"""The PyTorch ``mem`` control plane against the JAX package's.

The same operation sequences -- those of ``tests/test_blockpool.py``,
``tests/test_mem_api.py`` and ``tests/test_transfer.py``, plus seeded
random interleavings drawn with numpy -- drive both packages' allocator,
Arena, Mapping and transfer plane.  Every block id handed out, every
copy/swap plan, the stats snapshots, and (with executors over real
device streams) the pool contents and host payloads must be equal.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.mem as jmem
import repro_torch.mem as tmem

torch.set_num_threads(1)

PKGS = {"jax": jmem, "torch": tmem}


def _both(fn, *args):
    out = {k: fn(m, *args) for k, m in PKGS.items()}
    assert out["jax"] == out["torch"], (out["jax"], out["torch"])
    return out["torch"]


# ---------------------------------------------------------------------------
# allocator
# ---------------------------------------------------------------------------
def _allocator_trace(mem, seed):
    rng = np.random.default_rng(seed)
    a = mem.BlockAllocator(24)
    live, trace = [], []
    for _ in range(300):
        op = rng.integers(0, 7)
        try:
            if op == 0:
                b = a.alloc()
                live.append(b)
                trace.append(("alloc", b))
            elif op == 1 and live:
                b = live.pop(int(rng.integers(len(live))))
                a.free(b)
                trace.append(("free", b))
            elif op == 2 and live:
                b = live[int(rng.integers(len(live)))]
                live.append(a.share(b))
            elif op == 3 and live:
                i = int(rng.integers(len(live)))
                nb, copy = a.fork_for_write(live[i])
                trace.append(("fork", live[i], nb, copy))
                live[i] = nb
            elif op == 4:
                free = [b for b in range(24) if a.refcount(b) == 0
                        and not a.is_held(b)]
                if free:
                    b = free[int(rng.integers(len(free)))]
                    a.hold(b, engine="d2h")
                    trace.append(("hold", b))
            elif op == 5 and a.held_ids():
                b = sorted(a.held_ids())[0]
                a.release_hold(b)
                trace.append(("release", b))
            elif op == 6 and live:
                a.note_write(live[:3])
        except mem.OutOfBlocksError:
            trace.append(("oob",))
    trace.append(("refcounts", [a.refcount(b) for b in range(24)]))
    trace.append(("free_list", list(a._free)))
    trace.append(("gens", a.write_gens(range(24)).tolist()))
    trace.append(("hist", a.refcount_histogram().tolist()))
    return trace


@pytest.mark.parametrize("seed", range(4))
def test_allocator_sequences_match(seed):
    _both(_allocator_trace, seed)


# ---------------------------------------------------------------------------
# Arena / Mapping verbs (the test_mem_api sequences)
# ---------------------------------------------------------------------------
def _arena(mem, n=8):
    a = mem.Arena()
    a.register_class("kv", num_blocks=n, block_nbytes=64)
    return a


def _stats(a):
    d = a.stats().to_dict()
    # the port has no data-parallel pool groups, so no per-group rows
    for c in d["classes"].values():
        c.pop("groups", None)
    return d


def scen_fork_barrier_migrate(mem):
    a = _arena(mem)
    parent = a.mapping("kv", owner=0)
    out = [parent.ensure_capacity(3)]
    child = parent.fork(owner=1, nblocks=2)
    out.append(child.block_ids())
    out.append(child.ensure_writable(1))
    out.append(child.ensure_writable(1))
    out.append(_stats(a))
    out.append(parent.migrate("host"))
    stranger = a.mapping("kv", owner=8)
    out.append(stranger.ensure_capacity(2))
    out.append(parent.migrate("device"))
    out.append(_stats(a))
    for m in (child, parent, stranger):
        m.free()
    a.transfers.drain()
    a.assert_quiescent()
    out.append(_stats(a))
    return out


def scen_pressure(mem):
    a = _arena(mem, n=4)
    victim = a.mapping("kv", owner="victim")
    out = [victim.ensure_capacity(3)]
    seen = []

    def reclaimer(requester):
        seen.append(requester)
        victim.migrate("host")
        return "victim"

    a.set_reclaimer(reclaimer)
    m = a.mapping("kv", owner="req")
    out.append(m.ensure_capacity(3))
    out.append(list(seen))
    out.append(a.host_counts("kv"))
    out.append(_stats(a))
    victim.free()
    m.free()
    a.transfers.drain()
    a.assert_quiescent()
    a2 = _arena(mem, n=2)
    s = a2.mapping("kv", owner="self")
    s.ensure_capacity(2)
    a2.set_reclaimer(lambda r: (s.migrate("host"), "self")[1])
    try:
        s.ensure_capacity(3)
    except mem.LeaseRevokedError:
        out.append("revoked")
    out.append(s.placement)
    return out


def scen_compact_and_stats(mem):
    a = _arena(mem, n=16)
    sink = a.pin("kv", owner="sink")
    keep = a.mapping("kv", owner="keep")
    keep.ensure_capacity(2)
    hole = a.mapping("kv", owner="hole")
    hole.ensure_capacity(4)
    tail = a.mapping("kv", owner="tail")
    tail.ensure_capacity(3)
    shared = tail.fork(owner="alias", nblocks=2)
    swapped = a.mapping("kv", owner=5)
    swapped.ensure_capacity(2)
    swapped.migrate("host")
    hole.free()
    out = [a.fragmentation("kv"), a.table_locality("kv"),
           a.should_compact("kv", min_free_frac=0.25, frag_threshold=0.1)]
    src, dst = a.compact("kv")
    out += [src.tolist(), dst.tolist(), keep.block_ids(), tail.block_ids(),
            shared.block_ids(), sink.block, _stats(a)]
    a.transfers.drain()
    for m in (shared, tail, keep, swapped):
        m.free()
    a.unpin(sink)
    a.assert_quiescent()
    return out


@pytest.mark.parametrize("scenario", [scen_fork_barrier_migrate,
                                      scen_pressure, scen_compact_and_stats])
def test_arena_sequences_match(scenario):
    _both(scenario)


# ---------------------------------------------------------------------------
# transfer plane with executors over real streams (test_transfer.py)
# ---------------------------------------------------------------------------
class _Streams:
    """One (layers, n, blk) float32 stream in either package."""

    def __init__(self, pkg, n, layers=1, blk=2):
        self.pkg = pkg
        self.s = (jnp.zeros((layers, n, blk), jnp.float32) if pkg == "jax"
                  else torch.zeros((layers, n, blk)))

    def get(self):
        return [self.s]

    def set(self, streams):
        self.s = streams[0]

    def write(self, ids, value):
        if self.pkg == "jax":
            self.s = self.s.at[:, jnp.asarray(ids, jnp.int32)].set(value)
        else:
            self.s[:, torch.as_tensor(ids).long()] = value

    def read(self, ids):
        ids = np.asarray(ids, np.int64)
        if self.pkg == "jax":
            return np.asarray(self.s)[:, ids].tolist()
        return self.s[:, torch.as_tensor(ids)].numpy().tolist()


def _payload(p):
    return [np.asarray(x if not isinstance(x, torch.Tensor) else x.numpy()
                       ).tolist() for x in p]


def _schedule(mem, ops, eager):
    pkg = "jax" if mem is jmem else "torch"
    a = mem.Arena()
    a.register_class("kv", num_blocks=10, block_nbytes=8)
    st = _Streams(pkg, 10)
    a.transfers.register_executor("kv", st.get, st.set)
    a.transfers.eager = eager
    maps, fill, trace = [], [1.0], []

    def avail():
        return a.num_free("kv") + a.allocator("kv").num_held

    def write(m):
        a.transfers.dispatch()
        m.assert_settled()
        st.write(m.block_ids(), fill[0])
        fill[0] += 1

    for code, arg in ops:
        live = [m for m in maps if not m.freed]
        device = [m for m in live if m.placement == "device"]
        host = [m for m in live if m.placement == "host"]
        if code == 0 and avail() >= 2:
            m = a.mapping("kv", owner=len(maps) + 1)
            trace.append(("grow", m.ensure_capacity(1 + arg % 2)))
            maps.append(m)
            write(m)
        elif code == 1 and device:
            trace.append(("out", device[arg % len(device)].migrate("host")))
        elif code == 2 and host:
            m = host[arg % len(host)]
            if avail() >= len(m):
                trace.append(("in", m.migrate("device")))
        elif code == 3 and device and avail() >= 1:
            child = device[arg % len(device)].fork(owner=len(maps) + 1,
                                                   nblocks=1)
            maps.append(child)
            trace.append(("cow", child.ensure_writable(0)))
            write(child)
        elif code == 4:
            a.transfers.drain()
        elif code == 5:
            idle = [m for m in host if not m.prefetched and len(m) > 0]
            if idle and avail() >= len(idle[arg % len(idle)]):
                trace.append(("pf", idle[arg % len(idle)].prefetch()))
        elif code == 6:
            spec = [m for m in host if m.prefetched]
            if spec:
                spec[arg % len(spec)].cancel_prefetch()
        elif code == 7 and device:
            device[arg % len(device)].free()
        trace.append(a.transfers.pending_by_direction())
    a.transfers.drain()
    for m in maps:
        if m.freed:
            continue
        if m.placement == "device":
            trace.append((m.owner, st.read(m.block_ids())))
        else:
            payload, nbytes = a._host_payload[("kv", m.owner)]
            trace.append((m.owner, _payload(payload), nbytes))
    trace.append(a.transfers.stats.to_dict())
    trace.append(_stats(a))
    return trace


@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_transfer_schedules_match(seed, eager):
    rng = np.random.default_rng(100 + seed)
    ops = [(int(c), int(x)) for c, x in
           zip(rng.integers(0, 8, 40), rng.integers(0, 8, 40))]
    _both(_schedule, ops, eager)


def _contents(trace):
    """The block contents and host payloads that ``_schedule`` ends its
    trace with, by owner: ``(values,)`` for a mapping on the device,
    ``(payload, nbytes)`` for one on the host."""
    return {t[0]: t[1:] for t in trace
            if isinstance(t, tuple) and isinstance(t[0], int)}


@pytest.mark.parametrize("seed", range(20))
def test_deferred_schedule_matches_eager(seed):
    """In the port alone: after a seeded mix of grows, swap-outs,
    swap-ins, COW barriers, prefetches, cancellations, frees, device
    writes and fences, the deferred multi-queue schedule leaves the same
    block contents and host payloads as the eager one (drain per
    enqueue) -- the invariant of the reference's
    ``test_any_interleaving_matches_synchronous_drain``, which the block
    kernels no longer fence with a host sync."""
    rng = np.random.default_rng(300 + seed)
    ops = [(int(c), int(x)) for c, x in
           zip(rng.integers(0, 8, 60), rng.integers(0, 8, 60))]
    deferred = _contents(_schedule(tmem, ops, eager=False))
    eager = _contents(_schedule(tmem, ops, eager=True))
    assert deferred == eager
