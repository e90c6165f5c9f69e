"""One rank of ``launch.mesh.spawn_ranks``.

    python -m repro_torch.launch.rank JOB

``JOB`` is the pickle ``spawn_ranks`` wrote: the function, the mesh
shape, backend, device and group timeout.  The rank builds its mesh with
``Mesh.from_env`` from the environment ``spawn_processes`` set, runs the
function, shuts its groups down and writes ``("ok", result)`` or
``("error", time.time(), exception, traceback)`` beside the job as
``rank<RANK>.pkl``; an exception that does not pickle travels as a
``RuntimeError`` holding its text.  It then exits without running the
interpreter's shutdown (a group's destructor must not block the exit).
"""

from __future__ import annotations

import os
import pickle
import sys
import time
import traceback


def _picklable(err: BaseException) -> BaseException:
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:           # noqa: BLE001 - any pickling failure
        return RuntimeError(f"{type(err).__name__}: {err}")


def main(job_path: str) -> int:
    rank = int(os.environ["RANK"])
    out = os.path.join(os.path.dirname(job_path), f"rank{rank}.pkl")
    mesh = None
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        from repro_torch.launch.mesh import Mesh

        mesh = Mesh.from_env(job["shape"], backend=job["backend"],
                             device=job["device"], timeout=job["timeout"])
        rec = ("ok", job["fn"](mesh))
        code = 0
    except BaseException as e:      # handed to the caller
        rec = ("error", time.time(), _picklable(e), traceback.format_exc())
        code = 1
    finally:
        if mesh is not None:
            mesh.shutdown()
    try:
        data = pickle.dumps(rec)
    except Exception as e:          # noqa: BLE001 - an unpicklable result
        data = pickle.dumps(("error", time.time(), RuntimeError(
            f"rank {rank}'s result does not pickle: {e}"), ""))
        code = 1
    with open(out + ".tmp", "wb") as f:
        f.write(data)
    os.replace(out + ".tmp", out)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    main(sys.argv[1])
