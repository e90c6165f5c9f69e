"""Configs and package hygiene of the PyTorch port.

* Every field of each ported config equals the JAX package's, full and
  ``reduced()``; ``torch_dtype`` matches ``jdtype``; ``ARCH_IDS`` is the
  reference's list.
* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or anything of ``repro`` (the port keeps its own copies).
* Entry points default to CUDA and refuse to fall back to the CPU.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import ARCH_IDS as JARCH_IDS
from repro_torch.configs.base import ARCH_IDS, CONFIG_IDS, get_config
from repro_torch.device import resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", CONFIG_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(arch, reduced):
    ours, theirs = get_config(arch), jget_config(arch)
    if reduced:
        ours, theirs = ours.reduced(), theirs.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.hd == theirs.hd
    assert ours.param_count() == theirs.param_count()
    if theirs.mla is not None:
        assert ours.mla.latent_dim == theirs.mla.latent_dim
    assert ([ours.layer_is_local(i) for i in range(ours.num_layers)]
            == [theirs.layer_is_local(i) for i in range(theirs.num_layers)])
    assert (torch.empty((), dtype=ours.torch_dtype).element_size()
            == np.dtype(theirs.jdtype).itemsize)
    assert str(ours.torch_dtype) == f"torch.{theirs.jdtype}"


def test_arch_ids_are_the_references():
    assert ARCH_IDS == JARCH_IDS
    assert CONFIG_IDS == ARCH_IDS + ["mamba2_370m"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            yield "".join(v.value for v in node.args[0].values
                          if isinstance(v, ast.Constant))


def test_minicpm3_4b_is_the_published_shape():
    """Full width: 62 layers, d 2560, 40 heads, q_lora 768, kv_lora 256,
    rope 32, nope 64, v 64, d_ff 6400, vocab 73448, bf16; 4,073,492,480
    parameters (8.15 GB in bf16) and a 288-wide latent per token."""
    cfg = get_config("minicpm3_4b")
    m = cfg.mla
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.d_ff,
            cfg.vocab_size, cfg.dtype, cfg.attention, cfg.tie_embeddings) \
        == (62, 2560, 40, 6400, 73448, "bfloat16", "mla", True)
    assert (m.q_lora_rank, m.kv_lora_rank, m.qk_rope_head_dim,
            m.qk_nope_head_dim, m.v_head_dim, m.latent_dim) \
        == (768, 256, 32, 64, 64, 288)
    assert cfg.param_count() == 4_073_492_480


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "flax", "repro"):
                bad.append(f"{path.relative_to(REPO)}: {mod}")
    assert not bad, "port modules import the JAX package:\n" + "\n".join(bad)


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_serve_launcher_runs_on_cpu(capsys):
    """``python -m repro_torch.launch.serve`` end to end on the plain
    versions: every request of the trace is served and reported."""
    from repro_torch.launch.serve import main

    done = main(["--arch", "gemma_2b", "--reduced", "--device", "cpu",
                 "--requests", "4", "--max-new", "4", "--trace",
                 "prefixheavy", "--prefill-budget", "none"])
    assert len(done) == 4 and all(len(r.generated) == 4 for r in done)
    out = capsys.readouterr().out
    assert "served 4/4 requests on cpu" in out and "phase split" in out
