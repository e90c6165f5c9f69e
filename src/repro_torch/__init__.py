"""repro_torch -- the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``: the same
software memory manager (``mem/``), paged KV cache and the paper's data
structures (``core/``: TreeArray, deep tables, split stacks), decoder
model (``models/``) and serving stack (``serve/``), with each Pallas
kernel replaced by a CUDA kernel written for ``sm_90a`` (``kernels/``),
the paper's experiments (``bench/``), and one-device training: the
models' ``loss``, AdamW (``optim/``), the step-addressable data pipeline
(``data/``), block checkpoints and the fault-tolerant loop (``train/``)
and ``launch/train.py``.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.

Entry points take an explicit ``device`` and default to ``"cuda"``;
only an explicit ``device="cpu"`` runs on the CPU, where every kernel
wrapper uses its plain PyTorch version.
"""
