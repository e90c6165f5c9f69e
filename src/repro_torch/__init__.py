"""repro_torch -- the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``: the same
software memory manager (``mem/``), paged KV cache (``core/``), decoder
model (``models/``) and serving stack (``serve/``), with each Pallas
kernel of the serving path replaced by a CUDA kernel written for
``sm_90a`` (``kernels/``).  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.

Entry points take an explicit ``device`` and default to ``"cuda"``;
only an explicit ``device="cpu"`` runs on the CPU, where every kernel
wrapper uses its plain PyTorch version.
"""
