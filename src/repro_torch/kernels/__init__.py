"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops`` is the public surface (dispatch by device, launch counters),
``ref`` holds the plain versions, ``build`` compiles ``csrc/*.cu``.
Nothing here builds or imports a compiler at import time.
"""
