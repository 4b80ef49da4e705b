"""Hand-written CUDA kernels of the level engine (csrc/), their build
(build.py) and their wrappers and plain PyTorch twins (ops.py)."""
