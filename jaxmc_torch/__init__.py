"""jaxmc_torch — the jaxmc TLA+ model checker ported to PyTorch and CUDA.

`jaxmc/` (JAX) is the reference; this package does the same work on an
NVIDIA H100.  It imports torch and numpy, never jax and nothing of
`jaxmc`: the JAX-free layers are kept here as copies.

  front/    TLA+ lexer/parser, .cfg parser, PlusCal translator
  sem/      value domain, evaluator, Init/Next enumeration
  engine/   check results, traces, layout sampling
  analyze/  static bounds that size the packed lanes
  compile/  grounding, value layouts, lane packing, the batch-first
            transition-kernel compiler (kernel2.py)
  kernels/  hand-written CUDA kernels (csrc/), their build, wrappers
            and plain PyTorch twins (ops.py)
  backend/  the level engine, TorchExplorer (bfs.py)
"""

__version__ = "0.1.0"
