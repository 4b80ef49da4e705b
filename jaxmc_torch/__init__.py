"""jaxmc_torch — the jaxmc TLA+ model checker ported to PyTorch and CUDA.

`jaxmc/` (JAX) is the reference; this package does the same work on an
NVIDIA H100.  It imports torch and numpy, never jax and nothing of
`jaxmc`: the JAX-free layers are kept here as copies.

  front/    TLA+ lexer/parser, .cfg parser, PlusCal translator
  sem/      value domain, evaluator, Init/Next enumeration
  engine/   check results, traces, layout sampling
  analyze/  static analysis: the bounds that size the packed lanes,
            demotion prediction, the linter (`python -m
            jaxmc_torch.analyze`), the arm independence matrix
  compile/  grounding, value layouts, lane packing, the batch-first
            transition-kernel compiler (kernel2.py)
  kernels/  hand-written CUDA kernels (csrc/), their build, wrappers
            and plain PyTorch twins (ops.py)
  backend/  the engines, TorchExplorer (bfs.py), batching (batch.py),
            the seen tiers (tiers.py), the backend descriptor
            (__init__.py) and the preflight oracle (oracle.py)
  obs/      telemetry, the metrics artifact and trace, the profiler
            and HBM model, the watchdog, and `python -m
            jaxmc_torch.obs report|diff|timeline|top|history`
  session.py  CheckSession: the parse, analyze, compile and explore
            stages that `check` runs through
  cli.py    `python -m jaxmc_torch check|simulate|info|sweep`
  corpus.py  the corpus manifest and the sweep
  meshbench.py  the mesh's parity legs and scaling bench
"""

__version__ = "0.1.0"
