"""Static analysis over the TLA+ AST, copies of the reference's
jaxmc/analyze modules:

  bounds.py      the bounds fixpoint whose proven intervals size the
                 packed lanes (JAXMC_ANALYZE_BOUNDS=0 disables it)
  verdicts.py    demotion prediction: arms the compiler is certain to
                 demote skip their build, with the build-time reason
                 (JAXMC_ANALYZE_PREDICT=0 disables it)
  lint.py        spec/cfg diagnostics with stable JMC codes (`check
                 --analyze`, `python -m jaxmc_torch.analyze lint`)
  independence.py  per-arm footprints and the commutativity matrix
                 (--por, `info`)
  pylint.py      the builtin unused-import/-local checker
"""

from __future__ import annotations

import os

_OFF = ("0", "off", "no", "false", "disabled")


def bounds_enabled() -> bool:
    """Static bounds -> proven pack lanes (JAXMC_ANALYZE_BOUNDS)."""
    return os.environ.get("JAXMC_ANALYZE_BOUNDS", "1").strip().lower() \
        not in _OFF


def predict_enabled() -> bool:
    """Static per-arm demotion verdicts (JAXMC_ANALYZE_PREDICT)."""
    return os.environ.get("JAXMC_ANALYZE_PREDICT", "1").strip().lower() \
        not in _OFF


from .bounds import (BoundsReport, EB, Iv,  # noqa: E402
                     infer_state_bounds, state_space_estimate)
from .verdicts import predict_arm_demotions  # noqa: E402
from .lint import Diagnostic, lint_pair  # noqa: E402

__all__ = ["BoundsReport", "Diagnostic", "EB", "Iv", "bounds_enabled",
           "infer_state_bounds", "lint_pair", "predict_arm_demotions",
           "predict_enabled", "state_space_estimate"]
