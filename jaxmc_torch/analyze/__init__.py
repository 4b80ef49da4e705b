"""Static analysis the level engine needs: the bounds fixpoint whose
proven intervals size the packed lanes (`analyze/bounds.py`).
JAXMC_ANALYZE_BOUNDS=0 disables it."""

from __future__ import annotations

import os

_OFF = ("0", "off", "no", "false", "disabled")


def bounds_enabled() -> bool:
    """Static bounds -> proven pack lanes (JAXMC_ANALYZE_BOUNDS)."""
    return os.environ.get("JAXMC_ANALYZE_BOUNDS", "1").strip().lower() \
        not in _OFF


from .bounds import (BoundsReport, EB, Iv,  # noqa: E402
                     infer_state_bounds, state_space_estimate)

__all__ = ["BoundsReport", "EB", "Iv", "bounds_enabled",
           "infer_state_bounds", "state_space_estimate"]
