"""Model loading for the port's entry points (the port of
jaxmc/session.py load_model)."""

from __future__ import annotations

import os
from typing import Optional


def read_text(path: str) -> str:
    """Read a cfg/spec file without leaking the handle."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        return fh.read()


def default_cfg_path(spec_path: str) -> Optional[str]:
    guess = os.path.splitext(spec_path)[0] + ".cfg"
    return guess if os.path.exists(guess) else None


def load_model(spec_path: str, cfg_path=None, no_deadlock: bool = False,
               includes=()):
    """Parse SPEC (and its cfg: `cfg_path`, else SPEC's sibling .cfg,
    else `SPECIFICATION Spec`) and bind it into a checkable Model."""
    from .front.cfg import parse_cfg, ModelConfig
    from .sem.modules import Loader, bind_model

    if cfg_path is None:
        cfg_path = default_cfg_path(spec_path)
    if cfg_path:
        cfg = parse_cfg(read_text(cfg_path))
    else:
        cfg = ModelConfig(specification="Spec")
    if no_deadlock:
        cfg.check_deadlock = False
    ldr = Loader([os.path.dirname(os.path.abspath(spec_path))] +
                 list(includes))
    mod = ldr.load_path(spec_path)
    return bind_model(mod, cfg)
