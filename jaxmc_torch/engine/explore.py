r"""Results of a check: the verdict record every engine returns, and
TLC's counterexample format (README.md:268-318).

The port's own copy of the result half of jaxmc/engine/explore.py.  The
reference's interpreter engine (the `Explorer` class, with its
checkpoint, liveness, refinement and POR helpers) is not part of this
slice: no entry point of the port runs it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..sem.values import fmt


@dataclass
class Violation:
    kind: str  # 'invariant' | 'assert' | 'deadlock' | 'constraint-eval' | 'error'
    name: str
    trace: List[Tuple[Dict[str, Any], str]]  # (state, action label)
    message: str = ""


@dataclass
class CheckResult:
    ok: bool
    distinct: int
    generated: int
    diameter: int
    violation: Optional[Violation] = None
    wall_s: float = 0.0
    truncated: bool = False
    warnings: List[str] = field(default_factory=list)
    # truncation attribution: which resource ran out ("max_states:
    # distinct N >= limit M").  None on complete runs.
    trunc_reason: Optional[str] = None
    # dedup-key mode the run actually used ("exact" | "fingerprint")
    # and, in fingerprint mode, the reported collision-probability
    # bound (< n^2 * 2^-129 over n admitted keys) — TLC reports the
    # same estimate for its 64-bit fingerprints
    seen_mode: str = "exact"
    collision_p: Optional[float] = None


def format_trace(violation: Violation) -> str:
    lines = []
    if violation.kind == "invariant":
        lines.append(f"Error: Invariant {violation.name} is violated.")
    elif violation.kind == "property":
        lines.append(f"Error: Property {violation.name} is violated"
                     + (f" ({violation.message})." if violation.message
                        else "."))
    elif violation.kind == "assert":
        lines.append(f"Error: Assertion failed: {violation.message}")
    elif violation.kind == "deadlock":
        lines.append("Error: Deadlock reached.")
    else:  # engine errors (capacity overflow, ...) — never print silently
        lines.append(f"Error: {violation.name}"
                     + (f": {violation.message}" if violation.message
                        else "."))
    if not violation.trace:
        return "\n".join(lines)
    lines.append("The behavior up to this point is:")
    for i, (st, label) in enumerate(violation.trace):
        head = "Initial predicate" if i == 0 else f"Action {label}"
        lines.append(f"State {i + 1}: <{head}>")
        for k in sorted(st.keys()):
            lines.append(f"  {k} = {fmt(st[k])}")
        lines.append("")
    return "\n".join(lines)
