r"""Search-progress / ETA estimation from the analyze-layer prediction.

``analyze.state_space_estimate`` proves an upper bound on
the reachable distinct-state count for many specs.  Against that bound
and the observed frontier-growth curve this module derives, live:

  fraction   distinct / estimate, clamped to [0, 1]
  eta_s      remaining / recent discovery rate (a trailing window over
             the last observations, so it tracks the curve's knee
             instead of averaging the whole run)
  verdict    "est" while the bound holds; "unbounded" when no estimate
             exists OR the search has already exceeded it (the bound
             was an upper bound on the wrong model of the search — be
             honest rather than show >100%)

The estimator is attached to a live Telemetry as ``tel.progress_est``
(``attach_estimator``, called from CheckSession.parse once the model
is bound).  Consumers:

  - engine progress lines append ``eta_suffix(distinct)`` — empty
    string when no estimator is attached, so default (NullTelemetry)
    runs keep byte-identical stdout;
  - the watchdog stamps snapshot fields into heartbeats;
  - the serve daemon's /status and /metrics surface the
    ``search.progress_est`` gauge the estimator maintains.

Thread-safe: observations arrive from engine threads, snapshots from
the watchdog and the daemon's HTTP threads.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Optional

#: sliding window of (t, distinct) samples the rate is fitted over
_WINDOW = 32


class ProgressEstimator:
    def __init__(self, estimate: Optional[int],
                 clock=time.time):
        try:
            self.estimate = int(estimate) if estimate is not None else None
        except (TypeError, ValueError):
            self.estimate = None
        self.clock = clock
        self._lock = threading.Lock()
        self._samples = collections.deque(maxlen=_WINDOW)
        self._distinct = 0

    # ---- feeding ------------------------------------------------------
    def observe(self, distinct: Optional[int] = None,
                new: Optional[int] = None) -> Optional[float]:
        """Record a progress observation (cumulative `distinct` wins;
        `new` increments when that's all the caller has).  Returns the
        current fraction-explored, or None when unbounded."""
        with self._lock:
            if distinct is not None:
                try:
                    self._distinct = max(self._distinct, int(distinct))
                except (TypeError, ValueError):
                    pass
            elif new is not None:
                self._distinct += int(new)
            self._samples.append((self.clock(), self._distinct))
            return self._fraction_locked()

    # ---- deriving -----------------------------------------------------
    def _fraction_locked(self) -> Optional[float]:
        if self.estimate is None or self.estimate <= 0 \
                or self._distinct > self.estimate:
            return None
        return min(1.0, self._distinct / self.estimate)

    def _rate_locked(self) -> Optional[float]:
        if len(self._samples) < 2:
            return None
        t0, n0 = self._samples[0]
        t1, n1 = self._samples[-1]
        if t1 <= t0 or n1 <= n0:
            return None
        return (n1 - n0) / (t1 - t0)

    def snapshot(self) -> Dict[str, Any]:
        """The fields stamped into heartbeats / /status / timeline."""
        with self._lock:
            fr = self._fraction_locked()
            rate = self._rate_locked()
            eta = None
            if fr is not None and rate is not None and rate > 0:
                eta = max(0.0, (self.estimate - self._distinct) / rate)
            return {
                "estimate": self.estimate,
                "distinct": self._distinct,
                "fraction": round(fr, 6) if fr is not None else None,
                "rate_states_s": round(rate, 3) if rate else None,
                "eta_s": round(eta, 3) if eta is not None else None,
                "verdict": "est" if fr is not None else "unbounded",
            }

    def suffix(self) -> str:
        """Human tail for a Progress(...) line, e.g.
        " (~41% of est. 20001 states, ETA 12s)"."""
        s = self.snapshot()
        if s["verdict"] == "unbounded":
            return " (est. unbounded)"
        pct = 100.0 * s["fraction"]
        tail = f" (~{pct:.0f}% of est. {s['estimate']} states"
        if s["eta_s"] is not None:
            tail += f", ETA {_fmt_s(s['eta_s'])}"
        return tail + ")"


def _fmt_s(sec: float) -> str:
    if sec >= 3600:
        return f"{sec / 3600:.1f}h"
    if sec >= 60:
        return f"{sec / 60:.1f}m"
    return f"{sec:.0f}s"


def attach_estimator(tel, model) -> Optional[ProgressEstimator]:
    """Attach a ProgressEstimator for `model` to `tel` (no-op on
    disabled telemetry).  The analyze fixpoint must never break a
    check, so every failure degrades to an unbounded estimator."""
    if not getattr(tel, "enabled", False):
        return None
    est = None
    try:
        from ..analyze.bounds import state_space_estimate
        est = state_space_estimate(model)
    except Exception:  # noqa: BLE001 — estimation is best-effort
        est = None
    pe = ProgressEstimator(est)
    tel.progress_est = pe
    if est is not None:
        tel.event("progress_estimate", estimate=int(est))
    return pe


def eta_suffix(distinct: Optional[int] = None, tel=None) -> str:
    """The progress-line tail for the current telemetry's estimator —
    "" when none is attached (default runs keep their exact output).
    Feeds the observation in and refreshes the `search.progress_est`
    gauge as a side effect, so the first progress line (emitted before
    level 1 completes) already carries an estimate."""
    if tel is None:
        from .telemetry import current
        tel = current()
    pe = getattr(tel, "progress_est", None)
    if pe is None:
        return ""
    fr = pe.observe(distinct=distinct) if distinct is not None \
        else pe.snapshot().get("fraction")
    if fr is not None:
        tel.gauge("search.progress_est", fr)
    return pe.suffix()
