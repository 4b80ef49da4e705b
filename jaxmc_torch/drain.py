r"""Cooperative drain: graceful shutdown for every engine.

Before this module, SIGTERM killed a `check` (or a bench child, or a
serve worker) wherever it stood: open spans never closed, the watchdog
thread died mid-beat, and hours of search state evaporated because the
periodic checkpoint had not fired yet.  The fix is COOPERATIVE: a signal
handler (or the serve daemon's drain endpoint) only *requests* a drain
here; every engine polls `requested()` at its next safe boundary — the
serial BFS pop, the parallel engine's level barrier, a device mode's
inter-dispatch gap — writes a checkpoint if one was configured, and
returns a truncated `CheckResult` with `drained=True` and the NAMED
reason in its warnings.  The normal return path then unwinds through
the CLI/session `finally` blocks, so spans close, the watchdog joins,
and the metrics artifact is written — nothing is lost and nothing
leaks.

Exit-code contract: a drained `check` exits with DRAIN_EXIT_CODE (143,
the conventional 128+SIGTERM), never 0 (the search did NOT complete)
and never 2 (nothing was wrong with the invocation).  The serve daemon
reuses the same flag for its SIGTERM drain: in-flight jobs checkpoint
and re-queue, then the daemon exits 0 (a drained daemon IS a clean
daemon).

The state is process-global on purpose: one SIGTERM must drain every
engine the process is running (the serve daemon runs several at once).
`clear()` re-arms the process (the daemon clears after a completed
drain-and-restart cycle in tests; the CLI never needs to).
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, Optional

DRAIN_EXIT_CODE = 143  # 128 + SIGTERM: "terminated, but gracefully"

_EVENT = threading.Event()
_LOCK = threading.Lock()
_REASON: Optional[str] = None
_INSTALLED = False


def request(reason: str) -> None:
    """Ask every engine in this process to checkpoint and stop at its
    next safe boundary.  First reason wins (it names the cause in every
    warning/exit line); repeat requests are no-ops."""
    global _REASON
    with _LOCK:
        if _REASON is None:
            _REASON = str(reason)
    _EVENT.set()


def requested() -> bool:
    return _EVENT.is_set()


def reason() -> str:
    with _LOCK:
        return _REASON or "drain requested"


def clear() -> None:
    """Re-arm (serve daemon restart cycles, tests)."""
    global _REASON
    with _LOCK:
        _REASON = None
    _EVENT.clear()


def install(signals=(signal.SIGTERM,),
            on_request: Optional[Callable[[str], None]] = None) -> bool:
    """Install the drain handler on `signals` (main thread only —
    Python restricts signal.signal to it; returns False elsewhere, and
    the caller keeps working without graceful drain).

    First signal: request a drain (engines checkpoint and stop).
    Second signal of the same kind: the operator means it — exit HARD
    with DRAIN_EXIT_CODE (a wedged engine must not make the process
    unkillable short of SIGKILL)."""
    global _INSTALLED
    if threading.current_thread() is not threading.main_thread():
        return False
    seen = {"signals": 0}

    def _handler(signum, frame):
        name = signal.Signals(signum).name
        # count SIGNALS, not drain requests: a drain begun some other
        # way (POST /drain, a programmatic request) must not turn the
        # operator's first, routine SIGTERM into a hard kill — only a
        # REPEATED signal says "stop waiting for the safe boundary"
        seen["signals"] += 1
        if seen["signals"] > 1:
            os._exit(DRAIN_EXIT_CODE)  # second signal: hard exit
        request(f"signal {name}")
        if on_request is not None:
            try:
                on_request(name)
            except Exception:  # noqa: BLE001 — a drain hook must never
                pass           # turn a graceful stop into a crash

    for sig in signals:
        signal.signal(sig, _handler)
    _INSTALLED = True
    return True
