"""Run telemetry for the port: counters, gauges, spans, a level log and a
logger.

A small module of the port's own.  It holds the calls the engines and
the copied front end, evaluator, tiers and faults make (`current().
counter/gauge/span/level/event`, `Logger`, `note_buffer`) and
keeps their values in memory, where a caller reads them after a run
(`current().levels`, `.gauges`, ...).  Nothing is written to disk.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional


class Span:
    __slots__ = ("name", "attrs", "t0", "wall_s")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = dict(attrs)
        self.t0 = time.time()
        self.wall_s = 0.0


class Telemetry:
    """In-memory sink for one process's run metrics."""

    def __init__(self):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.spans: List[Span] = []
        self.levels: List[Dict[str, Any]] = []
        self.buffers: Dict[str, int] = {}
        self.events: List[Dict[str, Any]] = []

    def counter(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def event(self, name: str, **attrs) -> None:
        self.events.append(dict(name=name, **attrs))

    def gauge(self, name: str, value: Any) -> None:
        self.gauges[name] = value

    def high_water(self, name: str, value: Optional[float]) -> None:
        if value is None:
            return
        old = self.gauges.get(name)
        if old is None or value > old:
            self.gauges[name] = value

    @contextmanager
    def span(self, name: str, **attrs):
        sp = Span(name, attrs)
        try:
            yield sp
        finally:
            sp.wall_s = time.time() - sp.t0
            self.spans.append(sp)

    def level(self, depth: int, **fields) -> None:
        self.levels.append(dict(depth=depth, **fields))

    def reset_levels(self, reason: str = "") -> None:
        """A search restart (hybrid demotion, adaptive relayout) replays
        from level 0: drop the stale level records so they describe the
        search that produced the final counts."""
        self.levels = []
        self.counter("search.restarts")


_CURRENT = Telemetry()
# a thread's own sink (a batch member's, backend/batch.py), else _CURRENT
_LOCAL = threading.local()


def current() -> Telemetry:
    t = getattr(_LOCAL, "tel", None)
    return t if t is not None else _CURRENT


@contextmanager
def use_local(tel: Telemetry):
    """Route this thread's telemetry to `tel` for the block."""
    prev = getattr(_LOCAL, "tel", None)
    _LOCAL.tel = tel
    try:
        yield tel
    finally:
        _LOCAL.tel = prev


def reset() -> Telemetry:
    """Start a fresh sink (one per run in callers that run several)."""
    global _CURRENT
    _CURRENT = Telemetry()
    return _CURRENT


def note_buffer(name: str, nbytes: int) -> None:
    """Record a device buffer's size at its current capacity."""
    _CURRENT.buffers[name] = int(nbytes)


def device_mem_high_water() -> Optional[int]:
    """Peak bytes the CUDA caching allocator handed out, or None when
    the process never touched a card."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return int(torch.cuda.max_memory_allocated())


class Logger:
    """The log funnel: prints TLC-style lines unless quiet, and keeps
    every line for callers and tests."""

    def __init__(self, quiet: bool = False):
        self.quiet = quiet
        self.lines: List[str] = []

    def __call__(self, msg: str) -> None:
        self.lines.append(msg)
        if not self.quiet:
            print(msg, file=sys.stdout, flush=True)
