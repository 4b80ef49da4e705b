r"""Watchdog: a daemon heartbeat thread that names a stall WHILE it is
happening.

Motivation (BENCH_r05): the device bench degraded to the
interpreter because device init wedged inside the 480 s deadline, and
nothing in-flight said so — the post-mortem rollup named the culprit
only after the budget was gone. The watchdog turns the telemetry the
engines already emit into a live signal:

  - every `interval` seconds it emits a `heartbeat` trace event carrying
    wall time, RSS, the open-span stack (outermost first) and the last
    completed BFS level — a killed run's trace ends with a beat that
    says exactly where it was;
  - when no span opens/closes and no level record lands for longer than
    `max(min_stall_s, stall_factor * median(level wall))` it emits ONE
    `stall` trace event per episode (plus a stderr line via `on_stall`),
    naming the open spans — a wedged device init or a pathological BFS
    level is reported before any deadline fires, not after.

The liveness signal is `Telemetry.progress_seq`, bumped on every span
open/close and level record, so the watchdog needs no cooperation from
the engines. Everything is best-effort: a watchdog failure must never
break a run (the tick body is exception-proofed), and the thread is a
daemon so it can never hold a process open.

Knobs (env, all optional):
  JAXMC_HEARTBEAT_EVERY  seconds between beats        (default 10)
  JAXMC_STALL_FACTOR     multiple of the median level (default 5)
  JAXMC_STALL_MIN_S      stall floor in seconds       (default 30)
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

from .telemetry import device_mem_high_water, rss_bytes


def _median(xs):
    if not xs:
        return None
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def _default_on_stall(msg: str) -> None:
    print(f"jaxmc: WATCHDOG: {msg}", file=sys.stderr, flush=True)


class Watchdog:
    """Heartbeat/stall monitor over one Telemetry instance.

    `start()` launches the daemon thread; `stop()` joins it. `_tick()`
    is the whole per-beat body and takes the current time explicitly, so
    tests drive it deterministically without threads or sleeps."""

    def __init__(self, tel, interval: Optional[float] = None,
                 stall_factor: Optional[float] = None,
                 min_stall_s: Optional[float] = None,
                 on_stall: Callable[[str], None] = _default_on_stall,
                 clock=time.time):
        def _env(name, default):
            try:
                return float(os.environ.get(name, ""))
            except ValueError:
                return default

        self.tel = tel
        self.interval = interval if interval is not None \
            else _env("JAXMC_HEARTBEAT_EVERY", 10.0)
        self.stall_factor = stall_factor if stall_factor is not None \
            else _env("JAXMC_STALL_FACTOR", 5.0)
        self.min_stall_s = min_stall_s if min_stall_s is not None \
            else _env("JAXMC_STALL_MIN_S", 30.0)
        self.on_stall = on_stall
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        now = clock()
        self._last_seq = -1
        self._last_change_t = now
        self._stalled = False  # one stall event per episode

    # ---- lifecycle ----
    def start(self) -> "Watchdog":
        if not getattr(self.tel, "enabled", False):
            return self  # a NullTelemetry never progresses: nothing to watch
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop,
                                        name="jaxmc-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick(self._clock())
            except Exception:  # noqa: BLE001 — never break the run
                pass

    # ---- one beat (deterministic; tests call this directly) ----
    def stall_threshold_s(self, level_walls) -> float:
        """max(floor, factor * median level wall): early phases (device
        init, compile) have no levels yet, so the floor governs; once
        the BFS is producing level records the threshold tracks the
        model's own rhythm — a level 5x slower than the median is news
        even when it is fast in absolute terms."""
        med = _median(level_walls)
        if med is None:
            return self.min_stall_s
        return max(self.min_stall_s, self.stall_factor * med)

    def _tick(self, now: float) -> None:
        tel = self.tel
        snap = tel.watch_snapshot()
        if snap["progress_seq"] != self._last_seq:
            self._last_seq = snap["progress_seq"]
            self._last_change_t = now
            self._stalled = False
        stalled_for = now - self._last_change_t
        tel.counter("watchdog.heartbeats")
        beat = dict(
            wall_s=round(max(now - tel.t_start, 0.0), 3),
            rss_bytes=rss_bytes(),
            open_spans=snap["open_spans"],
            last_level=snap["last_level"],
            progress_seq=snap["progress_seq"],
            stalled_for_s=round(stalled_for, 3))
        prof = getattr(tel, "prof", None)
        if prof is not None:
            # device memory (the HBM model's current total)
            # rides next to RSS — a beat that shows host memory flat
            # while device buffers grew names the right suspect
            dm = prof.hbm_current_bytes()
            if dm:
                beat["device_mem_bytes"] = dm
        # the port's measured signal beside the model: the CUDA
        # allocator's peak, once the process has touched the card
        peak = device_mem_high_water()
        if peak is not None:
            beat["device_mem_peak_bytes"] = peak
        pe = getattr(tel, "progress_est", None)
        if pe is not None:  # the beat carries the live ETA
            ps = pe.snapshot()
            beat.update(progress_fraction=ps["fraction"],
                        progress_eta_s=ps["eta_s"],
                        progress_verdict=ps["verdict"])
        tel.event("heartbeat", **beat)
        threshold = self.stall_threshold_s(snap["level_walls"])
        if stalled_for >= threshold and not self._stalled:
            self._stalled = True
            tel.counter("watchdog.stalls")
            tel.high_water("watchdog.max_stall_s", round(stalled_for, 3))
            med = _median(snap["level_walls"])
            tel.event("stall",
                      stalled_for_s=round(stalled_for, 3),
                      threshold_s=round(threshold, 3),
                      open_spans=snap["open_spans"],
                      last_level=snap["last_level"],
                      median_level_s=None if med is None
                      else round(med, 6))
            where = " > ".join(snap["open_spans"]) or "no open span"
            lvl = snap["last_level"]
            # name the dominant profiler site, turning "no
            # progress" into "no progress, 92% in mesh.superstep"
            dom = ""
            if prof is not None:
                ds = prof.dominant_site()
                if ds is not None:
                    dom = f"; {ds[1]:.0%} in {ds[0]}"
            try:
                self.on_stall(
                    f"no span/level progress for {stalled_for:.0f}s "
                    f"(threshold {threshold:.0f}s); open: {where}; "
                    f"last completed level: "
                    f"{'none' if lvl is None else lvl}{dom}")
            except Exception:  # noqa: BLE001
                pass
        elif self._stalled:
            # episode continues: keep the high-water moving so the
            # summary records how long the worst wedge lasted
            tel.high_water("watchdog.max_stall_s", round(stalled_for, 3))
