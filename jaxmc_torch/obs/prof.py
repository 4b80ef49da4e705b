r"""Device profiler: per-dispatch attribution + HBM accounting (the port
of jaxmc/obs/prof.py).

  sites     every engine entry point that runs device work registers a
            NAMED dispatch site via `wrap("bfs.level_step", fn)`; the
            wrapper resolves the active recorder's Profiler at CALL
            time (so per-thread recorders work unchanged) and records
            per-site stats.
  cheap     the always-on mode: dispatch counts + build attribution
            only -- no sync, no byte walks, so profile-off runs stay
            byte-identical and effectively free.  A `recompile` in the
            port is a first-use `nvcc` build (kernels/build.py's
            BUILDS counter) that happened inside the call.
  wall      `--profile`: additionally waits for the call's device work
            (a CUDA event recorded on the current stream after the
            call, then synchronised -- the counterpart of
            block_until_ready; the whole device is never synchronised)
            and charges the host wall to the site, and sums argument /
            result bytes (tensor `nbytes`) per dispatch.  The reference's
            one-shot AOT cost analysis has no counterpart: there is no
            XLA lowering.  Synchronization cannot change counts or
            traces -- profile-on vs profile-off stays bit-identical.
  xla       wall + the CLI wraps the run in a torch.profiler capture to
            a named artifact dir.
  hbm       a device-memory MODEL: engines register named buffers
            (seen table, frontier, accumulator, candidates) as byte
            sizes the moment their capacities are known; the running
            sum's high-water is `prof.hbm.peak_bytes`, cross-checked
            against `torch.cuda.max_memory_allocated()` as
            `measured_peak_bytes`.

The rollup lands in the metrics artifact as the `prof{}` block (schema
jaxmc.metrics/4, obs/schema.py) and renders via `python -m
jaxmc_torch.obs top`.  This module imports no torch at import time (the
report CLI must run anywhere); torch is read from sys.modules in the
wall-mode sync only.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

# resolved lazily to avoid a telemetry<->prof import cycle (telemetry
# imports Profiler at module load; we only need current() at call time)
_current = None

# the kernel builder whose BUILDS counter a site's recompiles read
_BUILD_MOD = __name__.rsplit(".", 2)[0] + ".kernels.build"


def _cur():
    global _current
    if _current is None:
        from .telemetry import current as _current
    return _current()


def _builds() -> int:
    """nvcc builds so far in this process (0 before the builder is
    imported: nothing can have been built)."""
    mod = sys.modules.get(_BUILD_MOD)
    return getattr(mod, "BUILDS", 0) if mod is not None else 0


def _nbytes(x) -> int:
    """Best-effort byte count of a value: tensors and arrays expose an
    int .nbytes; containers recurse; scalars are 0."""
    nb = getattr(x, "nbytes", None)
    if isinstance(nb, int):
        return nb
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class SiteStats:
    """Per-site accumulators.  Mutated under the owning Profiler's
    lock; read via Profiler.snapshot()."""

    __slots__ = ("name", "dispatches", "wall_s", "arg_bytes",
                 "res_bytes", "recompiles")

    def __init__(self, name: str):
        self.name = name
        self.dispatches = 0
        self.wall_s = 0.0
        self.arg_bytes = 0
        self.res_bytes = 0
        self.recompiles = 0

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"dispatches": self.dispatches,
                             "recompiles": self.recompiles}
        if self.wall_s:
            d["wall_s"] = round(self.wall_s, 6)
        if self.arg_bytes or self.res_bytes:
            d["arg_bytes"] = self.arg_bytes
            d["res_bytes"] = self.res_bytes
        return d


class Profiler:
    """One per live Telemetry (NullTelemetry carries `prof = None`, so
    the un-instrumented hot path costs one getattr + a None test)."""

    CHEAP, WALL, XLA = "cheap", "wall", "xla"

    def __init__(self, mode: str = "cheap",
                 clock=time.perf_counter):
        self.mode = mode
        self._clock = clock
        self._lock = threading.Lock()
        self.sites: Dict[str, SiteStats] = {}
        self._buffers: Dict[str, int] = {}
        self.hbm_peak_bytes = 0
        self.xla_trace_dir: Optional[str] = None

    # ---- dispatch sites ------------------------------------------------
    def _site(self, name: str) -> SiteStats:
        st = self.sites.get(name)
        if st is None:
            with self._lock:
                st = self.sites.setdefault(name, SiteStats(name))
        return st

    def record(self, name: str, fn, args, kwargs):
        """One profiled dispatch.  Cheap mode: count + build delta
        only.  Wall mode: + the synchronised wall and arg/result
        bytes."""
        st = self._site(name)
        b0 = _builds()
        if self.mode == self.CHEAP:
            out = fn(*args, **kwargs)
            b1 = _builds()
            with self._lock:
                st.dispatches += 1
                st.recompiles += b1 - b0
            return out
        t0 = self._clock()
        out = fn(*args, **kwargs)
        self._block()
        dt = self._clock() - t0
        b1 = _builds()
        ab = _nbytes(args) + _nbytes(kwargs)
        rb = _nbytes(out)
        with self._lock:
            st.dispatches += 1
            st.wall_s += dt
            st.arg_bytes += ab
            st.res_bytes += rb
            st.recompiles += b1 - b0
        return out

    @staticmethod
    def _block() -> None:
        """Wait for the work the call queued on the current CUDA stream,
        so the recorded wall covers the device work, not just the
        launches: one event recorded after the call and synchronised.
        A sync cannot change values -- counts/traces stay
        bit-identical.  No-op where CUDA was never initialised."""
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()

    def dominant_site(self) -> Optional[Tuple[str, float]]:
        """(site name, share) of the site holding the largest wall
        share (wall mode) or dispatch share (cheap mode); None when no
        dispatches were recorded yet.  The watchdog's stall suffix."""
        with self._lock:
            if not self.sites:
                return None
            walls = {n: s.wall_s for n, s in self.sites.items()}
            total = sum(walls.values())
            if total > 0:
                name = max(walls, key=walls.get)
                return name, walls[name] / total
            disp = {n: s.dispatches for n, s in self.sites.items()}
            total = sum(disp.values())
            if total > 0:
                name = max(disp, key=disp.get)
                return name, disp[name] / total
            return None

    # ---- HBM accounting ------------------------------------------------
    def note_buffer(self, name: str, nbytes) -> None:
        """Register (or resize) one named device buffer in the memory
        model; the running total's high-water is hbm_peak_bytes."""
        try:
            nb = int(nbytes)
        except (TypeError, ValueError):
            return
        with self._lock:
            self._buffers[name] = nb
            cur = sum(self._buffers.values())
            if cur > self.hbm_peak_bytes:
                self.hbm_peak_bytes = cur

    def drop_buffer(self, name: str) -> None:
        with self._lock:
            self._buffers.pop(name, None)

    def hbm_current_bytes(self) -> int:
        with self._lock:
            return sum(self._buffers.values())

    def hbm_buffers(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._buffers)

    # ---- rollup --------------------------------------------------------
    def snapshot(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """The `prof{}` artifact block (schema notes in obs/schema.py).
        None when nothing was recorded and the mode is cheap (so
        un-instrumented artifacts carry no empty noise block) unless
        `force`."""
        with self._lock:
            sites = {n: s.as_dict() for n, s in self.sites.items()}
            buffers = dict(self._buffers)
            peak = self.hbm_peak_bytes
        if not force and not sites and not buffers \
                and self.mode == self.CHEAP:
            return None
        out: Dict[str, Any] = {"mode": self.mode, "sites": sites}
        hbm: Dict[str, Any] = {"buffers": buffers, "peak_bytes": peak}
        measured = _measured_peak()
        if measured is not None:
            hbm["measured_peak_bytes"] = measured
        out["hbm"] = hbm
        if self.xla_trace_dir:
            out["xla_trace_dir"] = self.xla_trace_dir
        return out


def _measured_peak() -> Optional[int]:
    from .telemetry import device_mem_high_water
    return device_mem_high_water()


def wrap(name: str, fn):
    """Register `fn` (an engine step that runs device work) as the
    named dispatch site.  The active recorder's Profiler is resolved at
    CALL time; with no live recorder (NullTelemetry.prof is None) the
    wrapper is one getattr + a None test.  The wrapper keeps fn's name
    and docstring (engine methods are wrapped where they are defined)."""
    def profiled(*args, **kwargs):
        prof = getattr(_cur(), "prof", None)
        if prof is None:
            return fn(*args, **kwargs)
        return prof.record(name, fn, args, kwargs)

    functools.update_wrapper(profiled, fn)
    profiled.profiler_site = name
    return profiled


def note_buffer(name: str, nbytes) -> None:
    """Module-level HBM-model convenience for engine code: a no-op
    unless a live recorder (with a Profiler) is installed."""
    prof = getattr(_cur(), "prof", None)
    if prof is not None:
        prof.note_buffer(name, nbytes)


# ------------------------------------------------------- rollup helpers

def attribution(summary: Dict[str, Any]) -> Dict[str, Any]:
    """How much of the measured search wall the named sites explain —
    the reference's `make prof-check` acceptance metric.  Pure dict
    math: works on any jaxmc.metrics/4 artifact."""
    prof = summary.get("prof") or {}
    sites = prof.get("sites") or {}
    attributed = sum((s.get("wall_s") or 0.0)
                     + (s.get("analysis_wall_s") or 0.0)
                     for s in sites.values())
    search = None
    for ph in summary.get("phases", []) or []:
        if ph.get("name") == "search":
            search = ph.get("wall_s")
            break
    share = (attributed / search) if search else None
    return {"attributed_wall_s": round(attributed, 6),
            "search_wall_s": search,
            "share": None if share is None else round(share, 4)}


# package-namespace aliases (obs.prof_wrap / obs.prof_attribution):
# "wrap" and "attribution" are too generic at the obs level
prof_wrap = wrap
prof_attribution = attribution


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:,.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:,.1f}TB"


def cmd_top(args, out=None) -> int:
    """`python -m jaxmc_torch.obs top FILE` — the per-site table: wall,
    share of the search wall, dispatches, bytes per dispatch,
    recompiles; plus the HBM model.  Exit 2 when the artifact carries
    no prof block (pre-/4 artifact, or an un-instrumented run)."""
    import json
    import sys
    out = out if out is not None else sys.stdout
    with open(args.file, encoding="utf-8") as fh:
        summary = json.load(fh)
    prof = summary.get("prof")
    if not isinstance(prof, dict) or not (prof.get("sites")
                                          or prof.get("hbm")):
        print(f"error: {args.file}: no prof block (run with --profile, "
              f"or any telemetry-enabled run on jaxmc.metrics/4+)",
              file=sys.stderr)
        return 2
    sites: Dict[str, Dict[str, Any]] = prof.get("sites") or {}
    att = attribution(summary)
    search = att["search_wall_s"]
    print(f"== prof top: {args.file} (mode={prof.get('mode')})",
          file=out)
    rows: List[Tuple[str, Dict[str, Any]]] = sorted(
        sites.items(),
        key=lambda kv: (-(kv[1].get("wall_s") or 0.0),
                        -kv[1].get("dispatches", 0)))
    if rows:
        w = max(len(n) for n, _ in rows)
        print(f"  {'site':<{w}}  {'wall':>9}  {'share':>6}  "
              f"{'disp':>6}  {'arg/disp':>10}  {'res/disp':>10}  "
              f"{'recomp':>6}", file=out)
        for name, s in rows:
            wall = s.get("wall_s")
            share = (wall / search * 100.0) if wall and search else None
            d = max(s.get("dispatches", 0), 1)
            print(
                f"  {name:<{w}}  "
                f"{'-' if wall is None else f'{wall:9.3f}s'[:10]:>9}  "
                f"{'-' if share is None else f'{share:5.1f}%':>6}  "
                f"{s.get('dispatches', 0):>6}  "
                f"{_fmt_bytes(s.get('arg_bytes', 0) / d if s.get('arg_bytes') else None):>10}  "
                f"{_fmt_bytes(s.get('res_bytes', 0) / d if s.get('res_bytes') else None):>10}  "
                f"{s.get('recompiles', 0):>6}", file=out)
    else:
        print("  (no dispatch sites recorded)", file=out)
    if att["share"] is not None:
        print(f"attributed {att['share'] * 100.0:.1f}% of the search "
              f"wall ({att['attributed_wall_s']:.3f}s of "
              f"{search:.3f}s)", file=out)
    hbm = prof.get("hbm") or {}
    bufs = hbm.get("buffers") or {}
    if bufs or hbm.get("peak_bytes"):
        meas = hbm.get("measured_peak_bytes")
        print(f"hbm model: peak {_fmt_bytes(hbm.get('peak_bytes'))}"
              + (f" (measured {_fmt_bytes(meas)})"
                 if meas is not None else ""), file=out)
        for bname in sorted(bufs, key=lambda b: -bufs[b]):
            print(f"  {bname:<28} {_fmt_bytes(bufs[bname]):>12}",
                  file=out)
    return 0
