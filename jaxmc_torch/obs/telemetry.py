r"""Run telemetry: spans, counters, per-level BFS records (the port of
jaxmc/obs/telemetry.py).

Every engine phase reports into one `Telemetry` object: phases as spans
(wall time, nesting), scalar counters/gauges (expansion-mode tallies,
memo-cache hits, fingerprint occupancy, device-memory high-water), and
one record per BFS level (frontier/generated/distinct).  Events stream
as JSONL (`--trace FILE`) while the run is live -- a killed process
leaves `span_open` events naming the phase it died in -- and roll up
into an end-of-run summary (`--metrics-out FILE`, schema in
obs/schema.py).

Telemetry is a PARALLEL channel: TLC-style stdout stays byte-identical.
Engines reach the active recorder through `current()` (a NullTelemetry
by default, every method a no-op), so deep code needs no constructor
plumbing; the CLI installs a real recorder with `use(...)` only when the
user asked for an artifact.  The device functions at the end read torch
(imported lazily) where the reference reads jax.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from . import context as trace_context
from .prof import Profiler  # per-dispatch attribution + HBM model
from .schema import SCHEMA  # one source of truth for the artifact schema

# every live recorder keeps the last N trace events in memory (the
# serve daemon's GET /jobs/<id>/events reads them mid-run); bounded so
# a long search cannot grow the daemon without limit
_RING_MAX = int(os.environ.get("JAXMC_TRACE_RING", "256") or "256")


def write_json_atomic(path: str, obj) -> None:
    """Dump `obj` as JSON via a sibling tmp file + os.replace, so a
    crash mid-write never leaves a truncated artifact.  Creates the
    parent directory: a bench leg must not burn minutes of measurement
    and then die because --out-dir didn't exist yet."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, indent=1, sort_keys=False)
        fh.write("\n")
    os.replace(tmp, path)


def _jsonable(v):
    """Best-effort plain-JSON coercion for attribute values."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:  # numpy scalars
        return v.item()
    except Exception:  # non-scalar array, no .item(): never break a run
        return str(v)


class _SpanHandle:
    """Context manager for one phase span. Re-entrant use is not needed:
    each `span()` call makes a fresh handle."""

    __slots__ = ("tel", "name", "attrs", "t0", "_done")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict[str, Any]):
        self.tel = tel
        self.name = name
        self.attrs = attrs
        self.t0 = None
        self._done = False

    def __enter__(self):
        self.t0 = self.tel._clock()
        self.tel._span_open(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.done(error=exc_type.__name__ if exc_type else None)
        return False

    def done(self, error: Optional[str] = None):
        if self._done:
            return
        self._done = True
        self.tel._span_close(self, error)


class NullTelemetry:
    """The default recorder: every method a no-op, so instrumented hot
    paths cost one attribute lookup and a truth test when telemetry is
    off."""

    enabled = False
    progress_seq = 0  # never advances: a watchdog on a null recorder
    # would see an eternal stall, so Watchdog refuses to start on one
    progress_est = None  # a ProgressEstimator when one is attached
    # (obs/progress.py); engines read it via getattr, so the null
    # recorder's class attribute keeps the hot path allocation-free
    prof = None  # a Profiler on live recorders (obs/prof.py); the
    # class-level None keeps prof.wrap's per-dispatch check to one
    # getattr + a None test when telemetry is off

    def recent_events(self) -> List[Dict[str, Any]]:
        return []

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def counter(self, name: str, inc: int = 1) -> None:
        pass

    def gauge(self, name: str, value) -> None:
        pass

    def high_water(self, name: str, value) -> None:
        pass

    def level(self, index: int, **fields) -> None:
        pass

    def reset_levels(self, reason: str = "") -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def log_line(self, msg: str) -> None:
        pass

    def set_meta(self, **fields) -> None:
        pass

    def close(self) -> None:
        pass


class _NullSpan:
    __slots__ = ()

    @property
    def attrs(self):
        # a fresh throwaway dict per access: callers may annotate
        # (`span.attrs["outcome"] = ...`) without caring whether
        # telemetry is live
        return {}

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def done(self, error=None):
        pass


_NULL_SPAN = _NullSpan()


class Telemetry(NullTelemetry):
    """A run recorder. Thread-safe: bench workers and engine threads may
    report into one instance (spans nest per-thread via a thread-local
    stack; counters/levels share one lock)."""

    enabled = True

    def __init__(self, trace_path: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 clock=time.time):
        self._clock = clock
        self._lock = threading.Lock()
        self._local = threading.local()
        self.t_start = clock()
        # bumped on every span open/close and level record — the
        # watchdog's liveness signal: a run whose progress_seq stops
        # moving is wedged inside whatever span is still open
        self.progress_seq = 0
        self.meta: Dict[str, Any] = dict(meta or {})
        # phases aggregate spans by name, in first-start order
        self._phases: Dict[str, Dict[str, Any]] = {}
        self._open_spans: List[_SpanHandle] = []
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, Any] = {}
        self.levels: List[Dict[str, Any]] = []
        self.progress_est = None  # attached by obs.progress when the
        # model binds and analyze offers a state-space estimate
        # always-on cheap profiler (dispatch counts + recompiles only);
        # the CLI flips mode to wall/xla under --profile
        self.prof = Profiler()
        self._ring: collections.deque = collections.deque(maxlen=_RING_MAX)
        # the trace context is derived once per process; every event
        # this recorder emits is stamped with its trace_id so fleet
        # artifacts merge into one causally-ordered timeline
        self.ctx = trace_context.get()
        self._trace_fh = None
        if trace_path:
            self._trace_fh = open(trace_path, "w", encoding="utf-8")
        # the per-file meta header: pid/argv/env fingerprint
        # plus a monotonic-clock anchor, so `obs timeline` can place
        # this file's process in the trace tree and skew-align its
        # wall-clock timestamps against the other processes'
        self._emit({"ev": "proc_meta", "t": self.t_start,
                    "mono": time.monotonic(), "pid": os.getpid(),
                    "argv": list(sys.argv), "psid": self.ctx.span_id,
                    "parent_span": self.ctx.parent_span_id,
                    "env": environment_meta()})
        self._emit({"ev": "run_start", "t": self.t_start,
                    "meta": _jsonable(self.meta)})

    # ---- trace stream ----
    def _emit(self, obj: Dict[str, Any]) -> None:
        obj.setdefault("tid", self.ctx.trace_id)
        with self._lock:
            # the in-memory ring is fed even with no trace file: the
            # serve daemon reads it live for /jobs/<id>/events
            self._ring.append(obj)
            fh = self._trace_fh
            if fh is None:
                return
            try:
                fh.write(json.dumps(obj) + "\n")
                fh.flush()
            except ValueError:  # closed file: late event after close()
                pass

    def recent_events(self) -> List[Dict[str, Any]]:
        """A snapshot of the last ~_RING_MAX trace events (newest last).
        Short critical section only — safe to call from a scrape thread
        while engine threads emit."""
        with self._lock:
            return list(self._ring)

    # ---- spans ----
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        return _SpanHandle(self, name, {k: _jsonable(v)
                                        for k, v in attrs.items()})

    def _span_open(self, h: _SpanHandle) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(h.name)
        with self._lock:
            self.progress_seq += 1
            self._open_spans.append(h)
            ph = self._phases.setdefault(
                h.name, {"name": h.name, "wall_s": 0.0, "count": 0,
                         "open": 0})
            ph["open"] += 1
        self._emit({"ev": "span_open", "name": h.name, "t": h.t0,
                    "parent": parent, "attrs": h.attrs})

    def _span_close(self, h: _SpanHandle, error: Optional[str]) -> None:
        t1 = self._clock()
        stack = self._stack()
        if stack and stack[-1] == h.name:
            stack.pop()
        with self._lock:
            self.progress_seq += 1
            if h in self._open_spans:
                self._open_spans.remove(h)
            ph = self._phases[h.name]
            ph["wall_s"] += t1 - h.t0
            ph["count"] += 1
            ph["open"] -= 1
        ev = {"ev": "span", "name": h.name, "t0": h.t0,
              "wall_s": round(t1 - h.t0, 6), "attrs": h.attrs}
        if error:
            ev["error"] = error
        self._emit(ev)

    # ---- scalars ----
    def counter(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + inc

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = _jsonable(value)

    def high_water(self, name: str, value) -> None:
        if value is None:
            return
        value = _jsonable(value)
        with self._lock:
            old = self.gauges.get(name)
            if old is None or value > old:
                self.gauges[name] = value

    # ---- per-level BFS records ----
    def level(self, index: int, **fields) -> None:
        rec = {"level": int(index)}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        with self._lock:
            self.progress_seq += 1
            self.levels.append(rec)
        self._emit(dict(rec, ev="level", t=self._clock()))
        pe = self.progress_est
        if pe is not None:  # feed the ETA estimator per level, so the
            # `search.progress_est` gauge moves with the frontier even
            # between --progress-every lines
            if rec.get("distinct") is not None:
                fr = pe.observe(distinct=rec["distinct"])
            elif rec.get("new") is not None:
                fr = pe.observe(new=rec["new"])
            else:
                fr = None
            if fr is not None:
                self.gauge("search.progress_est", fr)

    def reset_levels(self, reason: str = "") -> None:
        """A search RESTART (hybrid demotion, adaptive relayout) replays
        from level 0: drop the stale records so the summary's level list
        describes the search that produced the final counts. The trace
        stream keeps everything, separated by this restart event."""
        with self._lock:
            n = len(self.levels)
            self.levels = []
        self.counter("search.restarts")
        self._emit({"ev": "search_restart", "t": self._clock(),
                    "reason": reason, "levels_dropped": n})

    # ---- free-form events / log mirror ----
    def event(self, name: str, **fields) -> None:
        self._emit(dict({k: _jsonable(v) for k, v in fields.items()},
                        ev=name, t=self._clock()))

    def log_line(self, msg: str) -> None:
        self._emit({"ev": "log", "t": self._clock(), "msg": msg})

    def set_meta(self, **fields) -> None:
        with self._lock:
            self.meta.update({k: _jsonable(v) for k, v in fields.items()})

    def watch_snapshot(self) -> Dict[str, Any]:
        """One consistent liveness snapshot for the watchdog: the
        progress sequence number, the open-span names (outermost first),
        the last completed BFS level, and the per-level wall times (for
        the stall threshold's median)."""
        with self._lock:
            last = self.levels[-1] if self.levels else None
            return {
                "progress_seq": self.progress_seq,
                "open_spans": [h.name for h in self._open_spans],
                "last_level": None if last is None else last.get("level"),
                "level_walls": [r["wall_s"] for r in self.levels
                                if isinstance(r.get("wall_s"),
                                              (int, float))],
            }

    def metrics_snapshot(self) -> Dict[str, Any]:
        """Consistent copies of the scalar surfaces for a live scrape
        (the serve daemon's /metrics) — short critical section, never
        blocks the emitting threads for long."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "levels": list(self.levels)}

    # ---- rollup ----
    def phase_list(self) -> List[Dict[str, Any]]:
        """Phases in first-start order; spans still open contribute their
        elapsed-so-far with open=True (the deadline-blowout forensics:
        a partial span names its culprit)."""
        now = self._clock()
        with self._lock:
            out = []
            open_extra: Dict[str, float] = {}
            for h in self._open_spans:
                open_extra[h.name] = open_extra.get(h.name, 0.0) \
                    + (now - h.t0)
            for ph in self._phases.values():
                d = {"name": ph["name"],
                     "wall_s": round(ph["wall_s"]
                                     + open_extra.get(ph["name"], 0.0), 6),
                     "count": ph["count"] + ph["open"]}
                if ph["open"]:
                    d["open"] = True
                out.append(d)
            return out

    def summary(self, result: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            levels = list(self.levels)
            meta = dict(self.meta)
        out = {
            "schema": SCHEMA,
            "started_at": self.t_start,
            "wall_s": round(self._clock() - self.t_start, 6),
            "phases": self.phase_list(),
            "counters": counters,
            "gauges": gauges,
            "levels": levels,
        }
        out.update(meta)
        prof = self.prof
        if prof is not None:
            pb = prof.snapshot()
            if pb is not None:
                out["prof"] = pb  # additive /4 block (obs/schema.py)
        if result is not None:
            out["result"] = _jsonable(result)
        return out

    def write_metrics(self, path: str,
                      result: Optional[Dict[str, Any]] = None) -> None:
        s = self.summary(result)
        write_json_atomic(path, s)
        # every artifact-writing run is a trajectory point: record it in
        # the persistent ledger (no-op when JAXMC_LEDGER=off, never
        # raises — the ledger must not break a run)
        try:
            from .ledger import append_summary
            append_summary(s, source=path)
        except Exception:  # noqa: BLE001
            pass

    def close(self) -> None:
        self._emit({"ev": "run_end", "t": self._clock()})
        fh = self._trace_fh
        self._trace_fh = None
        if fh is not None:
            fh.close()


# ---- the process-wide current recorder ----

_CURRENT: NullTelemetry = NullTelemetry()

# per-thread override: the serve daemon runs several check
# jobs concurrently in worker threads, each with its OWN recorder —
# a single process-global slot would interleave their spans/levels.
# current() consults the thread-local first, so engine code needs no
# plumbing changes; the main-thread CLI keeps using the global `use`.
_TLS = threading.local()


def current() -> NullTelemetry:
    """The active recorder: this thread's `use_local` override if one is
    installed, else the process-wide one (a shared no-op unless the
    CLI/bench installed a real recorder)."""
    tel = getattr(_TLS, "tel", None)
    return tel if tel is not None else _CURRENT


class use:
    """Install `tel` as the process-wide recorder for a with-block."""

    def __init__(self, tel: NullTelemetry):
        self.tel = tel
        self._prev = None

    def __enter__(self):
        global _CURRENT
        self._prev = _CURRENT
        _CURRENT = self.tel
        return self.tel

    def __exit__(self, *a):
        global _CURRENT
        _CURRENT = self._prev
        return False


class use_local:
    """Install `tel` as THIS THREAD's recorder for a with-block (wins
    over the process-wide one inside the block).  The serve daemon's
    per-job telemetry channel: each worker thread records its job's
    spans/levels/counters into a private recorder while the daemon's
    fleet recorder keeps the global view."""

    def __init__(self, tel: NullTelemetry):
        self.tel = tel
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "tel", None)
        _TLS.tel = self.tel
        return self.tel

    def __exit__(self, *a):
        _TLS.tel = self._prev
        return False


class Logger:
    """The ONE engine log sink: prints the TLC-style line (unless quiet)
    and mirrors it into the telemetry trace. Replaces the ad-hoc
    `(lambda s: None) if quiet else print` plumbing in cli.py — every
    engine's `log:` callback funnels through here so stdout and the
    trace always carry the same strings."""

    __slots__ = ("tel", "quiet", "sink")

    def __init__(self, tel: Optional[NullTelemetry] = None,
                 quiet: bool = False, sink=print):
        self.tel = tel
        self.quiet = quiet
        self.sink = sink

    def __call__(self, msg: str) -> None:
        if not self.quiet:
            self.sink(msg)
        tel = self.tel if self.tel is not None else current()
        tel.log_line(msg)


def prom_name(name: str) -> str:
    """Map an internal dotted metric name onto the Prometheus exposition
    grammar (documented in obs/schema.py): `jaxmc_` prefix, every char
    outside [a-zA-Z0-9_] replaced by `_`.  `serve.warm_hits` ->
    `jaxmc_serve_warm_hits`."""
    return "jaxmc_" + "".join(
        c if (c.isascii() and (c.isalnum() or c == "_")) else "_"
        for c in name)


def rss_bytes() -> Optional[int]:
    """This process's resident set size, or None when the platform has
    no cheap way to ask. /proc is the normal path (linux containers);
    the getrusage fallback reports the PEAK rss, which is still the
    useful number for a watchdog heartbeat."""
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss_kb) * 1024
    except Exception:  # noqa: BLE001 — diagnostics must not mask
        return None




_SMI: Optional[str] = None


def _nvidia_smi() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, or None where there is no nvidia-smi (read once a
    process: every recorder stamps it)."""
    global _SMI
    if _SMI is None:
        import shutil
        import subprocess
        line = ""
        exe = shutil.which("nvidia-smi")
        if exe:
            try:
                out = subprocess.run(
                    [exe, "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=20).stdout.strip().splitlines()
                line = out[0].strip() if out else ""
            except (OSError, subprocess.SubprocessError):
                line = ""
        _SMI = line
    return _SMI or None


def environment_meta(device=None) -> Dict[str, Any]:
    """The environment fingerprint recorded in the metrics `meta` block
    so `python -m jaxmc_torch.obs diff` can attribute a regression to an
    environment change instead of a code change.  The reference's keys
    (`jax_version` is always None here) plus `torch_version` and, where
    nvidia-smi exists, the card's name and power limit.  Torch is read
    only when the caller already imported it, and CUDA is never
    initialised for telemetry's sake; `device` (the run's torch device,
    once the session resolved it) names the platform the run uses."""
    out: Dict[str, Any] = {"python": sys.version.split()[0],
                           "jax_version": None, "platform": None,
                           "device_count": None, "torch_version": None}
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch_version"] = getattr(torch, "__version__", None)
        try:
            if device is not None:
                cuda = getattr(device, "type", str(device)) == "cuda"
            else:
                cuda = torch.cuda.is_available()
            out["platform"] = "gpu" if cuda else "cpu"
            out["device_count"] = torch.cuda.device_count() if cuda else 1
        except Exception:  # noqa: BLE001 — a broken driver must not
            pass           # break telemetry
    smi = _nvidia_smi()
    if smi:
        name, _, limit = smi.rpartition(",")
        out["gpu_name"] = name.strip() if name else smi
        out["gpu_power_limit"] = limit.strip() if name else None
    return out


def device_mem_high_water() -> Optional[int]:
    """Peak bytes the CUDA caching allocator handed out
    (`torch.cuda.max_memory_allocated`), or None when the process never
    initialised CUDA.  Never raises -- telemetry must not break a run."""
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.max_memory_allocated())
    except Exception:  # noqa: BLE001 — diagnostics must not mask
        return None
