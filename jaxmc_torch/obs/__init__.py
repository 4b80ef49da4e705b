r"""jaxmc_torch.obs — run telemetry (phase spans, counters, per-level BFS
metrics) with JSONL trace streaming, a JSON summary artifact, a
watchdog heartbeat/stall monitor, distributed trace context, a
search-progress/ETA estimator, a per-dispatch device profiler with an
HBM model, and a cross-run report CLI: the port of jaxmc/obs/.

    from jaxmc_torch import obs

    tel = obs.Telemetry(trace_path="run.jsonl", meta={"backend": "torch"})
    wd = obs.Watchdog(tel).start()           # heartbeat + stall events
    with obs.use(tel):                       # engines see it via current()
        with tel.span("load"):
            ...
    wd.stop()
    tel.write_metrics("m.json", result={...})

Engines report through `obs.current()` — a no-op NullTelemetry unless a
real recorder is installed — so instrumentation costs nothing when no
artifact was requested.  `reset()` installs and returns a fresh
recording Telemetry as the process-wide recorder (for callers that run
several searches and read each one's counters).  context, schema,
progress, ledger, timeline, report and watchdog are copies of the
reference's JAX-free modules; telemetry and prof read torch where the
reference reads jax.  `python -m jaxmc_torch.obs
report|diff|timeline|top|history` renders artifacts.
"""

from . import context
from . import telemetry as _telemetry
from .telemetry import (Logger, NullTelemetry, Telemetry, current,
                        device_mem_high_water, environment_meta,
                        prom_name, rss_bytes, use, use_local,
                        write_json_atomic)
from .context import TraceContext, child_env
from .ledger import append_summary, ledger_path
from .prof import Profiler, note_buffer, prof_attribution, prof_wrap
from .progress import ProgressEstimator, attach_estimator, eta_suffix
from .schema import (CHECK_KEYS, HEARTBEAT_KEYS, REQUIRED_KEYS,
                     RESULT_KEYS, SCHEMA, SCHEMAS, STALL_KEYS,
                     validate_summary, validate_trace_event)
from .watchdog import Watchdog


def reset() -> Telemetry:
    """Install a fresh recording Telemetry as the process-wide recorder
    and return it (one per run in callers that run several)."""
    tel = Telemetry()
    _telemetry._CURRENT = tel
    return tel


__all__ = ["Logger", "NullTelemetry", "Profiler", "Telemetry",
           "Watchdog", "TraceContext", "ProgressEstimator",
           "append_summary", "attach_estimator", "child_env", "context",
           "current", "device_mem_high_water", "environment_meta",
           "eta_suffix", "ledger_path", "note_buffer",
           "prof_attribution", "prof_wrap", "prom_name", "reset",
           "rss_bytes", "use", "use_local", "write_json_atomic",
           "SCHEMA", "SCHEMAS", "REQUIRED_KEYS", "CHECK_KEYS",
           "RESULT_KEYS", "HEARTBEAT_KEYS", "STALL_KEYS",
           "validate_summary", "validate_trace_event"]
