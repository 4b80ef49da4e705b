r"""Dapper-style trace context, carried across every process boundary.

One CHECK — wherever it fans out — shares one ``trace_id``.  Each
process gets its own process-span id, parented on the span of whoever
spawned it, so artifacts from a whole fleet (serve daemon ->
device-owner -> job sessions, bench parent -> children, fork-pool
workers, oracle / cache-guard probes) can be merged back into a single
causally-ordered timeline (``python -m jaxmc_torch.obs timeline``).

The wire format is deliberately tiny — one env var:

    JAXMC_TRACE_CTX = "<trace_id>:<parent_span_id>"

Both ids are 16 lowercase hex chars.  A process that finds the var in
its environment INHERITS the trace; one that does not MINTS a fresh
trace_id and becomes a root.  ``fork`` children (the parallel engine's
worker pool) inherit the parent's in-memory context; the pid check in
``get()`` re-derives their own process span lazily, parented on the
forking process — no env round-trip needed, and a respawned worker
keeps the original trace_id by construction (the chaos suite pins
this).

Everything here is stdlib-only and import-light: obs must stay safe to
import before jax and inside every subprocess.
"""

from __future__ import annotations

import contextlib
import os
import threading
import uuid
from typing import Dict, Optional

ENV_VAR = "JAXMC_TRACE_CTX"

_lock = threading.Lock()
_ctx: Optional["TraceContext"] = None


def new_span_id() -> str:
    """A fresh 16-hex span/trace id (uuid4-derived, no coordination)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """This process's position in the trace tree."""

    __slots__ = ("trace_id", "parent_span_id", "span_id", "pid")

    def __init__(self, trace_id: str, parent_span_id: Optional[str],
                 span_id: str, pid: int):
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.span_id = span_id
        self.pid = pid

    def header(self) -> str:
        """The env-var value a CHILD of this process should inherit."""
        return f"{self.trace_id}:{self.span_id}"

    def lineage(self) -> Dict[str, Optional[str]]:
        """The ids worth carrying in an IPC message (fork-pool worker
        start/done/fail frames): enough for the receiver to emit a
        trace event that places this process in the tree."""
        return {"tid": self.trace_id, "span": self.span_id,
                "parent": self.parent_span_id}


def _parse_header(raw: str) -> Optional[tuple]:
    parts = raw.strip().split(":")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        return None
    return parts[0], parts[1]


def _derive(parent: Optional["TraceContext"]) -> "TraceContext":
    """Build this process's context: from a forked parent's in-memory
    context when given, else from the env header, else a fresh root."""
    if parent is not None:
        return TraceContext(parent.trace_id, parent.span_id,
                            new_span_id(), os.getpid())
    hdr = _parse_header(os.environ.get(ENV_VAR, "") or "")
    if hdr is not None:
        return TraceContext(hdr[0], hdr[1], new_span_id(), os.getpid())
    return TraceContext(new_span_id(), None, new_span_id(), os.getpid())


def get() -> TraceContext:
    """The current process's trace context (lazily derived; fork-safe:
    a context cached by a parent is re-derived in the child, keeping
    the trace_id and parenting the child span on the parent's)."""
    global _ctx
    with _lock:
        if _ctx is None:
            _ctx = _derive(None)
        elif _ctx.pid != os.getpid():  # we are a fork child
            _ctx = _derive(_ctx)
        return _ctx


def reset() -> None:
    """Drop the cached context (tests)."""
    global _ctx
    with _lock:
        _ctx = None


def child_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A copy of `env` (default: os.environ) with the trace header a
    spawned child should inherit.  Use on every subprocess env dict."""
    out = dict(os.environ if env is None else env)
    out[ENV_VAR] = get().header()
    return out


@contextlib.contextmanager
def exported():
    """Temporarily export the child header into os.environ — for spawn
    APIs that snapshot the parent environment and take no env argument
    (multiprocessing's spawn context, the device owner)."""
    prev = os.environ.get(ENV_VAR)
    os.environ[ENV_VAR] = get().header()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = prev
