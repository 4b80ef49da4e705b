r"""`python -m jaxmc_torch.obs timeline <artifacts...>` — merge multi-process
JSONL traces into one causally-ordered per-process-lane view.

Every trace file opens with a `proc_meta` header (obs/telemetry.py):
pid, argv, env fingerprint, a monotonic-clock anchor, the process's
span id (`psid`) and the span of whoever spawned it (`parent_span`,
carried over the JAXMC_TRACE_CTX env var — obs/context.py).  Fork-pool
workers write no files of their own; the parent's trace carries one
`parallel.worker_span` event per worker pid instead.  From those two
sources the renderer reconstructs the process tree, assigns every file
a LANE, and prints all events merged in time order with lane tags.

Diagnostics:
  orphan spans   a lane whose parent_span resolves to no known process
                 span — a broken propagation hop (the chaos suite pins
                 zero orphans across worker SIGKILL + respawn);
  gaps           a silent stretch inside one lane longer than
                 --gap-threshold while the run was live — where to look
                 when a fleet wedged;
  heartbeat/stall events render with their stalled_for/threshold fields
                 (the PR-2 grammar), so a stalled lane is visible inline.

The last line is machine-parseable (the trace-check gate asserts on
it):

    summary: files=N processes=N lanes=N events=N orphans=N gaps=N

Stdlib-only, like the rest of the report path: timeline must work where
only the interpreter backend runs.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def _load_events(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path, encoding="utf-8") as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln:
                continue
            try:
                ev = json.loads(ln)
            except ValueError:
                continue  # torn final line of a killed writer
            if isinstance(ev, dict):
                out.append(ev)
    return out


def _ev_time(ev: Dict[str, Any]) -> Optional[float]:
    t = ev.get("t0") if ev.get("ev") == "span" else ev.get("t")
    return t if isinstance(t, (int, float)) else None


class _Lane:
    __slots__ = ("key", "label", "pid", "span", "parent", "events",
                 "source", "command")

    def __init__(self, key, pid, span, parent, source, command=None):
        self.key = key
        self.label = ""
        self.pid = pid
        self.span = span
        self.parent = parent
        self.source = source
        self.command = command
        self.events: List[Dict[str, Any]] = []


def _describe(ev: Dict[str, Any]) -> str:
    kind = ev.get("ev")
    if kind == "proc_meta":
        return f"proc_meta pid={ev.get('pid')}"
    if kind == "run_start":
        cmd = (ev.get("meta") or {}).get("command")
        return f"run_start {cmd or ''}".rstrip()
    if kind == "span_open":
        return f"span_open {ev.get('name')}"
    if kind == "span":
        err = f" ERROR={ev['error']}" if ev.get("error") else ""
        return f"span {ev.get('name')} ({ev.get('wall_s')}s){err}"
    if kind == "level":
        return (f"level {ev.get('level')} "
                f"distinct={ev.get('distinct')} "
                f"queue={ev.get('queue')}")
    if kind == "heartbeat":
        extra = ""
        if ev.get("progress_verdict") is not None:
            extra = f" progress={ev.get('progress_fraction')}" \
                    f" verdict={ev['progress_verdict']}"
        return (f"heartbeat stalled_for={ev.get('stalled_for_s')}s "
                f"level={ev.get('last_level')}{extra}")
    if kind == "stall":
        return (f"STALL {ev.get('stalled_for_s')}s "
                f"(threshold {ev.get('threshold_s')}s) "
                f"open={'>'.join(ev.get('open_spans') or [])}")
    if kind == "log":
        msg = str(ev.get("msg") or "")
        return f"log {msg[:90]}"
    if kind == "parallel.worker_span":
        return (f"worker_span pid={ev.get('pid')} "
                f"span={str(ev.get('span'))[:8]}")
    return str(kind)


def cmd_timeline(args, out) -> int:
    lanes: List[_Lane] = []
    psids: Dict[str, _Lane] = {}  # process span id -> its file lane
    trace_ids: set = set()
    files_loaded = 0
    for path in args.files:
        evs = _load_events(path)
        files_loaded += 1
        meta = next((e for e in evs if e.get("ev") == "proc_meta"), None)
        run0 = next((e for e in evs if e.get("ev") == "run_start"), None)
        cmd = (run0 or {}).get("meta", {}).get("command") \
            if run0 else None
        if meta is not None:
            lane = _Lane(path, meta.get("pid"), meta.get("psid"),
                         meta.get("parent_span"), path, cmd)
            if meta.get("psid"):
                # several recorders in one process (a daemon's fleet +
                # in-process job tels) share one psid; the first file
                # seen resolves it
                psids.setdefault(meta["psid"], lane)
        else:  # pre-PR-16 artifact: still render, just unparented
            lane = _Lane(path, None, None, None, path, cmd)
        for e in evs:
            if e.get("tid"):
                trace_ids.add(e["tid"])
        lane.events = evs
        lanes.append(lane)

    # fork-pool workers: lanes synthesized from the parents' events
    worker_lanes: List[_Lane] = []
    for lane in list(lanes):
        for e in lane.events:
            if e.get("ev") == "parallel.worker_span":
                wl = _Lane(f"worker:{e.get('span')}", e.get("pid"),
                           e.get("span"), e.get("parent"),
                           lane.source, "worker")
                wl.events = [e]
                worker_lanes.append(wl)
    lanes.extend(worker_lanes)

    # ---- process tree + orphan detection ----
    orphans = []
    for lane in lanes:
        if lane.parent is not None and lane.parent not in psids:
            orphans.append(lane)

    pids = {ln.pid for ln in lanes if ln.pid is not None}
    for i, lane in enumerate(sorted(
            lanes, key=lambda ln: (_ev_time(ln.events[0])
                                   if ln.events and
                                   _ev_time(ln.events[0]) is not None
                                   else 0.0))):
        lane.label = f"P{i}"

    tid_txt = ",".join(sorted(trace_ids)) or "none"
    print(f"timeline: {files_loaded} file"
          f"{'s' if files_loaded != 1 else ''}, "
          f"{len(pids)} process{'es' if len(pids) != 1 else ''}, "
          f"trace {tid_txt}", file=out)
    for lane in sorted(lanes, key=lambda ln: ln.label):
        par = psids.get(lane.parent)
        ptxt = "(root)" if lane.parent is None else \
            (f"parent={par.label}" if par is not None
             else f"parent=ORPHAN({str(lane.parent)[:8]})")
        span8 = str(lane.span)[:8] if lane.span else "-"
        print(f"  {lane.label:<4} pid={lane.pid or '?':<8} "
              f"{(lane.command or '?'):<16} {ptxt:<22} "
              f"span={span8} events={len(lane.events)}", file=out)

    # ---- merged, time-ordered event listing ----
    tagged = []
    for lane in lanes:
        if lane.command == "worker":
            continue  # worker lanes' one event renders via the parent
        for e in lane.events:
            t = _ev_time(e)
            if t is not None:
                tagged.append((t, lane.label, e))
    tagged.sort(key=lambda x: (x[0], x[1]))
    t0 = tagged[0][0] if tagged else 0.0

    gaps = 0
    last_per_lane: Dict[str, float] = {}
    limit = args.limit if args.limit and args.limit > 0 else len(tagged)
    shown = 0
    for t, label, e in tagged:
        prev = last_per_lane.get(label)
        last_per_lane[label] = t
        if prev is not None and t - prev > args.gap_threshold:
            gaps += 1
            print(f"  ........ {label} silent for {t - prev:.1f}s "
                  f"(gap threshold {args.gap_threshold:.0f}s)",
                  file=out)
        if shown < limit:
            print(f"  +{t - t0:9.3f}s {label:<4} {_describe(e)}",
                  file=out)
            shown += 1
    if shown < len(tagged):
        print(f"  ... {len(tagged) - shown} more events "
              f"(--limit {args.limit})", file=out)

    for lane in orphans:
        print(f"  ORPHAN: {lane.label} ({lane.source}) parent span "
              f"{lane.parent} not found in any artifact — broken "
              f"trace-context hop or missing file", file=out)
    print(f"summary: files={files_loaded} processes={len(pids)} "
          f"lanes={len(lanes)} events={len(tagged)} "
          f"orphans={len(orphans)} gaps={gaps}", file=out)
    if args.fail_on_orphans and orphans:
        return 1
    return 0
