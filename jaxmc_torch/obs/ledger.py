r"""Persistent run ledger: the perf trajectory as a
first-class, queryable, self-gating artifact.

Before this, the states/sec trajectory lived in loose `BENCH_r*.json` /
`MULTICHIP_r*.json` files compared pairwise by hand-picked `obs diff`
invocations — a regression between gate runs was invisible unless
someone happened to diff the right pair.  The ledger is the cross-run
memory:

  append    every bench child, `make *-check` gate leg and serve job
            appends one compact line (rung, states/sec, platform, env
            fingerprint, source, job signature) to an append-only JSONL
            (default ~/.cache/jaxmc/ledger.jsonl; JAXMC_LEDGER overrides
            the path, JAXMC_LEDGER=off disables).  Appends are
            flock-serialized and content-addressed — the entry id is a
            hash over (rung, ts, rate, sig, env, source), so re-importing
            the same artifact is idempotent and concurrent writers
            cannot corrupt or duplicate.
  history   `python -m jaxmc_torch.obs history [--rung R] [--fail-on-regress]`
            renders the per-rung trajectory across ALL recorded runs
            (not just adjacent pairs) and flags the LATEST entry per
            rung against the best of the preceding window (rolling
            best-of-`--window`), with env-change attribution reused
            from `obs diff` (report._env_changes) so a drop caused by a
            jax upgrade or a device-count change reads as such.
  --import  backfills committed artifacts (BENCH_r01..r05,
            MULTICHIP_r01..r08, any --metrics-out JSON) through
            report.load_record so the trajectory starts at r01.

Pure stdlib (no jax): the CLI must work in interp-only environments.
Writers call `append_summary` which NEVER raises — a full disk or a
read-only cache dir degrades the ledger, not the run.
"""

from __future__ import annotations

import datetime
import glob as _glob
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from . import report

DEFAULT_PATH = os.path.join("~", ".cache", "jaxmc", "ledger.jsonl")
_OFF = frozenset(("off", "0", "no", "none", "disabled"))


def ledger_path(path: Optional[str] = None) -> Optional[str]:
    """Resolve the ledger file: explicit arg wins; else JAXMC_LEDGER
    (a path, or off/0/no/none to disable -> None); else the default
    under ~/.cache."""
    if path:
        return os.path.expanduser(path)
    env = os.environ.get("JAXMC_LEDGER")
    if env is not None:
        env = env.strip()
        if env.lower() in _OFF or not env:
            return None
        return os.path.expanduser(env)
    return os.path.expanduser(DEFAULT_PATH)


def _entry_id(e: Dict[str, Any]) -> str:
    """Content address: stable over the fields that make two records
    "the same run", so concurrent appends and repeated --import of one
    artifact dedup instead of duplicating."""
    key = {k: e.get(k) for k in ("rung", "ts", "states_per_sec",
                                 "sig", "env", "source")}
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def make_entry(rung: str, states_per_sec: Optional[float],
               ts: Optional[float] = None, *,
               run: Optional[str] = None, kind: str = "metrics",
               platform: Optional[str] = None,
               env: Optional[Dict[str, Any]] = None,
               source: Optional[str] = None,
               sig: Optional[str] = None) -> Dict[str, Any]:
    e: Dict[str, Any] = {
        "v": 1,
        "ts": float(ts) if ts is not None else time.time(),
        "rung": rung,
        "run": run or rung,
        "kind": kind,
        "states_per_sec": states_per_sec,
        "platform": platform,
        "env": dict(env or {}),
        "source": source,
    }
    if sig:
        e["sig"] = sig
    e["id"] = _entry_id(e)
    return e


def append_entries(entries: List[Dict[str, Any]],
                   path: Optional[str] = None) -> int:
    """flock-serialized append of pre-built entries; returns the count
    written. Raises on IO errors — callers that must not fail use
    append_summary."""
    p = ledger_path(path)
    if p is None or not entries:
        return 0
    os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    payload = "".join(
        json.dumps(e, sort_keys=True, separators=(",", ":"),
                   default=str) + "\n"
        for e in entries)
    with open(p, "a", encoding="utf-8") as fh:
        try:
            import fcntl
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass  # non-posix / NFS without locks: plain O_APPEND
        fh.write(payload)
        fh.flush()
    return len(entries)


def _rate_of(summary: Dict[str, Any]) -> Optional[float]:
    res = summary.get("result") or {}
    gen, wall = res.get("generated"), res.get("wall_s")
    if gen and wall:
        return gen / wall
    return None


def append_summary(summary: Dict[str, Any],
                   source: Optional[str] = None,
                   rung: Optional[str] = None,
                   path: Optional[str] = None) -> bool:
    """Append one metrics summary (the dict `Telemetry.summary()`
    builds) to the ledger.  Never raises; returns False when disabled,
    when no states/sec rate computes (a trace-only or failed run has no
    trajectory point), or on any IO error."""
    try:
        p = ledger_path(path)
        if p is None:
            return False
        rate = _rate_of(summary)
        if rate is None:
            return False
        if rung is None:
            if source:
                rung = os.path.basename(source)
                for ext in (".json", ".jsonl"):
                    if rung.endswith(ext):
                        rung = rung[:-len(ext)]
            else:
                spec = summary.get("spec") or \
                    (summary.get("meta") or {}).get("spec")
                rung = os.path.basename(str(spec or "run"))
                if rung.endswith(".tla"):
                    rung = rung[:-4]
        env = dict(summary.get("env") or {})
        serve = summary.get("serve") or {}
        e = make_entry(
            rung, rate, summary.get("started_at"),
            kind="metrics",
            platform=env.get("platform")
            or (summary.get("gauges") or {}).get("device.platform"),
            env=env, source=source,
            sig=serve.get("sig"))
        return append_entries([e], p) > 0
    except Exception:  # noqa: BLE001 — the ledger never breaks a run
        return False


def read_entries(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """All entries, torn-line tolerant, deduped by id (first wins)."""
    p = ledger_path(path)
    out: List[Dict[str, Any]] = []
    seen = set()
    if p is None or not os.path.exists(p):
        return out
    with open(p, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                e = json.loads(line)
            except ValueError:
                continue  # torn tail from a crashed writer
            if not isinstance(e, dict) or "rung" not in e:
                continue
            eid = e.get("id") or _entry_id(e)
            if eid in seen:
                continue
            seen.add(eid)
            out.append(e)
    return out


# ---------------------------------------------------------------- import

def _parse_ts(v) -> Optional[float]:
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return datetime.datetime.fromisoformat(
                v.replace("Z", "+00:00")).timestamp()
        except ValueError:
            return None
    return None


def entries_from_artifact(path: str) -> List[Dict[str, Any]]:
    """Ledger entries for one committed artifact via report.load_record
    — one per run for metrics/bench shapes, one per (rung, devices)
    curve point for multichip scaling artifacts."""
    rec = report.load_record(path)
    mtime = os.path.getmtime(path)
    env = report._effective_env(rec)
    if rec["kind"] == "multichip":
        ts = _parse_ts(rec["summary"].get("generated_at")) or mtime
        out = []
        for key, pt in rec["curve"].items():
            out.append(make_entry(
                key, pt.get("states_per_sec_per_chip"), ts,
                run=rec["label"], kind="multichip",
                platform=rec["platform"], env=env, source=path))
        return out
    if rec["kind"] == "bench":
        return [make_entry(
            "bench", rec["states_per_sec"], mtime,
            run=rec["label"], kind="bench",
            platform=rec["platform"], env=env, source=path)]
    ts = _parse_ts(rec["summary"].get("started_at")) or mtime
    return [make_entry(
        rec["label"], rec["states_per_sec"], ts,
        run=rec["label"], kind="metrics",
        platform=rec["platform"], env=env, source=path)]


def import_artifacts(paths: List[str], path: Optional[str] = None,
                     skipped: Optional[List[str]] = None) -> int:
    """Backfill committed artifacts (`obs history --import`); globs are
    expanded, entries already in the ledger (by content id) are
    skipped. Returns the number of NEW entries appended.  Unparseable
    artifacts (e.g. a failed bench run with `parsed: null`) are
    recorded in `skipped` and do not abort the import — a dead run is
    a fact about the history, not an import failure."""
    files: List[str] = []
    for p in paths:
        if any(ch in p for ch in "*?["):
            files.extend(sorted(_glob.glob(p)))
        elif os.path.isdir(p):
            files.extend(sorted(_glob.glob(os.path.join(p, "*.json"))))
        else:
            files.append(p)
    have = {e.get("id") for e in read_entries(path)}
    fresh: List[Dict[str, Any]] = []
    for f in files:
        try:
            ents = entries_from_artifact(f)
        except (OSError, ValueError, KeyError) as e:
            if skipped is not None:
                skipped.append(f"{f}: {e}")
            continue
        for e in ents:
            if e["id"] not in have:
                have.add(e["id"])
                fresh.append(e)
    return append_entries(fresh, path)


# --------------------------------------------------------------- history

def trajectory(entries: List[Dict[str, Any]]
               ) -> Dict[str, List[Dict[str, Any]]]:
    """Group by rung, each list sorted by (ts, run label)."""
    by: Dict[str, List[Dict[str, Any]]] = {}
    for e in entries:
        by.setdefault(str(e.get("rung")), []).append(e)
    for rows in by.values():
        rows.sort(key=lambda e: (e.get("ts") or 0.0,
                                 str(e.get("run") or "")))
    return by


def flag_latest(rows: List[Dict[str, Any]], threshold_pct: float,
                window: int) -> Optional[str]:
    """REGRESS flag when the LATEST entry of a rung drops more than
    threshold below the best of the preceding `window` entries.  Only
    the latest is judged — a freshly imported history must not spam
    flags for drops that later runs already recovered from; the gate
    cares whether the run just appended regressed."""
    if len(rows) < 2:
        return None
    cur = rows[-1]
    rate = cur.get("states_per_sec")
    if not isinstance(rate, (int, float)):
        return None
    ref = [r for r in rows[-1 - window:-1]
           if isinstance(r.get("states_per_sec"), (int, float))]
    if not ref:
        return None
    best = max(ref, key=lambda r: r["states_per_sec"])
    bv = best["states_per_sec"]
    if bv <= 0:
        return None
    d = (rate - bv) / bv * 100.0
    if d >= -threshold_pct:
        return None
    flag = (f"REGRESS states/sec {cur.get('rung')}: best-of-window "
            f"{bv:,.1f} ({best.get('run')}) -> {rate:,.1f} "
            f"({cur.get('run')}) ({d:+.1f}%)")
    env = report._env_changes(best.get("env") or {},
                              cur.get("env") or {})
    if env:
        flag += f"  [env changed: {'; '.join(env)}]"
    return flag


def _fmt_rate(x) -> str:
    return "-" if not isinstance(x, (int, float)) else f"{x:,.0f}"


def cmd_history(args, out=None) -> int:
    """`python -m jaxmc_torch.obs history` — the per-rung states/sec
    trajectory across all recorded runs, optionally backfilling
    committed artifacts first (--import) and gating
    (--fail-on-regress)."""
    out = out if out is not None else sys.stdout
    lpath = ledger_path(getattr(args, "ledger", None))
    if getattr(args, "import_files", None):
        skipped: List[str] = []
        n = import_artifacts(args.import_files, lpath, skipped=skipped)
        print(f"imported {n} new entr{'y' if n == 1 else 'ies'} "
              f"into {lpath}", file=out)
        for s in skipped:
            print(f"  skipped {s}", file=out)
    entries = read_entries(lpath)
    if getattr(args, "rung", None):
        entries = [e for e in entries
                   if str(e.get("rung")) == args.rung]
    if not entries:
        print(f"ledger {lpath}: no entries"
              + (f" for rung {args.rung}" if getattr(args, "rung", None)
                 else ""), file=out)
        return 0
    by = trajectory(entries)
    kw = max(len(k) for k in by)
    print(f"== ledger history: {lpath} ({len(entries)} entries, "
          f"{len(by)} rungs)", file=out)
    print(f"  {'rung':<{kw}}  {'runs':>4}  trajectory (oldest -> "
          f"latest states/sec)", file=out)
    flags: List[str] = []
    for rung in sorted(by):
        rows = by[rung]
        tail = rows[-6:]
        cells = " -> ".join(_fmt_rate(r.get("states_per_sec"))
                            for r in tail)
        if len(rows) > len(tail):
            cells = "... " + cells
        rates = [r["states_per_sec"] for r in rows
                 if isinstance(r.get("states_per_sec"), (int, float))]
        note = ""
        if rates:
            best = max(rates)
            last = rows[-1].get("states_per_sec")
            if isinstance(last, (int, float)) and best > 0:
                note = f"  (last vs best {100.0 * last / best:.0f}%)"
        print(f"  {rung:<{kw}}  {len(rows):>4}  {cells}{note}",
              file=out)
        f = flag_latest(rows, args.threshold, args.window)
        if f:
            flags.append(f)
    print("", file=out)
    if flags:
        print("regressions:", file=out)
        for f in flags:
            print(f"  {f}", file=out)
    else:
        print(f"no regressions flagged (latest-vs-best-of-{args.window}"
              f", threshold {args.threshold:.0f}%).", file=out)
    return 1 if (flags and args.fail_on_regress) else 0
