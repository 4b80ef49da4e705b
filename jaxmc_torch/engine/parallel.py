r"""Parallel exact BFS engine: worker-pool frontier expansion.

TLC gets its throughput from worker-parallel frontier expansion (Yu,
Manolios & Lamport, CHARME 1999); jaxmc's exact oracle path was pinned to
one core. This engine is the same idea adapted to the Python interpreter:

- level-synchronous BFS: the frontier at depth d is split into chunks and
  farmed to a `multiprocessing` fork pool; workers run the expensive pure
  work per successor — `enumerate_next`, action/state CONSTRAINTs,
  SYMMETRY canonicalization / VIEW fingerprints, invariants — against the
  model they inherited at fork time (no per-task model pickling);
- the PARENT REPLAYS the merge through the single `seen` dict in exact
  frontier order at the level barrier, running the byte-level algorithm
  of the serial engine (engine/explore.py) with the expensive evaluations
  precomputed.  `generated`/`distinct`/`diameter`, violation traces, and
  truncation points are therefore BIT-IDENTICAL to the serial engine on
  every path, including mid-level violations: the replay consumes worker
  records in the same order the serial loop would have produced them and
  stops at the same record.

Dedup/merge correctness notes:
- workers never see the global `seen` set; every successor's fingerprint
  key rides back with the record and the parent's dedup decides.  A
  record's constraint/invariant verdicts describe the record's CONCRETE
  successor and are consulted only when its key is globally new — for a
  duplicate key the parent uses the stored verdict, exactly like the
  serial engine (matters under SYMMETRY, where two concrete states share
  one canonical key);
- within one chunk, repeats of an already-emitted key are sent as slim
  (key-only) records to bound pickle volume; chunks merge in submission
  order, so the full record always precedes its slim repeats.

Known (documented) divergence from serial: `CheckResult.prints` — worker
expansion collects a state's Print output as one batch, so on violation
paths prints from the violating state's expansion may include output the
serial engine would have cut off mid-state; print ORDER within a state
interleaves invariant-eval prints after expansion prints.  Counts, logs,
traces and verdicts are unaffected (the CLI does not render prints).

Crash safety: the engine owns its worker pool (`_WorkerPool`,
a context-managed set of fork processes around two queues) instead of
`multiprocessing.Pool`, BECAUSE Pool loses the task a dead worker held
and wedges the imap iterator.  Workers announce each chunk before
expanding it, so when a worker dies (OOM kill, fault injection) the
parent knows exactly which chunks were in flight: it drains completed
results, tears the pool down, respawns it (shrunk after repeat deaths),
and requeues the unmerged chunks with a bounded per-chunk retry budget
(JAXMC_PARALLEL_RETRIES, default 2) and backoff.  A chunk that raises a
transient error is retried INLINE in the parent at its merge point —
chunks are pure, and the parent replay keeps the slim-record invariant.
Only when a chunk's retries are exhausted (or the pool cannot respawn)
does the run degrade to serial expansion for the remainder, recorded as
the `parallel.degraded` gauge/event.  Counts stay bit-identical to the
serial engine through every recovery: chunks always MERGE in submission
order, and re-executed chunks produce the same records (full records
where the dead worker would have sent slim repeats — the parent dedup
treats both identically).

Checkpoints: written at level barriers through engine/ckpt.py
in the SAME payload format as the serial engine, so either engine
resumes the other's checkpoint; a state-limit truncation checkpoints
mid-level with the in-flight state requeued at the head, exactly like
the serial engine.

Falls back to the serial engine (identical behavior, a
`parallel.fallback` telemetry event, no stdout difference) when: workers
<= 1, the platform has no fork start method, or the model carries
stepwise refinement properties (their checkers are evaluated
edge-at-a-time in the parent today).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..sem.eval import TLCAssertFailure, eval_expr
from ..sem.enumerate import Walker, enumerate_init, enumerate_next, label_str
from ..sem.modules import Model, satisfies_constraints
from ..sem.values import EvalError
from .explore import (CheckResult, Explorer, Violation, _state_key,
                      make_canonicalizer, state_fingerprint)

# worker-side pure-verdict / sent-key cache cap. Each entry holds full
# state tuples, and EVERY worker keeps its own copy — an over-generous
# cap would multiply resident memory by the worker count on models that
# barely fit in RAM serially. 256k entries retains most of the dup-reuse
# win (dups cluster within/between adjacent levels)
_CACHE_CAP = 1 << 18


def default_workers() -> int:
    """`JAXMC_WORKERS` if set, else min(os.cpu_count(), 8)."""
    env = os.environ.get("JAXMC_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return max(1, min(os.cpu_count() or 1, 8))


def fork_available() -> bool:
    import multiprocessing
    return "fork" in multiprocessing.get_all_start_methods()


# ---------------------------------------------------------------- worker

class _WorkerState:
    """Everything a worker needs, built in the parent and inherited over
    fork (copy-on-write; nothing here is pickled)."""

    __slots__ = ("model", "vars", "walker", "base_ctx", "canon",
                 "view_expr", "prints", "verdicts", "sent", "memo_sent",
                 "key_is_concrete")

    def __init__(self, model: Model):
        self.model = model
        self.vars = model.vars
        self.walker = Walker("next", model.vars)
        self.prints: List[Any] = []
        self.base_ctx = model.ctx(on_print=self.prints.append)
        self.canon = make_canonicalizer(model)
        self.view_expr = getattr(model, "view", None)
        # without SYMMETRY/VIEW the fingerprint IS the concrete value
        # tuple, so a full record need not carry the state twice
        self.key_is_concrete = self.canon is None and self.view_expr is None
        # concrete-state-key -> (fingerprint key, cons_ok, inv, inv_prints)
        # — all pure functions of the concrete successor, so caching them
        # per worker cuts repeat verdicts to ~distinct-per-worker instead
        # of per-generated
        self.verdicts: Dict[tuple, tuple] = {}
        # fingerprints this worker has already emitted a full record for
        # (worker lifetime: a worker's chunks merge in its processing
        # order, so the full record always precedes its slim repeats) —
        # the main IPC-volume cut: repeat successors ship as key-only
        self.sent: set = set()
        # delta baseline = the PRE-FORK memo counters: workers inherit the
        # parent's store, and a (0, 0) baseline would re-add the parent's
        # own pre-fork hits/misses once per worker at the first chunk
        self.memo_sent = model._memo.stats() if model._memo is not None \
            else (0, 0)

    def fingerprint(self, st: Dict[str, Any]):
        return state_fingerprint(self.model, self.canon, self.view_expr,
                                 self.vars, st)

    def check_invariants(self, st) -> Tuple[Any, List[Any]]:
        """(None | ("inv", name) | ("assert", msg), prints)."""
        model = self.model
        if not model.invariants:
            return None, ()
        inv_prints: List[Any] = []
        ctx = model.ctx(state=st, on_print=inv_prints.append)
        from ..sem.eval import _bool
        try:
            for name, expr in model.invariants:
                if not _bool(eval_expr(expr, ctx), f"invariant {name}"):
                    return ("inv", name), inv_prints
        except TLCAssertFailure as ex:
            return ("assert", str(ex.out)), inv_prints
        return None, inv_prints

    def verdict(self, succ: Dict[str, Any]):
        ck = _state_key(succ, self.vars)
        try:
            hit = self.verdicts.get(ck)
        except TypeError:  # unhashable value (cannot happen for states,
            hit = None     # but never let the cache break a run)
            ck = None
        if hit is not None:
            return hit
        # without SYMMETRY/VIEW the fingerprint IS the concrete key —
        # don't build the same tuple twice on the miss path
        key = ck if ck is not None and self.key_is_concrete \
            else self.fingerprint(succ)
        cons_ok = satisfies_constraints(self.model, succ)
        if cons_ok:
            inv, inv_prints = self.check_invariants(succ)
        else:
            inv, inv_prints = None, ()  # discarded states are never checked
        out = (key, cons_ok, inv, list(inv_prints) if inv_prints else ())
        if ck is not None:
            if len(self.verdicts) >= _CACHE_CAP:
                self.verdicts.clear()
            self.verdicts[ck] = out
        return out


_W: Optional[_WorkerState] = None


def _init_worker(state: _WorkerState) -> None:
    global _W
    _W = state


def _expand_chunk(chunk):
    """Expand a chunk of (sid, value-tuple) pairs.  Returns
    (wall_s, memo_delta, per-state records); each per-state record is
    (sid, n_succ, assert_msg, error_msg, state_prints,
    successor-records) with successor records one of:
      ("x",)                                action-constraint filtered
      ("s", key)                            repeat of a key this worker
                                            already sent a full record for
                                            (merges strictly earlier)
      ("d", key)                            CONSTRAINT-discard (if new)
      ("f", key, label, inv, prints)        kept successor; the state IS
                                            the key values (no SYM/VIEW)
      ("F", vals, key, label, inv, prints)  kept successor under SYM/VIEW
                                            (concrete values + canonical
                                            fingerprint)
    """
    w = _W
    t0 = time.perf_counter()
    model = w.model
    vars = w.vars
    sent = w.sent
    out = []
    for sid, vals in chunk:
        st = dict(zip(vars, vals))
        recs: List[tuple] = []
        n_succ = 0
        assert_msg = None
        error_msg = None
        p0 = len(w.prints)
        it = enumerate_next(model.next, w.base_ctx, vars, st,
                            walker=w.walker)
        while True:
            try:
                succ, label = next(it)
            except StopIteration:
                break
            except TLCAssertFailure as ex:
                # raised while ENUMERATING the next successor: nothing
                # was counted for it yet (matches the serial loop)
                assert_msg = str(ex.out)
                break
            except EvalError as ex:
                # an eval error must not vaporize this chunk's earlier
                # records (a violation recorded before it would be lost
                # and the run would crash where serial reports the
                # violation): capture per state, parent re-raises at the
                # serial engine's crash point
                error_msg = str(ex)
                break
            n_succ += 1
            try:
                if model.action_constraints and \
                        not _action_constraints_ok(w, st, succ):
                    recs.append(("x",))
                    continue
                key, cons_ok, inv, inv_prints = w.verdict(succ)
            except TLCAssertFailure as ex:
                # Assert inside an action constraint, CONSTRAINT, or
                # VIEW fingerprint eval: the serial engine has already
                # counted this successor (generated++ precedes the
                # raising eval), so emit a counted-only record before
                # reporting the assert
                recs.append(("x",))
                assert_msg = str(ex.out)
                break
            except EvalError as ex:
                recs.append(("x",))  # counted before the eval raised
                error_msg = str(ex)
                break
            if key in sent:
                recs.append(("s", key))
                continue
            if len(sent) >= _CACHE_CAP:
                sent.clear()  # re-emitting full records is safe
            sent.add(key)
            if not cons_ok:
                recs.append(("d", key))
            elif w.key_is_concrete:
                recs.append(("f", key, label_str(label), inv,
                             inv_prints))
            else:
                recs.append(("F",
                             tuple(succ[v] for v in vars), key,
                             label_str(label), inv, inv_prints))
        state_prints = w.prints[p0:]
        del w.prints[p0:]
        out.append((sid, n_succ, assert_msg, error_msg, state_prints,
                    recs))
    mst = model._memo
    dh = dm = 0
    if mst is not None:
        h, m = mst.stats()
        h0, m0 = w.memo_sent
        dh, dm = h - h0, m - m0
        w.memo_sent = (h, m)
    return (time.perf_counter() - t0, (dh, dm), out)


def _action_constraints_ok(w: _WorkerState, st, succ) -> bool:
    from ..sem.eval import _bool
    ctx = w.model.ctx(state=st, primes=succ, on_print=w.prints.append)
    for name, expr in w.model.action_constraints:
        if not _bool(eval_expr(expr, ctx), f"action constraint {name}"):
            return False
    return True


def _worker_main(task_q, result_q) -> None:
    """Pool worker loop.  The model/walker state (_W) is inherited over
    fork.  Each chunk is ANNOUNCED before expansion ("start" message)
    so the parent can attribute a dead pid to the chunk it held; every
    escape from a chunk is reported as a "fail" message, never fatal —
    the parent decides retry vs degrade.  The worker_kill/chunk_error
    fault sites live here and ONLY here: the parent-inline path must
    never kill or fail the run's only process.

    Every message carries a slot for the worker's span lineage; the
    port has no trace context (ROADMAP A.13), so it is None and the
    parent records no worker span."""
    from .. import faults
    lin = None
    while True:
        task = task_q.get()
        if task is None:
            return
        idx, depth, chunk = task
        result_q.put(("start", idx, os.getpid(), lin))
        try:
            faults.kill_self("worker_kill", level=depth)
            faults.inject("chunk_error", level=depth)
            out = _expand_chunk(chunk)
        except BaseException as ex:  # noqa: BLE001 — report, keep serving
            result_q.put(("fail", idx, os.getpid(),
                          f"{type(ex).__name__}: {ex}", lin))
            continue
        result_q.put(("done", idx, os.getpid(), out, lin))


class _WorkerPool:
    """A context-managed fork pool with observable worker liveness.

    `multiprocessing.Pool` silently replaces a dead worker and never
    redelivers the task it held; this pool instead exposes exit codes
    (`dead()`), hands the parent every buffered result (`drain()`), and
    guarantees teardown — `shutdown()` is idempotent, runs from the
    engine's `finally`, and leaves no orphan processes behind even when
    the engine raises before or during a level (a bare
    `pool.terminate()` error path could leak the pool)."""

    def __init__(self, mp_ctx, size: int, wstate: _WorkerState):
        import collections
        import threading
        # delta baseline: re-read the memo counters at THIS fork point so
        # worker deltas never re-add the parent's own pre-fork hits
        if wstate.model._memo is not None:
            wstate.memo_sent = wstate.model._memo.stats()
        _init_worker(wstate)  # forked children inherit via the global
        self.size = size
        self.task_q = mp_ctx.Queue()
        self.result_q = mp_ctx.Queue()
        self.procs: List[Any] = []
        # The parent NEVER touches result_q directly: a worker SIGKILLed
        # mid-put can leave a truncated length-prefixed frame in the
        # pipe, and Queue.get's recv would then block PAST any timeout
        # (mp timeouts only cover the readability poll).  A daemon
        # reader thread absorbs that risk: it alone may wedge on the
        # torn frame; the parent reads from the thread-fed buffer with a
        # real timeout, still sees the dead worker via exit codes, and
        # abandons the thread at shutdown.
        self._buf = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._reader = threading.Thread(target=self._read_loop,
                                        daemon=True)
        try:
            for _ in range(size):
                p = mp_ctx.Process(target=_worker_main,
                                   args=(self.task_q, self.result_q),
                                   daemon=True)
                p.start()
                self.procs.append(p)
            self._reader.start()
        except BaseException:
            self.shutdown()
            raise

    def _read_loop(self) -> None:
        import queue as _q
        while not self._stop:
            try:
                msg = self.result_q.get(timeout=0.2)
            except _q.Empty:
                continue
            except (EOFError, OSError):
                return  # queue closed under us (shutdown)
            except Exception:  # noqa: BLE001 — a torn frame's unpickle
                continue       # error must not kill the reader
            with self._cv:
                self._buf.append(msg)
                self._cv.notify()

    def __enter__(self) -> "_WorkerPool":
        return self

    def __exit__(self, *a) -> bool:
        self.shutdown()
        return False

    def submit(self, task) -> None:
        self.task_q.put(task)

    def get(self, timeout: float):
        import queue as _q
        with self._cv:
            if not self._buf:
                self._cv.wait(timeout)
            if not self._buf:
                raise _q.Empty()
            return self._buf.popleft()

    def drain(self) -> List[tuple]:
        """Everything currently buffered (salvaged before a teardown so
        completed chunks are never re-executed).  Gives the reader
        thread a short grace window to flush messages already in the
        pipe from still-healthy workers."""
        time.sleep(0.1)
        with self._cv:
            out = list(self._buf)
            self._buf.clear()
        return out

    def dead(self) -> List[Any]:
        return [p for p in self.procs if p.exitcode is not None]

    def shutdown(self) -> None:
        self._stop = True  # reader thread is a daemon: abandoned if it
        # is wedged on a torn frame, joined-by-exit otherwise
        for p in self.procs:
            if p.exitcode is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.time() + 5.0
        for p in self.procs:
            p.join(max(0.1, deadline - time.time()))
            if p.exitcode is None:
                try:  # a worker ignoring SIGTERM gets SIGKILL
                    p.kill()
                    p.join(1.0)
                except OSError:
                    pass
        for q in (self.task_q, self.result_q):
            try:
                q.close()
                q.cancel_join_thread()  # never hang exit on a feeder
            except OSError:
                pass
        self.procs = []


# ---------------------------------------------------------------- engine

class ParallelExplorer(Explorer):
    """Worker-parallel exact BFS with serial-identical results.

    `workers` defaults to JAXMC_WORKERS, else min(os.cpu_count(), 8);
    `chunk` (frontier states per worker task) defaults to an adaptive
    split targeting ~4 tasks per worker per level, capped so task pickles
    stay small (env JAXMC_PARALLEL_CHUNK pins it)."""

    def __init__(self, model: Model, workers: Optional[int] = None,
                 chunk: Optional[int] = None, **kw):
        super().__init__(model, **kw)
        self.workers = default_workers() if workers is None \
            else max(1, int(workers))
        if chunk is None:
            env = os.environ.get("JAXMC_PARALLEL_CHUNK")
            chunk = int(env) if env else None
        self.chunk = chunk
        # crash-safe pool state (owned by _run_parallel; kept here so
        # teardown/telemetry accessors are safe on the fallback path)
        self._pool: Optional[_WorkerPool] = None
        self._pool_size = self.workers
        self._respawns = 0
        self._degraded: Optional[str] = None
        self._worker_lineage: Dict[int, Dict] = {}  # pid -> trace span

    # -- engine selection ------------------------------------------------
    def _fallback_reason(self, refiners) -> Optional[str]:
        # NOTE: checkpoint/resume no longer falls back: the
        # engine checkpoints at level barriers through engine/ckpt.py in
        # the serial engine's own payload format
        if self.workers <= 1:
            return "workers<=1"
        if not fork_available():
            return "no fork start method on this platform"
        if refiners:
            return "stepwise refinement properties"
        return None

    def run(self) -> CheckResult:
        from .. import obs
        from .refinement import build_refinement_checkers
        refiners, _ = build_refinement_checkers(self.model)
        reason = self._fallback_reason(refiners)
        if reason is not None:
            tel = obs.current()
            tel.event("parallel.fallback", reason=reason)
            tel.gauge("parallel.fallback_reason", reason)
            return Explorer.run(self)
        return self._run_parallel()

    def _chunks(self, frontier: List[int]):
        n = len(frontier)
        size = self.chunk
        if size is None:
            size = max(1, min(256, -(-n // (self.workers * 4))))
        return [frontier[i:i + size] for i in range(0, n, size)]

    # -- crash-safe pool plumbing ----------------------------------------
    def _ensure_pool(self) -> None:
        """Fork the worker pool (lazily, and again after a death).
        Workers inherit the parent's inline worker state — its `sent`
        keys were all merged into `seen`, so slim repeats from any
        worker stay resolvable."""
        if self._pool is None:
            self._pool = _WorkerPool(self._mp, self._pool_size,
                                     self._wstate)

    def _note_degraded(self, tel, reason: str) -> None:
        """Record the one-way degrade to serial expansion (telemetry +
        log); expansion correctness is unchanged — the inline path runs
        the same records through the same merge."""
        if self._degraded is None:
            self._degraded = reason
            tel.gauge("parallel.degraded", reason)
            tel.event("parallel.degraded", reason=reason)
            tel.counter("parallel.degradations")
            self.log(f"-- parallel: degrading to serial expansion "
                     f"({reason})")

    def _level_results(self, payloads, depth, tel, max_retries):
        """Yield (chunk_wall, memo_delta, records) for every chunk of
        one level IN SUBMISSION ORDER, surviving worker deaths and
        transient chunk errors.

        Recovery rules (all exact — chunks are pure functions):
        - a chunk whose worker DIED is requeued to a respawned pool,
          with a per-chunk retry budget and backoff between respawns;
          repeat deaths shrink the pool (half, floor 1) on the theory
          that the box cannot hold the full worker count;
        - a chunk that raised a TRANSIENT error is re-executed inline
          in the parent at its merge point (the parent's worker state
          keeps the slim-record invariant: every key it has emitted is
          already merged);
        - when a chunk's budget is exhausted, or the pool cannot be
          respawned, the level (and the rest of the run) degrades to
          inline expansion — `parallel.degraded` telemetry, counts
          unchanged."""
        import queue as _queue
        n = len(payloads)
        done: Dict[int, tuple] = {}
        must_inline: set = set()
        retries: Dict[int, int] = {}
        in_flight: Dict[int, int] = {}  # pid -> chunk idx
        yielded = 0
        self._ensure_pool()
        for i, p in enumerate(payloads):
            self._pool.submit((i, depth, p))

        def note_lineage(pid, lin):
            # first sight of a worker pid: one trace event placing its
            # span in the fleet timeline (same trace_id over fork, span
            # parented on this process's span) — respawned workers get
            # a fresh pid+span under the ORIGINAL trace_id
            if lin and pid not in self._worker_lineage:
                self._worker_lineage[pid] = lin
                tel.event("parallel.worker_span", pid=pid,
                          span=lin.get("span"), parent=lin.get("parent"),
                          level=depth)

        def absorb(msg):
            kind = msg[0]
            if kind == "start":
                in_flight[msg[2]] = msg[1]
                note_lineage(msg[2], msg[3] if len(msg) > 3 else None)
            elif kind == "done":
                done[msg[1]] = msg[3]
                in_flight.pop(msg[2], None)
            elif kind == "fail":
                idx = msg[1]
                in_flight.pop(msg[2], None)
                retries[idx] = retries.get(idx, 0) + 1
                tel.counter("parallel.chunk_retries")
                tel.event("parallel.chunk_error", level=depth, chunk=idx,
                          error=msg[3], retry=retries[idx])
                must_inline.add(idx)

        while yielded < n:
            if yielded in done:
                yield done.pop(yielded)
                yielded += 1
                continue
            if yielded in must_inline or self._pool is None:
                # bounded retry, replayed in the parent at the merge
                # point; memo deltas land in the parent store directly,
                # so the consumer must not re-merge them
                must_inline.discard(yielded)
                wall, _delta, out = _expand_chunk(payloads[yielded])
                yield (wall, (0, 0), out)
                yielded += 1
                continue
            try:
                absorb(self._pool.get(0.25))
                continue
            except _queue.Empty:
                pass
            dead = self._pool.dead()
            if not dead:
                continue
            # ---- a worker died (OOM kill, crash, injected fault) ----
            dead_pids = [p.pid for p in dead]
            for msg in self._pool.drain():  # salvage completed chunks
                absorb(msg)
            lost = sorted(idx for pid, idx in in_flight.items()
                          if pid in dead_pids and idx not in done)
            tel.counter("parallel.worker_deaths", len(dead))
            tel.event("parallel.worker_death", level=depth,
                      pids=dead_pids, lost_chunks=lost)
            for idx in lost:
                retries[idx] = retries.get(idx, 0) + 1
            in_flight.clear()
            self._pool.shutdown()
            self._pool = None
            exhausted = sorted(i for i, r in retries.items()
                               if r > max_retries and i >= yielded
                               and i not in done)
            if exhausted:
                self._note_degraded(
                    tel, f"chunk retry budget exhausted after repeated "
                         f"worker deaths (level {depth}, chunks "
                         f"{exhausted})")
                continue  # pool stays down -> the loop expands inline
            # bounded backoff, then respawn — shrunk after repeat
            # deaths: a box that keeps killing N workers may hold N/2
            self._respawns += 1
            if self._respawns > 1:
                self._pool_size = max(1, self._pool_size // 2)
            time.sleep(min(0.05 * (2 ** (self._respawns - 1)), 2.0))
            tel.counter("parallel.respawns")
            tel.gauge("parallel.pool_size", self._pool_size)
            try:
                self._ensure_pool()
            except OSError as ex:
                self._note_degraded(tel, f"pool respawn failed: {ex}")
                continue
            todo = [i for i in range(yielded, n)
                    if i not in done and i not in must_inline]
            tel.counter("parallel.requeues", len(todo))
            for i in todo:
                self._pool.submit((i, depth, payloads[i]))

    # -- the parallel search --------------------------------------------
    def _run_parallel(self) -> CheckResult:
        import multiprocessing
        from .. import faults, obs
        from . import ckpt as _ckpt
        model = self.model
        vars = model.vars
        t0 = time.time()
        tel = obs.current()
        base_ctx = self._ctx()

        seen: Dict[tuple, int] = {}
        states: List[Dict[str, Any]] = []
        parents: List[Optional[int]] = []
        labels: List[str] = []
        depth_of: List[int] = []
        generated = 0
        diameter = 0
        last_progress = time.time()

        canon = make_canonicalizer(model)
        VIOL = -1  # same discard sentinel as the serial engine
        view_expr = getattr(model, "view", None)

        def add_state(st, parent, label, depth):
            # same flow as the serial engine's add_state (only init
            # states pass through here; successors merge via worker
            # records above)
            key = state_fingerprint(model, canon, view_expr, vars, st)
            nid = len(states)
            sid = seen.setdefault(key, nid)
            if sid != nid:
                return (None if sid == VIOL else sid), False
            if not self._satisfies_constraints(st):
                seen[key] = VIOL
                return None, True
            states.append(st)
            parents.append(parent)
            labels.append(label)
            depth_of.append(depth)
            return nid, True

        # refiners are [] here (non-empty fell back to serial), so the
        # shared setup emits exactly the serial engine's warning lines
        from .explore import liveness_setup
        live_obligations, collect_edges, warnings = \
            liveness_setup(model, [], view_expr)
        edges: List[Tuple[int, int]] = []

        lv = {"depth": 0, "frontier": 0, "generated": 0, "new": 0,
              "t0": time.time(), "chunk_wall": 0.0, "merge_wall": 0.0}

        def flush_level(queue_len):
            if lv["frontier"] == 0 and lv["generated"] == 0:
                return
            tel.level(lv["depth"], frontier=lv["frontier"],
                      generated=lv["generated"], new=lv["new"],
                      distinct=len(states), seen=len(seen),
                      queue=queue_len,
                      wall_s=round(time.time() - lv["t0"], 6),
                      workers=self.workers,
                      chunk_wall_s=round(lv["chunk_wall"], 6),
                      merge_wall_s=round(lv["merge_wall"], 6))
            lv.update(frontier=0, generated=0, new=0, t0=time.time(),
                      chunk_wall=0.0, merge_wall=0.0)

        def result(ok, violation=None, truncated=False, queue_len=0,
                   drained=False):
            if truncated and live_obligations:
                warnings.append("temporal properties NOT checked: the "
                                "search was truncated (behavior graph "
                                "incomplete)")
            flush_level(queue_len)
            mst = model._memo
            if mst is not None:
                tel.gauge("memo.hits", mst.hits)
                tel.gauge("memo.misses", mst.misses)
            tel.gauge("fingerprint.occupancy", len(seen))
            tel.gauge("parallel.workers", self.workers)
            trunc_reason = None
            if truncated:
                # name the exhausted resource
                trunc_reason = ("drain" if drained else
                                f"max_states: distinct {len(states)} "
                                f">= limit {self.max_states}")
                tel.gauge("truncation.reason", trunc_reason)
            return CheckResult(ok=ok, distinct=len(states),
                               generated=generated, diameter=diameter,
                               violation=violation,
                               wall_s=time.time() - t0,
                               prints=self.prints, truncated=truncated,
                               warnings=warnings, drained=drained,
                               trunc_reason=trunc_reason)

        # checkpoint plumbing: level-barrier (and truncation) writes in
        # the serial engine's payload format, with the serial engine's
        # adaptive interval stretch (write cost capped at ~5% of wall)
        ck_state = {"every": self.checkpoint_every,
                    "last": time.time()}

        def write_checkpoint(queue, generated_at, prints_at=None):
            payload = _ckpt.interp_payload(
                model, vars, states, parents, labels, depth_of,
                queue, generated_at, diameter, seen, edges,
                collect_edges,
                self.prints if prints_at is None
                else self.prints[:prints_at])
            _ckpt.write_periodic(
                self.checkpoint_path, "interp",
                {"module": model.module.name, "engine": "parallel"},
                payload, tel, self.log, ck_state,
                span_attrs={"states": len(states), "queue": len(queue)})

        # ---- initial states, or resume (exactly as the serial engine) --
        frontier: List[int] = []
        carry: List[int] = []  # resumed queue states one level deeper
        if self.resume_from:
            # same loader + validations as the serial engine: integrity
            # defects surface as CkptError (exit 2), never a traceback
            ck = _ckpt.load_interp_checkpoint(self.resume_from, model,
                                              vars, collect_edges)
            self.prints.extend(ck.get("prints", []))
            states.extend(ck["states"])
            parents.extend(ck["parents"])
            labels.extend(ck["labels"])
            depth_of.extend(ck["depth_of"])
            generated = ck["generated"]
            diameter = ck["diameter"]
            seen.update(ck["seen_items"])
            if collect_edges:
                edges.extend(ck["edges"])
            q = list(ck["queue"])
            if q:
                # the queue spans at most two adjacent depths (BFS
                # invariant): replay the depth-d prefix as this level's
                # frontier and keep the depth-d+1 suffix AHEAD of this
                # level's discoveries — the serial engine's exact pop
                # order, so resumed counts stay bit-identical
                rd = depth_of[q[0]]
                frontier = [s for s in q if depth_of[s] == rd]
                carry = [s for s in q if depth_of[s] != rd]
            self.log(f"Resumed from {self.resume_from}: {len(states)} "
                     f"distinct states, {len(q)} on queue.")
        else:
            try:
                inits = enumerate_init(model.init, base_ctx, vars)
            except TLCAssertFailure as ex:
                return result(False, Violation("assert", "Init", [],
                                               str(ex.out)))
            init_count = 0
            for st in inits:
                sid, new = add_state(st, None, "Initial predicate", 0)
                if not new:
                    continue
                generated += 1
                if sid is None:
                    continue  # discarded by CONSTRAINT
                init_count += 1
                bad = self._check_state_preds(st)
                if bad is not None:
                    return result(False, Violation(
                        "invariant", bad,
                        self._trace_to(sid, parents, states, labels)))
                frontier.append(sid)
            self.log(f"Finished computing initial states: {init_count} "
                     f"distinct state{'s' if init_count != 1 else ''} "
                     f"generated.")

        d0 = depth_of[frontier[0]] if frontier else 0
        self.log(f"Progress({d0}): {generated} states generated, "
                 f"{len(states)} distinct states found, "
                 f"{len(frontier) + len(carry)} states left on queue."
                 f"{obs.eta_suffix(len(states))}")

        # ---- the level-synchronous pool loop ----
        self._mp = multiprocessing.get_context("fork")
        wstate = _WorkerState(model)
        # the parent can run the worker body inline (global worker state
        # in this process too): frontiers smaller than the fan-out are
        # expanded without the per-level IPC barrier — same records, same
        # replay, zero round-trip latency on shallow/narrow levels.
        # Chaos faults targeting pool workers force the pool ON so a
        # tiny model still exercises the crash path the fault asks for.
        _init_worker(wstate)
        self._wstate = wstate
        self._pool = None
        self._pool_size = self.workers
        self._respawns = 0
        self._degraded = None
        faults.ensure_shared_state()  # one fault budget for all forks
        inline_below = 0 if faults.targets("worker_kill", "chunk_error") \
            else self.workers * 4
        max_retries = int(os.environ.get("JAXMC_PARALLEL_RETRIES", "2"))
        n_chunks_total = 0
        from .. import drain as _drain
        try:
            depth = d0
            while frontier or carry:
                if _drain.requested():
                    # cooperative drain at the level barrier: the queue
                    # (this frontier, then the resumed-carry states one
                    # level deeper) checkpoints untouched — the serial
                    # engine's own resume split re-derives the depths
                    why = _drain.reason()
                    self.log(f"-- drain requested ({why}): stopping at "
                             f"the level barrier")
                    if self.checkpoint_path:
                        write_checkpoint(list(frontier) + list(carry),
                                         generated)
                    tel.event("drain", reason=why, engine="parallel")
                    warnings.append(
                        f"run drained before completion ({why})"
                        + (f"; resume with --resume "
                           f"{self.checkpoint_path}"
                           if self.checkpoint_path else "; no "
                           "checkpoint was configured — progress was "
                           "discarded"))
                    return result(True, truncated=True, drained=True,
                                  queue_len=len(frontier) + len(carry))
                lv["depth"] = depth
                # resumed depth+1 queue states stay AHEAD of this
                # level's discoveries (serial pop order)
                next_frontier: List[int] = carry
                carry = []
                chunks = self._chunks(frontier)
                n_chunks_total += len(chunks)
                payloads = [[(sid,
                              tuple(states[sid][v] for v in vars))
                             for sid in c] for c in chunks]
                remaining = len(frontier)
                fpos = -1  # index of the merging state in frontier order
                if self._degraded is not None or \
                        len(frontier) < inline_below:
                    # parent-inline expansion: memo deltas are already in
                    # the parent store, so they are NOT re-merged below
                    results = (_expand_chunk(p) for p in payloads)
                    inline = True
                else:
                    results = self._level_results(payloads, depth, tel,
                                                  max_retries)
                    inline = False
                for chunk_wall, memo_delta, chunk_out in results:
                    lv["chunk_wall"] += chunk_wall
                    mst = model._memo
                    if mst is not None and not inline:
                        mst.merge_stats(*memo_delta)
                    m0 = time.perf_counter()
                    for (sid, n_succ, assert_msg, error_msg,
                         state_prints, recs) in chunk_out:
                        remaining -= 1
                        fpos += 1
                        lv["frontier"] += 1
                        diameter = max(diameter, depth)
                        # truncation-checkpoint snapshots: roll back to
                        # this state's merge start so resume re-expands
                        # it exactly once (the serial engine's rule)
                        gen_at_state = generated
                        prints_at_state = len(self.prints)
                        self.prints.extend(state_prints)
                        for rec in recs:
                            generated += 1
                            lv["generated"] += 1
                            kind = rec[0]
                            if kind == "x":
                                continue
                            if kind == "s":
                                ex_sid = seen[rec[1]]
                                if ex_sid != VIOL and collect_edges:
                                    edges.append((sid, ex_sid))
                                continue
                            key = rec[2] if kind == "F" else rec[1]
                            ex_sid = seen.get(key)
                            if ex_sid is not None:
                                # duplicate fingerprint: the stored
                                # verdict wins (serial dedup-first order)
                                if ex_sid != VIOL and collect_edges:
                                    edges.append((sid, ex_sid))
                                continue
                            if kind == "d":
                                seen[key] = VIOL
                                continue
                            if kind == "f":
                                _, _, label, inv, inv_prints = rec
                                succ = dict(zip(vars, key))
                            else:
                                _, vals, _, label, inv, inv_prints = rec
                                succ = dict(zip(vars, vals))
                            nid = len(states)
                            seen[key] = nid
                            states.append(succ)
                            parents.append(sid)
                            labels.append(label)
                            depth_of.append(depth + 1)
                            if collect_edges:
                                edges.append((sid, nid))
                            lv["new"] += 1
                            self.prints.extend(inv_prints)
                            if inv is not None:
                                if inv[0] == "inv":
                                    return result(False, Violation(
                                        "invariant", inv[1],
                                        self._trace_to(nid, parents,
                                                       states, labels)))
                                trace = self._trace_to(sid, parents,
                                                       states, labels)
                                return result(False, Violation(
                                    "assert", "Assert", trace, inv[1]))
                            next_frontier.append(nid)
                            if self.max_states and \
                                    len(states) >= self.max_states:
                                self.log("-- state limit reached, "
                                         "search truncated")
                                if self.checkpoint_path:
                                    # mid-level write: the in-flight
                                    # state re-queued at the head with
                                    # generated/prints rolled back to
                                    # its merge start (serial rule)
                                    write_checkpoint(
                                        [sid] + frontier[fpos + 1:]
                                        + next_frontier,
                                        gen_at_state, prints_at_state)
                                return result(
                                    True, truncated=True,
                                    queue_len=remaining
                                    + len(next_frontier))
                        if assert_msg is not None:
                            trace = self._trace_to(sid, parents, states,
                                                   labels)
                            return result(False, Violation(
                                "assert", "Assert", trace, assert_msg))
                        if error_msg is not None:
                            # the serial engine's crash point: the eval
                            # error surfaced expanding THIS state, after
                            # its earlier successors were processed
                            raise EvalError(error_msg)
                        if n_succ == 0 and model.check_deadlock:
                            return result(False, Violation(
                                "deadlock", "deadlock",
                                self._trace_to(sid, parents, states,
                                               labels)))
                        now = time.time()
                        if now - last_progress >= self.progress_every:
                            last_progress = now
                            self.log(
                                f"Progress({depth}): {generated} states "
                                f"generated, {len(states)} distinct "
                                f"states found, "
                                f"{remaining + len(next_frontier)} "
                                f"states left on queue."
                                f"{obs.eta_suffix(len(states))}")
                    lv["merge_wall"] += time.perf_counter() - m0
                flush_level(len(next_frontier))
                frontier = next_frontier
                depth += 1
                # ---- level barrier: checkpoint + chaos kill site ----
                now = time.time()
                if self.checkpoint_path and \
                        now - ck_state["last"] >= ck_state["every"]:
                    ck_state["last"] = now
                    write_checkpoint(list(frontier), generated)
                faults.kill_self("run_kill", level=depth,
                                 engine="parallel")
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None
            # in the finally: a truncated or violating run's early
            # return must still record its chunk count
            tel.counter("parallel.chunks", n_chunks_total)

        # completed search: the FINAL checkpoint (serve warm-resume
        # source; engine/explore.py documents the contract)
        if self.checkpoint_path and self.final_checkpoint:
            write_checkpoint([], generated)

        # ---- temporal properties over the completed behavior graph ----
        if live_obligations:
            from .liveness import LivenessChecker
            lc = LivenessChecker(model, states, edges, parents, labels)
            bad, live_warns = lc.check(live_obligations)
            warnings.extend(live_warns)
            if bad is not None:
                pname, trace, msg = bad
                return result(False, Violation("property", pname, trace,
                                               msg))

        self.log(f"Model checking completed. No error has been found.")
        self.log(f"{generated} states generated, {len(states)} distinct "
                 f"states found, 0 states left on queue.")
        self.log(f"The depth of the complete state graph search is "
                 f"{diameter + 1}.")
        return result(True)
