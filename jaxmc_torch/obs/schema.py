r"""The `--metrics-out` / `--trace` event schema, as data.

One place pins what every artifact must carry so the CLI, bench.py, the
sweep driver, and tests/test_obs.py agree. `validate_summary` raises
ValueError with the missing/ill-typed field names — it is deliberately
structural (required keys + types + level-index monotonicity), not
exhaustive: engines are free to add fields.

Trace JSONL event grammar (one JSON object per line, `ev` discriminates;
since jaxmc.metrics/3 every event also carries `tid` — the fleet-wide
trace id, obs/context.py):

  proc_meta  {t, mono, pid, argv, psid, parent_span, env}
                                           -- per-file header (first
                                              line): process identity +
                                              span lineage + monotonic
                                              clock anchor
  run_start  {t, meta}
  span_open  {name, t, parent, attrs}      -- partial-span forensics
  span       {name, t0, wall_s, attrs[, error]}
  level      {level, t, frontier?, generated?, new?, distinct?, ...}
  heartbeat  {t, wall_s, rss_bytes, open_spans, last_level,
              progress_seq}                -- periodic watchdog beat
  stall      {t, stalled_for_s, threshold_s, open_spans, last_level,
              median_level_s}              -- watchdog: no span/level
                                              progress for too long
  counter/gauge changes are rolled up in the summary only
  log        {t, msg}                      -- mirror of the stdout line
  run_end    {t}

Summary (metrics-out) required surface: see REQUIRED_KEYS below; each
phases[i] carries {name, wall_s, count} (+optional open=True for spans
still running at rollup — the deadline-blowout record); each levels[i]
carries at least {level} with non-decreasing level indices.

Where the torch port's artifact differs (jaxmc_torch, the same schema
and validators; see PORT_ABSENT_SITES below):
  - `env` (meta block and proc_meta events): the reference's keys with
    `jax_version` always null, `platform` "gpu" or "cpu" as the run's
    torch device, plus `torch_version` and, where nvidia-smi exists,
    `gpu_name` and `gpu_power_limit` (its name,power.limit csv line).
  - prof.sites[*] never carry `cost` or `analysis_wall_s`: there is no
    XLA lowering to analyse.  `recompiles` counts the first-use nvcc
    builds (jaxmc_torch/kernels/build.py BUILDS) made inside the call;
    `wall_s` waits on a CUDA event recorded after the call.
    `prof.hbm.measured_peak_bytes` is torch.cuda.max_memory_allocated().
    `prof.xla_trace_dir` (--profile=xla) holds a torch.profiler chrome
    trace.
  - `device.donation` is the reference's platform rule (true on the
    card) with no JAXMC_DONATE override: the port's engines update
    their buffers in place, which is what donation buys, and have no
    copying mode to switch to.
  - a live gpu probe in gauge `backend.oracle_probe` also carries
    `launches`, K12's launch count in the probe's process.
  - heartbeats may carry `device_mem_peak_bytes` (the allocator's peak)
    beside the model's `device_mem_bytes`.
  - the split-step sites `bfs.hstep_group`, `bfs.hstep_combine`,
    `bfs.newcheck` and the split step's own `bfs.unpack` never fire: the
    port has no split step (its fused chunk step, `bfs.hstep`, runs on
    every device and unpacks inside the site, as `bfs.level_step` and
    `bfs.resident_run` do).
  - the `analyze_arms` span never opens: the port has no static
    demotion prediction (analyze/verdicts.py); an arm the compiler
    rejects demotes at build time with the same reason.

Schema history (additive — every jaxmc.metrics/1 artifact is a valid
jaxmc.metrics/2 artifact minus the new optional surface, so readers and
`validate_summary` accept both):

  jaxmc.metrics/1  the surface above minus heartbeat/stall.
  jaxmc.metrics/2  adds, all optional:
    - meta block `env` = {jax_version, platform, device_count}: the
      environment fingerprint `python -m jaxmc_torch.obs diff` uses to
      attribute regressions to environment changes;
    - trace events `heartbeat` / `stall` (obs/watchdog.py);
    - compile-introspection gauges: `compile.arm_cost` ({arm label ->
      {jaxpr_eqns, hlo_flops?, hlo_bytes?}}), counters
      `compile.jaxpr_eqns_total`, `compile.hlo_flops_total`,
      `compile.hlo_bytes_total`, and jit-cache effectiveness counters
      `compile.cache_hits` / `compile.cache_misses`;
    - watchdog counters `watchdog.heartbeats` / `watchdog.stalls` and
      the `watchdog.max_stall_s` high-water gauge.

  (still jaxmc.metrics/2 — all additive/optional:)
    - parallel exact engine (engine/parallel.py): level records may
      carry `workers`, `chunk_wall_s` (summed worker expansion wall for
      the level) and `merge_wall_s` (parent-side merge wall); gauges
      `parallel.workers` / `parallel.fallback_reason`, counter
      `parallel.chunks`, trace event `parallel.fallback {reason}`;
    - persistent XLA compile cache (compile/cache.py): counters
      `compile.persistent_cache_hits` (and any other
      /jax/compilation_cache/* monitoring events, same naming), gauges
      `compile.persistent_cache_dir`,
      `compile.persistent_cache_entries_start` / `_end`,
      `compile.persistent_cache_active`;
    - checkpoint cost: phase `checkpoint.write` (span attrs: states,
      queue) — checkpoint wall no longer hides inside `search`.

  (still jaxmc.metrics/2 — all additive/optional; the
   fault-tolerance surface:)
    - crash-safe parallel engine (engine/parallel.py): counters
      `parallel.worker_deaths` / `parallel.respawns` /
      `parallel.requeues` / `parallel.chunk_retries` /
      `parallel.degradations`, gauges `parallel.degraded` (the reason
      string — present ONLY when the run fell back to serial expansion
      after exhausting its retry budget) and `parallel.pool_size`
      (post-shrink worker count), trace events `parallel.worker_death
      {level, pids, lost_chunks}` / `parallel.chunk_error {level,
      chunk, error, retry}` / `parallel.degraded {reason}`;
    - device retry/demotion (cli.py): counters `device.init_retries` /
      `device.demotions` / `compile.retries`, gauge `device.demoted`
      (the terminal failure reason — `python -m jaxmc_torch.obs diff` raises
      a REGRESS flag when it appears between runs), trace event
      `device.demoted {reason}`, phase `search_fallback`;
    - checkpoint integrity (engine/ckpt.py): phase
      `checkpoint.host_snapshot` + counter `checkpoint.host_snapshots`
      (the device path's CPU-resumable `<checkpoint>.host` snapshot);
    - fault harness (jaxmc/faults.py): counter `faults.injected`,
      trace event `fault.injected {site, ...ctx}` — present only when
      JAXMC_FAULTS is set (chaos runs / `make chaos`).

  (still jaxmc.metrics/2 — all additive/optional; the
   compile-amortization surface:)
    - guarded persistent compile cache (compile/cache.py): gauge
      `compile.persistent_cache_guard` — "ok" / "ok (<notes>)" when the
      cache enabled (notes name quarantined entries / a fresh probe),
      "cold-fallback:<reason>" when the guard degraded the run to cold
      compilation (wedged probe, corrupt dir, lock contention, foreign
      build), "disabled:..." on explicit opt-out; counters
      `compile.persistent_cache_fallbacks` and
      `compile.persistent_cache_quarantines`.  The existing
      `compile.persistent_cache_hits` counter is the CROSS-PROCESS
      proof: >0 means this process reloaded a program some other
      process compiled.
    - steady-state bench window (bench.py full rung): the emitted line
      gains a `steady_state` block {source, path, resumed_generated,
      resumed_distinct, resumed_depth, window_generated, window_wall_s,
      window_recompiles}; the parent's orchestration block gains
      `compile_excluded_from_window` {phases: {name -> wall_s},
      total_s} — the one-time compile bill, separated from the
      steady-state states/sec claim.  New child phase spans
      `warmup_run {warm_source}` and `warm_ckpt_build {warm_states}`;
      bench-warm runs emit `warmgen_bench` / `warmgen_3s` spans.
    - expansion-mode pins (corpus.py): sweep case records/details note
      `[mode pinned]` for manifest-pinned interp-arms cases (kernel
      construction skipped) and carry a per-arm demotion reason table
      (`[demoted arms: <label>: <reason>; ...]`) whenever arms demote
      unpinned; a pinned case that slides toward the interpreter is a
      FAIL with detail "REGRESSION: expansion mode slid ...".
    - symmetry disclosure is three-way: `sym=device-reduced`,
      `sym=identity` (identity permutation group — no divergence), or
      `sym=UNREDUCED-FALLBACK (...)` (a genuine CompileError fallback;
      the only case where counts diverge from TLC's reduced ones).

  (still jaxmc.metrics/2 — all additive/optional; the
   state-encoding surface:)
    - bit-packed lane plans (compile/pack.py): gauges
      `layout.packed_width_lanes` (packed row width, vs the existing
      `layout.width_lanes`), `layout.bits_per_state`,
      `layout.pack_ratio` (packed/unpacked width),
      `layout.pack_guarded_lanes` (observed-range int lanes with a
      runtime guard), and `dedup.mode` — "exact" | "fp128" with a
      "-packed" suffix when the key basis is the packed row or
      "-view" when cfg VIEW keys the dedup;
    - buffer donation (tpu/bfs.py): gauge `device.donation` (bool —
      seen/frontier donated into the jitted steps; off on XLA:CPU by
      default, JAXMC_DONATE forces);
    - capacity profiles (compile/cache.py): gauge `profile.status` —
      "loaded" / "saved" / "absent" / "disabled:..." /
      "degraded:<named reason>" (stale layout signature, foreign
      schema, module mismatch, unreadable, malformed caps — a degraded
      profile falls back to the overflow-growth path, never a crash);
      counters `profile.hits` / `profile.saves` / `profile.degrades`;
    - kernelbench artifacts (jaxmc/kernelbench.py): ordinary
      jaxmc.metrics/2 summaries whose `result.wall_s` is the
      min-of-repeats steady wall (warm-up excluded), gauge
      `kernelbench.note` carries the measurement methodology; the
      kernel-vs-interp leg feeds them to `obs diff --fail-on-regress`.

  (still jaxmc.metrics/2 — all additive/optional; the
   checking-as-a-service surface:)
    - cooperative drain (jaxmc/drain.py): `result.drained` = true when
      a SIGTERM/daemon drain stopped the search at a safe boundary
      (implies `result.truncated`; the run checkpointed and is
      resumable); trace event `drain {reason, engine}`.
    - serve fleet telemetry (jaxmc/serve/daemon.py, the daemon's own
      Telemetry): per-job `job` phase spans (attrs: id, sig, spec,
      backend, batched), gauges `serve.queue_depth` / `serve.running` /
      `serve.warm_sessions` / `serve.workers` / `serve.draining`,
      counters `serve.jobs_submitted` / `serve.jobs_done` /
      `serve.jobs_failed` / `serve.jobs_drained` / `serve.warm_hits`
      (a repeat submission answered by a warm session's checkpoint
      replay) / `serve.cold_runs` / `serve.ckpt_resumes` (cold engine,
      but resumed a previous daemon life's checkpoint) /
      `serve.batched_jobs` (queued identical jobs coalesced into one
      dispatch) / `serve.requeued_on_start`; trace events
      `serve.drain {reason}` / `serve.job_failed {id, error}`.
    - serve per-job artifacts (`<spool>/results/<id>.json`): ordinary
      jaxmc.metrics/2 summaries (meta `command` = "serve.job") plus a
      top-level `serve` block {sig, warm_engine,
      resumed_from_checkpoint, window_recompiles (count of
      `fresh_compile` level records — 0 on a warm hit), profile_hits,
      persistent_cache_hits, batched_with, job_wall_s}; violating jobs
      add `result.trace` (the rendered counterexample).
    - session stage spans (jaxmc/session.py): the `check` flow's
      existing `load` / `device_init` / `engine_build` / `search` /
      `search_fallback` phases are now emitted by CheckSession — same
      names, same meaning, whether the CLI or the serve daemon drives.
    - fused arm groups (tpu/bfs.py): gauge `expand.fused_groups` — the
      number of fused expansion jits when a many-instance model splits
      per arm-group (JAXMC_FUSED_MAX_INSTANCES instances per group)
      instead of per action.

  (still jaxmc.metrics/2 — all additive/optional; the mesh-
   resident multi-chip surface, tpu/mesh.py + jaxmc/meshbench.py:)
    - exchange strategy: gauges `mesh.exchange` ("a2a" | "gather"),
      `mesh.devices`; the strategy + gamma are also logged once per
      run.
    - resident-loop host traffic: counter `mesh.host_syncs` — one per
      level, counting the SINGLE replicated scalar-vector read the
      resident loop performs (on a clean run it EQUALS the level-record
      count: no row traffic crosses to the host between levels);
      counter `mesh.row_syncs` — whole-ring row pulls (violation trace
      assembly, checkpoints) — the only other device->host transfers.
    - exchange volume: counter `mesh.exchange_bytes` — whole-mesh bytes
      moved by the level exchanges (a2a: D^2*(B+SB)*(K+PW+1)*4 per
      level incl. the spill pass; gather: D^2*C*(K+PW)*4), computed
      from the static shapes.
    - a2a routing: gauges `mesh.a2a_gamma` (final bucket capacity
      factor; grows to the observed per-peer need on overflow),
      `mesh.a2a_spill` (total rows drained through the second
      all_to_all spill pass instead of rerunning the level),
      `mesh.a2a_max_bucket` (peak per-destination bucket occupancy).
    - shard health: gauge `mesh.shard_balance` — max/mean seen-shard
      occupancy (1.0 = perfectly balanced hash partition).
    - mesh level records add `devices`, `fc` (frontier capacity),
      `spill`, `max_bucket`, and the existing `fresh_compile` flag
      (so `window_recompiles` computes for mesh runs exactly like
      serve jobs).
    - multichip artifacts: MULTICHIP_r*.json (schema
      jaxmc.multichip/1, jaxmc/meshbench.py) — per-rung scaling curves
      [{devices, exchange, states_per_sec, states_per_sec_per_chip,
      window_recompiles, host_syncs, levels, exchange_bytes_per_level,
      shard_balance, a2a_*}]; per-leg jaxmc.metrics/2 artifacts carry
      the same numbers in a top-level `multichip` block and gate via
      `obs diff --fail-on-regress`.

  (still jaxmc.metrics/2 — all additive/optional; the static-
   analysis surface, jaxmc/analyze/*:)
    - session stage span `analyze` (attrs: mode) between `load` and
      `engine_build` when `check --analyze != off`; engine-side spans
      `analyze_bounds` (the interval fixpoint) and `analyze_arms` (the
      per-arm demotion scan) inside the jax engine build.
    - bounds inference: gauge `analyze.proven_lanes` — int lanes whose
      packed width is a STATICALLY PROVEN interval (no sampling
      margin; the runtime OV_PACK check remains as a soundness net) —
      disjoint from `layout.pack_guarded_lanes`, which now counts ONLY
      observed-range lanes; gauge `analyze.bounds_converged` (bool).
      `obs report` renders the proven/(proven+guarded) ratio as a
      highlight line.
    - demotion prediction: counter `analyze.predicted_demotions` and
      gauge `analyze.arm_verdicts` ({arm label -> predicted reason});
      a predicted arm's reason string is IDENTICAL to the build-time
      demotion wording (kernel2's shared message constants), so the
      per-arm demotion table reads the same on either path.
    - linter: counter `analyze.lint_diags`, gauges
      `analyze.lint_max_severity` ("error"|"warning"|"info") and
      `analyze.lint_codes` (sorted JMC* code list).  Serve adds
      counter `serve.jobs_rejected` + trace event `serve.job_rejected
      {spec, codes}` for submissions refused by the submit-time lint
      gate.

  (still jaxmc.metrics/2 — all additive/optional; the mesh
   rank-merge + superstep surface, tpu/mesh.py + jaxmc/meshbench.py:)
    - merge strategy: gauge `mesh.merge` ("rank" | "fullsort") — the
      shard-local dedup-merge that actually ran (rank is the default;
      JAXMC_MESH_RANKMERGE=0 forces the PR-8 fullsort); the mesh
      engine now also re-stamps `dedup.mode` at run start (the PR-6
      gauge was stamped before the mesh subclass forced fp128 keys,
      so multichip artifacts carried a stale value).
    - supersteps: `mesh.host_syncs` now counts SUPERSTEPS — one
      scalar-RING read per dispatch, each dispatch fusing up to
      JAXMC_MESH_SUPERSTEP levels in a device-side lax.while_loop —
      so host_syncs <= level-record count and < on any multi-level
      run; gauges `mesh.supersteps` (== host_syncs for the run) and
      `mesh.superstep_levels` (deepest fused dispatch).  Mesh level
      records gain `superstep` (which dispatch the level rode) and
      their `wall_s` is the dispatch wall amortized over its levels.
    - phase walls (jaxmc.meshbench bench legs, MeshExplorer
      .probe_phase_walls): gauges `mesh.phase_levels`,
      `mesh.phase_expand_s`, `mesh.phase_exchange_s`,
      `mesh.phase_merge_s`, `mesh.phase_merge_rank_s`,
      `mesh.phase_merge_fullsort_s` — a measured expand / exchange /
      merge wall breakdown at the run's learned capacities (both
      merge strategies timed on identical inputs, so the rank win is
      in the artifact); per-probed-level trace event
      `mesh.phase_walls {level, expand_s, exchange_s, merge_rank_s,
      merge_fullsort_s}`.
    - multichip artifacts add per-point `merge`, `supersteps`,
      `superstep_levels` and `phase_walls`; `python -m jaxmc_torch.obs
      diff` accepts two+ jaxmc.multichip/1 artifacts directly and
      gates per-(rung, D) states/sec/chip with REGRESS flags.
    - serve warm-registry eviction (ROADMAP item 3): counter
      `serve.evictions` + trace event `serve.evicted {sig}` when the
      bounded LRU (JAXMC_SERVE_WARM_MAX, default 32) drops the
      least-recently-used idle session; evicted signatures fall back
      to the final-checkpoint resume path (`serve.ckpt_resumes`).
    - mesh capacity profiles (compile/cache.py variant
      mesh-d<D>-<exchange>) gain the MSL key — the superstep
      controller's learned levels-per-dispatch — alongside
      SC/FC/TRL/GAM16.

  (still jaxmc.metrics/2 — all additive/optional; the
   out-of-core hierarchical seen set, backend/tiers.py:)
    - seen-key mode: gauge `seen.mode` ("exact" | "fingerprint") — the
      dedup-key mode that actually ran (--seen forces it; auto keeps
      the width-based default); gauge `fingerprint.collision_p` — the
      reported n^2 * 2^-129 bound over every admitted key (device +
      cold tiers).  `result` gains `seen_mode` and (fingerprint runs)
      `collision_p`.
    - tier hierarchy: gauge `tier.occupancy` ({device, host, disk}
      keys), gauge `tier.probe_wall_s` (cumulative cold-probe wall),
      gauge `tier.device_cap` (the configured device cap, rows),
      counters `tier.spills` / `tier.spilled_keys` /
      `tier.compactions`; phase span `tier.spill {keys[, shards]}`
      per device-prefix spill; `result.tiers` carries the final
      stats() summary {host_keys, disk_keys, host_runs, disk_runs,
      spills, compactions, probe_wall_s[, io_degraded]}.
    - tier fault containment: trace event + gauge `tier.io_degraded
      {error}` when a disk-tier write fails (ENOSPC, the
      tier_io_error fault site) and the store degrades to
      host-tier-only — counts stay exact; `obs diff` treats its
      appearance like `device.demoted` (a named degradation).
    - truncation attribution: gauge `truncation.reason` and
      `result.trunc_reason` — the EXHAUSTED resource by name
      ("max_states: distinct N >= limit M", "drain", a tier/cap with
      the observed need) so capacity regressions are attributable;
      a bare `truncated` flag no longer ships alone.
    - capacity profiles: resident runs that spilled persist the
      optional TIERK key (cold-tier key total, pow2) alongside
      SC/FCap/AccCap/VC; a capped run that loads one stamps gauge
      `tier.predicted_keys` (the expected out-of-core magnitude)
      before the first spill.

  (still jaxmc.metrics/2 — all additive/optional; cross-model
   vmapped batching, backend/batch.py + serve fleet wiring:)
    - batch scheduling (fleet telemetry): gauge `serve.batch_sigs`
      (distinct layout-compat classes seen this life), gauge
      `serve.batch_occupancy` (member width of the last vmapped
      cohort), gauge `serve.batch_compiles` (engine builds per cohort
      — 1 by construction), counters `serve.vbatch_jobs` /
      `serve.fastlane_jobs` (analyze-cost-routed queue jumps) /
      `serve.batch_incompatible` (parse-time-compatible cohorts the
      build refused; members requeued solo) / `serve.owner_respawns`
      + trace event `serve.owner_died {error}` (device-owner process
      death; jobs requeued, never lost).
    - batch engine (run-scope telemetry): gauge `batch.width` (member
      lanes in the last vmapped dispatch), counter `batch.dispatches`,
      gauges `batch.members` / `batch.occupancy` /
      `batch.dispatch_count` / `batch.lifted_consts` (the CONSTANT
      names riding the batch axis) / `batch.plan` (the shared
      pack-plan descriptor: width/packed_width/bits_per_state/...).
    - serve job artifacts: the `serve` block gains optional `bsig`
      (the layout-compat class), `cost_estimate` (analyze's
      state-space estimate consumed by the fast lane — null when the
      fixpoint bailed), `batch_occupancy`, `batch_dispatches`,
      `lifted_consts`, and `device_owner` (job ran in the owner
      process); job records carry `bsig`/`cost_estimate`/`fast_lane`.

  (still jaxmc.metrics/2 — all additive/optional;
   independence-driven hot path:)
    - independence analysis: gauge `analyze.independence_pairs`
      (commuting arm pairs proven by the element-atom footprints),
      gauge `analyze.independence_safe` (arms eligible as singleton
      ample sets), gauge `expand.regrouped` (1 when the fused-group
      plan departed from the legacy contiguous one — counts/traces
      stay byte-identical; `expand.fused_groups` /
      `mesh.grouped_expand` may SHRINK under the new plan).
    - partial-order reduction (opt-in --por): gauge `por.enabled`
      (false + gauge `por.disabled_reason` when the model's
      constructs refuse the reduction), counters `por.ample_states` /
      `por.full_states` (states expanded through a singleton ample
      set vs fully), gauge `por.ample_ratio` (ample / total expanded),
      gauge `por.reduced_states` (the REDUCED run's distinct count —
      compare against an unreduced baseline's result.distinct; raw
      counts shrink BY DESIGN under --por), gauge `por.engine`
      ("interp" on the exact interpreter; "device" when the ample
      mask runs inside the fused device step).
    - bounds-sized engines: `profile.status` gains the value
      "predicted" (capacity ladder rung below `learned`: no saved
      profile, but a converged bounds fixpoint proved a state-count
      ceiling), gauges `profile.predicted_states` (the proven
      ceiling) and `profile.predicted_caps` (the buckets sized from
      it — a cold run then pays zero growth-retry recompiles).

  jaxmc.metrics/3  adds, all optional — the fleet-wide
   distributed-tracing + live-exposition surface; every /2 artifact
   remains valid (readers accept both):
    - trace-context propagation (obs/context.py): every trace event
      carries `tid` (16-hex fleet-wide trace id); every trace FILE
      opens with a `proc_meta` header {t, mono, pid, argv, psid,
      parent_span, env} — `psid` is this process's span id,
      `parent_span` the span of whoever spawned it (inherited over
      the JAXMC_TRACE_CTX env var as "<trace_id>:<parent_span_id>";
      absent -> this process is a trace root and `parent_span` is
      null).  Fork-pool workers (engine/parallel.py) write no files;
      the parent emits one `parallel.worker_span {pid, span, parent,
      level}` event per worker instead.  `python -m jaxmc_torch.obs
      timeline` reconstructs the process tree from exactly these two
      shapes and flags orphan spans (a `parent_span` resolving to no
      known `psid`/worker span — a broken propagation hop).
    - search-progress estimation (obs/progress.py): trace event
      `progress_estimate {estimate, source}` when analyze's bounds
      fixpoint proved a state-space ceiling; gauge
      `search.progress_est` (fraction of the estimate explored, live
      during the run); heartbeat events gain `progress_fraction` /
      `progress_eta_s` / `progress_verdict` ("est" | "unbounded" —
      unbounded when no estimate exists or the observed distinct
      count exceeded it); `--progress-every` stdout lines (and their
      `log` mirrors) gain the same "~N% of est. M states, ETA Ks"
      suffix, including the immediate first line.
    - live exposition (serve/daemon.py): `GET /metrics` renders the
      daemon's counters/gauges plus per-job series in Prometheus
      text format 0.0.4.  Name grammar: `jaxmc_` + the internal
      dotted name with every character outside [a-zA-Z0-9_] mapped
      to `_` (obs.prom_name — e.g. `serve.queue_depth` ->
      `jaxmc_serve_queue_depth`, `search.progress_est` ->
      `jaxmc_search_progress_est`); per-job samples carry a
      `{job="<id>"}` label; derived per-job series:
      `jaxmc_job_running`, `jaxmc_job_levels`,
      `jaxmc_job_states_per_sec`, `jaxmc_job_progress_distinct`,
      `jaxmc_job_progress_eta_s`.  `GET /jobs/<id>/events` serves
      the job's bounded in-memory event ring (JAXMC_TRACE_RING,
      default 256 events) readable MID-RUN; `GET /status` gains a
      `progress` block {job id -> progress snapshot}.  Scrapes never
      block job threads (bounded ring + lock-copy snapshots).
    - per-job watchdogs (serve fleet): each in-daemon job and each
      owner-side solo job runs its own obs.Watchdog over the job's
      Telemetry, so one slow tenant cannot mask another job's stall;
      job heartbeat/stall events land in the per-job trace
      (`<spool>/results/<id>.trace.jsonl`) and ring.

  jaxmc.metrics/4  adds, all optional — the device profiler +
   HBM accounting + run-ledger surface; every /3 artifact remains
   valid (readers accept both):
    - the `prof{}` block (obs/prof.py): stamped by any run whose
      profiler recorded something (always under --profile; under the
      always-on cheap mode only when a dispatch site fired).  Grammar:
        prof: {
          mode: "cheap" | "wall" | "xla",
          sites: { <site>: {              # e.g. "bfs.resident_run",
            dispatches: int,              #   "mesh.superstep",
            recompiles: int,              #   "batch.vstep", ...
            wall_s?: float,               # block-until-ready wall
            analysis_wall_s?: float,      # one-shot lowering retrace
            arg_bytes?: int,              # cumulative argument bytes
            res_bytes?: int,              # cumulative result bytes
            cost?: {flops?: int,          # one-shot AOT
                    bytes_accessed?: int} # lowering cost_analysis
          }, ... },
          hbm: {
            buffers: { <name>: bytes },   # the device-memory MODEL:
                                          # resident.seen/.frontier/
                                          # .accumulator/.candidates,
                                          # mesh.seen_shards/.frontier/
                                          # .trace_ring/.a2a_buckets,
                                          # level.seen/.frontier, ...
            peak_bytes: int,              # model high-water
            measured_peak_bytes?: int     # cross-check: sum of
                                          # device memory_stats()
                                          # peak_bytes_in_use, when
                                          # the backend exposes it
          },
          xla_trace_dir?: str             # --profile=xla capture dir
        }
      Cheap mode records counts/recompiles only; wall/xla add the
      sync + byte surfaces.  Profiling NEVER changes results: counts
      and traces stay bit-identical profile-on vs profile-off
      (pinned by tests and `make prof-check`).
    - watchdog heartbeat events gain optional `device_mem_bytes` (the
      HBM model's current total) next to `rss_bytes`; stall events
      gain an optional dominant-site suffix in `msg` ("; 92% in
      mesh.superstep") naming where the wall concentrated at stall
      time.
    - live exposition (serve/daemon.py): per-job `/metrics` series
      gain `jaxmc_prof_site_dispatches` / `jaxmc_prof_site_wall_s`
      (labels `{job,site}`) and `jaxmc_hbm_peak_bytes` {job}.
      Completed jobs' `{job=...}` series persist for
      JAXMC_METRICS_JOB_TTL seconds (default 600) after completion —
      `jaxmc_job_running 0` plus the final gauges — then drop, so
      fleet lifetime no longer grows scrape cardinality without
      bound.
    - the run ledger (obs/ledger.py) is a SIBLING artifact, not part
      of the metrics schema: an append-only JSONL (default
      ~/.cache/jaxmc/ledger.jsonl; JAXMC_LEDGER=path overrides,
      =off disables) of one-line trajectory points
        {v:1, id, ts, rung, run, kind, states_per_sec, platform,
         env, source, sig?}
      content-addressed by `id` = sha1(rung, ts, rate, sig, env,
      source)[:16] — flock-appended, torn-line tolerant, idempotent
      to re-import.  `python -m jaxmc_torch.obs history` renders/gates it.

  (still jaxmc.metrics/4 — all additive/optional; device-side
   POR + dynamic element keys + structural batch-bound merge:)
    - device POR (--por on the jax/mesh backends): gauge `por.engine`
      gains the value "device" (ample mask applied INSIDE the fused
      step — level, resident, host_seen, and mesh supersteps; zero
      extra dispatches), gauge `por.device_masked_arms` (candidate
      rows the device mask dropped before dedup/exchange — the raw
      arm-level reduction the por.ample_states/full_states counters
      summarise per state), and the existing `por.ample_ratio` /
      `por.reduced_states` gauges are now also emitted by the device
      engines with IDENTICAL semantics (counts are bit-identical
      across engine shapes, including mesh data-parallel runs, where
      the ample probe is psum-distributed over the pre-level seen
      snapshot).  `por.disabled_reason` gains the mesh host-loop
      refusal (JAXMC_MESH_RESIDENT=0 escape hatch).
    - independence analysis: the arm-footprint report adds per-arm
      dynamic-key classes (element-commuting / whole-var writes /
      full-footprint bail) surfaced by `jaxmc info --cfg`; no new
      metrics keys.
    - batch engine: `batch.plan` (the shared pack-plan descriptor)
      now reflects the STRUCTURAL per-element bound merge — the donor
      packs container elements at the interval-union of every
      member's proven element bounds instead of falling back to
      whole-variable summaries; `bits_per_state` never exceeds the
      worst solo member's.

  (still jaxmc.metrics/4 — all additive/optional; fleet-grade
   serving: leases + takeover, admission control, quarantine:)
    - serve fleet gauges: `serve.fleet_daemons` (live daemon-registry
      records within the lease TTL), `serve.leases_held` (jobs this
      daemon currently holds a lease on).
    - serve fleet counters: `serve.takeovers` (expired leases this
      daemon stole), `serve.jobs_adopted` (spool jobs pulled into the
      local queue by the fleet scanner), `serve.jobs_deferred`
      (submissions accepted but left unclaimed for a warmer peer),
      `serve.affinity_adoptions` (adoptions won on sig/bsig warmth),
      `serve.lease_lost` / `serve.lease_lost_drops` (renewals lost to
      a thief / results discarded because the lease was lost),
      `serve.lease_stalls` (injected fleet-tick stalls),
      `serve.quarantined` (jobs moved to spool/quarantine after the
      cross-daemon retry budget), `serve.admission_rejected` (429s),
      `serve.spool_retries` / `serve.spool_degraded` (transient spool
      write retries / writes that exhausted them).  `obs diff` flags
      the APPEARANCE of admission_rejected and spool_degraded like
      the tier degradation gauge (REGRESS lines).
    - job records (serve artifacts / GET /jobs): optional `daemon`
      (the fleet member that ran the job), `tenant` (admission
      accounting principal), `stolen_by` + `requeue_note` (lease-
      expiry takeover provenance); job status gains "quarantined".
    - batch counters: `batch.resume_refused` (a cohort member's
      checkpoint could not seed the merged layout; it ran fresh).
"""

from __future__ import annotations

from typing import Any, Dict

SCHEMA = "jaxmc.metrics/4"

# every schema revision an artifact may carry and a reader must accept
# (additive history: a v1 artifact simply lacks the v2 optional surface)
SCHEMAS = ("jaxmc.metrics/1", "jaxmc.metrics/2", "jaxmc.metrics/3",
           "jaxmc.metrics/4")

# top-level summary keys every artifact must carry
REQUIRED_KEYS = ("schema", "started_at", "wall_s", "phases", "counters",
                 "gauges", "levels")

# keys a `check` run's artifact adds
CHECK_KEYS = ("backend", "spec", "result")

# required fields of summary["result"] for a check run
RESULT_KEYS = ("ok", "distinct", "generated", "diameter", "truncated")

PHASE_KEYS = ("name", "wall_s", "count")

# reference dispatch sites with no counterpart in the torch port, with
# the reason (the docstring's port notes); every reference span has one
PORT_ABSENT_SITES = {
    "bfs.hstep_group": "no split step in the port",
    "bfs.hstep_combine": "no split step in the port",
    "bfs.newcheck": "no split step in the port",
    "bfs.unpack": "no split step in the port: the fused steps unpack "
                  "inside their own sites"}

# required fields of the watchdog trace events (obs/watchdog.py)
HEARTBEAT_KEYS = ("ev", "t", "wall_s", "open_spans", "last_level",
                  "progress_seq")
STALL_KEYS = ("ev", "t", "stalled_for_s", "threshold_s", "open_spans",
              "last_level")


def validate_summary(s: Dict[str, Any], check_run: bool = False) -> None:
    """Structural validation; raises ValueError naming the defect."""
    if not isinstance(s, dict):
        raise ValueError(f"summary is {type(s).__name__}, not a dict")
    missing = [k for k in REQUIRED_KEYS if k not in s]
    if check_run:
        missing += [k for k in CHECK_KEYS if k not in s]
    if missing:
        raise ValueError(f"summary missing keys: {missing}")
    if s["schema"] not in SCHEMAS:
        raise ValueError(f"schema {s['schema']!r} not in {SCHEMAS!r}")
    if not isinstance(s["phases"], list):
        raise ValueError("phases is not a list")
    for ph in s["phases"]:
        miss = [k for k in PHASE_KEYS if k not in ph]
        if miss:
            raise ValueError(f"phase {ph!r} missing {miss}")
        if ph["wall_s"] < 0:
            raise ValueError(f"phase {ph['name']} has negative wall_s")
    if not isinstance(s["counters"], dict) or \
            not isinstance(s["gauges"], dict):
        raise ValueError("counters/gauges must be dicts")
    if not isinstance(s["levels"], list):
        raise ValueError("levels is not a list")
    prev = None
    for rec in s["levels"]:
        if "level" not in rec:
            raise ValueError(f"level record {rec!r} missing 'level'")
        if prev is not None and rec["level"] < prev:
            raise ValueError(
                f"level indices not monotone: {rec['level']} after {prev}")
        prev = rec["level"]
    if check_run:
        res = s["result"]
        miss = [k for k in RESULT_KEYS if k not in res]
        if miss:
            raise ValueError(f"result missing keys: {miss}")


def validate_trace_event(e: Dict[str, Any]) -> None:
    """Structural validation of one trace JSONL event. Only the watchdog
    events carry enough required structure to pin; other event kinds
    need just the `ev`/`t` envelope."""
    if not isinstance(e, dict):
        raise ValueError(f"event is {type(e).__name__}, not a dict")
    if "ev" not in e:
        raise ValueError("event missing 'ev'")
    # every event is timestamped: `t` everywhere except span-close,
    # which carries its open time as `t0` (see the grammar above)
    tkey = "t0" if e["ev"] == "span" else "t"
    if tkey not in e:
        raise ValueError(f"event {e['ev']!r} missing {tkey!r}")
    required = {"heartbeat": HEARTBEAT_KEYS, "stall": STALL_KEYS}.get(
        e["ev"])
    if required is None:
        return
    miss = [k for k in required if k not in e]
    if miss:
        raise ValueError(f"{e['ev']} event missing {miss}")
    if not isinstance(e["open_spans"], list):
        raise ValueError(f"{e['ev']}.open_spans is not a list")
    if e["ev"] == "heartbeat" and e["wall_s"] < 0:
        raise ValueError("heartbeat has negative wall_s")
    if e["ev"] == "stall" and e["stalled_for_s"] < 0:
        raise ValueError("stall has negative stalled_for_s")
