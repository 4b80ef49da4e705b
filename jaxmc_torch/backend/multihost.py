r"""Multi-process distributed BFS: one mesh shard per process over
torch.distributed — the port of jaxmc/backend/multihost.py.

Every process runs the same host loop over the mesh engine's legacy
level step (MeshExplorer._mesh_step with a fixed [FC] frontier shard,
the out_cap variant) for its own shard:

  all_to_all   all_to_all_single of K13's send layout, the main buckets
               and the spill buckets in two calls (the a2a exchange)
  all_gather   all_gather_into_tensor of the candidate keys and rows
               (the gather exchange, the default: this fixed-capacity
               loop cannot redo a level, so an a2a bucket+spill overflow
               would abort a run that gather completes)
  psum / pmax  an all_gather of every shard's partials, then K14 on
  / pmin       each process: the replicated scalar vector and the
               localization vectors, identical everywhere

The host reads only that vector.  A frontier or seen shard that
outgrows its fixed capacity, or an a2a overflow, aborts loudly with the
replicated flag.  A violation's trace is assembled by gathering each
level's frontier shards and walking the same provenance chain as the
single-process MeshExplorer, so every process prints the same trace.

gloo runs it on the CPU with a file:// store (no network); NCCL runs
one process per card.  The init method, world size and rank are given
explicitly:

    python -m jaxmc_torch.backend.multihost --process-id 0 \
        --num-processes 2 --init-method file:///tmp/store --device cpu

launch() starts the processes, waits for them and stops every one it
started.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_SPEC = os.path.join(_REPO, "specs", "transfer_scaled.tla")


class _Dist:
    """The exchange of one shard per process over torch.distributed."""

    def __init__(self, eng, rank: int, world: int):
        self.eng = eng
        self.lo = rank
        self.n = 1
        self.D = world

    def _gather(self, out, inp):
        """All ranks' `inp` concatenated along dim 0 into `out`
        (contiguous); flat, as every backend takes it."""
        import torch.distributed as dist
        f = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        f(out.view(-1), inp.contiguous().view(-1))

    def route_a2a(self, ckeys, cand, cvalid, B: int, SB: int):
        import torch
        import torch.distributed as dist
        from ..kernels import ops
        e = self.eng
        K, PW = e.K, e.PW
        f = ops.mesh_route_twin if e.twins else ops.mesh_route
        ok, oc, osrc, stats = f(ckeys, cand, cvalid, self.D, B, SB, e._skew,
                                src_lo=self.lo, send=True)
        pay = torch.cat([ok[0], oc[0], osrc[0][:, None]], dim=1)
        recv = torch.empty_like(pay)
        DB = self.D * B
        # two all_to_alls, as the reference's: every source's main
        # bucket first, then every source's spill bucket
        dist.all_to_all_single(recv[:DB], pay[:DB].contiguous())
        dist.all_to_all_single(recv[DB:], pay[DB:].contiguous())
        return (recv[:, :K].contiguous()[None],
                recv[:, K:K + PW].contiguous()[None],
                recv[:, K + PW].contiguous()[None], stats)

    def route_gather(self, ckeys, cand):
        import torch
        from ..kernels import ops
        e = self.eng
        _, C, K = ckeys.shape
        allk = torch.empty((self.D * C, K), dtype=torch.int32,
                           device=ckeys.device)
        self._gather(allk, ckeys[0])
        allc = torch.empty((self.D * C, cand.shape[2]), dtype=torch.int32,
                           device=cand.device)
        self._gather(allc, cand[0])
        f = ops.mesh_route_gather_twin if e.twins else ops.mesh_route_gather
        gk, evalid = f(allk, self.D, self.lo, 1, e._skew)
        return gk, allc, evalid

    def gather_partials(self, part):
        import torch
        out = torch.empty((self.D, part.shape[1]), dtype=part.dtype,
                          device=part.device)
        self._gather(out, part[0])
        return out


def run_multihost_child(process_id: int, num_processes: int,
                        init_method: str, spec: Optional[str] = None,
                        cfg: Optional[str] = None, FC: int = 65536,
                        SC: int = 1 << 19, max_levels: int = 200,
                        store_trace: bool = True, device=None,
                        backend: Optional[str] = None):
    """One process of the multi-process run: shard `process_id` of
    `num_processes`.  Returns (generated, distinct, violation), the same
    on every process; violation is None for a clean run, else (kind,
    name, trace) with trace [(state, action label), ...] — the trace the
    single-process MeshExplorer gives at D = num_processes."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..session import load_model
    from .bfs import resolve_device
    from .mesh import (_A_ASRTA, _A_ASRTF, _A_ASSERT, _A_DEAD, _A_DEADSLOT,
                       _A_INVSLOT, _A_INVW, _BIG, _P, _S_AOVF, _S_ASSERT,
                       _S_DEAD, _S_FOVF, _S_FRONT, _S_GEN, _S_INVMIN, _S_NEW,
                       _S_OVC, _S_SOVF, MeshExplorer, split_vector)

    rank, world = process_id, num_processes
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        # one process per card
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    try:
        model = load_model(spec or DEFAULT_SPEC, cfg)
        # gather unless overridden: this loop cannot redo a level
        exchange = os.environ.get("JAXMC_MESH_EXCHANGE", "").strip() \
            or "gather"
        me = MeshExplorer(model, shards=world, store_trace=False,
                          exchange=exchange, device=dev)
        xchg = _Dist(me, rank, world)
        init_rows, explored, n_init, err = me._prepare_init(time.time(), [])
        if err is not None:
            v = err.violation
            return err.generated, err.distinct, (v.kind, v.name, v.trace)
        seen_h, front_h, fcount_h, scount_h = me._init_shards(
            init_rows, explored, world, SC, FC)
        if int(fcount_h.max(initial=0)) > FC:
            raise RuntimeError(f"fixed shard capacity exceeded by the "
                               f"initial states (FC={FC})")
        seen = torch.as_tensor(seen_h[rank], device=dev)
        frontier = torch.as_tensor(front_h[rank], device=dev)
        scount, fcount = int(scount_h[rank]), int(fcount_h[rank])
        generated, distinct = n_init, len(explored)
        # level 0 is the same on every process; later levels keep only
        # this process's shard until a trace gathers them
        levels = [(front_h, None)] if store_trace else None

        def full(local):
            out = torch.empty((world,) + tuple(local.shape),
                              dtype=local.dtype, device=dev)
            xchg._gather(out, local)
            return out.cpu().numpy()

        def assemble(d, i, lvl, extra=None):
            rows_all = [levels[0][0]] + [full(r) for r, _ in
                                         levels[1:lvl + 1]]
            src_all = [None] + [full(s) for _, s in levels[1:lvl + 1]]
            C = me.A * FC
            out = []
            for lv in range(lvl, -1, -1):
                st = me.layout.decode_packed(np.asarray(rows_all[lv][d][i]))
                if lv == 0:
                    out.append((st, "Initial predicate"))
                else:
                    g = int(src_all[lv][d][i])
                    out.append((st, me.labels_flat[(g % C) // FC]))
                    d, i = g // C, (g % C) % FC
            out.reverse()
            if extra is not None:
                out.append(extra)
            return out

        depth = 0
        while depth < max_levels:
            vec, shards, _R, _B, _SB, _ = me._mesh_step(
                xchg, [seen], [scount], [frontier], [fcount], SC, FC,
                out_cap=FC)
            scal, aux, part = split_vector(vec.cpu().tolist(), world)
            mg = shards[0]
            seen = mg["seen2"]
            scount = int(part[rank, _P["seen"]])
            fcount = int(part[rank, _P["front"]])
            frontier = me._fit_rows(mg["front_rows"], FC)
            ovc = int(scal[_S_OVC])
            if ovc:
                v = me._ovc_violation(ovc)
                raise RuntimeError(f"multi-process run: {v.message}")
            if scal[_S_FOVF] or scal[_S_SOVF] or scal[_S_AOVF]:
                raise RuntimeError(
                    f"fixed shard capacity exceeded (FC={FC}, SC={SC}): "
                    f"raise them for this model")
            if store_trace:
                levels.append((frontier, me._fit_rows(mg["front_src"], FC)))
            # the single-process loop's precedence: deadlock, assert,
            # then the invariant in the new frontier
            if model.check_deadlock and scal[_S_DEAD]:
                d = int(np.argmax(aux[:, _A_DEAD]))
                tr = assemble(d, int(aux[d, _A_DEADSLOT]), depth) \
                    if store_trace else []
                return generated, distinct, ("deadlock", "deadlock", tr)
            if scal[_S_ASSERT]:
                d = int(np.argmax(aux[:, _A_ASSERT]))
                tr = assemble(d, int(aux[d, _A_ASRTF]), depth) \
                    if store_trace else []
                nm = f"assertion in {me.labels_flat[int(aux[d, _A_ASRTA])]}"
                return generated, distinct, ("assert", nm, tr)
            which = int(scal[_S_INVMIN])
            if which != _BIG:
                d = int(np.argmax(aux[:, _A_INVW] == which))
                tr = assemble(d, int(aux[d, _A_INVSLOT]), depth + 1) \
                    if store_trace else []
                return generated, distinct, ("invariant",
                                             me.inv_fns[which][0], tr)
            generated += int(scal[_S_GEN])
            distinct += int(scal[_S_NEW])
            depth += 1
            if int(scal[_S_FRONT]) == 0:
                return generated, distinct, None
        raise RuntimeError(f"did not converge in {max_levels} levels")
    finally:
        dist.destroy_process_group()


def fmt_trace_line(i, st, label) -> str:
    """One parseable line per trace step (sorted vars, sem.values.fmt),
    so callers compare multi-process traces with single-process ones
    textually."""
    from ..sem.values import fmt
    body = " /\\ ".join(f"{v} = {fmt(st[v])}" for v in sorted(st))
    return f"MHTRACE {i}: [{label}] {body}"


def launch(num_processes: int, args: List[str], timeout: float = 600.0,
           env=None) -> List[str]:
    """Start `num_processes` processes of this module on a fresh
    file:// store with the extra `args`, wait for all of them and return
    their standard outputs.  A process that fails or outlives `timeout`
    raises; every process started is stopped before this returns."""
    store = tempfile.mkdtemp(prefix="jaxmc_mh_")
    init = "file://" + os.path.join(store, "store")
    procs = []
    try:
        for i in range(num_processes):
            cmd = [sys.executable, "-m", "jaxmc_torch.backend.multihost",
                   "--process-id", str(i), "--num-processes",
                   str(num_processes), "--init-method", init] + list(args)
            procs.append(subprocess.Popen(
                cmd, cwd=_REPO, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=dict(env if env is not None else os.environ,
                         PYTHONPATH=_REPO)))
        deadline = time.time() + timeout
        outs = []
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=max(1.0,
                                                 deadline - time.time()))
            if p.returncode != 0:
                raise RuntimeError(f"multihost process {i} exited "
                                   f"{p.returncode}: {err.strip()[-2000:]}")
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in os.listdir(store):
            os.remove(os.path.join(store, f))
        os.rmdir(store)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m jaxmc_torch.backend.multihost")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--init-method", default="tcp://localhost:29521",
                    help="torch.distributed init method (file:// needs "
                         "no network)")
    ap.add_argument("--spec", default=None)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--fc", type=int, default=65536)
    ap.add_argument("--sc", type=int, default=1 << 19)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--backend", default=None, help="gloo or nccl")
    a = ap.parse_args(argv)
    gen, dist_, viol = run_multihost_child(
        a.process_id, a.num_processes, a.init_method, spec=a.spec,
        cfg=a.cfg, FC=a.fc, SC=a.sc, device=a.device, backend=a.backend)
    if viol is not None:
        kind, name, trace = viol
        print(f"MHVIOLATION p{a.process_id}: {kind} {name} "
              f"({len(trace)} states)", flush=True)
        for i, (st, label) in enumerate(trace):
            print(fmt_trace_line(i, st, label), flush=True)
    print(f"MULTIHOST p{a.process_id}: {gen} generated / "
          f"{dist_} distinct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
