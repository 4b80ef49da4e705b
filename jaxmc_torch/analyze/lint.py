r"""The corpus linter.

Pure parse-level diagnostics over a (spec, cfg) pair — no search, no
kernel build — each with a STABLE code, a severity, and a source
location:

  JMC100 error    spec/cfg does not parse (or a module is missing)
  JMC101 error    cfg names an undefined definition (INIT/NEXT/
                  SPECIFICATION/INVARIANT/PROPERTY/CONSTRAINT/
                  ACTION-CONSTRAINT/SYMMETRY/VIEW)
  JMC102 error    declared CONSTANT never assigned by the cfg
  JMC103 warning  cfg assigns a name that is not a declared CONSTANT
  JMC104 error    cfg substitution `c <- D` where D is undefined
  JMC201 warning  declared VARIABLE never referenced by any definition
  JMC202 warning  statically dead action: its guard is false in every
                  reachable state (interval analysis, analyze/bounds.py)
  JMC203 warning  symmetry-soundness hazard: a symmetry-set constant
                  (or an element bound from it) used in an
                  order-sensitive position (CHOOSE / < <= > >= ..)
  JMC301 info     definition never used (unreachable from the checked
                  cfg entrypoints)
  JMC302 info     declared CONSTANT never used

Severity is the triage contract: `check --analyze=strict` (and the
serve daemon's submit gate) fail on ERRORS; warnings and infos print
but never block.  `python -m jaxmc_torch.analyze lint-corpus`
additionally fails on warnings in the repo corpus unless the manifest
carries an explicit waiver (corpus.py Case.lint_waive).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set, Tuple

from ..front import tla_ast as A

_SEV_RANK = {"error": 2, "warning": 1, "info": 0}


@dataclass
class Diagnostic:
    code: str
    severity: str  # "error" | "warning" | "info"
    message: str
    path: Optional[str] = None
    line: Optional[int] = None

    def render(self) -> str:
        loc = ""
        if self.path:
            loc = os.path.basename(self.path)
            if self.line:
                loc += f":{self.line}"
            loc += ": "
        return f"{loc}{self.code} {self.severity}: {self.message}"


def max_severity(diags: List[Diagnostic]) -> Optional[str]:
    if not diags:
        return None
    return max(diags, key=lambda d: _SEV_RANK[d.severity]).severity


def errors(diags: List[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == "error"]


# ------------------------------------------------------------------ utils

def _locate(src: str, name: str, defn: bool = False) -> Optional[int]:
    """1-based line of `name` in source text; with defn=True prefer its
    definition/declaration site (`Name ==` / `Name(..) ==`)."""
    if not src:
        return None
    if defn:
        pat = re.compile(r"^\s*(?:LOCAL\s+)?" + re.escape(name)
                         + r"\s*(?:\(|\[|==)", re.M)
        m = pat.search(src)
        if m:
            return src.count("\n", 0, m.start()) + 1
    m = re.search(r"\b" + re.escape(name) + r"\b", src)
    if m:
        return src.count("\n", 0, m.start()) + 1
    return None


def _ast_refs(e: Any, out: Set[str]) -> None:
    """Every identifier/operator name referenced under e (including
    binder names — an over-approximation that keeps 'unused' lints
    conservative)."""
    if isinstance(e, A.Ident):
        out.add(e.name)
    elif isinstance(e, A.OpApp):
        out.add(e.name)
        for pn, pargs in e.path:
            out.add(pn)
            for pa in pargs:
                _ast_refs(pa, out)
    if isinstance(e, A.Node):
        for f in getattr(e, "__dataclass_fields__", {}):
            v = getattr(e, f)
            if isinstance(v, A.Node):
                _ast_refs(v, out)
            elif isinstance(v, tuple):
                _tuple_refs(v, out)
    elif isinstance(e, tuple):
        _tuple_refs(e, out)


def _tuple_refs(t: tuple, out: Set[str]) -> None:
    for x in t:
        if isinstance(x, (A.Node, tuple)):
            _ast_refs(x, out)
        elif isinstance(x, str):
            # Except paths carry ('dot', name) items; harmless extras
            continue


# ------------------------------------------------------------------ lint


def lint_pair(spec_path: str, cfg_path: Optional[str],
              includes: Tuple[str, ...] = (),
              semantic: bool = True) -> List[Diagnostic]:
    """Lint one spec+cfg pair; never raises — every defect (including
    parse failures) comes back as a Diagnostic.  semantic=False skips
    the interval-analysis lints (dead actions, symmetry hazards) —
    they only ever produce warnings, so error-gating callers (the serve
    daemon's submit check) can stay parse-cheap."""
    from ..front.cfg import CfgError, ModelConfig, parse_cfg
    from ..sem.modules import Loader

    diags: List[Diagnostic] = []
    cfg_src = ""
    if cfg_path is None:
        guess = os.path.splitext(spec_path)[0] + ".cfg"
        cfg_path = guess if os.path.exists(guess) else None
    if cfg_path:
        try:
            with open(cfg_path, encoding="utf-8",
                      errors="replace") as fh:
                cfg_src = fh.read()
            cfg = parse_cfg(cfg_src)
        except (CfgError, OSError) as ex:
            return [Diagnostic("JMC100", "error",
                               f"cfg does not parse: {ex}",
                               path=cfg_path)]
    else:
        cfg = ModelConfig(specification="Spec")

    try:
        with open(spec_path, encoding="utf-8", errors="replace") as fh:
            spec_src = fh.read()
    except OSError as ex:
        return diags + [Diagnostic("JMC100", "error", str(ex),
                                   path=spec_path)]
    try:
        ldr = Loader([os.path.dirname(os.path.abspath(spec_path))]
                     + list(includes))
        mod = ldr.load_path(spec_path)
    except Exception as ex:  # LexError/ParseError/EvalError/IO
        return diags + [Diagnostic(
            "JMC100", "error",
            f"spec does not load: {type(ex).__name__}: {ex}",
            path=spec_path)]

    diags += _lint_cfg_refs(mod, cfg, cfg_path, cfg_src)
    diags += _lint_unused(mod, cfg, spec_path, spec_src, cfg_src)
    if semantic:
        diags += _lint_semantic(mod, cfg, spec_path, spec_src, diags)
    # a degenerate cfg can repeat one defect (INVARIANT { { {): one
    # diagnostic per distinct finding
    seen = set()
    uniq = []
    for d in diags:
        key = (d.code, d.message, d.path, d.line)
        if key not in seen:
            seen.add(key)
            uniq.append(d)
    uniq.sort(key=lambda d: (-_SEV_RANK[d.severity], d.code,
                             d.line or 0))
    return uniq


def _cfg_role_names(cfg) -> List[Tuple[str, str]]:
    out = []
    for role, nm in (("SPECIFICATION", cfg.specification),
                     ("INIT", cfg.init), ("NEXT", cfg.next),
                     ("SYMMETRY", cfg.symmetry), ("VIEW", cfg.view)):
        if nm:
            out.append((role, nm))
    for role, names in (("INVARIANT", cfg.invariants),
                        ("PROPERTY", cfg.properties),
                        ("CONSTRAINT", cfg.constraints),
                        ("ACTION-CONSTRAINT", cfg.action_constraints)):
        for nm in names:
            out.append((role, nm))
    return out


def _lint_cfg_refs(mod, cfg, cfg_path, cfg_src) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    declared = {n for n, _a in mod.constants}
    for role, nm in _cfg_role_names(cfg):
        if nm not in mod.defs:
            diags.append(Diagnostic(
                "JMC101", "error",
                f"cfg {role} names undefined definition {nm!r}",
                path=cfg_path, line=_locate(cfg_src, nm)))
    # declared constants that neither a cfg assignment, an override,
    # nor a module-level definition satisfies — bind_model would refuse
    for n in sorted(declared):
        if n not in cfg.constants and n not in cfg.overrides \
                and n not in mod.defs:
            diags.append(Diagnostic(
                "JMC102", "error",
                f"CONSTANT {n} is declared but never assigned by the "
                f"cfg", path=cfg_path,
                line=_locate(cfg_src, n) or 1))
    for n in sorted(cfg.constants):
        if n not in declared:
            diags.append(Diagnostic(
                "JMC103", "warning",
                f"cfg assigns {n}, which is not a declared CONSTANT",
                path=cfg_path, line=_locate(cfg_src, n)))
    for n, target in sorted(cfg.overrides.items()):
        if target not in mod.defs:
            diags.append(Diagnostic(
                "JMC104", "error",
                f"cfg substitutes {n} <- {target}, but {target} is "
                f"undefined", path=cfg_path,
                line=_locate(cfg_src, target)))
    return diags


def _reachable(mod, cfg) -> Tuple[Set[str], Set[str]]:
    """(reachable definition names, union of every name referenced from
    a reachable body / ASSUME)."""
    from ..sem.eval import OpClosure

    body_refs: Dict[str, Set[str]] = {}

    def refs_of(name: str) -> Set[str]:
        if name in body_refs:
            return body_refs[name]
        d = mod.defs.get(name)
        out: Set[str] = set()
        body_refs[name] = out
        if isinstance(d, OpClosure):
            _ast_refs(d.body, out)
        else:
            from ..sem.modules import InstanceNamespace
            if isinstance(d, InstanceNamespace):
                for _inner, expr in d.substs.items():
                    _ast_refs(expr, out)
        return out

    entries = [nm for _role, nm in _cfg_role_names(cfg)]
    entries += list(cfg.overrides.values())
    entries += [t for (_m, _c), t in cfg.scoped_overrides.items()]
    seen: Set[str] = set()
    refs_union: Set[str] = set()
    for a in mod.assumes:
        _ast_refs(a.expr, refs_union)
    stack = [e for e in entries if e in mod.defs]
    stack += [e for e in refs_union if e in mod.defs]
    seen.update(stack)
    while stack:
        nm = stack.pop()
        rs = refs_of(nm)
        refs_union |= rs
        for r in rs:
            if r in mod.defs and r not in seen:
                seen.add(r)
                stack.append(r)
    return seen, refs_union


def _lint_unused(mod, cfg, spec_path, spec_src,
                 cfg_src) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    reachable, refs_union = _reachable(mod, cfg)
    role_names = {nm for _r, nm in _cfg_role_names(cfg)}

    top_defs = [u for u in mod.ast.units
                if isinstance(u, (A.OpDef, A.FnConstrDef))]
    for u in top_defs:
        if u.name not in reachable and u.name not in role_names:
            diags.append(Diagnostic(
                "JMC301", "info",
                f"definition {u.name} is never used (unreachable from "
                f"the cfg entrypoints)", path=spec_path,
                line=_locate(spec_src, u.name, defn=True)))
    top_vars: List[str] = []
    top_consts: List[str] = []
    for u in mod.ast.units:
        if isinstance(u, A.Variables):
            top_vars.extend(u.names)
        elif isinstance(u, A.Constants):
            top_consts.extend(n for n, _a in u.names)
    for v in top_vars:
        if v not in refs_union:
            diags.append(Diagnostic(
                "JMC201", "warning",
                f"VARIABLE {v} is never used", path=spec_path,
                line=_locate(spec_src, v)))
    for c in top_consts:
        if c not in refs_union:
            diags.append(Diagnostic(
                "JMC302", "info",
                f"CONSTANT {c} is declared but never used",
                path=spec_path, line=_locate(spec_src, c)))
    return diags


def _sanitized_bind(mod, cfg):
    """bind_model with the already-reported cfg defects patched out, so
    the semantic lints (dead actions, symmetry hazards) still run on a
    broken-cfg fixture: undefined role names are dropped, unassigned
    constants get placeholder model values."""
    import copy
    from ..front.cfg import CfgModelValue
    from ..sem.modules import bind_model

    cfg2 = copy.deepcopy(cfg)
    for role in ("specification", "init", "next", "symmetry", "view"):
        nm = getattr(cfg2, role)
        if nm and nm not in mod.defs:
            setattr(cfg2, role, None)
    for role in ("invariants", "properties", "constraints",
                 "action_constraints"):
        setattr(cfg2, role,
                [nm for nm in getattr(cfg2, role) if nm in mod.defs])
    cfg2.overrides = {n: t for n, t in cfg2.overrides.items()
                      if t in mod.defs}
    for n, _a in mod.constants:
        if n not in cfg2.constants and n not in cfg2.overrides \
                and n not in mod.defs:
            cfg2.constants[n] = CfgModelValue(n)
    return bind_model(mod, cfg2)


_ORDER_OPS = {"<", "<=", "=<", "\\leq", ">", ">=", "\\geq", ".."}


def _lint_semantic(mod, cfg, spec_path, spec_src,
                   prior: List[Diagnostic]) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    try:
        model = _sanitized_bind(mod, cfg)
    except Exception:
        return diags  # bind defects are already reported as errors
    # dead actions (JMC202) — interval analysis over the arm guards
    try:
        from ..compile.ground import split_arms
        from .bounds import dead_arms, infer_state_bounds
        arms = split_arms(model)
        report = infer_state_bounds(model)
        if report is not None:
            for _i, label in dead_arms(model, arms, report):
                diags.append(Diagnostic(
                    "JMC202", "warning",
                    f"action {label} is statically dead (its guard is "
                    f"false in every reachable state)", path=spec_path,
                    line=_locate(spec_src, label, defn=True)))
    except Exception:
        if os.environ.get("JAXMC_DEBUG"):
            raise
    # symmetry hazards (JMC203)
    try:
        diags += _lint_symmetry(mod, model, spec_path, spec_src)
    except Exception:
        if os.environ.get("JAXMC_DEBUG"):
            raise
    return diags


def _lint_symmetry(mod, model, spec_path, spec_src) -> List[Diagnostic]:
    if model.symmetry is None:
        return []
    from ..sem.eval import OpClosure
    sym_refs: Set[str] = set()
    _ast_refs(model.symmetry, sym_refs)
    declared = {n for n, _a in mod.constants}
    sym_consts = {n for n in sym_refs if n in declared
                  and isinstance(model.defs.get(n), frozenset)}
    if not sym_consts:
        return []
    reachable, _ = _reachable(mod, model.cfg)
    diags: List[Diagnostic] = []
    seen_sites: Set[Tuple[str, str]] = set()

    def refs_sym(e) -> bool:
        rs: Set[str] = set()
        _ast_refs(e, rs)
        return bool(rs & sym_consts)

    def scan(e, tainted: Set[str], where: str) -> None:
        if isinstance(e, A.Choose):
            if e.set is not None and refs_sym(e.set):
                key = (where, "CHOOSE")
                if key not in seen_sites:
                    seen_sites.add(key)
                    cs = sorted(sym_consts)[0]
                    diags.append(Diagnostic(
                        "JMC203", "warning",
                        f"{where}: CHOOSE over the symmetry set "
                        f"{cs} is order-sensitive — symmetry "
                        f"reduction may be unsound", path=spec_path,
                        line=_locate(spec_src, where, defn=True)))
        if isinstance(e, A.OpApp) and e.name in _ORDER_OPS:
            for a in e.args:
                if isinstance(a, A.Ident) and \
                        (a.name in sym_consts or a.name in tainted):
                    key = (where, e.name)
                    if key not in seen_sites:
                        seen_sites.add(key)
                        diags.append(Diagnostic(
                            "JMC203", "warning",
                            f"{where}: order-sensitive operator "
                            f"{e.name!r} applied to an element of the "
                            f"symmetry set ({a.name})", path=spec_path,
                            line=_locate(spec_src, where, defn=True)))
        t2 = tainted
        if isinstance(e, (A.Quant, A.SetFilter, A.SetMap, A.FnDef,
                          A.Choose)):
            names: List[str] = []
            sets: List[Any] = []
            if isinstance(e, (A.SetFilter, A.Choose)):
                v = e.var
                names = list(v) if isinstance(v, tuple) else [v]
                sets = [e.set] if getattr(e, "set", None) is not None \
                    else []
            else:
                for bnames, s in e.binders:
                    if s is not None and refs_sym(s):
                        names.extend(bnames)
                        sets.append(s)
            if names and any(s is not None and refs_sym(s)
                             for s in sets):
                t2 = set(tainted) | set(names)
        if isinstance(e, A.Node):
            for f in getattr(e, "__dataclass_fields__", {}):
                v = getattr(e, f)
                if isinstance(v, A.Node):
                    scan(v, t2, where)
                elif isinstance(v, tuple):
                    _scan_tuple(v, t2, where)

    def _scan_tuple(t, tainted, where):
        for x in t:
            if isinstance(x, A.Node):
                scan(x, tainted, where)
            elif isinstance(x, tuple):
                _scan_tuple(x, tainted, where)

    for nm in sorted(reachable):
        d = mod.defs.get(nm)
        if isinstance(d, OpClosure):
            scan(d.body, set(), nm)
    return diags
