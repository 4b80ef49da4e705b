r"""Module loading: EXTENDS closure, INSTANCE substitution, cfg binding.

Builds the definition table the evaluator runs against. Standard modules
(Naturals, Integers, Sequences, FiniteSets, Bags, TLC, Reals, Peano) are
native (SURVEY.md §1 L2): their operators live in stdlib.BUILTIN_OPS and the
identifiers Nat/Int/Real/BOOLEAN/STRING are injected here.

INSTANCE semantics (needed for the Paxos refinement chain,
tla-rust examples/Paxos/Paxos.tla:195): a named instance
`V == INSTANCE M WITH a <- e` creates a namespace in which M's definitions
are evaluated with M's constants/variables resolved through the
substitutions, themselves evaluated in the outer module's context. Omitted
substitutions default to the same-named outer entity.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..front import tla_ast as A
from ..front.parser import parse_module_text
from ..front.cfg import ModelConfig, CfgModelValue
from .values import (EvalError, ModelValue, BOOLEAN_SET, INT, NAT, REAL,
                     STRING_SET)
from .eval import Ctx, OpClosure, eval_expr, _force

NATIVE_MODULES = {"Naturals", "Integers", "Reals", "Sequences", "FiniteSets",
                  "Bags", "TLC", "Peano", "ProtoReals"}

BASE_IDENTS = {
    "Nat": NAT, "Int": INT, "Real": REAL,
    "BOOLEAN": BOOLEAN_SET, "STRING": STRING_SET,
    "Infinity": ModelValue("$Infinity"),
}


@dataclass
class LoadedModule:
    name: str
    ast: A.Module
    defs: Dict[str, Any] = field(default_factory=dict)
    constants: List[Tuple[str, int]] = field(default_factory=list)
    variables: List[str] = field(default_factory=list)
    assumes: List[A.Assume] = field(default_factory=list)
    path: Optional[str] = None


class InstanceNamespace:
    """Runtime value of `name(params) == INSTANCE M WITH substs`."""

    def __init__(self, module: LoadedModule, substs, params: Tuple[str, ...]):
        self.module = module
        self.substs = dict(substs)  # inner name -> outer expr
        self.params = params

    def enter(self, outer: Ctx, argvals) -> Ctx:
        """Build the evaluation context for expressions inside the instance."""
        if len(argvals) != len(self.params):
            raise EvalError(
                f"instance of {self.module.name} takes {len(self.params)} "
                f"arguments, got {len(argvals)}")
        outer_bound = {**outer.bound, **dict(zip(self.params, argvals))}
        subst_ctx_bound = outer_bound
        defs = dict(self.module.defs)
        # explicit substitutions: evaluate lazily in the outer context
        for inner_name, expr in self.substs.items():
            defs[inner_name] = OpClosure(inner_name, (), expr,
                                         dict(subst_ctx_bound), outer.defs)
        # implicit same-name substitutions for unsubstituted constants/vars
        for cname, arity in self.module.constants:
            if cname not in self.substs:
                defs[cname] = OpClosure(cname, (), A.Ident(cname),
                                        dict(subst_ctx_bound), outer.defs)
        for vname in self.module.variables:
            if vname not in self.substs and vname not in self.params:
                defs[vname] = OpClosure(vname, (), A.Ident(vname),
                                        dict(subst_ctx_bound), outer.defs)
        # params refer to outer values directly
        for p, v in zip(self.params, argvals):
            defs[p] = v
        return Ctx(defs, outer.bound, outer.state, outer.primes, outer.vars,
                   outer.on_print, outer.memo)

    def __repr__(self):
        return f"<instance of {self.module.name}>"


class Loader:
    def __init__(self, search_dirs: List[str]):
        self.search_dirs = list(search_dirs)
        self.cache: Dict[str, LoadedModule] = {}
        self.inner_modules: Dict[str, A.Module] = {}

    def find(self, name: str) -> str:
        for d in self.search_dirs:
            p = os.path.join(d, name + ".tla")
            if os.path.exists(p):
                return p
        raise EvalError(f"module {name} not found in {self.search_dirs}")

    def _parse_file(self, path: str) -> A.Module:
        from .. import obs
        tel = obs.current()
        with open(path, encoding="utf-8", errors="replace") as fh:
            src = fh.read()
        with tel.span("parse", module=os.path.basename(path)):
            ast = parse_module_text(src)
        from ..front.pcal import has_algorithm, translate_module
        if has_algorithm(src):
            # the in-memory equivalent of `make transpile` (Makefile:4)
            with tel.span("pcal_translate",
                          module=os.path.basename(path)):
                ast = translate_module(src, ast)
        return ast

    def load(self, name: str) -> LoadedModule:
        if name in self.cache:
            return self.cache[name]
        if name in self.inner_modules:
            return self.build(self.inner_modules[name], path=None)
        path = self.find(name)
        return self.build(self._parse_file(path), path, preferred_name=name)

    def load_path(self, path: str) -> LoadedModule:
        d = os.path.dirname(os.path.abspath(path))
        if d not in self.search_dirs:
            self.search_dirs.insert(0, d)
        return self.build(self._parse_file(path), path)

    def build(self, ast: A.Module, path: Optional[str],
              preferred_name: Optional[str] = None) -> LoadedModule:
        name = preferred_name or ast.name
        if name in self.cache:
            return self.cache[name]
        m = LoadedModule(name=name, ast=ast, path=path)
        self.cache[name] = m
        defs: Dict[str, Any] = dict(BASE_IDENTS)
        for ext in ast.extends:
            if ext in NATIVE_MODULES:
                continue
            sub = self.load(ext)
            defs.update(sub.defs)
            m.constants.extend(c for c in sub.constants
                               if c not in m.constants)
            m.variables.extend(v for v in sub.variables
                               if v not in m.variables)
        for u in ast.units:
            if isinstance(u, A.Module):
                # nested inner module: register for later INSTANCE
                self.inner_modules[u.name] = u
            elif isinstance(u, A.Constants):
                m.constants.extend(u.names)
            elif isinstance(u, A.Variables):
                m.variables.extend(u.names)
            elif isinstance(u, A.OpDef):
                defs[u.name] = OpClosure(u.name, u.params, u.body,
                                         stable=True)
            elif isinstance(u, A.FnConstrDef):
                defs[u.name] = OpClosure(u.name, (), u, stable=True)
            elif isinstance(u, A.InstanceDef):
                if u.name is None:
                    if u.module in NATIVE_MODULES:
                        continue
                    if u.substs:
                        raise EvalError(
                            "bare INSTANCE with WITH not supported")
                    sub = self.load(u.module)
                    defs.update(sub.defs)
                    m.constants.extend(c for c in sub.constants
                                       if c not in m.constants)
                    m.variables.extend(v for v in sub.variables
                                       if v not in m.variables)
                else:
                    sub = self.load(u.module)
                    defs[u.name] = InstanceNamespace(sub, u.substs, u.params)
            elif isinstance(u, A.Assume):
                m.assumes.append(u)
            elif isinstance(u, (A.Theorem, A.RecursiveDecl)):
                continue
            else:
                raise EvalError(f"unsupported module unit {u!r}")
        m.defs = defs
        return m


@dataclass
class Model:
    """A loaded module plus a bound cfg: ready to check."""
    module: LoadedModule
    cfg: ModelConfig
    init: A.Node
    next: A.Node
    invariants: List[Tuple[str, A.Node]]
    constraints: List[Tuple[str, A.Node]]
    action_constraints: List[Tuple[str, A.Node]]
    properties: List[Tuple[str, A.Node]]
    symmetry: Optional[A.Node]
    # cfg VIEW: states are deduplicated by this expression's VALUE instead
    # of the full state (TLC semantics, ConfigFileGrammar.tla:8-11) —
    # interp backend only; the jax backends reject it loudly
    view: Optional[A.Node]
    vars: Tuple[str, ...]
    defs: Dict[str, Any]
    check_deadlock: bool = True
    # fairness conjuncts of the SPECIFICATION formula (WF/SF, possibly
    # quantified or behind named ops) — consumed by engine/liveness.py
    fairness: List[A.Node] = field(default_factory=list)
    _memo: Any = field(default=None, repr=False, compare=False)

    def ctx(self, state=None, primes=None, on_print=None) -> Ctx:
        # one MemoStore per model: operator results are keyed by dependency
        # values, and constants differ between models (sem/memo.py)
        if self._memo is None:
            from .memo import MemoStore
            self._memo = MemoStore(self.defs)
        return Ctx(self.defs, {}, state, primes, self.vars, on_print,
                   self._memo)


def satisfies_constraints(model: "Model", state) -> bool:
    """Does `state` satisfy every cfg CONSTRAINT? The ONE implementation —
    the engine, the device backends, and layout sampling must agree on
    which states the search keeps (TLC discard semantics)."""
    if not model.constraints:
        return True  # skip the per-state ctx build entirely
    from .eval import _bool
    ctx = model.ctx(state=state)
    for name, expr in model.constraints:
        if not _bool(eval_expr(expr, ctx), f"constraint {name}"):
            return False
    return True


def _cfg_value(v):
    if isinstance(v, CfgModelValue):
        return ModelValue(v.name)
    if isinstance(v, frozenset):
        return frozenset(_cfg_value(x) for x in v)
    return v


def _split_spec(expr: A.Node, defs: Dict[str, Any]):
    """Extract Init and Next from Spec == Init /\\ [][Next]_vars /\\ fairness.

    A conjunct that is a plain name (LSpec == HC /\\ WF_hr(HCnxt),
    Liveness/LiveHourClock.tla:9) is expanded when its definition contains
    a [][N]_v somewhere — so nested Spec definitions resolve — and treated
    as the initial predicate otherwise."""
    from ..front.subst import contains_box
    init = None
    nxt = None
    sub = None
    fair = []

    def walk(e):
        nonlocal init, nxt, sub
        if isinstance(e, A.OpApp) and e.name == "/\\":
            walk(e.args[0])
            walk(e.args[1])
            return
        if isinstance(e, A.OpApp) and e.name == "[]" and \
                isinstance(e.args[0], A.BoxAction):
            if nxt is not None:
                raise EvalError("specification has two [][Next]_vars "
                                "conjuncts")
            nxt = e.args[0].action
            sub = e.args[0].sub
            return
        if isinstance(e, (A.Fair, A.Quant)):
            fair.append(e)
            return
        if isinstance(e, A.Ident):
            d = defs.get(e.name)
            if isinstance(d, OpClosure) and not d.params \
                    and contains_box(d.body):
                walk(d.body)
                return
        if init is None:
            init = e
        else:
            fair.append(e)

    walk(expr)
    if init is None or nxt is None:
        raise EvalError("could not extract Init and [][Next]_vars from "
                        "specification formula")
    return init, nxt, sub, fair


def bind_model_defs(module: LoadedModule, cfg: ModelConfig) -> Dict[str, Any]:
    """Bind cfg constants/overrides into a definition table."""
    defs = dict(module.defs)
    declared = {n for n, _ in module.constants}
    for cname, val in cfg.constants.items():
        defs[cname] = _cfg_value(val)
    for cname, defn in cfg.overrides.items():
        if defn not in defs:
            raise EvalError(f"cfg substitutes {cname} <- {defn}, "
                            f"but {defn} is not defined")
        defs[cname] = defs[defn]
    # scoped overrides (Ballot <-[Voting] MCBallot): rebuild the affected
    # instances with the extra substitution — never mutate the loader-cached
    # namespace, other models may share it
    for (modname, cname), defn in cfg.scoped_overrides.items():
        for k, v in list(defs.items()):
            if isinstance(v, InstanceNamespace) and v.module.name == modname:
                defs[k] = InstanceNamespace(
                    v.module, {**v.substs, cname: A.Ident(defn)}, v.params)
    missing = [n for n in declared if n not in defs]
    if missing:
        raise EvalError(f"constants not bound by cfg: {missing}")
    return defs


def bind_model(module: LoadedModule, cfg: ModelConfig) -> Model:
    """Bind cfg constants/overrides and resolve the checked formulas."""
    defs = bind_model_defs(module, cfg)
    vars = tuple(module.variables)

    def named(nm):
        d = defs.get(nm)
        if d is None:
            raise EvalError(f"cfg names unknown definition {nm}")
        if isinstance(d, OpClosure):
            return d.body
        raise EvalError(f"cfg name {nm} does not name a definition")

    fair: List[A.Node] = []
    if cfg.specification:
        spec_body = named(cfg.specification)
        init, nxt, _sub, fair = _split_spec(spec_body, defs)
    else:
        if not cfg.init or not cfg.next:
            raise EvalError("cfg must give SPECIFICATION or INIT+NEXT")
        init = named(cfg.init)
        nxt = named(cfg.next)

    invariants = [(nm, named(nm)) for nm in cfg.invariants]
    constraints = [(nm, named(nm)) for nm in cfg.constraints]
    action_constraints = [(nm, named(nm)) for nm in cfg.action_constraints]
    properties = [(nm, named(nm)) for nm in cfg.properties]
    symmetry = named(cfg.symmetry) if cfg.symmetry else None
    view = None
    if cfg.view:
        vd = defs.get(cfg.view)
        if not isinstance(vd, OpClosure):
            raise EvalError(f"cfg VIEW names unknown definition "
                            f"{cfg.view}")
        if vd.params:
            # TLC rejects parameterized views at config time too; letting
            # it through would crash on the unhashable closure later
            raise EvalError(f"cfg VIEW {cfg.view} takes parameters; a "
                            f"view must be a state expression")
        view = A.Ident(cfg.view)

    return Model(module=module, cfg=cfg, init=init, next=nxt,
                 invariants=invariants, constraints=constraints,
                 action_constraints=action_constraints,
                 properties=properties, symmetry=symmetry, view=view,
                 vars=vars, defs=defs, check_deadlock=cfg.check_deadlock,
                 fairness=fair)
