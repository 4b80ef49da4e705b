r"""PlusCal (p-syntax) → TLA+ translator for the corpus subset.

Observable contract (tla-rust README.md:217-311 and p-manual.pdf):
per-process locals and pc become functions over ProcSet, every label becomes
an action parameterized by `self`, labels inside if-branches end the enclosing
action with a conditional pc' assignment, and the whole algorithm yields
Init / per-label actions / Next / Spec / Terminating definitions.

Subset: top-level `variables`, `process P \in S` / `process P = v` with local
`variables`, statements: `x := e`, `if/then/else/end if`, `while/do/end while`,
`await e`, `assert e`, `skip`, `goto L`, with labels anywhere a statement
starts. This covers pcal_intro.tla, atomic_add.tla and the README's buggy
money-transfer variant (README.md:222-241).

The translation is built directly as AST units appended to the host module —
no text round-trip.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .lexer import tokenize
from .parser import Parser
from . import tla_ast as A


class PcalError(Exception):
    pass


# ---- statement forms ----

@dataclass
class Assign:
    var: str
    expr: A.Node
    line: int = 0


@dataclass
class If:
    cond: A.Node
    then: List
    els: List


@dataclass
class While:
    cond: A.Node
    body: List


@dataclass
class Await:
    expr: A.Node


@dataclass
class AssertStmt:
    expr: A.Node
    line: int
    col: int


@dataclass
class Skip:
    pass


@dataclass
class Goto:
    label: str


@dataclass
class Labeled:
    label: str
    stmt: object


@dataclass
class ProcDecl:
    name: str
    ids: A.Node          # the id-set expression (or singleton value expr)
    singleton: bool      # process Name = expr
    locals: List[Tuple[str, str, A.Node]]  # (name, '='|'in', expr)
    body: List


@dataclass
class Algorithm:
    name: str
    globals: List[Tuple[str, str, A.Node]]
    procs: List[ProcDecl]


_ALG_RE = re.compile(r"\(\*\s*--algorithm\s+(\w+)(.*?)end\s+algorithm\s*;?\s*\*\)",
                     re.DOTALL)


def has_algorithm(src: str) -> bool:
    return _ALG_RE.search(src) is not None


class _P(Parser):
    """Token cursor over the algorithm body, reusing the TLA+ expression
    parser for embedded expressions."""

    def at_word(self, *words) -> bool:
        return self.cur.kind == "ident" and self.cur.text in words

    def expect_word(self, w):
        if not self.at_word(w):
            raise PcalError(f"expected '{w}' at {self.cur.line}:{self.cur.col}"
                            f", found {self.cur.text!r}")
        return self.next()

    def parse_var_decls(self):
        decls = []
        while True:
            if self.cur.kind != "ident" or self.at_word(
                    "process", "begin", "define", "macro", "procedure"):
                break
            name = self.next().text
            if self.at_op("="):
                self.next()
                decls.append((name, "=", self.parse_expr()))
            elif self.at_op("\\in"):
                self.next()
                decls.append((name, "in", self.parse_expr()))
            else:
                decls.append((name, "=", A.Ident("defaultInitValue")))
            if self.at_op(",") or self.at_op(";"):
                self.next()
                continue
        return decls

    def parse_stmts(self, stop_words) -> List:
        out = []
        while True:
            if self.cur.kind == "eof" or self.at_word(*stop_words):
                return out
            if self.at_op(";"):
                self.next()
                continue
            out.append(self.parse_stmt())

    def parse_stmt(self):
        # label?
        if self.cur.kind == "ident" and self.peek().kind == "op" \
                and self.peek().text == ":" and not self.at_word(
                    "if", "while", "await", "when", "assert", "skip", "goto"):
            label = self.next().text
            self.next()  # ':'
            return Labeled(label, self.parse_stmt())
        if self.at_word("if"):
            self.next()
            cond = self.parse_expr()
            self.expect_word("then")
            then = self.parse_stmts(("else", "elsif", "end"))
            els: List = []
            if self.at_word("else"):
                self.next()
                els = self.parse_stmts(("end",))
            elif self.at_word("elsif"):
                raise PcalError("elsif not supported")
            self.expect_word("end")
            self.expect_word("if")
            return If(cond, then, els)
        if self.at_word("while"):
            self.next()
            cond = self.parse_expr()
            self.expect_word("do")
            body = self.parse_stmts(("end",))
            self.expect_word("end")
            self.expect_word("while")
            return While(cond, body)
        if self.at_word("await", "when"):
            self.next()
            return Await(self.parse_expr())
        if self.at_word("assert"):
            t = self.cur
            self.next()
            return AssertStmt(self.parse_expr(), t.line, t.col)
        if self.at_word("skip"):
            self.next()
            return Skip()
        if self.at_word("goto"):
            self.next()
            return Goto(self.next().text)
        if self.cur.kind == "ident":
            t = self.cur
            name = self.next().text
            if self.at_op(":="):
                self.next()
                return Assign(name, self.parse_expr(), t.line)
            raise PcalError(f"unsupported statement at {t.line}:{t.col} "
                            f"({name!r})")
        raise PcalError(f"unsupported statement at "
                        f"{self.cur.line}:{self.cur.col}")


def parse_algorithm(src: str) -> Tuple[Algorithm, int]:
    """Extract and parse the PlusCal algorithm; returns (alg, line offset)."""
    m = _ALG_RE.search(src)
    if not m:
        raise PcalError("no --algorithm block found")
    name = m.group(1)
    body = m.group(2)
    line_off = src[:m.start(2)].count("\n")
    p = _P(tokenize(body))
    globals_: List = []
    procs: List[ProcDecl] = []
    while p.cur.kind != "eof":
        if p.at_word("variables", "variable"):
            p.next()
            globals_.extend(p.parse_var_decls())
            continue
        if p.at_word("define"):
            raise PcalError("define blocks not supported yet")
        if p.at_word("process"):
            p.next()
            pname = p.next().text
            if p.at_op("="):
                p.next()
                ids = p.parse_expr()
                singleton = True
            elif p.at_op("\\in"):
                p.next()
                ids = p.parse_expr()
                singleton = False
            else:
                raise PcalError("process needs = or \\in")
            locs: List = []
            if p.at_word("variables", "variable"):
                p.next()
                locs = p.parse_var_decls()
            p.expect_word("begin")
            stmts = p.parse_stmts(("end",))
            p.expect_word("end")
            p.expect_word("process")
            if p.at_op(";"):
                p.next()
            procs.append(ProcDecl(pname, ids, singleton, locs, stmts))
            continue
        if p.at_word("begin"):
            raise PcalError("single-process algorithms not supported yet")
        raise PcalError(f"unexpected token {p.cur.text!r} at "
                        f"{p.cur.line}:{p.cur.col}")
    if not procs:
        raise PcalError("algorithm has no processes")
    return Algorithm(name, globals_, procs), line_off


# ---- translation ----

def _conj(items: List[A.Node]) -> A.Node:
    out = items[0]
    for it in items[1:]:
        out = A.OpApp("/\\", (out, it))
    return out


def _disj(items: List[A.Node]) -> A.Node:
    out = items[0]
    for it in items[1:]:
        out = A.OpApp("\\/", (out, it))
    return out


def _eq(a, b):
    return A.OpApp("=", (a, b))


def _pc_is(label):
    return _eq(A.FnApp(A.Ident("pc"), (A.Ident("self"),)), A.Str(label))


def _pc_set(label):
    return _eq(A.Prime(A.Ident("pc")),
               A.Except(A.Ident("pc"),
                        ((((("idx", (A.Ident("self"),))),), A.Str(label)),)))


@dataclass
class _Path:
    # ordered action conjuncts: ('cond', expr) or ('upd', var, rhs_expr),
    # in statement order — order matters because a read after an assignment
    # sees the primed value
    items: List[tuple] = field(default_factory=list)
    next_label: Optional[str] = None

    def assigned(self):
        return {it[1] for it in self.items if it[0] == 'upd'}


class Translator:
    def __init__(self, alg: Algorithm, line_off: int, module_name: str):
        self.alg = alg
        self.line_off = line_off
        self.module_name = module_name
        self.global_names = [n for n, _, _ in alg.globals]
        self.all_vars: List[str] = list(self.global_names)
        for pr in alg.procs:
            self.all_vars.extend(n for n, _, _ in pr.locals)
        self.all_vars.append("pc")

    # -- expression rewriting: local var v  ->  v[self] --
    def _rw(self, e: A.Node, locals_: set) -> A.Node:
        R = lambda x: self._rw(x, locals_)
        if isinstance(e, A.Ident):
            if e.name in locals_:
                return A.FnApp(A.Ident(e.name), (A.Ident("self"),))
            return e
        if isinstance(e, A.Num) or isinstance(e, A.Str) or isinstance(e, A.Bool):
            return e
        if isinstance(e, A.OpApp):
            return A.OpApp(e.name, tuple(R(a) for a in e.args), e.path)
        if isinstance(e, A.FnApp):
            return A.FnApp(R(e.fn), tuple(R(a) for a in e.args))
        if isinstance(e, A.Dot):
            return A.Dot(R(e.expr), e.fld)
        if isinstance(e, A.TupleExpr):
            return A.TupleExpr(tuple(R(x) for x in e.items))
        if isinstance(e, A.SetEnum):
            return A.SetEnum(tuple(R(x) for x in e.items))
        if isinstance(e, A.If):
            return A.If(R(e.cond), R(e.then), R(e.els))
        if isinstance(e, A.SetFilter):
            return A.SetFilter(e.var, R(e.set), R(e.pred))
        if isinstance(e, A.SetMap):
            return A.SetMap(R(e.expr),
                            tuple((n, R(s)) for n, s in e.binders))
        if isinstance(e, A.Quant):
            return A.Quant(e.kind,
                           tuple((n, R(s) if s else None) for n, s in e.binders),
                           R(e.body))
        if isinstance(e, A.FnDef):
            return A.FnDef(tuple((n, R(s)) for n, s in e.binders), R(e.body))
        if isinstance(e, A.Except):
            return A.Except(R(e.fn), tuple(
                ((tuple(("idx", tuple(R(i) for i in arg)) if k == "idx"
                        else (k, arg) for k, arg in path)), R(rhs))
                for path, rhs in e.updates))
        if isinstance(e, A.Choose):
            return A.Choose(e.var, R(e.set) if e.set else None, R(e.pred))
        return e

    def translate(self) -> List[A.Node]:
        alg = self.alg
        units: List[A.Node] = []
        # ProcSet
        id_sets = []
        for pr in alg.procs:
            ids = pr.ids
            id_sets.append(A.SetEnum((ids,)) if pr.singleton else ids)
        procset: A.Node = id_sets[0]
        for s in id_sets[1:]:
            procset = A.OpApp("\\cup", (procset, s))
        units.append(A.OpDef("ProcSet", (), procset))

        # vars tuple
        units.append(A.OpDef("vars", (), A.TupleExpr(
            tuple(A.Ident(v) for v in self.all_vars))))

        # Init
        init_conjs: List[A.Node] = []
        for n, kind, e in alg.globals:
            init_conjs.append(
                _eq(A.Ident(n), e) if kind == "=" else
                A.OpApp("\\in", (A.Ident(n), e)))
        for pr in alg.procs:
            locals_ = {n for n, _, _ in pr.locals}
            idset = A.SetEnum((pr.ids,)) if pr.singleton else pr.ids
            for n, kind, e in pr.locals:
                if kind == "=":
                    init_conjs.append(_eq(
                        A.Ident(n),
                        A.FnDef(((("self",), idset),), self._rw(e, locals_))))
                else:
                    init_conjs.append(A.OpApp("\\in", (
                        A.Ident(n), A.FnSet(idset, e))))
        # pc initial: first label per process
        arms = []
        for pr in alg.procs:
            first = self._first_label(pr)
            guard = _eq(A.Ident("self"), pr.ids) if pr.singleton else \
                A.OpApp("\\in", (A.Ident("self"), pr.ids))
            arms.append((guard, A.Str(first)))
        pc_init = A.FnDef(((("self",), A.Ident("ProcSet")),),
                          A.Case(tuple(arms), None))
        init_conjs.append(_eq(A.Ident("pc"), pc_init))
        units.append(A.OpDef("Init", (), _conj(init_conjs)))

        # actions per process
        proc_next_disjs: List[A.Node] = []
        for pr in alg.procs:
            actions = self._compile_proc(pr)
            label_names = []
            for label, body in actions:
                units.append(A.OpDef(label, ("self",), body))
                label_names.append(label)
            pbody = _disj([A.OpApp(l, (A.Ident("self"),))
                           for l in label_names])
            units.append(A.OpDef(pr.name, ("self",), pbody))
            if pr.singleton:
                proc_next_disjs.append(A.OpApp(pr.name, (pr.ids,)))
            else:
                proc_next_disjs.append(A.Quant(
                    "E", ((("self",), pr.ids),),
                    A.OpApp(pr.name, (A.Ident("self"),))))

        # Terminating
        term = A.OpApp("/\\", (
            A.Quant("A", ((("self",), A.Ident("ProcSet")),),
                    _pc_is_done()),
            A.Unchanged(A.Ident("vars"))))
        units.append(A.OpDef("Terminating", (), term))
        proc_next_disjs.append(A.Ident("Terminating"))
        units.append(A.OpDef("Next", (), _disj(proc_next_disjs)))
        units.append(A.OpDef("Spec", (), A.OpApp("/\\", (
            A.Ident("Init"),
            A.OpApp("[]", (A.BoxAction(A.Ident("Next"), A.Ident("vars")),))))))
        units.append(A.OpDef("Termination", (), A.OpApp("<>", (
            A.Quant("A", ((("self",), A.Ident("ProcSet")),),
                    _pc_is_done()),))))
        return units

    def _first_label(self, pr: ProcDecl) -> str:
        s = pr.body[0]
        if isinstance(s, Labeled):
            return s.label
        raise PcalError(f"process {pr.name} body must start with a label")

    def _compile_proc(self, pr: ProcDecl) -> List[Tuple[str, A.Node]]:
        """Build (label, action body) list for one process."""
        locals_ = {n for n, _, _ in pr.locals}
        self._cur_locals = locals_
        actions: Dict[str, A.Node] = {}
        # collect label positions: walk statements building per-label stmt
        # suffixes (statements from the label to the end of the process,
        # through enclosing control structure)
        pending: List[Tuple[str, List]] = []
        first = self._first_label(pr)
        pending.append((first, pr.body))
        done_set = set()
        while pending:
            label, stmts = pending.pop()
            if label in done_set:
                continue
            done_set.add(label)
            # stmts[0] is Labeled(label, ...)
            assert isinstance(stmts[0], Labeled) and stmts[0].label == label
            flat = [stmts[0].stmt] + list(stmts[1:])
            paths = self._compile_seq(flat, "Done", pending, cur_label=label)
            body = self._paths_to_body(label, paths)
            actions[label] = body
        order = self._label_order(pr)
        return [(l, actions[l]) for l in order if l in actions]

    def _label_order(self, pr: ProcDecl) -> List[str]:
        out = []

        def scan(stmts):
            for s in stmts:
                if isinstance(s, Labeled):
                    out.append(s.label)
                    scan([s.stmt])
                elif isinstance(s, If):
                    scan(s.then)
                    scan(s.els)
                elif isinstance(s, While):
                    scan(s.body)
        scan(pr.body)
        return out

    def _prime_assigned(self, e: A.Node, assigned: frozenset) -> A.Node:
        """Rewrite reads of already-assigned variables to primed reads —
        PlusCal statements execute sequentially within a step, so
        `x := 1; y := x` reads the NEW x (p-manual semantics; pcal2tla
        performs the same rewriting)."""
        if not assigned:
            return e
        R = lambda x: self._prime_assigned(x, assigned)
        if isinstance(e, A.Ident):
            return A.Prime(e) if e.name in assigned else e
        if isinstance(e, (A.Num, A.Str, A.Bool)):
            return e
        if isinstance(e, A.OpApp):
            return A.OpApp(e.name, tuple(R(a) for a in e.args), e.path)
        if isinstance(e, A.FnApp):
            return A.FnApp(R(e.fn), tuple(R(a) for a in e.args))
        if isinstance(e, A.Dot):
            return A.Dot(R(e.expr), e.fld)
        if isinstance(e, A.TupleExpr):
            return A.TupleExpr(tuple(R(x) for x in e.items))
        if isinstance(e, A.SetEnum):
            return A.SetEnum(tuple(R(x) for x in e.items))
        if isinstance(e, A.If):
            return A.If(R(e.cond), R(e.then), R(e.els))
        if isinstance(e, A.SetFilter):
            return A.SetFilter(e.var, R(e.set), R(e.pred))
        if isinstance(e, A.SetMap):
            return A.SetMap(R(e.expr), tuple((n, R(s)) for n, s in e.binders))
        if isinstance(e, A.Quant):
            return A.Quant(e.kind,
                           tuple((n, R(s) if s else None)
                                 for n, s in e.binders), R(e.body))
        if isinstance(e, A.FnDef):
            return A.FnDef(tuple((n, R(s)) for n, s in e.binders), R(e.body))
        if isinstance(e, A.Except):
            return A.Except(R(e.fn), tuple(
                ((tuple(("idx", tuple(R(i) for i in arg)) if kk == "idx"
                        else (kk, arg) for kk, arg in path)), R(rhs))
                for path, rhs in e.updates))
        if isinstance(e, A.Choose):
            return A.Choose(e.var, R(e.set) if e.set else None, R(e.pred))
        if isinstance(e, A.Prime):
            return e
        return e

    def _compile_seq(self, stmts: List, k: str, pending,
                     cur_label: str = "",
                     assigned: frozenset = frozenset()) -> List[_Path]:
        """Compile a statement list into paths; k is the fall-through label;
        assigned tracks variables already assigned earlier in this step."""
        if not stmts:
            p = _Path()
            p.next_label = k
            return [p]
        s, rest = stmts[0], list(stmts[1:])
        if isinstance(s, Labeled):
            # current action ends here, jumping to s.label
            pending.append((s.label, stmts))
            p = _Path()
            p.next_label = s.label
            return [p]
        if isinstance(s, Assign):
            rw = self._prime_assigned(self._rw(s.expr, self._cur_locals),
                                      assigned)
            if s.var in self._cur_locals:
                base = A.Ident(s.var)
                if s.var in assigned:
                    raise PcalError(
                        f"two assignments to {s.var} in one step")
                rhs = A.Except(base, (((("idx", (A.Ident("self"),)),), rw),))
            else:
                if s.var in assigned:
                    raise PcalError(
                        f"two assignments to {s.var} in one step")
                rhs = rw
            tails = self._compile_seq(rest, k, pending, cur_label,
                                      assigned | {s.var})
            out = []
            for t in tails:
                np = _Path([("upd", s.var, rhs)] + list(t.items),
                           t.next_label)
                out.append(np)
            return out
        if isinstance(s, If):
            cond = self._prime_assigned(self._rw(s.cond, self._cur_locals),
                                        assigned)
            tpaths = self._compile_seq(list(s.then) + rest, k, pending,
                                       cur_label, assigned)
            epaths = self._compile_seq(list(s.els) + rest, k, pending,
                                       cur_label, assigned)
            for p in tpaths:
                p.items.insert(0, ("cond", cond))
            neg = A.OpApp("~", (cond,))
            for p in epaths:
                p.items.insert(0, ("cond", neg))
            return tpaths + epaths
        if isinstance(s, While):
            # L: while c do body end while; rest
            # ~~> IF c THEN body; goto L ELSE rest  (pcal requires a label
            # on every while, so cur_label is the loop head)
            if not cur_label:
                raise PcalError("while loop without an enclosing label")
            cond = self._prime_assigned(self._rw(s.cond, self._cur_locals),
                                        assigned)
            tpaths = self._compile_seq(list(s.body) + [Goto(cur_label)],
                                       k, pending, cur_label, assigned)
            epaths = self._compile_seq(rest, k, pending, cur_label, assigned)
            for p in tpaths:
                p.items.insert(0, ("cond", cond))
            neg = A.OpApp("~", (cond,))
            for p in epaths:
                p.items.insert(0, ("cond", neg))
            return tpaths + epaths
        if isinstance(s, Await):
            tails = self._compile_seq(rest, k, pending, cur_label, assigned)
            g = self._prime_assigned(self._rw(s.expr, self._cur_locals),
                                     assigned)
            for p in tails:
                p.items.insert(0, ("cond", g))
            return tails
        if isinstance(s, AssertStmt):
            g = self._prime_assigned(self._rw(s.expr, self._cur_locals),
                                     assigned)
            msg = (f"Failure of assertion at line {s.line + self.line_off}, "
                   f"column {s.col}.")
            call = A.OpApp("Assert", (g, A.Str(msg)))
            tails = self._compile_seq(rest, k, pending, cur_label, assigned)
            for p in tails:
                p.items.insert(0, ("cond", call))
            return tails
        if isinstance(s, Skip):
            return self._compile_seq(rest, k, pending, cur_label, assigned)
        if isinstance(s, Goto):
            p = _Path()
            p.next_label = s.label
            return [p]
        raise PcalError(f"unsupported statement {s!r}")

    def _paths_to_body(self, label: str, paths: List[_Path]) -> A.Node:
        assigned_any = set()
        for p in paths:
            assigned_any.update(p.assigned())
        arms = []
        for p in paths:
            conjs: List[A.Node] = []
            for it in p.items:
                if it[0] == "cond":
                    conjs.append(it[1])
                else:
                    _, var, rhs = it
                    conjs.append(_eq(A.Prime(A.Ident(var)), rhs))
            # vars assigned in other paths but not this one stay equal
            for var in sorted(assigned_any - p.assigned()):
                conjs.append(_eq(A.Prime(A.Ident(var)), A.Ident(var)))
            conjs.append(_pc_set(p.next_label))
            arms.append(_conj(conjs))
        body = _disj(arms)
        unchanged = [v for v in self.all_vars
                     if v != "pc" and v not in assigned_any]
        guard = _pc_is(label)
        parts: List[A.Node] = [guard, body]
        if unchanged:
            parts.append(A.Unchanged(A.TupleExpr(
                tuple(A.Ident(v) for v in unchanged))))
        return _conj(parts)


def _pc_is_done():
    return _eq(A.FnApp(A.Ident("pc"), (A.Ident("self"),)), A.Str("Done"))


def translate_module(src: str, module_ast: A.Module) -> A.Module:
    """Return module_ast with the PlusCal translation appended (the in-memory
    equivalent of pcal2tla's in-place insertion, Makefile:4)."""
    alg, line_off = parse_algorithm(src)
    tr = Translator(alg, line_off, module_ast.name)
    units = tr.translate()
    # declare the translation's variables
    var_names = tuple(tr.all_vars)
    new_units = (A.Variables(var_names),) + tuple(units) + module_ast.units
    return A.Module(module_ast.name, module_ast.extends, new_units)
