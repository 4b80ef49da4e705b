"""AST for the TLA+ subset used by the reference corpus.

Node inventory follows the grammar spec shipped inside the corpus
(tla-rust examples/SpecifyingSystems/Syntax/TLAPlusGrammar.tla, module
grammar from :70). Expressions are plain dataclasses; the evaluator and the
kernel compiler both walk these.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


class Node:
    __slots__ = ()


# ---------- expressions ----------

@dataclass(frozen=True)
class Num(Node):
    val: int


@dataclass(frozen=True)
class Str(Node):
    val: str


@dataclass(frozen=True)
class Bool(Node):
    val: bool


@dataclass(frozen=True)
class Ident(Node):
    name: str


@dataclass(frozen=True)
class OpApp(Node):
    """Operator application: user-defined, builtin prefix/infix/postfix (by
    lexeme, e.g. '+', '\\cup'), or instance path application A!B!Op(args).

    path holds instance qualifiers with their own arguments, e.g.
    Inner(mem, ctl, buf)!ISpec  ->  path=(('Inner', (mem, ctl, buf)),),
    name='ISpec'."""
    name: str
    args: Tuple[Node, ...] = ()
    path: Tuple[Tuple[str, Tuple[Node, ...]], ...] = ()


@dataclass(frozen=True)
class FnApp(Node):
    fn: Node
    args: Tuple[Node, ...]


@dataclass(frozen=True)
class Dot(Node):
    expr: Node
    fld: str


@dataclass(frozen=True)
class TupleExpr(Node):
    items: Tuple[Node, ...]


@dataclass(frozen=True)
class SetEnum(Node):
    items: Tuple[Node, ...]


@dataclass(frozen=True)
class SetFilter(Node):
    # {x \in S : P}; var is a name or a tuple-destructuring pattern
    # like <<from, to>> (textbookSnapshotIsolation.tla:411)
    var: Any  # str | Tuple[str, ...]
    set: Node
    pred: Node


@dataclass(frozen=True)
class SetMap(Node):
    # {e : x \in S, y \in T}
    expr: Node
    binders: Tuple[Tuple[Tuple[str, ...], Node], ...]  # ((names), set)


@dataclass(frozen=True)
class FnDef(Node):
    # [x \in S, y \in T |-> e]
    binders: Tuple[Tuple[Tuple[str, ...], Node], ...]
    body: Node


@dataclass(frozen=True)
class FnSet(Node):
    # [S -> T]
    dom: Node
    rng: Node


@dataclass(frozen=True)
class RecordExpr(Node):
    fields: Tuple[Tuple[str, Node], ...]


@dataclass(frozen=True)
class RecordSet(Node):
    fields: Tuple[Tuple[str, Node], ...]


@dataclass(frozen=True)
class Except(Node):
    """[f EXCEPT ![i][j].fld = e, ...].  Each update: (path, rhs) where path
    items are ('idx', (exprs,)) or ('dot', name); rhs may contain At (@)."""
    fn: Node
    updates: Tuple[Tuple[Tuple, Node], ...]


@dataclass(frozen=True)
class At(Node):
    pass


@dataclass(frozen=True)
class If(Node):
    cond: Node
    then: Node
    els: Node


@dataclass(frozen=True)
class Case(Node):
    arms: Tuple[Tuple[Node, Node], ...]
    other: Optional[Node]


@dataclass(frozen=True)
class Let(Node):
    defs: Tuple[Any, ...]  # OpDef / FnConstrDef units
    body: Node


@dataclass(frozen=True)
class Quant(Node):
    kind: str  # 'A' | 'E'
    binders: Tuple[Tuple[Tuple[str, ...], Optional[Node]], ...]
    body: Node


@dataclass(frozen=True)
class TemporalQuant(Node):
    kind: str  # 'AA' | 'EE'  (\AA / \EE variable hiding)
    vars: Tuple[str, ...]
    body: Node


@dataclass(frozen=True)
class Choose(Node):
    var: Any  # str | Tuple[str, ...] destructuring pattern
    set: Optional[Node]
    pred: Node


@dataclass(frozen=True)
class Prime(Node):
    expr: Node


@dataclass(frozen=True)
class BoxAction(Node):
    # [A]_v
    action: Node
    sub: Node


@dataclass(frozen=True)
class AngleAction(Node):
    # <<A>>_v
    action: Node
    sub: Node


@dataclass(frozen=True)
class Fair(Node):
    kind: str  # 'WF' | 'SF'
    sub: Node
    action: Node


@dataclass(frozen=True)
class Unchanged(Node):
    expr: Node


@dataclass(frozen=True)
class Enabled(Node):
    expr: Node


@dataclass(frozen=True)
class Lambda(Node):
    params: Tuple[str, ...]
    body: Node


# ---------- module-level units ----------

@dataclass(frozen=True)
class Constants(Node):
    # (name, arity) — arity > 0 for operator constants like Send(_,_,_,_)
    names: Tuple[Tuple[str, int], ...]


@dataclass(frozen=True)
class Variables(Node):
    names: Tuple[str, ...]


@dataclass(frozen=True)
class OpDef(Node):
    name: str
    params: Tuple[str, ...]
    body: Node
    local: bool = False


@dataclass(frozen=True)
class FnConstrDef(Node):
    # f[x \in S] == e   (possibly recursive function constructor)
    name: str
    binders: Tuple[Tuple[Tuple[str, ...], Node], ...]
    body: Node
    local: bool = False


@dataclass(frozen=True)
class InstanceDef(Node):
    # name(params) == INSTANCE mod WITH a <- e, ...; name None for bare INSTANCE
    name: Optional[str]
    params: Tuple[str, ...]
    module: str
    substs: Tuple[Tuple[str, Node], ...]
    local: bool = False


@dataclass(frozen=True)
class Assume(Node):
    name: Optional[str]
    expr: Node


@dataclass(frozen=True)
class Theorem(Node):
    name: Optional[str]
    expr: Node


@dataclass(frozen=True)
class RecursiveDecl(Node):
    names: Tuple[Tuple[str, int], ...]


@dataclass(frozen=True)
class Module(Node):
    name: str
    extends: Tuple[str, ...]
    units: Tuple[Node, ...] = field(default_factory=tuple)

    def defs(self):
        for u in self.units:
            if isinstance(u, (OpDef, FnConstrDef)):
                yield u
