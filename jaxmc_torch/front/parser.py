"""TLA+ parser (Pratt / precedence-climbing, with junction lists).

Covers the subset exercised by the reference corpus: full expression grammar
including indentation-sensitive /\\ and \\/ junction lists, LET/IN, EXCEPT,
CASE, quantifiers, CHOOSE, records, functions, tuples, temporal operators
([]/<>/~>, [A]_v, <<A>>_v, WF_/SF_), instance paths (V!Spec), and module units
(EXTENDS, CONSTANTS, VARIABLES, definitions, INSTANCE ... WITH, ASSUME,
THEOREM, RECURSIVE, nested modules).

Grammar reference: the corpus's own BNF at
tla-rust examples/SpecifyingSystems/Syntax/TLAPlusGrammar.tla (module
grammar from :70); junction-list semantics per the *Specifying Systems* book.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .lexer import Token, tokenize
from . import tla_ast as A


class ParseError(Exception):
    def __init__(self, msg: str, tok: Optional[Token] = None):
        if tok is not None:
            msg = f"{msg} (at {tok.line}:{tok.col}, near {tok.text!r})"
        super().__init__(msg)


# infix operator -> (precedence, right_assoc)
INFIX = {
    "=>": (1, False),
    "<=>": (2, False), "\\equiv": (2, False),
    "~>": (2, False), "-+->": (2, False),
    "\\/": (3, False),
    "/\\": (3, False),
    "=": (5, False), "/=": (5, False), "#": (5, False),
    "<": (5, False), ">": (5, False), "<=": (5, False), "=<": (5, False),
    ">=": (5, False), "\\leq": (5, False), "\\geq": (5, False),
    "\\in": (5, False), "\\notin": (5, False),
    "\\subseteq": (5, False), "\\subset": (5, False),
    "\\supseteq": (5, False), "\\supset": (5, False),
    "\\prec": (5, False), "\\succ": (5, False),
    "\\sqsubseteq": (5, False), "\\sqsupseteq": (5, False),
    "@@": (6, False),
    ":>": (7, False),
    "\\cup": (8, False), "\\union": (8, False),
    "\\cap": (8, False), "\\intersect": (8, False),
    "\\": (8, False),
    "..": (9, False),
    "+": (10, False), "-": (10, False),
    "(+)": (10, False), "(-)": (10, False),
    "%": (10, False), "\\mod": (10, False),
    "*": (13, False), "/": (13, False), "\\div": (13, False),
    "\\o": (13, False), "\\circ": (13, False),
    "\\X": (13, False), "\\times": (13, False),
    "^": (14, True),
    # user-definable grammar-combinator ops (BNFGrammars.tla:5-27)
    "&": (13, False), "|": (10, False), "::=": (2, False),
}

POSTFIX_OPS = {"^*", "^+", "^#"}

PREFIX = {
    "~": 4, "\\lnot": 4, "\\neg": 4,
    "[]": 4, "<>": 4,
    "-": 12,
}

_STOP_KINDS = {"eof", "end4", "sep4", "prooflabel"}
# tokens that always terminate an expression
_STOP_OPS = {")", "]", "}", ">>", ",", ":", ";", "|->", "->", "<-", "]_", ">>_",
             ":=", "||", "@"}
_STOP_RESERVED = {"THEN", "ELSE", "IN", "OTHER", "EXCEPT", "WITH", "MODULE",
                  "EXTENDS", "CONSTANT", "CONSTANTS", "VARIABLE", "VARIABLES",
                  "ASSUME", "ASSUMPTION", "AXIOM", "THEOREM", "LEMMA",
                  "INSTANCE", "LOCAL", "RECURSIVE", "BY", "PROOF", "OBVIOUS",
                  "OMITTED", "QED"}


class Parser:
    def __init__(self, toks: List[Token]):
        self.toks = toks
        self.i = 0
        self.fences: List[int] = []  # junction-list columns

    # ---- token helpers ----
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def peek(self, k: int = 1) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_op(self, *texts) -> bool:
        return self.cur.kind == "op" and self.cur.text in texts

    def at_res(self, *texts) -> bool:
        return self.cur.kind == "reserved" and self.cur.text in texts

    def expect_op(self, text) -> Token:
        if not self.at_op(text):
            raise ParseError(f"expected {text!r}", self.cur)
        return self.next()

    def expect_res(self, text) -> Token:
        if not self.at_res(text):
            raise ParseError(f"expected {text!r}", self.cur)
        return self.next()

    def expect_ident(self) -> str:
        if self.cur.kind != "ident":
            raise ParseError("expected identifier", self.cur)
        return self.next().text

    def _fenced(self) -> bool:
        """True if the current token lies at/left of the innermost junction
        bullet column — it then belongs to an enclosing construct."""
        return bool(self.fences) and self.cur.col <= self.fences[-1]

    def _expr_ended(self) -> bool:
        t = self.cur
        if t.kind in _STOP_KINDS:
            return True
        if self._fenced():
            return True
        if t.kind == "op" and t.text in _STOP_OPS:
            return True
        if t.kind == "reserved" and t.text in _STOP_RESERVED:
            return True
        # a new top-level definition: Ident == ... / Ident(params) == ...
        return False

    # ---- expressions ----
    def parse_expr(self, min_prec: int = 0) -> A.Node:
        lhs = self.parse_prefix()
        return self.parse_infix_loop(lhs, min_prec)

    def parse_infix_loop(self, lhs: A.Node, min_prec: int) -> A.Node:
        # /\ and \/ may not be mixed without parentheses (SANY rejects the
        # mix as a precedence conflict; parsing it silently would check the
        # wrong formula)
        junction_seen = None
        while True:
            if self._expr_ended():
                return lhs
            t = self.cur
            # postfix prime
            if t.kind == "op" and t.text == "'":
                self.next()
                lhs = A.Prime(lhs)
                continue
            if t.kind == "op" and t.text in POSTFIX_OPS:
                self.next()
                lhs = A.OpApp(t.text, (lhs,))
                continue
            # function application f[x, y]  (prec 16, tighter than all infix)
            if t.kind == "op" and t.text == "[":
                self.next()
                args = [self.parse_expr()]
                while self.at_op(","):
                    self.next()
                    args.append(self.parse_expr())
                self.expect_op("]")
                lhs = A.FnApp(lhs, tuple(args))
                continue
            # record access  (prec 17)
            if t.kind == "op" and t.text == ".":
                self.next()
                fld = self.expect_ident()
                lhs = A.Dot(lhs, fld)
                continue
            if t.kind != "op" or t.text not in INFIX:
                return lhs
            prec, right = INFIX[t.text]
            if prec < min_prec:
                return lhs
            op = t.text
            if op in ("/\\", "\\/"):
                if junction_seen is not None and junction_seen != op:
                    raise ParseError(
                        "/\\ and \\/ mixed without parentheses", t)
                junction_seen = op
            self.next()
            # n-ary cartesian product: a \X b \X c is the set of triples
            if op in ("\\X", "\\times"):
                items = [lhs, self.parse_expr(prec + 1)]
                while self.at_op("\\X", "\\times") and not self._expr_ended():
                    self.next()
                    items.append(self.parse_expr(prec + 1))
                lhs = A.OpApp("\\X", tuple(items))
                continue
            rhs = self.parse_expr(prec if right else prec + 1)
            lhs = A.OpApp(op, (lhs, rhs))

    def _parse_junction(self, op: str) -> A.Node:
        col = self.cur.col
        items = []
        while self.at_op(op) and self.cur.col == col:
            self.next()
            self.fences.append(col)
            try:
                items.append(self.parse_expr())
            finally:
                self.fences.pop()
        node = items[0]
        for it in items[1:]:
            node = A.OpApp(op, (node, it))
        return node

    def _try_parse_pattern(self):
        """Parse a tuple-destructuring pattern <<a, b>>; None if not one."""
        if not self.at_op("<<") or self.peek().kind != "ident":
            return None
        save = self.i
        self.next()
        names = [self.expect_ident()]
        while self.at_op(","):
            self.next()
            if self.cur.kind != "ident":
                self.i = save
                return None
            names.append(self.next().text)
        if not self.at_op(">>"):
            self.i = save
            return None
        self.next()
        return tuple(names)

    def _parse_binders(self, require_set=True):
        """Parse  x, y \\in S, z \\in T  (or untyped x, y when allowed).
        A name may be a tuple pattern <<a, b>> (destructured per element)."""
        binders = []
        while True:
            pat = self._try_parse_pattern()
            names = [pat if pat is not None else self.expect_ident()]
            while self.at_op(","):
                # lookahead: Ident (',' | '\in')
                save = self.i
                self.next()
                nm = self.expect_ident()
                names.append(nm)
                if self.at_op(",") or self.at_op("\\in"):
                    continue
                # it was the start of the next binder group? restore
                self.i = save
                names.pop()
                break
            if self.at_op("\\in"):
                self.next()
                s = self.parse_expr(6)  # bind tighter than \in level
                binders.append((tuple(names), s))
            else:
                if require_set:
                    raise ParseError("expected \\in in binder", self.cur)
                binders.append((tuple(names), None))
            if self.at_op(","):
                self.next()
                continue
            return tuple(binders)

    def parse_prefix(self) -> A.Node:
        t = self.cur
        if t.kind in _STOP_KINDS:
            raise ParseError("unexpected end of input", t)

        # junction lists
        if t.kind == "op" and t.text in ("/\\", "\\/"):
            return self._parse_junction(t.text)

        if t.kind == "number":
            self.next()
            return A.Num(int(t.text))
        if t.kind == "string":
            self.next()
            return A.Str(t.text)

        if t.kind == "reserved":
            w = t.text
            if w == "TRUE":
                self.next()
                return A.Bool(True)
            if w == "FALSE":
                self.next()
                return A.Bool(False)
            if w == "BOOLEAN":
                self.next()
                return A.Ident("BOOLEAN")
            if w == "STRING":
                self.next()
                return A.Ident("STRING")
            if w == "IF":
                self.next()
                c = self.parse_expr()
                self.expect_res("THEN")
                th = self.parse_expr()
                self.expect_res("ELSE")
                el = self.parse_expr()
                return A.If(c, th, el)
            if w == "CASE":
                self.next()
                arms = []
                other = None
                while True:
                    if self.at_res("OTHER"):
                        self.next()
                        self.expect_op("->")
                        other = self.parse_expr()
                    else:
                        g = self.parse_expr()
                        self.expect_op("->")
                        e = self.parse_expr()
                        arms.append((g, e))
                    if self.at_op("[]"):
                        self.next()
                        continue
                    break
                return A.Case(tuple(arms), other)
            if w == "LET":
                self.next()
                defs = []
                while True:
                    if self.at_res("RECURSIVE"):
                        self.next()
                        names = [(self.expect_ident(), self._parse_arity())]
                        while self.at_op(","):
                            self.next()
                            names.append((self.expect_ident(), self._parse_arity()))
                        defs.append(A.RecursiveDecl(tuple(names)))
                    else:
                        defs.append(self.parse_definition(local=False))
                    if self.at_res("IN"):
                        break
                self.expect_res("IN")
                body = self.parse_expr()
                return A.Let(tuple(defs), body)
            if w == "CHOOSE":
                self.next()
                var = self._try_parse_pattern()
                if var is None:
                    var = self.expect_ident()
                s = None
                if self.at_op("\\in"):
                    self.next()
                    s = self.parse_expr(6)
                self.expect_op(":")
                pred = self.parse_expr()
                return A.Choose(var, s, pred)
            if w == "ENABLED":
                self.next()
                return A.Enabled(self.parse_expr(4))
            if w == "UNCHANGED":
                self.next()
                return A.Unchanged(self.parse_expr(15))
            if w == "SUBSET":
                self.next()
                return A.OpApp("SUBSET", (self.parse_expr(8),))
            if w == "UNION":
                self.next()
                return A.OpApp("UNION", (self.parse_expr(8),))
            if w == "DOMAIN":
                self.next()
                return A.OpApp("DOMAIN", (self.parse_expr(9),))
            if w in ("WF_", "SF_"):
                self.next()
                sub = self.parse_subscript()
                self.expect_op("(")
                act = self.parse_expr()
                self.expect_op(")")
                return A.Fair(w[:2], sub, act)
            if w == "LAMBDA":
                self.next()
                params = [self.expect_ident()]
                while self.at_op(","):
                    self.next()
                    params.append(self.expect_ident())
                self.expect_op(":")
                body = self.parse_expr()
                return A.Lambda(tuple(params), body)
            raise ParseError(f"unexpected keyword {w}", t)

        if t.kind == "op":
            op = t.text
            if op in ("\\A", "\\E"):
                self.next()
                binders = self._parse_binders(require_set=False)
                self.expect_op(":")
                body = self.parse_expr()
                return A.Quant(op[1], binders, body)
            if op in ("\\AA", "\\EE"):
                self.next()
                names = [self.expect_ident()]
                while self.at_op(","):
                    self.next()
                    names.append(self.expect_ident())
                self.expect_op(":")
                body = self.parse_expr()
                return A.TemporalQuant(op[1:], tuple(names), body)
            if op == "(":
                self.next()
                saved, self.fences = self.fences, []
                try:
                    e = self.parse_expr()
                finally:
                    self.fences = saved
                self.expect_op(")")
                return e
            if op == "{":
                return self.parse_braces()
            if op == "[":
                return self.parse_brackets()
            if op == "<<":
                self.next()
                items = []
                saved, self.fences = self.fences, []
                try:
                    if not self.at_op(">>") and not self.at_op(">>_"):
                        items.append(self.parse_expr())
                        while self.at_op(","):
                            self.next()
                            items.append(self.parse_expr())
                finally:
                    self.fences = saved
                if self.at_op(">>_"):
                    # <<A>>_v  angle action
                    self.next()
                    if len(items) != 1:
                        raise ParseError("<<A>>_v with multiple exprs", t)
                    sub = self.parse_subscript()
                    return A.AngleAction(items[0], sub)
                self.expect_op(">>")
                return A.TupleExpr(tuple(items))
            if op == "@":
                self.next()
                return A.At()
            if op in PREFIX:
                self.next()
                if op == "[]":
                    # [] [A]_v or []P
                    arg = self.parse_expr(PREFIX[op])
                    return A.OpApp("[]", (arg,))
                if op == "<>":
                    arg = self.parse_expr(PREFIX[op])
                    return A.OpApp("<>", (arg,))
                arg = self.parse_expr(PREFIX[op])
                if op == "-":
                    return A.OpApp("-.", (arg,))
                return A.OpApp("~", (arg,)) if op in ("~", "\\lnot", "\\neg") else A.OpApp(op, (arg,))

        if t.kind == "ident":
            return self.parse_general_ident_tight()

        raise ParseError("unexpected token", t)

    def parse_subscript(self) -> A.Node:
        """Subscript of WF_/SF_/[A]_/<<A>>_: either a simple name, a tuple
        <<a, b>>, or a parenthesized expression.  A bare name is NOT treated
        as an operator application — in WF_vars(A) the parens belong to WF."""
        if self.cur.kind == "ident":
            return A.Ident(self.next().text)
        if self.at_op("<<"):
            self.next()
            items = [self.parse_expr()]
            while self.at_op(","):
                self.next()
                items.append(self.parse_expr())
            self.expect_op(">>")
            return A.TupleExpr(tuple(items))
        if self.at_op("("):
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        raise ParseError("expected fairness/action subscript", self.cur)

    def _parse_call_args(self) -> Tuple[A.Node, ...]:
        if not self.at_op("("):
            return ()
        self.next()
        saved, self.fences = self.fences, []
        try:
            lst = [self.parse_expr()]
            while self.at_op(","):
                self.next()
                lst.append(self.parse_expr())
            self.expect_op(")")
        finally:
            self.fences = saved
        return tuple(lst)

    def parse_general_ident_tight(self) -> A.Node:
        """An identifier with optional arguments and !-instance path segments
        (each segment may itself take arguments: Inner(mem)!Spec)."""
        name = self.expect_ident()
        args = self._parse_call_args()
        path = []
        while self.at_op("!"):
            nxt = self.peek()
            if nxt.kind == "op" and nxt.text == ":":
                # TLAPS-style assumption citation 'Name!:' — plain reference
                self.next()
                self.next()
                break
            if nxt.kind != "ident":
                break
            self.next()
            path.append((name, args))
            name = self.expect_ident()
            args = self._parse_call_args()
        node: A.Node
        if path or args:
            node = A.OpApp(name, args, tuple(path))
        else:
            node = A.Ident(name)
        # conjunct selection: Inv!2 picks the 2nd conjunct of Inv's definition
        # (used by MCPaxos.tla:41-43)
        while self.at_op("!") and self.peek().kind == "number":
            self.next()
            node = A.OpApp("!sel", (node, A.Num(int(self.next().text))))
        return node

    def parse_braces(self) -> A.Node:
        self.expect_op("{")
        saved, self.fences = self.fences, []
        try:
            if self.at_op("}"):
                self.next()
                return A.SetEnum(())
            # Try {x \in S : P} / {<<a, b>> \in S : P} filter forms
            save = self.i
            pat = self._try_parse_pattern()
            var = None
            if pat is not None:
                var = pat
            elif self.cur.kind == "ident" and self.peek().kind == "op" \
                    and self.peek().text == "\\in":
                var = self.expect_ident()
            if var is not None and self.at_op("\\in"):
                self.next()  # \in
                s = self.parse_expr(6)
                if self.at_op(":"):
                    self.next()
                    pred = self.parse_expr()
                    self.expect_op("}")
                    return A.SetFilter(var, s, pred)
            self.i = save
            first = self.parse_expr()
            if self.at_op(":"):
                # {e : x \in S, ...} map form
                self.next()
                binders = self._parse_binders()
                self.expect_op("}")
                return A.SetMap(first, binders)
            items = [first]
            while self.at_op(","):
                self.next()
                items.append(self.parse_expr())
            self.expect_op("}")
            return A.SetEnum(tuple(items))
        finally:
            self.fences = saved

    def parse_brackets(self) -> A.Node:
        """All '['-introduced forms: [x \\in S |-> e], [S -> T], [a |-> e],
        [a : S], [f EXCEPT ...], [A]_v."""
        self.expect_op("[")
        saved, self.fences = self.fences, []
        try:
            # record forms: Ident (|-> / :)
            if self.cur.kind == "ident" and self.peek().kind == "op" and \
                    self.peek().text in ("|->", ":") :
                if self.peek().text == "|->":
                    fields = []
                    while True:
                        nm = self.expect_ident()
                        self.expect_op("|->")
                        fields.append((nm, self.parse_expr()))
                        if self.at_op(","):
                            self.next()
                            continue
                        break
                    self.expect_op("]")
                    return A.RecordExpr(tuple(fields))
                else:
                    fields = []
                    while True:
                        nm = self.expect_ident()
                        self.expect_op(":")
                        fields.append((nm, self.parse_expr()))
                        if self.at_op(","):
                            self.next()
                            continue
                        break
                    self.expect_op("]")
                    return A.RecordSet(tuple(fields))
            # function constructor [x \in S, ... |-> e]  (names or <<a,b>> patterns)
            if self.cur.kind == "ident" or self.at_op("<<"):
                save = self.i
                try:
                    binders = self._parse_binders()
                    if self.at_op("|->"):
                        self.next()
                        body = self.parse_expr()
                        self.expect_op("]")
                        return A.FnDef(binders, body)
                except ParseError:
                    pass
                self.i = save
            first = self.parse_expr()
            if self.at_op("->"):
                self.next()
                rng = self.parse_expr()
                self.expect_op("]")
                return A.FnSet(first, rng)
            if self.at_res("EXCEPT"):
                self.next()
                updates = []
                while True:
                    self.expect_op("!")
                    path = []
                    while True:
                        if self.at_op("["):
                            self.next()
                            idx = [self.parse_expr()]
                            while self.at_op(","):
                                self.next()
                                idx.append(self.parse_expr())
                            self.expect_op("]")
                            path.append(("idx", tuple(idx)))
                        elif self.at_op("."):
                            self.next()
                            path.append(("dot", self.expect_ident()))
                        else:
                            break
                    self.expect_op("=")
                    rhs = self.parse_expr()
                    updates.append((tuple(path), rhs))
                    if self.at_op(","):
                        self.next()
                        continue
                    break
                self.expect_op("]")
                return A.Except(first, tuple(updates))
            if self.at_op("]_"):
                self.next()
                self.fences = saved  # subscript is outside the brackets
                sub = self.parse_subscript()
                return A.BoxAction(first, sub)
            self.expect_op("]")
            raise ParseError("unrecognized [...] form", self.cur)
        finally:
            self.fences = saved

    # ---- module units ----
    # infix lexemes a user module may (re)define: a (+) b == ..., d :> e == ...
    _DEFINABLE_INFIX = set(INFIX) - {"=", "=>", "\\in"}

    def parse_definition(self, local: bool) -> A.Node:
        """Parse one definition: Op == e, Op(p, q) == e, f[x \\in S] == e,
        infix  a OP b == e,  prefix  -. a == e,  postfix  a ^* == e."""
        # prefix operator definition
        if self.at_op("-.") and self.peek().kind == "ident":
            self.next()
            p = self.expect_ident()
            self.expect_op("==")
            return A.OpDef("-.", (p,), self.parse_expr(), local)
        name = self.expect_ident()
        # infix operator definition
        if self.cur.kind == "op" and self.cur.text in self._DEFINABLE_INFIX \
                and self.peek().kind == "ident" \
                and self.peek(2).kind == "op" and self.peek(2).text == "==":
            op = self.next().text
            rhsname = self.expect_ident()
            self.expect_op("==")
            return A.OpDef(op, (name, rhsname), self.parse_expr(), local)
        # postfix operator definition
        if self.cur.kind == "op" and self.cur.text in POSTFIX_OPS \
                and self.peek().kind == "op" and self.peek().text == "==":
            op = self.next().text
            self.expect_op("==")
            return A.OpDef(op, (name,), self.parse_expr(), local)
        params: List[str] = []
        if self.at_op("("):
            self.next()
            params.append(self._param_name())
            while self.at_op(","):
                self.next()
                params.append(self._param_name())
            self.expect_op(")")
            self.expect_op("==")
            body = self._parse_def_body(name, tuple(params), local)
            return body
        if self.at_op("["):
            self.next()
            binders = self._parse_binders()
            self.expect_op("]")
            self.expect_op("==")
            body = self.parse_expr()
            return A.FnConstrDef(name, binders, body, local)
        self.expect_op("==")
        return self._parse_def_body(name, (), local)

    def _param_name(self) -> str:
        # ordinary name or operator-parameter decl like  Op(_, _)  /  _ (+) _
        if self.cur.kind == "ident":
            nm = self.next().text
            if self.at_op("("):
                # higher-order param  P(_, _): record arity in name only
                self.next()
                while self.at_op("_", ","):
                    self.next()
                self.expect_op(")")
            return nm
        if self.at_op("_"):
            raise ParseError("infix operator definitions not supported", self.cur)
        raise ParseError("expected parameter name", self.cur)

    def _parse_def_body(self, name, params, local) -> A.Node:
        if self.at_res("INSTANCE"):
            self.next()
            mod = self.expect_ident()
            substs = self._parse_with()
            return A.InstanceDef(name, params, mod, substs, local)
        body = self.parse_expr()
        return A.OpDef(name, params, body, local)

    def _parse_with(self):
        substs = []
        if self.at_res("WITH"):
            self.next()
            while True:
                nm = self.expect_ident()
                self.expect_op("<-")
                substs.append((nm, self.parse_expr()))
                if self.at_op(","):
                    self.next()
                    continue
                break
        return tuple(substs)

    def _at_definition_start(self) -> bool:
        if self.at_op("-.") and self.peek().kind == "ident" \
                and self.peek(2).kind == "op" and self.peek(2).text == "==":
            return True
        if self.cur.kind != "ident":
            return False
        t1 = self.peek()
        if t1.kind == "op" and t1.text == "==":
            return True
        if t1.kind == "op" and t1.text in self._DEFINABLE_INFIX \
                and self.peek(2).kind == "ident" \
                and self.peek(3).kind == "op" and self.peek(3).text == "==":
            return True
        if t1.kind == "op" and t1.text in POSTFIX_OPS \
                and self.peek(2).kind == "op" and self.peek(2).text == "==":
            return True
        if t1.kind == "op" and t1.text in ("(", "["):
            # scan ahead for matching close then '=='
            depth = 0
            j = self.i + 1
            while j < len(self.toks) - 1:
                tt = self.toks[j]
                if tt.kind == "op" and tt.text in ("(", "[", "{"):
                    depth += 1
                elif tt.kind == "op" and tt.text in (")", "]", "}"):
                    depth -= 1
                    if depth == 0:
                        nx = self.toks[j + 1]
                        return nx.kind == "op" and nx.text == "=="
                elif depth == 0:
                    return False
                j += 1
        return False

    def parse_module(self) -> A.Module:
        # ---- MODULE name ----
        while not (self.cur.kind == "sep4" and self.peek().kind == "reserved"
                   and self.peek().text == "MODULE"):
            if self.cur.kind == "eof":
                raise ParseError("no module header found", self.cur)
            self.next()
        self.next()  # sep4
        self.expect_res("MODULE")
        name = self.expect_ident()
        if self.cur.kind == "sep4":
            self.next()
        extends: List[str] = []
        units: List[A.Node] = []
        if self.at_res("EXTENDS"):
            self.next()
            extends.append(self.expect_ident())
            while self.at_op(","):
                self.next()
                extends.append(self.expect_ident())
        while True:
            t = self.cur
            if t.kind == "eof":
                break
            if t.kind == "end4":
                self.next()
                break
            if t.kind == "sep4":
                if self.peek().kind == "reserved" and self.peek().text == "MODULE":
                    units.append(self.parse_module())
                    continue
                self.next()
                continue
            if t.kind == "reserved":
                w = t.text
                if w in ("CONSTANT", "CONSTANTS"):
                    self.next()
                    names = []
                    while True:
                        nm = self.expect_ident()
                        names.append((nm, self._parse_arity()))
                        if self.at_op(","):
                            self.next()
                            continue
                        break
                    units.append(A.Constants(tuple(names)))
                    continue
                if w in ("VARIABLE", "VARIABLES"):
                    self.next()
                    names = [self.expect_ident()]
                    while self.at_op(","):
                        self.next()
                        names.append(self.expect_ident())
                    units.append(A.Variables(tuple(names)))
                    continue
                if w in ("ASSUME", "ASSUMPTION", "AXIOM"):
                    self.next()
                    nm = None
                    if self._at_definition_start():
                        nm = self.expect_ident()
                        self.expect_op("==")
                    units.append(A.Assume(nm, self.parse_expr()))
                    continue
                if w in ("THEOREM", "LEMMA", "COROLLARY"):
                    self.next()
                    nm = None
                    if self._at_definition_start():
                        nm = self.expect_ident()
                        self.expect_op("==")
                    units.append(A.Theorem(nm, self.parse_expr()))
                    self._skip_proof()
                    continue
                if w == "LOCAL":
                    self.next()
                    if self.at_res("INSTANCE"):
                        self.next()
                        mod = self.expect_ident()
                        units.append(A.InstanceDef(None, (), mod, self._parse_with(), True))
                    else:
                        d = self.parse_definition(local=True)
                        units.append(d)
                    continue
                if w == "INSTANCE":
                    self.next()
                    mod = self.expect_ident()
                    units.append(A.InstanceDef(None, (), mod, self._parse_with(), False))
                    continue
                if w == "RECURSIVE":
                    self.next()
                    names = []
                    while True:
                        nm = self.expect_ident()
                        names.append((nm, self._parse_arity()))
                        if self.at_op(","):
                            self.next()
                            continue
                        break
                    units.append(A.RecursiveDecl(tuple(names)))
                    continue
                raise ParseError(f"unexpected {w} at module level", t)
            if self._at_definition_start():
                units.append(self.parse_definition(local=False))
                continue
            raise ParseError("unexpected token at module level", t)
        return A.Module(name, tuple(extends), tuple(units))

    def _parse_arity(self) -> int:
        """Parse the (_, _, ...) suffix of an operator declaration."""
        if not self.at_op("("):
            return 0
        self.next()
        arity = 0
        while not self.at_op(")"):
            if self.at_op("_"):
                self.next()
                arity += 1
            elif self.at_op(","):
                self.next()
            else:
                raise ParseError("expected _ in operator arity decl", self.cur)
        self.next()
        return arity

    _PROOF_WORDS = {"PROOF", "BY", "OBVIOUS", "OMITTED", "QED"}
    _UNIT_WORDS = {"CONSTANT", "CONSTANTS", "VARIABLE", "VARIABLES", "ASSUME",
                   "ASSUMPTION", "AXIOM", "THEOREM", "LEMMA", "COROLLARY",
                   "INSTANCE", "LOCAL", "RECURSIVE"}

    def _skip_proof(self):
        """Skip a structured proof body (step labels <1>1., BY/QED leaves)
        following a THEOREM, up to the next module-level unit."""
        if not (self.cur.kind == "prooflabel" or self.at_res(*self._PROOF_WORDS)):
            return
        while True:
            t = self.cur
            if t.kind in ("eof", "end4", "sep4"):
                return
            if t.kind == "prooflabel":
                self.next()
                continue
            if t.kind == "reserved":
                if t.text in self._PROOF_WORDS:
                    self.next()
                    continue
                if t.text in self._UNIT_WORDS:
                    return
                self.next()
                continue
            if self._at_definition_start():
                return
            self.next()


def parse_module_text(src: str) -> A.Module:
    return Parser(tokenize(src)).parse_module()


def parse_expr_text(src: str) -> A.Node:
    p = Parser(tokenize(src))
    e = p.parse_expr()
    if p.cur.kind != "eof":
        raise ParseError("trailing input after expression", p.cur)
    return e
