r"""TLA+ lexer.

Tokenizes the TLA+ subset used by the reference corpus (grammar reference:
tla-rust examples/SpecifyingSystems/Syntax/TLAPlusGrammar.tla — lexemes
at :17-37, reserved words at :7-15). Emits (kind, text, line, col) tokens; line
and col are 1-based. Column information is load-bearing: the parser uses it for
TLA+'s indentation-sensitive /\ and \/ junction lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


class LexError(Exception):
    def __init__(self, msg: str, line: int, col: int):
        super().__init__(f"{msg} at {line}:{col}")
        self.line = line
        self.col = col


@dataclass(frozen=True)
class Token:
    kind: str  # 'ident' | 'number' | 'string' | 'op' | 'reserved' | 'sep4' | 'end4' | 'eof'
    text: str
    line: int
    col: int

    def __repr__(self):
        return f"Token({self.kind},{self.text!r},{self.line}:{self.col})"


RESERVED = {
    "MODULE", "EXTENDS", "CONSTANT", "CONSTANTS", "VARIABLE", "VARIABLES",
    "ASSUME", "ASSUMPTION", "AXIOM", "THEOREM", "LEMMA", "COROLLARY",
    "INSTANCE", "LOCAL", "LET", "IN", "IF", "THEN", "ELSE", "CASE", "OTHER",
    "CHOOSE", "ENABLED", "UNCHANGED", "SUBSET", "UNION", "DOMAIN", "EXCEPT",
    "WITH", "RECURSIVE", "LAMBDA", "TRUE", "FALSE", "BOOLEAN", "STRING",
    "SF_", "WF_", "PROOF", "BY", "OBVIOUS", "OMITTED", "QED",
}

# Multi-char operator lexemes, longest-first so greedy matching works.
_SYMBOLS = [
    "<=>", "|->", "-+->", "...", "::=",
    "==", "=>", "=<", "<=", ">=", "/=", "#", "..", "<<", ">>_", ">>",
    "/\\", "\\/", "@@", ":>", ":=", "||", "->", "<-", "~>", "[]", "<>",
    "]_", "(+)", "(-)", "(.)", "(/)", "(\\X)", "^*", "^+", "^#", "-.",
    "^^", "##", "%%", "&&", "$$",
    "??", "!!", "++", "--", "**", "//", "^", "%", "&", "|", "$",
    "=", "<", ">", "+", "-", "*", "/", "(", ")", "[", "]", "{", "}",
    ",", ":", ";", ".", "!", "@", "'", "~", "_",
]

def _is_ident_char(c: str) -> bool:
    return c.isalnum() or c == "_"


def tokenize(src: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(src)
    line, col = 1, 1

    def adv(k: int = 1):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n\f":
            adv()
            continue
        # line comment
        if src.startswith("\\*", i):
            while i < n and src[i] != "\n":
                adv()
            continue
        # block comment, nested
        if src.startswith("(*", i):
            l0, c0 = line, col
            depth = 1
            adv(2)
            while i < n and depth:
                if src.startswith("(*", i):
                    depth += 1
                    adv(2)
                elif src.startswith("*)", i):
                    depth -= 1
                    adv(2)
                else:
                    adv()
            if depth:
                raise LexError("unterminated block comment", l0, c0)
            continue
        # ---- separators and ==== module end (4 or more)
        if c == "-" and src.startswith("----", i):
            l0, c0 = line, col
            j = i
            while j < n and src[j] == "-":
                j += 1
            adv(j - i)
            toks.append(Token("sep4", "----", l0, c0))
            continue
        if c == "=" and src.startswith("====", i):
            l0, c0 = line, col
            j = i
            while j < n and src[j] == "=":
                j += 1
            adv(j - i)
            toks.append(Token("end4", "====", l0, c0))
            continue
        # string literal
        if c == '"':
            l0, c0 = line, col
            j = i + 1
            buf = []
            while j < n and src[j] != '"':
                if src[j] == "\\" and j + 1 < n:
                    esc = src[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise LexError("unterminated string", l0, c0)
            adv(j + 1 - i)
            toks.append(Token("string", "".join(buf), l0, c0))
            continue
        # number (TLA+ naturals only; '1..2' must lex as 1, '..', 2)
        if c.isdigit():
            l0, c0 = line, col
            j = i
            while j < n and src[j].isdigit():
                j += 1
            text = src[i:j]
            adv(j - i)
            toks.append(Token("number", text, l0, c0))
            continue
        # identifier / reserved word
        if c.isalpha() or c == "_":
            l0, c0 = line, col
            j = i
            while j < n and _is_ident_char(src[j]):
                j += 1
            word = src[i:j]
            # WF_/SF_ prefixes split: WF_vars -> 'WF_' + ident 'vars'
            if word.startswith(("WF_", "SF_")) and len(word) > 3:
                adv(3)
                toks.append(Token("reserved", word[:3], l0, c0))
                continue
            adv(j - i)
            if word == "_":
                toks.append(Token("op", "_", l0, c0))
            elif word in RESERVED:
                toks.append(Token("reserved", word, l0, c0))
            else:
                toks.append(Token("ident", word, l0, c0))
            continue
        # backslash operators  (\in, \cup, \o, \X, \A, \E, ...)
        if c == "\\":
            l0, c0 = line, col
            if i + 1 < n and src[i + 1] == "/":
                adv(2)
                toks.append(Token("op", "\\/", l0, c0))
                continue
            j = i + 1
            while j < n and src[j].isalpha():
                j += 1
            if j == i + 1:
                # lone backslash = set difference
                adv(1)
                toks.append(Token("op", "\\", l0, c0))
                continue
            word = src[i:j]
            adv(j - i)
            toks.append(Token("op", word, l0, c0))
            continue
        # structured-proof step labels: <1>1. / <2>3 / <1>a  (TLAPS syntax,
        # appears in the Paxos proof sketches) — parser skips proof bodies
        if c == "<" and i + 1 < n and src[i + 1].isdigit():
            j = i + 1
            while j < n and src[j].isdigit():
                j += 1
            if j < n and src[j] == ">":
                l0, c0 = line, col
                j += 1
                while j < n and _is_ident_char(src[j]):
                    j += 1
                if j < n and src[j] == ".":
                    j += 1
                text = src[i:j]
                adv(j - i)
                toks.append(Token("prooflabel", text, l0, c0))
                continue
        # symbols (greedy longest match)
        for sym in _SYMBOLS:
            if src.startswith(sym, i):
                # ']_' and '>>_' only when followed by a subscript start:
                # name, number, '<<tuple>>', or parenthesized expression
                if sym in ("]_", ">>_"):
                    nxt = src[i + len(sym):i + len(sym) + 1]
                    if not (nxt.isalpha() or nxt.isdigit()
                            or nxt in ("<", "_", "(")):
                        continue
                l0, c0 = line, col
                adv(len(sym))
                toks.append(Token("op", sym, l0, c0))
                break
        else:
            raise LexError(f"unexpected character {c!r}", line, col)

    toks.append(Token("eof", "", line, col))
    return toks
