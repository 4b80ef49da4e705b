r"""TLC .cfg model-configuration parser.

Grammar: the corpus self-specifies the cfg language at
tla-rust examples/SpecifyingSystems/TLC/ConfigFileGrammar.tla:8-33.
Statements observed in-corpus (SURVEY.md §5): SPECIFICATION, INIT, NEXT,
INVARIANT[S], PROPERTY/PROPERTIES, CONSTRAINT[S], ACTION-CONSTRAINT[S],
SYMMETRY, VIEW, CONSTANT[S] with either
    Ident = <value>          (model value / literal instantiation)
    Ident <- Defn            (substitute a definition)
    Ident <- [Mod] Defn      (instance-scoped substitution, MCPaxos.cfg:9)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class CfgError(Exception):
    pass


@dataclass
class ModelConfig:
    specification: Optional[str] = None
    init: Optional[str] = None
    next: Optional[str] = None
    invariants: List[str] = field(default_factory=list)
    properties: List[str] = field(default_factory=list)
    constraints: List[str] = field(default_factory=list)
    action_constraints: List[str] = field(default_factory=list)
    symmetry: Optional[str] = None
    view: Optional[str] = None
    # name -> parsed constant value (ints, strings, model values, sets of those)
    constants: Dict[str, object] = field(default_factory=dict)
    # name -> substituted definition name;  scoped[(module, name)] for <-[Mod]
    overrides: Dict[str, str] = field(default_factory=dict)
    scoped_overrides: Dict[Tuple[str, str], str] = field(default_factory=dict)
    check_deadlock: bool = True


@dataclass(frozen=True)
class CfgModelValue:
    """A fresh model value introduced by `Ident = Ident` in a cfg."""
    name: str

    def __repr__(self):
        return self.name


_KEYWORDS = {
    "SPECIFICATION", "INIT", "NEXT", "INVARIANT", "INVARIANTS", "PROPERTY",
    "PROPERTIES", "CONSTRAINT", "CONSTRAINTS", "ACTION-CONSTRAINT",
    "ACTION-CONSTRAINTS", "SYMMETRY", "VIEW", "CONSTANT", "CONSTANTS",
    "CHECK_DEADLOCK",
}

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<comment>\\\*[^\n]*|\(\*.*?\*\))
      | (?P<str>"[^"]*")
      | (?P<num>-?\d+)
      | (?P<arrow><-)
      | (?P<punct>[={},\[\]])
      | (?P<word>[A-Za-z0-9_!.\-]+)
    )""",
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> List[str]:
    toks = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise CfgError(f"bad cfg syntax near {text[pos:pos+30]!r}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        toks.append(m.group(m.lastgroup))
    return toks


def _parse_value(toks: List[str], i: int):
    """Parse a constant value: number, string, model value, or {set, of, them}."""
    if i >= len(toks):
        raise CfgError("constant binding missing its value")
    t = toks[i]
    if t == "{":
        items = []
        i += 1
        while True:
            if i >= len(toks):
                raise CfgError("unterminated set value in cfg")
            if toks[i] == "}":
                break
            v, i = _parse_value(toks, i)
            items.append(v)
            if i < len(toks) and toks[i] == ",":
                i += 1
        return frozenset(items), i + 1
    if t.startswith('"'):
        return t[1:-1], i + 1
    if re.fullmatch(r"-?\d+", t):
        return int(t), i + 1
    if t == "TRUE":
        return True, i + 1
    if t == "FALSE":
        return False, i + 1
    return CfgModelValue(t), i + 1


def parse_cfg(text: str) -> ModelConfig:
    toks = _tokenize(text)
    cfg = ModelConfig()
    i = 0
    n = len(toks)

    def names_until_keyword(i):
        names = []
        while i < n and toks[i] not in _KEYWORDS:
            # stop if this looks like the start of a CONSTANT binding
            if i + 1 < n and toks[i + 1] in ("=", "<-"):
                break
            names.append(toks[i])
            i += 1
        return names, i

    def arg(j):
        if j >= n:
            raise CfgError(f"statement {toks[-1]!r} missing its argument")
        return toks[j]

    while i < n:
        kw = toks[i]
        if kw == "SPECIFICATION":
            cfg.specification = arg(i + 1)
            i += 2
        elif kw == "INIT":
            cfg.init = arg(i + 1)
            i += 2
        elif kw == "NEXT":
            cfg.next = arg(i + 1)
            i += 2
        elif kw in ("INVARIANT", "INVARIANTS"):
            names, i = names_until_keyword(i + 1)
            cfg.invariants.extend(names)
        elif kw in ("PROPERTY", "PROPERTIES"):
            names, i = names_until_keyword(i + 1)
            cfg.properties.extend(names)
        elif kw in ("CONSTRAINT", "CONSTRAINTS"):
            names, i = names_until_keyword(i + 1)
            cfg.constraints.extend(names)
        elif kw in ("ACTION-CONSTRAINT", "ACTION-CONSTRAINTS"):
            names, i = names_until_keyword(i + 1)
            cfg.action_constraints.extend(names)
        elif kw == "SYMMETRY":
            cfg.symmetry = arg(i + 1)
            i += 2
        elif kw == "VIEW":
            cfg.view = arg(i + 1)
            i += 2
        elif kw == "CHECK_DEADLOCK":
            cfg.check_deadlock = arg(i + 1) == "TRUE"
            i += 2
        elif kw in ("CONSTANT", "CONSTANTS"):
            i += 1
            while i < n and toks[i] not in _KEYWORDS:
                name = toks[i]
                if i + 1 >= n or toks[i + 1] not in ("=", "<-"):
                    raise CfgError(f"expected = or <- after constant {name!r}")
                if toks[i + 1] == "=":
                    val, j = _parse_value(toks, i + 2)
                    # `Ident = Ident` introduces a fresh model value; keep the
                    # self-named case as a model value too (NoVal = NoVal)
                    cfg.constants[name] = val
                    i = j
                else:
                    i += 2
                    if arg(i) == "[":
                        mod = arg(i + 1)
                        if arg(i + 2) != "]":
                            raise CfgError("bad scoped substitution")
                        cfg.scoped_overrides[(mod, name)] = arg(i + 3)
                        i += 4
                    else:
                        cfg.overrides[name] = arg(i)
                        i += 1
        else:
            raise CfgError(f"unknown cfg statement {kw!r}")
    return cfg
