r"""cfg SYMMETRY support: the permutation group shared by every backend.

TLC's SYMMETRY statement names a set of model-value permutations
(TLC.tla:13-14 `Permutations`); states are canonicalized to one
representative per orbit. TLC canonicalizes over the GROUP generated by
the declared set — `Permutations(A) \cup Permutations(B)` alone misses
the combined A+B permutations and under-reduces — so the closure under
composition is computed here, once, for both the interp canonicalizer
(engine/explore.py) and the device-row canonicalizer
(compile/symmetry2.py).
"""

from __future__ import annotations

from typing import Dict, List

from .eval import eval_expr
from .values import Fcn, enumerate_set


def symmetry_group(model) -> List[Dict]:
    """The non-identity elements of the group generated by the cfg's
    SYMMETRY permutation set, as ModelValue->ModelValue dicts. Empty when
    no symmetry is declared or every permutation is the identity."""
    if model.symmetry is None:
        return []
    base = []
    val = eval_expr(model.symmetry, model.ctx())
    for p in enumerate_set(val):
        if isinstance(p, Fcn):
            base.append(dict(p.d))

    def key_of(pd):
        return tuple(sorted((id(k), id(v)) for k, v in pd.items()))

    group = {key_of(pd): pd for pd in base}
    frontier = list(base)
    while frontier:
        nxt = []
        for a in frontier:
            for b in base:
                comp = {k: b.get(a.get(k, k), a.get(k, k))
                        for k in set(a) | set(b)}
                kk = key_of(comp)
                if kk not in group:
                    group[kk] = comp
                    nxt.append(comp)
        frontier = nxt
    return [pd for pd in group.values()
            if any(k is not v for k, v in pd.items())]
