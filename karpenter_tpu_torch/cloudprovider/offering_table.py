"""One offering table for the truncation of a round's new claims.

``truncate_instance_types`` (types.py, types.go Truncate:203) orders one
claim's instance types by the cheapest available offering compatible with
the claim, name breaking ties, and keeps the first ``max_items``: a
``Requirements.compatible`` call for every (type, offering) pair of the
claim. A round's claims share the catalog's types, and a catalog holds a
handful of distinct offering requirement sets (zone × capacity type).
:class:`OfferingTable` prices each (type, requirement set) pair once over
the union of the round's types, answers compatibility once per
(requirement set, claim restriction) through a memo, and orders each
claim's types with one ``lexsort``. Its answer is
``truncate_instance_types``'s, the same list in the same order and the
same error.

The table lives for one call: offering availability and the risk weight
λ may change between rounds, so nothing is kept across them. ``STATS``
counts, over the process, the claims truncated, the ``compatible`` calls
made (``compat_evals``) and the lookups the memo answered
(``memo_hits``).
"""

from __future__ import annotations

import math

import numpy as np

from karpenter_tpu_torch.api import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    effective_price,
    risk_lambda,
    satisfies_min_values,
)

# process-wide truncation accounting — a plain dict
STATS = {
    "claims": 0,
    "compat_evals": 0,
    "memo_hits": 0,
}


class OfferingTable:
    """The available offerings of ``its`` as a (type, requirement set)
    table of effective prices, the cheapest where a type has several
    offerings with one requirement set; ``inf`` where it has none."""

    def __init__(self, its):
        lam = risk_lambda()  # once per table, as order_by_price reads it once per sort
        self._pos: dict = {}
        self._sig_reqs: list = []  # one offering's Requirements per requirement set
        self._sig_keys: list = []
        self._memo: dict = {}
        sig_of: dict = {}
        names, cells = [], []
        for it in its:
            if id(it) in self._pos:
                continue
            self._pos[id(it)] = len(names)
            names.append(it.name)
            for o in it.offerings:
                if not o.available:
                    continue
                # by content: every type holds Requirements of its own
                sig = frozenset(o.requirements.items())
                s = sig_of.get(sig)
                if s is None:
                    s = sig_of[sig] = len(self._sig_reqs)
                    self._sig_reqs.append(o.requirements)
                    self._sig_keys.append(tuple(o.requirements))
                cells.append((len(names) - 1, s, effective_price(o, lam)))
        self._price = np.full((len(names), len(self._sig_reqs)), math.inf)
        for t, s, p in cells:
            if p < self._price[t, s]:
                self._price[t, s] = p
        rank = {n: r for r, n in enumerate(sorted(set(names)))}
        self._rank = np.fromiter((rank[n] for n in names), dtype=np.int64,
                                 count=len(names))

    def _compatible(self, reqs, s: int) -> bool:
        """``reqs.is_compatible`` with requirement set ``s``, memoised.
        ``compatible`` reads the incoming requirement set and, for each of
        its keys, whether ``reqs`` holds the key and ``reqs``'s
        requirement there (its intersection on shared keys); no other key
        of ``reqs`` takes part. So the answer is a function of the set and
        ``reqs`` restricted to the set's keys, which is the key."""
        key = (s, tuple(reqs.get(k) for k in self._sig_keys[s]))
        hit = self._memo.get(key)
        if hit is not None:
            STATS["memo_hits"] += 1
            return hit
        STATS["compat_evals"] += 1
        ok = self._memo[key] = reqs.is_compatible(
            self._sig_reqs[s], allow_undefined=wk.WELL_KNOWN_LABELS)
        return ok

    def truncate(self, its, reqs, max_items: int):
        """``truncate_instance_types(its, reqs, max_items)`` from the
        table: (truncated list, error). Every type of ``its`` is one the
        table was built over."""
        STATS["claims"] += 1
        its = list(its)
        idx = np.fromiter(map(self._pos.__getitem__, map(id, its)), dtype=np.intp,
                          count=len(its))
        cols = [s for s in range(len(self._sig_reqs)) if self._compatible(reqs, s)]
        if cols:
            price = self._price[np.ix_(idx, cols)].min(axis=1)
        else:
            price = np.full(len(idx), math.inf)
        # (price, name) as order_by_price sorts; lexsort is stable, as
        # sorted is, for types of one name and price
        order = np.lexsort((self._rank[idx], price))[:max_items]
        truncated = [its[i] for i in order.tolist()]
        if reqs.has_min_values():
            _, err = satisfies_min_values(truncated, reqs)
            if err:
                return its, f"validating minValues, {err}"
        return truncated, None
