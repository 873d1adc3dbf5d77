"""The one traffic generator: a closed loop of solve requests whose
parameters are drawn from the seed as a traffic file describes.

A traffic file (``traffic/<mix>.json``) holds:

``mesh``
    ``"once"``: the set-up meshes the configuration's geometry and every
    request solves on that mesh; ``"per_request"``: every request meshes
    its own geometry first.
``vary``
    ``{parameter: [low, high]}``: each request draws these parameters of
    the configuration's problem uniformly from the range.
``set``
    ``{parameter: value}``: parameters every request takes as given.
``strata``
    The draws are stratified: each run of ``strata`` consecutive requests
    takes every stratum ``[low + k (high - low) / strata, ...)`` of every
    varied parameter once, in an order and at a point inside the stratum
    drawn from the seed. So every seed offers the same mix of work, in
    another order.

One client sends the requests back to back: each waits for the previous
one to finish (an engineer's script, or a sweep driver, does so).
"""

from __future__ import annotations

import numpy as np

#: keys a traffic file may hold
KEYS = {"mesh", "vary", "set", "strata", "why"}


class Traffic:
    def __init__(self, spec: dict, seed: int):
        unknown = set(spec) - KEYS
        if unknown:
            raise ValueError(f"traffic: unknown keys {sorted(unknown)}")
        if spec["mesh"] not in ("once", "per_request"):
            raise ValueError("traffic: mesh must be 'once' or 'per_request'")
        self.per_request_mesh = spec["mesh"] == "per_request"
        self.vary = {k: (float(lo), float(hi))
                     for k, (lo, hi) in spec.get("vary", {}).items()}
        self.set = dict(spec.get("set", {}))
        self.strata = int(spec.get("strata", 1))
        self.seed = int(seed)
        self._cycles: dict[int, dict] = {}

    def _cycle(self, c: int) -> dict:
        """The draws of cycle ``c`` (requests c*strata .. c*strata+strata-1):
        per varied parameter, a permutation of the strata and offsets."""
        if c not in self._cycles:
            rng = np.random.default_rng([self.seed & 0xFFFFFFFFFFFFFFFF, c])
            self._cycles[c] = {
                k: (rng.permutation(self.strata), rng.random(self.strata))
                for k in sorted(self.vary)}
        return self._cycles[c]

    def request(self, i: int) -> dict:
        """The parameters request ``i`` sets."""
        c, j = divmod(i, self.strata)
        draws = self._cycle(c)
        out = dict(self.set)
        for k, (lo, hi) in self.vary.items():
            perm, off = draws[k]
            out[k] = lo + (hi - lo) * (perm[j] + off[j]) / self.strata
        return out

    def check_sample(self, n_requests: int, k: int) -> list:
        """The indices of ``k`` distinct served requests (all, if fewer
        were served) drawn from the seed."""
        rng = np.random.default_rng([self.seed & 0xFFFFFFFFFFFFFFFF,
                                     0xC4EC])
        return sorted(int(i) for i in rng.permutation(n_requests)[:k])
