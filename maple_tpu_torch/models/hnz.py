"""HorseNotZebra (HnZ) lineage-abundance topology modifiers.

Mode 1 multiplies the likelihood by the number of embedded bifurcating
topologies of each multifurcation; mode 2 by a sampling likelihood n*log(n)
(reference :305-328).  Scores are memoized per mode.
"""
from math import log

_vectors = {1: [0, 0, 0], 2: [0, 0, 2 * log(2)]}


def get_hnz(mode: int, n: int) -> float:
    if n <= 0:
        raise ValueError(f"HnZ score requested for non-positive nDesc0 {n}")
    vec = _vectors[mode]
    while len(vec) <= n:
        cur = len(vec)
        if mode == 1:
            vec.append(vec[-1] + log(2 * cur - 3))
        else:
            vec.append(cur * log(cur))
    return vec[n]
