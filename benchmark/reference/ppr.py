"""Approximate personalized PageRank by Andersen's push, one source at a
time, in NumPy: the algorithm of the LPFormer reference
(src/util/calc_ppr_scores.py), a LIFO queue of the nodes whose residual
reaches ``alpha * eps * deg``, over the distinct neighbours of the
symmetrised train edges. ``dtype`` is the arithmetic's (float64 as
published; the control runs float32)."""
from __future__ import annotations

import numpy as np


def push_rows(indptr, indices, sources, alpha: float, eps: float,
              dtype=np.float64):
    """{source: (ids sorted, float32 values)} of each source's push."""
    n = len(indptr) - 1
    deg = (indptr[1:] - indptr[:-1]).astype(dtype)
    thr = (dtype(alpha) * dtype(eps)) * deg
    p = np.zeros(n, dtype)
    r = np.zeros(n, dtype)
    inq = np.zeros(n, bool)
    a, one_minus = dtype(alpha), dtype(1.0) - dtype(alpha)
    out = {}
    for s in sources:
        s = int(s)
        r[s] = a
        q = [s]
        inq[s] = True
        touched = [np.array([s])]
        while q:
            u = q.pop()
            inq[u] = False
            res = r[u]
            p[u] += res
            r[u] = 0
            if deg[u] == 0:
                continue
            val = one_minus * res / deg[u]
            nb = indices[indptr[u]:indptr[u + 1]]
            r[nb] += val
            touched.append(nb)
            new = nb[(r[nb] >= thr[nb]) & ~inq[nb]]
            if len(new):
                q.extend(new.tolist())
                inq[new] = True
        touched = np.unique(np.concatenate(touched))
        ids = touched[p[touched] != 0]
        out[s] = (ids, p[ids].astype(np.float32))
        p[touched] = 0
        r[touched] = 0
    return out
