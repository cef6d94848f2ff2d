"""The looping loss's nearest-patch search (K11's work, bf16 on the
tensor cores): reads the loop-padded render and the video in bf16 once,
writes one int32 index a query."""
from portbench.counts.common import nn_search_ops


def count(s):
    p = s.plan
    ntx, nty, nh, nw = p.grid
    cols = len(p.hs) * len(p.ws) * nh * nw
    n_nn = cols * ntx
    nbytes = (3 * s.Fx * s.h * s.w + 3 * s.F * s.h * s.w) * 2 + n_nn * 4
    ops = cols * (nn_search_ops(p, 3, 2) + 5 * ntx * nty)
    return {"ops": ops, "bytes": nbytes, "peak": "bf16"}
