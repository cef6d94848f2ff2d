"""K15, the fused stage-2 composite's backward (``chip_smoke.py``
``bwd_bound``): K14's reads (the samples each slot selects, the masks),
the cotangents read as K14's outputs were written, the texel cotangents
(S, h, w, F, 4) and (S, h, w, 4) f32 written."""
from portbench.counts.common import composite_ops


def count(s):
    P = s.h * s.w
    reads = s.n_dyn * s.F * 16 + (s.n_sp - s.n_dyn) * 16 + s.n_sp * 3
    writes = P * s.F * 16 + 12
    nbytes = reads + writes + s.n_sp * s.F * 16 + s.n_sp * 16
    return {"ops": composite_ops(s, backward=True), "bytes": nbytes,
            "peak": "f32"}
