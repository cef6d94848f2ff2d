"""The training render's backward: from the patch's rgb cotangent to the
gradients of both atlases.  Reads the cotangent and the touched texels
once; writes both atlases' gradients whole (f32, every texel)."""
from portbench.counts.common import composite_ops


def count(s):
    ops = (composite_ops(s, backward=True)
           + s.hits_s * (8 * s.C + 10)
           + s.n_dyn * s.F * (8 * s.C + 10))
    nbytes = (s.F * s.h * s.w * 3 * 4
              + s.used_s * s.th * s.tw * s.C * 4
              + s.used_d * s.th * s.tw * s.F * s.C * 4
              + s.Ns * s.th * s.tw * s.C * 4
              + s.Nd * s.th * s.tw * s.F * s.C * 4)
    return {"ops": ops, "bytes": nbytes, "peak": "f32"}
