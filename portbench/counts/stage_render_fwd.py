"""The training render's forward: warp and tile lookup of every (plane,
pixel), the compaction, the bilinear samples of the static and dynamic
tiles, decode, select, composite and the smoothness sums.  Reads the
tile maps and the touched tiles' f32 texels once; writes the patch's
rgb (F, h, w, 3) f32."""
from portbench.counts.common import composite_ops


def count(s):
    n_plane = s.D * s.h * s.w
    ops = (n_plane * 25                                  # warp + lookup
           + s.hits_s * (9 * s.C + 10)                   # static samples
           + s.n_dyn * s.F * (9 * s.C + 10)              # dynamic samples
           + composite_ops(s, backward=False))
    nbytes = (2 * s.D * s.nth * s.ntw * 4
              + s.used_s * s.th * s.tw * s.C * 4
              + s.used_d * s.th * s.tw * s.F * s.C * 4
              + s.F * s.h * s.w * 3 * 4)
    return {"ops": ops, "bytes": nbytes, "peak": "f32"}
