"""The looping loss's fold of the chosen patches into the target (K12's
work) and the robust penalty with its gradient: reads the video (bf16),
the indices and the render (f32) once, writes the render's gradient
(f32)."""


def count(s):
    p = s.plan
    ntx, nty, nh, nw = p.grid
    cols = len(p.hs) * len(p.ws) * nh * nw
    n_nn = cols * ntx
    ft, fh, fw = p.fit
    vox = 3 * ft * fh * fw
    pt, ph, pw = p.psz
    covers = n_nn * pt * ph * pw
    nbytes = (3 * s.F * s.h * s.w * 2 + n_nn * 4
              + 3 * s.Fx * s.h * s.w * 4 * 2)
    ops = 3 * covers + vox + vox * 30
    return {"ops": ops, "bytes": nbytes, "peak": "f32"}
