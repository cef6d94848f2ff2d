"""K10, the dynamic tiles' gradient (``chip_smoke.py``: n * 4 +
hits * (8 + F * C * 4) + the whole gradient written, hits * F * (8 C +
10) operations)."""


def count(s):
    n = s.n_sp
    nbytes = n * 4 + s.n_dyn * (8 + s.F * s.C * 4) \
        + s.Nd * s.th * s.tw * s.F * s.C * 4
    return {"ops": s.n_dyn * s.F * (8 * s.C + 10), "bytes": nbytes,
            "peak": "f32"}
