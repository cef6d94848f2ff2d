"""K3, the dynamic tiles' samples of the f32 atlas read as bf16
(``chip_smoke.py``: n * 4 + hits * 8 + the touched tiles' texels + the
samples written, hits * F * (9 C + 10) operations)."""


def count(s):
    n = s.n_sp
    nbytes = (n * 4 + s.n_dyn * 8 + s.used_d * s.th * s.tw * s.F * s.C * 4
              + n * s.F * s.C * 4)
    return {"ops": s.n_dyn * s.F * (9 * s.C + 10), "bytes": nbytes,
            "peak": "f32"}
