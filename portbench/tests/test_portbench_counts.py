"""The work counts against counts worked by hand at small shapes."""
from types import SimpleNamespace

import pytest

from portbench import counts
from portbench.counts.common import composite_ops, nn_search_ops
from portbench.reference import stage2 as ref

PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32": 67e12, "bf16": 989e12}


def shape(**kw):
    s = dict(h=2, w=3, F=2, Fx=4, C=4, D=3, S=2, nth=1, ntw=2, th=2, tw=2,
             Ns=1, Nd=1, n_sp=12, n_dyn=5, hits_s=4, used_s=1, used_d=1,
             decoder="direct", n_params=40, plan=None)
    s.update(kw)
    return SimpleNamespace(**s)


def test_adam():
    w = counts.stages()["adam"](shape(n_params=10))
    assert w == {"ops": 120, "bytes": 280, "peak": "f32"}


def test_kernel_k10_and_k3():
    s = shape()
    # K10: 12 samples * 4 + 5 hits * (8 + 2 * 4 * 4) + 1 * 2 * 2 * 2 * 4 * 4
    assert counts.kernel("K10")(s) == {
        "ops": 5 * 2 * (8 * 4 + 10), "bytes": 48 + 5 * 40 + 128,
        "peak": "f32"}
    # K3: 12 * 4 + 5 * 8 + 1 * 2 * 2 * 2 * 4 * 4 + 12 * 2 * 4 * 4
    assert counts.kernel("K3")(s) == {
        "ops": 5 * 2 * (9 * 4 + 10), "bytes": 48 + 40 + 128 + 384,
        "peak": "f32"}


def test_composite_ops_by_hand():
    s = shape()
    # forward: decode 20 * (5 * 2 + 7) + 24 slot-pixel-frames * (10 + 24)
    assert composite_ops(s, False) == 20 * 17 + 24 * 34
    # backward: decode + 24 * (2 + 6 + 10 + 40) + 16 * 10 + 4 * 14 + 16 * 7
    assert composite_ops(s, True) == 20 * 17 + 24 * 58 + 160 + 56 + 112
    sh = shape(decoder="rgb_sh", C=13)
    assert composite_ops(sh, False) == 44 * 17 + 24 * 34


def test_nn_search_ops_brute_force():
    plan = ref.crop_plan(6, 5, 7, 7, (2, 3, 3), (1, 2, 2), 65)
    ntx, nty = 5, 4
    assert plan.grid == (ntx, nty, 3, 3)
    C, pt = 3, 2
    cpp = C * 3 * 3
    patches = 2 * ntx * nty * cpp * pt + 2 * (ntx + nty) * cpp * pt
    nfx, nfy = ntx - 1 + pt, nty - 1 + pt
    frames = (2 * nfx * nfy * cpp + (pt - 1) * ntx * nty
              + 2 * (nfx + nfy) * cpp + (pt - 1) * (ntx + nty))
    assert nn_search_ops(plan, C, 2) == min(patches, frames)


def test_loss_search_counts_every_crop_column():
    plan = ref.crop_plan(4, 2, 6, 6, (3, 3, 3), (1, 2, 2), 65)
    assert plan.grid == (2, 0, 2, 2)
    s = shape(h=6, w=6, F=2, Fx=4, plan=plan)
    w = counts.stages()["loss_search"](s)
    cols = len(plan.hs) * len(plan.ws) * 4
    assert w["bytes"] == (3 * 4 * 36 + 3 * 2 * 36) * 2 + cols * 2 * 4
    assert w["peak"] == "bf16"


def test_least_seconds_takes_the_bound_side():
    assert counts.least_seconds({"ops": 67e12, "bytes": 0, "peak": "f32"},
                                PEAKS) == pytest.approx(1.0)
    assert counts.least_seconds({"ops": 1, "bytes": 3.35e12, "peak": "bf16"},
                                PEAKS) == pytest.approx(1.0)


def test_every_stage_counts_positive_work():
    plan = ref.crop_plan(52, 50, 180, 320, (3, 11, 11), (1, 4, 4), 65)
    assert plan.grid == (50, 48, 14, 14)
    s = shape(h=180, w=320, F=50, Fx=52, C=4, D=32, S=19, nth=35, ntw=63,
              th=12, tw=12, Ns=9786, Nd=4257, n_sp=19 * 57600,
              n_dyn=200000, hits_s=300000, used_s=3000, used_d=1500,
              n_params=128_200_000, plan=plan)
    total = 0.0
    for name, f in counts.stages().items():
        w = f(s)
        assert w["ops"] > 0 and w["bytes"] > 0, name
        total += counts.least_seconds(w, PEAKS)
    # Adam alone: 28 B x 128.2 M over 3.35 TB/s
    assert total > 28 * 128.2e6 / 3.35e12
