"""The GPNN looping loss of the PyTorch port against the JAX package, on
the CPU: `robust_lossfun`, `_lm_plan`, the plain versions of K11 (the
nearest-temporal-patch search) and K12 (select, fold, crop overlap-add
and weight division) against JAX's `nn_indices` and retarget, with alpha
off and alpha 0, f32 and bf16 inputs, exact duplicate patches and 0/0
columns; `gpnn_lowmem_loss` and `gpnn_direct_loss` values and input
gradients at the shipped patch shapes cut to size (3x3x3, and 3x5x5
standing in for 3x11x11); `video_mse_loss` and `video_avg_loss`.  Inputs
are made with numpy and handed to both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.losses import patch_nn as J
from videoloop3d_torch.losses import patch_nn as T


@pytest.fixture
def f32_fold(monkeypatch):
    """The JAX package's CPU route folds bf16 patches in bf16; its TPU
    route (`fold_patches_flat`) and the port sum them in f32.  Under this
    fixture the JAX CPU fold takes f32 patches, as on the TPU."""
    fold = J.fold_patches_3d
    monkeypatch.setattr(J, "fold_patches_3d",
                        lambda p, *a: fold(p.astype(jnp.float32), *a))


@pytest.mark.parametrize("rou", ["mse", "abs", 0, 2, -2, 1.5, "-2"])
def test_robust_lossfun_matches_jax(rou):
    x = np.random.default_rng(0).normal(0, 0.3, (4, 50)).astype(np.float32)
    t = T.robust_lossfun(torch.from_numpy(x), rou, 0.1).numpy()
    j = np.asarray(J.robust_lossfun(jnp.asarray(x), rou, 0.1))
    np.testing.assert_allclose(t, j, rtol=2e-6, atol=1e-7)


PLAN_CASES = [(52, 50, 180, 320, (3, 3, 3), (1, 2, 2), 65),
              (52, 50, 180, 320, (3, 11, 11), (1, 4, 4), 65),
              (14, 12, 37, 61, (3, 5, 5), (1, 2, 2), 17),
              (8, 6, 18, 24, (3, 5, 5), (1, 2, 2), 33)]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_lm_plan_matches_jax(case):
    """Fitted sizes, clamped crop starts and the clipped weight equal."""
    t = T._lm_plan(*case)
    j = J._lm_plan(*case)
    assert t[:6] == j[:6]
    np.testing.assert_array_equal(t[6], j[6])
    plan = T.lowmem_plan(*case)
    assert plan.hs == j[4] and plan.ws == j[5]
    assert plan.crop_hw == (j[0], j[0]) and plan.fit == tuple(j[1:4])


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_ints_carry_the_crop_starts(case):
    """The int array the NN kernels unpack (csrc/nn_crops.cuh) holds the
    plan's shape fields, then JAX's own clamped starts."""
    plan = T.lowmem_plan(*case)
    j = J._lm_plan(*case)
    a = list(T._plan_ints(plan))
    assert a[:14] == [*case[4], *case[5], j[0], j[0], *plan.grid,
                      len(j[4]), len(j[5])]
    assert a[14:] == [*j[4], *j[5]]


def test_plan_ints_refuse_too_many_starts():
    plan = T.lowmem_plan(8, 6, 18, 24 * 70, (3, 5, 5), (1, 2, 2), 9)
    assert len(plan.ws) > T._MAX_STARTS
    with pytest.raises(ValueError, match="starts per axis"):
        T._plan_ints(plan)


def _inputs(seed, dtype, C=3, Tx=9, Ty=7, H=21, W=26):
    rng = np.random.default_rng(seed)
    x = rng.random((C, Tx, H, W)).astype(np.float32)
    y = rng.random((C, Ty, H, W)).astype(np.float32)
    if dtype == "bf16":       # values on the bf16 grid for both packages
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        y = np.asarray(jnp.asarray(y, jnp.bfloat16).astype(jnp.float32))
    return x, y


def _jax_indices(x, y, plan, alpha, bf16):
    """JAX's nn_indices on the crops of `plan` (its retarget's search)."""
    ft, fh, fw = plan.fit
    mh, mw = plan.crop_hw
    dt = jnp.bfloat16 if bf16 else jnp.float32
    xs = jnp.asarray(x, dt)[:, :ft, :fh, :fw]
    ys = jnp.asarray(y, dt)[:, :plan.fit_ty, :fh, :fw]
    out = []
    for h0 in plan.hs:
        for w0 in plan.ws:
            Xp = J.extract_patches_flat(xs[..., h0:h0 + mh, w0:w0 + mw],
                                        plan.psz, plan.strides)
            Yp = J.extract_patches_flat(ys[..., h0:h0 + mh, w0:w0 + mw],
                                        plan.psz, plan.strides)
            ntx, nh, nw, d = Xp.shape
            out.append(np.asarray(J.nn_indices(
                Xp.reshape(ntx, nh * nw, d).transpose(1, 0, 2),
                Yp.reshape(Yp.shape[0], nh * nw, d).transpose(1, 0, 2),
                alpha)))
    return np.stack(out)


SEARCH_CASES = {"3x3x3": ((3, 3, 3), (1, 2, 2), 11),
                "3x5x5": ((3, 5, 5), (1, 2, 2), 13)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_nn_search_and_fold_match_jax(case, alpha, dtype, f32_fold):
    """K11's plain version returns JAX's indices exactly (random inputs
    have no near ties) on the macro-block and the direct plan, and K12's
    plain version on them equals JAX's weight-normalized retarget target
    within 1e-6."""
    psz, strides, macro = SEARCH_CASES[case]
    bf16 = dtype == "bf16"
    x, y = _inputs(1, dtype)
    C, Tx, H, W = x.shape
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if bf16:
        tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if bf16:
        jx, jy = jx.astype(jnp.bfloat16), jy.astype(jnp.bfloat16)
    lm = T.lowmem_plan(Tx, y.shape[1], H, W, psz, strides, macro)
    assert len(lm.hs) * len(lm.ws) > 1
    nn = T.nn_argmin(tx, ty, lm, alpha)
    assert nn.dtype == torch.int32
    np.testing.assert_array_equal(nn.numpy(), _jax_indices(x, y, lm, alpha,
                                                           bf16))
    jt, fit = J.gpnn_lowmem_retarget(
        jx, jy, patch_size=psz[1], patcht_size=psz[0], stride=strides[1],
        stridet=strides[0], alpha=alpha, macro_block=macro)
    assert fit == lm.fit
    got = T.nn_fold(ty, nn, lm)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(jt)).max() <= 1e-6

    dp = T.direct_plan(Tx, y.shape[1], H, W, psz, strides)
    nn = T.nn_argmin(tx, ty, dp, alpha)
    np.testing.assert_array_equal(nn.numpy(), _jax_indices(x, y, dp, alpha,
                                                           bf16))
    ft, fh, fw = dp.fit
    jd = J.nn_retarget(jx[:, :ft, :fh, :fw], jy[:, :dp.fit_ty, :fh, :fw],
                       psz, strides, alpha)
    jd = np.asarray(jd) / dp.weight[None]
    assert np.abs(T.nn_fold(ty, nn, dp).numpy() - jd).max() <= 1e-6


def test_nn_search_first_index_and_nan_match_jax():
    """Exact duplicates among the y patches: the first index wins; a
    column whose minimum is exactly 0 under alpha 0 gives 0/0 = NaN, and
    the first NaN wins; both as jnp.argmin chooses (values on a 1/4 grid,
    so every sum is exact in both packages)."""
    rng = np.random.default_rng(12)
    y = rng.integers(0, 4, (3, 8, 9, 9)).astype(np.float32) / 4
    y[:, 4:] = y[:, :4]                     # frames 4-7 repeat frames 0-3
    x = rng.integers(0, 4, (3, 6, 9, 9)).astype(np.float32) / 4
    x[:, 1:4] = y[:, 1:4]                   # x patch 1 equals y patches 1, 5
    plan = T.direct_plan(6, 8, 9, 9, (3, 3, 3), (1, 2, 2))
    for alpha in (None, 0.0):
        got = T.nn_argmin(torch.from_numpy(x), torch.from_numpy(y), plan,
                          alpha).numpy()
        np.testing.assert_array_equal(got, _jax_indices(x, y, plan, alpha,
                                                        False))
        dist = T.nn_dist_plain(torch.from_numpy(x), torch.from_numpy(y),
                               plan, alpha)
        if alpha is None:
            assert (got[..., 1] == 1).all()
        else:
            assert torch.isnan(dist[..., 1, 1]).all()
            assert torch.isinf(dist[..., 0, 1]).all()
            assert (got[..., 1] == 1).all()


LOSS_CASES = {"3x3x3": dict(patch_size=3, patcht_size=3, stride=2, stridet=1,
                            rou=-2, scaling=0.1, macro_block=11),
              "3x5x5": dict(patch_size=5, patcht_size=3, stride=2, stridet=1,
                            rou=-2, scaling=0.1, macro_block=13)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "nn_bf16"])
@pytest.mark.parametrize("alpha", [1e4, 0.0], ids=["alpha_off", "alpha0"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("loss", ["gpnn_lm", "gpnn"])
def test_gpnn_losses_match_jax(loss, case, alpha, bf16, f32_fold):
    """The loss within 1e-5 relative of JAX's and its gradient with
    respect to the render within 1e-5 * max|g| (the NN target carries
    no gradient in either package)."""
    cfg = dict(LOSS_CASES[case], alpha=alpha, nn_bf16=bf16)
    if loss == "gpnn":
        cfg.pop("macro_block")
    x, y = _inputs(2, "f32")
    jfn = {"gpnn_lm": J.gpnn_lowmem_loss, "gpnn": J.gpnn_direct_loss}[loss]
    jl, jg = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(y), **cfg))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = T.LOSS_FNS[loss](tx, torch.from_numpy(y), **cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(tx.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


@pytest.mark.parametrize("loss", ["mse", "avg"])
def test_video_losses_match_jax(loss):
    x, y = _inputs(3, "f32")
    jfn = {"mse": J.video_mse_loss, "avg": J.video_avg_loss}[loss]
    jl, jg = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(y)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = T.LOSS_FNS[loss](tx, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-9)


BAND_CASES = {"3x3x3": ((3, 3, 3), (1, 2, 2), 11),
              "3x5x5": ((3, 5, 5), (1, 2, 2), 13),
              "4x3x3_st2": ((4, 3, 3), (2, 2, 2), 11)}


def _jax_band_dist(x, y, plan, bf16):
    """JAX's temporally decomposed distances on the crops of `plan`: the
    per-frame `_pairwise_sqdist` and `banded_temporal_dist`, (n_crops,
    columns, ntx, nty)."""
    (pt, p, _), (st, s, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    ft, fh, fw = plan.fit
    mh, mw = plan.crop_hw
    dt = jnp.bfloat16 if bf16 else jnp.float32
    xs = jnp.asarray(x, dt)[:, :ft, :fh, :fw]
    ys = jnp.asarray(y, dt)[:, :plan.fit_ty, :fh, :fw]
    out = []
    for h0 in plan.hs:
        for w0 in plan.ws:
            P = [J.extract_patches_3d(v[..., h0:h0 + mh, w0:w0 + mw],
                                      (1, p, p), (1, s, s)) for v in (xs, ys)]
            Xf, Yf = (q.reshape(q.shape[0], -1, int(np.prod(q.shape[3:])))
                      .transpose(1, 0, 2) for q in P)
            d1 = J._pairwise_sqdist(Xf, Yf)
            out.append(np.asarray(J.banded_temporal_dist(d1, pt, st, ntx,
                                                         nty)))
    return np.stack(out)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_band_search_and_err_match_jax(case, alpha, dtype, f32_fold):
    """K18's plain version: its rows equal the argmin of JAX's banded
    distances / pt with alpha (`_nn_retarget_temporal`'s search) and its
    columns the argmin of the transposed distances (the eval's reverse
    direction), exactly (random inputs have no near ties); K12 on its
    rows equals JAX's --fast_nn_dist retarget within 1e-6; K19's plain
    version gives the per-crop sums of `eval/nnmse.py`'s sel_err within
    1e-6 relative."""
    psz, strides, macro = BAND_CASES[case]
    bf16 = dtype == "bf16"
    x, y = _inputs(5, dtype)
    C, Tx, H, W = x.shape
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if bf16:
        tx, ty = tx.to(torch.bfloat16), ty.to(torch.bfloat16)
    plan = T.lowmem_plan(Tx, y.shape[1], H, W, psz, strides, macro)
    assert len(plan.hs) * len(plan.ws) > 1
    dist = _jax_band_dist(x, y, plan, bf16)
    rows, cols = T.nn_band_argmin(tx, ty, plan, alpha, scale_by_pt=True,
                                  both_directions=True)
    want = np.stack([np.asarray(J.nn_indices_from_dist(
        jnp.asarray(d / psz[0]), alpha)) for d in dist])
    np.testing.assert_array_equal(rows.numpy(), want)
    want_cols = np.stack([np.asarray(J.nn_indices_from_dist(
        jnp.asarray(d / psz[0]).transpose(0, 2, 1), None)) for d in dist])
    if alpha is None:
        np.testing.assert_array_equal(cols.numpy(), want_cols)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    if bf16:
        jx, jy = jx.astype(jnp.bfloat16), jy.astype(jnp.bfloat16)
    jt, _ = J.gpnn_lowmem_retarget(
        jx, jy, patch_size=psz[1], patcht_size=psz[0], stride=strides[1],
        stridet=strides[0], alpha=alpha, macro_block=macro,
        fast_nn_dist=True)
    assert np.abs(T.nn_fold(ty, rows, plan).numpy()
                  - np.asarray(jt)).max() <= 1e-6
    # sel_err's sum, per crop: frame k of every temporal patch, selected
    (pt, p, _), (st, s, _) = psz, strides
    ntx, nty = plan.grid[:2]
    ft, fh, fw = plan.fit
    mh, mw = plan.crop_hw
    xs = x.astype(np.float64)[:, :ft, :fh, :fw]
    ys = y.astype(np.float64)[:, :plan.fit_ty, :fh, :fw]
    for nn, reverse in ((rows, False), (cols, True)):
        got = T.nn_band_err(tx, ty, plan, nn, reverse).numpy()
        src, tar = (ys, xs) if reverse else (xs, ys)
        ns = nty if reverse else ntx
        want = []
        for ci, (h0, w0) in enumerate((h, w) for h in plan.hs
                                      for w in plan.ws):
            sc = src[..., h0:h0 + mh, w0:w0 + mw]
            tc = tar[..., h0:h0 + mh, w0:w0 + mw]
            total = 0.0
            for col in range(nn.shape[1]):
                r0, c0 = (col // ((mw - p) // s + 1)) * s, \
                    (col % ((mw - p) // s + 1)) * s
                for i in range(ns):
                    j = int(nn[ci, col, i])
                    a = sc[:, i * st:i * st + pt, r0:r0 + p, c0:c0 + p]
                    b = tc[:, j * st:j * st + pt, r0:r0 + p, c0:c0 + p]
                    total += np.abs(b - a).sum()
            want.append(total)
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("alpha", [1e4, 0.0], ids=["alpha_off", "alpha0"])
@pytest.mark.parametrize("case", list(LOSS_CASES))
@pytest.mark.parametrize("loss", ["gpnn_lm", "gpnn"])
def test_gpnn_losses_fast_nn_dist_match_jax(loss, case, alpha, f32_fold):
    """With fast_nn_dist (the temporally decomposed search, K18): the
    loss within 1e-5 relative of JAX's and its gradient within 1e-5 *
    max|g|, as the direct search's losses are held."""
    cfg = dict(LOSS_CASES[case], alpha=alpha, fast_nn_dist=True)
    if loss == "gpnn":
        cfg.pop("macro_block")
    x, y = _inputs(6, "f32")
    jfn = {"gpnn_lm": J.gpnn_lowmem_loss, "gpnn": J.gpnn_direct_loss}[loss]
    jl, jg = jax.value_and_grad(lambda a: jfn(a, jnp.asarray(y), **cfg))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = T.LOSS_FNS[loss](tx, torch.from_numpy(y), **cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(tx.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_fast_nn_dist_takes_the_band_search_only_for_pt_above_1(monkeypatch):
    """JAX's rule: the temporally decomposed search only where pt > 1."""
    calls = []
    band = T.nn_band_argmin
    monkeypatch.setattr(T, "nn_band_argmin",
                        lambda *a, **k: calls.append(1) or band(*a, **k))
    x, y = (torch.from_numpy(v) for v in _inputs(7, "f32"))
    for pt, want in ((3, 1), (1, 0)):
        calls.clear()
        T.gpnn_lowmem_loss(x, y, patch_size=3, patcht_size=pt, stride=2,
                           stridet=1, macro_block=11, fast_nn_dist=True)
        assert len(calls) == want


def test_distance_not_ported_raises():
    x, y = _inputs(4, "f32")
    with pytest.raises(NotImplementedError, match="ssim"):
        T.gpnn_lowmem_loss(torch.from_numpy(x), torch.from_numpy(y),
                           dist_fn="ssim")
