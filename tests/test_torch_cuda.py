"""The port's CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA GPU and nvcc (the kernels are built from
videoloop3d_torch/csrc at first use); every test skips without CUDA.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from videoloop3d_torch import kernels
from videoloop3d_torch.losses import patch_nn as PN
from videoloop3d_torch.render import compact as CP
from videoloop3d_torch.render import fused as FU
from videoloop3d_torch.render import fused_s1 as F1
from videoloop3d_torch.render import renderer as R
from videoloop3d_torch.render import sample as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _samples(n_tiles, th, tw, shape, seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(-1, n_tiles, shape).astype(np.int32)
    u = rng.uniform(-0.5, tw - 0.5, shape).astype(np.float32)
    v = rng.uniform(-0.5, th - 0.5, shape).astype(np.float32)
    u.reshape(-1)[:40] = tw - 1
    v.reshape(-1)[20:60] = th - 1
    return [torch.from_numpy(a) for a in (k, u, v)]


def test_warp_lookup_kernel(cuda):
    """Bit-exact against the plain version on the card: both evaluate the
    warp with one rounding per operation in the same order."""
    rng = np.random.default_rng(0)
    D, h, w, nth, ntw = 7, 40, 56, 5, 6
    G = np.zeros((2, D, 3, 3), np.float32)
    for b in range(2):
        for d in range(D):
            G[b, d] = np.diag([1.2, 1.1, 0.05 * (d + 1)]) \
                + rng.normal(0, 0.02, (3, 3))
            G[b, d, :2, 2] = rng.uniform(-4, 8, 2)
    G = torch.from_numpy(G).to(cuda)
    maps = [torch.from_numpy(rng.integers(-1, 30, (D, nth, ntw))
                             .astype(np.int32)).to(cuda) for _ in range(2)]
    args = (G, *maps, h, w, (64, 71), (63 / nth, 70 / ntw))
    before = kernels.LAUNCHES["warp_lookup"]
    got = R.warp_lookup(*args)
    assert kernels.LAUNCHES["warp_lookup"] == before + 1
    ref = R.warp_lookup_plain(*args)
    for a, b in zip(list(got[0]) + list(got[1:]), list(ref[0]) + list(ref[1:])):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert 0 < got[0].valid.float().mean() < 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_tiles_kernel(cuda, dtype):
    tiles = torch.randn((29, 6, 7, 4), generator=torch.Generator().manual_seed(1)
                        ).to(dtype).to(cuda)
    k, u, v = (t.to(cuda) for t in _samples(29, 6, 7, (5, 30, 40), 2))
    got, valid = S.bilinear_tiles(tiles, k, u, v)
    ref, _ = S.bilinear_tiles_plain(tiles, k, u, v)
    assert got.dtype == torch.float32
    assert (got - ref).abs().max() <= 1e-6
    assert torch.equal(valid, k >= 0)
    cpu, _ = S.bilinear_tiles(tiles.cpu(), k.cpu(), u.cpu(), v.cpu())
    assert (got.cpu() - cpu).abs().max() <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ts", [None, [5, 0, 3]])
def test_bilinear_tiles_tilemajor_kernel(cuda, dtype, ts):
    tiles = torch.randn((17, 6, 7, 6, 4),
                        generator=torch.Generator().manual_seed(3)
                        ).to(dtype).to(cuda)
    k, u, v = (t.to(cuda) for t in _samples(17, 6, 7, (5, 30, 40), 4))
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32,
                                               device=cuda)
    got, _ = S.bilinear_tiles_tilemajor(tiles, k, u, v, tts)
    ref, _ = S.bilinear_tiles_tilemajor_plain(tiles, k, u, v, tts)
    assert got.shape == (5, 30, 40, 6 if ts is None else 3, 4)
    assert (got - ref).abs().max() <= 1e-6


def test_bilinear_tiles_grad_kernel(cuda):
    """K9 within 1e-5 * max|g| of its plain version (atomics add in no
    fixed order), also for samples clamped at the tile edges and with
    non-finite coordinates where k < 0; through `sample_tiles`, one launch
    of K2 and one of K9; N = 0 launches nothing."""
    shape = (5, 30, 40)
    k, u, v = (t.to(cuda) for t in _samples(29, 6, 7, shape, 6))
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    ct = torch.randn(shape + (4,), generator=torch.Generator().manual_seed(7)
                     ).to(cuda)
    tiles = torch.randn((29, 6, 7, 4), generator=torch.Generator()
                        .manual_seed(8)).to(cuda).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals, _ = S.sample_tiles(tiles, k, u, v)
    (vals * ct).sum().backward()
    assert kernels.LAUNCHES["bilinear_tiles"] == before["bilinear_tiles"] + 1
    assert kernels.LAUNCHES["bilinear_tiles_grad"] == \
        before["bilinear_tiles_grad"] + 1
    ref = S.bilinear_tiles_grad_plain(ct, k, u, v, tiles.shape)
    assert torch.isfinite(tiles.grad).all()
    assert (tiles.grad - ref).abs().max() <= 1e-5 * ref.abs().max()
    cpu = S.bilinear_tiles_grad(ct.cpu(), k.cpu(), u.cpu(), v.cpu(),
                                tiles.shape)
    assert (tiles.grad.cpu() - cpu).abs().max() <= 1e-5 * cpu.abs().max()
    empty = S.bilinear_tiles_grad(ct, torch.full_like(k, -1), u, v,
                                  (0, 6, 7, 4))
    assert empty.shape == (0, 6, 7, 4)
    assert kernels.LAUNCHES["bilinear_tiles_grad"] == \
        before["bilinear_tiles_grad"] + 1


def test_empty_atlas_launches_nothing(cuda):
    k = torch.full((3, 4), -1, dtype=torch.int32, device=cuda)
    u = torch.zeros((3, 4), device=cuda)
    before = dict(kernels.LAUNCHES)
    out, _ = S.bilinear_tiles(torch.zeros((0, 6, 7, 4), device=cuda), k, u, u)
    assert out.shape == (3, 4, 4) and not out.any()
    assert kernels.LAUNCHES == before


def test_composite_kernel(cuda):
    """1e-5: the same operation order; expf may differ from PyTorch's
    sigmoid in the last ulp."""
    g = torch.Generator().manual_seed(5)
    S_, h, w, F = 9, 20, 24, 6
    vals_s = torch.randn((S_, h, w, 4), generator=g).to(cuda)
    vals_d = torch.randn((S_, h, w, F, 4), generator=g).to(cuda)
    m_s, hit_d, m_d = ((torch.rand((S_, h, w), generator=g) < p).to(cuda)
                       for p in (0.6, 0.4, 0.3))
    out, asum = FU.composite(vals_s, m_s, vals_d, hit_d, m_d)
    pout, pasum = FU.composite_plain(vals_s, m_s, vals_d, hit_d, m_d)
    assert (out - pout).abs().max() <= 1e-5
    assert (asum - pasum).abs().max() <= 1e-5


def test_wrapper_rejects_mixed_devices(cuda):
    tiles = torch.zeros((3, 6, 7, 4), device=cuda)
    k = torch.zeros((2, 3), dtype=torch.int32)
    u = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="expected cuda"):
        S.bilinear_tiles(tiles, k, u, u)


def _dense_inputs(seed, B=2, D=3, h=20, w=24, Ht=30, Wt=40):
    rng = np.random.default_rng(seed)
    atlas = rng.standard_normal((D, Ht, Wt, 4)).astype(np.float32)
    mask = rng.standard_normal((D, Ht, Wt, 1)).astype(np.float32)
    x = rng.uniform(-3, Wt + 2, (B, D, h, w)).astype(np.float32)
    y = rng.uniform(-3, Ht + 2, (B, D, h, w)).astype(np.float32)
    x.reshape(-1)[:50] = 1e9            # far off the plane / behind it
    y.reshape(-1)[50:90] = -4e12
    x.reshape(-1)[90:120] = np.floor(x.reshape(-1)[90:120])
    g = rng.standard_normal((B, D, h, w, 4)).astype(np.float32)
    gm = rng.standard_normal((B, D, h, w, 1)).astype(np.float32)
    return [torch.from_numpy(a) for a in (atlas, mask, x, y, g, gm)]


def test_sample_dense_kernels(cuda):
    """K5 equals the plain version bit for bit (same lerps, one rounding
    each); K6, whose atomics add in no fixed order, is within
    1e-5 * max|g| of the plain version's autograd gradient; both through
    the autograd.Function, one launch each."""
    atlas, mask, x, y, g, gm = (t.to(cuda) for t in _dense_inputs(0))
    a = atlas.clone().requires_grad_(True)
    m = mask.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    feats, mfeats = S.sample_dense(a, m, x, y)
    assert torch.equal(feats, S.bilinear_planes_plain(atlas, x, y))
    assert torch.equal(mfeats, S.bilinear_planes_plain(mask, x, y))
    ((feats * g).sum() + (mfeats * gm).sum()).backward()
    for got, cot, shape in ((a.grad, g, atlas.shape), (m.grad, gm, mask.shape)):
        ref = S.bilinear_planes_grad_plain(cot, x, y, shape)
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert kernels.LAUNCHES["sample_dense"] == before["sample_dense"] + 1
    assert kernels.LAUNCHES["sample_dense_grad"] == \
        before["sample_dense_grad"] + 1
    cpu_feats, _ = S.sample_dense(atlas.cpu(), None, x.cpu(), y.cpu())
    assert (feats.cpu() - cpu_feats).abs().max() <= 1e-6


def test_warp_lookup_noise_kernel(cuda):
    """K1 with uv-noise draws bit for bit against its plain version (the
    draws added after valid, before the tile index); without draws K1's
    outputs are those of the kernel before the draws existed (the plain
    version without noise)."""
    rng = np.random.default_rng(1)
    D, h, w, nth, ntw = 6, 36, 44, 5, 6
    G = np.zeros((1, D, 3, 3), np.float32)
    for d in range(D):
        G[0, d] = np.diag([1.1, 1.2, 0.04 * (d + 1)]) \
            + rng.normal(0, 0.02, (3, 3))
        G[0, d, :2, 2] = rng.uniform(-4, 8, 2)
    G = torch.from_numpy(G).to(cuda)
    maps = [torch.from_numpy(rng.integers(-1, 30, (D, nth, ntw))
                             .astype(np.int32)).to(cuda) for _ in range(2)]
    nx, ny = (torch.from_numpy(rng.uniform(-1, 1, (1, D, h, w))
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    args = (G, *maps, h, w, (52, 61), (51 / nth, 60 / ntw))
    plain = R.warp_lookup_plain(*args)
    for extra in ((), (nx, ny)):
        got = R.warp_lookup(*args, *extra)
        ref = R.warp_lookup_plain(*args, *extra)
        for a, b in zip(list(got[0]) + list(got[1:]),
                        list(ref[0]) + list(ref[1:])):
            assert torch.equal(a, b)
    assert torch.equal(got[0].valid, plain[0].valid)
    assert torch.equal(got[0].x, plain[0].x + nx)
    assert not torch.equal(got[1], plain[1])


def _plane_inputs(seed, D=3, N=(20, 24), Ht=30, Wt=40, F=6):
    rng = np.random.default_rng(seed)
    tex = rng.standard_normal((D, Ht, Wt, F, 4)).astype(np.float32)
    x = rng.uniform(-3, Wt + 2, (D,) + N).astype(np.float32)
    y = rng.uniform(-3, Ht + 2, (D,) + N).astype(np.float32)
    x.reshape(-1)[:50] = 1e9            # far off the plane
    y.reshape(-1)[50:90] = -4e12
    x.reshape(-1)[90:120] = np.floor(x.reshape(-1)[90:120])
    x.reshape(-1)[120:130] = Wt - 1
    y.reshape(-1)[130:140] = Ht - 1
    ct = rng.standard_normal((D,) + N + (F, 4)).astype(np.float32)
    return [torch.from_numpy(a) for a in (tex, x, y, ct)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ts", [None, [5, 0, 3, 3]])
def test_bilinear_planes_tilemajor_kernels(cuda, dtype, ts):
    """K16 equals its plain version bit for bit (same lerps, one rounding
    each; corners off the plane read zero, far-off coordinates included);
    K17, whose atomics add in no fixed order, is within 1e-5 * max|g| of
    its plain version; through `sample_planes_tilemajor` one launch of
    each, the f32 sum rounded once to the texels' dtype."""
    tex, x, y, ct = (t.to(cuda) for t in _plane_inputs(2))
    tex = tex.to(dtype)
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32,
                                               device=cuda)
    got = S.bilinear_planes_tilemajor(tex, x, y, tts)
    ref = S.bilinear_planes_tilemajor_plain(tex, x, y, tts)
    assert got.shape == x.shape + (6 if ts is None else 4, 4)
    assert torch.equal(got, ref)
    cpu = S.bilinear_planes_tilemajor(tex.cpu(), x.cpu(), y.cpu(),
                                      None if ts is None else tts.cpu())
    assert torch.equal(got.cpu(), cpu)
    if ts is not None:
        return
    t = tex.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals = S.sample_planes_tilemajor(t, x, y)
    (vals * ct).sum().backward()
    for name in ("bilinear_planes_tilemajor",
                 "bilinear_planes_tilemajor_grad"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    gref = S.bilinear_planes_tilemajor_grad_plain(ct, x, y, tex.shape)
    g17 = S.bilinear_planes_tilemajor_grad(ct, x, y, tex.shape)
    assert torch.isfinite(g17).all()
    assert (g17 - gref).abs().max() <= 1e-5 * gref.abs().max()
    assert t.grad.dtype == dtype
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (t.grad.float() - gref.to(dtype).float()).abs().max() <= \
        tol * gref.abs().max()


def test_bilinear_planes_tilemajor_past_2_31_elements(cuda):
    """K16/K17 index a (2, 1024, 1024, 260, 4) bf16 stack, 2.18 G elements
    (past 2^31), with 64-bit offsets: samples in the last rows of the last
    plane read and write the same texels as the plain version."""
    D, Ht, Wt, F = 2, 1024, 1024, 260
    tex = torch.empty((D, Ht, Wt, F, 4), dtype=torch.bfloat16, device=cuda)
    tex.view(-1)[-(8 * Wt * F * 4):].copy_(torch.randn(
        8 * Wt * F * 4, generator=torch.Generator(device=cuda).manual_seed(3),
        device=cuda))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, Wt - 1, (D, 64)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(Ht - 6, Ht - 1, (D, 64))
                         .astype(np.float32))
    x, y = x.to(cuda), y.to(cuda)
    got = S.bilinear_planes_tilemajor(tex, x, y)
    ref = S.bilinear_planes_tilemajor_plain(tex, x, y)
    assert torch.equal(got[1], ref[1])
    ct = torch.ones((D, 64, F, 4), device=cuda)
    g = S.bilinear_planes_tilemajor_grad(ct, x, y, tex.shape)
    assert float(g[1, Ht - 7:].sum()) == pytest.approx(64 * F * 4, rel=1e-4)
    del tex, g


FUSED_FLAGS = [(True, True, True, True, True, True),
               (True, True, True, False, True, False),
               (False, False, False, False, False, False)]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("flags", FUSED_FLAGS)
def test_fused_s1_kernels(cuda, flags, B):
    """K7 and K8 against the plain forward and backward on the card:
    per-pixel outputs and gradients to 1e-5 (same operation order; only
    expf may differ in the last ulp), the regularizer sums to 1e-5
    relative (K7 reduces in a fixed tree order)."""
    sp, rs, as_, ls, loop, disp = flags
    D, h, w = 7, 13, 17
    cfg = F1.FusedS1Cfg(D, sp, rs, as_, ls, loop, disp)
    gen = torch.Generator().manual_seed(B)
    feats = (2 * torch.randn((B, D, h, w, 4), generator=gen)).to(cuda)
    valid = (torch.rand((B, D, h, w), generator=gen) < 0.75).to(cuda)
    mask = torch.randn((B, D, h, w), generator=gen).to(cuda)
    dinv = torch.rand((B, D, h, w), generator=gen).to(cuda)
    cts = [torch.randn(s, generator=gen).to(cuda)
           for s in ((B, h, w, 3), (B, h, w), (B, h, w), (B, h, w, 1), (4,))]
    f = feats.clone().requires_grad_(True)
    mk = mask.clone().requires_grad_(True) if loop else None
    before = dict(kernels.LAUNCHES)
    out, asum, dsp, lab, regs = F1.fused_composite_s1(
        cfg, f, valid, mk, dinv if disp else None)
    ref = F1.fused_composite_s1_plain_fwd(cfg, feats, valid, mask, dinv)
    for a, b in ((out, ref[0]), (asum, ref[1]), (dsp, ref[2]),
                 (lab, ref[3])):
        if a is not None:
            assert (a.detach() - b).abs().max() <= 1e-5
    for i, k in enumerate(F1.REG_NAMES):
        if k in regs:
            assert abs(float(regs[k]) - float(ref[4][i])) <= \
                1e-5 * abs(float(ref[4][i])) + 1e-7
    total = (out * cts[0]).sum() + (asum * cts[1]).sum()
    if disp:
        total = total + (dsp * cts[2]).sum()
    if loop:
        total = total + (lab * cts[3]).sum()
    for i, k in enumerate(F1.REG_NAMES):
        if k in regs:
            total = total + regs[k] * cts[4][i]
    total.backward()
    g_regs = cts[4].clone()
    d_feats, d_mask = F1.fused_composite_s1_plain_bwd(
        cfg, feats, valid, mask, dinv, cts[0], cts[1], cts[2], cts[3],
        g_regs)
    assert (f.grad - d_feats).abs().max() <= 1e-5 * d_feats.abs().max()
    if loop:
        assert (mk.grad - d_mask).abs().max() <= 1e-5 * d_mask.abs().max()
    assert kernels.LAUNCHES["fused_s1_fwd"] == before["fused_s1_fwd"] + 1
    assert kernels.LAUNCHES["fused_s1_bwd"] == before["fused_s1_bwd"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_tiles_tilemajor_grad_kernel(cuda, dtype):
    """K10 within 1e-5 * max|g| of its plain version (atomics add in no
    fixed order), with non-finite coordinates where k < 0; through
    `sample_tiles` on 5-D tiles one launch of K3 and one of K10, and for
    bf16 tiles the f32 sum rounded once to bf16 (one bf16 ulp)."""
    shape = (5, 30, 40)
    k, u, v = (t.to(cuda) for t in _samples(17, 6, 7, shape, 9))
    v = torch.where(k < 0, torch.full_like(v, float("inf")), v)
    gen = torch.Generator().manual_seed(10)
    ct = torch.randn(shape + (6, 4), generator=gen).to(cuda)
    tiles = torch.randn((17, 6, 7, 6, 4), generator=gen).to(dtype).to(cuda)
    t = tiles.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals, _ = S.sample_tiles(t, k, u, v)
    (vals * ct).sum().backward()
    for name in ("bilinear_tiles_tilemajor", "bilinear_tiles_tilemajor_grad"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    ref = S.bilinear_tiles_tilemajor_grad_plain(ct, k, u, v, tiles.shape)
    got = S.bilinear_tiles_tilemajor_grad(ct, k, u, v, tiles.shape)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert t.grad.dtype == dtype
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert (t.grad.float() - ref.to(dtype).float()).abs().max() <= \
        tol * ref.abs().max()


def _nn_inputs(cuda, dtype, seed, C=3, Tx=10, Ty=8, H=27, W=33):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((C, Tx, H, W), generator=gen)
    y = torch.rand((C, Ty, H, W), generator=gen)
    return x.to(dtype).to(cuda), y.to(dtype).to(cuda)


NN_CASES = {"3x3x3": ((3, 3, 3), (1, 2, 2), 13),
            "3x5x5": ((3, 5, 5), (1, 2, 2), 13),
            "3x11x11": ((3, 11, 11), (1, 4, 4), 23)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(NN_CASES))
def test_nn_kernels(cuda, case, alpha, dtype):
    """K11's indices equal its plain version's except at near ties of
    the plain distances (1e-5 relative: the two sum in another order);
    K12 on K11's indices within 1e-5 of its plain version; the
    macro-block crop plan (clamped last crop) and the one-crop direct
    plan; one launch each."""
    psz, strides, macro = NN_CASES[case]
    x, y = _nn_inputs(cuda, dtype, 11)
    C, Tx, H, W = x.shape
    for plan in (PN.lowmem_plan(Tx, y.shape[1], H, W, psz, strides, macro),
                 PN.direct_plan(Tx, y.shape[1], H, W, psz, strides)):
        before = dict(kernels.LAUNCHES)
        nn = PN.nn_argmin(x, y, plan, alpha)
        dist = PN.nn_dist_plain(x, y, plan, alpha)
        ref = torch.argmin(dist, dim=3).to(torch.int32)
        assert nn.shape == ref.shape and nn.dtype == torch.int32
        flips = nn != ref
        if flips.any():
            dk = torch.gather(dist, 3, nn.long()[..., None])[..., 0][flips]
            dp = torch.gather(dist, 3, ref.long()[..., None])[..., 0][flips]
            assert ((dk - dp).abs() <= 1e-5 * dp.abs()).all()
        out = PN.nn_fold(y, nn, plan)
        assert (out - PN.nn_fold_plain(y, nn, plan)).abs().max() <= 1e-5
        for name in ("nn_argmin", "nn_fold"):
            assert kernels.LAUNCHES[name] == before[name] + 1


def test_nn_argmin_first_index_and_nan(cuda):
    """Exact duplicates among the y patches: the first index wins; a
    column whose minimum is exactly 0 under alpha 0 gives 0/0 = NaN and
    the first NaN wins, as torch.argmin and jnp.argmin choose (values on
    a 1/4 grid, so every sum is exact on both sides)."""
    gen = torch.Generator().manual_seed(12)
    y = torch.randint(0, 4, (3, 8, 9, 9), generator=gen).float() / 4
    y[:, 4:] = y[:, :4]                     # frames 4-7 repeat frames 0-3
    x = torch.randint(0, 4, (3, 6, 9, 9), generator=gen).float() / 4
    x[:, 1:4] = y[:, 1:4]                   # patch 1 of x equals y patch 1
    x, y = x.to(cuda), y.to(cuda)
    plan = PN.direct_plan(6, 8, 9, 9, (3, 3, 3), (1, 2, 2))
    for alpha in (None, 0.0):
        nn = PN.nn_argmin(x, y, plan, alpha)
        assert torch.equal(nn, PN.nn_argmin_plain(x, y, plan, alpha))
    assert (PN.nn_argmin(x, y, plan, None)[..., 1] == 1).all()


BAND_CASES = {"3x3x3": ((3, 3, 3), (1, 2, 2), 13),
              "3x11x11": ((3, 11, 11), (1, 4, 4), 23),
              "7x5x5": ((7, 5, 5), (1, 2, 2), 17),
              "4x5x5_st2": ((4, 5, 5), (2, 2, 2), 17)}


def _band_flips_are_near_ties(dist, nn, ref, dim):
    """Indices that differ from the plain version's lie on near ties of
    the plain distances: within 1e-5 of their size (the kernel sums the
    per-frame dot products in another order)."""
    flips = nn != ref
    if flips.any():
        dk = torch.gather(dist, dim, nn.long().unsqueeze(dim)).squeeze(dim)
        dp = torch.gather(dist, dim, ref.long().unsqueeze(dim)).squeeze(dim)
        assert ((dk - dp)[flips].abs() <= 1e-5 * dp[flips].abs()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(BAND_CASES))
def test_nn_band_kernels(cuda, case, alpha, dtype):
    """K18's rows (with /pt, as training) and columns (the eval's reverse
    direction) equal its plain version's except at near ties; K19 on
    K18's own indices within 1e-6 relative of its plain version (f32 sums
    in another order), both directions; one launch each."""
    psz, strides, macro = BAND_CASES[case]
    x, y = _nn_inputs(cuda, dtype, 13, Tx=12, Ty=9)
    C, Tx, H, W = x.shape
    plan = PN.lowmem_plan(Tx, y.shape[1], H, W, psz, strides, macro)
    before = dict(kernels.LAUNCHES)
    rows, cols = PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt=True,
                                   both_directions=True)
    dist = PN.nn_band_dist_plain(x, y, plan, alpha, scale_by_pt=True)
    ref_rows, ref_cols = PN.nn_band_argmin_plain(
        x, y, plan, alpha, scale_by_pt=True, both_directions=True)
    assert rows.shape == ref_rows.shape and cols.shape == ref_cols.shape
    _band_flips_are_near_ties(dist, rows, ref_rows, 3)
    _band_flips_are_near_ties(dist, cols, ref_cols, 2)
    for nn, reverse in ((rows, False), (cols, True)):
        got = PN.nn_band_err(x, y, plan, nn, reverse)
        want = PN.nn_band_err_plain(x, y, plan, nn, reverse)
        assert ((got - want).abs() <= 1e-6 * want.abs()).all()
    assert kernels.LAUNCHES["nn_band_argmin"] == before["nn_band_argmin"] + 1
    assert kernels.LAUNCHES["nn_band_err"] == before["nn_band_err"] + 2
    rows2, none = PN.nn_band_argmin(x, y, plan, alpha)
    assert none is None
    _band_flips_are_near_ties(PN.nn_band_dist_plain(x, y, plan, alpha),
                              rows2, PN.nn_band_argmin_plain(
                                  x, y, plan, alpha)[0], 3)


def test_nn_band_exact_ties(cuda):
    """u8-valued clips whose y repeats a stretch of frames: equal temporal
    patches get bit-equal distances in K18, so it picks the first of them
    as the plain version does, in both directions, and K19 equals its
    plain version (integer sums below 2^24 are exact in any order)."""
    gen = torch.Generator().manual_seed(14)
    x = torch.randint(0, 128, (3, 12, 30, 34), generator=gen).float()
    y = torch.randint(0, 128, (3, 10, 30, 34), generator=gen).float()
    y[:, 6:] = y[:, 1:5]
    x[:, 3:8] = y[:, 1:6]
    x, y = x.to(cuda), y.to(cuda)
    plan = PN.lowmem_plan(12, 10, 30, 34, (3, 5, 5), (1, 2, 2), 17)
    rows, cols = PN.nn_band_argmin(x, y, plan, both_directions=True)
    ref_rows, ref_cols = PN.nn_band_argmin_plain(x, y, plan,
                                                 both_directions=True)
    assert torch.equal(rows, ref_rows) and torch.equal(cols, ref_cols)
    assert (rows[..., 3] == 1).all()     # x patch 3 equals y patches 1, 6
    for nn, reverse in ((rows, False), (cols, True)):
        assert torch.equal(PN.nn_band_err(x, y, plan, nn, reverse),
                           PN.nn_band_err_plain(x, y, plan, nn, reverse))


@pytest.mark.parametrize("shape", [(10, 20, 24, 4), (32, 180, 320, 15)],
                         ids=["small", "production"])
def test_compact_sweep_kernel(cuda, shape):
    """K13 equals its plain version array for array (copies only), with
    pixels of more hits than S (the farthest dropped) and all-miss
    pixels; one launch."""
    D, h, w, S = shape
    gen = torch.Generator().manual_seed(D)
    hit = torch.rand((D, h, w), generator=gen) < 0.35
    hit[:, 0] = True
    hit[:, :, 0] = False
    both = torch.rand((D, h, w), generator=gen)
    k = torch.randint(0, 900, (D, h, w), generator=gen, dtype=torch.int32)
    k_s = torch.where(hit & (both < 0.7), k, -1)
    k_d = torch.where(hit & (both > 0.4), k + 7, -1)
    fu, fv, z = (torch.rand((D, h, w), generator=gen) for _ in range(3))
    valid = torch.rand((D, h, w), generator=gen) < 0.9
    args = [t.to(cuda) for t in (k_s, k_d, fu, fv, valid, z)]
    before = kernels.LAUNCHES["compact_sweep"]
    got = CP.compact_sweep(*args, S)
    assert kernels.LAUNCHES["compact_sweep"] == before + 1
    ref = CP.compact_sweep_plain(*args, S)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape == (S, h, w)
        assert torch.equal(a, b)
    assert (got.k_s[:, :, 0] == -1).all() and not got.valid[:, :, 0].any()
    cpu = CP.compact_sweep(*(t.cpu() for t in args), S)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))


FUSED_S2_FLAGS = [(True, True, True, True), (False, True, True, False),
                  (False, False, False, False)]


def _fused_s2_inputs(cuda, S, h, w, F, seed):
    gen = torch.Generator().manual_seed(seed)
    vals_s = (2 * torch.randn((S, h, w, 4), generator=gen)).to(cuda)
    vals_d = (2 * torch.randn((S, h, w, F, 4), generator=gen)).to(cuda)
    m_s, hit_d, m_d = ((torch.rand((S, h, w), generator=gen) < p).to(cuda)
                       for p in (0.7, 0.4, 0.6))
    dinv = torch.rand((S, h, w), generator=gen).to(cuda)
    cts = [torch.randn(s, generator=gen).to(cuda)
           for s in ((h, w, F, 3), (h, w, F), (h, w, F), (3,))]
    return (vals_s, m_s, vals_d, hit_d, m_d), dinv, cts


@pytest.mark.parametrize("shape", [(7, 13, 17, 5), (15, 180, 320, 50),
                                   (32, 180, 320, 50)],
                         ids=["small", "production", "slots=D"])
@pytest.mark.parametrize("flags", FUSED_S2_FLAGS)
def test_fused_s2_kernels(cuda, flags, shape):
    """K14 and K15 through `fused_composite` against the plain forward and
    backward on the card: outputs within 1e-6, the regularizer sums within
    2e-5 relative (K14 reduces in a fixed tree order), the texel
    cotangents within 2e-5 * max|g|; one launch each; and a second K14
    and K15 call equal to the first bit for bit."""
    S, h, w, F = shape
    cfg = FU.FusedCfg(32, *flags)
    ins, dinv, cts = _fused_s2_inputs(cuda, S, h, w, F, S)
    dv = dinv if cfg.want_disp else None
    vs = ins[0].clone().requires_grad_(True)
    vd = ins[2].clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out, asum, disp, regs = FU.fused_composite(cfg, vs, ins[1], vd, ins[3],
                                               ins[4], dv)
    ref = FU.fused_composite_fwd_plain(cfg, *ins, dv)
    for a, b in ((out, ref[0]), (asum, ref[1]), (disp, ref[2])):
        if a is not None:
            assert (a.detach() - b).abs().max() <= 1e-6
    for i, k in enumerate(FU.REG_NAMES):
        if k in regs:
            assert abs(float(regs[k]) - float(ref[3][i])) <= \
                2e-5 * abs(float(ref[3][i])) + 1e-8
    total = (out * cts[0]).sum() + (asum * cts[1]).sum()
    if disp is not None:
        total = total + (disp * cts[2]).sum()
    for i, k in enumerate(FU.REG_NAMES):
        if k in regs:
            total = total + regs[k] * cts[3][i]
    total.backward()
    g_regs = cts[3].clone()
    d_s, d_d = FU.fused_composite_bwd_plain(cfg, *ins, dv, cts[0], cts[1],
                                            cts[2], g_regs)
    for got, want in ((vs.grad, d_s), (vd.grad, d_d)):
        assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    for name in ("fused_s2_fwd", "fused_s2_bwd"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    a14 = FU.fused_s2_fwd(cfg, *ins, dv)
    b14 = FU.fused_s2_fwd(cfg, *ins, dv)
    a15 = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
    b15 = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
    assert all(torch.equal(a, b) for a, b in zip(a14 + a15, b14 + b15))
