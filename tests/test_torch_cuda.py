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
from videoloop3d_torch.first_designs import (
    bilinear_planes_tilemajor_first, bilinear_planes_tilemajor_grad_first,
    bilinear_tiles_coord_grad_first, bilinear_tiles_first,
    bilinear_tiles_grad_atomic, bilinear_tiles_grad_first,
    bilinear_tiles_tilemajor_first, compact_sweep_first, composite_first,
    fused_s1_bwd_first, fused_s1_fwd_first, fused_s2_bwd_first,
    fused_s2_fwd_first, geo_warp_bwd_first, geo_warp_fwd_first,
    nn_argmin_first,
    nn_band_argmin_first, nn_band_err_first, nn_fold_first,
    sample_dense_coord_grad_first, sample_dense_coord_grad_staged,
    sample_dense_first, sort_keys,
    swd_mask_l1_first, swd_mask_sort_first, swd_project_first,
    swd_project_grad_first,
    swd_sort_l1_first,
    tiles_tilemajor_grad_first)
from videoloop3d_torch.losses import patch_nn as PN
from videoloop3d_torch.losses import swd as SW
from videoloop3d_torch.render import compact as CP
from videoloop3d_torch.render import fused as FU
from videoloop3d_torch.render import fused_s1 as F1
from videoloop3d_torch.render import geo_warp as GW
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


@pytest.mark.parametrize("C", [4, 2, 13])
def test_bilinear_tiles_grad_kernel(cuda, C):
    """K9 (vector atomics: 4 floats at C = 4, 2 at C = 2, scalar at 13)
    within 1e-5 * max|g| of its plain version and of its first design
    (atomics add in no fixed order), also for samples clamped at the tile
    edges and with non-finite coordinates where k < 0; through
    `sample_tiles`, one launch of K2 and one of K9, the first design
    none; N = 0 launches nothing."""
    shape = (5, 30, 40)
    k, u, v = (t.to(cuda) for t in _samples(29, 6, 7, shape, 6))
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    ct = torch.randn(shape + (C,), generator=torch.Generator().manual_seed(7)
                     ).to(cuda)
    tiles = torch.randn((29, 6, 7, C), generator=torch.Generator()
                        .manual_seed(8)).to(cuda).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals, _ = S.sample_tiles(tiles, k, u, v)
    (vals * ct).sum().backward()
    assert kernels.LAUNCHES["bilinear_tiles"] == before["bilinear_tiles"] + 1
    assert kernels.LAUNCHES["bilinear_tiles_grad"] == \
        before["bilinear_tiles_grad"] + 1
    ref = S.bilinear_tiles_grad_plain(ct, k, u, v, tiles.shape)
    first = bilinear_tiles_grad_first(ct, k, u, v, tiles.shape)
    assert torch.isfinite(tiles.grad).all()
    for want in (ref, first):
        assert (tiles.grad - want).abs().max() <= 1e-5 * ref.abs().max()
    cpu = S.bilinear_tiles_grad(ct.cpu(), k.cpu(), u.cpu(), v.cpu(),
                                tiles.shape)
    assert (tiles.grad.cpu() - cpu).abs().max() <= 1e-5 * cpu.abs().max()
    empty = S.bilinear_tiles_grad(ct, torch.full_like(k, -1), u, v,
                                  (0, 6, 7, C))
    assert empty.shape == (0, 6, 7, C)
    assert kernels.LAUNCHES["bilinear_tiles_grad"] == \
        before["bilinear_tiles_grad"] + 1


def test_round_bf16_pass(cuda):
    """K9's rounding pass is bit for bit ``.to(torch.bfloat16).float()``
    on random values, exact ties, infinities, subnormals and both zeros
    (NaNs stay NaN), at a length that takes the float4 path and one that
    takes the scalar path, and with tile flags only on the flagged
    tiles."""
    g = torch.Generator().manual_seed(3)
    bits = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096,), generator=g,
                         dtype=torch.int64).to(torch.int32)
    ties = (bits & -65536) | 0x8000
    vals = torch.cat([torch.randn(4096, generator=g) * 3e3,
                      bits.view(torch.float32), ties.view(torch.float32),
                      torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                                    1e-40, -1e-45, 3.4028235e38])])
    for n in (vals.numel() - 3, vals.numel()):
        x = vals[:n].to(cuda).contiguous()
        want = x.to(torch.bfloat16).float()
        got = S.round_bf16_(x.clone())
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))
    # with flags: only the flagged rows (float4 rows of 36 and scalar rows
    # of 13 floats), the others left as they are
    for width in (36, 13):
        x = vals[:(vals.numel() // width) * width].view(-1, width).to(cuda)
        flags = (torch.rand(x.shape[0], generator=g) < 0.3).to(
            torch.uint8).to(cuda)
        got = S.round_bf16_(x.clone(), flags)
        want = torch.where(flags.bool()[:, None],
                           x.to(torch.bfloat16).float(), x)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32),
                           want[~nan].view(torch.int32))


@pytest.mark.parametrize("C", [4, 13])
def test_bilinear_tiles_f32_as_bf16(cuda, C):
    """K2 on f32 tiles gathered as bf16 returns bit for bit K2's samples
    of the bf16 copy; K9 rounding its sums writes f32 values that are
    bf16 values, within one bf16 step of the old chain (the first
    design's sums cast to bf16 and back)."""
    shape = (5, 30, 40)
    tiles = torch.randn((29, 6, 7, C),
                        generator=torch.Generator().manual_seed(C)).to(cuda)
    k, u, v = (t.to(cuda) for t in _samples(29, 6, 7, shape, C))
    got, _ = S.bilinear_tiles(tiles, k, u, v, torch.bfloat16)
    old, _ = S.bilinear_tiles(tiles.to(torch.bfloat16), k, u, v)
    assert torch.equal(got.view(torch.int32), old.view(torch.int32))
    ct = torch.randn(shape + (C,),
                     generator=torch.Generator().manual_seed(9)).to(cuda)
    rnd = S.bilinear_tiles_grad(ct, k, u, v, tiles.shape, torch.bfloat16)
    assert rnd.dtype == torch.float32
    assert torch.equal(rnd, rnd.to(torch.bfloat16).float())
    chain = bilinear_tiles_grad_first(ct, k, u, v, tiles.shape).to(
        torch.bfloat16).float()
    assert _within_bf16_step(rnd, chain, 1e-6 * float(chain.abs().max()))


def test_sample_tiles_static_atlas_as_bf16(cuda):
    """Through `sample_tiles` on the packed f32 atlas at the bf16 gather
    dtype: one launch of K2 and one of K9, the samples bit for bit those
    of the bf16 copy, the gradient f32, every value a bf16 value, within
    one bf16 step of the old chain's, with no cast or copy in the
    autograd graph."""
    shape = (5, 30, 40)
    k, u, v = (t.to(cuda) for t in _samples(29, 6, 7, shape, 12))
    ct = torch.randn(shape + (4,), generator=torch.Generator().manual_seed(
        13)).to(cuda)
    atlas = torch.randn((29, 6, 7, 4), generator=torch.Generator()
                        .manual_seed(14)).to(cuda).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals, _ = S.sample_tiles(atlas, k, u, v, torch.bfloat16)
    assert vals.grad_fn.next_functions[0][0].variable is atlas
    (vals * ct).sum().backward()
    for name in ("bilinear_tiles", "bilinear_tiles_grad"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    old, _ = S.bilinear_tiles(atlas.detach().to(torch.bfloat16), k, u, v)
    assert torch.equal(vals.detach(), old)
    assert atlas.grad.dtype == torch.float32
    assert torch.equal(atlas.grad, atlas.grad.to(torch.bfloat16).float())
    chain = bilinear_tiles_grad_first(ct, k, u, v, atlas.shape).to(
        torch.bfloat16).float()
    assert _within_bf16_step(atlas.grad, chain,
                             1e-6 * float(chain.abs().max()))


def test_empty_atlas_launches_nothing(cuda):
    k = torch.full((3, 4), -1, dtype=torch.int32, device=cuda)
    u = torch.zeros((3, 4), device=cuda)
    before = dict(kernels.LAUNCHES)
    out, _ = S.bilinear_tiles(torch.zeros((0, 6, 7, 4), device=cuda), k, u, u)
    assert out.shape == (3, 4, 4) and not out.any()
    assert kernels.LAUNCHES == before


def _composite_stacks(cuda, S_, h, w, F, case, seed=5):
    g = torch.Generator().manual_seed(seed)
    vals_s = torch.randn((S_, h, w, 4), generator=g) * 2
    vals_d = torch.randn((S_, h, w, F, 4), generator=g) * 2
    m_s, hit_d, m_d = ((torch.rand((S_, h, w), generator=g) < p)
                       for p in (0.6, 0.4, 0.3))
    if case == "all_masked":
        m_s[:] = False
        m_d[:] = False
    elif case == "all_hit":
        hit_d[:] = True
        vals_s[:] = float("nan")       # never read where every plane hits
    elif case == "nonfinite":
        bad = torch.tensor([float("nan"), float("inf"), float("-inf")])
        pick = torch.rand((S_, h, w), generator=g) < 0.3
        sel = pick & ~m_s
        vals_s[sel] = bad[torch.randint(0, 3, (int(sel.sum()), 4),
                                        generator=g)]
        dsel = pick & hit_d & ~m_d
        vals_d[dsel] = bad[torch.randint(0, 3, (int(dsel.sum()), F, 4),
                                         generator=g)]
        vals_s[~pick & ~m_s] = 1e30
    return [t.to(cuda) for t in (vals_s, m_s, vals_d, hit_d, m_d)]


COMPOSITE_CASES = {"s9": (9, 20, 24, 6), "d1": (1, 20, 24, 6),
                   "d33": (33, 13, 17, 6), "f1": (32, 20, 24, 1),
                   "f50": (32, 13, 17, 50), "d128": (128, 9, 11, 10)}


@pytest.mark.parametrize("case", ["random", "all_masked", "all_hit",
                                  "nonfinite"])
@pytest.mark.parametrize("shape", list(COMPOSITE_CASES))
def test_composite_kernel(cuda, shape, case):
    """K4 bit for bit its first design (NaNs where the first design has
    them) and within 1e-5 of its plain version (expf may differ from
    PyTorch's sigmoid in the last ulp): D = 1, 9, 33, 128, F = 1, 6, 50,
    all masked, all hit, non-finite masked-off samples.  One launch a
    call; the first design adds none."""
    stacks = _composite_stacks(cuda, *COMPOSITE_CASES[shape], case)
    before = kernels.LAUNCHES["composite"]
    out, asum = FU.composite(*stacks)
    assert kernels.LAUNCHES["composite"] == before + 1
    fout, fasum = composite_first(*stacks)
    assert kernels.LAUNCHES["composite"] == before + 1
    for a, b in ((out, fout), (asum, fasum)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    pout, pasum = FU.composite_plain(*stacks)
    for a, b in ((out, pout), (asum, pasum)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        ok = ~torch.isnan(b)
        assert (a[ok] - b[ok]).abs().max() <= 1e-5
    if case == "nonfinite":
        assert torch.isnan(out).any() and torch.isfinite(asum).all()


@pytest.mark.parametrize("D,F", [(1, 10), (32, 10), (32, 1), (33, 50),
                                 (128, 10), (2048, 1)])
def test_composite_layout_matches_the_kernel(cuda, D, F):
    assert FU.kernel_composite_layout(D, F) == FU.composite_layout(D, F)


def test_wrapper_rejects_mixed_devices(cuda):
    tiles = torch.zeros((3, 6, 7, 4), device=cuda)
    k = torch.zeros((2, 3), dtype=torch.int32)
    u = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="expected cuda"):
        S.bilinear_tiles(tiles, k, u, u)


def _dense_inputs(seed, B=2, D=3, h=20, w=24, Ht=30, Wt=40, C=4):
    rng = np.random.default_rng(seed)
    atlas = rng.standard_normal((D, Ht, Wt, C)).astype(np.float32)
    mask = rng.standard_normal((D, Ht, Wt, 1)).astype(np.float32)
    x = rng.uniform(-3, Wt + 2, (B, D, h, w)).astype(np.float32)
    y = rng.uniform(-3, Ht + 2, (B, D, h, w)).astype(np.float32)
    x.reshape(-1)[:50] = 1e9            # far off the plane / behind it
    y.reshape(-1)[50:90] = -4e12
    x.reshape(-1)[90:120] = np.floor(x.reshape(-1)[90:120])
    g = rng.standard_normal((B, D, h, w, C)).astype(np.float32)
    gm = rng.standard_normal((B, D, h, w, 1)).astype(np.float32)
    return [torch.from_numpy(a) for a in (atlas, mask, x, y, g, gm)]


@pytest.mark.parametrize("C", [1, 8, 13, 36])
def test_sample_dense_kernels_at_c_channels(cuda, C):
    """K5/K6/K22 at the other decoders' channel counts (the general-C
    kernels): K5 bit-equal to the plain version, K6 and K22 within
    1e-5 * max|g|; and at C = 4 padded to C = 5, the general kernel
    equals the float4 kernel on the first four channels."""
    atlas, mask, x, y, g, gm = (t.to(cuda) for t in _dense_inputs(1, C=C))
    a = atlas.clone().requires_grad_(True)
    m = mask.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    feats, mfeats = S.sample_dense(a, m, xr, y)
    assert feats.shape[-1] == C
    assert torch.equal(feats, S.bilinear_planes_plain(atlas, x, y))
    assert torch.equal(mfeats, S.bilinear_planes_plain(mask, x, y))
    ((feats * g).sum() + (mfeats * gm).sum()).backward()
    ref = S.bilinear_planes_grad_plain(g, x, y, atlas.shape)
    assert (a.grad - ref).abs().max() <= 1e-5 * ref.abs().max()
    rx = S.bilinear_planes_coord_grad_plain(g, atlas, x, y)[0] \
        + S.bilinear_planes_coord_grad_plain(gm, mask, x, y)[0]
    assert (xr.grad - rx).abs().max() <= 1e-5 * rx.abs().max()
    a4, _, x4, y4, _, _ = (t.to(cuda) for t in _dense_inputs(2))
    a5 = torch.cat([a4, torch.zeros_like(a4[..., :1])], -1).contiguous()
    f4, _ = S.sample_dense_fwd(a4, None, x4, y4)
    f5, _ = S.sample_dense_fwd(a5, None, x4, y4)
    assert torch.equal(f4, f5[..., :4])


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 12, 13, 36, 37])
def test_sample_dense_block_kernel(cuda, C, masked):
    """K5's redesign at C != 4 (a block's corners once per sample, its
    outputs swept in output order; float4 where C % 4 == 0) at B = 2 and
    2,880 samples (11.25 blocks), with _dense_inputs' planted coordinates
    (1e9, -4e12, whole numbers): bit-equal to the plain version and to its
    first design, one launch."""
    atlas, mask, x, y, _, _ = (t.to(cuda) for t in _dense_inputs(5, C=C))
    mask = mask if masked else None
    before = kernels.LAUNCHES["sample_dense"]
    feats, mfeats = S.sample_dense_fwd(atlas, mask, x, y)
    assert kernels.LAUNCHES["sample_dense"] == before + 1
    assert x.numel() % 256 != 0
    assert torch.equal(feats, S.bilinear_planes_plain(atlas, x, y))
    first, mfirst = sample_dense_first(atlas, mask, x, y)
    assert torch.equal(feats, first)
    if masked:
        assert torch.equal(mfeats, S.bilinear_planes_plain(mask, x, y))
        assert torch.equal(mfeats, mfirst)
    else:
        assert mfeats is None


def test_sample_dense_block_kernel_unaligned_atlas(cuda):
    """K5 at C = 8 on an atlas view whose data pointer is 4 bytes past a
    16-byte boundary (the one-channel sweep, not the float4 one): bit-equal
    to the plain version and to the first design."""
    atlas, mask, x, y, _, _ = (t.to(cuda) for t in _dense_inputs(6, C=8))
    flat = torch.empty(atlas.numel() + 1, dtype=torch.float32, device=cuda)
    view = flat[1:].view(atlas.shape)
    view.copy_(atlas)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    feats, mfeats = S.sample_dense_fwd(view, mask, x, y)
    assert torch.equal(feats, S.bilinear_planes_plain(atlas, x, y))
    assert torch.equal(mfeats, S.bilinear_planes_plain(mask, x, y))
    first, _ = sample_dense_first(view, mask, x, y)
    assert torch.equal(feats, first)


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


@pytest.mark.parametrize("mask", [True, False])
def test_sample_dense_grad_smooth_and_spread(cuda, mask):
    """K6 at C = 4 (128-bit atomics) on a 200 x 300 plane: planes 0 and 2
    sampled smoothly (1.4 texels a pixel: neighbouring samples share
    texels), plane 1 at random points, with and without the mask; within
    1e-5 * max|g| of the plain version."""
    rng = np.random.default_rng(4)
    B, D, h, w, Ht, Wt = 1, 3, 90, 120, 200, 300
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = np.broadcast_to(1.4 * xx + 3.3, (B, D, h, w)).copy()
    y = np.broadcast_to(1.4 * yy - 2.6, (B, D, h, w)).copy()
    x[:, 1] = rng.uniform(-3, Wt + 2, (B, h, w))
    y[:, 1] = rng.uniform(-3, Ht + 2, (B, h, w))
    g = rng.standard_normal((B, D, h, w, 4)).astype(np.float32)
    gm = rng.standard_normal((B, D, h, w, 1)).astype(np.float32)
    x, y, g, gm = (torch.from_numpy(a.astype(np.float32)).to(cuda)
                   for a in (x, y, g, gm))
    gm = gm if mask else None
    before = kernels.LAUNCHES["sample_dense_grad"]
    ga, gma = S.sample_dense_grad(g, gm, x, y, (D, Ht, Wt, 4),
                                  (D, Ht, Wt, 1))
    assert kernels.LAUNCHES["sample_dense_grad"] == before + 1
    ref = S.bilinear_planes_grad_plain(g, x, y, (D, Ht, Wt, 4))
    assert (ga - ref).abs().max() <= 1e-5 * ref.abs().max()
    if mask:
        ref = S.bilinear_planes_grad_plain(gm, x, y, (D, Ht, Wt, 1))
        assert (gma - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        assert gma is None


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


def _plane_inputs(seed, D=3, N=(20, 24), Ht=30, Wt=40, F=6, C=4):
    rng = np.random.default_rng(seed)
    tex = rng.standard_normal((D, Ht, Wt, F, C)).astype(np.float32)
    x = rng.uniform(-3, Wt + 2, (D,) + N).astype(np.float32)
    y = rng.uniform(-3, Ht + 2, (D,) + N).astype(np.float32)
    x.reshape(-1)[:50] = 1e9            # far off the plane
    y.reshape(-1)[50:90] = -4e12
    x.reshape(-1)[90:120] = np.floor(x.reshape(-1)[90:120])
    x.reshape(-1)[120:130] = Wt - 1
    y.reshape(-1)[130:140] = Ht - 1
    ct = rng.standard_normal((D,) + N + (F, C)).astype(np.float32)
    return [torch.from_numpy(a) for a in (tex, x, y, ct)]


def _within_bf16_step(a, b, slack=0.0):
    """Every value of a within one bf16 step (at the larger magnitude) plus
    `slack` of b's."""
    mag = torch.maximum(a.abs(), b.abs())
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return bool(((a - b).abs() <= step + slack).all())


@pytest.mark.parametrize("C", [4, 13, 36])
@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_as_bf16"])
@pytest.mark.parametrize("ts", [None, [5, 0, 3, 3]])
def test_bilinear_planes_tilemajor_kernels(cuda, mode, ts, C):
    """K16 equals its plain version and its first design bit for bit (same
    lerps, one rounding each; corners off the plane read zero, far-off
    coordinates included) on f32 and bf16 texels and on f32 texels
    gathered as bf16 (the first design on their bf16 copy); K17 is within
    1e-5 * max|g| of its plain version and of its first design (atomics),
    gives the same bits twice, and in the rounding mode stores its f32
    sums rounded to bf16, bit for bit (so within one bf16 step plus the
    f32 tolerance of the plain sums' rounding);
    through `sample_planes_tilemajor` one launch of each, the gradient of
    an f32 atlas in f32 (K17's rounded sums as they are), of a bf16
    texture in bf16."""
    tex, x, y, ct = (t.to(cuda) for t in _plane_inputs(2, C=C))
    if mode == "bf16":
        tex = tex.to(torch.bfloat16)
    gather = None if mode == "f32" else torch.bfloat16
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32,
                                               device=cuda)
    got = S.bilinear_planes_tilemajor(tex, x, y, tts, gather)
    ref = S.bilinear_planes_tilemajor_plain(tex, x, y, tts, gather)
    assert got.shape == x.shape + (6 if ts is None else 4, C)
    assert torch.equal(got, ref)
    first_tex = tex.to(torch.bfloat16) if mode == "f32_as_bf16" else tex
    assert torch.equal(got, bilinear_planes_tilemajor_first(first_tex, x, y,
                                                            tts))
    cpu = S.bilinear_planes_tilemajor(tex.cpu(), x.cpu(), y.cpu(),
                                      None if ts is None else tts.cpu(),
                                      gather)
    assert torch.equal(got.cpu(), cpu)
    if ts is not None:
        return
    t = tex.clone().requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals = S.sample_planes_tilemajor(t, x, y, None, gather)
    (vals * ct).sum().backward()
    for name in ("bilinear_planes_tilemajor",
                 "bilinear_planes_tilemajor_grad"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    gref = S.bilinear_planes_tilemajor_grad_plain(ct, x, y, tex.shape)
    scale = gref.abs().max()
    g17 = S.bilinear_planes_tilemajor_grad(ct, x, y, tex.shape)
    assert torch.isfinite(g17).all()
    assert (g17 - gref).abs().max() <= 1e-5 * scale
    assert torch.equal(g17, S.bilinear_planes_tilemajor_grad(ct, x, y,
                                                             tex.shape))
    first = bilinear_planes_tilemajor_grad_first(ct, x, y, tex.shape)
    assert (g17 - first).abs().max() <= 1e-5 * scale
    g_r = S.bilinear_planes_tilemajor_grad(ct, x, y, tex.shape,
                                           torch.bfloat16)
    assert torch.equal(g_r, g17.to(torch.bfloat16).float())
    assert _within_bf16_step(g_r, gref.to(torch.bfloat16).float(),
                             1e-5 * scale)
    assert torch.equal(g_r, S.bilinear_planes_tilemajor_grad(
        ct, x, y, tex.shape, torch.bfloat16))
    assert t.grad.dtype == tex.dtype
    assert torch.equal(t.grad.float(), g17 if gather is None else g_r)


def test_bilinear_planes_tilemajor_past_2_31_elements(cuda):
    """K16/K17 and their first designs index a (2, 1024, 1024, 260, 4)
    stack, 2.18 G elements (past 2^31), with 64-bit plane offsets: samples
    in the last rows of the last plane read and write the same texels as
    the plain version, from bf16 texels and from f32 texels gathered as
    bf16; K17 writes every texel (zero in the rows no sample reads) and
    the gradient sums to one a sample, frame and channel, within one bf16
    step of its first design's."""
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
    assert torch.equal(got[1], bilinear_planes_tilemajor_first(tex, x, y)[1])
    tex32 = tex.float()
    del tex
    got32 = S.bilinear_planes_tilemajor(tex32, x, y, None, torch.bfloat16)
    assert torch.equal(got32[1], ref[1])
    del tex32
    torch.cuda.empty_cache()
    ct = torch.ones((D, 64, F, 4), device=cuda)
    shape = (D, Ht, Wt, F, 4)
    g = S.bilinear_planes_tilemajor_grad(ct, x, y, shape, torch.bfloat16)
    assert float(g[1, Ht - 7:].sum()) == pytest.approx(64 * F * 4, rel=1e-4)
    untouched = g[1, :Ht - 7]
    assert float(untouched.amax()) == 0.0 == float(untouched.amin())
    tail = g[1, Ht - 7:].clone()
    del g, untouched
    torch.cuda.empty_cache()
    first = bilinear_planes_tilemajor_grad_first(ct, x, y, shape)
    assert _within_bf16_step(tail, first[1, Ht - 7:].to(torch.bfloat16)
                             .float(), 1e-5 * float(tail.abs().max()))
    del first


@pytest.mark.parametrize("shape", [(32, 57600, 396, 704, 50, 4),
                                   (32, 57600, 396, 704, 50, 13),
                                   (32, 57600, 396, 704, 50, 36),
                                   (3, 480, 30, 40, 6, 4),
                                   (1, 7, 9, 11, 5, 13),
                                   (2, 64, 1024, 1024, 260, 4)])
def test_planes_grad_layout_matches_the_kernel(cuda, shape):
    """render/sample.py:planes_grad_layout gives the tiles, bins, passes,
    slices, threads, shared memory and scratch that the kernel's own
    layout does (vl3d_planes_grad_layout), for every vector width."""
    D, n, Ht, Wt, F, C = shape
    for vec in (4, 2, 1):
        if F * C % vec:
            continue
        lay = S.planes_grad_layout(D, n, Ht, Wt, F, C, vec)
        assert S.kernel_planes_grad_layout(D, n, Ht, Wt, F, C, vec) == {
            k: lay[k] for k in S.PLANES_GRAD_LAYOUT_KEYS}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [13, 36])
def test_tile_kernels_at_c_channels(cuda, C, dtype):
    """K2/K9 on packed and K3/K10 on tile-major tiles at the SH decoders'
    channel counts (bf16 texel rows of 2 C bytes, not 4-byte aligned at
    C = 13): samples within 1e-6 of the plain versions, gradients within
    1e-5 * max|g|."""
    shape = (4, 20, 24)
    gen = torch.Generator().manual_seed(C)
    k, u, v = (t.to(cuda) for t in _samples(17, 6, 7, shape, C))
    tiles = torch.randn((17, 6, 7, C), generator=gen).to(dtype).to(cuda)
    dyn = torch.randn((17, 6, 7, 5, C), generator=gen).to(dtype).to(cuda)
    got, _ = S.bilinear_tiles(tiles, k, u, v)
    ref, _ = S.bilinear_tiles_plain(tiles, k, u, v)
    assert (got - ref).abs().max() <= 1e-6
    got, _ = S.bilinear_tiles_tilemajor(dyn, k, u, v)
    ref, _ = S.bilinear_tiles_tilemajor_plain(dyn, k, u, v)
    assert got.shape == shape + (5, C) and (got - ref).abs().max() <= 1e-6
    ct = torch.randn(shape + (C,), generator=gen).to(cuda)
    got = S.bilinear_tiles_grad(ct, k, u, v, tiles.shape)
    ref = S.bilinear_tiles_grad_plain(ct, k, u, v, tiles.shape)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    ct = torch.randn(shape + (5, C), generator=gen).to(cuda)
    got = S.bilinear_tiles_tilemajor_grad(ct, k, u, v, dyn.shape)
    ref = S.bilinear_tiles_tilemajor_grad_plain(ct, k, u, v, dyn.shape)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("C", [8, 13, 36])
def test_static_tiles_gather(cuda, C):
    """K9 at C != 4 (K10's binned gather at F = 1) within 1e-5 * max|g|
    of its plain version and of its atomic route, samples clamped at the
    tile edges and k past the last tile included; the same bits on a
    second call; the rounding mode bit for bit ``.to(bf16).float()`` of
    the f32 sums; the library's layout equal to the mirror's; one launch
    a call, the atomic route none."""
    shape = (5, 30, 40)
    k, u, v = (t.to(cuda) for t in _samples(29, 12, 12, shape, C))
    k.view(-1)[::53] = 40                   # past the last tile: clamped
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    ct = torch.randn(shape + (C,),
                     generator=torch.Generator().manual_seed(C)).to(cuda)
    tshape = (29, 12, 12, C)
    before = kernels.LAUNCHES["bilinear_tiles_grad"]
    got = S.bilinear_tiles_grad(ct, k, u, v, tshape)
    again = S.bilinear_tiles_grad(ct, k, u, v, tshape)
    rnd = S.bilinear_tiles_grad(ct, k, u, v, tshape, torch.bfloat16)
    assert kernels.LAUNCHES["bilinear_tiles_grad"] == before + 3
    atomic = bilinear_tiles_grad_atomic(ct, k, u, v, tshape)
    assert kernels.LAUNCHES["bilinear_tiles_grad"] == before + 3
    # the plain version indexes k as it is: the kernels' clamp given it
    want = S.bilinear_tiles_grad_plain(ct, k.clamp(max=28), u, v, tshape)
    scale = want.abs().max()
    assert torch.isfinite(got).all() and scale > 0
    assert (got - want).abs().max() <= 1e-5 * scale
    assert (atomic - want).abs().max() <= 1e-5 * scale
    assert torch.equal(got, again)
    assert torch.equal(rnd.view(torch.int32),
                       got.to(torch.bfloat16).float().view(torch.int32))
    vec = S._vec_width(C, ct)
    D = S.tiles_grad_planes(k.shape)
    args = (D, k.numel() // D, 29, 12, 12, C, vec)
    assert S.kernel_static_grad_layout(*args) == S.static_grad_layout(*args)


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


MMA_CASES = {"ref_11x11": (3, (3, 11, 11), (1, 4, 4), 23, 12, 10),
             "odd_pt1": (3, (1, 5, 5), (1, 2, 2), 13, 70, 52),
             "st2": (3, (3, 7, 7), (2, 3, 3), 17, 21, 17),
             "c1_pt2": (1, (2, 3, 3), (1, 1, 1), 9, 40, 55),
             "long_video": (3, (3, 11, 11), (1, 4, 4), 23, 150, 148)}


def _term_scale(x, y, plan):
    """(|X_i|^2 + |Y_j|^2) / d of every pair of `nn_dist_plain`: the size
    of the terms the expanded distance cancels, which its rounding error
    scales with."""
    ft, fh, fw = plan.fit
    out = []
    for xc, yc in zip(PN._crops(x[:, :ft, :fh, :fw].float(), plan),
                      PN._crops(y[:, :plan.fit_ty, :fh, :fw].float(), plan)):
        px = PN.extract_patches_3d(xc, plan.psz, plan.strides)
        py = PN.extract_patches_3d(yc, plan.psz, plan.strides)
        xx = (px * px).sum(-1).flatten(1).T
        yy = (py * py).sum(-1).flatten(1).T
        out.append((xx[..., :, None] + yy[..., None, :]) / px.shape[-1])
    return torch.stack(out)


@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(MMA_CASES))
def test_nn_argmin_mma_kernel(cuda, case, alpha):
    """K11 on bf16 "mse" inputs (the tensor-core kernel) at layouts with
    a k8 tail step, several warp tiles and rounds of them, several k
    splits, a temporal stride of 2 and one channel, and on a video of
    150 frames, too long to stage, on the CUDA-core template: its indices
    equal the plain version's except at near ties, within 1e-5 of the
    term scale (the sums run in another order; with alpha the scale
    carried through the column minimum, as chip_smoke.py:flip_gaps); y's
    frames repeat every 6, and every choice is the first of its bit-equal
    candidates; one launch."""
    import math
    C, psz, strides, macro, Tx, Ty = MMA_CASES[case]
    x, y = _nn_inputs(cuda, torch.bfloat16, 13, C=C, Tx=Tx, Ty=Ty, H=31,
                      W=37)
    y = y[:, torch.arange(Ty, device=cuda) % 6].contiguous()
    plan = PN.lowmem_plan(Tx, Ty, 31, 37, psz, strides, macro)
    staged = PN.mma_layout(plan, C)[2] <= PN._SMEM_LIMIT
    assert staged == (case != "long_video")
    before = kernels.LAUNCHES["nn_argmin"]
    nn = PN.nn_argmin(x, y, plan, alpha)
    assert kernels.LAUNCHES["nn_argmin"] == before + 1
    raw = PN.nn_dist_plain(x, y, plan, None)
    dist = PN.nn_dist_plain(x, y, plan, alpha)
    ref = torch.argmin(dist, dim=3).to(torch.int32)
    scale = _term_scale(x, y, plan)
    if alpha is not None:
        scale = (scale + dist.abs() * scale.amax(dim=2, keepdim=True)) \
            / (alpha + raw.amin(dim=2, keepdim=True)).abs()
    flips = nn != ref

    def at(t, k):
        return torch.gather(t, 3, k.long()[..., None])[..., 0][flips]
    gap = (at(dist, nn) - at(dist, ref)).abs()
    assert (gap <= 1e-5 * torch.maximum(at(scale, nn), at(scale, ref))
            ).all()
    # patch j equals patch j - 6 / gcd(6, st): the first of its equals
    # lies in the first period
    assert (nn < 6 // math.gcd(6, strides[0])).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(MMA_CASES))
def test_nn_fp_modes_at_one_rank(cuda, case, dtype):
    """The frame-parallel gpnn loss's modes at one rank: K11's minima mode
    within 1e-5 of the term scale of the plain minima, its given-minima
    mode with those minima K11's indices bit for bit at alpha 0 and 0.01
    (bf16: the tensor cores where they fit, else the CUDA-core search;
    f32: the CUDA-core search), and K12's numerator mode over the plan's
    weight K12 bit for bit; one launch each."""
    C, psz, strides, macro, Tx, Ty = MMA_CASES[case]
    x, y = _nn_inputs(cuda, dtype, 17, C=C, Tx=Tx, Ty=Ty, H=31, W=37)
    plan = PN.lowmem_plan(Tx, Ty, 31, 37, psz, strides, macro)
    before = dict(kernels.LAUNCHES)
    cm = PN.nn_argmin_colmin(x, y, plan)
    scale = _term_scale(x, y, plan).amax(dim=2)
    assert ((cm - PN.nn_colmin_plain(x, y, plan)).abs()
            <= 1e-5 * scale).all()
    for alpha in (0.0, 0.01):
        assert torch.equal(PN.nn_argmin_given(x, y, plan, alpha, cm),
                           PN.nn_argmin(x, y, plan, alpha))
    nn = PN.nn_argmin(x, y, plan, None)
    num = PN.nn_fold(y, nn, plan, numer=True)
    w = torch.from_numpy(plan.weight).to(cuda)[None]
    assert torch.equal((num / w).view(torch.int32),
                       PN.nn_fold(y, nn, plan).view(torch.int32))
    for name, n in (("nn_argmin_colmin", 1), ("nn_argmin_given", 2),
                    ("nn_fold_numer", 1)):
        assert kernels.LAUNCHES[name] == before[name] + n


def test_nn_given_minima_change_the_search(cuda):
    """Minima from elsewhere (another rank's smaller ones) change the
    normalized search as its plain version's: with the minima halved the
    indices equal nn_argmin_plain's with those minima except at near
    ties (1e-5 relative)."""
    x, y = _nn_inputs(cuda, torch.float32, 18)
    plan = PN.lowmem_plan(10, 8, 27, 33, (3, 3, 3), (1, 2, 2), 13)
    cm = PN.nn_argmin_colmin(x, y, plan) * 0.5
    nn = PN.nn_argmin_given(x, y, plan, 0.01, cm)
    dist = PN.nn_dist_plain(x, y, plan, 0.01, colmin=cm)
    ref = torch.argmin(dist, dim=3).to(torch.int32)
    flips = nn != ref
    if flips.any():
        dk = torch.gather(dist, 3, nn.long()[..., None])[..., 0][flips]
        dp = torch.gather(dist, 3, ref.long()[..., None])[..., 0][flips]
        assert ((dk - dp).abs() <= 1e-5 * dp.abs()).all()


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


# (C, patch size, strides, macro block, Tx, Ty, H, W): the two stage-2
# views, an odd width with pt = 1, a temporal stride of 2, one channel, and
# videos long enough for several output tiles a column
SEARCH_CASES = {"ref_11x11": (3, (3, 11, 11), (1, 4, 4), 23, 12, 10, 31, 37),
                "other_3x3": (3, (3, 3, 3), (1, 2, 2), 13, 14, 12, 31, 37),
                "odd_pt1": (3, (1, 5, 5), (1, 2, 2), 13, 20, 17, 31, 37),
                "st2": (3, (3, 7, 7), (2, 3, 3), 17, 21, 17, 31, 37),
                "c1_pt2": (1, (2, 3, 3), (1, 1, 1), 9, 40, 55, 31, 37),
                "eval_p17": (3, (3, 17, 17), (1, 6, 6), 29, 12, 12, 40, 52),
                "long_video": (3, (3, 5, 5), (1, 2, 2), 13, 150, 148, 24,
                               28)}


def _search_case(cuda, case, dtype, seed):
    C, psz, strides, macro, Tx, Ty, H, W = SEARCH_CASES[case]
    x, y = _nn_inputs(cuda, dtype, seed, C=C, Tx=Tx, Ty=Ty, H=H, W=W)
    # frames repeated: exact ties in every search
    y = y[:, torch.arange(Ty, device=cuda) % 7].contiguous()
    return x, y, PN.lowmem_plan(Tx, Ty, H, W, psz, strides, macro)


@pytest.mark.parametrize("scale_by_pt", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_nn_band_redesign_equals_first_design(cuda, case, alpha, dtype,
                                              scale_by_pt):
    """K18 (the redesigned CUDA-core search) returns its first design's
    rows and columns bit for bit, one launch; the first design adds to no
    launch count."""
    x, y, plan = _search_case(cuda, case, dtype, 21)
    before = dict(kernels.LAUNCHES)
    rows, cols = PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt, True)
    assert kernels.LAUNCHES["nn_band_argmin"] == before["nn_band_argmin"] + 1
    launched = dict(kernels.LAUNCHES)
    rows_1, cols_1 = nn_band_argmin_first(x, y, plan, alpha, scale_by_pt,
                                          True)
    assert kernels.LAUNCHES == launched
    assert torch.equal(rows, rows_1) and torch.equal(cols, cols_1)
    rows2, none = PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt)
    assert none is None and torch.equal(rows2, rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_nn_ssim_redesign_equals_first_design(cuda, case, alpha, dtype):
    """K11's ssim mode and (f32) its "mse" search on the redesigned
    CUDA-core search return their first designs' indices bit for bit, one
    launch each, counted apart; the first designs add to no count."""
    x, y, plan = _search_case(cuda, case, dtype, 22)
    before = dict(kernels.LAUNCHES)
    nn = PN.nn_argmin(x, y, plan, alpha, "ssim")
    assert kernels.LAUNCHES["nn_argmin_ssim"] == before["nn_argmin_ssim"] + 1
    assert kernels.LAUNCHES["nn_argmin"] == before["nn_argmin"]
    launched = dict(kernels.LAUNCHES)
    assert torch.equal(nn, nn_argmin_first(x, y, plan, alpha, "ssim"))
    if dtype == torch.float32:
        assert torch.equal(PN.nn_argmin(x, y, plan, alpha),
                           nn_argmin_first(x, y, plan, alpha))
        launched["nn_argmin"] += 1
    assert kernels.LAUNCHES == launched


# (patch size, strides, macro block): pt = 1, 3 and 7 at st = 1 (the
# window), pt = 3 at st = 2 (the generic loop)
BAND_ERR_CASES = {"pt1": ((1, 5, 5), (1, 2, 2), 17),
                  "pt3": ((3, 11, 11), (1, 4, 4), 23),
                  "pt7": ((7, 5, 5), (1, 2, 2), 17),
                  "pt3_st2": ((3, 5, 5), (2, 2, 2), 17)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(BAND_ERR_CASES))
def test_nn_band_err_redesign(cuda, case, dtype):
    """K19 redesigned: within 1e-6 relative of its first design
    (vl3d_nn_band_err_first) and of its plain version on K18's indices,
    both directions; the same bits twice; the target read from device
    memory and staged give the same bits; 1, 2 and 3 columns a block
    within 1e-6 of the plain version; its layout the kernel's; one launch
    a direction through the wrapper."""
    psz, strides, macro = BAND_ERR_CASES[case]
    x, y = _nn_inputs(cuda, dtype, 19, Tx=14, Ty=11, H=40, W=46)
    C, Tx, H, W = x.shape
    plan = PN.lowmem_plan(Tx, y.shape[1], H, W, psz, strides, macro)
    rows, cols = PN.nn_band_argmin(x, y, plan, both_directions=True)
    for nn, reverse in ((rows, False), (cols, True)):
        before = kernels.LAUNCHES["nn_band_err"]
        got = PN.nn_band_err(x, y, plan, nn, reverse)
        assert kernels.LAUNCHES["nn_band_err"] == before + 1
        first = nn_band_err_first(x, y, plan, nn, reverse)
        want = PN.nn_band_err_plain(x, y, plan, nn, reverse)
        assert ((got - first).abs() <= 1e-6 * first.abs()).all()
        assert ((got - want).abs() <= 1e-6 * want.abs()).all()
        assert torch.equal(got, PN.nn_band_err(x, y, plan, nn, reverse))
        for stage in (0, 1):
            assert torch.equal(got, PN.nn_band_err_launch(
                x, y, plan, nn, reverse, stage=stage))
        for tw in (1, 2, 3):
            one = PN.nn_band_err_launch(x, y, plan, nn, reverse, tw=tw)
            assert ((one - want).abs() <= 1e-6 * want.abs()).all()
        assert PN.kernel_nn_band_err_layout(plan, C, reverse) \
            == PN.nn_band_err_layout(plan, C, reverse)


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_nn_tile_layout_matches_the_kernel(cuda, case):
    """losses/patch_nn.py:tile_layout gives the shared bytes the kernel's
    own layout does (vl3d_nn_tile_smem), in every mode."""
    C, psz, strides, macro, Tx, Ty, H, W = SEARCH_CASES[case]
    plan = PN.lowmem_plan(Tx, Ty, H, W, psz, strides, macro)
    for mode, code in (("mse", 0), ("band", 1), ("ssim", 2)):
        assert kernels.library().vl3d_nn_tile_smem(
            PN._plan_ints(plan), C, code) == PN.tile_layout(plan, C,
                                                            mode)["smem"]


@pytest.mark.parametrize("shape", [(10, 20, 24, 4), (32, 180, 320, 15),
                                   (33, 20, 24, 1), (128, 20, 24, 15),
                                   (128, 20, 24, 128)],
                         ids=["small", "production", "d33_s1", "d128",
                              "d128_s128"])
def test_compact_sweep_kernel(cuda, shape):
    """K13 equals its plain version and its first design
    (vl3d_compact_sweep_first) array for array (copies only), with pixels
    of more hits than S (the farthest dropped) and all-miss pixels; its
    layout the kernel's; one launch."""
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
    first = compact_sweep_first(*args, S)
    for a, b, c in zip(got, ref, first):
        assert a.dtype == b.dtype and a.shape == b.shape == (S, h, w)
        assert torch.equal(a, b) and torch.equal(a, c)
    assert CP.kernel_compact_layout(D, S) == CP.compact_layout(D, S)
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


ALL_FUSED_S2_FLAGS = [tuple(bool(m >> b & 1) for b in range(4))
                      for m in range(16)]
# (S, h, w, F): the small shape, the stage-2 patch at its slot bound and
# uncompacted (S = D), the slot limit with a small patch (chunks of one
# frame), one frame, and 640 frames (a block of 640 threads in the first
# design; at 1,024 its block asks more registers than an SM has)
FUSED_S2_BWD_SHAPES = {"small": (7, 13, 17, 5),
                       "production": (15, 180, 320, 50),
                       "slots=D": (32, 180, 320, 50),
                       "S=128": (128, 5, 9, 3), "F=1": (9, 21, 35, 1),
                       "F=640": (3, 3, 10, 640)}
FUSED_S2_BWD_CASES = (
    [("small", f) for f in ALL_FUSED_S2_FLAGS]
    + [(k, f) for k in FUSED_S2_BWD_SHAPES if k != "small"
       for f in FUSED_S2_FLAGS])


def _s2_case_id(case):
    k, flags = case
    return k + "-" + "".join(c if on else "-" for c, on in zip("sraD", flags))


@pytest.mark.parametrize("case,flags", FUSED_S2_BWD_CASES,
                         ids=[_s2_case_id(c) for c in FUSED_S2_BWD_CASES])
def test_fused_s2_bwd_redesign_equals_first_design(cuda, case, flags):
    """K15's redesign (the tile kernel) returns its first design's texel
    cotangents bit for bit, within 2e-5 * max|g| of the plain version, the
    same bits on a second call, one launch counted; the first design adds
    to no launch count."""
    S, h, w, F = FUSED_S2_BWD_SHAPES[case]
    cfg = FU.FusedCfg(max(S, 32), *flags)
    ins, dinv, cts = _fused_s2_inputs(cuda, S, h, w, F, S + F)
    dv = dinv if cfg.want_disp else None
    before = dict(kernels.LAUNCHES)
    got = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
    assert kernels.LAUNCHES["fused_s2_bwd"] == before["fused_s2_bwd"] + 1
    launched = dict(kernels.LAUNCHES)
    first = fused_s2_bwd_first(cfg, *ins, dv, *cts)
    assert kernels.LAUNCHES == launched
    for a, b in zip(got, first):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    again = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = FU.fused_composite_bwd_plain(cfg, *ins, dv, *cts)
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 2e-5 * b.abs().max()


@pytest.mark.parametrize("flags", FUSED_S2_FLAGS)
def test_fused_s2_bwd_at_1024_frames(cuda, flags):
    """K15 at the frame limit (1,024, chunks of 10 and a last one of 4):
    within 2e-5 * max|g| of the plain version, the same bits twice."""
    cfg = FU.FusedCfg(32, *flags)
    ins, dinv, cts = _fused_s2_inputs(cuda, 3, 3, 10, 1024, 3)
    dv = dinv if cfg.want_disp else None
    got = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
    again = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = FU.fused_composite_bwd_plain(cfg, *ins, dv, *cts)
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 2e-5 * b.abs().max()


@pytest.mark.parametrize("S,F", [(15, 50), (29, 50), (32, 50), (128, 50),
                                 (128, 1), (1, 1), (7, 23), (15, 1024)])
def test_fused_s2_bwd_layout_matches_the_kernel(cuda, S, F):
    """render/fused.py:fused_s2_bwd_layout gives the chunk, threads and
    shared bytes of the kernel's own layout (vl3d_fused_s2_bwd_layout)."""
    assert FU.kernel_fused_s2_bwd_layout(S, F) == FU.fused_s2_bwd_layout(S, F)


# (S, h, w, F): K15's shapes and 1,024 frames (the limit)
FUSED_S2_FWD_SHAPES = dict(FUSED_S2_BWD_SHAPES, **{"F=1024": (3, 3, 10, 1024)})
FUSED_S2_FWD_CASES = (
    [("small", f) for f in ALL_FUSED_S2_FLAGS]
    + [(k, f) for k in FUSED_S2_FWD_SHAPES if k != "small"
       for f in FUSED_S2_FLAGS])


@pytest.mark.parametrize("case,flags", FUSED_S2_FWD_CASES,
                         ids=[_s2_case_id(c) for c in FUSED_S2_FWD_CASES])
def test_fused_s2_fwd_redesign_equals_first_design(cuda, case, flags):
    """K14's redesign (the tile kernel) returns its first design's out,
    alpha_sum, disparity and regularizer scalars bit for bit, the same bits
    on a second call, one launch counted; the first design adds to no
    launch count."""
    S, h, w, F = FUSED_S2_FWD_SHAPES[case]
    cfg = FU.FusedCfg(max(S, 32), *flags)
    ins, dinv, _ = _fused_s2_inputs(cuda, S, h, w, F, S + F + 1)
    dv = dinv if cfg.want_disp else None
    before = dict(kernels.LAUNCHES)
    got = FU.fused_s2_fwd(cfg, *ins, dv)
    assert kernels.LAUNCHES["fused_s2_fwd"] == before["fused_s2_fwd"] + 1
    launched = dict(kernels.LAUNCHES)
    first = fused_s2_fwd_first(cfg, *ins, dv)
    assert kernels.LAUNCHES == launched
    for a, b in zip(got, first):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    again = FU.fused_s2_fwd(cfg, *ins, dv)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("S,F", [(15, 50), (29, 50), (32, 50), (128, 50),
                                 (128, 1), (1, 1), (7, 23), (15, 1024)])
def test_fused_s2_fwd_layout_matches_the_kernel(cuda, S, F):
    """render/fused.py:fused_s2_fwd_layout gives the chunk, threads and
    shared bytes of the kernel's own layout (vl3d_fused_s2_fwd_layout)."""
    assert FU.kernel_fused_s2_fwd_layout(S, F) == FU.fused_s2_fwd_layout(S, F)


@pytest.mark.parametrize("S,F", [(129, 5), (3, 1025)])
def test_fused_s2_fwd_refuses_past_its_limits(cuda, S, F):
    """K14 takes S <= 128 slots and F <= 1,024 frames, as K15: beyond
    them the launch raises."""
    cfg = FU.FusedCfg(S, *FUSED_S2_FLAGS[0])
    ins, dinv, _ = _fused_s2_inputs(cuda, S, 2, 3, F, 0)
    with pytest.raises(RuntimeError):
        FU.fused_s2_fwd(cfg, *ins, dinv)


def _tile_grad_case(cuda, C, F, seed, N=29, th=6, tw=7, shape=(5, 30, 40)):
    """K10's inputs: samples with non-finite u, v where k < 0, k past the
    last tile on a share (clamped), u and v on the tile edges; a random
    cotangent."""
    k, u, v = (t.to(cuda) for t in _samples(N, th, tw, shape, seed))
    k.view(-1)[100:130] = N + 3
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    v = torch.where(k < 0, torch.full_like(v, float("-inf")), v)
    gen = torch.Generator().manual_seed(seed)
    ct = torch.randn(shape + (F, C), generator=gen).to(cuda)
    return ct, k, u, v, (N, th, tw, F, C)


@pytest.mark.parametrize("tile", [(6, 7), (16, 13)], ids=["6x7", "16x13"])
@pytest.mark.parametrize("C,F", [(4, 6), (4, 50), (13, 5), (36, 5), (3, 3)])
@pytest.mark.parametrize("gather", [torch.float32, torch.bfloat16])
def test_tiles_grad_redesign(cuda, C, F, gather, tile):
    """K10's binned gather on small and larger tiles: finite, within 1e-6 *
    max|g| of its plain version (f32 sums; rounded to bf16: the f32 mode's
    sums rounded, bit for bit, and within one bf16 step and 1e-6 * max|g|
    of the plain sums rounded), within 1e-5 * max|g| of its first design,
    the same bits on a second call, one launch counted, none for the first
    design."""
    ct, k, u, v, shape = _tile_grad_case(cuda, C, F, C + F, th=tile[0],
                                         tw=tile[1])
    before = dict(kernels.LAUNCHES)
    got = S.bilinear_tiles_tilemajor_grad(ct, k, u, v, shape, gather)
    assert kernels.LAUNCHES["bilinear_tiles_tilemajor_grad"] == \
        before["bilinear_tiles_tilemajor_grad"] + 1
    launched = dict(kernels.LAUNCHES)
    first = tiles_tilemajor_grad_first(ct, k, u, v, shape)
    assert kernels.LAUNCHES == launched
    again = S.bilinear_tiles_tilemajor_grad(ct, k, u, v, shape, gather)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.isfinite(got).all()
    # the plain version indexes the tiles as given: k past the last tile
    # clamped for it
    plain = S.bilinear_tiles_tilemajor_grad_plain(
        ct, k.clamp(max=shape[0] - 1), u, v, shape)
    scale = float(plain.abs().max())
    if gather == torch.float32:
        assert (got - plain).abs().max() <= 1e-6 * scale
        assert (got - first).abs().max() <= 1e-5 * scale
        assert torch.equal(got == 0, plain == 0)
    else:
        f32 = S.bilinear_tiles_tilemajor_grad(ct, k, u, v, shape)
        assert torch.equal(got, f32.to(torch.bfloat16).float())
        assert _within_bf16_step(got, plain.to(torch.bfloat16).float(),
                                 1e-6 * scale)


@pytest.mark.parametrize("ts", [None, [5, 0, 3]])
@pytest.mark.parametrize("C", [4, 13])
def test_tiles_tilemajor_f32_as_bf16(cuda, C, ts):
    """K3 on f32 tiles gathered as bf16 returns bit for bit K3's samples of
    the bf16 copy, all frames and a frame subset."""
    tiles = torch.randn((17, 6, 7, 6, C),
                        generator=torch.Generator().manual_seed(C)).to(cuda)
    k, u, v = (t.to(cuda) for t in _samples(17, 6, 7, (5, 30, 40), C))
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32,
                                               device=cuda)
    got, _ = S.bilinear_tiles_tilemajor(tiles, k, u, v, tts, torch.bfloat16)
    old, _ = S.bilinear_tiles_tilemajor(tiles.to(torch.bfloat16), k, u, v,
                                        tts)
    assert torch.equal(got.view(torch.int32), old.view(torch.int32))


def test_sample_tiles_f32_atlas_as_bf16(cuda):
    """Through `sample_tiles` on the f32 tile-major atlas at the bf16
    gather dtype: one launch of K3 and one of K10, the samples bit for bit
    those of the bf16 copy, the gradient f32, every value a bf16 value,
    within one bf16 step of the old chain's (K10's f32 sum cast to bf16
    and back), with no cast or copy in the autograd graph."""
    ct, k, u, v, shape = _tile_grad_case(cuda, 4, 6, 11, shape=(5, 30, 40))
    atlas = torch.randn(shape, generator=torch.Generator().manual_seed(12)
                        ).to(cuda).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    vals, _ = S.sample_tiles(atlas, k, u, v, torch.bfloat16)
    assert vals.grad_fn.next_functions[0][0].variable is atlas
    (vals * ct).sum().backward()
    for name in ("bilinear_tiles_tilemajor", "bilinear_tiles_tilemajor_grad"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    old, _ = S.bilinear_tiles_tilemajor(atlas.detach().to(torch.bfloat16), k,
                                        u, v)
    assert torch.equal(vals.detach(), old)
    assert atlas.grad.dtype == torch.float32
    assert torch.equal(atlas.grad, atlas.grad.to(torch.bfloat16).float())
    chain = tiles_tilemajor_grad_first(ct, k, u, v, shape).to(
        torch.bfloat16).float()
    assert _within_bf16_step(atlas.grad, chain,
                             1e-6 * float(chain.abs().max()))


@pytest.mark.parametrize("shape", [(15, 57600, 4257, 12, 12, 50, 4, 4),
                                   (15, 57600, 4257, 16, 16, 50, 4, 4),
                                   (32, 57600, 4257, 12, 12, 50, 13, 2),
                                   (15, 57600, 4257, 12, 12, 50, 36, 4),
                                   (1, 1, 1, 2, 2, 1, 3, 1),
                                   (5, 1200, 29, 6, 7, 6, 4, 4)])
def test_tiles_grad_layout_matches_the_kernel(cuda, shape):
    """render/sample.py:tiles_grad_layout gives the slices, threads, shared
    bytes and scratch of the kernel's own layout (vl3d_tiles_grad_layout)."""
    assert S.kernel_tiles_grad_layout(*shape) == S.tiles_grad_layout(*shape)


def _fold_case(cuda, view, dtype, parent, seed):
    """y (3, 50, 180, 320) (the stage-2 patch's video) or a small one, a
    plan and random indices for it: the ref view's or the other view's
    lowmem plan, or gpnn_down's full-resolution plan at f = parent."""
    small = view.endswith("small")
    Tx, Ty, H, W = (10, 8, 47, 70) if small else (52, 50, 180, 320)
    psz, strides, macro = ((3, 11, 11), (1, 4, 4), 23 if small else 65) \
        if view.startswith("ref") else ((3, 3, 3), (1, 2, 2),
                                        13 if small else 65)
    gen = torch.Generator().manual_seed(seed)
    y = torch.rand((3, Ty, H, W), generator=gen).to(dtype).to(cuda)
    if parent > 1:
        low, plan, _ = PN.down_plans(Tx, Ty, H, W, psz, strides, macro,
                                     parent)
        grid = low.grid
        n_crops = len(low.hs) * len(low.ws)
    else:
        plan = PN.lowmem_plan(Tx, Ty, H, W, psz, strides, macro)
        grid = plan.grid
        n_crops = len(plan.hs) * len(plan.ws)
    nn = torch.randint(0, grid[1], (n_crops, grid[2] * grid[3], grid[0]),
                       generator=gen, dtype=torch.int32).to(cuda)
    return y, nn, plan


@pytest.mark.parametrize("parent", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["ref", "other", "ref_small",
                                  "other_small"])
def test_nn_fold_redesign_equals_first_design(cuda, view, dtype, parent):
    """K12's redesign (the tile kernel) returns its first design's target
    bit for bit in both modes, on both views' plans at the stage-2 patch
    and on small ones, f32 and bf16 y; within 1e-5 of the plain version;
    one launch counted under its mode's name; the first design adds to no
    launch count."""
    y, nn, plan = _fold_case(cuda, view, dtype, parent, parent)
    name = "nn_fold_parent" if parent > 1 else "nn_fold"
    before = dict(kernels.LAUNCHES)
    got = PN.nn_fold(y, nn, plan, parent)
    assert kernels.LAUNCHES[name] == before[name] + 1
    launched = dict(kernels.LAUNCHES)
    first = nn_fold_first(y, nn, plan, parent)
    assert kernels.LAUNCHES == launched
    assert torch.equal(got.view(torch.int32), first.view(torch.int32))
    assert (got - PN.nn_fold_plain(y, nn, plan, parent)).abs().max() <= 1e-5


@pytest.mark.parametrize("C,T", [(3, 600), (3, 900), (5, 10), (1, 1300)])
def test_nn_fold_long_videos_and_channel_groups(cuda, C, T):
    """K12 where a block stages fewer t than the fitted extent and fewer
    channels than C (long videos: 8 t a block, 2 or 1 channels at a time)
    and with a channel group left over (C = 5: 4 and 1): bit for bit its
    first design, within 1e-5 of the plain version.  Past the limit (2,000
    frames) the launch is refused."""
    gen = torch.Generator().manual_seed(C * T)
    y = torch.rand((C, T, 40, 60), generator=gen).to(cuda)
    plan = PN.lowmem_plan(T, T, 40, 60, (3, 11, 11), (1, 4, 4), 27)
    ntx, nty, nh, nw = plan.grid
    nn = torch.randint(0, nty, (len(plan.hs) * len(plan.ws), nh * nw, ntx),
                       generator=gen, dtype=torch.int32).to(cuda)
    lay = PN.nn_fold_layout(plan, C, T)
    assert lay["tb"] < plan.fit[0] or lay["cg"] < C
    got = PN.nn_fold(y, nn, plan)
    assert torch.equal(got.view(torch.int32),
                       nn_fold_first(y, nn, plan).view(torch.int32))
    assert (got - PN.nn_fold_plain(y, nn, plan)).abs().max() <= 1e-5


def test_nn_fold_refuses_what_does_not_fit(cuda):
    """A block's y of 2,000 frames does not fit the shared memory: the
    launch is refused (no fallback)."""
    y = torch.rand((1, 2000, 40, 60)).to(cuda)
    plan = PN.lowmem_plan(2000, 2000, 40, 60, (3, 11, 11), (1, 4, 4), 27)
    assert PN.nn_fold_layout(plan, 1, 2000)["smem"] > 232448
    ntx, _, nh, nw = plan.grid
    nn = torch.zeros((len(plan.hs) * len(plan.ws), nh * nw, ntx),
                     dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="nn_fold"):
        PN.nn_fold(y, nn, plan)


@pytest.mark.parametrize("view", ["ref", "other", "ref_small", "long"])
def test_nn_fold_layout_matches_the_kernel(cuda, view):
    """losses/patch_nn.py:nn_fold_layout gives the block, the channels
    staged at once, the row, column and temporal maxima and the shared
    bytes of the kernel's own layout (vl3d_nn_fold_layout), for plain and
    parent plans and for videos long enough to shrink the block."""
    if view == "long":
        cases = [(PN.lowmem_plan(T, T, 40, 60, (3, 11, 11), (1, 4, 4), 27),
                  3, T) for T in (500, 600, 900, 1300, 2000)]
    else:
        cases = []
        for f in (1, 2, 3):
            y, _, plan = _fold_case(cuda, view, torch.float32, f, 0)
            cases.append((plan, y.shape[0], y.shape[1]))
    for plan, C, Ty in cases:
        assert PN.kernel_nn_fold_layout(plan, C, Ty) == PN.nn_fold_layout(
            plan, C, Ty)


def _geo_inputs(cuda, frac, seed=0, B=2, D=3, Hv=5, Wv=7, h=30, w=40):
    """Projected vertex grids of a (B, D) sweep whose flat vertices land on
    a regular pixel grid, jiggled by up to frac/2 of a quad, a few vertices
    and one plane behind the camera, and the flat quad guess of every
    sample."""
    rng = np.random.default_rng(seed)
    sx, sy = (w + 6.0) / (Wv - 1), (h + 6.0) / (Hv - 1)
    gx = np.arange(Wv) * sx - 3.0
    gy = np.arange(Hv) * sy - 3.0
    vpx = np.broadcast_to(gx[None, None, None, :], (B, D, Hv, Wv)).copy()
    vpy = np.broadcast_to(gy[None, None, :, None], (B, D, Hv, Wv)).copy()
    vpx += (rng.random(vpx.shape) - 0.5) * frac * sx
    vpy += (rng.random(vpy.shape) - 0.5) * frac * sy
    vz = rng.uniform(1.0, 3.0, (B, D, Hv, Wv))
    vz.reshape(-1)[::17] = -1.0
    vz[0, 1] = -1.0                     # a plane behind the camera
    px = np.arange(w, dtype=np.float32)[None, :]
    py = np.arange(h, dtype=np.float32)[:, None]
    qj0 = np.clip(np.floor((px + 3.0) / sx), 0, Wv - 2)
    qi0 = np.clip(np.floor((py + 3.0) / sy), 0, Hv - 2)
    qi0, qj0 = (np.broadcast_to(q, (B, D, h, w)).astype(np.int32)
                for q in (qi0 + 0 * px, qj0 + 0 * py))
    uvx = np.linspace(0, 60.0, Wv).astype(np.float32)
    uvy = np.linspace(0, 40.0, Hv).astype(np.float32)
    f32 = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(cuda)
           for a in (vpx, vpy, vz, uvx, uvy)]
    i32 = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
           for a in (qi0, qj0)]
    return f32[:3], i32, f32[3:]


@pytest.mark.parametrize("frac", [0.0, 0.6], ids=["flat", "perturbed"])
def test_geo_warp_kernels(cuda, frac):
    """K20 equals its plain version bit for bit (the same barycentric
    operations, one rounding each: the same winners); K21, whose atomics
    add in no fixed order, is within 1e-5 * max|g| of the plain version;
    both through the autograd.Function, one launch each."""
    (vpx, vpy, vz), (qi0, qj0), (uvx, uvy) = _geo_inputs(cuda, frac)
    hw = (41, 61)
    got = GW.geo_warp_fwd(vpx, vpy, vz, qi0, qj0, uvx, uvy, hw)
    ref = GW.geo_warp_fwd_plain(vpx, vpy, vz, qi0, qj0, uvx, uvy, hw)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert 0.3 < got[3].float().mean() < 1 and (got[4] < 0).any()
    gen = torch.Generator(device=cuda).manual_seed(1)
    cts = [torch.randn(qi0.shape, generator=gen, device=cuda)
           for _ in range(3)]
    leaves = [t.clone().requires_grad_(True) for t in (vpx, vpy, vz)]
    before = dict(kernels.LAUNCHES)
    x, y, z, valid = GW._GeoWarp.apply(*leaves, qi0, qj0, uvx, uvy, hw)
    ((x * cts[0]).sum() + (y * cts[1]).sum() + (z * cts[2]).sum()).backward()
    want = GW.geo_warp_bwd_plain(*cts, vpx, vpy, vz, qi0, qj0, got[4], uvx,
                                 uvy)
    for leaf, b in zip(leaves, want):
        assert (leaf.grad - b).abs().max() <= 1e-5 * b.abs().max()
    for name in ("geo_warp_fwd", "geo_warp_bwd"):
        assert kernels.LAUNCHES[name] == before[name] + 1


@pytest.mark.parametrize("case", ["flat", "perturbed", "oblique"])
def test_geo_warp_fwd_redesign(cuda, case):
    """K20 (a block's window and triangle table staged once, candidates
    found without division) bit for bit its first design
    (vl3d_geo_warp_fwd_first) in x, y, z, valid and tri, with corners and
    a plane behind the camera; its headers hold `geo_bwd_layout`'s
    windows, the samples of the global route and the samples, and an
    oblique view over a fine grid sends samples to the global route; one
    launch a call, the first design none."""
    frac, grid = {"flat": (0.0, {}), "perturbed": (0.6, {}),
                  "oblique": (0.6, {"Hv": 40, "Wv": 60})}[case]
    (vpx, vpy, vz), (qi0, qj0), (uvx, uvy) = _geo_inputs(cuda, frac, **grid)
    if case == "oblique":                  # turn the view: guesses spread
        vpx = (vpx * 1.7 + vpy * 0.4).contiguous()
    fwd = (vpx, vpy, vz, qi0, qj0, uvx, uvy, (41, 61))
    before = kernels.LAUNCHES["geo_warp_fwd"]
    got, hdr = GW.geo_warp_fwd(*fwd, with_headers=True)
    assert kernels.LAUNCHES["geo_warp_fwd"] == before + 1
    first = geo_warp_fwd_first(*fwd)
    assert kernels.LAUNCHES["geo_warp_fwd"] == before + 1
    for a, b in zip(got, first):
        assert a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)
    assert torch.equal(got[4], GW.geo_warp_fwd_plain(*fwd)[4])
    lay = GW.geo_bwd_layout(qi0, qj0, *vpx.shape[2:])
    assert torch.equal(hdr[:, :4], lay["windows"])
    assert torch.equal(hdr[:, 4].long(), lay["n_search_global"])
    assert torch.equal(hdr[:, 5].long(), lay["n_samples"])
    assert (int(hdr[:, 4].sum()) > 0) == (case == "oblique")


def _geo_bwd_case(cuda, frac, **shape):
    (vpx, vpy, vz), (qi0, qj0), (uvx, uvy) = _geo_inputs(cuda, frac,
                                                         **shape)
    tri = GW.geo_warp_fwd(vpx, vpy, vz, qi0, qj0, uvx, uvy, (41, 61))[4]
    gen = torch.Generator(device=cuda).manual_seed(2)
    cts = [torch.randn(qi0.shape, generator=gen, device=cuda)
           for _ in range(3)]
    cts[0].view(-1)[::7] = 0.0          # some samples add nothing
    cts[1].view(-1)[::7] = 0.0
    cts[2].view(-1)[::7] = 0.0
    return (*cts, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy)


@pytest.mark.parametrize("frac", [0.0, 0.6], ids=["flat", "perturbed"])
def test_geo_warp_bwd_redesign(cuda, frac):
    """K21 (a block's window summed on chip, a second pass in block order)
    within 1e-5 * max|g| of its plain version and its first design, the
    same bits on two calls; its headers hold `geo_bwd_layout`'s windows
    and counts (no sample overflows here) and the library's plan equals
    the mirror's; the first design adds to no launch count."""
    args = _geo_bwd_case(cuda, frac)
    before = kernels.LAUNCHES["geo_warp_bwd"]
    got, hdr = GW.geo_warp_bwd(*args, with_headers=True)
    again = GW.geo_warp_bwd(*args)
    assert kernels.LAUNCHES["geo_warp_bwd"] == before + 2
    launched = dict(kernels.LAUNCHES)
    first = geo_warp_bwd_first(*args)
    assert kernels.LAUNCHES == launched
    want = GW.geo_warp_bwd_plain(*args)
    for a, b, c, f in zip(got, again, want, first):
        assert torch.equal(a, b)
        assert (a - c).abs().max() <= 1e-5 * c.abs().max()
        assert (a - f).abs().max() <= 1e-5 * c.abs().max()
    gx, gy, gz, vpx, _, _, qi0, qj0, tri = args[:9]
    live = (tri >= 0) & ~((gx == 0) & (gy == 0) & (gz == 0))
    lay = GW.geo_bwd_layout(qi0, qj0, *vpx.shape[2:], tri, live)
    assert torch.equal(hdr[:, :4], lay["windows"])
    assert torch.equal(hdr[:, 4].long(), lay["n_overflow"])
    assert torch.equal(hdr[:, 5].long(), lay["n_live"])
    assert int(hdr[:, 4].sum()) == 0
    klay = GW.kernel_geo_bwd_layout(*qi0.shape, *vpx.shape[2:])
    assert klay == {k: lay[k] for k in klay}


def test_geo_warp_bwd_overflow_route(cuda):
    """A vertex grid finer than a pixel: a block's searches reach more than
    a window takes, and the samples with a corner outside it go by the
    atomic route (counted in the headers, as `geo_bwd_layout` says);
    still within 1e-5 * max|g| of the plain version."""
    args = _geo_bwd_case(cuda, 0.6, Hv=40, Wv=60)
    got, hdr = GW.geo_warp_bwd(*args, with_headers=True)
    want = GW.geo_warp_bwd_plain(*args)
    for a, c in zip(got, want):
        assert (a - c).abs().max() <= 1e-5 * c.abs().max()
    gx, gy, gz, vpx, _, _, qi0, qj0, tri = args[:9]
    live = (tri >= 0) & ~((gx == 0) & (gy == 0) & (gz == 0))
    lay = GW.geo_bwd_layout(qi0, qj0, *vpx.shape[2:], tri, live)
    assert torch.equal(hdr[:, :4], lay["windows"])
    assert torch.equal(hdr[:, 4].long(), lay["n_overflow"])
    assert int(hdr[:, 4].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", [False, True], ids=["rgba", "loop_mask"])
def test_sample_dense_coord_grad_kernel(cuda, dtype, mask):
    """K22 within 1e-5 * max|g| of its plain version (f32 sums in another
    order), on f32 and bf16 texels, with and without the loop-mask
    channel; through sample_dense's autograd only where the coordinates
    require grad."""
    atlas, amask, x, y, g, gm = (t.to(cuda) for t in _dense_inputs(3))
    atlas, amask = atlas.to(dtype), amask.to(dtype)
    m, cm = (amask, gm) if mask else (None, None)
    before = kernels.LAUNCHES["sample_dense_coord_grad"]
    got = S.sample_dense_coord_grad(g, cm, atlas, m, x, y)
    assert kernels.LAUNCHES["sample_dense_coord_grad"] == before + 1
    want = S.bilinear_planes_coord_grad_plain(g, atlas, x, y)
    if mask:
        mw = S.bilinear_planes_coord_grad_plain(gm, amask, x, y)
        want = (want[0] + mw[0], want[1] + mw[1])
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    if dtype == torch.float32:
        a32 = atlas.clone().requires_grad_(True)
        feats, _ = S.sample_dense(a32, None, x, y)
        (feats * g).sum().backward()
        assert kernels.LAUNCHES["sample_dense_coord_grad"] == before + 1
        xr = x.clone().requires_grad_(True)
        feats, _ = S.sample_dense(atlas, None, xr, y)
        (feats * g).sum().backward()
        assert kernels.LAUNCHES["sample_dense_coord_grad"] == before + 2
        ref = S.bilinear_planes_coord_grad_plain(g, atlas, x, y)[0]
        assert (xr.grad - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("mask", [False, True], ids=["rgba", "loop_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [13, 36, 8, 5, 37, 4])
def test_dense_coord_grad_redesign_equals_first_design(cuda, C, dtype, mask):
    """K22 (at C != 4 the staged kernel: a warp's cotangents and terms in
    shared memory, each sample's channels summed in order) bit for bit its
    first design (one thread a sample, vl3d_sample_dense_coord_grad_first)
    with samples far off the plane, on texel columns and at NaN x, one
    launch a call; the staged kernel bit for bit it too where the wrapper
    keeps the first design (C = 4; bf16 at C % 4 != 0) and on an atlas
    one element past the vector alignment (its scalar route); within
    1e-5 * max|g| of the plain version."""
    atlas, amask, x, y, g, gm = (t.to(cuda) for t in _dense_inputs(
        20 + C, h=21, w=37, C=C))
    x.view(-1)[200:210] = float("nan")
    atlas, amask = atlas.to(dtype), amask.to(dtype)
    m, cm = (amask, gm) if mask else (None, None)
    before = kernels.LAUNCHES["sample_dense_coord_grad"]
    got = S.sample_dense_coord_grad(g, cm, atlas, m, x, y)
    assert kernels.LAUNCHES["sample_dense_coord_grad"] == before + 1
    first = sample_dense_coord_grad_first(g, cm, atlas, m, x, y)
    staged = sample_dense_coord_grad_staged(g, cm, atlas, m, x, y)
    shifted = staged
    if C != 4:   # (the C = 4 check of sample_dense wants 16-byte texels)
        store = torch.zeros(atlas.numel() + 1, dtype=dtype, device=cuda)
        store[1:] = atlas.reshape(-1)
        shifted = sample_dense_coord_grad_staged(
            g, cm, store[1:].view(atlas.shape), m, x, y)
    for a, b, c, d in zip(got, first, staged, shifted):
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(c), _bits(b))
        assert torch.equal(_bits(d), _bits(b))
    assert kernels.LAUNCHES["sample_dense_coord_grad"] == before + 1
    want = S.bilinear_planes_coord_grad_plain(g, atlas, x, y)
    if mask:
        mw = S.bilinear_planes_coord_grad_plain(gm, amask, x, y)
        want = (want[0] + mw[0], want[1] + mw[1])
    ok = ~torch.isnan(x)
    for a, b in zip(got, want):
        assert (a - b)[ok].abs().max() <= 1e-5 * b[ok].abs().max()
        assert torch.equal(torch.isnan(a), torch.isnan(b))


@pytest.mark.parametrize("C", [1, 13, 36, 64, 1024])
def test_dense_coord_grad_layout_matches_the_kernel(cuda, C):
    """render/sample.py:dense_coord_grad_layout equals the kernel's
    (vl3d_sample_dense_coord_grad_layout), and both refuse beyond the
    limits; the wrapper raises there on the card."""
    for n in (0, 1, 257, 1843200):
        assert S.kernel_dense_coord_grad_layout(n, C, 32, 576, 1024) == \
            S.dense_coord_grad_layout(n, C, 32, 576, 1024)
    assert S.kernel_dense_coord_grad_layout(10, 1025, 1, 4, 4) is None
    assert S.kernel_dense_coord_grad_layout(10, 13, 2048, 1024, 1024) is None
    x = torch.full((1, 1, 2, 2), 0.5, device=cuda)
    with pytest.raises(ValueError, match="dense_coord_grad_layout"):
        S.sample_dense_coord_grad(
            torch.ones((1, 1, 2, 2, 1025), device=cuda), None,
            torch.ones((1, 3, 3, 1025), device=cuda), None, x, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bilinear_tiles_coord_grad_kernel(cuda, dtype):
    """K23 within 1e-5 * max|g| of its plain version, with u, v exactly on
    the tile edges (the clip's 0.5), past them, and k = -1; through
    sample_tiles' autograd on 4-D tiles."""
    k, u, v = _samples(29, 6, 7, (5, 30, 40), 11)
    u.reshape(-1)[60:100] = 0.0
    v.reshape(-1)[100:140] = 0.0
    u.reshape(-1)[140:160] = 7.5
    k.reshape(-1)[:20] = 28                     # the last tile's far corner
    v.reshape(-1)[:20] = 5.0
    k, u, v = (t.to(cuda) for t in (k, u, v))
    gen = torch.Generator().manual_seed(12)
    tiles = torch.randn((29, 6, 7, 4), generator=gen).to(dtype).to(cuda)
    ct = torch.randn(k.shape + (4,), generator=gen).to(cuda)
    got = S.bilinear_tiles_coord_grad(ct, tiles, k, u, v)
    want = S.bilinear_tiles_coord_grad_plain(ct, tiles, k, u, v)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    ur, vr = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
    before = kernels.LAUNCHES["bilinear_tiles_coord_grad"]
    vals, _ = S.sample_tiles(tiles, k, ur, vr)
    (vals * ct).sum().backward()
    assert kernels.LAUNCHES["bilinear_tiles_coord_grad"] == before + 1
    assert (ur.grad - want[0]).abs().max() <= 1e-5 * want[0].abs().max()


def test_tile_lookup_coords_kernel(cuda):
    """K1's coordinate entry bit for bit against its plain version, and
    against K1's own lookup on the coordinates K1 warps."""
    rng = np.random.default_rng(2)
    D, h, w, nth, ntw = 6, 36, 44, 5, 6
    G = np.zeros((1, D, 3, 3), np.float32)
    for d in range(D):
        G[0, d] = np.diag([1.1, 1.2, 0.04 * (d + 1)]) \
            + rng.normal(0, 0.02, (3, 3))
        G[0, d, :2, 2] = rng.uniform(-4, 8, 2)
    G = torch.from_numpy(G).to(cuda)
    maps = [torch.from_numpy(rng.integers(-1, 30, (D, nth, ntw))
                             .astype(np.int32)).to(cuda) for _ in range(2)]
    span = (51 / nth, 60 / ntw)
    coords, k_s, k_d, fu, fv = R.warp_lookup(G, *maps, h, w, (52, 61), span)
    args = (coords.x, coords.y, coords.valid, *maps, span)
    before = kernels.LAUNCHES["tile_lookup_coords"]
    got = R.tile_lookup_coords(*args)
    assert kernels.LAUNCHES["tile_lookup_coords"] == before + 1
    for a, b in zip(got, R.tile_lookup_coords_plain(*args)):
        assert torch.equal(a, b)
    assert torch.equal(got[0], k_s) and torch.equal(got[1], k_d)
    fu2, fv2 = R.tile_fractions(coords.x, coords.y, got[2], got[3], span)
    assert torch.equal(fu2, fu) and torch.equal(fv2, fv)


SWD_GEOMS = {"ref_view": ((3, 11, 11), (1, 4, 4), 37),
             "other_view": ((3, 3, 3), (1, 2, 2), 64),
             "p5_s3_st2": ((2, 5, 5), (2, 3, 3), 70)}


def _swd_inputs(cuda, psz, P, seed, Tx=12, Ty=9, C=3, H=40, W=53):
    gen = torch.Generator().manual_seed(seed)
    vx = torch.rand((C, Tx, H, W), generator=gen) * 2 - 1
    vy = torch.rand((C, Ty, H, W), generator=gen) * 2 - 1
    rand = SW.normalized_projections(
        torch.randn((P, C) + psz, generator=gen))
    return vx.to(cuda), vy.to(cuda), rand.to(cuda)


@pytest.mark.parametrize("geom", list(SWD_GEOMS))
def test_swd_project_kernel(cuda, geom):
    """K24 within 1e-5 * max|out| of its plain version (f32 sums of d
    products in another order), one launch; on a static clip (every
    frame equal) every column is one value repeated, bit for bit."""
    psz, strides, P = SWD_GEOMS[geom]
    vx, _, rand = _swd_inputs(cuda, psz, P, 1)
    before = kernels.LAUNCHES["swd_project"]
    out = SW.swd_project(vx, rand, psz, strides)
    assert kernels.LAUNCHES["swd_project"] == before + 1
    ref = SW.swd_project_plain(vx, rand, psz, strides)
    assert out.shape == ref.shape
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    static = vx[:, :1].expand_as(vx).contiguous()
    out = SW.swd_project(static, rand, psz, strides)
    assert torch.equal(out, out[..., :1].expand_as(out))


# odd shapes of K24/K26's redesign: (psz, strides, P, (Tx, H, W)): one
# projection; 37 with N = 60, under one 128-column tile; d = 1,089, one
# entry past its last 16-entry stage, at P = 256; d = P = 48, whole stages
# and the first design's zero step (48 % 32 != 0) taken explicitly
SWD_ODD = {"p1": ((3, 3, 3), (1, 2, 2), 1, (12, 40, 53)),
           "n_under_tile": ((3, 3, 3), (1, 2, 2), 37, (5, 9, 11)),
           "d1089_tail1": ((3, 11, 11), (1, 4, 4), 256, (14, 60, 71)),
           "d48_p48": ((1, 4, 4), (1, 2, 2), 48, (5, 9, 21))}
SWD_REDESIGN = {**{k: v + ((12, 40, 53),) for k, v in SWD_GEOMS.items()},
                **SWD_ODD}


@pytest.mark.parametrize("geom", list(SWD_REDESIGN))
def test_swd_redesign_equals_first_design(cuda, geom):
    """K24 and K26 (one register-tiled GEMM core; K26's scratch
    transposed) equal their first designs bit for bit, each launched
    twice with the same bits; the first designs add to no launch count."""
    psz, strides, P, (Tx, H, W) = SWD_REDESIGN[geom]
    vx, _, rand = _swd_inputs(cuda, psz, P, 7, Tx=Tx, H=H, W=W)
    shape = tuple(vx.shape)
    cf, ch, cw = SW._grid(shape, psz, strides)
    gx = torch.randn((P, ch * cw, cf), generator=torch.Generator()
                     .manual_seed(8)).to(cuda)
    before = dict(kernels.LAUNCHES)
    out = SW.swd_project(vx, rand, psz, strides)
    g = SW.swd_project_grad(gx, rand, shape, psz, strides)
    assert torch.equal(out, SW.swd_project(vx, rand, psz, strides))
    assert torch.equal(g, SW.swd_project_grad(gx, rand, shape, psz, strides))
    assert kernels.LAUNCHES["swd_project"] == before["swd_project"] + 2
    assert (kernels.LAUNCHES["swd_project_grad"]
            == before["swd_project_grad"] + 2)
    launched = dict(kernels.LAUNCHES)
    assert torch.equal(out, swd_project_first(vx, rand, psz, strides))
    assert torch.equal(g, swd_project_grad_first(gx, rand, shape, psz,
                                                 strides))
    assert kernels.LAUNCHES == launched


@pytest.mark.parametrize("lengths", [(50, 48), (48, 50), (30, 30), (7, 3)],
                         ids=["x_longer", "y_longer", "equal", "twice"])
@pytest.mark.parametrize("grid", [False, True], ids=["random", "ties"])
def test_swd_sort_l1_kernel(cuda, lengths, grid):
    """K25: gx equal to its plain version's (the same stable ranks, the
    same sums of +-1/N over the copies) and the loss within 1e-6
    relative; on values of a coarse grid (many exact ties) too."""
    nx, ny = lengths
    gen = torch.Generator().manual_seed(3)
    ox = torch.randn((5, 77, nx), generator=gen)
    oy = torch.randn((5, 77, ny), generator=gen)
    if grid:
        ox, oy = (torch.round(v * 2) / 2 for v in (ox, oy))
    perm = torch.randperm(max(lengths) // min(lengths) * min(lengths),
                          generator=gen)
    maps = SW._match_maps(nx, ny, perm, cuda)
    ox, oy = ox.to(cuda), oy.to(cuda)
    before = kernels.LAUNCHES["swd_sort_l1"]
    loss, gx = SW.swd_sort_l1(ox, oy, *maps)
    assert kernels.LAUNCHES["swd_sort_l1"] == before + 1
    ref_loss, ref_gx = SW.swd_sort_l1_plain(ox, oy, *maps)
    assert torch.equal(gx, ref_gx)
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)


def _sort_cols(cuda, nx, ny, kind, seed, P=5, L=77):
    gen = torch.Generator().manual_seed(seed)
    ox = torch.randn((P, L, nx), generator=gen)
    oy = torch.randn((P, L, ny), generator=gen)
    if kind == "ties":
        # a static region: every column of the first 30 one value
        ox[:, :30] = ox[:, :30, :1]
        oy[:, :30] = torch.round(oy[:, :30] * 2) / 2
        ox[:, 30:40] = torch.round(ox[:, 30:40] * 2) / 2
        ox[:, 40:45] = torch.where(ox[:, 40:45] > 0, 0.0, -0.0)
    elif kind == "nan":
        ox[torch.rand(ox.shape, generator=gen) < 0.1] = float("nan")
        oy[torch.rand(oy.shape, generator=gen) < 0.1] = float("nan")
        ox[:, :, 0] = float("nan")
    perm = torch.randperm(max(nx, ny) // min(nx, ny) * min(nx, ny),
                          generator=gen)
    maps = SW._match_maps(nx, ny, perm, cuda)
    return ox.to(cuda), oy.to(cuda), maps


@pytest.mark.parametrize("lengths", [(50, 48), (48, 50), (30, 30), (9, 4),
                                     (4, 9)],
                         ids=["x_longer", "y_longer", "equal", "y_tiled",
                              "x_tiled"])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_swd_sort_l1_redesign_equals_first_design(cuda, lengths, kind):
    """K25 (keys sorted by a warp's bitonic network in registers) bit for
    bit its first design, loss and gx, on finite columns with a static
    region's ties and +-0, x or y matched through a map; gx equal to the
    plain version's; the first design adds to no launch count."""
    ox, oy, maps = _sort_cols(cuda, *lengths, kind, 4)
    loss, gx = SW.swd_sort_l1(ox, oy, *maps)
    launched = dict(kernels.LAUNCHES)
    loss1, gx1 = swd_sort_l1_first(ox, oy, *maps)
    assert kernels.LAUNCHES == launched
    assert torch.equal(loss, loss1) and torch.equal(gx, gx1)
    ref_loss, ref_gx = SW.swd_sort_l1_plain(ox, oy, *maps)
    assert torch.equal(gx, ref_gx)
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)


@pytest.mark.parametrize("lengths", [(65, 63), (63, 65), (1024, 1000),
                                     (1000, 1024), (128, 1024)],
                         ids=["65_x", "65_y", "1024_x", "1024_y",
                              "1024_x_tiled"])
def test_swd_sort_l1_long_columns(cuda, lengths):
    """K25 beyond 64 entries (the network in shared memory): gx equal to
    the plain version's (within 1e-6 * max|g| where x is tiled 8 times:
    the plain version's index_add_ sums a source's copies in another
    order), the loss within 1e-6, and both bit for bit the first
    design's."""
    ox, oy, maps = _sort_cols(cuda, *lengths, "ties", 5, P=2, L=21)
    loss, gx = SW.swd_sort_l1(ox, oy, *maps)
    ref_loss, ref_gx = SW.swd_sort_l1_plain(ox, oy, *maps)
    if maps[0] is None:
        assert torch.equal(gx, ref_gx)
    else:
        assert (gx - ref_gx).abs().max() <= 1e-6 * ref_gx.abs().max()
    assert abs(float(loss) - float(ref_loss)) <= 1e-6 * float(ref_loss)
    loss1, gx1 = swd_sort_l1_first(ox, oy, *maps)
    assert torch.equal(loss, loss1) and torch.equal(gx, gx1)


@pytest.mark.parametrize("lengths", [(50, 48), (48, 50), (90, 90)],
                         ids=["x_longer", "y_longer", "long"])
def test_swd_sort_l1_nans_sort_last(cuda, lengths):
    """Columns with NaNs: K25 sorts them last in index order, as the plain
    version's stable torch.sort: gx equal to it, the loss NaN as its."""
    ox, oy, maps = _sort_cols(cuda, *lengths, "nan", 6)
    loss, gx = SW.swd_sort_l1(ox, oy, *maps)
    ref_loss, ref_gx = SW.swd_sort_l1_plain(ox, oy, *maps)
    assert torch.equal(gx, ref_gx)
    assert torch.isnan(loss) and torch.isnan(ref_loss)


def test_swd_sort_l1_refuses_long_columns(cuda):
    ox = torch.zeros((1, 2, 1025), device=cuda)
    with pytest.raises(ValueError, match="1024"):
        SW.swd_sort_l1(ox, ox, None, None)


@pytest.mark.parametrize("geom", list(SWD_GEOMS))
def test_swd_project_grad_kernel(cuda, geom):
    """K26 within 1e-5 * max|g| of its plain version, one launch, and
    equal bit for bit when launched again (no atomics)."""
    psz, strides, P = SWD_GEOMS[geom]
    vx, _, rand = _swd_inputs(cuda, psz, P, 2)
    cf, ch, cw = SW._grid(vx.shape, psz, strides)
    gx = torch.randn((P, ch * cw, cf), generator=torch.Generator()
                     .manual_seed(4)).to(cuda)
    before = kernels.LAUNCHES["swd_project_grad"]
    got = SW.swd_project_grad(gx, rand, tuple(vx.shape), psz, strides)
    assert kernels.LAUNCHES["swd_project_grad"] == before + 1
    ref = SW.swd_project_grad_plain(gx, rand, tuple(vx.shape), psz, strides)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    again = SW.swd_project_grad(gx, rand, tuple(vx.shape), psz, strides)
    assert torch.equal(got, again)


@pytest.mark.parametrize("geom", ["ref_view", "other_view"])
def test_swd_loss_on_the_card(cuda, geom):
    """`swd_3d_loss` on the card (K24 twice, K25, K26) against the same
    loss on the CPU (the plain versions): value 1e-5 relative, gradient
    1e-5 * max|g|."""
    psz, strides, P = SWD_GEOMS[geom]
    vx, vy, _ = _swd_inputs(cuda, psz, P, 5)
    x, y = (vx + 1) / 2, (vy + 1) / 2
    cfx = (x.shape[1] - psz[0]) // strides[0] + 1
    cfy = (y.shape[1] - psz[0]) // strides[0] + 1
    draws = SW.swd_draws(torch.Generator().manual_seed(6), P, 3, psz[0],
                         psz[1], SW.swd_n_short(cfx, cfy))
    cfg = dict(patch_size=psz[1], patcht_size=psz[0], stride=strides[1],
               stridet=strides[0], num_proj=P)
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = x.to(dev).clone().requires_grad_(True)
        loss = SW.swd_3d_loss(t, y.to(dev), draws=draws, **cfg)
        loss.backward()
        out.append((float(loss), t.grad.cpu()))
    (lk, gk), (lp, gp) = out
    assert abs(lk - lp) <= 1e-5 * lp
    assert (gk - gp).abs().max() <= 1e-5 * gp.abs().max()


def test_swd_mask_branch_refused_on_the_card(cuda):
    """The mask branch is no longer refused on the card: K24 twice, K27
    twice and K28 compute it (see test_swd_mask_kernels)."""
    x = torch.rand((3, 6, 20, 24), device=cuda)
    draws = SW.swd_draws(torch.Generator().manual_seed(0), 4, 3, 3, 3, 0)
    before = dict(kernels.LAUNCHES)
    loss = SW.swd_3d_loss(x, x.clone(), draws=draws, patch_size=3,
                          patcht_size=3, num_proj=4,
                          mask=np.ones((20, 24), np.float32))
    assert float(loss) == 0.0
    assert kernels.LAUNCHES["swd_mask_sort"] == before["swd_mask_sort"] + 2
    assert kernels.LAUNCHES["swd_mask_l1"] == before["swd_mask_l1"] + 1


@pytest.mark.parametrize("static", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("factor", [1, 3])
def test_swd_mask_kernels(cuda, factor, static):
    """K27/K28 against the plain mask branch on the same projections: the
    loss within 1e-6 and the gradient in x equal (both sum an entry's
    copies in increasing matched index), at factor 1 (x longer) and 3 (y
    longer, a deficit), on random clips and on a static x (exact ties)."""
    rng = np.random.default_rng(factor)
    x = rng.random((3, 9, 30, 41)).astype(np.float32)
    y = rng.random((3, 8, 30, 41)).astype(np.float32)
    if static:
        x[:] = x[:, :1]
    mask = np.zeros((30, 41), np.float32)
    mask[5:20, 9:30] = 1.0
    psz, strides = (3, 3, 3), (1, 2, 2)
    sel = SW.mask_patch_columns(mask, 3, 3, 2, 1, n_frames=8)
    order = torch.from_numpy(np.concatenate(
        [np.nonzero(~sel)[0]] + [np.nonzero(sel)[0]] * factor))
    rand = SW.normalized_projections(torch.from_numpy(
        rng.normal(size=(16, 81)).astype(np.float32))).to(cuda)
    ox = SW.swd_project(torch.from_numpy(x * 2 - 1).to(cuda), rand, psz,
                        strides)
    oy = SW.swd_project(torch.from_numpy(y * 2 - 1).to(cuda), rand, psz,
                        strides)
    n_x, n_y = ox.shape[1] * ox.shape[2], int(order.numel())
    n_short = SW.swd_n_short(n_x, n_y)
    perm = torch.from_numpy(rng.permutation(n_short)) if n_short else None
    before = dict(kernels.LAUNCHES)
    loss, gx = SW.swd_mask_sort_l1(ox, oy, order, perm)
    assert kernels.LAUNCHES["swd_mask_sort"] == before["swd_mask_sort"] + 2
    assert kernels.LAUNCHES["swd_mask_l1"] == before["swd_mask_l1"] + 1
    rl, rg = SW.swd_mask_sort_l1_plain(ox.cpu(), oy.cpu(), order,
                                       perm)
    assert abs(float(loss) - float(rl)) <= 1e-6
    assert torch.equal(gx.cpu(), rg)


def _mask_rows(cuda, keyset, P, n, seed):
    """P rows of n f32 keys: random normal, all equal, two distinct values,
    or a mix of +-0, +-inf, denormals and a few normals."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    if keyset == "random":
        return torch.randn((P, n), generator=gen, device=cuda)
    if keyset == "equal":
        return torch.full((P, n), 0.75, device=cuda)
    vals = {"two": [-1.25, 3.5],
            "special": [0.0, -0.0, float("inf"), float("-inf"), 1e-40,
                        -1e-40, 1.4e-45, -1.4e-45, 1e-30, -2.0, 2.0]}[keyset]
    vals = torch.tensor(vals, dtype=torch.float32, device=cuda)
    pick = torch.randint(0, len(vals), (P, n), generator=gen, device=cuda)
    return vals[pick]


@pytest.mark.parametrize("keyset", ["random", "equal", "two", "special"])
@pytest.mark.parametrize("P", [1, 256])
@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 3 * 2048 + 5, 200_003])
def test_swd_mask_sort_kernel(cuda, n, P, keyset):
    """K27's redesign on rows read through a permuted gather, with the
    payload (x's rows) and without (y's): keys equal to a stable
    torch.sort's values, the payload to its indices; the first design
    gives the same keys and payload."""
    vals = _mask_rows(cuda, keyset, P, n, seed=n + P)
    gen = torch.Generator(device=cuda).manual_seed(n)
    gather = torch.randperm(n, generator=gen, device=cuda).to(torch.int32)
    o = torch.empty((P, n, 1), dtype=torch.float32, device=cuda)
    o.view(P, n)[:, gather.long()] = vals
    ref_v, ref_i = torch.sort(vals, dim=1, stable=True)
    ref_k = sort_keys(ref_v)
    before = kernels.LAUNCHES["swd_mask_sort"]
    kx, ix = SW.swd_mask_sort(o, gather, True)
    ky, iy = SW.swd_mask_sort(o, gather, False)
    assert kernels.LAUNCHES["swd_mask_sort"] == before + 2
    assert iy is None
    assert torch.equal(kx, ref_k) and torch.equal(ky, ref_k)
    assert torch.equal(ix, ref_i.to(torch.int32))
    kf, if_ = swd_mask_sort_first(o, gather, True)
    assert torch.equal(kf, kx) and torch.equal(if_, ix)
    kf, _ = swd_mask_sort_first(o, gather, False)
    assert torch.equal(kf, ky)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [None, 0.0])
@pytest.mark.parametrize("case", list(NN_CASES))
def test_nn_argmin_ssim_kernel(cuda, case, alpha, dtype):
    """K11's ssim mode: its indices equal the plain ssim search's except at
    near ties (1e-5 of the plain distance's size: another summation
    order); one launch, counted as nn_argmin_ssim and not as nn_argmin."""
    psz, strides, macro = NN_CASES[case]
    x, y = _nn_inputs(cuda, dtype, 15)
    C, Tx, H, W = x.shape
    for plan in (PN.lowmem_plan(Tx, y.shape[1], H, W, psz, strides, macro),
                 PN.direct_plan(Tx, y.shape[1], H, W, psz, strides)):
        before = dict(kernels.LAUNCHES)
        nn = PN.nn_argmin(x, y, plan, alpha, "ssim")
        assert kernels.LAUNCHES["nn_argmin_ssim"] == before["nn_argmin_ssim"] + 1
        assert kernels.LAUNCHES["nn_argmin"] == before["nn_argmin"]
        dist = PN.nn_dist_plain(x, y, plan, alpha, "ssim")
        ref = torch.argmin(dist, dim=3).to(torch.int32)
        flips = nn != ref
        if flips.any():
            dk = torch.gather(dist, 3, nn.long()[..., None])[..., 0][flips]
            dp = torch.gather(dist, 3, ref.long()[..., None])[..., 0][flips]
            assert ((dk - dp).abs() <= 1e-5 * dp.abs()).all()
        assert flips.float().mean() < 0.01


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor", [2, 3])
def test_nn_fold_parent_kernel(cuda, factor, dtype):
    """K12's parent mode on gpnn_down's full-resolution crops: within 1e-5
    of its plain version, one launch counted as nn_fold_parent; and the
    whole gpnn_down loss on the card against the CPU's (1e-5)."""
    x, y = _nn_inputs(cuda, dtype, 16, Tx=9, Ty=7, H=46, W=61)
    low, full, _ = PN.down_plans(9, 7, 46, 61, (3, 3, 3), (1, 2, 2), 11,
                                 factor)
    ntx = low.grid[0]
    nn = torch.randint(0, low.grid[1], (len(low.hs) * len(low.ws),
                                        low.grid[2] * low.grid[3], ntx),
                       generator=torch.Generator().manual_seed(2),
                       dtype=torch.int32).to(cuda)
    before = dict(kernels.LAUNCHES)
    out = PN.nn_fold(y, nn, full, parent=factor)
    assert kernels.LAUNCHES["nn_fold_parent"] == before["nn_fold_parent"] + 1
    assert kernels.LAUNCHES["nn_fold"] == before["nn_fold"]
    ref = PN.nn_fold_plain(y, nn, full, factor)
    assert (out - ref).abs().max() <= 1e-5
    cfg = dict(patch_size=3, patcht_size=3, stride=2, stridet=1, rou=-2,
               scaling=0.1, macro_block=11, factor=factor, alpha=1e4,
               nn_bf16=dtype == torch.bfloat16)
    xf, yf = x.float(), y.float()
    got = float(PN.gpnn_downsample_loss(xf, yf, **cfg))
    want = float(PN.gpnn_downsample_loss(xf.cpu(), yf.cpu(), **cfg))
    assert abs(got - want) <= 1e-5 * want


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_as_bf16"])
@pytest.mark.parametrize("C", [1, 3, 8, 13, 36, 37])
def test_bilinear_tiles_sweep_equals_first_design(cuda, C, mode):
    """K2 at C != 4 (a block's corners found once, its outputs swept in
    output order) bit for bit its first design (one thread a sample,
    vl3d_bilinear_tiles_first) in each texel mode, with misses (NaN
    coordinates), k past the last tile, coordinates outside the tile, a
    sample count that ends a block early, and into an output that is not
    16-byte aligned (the scalar stores); within 1e-6 of the plain
    version; one launch a call, the first design none."""
    n = 10 * S.bilinear_tiles_layout(1, C)["samples"] + 77
    k, u, v = (t.to(cuda) for t in _samples(29, 12, 12, (n,), C))
    k[::53] = 40
    u[1::7], v[2::7] = -2.5, 12.75
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    tiles = torch.randn((29, 12, 12, C),
                        generator=torch.Generator().manual_seed(C)).to(cuda)
    gather = torch.bfloat16 if mode == "f32_as_bf16" else None
    if mode == "bf16":
        tiles = tiles.to(torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    got, valid = S.bilinear_tiles(tiles, k, u, v, gather)
    first, fvalid = bilinear_tiles_first(tiles, k, u, v, gather)
    assert kernels.LAUNCHES["bilinear_tiles"] == before["bilinear_tiles"] + 1
    assert torch.equal(_bits(got), _bits(first)) and torch.equal(valid,
                                                                 fvalid)
    ref, _ = S.bilinear_tiles_plain(tiles, k.clamp(max=28), u, v, gather)
    assert (got - ref).abs().max() <= 1e-6
    # the scalar stores: an output one float past a 16-byte boundary
    buf = torch.full((n * C + 1,), float("nan"), device=cuda)
    bf16 = tiles.dtype == torch.bfloat16
    err = kernels.library().vl3d_bilinear_tiles(
        tiles.data_ptr(), int(bf16), int(gather is not None), k.data_ptr(),
        u.data_ptr(), v.data_ptr(), n, 29, 12, 12, C, buf[1:].data_ptr(),
        kernels.stream_ptr(cuda))
    assert err == 0
    assert torch.equal(_bits(buf[1:].view(n, C)), _bits(first))


@pytest.mark.parametrize("n,C", [(864000, 13), (864000, 36), (864000, 8),
                                 (1843200, 13), (1000, 1), (1025, 2),
                                 (513, 3), (0, 37), (7, 1024)])
def test_bilinear_tiles_layout_matches_the_kernel(cuda, n, C):
    """render/sample.py:bilinear_tiles_layout is the kernel's own
    (vl3d_bilinear_tiles_layout); both refuse C = 0 and C = 1,025, and
    the wrapper refuses a C it cannot launch."""
    assert S.kernel_bilinear_tiles_layout(n, C) == S.bilinear_tiles_layout(
        n, C)
    for bad in (0, 1025):
        assert S.kernel_bilinear_tiles_layout(n, bad) is None
    k = torch.zeros((5,), dtype=torch.int32, device=cuda)
    u = torch.zeros((5,), device=cuda)
    with pytest.raises(ValueError, match="bilinear_tiles_layout"):
        S.bilinear_tiles(torch.zeros((2, 3, 3, 1025), device=cuda), k, u, u)


TS_CASES = {"all": None, "subset": [6, 0, 3, 3, 1], "run": [2, 3, 4, 5]}


@pytest.mark.parametrize("ts_case", list(TS_CASES))
@pytest.mark.parametrize("mode", ["f32", "bf16", "f32_as_bf16"])
@pytest.mark.parametrize("C", [1, 3, 8, 13, 36, 37])
def test_tilemajor_sweep_equals_first_design(cuda, C, mode, ts_case):
    """K3 at C != 4 (a block's corners found once, its F_sel x C outputs
    swept in output order) bit for bit its first design (one thread a
    (sample, frame), vl3d_bilinear_tiles_tilemajor_first) in each texel
    mode, at F_all = 7 with ts None, a permuted subset
    with a repeat and a contiguous run, with misses (NaN coordinates), k
    past the last tile, coordinates outside the tile, a sample count that
    ends a block early, into an output that is not 16-byte aligned (the
    scalar stores) and from tiles that are not; within 1e-6 of the plain
    version; one launch a call, the first design none."""
    F_sel = 7 if TS_CASES[ts_case] is None else len(TS_CASES[ts_case])
    n = 3 * S.tiles_tilemajor_layout(1, F_sel, C)["samples"] + 17
    k, u, v = (t.to(cuda) for t in _samples(23, 12, 12, (n,), C))
    k[::37] = 30
    u[1::7], v[2::7] = -2.5, 12.75
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    tiles = torch.randn((23, 12, 12, 7, C),
                        generator=torch.Generator().manual_seed(C)).to(cuda)
    gather = torch.bfloat16 if mode == "f32_as_bf16" else None
    if mode == "bf16":
        tiles = tiles.to(torch.bfloat16)
    ts = None if TS_CASES[ts_case] is None else torch.tensor(
        TS_CASES[ts_case], dtype=torch.int32, device=cuda)
    before = dict(kernels.LAUNCHES)
    got, valid = S.bilinear_tiles_tilemajor(tiles, k, u, v, ts, gather)
    first, fvalid = bilinear_tiles_tilemajor_first(tiles, k, u, v, ts, gather)
    assert (kernels.LAUNCHES["bilinear_tiles_tilemajor"]
            == before["bilinear_tiles_tilemajor"] + 1)
    assert torch.equal(_bits(got), _bits(first)) and torch.equal(valid,
                                                                 fvalid)
    ref, _ = S.bilinear_tiles_tilemajor_plain(tiles, k.clamp(max=22), u, v,
                                              ts, gather)
    assert (got - ref).abs().max() <= 1e-6
    # the scalar stores: an output one float past a 16-byte boundary
    buf = torch.full((n * F_sel * C + 1,), float("nan"), device=cuda)
    bf16 = tiles.dtype == torch.bfloat16
    err = kernels.library().vl3d_bilinear_tiles_tilemajor(
        tiles.data_ptr(), int(bf16), int(gather is not None), k.data_ptr(),
        u.data_ptr(), v.data_ptr(), None if ts is None else ts.data_ptr(), n,
        23, 12, 12, 7, F_sel, C, buf[1:].data_ptr(), kernels.stream_ptr(cuda))
    assert err == 0
    assert torch.equal(_bits(buf[1:].view(n, F_sel, C)), _bits(first))
    # tiles one element past a 16-byte boundary
    store = torch.empty((tiles.numel() + 1,), dtype=tiles.dtype, device=cuda)
    store[1:] = tiles.reshape(-1)
    shifted, _ = S.bilinear_tiles_tilemajor(store[1:].view(tiles.shape), k, u,
                                            v, ts, gather)
    assert torch.equal(_bits(shifted), _bits(first))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tilemajor_c4_keeps_its_kernel(cuda, dtype):
    """K3 at C = 4 (the direct decoder) launches the kernel it had: bit for
    bit vl3d_bilinear_tiles_tilemajor_first, with and without ts."""
    tiles = torch.randn((17, 6, 7, 6, 4),
                        generator=torch.Generator().manual_seed(4)
                        ).to(dtype).to(cuda)
    k, u, v = (t.to(cuda) for t in _samples(17, 6, 7, (3, 20, 30), 6))
    for ts in (None, torch.tensor([5, 0, 3], dtype=torch.int32,
                                  device=cuda)):
        got, _ = S.bilinear_tiles_tilemajor(tiles, k, u, v, ts)
        first, _ = bilinear_tiles_tilemajor_first(tiles, k, u, v, ts)
        assert torch.equal(_bits(got), _bits(first))


@pytest.mark.parametrize("n,F_sel,C", [(864000, 50, 13), (864000, 50, 36),
                                       (7372800, 10, 13), (7372800, 10, 36),
                                       (5000, 1, 1), (3, 7, 5), (0, 50, 13),
                                       (9, 12264, 1024)])
def test_tiles_tilemajor_layout_matches_the_kernel(cuda, n, F_sel, C):
    """render/sample.py:tiles_tilemajor_layout is the kernel's own
    (vl3d_bilinear_tiles_tilemajor_layout); both refuse C = 0, C = 1,025,
    no frames and more frames than 48 KB hold, and the wrapper refuses a
    C it cannot launch."""
    assert S.kernel_tiles_tilemajor_layout(n, F_sel, C) == \
        S.tiles_tilemajor_layout(n, F_sel, C)
    for bad_f, bad_c in ((F_sel, 0), (F_sel, 1025), (0, C), (12265, 1024)):
        assert S.kernel_tiles_tilemajor_layout(n, bad_f, bad_c) is None
    k = torch.zeros((5,), dtype=torch.int32, device=cuda)
    u = torch.zeros((5,), device=cuda)
    with pytest.raises(ValueError, match="tiles_tilemajor_layout"):
        S.bilinear_tiles_tilemajor(torch.zeros((2, 3, 3, 2, 1025),
                                               device=cuda), k, u, u)


@pytest.mark.parametrize("n", [1, 1000, 1024, 70001])
@pytest.mark.parametrize("C", [4, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coord_grad_redesign_equals_first_design(cuda, dtype, C, n):
    """K23 (no fill; at C = 4 a hit's corners and cotangent as vectors) bit
    for bit its first design (two zero fills, one thread a sample,
    vl3d_bilinear_tiles_coord_grad_first) with misses (NaN coordinates),
    k past the last tile, u and v on the tile's edges and the last tile's
    far corner (corners past the end); every sample written into outputs
    that start as NaN; tiles one texel past a vector boundary take the
    first design's loop in the same launch, the same bits; within 1e-5 *
    max|g| of the plain version; one launch a call."""
    N, th, tw = 7, 6, 5
    k, u, v = (t.to(cuda) for t in _samples(N, th, tw, (n,), 9 + C))
    u[::9], v[1::9] = 0.0, 0.0
    u[2::9], v[3::9] = tw - 1.0, th - 1.0
    k[4::17], u[4::17], v[4::17] = N - 1, tw - 1.0, th - 1.0
    k[5::23] = N + 1
    u = torch.where(k < 0, torch.full_like(u, float("nan")), u)
    gen = torch.Generator().manual_seed(n)
    store = torch.randn((N * th * tw * C + 1,), generator=gen).to(dtype)
    store = store.to(cuda)
    tiles = store[:-1].view(N, th, tw, C)
    ct = torch.randn((n, C), generator=gen).to(cuda)
    before = dict(kernels.LAUNCHES)
    got = S.bilinear_tiles_coord_grad(ct, tiles, k, u, v)
    first = bilinear_tiles_coord_grad_first(ct, tiles, k, u, v)
    assert (kernels.LAUNCHES["bilinear_tiles_coord_grad"]
            == before["bilinear_tiles_coord_grad"] + 1)
    for a, b in zip(got, first):
        assert torch.equal(_bits(a), _bits(b))
        assert not a[k < 0].any()
    kc = k.clamp(max=N - 1)
    uu = torch.where(k < 0, torch.zeros_like(u), u)
    plain = S.bilinear_tiles_coord_grad_plain(ct, tiles, kc, uu, v)
    for a, b in zip(got, plain):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    # every sample written; then the unaligned tiles' route
    for tt in (tiles, store[1:].view(N, th, tw, C)):
        gu = torch.full((n,), float("nan"), device=cuda)
        gv = torch.full((n,), float("nan"), device=cuda)
        S.launch_coord_grad("vl3d_bilinear_tiles_coord_grad", ct, tt, k, u,
                            v, gu, gv)
        fu, fv = bilinear_tiles_coord_grad_first(ct, tt, k, u, v)
        assert torch.equal(_bits(gu), _bits(fu))
        assert torch.equal(_bits(gv), _bits(fv))


def _k8_case(cuda, B, D, h, w, seed):
    """Random K8 inputs on the card: features with saturated alphas and
    equal neighbours across the tiles' seams (sign(0) = 0), a quarter of
    the samples invalid, random cotangents."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    feats = 2 * torch.randn((B, D, h, w, 4), generator=gen, device=cuda)
    feats[:, :, :, 16::16] = feats[:, :, :, 15::16][
        :, :, :, :feats[:, :, :, 16::16].shape[3]]
    feats[:, :, 8::8] = feats[:, :, 7::8][:, :, :feats[:, :, 8::8].shape[2]]
    feats[:, -1, :2, :3, 3] = 40.0
    valid = torch.rand((B, D, h, w), generator=gen, device=cuda) < 0.75
    mask = torch.randn((B, D, h, w), generator=gen, device=cuda)
    mask[:, :, 8::8] = mask[:, :, 7::8][:, :, :mask[:, :, 8::8].shape[2]]
    dinv = torch.rand((B, D, h, w), generator=gen, device=cuda)
    cts = [torch.randn(s, generator=gen, device=cuda)
           for s in ((B, h, w, 3), (B, h, w), (B, h, w), (B, h, w, 1), (4,))]
    return feats, valid, mask, dinv, cts


@pytest.mark.parametrize("D", [1, 5, 32, 128])
@pytest.mark.parametrize("hw", [(9, 11), (1, 7), (180, 320)],
                         ids=["9x11", "1x7", "180x320"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("flags", FUSED_FLAGS + [
    (False, False, False, False, True, True)])
def test_fused_s1_bwd_redesign_equals_first_design(cuda, flags, B, hw, D):
    """K8 (a pixel tile with its halo, each plane decoded once a pass, T_in
    in shared memory) bit for bit its first design (one thread a pixel,
    vl3d_fused_s1_bwd_first) on d_feats and d_mask, NaNs included (at
    h = 1 the smoothness terms divide by 0), at B = 1, 2, a patch of one
    row, one that ends the tiles early and the shipped 180 x 320, up to
    the 128-plane limit; one launch a call, the first design none."""
    h, w = hw
    cfg = F1.FusedS1Cfg(D, *flags)
    feats, valid, mask, dinv, cts = _k8_case(cuda, B, D, h, w, D + B)
    args = (cfg, feats, valid, mask, dinv, *cts)
    before = kernels.LAUNCHES["fused_s1_bwd"]
    got = F1.fused_s1_bwd(*args)
    first = fused_s1_bwd_first(*args)
    assert kernels.LAUNCHES["fused_s1_bwd"] == before + 1
    assert (got[1] is None) == (first[1] is None) == (not cfg.use_loop)
    for a, b in zip(got, first):
        if a is not None:
            assert torch.equal(_bits(a), _bits(b))
    if h > 1:
        assert torch.isfinite(got[0]).all()


def test_fused_s1_bwd_layout_matches_the_kernel(cuda):
    """render/fused_s1.py:fused_s1_bwd_layout is the kernel's own
    (vl3d_fused_s1_bwd_layout) for D = 1 to 128; D = 129 is refused by
    both, by the wrapper and by the first design."""
    for D in (1, 5, 32, 33, 127, 128):
        assert F1.kernel_fused_s1_bwd_layout(D) == F1.fused_s1_bwd_layout(D)
    assert F1.kernel_fused_s1_bwd_layout(129) is None
    assert F1.kernel_fused_s1_bwd_layout(0) is None
    cfg = F1.FusedS1Cfg(129, True, True, True, False, True, False)
    feats, valid, mask, dinv, cts = _k8_case(cuda, 1, 129, 4, 5, 0)
    for fn in (F1.fused_s1_bwd, fused_s1_bwd_first):
        with pytest.raises(ValueError, match="129"):
            fn(cfg, feats, valid, mask, dinv, *cts)


@pytest.mark.parametrize("D", [1, 2, 5, 32, 129])
@pytest.mark.parametrize("hw", [(9, 11), (1, 7), (180, 320)],
                         ids=["9x11", "1x7", "180x320"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("flags", FUSED_FLAGS + [
    (False, False, False, False, True, True),
    (False, False, False, True, True, False)])
def test_fused_s1_fwd_redesign_equals_first_design(cuda, flags, B, hw, D):
    """K7 (a pixel tile with its one-sided halo, each plane decoded once,
    the pixels' sums reduced by the first design's tree) bit for bit its
    first design (one thread a pixel, vl3d_fused_s1_fwd_first) on out,
    asum, disp, label and the four scalars, NaNs included, and the same
    bits twice, at B = 1, 2, a patch of one row, one that ends the tiles
    early and the shipped 180 x 320, past K8's 128 planes; one launch a
    call, the first design none."""
    h, w = hw
    cfg = F1.FusedS1Cfg(D, *flags)
    feats, valid, mask, dinv, _ = _k8_case(cuda, B, D, h, w, D + 3 * B)
    args = (cfg, feats, valid, mask, dinv)
    before = kernels.LAUNCHES["fused_s1_fwd"]
    got = F1.fused_s1_fwd(*args)
    again = F1.fused_s1_fwd(*args)
    first = fused_s1_fwd_first(*args)
    assert kernels.LAUNCHES["fused_s1_fwd"] == before + 2
    for a, b, c in zip(got, first, again):
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a), _bits(c))
    assert torch.isfinite(got[0]).all()


def test_fused_s1_fwd_layout_matches_the_kernel(cuda):
    """render/fused_s1.py:fused_s1_fwd_layout is the kernel's own
    (vl3d_fused_s1_fwd_layout) at any D; D = 0 is refused by both."""
    for D in (1, 5, 32, 128, 129, 2048):
        assert F1.kernel_fused_s1_fwd_layout(D) == F1.fused_s1_fwd_layout(D)
    assert F1.kernel_fused_s1_fwd_layout(0) is None


def _mask_l1_case(cuda, P, L, cfx, cfy, seed):
    """K27's sorted rows of random projections x (P, L, cfx) and y (P, L,
    cfy), y in a shuffled order, and their plan."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    ox = torch.randn((P, L, cfx), generator=gen, device=cuda)
    oy = torch.randn((P, L, cfy), generator=gen, device=cuda)
    n_x, n_y = L * cfx, L * cfy
    order = torch.randperm(n_y, generator=gen, device=cuda).cpu()
    n_short = SW.swd_n_short(n_x, n_y)
    perm = torch.randperm(n_short, generator=gen, device=cuda) \
        if n_short else None
    plan = SW.swd_mask_plan(n_x, n_y, order, perm, L, cfx, cfy, cuda)
    kx, ix = SW.swd_mask_sort(ox, plan["gather_x"], True)
    ky, _ = SW.swd_mask_sort(oy, plan["gather_y"], False)
    return ox, oy, order, perm, plan, kx, ix, ky


@pytest.mark.parametrize("case", [
    (256, 300, 7, 5), (256, 300, 5, 5), (256, 300, 5, 7), (256, 300, 5, 11),
    (16, 300, 7, 5), (16, 300, 5, 7), (16, 300, 5, 13), (3, 2, 2, 141)],
    ids=["block_x_longer", "block_equal", "block_deficit",
         "block_two_tilings", "global_x_longer", "global_deficit",
         "global_two_tilings", "global_many_copies"])
def test_swd_mask_l1_redesign_equals_first_design(cuda, case):
    """K28 (the signs as bits, in shared memory where a block a row
    reaches every SM, else in device memory) against its first design
    (vl3d_swd_mask_l1_first) and the plain branch on the CPU: the
    gradient bit for bit, the loss within 1 f32 ulp of the first design's
    and 1e-6 of the plain one, the same bits twice; with x longer (n_x =
    n), equal lengths, a deficit, two tilings with a deficit and 70
    copies an entry with a deficit (past the first design's 64: the
    redesign alone), on the block and the global route."""
    P, L, cfx, cfy = case
    ox, oy, order, perm, plan, kx, ix, ky = _mask_l1_case(cuda, P, L, cfx,
                                                          cfy, P + L)
    route = "block" if P == 256 else "global"
    assert SW.swd_mask_l1_layout(P, plan["n"])["route"] == route
    before = kernels.LAUNCHES["swd_mask_l1"]
    loss, gx = SW.swd_mask_l1(kx, ix, ky, plan, L, cfx)
    loss2, gx2 = SW.swd_mask_l1(kx, ix, ky, plan, L, cfx)
    assert kernels.LAUNCHES["swd_mask_l1"] == before + 2
    assert torch.equal(_bits(gx), _bits(gx2))
    assert torch.equal(_bits(loss), _bits(loss2))
    # the plain branch on the CPU, where index_add_ sums an entry's
    # copies in index order (on the card its atomics add in any order)
    lp, gp = SW.swd_mask_sort_l1_plain(ox.cpu(), oy.cpu(), order,
                                       None if perm is None else perm.cpu())
    assert torch.equal(gx.cpu(), gp)
    assert abs(float(loss) - float(lp)) <= 1e-6
    if plan["tiled"] // (L * cfx) > 64:
        with pytest.raises(ValueError, match="64"):
            swd_mask_l1_first(kx, ix, ky, plan, L, cfx)
        return
    lf, gf = swd_mask_l1_first(kx, ix, ky, plan, L, cfx)
    assert torch.equal(_bits(gx), _bits(gf))
    assert abs(int(_bits(loss)) - int(_bits(lf))) <= 1


@pytest.mark.parametrize("case", [(8, 40_000, 40, 55), (2, 300_000, 40, 54)],
                         ids=["8x2.2M", "2x16.2M"])
def test_swd_mask_l1_long_rows(cuda, case):
    """K28 on rows past one block's shared memory against its first
    design: 8 rows of 2.2 M keys and 2 of 16.2 M, the bits in device
    memory (the global route); the gradient bit for bit, the loss within
    1 f32 ulp."""
    P, L, cfx, cfy = case
    assert SW.swd_mask_l1_layout(P, L * cfy)["route"] == "global"
    _, _, _, _, plan, kx, ix, ky = _mask_l1_case(cuda, P, L, cfx, cfy, 5)
    loss, gx = SW.swd_mask_l1(kx, ix, ky, plan, L, cfx)
    lf, gf = swd_mask_l1_first(kx, ix, ky, plan, L, cfx)
    assert torch.equal(_bits(gx), _bits(gf))
    assert abs(int(_bits(loss)) - int(_bits(lf))) <= 1


def test_swd_mask_l1_layout_matches_the_kernel(cuda):
    """losses/swd.py:swd_mask_l1_layout is the kernel's own
    (vl3d_swd_mask_l1_layout) on every route and at its edges; rows of 0
    or 2^30 keys are refused by both."""
    cap = 57_856 * 32
    for P, n in ((256, 168_000), (132, cap), (131, cap), (66, cap + 1),
                 (65, cap + 1), (16, 1_500), (17, 8 * cap),
                 (256, 8 * cap + 1), (1, 2 ** 30 - 1)):
        assert SW.kernel_swd_mask_l1_layout(P, n) == \
            SW.swd_mask_l1_layout(P, n)
    for P, n in ((2, 0), (2, 2 ** 30), (0, 10)):
        assert SW.kernel_swd_mask_l1_layout(P, n) is None
