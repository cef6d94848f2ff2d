"""The staged layout of K11's tensor-core kernel (csrc/nn_argmin_mma.cu),
checked on the CPU: each spatial patch column's frames staged once, each
frame's (c, dy, dx) window zero-padded to the pitch fp
(`staged_frames` below), temporal patch i the pt fp values from frame
i st on (`hankel_rows`).  Its rows must be a permutation of
`extract_patches_3d`'s (plus zeros), and the kernel's dot products, the
frame Gram summed along the band (`banded_frame_dots`), must give
`_pairwise_sqdist`'s distances.  The kernel itself runs on the card
only (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from videoloop3d_torch.losses import patch_nn as PN

# (C, T x, T y, H, W, patch size, strides, macro block): the shipped ref
# view (3x11x11, stride 4/1), the other view (3x3x3, stride 2/1), an odd
# C ph pw with pt = 1, and pt = 3 at a temporal stride of 2
LAYOUTS = {"ref_view": (3, 12, 10, 40, 44, (3, 11, 11), (1, 4, 4), 27),
           "other_view": (3, 9, 8, 20, 22, (3, 3, 3), (1, 2, 2), 13),
           "odd_pt1": (3, 7, 6, 21, 23, (1, 5, 5), (1, 2, 2), 13),
           "st2": (1, 11, 9, 20, 20, (3, 7, 7), (2, 3, 3), 13)}


def hankel_channels(C, psz, fp):
    """Where each flat channel of `extract_patches_3d` ((c, dt, dy, dx)
    order) lies in a row of `hankel_rows`: dt fp + (c ph + dy) pw + dx,
    the (dt, c, dy, dx) order with each frame padded to fp.
    (C pt ph pw,) int64."""
    pt, ph, pw = psz
    c, dt, dy, dx = np.meshgrid(np.arange(C), np.arange(pt), np.arange(ph),
                                np.arange(pw), indexing="ij")
    return torch.as_tensor((dt * fp + (c * ph + dy) * pw + dx).reshape(-1))


def staged_frames(v, plan, fp):
    """K11's tensor-core staging of one crop v (C, T, mh, mw): per spatial
    patch column, each frame's (c, dy, dx) window padded with zeros to fp.
    Returns (nh nw, T, fp)."""
    _, ph, pw = plan.psz
    _, sh, sw = plan.strides
    C, T = v.shape[:2]
    w = v.unfold(2, ph, sh).unfold(3, pw, sw)      # (C, T, nh, nw, ph, pw)
    nh, nw = w.shape[2:4]
    frames = w.permute(2, 3, 1, 0, 4, 5).reshape(nh * nw, T, -1)
    staged = torch.zeros((nh * nw, T, fp), dtype=v.dtype)
    staged[..., :frames.shape[-1]] = frames
    return staged


def hankel_rows(v, plan, fp):
    """The temporal patches as rows of `staged_frames`: patch i is the pt
    fp values from frame i st on (rows overlap; one staged copy serves
    every row).  Returns (nh nw, nt, pt fp)."""
    pt, st = plan.psz[0], plan.strides[0]
    staged = staged_frames(v, plan, fp)
    cols, T = staged.shape[:2]
    nt = (T - pt) // st + 1
    return staged.reshape(cols, T * fp).unfold(1, pt * fp, st * fp)[:, :nt]


def banded_frame_dots(fx, fy, pt, st, ntx, nty):
    """K11's tensor-core dot products from staged frames fx (cols, Tx, fp)
    and fy (cols, Ty, fp): the frame Gram G = fx fy^T, then X_i.Y_j = the
    sum over dt of G(i st + dt, j st + dt), dt ascending.  Returns (cols,
    ntx, nty)."""
    G = torch.bmm(fx, fy.transpose(1, 2))
    i = torch.arange(ntx)[:, None] * st
    j = torch.arange(nty)[None, :] * st
    dots = G[:, i, j]
    for dt in range(1, pt):
        dots = dots + G[:, i + dt, j + dt]
    return dots


def _case(name, seed=0, integers=False):
    C, tx, ty, H, W, psz, strides, macro = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    if integers:
        x = rng.integers(-4, 5, (C, tx, H, W)).astype(np.float32)
        y = rng.integers(-4, 5, (C, ty, H, W)).astype(np.float32)
    else:
        x = rng.uniform(0, 1, (C, tx, H, W)).astype(np.float32)
        y = rng.uniform(0, 1, (C, ty, H, W)).astype(np.float32)
    plan = PN.lowmem_plan(tx, ty, H, W, psz, strides, macro)
    return torch.from_numpy(x), torch.from_numpy(y), plan


def test_frame_pitch():
    """fp: 8 times an odd number, at least C ph pw (368 -> 376 at the ref
    view, 27 -> 40 at the other)."""
    assert PN.mma_frame_pitch(363) == 376
    assert PN.mma_frame_pitch(27) == 40
    for cpp in range(1, 400):
        fp = PN.mma_frame_pitch(cpp)
        assert fp >= cpp and fp % 8 == 0 and (fp // 8) % 2 == 1
        assert fp - cpp < 16


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_hankel_rows_permute_extract_patches(name):
    """The staged rows, read at `hankel_channels`, equal the patches of
    `extract_patches_3d` (flat channel (c, dt, dy, dx)); every other
    position of a row is padding, zero; the positions are distinct."""
    x, _, plan = _case(name)
    C = x.shape[0]
    fp = PN.mma_layout(plan, C)[0]
    ntx, _, nh, nw = plan.grid
    idx = hankel_channels(C, plan.psz, fp)
    assert len(set(idx.tolist())) == idx.numel() == C * int(np.prod(plan.psz))
    pad = torch.ones(plan.psz[0] * fp, dtype=torch.bool)
    pad[idx] = False
    ft, fh, fw = plan.fit
    for crop in PN._crops(x[:, :ft, :fh, :fw], plan):
        rows = hankel_rows(crop, plan, fp)          # (cols, nt, pt fp)
        patches = PN.extract_patches_3d(crop, plan.psz, plan.strides)
        ref = patches.reshape(ntx, nh * nw, -1).transpose(0, 1)
        assert rows.shape == (nh * nw, ntx, plan.psz[0] * fp)
        assert torch.equal(rows[..., idx], ref)
        assert not rows[..., pad].any()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_frame_gram_gives_pairwise_sqdist(name):
    """The dot products of the staged frames' Gram summed along the band
    (f32), of the rows of `hankel_rows`, and the norms from per-frame sums
    of squares summed over dt (the kernel's order) give
    `_pairwise_sqdist`'s distances: bit for bit on integer data, whose
    sums are exact in any order, and within 1e-5 of the term scale on
    uniform data (f32 sums of d products in two orders)."""
    for integers in (True, False):
        x, y, plan = _case(name, seed=1, integers=integers)
        C = x.shape[0]
        fp = PN.mma_layout(plan, C)[0]
        pt, ph, pw = plan.psz
        st = plan.strides[0]
        ntx, nty, nh, nw = plan.grid
        d = C * pt * ph * pw
        ft, fh, fw = plan.fit
        for xc, yc in zip(PN._crops(x[:, :ft, :fh, :fw], plan),
                          PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)):
            hx = hankel_rows(xc, plan, fp)
            hy = hankel_rows(yc, plan, fp)
            gram = banded_frame_dots(staged_frames(xc, plan, fp),
                                        staged_frames(yc, plan, fp),
                                        pt, st, ntx, nty)
            if integers:
                assert torch.equal(gram, torch.bmm(hx, hy.transpose(1, 2)))

            def norms(h):
                # frame i st + k of row i, k ascending
                out = (h[..., :fp] ** 2).sum(-1)
                for k in range(1, pt):
                    out = out + (h[..., k * fp:(k + 1) * fp] ** 2).sum(-1)
                return out
            dist = (norms(hx)[..., :, None] + norms(hy)[..., None, :]
                    - 2 * gram) / d
            X = PN.extract_patches_3d(xc, plan.psz, plan.strides).reshape(
                ntx, nh * nw, d).transpose(0, 1)
            Y = PN.extract_patches_3d(yc, plan.psz, plan.strides).reshape(
                nty, nh * nw, d).transpose(0, 1)
            ref = PN._pairwise_sqdist(X, Y)
            if integers:
                assert torch.equal(dist, ref)
            else:
                scale = (X * X).sum(-1)[..., :, None] / d \
                    + (Y * Y).sum(-1)[..., None, :] / d
                assert ((dist - ref).abs() <= 1e-5 * scale).all()


def test_argmin_smem_follows_the_layout():
    """`_argmin_smem` gives the tensor-core kernel's shared bytes for bf16
    "mse" searches (the ref view: one column of 91,064 B a block; the
    other view: four columns, 84,248 B), the CUDA-core search's
    (`tile_layout`: four ref-view columns on one window, 64,192 B)
    otherwise and for bf16 videos too long to stage (160 frames at the
    ref view: one column of 3 x 3 output tiles), and exceeds _SMEM_LIMIT
    only where the CUDA-core search's distances do not fit either."""
    ref = PN.lowmem_plan(52, 50, 180, 320, (3, 11, 11), (1, 4, 4), 65)
    other = PN.lowmem_plan(52, 50, 180, 320, (3, 3, 3), (1, 2, 2), 65)
    assert PN.mma_layout(ref, 3) == (376, 1, 91064)
    assert PN.mma_layout(other, 3) == (40, 4, 84248)
    assert PN._argmin_smem(ref, 1089, "mse", True) == 91064
    assert PN._argmin_smem(other, 81, "mse", True) == 84248
    lay = PN.tile_layout(ref, 3, "mse")
    assert (lay["ra"], lay["rb"], lay["ncb"], lay["smem"]) == (7, 6, 4, 64192)
    assert PN._argmin_smem(ref, 1089) == 64192
    long = PN.lowmem_plan(160, 158, 180, 320, (3, 11, 11), (1, 4, 4), 65)
    assert PN.mma_layout(long, 3)[2] > PN._SMEM_LIMIT
    lay = PN.tile_layout(long, 3, "mse")
    assert (lay["n_ti"], lay["n_tj"], lay["ncb"]) == (3, 3, 1)
    assert PN._argmin_smem(long, 1089, "mse", True) \
        == PN._argmin_smem(long, 1089) == lay["smem"] == 132800
    assert PN._argmin_smem(long, 1089) <= PN._SMEM_LIMIT
    longer = PN.lowmem_plan(260, 258, 180, 320, (3, 11, 11), (1, 4, 4), 65)
    assert PN._argmin_smem(longer, 1089, "mse", True) > PN._SMEM_LIMIT
