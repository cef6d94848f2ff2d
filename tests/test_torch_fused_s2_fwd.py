"""K14 as redesigned for the card (csrc/fused_s2.cu:
fused_s2_fwd_tile_kernel), emulated on the host from the layout of
``render/fused.py`` (the CUDA kernel does not run on the CPU).

The emulation follows the kernel block by block: a tile of
BWD_TILE_W x BWD_TILE_H pixels with a halo of one column on the right and
one row below (only with a smoothness term on; the corner never); the slot
table (which samples are dynamic, and the static samples' masked values,
each decoded once a block); the frames in chunks
of `fc` (`fused_s2_fwd_layout`); per chunk every slot's dynamic samples of
the tile and halo decoded once, then the slots near -> far, each item's
own value and its right and lower neighbours' read from the table; each
(pixel, frame)'s five sums written at p F + f, then the
first design's reduction (blocks of 256 consecutive (pixel, frame)s summed
by a tree, the blocks' partials by the single-block pass and its tree).
Each product and sum rounds once in f32, as the kernel's intrinsics do.

It is held bit for bit to an emulation of the first design's schedule
(one thread per (pixel, frame), every sample and both neighbours decoded
per slot and frame) on the same sigmoids: out, alpha_sum, the disparity,
every (pixel, frame)'s five sums and the three regularizer scalars; within
1e-6 (outputs) and 2e-5 relative (scalars) of the plain version
(`fused_composite_fwd_plain`) and within 1e-5 and 2e-5 of the JAX
package's `fused_composite`, over all 16 flag combinations, S < D and
S = D, h and w that are not multiples of the tile, F = 1, 5, 23 and 50,
and S = 128.  It also counts the decodes: each static (slot, pixel) at
most three times (its own block and the halos of its left and upper
neighbours' blocks; once without a smoothness term), each dynamic (slot,
pixel, frame) likewise; every output written once.
"""
import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoloop3d_tpu.render import fused as JF
from videoloop3d_torch.render import fused as FU

F32 = np.float32
TW, TH = FU.BWD_TILE_W, FU.BWD_TILE_H
BLOCK = 256           # csrc/common.cuh:kBlock, the first design's block
FLAGS = list(itertools.product([False, True], repeat=4))


def _flag_id(f):
    return "".join(c if on else "-" for c, on in zip("sraD", f))


def _inputs(S, h, w, F, seed):
    rng = np.random.default_rng(seed)
    vals_s = (2 * rng.standard_normal((S, h, w, 4))).astype(F32)
    vals_d = (2 * rng.standard_normal((S, h, w, F, 4))).astype(F32)
    m_s, hit_d, m_d = (rng.random((S, h, w)) < p for p in (0.7, 0.4, 0.6))
    # whole slots static or dynamic, as the compacted sweeps hold them
    hit_d[0] = False
    hit_d[-1] = True
    dinv = rng.random((S, h, w)).astype(F32)
    return (vals_s, m_s, vals_d, hit_d, m_d), dinv


def _sigmoid(v):
    """The decode's sigmoids, computed once for every sample: both
    emulations read the same values."""
    return torch.sigmoid(torch.from_numpy(v)).numpy()


def _masked(sg, vm):
    """decode()'s masked rgb and alpha from the sigmoids (..., 4)."""
    m = np.where(vm, F32(1), F32(0))[..., None]
    return np.concatenate([sg[..., :3] * m,
                           np.where(vm, sg[..., 3], F32(0))[..., None]], -1)


def _absdiff(a, b):
    return np.abs(a - b)


class _Items:
    """The running values of a set of items (pixel, frame) over the slots:
    the composite, the disparity, the sparsity sums and the first design's
    sums[1..4], each step rounded as the kernel rounds it."""

    def __init__(self, shape):
        z = np.zeros(shape, F32)
        self.T = np.ones(shape, F32)
        self.o = [z.copy(), z.copy(), z.copy()]
        self.asum, self.disp, self.l1, self.l2 = (z.copy(), z.copy(),
                                                  z.copy(), z.copy())
        self.sums = [z.copy() for _ in range(5)]

    def slot(self, cfg, cv, dv, right, down):
        """One slot: cv the items' masked values (..., 4), dv their slot's
        reciprocal depth; right / down (has, masked values) or None."""
        a = cv[..., 3]
        bw = a * self.T
        for c in range(3):
            self.o[c] = self.o[c] + cv[..., c] * bw
        self.asum = self.asum + bw
        if cfg.want_disp:
            self.disp = self.disp + dv * bw
        self.T = self.T * (F32(1) - a)
        if cfg.use_sparsity:
            self.l1 = self.l1 + np.abs(a)
            self.l2 = self.l2 + a * a
        for nb, (i_rgb, i_a) in ((right, (1, 3)), (down, (2, 4))):
            if nb is None:
                continue
            has, n = nb
            rgb = ((_absdiff(n[..., 0], cv[..., 0])
                    + _absdiff(n[..., 1], cv[..., 1]))
                   + _absdiff(n[..., 2], cv[..., 2]))
            self.sums[i_rgb] = np.where(has, self.sums[i_rgb] + rgb,
                                        self.sums[i_rgb])
            self.sums[i_a] = np.where(
                has, self.sums[i_a] + _absdiff(n[..., 3], cv[..., 3]),
                self.sums[i_a])

    def finish(self, cfg, sp_eps):
        """(out (..., 3), alpha_sum, disp, the five sums (..., 5))."""
        sums = list(self.sums)
        if cfg.use_sparsity:
            sums[0] = self.l1 / np.fmax(np.sqrt(self.l2), sp_eps)
        return (np.stack(self.o, -1), self.asum, self.disp,
                np.stack(sums, -1))


def _smooth(cfg):
    return cfg.use_rgb_smooth or cfg.use_a_smooth


def emulate_tile(cfg, ins, dinv, sig_s, sig_d, counts):
    """K14's redesign, block by block.  counts: dict of decode counters
    ("static" (S, h, w), "dynamic" (S, h, w, F)).  Returns (out, alpha_sum,
    disp, the (h, w, F, 5) sums) and the writes of each output."""
    _, m_s, vals_d, hit_d, m_d = ins
    S, h, w, F, _ = vals_d.shape
    smooth = _smooth(cfg)
    sp_eps = F32(cfg.sp_eps)
    fc = FU.fused_s2_fwd_layout(S, F)["fc"]
    out = np.full((h, w, F, 3), np.nan, F32)
    asum = np.full((h, w, F), np.nan, F32)
    disp = np.full((h, w, F), np.nan, F32)
    sums = np.full((h, w, F, 5), np.nan, F32)
    writes = np.zeros((h, w, F), np.int64)
    hh, hw_ = np.meshgrid(np.arange(TH + 1), np.arange(TW + 1), indexing="ij")
    own = (hh < TH) & (hw_ < TW)
    need = own | (smooth & ~((hh == TH) & (hw_ == TW)))
    for i0 in range(0, h, TH):
        for j0 in range(0, w, TW):
            ii, jj = i0 + hh, j0 + hw_
            valid = need & (ii < h) & (jj < w)
            ic, jc = np.clip(ii, 0, h - 1), np.clip(jj, 0, w - 1)
            # the slot table: flags and the static samples' masked values
            dyn = hit_d[:, ic, jc] & valid               # (S, TH+1, TW+1)
            vm = np.where(dyn, m_d[:, ic, jc], m_s[:, ic, jc]) & valid
            sdec = _masked(sig_s[:, ic, jc], vm)         # (S, TH+1, TW+1, 4)
            for s in range(S):
                sel = valid & ~dyn[s]
                np.add.at(counts["static"][s], (ii[sel], jj[sel]), 1)
            oi, oj = ic[:TH, :TW], jc[:TH, :TW]
            in_img = valid[:TH, :TW]
            has_r = (jj[:TH, :TW] + 1 < w)[..., None]
            has_d = (ii[:TH, :TW] + 1 < h)[..., None]
            for f0 in range(0, F, fc):
                fr = slice(f0, min(f0 + fc, F))
                nf = fr.stop - f0
                it = _Items((TH, TW, nf))
                for s in range(S - 1, -1, -1):
                    # the chunk's dynamic samples of the tile and halo
                    dsel = dyn[s]
                    np.add.at(counts["dynamic"][s], (ii[dsel], jj[dsel]),
                              np.eye(F, dtype=np.int64)[fr].sum(0))
                    dec = _masked(sig_d[s, ic, jc, fr],
                                  vm[s][..., None])     # (TH+1, TW+1, nf, 4)
                    val = np.where(dyn[s][..., None, None], dec,
                                   sdec[s][:, :, None, :])
                    it.slot(cfg, val[:TH, :TW], dinv[s, oi, oj][..., None],
                            (has_r, val[:TH, 1:]) if smooth else None,
                            (has_d, val[1:, :TW]) if smooth else None)
                o, a, d, sm = it.finish(cfg, sp_eps)
                out[oi[in_img], oj[in_img], fr] = o[in_img]
                asum[oi[in_img], oj[in_img], fr] = a[in_img]
                disp[oi[in_img], oj[in_img], fr] = d[in_img]
                sums[oi[in_img], oj[in_img], fr] = sm[in_img]
                writes[oi[in_img], oj[in_img], fr] += 1
    return (out, asum, disp, sums), writes


def emulate_first(cfg, ins, dinv, sig_s, sig_d):
    """K14's first design: every (pixel, frame) at once, each sample and
    its right and lower neighbours decoded per slot and frame."""
    _, m_s, vals_d, hit_d, m_d = ins
    S, h, w, F, _ = vals_d.shape
    vmk = np.where(hit_d, m_d, m_s)[..., None]             # (S, h, w, 1)
    sg = np.where(hit_d[..., None, None], sig_d, sig_s[:, :, :, None, :])
    cv = _masked(sg, vmk)                                  # (S, h, w, F, 4)
    smooth = _smooth(cfg)
    has_r = (np.arange(w) + 1 < w)[None, :, None]
    has_d = (np.arange(h) + 1 < h)[:, None, None]
    it = _Items((h, w, F))
    for s in range(S - 1, -1, -1):
        x = cv[s]
        right = np.concatenate([x[:, 1:], np.zeros_like(x[:, :1])], 1)
        down = np.concatenate([x[1:], np.zeros_like(x[:1])], 0)
        it.slot(cfg, x, dinv[s][..., None],
                (has_r, right) if smooth else None,
                (has_d, down) if smooth else None)
    return it.finish(cfg, F32(cfg.sp_eps))


def _tree(rows):
    """The kernels' fixed-order tree over rows (..., 256): red[t] +=
    red[t + half], half = 128, 64, ..., 1."""
    red = rows.copy()
    half = BLOCK // 2
    while half:
        red[..., :half] = red[..., :half] + red[..., half:2 * half]
        half //= 2
    return red[..., 0]


def reduce_sums(cfg, sums, S, h, w, F):
    """The first design's reduction of the (h, w, F, 5) sums: each block of
    256 consecutive (pixel, frame)s by the tree (fused_s2_fwd_kernel, or
    fused_s2_sums_kernel on the redesign's scratch), the partials strided
    over 256 threads and by the tree (fused_s2_reduce_kernel), then the
    three scalars."""
    flat = sums.reshape(-1, 5)
    nb = -(-flat.shape[0] // BLOCK)
    pad = np.zeros((nb * BLOCK, 5), F32)
    pad[:flat.shape[0]] = flat
    partials = _tree(pad.reshape(nb, BLOCK, 5).transpose(0, 2, 1))  # (nb, 5)
    acc = np.zeros((BLOCK, 5), F32)
    for t in range(BLOCK):
        for blk in range(t, nb, BLOCK):
            acc[t] = acc[t] + partials[blk]
    red = _tree(acc.T)                                            # (5,)
    n = FU._norms(cfg, S, h, w, F)
    f = {k: F32(v) for k, v in n.items()}
    return np.array([(red[0] / f["n_pix"]) / f["sqrt_planes"],
                     red[1] / f["n_rgb_dx"] + red[2] / f["n_rgb_dy"],
                     red[3] / f["n_dx"] + red[4] / f["n_dy"]], F32)


def _check(flags, S, D, h, w, F, seed, jax_too=True):
    cfg = FU.FusedCfg(D, *flags)
    ins, dinv = _inputs(S, h, w, F, seed)
    sig_s, sig_d = _sigmoid(ins[0]), _sigmoid(ins[2])
    counts = {"static": np.zeros((S, h, w), np.int64),
              "dynamic": np.zeros((S, h, w, F), np.int64)}
    tile, writes = emulate_tile(cfg, ins, dinv, sig_s, sig_d, counts)
    assert (writes == 1).all()
    assert not any(np.isnan(a).any() for a in tile)
    first = emulate_first(cfg, ins, dinv, sig_s, sig_d)
    for a, b in zip(tile, first):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    regs = reduce_sums(cfg, tile[3], S, h, w, F)
    on = np.array([cfg.use_sparsity, cfg.use_rgb_smooth, cfg.use_a_smooth])

    hit = ins[3]
    stat, dyn = counts["static"], counts["dynamic"]
    most = 3 if _smooth(cfg) else 1
    assert (stat[~hit] >= 1).all() and stat.max() <= most
    assert not stat[hit].any()
    assert (dyn[hit] >= 1).all() and dyn.max() <= most
    assert not dyn[~hit].any()

    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in ins]
    p_out, p_asum, p_disp, p_regs = FU.fused_composite_fwd_plain(
        cfg, *t, torch.from_numpy(dinv))
    for got, ref in ((tile[0], p_out), (tile[1], p_asum), (tile[2], p_disp)):
        assert np.abs(got - ref.numpy()).max() <= 1e-6
    p_regs = p_regs.numpy()
    assert (np.abs(regs - p_regs)[on]
            <= 2e-5 * np.abs(p_regs[on]) + 1e-8).all()
    if not jax_too:
        return
    jcfg = JF.FusedCfg(D, *flags)
    j_out, j_asum, j_disp, j_regs = JF.fused_composite(
        jcfg, *(jnp.asarray(a) for a in ins), jnp.asarray(dinv))
    pairs = [(tile[0], j_out), (tile[1], j_asum)]
    if cfg.want_disp:
        pairs.append((tile[2], j_disp))
    for got, ref in pairs:
        assert np.abs(got - np.asarray(ref)).max() <= 1e-5
    for i, k in enumerate(FU.REG_NAMES):
        assert (k in j_regs) == bool(on[i])
        if k in j_regs:
            ref = float(j_regs[k])
            assert abs(float(regs[i]) - ref) <= 2e-5 * abs(ref) + 1e-8


@pytest.mark.parametrize("n_slots", [6, 10], ids=["S<D", "S=D"])
@pytest.mark.parametrize("flags", FLAGS, ids=[_flag_id(f) for f in FLAGS])
def test_tile_schedule_every_flag_set(flags, n_slots):
    """Every flag combination at S < D and S = D on a 13 x 17 patch (not
    multiples of the 8 x 4 tile) over 5 frames (one chunk)."""
    _check(flags, n_slots, 10, 13, 17, 5, sum(flags) + n_slots)


@pytest.mark.parametrize("F", [1, 23, 50])
@pytest.mark.parametrize("flags", [(True, True, True, True),
                                   (False, True, True, False)],
                         ids=["sraD", "-ra-"])
def test_tile_schedule_frame_chunks(flags, F):
    """F = 1 (chunks of one frame), 23 (three chunks of 8, the last of
    7) and 50 (five chunks of 10): the chunks cover the frames once, and
    the reduction's blocks of 256 cross pixels and chunks."""
    assert FU.fused_s2_fwd_layout(7, F)["fc"] == {1: 1, 23: 8, 50: 10}[F]
    _check(flags, 7, 32, 9, 11, F, F, jax_too=F < 50)


def test_tile_schedule_at_the_slot_limit():
    """S = 128 (the kernel's limit) over three frames: chunks of one
    frame."""
    lay = FU.fused_s2_fwd_layout(128, 3)
    assert lay["smem"] <= FU.BWD_SMEM_TWO
    _check((True, True, True, True), 128, 128, 5, 9, 3, 0, jax_too=False)


def test_reduction_emulation_is_the_plain_sum():
    """The tree emulation on known values: the sums of 1,000 ones and of a
    ramp, exact in f32, at any number of blocks."""
    cfg = FU.FusedCfg(4, True, True, True, False)
    h, w, F = 10, 20, 5
    ones = np.ones((h, w, F, 5), F32)
    regs = reduce_sums(cfg, ones, 3, h, w, F)
    n = FU._norms(cfg, 3, h, w, F)
    assert regs[0] == F32(F32(h * w * F) / F32(n["n_pix"])) / F32(
        math.sqrt(4))
    ramp = np.arange(h * w * F * 5, dtype=F32).reshape(h, w, F, 5) % 7
    regs = reduce_sums(cfg, ramp, 3, h, w, F)
    tot = ramp.reshape(-1, 5).astype(np.float64).sum(0)
    assert regs[1] == F32(F32(tot[1]) / F32(n["n_rgb_dx"])) + F32(
        F32(tot[2]) / F32(n["n_rgb_dy"]))


@pytest.mark.parametrize("S,F,fc", [(15, 50, 10), (29, 50, 5), (32, 50, 4),
                                    (128, 50, 1), (128, 1, 1), (1, 1, 1),
                                    (15, 1024, 10), (7, 9, 9), (7, 23, 8)])
def test_layout(S, F, fc):
    """The shipped shapes' layout (S = 15 slots at 50 frames: chunks of 10,
    320 threads; the trainer's S = 29: chunks of 5; D = 32 planes: chunks
    of 4, so that the value table of every slot, pixel and frame of a chunk
    leaves room for two blocks an SM) and the limits."""
    lay = FU.fused_s2_fwd_layout(S, F)
    assert lay["fc"] == fc and lay["threads"] == TW * TH * fc
    assert lay["smem"] <= FU.BWD_SMEM_TWO
    assert lay["smem"] >= 16 * S * FU.FWD_HALO * fc
