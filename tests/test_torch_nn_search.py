"""The CUDA-core NN search of K18 and of K11's "mse" and ssim modes
(csrc/nn_argmin.cu:nn_tile_search_kernel), emulated on the CPU.

The kernel runs on the card only (tests/test_torch_cuda.py holds it bit
for bit against its first design there); here numpy follows its index
arithmetic at small sizes of the shipped shapes: the eval's three patch
scales and the Loop Quality seam (K18), the two training views (K18) and
the two views' ssim and "mse" searches (K11).  Checked: every output of a
column is one thread's register slot exactly once; the loader's warp
tasks fill each staged slot once, and each chain reads the staged window
at the entries of `extract_patches_3d`, q ascending; the Gram of those
chains gives `_pairwise_sqdist`, the banded distance and
`_pairwise_ssim_dist` (and the JAX package's); the one +0 step where d %
32 != 0 keeps the first design's bits; the lane-group searches return
the serial rule's index and value on rows with NaNs, exact ties and
signed zeros; `_argmin_smem` and `_band_smem` are the bytes the emulated
layout touches."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoloop3d_tpu.losses import patch_nn as J
from videoloop3d_torch.losses import patch_nn as PN

# name: (mode, C, Tx, Ty, H, W, patch size, strides, macro block), cut to
# size from the eval pair (p 5 / 11 / 17 at strides 2 / 4 / 6, pt 7 / 5 /
# 3), its seam (2 (pt - 1) frames of x), the stage-2 views (3x11x11 at
# 4/1, 3x3x3 at 2/1) and a video long enough for several output tiles
CASES = {
    "eval_p5": ("band", 3, 12, 12, 24, 30, (7, 5, 5), (1, 2, 2), 15),
    "eval_p11": ("band", 3, 10, 10, 30, 38, (5, 11, 11), (1, 4, 4), 23),
    "eval_p17": ("band", 3, 8, 8, 34, 46, (3, 17, 17), (1, 6, 6), 29),
    "seam_p11": ("band", 3, 8, 10, 30, 38, (5, 11, 11), (1, 4, 4), 23),
    "train_ref": ("band", 3, 10, 8, 30, 38, (3, 11, 11), (1, 4, 4), 23),
    "train_other": ("band", 3, 9, 8, 20, 22, (3, 3, 3), (1, 2, 2), 13),
    "ssim_ref": ("ssim", 3, 10, 8, 30, 38, (3, 11, 11), (1, 4, 4), 23),
    "ssim_other": ("ssim", 3, 9, 8, 20, 22, (3, 3, 3), (1, 2, 2), 13),
    "mse_ref": ("mse", 3, 10, 8, 30, 38, (3, 11, 11), (1, 4, 4), 23),
    "long_band": ("band", 1, 70, 68, 9, 11, (3, 3, 3), (1, 2, 2), 7),
    "long_ssim": ("ssim", 1, 70, 68, 9, 11, (3, 3, 3), (1, 2, 2), 7),
}

# The layouts at the shipped shapes (the eval pair at 280x560, 50 frames;
# the stage-2 search of a 180x320 patch, 52 x 50 frames), whose shared
# bytes chip_smoke.py holds to the kernel's own (vl3d_nn_tile_smem) on the
# card: (ra, rb, ncb, chunks, nb, threads, smem)
SHIPPED = {
    ("band", (50, 50, 280, 560, (7, 5, 5), (1, 2, 2))):
        (7, 7, 4, 8, 5, 256, 86784),
    ("band", (50, 50, 280, 560, (5, 11, 11), (1, 4, 4))):
        (7, 7, 4, 4, 3, 256, 103168),
    ("band", (50, 50, 280, 560, (3, 17, 17), (1, 6, 6))):
        (7, 7, 3, 3, 2, 192, 85680),
    ("band", (52, 50, 180, 320, (3, 11, 11), (1, 4, 4))):
        (7, 7, 4, 4, 3, 256, 107840),
    ("band", (52, 50, 180, 320, (3, 3, 3), (1, 2, 2))):
        (7, 7, 4, 8, 3, 256, 84032),
    ("ssim", (52, 50, 180, 320, (3, 11, 11), (1, 4, 4))):
        (7, 6, 4, 4, 3, 256, 74440),
    ("ssim", (52, 50, 180, 320, (3, 3, 3), (1, 2, 2))):
        (7, 6, 4, 8, 3, 256, 43784),
    ("mse", (52, 50, 180, 320, (3, 11, 11), (1, 4, 4))):
        (7, 6, 4, 4, 3, 256, 64192),
}


@pytest.mark.parametrize("mode,shape", list(SHIPPED))
def test_shipped_layouts_are_the_kernels(mode, shape):
    """`tile_layout` at the shipped shapes gives the layouts the kernel
    computed for them on the card."""
    plan = PN.lowmem_plan(*shape, 65)
    lay = PN.tile_layout(plan, 3, mode)
    keys = ("ra", "rb", "ncb", "chunks", "nb", "threads", "smem")
    assert tuple(lay[k] for k in keys) == SHIPPED[(mode, shape)]


def _case(name, integers=True, seed=0):
    mode, C, tx, ty, H, W, psz, strides, macro = CASES[name]
    rng = np.random.default_rng(seed)
    if integers:
        x = rng.integers(0, 9, (C, tx, H, W)).astype(np.float32)
        y = rng.integers(0, 9, (C, ty, H, W)).astype(np.float32)
    else:
        x = rng.uniform(0, 1, (C, tx, H, W)).astype(np.float32)
        y = rng.uniform(0, 1, (C, ty, H, W)).astype(np.float32)
    plan = PN.lowmem_plan(tx, ty, H, W, psz, strides, macro)
    return mode, x, y, plan


class Emu:
    """The kernel's geometry for one plan: csrc/nn_argmin.cu's names."""

    def __init__(self, plan, C, mode):
        self.L = PN.tile_layout(plan, C, mode)
        self.plan, self.C, self.mode = plan, C, mode
        (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
        ntx, nty, nh, nw = plan.grid
        self.band = mode == "band"
        self.nx = (ntx - 1) * st + pt if self.band else ntx
        self.ny = (nty - 1) * st + pt if self.band else nty
        self.ptd = 1 if self.band else pt
        self.rst = 1 if self.band else st
        self.d = C * self.ptd * ph * pw
        self.n_bands = -(-ph // self.L["nb"])
        self.n_st = C * self.ptd * self.n_bands

    def blocks(self):
        """(crop, column row, chunk, columns, first column) per block."""
        L, (_, _, nh, nw) = self.L, self.plan.grid
        n_crops = len(self.plan.hs) * len(self.plan.ws)
        for blk in range(n_crops * nh * L["chunks"]):
            crop, rem = divmod(blk, nh * L["chunks"])
            b_row, chunk = divmod(rem, L["chunks"])
            cnt = min(L["ncb"], nw - chunk * L["ncb"])
            yield crop, b_row, chunk, cnt, crop * nh * nw + b_row * nw \
                + chunk * L["ncb"]

    def stage(self, s):
        """(c, dt, dy0, dy rows) of stage s."""
        nb = self.L["nb"]
        c, rem = divmod(s, self.ptd * self.n_bands)
        dt, band = divmod(rem, self.n_bands)
        return c, dt, band * nb, min(nb, self.plan.psz[1] - band * nb)

    def issue(self, s, cnt, nxr, nyr):
        """The loader's copies of stage s into ring buffer 0: per copy its
        shared offset and (side, row r, dy row l, window position u).
        Warp tasks (side, l, group of 8 positions), lanes 8 positions x 4
        rows, rows stepped by 4."""
        L = self.L
        _, _, _, nbr = self.stage(s)
        pw, sw = self.plan.psz[2], self.plan.strides[2]
        wreal = pw + (cnt - 1) * sw
        n_ug = -(-wreal // 8)
        nwarps = L["threads"] // 32
        out = []
        for warp in range(nwarps):
            for t in range(warp, 2 * nbr * n_ug, nwarps):
                is_y, rest = t % 2, t // 2
                l, ug = divmod(rest, n_ug)
                for lane in range(32):
                    u, rl = ug * 8 + lane % 8, lane // 8
                    if u >= wreal:
                        continue
                    pitch = L["py"] if is_y else L["px"]
                    base = L["nb"] * L["wb"] * L["px"] if is_y else 0
                    for r in range(rl, nyr if is_y else nxr, 4):
                        out.append((base + (l * L["wb"] + u) * pitch + r,
                                    is_y, r, l, u))
        return out

    def entry(self, side, g, r, l, dx):
        """Where column g's chain entry (dy0 + l, dx) of row r lies in a
        stage."""
        L = self.L
        pos = l * L["wb"] + g * self.plan.strides[2] + dx
        if side:
            return L["nb"] * L["wb"] * L["px"] + pos * L["py"] + r
        return pos * L["px"] + r


def slot_row(r, t, a):
    """csrc/nn_argmin.cu:slot_row: row a of thread t's r rows, the pairs
    16 p + 2 t (+1), then 16 (r // 2) + t where r is odd."""
    return 16 * (a // 2) + 2 * t + a % 2 if a < r // 2 * 2 \
        else 16 * (r // 2) + t


@pytest.mark.parametrize("r", [6, 7, 8])
def test_slot_rows_are_float2_pairs(r):
    """The rows a thread reads as float2 start at even offsets, and the 8
    threads' rows are 0 .. 8 r - 1 once."""
    rows = [slot_row(r, t, a) for t in range(8) for a in range(r)]
    assert sorted(rows) == list(range(8 * r))
    for t in range(8):
        for a in range(0, r // 2 * 2, 2):
            assert slot_row(r, t, a) % 2 == 0
            assert slot_row(r, t, a + 1) == slot_row(r, t, a) + 1


@pytest.mark.parametrize("name", list(CASES))
def test_thread_slots_cover_each_output_once(name):
    """Thread (ti, tj) of an output tile's 8 x 8 holds rows slot_row(ti,
    a) and columns slot_row(tj, b) (a < ra, b < rb); over the n_ti x n_tj
    tiles each (i, j) of the Gram is one thread's register slot exactly
    once, and no slot of a real output falls outside its tile's staged
    rows."""
    mode, x, y, plan = _case(name)
    e = Emu(plan, x.shape[0], mode)
    L = e.L
    seen = np.zeros((e.nx, e.ny), np.int64)
    for t_i in range(L["n_ti"]):
        for t_j in range(L["n_tj"]):
            i0, j0 = 8 * L["ra"] * t_i, 8 * L["rb"] * t_j
            nxr = min(8 * L["ra"], e.nx - i0)
            nyr = min(8 * L["rb"], e.ny - j0)
            for ti in range(8):
                for tj in range(8):
                    for a in range(L["ra"]):
                        for b in range(L["rb"]):
                            i = slot_row(L["ra"], ti, a)
                            j = slot_row(L["rb"], tj, b)
                            if i0 + i < e.nx and j0 + j < e.ny:
                                assert i < nxr and j < nyr
                                seen[i0 + i, j0 + j] += 1
    assert (seen == 1).all()
    assert L["threads"] == 64 * L["ncb"] <= 256
    assert L["px"] % 2 == 0 and L["py"] % 2 == 0     # float2 reads
    assert 8 * L["ra"] * L["n_ti"] >= e.nx and 8 * L["rb"] * L["n_tj"] >= e.ny


@pytest.mark.parametrize("name", list(CASES))
def test_chains_read_extract_patches_in_order(name):
    """The loader copies each staged (position, row) once a stage; a
    column's chain, stage by stage, reads the staged window at exactly the
    entries `extract_patches_3d` gives its patch (K11) or frame (K18), q
    ascending.  Emulated on an index video for the blocks of the first and
    last crop, every tile."""
    mode, x, _, plan = _case(name)
    e = Emu(plan, x.shape[0], mode)
    L, (pt, ph, pw), (st, sh, sw) = e.L, plan.psz, plan.strides
    C, T, H, W = x.shape
    idx = np.arange(C * T * H * W, dtype=np.int64).reshape(C, T, H, W)
    ft, fh, fw = plan.fit
    crops = PN._crops(torch.from_numpy(idx[:, :ft, :fh, :fw]), plan)
    epsz = (1, ph, pw) if e.band else plan.psz
    estr = (1, sh, sw) if e.band else plan.strides
    n_crops = len(crops)
    for crop, b_row, chunk, cnt, _ in e.blocks():
        if crop not in (0, n_crops - 1):
            continue
        ref = PN.extract_patches_3d(crops[crop], epsz, estr).numpy()
        h0 = plan.hs[crop // len(plan.ws)] + b_row * sh
        w0 = plan.ws[crop % len(plan.ws)] + chunk * L["ncb"] * sw
        for t_i in range(L["n_ti"]):
            i0 = 8 * L["ra"] * t_i
            nxr = min(8 * L["ra"], e.nx - i0)
            chains = [[] for _ in range(cnt * nxr)]
            for s in range(e.n_st):
                c, dt, dy0, nbr = e.stage(s)
                ring = np.full(L["stage"], -1, np.int64)
                for off, side, r, l, u in e.issue(s, cnt, nxr, 0):
                    assert ring[off] == -1 and side == 0
                    ring[off] = idx[c, (i0 + r) * e.rst + dt, h0 + dy0 + l,
                                    w0 + u]
                for g in range(cnt):
                    for r in range(nxr):
                        chains[g * nxr + r] += [
                            ring[e.entry(0, g, r, l, dx)]
                            for l in range(nbr) for dx in range(pw)]
            for g in range(cnt):
                col = chunk * L["ncb"] + g
                for r in range(nxr):
                    want = ref[i0 + r, b_row, col]
                    assert np.array_equal(chains[g * nxr + r], want)
            assert len(chains[0]) == e.d


def _fma(a, b, acc):
    """fmaf for f32 operands whose product and sum f64 holds exactly (the
    data below): one rounding to f32."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(acc))


def _chain(u, v, d_pad=None):
    """One fmaf chain from +0 over u . v, q ascending; with d_pad, the first
    design's: zero-padded to chunks of 32 (fmaf(0, 0, acc) steps)."""
    acc = np.float32(0.0)
    for a, b in zip(u, v):
        acc = _fma(a, b, acc)
    for _ in range((d_pad or len(u)) - len(u)):
        acc = _fma(np.float32(0), np.float32(0), acc)
    return acc


@pytest.mark.parametrize("d", [32, 48, 75, 81, 96, 363])
def test_one_zero_step_keeps_the_first_designs_bits(d):
    """The redesign's chain reads d real entries and ends with one +0 step
    where d % 32 != 0; the first design's ran over chunks of 32, padded
    with fmaf(0, 0, acc).  Both give the same bits, -0 included (a last
    product that underflows to -0 after the rest cancels)."""
    rng = np.random.default_rng(d)
    for case in range(4):
        u = rng.integers(-3, 4, d).astype(np.float32)
        v = rng.integers(-3, 4, d).astype(np.float32)
        if case >= 2:
            v[:] = 0
            u[-1], v[-1] = np.float32(-2.0 ** -100), np.float32(2.0 ** -100)
        redesign = _chain(u, v)
        if d % 32:
            redesign = np.float32(redesign + np.float32(0.0))
        first = _chain(u, v, -(-d // 32) * 32)
        assert redesign.view(np.int32) == first.view(np.int32)


def _emulated_dists(mode, x, y, plan):
    """The kernel's distances per crop and column, (n_crops, cols, ntx,
    nty) f32, from the emulated chains: dot products and norms in q order
    (f64 sums of these small integers are exact), the ssim statistics in
    the lane-strided order and xor tree, each operation rounded in f32 as
    the kernel's; K18's banded sums k ascending (/ pt)."""
    (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
    ntx, nty, nh, nw = plan.grid
    out = []
    for xc, yc in zip(*(PN._crops(t, plan)
                        for t in PN._fitted(torch.from_numpy(x),
                                            torch.from_numpy(y), plan))):
        if mode == "band":
            X = PN._frame_patches(xc, plan).numpy().astype(np.float64)
            Y = PN._frame_patches(yc, plan).numpy().astype(np.float64)
        else:
            X = PN.extract_patches_3d(xc, plan.psz, plan.strides).reshape(
                ntx, nh * nw, -1).transpose(0, 1).numpy().astype(np.float64)
            Y = PN.extract_patches_3d(yc, plan.psz, plan.strides).reshape(
                nty, nh * nw, -1).transpose(0, 1).numpy().astype(np.float64)
        d = np.float32(X.shape[-1])
        dot = np.einsum("cid,cjd->cij", X, Y).astype(np.float32)
        if mode == "ssim":
            def lane_sums(V):
                # lane l's sum of entries q = l (mod 32), q ascending: a
                # sequential f32 accumulation (the zeros padding the last
                # round add nothing to these non-negative sums)
                D = V.shape[-1]
                V = np.concatenate([V, np.zeros(V.shape[:-1] + (
                    -D % 32,), np.float32)], -1)
                V = V.reshape(V.shape[:-1] + (-1, 32))
                return np.add.accumulate(V, axis=-2, dtype=np.float32)[
                    ..., -1, :]

            def tree(v):
                for o in (16, 8, 4, 2, 1):
                    v = v + v[..., np.arange(32) ^ o]
                return v[..., 0]

            def stats(P):
                P = P.astype(np.float32)
                mean = tree(lane_sums(P)) / d
                e = P - mean[..., None]
                return mean, tree(lane_sums(e * e)) / d
            mx, vx = stats(X)
            my, vy = stats(Y)
            mx, vx = mx[..., :, None], vx[..., :, None]
            my, vy = my[..., None, :], vy[..., None, :]
            c1, c2 = np.float32(0.01 ** 2), np.float32(0.03 ** 2)
            mxy = mx * my
            cov = dot / d - mxy
            num = (np.float32(2) * mxy + c1) * (np.float32(2) * cov + c2)
            den = (mx * mx + my * my + c1) * (vx + vy + c2)
            dist = np.float32(1) - num / den
        else:
            xx = (X * X).sum(-1).astype(np.float32)[..., :, None]
            yy = (Y * Y).sum(-1).astype(np.float32)[..., None, :]
            dist = ((xx + yy) - np.float32(2) * dot) / d
        if mode == "band":
            band = dist[:, 0:(ntx - 1) * st + 1:st, 0:(nty - 1) * st + 1:st]
            for k in range(1, pt):
                band = band + dist[:, k:k + (ntx - 1) * st + 1:st,
                                   k:k + (nty - 1) * st + 1:st]
            dist = band / np.float32(pt)
        out.append(dist)
    return np.stack(out)


JAX_CASES = ("eval_p11", "ssim_ref", "mse_ref")


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_gram_gives_the_plain_distances(name):
    """The emulated chains' distances equal the plain versions' bit for
    bit on small integers ("mse" and K18: every sum exact in any order)
    and within 2e-6 of the term scale for ssim (its centred deviations
    are not integers); and, for JAX_CASES, the JAX package's within 1e-5
    of the terms."""
    mode, x, y, plan = _case(name)
    got = _emulated_dists(mode, x, y, plan)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if mode == "band":
        want = PN.nn_band_dist_plain(xt, yt, plan, scale_by_pt=True).numpy()
    else:
        want = PN.nn_dist_plain(xt, yt, plan, None, mode).numpy()
    if mode == "ssim":
        assert np.abs(got - want).max() <= 2e-6 * max(1.0, np.abs(want)
                                                      .max())
    else:
        assert np.array_equal(got, want)
    if name not in JAX_CASES:
        return
    # the JAX package's distances of one crop (one case a mode: each
    # compiles JAX's ops anew)
    (pt, ph, pw), (st, sh, sw) = plan.psz, plan.strides
    ntx, nty, nh, nw = plan.grid
    xc, yc = (PN._crops(t, plan)[0] for t in PN._fitted(xt, yt, plan))
    if mode == "band":
        X = np.asarray(PN._frame_patches(xc, plan))
        Y = np.asarray(PN._frame_patches(yc, plan))
        ref = np.asarray(J.banded_temporal_dist(
            J._pairwise_sqdist(jnp.asarray(X), jnp.asarray(Y)), pt, st,
            ntx, nty)) / pt
    else:
        X, Y = (np.asarray(PN.extract_patches_3d(c, plan.psz, plan.strides)
                           .reshape(n, nh * nw, -1).transpose(0, 1))
                for c, n in ((xc, ntx), (yc, nty)))
        fn = J._pairwise_ssim_dist if mode == "ssim" else J._pairwise_sqdist
        ref = np.asarray(fn(jnp.asarray(X), jnp.asarray(Y)))
    scale = 1.0 if mode == "ssim" else float(np.abs(X).max()) ** 2 * 2
    assert np.abs(got[0] - ref).max() <= 1e-5 * scale


def _takes(v1, i1, v2, i2):
    """csrc/nn_argmin.cu:takes: (v2, i2) replaces (v1, i1)."""
    n1, n2 = math.isnan(v1), math.isnan(v2)
    if n1 or n2:
        return n2 and (not n1 or i2 < i1)
    return v2 < v1 or (not v1 < v2 and i2 < i1)


def _group_best(row, gsz):
    """The kernel's search of a row by gsz lanes: each lane its contiguous
    run (k ascending), then the butterfly o = 1, 2, ..; every lane ends
    with the same (value, index).  Returns lane 0's."""
    n = len(row)
    seg = -(-n // gsz)
    lanes = []
    for gl in range(gsz):
        v, i = math.inf, 2 ** 31 - 1
        for k in range(gl * seg, min(n, (gl + 1) * seg)):
            if _takes(v, i, row[k], k):
                v, i = row[k], k
        lanes.append((v, i))
    o = 1
    while o < gsz:
        lanes = [lanes[ln ^ o] if _takes(*lanes[ln], *lanes[ln ^ o])
                 else lanes[ln] for ln in range(gsz)]
        o *= 2
    assert all(lane[1] == lanes[0][1] for lane in lanes)
    return lanes[0]


def _serial_argmin(row):
    """The first design's row search: the first NaN, else the first
    minimum."""
    best, bv = 0, row[0]
    if not math.isnan(bv):
        for j in range(1, len(row)):
            if math.isnan(row[j]):
                return j
            if row[j] < bv:
                bv, best = row[j], j
    return best


def _serial_min(col):
    """The first design's column minimum (a NaN minimum stays NaN)."""
    m = col[0]
    for v in col[1:]:
        if math.isnan(v) or v < m:
            m = v
    return m


@pytest.mark.parametrize("gsz", [1, 2, 4, 8, 16, 32])
def test_group_searches_equal_the_serial_rule(gsz):
    """On rows drawn from {NaN, -inf, -1, -0, +0, 1, 2, +inf} (exact ties,
    signed zeros, NaNs anywhere, rows shorter than the group), the lane
    groups return the serial argmin's index, and the value of the serial
    column minimum: NaN where it is NaN, else the same bits (-0 and +0
    tie to the first)."""
    rng = np.random.default_rng(gsz)
    vals = np.array([np.nan, -np.inf, -1.0, -0.0, 0.0, 1.0, 2.0, np.inf],
                    np.float32)
    for n in (1, 3, 17, 44, 50, 97):
        for _ in range(40):
            p = rng.dirichlet(np.ones(8))
            row = [float(v) for v in rng.choice(vals, n, p=p)]
            v, i = _group_best(row, gsz)
            assert i == _serial_argmin(row)
            m = _serial_min(row)
            if math.isnan(m):
                assert math.isnan(v)
            else:
                assert np.float32(v).view(np.int32) == \
                    np.float32(m).view(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_smem_is_the_emulated_layout(name):
    """`_argmin_smem` (K11) and `_band_smem` (K18) equal the bytes the
    emulated kernel touches: the ring (two stages, from the loader's
    offsets), each column's Gram (over the ring where a column is one
    tile), K18's band, the norms or means, the ssim variances and the
    column minima (each padded to 16 bytes), and for ssim the offsets of x
    and y; ncb columns."""
    mode, x, _, plan = _case(name)
    C = x.shape[0]
    e = Emu(plan, C, mode)
    L = e.L
    (pt, ph, pw), (st, _, sw) = plan.psz, plan.strides
    ntx, nty, _, nw = plan.grid
    ring = 0
    for s in range(e.n_st):
        cnt = min(L["ncb"], nw)
        nxr, nyr = min(8 * L["ra"], e.nx), min(8 * L["rb"], e.ny)
        ring = max(ring, 1 + max(off for off, *_ in e.issue(s, cnt, nxr,
                                                            nyr)))
    assert ring <= L["stage"]

    def pad(n):
        return -(-n // 4) * 4
    gram = pad((e.nx - 1) * (e.ny | 1) + e.ny)
    rest = pad((ntx * (nty | 1) if e.band else 0) + 2 * (e.nx + e.ny) * (
        mode == "ssim") + (e.nx + e.ny) * (mode != "ssim") + nty)
    one = L["n_ti"] * L["n_tj"] == 1
    front = max(2 * L["stage"], L["ncb"] * gram) if one \
        else 2 * L["stage"] + L["ncb"] * gram
    want = 4 * (front + L["ncb"] * rest) + (8 * e.d if mode == "ssim" else 0)
    if e.band:
        assert PN._band_smem(plan, C * ph * pw) == want
    else:
        assert PN._argmin_smem(plan, e.d, mode) == want
        assert PN._argmin_smem(plan, e.d, mode, bf16=True) == (
            want if mode == "ssim" or PN.mma_layout(plan, C)[2]
            > PN._SMEM_LIMIT else PN.mma_layout(plan, C)[2])
    assert L["stage"] == L["nb"] * L["wb"] * (L["px"] + L["py"])
    assert L["wb"] == pw + (L["ncb"] - 1) * sw
    assert L["nb"] * pw >= min(24, ph * pw)
