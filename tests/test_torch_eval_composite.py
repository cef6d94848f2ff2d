"""K4 (the eval composite) as redesigned for the card, emulated on the host
from ``render/fused.py:composite_layout`` (the CUDA kernel of
``csrc/composite.cu`` does not run on the CPU).

The emulation follows composite_tile_kernel block by block: the layout's
`pix` pixels a block with all frames; stage 1 one (plane, pixel) at a
time in the kernel's batches, hit_d and m_d set in the pixel's bit words,
a static sample decoded once into the table and its live bit set unless
it decodes to exact zeros (masked off with finite rgb: no exponential,
no entry); stage 2 one (pixel, frame) at a time, vectorized over the
block's frames: the bit words from the last down, each word's hit
samples loaded K4_BUF at a time highest plane first (the next batch when
the walk has used the last), the live and hit planes walked from the
highest set bit down, the composite in f32 with one rounding an
operation.  The first design's per-(pixel, frame) loop over every plane
is emulated beside it with the same sigmoid (``1 / (1 + exp(-x))`` in
f32), so the two are held bit for bit (NaN where the first design has
NaN), and both within 1e-6 of `composite_plain` (torch's sigmoid) at
D = 1, 32, 33 and 128, F = 1, 5 and 50, pixel counts that leave a partial
last block, and stacks that are all masked, all hit, or hold non-finite
masked-off samples.  The planes walked are exactly the hit planes and the
static planes that do not decode to zeros; each sample's exponentials
and each hit load are counted.  JAX's `fused_composite` is the reference
of ``tests/test_torch_render_kernels`` (K4's parity test there is
unchanged).
"""
import numpy as np
import pytest
import torch

from videoloop3d_torch.render import fused as FU

F32 = np.float32


def _sigmoid(x):
    """The kernels' sigmoid_f in f32: 1 / (1 + exp(-x)), each operation
    rounded once."""
    with np.errstate(over="ignore", invalid="ignore"):
        return F32(1) / (F32(1) + np.exp(-x))


def _decode(x, m, count):
    """decode(): rgb = sigmoid(x[:3]) * m, alpha = m ? sigmoid(x[3]) : 0;
    x (..., 4) f32, m (...) bool; count[0] += the exponentials taken (3
    a sample, 4 where m)."""
    count[0] += 3 * m.size + int(m.sum())
    with np.errstate(invalid="ignore"):
        rgb = _sigmoid(x[..., :3]) * m.astype(F32)[..., None]
    a = np.where(m, _sigmoid(x[..., 3]), F32(0))
    return np.concatenate([rgb, a[..., None]], -1).astype(F32)


def _decode_skip(x, m, count):
    """decode_skip(): zeros with no exponential where m is 0 and the rgb
    finite; else decode()."""
    skip = ~m & np.isfinite(x[..., :3]).all(-1)
    out = np.zeros(x.shape, F32)
    if (~skip).any():
        out[~skip] = _decode(x[~skip], m[~skip], count)
    return out


def _over(state, d):
    """One plane of the composite on (T, o0, o1, o2, as) with the decoded
    (..., 4) sample d, in the kernels' order."""
    T, o, asum = state
    bw = d[..., 3] * T
    with np.errstate(invalid="ignore"):
        o = o + d[..., :3] * bw[..., None]
    asum = asum + bw
    T = T * (F32(1) - d[..., 3])
    return T, o, asum


def emulate_first(vals_s, m_s, vals_d, hit_d, m_d):
    """composite_first_kernel: every (pixel, frame) walks s = D-1 .. 0,
    reading the hit byte, then the dynamic or the static sample, decoded
    per frame.  Returns (out (P, F, 3), alpha_sum (P, F), exponentials)."""
    D, P, F, _ = vals_d.shape
    count = [0]
    state = (np.ones((P, F), F32), np.zeros((P, F, 3), F32),
             np.zeros((P, F), F32))
    for s in range(D - 1, -1, -1):
        hit = hit_d[s][:, None]
        x = np.where(hit[..., None], vals_d[s],
                     np.broadcast_to(vals_s[s][:, None], vals_d[s].shape))
        m = np.broadcast_to(np.where(hit, m_d[s][:, None], m_s[s][:, None]),
                            (P, F))
        state = _over(state, _decode(x, m, count))
    return state[1], state[2], count[0]


def emulate_k4(vals_s, m_s, vals_d, hit_d, m_d):
    """composite_tile_kernel block by block (see the module docstring).
    Returns (out (P, F, 3), alpha_sum (P, F), exponentials, {pixel: the
    planes its frames walked, in order}, table entries written, hit
    samples loaded, (plane, pixel)s read in stage 1)."""
    D, P, F, _ = vals_d.shape
    lay = FU.composite_layout(D, F)
    pix, words, nt = lay["pix"], lay["words"], lay["threads"]
    out = np.full((P, F, 3), np.nan, F32)
    asum = np.full((P, F), np.nan, F32)
    count, walks, written, loads, reads = [0], {}, 0, 0, 0
    for p0 in range(0, P, pix):
        npx = min(pix, P - p0)
        # stage 1: thread tid takes i = i0 + b * nt, b < K4_BATCH
        table = np.full((D * pix, 4), np.nan, F32)
        hitw, mdw, livew = (np.zeros((pix, words), np.uint64)
                            for _ in range(3))
        for tid in range(nt):
            for i0 in range(tid, D * pix, FU.K4_BATCH * nt):
                for b in range(FU.K4_BATCH):
                    i = i0 + b * nt
                    s, pl = divmod(i, pix)
                    if i >= D * pix or pl >= npx:
                        continue
                    reads += 1
                    p, bit = p0 + pl, np.uint64(1 << (s & 31))
                    x, ms = vals_s[s, p], bool(m_s[s, p])
                    if hit_d[s, p]:
                        hitw[pl, s >> 5] |= bit
                        if m_d[s, p]:
                            mdw[pl, s >> 5] |= bit
                    elif ms or not np.isfinite(x[:3]).all():
                        table[i] = _decode(x[None], np.array([ms]), count)[0]
                        livew[pl, s >> 5] |= bit
                        written += 1
        # stage 2: (pixel, frame), the block's frames at once per pixel
        for pl in range(npx):
            p = p0 + pl
            state = (np.ones(F, F32), np.zeros((F, 3), F32),
                     np.zeros(F, F32))
            seen = []
            for w in range(words - 1, -1, -1):
                hw, mw = int(hitw[pl, w]), int(mdw[pl, w])
                base, pend, buf = 32 * w, hw, []

                def refill():
                    nonlocal pend, loads
                    for _ in range(FU.K4_BUF):
                        if pend:
                            b = pend.bit_length() - 1
                            pend ^= 1 << b
                            buf.append(vals_d[base + b, p])
                            loads += F          # one a frame's thread
                if hw:
                    refill()
                live = hw | int(livew[pl, w])
                while live:
                    b = live.bit_length() - 1
                    live ^= 1 << b
                    s = base + b
                    seen.append(s)
                    if hw >> b & 1:
                        if not buf:
                            refill()
                        m = np.full(F, bool(mw >> b & 1))
                        d = _decode_skip(buf.pop(0), m, count)
                    else:
                        d = np.broadcast_to(table[s * pix + pl], (F, 4))
                    state = _over(state, d)
            walks[p] = seen
            out[p], asum[p] = state[1], state[2]
    return out, asum, count[0], walks, written, loads, reads


def _stack(D, P, F, seed, case):
    rng = np.random.default_rng(seed)
    vals_s = rng.normal(0, 2, (D, P, 4)).astype(F32)
    vals_d = rng.normal(0, 2, (D, P, F, 4)).astype(F32)
    m_s = rng.random((D, P)) < 0.6
    hit_d = rng.random((D, P)) < 0.3
    m_d = rng.random((D, P)) < 0.5
    if case == "all_masked":
        m_s[:] = m_d[:] = False
    elif case == "all_hit":
        hit_d[:] = True
        vals_s[:] = np.nan          # never read where every plane hits
    elif case == "nonfinite":
        bad = np.array([np.nan, np.inf, -np.inf], F32)
        pick = rng.random((D, P)) < 0.3
        vals_s[pick & ~m_s] = bad[rng.integers(0, 3, (D, P, 4))][pick & ~m_s]
        dpick = pick & hit_d & ~m_d
        vals_d[dpick] = bad[rng.integers(0, 3, (D, P, F, 4))][dpick]
        # finite masked-off samples of large magnitude stay zeros
        big = ~pick & ~m_s
        vals_s[big] = F32(1e30)
    return vals_s, m_s, vals_d, hit_d, m_d


def _plain(stack, h, w):
    vals_s, m_s, vals_d, hit_d, m_d = stack
    D, P, F, _ = vals_d.shape
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        vals_s.reshape(D, h, w, 4), m_s.reshape(D, h, w),
        vals_d.reshape(D, h, w, F, 4), hit_d.reshape(D, h, w),
        m_d.reshape(D, h, w))]
    out, asum = FU.composite(*t)
    return out.numpy().reshape(P, F, 3), asum.numpy().reshape(P, F)


CASES = {  # D, h, w, F
    "d1": (1, 5, 9, 5), "d32": (32, 6, 7, 5), "d33": (33, 7, 11, 1),
    "d128": (128, 3, 7, 5), "f50": (32, 5, 7, 50), "f1": (32, 9, 5, 1)}


@pytest.mark.parametrize("case", ["random", "all_masked", "all_hit",
                                  "nonfinite"])
@pytest.mark.parametrize("shape", list(CASES))
def test_k4_two_stage_order_emulated(shape, case):
    """Bit for bit the first design's per-(pixel, frame) loop (NaN where
    it has NaN), within 1e-6 of `composite_plain`; every (pixel, frame)
    walks, near to far, exactly its hit planes and the static planes that
    do not decode to zeros; each (plane, pixel) read once in stage 1; each
    static sample decoded once a (plane, pixel), each hit sample loaded
    and decoded once a (plane, pixel, frame), masked-off samples with
    finite rgb never."""
    D, h, w, F = CASES[shape]
    P = h * w
    stack = _stack(D, P, F, seed=D + F, case=case)
    vals_s, m_s, vals_d, hit_d, m_d = stack
    out, asum, n_exp, walks, written, loads, reads = emulate_k4(*stack)
    fout, fasum, n_exp_first = emulate_first(*stack)
    zero_s = ~hit_d & ~m_s & np.isfinite(vals_s[..., :3]).all(-1)
    for p in range(P):
        want = [s for s in range(D - 1, -1, -1) if not zero_s[s, p]]
        assert walks[p] == want
    assert reads == D * P
    assert written == int((~hit_d & ~zero_s).sum())
    assert loads == int(hit_d.sum()) * F
    for a, b in ((out, fout), (asum, fasum)):
        same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a)
                                                         & np.isnan(b))
        assert same.all()
    pout, pasum = _plain(stack, h, w)
    np.testing.assert_allclose(out, pout, rtol=0, atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(asum, pasum, rtol=0, atol=1e-6,
                               equal_nan=True)
    live_d = hit_d[..., None] & ~(~m_d[..., None] & np.isfinite(
        vals_d[..., :3]).all(-1))
    # 3 exponentials a masked sample decoded in full (alpha is 0), 4 else
    live_s = ~hit_d & ~zero_s
    want = (4 * int((live_s & m_s).sum()) + 3 * int((live_s & ~m_s).sum())
            + 4 * int((live_d & m_d[..., None]).sum())
            + 3 * int((live_d & ~m_d[..., None]).sum()))
    assert n_exp == want
    assert n_exp_first == 4 * D * P * F - F * int(
        (~np.where(hit_d, m_d, m_s)).sum())
    if case == "all_masked":
        assert not out.any() and not asum.any()
    if case == "nonfinite":
        assert np.isnan(out).any() and np.isfinite(asum).all()


@pytest.mark.parametrize("D,F,want", [
    (1, 10, (32, 1, 320, 896)),
    (32, 10, (32, 1, 320, 16768)),
    (32, 1, (32, 1, 128, 16768)),
    (32, 50, (32, 1, 512, 16768)),
    (33, 10, (32, 2, 320, 17664)),
    (128, 10, (16, 4, 160, 33536)),
    (2048, 1, (1, 64, 128, 33536)),
])
def test_k4_layout(D, F, want):
    """Pixels a block, bit words a pixel, threads and shared bytes at the
    eval chunk (D = 32, F = 10), a spiral frame (F = 1), the training
    frame count (F = 50) and the plane counts around the word size up to
    the limit: within the 48 KB a block takes without opting in."""
    lay = FU.composite_layout(D, F)
    assert (lay["pix"], lay["words"], lay["threads"], lay["smem"]) == want
    assert lay["smem"] <= 48 * 1024


def test_k4_refuses_past_its_plane_limit():
    """More than K4_MAX_PLANES planes raise (on the CPU too): no pixel of
    their table would fit a block."""
    D = FU.K4_MAX_PLANES + 1
    assert FU.composite_layout(D, 1)["pix"] == 0
    z = torch.zeros((D, 1, 1, 4))
    b = torch.zeros((D, 1, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="limit"):
        FU.composite(z, b, z[:, :, :, None], b, b)
