"""K13 (the stage-2 hit compaction) as redesigned for the card, emulated on
the host from ``render/compact.py:compact_layout`` (the CUDA kernel of
``csrc/compact.cu`` does not run on the CPU).

The emulation follows compact_bits_kernel block by block: a block of
`pix` pixels and all D planes; phase 1 each plane's hit bits over the
block's pixels (a hit: the sign bit of k_s & k_d clear, as
``k_s >= 0 or k_d >= 0``), phase 2 their transpose into per-pixel words
of 32 planes, each pixel's hit count at the nearer words, phase 3 each
hit's rank (the popcount of its word's bits above it plus that count),
kept while rank < S in slot S - 1 - rank of the slot table, only the kept
hits' geometry read, phase 4 every (slot, pixel) written once from the
table or with the empty values below the pixel's min(hits, S) kept
slots.  The result must equal `compact_sweep_plain` array for array
(K13 only copies values) at D = 1, 32, 33, 128 and 256, S = 1, 15 and D,
with all-miss pixels, all-hit pixels, pixels with more than S hits and a
partial last block.  JAX's one-hot selection is held to the plain
version by ``tests/test_torch_stage2_shipped.py`` (unchanged).
"""
import numpy as np
import pytest
import torch

from videoloop3d_torch.render import compact as CP


def _sweep(D, h, w, p_hit, seed):
    """(D, h, w) per-plane arrays: random hits (a third static only, a
    third dynamic only, a third both); pixel column 0 all hits, row 0 all
    misses, NaN and -0.0 geometry on some planes (copied as they are)."""
    rng = np.random.default_rng(seed)
    hit = rng.random((D, h, w)) < p_hit
    hit[:, :, 0] = True
    hit[:, 0, :] = False
    kind = rng.integers(0, 3, (D, h, w))
    k = rng.integers(0, 5000, (D, h, w)).astype(np.int32)
    k_s = np.where(hit & (kind != 1), k, -1 - rng.integers(0, 3, (D, h, w)))
    k_d = np.where(hit & (kind != 0), k + 3, -1)
    fu, fv, z = (rng.normal(0, 2, (D, h, w)).astype(np.float32)
                 for _ in range(3))
    fu[:, 1 % h, 1 % w] = np.nan
    fv[:, 2 % h, 1 % w] = -0.0
    valid = rng.random((D, h, w)) < 0.8
    return (k_s.astype(np.int32), k_d.astype(np.int32), fu, fv, valid, z)


def emulate_k13(k_s, k_d, fu, fv, valid, zview, S):
    """compact_bits_kernel block by block (see the module docstring).
    Returns (the six (S, h, w) outputs, the writes of each (slot, pixel),
    the (plane, pixel)s whose geometry was read)."""
    D, h, w = k_s.shape
    P = h * w
    lay = CP.compact_layout(D, S)
    pix, words = lay["pix"], lay["words"]
    flat = [a.reshape(D, P) for a in (k_s, k_d, fu, fv, valid, zview)]
    empty = (-1, -1, 0.0, 0.0, False, 0.0)
    outs = [np.empty((S, P), a.dtype) for a in flat]
    writes = np.zeros((S, P), np.int64)
    reads = np.zeros((D, P), bool)
    lanes = np.arange(pix)
    for p0 in range(0, P, pix):
        p = p0 + lanes
        inb = p < P
        pc = np.where(inb, p, 0)
        # 1. a plane's hit bits over the block's pixels (one word a plane)
        hit = inb[None] & ((flat[0][:, pc] & flat[1][:, pc]) >= 0)
        rows = (hit.astype(np.uint64) << lanes.astype(np.uint64)).sum(1)
        # 2. the transpose: pbits[j, lane] holds planes 32 j .. 32 j + 31
        pbits = np.zeros((words, pix), np.uint32)
        for d in range(D):
            bit = (rows[d] >> lanes.astype(np.uint64)) & np.uint64(1)
            pbits[d >> 5] |= (bit << np.uint64(d & 31)).astype(np.uint32)
        cnt = np.bitwise_count(pbits).astype(np.int64)
        above = np.cumsum(cnt[::-1], 0)[::-1] - cnt
        # 3. ranks, the slot table of the kept hits
        table = [np.zeros((S, pix), a.dtype) for a in flat]
        for d in range(D):
            j, b = d >> 5, d & 31
            wd = pbits[j]
            higher = np.zeros(pix, np.int64) if b == 31 else \
                np.bitwise_count(wd >> np.uint32(b + 1)).astype(np.int64)
            rank = higher + above[j]
            keep = (((wd >> np.uint32(b)) & 1) == 1) & (rank < S)
            for a, t in zip(flat, table):
                t[S - 1 - rank[keep], lanes[keep]] = a[d, p[keep]]
            reads[d, p[keep]] = True
        # 4. each (slot, pixel) once
        hits = above[0] + cnt[0]
        first = S - np.minimum(hits, S)
        for s in range(S):
            kept = s >= first
            for o, t, e in zip(outs, table, empty):
                o[s, p[inb]] = np.where(kept, t[s], e)[inb]
            writes[s, p[inb]] += 1
    return [o.reshape(S, h, w) for o in outs], writes, reads


CASES = [(1, 1, 0.5), (32, 1, 0.3), (32, 15, 0.3), (32, 32, 0.3),
         (33, 1, 0.4), (33, 15, 0.2), (33, 33, 0.2), (128, 15, 0.1),
         (128, 128, 0.1), (256, 256, 0.05)]


@pytest.mark.parametrize("D,S,p_hit", CASES,
                         ids=[f"D{d}_S{s}" for d, s, _ in CASES])
def test_compact_bits_emulated(D, S, p_hit):
    """The emulated redesign equals `compact_sweep_plain` array for array;
    each (slot, pixel) is written once; a pixel's geometry is read at
    exactly its min(hits, S) nearest hit planes."""
    h, w = 7, 13                     # 91 pixels: a partial last block
    arrs = _sweep(D, h, w, p_hit, D * 1000 + S)
    got, writes, reads = emulate_k13(*arrs, S)
    ref = CP.compact_sweep_plain(*(torch.from_numpy(a) for a in arrs), S)
    for g, r in zip(got, ref):
        assert g.dtype == r.numpy().dtype and g.shape == (S, h, w)
        assert g.tobytes() == r.numpy().tobytes()
    assert (writes == 1).all()
    hit = (arrs[0] >= 0) | (arrs[1] >= 0)
    nearer = np.cumsum(hit[::-1], 0)[::-1]      # hits at it and nearer
    want = (hit & (nearer <= S)).reshape(D, -1)
    assert (reads == want).all()
    n_hits = hit.sum(0)
    assert (n_hits[1:, 0] == D).all() and (n_hits[0] == 0).all()
    if S < D:
        assert (n_hits > S).any()


def test_compact_bits_shipped_patch_shape():
    """The shipped step's shapes (D = 32, S = 15) on a 45 x 64 patch with
    coherent bands of hits: equal to the plain version."""
    D, S, h, w = 32, 15, 45, 64
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c0 = D / 2 + D / 3 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
    dd = np.arange(D)[:, None, None]
    hit = (np.abs(dd - c0) < 1.5) | (np.abs(dd - c0 / 2) < 1.0) \
        | (np.abs(dd - D + 3 + 2 * np.sin(yy / 5.0)) < 1.0)
    arrs = list(_sweep(D, h, w, 0.0, 7))
    arrs[0] = np.where(hit, np.abs(arrs[0]) % 900, -1).astype(np.int32)
    got, writes, _ = emulate_k13(*arrs, S)
    ref = CP.compact_sweep_plain(*(torch.from_numpy(a) for a in arrs), S)
    for g, r in zip(got, ref):
        assert g.tobytes() == r.numpy().tobytes()
    assert (writes == 1).all()


@pytest.mark.parametrize("D,S", [(1, 1), (32, 15), (33, 33), (128, 128),
                                 (256, 256)])
def test_compact_layout(D, S):
    """K13's layout: 32 pixels and 4 warps a block, a word a 32 planes,
    the shared bytes of the plane words, the pixel words and their counts
    and the slot table, within the card's 227 KB up to the limit."""
    lay = CP.compact_layout(D, S)
    words = -(-D // 32)
    assert lay == dict(pix=32, threads=128, words=words,
                       smem=4 * D + 8 * 32 * words + 21 * 32 * S)
    assert lay["smem"] <= 227 * 1024
    assert CP.K13_MAX_PLANES >= 128


def test_compact_limit_raises():
    """More than K13_MAX_PLANES planes or slots raise, on the CPU too."""
    D = CP.K13_MAX_PLANES + 1
    arrs = [torch.from_numpy(a) for a in _sweep(D, 2, 3, 0.3, 0)]
    with pytest.raises(ValueError, match="limit"):
        CP.compact_sweep(*arrs, 4)
    arrs = [torch.from_numpy(a) for a in _sweep(4, 2, 3, 0.3, 0)]
    with pytest.raises(ValueError, match="limit"):
        CP.compact_sweep(*arrs, CP.K13_MAX_PLANES + 1)
    got = CP.compact_sweep(*arrs, 3)
    ref = CP.compact_sweep_plain(*arrs, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
