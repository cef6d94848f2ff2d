"""The SWD looping loss of the PyTorch port against the JAX package, on the
CPU: `swd_3d_loss` values and input gradients with JAX's draws fed in
(x longer, y longer, equal lengths, strides above 1, one projection,
exact ties in a static region, x = y and its +1 branch of |.|), the mask
branch at factors 1 and 3 (and the index maps and arithmetic of its
kernels K27/K28, emulated on the host, K28's redesign in its order),
`mask_patch_columns` and `_match_lengths`;
and the plain versions of K24-K26 against the library calls they stand
for (conv3d and its input gradient) and against autograd; K24/K26's
redesigned tiling, gather and fold emulated on the host.  Inputs are
made with numpy and handed to both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from videoloop3d_tpu.losses import swd as J
from videoloop3d_torch.first_designs import sort_keys
from videoloop3d_torch.losses import swd as T
from videoloop3d_torch.losses.patch_nn import extract_patches_3d


def _clips(seed, Tx, Ty, C=3, H=19, W=23):
    rng = np.random.default_rng(seed)
    return (rng.random((C, Tx, H, W)).astype(np.float32),
            rng.random((C, Ty, H, W)).astype(np.float32))


def _jax_draws(key, cfg, C, n_x, n_y):
    """JAX's draws of `swd_3d_loss` from its key (the projections and the
    permutation of `_match_lengths`, both from the same key) as the port's
    draws dict."""
    p, pt, P = cfg["patch_size"], cfg["patcht_size"], cfg["num_proj"]
    n_short = T.swd_n_short(n_x, n_y)
    rand = np.array(jax.random.normal(key, (P, C, pt, p, p)))
    perm = np.array(jax.random.permutation(key, n_short)) if n_short \
        else None
    return {"rand": torch.from_numpy(rand),
            "perm": None if perm is None else torch.from_numpy(perm)}


def _cols(T_, cfg):
    return (T_ - cfg["patcht_size"]) // cfg["stridet"] + 1


def _both(x, y, cfg, seed=3, mask=None, factor=1):
    """(port loss, port gradient, JAX loss, JAX gradient) on one key."""
    key = jax.random.PRNGKey(seed)
    kw = dict(cfg)
    if mask is not None:
        kw.update(mask=mask, mask_patches_factor=factor)
    jl, jg = jax.value_and_grad(
        lambda a: J.swd_3d_loss(a, jnp.asarray(y), key, **kw))(jnp.asarray(x))
    if mask is None:
        n_x, n_y = _cols(x.shape[1], cfg), _cols(y.shape[1], cfg)
    else:
        L = ((x.shape[2] - cfg["patch_size"]) // cfg["stride"] + 1) \
            * ((x.shape[3] - cfg["patch_size"]) // cfg["stride"] + 1)
        sel = T.mask_patch_columns(mask, cfg["patch_size"],
                                   cfg["patcht_size"], cfg["stride"],
                                   cfg["stridet"], n_frames=y.shape[1])
        n_x = _cols(x.shape[1], cfg) * L
        n_y = int((~sel).sum() + sel.sum() * factor)
    draws = _jax_draws(key, cfg, x.shape[0], n_x, n_y)
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = T.swd_3d_loss(tx, torch.from_numpy(y), draws=draws, **kw)
    tl.backward()
    return float(tl.detach()), tx.grad.numpy(), float(jl), np.asarray(jg)


BASE = dict(patch_size=3, patcht_size=3, stride=1, stridet=1, num_proj=16)
CASES = {
    "x_longer": (9, 7, BASE),
    "y_longer": (7, 12, BASE),
    "equal": (8, 8, BASE),
    "strides": (11, 8, dict(patch_size=5, patcht_size=2, stride=2,
                            stridet=2, num_proj=24)),
    "one_projection": (9, 7, dict(BASE, num_proj=1)),
    "ref_view_shape": (8, 6, dict(patch_size=7, patcht_size=3, stride=4,
                                  stridet=1, num_proj=32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_swd_matches_jax(case):
    """The loss within 1e-5 relative of JAX's and its gradient in x within
    1e-5 * max|g|, JAX's projections and permutation fed to the port."""
    Tx, Ty, cfg = CASES[case]
    x, y = _clips(1, Tx, Ty)
    tl, tg, jl, jg = _both(x, y, cfg)
    assert np.isfinite(tl) and tl > 0
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()


def test_swd_exact_ties_route_in_index_order():
    """A static x (every frame equal): its projections are equal down a
    column, and the sort's gradient reaches its entries in index order, as
    jnp.sort's does; the port's rank of each tied entry is its index."""
    x, y = _clips(2, 9, 7)
    x[:] = x[:, :1]
    tl, tg, jl, jg = _both(x, y, BASE)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()
    # every column of x's projections is one value repeated: all ties
    v = torch.from_numpy(x * 2 - 1)
    rand = T.normalized_projections(torch.randn(16, 3 * 27,
                                                generator=torch.Generator()
                                                .manual_seed(0)))
    ox = T.swd_project_plain(v, rand, (3, 3, 3), (1, 1, 1))
    assert torch.equal(ox, ox[..., :1].expand_as(ox))


def test_swd_x_equals_y_takes_the_plus_one_branch():
    """x = y: every sorted pair is equal, the loss is 0 and the gradient
    of |.| at 0 is +1 (jnp.abs's; torch.abs would give 0)."""
    x, _ = _clips(3, 8, 8)
    tl, tg, jl, jg = _both(x, x.copy(), BASE)
    assert tl == jl == 0.0
    assert np.abs(jg).max() > 0
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()


@pytest.mark.parametrize("factor", [1, 3])
def test_swd_mask_branch_matches_jax(factor):
    """The mask branch (CPU only): y's patches touching the mask
    duplicated `factor` times before the sort over all patches of a
    projection; loss and gradient against JAX as above."""
    x, y = _clips(4, 7, 6)
    mask = np.zeros(x.shape[2:], np.float32)
    mask[4:9, 6:15] = 1.0
    tl, tg, jl, jg = _both(x, y, dict(BASE, num_proj=8), mask=mask,
                           factor=factor)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()


def _f2key(v):
    """csrc/swd_mask.cu:f2key on the host: the order-preserving u32 key of
    an f32 (-0 as +0)."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    neg = (u & 0x80000000) != 0
    return np.where(neg, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _emulate_mask_kernels(ox, oy, plan, L, cfx):
    """K27 and K28 on the host from `swd_mask_plan`'s index maps: each
    row's keys stably sorted (its matched index as x's payload), the sign
    at the payload, and x's gradient in K24's (P, L, cf) layout summed over
    the copies in the kernel's order (tiled copies, then the deficit's by
    the inverse permutation, ascending)."""
    P = ox.shape[0]
    n, n_x = plan["n"], L * cfx
    rx = ox.reshape(P, -1)[:, plan["gather_x"].long().numpy()]
    ry = oy.reshape(P, -1)[:, plan["gather_y"].long().numpy()]
    ix = np.argsort(_f2key(rx), axis=1, kind="stable")
    sx = np.take_along_axis(rx, ix, 1)
    sy = np.take_along_axis(ry, np.argsort(_f2key(ry), axis=1,
                                           kind="stable"), 1)
    d = (sx - sy).astype(np.float32)
    count = np.float32(P * n)
    loss = np.float32(np.abs(d).astype(np.float64).sum()) / count
    inv = np.float32(1.0) / count
    gm = np.empty((P, n), np.float32)
    np.put_along_axis(gm, ix, np.where(d >= 0, inv, -inv), 1)
    tiled, deficit = plan["tiled"], plan["deficit"]
    invp = None if plan["invp"] is None else plan["invp"].numpy()
    gx = np.empty((P, L, cfx), np.float32)
    for e in range(n_x):
        if n_x == n:
            acc = gm[:, e]
        else:
            acc = np.zeros(P, np.float32)
            for k in range(tiled // n_x):
                acc = acc + gm[:, e + k * n_x]
            js = sorted(int(invp[e + q * n_x]) for q in range(tiled // n_x)
                        if invp is not None and invp[e + q * n_x] < deficit)
            for j in js:
                acc = acc + gm[:, tiled + j]
        gx[:, e % L, e // L] = acc
    return loss, gx


MASK_PLANS = {"x_longer": (7, 6, 1), "y_longer": (7, 6, 3),
              "equal_frames": (6, 6, 2), "static": (7, 6, 3)}


@pytest.mark.parametrize("case", list(MASK_PLANS))
def test_swd_mask_kernel_plan_matches_the_plain_version(case):
    """The index maps K27/K28 take (`swd_mask_plan`: the matching, the
    mask order and the transpose from K24's layout composed) and the
    kernels' arithmetic, emulated on the host, give the plain mask
    branch's loss (within 1e-6) and its gradient bit for bit: x longer
    (factor 1), y longer with a deficit (factor 3), and a static x whose
    tied entries route in index order."""
    Tx, Ty, factor = MASK_PLANS[case]
    x, y = _clips(5, Tx, Ty)
    if case == "static":
        x[:] = x[:, :1]
    mask = np.zeros(x.shape[2:], np.float32)
    mask[3:10, 5:14] = 1.0
    cfg = dict(BASE, num_proj=6)
    psz, strides = (3, 3, 3), (1, 1, 1)
    sel = T.mask_patch_columns(mask, 3, 3, 1, 1, n_frames=Ty)
    order = torch.from_numpy(np.concatenate(
        [np.nonzero(~sel)[0]] + [np.nonzero(sel)[0]] * factor))
    rand = T.normalized_projections(torch.from_numpy(
        np.random.default_rng(6).normal(size=(6, 3 * 27)).astype(
            np.float32)))
    ox = T.swd_project_plain(torch.from_numpy(x * 2 - 1), rand, psz, strides)
    oy = T.swd_project_plain(torch.from_numpy(y * 2 - 1), rand, psz, strides)
    P, L, cfx = ox.shape
    n_x, n_y = L * cfx, int(order.numel())
    n_short = T.swd_n_short(n_x, n_y)
    perm = torch.from_numpy(np.random.default_rng(7).permutation(n_short)) \
        if n_short else None
    plan = T.swd_mask_plan(n_x, n_y, order, perm, L, cfx, oy.shape[2],
                           torch.device("cpu"))
    assert plan["n"] == max(n_x, n_y)
    assert (plan["deficit"] > 0) == (n_x < n_y and n_y % n_x > 0)
    assert (n_x > n_y) == (case == "x_longer")
    loss, gx = T.swd_mask_sort_l1_plain(ox, oy, order, perm)
    el, eg = _emulate_mask_kernels(ox.numpy(), oy.numpy(), plan, L, cfx)
    assert abs(float(el) - float(loss)) <= 1e-6
    np.testing.assert_array_equal(eg, gx.numpy())
    tl, tg, jl, jg = _both(x, y, cfg, mask=mask, factor=factor)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_swd_mask_keys_sort_as_floats():
    """The radix keys order floats as a stable comparison sort does:
    negatives, -0 tied with +0, positives, infinities."""
    v = np.float32([3.0, -0.0, -1.5, 0.0, np.inf, -np.inf, 1e-38, -1e-38,
                    2.5, -0.0, 7.0, -7.0])
    by_key = np.argsort(_f2key(v), kind="stable")
    by_value = torch.sort(torch.from_numpy(v), stable=True)[1].numpy()
    np.testing.assert_array_equal(by_key, by_value)


# K27's redesign (csrc/swd_mask.cu rank_pass_kernel): kRankWarps warps rank
# kRankItems rounds of 32 keys each, a tile of 3,840 keys, kBits a digit
_RANK_WARPS, _RANK_ITEMS = 8, 15
_RADIX_BITS = 8
_RANK_TILE = _RANK_WARPS * _RANK_ITEMS * 32


def _rank_tile(digit, D):
    """rank_pass_kernel's ranking of one tile's digits (in index order):
    warp w takes the tile's w-th run of _RANK_ITEMS x 32 keys in rounds of
    32; a key's place is its round's lower lanes of the same digit
    (__match_any_sync), its warp's count of the digit from earlier rounds,
    the digit's keys in earlier warps (the exclusive pass over the warps)
    and the tile's keys of smaller digits (the scan over the digits).
    Returns (each key's index in the tile staged in digit order, the
    tile's count of each digit, each digit's start in the staged tile)."""
    cnt = len(digit)
    wcnt = np.zeros((_RANK_WARPS, D), np.int64)
    pos = np.zeros(cnt, np.int64)
    warp = np.zeros(cnt, np.int64)
    lanes = np.arange(32)
    for w in range(_RANK_WARPS):
        for r in range(_RANK_ITEMS):
            i = w * _RANK_ITEMS * 32 + r * 32 + lanes
            i = i[i < cnt]
            if not len(i):
                break
            d = digit[i]
            peers_before = np.tril(d[:, None] == d[None, :], -1).sum(1)
            pos[i] = wcnt[w, d] + peers_before
            warp[i] = w
            np.add.at(wcnt[w], d, 1)
    warps_before = np.cumsum(wcnt, 0) - wcnt
    tot = wcnt.sum(0)
    dstart = np.cumsum(tot) - tot
    return pos + warps_before[warp, digit] + dstart[digit], tot, dstart


def _look_back(tots, rng):
    """The decoupled look-back over one row's tiles (tots: each tile's
    digit counts) in a random interleaving of the tiles' steps: a tile
    publishes its counts (flag A; tile 0 its inclusive prefix, flag P),
    then, once no status it would read is empty (the kernel spins there),
    adds its predecessors' counts back to the first P and publishes its
    own P.  Returns each tile's exclusive prefix of every digit."""
    ntiles = len(tots)
    flag = np.zeros(ntiles, np.int64)           # 0 empty, 1 A, 2 P
    value = np.zeros_like(tots)
    excl = np.zeros_like(tots)

    def can_walk(t):
        for q in range(t - 1, -1, -1):
            if flag[q] == 0:
                return False
            if flag[q] == 2:
                return True
        return True

    while (flag < 2).any():
        steps = [t for t in range(ntiles)
                 if flag[t] == 0 or (flag[t] == 1 and can_walk(t))]
        t = steps[rng.integers(len(steps))]
        if flag[t] == 0:
            flag[t], value[t] = (2 if t == 0 else 1), tots[t]
            continue
        acc = np.zeros_like(tots[t])
        for q in range(t - 1, -1, -1):
            acc += value[q]
            if flag[q] == 2:
                break
        excl[t] = acc
        flag[t], value[t] = 2, acc + tots[t]
    return excl


def _radix_pass(keys, pay, shift, starts, rng):
    """One pass of rank_pass_kernel over one row: each tile ranked and
    staged in digit order, its digits' offsets from the look-back plus the
    upsweep's row-global digit starts (which must equal the scan of every
    tile's histogram, digit-major), and each staged key written at its
    digit's offset plus its staged index."""
    D = 1 << _RADIX_BITS
    n = len(keys)
    digit = (keys >> np.uint32(shift)) & np.uint32(D - 1)
    ntiles = -(-n // _RANK_TILE)
    staged, tots, dstarts = [], [], []
    for t in range(ntiles):
        sl = slice(t * _RANK_TILE, min(n, (t + 1) * _RANK_TILE))
        pos, tot, dstart = _rank_tile(digit[sl].astype(np.int64), D)
        assert np.array_equal(np.sort(pos), np.arange(len(pos)))
        sk, sp = np.empty_like(keys[sl]), np.empty_like(pay[sl])
        sk[pos], sp[pos] = keys[sl], pay[sl]
        staged.append((sk, sp))
        tots.append(tot)
        dstarts.append(dstart)
    tots = np.stack(tots)
    before = starts[None, :] + _look_back(tots, rng)
    np.testing.assert_array_equal(before, (np.cumsum(tots.T.reshape(-1))
                                           - tots.T.reshape(-1))
                                  .reshape(D, ntiles).T)
    out_k, out_p = np.empty_like(keys), np.empty_like(pay)
    for t, (sk, sp) in enumerate(staged):
        gbase = before[t] - dstarts[t]
        d = ((sk >> np.uint32(shift)) & np.uint32(D - 1)).astype(np.int64)
        at = gbase[d] + np.arange(len(sk))
        out_k[at], out_p[at] = sk, sp
    return out_k, out_p


def _emulate_mask_sort(vals, seed):
    """K27's redesign on one row of f32 values: the load's keys and index
    payload, the upsweep's digit counts of every pass scanned into the
    row-global digit starts, then 32 / _RADIX_BITS passes whose look-backs
    interleave as `seed` draws."""
    rng = np.random.default_rng(seed)
    keys = _f2key(vals)
    pay = np.arange(len(keys), dtype=np.int64)
    D = 1 << _RADIX_BITS
    for p in range(32 // _RADIX_BITS):
        shift = p * _RADIX_BITS
        count = np.bincount((keys >> np.uint32(shift)) & np.uint32(D - 1),
                            minlength=D)
        starts = np.cumsum(count) - count
        keys, pay = _radix_pass(keys, pay, shift, starts, rng)
    return keys, pay


def _mask_sort_rows(case):
    rng = np.random.default_rng(len(case))
    if case == "random":
        return rng.standard_normal(3 * _RANK_TILE + 5).astype(np.float32)
    if case == "heavy_ties":
        return rng.choice(np.float32([-2.5, 0.5, 7.0]), 3 * _RANK_TILE + 5)
    if case == "all_equal":
        return np.full(2 * _RANK_TILE + 1, 1.5, np.float32)
    if case == "specials":
        return rng.choice(np.float32([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                      -1e-40, 1e-45, -3.0, 3.0]), 4001)
    if case == "one_tile":
        return rng.integers(-4, 4, _RANK_TILE).astype(np.float32)
    return np.float32([0.25])                    # one key


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", ["random", "heavy_ties", "all_equal",
                                  "specials", "one_tile", "one_key"])
def test_mask_sort_redesign_emulated(case, seed):
    """K27's redesign emulated on the host (tile ranking, staging in digit
    order, tile offsets by look-back, its steps interleaved at random as
    `seed` draws) over several tiles with heavy ties: its payload equals
    np.argsort(kind="stable") of the keys and of the values, and its keys
    the keys in that order."""
    vals = _mask_sort_rows(case)
    keys, pay = _emulate_mask_sort(vals, seed)
    want = np.argsort(_f2key(vals), kind="stable")
    np.testing.assert_array_equal(pay, want)
    np.testing.assert_array_equal(pay, np.argsort(vals, kind="stable"))
    np.testing.assert_array_equal(keys, _f2key(vals)[want])


@pytest.mark.parametrize("shape", [(19, 23), (6, 19, 23)], ids=["hw", "thw"])
def test_mask_patch_columns_matches_jax(shape):
    rng = np.random.default_rng(5)
    mask = (rng.random(shape) > 0.97).astype(np.float32)
    for args in ((3, 3, 1, 1), (5, 2, 2, 2)):
        np.testing.assert_array_equal(
            T.mask_patch_columns(mask, *args, n_frames=6),
            J.mask_patch_columns(mask, *args, n_frames=6))


@pytest.mark.parametrize("n", [(9, 4), (4, 9), (6, 6), (7, 3)])
def test_match_lengths_matches_jax(n):
    """Tiling and the permutation's padding, for either side the shorter,
    equal to JAX's `_match_lengths` on the same key."""
    rng = np.random.default_rng(6)
    a = rng.random((5, n[0])).astype(np.float32)
    b = rng.random((5, n[1])).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ja, jb = J._match_lengths(jnp.asarray(a), jnp.asarray(b), key)
    n_short = T.swd_n_short(*n)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, n_short))) \
        if n_short else None
    ta, tb = T._match_lengths(torch.from_numpy(a), torch.from_numpy(b), perm)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


GEOMS = {"p3_s1": ((3, 3, 3), (1, 1, 1)), "p5_s2_st2": ((2, 5, 5), (2, 2, 2)),
         "p7_s4": ((3, 7, 7), (1, 4, 4))}


@pytest.mark.parametrize("geom", list(GEOMS))
def test_projection_plain_versions_match_the_library(geom):
    """K24's plain version equals F.conv3d (VALID, strides (st, s, s)) in
    the column layout (P, ch * cw, cf), and K26's equals twice
    torch.nn.grad.conv3d_input of the same gradient, within 1e-5
    relative (sums in another order)."""
    psz, strides = GEOMS[geom]
    x, _ = _clips(8, 10, 4)
    v = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(1)
    rand = torch.randn((13, 3 * int(np.prod(psz))), generator=gen)
    out = T.swd_project_plain(v, rand, psz, strides)
    lib = F.conv3d(v[None], rand.reshape((13, 3) + psz), stride=strides)[0]
    P, cf, ch, cw = lib.shape
    lib = lib.reshape(P, cf, ch * cw).transpose(1, 2)
    assert out.shape == (P, ch * cw, cf)
    assert (out - lib).abs().max() <= 1e-5 * lib.abs().max()
    gx = torch.randn(out.shape, generator=gen)
    got = T.swd_project_grad_plain(gx, rand, tuple(v.shape), psz, strides)
    want = 2 * torch.nn.grad.conv3d_input(
        (1,) + tuple(v.shape), rand.reshape((13, 3) + psz),
        gx.transpose(1, 2).reshape(1, P, cf, ch, cw), stride=strides)[0]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("n", [(7, 5), (5, 7), (6, 6)])
def test_sort_l1_plain_gradient_matches_autograd(n):
    """K25's plain version's gradient equals autograd through
    torch.sort and the index maps where no |.| argument is 0 (there
    torch's |.| has the same derivative as jnp.abs)."""
    gen = torch.Generator().manual_seed(2)
    ox = torch.randn((4, 3, n[0]), generator=gen)
    oy = torch.randn((4, 3, n[1]), generator=gen)
    perm = torch.randperm(max(n) // min(n) * min(n), generator=gen)
    map_x, map_y = T._match_maps(n[0], n[1], perm, ox.device)
    loss, gx = T.swd_sort_l1_plain(ox, oy, map_x, map_y)
    a = ox.clone().requires_grad_(True)
    am, bm = T._match_lengths(a.reshape(-1, n[0]), oy.reshape(-1, n[1]),
                              perm)
    ref = torch.mean(torch.abs(torch.sort(am, dim=1, stable=True)[0]
                               - torch.sort(bm, dim=1, stable=True)[0]))
    ref.backward()
    assert abs(float(loss) - float(ref)) <= 1e-6 * float(ref)
    assert torch.allclose(gx, a.grad, rtol=0, atol=1e-9)


def test_swd_draws_and_the_trainer_lengths():
    """`swd_draws` from a generator: the raw projections' shape and a
    permutation of the tiled shorter column (none without a deficit);
    the same seed gives the same draws."""
    d1 = T.swd_draws(torch.Generator().manual_seed(4), 8, 3, 3, 5,
                     T.swd_n_short(50, 48))
    d2 = T.swd_draws(torch.Generator().manual_seed(4), 8, 3, 3, 5, 48)
    assert tuple(d1["rand"].shape) == (8, 3, 3, 5, 5)
    assert sorted(d1["perm"].tolist()) == list(range(48))
    assert torch.equal(d1["rand"], d2["rand"])
    assert torch.equal(d1["perm"], d2["perm"])
    assert T.swd_n_short(48, 48) == 0 and T.swd_n_short(10, 5) == 0
    assert T.swd_n_short(7, 3) == 6


def test_swd_refuses_a_target_with_gradient_and_wrong_draws():
    x, y = (torch.from_numpy(v) for v in _clips(9, 6, 6))
    draws = T.swd_draws(torch.Generator().manual_seed(0), 4, 3, 3, 3, 0)
    with pytest.raises(ValueError, match="target"):
        T.swd_3d_loss(x, y.clone().requires_grad_(True), draws=draws,
                      **dict(BASE, num_proj=4))
    with pytest.raises(ValueError, match="projections"):
        T.swd_3d_loss(x, y, draws=draws, **dict(BASE, num_proj=8))


# K24/K26's redesign (csrc/swd.cu swd_tile_gemm_kernel, swd_fold_t_kernel):
# 128 x 128 output tiles of 256 threads, 8 x 8 outputs a thread, stages of
# 16 reduction entries; the first design padded K to a multiple of 32.  The
# fold: blocks of 32 t (lanes) x 8 w (warps), 4 loads in flight a thread.
_TILE, _BK, _THREADS = 128, 16, 256
_FOLD_T, _FOLD_W, _FOLD_BATCH = 32, 8, 4
# (psz, strides, P, (C, Tx, H, W)): tests/test_torch_cuda.py's SWD_GEOMS at
# its _swd_inputs shape, a shipped-like ref view at P = 256, and tails: d =
# 48 (K % 32 == 16: the explicit zero step) at P = 1, N under one tile
TILE_GEOMS = {
    "ref_view": ((3, 11, 11), (1, 4, 4), 37, (3, 12, 40, 53)),
    "other_view": ((3, 3, 3), (1, 2, 2), 64, (3, 12, 40, 53)),
    "p5_s3_st2": ((2, 5, 5), (2, 3, 3), 70, (3, 12, 40, 53)),
    "shipped_like": ((3, 11, 11), (1, 4, 4), 256, (3, 14, 60, 71)),
    "d48_p1": ((1, 4, 4), (1, 2, 2), 1, (3, 5, 9, 21)),
    "n_under_tile": ((3, 3, 3), (1, 2, 2), 37, (3, 5, 9, 11)),
}


def _tile_outputs(M, N):
    """swd_tile_gemm_kernel's block -> tile map (the axis with fewer tiles
    fastest) and its (thread, register slot) -> output map: (m, n) arrays
    over blocks x 256 threads x 8 x 8 slots."""
    tm, tn = -(-M // _TILE), -(-N // _TILE)
    blk = np.arange(tm * tn)
    mt, nt = (blk % tm, blk // tm) if tm <= tn else (blk // tn, blk % tn)
    tid = np.arange(_THREADS)
    warp, lane = tid >> 5, tid & 31
    ty = (warp >> 1) * 4 + (lane >> 3)
    tx = (warp & 1) * 8 + (lane & 7)
    slot = np.arange(8)
    rows = np.where(slot < 4, ty[:, None] * 4 + slot,
                    64 + ty[:, None] * 4 + slot - 4)           # (256, 8)
    cols = np.where(slot < 4, tx[:, None] * 4 + slot,
                    64 + tx[:, None] * 4 + slot - 4)
    m = mt[:, None, None, None] * _TILE + rows[None, :, :, None]
    n = nt[:, None, None, None] * _TILE + cols[None, :, None, :]
    return np.broadcast_arrays(m, n)


def _assert_each_output_once(M, N):
    m, n = _tile_outputs(M, N)
    keep = (m < M) & (n < N)
    count = np.bincount((m[keep] * N + n[keep]).ravel(), minlength=M * N)
    np.testing.assert_array_equal(count, np.ones(M * N, np.int64))


def _stage_loads(project):
    """The (entry in the stage, tile row or column) pairs the 256 threads
    load in one stage: K24 lanes along k (entry tid % 16, rows tid / 16 +
    16 i), K26 lanes along the row (tid % 128, entries tid / 128 + 2 i)."""
    tid = np.arange(_THREADS)[:, None]
    i = np.arange(_TILE * _BK // _THREADS)[None, :]
    if project:
        kk, r = np.broadcast_arrays(tid % _BK,
                                    tid // _BK + (_THREADS // _BK) * i)
    else:
        kk, r = np.broadcast_arrays(tid // 128 + (_THREADS // 128) * i,
                                    tid % 128)
    return kk.ravel(), r.ravel()


def _cursor_offsets(lk, K, g):
    """KCursor: the v offset of entry s * 16 + lk at every stage s with
    that entry below K, stepped forward 16 entries a stage."""
    C, T_, H, W, pt, p = g
    dx, dy, dt, c = lk, 0, 0, 0
    out = {}
    for s in range(-(-K // _BK)):
        if s:
            dx += _BK
        while dx >= p:
            dx -= p
            dy += 1
            if dy == p:
                dy, dt = 0, dt + 1
                if dt == pt:
                    dt, c = 0, c + 1
        k = s * _BK + lk
        if k < K:
            out[k] = ((c * T_ + dt) * H + dy) * W + dx
    return out


@pytest.mark.parametrize("case", list(TILE_GEOMS))
def test_swd_tile_gemm_maps_emulated(case):
    """K24's and K26's GEMM redesign emulated on the host: every output (m,
    n) of both products is one thread's register slot exactly once; every
    stage loads each (entry, row) of its two operand tiles once; K24's
    gather offsets (the tile's column bases plus each lane's stepped entry
    offset) equal extract_patches_3d's; the stages' real steps number K
    (the first design's zero step where K % 32 != 0 is one explicit add);
    K26's scratch rows hold each output once; and the f64 sums
    over the emulated gather equal swd_project_plain within 1e-6."""
    psz, strides, P, shape = TILE_GEOMS[case]
    C, T_, H, W = shape
    (pt, p, _), (st, s, _) = psz, strides
    cf, ch, cw = ((T_ - pt) // st + 1, (H - p) // s + 1, (W - p) // s + 1)
    N, d = cf * ch * cw, C * pt * p * p
    _assert_each_output_once(P, N)        # K24: P x N
    _assert_each_output_once(d, N)        # K26's first pass: d x N
    for project in (True, False):
        kk, r = _stage_loads(project)
        count = np.bincount(kk * _TILE + r, minlength=_BK * _TILE)
        np.testing.assert_array_equal(count, np.ones(_BK * _TILE, np.int64))
    for K in (d, P):
        stages = [min(_BK, K - s0 * _BK) for s0 in range(-(-K // _BK))]
        assert sum(stages) == K and min(stages) > 0
    # the gather: column bases + stepped entry offsets
    n = np.arange(N)
    f, loc = n % cf, n // cf
    colbase = f * st * H * W + (loc // cw) * s * W + (loc % cw) * s
    off = np.zeros(d, np.int64)
    for lk in range(_BK):
        for k, o in _cursor_offsets(lk, d, (C, T_, H, W, pt, p)).items():
            off[k] = o
    gidx = colbase[:, None] + off[None, :]                 # (N, d)
    idx = torch.arange(C * T_ * H * W, dtype=torch.float64).reshape(shape)
    want = extract_patches_3d(idx, psz, strides).numpy()    # (cf, ch, cw, d)
    want = want.transpose(1, 2, 0, 3).reshape(N, d)         # n = loc cf + f
    np.testing.assert_array_equal(gidx, want.astype(np.int64))
    # K26's scratch: row q of round_up(N, 4), patch column fastest
    pitch = -(-N // 4) * 4
    at = np.arange(d)[:, None] * pitch + n[None, :]
    assert len(np.unique(at)) == d * N and at.max() < d * pitch
    rng = np.random.default_rng(len(case))
    v = rng.uniform(-1, 1, shape).astype(np.float32)
    rand = T.normalized_projections(torch.from_numpy(
        rng.standard_normal((P, C) + psz).astype(np.float32)))
    out64 = rand.numpy().astype(np.float64) @ v.ravel()[gidx].T.astype(
        np.float64)
    plain = T.swd_project_plain(torch.from_numpy(v), rand, psz, strides)
    np.testing.assert_allclose(out64.reshape(P, ch * cw, cf), plain.numpy(),
                               rtol=0, atol=1e-6 * float(plain.abs().max()))


def _first_patch(pos, p, s):
    num = pos - p + 1
    return np.where(num <= 0, 0, (num + s - 1) // s)


def _fold_ranges(c, t, h, w, g):
    """The (lo, count) of each voxel's covering patches along i, j, f."""
    cf, ch, cw, pt, p, st, s = g
    i_lo, j_lo = _first_patch(h, p, s), _first_patch(w, p, s)
    f_lo = _first_patch(t, pt, st)
    ni = np.maximum(0, np.minimum(ch - 1, h // s) - i_lo + 1)
    nj = np.maximum(0, np.minimum(cw - 1, w // s) - j_lo + 1)
    nf = np.maximum(0, np.minimum(cf - 1, t // st) - f_lo + 1)
    return (i_lo, ni), (j_lo, nj), (f_lo, nf)


def _fold_first(G_old, shape, g, d):
    """swd_fold_first_kernel on its (cf ch cw, d) scratch: per voxel, the
    f32 adds over (i, j, f) ascending, doubled."""
    cf, ch, cw, pt, p, st, s = g
    c, t, h, w = (a.ravel() for a in np.indices(shape))
    (i_lo, ni), (j_lo, nj), (f_lo, nf) = _fold_ranges(c, t, h, w, g)
    acc = np.zeros(c.shape, np.float32)
    for a in range(int(ni.max(initial=0))):
        for b in range(int(nj.max(initial=0))):
            for e in range(int(nf.max(initial=0))):
                ok = (a < ni) & (b < nj) & (e < nf)
                i, j, f = i_lo[ok] + a, j_lo[ok] + b, f_lo[ok] + e
                qq = ((c[ok] * pt + t[ok] - f * st) * p * p
                      + (h[ok] - i * s) * p + (w[ok] - j * s))
                acc[ok] = acc[ok] + G_old[((i * cw + j) * cf + f) * d + qq]
    return np.float32(2) * acc


def _fold_redesign(G_new, pitch, shape, g):
    """swd_fold_t_kernel on the (d, pitch) scratch: its block, lane and
    warp -> voxel map (each voxel once), each thread's (i, j, f) counter
    stepped as the kernel steps it, kFoldBatch loads then their f32 adds
    in order, doubled, written back through the block's transpose."""
    C, T_, H, W = shape
    cf, ch, cw, pt, p, st, s = g
    tb_n, wb_n = -(-T_ // _FOLD_T), -(-W // _FOLD_W)
    blk = np.arange(tb_n * wb_n * H * C)
    tb, rest = blk % tb_n, blk // tb_n
    wb, rest = rest % wb_n, rest // wb_n
    h, c = rest % H, rest // H
    lane, warp = np.meshgrid(np.arange(32), np.arange(8), indexing="xy")
    t = tb[:, None, None] * _FOLD_T + lane[None]          # (blocks, 8, 32)
    w = wb[:, None, None] * _FOLD_W + warp[None]
    c, h = (np.broadcast_to(a[:, None, None], t.shape) for a in (c, h))
    live = (t < T_) & (w < W)
    c, t, h, w = c[live], t[live], h[live], w[live]
    flat = ((c * T_ + t) * H + h) * W + w
    np.testing.assert_array_equal(np.sort(flat), np.arange(C * T_ * H * W))
    (i_lo, ni), (j_lo, nj), (f_lo, nf) = _fold_ranges(c, t, h, w, g)
    total = ni * nj * nf
    i, j, f = i_lo.copy(), j_lo.copy(), f_lo.copy()
    acc = np.zeros(c.shape, np.float32)
    for e0 in range(0, int(total.max(initial=0)), _FOLD_BATCH):
        vals = []
        for u in range(_FOLD_BATCH):
            ok = e0 + u < total
            qq = ((c * pt + t - f * st) * p * p + (h - i * s) * p
                  + (w - j * s))
            at = qq * pitch + (i * cw + j) * cf + f
            vals.append((ok, np.where(ok, G_new[np.where(ok, at, 0)], 0)))
            f = np.where(ok, f + 1, f)
            wrap = ok & (f > f_lo + nf - 1)
            f = np.where(wrap, f_lo, f)
            j = np.where(wrap, j + 1, j)
            wrap_j = wrap & (j > j_lo + nj - 1)
            j = np.where(wrap_j, j_lo, j)
            i = np.where(wrap_j, i + 1, i)
        for ok, val in vals:
            acc = np.where(ok, acc + val.astype(np.float32), acc)
    out = np.empty(C * T_ * H * W, np.float32)
    out[flat] = np.float32(2) * acc
    return out


@pytest.mark.parametrize("case", list(TILE_GEOMS))
def test_swd_fold_redesign_emulated(case):
    """K26's fold redesign emulated on the host: over the transposed
    scratch (d rows of the patch columns, padded to 4) with its thread
    map and batched loads, it equals bit for bit the first design's fold
    over the (cf ch cw, d) scratch of the same patch gradients, and lies
    within 1e-5 * max|g| of swd_project_grad_plain."""
    psz, strides, P, shape = TILE_GEOMS[case]
    C, T_, H, W = shape
    (pt, p, _), (st, s, _) = psz, strides
    cf, ch, cw = ((T_ - pt) // st + 1, (H - p) // s + 1, (W - p) // s + 1)
    N, d = cf * ch * cw, C * pt * p * p
    rng = np.random.default_rng(10 + len(case))
    gx = rng.standard_normal((P, ch * cw, cf)).astype(np.float32)
    rand = T.normalized_projections(torch.from_numpy(
        rng.standard_normal((P, C) + psz).astype(np.float32)))
    # the patch gradients G[n, q], n = loc cf + f (any f32 values: both
    # folds read the same ones)
    Gm = (torch.from_numpy(gx).permute(1, 2, 0).reshape(N, P)
          @ rand).numpy()
    G_old = Gm.ravel()
    pitch = -(-N // 4) * 4
    G_new = np.full((d, pitch), np.nan, np.float32)
    G_new[:, :N] = Gm.T
    g = (cf, ch, cw, pt, p, st, s)
    old = _fold_first(G_old, shape, g, d)
    new = _fold_redesign(G_new.ravel(), pitch, shape, g)
    np.testing.assert_array_equal(new.view(np.int32), old.view(np.int32))
    plain = T.swd_project_grad_plain(torch.from_numpy(gx), rand, shape, psz,
                                     strides).numpy().ravel()
    assert np.abs(new - plain).max() <= 1e-5 * np.abs(plain).max()


# ---------------------------------------------------------------------------
# K25's redesign emulated on the host: its keys, the keyed bitonic network
# in a warp's registers (n <= 64) and in shared memory (64 < n <= 1,024),
# the inverse match map and the column's sums in the first design's order
# ---------------------------------------------------------------------------

def _sort_values(case, n, seed):
    """A column of n f32 values of one kind."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(np.float32)
    if case == "heavy_ties":
        v = np.round(v * 2) / 2
    elif case == "all_equal":
        v[:] = np.float32(0.375)
    elif case == "pm_zero":
        v = np.where(rng.random(n) < 0.6,
                     np.where(rng.random(n) < 0.5, np.float32(0.0),
                              np.float32(-0.0)), v).astype(np.float32)
    elif case == "nan":
        v[rng.random(n) < 0.2] = np.nan
        v[rng.random(n) < 0.1] = -np.inf
        v[0] = np.nan
    return torch.from_numpy(v)


def _sort_l1_keys(v):
    """csrc/swd.cu:sort_key: the order-preserving u32 keys (int64) of f32
    values, -0 as +0 (K27's `sort_keys`) and every NaN 0xFFFFFFFF, after
    +inf."""
    k = sort_keys(v).long() & 0xFFFFFFFF
    return torch.where(torch.isnan(v), torch.full_like(k, 0xFFFFFFFF), k)


def _sort_l1_slots(n):
    """The slots of K25's network for columns of n entries: 64 in
    registers up to n = 64 (csrc/swd.cu kNetSlots), else the power of
    two >= n in shared memory."""
    slots = 64
    while slots < n:
        slots *= 2
    return slots


def _x_keys(v):
    """x's keys in the order of csrc/swd.cu's u64 (key << 32 | r): key
    2^11 + r, exact for r < 2,048."""
    return _sort_l1_keys(v) * 2048 + torch.arange(v.numel())


def _net64_emulated(keys, pad):
    """csrc/swd.cu:bitonic64 on 64 keys, step by step as a column's 8
    lanes run it: slot s = 8 g + j in lane g's register a[j]; each merge
    of k slots first pairs s with s ^ (k - 1) (within the lane up to k = 8,
    else lane g's a[j] with lane g ^ (k / 8 - 1)'s a[7 - j], the lower
    lane keeping the smaller key), then s with s ^ jd (within the lane
    below 8, else a shuffle to lane g ^ jd / 8): the lower slot keeps the
    smaller key."""
    a = torch.full((8, 8), pad, dtype=torch.long)        # [g, j]
    a.view(-1)[:keys.numel()] = keys
    g = torch.arange(8)

    def order2(j1, j2):
        lo = torch.minimum(a[:, j1], a[:, j2])
        hi = torch.maximum(a[:, j1], a[:, j2])
        a[:, j1], a[:, j2] = lo, hi
    for lk in range(1, 7):
        k = 1 << lk
        if k <= 8:
            for j in range(8):
                if not j & (k >> 1):
                    order2(j, j ^ (k - 1))
        else:
            m = k // 8 - 1
            keep_min = (g & (k // 16)) == 0
            b = a[g ^ m].flip(1)                 # lane g ^ m's a[7 - j]
            a = torch.where(keep_min[:, None] == (b < a), b, a)
        for lj in range(lk - 2, -1, -1):
            jd = 1 << lj
            if jd < 8:
                for j in range(8):
                    if not j & jd:
                        order2(j, j | jd)
            else:
                m = jd // 8
                keep_min = (g & m) == 0
                p = a[g ^ m]
                a = torch.where(keep_min[:, None] == (p < a), p, a)
    return a.reshape(-1)


def _net_smem_emulated(keys, pad, slots):
    """csrc/swd.cu:swd_sort_smem_kernel's network over `slots` keys in
    shared memory: pair p's lower slot i (p with a zero at bit jd), upper
    i | jd, swapped where (b < a) == ascending."""
    s = torch.full((slots,), pad, dtype=torch.long)
    s[:keys.numel()] = keys
    p = torch.arange(slots // 2)
    k = 2
    while k <= slots:
        jd = k // 2
        while jd > 0:
            i = ((p & ~(jd - 1)) << 1) | (p & (jd - 1))
            l_ = i | jd
            up = (i & k) == 0
            a, b = s[i], s[l_]
            swap = (b < a) == up
            s[i] = torch.where(swap, b, a)
            s[l_] = torch.where(swap, a, b)
            jd //= 2
        k *= 2
    return s


def _keyed_sort(v):
    """The kernel's sort of one column: (the sorted keys' values, x's
    matched indices by rank), through the network its length takes."""
    n = v.numel()
    slots = _sort_l1_slots(n)
    pad = 2 ** 43 - 1
    keys = _x_keys(v)
    out = _net64_emulated(keys, pad) if slots == 64 \
        else _net_smem_emulated(keys, pad, slots)
    assert (out[n:] == pad).all()
    idx = out[:n] % 2048
    return v[idx], idx


@pytest.mark.parametrize("n", [1, 7, 50, 64, 65, 1024])
@pytest.mark.parametrize("case", ["random", "heavy_ties", "all_equal",
                                  "pm_zero", "nan"])
def test_sort_l1_keyed_network_emulated(case, n):
    """K25's keys and network (the register form at n <= 64, the shared
    memory form beyond), padded with keys that sort last and broken by
    the matched index: the stable sort's order, NaNs last in index order,
    -0 and +0 tied: torch.sort(stable=True)'s indices and values."""
    v = _sort_values(case, n, seed=n)
    got_v, got_i = _keyed_sort(v)
    want_v, want_i = torch.sort(v, stable=True)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    # the keys decode to the values (-0 as +0, a NaN as a NaN)
    k = _sort_l1_keys(v)
    u = torch.where(k >= 2 ** 31, k & 0x7FFFFFFF, k ^ 0xFFFFFFFF)
    back = u.to(torch.int32).view(torch.float32)
    same = (back == v) | (torch.isnan(back) & torch.isnan(v))
    assert same.all() and not (torch.signbit(back) & (back == 0)).any()


INV_CASES = {"x_longer_deficit": (9, 4), "x_shorter_deficit": (4, 9),
             "equal": (6, 6), "x_longer_twice_deficit": (7, 3),
             "x_shorter_no_deficit": (4, 8)}


@pytest.mark.parametrize("case", list(INV_CASES))
def test_match_inverse_lists_each_source_copies(case):
    """match_inverse of `_match_maps`' map: each source's copies r of the
    map, ascending, and every r once; None without a map."""
    n_x, n_y = INV_CASES[case]
    gen = torch.Generator().manual_seed(11)
    perm = torch.randperm(max(n_x, n_y) // min(n_x, n_y) * min(n_x, n_y),
                          generator=gen)
    maps = T._match_maps(n_x, n_y, perm, torch.device("cpu"))
    for m, n_side in zip(maps, (n_x, n_y)):
        inv = T.match_inverse(m, n_side)
        if m is None:
            assert inv is None
            continue
        start, order = inv
        assert start.dtype == order.dtype == torch.int32
        assert int(start[0]) == 0 and int(start[-1]) == m.numel()
        assert sorted(order.tolist()) == list(range(m.numel()))
        for src in range(n_side):
            got = order[start[src]:start[src + 1]].tolist()
            assert got == [r for r in range(m.numel()) if m[r] == src]
    assert (maps[0] is None) == (n_x >= n_y)


def _first_design_column(xv, yv, map_x, nx, inv):
    """csrc/swd.cu:swd_sort_l1_first_kernel on one matched column, in f32:
    (the 32 lanes' |d| sums, gx of the column)."""
    n = xv.size
    f32 = np.float32

    def rank(v, i):
        a = v[i]
        return int(sum((v[k] < a) or (v[k] == a and k < i)
                       for k in range(n)))
    sy = np.zeros(n, f32)
    for r in range(n):
        sy[rank(yv, r)] = yv[r]
    inv_f = f32(1.0) / f32(n * 7)
    lsum = np.zeros(32, f32)
    gm = np.zeros(n, f32)
    for r in range(n):
        d = f32(xv[r] - sy[rank(xv, r)])
        lsum[r % 32] = f32(lsum[r % 32] + abs(d))
        gm[r] = inv_f if d >= 0 else -inv_f
    g = _gx_from_gm(gm, map_x, nx)
    return lsum, g


def _gx_from_gm(gm, map_x, nx):
    if map_x is None:
        return gm.copy()
    g = np.zeros(nx, np.float32)
    for src in range(nx):
        acc = np.float32(0)
        for r in range(gm.size):
            if map_x[r] == src:
                acc = np.float32(acc + gm[r])
        g[src] = acc
    return g


def _redesign_column(xv, yv, map_x, nx, inv):
    """The redesign on one matched column: keyed sorts, rank s of x paired
    with rank s of y, |d| and the sign to x's matched index, the lanes'
    sums over r = lane, lane + 32, ..., gx through the inverse map."""
    n = xv.numel()
    f32 = np.float32
    sx, ix = _keyed_sort(xv)
    sy, _ = _keyed_sort(yv)
    # the values the kernel decodes from its keys: -0 as +0
    sx, sy = sx + 0.0, sy + 0.0
    inv_f = f32(1.0) / f32(n * 7)
    ad = np.zeros(n, f32)
    gm = np.zeros(n, f32)
    for s in range(n):
        d = f32(sx[s].item() - sy[s].item())
        ad[ix[s]] = abs(d)
        gm[ix[s]] = inv_f if d >= 0 else -inv_f
    lsum = np.zeros(32, f32)
    for r in range(n):
        lsum[r % 32] = f32(lsum[r % 32] + ad[r])
    if map_x is None:
        return lsum, gm
    start, order = inv
    g = np.zeros(nx, f32)
    for src in range(nx):
        acc = f32(0)
        for k in range(int(start[src]), int(start[src + 1])):
            acc = f32(acc + gm[int(order[k])])
        g[src] = acc
    return lsum, g


@pytest.mark.parametrize("lengths", [(50, 48), (48, 50), (30, 30), (70, 66),
                                     (3, 7)],
                         ids=["x_longer", "y_longer", "equal", "smem",
                              "x_tiled"])
@pytest.mark.parametrize("case", ["random", "heavy_ties", "pm_zero"])
def test_sort_l1_redesign_equals_first_design_emulated(case, lengths):
    """On finite columns the redesign's per-lane |d| sums (what the shuffle
    tree, the block and swd_sum_kernel add, unchanged) and gx are bit for
    bit the first design's, x and y matched through either map; and gx
    is the plain version's."""
    nx, ny = lengths
    n = max(nx, ny)
    gen = torch.Generator().manual_seed(5)
    perm = torch.randperm(n // min(nx, ny) * min(nx, ny), generator=gen)
    map_x, map_y = T._match_maps(nx, ny, perm, torch.device("cpu"))
    inv = T.match_inverse(map_x, nx)
    for col in range(2):
        x = _sort_values(case, nx, seed=10 + col)
        y = _sort_values(case, ny, seed=20 + col)
        xv = x[map_x.long()] if map_x is not None else x
        yv = y[map_y.long()] if map_y is not None else y
        mx = None if map_x is None else map_x.numpy()
        l1, g1 = _first_design_column(xv.numpy(), yv.numpy(), mx, nx, inv)
        l2, g2 = _redesign_column(xv, yv, mx, nx, inv)
        np.testing.assert_array_equal(l1.view(np.int32), l2.view(np.int32))
        np.testing.assert_array_equal(g1.view(np.int32), g2.view(np.int32))
        _, gp = T.sort_l1_cols_plain(x[None], y[None], map_x, map_y)
        # the plain version's 1 / N from a (1, n) column: N = n; the
        # emulations' from n * 7, so compare the signs' pattern
        np.testing.assert_array_equal(np.sign(gp[0].numpy()), np.sign(g2))


@pytest.mark.parametrize("lengths", [(50, 48), (48, 50), (90, 90)],
                         ids=["x_longer", "y_longer", "smem"])
def test_sort_l1_redesign_nans_as_the_plain_version(lengths):
    """With NaNs in x and y the redesign routes every sign as the plain
    version (a stable torch.sort, NaNs last in index order): gx's signs
    equal, NaN pairs taking -1/N; the first design (every NaN rank 0)
    does not."""
    nx, ny = lengths
    n = max(nx, ny)
    gen = torch.Generator().manual_seed(6)
    perm = torch.randperm(n // min(nx, ny) * min(nx, ny), generator=gen)
    map_x, map_y = T._match_maps(nx, ny, perm, torch.device("cpu"))
    inv = T.match_inverse(map_x, nx)
    x = _sort_values("nan", nx, seed=3)
    y = _sort_values("nan", ny, seed=4)
    xv = x[map_x.long()] if map_x is not None else x
    yv = y[map_y.long()] if map_y is not None else y
    mx = None if map_x is None else map_x.numpy()
    _, g2 = _redesign_column(xv, yv, mx, nx, inv)
    _, gp = T.sort_l1_cols_plain(x[None], y[None], map_x, map_y)
    np.testing.assert_array_equal(np.sign(gp[0].numpy()), np.sign(g2))


# K28's redesign (csrc/swd_mask.cu mask_l1_bits_kernel): a block's
# threads, the loads each thread has in flight
_L1_THREADS, _L1_UNROLL = 1024, 4


def _fastdiv(n, d):
    """csrc/swd_mask.cu:fdiv on the host: n // d for n < 2^32, 1 <= d <
    2^31 by the round-up method (t = umulhi(m, n), (t + ((n - t) >> s1))
    >> s2), in uint64."""
    l = int(d - 1).bit_length()
    m = np.uint64((((1 << l) - d) << 32) // d + 1)
    n = np.asarray(n, np.uint64)
    t = (m * n) >> np.uint64(32)
    return ((t + ((n - t) >> np.uint64(min(l, 1))))
            >> np.uint64(max(l - 1, 0))).astype(np.int64)


def _bit_positions(m, n_x, L, cf, tiled):
    """csrc/swd_mask.cu:bit_pos: copy k of x's conv-order entry e = f L + l
    at k n_x + l cf + f, the deficit's copies at their matched index (the
    kernel's divisions by `_fastdiv`)."""
    m = np.asarray(m, np.int64)
    k = np.zeros_like(m) if tiled == n_x else _fastdiv(m, n_x)
    e = m - k * n_x
    f = _fastdiv(e, L)
    return np.where(m >= tiled, m, k * n_x + (e - f * L) * cf + f)


def test_swd_mask_l1_fastdiv():
    """K28's division by invariant divisors (csrc/swd_mask.cu:fdiv) is
    floor division for every divisor and dividend it meets: dividends
    below 2^30, divisors 1 to 2^30 (their edges, powers of two and
    random), the dividends at the multiples and their neighbours."""
    rng = np.random.default_rng(12)
    ds = [1, 2, 3, 5, 7, 40, 169, 1024, 1025, 57_856, 167_700, 12_000_000,
          2 ** 29 + 1, 2 ** 30 - 1, 2 ** 30]
    ds += [int(v) for v in rng.integers(1, 2 ** 30, 40)]
    for d in ds:
        q = rng.integers(0, 2 ** 30 // d + 1, 200)
        n = np.concatenate([q * d, q * d + d - 1, q * d - 1,
                            rng.integers(0, 2 ** 30, 200), [0, 2 ** 30 - 1]])
        n = n[(n >= 0) & (n < 2 ** 30)]
        np.testing.assert_array_equal(_fastdiv(n, d), n // d)


def _block_double_sum(vals):
    """One block's double sum of its ranks' |d| in the kernel's order:
    thread t adds its ranks t + 1024 (u + 4 i) in order, then each warp's
    shuffle-down tree, then the warps in order."""
    n = vals.size
    acc = np.zeros(_L1_THREADS)
    for r0 in range(0, n, _L1_THREADS * _L1_UNROLL):
        for u in range(_L1_UNROLL):
            lo = r0 + u * _L1_THREADS
            chunk = vals[lo:lo + _L1_THREADS]
            acc[:chunk.size] = acc[:chunk.size] + chunk
    acc = acc.reshape(-1, 32)
    for o in (16, 8, 4, 2, 1):
        acc[:, :32 - o] = acc[:, :32 - o] + acc[:, o:]
    total = 0.0
    for w in acc[:, 0]:
        total = total + w
    return total


def _loss_kernel(partial, count):
    """csrc/swd_mask.cu:mask_loss_kernel: 1,024 threads add the partials
    t, t + 1024, ... in order, a tree, then f32 over the count."""
    red = np.zeros(1024)
    for i, v in enumerate(partial):
        red[i % 1024] = red[i % 1024] + v
    half = 512
    while half:
        red[:half] = red[:half] + red[half:2 * half]
        half //= 2
    return np.float32(red[0]) / np.float32(count)


def emulate_k28(kx_vals, ix, ky_vals, plan, L, cfx, blocks=1):
    """K28's redesign on the host, a row to `blocks` blocks (one:
    mask_l1_bits_kernel; more: the global route's mask_l1_set_kernel and
    mask_l1_grad_kernel, whose partials come in row, then block order):
    block b takes ranks [n b / B, n (b + 1) / B) of its row, sums their
    |d| in double in its order and sets the positive signs' bits at
    `_bit_positions`; then each entry of gx's order adds its copies'
    signs +-inv in increasing matched index in f32: the tiled copies k n_x
    + o, then the deficit's tiled + j for j = invp_t[q n_x + o] <
    deficit, ascending by selection.  kx_vals / ky_vals: the sorted rows
    (P, n) as f32; ix: x's payload.  Returns (loss, gx (P, L, cfx))."""
    P, n = kx_vals.shape
    n_x = L * cfx
    tiled, deficit = plan["tiled"], plan["deficit"]
    d = (kx_vals - ky_vals).astype(np.float32)
    count = np.float32(P * n)
    inv = np.float32(1.0) / count
    partial = []
    bits = np.zeros((P, n), bool)
    for p in range(P):
        for b in range(blocks):
            lo, hi = n * b // blocks, n * (b + 1) // blocks
            partial.append(_block_double_sum(np.abs(d[p, lo:hi])
                                             .astype(np.float64)))
            pos = _bit_positions(ix[p, lo:hi], n_x, L, cfx, tiled)
            pos = pos[d[p, lo:hi] >= 0]
            assert not bits[p, pos].any()       # each bit set once
            bits[p, pos] = True
    sgn = np.where(bits, inv, -inv).astype(np.float32)
    o = np.arange(n_x)
    if n_x == n:
        gx = sgn[:, :n_x].copy()
    else:
        reps = tiled // n_x
        gx = np.zeros((P, n_x), np.float32)
        for k in range(reps):
            gx = gx + sgn[:, k * n_x + o]
        if deficit:
            invp_t = T.invp_in_grad_order(plan["invp"], L, cfx).numpy()
            cand = np.stack([invp_t[q * n_x + o] for q in range(reps)])
            prev = np.full(n_x, -1)
            while True:
                ok = (cand > prev) & (cand < deficit)
                best = np.where(ok, cand, deficit).min(0)
                live = best < deficit
                if not live.any():
                    break
                add = sgn[:, tiled + np.minimum(best, deficit - 1)]
                gx = np.where(live, gx + add, gx)
                prev = np.where(live, best, prev)
    return _loss_kernel(partial, count), gx.reshape(P, L, cfx)


# (Tx, Ty, factor, mask rows, mask columns): x longer (n_x = n), equal
# lengths, a deficit, two tilings of x with a deficit, and a static x
K28_CASES = {"x_longer": (7, 6, 1, (3, 10), (5, 14)),
             "equal_f1": (6, 6, 1, (3, 10), (5, 14)),
             "deficit_f3": (7, 6, 3, (3, 10), (5, 14)),
             "two_tilings_f3": (6, 6, 3, (0, 16), (0, 20)),
             "static_f1": (7, 6, 1, (3, 10), (5, 14)),
             "static_f3": (7, 6, 3, (3, 10), (5, 14))}


@pytest.mark.parametrize("case", list(K28_CASES))
def test_swd_mask_l1_redesign_emulated(case):
    """K28's redesign emulated on the host from the sorted rows (as K27
    gives them): its gradient bit-equal to the plain mask branch's
    (`swd_mask_sort_l1_plain`) at n_x = n, with tiling and with a deficit,
    at factors 1 and 3, and with exact ties (a static x), for a block a
    row and for 2 and 3 blocks a row (the global route's blocks); its loss
    (the kernel's double sums, in its order) within 1e-6 of the plain
    version's and of JAX's swd_3d_loss(mask=...) on the same draws."""
    Tx, Ty, factor, (r0, r1), (c0, c1) = K28_CASES[case]
    x, y = _clips(8, Tx, Ty)
    if case.startswith("static"):
        x[:] = x[:, :1]
    mask = np.zeros(x.shape[2:], np.float32)
    mask[r0:r1, c0:c1] = 1.0
    cfg = dict(BASE, num_proj=6)
    psz, strides = (3, 3, 3), (1, 1, 1)
    sel = T.mask_patch_columns(mask, 3, 3, 1, 1, n_frames=Ty)
    order = torch.from_numpy(np.concatenate(
        [np.nonzero(~sel)[0]] + [np.nonzero(sel)[0]] * factor))
    key = jax.random.PRNGKey(3)
    L = 17 * 21
    n_x, n_y = _cols(Tx, cfg) * L, int(order.numel())
    draws = _jax_draws(key, cfg, 3, n_x, n_y)
    rand = T.normalized_projections(draws["rand"])
    ox = T.swd_project_plain(torch.from_numpy(x * 2 - 1), rand, psz, strides)
    oy = T.swd_project_plain(torch.from_numpy(y * 2 - 1), rand, psz, strides)
    P, L_, cfx = ox.shape
    assert (L_, L_ * cfx) == (L, n_x)
    plan = T.swd_mask_plan(n_x, n_y, order, draws["perm"], L, cfx,
                           oy.shape[2], torch.device("cpu"))
    n = plan["n"]
    reps = plan["tiled"] // n_x
    assert (n == n_x) == (factor == 1)
    if case == "two_tilings_f3":
        assert reps == 2 and plan["deficit"] > 0
    if case in ("deficit_f3", "static_f3"):
        assert reps == 1 and plan["deficit"] > 0
    rx = ox.reshape(P, -1)[:, plan["gather_x"].long()].numpy()
    ry = oy.reshape(P, -1)[:, plan["gather_y"].long()].numpy()
    ix = np.argsort(_f2key(rx), axis=1, kind="stable")
    sx = np.take_along_axis(rx, ix, 1)
    sy = np.take_along_axis(ry, np.argsort(_f2key(ry), axis=1,
                                           kind="stable"), 1)
    loss_p, gx_p = T.swd_mask_sort_l1_plain(ox, oy, order, draws["perm"])
    jl = float(J.swd_3d_loss(jnp.asarray(x), jnp.asarray(y), key,
                             mask=mask, mask_patches_factor=factor, **cfg))
    for blocks in (1, 2, 3):
        loss, gx = emulate_k28(sx, ix, sy, plan, L, cfx, blocks)
        np.testing.assert_array_equal(gx.view(np.int32),
                                      gx_p.numpy().view(np.int32))
        assert abs(float(loss) - float(loss_p)) <= 1e-6
        assert abs(float(loss) - jl) <= 1e-6


@pytest.mark.parametrize("P,n,route", [
    (256, 168_000, "block"), (256, 1_050_000, "block"),
    (132, 57_856 * 32, "block"), (131, 57_856 * 32, "global"),
    (256, 57_856 * 32 + 1, "global"), (66, 57_856 * 32 + 1, "global"),
    (65, 57_856 * 32 + 1, "global"), (16, 1_500, "global"),
    (256, 8 * 57_856 * 32, "global"), (17, 8 * 57_856 * 32, "global"),
    (256, 8 * 57_856 * 32 + 1, "global"), (1, 2 ** 30 - 1, "global")])
def test_swd_mask_l1_layout(P, n, route):
    """K28's routes (mirrored by the kernel's vl3d_swd_mask_l1_layout,
    checked on the card): a block a row while the row's sign bits fit one
    block's 227 KB of shared memory less 1 KB (57,856 words; the masked
    rows of the stage-2 patch, 1.7e5 to 1.1e6 keys, all do) and the rows
    reach the H100's 132 SMs, else the bits in device memory and several
    blocks a row (twice 132 in all, each at least 16,384 keys); rows of
    2^30 keys or more raise, as K27 refuses them."""
    lay = T.swd_mask_l1_layout(P, n)
    assert tuple(lay) == T.SWD_MASK_L1_LAYOUT_KEYS
    words = -(-n // 32)
    assert lay["route"] == route
    assert lay["threads"] == 1024
    assert lay["words"] == words
    assert lay["smem"] == (0 if route == "global" else 4 * words)
    assert lay["smem"] <= 227 * 1024 - 1024
    assert lay["scratch"] == (P * words if route == "global" else 0)
    if route == "global":
        assert lay["blocks"] == P * min(-(-264 // P), -(-n // 16_384))
    else:
        assert lay["blocks"] == P >= 132
    for bad in ((P, 0), (P, 2 ** 30), (0, n)):
        with pytest.raises(ValueError, match="keys"):
            T.swd_mask_l1_layout(*bad)
