"""The SWD looping loss of the PyTorch port against the JAX package, on the
CPU: `swd_3d_loss` values and input gradients with JAX's draws fed in
(x longer, y longer, equal lengths, strides above 1, one projection,
exact ties in a static region, x = y and its +1 branch of |.|), the mask
branch at factors 1 and 3 (and the index maps and arithmetic of its
kernels K27/K28, emulated on the host), `mask_patch_columns` and
`_match_lengths`;
and the plain versions of K24-K26 against the library calls they stand
for (conv3d and its input gradient) and against autograd.  Inputs are
made with numpy and handed to both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from videoloop3d_tpu.losses import swd as J
from videoloop3d_torch.losses import swd as T


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
