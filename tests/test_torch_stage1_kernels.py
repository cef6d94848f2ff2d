"""The stage-1 kernels' plain versions against the JAX package, on the CPU:
the dense sampler K5/K6 (`render/sample.py:sample_dense`) against JAX's
gather sampler under ``jax.grad`` and its block-adjoint sampler, and the
fused composite K7/K8 (`render/fused_s1.py`) against JAX's custom VJP,
and the redesigns of K5 at C != 4, K7 and K8 emulated on the host in the
kernels' order (`_emulate_k5`, `emulate_k7`, `emulate_k8`).  Inputs are made with numpy
and handed to both packages."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.models.geometry import MPIGeometry as JGeom
from videoloop3d_tpu.render import adjoint as ADJ
from videoloop3d_tpu.render import fused_s1 as JF
from videoloop3d_tpu.render import renderer as JR
from videoloop3d_tpu.render import sample as JS
from videoloop3d_torch.render import fused_s1 as TF
from videoloop3d_torch.render import sample as TS


def _view(case, h=20, w=26):
    """(geom, ext, intrin) of a near, an oblique and a partly-outside
    view of a 3-plane geometry (as tests/test_adjoint.py builds them)."""
    intrin = np.array([[25.0, 0, w / 2], [0, 25.0, h / 2], [0, 0, 1]],
                      np.float32)
    km = intrin.copy()
    km[0, 0] *= 1.6
    km[1, 1] *= 1.6
    km[0, 2], km[1, 2] = 20, 16
    geom = JGeom(
        n_planes=3, mpi_h=int(h * 1.6) + 10, mpi_w=int(w * 1.6) + 12,
        n_tiles_h=2, n_tiles_w=3, near=1.5, far=6.0, depths=(5.0, 3.0, 2.0),
        ref_intrin_mpi=tuple(tuple(float(v) for v in r) for r in km),
        ref_extrin=tuple(tuple(float(v) for v in r) for r in np.eye(4)))
    angle = 0.06
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                   [-np.sin(angle), 0, np.cos(angle)]]
    ext[:3, 3] = [0.15, -0.08, 0.05]
    if case == "oblique":
        geom = geom.scaled(int(geom.mpi_h * 0.75), int(geom.mpi_w * 0.75))
        intrin = intrin.copy()
        intrin[0, 2] -= 6
        intrin[1, 2] += 4
        ext[:3, :3] = [[np.cos(0.25), 0, np.sin(0.25)], [0, 1, 0],
                       [-np.sin(0.25), 0, np.cos(0.25)]]
    elif case == "outside":
        ext[:3, 3] = [1.5, 0.9, 0.2]
    return geom, ext[None], intrin[None], (h, w)


def _sample_inputs(case, seed=0):
    geom, ext, intr, (h, w) = _view(case)
    coords = JR.warp_coordinates(geom, jnp.asarray(ext), jnp.asarray(intr),
                                 h, w)
    rng = np.random.default_rng(seed)
    atlas = rng.random((3, geom.mpi_h, geom.mpi_w, 5), dtype=np.float32)
    ct = rng.standard_normal((1, 3, h, w, 5)).astype(np.float32)
    return geom, ext, intr, (h, w), coords, atlas, ct


def _port_sample(atlas, x, y, ct):
    """Port values (B, D, h, w, 5) and the gradient of sum(vals * ct)
    with respect to the (atlas, mask) pair, concatenated to 5 channels."""
    a = torch.tensor(atlas[..., :4], requires_grad=True)
    m = torch.tensor(atlas[..., 4:], requires_grad=True)
    feats, mfeats = TS.sample_dense(a, m, torch.from_numpy(x),
                                    torch.from_numpy(y))
    vals = torch.cat([feats, mfeats], -1)
    (vals * torch.from_numpy(ct)).sum().backward()
    return vals.detach().numpy(), torch.cat([a.grad, m.grad], -1).numpy()


@pytest.mark.parametrize("case", ["near", "oblique", "outside"])
def test_sample_dense_matches_jax(case):
    """Values within 1e-5 and the atlas gradient within 1e-5 * max|g| of
    both JAX samplers: the gather (R.sample_dense under jax.grad) and the
    block-adjoint one (sample_dense_blockadj at prec="highest")."""
    geom, ext, intr, (h, w), coords, atlas, ct = _sample_inputs(case)
    x, y = np.array(coords.x), np.array(coords.y)
    vals, grad = _port_sample(atlas, x, y, ct)
    if case == "outside":
        assert 0.1 < float(np.mean(np.asarray(coords.valid))) < 0.9

    def gather(a):
        return JR.sample_dense(a, coords)

    M = ADJ.forward_projection(geom.depths_np(), geom.ref_intrin_mpi_np(),
                               jnp.asarray(ext), jnp.asarray(intr))
    plan = ADJ.block_plan_for(geom, h, w, (h, w))
    bwd_plan = ADJ.bwd_block_plan_for(geom, h, w, (h, w))

    def blockadj(a):
        return ADJ.sample_dense_blockadj(a, coords.x, coords.y, M, *plan,
                                         bwd_plan, "highest")

    for fn in (gather, blockadj):
        jv, vjp = jax.vjp(jax.jit(fn), jnp.asarray(atlas))
        (jg,) = vjp(jnp.asarray(ct))
        jv, jg = np.asarray(jv), np.asarray(jg)
        assert np.abs(vals - jv).max() <= 1e-5, fn.__name__
        assert np.abs(grad - jg).max() <= 1e-5 * np.abs(jg).max(), \
            fn.__name__
    # the plain version alone, and the exact zeros off the plane
    plain = TS.bilinear_planes_plain(torch.from_numpy(atlas),
                                     torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(plain.numpy(), vals)
    far = np.abs(x) > 1e6
    assert not np.any(vals[far])


def test_sample_dense_against_bf16_contractions():
    """Against JAX's --s1_gemm_bf16 mode (prec="default": bf16 inputs to
    the block contractions) the port, which computes in f32, agrees to
    bf16 rounding: 1e-2 on values of an atlas in [0, 1) and 2e-2 * max|g|
    on the gradient (bf16 keeps 8 significant bits, ~4e-3 relative per
    rounded input, and each output rounds a texel and two weights)."""
    geom, ext, intr, (h, w), coords, atlas, ct = _sample_inputs("near", 3)
    x, y = np.array(coords.x), np.array(coords.y)
    vals, grad = _port_sample(atlas, x, y, ct)
    M = ADJ.forward_projection(geom.depths_np(), geom.ref_intrin_mpi_np(),
                               jnp.asarray(ext), jnp.asarray(intr))
    plan = ADJ.block_plan_for(geom, h, w, (h, w))

    def blockadj(a):
        return ADJ.sample_dense_blockadj(a, coords.x, coords.y, M, *plan,
                                         None, "default")

    jv, vjp = jax.vjp(jax.jit(blockadj), jnp.asarray(atlas))
    (jg,) = vjp(jnp.asarray(ct))
    assert np.abs(vals - np.asarray(jv)).max() <= 1e-2
    jg = np.asarray(jg)
    assert np.abs(grad - jg).max() <= 2e-2 * np.abs(jg).max()


def test_sample_dense_far_coordinates_read_nothing():
    """Coordinates far outside the plane or huge (behind the camera) give
    exact zeros and a zero gradient, and no index leaves the atlas."""
    atlas = torch.rand((2, 5, 6, 4), requires_grad=True)
    x = torch.tensor([[[[-1e30, 1e30, 7.0, -1.5]], [[3e9, -2.0, 5.0, 2.5]]]])
    y = torch.tensor([[[[0.5, 0.5, 1.0, 1.0]], [[-4e12, 1.0, 4.0, 3.5]]]])
    feats, none = TS.sample_dense(atlas, None, x, y)
    assert none is None and feats.shape == (1, 2, 1, 4, 4)
    zero = torch.tensor([[True, True, True, True], [True, True, False, False]])
    assert not feats[0, :, 0][zero].any()
    assert feats[0, :, 0][~zero].abs().sum() > 0
    feats.sum().backward()
    assert atlas.grad[0].abs().sum() == 0


def test_sample_dense_rejects_bad_inputs():
    atlas = torch.zeros((2, 5, 6, 4))
    x = torch.zeros((1, 3, 2, 2))
    with pytest.raises(ValueError, match="expected"):
        TS.sample_dense(atlas, None, x, x)
    with pytest.raises(TypeError, match="dtype"):
        TS.sample_dense(atlas.double(), None, x[:, :2], x[:, :2])
    with pytest.raises(ValueError, match="shape"):
        TS.sample_dense(atlas, torch.zeros((2, 5, 6, 2)), x[:, :2], x[:, :2])


# K5 at C != 4 (csrc/sample_dense.cu sample_dense_block_kernel): a block's
# samples (kBlock) and the outputs a thread loads before it lerps any, by
# the width of its texel loads (Sweep<float>, Sweep<float4>)
_K5_BLOCK = 256
_K5_UNROLL = {1: 4, 4: 2}


def _k5_sweep(count, Cv, unroll):
    """The (output, sample, channel) triples of one block's sweep over its
    count x Cv outputs, as the kernel's threads visit them: thread t starts
    at output t and steps its (sample, channel) by _K5_BLOCK outputs with a
    carry, `unroll` outputs a step."""
    ds, dk = divmod(_K5_BLOCK, Cv)
    total = count * Cv
    visits = []
    for t in range(min(_K5_BLOCK, total)):
        s, k = divmod(t, Cv)
        for o0 in range(t, total, unroll * _K5_BLOCK):
            for u in range(unroll):
                if o0 + u * _K5_BLOCK < total:
                    visits.append((o0 + u * _K5_BLOCK, s, k))
                k, s = k + dk, s + ds
                if k >= Cv:
                    k, s = k - Cv, s + 1
    return np.array(visits, np.int64).reshape(-1, 3)


def _lerp(a, b, f):
    """csrc/common.cuh lerp_rn in f32, one rounding per operation."""
    return a * (np.float32(1) - f) + b * f


def _emulate_k5(atlas, mask, x, y):
    """sample_dense_block_kernel on the host: per sample, corners_of (floor,
    the float clamp to [-2, size], the four in-texture bits) and the mask
    channel; per block, the sweep of its outputs (four channels at a time
    where C % 4 == 0, as the float4 path on an aligned atlas), each output
    lerped from the four corners' texels."""
    D, Ht, Wt, C = atlas.shape
    n = x.size
    P = n // (x.shape[0] * D)
    d = (np.arange(n) // P) % D
    xs, ys = x.reshape(-1), y.reshape(-1)
    xf, yf = np.floor(xs), np.floor(ys)
    fx, fy = xs - xf, ys - yf
    x0 = np.minimum(np.maximum(xf, -2), Wt).astype(np.int64)
    y0 = np.minimum(np.maximum(yf, -2), Ht).astype(np.int64)
    xin = [(x0 + i >= 0) & (x0 + i < Wt) for i in (0, 1)]
    yin = [(y0 + i >= 0) & (y0 + i < Ht) for i in (0, 1)]
    row0 = (d * Ht + y0) * Wt + x0
    width = 4 if C % 4 == 0 else 1
    Cv = C // width
    texels = atlas.reshape(-1, Cv, width)
    corners = [(0, 0), (0, 1), (1, 0), (1, 1)]      # (row, column) steps

    def at(src, s, k, dy, dx):
        inside = yin[dy][s] & xin[dx][s]
        t = np.where(inside, row0[s] + dy * Wt + dx, 0)
        return np.where(inside[:, None], src[t, k], np.float32(0))

    out = np.full((n, Cv, width), np.nan, np.float32)
    for first in range(0, n, _K5_BLOCK):
        count = min(_K5_BLOCK, n - first)
        sweep = _k5_sweep(count, Cv, _K5_UNROLL[width])
        o, s, k = sweep.T
        assert np.array_equal(np.sort(o), np.arange(count * Cv))
        assert np.array_equal(o, s * Cv + k)
        s = s + first
        v = [at(texels, s, k, dy, dx) for dy, dx in corners]
        out[s, k] = _lerp(_lerp(v[0], v[1], fx[s, None]),
                          _lerp(v[2], v[3], fx[s, None]), fy[s, None])
    s = np.arange(n)
    m = [at(mask.reshape(-1, 1, 1), s, np.zeros(n, np.int64), dy, dx)[:, 0]
         for dy, dx in corners]
    out_m = _lerp(_lerp(m[0], m[1], fx), _lerp(m[2], m[3], fx), fy)
    return out.reshape(x.shape + (C,)), out_m.reshape(x.shape + (1,))


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 12, 13, 36, 37])
def test_sample_dense_block_sweep_emulated(C):
    """K5's redesign at C != 4 emulated on the host (corners once per
    sample, each block's outputs swept in output order, 2,880 samples:
    11.25 blocks) on planted coordinates (1e9, -4e12, whole numbers): every
    output visited once, bit-equal to the plain version and within 1e-6 of
    JAX's bilinear_planes."""
    rng = np.random.default_rng(C)
    B, D, h, w, Ht, Wt = 2, 3, 20, 24, 30, 40
    atlas = rng.standard_normal((D, Ht, Wt, C)).astype(np.float32)
    mask = rng.standard_normal((D, Ht, Wt, 1)).astype(np.float32)
    x = rng.uniform(-3, Wt + 2, (B, D, h, w)).astype(np.float32)
    y = rng.uniform(-3, Ht + 2, (B, D, h, w)).astype(np.float32)
    x.reshape(-1)[:50] = 1e9
    y.reshape(-1)[50:90] = -4e12
    x.reshape(-1)[90:120] = np.floor(x.reshape(-1)[90:120])
    feats, mfeats = _emulate_k5(atlas, mask, x, y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(
        feats, TS.bilinear_planes_plain(torch.from_numpy(atlas), tx, ty))
    np.testing.assert_array_equal(
        mfeats, TS.bilinear_planes_plain(torch.from_numpy(mask), tx, ty))
    for b in range(B):
        jv, _ = JS.bilinear_planes(jnp.asarray(atlas),
                                   jnp.asarray(x[b].reshape(D, -1)),
                                   jnp.asarray(y[b].reshape(D, -1)))
        np.testing.assert_allclose(feats[b].reshape(D, -1, C),
                                   np.asarray(jv), rtol=0, atol=1e-6)


FLAG_SETS = {
    # (sparsity, rgb_smooth, a_smooth, l_smooth, use_loop, want_disp)
    "all": (True, True, True, True, True, True),
    "shipped": (True, True, True, False, True, False),
    "loop_disp": (False, False, False, False, True, True),
    "none": (False, False, False, False, False, False),
}


def _fused_inputs(B, D=5, h=9, w=11, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, D, h, w, 4)).astype(np.float32) * 2
    valid = rng.random((B, D, h, w)) < 0.75
    # equal neighbours and saturated alphas exercise sign(0) = 0 and
    # 1 - alpha = 0
    feats[:, :, :, 3] = feats[:, :, :, 2]
    feats[:, 1, 2:4, 2:5, 3] = 40.0
    mask = rng.standard_normal((B, D, h, w)).astype(np.float32)
    dinv = rng.random((B, D, h, w)).astype(np.float32) * valid
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, h, w, 3), (B, h, w), (B, h, w), (B, h, w, 1))]
    g_regs = rng.standard_normal(4).astype(np.float32)
    return feats, valid, mask, dinv, cts, g_regs


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_fused_composite_s1_matches_jax(flags, B):
    """Forward outputs within 1e-5 (regularizers 1e-5 relative) and the
    gradients of feats and of the mask logits within 1e-5 * max|g| of the
    JAX custom VJP, for random cotangents of every output."""
    sp, rs, as_, ls, loop, disp = FLAG_SETS[flags]
    D = 5
    kw = dict(n_planes=D, use_sparsity=sp, use_rgb_smooth=rs,
              use_a_smooth=as_, use_l_smooth=ls, use_loop=loop,
              want_disp=disp)
    feats, valid, mask, dinv, cts, g_regs = _fused_inputs(B, D)
    jcfg = JF.FusedS1Cfg(**kw)
    dummy = np.zeros((1, 1, 1, 1), np.float32)
    j_mask = mask if loop else dummy
    j_dinv = dinv if disp else dummy
    names = TF.REG_NAMES

    def jfn(f, m):
        out, asum, dsp, lab, regs = JF.fused_composite_s1(
            jcfg, f, jnp.asarray(valid), m, jnp.asarray(j_dinv))
        return out, asum, dsp, lab, regs

    jout, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(feats), jnp.asarray(j_mask))
    j_cts = (jnp.asarray(cts[0]), jnp.asarray(cts[1]),
             jnp.asarray(cts[2]) if disp else None,
             jnp.asarray(cts[3]) if loop else None,
             {k: jnp.asarray(g_regs[i]) for i, k in enumerate(names)
              if k in jout[4]})
    jg_feats, jg_mask = (np.asarray(g) for g in vjp(j_cts))

    tf = torch.tensor(feats, requires_grad=True)
    tm = torch.tensor(mask, requires_grad=True) if loop else None
    out, asum, dsp, lab, regs = TF.fused_composite_s1(
        TF.FusedS1Cfg(**kw), tf, torch.from_numpy(valid), tm,
        torch.from_numpy(dinv) if disp else None)
    assert set(regs) == set(jout[4])
    for a, b in ((out, jout[0]), (asum, jout[1]), (dsp, jout[2]),
                 (lab, jout[3])):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-5
    for k in regs:
        np.testing.assert_allclose(float(regs[k].detach()), float(jout[4][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    total = (out * torch.from_numpy(cts[0])).sum() \
        + (asum * torch.from_numpy(cts[1])).sum()
    if disp:
        total = total + (dsp * torch.from_numpy(cts[2])).sum()
    if loop:
        total = total + (lab * torch.from_numpy(cts[3])).sum()
    for i, k in enumerate(names):
        if k in regs:
            total = total + regs[k] * float(g_regs[i])
    total.backward()
    g = tf.grad.numpy()
    assert np.abs(g - jg_feats).max() <= 1e-5 * np.abs(jg_feats).max()
    if loop:
        gm = tm.grad.numpy()
        assert np.abs(gm - jg_mask).max() <= 1e-5 * np.abs(jg_mask).max()


def test_fused_s1_plain_backward_is_the_autograd_gradient():
    """The plain backward (a transcription of the JAX VJP) equals
    autograd through the plain forward, to 1e-5 * max|g|."""
    feats, valid, mask, dinv, cts, g_regs = _fused_inputs(2, seed=4)
    cfg = TF.FusedS1Cfg(5, True, True, True, True, True, True)
    f = torch.tensor(feats, requires_grad=True)
    m = torch.tensor(mask, requires_grad=True)
    outs = TF.fused_composite_s1_plain_fwd(cfg, f, torch.from_numpy(valid),
                                           m, torch.from_numpy(dinv))
    # the label composite's alpha is detached: autograd must not see it,
    # so take the label's gradient path through the mask only
    total = sum((o * torch.from_numpy(c)).sum()
                for o, c in zip(outs[:3], cts[:3]))
    total = total + (outs[4] * torch.from_numpy(g_regs)).sum()
    ga, = torch.autograd.grad(total, f)
    d_feats, _ = TF.fused_composite_s1_plain_bwd(
        cfg, f.detach(), torch.from_numpy(valid), m.detach(),
        torch.from_numpy(dinv), *(torch.from_numpy(c) for c in cts[:3]),
        torch.zeros((2, 9, 11, 1)), torch.from_numpy(g_regs))
    assert (d_feats - ga).abs().max() <= 1e-5 * ga.abs().max()


def _same_bits(a, b):
    """a and b (numpy f32) NaN at the same places and bit for bit equal
    elsewhere."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    assert np.array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a[~nan].view(np.int32),
                                  b[~nan].view(np.int32))


def emulate_k8(cfg, feats, valid, mask, dinv, g_out, g_asum, g_disp,
               g_label, g_regs):
    """fused_s1_bwd_tile_kernel on the host, its plan in its order: a
    block a pixel tile (`render/fused_s1.py:fused_s1_bwd_layout`) of one
    b; pass A near -> far decodes each own pixel's alpha once a plane into
    T_in (a [D][tile] table) and the sparsity sums; pass B far -> near
    decodes each (plane, tile or halo pixel inside the patch) once into a
    staged table (r, g, b, a and the loop probability; a pixel's thread
    decodes its own and keeps its sigmoids, validity and loop sigmoid, the
    ring warps the rest of the halo), then runs each own pixel's
    dT chain reading its neighbours from the table where the patch's
    has_l/r/u/d edges allow, each step rounded once as the kernel does.
    The card's sigmoid_f is taken from one torch.sigmoid of each plane,
    as the plain version computes it (the host's vectorized sigmoid
    rounds some elements differently by their place in the vector).
    Returns (d_feats, d_mask or None, decodes): decodes[p, b, s, y, x]
    counts pass p's decodes of (b, plane s, pixel (y, x)) per tile, summed
    over the tiles that stage it."""
    B, D, h, w, _ = feats.shape
    lay = TF.fused_s1_bwd_layout(D)
    TW, TH = lay["tile_w"], lay["tile_h"]
    assert lay["halo"] == (TW + 2) * (TH + 2)
    assert lay["threads"] == TW * TH + 64     # two warps for the ring
    n = TF._norms(cfg, B, D, h, w)
    sig = torch.stack([torch.sigmoid(feats[:, s].float()) for s in range(D)],
                      1)
    lsig = torch.stack([torch.sigmoid(mask[:, s]) for s in range(D)], 1) \
        if cfg.use_loop else None
    rgb_smooth, a_smooth = cfg.use_rgb_smooth, cfg.use_a_smooth
    l_smooth = cfg.use_loop and cfg.use_l_smooth
    stage = rgb_smooth or a_smooth or l_smooth
    zero = torch.zeros(())
    g_rs_dx = g_regs[1] / n["n_rgb_dx"] if rgb_smooth else zero
    g_rs_dy = g_regs[1] / n["n_rgb_dy"] if rgb_smooth else zero
    g_as_dx = g_regs[2] / n["n_dx"] if a_smooth else zero
    g_as_dy = g_regs[2] / n["n_dy"] if a_smooth else zero
    g_ls_dx = g_regs[3] / n["n_dx"] if l_smooth else zero
    g_ls_dy = g_regs[3] / n["n_dy"] if l_smooth else zero
    d_feats = torch.full(feats.shape, float("nan"))
    d_mask = torch.full(valid.shape, float("nan")) if cfg.use_loop else None
    decodes = np.zeros((2, B, D, h, w), np.int64)

    def smooth(x, nb, has, g_dx, g_dy):
        """csrc/fused_s1.cu:smooth_grad on a tile's own pixels."""
        (xl, xr, xu, xd), (hl, hr, hu, hd) = nb, has
        sw = (torch.where(hl, torch.sign(x - xl), 0.0)
              - torch.where(hr, torch.sign(xr - x), 0.0))
        sh = (torch.where(hu, torch.sign(x - xu), 0.0)
              - torch.where(hd, torch.sign(xd - x), 0.0))
        return g_dx * sw + g_dy * sh

    for b in range(B):
        for i0 in range(0, h, TH):
            for j0 in range(0, w, TW):
                i1, j1 = min(i0 + TH, h), min(j0 + TW, w)
                own = (b, slice(i0, i1), slice(j0, j1))
                # pass A: own pixels only
                T = torch.ones((i1 - i0, j1 - j0))
                l1, l2 = torch.zeros_like(T), torch.zeros_like(T)
                t_in = torch.full((D,) + T.shape, float("nan"))
                for s in range(D - 1, -1, -1):
                    a = torch.where(valid[b, s, i0:i1, j0:j1],
                                    sig[b, s, i0:i1, j0:j1, 3], 0.0)
                    decodes[0, b, s, i0:i1, j0:j1] += 1
                    t_in[s] = T
                    T = T * (1.0 - a)
                    if cfg.use_sparsity:
                        l1 = l1 + torch.abs(a)
                        l2 = l2 + a * a
                if cfg.use_sparsity:
                    l2r = torch.sqrt(l2)
                    l2c = l2r.clamp(min=cfg.sp_eps)
                    scale = g_regs[0] / (n["n_pix"] * n["sqrt_planes"])
                    a_coef = scale / l2c
                    b_coef = torch.where(
                        l2r >= cfg.sp_eps,
                        scale * l1 / (l2c * l2c * l2r.clamp(min=cfg.sp_eps)),
                        0.0)
                go = g_out[own]
                ga = g_asum[own]
                # the halo: rows i0 - 1 .. i0 + TH, columns j0 - 1 .. j0 + TW
                hi0, hj0 = max(i0 - 1, 0), max(j0 - 1, 0)
                hi1, hj1 = min(i0 + TH + 1, h), min(j0 + TW + 1, w)
                ii = torch.arange(i0, i1)[:, None]
                jj = torch.arange(j0, j1)[None, :]
                has = (jj > 0, jj + 1 < w, ii > 0, ii + 1 < h)
                has = tuple(x.expand(T.shape) for x in has)
                dT = torch.zeros_like(T)
                for s in range(D):
                    # the staged plane: tile and halo, NaN where nothing
                    # is decoded (outside the patch)
                    st = torch.full((TH + 2, TW + 2, 5), float("nan"))
                    rows = slice(hi0, hi1) if stage else slice(i0, i1)
                    cols = slice(hj0, hj1) if stage else slice(j0, j1)
                    v = valid[b, s, rows, cols]
                    sg = sig[b, s, rows, cols]
                    vm = v.float()
                    dec = torch.cat([sg[..., :3] * vm[..., None],
                                     torch.where(v, sg[..., 3], 0.0)[
                                         ..., None]], -1)
                    lp = torch.where(v, lsig[b, s, rows, cols], 0.0) \
                        if cfg.use_loop else torch.zeros_like(vm)
                    st[rows.start - i0 + 1:rows.stop - i0 + 1,
                       cols.start - j0 + 1:cols.stop - j0 + 1] = torch.cat(
                        [dec, lp[..., None]], -1)
                    decodes[1, b, s, rows, cols] += 1
                    yo, xo = slice(1, i1 - i0 + 1), slice(1, j1 - j0 + 1)
                    c = st[yo, xo]
                    cs = sig[b, s, i0:i1, j0:j1]
                    cv = valid[b, s, i0:i1, j0:j1]
                    cvm = cv.float()
                    r, g, bl, a = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
                    g_i = ((r * go[..., 0] + g * go[..., 1])
                           + bl * go[..., 2]) + ga
                    if cfg.want_disp:
                        g_i = g_i + dinv[b, s, i0:i1, j0:j1] * g_disp[own]
                    tin = t_in[s]
                    bw = a * tin
                    da = tin * (g_i - dT)
                    dT = a * g_i + (1.0 - a) * dT
                    drgb = bw[..., None] * go
                    if cfg.use_sparsity:
                        da = da + a_coef * torch.sign(a) - b_coef * a
                    nb = [st[1:i1 - i0 + 1, 0:j1 - j0],
                          st[1:i1 - i0 + 1, 2:j1 - j0 + 2],
                          st[0:i1 - i0, 1:j1 - j0 + 1],
                          st[2:i1 - i0 + 2, 1:j1 - j0 + 1]]
                    if rgb_smooth:
                        drgb = drgb + torch.stack(
                            [smooth(c[..., q], [x[..., q] for x in nb], has,
                                    g_rs_dx, g_rs_dy) for q in range(3)], -1)
                    if a_smooth:
                        da = da + smooth(a, [x[..., 3] for x in nb], has,
                                         g_as_dx, g_as_dy)
                    d_feats[b, s, i0:i1, j0:j1] = torch.cat([
                        drgb * cvm[..., None]
                        * (cs[..., :3] * (1.0 - cs[..., :3])),
                        (torch.where(cv, da, 0.0) * cs[..., 3]
                         * (1.0 - cs[..., 3]))[..., None]], -1)
                    if cfg.use_loop:
                        ls = lsig[b, s, i0:i1, j0:j1]
                        d_lp = g_label[own][..., 0] * bw
                        if l_smooth:
                            d_lp = d_lp + smooth(
                                c[..., 4], [x[..., 4] for x in nb], has,
                                g_ls_dx, g_ls_dy)
                        d_mask[b, s, i0:i1, j0:j1] = \
                            torch.where(cv, d_lp, 0.0) * ls * (1.0 - ls)
    return d_feats, d_mask, decodes


def _k8_inputs(B, D, h, w, seed, ties):
    """`_fused_inputs` at any D, h and w; with ties, equal neighbours
    along w and h (sign(0) = 0), across the tiles' seams too.  Saturated
    alphas (1 - alpha = 0) on the last plane."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, D, h, w, 4)).astype(np.float32) * 2
    valid = rng.random((B, D, h, w)) < 0.75
    mask = rng.standard_normal((B, D, h, w)).astype(np.float32)
    if ties:
        for x in (feats, mask):
            x[:, :, :, 3::8] = x[:, :, :, 2::8][:, :, :, :x[
                :, :, :, 3::8].shape[3]]
            x[:, :, 8::8] = x[:, :, 7::8][:, :, :x[:, :, 8::8].shape[2]]
    feats[:, -1, :2, :3, 3] = 40.0
    dinv = rng.random((B, D, h, w)).astype(np.float32) * valid
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((B, h, w, 3), (B, h, w), (B, h, w), (B, h, w, 1))]
    g_regs = rng.standard_normal(4).astype(np.float32)
    return feats, valid, mask, dinv, cts, g_regs


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
@pytest.mark.parametrize("h,w,D", [(9, 11, 1), (9, 11, 5), (1, 7, 1),
                                   (1, 7, 5), (19, 37, 5)])
def test_fused_s1_bwd_tile_emulated(h, w, D, flags, B):
    """K8's redesign emulated on the host (pixel tiles with a one-pixel
    halo, each plane decoded once a pass into a staged table, T_in from a
    table, the serial dT chain): bit-equal to the plain version
    (`fused_composite_s1_plain_bwd`; NaNs at the same places: at h = 1 the
    smoothness terms divide by h - 1 = 0, in JAX too) with and without
    equal neighbours, within 1e-5 * max|g| of JAX's _fused_s1_bwd
    (through jax.vjp) without them, and each (plane,
    pixel) decoded exactly once in pass A by its tile and once in pass B
    by each tile whose tile or halo holds it (only its own where no
    smoothness term stages neighbours)."""
    sp, rs, as_, ls, loop, disp = FLAG_SETS[flags]
    kw = dict(n_planes=D, use_sparsity=sp, use_rgb_smooth=rs,
              use_a_smooth=as_, use_l_smooth=ls, use_loop=loop,
              want_disp=disp)
    cfg = TF.FusedS1Cfg(**kw)
    for ties in (True, False):
        feats, valid, mask, dinv, cts, g_regs = _k8_inputs(B, D, h, w,
                                                           7 + B, ties)
        tin = [torch.from_numpy(a) for a in (feats, valid, mask, dinv)]
        tct = [torch.from_numpy(a) for a in cts] + [torch.from_numpy(g_regs)]
        got_f, got_m, decodes = emulate_k8(cfg, *tin, *tct)
        want_f, want_m = TF.fused_composite_s1_plain_bwd(cfg, *tin, *tct)
        _same_bits(got_f.numpy(), want_f.numpy())
        assert (got_m is None) == (want_m is None) == (not loop)
        if loop:
            _same_bits(got_m.numpy(), want_m.numpy())
    # decodes: once a pass by the owning tile; pass B also by the tiles
    # whose halo holds the pixel where a smoothness term stages it
    assert (decodes[0] == 1).all()
    stage = rs or as_ or (loop and ls)
    lay = TF.fused_s1_bwd_layout(D)
    TW, TH = lay["tile_w"], lay["tile_h"]
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    tiles_h = ((ii % TH == 0) & (ii > 0)) | ((ii % TH == TH - 1)
                                             & (ii + 1 < h))
    tiles_w = ((jj % TW == 0) & (jj > 0)) | ((jj % TW == TW - 1)
                                             & (jj + 1 < w))
    want = (1 + tiles_h + tiles_w + (tiles_h & tiles_w)) if stage \
        else np.ones((h, w), np.int64)
    assert (decodes[1] == np.broadcast_to(want, decodes[1].shape)).all()
    # JAX's VJP on the inputs without ties (XLA's vectorized sigmoid, like
    # torch's, rounds some elements by their place, which can break a tie)
    jcfg = JF.FusedS1Cfg(**kw)
    dummy = np.zeros((1, 1, 1, 1), np.float32)

    def jfn(f, m):
        return JF.fused_composite_s1(jcfg, f, jnp.asarray(valid), m,
                                     jnp.asarray(dinv if disp else dummy))

    jout, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(feats),
                        jnp.asarray(mask if loop else dummy))
    j_cts = (jnp.asarray(cts[0]), jnp.asarray(cts[1]),
             jnp.asarray(cts[2]) if disp else None,
             jnp.asarray(cts[3]) if loop else None,
             {k: jnp.asarray(g_regs[i]) for i, k in enumerate(TF.REG_NAMES)
              if k in jout[4]})
    for got, want in zip((got_f, got_m), vjp(j_cts)):
        if got is None:
            continue
        got, want = got.numpy(), np.asarray(want)
        nan = np.isnan(want)
        assert np.array_equal(np.isnan(got), nan)
        if (~nan).any():
            scale = np.abs(want[~nan]).max()
            assert np.abs(got[~nan] - want[~nan]).max() <= 1e-5 * scale


@pytest.mark.parametrize("D,smem", [(1, 7712), (5, 9760), (32, 23584),
                                    (128, 72736)])
def test_fused_s1_bwd_layout(D, smem):
    """K8's layout (mirrored by the kernel's vl3d_fused_s1_bwd_layout,
    checked on the card): 16 x 8 pixels a block with an 18 x 10 halo whose
    52 ring pixels take two more warps, two staged planes and T_in
    [D][128] in shared memory, D = 128 within the H100's 227 KB a block;
    D < 1 and D > 128 raise, in the wrapper too."""
    lay = TF.fused_s1_bwd_layout(D)
    assert tuple(lay) == TF.FUSED_S1_BWD_LAYOUT_KEYS
    assert lay == dict(tile_w=16, tile_h=8, halo=180, threads=192, smem=smem)
    assert smem <= 227 * 1024


@pytest.mark.parametrize("D", [0, 129])
def test_fused_s1_bwd_layout_limits(D):
    with pytest.raises(ValueError, match="planes"):
        TF.fused_s1_bwd_layout(D)


def _reduce_first(pix, cfg, B, D, h, w):
    """K7's scalars from the pixels' seven sums (7, B h w) f32 in the first
    design's order (csrc/fused_s1.cu): 256-pixel runs of the flat (b, i,
    j) order reduced by a tree (the last run's missing pixels as its idle
    threads' zeros), then fused_s1_reduce_kernel: thread t adds the runs
    t, t + 256, ... in order, a tree over the 256 threads, the four
    divisions; every step in f32."""
    n = pix.shape[1]
    nb = -(-n // 256)
    red = np.zeros((7, nb * 256), np.float32)
    red[:, :n] = pix
    red = red.reshape(7, nb, 256)
    half = 128
    while half:
        red[..., :half] = red[..., :half] + red[..., half:2 * half]
        half //= 2
    parts = red[..., 0]                                   # (7, nb)
    acc = np.zeros((7, 256), np.float32)
    for blk in range(nb):
        acc[:, blk % 256] = acc[:, blk % 256] + parts[:, blk]
    half = 128
    while half:
        acc[:, :half] = acc[:, :half] + acc[:, half:2 * half]
        half //= 2
    r = acc[:, 0]
    nm = {k: np.float32(v) for k, v in TF._norms(cfg, B, D, h, w).items()}
    with np.errstate(divide="ignore", invalid="ignore"):   # h or w of 1
        return np.array([
            (r[0] / nm["n_pix"]) / nm["sqrt_planes"],
            r[1] / nm["n_rgb_dx"] + r[2] / nm["n_rgb_dy"],
            r[3] / nm["n_dx"] + r[4] / nm["n_dy"],
            r[5] / nm["n_dx"] + r[6] / nm["n_dy"]], np.float32)


def _plane_sigmoids(feats, mask, cfg):
    """The card's sigmoid_f taken from one torch.sigmoid of each plane, as
    the plain version computes it (see `emulate_k8`)."""
    D = feats.shape[1]
    sig = torch.stack([torch.sigmoid(feats[:, s].float()) for s in range(D)],
                      1)
    lsig = torch.stack([torch.sigmoid(mask[:, s]) for s in range(D)], 1) \
        if cfg.use_loop else None
    return sig, lsig


def _abs_diff_sums(n, c):
    """The kernels' rgb and alpha terms of one neighbour: (|dr| + |dg|) +
    |db| and |da| (each (..., 4) of decoded r, g, b, a)."""
    d = torch.abs(n - c)
    return (d[..., 0] + d[..., 1]) + d[..., 2], d[..., 3]


def _first_pixel_sums(cfg, feats, valid, mask):
    """The first design's seven sums a pixel (fused_s1_fwd_kernel: every
    neighbour decoded again from its features), on whole planes, (7, B h
    w) f32."""
    B, D, h, w, _ = feats.shape
    sig, lsig = _plane_sigmoids(feats, mask, cfg)
    smooth = cfg.use_rgb_smooth or cfg.use_a_smooth
    l_smooth = cfg.use_loop and cfg.use_l_smooth
    sums = torch.zeros((7, B, h, w))
    l1, l2 = torch.zeros((B, h, w)), torch.zeros((B, h, w))
    for s in range(D - 1, -1, -1):
        v = valid[:, s]
        dec = torch.cat([sig[:, s, ..., :3] * v[..., None].float(),
                         torch.where(v, sig[:, s, ..., 3], 0.0)[..., None]],
                        -1)
        if l_smooth:
            lp = torch.where(v, lsig[:, s], 0.0)
            sums[5, :, :, :-1] += torch.abs(lp[:, :, 1:] - lp[:, :, :-1])
            sums[6, :, :-1] += torch.abs(lp[:, 1:] - lp[:, :-1])
        a = dec[..., 3]
        if cfg.use_sparsity:
            l1 = l1 + torch.abs(a)
            l2 = l2 + a * a
        if smooth:
            rgb, al = _abs_diff_sums(dec[:, :, 1:], dec[:, :, :-1])
            sums[1, :, :, :-1] += rgb
            sums[3, :, :, :-1] += al
            rgb, al = _abs_diff_sums(dec[:, 1:], dec[:, :-1])
            sums[2, :, :-1] += rgb
            sums[4, :, :-1] += al
    if cfg.use_sparsity:
        sums[0] = l1 / torch.sqrt(l2).clamp(min=cfg.sp_eps)
    return sums.reshape(7, -1).numpy()


def emulate_k7(cfg, feats, valid, mask, dinv):
    """fused_s1_fwd_tile_kernel on the host, its plan in its order: a
    block a pixel tile (`render/fused_s1.py:fused_s1_fwd_layout`) of one
    b, planes near -> far; each plane's tile and its one-sided halo (the
    column to the right and the row below, inside the patch) decoded once
    into a staged table (r, g, b, a and the loop probability; the own
    pixels by their threads, the halo by the ring warp) where a smoothness
    term reads neighbours, then each own pixel's chain reading its right
    and lower neighbours from the table where the patch's has_r/has_d
    edges allow, each step rounded once as the kernel does; each pixel's
    seven sums, then `_reduce_first`.  Returns ((out, asum, disp, label,
    regs), pixel sums (7, B h w), decodes (B, D, h, w): the (plane,
    pixel)'s decodes summed over the tiles that stage it)."""
    B, D, h, w, _ = feats.shape
    lay = TF.fused_s1_fwd_layout(D)
    TW, TH = lay["tile_w"], lay["tile_h"]
    assert lay["halo"] == (TW + 1) * (TH + 1)
    assert lay["threads"] == TW * TH + 32     # one warp for the ring
    sig, lsig = _plane_sigmoids(feats, mask, cfg)
    smooth = cfg.use_rgb_smooth or cfg.use_a_smooth
    l_smooth = cfg.use_loop and cfg.use_l_smooth
    stage = smooth or l_smooth
    nan = float("nan")
    out = torch.full((B, h, w, 3), nan)
    asum, disp, label = (torch.full((B, h, w), nan) for _ in range(3))
    pix = torch.full((7, B, h, w), nan)
    decodes = np.zeros((B, D, h, w), np.int64)
    for b in range(B):
        for i0 in range(0, h, TH):
            for j0 in range(0, w, TW):
                i1, j1 = min(i0 + TH, h), min(j0 + TW, w)
                th, tw = i1 - i0, j1 - j0
                T = torch.ones((th, tw))
                o = torch.zeros((th, tw, 3))
                acc = {k: torch.zeros((th, tw))
                       for k in ("as", "dsp", "lab", "l1", "l2")}
                sums = torch.zeros((7, th, tw))
                ii = torch.arange(i0, i1)[:, None].expand(th, tw)
                jj = torch.arange(j0, j1)[None, :].expand(th, tw)
                has_r, has_d = jj + 1 < w, ii + 1 < h
                for s in range(D - 1, -1, -1):
                    # the staged plane: tile, right column, row below; NaN
                    # where nothing is decoded
                    st = torch.full((TH + 1, TW + 1, 5), nan)
                    spans = [(slice(i0, i1), slice(j0, j1))]
                    if stage and j1 < w and j1 == j0 + TW:
                        spans.append((slice(i0, i1), slice(j1, j1 + 1)))
                    if stage and i1 < h and i1 == i0 + TH:
                        spans.append((slice(i1, i1 + 1), slice(j0, j1)))
                    for rows, cols in spans:
                        v = valid[b, s, rows, cols]
                        sg = sig[b, s, rows, cols]
                        dec = torch.cat([
                            sg[..., :3] * v[..., None].float(),
                            torch.where(v, sg[..., 3], 0.0)[..., None],
                            (torch.where(v, lsig[b, s, rows, cols], 0.0)
                             if cfg.use_loop else torch.zeros(v.shape))[
                                ..., None]], -1)
                        st[rows.start - i0:rows.stop - i0,
                           cols.start - j0:cols.stop - j0] = dec
                        decodes[b, s, rows, cols] += 1
                    c = st[:th, :tw]
                    a = c[..., 3]
                    bw = a * T
                    o = o + c[..., :3] * bw[..., None]
                    acc["as"] = acc["as"] + bw
                    if cfg.want_disp:
                        acc["dsp"] = acc["dsp"] + dinv[b, s, i0:i1, j0:j1] \
                            * bw
                    if cfg.use_loop:
                        lp = c[..., 4]
                        acc["lab"] = acc["lab"] + lp * bw
                        if l_smooth:
                            sums[5] = torch.where(has_r, sums[5] + torch.abs(
                                st[:th, 1:tw + 1, 4] - lp), sums[5])
                            sums[6] = torch.where(has_d, sums[6] + torch.abs(
                                st[1:th + 1, :tw, 4] - lp), sums[6])
                    T = T * (1.0 - a)
                    if cfg.use_sparsity:
                        acc["l1"] = acc["l1"] + torch.abs(a)
                        acc["l2"] = acc["l2"] + a * a
                    if smooth:
                        for k, nb, has in ((1, st[:th, 1:tw + 1], has_r),
                                           (2, st[1:th + 1, :tw], has_d)):
                            rgb, al = _abs_diff_sums(nb[..., :4], c[..., :4])
                            sums[k] = torch.where(has, sums[k] + rgb,
                                                  sums[k])
                            sums[k + 2] = torch.where(has, sums[k + 2] + al,
                                                      sums[k + 2])
                if cfg.use_sparsity:
                    sums[0] = acc["l1"] / torch.sqrt(acc["l2"]).clamp(
                        min=cfg.sp_eps)
                own = (b, slice(i0, i1), slice(j0, j1))
                out[own] = o
                asum[own], disp[own], label[own] = (acc["as"], acc["dsp"],
                                                    acc["lab"])
                pix[:, b, i0:i1, j0:j1] = sums
    pix = pix.reshape(7, -1).numpy()
    regs = torch.from_numpy(_reduce_first(pix, cfg, B, D, h, w))
    return (out, asum, disp, label[..., None], regs), pix, decodes


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
@pytest.mark.parametrize("h,w,D", [(9, 11, 1), (9, 11, 5), (1, 7, 5),
                                   (19, 37, 5)])
def test_fused_s1_fwd_tile_emulated(h, w, D, flags, B):
    """K7's redesign emulated on the host (pixel tiles with the one-sided
    halo, each plane decoded once into a staged table, the chains near ->
    far, each pixel's sums reduced by the first design's 256-pixel tree):
    out, asum, disp and label bit-equal to the plain version
    (`fused_composite_s1_plain_fwd`; NaNs at the same places), the pixels'
    sums and the four scalars bit-equal to the first design's (every
    neighbour decoded again, whole planes) through the same reduction,
    with and without equal neighbours; each (plane, pixel) decoded once by
    its tile and once more by each tile whose halo holds it (only its own
    where no smoothness term stages neighbours); everything within 1e-5
    (the scalars 1e-5 relative) of JAX's fused_composite_s1."""
    sp, rs, as_, ls, loop, disp = FLAG_SETS[flags]
    kw = dict(n_planes=D, use_sparsity=sp, use_rgb_smooth=rs,
              use_a_smooth=as_, use_l_smooth=ls, use_loop=loop,
              want_disp=disp)
    cfg = TF.FusedS1Cfg(**kw)
    for ties in (True, False):
        feats, valid, mask, dinv, _, _ = _k8_inputs(B, D, h, w, 3 + B, ties)
        tin = [torch.from_numpy(a) for a in (feats, valid, mask, dinv)]
        got, pix, decodes = emulate_k7(cfg, *tin)
        want = TF.fused_composite_s1_plain_fwd(cfg, *tin)
        for a, b in zip(got[:4], want[:4]):
            _same_bits(a.numpy(), b.numpy())
        first = _first_pixel_sums(cfg, *tin[:3])
        _same_bits(pix, first)
        _same_bits(got[4].numpy(), _reduce_first(first, cfg, B, D, h, w))
    stage = rs or as_ or (loop and ls)
    lay = TF.fused_s1_fwd_layout(D)
    TW, TH = lay["tile_w"], lay["tile_h"]
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    want_dec = (1 + ((jj % TW == 0) & (jj > 0)) + ((ii % TH == 0) & (ii > 0))
                ) if stage else np.ones((h, w), np.int64)
    assert (decodes == np.broadcast_to(want_dec, decodes.shape)).all()
    jcfg = JF.FusedS1Cfg(**kw)
    dummy = np.zeros((1, 1, 1, 1), np.float32)
    jout = JF.fused_composite_s1(jcfg, jnp.asarray(feats), jnp.asarray(valid),
                                 jnp.asarray(mask if loop else dummy),
                                 jnp.asarray(dinv if disp else dummy))
    for a, b in zip(got[:4], jout[:4]):
        if b is None:
            continue
        a, b = a.numpy(), np.asarray(b)
        nan = np.isnan(b)
        assert np.array_equal(np.isnan(a), nan)
        assert np.abs(a[~nan] - b[~nan]).max(initial=0.0) <= 1e-5
    for i, k in enumerate(TF.REG_NAMES):
        if k in jout[4]:
            want_k = float(jout[4][k])
            if np.isnan(want_k):
                assert np.isnan(float(got[4][i]))
            else:
                np.testing.assert_allclose(float(got[4][i]), want_k,
                                           rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("D", [1, 5, 32, 128, 2048])
def test_fused_s1_fwd_layout(D):
    """K7's layout (mirrored by the kernel's vl3d_fused_s1_fwd_layout,
    checked on the card): K8's 16 x 8 pixels a block, the tile with the
    column to its right and the row below it staged (17 x 9 entries),
    whose 24 ring pixels take one more warp, two buffers of two staged
    planes in shared memory whatever D (no per-plane state)."""
    lay = TF.fused_s1_fwd_layout(D)
    assert tuple(lay) == TF.FUSED_S1_FWD_LAYOUT_KEYS
    assert lay == dict(tile_w=16, tile_h=8, halo=153, threads=160,
                       smem=12240)
    assert (lay["tile_w"], lay["tile_h"]) == (
        TF.fused_s1_bwd_layout(1)["tile_w"],
        TF.fused_s1_bwd_layout(1)["tile_h"])


@pytest.mark.parametrize("D", [0, -3])
def test_fused_s1_fwd_layout_limits(D):
    """K7 refuses fewer than one plane, in the wrapper too; it has no upper
    plane limit (K8's 128 is its T_in table's)."""
    with pytest.raises(ValueError, match="plane"):
        TF.fused_s1_fwd_layout(D)
