"""The stage-1 kernels' plain versions against the JAX package, on the CPU:
the dense sampler K5/K6 (`render/sample.py:sample_dense`) against JAX's
gather sampler under ``jax.grad`` and its block-adjoint sampler, and the
fused composite K7/K8 (`render/fused_s1.py`) against JAX's custom VJP.
Inputs are made with numpy and handed to both packages."""
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
