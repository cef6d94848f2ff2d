"""`jnp.clip`'s tie rule at the port's differentiable clips, against the
JAX package on the CPU.

``jax.grad(lambda x: jnp.clip(x, 0., None))(0.)`` is 0.5 (``maximum``
and ``minimum`` split a tie evenly) where ``torch.clamp``'s derivative is
1.  `videoloop3d_torch.core.activations.clip` takes JAX's rule; each site
that JAX writes with ``jnp.clip`` goes through it, and each test below
drives one site at exact ties (inputs on binary grids, so both packages
hit the bound bit for bit) and holds the port's gradients to
``jax.grad`` of the JAX function on the same numpy inputs (1e-5 * max|g|).
"""
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.losses import regularizers as JR
from videoloop3d_tpu.models import mpmesh as JMM
from videoloop3d_tpu.render import fused_s1 as JFS1
from videoloop3d_tpu.render import renderer as JREN
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_torch.core.activations import clip
from videoloop3d_torch.losses import regularizers as TR
from videoloop3d_torch.models import mpmesh as TMM
from videoloop3d_torch.render import renderer as TREN
from videoloop3d_torch.train import stage1 as TS1


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30), \
        (np.abs(a - b).max(), np.abs(b).max())


def _torch_grads(fn, *arrays):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return float(out.detach()), [t.grad.numpy() for t in ts]


def _jax_grads(fn, *arrays):
    out, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return float(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("lo, hi", [(0.0, None), (None, 1.0), (1e-6, None),
                                    (None, 0.999), (0.001, 0.999)])
def test_one_sided_clip_matches_jax(lo, hi):
    """`clip` with one or both bounds: values and gradients of
    ``jnp.clip(x, lo, hi)``, 0.5 at a bound, on normal draws and on the
    bounds themselves."""
    x = np.random.default_rng(0).normal(0, 1, 200).astype(np.float32)
    bounds = [b for b in (lo, hi) if b is not None]
    x = np.concatenate([x, np.float32(bounds), np.float32([0.0, 1.0])])
    g = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)
    jv, vjp = jax.vjp(lambda v: jnp.clip(v, lo, hi), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = clip(t, lo, hi)
    tv.backward(torch.from_numpy(g))
    _close(tv.detach().numpy(), jv)
    _close(t.grad.numpy(), jg)
    k = len(bounds)
    np.testing.assert_array_equal(t.grad.numpy()[-2 - k:-2],
                                  0.5 * g[-2 - k:-2])


def test_sparsity_loss_tie_matches_jax():
    """regularizers.sparsity_loss's L2 floor (JAX ``jnp.clip(l2, eps,
    None)``): pixels whose plane stack has L2 exactly eps (0.5 on each of
    4 planes: L2 1.0 = eps), above and below it."""
    rng = np.random.default_rng(2)
    alpha = rng.integers(0, 5, (2, 4, 6, 5)).astype(np.float32) / 8
    alpha[:, :, :3, :] = 0.5                    # L2 exactly 1.0
    alpha[:, :, 3, :2] = 0.125                  # L2 0.25, below the floor
    tv, (tg,) = _torch_grads(
        lambda a: TR.sparsity_loss(a, 4, eps=1.0, plane_axis=1), alpha)
    jv, (jg,) = _jax_grads(
        lambda a: JR.sparsity_loss(a, 4, eps=1.0, plane_axis=1), alpha)
    _close(tv, jv)
    _close(tg, jg)


def test_depth_smooth_edge_tie_matches_jax():
    """regularizers.depth_smooth_loss's edge weight (JAX ``jnp.clip(1 -
    4 (ex + ey), 0, None)``): rgb on a 1/16 grid, so many pixels have
    ex + ey exactly 1/4 and a weight of exactly 0; the rgb gradient there
    is half of torch.clamp's."""
    rng = np.random.default_rng(3)
    disp = rng.normal(0, 1, (2, 7, 9)).astype(np.float32)
    rgb = rng.integers(0, 3, (2, 7, 9, 3)).astype(np.float32) / 16
    rgb[0, :, :, 1:] = 0.0
    rgb[0, :, :, 0] = np.arange(9, dtype=np.float32) / 8   # ex = 1/8
    rgb[0, :, :, 0] += np.arange(7, dtype=np.float32)[:, None] / 8
    tv, tg = _torch_grads(lambda d, c: TR.depth_smooth_loss(d, c), disp, rgb)
    jv, jg = _jax_grads(lambda d, c: JR.depth_smooth_loss(d, c), disp, rgb)
    _close(tv, jv)
    for a, b in zip(tg, jg):
        _close(a, b)
    # image 0: ex + ey = 1/4 everywhere, every weight 0 at the bound
    assert np.abs(jg[1][0]).max() > 0


def test_loop_mask_bce_tie_matches_jax():
    """train/stage1.py's loop-mask BCE clip to [0.001, 0.999] (JAX
    ``jnp.clip``): the rendered loop channel exactly 0.001 and 0.999 on
    some pixels, through each package's stage-1 loss function with the
    render replaced by the given rgbl."""
    rng = np.random.default_rng(4)
    rgbl = rng.uniform(0, 1, (1, 6, 8, 4)).astype(np.float32)
    rgbl[0, :2, :, 3] = np.float32(0.001)
    rgbl[0, 2:4, :, 3] = np.float32(0.999)
    rgbl[0, 4, :4, 3] = 0.0
    rgb = rng.uniform(0, 1, (1, 6, 8, 3)).astype(np.float32)
    loop = (rng.uniform(0, 1, (1, 6, 8)) < 0.5).astype(np.float32)
    args = types.SimpleNamespace(scale_invariant=False)
    cfg = types.SimpleNamespace(learn_loop_mask=True)

    def fake(p_key):
        return types.SimpleNamespace(
            cfg=cfg, is_sparse=False,
            forward=lambda p, *a, **k: (p[p_key], {}))

    t_loss = TS1.make_stage1_loss_fn(fake("rgbl"), args, 6, 8)
    j_loss = JS1.make_stage1_loss_fn(fake("rgbl"), args, 6, 8)
    tv, (tg,) = _torch_grads(
        lambda r: t_loss({"rgbl": r}, {"extrin": None, "intrin": None,
                                       "rgb": torch.from_numpy(rgb),
                                       "loopmask": torch.from_numpy(loop)},
                         {})[0], rgbl)
    jv, (jg,) = _jax_grads(
        lambda r: j_loss({"rgbl": r}, {"extrin": None, "intrin": None,
                                       "rgb": jnp.asarray(rgb),
                                       "loopmask": jnp.asarray(loop)},
                         {}, None)[0], rgbl)
    _close(tv, jv)
    _close(tg, jg)


def test_normalized_disparity_tie_matches_jax():
    """renderer.normalized_disparity's alpha floor (JAX ``jnp.clip(sum,
    1e-10, None)``, ``--normalize_blendweight_fordepth``): pixels whose
    blend weights sum to exactly 1e-10."""
    rng = np.random.default_rng(5)
    D = 4
    zview = rng.uniform(1.5, 6.0, (1, D, 5, 6)).astype(np.float32)
    valid = rng.uniform(0, 1, (1, D, 5, 6)) < 0.9
    bw = rng.uniform(0, 0.3, (1, D, 5, 6)).astype(np.float32)
    bw[:, :, :2] = 0.0
    bw[:, 1, :2] = np.float32(1e-10)            # sums exactly 1e-10
    geom = types.SimpleNamespace(near=1.5, far=6.0)

    def coords(mod):
        return types.SimpleNamespace(valid=mod.asarray(valid),
                                     zview=mod.asarray(zview))
    tv, (tg,) = _torch_grads(
        lambda b: (TREN.normalized_disparity(
            geom, types.SimpleNamespace(valid=torch.from_numpy(valid),
                                        zview=torch.from_numpy(zview)),
            b, normalize_by_alpha=True) ** 2).sum(), bw)
    jv, (jg,) = _jax_grads(
        lambda b: (JREN.normalized_disparity(geom, coords(jnp), b,
                                             normalize_by_alpha=True)
                   ** 2).sum(), bw)
    _close(tv, jv)
    _close(tg, jg)


def test_fused_dense_disp_floor_tie_matches_jax(monkeypatch):
    """models/mpmesh.py's fused dense render: ``disp / clip(alpha_sum,
    1e-10)`` under ``--normalize_blendweight_fordepth`` (JAX
    ``jnp.clip(alpha_sum, 1e-10, None)``).  The fused composite of both
    packages is replaced by the same plain sums of the features (alpha_sum
    the sum of channel 3 over the planes, exactly 1e-10 on some pixels),
    so the test reaches the floor and nothing else of the kernel."""
    rng = np.random.default_rng(6)
    B, D, h, w = 1, 3, 4, 5
    feats = rng.uniform(0, 0.4, (B, D, h, w, 4)).astype(np.float32)
    feats[0, :, :2, :, 3] = 0.0
    feats[0, 1, :2, :, 3] = np.float32(1e-10)
    cot = rng.normal(0, 1, (B, h, w)).astype(np.float32)
    valid = np.ones((B, D, h, w), bool)
    zview = rng.uniform(1.5, 6.0, (B, D, h, w)).astype(np.float32)

    def stub(mod, cat):
        def fused(fcfg, f, valid, mf, dinv):
            s = f.sum(axis=1) if mod is jnp else f.sum(dim=1)
            zero = s[..., :1] * 0
            return (s[..., :3], s[..., 3], s[..., 0] * s[..., 1], zero,
                    cat([zero.reshape(-1)[:1]] * 4))
        return fused
    monkeypatch.setattr(TMM, "fused_composite_s1",
                        stub(torch, lambda v: torch.cat(v)))
    monkeypatch.setattr(JFS1, "fused_composite_s1",
                        stub(jnp, jnp.concatenate))
    cfg = types.SimpleNamespace(
        d_smooth_on=True, normalize_blendweight_fordepth=True,
        sparsity_on=False, rgb_smooth_on=False, a_smooth_on=False,
        l_smooth_on=False, sparsity_eps=1e-6, bg_color="")
    geom = types.SimpleNamespace(near=1.5, far=6.0, n_planes=D)
    t_self = types.SimpleNamespace(cfg=cfg, geom=geom,
                                   device=torch.device("cpu"))
    j_self = types.SimpleNamespace(geom=geom)

    def t_fn(f):
        c = types.SimpleNamespace(valid=torch.from_numpy(valid),
                                  zview=torch.from_numpy(zview))
        _, var = TMM.MPMesh._render_fused_dense(t_self, c, f, None, False,
                                                None)
        return (var["disp_norm"] * torch.from_numpy(cot)).sum()

    def j_fn(f):
        c = types.SimpleNamespace(valid=jnp.asarray(valid),
                                  zview=jnp.asarray(zview))
        _, var = JMM.MPMesh._render_fused_dense(j_self, None, cfg, c, f,
                                                None, False, None)
        return (var["disp_norm"] * jnp.asarray(cot)).sum()
    tv, (tg,) = _torch_grads(t_fn, feats)
    jv, (jg,) = _jax_grads(j_fn, feats)
    _close(tv, jv)
    _close(tg, jg)
