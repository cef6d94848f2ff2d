"""Vertex-geometry optimization (``--optimize_geo_start``) of the PyTorch
port against the JAX package, on the CPU: the vertex warp (K20/K21's
plain versions and the line-by-line plain warp) against JAX's
`warp_coordinates_verts` in values and the verts gradient, the crossing
guard, the samplers' coordinate gradients (K22/K23's plain versions)
against ``jax.grad`` of `bilinear_planes` and `bilinear_tiles`, one dense
geo step on each route and one sparse geo step against JAX's loss, the
vertex-recovery runs of JAX's tests, Adam's state for verts at the
event, the `train_3d` CLI through the event and the cull, the crossing
warning, and a flat `render_video` of a geo-trained checkpoint.  Inputs
are numpy from a seed, handed to both packages."""
import contextlib
import io
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_render_slice import _assert_u8_close, _read_frames
from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core.activations import ACTIVATIONS
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models import sparsify as JSP
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.render import geo_warp as JGW
from videoloop3d_tpu.render import sample as JS
from videoloop3d_tpu.tools import render_video as jrv
from videoloop3d_tpu.tools import train_3d as jax_train_3d
from videoloop3d_tpu.train import optimizer as JO
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models import sparsify as TSP
from videoloop3d_torch.models.mpmesh import MPMesh as TorchMPMesh
from videoloop3d_torch.render import geo_warp as TGW
from videoloop3d_torch.render import renderer as TR
from videoloop3d_torch.render import sample as TS
from videoloop3d_torch.tools import render_video as trv
from videoloop3d_torch.tools import train_3d
from videoloop3d_torch.train import optimizer as TO
from videoloop3d_torch.train import stage1 as TS1

CPU = torch.device("cpu")


def _models(normalize=False, loop_mask=False, h=36, w=48):
    """Both packages' MPMesh of JAX's tests/test_geo_warp.py (3 planes of
    5 x 7 vertices) and its three views."""
    argv = ["--mpi_h_scale", "1.3", "--mpi_w_scale", "1.3",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7",
            "--mpi_d", "3", "--atlas_grid_h", "1",
            "--rgb_smooth_loss_weight", "0"]
    argv += ["--normalize_verts"] if normalize else []
    argv += ["--learn_loop_mask"] if loop_mask else []
    focal = 0.8 * w
    intrin = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                      np.float32)
    jm = JaxMPMesh(jax_parse(argv), h, w, np.eye(4), intrin, 1.5, 6.0)
    tm = TorchMPMesh(torch_parse(argv), h, w, np.eye(4), intrin, 1.5, 6.0,
                     device=CPU)
    exts = []
    for off in (0.0, 0.12, -0.1):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = off
        e[1, 3] = off * 0.4
        exts.append(e)
    return jm, tm, np.stack(exts), np.repeat(intrin[None], 3, axis=0)


def _perturb(geom, verts, frac, seed=3, normalize=False):
    """In-plane jiggle of every vertex by up to frac/2 of a quad (JAX's
    tests/test_geo_warp.py), in the parameterization of verts."""
    rng = np.random.default_rng(seed)
    D = geom.n_planes
    depths = geom.depths_np()
    v = verts.reshape(D, -1, 3).copy()
    if normalize:
        v = v * depths[:, None, None]
    span = min((geom.mpi_h - 1) / geom.n_tiles_h,
               (geom.mpi_w - 1) / geom.n_tiles_w)
    focal = geom.ref_intrin_mpi_np()[0, 0]
    scale_px = depths / focal
    v[..., :2] += (rng.random(v[..., :2].shape) - 0.5) * (frac * span) \
        * scale_px[:, None, None]
    if normalize:
        v = v / depths[:, None, None]
    return v.reshape(-1, 3).astype(np.float32)


def _jax_warp(geom, verts, ext, intr, h, w, normalize, weights, mask=None):
    """JAX's coordinates and the verts gradient of sum_k w_k * c_k over the
    valid samples (and the given mask)."""
    def f(v):
        c = JGW.warp_coordinates_verts(geom, v, jnp.asarray(ext),
                                       jnp.asarray(intr), h, w,
                                       normalize=normalize)
        keep = c.valid if mask is None else c.valid & jnp.asarray(mask)
        return sum(jnp.sum(jnp.where(keep, a, 0.0) * b)
                   for a, b in zip((c.x, c.y, c.zview), weights)), c
    (_, c), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(verts))
    return c, np.asarray(g)


def _torch_warp(fn, geom, verts, ext, intr, h, w, normalize, weights,
                mask=None):
    v = torch.tensor(verts, requires_grad=True)
    c = fn(geom, v, torch.tensor(ext), torch.tensor(intr), h, w, normalize)
    keep = c.valid if mask is None else c.valid & torch.as_tensor(mask)
    total = sum((torch.where(keep, a, 0.0) * torch.as_tensor(b)).sum()
                for a, b in zip((c.x, c.y, c.zview), weights))
    total.backward()
    return c, v.grad.numpy()


def _rim(c, geom):
    """Samples within one texel of the plane texture's rim."""
    x, y = np.asarray(c.x), np.asarray(c.y)
    return ((x < 1) | (x > geom.mpi_w - 2) | (y < 1)
            | (y > geom.mpi_h - 2))


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("frac", [0.0, 0.6], ids=["flat", "perturbed"])
def test_warp_matches_jax(normalize, frac):
    """The port's warp (K20/K21 plain versions) and the line-by-line plain
    warp against JAX's warp_coordinates_verts: validity equal except on
    the 1-texel rim, x, y, z within 1e-5 relative on the samples valid in
    both, and the verts gradient of a weighted sum of x, y, z over them
    within 1e-5 * max|g|.  At flat verts x, y are the plane sweep's within
    1e-3 texel."""
    jm, tm, ext, intr = _models(normalize)
    g, h, w = jm.geom, jm.H, jm.W
    verts = _perturb(g, np.asarray(jm.init_params(0)["verts"]), frac,
                     normalize=normalize)
    rng = np.random.default_rng(1)
    weights = [rng.standard_normal((3, g.n_planes, h, w)).astype(np.float32)
               for _ in range(3)]
    # one JAX call: its values, and its gradient over the samples the
    # port also finds valid
    pc, _ = _torch_warp(TGW.warp_coordinates_verts_plain, tm.geom, verts,
                        ext, intr, h, w, normalize, weights)
    jc, jg = _jax_warp(g, verts, ext, intr, h, w, normalize, weights,
                       pc.valid.numpy())
    jvalid = np.asarray(jc.valid)
    assert np.abs(jg).max() > 0
    for fn in (TGW.warp_coordinates_verts,
               TGW.warp_coordinates_verts_plain):
        tc, _ = _torch_warp(fn, tm.geom, verts, ext, intr, h, w, normalize,
                            weights)
        tvalid = tc.valid.numpy()
        both = jvalid & tvalid
        assert both.mean() > 0.5
        assert not ((jvalid ^ tvalid) & ~_rim(jc, g)).any()
        for a, b, scale in ((jc.x, tc.x, g.mpi_w), (jc.y, tc.y, g.mpi_h),
                            (jc.zview, tc.zview, 6.0)):
            assert np.abs(np.asarray(a) - b.detach().numpy())[both].max() \
                <= 1e-5 * scale
        # the gradient over the samples valid in both packages
        _, tg = _torch_warp(fn, tm.geom, verts, ext, intr, h, w, normalize,
                            weights, both)
        assert np.abs(tg - jg).max() <= 1e-5 * np.abs(jg).max()
    if frac == 0.0:
        flat = TR.warp_coordinates(tm.geom, torch.tensor(ext),
                                   torch.tensor(intr), h, w)
        m = tvalid & flat.valid.numpy()
        assert m.mean() > 0.5
        for a, b in ((tc.x, flat.x), (tc.y, flat.y)):
            assert np.abs(a.detach().numpy() - b.numpy())[m].max() < 1e-3


def test_plain_kernel_versions_match_autograd():
    """K20's plain version gives the plain warp's values and a winner for
    every sample; K21's plain version (autograd of the winners' barycentric
    interpolation) gives autograd's gradient of the whole loop."""
    jm, tm, ext, intr = _models()
    g, h, w = tm.geom, tm.H, tm.W
    verts = torch.tensor(_perturb(g, np.asarray(jm.init_params(0)["verts"]),
                                  0.6), requires_grad=True)
    e, k = torch.tensor(ext), torch.tensor(intr)
    vpx, vpy, vz = TGW.project_verts(g, verts, e, k)
    qi0, qj0 = TGW.flat_quad_guess(g, e, k, h, w)
    uvx, uvy = TGW.vertex_uvs(g, CPU)
    mpi_hw = (g.mpi_h, g.mpi_w)
    x, y, z, valid, tri = TGW.geo_warp_fwd(
        vpx.detach(), vpy.detach(), vz.detach(), qi0, qj0, uvx, uvy, mpi_hw)
    ref = TGW._search(vpx, vpy, vz, qi0, qj0, uvx, uvy)
    for a, b in zip((x, y, z, tri), ref[:3] + ref[4:]):
        assert torch.equal(a, b.detach())
    assert torch.equal(valid, TGW._valid(*ref[:4], mpi_hw))
    assert (tri >= 0).all() and valid.float().mean() > 0.5
    gen = torch.Generator().manual_seed(2)
    cts = [torch.randn(x.shape, generator=gen) for _ in range(3)]
    want = torch.autograd.grad(ref[:3], (vpx, vpy, vz), cts)
    got = TGW.geo_warp_bwd(*cts, vpx.detach(), vpy.detach(), vz.detach(),
                           qi0, qj0, tri, uvx, uvy)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()


def test_vertex_crossing_report_matches_jax():
    """The guard's (max |dz|, half gap) equal JAX's, flat and with a
    vertex pushed a full inter-plane gap, raw and normalized verts."""
    for normalize in (False, True):
        jm, _, _, _ = _models(normalize)
        g = jm.geom
        v = np.asarray(jm.init_params(0)["verts"]).copy()
        depths = g.depths_np()
        for bump in (0.0, np.abs(np.diff(depths)).min()):
            v2 = v.copy()
            v2[0, 2] += bump / (depths[0] if normalize else 1.0)
            j = JGW.vertex_crossing_report(g, jnp.asarray(v2), normalize)
            t = TGW.vertex_crossing_report(g, torch.tensor(v2), normalize)
            np.testing.assert_allclose(t, j, rtol=1e-6)
            assert (t[0] > t[1]) == (bump > 0)


@pytest.mark.parametrize("C,mask", [
    (4, False), (4, True), (13, False), (13, True), (36, False), (36, True),
    (8, False), (8, True)], ids=[
    "rgba", "loop_mask", "rgb_sh", "rgb_sh_loop_mask", "rgba_sh",
    "rgba_sh_loop_mask", "atlas_cnl8", "atlas_cnl8_loop_mask"])
def test_dense_coord_grad_matches_jax(C, mask):
    """K22's plain version, alone and under `sample_dense`'s autograd,
    against jax.grad of bilinear_planes with respect to x and y, at the
    direct decoder's C = 4, rgb_sh's 13, rgba_sh's 36 and --atlas_cnl 8,
    with the loop mask as JAX's channel C; coordinates on texel lines, on
    the rim and outside the plane among them: within 1e-5 * max|g|."""
    rng = np.random.default_rng(4)
    D, Ht, Wt, B, h, w = 3, 10, 12, 2, 6, 8
    atlas = rng.standard_normal((D, Ht, Wt, C)).astype(np.float32)
    amask = rng.standard_normal((D, Ht, Wt, 1)).astype(np.float32)
    x = rng.uniform(-1.5, Wt + 0.5, (B, D, h, w)).astype(np.float32)
    y = rng.uniform(-1.5, Ht + 0.5, (B, D, h, w)).astype(np.float32)
    x[:, :, 0] = np.round(x[:, :, 0])           # exactly on texel columns
    y[:, :, 1] = np.round(y[:, :, 1])
    x[:, :, 2, :2] = [0.0, Wt - 1.0]            # the rim
    g = rng.standard_normal((B, D, h, w, C)).astype(np.float32)
    gm = rng.standard_normal((B, D, h, w, 1)).astype(np.float32)
    tex = np.concatenate([atlas, amask], -1) if mask else atlas
    ct = np.concatenate([g, gm], -1) if mask else g

    def jf(xx, yy):
        vals = [JS.bilinear_planes(jnp.asarray(tex), xx[b].reshape(D, -1),
                                   yy[b].reshape(D, -1))[0]
                for b in range(B)]
        return jnp.sum(jnp.stack(vals).reshape(ct.shape) * ct)
    jgx, jgy = (np.asarray(a) for a in jax.grad(jf, (0, 1))(
        jnp.asarray(x), jnp.asarray(y)))
    t = [torch.from_numpy(a) for a in (atlas, amask, x, y, g, gm)]
    tgx, tgy = TS.sample_dense_coord_grad(
        t[4], t[5] if mask else None, t[0], t[1] if mask else None, t[2],
        t[3])
    xr, yr = (a.clone().requires_grad_(True) for a in t[2:4])
    feats, mfeats = TS.sample_dense(t[0], t[1] if mask else None, xr, yr)
    total = (feats * t[4]).sum() + ((mfeats * t[5]).sum() if mask else 0)
    total.backward()
    for a, b in ((tgx, jgx), (tgy, jgy), (xr.grad, jgx), (yr.grad, jgy)):
        assert np.abs(b).max() > 0
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_tile_coord_grad_matches_jax():
    """K23's plain version, alone and under `sample_tiles`' autograd,
    against jax.grad of bilinear_tiles with respect to u and v: the
    clip's 0.5 at u, v = 0 and at the far tile edge (where the +1 corner
    is the next row's, tile's or the zero pad's texel), 0 outside, and
    nothing where k < 0; within 1e-5 * max|g|."""
    rng = np.random.default_rng(5)
    N, th, tw, C = 5, 4, 6, 4
    tiles = rng.standard_normal((N, th, tw, C)).astype(np.float32)
    shape = (3, 40)
    k = rng.integers(-1, N, shape).astype(np.int32)
    u = rng.uniform(-1.0, tw, shape).astype(np.float32)
    v = rng.uniform(-1.0, th, shape).astype(np.float32)
    u[0, :8], v[0, :8] = 0.0, 1.5                  # u on the tile's edges
    u[0, 8:16] = tw - 1.0
    v[1, :8], u[1, :8] = 0.0, 2.25
    v[1, 8:16] = th - 1.0
    u[2, :4], v[2, :4], k[2, :4] = tw - 1.0, th - 1.0, N - 1   # the pad
    k[:2, :16] = rng.integers(0, N, (2, 16))
    ct = rng.standard_normal(shape + (C,)).astype(np.float32)

    def jf(uu, vv):
        vals, _ = JS.bilinear_tiles(jnp.asarray(tiles), jnp.asarray(k), uu,
                                    vv)
        return jnp.sum(vals * ct)
    jgu, jgv = (np.asarray(a) for a in jax.grad(jf, (0, 1))(
        jnp.asarray(u), jnp.asarray(v)))
    t = [torch.from_numpy(a) for a in (tiles, k, u, v, ct)]
    tgu, tgv = TS.bilinear_tiles_coord_grad(t[4], t[0], t[1], t[2], t[3])
    ur, vr = (a.clone().requires_grad_(True) for a in t[2:4])
    vals, _ = TS.sample_tiles(t[0], t[1], ur, vr)
    (vals * t[4]).sum().backward()
    edge = (u == 0) | (u == tw - 1)
    assert ((k >= 0) & edge & (jgu != 0)).sum() >= 8
    for a, b in ((tgu, jgu), (tgv, jgv), (ur.grad, jgu), (vr.grad, jgv)):
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def _step_models(route, decoder=None):
    """Both MPMeshes of tests/test_torch_stage1_train.py's step (6 planes,
    every regularizer on) in the geometry phase, at perturbed verts, and
    one batch; for route "sparse" after the same random cull; with
    `decoder`, under that --rgb_mlp_type (its atlas channels)."""
    argv = ["--rgb_mlp_type", decoder] if decoder else []
    argv += ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "6",
            "--scale_invariant", "--learn_loop_mask", "--fast_stage1_grad",
            "--sparsity_loss_weight", "0.004",
            "--rgb_smooth_loss_weight", "0.2",
            "--a_smooth_loss_weight", "0.5", "--d_smooth_loss_weight", "0.1",
            "--l_smooth_loss_weight", "0.1", "--density_loss_weight", "0.02",
            "--lrate", "0.1"]
    argv += ["--fused_render"] if route == "fused" else []
    H, W = 24, 32
    intrin = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                      np.float32)
    ja, ta = jax_parse(argv), torch_parse(argv)
    jm = JaxMPMesh(ja, H, W, np.eye(4), intrin, 1.5, 6.0)
    tm = TorchMPMesh(ta, H, W, np.eye(4), intrin, 1.5, 6.0, device=CPU)
    g = jm.geom
    p = {k: np.asarray(v) for k, v in jm.init_params(1).items()}
    rng = np.random.default_rng(0)
    p["atlas"] = rng.standard_normal(p["atlas"].shape).astype(np.float32)
    p["atlas_mask"] = rng.standard_normal(
        p["atlas_mask"].shape).astype(np.float32)
    p["verts"] = _perturb(g, p["verts"], 0.5, seed=7)
    if route == "sparse":
        r = rng.random((g.n_planes, g.n_tiles_h, g.n_tiles_w))
        tm_s = np.full(r.shape, -1, np.int32)
        tm_d = np.full(r.shape, -1, np.int32)
        tm_s[r < 0.5] = np.arange((r < 0.5).sum(), dtype=np.int32)
        tm_d[r >= 0.7] = np.arange((r >= 0.7).sum(), dtype=np.int32)
        th, tw = g.default_tile_texels()
        jm.is_sparse, jm.has_dyn = True, True
        jm.tile_map_static, jm.tile_map_dyn = tm_s, tm_d
        jm.tile_hw = (th, tw)
        tm.set_sparse(tm_s, tm_d, (th, tw))
        p = {"atlas": rng.standard_normal((int((r < 0.5).sum()), th, tw, 4)),
             "atlas_dyn": rng.standard_normal((int((r >= 0.7).sum()), th,
                                               tw, 4)),
             "verts": p["verts"]}
        p = {k: v.astype(np.float32) for k, v in p.items()}
    jm.optimize_geometry = tm.optimize_geometry = True
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    batch = {"extrin": ext, "intrin": intrin[None].copy(),
             "rgb": rng.random((1, H, W, 3), dtype=np.float32),
             "loopmask": (rng.random((1, H, W)) < 0.5).astype(np.float32)}
    return ja, ta, jm, tm, p, batch, (H, W)


@pytest.mark.parametrize("route,decoder", [
    ("shipped", None), ("fused", None), ("sparse", None),
    ("shipped", "rgb_sh"), ("shipped", "rgba_sh")], ids=[
    "shipped", "fused", "sparse", "shipped_rgb_sh", "shipped_rgba_sh"])
def test_geo_step_matches_jax(route, decoder):
    """One geometry-phase step (dense unfused, dense --fused_render,
    sparse; the dense unfused route also with the rgb_sh and rgba_sh
    decoders, whose 13 and 36 channels K22 sums) against JAX's
    make_stage1_loss_fn at perturbed verts: the loss and every metric
    within 1e-5 relative, every gradient (atlas, atlas_mask or atlas_dyn,
    verts) within 1e-5 * max|g|; verts get one."""
    ja, ta, jm, tm, p, batch, (H, W) = _step_models(route, decoder)
    if decoder:
        assert p["atlas"].shape[-1] == {"rgb_sh": 13, "rgba_sh": 36}[decoder]
    weights = {k: 0.3 for k in JS1.STAGE1_WEIGHT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jloss = JS1.make_stage1_loss_fn(jm, ja, H, W)
    jfn = jax.value_and_grad(lambda q: jloss(q, jb, weights, None),
                             has_aux=True)
    # compiling beats JAX's op-by-op autodiff of the unfused chain only
    (_, jmet), jg = (jax.jit(jfn) if route == "shipped" else jfn)(jp)
    tp = tck.params_from_numpy(p, CPU)
    for t in tp.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, tmet = TS1.make_stage1_loss_fn(tm, ta, H, W)(tp, tb, weights)
    total.backward()
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(torch.as_tensor(tmet[k]).item(),
                                   float(jmet[k]), rtol=1e-5, err_msg=k)
    for k in tp:
        a = np.asarray(jg[k])
        assert np.abs(a).max() > 0, k
        assert np.abs(tp[k].grad.numpy() - a).max() <= 1e-5 * np.abs(a).max(), k


def _recovery(sparse):
    """JAX's vertex-recovery setups: a smooth contentful atlas, (sparse:
    half the plane dynamic, culled at alpha 0.01), the ground truth
    rendered through verts jiggled by 0.35 of a quad, 80 Adam steps on the
    verts alone from the flat grid (lr 3e-3) through the port.  Returns
    (loss before, loss after, mean |v - truth| before, after)."""
    jm, tm, ext, intr = _models(loop_mask=sparse)
    g = tm.geom
    ty, tx = np.meshgrid(np.arange(g.mpi_h), np.arange(g.mpi_w),
                         indexing="ij")
    a = np.zeros((g.n_planes, g.mpi_h, g.mpi_w, 4), np.float32)
    for d in range(g.n_planes):
        a[d, ..., 0] = np.sin(2 * np.pi * tx / (14 + 3 * d))
        a[d, ..., 1] = np.sin(2 * np.pi * ty / (11 + 2 * d))
        a[d, ..., 2] = np.sin(2 * np.pi * (tx + ty) / 17)
    a[..., -1] = 2.0
    params = tck.params_from_numpy(
        {k: np.asarray(v) for k, v in jm.init_params(0).items()}, CPU)
    params["atlas"] = torch.from_numpy(a)
    if sparse:
        mask = np.full((g.n_planes, g.mpi_h, g.mpi_w, 1), -3.0, np.float32)
        mask[:, :, : g.mpi_w // 2] = 3.0
        params["atlas_mask"] = torch.from_numpy(mask)
        params, _ = TSP.apply_tile_cull(tm, params, torch.sigmoid,
                                        erode_num=0, alpha_thresh=0.01,
                                        rm_first_layers=0)
        assert tm.is_sparse and len(params["atlas"]) and \
            len(params["atlas_dyn"])
    tm.optimize_geometry = True
    truth = torch.from_numpy(_perturb(g, g.vertex_grid(), 0.35))
    e, k = torch.tensor(ext), torch.tensor(intr)
    with torch.no_grad():
        gt = tm.forward({**params, "verts": truth}, tm.H, tm.W, e, k)[0]
    v = params["verts"].clone().requires_grad_(True)

    def loss():
        rgb = tm.forward({**params, "verts": v}, tm.H, tm.W, e, k)[0]
        return torch.mean((rgb - gt) ** 2)

    with torch.no_grad():
        val0, err0 = float(loss()), float((v - truth).abs().mean())
    opt = torch.optim.Adam([v], lr=3e-3, eps=1e-8)
    for _ in range(80):
        opt.zero_grad()
        loss().backward()
        opt.step()
    with torch.no_grad():
        return val0, float(loss()), err0, float((v - truth).abs().mean())


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_vertex_recovery(sparse):
    """The port's counterparts of JAX's
    test_vertex_recovery_on_misregistered_scene and
    test_sparse_phase_vertex_recovery: training the verts alone halves the
    loss and moves them toward the truth."""
    val0, val1, err0, err1 = _recovery(sparse)
    assert val1 < 0.5 * val0, (val0, val1)
    assert err1 < err0, (err0, err1)


def test_start_param_matches_jax_adam():
    """Adam state of a parameter that joins the loss late: JAX's one step
    counter gives verts' first update the bias correction of step t; the
    port's start_param seeds that state, and the parameters after two
    more steps equal JAX's within 1e-4 relative (torch takes the bias
    corrections in float64, JAX in float32).  Without it the first verts
    update is about 3x smaller."""
    rng = np.random.default_rng(9)
    a0 = rng.standard_normal(6).astype(np.float32)
    v0 = rng.standard_normal(4).astype(np.float32)
    ga = [rng.standard_normal(6).astype(np.float32) for _ in range(5)]
    gv = [rng.standard_normal(4).astype(np.float32) for _ in range(2)]
    init, update = JO.make_optimizer("adam", eps=1e-8)
    jp = {"a": jnp.asarray(a0), "verts": jnp.asarray(v0)}
    state = init(jp)
    lr = {"a": jnp.asarray(0.1), "verts": jnp.asarray(0.1)}
    for i in range(5):
        gvi = gv[i - 3] if i >= 3 else np.zeros(4, np.float32)
        jp, state = update(jp, {"a": jnp.asarray(ga[i]),
                                "verts": jnp.asarray(gvi)}, state, lr)

    def port(seed):
        tp = {"a": torch.tensor(a0), "verts": torch.tensor(v0)}
        for t in tp.values():
            t.requires_grad_(True)
        opt = TO.make_optimizer("adam", tp, TO.make_group_fn(1.0), eps=1e-8)
        for i in range(5):
            if i == 3 and seed:
                TO.start_param(opt, tp["verts"])
            tp["a"].grad = torch.tensor(ga[i])
            tp["verts"].grad = torch.tensor(gv[i - 3]) if i >= 3 else None
            TO.set_lr(opt, 0.1)
            opt.step()
        return {k: t.detach().numpy() for k, t in tp.items()}

    seeded, unseeded = port(True), port(False)
    for k in ("a", "verts"):
        np.testing.assert_allclose(seeded[k], np.asarray(jp[k]), rtol=1e-4)
    assert np.abs(unseeded["verts"] - np.asarray(jp["verts"])).max() > 0.05


def _argv(root, exp, n_iters, extra=()):
    """tests/test_torch_stage1_sparse.py's tiny trainer configuration with
    the geometry on from epoch 1, through the cull at epoch 2."""
    return ["--datadir", os.path.join(root, "scene"),
            "--expdir", os.path.join(root, exp), "--expname", "s",
            "--factor", "1", "--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
            "--atlas_grid_h", "2", "--patch_h_size", "24",
            "--patch_w_size", "32", "--patch_h_stride", "16",
            "--patch_w_stride", "24", "--lrate", "0.1",
            "--lrate_decay", "100", "--N_iters", str(n_iters),
            "--i_weights", "1", "--i_video", "1000", "--i_img", "1",
            "--i_print", "1000", "--scale_invariant", "--learn_loop_mask",
            "--add_intrin_noise", "--fast_stage1_grad",
            "--sparsity_loss_weight", "0.004",
            "--rgb_smooth_loss_weight", "0.2",
            "--a_smooth_loss_weight", "0.5", "--density_loss_weight", "0.02",
            "--density_loss_epoch", "1", "--seed", "1", "--mesh_devices", "1",
            "--sparsify_epoch", "2", "--sparsify_alpha_thresh", "0.03",
            "--optimize_geo_start", "1", "--optimize_verts_gain", "0.01",
            "--gpu_num", "0", *extra]


def _series(rundir, tag):
    import json
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["value"]) for r in rows
            if r["tag"] == f"stage1/{tag}"]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def geo_runs(tmp_path_factory):
    """A synthetic scene and both packages' 3-epoch runs on it: a flat
    dense epoch, a dense geometry epoch, the cull, a sparse geometry
    epoch.  Returns (root, JAX's output, the port's output)."""
    root = str(tmp_path_factory.mktemp("geo"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VL3D_DATA_CACHE", "off")
        scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
        jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
        jout = _run(jax_train_3d.main, _argv(root, "jax", 3))
        tout = _run(train_3d.main, _argv(root, "torch", 3))
        yield root, jout, tout


def test_train_3d_geo_matches_jax(geo_runs):
    """The CLI through the geometry event and the cull: the event and
    cull lines, the losses within 2e-3 relative (the first geo step's
    within 1e-5), the flat epoch leaving verts untouched, and the verts
    after the first geometry epoch (3 Adam steps, the step count seeded at
    the event) within 1e-5 relative of JAX's on >= 99% of the entries: an
    entry whose gradient is roundoff-sized may step the other way
    (test_stage1_step_matches_jax), while an unseeded step count would
    move every vertex 3x less in the first step.  The sparse geometry
    epoch moves the verts in both packages."""
    root, jout, tout = geo_runs
    for out in (jout, tout):
        assert out.count("enabling vertex-geometry optimization") == 1
        assert out.count("tile culling: keep") == 1
    t_dir, j_dir = (os.path.join(root, p, "s") for p in ("torch", "jax"))
    t_loss, j_loss = _series(t_dir, "loss"), _series(j_dir, "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss]
    t_v = np.array([v for _, v in t_loss])
    j_v = np.array([v for _, v in j_loss])
    steps = len(t_v) // 3
    assert abs(t_v[steps] - j_v[steps]) <= 1e-5 * abs(j_v[steps])
    np.testing.assert_allclose(t_v, j_v, rtol=2e-3)

    def verts(run, epoch):
        path = os.path.join(run, f"ckpt_epoch_{epoch:04d}.npz")
        return np.asarray(jck.load_checkpoint(path)["params"]["verts"])
    flat = verts(j_dir, 0)
    np.testing.assert_array_equal(verts(t_dir, 0), flat)
    tv, jv = verts(t_dir, 1), verts(j_dir, 1)
    assert np.median(np.abs(jv - flat)) > 5e-4
    close = np.abs(tv - jv) <= 1e-5 * np.abs(jv).max()
    assert close.mean() >= 0.99, close.mean()
    for run in (t_dir, j_dir):
        assert np.abs(verts(run, 2) - verts(run, 1)).max() > 1e-3


def test_crossing_warning_text(geo_runs, tmp_path):
    """A run resumed from a checkpoint whose verts stray more than half
    the inter-plane gap turns the geometry on at its first epoch (>= the
    start epoch, as JAX does on a resume) and prints JAX's warning word
    for word (its numbers from JAX's vertex_crossing_report)."""
    root = geo_runs[0]
    src = os.path.join(root, "torch", "s", "ckpt_epoch_0000.npz")
    loaded = jck.load_checkpoint(src)
    params = {k: np.asarray(v) for k, v in loaded["params"].items()}
    geom = loaded["geom"]
    gap = np.abs(np.diff(geom.depths_np())).min()
    params["verts"][3, 2] += 0.8 * gap
    jck.save_checkpoint(
        str(tmp_path / "cross" / "s" / "ckpt_epoch_0000.npz"), geom=geom,
        params=params, stage="mpi", is_sparse=False, has_dyn=False,
        extra_meta=loaded["meta"]["extra"])
    out = _run(train_3d.main, _argv(root, str(tmp_path / "cross"), 2))
    dz, half_gap = JGW.vertex_crossing_report(geom, jnp.asarray(
        params["verts"]), False)
    want = (f"[stage1] WARNING: vertex depth deviation {dz:.4f} exceeds "
            f"half the inter-plane gap {half_gap:.4f}; plane surfaces may "
            f"cross and the global composite order becomes invalid "
            f"(render/geo_warp.py validity bound)")
    assert dz > half_gap
    lines = out.splitlines()
    assert "[stage1] enabling vertex-geometry optimization" in lines
    assert want in lines, out


def test_render_video_of_geo_checkpoint_is_flat(geo_runs):
    """A port-written checkpoint whose verts moved (dense, after the first
    geometry epoch) renders flat through both packages' render_video:
    the same frames within one u8 step except on 0.1% of the pixels."""
    root = geo_runs[0]
    src = os.path.join(root, "torch", "s", "ckpt_epoch_0001.npz")
    exp = os.path.join(root, "render")
    for pkg in ("jax", "torch"):
        os.makedirs(os.path.join(exp, pkg))
        shutil.copy(src, os.path.join(exp, pkg))

    def argv(name):
        return ["--datadir", os.path.join(root, "scene"), "--expdir", exp,
                "--expname", name, "--factor", "1", "--mpv_frm_num", "6",
                "--gpu_num", "0", "--v", "0", "--t", "0:3", "--type", "seq"]
    jrv.main(argv("jax"))
    trv.main(argv("torch"))
    jf = _read_frames(os.path.join(exp, "jax", "renderonly"))
    tf = _read_frames(os.path.join(exp, "torch", "renderonly"))
    assert tf.shape == (3, 24, 32, 3) and tf.std() > 1.0
    _assert_u8_close(tf, jf)


# ---------------------------------------------------------------------------
# K21's redesign emulated on the host: the blocks' windows and the
# overflow route (`geo_bwd_layout`), and the kernel's order of sums
# ---------------------------------------------------------------------------

def _view_inputs(tm, ext, intr, h, w, frac=0.0, seed=3):
    """The projected vertex arrays, the flat quad guess and the winners of
    the port's model tm at (moved) verts, on the CPU."""
    g = tm.geom
    v = np.asarray(tm.init_params(0)["verts"].detach().numpy())
    verts = torch.tensor(_perturb(g, v, frac, seed=seed) if frac else v)
    e, k = torch.tensor(ext), torch.tensor(intr)
    vpx, vpy, vz = TGW.project_verts(g, verts, e, k)
    qi0, qj0 = TGW.flat_quad_guess(g, e, k, h, w)
    uvx, uvy = TGW.vertex_uvs(g, CPU)
    fwd = TGW.geo_warp_fwd_plain(vpx, vpy, vz, qi0, qj0, uvx, uvy,
                                 (g.mpi_h, g.mpi_w))
    return (vpx, vpy, vz), (qi0, qj0), (uvx, uvy), fwd[4]


def _oblique_models(h=36, w=48):
    """A fine vertex grid (about a quad a pixel) seen from a camera turned
    25 degrees about its vertical axis: a tile's guesses span more than a
    window takes."""
    argv = ["--mpi_h_scale", "1.3", "--mpi_w_scale", "1.3",
            "--mpi_h_verts", "40", "--mpi_w_verts", "60",
            "--mpi_d", "3", "--atlas_grid_h", "1",
            "--rgb_smooth_loss_weight", "0"]
    focal = 0.8 * w
    intrin = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                      np.float32)
    tm = TorchMPMesh(torch_parse(argv), h, w, np.eye(4), intrin, 1.5, 6.0,
                     device=CPU)
    a = np.deg2rad(25.0)
    e = np.eye(4, dtype=np.float32)
    e[0, 0], e[0, 2], e[2, 0], e[2, 2] = np.cos(a), np.sin(a), -np.sin(a), \
        np.cos(a)
    e[0, 3] = 0.3
    return tm, e[None], intrin[None]


def _layout_case(case):
    """(Hv, Wv, qi0, qj0, tri or None) of a layout case."""
    if case == "shipped":
        # configs/mpi_base.txt at --factor 1: 360 x 640, planes of 576 x
        # 1024 texels on 36 x 64 vertices, D = 32, a 180 x 320 patch at
        # the centre of a view 0.05 to the side (chip_smoke.py's stage 1)
        from types import SimpleNamespace
        from videoloop3d_torch.models.geometry import MPIGeometry
        args = SimpleNamespace(mpi_h_scale=1.6, mpi_w_scale=1.6, mpi_d=32,
                               mpi_h_verts=36, mpi_w_verts=64)
        H, W, ph, pw = 360, 640, 180, 320
        focal = 0.9 * W
        intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                          np.float32)
        g = MPIGeometry.create(args, H, W, np.eye(4), intrin, 2.0, 10.0)
        ext = np.eye(4, dtype=np.float32)[None]
        ext[:, 0, 3] = 0.05
        pi = intrin.copy()
        pi[0, 2] -= (W - pw) / 2
        pi[1, 2] -= (H - ph) / 2
        qi0, qj0 = TGW.flat_quad_guess(g, torch.tensor(ext),
                                       torch.tensor(pi[None]), ph, pw)
        return g.n_tiles_h + 1, g.n_tiles_w + 1, qi0, qj0, None
    if case == "oblique":
        tm, ext, intr = _oblique_models()
        h, w = tm.H, tm.W
        frac = 0.0
    else:
        _, tm, ext, intr = _models()
        h, w = tm.H, tm.W
        frac = 0.6 if case == "perturbed" else 0.0
        if case == "grid_edge":
            # far to the side and up: part of every plane falls off the
            # vertex grid, whose guesses clamp to its edge quads
            ext = ext.copy()
            ext[:, 0, 3] += 1.2
            ext[:, 1, 3] -= 0.9
    _, (qi0, qj0), _, tri = _view_inputs(tm, ext, intr, h, w, frac)
    g = tm.geom
    return g.n_tiles_h + 1, g.n_tiles_w + 1, qi0, qj0, tri


def _layout_brute(qi0, qj0, tri, Hv, Wv):
    """geo_bwd_layout's windows, overflow and the uncut extents (rows,
    columns) by a loop over the blocks."""
    B, D, h, w = qi0.shape
    th, tw = TGW._GEO_TILE
    qi, qj = qi0.numpy(), qj0.numpy()
    wins, exts, over = [], [], np.zeros((B, D, h, w), bool)
    corners = None if tri is None else [
        (a.numpy(), b.numpy())
        for a, b in TGW._winner_corners(qi0, qj0, tri, Hv, Wv)]
    for b in range(B):
        for d in range(D):
            for y0 in range(0, h, th):
                for x0 in range(0, w, tw):
                    si = qi[b, d, y0:y0 + th, x0:x0 + tw]
                    sj = qj[b, d, y0:y0 + th, x0:x0 + tw]
                    r0 = int(np.clip(si - 1, 0, Hv - 2).min())
                    r1 = int(np.clip(si + 1, 0, Hv - 2).max()) + 1
                    c0 = int(np.clip(sj - 1, 0, Wv - 2).min())
                    c1 = int(np.clip(sj + 1, 0, Wv - 2).max()) + 1
                    nc = min(c1 - c0 + 1, 32)
                    nr = min(r1 - r0 + 1, 256 // nc)
                    wins.append((r0, c0, nr, nc))
                    exts.append((r1 - r0 + 1, c1 - c0 + 1))
                    if corners is None:
                        continue
                    sl = (b, d, slice(y0, y0 + th), slice(x0, x0 + tw))
                    out = np.zeros(si.shape, bool)
                    for vi, vj in corners:
                        out |= ~((vi[sl] >= r0) & (vi[sl] < r0 + nr)
                                 & (vj[sl] >= c0) & (vj[sl] < c0 + nc))
                    over[sl] = out & (tri.numpy()[sl] >= 0)
    return np.array(wins, np.int32), over, np.array(exts)


@pytest.mark.parametrize("case", ["shipped", "grid_edge", "perturbed",
                                  "oblique"])
def test_geo_bwd_layout(case):
    """K21's plan (`geo_bwd_layout`, mirrored by the kernel's headers):
    blocks of 32 x 32 pixels a (view, plane), each window the vertices its
    3 x 3 searches reach, cut to 32 columns and 256 vertices, against a
    loop over the blocks; a winner's corner outside its window is the
    overflow route.  At the shipped shapes no window is cut, so no sample
    can take that route; an oblique view over a fine grid cuts some."""
    Hv, Wv, qi0, qj0, tri = _layout_case(case)
    lay = TGW.geo_bwd_layout(qi0, qj0, Hv, Wv, tri)
    B, D, h, w = qi0.shape
    assert lay["tiles"] == (-(-h // 32), -(-w // 32))
    assert lay["blocks"] == B * D * lay["tiles"][0] * lay["tiles"][1]
    assert lay["scratch"] == lay["blocks"] * 3 * 256
    wins, over, exts = _layout_brute(qi0, qj0, tri, Hv, Wv)
    np.testing.assert_array_equal(lay["windows"].numpy(), wins)
    cut = (exts[:, 0] > wins[:, 2]) | (exts[:, 1] > wins[:, 3])
    r0, c0, nr, nc = (wins[:, k] for k in range(4))
    assert (r0 >= 0).all() and (r0 + nr <= Hv).all()
    assert (c0 >= 0).all() and (c0 + nc <= Wv).all()
    assert (nr * nc <= 256).all() and (nc <= 32).all()
    if case == "shipped":
        assert lay["blocks"] == 32 * 6 * 10
        # every window whole (no cut: no sample can overflow), at most 64
        # vertices
        assert not cut.any() and (nr * nc).max() <= 64
        return
    np.testing.assert_array_equal(lay["overflow"].numpy(), over)
    assert int(lay["n_overflow"].sum()) == int(over.sum())
    assert int(lay["n_live"].sum()) == int((tri >= 0).sum())
    # only a cut window (fewer rows or columns than its block's searches
    # reach) sends samples to the overflow route
    if case == "oblique":
        assert over.any() and cut.any()
    else:
        assert not over.any() and not cut.any()
    if case == "grid_edge":
        assert (qi0 == 0).any() or (qi0 == Hv - 2).any()
        assert (qj0 == 0).any() or (qj0 == Wv - 2).any()


def _sample_values(cts, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy):
    """csrc/geo_warp.cu:sample_grad in torch (f32, one rounding an
    operation): each winner corner's (row, column) and d/d (vpx, vpy, vz)
    there, (3,) + shape each."""
    g_x, g_y, g_z = cts
    Hv, Wv = vpx.shape[2:]
    corners = TGW._winner_corners(qi0, qj0, tri, Hv, Wv)
    p = [TGW._gather(vpx, i, j) for i, j in corners]
    q = [TGW._gather(vpy, i, j) for i, j in corners]
    z = [TGW._gather(vz, i, j) for i, j in corners]
    u = [uvx[j] for _, j in corners]
    v = [uvy[i] for i, _ in corners]
    xs, ys = TGW._pixels(*qi0.shape[2:], CPU)
    v0x, v0y = p[1] - p[0], q[1] - q[0]
    v1x, v1y = p[2] - p[0], q[2] - q[0]
    v2x, v2y = xs - p[0], ys - q[0]
    den = v0x * v1y - v1x * v0y
    clamped = den.abs() < 1e-12
    den = torch.where(clamped, torch.where(den < 0, -1e-12, 1e-12), den)
    b1 = (v2x * v1y - v1x * v2y) / den
    b2 = (v0x * v2y - v2x * v0y) / den
    b0 = 1.0 - b1 - b2
    gb0 = g_x * u[0] + g_y * v[0] + g_z * z[0]
    gb1 = g_x * u[1] + g_y * v[1] + g_z * z[1] - gb0
    gb2 = g_x * u[2] + g_y * v[2] + g_z * z[2] - gb0
    gn1, gn2 = gb1 / den, gb2 / den
    gden = torch.where(clamped, 0.0, -(gb1 * b1 + gb2 * b2) / den)
    g_v0x = gn2 * v2y + gden * v1y
    g_v0y = -gn2 * v2x - gden * v1x
    g_v1x = -gn1 * v2y - gden * v0y
    g_v1y = gn1 * v2x + gden * v0x
    g_v2x = gn1 * v1y - gn2 * v0y
    g_v2y = -gn1 * v1x + gn2 * v0x
    dpx = torch.stack([-(g_v0x + g_v1x + g_v2x), g_v0x, g_v1x])
    dpy = torch.stack([-(g_v0y + g_v1y + g_v2y), g_v0y, g_v1y])
    dz = torch.stack([g_z * b0, g_z * b1, g_z * b2])
    rows = torch.stack([i for i, _ in corners])
    cols = torch.stack([j for _, j in corners])
    return rows, cols, dpx, dpy, dz


def _slot_sums(keys, vals):
    """csrc/geo_warp.cu:add_slot on one warp's 32 lanes: each run of equal
    keys in lane order summed by the segmented Hillis-Steele scan (f32),
    then (tail lane, key, sum) of each run with a key >= 0, lanes
    ascending (the rounds add a vertex's runs in that order)."""
    v = vals.astype(np.float32).copy()          # (32, 3)
    head = np.r_[True, keys[1:] != keys[:-1]]
    start = np.maximum.accumulate(np.where(head, np.arange(32), 0))
    o = 1
    while o <= (np.arange(32) - start).max():
        up = np.vstack([v[:o], v[:-o]])          # lane - o's value
        take = (np.arange(32) - o) >= start
        v = np.where(take[:, None], v + up, v).astype(np.float32)
        o *= 2
    tail = np.r_[head[1:], True]
    return [(lane, keys[lane], v[lane]) for lane in range(32)
            if tail[lane] and keys[lane] >= 0]


def _k21_emulated(cts, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy):
    """The redesign's sums in its order, in f32: a block's 8 warps, each of
    4 pixel rows, add row by row and corner slot by corner slot into their
    own window (`_slot_sums`); the block sums its warps in order; each
    vertex adds its blocks' windows in block order onto the overflow
    route's sums.  Returns the three gradients and the overflow count."""
    B, D, Hv, Wv = vpx.shape
    h, w = qi0.shape[2:]
    live = (tri >= 0) & ~((cts[0] == 0) & (cts[1] == 0) & (cts[2] == 0))
    lay = TGW.geo_bwd_layout(qi0, qj0, Hv, Wv, tri, live)
    rows, cols, dpx, dpy, dz = (t.numpy() for t in _sample_values(
        cts, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy))
    vals = np.stack([dpx, dpy, dz], 1)            # (3 corners, 3, shape)
    over = lay["overflow"].numpy()
    lv = live.numpy()
    out = np.zeros((3, B * D, Hv * Wv), np.float32)
    # the overflow route: atomics, in no fixed order
    for b, d, y, x in zip(*np.nonzero(over)):
        for k in range(3):
            out[:, b * D + d, rows[k, b, d, y, x] * Wv + cols[k, b, d, y, x]] \
                += vals[k, :, b, d, y, x]
    (th, tw), wr = TGW._GEO_TILE, TGW._GEO_WARP_ROWS
    ty, tx = lay["tiles"]
    wins = lay["windows"].numpy()
    pass2 = np.zeros_like(out)
    for blk in range(lay["blocks"]):
        plane, t = divmod(blk, ty * tx)
        b, d = divmod(plane, D)
        r0, c0, nr, nc = wins[blk]
        acc = np.zeros((th // wr, 3, nr * nc), np.float32)
        xs = (t % tx) * tw + np.arange(tw)
        xc = np.minimum(xs, w - 1)
        for wp in range(th // wr):
            for i in range(wr):
                y = (t // tx) * th + wp * wr + i
                yc = min(y, h - 1)
                use = (xs < w) & (y < h) & lv[b, d, yc, xc] \
                    & ~over[b, d, yc, xc]
                for k in range(3):
                    keys = np.where(use, (rows[k, b, d, yc, xc] - r0) * nc
                                    + cols[k, b, d, yc, xc] - c0, -1)
                    # (32, 3): the advanced indices' axis comes first
                    v = np.where(use[:, None], vals[k, :, b, d, yc, xc],
                                 0.0)
                    for _, key, sm in _slot_sums(keys, v):
                        acc[wp, :, key] += sm
        s_ = acc[0].copy()
        for wp in range(1, th // wr):
            s_ += acc[wp]
        vi, vj = np.divmod(np.arange(nr * nc), nc)
        pass2[:, plane, (vi + r0) * Wv + vj + c0] += s_
    out += pass2
    grads = [torch.from_numpy(out[c].reshape(B, D, Hv, Wv))
             for c in range(3)]
    return grads, int(over.sum())


@pytest.mark.parametrize("case", ["flat", "perturbed", "oblique"])
def test_geo_bwd_summation_order_emulated(case):
    """K21's redesign in its own order of f32 sums (each live sample's
    values once: in its block's window, or by the overflow route) within
    1e-6 * max|g| of `geo_warp_bwd_plain`, with a share of the cotangents
    zero (those samples add nothing); the oblique view takes the overflow
    route."""
    if case == "oblique":
        tm, ext, intr = _oblique_models()
        frac = 0.0
    else:
        _, tm, ext, intr = _models()
        frac = 0.6 if case == "perturbed" else 0.0
    (vpx, vpy, vz), (qi0, qj0), (uvx, uvy), tri = _view_inputs(
        tm, ext, intr, tm.H, tm.W, frac)
    rng = np.random.default_rng(4)
    cts = [torch.from_numpy(rng.standard_normal(qi0.shape).astype(
        np.float32)) for _ in range(3)]
    zero = torch.from_numpy(rng.random(qi0.shape) < 0.1)
    cts = [torch.where(zero, 0.0, c) for c in cts]
    got, n_over = _k21_emulated(cts, vpx, vpy, vz, qi0, qj0, tri, uvx, uvy)
    want = TGW.geo_warp_bwd_plain(*cts, vpx, vpy, vz, qi0, qj0, tri, uvx,
                                  uvy)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
    assert (n_over > 0) == (case == "oblique")


# ---------------------------------------------------------------------------
# K20's redesign emulated on the host: the block's staged window and
# triangle table, the candidates found without division, their search in
# order, the full search where no candidate scores > 0, and the global
# route of the samples whose reach leaves their window
# ---------------------------------------------------------------------------

_CORNER_OFF = ((0, 0), (0, 1), (1, 1), (1, 0))     # TL, TR, BR, BL


def _k20_table(vpx, vpy, vz):
    """csrc/geo_warp.cu's staged triangle table for every triangle of the
    (B, D, Hv, Wv) grids, as each window computes it (bary's operations in
    f32, the clamp, v0 and v1 negated where den < 0, den 0 where a corner
    is behind): (B, D, Hv - 1, Wv - 1, 2, 7) = ax, ay, v0x, v0y, v1x,
    v1y, den."""
    Hv, Wv = vpx.shape[2:]

    def at(arr, k):
        di, dj = _CORNER_OFF[k]
        return arr[:, :, di:Hv - 1 + di, dj:Wv - 1 + dj]
    out = []
    for a, b, c in TGW._TRIANGLES:
        ax, ay = at(vpx, a), at(vpy, a)
        v0x, v0y = at(vpx, b) - ax, at(vpy, b) - ay
        v1x, v1y = at(vpx, c) - ax, at(vpy, c) - ay
        den = v0x * v1y - v1x * v0y
        den = torch.where(den.abs() < 1e-12,
                          torch.where(den < 0, -1e-12, 1e-12), den)
        front = (at(vz, a) > 1e-6) & (at(vz, b) > 1e-6) & (at(vz, c) > 1e-6)
        sg = torch.where(den < 0, -1.0, 1.0)
        out.append(torch.stack([ax, ay, sg * v0x, sg * v0y, sg * v1x,
                                sg * v1y, torch.where(front, den.abs(), 0.0)],
                               -1))
    return torch.stack(out, -2)


def _k20_emulated(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw):
    """geo_fwd_tile_kernel on the host, sample-parallel: each sample's
    block window (`geo_bwd_layout`), the global route where its reach
    leaves it (the first design's search: `geo_warp_fwd_plain`), else its
    18 triangles' terms read from the staged table at window-local
    indices, (A) the candidates, (B) their barycentrics in the order of i
    keeping the first strict maximum, (C) the whole search in order where
    no candidate scores > 0, and the winner's interpolation of the staged
    uv and depths.  Returns ((x, y, z, valid, tri), stats)."""
    B, D, Hv, Wv = vpx.shape
    h, w = qi0.shape[2:]
    lay = TGW.geo_bwd_layout(qi0, qj0, Hv, Wv)
    (th, tw), (ty, tx) = TGW._GEO_TILE, lay["tiles"]
    blk = ((torch.arange(B * D).view(B, D, 1, 1) * ty
            + (torch.arange(h) // th).view(1, 1, h, 1)) * tx
           + (torch.arange(w) // tw).view(1, 1, 1, w))
    r0, c0, nr, nc = lay["windows"].long()[blk].unbind(-1)
    glob = lay["search_global"]
    staged = ~glob
    table = _k20_table(vpx, vpy, vz)
    bb = torch.arange(B).view(B, 1, 1, 1).expand(B, D, h, w)
    dd = torch.arange(D).view(1, D, 1, 1).expand(B, D, h, w)
    xs, ys = TGW._pixels(h, w, CPU)
    i0, j0 = qi0.long(), qj0.long()
    terms, quads = [], []
    for i in range(18):
        q, t = divmod(i, 2)
        ri = (i0 + q // 3 - 1).clamp(0, Hv - 2)
        cj = (j0 + q % 3 - 1).clamp(0, Wv - 2)
        li, lj = ri - r0, cj - c0
        # every quad of a staged sample lies in its window
        inside = (li >= 0) & (li <= nr - 2) & (lj >= 0) & (lj <= nc - 2)
        assert inside[staged].all()
        terms.append(table[bb, dd, (r0 + li).clamp(0, Hv - 2),
                           (c0 + lj).clamp(0, Wv - 2), t])
        quads.append((ri, cj, t))
    # (A) the candidates, without division
    nums = []
    cand = torch.zeros((18,) + qi0.shape, dtype=torch.bool)
    for i, tm in enumerate(terms):
        ax, ay, v0x, v0y, v1x, v1y, den = tm.unbind(-1)
        v2x, v2y = xs - ax, ys - ay
        n1 = v2x * v1y - v1x * v2y
        n2 = v0x * v2y - v2x * v0y
        nums.append((n1, n2, den))
        cand[i] = ~((n1 <= 0) | (n2 <= 0) | (n1 > den) | (n2 > den))
    best = torch.full(qi0.shape, -float("inf"))
    code = torch.full(qi0.shape, -1, dtype=torch.long)
    bw = torch.zeros((3,) + qi0.shape)

    def visit(i, sel):
        n1, n2, den = nums[i]
        b1, b2 = n1 / den, n2 / den
        b0 = 1.0 - b1 - b2
        score = torch.minimum(torch.minimum(b0, b1), b2)
        upd = sel & (score > best)
        best.copy_(torch.where(upd, score, best))
        code.copy_(torch.where(upd, i, code))
        bw.copy_(torch.where(upd, torch.stack([b0, b1, b2]), bw))
        return int(sel.sum())
    divisions = 0
    for i in range(18):                                   # (B)
        divisions += visit(i, staged & cand[i])
    redo = staged & ~(best > 0)                           # (C)
    best[redo], code[redo], bw[:, redo] = -float("inf"), -1, 0.0
    for i in range(18):
        divisions += visit(i, redo & (nums[i][2] != 0))
    # the winner's interpolation
    x = torch.zeros(qi0.shape)
    y = torch.zeros(qi0.shape)
    z = torch.ones(qi0.shape)
    for i, (ri, cj, t) in enumerate(quads):
        sel = staged & (code == i)
        ks = [TGW._TRIANGLES[t][k] for k in range(3)]
        vi = [ri + _CORNER_OFF[k][0] for k in ks]
        vj = [cj + _CORNER_OFF[k][1] for k in ks]
        cz = [TGW._gather(vz, a, b_) for a, b_ in zip(vi, vj)]
        for out, vals in ((x, [uvx[j] for j in vj]), (y, [uvy[a] for a in vi]),
                          (z, cz)):
            val = bw[0] * vals[0] + bw[1] * vals[1] + bw[2] * vals[2]
            out.copy_(torch.where(sel, val, out))
    valid = TGW._valid(x, y, z, best, mpi_hw)
    tri = code.to(torch.int8)
    plain = TGW.geo_warp_fwd_plain(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw)
    outs = [torch.where(glob, p, o) for p, o in zip(plain,
                                                   (x, y, z, valid, tri))]
    stats = {"global": int(glob.sum()), "candidates": int(cand.sum()),
             "redone": int(redo.sum()), "divisions": 2 * divisions,
             "samples": qi0.numel(), "n_search_global": lay["n_search_global"],
             "lay": lay, "blk": blk}
    return outs, stats


def _k20_synthetic(case, B=2, D=2, Hv=6, Wv=8, h=40, w=70, seed=0):
    """Projected vertex grids on the CPU whose flat vertices sit on whole
    pixels (10 x 8 pixel quads, a part of the image beyond the grid: the
    guesses clamp to its edge quads), with the case's twist: 'behind'
    (every 5th vertex and a whole plane behind the camera), 'ties'
    (unmoved: pixels on the shared edges and diagonals, exact score
    ties), 'nan' (a NaN vertex position and depth)."""
    rng = np.random.default_rng(seed)
    sx, sy = 10.0, 8.0
    gx = np.arange(Wv) * sx - 3.0 * sx / 2
    gy = np.arange(Hv) * sy - 2.0
    vpx = np.broadcast_to(gx[None, None, None, :], (B, D, Hv, Wv)).copy()
    vpy = np.broadcast_to(gy[None, None, :, None], (B, D, Hv, Wv)).copy()
    if case != "ties":
        vpx += np.round((rng.random(vpx.shape) - 0.5) * 0.6 * sx, 1)
        vpy += np.round((rng.random(vpy.shape) - 0.5) * 0.6 * sy, 1)
    vz = rng.uniform(1.0, 3.0, (B, D, Hv, Wv))
    if case == "behind":
        vz.reshape(-1)[::5] = -1.0
        vz[1, 0] = -0.5
    if case == "nan":
        vpx[0, 1, 2, 3] = np.nan
        vz[1, 0, 3, 4] = np.nan
    px = np.arange(w)[None, :]
    py = np.arange(h)[:, None]
    qj0 = np.clip(np.floor((px - gx[0]) / sx), 0, Wv - 2) + 0 * py
    qi0 = np.clip(np.floor((py - gy[0]) / sy), 0, Hv - 2) + 0 * px
    f32 = [torch.from_numpy(np.ascontiguousarray(a, np.float32))
           for a in (vpx, vpy, vz)]
    i32 = [torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(a, (B, D, h, w)), np.int32)) for a in (qi0, qj0)]
    uvx = torch.from_numpy(np.linspace(0, 60.0, Wv).astype(np.float32))
    uvy = torch.from_numpy(np.linspace(0, 40.0, Hv).astype(np.float32))
    return (*f32, *i32, uvx, uvy, (41, 61))


def _k20_case(case):
    """(vpx, vpy, vz, qi0, qj0, uvx, uvy, mpi_hw) of a case, and for the
    model cases the JAX model, view and verts."""
    if case in ("behind", "ties", "nan"):
        return _k20_synthetic(case), None
    if case == "oblique":
        tm, ext, intr = _oblique_models()
        jm, frac = None, 0.0
    else:
        jm, tm, ext, intr = _models()
        frac = 0.6 if case == "perturbed" else 0.0
        if case == "grid_edge":
            ext = ext.copy()
            ext[:, 0, 3] += 1.2
            ext[:, 1, 3] -= 0.9
    g = tm.geom
    v = np.asarray(tm.init_params(0)["verts"].detach().numpy())
    verts = _perturb(g, v, frac) if frac else v
    (vpx, vpy, vz), (qi0, qj0), (uvx, uvy), _ = _view_inputs(
        tm, ext, intr, tm.H, tm.W, frac)
    jax_case = None if jm is None or case == "grid_edge" else (
        jm, verts, ext, intr)
    return (vpx, vpy, vz, qi0, qj0, uvx, uvy, (g.mpi_h, g.mpi_w)), jax_case


@pytest.mark.parametrize("case", ["flat", "perturbed", "grid_edge", "oblique",
                                  "behind", "ties", "nan"])
def test_k20_staged_search_emulated(case):
    """K20's redesign, emulated in its own order, gives x, y, z, valid and
    the winners bit for bit as `geo_warp_fwd_plain` (the first design's
    arithmetic): flat and moved verts, grid edges, an oblique view whose
    samples take the global route, corners behind the camera, exact ties
    between neighbouring triangles and a NaN vertex.  The window plan
    holds every staged sample's 9 quads (asserted in the emulation) and
    marks the others for the global route, block by block as the kernel's
    header counts them; where every pixel lies inside the grid the
    candidates leave out most divisions.  On the
    model cases the values agree with JAX's `warp_coordinates_verts` as
    in `test_warp_matches_jax`."""
    args, jax_case = _k20_case(case)
    got, st = _k20_emulated(*args)
    want = TGW.geo_warp_fwd_plain(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if a.dtype == torch.float32:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert torch.equal(a, b)
    # the global route: exactly the samples whose reach leaves the window,
    # counted per block as the kernel's header does
    counts = torch.bincount(st["blk"][st["lay"]["search_global"]].reshape(-1),
                            minlength=st["lay"]["blocks"])
    assert torch.equal(counts, st["n_search_global"])
    assert (st["global"] > 0) == (case == "oblique")
    if case in ("flat", "perturbed"):
        # every pixel inside the grid: most triangles left out
        assert st["divisions"] < 0.5 * 36 * st["samples"]
    if case == "ties":
        assert st["redone"] > 0              # exact zeros: the full search
        assert (want[4] >= 0).all()
    if case == "behind":
        assert (want[4] < 0).any() and st["redone"] > 0
    if case == "nan":
        assert torch.isfinite(got[0]).all()
    if jax_case is not None:
        jm, verts, ext, intr = jax_case
        jc = JGW.warp_coordinates_verts(jm.geom, jnp.asarray(verts),
                                        jnp.asarray(ext), jnp.asarray(intr),
                                        jm.H, jm.W)
        jvalid = np.asarray(jc.valid)
        tvalid = got[3].numpy()
        both = jvalid & tvalid
        assert both.mean() > 0.5
        assert not ((jvalid ^ tvalid) & ~_rim(jc, jm.geom)).any()
        for a, b, scale in ((jc.x, got[0], jm.geom.mpi_w),
                            (jc.y, got[1], jm.geom.mpi_h),
                            (jc.zview, got[2], 6.0)):
            assert np.abs(np.asarray(a) - b.numpy())[both].max() \
                <= 1e-5 * scale
