"""The port's kernel-holding functions against the JAX package, on the CPU.

On CPU tensors each wrapper (K1 `warp_lookup`, K2 `bilinear_tiles`, K3
`bilinear_tiles_tilemajor`, also at 13 and 36 channels, K4 `composite`)
runs its plain PyTorch
version, which is what the CUDA kernels are held against on the card
(``chip_smoke.py``).  Inputs are made with numpy from fixed seeds and fed
to both packages.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPV
from videoloop3d_tpu.render import fused as jfused
from videoloop3d_tpu.render import renderer as jR
from videoloop3d_tpu.render import sample as jS
from videoloop3d_torch.render import fused as tfused
from videoloop3d_torch.render import renderer as tR
from videoloop3d_torch.render import sample as tS

H, W, D, F = 24, 32, 10, 5


def _geometry():
    """The tests/test_fused.py geometry: 24x32 view, 10 planes, 3x4 tiles
    over a 28x38 texture."""
    intrin = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                      np.float32)
    args = jax_parse(["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
                      "--mpi_h_verts", "4", "--mpi_w_verts", "5",
                      "--mpi_d", str(D), "--mpv_frm_num", str(F)])
    geom = JaxMPV(args, H, W, np.eye(4, dtype=np.float32), intrin, 1.5,
                  6.0).geom
    r = np.random.default_rng(5).random((D, geom.n_tiles_h, geom.n_tiles_w))
    tm_s = np.full(r.shape, -1, np.int32)
    tm_d = np.full(r.shape, -1, np.int32)
    tm_s[r < 0.5] = np.arange((r < 0.5).sum(), dtype=np.int32)
    tm_d[r > 0.6] = np.arange((r > 0.6).sum(), dtype=np.int32)
    return geom, intrin, tm_s, tm_d


def _views(intrin):
    """Three target views: near the reference, a larger translation (part
    of each plane outside the view), and a rotated one."""
    exts = []
    for t, ang in (([0.1, -0.05, 0.02], 0.0), ([0.6, 0.3, -0.2], 0.0),
                   ([-0.2, 0.1, 0.1], 0.15)):
        e = np.eye(4, dtype=np.float32)
        c, s = np.cos(ang), np.sin(ang)
        e[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        e[:3, 3] = t
        exts.append(e)
    exts = np.stack(exts)
    return exts, np.repeat(intrin[None], len(exts), 0)


def _near_edge(t, span, hi, tol=1e-3):
    """True where texel coordinate t is within tol of a tile edge (a
    multiple of span) or of the plane rectangle's edges 0 and hi."""
    return (np.abs(t - np.round(t / span) * span) < tol) \
        | (np.abs(t) < tol) | (np.abs(t - hi) < tol)


def _close_rel(a, b, rel):
    return np.abs(a - b) <= rel * np.maximum(np.abs(a), 1.0)


def test_warp_lookup_matches_jax():
    """K1 vs warp_coordinates + tile_lookup2.  Tolerance: x, y, zview, fu
    and fv agree to 1e-4 relative (both are f32 homography evaluations
    whose matrix products may round in another order); k_s, k_d and
    valid are exact except where x or y lies within 1e-3 texel of a tile
    edge or the plane rectangle's edge, where one ulp flips the tile."""
    geom, intrin, tm_s, tm_d = _geometry()
    exts, intrs = _views(intrin)
    jc = jR.warp_coordinates(geom, jnp.asarray(exts), jnp.asarray(intrs),
                             H, W)
    jks, jkd, jfu, jfv = jR.tile_lookup2(geom, tm_s, tm_d, jc)

    G = tR.homographies(geom, torch.from_numpy(exts),
                        torch.from_numpy(intrs)).contiguous()
    tc, tks, tkd, tfu, tfv = tR.warp_lookup(
        G, torch.from_numpy(tm_s), torch.from_numpy(tm_d), H, W,
        (geom.mpi_h, geom.mpi_w), geom.tile_span)
    assert tks.dtype == torch.int32 and tc.valid.dtype == torch.bool
    assert tuple(tks.shape) == (3, D, H, W)

    x, y = np.asarray(jc.x), np.asarray(jc.y)
    finite = np.isfinite(x) & np.isfinite(y)
    for a, b in ((jc.x, tc.x), (jc.y, tc.y), (jc.zview, tc.zview)):
        assert _close_rel(np.asarray(a), b.numpy(), 1e-4)[finite].all()
    sy, sx = geom.tile_span
    edge = _near_edge(x, sx, geom.mpi_w - 1) | _near_edge(y, sy,
                                                         geom.mpi_h - 1)
    valid = np.asarray(jc.valid)
    assert 0.2 < valid.mean() < 1.0        # both in- and outside samples
    assert (valid == tc.valid.numpy())[~edge].all()
    assert (np.asarray(jks) == tks.numpy())[~edge].all()
    assert (np.asarray(jkd) == tkd.numpy())[~edge].all()
    sel = valid & ~edge
    assert _close_rel(np.asarray(jfu), tfu.numpy(), 1e-4)[sel].all()
    assert _close_rel(np.asarray(jfv), tfv.numpy(), 1e-4)[sel].all()
    # the same function through the JAX-named plain entry points
    tc2 = tR.warp_coordinates(geom, torch.from_numpy(exts),
                              torch.from_numpy(intrs), H, W)
    k2 = tR.tile_lookup2(geom, torch.from_numpy(tm_s),
                         torch.from_numpy(tm_d), tc2)
    assert torch.equal(k2[0], tks) and torch.equal(k2[1], tkd)


def _samples(n_tiles, th, tw, shape=(D, H, W), seed=0):
    """Shared k/u/v inputs: k in [-1, N), u and v spanning past both tile
    ends, with exact hits on 0, tw-1 and th-1."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-1, max(n_tiles, 1), shape).astype(np.int32)
    u = rng.uniform(-0.5, tw - 0.5, shape).astype(np.float32)
    v = rng.uniform(-0.5, th - 0.5, shape).astype(np.float32)
    flat_u, flat_v = u.reshape(-1), v.reshape(-1)
    flat_u[:50] = tw - 1
    flat_v[25:75] = th - 1
    flat_u[100:120] = 0.0
    return k, u, v


def _tiles(shape, seed, dtype):
    t = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jt = jnp.asarray(t).astype(jnp.bfloat16 if dtype == "bf16" else
                                jnp.float32)
    tt = torch.from_numpy(t).to(torch.bfloat16 if dtype == "bf16" else
                                torch.float32)
    return jt, tt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bilinear_tiles_matches_jax(dtype):
    """K2 vs sample.bilinear_tiles.  Tolerance 1e-6: the same f32 lerps
    of the same texels (bf16 texels are rounded from the same f32 values
    by both frameworks and widened exactly)."""
    jt, tt = _tiles((37, 6, 7, 4), 1, dtype)
    k, u, v = _samples(37, 6, 7)
    jv, jvalid = jS.bilinear_tiles(jt, jnp.asarray(k), jnp.asarray(u),
                                   jnp.asarray(v))
    tv, tvalid = tS.bilinear_tiles(tt, torch.from_numpy(k),
                                   torch.from_numpy(u), torch.from_numpy(v))
    assert tv.dtype == torch.float32 and tuple(tv.shape) == (D, H, W, 4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv, np.float32),
                               rtol=0, atol=1e-6)
    assert (tvalid.numpy() == np.asarray(jvalid)).all()
    assert (tv.numpy()[k < 0] == 0).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ts", [None, [4, 0, 2]])
def test_bilinear_tiles_tilemajor_matches_jax(dtype, ts):
    """K3 vs sample.bilinear_tiles_tilemajor on dyn[..., ts, :].
    Tolerance 1e-6, as for K2."""
    _tilemajor_vs_jax(dtype, ts, 4)


@pytest.mark.parametrize("C", [13, 36])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ts", [None, [4, 0, 2]])
def test_bilinear_tiles_tilemajor_matches_jax_sh_channels(dtype, ts, C):
    """K3 at the SH decoders' channel counts (rgb_sh 13, rgba_sh 36: the
    card's sweep route) vs sample.bilinear_tiles_tilemajor on
    dyn[..., ts, :]; tolerance 1e-6, as at C = 4."""
    _tilemajor_vs_jax(dtype, ts, C)


def _tilemajor_vs_jax(dtype, ts, C):
    jt, tt = _tiles((23, 6, 7, F, C), 2, dtype)
    k, u, v = _samples(23, 6, 7, seed=3)
    jtiles = jt if ts is None else jt[..., jnp.asarray(ts), :]
    jv, _ = jS.bilinear_tiles_tilemajor(jtiles, jnp.asarray(k),
                                        jnp.asarray(u), jnp.asarray(v))
    tts = None if ts is None else torch.tensor(ts, dtype=torch.int32)
    tv, tvalid = tS.bilinear_tiles_tilemajor(
        tt, torch.from_numpy(k), torch.from_numpy(u), torch.from_numpy(v),
        tts)
    n_f = F if ts is None else len(ts)
    assert tuple(tv.shape) == (D, H, W, n_f, C)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv, np.float32),
                               rtol=0, atol=1e-6)
    assert (tvalid.numpy() == (k >= 0)).all()


def test_bilinear_tiles_fully_culled_atlas():
    """N = 0 (every tile culled): zeros of the right shape, and the
    valid mask still follows k (all -1 here)."""
    k = np.full((D, H, W), -1, np.int32)
    u = np.zeros((D, H, W), np.float32)
    tv, tvalid = tS.bilinear_tiles(torch.zeros((0, 6, 7, 4)),
                                   torch.from_numpy(k), torch.from_numpy(u),
                                   torch.from_numpy(u))
    assert tuple(tv.shape) == (D, H, W, 4) and not tv.any()
    assert not tvalid.any()
    td, _ = tS.bilinear_tiles_tilemajor(
        torch.zeros((0, 6, 7, F, 4)), torch.from_numpy(k),
        torch.from_numpy(u), torch.from_numpy(u))
    assert tuple(td.shape) == (D, H, W, F, 4) and not td.any()
    jv, _ = jS.bilinear_tiles(jnp.zeros((0, 6, 7, 4)), jnp.asarray(k),
                              jnp.asarray(u), jnp.asarray(u))
    assert not np.asarray(jv).any()


def test_wrappers_reject_grad_and_bad_inputs():
    """Forward-only wrappers raise on tensors that require grad, and on
    a wrong dtype or shape."""
    tiles = torch.zeros((3, 6, 7, 4), requires_grad=True)
    k = torch.zeros((2, 3), dtype=torch.int32)
    u = torch.zeros((2, 3))
    with pytest.raises(RuntimeError, match="requires grad"):
        tS.bilinear_tiles(tiles, k, u, u)
    with pytest.raises(TypeError):
        tS.bilinear_tiles(tiles.detach(), k.long(), u, u)
    with pytest.raises(ValueError):
        tS.bilinear_tiles(tiles.detach(), k, u[:1], u)


def _stacks(seed=7):
    rng = np.random.default_rng(seed)
    vals_s = rng.standard_normal((D, H, W, 4)).astype(np.float32)
    vals_d = rng.standard_normal((D, H, W, F, 4)).astype(np.float32)
    valid = rng.random((D, H, W)) < 0.8
    hit_s = rng.random((D, H, W)) < 0.5
    hit_d = rng.random((D, H, W)) < 0.4
    return vals_s, valid & hit_s, vals_d, hit_d, valid & hit_d


def _jax_unfused_chain(vals_s, m_s, vals_d, hit_d, m_d):
    """The eval path's unfused decode + select + cumprod composite of
    videoloop3d_tpu/models/mpv.py (render, sparse branch, fused off)."""
    import jax

    def decode(feats, valid):
        rgb = jax.nn.sigmoid(feats[..., :3]) * valid[..., None]
        alpha = jnp.where(valid, jax.nn.sigmoid(feats[..., 3]), 0.0)
        return rgb, alpha

    rgb_s, alpha_s = decode(vals_s, m_s)
    rgb_d, alpha_d = decode(vals_d, m_d[..., None])
    hd = hit_d[..., None, None]
    rgb_p = jnp.where(hd, rgb_d, rgb_s[..., None, :])
    alpha_p = jnp.where(hd[..., 0], alpha_d, alpha_s[..., None])
    trans = jax.lax.cumprod(1.0 - alpha_p, axis=0, reverse=True)
    trans = jnp.concatenate([trans[1:], jnp.ones_like(trans[:1])], axis=0)
    bw = alpha_p * trans
    return jnp.sum(rgb_p * bw[..., None], axis=0), jnp.sum(bw, axis=0)


def test_composite_matches_jax():
    """K4 vs the unfused chain and vs fused.fused_composite's forward.
    Tolerance 1e-5: the sequential product reassociates the cumprod scan
    (outputs lie in [0, 1])."""
    stacks = _stacks()
    jin = [jnp.asarray(a) for a in stacks]
    out_u, asum_u = _jax_unfused_chain(*jin)
    cfg = jfused.FusedCfg(n_planes=D, use_sparsity=False,
                          use_rgb_smooth=False, use_a_smooth=False,
                          want_disp=False)
    out_f, asum_f, disp, regs = jfused.fused_composite(
        cfg, *jin, jnp.zeros((D, H, W), jnp.float32))
    assert disp is None and regs == {}
    out, asum = tfused.composite(*[torch.from_numpy(a) for a in stacks])
    assert tuple(out.shape) == (H, W, F, 3) and tuple(asum.shape) == (H, W, F)
    for ref_out, ref_asum in ((out_u, asum_u), (out_f, asum_f)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(asum.numpy(), np.asarray(ref_asum),
                                   rtol=0, atol=1e-5)


def test_composite_planes_matches_jax():
    """renderer.composite_planes (the cumprod chain) vs JAX, 1e-6: the
    same products and sums in f32."""
    rng = np.random.default_rng(9)
    alpha = rng.random((2, D, H, W)).astype(np.float32)
    content = rng.random((2, D, H, W, 3)).astype(np.float32)
    jo, jw = jR.composite_planes(jnp.asarray(alpha), jnp.asarray(content))
    to, tw = tR.composite_planes(torch.from_numpy(alpha),
                                 torch.from_numpy(content))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
