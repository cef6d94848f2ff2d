"""The shipped stage-2 route of the PyTorch port (``--compact_hits``,
``--fused_render``) against the JAX package, on the CPU: hit compaction
(`compact_sweep`'s plain version, the cotangent expansion and
`slot_bound`), the compacted tile sampler against
`make_tile_adjoint_compacted`, `fused_composite`'s plain forward and VJP
against `jax.vjp`, one stage-2 step on the four routes {compact on/off} x
{fused on/off} in f32 and under --fp16, and the `train_3dvid` CLI with
the shipped flags over two pyramid levels with a cross-package resume.
The shapes are those of ``tests/test_fused.py:_build`` (mpi_d 10, 24x32,
5 frames, every regularizer weighted).  Inputs are made with numpy and
handed to both packages; the JAX functions run as plain XLA on the CPU."""
import itertools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_stage2_train import _argv, _copy_ckpt, _series
from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core import cameras as jcam
from videoloop3d_tpu.data import llff as jllff
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.losses import patch_nn as JPN
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.render import adjoint as ADJ
from videoloop3d_tpu.render import compact as JC
from videoloop3d_tpu.render import fused as JF
from videoloop3d_tpu.render import renderer as JR
from videoloop3d_tpu.tools import train_3dvid as jax_train_3dvid
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
from videoloop3d_torch.render import compact as TC
from videoloop3d_torch.render import fused as TF
from videoloop3d_torch.render import renderer as TR
from videoloop3d_torch.tools import train_3dvid
from videoloop3d_torch.train import stage2 as TS2

CPU = torch.device("cpu")
H, W, FRM = 24, 32, 5
INTRIN = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]],
                  np.float32)
SHIPPED = ["--compact_hits", "--fused_render"]


def _model_argv(extra=()):
    """tests/test_fused.py:_build's configuration, with the other-view
    loss of tests/test_torch_stage2_train.py (3x3x3, alpha off)."""
    return ["--datadir", "x", "--expname", "x",
            "--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "4", "--mpi_w_verts", "5",
            "--mpi_d", "10", "--mpv_frm_num", str(FRM), "--mpv_isloop",
            "--sparsity_loss_weight", "0.1", "--rgb_smooth_loss_weight",
            "0.1", "--a_smooth_loss_weight", "0.1",
            "--d_smooth_loss_weight", "0.1", "--density_loss_weight", "0.1",
            "--scale_invariant", "--loss_name", "gpnn_lm",
            "--swd_patch_size", "3", "--swd_patcht_size", "3",
            "--swd_stride", "2", "--swd_stridet", "1", "--swd_alpha",
            "10000", "--swd_rou", "-2", "--swd_scaling", "0.1",
            "--swd_macro_block", "17", *extra]


def _tile_maps(shape, keep_s, keep_d, seed):
    r = np.random.default_rng(seed).random(shape)
    tm_s = np.full(shape, -1, np.int32)
    tm_d = np.full(shape, -1, np.int32)
    tm_s[r < keep_s] = np.arange((r < keep_s).sum(), dtype=np.int32)
    sel_d = r > 1 - keep_d
    tm_d[sel_d] = np.arange(sel_d.sum(), dtype=np.int32)
    return tm_s, tm_d


def _pair(extra=(), keep_s=0.07, keep_d=0.05, seed=5):
    """Both packages' sparse MPMeshVid on _build's geometry and tile maps,
    with the same seeded texels (the JAX model, its params, the port's
    model and params)."""
    argv = _model_argv(extra)
    jm = JaxMPMeshVid(jax_parse(argv), H, W, np.eye(4, dtype=np.float32),
                      INTRIN, 1.5, 6.0)
    tm = TorchMPMeshVid(torch_parse(argv), H, W,
                        np.eye(4, dtype=np.float32), INTRIN, 1.5, 6.0,
                        device=CPU)
    g = jm.geom
    tm_s, tm_d = _tile_maps((g.n_planes, g.n_tiles_h, g.n_tiles_w), keep_s,
                            keep_d, seed)
    th, tw = g.default_tile_texels()
    rng = np.random.default_rng(11)
    params = {"atlas": rng.standard_normal(
        (int((tm_s >= 0).sum()), th, tw, 4)).astype(np.float32),
        "atlas_dyn": rng.standard_normal(
            (int((tm_d >= 0).sum()), th, tw, FRM, 4)).astype(np.float32)}

    def ckpt(geom):
        return {"meta": {"is_sparse": True, "tile_hw": [th, tw],
                         "frm_num": FRM, "extra": {}},
                "geom": geom, "params": params, "tile_map_static": tm_s,
                "tile_map_dyn": tm_d}

    jp = jm.restore_checkpoint(ckpt(g))
    tp = tm.restore_checkpoint(ckpt(tm.geom))
    return jm, jp, tm, tp


def _view():
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.1, -0.05, 0.02]
    return ext[None], INTRIN[None].copy()


def _jax_sweep(jm, ext, intr):
    coords = JR.warp_coordinates(jm.geom, jnp.asarray(ext), jnp.asarray(intr),
                                 H, W)
    k_s, k_d, fu, fv = JR.tile_lookup2(jm.geom, jm.tile_map_static,
                                       jm.tile_map_dyn, coords)
    return coords, k_s[0], k_d[0], fu[0], fv[0]


def _sweep_arrays(case, S):
    """(D, h, w) per-plane arrays for compact_sweep: random hits; every
    pixel with more hits than S (overflow); an all-miss row and column."""
    rng = np.random.default_rng(7)
    D, h, w = 10, 6, 9
    p_hit = {"random": 0.3, "overflow": 0.9, "all_miss": 0.4}[case]
    hit = rng.random((D, h, w)) < p_hit
    if case == "all_miss":
        hit[:, 2] = False
        hit[:, :, 4] = False
    if case == "overflow":
        hit[:S + 1] = True
    both = rng.random((D, h, w))
    k_s = np.where(hit & (both < 0.7), rng.integers(0, 40, (D, h, w)), -1)
    k_d = np.where(hit & (both > 0.4), rng.integers(0, 30, (D, h, w)), -1)
    arrs = [k_s.astype(np.int32), k_d.astype(np.int32)]
    arrs += [rng.uniform(-0.2, 1.2, (D, h, w)).astype(np.float32)
             for _ in range(2)]
    arrs.append(rng.random((D, h, w)) < 0.8)
    arrs.append(rng.uniform(1.0, 6.0, (D, h, w)).astype(np.float32))
    return arrs


@pytest.mark.parametrize("S", [3, 7])
@pytest.mark.parametrize("case", ["random", "overflow", "all_miss"])
def test_compact_sweep_matches_jax(case, S):
    """compact_sweep (the plain version of K13) equals JAX's one-hot
    selection array for array: slot order far -> near, the farthest hits
    dropped on overflow, empty slots k = -1, fu = fv = zview = 0,
    invalid; and expand_cotangent_plain equals JAX's expand_cotangent."""
    arrs = _sweep_arrays(case, S)
    j = JC.compact_sweep(*(jnp.asarray(a) for a in arrs), S)
    t = TC.compact_sweep(*(torch.from_numpy(a) for a in arrs), S)
    for name in TC.CompactedSweep._fields:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "all_miss":
        assert (t.k_s[:, 2] == -1).all() and not t.valid[:, :, 4].any()
    ct = np.random.default_rng(8).standard_normal(t.k_s.shape + (5, 4))
    ct = ct.astype(np.float32)
    je = np.asarray(JC.expand_cotangent(j.onehot, jnp.asarray(ct)))
    te = TC.expand_cotangent_plain(torch.from_numpy(arrs[0]),
                                   torch.from_numpy(arrs[1]),
                                   torch.from_numpy(ct), S)
    np.testing.assert_array_equal(te.numpy(), je)


@pytest.mark.parametrize("keep", [(0.05, 0.03), (0.07, 0.05), (0.5, 0.4)])
def test_slot_bound_matches_jax(keep):
    """The port's slot_bound (K1's plain version on the CPU) gives JAX's S
    for two views, below D for the sparse maps and D for the dense ones."""
    jm, _, tm, _ = _pair(keep_s=keep[0], keep_d=keep[1])
    ext, intr = _view()
    ext2 = ext.copy()
    ext2[0, :3, 3] = [-0.12, 0.04, -0.03]
    exts, intrs = np.concatenate([ext, ext2]), np.concatenate([intr, intr])
    js = JC.slot_bound(jm.geom, jm.tile_map_static, jm.tile_map_dyn, exts,
                       intrs, H, W)
    ts = TC.slot_bound(tm.geom, tm.tile_map_static, tm.tile_map_dyn, exts,
                       intrs, H, W)
    assert ts == js
    assert (ts < 10) == (keep[0] < 0.1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("ndim", [4, 5], ids=["static", "dynamic"])
@pytest.mark.parametrize("slots", ["bound", "overflow"])
def test_compacted_sampler_matches_jax_adjoint(slots, ndim, bf16):
    """The port's tile sampler (renderer.sample_sparse: K2/K9, K3/K10) on
    the compacted slots (values within 1e-6) and its
    tile gradient straight from the slot layout against JAX's
    make_tile_adjoint_compacted (expansion to the plane layout, then the
    per-tile gradient): within 1e-5 * max|g| in f32, one bf16 ulp
    (2^-7 * max|g|) for bf16 tiles, also when S is below the pixels' hit
    counts and the farthest hits are dropped."""
    jm, jp, tm, tp = _pair()
    ext, intr = _view()
    coords, k_s, k_d, fu, fv = _jax_sweep(jm, ext, intr)
    S = JC.slot_bound(jm.geom, jm.tile_map_static, jm.tile_map_dyn, ext,
                      intr, H, W)
    hits = np.asarray(((k_s >= 0) | (k_d >= 0)).sum(0)).max()
    if slots == "overflow":
        S = int(hits) - 2
    assert 0 < S < 10
    cs = JC.compact_sweep(k_s, k_d, fu, fv, coords.valid[0],
                          coords.zview[0], S)
    key = "atlas" if ndim == 4 else "atlas_dyn"
    k_full, k_c = (k_s, cs.k_s) if ndim == 4 else (k_d, cs.k_d)
    tm_np = jm.tile_map_static if ndim == 4 else jm.tile_map_dyn
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jt = jp[key].astype(jdt)
    th, tw = jt.shape[1], jt.shape[2]
    ct = np.random.default_rng(9).standard_normal(
        k_c.shape + jt.shape[3:]).astype(np.float32)
    M = ADJ.forward_projection(jnp.asarray(jm.geom.depths),
                               jnp.asarray(jm.geom.ref_intrin_mpi),
                               jnp.asarray(ext), jnp.asarray(intr))[0]
    samp = ADJ.make_tile_adjoint_compacted(
        ADJ.tile_positions(tm_np), jm.geom.tile_span,
        ADJ.tile_window_for(jm.geom, (H, W)))

    def jf(t):
        return samp(t, k_c, cs.fu * (tw - 1), cs.fv * (th - 1), k_full,
                    fu * (tw - 1), fv * (th - 1), cs.onehot, M)[0]

    jvals = np.asarray(jf(jt))
    jg = np.asarray(jax.grad(lambda t: jnp.sum(jf(t) * ct))(jt)
                    .astype(jnp.float32))
    tdt = torch.bfloat16 if bf16 else torch.float32
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32))).to(tdt)
    tt.requires_grad_(True)
    tcs = TC.compact_sweep(*(torch.from_numpy(np.array(a)) for a in (
        k_s, k_d, fu, fv, coords.valid[0], coords.zview[0])), S)
    kt = tcs.k_s if ndim == 4 else tcs.k_d
    vals, valid = TR.sample_sparse(tt, kt, tcs.fu, tcs.fv)
    assert torch.equal(valid, kt >= 0)
    assert np.abs(vals.detach().numpy() - jvals).max() <= 1e-6
    (vals * torch.from_numpy(ct)).sum().backward()
    assert tt.grad.dtype == tdt
    tol = (2.0 ** -7 if bf16 else 1e-5) * np.abs(jg).max()
    assert np.abs(jg).max() > 0
    assert np.abs(tt.grad.float().numpy() - jg).max() <= tol


FLAGS = list(itertools.product([False, True], repeat=4))


def _flag_id(f):
    return "".join(c if on else "-" for c, on in zip("sraD", f))


@pytest.mark.parametrize("n_slots", [6, 10], ids=["S<D", "S=D"])
@pytest.mark.parametrize("flags", FLAGS, ids=[_flag_id(f) for f in FLAGS])
def test_fused_composite_matches_jax_vjp(flags, n_slots):
    """fused_composite (the autograd Function, plain forward and backward
    on the CPU) against jax.vjp of the JAX fused_composite for every
    FusedCfg flag combination (sparsity, rgb-smooth, a-smooth, disparity),
    at S < D slots and S = D: outputs within 1e-6, the regularizer sums
    within 2e-5 relative, the texel cotangents within 2e-5 * max|g|."""
    D = 10
    rng = np.random.default_rng(sum(flags) + n_slots)
    S, h, w, F = n_slots, 7, 9, FRM
    vals_s = (2 * rng.standard_normal((S, h, w, 4))).astype(np.float32)
    vals_d = (2 * rng.standard_normal((S, h, w, F, 4))).astype(np.float32)
    masks = [rng.random((S, h, w)) < p for p in (0.7, 0.4, 0.6)]
    dinv = rng.random((S, h, w)).astype(np.float32)
    g_out = rng.standard_normal((h, w, F, 3)).astype(np.float32)
    g_asum, g_disp = (rng.standard_normal((h, w, F)).astype(np.float32)
                      for _ in range(2))
    g_regs = rng.standard_normal(3).astype(np.float32)
    jcfg, tcfg = JF.FusedCfg(D, *flags), TF.FusedCfg(D, *flags)
    jm = [jnp.asarray(m) for m in masks]

    def jfun(a, b):
        return JF.fused_composite(jcfg, a, jm[0], b, jm[1], jm[2],
                                  jnp.asarray(dinv))

    (jout, jasum, jdisp, jregs), vjp = jax.vjp(jfun, jnp.asarray(vals_s),
                                               jnp.asarray(vals_d))
    jct = {k: jnp.asarray(g_regs[i]) for i, k in enumerate(TF.REG_NAMES)
           if k in jregs}
    jg_s, jg_d = vjp((jnp.asarray(g_out), jnp.asarray(g_asum),
                      jnp.asarray(g_disp) if flags[3] else None, jct))

    ts = torch.from_numpy(vals_s).requires_grad_(True)
    td = torch.from_numpy(vals_d).requires_grad_(True)
    tm = [torch.from_numpy(m) for m in masks]
    out, asum, disp, regs = TF.fused_composite(
        tcfg, ts, tm[0], td, tm[1], tm[2],
        torch.from_numpy(dinv) if flags[3] else None)
    assert set(regs) == set(jregs)
    assert (disp is None) == (jdisp is None)
    for a, b in ((out, jout), (asum, jasum), (disp, jdisp)):
        if b is not None:
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-6
    for k in regs:
        np.testing.assert_allclose(float(regs[k].detach()), float(jregs[k]),
                                   rtol=2e-5, atol=1e-8, err_msg=k)
    total = (out * torch.from_numpy(g_out)).sum() \
        + (asum * torch.from_numpy(g_asum)).sum()
    if disp is not None:
        total = total + (disp * torch.from_numpy(g_disp)).sum()
    for i, k in enumerate(TF.REG_NAMES):
        if k in regs:
            total = total + regs[k] * float(g_regs[i])
    total.backward()
    for got, ref in ((ts.grad, jg_s), (td.grad, jg_d)):
        ref = np.asarray(ref)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


ROUTES = {"unfused": [], "compact": ["--compact_hits"],
          "fused": ["--fused_render"], "shipped": SHIPPED}


@pytest.mark.parametrize("prec", ["f32", "fp16"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_stage2_step_routes_match_jax(route, prec, monkeypatch):
    """One stage-2 loss (train/stage2.py:make_patch_loss_fn: the GPNN loss
    at alpha off and every regularizer) and its atlas gradients on each of
    the four routes {--compact_hits on/off} x {--fused_render on/off},
    against the JAX package's step on the same route: the slot bound
    equal to JAX's and below D, the metrics within 2e-5 relative, the
    gradients within 2e-5 * max|g| in f32 and one bf16 ulp (2^-7 *
    max|g|) under --fp16 --fast_stage2_grad (bf16 texels whose gradients
    both packages sum in f32 and round once, and a bf16 NN search; the
    JAX fold takes f32 patches, as on the TPU)."""
    fold = JPN.fold_patches_3d
    monkeypatch.setattr(JPN, "fold_patches_3d",
                        lambda p, *a: fold(p.astype(jnp.float32), *a))
    extra = ROUTES[route] + (["--fp16", "--fast_stage2_grad"]
                             if prec == "fp16" else [])
    jm, jp, tm, tp = _pair(extra)
    ext, intr = _view()
    if "--compact_hits" in extra:
        S = JC.slot_bound(jm.geom, jm.tile_map_static, jm.tile_map_dyn,
                          ext, intr, H, W)
        assert TC.slot_bound(tm.geom, tm.tile_map_static, tm.tile_map_dyn,
                             ext, intr, H, W) == S < 10
        jm.compact_slots = tm.compact_slots = S
    video = np.random.default_rng(3).random((FRM, H, W, 3)).astype(
        np.float32)
    batch = {"extrin": ext, "intrin": intr, "video": video}
    weights = {k: 0.3 for k in TS2.STAGE2_WEIGHT_KEYS}
    cfg = JS2.loss_config_from_args(jax_parse(_model_argv(extra)), ref=False)
    jloss = JS2.make_patch_loss_fn(jm, jax_parse(_model_argv(extra)), H, W,
                                   cfg)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, {k: jnp.asarray(v) for k, v in batch.items()},
                        {k: jnp.asarray(v, jnp.float32)
                         for k, v in weights.items()}, None),
        has_aux=True))(jp)

    for t in tp.values():
        t.requires_grad_(True)
    tloss = TS2.make_patch_loss_fn(tm, torch_parse(_model_argv(extra)), H,
                                   W, cfg)
    total, tmet = tloss(tp, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, weights)
    total.backward()
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2e-5, err_msg=k)
    gtol = 2.0 ** -7 if prec == "fp16" else 2e-5
    for k in ("atlas", "atlas_dyn"):
        a = np.asarray(jg[k])
        assert np.abs(a).max() > 0
        assert np.abs(tp[k].grad.numpy() - a).max() <= \
            gtol * np.abs(a).max(), k


@pytest.fixture(scope="module")
def scene10(tmp_path_factory):
    """A synthetic 3-view scene (tests/test_torch_stage2_train.py's, with
    its seeded pixel noise) and a sparse stage-1 checkpoint of 10 planes
    with the tile density of tests/test_fused.py's compacted case (7%
    static, 5% dynamic tiles), built
    with the JAX package: sparse enough that the slot bound stays below
    D at both pyramid levels."""
    root = str(tmp_path_factory.mktemp("shipped"))
    scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
    noise = np.random.default_rng(5).normal(0.0, 0.03, scene["videos"].shape)
    scene["videos"] = np.clip(scene["videos"] + noise, 0.0, 1.0)
    jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
    args = jax_parse(_argv(root, "x", ["--mpi_d", "10"]))
    _, _, sc = jllff.load_mv_videos(
        os.path.join(root, "scene"), factor=1,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    ref = jcam.pose_to_extrinsic(jcam.average_pose(sc["poses"])[:, :4])
    m = JaxMPMesh(args, *sc["hw"], ref, sc["intrins"].mean(0),
                  float(sc["bds"].min()), float(sc["bds"].max()))
    g = m.geom
    tm_s, tm_d = _tile_maps((g.n_planes, g.n_tiles_h, g.n_tiles_w), 0.07,
                            0.05, 5)
    th, tw = g.default_tile_texels()
    m.is_sparse, m.has_dyn = True, True
    m.tile_map_static, m.tile_map_dyn, m.tile_hw = tm_s, tm_d, (th, tw)
    rng = np.random.default_rng(11)

    def tiles(n):
        t = rng.standard_normal((n, th, tw, 4)).astype(np.float32)
        t[..., 3] = rng.uniform(-2.0, 3.0, t.shape[:3])
        return t

    p = {"atlas": tiles(int((tm_s >= 0).sum())),
         "atlas_dyn": tiles(int((tm_d >= 0).sum())),
         "verts": g.vertex_grid().astype(np.float32)}
    JS1.save_stage1_checkpoint(os.path.join(root, "s1", "ckpt_epoch_0002.npz"),
                               m, p, epoch=2)
    return root


def test_train_3dvid_shipped_flags_match_jax_and_resume(scene10, capsys,
                                                        monkeypatch):
    """Both CLIs with the shipped route (--compact_hits --fused_render
    --fp16 --fast_stage2_grad; the JAX fold takes f32 patches, as on the
    TPU) from the same 10-plane sparse stage-1 checkpoint
    over two pyramid levels (3 + 3 steps, alpha off as in
    tests/test_torch_stage2_train.py): the same `hit-compaction: S=...`
    line per level, S below D, and the same loss series within 1e-4
    relative.  Then each package auto-resumes the other's level-1
    checkpoint with --pyr_num_epoch 2: losses finite and within 1e-4."""
    fold = JPN.fold_patches_3d
    monkeypatch.setattr(JPN, "fold_patches_3d",
                        lambda p, *a: fold(p.astype(jnp.float32), *a))
    root = scene10
    flags = ["--mpi_d", "10", "--swd_alpha_ref", "10000", "--fp16",
             "--fast_stage2_grad", *SHIPPED]
    jax_train_3dvid.main(_argv(root, "jax", flags))
    j_lines = [ln for ln in capsys.readouterr().out.splitlines()
               if "hit-compaction" in ln]
    _, params, rundir = train_3dvid.main(_argv(root, "torch", flags))
    t_lines = [ln for ln in capsys.readouterr().out.splitlines()
               if "hit-compaction" in ln]
    assert t_lines == j_lines and len(t_lines) == 2
    assert all("(no win; off)" not in ln and "of D=10" in ln
               for ln in t_lines)
    jdir = os.path.join(root, "jax", "s")
    t_loss, j_loss = _series(rundir, "loss"), _series(jdir, "loss")
    assert [s for s, _ in t_loss] == [s for s, _ in j_loss] == \
        list(range(6))
    np.testing.assert_allclose([v for _, v in t_loss],
                               [v for _, v in j_loss], rtol=1e-4)
    for tag in ("rgb_smooth", "a_smooth", "sparsity"):
        np.testing.assert_allclose([v for _, v in _series(rundir, tag)],
                                   [v for _, v in _series(jdir, tag)],
                                   rtol=1e-4, err_msg=tag)

    name = "ckpt_l1_epoch_0000.npz"
    more = flags + ["--pyr_num_epoch", "2"]
    _copy_ckpt(os.path.join(rundir, name), root, "res_jax")
    _copy_ckpt(os.path.join(jdir, name), root, "res_torch")
    jax_train_3dvid.main(_argv(root, "res_jax", more))
    _, _, rundir2 = train_3dvid.main(_argv(root, "res_torch", more))
    r_t = _series(rundir2, "loss")
    r_j = _series(os.path.join(root, "res_jax", "s"), "loss")
    assert [s for s, _ in r_t] == [s for s, _ in r_j] == list(range(6, 9))
    assert np.isfinite([v for _, v in r_t + r_j]).all()
    np.testing.assert_allclose([v for _, v in r_t], [v for _, v in r_j],
                               rtol=1e-4)
    for d in (rundir2, os.path.join(root, "res_jax", "s")):
        meta = jck.load_checkpoint(os.path.join(
            d, "ckpt_l1_epoch_0001.npz"))["meta"]
        assert (meta["extra"]["pyr_i"], meta["extra"]["epoch_i"]) == (1, 1)
