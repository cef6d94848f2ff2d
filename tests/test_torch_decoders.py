"""The view-dependent decoders and the activation table of the PyTorch port
against the JAX package, on the CPU: every activation's value and gradient
(0.5 at ``jnp.clip``'s bounds), `eval_sh_bases` at every degree, the view
directions, `decode_rgba` for every decoder, `convert_direct_to_sh` on the
dense and the packed atlas, one stage-1 loss per decoder in the dense and
the sparse phase (with one Adam step where the JAX trainer can take one),
the fused-route gate of both stages, the cull's raw-alpha channel, and
checkpoints across the packages.  Inputs are made with numpy from a seed
and handed to both packages; values are held to 1e-5 relative, gradients
to 1e-5 * max|g|."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core import cameras as jcam
from videoloop3d_tpu.core import sh as jsh
from videoloop3d_tpu.core.activations import ACTIVATIONS as JACT
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models import mpmesh as JMM
from videoloop3d_tpu.models import sparsify as JSP
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.core import cameras as tcam
from videoloop3d_torch.core import sh as tsh
from videoloop3d_torch.core.activations import ACTIVATIONS as TACT
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models import mpmesh as TMM
from videoloop3d_torch.models import sparsify as TSP
from videoloop3d_torch.models.mpmesh import MPMesh as TorchMPMesh
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
from videoloop3d_torch.train import optimizer as TO
from videoloop3d_torch.train import stage1 as TS1
from videoloop3d_torch.train import stage2 as TS2

CPU = torch.device("cpu")
H, W = 24, 32
INTRIN = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1]],
                  np.float32)
DECODERS = {"rgb_sh": [], "rgba_sh": [],
            "nex_rgb": ["--atlas_cnl", "8"],
            "mlp_alpha": ["--atlas_cnl", "8"]}


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-30), \
        (np.abs(a - b).max(), np.abs(b).max())


def _flat(tree):
    return tck.flat_params(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name", sorted(JACT))
def test_activation_matches_jax(name):
    """Value and gradient of every activation of the JAX table, on normal
    draws, on points at the clip bounds 0, 1, 1e-6 and 1 - 1e-6 (where
    ``jnp.clip``'s derivative is 0.5) and beyond the softplus threshold."""
    x = np.random.default_rng(1).normal(0, 3, 300).astype(np.float32)
    x = np.concatenate([x, np.float32([0.0, 1.0, 1e-6, 1 - 1e-6, -1.0,
                                       2.0, 25.0, -25.0, 0.5])])
    g = np.random.default_rng(2).normal(0, 1, x.shape).astype(np.float32)
    jv, vjp = jax.vjp(JACT[name], jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    tv = TACT[name](t)
    tv.backward(torch.from_numpy(g))
    _close(tv.detach().numpy(), jv)
    _close(t.grad.numpy(), jg)
    if name == "clamp":
        # the bounds' derivative is 0.5 (torch.clamp's would be 1)
        np.testing.assert_array_equal(t.grad.numpy()[-9:-7], 0.5 * g[-9:-7])


@pytest.mark.parametrize("dim", [1, 4, 9, 16, 25])
def test_eval_sh_bases_matches_jax(dim):
    d = np.random.default_rng(dim).normal(size=(5, 7, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    j = jsh.eval_sh_bases(dim, jnp.asarray(d))
    t = tsh.eval_sh_bases(dim, torch.from_numpy(d))
    assert t.shape == (5, 7, dim)
    _close(t.numpy(), j)


def test_view_dirs_match_jax():
    """The per-pixel unit view directions of a batch of two relative
    extrinsics, as JAX's stage-1 `_decode` computes them."""
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    c, s = np.cos(0.2), np.sin(0.2)
    ext[1, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    intr = np.stack([INTRIN, INTRIN * [[1.1], [0.9], [1]]]).astype(np.float32)
    poses = jcam.pose_to_extrinsic(jnp.asarray(ext))
    ref = []
    for b in range(2):
        _, d = jcam.get_rays(H, W, jnp.asarray(intr[b]), poses[b])
        ref.append(d / jnp.linalg.norm(d, axis=-1, keepdims=True))
    t = tcam.unit_view_dirs(H, W, torch.from_numpy(ext), torch.from_numpy(intr))
    _close(t.numpy(), np.stack(ref))


@pytest.mark.parametrize("kind", ["direct"] + list(DECODERS))
def test_decode_rgba_matches_jax(kind):
    """`decode_rgba` and its gradients in the features, the view
    directions and the decoder weights (alpha last in every output: the
    SH decoders' last channel, NeX/MLP's channel 0)."""
    C = TMM._atlas_channels(kind, 8)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(2, 3, 5, 6, C)).astype(np.float32)
    dirs = rng.normal(size=(2, 1, 5, 6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dec = TMM.init_decoder_params(kind, C, 3)
    gout = rng.normal(size=(2, 3, 5, 6, 4)).astype(np.float32)

    def jf(f, d, w):
        return JMM.decode_rgba(f, kind, d, w)

    jv, vjp = jax.vjp(jf, jnp.asarray(feats), jnp.asarray(dirs),
                      jax.tree.map(jnp.asarray, dec))
    jgf, jgd, jgw = vjp(jnp.asarray(gout))
    tf = torch.from_numpy(feats).requires_grad_(True)
    td = torch.from_numpy(dirs).requires_grad_(True)
    tw = None if dec is None else tck.params_from_numpy(dec, CPU)
    leaves = tck.flat_params(tw or {})
    for t in leaves.values():
        t.requires_grad_(True)
    tv = TMM.decode_rgba(tf, kind, td if kind != "direct" else None, tw)
    assert tv.shape == (2, 3, 5, 6, 4)
    tv.backward(torch.from_numpy(gout))
    _close(tv.detach().numpy(), jv)
    _close(tf.grad.numpy(), jgf)
    if kind != "direct":
        _close(td.grad.numpy(), jgd)
    for k, t in leaves.items():
        _close(t.grad.numpy(), _flat(jgw)[k])
    if dec is not None:
        ref = JMM.init_decoder_params(kind, C, 3)
        for k, v in _flat(ref).items():
            np.testing.assert_array_equal(tck.flat_params(dec)[k], v)


def _model_pair(argv, H=H, W=W):
    ja, ta = jax_parse(argv), torch_parse(argv)
    jm = JaxMPMesh(ja, H, W, np.eye(4), INTRIN, 1.5, 6.0)
    tm = TorchMPMesh(ta, H, W, np.eye(4), INTRIN, 1.5, 6.0, device=CPU)
    return ja, ta, jm, tm


@pytest.mark.parametrize("phase", ["dense", "sparse"])
def test_convert_direct_to_sh_matches_jax(phase):
    """The direct2sh widening of the dense atlas, and of the packed
    static and dynamic tiles: equal arrays, rgb_sh config, and the
    converted model's render within 1e-5 of JAX's."""
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2", "--mpi_h_verts",
            "5", "--mpi_w_verts", "7", "--mpi_d", "4"]
    _, _, jm, tm = _model_pair(argv)
    rng = np.random.default_rng(5)
    g = jm.geom
    if phase == "dense":
        p = {"atlas": rng.normal(size=(4, g.mpi_h, g.mpi_w, 4)),
             "verts": g.vertex_grid()}
    else:
        r = rng.random((g.n_planes, g.n_tiles_h, g.n_tiles_w))
        tm_s = np.where(r < 0.5, np.cumsum(r < 0.5).reshape(r.shape) - 1, -1)
        tm_d = np.where(r >= 0.6, np.cumsum(r >= 0.6).reshape(r.shape) - 1,
                        -1)
        tm_s, tm_d = tm_s.astype(np.int32), tm_d.astype(np.int32)
        th, tw = g.default_tile_texels()
        p = {"atlas": rng.normal(size=(int((r < 0.5).sum()), th, tw, 4)),
             "atlas_dyn": rng.normal(size=(int((r >= 0.6).sum()), th, tw,
                                           4)),
             "verts": g.vertex_grid()}
        jm.is_sparse, jm.has_dyn = True, True
        jm.tile_map_static, jm.tile_map_dyn = tm_s, tm_d
        jm.tile_hw = (th, tw)
        tm.set_sparse(tm_s, tm_d, (th, tw))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jn = JMM.convert_direct_to_sh(jm, {k: jnp.asarray(v)
                                       for k, v in p.items()})
    tn = TMM.convert_direct_to_sh(tm, tck.params_from_numpy(p, CPU))
    assert jm.cfg.rgb_mlp_type == tm.cfg.rgb_mlp_type == "rgb_sh"
    assert set(tn) == set(jn)
    for k in jn:
        np.testing.assert_array_equal(tn[k].numpy(), np.asarray(jn[k]))
    assert tn["atlas"].shape[-1] == 13
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    jr = jm.forward(jn, H, W, jnp.asarray(ext), jnp.asarray(INTRIN[None]))[0]
    with torch.no_grad():
        tr = tm.forward(tn, H, W, ext, INTRIN[None])[0]
    _close(tr.numpy(), jr)


STEP_ARGV = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
             "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "6",
             "--scale_invariant", "--learn_loop_mask",
             "--sparsity_loss_weight", "0.004",
             "--rgb_smooth_loss_weight", "0.2",
             "--a_smooth_loss_weight", "0.5", "--d_smooth_loss_weight", "0.1",
             "--l_smooth_loss_weight", "0.1", "--density_loss_weight", "0.02",
             "--lrate", "0.1"]


def _step_setup(argv, phase):
    """Both packages' MPMesh on the same random texels (the decoder's
    weights from init_params(1), equal in both) in the dense phase, or
    in the sparse phase on random tile maps, and one batch."""
    ja, ta, jm, tm = _model_pair(argv)
    rng = np.random.default_rng(0)
    p = {k: np.asarray(v) if not isinstance(v, dict) else
         jax.tree.map(np.asarray, v) for k, v in jm.init_params(1).items()}
    g = jm.geom
    C = p["atlas"].shape[-1]
    if phase == "dense":
        p["atlas"] = rng.standard_normal(p["atlas"].shape).astype(np.float32)
        p["atlas_mask"] = rng.standard_normal(
            p["atlas_mask"].shape).astype(np.float32)
    else:
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
        del p["atlas_mask"]
        p["atlas"] = rng.standard_normal(
            (int((r < 0.5).sum()), th, tw, C)).astype(np.float32)
        p["atlas_dyn"] = rng.standard_normal(
            (int((r >= 0.7).sum()), th, tw, C)).astype(np.float32)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    batch = {"extrin": ext, "intrin": INTRIN[None].copy(),
             "rgb": rng.random((1, H, W, 3), dtype=np.float32),
             "loopmask": (rng.random((1, H, W)) < 0.5).astype(np.float32)}
    return ja, ta, jm, tm, p, batch


def _step_compare(argv, phase, adam):
    """The stage-1 loss, every metric and every gradient against JAX's;
    with adam, the parameters after one Adam step (lr 0.1) against JAX's
    own train step: the first update is lr * g / (|g| + eps), which sends
    a roundoff-sized gradient (below 1e-5 * max|g|) either way and, near
    eps (1e-8), turns the gradients' 1e-5 * max|g| tolerance into
    lr * eps * 1e-5 max|g| / (|g| + eps)^2 of the update; elsewhere the
    parameters agree within 1e-5."""
    ja, ta, jm, tm, p, batch = _step_setup(argv, phase)
    weights = {k: 0.3 for k in JS1.STAGE1_WEIGHT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, p)
    jloss = JS1.make_stage1_loss_fn(jm, ja, H, W)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, jb, weights, None), has_aux=True))(jp)
    tp = tck.params_from_numpy(p, CPU)
    step, opt_init, _ = TS1.make_train_step(tm, ta, H, W)
    opt = opt_init(tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, tmet = TS1.make_stage1_loss_fn(tm, ta, H, W)(tp, tb, weights)
    total.backward()
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(torch.as_tensor(tmet[k]).item(),
                                   float(jmet[k]), rtol=1e-5, err_msg=k)
    jflat = _flat(jg)
    for k, t in tck.flat_params(tp).items():
        if k == "verts":
            continue
        assert np.abs(jflat[k]).max() > 0, k
        _close(t.grad.numpy(), jflat[k])
    if not adam:
        return
    jstep, jinit, _ = JS1.make_train_step(jm, ja, H, W)
    jnew, _, _ = jstep(jp, jinit(jp), jb, jnp.float32(0.1),
                       {k: jnp.float32(v) for k, v in weights.items()}, None)
    tp = tck.params_from_numpy(p, CPU)
    step(tp, opt_init(tp), tb, 0.1, weights)
    for k, v in _flat(jnew).items():
        close = np.isclose(tck.flat_params(tp)[k].detach().numpy(), v,
                           rtol=0, atol=1e-5)
        if k == "verts":
            assert close.all()
            continue
        g = np.abs(jflat[k])
        # Adam's update moves by lr * eps * dg / (|g| + eps)^2 for a
        # gradient error dg (at most 1e-5 * max|g|, asserted above)
        dg = 1e-5 * g.max()
        tol = 1e-5 + 0.1 * 1e-8 * dg / (g + 1e-8) ** 2
        err = np.abs(tck.flat_params(tp)[k].detach().numpy() - v)
        assert ((err <= tol) | (g <= dg)).all(), k


@pytest.mark.parametrize("phase", ["dense", "sparse"])
@pytest.mark.parametrize("kind", list(DECODERS))
def test_stage1_step_per_decoder_matches_jax(kind, phase):
    """One stage-1 step of each decoder in each phase.  The JAX trainer
    steps rgb_sh and rgba_sh; for nex_rgb and mlp_alpha its Adam refuses
    the decoder's lr (one scalar for a dict), so the loss and gradients
    are held to JAX's loss function and the step to the port's own Adam
    (`test_jax_trainer_cannot_step_the_mlp_decoders`)."""
    argv = STEP_ARGV + ["--rgb_mlp_type", kind] + DECODERS[kind]
    _step_compare(argv, phase, adam=kind in ("rgb_sh", "rgba_sh"))


def test_jax_trainer_cannot_step_the_mlp_decoders():
    """Reference-side behaviour: JAX's `build_lr_tree` gives the decoder
    dict one scalar, which `adam_update` refuses; the port's optimizer
    steps every decoder leaf at the atlas's lr."""
    argv = STEP_ARGV + ["--rgb_mlp_type", "nex_rgb", "--atlas_cnl", "8"]
    ja, ta, jm, tm, p, batch = _step_setup(argv, "dense")
    jp = jax.tree.map(jnp.asarray, p)
    jstep, jinit, keys = JS1.make_train_step(jm, ja, H, W)
    with pytest.raises(ValueError, match="Expected dict"):
        jstep(jp, jinit(jp), {k: jnp.asarray(v) for k, v in batch.items()},
              jnp.float32(0.1), {k: jnp.float32(0.3) for k in keys}, None)
    tp = tck.params_from_numpy(p, CPU)
    opt = TO.make_optimizer("adam", TO.trainable(tp),
                            TO.make_group_fn(1.0))
    names = {g["name"]: g["gain"] for g in opt.param_groups}
    assert names == {"atlas": 1.0, "atlas_mask": 1.0, "verts": 1.0,
                     "decoder/l0/b": 1.0, "decoder/l0/w": 1.0,
                     "decoder/l1/b": 1.0, "decoder/l1/w": 1.0}


GATE = {"clamp": ["--rgb_activate", "clamp"],
        "rgb_sh": ["--rgb_mlp_type", "rgb_sh"]}


@pytest.mark.parametrize("case", list(GATE))
def test_stage1_fused_gate_matches_jax(case, monkeypatch):
    """--fused_render with another activation or decoder takes the
    unfused chain, as JAX's gate does: one step equals JAX's, and K7/K8
    (their plain versions here) are never entered."""
    from videoloop3d_torch.render import fused_s1
    monkeypatch.setattr(fused_s1, "fused_composite_s1", _never)
    monkeypatch.setattr(TMM, "fused_composite_s1", _never)
    _step_compare(STEP_ARGV + ["--fused_render"] + GATE[case], "dense",
                  adam=True)


def _never(*a, **k):
    raise AssertionError("the fused composite was entered")


def _mpv_pair(extra, C, seed=5):
    """Both packages' sparse stage-2 model (the shipped-route test's
    geometry) with C-channel texels."""
    from test_torch_stage2_shipped import FRM, INTRIN as I2, _model_argv, \
        _tile_maps
    argv = _model_argv(extra)
    jm = JaxMPMeshVid(jax_parse(argv), H, W, np.eye(4, dtype=np.float32),
                      I2, 1.5, 6.0)
    tm = TorchMPMeshVid(torch_parse(argv), H, W, np.eye(4, dtype=np.float32),
                        I2, 1.5, 6.0, device=CPU)
    g = jm.geom
    tm_s, tm_d = _tile_maps((g.n_planes, g.n_tiles_h, g.n_tiles_w), 0.07,
                            0.05, seed)
    th, tw = g.default_tile_texels()
    rng = np.random.default_rng(11)
    params = {"atlas": rng.standard_normal(
        (int((tm_s >= 0).sum()), th, tw, C)).astype(np.float32),
        "atlas_dyn": rng.standard_normal(
            (int((tm_d >= 0).sum()), th, tw, FRM, C)).astype(np.float32)}

    def ckpt(geom):
        return {"meta": {"is_sparse": True, "tile_hw": [th, tw],
                         "frm_num": FRM, "extra": {}},
                "geom": geom, "params": params, "tile_map_static": tm_s,
                "tile_map_dyn": tm_d}

    return jm, jm.restore_checkpoint(ckpt(g)), tm, \
        tm.restore_checkpoint(ckpt(tm.geom)), argv


def _stage2_compare(jm, jp, tm, tp, argv, tol=2e-5):
    from test_torch_stage2_shipped import FRM, INTRIN as I2
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.1, -0.05, 0.02]
    ext, intr = ext[None], I2[None].copy()
    video = np.random.default_rng(3).random((FRM, H, W, 3)).astype(
        np.float32)
    batch = {"extrin": ext, "intrin": intr, "video": video}
    weights = {k: 0.3 for k in TS2.STAGE2_WEIGHT_KEYS}
    cfg = JS2.loss_config_from_args(jax_parse(argv), ref=False)
    jloss = JS2.make_patch_loss_fn(jm, jax_parse(argv), H, W, cfg)
    (_, jmet), jg = jax.jit(jax.value_and_grad(
        lambda q: jloss(q, {k: jnp.asarray(v) for k, v in batch.items()},
                        {k: jnp.asarray(v, jnp.float32)
                         for k, v in weights.items()}, None),
        has_aux=True))(jp)
    TO.trainable(tp)
    tloss = TS2.make_patch_loss_fn(tm, torch_parse(argv), H, W, cfg)
    total, tmet = tloss(tp, {k: torch.from_numpy(v) for k, v in
                             batch.items()}, weights)
    total.backward()
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=tol, err_msg=k)
    jflat = _flat(jg)
    for k, t in tck.flat_params(tp).items():
        if t.grad is None:
            continue
        assert np.abs(jflat[k]).max() > 0, k
        assert np.abs(t.grad.numpy() - jflat[k]).max() <= \
            tol * np.abs(jflat[k]).max(), k
    return ext, intr


@pytest.mark.parametrize("case", list(GATE))
def test_stage2_fused_gate_matches_jax(case, monkeypatch):
    """Stage 2 with --compact_hits --fused_render and another activation
    or decoder: the unfused chain on the compacted slots (K14/K15 never
    entered), equal to JAX's step; and the eval render, which JAX never
    fuses, decodes and composites unfused (K4 never entered)."""
    from videoloop3d_torch.models import mpv as TMV
    from videoloop3d_tpu.render import compact as JC
    from videoloop3d_torch.render import compact as TC
    monkeypatch.setattr(TMV, "fused_composite", _never)
    monkeypatch.setattr(TMV, "composite", _never)
    C = 13 if case == "rgb_sh" else 4
    # clamp saturates whole patches at 0 or 1, and the two packages break
    # the GPNN search's exact ties differently: that case takes the mse
    # looping loss
    loss = ["--loss_name", "mse"] if case == "clamp" else []
    jm, jp, tm, tp, argv = _mpv_pair(["--compact_hits", "--fused_render"]
                                     + GATE[case] + loss, C)
    ext, intr = np.eye(4, dtype=np.float32)[None], INTRIN[None]
    from test_torch_stage2_shipped import INTRIN as I2
    S = JC.slot_bound(jm.geom, jm.tile_map_static, jm.tile_map_dyn,
                      ext, I2[None], H, W)
    assert TC.slot_bound(tm.geom, tm.tile_map_static, tm.tile_map_dyn,
                         ext, I2[None], H, W) == S < 10
    jm.compact_slots = tm.compact_slots = S
    ext, intr = _stage2_compare(jm, jp, tm, tp, argv)
    jr, _ = jm.render(jp, H, W, jnp.asarray(ext), jnp.asarray(intr),
                      jnp.asarray([0, 3]))
    with torch.no_grad():
        tr, _ = tm.render(tp, H, W, ext, intr, np.array([0, 3]))
    _close(tr.numpy(), jr)


ROUTES2 = {"unfused": [], "compacted": ["--compact_hits"]}


@pytest.mark.parametrize("route", list(ROUTES2))
def test_stage2_sh_step_matches_jax(route):
    """One stage-2 step of an rgb_sh sparse MTV on the unfused and the
    compacted route (the dense route: `test_stage2_dense_sh_step`)."""
    jm, jp, tm, tp, argv = _mpv_pair(ROUTES2[route]
                                     + ["--rgb_mlp_type", "rgb_sh"], 13)
    if route == "compacted":
        from videoloop3d_tpu.render import compact as JC
        from test_torch_stage2_shipped import INTRIN as I2
        ext = np.eye(4, dtype=np.float32)
        ext[:3, 3] = [0.1, -0.05, 0.02]
        S = JC.slot_bound(jm.geom, jm.tile_map_static, jm.tile_map_dyn,
                          ext[None], I2[None], H, W)
        assert S < 10
        jm.compact_slots = tm.compact_slots = S
    _stage2_compare(jm, jp, tm, tp, argv)


@pytest.mark.parametrize("kind", ["rgba_sh", "nex_rgb"])
def test_tile_cull_reads_the_last_channel_as_alpha(kind):
    """JAX's cull takes channel -1 as the raw alpha for every decoder (for
    nex_rgb, whose decode reads alpha from channel 0, and for rgba_sh,
    whose last channel is alpha's last SH coefficient); the port's cull
    makes the same decision and packs the same tiles."""
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
            "--rgb_mlp_type", kind, "--atlas_cnl", "6"]
    _, _, jm, tm = _model_pair(argv)
    g = jm.geom
    C = TMM._atlas_channels(kind, 6)
    rng = np.random.default_rng(9)
    level = rng.uniform(-12, 2, (g.n_planes, g.n_tiles_h, g.n_tiles_w))
    sy, sx = g.tile_span
    alpha = np.repeat(np.repeat(level, int(np.ceil(sy)) + 1, 1),
                      int(np.ceil(sx)) + 1, 2)[:, :g.mpi_h, :g.mpi_w]
    atlas = rng.normal(size=(g.n_planes, g.mpi_h, g.mpi_w, C))
    atlas[..., -1] = alpha
    atlas[..., 0] = -10.0          # channel 0 would cull everything
    p = {"atlas": atlas.astype(np.float32)}
    j = JSP.tile_cull(p, g, JACT["sigmoid"], 0, 0.3)
    t = TSP.tile_cull(p, tm.geom, TACT["sigmoid"], 0, 0.3)
    for k in ("tile_map_static", "tile_map_dyn", "static_tiles",
              "dyn_tiles"):
        np.testing.assert_array_equal(t[k], j[k])
    assert 0 < t["keep_frac"] < 1 and t["static_tiles"].shape[-1] == C


@pytest.mark.parametrize("kind", ["rgb_sh", "rgba_sh"])
def test_sh_checkpoints_load_across_packages(kind, tmp_path):
    """A stage-1 SH checkpoint written by either package loads in the
    other with its decoder type, and renders the same (1e-5)."""
    argv = STEP_ARGV + ["--rgb_mlp_type", kind]
    ja, ta, jm, tm, p, _ = _step_setup(argv, "dense")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JS1.save_stage1_checkpoint(jpath, jm, jax.tree.map(jnp.asarray, p), 4)
    TS1.save_stage1_checkpoint(tpath, tm, tck.params_from_numpy(p, CPU), 4)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    for src in (jpath, tpath):
        j = jck.load_checkpoint(src)
        t = tck.load_checkpoint(src)
        assert j["meta"]["extra"]["rgb_mlp_type"] == kind
        assert t["meta"]["extra"]["rgb_mlp_type"] == kind
        _, ta2, jm2, tm2 = _model_pair(STEP_ARGV)       # args say direct
        _, tmeta = TS1._load_into_model(tm2, src)
        assert tm2.cfg.rgb_mlp_type == kind
        jm2.cfg = jm.cfg
        jr = jm2.forward({k: jnp.asarray(v) for k, v in j["params"].items()},
                         H, W, jnp.asarray(ext), jnp.asarray(INTRIN[None]))[0]
        with torch.no_grad():
            tr = tm2.forward(tck.params_from_numpy(t["params"], CPU), H, W,
                             ext, INTRIN[None])[0]
        _close(tr.numpy(), jr)


def test_decoder_checkpoints(tmp_path):
    """Reference-side behaviour: JAX writes a nex_rgb decoder as a pickled
    object array that its own loader refuses; the port writes the leaves
    as plain arrays and reads them back into the nested dict."""
    argv = STEP_ARGV + ["--rgb_mlp_type", "nex_rgb", "--atlas_cnl", "8"]
    ja, ta, jm, tm, p, _ = _step_setup(argv, "dense")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JS1.save_stage1_checkpoint(jpath, jm, jax.tree.map(jnp.asarray, p), 0)
    for load in (jck.load_checkpoint, tck.load_checkpoint):
        with pytest.raises(ValueError, match="allow_pickle"):
            load(jpath)
    TS1.save_stage1_checkpoint(tpath, tm, tck.params_from_numpy(p, CPU), 0)
    t = tck.load_checkpoint(tpath)
    assert set(t["params"]["decoder"]) == {"l0", "l1"}
    for k, v in tck.flat_params(p).items():
        np.testing.assert_array_equal(tck.flat_params(t["params"])[k], v)
    assert "decoder/l0/w" in t["meta"]["param_keys"]
