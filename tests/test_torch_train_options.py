"""The training options ``--add_uv_noise`` and ``--bg_color random`` of the
PyTorch port against the JAX package, on the CPU: the stage-1 loss (dense
on both composite routes, and sparse) and the stage-2 loss (sparse on
the unfused and the shipped route, and dense), each with its gradients,
from the same draws.  The port cannot reproduce JAX's RNG streams, so
each JAX loss takes a key and the port the draws that JAX's renders make
from it (`_jax_draws` splits the key as ``render/renderer.py:
add_texel_noise`` and ``models/mpmesh.py:parse_bg_color`` do).  Also the
draws the trainers make from their torch.Generator, both trainers from
the command line with the options on, the regularizers' |.| at 0, and
``read_fps`` with a stubbed ``cv2``."""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_stage1_parts as S1P
import test_torch_stage1_sparse as S1S
import test_torch_stage2_shipped as S2S
from test_torch_stage2_dense import _dargv, _series, root  # noqa: F401
from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.data import video as JV
from videoloop3d_tpu.losses import regularizers as JREG
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.render import compact as JC
from videoloop3d_tpu.train import stage1 as JS1
from videoloop3d_tpu.train import stage2 as JS2
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.data import video as TV
from videoloop3d_torch.losses import regularizers as TREG
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models.mpmesh import training_draws
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPMeshVid
from videoloop3d_torch.tools import train_3d, train_3dvid
from videoloop3d_torch.train import stage1 as TS1
from videoloop3d_torch.train import stage2 as TS2

CPU = torch.device("cpu")
OPTIONS = {"uv_bg": ["--add_uv_noise", "--bg_color", "random"],
           "uv": ["--add_uv_noise"],
           "bg": ["--bg_color", "random"]}


def _jax_draws(key, shape, uv, bg):
    """The draws a JAX training render makes from key: the uv noise
    (B, D, h, w) x 2 from the first split's subkey, then the background
    from what is left."""
    draws = {}
    if uv:
        key, sub = jax.random.split(key)
        kx, ky = jax.random.split(sub)
        draws["uv"] = tuple(torch.from_numpy(np.asarray(jax.random.uniform(
            k, shape, minval=-1.0, maxval=1.0))) for k in (kx, ky))
    if bg:
        draws["bg"] = torch.from_numpy(np.asarray(
            jax.random.uniform(key, (3,))))
    return draws


def _set_option(option, *models):
    for m in models:
        m.cfg = dataclasses.replace(
            m.cfg, add_uv_noise="uv" in option,
            bg_color="random" if "bg" in option else "")


def _compare(jmet, jg, tmet, tp, keys, rtol=1e-5, gtol=1e-5):
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=rtol,
                                   err_msg=k)
    for k in keys:
        a = np.asarray(jg[k])
        assert np.abs(a).max() > 0
        diff = np.abs(tp[k].grad.numpy() - a).max()
        assert diff <= gtol * np.abs(a).max(), k


def _stage1_case(route):
    """(ja, ta, jm, tm, params, batch, (h, w)) of a stage-1 loss: dense on
    the unfused or the fused composite, or sparse."""
    if route == "sparse":
        return S1S._sparse_models(False)
    over = {"fused_render": None} if route == "dense_fused" else {}
    argv = S1P._model_argv(**over, scale_invariant=None,
                           a_smooth_loss_weight=0.2,
                           d_smooth_loss_weight=0.1,
                           density_loss_weight=0.05)
    jm, tm, intrin = S1P._models(**over, scale_invariant=None,
                                 a_smooth_loss_weight=0.2,
                                 d_smooth_loss_weight=0.1,
                                 density_loss_weight=0.05)
    p = S1P._random_params(jm, 3)
    rng = np.random.default_rng(4)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    batch = {"extrin": ext, "intrin": intrin[None].copy(),
             "rgb": rng.random((1, 24, 32, 3), dtype=np.float32),
             "loopmask": (rng.random((1, 24, 32)) < 0.5).astype(np.float32)}
    return (jax_parse(argv), torch_parse(argv), jm, tm, p, batch, (24, 32))


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("route", ["dense", "dense_fused", "sparse"])
def test_stage1_options_match_jax(route, option):
    """The stage-1 loss under the option (the JAX loss with a key, the port
    with JAX's draws from it): metrics within 1e-5 relative, the atlas
    gradients within 1e-5 * max|g|; the uv noise moves the loss."""
    ja, ta, jm, tm, p, batch, (h, w) = _stage1_case(route)
    _set_option(option, jm, tm)
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(key, (1, jm.geom.n_planes, h, w), "uv" in option,
                       "bg" in option)
    weights = {k: 0.3 for k in JS1.STAGE1_WEIGHT_KEYS}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = JS1.make_stage1_loss_fn(jm, ja, h, w)
    (_, jmet), jg = jax.value_and_grad(
        lambda q: jloss(q, jb, weights, key), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()})
    tp = tck.params_from_numpy(p, CPU)
    for t in tp.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss = TS1.make_stage1_loss_fn(tm, ta, h, w)
    total, tmet = tloss(tp, dict(tb, draws=draws), weights)
    total.backward()
    keys = ("atlas", "atlas_dyn") if route == "sparse" else ("atlas",)
    _compare(jmet, jg, tmet, tp, keys)
    if "uv" in option:
        still, _ = tloss(tp, dict(tb, draws={k: v for k, v in draws.items()
                                             if k == "bg"}), weights)
        assert abs(float(still) - float(total)) > 1e-6


def _stage2_case(route):
    """(ja, ta, jm, jp, tm, tp, argv) of a stage-2 loss: sparse on the
    unfused or the shipped route (the slot bound below D), or dense."""
    if route != "dense":
        extra = S2S.SHIPPED if route == "shipped" else []
        jm, jp, tm, tp = S2S._pair(extra)
        argv = S2S._model_argv(extra)
        if route == "shipped":
            ext, intr = S2S._view()
            S = JC.slot_bound(jm.geom, jm.tile_map_static, jm.tile_map_dyn,
                              ext, intr, S2S.H, S2S.W)
            assert S < jm.geom.n_planes
            jm.compact_slots = tm.compact_slots = S
        return jax_parse(argv), torch_parse(argv), jm, jp, tm, tp, argv
    argv = S2S._model_argv()
    ja, ta = jax_parse(argv), torch_parse(argv)
    jm = JaxMPMeshVid(ja, S2S.H, S2S.W, np.eye(4, dtype=np.float32),
                      S2S.INTRIN, 1.5, 6.0)
    tm = TorchMPMeshVid(ta, S2S.H, S2S.W, np.eye(4, dtype=np.float32),
                        S2S.INTRIN, 1.5, 6.0, device=CPU)
    g = jm.geom
    rng = np.random.default_rng(12)
    dyn = rng.standard_normal((g.n_planes, g.mpi_h, g.mpi_w, S2S.FRM, 4))
    dyn[..., 3] = rng.uniform(-4.0, 2.0, dyn.shape[:4])
    p = {"atlas": np.zeros((0, 1, 1, 4), np.float32),
         "atlas_dyn": dyn.astype(np.float32),
         "verts": g.vertex_grid().astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = tck.params_from_numpy(p, CPU)
    return ja, ta, jm, jp, tm, tp, argv


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("route", ["unfused", "shipped", "dense"])
def test_stage2_options_match_jax(route, option):
    """The stage-2 loss (GPNN at alpha off and every regularizer) under
    the option, as in test_stage1_options_match_jax: metrics within 2e-5
    relative and the gradients within 2e-5 * max|g| (the tolerance of
    test_torch_stage2_shipped's routes); the uv noise moves the loss.
    Under PRNGKey(5) one neighbour difference of the dense render's
    rgb_smooth term lies within the packages' roundoff of 0, where |.|
    takes the other sign in each package and moves 5 texel gradients by
    2e-3 * max|g|; key 6 has no such tie."""
    ja, ta, jm, jp, tm, tp, argv = _stage2_case(route)
    _set_option(option, jm, tm)
    ext, intr = S2S._view()
    key = jax.random.PRNGKey(6)
    draws = _jax_draws(key, (1, jm.geom.n_planes, S2S.H, S2S.W),
                       "uv" in option, "bg" in option)
    video = np.random.default_rng(3).random(
        (S2S.FRM, S2S.H, S2S.W, 3)).astype(np.float32)
    batch = {"extrin": ext, "intrin": intr, "video": video}
    weights = {k: 0.3 for k in TS2.STAGE2_WEIGHT_KEYS}
    cfg = JS2.loss_config_from_args(ja, ref=False)
    jloss = JS2.make_patch_loss_fn(jm, ja, S2S.H, S2S.W, cfg)
    (_, jmet), jg = jax.value_and_grad(
        lambda q: jloss(q, {k: jnp.asarray(v) for k, v in batch.items()},
                        {k: jnp.asarray(v, jnp.float32)
                         for k, v in weights.items()}, key),
        has_aux=True)(jp)
    for t in tp.values():
        t.requires_grad_(True)
    tloss = TS2.make_patch_loss_fn(tm, ta, S2S.H, S2S.W, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, tmet = tloss(tp, dict(tb, draws=draws), weights)
    total.backward()
    keys = ("atlas_dyn",) if route == "dense" else ("atlas", "atlas_dyn")
    _compare(jmet, jg, tmet, tp, keys, rtol=2e-5, gtol=2e-5)
    if "uv" in option:
        still, _ = tloss(tp, dict(tb, draws={k: v for k, v in draws.items()
                                             if k == "bg"}), weights)
        assert abs(float(still) - float(total)) > 1e-6


def test_training_draws_from_the_generator():
    """The trainers' draws (`training_draws`): per option, uv noise in
    [-1, 1) of the sweep's shape and a colour in [0, 1), in that order
    from the generator; none without options or without a generator; a
    random background without draws raises."""
    argv = S2S._model_argv(OPTIONS["uv_bg"])
    tm = TorchMPMeshVid(torch_parse(argv), S2S.H, S2S.W, np.eye(4),
                        S2S.INTRIN, 1.5, 6.0, device=CPU)
    shape = (1, 10, 6, 7)
    gen = torch.Generator().manual_seed(4)
    d = training_draws(tm.cfg, gen, shape)
    assert set(d) == {"uv", "bg"} and d["bg"].shape == (3,)
    for n in d["uv"]:
        assert n.shape == shape and n.dtype == torch.float32
        assert -1.0 <= float(n.min()) and float(n.max()) < 1.0
    assert 0.0 <= float(d["bg"].min()) and float(d["bg"].max()) < 1.0
    again = training_draws(tm.cfg, torch.Generator().manual_seed(4), shape)
    assert torch.equal(again["uv"][1], d["uv"][1])
    assert training_draws(tm.cfg, None, shape) == {}
    with pytest.raises(ValueError, match="random"):
        tm.render({}, 6, 7, np.eye(4)[None], S2S.INTRIN[None], None,
                  training=True)
    plain = TorchMPMeshVid(torch_parse(S2S._model_argv()), S2S.H, S2S.W,
                           np.eye(4), S2S.INTRIN, 1.5, 6.0, device=CPU)
    assert training_draws(plain.cfg, gen, shape) == {}


def test_train_3dvid_with_options(root):  # noqa: F811
    """train_3dvid from scratch over the two levels with --add_uv_noise
    --bg_color random: finite losses, and a run of its own seed gives the
    same series again (the draws come from the --seed generator)."""
    extra = OPTIONS["uv_bg"]
    series = []
    for exp in ("opt_a", "opt_b"):
        _, _, rundir = train_3dvid.main(_dargv(root, exp, extra))
        series.append(_series(rundir, "loss"))
    assert [s for s, _ in series[0]] == list(range(6))
    assert np.isfinite([v for _, v in series[0]]).all()
    assert series[0] == series[1]


def test_train_3d_with_options(tmp_path, monkeypatch):
    """train_3d with --add_uv_noise --bg_color random through its two
    dense epochs, the cull and a sparse epoch: finite losses."""
    monkeypatch.setenv("VL3D_DATA_CACHE", "off")
    root = str(tmp_path)
    scene = jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)
    jsyn.write_llff_dir(scene, os.path.join(root, "scene"), factor=1)
    model, _, rundir = train_3d.main(S1S._argv(
        root, "opt", 3, ["--sparsify_epoch", "2", "--sparsify_alpha_thresh",
                         "0.0"] + OPTIONS["uv_bg"]))
    loss = S1S._series(rundir, "loss")
    assert len(loss) == 9 and np.isfinite([v for _, v in loss]).all()
    assert model.is_sparse


def test_regularizer_abs_at_zero_matches_jax():
    """The regularizers' |.| has jnp.abs's derivative +1 at 0 (torch.abs
    has 0): equal neighbours, as a scratch stage-2 start makes them, give
    JAX's gradients."""
    x = np.zeros((2, 3, 4, 5, 3), np.float32)
    x[0, 1] = 0.5
    disp = np.zeros((2, 4, 5), np.float32)
    disp[1, :, 2:] = 0.25
    jg = jax.grad(lambda a, d: JREG.content_smooth_loss(a)
                  + JREG.depth_smooth_loss(d) + JREG.density_loss(d + 1.0),
                  argnums=(0, 1))(jnp.asarray(x), jnp.asarray(disp))
    tx = torch.from_numpy(x).requires_grad_(True)
    td = torch.from_numpy(disp).requires_grad_(True)
    (TREG.content_smooth_loss(tx) + TREG.depth_smooth_loss(td)
     + TREG.density_loss(td + 1.0)).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=1e-7)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg[1]), atol=1e-7)
    assert np.abs(np.asarray(jg[0])).max() > 0


class _StubCapture:
    def __init__(self, fps):
        self.fps, self.released = fps, False

    def get(self, prop):
        assert prop == "fps"
        return self.fps

    def release(self):
        self.released = True


@pytest.mark.parametrize("fps", [29.97, 0.0])
def test_read_fps_matches_jax_with_a_stubbed_cv2(fps, monkeypatch):
    """read_fps through a stubbed cv2 (a container reporting 29.97 fps, or
    none): the JAX package's value (29, or the default 25), the capture
    released; .npy stacks and a missing cv2 give the default."""
    caps = []

    class Cv2:
        CAP_PROP_FPS = "fps"

        @staticmethod
        def VideoCapture(path):
            caps.append(_StubCapture(fps))
            return caps[-1]

    for mod in (JV, TV):
        monkeypatch.setattr(mod, "cv2", Cv2)
        monkeypatch.setattr(mod, "_HAS_CV2", True)
    got = TV.read_fps("scene/video.mp4")
    assert got == JV.read_fps("scene/video.mp4") == (29 if fps else 25)
    assert all(c.released for c in caps) and len(caps) == 2
    assert TV.read_fps("scene/video.npy") == 25
    monkeypatch.setattr(TV, "_HAS_CV2", False)
    assert TV.read_fps("scene/video.mp4", default=30) == 30
