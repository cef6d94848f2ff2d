"""The stage-1 modules of the PyTorch port against the JAX package, on the
CPU: video helpers, the loopable mask, the patch dataset and its cache,
the regularizers, the composite's gradient, the optimizer, MPMesh's
parameters and eval render, checkpoints both ways, and what the stage-1
trainer refuses at start-up."""
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import loopmask as JL
from videoloop3d_tpu.data import patches as JP
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.data import video as JV
from videoloop3d_tpu.losses import regularizers as JREG
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.render import renderer as JR
from videoloop3d_tpu.train import common as JC
from videoloop3d_tpu.train import optimizer as JO
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.data import loopmask as TL
from videoloop3d_torch.data import patches as TP
from videoloop3d_torch.data import video as TV
from videoloop3d_torch.losses import regularizers as TREG
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models.mpmesh import MPMesh as TorchMPMesh
from videoloop3d_torch.render import renderer as TR
from videoloop3d_torch.tools import train_3d
from videoloop3d_torch.train import common as TC
from videoloop3d_torch.train import optimizer as TO

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scene():
    return jsyn.make_scene(n_views=3, h=24, w=32, n_frames=6, seed=0)


def _u8(videos):
    return [(np.asarray(v) * 255).astype(np.uint8) for v in videos]


@pytest.mark.parametrize("mode", ["average", "median", "first", "dynamic",
                                  "dynamic0.5", "blur5"])
def test_video_helpers_match_jax(scene, mode):
    vid = np.asarray(scene["videos"][0], np.float32)
    np.testing.assert_array_equal(TV.collapse_video(vid, mode),
                                  JV.collapse_video(vid, mode))
    u8 = _u8(scene["videos"])[1]
    np.testing.assert_array_equal(TV.resize_video(u8, 17, 21),
                                  JV.resize_video(u8, 17, 21))
    np.testing.assert_array_equal(TV._bilinear_resize_np(u8, 13, 40),
                                  JV._bilinear_resize_np(u8, 13, 40))
    img = (vid[0] * 255).astype(np.uint8)
    np.testing.assert_array_equal(TV.gaussian_blur(img, 5),
                                  JV.gaussian_blur(img, 5))


def test_loopable_mask_matches_jax(scene):
    vid = np.asarray(scene["videos"][1], np.float32)
    t, j = TL.compute_loopable_mask(vid), JL.compute_loopable_mask(vid)
    np.testing.assert_array_equal(t, j)
    assert 0 < t.mean() < 1


def test_image_patch_dataset_matches_jax(scene, tmp_path):
    """Images, masks, origins, pad, intrinsics and items equal JAX's; the
    port's cache (keyed on the pad and a sha256 of the video) returns the
    same arrays."""
    videos = _u8(scene["videos"])
    args = ((24, 32), videos, (12, 16), (8, 12), scene["poses"],
            scene["intrins"], "dynamic")
    jd = JP.ImagePatchDataset(*args)
    td = TP.ImagePatchDataset(*args, cache_dir=str(tmp_path / "c"))
    cached = TP.ImagePatchDataset(*args, cache_dir=str(tmp_path / "c"))
    names = sorted(os.listdir(tmp_path / "c"))
    assert len(names) == 3 and all("pad" in n for n in names)
    assert td.pad == jd.pad == (4, 8) and td.patch_size == jd.patch_size
    np.testing.assert_array_equal(td.origins, jd.origins)
    np.testing.assert_array_equal(td.intrins, jd.intrins)
    assert len(td) == len(jd) == 27
    for a, b, c in zip(td.images + td.masks, jd.images + jd.masks,
                       cached.images + cached.masks):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    for i in (0, 13, 26):
        ti, ji = td[i], jd[i]
        assert ti["wh_start"] == ji["wh_start"] and ti["view"] == ji["view"]
        for k in ("pose", "intrin", "rgb", "loopmask"):
            np.testing.assert_array_equal(ti[k], ji[k])
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    order_t = [it["view"] for it in td.iter_epoch(r1)]
    order_j = [it["view"] for it in jd.iter_epoch(r2)]
    assert order_t == order_j
    np.testing.assert_array_equal(
        TC.jitter_intrinsic(jd[3]["intrin"], r1),
        JC.jitter_intrinsic(jd[3]["intrin"], r2))


def test_regularizers_match_jax():
    """Values to 1e-6 relative, gradients to 1e-5 * max|g|."""
    rng = np.random.default_rng(0)
    alpha = rng.random((2, 5, 7, 9)).astype(np.float32)
    rgb_p = rng.random((2, 5, 7, 9, 3)).astype(np.float32)
    disp = rng.random((2, 7, 9)).astype(np.float32)
    rgb = rng.random((2, 7, 9, 3)).astype(np.float32) * 0.1
    cases = [
        ("sparsity", lambda R, a: R.sparsity_loss(a, 5), alpha),
        ("content", lambda R, a: R.content_smooth_loss(a), rgb_p),
        ("content_a", lambda R, a: R.content_smooth_loss(a[..., None]),
         alpha),
        ("depth", lambda R, a: R.depth_smooth_loss(a), disp),
        ("depth_edge", lambda R, a: R.depth_smooth_loss(a, R_rgb[R], 4.0),
         disp),
        ("density", lambda R, a: R.density_loss(a.sum(1)), alpha),
    ]
    R_rgb = {JREG: jnp.asarray(rgb), TREG: torch.from_numpy(rgb)}
    for name, fn, x in cases:
        jv, jg = jax.value_and_grad(lambda a: fn(JREG, a))(jnp.asarray(x))
        t = torch.tensor(x, requires_grad=True)
        tv = fn(TREG, t)
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6,
                                   err_msg=name)
        jg = np.asarray(jg)
        assert np.abs(t.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max(), \
            name


def test_sparsity_of_an_empty_stack_matches_jax():
    """An all-zero alpha stack clamps its L2 norm to eps (value only: the
    gradient of sqrt at 0 is not finite in either package)."""
    alpha = np.random.default_rng(5).random((1, 4, 3, 3)).astype(np.float32)
    alpha[0, :, 1, 1] = 0.0
    np.testing.assert_allclose(
        float(TREG.sparsity_loss(torch.from_numpy(alpha), 4)),
        float(JREG.sparsity_loss(jnp.asarray(alpha), 4)), rtol=1e-6)


def test_composite_planes_gradient_matches_jax():
    """composite_planes' values and gradients equal JAX's, also where an
    alpha is exactly 1 (1 - alpha = 0 in the cumulative product)."""
    rng = np.random.default_rng(1)
    alpha = rng.random((2, 6, 5, 7)).astype(np.float32)
    alpha[:, 3, 1:3, 2:4] = 1.0
    alpha[:, 5, 4, :] = 1.0
    content = rng.random((2, 6, 5, 7, 3)).astype(np.float32)
    c1 = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    c2 = rng.standard_normal((2, 6, 5, 7)).astype(np.float32)

    def jloss(a, c):
        out, w = JR.composite_planes(a, c)
        return jnp.sum(out * c1) + jnp.sum(w * c2)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(alpha),
                                         jnp.asarray(content))
    ta = torch.tensor(alpha, requires_grad=True)
    tc = torch.tensor(content, requires_grad=True)
    out, w = TR.composite_planes(ta, tc)
    ((out * torch.from_numpy(c1)).sum()
     + (w * torch.from_numpy(c2)).sum()).backward()
    jout, jw = JR.composite_planes(jnp.asarray(alpha), jnp.asarray(content))
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= 1e-6
    for t, j in ((ta, jg[0]), (tc, jg[1])):
        j = np.asarray(j)
        assert np.isfinite(t.grad.numpy()).all()
        assert np.abs(t.grad.numpy() - j).max() <= 1e-5 * np.abs(j).max()


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_matches_jax(name):
    """Three steps with a decaying lr and a verts group at 0.1x gain:
    the parameters agree to 1e-6."""
    rng = np.random.default_rng(2)
    p0 = {"atlas": rng.standard_normal((4, 3)).astype(np.float32),
          "verts": rng.standard_normal((5, 3)).astype(np.float32)}
    group = TO.make_group_fn(0.1)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = TO.make_optimizer(name, tp, group)
    init, update = JO.make_optimizer(name, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = init(jp)
    for step in range(3):
        lr = TO.lr_schedule(step * 700, 0.05, decay_steps_k=1)
        assert lr == JO.lr_schedule(step * 700, 0.05, decay_steps_k=1)
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p0.items()}
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        TO.set_lr(opt, lr)
        opt.step()
        jp, state = update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           state, JO.build_lr_tree(jp, lr, group))
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, err_msg=k)


def _model_argv(**over):
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
            "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
            "--learn_loop_mask", "--normalize_verts",
            "--sparsity_loss_weight", "0.1"]
    for k, v in over.items():
        argv += [f"--{k}"] if v is None else [f"--{k}", str(v)]
    return argv


def _models(**over):
    argv = _model_argv(**over)
    intrin = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    ref = np.eye(4, dtype=np.float32)
    ref[:3, 3] = [0.02, -0.01, 0.03]
    jm = JaxMPMesh(jax_parse(argv), 24, 32, ref, intrin, 1.5, 6.0)
    tm = TorchMPMesh(torch_parse(argv), 24, 32, ref, intrin, 1.5, 6.0,
                     device=CPU)
    return jm, tm, intrin


def test_mpmesh_init_params_match_jax():
    jm, tm, _ = _models()
    jp, tp = jm.init_params(7), tm.init_params(7)
    assert set(tp) == set(jp) == {"atlas", "verts", "atlas_mask"}
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def _random_params(jm, seed):
    p = {k: np.asarray(v) for k, v in jm.init_params(seed).items()}
    rng = np.random.default_rng(seed)
    p["atlas"] = rng.standard_normal(p["atlas"].shape).astype(np.float32)
    p["atlas_mask"] = rng.standard_normal(
        p["atlas_mask"].shape).astype(np.float32)
    return p


def _eval_render(jm, tm, jparams, tparams):
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, :3, 3] = [0.1, -0.05, 0.02]
    intr = np.array([[[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]], np.float32)
    jr = jm.forward(jparams, 24, 32, jnp.asarray(ext), jnp.asarray(intr))[0]
    with torch.no_grad():
        tr = tm.forward(tparams, 24, 32, ext, intr)[0]
    return np.asarray(jr), tr.numpy()


def test_checkpoint_written_by_port_loads_and_renders_in_jax(tmp_path):
    """A port-written dense stage-1 checkpoint loads in JAX's
    load_checkpoint with identical arrays and metadata, and JAX's dense
    eval render of it equals the port's within 1e-5."""
    from videoloop3d_torch.train import stage1 as TS1
    jm, tm, _ = _models()
    params = tck.params_from_numpy(_random_params(jm, 4), CPU)
    path = str(tmp_path / "ckpt_epoch_0003.npz")
    TS1.save_stage1_checkpoint(path, tm, params, 3)
    loaded = jck.load_checkpoint(path)
    assert loaded["meta"]["stage"] == "mpi" and not loaded["meta"]["is_sparse"]
    assert loaded["meta"]["extra"]["epoch_i"] == 3
    assert loaded["geom"].__dict__ == tm.geom.__dict__
    for k, v in params.items():
        np.testing.assert_array_equal(loaded["params"][k], v.numpy())
    jparams = {k: jnp.asarray(v) for k, v in loaded["params"].items()}
    tparams = tck.params_from_numpy(tck.load_checkpoint(path)["params"], CPU)
    jr, tr = _eval_render(jm, tm, jparams, tparams)
    assert jr.shape == tr.shape == (1, 24, 32, 4)
    assert np.abs(tr - jr).max() <= 1e-5 and jr.std() > 0.01


OUT_OF_SCOPE = {
    "direct2sh": (["--direct2sh_epoch", "0"], None),
    "shard_views": (["--shard_views"], None),
    "two_devices": (["--mesh_devices", "2"], "world"),
    "sh_decoder": (["--rgb_mlp_type", "rgb_sh"], None),
}


def _refusal_argv(tmp_path):
    return ["--datadir", str(tmp_path / "missing"), "--expdir",
            str(tmp_path / "exp"), "--expname", "x", "--N_iters", "3",
            "--gpu_num", "0", "--mesh_devices", "1"]


@pytest.mark.parametrize("case", list(OUT_OF_SCOPE))
def test_train_3d_refuses_what_is_not_ported(case, tmp_path):
    """Every option of the JAX package is ported: the decoders, the
    direct -> SH conversion and --shard_views (item None) pass the
    start-up check and the run fails on the missing data directory.
    --mesh_devices 2 in one process (item "world") raises the world-size
    mismatch, a ValueError, before any work."""
    extra, item = OUT_OF_SCOPE[case]
    if item is None:
        with pytest.raises(FileNotFoundError, match="missing"):
            train_3d.main(_refusal_argv(tmp_path) + extra)
        return
    with pytest.raises(ValueError, match="does not match the 1 process"):
        train_3d.main(_refusal_argv(tmp_path) + extra)
    assert not os.path.exists(tmp_path / "exp" / "x" / "metrics.jsonl")


@pytest.mark.parametrize("case", ["culling", "sparse_resume"])
def test_train_3d_accepts_the_sparse_phase(case, tmp_path):
    """Tile culling (--sparsify_epoch below --N_iters) and a sparse
    checkpoint to resume pass the start-up check; the run then stops at
    the missing data directory, not at a refusal."""
    from videoloop3d_torch.train import stage1 as TS1
    argv = _refusal_argv(tmp_path)
    if case == "culling":
        argv += ["--sparsify_epoch", "1"]
    else:
        jm, _, _ = _models()
        jck.save_checkpoint(str(tmp_path / "exp" / "x" / "ckpt_epoch_0001.npz"),
                            geom=jm.geom, params={"atlas": np.zeros(3)},
                            stage="mpi", is_sparse=True)
    TS1.check_supported(torch_parse(argv))
    with pytest.raises(FileNotFoundError):
        train_3d.main(argv)


def test_train_3d_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    """Without --gpu_num 0 the trainer takes cuda:0 and raises where there
    is none; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--datadir", str(tmp_path / "missing"), "--expdir",
            str(tmp_path / "exp"), "--N_iters", "3", "--mesh_devices", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_3d.main(argv)


def test_hang_watchdog_fires_without_ticks():
    """No tick for longer than the timeout runs the watchdog's action
    (exit 42 by default); ticks keep it quiet."""
    fired = []
    dog = TC.HangWatchdog(0.5, "test", action=fired.append)
    for _ in range(8):
        dog.tick()
        time.sleep(0.05)
    assert not fired
    time.sleep(1.5)
    dog.stop()
    assert len(fired) == 1 and fired[0] > 0.5
    assert TC.HangWatchdog.EXIT_CODE == 42
