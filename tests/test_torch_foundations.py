"""Foundations of the PyTorch port against the JAX package, on the CPU:
configs, plane geometry, checkpoints in both directions, the LLFF loader,
the synthetic production MTV, device selection, and that the port
imports without JAX."""
import glob
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core import planes as jplanes
from videoloop3d_tpu.data import llff as jllff
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPV
from videoloop3d_torch.backend import device_from_args
from videoloop3d_torch.config import parse_args_with_configs as torch_parse
from videoloop3d_torch.core import planes as tplanes
from videoloop3d_torch.data import llff as tllff
from videoloop3d_torch.data import synthetic as tsyn
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models.geometry import MPIGeometry as TorchGeom
from videoloop3d_torch.models.mpv import MPMeshVid as TorchMPV

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.txt"),
                           recursive=True))


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_config_parses_like_jax(path):
    argv = ["--config", path, "--expname", "x"]
    assert vars(torch_parse(argv)) == vars(jax_parse(argv))


def test_two_level_config_and_cli_override_like_jax():
    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--config1", os.path.join(REPO, "configs", "mpvs", "usttap.txt"),
            "--mpi_d", "7", "--fp16"]
    assert vars(torch_parse(argv)) == vars(jax_parse(argv))


def _args(**over):
    argv = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.1",
            "--mpi_h_verts", "4", "--mpi_w_verts", "6", "--mpi_d", "9",
            "--mpv_frm_num", "5"]
    for k, v in over.items():
        argv += [f"--{k}", str(v)]
    return jax_parse(argv), torch_parse(argv)


def test_geometry_and_homographies_match_jax():
    """make_depths and MPIGeometry are exact (same numpy code);
    plane_homographies agree to 1e-5 relative (f32 matrix products whose
    rounding order may differ)."""
    ja, ta = _args()
    intrin = np.array([[28.0, 0, 16], [0, 29.0, 12], [0, 0, 1]], np.float32)
    ref_ext = np.eye(4, dtype=np.float32)
    jg = JaxMPV(ja, 24, 32, ref_ext, intrin, 1.5, 6.0).geom
    tg = TorchGeom.create(ta, 24, 32, ref_ext, intrin, 1.5, 6.0)
    assert tg.__dict__ == jg.__dict__
    assert tg.tile_span == jg.tile_span
    assert tg.default_tile_texels() == jg.default_tile_texels()
    np.testing.assert_array_equal(tg.vertex_grid(), jg.vertex_grid())
    assert tg.scaled(20, 30).__dict__ == jg.scaled(20, 30).__dict__
    np.testing.assert_array_equal(tplanes.make_depths(9, 1.5, 6.0),
                                  jplanes.make_depths(9, 1.5, 6.0))

    rng = np.random.default_rng(0)
    exts = np.repeat(np.eye(4, dtype=np.float32)[None], 4, 0)
    for b in range(4):
        ang = rng.uniform(-0.2, 0.2)
        c, s = np.cos(ang), np.sin(ang)
        exts[b, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        exts[b, :3, 3] = rng.uniform(-0.3, 0.3, 3)
    intrs = np.repeat(intrin[None], 4, 0)
    jG = np.array(jplanes.plane_homographies(
        jg.depths_np(), jg.ref_intrin_mpi_np(), jnp.asarray(exts),
        jnp.asarray(intrs)))
    tG = tplanes.plane_homographies(tg.depths_np(), tg.ref_intrin_mpi_np(),
                                    torch.from_numpy(exts),
                                    torch.from_numpy(intrs)).numpy()
    np.testing.assert_allclose(tG, jG, rtol=1e-5, atol=1e-5 * np.abs(jG).max())
    jx, jy, jz = jplanes.warp_grid(jnp.asarray(jG), 24, 32)
    tx, ty, tz = tplanes.warp_grid(torch.from_numpy(jG), 24, 32)
    for a, b in ((jx, tx), (jy, ty), (jz, tz)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-4)


def _sparse_model(seed=5, frm=5):
    ja, ta = _args(mpv_frm_num=frm)
    intrin = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
    model = JaxMPV(ja, 24, 32, np.eye(4, dtype=np.float32), intrin, 1.5, 6.0)
    g = model.geom
    r = np.random.default_rng(seed).random((g.n_planes, g.n_tiles_h,
                                            g.n_tiles_w))
    tm_s = np.full(r.shape, -1, np.int32)
    tm_d = np.full(r.shape, -1, np.int32)
    tm_s[r < 0.4] = np.arange((r < 0.4).sum(), dtype=np.int32)
    tm_d[r > 0.7] = np.arange((r > 0.7).sum(), dtype=np.int32)
    th, tw = g.default_tile_texels()
    rng = np.random.default_rng(seed + 1)
    params = {
        "atlas": rng.standard_normal(
            ((r < 0.4).sum(), th, tw, 4)).astype(np.float32),
        "atlas_dyn": rng.standard_normal(
            ((r > 0.7).sum(), th, tw, frm, 4)).astype(np.float32)}
    meta = dict(geom=g, stage="mpv", is_sparse=True, has_dyn=True,
                tile_map_static=tm_s, tile_map_dyn=tm_d, tile_hw=(th, tw),
                frm_num=frm, extra_meta={"epoch_i": 3})
    return ja, ta, intrin, params, meta


def _render_both(ja, ta, intrin, path):
    """Render the checkpoint at `path` with both packages (f32)."""
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.1, -0.05, 0.02]
    ts = np.array([4, 1])
    jm = JaxMPV(ja, 24, 32, np.eye(4), intrin, 1.5, 6.0)
    jp = jm.restore_checkpoint(jck.load_checkpoint(path))
    jr, _ = jm.render(jp, 24, 32, jnp.asarray(ext)[None],
                      jnp.asarray(intrin)[None], jnp.asarray(ts))
    tm = TorchMPV(ta, 24, 32, np.eye(4), intrin, 1.5, 6.0, device=CPU)
    tp = tm.restore_checkpoint(tck.load_checkpoint(path))
    tr, variables = tm.render(tp, 24, 32, ext[None], intrin[None], ts)
    assert tuple(variables["alpha"].shape) == (24, 32, 2)
    return np.asarray(jr), tr.numpy()


def test_checkpoint_written_by_jax_loads_and_renders_in_port(tmp_path):
    """A JAX-written sparse mpv checkpoint restores in the port with the
    same arrays and metadata, and renders like the JAX model (1e-5: the
    sequential composite reassociates the cumprod chain)."""
    ja, ta, intrin, params, meta = _sparse_model()
    path = str(tmp_path / "ckpt_000.npz")
    jck.save_checkpoint(path, params=params, **meta)
    loaded = tck.load_checkpoint(path)
    assert loaded["meta"] == jck.load_checkpoint(path)["meta"]
    assert loaded["geom"] == TorchGeom(**meta["geom"].__dict__)
    tm = TorchMPV(ta, 24, 32, np.eye(4), intrin, 1.5, 6.0, device=CPU)
    tp = tm.restore_checkpoint(loaded)
    for k, v in params.items():
        np.testing.assert_array_equal(tp[k].numpy(), v)
    np.testing.assert_array_equal(tm.tile_map_dyn.numpy(),
                                  meta["tile_map_dyn"])
    assert tm.tile_hw == meta["tile_hw"] and tm.frm_num == 5
    jr, tr = _render_both(ja, ta, intrin, path)
    assert np.abs(tr - jr).max() <= 1e-5 and jr.std() > 0.01


def test_checkpoint_written_by_port_loads_in_jax(tmp_path):
    """The port's save_checkpoint (from device tensors) is read by the
    JAX package's loader with identical arrays and metadata."""
    ja, ta, intrin, params, meta = _sparse_model(seed=9)
    meta["geom"] = TorchGeom(**meta["geom"].__dict__)
    tparams = tck.params_from_numpy(params, CPU)
    path = str(tmp_path / "ckpt_001.npz")
    tck.save_checkpoint(path, params=tparams, **meta)
    assert not os.path.exists(path + ".tmp.npz")
    loaded = jck.load_checkpoint(path)
    assert loaded["meta"]["tile_hw"] == list(meta["tile_hw"])
    assert loaded["geom"].__dict__ == meta["geom"].__dict__
    for k, v in params.items():
        np.testing.assert_array_equal(loaded["params"][k], v)
    np.testing.assert_array_equal(loaded["tile_map_static"],
                                  meta["tile_map_static"])
    assert jck.latest_checkpoint(str(tmp_path)) == \
        tck.latest_checkpoint(str(tmp_path)) == path
    jr, tr = _render_both(ja, ta, intrin, path)
    assert np.abs(tr - jr).max() <= 1e-5


def test_llff_loader_and_scene_match_jax(tmp_path):
    """make_scene + write_llff_dir + load_mv_videos give identical arrays
    in both packages, and each package reads the other's directory."""
    js = jsyn.make_scene(n_views=3, h=12, w=16, n_frames=2, seed=1)
    ts = tsyn.make_scene(n_views=3, h=12, w=16, n_frames=2, seed=1)
    for k in ("videos", "poses", "intrins", "bds", "plane_intrin"):
        np.testing.assert_array_equal(ts[k], js[k])
    jsyn.write_llff_dir(js, str(tmp_path / "j"), factor=1)
    tsyn.write_llff_dir(ts, str(tmp_path / "t"), factor=1)
    kw = dict(factor=1, bd_factor=(0.9, 2.0), recenter=True,
              render_frames=7)
    jv, jfps, jscene = jllff.load_mv_videos(str(tmp_path / "t"), **kw)
    tv, tfps, tscene = tllff.load_mv_videos(str(tmp_path / "j"), **kw)
    assert jfps == tfps
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(a, b)
    for k in ("poses", "intrins", "bds", "render_poses", "render_intrins"):
        np.testing.assert_allclose(tscene[k], jscene[k], rtol=1e-6,
                                   atol=1e-6)
    assert tscene["hw"] == jscene["hw"] == (12, 16)


def test_sparse_mtv_matches_bench_setup():
    """make_sparse_mtv re-implements bench.py:build_bench_setup array for
    array (checked at the benchmark's quick size)."""
    import bench                     # repo root is on sys.path (conftest)

    model, _, params, _, _, _, info = bench.build_bench_setup(quick=True)
    mtv = tsyn.make_sparse_mtv(quick=True)
    assert mtv["geom"].__dict__ == model.geom.__dict__
    assert mtv["tile_hw"] == tuple(info["tile_hw"]) == model.tile_hw
    assert mtv["frm_num"] == info["frames"]
    np.testing.assert_array_equal(mtv["tile_map_static"],
                                  model.tile_map_static)
    np.testing.assert_array_equal(mtv["tile_map_dyn"], model.tile_map_dyn)
    for k in ("atlas", "atlas_dyn"):
        np.testing.assert_array_equal(mtv["params"][k],
                                      np.asarray(params[k]))


def test_device_from_args():
    _, ta = _args(gpu_num=0)
    assert device_from_args(ta) == torch.device("cpu")
    _, ta = _args(gpu_num=1)
    if torch.cuda.is_available():
        assert device_from_args(ta) == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_from_args(ta)


def test_port_imports_without_jax():
    """With jax made unimportable, every port module (the render and
    training CLIs, the stage-1 modules and the dense stage-2 phase's
    included) imports, and none of the JAX package is loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import videoloop3d_torch\n"
        "import videoloop3d_torch.tools.render_video\n"
        "for m in pkgutil.walk_packages(videoloop3d_torch.__path__,\n"
        "                               'videoloop3d_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('videoloop3d_tpu', 'jax')]\n"
        "assert not bad, bad\n"
        "for m in ('tools.train_3d', 'train.stage1', 'render.fused_s1',\n"
        "          'losses.regularizers', 'data.patches', 'export.objio',\n"
        "          'models.sparsify', 'models.mpv', 'render.sample',\n"
        "          'train.stage2', 'tools.train_3dvid', 'data.video'):\n"
        "    assert 'videoloop3d_torch.' + m in sys.modules, m\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
