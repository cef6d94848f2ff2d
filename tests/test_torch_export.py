"""The export slice of the PyTorch port against the JAX package, on the CPU:
`packing_grid`, the OBJ writers and reader, `export_mtv` and the
``export_mesh`` CLI on sparse mpv checkpoints written by either package.
Inputs are made with numpy and handed to both packages.

Tolerances: geometry.obj and meta.json text equal (the same numpy float64
arithmetic); the atlases within one u8 step, and differing on at most
0.1% of the texels (the sigmoid of the two frameworks may differ in its
last bit, which moves a texel across a quantization step).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.export import mesh_export as JX
from videoloop3d_tpu.export import objio as JO
from videoloop3d_tpu.models import checkpoint as jck
from videoloop3d_tpu.models.geometry import MPIGeometry as JGeom
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPV
from videoloop3d_tpu.tools import export_mesh as jexport
from videoloop3d_torch.export import mesh_export as TX
from videoloop3d_torch.export import objio as TO
from videoloop3d_torch.models import checkpoint as tck
from videoloop3d_torch.models.geometry import MPIGeometry as TGeom
from videoloop3d_torch.tools import export_mesh as texport


@pytest.mark.parametrize("n", [0, 1, 5, 12, 97, 4257, 9786])
def test_packing_grid_equals_jax(n):
    assert TX.packing_grid(n) == JX.packing_grid(n)


def test_objio_equals_jax(tmp_path):
    """normalize_uv, the multi-material writer (text) and load_obj."""
    rng = np.random.default_rng(0)
    uv = rng.uniform(-1, 1, (9, 2))
    np.testing.assert_array_equal(TO.normalize_uv(uv, 7, 11),
                                  JO.normalize_uv(uv, 7, 11))
    verts = rng.random((6, 3))
    faces = [np.array([[0, 1, 2]]), np.array([[3, 4, 5], [0, 2, 4]])]
    uvfaces = [np.array([[0, 1, 2]]), np.array([[2, 1, 0], [3, 4, 5]])]
    for mod, name in ((TO, "t.obj"), (JO, "j.obj")):
        mod.save_obj_multimaterial(str(tmp_path / name), verts, faces,
                                   uv[:6], uvfaces, ["a", "b"])
    text = (tmp_path / "t.obj").read_text()
    assert text == (tmp_path / "j.obj").read_text()
    for got, want in zip(TO.load_obj(str(tmp_path / "t.obj")),
                         JO.load_obj(str(tmp_path / "j.obj"))):
        np.testing.assert_array_equal(got, want)


def _read_image(path):
    """An atlas as written: png through imageio where it is installed,
    else the .npy fallback."""
    if os.path.exists(path + ".npy"):
        return np.load(path + ".npy")
    import imageio.v2 as imageio
    return imageio.imread(path)


def _assert_exports_match(tdir, jdir, n_frames):
    """geometry.obj and meta.json text equal; static.png and every
    dynamic frame within one u8 step on at most 0.1% of the texels."""
    for name in ("geometry.obj", "meta.json"):
        with open(os.path.join(tdir, name)) as a, \
                open(os.path.join(jdir, name)) as b:
            assert a.read() == b.read(), name
    names = ["static.png"] + [os.path.join("dynamic", f"{i:04d}.png")
                              for i in range(n_frames)]
    for name in names:
        t = _read_image(os.path.join(tdir, name)).astype(np.int16)
        j = _read_image(os.path.join(jdir, name)).astype(np.int16)
        assert t.shape == j.shape and t.shape[-1] == 4, name
        diff = np.abs(t - j)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
    assert not os.path.exists(os.path.join(tdir, "dynamic",
                                           f"{n_frames:04d}.png"))


def test_export_mtv_matches_jax(tmp_path):
    """export_mtv of a 2-plane geometry with alternating static and
    dynamic tiles (tests/test_eval_export.py's case) through both
    packages."""
    km = ((20.0, 0.0, 16.0), (0.0, 20.0, 12.0), (0.0, 0.0, 1.0))
    fields = dict(n_planes=2, mpi_h=25, mpi_w=31, n_tiles_h=2, n_tiles_w=3,
                  near=1.5, far=6.0, depths=(5.0, 2.0), ref_intrin_mpi=km,
                  ref_extrin=tuple(tuple(float(v) for v in r)
                                   for r in np.eye(4)))
    flat = np.arange(12)
    pack_s = np.full(12, -1, np.int32)
    pack_s[flat % 2 == 1] = np.arange(6)
    pack_d = np.full(12, -1, np.int32)
    pack_d[flat % 2 == 0] = np.arange(6)
    rng = np.random.default_rng(0)
    params = {"atlas": rng.normal(0, 2, (6, 5, 6, 4)).astype(np.float32),
              "atlas_dyn": rng.normal(0, 2, (6, 5, 6, 3, 4))
              .astype(np.float32)}
    meta = {"fov": 60.0, "near": 1.5, "far": 6.0, "up": [0, -1, 0],
            "lookat": [0, 0, 3.0], "limit": [1, 1, 1]}
    maps = (pack_s.reshape(2, 2, 3), pack_d.reshape(2, 2, 3))
    tdir = TX.export_mtv(str(tmp_path / "t"), TGeom(**fields), params,
                         *maps, meta)
    jdir = JX.export_mtv(str(tmp_path / "j"), JGeom(**fields), params,
                         *maps, meta)
    _assert_exports_match(tdir, jdir, 3)
    verts, _, faces, _ = TO.load_obj(os.path.join(tdir, "geometry.obj"))
    assert len(faces) == 2 * 12 and verts.shape[1] == 6
    assert np.all(np.diff(verts[faces[:, 0]][:, 2]) <= 1e-6)  # far to near
    # every activation of the JAX table is ported: exp rgb exports as JAX's
    tdir = TX.export_mtv(str(tmp_path / "x"), TGeom(**fields), params, *maps,
                         meta, rgb_activate="exp")
    jdir = JX.export_mtv(str(tmp_path / "jx"), JGeom(**fields), params,
                         *maps, meta, rgb_activate="exp")
    _assert_exports_match(tdir, jdir, 3)


H, W, D, F = 48, 64, 6, 5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 3-view synthetic scene and the geometry of a 6-plane model on it."""
    root = tmp_path_factory.mktemp("export")
    sc = jsyn.make_scene(n_views=3, h=H, w=W, n_frames=F, seed=0)
    jsyn.write_llff_dir(sc, str(root / "scene"), factor=1)
    intrin = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]],
                      np.float32)
    args = jax_parse(["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
                      "--mpi_h_verts", "4", "--mpi_w_verts", "5",
                      "--mpi_d", str(D), "--mpv_frm_num", str(F)])
    geom = JaxMPV(args, H, W, np.eye(4, dtype=np.float32), intrin, 1.5,
                  6.0).geom
    return root, geom


def _write_ckpt(path, writer, geom, seed, sparse=True):
    """A sparse (or dense) mpv checkpoint of random tiles, written by the
    JAX package or the port."""
    rng = np.random.default_rng(seed)
    r = rng.random((geom.n_planes, geom.n_tiles_h, geom.n_tiles_w))
    tm_s = np.full(r.shape, -1, np.int32)
    tm_d = np.full(r.shape, -1, np.int32)
    tm_s[r < 0.45] = np.arange((r < 0.45).sum(), dtype=np.int32)
    tm_d[r > 0.65] = np.arange((r > 0.65).sum(), dtype=np.int32)
    th, tw = geom.default_tile_texels()
    params = {"atlas": rng.normal(0, 2, ((r < 0.45).sum(), th, tw, 4))
              .astype(np.float32),
              "atlas_dyn": rng.normal(0, 2, ((r > 0.65).sum(), th, tw, F, 4))
              .astype(np.float32)}
    if writer == "torch":
        geom = tck.geom_from_meta(dataclasses.asdict(geom))
    save = (jck if writer == "jax" else tck).save_checkpoint
    save(path, geom=geom, params=params, stage="mpv", is_sparse=sparse,
         has_dyn=True, tile_map_static=tm_s, tile_map_dyn=tm_d,
         tile_hw=(th, tw), frm_num=F)
    return int((r < 0.45).sum()), int((r > 0.65).sum()), (th, tw)


def _argv(root, exp, extra=()):
    return ["--datadir", str(root / "scene"), "--expdir", str(root / "runs"),
            "--expname", exp, "--factor", "1", "--mpv_frm_num", str(F),
            "--mesh_folder", str(root / "meshes" / exp), "--gpu_num", "0",
            *extra]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_export_mesh_cli_matches_jax(scene, writer):
    """Both packages' export_mesh CLIs on the newest checkpoint of a run
    written by `writer`: the same files; 2 faces per kept tile, the
    static atlas packing_grid x the tile size, one dynamic frame per
    frame and meta.json's frame_count."""
    root, geom = scene
    n_s, n_d, (th, tw) = _write_ckpt(
        str(root / "runs" / writer / "ckpt_000003.npz"), writer, geom, 3)
    _write_ckpt(str(root / "runs" / writer / "ckpt_000001.npz"), writer,
                geom, 4)
    jexport.main(_argv(root, writer, ["--mesh_folder",
                                      str(root / "meshes" / "jax")]))
    out = texport.main(_argv(root, writer))
    assert out == str(root / "meshes" / writer / writer)
    _assert_exports_match(out, str(root / "meshes" / "jax" / writer), F)
    _, _, faces, _ = TO.load_obj(os.path.join(out, "geometry.obj"))
    assert len(faces) == 2 * (n_s + n_d)
    rows, cols = TX.packing_grid(n_s)
    assert _read_image(os.path.join(out, "static.png")).shape == \
        (rows * th, cols * tw, 4)
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["frame_count"] == F


def test_export_mesh_cli_refuses_a_dense_checkpoint(scene):
    root, geom = scene
    _write_ckpt(str(root / "runs" / "dense" / "ckpt_000001.npz"), "torch",
                geom, 5, sparse=False)
    with pytest.raises(ValueError, match="sparse"):
        texport.main(_argv(root, "dense"))
