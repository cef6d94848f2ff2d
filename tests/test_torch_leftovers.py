"""The port's last leftovers against the JAX package:
``render/composite.py:composite_front_to_back``, the host rasterizer
``render/raster_cpp.py`` (its own copy of ``csrc/rasterizer.cpp``, built
into ``build/raster/``), ``make_scene(variant="rich")``,
``write_llff_dir(container="tif")``, and the loaders' per-process view
selection (``count_views``, ``load_views``, datasets with another
process's views)."""
import builtins
import filecmp
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.data import llff as jllff
from videoloop3d_tpu.data import patches as jpatches
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.render import raster_cpp as jraster
from videoloop3d_tpu.render.composite import \
    composite_front_to_back as jcomposite
from videoloop3d_torch.data import llff as tllff
from videoloop3d_torch.data import patches as tpatches
from videoloop3d_torch.data import synthetic as tsyn
from videoloop3d_torch.render import raster_cpp as traster
from videoloop3d_torch.render.composite import \
    composite_front_to_back as tcomposite


@pytest.mark.parametrize("shape", [(5,), (7, 9, 4), (2, 3, 8)])
def test_torch_composite_front_to_back_matches_jax(shape):
    """Out and blend weights within 1e-6 of JAX's, for alpha in [0, 1]
    with exact 0 and 1 among them."""
    rng = np.random.default_rng(len(shape))
    alpha = rng.random(shape).astype(np.float32)
    alpha.reshape(-1)[::7] = 1.0
    alpha.reshape(-1)[3::11] = 0.0
    content = rng.random(shape + (3,)).astype(np.float32)
    out, w = tcomposite(torch.from_numpy(alpha), torch.from_numpy(content))
    jout, jw = jcomposite(jnp.asarray(alpha), jnp.asarray(content))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def _triangles(seed):
    rng = np.random.default_rng(seed)
    verts = np.concatenate([rng.uniform(-2, 20, (30, 2)),
                            rng.uniform(0.5, 4.0, (30, 1))], 1)
    faces = rng.integers(0, 30, (12, 3)).astype(np.int32)
    return verts.astype(np.float32), faces


@pytest.mark.parametrize("k", [1, 3])
def test_torch_rasterizer_matches_jax(k):
    """The port's build of its own rasterizer source gives JAX's
    fragments bit for bit (faces, depths, perspective-correct
    barycentrics), and the same screen-space projection; the library
    lives under build/raster/."""
    verts, faces = _triangles(k)
    got = traster.rasterize(verts, faces, 18, 20, k)
    want = jraster.rasterize(verts, faces, 18, 20, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[0] >= 0).any()
    lib = traster._build_lib()
    assert os.path.dirname(lib) == traster.BUILD_DIR
    assert lib.startswith(os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(traster.__file__))), "build"))
    ext = np.eye(4, dtype=np.float32)
    ext[:3, 3] = [0.1, -0.2, 0.3]
    intr = np.array([[20, 0, 10], [0, 20, 9], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(
        traster.project_vertices(verts, ext, intr),
        jraster.project_vertices(verts, ext, intr))


@pytest.mark.parametrize("variant", ["basic", "rich"])
def test_torch_synthetic_variants_match_jax(variant):
    """make_scene's two variants give JAX's arrays exactly."""
    kw = dict(n_views=4, h=20, w=28, n_frames=5, seed=3, variant=variant)
    got, want = tsyn.make_scene(**kw), jsyn.make_scene(**kw)
    for k in ("videos", "poses", "intrins", "bds", "plane_depths",
              "plane_intrin"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["plane_texs_hw"] == want["plane_texs_hw"]
    with pytest.raises(ValueError, match="variant"):
        tsyn.make_scene(variant="poster")


def test_torch_write_llff_dir_tif_matches_jax(tmp_path):
    """container="tif": JAX's files byte for byte, read back by both
    loaders to the same uint8 videos."""
    scene = tsyn.make_scene(n_views=2, h=16, w=20, n_frames=3, seed=1)
    tsyn.write_llff_dir(scene, str(tmp_path / "t"), container="tif")
    jsyn.write_llff_dir(scene, str(tmp_path / "j"), container="tif")
    names = sorted(os.listdir(tmp_path / "t" / "videos_1"))
    assert names == ["0000.tif", "0001.tif"]
    for n in names + ["../poses_bounds.npy"]:
        assert filecmp.cmp(tmp_path / "t" / "videos_1" / n,
                           tmp_path / "j" / "videos_1" / n, shallow=False)
    tv, _, _ = tllff.load_mv_videos(str(tmp_path / "t"), recenter=False)
    jv, _, _ = jllff.load_mv_videos(str(tmp_path / "j"), recenter=False)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="container"):
        tsyn.write_llff_dir(scene, str(tmp_path / "x"), container="avi")


def test_torch_write_llff_dir_tif_needs_imageio(tmp_path, monkeypatch):
    """Without imageio the tif container raises ImportError, as JAX's."""
    real = builtins.__import__

    def no_imageio(name, *a, **k):
        if name == "imageio" or name.startswith("imageio."):
            raise ImportError("no imageio")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    scene = tsyn.make_scene(n_views=1, h=8, w=8, n_frames=2)
    with pytest.raises(ImportError):
        tsyn.write_llff_dir(scene, str(tmp_path / "t"), container="tif")


def test_torch_count_and_load_views_match_jax(tmp_path):
    """count_views counts without decoding; load_views decodes only the
    given views (None elsewhere), as JAX's loader; no videos raises."""
    scene = tsyn.make_scene(n_views=4, h=16, w=20, n_frames=3, seed=0)
    tsyn.write_llff_dir(scene, str(tmp_path / "s"))
    d = str(tmp_path / "s")
    assert tllff.count_views(d) == jllff.count_views(d) == 4
    tv, tf, ts = tllff.load_mv_videos(d, load_views={1, 3})
    jv, jf, js = jllff.load_mv_videos(d, load_views={1, 3})
    assert [v is None for v in tv] == [v is None for v in jv] == \
        [True, False, True, False]
    for a, b in zip(tv, jv):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert tf == jf
    with pytest.raises(FileNotFoundError, match="no videos"):
        tllff.count_views(str(tmp_path / "missing"))


def test_torch_datasets_with_foreign_views_match_jax():
    """The stage-1 and stage-2 datasets built with another process's views
    as None: the same metadata as JAX's, pixels only for the own views."""
    scene = tsyn.make_scene(n_views=3, h=24, w=32, n_frames=4, seed=0)
    vids = [(np.clip(v, 0, 1) * 255).astype(np.uint8)
            for v in scene["videos"]]
    vids[1] = None
    args = ((24, 32), vids, (16, 24), (8, 8), scene["poses"],
            scene["intrins"])
    t1, j1 = tpatches.ImagePatchDataset(*args), \
        jpatches.ImagePatchDataset(*args)
    assert t1.images[1] is None and j1.images[1] is None
    for i in range(len(t1)):
        a, b = t1[i], j1[i]
        assert a.keys() == b.keys()
        assert a["view"] == b["view"] and a["wh_start"] == b["wh_start"]
        if "rgb" in a:
            np.testing.assert_allclose(a["rgb"], b["rgb"], atol=1e-6)
    cfgs = [{"loss_name": "gpnn_lm"}] * 3
    t2 = tpatches.VideoPatchDataset(*args, cfgs)
    j2 = jpatches.VideoPatchDataset(*args, cfgs)
    assert t2.videos[1] is None and j2.videos[1] is None
    for a, b in zip(t2.videos, j2.videos):
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert [t2[i]["view"] for i in range(len(t2))] == \
        [j2[i]["view"] for i in range(len(j2))]
