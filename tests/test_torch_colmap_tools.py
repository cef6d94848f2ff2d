"""The port's own-data tools (``videoloop3d_torch/tools/colmap/``,
``tools/owndata_step1.py``, ``tools/owndata_step2.py``) against the JAX
package's: the same numpy inputs from a seed give the same files, byte
for byte."""
import filecmp
import os
import stat

import numpy as np
import pytest

from videoloop3d_tpu.tools.colmap import binmodel as jbm
from videoloop3d_tpu.tools.colmap import poses as jposes
from videoloop3d_tpu.tools.colmap import wrapper as jwrap
from videoloop3d_tpu.tools import owndata_step1 as jstep1
from videoloop3d_torch.tools.colmap import binmodel as tbm
from videoloop3d_torch.tools.colmap import poses as tposes
from videoloop3d_torch.tools.colmap import wrapper as twrap
from videoloop3d_torch.tools import owndata_step1 as tstep1
from videoloop3d_torch.tools import owndata_step2 as tstep2


def test_torch_quaternions_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        q = q if q[0] >= 0 else -q
        R = tbm.qvec_to_rotmat(q)
        np.testing.assert_array_equal(R, jbm.qvec_to_rotmat(q))
        np.testing.assert_array_equal(tbm.rotmat_to_qvec(R),
                                      jbm.rotmat_to_qvec(R))
        np.testing.assert_allclose(tbm.rotmat_to_qvec(R), q, atol=1e-8)


def _model(bm, n_views=4):
    """A synthetic sparse model (cameras, images, points) built with the
    binmodel module `bm` from seeded numpy."""
    rng = np.random.default_rng(1)
    w, h, focal = 64, 48, 55.0
    cams = {1: bm.Camera(1, "SIMPLE_PINHOLE", w, h,
                         np.array([focal, w / 2, h / 2]))}
    images = {}
    for i in range(n_views):
        a = 0.05 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = [0.2 * i, 0.05 * i, 0.0]
        w2c = np.linalg.inv(c2w)
        images[i + 1] = bm.Image(
            i + 1, bm.rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1,
            f"{i:04d}.png", rng.random((3, 2)), np.arange(3))
    pts = {}
    for pid in range(30):
        xyz = rng.normal(size=3) * np.array([1, 1, 0.5]) + [0, 0, 4.0]
        pts[pid + 1] = bm.Point3D(
            pid + 1, xyz, np.array([128, 64, 32]), 0.5,
            np.arange(1, n_views + 1), np.zeros(n_views, np.int32))
    return cams, images, pts


def _write(bm, scenedir):
    sparse = os.path.join(scenedir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    cams, images, pts = _model(bm)
    bm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
    bm.write_images_binary(os.path.join(sparse, "images.bin"), images)
    bm.write_points3d_binary(os.path.join(sparse, "points3D.bin"), pts)
    return sparse


def _same_tree(a, b):
    """Every file under a and b, byte for byte."""
    fa = sorted(os.path.relpath(os.path.join(r, f), a)
                for r, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b)
                for r, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa
    for f in fa:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


def test_torch_binary_model_matches_jax(tmp_path):
    """The writers give JAX's files byte for byte, and each package reads
    the other's files to the same values."""
    ts = _write(tbm, str(tmp_path / "t"))
    js = _write(jbm, str(tmp_path / "j"))
    _same_tree(ts, js)
    for name, fn in (("cameras.bin", "read_cameras_binary"),
                     ("images.bin", "read_images_binary"),
                     ("points3D.bin", "read_points3d_binary")):
        got = getattr(tbm, fn)(os.path.join(js, name))
        want = getattr(jbm, fn)(os.path.join(ts, name))
        assert got.keys() == want.keys()
        for k in got:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torch_colmap_to_llff_matches_jax(tmp_path):
    """load_colmap_scene + save_llff_poses write JAX's poses_bounds.npy
    byte for byte."""
    for tag, bm, ps in (("t", tbm, tposes), ("j", jbm, jposes)):
        d = str(tmp_path / tag)
        _write(bm, d)
        poses, pts3d, perm, names = ps.load_colmap_scene(d)
        ps.save_llff_poses(d, poses, pts3d, perm)
    assert filecmp.cmp(tmp_path / "t" / "poses_bounds.npy",
                       tmp_path / "j" / "poses_bounds.npy", shallow=False)


def _images(scenedir, n):
    os.makedirs(os.path.join(scenedir, "images"), exist_ok=True)
    for i in range(n):
        open(os.path.join(scenedir, "images", f"{i:04d}.png"), "wb").close()


def test_torch_owndata_step2_matches_jax(tmp_path):
    """owndata_step2 on a registered sparse model (COLMAP is not run: the
    model exists) writes JAX's gen_poses file byte for byte; an image that
    failed to register raises, as in the JAX package."""
    _write(tbm, str(tmp_path / "t"))
    _images(str(tmp_path / "t"), 4)
    _write(jbm, str(tmp_path / "j"))
    _images(str(tmp_path / "j"), 4)
    out = tstep2.main(["--scenedir", str(tmp_path / "t")])
    jposes.gen_poses(str(tmp_path / "j"))
    assert filecmp.cmp(out, tmp_path / "j" / "poses_bounds.npy",
                       shallow=False)
    _write(tbm, str(tmp_path / "u"))
    _images(str(tmp_path / "u"), 5)
    with pytest.raises(RuntimeError, match="failed to register"):
        tposes.gen_poses(str(tmp_path / "u"))


def test_torch_colmap_wrapper_matches_jax(tmp_path):
    """run_colmap runs the JAX package's command lines, in its order,
    against a stand-in binary that records them."""
    fake = tmp_path / "colmap"
    fake.write_text("#!/bin/sh\necho \"$@\"\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    logs = []
    for tag, wr in (("t", twrap), ("j", jwrap)):
        d = tmp_path / tag
        d.mkdir()
        log = wr.run_colmap(str(d), "exhaustive_matcher",
                            ["feature_extractor", "matcher", "mapper",
                             "convert"], colmap_bin=str(fake))
        logs.append(open(log).read().replace(str(d), "<scene>"))
    assert logs[0] == logs[1] and logs[0].count("\n") == 4


def test_torch_owndata_step1_matches_jax(tmp_path, monkeypatch):
    """split_on_black and standardize on a .npy capture: the clips, and
    the images and videos written, file for file JAX's; without imageio
    (as on the card) the clips are written as .npy, the frames intact."""
    rng = np.random.default_rng(2)
    clip1 = rng.integers(60, 255, (4, 16, 20, 3)).astype(np.uint8)
    clip2 = rng.integers(60, 255, (5, 16, 20, 3)).astype(np.uint8)
    black = np.zeros((2, 16, 20, 3), np.uint8)
    vid = np.concatenate([clip1, black, clip2, black])
    for a, b in zip(tstep1.split_on_black(vid), jstep1.split_on_black(vid)):
        np.testing.assert_array_equal(np.stack(a), np.stack(b))
    src = str(tmp_path / "cap.npy")
    np.save(src, vid)
    n = tstep1.main(["--input_path", src, "--output_prefix",
                     str(tmp_path / "t"), "--factor", "1,2"])
    assert n == jstep1.standardize(src, str(tmp_path / "j"), [1, 2]) == 2
    _same_tree(tmp_path / "t", tmp_path / "j")
    monkeypatch.setattr(tstep1.video_io, "_HAS_IMAGEIO", False)
    tstep1.standardize(src, str(tmp_path / "n"), [1])
    got = np.load(tmp_path / "n" / "videos_1" / "0001.npy")
    np.testing.assert_array_equal(got, clip2)
