"""README's quick start through the PyTorch port's five CLIs on the CPU
(``--gpu_num 0``): a synthetic scene, ``train_3d`` and ``train_3dvid`` on
``configs/debug_synthetic_s1.txt`` / ``_s2.txt`` with their epochs cut on
the command line, ``render_video``, ``evaluate`` and ``export_mesh``.
Then the JAX package scores the port's renders (``evaluate --pred_dir``)
and exports the port's checkpoint, and both are held to the port's
files: eval_metrics.txt within 1e-5 relative (the NN metrics sum in
another order), geometry.obj and meta.json text equal, atlases within one
u8 step on at most 0.1% of the texels (the frameworks' sigmoids may differ
in the last bit)."""
import os

import numpy as np
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.eval.evaluate import evaluate as jax_evaluate
from videoloop3d_tpu.tools import export_mesh as jexport
from videoloop3d_torch.config import parse_args_with_configs
from videoloop3d_torch.core import cameras
from videoloop3d_torch.data import llff, synthetic
from videoloop3d_torch.data.video import to8b
from videoloop3d_torch.eval.evaluate import load_mpv_from_run
from videoloop3d_torch.tools import (evaluate, export_mesh, render_video,
                                     train_3d, train_3dvid)
from videoloop3d_torch.train.stage2 import render_eval

from test_torch_eval import _assert_tables_close, _table
from test_torch_export import _assert_exports_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S1 = os.path.join(REPO, "configs", "debug_synthetic_s1.txt")
S2 = os.path.join(REPO, "configs", "debug_synthetic_s2.txt")


def test_quick_start_through_the_port(tmp_path, monkeypatch):
    monkeypatch.delenv("VL3D_LPIPS_WEIGHTS", raising=False)
    prefix = str(tmp_path)
    synthetic.write_llff_dir(
        synthetic.make_scene(n_views=3, h=90, w=160, n_frames=8),
        os.path.join(prefix, "data", "synthetic"), 1)
    common = ["--prefix", prefix, "--gpu_num", "0", "--mesh_devices", "1"]
    # 2 dense epochs, the cull, 1 sparse epoch (the config: 9, 12)
    train_3d.main(["--config", S1, *common, "--N_iters", "3",
                   "--sparsify_epoch", "2"])
    s2 = ["--config", S2, *common,
          "--init_from", "mpis/debug_synthetic/ckpt_epoch_0002.npz"]
    # the full-resolution level only, one epoch (the config: 5 levels x 6)
    _, params, rundir = train_3dvid.main(
        s2 + ["--pyr_init_level", "4", "--pyr_num_epoch", "1"])
    assert rundir == os.path.join(prefix, "mpvs", "debug_synthetic")
    frames = render_video.main(s2 + ["--v", "0"])
    assert np.stack(frames).shape == (8, 90, 160, 3)
    table = evaluate.main(s2)
    assert np.isfinite(table["nnf"]).all() and np.isnan(table["lpips"]).all()
    out = export_mesh.main(s2)
    assert out == os.path.join(prefix, "meshes", "debug_synthetic")

    # the JAX package scores the port's eval renders...
    args = parse_args_with_configs(s2)
    _, _, sc = llff.load_mv_videos(os.path.join(prefix, args.datadir),
                                   factor=1, bd_factor=(args.near_factor,
                                                        args.far_factor),
                                   recenter=True)
    ref = cameras.pose_to_extrinsic(cameras.average_pose(sc["poses"])[:, :4])
    model, params, _, _ = load_mpv_from_run(
        args, 90, 160, ref, sc["intrins"][0], float(sc["bds"].min()),
        float(sc["bds"].max()), device=torch.device("cpu"))
    ext = cameras.pose_to_extrinsic(sc["poses"])
    preds = tmp_path / "preds"
    preds.mkdir()
    for v in range(3):
        np.save(preds / f"view{v:02d}.npy", to8b(render_eval(
            model, params, 90, 160, ext[v:v + 1], sc["intrins"][v:v + 1],
            np.arange(8), chunk=2)))
    jax_evaluate(jax_parse(s2), pred_dir=str(preds))
    _assert_tables_close(_table(table["path"]),
                         _table(str(preds / "eval_metrics.txt")))
    # ...and exports the port's checkpoint
    jexport.main(s2 + ["--mesh_folder", "meshes_jax"])
    _assert_exports_match(out, os.path.join(prefix, "meshes_jax",
                                            "debug_synthetic"), 8)
