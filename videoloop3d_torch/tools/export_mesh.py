"""Mesh and atlas export CLI (counterpart of
``videoloop3d_tpu/tools/export_mesh.py``, reference
scripts/script_export_mesh.py): checkpoint -> geometry.obj + static.png +
dynamic/%04d.png + meta.json for the VideoLoopUI WebGL player.

    python -m videoloop3d_torch.tools.export_mesh --config ... --config1 ...
        [--mesh_folder meshes] [--ckpt path]

Host work (numpy; the texel activation as a torch op on the CPU), as in
the JAX package: it reads the checkpoint and the scene's cameras and
writes the files, on any machine; ``--gpu_num`` changes nothing.  The
checkpoint must be a sparse (culled) MTV of either package.
"""
from __future__ import annotations

import os

from videoloop3d_torch.config import build_parser, parse_args_with_configs
from videoloop3d_torch.data import llff
from videoloop3d_torch.export.mesh_export import (export_mtv,
                                                  scene_meta_from_llff)
from videoloop3d_torch.models import checkpoint as ckpt_io


def main(argv=None):
    """Parse and export.  Returns the output directory."""
    parser = build_parser()
    parser.add_argument("--mesh_folder", type=str, default="meshes")
    parser.add_argument("--ckpt", type=str, default="",
                        help="explicit checkpoint path (default: newest)")
    args = parse_args_with_configs(argv, parser)

    expname = args.expname + args.expname_postfix
    outdir = os.path.join(args.prefix, args.mesh_folder, expname)
    rundir = os.path.join(args.prefix, args.expdir, expname)
    ckpt_path = args.ckpt or ckpt_io.latest_checkpoint(rundir)
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoints under {rundir}")
    print(f"[export] checkpoint {ckpt_path}")
    ckpt = ckpt_io.load_checkpoint(ckpt_path)
    meta = ckpt["meta"]
    if not meta["is_sparse"]:
        raise ValueError("export requires a sparse (culled) MTV")

    datadir = os.path.join(args.prefix, args.datadir)
    scene = llff.load_llff_scene(
        datadir, args.factor, recenter=False,
        bd_factor=(args.near_factor, args.far_factor))
    scene_meta = scene_meta_from_llff(scene)
    scene_meta["fps"] = 25

    frm = meta.get("frm_num") or args.mpv_frm_num
    dyn = ckpt["params"]["atlas_dyn"]
    if dyn.ndim == 5 and dyn.shape[3] != frm:
        raise ValueError(f"unmatched frame count {dyn.shape[3]} vs {frm}")

    extra = meta.get("extra", {})
    export_mtv(outdir, ckpt["geom"], ckpt["params"],
               ckpt["tile_map_static"], ckpt["tile_map_dyn"], scene_meta,
               rgb_activate=extra.get("rgb_activate", "sigmoid"),
               alpha_activate=extra.get("alpha_activate", "sigmoid"))
    print(f"[export] wrote {outdir}")
    return outdir


if __name__ == "__main__":
    main()
