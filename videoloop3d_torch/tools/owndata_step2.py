"""Own-data pose registration: run COLMAP on the standardized scene (where
its sparse model is missing) and convert the sparse model to LLFF
``poses_bounds.npy`` (counterpart of
``videoloop3d_tpu/tools/owndata_step2.py``; ref
scripts/script_owndata_step2_genllffpose.py).  The COLMAP binary comes
from ``--colmap_bin`` or ``$COLMAP_BIN``.

    python -m videoloop3d_torch.tools.owndata_step2 --scenedir data/myscene \
        [--share_intrin] [--match_type exhaustive_matcher] [--colmap_bin ...]
"""
from __future__ import annotations

import argparse

from videoloop3d_torch.tools.colmap.poses import gen_poses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenedir", type=str, required=True)
    ap.add_argument("--share_intrin", action="store_true")
    ap.add_argument("--match_type", type=str,
                    default="exhaustive_matcher",
                    choices=["exhaustive_matcher", "sequential_matcher"])
    ap.add_argument("--colmap_bin", type=str, default="")
    args = ap.parse_args(argv)
    return gen_poses(args.scenedir, args.match_type, args.share_intrin,
                     args.colmap_bin or None)


if __name__ == "__main__":
    main()
