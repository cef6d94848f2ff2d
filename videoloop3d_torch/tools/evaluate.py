"""Evaluation CLI (counterpart of ``videoloop3d_tpu/tools/evaluate.py``,
reference scripts/script_evaluate_ours.py).

    python -m videoloop3d_torch.tools.evaluate --config ... --config1 ...
        [--skip static,lpips,...] [--with_svfid] [--pred_dir DIR]
        [--gpu_num 0]

Runs on ``cuda:0`` unless ``--gpu_num 0`` asks for the CPU.  Metric groups
mirror the reference's COMPUTE_* flags (script_evaluate_ours.py:25-30):
static, dyn, lpips, nnmse, loopq, svfid (svfid off by default there too).
LPIPS needs ``VL3D_LPIPS_WEIGHTS`` and SVFID ``VL3D_C3D_WEIGHTS`` (local
``.npz`` files); without them the metric is NaN.
"""
from __future__ import annotations

import numpy as np

from videoloop3d_torch.backend import device_from_args
from videoloop3d_torch.config import build_parser, parse_args_with_configs


def main(argv=None):
    """Parse and evaluate.  Returns `eval.evaluate.evaluate`'s table."""
    parser = build_parser()
    parser.add_argument("--skip", type=str, default="",
                        help="comma list of metric groups to skip: "
                             "static,dyn,lpips,nnmse,loopq")
    parser.add_argument("--with_svfid", action="store_true",
                        help="compute SVFID (needs VL3D_C3D_WEIGHTS)")
    parser.add_argument("--pred_dir", type=str, default=None,
                        help="score pre-rendered view{v:02d}.npy loops "
                             "from this dir instead of rendering from "
                             "the run checkpoint (head-to-head path)")
    args = parse_args_with_configs(argv, parser)
    device = device_from_args(args)
    from videoloop3d_torch.eval.evaluate import evaluate

    np.random.seed(args.seed)
    flags = {}
    for name in args.skip.split(","):
        if name.strip():
            flags[name.strip()] = False
    if args.with_svfid:
        flags["svfid"] = True
    return evaluate(args, compute_flags=flags or None,
                    pred_dir=args.pred_dir, device=device)


if __name__ == "__main__":
    main()
