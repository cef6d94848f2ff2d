"""Stage-2 training CLI (counterpart of
``videoloop3d_tpu/tools/train_3dvid.py``, reference train_3dvid.py): the
looping MTV over the coarse-to-fine pyramid, from a sparse or dense
stage-1 checkpoint or from scratch.

    python -m videoloop3d_torch.tools.train_3dvid --config <base> \
        --config1 <scene>.txt [--init_from <stage-1 ckpt>] [--gpu_num 0]

Runs on ``cuda:0`` unless ``--gpu_num 0`` asks for the CPU.  A sparse
model trains on the shipped route of ``configs/mpv_base.txt``
(``--compact_hits``, ``--fused_render``) or with either flag off; a
dense one (no ``--init_from``: a scratch start, or a dense stage-1
checkpoint) on K16/K17 and the unfused composite.  ``--add_uv_noise`` and
``--bg_color random`` take their draws from a generator seeded from
``--seed``.  Resumes from the newest stage-2 checkpoint of the run
(either package's).  ``--fast_nn_dist`` (and its per-view overrides
``--fast_nn_dist_ref``/``--fast_nn_dist_other``) searches with K18, the
temporally decomposed form, where pt > 1.  Every looping loss, decoder
and activation of the JAX package trains (a checkpoint's decoder type is
adopted).  More than one process trains on a (dp, fp) rank grid, one
process a rank (``--num_processes N --process_id i --coordinator_address
host:port``, or torchrun; ``--mesh_fp`` sets the frame-parallel size),
each on ``cuda:(rank mod device_count)``; ``--shard_views`` has each
decode only its own views.  Exit codes: 75 after a SIGTERM (a resumable checkpoint was written), 42 from
the hang watchdog (``--hang_timeout``).
"""
from __future__ import annotations

import numpy as np

from videoloop3d_torch.backend import device_from_args
from videoloop3d_torch.config import parse_args_with_configs
from videoloop3d_torch.parallel.distributed import maybe_init_from_args


def main(argv=None):
    """Parse, check, train.  Returns stage2.train's (model, params,
    rundir)."""
    args = parse_args_with_configs(argv)
    from videoloop3d_torch.train import common, stage2
    # one process a rank: --num_processes / --process_id /
    # --coordinator_address, or torchrun's environment
    device = maybe_init_from_args(args, device_from_args(args))
    np.random.seed(args.seed)
    shutdown = common.GracefulShutdown()
    try:
        result = stage2.train(args, device, shutdown=shutdown)
    finally:
        shutdown.restore()
    if shutdown.requested:
        # EX_TEMPFAIL: the run checkpointed and can resume
        raise SystemExit(common.GracefulShutdown.EXIT_CODE)
    return result


if __name__ == "__main__":
    main()
