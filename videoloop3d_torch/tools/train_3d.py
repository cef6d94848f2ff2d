"""Stage-1 training CLI (counterpart of ``videoloop3d_tpu/tools/train_3d.py``,
reference train_3d.py): stage 1, the dense epochs, the tile cull at
``--sparsify_epoch`` and the sparse epochs.

    python -m videoloop3d_torch.tools.train_3d --config configs/mpi_base.txt \
        --config1 <scene>.txt [--N_iters 140] [--gpu_num 0]

Runs on ``cuda:0`` unless ``--gpu_num 0`` asks for the CPU.  Resumes
from the newest dense or sparse checkpoint of the run (either package's).
``--add_uv_noise`` and ``--bg_color random`` take their draws from a
generator seeded from ``--seed``.  Every ``--rgb_mlp_type`` and activation
of the JAX package trains; ``--direct2sh_epoch E`` widens a direct atlas
to rgb_sh at epoch E.  More than one process trains data-parallel, one
process a rank (``--num_processes N --process_id i --coordinator_address
host:port``, or torchrun), each on ``cuda:(rank mod device_count)``;
``--shard_views`` has each decode only its own views.  Exit codes: 75 after a SIGTERM (a resumable checkpoint was written), 42 from
the hang watchdog (``--hang_timeout``).
"""
from __future__ import annotations

import numpy as np

from videoloop3d_torch.backend import device_from_args
from videoloop3d_torch.config import parse_args_with_configs
from videoloop3d_torch.parallel.distributed import maybe_init_from_args


def main(argv=None):
    """Parse, check, train.  Returns stage1.train's (model, params,
    rundir)."""
    args = parse_args_with_configs(argv)
    from videoloop3d_torch.train import common, stage1
    # one process a rank: --num_processes / --process_id /
    # --coordinator_address, or torchrun's environment
    device = maybe_init_from_args(args, device_from_args(args))
    np.random.seed(args.seed)
    shutdown = common.GracefulShutdown()
    try:
        result = stage1.train(args, device, shutdown=shutdown)
    finally:
        shutdown.restore()
    if shutdown.requested:
        # EX_TEMPFAIL: the run checkpointed and can resume
        raise SystemExit(common.GracefulShutdown.EXIT_CODE)
    return result


if __name__ == "__main__":
    main()
