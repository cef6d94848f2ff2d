"""The port's multi-process dry runs
(``videoloop3d_torch/parallel/multihost_dryrun.py``) in its four modes,
two gloo processes each meeting through a ``file://`` store in tmp_path,
and the helpers of ``parallel/distributed.py`` against the JAX
package's."""
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from test_torch_parallel import ROOT, launch
from videoloop3d_tpu.parallel.distributed import \
    partition_views as jax_partition_views


def _dryrun(mode, tmp_path, **extra):
    def argv(i, init):
        out = [sys.executable, "-m",
               "videoloop3d_torch.parallel.multihost_dryrun",
               "--process_id", str(i), "--num_processes", "2",
               "--init_method", init, "--workdir", str(tmp_path / "work"),
               "--mode", mode]
        for k, v in extra.items():
            out += [f"--{k}", str(v)]
        return out
    return launch(argv, 2, tmp_path)


def test_torch_multihost_step(tmp_path):
    """Two processes, one real dp stage-2 step, a patch each: both print
    MULTIHOST_OK with the same finite loss (the dp mean) and pass the
    checkpoint gather's shape checks."""
    outs = _dryrun("step", tmp_path)
    losses = []
    for i, out in enumerate(outs):
        m = re.search(r"MULTIHOST_OK process=%d procs=2 devices=2 "
                      r"loss=([-\d.]+)" % i, out)
        assert m, out[-2000:]
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1] and np.isfinite(losses[0])


@pytest.mark.parametrize("n_views", [4, 3])
def test_torch_multihost_shard_views(tmp_path, n_views):
    """The stage-2 trainer with --shard_views: the processes decode
    disjoint view sets that together cover the scene (uneven with 3
    views over 2), end with the same loss, and only rank 0 writes a
    checkpoint."""
    outs = _dryrun("shard_views", tmp_path, sv_views=n_views)
    views, losses, ckpts = [], [], []
    for i, out in enumerate(outs):
        m = re.search(r"MULTIHOST_SV_OK process=%d views=([\d,]+) "
                      r"host_bytes=(\d+) ckpt=(\d) loss=([-\d.]+)" % i, out)
        assert m, out[-2000:]
        views.append({int(v) for v in m.group(1).split(",")})
        ckpts.append(int(m.group(3)))
        losses.append(float(m.group(4)))
    assert not views[0] & views[1]
    assert views[0] | views[1] == set(range(n_views))
    assert ckpts == [1, 0]
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_torch_multihost_stage1_shard_views(tmp_path):
    """The stage-1 trainer with --shard_views: two views decoded a
    process, disjoint, and the same finite loss on both."""
    outs = _dryrun("stage1_sv", tmp_path)
    views, losses = [], []
    for i, out in enumerate(outs):
        m = re.search(r"MULTIHOST_S1SV_OK process=%d views=([\d,]+) "
                      r"host_bytes=(\d+) loss=([-\d.]+)" % i, out)
        assert m, out[-2000:]
        views.append({int(v) for v in m.group(1).split(",")})
        losses.append(float(m.group(3)))
    assert not views[0] & views[1] and len(views[0]) == len(views[1]) == 2
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_torch_multihost_sigterm_stops_both_processes(tmp_path):
    """SIGTERM to rank 1 only of a 2-process stage-1 run: both ranks stop
    at the same epoch (the per-epoch any_process_flag), exit 0, and only
    rank 0, which was never signalled, writes the checkpoint."""
    init = "file://" + str(tmp_path / "pg_store")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join([ROOT, env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "videoloop3d_torch.parallel.multihost_dryrun",
         "--process_id", str(i), "--num_processes", "2", "--init_method",
         init, "--workdir", str(tmp_path / "work"), "--mode",
         "sigterm_stop"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    lines = [[], []]
    evts = [threading.Event(), threading.Event()]

    def reader(i):
        for line in procs[i].stdout:
            lines[i].append(line)
            if "STOP_DRYRUN_EPOCH" in line:
                evts[i].set()
        procs[i].stdout.close()

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    try:
        assert evts[0].wait(timeout=240), "".join(lines[0][-30:])
        assert evts[1].wait(timeout=240), "".join(lines[1][-30:])
        procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in threads:
        t.join(timeout=30)
    oks = []
    for i in range(2):
        out = "".join(lines[i])
        assert rcs[i] == 0, (i, rcs[i], out[-2000:])
        m = re.search(r"MULTIHOST_STOP_OK process=%d signaled=(\d) "
                      r"stopped_epoch=(\d+) ckpts=(\d+)" % i, out)
        assert m, out[-2000:]
        oks.append(tuple(int(g) for g in m.groups()))
    assert oks[0][0] == 0 and oks[1][0] == 1, oks
    assert oks[0][1] == oks[1][1], oks
    assert oks[0][2] == 1 and oks[1][2] == 0, oks


def test_torch_partition_views_uneven_10_over_4():
    """10 views over 4 processes: JAX's owners, counts 3/3/2/2, each loss
    config class round-robined on its own."""
    from videoloop3d_torch.parallel.distributed import partition_views
    ref = {1, 6}
    owner = partition_views(list(range(10)), ref, 4)
    assert owner == jax_partition_views(list(range(10)), ref, 4)
    counts = sorted(sum(1 for p in owner.values() if p == q)
                    for q in range(4))
    assert counts == [2, 2, 3, 3]
    assert owner[1] == 0 and owner[6] == 1


def test_torch_partition_views_rejects_starved_process():
    from videoloop3d_torch.parallel.distributed import partition_views
    with pytest.raises(ValueError, match="shard_views"):
        partition_views([0, 1, 2], set(), 4)


def test_torch_single_process_helpers():
    """In one process: a grid of one rank whose collectives are the
    identity, any_process_flag passes its flag through, rank 0 is
    primary, commit_batch takes the only row, and fold_seed keeps row 0's
    seed and gives other rows other seeds."""
    from videoloop3d_torch.parallel import distributed as dist
    grid = dist.make_mesh()
    assert (grid.n_dp, grid.n_fp, grid.dp_rank, grid.fp_rank) == (1, 1, 0, 0)
    t = torch.arange(6.0)
    assert grid.dp.all_reduce(t) is t
    np.testing.assert_array_equal(grid.fp.all_gather(t)[0], t)
    np.testing.assert_array_equal(grid.fp.shift(t, 1), t)
    assert dist.any_process_flag(True) is True
    assert dist.any_process_flag(False) is False
    assert dist.is_primary() and dist.world_size() == 1
    assert dist.commit_batch(grid, ["a"]) == ["a"]
    assert dist.fold_seed(7, 0) == 7
    assert len({dist.fold_seed(7, r) for r in range(4)}) == 4
    with pytest.raises(ValueError, match="dp=2"):
        dist.make_mesh(n_dp=2, n_fp=1)


def test_torch_backend_rule():
    """NCCL only where each rank on a host has a GPU of its own; gloo on
    the CPU and where ranks share a device."""
    from videoloop3d_torch.parallel.distributed import choose_backend
    assert choose_backend(torch.device("cpu"), 1) == "gloo"
    assert choose_backend(torch.device("cpu"), 4) == "gloo"
    n = torch.cuda.device_count()
    assert choose_backend(torch.device("cuda", 0), n + 1) == "gloo"


def test_torch_world_size_mismatch_raises():
    """--mesh_devices other than the number of processes raises before
    any work; 0 and the world's size pass."""
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.parallel.distributed import check_world
    for n in (0, 1):
        check_world(parse_args_with_configs(["--mesh_devices", str(n)]))
    with pytest.raises(ValueError, match="does not match"):
        check_world(parse_args_with_configs(["--mesh_devices", "2"]))
