"""The port's data-parallel layer (``videoloop3d_torch/parallel/dp_step.py``,
``distributed.py``) against the JAX package's dp steps.

Two gloo processes (this file run as a script, ``_worker``) take a
distinct patch each and one SGD step of the port's dp stage-2 and
stage-1 steps; the test process runs JAX's ``make_dp_stage2_step`` and
``make_dp_stage1_step`` on a 2-row virtual CPU mesh (``tests/conftest.py``)
on the same numpy inputs, and the port's single-process step on each
patch.  SGD: the update is linear in the gradient, so the dp update is
the mean of the two single-patch updates.  A weight-0 filler row must
change nothing, and ``--dp_serial_below`` feeds one real patch a step.
Each multi-process run has a timeout of its own and meets through a
``file://`` store in tmp_path.
"""
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from videoloop3d_tpu.config import parse_args_with_configs as jax_parse
from videoloop3d_tpu.core import cameras as jcam
from videoloop3d_tpu.data import synthetic as jsyn
from videoloop3d_tpu.models.mpmesh import MPMesh as JaxMPMesh
from videoloop3d_tpu.models.mpv import MPMeshVid as JaxMPMeshVid
from videoloop3d_tpu.parallel.dp_step import (make_dp_stage1_step,
                                              make_dp_stage2_step)
from videoloop3d_tpu.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GEOM = ["--mpi_h_scale", "1.2", "--mpi_w_scale", "1.2",
        "--mpi_h_verts", "5", "--mpi_w_verts", "7", "--mpi_d", "4",
        "--atlas_grid_h", "2"]
MPV_ARGV = GEOM + ["--mpv_frm_num", "4", "--mpv_isloop", "--scale_invariant",
                   "--init_std", "0.02", "--rgb_smooth_loss_weight", "0.2",
                   "--a_smooth_loss_weight", "0.2", "--optimizer", "sgd"]
MPI_ARGV = GEOM + ["--scale_invariant", "--learn_loop_mask", "--init_std",
                   "0.02", "--rgb_smooth_loss_weight", "0.2",
                   "--a_smooth_loss_weight", "0.2", "--optimizer", "sgd"]
LOSSCFG = {"loss_name": "gpnn_lm", "patch_size": 3, "patcht_size": 3,
           "stride": 2, "stridet": 1, "alpha": 10000, "rou": "-2",
           "scaling": 0.1, "macro_block": 17, "factor": 1,
           "loss_gain": 1.0, "dist_fn": "mse", "num_proj": 32,
           "fast_nn_dist": False, "nn_bf16": False}
S2_KEYS = ("sparsity", "rgb_smooth", "a_smooth", "d_smooth", "density")
S1_KEYS = ("sparsity", "rgb_smooth", "a_smooth", "d_smooth", "l_smooth",
           "density")
LR = 0.1
TIMEOUT = 300


# ---------------------------------------------------------------------------
# launching the ranks
# ---------------------------------------------------------------------------

def launch(argv_of, n, workdir, timeout=TIMEOUT):
    """Run `n` processes, process i with the arguments argv_of(i, init),
    init a file:// store in workdir; raise with their output unless every
    one exits 0 within `timeout` seconds.  Returns their outputs."""
    init = "file://" + os.path.join(str(workdir), "pg_store")
    env = dict(os.environ, OMP_NUM_THREADS="2", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen(argv_of(i, init), cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {i} exited {p.returncode}:\n"
                                 + "\n".join(o[-3000:] for o in outs))
    return outs


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

def _scene(n_views, n_frames=4):
    return jsyn.make_scene(n_views=n_views, h=24, w=32, n_frames=n_frames,
                           seed=0)


def _ref(scene):
    return jcam.pose_to_extrinsic(jcam.average_pose(scene["poses"])[:, :4])


def _ext(pose):
    return np.linalg.inv(np.concatenate(
        [pose, np.array([[0, 0, 0, 1.0]], np.float32)])).astype(np.float32)


def dp_inputs():
    """The stage-2 and stage-1 params and the two rows of each batch, as
    numpy."""
    sc2 = _scene(2)
    jm2 = JaxMPMeshVid(jax_parse(MPV_ARGV), 24, 32, _ref(sc2),
                       sc2["intrins"][0], float(sc2["bds"][0]),
                       float(sc2["bds"][1]))
    sc1 = _scene(3)
    jm1 = JaxMPMesh(jax_parse(MPI_ARGV), 24, 32, _ref(sc1),
                    sc1["intrins"][0], float(sc1["bds"][0]),
                    float(sc1["bds"][1]))
    lms = (np.random.default_rng(0).random((2, 24, 32)) > 0.5).astype(
        np.float32)
    out = {"s2/extrin": np.stack([_ext(sc2["poses"][i]) for i in range(2)]),
           "s2/intrin": sc2["intrins"][:2].astype(np.float32),
           "s2/video": sc2["videos"][:2].astype(np.float32),
           "s1/extrin": np.stack([_ext(sc1["poses"][i]) for i in range(2)]),
           "s1/intrin": sc1["intrins"][:2].astype(np.float32),
           "s1/rgb": sc1["videos"][:2].mean(1).astype(np.float32),
           "s1/loopmask": lms}
    for tag, m in (("p2", jm2), ("p1", jm1)):
        for k, v in m.init_params(0).items():
            out[f"{tag}/{k}"] = np.asarray(v)
    return out


def _params(inp, tag):
    return {k.split("/", 1)[1]: torch.from_numpy(v.copy())
            for k, v in inp.items() if k.startswith(tag + "/")}


def _torch_models(inp):
    from videoloop3d_torch.config import parse_args_with_configs as tparse
    from videoloop3d_torch.models.mpmesh import MPMesh
    from videoloop3d_torch.models.mpv import MPMeshVid
    sc2, sc1 = _scene(2), _scene(3)
    m2 = MPMeshVid(tparse(MPV_ARGV + ["--gpu_num", "0"]), 24, 32, _ref(sc2),
                   sc2["intrins"][0], float(sc2["bds"][0]),
                   float(sc2["bds"][1]), device=CPU)
    m1 = MPMesh(tparse(MPI_ARGV + ["--gpu_num", "0"]), 24, 32, _ref(sc1),
                sc1["intrins"][0], float(sc1["bds"][0]), float(sc1["bds"][1]),
                device=CPU)
    return m2, m1


def _row2(inp, r):
    return {"extrin": torch.from_numpy(inp["s2/extrin"][r:r + 1]),
            "intrin": torch.from_numpy(inp["s2/intrin"][r:r + 1]),
            "video": torch.from_numpy(inp["s2/video"][r])}


def _row1(inp, r):
    return {k: torch.from_numpy(inp[f"s1/{k}"][r:r + 1])
            for k in ("extrin", "intrin", "rgb", "loopmask")}


def _detached(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


# ---------------------------------------------------------------------------
# the worker (one rank)
# ---------------------------------------------------------------------------

def _worker(workdir, rank, world, init):
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.parallel.dp_step import (make_dp_stage1_step as
                                                    t_dp1,
                                                    make_dp_stage2_step as
                                                    t_dp2)
    from videoloop3d_torch.config import parse_args_with_configs as tparse
    dist.init_distributed(CPU, init, world, rank)
    grid = dist.make_mesh(n_dp=world, n_fp=1)
    inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
    m2, m1 = _torch_models(inp)
    a2 = tparse(MPV_ARGV + ["--gpu_num", "0"])
    a1 = tparse(MPI_ARGV + ["--gpu_num", "0"])
    out = {}

    def s2(tag, row, wt=None):
        step, init_opt = t_dp2(m2, a2, 24, 32, LOSSCFG, grid)
        params = _params(inp, "p2")
        opt = init_opt(params)
        batch = dict(row, **({} if wt is None else {"wt": wt}))
        m = step(params, opt, batch, LR, {k: 0.2 for k in S2_KEYS})
        out.update({f"{tag}/{k}": v for k, v in _detached(params).items()})
        out[f"{tag}/loss"] = np.float32(m["loss"])

    s2("dp2", _row2(inp, rank))
    # row 1 a weight-0 filler: a copy of row 0, or the other patch
    s2("wtA", _row2(inp, 0), 1.0 if rank == 0 else 0.0)
    s2("wtB", _row2(inp, rank), 1.0 if rank == 0 else 0.0)
    step, init_opt, _ = t_dp1(m1, a1, 24, 32, grid)
    params = _params(inp, "p1")
    opt = init_opt(params)
    m = step(params, opt, _row1(inp, rank), LR, {k: 0.1 for k in S1_KEYS})
    out.update({f"dp1/{k}": v for k, v in _detached(params).items()})
    out["dp1/loss"] = np.float32(m["loss"])
    np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    inp = dp_inputs()
    np.savez(d / "inputs.npz", **inp)
    launch(lambda i, init: [sys.executable, __file__, "worker", str(d),
                            str(i), "2", init], 2, d)
    outs = [dict(np.load(d / f"out{i}.npz")) for i in range(2)]
    return inp, outs


def _update_close(got, want, p0, tol=1e-5):
    """got == want within tol * the largest update, plus two f32 spacings
    of the largest parameter (p0 - lr g rounds to the parameter's f32
    grid; the dp update and the reference differ by f32 reduction order
    only)."""
    if want.size == 0:
        return
    upd = np.abs(want - p0).max()
    ulp = 2 * np.spacing(np.abs(p0).max().astype(np.float32))
    assert np.abs(got - want).max() <= tol * upd + ulp, \
        (np.abs(got - want).max(), upd, ulp)


def _jax_dp2(inp, wt=None, rows=(0, 1)):
    args = jax_parse(MPV_ARGV)
    sc = _scene(2)
    jm = JaxMPMeshVid(args, 24, 32, _ref(sc), sc["intrins"][0],
                      float(sc["bds"][0]), float(sc["bds"][1]))
    step, init = make_dp_stage2_step(jm, args, 24, 32, LOSSCFG,
                                     make_mesh(n_dp=2, n_fp=1))
    params = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith("p2/")}
    rows = list(rows)
    batch = {"extrin": jnp.asarray(inp["s2/extrin"][rows]),
             "intrin": jnp.asarray(inp["s2/intrin"][rows]),
             "video": jnp.asarray(inp["s2/video"][rows])}
    if wt is not None:
        batch["wt"] = jnp.asarray(np.asarray(wt, np.float32))
    p, _, m = step(params, init(params), batch, jnp.asarray(LR),
                   {k: jnp.asarray(0.2, jnp.float32) for k in S2_KEYS},
                   jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in p.items()}, float(m["loss"])


def test_torch_dp_stage2_step_matches_jax(dp_run):
    """Two ranks, a distinct patch each, one SGD step: both ranks hold the
    same params and loss, within 1e-5 of the largest update of JAX's dp
    step on the 2-row mesh (loss within 1e-5 relative)."""
    inp, outs = dp_run
    jp, jl = _jax_dp2(inp)
    for k, v in jp.items():
        np.testing.assert_array_equal(outs[0][f"dp2/{k}"],
                                      outs[1][f"dp2/{k}"])
        _update_close(outs[0][f"dp2/{k}"], v, inp[f"p2/{k}"])
    assert outs[0]["dp2/loss"] == outs[1]["dp2/loss"]
    np.testing.assert_allclose(outs[0]["dp2/loss"], jl, rtol=1e-5)


def test_torch_dp_stage2_step_is_the_mean_of_single_steps(dp_run):
    """The dp update is the mean of the port's single-process SGD updates
    on either patch (1e-5 of the largest update), its loss their mean."""
    from videoloop3d_torch.config import parse_args_with_configs as tparse
    from videoloop3d_torch.train.stage2 import make_stage2_step
    inp, outs = dp_run
    m2, _ = _torch_models(inp)
    args = tparse(MPV_ARGV + ["--gpu_num", "0"])
    singles, losses = [], []
    for r in range(2):
        step, init_opt = make_stage2_step(m2, args, 24, 32, LOSSCFG)
        params = _params(inp, "p2")
        m = step(params, init_opt(params), _row2(inp, r), LR,
                 {k: 0.2 for k in S2_KEYS})
        singles.append(_detached(params))
        losses.append(float(m["loss"]))
    for k in singles[0]:
        want = (singles[0][k] + singles[1][k]) / 2
        _update_close(outs[0][f"dp2/{k}"], want, inp[f"p2/{k}"])
    np.testing.assert_allclose(outs[0]["dp2/loss"], np.mean(losses),
                               rtol=1e-5)


def test_torch_dp_weight_zero_row_changes_nothing(dp_run):
    """A weight-0 row contributes nothing: the update with row 1 a copy of
    row 0 equals the one with row 1 the other patch, bit for bit, and
    JAX's wt-masked step on the same rows (1e-5 of the update)."""
    inp, outs = dp_run
    jp, jl = _jax_dp2(inp, wt=[1.0, 0.0], rows=(0, 1))
    for k, v in jp.items():
        np.testing.assert_array_equal(outs[0][f"wtA/{k}"],
                                      outs[0][f"wtB/{k}"])
        _update_close(outs[0][f"wtA/{k}"], v, inp[f"p2/{k}"])
    assert outs[0]["wtA/loss"] == outs[0]["wtB/loss"]
    np.testing.assert_allclose(outs[0]["wtA/loss"], jl, rtol=1e-5)


def test_torch_dp_stage1_step_matches_jax(dp_run):
    """The dp stage-1 step on two distinct patches (one a rank): within
    1e-5 of the largest update of JAX's make_dp_stage1_step on the 2-row
    mesh, the loss within 1e-5 relative."""
    inp, outs = dp_run
    args = jax_parse(MPI_ARGV)
    sc = _scene(3)
    jm = JaxMPMesh(args, 24, 32, _ref(sc), sc["intrins"][0],
                   float(sc["bds"][0]), float(sc["bds"][1]))
    step, init, _ = make_dp_stage1_step(jm, args, 24, 32,
                                        make_mesh(n_dp=2, n_fp=1))
    params = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith("p1/")}
    batch = {k: jnp.asarray(inp[f"s1/{k}"])
             for k in ("extrin", "intrin", "rgb", "loopmask")}
    p, _, m = step(params, init(params), batch, jnp.asarray(LR),
                   {k: jnp.asarray(0.1, jnp.float32) for k in S1_KEYS},
                   jax.random.PRNGKey(0))
    for k, v in p.items():
        np.testing.assert_array_equal(outs[0][f"dp1/{k}"],
                                      outs[1][f"dp1/{k}"])
        _update_close(outs[0][f"dp1/{k}"], np.asarray(v), inp[f"p1/{k}"])
    np.testing.assert_allclose(outs[0]["dp1/loss"], float(m["loss"]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# batching
# ---------------------------------------------------------------------------

class _DS:
    """iter_epoch of a VideoPatchDataset stand-in: n items over 3 views
    (view 0 the reference config)."""

    def __init__(self, n):
        self.n = n

    def iter_epoch(self, rng, shuffle=True):
        for i in rng.permutation(self.n):
            v = int(i) % 3
            yield {"id": int(i), "view": v,
                   "losscfg": {"ref": v == 0}}


@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_torch_dp_serial_batching(n_dp):
    """--dp_serial_below: a level with fewer patches feeds one real patch
    a step in row 0 (the other rows weight-0 copies), in the order and
    count of the single-device feed; at or above it, batches of n_dp
    patches (the last padded with weight-0 copies), every patch once."""
    from videoloop3d_torch.train.stage2 import batched_items
    single = [(k, [it["id"] for it in items]) for k, items, _ in
              batched_items(_DS(13), np.random.default_rng(0), 1, 0)]
    serial = batched_items(_DS(13), np.random.default_rng(0), n_dp, 14)
    assert [(k, [items[0]["id"]]) for k, items, _ in serial] == single
    for k, items, wts in serial:
        assert len(items) == n_dp
        assert all(it is items[0] for it in items)
        if n_dp > 1:
            np.testing.assert_array_equal(wts, [1.0] + [0.0] * (n_dp - 1))
    batched = batched_items(_DS(13), np.random.default_rng(0), n_dp, 13)
    seen = []
    for k, items, wts in batched:
        assert len(items) == n_dp
        w = np.ones(n_dp) if wts is None else wts
        seen += [it["id"] for it, x in zip(items, w) if x == 1.0]
        assert all(repr(sorted(it["losscfg"].items())) == k for it in items)
    assert sorted(seen) == list(range(13))
    assert len(batched) == sum(-(-c // n_dp) for c in (5, 8))


def test_torch_shard_views_batching():
    """--shard_views batching: rows are process-major and a row trains
    only its process's views; weight-0 fillers are the process's own;
    every patch is trained once an epoch."""
    from videoloop3d_torch.train import stage2 as TS2
    owner = {0: 0, 1: 1, 2: 0}
    for n_dp, serial in ((2, 0), (2, 100), (4, 0)):
        nproc = 2
        orig = TS2.dist.world_size
        TS2.dist.world_size = lambda: nproc
        try:
            b = TS2.batched_items(_DS(12), np.random.default_rng(1), n_dp,
                                  serial, owner)
        finally:
            TS2.dist.world_size = orig
        seen = []
        rows_pp = n_dp // nproc
        for _, items, wts in b:
            for j, (it, w) in enumerate(zip(items, wts)):
                assert owner[it["view"]] == j // rows_pp
                if w == 1.0:
                    seen.append(it["id"])
        assert sorted(seen) == list(range(12))


# ---------------------------------------------------------------------------
# the trainer under --dp_serial_below
# ---------------------------------------------------------------------------

def _trainer_argv(root, exp, extra=()):
    return ["--datadir", os.path.join(root, "scene"),
            "--expdir", os.path.join(root, exp), "--expname", "s",
            "--factor", "1", *GEOM, "--mpv_frm_num", "4", "--mpv_isloop",
            "--patch_h_size", "24", "--patch_w_size", "32",
            "--patch_h_stride", "16", "--patch_w_stride", "24",
            "--lrate", "0.3", "--lrate_decay", "100", "--lrate_adaptive",
            "--pyr_minimal_dim", "20", "--pyr_num_epoch", "2",
            "--i_weights", "100", "--i_video", "1000", "--i_img", "1",
            "--i_print", "1000", "--scale_invariant", "--init_std", "0.02",
            "--loss_name", "gpnn_lm", "--loss_name_ref", "gpnn_lm",
            "--swd_patch_size", "3", "--swd_patcht_size", "3",
            "--swd_stride", "2", "--swd_stridet", "1",
            "--swd_patch_size_ref", "3", "--swd_patcht_size_ref", "3",
            "--swd_stride_ref", "2", "--swd_stridet_ref", "1",
            "--swd_macro_block", "17", "--loss_ref_idx", "0",
            "--rgb_smooth_loss_weight", "0.2",
            "--a_smooth_loss_weight", "0.2", "--seed", "1", "--gpu_num",
            "0", "--dp_serial_below", "100000", *extra]


def _series(rundir, tag):
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r["value"] for r in rows if r["tag"] == f"stage2/{tag}"]


def _two_process_trainer(tmp_path, extra):
    """train_3dvid in two processes (argv plus extra) and in one; returns
    (the two runs' loss series, the two-process run's files)."""
    from videoloop3d_torch.tools import train_3dvid
    root = str(tmp_path)
    jsyn.write_llff_dir(_scene(3), os.path.join(root, "scene"), factor=1)
    launch(lambda i, init: [
        sys.executable, "-m", "videoloop3d_torch.tools.train_3dvid",
        *_trainer_argv(root, "two", extra), "--num_processes", "2",
        "--process_id", str(i), "--coordinator_address", init], 2, tmp_path)
    train_3dvid.main(_trainer_argv(root, "single"))
    single = _series(os.path.join(root, "single", "s"), "loss")
    two = _series(os.path.join(root, "two", "s"), "loss")
    return single, two, os.listdir(os.path.join(root, "two", "s"))


def test_torch_dp_serial_trainer_matches_single_process(tmp_path):
    """train_3dvid with two processes at dp = 2 (--mesh_fp 1) under
    --dp_serial_below (one real patch a step, the other row a weight-0
    copy) reproduces the single-process loss series within 1e-4
    relative, and only rank 0 writes metrics.jsonl and the checkpoint."""
    single, dp, files = _two_process_trainer(tmp_path, ["--mesh_fp", "1"])
    assert len(single) == len(dp) > 3
    np.testing.assert_allclose(dp, single, rtol=1e-4)
    assert any(f.startswith("ckpt_") for f in files)


def test_torch_fp_trainer_matches_single_process(tmp_path):
    """train_3dvid with two processes at the default --mesh_fp (fp = 2:
    4 frames, pt 3) reproduces the single-process loss series within
    1e-4 relative, and rank 0 writes the gathered checkpoint."""
    single, fp, files = _two_process_trainer(tmp_path, [])
    assert len(single) == len(fp) > 3
    np.testing.assert_allclose(fp, single, rtol=1e-4)
    assert any(f.startswith("ckpt_") for f in files)


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
