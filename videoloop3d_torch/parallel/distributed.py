"""Multi-process training over ``torch.distributed`` (counterpart of
``videoloop3d_tpu/parallel/distributed.py`` and ``parallel/mesh.py``).

The JAX package drives every device from one process on a ('dp', 'fp')
mesh.  The port runs one process per rank instead:

* a process learns its rank from ``--num_processes``, ``--process_id``
  and ``--coordinator_address`` (``host:port``, ``tcp://...`` or
  ``file://...``), or else from torchrun's ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` (`maybe_init_from_args`);
* rank r computes on ``cuda:(r mod device_count)``, or on the CPU under
  ``--gpu_num 0``;
* the backend is NCCL where every rank on a host has a GPU of its own,
  and gloo where ranks share a device (NCCL refuses two ranks on one
  device) or run on the CPU (`choose_backend`).  gloo has no CUDA
  collective but all_reduce and broadcast, so under gloo every collective
  of a CUDA tensor goes through the host, on every run (`Comm.host`);
* `make_mesh` lays the ranks out as a (dp, fp) grid, fp ranks contiguous
  so that the frame ring stays inside a host, with one ``new_group`` per
  dp row (its fp ring) and per fp column (its dp group).

Every rank builds the same global batch from the same seeded dataset and
takes its dp row (`commit_batch`); parameters are replicated, but for
the frame-parallel step's ``atlas_dyn``, which each fp rank holds for its
own frames (`shard_params_by_frames`, `gather_params_by_frames`).
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

FRAME_AXIS = 3          # atlas_dyn (N | D, th | Ht, tw | Wt, F, C)
FRAME_SHARDED = ("atlas_dyn",)


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary():
    """True on the process that writes files (checkpoints, previews,
    logs): rank 0, and always in a single process."""
    return rank() == 0


def choose_backend(device, local_world):
    """NCCL where each of the local_world ranks on this host has a GPU of
    its own, gloo where they share one or run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, r=None):
    """The device rank r computes on: ``cuda:(r mod device_count)`` for a
    CUDA device, else the device itself."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    r = rank() if r is None else r
    return torch.device("cuda", r % torch.cuda.device_count())


def _init_method(address):
    if address.startswith(("tcp://", "file://", "env://")):
        return address
    return f"tcp://{address}"


def init_distributed(device, coordinator_address=None, num_processes=None,
                     process_id=None):
    """Idempotent ``torch.distributed.init_process_group``; returns the
    rank's device.  Explicit arguments win; a missing one is read from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  Prints the backend it chose."""
    if dist.is_initialized():
        return rank_device(device)
    env = os.environ
    world = num_processes or int(env.get("WORLD_SIZE", 1))
    r = process_id if process_id is not None else int(env.get("RANK", 0))
    if coordinator_address:
        init = _init_method(coordinator_address)
    elif env.get("MASTER_ADDR"):
        init = "env://"
    else:
        raise ValueError("a multi-process run needs --coordinator_address "
                         "or torchrun's MASTER_ADDR / MASTER_PORT")
    if not 0 <= r < world:
        raise ValueError(f"process id {r} outside a world of {world}")
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, r)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=r)
    print(f"[dist] rank {r} of {world} on {dev}, backend {backend}"
          + (" (collectives of CUDA tensors through the host)"
             if backend == "gloo" and dev.type == "cuda" else ""),
          flush=True)
    return dev


def maybe_init_from_args(args, device):
    """Trainer and tool hook: initialise the process group when the
    arguments (or torchrun's environment) ask for more than one process.
    Returns the device this process computes on."""
    coord = args.coordinator_address or None
    nproc = int(args.num_processes or 0) or None
    pid = None if int(args.process_id) < 0 else int(args.process_id)
    if coord or (nproc or 0) > 1 or int(os.environ.get("WORLD_SIZE",
                                                         1)) > 1:
        return init_distributed(device, coord, nproc, pid)
    return torch.device(device)


def check_world(args):
    """Raise ValueError before any work when ``--mesh_devices`` asks for a
    number of ranks other than the world's (0 takes the world)."""
    n = int(args.mesh_devices)
    if n not in (0, world_size()):
        raise ValueError(
            f"--mesh_devices {n} does not match the {world_size()} "
            "process(es) of this run: the port runs one process per "
            "rank (launch with --num_processes or torchrun)")


class Comm:
    """The collectives of one process group (None: the whole world; a
    group of one rank makes each of them the identity).  host: stage CUDA
    tensors through host memory (gloo), on every call.  ``ms`` sums the
    host time spent in the collectives while ``timing`` is on (each then
    synchronises the device before and after).  Off the host path a
    collective reads its input where it lies; only `all_reduce`, which
    reduces in place, copies it first, unless the caller hands it over
    (``inplace=True``)."""

    def __init__(self, group, ranks, host):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank())
        self.host = host
        self.timing = False
        self.ms = 0.0

    def _run(self, t, fn, copy=False):
        if self.timing and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dev = t.device
        if self.host and t.is_cuda:
            # through page-locked host memory, which the device copies at
            # a higher rate than pageable memory (PyTorch's caching host
            # allocator keeps the buffers)
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t.detach())
            out = fn(h).to(dev)
        else:
            out = fn(t.detach().clone() if copy else t.detach())
        if self.timing:
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            self.ms += 1e3 * (time.perf_counter() - t0)
        return out

    def all_reduce(self, t, op="sum", inplace=False):
        """The elementwise sum (or "min", "max") of t over the group.
        inplace: t is the caller's scratch (a fresh buffer it does not
        read again), reduced in place with no copy where no host staging
        is needed."""
        if self.size == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}[op]

        def fn(b):
            dist.all_reduce(b, red, group=self.group)
            return b
        return self._run(t, fn, copy=not inplace)

    def all_gather(self, t):
        """(size, *t.shape): every rank's t in group order."""
        if self.size == 1:
            return t[None]

        def fn(b):
            out = [torch.empty_like(b) for _ in range(self.size)]
            dist.all_gather(out, b.contiguous(), group=self.group)
            return torch.stack(out)
        return self._run(t, fn)

    def shift(self, t, step):
        """The t of the rank `step` places on in the ring (index + step mod
        size); this rank's t goes to index - step."""
        if self.size == 1:
            return t.clone()
        src = self.ranks[(self.index + step) % self.size]
        dst = self.ranks[(self.index - step) % self.size]

        def fn(b):
            out = torch.empty_like(b)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, b.contiguous(), dst, self.group),
                dist.P2POp(dist.irecv, out, src, self.group)])
            for q in reqs:
                q.wait()
            return out
        return self._run(t, fn)


@dataclasses.dataclass
class Grid:
    """The (dp, fp) rank grid: rank = dp_rank * n_fp + fp_rank.  dp is
    the Comm of this rank's fp column (its gradient mean), fp the Comm of
    its dp row (the frame ring)."""
    n_dp: int
    n_fp: int
    dp_rank: int
    fp_rank: int
    dp: Comm
    fp: Comm


def _host_staging():
    return dist.is_initialized() and dist.get_backend() == "gloo"


def make_mesh(n_dp=0, n_fp=1):
    """The (dp, fp) grid over the world's ranks (n_dp 0: world / n_fp).
    Every rank must call it (``new_group`` is collective); a single
    process gets a grid of one rank."""
    world = world_size()
    if n_dp == 0:
        if world % n_fp:
            raise ValueError(f"fp={n_fp} does not divide {world} ranks")
        n_dp = world // n_fp
    if n_dp * n_fp != world:
        raise ValueError(f"dp={n_dp} x fp={n_fp} != {world} ranks")
    r = rank()
    host = _host_staging()
    rows = [list(range(d * n_fp, (d + 1) * n_fp)) for d in range(n_dp)]
    cols = [list(range(f, world, n_fp)) for f in range(n_fp)]

    def comm_of(groups):
        mine = None
        for ranks in groups:
            g = dist.new_group(ranks) if world > 1 else None
            if r in ranks:
                mine = Comm(g, ranks, host)
        return mine
    fp = comm_of(rows)
    dp = comm_of(cols)
    return Grid(n_dp, n_fp, r // n_fp, r % n_fp, dp, fp)


def fold_seed(seed, dp_rank):
    """The seed of dp row dp_rank's torch.Generator (the counterpart of
    ``fold_in(rng, axis_index("dp"))``): the seed itself for row 0."""
    if dp_rank == 0:
        return int(seed)
    s = np.random.SeedSequence([int(seed), int(dp_rank)])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def commit_batch(grid, items, per_row=1):
    """This rank's dp row of a global batch of n_dp * per_row items that
    every rank built identically."""
    if len(items) != grid.n_dp * per_row:
        raise ValueError(f"{len(items)} items for {grid.n_dp} dp rows of "
                         f"{per_row}")
    return items[grid.dp_rank * per_row:(grid.dp_rank + 1) * per_row]


def partition_views(train_view, ref_idxs, nproc):
    """Owner process for every train view (per-process data loading).

    Round-robins each loss-config class (reference vs other views,
    train_3dvid.py:160-192) over processes separately, so every process
    gets a proportional share of each config when counts allow.
    Returns {view_id: process_index}.  Raises if some process would own
    zero views (it could never contribute real data)."""
    ref = [v for v in train_view if v in ref_idxs]
    oth = [v for v in train_view if v not in ref_idxs]
    owner = {}
    for cls in (ref, oth):
        for i, v in enumerate(cls):
            owner[v] = i % nproc
    counts = [sum(1 for p in owner.values() if p == q)
              for q in range(nproc)]
    if min(counts) == 0:
        raise ValueError(
            f"--shard_views: {len(train_view)} train views cannot give "
            f"every one of {nproc} processes a view (counts {counts}); "
            f"run with fewer processes or without --shard_views")
    return owner


def build_sharded_video_stack(owner, positions, videos_local, device):
    """This process's stack of the views it owns, on `device`, and
    local_index {position: index into its owner's stack}, the same on
    every process.  owner maps a position of `positions` to its process;
    videos_local holds None for another process's views."""
    per_proc = [[] for _ in range(world_size())]
    local_index = {}
    for pos in positions:
        p = owner[pos]
        local_index[pos] = len(per_proc[p])
        per_proc[p].append(pos)
    mine = per_proc[rank()]
    stack = np.stack([videos_local[pos] for pos in mine])
    return torch.as_tensor(stack, device=device), local_index


def any_process_flag(flag):
    """OR of a host bool over every process: a MAX all_reduce of one
    element.  Collective (every process calls it at the same point);
    the flag itself in a single process."""
    if world_size() == 1:
        return bool(flag)
    dev = torch.device("cpu") if _host_staging() \
        else torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    return bool(Comm(None, range(world_size()), False).all_reduce(
        t, "max", inplace=True).item())


def frame_slice(n_frames, grid):
    """The frames [f0, f1) of this rank's fp index."""
    if n_frames % grid.n_fp:
        raise ValueError(f"{n_frames} frames do not divide over fp="
                         f"{grid.n_fp}")
    fl = n_frames // grid.n_fp
    return grid.fp_rank * fl, (grid.fp_rank + 1) * fl


def shard_params_by_frames(params, grid):
    """Params in the frame-parallel layout: ``atlas_dyn`` cut to a
    contiguous copy of this rank's frames (axis 3), the rest as they
    are.  Carries a JAX or port checkpoint's params into the fp step."""
    if grid.n_fp == 1:
        return params
    out = dict(params)
    for k in FRAME_SHARDED:
        f0, f1 = frame_slice(params[k].shape[FRAME_AXIS], grid)
        out[k] = params[k].detach()[:, :, :, f0:f1].contiguous()
    return out


def gather_params_by_frames(params, grid):
    """The inverse of `shard_params_by_frames`: every fp rank's frames of
    ``atlas_dyn`` concatenated in rank order (collective over fp)."""
    if grid.n_fp == 1:
        return params
    out = dict(params)
    for k in FRAME_SHARDED:
        parts = grid.fp.all_gather(params[k].detach())
        out[k] = torch.cat(list(parts), dim=FRAME_AXIS)
    return out


def gather_for_host(params, grid=None):
    """The params on the host for a checkpoint: replicated leaves copied,
    a frame-sharded ``atlas_dyn`` gathered along F.  Collective when
    grid has fp > 1 (every rank calls it)."""
    if grid is not None:
        params = gather_params_by_frames(params, grid)

    def host(v):
        return {k: host(u) for k, u in v.items()} if isinstance(v, dict) \
            else v.detach().cpu()
    return host(params)
