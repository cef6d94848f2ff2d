"""The system under test: the program's stage-2 optimizer step
(``videoloop3d_torch.train.stage2.make_stage2_step``), set up and fed as
``train()`` sets it up and feeds it at one pyramid level.

Set-up follows ``train()``: the model (``models/mpv.py:MPMeshVid``) from
the sparse MTV as a stage-1 checkpoint would give it, ``lod`` to the
level, the level's ``VideoPatchDataset``, ``set_compact_slots`` and
``set_sparse_fastpath_bounds``, one step per loss config and one Adam
over the parameters.  The feed follows ``train()``'s loop: the epoch
order of ``batched_items``, the learning rate of ``lr_schedule`` divided
by the epoch's steps (``--lrate_adaptive``), the +-0.5 px principal-point
jitter drawn from the same numpy generator right before each step, the
crop by view and origin from the device-resident uint8 videos, and the
loss read on the host every 8 steps.

Left out of ``train()``: checkpoints every 50 epochs, previews, scalar
logging, the epoch's print line, the watchdog and the shutdown poll.
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import scene as scene_mod


def program_argv(config):
    """The configuration's program arguments as a command line."""
    argv = []
    for key, value in config["args"].items():
        if isinstance(value, bool):
            if value:
                argv.append(f"--{key}")
        else:
            argv += [f"--{key}", str(value)]
    return argv


class System:
    """One cell's trainer state: model, parameters, optimizer, steps and
    the epoch stream, on `device`."""

    def __init__(self, config, traffic, seed, device):
        from videoloop3d_torch.config import parse_args_with_configs
        from videoloop3d_torch.data.patches import VideoPatchDataset
        from videoloop3d_torch.models.geometry import MPIGeometry
        from videoloop3d_torch.models.mpv import MPMeshVid
        from videoloop3d_torch.train import common
        from videoloop3d_torch.train import stage2 as S2

        marks = [("start", time.perf_counter())]
        self.device = torch.device(device)
        sc = config["scene"]
        args = parse_args_with_configs(program_argv(config))
        self.args = args
        H, W = sc["H"], sc["W"]
        ref_intrin = scene_mod.ref_intrinsic(sc)
        tm_s, tm_d = scene_mod.tile_layout(sc)
        geom = MPIGeometry.create(
            SimpleNamespace(mpi_h_scale=sc["mpi_scale"],
                            mpi_w_scale=sc["mpi_scale"], mpi_d=sc["planes"],
                            mpi_h_verts=sc["verts_h"],
                            mpi_w_verts=sc["verts_w"]),
            H, W, np.eye(4, dtype=np.float32), ref_intrin, sc["near"],
            sc["far"])
        model = MPMeshVid(args, H, W, np.eye(4, dtype=np.float32),
                          ref_intrin, sc["near"], sc["far"],
                          device=self.device)
        model.restore_checkpoint({
            "meta": {"is_sparse": True,
                     "tile_hw": list(geom.default_tile_texels()),
                     "frm_num": sc["frames"], "extra": {}},
            "geom": geom, "params": {}, "tile_map_static": tm_s,
            "tile_map_dyn": tm_d})
        marks.append(("model", time.perf_counter()))
        params = scene_mod.texels(sc, int((tm_s >= 0).sum()),
                                  int((tm_d >= 0).sum()), seed, self.device)
        marks.append(("texels", time.perf_counter()))
        factor, hw, _ = S2.pyramid_schedule(args, H, W)[traffic["level"]]
        params = model.lod(params, factor)

        poses, intrins = scene_mod.rig(sc)
        views, _ = scene_mod.train_views(sc)
        refs = S2._ref_views(args)
        cfg_other = S2.loss_config_from_args(args, ref=False)
        cfg_ref = S2.loss_config_from_args(args, ref=True)
        loss_cfgs = [cfg_ref if v in refs else cfg_other for v in views]
        # the dataset's bookkeeping only: the trainer crops on the device
        # from the resident stack below, never from the dataset's videos
        empty = np.empty((0, H, W, 3), np.uint8)
        dataset = VideoPatchDataset(
            hw, [empty] * len(views), (args.patch_h_size, args.patch_w_size),
            (args.patch_h_stride, args.patch_w_stride), poses[views],
            intrins[views], loss_cfgs)
        tag = f"[portbench] l{traffic['level']}"
        marks.append(("dataset", time.perf_counter()))
        S2.set_compact_slots(model, args, dataset, tag)
        common.set_sparse_fastpath_bounds(model, args, tag,
                                          fast_grad_flag="fast_stage2_grad")
        marks.append(("slot bound", time.perf_counter()))
        ph, pw = dataset.patch_size
        vids = scene_mod.videos(sc, traffic["content"], len(views), seed,
                                self.device)
        pad_h, pad_w = dataset.pad
        if pad_h or pad_w:
            vids = torch.nn.functional.pad(vids, (0, 0, 0, pad_w, 0, pad_h))
        self.videos = vids.contiguous()
        marks.append(("videos", time.perf_counter()))
        self.steps = {}
        for cfg in loss_cfgs:
            key = repr(sorted(cfg.items()))
            if key not in self.steps:
                self.steps[key] = S2.make_stage2_step(model, args, ph, pw,
                                                      cfg)
        self.ref_key = repr(sorted(cfg_ref.items()))
        self.optimizer = next(iter(self.steps.values()))[1](params)
        self.weights = common.extra_loss_weights(args,
                                                 S2.STAGE2_WEIGHT_KEYS)
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(seed) % (2 ** 63))
        self.model, self.params, self.dataset = model, params, dataset
        self.read_every = int(traffic["loss_read_every"])
        self.np_rng = np.random.default_rng(int(seed))
        self.iter = 0
        self.failed_reads = 0
        self._stream = self._epochs()
        marks.append(("steps", time.perf_counter()))
        # seconds of each set-up stage, for the run's standard error
        self.setup_s = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}

    def _epochs(self):
        """Step descriptions, epoch after epoch, drawn as ``train()``
        draws them."""
        from videoloop3d_torch.train import optimizer as opt_lib
        from videoloop3d_torch.train import stage2 as S2
        args = self.args
        epoch = 0
        while True:
            batches = S2.batched_items(self.dataset, self.np_rng, 1,
                                       args.dp_serial_below)
            for key, items, _ in batches:
                lr = opt_lib.lr_schedule(epoch, args.lrate,
                                         decay_steps_k=args.lrate_decay)
                if args.lrate_adaptive:
                    lr = lr / len(batches)
                item = items[0]
                intrin = np.array(item["intrin"], copy=True)
                jitter = np.zeros(2)
                if args.add_intrin_noise:
                    # common.jitter_intrinsic's draw, kept for the reference
                    jitter = self.np_rng.random(2) - 0.5
                    intrin[..., :2, 2] += jitter
                w0, h0 = item["wh_start"]
                yield SimpleNamespace(
                    key=key, ref=key == self.ref_key, view=item["view"],
                    h0=h0, w0=w0, pose=item["pose"], intrin=intrin,
                    jitter=jitter, lr=lr, epoch=epoch)
            epoch += 1

    def next_batch(self):
        return next(self._stream)

    def run(self, b):
        """One optimizer step of description b; returns its metrics
        (device tensors).  The loss is read on the host every
        `read_every` steps (the trainer's bounded run-ahead)."""
        from videoloop3d_torch.core import cameras
        dev = self.device
        batch = {
            "extrin": torch.as_tensor(
                cameras.pose_to_extrinsic(b.pose)[None].astype(np.float32),
                device=dev),
            "intrin": torch.as_tensor(
                np.asarray(b.intrin, np.float32)[None], device=dev),
            "videos": self.videos, "view": b.view, "h0": b.h0, "w0": b.w0}
        metrics = self.steps[b.key][0](self.params, self.optimizer, batch,
                                       b.lr, self.weights, self.gen)
        if self.iter % self.read_every == 0 \
                and not math.isfinite(float(metrics["loss"])):
            self.failed_reads += 1
        self.iter += 1
        return metrics

    def leaves(self):
        return {k: v for k, v in self.params.items()
                if isinstance(v, torch.Tensor) and v.requires_grad}

    def first_gradient(self):
        """Each leaf's gradient as Adam got it at its first step, from its
        first moment: m_1 = (1 - beta1) g_1."""
        out = {}
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        for k, p in self.leaves().items():
            m = self.optimizer.state.get(p, {}).get("exp_avg")
            out[k] = torch.zeros_like(p) if m is None else m / (1.0 - beta1)
        return out

    def free(self):
        """Drop every device tensor of the program."""
        for name in ("steps", "optimizer", "params", "model", "videos",
                     "gen", "dataset"):
            setattr(self, name, None)
