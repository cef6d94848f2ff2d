"""The shape of each traced step, as the counts need it: the slot bound,
the number of slot-pixels, static and dynamic hits, the tiles they touch
and the loss's crop plan.  Worked out with the reference's own sweep
(``reference/stage2.py``), not read from the program."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench import correct
from portbench import scene as scene_mod
from portbench.reference import stage2 as ref


class Shapes:
    """Step shapes of one cell: the fixed part once, the hits per step."""

    def __init__(self, config, traffic, device):
        sc, args = config["scene"], config["args"]
        self.sc, self.args, self.device = sc, args, device
        self.geom = ref.geometry(sc)
        tm_s, tm_d = scene_mod.tile_layout(sc)
        self.maps = tuple(torch.as_tensor(m, device=device)
                          for m in (tm_s, tm_d))
        self.Ns, self.Nd = int((tm_s >= 0).sum()), int((tm_d >= 0).sum())
        poses, intrins = scene_mod.rig(sc)
        self.views, self.is_ref = scene_mod.train_views(sc)
        H, W = sc["H"], sc["W"]
        (h, w), pad, self.patch, _ = correct.level_grid(args, H, W,
                                                        traffic["level"])
        intr = intrins[self.views].astype(np.float32).copy()
        intr[:, 0] *= w / W
        intr[:, 1] *= h / H
        self.intr = intr
        hom = np.zeros((len(self.views), 4, 4), np.float32)
        hom[:, :3] = poses[self.views]
        hom[:, 3, 3] = 1.0
        self.extr = np.linalg.inv(hom)
        self.S = ref.slot_bound(self.geom, self.maps, self.extr, intr,
                                h + pad[0], w + pad[1])
        th, tw = self.geom.tile_hw
        self.n_params = (self.Ns * th * tw * sc["channels"]
                         + self.Nd * th * tw * sc["frames"] * sc["channels"])

    def of(self, b):
        """The shape of the step of description b."""
        sc, g = self.sc, self.geom
        ph, pw = self.patch
        K = self.intr[b.view].copy()
        K[0, 2] -= b.w0
        K[1, 2] -= b.h0
        K[:2, 2] += b.jitter
        with torch.no_grad():
            G = ref.homographies(
                g, torch.as_tensor(self.extr[b.view][None], device=self.device),
                torch.as_tensor(K[None], device=self.device)).contiguous()
            s = {k: v[0] for k, v in ref.sweep(g, self.maps, G, ph, pw)
                 .items()}
            if self.S < g.n_planes:
                s = ref.compact(s, self.S)
            ks, kd = s["k_s"], s["k_d"]
            hits_s, hits_d = int((ks >= 0).sum()), int((kd >= 0).sum())
            used_s = int(torch.unique(ks[ks >= 0]).numel())
            used_d = int(torch.unique(kd[kd >= 0]).numel())
        lc = correct.loss_config(self.args, self.is_ref[b.view])
        pt = lc["patcht_size"]
        F = sc["frames"]
        Fx = F + pt - 1
        plan = ref.crop_plan(Fx, F, ph, pw, (pt, lc["patch_size"],
                                             lc["patch_size"]),
                             (lc["stridet"], lc["stride"], lc["stride"]),
                             lc["macro_block"])
        th, tw = g.tile_hw
        return SimpleNamespace(
            h=ph, w=pw, F=F, Fx=Fx, C=sc["channels"], D=g.n_planes,
            S=self.S, nth=g.nth, ntw=g.ntw, th=th, tw=tw, Ns=self.Ns,
            Nd=self.Nd, n_sp=ks.numel(), n_dyn=hits_d, hits_s=hits_s,
            used_s=used_s, used_d=used_d, decoder=sc["decoder"], plan=plan,
            n_params=self.n_params)
