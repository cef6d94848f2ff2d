"""MPMeshVid — the stage-2 model: Multi-plane Tile Video (counterpart of
``videoloop3d_tpu/models/mpv.py``).

Sparse phase: ``atlas (Ns, th, tw, 4)`` static tiles plus a tile-major
``atlas_dyn (Nd, th, tw, F, 4)`` dynamic stack (one texel holds all F
frames contiguously), addressed through per-plane int32 tile maps.

Renders of a sparse model (the shipped direct decoder):

* eval (``training=False``, frames ``ts``): K1 (warp + tile lookup), K2
  (static samples), K3 (dynamic samples) and K4 (decode + select +
  composite), over all D planes (the eval path is never compacted);
* training (all frames): K1, then
  - with ``compact_slots`` = S < D (``--compact_hits``, set per pyramid
    level by the trainer): K13 compacts the sweep to S slots per pixel
    (``render/compact.py``) and the samplers run at (S, h, w);
    otherwise at (D, h, w);
  - K2/K9 for the static tiles, K3/K10 for the dynamic tiles
    (``renderer.sample_sparse``, ``render/sample.py:sample_tiles``;
    gradients accumulated in f32 and rounded once to the texel dtype;
    the backward scatters straight from the slots);
  - with ``--fused_render``: K14/K15 (``render/fused.py:
    fused_composite``), decode, select, composite, the stack
    regularizers and the disparity in one autograd Function; otherwise
    decode, select and the reverse-cumprod composite as plain autograd
    and the regularizers on the (S or D, h, w, F) stacks
    (`training_extras`, renormalized by S/mpi_d as in the JAX package).

`lod` resizes the tiles for the coarse-to-fine pyramid
(``core/resize.py``).  Dense models (scratch init, dense checkpoints),
non-direct decoders and uv noise raise `NotImplementedError` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videoloop3d_torch.core.activations import get_activation
from videoloop3d_torch.core.resize import resize_tiles
from videoloop3d_torch.losses import regularizers as regs
from videoloop3d_torch.models.checkpoint import params_from_numpy
from videoloop3d_torch.models.geometry import MPIGeometry
from videoloop3d_torch.models.mpmesh import (MPMeshConfig, _NOT_PORTED,
                                             decode_rgba, parse_bg_color)
from videoloop3d_torch.render import renderer as R
from videoloop3d_torch.render.compact import compact_sweep
from videoloop3d_torch.render.fused import (FusedCfg, composite,
                                            fused_composite)
from videoloop3d_torch.render.sample import bilinear_tiles_tilemajor

DENSE_NOT_PORTED = ("the dense stage-2 phase (a scratch start or a dense "
                    "checkpoint) is not ported yet (ROADMAP Queue B Q10: "
                    "bilinear_planes_tilemajor)")


class MPMeshVid:
    def __init__(self, args, H, W, ref_extrin, ref_intrin, near, far, *,
                 device):
        self.base_geom = MPIGeometry.create(args, H, W, ref_extrin,
                                            ref_intrin, near, far)
        self.geom = self.base_geom
        self.cfg = MPMeshConfig.from_args(args)
        self.H, self.W = H, W
        self.frm_num = int(args.mpv_frm_num)
        self.isloop = bool(args.mpv_isloop)
        self.device = torch.device(device)
        self.is_sparse = False
        # (D, n_tiles_h, n_tiles_w) int32 tensors on self.device
        self.tile_map_static = None
        self.tile_map_dyn = None
        self.tile_hw = None
        self.base_tile_hw = None
        # --fp16: texels are gathered in bfloat16 and decoded/composited
        # in f32; parameters stay f32
        self.dtype = torch.float32
        self.gather_dtype = torch.bfloat16 if args.fp16 else torch.float32
        # --compact_hits: the static per-pixel hit bound S set by the
        # trainer per level (render/compact.py:slot_bound); None disables
        # compaction
        self.compact_slots = None

    def _maps_to_device(self, tm_s, tm_d):
        def conv(tm):
            return None if tm is None else torch.as_tensor(
                np.asarray(tm, np.int32), device=self.device).contiguous()
        self.tile_map_static = conv(tm_s)
        self.tile_map_dyn = conv(tm_d)

    def init_from_stage1(self, ckpt):
        """Consume a stage-1 checkpoint.  Sparse: static tiles stay static,
        dynamic tiles broadcast over frames.  Dense: the whole atlas
        becomes the dynamic stack.  Returns params (device tensors)."""
        meta, p = ckpt["meta"], ckpt["params"]
        self.base_geom = ckpt["geom"]
        self.geom = ckpt["geom"]
        ck_type = meta.get("extra", {}).get("rgb_mlp_type")
        if ck_type and ck_type != self.cfg.rgb_mlp_type:
            print(f"[mpv] adopting rgb_mlp_type={ck_type} from the "
                  f"stage-1 checkpoint (args said {self.cfg.rgb_mlp_type})")
            self.cfg = dataclasses.replace(self.cfg, rgb_mlp_type=ck_type)
        if meta["is_sparse"]:
            self.is_sparse = True
            self._maps_to_device(ckpt["tile_map_static"],
                                 ckpt["tile_map_dyn"])
            self.tile_hw = tuple(meta["tile_hw"])
            self.base_tile_hw = self.tile_hw
            src = p["atlas_dyn"]
            atlas = p["atlas"]
        else:
            self.is_sparse = False
            src = p["atlas"]
            atlas = np.zeros((0, 1, 1, src.shape[-1]), np.float32)
        C = src.shape[-1]
        dyn = np.broadcast_to(src[..., None, :],
                              src.shape[:-1] + (self.frm_num, C))
        params = {"atlas": atlas, "atlas_dyn": dyn}
        if "verts" in p:
            params["verts"] = p["verts"]
        return params_from_numpy(params, self.device, self.dtype)

    def restore_checkpoint(self, ckpt):
        """Restore a stage-2 (mpv) checkpoint; returns params (device
        tensors).  Used by the trainer's auto-resume and the render and
        eval tools."""
        meta = ckpt["meta"]
        self.geom = ckpt["geom"]
        extra = meta.get("extra", {})
        base_hw = extra.get("base_mpi_hw")
        self.base_geom = ckpt["geom"].scaled(*base_hw) if base_hw \
            else ckpt["geom"]
        self.is_sparse = meta["is_sparse"]
        self._maps_to_device(ckpt["tile_map_static"], ckpt["tile_map_dyn"])
        self.tile_hw = tuple(meta["tile_hw"]) if meta["tile_hw"] else None
        base = extra.get("base_tile_hw")
        self.base_tile_hw = tuple(base) if base else self.tile_hw
        if meta.get("frm_num"):
            self.frm_num = int(meta["frm_num"])
        return params_from_numpy(ckpt["params"], self.device, self.dtype)

    def lod(self, params, factor):
        """Level-of-detail resize of the tiles to the base tile size times
        `factor` (at least 2 texels; ref MPV.py:140-198): returns new
        params, or `params` when the size does not change."""
        if not self.is_sparse:
            raise NotImplementedError(DENSE_NOT_PORTED)
        bth, btw = self.base_tile_hw
        nth = max(int(bth * factor), 2)
        ntw = max(int(btw * factor), 2)
        if (nth, ntw) == self.tile_hw:
            return params
        out = dict(params)
        with torch.no_grad():
            for key in ("atlas", "atlas_dyn"):
                if params[key].shape[0] > 0:
                    out[key] = resize_tiles(params[key].detach(), (nth, ntw))
        self.tile_hw = (nth, ntw)
        return out

    def _check_render_supported(self, training):
        cfg = self.cfg
        if not self.is_sparse:
            raise NotImplementedError(
                "dense (non-sparse) mpv checkpoints are not ported yet "
                "(ROADMAP Queue A, item 2: dense render, Queue B Q10 "
                "bilinear_planes_tilemajor)")
        if cfg.rgb_mlp_type != "direct":
            raise NotImplementedError(
                f"rgb_mlp_type '{cfg.rgb_mlp_type}' {_NOT_PORTED}")
        for name in (cfg.rgb_activate, cfg.alpha_activate):
            get_activation(name)            # raises unless ported (sigmoid)
        if training and cfg.add_uv_noise:
            raise NotImplementedError(
                "--add_uv_noise is not ported yet (ROADMAP Queue A, item "
                "5c: stage-2 training options)")

    def render(self, params, h, w, extrins, intrins, ts, training=False):
        """Render frames `ts` (int tensor/array of frame indices, or None
        for all frames; training renders take all frames) from one view.
        extrins (1, 4, 4) are RELATIVE to the reference camera; intrins
        (1, 3, 3).

        Returns (rgb (F, h, w, 3) f32, variables): {"alpha": (h, w, F)
        alpha sum} in eval; in training also "disp" ((h, w, F)
        raw-disparity composite, or None without d_smooth) and either the
        (D or S, h, w, F[, 3]) stacks "alpha_planes", "rgb_planes",
        "blend_weight" (unfused) or "fused_regs" and "fused_denorm" (S /
        mpi_d) with the stacks None (``--fused_render``).
        """
        self._check_render_supported(training)
        dev = self.device
        extrins = torch.as_tensor(extrins, dtype=torch.float32, device=dev)
        intrins = torch.as_tensor(intrins, dtype=torch.float32, device=dev)
        if extrins.shape[0] != 1:
            raise ValueError("render takes one view (B = 1)")
        G = R.homographies(self.geom, extrins, intrins).contiguous()
        coords, k_s, k_d, fu, fv = R.warp_lookup(                    # K1
            G, self.tile_map_static, self.tile_map_dyn, h, w,
            (self.geom.mpi_h, self.geom.mpi_w), self.geom.tile_span)
        valid0 = coords.valid[0]                                  # (D, h, w)
        atlas_s = params["atlas"].to(self.gather_dtype).contiguous()
        dyn = params["atlas_dyn"].to(self.gather_dtype).contiguous()
        if training:
            if ts is not None:
                raise ValueError("a training render takes all frames "
                                 "(ts=None)")
            return self._render_train(atlas_s, dyn, coords, k_s, k_d, fu, fv)
        th, tw = dyn.shape[1], dyn.shape[2]
        if ts is not None:
            ts = torch.as_tensor(np.asarray(ts), dtype=torch.int32,
                                 device=dev)
        vals_s, hit_s = R.sample_sparse(atlas_s, k_s, fu, fv)       # K2
        vals_s0, hit_s0 = vals_s[0], hit_s[0]
        vals_d, hit_d = bilinear_tiles_tilemajor(                   # K3
            dyn, k_d[0], fu[0] * (tw - 1), fv[0] * (th - 1), ts)
        out, alpha_sum = composite(                                 # K4
            vals_s0, valid0 & hit_s0, vals_d, hit_d, valid0 & hit_d)
        bg = parse_bg_color(self.cfg.bg_color, dev)
        if bg is not None:
            out = out * alpha_sum[..., None] \
                + bg * (1.0 - alpha_sum[..., None])
        return out.movedim(2, 0), {"alpha": alpha_sum}

    def _render_train(self, atlas_s, dyn, coords, k_s, k_d, fu, fv):
        """The training render after the lookup (JAX mpv.py:273-375,
        376-432): the hit-compacted sweep when ``compact_slots`` < D, then
        the fused or the unfused composite."""
        cfg = self.cfg
        sweep = (k_s[0], k_d[0], fu[0], fv[0], coords.valid[0],
                 coords.zview[0])                               # (D, h, w)
        S = self.compact_slots
        if S is not None and S < self.geom.n_planes:
            sweep = compact_sweep(*sweep, S)                  # K13: (S, h, w)
        k_s0, k_d0, fu0, fv0, valid0, zview0 = sweep
        vals_s0, hit_s0 = R.sample_sparse(atlas_s, k_s0, fu0, fv0)  # K2/K9
        vals_d, hit_d = R.sample_sparse(dyn, k_d0, fu0, fv0)       # K3/K10
        m_s, m_d = valid0 & hit_s0, valid0 & hit_d
        bg = parse_bg_color(cfg.bg_color, self.device)
        if cfg.fused_render:
            return self._render_fused(vals_s0, m_s, vals_d, hit_d, m_d,
                                      valid0, zview0, bg)
        act_rgb = get_activation(cfg.rgb_activate)
        act_a = get_activation(cfg.alpha_activate)

        def decode(feats, valid):
            rgba = decode_rgba(feats.float(), cfg.rgb_mlp_type)
            rgb = act_rgb(rgba[..., :-1]) * valid[..., None]
            alpha = torch.where(valid, act_a(rgba[..., -1]), 0.0)
            return rgb, alpha

        rgb_s, alpha_s = decode(vals_s0, m_s)                  # (S, h, w, .)
        rgb_d, alpha_d = decode(vals_d, m_d[..., None])
        # (S, h, w, F, .) stacks; the static sample broadcasts over F
        hd = hit_d[..., None, None]
        rgb_p = torch.where(hd, rgb_d, rgb_s[..., None, :])
        alpha_p = torch.where(hd[..., 0], alpha_d, alpha_s[..., None])
        out, bw = R.composite_planes(alpha_p[None], rgb_p[None])
        out, bw = out[0], bw[0]                       # (h, w, F, 3), far first
        alpha_sum = torch.sum(bw, dim=0)              # (h, w, F)
        out = R.apply_background(out, alpha_sum, bg)
        disp = None
        if cfg.d_smooth_on:
            # stage 2 composites the raw reciprocal depth (MPV.py:386)
            disp = torch.sum(self._dinv(valid0, zview0)[..., None] * bw,
                             dim=0)
        variables = {"alpha_planes": alpha_p, "rgb_planes": rgb_p,
                     "blend_weight": bw, "alpha": alpha_sum, "disp": disp}
        return out.movedim(2, 0), variables

    @staticmethod
    def _dinv(valid, zview):
        """The per-plane (or per-slot) masked reciprocal depth."""
        z = torch.where(valid, zview, 1.0)
        return torch.where(valid, 1.0 / z, 0.0)

    def _render_fused(self, vals_s, m_s, vals_d, hit_d, m_d, valid, zview,
                      bg):
        """--fused_render (JAX mpv.py:336-375): K14/K15 over the S (or D)
        slots.  dinv is computed without gradient, as the JAX model's
        stop_gradient: the VJP returns no cotangent for it."""
        cfg = self.cfg
        dinv = None
        if cfg.d_smooth_on:
            with torch.no_grad():
                dinv = self._dinv(valid, zview).contiguous()
        fcfg = FusedCfg(n_planes=self.geom.n_planes,
                        use_sparsity=cfg.sparsity_on,
                        use_rgb_smooth=cfg.rgb_smooth_on,
                        use_a_smooth=cfg.a_smooth_on,
                        want_disp=cfg.d_smooth_on)
        out, alpha_sum, disp, regsums = fused_composite(
            fcfg, vals_s, m_s, vals_d, hit_d, m_d, dinv)
        out = R.apply_background(out, alpha_sum, bg)
        variables = {"alpha_planes": None, "rgb_planes": None,
                     "blend_weight": None, "alpha": alpha_sum, "disp": disp,
                     "fused_regs": regsums,
                     "fused_denorm": vals_d.shape[0] / self.geom.n_planes}
        return out.movedim(2, 0), variables

    def training_extras(self, variables, loss_gain=1.0):
        """The regularizer terms (ref MPV.py:511-551) in the JAX model's
        key order: from the fused route's sums, or on the (L, h, w, F[, 3])
        stacks of the unfused route (L = D, or the slot count S under
        compaction)."""
        cfg = self.cfg
        extra = {}
        fused = variables.get("fused_regs")
        if fused is not None:
            # the stack regularizers came out of K14 (same formulas); the
            # same scales as below
            denorm = variables["fused_denorm"]
            terms = fused
        else:
            a = variables["alpha_planes"]                  # (L, h, w, F)
            # the stack's plane-axis length over mpi_d, as the reference
            # renormalizes its truncated fragment stack (MPV.py:518, 524)
            denorm = a.shape[0] / self.geom.n_planes
            terms = {}
            if cfg.sparsity_on:
                terms["sparsity"] = regs.sparsity_loss(
                    a, self.geom.n_planes, eps=1e-4, plane_axis=0)
            if cfg.rgb_smooth_on:
                terms["rgb_smooth"] = regs.content_smooth_loss(
                    variables["rgb_planes"], h_axis=1, w_axis=2)
            if cfg.a_smooth_on:
                terms["a_smooth"] = regs.content_smooth_loss(
                    a[..., None], h_axis=1, w_axis=2)
        if "sparsity" in terms:
            extra["sparsity"] = terms["sparsity"] * loss_gain
        for k in ("rgb_smooth", "a_smooth"):
            if k in terms:
                extra[k] = terms[k] * (loss_gain * denorm)
        if cfg.density_on:
            extra["density"] = regs.density_loss(variables["alpha"])
        if cfg.d_smooth_on and variables["disp"] is not None:
            # (h, w, F) -> frame-major (F, h, w)
            extra["d_smooth"] = regs.depth_smooth_loss(
                variables["disp"].movedim(2, 0))
        return extra
