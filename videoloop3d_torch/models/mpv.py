"""MPMeshVid — the stage-2 model: Multi-plane Tile Video (counterpart of
``videoloop3d_tpu/models/mpv.py``).

Sparse phase: ``atlas (Ns, th, tw, C)`` static tiles plus a tile-major
``atlas_dyn (Nd, th, tw, F, C)`` dynamic stack (one texel holds all F
frames contiguously), addressed through per-plane int32 tile maps.  C is
the decoder's channel count (4 direct, 13 rgb_sh, 36 rgba_sh,
``--atlas_cnl`` nex_rgb / mlp_alpha, which also carry the nested
``params["decoder"]`` weights).

Renders of a sparse model:

* eval (``training=False``, frames ``ts``): K1 (warp + tile lookup), K2
  (static samples), K3 (dynamic samples) and, for the shipped direct
  decoder with sigmoid rgb and alpha, K4 (decode + select + composite),
  over all D planes (the eval path is never compacted); any other
  decoder or activation decodes with the per-pixel view directions and
  takes the unfused composite, as the JAX package's eval render does;
* training (all frames): K1, then
  - with ``compact_slots`` = S < D (``--compact_hits``, set per pyramid
    level by the trainer): K13 compacts the sweep to S slots per pixel
    (``render/compact.py``) and the samplers run at (S, h, w);
    otherwise at (D, h, w);
  - K2/K9 for the static tiles, K3/K10 for the dynamic tiles
    (``renderer.sample_sparse``, ``render/sample.py:sample_tiles``;
    gradients accumulated in f32 and rounded once to the gather dtype;
    the backward scatters straight from the slots).  Under ``--fp16``
    both atlases are read in f32, each texel rounded to bf16 in K2 and
    K3 and each gradient sum in K9's rounding pass and in K10 (no copy,
    no cast of either gradient);
  - with ``--fused_render`` and the direct / sigmoid / sigmoid decoder
    (`MPMeshConfig.fused_decoder`, JAX mpv.py:340-343): K14/K15
    (``render/fused.py:fused_composite``), decode, select, composite, the
    stack regularizers and the disparity in one autograd Function; otherwise
    decode, select and the reverse-cumprod composite as plain autograd
    and the regularizers on the (S or D, h, w, F) stacks
    (`training_extras`, renormalized by S/mpi_d as in the JAX package).

Dense phase (a scratch start, `init_params`, or a dense stage-1
checkpoint): the whole scene is one frame-stacked ``atlas_dyn (D, Ht, Wt,
F, C)`` with an empty ``atlas (0, 1, 1, C)`` and no tile maps.  Its
renders, training and eval alike, take plain `R.warp_coordinates`, then
K16/K17 (``render/sample.py:sample_planes_tilemajor`` on the f32 stack at
the gather dtype, with no bf16 copy of it under ``--fp16``; frames ``ts``
read inside K16 in eval), decode under the warp's valid and the unfused
reverse-cumprod composite.  As in the JAX package the dense phase takes
neither ``--compact_hits`` nor ``--fused_render``.

A training render takes its random inputs (``--add_uv_noise``,
``--bg_color random``) from `draws` or from a torch.Generator
(``models/mpmesh.py:training_draws``): the uv noise enters K1 on the
sparse phase and the coordinates of K16 on the dense one; decode, the
compaction and the disparity keep the un-jittered samples' valid.

`lod` resizes the tiles (sparse) or the dense stack for the
coarse-to-fine pyramid (``core/resize.py``).

Where the port differs from the JAX model on purpose: a stage-2 model of
the NeX / MLP decoders carries decoder weights (`init_params` draws them
as stage 1 does; `init_from_stage1` takes the checkpoint's), where the
JAX model has none and fails at its first decode; `restore_checkpoint`
takes the decoder type and activations an mpv checkpoint was saved with,
where the JAX model keeps the arguments' (so its render of an rgb_sh
MTV needs ``--rgb_mlp_type rgb_sh`` on the command line).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videoloop3d_torch.core import cameras
from videoloop3d_torch.core.activations import get_activation
from videoloop3d_torch.core.resize import resize_tiles
from videoloop3d_torch.losses import regularizers as regs
from videoloop3d_torch.models.checkpoint import params_from_numpy
from videoloop3d_torch.models.geometry import MPIGeometry
from videoloop3d_torch.models.mpmesh import (MPMeshConfig, _atlas_channels,
                                             background, decode_rgba,
                                             init_decoder_params,
                                             training_draws)
from videoloop3d_torch.render import renderer as R
from videoloop3d_torch.render.compact import compact_sweep
from videoloop3d_torch.render.fused import (FusedCfg, composite,
                                            fused_composite)
from videoloop3d_torch.render.sample import (bilinear_tiles_tilemajor,
                                             sample_planes_tilemajor)


def _detached(params):
    """The params dict (nested decoder included) with every tensor
    detached."""
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in params.items()}


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
        self.init_std = float(args.init_std)
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

    def init_params(self, seed=0):
        """Scratch start (dense; ref MPV.py:83-110, JAX mpv.py:84-96):
        ``atlas_dyn`` (D, Ht, Wt, F, C) from numpy ``default_rng(seed)``
        standard normals in float64 times ``init_std``, cast to f32, the
        alpha channel -2 for the direct decoder; an empty static atlas;
        ``verts`` the base geometry's vertex grid; the NeX / MLP decoder
        weights drawn as stage 1 draws them (`init_decoder_params`, from
        seed; the JAX model has none).  The arrays equal the JAX
        package's bit for bit.  The draw is made one plane at a time
        (consecutive draws continue one stream), so the host holds one
        plane of float64, not the whole stack (14.3 GB at mpv_base's
        width); each plane is uploaded as it is made.  Returns params
        (device tensors)."""
        g = self.base_geom
        cfg = self.cfg
        rng = np.random.default_rng(seed)
        C = _atlas_channels(cfg.rgb_mlp_type, cfg.atlas_cnl)
        plane = (g.mpi_h, g.mpi_w, self.frm_num, C)
        dyn = torch.empty((g.n_planes,) + plane, dtype=self.dtype,
                          device=self.device)
        for d in range(g.n_planes):
            p = (rng.standard_normal(plane) * self.init_std).astype(
                np.float32)
            if cfg.rgb_mlp_type == "direct":
                p[..., -1] = -2.0
            dyn[d] = torch.from_numpy(p)
        params = {"atlas": torch.zeros((0, 1, 1, C), dtype=self.dtype,
                                       device=self.device),
                  "atlas_dyn": dyn,
                  "verts": torch.from_numpy(g.vertex_grid()).to(self.device)}
        decoder = init_decoder_params(cfg.rgb_mlp_type, C, seed)
        if decoder is not None:
            params["decoder"] = params_from_numpy(decoder, self.device)
        return params

    def init_from_stage1(self, ckpt):
        """Consume a stage-1 checkpoint.  Sparse: static tiles stay static,
        dynamic tiles broadcast over frames.  Dense: the whole atlas
        becomes the dynamic stack, the static atlas is empty.  The
        broadcast over the F frames is made on the device (a dense
        checkpoint at the shipped stage-1 width becomes 15.1 GB there; no
        host copy of that size is made).  The checkpoint's decoder type
        wins over the arguments (a direct2sh-converted checkpoint carries
        SH channels), and its NeX / MLP weights are carried across (drawn
        from seed 0 when it has none).  Returns params (device
        tensors)."""
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
            self._maps_to_device(None, None)
            self.tile_hw = self.base_tile_hw = None
            src = p["atlas"]
            atlas = np.zeros((0, 1, 1, src.shape[-1]), np.float32)
        params = {"atlas": atlas, "atlas_dyn": src}
        if "verts" in p:
            params["verts"] = p["verts"]
        decoder = p.get("decoder") or init_decoder_params(
            self.cfg.rgb_mlp_type, src.shape[-1])
        if decoder is not None:
            params["decoder"] = decoder
        params = params_from_numpy(params, self.device, self.dtype)
        src = params["atlas_dyn"]
        params["atlas_dyn"] = src[..., None, :].expand(
            src.shape[:-1] + (self.frm_num, src.shape[-1])).contiguous()
        return params

    def restore_checkpoint(self, ckpt):
        """Restore a stage-2 (mpv) checkpoint; returns params (device
        tensors).  Used by the trainer's auto-resume and the render and
        eval tools.  The decoder type and activations the checkpoint was
        saved with replace the arguments' (the JAX model keeps the
        arguments')."""
        meta = ckpt["meta"]
        self.geom = ckpt["geom"]
        extra = meta.get("extra", {})
        reps = {k: extra[k] for k in ("rgb_mlp_type", "rgb_activate",
                                      "alpha_activate") if k in extra}
        if any(getattr(self.cfg, k) != v for k, v in reps.items()):
            print(f"[mpv] adopting {reps} from the checkpoint")
            self.cfg = dataclasses.replace(self.cfg, **reps)
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
        """Level-of-detail resize (ref MPV.py:140-198, JAX mpv.py:160-195)
        from the current params, down or up: sparse, of the tiles to the
        base tile size times `factor` (at least 2 texels); dense, of the
        (D, Ht, Wt, F, C) stack to the base plane size times `factor`, and
        ``geom`` becomes the base geometry scaled to it.  Returns new
        params, or `params` when the size does not change."""
        if not self.is_sparse:
            nh = int(self.base_geom.mpi_h * factor)
            nw = int(self.base_geom.mpi_w * factor)
            if (nh, nw) == (self.geom.mpi_h, self.geom.mpi_w):
                return params
            out = dict(params)
            with torch.no_grad():
                out["atlas_dyn"] = resize_tiles(params["atlas_dyn"].detach(),
                                                (nh, nw))
            self.geom = self.base_geom.scaled(nh, nw)
            return out
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

    def render(self, params, h, w, extrins, intrins, ts, training=False,
               gen=None, draws=None):
        """Render frames `ts` (int tensor/array of frame indices, or None
        for all frames; training renders take all frames) from one view.
        extrins (1, 4, 4) are RELATIVE to the reference camera; intrins
        (1, 3, 3).  A training render takes its random inputs from `draws`
        ({"uv": (nx, ny) (1, D, h, w), "bg": (3,)}) or, without them, from
        the torch.Generator gen (``models/mpmesh.py:training_draws``).

        Returns (rgb (F, h, w, 3) f32, variables): {"alpha": (h, w, F)
        alpha sum} in eval; in training also "disp" ((h, w, F)
        raw-disparity composite, or None without d_smooth) and either the
        (D or S, h, w, F[, 3]) stacks "alpha_planes", "rgb_planes",
        "blend_weight" (unfused, and always on the dense phase) or
        "fused_regs" and "fused_denorm" (S / mpi_d) with the stacks None
        (``--fused_render`` on the sparse phase).
        """
        dev = self.device
        extrins = torch.as_tensor(extrins, dtype=torch.float32, device=dev)
        intrins = torch.as_tensor(intrins, dtype=torch.float32, device=dev)
        if extrins.shape[0] != 1:
            raise ValueError("render takes one view (B = 1)")
        if training and ts is not None:
            raise ValueError("a training render takes all frames (ts=None)")
        if ts is not None:
            ts = torch.as_tensor(np.asarray(ts), dtype=torch.int32,
                                 device=dev)
        if not training:
            # the eval kernels are forward-only: trained params (leaves
            # that require grad) are read as constants
            params = _detached(params)
        if training and draws is None:
            draws = training_draws(self.cfg, gen,
                                   (1, self.geom.n_planes, h, w))
        draws = draws if training else None
        uv = draws.get("uv", ()) if draws else ()
        bg = background(self.cfg, draws, dev)
        # what a view-dependent decoder decodes with: the per-pixel unit
        # view directions (h, w, 3) and the NeX / MLP weights
        view = (None if self.cfg.rgb_mlp_type == "direct" else
                cameras.unit_view_dirs(h, w, extrins, intrins)[0],
                params.get("decoder"))
        if not self.is_sparse:
            return self._render_dense(params, h, w, extrins, intrins, ts,
                                      training, uv, bg, view)
        G = R.homographies(self.geom, extrins, intrins).contiguous()
        coords, k_s, k_d, fu, fv = R.warp_lookup(                    # K1
            G, self.tile_map_static, self.tile_map_dyn, h, w,
            (self.geom.mpi_h, self.geom.mpi_w), self.geom.tile_span, *uv)
        valid0 = coords.valid[0]                                  # (D, h, w)
        # both atlases are read in f32, each texel rounded to the gather
        # dtype inside K2 and K3 (and each gradient sum in K9's rounding
        # pass and inside K10), where JAX casts them
        atlas_s = params["atlas"].contiguous()
        dyn = params["atlas_dyn"].contiguous()
        if training:
            return self._render_train(atlas_s, dyn, coords, k_s, k_d, fu, fv,
                                      bg, view)
        th, tw = dyn.shape[1], dyn.shape[2]
        vals_s, hit_s = R.sample_sparse(atlas_s, k_s, fu, fv,      # K2
                                        self.gather_dtype)
        vals_s0, hit_s0 = vals_s[0], hit_s[0]
        vals_d, hit_d = bilinear_tiles_tilemajor(                   # K3
            dyn, k_d[0], fu[0] * (tw - 1), fv[0] * (th - 1), ts,
            self.gather_dtype)
        if not self.cfg.fused_decoder():
            return self._select_composite(vals_s0, valid0 & hit_s0, vals_d,
                                          hit_d, valid0 & hit_d, valid0,
                                          coords.zview[0], bg, False, view)
        out, alpha_sum = composite(                                 # K4
            vals_s0, valid0 & hit_s0, vals_d, hit_d, valid0 & hit_d)
        out = R.apply_background(out, alpha_sum, bg)
        return out.movedim(2, 0), {"alpha": alpha_sum}

    def _render_dense(self, params, h, w, extrins, intrins, ts, training, uv,
                      bg, view):
        """The dense phase's render (JAX mpv.py:382-393), training and
        eval alike: the plain warp, the uv-noise draws uv added to the
        sample positions, K16/K17 on the f32 frame-stacked planes at the
        gather dtype (under --fp16 each texel and each gradient sum rounded
        to bf16 inside the kernels, where JAX casts the stack; frames ts
        read inside K16), decode under the un-jittered valid, the unfused
        composite."""
        coords = R.warp_coordinates(self.geom, extrins, intrins, h, w)
        sample = R.add_texel_noise(coords, *uv) if uv else coords
        dyn = params["atlas_dyn"].contiguous()
        vals = sample_planes_tilemajor(                            # K16/K17
            dyn, sample.x[0].contiguous(), sample.y[0].contiguous(), ts,
            self.gather_dtype)                            # (D, h, w, F, C)
        valid0 = coords.valid[0]
        rgb_p, alpha_p = self._decode(vals, valid0[..., None], view)
        return self._composite(rgb_p, alpha_p, valid0, coords.zview[0], bg,
                               training)

    def _decode(self, feats, valid, view):
        """Texel features (L, h, w[, F], C) -> activated rgb and alpha,
        zero where valid (broadcastable to feats[..., 0]) is False.  view:
        (the render's per-pixel unit view directions (h, w, 3) or None for
        the direct decoder, the NeX / MLP weights or None)."""
        cfg = self.cfg
        dirs, decoder = view
        vd = None
        if dirs is not None:
            vd = dirs[None] if feats.dim() == 4 else dirs[None, :, :, None]
        rgba = decode_rgba(feats.float(), cfg.rgb_mlp_type, vd, decoder)
        rgb = get_activation(cfg.rgb_activate)(rgba[..., :-1]) \
            * valid[..., None]
        alpha = torch.where(valid,
                            get_activation(cfg.alpha_activate)(rgba[..., -1]),
                            0.0)
        return rgb, alpha

    def _composite(self, rgb_p, alpha_p, valid0, zview0, bg, training):
        """The unfused chain on the (L, h, w, F[, 3]) stacks, planes stored
        far first (JAX mpv.py:395-432): the reverse-cumprod composite, the
        background, and in training the raw-disparity composite."""
        out, bw = R.composite_planes(alpha_p[None], rgb_p[None])
        out, bw = out[0], bw[0]                       # (h, w, F, 3), far first
        alpha_sum = torch.sum(bw, dim=0)              # (h, w, F)
        out = R.apply_background(out, alpha_sum, bg)
        if not training:
            return out.movedim(2, 0), {"alpha": alpha_sum}
        disp = None
        if self.cfg.d_smooth_on:
            # stage 2 composites the raw reciprocal depth (MPV.py:386)
            disp = torch.sum(self._dinv(valid0, zview0)[..., None] * bw,
                             dim=0)
        variables = {"alpha_planes": alpha_p, "rgb_planes": rgb_p,
                     "blend_weight": bw, "alpha": alpha_sum, "disp": disp}
        return out.movedim(2, 0), variables

    def _render_train(self, atlas_s, dyn, coords, k_s, k_d, fu, fv, bg,
                      view):
        """The sparse training render after the lookup (JAX
        mpv.py:273-375, 376-432): the hit-compacted sweep when
        ``compact_slots`` < D, then the fused or the unfused composite."""
        cfg = self.cfg
        sweep = (k_s[0], k_d[0], fu[0], fv[0], coords.valid[0],
                 coords.zview[0])                               # (D, h, w)
        S = self.compact_slots
        if S is not None and S < self.geom.n_planes:
            sweep = compact_sweep(*sweep, S)                  # K13: (S, h, w)
        k_s0, k_d0, fu0, fv0, valid0, zview0 = sweep
        vals_s0, hit_s0 = R.sample_sparse(atlas_s, k_s0, fu0, fv0,  # K2/K9
                                          self.gather_dtype)
        vals_d, hit_d = R.sample_sparse(dyn, k_d0, fu0, fv0,       # K3/K10
                                        self.gather_dtype)
        m_s, m_d = valid0 & hit_s0, valid0 & hit_d
        if cfg.fused_render and cfg.fused_decoder():
            return self._render_fused(vals_s0, m_s, vals_d, hit_d, m_d,
                                      valid0, zview0, bg)
        return self._select_composite(vals_s0, m_s, vals_d, hit_d, m_d,
                                      valid0, zview0, bg, True, view)

    def _select_composite(self, vals_s0, m_s, vals_d, hit_d, m_d, valid0,
                          zview0, bg, training, view):
        """The unfused chain of the sparse phase (JAX mpv.py:376-432):
        decode the static and dynamic samples, take a plane's dynamic
        texel where its dynamic map hits, composite."""
        rgb_s, alpha_s = self._decode(vals_s0, m_s, view)      # (S, h, w, .)
        rgb_d, alpha_d = self._decode(vals_d, m_d[..., None], view)
        # (S, h, w, F, .) stacks; the static sample broadcasts over F
        hd = hit_d[..., None, None]
        rgb_p = torch.where(hd, rgb_d, rgb_s[..., None, :])
        alpha_p = torch.where(hd[..., 0], alpha_d, alpha_s[..., None])
        return self._composite(rgb_p, alpha_p, valid0, zview0, bg, training)

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
