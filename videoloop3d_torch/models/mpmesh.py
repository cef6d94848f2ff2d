"""MPMesh, the stage-1 model (static MPI + learned 3D loop mask), and the
decoder table and static config shared with the MPV model (counterpart
of ``videoloop3d_tpu/models/mpmesh.py``).

Two phases, rendered by the homography plane sweep:

* dense: per-plane textures ``atlas (D, Ht, Wt, C)`` and loop-mask
  textures ``atlas_mask (D, Ht, Wt, 1)``.  Samples come from kernels
  K5/K6 (``render/sample.py:sample_dense``; exact for any warp, so
  ``--fast_stage1_grad``, which picks the JAX package's block-adjoint
  sampler, and ``--s1_gemm_bf16``, which rounds that sampler's MXU
  contraction inputs, change nothing here: there is no contraction).
  The composite is either the unfused autograd chain of the JAX model
  or, with ``--fused_render`` in training, kernels K7/K8
  (``render/fused_s1.py``).
* sparse (after tile culling, ``models/sparsify.py``): packed static
  tiles ``atlas (Ns, th, tw, C)`` and dynamic tiles ``atlas_dyn (Nd, th,
  tw, C)`` addressed by per-plane int32 tile maps.  K1 warps and looks
  up both maps, K2 samples the tiles and K9 gives their gradient (exact
  for any warp and batch, so ``--fast_stage1_grad`` changes nothing here
  either); the composite is the unfused chain (``--fused_render`` only
  covers the dense phase, as in the JAX package).  The loop mask is gone.

With ``optimize_geometry`` set (the trainer's ``--optimize_geo_start``)
both phases warp through the vertex grids instead of the homography
(``render/geo_warp.py``, K20/K21), and the samplers' coordinate
gradients (K22 dense, K23 sparse) carry the loss to ``verts``; the fused
route's disparity stays detached, as in the JAX package.

A training render jitters the sample positions under ``--add_uv_noise``
(the draws enter K5 through the coordinates, and K1 on the sparse phase)
and draws its background under ``--bg_color random`` (`training_draws`).

Decoders (``--rgb_mlp_type``, `decode_rgba`): ``direct`` (4 channels),
``rgb_sh`` (3 x 4 SH coefficients + alpha, 13), ``rgba_sh`` (4 x 9, 36),
``nex_rgb`` and ``mlp_alpha`` (``--atlas_cnl`` channels, alpha in channel
0, with the learnable MLP weights ``params["decoder"]``).  The view
dependent ones decode with the per-pixel unit view directions
(``core/cameras.py:unit_view_dirs``); K5/K6 and K1/K2/K9 sample any
channel count.  The fused route (K7/K8) covers only the direct decoder
with sigmoid rgb and alpha (`MPMeshConfig.fused_decoder`), as in the JAX
package; every other decoder or activation takes the unfused chain.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from videoloop3d_torch.core import cameras
from videoloop3d_torch.core.activations import (ALPHA_INIT_VAL, clip,
                                                get_activation)
from videoloop3d_torch.core.sh import eval_sh_bases
from videoloop3d_torch.losses import regularizers as regs
from videoloop3d_torch.models.checkpoint import params_from_numpy
from videoloop3d_torch.models.geometry import MPIGeometry
from videoloop3d_torch.render import geo_warp as GW
from videoloop3d_torch.render import renderer as R
from videoloop3d_torch.render.fused_s1 import FusedS1Cfg, fused_composite_s1

def _atlas_channels(rgb_mlp_type, atlas_cnl=4):
    if rgb_mlp_type == "direct":
        return 4
    if rgb_mlp_type == "rgb_sh":
        return 3 * 4 + 1          # 4 SH coefficients per colour + alpha
    if rgb_mlp_type == "rgba_sh":
        return 4 * 9
    if rgb_mlp_type in ("nex_rgb", "mlp_alpha"):
        return max(int(atlas_cnl), 4)
    raise ValueError(f"unknown rgb_mlp_type {rgb_mlp_type}")


def init_decoder_params(rgb_mlp_type, atlas_cnl, seed=0):
    """The learnable decoder weights of the NeX / MLP family (ref
    utils_mpi.py:8-47) as numpy, with the JAX package's draws: He-normal
    weights from ``default_rng(seed)``, zero biases.  None for the
    parameter-free decoders."""
    rng = np.random.default_rng(seed)

    def dense(n_in, n_out):
        return {"w": rng.normal(0, np.sqrt(2.0 / n_in),
                                (n_in, n_out)).astype(np.float32),
                "b": np.zeros((n_out,), np.float32)}

    if rgb_mlp_type == "nex_rgb":
        # view dir -> per-feature RGB basis (alpha is texel channel 0)
        return {"l0": dense(3, 64), "l1": dense(64, 3 * (atlas_cnl - 1))}
    if rgb_mlp_type == "mlp_alpha":
        # (texel features [1:], view dir) -> rgb (alpha is channel 0)
        return {"l0": dense(atlas_cnl - 1 + 3, 48), "l1": dense(48, 3)}
    return None


def _mlp(decoder, x):
    h = torch.relu(x @ decoder["l0"]["w"] + decoder["l0"]["b"])
    return h @ decoder["l1"]["w"] + decoder["l1"]["b"]


def decode_rgba(feats, rgb_mlp_type, view_dirs=None, decoder=None):
    """Texel features (..., C) -> raw RGBA (..., 4), alpha last
    (pre-activation).  view_dirs: unit view directions broadcastable to
    (..., 3) (the view-dependent decoders); decoder: the NeX / MLP
    weights.  Parity: JAX ``models/mpmesh.py:decode_rgba`` (MPI.py
    feat2rgba, utils_mpi.py:8-75).  ``nex_rgb`` evaluates its basis MLP
    on the un-broadcast directions (the same rows JAX evaluates once per
    plane)."""
    if rgb_mlp_type == "direct":
        return feats[..., :4]
    if rgb_mlp_type == "rgb_sh":
        dim = (feats.shape[-1] - 1) // 3
        base = eval_sh_bases(dim, view_dirs)
        coef = feats[..., :-1].reshape(feats.shape[:-1] + (3, dim))
        rgb = torch.sum(base[..., None, :] * coef, dim=-1)
        return torch.cat([rgb, feats[..., -1:]], dim=-1)
    if rgb_mlp_type == "rgba_sh":
        base = eval_sh_bases(9, view_dirs)
        coef = feats.reshape(feats.shape[:-1] + (4, 9))
        return torch.sum(base[..., None, :] * coef, dim=-1)
    if rgb_mlp_type == "nex_rgb":
        C = feats.shape[-1]
        basis = _mlp(decoder, view_dirs)
        basis = basis.reshape(basis.shape[:-1] + (C - 1, 3))
        rgb = torch.sum(feats[..., 1:, None] * basis, dim=-2)
        return torch.cat([rgb, feats[..., :1]], dim=-1)
    if rgb_mlp_type == "mlp_alpha":
        vd = view_dirs.expand(feats.shape[:-1] + (3,))
        rgb = _mlp(decoder, torch.cat([feats[..., 1:], vd], dim=-1))
        return torch.cat([rgb, feats[..., :1]], dim=-1)
    raise ValueError(f"unknown rgb_mlp_type {rgb_mlp_type}")


def convert_direct_to_sh(model, params):
    """The ``--direct2sh_epoch`` event (ref MPI.py:273-286, JAX
    ``models/mpmesh.py:convert_direct_to_sh``): widen a direct (..., 4)
    atlas to rgb_sh's 13 channels, each colour's DC coefficient seeded
    from the direct colour, the others zero, alpha kept last; the dense
    atlas and, in the sparse phase, the packed ``atlas_dyn`` alike.  Sets
    ``model.cfg`` to rgb_sh and returns new params (detached tensors on
    the atlas's device; the caller rebuilds the optimizer)."""
    if model.cfg.rgb_mlp_type != "direct":
        raise ValueError("direct2sh needs a direct atlas, got "
                         f"{model.cfg.rgb_mlp_type}")

    def widen(t):
        t = t.detach().float()
        out = torch.zeros(t.shape[:-1] + (13,), dtype=torch.float32,
                          device=t.device)
        out[..., -1] = t[..., -1]
        out[..., 0:-1:4] = t[..., :3]      # the DC coefficient per colour
        return out

    new = {k: (v.detach() if isinstance(v, torch.Tensor) else v)
           for k, v in params.items()}
    new["atlas"] = widen(params["atlas"])
    if "atlas_dyn" in params and len(params["atlas_dyn"]):
        new["atlas_dyn"] = widen(params["atlas_dyn"])
    model.cfg = dataclasses.replace(model.cfg, rgb_mlp_type="rgb_sh")
    return new


@dataclasses.dataclass(frozen=True)
class MPMeshConfig:
    rgb_mlp_type: str = "direct"
    atlas_cnl: int = 4
    rgb_activate: str = "sigmoid"
    alpha_activate: str = "sigmoid"
    learn_loop_mask: bool = False
    add_uv_noise: bool = False
    fast_stage1_grad: bool = False
    fast_stage2_grad: bool = False
    fused_render: bool = False
    s1_gemm_prec: str = "highest"      # --s1_gemm_bf16 -> "default"
    s1_fwd_block: tuple = (16, 32)     # --s1_fwd_block
    bg_color: str = ""
    normalize_verts: bool = False
    edge_scale: float = 4.0
    normalize_blendweight_fordepth: bool = False
    sparsity_eps: float = 1e-6
    # regularizer switches: a loss is computed iff its weight is > 0
    sparsity_on: bool = True
    rgb_smooth_on: bool = True
    a_smooth_on: bool = True
    d_smooth_on: bool = True
    l_smooth_on: bool = True
    density_on: bool = True

    def fused_decoder(self):
        """Whether the fused composites (K7/K8, K14/K15, K4) compute this
        decoder: only the direct one with sigmoid rgb and alpha, which
        they decode inside (JAX ``models/mpmesh.py:445-449``,
        ``models/mpv.py:340-343``)."""
        return (self.rgb_mlp_type == "direct"
                and self.rgb_activate == "sigmoid"
                and self.alpha_activate == "sigmoid")

    @staticmethod
    def from_args(args):
        return MPMeshConfig(
            rgb_mlp_type=args.rgb_mlp_type,
            atlas_cnl=int(args.atlas_cnl),
            rgb_activate=args.rgb_activate,
            alpha_activate=args.alpha_activate,
            learn_loop_mask=bool(args.learn_loop_mask),
            add_uv_noise=bool(args.add_uv_noise),
            fast_stage1_grad=bool(args.fast_stage1_grad),
            fast_stage2_grad=bool(args.fast_stage2_grad),
            fused_render=bool(args.fused_render),
            s1_gemm_prec="default" if args.s1_gemm_bf16 else "highest",
            s1_fwd_block=tuple(int(v) for v in args.s1_fwd_block.split("x")),
            bg_color=args.bg_color,
            normalize_verts=bool(args.normalize_verts),
            edge_scale=float(args.edge_scale),
            normalize_blendweight_fordepth=bool(
                args.normalize_blendweight_fordepth),
            sparsity_on=args.sparsity_loss_weight > 0,
            rgb_smooth_on=args.rgb_smooth_loss_weight > 0,
            a_smooth_on=args.a_smooth_loss_weight > 0,
            d_smooth_on=args.d_smooth_loss_weight > 0,
            l_smooth_on=args.l_smooth_loss_weight > 0,
            density_on=args.density_loss_weight > 0,
        )


def parse_bg_color(bg_color: str, generator=None, device=None):
    """'' -> None; 'r#g#b' -> fixed color tensor on `device`; 'random' ->
    three uniforms in [0, 1) from the torch.Generator `generator`, on its
    device (JAX ``models/mpmesh.py:171-177`` draws them from its key; a
    training option: there is no random background without draws)."""
    if not bg_color:
        return None
    if bg_color == "random":
        if generator is None:
            raise ValueError("--bg_color random needs a generator (the "
                             "background is drawn per training render)")
        return torch.rand(3, generator=generator, device=generator.device)
    r, g, b = map(float, bg_color.split("#"))
    return torch.tensor([r, g, b], dtype=torch.float32, device=device)


def training_draws(cfg, gen, noise_shape):
    """The random inputs of one training render, drawn from the
    torch.Generator gen in this order: the uv-noise (nx, ny) of the
    (B, D, h, w) sweep under ``--add_uv_noise`` (key "uv",
    `renderer.texel_noise`), and the background colour under
    ``--bg_color random`` (key "bg").  A render takes them from here, or
    from its caller (tests feed the JAX package's draws).  Without gen
    there are none: JAX adds no noise without an rng either."""
    draws = {}
    if gen is None:
        return draws
    if cfg.add_uv_noise:
        draws["uv"] = R.texel_noise(gen, noise_shape)
    if cfg.bg_color == "random":
        draws["bg"] = parse_bg_color(cfg.bg_color, gen)
    return draws


def background(cfg, draws, device):
    """The render's background colour: None, the fixed colour, or the
    drawn one (``--bg_color random``, training renders only)."""
    if cfg.bg_color == "random":
        if not draws or "bg" not in draws:
            raise ValueError("--bg_color random needs the training draws "
                             "(a generator or draws['bg'])")
        return draws["bg"]
    return parse_bg_color(cfg.bg_color, device=device)


class MPMesh:
    """Stage-1 model: static geometry and config, the phase and its tile
    maps, parameter initialisation, and the render / forward.  Parameters
    are a dict of tensors on ``device``."""

    def __init__(self, args, H, W, ref_extrin, ref_intrin, near, far, *,
                 device):
        self.geom = MPIGeometry.create(args, H, W, ref_extrin, ref_intrin,
                                       near, far)
        self.cfg = MPMeshConfig.from_args(args)
        self.H, self.W = H, W
        self.device = torch.device(device)
        self.is_sparse = False
        self.has_dyn = False
        # (D, n_tiles_h, n_tiles_w) int32 tensors on self.device
        self.tile_map_static = None
        self.tile_map_dyn = None
        self.tile_hw = None
        # set by the trainer from epoch --optimize_geo_start on: the render
        # warps through the vertex grids (render/geo_warp.py) in both
        # phases; a model built or loaded from a checkpoint renders flat
        self.optimize_geometry = False

    def set_sparse(self, tile_map_static, tile_map_dyn, tile_hw):
        """Enter the sparse phase with the given numpy int32 tile maps
        (-1 = culled) and packed tile size (th, tw)."""
        maps = params_from_numpy({"s": tile_map_static, "d": tile_map_dyn},
                                 self.device)
        self.is_sparse = True
        self.has_dyn = True
        self.tile_map_static, self.tile_map_dyn = maps["s"], maps["d"]
        self.tile_hw = tuple(int(v) for v in tile_hw)

    def init_params(self, seed=0):
        """Random init mirroring ref MPI.py:100-117, with the JAX
        package's numpy draws (identical arrays)."""
        cfg, g = self.cfg, self.geom
        rng = np.random.default_rng(seed)
        C = _atlas_channels(cfg.rgb_mlp_type, cfg.atlas_cnl)
        atlas = rng.random((g.n_planes, g.mpi_h, g.mpi_w, C),
                           dtype=np.float32)
        atlas[..., -1] = ALPHA_INIT_VAL
        verts = g.vertex_grid()
        if cfg.normalize_verts:                # ref MPI.py:68-70
            verts = (verts.reshape(g.n_planes, -1)
                     / g.depths_np()[:, None]).reshape(verts.shape)
        params = {"atlas": atlas, "verts": verts}
        if cfg.learn_loop_mask:
            params["atlas_mask"] = np.full(
                (g.n_planes, g.mpi_h, g.mpi_w, 1), ALPHA_INIT_VAL,
                np.float32)
        decoder = init_decoder_params(cfg.rgb_mlp_type, C, seed)
        if decoder is not None:
            params["decoder"] = decoder
        return params_from_numpy(params, self.device)

    def _decode(self, feats, coords, view_dirs=None, decoder=None):
        """Texel features (B, D, h, w, C) -> activated rgb (B, D, h, w, 3)
        and alpha (B, D, h, w), zero where the sample is invalid.
        view_dirs (B, 1, h, w, 3) for the view-dependent decoders."""
        cfg = self.cfg
        rgba = decode_rgba(feats, cfg.rgb_mlp_type, view_dirs, decoder)
        rgb = get_activation(cfg.rgb_activate)(rgba[..., :-1])
        alpha = get_activation(cfg.alpha_activate)(rgba[..., -1])
        alpha = torch.where(coords.valid, alpha, 0.0)
        rgb = rgb * coords.valid[..., None]
        return rgb, alpha

    def _render_fused_dense(self, coords, feats, mask_feats, need_mask, bg):
        """Dense training render through K7/K8 (render/fused_s1.py).
        Returns (rgbl, variables) shaped like the unfused path; variables
        carries 'fused_regs' instead of the per-plane stacks."""
        cfg, g = self.cfg, self.geom
        want_disp = cfg.d_smooth_on
        dinv = None
        if want_disp:
            # K7/K8 give dinv no cotangent (JAX: stop_gradient)
            one = torch.ones((), device=self.device)
            z = torch.where(coords.valid, coords.zview.detach(), one)
            dinv = (1.0 / z - 1.0 / g.far) / (1.0 / g.near - 1.0 / g.far)
            dinv = torch.where(coords.valid, dinv, 0.0).contiguous()
        fcfg = FusedS1Cfg(n_planes=g.n_planes,
                          use_sparsity=cfg.sparsity_on,
                          use_rgb_smooth=cfg.rgb_smooth_on,
                          use_a_smooth=cfg.a_smooth_on,
                          use_l_smooth=cfg.l_smooth_on and need_mask,
                          use_loop=need_mask,
                          want_disp=want_disp,
                          sp_eps=cfg.sparsity_eps)
        mf = mask_feats[..., 0] if need_mask else None
        out_rgb, alpha_sum, disp, label, regsums = fused_composite_s1(
            fcfg, feats, coords.valid.contiguous(), mf, dinv)
        out_rgb = R.apply_background(out_rgb, alpha_sum, bg)
        if want_disp and cfg.normalize_blendweight_fordepth:
            disp = disp / clip(alpha_sum, 1e-10)
        variables = {"alpha_planes": None, "rgb_planes": None,
                     "blend_weight": None, "loop_planes": None,
                     "disp_norm": disp, "alpha": alpha_sum,
                     "fused_regs": regsums}
        rgbl = torch.cat([out_rgb, label], dim=-1) if need_mask else out_rgb
        return rgbl, variables

    def _warp(self, params, h, w, extrins, intrins):
        """The vertex warp of the geometry phase (K20/K21 under the plain
        projection; render/geo_warp.py), differentiable in verts."""
        return GW.warp_coordinates_verts(
            self.geom, params["verts"], extrins, intrins, h, w,
            normalize=self.cfg.normalize_verts)

    def _view_dirs(self, h, w, extrins, intrins):
        """(B, 1, h, w, 3) unit view directions for a view-dependent
        decoder (broadcast over the planes), else None."""
        if self.cfg.rgb_mlp_type == "direct":
            return None
        return cameras.unit_view_dirs(h, w, extrins, intrins)[:, None]

    def _planes_sparse(self, params, h, w, extrins, intrins, uv):
        """Sparse-phase samples (JAX mpmesh.py:455-499): K1 warps, adds the
        uv-noise draws uv = (nx, ny) when given, and looks up both tile
        maps, K2/K9 sample the static and dynamic tiles; a plane takes its
        static texel where the static map hits.  Under the vertex warp,
        K1's coordinate entry looks up the warped (and jittered) samples,
        whose in-tile fractions carry the gradient to verts (K23).
        Returns (coords, rgb (B, D, h, w, 3), alpha (B, D, h, w)), zero
        where no tile is hit (coords.valid is the un-jittered sample's)."""
        g = self.geom
        maps = (self.tile_map_static, self.tile_map_dyn)
        if self.optimize_geometry:
            coords = self._warp(params, h, w, extrins, intrins)
            sample = R.add_texel_noise(coords, *uv) if uv else coords
            k_s, k_d, i, j = R.tile_lookup_coords(                 # K1
                sample.x.detach().contiguous(),
                sample.y.detach().contiguous(),
                sample.valid.contiguous(), *maps, g.tile_span)
            fu, fv = R.tile_fractions(sample.x, sample.y, i, j, g.tile_span)
        else:
            G = R.homographies(g, extrins, intrins).contiguous()
            coords, k_s, k_d, fu, fv = R.warp_lookup(                 # K1
                G, *maps, h, w, (g.mpi_h, g.mpi_w), g.tile_span, *uv)
        vals_s, hit_s = R.sample_sparse(params["atlas"], k_s, fu, fv)  # K2/K9
        vals_d, hit_d = R.sample_sparse(params["atlas_dyn"], k_d, fu, fv)
        feats = torch.where(hit_s[..., None], vals_s, vals_d)
        rgb_p, alpha_p = self._decode(
            feats, coords, self._view_dirs(h, w, extrins, intrins),
            params.get("decoder"))
        hit = hit_s | hit_d
        return coords, rgb_p * hit[..., None], torch.where(hit, alpha_p, 0.0)

    def render(self, params, h, w, extrins, intrins, training=False,
               gen=None, draws=None):
        """Render views whose extrinsics (B, 4, 4) are RELATIVE to the
        reference camera; intrins (B, 3, 3).  Parity: MPI.py:452-594.
        A training render takes its random inputs (``--add_uv_noise``,
        ``--bg_color random``) from `draws` or, without them, from the
        torch.Generator gen (`training_draws`).  The uv noise jitters the
        sample positions only: decode, disparity and the loop-mask stay
        on the un-jittered samples' valid, as in the JAX package.

        Returns (rgbl (B, h, w, 3 [+1 loop label in the dense phase]),
        variables with the per-plane stacks for the regularizers)."""
        cfg = self.cfg
        need_mask = cfg.learn_loop_mask and not self.is_sparse
        if training and draws is None:
            draws = training_draws(cfg, gen, (extrins.shape[0],
                                              self.geom.n_planes, h, w))
        uv = draws.get("uv", ()) if training and draws else ()
        bg = background(cfg, draws if training else None, self.device)
        if self.is_sparse:
            coords, rgb_p, alpha_p = self._planes_sparse(params, h, w,
                                                         extrins, intrins, uv)
        else:
            coords = (self._warp(params, h, w, extrins, intrins)
                      if self.optimize_geometry else
                      R.warp_coordinates(self.geom, extrins, intrins, h, w))
            sample = R.add_texel_noise(coords, *uv) if uv else coords
            feats, mask_feats = R.sample_dense(               # K5 / K6 (K22)
                params["atlas"], params["atlas_mask"] if need_mask else None,
                sample)
            if training and cfg.fused_render and cfg.fused_decoder():
                return self._render_fused_dense(coords, feats, mask_feats,
                                                need_mask, bg)
            rgb_p, alpha_p = self._decode(
                feats, coords, self._view_dirs(h, w, extrins, intrins),
                params.get("decoder"))
        out_rgb, bw = R.composite_planes(alpha_p, rgb_p)
        alpha_sum = torch.sum(bw, dim=1)
        out_rgb = R.apply_background(out_rgb, alpha_sum, bg)
        disp = R.normalized_disparity(
            self.geom, coords, bw, cfg.normalize_blendweight_fordepth)
        variables = {"alpha_planes": alpha_p, "rgb_planes": rgb_p,
                     "blend_weight": bw, "disp_norm": disp,
                     "alpha": alpha_sum, "loop_planes": None}
        rgbl = out_rgb
        if need_mask:
            label_p = torch.sigmoid(mask_feats[..., 0])
            label_p = torch.where(coords.valid, label_p, 0.0)
            # the loop-mask composite uses the DETACHED alpha (ref MPI.py:578)
            label, _ = R.composite_planes(alpha_p.detach(), label_p[..., None])
            variables["loop_planes"] = label_p
            rgbl = torch.cat([out_rgb, label], dim=-1)
        return rgbl, variables

    def forward(self, params, h, w, tar_extrins, tar_intrins,
                training=False, gen=None, draws=None):
        """World-space forward (ref MPI.py:596-652): target extrinsics
        (B, 4, 4) and intrinsics (B, 3, 3), as tensors or arrays; gen and
        draws as in `render`.  Returns (rgbl, extra losses) — the losses
        only when training."""
        dev = self.device
        tar_extrins = torch.as_tensor(tar_extrins, dtype=torch.float32,
                                      device=dev)
        tar_intrins = torch.as_tensor(tar_intrins, dtype=torch.float32,
                                      device=dev)
        # the reference extrinsic's inverse in f32 on the host (a 4x4;
        # torch.linalg.inv on the card would synchronize)
        ref_inv = torch.as_tensor(
            np.linalg.inv(self.geom.ref_extrin_np()), device=dev)
        rel = tar_extrins @ ref_inv[None]
        rgbl, variables = self.render(params, h, w, rel, tar_intrins,
                                      training, gen, draws)
        extra = {}
        if not training:
            return rgbl, extra
        cfg = self.cfg
        fused = variables.get("fused_regs")
        a = variables["alpha_planes"]
        loop_p = variables["loop_planes"]
        # same keys, in the same order, as the JAX model
        if cfg.sparsity_on:
            extra["sparsity"] = fused["sparsity"] if fused is not None \
                else regs.sparsity_loss(a, self.geom.n_planes,
                                        cfg.sparsity_eps)
        if cfg.rgb_smooth_on:
            extra["rgb_smooth"] = fused["rgb_smooth"] if fused is not None \
                else regs.content_smooth_loss(variables["rgb_planes"])
        if cfg.a_smooth_on:
            extra["a_smooth"] = fused["a_smooth"] if fused is not None \
                else regs.content_smooth_loss(a[..., None])
        if cfg.d_smooth_on:
            extra["d_smooth"] = regs.depth_smooth_loss(
                variables["disp_norm"], rgbl[..., :3], cfg.edge_scale)
        if cfg.l_smooth_on:
            if fused is not None and "l_smooth" in fused:
                extra["l_smooth"] = fused["l_smooth"]
            elif fused is None and loop_p is not None:
                extra["l_smooth"] = regs.content_smooth_loss(
                    loop_p[..., None])
        if cfg.density_on:
            extra["density"] = regs.density_loss(variables["alpha"])
        return rgbl, extra
