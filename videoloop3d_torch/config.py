"""Configuration system: argparse + two-level text config files.

Copy of ``videoloop3d_tpu/config.py`` (the port imports nothing from the
JAX package): a base config (``--config``) overridden by a per-scene
config (``--config1``), both in ``key = value`` / bare-flag text format,
with *unique-prefix key matching* (the shipped configs say ``i_weight``
for the ``--i_weights`` flag).  Command-line flags override both files.
The flag surface is identical, so every shipped config parses to the
same namespace in both packages.
"""
from __future__ import annotations

import argparse
import shlex


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=True)
    # config files (handled manually in parse_args_with_configs)
    p.add_argument("--config", type=str, default="", help="base config file")
    p.add_argument("--config1", type=str, default="", help="per-scene config file")

    p.add_argument("--expname", type=str, default="exp")
    p.add_argument("--expname_postfix", type=str, default="")
    p.add_argument("--test_view_idx", type=str, default="")

    p.add_argument("--prefix", type=str, default="")
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--expdir", type=str, default="")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--near_factor", type=float, default=0.9)
    p.add_argument("--far_factor", type=float, default=2)
    p.add_argument("--chunk", type=int, default=1024 * 32)
    p.add_argument("--fp16", action="store_true",
                   help="train atlases in bfloat16 (working replacement for "
                        "the reference's broken fp16 flag)")
    p.add_argument("--bg_color", type=str, default="")
    p.add_argument("--scale_invariant", action="store_true")

    # MPV (stage 2)
    p.add_argument("--mpv_frm_num", type=int, default=90)
    p.add_argument("--mpv_isloop", action="store_true")
    p.add_argument("--init_from", type=str, default="")
    p.add_argument("--init_std", type=float, default=0)
    p.add_argument("--add_uv_noise", action="store_true")
    p.add_argument("--add_intrin_noise", action="store_true")

    # looping-loss config
    p.add_argument("--loss_ref_idx", type=str, default="0")
    p.add_argument("--loss_name", type=str, default="gpnn")
    p.add_argument("--loss_name_ref", type=str, default="gpnn")
    p.add_argument("--swd_macro_block", type=int, default=65)
    p.add_argument("--swd_patch_size_ref", type=int, default=5)
    p.add_argument("--swd_patch_size", type=int, default=5)
    p.add_argument("--swd_patcht_size_ref", type=int, default=5)
    p.add_argument("--swd_patcht_size", type=int, default=5)
    p.add_argument("--swd_stride_ref", type=int, default=2)
    p.add_argument("--swd_stride", type=int, default=2)
    p.add_argument("--swd_stridet", type=int, default=2)
    p.add_argument("--swd_stridet_ref", type=int, default=2)
    p.add_argument("--swd_rou", type=str, default="0")
    p.add_argument("--swd_rou_ref", type=str, default="0")
    p.add_argument("--swd_scaling", type=float, default=0.2)
    p.add_argument("--swd_scaling_ref", type=float, default=0.2)
    p.add_argument("--swd_alpha", type=float, default=0)
    p.add_argument("--swd_alpha_ref", type=float, default=0)
    p.add_argument("--swd_dist_fn", type=str, default="mse")
    p.add_argument("--swd_dist_fn_ref", type=str, default="mse")
    p.add_argument("--swd_factor", type=int, default=1)
    p.add_argument("--swd_factor_ref", type=int, default=1)
    p.add_argument("--swd_loss_gain_ref", type=float, default=1)
    p.add_argument("--swd_num_proj", type=int, default=256,
                   help="random projections for the SWD loss variant")

    # pyramid
    p.add_argument("--pyr_stage", type=str, default="")
    p.add_argument("--pyr_minimal_dim", type=int, default=60)
    p.add_argument("--pyr_num_epoch", type=int, default=600)
    p.add_argument("--pyr_factor", type=float, default=0.5)
    p.add_argument("--pyr_init_level", type=int, default=-1,
                   help="start the stage-2 pyramid at this level index "
                        "(skip coarser levels); -1 = start at level 0")

    # MPI
    p.add_argument("--sparsify_epoch", type=int, default=-1)
    p.add_argument("--sparsify_rmfirstlayer", type=int, default=0)
    p.add_argument("--sparsify_erode", type=int, default=2)
    p.add_argument("--learn_loop_mask", action="store_true")
    p.add_argument("--direct2sh_epoch", type=int, default=-1)
    p.add_argument("--sparsify_alpha_thresh", type=float, default=0.03)
    p.add_argument("--vid2img_mode", type=str, default="average")
    p.add_argument("--mpi_h_scale", type=float, default=1)
    p.add_argument("--mpi_w_scale", type=float, default=1)
    p.add_argument("--mpi_h_verts", type=int, default=12)
    p.add_argument("--mpi_w_verts", type=int, default=15)
    p.add_argument("--mpi_d", type=int, default=64)
    p.add_argument("--atlas_grid_h", type=int, default=8)
    p.add_argument("--atlas_size_scale", type=float, default=1)
    p.add_argument("--atlas_cnl", type=int, default=4)
    p.add_argument("--model_type", type=str, default="MPMesh")
    p.add_argument("--rgb_mlp_type", type=str, default="direct")
    p.add_argument("--rgb_activate", type=str, default="sigmoid")
    p.add_argument("--alpha_activate", type=str, default="sigmoid")
    p.add_argument("--optimize_geo_start", type=int, default=10000000)
    p.add_argument("--optimize_verts_gain", type=float, default=1)
    p.add_argument("--normalize_verts", action="store_true")

    # training losses
    p.add_argument("--upsample_stage", type=str, default="")
    p.add_argument("--rgb_smooth_loss_weight", type=float, default=0)
    p.add_argument("--a_smooth_loss_weight", type=float, default=0)
    p.add_argument("--d_smooth_loss_weight", type=float, default=0)
    p.add_argument("--l_smooth_loss_weight", type=float, default=0)
    p.add_argument("--edge_scale", type=float, default=4)
    p.add_argument("--normalize_blendweight_fordepth", action="store_true")
    p.add_argument("--density_loss_weight", type=float, default=0)
    p.add_argument("--density_loss_epoch", type=int, default=0)
    p.add_argument("--sparsity_loss_weight", type=float, default=0)

    # training options
    p.add_argument("--N_iters", type=int, default=30)
    p.add_argument("--optimizer", type=str, default="adam", choices=["adam", "sgd"])
    p.add_argument("--fast_stage1_grad", action="store_true",
                   help="block-matmul adjoint for the stage-1 atlas "
                        "gradient: bypasses the slow XLA scatter with "
                        "an exact gather-free formulation (2.7x step "
                        "speedup on v5e; see render/adjoint.py)")
    p.add_argument("--s1_gemm_bf16", action="store_true",
                   help="run the stage-1 dense block sampler/adjoint "
                        "MXU contractions with bf16 inputs + f32 "
                        "accumulate (1 pass instead of 6; ~1e-3 rel "
                        "sample/grad noise, training-quality neutral "
                        "— measured 56 -> 44 ms/step on v5e)")
    p.add_argument("--s1_fwd_block", type=str, default="16x32",
                   help="stage-1 dense forward sampler block plan HxW "
                        "(45x64 pairs with --s1_gemm_bf16 for the "
                        "fastest measured step; render/adjoint.py)")
    p.add_argument("--no_render_remat", action="store_true",
                   help="keep render activations for the backward "
                        "instead of rematerializing (more HBM, less "
                        "recompute; pair with --fast_stage2_grad)")
    p.add_argument("--fast_stage2_grad", action="store_true",
                   help="per-tile adjoint for the stage-2 packed-tile "
                        "gradients: replaces the scatter-add backward "
                        "of the tile gathers with window slices + MXU "
                        "contractions (see render/adjoint.py)")
    p.add_argument("--compact_hits", action="store_true",
                   help="stage-2 hit-compaction: compact the sparse "
                        "plane sweep to the per-pixel max-hit bound so "
                        "gathers/decode/composite skip culled planes "
                        "(exact; see render/compact.py)")
    p.add_argument("--compact_tiles", action="store_true",
                   help="tile-compaction: the per-tile adjoint backward "
                        "loops only over tiles whose footprint can "
                        "reach the training patch (~20% at production "
                        "scale; exact — see "
                        "render/adjoint.py:active_tile_bound); needs "
                        "--fast_stage2_grad (stage 2) / "
                        "--fast_stage1_grad (stage-1 post-cull phase)")
    p.add_argument("--fast_nn_dist", action="store_true",
                   help="temporally-decomposed NN search in the GPNN "
                        "losses: per-frame distance matrices + banded "
                        "sums instead of full spatio-temporal patch "
                        "distances (F^2 vs ntx*nty*pt GEMM FLOPs; "
                        "exact up to float summation order / argmin "
                        "ties — see losses/patch_nn.py)")
    p.add_argument("--fast_nn_dist_ref", type=str, default="",
                   choices=["", "on", "off"],
                   help="per-view override of --fast_nn_dist for the "
                        "reference-view loss config ('' inherits). The "
                        "two shipped configs sit on opposite sides of "
                        "the bytes-for-FLOPs trade: the 3x3 other-view "
                        "step is HBM-bound (decomposition loses), the "
                        "11x11 ref-view step is latency-bound at 62% "
                        "HBM (decomposition wins)")
    p.add_argument("--fast_nn_dist_other", type=str, default="",
                   choices=["", "on", "off"],
                   help="per-view override of --fast_nn_dist for the "
                        "other-view loss config ('' inherits)")
    p.add_argument("--nn_bf16", type=str, default="",
                   choices=["", "on", "off"],
                   help="run the GPNN NN search + retarget fold in "
                        "bfloat16 (all under stop_gradient; distances "
                        "accumulate f32 on the MXU).  '' follows "
                        "--fp16: bf16 texels already quantize the "
                        "render, so the bf16 target adds nothing; an "
                        "all-f32 run stays f32 end to end")
    p.add_argument("--fused_render", action="store_true",
                   help="stage-2 fused decode+composite+regularizers "
                        "with a hand-derived VJP: nothing (S,h,w,F)-"
                        "shaped is materialized or saved as residuals "
                        "(render/fused.py); engages on the shipped "
                        "direct/sigmoid decoder, falls back otherwise")
    p.add_argument("--blocked_lookup", action="store_true",
                   help="stage-2 blocked tile-map lookup: fetch one "
                        "(Ti, J) tile-map block per (plane, scanline) "
                        "instead of one element gather per (plane, "
                        "pixel) (exact; see "
                        "render/renderer.py:tile_lookup2_blocked)")
    p.add_argument("--patch_batch", type=int, default=1,
                   help="stage-1 patches optimized jointly per step "
                        "(amortizes per-step overhead on TPU; 1 = "
                        "reference semantics)")
    p.add_argument("--patch_h_size", type=int, default=512)
    p.add_argument("--patch_w_size", type=int, default=512)
    p.add_argument("--patch_h_stride", type=int, default=128)
    p.add_argument("--patch_w_stride", type=int, default=128)
    p.add_argument("--lrate", type=float, default=5e-4)
    p.add_argument("--lrate_adaptive", action="store_true")
    p.add_argument("--lrate_decay", type=int, default=30)

    # logging
    p.add_argument("--i_img", type=int, default=300)
    p.add_argument("--i_print", type=int, default=300)
    p.add_argument("--i_weights", type=int, default=20000)
    p.add_argument("--i_video", type=int, default=10000)

    # resilience / observability (upgrades over the reference, which
    # lists checkpoints but never auto-resumes — ref train_3d.py:172-186)
    p.add_argument("--disable_auto_resume", action="store_true",
                   help="do not resume from the newest checkpoint in the "
                        "run directory")
    p.add_argument("--hang_timeout", type=float, default=0.0,
                   help="seconds without step progress before the "
                        "process self-terminates (exit 42) for a "
                        "restart + auto-resume; converts dead-peer "
                        "collective hangs and wedged device claims into "
                        "visible failures. Must exceed the worst cold "
                        "step compile (~70 s on v5e; use >= 600). "
                        "0 disables")
    p.add_argument("--profile_steps", type=str, default="",
                   help="'start:stop' step window to capture a "
                        "jax.profiler trace")
    p.add_argument("--profile_dir", type=str, default="",
                   help="trace output dir (default <rundir>/profile)")

    # parallelism: one process a rank (parallel/distributed.py)
    p.add_argument("--gpu_num", type=int, default=1,
                   help="reference-compat device switch: <= 0 selects the "
                        "CPU backend (ref train_3dvid.py:70-73); device "
                        "COUNT is --mesh_devices")
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="ranks of the rank grid: 0 = every process of "
                        "the run, else it must equal their number")
    p.add_argument("--host_crops", action="store_true",
                   help="accepted for the JAX package's command lines; "
                        "the port always crops on the device (refused "
                        "with --shard_views, as in the JAX package)")
    p.add_argument("--dp_serial_below", type=int, default=32,
                   help="stage 2: pyramid levels with fewer than this "
                        "many patches feed the dp mesh one patch per "
                        "optimizer step (weight-0 filler rows), keeping "
                        "the reference's batch-1 Adam regime where step "
                        "counts are small; larger levels batch n_dp "
                        "patches per step (0 disables)")
    p.add_argument("--mesh_fp", type=int, default=0,
                   help="frame-parallel axis size (0 = auto: the largest "
                        "divisor of the ranks on a host and of the loop "
                        "length that leaves pt - 1 frames a rank)")
    p.add_argument("--shard_views", action="store_true",
                   help="multi-host per-process data loading: each "
                        "process decodes/uploads only the views its dp "
                        "rows train on (both stages; requires every "
                        "process to own >= 1 train view)")
    # multi-process runs (one process a rank; parallel/distributed.py)
    p.add_argument("--coordinator_address", type=str, default="",
                   help="the process group's address: host:port of rank "
                        "0, tcp://host:port or file://path (torchrun's "
                        "MASTER_ADDR / MASTER_PORT work too)")
    p.add_argument("--num_processes", type=int, default=0,
                   help="processes (ranks) of the run (0 = one, or "
                        "torchrun's WORLD_SIZE)")
    p.add_argument("--process_id", type=int, default=-1,
                   help="this process's rank (-1 = torchrun's RANK)")
    return p


def _option_names(parser):
    names = []
    for action in parser._actions:
        for opt in action.option_strings:
            if opt.startswith("--"):
                names.append((opt[2:], action))
    return names


def _resolve_key(key, names):
    """Unique-prefix matching, like configargparse/argparse allow_abbrev."""
    exact = [(n, a) for n, a in names if n == key]
    if exact:
        return exact[0]
    pref = [(n, a) for n, a in names if n.startswith(key)]
    if len(pref) == 1:
        return pref[0]
    if not pref:
        raise KeyError(f"unknown config key '{key}'")
    raise KeyError(f"ambiguous config key '{key}': {[n for n, _ in pref]}")


def read_config_file(path, parser):
    """Parse a ``key = value`` / bare-flag config file into an argv list."""
    names = _option_names(parser)
    argv = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, val = line.split("=", 1)
                key, val = key.strip(), val.strip()
            else:
                key, val = line.strip(), None
            name, action = _resolve_key(key, names)
            if isinstance(action, argparse._StoreTrueAction):
                if val is None or str(val).lower() in ("true", "1", "yes"):
                    argv.append(f"--{name}")
            else:
                if val is None:
                    raise ValueError(f"config key '{key}' needs a value")
                argv.extend([f"--{name}", val])
    return argv


def parse_args_with_configs(argv=None, parser=None):
    """Full two-level parse: base config < scene config < command line."""
    parser = parser or build_parser()
    pre, _ = parser.parse_known_args(argv)
    file_argv = []
    for path in (pre.config, pre.config1):
        if path:
            file_argv.extend(read_config_file(path, parser))
    if argv is None:
        import sys
        argv = sys.argv[1:]
    return parser.parse_args(file_argv + list(argv))


def args_to_string(args):
    return "\n".join(f"{k} = {getattr(args, k)}" for k in sorted(vars(args)))


def parse_cli_string(s):
    return shlex.split(s)
