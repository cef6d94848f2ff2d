#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videoloop3d_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from videoloop3d_torch/csrc (kernels.build)
     and print ptxas's registers and stack frames of K15's, K12's, K14's,
     K10's, K4's, K9's, K13's, K19's, K20's, K21's, K25's, K2's, K8's,
     K7's, K28's, K3's, K23's and K22's kernels, the redesigns and the
     first designs;
  3. build the production-width sparse MTV of the JAX package's benchmark
     (360x640 render, D=32, F=50, 35x63 tiles of 12x12 texels: 9,786
     static + 4,257 dynamic tiles, seed 0) and write it as an mpv
     checkpoint next to a synthetic LLFF scene with 360x640 .npy videos;
  4. hold each kernel against its plain PyTorch version on the card at the
     shapes of one fixed-view chunk of 10 frames, f32 and bf16 texels, and
     time both (CUDA events); K2 and K3 also on the f32 static and
     dynamic atlases gathered as bf16 (the render's --fp16 path), bit for
     bit their samples of the bf16 copies, timed beside the copies; K4
     (redesigned: a block owns a run of pixels and all frames, the static
     samples decoded once into a shared table, the dynamic planes as bit
     words) bit for bit against its first design (vl3d_composite_first)
     on the chunk and timed beside it in turns, then on random stacks at
     D = 1, 33 and 128, F = 1 and 50, all masked, all hit and with
     non-finite masked-off samples, and its layout against the kernel's;
  5. render through ``videoloop3d_torch.tools.render_video.main`` (bf16
     texels, the shipped ``--fp16``): a fixed view over the whole 50-frame
     loop in chunks of 10, then a 10-pose spiral one frame per call, each
     with the launch counters set to 0 just before and read just after;
     then render ms/frame of both views with K4's first design in the
     model's place and with the redesign, in turns (the frames equal);
  6. check the frames (shape, not constant) and hold three of them
     against a render made of the plain versions on the card;
  7. profile one warm fixed-view chunk and one spiral frame
     (torch.profiler): device busy share and the largest device times;
  8. stage 1 at the shipped width (configs/mpi_base.txt: 360x640 scene,
     576x1024 texel planes, D=32, 180x320 patches, B=1): hold K5-K8
     against their plain versions on the card, time them (CUDA events)
     beside torch.nn.functional.grid_sample for K5/K6; K6 (128-bit
     atomics) also beside its first design (four scalar atomics a
     corner, vl3d_sample_dense_grad_scalar) and the zero fill, and held
     again with every other plane's pixels permuted (a warp's samples
     spread across the plane); K6 with shared-memory accumulation
     (vl3d_sample_dense_grad_window, measured slower, not on the port's
     path) held and timed at four windows on both sample sets (the
     spread tiles take its global branch), and the atomic instructions
     of the three K6 kernels counted in their SASS (cuobjdump); K8
     (redesigned: a 16 x 8 pixel tile with its halo, each plane decoded
     once into shared memory, T_in there) bit for bit against its first
     design (vl3d_fused_s1_bwd_first) at the shipped flags and with every
     flag on, both timed in turns, and its layout against the kernel's;
     likewise K7 (redesigned on K8's tile with the one-sided halo the
     forward reads, each pixel's sums reduced by the first design's tree)
     against vl3d_fused_s1_fwd_first on its eight outputs, the same bits
     twice;
  9. train through ``videoloop3d_torch.tools.train_3d.main`` on a 360x640
     synthetic scene (3 views x 12 frames) for 2 epochs, once on the
     shipped route and once with ``--fused_render``, each with the launch
     counters set to 0 just before and read just after; check the loss,
     the PSNR, the checkpoint and the launches;
 10. hold one stage-1 step with the kernels against the same step made
     of the plain versions on the card (loss, metrics, gradients), and
     profile one warm step of each route; then the dense step of the
     shipped route with K6's first design in its place and with the
     redesign, in turns (first, redesign, redesign, first): step ms,
     device ms, busy share and K6's share; and the --fused_render dense
     step with K8's first design and its redesign in turns (K8's share),
     and likewise with either K7 (K7's kernels' share);
 11. cull a synthesized shipped-width dense atlas (about 20% of the
     70,560 tiles kept, about 30% of them dynamic) through
     ``models/sparsify.py``, and hold K1, K2 and K9 against their plain
     versions on the card at the sparse step's shapes, timed (CUDA
     events) with their bounds; K9 (redesigned: its own zero fill, one
     vector atomic a corner) also against its first design (four scalar
     atomics a corner, vl3d_bilinear_tiles_grad_first), timed beside it
     in turns, and the atomic instructions of both counted in their SASS;
 12. train the shipped route through the cull with
     ``videoloop3d_torch.tools.train_3d.main`` and ``--N_iters 3
     --sparsify_epoch 2`` (2 dense epochs, the cull at a threshold cut
     to 0.03, 1 sparse epoch) with the launch counters set to 0 just
     before and read just after: the cull line, K1/K2/K9 launched, finite
     losses and a sparse ``ckpt_epoch_0002.npz``; then ``--N_iters 4``
     must auto-resume from it;
 13. hold one sparse step with the kernels against the same step made of
     the plain versions, and profile one warm sparse step;
 14. stage 2 on the benchmark MTV of phase 3 at the shipped config
     (``configs/mpv_base.txt`` with ``--factor 1 --mpv_frm_num 50``;
     ``--fp16``), one 180x320 patch: hold K10 (redesigned: stable bins by
     tile, one gather a tile and slice, the empty tiles zero-filled) on
     the f32 dynamic atlas, its sums rounded to bf16 as the step runs it
     (the f32 sums' rounding bit for bit; the f32 sums within 1e-6 *
     max|g| of its plain version and 1e-5 of its first design,
     vl3d_bilinear_tiles_tilemajor_grad_first; both the same bits twice;
     its layout against the kernel's), timed in turns beside its first
     design and beside the chain it replaced (zero fill, first design,
     two casts); K3 on the f32 atlas gathered as bf16, bit for bit its
     samples of the bf16 copy, timed in turns beside K3 on the copy; K9
     on bf16 tiles, and
     K11 and K12 for both loss configs with f32 and bf16 search inputs,
     against their plain versions, timed (CUDA events) with bounds and
     library times, K11 beside its first design (the first CUDA-core
     template, vl3d_nn_argmin_simt; on f32 inputs the redesigned
     CUDA-core search equals it bit for bit), K12 bit for bit equal to
     its first design (vl3d_nn_fold_first), both timed in turns; then K11
     on bf16 inputs, K18
     and K11's ssim mode where choices have bit-equal candidates (the
     video's frames repeated every 10), at both views and at an odd C ph
     pw with pt = 1 and pt = 3 at st = 2: every choice the first of its
     exact ties, K11's other differences near ties, K18 and the ssim mode
     equal to their first designs;
 15. the shipped route's kernels on the same patch at the slot bound S of
     that view (printed beside D): K13 (redesigned: 32 pixels and all
     planes a block, the hits as bit words, each slot written once)
     against its plain version and its first design
     (vl3d_compact_sweep_first), exact, timed in turns beside the first
     design, then on random sweeps at D = 1, 32, 33, 128 and S = 1, 15,
     D with all-miss and all-hit pixels, its layout against the kernel's;
     K14 and K15 (shipped flags, timed, and every flag on)
     against theirs, K14 and K15 rerun bit for bit, K14 (redesigned on
     K15's pixel tile) and K15 bit for bit equal to their first designs
     (vl3d_fused_s2_fwd_first, vl3d_fused_s2_bwd_first), timed with
     bounds; K14's layout against the kernel's; K14, K15 and their first
     designs timed in turns with the shipped flags, every flag on and
     every flag off (the attribution); K2 and K9 on the static atlas at
     the slot bound's compacted samples as the --fp16 step runs them (the
     f32 atlas read as bf16, bit for bit K2 on the copy; K9 within 1e-5 *
     max|g| of its plain version and first design, rounding its sums
     within a bf16 step of the old chain, its rounding pass bit for bit
     .to(bf16).float()), timed in turns beside the copy, K9's first
     design and the old chain;
 16. hold one stage-2 step with the kernels against the same step made of
     the plain versions, on the shipped route (``--compact_hits
     --fused_render``) and on the unfused, uncompacted route, for a ref
     view (alpha 0) and an other view;
 17. profile one warm stage-2 step of each route (device time by group,
     busy share, peak memory), then the shipped step with K11's first
     design in its place and with the redesign, in turns, and likewise
     with K15's and K12's first designs, and with K14's and K10's first
     designs plus the old chain of the dynamic atlas (its bf16 copy, the
     zero fill, the gradient's cast and widening) against the redesigns
     (device and host time, the copies as a group, peak memory), and with
     K9's first design plus the old chain of the static atlas against
     K2/K9 on the f32 atlas; one step's launch counters (K2 and K9 once,
     K4 never; K9's first design adds to no count);
 18. train through ``videoloop3d_torch.tools.train_3dvid.main`` on the
     unmodified ``configs/mpv_base.txt`` (``--factor 1 --mpv_frm_num 50``
     on the command line) from the phase-11 cull (written as a sparse
     stage-1 checkpoint with dynamic tiles) on a 360x640 synthetic scene
     of 3 views x 50 frames, ``--pyr_init_level 4 --pyr_num_epoch 1``
     (levels 4 and 5), with the launch counters set to 0 just before and
     read just after: the hit-compaction line of each level with S < D,
     K2, K3, K9-K15 launched once per step, K1 once per step and once per
     view and level for the slot bound, K4 never, finite losses; then
     ``--pyr_num_epoch 2`` must auto-resume at level 5, epoch 1;
 19. (with phase 14) K1 with uv-noise draws against its plain version, bit
     for bit, and without them still bit for bit;
 20. the dense stage-2 phase at the mpv_base scratch width (396x704
     texel planes, D=32, F=50): K17's layout against the kernel's own;
     K16 (redesigned: corners once per sample, vector loads) on f32 and
     bf16 texels and on the f32 atlas gathered as bf16 (the main path),
     at the training patch (all frames) and an eval chunk (the 360x640
     view, 10 frames through ts), bit for bit against its plain version
     and its first design (vl3d_bilinear_planes_tilemajor_first); K17
     (redesigned: stable bins and one gather that writes every texel) in
     f32 and rounding its sums to bf16, against its plain version, its
     first design (vl3d_bilinear_planes_tilemajor_grad_first) and itself
     (two launches, the same bits); all timed (CUDA events) with bounds,
     the first designs, grid_sample as the library yardstick, and each
     rounding mode beside the chain of copy, first design and casts that
     it replaced;
 21. one dense stage-2 step (ref view, --fp16) with the kernels against
     the same step made of the plain versions, once as shipped and once
     with ``--add_uv_noise --bg_color random`` and the same draws fed to
     both; no sparse-route kernel may run;
 22. profile one warm dense step (device time by group, with PyTorch's
     copies, casts and fills as one group, busy share, peak memory), then
     the step with the bf16 copy, K16/K17's first designs, the zero fill
     and the casts in K16/K17's place and with the redesigns, in turns;
 23. train through ``videoloop3d_torch.tools.train_3dvid.main`` from
     scratch (no ``--init_from``) on the unmodified
     ``configs/mpv_base.txt`` with ``--factor 1 --mpv_frm_num 50
     --pyr_init_level 4 --pyr_num_epoch 1`` on phase 18's scene, with the
     launch counters set to 0 just before and read just after: K16 and
     K17 once per step, no sparse-route kernel, falling finite losses, a
     dense stage-2 checkpoint (7 GB);
 24. render through ``videoloop3d_torch.tools.render_video.main`` the
     fixed view over 50 frames in chunks of 10 of (a) that dense mpv
     checkpoint and (b) phase 9's dense stage-1 checkpoint (576x1024
     texels, broadcast to 50 frames on the card: 3.77 G elements), each
     held against a render of the plain versions;
 25. hold K18 (the banded temporal-patch NN search) and K19 (its
     selected-patch error) against their plain versions at the eval's
     shapes: view 0 of phase 18's scene and evaluate's render of phase
     18's checkpoint, cropped to 280x560, 50 frames, at the three patch
     scales, the pair (both directions) and the Loop Quality seam; index
     flips only on near ties, K18's rows and columns bit for bit equal to
     its first design's (vl3d_nn_band_argmin_first), K19 within 1e-6
     relative on the same indices; timed (CUDA events) beside the first
     design, with bounds and library yardsticks; K19 (redesigned:
     (channel, patch range) units, a sliding source window) also within
     1e-6 relative of its first design (vl3d_nn_band_err_first) and that
     within 1e-6 of the plain version, the same bits twice and with its
     target read from device memory or staged (both forms timed), both
     designs' largest relative error against float64 sums, its layout
     against the kernel's, both designs timed in turns; then
     tools/evaluate.py's loopq and nnmse groups for that view
     (`loop_quality`, `compute_nnerr_pair`, the three scales, host clock)
     with K19's first design and with the redesign, in turns;
 26. (with phases 16 and 18) K18 at the stage-2 search shapes (both loss
     configs, f32 and bf16; bit for bit against and timed beside its first
     design), one shipped-route step with --fast_nn_dist against its
     plain composition and profiled with either K18 design in turns, and
     ``train_3dvid --fast_nn_dist`` on phase 18's setup (levels 4 and 5,
     one epoch each): K18 once per step, K11 never;
 27. ``videoloop3d_torch.tools.evaluate.main`` on phase 18's sparse mpv
     checkpoint (3 views x 50 frames, 360x640) with seeded local alex
     LPIPS weights (VL3D_LPIPS_WEIGHTS), the launch counters set to 0 just
     before and read just after: K1-K4, K18, K19 launched, the JAX
     package's column list, finite values, the NN columns within 1e-3 of
     the plain versions' metrics, the seconds of each metric group;
 28. ``videoloop3d_torch.tools.export_mesh.main`` on the same checkpoint:
     2 faces per kept tile, the static atlas packing_grid x the tile
     size, 50 dynamic frames, meta.json's frame_count;
 29. vertex-geometry optimization (``--optimize_geo_start``), the kernels
     alone on phase 8's setup: K20/K21 (the vertex warp's triangle search
     and its gradient) against their plain versions at flat verts (x, y
     within 1e-3 texel of the plane sweep) and at verts moved by up to
     0.3 of a quad: winners equal except where the top two scores lie
     within 1e-6, x, y, z within 1e-4, the verts gradient within 1e-5 *
     max|g|; K21 (redesigned: a block's window of vertices summed on
     chip in a fixed order, a second pass adding the windows in block
     order) also within 1e-5 * max|g| of its first design (9 global
     atomics a sample, vl3d_geo_warp_bwd_first), the same bits twice, its
     headers (windows, the samples of the overflow route, counted) and
     plan against `geo_bwd_layout`, both designs timed in turns; K20
     (redesigned: a block's window and triangle table staged once, the
     candidates found without division) bit for bit against its first
     design (one thread a sample, vl3d_geo_warp_fwd_first) in x, y, z,
     valid and tri at flat and moved verts and on an oblique view over a
     fine grid whose samples take the global route, its headers against
     `geo_bwd_layout`, both designs timed in turns; K22
     (the dense sampler's coordinate gradient, f32 and bf16,
     with and without the loop-mask channel) at the moved warp's
     coordinates; K1's coordinate entry (bit for bit) and K23 (the tile
     sampler's coordinate gradient, u, v set on tile edges on a share of
     the samples) at phase 11's cull; K23 (redesigned: no fill, a hit's
     corners and cotangent read as vectors) also bit for bit against its
     first design (its two zero fills, one thread a sample,
     vl3d_bilinear_tiles_coord_grad_first) and timed beside it in turns;
     each timed (CUDA events) with its bound, K22 beside
     grid_sampler_2d_backward's grid gradient;
 30. one dense geo step on each route, one dense geo step of the rgba_sh
     and one of the rgb_sh decoder (K22 at 36 and 13 channels, the loop
     mask on) and one sparse geo step on phase 11's cull, at moved verts,
     against their plain compositions (metrics 1e-5 relative, every
     gradient 1e-5 * max|g|), and a profile of each (device time by
     group, busy share, peak memory); the shipped dense and the sparse geo
     step profiled with K20's first design and with its redesign in
     turns, and likewise with either K21 (the redesign's two passes
     apart); the SH geo steps with either K22 (first, redesign, redesign,
     first);
 31. ``videoloop3d_torch.tools.train_3d.main`` on phase 9's scene with
     ``--optimize_geo_start 1``: (a) ``--N_iters 3`` on both routes, (b)
     ``--N_iters 4 --sparsify_epoch 2 --sparsify_alpha_thresh 0.03``, the
     launch counters set to 0 just before each run and read just after:
     K20/K21 once per geo step, K22 once per dense geo step, K1's
     coordinate entry once and K23 once per non-empty packed atlas per
     sparse geo step, none in the flat epoch; finite losses, moved verts,
     warm ms/step per phase;
 32. the swd loss's kernels on phase 14's patch (x (3, 52, 180, 320), y
     (3, 50, 180, 320), 256 projections) for both view configs (ref
     3x11x11 at stride 4, other 3x3x3 at stride 2): K24 (the projection)
     and K26 (its input gradient) within 1e-5 * max|out| of their plain
     versions and (redesigned: one register-tiled f32 GEMM core, K26's
     scratch transposed) bit for bit equal to their first designs
     (vl3d_swd_project_first on x and y, vl3d_swd_project_grad_first),
     K25 (the stable column sort and L1) with its gradient equal to its
     plain version's and its loss within 1e-6, and (redesigned: keys
     sorted by a warp's bitonic network in registers) bit for bit equal
     to its first design (vl3d_swd_sort_l1_first), also with x the
     shorter side, and with NaNs in the columns its gradient equal to the
     plain version's; a static region (exact ties) where K24's columns are
     bit-equal and K25's gradient equals its plain version's and its
     first design's; timed (CUDA events) with bounds beside cuDNN's
     conv3d, its input gradient, a stable torch.sort and K24/K25/K26's
     first designs (K25's in turns), K26's GEMM and fold timed apart (a
     profile) for either
     design, and cuBLAS's f32 GEMM of K24's and K26's products on the
     patch matrix extracted beforehand;
 33. K11's ssim mode (both views in bf16, the ref view in f32) and K12's
     parent mode (gpnn_down, ``--swd_factor_ref 2``) against their plain
     versions at the stage-2 search shapes: ssim index flips only on near
     ties, the ssim mode and K11's f32 "mse" search bit for bit equal to
     their first designs (vl3d_nn_argmin_ssim_first, vl3d_nn_argmin_simt),
     the fold within 1e-5 and bit for bit equal to its first design
     (vl3d_nn_fold_first); timed beside the first designs, with bounds
     and library yardsticks;
 34. one shipped-route stage-2 step with the swd loss on each view against
     its plain composition (the same draws), and a profile of each; then
     each view's step profiled with K24/K26's first designs and with
     their redesigns in turns (first, redesign, redesign, first), the
     same with K25's first design and its redesign, and the
     other view's step under --swd_dist_fn ssim with either design of
     K11's ssim mode;
 35. ``train_3dvid`` on phase 18's setup with ``--loss_name swd
     --loss_name_ref swd`` (levels 4 and 5, one epoch each): K24 twice,
     K25 and K26 once per step, no K11 or K12, finite losses;
 36. ``train_3dvid`` with ``--loss_name_ref gpnn_down --swd_factor_ref 2
     --swd_dist_fn ssim`` at level 5: K12's parent mode on the ref views'
     steps, K11's ssim mode on the others', K24-K26 never.

 37. K5, K6 and K22 at C = 13 (rgb_sh), 36 (rgba_sh) and 8 (nex_rgb /
     mlp_alpha at --atlas_cnl 8) with the loop-mask atlas at phase 8's
     shapes, against their plain versions (K5 bit for bit, K6/K22 within
     1e-5 * max|g|), C = 4 again and C = 4 padded to 5 (the float4 and the
     general-C kernels agree), timed beside grid_sample and its input and
     grid gradients; K5 at C != 4 (redesigned: corners once per sample, a
     block's outputs swept in output order) also bit for bit against and
     timed beside its first design (a thread per (sample, channel),
     vl3d_sample_dense_per_channel); K22 at C = 4, 13, 36 and 8
     (redesigned at C != 4: a warp's cotangents and terms staged in
     shared memory, each sample's channels summed in order) on f32 and
     bf16 texels, with and without the mask, bit for bit against its
     first design (one thread a sample, vl3d_sample_dense_coord_grad_first)
     and, where the wrapper keeps the first design (C = 4, bf16 at C = 13),
     the staged kernel (vl3d_sample_dense_coord_grad_staged) too, both
     timed in turns with bounds, its layout against the kernel's;
 38. K1 and K13 on the benchmark MTV's patch, then K2/K9 and K3/K10 on its
     tiles widened to C = 13 and 36 (bf16; K2/K9 also at C = 8); K2 at
     C != 4 (redesigned: a block's corners found once, its outputs swept
     in output order) at C = 13, 36 and 8 in f32, bf16 and f32 read as
     bf16, and at C = 13 on phase 11's sparse stage-1 samples, bit for bit
     against its first design (vl3d_bilinear_tiles_first) and timed in
     turns beside it with bounds, its layout against the kernel's; K9
     (redesigned at C != 4: K10's binned gather at F = 1) also the same
     bits twice, rounding its sums bit for bit .to(bf16).float() of them,
     its layout against the kernel's, and timed in turns beside the
     atomic route it replaced (vl3d_bilinear_tiles_grad_atomic), rounded
     and not; K3 at C != 4 (redesigned: a block's corners found once, its
     F x C outputs swept in output order) at C = 13 and 36 on the
     dynamic atlas in bf16 and f32 read as bf16, all 50 frames and a
     10-frame ts, and at C = 13 on phase 4's eval chunk (32 x 360 x 640,
     10 frames), bit for bit against its first design
     (vl3d_bilinear_tiles_tilemajor_first) and the plain version, timed
     in turns beside the first design with bounds, its layout against the
     kernel's; and K16/K17 on a (32, 396, 704, 10, 13) bf16
     stack and its f32 original gathered as bf16, against their plain
     versions and first designs, timed;
 39. one stage-1 step of each decoder (rgb_sh, rgba_sh, nex_rgb and
     mlp_alpha at --atlas_cnl 8) and of --fused_render --rgb_activate
     clamp at the shipped width, against the same step made of the plain
     versions; K5/K6 once, K7/K8 never; a profile of the rgb_sh and the
     rgba_sh step;
 40. the full-width SH path through the CLIs, the launch counters set to 0
     just before each and read just after: train_3d (mpi_base, factor 1)
     with --direct2sh_epoch 1 --N_iters 4 --sparsify_epoch 2
     --fused_render (K7/K8 in the direct epoch only, K5/K6 dense, K1/K2/K9
     on 13-channel tiles), train_3dvid (unmodified mpv_base, levels 4-5)
     from its checkpoint (rgb_sh adopted; K13 on, K14/K15 and K4 never),
     render_video and evaluate (its host PSNR/SSIM group left to phase
     27) of the SH MTV, train_3d --rgb_mlp_type
     rgba_sh for 2 flat epochs (C = 36) and a geometry epoch
     (--optimize_geo_start 2 --N_iters 3: K20, K21 and K22 once a
     geometry step, never before), and one epoch each of nex_rgb and
     mlp_alpha at --atlas_cnl 8; then a stage-2 rgb_sh step on the shipped
     flags (the benchmark MTV widened to 13 channels: K13 and K3/K10 at
     C = 13, K14/K15 never) against its plain composition, profiled, and
     profiled with K2's first design and its redesign in turns, then
     with K3's;
 41. K27/K28 (the swd mask branch: a per-row stable radix sort, the L1
     over ranks and its gradient) at both views' mask shapes (the patch
     video's loop mask, factors 1 and 3) against their plain versions
     (loss within 1e-6, gradient equal; a static region with exact
     ties), timed beside two stable torch.sorts; K27 (redesigned: one
     upsweep, then one ranking pass a digit with a decoupled look-back)
     on x's and y's rows bit for bit against a stable torch.sort's values
     and indices, and its first design (vl3d_swd_mask_sort_first), both
     timed, with torch.sort of x's and of y's rows; K28 (redesigned: a
     block a row keeps the row's signs as bits in shared memory, placed
     in the gradient's order) on the same rows and on the
     static region's, its gradient bit for bit and its loss within 1 f32
     ulp of its first design (vl3d_swd_mask_l1_first), the same bits
     twice, its route and layout against the kernel's, both timed in
     turns; then K28 on long synthetic rows that take its global route
     (66 rows of 2.2 M keys and 2 of 16.2 M: the bits in device memory),
     against its first design and the plain branch, timed in turns, the
     routes counted; then one shipped-route swd
     step with the mask against its plain composition, the launch
     counters set to 0 just before and read just after: K27 twice, K28
     once; and that step's profile with K27's first design and with the
     redesign in turns, and with either K28.

 42. two ranks on cuda:0 under gloo (``chip_smoke.py --par-worker``; NCCL
     refuses two ranks on one device, so every collective of a CUDA
     tensor goes through page-locked host memory): a dp = 2 step of the
     shipped stage-2 route (configs/mpv_base.txt --factor 1 --mpv_frm_num
     50, the benchmark MTV, one 180x320 patch a rank at the patches'
     slot bound, SGD): the reduced gradient (p.grad after the step)
     against the mean of rank 0's two single-patch gradients, and with
     rank 1's row at weight 0 against rank 0's own, each within PERF.md
     §2's step bound (1e-5 * max|g|; the atlases' bf16-rounded sums, K9's
     atomics among them, 2^-7 * max|g|); each rank's step ms (CUDA events)
     and the all_reduce's host ms;
 43. fp = 2 at F = 50 (25 frames a rank) on the ref view's gpnn_lm
     (alpha 0, pt 3: K11's minima and given-minima modes, K12's numerator
     mode) and on the swd loss (the draws fed to both): the loss within
     2e-4 relative of rank 0's single-process step, the gathered updates
     by tests/test_fp_sharding.py's rule, the launch counters set to 0
     just before the fp step and read just after; step and collective
     ms;
 44. a dp = 2 step of the shipped stage-1 route (configs/mpi_base.txt
     --factor 1), held as in phase 42 (f32: 1e-5 * max|g|);
 45. K11's two modes and K12's numerator mode at rank 0's search shapes
     of phase 43 (27 frames of the ref view, bf16): the given mode with
     the rank's own minima bit for bit K11, its other differences from
     the plain version near ties; the minima within 1e-5 of the term
     scale of the plain version's; the numerator over the plan's weight
     bit for bit K12 and within 1e-5 of the plain numerator; timed with
     bounds and library times (the kernels line);
 46. train_3dvid with --num_processes 2 --shard_views (two processes, a
     file:// store) on mpv_base level 5 from phase 18's checkpoint, cut
     to 8 steps (a patch's strides, --dp_serial_below 0): disjoint
     decoded views, rank 0's checkpoint and metrics, then render_video of
     it in this process; owndata_step1 on a .npy capture (three clips
     between black frames, .npy clips) and owndata_step2 from a COLMAP
     binary model written here, its poses loaded back.

The last lines are the ``{"kernels": [...]}`` record, the nvidia-smi line
and ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when no CUDA device is available.  Writes only under build/chip_smoke.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # bf16 tensor cores, f32 sums (dense)
SLEEP_CYCLES = 200_000_000       # ~0.1 s of device clock (cuda_ms)
CHUNK = 10
DEVICE = "cuda:0"                # the card the main path runs on
GPU_NUM = "1"                    # render_video's --gpu_num for DEVICE
REPLACES = {
    "warp_lookup": "videoloop3d_tpu/render/renderer.py:95",
    "bilinear_tiles": "videoloop3d_tpu/render/sample.py:72",
    "bilinear_tiles_tilemajor": "videoloop3d_tpu/render/sample.py:133",
    "composite": "videoloop3d_tpu/render/fused.py:109",
    "sample_dense": "videoloop3d_tpu/render/adjoint.py:366",
    "sample_dense_grad": "videoloop3d_tpu/render/adjoint.py:156",
    "fused_s1_fwd": "videoloop3d_tpu/render/fused_s1.py:90",
    "fused_s1_bwd": "videoloop3d_tpu/render/fused_s1.py:150",
    "bilinear_tiles_grad": "videoloop3d_tpu/render/adjoint.py:574",
    "bilinear_tiles_tilemajor_grad": "videoloop3d_tpu/render/adjoint.py:663",
    "nn_argmin": "videoloop3d_tpu/losses/patch_nn.py:274",
    "nn_fold": "videoloop3d_tpu/losses/patch_nn.py:219",
    "compact_sweep": "videoloop3d_tpu/render/compact.py:63",
    "fused_s2_fwd": "videoloop3d_tpu/render/fused.py:120",
    "fused_s2_bwd": "videoloop3d_tpu/render/fused.py:169",
    "bilinear_planes_tilemajor": "videoloop3d_tpu/render/sample.py:193",
    # JAX takes this gradient by autodiff of the same gather
    "bilinear_planes_tilemajor_grad": "videoloop3d_tpu/render/sample.py:193",
    "nn_band_argmin": "videoloop3d_tpu/losses/patch_nn.py:338",
    "nn_band_err": "videoloop3d_tpu/eval/nnmse.py:132",
    "geo_warp_fwd": "videoloop3d_tpu/render/geo_warp.py:85",
    # JAX takes it by autodiff of the same loop (and of _bary, :72)
    "geo_warp_bwd": "videoloop3d_tpu/render/geo_warp.py:85",
    # JAX: autodiff of the gathers the geometry phase samples through
    "sample_dense_coord_grad": "videoloop3d_tpu/render/sample.py:13",
    "bilinear_tiles_coord_grad": "videoloop3d_tpu/render/sample.py:72",
    "tile_lookup_coords": "videoloop3d_tpu/render/renderer.py:95",
    # swd_3d_loss (:48): the conv (:71), the sorts (:100) and, by
    # autodiff, the conv's input gradient
    "swd_project": "videoloop3d_tpu/losses/swd.py:71",
    "swd_sort_l1": "videoloop3d_tpu/losses/swd.py:100",
    "swd_project_grad": "videoloop3d_tpu/losses/swd.py:48",
    "nn_argmin_ssim": "videoloop3d_tpu/losses/patch_nn.py:292",
    "nn_fold_parent": "videoloop3d_tpu/losses/patch_nn.py:682",
    # the mask branch (:79-93): its sort over all patches of a projection
    # (:100) and the mean L1 with its gradient (:102)
    "swd_mask_sort": "videoloop3d_tpu/losses/swd.py:79",
    "swd_mask_l1": "videoloop3d_tpu/losses/swd.py:102",
}
# K11's and K12's modes of the frame-parallel gpnn loss (phase 45)
REPLACES.update({
    "nn_argmin_colmin": "videoloop3d_tpu/parallel/fp_step.py:128",
    "nn_argmin_given": "videoloop3d_tpu/parallel/fp_step.py:130",
    "nn_fold_numer": "videoloop3d_tpu/parallel/fp_step.py:135"})
RENDER_KERNELS = ("warp_lookup", "bilinear_tiles", "bilinear_tiles_tilemajor",
                  "composite")
# the CUDA functions of the kernels redesigned last, beside those of the
# designs they replaced
DESIGN_KERNELS = {
    "sample_dense_coord_grad": {
        "C4": ["sample_dense_coord_grad_kernel<T>"],
        "redesign_C_not_4": ["coord_grad_staged_kernel<T, kVec>"],
        "replaced_C_not_4": ["sample_dense_coord_grad_kernel<T>"],
        "bf16_C_not_multiple_of_4": ["sample_dense_coord_grad_kernel<T>"],
        "first_design": "csrc/sample_dense.cu:"
                        "vl3d_sample_dense_coord_grad_first"},
    "bilinear_tiles_tilemajor": {
        "C4": ["bilinear_tiles_tilemajor_kernel<T, kRound>"],
        "redesign_C_not_4": [
            "bilinear_tiles_tilemajor_sweep_kernel<T, kRound>"],
        "replaced_C_not_4": ["bilinear_tiles_tilemajor_kernel<T, kRound>"],
        "first_design": "csrc/bilinear_tiles_tilemajor.cu:"
                        "vl3d_bilinear_tiles_tilemajor_first"},
    "bilinear_tiles_coord_grad": {
        "redesign_C4": ["coord_grad_c4_kernel<T>"],
        "C_not_4": ["bilinear_tiles_coord_grad_kernel<T>"],
        "replaced": ["FillFunctor (x2)",
                     "bilinear_tiles_coord_grad_kernel<T>"],
        "first_design": "csrc/bilinear_tiles.cu:"
                        "vl3d_bilinear_tiles_coord_grad_first"},
    "bilinear_tiles": {
        "C4": ["bilinear_tiles_kernel<T, kRound>"],
        "redesign_C_not_4": ["bilinear_tiles_sweep_kernel<T, kRound>"],
        "replaced_C_not_4": ["bilinear_tiles_kernel<T, kRound>"],
        "first_design": "csrc/bilinear_tiles.cu:vl3d_bilinear_tiles_first"},
    "fused_s1_bwd": {
        "redesign": ["fused_s1_bwd_tile_kernel"],
        "replaced": ["fused_s1_bwd_kernel"],
        "first_design": "csrc/fused_s1.cu:vl3d_fused_s1_bwd_first"},
    "fused_s1_fwd": {
        "redesign": ["fused_s1_fwd_tile_kernel", "fused_s1_tree_kernel"],
        "replaced": ["fused_s1_fwd_kernel", "fused_s1_reduce_kernel"],
        "first_design": "csrc/fused_s1.cu:vl3d_fused_s1_fwd_first"},
    "swd_mask_l1": {
        "redesign": ["mask_l1_bits_kernel", "mask_l1_set_kernel",
                     "mask_l1_grad_kernel", "mask_loss_kernel"],
        "replaced": ["mask_l1_kernel", "mask_loss_kernel",
                     "mask_grad_kernel"],
        "first_design": "csrc/swd_mask.cu:vl3d_swd_mask_l1_first"},
    "geo_warp_fwd": {"redesign": ["geo_window_kernel",
                                  "geo_fwd_tile_kernel"],
                     "replaced": ["geo_warp_fwd_first_kernel"]},
    "bilinear_tiles_grad": {
        "C4": ["zero_grad_kernel", "bilinear_tiles_grad_kernel<4, 4>",
               "round_bf16_kernel"],
        "redesign_C_not_4": ["tiles_key_kernel", "bin_hist_kernel",
                             "bin_scan_kernel", "bin_scatter_kernel",
                             "bin_offsets_kernel", "tiles_count_kernel",
                             "tiles_zero_rows_kernel",
                             "tiles_grad_gather_kernel<kV, kRound, true>"],
        "replaced_C_not_4": ["zero_grad_kernel",
                             "bilinear_tiles_grad_kernel<kV, 0>",
                             "round_bf16_kernel"]},
}
SOURCES = {k: f"videoloop3d_torch/csrc/{k}.cu" for k in REPLACES}
SOURCES.update({"sample_dense_grad": "videoloop3d_torch/csrc/sample_dense.cu",
                "fused_s1_fwd": "videoloop3d_torch/csrc/fused_s1.cu",
                "fused_s1_bwd": "videoloop3d_torch/csrc/fused_s1.cu",
                "bilinear_tiles_grad":
                    "videoloop3d_torch/csrc/bilinear_tiles.cu",
                "bilinear_tiles_tilemajor_grad":
                    "videoloop3d_torch/csrc/bilinear_tiles_tilemajor.cu",
                "compact_sweep": "videoloop3d_torch/csrc/compact.cu",
                "fused_s2_fwd": "videoloop3d_torch/csrc/fused_s2.cu",
                "fused_s2_bwd": "videoloop3d_torch/csrc/fused_s2.cu",
                "bilinear_planes_tilemajor_grad":
                    "videoloop3d_torch/csrc/bilinear_planes_tilemajor.cu",
                "nn_argmin": "videoloop3d_torch/csrc/nn_argmin_mma.cu",
                "nn_band_argmin": "videoloop3d_torch/csrc/nn_argmin.cu",
                "geo_warp_fwd": "videoloop3d_torch/csrc/geo_warp.cu",
                "geo_warp_bwd": "videoloop3d_torch/csrc/geo_warp.cu",
                "sample_dense_coord_grad":
                    "videoloop3d_torch/csrc/sample_dense.cu",
                "bilinear_tiles_coord_grad":
                    "videoloop3d_torch/csrc/bilinear_tiles.cu",
                "tile_lookup_coords":
                    "videoloop3d_torch/csrc/warp_lookup.cu",
                "swd_project": "videoloop3d_torch/csrc/swd.cu",
                "swd_sort_l1": "videoloop3d_torch/csrc/swd.cu",
                "swd_project_grad": "videoloop3d_torch/csrc/swd.cu",
                "nn_argmin_ssim": "videoloop3d_torch/csrc/nn_argmin.cu",
                "nn_fold_parent": "videoloop3d_torch/csrc/nn_fold.cu",
                "swd_mask_sort": "videoloop3d_torch/csrc/swd_mask.cu",
                "swd_mask_l1": "videoloop3d_torch/csrc/swd_mask.cu",
                "nn_argmin_colmin": "videoloop3d_torch/csrc/nn_argmin_mma.cu",
                "nn_argmin_given": "videoloop3d_torch/csrc/nn_argmin_mma.cu",
                "nn_fold_numer": "videoloop3d_torch/csrc/nn_fold.cu"})
SPARSE_KERNELS = ("warp_lookup", "bilinear_tiles", "bilinear_tiles_grad")
# phase 11's sparse stage-1 samples and static tiles, kept for phase 38
SPARSE_S1_SAMPLES = {}
# phase 4's eval chunk (the fixed view's dynamic lookups), kept for phase 38
EVAL_CHUNK_SAMPLES = {}
S1_HW = (360, 640)               # the shipped stage-1 scene (factor 1)
S1_PATCH = (180, 320)
S1_ROUTES = {"shipped": [], "fused": ["--fused_render"]}
S2_KERNELS = ("warp_lookup", "bilinear_tiles", "bilinear_tiles_grad",
              "bilinear_tiles_tilemajor", "bilinear_tiles_tilemajor_grad",
              "nn_argmin", "nn_fold")
SHIPPED_KERNELS = ("compact_sweep", "fused_s2_fwd", "fused_s2_bwd")
S2_ROUTES = {"shipped": S2_KERNELS + SHIPPED_KERNELS, "unfused": S2_KERNELS}
S2_PATCH = (180, 320)
DENSE_KERNELS = ("bilinear_planes_tilemajor",
                 "bilinear_planes_tilemajor_grad")
SWD_KERNELS = ("swd_project", "swd_sort_l1", "swd_project_grad")
# the sparse routes' kernels, which a dense stage-2 model never reaches
SPARSE_ROUTE_KERNELS = ("warp_lookup", "bilinear_tiles",
                        "bilinear_tiles_tilemajor", "composite",
                        "bilinear_tiles_grad", "bilinear_tiles_tilemajor_grad",
                        "compact_sweep", "fused_s2_fwd", "fused_s2_bwd")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_lines(report):
    """nvcc's ptxas report, one line a kernel: its (mangled) name, then
    registers, stack and spills; the sources' headers kept."""
    out, name = [], None
    for ln in report.splitlines():
        if ln.startswith("=="):
            out.append(ln)
        elif "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and ("spill" in ln or "registers" in ln):
            out.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    return out


# K22's at C != 4, K3's at C != 4, K23's, K15's, K12's, K14's, K10's (and
# K9's at C != 4), K4's, K9's, K13's, K19's, K20's, K21's, K25's, K2's at
# C != 4, K8's, K7's and K28's kernels, the redesigns beside their first
# designs (K8's first design's stack frame: its T_in array in local
# memory; K28's: the deficit's copies in a local array)
REDESIGN_PTXAS = ("coord_grad_staged_kernel",
                  "sample_dense_coord_grad_kernel",
                  "bilinear_tiles_tilemajor_sweep_kernel",
                  "bilinear_tiles_tilemajor_kernel", "coord_grad_c4_kernel",
                  "bilinear_tiles_coord_grad_kernel",
                  "fused_s1_fwd_tile_kernel", "fused_s1_tree_kernel",
                  "fused_s1_fwd_kernel", "mask_l1_bits_kernel",
                  "mask_l1_set_kernel", "mask_l1_grad_kernel",
                  "mask_l1_kernel", "mask_grad_kernel",
                  "bilinear_tiles_sweep_kernel", "bilinear_tiles_kernel",
                  "fused_s1_bwd_tile_kernel", "fused_s1_bwd_kernel",
                  "geo_window_kernel", "geo_fwd_tile_kernel",
                  "geo_warp_fwd_first_kernel",
                  "geo_bwd_tile_kernel", "geo_bwd_sum_kernel",
                  "geo_warp_bwd_first_kernel", "swd_sort_net_kernel",
                  "swd_sort_smem_kernel", "swd_sort_l1_first_kernel",
                  "fused_s2_bwd_tile_kernel", "fused_s2_bwd_kernel",
                  "nn_fold_tile_kernel", "nn_fold_kernel",
                  "fused_s2_fwd_tile_kernel", "fused_s2_fwd_kernel",
                  "tiles_grad_gather_kernel",
                  "bilinear_tiles_tilemajor_grad_kernel",
                  "composite_tile_kernel", "composite_first_kernel",
                  "bilinear_tiles_grad_kernel",
                  "bilinear_tiles_grad_first_kernel",
                  "compact_bits_kernel", "compact_sweep_kernel",
                  "nn_band_err_unit_kernel", "nn_band_err_kernel")


def ptxas_kernels(report, names=REDESIGN_PTXAS):
    """{name: [{registers, stack_frame_bytes, spill_stores_bytes,
    spill_loads_bytes}, one a compiled instance]} from nvcc's ptxas
    report, for the kernels whose mangled names hold one of `names`."""
    import re
    out, cur = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            m = ln.split("'")[1] if "'" in ln else ln
            cur = next((n for n in names if n in m), None)
            if cur:
                out.setdefault(cur, []).append({})
        elif cur and "bytes stack frame" in ln:
            st, ss, sl = (int(v) for v in re.findall(r"(\d+) bytes", ln)[:3])
            out[cur][-1].update(stack_frame_bytes=st, spill_stores_bytes=ss,
                                spill_loads_bytes=sl)
        elif cur and "Used" in ln and "registers" in ln:
            out[cur][-1]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` back-to-back calls after one
    warm-up.  A sleep kernel holds the device while the host enqueues the
    calls, so the events time the device's work and not the wrappers'
    host overhead between launches, which exceeds a small kernel's run
    time (a function that synchronizes inside waits out the sleep and
    then runs host-bound as before)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ms_in_turns(fn, first, iters):
    """CUDA-event ms of a redesign (fn) and its first design (first) on the
    same inputs, timed in turns: first, redesign, redesign, first.
    Returns (redesign ms, first design ms, {the four times in order})."""
    times = {"first_design": [], "redesign": []}
    for key in ("first_design", "redesign", "redesign", "first_design"):
        times[key].append(cuda_ms(fn if key == "redesign" else first, iters))
    return (sum(times["redesign"]) / 2, sum(times["first_design"]) / 2,
            times)


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """The least time for the work: bytes over the memory rate, or
    operations over the card's peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nn_search_ops(plan, C, passes):
    """The least operations of one K11 column's products: the Gram of the
    patches (2 ntx nty d, d = C pt ph pw) or, where fewer, the Gram of
    the footprint frames (2 nfx nfy C ph pw) summed along the band of pt
    frames ((pt - 1) ntx nty adds), as the tensor-core kernel may take it;
    with `passes` operations a value for the row statistics (the norms:
    2; ssim's means and second moments: 4), per patch or per frame summed
    along the band."""
    (pt, ph, pw), st = plan.psz, plan.strides[0]
    ntx, nty = plan.grid[:2]
    cpp = C * ph * pw
    nfx, nfy = (ntx - 1) * st + pt, (nty - 1) * st + pt
    patches = 2 * ntx * nty * cpp * pt + passes * (ntx + nty) * cpp * pt
    frames = (2 * nfx * nfy * cpp + (pt - 1) * ntx * nty
              + passes * (nfx + nfy) * cpp
              + passes // 2 * (pt - 1) * (ntx + nty))
    return min(patches, frames)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def build_inputs(mtv):
    """Checkpoint + scene on disk (phase 3)."""
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.models import checkpoint as ckpt_io

    shutil.rmtree(WORK, ignore_errors=True)
    scene_dir = os.path.join(WORK, "scene")
    H, W = mtv["hw"]
    scene = synthetic.make_scene(n_views=3, h=H, w=W, n_frames=2, seed=0)
    synthetic.write_llff_dir(scene, scene_dir, factor=1)
    ckpt_io.save_checkpoint(
        os.path.join(WORK, "runs", "mtv", "ckpt_000001.npz"),
        geom=mtv["geom"], params=mtv["params"], stage="mpv", is_sparse=True,
        has_dyn=True, tile_map_static=mtv["tile_map_static"],
        tile_map_dyn=mtv["tile_map_dyn"], tile_hw=mtv["tile_hw"],
        frm_num=mtv["frm_num"])
    return scene_dir


def cli_argv(scene_dir, frm_num, extra):
    return ["--datadir", scene_dir, "--expdir", os.path.join(WORK, "runs"),
            "--expname", "mtv", "--factor", "1", "--mpv_frm_num",
            str(frm_num), "--fp16", "--gpu_num", GPU_NUM] + extra


def fixed_view(scene_dir, frm_num):
    """Model, params and the fixed view 0 exactly as render_video sets
    them up."""
    import torch
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run

    args = parse_args_with_configs(cli_argv(scene_dir, frm_num, []))
    _, _, scene = llff.load_mv_videos(
        scene_dir, factor=1, bd_factor=(args.near_factor, args.far_factor),
        recenter=True, render_frames=frm_num)
    H, W = scene["hw"]
    poses, intrins = scene["poses"], scene["intrins"]
    model, params, _, _ = load_mpv_from_run(
        args, H, W, np.eye(4), intrins[0], float(scene["bds"].min()),
        float(scene["bds"].max()), device=torch.device(DEVICE))
    ext = cameras.pose_to_extrinsic(poses[:1]).astype(np.float32)
    return model, params, ext, intrins[:1], (H, W)


def plain_render(model, params, h, w, ext, intr, ts):
    """The model's sparse eval render composed of the plain versions only
    (the reference the kernels' render is held against)."""
    import torch
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render.fused import composite_plain
    from videoloop3d_torch.render.sample import (
        bilinear_tiles_plain, bilinear_tiles_tilemajor_plain)

    dev = model.device
    g = model.geom
    G = R.homographies(g, torch.as_tensor(ext, device=dev),
                       torch.as_tensor(intr, device=dev)).contiguous()
    coords, k_s, k_d, fu, fv = R.warp_lookup_plain(
        G, model.tile_map_static, model.tile_map_dyn, h, w,
        (g.mpi_h, g.mpi_w), g.tile_span)
    valid0 = coords.valid[0]
    atlas_s = params["atlas"].to(model.gather_dtype)
    dyn = params["atlas_dyn"].to(model.gather_dtype)
    ths, tws = atlas_s.shape[1:3]
    th, tw = dyn.shape[1:3]
    vs, hs = bilinear_tiles_plain(atlas_s, k_s[0], fu[0] * (tws - 1),
                                  fv[0] * (ths - 1))
    vd, hd = bilinear_tiles_tilemajor_plain(
        dyn, k_d[0], fu[0] * (tw - 1), fv[0] * (th - 1),
        torch.as_tensor(ts, dtype=torch.int32, device=dev))
    out, _ = composite_plain(vs, valid0 & hs, vd, hd, valid0 & hd)
    rgb = out.movedim(2, 0)
    return (255.0 * rgb.clamp(0.0, 1.0)).to(torch.uint8).cpu().numpy()


def check_warp_lookup(G, maps, h, w, g):
    """K1 against its plain version: x, y, zview, fu, fv to 1e-4
    relative; k exact except within 1e-3 texel of a tile edge or the
    plane rectangle's edge.  Returns the record (times, bound)."""
    import torch
    from videoloop3d_torch.render import renderer as R

    k1_args = (G, *maps, h, w, (g.mpi_h, g.mpi_w), g.tile_span)
    kc, kks, kkd, kfu, kfv = R.warp_lookup(*k1_args)
    pc, pks, pkd, pfu, pfv = R.warp_lookup_plain(*k1_args)
    sy, sx = g.tile_span

    def near_edge(t, span, hi):
        return ((t - torch.round(t / span) * span).abs() < 1e-3) \
            | (t.abs() < 1e-3) | ((t - hi).abs() < 1e-3)

    edge = near_edge(pc.x, sx, g.mpi_w - 1) | near_edge(pc.y, sy,
                                                       g.mpi_h - 1)
    finite = torch.isfinite(pc.x) & torch.isfinite(pc.y)
    sel = pc.valid & ~edge
    rel = 0.0
    for a, b, m in ((kc.x, pc.x, finite), (kc.y, pc.y, finite),
                    (kc.zview, pc.zview, finite), (kfu, pfu, sel),
                    (kfv, pfv, sel)):
        r = ((a - b).abs() / b.abs().clamp(min=1.0))[m]
        rel = max(rel, float(r.max()) if r.numel() else 0.0)
    k_bad = int((((kks != pks) | (kkd != pkd) | (kc.valid != pc.valid))
                 & ~edge).sum())
    k_flips = int(((kks != pks) | (kkd != pkd)).sum())
    if rel > 1e-4 or k_bad:
        raise AssertionError(f"warp_lookup disagrees: rel {rel}, "
                             f"{k_bad} index mismatches off tile edges")
    n1 = G.shape[0] * G.shape[1] * h * w
    return dict(
        max_abs_err=max(max_err(kc.x, pc.x), max_err(kfu[sel], pfu[sel])),
        max_rel_err=rel, k_flips_at_edges=k_flips,
        ms=cuda_ms(lambda: R.warp_lookup(*k1_args), 20),
        plain_ms=cuda_ms(lambda: R.warp_lookup_plain(*k1_args), 5),
        bound=bound_ms(G.numel() * 4 + 2 * maps[0].numel() * 4 + n1 * 29,
                       n1 * 25))


def check_kernels(model, params, ext, intr, hw):
    """Phase 4: each kernel against its plain version at the main path's
    shapes (one fixed-view chunk of 10 frames).  Returns per-kernel
    records."""
    import torch
    from videoloop3d_torch.first_designs import composite_first
    from videoloop3d_torch.render import fused as FU
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    h, w = hw
    g = model.geom
    dev = model.device
    ts = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    G = R.homographies(g, torch.as_tensor(ext, device=dev),
                       torch.as_tensor(intr, device=dev)).contiguous()
    maps = (model.tile_map_static, model.tile_map_dyn)
    k1_args = (G, *maps, h, w, (g.mpi_h, g.mpi_w), g.tile_span)
    rec = {}

    rec["warp_lookup"] = check_warp_lookup(G, maps, h, w, g)
    kc, kks, kkd, kfu, kfv = R.warp_lookup(*k1_args)

    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        atlas_s = params["atlas"].to(dtype).contiguous()
        dyn = params["atlas_dyn"].to(dtype).contiguous()
        item = atlas_s.element_size()
        ths, tws = atlas_s.shape[1:3]
        th, tw = dyn.shape[1:3]
        C = dyn.shape[-1]

        # K2, 1e-6: identical f32 lerps of the same texels
        k2_args = (atlas_s, kks, kfu * (tws - 1), kfv * (ths - 1))
        vs, hs = S.bilinear_tiles(*k2_args)
        ps, _ = S.bilinear_tiles_plain(*k2_args)
        e2 = max_err(vs, ps)
        n2 = kks.numel()
        used = torch.unique(kks[kks >= 0]).numel()
        r2 = dict(max_abs_err=e2,
                  ms=cuda_ms(lambda: S.bilinear_tiles(*k2_args), 20),
                  plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(*k2_args),
                                   5),
                  bound=bound_ms(n2 * 12 + used * ths * tws * C * item
                                 + n2 * C * 4, n2 * (9 * C + 10)))

        # K3, 1e-6, at the chunk's frames read through ts
        k3_args = (dyn, kkd[0], kfu[0] * (tw - 1), kfv[0] * (th - 1), ts)
        vd, hd = S.bilinear_tiles_tilemajor(*k3_args)
        pd, _ = S.bilinear_tiles_tilemajor_plain(*k3_args)
        e3 = max_err(vd, pd)
        n3 = kkd[0].numel()
        used = torch.unique(kkd[kkd >= 0]).numel()
        r3 = dict(max_abs_err=e3,
                  ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor(*k3_args),
                             20),
                  plain_ms=cuda_ms(
                      lambda: S.bilinear_tiles_tilemajor_plain(*k3_args), 3),
                  bound=bound_ms(n3 * 12 + ts.numel() * 4
                                 + used * th * tw * CHUNK * C * item
                                 + n3 * CHUNK * C * 4,
                                 n3 * CHUNK * (9 * C + 10)))

        # K4, 1e-5: same operation order; exp may differ in the last ulp;
        # bit for bit its first design, timed beside it in turns
        valid0 = kc.valid[0]
        k4_args = (vs[0].contiguous(), valid0 & hs[0], vd, hd, valid0 & hd)
        out, asum = FU.composite(*k4_args)
        pout, pasum = FU.composite_plain(*k4_args)
        e4 = max(max_err(out, pout), max_err(asum, pasum))
        fout, fasum = composite_first(*k4_args)
        if not (torch.equal(out.view(torch.int32), fout.view(torch.int32))
                and torch.equal(asum.view(torch.int32),
                                fasum.view(torch.int32))):
            raise AssertionError(f"composite ({tag}) differs from its first "
                                 "design")
        del fout, fasum, pout, pasum
        n_hit = int(hd.sum())
        n_planes_px = hd.numel()
        P = h * w
        ms4, first4, turns4 = ms_in_turns(
            lambda: FU.composite(*k4_args),
            lambda: composite_first(*k4_args), 20)
        r4 = dict(max_abs_err=e4, equal_to_first_design=True,
                  first_design="csrc/composite.cu:vl3d_composite_first",
                  layout=FU.composite_layout(g.n_planes, CHUNK),
                  dynamic_share=n_hit / n_planes_px,
                  ms=ms4, first_design_ms=first4, ms_in_turns=turns4,
                  plain_ms=cuda_ms(lambda: FU.composite_plain(*k4_args), 3),
                  bound=bound_ms(n_hit * CHUNK * C * 4
                                 + (n_planes_px - n_hit) * C * 4
                                 + n_planes_px * 2 + P * CHUNK * 16,
                                 n_planes_px * CHUNK * 28))
        for name, r, tol in (("bilinear_tiles", r2, 1e-6),
                             ("bilinear_tiles_tilemajor", r3, 1e-6),
                             ("composite", r4, 1e-5)):
            if not r["max_abs_err"] <= tol:
                raise AssertionError(f"{name} ({tag}) disagrees with its "
                                     f"plain version: {r['max_abs_err']}")
            rec[f"{name}/{tag}"] = r
    # K2 as the render reads the static atlas under --fp16 (the main
    # path): the f32 atlas, each texel rounded to bf16 in registers; bit
    # for bit its samples of the bf16 copy, timed in turns beside K2 on
    # the copy
    bf16 = torch.bfloat16
    atlas = params["atlas"].detach().contiguous()
    ths, tws = atlas.shape[1:3]
    C = atlas.shape[-1]
    k2_args = (atlas, kks, kfu * (tws - 1), kfv * (ths - 1), bf16)
    vs, _ = S.bilinear_tiles(*k2_args)
    copy = atlas.to(bf16)
    vc, _ = S.bilinear_tiles(copy, *k2_args[1:4])
    if not torch.equal(vs.view(torch.int32), vc.view(torch.int32)):
        raise AssertionError("K2 on the f32 atlas gathered as bf16 differs "
                             "from K2 on the bf16 copy")
    n2 = kks.numel()
    used = torch.unique(kks[kks >= 0]).numel()
    k2_ms, k2_copy_ms, k2_turns = ms_in_turns(
        lambda: S.bilinear_tiles(*k2_args),
        lambda: S.bilinear_tiles(copy, *k2_args[1:4]), 20)
    rec["bilinear_tiles/f32 as bf16"] = dict(
        max_abs_err=max_err(vs, S.bilinear_tiles_plain(*k2_args)[0]),
        equal_to_bf16_copy=True, ms=k2_ms, bf16_copy_ms=k2_copy_ms,
        ms_in_turns=k2_turns,
        copy_ms=cuda_ms(lambda: atlas.to(bf16), 20),
        plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(*k2_args), 5),
        bound=bound_ms(n2 * 12 + used * ths * tws * C * 4 + n2 * C * 4,
                       n2 * (9 * C + 10)))
    del vs, vc, copy
    # K3 as the render reads the dynamic atlas under --fp16 (the main
    # path): the f32 atlas, each texel rounded to bf16 in registers; bit
    # for bit its samples of the bf16 copy
    dyn = params["atlas_dyn"].detach().contiguous()
    th, tw = dyn.shape[1:3]
    C = dyn.shape[-1]
    k3_args = (dyn, kkd[0], kfu[0] * (tw - 1), kfv[0] * (th - 1), ts, bf16)
    vd, _ = S.bilinear_tiles_tilemajor(*k3_args)
    copy = dyn.to(bf16)
    vc, _ = S.bilinear_tiles_tilemajor(copy, *k3_args[1:5])
    if not torch.equal(vd.view(torch.int32), vc.view(torch.int32)):
        raise AssertionError("K3 on the f32 atlas gathered as bf16 differs "
                             "from K3 on the bf16 copy")
    n3 = kkd[0].numel()
    used = torch.unique(kkd[kkd >= 0]).numel()
    EVAL_CHUNK_SAMPLES.update(k=kkd[0], u=k3_args[2], v=k3_args[3], ts=ts)
    rec["bilinear_tiles_tilemajor/f32 as bf16"] = dict(
        max_abs_err=max_err(vd, S.bilinear_tiles_tilemajor_plain(
            *k3_args)[0]), equal_to_bf16_copy=True,
        ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor(*k3_args), 20),
        copy_ms=cuda_ms(lambda: dyn.to(bf16), 20),
        plain_ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor_plain(*k3_args),
                         3),
        bound=bound_ms(n3 * 12 + ts.numel() * 4
                       + used * th * tw * CHUNK * C * 4 + n3 * CHUNK * C * 4,
                       n3 * CHUNK * (9 * C + 10)))
    del vd, vc, copy
    rec["composite/cases"] = check_composite_cases()
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound", (None, None))
        print(json.dumps({"kernel_check": name, **r, "bound_ms": b,
                          "bound_by": by}))
    return rec


# K4's redesign against its first design on random stacks: (planes,
# height, width, frames), the eval chunk's width at D = 1, 33 and 128, a
# spiral frame (F = 1) and the training frame count (F = 50)
COMPOSITE_CASES = {"d1": (1, 180, 320, 10), "d33": (33, 180, 320, 10),
                   "d128": (128, 90, 160, 10), "f1": (32, 360, 640, 1),
                   "f50": (32, 90, 160, 50)}


def composite_stacks(D, h, w, F, case, seed):
    """Random K4 inputs on the card: rgb-ish samples, masks, and for
    `case` every mask off ("all_masked"), every plane dynamic with NaN
    static samples that must never be read ("all_hit"), or non-finite
    masked-off samples ("nonfinite": NaN and infinities where the mask is
    0, so the first design's NaN * 0 reaches the outputs)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    f32 = dict(device=DEVICE, generator=g)
    vals_s = torch.randn((D, h, w, 4), **f32) * 2
    vals_d = torch.randn((D, h, w, F, 4), **f32) * 2
    m_s, hit_d, m_d = (torch.rand((D, h, w), **f32) < p
                       for p in (0.6, 0.1, 0.5))
    if case == "all_masked":
        m_s.zero_()
        m_d.zero_()
    elif case == "all_hit":
        hit_d.fill_(True)
        vals_s.fill_(float("nan"))
    elif case == "nonfinite":
        bad = torch.tensor([float("nan"), float("inf"), float("-inf")],
                           device=DEVICE)
        pick = torch.rand((D, h, w), **f32) < 0.3
        sel = pick & ~m_s
        vals_s[sel] = bad[torch.randint(0, 3, (int(sel.sum()), 4), **f32)]
        dsel = pick & hit_d & ~m_d
        vals_d[dsel] = bad[torch.randint(0, 3, (int(dsel.sum()), F, 4),
                                         **f32)]
    return vals_s, m_s, vals_d, hit_d, m_d


def check_composite_cases():
    """Phase 4 (b): K4 bit for bit its first design and within 1e-5 of its
    plain version (NaNs where the plain version has them) on random stacks
    of COMPOSITE_CASES, all masked, all hit and with non-finite
    masked-off samples; K4's layout against the kernel's.  Returns the
    record (the worst error, the cases, the layouts)."""
    import torch
    from videoloop3d_torch.first_designs import composite_first
    from videoloop3d_torch.render import fused as FU

    worst, n = 0.0, 0
    layouts = {}
    for i, (tag, (D, h, w, F)) in enumerate(COMPOSITE_CASES.items()):
        layouts[tag] = FU.composite_layout(D, F)
        if FU.kernel_composite_layout(D, F) != layouts[tag]:
            raise AssertionError(f"composite_layout ({tag}) differs from the "
                                 "kernel's")
        for case in ("random", "all_masked", "all_hit", "nonfinite"):
            ins = composite_stacks(D, h, w, F, case, seed=i)
            got = FU.composite(*ins)
            first = composite_first(*ins)
            plain = FU.composite_plain(*ins)
            for a, b, c in zip(got, first, plain):
                nan = torch.isnan(c)
                if not (torch.equal(a.view(torch.int32), b.view(torch.int32))
                        and torch.equal(torch.isnan(a), nan)):
                    raise AssertionError(f"composite ({tag}, {case}) differs "
                                         "from its first design or in NaNs")
                err = max_err(a[~nan], c[~nan])
                if not err <= 1e-5:
                    raise AssertionError(f"composite ({tag}, {case}) "
                                         f"disagrees with its plain version: "
                                         f"{err}")
                worst = max(worst, err)
            n += 1
            del ins, got, first, plain
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "equal_to_first_design": True,
            "stacks": n, "cases": COMPOSITE_CASES, "layouts": layouts}


def render_ms_in_turns(model, params, hw, ext, intr, sp_ext, sp_intr, frm):
    """Phase 5 (b): render ms/frame (host clock around `render_eval`, as
    `drive` takes it) of the fixed view (all frames in chunks of 10) and
    the 10-pose spiral (one frame a call) with K4's first design in the
    model's place and with the redesign, in turns: first, redesign,
    redesign, first; the frames of both designs equal."""
    from videoloop3d_torch.first_designs import composite_first
    from videoloop3d_torch.models import mpv
    from videoloop3d_torch.train.stage2 import render_eval

    H, W = hw
    shipped = mpv.composite

    def fixed():
        return render_eval(model, params, H, W, ext, intr, np.arange(frm),
                           chunk=CHUNK, u8=True)

    def spiral():
        return np.concatenate([render_eval(
            model, params, H, W, sp_ext[i:i + 1], sp_intr[i:i + 1],
            [i % frm], chunk=1, u8=True) for i in range(len(sp_ext))])

    out = {"first_design": [], "redesign": []}
    frames = {}
    for key in ("first_design", "redesign", "redesign", "first_design"):
        mpv.composite = composite_first if key == "first_design" else shipped
        try:
            row = {}
            for view, fn in (("fixed", fixed), ("spiral", spiral)):
                fn()
                t = time.perf_counter()
                f = fn()
                row[f"{view}_ms_per_frame"] = (time.perf_counter() - t) \
                    * 1e3 / len(f)
                frames.setdefault((key, view), f)
        finally:
            mpv.composite = shipped
        out[key].append(row)
    for view in ("fixed", "spiral"):
        if not np.array_equal(frames[("first_design", view)],
                              frames[("redesign", view)]):
            raise AssertionError(f"{view} render differs between K4's "
                                 "designs")
    return out


def drive(argv):
    """Run render_video.main with the launch counters set to 0 just before
    and read just after; returns (frames, counts, render seconds, wall
    seconds)."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.tools import render_video
    from videoloop3d_torch.train import stage2

    inner = stage2.render_eval
    spent = [0.0]

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)           # returns host numpy: synchronized
        spent[0] += time.perf_counter() - t
        return out

    stage2.render_eval = timed
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        frames = render_video.main(argv)
        wall = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    finally:
        stage2.render_eval = inner
    return np.stack(frames), counts, spent[0], wall


def profile_render(model, params, hw, ext, intr, ts, chunk):
    """Device busy share and the largest device entries (kernels and
    copies, each counted once) of one warm `render_eval` call
    (torch.profiler, CPU + CUDA activities)."""
    import torch
    from videoloop3d_torch.train.stage2 import render_eval

    H, W = hw

    def call():
        return render_eval(model, params, H, W, ext, intr, ts, chunk=chunk,
                           u8=True)

    call()
    torch.cuda.synchronize()
    by_name, wall_ms = profiled(call)
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "top": [{"name": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in rows[:10]]}


def profiled(call, tries=3):
    """torch.profiler (CPU + CUDA activities) over one call(), which ends
    with the device idle: (device_entries, host-clock ms).  A trace that
    recorded no device event (the profiler now and then drops a cycle's
    events) is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            call()
            wall_ms = (time.perf_counter() - t) * 1e3
        by_name = device_entries(prof)
        if by_name:
            break
    return by_name, wall_ms


def device_entries(prof):
    """{name: (device ms, calls)} of the kernels and copies of a
    torch.profiler run, each counted once.  User annotations on the
    device timeline (such as "Optimizer.step#Adam.step") span other
    entries and are left out."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return by_name


# K27's kernels: the redesign's load and upsweep, digit scan and ranking
# pass; the first design's load, histogram, scan and scatter
MASK_SORT_KERNELS = ("sort_load_count_kernel", "digit_scan_kernel",
                     "rank_pass_kernel",
                     "sort_load_kernel", "sort_hist_kernel",
                     "sort_scan_kernel", "sort_scatter_kernel")
# the calls of K28 phase 41 held against its first design, by route
MASK_L1_ROUTE_COUNTS = {"block": 0, "global": 0}
# K7's kernels: the redesign's tile and tree kernels (the tree's last
# block reduces the partials), the first design's kernel and reduction
K7_KERNELS = ("fused_s1_fwd_tile_kernel", "fused_s1_tree_kernel",
              "fused_s1_fwd_kernel", "fused_s1_reduce_kernel")
# K28's kernels: the redesign's block route and its global route's two
# kernels, the first design's sign scatter and gradient, and the loss both
# end with
MASK_L1_KERNELS = ("mask_l1_bits_kernel", "mask_l1_set_kernel",
                   "mask_l1_grad_kernel", "mask_l1_kernel",
                   "mask_grad_kernel", "mask_loss_kernel")
# PyTorch's copies and casts (direct_copy_kernel_cuda, the bf16 casts'
# copy kernels) and fills (FillFunctor: torch.zeros)
COPY_KERNELS = ("copy_kernel", "FillFunctor", "Memset", "Memcpy")
# K16/K17's kernels: the redesigns, their bins' sort, the first designs;
# and the copies, casts and fills the redesigns took the place of
DENSE_PROFILE_GROUPS = ("planes_", "bin_", "bilinear_planes",
                        "copy, cast and fill")
PORT_KERNELS = ("warp_lookup_kernel", "bilinear_tiles_kernel",
                # K9: its zero fill, the vector-atomic scatter, its
                # rounding pass, its first design
                "zero_grad_kernel", "bilinear_tiles_grad_kernel",
                "round_bf16_kernel", "bilinear_tiles_grad_first_kernel",
                "bilinear_tiles_tilemajor_kernel",
                "bilinear_tiles_tilemajor_grad_kernel",
                # K3 at C != 4 redesigned, K23 redesigned at C = 4
                "bilinear_tiles_tilemajor_sweep_kernel",
                "coord_grad_c4_kernel",
                # K11 on f32 (and its ssim mode) and K18:
                # nn_tile_search_kernel<kMode, ra, rb>, their first designs
                # nn_search_first_kernel<T, kMode>; K11 on bf16:
                # nn_mma_kernel
                "nn_tile_search_kernel", "nn_search_first_kernel",
                "nn_mma_kernel", "nn_fold_kernel", "nn_fold_tile_kernel",
                # K4 redesigned and its first design
                "composite_tile_kernel", "composite_first_kernel",
                "sample_dense_kernel",
                "sample_dense_grad_kernel", "fused_s1_fwd_kernel",
                "fused_s1_reduce_kernel", "fused_s1_bwd_kernel",
                # K8 redesigned, K2 at C != 4 redesigned
                "fused_s1_bwd_tile_kernel", "bilinear_tiles_sweep_kernel",
                # K13 redesigned and its first design
                "compact_bits_kernel", "compact_sweep_kernel",
                "fused_s2_fwd_kernel",
                "fused_s2_reduce_kernel", "fused_s2_bwd_kernel",
                "fused_s2_bwd_tile_kernel",
                # K14 redesigned: the tile kernel and the first design's
                # reduction of its sums
                "fused_s2_fwd_tile_kernel", "fused_s2_sums_kernel",
                # K10 redesigned (and K9 at C != 4): its bins' keys, the
                # tiles' counts, the zero fill (K9's by rows), the gather
                # (the sort: bin_*_kernel below)
                "tiles_key_kernel", "tiles_count_kernel", "tiles_zero_kernel",
                "tiles_zero_rows_kernel", "tiles_grad_gather_kernel",
                "bilinear_planes_tilemajor_kernel",
                "bilinear_planes_tilemajor_grad_kernel",
                # K16/K17 redesigned: the sweep, the bins' key, radix
                # sort and offsets, the gather
                "planes_sweep_kernel", "bin_key_kernel", "bin_hist_kernel",
                "bin_scan_kernel", "bin_scatter_kernel", "bin_offsets_kernel",
                "planes_grad_gather_kernel",
                # K19 redesigned, its first design, their crop sums
                "nn_band_err_unit_kernel", "nn_band_err_kernel",
                "crop_sums_kernel",
                # K20 redesigned and its first design (and its global
                # route's call), K21 redesigned (the tile pass, the sum
                # pass) and its first design
                "geo_window_kernel", "geo_fwd_tile_kernel",
                "geo_warp_fwd_first_kernel", "geo_bwd_tile_kernel",
                "geo_bwd_sum_kernel", "geo_warp_bwd_first_kernel",
                "sample_dense_coord_grad_kernel",
                # K22 at C != 4 redesigned
                "coord_grad_staged_kernel",
                "bilinear_tiles_coord_grad_kernel",
                "tile_lookup_coords_kernel",
                # K24 and K26's first pass: swd_tile_gemm_kernel<true>,
                # <false>; K26's fold: swd_fold_t_kernel; their first
                # designs: swd_gemm_first_kernel, swd_fold_first_kernel
                "swd_tile_gemm_kernel", "swd_gemm_first_kernel",
                # K25 redesigned (n <= 64, longer columns) and its first
                # design
                "swd_sort_net_kernel", "swd_sort_smem_kernel",
                "swd_sort_l1_first_kernel", "swd_sum_kernel",
                "swd_fold_t_kernel",
                "swd_fold_first_kernel",
                # K5 at C != 4 (its first design: sample_dense_c_kernel)
                "sample_dense_block_kernel", "sample_dense_c_kernel",
                "sample_dense_grad_c_kernel") + MASK_SORT_KERNELS \
    + MASK_L1_KERNELS + ("fused_s1_fwd_tile_kernel", "fused_s1_tree_kernel")


def device_groups(by_name, copies=False):
    """{group: {device_ms, calls, share}} of device_entries' result: each
    port kernel by its CUDA function name, Adam's multi_tensor_apply
    passes, with `copies` PyTorch's copies, casts and fills, and everything
    else; share of all device time."""
    total = sum(ms for ms, _ in by_name.values())
    groups = {}
    for name, (ms, n) in by_name.items():
        key = next((k for k in PORT_KERNELS
                    if k + "(" in name or k + "<" in name), None)
        if key is None:
            key = "adam multi_tensor_apply" if "multi_tensor_apply" in name \
                else "other"
            if copies and key == "other" and any(
                    c in name for c in COPY_KERNELS):
                key = "copy, cast and fill"
        g = groups.setdefault(key, {"device_ms": 0.0, "calls": 0})
        g["device_ms"] += ms
        g["calls"] += n
    for g in groups.values():
        g["share"] = g["device_ms"] / total
    return groups


def u8_close(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
    return float((diff > 1).mean())


def s1_args(extra=()):
    """The shipped stage-1 configuration at factor 1 (the port's parser)."""
    from videoloop3d_torch.config import parse_args_with_configs
    return parse_args_with_configs(
        ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
         "--factor", "1", *extra])


def s1_setup(route, seed=0):
    """An MPMesh at the shipped width on the card with its initial
    parameters, and one batch as the trainer feeds it: a 180x320 patch at
    the centre of a 360x640 view, 0.05 to the side of the reference
    camera (the geometry of bench.py:run_stage1_bench)."""
    import torch
    from videoloop3d_torch.models.mpmesh import MPMesh

    args = s1_args(S1_ROUTES[route])
    H, W = S1_HW
    ph, pw = S1_PATCH
    focal = 0.9 * W
    intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                      np.float32)
    model = MPMesh(args, H, W, np.eye(4, dtype=np.float32), intrin, 2.0,
                   10.0, device=DEVICE)
    params = model.init_params(1)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[:, 0, 3] = 0.05
    pi = intrin.copy()
    pi[0, 2] -= (W - pw) / 2
    pi[1, 2] -= (H - ph) / 2
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    batch = {"extrin": torch.as_tensor(ext, device=DEVICE),
             "intrin": torch.as_tensor(pi[None], device=DEVICE),
             "rgb": torch.rand((1, ph, pw, 3), generator=gen, device=DEVICE),
             "loopmask": (torch.rand((1, ph, pw), generator=gen,
                                     device=DEVICE) < 0.3).float()}
    return args, model, params, batch


def s1_kernel_inputs():
    """Production-shape inputs of K5-K8: the warp of the s1_setup patch
    onto the 32 planes, a random 576x1024 atlas and mask atlas, and
    random cotangents (seeded on the card)."""
    import torch
    from videoloop3d_torch.render import renderer as R

    args, model, params, batch = s1_setup("shipped")
    g = model.geom
    ref_inv = torch.as_tensor(np.linalg.inv(g.ref_extrin_np()), device=DEVICE)
    coords = R.warp_coordinates(g, batch["extrin"] @ ref_inv[None],
                                batch["intrin"], *S1_PATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    atlas = torch.randn((D, Ht, Wt, 4), generator=gen, device=DEVICE)
    mask = torch.randn((D, Ht, Wt, 1), generator=gen, device=DEVICE)
    x, y = coords.x.contiguous(), coords.y.contiguous()
    shape = x.shape
    cot = torch.randn(shape + (4,), generator=gen, device=DEVICE)
    cot_m = torch.randn(shape + (1,), generator=gen, device=DEVICE)
    return args, g, coords, atlas, mask, x, y, cot, cot_m


def sample_dense_grad_first(g, g_mask, x, y, atlas_shape, mask_shape=None):
    """K6's first design at C = 4 (four scalar atomics a corner,
    csrc/sample_dense.cu:vl3d_sample_dense_grad_scalar), with
    `S.sample_dense_grad`'s arguments, zero fill and results.  Not
    counted: no path of the port calls it."""
    import torch
    from videoloop3d_torch import kernels

    B, D, h, w = x.shape
    _, Ht, Wt, _ = atlas_shape
    g_atlas = torch.zeros(atlas_shape, device=x.device)
    g_m = None if g_mask is None else torch.zeros(mask_shape, device=x.device)
    err = kernels.library().vl3d_sample_dense_grad_scalar(
        g.data_ptr(), None if g_mask is None else g_mask.data_ptr(),
        x.data_ptr(), y.data_ptr(), B, D, h * w, Ht, Wt, g_atlas.data_ptr(),
        None if g_m is None else g_m.data_ptr(), kernels.stream_ptr(x.device))
    kernels.check_launch("sample_dense_grad (first design)", err)
    return g_atlas, g_m


def sample_dense_grad_window(g, g_mask, x, y, atlas_shape, mask_shape,
                             window):
    """K6 with shared-memory accumulation in windows of `window` texels
    (csrc/sample_dense.cu:vl3d_sample_dense_grad_window, measured slower
    than the redesign), with `S.sample_dense_grad`'s arguments, zero fill
    and results, and the number of 32 x 8 pixel tiles whose texel box
    exceeded the window (added straight to global memory).  Not counted:
    no path of the port calls it."""
    import torch
    from videoloop3d_torch import kernels

    B, D, h, w = x.shape
    _, Ht, Wt, _ = atlas_shape
    g_atlas = torch.zeros(atlas_shape, device=x.device)
    g_m = torch.zeros(mask_shape, device=x.device)
    over = torch.zeros((), dtype=torch.int32, device=x.device)
    err = kernels.library().vl3d_sample_dense_grad_window(
        g.data_ptr(), g_mask.data_ptr(), x.data_ptr(), y.data_ptr(), B, D, h,
        w, Ht, Wt, window, g_atlas.data_ptr(), g_m.data_ptr(),
        over.data_ptr(), kernels.stream_ptr(x.device))
    kernels.check_launch("sample_dense_grad (window)", err)
    return g_atlas, g_m, over


def sass_atomics(source, kernel_names):
    """The atomic and reduction instructions (full opcodes) of each named
    kernel in the compiled object of `source` (cuobjdump -sass of
    build/torch_kernels/<source>.o): {kernel: {opcode: count}}."""
    import re
    from videoloop3d_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    obj = os.path.join(kernels.BUILD_DIR, source + ".o")
    out = subprocess.run([tool, "-sass", obj], capture_output=True,
                         text=True, check=True).stdout
    counts, cur = {k: {} for k in kernel_names}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((k for k in kernel_names
                        if re.search(k + r"(IL|E|$)", m.group(1))), None)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"((?:ATOM[SG]?|REDG?)(?:\.[A-Za-z0-9_.]+)?)\s", line)
        if cur and m:
            counts[cur][m.group(1)] = counts[cur].get(m.group(1), 0) + 1
    if not all(counts.values()):
        raise AssertionError(f"sass_atomics: no atomics found in {counts}")
    return counts


def sass_loop_mix(source, kernel):
    """The instruction mix of the hot inner loop of one kernel in the
    compiled object of `source` (cuobjdump -sass): of the backward
    branches whose body holds at least 32 FFMA, the one with the largest
    FFMA share (an outer loop around it holds its FFMA and more), its
    opcodes (first token, predicate dropped) counted.  Returns
    {"instructions": n, opcode: count}."""
    import re
    from collections import Counter
    from videoloop3d_torch import kernels

    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    obj = os.path.join(kernels.BUILD_DIR, source + ".o")
    out = subprocess.run([tool, "-sass", obj], capture_output=True,
                         text=True, check=True).stdout
    code, cur = [], False
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.search(kernel, m.group(1)) is not None
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)"
                     r"([^;]*);", line)
        if cur and m:
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best = None
    for addr, op, rest in code:
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and t and int(t.group(1), 16) < addr:
            body = [o for a, o, _ in code if int(t.group(1), 16) <= a <= addr]
            share = body.count("FFMA") / len(body)
            if body.count("FFMA") >= 32 and (
                    best is None or share > best.count("FFMA") / len(best)):
                best = body
    if not best:
        raise AssertionError(f"sass_loop_mix: no loop in {kernel}")
    return {"instructions": len(best), **dict(Counter(best).most_common(8))}


def check_s1_kernels():
    """Phase 8: K5-K8 against their plain versions on the card at the
    shipped stage-1 shapes, with CUDA-event times, bounds and, for K5/K6,
    grid_sample as the library yardstick; K7 and K8 (redesigned) also bit
    for bit against their first designs (K7 on its eight outputs, the
    same bits twice) and timed beside them in turns, at the shipped flags
    and with every flag on, and their layouts against the kernel's."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.first_designs import (fused_s1_bwd_first,
                                                  fused_s1_fwd_first)
    from videoloop3d_torch.render import fused_s1 as F1
    from videoloop3d_torch.render import sample as S

    args, g, coords, atlas, mask, x, y, cot, cot_m = s1_kernel_inputs()
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    n = x.numel()
    rec = {}

    # K5: bit-exact (same lerps, one rounding per operation)
    feats, mfeats = S.sample_dense_fwd(atlas, mask, x, y)
    e5 = max(max_err(feats, S.bilinear_planes_plain(atlas, x, y)),
             max_err(mfeats, S.bilinear_planes_plain(mask, x, y)))
    # texels the samples touch (each read once in the bound)
    x0 = torch.floor(x).clamp(-2, Wt).long()
    y0 = torch.floor(y).clamp(-2, Ht).long()
    dd = torch.arange(D, device=DEVICE).view(1, D, 1, 1)
    idx = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
        idx.append(((dd * Ht + yi) * Wt + xi)[inside])
    touched = torch.unique(torch.cat(idx)).numel()
    # grid_sample on (D, 5, Ht, Wt) with normalized grids; the layout
    # change is done once here and not timed
    tex = torch.cat([atlas, mask], -1).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x[0] / (Wt - 1) * 2 - 1, y[0] / (Ht - 1) * 2 - 1],
                       -1).contiguous()

    def gs(t):
        return TF.grid_sample(t, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True)

    ref5 = gs(tex).permute(0, 2, 3, 1)[None]
    gs_err = max_err(torch.cat([feats, mfeats], -1), ref5)
    rec["sample_dense"] = dict(
        max_abs_err=e5, grid_sample_max_abs_diff=gs_err,
        ms=cuda_ms(lambda: S.sample_dense_fwd(atlas, mask, x, y), 20),
        plain_ms=cuda_ms(lambda: (S.bilinear_planes_plain(atlas, x, y),
                                  S.bilinear_planes_plain(mask, x, y)), 5),
        library_ms=cuda_ms(lambda: gs(tex), 20),
        bound=bound_ms(n * 8 + touched * 20 + n * 20, n * 55))

    # K6: atomics add in no fixed order -> 1e-5 relative to max|g|
    ga, gm = S.sample_dense_grad(cot, cot_m, x, y, atlas.shape, mask.shape)
    pa = S.bilinear_planes_grad_plain(cot, x, y, atlas.shape)
    pm = S.bilinear_planes_grad_plain(cot_m, x, y, mask.shape)
    e6 = max(max_err(ga, pa) / float(pa.abs().max()),
             max_err(gm, pm) / float(pm.abs().max()))
    tex_g = tex.clone().requires_grad_(True)
    out_g = gs(tex_g)
    cot_gs = torch.cat([cot, cot_m], -1)[0].permute(0, 3, 1, 2).contiguous()
    rec["sample_dense_grad"] = dict(
        max_abs_err=max(max_err(ga, pa), max_err(gm, pm)), max_rel_err=e6,
        ms=cuda_ms(lambda: S.sample_dense_grad(cot, cot_m, x, y, atlas.shape,
                                               mask.shape), 20),
        plain_ms=cuda_ms(lambda: (
            S.bilinear_planes_grad_plain(cot, x, y, atlas.shape),
            S.bilinear_planes_grad_plain(cot_m, x, y, mask.shape)), 3),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            out_g, tex_g, cot_gs, retain_graph=True), 20),
        bound=bound_ms(D * Ht * Wt * 20 + n * 20 + n * 8, n * 45))
    # the first design (four scalar atomics a corner) on the same inputs,
    # and the redesign where a warp's samples spread across the plane (the
    # pixels of every other plane permuted at random)
    mshape = mask.shape
    fa, fm = sample_dense_grad_first(cot, cot_m, x, y, atlas.shape, mshape)
    e_first = max(max_err(fa, pa) / float(pa.abs().max()),
                  max_err(fm, pm) / float(pm.abs().max()))
    del fa, fm
    perm = torch.randperm(x[0, 0].numel(),
                          generator=torch.Generator().manual_seed(3))
    xs, ys = x.clone(), y.clone()
    for t, src in ((xs, x), (ys, y)):
        t[:, ::2] = src[:, ::2].flatten(2)[..., perm.to(DEVICE)].view_as(
            src[:, ::2])
    sa, sm = S.sample_dense_grad(cot, cot_m, xs, ys, atlas.shape, mshape)
    spa = S.bilinear_planes_grad_plain(cot, xs, ys, atlas.shape)
    spm = S.bilinear_planes_grad_plain(cot_m, xs, ys, mshape)
    e_spread = max(max_err(sa, spa) / float(spa.abs().max()),
                   max_err(sm, spm) / float(spm.abs().max()))
    if not max(e_first, e_spread) <= 1e-5:
        raise AssertionError(f"K6: first design {e_first}, spread samples "
                             f"{e_spread} of max|g|")
    rec["sample_dense_grad"].update(
        first_design="csrc/sample_dense.cu:vl3d_sample_dense_grad_scalar",
        first_design_max_rel_err=e_first,
        first_design_ms=cuda_ms(lambda: sample_dense_grad_first(
            cot, cot_m, x, y, atlas.shape, mshape), 20),
        zero_fill_ms=cuda_ms(lambda: (
            torch.zeros(atlas.shape, device=DEVICE),
            torch.zeros(mshape, device=DEVICE)), 20),
        spread_max_rel_err=e_spread,
        spread_ms=cuda_ms(lambda: S.sample_dense_grad(
            cot, cot_m, xs, ys, atlas.shape, mshape), 20))
    # shared-memory accumulation (measured slower, not on the port's
    # path) at four windows, on the shipped and the spread samples, held
    # like the redesign; the spread tiles' boxes exceed the window and
    # take the kernel's global branch
    trial = {}
    for win in (256, 512, 1024, 2048):
        for tag, xa, ya, ra, rm in (("", x, y, pa, pm),
                                    ("spread_", xs, ys, spa, spm)):
            wa, wm, over = sample_dense_grad_window(cot, cot_m, xa, ya,
                                                    atlas.shape, mshape, win)
            e = max(max_err(wa, ra) / float(ra.abs().max()),
                    max_err(wm, rm) / float(rm.abs().max()))
            if not e <= 1e-5:
                raise AssertionError(f"K6 window {win} {tag}: {e} of max|g|")
            trial[f"{tag}{win}"] = dict(
                max_rel_err=e, tiles_over_window=int(over),
                ms=cuda_ms(lambda: sample_dense_grad_window(
                    cot, cot_m, xa, ya, atlas.shape, mshape, win), 20))
            del wa, wm
    rec["sample_dense_grad"].update(
        window_design="csrc/sample_dense.cu:vl3d_sample_dense_grad_window",
        window_tiles=((x.shape[3] + 31) // 32) * ((x.shape[2] + 7) // 8)
        * x.shape[0] * x.shape[1],
        window_trial=trial,
        sass_atomics=sass_atomics("sample_dense", (
            "sample_dense_grad_kernelILb1", "sample_dense_grad_kernelILb0",
            "sample_dense_grad_window_kernel")))
    del pa, pm, ga, gm, tex_g, out_g, sa, sm, spa, spm

    # K7 / K8 at the flags of the shipped --fused_render step, and with
    # every flag on (checked, not timed)
    valid = coords.valid.contiguous()
    mf = mfeats[..., 0].contiguous()
    dinv = torch.rand(x.shape, device=DEVICE) * valid
    P = S1_PATCH[0] * S1_PATCH[1]
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    cts = [torch.randn(s, generator=gen, device=DEVICE)
           for s in ((1,) + S1_PATCH + (3,), (1,) + S1_PATCH,
                     (1,) + S1_PATCH, (1,) + S1_PATCH + (1,), (4,))]
    shipped = F1.FusedS1Cfg(D, args.sparsity_loss_weight > 0,
                            args.rgb_smooth_loss_weight > 0,
                            args.a_smooth_loss_weight > 0, False, True,
                            False)
    all_on = F1.FusedS1Cfg(D, True, True, True, True, True, True)
    k7_first, k8_first = {}, {}
    for cfg in (all_on, shipped):
        dv = dinv if cfg.want_disp else None
        k7 = F1.fused_s1_fwd(cfg, feats, valid, mf, dv)
        p7 = F1.fused_composite_s1_plain_fwd(cfg, feats, valid, mf, dv)
        e7 = max(max_err(a, b) for a, b in zip(k7[:4], p7[:4]))
        r7 = float(((k7[4] - p7[4]).abs() / p7[4].abs().clamp(min=1e-30))
                   .max())
        # K7 (redesigned) bit for bit its first design on all eight
        # outputs (out, asum, disp, label and the four scalars), twice
        f7 = fused_s1_fwd_first(cfg, feats, valid, mf, dv)
        k7b = F1.fused_s1_fwd(cfg, feats, valid, mf, dv)
        same7 = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    and torch.equal(a.view(torch.int32), c.view(torch.int32))
                    for a, b, c in zip(k7, f7, k7b))
        k7_first[cfg == shipped] = same7
        del f7, k7b
        if not same7:
            raise AssertionError(f"K7 differs from its first design ({cfg})")
        k8 = F1.fused_s1_bwd(cfg, feats, valid, mf, dv, *cts)
        p8 = F1.fused_composite_s1_plain_bwd(cfg, feats, valid, mf, dv, *cts)
        e8 = max(max_err(a, b) / float(b.abs().max())
                 for a, b in zip(k8, p8) if b is not None)
        # K8 (redesigned) bit for bit its first design
        f8 = fused_s1_bwd_first(cfg, feats, valid, mf, dv, *cts)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k8, f8) if a is not None)
        k8_first[cfg == shipped] = same
        if not (e7 <= 1e-5 and r7 <= 1e-5 and e8 <= 1e-5 and same):
            raise AssertionError(f"fused_s1 kernels disagree ({cfg}): "
                                 f"{e7} {r7} {e8}, first design equal "
                                 f"{same}")
        del f8
    reads = n * (16 + 1 + 4)
    # K7 and its first design in turns, at the shipped flags and with
    # every flag on (the all-on bound reads the disparity too)
    ms7, first7, turns7 = ms_in_turns(
        lambda: F1.fused_s1_fwd(shipped, feats, valid, mf, None),
        lambda: fused_s1_fwd_first(shipped, feats, valid, mf, None), 20)
    ms7a, first7a, turns7a = ms_in_turns(
        lambda: F1.fused_s1_fwd(all_on, feats, valid, mf, dinv),
        lambda: fused_s1_fwd_first(all_on, feats, valid, mf, dinv), 20)
    layout7 = F1.fused_s1_fwd_layout(D)
    if F1.kernel_fused_s1_fwd_layout(D) != layout7:
        raise AssertionError(f"K7's layout: {layout7} against the kernel's "
                             f"{F1.kernel_fused_s1_fwd_layout(D)}")
    rec["fused_s1_fwd"] = dict(
        max_abs_err=e7, regs_max_rel_err=r7, ms=ms7,
        first_design="csrc/fused_s1.cu:vl3d_fused_s1_fwd_first",
        first_design_ms=first7, ms_in_turns=turns7,
        equal_first_design={"shipped": k7_first[True],
                            "all_on": k7_first[False]},
        all_on={"ms": ms7a, "first_design_ms": first7a,
                "ms_in_turns": turns7a,
                "bound_ms": bound_ms(reads + n * 4 + P * 24 + 16,
                                     n * 80)[0]},
        layout=layout7,
        plain_ms=cuda_ms(lambda: F1.fused_composite_s1_plain_fwd(
            shipped, feats, valid, mf, None), 3),
        library_ms=None,
        bound=bound_ms(reads + P * 24 + 16, n * 80))
    # K8 and its first design in turns, at the shipped flags and with
    # every flag on (the all-on bound reads the disparity too)
    ms8, first8, turns8 = ms_in_turns(
        lambda: F1.fused_s1_bwd(shipped, feats, valid, mf, None, *cts),
        lambda: fused_s1_bwd_first(shipped, feats, valid, mf, None, *cts),
        20)
    ms8a, first8a, turns8a = ms_in_turns(
        lambda: F1.fused_s1_bwd(all_on, feats, valid, mf, dinv, *cts),
        lambda: fused_s1_bwd_first(all_on, feats, valid, mf, dinv, *cts), 20)
    layout = F1.fused_s1_bwd_layout(D)
    if F1.kernel_fused_s1_bwd_layout(D) != layout:
        raise AssertionError(f"K8's layout: {layout} against the kernel's "
                             f"{F1.kernel_fused_s1_bwd_layout(D)}")
    rec["fused_s1_bwd"] = dict(
        max_abs_err=max(max_err(a, b) for a, b in zip(k8, p8)),
        max_rel_err=e8, ms=ms8,
        first_design="csrc/fused_s1.cu:vl3d_fused_s1_bwd_first",
        first_design_ms=first8, ms_in_turns=turns8,
        equal_first_design={"shipped": k8_first[True],
                            "all_on": k8_first[False]},
        all_on={"ms": ms8a, "first_design_ms": first8a,
                "ms_in_turns": turns8a,
                "bound_ms": bound_ms(reads + n * 4 + P * 24 + 16 + n * 20,
                                     n * 200)[0]},
        layout=layout,
        plain_ms=cuda_ms(lambda: F1.fused_composite_s1_plain_bwd(
            shipped, feats, valid, mf, None, *cts), 3),
        library_ms=None,
        bound=bound_ms(reads + P * 24 + 16 + n * 20, n * 150))
    for name, tol in (("sample_dense", 0.0), ("sample_dense_grad", 1e-5)):
        r = rec[name]
        err = r["max_abs_err"] if name == "sample_dense" else r["max_rel_err"]
        if not err <= tol:
            raise AssertionError(f"{name} disagrees with its plain version: "
                                 f"{err}")
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": name, **r, "bound_ms": b,
                          "bound_by": by}), flush=True)
    return rec


def s1_scene():
    """A 360x640 synthetic LLFF scene, 3 views x 12 frames, as .npy."""
    from videoloop3d_torch.data import synthetic

    scene_dir = os.path.join(WORK, "s1_scene")
    scene = synthetic.make_scene(n_views=3, h=S1_HW[0], w=S1_HW[1],
                                 n_frames=12, seed=0)
    synthetic.write_llff_dir(scene, scene_dir, factor=1)
    return scene_dir


def run_train(argv, tool=None):
    """tool.main (train_3d by default) with the launch counters set to 0
    just before and read just after, its standard output echoed.  Returns
    (counts, metrics.jsonl rows, rundir, wall seconds, output text)."""
    import contextlib
    import io
    from videoloop3d_torch import kernels
    from videoloop3d_torch.tools import train_3d

    tool = tool or train_3d
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            _, _, rundir = tool.main(argv)
    finally:
        print(buf.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return counts, rows, rundir, wall, buf.getvalue()


def drive_train(scene_dir, route):
    """Phase 9: train_3d.main with the launch counters set to 0 just
    before and read just after.  Returns (counts, metrics.jsonl rows,
    rundir, wall seconds)."""
    argv = ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
            "--factor", "1", "--N_iters", "2", "--i_video", "1000",
            "--datadir", scene_dir, "--expdir", os.path.join(WORK, "s1_runs"),
            "--expname", route, *S1_ROUTES[route]]
    return run_train(argv)[:4]


def check_train(route, counts, rows, rundir):
    """The trainer run's launches, loss, PSNR and checkpoint."""
    need = ["sample_dense", "sample_dense_grad"]
    if route == "fused":
        need += ["fused_s1_fwd", "fused_s1_bwd"]
    idle = [k for k in need if counts[k] == 0]
    if idle:
        raise AssertionError(f"stage-1 {route} run never launched {idle}")
    loss = [r["value"] for r in rows if r["tag"] == "stage1/loss"]
    psnr = [r["value"] for r in rows if r["tag"] == "stage1/psnr"]
    if not loss or not all(np.isfinite(loss)):
        raise AssertionError(f"stage-1 {route} loss not finite: {loss}")
    if len(psnr) < 2 or not psnr[-1] > psnr[0]:
        raise AssertionError(f"stage-1 {route} PSNR did not rise: {psnr}")
    if not os.path.isfile(os.path.join(rundir, "ckpt_epoch_0001.npz")):
        raise AssertionError(f"stage-1 {route} wrote no checkpoint")
    steps = max(r["step"] for r in rows if r["tag"] == "stage1/loss") + 1
    warm = [r["value"] for r in rows if r["tag"] == "stage1/warm_step_ms"]
    return {"steps": counts["sample_dense"], "logged_steps": steps,
            "warm_ms_per_step": warm[-1], "loss": loss, "psnr": psnr}


def make_plain_fused_s1():
    """render.fused_s1.fused_composite_s1 made of the plain forward and
    backward, for the plain composition of a step (phase 10)."""
    import torch
    from videoloop3d_torch.render import fused_s1 as F1

    class PlainFusedS1(torch.autograd.Function):
        @staticmethod
        def forward(ctx, cfg, feats, valid, mask_feats, dinv):
            ctx.cfg = cfg
            ctx.save_for_backward(feats, valid, mask_feats, dinv)
            return F1.fused_composite_s1_plain_fwd(cfg, feats, valid,
                                                   mask_feats, dinv)

        @staticmethod
        def backward(ctx, *grads):
            d_feats, d_mask = F1.fused_composite_s1_plain_bwd(
                ctx.cfg, *ctx.saved_tensors, *(t.contiguous() for t in grads))
            return None, d_feats, None, d_mask, None

    def fused(cfg, feats, valid, mask_feats=None, dinv=None):
        return F1.select_outputs(cfg, *PlainFusedS1.apply(
            cfg, feats, valid, mask_feats, dinv))
    return fused


def plain_sample(atlas, atlas_mask, coords):
    """renderer.sample_dense made of the plain version under autograd."""
    from videoloop3d_torch.render.sample import bilinear_planes_plain
    x, y = coords.x, coords.y
    return (bilinear_planes_plain(atlas, x, y),
            None if atlas_mask is None
            else bilinear_planes_plain(atlas_mask, x, y))


def s1_step_grads(route, plain):
    """Loss, metrics and atlas gradients of one stage-1 step (initial
    parameters, shipped weights), with the kernels or with the plain
    versions composed in their place."""
    import torch
    from videoloop3d_torch.models import mpmesh
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    args, model, params, batch = s1_setup(route)
    for t in params.values():
        t.requires_grad_(True)
    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)
    saved = (renderer.sample_dense, mpmesh.fused_composite_s1)
    if plain:
        renderer.sample_dense = plain_sample
        mpmesh.fused_composite_s1 = make_plain_fused_s1()
    try:
        total, metrics = TS1.make_stage1_loss_fn(model, args, *S1_PATCH)(
            params, batch, weights)
        total.backward()
    finally:
        renderer.sample_dense, mpmesh.fused_composite_s1 = saved
    return ({k: float(torch.as_tensor(v).detach())
             for k, v in metrics.items()},
            {k: params[k].grad for k in ("atlas", "atlas_mask")})


def check_s1_step(route):
    """Phase 10: the kernel step against the plain step on the card:
    metrics to 1e-5 relative, gradients to 1e-5 * max|g| (K6's atomics and
    the plain scatter both add in no fixed order)."""
    from videoloop3d_torch import kernels
    kernels.reset_launches()
    m_k, g_k = s1_step_grads(route, plain=False)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p = s1_step_grads(route, plain=True)
    if kernels.LAUNCHES["sample_dense"] != launched["sample_dense"]:
        raise AssertionError("the plain step launched a kernel")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
               for k in g_k)
    if not (rel <= 1e-5 and grel <= 1e-5):
        raise AssertionError(f"stage-1 {route} step differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "loss": m_k["loss"]}


def profile_s1_step(args, model, params, batch):
    """Device busy share and the largest device entries of one warm
    stage-1 train step (Adam included), plus its host-clock time."""
    import torch
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    step, opt_init, keys = TS1.make_train_step(model, args, *S1_PATCH)
    opt = opt_init(params)
    weights = common.extra_loss_weights(args, keys)
    for _ in range(3):
        step(params, opt, batch, 0.05, weights)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        step(params, opt, batch, 0.05, weights)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 100
    torch.cuda.reset_peak_memory_stats()
    by_name, wall_ms = profiled(lambda: (step(params, opt, batch, 0.05,
                                              weights),
                                         torch.cuda.synchronize()))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"step_ms_10_steps": step_ms, "profiled_wall_ms": wall_ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "groups": device_groups(by_name),
            "top": [{"name": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in rows[:12]]}


def compare_designs(profile, module, name, first,
                    groups=("nn_", "sample_dense_grad"), memory=False):
    """One step's profile with the redesigned kernel and with its first
    design put in its place (module.name = first; or each of a tuple of
    names with the first designs of a tuple, in one module or in a tuple
    of modules, one a name), in turns: first, redesign,
    redesign, first.  Returns {design: [summaries]}, each summary the
    host-clock step ms, device ms, busy share and the device ms and share
    of the profile groups whose names start with one of `groups` (K6's,
    K11's, K24/K26's, K27's kernels); with memory, the peak device
    memory."""
    names = (name,) if isinstance(name, str) else tuple(name)
    firsts = (first,) if callable(first) else tuple(first)
    mods = module if isinstance(module, tuple) else (module,) * len(names)
    saved = [getattr(m, n) for m, n in zip(mods, names)]
    out = {"first_design": [], "redesign": []}
    for key in ("first_design", "redesign", "redesign", "first_design"):
        for m, n, f, k in zip(mods, names, firsts, saved):
            setattr(m, n, f if key == "first_design" else k)
        try:
            prof = profile()
        finally:
            for m, n, k in zip(mods, names, saved):
                setattr(m, n, k)
        step_ms = next(v for k, v in prof.items() if k.startswith("step_ms"))
        out[key].append({
            "step_ms": step_ms, "device_ms": prof["device_ms"],
            "device_busy_share": prof["device_busy_share"],
            "groups": {k: v for k, v in prof["groups"].items()
                       if k.startswith(groups)}}
            | ({"max_memory_allocated_GB": prof["max_memory_allocated_GB"]}
               if memory else {}))
    return out


def stage1_phases():
    """Phases 8-10.  Returns (kernel records, launches per route)."""
    rec = check_s1_kernels()
    scene_dir = s1_scene()
    launches = {}
    for route in S1_ROUTES:
        counts, rows, rundir, wall = drive_train(scene_dir, route)
        summary = check_train(route, counts, rows, rundir)
        launches[route] = counts
        print(json.dumps({"train_3d": route, "cli_wall_s": wall,
                          "launches": counts, **summary}), flush=True)
    for route in S1_ROUTES:
        print(json.dumps({"plain_step_check": route,
                          **check_s1_step(route)}), flush=True)
    for route in S1_ROUTES:
        print(json.dumps({"profile": f"stage-1 step, {route} route",
                          **profile_s1_step(*s1_setup(route))}), flush=True)
    from videoloop3d_torch.first_designs import (fused_s1_bwd_first,
                                                  fused_s1_fwd_first)
    from videoloop3d_torch.render import fused_s1 as F1
    from videoloop3d_torch.render import sample as S
    setup = s1_setup("shipped")
    print(json.dumps({"profile_compare": "dense stage-1 step, shipped "
                      "route: K6's first design against its redesign",
                      **compare_designs(lambda: profile_s1_step(*setup), S,
                                        "sample_dense_grad",
                                        sample_dense_grad_first)}),
          flush=True)
    del setup
    setup = s1_setup("fused")
    k8_step = compare_designs(lambda: profile_s1_step(*setup), F1,
                              "fused_s1_bwd", fused_s1_bwd_first,
                              groups=("fused_s1_bwd",))
    print(json.dumps({"profile_compare": "dense stage-1 step, "
                      "--fused_render: K8's first design against its "
                      "redesign", **k8_step}), flush=True)
    rec["fused_s1_bwd"]["step_in_turns"] = k8_step
    k7_step = compare_designs(lambda: profile_s1_step(*setup), F1,
                              "fused_s1_fwd", fused_s1_fwd_first,
                              groups=K7_KERNELS)
    print(json.dumps({"profile_compare": "dense stage-1 step, "
                      "--fused_render: K7's first design against its "
                      "redesign", **k7_step}), flush=True)
    rec["fused_s1_fwd"]["step_in_turns"] = k7_step
    return rec, launches, scene_dir


def s1_dense_for_cull(geom, seed=0):
    """Dense stage-1 params at the shipped width whose cull keeps about
    20% of the tiles, about 30% of them dynamic: opaque (and, for the
    dynamic ones, loopable) blocks inside the chosen tiles, 4 texels in
    from every tile edge so that the cull's erode/dilate (net +2 texels)
    stays inside the tile, over a transparent, static background."""
    rng = np.random.default_rng(seed)
    D, Ht, Wt = geom.n_planes, geom.mpi_h, geom.mpi_w
    sy, sx = geom.tile_span
    r = rng.random((D, geom.n_tiles_h, geom.n_tiles_w))
    keep = r < 0.2
    dyn = keep & (rng.random(r.shape) < 0.3)
    atlas = rng.random((D, Ht, Wt, 4), dtype=np.float32)
    atlas[..., 3] = rng.uniform(-6.0, -4.0, (D, Ht, Wt))
    mask = rng.uniform(-4.0, -2.0, (D, Ht, Wt, 1)).astype(np.float32)
    for d, i, j in zip(*np.nonzero(keep)):
        y0, y1 = int(np.ceil(i * sy)) + 4, int(np.floor((i + 1) * sy)) - 3
        x0, x1 = int(np.ceil(j * sx)) + 4, int(np.floor((j + 1) * sx)) - 3
        atlas[d, y0:y1, x0:x1, 3] = rng.uniform(1.0, 3.0)
        if dyn[d, i, j]:
            mask[d, y0:y1, x0:x1] = 3.0
    return {"atlas": atlas, "atlas_mask": mask}, int(keep.sum()), \
        int(dyn.sum())


def s1_sparse_setup():
    """The s1_setup model and batch in the sparse phase: tile_cull of
    s1_dense_for_cull's params through sparsify.apply_tile_cull.  Returns
    (args, model, params, batch, cull record)."""
    from videoloop3d_torch.core.activations import get_activation
    from videoloop3d_torch.models.sparsify import apply_tile_cull

    args, model, params, batch = s1_setup("shipped")
    dense, n_keep, n_dyn = s1_dense_for_cull(model.geom)
    t = time.perf_counter()
    params, info = apply_tile_cull(
        model, {**dense, "verts": params["verts"]},
        get_activation(args.alpha_activate), erode_num=args.sparsify_erode,
        alpha_thresh=args.sparsify_alpha_thresh,
        rm_first_layers=args.sparsify_rmfirstlayer)
    cull_s = time.perf_counter() - t
    ns, nd = len(params["atlas"]), len(params["atlas_dyn"])
    if (ns + nd, nd) != (n_keep, n_dyn):
        raise AssertionError(f"cull kept {ns} + {nd} tiles, expected "
                             f"{n_keep - n_dyn} + {n_dyn}")
    return args, model, params, batch, {
        "cull_s": cull_s, "tiles_static": ns, "tiles_dyn": nd,
        "keep_frac": info["keep_frac"], "dyn_frac": info["dyn_frac"],
        "tile_hw": info["tile_hw"]}


def check_s1_sparse_kernels(model, params, batch):
    """Phase 11: K1, K2 and K9 against their plain versions on the card at
    the shipped sparse stage-1 shapes (the s1_sparse_setup patch and
    tiles, a random cotangent), with CUDA-event times and bounds; K9 also
    against its first design (vl3d_bilinear_tiles_grad_first), timed
    beside it in turns."""
    import torch
    from videoloop3d_torch.first_designs import bilinear_tiles_grad_first
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    g = model.geom
    h, w = S1_PATCH
    ref_inv = torch.as_tensor(np.linalg.inv(g.ref_extrin_np()), device=DEVICE)
    G = R.homographies(g, batch["extrin"] @ ref_inv[None],
                       batch["intrin"]).contiguous()
    maps = (model.tile_map_static, model.tile_map_dyn)
    rec = {"warp_lookup": check_warp_lookup(G, maps, h, w, g)}
    _, k_s, k_d, fu, fv = R.warp_lookup(G, *maps, h, w, (g.mpi_h, g.mpi_w),
                                        g.tile_span)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    n = k_s.numel()
    for key, k in (("atlas", k_s), ("atlas_dyn", k_d)):
        tiles = params[key].detach()
        N, th, tw, C = tiles.shape
        u = (fu * (tw - 1)).contiguous()
        v = (fv * (th - 1)).contiguous()
        args = (tiles, k, u, v)
        # K2, 1e-6: identical f32 lerps of the same texels
        e2 = max_err(S.bilinear_tiles(*args)[0],
                     S.bilinear_tiles_plain(*args)[0])
        # K9: atomics add in no fixed order -> 1e-5 relative to max|g|, of
        # its plain version and of its first design
        ct = torch.randn(k.shape + (C,), generator=gen, device=DEVICE)
        gargs = (ct, k, u, v, tiles.shape)
        g9, p9 = S.bilinear_tiles_grad(*gargs), S.bilinear_tiles_grad_plain(
            *gargs)
        e9 = max_err(g9, p9) / float(p9.abs().max())
        e9_first = max_err(g9, bilinear_tiles_grad_first(*gargs)) / float(
            p9.abs().max())
        if not (e2 <= 1e-6 and e9 <= 1e-5 and e9_first <= 1e-5):
            raise AssertionError(f"sparse kernels disagree on {key}: K2 "
                                 f"{e2}, K9 {e9}, K9 against its first "
                                 f"design {e9_first}")
        if key != "atlas":
            continue
        # phase 38 times K2 at C = 13 on these samples
        SPARSE_S1_SAMPLES.update(tiles=tiles, k=k, u=u, v=v)
        hits = int((k >= 0).sum())
        used = torch.unique(k[k >= 0]).numel()
        texel = th * tw * C * 4
        rec["bilinear_tiles"] = dict(
            max_abs_err=e2, samples=n, hits=hits,
            ms=cuda_ms(lambda: S.bilinear_tiles(*args), 20),
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(*args), 5),
            bound=bound_ms(n * 4 + hits * 8 + used * texel + n * C * 4,
                           hits * (9 * C + 10)))
        ms9, first9, turns9 = ms_in_turns(
            lambda: S.bilinear_tiles_grad(*gargs),
            lambda: bilinear_tiles_grad_first(*gargs), 20)
        rec["bilinear_tiles_grad"] = dict(
            max_abs_err=max_err(g9, p9), max_rel_err=e9,
            first_design_max_rel_err=e9_first,
            first_design="csrc/bilinear_tiles.cu:"
                         "vl3d_bilinear_tiles_grad_first",
            vector_floats=S._vec_width(C, ct, g9),
            sass_atomics=sass_atomics("bilinear_tiles", (
                "bilinear_tiles_grad_kernel",
                "bilinear_tiles_grad_first_kernel")),
            samples=n, hits=hits, tiles=N, ms=ms9, first_design_ms=first9,
            ms_in_turns=turns9,
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_grad_plain(*gargs), 3),
            library_ms=None,
            bound=bound_ms(n * 4 + hits * (8 + C * 4) + N * texel,
                           hits * (8 * C + 10)))
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage-1 sparse", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def drive_sparse_train(scene_dir):
    """Phase 12: the shipped route through the cull: --N_iters 3
    --sparsify_epoch 2 (2 dense epochs, the cull, 1 sparse epoch), then
    --N_iters 4, which must auto-resume from the sparse checkpoint.  The
    run's K1, K2 and K9 launches all come from the sparse epoch (the dense
    epochs launch K5/K6 only, and there are no previews).

    The cull threshold is cut with the schedule: on this scene no texel
    reaches the shipped sparsify_alpha_thresh = 0.05 within a few epochs
    (sigmoid(-3) = 0.047 is where the alphas start), so that threshold
    culls every tile after 2 epochs; 0.03 keeps the tiles whose alphas
    have not fallen, about a quarter of them."""
    from videoloop3d_torch.models import checkpoint as ckpt_io

    def argv(n_iters):
        return ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
                "--factor", "1", "--N_iters", str(n_iters),
                "--sparsify_epoch", "2", "--sparsify_alpha_thresh", "0.03",
                "--i_video", "1000",
                "--i_img", "9", "--datadir", scene_dir,
                "--expdir", os.path.join(WORK, "s1_runs"),
                "--expname", "sparse"]

    counts, rows, rundir, wall, out = run_train(argv(3))
    cull = [ln for ln in out.splitlines() if "tile culling: keep" in ln]
    idle = [k for k in SPARSE_KERNELS + ("sample_dense", "sample_dense_grad")
            if counts[k] == 0]
    epoch_steps = counts["sample_dense"] // 2
    loss = [(r["step"], r["value"]) for r in rows
            if r["tag"] == "stage1/loss"]
    sparse_loss = [v for st, v in loss if st >= 2 * epoch_steps]
    if (len(cull) != 1 or idle or not sparse_loss
            or not np.isfinite([v for _, v in loss]).all()):
        raise AssertionError(f"sparse run: cull lines {cull}, idle {idle}, "
                             f"loss {loss}")
    ckpt = os.path.join(rundir, "ckpt_epoch_0002.npz")
    if not ckpt_io.load_checkpoint_meta(ckpt)["is_sparse"]:
        raise AssertionError("ckpt_epoch_0002.npz is not sparse")
    sparse_ms = [r["value"] for r in rows
                 if r["tag"] == "stage1/warm_step_ms_sparse"]
    r_counts, r_rows, _, r_wall, r_out = run_train(argv(4))
    resumed = f"auto-resuming from {ckpt} at epoch 3" in r_out
    new = [(r["step"], r["value"]) for r in r_rows[len(rows):]
           if r["tag"] == "stage1/loss"]
    last = ckpt_io.load_checkpoint_meta(
        os.path.join(rundir, "ckpt_epoch_0003.npz"))
    if not (resumed and new and new[0][0] == 3 * epoch_steps
            and np.isfinite([v for _, v in new]).all()
            and last["is_sparse"] and r_counts["bilinear_tiles_grad"] > 0):
        raise AssertionError(f"the resume did not continue the sparse run: "
                             f"resumed {resumed}, losses {new}")
    return counts, {
        "cull_line": cull[0], "cli_wall_s": wall, "loss": loss,
        "warm_ms_per_sparse_step": sparse_ms[-1],
        "resume": {"cli_wall_s": r_wall, "loss": new,
                   "launches": r_counts}}


def make_plain_sparse():
    """renderer.warp_lookup and renderer.sample_sparse made of the plain
    versions under autograd, for the plain composition of a sparse step
    (phase 13)."""
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render.sample import bilinear_tiles_plain

    def sample_sparse(tiles, k, fu, fv, gather_dtype=None):
        th, tw = tiles.shape[1:3]
        return bilinear_tiles_plain(tiles, k, fu * (tw - 1), fv * (th - 1))
    return R.warp_lookup_plain, sample_sparse


def check_s1_sparse_step(args, model, params, batch):
    """Phase 13: one sparse step with the kernels against the same step
    made of the plain versions on the card: metrics to 1e-5 relative,
    atlas and atlas_dyn gradients to 1e-5 * max|g|."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)

    def grads(plain):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        saved = (renderer.warp_lookup, renderer.sample_sparse)
        if plain:
            renderer.warp_lookup, renderer.sample_sparse = make_plain_sparse()
        try:
            total, metrics = TS1.make_stage1_loss_fn(model, args, *S1_PATCH)(
                p, batch, weights)
            total.backward()
        finally:
            renderer.warp_lookup, renderer.sample_sparse = saved
        return ({k: float(torch.as_tensor(v).detach())
                 for k, v in metrics.items()},
                {k: p[k].grad for k in ("atlas", "atlas_dyn")})

    kernels.reset_launches()
    m_k, g_k = grads(False)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p = grads(True)
    if kernels.LAUNCHES != launched or any(launched[k] == 0
                                           for k in SPARSE_KERNELS):
        raise AssertionError(f"launches: kernel step {launched}, plain step "
                             f"{kernels.LAUNCHES}")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
               for k in g_k)
    if not (rel <= 1e-5 and grel <= 1e-5):
        raise AssertionError(f"sparse step differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "loss": m_k["loss"]}


def sparse_phases(scene_dir):
    """Phases 11-13.  Returns (kernel records, launches of the sparse
    trainer run, the cell-a model and params)."""
    args, model, params, batch, cull = s1_sparse_setup()
    print(json.dumps({"phase": "stage-1 sparse setup", **cull}), flush=True)
    rec = check_s1_sparse_kernels(model, params, batch)
    counts, summary = drive_sparse_train(scene_dir)
    print(json.dumps({"train_3d": "shipped, through the cull",
                      "launches": counts, **summary}), flush=True)
    print(json.dumps({"plain_step_check": "stage-1 sparse",
                      **check_s1_sparse_step(args, model, params, batch)}),
          flush=True)
    print(json.dumps({"profile": "stage-1 sparse step, shipped route",
                      **profile_s1_step(args, model, params, batch)}),
          flush=True)
    return rec, counts, (model, params)


def s2_args(extra=()):
    """The shipped stage-2 configuration at factor 1, 50 frames."""
    from videoloop3d_torch.config import parse_args_with_configs
    return parse_args_with_configs(
        ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
         "--factor", "1", "--mpv_frm_num", "50", *extra])


def s2_setup():
    """The benchmark MTV (make_sparse_mtv: 9,786 static and 4,257 dynamic
    12x12 tiles, F = 50) as a stage-2 model of the shipped config on the
    card (``--fused_render``, no slot bound yet: `s2_route` sets the
    route), and one batch as the trainer feeds it: a 180x320 patch at the
    centre of the 360x640 view, 0.05 to the side of the reference camera,
    with its target video (`s2_video`)."""
    import torch
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.models.mpv import MPMeshVid

    mtv = synthetic.make_sparse_mtv(quick=False, seed=0)
    args = s2_args()
    H, W = mtv["hw"]
    model = MPMeshVid(args, H, W, np.eye(4, dtype=np.float32),
                      mtv["ref_intrin"], mtv["near"], mtv["far"],
                      device=DEVICE)
    params = model.restore_checkpoint({
        "meta": {"is_sparse": True, "tile_hw": list(mtv["tile_hw"]),
                 "frm_num": mtv["frm_num"], "extra": {}},
        "geom": mtv["geom"], "params": mtv["params"],
        "tile_map_static": mtv["tile_map_static"],
        "tile_map_dyn": mtv["tile_map_dyn"]})
    ph, pw = S2_PATCH
    ext = np.eye(4, dtype=np.float32)[None]
    ext[:, 0, 3] = 0.05
    pi = mtv["ref_intrin"].copy()
    pi[0, 2] -= (W - pw) / 2
    pi[1, 2] -= (H - ph) / 2
    batch = {"extrin": torch.as_tensor(ext, device=DEVICE),
             "intrin": torch.as_tensor(pi[None], device=DEVICE)}
    batch["video"] = s2_video(model, params, batch)
    return args, model, params, batch


def s2_video(model, params, batch):
    """A target video for the patch: the training render of the MTV with
    its raw colour channels mirrored (1 - c), rolled by 7 frames.  It
    differs from the render everywhere, so no NN distance is 0 (alpha 0
    divides by the column minima), and its temporal patches are equal only
    where the MTV is static (ties among equal patches fold to the same
    target).  (F, 180, 320, 3) f32."""
    import torch
    with torch.no_grad():
        p2 = {k: v.clone() for k, v in params.items()}
        for k in ("atlas", "atlas_dyn"):
            p2[k][..., :3] = 1.0 - p2[k][..., :3]
        rgb, _ = model.render(p2, *S2_PATCH, batch["extrin"],
                              batch["intrin"], None, training=True)
    return torch.roll(rgb, 7, dims=0).contiguous()


def s2_loss_inputs(model, params, batch, cfg):
    """The NN search inputs of the patch loss under `cfg` (as
    train/stage2.py:make_patch_loss_fn builds them, scale-invariant gain
    left out): x the loop-padded render (3, F + pt - 1, h, w), y the video
    (3, F, h, w), in the search dtype; the crop plan and alpha."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN
    with torch.no_grad():
        rgb, _ = model.render(params, *S2_PATCH, batch["extrin"],
                              batch["intrin"], None, training=True)
    x = rgb.permute(3, 0, 1, 2)
    x = torch.cat([x, x[:, :cfg["patcht_size"] - 1]], dim=1)
    y = batch["video"].permute(3, 0, 1, 2)
    xs, ys = PN._nn_cast(x.contiguous(), y.contiguous(), cfg["nn_bf16"])
    psz = (cfg["patcht_size"], cfg["patch_size"], cfg["patch_size"])
    plan = PN.lowmem_plan(x.shape[1], y.shape[1], x.shape[2], x.shape[3],
                          psz, (cfg["stridet"], cfg["stride"], cfg["stride"]),
                          cfg["macro_block"])
    return xs.contiguous(), ys.contiguous(), plan, \
        PN._norm_alpha(cfg["alpha"])


FLIP_LIMIT = 1e-5


def nn_flips(x, y, plan, alpha, nn_k):
    """K11's indices nn_k against the plain version's.  Both evaluate the
    expanded form (|X_i|^2 + |Y_j|^2 - 2 X_i.Y_j) / d, summing in another
    order; its rounding error scales with the terms it cancels, not with
    the distance (the MTV's low-contrast renders make distances 10-100x
    smaller than the terms).  So a flip is a near tie when the plain
    distances of the two choices lie within FLIP_LIMIT of that scale, not
    of the distance: (|X_i|^2 + |Y_j|^2) / d, and with alpha also the
    column minimum's own term scale times the normalized distance, over
    |alpha + column minimum|.  Raises on any other flip.  Returns (the
    plain indices, the flip mask, the largest flip gap: absolute, relative
    to the distance and relative to the scale); the record prints the gap
    relative to the distance too, so a change that widens it shows."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    ft, fh, fw = plan.fit
    scales = []
    for xc, yc in zip(PN._crops(x[:, :ft, :fh, :fw].float(), plan),
                      PN._crops(y[:, :plan.fit_ty, :fh, :fw].float(), plan)):
        nx = PN.extract_patches_3d(xc, plan.psz, plan.strides)
        ny = PN.extract_patches_3d(yc, plan.psz, plan.strides)
        d = nx.shape[-1]
        xx = (nx * nx).sum(-1).flatten(1).T          # (cols, ntx)
        yy = (ny * ny).sum(-1).flatten(1).T          # (cols, nty)
        scales.append((xx[..., :, None] + yy[..., None, :]) / d)
    return flip_gaps("nn_argmin", PN.nn_dist_plain(x, y, plan, None),
                     torch.stack(scales), alpha, nn_k)


def flip_gaps(name, raw, scale, alpha, nn_k, dim=3):
    """The kernel's indices nn_k (argmins over `dim` of the distances raw,
    alpha-normalized) against the plain argmin, given each distance's term
    scale: every flip must be a near tie (`nn_flips`).  Returns (the plain
    indices, the flip mask, the largest flip gap: absolute, relative to
    the distance and relative to the scale)."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    dist = PN.normalized_dist(raw.flatten(0, 1), alpha).view(raw.shape)
    nn_p = torch.argmin(dist, dim=dim).to(torch.int32)
    flips = nn_k != nn_p
    if not bool(flips.any()):
        return nn_p, flips, 0.0, 0.0, 0.0
    if alpha is not None:
        den = (alpha + raw.amin(dim=2, keepdim=True)).abs()
        scale = (scale + dist.abs() * scale.amax(dim=2, keepdim=True)) / den

    def at(t, nn):
        return torch.gather(t, dim, nn.long().unsqueeze(dim)).squeeze(dim)[
            flips]

    dk, dp = at(dist, nn_k), at(dist, nn_p)
    gap = (dk - dp).abs()
    rel_scale = gap / torch.maximum(at(scale, nn_k), at(scale, nn_p))
    rel_dist = float((gap / dp.abs().clamp(min=1e-30)).max())
    if not bool((rel_scale <= FLIP_LIMIT).all()):
        raise AssertionError(f"{name} differs off near ties: largest gap "
                             f"{float(rel_scale.max())} of the term scale, "
                             f"{int(flips.sum())} flips")
    return nn_p, flips, float(gap.max()), rel_dist, float(rel_scale.max())


def band_flips(x, y, plan, alpha, nn_k, scale_by_pt, dim=3):
    """`nn_flips` for K18: the banded per-frame distances, whose term scale
    is the banded sum of the per-frame (|X_f|^2 + |Y_g|^2) / d (/ pt with
    scale_by_pt); dim 3 for its rows, 2 for its columns."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty = plan.grid[:2]
    ft, fh, fw = plan.fit
    scales = []
    for xc, yc in zip(PN._crops(x[:, :ft, :fh, :fw].float(), plan),
                      PN._crops(y[:, :plan.fit_ty, :fh, :fw].float(), plan)):
        px, py = PN._frame_patches(xc, plan), PN._frame_patches(yc, plan)
        xx, yy = (px * px).sum(-1), (py * py).sum(-1)     # (cols, F)
        s1 = (xx[..., :, None] + yy[..., None, :]) / px.shape[-1]
        band = PN.banded_temporal_dist_plain(s1, pt, st, ntx, nty)
        scales.append(band / pt if scale_by_pt else band)
    raw = PN.nn_band_dist_plain(x, y, plan, None, scale_by_pt)
    return flip_gaps("nn_band_argmin", raw, torch.stack(scales), alpha,
                     nn_k, dim)


def fold_library(y, nn_k, plan):
    """K12's library yardstick on y's pre-extracted, selected patches (not
    timed): the JAX package's fold, a transposed convolution with the
    identity kernel, per crop.  Returns the callable."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.losses import patch_nn as PN

    ntx, nty, nh, nw = plan.grid
    C = y.shape[0]
    d = C * int(np.prod(plan.psz))
    ft, fh, fw = plan.fit
    Yf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(nty, nh * nw, d).transpose(0, 1)
                    for c in PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)])
    sel = torch.take_along_dim(Yf.float(),
                               nn_k.reshape(-1, ntx).long()[..., None],
                               dim=1)                         # (cols, ntx, d)
    sel = sel.reshape(-1, nh, nw, ntx, d).permute(0, 4, 3, 1, 2).contiguous()
    kern = torch.zeros((d, C) + tuple(plan.psz), device=y.device)
    q = torch.arange(d, device=y.device)
    pt, ph, pw = plan.psz
    kern[q, q // (pt * ph * pw), (q // (ph * pw)) % pt, (q // pw) % ph,
         q % pw] = 1.0

    def lib12():
        return TF.conv_transpose3d(sel, kern, stride=plan.strides)

    lib_fold = lib12()
    if lib_fold.shape[2:] != (ft,) + tuple(plan.crop_hw):
        raise AssertionError(f"fold yardstick shape {tuple(lib_fold.shape)}")
    return lib12


def first_equal(y, plan):
    """For every crop column and temporal y patch j, the first j' whose
    patch equals patch j bit for bit (integer hashes of the bf16 or f32
    bits, exact in any order).  (n_crops, nh * nw, nty) int64."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    ntx, nty, nh, nw = plan.grid
    ft, fh, fw = plan.fit
    gen = torch.Generator(device=y.device).manual_seed(5)
    bits = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    out = []
    for c in PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan):
        p = PN.extract_patches_3d(c.contiguous().view(bits).long(), plan.psz,
                                  plan.strides).reshape(nty, nh * nw, -1)
        wts = torch.randint(1, 2 ** 20, (2, p.shape[-1]), generator=gen,
                            device=y.device)
        h = torch.stack([(p * w).sum(-1) for w in wts], -1)   # (nty, cols, 2)
        h = h.transpose(0, 1)
        eq = (h[:, :, None] == h[:, None, :]).all(-1)       # (cols, j, j')
        out.append(eq.int().argmax(-1))
    return torch.stack(out)


def nn_tie_check(name, y, plan, nn_k):
    """Every index of nn_k must be the first of the y patches bit-equal to
    it (the first-minimum rule on bit-equal distances).  Returns the
    number of queries whose choice has bit-equal candidates."""
    import torch
    fe = first_equal(y, plan)
    chosen = torch.gather(fe, 2, nn_k.long())
    if not torch.equal(chosen, nn_k.long()):
        raise AssertionError(f"{name}: {int((chosen != nn_k).sum())} "
                             "choices are not the first of their exact ties")
    groups = (fe[:, :, :, None] == fe[:, :, None, :]).sum(-1)
    return int((torch.gather(groups, 2, nn_k.long()) > 1).sum())


def check_nn(x, y, plan, alpha):
    """K11 and K12 against their plain versions on one loss config's
    inputs.  K11's indices must equal the plain version's except at near
    ties (`nn_flips`), and on f32 inputs (the CUDA-core search) its first
    design's bit for bit; K12 is held on K11's own indices (1e-5: the
    sums run in another order) and against its first design bit for bit,
    both designs timed in turns.  Returns the records (times, bounds,
    library times)."""
    import torch
    from videoloop3d_torch.first_designs import nn_argmin_first, nn_fold_first
    from videoloop3d_torch.losses import patch_nn as PN

    nn_k = PN.nn_argmin(x, y, plan, alpha)
    _, flips, gap_abs, gap_dist, gap_scale = nn_flips(x, y, plan, alpha,
                                                      nn_k)
    n_flips = int(flips.sum())
    out_k = PN.nn_fold(y, nn_k, plan)
    out_p = PN.nn_fold_plain(y, nn_k, plan)
    e12 = max_err(out_k, out_p)
    if not e12 <= 1e-5:
        raise AssertionError(f"nn_fold disagrees with its plain version: "
                             f"{e12}")
    ntx, nty, nh, nw = plan.grid
    C = x.shape[0]
    d = C * int(np.prod(plan.psz))
    cols = len(plan.hs) * len(plan.ws) * nh * nw
    item = x.element_size()
    bf16 = x.dtype == torch.bfloat16
    # library yardsticks on pre-extracted patches (not timed): K11 as
    # baddbmm + amin + divide + argmin (bf16 patches: a bf16 GEMM with f32
    # sums and output, K11's arithmetic), K12 as the JAX package's fold, a
    # transposed convolution with the identity kernel, per crop
    ft, fh, fw = plan.fit
    xc = PN._crops(x[:, :ft, :fh, :fw], plan)
    yc = PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)
    Xf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(ntx, nh * nw, d).transpose(0, 1) for c in xc])
    Yf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(nty, nh * nw, d).transpose(0, 1) for c in yc])
    Xf, Yf = Xf.contiguous(), Yf.contiguous()
    xx = (Xf.float() ** 2).sum(-1)[..., :, None]
    yy = (Yf.float() ** 2).sum(-1)[..., None, :]
    YfT = Yf.transpose(1, 2)
    gemm = {"out_dtype": torch.float32} if bf16 else {}

    def lib11():
        dd = torch.baddbmm(xx + yy, Xf, YfT, alpha=-2.0, **gemm) / d
        if alpha is not None:
            dd = dd / (alpha + torch.amin(dd, dim=1, keepdim=True))
        return torch.argmin(dd, dim=2)

    lib12 = fold_library(y, nn_k, plan)
    n_nn = nn_k.numel()
    r11 = dict(
        max_abs_err=gap_abs, index_flips=n_flips,
        flip_share=n_flips / n_nn, queries=n_nn,
        flip_gap_rel_distance=gap_dist, flip_gap_rel_term_scale=gap_scale,
        flip_limit_rel_term_scale=FLIP_LIMIT,
        ms=cuda_ms(lambda: PN.nn_argmin(x, y, plan, alpha), 10),
        plain_ms=cuda_ms(lambda: PN.nn_argmin_plain(x, y, plan, alpha), 2),
        library_ms=cuda_ms(lib11, 5),
        bound=bound_ms((x.numel() + y.numel()) * item + n_nn * 4,
                       cols * (nn_search_ops(plan, C, 2) + 5 * ntx * nty),
                       BF16_OPS_PER_S if bf16 else F32_OPS_PER_S))
    # the first design (the first CUDA-core template) on the same inputs:
    # the f32 redesign keeps its bits, the tensor-core kernel does not
    nn_1 = nn_argmin_first(x, y, plan, alpha)
    if not bf16 and not torch.equal(nn_k, nn_1):
        raise AssertionError(f"nn_argmin (f32) differs from its first design "
                             f"at {int((nn_k != nn_1).sum())} queries")
    _, flips_1, _, _, gap_1 = nn_flips(x, y, plan, alpha, nn_1)
    r11.update(
        first_design="csrc/nn_argmin.cu:vl3d_nn_argmin_simt",
        first_design_ms=cuda_ms(
            lambda: nn_argmin_first(x, y, plan, alpha), 10),
        first_design_index_flips=int(flips_1.sum()),
        first_design_flip_gap_rel_term_scale=gap_1,
        differs_from_first_design=int((nn_k != nn_1).sum()))
    covers = float(plan.weight[plan.weight >= 1].sum())
    out_1 = nn_fold_first(y, nn_k, plan)
    if not torch.equal(out_k.view(torch.int32), out_1.view(torch.int32)):
        raise AssertionError("nn_fold differs from its first design at "
                             f"{int((out_k != out_1).sum())} voxels")
    ms12, first12, turns12 = ms_in_turns(
        lambda: PN.nn_fold(y, nn_k, plan),
        lambda: nn_fold_first(y, nn_k, plan), 20)
    r12 = dict(
        max_abs_err=e12, equal_to_first_design=True,
        first_design="csrc/nn_fold.cu:vl3d_nn_fold_first",
        layout=PN.nn_fold_layout(plan, *y.shape[:2]),
        ms=ms12, first_design_ms=first12, ms_in_turns=turns12,
        plain_ms=cuda_ms(lambda: PN.nn_fold_plain(y, nn_k, plan), 2),
        library_ms=cuda_ms(lib12, 10),
        bound=bound_ms(y[:, :plan.fit_ty].numel() * item + n_nn * 4
                       + out_k.numel() * 4, C * covers + out_k.numel()))
    return r11, r12


def tile_layout(plan, C, mode):
    """The CUDA-core search's layout for K11 ("mse", "ssim") or K18
    ("band") at this plan (losses/patch_nn.py:tile_layout), its shared
    bytes held to the C layout's (csrc/nn_argmin.cu:vl3d_nn_tile_smem).
    Returns the fields worth printing."""
    from videoloop3d_torch import kernels
    from videoloop3d_torch.losses import patch_nn as PN

    lay = PN.tile_layout(plan, C, mode)
    c_smem = kernels.library().vl3d_nn_tile_smem(
        PN._plan_ints(plan), C, {"mse": 0, "band": 1, "ssim": 2}[mode])
    if c_smem != lay["smem"]:
        raise AssertionError(f"tile_layout {mode}: {lay['smem']} B against "
                             f"the kernel's {c_smem}")
    return {k: lay[k] for k in ("ra", "rb", "n_ti", "n_tj", "ncb", "chunks",
                                "nb", "threads", "smem")}


def check_band(x, y, plan, alpha=None, scale_by_pt=False, both=False,
               with_err=False, time_it=True):
    """K18 (and with with_err K19, both directions) against their plain
    versions on the card: K18's rows (and with both its columns) equal the
    plain version's except at near ties (`band_flips`), and its first
    design's (vl3d_nn_band_argmin_first) bit for bit; K19 within 1e-6
    relative on K18's own indices (f32 sums in another order), and of its
    first design (vl3d_nn_band_err_first; another fixed order), the first
    design and one column a block within 1e-6 of the plain version, the
    redesign the same bits twice and with its target read from device
    memory or staged, both designs' largest relative error against
    float64 sums of the same terms, its layout the kernel's.  With
    time_it, CUDA-event times of the redesigns and the first designs
    (K19's in turns, its two target reads and one column a block), bounds
    and library times: K18 as baddbmm (the
    per-frame distances of pre-extracted patches), slice adds (the band)
    and argmin; K19 as take_along_dim, abs and mean.  Returns (K18's
    record, K19's record or None)."""
    import torch
    from videoloop3d_torch.first_designs import (nn_band_argmin_first,
                                                 nn_band_err_first)
    from videoloop3d_torch.losses import patch_nn as PN

    rows, cols = PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt, both)
    rows_1, cols_1 = nn_band_argmin_first(x, y, plan, alpha, scale_by_pt,
                                          both)
    if not (torch.equal(rows, rows_1)
            and (not both or torch.equal(cols, cols_1))):
        raise AssertionError(
            f"nn_band_argmin differs from its first design: rows "
            f"{int((rows != rows_1).sum())}, columns "
            f"{int((cols != cols_1).sum()) if both else 0}")
    _, flips, gap_abs, gap_dist, gap_scale = band_flips(
        x, y, plan, alpha, rows, scale_by_pt)
    n_flips, queries = int(flips.sum()), rows.numel()
    if both:
        _, cflips, cgap, cgap_dist, cgap_scale = band_flips(
            x, y, plan, alpha, cols, scale_by_pt, dim=2)
        n_flips += int(cflips.sum())
        queries += cols.numel()
        gap_abs, gap_dist, gap_scale = (max(gap_abs, cgap),
                                        max(gap_dist, cgap_dist),
                                        max(gap_scale, cgap_scale))
    (pt, _, _), (st, _, _) = plan.psz, plan.strides
    ntx, nty, nh, nw = plan.grid
    C = x.shape[0]
    d = C * plan.psz[1] * plan.psz[2]
    n_cols = len(plan.hs) * len(plan.ws) * nh * nw
    fx, fy = plan.fit[0], plan.fit_ty
    item = x.element_size()
    bf16 = x.dtype == torch.bfloat16
    r18 = dict(max_abs_err=gap_abs, index_flips=n_flips,
               flip_share=n_flips / queries, queries=queries,
               flip_gap_rel_distance=gap_dist,
               flip_gap_rel_term_scale=gap_scale,
               flip_limit_rel_term_scale=FLIP_LIMIT, crops=len(plan.hs)
               * len(plan.ws), columns=nh * nw, dim=d, frames=[fx, fy],
               patches=[ntx, nty], equal_to_first_design=True,
               layout=tile_layout(plan, C, "band"))
    errs = []
    if with_err:
        def rel_err(a, b):
            return float(((a.double() - b.double()).abs()
                          / b.double().abs()).max())

        for nn, reverse in ((rows, False), (cols, True))[:2 if both else 1]:
            got = PN.nn_band_err(x, y, plan, nn, reverse)
            want = PN.nn_band_err_plain(x, y, plan, nn, reverse)
            rel = float(((got - want).abs() / want.abs()).max())
            if not rel <= 1e-6:
                raise AssertionError(f"nn_band_err disagrees with its plain "
                                     f"version: {rel}")
            first = nn_band_err_first(x, y, plan, nn, reverse)
            f64 = PN.nn_band_err_plain(x, y, plan, nn, reverse,
                                       torch.float64)
            forms = [PN.nn_band_err_launch(x, y, plan, nn, reverse,
                                           stage=stage) for stage in (0, 1)]
            one = PN.nn_band_err_launch(x, y, plan, nn, reverse, tw=1)
            e = dict(rel_err_vs_first_design=rel_err(got, first),
                     first_design_rel_err_vs_plain=rel_err(first, want),
                     rel_err_vs_f64=rel_err(got, f64),
                     first_design_rel_err_vs_f64=rel_err(first, f64),
                     same_bits_twice=torch.equal(
                         got, PN.nn_band_err(x, y, plan, nn, reverse)),
                     target_reads_equal=all(torch.equal(got, f)
                                            for f in forms),
                     one_column_rel_err_vs_plain=rel_err(one, want),
                     layout=PN.nn_band_err_layout(plan, C, reverse))
            if not (e["rel_err_vs_first_design"] <= 1e-6
                    and e["first_design_rel_err_vs_plain"] <= 1e-6
                    and e["one_column_rel_err_vs_plain"] <= 1e-6
                    and e["same_bits_twice"] and e["target_reads_equal"]
                    and e["layout"] == PN.kernel_nn_band_err_layout(
                        plan, C, reverse)):
                raise AssertionError(f"nn_band_err against its first design, "
                                     f"itself or its layout: {e}")
            errs.append((nn, reverse, rel, float((got - want).abs().max()),
                         e))
    if not time_it:
        return r18, ({"max_rel_err": max(e[2] for e in errs),
                      "checks": [e[4] for e in errs]} if with_err else None)
    # pre-extracted per-frame patches for the library yardsticks (not
    # timed); bf16 patches: a bf16 GEMM with f32 sums and output
    ft, fh, fw = plan.fit
    Xf = torch.cat([PN._frame_patches(c, plan) for c in
                    PN._crops(x[:, :ft, :fh, :fw], plan)]).contiguous()
    Yf = torch.cat([PN._frame_patches(c, plan) for c in
                    PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)]).contiguous()
    xx = (Xf.float() ** 2).sum(-1)[..., :, None]
    yy = (Yf.float() ** 2).sum(-1)[..., None, :]
    YfT = Yf.transpose(1, 2)
    gemm = {"out_dtype": torch.float32} if bf16 else {}

    def lib18():
        d1 = torch.baddbmm(xx + yy, Xf, YfT, alpha=-2.0, **gemm) / d
        dist = PN.banded_temporal_dist_plain(d1, pt, st, ntx, nty)
        if scale_by_pt:
            dist = dist / pt
        if alpha is not None:
            dist = dist / (alpha + torch.amin(dist, dim=1, keepdim=True))
        return torch.argmin(dist, dim=2), (torch.argmin(dist, dim=1)
                                           if both else None)

    r18.update(
        ms=cuda_ms(lambda: PN.nn_band_argmin(x, y, plan, alpha, scale_by_pt,
                                             both), 10),
        first_design_ms=cuda_ms(lambda: nn_band_argmin_first(
            x, y, plan, alpha, scale_by_pt, both), 10),
        plain_ms=cuda_ms(lambda: PN.nn_band_argmin_plain(
            x, y, plan, alpha, scale_by_pt, both), 2),
        library_ms=cuda_ms(lib18, 5),
        bound=bound_ms((x[:, :fx].numel() + y[:, :fy].numel()) * item
                       + queries * 4,
                       n_cols * (2 * fx * fy * d + 2 * (fx + fy) * d
                                 + 4 * fx * fy + (pt + 3) * ntx * nty),
                       BF16_OPS_PER_S if bf16 else F32_OPS_PER_S))
    if not with_err:
        return r18, None
    Xs, Ys = Xf.float(), Yf.float()
    r19 = {"max_abs_err": max(e[3] for e in errs),
           "max_rel_err": max(e[2] for e in errs), "directions": len(errs)}
    for nn, reverse, _, _, e in errs:
        A, B = (Ys, Xs) if reverse else (Xs, Ys)
        ns = nn.shape[2]
        nt = ntx if reverse else nty
        idx = nn.reshape(-1, ns).long()[..., None]

        def lib19():
            tot = 0.0
            for k in range(pt):
                sel = torch.take_along_dim(B[:, k:k + (nt - 1) * st + 1:st],
                                           idx, dim=1)
                tot = tot + (sel - A[:, k:k + (ns - 1) * st + 1:st]).abs() \
                    .mean()
            return tot / pt

        tag = "reverse_" if reverse else ""
        r19[f"{tag}checks"] = e
        r19[f"{tag}ms"], r19[f"{tag}first_design_ms"], \
            r19[f"{tag}ms_in_turns"] = ms_in_turns(
                lambda: PN.nn_band_err(x, y, plan, nn, reverse),
                lambda: nn_band_err_first(x, y, plan, nn, reverse), 10)
        # the target read from device memory and staged (where the
        # footprint fits), and one column a block
        for form, kw in (("l1", {"stage": 0}), ("staged", {"stage": 1}),
                         ("one_column", {"tw": 1})):
            r19[f"{tag}{form}_ms"] = cuda_ms(
                lambda: PN.nn_band_err_launch(x, y, plan, nn, reverse, **kw),
                10)
        r19[f"{tag}plain_ms"] = cuda_ms(
            lambda: PN.nn_band_err_plain(x, y, plan, nn, reverse), 2)
        r19[f"{tag}library_ms"] = cuda_ms(lib19, 5)
        r19[f"{tag}bound"] = bound_ms(
            (x[:, :fx].numel() + y[:, :fy].numel()) * item + nn.numel() * 4
            + len(plan.hs) * len(plan.ws) * 4, n_cols * ns * pt * d * 3)
    return r18, r19


def check_s2_kernels(args, model, params, batch):
    """Phase 14: K10 and K3 on the f32 dynamic atlas (as the --fp16 step
    reads it and takes its gradient), K9 on the f32 static atlas, K11 and K12
    against their plain versions on the card at the stage-2 step's shapes
    (the s2_setup patch, both loss configs, f32 and bf16 search inputs),
    with CUDA-event times, bounds and library times; K10 and K3 beside
    their first design and the bf16 copy.  Returns the records."""
    import torch
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    g = model.geom
    h, w = S2_PATCH
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    _, k_s, k_d, fu, fv = R.warp_lookup(
        G, model.tile_map_static, model.tile_map_dyn, h, w,
        (g.mpi_h, g.mpi_w), g.tile_span)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    rec = {}
    # K10 on the f32 dynamic atlas as the --fp16 step runs it: its sums
    # rounded to bf16 (the main path), and in f32; the f32 sums within
    # 1e-6 * max|g| of the plain version, the rounded ones the f32 sums'
    # rounding bit for bit, both the same bits twice; the first design
    # (atomics in no fixed order) within 1e-5 * max|g|
    from videoloop3d_torch.first_designs import tiles_tilemajor_grad_first
    bf16 = torch.bfloat16
    dyn = params["atlas_dyn"].detach().contiguous()
    dyn16 = dyn.to(bf16)
    N, th, tw, F, C = dyn.shape
    k = k_d[0].contiguous()
    u = (fu[0] * (tw - 1)).contiguous()
    v = (fv[0] * (th - 1)).contiguous()
    ct = torch.randn(k.shape + (F, C), generator=gen, device=DEVICE)
    gargs = (ct, k, u, v, dyn.shape)
    g10 = S.bilinear_tiles_tilemajor_grad(*gargs, bf16)
    g10f = S.bilinear_tiles_tilemajor_grad(*gargs)
    p10 = S.bilinear_tiles_tilemajor_grad_plain(*gargs)
    f10 = tiles_tilemajor_grad_first(*gargs)
    scale = float(p10.abs().max())
    e10 = max_err(g10f, p10) / scale
    e10_first = max_err(g10f, f10) / scale
    rounded = bool(torch.equal(g10, g10f.to(bf16).float()))
    rerun = bool(torch.equal(g10, S.bilinear_tiles_tilemajor_grad(
        *gargs, bf16))) and bool(torch.equal(
            g10f, S.bilinear_tiles_tilemajor_grad(*gargs)))
    layout = S.tiles_grad_layout(S.tiles_grad_planes(k.shape),
                                 k.numel() // S.tiles_grad_planes(k.shape),
                                 N, th, tw, F, C, S._vec_width(F * C, ct))
    layout_ok = S.kernel_tiles_grad_layout(
        S.tiles_grad_planes(k.shape),
        k.numel() // S.tiles_grad_planes(k.shape), N, th, tw, F, C,
        S._vec_width(F * C, ct)) == layout
    del f10
    # K3 on the f32 atlas gathered as bf16: bit for bit its samples of the
    # bf16 copy
    k3 = S.bilinear_tiles_tilemajor(dyn, k, u, v, None, bf16)[0]
    k3_copy = S.bilinear_tiles_tilemajor(dyn16, k, u, v)[0]
    k3_equal = bool(torch.equal(k3.view(torch.int32),
                                k3_copy.view(torch.int32)))
    del k3, k3_copy
    # through sample_tiles: both atlases in f32 at the bf16 gather dtype
    # (their gradients f32, every value a bf16 value), each within one
    # bf16 ulp of the plain f32 gradient rounded to bf16
    rounding = {}
    for key, kk, tiles, gather in (
            ("atlas_dyn", k, dyn, bf16),
            ("atlas", k_s[0].contiguous(),
             params["atlas"].detach().contiguous(), bf16)):
        t = tiles.detach().clone().requires_grad_(True)
        tu = (fu[0] * (t.shape[2] - 1)).contiguous()
        tv = (fv[0] * (t.shape[1] - 1)).contiguous()
        c = torch.randn(kk.shape + t.shape[3:], generator=gen, device=DEVICE)
        vals, _ = S.sample_tiles(t, kk, tu, tv, gather)
        (vals * c).sum().backward()
        plain = (S.bilinear_tiles_grad_plain if t.dim() == 4
                 else S.bilinear_tiles_tilemajor_grad_plain)(
                     c, kk, tu, tv, t.shape)
        if not (t.grad.dtype == torch.float32 and torch.equal(
                t.grad, t.grad.to(bf16).float())):
            raise AssertionError(f"{key}: gradient dtype {t.grad.dtype} or "
                                 "values not bf16 values")
        rounding[key] = max_err(t.grad, plain.to(bf16)) / float(
            plain.abs().max())
        del t, c, vals, plain
    if not (e10 <= 1e-6 and e10_first <= 1e-5 and rounded and rerun
            and k3_equal and layout_ok
            and max(rounding.values()) <= 2.0 ** -7):
        raise AssertionError(
            f"tile gradients disagree: K10 {e10}, its first design "
            f"{e10_first}, rounded {rounded}, rerun {rerun}, K3 f32 as bf16 "
            f"{k3_equal}, layout {layout_ok}, bf16 rounding {rounding}")
    hits = int((k >= 0).sum())
    n = k.numel()
    used = torch.unique(k[k >= 0]).numel()

    def old_chain():
        """What the redesign replaced: the zero fill and the first design,
        the sums cast to bf16 and widened back by the copy's backward."""
        return tiles_tilemajor_grad_first(*gargs).to(bf16).float()

    ms, first_ms, turns = ms_in_turns(
        lambda: S.bilinear_tiles_tilemajor_grad(*gargs, bf16),
        lambda: tiles_tilemajor_grad_first(*gargs), 10)
    rec["bilinear_tiles_tilemajor_grad"] = dict(
        max_abs_err=max_err(g10f, p10), max_rel_err=e10,
        first_design_max_rel_err=e10_first,
        rounded_equals_f32_rounded=rounded, bit_for_bit_rerun=rerun,
        bf16_grad_max_rel_err=rounding, samples=n, hits=hits, tiles=N,
        tiles_used=used, layout=layout,
        ms=ms, first_design_ms=first_ms, ms_in_turns=turns,
        f32_ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor_grad(*gargs), 10),
        replaced_chain_ms=cuda_ms(old_chain, 10),
        plain_ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor_grad_plain(
            *gargs), 2),
        library_ms=None,
        bound=bound_ms(n * 4 + hits * (8 + F * C * 4) + g10.numel() * 4,
                       hits * F * (8 * C + 10)))
    k3_args = (dyn, k, u, v, None, bf16)
    k3_ms, k3_copy_ms, k3_turns = ms_in_turns(
        lambda: S.bilinear_tiles_tilemajor(*k3_args),
        lambda: S.bilinear_tiles_tilemajor(dyn16, k, u, v), 10)
    rec["bilinear_tiles_tilemajor/stage 2, f32 as bf16"] = dict(
        max_abs_err=0.0, equal_to_bf16_copy=k3_equal, ms=k3_ms,
        bf16_copy_ms=k3_copy_ms, ms_in_turns=k3_turns,
        copy_ms=cuda_ms(lambda: dyn.to(bf16), 10),
        plain_ms=cuda_ms(lambda: S.bilinear_tiles_tilemajor_plain(
            *k3_args), 2),
        library_ms=None,
        bound=bound_ms(n * 4 + hits * 8 + used * th * tw * F * C * 4
                       + n * F * C * 4, hits * F * (9 * C + 10)))
    del g10, g10f, p10, ct, dyn16
    torch.cuda.empty_cache()
    for ref in (False, True):
        cfg = loss_config_from_args(args, ref=ref)
        for bf16 in (False, True):
            cfg = dict(cfg, nn_bf16=bf16)
            tag = f"{'ref' if ref else 'other'}/{'bf16' if bf16 else 'f32'}"
            r11, r12 = check_nn(*s2_loss_inputs(model, params, batch, cfg))
            rec[f"nn_argmin/{tag}"] = r11
            rec[f"nn_fold/{tag}"] = r12
            torch.cuda.empty_cache()
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


# K11 at shapes that stress the tensor-core kernel's layout: an odd
# C ph pw with pt = 1 (a k8 tail step, 52 x 50 patches over two warp
# tiles each way) and pt = 3 at st = 2 (rows two frames apart)
NN_LAYOUT_CASES = {"pt1_5x5": ((1, 5, 5), (1, 2, 2)),
                   "pt3_st2_7x7": ((3, 7, 7), (2, 3, 3))}


def check_nn_layouts(args, model, params, batch):
    """Phase 14 (b): K11 on bf16 inputs (the tensor-core kernel), K18 (the
    rows, /pt, as --fast_nn_dist) and K11's ssim mode where the choice has
    bit-equal candidates: the s2_setup patch's video with its frames
    repeated every 10 (y[t % 10]: temporal patch j equals patch j - 10),
    both views' configs, and at NN_LAYOUT_CASES (alpha 0 and off).  Every
    choice must be the first of its exact ties (`nn_tie_check`), K11's
    other differences from the plain version near ties (`nn_flips`,
    FLIP_LIMIT unchanged), and K18 and the ssim mode equal to their first
    designs bit for bit."""
    import torch
    from videoloop3d_torch.first_designs import (nn_argmin_first,
                                                 nn_band_argmin_first)
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    out = {}
    for ref in (True, False):
        cfg = dict(loss_config_from_args(args, ref=ref), nn_bf16=True)
        x, y, plan, alpha = s2_loss_inputs(model, params, batch, cfg)
        y = y[:, torch.arange(y.shape[1], device=DEVICE) % 10].contiguous()
        cases = {"ref" if ref else "other": (plan, alpha)}
        if ref:
            for name, (psz, strides) in NN_LAYOUT_CASES.items():
                lp = PN.lowmem_plan(x.shape[1], y.shape[1], x.shape[2],
                                    x.shape[3], psz, strides,
                                    cfg["macro_block"])
                cases[f"{name}/alpha0"] = (lp, 0.0)
                cases[f"{name}/alpha_off"] = (lp, None)
        for name, (pl, al) in cases.items():
            nn_k = PN.nn_argmin(x, y, pl, al)
            tied = nn_tie_check(f"nn_argmin {name}", y, pl, nn_k)
            _, flips, _, _, gap = nn_flips(x, y, pl, al, nn_k)
            rows, _ = PN.nn_band_argmin(x, y, pl, al, scale_by_pt=True)
            ssim = PN.nn_argmin(x, y, pl, al, "ssim")
            if not (torch.equal(rows, nn_band_argmin_first(
                    x, y, pl, al, scale_by_pt=True)[0])
                    and torch.equal(ssim, nn_argmin_first(x, y, pl, al,
                                                          "ssim"))):
                raise AssertionError(f"{name}: K18 or the ssim mode differs "
                                     "from its first design on exact ties")
            out[name] = {"queries": nn_k.numel(), "on_exact_ties": tied,
                         "index_flips": int(flips.sum()),
                         "flip_gap_rel_term_scale": gap,
                         "frame_pitch_ncb_smem": PN.mma_layout(
                             pl, x.shape[0]),
                         "nn_band_argmin_on_exact_ties": nn_tie_check(
                             f"nn_band_argmin {name}", y, pl, rows),
                         "nn_argmin_ssim_on_exact_ties": nn_tie_check(
                             f"nn_argmin_ssim {name}", y, pl, ssim)}
    print(json.dumps({"kernel_check": "nn_argmin/bf16, nn_band_argmin and "
                      "nn_argmin_ssim: exact ties and layout cases", **out}),
          flush=True)


def s2_route(model, route, n_slots):
    """Put the stage-2 model on the shipped route (--compact_hits at
    n_slots slots, --fused_render) or on the unfused, uncompacted one."""
    import dataclasses
    shipped = route == "shipped"
    model.cfg = dataclasses.replace(model.cfg, fused_render=shipped)
    model.compact_slots = n_slots if shipped else None


def fused_s2_inputs(model, params, sweep):
    """K14/K15's inputs for one view's (S, h, w) sweep (k_s, k_d, fu, fv,
    valid, zview), as the training render makes them: the samples of the
    f32 static and dynamic atlases gathered as bf16, the masks and the
    masked reciprocal depth."""
    import torch
    from videoloop3d_torch.render import renderer as R
    k_s, k_d, fu, fv, valid, zview = sweep
    with torch.no_grad():
        vals_s, hit_s = R.sample_sparse(
            params["atlas"].contiguous(), k_s, fu, fv, model.gather_dtype)
        vals_d, hit_d = R.sample_sparse(
            params["atlas_dyn"].contiguous(), k_d, fu, fv,
            model.gather_dtype)
    ins = (vals_s, valid & hit_s, vals_d, hit_d, valid & hit_d)
    return ins, model._dinv(valid, zview).contiguous()


def fused_s2_ops(cfg, n_sp, n_dyn, F, backward):
    """Operations that the fused stage-2 function needs on this run's data
    (n_sp slot-pixels, n_dyn of them dynamic, F frames), each sample
    decoded once: a decode (4 sigmoids of 4 operations, 3 mask products,
    the alpha select: 20) per dynamic (slot, pixel, frame) and per static
    (slot, pixel).  The forward adds per (slot, pixel, frame) the composite
    (10: the blend weight, 3 products and 4 sums into out and alpha_sum,
    T *= 1 - a), the disparity (2), the sparsity sums (4) and, per smoothed
    channel, its right and down differences (2 x subtract, abs, add).  The
    backward adds per (slot, pixel, frame) the transmittance (2), the
    sparsity sums (4) and their terms (5), g_i (6, 8 with the disparity),
    da, dT and the rgb products (10), per smoothed channel the two
    differences and their signs (4) and their combination (6), and the
    sigmoid derivative (4 per channel) per dynamic (slot, pixel, frame),
    or the frame sum (4) per static (slot, pixel, frame) and one
    derivative per static (slot, pixel)."""
    n = n_sp * F
    n_stat = n_sp - n_dyn
    ch = 3 * cfg.use_rgb_smooth + cfg.use_a_smooth
    decode = 20 * (n_dyn * F + n_stat)
    if not backward:
        return decode + n * (10 + 2 * cfg.want_disp + 4 * cfg.use_sparsity
                             + 6 * ch)
    return (decode + n * (2 + 9 * cfg.use_sparsity + 6 + 2 * cfg.want_disp
                          + 10 + 10 * ch)
            + 16 * n_dyn * F + 4 * n_stat * F + 16 * n_stat)


def check_static_tiles_s2(model, params, sweep):
    """Phase 15 (b): K2 and K9 on the static atlas at the shipped step's
    compacted samples (the (S, h, w) sweep at the slot bound), as the
    --fp16 step runs them: K2 on the f32 atlas gathered as bf16, bit for
    bit K2 on the bf16 copy; K9 in f32 within 1e-5 * max|g| of its plain
    version and of its first design; K9 rounding its sums to bf16 (the
    path), every value a bf16 value within one bf16 step of the old chain
    (zero fill, first design, cast to bf16 and widened back); K9's
    rounding pass bit for bit ``.to(bf16).float()`` of the f32 sums.  K2
    and K9 timed in turns beside K2 on the copy and K9's first design, and
    beside the copy and the old chain.  Returns the records."""
    import torch
    from videoloop3d_torch.first_designs import bilinear_tiles_grad_first
    from videoloop3d_torch.render import sample as S

    bf16 = torch.bfloat16
    atlas = params["atlas"].detach().contiguous()
    copy = atlas.to(bf16)
    N, th, tw, C = atlas.shape
    k = sweep[0].contiguous()
    u = (sweep[2] * (tw - 1)).contiguous()
    v = (sweep[3] * (th - 1)).contiguous()
    vs, _ = S.bilinear_tiles(atlas, k, u, v, bf16)
    vc, _ = S.bilinear_tiles(copy, k, u, v)
    k2_equal = bool(torch.equal(vs.view(torch.int32), vc.view(torch.int32)))
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    ct = torch.randn(k.shape + (C,), generator=gen, device=DEVICE)
    gargs = (ct, k, u, v, atlas.shape)
    g9 = S.bilinear_tiles_grad(*gargs)
    p9 = S.bilinear_tiles_grad_plain(*gargs)
    f9 = bilinear_tiles_grad_first(*gargs)
    scale = float(p9.abs().max())
    e9, e9_first = max_err(g9, p9) / scale, max_err(g9, f9) / scale
    rnd = S.bilinear_tiles_grad(*gargs, bf16)
    chain = f9.to(bf16).float()
    mag = torch.maximum(rnd.abs(), chain.abs())
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    within_step = bool(((rnd - chain).abs() <= step + 1e-6 * scale).all())
    del mag, step
    is_bf16 = bool(torch.equal(rnd, rnd.to(bf16).float()))
    # the rounding pass over all tiles and over the tiles the samples
    # read (the scatter's flags; the other tiles hold zeros)
    flags = (torch.bincount(k[k >= 0].clamp(max=N - 1).long(), minlength=N)
             > 0).to(torch.uint8)
    cast = g9.to(bf16).float().view(torch.int32)
    pass_equal = bool(torch.equal(S.round_bf16_(g9.clone()).view(
        torch.int32), cast)) and bool(torch.equal(S.round_bf16_(
            g9.clone(), flags).view(torch.int32), cast))
    if not (k2_equal and e9 <= 1e-5 and e9_first <= 1e-5 and within_step
            and is_bf16 and pass_equal):
        raise AssertionError(
            f"static tiles at the shipped step disagree: K2 f32 as bf16 "
            f"{k2_equal}, K9 {e9}, first design {e9_first}, rounded within "
            f"a bf16 step {within_step}, bf16 values {is_bf16}, rounding "
            f"pass {pass_equal}")
    del vs, vc, p9, f9, chain, cast, flags
    n = k.numel()
    hits = int((k >= 0).sum())
    used = torch.unique(k[k >= 0]).numel()
    texel = th * tw * C * 4

    def old_chain():
        """What the redesign replaced: the zero fill and the first design,
        the sums cast to bf16 and widened back by the copy's backward."""
        return bilinear_tiles_grad_first(*gargs).to(bf16).float()

    k2_ms, k2_copy_ms, k2_turns = ms_in_turns(
        lambda: S.bilinear_tiles(atlas, k, u, v, bf16),
        lambda: S.bilinear_tiles(copy, k, u, v), 20)
    ms, first_ms, turns = ms_in_turns(
        lambda: S.bilinear_tiles_grad(*gargs, bf16),
        lambda: bilinear_tiles_grad_first(*gargs), 20)
    new_ms, chain_ms, chain_turns = ms_in_turns(
        lambda: S.bilinear_tiles_grad(*gargs, bf16), old_chain, 20)
    return {
        "bilinear_tiles/f32 as bf16": dict(
            max_abs_err=0.0, equal_to_bf16_copy=k2_equal, samples=n,
            hits=hits, tiles=N, ms=k2_ms, bf16_copy_ms=k2_copy_ms,
            ms_in_turns=k2_turns, copy_ms=cuda_ms(lambda: atlas.to(bf16),
                                                  20),
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(
                atlas, k, u, v, bf16), 3),
            bound=bound_ms(n * 4 + hits * 8 + used * texel + n * C * 4,
                           hits * (9 * C + 10))),
        "bilinear_tiles_grad": dict(
            max_abs_err=max_err(g9, S.bilinear_tiles_grad_plain(*gargs)),
            max_rel_err=e9, first_design_max_rel_err=e9_first,
            rounded_within_bf16_step_of_old_chain=within_step,
            rounded_values_are_bf16=is_bf16,
            rounding_pass_equals_cast=pass_equal,
            vector_floats=S._vec_width(C, ct, g9), samples=n, hits=hits,
            tiles=N, tiles_used=used,
            ms=ms, first_design_ms=first_ms, ms_in_turns=turns,
            f32_ms=cuda_ms(lambda: S.bilinear_tiles_grad(*gargs), 20),
            redesign_beside_old_chain_ms=new_ms,
            replaced_chain_ms=chain_ms, chain_ms_in_turns=chain_turns,
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_grad_plain(
                *gargs, bf16), 3),
            library_ms=None,
            bound=bound_ms(n * 4 + hits * (8 + C * 4) + N * texel,
                           hits * (8 * C + 10)))}


def compact_cases(seed=13):
    """K13 on random (D, 90, 161) sweeps at D = 1, 32, 33 and 128 and S =
    1, 15 and D: hits at a random share of (plane, pixel)s, a band of
    pixels that miss every plane and one that hits every plane (more than
    S hits where S < D), a partial last block of pixels; equal to its
    plain version and its first design array for array, its layout the
    kernel's.  Returns {case: [max hits, pixels with more than S hits]}."""
    import torch
    from videoloop3d_torch.first_designs import compact_sweep_first
    from videoloop3d_torch.render import compact as CP

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {}
    h, w = 90, 161
    for D in (1, 32, 33, 128):
        for S in sorted({1, min(15, D), D}):
            hit = torch.rand((D, h, w), generator=gen, device=DEVICE) < 0.3
            hit[:, :10] = False
            hit[:, 10:20] = True
            kind = torch.randint(0, 3, (D, h, w), generator=gen,
                                 device=DEVICE)
            k = torch.randint(0, 9000, (D, h, w), generator=gen,
                              device=DEVICE, dtype=torch.int32)
            k_s = torch.where(hit & (kind != 1), k, -1).int()
            k_d = torch.where(hit & (kind != 0), k + 1, -1).int()
            fu, fv, z = (torch.randn((D, h, w), generator=gen, device=DEVICE)
                         for _ in range(3))
            valid = torch.rand((D, h, w), generator=gen, device=DEVICE) < 0.8
            sweep = (k_s, k_d, fu, fv, valid, z)
            got = CP.compact_sweep(*sweep, S)
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(got,
                                          CP.compact_sweep_plain(*sweep, S),
                                          compact_sweep_first(*sweep, S))) \
                    or CP.kernel_compact_layout(D, S) \
                    != CP.compact_layout(D, S):
                raise AssertionError(f"compact_sweep at D={D}, S={S} differs "
                                     "from its plain version, its first "
                                     "design or its layout")
            n = hit.sum(0)
            out[f"D{D}_S{S}"] = [int(n.max()), int((n > S).sum())]
    return out


def check_shipped_kernels(model, params, batch):
    """Phase 15: K13, K14 and K15 against their plain versions on the card
    at the shipped route's shapes (the s2_setup patch at its slot bound S,
    the samples of the bf16 tiles at slot volume, random cotangents), with
    CUDA-event times and bounds.  K13 must equal its plain version and its
    first design (vl3d_compact_sweep_first) array for array, there and on
    random sweeps (`compact_cases`), with its layout the kernel's, and is
    timed in turns beside its first design; K14
    within 1e-6 (outputs) and 2e-5 relative (the regularizer sums, summed
    in another order) and bit for bit its first design's
    (vl3d_fused_s2_fwd_first); K15 within 2e-5 * max|g| and bit for bit
    its first design's (vl3d_fused_s2_bwd_first); both rerun bit for bit,
    at S and again uncompacted at S = D.  K14, K15 and their first
    designs are timed in turns with the shipped flags and, for the
    attribution, with every term on and every term off.  Returns
    (records, S)."""
    import torch
    from videoloop3d_torch.first_designs import (compact_sweep_first,
                                                 fused_s2_bwd_first,
                                                 fused_s2_fwd_first)
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.render import fused as FU
    from videoloop3d_torch.render import renderer as R

    g = model.geom
    h, w = S2_PATCH
    P = h * w
    D = g.n_planes
    maps = (model.tile_map_static, model.tile_map_dyn)
    n_slots = CP.slot_bound(g, *maps, batch["extrin"].cpu().numpy(),
                            batch["intrin"].cpu().numpy(), h, w)
    if not n_slots < D:
        raise AssertionError(f"slot bound {n_slots} of D={D}: no compaction")
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    coords, k_s, k_d, fu, fv = R.warp_lookup(G, *maps, h, w,
                                             (g.mpi_h, g.mpi_w), g.tile_span)
    sweep = (k_s[0], k_d[0], fu[0], fv[0], coords.valid[0], coords.zview[0])
    cs = CP.compact_sweep(*sweep, n_slots)
    ps = CP.compact_sweep_plain(*sweep, n_slots)
    if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(
            cs, ps, compact_sweep_first(*sweep, n_slots))):
        raise AssertionError("compact_sweep differs from its plain version "
                             "or its first design")
    hits = (k_s[0] >= 0) | (k_d[0] >= 0)
    kept = int(torch.minimum(hits.sum(0), torch.tensor(n_slots,
                                                       device=DEVICE)).sum())
    ms, first_ms, turns = ms_in_turns(
        lambda: CP.compact_sweep(*sweep, n_slots),
        lambda: compact_sweep_first(*sweep, n_slots), 20)
    rec = {"compact_sweep": dict(
        max_abs_err=0.0, slots=n_slots, planes=D,
        max_hits=int(hits.sum(0).max()), mean_hits=float(hits.sum(0)
                                                         .float().mean()),
        equal_to_first_design=True, layout=CP.compact_layout(D, n_slots),
        ms=ms, first_design_ms=first_ms, ms_in_turns=turns,
        plain_ms=cuda_ms(lambda: CP.compact_sweep_plain(*sweep, n_slots), 5),
        library_ms=None,
        bound=bound_ms(D * P * 8 + kept * 13 + n_slots * P * 21, 0),
        random_sweeps=compact_cases())}

    rec.update(check_static_tiles_s2(model, params, cs))
    c = model.cfg
    shipped = FU.FusedCfg(D, c.sparsity_on, c.rgb_smooth_on, c.a_smooth_on,
                          c.d_smooth_on)
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    # at the slot bound (the main path's shapes, timed below), then
    # uncompacted at S = D (--fused_render alone): the longest T_in sweep
    checks = {}
    for slots, sw in ((n_slots, cs), (D, sweep)):
        ins, dinv = fused_s2_inputs(model, params, sw)
        F = ins[2].shape[3]
        cts = [torch.randn(shp, generator=gen, device=DEVICE)
               for shp in ((h, w, F, 3), (h, w, F), (h, w, F), (3,))]
        worst = []
        for cfg in (FU.FusedCfg(D, True, True, True, True), shipped):
            dv = dinv if cfg.want_disp else None
            k14 = FU.fused_s2_fwd(cfg, *ins, dv)
            p14 = FU.fused_composite_fwd_plain(cfg, *ins, dv)
            e14 = max(max_err(a, b) for a, b in zip(k14[:3], p14[:3]))
            r14 = float(((k14[3] - p14[3]).abs()
                         / p14[3].abs().clamp(min=1e-30)).max())
            del p14
            f14 = fused_s2_fwd_first(cfg, *ins, dv)
            first14 = all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(k14, f14))
            del f14
            k15 = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
            p15 = FU.fused_composite_bwd_plain(cfg, *ins, dv, *cts)
            a15 = max(max_err(a, b) for a, b in zip(k15, p15))
            e15 = max(max_err(a, b) / float(b.abs().max())
                      for a, b in zip(k15, p15))
            del p15
            f15 = fused_s2_bwd_first(cfg, *ins, dv, *cts)
            first = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(k15, f15))
            del f15
            again = FU.fused_s2_fwd(cfg, *ins, dv)
            again_b = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
            rerun = all(torch.equal(a, b) for a, b in zip(k14 + k15,
                                                          again + again_b))
            if not (e14 <= 1e-6 and r14 <= 2e-5 and e15 <= 2e-5 and rerun
                    and first and first14):
                raise AssertionError(
                    f"fused_s2 kernels disagree (S={slots}, {cfg}): {e14} "
                    f"{r14} {e15}, rerun equal {rerun}, K15 equal to its "
                    f"first design {first}, K14 {first14}")
            del k14, k15, again, again_b
            torch.cuda.empty_cache()
            worst.append((e14, r14, a15, e15, rerun))
        cols = list(zip(*worst))         # the worst of the two flag sets
        checks[slots] = tuple(max(c) for c in cols[:4]) + (all(cols[4]),)
        if slots == n_slots:
            main_ins, main_dinv, main_cts = ins, dinv, cts
        del ins, dinv, cts
    ins, cts = main_ins, main_cts
    dvs = main_dinv if shipped.want_disp else None
    e14, r14, a15, e15, rerun = checks[n_slots]
    at_d = dict(zip(("max_abs_err", "regs_max_rel_err", "bwd_max_abs_err",
                     "bwd_max_rel_err", "bit_for_bit_rerun"), checks[D]))
    hit_d = ins[3]
    n_dyn = int(hit_d.sum())
    n_sp = hit_d.numel()

    def fwd_bytes(cfg):
        """(reads, writes) of K14: the samples each (slot, pixel) selects,
        masks, dinv when on; out and alpha_sum, the disparity when on, the
        three sums."""
        return (n_dyn * F * 16 + (n_sp - n_dyn) * 16 + n_sp * 3
                + (n_sp * 4 if cfg.want_disp else 0),
                P * F * (16 + 4 * cfg.want_disp) + 12)

    def bwd_bound(cfg):
        """K15's bound: K14's reads, the cotangents read like K14's
        outputs written, the texel cotangents (S, h, w, F, 4) and (S, h, w,
        4) f32 written."""
        return bound_ms(sum(fwd_bytes(cfg)) + n_sp * F * 16 + n_sp * 16,
                        fused_s2_ops(cfg, n_sp, n_dyn, F, True))

    def fwd_bound(cfg):
        reads, writes = fwd_bytes(cfg)
        return bound_ms(reads + writes,
                        fused_s2_ops(cfg, n_sp, n_dyn, F, False))

    # K14 and its first design in turns (bit for bit above): the shipped
    # flags, every term on, every term off
    flag_sets = (("shipped", shipped),
                 ("all on", FU.FusedCfg(D, True, True, True, True)),
                 ("all off", FU.FusedCfg(D, False, False, False, False)))
    fwd_flags = {}
    for tag, cfg in flag_sets:
        dv = main_dinv if cfg.want_disp else None
        k14 = FU.fused_s2_fwd(cfg, *ins, dv)
        f14 = fused_s2_fwd_first(cfg, *ins, dv)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k14, f14)):
            raise AssertionError(f"fused_s2_fwd ({tag} flags) differs from "
                                 "its first design")
        del k14, f14
        ms, first_ms, turns = ms_in_turns(
            lambda: FU.fused_s2_fwd(cfg, *ins, dv),
            lambda: fused_s2_fwd_first(cfg, *ins, dv), 20)
        fwd_flags[tag] = {"flags": cfg.flags(), "ms": ms,
                          "first_design_ms": first_ms, "ms_in_turns": turns,
                          "bound_ms": fwd_bound(cfg)[0]}
    fwd_layout = FU.fused_s2_fwd_layout(n_slots, F)
    if FU.kernel_fused_s2_fwd_layout(n_slots, F) != fwd_layout:
        raise AssertionError("fused_s2_fwd_layout differs from the kernel's")
    rec["fused_s2_fwd"] = dict(
        max_abs_err=e14, regs_max_rel_err=r14, bit_for_bit_rerun=rerun,
        equal_to_first_design=True,
        first_design="csrc/fused_s2.cu:vl3d_fused_s2_fwd_first",
        slots=n_slots, planes=D, at_slots_D=at_d, layout=fwd_layout,
        ms=fwd_flags["shipped"]["ms"],
        first_design_ms=fwd_flags["shipped"]["first_design_ms"],
        by_flags=fwd_flags,
        plain_ms=cuda_ms(lambda: FU.fused_composite_fwd_plain(
            shipped, *ins, dvs), 3),
        library_ms=None, bound=fwd_bound(shipped))
    # K15 and its first design in turns: the shipped flags, then (the
    # attribution) every term on and every term off
    by_flags = {}
    for tag, cfg in flag_sets:
        dv = main_dinv if cfg.want_disp else None
        k15 = FU.fused_s2_bwd(cfg, *ins, dv, *cts)
        f15 = fused_s2_bwd_first(cfg, *ins, dv, *cts)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(k15, f15)):
            raise AssertionError(f"fused_s2_bwd ({tag} flags) differs from "
                                 "its first design")
        del k15, f15
        ms, first_ms, turns = ms_in_turns(
            lambda: FU.fused_s2_bwd(cfg, *ins, dv, *cts),
            lambda: fused_s2_bwd_first(cfg, *ins, dv, *cts), 20)
        by_flags[tag] = {"flags": cfg.flags(), "ms": ms,
                         "first_design_ms": first_ms, "ms_in_turns": turns,
                         "bound_ms": bwd_bound(cfg)[0]}
    rec["fused_s2_bwd"] = dict(
        max_abs_err=a15, max_rel_err=e15, bit_for_bit_rerun=rerun,
        equal_to_first_design=True,
        first_design="csrc/fused_s2.cu:vl3d_fused_s2_bwd_first",
        slots=n_slots, planes=D, at_slots_D=at_d,
        layout=FU.fused_s2_bwd_layout(n_slots, F),
        ms=by_flags["shipped"]["ms"],
        first_design_ms=by_flags["shipped"]["first_design_ms"],
        by_flags=by_flags,
        plain_ms=cuda_ms(lambda: FU.fused_composite_bwd_plain(
            shipped, *ins, dvs, *cts), 3),
        library_ms=None, bound=bwd_bound(shipped))
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2 shipped", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec, n_slots


def make_plain_fused_s2():
    """render.fused.fused_composite made of the plain forward and backward,
    for the plain composition of a shipped-route step (phase 16)."""
    import torch
    from videoloop3d_torch.render import fused as FU

    class PlainFusedS2(torch.autograd.Function):
        @staticmethod
        def forward(ctx, cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
            ctx.cfg = cfg
            ctx.save_for_backward(vals_s, m_s, vals_d, hit_d, m_d, dinv)
            return FU.fused_composite_fwd_plain(cfg, vals_s, m_s, vals_d,
                                                hit_d, m_d, dinv)

        @staticmethod
        def backward(ctx, *grads):
            d_s, d_d = FU.fused_composite_bwd_plain(
                ctx.cfg, *ctx.saved_tensors, *(t.contiguous() for t in grads))
            return None, d_s, None, d_d, None, None, None

    def fused(cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv):
        return FU.select_outputs(cfg, *PlainFusedS2.apply(
            cfg, vals_s, m_s, vals_d, hit_d, m_d, dinv))
    return fused


def make_plain_tile_sample():
    """renderer.sample_sparse made of the plain versions: the plain sample
    forward at the gather dtype, the plain f32 gradient rounded once to the
    gather dtype backward (the kernels' rounding) and returned in the
    tiles' dtype and, where the coordinates require grad (4-D tiles), K23's
    plain version on the texels at the gather dtype (the clip's 0.5 at
    tile edges), for the plain
    composition of a stage-2 step (phase 16) and of a sparse geo step
    (phase 30)."""
    import torch
    from videoloop3d_torch.render import sample as S

    class PlainTileSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tiles, k, u, v, gather):
            tiles, u, v = tiles.detach(), u.detach(), v.detach()
            ctx.save_for_backward(tiles, k, u, v)
            ctx.shape, ctx.dtype, ctx.gather = tiles.shape, tiles.dtype, \
                gather
            if tiles.dim() == 4:
                out, valid = S.bilinear_tiles_plain(tiles, k, u, v, gather)
            else:
                out, valid = S.bilinear_tiles_tilemajor_plain(
                    tiles, k, u, v, None, gather)
            ctx.mark_non_differentiable(valid)
            return out, valid

        @staticmethod
        def backward(ctx, g, _):
            tiles, k, u, v = ctx.saved_tensors
            g = g.contiguous()
            if len(ctx.shape) == 4:
                grad = S.bilinear_tiles_grad_plain(
                    g, k, u, v, ctx.shape,
                    ctx.gather if ctx.dtype == torch.float32 else None)
            else:
                grad = S.bilinear_tiles_tilemajor_grad_plain(
                    g, k, u, v, ctx.shape, ctx.gather)
            g_u = g_v = None
            if ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
                g_u, g_v = S.bilinear_tiles_coord_grad_plain(
                    g, tiles.to(ctx.gather), k, u, v)
            return grad.to(ctx.dtype), None, g_u, g_v, None

    def sample_sparse(tiles, k, fu, fv, gather_dtype=None):
        th, tw = tiles.shape[1:3]
        return PlainTileSample.apply(tiles, k, fu * (tw - 1), fv * (th - 1),
                                     gather_dtype or tiles.dtype)
    return sample_sparse


def make_old_tile_chain():
    """renderer.sample_sparse as it was before K10's redesign, for the
    comparison of phase 17: the f32 dynamic atlas copied to bf16 (an
    autograd copy, whose backward widens the gradient back to f32), K3 on
    the copy, and K10's first design (its zero fill, four atomics a corner
    and channel) with the sum cast to bf16; the static tiles as the route
    passes them."""
    import torch
    from videoloop3d_torch.first_designs import tiles_tilemajor_grad_first
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    shipped = R.sample_sparse

    class OldTileSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tiles, k, u, v):
            u, v = u.detach(), v.detach()
            ctx.save_for_backward(k, u, v)
            ctx.shape, ctx.dtype = tiles.shape, tiles.dtype
            out, valid = S.bilinear_tiles_tilemajor(tiles.detach(), k, u, v)
            ctx.mark_non_differentiable(valid)
            return out, valid

        @staticmethod
        def backward(ctx, g, _):
            k, u, v = ctx.saved_tensors
            grad = tiles_tilemajor_grad_first(g.contiguous(), k, u, v,
                                              ctx.shape)
            return grad.to(ctx.dtype), None, None, None

    def sample_sparse(tiles, k, fu, fv, gather_dtype=None):
        if tiles.dim() != 5 or gather_dtype in (None, tiles.dtype):
            return shipped(tiles, k, fu, fv, gather_dtype)
        th, tw = tiles.shape[1:3]
        return OldTileSample.apply(tiles.to(gather_dtype).contiguous(), k,
                                   fu * (tw - 1), fv * (th - 1))
    return sample_sparse


def make_old_static_chain():
    """renderer.sample_sparse as it was before K9's redesign, for the
    comparison of phase 17: the f32 static atlas copied to bf16 (an
    autograd copy, whose backward widens the gradient back to f32), K2 on
    the copy, and K9's first design (its zero fill, four scalar atomics a
    corner and channel) with the sum cast to bf16; the dynamic tiles as
    the route passes them."""
    import torch
    from videoloop3d_torch.first_designs import bilinear_tiles_grad_first
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    shipped = R.sample_sparse

    class OldStaticSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tiles, k, u, v):
            u, v = u.detach(), v.detach()
            ctx.save_for_backward(k, u, v)
            ctx.shape, ctx.dtype = tiles.shape, tiles.dtype
            out, valid = S.bilinear_tiles(tiles.detach(), k, u, v)
            ctx.mark_non_differentiable(valid)
            return out, valid

        @staticmethod
        def backward(ctx, g, _):
            k, u, v = ctx.saved_tensors
            grad = bilinear_tiles_grad_first(g.contiguous(), k, u, v,
                                             ctx.shape)
            return grad.to(ctx.dtype), None, None, None

    def sample_sparse(tiles, k, fu, fv, gather_dtype=None):
        if tiles.dim() != 4 or gather_dtype in (None, tiles.dtype):
            return shipped(tiles, k, fu, fv, gather_dtype)
        th, tw = tiles.shape[1:3]
        return OldStaticSample.apply(tiles.to(gather_dtype).contiguous(), k,
                                     fu * (tw - 1), fv * (th - 1))
    return sample_sparse


def s2_step_launches(args, model, params, batch):
    """The launch counters of one stage-2 train step on the model's route
    (ref-view config), set to 0 just before and read just after."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage2 as TS2

    cfg = TS2.loss_config_from_args(args, ref=True)
    step, opt_init = TS2.make_stage2_step(model, args, *S2_PATCH, cfg)
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = opt_init(p)
    weights = common.extra_loss_weights(args, TS2.STAGE2_WEIGHT_KEYS)
    kernels.reset_launches()
    step(p, opt, batch, 1e-3, weights, None)
    torch.cuda.synchronize()
    return dict(kernels.LAUNCHES)


def s2_step_grads(args, model, params, batch, cfg, nn_kernel=None,
                  swd_plain=None):
    """Metrics and atlas gradients of one stage-2 step (the loss of
    train/stage2.py:make_patch_loss_fn, shipped weights) on the model's
    route.  Without nn_kernel the step runs the kernels and returns K11's
    (under cfg's fast_nn_dist K18's) indices too; with nn_kernel (those
    indices) the plain versions are composed in the kernels' place, and
    where the plain search's choice differs at a near tie (`nn_flips`,
    `band_flips`) it takes the kernel's.  Under the swd loss, swd_plain
    False runs K24-K26 and True their plain versions with every other
    plain version above, and the gradients also hold that of the loss's
    input ("swd_input", f32).  Returns (metrics, gradients, K11's indices
    or the number of near ties taken, None without a search)."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.models import mpv
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage2 as TS2

    weights = common.extra_loss_weights(args, TS2.STAGE2_WEIGHT_KEYS)
    swd_saved = (SW.swd_project, SW.swd_sort_l1, SW.swd_project_grad,
                 SW.swd_3d_loss)
    swd_in = []

    def swd_capture(x, y, **kw):
        x.retain_grad()
        swd_in.append(x)
        return swd_saved[3](x, y, **kw)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    saved = (renderer.warp_lookup, renderer.sample_sparse, PN.nn_argmin,
             PN.nn_fold, mpv.compact_sweep, mpv.fused_composite,
             mpv.sample_planes_tilemajor, PN.nn_band_argmin)
    seen = []

    def kernel_nn(x, y, plan, alpha=None, dist_fn="mse"):
        seen.append(saved[2](x, y, plan, alpha, dist_fn))
        return seen[-1]

    def kernel_band(x, y, plan, alpha=None, scale_by_pt=False,
                    both_directions=False):
        out = saved[7](x, y, plan, alpha, scale_by_pt, both_directions)
        seen.append(out[0])
        return out

    def plain_nn(x, y, plan, alpha=None, dist_fn="mse"):
        if dist_fn != "mse":
            raise AssertionError("the plain step composes the mse search")
        nn_p, flips, *_ = nn_flips(x, y, plan, alpha, nn_kernel)
        seen.append(int(flips.sum()))
        return torch.where(flips, nn_kernel, nn_p)

    def plain_band(x, y, plan, alpha=None, scale_by_pt=False,
                   both_directions=False):
        nn_p, flips, *_ = band_flips(x, y, plan, alpha, nn_kernel,
                                     scale_by_pt)
        seen.append(int(flips.sum()))
        return torch.where(flips, nn_kernel, nn_p), None

    SW.swd_3d_loss = swd_capture
    if swd_plain:
        SW.swd_project, SW.swd_sort_l1, SW.swd_project_grad = (
            SW.swd_project_plain, SW.swd_sort_l1_plain,
            SW.swd_project_grad_plain)
    if nn_kernel is None and not swd_plain:
        PN.nn_argmin, PN.nn_band_argmin = kernel_nn, kernel_band
    else:
        renderer.sample_sparse = make_plain_tile_sample()
        renderer.warp_lookup = renderer.warp_lookup_plain
        PN.nn_argmin, PN.nn_fold = plain_nn, PN.nn_fold_plain
        PN.nn_band_argmin = plain_band
        mpv.compact_sweep = CP.compact_sweep_plain
        mpv.fused_composite = make_plain_fused_s2()
        mpv.sample_planes_tilemajor = make_plain_plane_sample()
    try:
        total, metrics = TS2.make_patch_loss_fn(model, args, *S2_PATCH, cfg)(
            p, batch, weights)
        total.backward()
    finally:
        (renderer.warp_lookup, renderer.sample_sparse, PN.nn_argmin,
         PN.nn_fold, mpv.compact_sweep, mpv.fused_composite,
         mpv.sample_planes_tilemajor, PN.nn_band_argmin) = saved
        (SW.swd_project, SW.swd_sort_l1, SW.swd_project_grad,
         SW.swd_3d_loss) = swd_saved
    # (a dense model's empty static atlas gets no gradient)
    grads = {k: p[k].grad for k in ("atlas", "atlas_dyn")
             if p[k].grad is not None}
    if swd_in:
        grads["swd_input"] = swd_in[0].grad
    return ({k: float(v.detach()) for k, v in metrics.items()}, grads,
            seen[0] if seen else None)


def check_s2_step(args, model, params, batch, route, fast=False):
    """Phase 16: one stage-2 step with the kernels against the same step
    made of the plain versions on the card, on the model's route, for the
    ref-view (alpha 0) and the other-view loss config under the shipped
    --fp16 (bf16 texels and NN search): metrics to 1e-5 relative,
    gradients to one bf16 ulp (2^-7 * max|g|: both sum in f32 and round
    once to bf16, in another order).  Where the plain search breaks a
    near tie otherwise than K11 (`nn_flips`), the plain step takes K11's
    choice: a flipped patch moves its voxels' targets and so their
    gradients, and K11 is held to its plain version on its own in phase
    14.  With fast (--fast_nn_dist, phase 26) the search is K18, never
    K11, held the same way (`band_flips`)."""
    from videoloop3d_torch import kernels
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    out = {}
    need = S2_ROUTES[route]
    if fast:
        need = tuple(k for k in need if k != "nn_argmin") + ("nn_band_argmin",)
    for ref in (True, False):
        cfg = dict(loss_config_from_args(args, ref=ref), fast_nn_dist=fast)
        kernels.reset_launches()
        m_k, g_k, nn_k = s2_step_grads(args, model, params, batch, cfg)
        launched = dict(kernels.LAUNCHES)
        m_p, g_p, ties = s2_step_grads(args, model, params, batch, cfg,
                                       nn_k)
        if (kernels.LAUNCHES != launched
                or any(launched[k] == 0 for k in need)
                or (fast and launched["nn_argmin"])):
            raise AssertionError(f"launches: kernel step {launched}, plain "
                                 f"step {kernels.LAUNCHES}")
        if route == "unfused" and any(launched[k] for k in SHIPPED_KERNELS):
            raise AssertionError(f"the unfused step launched {launched}")
        rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                  for k in m_p)
        grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
                   for k in g_k)
        name = "ref" if ref else "other"
        if not (rel <= 1e-5 and grel <= 2.0 ** -7):
            raise AssertionError(f"stage-2 {route} {name} step differs from "
                                 f"its plain composition: metrics {rel}, "
                                 f"grads {grel}")
        out[name] = {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
                     "near_ties_taken_from_kernel": ties,
                     "nn_queries": nn_k.numel(), "loss": m_k["loss"],
                     "swd": m_k["swd"]}
    return out


def profile_s2_step(args, model, params, batch, clone=True, cfg=None,
                    gen=None, copies=False):
    """Device busy share and device time by group of one warm stage-2
    train step on the ref-view config (or `cfg`; Adam included, draws
    from the generator gen), plus its host-clock time over 5 steps and
    the peak device memory.  With clone=False the steps update `params`
    in place (a 7 GB dense atlas is not copied).  With copies, PyTorch's
    copies, casts and fills form a group of their own."""
    import torch
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage2 as TS2

    cfg = cfg or TS2.loss_config_from_args(args, ref=True)
    step, opt_init = TS2.make_stage2_step(model, args, *S2_PATCH, cfg)
    p = {k: v.detach().clone() for k, v in params.items()} if clone \
        else params
    opt = opt_init(p)
    weights = common.extra_loss_weights(args, TS2.STAGE2_WEIGHT_KEYS)
    for _ in range(2):
        step(p, opt, batch, 1e-3, weights, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(5):
        step(p, opt, batch, 1e-3, weights, gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 200
    peak = torch.cuda.max_memory_allocated()
    by_name, wall_ms = profiled(lambda: (step(p, opt, batch, 1e-3, weights,
                                              gen),
                                         torch.cuda.synchronize()))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    device_ms = sum(ms for ms, _ in by_name.values())
    return {"step_ms_5_steps": step_ms, "profiled_wall_ms": wall_ms,
            "device_ms": device_ms, "device_busy_share": device_ms / wall_ms,
            "max_memory_allocated_GB": peak / 1e9,
            "kernel_launches": sum(n for _, n in by_name.values()),
            "groups": device_groups(by_name, copies),
            "top": [{"name": k[:60], "device_ms": ms, "calls": n}
                    for k, (ms, n) in rows[:12]]}


def drive_train_3dvid(s1_model, s1_params):
    """Phase 18: train_3dvid.main on the unmodified configs/mpv_base.txt
    (``--factor 1 --mpv_frm_num 50`` on the command line) from the cell-a
    sparse stage-1 model (written as a stage="mpi" checkpoint; it has
    dynamic tiles), on a 360x640 synthetic scene of 3 views x 50 frames:
    --pyr_init_level 4 --pyr_num_epoch 1 (levels 4 and 5 of 6: one lod
    downsample, one upsample, 12 + 27 steps), then --pyr_num_epoch 2,
    which must auto-resume at level 5, epoch 1.  Each level must print its
    hit-compaction line with S < D; every step must launch K2, K3 and
    K9-K15 once and K4 never; K1 runs once per step and once per view and
    level for the slot bound."""
    import torch
    from videoloop3d_torch.data import synthetic
    from videoloop3d_torch.tools import train_3dvid
    from videoloop3d_torch.train.stage1 import save_stage1_checkpoint

    init = os.path.join(WORK, "s2_init", "ckpt_epoch_0000.npz")
    save_stage1_checkpoint(init, s1_model, s1_params, 0)
    scene_dir = os.path.join(WORK, "s2_scene")
    n_views = 3
    scene = synthetic.make_scene(n_views=n_views, h=S1_HW[0], w=S1_HW[1],
                                 n_frames=50, seed=0)
    synthetic.write_llff_dir(scene, scene_dir, factor=1)
    del scene

    def argv(n_epoch):
        return ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
                "--factor", "1", "--datadir", scene_dir,
                "--expdir", os.path.join(WORK, "s2_runs"), "--expname", "s2",
                "--init_from", init, "--mpv_frm_num", "50",
                "--pyr_init_level", "4", "--pyr_num_epoch", str(n_epoch),
                "--i_img", "1", "--i_video", "1000"]

    def run(n_epoch, n_steps, n_levels, skip=0):
        torch.cuda.reset_peak_memory_stats()
        counts, rows, rundir, wall, out = run_train(argv(n_epoch),
                                                    train_3dvid)
        new = rows[skip:]
        loss = [(r["step"], r["value"]) for r in new
                if r["tag"] == "stage2/loss"]
        compaction = [ln for ln in out.splitlines() if "hit-compaction" in ln]
        want = {k: n_steps for k in S2_ROUTES["shipped"]}
        want["warp_lookup"] = n_steps + n_views * n_levels
        want["composite"] = 0
        bad = {k: counts[k] for k in want if counts[k] != want[k]}
        if (bad or len(loss) != n_steps or len(compaction) != n_levels
                or any("no win" in ln for ln in compaction)
                or not np.isfinite([v for _, v in loss]).all()):
            raise AssertionError(f"stage-2 run of {n_steps} steps: "
                                 f"launches {bad}, compaction {compaction}, "
                                 f"loss {loss}")
        warm = {r["tag"].split("/")[1]: r["value"] for r in new
                if "warm_step_ms" in r["tag"]}
        return rows, rundir, out, {
            "cli_wall_s": wall, "steps": n_steps, "launches": counts,
            "compaction_lines": compaction,
            "warm_step_ms": warm, "first_step": loss[0][0],
            "loss_first_last": [loss[0][1], loss[-1][1]],
            "max_memory_allocated_GB": torch.cuda.max_memory_allocated()
            / 1e9}

    rows, rundir, out, first = run(1, 39, 2)
    lines = [ln for ln in out.splitlines()
             if "no effect in the port" in ln or "--fast_stage2_grad" in ln
             or "activations" in ln]
    ckpt = os.path.join(rundir, "ckpt_l5_epoch_0000.npz")
    from videoloop3d_torch.models import checkpoint as ckpt_io
    meta = ckpt_io.load_checkpoint_meta(ckpt)
    if not (meta["stage"] == "mpv" and meta["is_sparse"]
            and meta["extra"]["pyr_i"] == 5):
        raise AssertionError(f"stage-2 checkpoint meta {meta}")
    _, _, r_out, resumed = run(2, 27, 1, skip=len(rows))
    if f"auto-resuming from {ckpt} at level 5 epoch 1" not in r_out \
            or resumed["first_step"] != 39:
        raise AssertionError("the rerun did not resume at level 5, epoch 1")
    return {k: first["launches"][k] + resumed["launches"][k]
            for k in first["launches"]}, {
        "route_lines": lines, "run": first, "resume": resumed}


def stage2_phases(s1_model, s1_params):
    """Phases 14-18.  Returns (kernel records, launches of the train_3dvid
    runs, the patch's slot bound)."""
    import torch
    args, model, params, batch = s2_setup()
    rec = check_s2_kernels(args, model, params, batch)
    check_nn_layouts(args, model, params, batch)
    rec["warp_lookup/uv noise"] = check_warp_lookup_noise(model, batch)
    shipped_rec, n_slots = check_shipped_kernels(model, params, batch)
    rec.update(shipped_rec)
    torch.cuda.empty_cache()
    for route in S2_ROUTES:
        s2_route(model, route, n_slots)
        print(json.dumps({"plain_step_check": f"stage 2, {route} route",
                          **check_s2_step(args, model, params, batch,
                                          route)}), flush=True)
    rec.update(check_band_training(args, model, params, batch))
    s2_route(model, "shipped", n_slots)
    print(json.dumps({"plain_step_check": "stage 2, shipped route, "
                      "--fast_nn_dist",
                      **check_s2_step(args, model, params, batch, "shipped",
                                      fast=True)}), flush=True)
    for route in S2_ROUTES:
        s2_route(model, route, n_slots)
        print(json.dumps({"profile": f"stage-2 step, ref view, {route} "
                          f"route (S={model.compact_slots} of D="
                          f"{model.geom.n_planes})",
                          **profile_s2_step(args, model, params, batch)}),
              flush=True)
    from videoloop3d_torch.first_designs import (nn_argmin_first,
                                                 nn_band_argmin_first)
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.train.stage2 import loss_config_from_args
    s2_route(model, "shipped", n_slots)
    print(json.dumps({"profile_compare": "stage-2 step, ref view, shipped "
                      "route: K11's first design against its redesign",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch), PN, "nn_argmin",
                          nn_argmin_first)}), flush=True)
    from videoloop3d_torch.first_designs import (fused_s2_bwd_first,
                                                 nn_fold_first)
    from videoloop3d_torch.render import fused as FU
    print(json.dumps({"profile_compare": "stage-2 step, ref view, shipped "
                      "route: K15's and K12's first designs against their "
                      "redesigns",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch), (FU, PN),
                          ("fused_s2_bwd", "nn_fold"),
                          (fused_s2_bwd_first, nn_fold_first),
                          groups=("fused_s2_", "nn_fold"))}), flush=True)
    from videoloop3d_torch.first_designs import fused_s2_fwd_first
    from videoloop3d_torch.render import renderer as R
    print(json.dumps({"profile_compare": "stage-2 step, ref view, shipped "
                      "route: K14's and K10's first designs with the old "
                      "chain of the dynamic atlas (its bf16 copy, the zero "
                      "fill, the gradient's casts) against the redesigns",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch, copies=True), (FU, R),
                          ("fused_s2_fwd", "sample_sparse"),
                          (fused_s2_fwd_first, make_old_tile_chain()),
                          groups=("fused_s2_", "tiles_", "bin_",
                                  "bilinear_tiles_tilemajor",
                                  "copy, cast and fill"),
                          memory=True)}), flush=True)
    # the static atlas: its old chain (the bf16 copy, K9's first design
    # with its zero fill, the gradient's cast and widening) against the f32
    # atlas read as bf16 by K2 and K9 rounding its sums
    print(json.dumps({"profile_compare": "stage-2 step, ref view, shipped "
                      "route: K9's first design with the old chain of the "
                      "static atlas (its bf16 copy, the zero fill, the "
                      "gradient's casts) against the redesign",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch, copies=True), R,
                          "sample_sparse", make_old_static_chain(),
                          groups=("bilinear_tiles_kernel",
                                  "bilinear_tiles_grad", "zero_grad",
                                  "round_bf16", "copy, cast and fill"),
                          memory=True)}), flush=True)
    saved = R.sample_sparse
    counts = {}
    for key, fn in (("first_design", make_old_static_chain()),
                    ("redesign", saved)):
        R.sample_sparse = fn
        try:
            counts[key] = s2_step_launches(args, model, params, batch)
        finally:
            R.sample_sparse = saved
    step_k = counts["redesign"]
    if not (step_k["bilinear_tiles"] == 1 and step_k["bilinear_tiles_grad"]
            == 1 and step_k["composite"] == 0
            and counts["first_design"]["bilinear_tiles_grad"] == 0):
        raise AssertionError(f"a shipped step's launches: {counts}")
    print(json.dumps({"step_launches": "stage-2 step, ref view, shipped "
                      "route (K9's first design adds to no count)",
                      **counts}), flush=True)
    fast = dict(loss_config_from_args(args, ref=True), fast_nn_dist=True)
    print(json.dumps({"profile_compare": "stage-2 step, ref view, shipped "
                      "route, --fast_nn_dist: K18's first design against "
                      "its redesign",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch, cfg=fast), PN,
                          "nn_band_argmin", nn_band_argmin_first)}),
          flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    counts, summary = drive_train_3dvid(s1_model, s1_params)
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt, levels 4-5",
                      **summary}), flush=True)
    fast_counts, summary = drive_train_3dvid_fast()
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt --fast_nn_dist, "
                      "levels 4-5", **summary}), flush=True)
    counts["nn_band_argmin"] = fast_counts["nn_band_argmin"]
    return rec, counts


def check_band_training(args, model, params, batch):
    """Phase 26 (a): K18 against its plain version at the stage-2 step's
    search shapes under --fast_nn_dist (the s2_setup patch, the ref view
    at alpha 0 and the other view at alpha off, f32 and bf16 inputs; the
    banded sums divided by pt), timed with bounds and library times.
    Returns the records."""
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    rec = {}
    for ref in (True, False):
        for bf16 in (True, False):
            cfg = dict(loss_config_from_args(args, ref=ref), nn_bf16=bf16)
            x, y, plan, alpha = s2_loss_inputs(model, params, batch, cfg)
            r, _ = check_band(x, y, plan, alpha, scale_by_pt=True)
            tag = f"{'ref' if ref else 'other'}/{'bf16' if bf16 else 'f32'}"
            rec[f"nn_band_argmin/train/{tag}"] = r
            print(json.dumps({"kernel": f"nn_band_argmin, stage 2 {tag}",
                              **r}), flush=True)
    return rec


def drive_train_3dvid_fast():
    """Phase 26 (b): train_3dvid.main with --fast_nn_dist on phase 18's
    setup (the unmodified configs/mpv_base.txt from the same sparse
    stage-1 checkpoint and scene, --pyr_init_level 4 --pyr_num_epoch 1:
    levels 4 and 5, 12 + 27 steps), with the launch counters set to 0
    just before and read just after: K18 and K12 once per step (one loss
    view a step), K11 never, the shipped route's kernels once per step,
    finite losses.  Returns (launches, summary)."""
    from videoloop3d_torch.tools import train_3dvid

    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2_runs"), "--expname", "s2fast",
            "--init_from", os.path.join(WORK, "s2_init", "ckpt_epoch_0000.npz"),
            "--mpv_frm_num", "50", "--pyr_init_level", "4",
            "--pyr_num_epoch", "1", "--fast_nn_dist", "--i_img", "1",
            "--i_video", "1000"]
    counts, rows, rundir, wall, _ = run_train(argv, train_3dvid)
    loss = [r["value"] for r in rows if r["tag"] == "stage2/loss"]
    n = len(loss)
    want = {k: n for k in S2_ROUTES["shipped"] if k != "nn_argmin"}
    # K1 also once per view and level for the slot bound
    want.update(nn_band_argmin=n, nn_argmin=0, composite=0,
                warp_lookup=n + 3 * 2)
    bad = {k: counts[k] for k in want if counts[k] != want[k]}
    if bad or n != 39 or not np.isfinite(loss).all():
        raise AssertionError(f"--fast_nn_dist run: launches {bad}, loss "
                             f"{loss}")
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    shutil.rmtree(rundir, ignore_errors=True)
    return counts, {"cli_wall_s": wall, "steps": n, "launches": counts,
                    "warm_step_ms": warm, "loss_first_last": [loss[0],
                                                              loss[-1]]}


def check_warp_lookup_noise(model, batch):
    """Phase 19: K1 with uv-noise draws (--add_uv_noise on the sparse
    routes) against its plain version, bit for bit, at the s2_setup
    patch's shapes; without draws K1 still equals its plain version bit
    for bit.  Returns the record (time with draws, bound)."""
    import torch
    from videoloop3d_torch.render import renderer as R

    g = model.geom
    h, w = S2_PATCH
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    k1_args = (G, model.tile_map_static, model.tile_map_dyn, h, w,
               (g.mpi_h, g.mpi_w), g.tile_span)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    nx, ny = R.texel_noise(gen, (1, g.n_planes, h, w))
    same = {}
    for tag, extra in (("no noise", ()), ("noise", (nx, ny))):
        got = R.warp_lookup(*k1_args, *extra)
        ref = R.warp_lookup_plain(*k1_args, *extra)
        same[tag] = all(torch.equal(a, b) for a, b in zip(
            list(got[0]) + list(got[1:]), list(ref[0]) + list(ref[1:])))
    moved = int((got[1] != R.warp_lookup(*k1_args)[1]).sum())
    if not all(same.values()) or not moved:
        raise AssertionError(f"warp_lookup with noise: bit-equal {same}, "
                             f"{moved} samples moved to another tile")
    n1 = G.shape[1] * h * w
    rec = dict(max_abs_err=0.0, bit_equal=same, samples_moved_tile=moved,
               ms=cuda_ms(lambda: R.warp_lookup(*k1_args, nx, ny), 20),
               plain_ms=cuda_ms(lambda: R.warp_lookup_plain(*k1_args, nx,
                                                            ny), 5),
               library_ms=None,
               bound=bound_ms(G.numel() * 4 + 2 * model.tile_map_static
                              .numel() * 4 + n1 * 37, n1 * 27))
    r = dict(rec)
    b, by = r.pop("bound")
    print(json.dumps({"kernel_check": "warp_lookup/uv noise, stage 2", **r,
                      "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def dense_s2_setup(seed=7):
    """A dense stage-2 model of the shipped config (configs/mpv_base.txt,
    --factor 1, F = 50, --fp16) at the scratch geometry of the 360x640
    scene (396x704 texel planes, D = 32) on the card, with a random atlas
    made there (colours N(0, 1), alpha N(-2, 1) before the sigmoids: every
    plane partly visible), and one batch as the trainer feeds it: a
    180x320 patch at the centre of the view, 0.05 to the side of the
    reference camera, with a random target video."""
    import torch
    from videoloop3d_torch.models.mpv import MPMeshVid

    args = s2_args()
    H, W = S1_HW
    ph, pw = S2_PATCH
    focal = 0.9 * W
    intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                      np.float32)
    model = MPMeshVid(args, H, W, np.eye(4, dtype=np.float32), intrin, 2.0,
                      10.0, device=DEVICE)
    g = model.geom
    if (g.n_planes, g.mpi_h, g.mpi_w, model.frm_num) != (32, 396, 704, 50):
        raise AssertionError(f"dense geometry {g}")
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dyn = torch.randn((g.n_planes, g.mpi_h, g.mpi_w, model.frm_num, 4),
                      generator=gen, device=DEVICE)
    dyn[..., 3] -= 2.0
    params = {"atlas": torch.zeros((0, 1, 1, 4), device=DEVICE),
              "atlas_dyn": dyn,
              "verts": torch.from_numpy(g.vertex_grid()).to(DEVICE)}
    ext = np.eye(4, dtype=np.float32)[None]
    ext[:, 0, 3] = 0.05
    pi = intrin.copy()
    pi[0, 2] -= (W - pw) / 2
    pi[1, 2] -= (H - ph) / 2
    batch = {"extrin": torch.as_tensor(ext, device=DEVICE),
             "intrin": torch.as_tensor(pi[None], device=DEVICE),
             "video": torch.rand((model.frm_num, ph, pw, 3), generator=gen,
                                 device=DEVICE)}
    return args, model, params, batch, intrin


def planes_touched(x, y, Ht, Wt):
    """Texels (plane, row, column) that the bilinear corners inside the
    plane read, for (D, N) coordinates: each counted once."""
    import torch
    D = x.shape[0]
    x0 = torch.floor(x).clamp(-2, Wt).long()
    y0 = torch.floor(y).clamp(-2, Ht).long()
    dd = torch.arange(D, device=x.device)[:, None]
    idx = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
        idx.append(((dd * Ht + yi) * Wt + xi)[inside])
    return torch.unique(torch.cat(idx)).numel()


def bf16_steps_beyond(a, b, slack=0.0):
    """The number of values of a further than one bf16 step (at the larger
    magnitude) plus `slack` from b's."""
    import torch
    mag = torch.maximum(a.abs(), b.abs())
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return int(((a - b).abs() > step + slack).sum())


def check_planes_layout():
    """K17's layout: render/sample.py:planes_grad_layout against the
    kernel's own (vl3d_planes_grad_layout) at the shapes phases 20 and 38
    launch and the widest channel count, every vector width."""
    from videoloop3d_torch.render import sample as S
    checked = []
    for D, n, Ht, Wt, F, C in ((32, 57600, 396, 704, 50, 4),
                               (32, 57600, 396, 704, 10, 13),
                               (32, 57600, 396, 704, 50, 36)):
        for vec in (4, 2, 1):
            if F * C % vec:
                continue
            lay = S.planes_grad_layout(D, n, Ht, Wt, F, C, vec)
            got = S.kernel_planes_grad_layout(D, n, Ht, Wt, F, C, vec)
            if got != {k: lay[k] for k in S.PLANES_GRAD_LAYOUT_KEYS}:
                raise AssertionError(f"K17 layout at {(F, C, vec)}: python "
                                     f"{lay}, kernel {got}")
            checked.append([F, C, vec, lay["smem"]])
    return checked


def check_dense_kernels(model, params, batch, intrin):
    """Phase 20: K16 and K17 against their plain versions and their first
    designs on the card at the dense stage-2 shapes of the (32, 396, 704,
    50, 4) stack: K16 on f32 texels, bf16 texels and the f32 atlas
    gathered as bf16 (the main path under --fp16), at the training patch
    (180x320 samples per plane, all frames) and an eval chunk (the whole
    360x640 view, frames 20-29 through ts), bit for bit equal to the plain
    version and to the first design (on the bf16 copy for the rounding
    mode); K17 in f32 within 1e-5 * max|g| of the plain version and of the
    first design (atomics), in the bf16-rounding mode bit for bit the f32
    mode's sums rounded to bf16 (so within one bf16 step plus that
    tolerance of the plain sums' rounding), and two launches bit for bit
    equal in both modes.  Timed with CUDA events
    beside their bounds, the first designs, the plain versions and
    torch.nn.functional.grid_sample (align_corners=True, zeros padding)
    on a (D, F*C, Ht, Wt) copy of the texels made outside the timing (for
    K17 grid_sample's input gradient), and each rounding mode beside the
    chain it replaces (the bf16 copy and the first design; the zero fill,
    the first design and the two casts).  Returns the records."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.first_designs import (
        bilinear_planes_tilemajor_first, bilinear_planes_tilemajor_grad_first)
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    print(json.dumps({"layout_check": "K17 planes_grad_layout against "
                      "vl3d_planes_grad_layout ([F, C, vec, smem])",
                      "checked": check_planes_layout()}), flush=True)
    g = model.geom
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    F, C = model.frm_num, 4
    H, W = S1_HW
    bf16 = torch.bfloat16
    coords = R.warp_coordinates(g, batch["extrin"], batch["intrin"],
                                *S2_PATCH)
    # (D, h, w) coordinates for K16, as the dense render passes them (the
    # training patch's samples then go by image tiles); flat for K17
    x3, y3 = coords.x[0].contiguous(), coords.y[0].contiguous()
    x, y = x3.reshape(D, -1), y3.reshape(D, -1)
    full = R.warp_coordinates(g, batch["extrin"],
                              torch.as_tensor(intrin[None], device=DEVICE),
                              H, W)
    xe3, ye3 = full.x[0].contiguous(), full.y[0].contiguous()
    xe, ye = xe3.reshape(D, -1), ye3.reshape(D, -1)
    ts = torch.arange(20, 30, dtype=torch.int32, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    ct = torch.randn(x.shape + (F, C), generator=gen, device=DEVICE)
    n, ne = x.numel(), xe.numel()
    touched = planes_touched(x, y, Ht, Wt)
    touched_e = planes_touched(xe, ye, Ht, Wt)
    atlas = params["atlas_dyn"].detach()
    shape = tuple(atlas.shape)

    def grid_of(xx, yy, hw):
        return torch.stack([xx / (Wt - 1) * 2 - 1, yy / (Ht - 1) * 2 - 1],
                           -1).reshape((D,) + hw + (2,)).contiguous()

    def gs(t, gr):
        return TF.grid_sample(t, gr, mode="bilinear", padding_mode="zeros",
                              align_corners=True)

    rec = {}
    # K16: (mode, texels as stored, gather dtype, library dtype)
    for tag, dtype, gather in (("f32", torch.float32, None),
                               ("bf16", bf16, None),
                               ("f32 as bf16", torch.float32, bf16)):
        tex = atlas if dtype == torch.float32 else atlas.to(bf16)
        first_tex = tex if gather is None else tex.to(bf16)
        ldt = gather or dtype
        item = tex.element_size()
        for part, (xx, yy, tt, nn_, tch, hw, frames) in (
                ("", (x3, y3, None, n, touched, S2_PATCH, range(F))),
                ("/eval chunk", (xe3, ye3, ts, ne, touched_e, (H, W),
                                 range(20, 30)))):
            nf = len(frames)
            got = S.bilinear_planes_tilemajor(tex, xx, yy, tt, gather)
            e16 = max_err(got, S.bilinear_planes_tilemajor_plain(
                tex, xx, yy, tt, gather))
            first_eq = bool(torch.equal(got, bilinear_planes_tilemajor_first(
                first_tex, xx, yy, tt)))
            # the library's layout (in the gathered dtype), made once here
            # and not timed; grid_sample takes its grid in that dtype
            lib = first_tex[..., frames.start:frames.stop, :].permute(
                0, 3, 4, 1, 2).reshape(D, nf * C, Ht, Wt).contiguous()
            grid = grid_of(xx, yy, hw).to(ldt)
            gs_diff = None
            if ldt == torch.float32 and not part:
                gs_diff = max_err(got.reshape(D, -1, F, C),
                                  gs(lib, grid).reshape(D, F, C, -1)
                                  .permute(0, 3, 1, 2))
            del got
            r = dict(
                max_abs_err=e16, first_design_equal=first_eq,
                grid_sample_max_abs_diff=gs_diff, samples=nn_, frames=nf,
                ms=cuda_ms(lambda: S.bilinear_planes_tilemajor(
                    tex, xx, yy, tt, gather), 20),
                first_design_ms=cuda_ms(
                    lambda: bilinear_planes_tilemajor_first(
                        first_tex, xx, yy, tt), 20),
                plain_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_plain(
                    tex, xx, yy, tt, gather), 2),
                library_ms=cuda_ms(lambda: gs(lib, grid), 20),
                # the coordinates, the touched texels of the frames read
                # (in their stored dtype), the samples written
                bound=bound_ms(nn_ * 8 + (nf * 4 if tt is not None else 0)
                               + tch * nf * C * item + nn_ * nf * C * 4,
                               nn_ * nf * (9 * C + 10)))
            if gather is not None:
                r["replaced_chain_ms"] = cuda_ms(
                    lambda: bilinear_planes_tilemajor_first(
                        tex.to(bf16).contiguous(), xx, yy, tt), 10)
            del lib, grid
            r["image_tiles"] = bool(S._sweep_image_width(xx, nf, C))
            rec[f"bilinear_planes_tilemajor/{tag}{part}"] = r
            if not (e16 == 0.0 and first_eq):
                raise AssertionError(f"K16 ({tag}{part}) differs from its "
                                     f"plain version ({e16}) or its first "
                                     f"design ({first_eq})")
        del tex, first_tex
        torch.cuda.empty_cache()
    # K17: f32 sums, and the sums rounded to bf16 (the f32 atlas's
    # gradient under --fp16)
    p17 = S.bilinear_planes_tilemajor_grad_plain(ct, x, y, shape)
    scale = float(p17.abs().max())
    first = bilinear_planes_tilemajor_grad_first(ct, x, y, shape)
    e_first = max_err(first, p17) / scale
    del first
    torch.cuda.empty_cache()
    # the rounding mode: the f32 mode's sums, each rounded once to bf16
    # (bit for bit), hence within one bf16 step plus the f32 sums'
    # tolerance of the plain sums' rounding (a sum that cancels to near
    # zero may be more bf16 steps of its own size apart: the two sum in
    # different orders)
    rounded = None
    for tag, gather in (("f32", None), ("bf16", bf16)):
        g17 = S.bilinear_planes_tilemajor_grad(ct, x, y, shape, gather)
        again = S.bilinear_planes_tilemajor_grad(ct, x, y, shape, gather)
        same = bool(torch.equal(g17, again))
        del again
        beyond = exact = representable = None
        if gather is None:
            a17 = max_err(g17, p17)
            ok = a17 / scale <= 1e-5
            rounded = g17.to(bf16)
        else:
            ref = p17.to(bf16).float()
            a17 = max_err(g17, ref)
            exact = bool(torch.equal(g17, rounded.float()))
            representable = bool(torch.equal(g17, g17.to(bf16).float()))
            beyond = bf16_steps_beyond(g17, ref)
            ok = (exact and representable
                  and bf16_steps_beyond(g17, ref, 1e-5 * scale) == 0)
            del ref, rounded
        del g17
        torch.cuda.empty_cache()
        lib = atlas.to(gather or torch.float32).permute(0, 3, 4, 1, 2) \
            .reshape(D, F * C, Ht, Wt).contiguous().requires_grad_(True)
        out_g = gs(lib, grid_of(x, y, S2_PATCH).to(lib.dtype))
        cot_gs = ct.permute(0, 2, 3, 1).reshape(D, F * C, *S2_PATCH) \
            .contiguous().to(lib.dtype)
        r = dict(
            max_abs_err=a17, max_rel_err=a17 / scale, deterministic=same,
            bf16_representable=representable,
            equals_f32_mode_rounded=exact,
            beyond_one_bf16_step_of_plain=beyond,
            first_design_max_rel_err=e_first, samples=n,
            ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_grad(
                ct, x, y, shape, gather), 10),
            # the first design with its zero fill
            first_design_ms=cuda_ms(
                lambda: bilinear_planes_tilemajor_grad_first(
                    ct, x, y, shape), 10),
            plain_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_grad_plain(
                ct, x, y, shape, gather), 2),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                out_g, lib, cot_gs, retain_graph=True), 10),
            bound=bound_ms(n * 8 + n * F * C * 4 + D * Ht * Wt * F * C * 4,
                           n * F * (8 * C + 10)))
        del lib, out_g, cot_gs
        torch.cuda.empty_cache()
        if gather is not None:
            r["replaced_chain_ms"] = cuda_ms(
                lambda: bilinear_planes_tilemajor_grad_first(
                    ct, x, y, shape).to(bf16).to(torch.float32), 5)
        rec[f"bilinear_planes_tilemajor_grad/{tag}"] = r
        if not (ok and same and e_first <= 1e-5):
            raise AssertionError(f"K17 ({tag}) disagrees: {a17} (scale "
                                 f"{scale}), deterministic {same}, "
                                 f"representable {representable}, the f32 "
                                 f"mode rounded {exact}, beyond one bf16 "
                                 f"step {beyond}, first design {e_first}")
    del p17
    torch.cuda.empty_cache()
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2 dense", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def make_plain_plane_sample():
    """render.sample.sample_planes_tilemajor made of the plain versions:
    the plain forward at the gather dtype, the plain f32 gradient (rounded
    to bf16 under a bf16 gather, the kernels' rounding) backward, for the
    plain composition of a dense stage-2 step and render (phases 21,
    23)."""
    import torch
    from videoloop3d_torch.render import sample as S

    class PlainPlaneSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tex, x, y, gather):
            ctx.save_for_backward(x, y)
            ctx.shape, ctx.dtype, ctx.gather = tex.shape, tex.dtype, gather
            return S.bilinear_planes_tilemajor_plain(tex.detach(), x, y,
                                                     None, gather)

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            grad = S.bilinear_planes_tilemajor_grad_plain(
                g.contiguous(), x, y, ctx.shape, ctx.gather)
            return grad.to(ctx.dtype), None, None, None

    def sample(tex, x, y, ts=None, gather_dtype=None):
        gather = gather_dtype or tex.dtype
        if ts is None:
            return PlainPlaneSample.apply(tex, x, y, gather)
        return S.bilinear_planes_tilemajor_plain(tex, x, y, ts, gather)
    return sample


def make_first_plane_sample():
    """render.sample.sample_planes_tilemajor as the port ran it before
    K16/K17 took the gather dtype: the stack cast to the gather dtype (a
    bf16 copy of the f32 atlas under --fp16, widened back by autograd in
    the backward), K16's first design forward, a zero-filled buffer and
    K17's first design backward, its sums rounded to the texels' dtype;
    for phase 22's profile of the step it replaced."""
    import torch
    from videoloop3d_torch.first_designs import (
        bilinear_planes_tilemajor_first, bilinear_planes_tilemajor_grad_first)

    class FirstPlaneSample(torch.autograd.Function):
        @staticmethod
        def forward(ctx, tex, x, y):
            ctx.save_for_backward(x, y)
            ctx.shape, ctx.dtype = tex.shape, tex.dtype
            return bilinear_planes_tilemajor_first(tex.detach(), x, y)

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            grad = bilinear_planes_tilemajor_grad_first(g.contiguous(), x, y,
                                                        ctx.shape)
            return grad.to(ctx.dtype), None, None

    def sample(tex, x, y, ts=None, gather_dtype=None):
        tex = tex.to(gather_dtype or tex.dtype).contiguous()
        if ts is None:
            return FirstPlaneSample.apply(tex, x, y)
        return bilinear_planes_tilemajor_first(tex, x, y, ts)
    return sample


def check_dense_step(args, model, params, batch, tag):
    """Phase 21: one dense stage-2 step (the ref-view loss config under
    the shipped --fp16) with the kernels against the same step made of the
    plain versions on the card: metrics to 1e-5 relative, gradients to one
    bf16 ulp (2^-7 * max|g|); near ties of the NN search taken from K11 as
    in phase 16.  The step must launch K16, K17, K11 and K12 and none of
    the sparse routes' kernels, whatever --compact_hits and --fused_render
    say."""
    from videoloop3d_torch import kernels
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    cfg = loss_config_from_args(args, ref=True)
    kernels.reset_launches()
    m_k, g_k, nn_k = s2_step_grads(args, model, params, batch, cfg)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p, ties = s2_step_grads(args, model, params, batch, cfg, nn_k)
    if (kernels.LAUNCHES != launched
            or any(launched[k] != 1 for k in DENSE_KERNELS)
            or not launched["nn_argmin"] or not launched["nn_fold"]
            or any(launched[k] for k in SPARSE_ROUTE_KERNELS)):
        raise AssertionError(f"dense {tag} step launches: kernel step "
                             f"{launched}, plain step {kernels.LAUNCHES}")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
               for k in g_k)
    if list(g_k) != ["atlas_dyn"] or not (rel <= 1e-5 and grel <= 2.0 ** -7):
        raise AssertionError(f"dense {tag} step differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "near_ties_taken_from_k11": ties, "nn_queries": nn_k.numel(),
            "loss": m_k["loss"], "swd": m_k["swd"]}


def dense_step_phases():
    """Phases 20-22: K16/K17, one dense step with and without the
    training options, a step profile, and the step's profile with the
    chain K16/K17 replaced in turns.  Returns the kernel records."""
    import dataclasses
    import torch
    from videoloop3d_torch.render import renderer as R

    args, model, params, batch, intrin = dense_s2_setup()
    if not (args.compact_hits and args.fused_render and args.fp16):
        raise AssertionError("configs/mpv_base.txt lost its shipped flags")
    rec = check_dense_kernels(model, params, batch, intrin)
    print(json.dumps({"plain_step_check": "stage 2 dense, ref view",
                      **check_dense_step(args, model, params, batch,
                                         "shipped flags")}), flush=True)
    # --add_uv_noise --bg_color random: the same draws to both steps
    base_cfg = model.cfg
    model.cfg = dataclasses.replace(base_cfg, add_uv_noise=True,
                                    bg_color="random")
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    g = model.geom
    noisy = dict(batch, draws={
        "uv": R.texel_noise(gen, (1, g.n_planes) + S2_PATCH),
        "bg": torch.rand(3, generator=gen, device=DEVICE)})
    print(json.dumps({"plain_step_check": "stage 2 dense, ref view, "
                      "--add_uv_noise --bg_color random",
                      **check_dense_step(args, model, params, noisy,
                                         "uv-noise")}), flush=True)
    model.cfg = base_cfg
    torch.cuda.empty_cache()
    print(json.dumps({"profile": "stage-2 step, ref view, dense (D=32, "
                      "396x704 texels, F=50)",
                      **profile_s2_step(args, model, params, batch,
                                        clone=False, copies=True)}),
          flush=True)
    from videoloop3d_torch.models import mpv
    print(json.dumps({"profile_compare": "stage-2 step, ref view, dense: "
                      "the bf16 copy, K16/K17's first designs, the zero "
                      "fill and the casts against K16/K17 at the gather "
                      "dtype",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch, clone=False,
                          copies=True), mpv, "sample_planes_tilemajor",
                          make_first_plane_sample(),
                          groups=DENSE_PROFILE_GROUPS, memory=True)}),
          flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    return rec


def drive_dense_train_3dvid():
    """Phase 23: train_3dvid.main from scratch (no --init_from) on the
    unmodified configs/mpv_base.txt, only --factor 1 --mpv_frm_num 50
    --pyr_init_level 4 --pyr_num_epoch 1 on the command line, on phase
    18's 360x640 scene of 3 views x 50 frames (levels 4 and 5: 297x528 then
    396x704 texel planes, 12 + 27 steps), with the launch counters set to
    0 just before and read just after: K16 and K17 once per step, none of
    the sparse routes' kernels, finite losses that fall (the mean of the
    last five against the first five), and the dense stage="mpv"
    checkpoint of level 5.  Returns (launches, summary, run directory)."""
    import torch
    from videoloop3d_torch.models import checkpoint as ckpt_io
    from videoloop3d_torch.tools import train_3dvid

    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--mpv_frm_num", "50",
            "--pyr_init_level", "4", "--pyr_num_epoch", "1",
            "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2d_runs"), "--expname", "dense",
            "--i_img", "1", "--i_video", "1000"]
    torch.cuda.reset_peak_memory_stats()
    counts, rows, rundir, wall, _ = run_train(argv, train_3dvid)
    loss = [(r["step"], r["value"]) for r in rows
            if r["tag"] == "stage2/loss"]
    vals = [v for _, v in loss]
    n_steps = len(loss)
    bad = {k: counts[k] for k in DENSE_KERNELS if counts[k] != n_steps}
    bad.update({k: counts[k] for k in SPARSE_ROUTE_KERNELS if counts[k]})
    if (bad or n_steps != 39 or not np.isfinite(vals).all()
            or not np.mean(vals[-5:]) < np.mean(vals[:5])):
        raise AssertionError(f"dense stage-2 run: launches {bad}, loss "
                             f"{loss}")
    ckpt = os.path.join(rundir, "ckpt_l5_epoch_0000.npz")
    meta = ckpt_io.load_checkpoint_meta(ckpt)
    if not (meta["stage"] == "mpv" and not meta["is_sparse"]
            and meta["extra"]["base_mpi_hw"] == [396, 704]):
        raise AssertionError(f"dense stage-2 checkpoint meta {meta}")
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    return counts, {
        "cli_wall_s": wall, "steps": n_steps, "launches": counts,
        "warm_step_ms": warm, "loss": loss,
        "checkpoint_GB": os.path.getsize(ckpt) / 1e9,
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9}


def plain_render_dense(model, params, h, w, ext, intr, ts):
    """A dense model's eval render composed of the plain versions only (the
    reference the kernels' render is held against), as uint8."""
    import torch
    from videoloop3d_torch.models import mpv

    saved = mpv.sample_planes_tilemajor
    mpv.sample_planes_tilemajor = make_plain_plane_sample()
    try:
        with torch.inference_mode():
            rgb, _ = model.render(params, h, w, ext, intr, ts)
    finally:
        mpv.sample_planes_tilemajor = saved
    return (255.0 * rgb.clamp(0.0, 1.0)).to(torch.uint8).cpu().numpy()


def drive_dense_render(scene_dir, expdir, expname, label):
    """Phase 24: render_video.main of a run's dense checkpoint, the fixed
    view 0 over the 50-frame loop in chunks of 10, with the launch
    counters set to 0 just before and read just after: K16 once per chunk
    and none of the sparse routes' kernels; the frames held against a
    render of the plain versions (|diff| <= 1 except on <= 0.1% of the
    pixels).  Returns (launches, summary)."""
    import torch
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run

    argv = ["--datadir", scene_dir, "--expdir", expdir, "--expname",
            expname, "--factor", "1", "--mpv_frm_num", "50", "--fp16",
            "--gpu_num", GPU_NUM]
    frames, counts, spent, wall = drive(argv + ["--v", "0"])
    H, W = S1_HW
    bad = {k: counts[k] for k in SPARSE_ROUTE_KERNELS if counts[k]}
    if counts["bilinear_planes_tilemajor"] != 5:
        bad["bilinear_planes_tilemajor"] = counts["bilinear_planes_tilemajor"]
    if (bad or frames.shape != (50, H, W, 3) or frames.dtype != np.uint8
            or frames.std() < 1.0):
        raise AssertionError(f"dense render {label}: launches {bad}, frames "
                             f"{frames.shape} std {frames.std()}")
    args = parse_args_with_configs(argv)
    _, _, scene = llff.load_mv_videos(
        scene_dir, factor=1, bd_factor=(args.near_factor, args.far_factor),
        recenter=True, render_frames=50)
    poses, intrins = scene["poses"], scene["intrins"]
    model, params, _, _ = load_mpv_from_run(
        args, H, W, cameras.pose_to_extrinsic(
            cameras.average_pose(poses)[:, :4]), intrins[0],
        float(scene["bds"].min()), float(scene["bds"].max()),
        device=torch.device(DEVICE))
    ext = cameras.pose_to_extrinsic(poses[:1]).astype(np.float32)
    worst = 0.0
    for t_idx in (0, 37):
        ref = plain_render_dense(model, params, H, W, ext, intrins[:1],
                                 [t_idx])[0]
        worst = max(worst, u8_close(frames[t_idx], ref))
    if worst > 1e-3:
        raise AssertionError(f"dense render {label} differs from the plain "
                             f"render on {worst:.2e} of pixels")
    g = model.geom
    summary = {"render": f"fixed view, dense {label}", "frames": len(frames),
               "planes": [g.n_planes, g.mpi_h, g.mpi_w, model.frm_num],
               "ms_per_frame": spent * 1e3 / len(frames), "cli_wall_s": wall,
               "plain_render_u8_diff_gt1_share": worst, "launches": counts}
    del model, params
    torch.cuda.empty_cache()
    return counts, summary


def dense_phases(s1_scene_dir):
    """Phases 20-24: the dense stage-2 phase.  Returns (kernel records,
    K16 and K17 launches of the main-path runs)."""
    rec = dense_step_phases()
    counts, summary = drive_dense_train_3dvid()
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt from scratch, "
                      "levels 4-5", **summary}), flush=True)
    launches = {k: counts[k] for k in DENSE_KERNELS}
    renders = (
        (os.path.join(WORK, "s2_scene"), os.path.join(WORK, "s2d_runs"),
         "dense", "mpv checkpoint (the scratch run's)"),
        (s1_scene_dir, os.path.join(WORK, "s1_runs"), "shipped",
         "stage-1 checkpoint (576x1024, broadcast to 50 frames)"))
    for scene_dir, expdir, name, label in renders:
        r_counts, summary = drive_dense_render(scene_dir, expdir, name, label)
        print(json.dumps(summary), flush=True)
        launches["bilinear_planes_tilemajor"] += \
            r_counts["bilinear_planes_tilemajor"]
        if name == "dense":
            shutil.rmtree(expdir, ignore_errors=True)     # a 7 GB checkpoint
    return rec, launches


EVAL_SCALES = ((5, 2, 7, 1), (11, 4, 5, 1), (17, 6, 3, 1))
EVAL_HEADER = (["name", "nnf", "nnb", "dyn", "lpips", "lpips_sw", "loop",
                "psnr", "ssim"]
               + [f"{m}_p{p}s{s}pt{pt}st{st}" for m in ("nnf", "nnb", "loop")
                  for p, s, pt, st in EVAL_SCALES]
               + ["psnr_full", "ssim_full"])
EVAL_KERNELS = RENDER_KERNELS + ("nn_band_argmin", "nn_band_err")


def eval_argv():
    """evaluate's (and export_mesh's) arguments for phase 18's run: the
    shipped configs/mpv_base.txt (--fp16: bf16 texels in the render) at
    factor 1 and 50 frames."""
    return ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--mpv_frm_num", "50",
            "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2_runs"), "--expname", "s2",
            "--gpu_num", GPU_NUM]


def lpips_weights(path, seed=0):
    """Seeded alex LPIPS weights in the layout of eval/lpips.py (He-scaled
    normal convolutions, |normal| linear heads), made locally."""
    from videoloop3d_torch.eval import lpips as L
    rng = np.random.default_rng(seed)
    out, ic = {"net": np.array("alex")}, 3
    for i, (oc, k, _, _) in enumerate(L._ALEX_CFG):
        out[f"conv{i}/w"] = rng.normal(0, (2.0 / (ic * k * k)) ** 0.5,
                                       (oc, ic, k, k)).astype(np.float32)
        out[f"conv{i}/b"] = rng.normal(0, 0.01, oc).astype(np.float32)
        ic = oc
    for i, c in enumerate(L._CHNS["alex"]):
        out[f"lin{i}/w"] = np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(
            np.float32)
    np.savez(path, **out)
    return path


def check_band_eval():
    """Phase 25: K18 and K19 against their plain versions on the card at
    the eval's shapes: view 0 of phase 18's scene (3, 50, 360, 640) and
    evaluate's render of phase 18's checkpoint, both cropped 40 px to
    280x560, u8 values in f32.  At each of the three patch scales: the
    pair (both directions from one K18 launch; K19 each way) and the Loop
    Quality seam (2 (pt - 1) frames of the render against the video).
    Returns {scale: (K18 record, K19 record)} (times of the pair)."""
    import torch
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.data.video import to8b
    from videoloop3d_torch.eval.evaluate import load_mpv_from_run
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.train.stage2 import render_eval

    args = parse_args_with_configs(eval_argv())
    videos, _, sc = llff.load_mv_videos(
        os.path.join(WORK, "s2_scene"), factor=1,
        bd_factor=(args.near_factor, args.far_factor), recenter=True)
    H, W = sc["hw"]
    ref = cameras.pose_to_extrinsic(cameras.average_pose(sc["poses"])[:, :4])
    model, params, _, _ = load_mpv_from_run(
        args, H, W, ref, sc["intrins"][0], float(sc["bds"].min()),
        float(sc["bds"].max()), device=torch.device(DEVICE))
    pred = to8b(render_eval(model, params, H, W,
                            cameras.pose_to_extrinsic(sc["poses"][:1]),
                            sc["intrins"][:1], np.arange(50), chunk=2))
    del model, params
    c = 40

    def cfhw(v):
        return torch.as_tensor(np.ascontiguousarray(np.moveaxis(
            v[:, c:-c, c:-c].astype(np.float32), -1, 0)), device=DEVICE)

    gt, pr = cfhw(np.asarray(videos[0])), cfhw(pred)
    del videos
    out = {}
    for p, s, pt, st in EVAL_SCALES:
        psz, strides = (pt, p, p), (st, s, s)
        plan = PN.lowmem_plan(50, 50, gt.shape[2], gt.shape[3], psz, strides,
                              65)
        r18, r19 = check_band(gt, pr, plan, both=True, with_err=True)
        seam = torch.cat([pr[:, -pt + 1:], pr[:, :pt - 1]], 1).contiguous()
        splan = PN.lowmem_plan(seam.shape[1], 50, gt.shape[2], gt.shape[3],
                               psz, strides, 65)
        s18, s19 = check_band(seam, gt, splan, with_err=True,
                              time_it=False)
        r18["seam"] = {k: s18[k] for k in ("index_flips", "queries",
                                           "flip_gap_rel_term_scale")}
        r19["seam"] = s19
        tag = f"p{p}s{s}pt{pt}st{st}"
        out[tag] = (r18, r19)
        print(json.dumps({"kernel": f"nn_band_argmin, eval pair {tag}",
                          **r18}), flush=True)
        print(json.dumps({"kernel": f"nn_band_err, eval pair {tag}",
                          **r19}), flush=True)
        torch.cuda.empty_cache()
    out["p5s2pt7st1"][1]["nn_groups_s"] = nn_groups_in_turns(gt, pr)
    print(json.dumps({"nn_groups": "loopq and nnmse of one view, host s, "
                      "K19's first design against its redesign",
                      **out["p5s2pt7st1"][1]["nn_groups_s"]}), flush=True)
    # what bounds the FMA loop: the share of FFMA among the instructions
    # of K18's 7 x 7 instance (the eval's and the training's)
    print(json.dumps({"sass_inner_loop": "nn_tile_search_kernel<K18, 7, 7>",
                      **sass_loop_mix("nn_argmin",
                                      r"nn_tile_search_kernelILi1ELi7ELi7E")}),
          flush=True)
    return out


def nn_groups_in_turns(gt, pr):
    """What tools/evaluate.py's loopq and nnmse groups pay for one view:
    `loop_quality` and `compute_nnerr_pair` at the three scales, from the
    host arrays, host clock (each ends in a copy to the host), with K19's
    first design in the redesign's place and with the redesign, in turns
    (first, redesign, redesign, first), after one warm-up of each.
    Returns {design: [[loopq s, nnmse s], ...]} and the means."""
    from videoloop3d_torch.eval import nnmse as NN
    from videoloop3d_torch.first_designs import nn_band_err_first
    from videoloop3d_torch.losses import patch_nn as PN

    g, p = gt.cpu().numpy(), pr.cpu().numpy()
    redesign = PN.nn_band_err

    def groups(fn):
        PN.nn_band_err = fn
        try:
            t0 = time.perf_counter()
            for ps, s, pt, st in EVAL_SCALES:
                NN.loop_quality(p, g, ps, s, pt, st, device=DEVICE)
            t1 = time.perf_counter()
            for ps, s, pt, st in EVAL_SCALES:
                NN.compute_nnerr_pair(g, p, ps, s, pt, st, device=DEVICE)
            return [t1 - t0, time.perf_counter() - t1]
        finally:
            PN.nn_band_err = redesign

    groups(nn_band_err_first)
    groups(redesign)
    out = {"first_design": [], "redesign": []}
    for key in ("first_design", "redesign", "redesign", "first_design"):
        out[key].append(groups(nn_band_err_first if key == "first_design"
                               else redesign))
    for key in ("first_design", "redesign"):
        out[f"{key}_mean"] = [sum(t[i] for t in out[key]) / 2
                              for i in range(2)]
    return out


def drive_evaluate():
    """Phase 27: ``python -m videoloop3d_torch.tools.evaluate``'s main on
    phase 18's sparse mpv checkpoint (3 views x 50 frames, 360x640), with
    seeded locally made alex LPIPS weights named by VL3D_LPIPS_WEIGHTS and
    the launch counters set to 0 just before and read just after: K1-K4,
    K18 and K19 launched; eval_metrics.txt's header equal to the JAX
    package's column list and every value finite; the nnf, nnb and loop
    columns within 1e-3 relative of the same metrics computed through
    K18's and K19's plain versions on the card (near ties may break
    otherwise).  Returns (launches, summary)."""
    import contextlib
    import io
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.config import parse_args_with_configs
    from videoloop3d_torch.eval.evaluate import evaluate
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.tools import evaluate as tool

    os.environ["VL3D_LPIPS_WEIGHTS"] = lpips_weights(
        os.path.join(WORK, "lpips_alex.npz"))
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            table = tool.main(eval_argv())
    finally:
        print(buf.getvalue(), end="", flush=True)
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    seconds = next(json.loads(ln[len("[eval] "):])["seconds"]
                   for ln in buf.getvalue().splitlines()
                   if ln.startswith('[eval] {"seconds"'))
    with open(table["path"]) as f:
        lines = f.read().splitlines()
    # the masked static PSNR/SSIM of a view whose static mask is empty are
    # -inf/NaN in both packages (the reference's npix correction); every
    # other value must be finite
    static = static_shares()
    masked = [EVAL_HEADER.index(k) for k in ("psnr", "ssim")]
    bad = [(ln.split(", ")[0], EVAL_HEADER[i])
           for row, ln in enumerate(lines[1:])
           for i, v in enumerate(ln.split(", ")[1:], 1)
           if not np.isfinite(float(v))
           and not (i in masked and min(static[row:row + 1] or static) == 0)]
    idle = [k for k in EVAL_KERNELS if counts[k] == 0]
    if idle or lines[0].split(", ") != EVAL_HEADER or len(lines) != 5 or bad:
        raise AssertionError(f"evaluate: idle kernels {idle}, non-finite "
                             f"{bad}, table {lines}")
    saved = (PN.nn_band_argmin, PN.nn_band_err)
    PN.nn_band_argmin, PN.nn_band_err = PN.nn_band_argmin_plain, \
        PN.nn_band_err_plain
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            plain = evaluate(parse_args_with_configs(eval_argv()),
                             compute_flags={"static": False, "dyn": False,
                                            "lpips": False},
                             device=torch.device(DEVICE))
    finally:
        PN.nn_band_argmin, PN.nn_band_err = saved
    rel = max(abs(a - b) / abs(b) for k in ("nnf", "nnb", "loopq")
              for ra, rb in zip(table[k], plain[k]) for a, b in zip(ra, rb))
    if not rel <= 1e-3:
        raise AssertionError(f"evaluate's NN metrics differ from the plain "
                             f"versions' by {rel}")
    return counts, {"evaluate": "tools.evaluate on phase 18's checkpoint",
                    "cli_wall_s": wall, "seconds_by_group": seconds,
                    "static_mask_share_by_view": static,
                    "launches": counts, "header": lines[0],
                    "aggregate_row": lines[-1],
                    "nn_metrics_max_rel_err_vs_plain": rel}


def static_shares():
    """The share of the static (not loopable) mask inside the eval's 40 px
    crop, per view of phase 18's scene (host numpy, as evaluate)."""
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.data.loopmask import compute_loopable_mask
    videos, _, _ = llff.load_mv_videos(os.path.join(WORK, "s2_scene"),
                                       factor=1, recenter=True)
    out = []
    for v in videos:
        c = min(40, v.shape[1] // 4, v.shape[2] // 4)
        out.append(float(1.0 - compute_loopable_mask(np.asarray(v) / 255)
                         [c:-c, c:-c].mean()))
    return out


def drive_export():
    """Phase 28: ``python -m videoloop3d_torch.tools.export_mesh``'s main
    on the same checkpoint: geometry.obj with 2 faces per kept tile, the
    static atlas packing_grid x the tile size, 50 dynamic frames, and
    meta.json's frame_count 50.  Returns the summary."""
    from videoloop3d_torch.export.mesh_export import packing_grid
    from videoloop3d_torch.export.objio import load_obj
    from videoloop3d_torch.models import checkpoint as ckpt_io
    from videoloop3d_torch.tools import export_mesh

    t0 = time.perf_counter()
    outdir = export_mesh.main(eval_argv() + [
        "--mesh_folder", os.path.join(WORK, "meshes")])
    wall = time.perf_counter() - t0
    ck = ckpt_io.load_checkpoint(ckpt_io.latest_checkpoint(
        os.path.join(WORK, "s2_runs", "s2")))
    n_s = int((ck["tile_map_static"] >= 0).sum())
    n_d = int((ck["tile_map_dyn"] >= 0).sum())
    th, tw = ck["meta"]["tile_hw"]
    _, _, faces, _ = load_obj(os.path.join(outdir, "geometry.obj"))

    def image(name):
        path = os.path.join(outdir, name)
        if os.path.exists(path + ".npy"):
            return np.load(path + ".npy")
        import imageio.v2 as imageio
        return imageio.imread(path)

    rows, cols = packing_grid(n_s)
    static = image("static.png")
    frames = sorted(os.listdir(os.path.join(outdir, "dynamic")))
    with open(os.path.join(outdir, "meta.json")) as f:
        meta = json.load(f)
    if (len(faces) != 2 * (n_s + n_d)
            or static.shape != (rows * th, cols * tw, 4)
            or len(frames) != 50 or meta["frame_count"] != 50):
        raise AssertionError(f"export: {len(faces)} faces for {n_s} + {n_d} "
                             f"tiles, static {static.shape}, "
                             f"{len(frames)} frames, meta {meta}")
    return {"export_mesh": "tools.export_mesh on phase 18's checkpoint",
            "cli_wall_s": wall, "tiles": [n_s, n_d], "faces": len(faces),
            "static_atlas": list(static.shape),
            "dynamic_atlas": list(image(os.path.join("dynamic", "0000.png"))
                                  .shape), "frames": len(frames)}


def eval_phases():
    """Phases 25, 27 and 28.  Returns (kernel records, launches of the
    evaluate run)."""
    rec = check_band_eval()
    counts, summary = drive_evaluate()
    print(json.dumps(summary), flush=True)
    print(json.dumps(drive_export()), flush=True)
    return rec, counts


GEO_KERNELS = ("geo_warp_fwd", "geo_warp_bwd", "sample_dense_coord_grad",
               "bilinear_tiles_coord_grad", "tile_lookup_coords")
GEO_FRAC = 0.3                   # perturbed verts: up to 0.3 of a quad
GEO_TIE = 1e-6                   # a flip is allowed where the top two
                                 # triangle scores lie within this
GEO_DIV_INSTRUCTIONS = 8         # an IEEE f32 division's fast path:
                                 # MUFU.RCP, 4 FFMA, FCHK, a branch, a move


def perturb_verts(geom, verts, frac=GEO_FRAC, seed=0):
    """verts (D*Hv*Wv, 3) on the card moved in-plane by up to frac of a
    quad (uniform), in the reference camera's pixel units at each
    plane's depth."""
    import torch
    rng = np.random.default_rng(seed)
    D = geom.n_planes
    depths = geom.depths_np()
    v = verts.detach().cpu().numpy().reshape(D, -1, 3).copy()
    span = min((geom.mpi_h - 1) / geom.n_tiles_h,
               (geom.mpi_w - 1) / geom.n_tiles_w)
    px = depths / geom.ref_intrin_mpi_np()[0, 0]
    v[..., :2] += (2 * rng.random(v[..., :2].shape) - 1) * frac * span \
        * px[:, None, None]
    return torch.as_tensor(v.reshape(-1, 3), device=verts.device)


def rel_view(model, batch):
    """The batch's extrinsics relative to the reference camera, and its
    intrinsics (what MPMesh.render receives)."""
    import torch
    ref_inv = torch.as_tensor(np.linalg.inv(model.geom.ref_extrin_np()),
                              device=DEVICE)
    return batch["extrin"] @ ref_inv[None], batch["intrin"]


def tie_gaps(vpx, vpy, vz, qi0, qj0):
    """Per sample, the best front-facing triangle score minus the second
    best (inf where fewer than two), from the plain search's arithmetic."""
    import torch
    from videoloop3d_torch.render import geo_warp as GW

    Hv, Wv = vpx.shape[2:]
    xs, ys = GW._pixels(*qi0.shape[2:], vpx.device)
    infront = vz > 1e-6
    scores = []
    for di, dj in GW._OFFSETS:
        cs = GW._quad(qi0, qj0, di, dj, Hv, Wv)
        cpx = [GW._gather(vpx, i, j) for i, j in cs]
        cpy = [GW._gather(vpy, i, j) for i, j in cs]
        cok = [GW._gather(infront, i, j) for i, j in cs]
        for a, b, c in GW._TRIANGLES:
            b0, b1, b2 = GW._bary(xs, ys, cpx[a], cpy[a], cpx[b], cpy[b],
                                  cpx[c], cpy[c])
            s = torch.minimum(torch.minimum(b0, b1), b2)
            scores.append(torch.where(cok[a] & cok[b] & cok[c], s,
                                      -float("inf")))
    top = torch.stack(scores).topk(2, dim=0).values
    return top[0] - top[1]


def check_geo_warp(model, batch, verts, tag):
    """K20/K21 against their plain versions on the card for one view of
    the model's sweep: the winning triangles (a flip only where the top
    two scores lie within GEO_TIE), x, y, z within 1e-4 elsewhere, and the
    verts gradient of a random weighted sum of x, y, z (through the plain
    projection, over the unflipped samples) within 1e-5 * max|g|.  Times
    (CUDA events) and bounds.  Returns (record, K20's coordinates)."""
    import torch
    from videoloop3d_torch.render import geo_warp as GW
    from videoloop3d_torch.render import renderer as R

    g = model.geom
    h, w = S1_PATCH
    ext, intr = rel_view(model, batch)
    vpx, vpy, vz = GW.project_verts(g, verts, ext, intr)
    qi0, qj0 = GW.flat_quad_guess(g, ext, intr, h, w)
    uvx, uvy = GW.vertex_uvs(g, vpx.device)
    hw = (g.mpi_h, g.mpi_w)
    fwd = (vpx, vpy, vz, qi0, qj0, uvx, uvy, hw)
    (kx, ky, kz, kv, kt), khdr = GW.geo_warp_fwd(*fwd, with_headers=True)
    k20 = check_geo_fwd_redesign(fwd, (kx, ky, kz, kv, kt), khdr, tag)
    px, py, pz, pv, pt = GW.geo_warp_fwd_plain(*fwd)
    flips = kt != pt
    n_flips = int(flips.sum())
    worst_gap = 0.0
    if n_flips:
        worst_gap = float(tie_gaps(vpx, vpy, vz, qi0, qj0)[flips].max())
    same = ~flips
    err = max(max_err(a[same], b[same]) for a, b in ((kx, px), (ky, py),
                                                     (kz, pz)))
    v_bad = int(((kv != pv) & same).sum())
    if worst_gap > GEO_TIE or err > 1e-4 or v_bad:
        raise AssertionError(f"geo_warp_fwd ({tag}): {n_flips} flips, "
                             f"worst score gap {worst_gap}, err {err}, "
                             f"{v_bad} validity mismatches")
    rec = {"flips": n_flips, "valid_share": float(kv.float().mean())}
    if tag == "flat":
        flat = R.warp_coordinates(g, ext, intr, h, w)
        m = kv & flat.valid
        rec["flat_sweep_max_abs_diff"] = max(max_err(kx[m], flat.x[m]),
                                             max_err(ky[m], flat.y[m]))
        if rec["flat_sweep_max_abs_diff"] > 1e-3:
            raise AssertionError(f"flat verts: x, y differ from the plane "
                                 f"sweep by {rec['flat_sweep_max_abs_diff']}")
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    cts = [torch.randn(qi0.shape, generator=gen, device=DEVICE) * same
           for _ in range(3)]

    def verts_grad(warp):
        v = verts.detach().clone().requires_grad_(True)
        c = warp(g, v, ext, intr, h, w)
        sum((a * b).sum() for a, b in zip(c[:3], cts)).backward()
        return v.grad
    gk = verts_grad(GW.warp_coordinates_verts)
    gp = verts_grad(GW.warp_coordinates_verts_plain)
    grel = max_err(gk, gp) / float(gp.abs().max())
    bwd = (*cts, vpx, vpy, vz, qi0, qj0, kt, uvx, uvy)
    d_k, hdr = GW.geo_warp_bwd(*bwd, with_headers=True)
    d_p = GW.geo_warp_bwd_plain(*bwd)
    drel = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(d_k, d_p))
    if grel > 1e-5 or drel > 1e-5:
        raise AssertionError(f"geo_warp_bwd ({tag}): verts grads {grel}, "
                             f"vertex-array grads {drel}")
    k21 = check_geo_bwd_redesign(bwd, d_k, d_p, hdr, tag)
    n = qi0.numel()
    n_vert = 3 * vpx.numel() * 4
    winners = int((kt >= 0).sum())
    rec["geo_warp_fwd"] = dict(
        max_abs_err=err, **k20,
        plain_ms=cuda_ms(lambda: GW.geo_warp_fwd_plain(*fwd), 3),
        library_ms=None,
        # 18 triangles of ~25 f32 operations where all three are in front
        bound=bound_ms(n * (8 + 14) + n_vert, n * 18 * 25),
        # the same, each of the two IEEE divisions a triangle counted as
        # the GEO_DIV_INSTRUCTIONS instructions of its fast path
        bound_divisions_ms=bound_ms(
            n * (8 + 14) + n_vert,
            n * 18 * (25 - 2 + 2 * GEO_DIV_INSTRUCTIONS))[0])
    rec["geo_warp_bwd"] = dict(
        max_abs_err=max(max_err(a, b) for a, b in zip(d_k, d_p)),
        max_rel_err=drel, verts_grad_max_rel_err=grel, **k21,
        plain_ms=cuda_ms(lambda: GW.geo_warp_bwd_plain(*bwd), 3),
        library_ms=None,
        bound=bound_ms(n * (12 + 8 + 1) + 2 * n_vert, winners * 80))
    return rec, (kx, ky, kv)


def check_geo_fwd_redesign(fwd, got, hdr, tag):
    """K20's redesign (a block's window and triangle table staged once,
    candidates found without division) bit for bit against its first
    design (one thread a sample, vl3d_geo_warp_fwd_first) in x, y, z,
    valid and tri, its headers (windows, the samples of the global route,
    the samples) against `geo_bwd_layout`, both designs timed in turns.
    Returns the record's fields."""
    import torch
    from videoloop3d_torch.first_designs import geo_warp_fwd_first
    from videoloop3d_torch.render import geo_warp as GW

    first = geo_warp_fwd_first(*fwd)
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               if a.dtype == torch.float32 else torch.equal(a, b)
               for a, b in zip(got, first))
    qi0, qj0 = fwd[3], fwd[4]
    lay = GW.geo_bwd_layout(qi0, qj0, *fwd[0].shape[2:])
    layout_ok = bool(torch.equal(hdr[:, :4], lay["windows"])
                     and torch.equal(hdr[:, 4].long(), lay["n_search_global"])
                     and torch.equal(hdr[:, 5].long(), lay["n_samples"]))
    if not (same and layout_ok):
        raise AssertionError(f"geo_warp_fwd ({tag}): first design equal "
                             f"{same}, headers {layout_ok}")
    ms, first_ms, turns = ms_in_turns(lambda: GW.geo_warp_fwd(*fwd),
                                      lambda: geo_warp_fwd_first(*fwd), 20)
    return dict(ms=ms, first_design_ms=first_ms, ms_in_turns=turns,
                equal_first_design=same,
                global_samples=int(hdr[:, 4].sum()))


def geo_oblique_inputs(B=1, D=4, h=96, w=160, Hv=110, Wv=180, seed=0):
    """A vertex grid finer than a pixel under a turned view (the card
    tests' oblique case at a larger size): a block's 3 x 3 searches reach
    more vertices than a window takes, so samples go by K20's global
    route.  Returns K20's arguments on the card."""
    import torch
    rng = np.random.default_rng(seed)
    sx, sy = (w + 6.0) / (Wv - 1), (h + 6.0) / (Hv - 1)
    gx = np.arange(Wv) * sx - 3.0
    gy = np.arange(Hv) * sy - 3.0
    vpx = np.broadcast_to(gx[None, None, None, :], (B, D, Hv, Wv)).copy()
    vpy = np.broadcast_to(gy[None, None, :, None], (B, D, Hv, Wv)).copy()
    vpx += (rng.random(vpx.shape) - 0.5) * 0.6 * sx
    vpy += (rng.random(vpy.shape) - 0.5) * 0.6 * sy
    vpx = vpx * 1.7 + vpy * 0.4
    vz = rng.uniform(1.0, 3.0, (B, D, Hv, Wv))
    px = np.arange(w)[None, :]
    py = np.arange(h)[:, None]
    qj0 = np.clip(np.floor((px + 3.0) / sx), 0, Wv - 2) + 0 * py
    qi0 = np.clip(np.floor((py + 3.0) / sy), 0, Hv - 2) + 0 * px
    f32 = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(DEVICE)
           for a in (vpx, vpy, vz, np.linspace(0, 60.0, Wv),
                     np.linspace(0, 40.0, Hv))]
    i32 = [torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(a, (B, D, h, w)), np.int32)).to(DEVICE)
           for a in (qi0, qj0)]
    return (*f32[:3], *i32, *f32[3:], (41, 61))


def check_geo_bwd_redesign(bwd, d_k, d_p, hdr, tag):
    """K21's redesign (a block's window summed on chip, the windows added
    in block order) against its first design (9 global atomics a sample,
    vl3d_geo_warp_bwd_first) within 1e-5 * max|g|, the same bits on a
    second call where no sample took the overflow route, its headers
    against `geo_bwd_layout` (windows, overflow and live samples) and the
    library's plan against the mirror's; both designs timed in turns.
    Returns the record's fields."""
    import torch
    from videoloop3d_torch.first_designs import geo_warp_bwd_first
    from videoloop3d_torch.render import geo_warp as GW

    gx, gy, gz, vpx, _, _, qi0, qj0, tri = bwd[:9]
    d_f = geo_warp_bwd_first(*bwd)
    frel = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(d_f, d_p))
    again = GW.geo_warp_bwd(*bwd)
    same = all(torch.equal(a, b) for a, b in zip(d_k, again))
    live = (tri >= 0) & ~((gx == 0) & (gy == 0) & (gz == 0))
    lay = GW.geo_bwd_layout(qi0, qj0, *vpx.shape[2:], tri, live)
    klay = GW.kernel_geo_bwd_layout(*qi0.shape, *vpx.shape[2:])
    overflow = int(hdr[:, 4].sum())
    layout_ok = bool(torch.equal(hdr[:, :4], lay["windows"])
                     and torch.equal(hdr[:, 4].long(), lay["n_overflow"])
                     and torch.equal(hdr[:, 5].long(), lay["n_live"])
                     and klay == {k: lay[k] for k in klay})
    if frel > 1e-5 or not layout_ok or not (same or overflow):
        raise AssertionError(f"geo_warp_bwd ({tag}): first design {frel}, "
                             f"layout {layout_ok}, same bits {same}, "
                             f"{overflow} overflow samples")
    ms, first_ms, turns = ms_in_turns(lambda: GW.geo_warp_bwd(*bwd),
                                      lambda: geo_warp_bwd_first(*bwd), 20)
    win = lay["windows"].long()
    return dict(ms=ms, first_design_ms=first_ms, ms_in_turns=turns,
                first_design_max_rel_err=frel, same_bits_twice=same,
                overflow_samples=overflow, live_samples=int(live.sum()),
                blocks=lay["blocks"],
                window_vertices_mean=float((win[:, 2] * win[:, 3]).float()
                                           .mean()))


def touched_texels(x, y, Ht, Wt):
    """Distinct in-plane texels the bilinear corners of (B, D, h, w)
    samples read."""
    import torch
    D = x.shape[1]
    x0 = torch.floor(x).clamp(-2, Wt).long()
    y0 = torch.floor(y).clamp(-2, Ht).long()
    dd = torch.arange(D, device=x.device).view(1, D, 1, 1)
    idx = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < Wt) & (yi >= 0) & (yi < Ht)
        idx.append(((dd * Ht + yi) * Wt + xi)[inside])
    return torch.unique(torch.cat(idx)).numel()


def check_dense_coord_grad(g, x, y):
    """K22 against its plain version at the geo warp's coordinates: f32
    and bf16 texels, with and without the loop-mask channel, 1e-5 *
    max|g|; timed with its bound and, for f32 with the mask,
    grid_sampler_2d_backward's grid gradient as the library yardstick."""
    import torch
    from videoloop3d_torch.render import sample as S

    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    atlas = torch.randn((D, Ht, Wt, 4), generator=gen, device=DEVICE)
    amask = torch.randn((D, Ht, Wt, 1), generator=gen, device=DEVICE)
    cot = torch.randn(x.shape + (4,), generator=gen, device=DEVICE)
    cot_m = torch.randn(x.shape + (1,), generator=gen, device=DEVICE)
    n = x.numel()
    touched = touched_texels(x, y, Ht, Wt)
    rec = {}
    for dtype in (torch.float32, torch.bfloat16):
        a, m = atlas.to(dtype), amask.to(dtype)
        for mask in (False, True):
            args = (cot, cot_m if mask else None, a, m if mask else None,
                    x, y)
            got = S.sample_dense_coord_grad(*args)
            want = S.bilinear_planes_coord_grad_plain(cot, a, x, y)
            if mask:
                mw = S.bilinear_planes_coord_grad_plain(cot_m, m, x, y)
                want = (want[0] + mw[0], want[1] + mw[1])
            e = max(max_err(p, q) / float(q.abs().max())
                    for p, q in zip(got, want))
            if e > 1e-5:
                raise AssertionError(f"sample_dense_coord_grad ({dtype}, "
                                     f"mask {mask}): {e}")
            rec[f"{dtype}/{mask}"] = e
    dtype = torch.float32
    args = (cot, cot_m, atlas, amask, x, y)
    C = 5
    tex = torch.cat([atlas, amask], -1).permute(0, 3, 1, 2).contiguous()
    grid = torch.stack([x[0] / (Wt - 1) * 2 - 1, y[0] / (Ht - 1) * 2 - 1],
                       -1).contiguous()
    gout = torch.cat([cot, cot_m], -1)[0].permute(0, 3, 1, 2).contiguous()

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            gout, tex, grid, 0, 0, True, [False, True])

    def plain():
        p = S.bilinear_planes_coord_grad_plain(cot, atlas, x, y)
        q = S.bilinear_planes_coord_grad_plain(cot_m, amask, x, y)
        return p[0] + q[0], p[1] + q[1]
    a16, m16 = atlas.bfloat16(), amask.bfloat16()
    return dict(
        max_rel_err=max(rec.values()), by_case=rec,
        ms=cuda_ms(lambda: S.sample_dense_coord_grad(*args), 20),
        bf16_ms=cuda_ms(lambda: S.sample_dense_coord_grad(
            cot, cot_m, a16, m16, x, y), 20),
        plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library, 20),
        max_abs_err=max(rec.values()),
        bound=bound_ms(n * (4 * C + 8 + 8) + touched * 4 * C,
                       n * (C * 14 + 10)))


def check_tile_coord_kernels(model, params, batch, verts):
    """K1's coordinate entry (bit for bit) and K23 (1e-5 * max|g|, with
    u, v set exactly on tile edges on a share of the samples) against
    their plain versions at the sparse step's shapes under the vertex
    warp; K23 (redesigned) also bit for bit against its first design, on
    the f32 atlas and its bf16 copy, and timed beside it in turns; timed
    with their bounds."""
    import torch
    from videoloop3d_torch.first_designs import (
        bilinear_tiles_coord_grad_first)
    from videoloop3d_torch.render import geo_warp as GW
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    g = model.geom
    ext, intr = rel_view(model, batch)
    with torch.no_grad():
        c = GW.warp_coordinates_verts(g, verts, ext, intr, *S1_PATCH)
    maps = (model.tile_map_static, model.tile_map_dyn)
    args = (c.x, c.y, c.valid, *maps, g.tile_span)
    got = R.tile_lookup_coords(*args)
    want = R.tile_lookup_coords_plain(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("tile_lookup_coords differs from its plain "
                             "version")
    k_s, _, i, j = got
    fu, fv = R.tile_fractions(c.x, c.y, i, j, g.tile_span)
    tiles = params["atlas"].detach()
    N, th, tw, C = tiles.shape
    u = (fu * (tw - 1)).contiguous()
    v = (fv * (th - 1)).contiguous()
    u.view(-1)[::97] = 0.0                  # on the tile edges
    u.view(-1)[1::97] = tw - 1.0
    v.view(-1)[2::97] = 0.0
    v.view(-1)[3::97] = th - 1.0
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    ct = torch.randn(k_s.shape + (C,), generator=gen, device=DEVICE)
    kargs = (ct, tiles, k_s, u, v)
    gk = S.bilinear_tiles_coord_grad(*kargs)
    gp = S.bilinear_tiles_coord_grad_plain(*kargs)
    e23 = max(max_err(a, b) / float(b.abs().max()) for a, b in zip(gk, gp))
    if e23 > 1e-5:
        raise AssertionError(f"bilinear_tiles_coord_grad: {e23}")
    n = k_s.numel()
    hits = int((k_s >= 0).sum())
    used = torch.unique(k_s[k_s >= 0]).numel()
    n_maps = 2 * maps[0].numel() * 4
    # the redesign against its first design (its two zero fills), on the
    # f32 atlas (the sparse geo step's) and its bf16 copy
    k23 = {}
    for tag, tt in (("f32", tiles), ("bf16", tiles.to(torch.bfloat16))):
        a = (ct, tt, k_s, u, v)
        got = S.bilinear_tiles_coord_grad(*a)
        first = bilinear_tiles_coord_grad_first(*a)
        same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(got, first))
        if not same:
            raise AssertionError(f"K23 ({tag}) differs from its first "
                                 f"design: {max_err(got[0], first[0])} "
                                 f"{max_err(got[1], first[1])}")
        ms, first_ms, turns = ms_in_turns(
            lambda: S.bilinear_tiles_coord_grad(*a),
            lambda: bilinear_tiles_coord_grad_first(*a), 20)
        k23[tag] = dict(equal_first_design=same, ms=ms,
                        first_design_ms=first_ms, ms_in_turns=turns,
                        bound_ms=bound_ms(
                            n * 4 + hits * (8 + C * 4)
                            + used * th * tw * C * tt.element_size() + n * 8,
                            hits * (C * 14 + 12))[0])
    print(json.dumps({"kernel_check": "K23 (redesigned) and its first "
                      "design, phase 11's cull", **k23}), flush=True)
    return {
        "tile_lookup_coords": dict(
            max_abs_err=0.0, samples=n, hits=hits,
            ms=cuda_ms(lambda: R.tile_lookup_coords(*args), 20),
            plain_ms=cuda_ms(lambda: R.tile_lookup_coords_plain(*args), 5),
            library_ms=None,
            bound=bound_ms(n * 9 + n_maps + n * 16, n * 12)),
        "bilinear_tiles_coord_grad": dict(
            max_abs_err=max(max_err(a, b) for a, b in zip(gk, gp)),
            max_rel_err=e23, samples=n, hits=hits,
            ms=k23["f32"]["ms"],
            first_design_ms=k23["f32"]["first_design_ms"],
            ms_in_turns=k23["f32"]["ms_in_turns"],
            equal_first_design=[k23[t]["equal_first_design"]
                                for t in ("f32", "bf16")],
            bf16=k23["bf16"],
            plain_ms=cuda_ms(lambda: S.bilinear_tiles_coord_grad_plain(
                *kargs), 3),
            library_ms=None,
            bound=bound_ms(n * 4 + hits * (8 + C * 4) + used * th * tw * C * 4
                           + n * 8, hits * (C * 14 + 12)))}


def geo_kernel_phase():
    """Phase 29: K20/K21 at flat and perturbed verts, K22 at the perturbed
    warp's coordinates, on phase 9's stage-1 setup; K1's coordinate entry
    and K23 on phase 11's cull.  Returns the kernel records."""
    from videoloop3d_torch.render import geo_warp as GW
    args, model, params, batch = s1_setup("shipped")
    verts = params["verts"]
    rec = {}
    for tag, v in (("flat", verts), ("perturbed", perturb_verts(model.geom,
                                                                verts))):
        r, (x, y, _) = check_geo_warp(model, batch, v, tag)
        print(json.dumps({"kernel_check": f"geo_warp/{tag}",
                          **{k: v2 for k, v2 in r.items()
                             if not isinstance(v2, dict)}}), flush=True)
        rec[tag] = r
    for name in ("geo_warp_fwd", "geo_warp_bwd"):
        rec[name] = rec["perturbed"][name]
        rec[name]["flat_ms"] = rec["flat"][name]["ms"]
        rec[name]["flips_flat_perturbed"] = [rec["flat"]["flips"],
                                             rec["perturbed"]["flips"]]
        rec[name]["flat_first_design_ms"] = \
            rec["flat"][name]["first_design_ms"]
    # K20 on an oblique view over a fine grid: samples on the global route
    fwd = geo_oblique_inputs()
    got, hdr = GW.geo_warp_fwd(*fwd, with_headers=True)
    ob = check_geo_fwd_redesign(fwd, got, hdr, "oblique")
    if not ob["global_samples"] > 0:
        raise AssertionError("geo_warp_fwd (oblique): no sample took the "
                             "global route")
    rec["geo_warp_fwd"]["oblique"] = {
        k: ob[k] for k in ("ms", "first_design_ms", "equal_first_design",
                           "global_samples")} | {"samples": got[0].numel()}
    print(json.dumps({"kernel_check": "geo_warp_fwd/oblique",
                      **rec["geo_warp_fwd"]["oblique"]}), flush=True)
    rec["sample_dense_coord_grad"] = check_dense_coord_grad(
        model.geom, x.contiguous(), y.contiguous())
    del model, params
    _, smodel, sparams, sbatch, _ = s1_sparse_setup()
    rec.update(check_tile_coord_kernels(
        smodel, sparams, sbatch, perturb_verts(smodel.geom,
                                               sparams["verts"])))
    for name in GEO_KERNELS:
        r = dict(rec[name])
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": name, **r, "bound_ms": b,
                          "bound_by": by}), flush=True)
    return {k: rec[k] for k in GEO_KERNELS}


def geo_step_grads(model, args, params, batch, plain):
    """Metrics and gradients (every parameter) of one geo step with the
    kernels, or with the plain versions composed in their place."""
    import torch
    from videoloop3d_torch.models import mpmesh
    from videoloop3d_torch.render import geo_warp as GW
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1

    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    saved = (GW.warp_coordinates_verts, renderer.sample_dense,
             mpmesh.fused_composite_s1, renderer.tile_lookup_coords,
             renderer.sample_sparse)
    if plain:
        GW.warp_coordinates_verts = GW.warp_coordinates_verts_plain
        renderer.sample_dense = plain_sample
        mpmesh.fused_composite_s1 = make_plain_fused_s1()
        renderer.tile_lookup_coords = renderer.tile_lookup_coords_plain
        renderer.sample_sparse = make_plain_tile_sample()
    try:
        total, metrics = TS1.make_stage1_loss_fn(model, args, *S1_PATCH)(
            p, batch, weights)
        total.backward()
    finally:
        (GW.warp_coordinates_verts, renderer.sample_dense,
         mpmesh.fused_composite_s1, renderer.tile_lookup_coords,
         renderer.sample_sparse) = saved
    return ({k: float(torch.as_tensor(v).detach())
             for k, v in metrics.items()}, {k: t.grad for k, t in p.items()})


def check_geo_step(tag, args, model, params, batch, need):
    """Phase 30: one geo step with the kernels against its plain
    composition: metrics to 1e-5 relative, every gradient to
    1e-5 * max|g|; the kernel step launches each kernel of `need` (name:
    launches) that many times, the plain one nothing."""
    from videoloop3d_torch import kernels
    kernels.reset_launches()
    m_k, g_k = geo_step_grads(model, args, params, batch, plain=False)
    launched = dict(kernels.LAUNCHES)
    m_p, g_p = geo_step_grads(model, args, params, batch, plain=True)
    idle = [k for k, n in need.items() if launched[k] != n]
    if kernels.LAUNCHES != launched or idle:
        raise AssertionError(f"geo step {tag}: kernels {launched}, plain "
                             f"{kernels.LAUNCHES}, not once: {idle}")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = {k: max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
            for k in g_k if g_p[k] is not None}
    if not (rel <= 1e-5 and max(grel.values()) <= 1e-5
            and float(g_p["verts"].abs().max()) > 0):
        raise AssertionError(f"geo step {tag} differs from its plain "
                             f"composition: metrics {rel}, grads {grel}")
    return {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
            "loss": m_k["loss"]}


def geo_step_phase():
    """Phase 30: a dense geo step on each route, one of the rgba_sh and
    one of the rgb_sh decoder (K22 at 36 and 13 channels, each profiled
    with either K22 design too), and a sparse geo step on phase 11's cull,
    at perturbed verts, against their plain compositions, and a profile of
    each.  Returns {step: fields}."""
    import torch
    dense_need = dict.fromkeys(("geo_warp_fwd", "geo_warp_bwd",
                                "sample_dense", "sample_dense_grad",
                                "sample_dense_coord_grad"), 1)
    out = {}
    for route in S1_ROUTES:
        args, model, params, batch = s1_setup(route)
        model.optimize_geometry = True
        params["verts"] = perturb_verts(model.geom, params["verts"])
        need = dict(dense_need)
        if route == "fused":
            need.update(fused_s1_fwd=1, fused_s1_bwd=1)
        out[route] = check_geo_step(route, args, model, params, batch, need)
        print(json.dumps({"plain_step_check": f"stage-1 geo, {route}",
                          **out[route]}), flush=True)
        print(json.dumps({"profile": f"stage-1 geo step, {route} route",
                          **profile_s1_step(args, model, params, batch)}),
              flush=True)
        if route == "shipped":
            for k in ("K20", "K21"):
                print(json.dumps({
                    "profile_compare": f"stage-1 geo step, shipped route: "
                    f"{k}'s first design against its redesign",
                    **compare_geo_designs(args, model, params, batch, k)}),
                    flush=True)
        del model, params
        torch.cuda.empty_cache()
    for kind in SH_GEO_DECODERS:
        out[kind] = check_sh_geo_step(kind, dense_need)
        torch.cuda.empty_cache()
    args, model, params, batch, _ = s1_sparse_setup()
    model.optimize_geometry = True
    params["verts"] = perturb_verts(model.geom, params["verts"])
    out["sparse"] = check_geo_step(
        "sparse", args, model, params, batch,
        {"geo_warp_fwd": 1, "geo_warp_bwd": 1, "tile_lookup_coords": 1,
         "bilinear_tiles": 2, "bilinear_tiles_grad": 2,
         "bilinear_tiles_coord_grad": 2, "warp_lookup": 0})
    print(json.dumps({"plain_step_check": "stage-1 geo, sparse",
                      **out["sparse"]}), flush=True)
    print(json.dumps({"profile": "stage-1 geo step, sparse",
                      **profile_s1_step(args, model, params, batch)}),
          flush=True)
    for k in ("K20", "K21"):
        print(json.dumps({"profile_compare": f"stage-1 geo step, sparse: "
                          f"{k}'s first design against its redesign",
                          **compare_geo_designs(args, model, params, batch,
                                                k)}), flush=True)
    return out


# phase 30's SH geo steps: K22 at 36 and 13 channels
SH_GEO_DECODERS = ("rgba_sh", "rgb_sh")


def check_sh_geo_step(kind, need):
    """Phase 30 (b): one dense geo step of the `kind` decoder (the
    unfused route, the loop mask on, moved verts; random atlas channels)
    against its plain composition (`check_geo_step`, launching each kernel
    of `need` once), a profile of it, and its profile with K22's first
    design in its place and with the redesign, in turns.  Returns the
    fields."""
    from videoloop3d_torch.first_designs import sample_dense_coord_grad_first
    from videoloop3d_torch.render import sample as S

    t0 = time.perf_counter()
    args, model, params, batch = s1_decoder_setup(["--rgb_mlp_type", kind])
    model.optimize_geometry = True
    params["verts"] = perturb_verts(model.geom, params["verts"])
    out = check_geo_step(kind, args, model, params, batch, dict(need))
    out["channels"] = int(params["atlas"].shape[-1])
    print(json.dumps({"plain_step_check": f"stage-1 geo, {kind}", **out}),
          flush=True)

    def profile():
        # each profile from the same parameters: its warm-up steps move
        # the verts, and with them the samples K22 reads
        return profile_s1_step(args, model, {k: v.detach().clone()
                                             for k, v in params.items()},
                               batch)
    out["profile"] = profile()
    print(json.dumps({"profile": f"stage-1 geo step, {kind}",
                      **out["profile"]}), flush=True)
    out["k22_in_turns"] = compare_designs(
        profile, S, "sample_dense_coord_grad", sample_dense_coord_grad_first,
        groups=("coord_grad_staged", "sample_dense_coord_grad"))
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps({"profile_compare": f"stage-1 geo step, {kind}: K22's "
                      "first design against its redesign",
                      **out["k22_in_turns"], "wall_s": out["wall_s"]}),
          flush=True)
    return out


def compare_geo_designs(args, model, params, batch, kernel):
    """A geo step's profile with the first design of `kernel` ("K20" or
    "K21") in its place and with the redesign, in turns
    (`compare_designs`; K20/K21's groups)."""
    from videoloop3d_torch.first_designs import (geo_warp_bwd_first,
                                                 geo_warp_fwd_first)
    from videoloop3d_torch.render import geo_warp as GW
    name, first = {"K20": ("geo_warp_fwd", geo_warp_fwd_first),
                   "K21": ("geo_warp_bwd", geo_warp_bwd_first)}[kernel]
    return compare_designs(lambda: profile_s1_step(args, model, params,
                                                   batch),
                           GW, name, first, groups=("geo_",))


def drive_geo_train(scene_dir):
    """Phase 31: train_3d.main with --optimize_geo_start 1 on phase 9's
    scene, the launch counters set to 0 just before each run and read
    just after: (a) --N_iters 3 on both routes (a flat epoch, two geo
    epochs), (b) --N_iters 4 --sparsify_epoch 2 (a flat and a geo dense
    epoch, the cull at 0.03, two sparse geo epochs).  K20/K21 launch once
    per geo step, K22 once per dense geo step, K1's coordinate entry once
    and K23 once per non-empty packed atlas (static, dynamic) per sparse
    geo step, none of them in the flat epoch; finite losses; verts move.
    Returns (launches summed over the runs, summaries)."""
    from videoloop3d_torch.models import checkpoint as ckpt_io

    def argv(name, n_iters, extra):
        return ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
                "--factor", "1", "--N_iters", str(n_iters),
                "--optimize_geo_start", "1", "--i_video", "1000",
                "--i_img", "9", "--datadir", scene_dir,
                "--expdir", os.path.join(WORK, "s1_geo_runs"),
                "--expname", name, *extra]

    runs = [("shipped", 3, []), ("fused", 3, ["--fused_render"]),
            ("sparse", 4, ["--sparsify_epoch", "2",
                           "--sparsify_alpha_thresh", "0.03"])]
    total = {k: 0 for k in GEO_KERNELS}
    summaries = {}
    for name, n_iters, extra in runs:
        counts, rows, rundir, wall, out = run_train(argv(name, n_iters,
                                                         extra))
        loss = [r["value"] for r in rows if r["tag"] == "stage1/loss"]
        dense_epochs = 2 if name == "sparse" else n_iters
        steps = counts["sample_dense"] // dense_epochs   # per epoch
        dense_geo = steps * (dense_epochs - 1)
        sparse_geo = steps * (n_iters - dense_epochs)
        last = ckpt_io.load_checkpoint(os.path.join(
            rundir, f"ckpt_epoch_{n_iters - 1:04d}.npz"))
        atlases = sum(len(last["params"].get(k, ())) > 0
                      for k in ("atlas", "atlas_dyn")) if sparse_geo else 0
        want = {"geo_warp_fwd": dense_geo + sparse_geo,
                "geo_warp_bwd": dense_geo + sparse_geo,
                "sample_dense_coord_grad": dense_geo,
                "bilinear_tiles_coord_grad": atlases * sparse_geo,
                "tile_lookup_coords": sparse_geo}
        got = {k: counts[k] for k in want}
        # the run starts from the flat grid (mpi_base: no normalize_verts)
        moved = float(np.abs(last["params"]["verts"]
                             - last["geom"].vertex_grid()).max())
        if (got != want or not steps or not np.isfinite(loss).all()
                or not moved > 0
                or out.count("enabling vertex-geometry optimization") != 1
                or counts["warp_lookup"] != 0):
            raise AssertionError(f"geo run {name}: launches {got} (want "
                                 f"{want}, K1 {counts['warp_lookup']}), "
                                 f"verts moved {moved}, loss {loss}")
        warm = {r["tag"].split("/")[1]: r["value"] for r in rows
                if r["tag"].startswith("stage1/warm_step_ms")}
        cull = [ln for ln in out.splitlines() if "tile culling: keep" in ln]
        summaries[name] = {"cli_wall_s": wall, "steps_per_epoch": steps,
                           "cull": cull[0] if cull else None,
                           "launches": got, "verts_max_move": moved,
                           "warm_ms_per_step": warm,
                           "loss_first_last": [loss[0], loss[-1]]}
        for k in GEO_KERNELS:
            total[k] += counts[k]
        print(json.dumps({"train_3d": f"--optimize_geo_start 1, {name}",
                          **summaries[name]}), flush=True)
    return total, summaries


def geo_phases(scene_dir):
    """Phases 29-31.  Returns (kernel records, with phase 30's SH geo
    steps under "sh_geo_steps"; launches of the trainer runs)."""
    rec = geo_kernel_phase()
    steps = geo_step_phase()
    rec["sh_geo_steps"] = {k: steps[k] for k in SH_GEO_DECODERS}
    launches, _ = drive_geo_train(scene_dir)
    return rec, launches


def swd_inputs(model, params, batch, cfg, seed):
    """The swd loss's inputs on the s2_setup patch under `cfg` (as
    train/stage2.py:make_patch_loss_fn builds them, scale-invariant gain
    left out): v = 2 x - 1 of the loop-padded render (3, F + pt - 1, h, w)
    and of the video (3, F, h, w), f32; the draws (cfg's num_proj, 256 in
    mpv_base) from a seeded generator, the normalized projections (P, d), the match maps, the
    patch and strides."""
    import torch
    from videoloop3d_torch.losses import swd as SW
    with torch.no_grad():
        rgb, _ = model.render(params, *S2_PATCH, batch["extrin"],
                              batch["intrin"], None, training=True)
    pt, p = cfg["patcht_size"], cfg["patch_size"]
    x = rgb.permute(3, 0, 1, 2)
    x = torch.cat([x, x[:, :pt - 1]], dim=1)
    y = batch["video"].permute(3, 0, 1, 2)
    vx = (x.float() * 2 - 1).contiguous()
    vy = (y.float() * 2 - 1).contiguous()
    psz = (pt, p, p)
    strides = (cfg["stridet"], cfg["stride"], cfg["stride"])
    cfx = (vx.shape[1] - pt) // strides[0] + 1
    cfy = (vy.shape[1] - pt) // strides[0] + 1
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    draws = SW.swd_draws(gen, cfg["num_proj"], 3, pt, p,
                         SW.swd_n_short(cfx, cfy))
    rand = SW.normalized_projections(draws["rand"])
    maps = SW._match_maps(cfx, cfy, draws["perm"], vx.device)
    return vx, vy, draws, rand, maps, psz, strides


def kernel_split_ms(fn, calls=3, expect_ms=None, tries=3):
    """{CUDA function: device ms a call} of fn() from one profile of
    `calls` calls (the kernels of a two-pass wrapper timed apart).  With
    expect_ms (fn's CUDA-event time), a profile whose kernels add up to
    less than 0.8 of it (the profiler dropped events) is taken again, up
    to `tries` times, and the split's share of expect_ms is returned
    beside it as "covered"."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        by_name, _ = profiled(lambda: ([fn() for _ in range(calls)],
                                       torch.cuda.synchronize()))
        split = {k: g["device_ms"] / calls
                 for k, g in device_groups(by_name).items()}
        if expect_ms is None:
            return split
        covered = sum(split.values()) / expect_ms
        if covered >= 0.8:
            break
    return split | {"covered": covered}


def check_swd_view(vx, vy, rand, maps, psz, strides):
    """K24, K25 and K26 against their plain versions on one view's inputs:
    K24 and K26 within 1e-5 * max|out| (f32 sums in another order), K25's
    gradient equal to its plain version's and its loss within 1e-6
    relative on K24's output; K24 (on x and y) and K26 bit for bit
    against their first designs; then a static region (the top half's
    frames equal to its first): K24 gives equal projections down each of
    its columns, bit for bit, and K25's gradient there equals its plain
    version's (exact ties broken in index order).  Timed (CUDA events)
    with bounds, library yardsticks and (K24, K26) the first designs;
    K26's GEMM and fold timed apart from a profile, for either design.
    Returns the three records."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.first_designs import (swd_project_first,
                                                 swd_project_grad_first,
                                                 swd_sort_l1_first)
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.losses.patch_nn import extract_patches_3d

    P, d = rand.shape
    ox = SW.swd_project(vx, rand, psz, strides)
    oy = SW.swd_project(vy, rand, psz, strides)
    first24 = bool(torch.equal(ox, swd_project_first(vx, rand, psz, strides))
                   and torch.equal(oy, swd_project_first(vy, rand, psz,
                                                         strides)))
    ox_p = SW.swd_project_plain(vx, rand, psz, strides)
    e24 = max_err(ox, ox_p) / float(ox_p.abs().max())
    del ox_p
    loss_k, gx = SW.swd_sort_l1(ox, oy, *maps)
    loss_p, gx_p = SW.swd_sort_l1_plain(ox, oy, *maps)
    e25 = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    same = bool(torch.equal(gx, gx_p))
    del gx_p
    k25 = check_sort_l1_redesign(ox, oy, maps, loss_k, gx)
    g = SW.swd_project_grad(gx, rand, tuple(vx.shape), psz, strides)
    first26 = bool(torch.equal(g, swd_project_grad_first(
        gx, rand, tuple(vx.shape), psz, strides)))
    g_p = SW.swd_project_grad_plain(gx, rand, tuple(vx.shape), psz, strides)
    e26 = max_err(g, g_p) / float(g_p.abs().max())
    del g_p
    if not (e24 <= 1e-5 and e25 <= 1e-6 and same and e26 <= 1e-5
            and first24 and first26):
        raise AssertionError(f"swd kernels disagree with their plain "
                             f"versions: K24 {e24}, K25 loss {e25} grad "
                             f"equal {same}, K26 {e26}; with their first "
                             f"designs: K24 {first24}, K26 {first26}")
    # a static region: exact ties down its columns
    h = vx.shape[2]
    vs = vx.clone()
    vs[:, :, :h // 2] = vx[:, :1, :h // 2]
    os_ = SW.swd_project(vs, rand, psz, strides)
    tied = (os_ == os_[..., :1]).all(dim=2)
    ch = (h - psz[1]) // strides[1] + 1
    cw = (vx.shape[3] - psz[2]) // strides[2] + 1
    top = (h // 2 - psz[1]) // strides[1] + 1     # rows inside the region
    if not bool(tied.view(P, ch, cw)[:, :top].all()):
        raise AssertionError("K24: equal patches gave unequal projections")
    ls, gs = SW.swd_sort_l1(os_, oy, *maps)
    _, gs_p = SW.swd_sort_l1_plain(os_, oy, *maps)
    ls_f, gs_f = swd_sort_l1_first(os_, oy, *maps)
    if not (torch.equal(gs, gs_p) and torch.equal(gs, gs_f)
            and torch.equal(ls, ls_f)):
        raise AssertionError("K25: exact ties broken otherwise than by the "
                             "plain (stable) sort or the first design")
    del vs, os_, gs, gs_p
    cf = ox.shape[2]
    n_loc = cf * ch * cw
    ops = 2 * P * d * n_loc
    # library yardsticks: cuDNN's conv3d (no TF32) and its input gradient
    # (its (1, P, cf, ch, cw) cotangent made outside the timing); a stable
    # torch.sort of both matched column sets, |.| and the mean
    w = rand.view((P, vx.shape[0]) + tuple(psz))
    gy = gx.transpose(1, 2).reshape(1, P, cf, ch, cw).contiguous()
    ax = ox.view(-1, cf)
    ay = oy.view(-1, oy.shape[2])
    if maps[0] is not None:
        ax = ax[:, maps[0].long()]
    if maps[1] is not None:
        ay = ay[:, maps[1].long()]
    ax, ay = ax.contiguous(), ay.contiguous()
    n = ax.shape[1]

    def lib25():
        return (torch.sort(ax, dim=1, stable=True)[0]
                - torch.sort(ay, dim=1, stable=True)[0]).abs().mean()

    r24 = dict(max_abs_err=e24 * float(ox.abs().max()), max_rel_err=e24,
               equal_first_design=first24,
               ms=cuda_ms(lambda: SW.swd_project(vx, rand, psz, strides), 5),
               first_design_ms=cuda_ms(lambda: swd_project_first(
                   vx, rand, psz, strides), 5),
               plain_ms=cuda_ms(lambda: SW.swd_project_plain(
                   vx, rand, psz, strides), 2),
               library_ms=cuda_ms(lambda: TF.conv3d(vx[None], w,
                                                    stride=strides), 5),
               bound=bound_ms((vx.numel() + rand.numel() + ox.numel()) * 4,
                              ops))
    ncols = ax.shape[0]
    # a comparison sort's least compares, both sides: 2 n ceil(log2 n)
    compares = 2 * n * int(np.ceil(np.log2(n))) * ncols
    r25 = dict(max_abs_err=abs(float(loss_k) - float(loss_p)),
               loss_rel_err=e25, grad_equal_plain=same,
               static_grad_equal_plain=True,
               static_equal_first_design=True, columns=ncols, length=n,
               compares=compares, **k25,
               plain_ms=cuda_ms(lambda: SW.swd_sort_l1_plain(ox, oy, *maps),
                                2),
               library_ms=cuda_ms(lib25, 3),
               bound=bound_ms((ox.numel() * 2 + oy.numel()) * 4, compares))
    # what the FP32 pipes give a library GEMM of the same products: cuBLAS
    # (TF32 off) on the patch matrix extracted beforehand, K24's (P x d)
    # (d x N) and K26's first pass (N x P) (P x d)
    pm = extract_patches_3d(vx, psz, strides).reshape(-1, d)
    gm = gx.reshape(P, -1)
    r24["gemm_library_ms"] = cuda_ms(lambda: torch.mm(rand, pm.T), 5)
    gemm26_ms = cuda_ms(lambda: torch.mm(gm.T, rand), 5)
    del pm
    shape = tuple(vx.shape)
    split = kernel_split_ms(lambda: SW.swd_project_grad(gx, rand, shape, psz,
                                                        strides))
    split1 = kernel_split_ms(lambda: swd_project_grad_first(gx, rand, shape,
                                                            psz, strides))
    r26 = dict(max_abs_err=e26 * float(g.abs().max()), max_rel_err=e26,
               equal_first_design=first26,
               ms=cuda_ms(lambda: SW.swd_project_grad(
                   gx, rand, tuple(vx.shape), psz, strides), 5),
               first_design_ms=cuda_ms(lambda: swd_project_grad_first(
                   gx, rand, shape, psz, strides), 5),
               gemm_ms=split.get("swd_tile_gemm_kernel"),
               fold_ms=split.get("swd_fold_t_kernel"),
               first_design_gemm_ms=split1.get("swd_gemm_first_kernel"),
               first_design_fold_ms=split1.get("swd_fold_first_kernel"),
               gemm_library_ms=gemm26_ms,
               # the scratch written by the GEMM and read by the fold
               scratch_bytes=n_loc * d * 4,
               plain_ms=cuda_ms(lambda: SW.swd_project_grad_plain(
                   gx, rand, tuple(vx.shape), psz, strides), 2),
               library_ms=cuda_ms(lambda: torch.nn.grad.conv3d_input(
                   (1,) + tuple(vx.shape), w, gy, stride=strides), 5),
               bound=bound_ms((gx.numel() + rand.numel() + g.numel()) * 4,
                              ops))
    return r24, r25, r26


def check_sort_l1_redesign(ox, oy, maps, loss_k, gx):
    """K25's redesign (keys sorted by a warp's bitonic network) against its
    first design (a rank scan a column, vl3d_swd_sort_l1_first), bit for
    bit, on this view's columns and on 8 projections of them with x the
    shorter side (its copies summed through the inverse map); with NaNs in
    both sides of those 8, gx equal to the plain version's (NaNs sorted
    last) and the loss NaN; both designs timed in turns.  Returns the
    record's fields."""
    import torch
    from videoloop3d_torch.first_designs import swd_sort_l1_first
    from videoloop3d_torch.losses import swd as SW

    loss_f, gx_f = swd_sort_l1_first(ox, oy, *maps)
    equal = bool(torch.equal(loss_k, loss_f) and torch.equal(gx, gx_f))
    del gx_f
    # x the shorter side: y's first 8 projections as x, x's as y
    sx, sy = oy[:8].contiguous(), ox[:8].contiguous()
    gen = torch.Generator(device=DEVICE).manual_seed(9)
    nx, ny = sx.shape[2], sy.shape[2]
    perm = torch.randperm(ny // nx * nx, generator=gen, device=DEVICE)
    smaps = SW._match_maps(nx, ny, perm, DEVICE)
    a, b = SW.swd_sort_l1(sx, sy, *smaps), swd_sort_l1_first(sx, sy, *smaps)
    p = SW.swd_sort_l1_plain(sx, sy, *smaps)
    x_shorter = bool(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                     and torch.equal(a[1], p[1]))
    # NaNs in x's and y's columns
    nx_, ny_ = ox[:8].clone(), oy[:8].clone()
    nx_[torch.rand(nx_.shape, generator=gen, device=DEVICE) < 0.05] = \
        float("nan")
    ny_[torch.rand(ny_.shape, generator=gen, device=DEVICE) < 0.05] = \
        float("nan")
    ln, gn = SW.swd_sort_l1(nx_, ny_, *maps)
    lp, gp = SW.swd_sort_l1_plain(nx_, ny_, *maps)
    nan_ok = bool(torch.equal(gn, gp) and torch.isnan(ln)
                  and torch.isnan(lp))
    if not (equal and x_shorter and nan_ok):
        raise AssertionError(f"K25: equal to its first design {equal}, x "
                             f"shorter {x_shorter}, with NaNs as the plain "
                             f"version {nan_ok}")
    ms, first_ms, turns = ms_in_turns(
        lambda: SW.swd_sort_l1(ox, oy, *maps),
        lambda: swd_sort_l1_first(ox, oy, *maps), 5)
    return dict(ms=ms, first_design_ms=first_ms, ms_in_turns=turns,
                equal_first_design=equal, x_shorter_equal=x_shorter,
                nan_grad_equal_plain=nan_ok)


def ssim_scale(xy, mx, my, vx, vy):
    """The term scale of the ssim distance 1 - A B / (Cc D), A = 2 mx my +
    C1, B = 2 (xy - mx my) + C2, Cc = mx^2 + my^2 + C1, D = vx + vy + C2
    (xy the mean product X.Y / d): the covariance cancels xy against
    mx my, whose rounding (a few ulps of their size) reaches the distance
    times 2 A / (Cc D).  Low-contrast patches (D near C2) scale it up
    about a thousandfold, so `flip_gaps` holds a flip to FLIP_LIMIT of
    this scale, as `nn_flips` holds the mse search to its terms'."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    a = 2 * mx * my + c1
    den = (mx * mx + my * my + c1) * (vx + vy + c2)
    return 2 * a.abs() / den * (xy.abs() + (mx * my).abs())


def check_ssim_parent(args, model, params, batch):
    """Phase 33: K11's ssim mode (both views in the shipped bf16 search,
    the ref view in f32) against its plain version, flips only on near
    ties (`flip_gaps` with `ssim_scale`), and its first design's indices
    (vl3d_nn_argmin_ssim_first) bit for bit; K11's "mse" search on f32
    (the ref view, the same CUDA-core search) bit for bit equal to its
    first design (vl3d_nn_argmin_simt); and K12's parent mode (gpnn_down
    at factor 2 on the ref view: K11 on the half-resolution crops, the
    fold of the full-resolution ones) within 1e-5 of its plain version
    and its first design's output (vl3d_nn_fold_first) bit for bit;
    timed, the redesigns beside their first designs, with bounds and
    library yardsticks.  Returns the records."""
    import torch
    from videoloop3d_torch.first_designs import nn_argmin_first, nn_fold_first
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    rec = {}
    for ref, bf16 in ((True, True), (False, True), (True, False)):
        tag = f"{'ref' if ref else 'other'}/{'bf16' if bf16 else 'f32'}"
        cfg = dict(loss_config_from_args(args, ref=ref), nn_bf16=bf16)
        x, y, plan, alpha = s2_loss_inputs(model, params, batch, cfg)
        ntx, nty, nh, nw = plan.grid
        d = x.shape[0] * int(np.prod(plan.psz))
        cols = len(plan.hs) * len(plan.ws) * nh * nw
        # the widened patches (crop-major, as nn_dist_plain's), their
        # statistics; the library below times their GEMM, the ssim
        # epilogue, amin, divide, argmin
        ft, fh, fw = plan.fit
        Xf, Yf = (torch.cat([
            PN.extract_patches_3d(c, plan.psz, plan.strides).reshape(
                -1, nh * nw, d).transpose(0, 1)
            for c in PN._crops(v, plan)]).float().contiguous()
            for v in (x[:, :ft, :fh, :fw], y[:, :plan.fit_ty, :fh, :fw]))
        mx, my = Xf.mean(-1)[..., :, None], Yf.mean(-1)[..., None, :]
        vx_ = ((Xf - mx) ** 2).mean(-1)[..., :, None]
        vy_ = ((Yf - my.transpose(1, 2)) ** 2).mean(-1)[..., None, :]
        YfT = Yf.transpose(1, 2)
        nn_k = PN.nn_argmin(x, y, plan, alpha, "ssim")
        nn_1 = nn_argmin_first(x, y, plan, alpha, "ssim")
        if not torch.equal(nn_k, nn_1):
            raise AssertionError(f"nn_argmin_ssim {tag} differs from its "
                                 f"first design at "
                                 f"{int((nn_k != nn_1).sum())} queries")
        raw = PN.nn_dist_plain(x, y, plan, None, "ssim")
        scale = ssim_scale(torch.bmm(Xf, YfT) / d, mx, my, vx_, vy_)
        _, flips, gap_abs, gap_dist, gap_scale = flip_gaps(
            "nn_argmin_ssim", raw, scale.view(raw.shape), alpha, nn_k)
        del raw, scale

        def lib():
            cov = torch.bmm(Xf, YfT) / d - mx * my
            dd = 1.0 - (2 * mx * my + 1e-4) * (2 * cov + 9e-4) / (
                (mx * mx + my * my + 1e-4) * (vx_ + vy_ + 9e-4))
            if alpha is not None:
                dd = dd / (alpha + torch.amin(dd, dim=1, keepdim=True))
            return torch.argmin(dd, dim=2)

        n_nn = nn_k.numel()
        rec[f"nn_argmin_ssim/{tag}"] = dict(
            max_abs_err=gap_abs, index_flips=int(flips.sum()),
            flip_share=int(flips.sum()) / n_nn, queries=n_nn,
            flip_gap_rel_distance=gap_dist, flip_gap_rel_term_scale=gap_scale,
            flip_limit_rel_term_scale=FLIP_LIMIT,
            equal_to_first_design=True,
            layout=tile_layout(plan, x.shape[0], "ssim"),
            ms=cuda_ms(lambda: PN.nn_argmin(x, y, plan, alpha, "ssim"), 10),
            first_design_ms=cuda_ms(lambda: nn_argmin_first(
                x, y, plan, alpha, "ssim"), 10),
            plain_ms=cuda_ms(lambda: PN.nn_argmin_plain(x, y, plan, alpha,
                                                        "ssim"), 2),
            library_ms=cuda_ms(lib, 5),
            bound=bound_ms((x.numel() + y.numel()) * x.element_size()
                           + n_nn * 4,
                           cols * (nn_search_ops(plan, x.shape[0], 4)
                                   + 16 * ntx * nty),
                           BF16_OPS_PER_S if bf16 else F32_OPS_PER_S))
        if ref and not bf16:
            # the "mse" search on f32 inputs: the same CUDA-core search;
            # library: baddbmm + amin + divide + argmin on the patches
            nn_m = PN.nn_argmin(x, y, plan, alpha)
            nn_m1 = nn_argmin_first(x, y, plan, alpha)
            if not torch.equal(nn_m, nn_m1):
                raise AssertionError(
                    f"nn_argmin (f32) differs from its first design at "
                    f"{int((nn_m != nn_m1).sum())} queries")
            _, mflips, mgap, _, mgap_scale = nn_flips(x, y, plan, alpha,
                                                      nn_m)
            xx = (Xf * Xf).sum(-1)[..., :, None]
            yy = (Yf * Yf).sum(-1)[..., None, :]

            def lib_mse():
                dd = torch.baddbmm(xx + yy, Xf, YfT, alpha=-2.0) / d
                if alpha is not None:
                    dd = dd / (alpha + torch.amin(dd, dim=1, keepdim=True))
                return torch.argmin(dd, dim=2)

            rec["nn_argmin/ref/f32"] = dict(
                max_abs_err=mgap, index_flips=int(mflips.sum()),
                queries=nn_m.numel(), flip_gap_rel_term_scale=mgap_scale,
                equal_to_first_design=True,
                layout=tile_layout(plan, x.shape[0], "mse"),
                ms=cuda_ms(lambda: PN.nn_argmin(x, y, plan, alpha), 10),
                first_design_ms=cuda_ms(lambda: nn_argmin_first(
                    x, y, plan, alpha), 10),
                plain_ms=cuda_ms(lambda: PN.nn_argmin_plain(x, y, plan,
                                                            alpha), 2),
                library_ms=cuda_ms(lib_mse, 5),
                bound=bound_ms((x.numel() + y.numel()) * 4 + n_nn * 4,
                               cols * (nn_search_ops(plan, x.shape[0], 2)
                                       + 5 * ntx * nty)))
        del Xf, Yf, YfT
        torch.cuda.empty_cache()
    # the parent mode: gpnn_down --swd_factor_ref 2 on the ref view
    cfg = dict(loss_config_from_args(args, ref=True), nn_bf16=True)
    x, y, _, alpha = s2_loss_inputs(model, params, batch, cfg)
    psz = (cfg["patcht_size"], cfg["patch_size"], cfg["patch_size"])
    strides = (cfg["stridet"], cfg["stride"], cfg["stride"])
    low, full, _ = PN.down_plans(x.shape[1], y.shape[1], x.shape[2],
                                 x.shape[3], psz, strides, cfg["macro_block"],
                                 2)
    ft, fh, fw = full.fit
    ys = y[:, :full.fit_ty, :fh, :fw].contiguous()
    nn = PN.nn_argmin(PN.resize_hw(x[:, :ft, :fh, :fw], *low.fit[1:]),
                      PN.resize_hw(ys, *low.fit[1:]), low, alpha)
    out_k = PN.nn_fold(ys, nn, full, parent=2)
    out_p = PN.nn_fold_plain(ys, nn, full, 2)
    e = max_err(out_k, out_p)
    if not e <= 1e-5:
        raise AssertionError(f"nn_fold's parent mode disagrees with its "
                             f"plain version: {e}")
    out_1 = nn_fold_first(ys, nn, full, 2)
    if not torch.equal(out_k.view(torch.int32), out_1.view(torch.int32)):
        raise AssertionError("nn_fold's parent mode differs from its first "
                             f"design at {int((out_k != out_1).sum())} "
                             "voxels")
    ms_p, first_p, turns_p = ms_in_turns(
        lambda: PN.nn_fold(ys, nn, full, parent=2),
        lambda: nn_fold_first(ys, nn, full, 2), 20)
    lib = fold_library(ys, PN.parent_indices(nn, full, 2), full)
    covers = float(full.weight[full.weight >= 1].sum())
    rec["nn_fold_parent/ref/bf16"] = dict(
        max_abs_err=e, low_res=list(low.fit), crops=len(full.hs) * len(
            full.ws), span=full.crop_hw[0], equal_to_first_design=True,
        first_design="csrc/nn_fold.cu:vl3d_nn_fold_first",
        layout=PN.nn_fold_layout(full, *ys.shape[:2]),
        first_design_ms=first_p,
        ms_in_turns=turns_p, ms=ms_p,
        plain_ms=cuda_ms(lambda: PN.nn_fold_plain(ys, nn, full, 2), 2),
        library_ms=cuda_ms(lib, 10),
        bound=bound_ms(ys.numel() * ys.element_size() + nn.numel() * 4
                       + out_k.numel() * 4, x.shape[0] * covers
                       + out_k.numel()))
    for name, r in rec.items():
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": f"{name}/stage 2", **r,
                          "bound_ms": b, "bound_by": by}), flush=True)
    return rec


def check_swd_step(args, model, params, batch):
    """Phase 34: one stage-2 step with the swd loss on each view (the
    shipped route, --fp16), with the kernels against the same step made of
    the plain versions (K24-K26's and the render's), the same draws fed to
    both: metrics to 1e-5 relative, the gradient of the loss's f32 input
    to 1e-5 * max|g|, the bf16 atlas gradients to one bf16 ulp (2^-7 *
    max|g|: both sum in f32 and round once to bf16, in another order).
    The kernel step launches K24 twice, K25 and K26 once, and no K11 or
    K12."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    out = {}
    for ref in (True, False):
        cfg = dict(loss_config_from_args(args, ref=ref), loss_name="swd")
        pt, p = cfg["patcht_size"], cfg["patch_size"]
        F = batch["video"].shape[0]
        gen = torch.Generator(device=DEVICE).manual_seed(5)
        draws = SW.swd_draws(gen, cfg["num_proj"], 3, pt, p,
                             SW.swd_n_short(F, F - pt + 1))
        b = dict(batch, draws={"swd": draws})
        kernels.reset_launches()
        m_k, g_k, _ = s2_step_grads(args, model, params, b, cfg,
                                    swd_plain=False)
        launched = dict(kernels.LAUNCHES)
        m_p, g_p, _ = s2_step_grads(args, model, params, b, cfg,
                                    swd_plain=True)
        want = {"swd_project": 2, "swd_sort_l1": 1, "swd_project_grad": 1,
                "nn_argmin": 0, "nn_fold": 0}
        if (kernels.LAUNCHES != launched
                or any(launched[k] != v for k, v in want.items())
                or any(launched[k] == 0 for k in SHIPPED_KERNELS)):
            raise AssertionError(f"launches: kernel step {launched}, plain "
                                 f"step {kernels.LAUNCHES}")
        rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                  for k in m_p)
        grel = {k: max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
                for k in g_k}
        name = "ref" if ref else "other"
        if not (rel <= 1e-5 and grel["swd_input"] <= 1e-5
                and max(grel.values()) <= 2.0 ** -7):
            raise AssertionError(f"stage-2 swd {name} step differs from its "
                                 f"plain composition: metrics {rel}, grads "
                                 f"{grel}")
        out[name] = {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
                     "loss": m_k["loss"], "swd": m_k["swd"]}
    return out


def swd_train_argv(expname, extra):
    return ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--datadir", os.path.join(WORK, "s2_scene"),
            "--expdir", os.path.join(WORK, "s2_runs"), "--expname", expname,
            "--init_from", os.path.join(WORK, "s2_init", "ckpt_epoch_0000.npz"),
            "--mpv_frm_num", "50", "--pyr_num_epoch", "1", "--i_img", "1",
            "--i_video", "1000", *extra]


def drive_train_3dvid_swd():
    """Phase 35: train_3dvid.main with ``--loss_name swd --loss_name_ref
    swd`` on phase 18's setup (the unmodified configs/mpv_base.txt from
    the same sparse stage-1 checkpoint and scene, --pyr_init_level 4
    --pyr_num_epoch 1: levels 4 and 5, 12 + 27 steps), the launch
    counters set to 0 just before and read just after: K24 twice, K25 and
    K26 once per step, K11/K12 (either mode) and K18 never, the shipped
    route's kernels once per step; finite losses.  Returns (launches,
    summary)."""
    from videoloop3d_torch.tools import train_3dvid

    counts, rows, rundir, wall, _ = run_train(swd_train_argv(
        "s2swd", ["--pyr_init_level", "4", "--loss_name", "swd",
                  "--loss_name_ref", "swd"]), train_3dvid)
    loss = [r["value"] for r in rows if r["tag"] == "stage2/loss"]
    n = len(loss)
    want = {k: n for k in SHIPPED_KERNELS}
    want.update(swd_project=2 * n, swd_sort_l1=n, swd_project_grad=n,
                nn_argmin=0, nn_fold=0, nn_argmin_ssim=0, nn_fold_parent=0,
                nn_band_argmin=0, composite=0, warp_lookup=n + 3 * 2)
    bad = {k: counts[k] for k in want if counts[k] != want[k]}
    if bad or n != 39 or not np.isfinite(loss).all():
        raise AssertionError(f"swd run: launches {bad}, loss {loss}")
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    shutil.rmtree(rundir, ignore_errors=True)
    return counts, {"cli_wall_s": wall, "steps": n, "launches": counts,
                    "warm_step_ms": warm,
                    "loss_first_last": [loss[0], loss[-1]]}


def drive_train_3dvid_down():
    """Phase 36: train_3dvid.main with ``--loss_name_ref gpnn_down
    --swd_factor_ref 2 --swd_dist_fn ssim`` on phase 18's setup at level 5
    only (--pyr_init_level 5, 27 steps): the ref views' steps search with
    K11 on the half-resolution crops and fold with K12's parent mode, the
    other views' search with K11's ssim mode and fold with K12; K24-K26
    never; finite losses.  Returns (launches, summary)."""
    from videoloop3d_torch.tools import train_3dvid

    counts, rows, rundir, wall, _ = run_train(swd_train_argv(
        "s2down", ["--pyr_init_level", "5", "--loss_name_ref", "gpnn_down",
                   "--swd_factor_ref", "2", "--swd_dist_fn", "ssim"]),
        train_3dvid)
    loss = [r["value"] for r in rows if r["tag"] == "stage2/loss"]
    n = len(loss)
    n_ref = counts["nn_fold_parent"]
    ok = (n == 27 and 0 < n_ref < n and counts["nn_argmin"] == n_ref
          and counts["nn_argmin_ssim"] == counts["nn_fold"] == n - n_ref
          and not any(counts[k] for k in SWD_KERNELS)
          and np.isfinite(loss).all())
    if not ok:
        raise AssertionError(f"gpnn_down + ssim run: launches {counts}, "
                             f"loss {loss}")
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    shutil.rmtree(rundir, ignore_errors=True)
    return counts, {"cli_wall_s": wall, "steps": n, "ref_view_steps": n_ref,
                    "launches": counts, "warm_step_ms": warm,
                    "loss_first_last": [loss[0], loss[-1]]}


def swd_phases():
    """Phases 32-36: the swd loss's kernels, K11's ssim and K12's parent
    modes, a swd step and its profile, and the trainer with swd and with
    gpnn_down + ssim.  Returns (records, launches of the trainer runs)."""
    import torch
    from videoloop3d_torch.first_designs import (swd_project_first,
                                                 swd_project_grad_first,
                                                 swd_sort_l1_first)
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    args, model, params, batch = s2_setup()
    rec = {}
    for ref in (True, False):
        cfg = loss_config_from_args(args, ref=ref)
        tag = "ref" if ref else "other"
        vx, vy, _, rand, maps, psz, strides = swd_inputs(model, params,
                                                         batch, cfg, 3)
        for name, r in zip(SWD_KERNELS, check_swd_view(vx, vy, rand, maps,
                                                       psz, strides)):
            rec[f"{name}/{tag}"] = r
            r = dict(r)
            b, by = r.pop("bound")
            print(json.dumps({"kernel_check": f"{name}/{tag} view", **r,
                              "bound_ms": b, "bound_by": by}), flush=True)
        del vx, vy, rand
        torch.cuda.empty_cache()
    rec.update(check_ssim_parent(args, model, params, batch))
    torch.cuda.empty_cache()
    g = model.geom
    n_slots = CP.slot_bound(g, model.tile_map_static, model.tile_map_dyn,
                            batch["extrin"].cpu().numpy(),
                            batch["intrin"].cpu().numpy(), *S2_PATCH)
    s2_route(model, "shipped", n_slots)
    print(json.dumps({"plain_step_check": "stage 2, shipped route, swd",
                      **check_swd_step(args, model, params, batch)}),
          flush=True)
    for ref in (True, False):
        cfg = dict(loss_config_from_args(args, ref=ref), loss_name="swd")
        gen = torch.Generator(device=DEVICE).manual_seed(6)
        view = f"{'ref' if ref else 'other'} view, shipped route " \
            f"(S={model.compact_slots} of D={g.n_planes})"
        print(json.dumps({"profile": f"stage-2 step, swd, {view}",
                          **profile_s2_step(args, model, params, batch,
                                            cfg=cfg, gen=gen)}), flush=True)
        print(json.dumps({"profile_compare": f"stage-2 step, swd, {view}: "
                          "K24/K26's first designs against their redesigns",
                          **compare_designs(
                              lambda: profile_s2_step(args, model, params,
                                                      batch, cfg=cfg,
                                                      gen=gen), SW,
                              ("swd_project", "swd_project_grad"),
                              (swd_project_first, swd_project_grad_first),
                              groups=("swd_",))}), flush=True)
        print(json.dumps({"profile_compare": f"stage-2 step, swd, {view}: "
                          "K25's first design against its redesign",
                          **compare_designs(
                              lambda: profile_s2_step(args, model, params,
                                                      batch, cfg=cfg,
                                                      gen=gen), SW,
                              "swd_sort_l1", swd_sort_l1_first,
                              groups=("swd_sort", "swd_sum"))}), flush=True)
    # the other view's step under --swd_dist_fn ssim (gpnn_down's run's
    # other views), with K11's ssim mode in either design
    from videoloop3d_torch.first_designs import nn_argmin_first
    from videoloop3d_torch.losses import patch_nn as PN
    redesign = PN.nn_argmin

    def ssim_first(x, y, plan, alpha=None, dist_fn="mse"):
        if dist_fn == "ssim":
            return nn_argmin_first(x, y, plan, alpha, "ssim")
        return redesign(x, y, plan, alpha, dist_fn)
    cfg = dict(loss_config_from_args(args, ref=False), dist_fn="ssim")
    print(json.dumps({"profile_compare": "stage-2 step, --swd_dist_fn ssim, "
                      f"other view, shipped route (S={model.compact_slots} "
                      f"of D={g.n_planes}): K11's ssim mode, first design "
                      "against its redesign",
                      **compare_designs(lambda: profile_s2_step(
                          args, model, params, batch, cfg=cfg), PN,
                          "nn_argmin", ssim_first)}), flush=True)
    del model, params, batch
    torch.cuda.empty_cache()
    swd_counts, summary = drive_train_3dvid_swd()
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt --loss_name swd "
                      "--loss_name_ref swd, levels 4-5", **summary}),
          flush=True)
    down_counts, summary = drive_train_3dvid_down()
    print(json.dumps({"train_3dvid": "configs/mpv_base.txt --loss_name_ref "
                      "gpnn_down --swd_factor_ref 2 --swd_dist_fn ssim, "
                      "level 5", **summary}), flush=True)
    counts = {k: swd_counts[k] for k in SWD_KERNELS}
    counts.update({k: down_counts[k]
                   for k in ("nn_argmin_ssim", "nn_fold_parent")})
    return rec, counts


# ---------------------------------------------------------------------------
# phases 37-41: the view-dependent decoders (K5/K6/K22 at C channels, the
# tile and plane samplers at C = 13 and 36, a step per decoder, the
# full-width SH path through the CLIs) and the swd mask branch (K27/K28)
# ---------------------------------------------------------------------------

DECODERS = {"rgb_sh": [], "rgba_sh": [],
            "nex_rgb": ["--atlas_cnl", "8"],
            "mlp_alpha": ["--atlas_cnl", "8"]}
MASK_KERNELS = ("swd_mask_sort", "swd_mask_l1")


def check_dense_channels():
    """Phase 37: K5, K6 and K22 at C = 13 (rgb_sh), 36 (rgba_sh) and 8
    (nex_rgb / mlp_alpha at --atlas_cnl 8), with the loop-mask atlas, at
    the shipped stage-1 shapes (phase 8's warp): K5 (the redesign: a
    block's corners once per sample, its outputs swept in output order)
    bit-equal to its plain version and to its first design (a thread per
    (sample, channel)), K6 and K22 within 1e-5 * max|g|; C = 4 again in
    the same call (the float4 kernels), and C = 4 padded to 5 (the general
    kernel) equal to it on the first four channels.  Timed (CUDA events)
    with bounds beside K5's first design, grid_sample and its input (K6)
    or grid (K22) gradient on a (D, C + 1, Ht, Wt) copy made outside the
    timing."""
    import torch
    import torch.nn.functional as TF
    from videoloop3d_torch.first_designs import sample_dense_first
    from videoloop3d_torch.render import sample as S

    _, g, _, atlas4, mask, x, y, _, cot_m = s1_kernel_inputs()
    D, Ht, Wt = g.n_planes, g.mpi_h, g.mpi_w
    n = x.numel()
    touched = touched_texels(x, y, Ht, Wt)
    grid = torch.stack([x[0] / (Wt - 1) * 2 - 1, y[0] / (Ht - 1) * 2 - 1],
                       -1).contiguous()
    f4, _ = S.sample_dense_fwd(atlas4, None, x, y)
    a5 = torch.cat([atlas4, torch.zeros_like(atlas4[..., :1])], -1)
    f5, _ = S.sample_dense_fwd(a5.contiguous(), None, x, y)
    if not torch.equal(f4, f5[..., :4]):
        raise AssertionError("K5's float4 and general-C kernels disagree")
    del f4, f5, a5, atlas4
    rec = {}
    for C in (4, 13, 36, 8):
        gen = torch.Generator(device=DEVICE).manual_seed(C)
        atlas = torch.randn((D, Ht, Wt, C), generator=gen, device=DEVICE)
        cot = torch.randn(x.shape + (C,), generator=gen, device=DEVICE)
        feats, mfeats = S.sample_dense_fwd(atlas, mask, x, y)
        e5 = max(max_err(feats, S.bilinear_planes_plain(atlas, x, y)),
                 max_err(mfeats, S.bilinear_planes_plain(mask, x, y)))
        first, mfirst = sample_dense_first(atlas, mask, x, y)
        first_equal = bool(torch.equal(feats, first)
                           and torch.equal(mfeats, mfirst))
        del first, mfirst
        if not first_equal:
            raise AssertionError(f"K5 at C = {C} differs from its first "
                                 "design")
        ga, gm = S.sample_dense_grad(cot, cot_m, x, y, atlas.shape,
                                     mask.shape)
        pa = S.bilinear_planes_grad_plain(cot, x, y, atlas.shape)
        e6 = max_err(ga, pa) / float(pa.abs().max())
        del ga, gm, pa
        gx, gy = S.sample_dense_coord_grad(cot, cot_m, atlas, mask, x, y)
        px, py = S.bilinear_planes_coord_grad_plain(cot, atlas, x, y)
        mx, my = S.bilinear_planes_coord_grad_plain(cot_m, mask, x, y)
        px, py = px + mx, py + my
        e22 = max(max_err(gx, px) / float(px.abs().max()),
                  max_err(gy, py) / float(py.abs().max()))
        del gx, gy, px, py, mx, my
        if not (e5 == 0.0 and e6 <= 1e-5 and e22 <= 1e-5):
            raise AssertionError(f"K5/K6/K22 at C = {C} disagree with their "
                                 f"plain versions: {e5} {e6} {e22}")
        tex = torch.cat([atlas, mask], -1).permute(0, 3, 1, 2).contiguous()
        tex_g = tex.clone().requires_grad_(True)
        out_g = TF.grid_sample(tex_g, grid, mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        cot_gs = torch.cat([cot, cot_m], -1)[0].permute(0, 3, 1, 2) \
            .contiguous()
        grid_g = grid.clone().requires_grad_(True)
        out_gg = TF.grid_sample(tex, grid_g, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
        c1 = C + 1
        rec[f"sample_dense/C{C}"] = dict(
            max_abs_err=e5, first_design_equal=first_equal,
            ms=cuda_ms(lambda: S.sample_dense_fwd(atlas, mask, x, y), 10),
            # C = 4 takes the float4 kernel, which was not redesigned
            first_design_ms=cuda_ms(
                lambda: sample_dense_first(atlas, mask, x, y), 10)
            if C != 4 else None,
            plain_ms=cuda_ms(lambda: (S.bilinear_planes_plain(atlas, x, y),
                                      S.bilinear_planes_plain(mask, x, y)),
                             3),
            library_ms=cuda_ms(lambda: TF.grid_sample(
                tex, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True), 10),
            bound=bound_ms(n * 8 + touched * 4 * c1 + n * 4 * c1,
                           n * 11 * c1))
        rec[f"sample_dense_grad/C{C}"] = dict(
            max_rel_err=e6,
            ms=cuda_ms(lambda: S.sample_dense_grad(
                cot, cot_m, x, y, atlas.shape, mask.shape), 10),
            plain_ms=cuda_ms(lambda: S.bilinear_planes_grad_plain(
                cot, x, y, atlas.shape), 2),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                out_g, tex_g, cot_gs, retain_graph=True), 10),
            bound=bound_ms(D * Ht * Wt * 4 * c1 + n * 4 * c1 + n * 8,
                           n * 9 * c1))
        k22 = check_k22_designs(atlas, mask, cot, cot_m, x, y, touched)
        print(json.dumps({"kernel_check": f"sample_dense_coord_grad designs"
                          f"/C{C}", **k22}), flush=True)
        rec[f"k22/C{C}"] = k22
        rec[f"sample_dense_coord_grad/C{C}"] = dict(
            max_rel_err=e22, first_design_ms=k22["f32"]["first_design_ms"],
            ms=cuda_ms(lambda: S.sample_dense_coord_grad(
                cot, cot_m, atlas, mask, x, y), 10),
            plain_ms=cuda_ms(lambda: S.bilinear_planes_coord_grad_plain(
                cot, atlas, x, y), 2),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                out_gg, grid_g, cot_gs, retain_graph=True), 10),
            bound=bound_ms(n * 4 * c1 + n * 16 + touched * 4 * c1,
                           n * 12 * c1))
        del tex, tex_g, out_g, out_gg, grid_g, cot_gs, atlas, cot
        torch.cuda.empty_cache()
    for name, r in rec.items():
        if name.startswith("k22/"):
            continue
        r = dict(r)
        b, by = r.pop("bound")
        print(json.dumps({"kernel_check": name, **r, "bound_ms": b,
                          "bound_by": by}), flush=True)
    return rec


def check_k22_designs(atlas, mask, cot, cot_m, x, y, touched):
    """Phase 37 (b): K22 at the atlas's C on f32 and bf16 texels, with and
    without the loop-mask channel, bit for bit its first design
    (vl3d_sample_dense_coord_grad_first) and, where the wrapper keeps the
    first design (C = 4; bf16 at C % 4 != 0), the staged kernel
    (vl3d_sample_dense_coord_grad_staged) bit for bit it too; the layout
    against the kernel's; f32 and bf16 with the mask timed in turns with
    the first design (and the staged kernel where it is not the route),
    with the bound (texels at their width).  Returns the fields."""
    import torch
    from videoloop3d_torch.first_designs import (
        sample_dense_coord_grad_first, sample_dense_coord_grad_staged)
    from videoloop3d_torch.render import sample as S

    t0 = time.perf_counter()
    D, Ht, Wt, C = atlas.shape
    n = x.numel()
    out = {}
    if C != 4:
        out["layout"] = S.dense_coord_grad_layout(n, C, D, Ht, Wt)
        if S.kernel_dense_coord_grad_layout(n, C, D, Ht, Wt) != out["layout"]:
            raise AssertionError(f"K22's layout at C = {C}: {out['layout']}")
    for dt in (torch.float32, torch.bfloat16):
        a, m = atlas.to(dt), mask.to(dt)
        tag = "f32" if dt == torch.float32 else "bf16"
        staged = S.dense_coord_grad_staged(C, dt)
        same = {}
        for mk in (False, True):
            args = (cot, cot_m if mk else None, a, m if mk else None, x, y)
            got = S.sample_dense_coord_grad(*args)
            first = sample_dense_coord_grad_first(*args)
            other = sample_dense_coord_grad_staged(*args)
            same[f"mask_{mk}"] = all(
                torch.equal(p.view(torch.int32), q.view(torch.int32))
                and torch.equal(p.view(torch.int32), r.view(torch.int32))
                for p, q, r in zip(got, first, other))
            del got, first, other
        if not all(same.values()):
            raise AssertionError(f"K22 at C = {C}, {tag}: {same}")
        args = (cot, cot_m, a, m, x, y)
        ms, first_ms, turns = ms_in_turns(
            lambda: S.sample_dense_coord_grad(*args),
            lambda: sample_dense_coord_grad_first(*args), 10)
        b, by = bound_ms(n * 4 * (C + 1) + n * 16
                         + touched * a.element_size() * (C + 1),
                         n * 12 * (C + 1))
        out[tag] = dict(route="staged" if staged else "first design",
                        equal_first_design=same, ms=ms,
                        first_design_ms=first_ms, ms_in_turns=turns,
                        bound_ms=b, bound_by=by)
        if not staged:
            # the staged kernel where the wrapper keeps the first design
            s_ms, _, s_turns = ms_in_turns(
                lambda: sample_dense_coord_grad_staged(*args),
                lambda: sample_dense_coord_grad_first(*args), 10)
            out[tag].update(staged_ms=s_ms, staged_turns=s_turns)
        del a, m
    out["wall_s"] = time.perf_counter() - t0
    return out


def widened(t, C, gen):
    """t (..., 4) with C - 4 more random channels before its last."""
    import torch
    extra = torch.randn(t.shape[:-1] + (C - 4,), generator=gen,
                        device=t.device).to(t.dtype)
    return torch.cat([t[..., :3], extra, t[..., 3:]], -1).contiguous()


def check_static_gather(ct, k, u, v, shape, gp):
    """K9 at C != 4 (K10's binned gather at F = 1): within 1e-5 * max|g|
    of its plain version's gp, the same bits on a second call, the
    rounding mode bit for bit ``.to(bf16).float()`` of the f32 sums, the
    library's layout equal to the mirror's; timed in turns beside the
    atomic route it replaced (its zero fill and vector atomics,
    vl3d_bilinear_tiles_grad_atomic), rounded and not, the atomic route
    within 1e-5 * max|g| too, and each route's kernels timed apart (a
    profile).  Returns the record's fields."""
    import torch
    from videoloop3d_torch.first_designs import bilinear_tiles_grad_atomic
    from videoloop3d_torch.render import sample as S

    bf16 = torch.bfloat16
    got = S.bilinear_tiles_grad(ct, k, u, v, shape)
    again = S.bilinear_tiles_grad(ct, k, u, v, shape)
    rnd = S.bilinear_tiles_grad(ct, k, u, v, shape, bf16)
    atomic = bilinear_tiles_grad_atomic(ct, k, u, v, shape)
    scale = float(gp.abs().max())
    D = S.tiles_grad_planes(k.shape)
    lay_args = (D, k.numel() // D, *shape, S._vec_width(shape[3], ct))
    out = dict(
        gather_max_rel_err=max_err(got, gp) / scale,
        atomic_max_rel_err=max_err(atomic, gp) / scale,
        same_bits_twice=bool(torch.equal(got, again)),
        rounded_equals_f32_rounded=bool(torch.equal(
            rnd.view(torch.int32), got.to(bf16).float().view(torch.int32))),
        layout=S.static_grad_layout(*lay_args))
    layout_ok = S.kernel_static_grad_layout(*lay_args) == out["layout"]
    if not (out["gather_max_rel_err"] <= 1e-5
            and out["atomic_max_rel_err"] <= 1e-5 and out["same_bits_twice"]
            and out["rounded_equals_f32_rounded"] and layout_ok):
        raise AssertionError(f"K9's gather at C = {shape[3]}: {out}, "
                             f"layout {layout_ok}")
    del got, again, rnd, atomic
    ms, first_ms, turns = ms_in_turns(
        lambda: S.bilinear_tiles_grad(ct, k, u, v, shape),
        lambda: bilinear_tiles_grad_atomic(ct, k, u, v, shape), 10)
    r_ms, r_first_ms, _ = ms_in_turns(
        lambda: S.bilinear_tiles_grad(ct, k, u, v, shape, bf16),
        lambda: bilinear_tiles_grad_atomic(ct, k, u, v, shape, bf16), 10)
    # where the time goes: each kernel of either route (one profile)
    split = kernel_split_ms(lambda: S.bilinear_tiles_grad(ct, k, u, v, shape),
                            expect_ms=ms)
    split_atomic = kernel_split_ms(
        lambda: bilinear_tiles_grad_atomic(ct, k, u, v, shape),
        expect_ms=first_ms)
    return out | dict(grad_ms=ms, grad_atomic_ms=first_ms,
                      grad_ms_in_turns=turns, grad_rounded_ms=r_ms,
                      grad_rounded_atomic_ms=r_first_ms,
                      grad_split_ms=split, grad_atomic_split_ms=split_atomic)


def check_tiles_sweep(tiles32, k, u, v, modes=("f32", "bf16",
                                               "f32 as bf16")):
    """K2 at C != 4 (redesigned: a block's corners found once, its outputs
    swept in output order) on f32 tiles, their bf16 copy and the f32 tiles
    read as bf16: bit for bit its first design (one thread a sample,
    vl3d_bilinear_tiles_first), within 1e-6 of the plain version, both
    timed in turns, with the bound (the indices, coordinates and used
    tiles read once, the samples written).  Returns {mode: fields} and
    the layout."""
    import torch
    from videoloop3d_torch.first_designs import bilinear_tiles_first
    from videoloop3d_torch.render import sample as S

    bf16 = torch.bfloat16
    N, th, tw, C = tiles32.shape
    n, hits = k.numel(), int((k >= 0).sum())
    used = torch.unique(k[k >= 0]).numel()
    out = {"samples": n, "hits": hits, "tiles_used": used,
           "layout": S.bilinear_tiles_layout(n, C)}
    if S.kernel_bilinear_tiles_layout(n, C) != out["layout"]:
        raise AssertionError(f"K2's layout at C = {C}: {out['layout']}")
    for mode in modes:
        tiles = tiles32.to(bf16) if mode == "bf16" else tiles32
        gather = bf16 if mode == "f32 as bf16" else None
        got, _ = S.bilinear_tiles(tiles, k, u, v, gather)
        first, _ = bilinear_tiles_first(tiles, k, u, v, gather)
        ref, _ = S.bilinear_tiles_plain(tiles, k, u, v, gather)
        same = torch.equal(got.view(torch.int32), first.view(torch.int32))
        err = max_err(got, ref)
        if not (same and err <= 1e-6):
            raise AssertionError(f"K2 at C = {C}, {mode}: first design "
                                 f"equal {same}, plain {err}")
        ms, first_ms, turns = ms_in_turns(
            lambda: S.bilinear_tiles(tiles, k, u, v, gather),
            lambda: bilinear_tiles_first(tiles, k, u, v, gather), 10)
        texel = th * tw * C * tiles.element_size()
        b, by = bound_ms(n * 4 + hits * 8 + used * texel + n * C * 4,
                         hits * (9 * C + 10))
        out[mode] = dict(equal_first_design=same, max_abs_err=err, ms=ms,
                         first_design_ms=first_ms, ms_in_turns=turns,
                         plain_ms=cuda_ms(lambda: S.bilinear_tiles_plain(
                             tiles, k, u, v, gather), 2),
                         bound_ms=b, bound_by=by)
        del got, first, ref
    return out


def check_tilemajor_sweep(tiles32, k, u, v, frame_sets,
                          modes=("bf16", "f32 as bf16")):
    """K3 at C != 4 (redesigned: a block's corners found once, its F_sel x
    C outputs swept in output order) on the f32 dynamic tiles' bf16 copy
    and on the f32 tiles read as bf16, at each of `frame_sets` ({name: ts
    or None}): bit for bit its first design (one thread a (sample,
    frame), vl3d_bilinear_tiles_tilemajor_first) and the plain version
    (in slices of samples: its temporaries at C = 36 and 50 frames exceed
    the card's memory at once); timed in turns beside the first design,
    with the bound (the indices, coordinates, ts and the used tiles'
    selected frames read once, the samples written); the layout against
    the kernel's.  Returns {frame set: {mode: fields}}."""
    import torch
    from videoloop3d_torch.first_designs import bilinear_tiles_tilemajor_first
    from videoloop3d_torch.render import sample as S

    bf16, i32 = torch.bfloat16, torch.int32
    N, th, tw, F_all, C = tiles32.shape
    n, hits = k.numel(), int((k >= 0).sum())
    used = torch.unique(k[k >= 0]).numel()
    out = {"samples": n, "hits": hits, "tiles_used": used}
    kf, uf, vf = k.reshape(-1), u.reshape(-1), v.reshape(-1)
    for fname, ts in frame_sets.items():
        F_sel = F_all if ts is None else ts.numel()
        rec = {"frames": F_sel,
               "layout": S.tiles_tilemajor_layout(n, F_sel, C)}
        if S.kernel_tiles_tilemajor_layout(n, F_sel, C) != rec["layout"]:
            raise AssertionError(f"K3's layout at C = {C}, {F_sel} frames: "
                                 f"{rec['layout']}")
        for mode in modes:
            tiles = tiles32.to(bf16) if mode == "bf16" else tiles32
            gather = bf16 if mode == "f32 as bf16" else None
            a = (tiles, k, u, v, ts, gather)
            got, _ = S.bilinear_tiles_tilemajor(*a)
            first, _ = bilinear_tiles_tilemajor_first(*a)
            same = torch.equal(got.view(i32), first.view(i32))
            del first
            gf = got.view(n, F_sel, C)
            same_plain, err, step = True, 0.0, 1 << 17
            for i in range(0, n, step):
                ref, _ = S.bilinear_tiles_tilemajor_plain(
                    tiles, kf[i:i + step], uf[i:i + step], vf[i:i + step],
                    ts, gather)
                same_plain &= torch.equal(gf[i:i + step].view(i32),
                                          ref.view(i32))
                err = max(err, max_err(gf[i:i + step], ref))
                del ref
            del got, gf
            if not (same and same_plain):
                raise AssertionError(
                    f"K3 at C = {C}, {mode}, {fname}: first design equal "
                    f"{same}, plain {same_plain} ({err})")
            ms, first_ms, turns = ms_in_turns(
                lambda: S.bilinear_tiles_tilemajor(*a),
                lambda: bilinear_tiles_tilemajor_first(*a), 5)
            b, by = bound_ms(n * 4 + hits * 8 + F_sel * 4
                             + used * th * tw * F_sel * C
                             * tiles.element_size() + n * F_sel * C * 4,
                             hits * F_sel * (9 * C + 10))
            rec[mode] = dict(equal_first_design=same, equal_plain=same_plain,
                             max_abs_err=err, ms=ms, first_design_ms=first_ms,
                             ms_in_turns=turns, bound_ms=b, bound_by=by)
            del tiles
            torch.cuda.empty_cache()
        out[fname] = rec
    return out


def check_tiles_channels():
    """Phase 38: the tile and plane samplers at the SH decoders' channel
    counts.  On the benchmark MTV (phase 14) widened to C = 13 and 36
    (random channels between the colours and alpha; bf16 texels as under
    --fp16): K1's lookup and K13's compaction (S slots) of the stage-2
    patch, then K2/K9 on the static and K3/K10 on the dynamic tiles at
    the slots; and K16/K17 on a dense (32, 396, 704, 10, 13) bf16 stack
    (the mpv_base scratch planes, 10 of 50 frames: an rgb_sh stack of 50
    frames is 23.2 GB of f32 parameters) and its f32 original gathered as
    bf16, at the training patch.  Samples within 1e-6 of the plain
    versions (K16 bit for bit, and equal to its first design), gradients
    within 1e-5 * max|g| (K17 and its first design; rounded to bf16, the
    f32 sums' rounding bit for bit); timed.  K3 at C != 4 (redesigned)
    also on the f32 dynamic atlas at all 50 frames and a 10-frame chunk,
    and on phase 4's eval chunk, against its first design
    (`check_tilemajor_sweep`)."""
    import torch
    from videoloop3d_torch.first_designs import tiles_tilemajor_grad_first
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.render import renderer as R
    from videoloop3d_torch.render import sample as S

    args, model, params, batch = s2_setup()
    g = model.geom
    G = R.homographies(g, batch["extrin"], batch["intrin"]).contiguous()
    coords, k_s, k_d, fu, fv = R.warp_lookup(
        G, model.tile_map_static, model.tile_map_dyn, *S2_PATCH,
        (g.mpi_h, g.mpi_w), g.tile_span)
    n_slots = CP.slot_bound(g, model.tile_map_static, model.tile_map_dyn,
                            batch["extrin"].cpu().numpy(),
                            batch["intrin"].cpu().numpy(), *S2_PATCH)
    sweep = CP.compact_sweep(k_s[0], k_d[0], fu[0], fv[0], coords.valid[0],
                             coords.zview[0], n_slots)
    ks, kd, u0, v0 = sweep[:4]
    rec = {"slots": n_slots}
    for C in (13, 36, 8):
        gen = torch.Generator(device=DEVICE).manual_seed(C)
        st32 = widened(params["atlas"].detach(), C, gen)
        st = st32.to(torch.bfloat16)
        # the dynamic atlas at the SH decoders' channel counts (nex_rgb's
        # C = 8: the static atlas only)
        dy32 = widened(params["atlas_dyn"].detach(), C, gen) if C != 8 \
            else None
        dy = dy32.to(torch.bfloat16) if C != 8 else None
        th, tw = st.shape[1:3]
        u, v = (u0 * (tw - 1)).contiguous(), (v0 * (th - 1)).contiguous()
        errs = {}
        for name, tiles, k in (("static", st, ks), ("dynamic", dy, kd)):
            if tiles is None:
                continue
            fwd = S.bilinear_tiles if tiles.dim() == 4 \
                else S.bilinear_tiles_tilemajor
            plain = S.bilinear_tiles_plain if tiles.dim() == 4 \
                else S.bilinear_tiles_tilemajor_plain
            grad = S.bilinear_tiles_grad if tiles.dim() == 4 \
                else S.bilinear_tiles_tilemajor_grad
            grad_p = S.bilinear_tiles_grad_plain if tiles.dim() == 4 \
                else S.bilinear_tiles_tilemajor_grad_plain
            out, _ = fwd(tiles, k, u, v)
            ref, _ = plain(tiles, k, u, v)
            ef = max_err(out, ref)
            ct = torch.randn(out.shape, generator=gen, device=DEVICE)
            gk = grad(ct, k, u, v, tiles.shape)
            gp = grad_p(ct, k, u, v, tiles.shape)
            eg = max_err(gk, gp) / float(gp.abs().max())
            if not (ef <= 1e-6 and eg <= 1e-5):
                raise AssertionError(f"tile samplers at C = {C}, {name}: "
                                     f"{ef} {eg}")
            # bounds as the C = 4 records' (phases 11, 14): the indices,
            # coordinates and used tiles read once, the samples written;
            # the gradient reads the cotangent and writes (zeroes) all tiles
            n, hits = k.numel(), int((k >= 0).sum())
            used = torch.unique(k[k >= 0]).numel()
            F = tiles.shape[3] if tiles.dim() == 5 else 1
            texel = tiles.shape[1] * tiles.shape[2] * F * C
            errs[name] = dict(
                max_abs_err=ef, grad_max_rel_err=eg,
                ms=cuda_ms(lambda: fwd(tiles, k, u, v), 10),
                plain_ms=cuda_ms(lambda: plain(tiles, k, u, v), 2),
                bound_ms=bound_ms(n * 4 + hits * 8 + used * texel * 2
                                  + n * F * C * 4, hits * F * (9 * C + 10))[0],
                grad_ms=cuda_ms(lambda: grad(ct, k, u, v, tiles.shape), 10),
                grad_plain_ms=cuda_ms(
                    lambda: grad_p(ct, k, u, v, tiles.shape), 2),
                grad_bound_ms=bound_ms(
                    n * 4 + hits * (8 + F * C * 4)
                    + tiles.shape[0] * texel * 4, hits * F * (8 * C + 10))[0])
            if tiles.dim() == 4:
                errs[name].update(check_static_gather(ct, k, u, v,
                                                      tiles.shape, gp))
            if tiles.dim() == 5:
                # K10 (redesigned) beside its first design; the sums
                # rounded to bf16 as under --fp16
                ef = max_err(tiles_tilemajor_grad_first(
                    ct, k, u, v, tiles.shape), gk) / float(gp.abs().max())
                if not ef <= 1e-5:
                    raise AssertionError(f"K10's first design at C = {C}: "
                                         f"{ef}")
                ms, first_ms, _ = ms_in_turns(
                    lambda: grad(ct, k, u, v, tiles.shape, torch.bfloat16),
                    lambda: tiles_tilemajor_grad_first(ct, k, u, v,
                                                       tiles.shape), 5)
                errs[name].update(grad_rounded_ms=ms,
                                  grad_first_design_ms=first_ms,
                                  grad_first_design_max_rel_err=ef)
            del out, ref, ct, gk, gp
        rec[f"tiles/C{C}"] = errs
        print(json.dumps({"kernel_check": f"K2/K9 static, K3/K10 dynamic, "
                          f"C = {C}, bf16, S = {n_slots}", **errs}),
              flush=True)
        rec[f"k2/C{C}"] = check_tiles_sweep(st32, ks, u, v)
        print(json.dumps({"kernel_check": f"K2 at C = {C} (redesigned) "
                          f"and its first design, S = {n_slots}",
                          **rec[f"k2/C{C}"]}), flush=True)
        del st, st32, dy
        torch.cuda.empty_cache()
        if dy32 is not None:
            # K3 at C != 4 (redesigned) on the dynamic atlas at the slots,
            # all 50 frames (training) and a 10-frame chunk (rendering)
            rec[f"k3/C{C}"] = check_tilemajor_sweep(
                dy32, kd, u, v, {"all": None, "ts10": torch.arange(
                    20, 30, dtype=torch.int32, device=DEVICE)})
            print(json.dumps({"kernel_check": f"K3 at C = {C} (redesigned) "
                              f"and its first design, S = {n_slots}",
                              **rec[f"k3/C{C}"]}), flush=True)
            if C == 13:
                # an SH eval chunk: phase 4's fixed-view lookups, 32
                # planes x 360 x 640, 10 frames
                ev = EVAL_CHUNK_SAMPLES
                rec["k3/eval_C13"] = check_tilemajor_sweep(
                    dy32, ev["k"], ev["u"], ev["v"], {"ts10": ev["ts"]})
                print(json.dumps({"kernel_check": "K3 at C = 13 "
                                  "(redesigned) and its first design, the "
                                  "fixed-view eval chunk",
                                  **rec["k3/eval_C13"]}), flush=True)
        del dy32
        torch.cuda.empty_cache()
    del model, params, batch, sweep, coords, k_s, k_d, fu, fv
    torch.cuda.empty_cache()
    # K2 at C = 13 at the sparse stage-1 shapes (phase 11's samples and
    # static tiles widened, f32 as the stage-1 atlas)
    sp = SPARSE_S1_SAMPLES
    gen = torch.Generator(device=DEVICE).manual_seed(113)
    rec["k2/sparse_s1_C13"] = check_tiles_sweep(
        widened(sp["tiles"], 13, gen), sp["k"], sp["u"], sp["v"],
        modes=("f32",))
    print(json.dumps({"kernel_check": "K2 at C = 13 (redesigned) and its "
                      "first design, sparse stage-1 samples",
                      **rec["k2/sparse_s1_C13"]}), flush=True)
    SPARSE_S1_SAMPLES.clear()
    EVAL_CHUNK_SAMPLES.clear()
    # K16/K17 at C = 13 on a reduced dense stack
    from videoloop3d_torch.first_designs import (
        bilinear_planes_tilemajor_first, bilinear_planes_tilemajor_grad_first)
    _, dmodel, dparams, dbatch, _ = dense_s2_setup()
    dg = dmodel.geom
    coords = R.warp_coordinates(dg, dbatch["extrin"], dbatch["intrin"],
                                *S2_PATCH)
    del dparams
    torch.cuda.empty_cache()
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    bf16 = torch.bfloat16
    tex32 = torch.randn((dg.n_planes, dg.mpi_h, dg.mpi_w, 10, 13),
                        generator=gen, device=DEVICE)
    tex = tex32.to(bf16)
    D, F13 = dg.n_planes, 10
    shape = tuple(tex.shape)
    # (D, h, w), as the dense render passes them: K16 by image tiles
    xs, ys = coords.x[0].contiguous(), coords.y[0].contiguous()
    n = xs.numel()
    touched = planes_touched(xs.reshape(D, -1), ys.reshape(D, -1), dg.mpi_h,
                             dg.mpi_w)
    out = S.bilinear_planes_tilemajor(tex, xs, ys)
    e16 = max_err(out, S.bilinear_planes_tilemajor_plain(tex, xs, ys))
    e16f = max_err(S.bilinear_planes_tilemajor(tex32, xs, ys, None, bf16),
                   out)
    first_eq = bool(torch.equal(out, bilinear_planes_tilemajor_first(
        tex, xs, ys)))
    ct = torch.randn(out.shape, generator=gen, device=DEVICE)
    gp = S.bilinear_planes_tilemajor_grad_plain(ct, xs, ys, shape)
    scale = float(gp.abs().max())
    gk = S.bilinear_planes_tilemajor_grad(ct, xs, ys, shape)
    e17 = max_err(gk, gp) / scale
    gr = S.bilinear_planes_tilemajor_grad(ct, xs, ys, shape, bf16)
    rounded_ok = bool(torch.equal(gr, gk.to(bf16).float())) and \
        bf16_steps_beyond(gr, gp.to(bf16).float(), 1e-5 * scale) == 0
    e17_first = max_err(bilinear_planes_tilemajor_grad_first(
        ct, xs, ys, shape), gp) / scale
    del gk, gp, gr
    torch.cuda.empty_cache()
    if not (e16 == 0.0 and e16f == 0.0 and first_eq and e17 <= 1e-5
            and rounded_ok and e17_first <= 1e-5):
        raise AssertionError(f"K16/K17 at C = 13: {e16} {e16f} {first_eq} "
                             f"{e17} {rounded_ok} {e17_first}")
    rec["planes/C13"] = dict(
        shape=list(shape), max_abs_err=e16, fused_max_abs_err=e16f,
        first_design_equal=first_eq, grad_max_rel_err=e17,
        grad_rounded_equals_f32_rounded=rounded_ok,
        ms=cuda_ms(lambda: S.bilinear_planes_tilemajor(tex, xs, ys), 5),
        fused_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor(
            tex32, xs, ys, None, bf16), 5),
        first_design_ms=cuda_ms(lambda: bilinear_planes_tilemajor_first(
            tex, xs, ys), 5),
        bound_ms=bound_ms(n * 8 + touched * F13 * 13 * 2
                          + n * F13 * 13 * 4, n * F13 * (9 * 13 + 10))[0],
        fused_bound_ms=bound_ms(n * 8 + touched * F13 * 13 * 4
                                + n * F13 * 13 * 4,
                                n * F13 * (9 * 13 + 10))[0],
        grad_ms=cuda_ms(lambda: S.bilinear_planes_tilemajor_grad(
            ct, xs, ys, shape, bf16), 3),
        grad_first_design_ms=cuda_ms(
            lambda: bilinear_planes_tilemajor_grad_first(ct, xs, ys, shape),
            3),
        grad_bound_ms=bound_ms(n * 8 + n * F13 * 13 * 4
                               + D * dg.mpi_h * dg.mpi_w * F13 * 13 * 4,
                               n * F13 * (8 * 13 + 10))[0])
    print(json.dumps({"kernel_check": "K16/K17, C = 13, bf16 and the f32 "
                      "stack gathered as bf16", **rec["planes/C13"]}),
          flush=True)
    del tex, tex32, out, ct
    torch.cuda.empty_cache()
    return rec


def s1_decoder_setup(extra):
    """s1_setup's model, parameters and batch under the extra arguments
    (a decoder or an activation), the colour and alpha channels of the
    atlas set to random values so that every plane shows."""
    import torch
    from videoloop3d_torch.models.mpmesh import MPMesh

    args = s1_args(list(extra))
    H, W = S1_HW
    ph, pw = S1_PATCH
    focal = 0.9 * W
    intrin = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                      np.float32)
    model = MPMesh(args, H, W, np.eye(4, dtype=np.float32), intrin, 2.0,
                   10.0, device=DEVICE)
    params = model.init_params(1)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    with torch.no_grad():
        params["atlas"].normal_(0.0, 1.0, generator=gen)
        params["atlas_mask"].normal_(0.0, 1.0, generator=gen)
    _, _, _, batch = s1_setup("shipped")
    return args, model, params, batch


def s1_decoder_step(extra, plain):
    """Metrics and every gradient of one stage-1 step under extra, with
    the kernels or with the samplers' plain versions composed in their
    place; the launches of the kernel step."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.models.checkpoint import flat_params
    from videoloop3d_torch.render import renderer
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import optimizer as opt_lib
    from videoloop3d_torch.train import stage1 as TS1

    args, model, params, batch = s1_decoder_setup(extra)
    flat = opt_lib.trainable(params)
    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)
    saved = renderer.sample_dense
    if plain:
        renderer.sample_dense = plain_sample
    kernels.reset_launches()
    try:
        total, metrics = TS1.make_stage1_loss_fn(model, args, *S1_PATCH)(
            params, batch, weights)
        total.backward()
    finally:
        renderer.sample_dense = saved
    return ({k: float(torch.as_tensor(v).detach())
             for k, v in metrics.items()},
            {k: t.grad for k, t in flat.items() if t.grad is not None},
            dict(kernels.LAUNCHES), flat_params(params)["atlas"].shape[-1])


def check_decoder_steps():
    """Phase 39: one stage-1 step of each decoder (rgb_sh, rgba_sh, and
    nex_rgb / mlp_alpha at --atlas_cnl 8) and one of the direct decoder
    with --fused_render --rgb_activate clamp, at the shipped width, with
    the kernels against the same step made of the plain versions: metrics
    within 1e-5 relative, every gradient (atlas, loop mask, decoder
    weights) within 1e-5 * max|g|; K5/K6 launched once, K7/K8 never (the
    fused gate)."""
    out = {}
    cases = {k: ["--rgb_mlp_type", k] + v for k, v in DECODERS.items()}
    cases["direct_clamp_fused"] = ["--fused_render", "--rgb_activate",
                                   "clamp"]
    for name, extra in cases.items():
        m_k, g_k, launched, C = s1_decoder_step(extra, plain=False)
        m_p, g_p, plain_launched, _ = s1_decoder_step(extra, plain=True)
        if (launched["sample_dense"] != 1
                or launched["sample_dense_grad"] != 1
                or launched["fused_s1_fwd"] or launched["fused_s1_bwd"]
                or plain_launched["sample_dense"]):
            raise AssertionError(f"{name} step launches: {launched}, plain "
                                 f"{plain_launched}")
        rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                  for k in m_p)
        grel = {k: max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
                for k in g_k}
        if not (rel <= 1e-5 and max(grel.values()) <= 1e-5):
            raise AssertionError(f"{name} step differs from its plain "
                                 f"composition: {rel} {grel}")
        out[name] = {"channels": C, "metrics_max_rel_err": rel,
                     "grads_max_rel_err": grel, "loss": m_k["loss"],
                     "launches": {k: v for k, v in launched.items() if v}}
        print(json.dumps({"plain_step_check": f"stage 1, {name}",
                          **out[name]}), flush=True)
    return out


def s1_cli_argv(scene_dir, expname, extra):
    return ["--config", os.path.join(REPO, "configs", "mpi_base.txt"),
            "--factor", "1", "--i_video", "1000", "--datadir", scene_dir,
            "--expdir", os.path.join(WORK, "sh_runs"), "--expname", expname,
            *extra]


def drive_sh_path(s1_scene_dir):
    """Phase 40: the full-width SH path through the CLIs, each with the
    launch counters set to 0 just before and read just after.
    (a) train_3d on mpi_base at --factor 1 with --direct2sh_epoch 1
    --N_iters 4 --sparsify_epoch 2 --fused_render (cull threshold 0.03 as
    in phase 12) on phase 9's scene: the direct epoch takes K7/K8, the
    converted ones never; K5/K6 in the 2 dense epochs, K1/K2/K9 in the 2
    sparse ones on 13-channel tiles; the conversion and cull lines; finite
    losses; warm ms/step per phase.  (b) train_3dvid on the unmodified
    mpv_base (--factor 1 --mpv_frm_num 50) from (a)'s sparse checkpoint on
    phase 18's scene, levels 4 and 5: it adopts rgb_sh, its
    --fused_render falls to the unfused chain (K14/K15 never) with
    --compact_hits on (K13 where a level compacts), K4 never; the cull
    after 2 epochs keeps no dynamic tile here, so K3/K10 run where there
    are some (phase 40 (g)).  (c) render_video of the SH MTV (fixed view,
    50 frames: K1, K2, K3 where there are dynamic tiles, K4 never) and
    (d) evaluate
    (eval_metrics.txt, finite values).  (e) train_3d --rgb_mlp_type
    rgba_sh from scratch, 2 dense epochs (C = 36), then a geometry epoch
    (--optimize_geo_start 2 --N_iters 3): K22 (at C = 36), K20 and K21
    once a geometry step and never in the flat epochs; and (f) one epoch
    each of nex_rgb and mlp_alpha at --atlas_cnl 8."""
    import torch
    from videoloop3d_torch.models import checkpoint as ckpt_io
    from videoloop3d_torch.tools import evaluate, render_video, train_3dvid

    out = {}
    counts, rows, rundir, wall, text = run_train(s1_cli_argv(
        s1_scene_dir, "sh", ["--direct2sh_epoch", "1", "--N_iters", "4",
                             "--sparsify_epoch", "2",
                             "--sparsify_alpha_thresh", "0.03",
                             "--fused_render", "--i_img", "1"]))
    loss = [r["value"] for r in rows if r["tag"] == "stage1/loss"]
    steps = len(loss)
    epoch = steps // 4
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    ckpt = os.path.join(rundir, "ckpt_epoch_0003.npz")
    meta = ckpt_io.load_checkpoint_meta(ckpt)
    ok = (counts["fused_s1_fwd"] == counts["fused_s1_bwd"] == epoch
          and counts["sample_dense"] == counts["sample_dense_grad"]
          == 2 * epoch and counts["bilinear_tiles_grad"] > 0
          and counts["warp_lookup"] >= 2 * epoch
          and "converting direct atlas to rgb_sh" in text
          and "tile culling: keep" in text and np.isfinite(loss).all()
          and meta["is_sparse"]
          and meta["extra"]["rgb_mlp_type"] == "rgb_sh")
    if not ok:
        raise AssertionError(f"SH train_3d: launches {counts}, loss {loss}, "
                             f"meta {meta}")
    out["train_3d_direct2sh"] = {
        "cli_wall_s": wall, "steps": steps, "launches": counts,
        "warm_step_ms": warm, "loss_first_last": [loss[0], loss[-1]],
        "cull_line": [ln for ln in text.splitlines()
                      if "tile culling" in ln][0]}
    print(json.dumps({"train_3d": "mpi_base --direct2sh_epoch 1",
                      **out["train_3d_direct2sh"]}), flush=True)

    s2_argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
               "--factor", "1", "--datadir", os.path.join(WORK, "s2_scene"),
               "--expdir", os.path.join(WORK, "sh_runs"), "--expname",
               "sh_mtv", "--mpv_frm_num", "50"]
    torch.cuda.reset_peak_memory_stats()
    counts, rows, s2dir, wall, text = run_train(
        s2_argv + ["--init_from", ckpt, "--pyr_init_level", "4",
                   "--pyr_num_epoch", "1", "--i_img", "1",
                   "--i_video", "1000"], train_3dvid)
    loss = [r["value"] for r in rows if r["tag"] == "stage2/loss"]
    n = len(loss)
    warm = {r["tag"].split("/")[1]: r["value"] for r in rows
            if "warm_step_ms" in r["tag"]}
    compaction = [ln for ln in text.splitlines() if "hit-compaction" in ln]
    on = any("no win" not in ln for ln in compaction)
    # the cull after 2 epochs keeps no dynamic tile (the loop mask is not
    # learned yet) and the sweep may not compact: K3/K10 and K13 launch
    # where there is work (phase 41's step has both)
    dyn = ckpt_io.load_checkpoint(ckpt)["params"]["atlas_dyn"].shape[0]
    ok = (n == 39 and "adopting rgb_mlp_type=rgb_sh" in text
          and counts["fused_s2_fwd"] == counts["fused_s2_bwd"] == 0
          and counts["composite"] == 0 and len(compaction) == 2
          and (counts["compact_sweep"] > 0) == on
          and counts["bilinear_tiles_grad"] == n
          and (counts["bilinear_tiles_tilemajor_grad"] > 0) == (dyn > 0)
          and np.isfinite(loss).all())
    if not ok:
        raise AssertionError(f"SH train_3dvid: launches {counts}, loss "
                             f"{loss}, compaction {compaction}")
    out["train_3dvid_rgb_sh"] = {
        "cli_wall_s": wall, "steps": n, "dyn_tiles": int(dyn),
        "launches": counts,
        "compaction_lines": compaction, "warm_step_ms": warm,
        "loss_first_last": [loss[0], loss[-1]],
        "max_memory_allocated_GB": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps({"train_3dvid": "mpv_base from the rgb_sh checkpoint",
                      **out["train_3dvid_rgb_sh"]}), flush=True)

    from videoloop3d_torch import kernels
    kernels.reset_launches()
    t = time.perf_counter()
    frames = np.stack(render_video.main(s2_argv + ["--v", "0",
                                                   "--gpu_num", GPU_NUM]))
    r_wall = time.perf_counter() - t
    r_counts = dict(kernels.LAUNCHES)
    if (frames.shape != (50,) + S1_HW + (3,) or frames.std() < 1.0
            or r_counts["composite"]
            or not r_counts["warp_lookup"] or not r_counts["bilinear_tiles"]
            or (r_counts["bilinear_tiles_tilemajor"] > 0) != (dyn > 0)):
        raise AssertionError(f"SH render: {frames.shape}, {r_counts}")
    out["render_video_rgb_sh"] = {"cli_wall_s": r_wall,
                                  "launches": r_counts,
                                  "frames": len(frames)}
    print(json.dumps({"render_video": "the rgb_sh MTV, fixed view",
                      **out["render_video_rgb_sh"]}), flush=True)
    t = time.perf_counter()
    # the host's float64 PSNR/SSIM group (--skip static) runs in phase 27
    # alone: it reads the frames evaluate rendered, whatever the decoder
    table = evaluate.main(s2_argv + ["--gpu_num", GPU_NUM, "--skip",
                                     "static"])
    e_wall = time.perf_counter() - t
    cols = {k: np.asarray(table[k], np.float64).tolist()
            for k in ("psnr_full", "ssim_full", "dyn", "nnf", "nnb",
                      "loopq", "lpips")}
    # LPIPS is NaN without local weights (phase 27 sets them); the
    # skipped static group's columns are NaN
    if not (os.path.isfile(table["path"])
            and all(np.isfinite(cols[k]).all() for k in cols
                    if k not in ("lpips", "psnr_full", "ssim_full"))
            and np.isnan(cols["psnr_full"]).all()):
        raise AssertionError(f"SH evaluate: {cols}")
    out["evaluate_rgb_sh"] = {"cli_wall_s": e_wall, "columns": cols}
    print(json.dumps({"evaluate": "the rgb_sh MTV",
                      **out["evaluate_rgb_sh"]}), flush=True)
    shutil.rmtree(s2dir, ignore_errors=True)

    out.update(drive_decoder_runs(s1_scene_dir))
    shutil.rmtree(os.path.join(WORK, "sh_runs"), ignore_errors=True)
    return out


def drive_decoder_runs(s1_scene_dir):
    """Phase 40 (e, f): train_3d --rgb_mlp_type rgba_sh from scratch on
    phase 9's scene, two flat epochs and a geometry epoch
    (--optimize_geo_start 2 --N_iters 3: K22 at C = 36, K20 and K21 once
    a geometry step, none in the flat epochs), and one epoch each of
    nex_rgb and mlp_alpha at --atlas_cnl 8, the launch counters set to 0
    just before each and read just after.  Returns {run: summary}."""
    from videoloop3d_torch.models import checkpoint as ckpt_io

    out = {}
    # rgba_sh: two flat epochs, then a geometry epoch (K20-K22 at C = 36)
    for name, extra, n_iters in (
            ("rgba_sh", ["--rgb_mlp_type", "rgba_sh",
                         "--optimize_geo_start", "2"], 3),
            ("nex_rgb", ["--rgb_mlp_type", "nex_rgb", "--atlas_cnl", "8"],
             1),
            ("mlp_alpha", ["--rgb_mlp_type", "mlp_alpha", "--atlas_cnl",
                           "8"], 1)):
        counts, rows, rdir, wall, text = run_train(s1_cli_argv(
            s1_scene_dir, name, extra + ["--N_iters", str(n_iters),
                                         "--i_img", "1"]))
        loss = [r["value"] for r in rows if r["tag"] == "stage1/loss"]
        warm = {r["tag"].split("/")[1]: r["value"] for r in rows
                if "warm_step_ms" in r["tag"]}
        ck = ckpt_io.load_checkpoint(os.path.join(
            rdir, f"ckpt_epoch_{n_iters - 1:04d}.npz"))
        # the geometry epoch's steps (rgba_sh's last of three); none else
        geo = len(loss) // n_iters if name == "rgba_sh" else 0
        geo_ok = (counts["sample_dense_coord_grad"] == counts["geo_warp_fwd"]
                  == counts["geo_warp_bwd"] == geo
                  and (not geo or len(loss) % n_iters == 0
                       and "enabling vertex-geometry optimization" in text))
        if (counts["sample_dense"] != len(loss) or counts["fused_s1_fwd"]
                or not np.isfinite(loss).all() or not geo_ok
                or ck["meta"]["extra"]["rgb_mlp_type"] != name
                or (name != "rgba_sh") != ("decoder" in ck["params"])):
            raise AssertionError(f"{name} train_3d: {counts}, {loss}")
        out[f"train_3d_{name}"] = {
            "cli_wall_s": wall, "steps": len(loss), "geo_steps": geo,
            "channels": int(ck["params"]["atlas"].shape[-1]),
            "launches": {k: v for k, v in counts.items() if v},
            "warm_step_ms": warm, "loss_first_last": [loss[0], loss[-1]]}
        print(json.dumps({"train_3d": name, **out[f"train_3d_{name}"]}),
              flush=True)
        shutil.rmtree(rdir, ignore_errors=True)
    return out


def check_sh_s2_step(args, model, params, batch, n_slots):
    """Phase 40 (g): one stage-2 step of an rgb_sh MTV on the shipped
    flags (the benchmark MTV's tiles widened to 13 channels, random SH
    coefficients between the colours and alpha; --compact_hits at the
    patch's slot bound, --fused_render, --fp16), for both loss configs,
    with the kernels against the same step made of the plain versions, as
    phase 16 holds the direct one: K1, K2/K9, K3/K10 at C = 13, K11, K12
    and K13 launched, K14/K15 never (the gate), metrics within 1e-5
    relative, gradients within one bf16 ulp; then a profile of the ref
    view's step, and that step with K2's first design and with its
    redesign in turns, then with K3's."""
    import dataclasses
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.first_designs import (
        bilinear_tiles_first, bilinear_tiles_tilemajor_first)
    from videoloop3d_torch.render import sample as S
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    sh = {"atlas": widened(params["atlas"].detach(), 13, gen),
          "atlas_dyn": widened(params["atlas_dyn"].detach(), 13, gen)}
    saved = model.cfg
    model.cfg = dataclasses.replace(model.cfg, rgb_mlp_type="rgb_sh")
    s2_route(model, "shipped", n_slots)
    out = {}
    try:
        for ref in (True, False):
            cfg = loss_config_from_args(args, ref=ref)
            kernels.reset_launches()
            m_k, g_k, nn_k = s2_step_grads(args, model, sh, batch, cfg)
            launched = dict(kernels.LAUNCHES)
            m_p, g_p, ties = s2_step_grads(args, model, sh, batch, cfg, nn_k)
            need = S2_KERNELS + ("compact_sweep",)
            if (kernels.LAUNCHES != launched
                    or any(launched[k] == 0 for k in need)
                    or launched["fused_s2_fwd"] or launched["fused_s2_bwd"]):
                raise AssertionError(f"SH step launches: kernel {launched}, "
                                     f"plain {kernels.LAUNCHES}")
            rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12)
                      for k in m_p)
            grel = max(max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
                       for k in g_k)
            if not (rel <= 1e-5 and grel <= 2.0 ** -7):
                raise AssertionError(f"SH stage-2 step differs from its "
                                     f"plain composition: {rel} {grel}")
            out["ref" if ref else "other"] = {
                "launches": {k: v for k, v in launched.items() if v},
                "metrics_max_rel_err": rel, "grads_max_rel_err": grel,
                "near_ties_taken_from_kernel": ties, "loss": m_k["loss"]}
        print(json.dumps({"plain_step_check": f"stage 2, rgb_sh, shipped "
                          f"flags (S={n_slots})", **out}), flush=True)
        print(json.dumps({"profile": f"stage-2 step, rgb_sh, ref view, "
                          f"shipped flags (S={n_slots} of D="
                          f"{model.geom.n_planes})",
                          **profile_s2_step(args, model, sh, batch)}),
              flush=True)
        # the same step with K2's first design and its redesign (C = 13)
        # in turns
        out["k2_in_turns"] = compare_designs(
            lambda: profile_s2_step(args, model, sh, batch), S,
            "bilinear_tiles", bilinear_tiles_first,
            groups=("bilinear_tiles_kernel", "bilinear_tiles_sweep"))
        print(json.dumps({"profile_compare": f"stage-2 step, rgb_sh, ref "
                          f"view, shipped flags (S={n_slots}): K2's first "
                          f"design against its redesign",
                          **out["k2_in_turns"]}), flush=True)
        # and with K3's (C = 13, all 50 frames at the slots)
        out["k3_in_turns"] = compare_designs(
            lambda: profile_s2_step(args, model, sh, batch), S,
            "bilinear_tiles_tilemajor", bilinear_tiles_tilemajor_first,
            groups=("bilinear_tiles_tilemajor_kernel",
                    "bilinear_tiles_tilemajor_sweep"))
        print(json.dumps({"profile_compare": f"stage-2 step, rgb_sh, ref "
                          f"view, shipped flags (S={n_slots}): K3's first "
                          f"design against its redesign",
                          **out["k3_in_turns"]}), flush=True)
    finally:
        model.cfg = saved
    return out


def profile_s1_decoders():
    """Phase 39 (b): a profile of one warm dense stage-1 step of rgb_sh and
    of rgba_sh at the shipped width (device time by group, busy share,
    peak memory)."""
    import torch
    for kind in ("rgb_sh", "rgba_sh"):
        print(json.dumps({"profile": f"stage-1 dense step, {kind}",
                          **profile_s1_step(*s1_decoder_setup(
                              ["--rgb_mlp_type", kind]))}), flush=True)
        torch.cuda.empty_cache()


def mask_inputs(model, params, batch, cfg, factor, seed):
    """The mask branch's inputs on the s2_setup patch under cfg: phase
    32's v = 2 x - 1 (swd_inputs), the loop mask of the patch's target
    video (data/loopmask.py, the trainer's vid2img mask), y's mask order
    with the masked patches repeated `factor` times, the draws for the
    matched rows, and K24's projections of both."""
    import torch
    from videoloop3d_torch.data.loopmask import compute_loopable_mask
    from videoloop3d_torch.losses import swd as SW

    vx, vy, _, rand, _, psz, strides = swd_inputs(model, params, batch, cfg,
                                                  seed)
    mask = compute_loopable_mask(batch["video"].float().cpu().numpy())
    sel = SW.mask_patch_columns(mask, psz[1], psz[0], strides[1],
                                strides[0], n_frames=vy.shape[1])
    order = torch.from_numpy(np.concatenate(
        [np.nonzero(~sel)[0]] + [np.nonzero(sel)[0]] * factor))
    ox = SW.swd_project(vx, rand, psz, strides)
    oy = SW.swd_project(vy, rand, psz, strides)
    n_x, n_y = ox.shape[1] * ox.shape[2], int(order.numel())
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    draws = SW.swd_draws(gen, cfg["num_proj"], 3, psz[0], psz[1],
                         SW.swd_n_short(n_x, n_y))
    return vx, vy, mask, order, ox, oy, draws["perm"], float(sel.mean())


def check_mask_kernels(model, params, batch, args):
    """Phase 41 (a): K27 and K28 at both views' mask shapes (factors 1
    and 3) on phase 32's projections: the loss within 1e-6 of the plain
    version's (a stable torch.sort of the matched rows, |.|, mean), the
    gradient equal to the plain version's (summed in index order; where
    the deficit's copies meet, the plain index_add_'s atomics may round
    one copy's sum otherwise, so there within 1e-6 * max|g|); then a
    static region (the top half's frames equal to its first: exact ties)
    at factor 1, whose gradient equals the plain one's.  K27's keys and
    payload on x's matched rows, and its keys on y's, equal to the values
    (as keys) and indices of a stable torch.sort, and equal to its first
    design's.  Timed (CUDA events) beside its first design, one stable
    torch.sort of x's and
    of y's matched rows (K27's plain version and library call) and the
    pair's yardstick (two of them, |.|, mean).  Bounds: K27 reads a row
    once and writes its sorted keys and payload once (12 B a key; y's rows
    8 B); K28 reads the sorted keys and payload once and writes x's
    gradient once."""
    import torch
    from videoloop3d_torch.first_designs import (sort_keys,
                                                  swd_mask_l1_first,
                                                  swd_mask_sort_first)
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    rec = {}
    for ref in (True, False):
        cfg = loss_config_from_args(args, ref=ref)
        tag = "ref" if ref else "other"
        for factor in (1, 3):
            vx, vy, mask, order, ox, oy, perm, share = mask_inputs(
                model, params, batch, cfg, factor, 11)
            P, L, cfx = ox.shape
            loss, gx = SW.swd_mask_sort_l1(ox, oy, order, perm)
            loss_p, gx_p = SW.swd_mask_sort_l1_plain(ox, oy, order, perm)
            el = abs(float(loss) - float(loss_p))
            same = bool(torch.equal(gx, gx_p))
            eg = max_err(gx, gx_p) / float(gx_p.abs().max())
            del gx_p
            plan = SW.swd_mask_plan(L * cfx, int(order.numel()), order,
                                    perm, L, cfx, oy.shape[2], ox.device)
            n = plan["n"]
            deficit = plan["deficit"]
            if not (el <= 1e-6 and (same or (deficit and eg <= 1e-6))):
                raise AssertionError(f"K27/K28 {tag} x{factor}: loss {el}, "
                                     f"grad equal {same} ({eg})")
            static_same = None
            if factor == 1:
                h = vx.shape[2]
                vs = vx.clone()
                vs[:, :, :h // 2] = vx[:, :1, :h // 2]
                psz = (cfg["patcht_size"], cfg["patch_size"],
                       cfg["patch_size"])
                strides = (cfg["stridet"], cfg["stride"], cfg["stride"])
                rand = SW.normalized_projections(SW.swd_draws(
                    torch.Generator(device=DEVICE).manual_seed(11),
                    cfg["num_proj"], 3, *psz[:2], 0)["rand"])
                os_ = SW.swd_project(vs, rand, psz, strides)
                _, gs = SW.swd_mask_sort_l1(os_, oy, order, perm)
                _, gs_p = SW.swd_mask_sort_l1_plain(os_, oy, order, perm)
                static_same = bool(torch.equal(gs, gs_p))
                if not static_same:
                    raise AssertionError(f"K27/K28 {tag}: exact ties broken "
                                         "otherwise than the stable sort")
                # K28's redesign on the ties against its first design
                skx, six = SW.swd_mask_sort(os_, plan["gather_x"], True)
                sky, _ = SW.swd_mask_sort(oy, plan["gather_y"], False)
                static_l1 = l1_designs(skx, six, sky, plan, L, cfx,
                                       f"{tag} static")
                del vs, os_, gs, gs_p, skx, six, sky
            kx, ix = SW.swd_mask_sort(ox, plan["gather_x"], True)
            ky, _ = SW.swd_mask_sort(oy, plan["gather_y"], False)
            ax = ox.reshape(P, -1)[:, plan["gather_x"].long()].contiguous()
            ay = oy.reshape(P, -1)[:, plan["gather_y"].long()].contiguous()
            sx, sxi = torch.sort(ax, dim=1, stable=True)
            sorted_equal = bool(torch.equal(kx, sort_keys(sx))
                                and torch.equal(ix, sxi.to(torch.int32))
                                and torch.equal(ky, sort_keys(torch.sort(
                                    ay, dim=1, stable=True)[0])))
            del sx, sxi
            k2, i2 = swd_mask_sort_first(ox, plan["gather_x"], True)
            k3, _ = swd_mask_sort_first(oy, plan["gather_y"], False)
            first_equal = bool(torch.equal(k2, kx) and torch.equal(i2, ix)
                               and torch.equal(k3, ky))
            del k2, i2, k3
            if not (sorted_equal and first_equal):
                raise AssertionError(f"K27 {tag} x{factor}: equal to a stable "
                                     f"torch.sort {sorted_equal}, to its "
                                     f"first design {first_equal}")

            def lib():
                return (torch.sort(ax, dim=1, stable=True)[0]
                        - torch.sort(ay, dim=1, stable=True)[0]).abs().mean()

            keys = P * n
            # K27's plain version and library call are one stable
            # torch.sort of x's matched rows (values and indices); the
            # pair's yardstick: two of them, |.| and the mean
            sort_ms = cuda_ms(lambda: torch.sort(ax, dim=1, stable=True), 3)
            pair_ms = cuda_ms(lib, 3)
            r27 = dict(
                view=tag, factor=factor, rows=P, row_length=n,
                n_x=L * cfx, n_y=int(order.numel()), mask_share=share,
                max_abs_err=0.0, equal_stable_torch_sort=sorted_equal,
                equal_first_design=first_equal,
                ms=cuda_ms(lambda: SW.swd_mask_sort(ox, plan["gather_x"],
                                                    True), 3),
                y_ms=cuda_ms(lambda: SW.swd_mask_sort(oy, plan["gather_y"],
                                                      False), 3),
                first_design_ms=cuda_ms(lambda: swd_mask_sort_first(
                    ox, plan["gather_x"], True), 3),
                first_design_y_ms=cuda_ms(lambda: swd_mask_sort_first(
                    oy, plan["gather_y"], False), 3),
                plain_ms=sort_ms, library_ms=sort_ms,
                y_library_ms=cuda_ms(lambda: torch.sort(ay, dim=1,
                                                        stable=True), 3),
                pair_yardstick_ms=pair_ms,
                bound=bound_ms(keys * 12, 0),
                y_bound_ms=bound_ms(keys * 8, 0)[0])
            # K28's plain version: the whole plain branch (sorts included);
            # no one library call takes the L1's gradient through a sort.
            # The redesign against its first design, both timed in turns
            l1 = l1_designs(kx, ix, ky, plan, L, cfx, f"{tag} x{factor}")
            r28 = dict(
                view=tag, factor=factor, max_abs_err=el, loss=float(loss),
                grad_equal_plain=same, grad_max_rel_err=eg,
                static_grad_equal_plain=static_same,
                **l1, static_first_design=static_l1 if factor == 1 else None,
                plain_ms=cuda_ms(lambda: SW.swd_mask_sort_l1_plain(
                    ox, oy, order, perm), 2),
                library_ms=None, pair_yardstick_ms=pair_ms,
                bound=bound_ms(keys * 12 + L * cfx * P * 4, keys * 3))
            rec[f"swd_mask_sort/{tag}/x{factor}"] = r27
            rec[f"swd_mask_l1/{tag}/x{factor}"] = r28
            for name, r in (("swd_mask_sort", r27), ("swd_mask_l1", r28)):
                r = dict(r)
                b, by = r.pop("bound")
                print(json.dumps({"kernel_check": f"{name}/{tag} view, "
                                  f"factor {factor}", **r, "bound_ms": b,
                                  "bound_by": by}), flush=True)
            del vx, vy, ox, oy, kx, ix, ky, ax, ay, gx
            torch.cuda.empty_cache()
    rec.update(check_mask_l1_long_rows())
    return rec


def l1_designs(kx, ix, ky, plan, L, cfx, tag, iters=5):
    """K28 (redesigned) against its first design on K27's sorted rows: the
    gradient bit for bit, the loss as f32 equal or within 1 ulp (the two
    sum their doubles in different fixed orders), the redesign the same
    bits twice, its layout against the kernel's; both timed in turns.
    Returns {ms, first_design_ms, ms_in_turns, route, layout, ...}."""
    import torch
    from videoloop3d_torch.first_designs import swd_mask_l1_first
    from videoloop3d_torch.losses import swd as SW

    P, n = kx.shape
    lay = SW.swd_mask_l1_layout(P, n)
    if SW.kernel_swd_mask_l1_layout(P, n) != lay:
        raise AssertionError(f"K28's layout {lay} against the kernel's "
                             f"{SW.kernel_swd_mask_l1_layout(P, n)}")
    loss, gx = SW.swd_mask_l1(kx, ix, ky, plan, L, cfx)
    loss2, gx2 = SW.swd_mask_l1(kx, ix, ky, plan, L, cfx)
    loss_f, gx_f = swd_mask_l1_first(kx, ix, ky, plan, L, cfx)
    bits = [t.view(torch.int32) for t in (gx, gx2, gx_f)]
    same = bool(torch.equal(bits[0], bits[2]))
    twice = bool(torch.equal(bits[0], bits[1])
                 and torch.equal(loss.view(torch.int32),
                                 loss2.view(torch.int32)))
    ulps = abs(int(loss.view(torch.int32)) - int(loss_f.view(torch.int32)))
    if not (same and twice and ulps <= 1):
        raise AssertionError(f"K28 {tag}: gradient equal to its first "
                             f"design {same}, the same bits twice {twice}, "
                             f"loss {ulps} ulps apart")
    MASK_L1_ROUTE_COUNTS[lay["route"]] += 1
    ms, first_ms, turns = ms_in_turns(
        lambda: SW.swd_mask_l1(kx, ix, ky, plan, L, cfx),
        lambda: swd_mask_l1_first(kx, ix, ky, plan, L, cfx), iters)
    return dict(ms=ms, first_design="csrc/swd_mask.cu:vl3d_swd_mask_l1_first",
                first_design_ms=first_ms, ms_in_turns=turns,
                equal_first_design=same, same_bits_twice=twice,
                loss_ulps_from_first_design=ulps, route=lay["route"],
                layout=lay)


def check_mask_l1_long_rows():
    """Phase 41 (a'): K28 on rows too long for one block's shared memory,
    P rows of x and y (projections of random values, y in a shuffled
    order) matched with a deficit, sorted by K27: 66 rows of 2.2 M keys
    (4 blocks a row) and 2 rows of 16.2 M (132 blocks a row), the bits in
    device memory (the global route); each against its first design
    (l1_designs) and against the plain branch, timed in turns, with the
    bound of the rows read once and gx written once."""
    import torch
    from videoloop3d_torch.losses import swd as SW

    rec = {}
    for name, P, L, cfx, cfy in (("66x2.2M", 66, 40_000, 40, 55),
                                  ("2x16.2M", 2, 300_000, 40, 54)):
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        ox = torch.randn((P, L, cfx), generator=gen, device=DEVICE)
        oy = torch.randn((P, L, cfy), generator=gen, device=DEVICE)
        n_x, n_y = L * cfx, L * cfy
        order = torch.randperm(n_y, generator=gen, device=DEVICE).cpu()
        perm = torch.randperm(SW.swd_n_short(n_x, n_y), generator=gen,
                              device=DEVICE)
        plan = SW.swd_mask_plan(n_x, n_y, order, perm, L, cfx, cfy, DEVICE)
        kx, ix = SW.swd_mask_sort(ox, plan["gather_x"], True)
        ky, _ = SW.swd_mask_sort(oy, plan["gather_y"], False)
        r = l1_designs(kx, ix, ky, plan, L, cfx, f"long rows ({name})", 3)
        if r["route"] != "global":
            raise AssertionError(f"K28 long rows: route {r['route']}, "
                                 "expected global")
        loss_p, gx_p = SW.swd_mask_sort_l1_plain(ox, oy, order, perm)
        loss, gx = SW.swd_mask_l1(kx, ix, ky, plan, L, cfx)
        el = abs(float(loss) - float(loss_p))
        same = bool(torch.equal(gx, gx_p))
        # where three or more copies meet, the plain index_add_'s atomics
        # may round a sum otherwise (see check_mask_kernels)
        eg = max_err(gx, gx_p) / float(gx_p.abs().max())
        if not (el <= 1e-6 and (same or eg <= 1e-6)):
            raise AssertionError(f"K28 long rows ({name}): loss {el}, grad "
                                 f"equal to the plain branch {same} ({eg})")
        keys = P * plan["n"]
        rec[f"swd_mask_l1/long/{name}"] = r | dict(
            rows=P, row_length=plan["n"], n_x=n_x, n_y=n_y,
            deficit=plan["deficit"], max_abs_err=el, grad_equal_plain=same,
            grad_max_rel_err=eg,
            bound_ms=bound_ms(keys * 12 + n_x * P * 4, keys * 3)[0])
        print(json.dumps({"kernel_check": f"swd_mask_l1/long rows, {name}",
                          **rec[f"swd_mask_l1/long/{name}"]}),
              flush=True)
        del ox, oy, kx, ix, ky, gx, gx_p, plan, perm
        torch.cuda.empty_cache()
    return rec


def check_mask_step(args, model, params, batch):
    """Phase 41 (b): one shipped-route stage-2 step of the swd loss with
    the mask branch (the ref view's config, the patch video's loop mask,
    factor 3; the same draws), with the kernels against the same step made
    of the plain versions: metrics within 1e-5 relative, the loss input's
    gradient within 1e-5 * max|g|, the bf16 atlas gradients within one
    bf16 ulp.  The kernel step is the mask branch's main path: its launch
    counters are set to 0 just before and read just after; it launches
    K24 twice, K27 twice, K28 and K26 once, and K25 never.  Then the
    masked step's profile with K27's first design in its place and with
    the redesign, in turns (compare_designs: step ms, device ms, busy
    share, K27's kernels' device ms and share), and likewise with K28's
    first design.  Returns (launches, summary, the two comparisons)."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.data.loopmask import compute_loopable_mask
    from videoloop3d_torch.first_designs import (swd_mask_l1_first,
                                                  swd_mask_sort_first)
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.train.stage2 import loss_config_from_args

    cfg = dict(loss_config_from_args(args, ref=True), loss_name="swd")
    pt, p = cfg["patcht_size"], cfg["patch_size"]
    F = batch["video"].shape[0]
    mask = compute_loopable_mask(batch["video"].float().cpu().numpy())
    sel = SW.mask_patch_columns(mask, p, pt, cfg["stride"], cfg["stridet"],
                                n_frames=F)
    h = (S2_PATCH[0] - p) // cfg["stride"] + 1
    w = (S2_PATCH[1] - p) // cfg["stride"] + 1
    n_x = (F + pt - 1 - pt + 1) * h * w
    n_y = int((~sel).sum() + 3 * sel.sum())
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    draws = SW.swd_draws(gen, cfg["num_proj"], 3, pt, p,
                         SW.swd_n_short(n_x, n_y))
    b = dict(batch, draws={"swd": draws})
    loss_fn = SW.swd_3d_loss

    def masked(x, y, **kw):
        return loss_fn(x, y, mask=mask, mask_patches_factor=3, **kw)

    saved_mask = SW.swd_mask_sort_l1
    SW.swd_3d_loss = masked
    try:
        kernels.reset_launches()
        m_k, g_k, _ = s2_step_grads(args, model, params, b, cfg,
                                    swd_plain=False)
        launched = dict(kernels.LAUNCHES)
        SW.swd_mask_sort_l1 = SW.swd_mask_sort_l1_plain
        m_p, g_p, _ = s2_step_grads(args, model, params, b, cfg,
                                    swd_plain=True)
    finally:
        SW.swd_3d_loss = loss_fn
        SW.swd_mask_sort_l1 = saved_mask
    want = {"swd_project": 2, "swd_mask_sort": 2, "swd_mask_l1": 1,
            "swd_project_grad": 1, "swd_sort_l1": 0}
    if (any(launched[k] != v for k, v in want.items())
            or kernels.LAUNCHES["swd_mask_sort"] != 2):
        raise AssertionError(f"mask step launches {launched}")
    rel = max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p)
    grel = {k: max_err(g_k[k], g_p[k]) / float(g_p[k].abs().max())
            for k in g_k}
    if not (rel <= 1e-5 and grel["swd_input"] <= 1e-5
            and max(grel.values()) <= 2.0 ** -7):
        raise AssertionError(f"swd mask step differs from its plain "
                             f"composition: {rel} {grel}")
    SW.swd_3d_loss = masked
    try:
        compare = compare_designs(
            lambda: profile_s2_step(args, model, params, b, cfg=cfg), SW,
            "swd_mask_sort", swd_mask_sort_first, groups=MASK_SORT_KERNELS)
        compare28 = compare_designs(
            lambda: profile_s2_step(args, model, params, b, cfg=cfg), SW,
            "swd_mask_l1", swd_mask_l1_first, groups=MASK_L1_KERNELS)
    finally:
        SW.swd_3d_loss = loss_fn
    return launched, {"metrics_max_rel_err": rel, "grads_max_rel_err": grel,
                      "loss": m_k["loss"], "swd": m_k["swd"],
                      "mask_share": float(sel.mean()), "n_x": n_x,
                      "n_y": n_y}, compare, compare28


def decoder_phases(s1_scene_dir):
    """Phases 37-41.  Returns (records, launches of the mask step, the
    summaries of the SH path)."""
    import torch
    from videoloop3d_torch.render import compact as CP

    rec = check_dense_channels()
    torch.cuda.empty_cache()
    rec.update(check_tiles_channels())
    torch.cuda.empty_cache()
    rec["decoder_steps"] = check_decoder_steps()
    profile_s1_decoders()
    torch.cuda.empty_cache()
    rec["sh_path"] = drive_sh_path(s1_scene_dir)
    torch.cuda.empty_cache()
    args, model, params, batch = s2_setup()
    g = model.geom
    n_slots = CP.slot_bound(g, model.tile_map_static, model.tile_map_dyn,
                            batch["extrin"].cpu().numpy(),
                            batch["intrin"].cpu().numpy(), *S2_PATCH)
    rec["sh_s2_step"] = check_sh_s2_step(args, model, params, batch, n_slots)
    torch.cuda.empty_cache()
    rec.update(check_mask_kernels(model, params, batch, args))
    torch.cuda.empty_cache()
    s2_route(model, "shipped", n_slots)
    counts, summary, compare, compare28 = check_mask_step(args, model,
                                                          params, batch)
    print(json.dumps({"plain_step_check": "stage 2, shipped route, swd with "
                      "a mask (ref view, factor 3)", **summary}), flush=True)
    print(json.dumps({"profile_compare": "stage-2 step, shipped route, swd "
                      "with a mask (ref view, factor 3): K27's first design "
                      "against its redesign", **compare}), flush=True)
    print(json.dumps({"profile_compare": "stage-2 step, shipped route, swd "
                      "with a mask (ref view, factor 3): K28's first design "
                      "against its redesign", **compare28}), flush=True)
    rec["mask_step_k28_in_turns"] = compare28
    del model, params, batch
    torch.cuda.empty_cache()
    return rec, counts



# ---------------------------------------------------------------------------
# phases 42-46: the multi-process layer (parallel/), two ranks on one card
# ---------------------------------------------------------------------------

# K11's and K12's modes of the frame-parallel gpnn loss (phase 45)
PAR_KERNELS = ("nn_argmin_colmin", "nn_argmin_given", "nn_fold_numer")
# the bound phases 42 and 44 hold a step's gradients to (PERF.md §2): f32
# gradients 1e-5 * max|g|; the atlases' under --fp16 (sums rounded to
# bf16; K9's atomics add in no fixed order) 2^-7 * max|g|
GRAD_TOL, BF16_GRAD_TOL = 1e-5, 2.0 ** -7


def grad_errs(got, want, bf16_keys=()):
    """{param: max|got - want| / max|want|} and whether each is within
    its bound (GRAD_TOL, or BF16_GRAD_TOL for bf16_keys)."""
    out, ok = {}, True
    for k, w in want.items():
        scale = float(w.abs().max()) if w.numel() else 0.0
        e = max_err(got[k], w) / max(scale, 1e-30) if scale else \
            max_err(got[k], w)
        out[k] = e
        ok = ok and e <= (BF16_GRAD_TOL if k in bf16_keys else GRAD_TOL)
    return out, ok


def step_grads(make, params, batch, weights, keys):
    """The gradients of one step (SGD at lr 0: params unchanged) of the
    single-process step factory make() = (step, opt_init)."""
    step, opt_init = make()
    p = {k: v.detach().clone() for k, v in params.items()}
    step(p, opt_init(p), batch, 0.0, weights, None)
    return {k: p[k].grad.detach().clone() for k in keys}


def dp_check(rank, grid, make_dp, make_single, params, rows, weights, keys,
             bf16_keys, lr):
    """Phases 42 and 44: one dp step (rank r takes rows[r]) against the
    mean of one process's two single-patch gradients (rank 0 computes
    both), then a dp step whose rank-1 row has weight 0 against rank 0's
    single-patch gradient; the reduced gradient is p.grad after the SGD
    step.  Then 3 more steps timed: step ms (CUDA events) and the
    collective's ms on each rank.  Returns the record."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.parallel.distributed import commit_batch

    single = None
    if rank == 0:
        single = [step_grads(make_single, params, b, weights, keys)
                  for b in rows]
    rec = {}
    for tag, wt in (("mean", None), ("weight_0_row", [1.0, 0.0])):
        step, opt_init = make_dp()
        p = {k: v.detach().clone() for k, v in params.items()}
        opt = opt_init(p)
        mine = dict(commit_batch(grid, rows)[0])
        if wt is not None:
            mine["wt"] = wt[rank]
        kernels.reset_launches()
        m = step(p, opt, mine, lr, weights, None)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        g = {k: p[k].grad for k in keys}
        if rank == 0:
            want = {k: (single[0][k] + single[1][k]) / 2 for k in keys} \
                if wt is None else single[0]
            errs, ok = grad_errs(g, want, bf16_keys)
            if not ok:
                raise AssertionError(f"dp step ({tag}) gradient differs: "
                                     f"{errs}")
            rec[tag] = {"grad_max_rel_err": errs, "loss": float(m["loss"]),
                        "launches": launches}
        del p, opt, g
    # timing: 3 warm steps, the collective's host time on this rank
    step, opt_init = make_dp()
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = opt_init(p)
    mine = dict(commit_batch(grid, rows)[0])
    step(p, opt, mine, lr, weights, None)
    torch.cuda.synchronize()
    grid.dp.timing, grid.dp.ms = True, 0.0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(3):
        step(p, opt, mine, lr, weights, None)
    ev[1].record()
    ev[1].synchronize()
    grid.dp.timing = False
    rec["rank_step_ms"] = ev[0].elapsed_time(ev[1]) / 3
    rec["rank_collective_ms"] = grid.dp.ms / 3
    rec["buffer_floats"] = sum(v.numel() for v in p.values()
                               if v.grad is not None)
    return rec


def s2_second_patch(model, params, batch):
    """The dp phases' second stage-2 patch: the top-left 180x320 crop of
    the view 0.05 to the other side of the reference camera, with its
    target video (`s2_video`)."""
    H, W = model.H, model.W
    ph, pw = S2_PATCH
    b = {"extrin": batch["extrin"].clone(), "intrin": batch["intrin"].clone()}
    b["extrin"][:, 0, 3] = -0.05
    b["intrin"][:, 0, 2] += (W - pw) / 2
    b["intrin"][:, 1, 2] += (H - ph) / 2
    b["video"] = s2_video(model, params, b)
    return b


def check_fp_nn_modes(x, y, plan, alpha):
    """Phase 45: K11's minima and given-minima modes and K12's numerator
    mode on one rank's search inputs of the fp step (the ref view: its
    Fl + pt - 1 frames), against their plain versions and K11/K12: the
    given mode with the rank's own minima is K11 bit for bit, its other
    differences from the plain version near ties (`nn_flips`); the minima
    within 1e-5 of the term scale of the plain version's; the numerator
    divided by the plan's weight K12 bit for bit, and within 1e-5 of the
    plain numerator (relative).  Timed (CUDA events) with bounds and
    library times."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN

    cm = PN.nn_argmin_colmin(x, y, plan)
    cm_p = PN.nn_colmin_plain(x, y, plan)
    term = float((x.float() ** 2).amax() + (y.float() ** 2).amax())
    e_cm = max_err(cm, cm_p)
    if not e_cm <= 1e-5 * term:
        raise AssertionError(f"nn_argmin_colmin off its plain version: "
                             f"{e_cm} (term scale {term})")
    nn_g = PN.nn_argmin_given(x, y, plan, alpha, cm)
    nn_k = PN.nn_argmin(x, y, plan, alpha)
    if not torch.equal(nn_g, nn_k):
        raise AssertionError("nn_argmin_given with its own minima differs "
                             f"from nn_argmin at {int((nn_g != nn_k).sum())}"
                             " queries")
    _, flips, gap_abs, _, gap_scale = nn_flips(x, y, plan, alpha, nn_g)
    num = PN.nn_fold(y, nn_k, plan, numer=True)
    out = PN.nn_fold(y, nn_k, plan)
    w = torch.from_numpy(plan.weight).to(num.device)[None]
    if not torch.equal((num / w).view(torch.int32), out.view(torch.int32)):
        raise AssertionError("nn_fold_numer / weight differs from nn_fold")
    num_p = PN.nn_fold_plain(y, nn_k, plan, numer=True)
    e_num = max_err(num, num_p) / max(float(num_p.abs().max()), 1e-30)
    if not e_num <= 1e-5:
        raise AssertionError(f"nn_fold_numer off its plain version: {e_num}")
    ntx, nty, nh, nw = plan.grid
    C = x.shape[0]
    d = C * int(np.prod(plan.psz))
    cols = len(plan.hs) * len(plan.ws) * nh * nw
    item = x.element_size()
    bf16 = x.dtype == torch.bfloat16
    rate = BF16_OPS_PER_S if bf16 else F32_OPS_PER_S
    ft, fh, fw = plan.fit
    Xf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(ntx, nh * nw, d).transpose(0, 1)
                    for c in PN._crops(x[:, :ft, :fh, :fw], plan)])
    Yf = torch.cat([PN.extract_patches_3d(c, plan.psz, plan.strides)
                    .reshape(nty, nh * nw, d).transpose(0, 1)
                    for c in PN._crops(y[:, :plan.fit_ty, :fh, :fw], plan)])
    Xf, Yf = Xf.contiguous(), Yf.contiguous()
    xx = (Xf.float() ** 2).sum(-1)[..., :, None]
    yy = (Yf.float() ** 2).sum(-1)[..., None, :]
    YfT = Yf.transpose(1, 2)
    gemm = {"out_dtype": torch.float32} if bf16 else {}
    cm_flat = cm.reshape(-1, 1, nty)

    def dist():
        return torch.baddbmm(xx + yy, Xf, YfT, alpha=-2.0, **gemm) / d

    def lib_colmin():
        return torch.amin(dist(), dim=1)

    def lib_given():
        return torch.argmin(dist() / (alpha + cm_flat), dim=2)

    lib_fold = fold_library(y, nn_k, plan)
    n_in = (x.numel() + y.numel()) * item
    ops = cols * nn_search_ops(plan, C, 2)
    covers = float(plan.weight[plan.weight >= 1].sum())
    return {
        "nn_argmin_colmin": dict(
            max_abs_err=e_cm, term_scale=term,
            ms=cuda_ms(lambda: PN.nn_argmin_colmin(x, y, plan), 10),
            plain_ms=cuda_ms(lambda: PN.nn_colmin_plain(x, y, plan), 2),
            library_ms=cuda_ms(lib_colmin, 5),
            bound=bound_ms(n_in + cm.numel() * 4,
                           ops + cols * ntx * nty, rate)),
        "nn_argmin_given": dict(
            max_abs_err=gap_abs, equal_nn_argmin=True,
            index_flips_vs_plain=int(flips.sum()), queries=nn_g.numel(),
            flip_gap_rel_term_scale=gap_scale,
            ms=cuda_ms(lambda: PN.nn_argmin_given(x, y, plan, alpha, cm), 10),
            nn_argmin_ms=cuda_ms(lambda: PN.nn_argmin(x, y, plan, alpha), 10),
            plain_ms=cuda_ms(lambda: PN.nn_argmin_plain(
                x, y, plan, alpha, colmin=cm), 2),
            library_ms=cuda_ms(lib_given, 5),
            bound=bound_ms(n_in + cm.numel() * 4 + nn_g.numel() * 4,
                           ops + 3 * cols * ntx * nty, rate)),
        "nn_fold_numer": dict(
            max_abs_err=max_err(num, num_p), max_rel_err=e_num,
            divided_equals_nn_fold=True,
            ms=cuda_ms(lambda: PN.nn_fold(y, nn_k, plan, numer=True), 20),
            nn_fold_ms=cuda_ms(lambda: PN.nn_fold(y, nn_k, plan), 20),
            plain_ms=cuda_ms(lambda: PN.nn_fold_plain(
                y, nn_k, plan, numer=True), 2),
            library_ms=cuda_ms(lib_fold, 10),
            bound=bound_ms(y[:, :plan.fit_ty].numel() * item
                           + nn_k.numel() * 4 + num.numel() * 4,
                           C * covers))}


def fp_rule(got, want, p0):
    """tests/test_fp_sharding.py:163-183's rule for an fp update: the
    residual under 0.25 of the update, the median gradient ratio within
    1e-3 of 1.  Returns (residual / update, median ratio)."""
    import torch
    upd = float((want - p0).abs().max())
    res = float((got - want).abs().max())
    if not res < max(0.25 * upd, 1e-7):
        raise AssertionError(f"fp update residual {res} of update {upd}")
    if upd == 0.0:
        return res, None
    g_got, g_want = (p0 - got).flatten(), (p0 - want).flatten()
    big = g_want.abs() > g_want.abs().max() * 1e-3
    med = float(torch.median(g_got[big] / g_want[big]))
    if not abs(med - 1.0) < 1e-3:
        raise AssertionError(f"fp gradient scale {med}")
    return res / upd, med


def fp_check(rank, grid, args, model, params, batch, cfg, weights, lr):
    """Phase 43: one fp step (rank r its 25 of the 50 frames) against the
    single-process step of rank 0 on the same patch and draws: the loss
    within 2e-4 relative, every update by `fp_rule`.  The launch counters
    are set to 0 just before the fp step and read just after.  Then 3
    more steps timed (CUDA events) with the fp collectives' host ms."""
    import torch
    from videoloop3d_torch import kernels
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.parallel.fp_step import make_fp_stage2_step
    from videoloop3d_torch.train.stage2 import make_stage2_step

    single = None
    if rank == 0:
        step, opt_init = make_stage2_step(model, args, *S2_PATCH, cfg)
        p = {k: v.detach().clone() for k, v in params.items()}
        m = step(p, opt_init(p), batch, lr, weights, None)
        single = ({k: v.detach() for k, v in p.items()}, float(m["loss"]))
        del p
    step, opt_init = make_fp_stage2_step(model, args, *S2_PATCH, cfg, grid)
    p = dist.shard_params_by_frames(
        {k: v.detach().clone() for k, v in params.items()}, grid)
    opt = opt_init(p)
    torch.cuda.synchronize()
    kernels.reset_launches()
    m = step(p, opt, batch, lr, weights, None)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    full = dist.gather_params_by_frames(p, grid)
    rec = {"launches": {k: v for k, v in launches.items() if v},
           "frames_a_rank": p["atlas_dyn"].shape[3]}
    if rank == 0:
        want, loss = single
        rel = abs(float(m["loss"]) - loss) / abs(loss)
        if not rel <= 2e-4:
            raise AssertionError(f"fp loss {float(m['loss'])} against "
                                 f"{loss}")
        rec["loss"], rec["single_loss"], rec["loss_rel_err"] = \
            float(m["loss"]), loss, rel
        rec["rule"] = {k: fp_rule(full[k], want[k], params[k])
                       for k in ("atlas", "atlas_dyn")}
    del full
    grid.fp.timing, grid.fp.ms = True, 0.0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(3):
        step(p, opt, batch, lr, weights, None)
    ev[1].record()
    ev[1].synchronize()
    grid.fp.timing = False
    rec["rank_step_ms"] = ev[0].elapsed_time(ev[1]) / 3
    rec["rank_collective_ms"] = grid.fp.ms / 3
    return rec, launches


def par_worker(rank, init, out_path):
    """One rank of phases 42-45 (``chip_smoke.py --par-worker``): the dp
    stage-2 step, the fp stage-2 steps, the dp stage-1 step, and on rank
    0 the modes' kernel checks; writes its record as JSON to out_path."""
    import torch
    from videoloop3d_torch.losses import patch_nn as PN
    from videoloop3d_torch.losses import swd as SW
    from videoloop3d_torch.parallel import distributed as dist
    from videoloop3d_torch.parallel.dp_step import (make_dp_stage1_step,
                                                    make_dp_stage2_step)
    from videoloop3d_torch.render import compact as CP
    from videoloop3d_torch.train import common
    from videoloop3d_torch.train import stage1 as TS1
    from videoloop3d_torch.train import stage2 as TS2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_distributed(torch.device(DEVICE), init, 2, rank)
    rec = {"backend": torch.distributed.get_backend()}
    lr = 0.1

    # phase 42: dp = 2, the shipped stage-2 step (SGD), a patch a rank
    args, model, params, batch0 = s2_setup()
    args.optimizer = "sgd"
    batch1 = s2_second_patch(model, params, batch0)
    g = model.geom
    n_slots = max(CP.slot_bound(g, model.tile_map_static, model.tile_map_dyn,
                                b["extrin"].cpu().numpy(),
                                b["intrin"].cpu().numpy(), *S2_PATCH)
                  for b in (batch0, batch1))
    s2_route(model, "shipped", n_slots)
    rec["slots"] = [n_slots, g.n_planes]
    cfg = TS2.loss_config_from_args(args, ref=True)
    weights = common.extra_loss_weights(args, TS2.STAGE2_WEIGHT_KEYS)
    grid = dist.make_mesh(n_dp=2, n_fp=1)
    rec["dp_stage2"] = dp_check(
        rank, grid, lambda: make_dp_stage2_step(model, args, *S2_PATCH, cfg,
                                                grid),
        lambda: TS2.make_stage2_step(model, args, *S2_PATCH, cfg), params,
        [batch0, batch1], weights, ("atlas", "atlas_dyn"),
        ("atlas", "atlas_dyn"), lr)
    del batch1
    torch.cuda.empty_cache()

    # phase 43: fp = 2 at F = 50, the ref view's gpnn_lm, then swd
    grid = dist.make_mesh(n_dp=1, n_fp=2)
    swd_cfg = dict(cfg, loss_name="swd")
    pt, p = swd_cfg["patcht_size"], swd_cfg["patch_size"]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    draws = SW.swd_draws(gen, swd_cfg["num_proj"], 3, pt, p,
                         SW.swd_n_short(model.frm_num,
                                        model.frm_num - pt + 1))
    rec["fp"], launches = {}, {}
    for tag, c, b in (("gpnn_lm_ref", cfg, batch0),
                      ("swd", swd_cfg, dict(batch0, draws={"swd": draws}))):
        rec["fp"][tag], launches[tag] = fp_check(
            rank, grid, args, model, params, b, c, weights, lr)
    need = {"gpnn_lm_ref": PAR_KERNELS + ("fused_s2_fwd", "fused_s2_bwd",
                                          "compact_sweep"),
            "swd": ("swd_project", "swd_sort_l1", "swd_project_grad")}
    for tag, names in need.items():
        idle = [k for k in names if launches[tag][k] == 0]
        if idle or launches[tag]["nn_argmin"] or (
                tag == "gpnn_lm_ref" and launches[tag]["nn_fold"]):
            raise AssertionError(f"fp {tag} step launches {launches[tag]}")
    rec["fp_launches"] = launches["gpnn_lm_ref"]

    # phase 45 (rank 0): the modes at this rank's search shapes
    if rank == 0:
        with torch.no_grad():
            rgb, _ = model.render(params, *S2_PATCH, batch0["extrin"],
                                  batch0["intrin"], None, training=True)
        fh = PN.fit_patch_size(S2_PATCH[0], cfg["patch_size"], cfg["stride"])
        fw = PN.fit_patch_size(S2_PATCH[1], cfg["patch_size"], cfg["stride"])
        fl = model.frm_num // 2
        x = rgb.permute(3, 0, 1, 2)[:, :fl + pt - 1, :fh, :fw]
        y = batch0["video"].permute(3, 0, 1, 2)[:, :, :fh, :fw]
        xq, yq = PN._nn_cast(x.contiguous(), y.contiguous(), cfg["nn_bf16"])
        plan = PN.lowmem_plan(fl + pt - 1, y.shape[1], fh, fw,
                              (pt, cfg["patch_size"], cfg["patch_size"]),
                              (1, cfg["stride"], cfg["stride"]),
                              cfg["macro_block"])
        rec["modes"] = check_fp_nn_modes(
            xq.contiguous(), yq.contiguous(), plan,
            PN._norm_alpha(cfg["alpha"]))
    del model, params, batch0
    torch.cuda.empty_cache()

    # phase 44: dp = 2, the shipped stage-1 step (mpi_base, SGD)
    args, model, params, b0 = s1_setup("shipped")
    args.optimizer = "sgd"
    H, W = S1_HW
    ph, pw = S1_PATCH
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    b1 = {"extrin": b0["extrin"].clone(), "intrin": b0["intrin"].clone(),
          "rgb": torch.rand((1, ph, pw, 3), generator=gen, device=DEVICE),
          "loopmask": (torch.rand((1, ph, pw), generator=gen,
                                  device=DEVICE) < 0.3).float()}
    b1["extrin"][:, 0, 3] = -0.05
    b1["intrin"][:, 0, 2] += (W - pw) / 2
    b1["intrin"][:, 1, 2] += (H - ph) / 2
    weights = common.extra_loss_weights(args, TS1.STAGE1_WEIGHT_KEYS)
    grid = dist.make_mesh(n_dp=2, n_fp=1)

    def make_single():
        return TS1.make_train_step(model, args, *S1_PATCH)[:2]

    def make_dp():
        return make_dp_stage1_step(model, args, *S1_PATCH, grid)[:2]

    rec["dp_stage1"] = dp_check(rank, grid, make_dp, make_single, params,
                                [b0, b1], weights, ("atlas", "atlas_mask"),
                                (), lr)
    with open(out_path, "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def run_ranks(argv_of, n=2, timeout=600):
    """Start n processes (rank i with argv_of(i, init), a file:// store
    under WORK) and wait for all; a failing rank fails the run.  Returns
    their outputs and the wall seconds."""
    init_dir = os.path.join(WORK, f"pg_{time.time_ns()}")
    os.makedirs(init_dir)
    init = "file://" + os.path.join(init_dir, "store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    import threading
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv_of(i, init), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n)]
    outs = [[] for _ in procs]
    readers = [threading.Thread(target=lambda p=p, o=o: o.extend(p.stdout),
                                daemon=True) for p, o in zip(procs, outs)]
    for t in readers:
        t.start()
    try:
        # a rank that fails stops the others (they would wait in a
        # collective)
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.perf_counter() - t0 > timeout:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join(timeout=30)
    outs = ["".join(o) for o in outs]
    wall = time.perf_counter() - t0
    for i, (p, out) in enumerate(zip(procs, outs)):
        print(f"--- rank {i} (exit {p.returncode}) ---\n{out[-4000:]}",
              flush=True)
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks {bad} failed")
    return outs, wall


def drive_shard_views_cli(scene_dir, init):
    """Phase 46 (a): train_3dvid with --num_processes 2 --shard_views on
    mpv_base (``--factor 1 --mpv_frm_num 50``) from phase 18's stage-1
    checkpoint and scene, one level (5), its depth cut to 8 steps: patch
    strides of a patch (4 patches a view, not 9) and --dp_serial_below 0
    (two real patches a step where both ranks have one; rank 0 owns 8
    patches, rank 1 4).  Each rank decodes its own views, only rank 0
    writes the checkpoint and metrics; then the checkpoint loads and
    renders the fixed view in one process (render_video), the launch
    counters set to 0 just before and read just after."""
    expdir = os.path.join(WORK, "s2sv_runs")
    argv = ["--config", os.path.join(REPO, "configs", "mpv_base.txt"),
            "--factor", "1", "--datadir", scene_dir, "--expdir", expdir,
            "--expname", "s2", "--init_from", init, "--mpv_frm_num", "50",
            "--pyr_init_level", "5", "--pyr_num_epoch", "1",
            "--patch_h_stride", "180", "--patch_w_stride", "320",
            "--dp_serial_below", "0",
            "--i_img", "1", "--i_video", "1000", "--shard_views"]
    outs, wall = run_ranks(lambda i, init_m: [
        sys.executable, "-m", "videoloop3d_torch.tools.train_3dvid", *argv,
        "--num_processes", "2", "--process_id", str(i),
        "--coordinator_address", init_m])
    views = [re.search(r"this process decodes views \[([\d, ]+)\]", o)
             for o in outs]
    if not all(views):
        raise AssertionError("a rank did not print its views")
    views = [{int(v) for v in m.group(1).split(",")} for m in views]
    rundir = os.path.join(expdir, "s2")
    ckpt = os.path.join(rundir, "ckpt_l5_epoch_0000.npz")
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    loss = [r["value"] for r in rows if r["tag"] == "stage2/loss"]
    if views[0] & views[1] or views[0] | views[1] != {0, 1, 2} \
            or not os.path.isfile(ckpt) or len(loss) != 8 \
            or not np.isfinite(loss).all() \
            or any("backend gloo" not in o for o in outs):
        raise AssertionError(f"shard_views run: views {views}, loss {loss}")
    frames, counts, _, r_wall = drive(
        ["--datadir", scene_dir, "--expdir", expdir, "--expname", "s2",
         "--factor", "1", "--mpv_frm_num", "50", "--fp16", "--gpu_num",
         GPU_NUM, "--v", "0"])
    if frames.shape[0] != 50 or frames.std() < 1.0 \
            or counts["warp_lookup"] == 0:
        raise AssertionError(f"render of the shard_views checkpoint: "
                             f"{frames.shape}, {counts}")
    return {"cli_wall_s": wall, "views": [sorted(v) for v in views],
            "steps": len(loss), "loss_first_last": [loss[0], loss[-1]],
            "checkpoint": os.path.basename(ckpt),
            "render_frames": list(frames.shape), "render_wall_s": r_wall,
            "render_launches": {k: v for k, v in counts.items() if v}}


def drive_owndata():
    """Phase 46 (b): owndata_step1 on a .npy capture (3 clips of 360x640
    between black frames, factors 1 and 2; without imageio, as on the
    card, the clips are written as .npy), then
    owndata_step2 from a COLMAP binary model written here (no COLMAP
    binary runs): the LLFF poses it writes load back to the model's
    cameras."""
    from videoloop3d_torch.data import llff
    from videoloop3d_torch.tools import owndata_step1, owndata_step2
    from videoloop3d_torch.tools.colmap import binmodel as bm

    root = os.path.join(WORK, "owndata")
    rng = np.random.default_rng(0)
    black = np.zeros((2, 360, 640, 3), np.uint8)
    clips = [rng.integers(40, 255, (6, 360, 640, 3)).astype(np.uint8)
             for _ in range(3)]
    cap = np.concatenate([clips[0], black, clips[1], black, clips[2]])
    os.makedirs(root, exist_ok=True)
    np.save(os.path.join(root, "capture.npy"), cap)
    t0 = time.perf_counter()
    n = owndata_step1.main(["--input_path",
                            os.path.join(root, "capture.npy"),
                            "--output_prefix", os.path.join(root, "scene"),
                            "--factor", "1,2"])
    s1_wall = time.perf_counter() - t0
    v2 = np.load(os.path.join(root, "scene", "videos_2", "0001.npy"))
    if n != 3 or v2.shape != (6, 180, 320, 3) or not np.array_equal(
            np.load(os.path.join(root, "scene", "videos_1", "0002.npy")),
            clips[2]):
        raise AssertionError(f"owndata_step1: {n} clips, {v2.shape}")
    scene = os.path.join(root, "scene")
    sparse = os.path.join(scene, "sparse", "0")
    os.makedirs(sparse)
    w, h, focal = 640, 360, 500.0
    c2ws, images = [], {}
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i, 0.02 * i, 0.0]
        c2ws.append(c2w)
        w2c = np.linalg.inv(c2w)
        images[i + 1] = bm.Image(i + 1, bm.rotmat_to_qvec(w2c[:3, :3]),
                                 w2c[:3, 3], 1, f"{i:04d}.png",
                                 np.zeros((0, 2)), np.zeros(0, np.int64))
    pts = {j + 1: bm.Point3D(j + 1, rng.normal(size=3) + [0, 0, 4.0],
                             np.array([128, 128, 128]), 0.5,
                             np.arange(1, 4), np.zeros(3, np.int32))
           for j in range(40)}
    bm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {
        1: bm.Camera(1, "SIMPLE_PINHOLE", w, h,
                     np.array([focal, w / 2, h / 2]))})
    bm.write_images_binary(os.path.join(sparse, "images.bin"), images)
    bm.write_points3d_binary(os.path.join(sparse, "points3D.bin"), pts)
    t0 = time.perf_counter()
    owndata_step2.main(["--scenedir", scene])
    s2_wall = time.perf_counter() - t0
    poses, bds = llff.load_poses_bounds(scene, factor=1)
    err = max(float(np.abs(poses[i, :3, :4] - c2ws[i][:3, :4]).max())
              for i in range(3))
    if err > 1e-6 or not np.allclose(poses[0, :, 4], [h, w, focal]) \
            or not 1.0 < bds.min() < bds.max() < 10.0:
        raise AssertionError(f"owndata_step2 poses off by {err}")
    return {"step1_clips": n, "step1_wall_s": s1_wall,
            "step2_pose_max_err": err, "step2_bounds": [float(bds.min()),
                                                        float(bds.max())],
            "step2_wall_s": s2_wall}


def parallel_phases(scene_dir, init):
    """Phases 42-46.  Two ranks on cuda:0 under gloo (NCCL refuses two
    ranks on one device; the collectives of CUDA tensors go through the
    host): `par_worker`'s phases 42-45, then phase 46's CLI runs.
    Returns (records of K11's and K12's modes, the fp step's launches)."""
    outs, wall = run_ranks(lambda i, init: [
        sys.executable, os.path.abspath(__file__), "--par-worker", str(i),
        init, os.path.join(WORK, f"par_rank{i}.json")])
    recs = []
    for i in range(2):
        with open(os.path.join(WORK, f"par_rank{i}.json")) as f:
            recs.append(json.load(f))
    r0 = recs[0]
    if any(r["backend"] != "gloo" for r in recs):
        raise AssertionError(f"backends {[r['backend'] for r in recs]}")
    for key, title in (("dp_stage2", "dp = 2, shipped stage-2 step (SGD), "
                        "a 180x320 patch a rank"),
                       ("dp_stage1", "dp = 2, shipped stage-1 step (SGD), "
                        "a 180x320 patch a rank")):
        print(json.dumps({"parallel": title, "slots": r0["slots"],
                          **{k: v for k, v in r0[key].items()},
                          "rank_step_ms": [r[key]["rank_step_ms"]
                                           for r in recs],
                          "rank_collective_ms": [
                              r[key]["rank_collective_ms"] for r in recs]}),
              flush=True)
    for tag in ("gpnn_lm_ref", "swd"):
        print(json.dumps({"parallel": f"fp = 2 at F = 50, {tag} (SGD)",
                          **r0["fp"][tag],
                          "rank_step_ms": [r["fp"][tag]["rank_step_ms"]
                                           for r in recs],
                          "rank_collective_ms": [
                              r["fp"][tag]["rank_collective_ms"]
                              for r in recs]}), flush=True)
    print(json.dumps({"parallel": "phases 42-45 wall", "s": wall}))
    sv = drive_shard_views_cli(scene_dir, init)
    print(json.dumps({"train_3dvid": "--num_processes 2 --shard_views, "
                      "mpv_base level 5", **sv}), flush=True)
    print(json.dumps({"owndata": "step1 on a .npy capture, step2 from a "
                      "binary model", **drive_owndata()}), flush=True)
    return r0["modes"], r0["fp_launches"]


def parallel_inputs():
    """Phase 18's stage-2 scene and stage-1 checkpoint, which phase 46
    trains from."""
    init = os.path.join(WORK, "s2_init", "ckpt_epoch_0000.npz")
    scene_dir = os.path.join(WORK, "s2_scene")
    if not (os.path.isfile(init) and os.path.isdir(scene_dir)):
        raise AssertionError("phase 18's scene or checkpoint is missing")
    return scene_dir, init


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--par-worker"]:
        return par_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    from videoloop3d_torch import kernels
    from videoloop3d_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)

    t = time.perf_counter()
    _, report = kernels.build()
    kernels.library()
    print(json.dumps({"phase": "build", "s": time.perf_counter() - t}))
    print("\n".join(ptxas_lines(report)))
    print(json.dumps({"ptxas": "K22 at C != 4, K3 at C != 4, K23, K15, "
                      "K12, K14, K10, K4, "
                      "K9, K13, K19, K20, K21, K25, K2 at C != 4, K8, K7 "
                      "and K28, redesign and first design",
                      **ptxas_kernels(report)}),
          flush=True)

    t = time.perf_counter()
    mtv = synthetic.make_sparse_mtv(quick=False, seed=0)
    ns, nd = len(mtv["params"]["atlas"]), len(mtv["params"]["atlas_dyn"])
    if (ns, nd, mtv["tile_hw"]) != (9786, 4257, (12, 12)):
        raise AssertionError(f"unexpected MTV: {ns}, {nd}, {mtv['tile_hw']}")
    frm = mtv["frm_num"]
    scene_dir = build_inputs(mtv)
    del mtv
    print(json.dumps({"phase": "mtv", "tiles_static": ns, "tiles_dyn": nd,
                      "s": time.perf_counter() - t}), flush=True)

    model, params, ext, intr, hw = fixed_view(scene_dir, frm)
    rec = check_kernels(model, params, ext, intr, hw)

    fixed, c_fixed, s_fixed, w_fixed = drive(
        cli_argv(scene_dir, frm, ["--v", "0"]))
    spiral, c_spiral, s_spiral, w_spiral = drive(
        cli_argv(scene_dir, frm, ["--f", "10"]))
    for name, counts in (("fixed", c_fixed), ("spiral", c_spiral)):
        idle = [k for k in RENDER_KERNELS if counts[k] == 0]
        if idle:
            raise AssertionError(f"{name} render never launched {idle}")
    H, W = hw
    if fixed.shape != (frm, H, W, 3) or spiral.shape != (10, H, W, 3):
        raise AssertionError(f"frame shapes {fixed.shape} {spiral.shape}")
    for frames in (fixed, spiral):
        if frames.dtype != np.uint8 or frames.std() < 1.0:
            raise AssertionError("rendered frames are constant")
    if np.abs(fixed[0].astype(np.int16) - fixed[25]).max() == 0:
        raise AssertionError("the fixed view does not move over the loop")

    # three rendered frames against the plain-version render on the card
    worst = 0.0
    for t_idx in (0, 37):
        ref = plain_render(model, params, H, W, ext, intr, [t_idx])[0]
        worst = max(worst, u8_close(fixed[t_idx], ref))
    from videoloop3d_torch.core import cameras
    from videoloop3d_torch.data import llff
    sc = llff.load_llff_scene(scene_dir, factor=1, bd_factor=(0.9, 2.0),
                              render_frames=10)
    sp_ext = cameras.pose_to_extrinsic(sc["render_poses"][3:4])
    ref = plain_render(model, params, H, W, sp_ext.astype(np.float32),
                       sc["render_intrins"][3:4], [3])[0]
    worst = max(worst, u8_close(spiral[3], ref))
    if worst > 1e-3:
        raise AssertionError(f"render differs from the plain render on "
                             f"{worst:.2e} of pixels")
    print(json.dumps({
        "render": "fixed view", "frames": len(fixed),
        "ms_per_frame": s_fixed * 1e3 / len(fixed),
        "cli_wall_s": w_fixed, "launches": c_fixed}))
    print(json.dumps({
        "render": "spiral", "frames": len(spiral),
        "ms_per_frame": s_spiral * 1e3 / len(spiral),
        "cli_wall_s": w_spiral, "launches": c_spiral}))
    print(json.dumps({"plain_render_check": "u8 |diff|>1 share",
                      "worst": worst}))
    render_turns = render_ms_in_turns(
        model, params, hw, ext, intr,
        cameras.pose_to_extrinsic(sc["render_poses"]).astype(np.float32),
        sc["render_intrins"], frm)
    print(json.dumps({"render_compare": "K4's first design against its "
                      "redesign, ms/frame", **render_turns}), flush=True)
    print(json.dumps({"profile": "fixed view, one 10-frame chunk",
                      **profile_render(model, params, hw, ext, intr,
                                       np.arange(CHUNK), CHUNK)}))
    print(json.dumps({"profile": "spiral, one frame",
                      **profile_render(model, params, hw,
                                       sp_ext.astype(np.float32),
                                       sc["render_intrins"][3:4], [3], 1)}))

    s1_rec, s1_launches, s1_scene_dir = stage1_phases()
    sp_rec, sp_launches, (s1_model, s1_params) = sparse_phases(s1_scene_dir)
    s2_rec, s2_launches = stage2_phases(s1_model, s1_params)
    del s1_model, s1_params
    d_rec, d_launches = dense_phases(s1_scene_dir)
    q_rec, q_launches = eval_phases()
    g_rec, g_launches = geo_phases(s1_scene_dir)
    w_rec, w_launches = swd_phases()
    m_rec, m_launches = decoder_phases(s1_scene_dir)
    p_rec, p_launches = parallel_phases(*parallel_inputs())

    out = []
    for name in REPLACES:
        if name in s1_rec:
            r = s1_rec[name]
            ship, fused = s1_launches["shipped"][name], \
                s1_launches["fused"][name]
            extra = {"launches": ship + fused, "launches_shipped": ship,
                     "launches_fused": fused}
        elif name == "bilinear_tiles_grad":
            # stage-1 sparse cell a (f32); the shipped stage-2 step's
            # compacted static samples, rounding to bf16, beside it
            r = sp_rec[name]
            t = s2_rec[name]
            # the SH path's CLIs (phase 40): K9 at C = 13 (C = 36 and 8
            # there train dense epochs only)
            sh = sum(v.get("launches", {}).get(name, 0)
                     for v in m_rec["sh_path"].values()
                     if isinstance(v, dict))
            extra = {"launches": sp_launches[name] + s2_launches[name] + sh,
                     "launches_s1_sparse": sp_launches[name],
                     "launches_s2": s2_launches[name],
                     "launches_sh_clis_C13": sh,
                     "stage2_S15_rounded": {k: t[k] for k in (
                         "ms", "first_design_ms", "f32_ms",
                         "replaced_chain_ms", "redesign_beside_old_chain_ms",
                         "plain_ms", "samples", "hits", "tiles")}
                     | {"bound_ms": t["bound"][0]},
                     # C != 4: the binned gather beside the atomic route
                     # it replaced, phase 38's static atlas at S slots
                     "by_channels": {f"C{c}": {
                         k: m_rec[f"tiles/C{c}"]["static"][k] for k in (
                             "grad_ms", "grad_atomic_ms", "grad_ms_in_turns",
                             "grad_rounded_ms", "grad_rounded_atomic_ms",
                             "grad_plain_ms", "grad_bound_ms",
                             "gather_max_rel_err", "atomic_max_rel_err",
                             "same_bits_twice", "rounded_equals_f32_rounded",
                             "layout", "grad_split_ms",
                             "grad_atomic_split_ms")}
                         for c in (13, 36, 8)}}
        elif name in ("bilinear_tiles_tilemajor_grad",) + SHIPPED_KERNELS:
            r = s2_rec[name]
            extra = {"launches": s2_launches[name]}
        elif name in DENSE_KERNELS:
            # the main path under the shipped --fp16, training patch: the
            # f32 atlas gathered as bf16 (K16), the f32 gradient's sums
            # rounded to bf16 (K17); every mode beside it
            k16 = name == "bilinear_planes_tilemajor"
            r = d_rec[f"{name}/{'f32 as bf16' if k16 else 'bf16'}"]
            extra = {"launches": d_launches[name], "modes": {
                k.split("/", 1)[1]: {
                    f: v[f] for f in ("ms", "first_design_ms", "library_ms",
                                      "replaced_chain_ms") if f in v}
                | {"bound_ms": v["bound"][0]}
                for k, v in d_rec.items() if k.startswith(name + "/")}}
            c13 = m_rec["planes/C13"]
            extra["modes"]["C13 bf16, 10 frames"] = (
                {"ms": c13["ms"], "fused_ms": c13["fused_ms"],
                 "first_design_ms": c13["first_design_ms"],
                 "bound_ms": c13["bound_ms"],
                 "fused_bound_ms": c13["fused_bound_ms"]} if k16 else
                {"ms": c13["grad_ms"],
                 "first_design_ms": c13["grad_first_design_ms"],
                 "bound_ms": c13["grad_bound_ms"]})
        elif name in GEO_KERNELS:
            r = g_rec[name]
            extra = {"launches": g_launches[name]}
            if "flat_ms" in r:
                extra["flat_verts_ms"] = r["flat_ms"]
                extra["flips_flat_perturbed"] = r["flips_flat_perturbed"]
            if name == "geo_warp_bwd":
                extra.update({k: r[k] for k in (
                    "flat_first_design_ms", "ms_in_turns",
                    "overflow_samples", "same_bits_twice")})
            if name == "geo_warp_fwd":
                extra.update({k: r[k] for k in (
                    "flat_first_design_ms", "ms_in_turns", "global_samples",
                    "equal_first_design", "oblique", "bound_divisions_ms")})
            if "bf16_ms" in r:
                extra["bf16_ms"] = r["bf16_ms"]
            if name == "bilinear_tiles_coord_grad":
                extra.update({k: r[k] for k in (
                    "ms_in_turns", "equal_first_design", "bf16")})
            if name == "sample_dense_coord_grad":
                # C != 4 (redesigned): phase 37's designs in turns, phase
                # 30's SH geo steps with either design, and the launches
                # of phase 40's rgba_sh geometry epoch (C = 36)
                sh = m_rec["sh_path"]["train_3d_rgba_sh"]["launches"].get(
                    name, 0)
                extra["launches"] += sh
                extra["launches_sh_cli_rgba_sh_C36"] = sh
                extra["designs_by_channels"] = {
                    f"C{c}": m_rec[f"k22/C{c}"] for c in (4, 13, 36, 8)}
                extra["sh_geo_steps"] = {
                    k: {f: v[f] for f in ("metrics_max_rel_err",
                                          "grads_max_rel_err", "channels",
                                          "k22_in_turns")}
                    | {"device_ms": v["profile"]["device_ms"],
                       "peak_memory_gb": v["profile"]["peak_memory_gb"]}
                    for k, v in g_rec["sh_geo_steps"].items()}
        elif name in ("nn_band_argmin", "nn_band_err"):
            # the eval pair at the first patch scale, (5, 2, 7, 1)
            r18, r19 = q_rec["p5s2pt7st1"]
            r = r18 if name == "nn_band_argmin" else r19
            train = s2_launches.get(name, 0)
            extra = {"launches": q_launches[name] + train,
                     "launches_evaluate": q_launches[name],
                     "launches_train_fast_nn_dist": train,
                     "ms_by_scale": {t: q_rec[t][name == "nn_band_err"]["ms"]
                                     for t in q_rec}}
            if name == "nn_band_err":
                # both directions at every scale, both designs in turns,
                # the two target reads, the errors against float64 sums;
                # the NN groups of one view with either design
                for k in ("first_design_ms", "reverse_ms",
                          "reverse_first_design_ms", "l1_ms", "staged_ms",
                          "one_column_ms", "plain_ms", "library_ms"):
                    extra[f"{k}_by_scale"] = {t: q_rec[t][1][k]
                                              for t in q_rec}
                extra["bound_ms_by_scale"] = {
                    t: q_rec[t][1]["bound"][0] for t in q_rec}
                extra["rel_err_vs_f64_by_scale"] = {t: {
                    "redesign": max(q_rec[t][1][f"{d}checks"][
                        "rel_err_vs_f64"] for d in ("", "reverse_")),
                    "first_design": max(q_rec[t][1][f"{d}checks"][
                        "first_design_rel_err_vs_f64"]
                        for d in ("", "reverse_"))} for t in q_rec}
                extra["layout_by_scale"] = {
                    t: q_rec[t][1]["checks"]["layout"] for t in q_rec}
                extra["nn_groups_s_in_turns"] = r["nn_groups_s"]
            if name == "nn_band_argmin":
                extra["first_design_ms_by_scale"] = {
                    t: q_rec[t][0]["first_design_ms"] for t in q_rec}
                extra["library_ms_by_scale"] = {
                    t: q_rec[t][0]["library_ms"] for t in q_rec}
                extra["bound_ms_by_scale"] = {
                    t: q_rec[t][0]["bound"][0] for t in q_rec}
                for t in ("ref/f32", "ref/bf16", "other/f32", "other/bf16"):
                    tr = s2_rec[f"nn_band_argmin/train/{t}"]
                    extra[f"train_{t.replace('/', '_')}"] = {
                        k: tr[k] for k in ("ms", "first_design_ms",
                                           "library_ms")} | {
                        "bound_ms": tr["bound"][0]}
        elif name in SWD_KERNELS:
            # the ref view (11x11 patches); the other view beside it
            r = w_rec[f"{name}/ref"]
            o = w_rec[f"{name}/other"]
            extra = {"launches": w_launches[name], "other_view_ms": o["ms"],
                     "other_view_bound_ms": o["bound"][0],
                     "other_view_plain_ms": o["plain_ms"],
                     "other_view_library_ms": o["library_ms"]}
            if "first_design_ms" in o:
                extra["other_view_first_design_ms"] = o["first_design_ms"]
            if name == "swd_sort_l1":
                extra.update(ms_in_turns=r["ms_in_turns"],
                             other_view_ms_in_turns=o["ms_in_turns"],
                             equal_first_design=[r["equal_first_design"],
                                                 o["equal_first_design"]],
                             nan_grad_equal_plain=[r["nan_grad_equal_plain"],
                                                   o["nan_grad_equal_plain"]])
            for k in ("gemm_ms", "fold_ms", "first_design_gemm_ms",
                      "first_design_fold_ms", "gemm_library_ms"):
                if k in r:
                    extra[k] = r[k]
                    extra[f"other_view_{k}"] = o[k]
        elif name in ("nn_argmin_ssim", "nn_fold_parent"):
            r = w_rec[f"{name}/ref/bf16"]
            extra = {"launches": w_launches[name]}
            if name == "nn_argmin_ssim":
                for t in ("other/bf16", "ref/f32"):
                    tr = w_rec[f"nn_argmin_ssim/{t}"]
                    extra[t.replace("/", "_")] = {
                        k: tr[k] for k in ("ms", "first_design_ms",
                                           "library_ms")} | {
                        "bound_ms": tr["bound"][0]}
        elif name in MASK_KERNELS:
            # the ref view at factor 3 (the mask step's case); every case
            r = m_rec[f"{name}/ref/x3"]
            cases = [f"{v}/x{f}" for v in ("ref", "other") for f in (1, 3)]
            extra = {"launches": m_launches[name],
                     "pair_yardstick_ms": r["pair_yardstick_ms"],
                     "ms_by_case": {c: m_rec[f"{name}/{c}"]["ms"]
                                    for c in cases},
                     "bound_ms_by_case": {
                         c: m_rec[f"{name}/{c}"]["bound"][0] for c in cases}}
            if name == "swd_mask_sort":
                extra.update({
                    f"{k}_by_case": {c: m_rec[f"{name}/{c}"][k]
                                     for c in cases}
                    for k in ("first_design_ms", "library_ms", "y_ms",
                              "first_design_y_ms", "y_library_ms",
                              "y_bound_ms")})
            if name == "swd_mask_l1":
                extra.update({
                    f"{k}_by_case": {c: m_rec[f"{name}/{c}"][k]
                                     for c in cases}
                    for k in ("first_design_ms", "ms_in_turns", "route",
                              "equal_first_design",
                              "loss_ulps_from_first_design")})
                extra["static_first_design"] = {
                    v: m_rec[f"{name}/{v}/x1"]["static_first_design"]
                    for v in ("ref", "other")}
                extra["long_rows"] = {k: m_rec[f"{name}/long/{k}"]
                                      for k in ("66x2.2M", "2x16.2M")}
                extra["route_counts"] = dict(MASK_L1_ROUTE_COUNTS)
                extra["step_in_turns"] = m_rec["mask_step_k28_in_turns"]
        elif name in PAR_KERNELS:
            # the fp step's ref view (alpha 0, bf16 search) on rank 0's 25
            # + 2 frames; launches: rank 0 in phase 43's gpnn step
            r = p_rec[name]
            extra = {"launches": p_launches[name]}
            extra.update({k: r[k] for k in (
                "nn_argmin_ms", "equal_nn_argmin", "index_flips_vs_plain",
                "nn_fold_ms", "divided_equals_nn_fold") if k in r})
        elif name in ("nn_argmin", "nn_fold"):
            # the ref view's bf16 search: the shipped route's costliest
            r = s2_rec[f"{name}/ref/bf16"]
            extra = {"launches": s2_launches[name],
                     "other_view_bf16_ms": s2_rec[f"{name}/other/bf16"]["ms"],
                     "other_view_bf16_bound_ms":
                         s2_rec[f"{name}/other/bf16"]["bound"][0]}
        else:
            # K3: the f32 atlas gathered as bf16, as the --fp16 render
            # reads it
            r = rec[next(k for k in (name, f"{name}/f32 as bf16",
                                     f"{name}/bf16") if k in rec)]
            extra = {"launches": c_fixed[name] + c_spiral[name]
                     + sp_launches[name] + s2_launches[name]
                     + q_launches[name],
                     "launches_fixed": c_fixed[name],
                     "launches_spiral": c_spiral[name],
                     "launches_s1_sparse": sp_launches[name],
                     "launches_s2": s2_launches[name],
                     "launches_evaluate": q_launches[name]}
        if f"{name}/C13" in m_rec:
            # the other decoders' channel counts (C = 4 timed again in the
            # same call)
            extra["by_channels"] = {
                f"C{c}": {k: m_rec[f"{name}/C{c}"][k]
                          for k in ("ms", "plain_ms", "library_ms",
                                    "first_design_ms")
                          if k in m_rec[f"{name}/C{c}"]}
                | {"bound_ms": m_rec[f"{name}/C{c}"]["bound"][0]}
                for c in (4, 8, 13, 36)}
        if "first_design_ms" in r:
            extra["first_design_ms"] = r["first_design_ms"]
        if name in DESIGN_KERNELS:
            extra["kernels"] = DESIGN_KERNELS[name]
        if name in ("fused_s1_bwd", "fused_s1_fwd"):
            extra.update({k: r[k] for k in (
                "ms_in_turns", "equal_first_design", "all_on", "layout",
                "step_in_turns")})
        if name == "bilinear_tiles":
            # C != 4 (redesigned): phase 38's static atlas at S slots in
            # each texel mode, the sparse stage-1 samples at C = 13, the
            # rgb_sh stage-2 step with either design; the SH CLIs'
            # launches (C = 13)
            sh = sum(v.get("launches", {}).get(name, 0)
                     for v in m_rec["sh_path"].values()
                     if isinstance(v, dict))
            extra["launches"] += sh
            extra["launches_sh_clis_C13"] = sh
            extra["C_not_4"] = {f"C{c}": m_rec[f"k2/C{c}"]
                                for c in (13, 36, 8)}
            extra["C_not_4"]["sparse_s1_C13"] = m_rec["k2/sparse_s1_C13"]
            extra["C_not_4"]["sh_s2_step_in_turns"] = \
                m_rec["sh_s2_step"]["k2_in_turns"]
        if "by_flags" in r:
            extra["by_flags"] = r["by_flags"]
        if name == "bilinear_tiles":
            extra["modes"] = {m: {"ms": rec[f"{name}/{m}"]["ms"],
                                  "bound_ms": rec[f"{name}/{m}"]["bound"][0]}
                              for m in ("f32", "bf16")}
            extra["bf16_copy_ms"] = r["bf16_copy_ms"]
            extra["copy_to_bf16_ms"] = r["copy_ms"]
            t = s2_rec[f"{name}/f32 as bf16"]
            extra["stage2_S15_f32_as_bf16"] = {
                k: t[k] for k in ("ms", "bf16_copy_ms", "copy_ms",
                                  "plain_ms")} | {"bound_ms": t["bound"][0]}
        if name == "compact_sweep":
            extra["random_sweeps_max_hits_and_over_S"] = r["random_sweeps"]
            extra["layout"] = r["layout"]
            extra["ms_in_turns"] = r["ms_in_turns"]
        if name == "composite":
            extra["modes"] = {"f32": {
                k: rec["composite/f32"][k] for k in ("ms", "first_design_ms",
                                                     "plain_ms")}}
            extra["layout"] = r["layout"]
            extra["render_ms_per_frame_in_turns"] = render_turns
        if name == "bilinear_tiles_tilemajor":
            extra["modes"] = {m: {"ms": rec[f"{name}/{m}"]["ms"],
                                  "bound_ms": rec[f"{name}/{m}"]["bound"][0]}
                              for m in ("f32", "bf16")}
            extra["copy_to_bf16_ms"] = r["copy_ms"]
            t = s2_rec[f"{name}/stage 2, f32 as bf16"]
            extra["stage2_f32_as_bf16"] = {
                k: t[k] for k in ("ms", "bf16_copy_ms", "copy_ms",
                                  "plain_ms")} | {"bound_ms": t["bound"][0]}
            extra["by_channels"] = {
                f"C{c}": {"ms": m_rec[f"tiles/C{c}"]["dynamic"]["ms"],
                          "bound_ms": m_rec[f"tiles/C{c}"]["dynamic"][
                              "bound_ms"]} for c in (13, 36)}
            # C != 4 (redesigned): phase 38's dynamic atlas at S slots
            # and the eval chunk, each mode and frame set; the rgb_sh
            # stage-2 step's launches and its profile with either design
            sh = m_rec["sh_s2_step"]
            n_sh = sum(sh[v]["launches"].get(name, 0)
                       for v in ("ref", "other"))
            extra["launches"] += n_sh
            extra["launches_sh_s2_step_C13"] = n_sh
            extra["C_not_4"] = {f"C{c}": m_rec[f"k3/C{c}"] for c in (13, 36)}
            extra["C_not_4"]["eval_C13"] = m_rec["k3/eval_C13"]
            extra["C_not_4"]["sh_s2_step_in_turns"] = sh["k3_in_turns"]
        if name == "bilinear_tiles_tilemajor_grad":
            extra.update(f32_ms=r["f32_ms"],
                         replaced_chain_ms=r["replaced_chain_ms"])
            extra["by_channels"] = {
                f"C{c}": {k: m_rec[f"tiles/C{c}"]["dynamic"][k] for k in (
                    "grad_rounded_ms", "grad_ms", "grad_first_design_ms",
                    "grad_plain_ms", "grad_bound_ms")} for c in (13, 36)}
        if name == "nn_fold":
            o = s2_rec["nn_fold/other/bf16"]
            extra["other_view_bf16_first_design_ms"] = o["first_design_ms"]
            extra["other_view_bf16_plain_ms"] = o["plain_ms"]
            extra["other_view_bf16_library_ms"] = o["library_ms"]
        if name == "nn_argmin":
            extra["other_view_bf16_first_design_ms"] = \
                s2_rec["nn_argmin/other/bf16"]["first_design_ms"]
            # f32 inputs: the CUDA-core search beside its first design
            tr = w_rec["nn_argmin/ref/f32"]
            extra["ref_f32"] = {k: tr[k] for k in (
                "ms", "first_design_ms", "library_ms")} | {
                "bound_ms": tr["bound"][0]}
        b, by = r["bound"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], **extra,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b, "bound_by": by,
            "library_ms": r.get("library_ms")})
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"phase": "all", "s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
