#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (threestudio_3dgs_tpu_torch) on one
NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run with a non-zero exit:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the hand-written kernels from csrc/ (one nvcc per source, all
     started together) and print the build time and ptxas lines (each
     kernel's registers, shared memory and spills, and any warning);
  3. hold every kernel of the training path (K1 blend forward, K2 blend
     backward, K3 segmented sum, K4 pair expansion) against its plain torch
     version on the card, at a small scene (tile 16) and at bench.py's
     scene (1M Gaussians, 512^2, tile 32, seed 0); hold K6 (the slot-only
     expand, on no training path) exactly against its plain version on
     both scenes' depth-ordered pair offsets (max_pairs rounded up to 512)
     and on bench-scale offsets with runs of 20,000 empty Gaussians (windows
     wider than a block's staged offsets);
  4. time a forward+backward ``rasterize`` of bench.py's scene (CUDA
     events, median of 10) with zero dropped pairs, and each kernel (K6
     included) beside its bound, its plain version and, where one exists,
     a library call: the kernel and the library call each by wrapper time
     (CUDA events around back-to-back calls, host work included) and by
     device time (one CUDA graph of the same calls replayed between CUDA
     events: every kernel the call launches, no host work between them;
     ``torch.profiler`` dropped the records of whole windows on the card's
     machine, so it is ``utils/kernel_timing.py``'s cross-check); print each
     input's tile skew (the small, bench and train inputs: the heaviest
     tile's pairs and evaluations, and the heaviest blend work unit's
     evaluations, as multiples of an even per-SM share), K4's input
     shape (live slots, the most pairs a Gaussian has) and K3's (live
     segments, blocks), each with its bound's bytes;
  5. train ``gaussian_splatting.yaml`` for 20 steps through the port's own
     ``launch.main`` (512^2, batch 4, tile 32, capacity 651,024, 4096
     initial points, fake SDS guidance; the test renders follow) with every
     launch counter zeroed just before and read just after: K1-K4 must
     have launched, on the stacked grid once a step after step 0 (the
     controller shrinks the capacity at step 0, so steps 1-19 take the
     single pass), and every logged loss must be finite; then hold K1-K4
     again and time them at the trained field's shapes (one view of a
     training batch, and the stacked grid of that batch's 4 views);
  6. full run: ``launch.main --train`` on the same YAML and width for 40
     steps with the structural schedule brought forward (validation every
     20 steps; prune and densify every 10 from step 10 with a zero
     gradient threshold, so every alive row densifies; opacity reset at 20;
     max_num 10,000, so the cap-prune at step 30 leaves exactly 10,000),
     then the 120 test renders and the point-cloud PLY; fails unless
     gauss_num rises after step 10, 10,000 rows are alive at the end, no
     pair is dropped, every logged loss is finite, K1-K4 launched, the two
     validation PNGs and the 120 test PNGs vary, and the PLY reads back
     with 10,000 vertices; then ``--export --resume`` the last checkpoint
     must write an OBJ with faces; prints the wall time, the median step,
     the step times around each structural step and each structural op's
     time on the final field (CUDA events);
  6b. ``train_batched``: ``gaussian_splatting.yaml`` as written (its
     ``batched`` and ``adaptive_max_pairs`` on) for 60 steps through
     ``launch.main`` with fake SDS (512^2, B = 4; 4 test renders after),
     every counter zeroed just before: fails unless the controller printed
     one capacity line, 2^21 -> min_pairs (256 Ki) a view at step 0, step 0
     rendered view by view and steps 1-59 in the single pass (the
     renderer's path counts; the gate takes 4 x 512^2 at 256 Ki), K1-K4
     launched on the stacked grid (the ``stacked`` launch tags) once a step
     after step 0, every loss and parameter finite and no pair dropped;
     then on the last step's field at the next batch's 4 cameras: K1-K4 on
     the (64, 16) stacked grid held against their plain twins
     (``check_kernels``) and timed, and ``rasterize_batched`` held against
     the per-view ``rasterize`` (forward outputs, radii and visibility
     equal, gradients to 2e-4 x scale) with both timed fwd+bwd (median of
     10, CUDA events);
  6c. ``train_dp`` (multi-device): (a) ``gaussian_splatting.yaml`` as
     written for 10 steps (512^2, B = 4, fake SDS) through ``launch.main``
     with ``trainer.devices=0`` and with ``trainer.devices=1`` (the
     data-parallel step on a one-rank NCCL group in an in-process store):
     fails unless the two fields (params, Adam moments, statistics) and
     losses are equal bit for bit; the two median steps and the gradient
     mean (``chunked_pmean`` of the field's gradients) timed; (b) the
     trained field's 512^2 view as 4 bands of 4 tile rows through
     ``rasterize(tile_band=...)`` against its full render (image / alpha
     1e-5, depth 1e-4, radii and visibility equal, the bands' summed
     gradients 1e-3 of the norm), K1-K4 launched once a band; K1-K4 held
     and timed on one 512 x 128 band (``@band``) and on a rank's 2-view
     stacked grid (``@dp_shard``); (c) two ranks spawned (not forked) on
     the card, both on cuda:0 over gloo's CUDA collectives (NCCL refuses
     two ranks on one device; one rank a card over NCCL where there are
     two), 3 steps of the YAML through ``launch.main`` at 2 x 2 views with
     fake-mse: fails unless both ranks' fields are bit-equal, the first
     loss equals a one-process run's to 2e-4 relative, each rank took
     step 0 view by view and steps 1-2 on its stacked grid (K1-K4 launched
     there twice), and the two-rank tile renderer's gathered view equals
     the full render (the tolerances of (b)); the gradient mean timed at
     two ranks;
  6d. ``profile``: ``python -m threestudio_3dgs_tpu_torch.launch --train
     --profile`` of ``gaussian_splatting.yaml`` as written (512^2, B = 4,
     fake SDS, 5 steps, 2 test renders) in a process of its own: fails
     unless it exits 0, writes a ``torch.profiler`` trace under
     ``<trial_dir>/profile``, the trace records at most the schedule's 3
     profiler steps, its CUDA kernel events name K1-K4 by their ``csrc/``
     symbols and its recorded steps hold the spans ``fit/train_step``,
     ``system/render``, ``system/guidance`` and ``system/backward``;
     prints the trace's device-busy share and, by span path
     (``benchmark/spans.py``), device ms, host self ms and idle ms a step
     beside the card's name and power limit;
  7. Stable Diffusion guidance: write a seeded random-init checkpoint
     directory with the published stabilityai/stable-diffusion-2-1-base
     UNet, VAE and text encoder architectures (diffusers layout, f32 .bin)
     and a synthetic CLIP tokenizer under outputs/chip_smoke/; hold K5
     (flash attention) against its plain version at the UNet's
     self-attention shapes, (40, 4096, 64) and (80, 1024, 64) in bf16 (the
     wgmma kernel, to 2^-6 of max|plain|, two bf16 ulps), at (40, 4096, 64)
     with keys in rising norm (the running max grows in every key tile) and
     at a ragged (40, 1000, 64) in bf16, and in f32 (the split-bf16 wgmma
     kernel, 2e-5) at (16, 1024, 64) and at MVDream's two shapes,
     (10, 4096, 64) and (20, 1024, 64), the first again with keys in rising
     norm, there against the float64 value (the plain f32 twin is itself up
     to 2.5e-5 from it) and no further from it than the plain twin; hold
     the SD guidance on a tiny random directory
     and the CLIP text encoder on a tiny random directory on the card
     against their CPU runs; train gaussian_splatting.yaml with its own
     ``stable-diffusion-guidance`` pointed at the SD directory for 10 steps
     (bf16 UNet and VAE, the CFG batch of 8), counters zeroed just before:
     every loss finite, grad_norm > 0, K1-K4 launched and K5 launched
     exactly 5 times per step at each of the two shapes; then time K5
     there beside its plain version, ``scaled_dot_product_attention`` and
     its bound, with its TFLOP/s and share of the bound;
  8. the lit and multi-view YAMLs, 10 steps each through ``launch.main``
     (8 test renders after), counters zeroed just before each: (a)
     gaussian_splatting_shading.yaml with its own SD guidance and CLIP
     prompts on the SD directory (512^2, B = 4, bf16; ambient-only for 5
     steps, lit after); (b) gaussian_splatting_mvdream.yaml with
     ``mvdream-multiview-diffusion-guidance`` on a freshly written seeded
     random MVDream directory (the published UNet with the 4-view fold and
     camera MLP, f32 as the JAX guidance builds it; 256^2, 4 views, CFG
     batch 8; CLIP prompts; ambient-only for 5 steps; the background
     augmented with probability 0.5, not 0.95, so that it trains); (c)
     gaussian_splatting_background.yaml with fake SDS (512^2, B = 4).  Each
     fails unless every logged loss is finite, grad_norm > 0, K1-K4
     launched, K5 launched 5 times a step at exactly its shapes ((a): the
     two bf16 ones; (b): (10, 4096, 64) and (20, 1024, 64) in f32; (c):
     none), K1-K4 launched on the stacked grid once a step after step 0,
     and the background MLP moved; then K1-K4 are held and timed at one
     256^2 view of the trained MVDream field and on the (32, 8) stacked
     grid of its 4 views, and K5 timed in f32 at MVDream's shapes; then
     ``train_mvdream_pred_normal``: 3 steps of the
     MVDream YAML with ``system.geometry.pred_normal=true`` and
     ``system.loss.lambda_pred_normal=1`` (train_lit's checks): K1/K2 at 7
     channels only (rgb, depth, the field's normal), train/loss_pred_normal
     finite and > 0 each step, the normal field moved; K1-K4 held and timed
     at one 256^2 view of that field and on the stacked grid of its 4
     views (C = 7);
  9. image-to-3D: hold K5 at Stable Zero123's head dim, d = 40, against its
     plain version ((64, 1024, 40) bf16 on standard normal and on rising
     keys, a ragged (64, 1000, 40) bf16, (16, 1024, 40) f32 and the same at
     rising keys against the float64 value); hold the Zero123 guidance on a
     tiny random ldm ``.ckpt`` (320 channels and 8 heads at level 0, so its
     1024-token self-attention runs K5 at d = 40) on the card against its
     CPU run; then ``zero123_guidance``: write a seeded random
     ``stable_zero123``-format ``.ckpt`` (the published ZERO123_UNET, the
     SD VAE encoder, cc_projection 772 -> 768, f16) and a random ViT-L/14
     ``image_encoder/`` beside it, ``prepare_embeddings`` on a reference
     frame, 10 guidance calls with backward on (4, 256, 256, 3) renders
     (bf16, CFG batch 8): K5 exactly 5 times a call at (64, 1024, 40) and
     nowhere else, finite loss, grad_norm > 0; then ``train_zero123``: 10
     steps of gaussian_splatting_zero123.yaml through ``launch.main`` on a
     synthetic 512^2 RGBA reference PNG, the ref view at 128^2, 256^2 and
     512^2 (milestones 3 and 6), the random views at 4 x 256^2: finite
     losses, the guidance's grad_norm > 0, K1-K4 launched and K5 never (the
     analytic prior, as in the JAX package); then warm starts from the
     run's ``.ckpt.npz`` and its PLY, each loaded field equal to the saved
     one, and 2 steps from each, and ``--export --resume`` its checkpoint
     (an OBJ with faces); time K5 at (64, 1024, 40) bf16; then K5 past 64
     columns (d = 72, 80, 128, 160 and 256 in bf16 at (64, 1024, d), the
     first four in f32 at (16, 1024, d), d = 80 ragged and on rising keys,
     (64, 4096, 40)) against its plain version, and ``zero123_guidance_512``:
     3 calls of the guidance at ``cond_image_size=512`` on 4 x 512^2
     renders: K5 exactly 5 times a call at (64, 4096, 40) and (64, 1024, 80)
     and nowhere else, then the denoiser's output through K5 held against
     the same call through the plain twin; K5 timed at both shapes and at
     (64, 1024, 160);
 10. video-to-4D: hold K5 at the temporal Zero123's CFG batch, (320, 1024,
     40) bf16, on standard normal and rising keys; then ``train_gs4d``: 10
     steps of gs4d_motion.yaml through ``launch.main`` at its widths (10
     frames, the reference views at 256^2 and from step 5 at 512^2, 20
     random views a step at 256^2, 4096 points in a 651,024 capacity, the
     lite ARAP from step 4 with its k-NN refreshed every 4 steps) with its
     temporal-stable-zero123-guidance on the random Stable Zero123
     checkpoint, counters zeroed just before (the reference frames kept at
     256^2 past the milestone at step 5, as the JAX package keeps the
     first size): the bf16 denoiser built
     through ``attach_video_frames``, K5 exactly 5 times a step at (320,
     1024, 40) and nowhere else, every loss finite (``loss_ref_gs`` and
     ``loss_lite_arap_reg`` logged each step), grad_norm > 0, motion and
     omega trained (trbf_center and trbf_scale, which take no gradient,
     unmoved); the 8 timed test renders and the temporal PLY read back
     equal to the trained rows; 2 more steps with ``--resume`` from its
     checkpoint; then 4 steps each of gs4d.yaml (spline with per-frame
     deltas) and gs4d_static.yaml (SuGaR's opacity, density and normal
     regularisers), on the analytic prior; K1-K4 held and timed at a
     256^2 reference-frame view of the trained 4D field, K5 timed at
     (320, 1024, 40);
 11. SuGaR static, both stages, through ``launch.main`` with counters zeroed
     just before each: ``train_sugar_gaussian``, 10 steps of
     gs_to_sugar.yaml at its widths (the 128^2 reference view, 8 random
     views at 256^2, 4096 points; ``sugar_prune_at`` brought forward to
     step 8, with a threshold the 10-step field's opacities straddle, and
     the opacity, density and SDF-normal regularisers every step) on the
     analytic prior: K1/K2 at 4 channels only, every loss finite, rows
     pruned, its checkpoint and 4 test renders; then
     ``train_sugar_refine``, 10 steps of sugar_static_refine.yaml bound
     through ``geometry_convert_from`` to that checkpoint (the mesh
     extracted from the field, 6 Gaussians a face) at 512^2, B = 4: K1/K2
     at 7 channels only (rgb, depth, face normals), every loss finite, the
     mesh vertices moved, 4 test renders, the PLY of every bound Gaussian,
     2 more steps with ``--resume``; K1-K4 held and timed at a 512^2
     reference view of the refined field (C = 7); then ``bake_sugar``:
     ``launch.main --predict --resume`` of the refined checkpoint with
     ``system.postprocess=true`` and the 2^24 pair ceiling over the 120
     test views: the OBJ (F faces, 3F vt rows), MTL and PNG (tex_size^2)
     read back, K1 and K4 launched by the renders; the faces before and
     after the postprocess, the texture size, the share of texels a view
     saw, the id-pass's drop counters per view (max, sum), the wall seconds
     of the renders, id-passes, texel init, scatters and file writes and
     the peak device memory printed; one view's id-pass on the card held
     against the same call on the CPU at 256^2 (face ids equal but at z
     ties and edge pixels, counted and printed);
 12. dynamic SuGaR: hold K5 at the temporal Zero123's CFG batches on these
     YAMLs, (256, 1024, 40) and (16, 1024, 40) bf16, on standard normal and
     rising keys; write the refined mesh of phase 11 to an OBJ and bind it
     through ``surface_mesh_to_bind_path``; ``train_sugar_dynamic``: 10
     steps of sugar_dynamic_dg_zero123.yaml through ``launch.main`` at its
     widths (32 frames, 8 reference views at 512^2, 2 x 8 random views at
     256^2, 1000 nodes x 16, DQS, the deformation network, per-node scale
     deltas) on the random Stable Zero123 checkpoint, counters zeroed just
     before: the bf16 denoiser built through ``attach_video_frames``, K5
     exactly 5 times a step at (256, 1024, 40) and nowhere else, K1/K2 at 7
     channels only, every loss finite, no pair dropped (under 2^24 pairs a
     view), grad_norm > 0, the deformation network's head biases (its only
     params with a gradient at the start) and the scale tracks moved; its
     face count, median step and peak device memory printed; 4 test
     renders, the PLY of every bound Gaussian, 2 more steps with
     ``--resume``; then 3 steps each of sugar_dynamic.yaml (discrete,
     spline; the inter-frame ARAP from step 1, on the command line),
     sugar_drag.yaml (1 frame, no spline, on the checkpoint: K5 exactly 5
     times a step at (16, 1024, 40)) and sugar_dynamic_dg.yaml, the node
     tracks or the network trained; K1-K4 held and timed at a 256^2 random
     view and a 512^2 reference view of the trained dynamic field at their
     times (C = 7), K5 timed at both shapes;
 13. print the per-kernel JSON line (launches from the training runs, K6's
     from its checks, K5 at d = 40 from ``zero123_guidance``,
     ``train_gs4d`` and the dynamic SuGaR runs; times at the main path's
     shapes, K6's at the bench scene; a run's launches on the stacked grid
     (its ``stacked`` tags) go to its ``_stacked`` row and only its other
     launches to its single-view row; K1-K4 rows at the trained 512^2 view
     and on its batch's stacked grid (``@train_stacked``), on the stacked
     grid of ``train_batched``'s 4 views (``@stacked``), on a rank's 2-view
     stacked grid (``@dp_shard``, launches from rank 0 of ``train_dp``'s
     two-rank run) and on one 512 x 128 tile band (``@band``, launches from
     ``train_dp``'s 4 band renders), at the MVDream view
     and its stacked grid (``@mvdream256_stacked``), at the pred_normal
     MVDream view and its stacked grid (C = 7, ``@mvdream_pn`` and
     ``@mvdream_pn_stacked``, launches from ``train_mvdream_pred_normal``), at the
     zero123 YAML's 128^2 ref view (launches
     from ``train_zero123``), at the 4D field's 256^2 reference-frame view
     (launches from ``train_gs4d``'s 10 steps), at the SuGaR field's 512^2
     view (C = 7, launches from ``train_sugar_refine``'s 10 steps) and at
     the dynamic SuGaR field's 256^2 random and 512^2 reference views
     (``@sugar_dyn256`` / ``@sugar_dyn512``, launches from
     ``train_sugar_dynamic``'s 10 steps); one K5 row per shape and type
     (``@64x4096x40`` and ``@64x1024x80`` with launches from
     ``zero123_guidance_512``);
     ``ms`` and ``library_ms`` wrapper times, ``device_ms`` and
     ``library_device_ms`` device times; K5's bound the largest of its
     bytes, its products and its exponentials on the SFU at the card's
     highest SM clock, named by ``bound_term``), then
     ``{"ok": true, ...}`` last.

Nothing is caught and passed over: the first failure ends the run.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PORT_CONFIG = os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs", "gaussian_splatting.yaml")
RUN_DIR = os.path.join(ROOT, "outputs", "chip_smoke")
SD_DIR = os.path.join(RUN_DIR, "sd21-base-random")
SD_STEPS = 10
FULL_STEPS = 40
FULL_MAX_NUM = 10000
FULL_STRUCTURAL_STEPS = (10, 20, 30)  # densify, densify + opacity reset, cap-prune
BATCHED_STEPS = 60  # the controller adapts at steps 0 and 50
CONFIG_DIR = os.path.join(ROOT, "threestudio_3dgs_tpu_torch", "configs")
SHADING_CONFIG = os.path.join(CONFIG_DIR, "gaussian_splatting_shading.yaml")
MVDREAM_CONFIG = os.path.join(CONFIG_DIR, "gaussian_splatting_mvdream.yaml")
BACKGROUND_CONFIG = os.path.join(CONFIG_DIR, "gaussian_splatting_background.yaml")
MV_DIR = os.path.join(RUN_DIR, "mvdream-random")
LIT_STEPS = 10
# the lit runs' ambient-only warm-up: half their steps (the YAMLs' 2000 and
# 3000 would keep all 10 steps on the albedo)
AMBIENT_ONLY_STEPS = 5
# K5's shapes on the main path (SD 2.1-base at 512^2, CFG batch 8: 5 heads of
# 4096 tokens, 10 of 1024) and its launches at each per UNet call
K5_SHAPES = ((40, 4096, 64), (80, 1024, 64))
K5_PER_SHAPE_PER_UNET_CALL = 5
# MVDream at 256^2, CFG batch 8 = 2 halves x 4 views, the views of a half
# folded into one sequence: 2 x 5 heads of 4 x 32^2 tokens and 2 x 10 of
# 4 x 16^2, in f32 (K5's split-bf16 kernel)
K5_MV_SHAPES = ((10, 4096, 64), (20, 1024, 64))
# Stable Zero123 at its 256^2 conditioning size, CFG batch 8 = 2 x 4 views:
# 8 heads of 32^2 tokens at d = 40 (320 / 8) at level 0; levels 1-3 have
# 256, 64 and 16 tokens and take the einsum
K5_Z123_SHAPES = ((64, 1024, 40),)
ZERO123_CONFIG = os.path.join(CONFIG_DIR, "gaussian_splatting_zero123.yaml")
ZERO123_DIR = os.path.join(RUN_DIR, "zero123-random")
ZERO123_CALLS = 10
ZERO123_STEPS = 10
WARM_STEPS = 2
# video-to-4D: gs4d_motion at its YAML's widths, 10 frames, 20 random views
# a step at 256^2, so the temporal Zero123's CFG batch is 40: 40 x 8 heads of
# 32^2 tokens at d = 40 at level 0
GS4D_MOTION_CONFIG = os.path.join(CONFIG_DIR, "gs4d_motion.yaml")
GS4D_CONFIG = os.path.join(CONFIG_DIR, "gs4d.yaml")
GS4D_STATIC_CONFIG = os.path.join(CONFIG_DIR, "gs4d_static.yaml")
GS4D_STEPS = 10
GS4D_SHORT_STEPS = 4
K5_GS4D_SHAPES = ((320, 1024, 40),)
K5_GS4D_CHECKS = ((320, 1024, 40, "bfloat16", False), (320, 1024, 40, "bfloat16", True))
# SuGaR static: the gaussian stage's 10 steps with its handoff prune at step
# 8; the sugar stage's 10 at 512^2, B = 4, then 2 more from its checkpoint
SUGAR_GAUSS_CONFIG = os.path.join(CONFIG_DIR, "gs_to_sugar.yaml")
SUGAR_REFINE_CONFIG = os.path.join(CONFIG_DIR, "sugar_static_refine.yaml")
SUGAR_STEPS = 10
SUGAR_PRUNE_AT = 8
# the YAML's 0.5 would prune every row of a 10-step field (initial opacity
# 0.05): a threshold its trained opacities straddle
SUGAR_PRUNE_THRESHOLD = 0.06
# the mesh-bound field at 512^2 makes several million pairs a view, past the
# renderers' default ceiling of 2^21 (where the JAX package, with the same
# ceiling, drops the deepest): the sugar stage renders under 2^24
SUGAR_MAX_PAIRS = 2**24
# dynamic SuGaR: sugar_dynamic_dg_zero123.yaml at its widths (32 frames, 8
# reference views at 512^2, 2 x 8 random views at 256^2, so the temporal
# Zero123's CFG batch is 32: 32 x 8 heads of 32^2 tokens at d = 40) on the
# refined SuGaR mesh, then sugar_dynamic.yaml (discrete, spline),
# sugar_drag.yaml (1 frame, no spline; CFG batch 2 x 1: 16 heads) and
# sugar_dynamic_dg.yaml for a few steps each
SUGAR_DYN_CONFIG = os.path.join(CONFIG_DIR, "sugar_dynamic_dg_zero123.yaml")
SUGAR_DYN_STEPS = 10
SUGAR_DYN_SHORT_STEPS = 3
K5_SUGAR_DYN_SHAPES = ((256, 1024, 40),)
K5_SUGAR_DRAG_SHAPES = ((16, 1024, 40),)
K5_SUGAR_DYN_CHECKS = ((256, 1024, 40, "bfloat16", False), (256, 1024, 40, "bfloat16", True),
                       (16, 1024, 40, "bfloat16", False), (16, 1024, 40, "bfloat16", True))
# K5 past 64 columns: two to four 64-column boxes in bf16, two or three in
# f32 (the last box zero-filled past d), on standard normal inputs, a
# ragged n and, at Stable Zero123's level 1 (d = 80), keys in rising norm
K5_WIDE_CHECKS = (tuple((64, 1024, d, "bfloat16", False) for d in (72, 80, 128, 160, 256))
                  + tuple((16, 1024, d, "float32", False) for d in (72, 80, 128, 160))
                  + ((64, 1000, 80, "bfloat16", False), (64, 1024, 80, "bfloat16", True),
                     (64, 4096, 40, "bfloat16", False)))
# timed beside SDPA: level 1 at a 512^2 conditioning image and level 2's
# head dim at the same length (no shipped config routes it: 256 tokens there)
K5_WIDE_SHAPES = ((64, 1024, 80), (64, 1024, 160))
# Stable Zero123 at cond_image_size = 512, CFG batch 8: level 0 has 64^2
# tokens at d = 40, level 1 32^2 at d = 80 (640 / 8); level 2's 256 tokens
# take the einsum
K5_Z512_SHAPES = ((64, 4096, 40), (64, 1024, 80))
ZERO123_512_CALLS = 3
# the denoiser's output through K5 against the same call through the plain
# twin, relative L2: every activation of both runs is rounded to bf16
# (relative step 2^-8), and K5's output is within two bf16 ulps of the
# plain twin's
Z512_DENOISER_REL = 2e-2
# gaussian_splatting_mvdream.yaml with pred_normal: the field's normal
# blended as 3 extra channels (K1/K2 at C = 7), the predicted-normal loss
PRED_NORMAL_STEPS = 3
PRED_NORMAL = ["system.geometry.pred_normal=true", "system.loss.lambda_pred_normal=1.0"]
# the bake's id-pass on the card against the CPU at one view of this size
BAKE_CPU_SIZE = 256
# the synthetic tokenizer's merges come from these lines
TOKENIZER_CORPUS = (
    "a hamburger, a DSLR photo of a delicious hamburger on a wooden plate. a zoomed out "
    "photo of a pineapple wearing sunglasses; a cat's hat, front view, side view, back view, "
    "overhead view. an astronaut riding a horse on the moon, highly detailed 3d render, "
    "8k, trending on artstation; a small saguaro cactus planted in a clay pot. "
    "a beautiful rainbow fish swimming in a coral reef, studio lighting, ultra realistic; "
    "a blue poison-dart frog sitting on a water lily, macro photography, shallow depth of "
    "field. a ripe strawberry with green leaves, isolated on a white background; an "
    "intricate wooden carving of a squirrel reading a book, cinematic composition. a "
    "majestic eagle perched on a snowy mountain peak at sunrise, golden hour, volumetric "
    "fog; a tiger dressed as a doctor, digital painting, sharp focus, vibrant colors. a "
    "stack of pancakes covered in maple syrup and fresh blueberries, food photography; a "
    "vintage red bicycle leaning against a brick wall, overcast weather, soft shadows."
)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 (non-tensor) and
# bf16 dense tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
# the SFU's exponentials: 16 a clock per SM (CUDA C++ Programming Guide,
# arithmetic instructions, compute capability 9.0) on the card's 132 SMs,
# at its highest SM clock, which main() reads from nvidia-smi
SFU_PER_CLOCK = 16 * 132
SM_MAX_HZ = None

# floating-point operations per evaluated (pixel, pair), counted from the
# kernels' bodies in csrc/blend.cu for C blended channels and F = 6 + C
def fwd_ops_per_eval(c):
    return 18 + 2 * c


def bwd_ops_per_eval(c):
    return 45 + 3 * c + (6 + c)


TILE_REACHABLE_OPS = 40  # per big-rect pair tested in K4

KERNELS = {
    "blend_forward": dict(
        source="threestudio_3dgs_tpu_torch/csrc/blend.cu",
        replaces="threestudio_3dgs_tpu/ops/rasterizer/blend_pallas.py:296",
    ),
    "blend_backward": dict(
        source="threestudio_3dgs_tpu_torch/csrc/blend.cu",
        replaces="threestudio_3dgs_tpu/ops/rasterizer/blend_pallas.py:550",
    ),
    "segsum_monotone": dict(
        source="threestudio_3dgs_tpu_torch/csrc/segsum.cu",
        replaces="threestudio_3dgs_tpu/ops/rasterizer/segsum_pallas.py:114",
    ),
    "expand_bin": dict(
        source="threestudio_3dgs_tpu_torch/csrc/expand.cu",
        replaces="threestudio_3dgs_tpu/ops/rasterizer/expand_pallas.py:585",
    ),
    "flash_attention_forward": dict(
        source="threestudio_3dgs_tpu_torch/csrc/flash_attention.cu",
        replaces="threestudio_3dgs_tpu/ops/flash_attention.py:57",
    ),
    "expand_slots": dict(
        source="threestudio_3dgs_tpu_torch/csrc/expand.cu",
        replaces="threestudio_3dgs_tpu/ops/rasterizer/expand_pallas.py:379",
    ),
    # K7: no TPU kernel, the JAX package autodiffs the projection
    "project_fwd": dict(
        source="threestudio_3dgs_tpu_torch/csrc/project.cu",
        replaces="none",
    ),
    "project_bwd": dict(
        source="threestudio_3dgs_tpu_torch/csrc/project.cu",
        replaces="none",
    ),
}
# K5 checks (bh, n, d, dtype name, keys in rising norm): the UNet's two
# self-attention shapes in bf16 (the wgmma kernel), the first again with a
# running max that grows in every key tile, a ragged n (a partial last key
# and query tile), and in f32 (the split-bf16 kernel) one shape, MVDream's
# two and its level 0 with keys in rising norm (logits of about +-30, where
# the plain twin is itself up to 2.5e-5 from float64 on the card); limits
# from profiling.k5_tolerance.  K5_Z123_CHECKS: the same at Stable
# Zero123's d = 40 (columns 40..63 of K5's boxes zero-filled), run with the
# image-to-3D phase
K5_CHECKS = ((40, 4096, 64, "bfloat16", False), (80, 1024, 64, "bfloat16", False),
             (40, 4096, 64, "bfloat16", True), (40, 1000, 64, "bfloat16", False),
             (16, 1024, 64, "float32", False), (10, 4096, 64, "float32", False),
             (20, 1024, 64, "float32", False), (10, 4096, 64, "float32", True))
K5_Z123_CHECKS = ((64, 1024, 40, "bfloat16", False), (64, 1024, 40, "bfloat16", True),
                  (64, 1000, 40, "bfloat16", False), (16, 1024, 40, "float32", False),
                  (16, 1024, 40, "float32", True))


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def small_scene(torch, cam_mod):
    """The parity tests' kind of scene at 128^2, tile 16."""
    from threestudio_3dgs_tpu_torch.utils.profiling import lookat_c2w

    n = 3000
    rng = np.random.default_rng(1)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.32
    scales = np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.5 - 3.0)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, size=(n,)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    cam = cam_mod.camera_from_c2w(lookat_c2w([0.0, -2.5, 0.3]), 0.9, 0.9, 128, 128)
    dev = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    return dict(means=dev(means), scales=dev(scales), quats=dev(quats),
                opac=dev(opac), colors=dev(colors), cam=cam, alive=None, tile_size=16)


def count_evals(torch, inp):
    """(pixel, pair) evaluations the blend kernels make on these inputs, per
    pixel, (T, ts^2): a pixel evaluates each pair of its tile until its
    transmittance before the pair falls below 1e-4 (the plain version's
    chunk walk)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import blend

    gx, gy, ts, _ = inp["dims"]
    px, py = blend._tile_pixel_coords(gx * gy, gx, ts, inp["pair_feats"].device,
                                      inp.get("view_grid_y", 0))
    walk = blend._ChunkWalk(inp["pair_feats"], inp["bins"].tile_ranges, gx * gy, ts * ts)
    evals = torch.zeros((gx * gy, ts * ts), dtype=torch.int64, device=px.device)
    with torch.no_grad():
        while bool(walk.active.any()):
            _, pmask, f = walk.step()
            alpha, _, _, _, _ = blend._chunk_alpha(f, px, py, pmask)
            _, cum_incl, _, cum_excl, _ = blend._weights(alpha, walk.raw)
            evals += ((cum_excl >= blend.T_EPS) & pmask[..., None]).sum(dim=1)
            walk.advance(cum_incl[:, -1])
    return evals


def log_tile_skew(torch, inp, pix_evals, label):
    """The heaviest tile's pairs and evaluations, and the heaviest K1 and K2
    work unit's evaluations, as multiples of an even per-SM share of the
    view's (what one SM would do if the work spread evenly)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import blend

    gx, gy, ts, _ = inp["dims"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ranges = inp["bins"].tile_ranges
    pairs = ranges[1:] - ranges[:-1]
    tile_evals = pix_evals.sum(dim=1)
    total_p, total_e = int(pairs.sum()), int(tile_evals.sum())

    def share(n, total):
        return f"{n * n_sm / max(total, 1):.2f}x"

    units = []
    for name, u in (("K1", blend.FWD_UNIT), ("K2", blend.BWD_UNIT)):
        k = ts // u
        most = int(pix_evals.reshape(gx * gy, k, u, k, u).sum(dim=(2, 4)).max())
        units.append(f"heaviest {name} unit ({u}x{u}) {most} = {share(most, total_e)}")
    log(f"tile skew {label:5s}: {int((pairs > 0).sum())} of {gx * gy} tiles hold pairs; heaviest "
        f"tile {int(pairs.max())} pairs = {share(int(pairs.max()), total_p)} an even per-SM share "
        f"({total_p} / {n_sm}), {int(tile_evals.max())} evaluations = "
        f"{share(int(tile_evals.max()), total_e)} ({total_e} / {n_sm}); " + ", ".join(units))


def check_kernels(torch, inp, label):
    """Each kernel against its plain version on the same inputs.  Returns
    {kernel: max_abs_err}."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import blend, expand, segsum

    gx, gy, ts, c = inp["dims"]
    vgy = inp.get("view_grid_y", 0)  # views stacked as tile rows: the single pass
    pf, ranges = inp["pair_feats"], inp["bins"].tile_ranges
    errs = {}
    with torch.no_grad():
        # K4: integer outputs, must agree exactly
        got = inp["plan"].expand(expand.expand_bin_cuda)
        want = inp["plan"].expand(expand.expand_bin_torch)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        report(label, "expand_bin", err, 0, "exact (slot, gauss, tile, key)")
        errs["expand_bin"] = float(err)

        # K1: sequential vs chunked transmittance products round apart
        got = blend.blend_forward_cuda(pf, ranges, gx, gy, ts, c, vgy)
        want = blend.blend_forward_torch(pf, ranges, gx, gy, ts, c, vgy)
        err = float((got - want).abs().max())
        tol = 2e-4 * max(1.0, float(want.abs().max()))
        report(label, "blend_forward", err, tol, "2e-4 x max(1, max|out|)")
        errs["blend_forward"] = err

        # K2: per column, relative to the column's largest gradient
        got = blend.blend_backward_cuda(pf, ranges, inp["out"], inp["g_out"], gx, gy, ts, c, vgy)
        want = blend.blend_backward_torch(pf, ranges, inp["out"], inp["g_out"], gx, gy, ts, c,
                                          vgy)
        diff = (got - want).abs().amax(dim=0)
        scale = torch.clamp_min(want.abs().amax(dim=0), 1e-12)
        rel = float((diff / scale).max())
        report(label, "blend_backward", rel, 1e-3, "per column, max|diff| / max|plain| (relative)")
        errs["blend_backward"] = float(diff.max())

        # K3: sums in index order vs index_add_; bound by the sum of |terms|
        vals, offs, counts = inp["seg"]
        got = segsum.segsum_cuda(vals, offs, counts)
        want = segsum.segsum_torch(vals, offs, counts)
        abs_sum = segsum.segsum_torch(vals.abs(), offs, counts).amax(dim=0)
        diff = (got - want).abs().amax(dim=0)
        rel = float((diff / torch.clamp_min(abs_sum, 1e-30)).max())
        report(label, "segsum_monotone", rel, 1e-5, "per column, max|diff| / max sum|terms| (relative)")
        errs["segsum_monotone"] = float(diff.max())
    return errs


def report(label, name, err, tol, rule):
    ok = err <= tol
    log(f"check {label:5s} {name:15s} err {err:.3e}  tol {tol:.1e}  [{rule}]  {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version at the {label} scene")


def slot_inputs(inp):
    """K6's inputs from a scene's pair plan: the depth-ordered exclusive
    offsets as int32, the pair total and max_pairs (the total rounded up to
    512, the TPU kernel's program size)."""
    plan = inp["plan"]
    total = plan.n_pairs
    return plan.offsets.int().contiguous(), total, -(-total // 512) * 512


def wide_slot_inputs(torch):
    """K6's inputs at the bench scene's scale with long empty runs: 1M
    Gaussians of Poisson(1.49) pairs (seed 0), two runs of 20,000 empty
    Gaussians inside the pair range and an empty last 30%, so the blocks
    around each run span more slots than they stage."""
    counts = np.random.default_rng(0).poisson(1.49, 1_000_000)
    counts[100_000:120_000] = counts[500_000:520_000] = counts[700_000:] = 0
    total = int(counts.sum())
    offsets = torch.as_tensor(np.cumsum(counts) - counts, dtype=torch.int32, device="cuda")
    return offsets, total, -(-total // 512) * 512


def check_slots(torch, native, offsets, total, max_pairs, label):
    """K6 against its plain version, exact on p < total.  Returns (max abs
    error, launches made)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import expand

    before = native.LAUNCHES["expand_slots"]
    with torch.no_grad():
        got = expand.expand_slots_cuda(offsets, max_pairs)
        want = expand.expand_slots_torch(offsets, max_pairs)
        err = int((got[:total].long() - want[:total].long()).abs().max()) if total else 0
    report(label, "expand_slots", err, 0, f"exact on p < {total} of {max_pairs}")
    return float(err), native.LAUNCHES["expand_slots"] - before


def time_slots(torch, inp):
    """K6 at a scene's offsets: its wrapper and device times, its plain
    version's, torch.searchsorted's, and its bound (offsets read once and
    the slots written once, 4 B each; one comparison per position at the
    f32 CUDA-core rate)."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import expand
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import graph_ms, wrapper_ms

    offsets, total, max_pairs = slot_inputs(inp)
    n = offsets.shape[0]
    positions = torch.arange(max_pairs, dtype=torch.int32, device="cuda")
    b_ms = (4 * n + 4 * max_pairs) / PEAK_BYTES_PER_S * 1e3
    o_ms = max_pairs / PEAK_F32_FLOPS * 1e3
    call = lambda: expand.expand_slots_cuda(offsets, max_pairs)  # noqa: E731
    library = lambda: torch.searchsorted(offsets, positions, right=True) - 1  # noqa: E731
    with torch.no_grad():
        row = dict(
            ms=wrapper_ms(call, 20),
            device_ms=graph_ms(call, 20),
            plain_ms=wrapper_ms(lambda: expand.expand_slots_torch(offsets, max_pairs), 5),
            library_ms=wrapper_ms(library, 20),
            library_device_ms=graph_ms(library, 20),
            bound=(max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"),
        )
    log_time("expand_slots", row, "torch.searchsorted",
             f"[{n} offsets, {total} pairs, max_pairs {max_pairs}]")
    return row


def log_time(name, r, library_name, note=""):
    log(f"time  {name:15s} wrapper {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms  plain "
        f"{r['plain_ms']:.4f} ms  bound {r['bound'][0]:.4f} ms ({r['bound'][1]})  library"
        + (" n/a" if r["library_ms"] is None else
           f" ({library_name}) wrapper {r['library_ms']:.4f} ms, device "
           f"{r['library_device_ms']:.4f} ms") + (f"  {note}" if note else ""))


def time_kernels(torch, inp, label):
    """Per kernel: its wrapper and device times, its plain version's time,
    a library call's wrapper and device times where one computes the same
    function, and its bound from the bytes it must move and the operations
    these inputs need; the tile skew and K4's and K3's input shapes first."""
    from threestudio_3dgs_tpu_torch.ops import native
    from threestudio_3dgs_tpu_torch.ops.rasterizer import blend, expand, segsum
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import (
        kernel_calls, time_call, wrapper_ms)

    gx, gy, ts, c = inp["dims"]
    vgy = inp.get("view_grid_y", 0)
    pf, ranges = inp["pair_feats"], inp["bins"].tile_ranges
    out, g_out = inp["out"], inp["g_out"]
    vals, offs, counts = inp["seg"]
    f_seg = vals.shape[1]
    plan = inp["plan"]
    p = pf.shape[0]
    n = plan.offsets.shape[0]
    t = gx * gy
    out_bytes = out.numel() * 4
    pix_evals = count_evals(torch, inp)
    log_tile_skew(torch, inp, pix_evals, label)
    evals = int(pix_evals.sum())
    live = plan.kept > 0
    big_rect = (plan.rect[:, 3] == expand.MASK_NONE)[plan.depth_order]
    n_live, n_live_big = int(live.sum()), int((live & big_rect).sum())
    big_rect_pairs = int(plan.kept[big_rect].sum())
    # K4 reads each live slot's offset and Gaussian id (8 B each) and that
    # Gaussian's (x0, y0, w, mask) row (16 B), a big rect its 6 cull fields
    # (24 B); each pair writes 20 B.  The count before the pair-parallel
    # design also charged 8 B of count to every slot of the capacity.
    k4_bytes = n_live * 32 + n_live_big * 24 + p * 20
    k4_old_bytes = n * 8 + k4_bytes
    log(f"K4 inputs {label}: {n_live} live slots of {n}, {p} pairs, at most "
        f"{int(plan.kept.max())} pairs a Gaussian, {n_live_big} rects without a mask "
        f"({big_rect_pairs} pairs); bound bytes {k4_bytes} (old count {k4_old_bytes})")
    # K3 reads every row once and writes every segment's sum; of the
    # offsets and counts it needs those of the live segments (16 B each)
    # and, per block of segments, the first offset and the last offset
    # and count (24 B), which show a block of the dead capacity empty.  The
    # count before this also charged 8 B of count to every segment.
    n_seg, n_seg_live = counts.shape[0], int((counts > 0).sum())
    seg_blocks = -(-n_seg // native.library("segsum").segsum_block_segments(f_seg))
    k3_io = vals.numel() * 4 + n_seg * f_seg * 4
    k3_bytes = k3_io + n_seg_live * 16 + seg_blocks * 24
    k3_old_bytes = k3_io + n_seg * 8 + n_seg_live * 8
    log(f"K3 inputs {label}: {n_seg_live} live segments of {n_seg} ({seg_blocks} blocks), "
        f"{vals.shape[0]} rows of {f_seg}; bound bytes {k3_bytes} (old count {k3_old_bytes})")

    def bound(nbytes, ops):
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        o_ms = ops / PEAK_F32_FLOPS * 1e3
        return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")

    plain = {
        "blend_forward": (lambda: blend.blend_forward_torch(pf, ranges, gx, gy, ts, c, vgy), 2),
        "blend_backward": (
            lambda: blend.blend_backward_torch(pf, ranges, out, g_out, gx, gy, ts, c, vgy), 2),
        "segsum_monotone": (lambda: segsum.segsum_torch(vals, offs, counts), 5),
        "expand_bin": (lambda: plan.expand(expand.expand_bin_torch), 5),
    }
    bounds = {
        "blend_forward": bound(pf.numel() * 4 + ranges.numel() * 8 + out_bytes,
                               evals * fwd_ops_per_eval(c)),
        "blend_backward": bound(2 * pf.numel() * 4 + ranges.numel() * 8 + 2 * out_bytes,
                                evals * bwd_ops_per_eval(c)),
        "segsum_monotone": bound(k3_bytes, vals.numel()),
        "expand_bin": bound(k4_bytes, big_rect_pairs * TILE_REACHABLE_OPS),
    }
    libraries = {"segsum_monotone": "torch.segment_reduce"}
    rows = {}
    with torch.no_grad():
        for name, (call, library) in kernel_calls(inp).items():
            plain_fn, plain_iters = plain[name]
            rows[name] = dict(
                time_call(call, 20),
                **(time_call(library, 20, "library_") if library is not None else
                   dict(library_ms=None, library_device_ms=None)),
                plain_ms=wrapper_ms(plain_fn, plain_iters),
                bound=bounds[name],
            )
    log(f"timing inputs: {p} pairs, {t} tiles of {ts}x{ts}, {evals} (pixel, pair) evaluations")
    for name, r in rows.items():
        log_time(name, r, libraries.get(name, ""))
    return rows


def check_project(torch, native):
    """K7 against its plain twins at the cells' shapes
    (``profiling.PROJECT_SHAPES``: gs4d, sd, mv), with a means2d offset:
    the integer outputs, counts and sort keys bit for bit, the floats within
    1e-6 of each column's largest, the gradients within 1e-5 of each one's
    largest, exactly zero on the dead rows and finite; one launch each way.
    Returns {case: {kernel: error}}."""
    from threestudio_3dgs_tpu_torch.utils.profiling import PROJECT_SHAPES, project_vs_twin

    errs = {}
    for case, (rows, live, b, size) in PROJECT_SHAPES.items():
        label = f"k7_{case}"
        native.reset_launches()
        got = project_vs_twin("cuda", case, seed=rows + b)
        report(label, "project_fwd", got["exact"], 0,
               "integers, counts, sort keys: elements that differ")
        report(label, "project_fwd", got["floats"], 1e-6,
               "per column, max|diff| / max|plain| (relative)")
        report(label, "project_bwd", got["grads"], 1e-5, "max|diff| / max|plain| (relative)")
        report(label, "project_bwd", got["dead"] + got["nonfinite"], 0,
               "nonzero gradients of dead rows + non-finite gradients")
        launches = {k: native.LAUNCHES[k] for k in ("project_fwd", "project_bwd")}
        if launches != {"project_fwd": 1, "project_bwd": 1}:
            fail(f"{label}: K7 launches {launches}, want one each way")
        log(f"K7 {case}: {rows} rows, {live} alive, {b} x {size}^2: {got['visible']} visible, "
            f"{got['masked']} with a mask, {got['pairs']} pairs")
        errs[case] = {"project_fwd": got["floats"], "project_bwd": got["grads"]}
    return errs


def time_project():
    """K7's wrapper and device times at the cells' shapes, beside the plain
    twin's and the bound by bytes (``kernel_timing.project_rows``).
    Returns {case: {kernel: timing row}}."""
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import project_rows

    rows = {}
    for tag, r in project_rows(20).items():
        kernel, case = tag.split("@")
        rows.setdefault(case, {})[kernel] = dict(
            ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
            bound=(r["bound_ms"], "bytes"), library_ms=None, library_device_ms=None)
        log_time(tag, rows[case][kernel], "")
    return rows


def bench_render(torch, scene, native):
    """Forward+backward rasterize of the scene, as bench.py measures it."""
    from threestudio_3dgs_tpu_torch.utils.profiling import render_step

    step = render_step(scene)
    out, grads = step()
    torch.cuda.synchronize()
    if out["n_dropped"] != 0:
        fail(f"bench render dropped {out['n_dropped']} pairs")
    for g in grads:
        if not bool(torch.isfinite(g).all()):
            fail("bench render gradients are not finite")
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    native.reset_launches()
    step()
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    med = statistics.median(times)
    log(f"bench render fwd+bwd: 1M Gaussians 512^2 tile 32: median {med:.3f} ms over 10 "
        f"(min {min(times):.3f}, max {max(times):.3f}), {out['n_pairs']} pairs, 0 dropped, "
        f"{512 * 512 / med * 1e3:.1f} px/s; launches per render {launches}")


def train(torch, native):
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.utils.profiling import PROJECT_KERNELS, RASTER_KERNELS

    argv = [
        "--config", PORT_CONFIG, "--train",
        "trainer.max_steps=20", "trainer.val_check_interval=0",
        "system.guidance_type=fake-sds-guidance",
        f"exp_root_dir={RUN_DIR}",
    ]
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    rows = trainer.metrics_log
    if len(rows) != 20:
        fail(f"expected 20 logged steps, got {len(rows)}")
    single, stacked = split_launches(native, launches, "train", 20)
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        if bad:
            fail(f"non-finite losses at step {row['step']}: {bad}")
    missing = [k for k in RASTER_KERNELS + PROJECT_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched by the training run: {missing}")
    gauss = trainer.state.gauss
    for k, v in gauss.params.as_dict().items():
        if not bool(torch.isfinite(v).all()):
            fail(f"trained parameter {k} is not finite")
    cfg = trainer.cfg
    log(f"train: 20 steps of gaussian_splatting.yaml at {cfg.data['height']}x{cfg.data['width']}, "
        f"batch {cfg.data['batch_size']}, capacity {gauss.capacity}, {gauss.n_alive} alive: "
        f"{wall:.2f} s wall incl. setup; last step loss_total {rows[-1]['train/loss_total']:.6g}, "
        f"n_pairs_max {rows[-1]['n_pairs_max']:.0f}; launches {single} view by view, "
        f"{stacked} on the stacked grid")
    return trainer, single, stacked


def trained_scene(torch, trainer):
    """One view of the trained field, as the training step renders it."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.ops import camera as cam_mod
    from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import sh_colors

    gauss = trainer.state.gauss
    batch = trainer.data.train_batch(0)
    fovy = float(batch["fovy"][0])
    cam = cam_mod.camera_from_c2w(batch["c2w"][0], fovy, fovy, int(batch["height"]),
                                  int(batch["width"]))
    p = gauss.params
    with torch.no_grad():
        colors = sh_colors(p.xyz, gf.get_features(p), cam.campos, 0)
        return dict(means=p.xyz, scales=gf.get_scaling(p), quats=p.rotation,
                    opac=gf.get_opacity(p)[:, 0], colors=colors, cam=cam,
                    alive=gauss.alive, tile_size=trainer.system.renderer.cfg.tile_size)


def read_png(path):
    from threestudio_3dgs_tpu_torch.utils.saving import decode_png

    with open(path, "rb") as f:
        return decode_png(f.read())


def time_structural(torch, gauss):
    """Each structural op on the full run's final field (CUDA events, warm:
    a run's first call of an op also loads its kernels), with the run's
    settings: every alive row densifies (threshold 0), prune at 0.005."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import wrapper_ms

    gen = torch.Generator(device="cuda").manual_seed(0)
    ops = {
        "densify": lambda: gf.densify_op(gauss, 0.0, 0.02, generator=gen),
        "prune": lambda: gf.prune_op(gauss, 0.005),
        "opacity reset": lambda: gf.reset_opacity_op(gauss),
        "cap-prune": lambda: gf.cap_prune_op(gauss, FULL_MAX_NUM // 2, generator=gen),
    }
    times = {name: wrapper_ms(fn, 5) for name, fn in ops.items()}
    log(f"structural ops at {gauss.n_alive} alive of {gauss.capacity}: "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in times.items()))


def full_run(torch, native):
    """The YAML's whole run, its structural schedule brought forward, then
    the test renders, the PLY and the export of the last checkpoint."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models import ply_io
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    common = [
        "system.guidance_type=fake-sds-guidance",
        "system.geometry.capacity=651024",
        f"exp_root_dir={os.path.join(RUN_DIR, 'full')}",
    ]
    schedule = [
        f"trainer.max_steps={FULL_STEPS}", "trainer.val_check_interval=20",
        "system.geometry.densify_from_iter=5", "system.geometry.densification_interval=10",
        "system.geometry.prune_from_iter=5", "system.geometry.prune_interval=10",
        "system.geometry.opacity_reset_interval=20",
        "system.geometry.densify_grad_threshold=0.0",
        f"system.geometry.max_num={FULL_MAX_NUM}",
    ]
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(["--config", PORT_CONFIG, "--train"] + common + schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    rows = trainer.metrics_log
    if len(rows) != FULL_STEPS:
        fail(f"full run: expected {FULL_STEPS} logged steps, got {len(rows)}")
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        if bad or row["n_dropped_pairs"] != 0:
            fail(f"full run step {row['step']}: non-finite {bad}, "
                 f"{row['n_dropped_pairs']:.0f} dropped pairs")
    # rows[i] is iteration i's step, logged before that step's update
    gauss_num = [int(row["gauss_num"]) for row in rows]
    if not gauss_num[11] > gauss_num[10]:
        fail(f"full run: gauss_num did not rise after the densify at step 10: {gauss_num}")
    if trainer.state.gauss.n_alive != FULL_MAX_NUM:
        fail(f"full run: {trainer.state.gauss.n_alive} alive at the end, want {FULL_MAX_NUM}")
    missing = [k for k in RASTER_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched by the full run: {missing}")
    save = os.path.join(trainer.save_dir, "save")
    pngs = [os.path.join(save, f"it{i}-0.png") for i in (20, 40)]
    pngs += [os.path.join(save, f"it{FULL_STEPS}-test", f"{i}.png") for i in range(120)]
    for path in pngs:
        if not os.path.exists(path) or not read_png(path).std() > 0:
            fail(f"full run: {path} is missing or flat")
    ply = ply_io.read_ply_table(os.path.join(save, "point_cloud.ply"))
    if ply["x"].shape[0] != FULL_MAX_NUM:
        fail(f"full run: point_cloud.ply has {ply['x'].shape[0]} vertices")
    steps_ms = [row["step_s"] * 1e3 for row in rows]
    around = "; ".join(
        f"step {i}: {steps_ms[i - 1]:.1f} / {steps_ms[i]:.1f} / {steps_ms[i + 1]:.1f} ms"
        for i in FULL_STRUCTURAL_STEPS)
    log(f"full run: {FULL_STEPS} steps of gaussian_splatting.yaml at "
        f"{trainer.cfg.data['height']}x{trainer.cfg.data['width']}, batch "
        f"{trainer.cfg.data['batch_size']}, then 120 test renders and the PLY: {wall:.2f} s wall "
        f"incl. setup; median step {statistics.median(steps_ms[1:]):.1f} ms (steps 2-{FULL_STEPS}); "
        f"before / at / after each structural step: {around}; gauss_num {gauss_num[0]} -> "
        f"{gauss_num[10]} -> {gauss_num[11]} -> {gauss_num[21]} -> {gauss_num[31]}; "
        f"{len(pngs)} PNGs; launches {launches}")

    time_structural(torch, trainer.state.gauss)

    ckpt = os.path.join(trainer.save_dir, "ckpts", "last.ckpt.npz")
    t0 = time.perf_counter()
    exporter = launch.main(["--config", PORT_CONFIG, "--export", "--resume", ckpt] + common)
    obj = os.path.join(exporter.save_dir, "save", "export", "model.obj")
    with open(obj) as f:
        faces = sum(line.startswith("f ") for line in f)
    if exporter.step != FULL_STEPS or faces < 1:
        fail(f"export: step {exporter.step}, {faces} faces in {obj}")
    log(f"export --resume {os.path.relpath(ckpt, ROOT)}: {faces} faces in "
        f"{os.path.relpath(obj, ROOT)}, {time.perf_counter() - t0:.2f} s")
    del trainer, exporter
    torch.cuda.empty_cache()


def batched_views(torch, trainer, step):
    """The field of ``trainer`` and the B cameras of its training batch at
    ``step``, as the single pass renders them: (scene for view_inputs,
    cameras)."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.ops import camera as cam_mod
    from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import sh_colors

    gauss = trainer.state.gauss
    batch = trainer.data.train_batch(step)
    cams = [cam_mod.camera_from_c2w(batch["c2w"][i], float(batch["fovy"][i]),
                                    float(batch["fovy"][i]), int(batch["height"]),
                                    int(batch["width"]))
            for i in range(len(batch["c2w"]))]
    p = gauss.params
    with torch.no_grad():
        colors = sh_colors(p.xyz, gf.get_features(p), cams[0].campos, 0)
        scene = dict(means=p.xyz, scales=gf.get_scaling(p), quats=p.rotation,
                     opac=gf.get_opacity(p)[:, 0], colors=colors, cam=cams[0],
                     alive=gauss.alive, tile_size=trainer.system.renderer.cfg.tile_size)
    return scene, cams


def split_launches(native, launches, label, steps):
    """(single-view launches, stacked-grid launches) of a run of ``steps``
    steps whose step 0 renders view by view and whose later steps take the
    single pass (the controller's first adaptation is at step 0): fails
    unless K1-K4 each launched on the stacked grid once a step after step
    0.  ``launches`` and the stacked tags are read together, just after
    the run."""
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    stacked = {k: native.SHAPE_LAUNCHES.get((k, "stacked"), 0) for k in RASTER_KERNELS}
    if any(stacked[k] != steps - 1 for k in RASTER_KERNELS):
        fail(f"{label}: launches on the stacked grid {stacked}, want {steps - 1} of each")
    return {k: n - stacked.get(k, 0) for k, n in launches.items()}, stacked


def stacked_inputs(torch, trainer, step, seed, extra=None):
    """K1-K4's inputs on the stacked grid of ``trainer``'s training batch
    at ``step``, as the single pass makes them (``extra``: the field's
    extra channels, as in the pred_normal view)."""
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs

    scene, cams = batched_views(torch, trainer, step)
    scene["extra"] = extra
    return view_inputs(scene, seed=seed, cameras=cams), cams


def hold_stacked(torch, inp, cams, label):
    """K1-K4 on a stacked grid held against their plain twins and timed.
    Returns (errors, timings)."""
    errs = check_kernels(torch, inp, label)
    log(f"{label} timing ({len(cams)} x {cams[0].height}x{cams[0].width} on one grid, "
        f"view_grid_y {inp['view_grid_y']}; these go in the kernels line):")
    return errs, time_kernels(torch, inp, label)


def batched_vs_loop(torch, trainer, cams):
    """rasterize_batched against the per-view rasterize on the trained
    field (its SH, its alive mask, the YAML's tile and the adaptive
    per-view capacity; the batched pool B times it): forward outputs, radii
    and visibility equal, gradients of a weighted sum of every output to
    2e-4 x max(1, max|loop gradient|) per input; fwd+bwd of both paths
    timed (median of 10, CUDA events)."""
    from threestudio_3dgs_tpu_torch.models import gaussian_field as gf
    from threestudio_3dgs_tpu_torch.ops.rasterizer import (
        RasterizeConfig, rasterize, rasterize_batched)

    gauss, renderer = trainer.state.gauss, trainer.system.renderer
    p = gauss.params
    with torch.no_grad():
        leaves = [p.xyz, gf.get_scaling(p), p.rotation, gf.get_opacity(p)[:, 0],
                  gf.get_features(p)]
    b, ts, cap = len(cams), renderer.cfg.tile_size, renderer.pair_capacity
    bg = torch.tensor([1.0, 1.0, 1.0], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    h, w = cams[0].height, cams[0].width
    weights = {k: torch.randn((b, h, w) + s, generator=gen, device="cuda")
               for k, s in (("image", (3,)), ("alpha", ()), ("depth", ()))}

    def step(batched):
        xs = [t.detach().clone().requires_grad_(True) for t in leaves]
        kw = dict(sh_coeffs=xs[4], sh_degree=trainer.system.geometry.active_sh_degree,
                  alive=gauss.alive)
        if batched:
            out = rasterize_batched(*xs[:4], cams, bg,
                                    config=RasterizeConfig(tile_size=ts, max_pairs=b * cap), **kw)
        else:
            outs = [rasterize(*xs[:4], cam, bg, config=RasterizeConfig(tile_size=ts,
                                                                        max_pairs=cap), **kw)
                    for cam in cams]
            out = {k: torch.stack([o[k] for o in outs]) for k in
                   ("image", "alpha", "depth", "radii", "visibility")}
            out["n_dropped"] = sum(o["n_dropped"] for o in outs)
        loss = sum((out[k] * wt).sum() for k, wt in weights.items())
        return out, torch.autograd.grad(loss, xs)

    results = {batched: step(batched) for batched in (True, False)}
    (out_b, g_b), (out_l, g_l) = results[True], results[False]
    if out_b["n_dropped"] or out_l["n_dropped"]:
        fail(f"batched_vs_loop: {out_b['n_dropped']} / {out_l['n_dropped']} pairs dropped")
    diffs = {k: float((out_b[k].detach().float() - out_l[k].detach().float()).abs().max())
             for k in ("image", "alpha", "depth", "radii", "visibility")}
    if any(diffs.values()):
        fail(f"batched_vs_loop: the single pass's outputs differ from the loop's: {diffs}")
    names = ("means", "scales", "quats", "opacities", "sh")
    rel = {n: float((gb - gl).abs().max()) / max(1.0, float(gl.abs().max()))
           for n, gb, gl in zip(names, g_b, g_l)}
    if max(rel.values()) > 2e-4:
        fail(f"batched_vs_loop: gradients past 2e-4 x scale: {rel}")
    times = {}
    for batched in (True, False):
        step(batched)
        ms = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(batched)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        times["batched" if batched else "loop"] = statistics.median(ms)
    log(f"batched_vs_loop at {b} x {h}x{w} ({out_b['n_pairs']} pairs, capacity {cap} a view): "
        f"forward max |diff| {diffs}; gradients max |diff| / max(1, max|loop|) "
        + ", ".join(f"{n} {v:.2e}" for n, v in rel.items())
        + f" (bound 2e-4); fwd+bwd median of 10: single pass {times['batched']:.3f} ms, "
        f"per-view loop {times['loop']:.3f} ms")
    return times


def train_batched(torch, native):
    """gaussian_splatting.yaml as written (batched and adaptive_max_pairs
    on) for BATCHED_STEPS steps through launch.main with fake SDS, every
    counter zeroed just before: the controller's one capacity line at step
    0 (2^21 -> min_pairs a view), step 0 on the per-view loop and every
    later step on the single pass (the renderer's path counts), K1-K4
    launched on the stacked grid once a step after step 0, every loss and
    parameter finite, no pair dropped; then, on the last step's field at
    the next batch's 4 cameras, K1-K4 on the stacked grid held against
    their plain twins and timed, and the single pass against the per-view
    loop.  Returns (stacked launches, errors, timings)."""
    import contextlib
    import io

    from threestudio_3dgs_tpu_torch import launch

    argv = ["--config", PORT_CONFIG, "--train", f"trainer.max_steps={BATCHED_STEPS}",
            "trainer.val_check_interval=0", "data.n_test_views=4",
            "system.guidance_type=fake-sds-guidance",
            f"exp_root_dir={os.path.join(RUN_DIR, 'batched')}"]
    native.reset_launches()
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sys.stdout.write(printed.getvalue())
    launches, stacked = split_launches(native, dict(native.LAUNCHES), "train_batched",
                                       BATCHED_STEPS)
    rows = trainer.metrics_log
    renderer = trainer.system.renderer
    paths = dict(renderer.path_counts)  # a new renderer: the run's calls only
    rcfg = renderer.cfg
    if len(rows) != BATCHED_STEPS:
        fail(f"train_batched: expected {BATCHED_STEPS} logged steps, got {len(rows)}")
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        if bad or row["n_dropped_pairs"] != 0:
            fail(f"train_batched step {row['step']}: non-finite {bad}, "
                 f"{row['n_dropped_pairs']:.0f} dropped pairs")
    for k, v in trainer.state.gauss.params.as_dict().items():
        if not bool(torch.isfinite(v).all()):
            fail(f"train_batched: trained parameter {k} is not finite")
    lines = [line for line in printed.getvalue().splitlines()
             if line.startswith("[system] pair capacity")]
    if not (rcfg.batched and rcfg.adaptive_max_pairs) or len(lines) != 1 or not lines[0].startswith(
            f"[system] pair capacity {rcfg.max_pairs} -> {rcfg.min_pairs} "):
        fail(f"train_batched: capacity lines {lines} (batched {rcfg.batched}, adaptive "
             f"{rcfg.adaptive_max_pairs}); want one, {rcfg.max_pairs} -> {rcfg.min_pairs}")
    bs = trainer.cfg.data["batch_size"]
    h, w = trainer.cfg.data["height"], trainer.cfg.data["width"]
    train_paths = {path: n for (path, training), n in paths.items() if training}
    if not renderer.use_batched(bs, h, w) or train_paths != {"loop": 1,
                                                               "batched": BATCHED_STEPS - 1}:
        fail(f"train_batched: training renders by path {train_paths}; want step 0 on the loop "
             f"and steps 1-{BATCHED_STEPS - 1} on the single pass")
    step_ms = [row["step_s"] * 1e3 for row in rows]
    log(f"train_batched: {BATCHED_STEPS} steps of gaussian_splatting.yaml as written "
        f"(batched, adaptive_max_pairs) at {h}x{w}, batch {bs}: {wall:.2f} s wall incl. setup "
        f"and 4 test renders; {lines[0]}; training renders by path {train_paths}; step 0 "
        f"(per-view loop) {step_ms[0]:.1f} ms, median of steps 2-{BATCHED_STEPS} (single "
        f"pass) {statistics.median(step_ms[1:]):.1f} ms; n_pairs_max "
        f"{[int(r['n_pairs_max']) for r in rows[::10]]} (every 10th step); launches "
        f"{launches} view by view, {stacked} on the stacked grid")

    inp, cams = stacked_inputs(torch, trainer, BATCHED_STEPS, seed=11)
    errs, timing = hold_stacked(torch, inp, cams, "stacked")
    del inp
    batched_vs_loop(torch, trainer, cams)
    del trainer
    torch.cuda.empty_cache()
    return stacked, errs, timing


DP_STEPS = 10  # the world-1 dp run and its one-process twin
DP_RANK_STEPS = 3  # the two-rank run: step 0 view by view, steps 1-2 on the stacked grid
DP_BANDS = 4  # tile-row bands of the 512^2 view
DP_PORT = ["--config", PORT_CONFIG, "--train", "trainer.val_check_interval=0",
           "data.n_test_views=2"]


def state_mismatches(torch, a, b):
    """The names of the fields where two GaussianStates differ in any bit
    (params, Adam moments and count, alive, the densify statistics)."""
    from threestudio_3dgs_tpu_torch.models.gaussian_field import STAT_FIELDS

    bad = [k for k, v in a.params.as_dict().items() if not torch.equal(v, getattr(b.params, k))]
    bad += [f"mu/{k}" for k, v in a.adam.mu.items() if not torch.equal(v, b.adam.mu[k])]
    bad += [f"nu/{k}" for k, v in a.adam.nu.items() if not torch.equal(v, b.adam.nu[k])]
    bad += [k for k in ("alive",) + STAT_FIELDS
            if not torch.equal(getattr(a, k), getattr(b, k))]
    if a.adam.count != b.adam.count:
        bad.append("adam/count")
    return bad


def state_digest(torch, gauss):
    """One sha256 of every params, Adam moment, alive and statistics byte."""
    import hashlib

    from threestudio_3dgs_tpu_torch.models.gaussian_field import STAT_FIELDS

    arrays = dict(gauss.params.as_dict())
    arrays.update({f"mu/{k}": v for k, v in gauss.adam.mu.items()})
    arrays.update({f"nu/{k}": v for k, v in gauss.adam.nu.items()})
    arrays.update({k: getattr(gauss, k) for k in ("alive",) + STAT_FIELDS})
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(arrays[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def time_grad_mean(torch, gauss, group, label):
    """``chunked_pmean`` over tensors shaped like one dp step's field
    gradients (CUDA events around 20 calls, after a warm-up): its ms and
    the bytes it reduces.  Returns (ms, bytes)."""
    from threestudio_3dgs_tpu_torch.parallel.data_parallel import chunked_pmean
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import wrapper_ms

    grads = {k: torch.ones_like(v) for k, v in gauss.params.as_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in grads.values())
    ms = wrapper_ms(lambda: chunked_pmean(grads, group), 20)
    log(f"{label}: chunked_pmean of the field's gradients ({nbytes} bytes, "
        f"{len(grads)} leaves): {ms:.4f} ms a step")
    return ms, nbytes


def band_scene(torch, scene):
    """The scene's alive rows as leaves that take gradients, for renders
    without the capacity mask (the tile renderer's five inputs)."""
    alive = scene["alive"]
    return [scene[k][alive].detach().clone().requires_grad_(True)
            for k in ("means", "scales", "quats", "opac", "colors")]


def band_vs_full(torch, native, scene):
    """(b): the view rendered whole and as DP_BANDS bands of tile rows
    through ``rasterize(tile_band=...)``, each with the gradients of
    sum(image^2) + 0.2 sum(alpha): the stitched bands equal the full render
    (image / alpha 1e-5, depth 1e-4, radii and the bands' union of
    visibility exactly) and the bands' summed gradients the full render's
    (1e-3 of the norm).  Returns the bands' launches."""
    from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    cam, ts = scene["cam"], scene["tile_size"]
    rows = cam.height // ts // DP_BANDS
    bg = torch.tensor([1.0, 1.0, 1.0], device="cuda")
    results = {}
    for name, bands in (("full", [None]), ("bands", [(b * rows, rows) for b in range(DP_BANDS)])):
        leaves = band_scene(torch, scene)
        native.reset_launches()
        outs = [rasterize(*leaves[:4], cam, bg, colors=leaves[4], config=RasterizeConfig(
            tile_size=ts), tile_band=band) for band in bands]
        loss = sum(torch.sum(o["image"] ** 2) + 0.2 * torch.sum(o["alpha"]) for o in outs)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out = {k: torch.cat([o[k] for o in outs]).detach() for k in ("image", "alpha", "depth")}
        out.update(radii=outs[0]["radii"], dropped=sum(o["n_dropped"] for o in outs),
                   visibility=torch.stack([o["visibility"] for o in outs]).any(dim=0))
        results[name] = (out, grads, dict(native.LAUNCHES))
    (full, g_full, _), (band, g_band, launches) = results["full"], results["bands"]
    errs = {k: float((band[k] - full[k]).abs().max()) for k in ("image", "alpha", "depth")}
    rel = [float(torch.linalg.norm(a - b)) / float(torch.linalg.norm(b))
           for a, b in zip(g_band, g_full)]
    if (errs["image"] > 1e-5 or errs["alpha"] > 1e-5 or errs["depth"] > 1e-4 or max(rel) > 1e-3
            or not torch.equal(band["radii"], full["radii"])
            or not torch.equal(band["visibility"], full["visibility"])
            or full["dropped"] or band["dropped"]):
        fail(f"tile bands vs the full render: max |diff| {errs}, gradients {rel}, radii equal "
             f"{torch.equal(band['radii'], full['radii'])}, visibility equal "
             f"{torch.equal(band['visibility'], full['visibility'])}, dropped "
             f"{full['dropped']} / {band['dropped']}")
    if any(launches[k] != DP_BANDS for k in RASTER_KERNELS):
        fail(f"tile bands: launches {launches}, want {DP_BANDS} of each of {RASTER_KERNELS}")
    log(f"tile bands: {DP_BANDS} bands of {rows} tile rows ({cam.width}x{rows * ts} each) of "
        f"the {cam.height}x{cam.width} view equal the full render: max |diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + ", radii and visibility equal; summed gradients vs full (norm-relative) "
        + ", ".join(f"{v:.2e}" for v in rel) + f"; launches {launches}")
    return launches


def dp_rank(rank, world, init_file, out_dir, argv):
    """(c): one rank of the two-rank run: ``launch.main`` (the trainer
    shards the camera batch over the group), then the tile renderer over
    the group on the trained field's view against the full render, and the
    gradient mean timed.  Pickles its results to ``out_dir``."""
    import pickle

    import torch
    import torch.distributed as dist

    n_dev = torch.cuda.device_count()
    dev = rank if n_dev >= world else 0
    torch.cuda.set_device(dev)
    # NCCL refuses two ranks on one card: gloo (its CUDA collectives) there
    backend = "nccl" if n_dev >= world else "gloo"
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank)
    try:
        from threestudio_3dgs_tpu_torch import launch
        from threestudio_3dgs_tpu_torch.ops import native
        from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
        from threestudio_3dgs_tpu_torch.parallel.tile_parallel import (
            gather_bands, make_tile_parallel_rasterize)
        from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

        native.reset_launches()
        t0 = time.perf_counter()
        trainer = launch.main(argv + ["--device", f"cuda:{dev}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = dict(backend=backend, device=dev, wall=wall, launches=dict(native.LAUNCHES),
                   stacked={k: native.SHAPE_LAUNCHES.get((k, "stacked"), 0)
                            for k in RASTER_KERNELS},
                   paths={p: n for (p, training), n in trainer.system.renderer.path_counts.items()
                          if training},
                   dp_steps=sorted(trainer.system._dp_steps),
                   losses=[row["train/loss_total"] for row in trainer.metrics_log],
                   step_ms=[row["step_s"] * 1e3 for row in trainer.metrics_log],
                   digest=state_digest(torch, trainer.state.gauss))

        scene = trained_scene(torch, trainer)
        ts = scene["tile_size"]
        bg = torch.tensor([1.0, 1.0, 1.0], device="cuda")
        cfg = RasterizeConfig(tile_size=ts)
        leaves = band_scene(torch, scene)
        f = make_tile_parallel_rasterize(dist.group.WORLD, scene["cam"], bg, config=cfg)
        out = f(*leaves)
        whole = gather_bands(out, dist.group.WORLD)
        g_band = torch.autograd.grad(torch.sum(out["image"] ** 2) + torch.sum(out["alpha"]),
                                     leaves)
        leaves_full = band_scene(torch, scene)
        full = rasterize(*leaves_full[:4], scene["cam"], bg, colors=leaves_full[4], config=cfg)
        g_full = torch.autograd.grad(torch.sum(full["image"] ** 2) + torch.sum(full["alpha"]),
                                     leaves_full)
        res["tile"] = dict(
            band_shape=tuple(out["image"].shape),
            errs={k: float((whole[k] - full[k].detach()).abs().max())
                  for k in ("image", "alpha", "depth")},
            radii_equal=bool(torch.equal(out["radii"], full["radii"])),
            visibility_equal=bool(torch.equal(out["visibility"], full["visibility"])),
            grad_rel=[float(torch.linalg.norm(a - b)) / float(torch.linalg.norm(b))
                      for a, b in zip(g_band, g_full)],
            dropped=out["n_dropped"])
        res["grad_mean_ms"], res["grad_mean_bytes"] = time_grad_mean(
            torch, trainer.state.gauss, dist.group.WORLD,
            f"rank {rank} ({backend}, {world} ranks)")
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)


def two_ranks(torch, run_dir, argv, world=2):
    """(c) in ``world`` spawned processes (not forked: this process holds
    CUDA), rendezvousing through a file; their results by rank."""
    import pickle

    import torch.multiprocessing as mp

    os.makedirs(run_dir, exist_ok=True)
    init_file = os.path.join(run_dir, "rendezvous")
    if os.path.exists(init_file):
        os.remove(init_file)
    mp.start_processes(dp_rank, args=(world, init_file, run_dir, argv), nprocs=world,
                       join=True, start_method="spawn")
    results = []
    for r in range(world):
        with open(os.path.join(run_dir, f"rank{r}.pkl"), "rb") as fh:
            results.append(pickle.load(fh))
    return results


def train_dp(torch, native):
    """The multi-device slice on the card: (a) ``gaussian_splatting.yaml``
    as written for DP_STEPS steps (fake SDS) with ``trainer.devices=0`` and
    with ``trainer.devices=1`` (the dp step on a one-rank NCCL group),
    states equal bit for bit; (b) the trained field's 512^2 view as
    DP_BANDS tile-row bands against the full render; (c) two ranks spawned
    on the card (both on cuda:0 over gloo's CUDA collectives, or one a
    card over NCCL where there are two), DP_RANK_STEPS steps of the YAML at
    2 x 2 views with fake-mse: bit-equal states, the first loss equal to
    the one-process run's to 2e-4 relative, each rank's steps 1+ on its
    stacked grid, and the two-rank tile renderer against the full render.
    Returns the rows' inputs: (stacked launches of rank 0, band launches,
    band errors and timing, dp_shard errors and timing)."""
    import torch.distributed as dist

    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.parallel.mesh import initialize_distributed
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    t_phase = time.perf_counter()
    fake = ["system.guidance_type=fake-sds-guidance", f"trainer.max_steps={DP_STEPS}"]
    runs, walls = {}, {}
    for devices in (0, 1):
        t0 = time.perf_counter()
        runs[devices] = launch.main(DP_PORT + fake + [
            f"trainer.devices={devices}", f"exp_root_dir={os.path.join(RUN_DIR, f'dp{devices}')}"])
        torch.cuda.synchronize()
        walls[devices] = time.perf_counter() - t0
    plain, dp = runs[0], runs[1]
    bad = state_mismatches(torch, plain.state.gauss, dp.state.gauss)
    losses = [[row["train/loss_total"] for row in tr.metrics_log] for tr in (plain, dp)]
    if (bad or losses[0] != losses[1] or sorted(dp.system._dp_steps) != [("dp", 1, 4)]
            or plain.system._dp_steps or dist.is_initialized()):
        fail(f"train_dp (a): fields differ in {bad}; losses {losses}; dp steps "
             f"{sorted(dp.system._dp_steps)} / {sorted(plain.system._dp_steps)}; group left "
             f"{dist.is_initialized()}")
    step_ms = {d: statistics.median(row["step_s"] * 1e3 for row in tr.metrics_log[1:])
               for d, tr in runs.items()}
    log(f"train_dp (a): {DP_STEPS} steps of gaussian_splatting.yaml (fake SDS, 4 x 512^2): "
        f"trainer.devices=1 (the dp step on a one-rank NCCL group) equals devices=0 bit for bit "
        f"(params, Adam moments, statistics; losses {losses[0][0]:.6g} .. {losses[0][-1]:.6g}); "
        f"median step (steps 2-{DP_STEPS}) {step_ms[1]:.1f} ms dp vs {step_ms[0]:.1f} ms plain; "
        f"wall {walls[1]:.2f} / {walls[0]:.2f} s incl. setup and 2 test renders")
    initialize_distributed("nccl", world_size=1, rank=0, force=True)
    try:
        ms1, nbytes = time_grad_mean(torch, dp.state.gauss, dist.group.WORLD,
                                     "train_dp (a) one rank (nccl)")
    finally:
        dist.destroy_process_group()

    # (b) the tile bands of the trained view, and K1-K4 on one band and on
    # a rank's 2-view stacked grid (held against their plain twins, timed)
    scene = trained_scene(torch, plain)
    band_launches = band_vs_full(torch, native, scene)
    rows = scene["cam"].height // scene["tile_size"] // DP_BANDS
    band_inp = view_inputs(scene, seed=16, tile_band=(rows, rows))
    band_errs = check_kernels(torch, band_inp, "band")
    log(f"band timing (band 1 of {DP_BANDS}: {scene['cam'].width}x{rows * scene['tile_size']}; "
        f"these go in the kernels line):")
    band_timing = time_kernels(torch, band_inp, "band")
    shard_scene, cams = batched_views(torch, plain, DP_STEPS)
    shard_inp = view_inputs(shard_scene, seed=17, cameras=cams[:2])
    shard_errs, shard_timing = hold_stacked(torch, shard_inp, cams[:2], "dp_shard")
    del band_inp, shard_inp, runs, plain, dp
    torch.cuda.empty_cache()

    # (c) two ranks; the one-process run's first loss with fake-mse first
    mse = ["system.guidance_type=fake-mse-guidance"]
    one = launch.main(DP_PORT + mse + ["trainer.max_steps=1",
                                       f"exp_root_dir={os.path.join(RUN_DIR, 'dp_mse1')}"])
    loss_one = one.metrics_log[0]["train/loss_total"]
    del one
    torch.cuda.empty_cache()
    ranks = two_ranks(torch, os.path.join(RUN_DIR, "dp_ranks"), DP_PORT + mse + [
        f"trainer.max_steps={DP_RANK_STEPS}", f"exp_root_dir={os.path.join(RUN_DIR, 'dp2')}"])
    r0 = ranks[0]
    want_paths = {"loop": 1, "batched": DP_RANK_STEPS - 1}
    problems = []
    if any(r["digest"] != r0["digest"] or r["losses"] != r0["losses"] for r in ranks):
        problems.append("the ranks' states or losses differ")
    if not np.isclose(r0["losses"][0], loss_one, rtol=2e-4, atol=0):
        problems.append(f"first loss {r0['losses'][0]} vs one process {loss_one}")
    for r in ranks:
        if r["dp_steps"] != [("dp", 2, 4)] or r["paths"] != want_paths:
            problems.append(f"dp steps {r['dp_steps']}, paths {r['paths']}")
        if any(r["stacked"][k] != DP_RANK_STEPS - 1 for k in RASTER_KERNELS):
            problems.append(f"stacked launches {r['stacked']}")
        t = r["tile"]
        if (t["errs"]["image"] > 1e-5 or t["errs"]["alpha"] > 1e-5 or t["errs"]["depth"] > 1e-4
                or not (t["radii_equal"] and t["visibility_equal"]) or max(t["grad_rel"]) > 1e-3
                or t["dropped"]):
            problems.append(f"tile renderer {t}")
    if problems:
        fail(f"train_dp (c): {problems}")
    log(f"train_dp (c): 2 ranks ({r0['backend']}, cuda:{ranks[0]['device']} / "
        f"cuda:{ranks[1]['device']}), {DP_RANK_STEPS} steps of gaussian_splatting.yaml "
        f"(fake-mse, 2 x 2 views at 512^2): states bit-equal (sha256 {r0['digest'][:16]}), losses "
        f"{r0['losses']}, first vs one process {loss_one:.6g} (rel "
        f"{abs(r0['losses'][0] - loss_one) / abs(loss_one):.2e}); paths {r0['paths']}; stacked "
        f"launches {r0['stacked']}; median step {statistics.median(r0['step_ms'][1:]):.1f} ms; "
        f"wall {r0['wall']:.2f} s; tile renderer bands {r0['tile']['band_shape']}: max |diff| "
        + ", ".join(f"{k} {v:.2e}" for k, v in r0["tile"]["errs"].items())
        + f", gradients {max(r0['tile']['grad_rel']):.2e}; gradient mean {ms1:.4f} ms at one "
        f"rank, {r0['grad_mean_ms']:.4f} ms at two ({nbytes} bytes)")
    log(f"train_dp: {time.perf_counter() - t_phase:.1f} s")
    return r0["stacked"], band_launches, band_errs, band_timing, shard_errs, shard_timing


# the spans the --profile trace of the step must hold
PROFILE_SPANS = ("fit/train_step", "system/render", "system/guidance", "system/backward",
                 "render/project")


def profile_run(card):
    """6d: ``launch --train --profile`` in a subprocess (its own counters
    and profiler, the kernels already built); the trace's checks and its
    breakdown, with ``card`` (nvidia-smi's name and power limit)."""
    import glob
    import shutil

    from benchmark import spans
    from threestudio_3dgs_tpu_torch.utils.profiling import (
        FAMILIES, PROJECT_SYMBOLS, RASTER_SYMBOLS, TRACE_ACTIVE, TRACE_STEPS, read_trace)
    from threestudio_3dgs_tpu_torch.utils.tracing import SPANS

    run_dir = os.path.join(RUN_DIR, "profile")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = [sys.executable, "-m", "threestudio_3dgs_tpu_torch.launch", "--config", PORT_CONFIG,
            "--train", "--profile", f"trainer.max_steps={TRACE_STEPS}",
            "trainer.val_check_interval=0", "system.guidance_type=fake-sds-guidance",
            "data.n_test_views=2", f"exp_root_dir={run_dir}"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"profile: launch --train --profile exited {proc.returncode}:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    logdirs = glob.glob(os.path.join(run_dir, "*", "*", "profile"))  # <trial_dir>/profile
    if len(logdirs) != 1:
        fail(f"profile: want one <trial_dir>/profile under {run_dir}, found {logdirs}")
    trace = read_trace(logdirs[0])
    steps = trace["steps"]
    if not 0 < len(steps) <= TRACE_ACTIVE:
        fail(f"profile: the trace records profiler steps {steps}, want 1 to {TRACE_ACTIVE}")
    symbols = {**RASTER_SYMBOLS, **PROJECT_SYMBOLS}
    events = {k: sum(1 for e in trace["events"] if e.get("cat") == "kernel"
                     and sym in str(e.get("name", ""))) for k, sym in symbols.items()}
    missing = [k for k, n in events.items() if n == 0]
    if missing:
        fail(f"profile: the trace has no kernel event of {missing} "
             f"(symbols {[symbols[k] for k in missing]}); events by kernel {events}")
    reduced = spans.reduce(trace["events"], SPANS)
    names = {n for path in (reduced or {}).get("count", {}) for n in path.split(spans.SEP)}
    missing = [n for n in PROFILE_SPANS if n not in names]
    if missing:
        fail(f"profile: the trace's recorded steps hold no span {missing}; spans {sorted(names)}")
    log(f"profile: launch --train --profile, {TRACE_STEPS} steps of gaussian_splatting.yaml "
        f"(fake SDS, 4 x 512^2) + 2 test renders: exit 0 in {wall:.1f} s wall incl. start-up; "
        f"trace {os.path.relpath(trace['path'], ROOT)} ({os.path.getsize(trace['path'])} bytes, "
        f"{len(trace['events'])} events), profiler steps {steps}; K1-K4, K7 kernel events {events}")
    n = reduced["steps"]
    families = {}  # the hand kernels' device ms a step
    for name, us in trace["kernels"].items():
        fam = next((f for f, pat in FAMILIES if re.search(pat, name)), None)
        if fam:
            families[fam] = round(families.get(fam, 0.0) + us / 1e3 / n, 4)
    log(f"profile on {card}: {reduced['wall_s'] / n * 1e3:.2f} ms a traced step (host clock of "
        f"the ProfilerStep spans), device {reduced['busy_s'] / n * 1e3:.3f} ms busy "
        f"({100 * reduced['busy_s'] / reduced['wall_s']:.1f}%); hand kernels' device ms a "
        f"step {families}; by span, ms a step: path, device, host self, idle, count " + json.dumps(
            [[p] + [round(v, 4) for v in rest] for p, *rest in spans.table(reduced)]))


def write_sd_checkpoint(torch):
    """The SD 2.1-base UNet and VAE, and its text encoder with a synthetic
    tokenizer (the byte symbols, the merges learned from a few lines of
    prompts, up to 400, pad "!" as SD 2.x directories have it)."""
    from threestudio_3dgs_tpu_torch.diffusion.convert import write_random_checkpoint
    from threestudio_3dgs_tpu_torch.guidance.clip import (
        SD21_TEXT_ENCODER, write_random_text_encoder)
    from threestudio_3dgs_tpu_torch.guidance.tokenizer import write_tokenizer

    t0 = time.perf_counter()
    sizes = write_random_checkpoint(SD_DIR, seed=0, device="cuda")
    te_dir = os.path.join(SD_DIR, "text_encoder")
    sizes[os.path.join(te_dir, "pytorch_model.bin")] = write_random_text_encoder(
        te_dir, SD21_TEXT_ENCODER, seed=0, device="cuda")
    write_tokenizer(os.path.join(SD_DIR, "tokenizer"), TOKENIZER_CORPUS, 400, pad_token="!")
    total = sum(sizes.values())
    log(f"wrote SD 2.1-base random checkpoint (seed 0, f32; UNet, VAE, text encoder of 23 "
        f"layers x 1024, synthetic tokenizer) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{os.path.relpath(p, ROOT)} {n / 2**20:.1f} MiB" for p, n in sizes.items())
        + f"; {total / 2**30:.2f} GiB")


def write_mv_checkpoint(torch):
    """The published MVDream UNet (SD 2.1-base widths with the 4-view fold
    and the camera MLP) and the SD VAE, seeded random f32 weights."""
    from threestudio_3dgs_tpu_torch.diffusion import MVDREAM_UNET
    from threestudio_3dgs_tpu_torch.diffusion.convert import write_random_checkpoint

    t0 = time.perf_counter()
    sizes = write_random_checkpoint(MV_DIR, MVDREAM_UNET, seed=0, device="cuda")
    log(f"wrote MVDream random checkpoint (seed 0, f32) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{os.path.relpath(p, ROOT)} {n / 2**20:.1f} MiB" for p, n in sizes.items())
        + f"; {sum(sizes.values()) / 2**30:.2f} GiB")


def check_clip_small(torch):
    """The port's CLIP text encoder on a tiny seeded random directory
    (gelu, 2 layers of 64) on the card against the same encoding on the
    CPU: the hidden states of three prompts to 1e-4 of max(1, max|CPU|)
    (cuBLAS and the CPU sum in other orders)."""
    from threestudio_3dgs_tpu_torch.guidance import clip
    from threestudio_3dgs_tpu_torch.guidance.tokenizer import write_tokenizer

    root = os.path.join(RUN_DIR, "clip-tiny")
    write_tokenizer(os.path.join(root, "tokenizer"), TOKENIZER_CORPUS, 200, pad_token="!")
    clip.write_random_text_encoder(
        os.path.join(root, "text_encoder"),
        clip.CLIPTextConfig(vocab_size=1000, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4, hidden_act="gelu"),
        seed=0, device="cpu")
    err, scale = 0.0, 1.0
    on_card, on_cpu = clip.PromptEncoder(root, "cuda"), clip.PromptEncoder(root, "cpu")
    for prompt in ("a hamburger", "A DSLR photo of a cat's hat, front view",
                   " ".join(["delicious hamburger"] * 40)):
        card, cpu = on_card(prompt), on_cpu(prompt)
        if card.shape != (77, 64) or not np.isfinite(card).all():
            fail(f"CLIP on the card: shape {card.shape}, finite {np.isfinite(card).all()}")
        err = max(err, float(np.abs(card - cpu).max()))
        scale = max(scale, float(np.abs(cpu).max()))
    report("clip-tiny", "clip_hidden", err, 1e-4 * scale, "card vs CPU, max|diff|")


def train_lit(torch, native, name, config, extra, k5_shapes=(), steps=LIT_STEPS):
    """``steps`` steps of one of the lit YAMLs through launch.main,
    every counter zeroed just before: every logged loss finite, grad_norm
    > 0, K1-K4 launched, K5 launched 5 times a step at each of
    ``k5_shapes`` and nowhere else, K1-K4 on the stacked grid once a step
    after step 0 (``split_launches``), and the background MLP moved.
    Returns the trainer, the launches view by view and on the stacked grid,
    and K5's launches by shape."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.ops.flash_attention import shape_tag
    from threestudio_3dgs_tpu_torch.systems.base import flatten_extra
    from threestudio_3dgs_tpu_torch.utils.profiling import PROJECT_KERNELS, RASTER_KERNELS

    argv = ["--config", config, "--train", f"trainer.max_steps={steps}",
            "trainer.val_check_interval=0", "data.n_test_views=8",
            f"exp_root_dir={os.path.join(RUN_DIR, name)}"] + extra
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    single, stacked = split_launches(native, launches, name, steps)
    shape_launches = {tag: c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
                      if fn == "flash_attention_forward"}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = trainer.metrics_log
    if len(rows) != steps:
        fail(f"{name}: expected {steps} logged steps, got {len(rows)}")
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        if bad or not row["train/grad_norm"] > 0:
            fail(f"{name} step {row['step']}: non-finite {bad}, grad_norm {row['train/grad_norm']}")
    missing = [k for k in RASTER_KERNELS + PROJECT_KERNELS if launches[k] == 0]
    if missing:
        fail(f"{name}: kernels never launched: {missing}")
    want = {shape_tag(*shape): K5_PER_SHAPE_PER_UNET_CALL * steps for shape in k5_shapes}
    if shape_launches != want or launches["flash_attention_forward"] != sum(want.values()):
        fail(f"{name}: K5 launched {launches['flash_attention_forward']} times, by shape "
             f"{shape_launches}; want {want}")
    state = trainer.state
    init = trainer.system.init_state(trainer.cfg.seed).extra_params
    moved = {k: float((v - flatten_extra(init)[k]).abs().max())
             for k, v in flatten_extra(state.extra_params).items()}
    if not moved or min(moved.values()) <= 0 or state.extra_opt.count != steps:
        fail(f"{name}: the background MLP did not train: {moved}")
    step_ms = [row["step_s"] * 1e3 for row in rows[1:]]
    cfg = trainer.cfg
    log(f"{name}: {steps} steps of {os.path.basename(config)} "
        f"({cfg.system['renderer_type']}, {cfg.system['guidance_type']}) at "
        f"{trainer.data.train_sampler.height}x{trainer.data.train_sampler.width}, batch "
        f"{trainer.data.train_sampler.batch_size}: {wall:.2f} s wall incl. loading and 8 test "
        f"renders; "
        f"median step (steps 2-{steps}) {statistics.median(step_ms):.1f} ms (min "
        f"{min(step_ms):.1f}, max {max(step_ms):.1f}); peak device memory {peak:.2f} GiB; "
        f"last loss_total {rows[-1]['train/loss_total']:.6g}, grad_norm "
        f"{rows[-1]['train/grad_norm']:.6g}; background moved by up to "
        f"{max(moved.values()):.3g}; launches {single} view by view, {stacked} on the stacked "
        f"grid, K5 by shape {shape_launches}")
    return (trainer, single, stacked,
            {shape: shape_launches[shape_tag(*shape)] for shape in k5_shapes})


def check_flash(torch, checks=K5_CHECKS, seed=10):
    """K5 against its plain version at each case of ``checks`` (scale
    d^-1/2).  Returns the absolute error by (bh, n, d, dtype name) of the
    checks on standard normal inputs."""
    from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
    from threestudio_3dgs_tpu_torch.utils.profiling import k5_float64, k5_inputs, k5_tolerance

    errs = {}
    with torch.no_grad():
        for i, (bh, n, d, dtype, rising) in enumerate(checks):
            q, k, v = k5_inputs(bh, n, getattr(torch, dtype), seed=seed + i, rising=rising, d=d)
            scale = d**-0.5
            got = fa.flash_bhnd_cuda(q, k, v, scale)
            want = fa.flash_bhnd_torch(q, k, v, scale)
            err = float((got.float() - want.float()).abs().max())
            rule = "max |diff|; limit 2^-6 x max|plain|" if dtype == "bfloat16" else "max |diff|"
            if not bool(torch.isfinite(got).all()):
                fail(f"k5 {bh}x{n}x{d} {dtype}: non-finite output")
            label = f"k5 {bh}x{n}x{d} {dtype}" + (" rising max" if rising else "")
            if rising and dtype == "float32":
                # the plain twin in f32 is itself up to 2.5e-5 from the
                # float64 value here: hold K5 to that value, and to no
                # further from it than the plain twin
                exact = k5_float64(q, k, v, scale)
                plain_err = float((want.double() - exact).abs().max())
                err_f64 = float((got.double() - exact).abs().max())
                log(f"k5 {bh}x{n}x{d} f32 rising max: |K5 - plain| {err:.3e}, |K5 - float64| "
                    f"{err_f64:.3e}, |plain - float64| {plain_err:.3e}")
                report(label, "flash_attention", err_f64, min(k5_tolerance(want), plain_err),
                       "max |diff| from float64; limit min(2e-5, |plain - float64|)")
                continue
            report(label, "flash_attention", err, k5_tolerance(want), rule)
            if not rising:
                errs[(bh, n, d, dtype)] = err
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return errs


def check_sd_small(torch):
    """The SD guidance on a tiny random directory (head dim 64, so its
    1024-token self-attention goes through K5) on the card against the same
    call on the CPU, f32 weights, the same draws: the loss and its gradient
    w.r.t. rgb to 1e-4 relative (cuDNN and the CPU sum in other orders)."""
    from threestudio_3dgs_tpu_torch.utils.profiling import TINY_SD_K5_LAUNCHES, tiny_sd_card_vs_cpu

    results = tiny_sd_card_vs_cpu(os.path.join(RUN_DIR, "sd-tiny"))
    (loss_c, grad_c, k5_c), (loss_p, grad_p, _) = results["cuda"], results["cpu"]
    if k5_c != TINY_SD_K5_LAUNCHES or not bool(torch.isfinite(grad_c).all()):
        fail(f"tiny SD guidance on the card: {k5_c} K5 launches (want {TINY_SD_K5_LAUNCHES}), "
             f"finite grad {bool(torch.isfinite(grad_c).all())}")
    report("sd-tiny", "sd_loss", abs(loss_c - loss_p) / abs(loss_p), 1e-4, "card vs CPU, relative")
    report("sd-tiny", "sd_grad_rgb", float((grad_c - grad_p).norm() / grad_p.norm()), 1e-4,
           "card vs CPU, relative L2")


def time_flash(torch, shapes, dtype):
    """K5 at the main path's (bh, n, d) shapes in ``dtype``: its time, its
    plain version's, scaled_dot_product_attention's, and its bound, the
    longest of three: each input read once and the output written once at
    3.35 TB/s; the products at their peak (bf16: 4 bh n^2 d FLOPs on the
    tensor cores at 989 TFLOP/s; f32, f32-accurate attention: the faster of
    its two routes, 4 bh n^2 d FLOPs on the CUDA cores at 67 TFLOP/s or the
    split on the tensor cores, 12 bf16 products of 2 bh n^2 d FLOPs each at
    989); the exponentials, bh n^2 on the SFU at 16 a clock per SM, 132
    SMs, the card's highest SM clock (``clocks.max.sm``).  Each row's
    ``bound_term`` names the longest of the three ("bytes", "products" or
    "sfu").  Returns the rows by (bh, n, d)."""
    import torch.nn.functional as F

    from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import graph_ms, wrapper_ms
    from threestudio_3dgs_tpu_torch.utils.profiling import k5_inputs

    rows = {}
    with torch.no_grad():
        for bh, n, d in shapes:
            q, k, v = k5_inputs(bh, n, dtype, seed=20, d=d)
            scale = d**-0.5
            b_ms = 4 * q.numel() * q.element_size() / PEAK_BYTES_PER_S * 1e3
            flops = 4 * bh * n * n * d
            if dtype == torch.bfloat16:
                o_ms, route = flops / PEAK_BF16_TC_FLOPS * 1e3, ""
            else:
                core_ms = flops / PEAK_F32_FLOPS * 1e3
                split_ms = 12 * (flops / 2) / PEAK_BF16_TC_FLOPS * 1e3
                o_ms = min(core_ms, split_ms)
                route = f"; f32 routes: CUDA cores {core_ms:.4f} ms, bf16 split {split_ms:.4f} ms"
            sfu_ms = bh * n * n / (SFU_PER_CLOCK * SM_MAX_HZ) * 1e3
            terms = {"bytes": b_ms, "products": o_ms, "sfu": sfu_ms}
            term = max(terms, key=terms.get)
            call = lambda: fa.flash_bhnd_cuda(q, k, v, scale)  # noqa: E731
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q[None], k[None], v[None], scale=scale)
            rows[(bh, n, d)] = dict(
                ms=wrapper_ms(call, 10),
                device_ms=graph_ms(call, 10),
                plain_ms=wrapper_ms(lambda: fa.flash_bhnd_torch(q, k, v, scale), 3),
                library_ms=wrapper_ms(library, 20),
                library_device_ms=graph_ms(library, 20),
                bound=(terms[term], "bytes" if term == "bytes" else "operations"),
                bound_term=term,
            )
            r = rows[(bh, n, d)]
            log_time(f"flash_attention ({bh}, {n}, {d}) {str(dtype).split('.')[-1]}", r,
                     "scaled_dot_product_attention",
                     f"[by device time {4 * bh * n * n * d / r['device_ms'] / 1e9:.1f} TFLOP/s, "
                     f"{r['bound'][0] / r['device_ms']:.1%} of the bound ({term}); bytes {b_ms:.4f} ms, "
                     f"products {o_ms:.4f} ms, SFU {sfu_ms:.4f} ms{route}]")
            del q, k, v
    torch.cuda.empty_cache()
    return rows


def train_sd(torch, native):
    """SD_STEPS steps of the YAML with its own stable-diffusion-guidance on
    the random SD 2.1-base directory."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.ops.flash_attention import shape_tag
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    argv = [
        "--config", PORT_CONFIG, "--train",
        f"trainer.max_steps={SD_STEPS}", "trainer.val_check_interval=0",
        f"system.guidance.pretrained_model_name_or_path={SD_DIR}",
        f"exp_root_dir={os.path.join(RUN_DIR, 'sd')}",
    ]
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    shape_launches = {tag: c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
                      if fn == "flash_attention_forward"}
    rows = trainer.metrics_log
    if len(rows) != SD_STEPS:
        fail(f"expected {SD_STEPS} logged SD steps, got {len(rows)}")
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        if bad:
            fail(f"non-finite losses at SD step {row['step']}: {bad}")
        if not row["train/grad_norm"] > 0:
            fail(f"SD step {row['step']}: grad_norm {row['train/grad_norm']} is not > 0")
    missing = [k for k in RASTER_KERNELS if launches[k] == 0]
    if missing:
        fail(f"kernels never launched by the SD training run: {missing}")
    want = {shape_tag(*shape): K5_PER_SHAPE_PER_UNET_CALL * SD_STEPS for shape in K5_SHAPES}
    if shape_launches != want or launches["flash_attention_forward"] != sum(want.values()):
        fail(f"K5 launched {launches['flash_attention_forward']} times in {SD_STEPS} SD steps, "
             f"by shape {shape_launches}; want {want}")
    guidance = trainer.system.guidance
    if guidance.unet is None or guidance.vae_encoder is None:
        fail("the SD guidance did not load the checkpoint directory")
    walls = [row["wall_s"] for row in rows]
    steps = [b - a for a, b in zip(walls, walls[1:])]  # steps 2..SD_STEPS
    cfg = trainer.cfg
    log(f"train SD: {SD_STEPS} steps of gaussian_splatting.yaml with stable-diffusion-guidance "
        f"(SD 2.1-base random weights, bf16 UNet and VAE, CFG batch {2 * cfg.data['batch_size']}) "
        f"at {cfg.data['height']}x{cfg.data['width']}, batch {cfg.data['batch_size']}: "
        f"{wall:.2f} s wall incl. loading; median step (steps 2-{SD_STEPS}) "
        f"{statistics.median(steps) * 1e3:.1f} ms (min {min(steps) * 1e3:.1f}, max "
        f"{max(steps) * 1e3:.1f}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last loss_sds "
        f"{rows[-1]['train/loss_sds']:.6g}, grad_norm {rows[-1]['train/grad_norm']:.6g}; "
        f"launches {launches}, K5 by shape {shape_launches}")
    del trainer, guidance
    torch.cuda.empty_cache()
    return launches, {shape: shape_launches[shape_tag(*shape)] for shape in K5_SHAPES}


def check_zero123_small(torch):
    """The Zero123 guidance on a tiny random ldm .ckpt (d = 40 at 1024
    tokens, so its level-0 self-attention runs K5's f32 kernel at d = 40)
    on the card against the same calls on the CPU, f32 weights, the same
    draws: the loss and its gradient w.r.t. rgb to 1e-4 relative (cuDNN and
    the CPU sum in other orders).  Returns K5's launches on the card."""
    from threestudio_3dgs_tpu_torch.utils.profiling import (
        TINY_ZERO123_K5_LAUNCHES, tiny_zero123_card_vs_cpu)

    results = tiny_zero123_card_vs_cpu(os.path.join(RUN_DIR, "zero123-tiny"))
    (loss_c, grad_c, k5_c), (loss_p, grad_p, _) = results["cuda"], results["cpu"]
    if k5_c != TINY_ZERO123_K5_LAUNCHES or not bool(torch.isfinite(grad_c).all()):
        fail(f"tiny Zero123 guidance on the card: {k5_c} K5 launches (want "
             f"{TINY_ZERO123_K5_LAUNCHES}), finite grad {bool(torch.isfinite(grad_c).all())}")
    report("z123-tiny", "zero123_loss", abs(loss_c - loss_p) / abs(loss_p), 1e-4,
           "card vs CPU, relative")
    report("z123-tiny", "zero123_grad_rgb", float((grad_c - grad_p).norm() / grad_p.norm()), 1e-4,
           "card vs CPU, relative L2")
    return k5_c


def write_zero123_checkpoint(torch):
    """A seeded random stable_zero123-format .ckpt (the published
    ZERO123_UNET, the SD VAE encoder, cc_projection 772 -> 768, f16 as the
    released file stores them) and, beside it, a random ViT-L/14
    image_encoder/ (f32), so the guidance's real CLIP path runs."""
    from threestudio_3dgs_tpu_torch.diffusion import SD_VAE, ZERO123_UNET
    from threestudio_3dgs_tpu_torch.diffusion.convert import write_random_ldm_checkpoint
    from threestudio_3dgs_tpu_torch.guidance.clip import VIT_L14, write_random_image_encoder

    t0 = time.perf_counter()
    ckpt = os.path.join(ZERO123_DIR, "stable_zero123.ckpt")
    sizes = {ckpt: write_random_ldm_checkpoint(ckpt, ZERO123_UNET, SD_VAE, clip_dim=768, seed=0,
                                               device="cuda", dtype=torch.float16)}
    enc_dir = os.path.join(ZERO123_DIR, "image_encoder")
    sizes[os.path.join(enc_dir, "pytorch_model.bin")] = write_random_image_encoder(
        enc_dir, VIT_L14, seed=0, device="cuda")
    log(f"wrote Stable Zero123 random checkpoint (seed 0; UNet + VAE encoder + cc_projection in "
        f"f16, ViT-L/14 image encoder in f32) in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{os.path.relpath(p, ROOT)} {n / 2**20:.1f} MiB" for p, n in sizes.items()))
    return ckpt


def reference_rgba(size=512):
    """A synthetic RGBA reference (uint8): a shaded disc with a stripe on a
    transparent ground."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1) * 2.0 - 1.0
    r = np.sqrt(xx**2 + yy**2)
    inside = r < 0.6
    shade = np.clip(1.0 - 0.8 * r, 0.0, 1.0)
    rgb = np.stack([0.9 * shade, 0.5 * shade + 0.3 * (np.abs(yy) < 0.1), 0.2 + 0.0 * shade], -1)
    alpha = inside.astype(np.float32)[..., None]
    return (np.concatenate([rgb * alpha, alpha], -1) * 255).round().astype(np.uint8)


def zero123_guidance(torch, native, ckpt, cond_size=256, calls=ZERO123_CALLS,
                     shapes=K5_Z123_SHAPES, label="zero123_guidance"):
    """Stable Zero123's guidance at its published widths and
    ``cond_image_size`` = ``cond_size``: prepare_embeddings on the reference
    frame, then ``calls`` calls with backward on (4, cond_size, cond_size,
    3) renders, counters zeroed just before: K5 exactly 5 times a call at
    each of ``shapes`` and nowhere else, finite losses, grad_norm > 0.  At a
    conditioning size other than 256 the denoiser's output through K5 is
    then held against the same call through K5's plain twin.  Returns K5's
    launches by shape."""
    from threestudio_3dgs_tpu_torch.guidance.temporal_zero123 import StableZero123Guidance
    from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
    from threestudio_3dgs_tpu_torch.ops.flash_attention import shape_tag
    from threestudio_3dgs_tpu_torch.utils.config import load_config

    cfg = load_config(ZERO123_CONFIG, [f"system.guidance.pretrained_model_name_or_path={ckpt}",
                                       f"system.guidance.cond_image_size={cond_size}",
                                       "data.image_path="])
    t0 = time.perf_counter()
    guidance = StableZero123Guidance(dict(cfg.system["guidance"]), device="cuda")
    frame = reference_rgba(cond_size)[None, ..., :3].astype(np.float32) / 255.0
    guidance.prepare_embeddings(frame)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if guidance.unet is None or guidance.unet.cfg.dtype != torch.bfloat16:
        fail(f"{label}: the guidance did not build its bf16 denoiser")
    rng = np.random.default_rng(0)
    batch = {"elevation": rng.uniform(-10, 80, 4).astype(np.float32),
             "azimuth": rng.uniform(-180, 180, 4).astype(np.float32),
             "camera_distances": np.full(4, 3.8, np.float32)}
    rgb = torch.tensor(rng.uniform(size=(4, cond_size, cond_size, 3)).astype(np.float32),
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    times = []
    for i in range(calls):
        x = rgb.clone().requires_grad_(True)
        t1 = time.perf_counter()
        out = guidance(x, None, batch, generator=gen, sched=guidance.sched_scalars(100 * i))
        out["loss_sds"].backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        loss, gnorm = float(out["loss_sds"].detach()), float(out["grad_norm"])
        if not (np.isfinite(loss) and gnorm > 0 and bool(torch.isfinite(x.grad).all())):
            fail(f"{label} call {i}: loss {loss}, grad_norm {gnorm}")
    launches = dict(native.LAUNCHES)
    shape_launches = {tag: c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
                      if fn == "flash_attention_forward"}
    want = {shape_tag(*shape): K5_PER_SHAPE_PER_UNET_CALL * calls for shape in shapes}
    if shape_launches != want or launches["flash_attention_forward"] != sum(want.values()):
        fail(f"{label}: K5 launched {launches['flash_attention_forward']} times, by "
             f"shape {shape_launches}; want {want}")
    n_params = sum(p.numel() for p in guidance.unet.parameters())
    log(f"{label}: {calls} calls of stable-zero123-guidance at cond_image_size {cond_size} "
        f"(ZERO123_UNET {n_params / 1e9:.3f} B parameters in bf16, CFG batch 8) on 4 x "
        f"{cond_size}^2 renders with backward: load + prepare_embeddings {load_s:.1f} s; per "
        f"call median {statistics.median(times[1:]):.1f} ms (min {min(times[1:]):.1f}, max "
        f"{max(times[1:]):.1f}; calls 2-{calls}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; last loss_sds {loss:.6g}, "
        f"grad_norm {gnorm:.6g}; launches {launches}, K5 by shape {shape_launches}")
    if cond_size != 256:
        lat = cond_size // 8
        noisy = torch.randn((4, 4, lat, lat), generator=gen, device="cuda")
        t = torch.full((4,), 500, dtype=torch.int64, device="cuda")
        frame_idx = torch.zeros(4, dtype=torch.int64, device="cuda")
        cam_emb = guidance.camera_embedding(batch)
        with torch.no_grad():
            native.reset_launches()
            got = torch.cat(guidance.denoiser(noisy, t, frame_idx, cam_emb)).float()
            k5_calls = native.LAUNCHES["flash_attention_forward"]
            kernel = fa.flash_bhnd_cuda
            fa.flash_bhnd_cuda = fa.flash_bhnd_torch  # the plain twin on the card
            try:
                want_eps = torch.cat(guidance.denoiser(noisy, t, frame_idx, cam_emb)).float()
            finally:
                fa.flash_bhnd_cuda = kernel
        if k5_calls != K5_PER_SHAPE_PER_UNET_CALL * len(shapes) or \
                native.LAUNCHES["flash_attention_forward"] != k5_calls:
            fail(f"{label}: the denoiser check launched K5 {k5_calls} times, then "
                 f"{native.LAUNCHES['flash_attention_forward'] - k5_calls} through the plain twin")
        report(label, "zero123_denoiser", float((got - want_eps).norm() / want_eps.norm()),
               Z512_DENOISER_REL, "K5 vs the plain twin in the UNet, relative L2 of (eps_u, eps_c)")
    del guidance
    torch.cuda.empty_cache()
    return {shape: shape_launches[shape_tag(*shape)] for shape in shapes}


def assert_same_field(torch, got, want_params, want_alive, label):
    """The loaded field equals the saved one where ``want_alive`` is set
    (``want_params`` of those rows, in order), with fresh Adam moments and
    zeroed statistics."""
    if not torch.equal(got.alive, want_alive):
        fail(f"{label}: alive rows {int(got.alive.sum())} differ from the saved field's")
    for k, v in want_params.items():
        if not torch.equal(getattr(got.params, k)[want_alive], v):
            fail(f"{label}: {k} differs from the saved field")
    stats = [got.adam.count] + [bool(t.any()) for t in list(got.adam.mu.values())
                                + list(got.adam.nu.values())
                                + [got.max_radii2d, got.xyz_grad_accum, got.denom]]
    if any(stats):
        fail(f"{label}: the warm start kept optimiser moments or statistics")


def train_zero123(torch, native):
    """ZERO123_STEPS steps of gaussian_splatting_zero123.yaml through
    launch.main on a synthetic 512^2 RGBA reference, counters zeroed just
    before; then warm starts from its .ckpt.npz and its PLY, and the export
    of its checkpoint.  Returns the training run's launches and K1-K4's
    inputs at the 128^2 ref view of the trained field."""
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS
    from threestudio_3dgs_tpu_torch.utils.saving import encode_png

    png = os.path.join(RUN_DIR, "reference_rgba.png")
    os.makedirs(RUN_DIR, exist_ok=True)
    with open(png, "wb") as f:
        f.write(encode_png(reference_rgba(512)))
    common = [f"data.image_path={png}", "data.random_camera.n_test_views=8",
              f"exp_root_dir={os.path.join(RUN_DIR, 'train_zero123')}"]
    argv = ["--config", ZERO123_CONFIG, "--train", f"trainer.max_steps={ZERO123_STEPS}",
            "trainer.val_check_interval=0", "data.resolution_milestones=[3,6]"] + common
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = trainer.metrics_log
    if len(rows) != ZERO123_STEPS:
        fail(f"train_zero123: expected {ZERO123_STEPS} logged steps, got {len(rows)}")
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        if bad or not row["zero123/grad_norm"] > 0 or row["n_dropped_pairs"] != 0:
            fail(f"train_zero123 step {row['step']}: non-finite {bad}, grad_norm "
                 f"{row['zero123/grad_norm']}, {row['n_dropped_pairs']} dropped pairs")
    missing = [k for k in RASTER_KERNELS if launches[k] == 0]
    if missing or launches["flash_attention_forward"] != 0:
        fail(f"train_zero123: kernels never launched {missing}; K5 launched "
             f"{launches['flash_attention_forward']} times (the analytic prior runs no UNet)")
    sizes = trainer.data.heights
    step_ms = [row["step_s"] * 1e3 for row in rows[1:]]
    rc = trainer.data.random_camera_cfg
    log(f"train_zero123: {ZERO123_STEPS} steps of gaussian_splatting_zero123.yaml (ref view at "
        f"{sizes} from steps {trainer.data.resolution_milestones[1:]}, random views "
        f"{rc.batch_size} x {rc.height}^2, stable-zero123-guidance's analytic prior): {wall:.2f} "
        f"s wall incl. 8 test renders; median step (steps 2-{ZERO123_STEPS}) "
        f"{statistics.median(step_ms):.1f} ms (min {min(step_ms):.1f}, max {max(step_ms):.1f}); "
        f"peak device memory {peak:.2f} GiB; last loss_total {rows[-1]['train/loss_total']:.6g}, "
        f"loss_ref_rgb {rows[-1]['train/loss_ref_rgb']:.6g}, guidance grad_norm "
        f"{rows[-1]['zero123/grad_norm']:.6g}; launches {launches}")

    ref_inp = view_inputs(trained_scene(torch, trainer), seed=5)
    saved = trainer.state.gauss
    want = {k: v[saved.alive] for k, v in saved.params.as_dict().items()}
    n_alive = saved.n_alive
    ckpt = os.path.join(trainer.save_dir, "ckpts", "last.ckpt.npz")
    ply = os.path.join(trainer.save_dir, "save", "point_cloud.ply")
    del trainer
    # the checkpoint keeps the rows where they were; the PLY holds the alive
    # rows in order, which load into the first ones
    first = torch.arange(saved.capacity, device=saved.alive.device) < n_alive
    for label, src, want_alive in (("warm start .ckpt.npz", ckpt, saved.alive),
                                   ("warm start .ply", ply, first)):
        t0 = time.perf_counter()
        warm = launch.main(["--config", ZERO123_CONFIG, "--validate",
                            f"system.geometry_convert_from={src}"] + common
                           + ["data.random_camera.n_val_views=1"])
        assert_same_field(torch, warm.state.gauss, want, want_alive, label)
        native.reset_launches()
        warm.max_steps = WARM_STEPS
        warm.fit()
        torch.cuda.synchronize()
        if len(warm.metrics_log) != WARM_STEPS or native.LAUNCHES["blend_forward"] == 0:
            fail(f"{label}: {len(warm.metrics_log)} steps, launches {dict(native.LAUNCHES)}")
        log(f"{label}: {os.path.relpath(src, ROOT)} -> {warm.state.gauss.n_alive} alive rows equal "
            f"to the saved field's, fresh moments and statistics, active SH degree "
            f"{warm.system.geometry.active_sh_degree}; {WARM_STEPS} steps from it, last "
            f"loss_total {warm.metrics_log[-1]['train/loss_total']:.6g}; "
            f"{time.perf_counter() - t0:.2f} s")
        del warm
    t0 = time.perf_counter()
    exporter = launch.main(["--config", ZERO123_CONFIG, "--export", "--resume", ckpt] + common)
    obj = os.path.join(exporter.save_dir, "save", "export", "model.obj")
    with open(obj) as f:
        faces = sum(line.startswith("f ") for line in f)
    if exporter.step != ZERO123_STEPS or faces < 1:
        fail(f"zero123 export: step {exporter.step}, {faces} faces in {obj}")
    log(f"zero123 export --resume {os.path.relpath(ckpt, ROOT)}: {faces} faces, "
        f"{time.perf_counter() - t0:.2f} s")
    del exporter
    torch.cuda.empty_cache()
    return launches, ref_inp


def trained_4d_scene(torch, trainer, size=256):
    """A reference-frame view of the trained 4D field at ``size``^2: the
    fixed front camera, the field evaluated at the first frame's time."""
    from threestudio_3dgs_tpu_torch.ops import camera as cam_mod

    data, system = trainer.data, trainer.system
    fovy = float(data.fovy[0])
    cam = cam_mod.camera_from_c2w(data.c2w[0], fovy, fovy, size, size)
    with torch.no_grad():
        means, scales, quats, opac, colors = system.geometry.get_timed_all(
            trainer.state.gauss, data.timestamps[0], int(data.frame_indices[0]),
            trainer.state.extra_params.get("deformation"))
    return dict(means=means, scales=scales, quats=quats, opac=opac[:, 0], colors=colors, cam=cam,
                alive=trainer.state.gauss.alive, tile_size=system.renderer.cfg.tile_size)


def check_4d_rows(torch, rows, label, keys):
    """Every logged train/ value finite, ``keys`` logged on every step and
    no pair dropped."""
    for row in rows:
        bad = [k for k, v in row.items() if k.startswith("train/") and not np.isfinite(v)]
        missing = [k for k in keys if k not in row]
        if bad or missing or row["n_dropped_pairs"] != 0:
            fail(f"{label} step {row['step']}: non-finite {bad}, missing {missing}, "
                 f"{row['n_dropped_pairs']} dropped pairs")


def train_gs4d(torch, native, ckpt):
    """The video-to-4D YAMLs through launch.main: gs4d_motion for
    GS4D_STEPS steps on the Stable Zero123 checkpoint, counters zeroed just
    before (the denoiser built through attach_video_frames, K5 at exactly
    its shapes, the losses finite, the guidance's grad_norm > 0, motion and
    omega trained), its temporal PLY read back and a --resume of its
    checkpoint; then gs4d.yaml (spline + per-frame deltas) and
    gs4d_static.yaml (SuGaR's regularisers) for GS4D_SHORT_STEPS each on the
    analytic prior.  Returns the motion run's launches, K5's launches by
    shape, and K1-K4's inputs at a 256^2 reference-frame view of its
    trained field."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models.spacetime import TEMPORAL_FIELDS
    from threestudio_3dgs_tpu_torch.ops.flash_attention import shape_tag
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs
    from threestudio_3dgs_tpu_torch.utils.profiling import PROJECT_KERNELS, RASTER_KERNELS

    motion = ["data.resolution_milestones=[5]", "system.loss.lambda_lite_arap_reg=[3,0,1000.,4]",
              "system.freq.update_arap=4", "data.random_camera.n_test_views=8",
              f"system.guidance_zero123.pretrained_model_name_or_path={ckpt}",
              f"exp_root_dir={os.path.join(RUN_DIR, 'gs4d_motion')}"]
    argv = ["--config", GS4D_MOTION_CONFIG, "--train", f"trainer.max_steps={GS4D_STEPS}",
            "trainer.val_check_interval=0"] + motion
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    shape_launches = {tag: c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
                      if fn == "flash_attention_forward"}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rows = trainer.metrics_log
    if len(rows) != GS4D_STEPS:
        fail(f"train_gs4d: expected {GS4D_STEPS} logged steps, got {len(rows)}")
    check_4d_rows(torch, rows, "train_gs4d", ("train/loss_ref_gs", "train/loss_lite_arap_reg"))
    for row in rows:
        if not row["zero123/grad_norm"] > 0:
            fail(f"train_gs4d step {row['step']}: grad_norm {row['zero123/grad_norm']}")
    guidance = trainer.system.guidance
    if guidance.unet is None or guidance.unet.cfg.dtype != torch.bfloat16:
        fail("train_gs4d: attach_video_frames did not build the bf16 Zero123 denoiser")
    missing = [k for k in RASTER_KERNELS + PROJECT_KERNELS if launches[k] == 0]
    want = {shape_tag(*shape): K5_PER_SHAPE_PER_UNET_CALL * GS4D_STEPS
            for shape in K5_GS4D_SHAPES}
    if missing or shape_launches != want or launches["flash_attention_forward"] != sum(
            want.values()):
        fail(f"train_gs4d: kernels never launched {missing}; K5 launched "
             f"{launches['flash_attention_forward']} times, by shape {shape_launches}; "
             f"want {want}")
    init = trainer.system.init_state(trainer.cfg.seed).gauss.params
    gauss = trainer.state.gauss
    alive = gauss.alive
    moved = {k: float((getattr(gauss.params, k) - getattr(init, k))[alive].abs().max())
             for k in ("motion", "omega", "trbf_center", "trbf_scale")}
    # trbf_center and trbf_scale take no gradient (dt is detached and the
    # TRBF opacity is off, as in the JAX package): they must not move
    if not (moved["motion"] > 0 and moved["omega"] > 0) or moved["trbf_center"] or moved[
            "trbf_scale"]:
        fail(f"train_gs4d: temporal fields moved {moved}")
    sizes = trainer.data.heights
    step_ms = [row["step_s"] * 1e3 for row in rows[1:]]
    n_params = sum(p.numel() for p in guidance.unet.parameters())
    rc = trainer.data.random_camera_cfg
    if trainer.data.rgbs.shape[1:3] != (sizes[0], sizes[0]):
        fail(f"train_gs4d: reference frames at {trainer.data.rgbs.shape[1:3]}, not the first "
             f"size {sizes[0]}^2")
    log(f"train_gs4d: {GS4D_STEPS} steps of gs4d_motion.yaml ({trainer.cfg.data['num_frames']} "
        f"frames, ref views at {sizes[0]}^2 throughout, the first of {sizes}, past the "
        f"milestone at step {trainer.data.resolution_milestones[1]}, as in the JAX package, "
        f"{rc.batch_size} random views at {rc.height}^2, capacity {gauss.capacity}, "
        f"{gauss.n_alive} alive; temporal-stable-zero123-guidance on the random checkpoint, "
        f"ZERO123_UNET {n_params / 1e9:.3f} B parameters in bf16, CFG batch "
        f"{2 * rc.batch_size}): {wall:.2f} s wall incl. loading and 8 test renders; median step "
        f"(steps 2-{GS4D_STEPS}) {statistics.median(step_ms):.1f} ms (min {min(step_ms):.1f}, "
        f"max {max(step_ms):.1f}); peak device memory {peak:.2f} GiB; last loss_total "
        f"{rows[-1]['train/loss_total']:.6g}, loss_ref_gs {rows[-1]['train/loss_ref_gs']:.6g}, "
        f"loss_lite_arap_reg {rows[-1]['train/loss_lite_arap_reg']:.6g}, grad_norm "
        f"{rows[-1]['zero123/grad_norm']:.6g}; moved {moved}; launches {launches}, K5 by shape "
        f"{shape_launches}")

    # the temporal PLY of the test renders' step holds the alive rows
    ply = os.path.join(trainer.save_dir, "save", "point_cloud.ply")
    back = trainer.system.geometry.load_temporal_ply(ply)
    for k in TEMPORAL_FIELDS:
        t = getattr(gauss.params, k)
        if t is not None and not np.array_equal(back[k], t[alive].cpu().numpy()):
            fail(f"train_gs4d: the temporal PLY's {k} differs from the trained field's")
    n_test = len(os.listdir(os.path.join(trainer.save_dir, "save", f"it{GS4D_STEPS}-test")))
    ref_inp = view_inputs(trained_4d_scene(torch, trainer), seed=6)
    ckpt_npz = os.path.join(trainer.save_dir, "ckpts", "last.ckpt.npz")
    del trainer, guidance
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the resumed steps on the analytic prior: the checkpoint's field and
    # step are what is checked, and the denoiser is already held above
    resumed = launch.main(["--config", GS4D_MOTION_CONFIG, "--train", "--resume", ckpt_npz,
                           f"trainer.max_steps={GS4D_STEPS + 2}",
                           "trainer.val_check_interval=0"] + motion[:-2]
                          + [f"exp_root_dir={os.path.join(RUN_DIR, 'gs4d_resume')}"])
    if resumed.step != GS4D_STEPS + 2 or len(resumed.metrics_log) != 2:
        fail(f"train_gs4d --resume: step {resumed.step}, {len(resumed.metrics_log)} logged steps")
    check_4d_rows(torch, resumed.metrics_log, "train_gs4d --resume", ())
    log(f"train_gs4d: {n_test} test renders with timestamps, the temporal PLY's "
        f"{len(TEMPORAL_FIELDS)} fields equal to the trained rows; --resume "
        f"{os.path.relpath(ckpt_npz, ROOT)} -> 2 more steps, last loss_total "
        f"{resumed.metrics_log[-1]['train/loss_total']:.6g}, {time.perf_counter() - t0:.2f} s")
    del resumed
    torch.cuda.empty_cache()

    png = os.path.join(RUN_DIR, "reference_rgba.png")
    for name, config, extra, keys in (
            ("gs4d", GS4D_CONFIG, [], ("train/loss_ref_gs",)),
            ("gs4d_static", GS4D_STATIC_CONFIG, [f"data.image_path={png}"],
             ("train/loss_opacity_binary", "train/loss_density_regulation",
              "train/loss_normal_regulation"))):
        native.reset_launches()
        t0 = time.perf_counter()
        short = launch.main(["--config", config, "--train", f"trainer.max_steps={GS4D_SHORT_STEPS}",
                             "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
                             "data.random_camera.n_test_views=4",
                             f"exp_root_dir={os.path.join(RUN_DIR, name)}"] + extra)
        torch.cuda.synchronize()
        short_launches = dict(native.LAUNCHES)
        if len(short.metrics_log) != GS4D_SHORT_STEPS:
            fail(f"train_{name}: {len(short.metrics_log)} logged steps")
        check_4d_rows(torch, short.metrics_log, f"train_{name}", keys)
        missing = [k for k in RASTER_KERNELS if short_launches[k] == 0]
        if missing:
            fail(f"train_{name}: kernels never launched {missing}")
        step_ms = [row["step_s"] * 1e3 for row in short.metrics_log[1:]]
        last = short.metrics_log[-1]
        log(f"train_{name}: {GS4D_SHORT_STEPS} steps ({short.system.geometry.cfg.__class__.__name__}"
            f", capacity {short.state.gauss.capacity}, the analytic prior) "
            f"{time.perf_counter() - t0:.2f} s wall incl. 4 test renders; steps 2-"
            f"{GS4D_SHORT_STEPS} {', '.join(f'{ms:.1f}' for ms in step_ms)} ms; last "
            + ", ".join(f"{k.split('/')[-1]} {last[k]:.6g}" for k in keys + ("train/loss_total",))
            + f"; launches {short_launches}")
        del short
        torch.cuda.empty_cache()
    return launches, {shape: shape_launches[shape_tag(*shape)] for shape in K5_GS4D_SHAPES}, \
        ref_inp


def sugar_view(torch, trainer, size=512):
    """The reference view of the refined SuGaR field at ``size``^2: its
    mesh-bound Gaussians, their SH colours from the camera and their face
    normals as the extra channels (C = 7)."""
    from threestudio_3dgs_tpu_torch.ops import camera as cam_mod
    from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import sh_colors

    data, geo = trainer.data, trainer.system.geometry
    fovy = float(data.fovy[0])
    cam = cam_mod.camera_from_c2w(data.c2w[0], fovy, fovy, size, size)
    with torch.no_grad():
        a = geo.as_gaussian_arrays(trainer.state.gauss)
        colors = sh_colors(a["means3d"], a["sh_coeffs"], cam.campos, geo.active_sh_degree)
    return dict(means=a["means3d"], scales=a["scales"], quats=a["quats"], opac=a["opacities"],
                colors=colors, extra=a["normals"], cam=cam, alive=None,
                tile_size=trainer.system.renderer.cfg.tile_size)


def sugar_run(torch, native, label, argv, keys, channels):
    """One SuGaR stage through launch.main, counters zeroed just before:
    every logged train/ value finite, ``keys`` logged each step, no pair
    dropped, K1-K4 launched and K1/K2 at exactly ``channels`` channels.
    Returns (trainer, launches, K1/K2 launches by channel count, wall s,
    peak GiB)."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    by_c = {f"{fn}:{tag}": c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
            if fn.startswith("blend_") and tag.startswith("C")}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(trainer.metrics_log) != SUGAR_STEPS:
        fail(f"{label}: {len(trainer.metrics_log)} logged steps")
    check_4d_rows(torch, trainer.metrics_log, label, keys)
    missing = [k for k in RASTER_KERNELS if launches[k] == 0]
    want = {f"blend_forward:C{channels}": launches["blend_forward"],
            f"blend_backward:C{channels}": launches["blend_backward"]}
    if missing or by_c != want:
        fail(f"{label}: kernels never launched {missing}; K1/K2 by channel count {by_c}, "
             f"want {want}")
    return trainer, launches, by_c, wall, peak


def train_sugar(torch, native):
    """SuGaR static, both stages (phase 11).  Returns the sugar stage's
    launches, K1-K4's inputs at a 512^2 view of its refined field, the path
    of the refined mesh's OBJ, the sugar stage's checkpoint and its
    command-line overrides."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models.mesh_extract import save_obj
    from threestudio_3dgs_tpu_torch.models.ply_io import read_ply_table
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs

    png = os.path.join(RUN_DIR, "reference_rgba.png")
    gauss_keys = ("train/loss_opacity_binary", "train/loss_density_regulation",
                  "train/loss_normal_regulation", "train/loss_zero123_sds")
    argv = ["--config", SUGAR_GAUSS_CONFIG, "--train", f"trainer.max_steps={SUGAR_STEPS}",
            "trainer.val_check_interval=0", f"data.image_path={png}",
            "data.random_camera.n_test_views=4", "system.sugar.start_regularization_from=0",
            "system.sugar.start_sdf_better_normal_from=0",
            f"system.geometry.sugar_prune_at={SUGAR_PRUNE_AT}",
            f"system.geometry.sugar_prune_threshold={SUGAR_PRUNE_THRESHOLD}",
            f"exp_root_dir={os.path.join(RUN_DIR, 'sugar_gaussian')}"]
    gt, g_launches, g_by_c, wall, peak = sugar_run(torch, native, "train_sugar_gaussian", argv,
                                                   gauss_keys, 4)
    nums = [row["gauss_num"] for row in gt.metrics_log]
    if not 0 < gt.state.gauss.n_alive < nums[SUGAR_PRUNE_AT]:
        fail(f"train_sugar_gaussian: {nums[SUGAR_PRUNE_AT]} -> {gt.state.gauss.n_alive} alive "
             f"rows at the prune of step {SUGAR_PRUNE_AT}")
    rand = gt.data.train_batch(SUGAR_STEPS)["random_camera"]
    step_ms = [row["step_s"] * 1e3 for row in gt.metrics_log[1:]]
    last = gt.metrics_log[-1]
    log(f"train_sugar_gaussian: {SUGAR_STEPS} steps of gs_to_sugar.yaml (ref view "
        f"{gt.data.height}^2, {len(rand['c2w'])} random views at {rand['height']}^2, capacity "
        f"{gt.state.gauss.capacity}, stable-zero123-guidance's analytic prior): {wall:.2f} s wall "
        f"incl. 4 test renders; median step (steps 2-{SUGAR_STEPS}) "
        f"{statistics.median(step_ms):.1f} ms; peak device memory {peak:.2f} GiB; gauss_num "
        f"{nums[0]} -> {gt.state.gauss.n_alive} after the prune at step {SUGAR_PRUNE_AT} "
        f"(threshold {SUGAR_PRUNE_THRESHOLD}); last "
        + ", ".join(f"{k.split('/')[-1]} {last[k]:.6g}" for k in gauss_keys)
        + f"; launches {g_launches}, K1/K2 by channels {g_by_c}")
    ckpt = os.path.join(gt.save_dir, "ckpts", "last.ckpt.npz")
    del gt
    torch.cuda.empty_cache()

    refine_keys = ("train/loss_zero123_sds", "train/loss_ref_rgb",
                   "train/loss_normal_consistency", "train/loss_laplacian_smoothing",
                   "train/loss_tv")
    common = [f"data.image_path={png}", "data.random_camera.n_test_views=4",
              f"system.geometry_convert_from={ckpt}", "trainer.val_check_interval=0",
              f"system.renderer.max_pairs={SUGAR_MAX_PAIRS}"]
    argv = ["--config", SUGAR_REFINE_CONFIG, "--train", f"trainer.max_steps={SUGAR_STEPS}",
            f"exp_root_dir={os.path.join(RUN_DIR, 'sugar_refine')}"] + common
    st, launches, by_c, wall, peak = sugar_run(torch, native, "train_sugar_refine", argv,
                                               refine_keys, 7)
    sugar = st.state.gauss
    init = st.system.init_state(st.cfg.seed).gauss
    moved = float((sugar.params.points - init.params.points).abs().max())
    if not moved > 0:
        fail("train_sugar_refine: the mesh vertices did not move")
    ply = os.path.join(st.save_dir, "save", "point_cloud.ply")
    n_ply = len(read_ply_table(ply)["x"])
    n_test = len(os.listdir(os.path.join(st.save_dir, "save", f"it{SUGAR_STEPS}-test")))
    if n_ply != sugar.n_gaussians or n_test != 4:
        fail(f"train_sugar_refine: {n_ply} PLY vertices for {sugar.n_gaussians} Gaussians, "
             f"{n_test} test renders")
    rc = st.data.random_camera_cfg
    pairs = max(row["n_pairs_max"] for row in st.metrics_log)
    step_ms = [row["step_s"] * 1e3 for row in st.metrics_log[1:]]
    last = st.metrics_log[-1]
    log(f"train_sugar_refine: {SUGAR_STEPS} steps of sugar_static_refine.yaml bound to the "
        f"gaussian stage's checkpoint: {sugar.n_faces} faces, {sugar.params.points.shape[0]} "
        f"vertices, {sugar.n_gaussians} Gaussians ({st.system.geometry.n_per_face} a face); ref "
        f"view {st.data.height}^2, {rc.batch_size} random views at {rc.height}^2: {wall:.2f} s "
        f"wall incl. binding and 4 test renders; median step (steps 2-{SUGAR_STEPS}) "
        f"{statistics.median(step_ms):.1f} ms (min {min(step_ms):.1f}, max {max(step_ms):.1f}); "
        f"peak device memory {peak:.2f} GiB; at most {pairs:.0f} pairs a view (ceiling "
        f"{SUGAR_MAX_PAIRS}, 0 dropped); vertices moved up to {moved:.3g}; last "
        + ", ".join(f"{k.split('/')[-1]} {last[k]:.6g}" for k in refine_keys)
        + f"; {n_ply} PLY vertices; launches {launches}, K1/K2 by channels {by_c}")
    inp = view_inputs(sugar_view(torch, st), seed=7, max_pairs=SUGAR_MAX_PAIRS)
    ckpt_s = os.path.join(st.save_dir, "ckpts", "last.ckpt.npz")
    # the refined mesh, which the dynamic phase binds
    obj = os.path.join(RUN_DIR, "sugar_refined.obj")
    save_obj(obj, sugar.params.points.cpu().numpy(), sugar.faces.cpu().numpy())
    del st
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    resumed = launch.main(["--config", SUGAR_REFINE_CONFIG, "--train", "--resume", ckpt_s,
                           f"trainer.max_steps={SUGAR_STEPS + 2}",
                           f"exp_root_dir={os.path.join(RUN_DIR, 'sugar_resume')}"] + common)
    if resumed.step != SUGAR_STEPS + 2 or len(resumed.metrics_log) != 2 or \
            resumed.state.gauss.adam.count != SUGAR_STEPS + 2:
        fail(f"train_sugar_refine --resume: step {resumed.step}, "
             f"{len(resumed.metrics_log)} logged steps, Adam count {resumed.state.gauss.adam.count}")
    check_4d_rows(torch, resumed.metrics_log, "train_sugar_refine --resume", refine_keys)
    log(f"train_sugar_refine --resume {os.path.relpath(ckpt_s, ROOT)} -> 2 more steps, last "
        f"loss_total {resumed.metrics_log[-1]['train/loss_total']:.6g}, "
        f"{time.perf_counter() - t0:.2f} s")
    del resumed
    torch.cuda.empty_cache()
    return launches, inp, obj, ckpt_s, common


def pred_normal_scene(torch, trainer):
    """One view of the trained pred_normal field: trained_scene with the
    field's normal as the 3 extra channels (C = 7)."""
    scene = trained_scene(torch, trainer)
    scene["extra"] = trainer.state.gauss.params.normal.detach()
    return scene


def train_pred_normal(torch, native, mv):
    """PRED_NORMAL_STEPS steps of gaussian_splatting_mvdream.yaml with
    pred_normal and lambda_pred_normal = 1 (train_lit's checks, K5 at
    MVDream's f32 shapes): train/loss_pred_normal finite and > 0 each step,
    the normal field moved, K1/K2 at 7 channels only.  Returns the
    launches view by view and on the stacked grid, and K1-K4's inputs at
    one view of the trained field and on the stacked grid of its batch
    (with that grid's cameras)."""
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs

    trainer, launches, stacked, _ = train_lit(torch, native, "train_mvdream_pred_normal",
                                              MVDREAM_CONFIG, mv + PRED_NORMAL, K5_MV_SHAPES,
                                              steps=PRED_NORMAL_STEPS)
    by_c = {f"{fn}:{tag}": c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
            if fn.startswith("blend_") and tag.startswith("C")}
    want = {"blend_forward:C7": launches["blend_forward"] + stacked["blend_forward"],
            "blend_backward:C7": launches["blend_backward"] + stacked["blend_backward"]}
    if by_c != want:
        fail(f"train_mvdream_pred_normal: K1/K2 by channel count {by_c}, want {want}")
    losses = [row["train/loss_pred_normal"] for row in trainer.metrics_log]
    if not all(np.isfinite(v) and v > 0 for v in losses):
        fail(f"train_mvdream_pred_normal: train/loss_pred_normal {losses}")
    normal = trainer.state.gauss.params.normal
    init = trainer.system.init_state(trainer.cfg.seed).gauss.params.normal
    moved = float((normal - init).abs().max())
    if not moved > 0:
        fail("train_mvdream_pred_normal: the normal field did not move")
    log(f"train_mvdream_pred_normal: loss_pred_normal by step "
        + ", ".join(f"{v:.6g}" for v in losses)
        + f"; normal moved by up to {moved:.3g} (normal_lr "
        f"{trainer.system.geometry.lr_tree(0)['normal']:.3g}); K1/K2 by channels {by_c}")
    inp = view_inputs(pred_normal_scene(torch, trainer), seed=5)
    stacked_inp = stacked_inputs(torch, trainer, PRED_NORMAL_STEPS, seed=13,
                                 extra=trainer.state.gauss.params.normal.detach())
    del trainer
    torch.cuda.empty_cache()
    return launches, stacked, inp, stacked_inp


def id_pass_exceptions(torch, verts, faces, cam, got, want):
    """Pixels whose face ids differ between two id-passes of one view,
    each classified as a z tie (both hits' depths within 1e-5) or a pixel
    on a triangle edge (a barycentric of either face within 1e-4 of 0, in
    float64); fails on any other.  Returns (ties, edge pixels)."""
    from threestudio_3dgs_tpu_torch.ops.tri_raster import project_vertices

    fa, fb = got.face_id.cpu(), want.face_id.cpu()
    ys, xs = torch.nonzero(fa != fb, as_tuple=True)
    if len(ys) == 0:
        return 0, 0
    pts, _ = project_vertices(verts.detach().cpu().float(), cam.w2c.cpu(), cam.full_proj.cpu(),
                              cam.height, cam.width)
    pts = pts.double()
    za, zb = got.zbuf.cpu(), want.zbuf.cpu()
    ties = edges = 0
    for y, x in zip(ys.tolist(), xs.tolist()):
        a, b = int(fa[y, x]), int(fb[y, x])
        if a >= 0 and b >= 0 and abs(float(za[y, x]) - float(zb[y, x])) <= 1e-5:
            ties += 1
            continue
        near = False
        for f in (a, b):
            if f < 0:
                continue
            v = pts[faces[f].cpu()]
            p = torch.tensor([x, y], dtype=torch.float64)

            def cross(u, w):
                return float(u[0] * w[1] - u[1] * w[0])

            e = [cross(v[2] - v[1], p - v[1]), cross(v[0] - v[2], p - v[2]),
                 cross(v[1] - v[0], p - v[0])]
            area = sum(e)
            near |= area != 0 and min(abs(t / area) for t in e) <= 1e-4
        if not near:
            fail(f"bake id-pass: pixel ({y}, {x}) has face {a} on the card and {b} on the CPU, "
                 f"neither a z tie nor on an edge")
        edges += 1
    return ties, edges


def bake_sugar(torch, native, ckpt, common):
    """The textured-mesh bake of the refined SuGaR field through
    ``launch.main --predict --resume`` with the border postprocess and the
    2^24 pair ceiling, over the data's 120 test views: the OBJ (F faces,
    3F vt rows), MTL and PNG (tex_size^2) read back; the faces before and
    after the postprocess, the texture's size and seen share, the id-pass's
    drop counters, each stage's wall seconds and the peak device memory
    printed; then one view's id-pass on the card against the same call on
    the CPU at BAKE_CPU_SIZE^2."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.ops.camera import camera_from_c2w
    from threestudio_3dgs_tpu_torch.ops.tri_raster import rasterize_triangles_camera
    from threestudio_3dgs_tpu_torch.utils.saving import decode_png

    argv = ["--config", SUGAR_REFINE_CONFIG, "--predict", "--resume", ckpt,
            "system.postprocess=true", f"exp_root_dir={os.path.join(RUN_DIR, 'sugar_bake')}"]
    argv += [o for o in common if not o.startswith("data.random_camera.n_test_views")]
    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = trainer.predict_stats
    out_dir = os.path.join(trainer.save_dir, "save", f"it{trainer.step}-predict")
    n_views = len(st["n_dropped_pairs"])
    faces, tex = st["faces_after"], st["tex_size"]
    counts = {"v": 0, "vt": 0, "f": 0}
    with open(os.path.join(out_dir, "textured_mesh.obj")) as f:
        for line in f:
            key = line.split(" ", 1)[0]
            if key in counts:
                counts[key] += 1
    with open(os.path.join(out_dir, "textured_mesh.mtl")) as f:
        mtl = f.read()
    with open(os.path.join(out_dir, "textured_mesh.png"), "rb") as f:
        png = decode_png(f.read())
    n_verts = trainer.state.gauss.params.points.shape[0]
    if (counts != {"v": n_verts, "vt": 3 * faces, "f": faces} or png.shape != (tex, tex, 3)
            or "map_Kd textured_mesh.png" not in mtl or n_views != 120
            or launches["blend_forward"] < n_views or launches["expand_bin"] < n_views):
        fail(f"bake_sugar: OBJ rows {counts} for {faces} faces and {n_verts} vertices, PNG "
             f"{png.shape} for tex_size {tex}, {n_views} views, launches {launches}")
    if not 0 < faces <= st["faces_before"] or not 0 < st["texels_seen"] <= 1:
        fail(f"bake_sugar: faces {st['faces_before']} -> {faces}, texels seen "
             f"{st['texels_seen']}")
    log(f"bake_sugar: --predict of the refined field ({st['faces_before']} faces, "
        f"{trainer.state.gauss.n_gaussians} Gaussians) with the border postprocess: {faces} "
        f"faces after it; {n_views} views at {trainer.data.random_camera_cfg.eval_height}^2; "
        f"texture {tex}x{tex}, {st['texels_seen']:.2%} of the texels seen by a view; id-pass "
        f"n_dropped_pairs max {max(st['n_dropped_pairs'])} sum {sum(st['n_dropped_pairs'])}, "
        f"n_dropped_tile max {max(st['n_dropped_tile'])} sum {sum(st['n_dropped_tile'])}; "
        f"wall s: renders {st['render_s']:.2f}, id-passes {st['id_pass_s']:.2f}, texel init "
        f"{st['texel_init_s']:.2f}, scatters {st['scatter_s']:.2f}, file writes "
        f"{st['write_s']:.2f}; {wall:.2f} s in all incl. binding; peak device memory "
        f"{peak:.2f} GiB; OBJ rows {counts}, PNG {png.shape}; launches {launches}")

    sugar = trainer.state.gauss
    view = trainer.data.test_views()[0]
    fovy = float(np.asarray(view["fovy"]).reshape(-1)[0])
    c2w = np.asarray(view["c2w"][0])
    max_pairs = max(1 << 18, 1 << int(np.ceil(np.log2(6 * sugar.n_faces))))
    kw = dict(max_pairs=max_pairs, max_faces_per_tile=1024)
    cams = {dev: camera_from_c2w(c2w, fovy, fovy, BAKE_CPU_SIZE, BAKE_CPU_SIZE, device=dev)
            for dev in ("cuda", "cpu")}
    got = rasterize_triangles_camera(sugar.params.points, sugar.faces, cams["cuda"], **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rasterize_triangles_camera(sugar.params.points.cpu(), sugar.faces.cpu(), cams["cpu"],
                                      **kw)
    cpu_s = time.perf_counter() - t0
    if (int(got.n_dropped_pairs), int(got.n_dropped_tile)) != \
            (int(want.n_dropped_pairs), int(want.n_dropped_tile)):
        fail(f"bake id-pass: drop counters card {int(got.n_dropped_pairs)}, "
             f"{int(got.n_dropped_tile)} vs CPU {int(want.n_dropped_pairs)}, "
             f"{int(want.n_dropped_tile)}")
    ties, edges = id_pass_exceptions(torch, sugar.params.points, sugar.faces, cams["cpu"], got,
                                     want)
    hits = int((want.face_id >= 0).sum())
    same = got.face_id.cpu() == want.face_id
    bary_err = float((got.bary.cpu() - want.bary)[same].abs().max()) if bool(same.any()) else 0.0
    log(f"check bake id-pass at {BAKE_CPU_SIZE}^2, card vs CPU ({cpu_s:.1f} s on the CPU): "
        f"{hits} hit pixels, face ids equal but {ties} z-tie and {edges} edge pixels; "
        f"barycentrics elsewhere max |diff| {bary_err:.3e}; drops {int(want.n_dropped_pairs)} "
        f"pairs, {int(want.n_dropped_tile)} tile")
    del trainer, sugar, got, want
    torch.cuda.empty_cache()


def dynamic_view(torch, trainer, random_view):
    """One view of the trained dynamic SuGaR field at its time: the first
    random view of a training batch (256^2), or the first reference view
    (512^2); the timed Gaussians, their SH colours from the camera and
    their face normals as the extra channels (C = 7)."""
    from threestudio_3dgs_tpu_torch.ops import camera as cam_mod
    from threestudio_3dgs_tpu_torch.ops.rasterizer.preprocess import sh_colors

    batch = trainer.data.train_batch(SUGAR_DYN_STEPS)
    view = batch["random_camera"] if random_view else batch
    size = int(view["height"])
    fovy = float(view["fovy"][0])
    cam = cam_mod.camera_from_c2w(view["c2w"][0], fovy, fovy, size, size,
                                  device=trainer.device)
    geo, state = trainer.system.geometry, trainer.state
    with torch.no_grad():
        a = geo.get_timed_gs_arrays(state.gauss, view["timestamp"][0],
                                    int(view["frame_indices"][0]),
                                    state.extra_params.get("deformation"))
        colors = sh_colors(a["means3d"], a["sh_coeffs"], cam.campos, geo.active_sh_degree)
    return dict(means=a["means3d"], scales=a["scales"], quats=a["quats"], opac=a["opacities"],
                colors=colors, extra=a["normals"], cam=cam, alive=None,
                tile_size=trainer.system.renderer.cfg.tile_size)


def dynamic_run(torch, native, label, config, steps, extra, keys):
    """One dynamic SuGaR YAML through launch.main for ``steps`` steps,
    counters zeroed just before: every logged train/ value finite, ``keys``
    logged each step, no pair dropped, K1-K4 launched and K1/K2 at 7
    channels only.  Returns (trainer, launches, K5 launches by shape, wall
    s, peak GiB)."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.utils.profiling import RASTER_KERNELS

    torch.cuda.reset_peak_memory_stats()
    native.reset_launches()
    t0 = time.perf_counter()
    trainer = launch.main(["--config", config, "--train", f"trainer.max_steps={steps}",
                           "trainer.val_check_interval=0", "trainer.log_every_n_steps=1",
                           f"system.renderer.max_pairs={SUGAR_MAX_PAIRS}",
                           f"exp_root_dir={os.path.join(RUN_DIR, label)}"] + extra)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    by_c = {f"{fn}:{tag}": c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
            if fn.startswith("blend_") and tag.startswith("C")}
    k5 = {tag: c for (fn, tag), c in native.SHAPE_LAUNCHES.items()
          if fn == "flash_attention_forward"}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(trainer.metrics_log) != steps:
        fail(f"{label}: {len(trainer.metrics_log)} logged steps")
    check_4d_rows(torch, trainer.metrics_log, label, keys)
    missing = [k for k in RASTER_KERNELS if launches[k] == 0]
    want = {"blend_forward:C7": launches["blend_forward"],
            "blend_backward:C7": launches["blend_backward"]}
    if missing or by_c != want:
        fail(f"{label}: kernels never launched {missing}; K1/K2 by channel count {by_c}, "
             f"want {want}")
    return trainer, launches, k5, wall, peak


def node_moves(torch, trainer):
    """How far each node track and each deformation parameter moved from
    the initial state."""
    init = trainer.system.init_state(trainer.cfg.seed)
    gauss = trainer.state.gauss
    moved = {k: float((getattr(gauss.params, k) - getattr(init.gauss.params, k)).abs().max())
             for k in ("node_trans", "node_rots", "node_scales", "node_opacity")
             if getattr(gauss.params, k) is not None}
    deform = trainer.state.extra_params.get("deformation", {})
    moved_deform = {k: float((v - init.extra_params["deformation"][k]).abs().max())
                    for k, v in deform.items()}
    return moved, {k: v for k, v in moved_deform.items() if v > 0}


def train_sugar_dynamic(torch, native, obj, ckpt):
    """Dynamic SuGaR (phase 12) on the refined mesh ``obj``: the four
    YAMLs through launch.main.  Returns the main run's launches, K5's
    launches at its shape and at sugar_drag's, and K1-K4's inputs at a
    256^2 random view and at a 512^2 reference view of its trained
    field."""
    from threestudio_3dgs_tpu_torch import launch
    from threestudio_3dgs_tpu_torch.models.ply_io import read_ply_table
    from threestudio_3dgs_tpu_torch.ops.flash_attention import shape_tag
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs

    bind = [f"system.geometry.surface_mesh_to_bind_path={obj}"]
    guided = [f"system.guidance_zero123.pretrained_model_name_or_path={ckpt}"]
    keys = ("train/loss_zero123_sds", "train/loss_ref_rgb", "train/psnr",
            "train/loss_normal_consistency", "train/loss_normal_depth_consistency",
            "train/loss_arap_reg", "train/loss_rgb_tv", "train/loss_normal_tv")
    tr, launches, k5, wall, peak = dynamic_run(
        torch, native, "sugar_dynamic_dg_zero123", SUGAR_DYN_CONFIG, SUGAR_DYN_STEPS,
        bind + guided + ["data.random_camera.n_test_views=4"], keys)
    rows = tr.metrics_log
    for row in rows:
        if not row["zero123/grad_norm"] > 0:
            fail(f"sugar_dynamic_dg_zero123 step {row['step']}: grad_norm "
                 f"{row['zero123/grad_norm']}")
    guidance = tr.system.guidance
    if guidance.unet is None or guidance.unet.cfg.dtype != torch.bfloat16:
        fail("sugar_dynamic_dg_zero123: attach_video_frames did not build the bf16 denoiser")
    want = {shape_tag(*shape): K5_PER_SHAPE_PER_UNET_CALL * SUGAR_DYN_STEPS
            for shape in K5_SUGAR_DYN_SHAPES}
    if k5 != want or launches["flash_attention_forward"] != sum(want.values()):
        fail(f"sugar_dynamic_dg_zero123: K5 by shape {k5}, want {want}")
    gauss = tr.state.gauss
    moved, moved_deform = node_moves(torch, tr)
    # the deformation heads start at zero: only their last biases take a
    # gradient at first, and only head_pos's is read (the position deltas)
    heads = [k for k in moved_deform if not (k.startswith("head_") and k.endswith("/b"))]
    if not moved_deform or heads or not moved["node_scales"] > 0:
        fail(f"sugar_dynamic_dg_zero123: deformation params moved {moved_deform}, node tracks "
             f"moved {moved}")
    n_ply = len(read_ply_table(os.path.join(tr.save_dir, "save", "point_cloud.ply"))["x"])
    n_test = len(os.listdir(os.path.join(tr.save_dir, "save", f"it{SUGAR_DYN_STEPS}-test")))
    if n_ply != gauss.n_gaussians or n_test != 4:
        fail(f"sugar_dynamic_dg_zero123: {n_ply} PLY vertices for {gauss.n_gaussians} "
             f"Gaussians, {n_test} test renders")
    rc = tr.data.random_camera_cfg
    pairs = max(row["n_pairs_max"] for row in rows)
    step_ms = [row["step_s"] * 1e3 for row in rows[1:]]
    last = rows[-1]
    cfg = tr.system.geometry.cfg
    log(f"train_sugar_dynamic: {SUGAR_DYN_STEPS} steps of sugar_dynamic_dg_zero123.yaml bound to "
        f"the refined mesh: {gauss.n_faces} faces, {gauss.params.points.shape[0]} vertices, "
        f"{gauss.n_gaussians} Gaussians ({tr.system.geometry.n_per_face} a face), "
        f"{gauss.nodes_xyz.shape[0]} nodes x {gauss.skin_idx.shape[1]} neighbours, "
        f"{cfg.skinning_method}, {cfg.dynamic_mode}, d_scale {cfg.d_scale}; "
        f"{tr.cfg.data['num_frames']} ref views at {tr.data.height}^2 of "
        f"{tr.cfg.data['video_length']} frames, {rc.batch_size} random views at {rc.height}^2; "
        f"temporal-stable-zero123-guidance on the random checkpoint, CFG batch "
        f"{2 * rc.batch_size}): "
        f"{wall:.2f} s wall incl. binding, loading and 4 test renders; median step (steps 2-"
        f"{SUGAR_DYN_STEPS}) {statistics.median(step_ms):.1f} ms (min {min(step_ms):.1f}, max "
        f"{max(step_ms):.1f}); peak device memory {peak:.2f} GiB; at most {pairs:.0f} pairs a view "
        f"(ceiling {SUGAR_MAX_PAIRS}, 0 dropped); last "
        + ", ".join(f"{k.split('/')[-1]} {last[k]:.6g}" for k in keys + ("train/loss_total",))
        + f", grad_norm {last['zero123/grad_norm']:.6g}; node tracks moved {moved}; deformation "
        f"params moved {moved_deform}; {n_ply} PLY vertices; launches {launches}, K5 by shape "
        f"{k5}")
    rand_inp = view_inputs(dynamic_view(torch, tr, True), seed=8, max_pairs=SUGAR_MAX_PAIRS)
    ref_inp = view_inputs(dynamic_view(torch, tr, False), seed=9, max_pairs=SUGAR_MAX_PAIRS)
    ckpt_d = os.path.join(tr.save_dir, "ckpts", "last.ckpt.npz")
    del tr, guidance
    torch.cuda.empty_cache()

    # the resumed steps on the analytic prior: the checkpoint's state and
    # step are what is checked, and the denoiser is held above
    t0 = time.perf_counter()
    resumed = launch.main(["--config", SUGAR_DYN_CONFIG, "--train", "--resume", ckpt_d,
                           f"trainer.max_steps={SUGAR_DYN_STEPS + 2}",
                           "trainer.val_check_interval=0", "data.random_camera.n_test_views=1",
                           f"system.renderer.max_pairs={SUGAR_MAX_PAIRS}",
                           f"exp_root_dir={os.path.join(RUN_DIR, 'sugar_dynamic_resume')}"] + bind)
    if resumed.step != SUGAR_DYN_STEPS + 2 or len(resumed.metrics_log) != 2 or \
            resumed.state.gauss.adam.count != SUGAR_DYN_STEPS + 2:
        fail(f"sugar_dynamic_dg_zero123 --resume: step {resumed.step}, "
             f"{len(resumed.metrics_log)} logged steps, Adam count "
             f"{resumed.state.gauss.adam.count}")
    check_4d_rows(torch, resumed.metrics_log, "sugar_dynamic_dg_zero123 --resume", keys)
    log(f"train_sugar_dynamic --resume {os.path.relpath(ckpt_d, ROOT)} -> 2 more steps, last "
        f"loss_total {resumed.metrics_log[-1]['train/loss_total']:.6g}, "
        f"{time.perf_counter() - t0:.2f} s")
    del resumed
    torch.cuda.empty_cache()

    # the other YAMLs: sugar_dynamic.yaml with the inter-frame ARAP from step
    # 1 (its YAML starts it at 10), sugar_drag.yaml on the checkpoint (K5 at
    # its CFG batch of 2), sugar_dynamic_dg.yaml
    drag_k5 = None
    for name, extra, more in (
            ("sugar_dynamic", ["system.freq.milestone_inter_frame_reg=1"],
             ("train/loss_arap_reg", "train/loss_ref_xyz")),
            ("sugar_drag", guided, ("train/loss_arap_reg", "train/loss_normal_consistency")),
            ("sugar_dynamic_dg", [], ("train/loss_arap_reg", "train/loss_normal_tv"))):
        run, run_launches, run_k5, wall, peak = dynamic_run(
            torch, native, name, os.path.join(CONFIG_DIR, f"{name}.yaml"), SUGAR_DYN_SHORT_STEPS,
            bind + extra + ["data.random_camera.n_test_views=1"], ("train/loss_zero123_sds",) + more)
        moved, moved_deform = node_moves(torch, run)
        geo_cfg = run.system.geometry.cfg
        if geo_cfg.dynamic_mode == "discrete" and not (moved["node_trans"] > 0
                                                       and moved["node_rots"] > 0):
            fail(f"{name}: node tracks moved {moved}")
        if geo_cfg.dynamic_mode == "deformation" and not moved_deform:
            fail(f"{name}: the deformation params did not move")
        note = ""
        if name == "sugar_dynamic":
            inter = [row.get("train/loss_arap_reg_inter_frame") for row in run.metrics_log]
            if any(v is None for v in inter[1:]) or inter[0] is not None:
                fail(f"sugar_dynamic: inter-frame ARAP at steps {inter}")
            note = (f"; the inter-frame ARAP ({run.cfg.system['num_inter_frames']} times) at "
                    f"steps 2-{SUGAR_DYN_SHORT_STEPS} (system.freq.milestone_inter_frame_reg=1 "
                    f"on the command line; the YAML's is 10): {inter[1:]}")
        if name == "sugar_drag":
            want = {shape_tag(*shape): K5_PER_SHAPE_PER_UNET_CALL * SUGAR_DYN_SHORT_STEPS
                    for shape in K5_SUGAR_DRAG_SHAPES}
            if run_k5 != want:
                fail(f"sugar_drag: K5 by shape {run_k5}, want {want}")
            drag_k5 = run_k5
        elif run_k5:
            fail(f"{name}: K5 launched {run_k5} on the analytic prior")
        gauss = run.state.gauss
        step_ms = [row["step_s"] * 1e3 for row in run.metrics_log[1:]]
        last = run.metrics_log[-1]
        log(f"train_{name}: {SUGAR_DYN_SHORT_STEPS} steps ({gauss.n_gaussians} Gaussians on "
            f"{gauss.n_faces} faces, {gauss.nodes_xyz.shape[0]} nodes, {geo_cfg.dynamic_mode}, "
            f"{geo_cfg.skinning_method}, spline {geo_cfg.use_spline}, "
            f"{'the random checkpoint' if extra == guided else 'the analytic prior'}): {wall:.2f}"
            f" s wall incl. binding and 1 test render; steps 2-{SUGAR_DYN_SHORT_STEPS} "
            f"{', '.join(f'{ms:.1f}' for ms in step_ms)} ms; peak {peak:.2f} GiB; last "
            + ", ".join(f"{k.split('/')[-1]} {last[k]:.6g}" for k in more + ("train/loss_total",))
            + f"; moved {moved}{note}; launches {run_launches}, K5 {run_k5}")
        del run
        torch.cuda.empty_cache()
    k5_launches = {shape: k5[shape_tag(*shape)] for shape in K5_SUGAR_DYN_SHAPES}
    k5_launches.update({shape: drag_k5[shape_tag(*shape)] for shape in K5_SUGAR_DRAG_SHAPES})
    return launches, k5_launches, rand_inp, ref_inp


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from threestudio_3dgs_tpu_torch.guidance.base import text_embedding
    from threestudio_3dgs_tpu_torch.ops import camera as cam_mod
    from threestudio_3dgs_tpu_torch.ops import native
    from threestudio_3dgs_tpu_torch.utils.kernel_timing import view_inputs
    from threestudio_3dgs_tpu_torch.utils.profiling import (
        PROJECT_KERNELS, RASTER_KERNELS, bench_scene)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    global SM_MAX_HZ
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    SM_MAX_HZ = float(clock.stdout.strip().splitlines()[0]) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, highest SM clock "
        f"{SM_MAX_HZ / 1e6:.0f} MHz")

    t0 = time.perf_counter()
    native.build()
    log(f"built {sorted(native.LIBRARIES)} in {time.perf_counter() - t0:.1f} s")
    for line in native.build_log().splitlines():
        if any(key in line for key in ("Used", "spill", "rc ", "entry function", "arning",
                                       "Performance")):
            log(f"  {line.strip()}")

    t0 = time.perf_counter()
    small = view_inputs(small_scene(torch, cam_mod), seed=1)
    errs = {"small": check_kernels(torch, small, "small")}
    log_tile_skew(torch, small, count_evals(torch, small), "small")
    k6_err, k6_launches = check_slots(torch, native, *slot_inputs(small), "small")
    bench = bench_scene("cuda")
    bench_inp = view_inputs(bench, seed=2)
    errs["bench"] = check_kernels(torch, bench_inp, "bench")
    for label, inputs in (("bench", slot_inputs(bench_inp)), ("wide", wide_slot_inputs(torch))):
        err, launches = check_slots(torch, native, *inputs, label)
        k6_err, k6_launches = max(k6_err, err), k6_launches + launches
    k7_errs = check_project(torch, native)
    log(f"kernel checks: {time.perf_counter() - t0:.1f} s")

    log("bench-scene timing:")
    time_kernels(torch, bench_inp, "bench")
    k6_time = time_slots(torch, bench_inp)
    log("K7 timing at the cells' shapes (these go in the kernels line):")
    k7_times = time_project()
    del bench_inp
    bench_render(torch, bench, native)
    del bench
    torch.cuda.empty_cache()

    trainer, train_launches, train_stacked = train(torch, native)
    train_inp = view_inputs(trained_scene(torch, trainer), seed=3)
    train_stk_inp, train_cams = stacked_inputs(torch, trainer, 20, seed=14)
    errs["train"] = check_kernels(torch, train_inp, "train")
    log("train-shape timing (the main path's shapes; these go in the kernels line):")
    timing = time_kernels(torch, train_inp, "train")
    train_stk_errs, train_stk_timing = hold_stacked(torch, train_stk_inp, train_cams,
                                                    "train_stacked")
    del trainer, train_inp, train_stk_inp
    torch.cuda.empty_cache()

    full_run(torch, native)
    batched_launches, batched_errs, batched_timing = train_batched(torch, native)
    (dp_launches, band_launches, band_errs, band_timing, shard_errs,
     shard_timing) = train_dp(torch, native)
    profile_run(card)

    write_sd_checkpoint(torch)
    k5_errs = check_flash(torch)
    check_sd_small(torch)
    check_clip_small(torch)
    sd_launches, k5_launches = train_sd(torch, native)
    if sd_launches["flash_attention_forward"] != sum(k5_launches.values()):
        fail("K5's launches by shape do not add up to its launches")
    k5_times = time_flash(torch, K5_SHAPES, torch.bfloat16)

    # this slice's paths: (a) the shading YAML with its own SD guidance and
    # CLIP prompts, (b) the MVDream YAML with its multi-view guidance, (c)
    # the background YAML with fake guidance
    lit = ["system.guidance.pretrained_model_name_or_path=" + SD_DIR,
           "system.prompt_processor.pretrained_model_name_or_path=" + SD_DIR,
           f"system.material.ambient_only_steps={AMBIENT_ONLY_STEPS}"]
    trainer, _, _, _ = train_lit(torch, native, "train_shading", SHADING_CONFIG, lit, K5_SHAPES)
    prompt_utils = trainer.system.prompt_utils
    if np.array_equal(prompt_utils.text_embedding, text_embedding(prompt_utils.prompt)):
        fail("train_shading: the prompt was not encoded by the CLIP text encoder")
    del trainer
    torch.cuda.empty_cache()

    write_mv_checkpoint(torch)
    # the YAML replaces 95% of the views' backgrounds by black or white, so
    # in 40 views the MLP would see no gradient 13% of the time; at 50% the
    # check that it trained has teeth
    mv = ["system.guidance.pretrained_model_name_or_path=" + MV_DIR,
          "system.background.random_aug_prob=0.5"] + lit[1:]
    trainer, mv_launches, mv_stacked, mv_k5 = train_lit(torch, native, "train_mvdream",
                                                        MVDREAM_CONFIG, mv, K5_MV_SHAPES)
    if trainer.system.guidance.unet is None or trainer.system.guidance.vae_encoder is None:
        fail("train_mvdream: the guidance did not load the MVDream directory")
    mv_inp = view_inputs(trained_scene(torch, trainer), seed=4)
    mv_stk_inp, mv_cams = stacked_inputs(torch, trainer, LIT_STEPS, seed=15)
    del trainer
    torch.cuda.empty_cache()
    mv_errs = check_kernels(torch, mv_inp, "mv256")
    log("MVDream-view timing (256^2, the trained MVDream field; these go in the kernels line):")
    mv_timing = time_kernels(torch, mv_inp, "mv256")
    mv_stk_errs, mv_stk_timing = hold_stacked(torch, mv_stk_inp, mv_cams, "mv256_stacked")
    del mv_inp, mv_stk_inp
    k5_mv_times = time_flash(torch, K5_MV_SHAPES, torch.float32)
    # the MVDream YAML with pred_normal: K1/K2 at C = 7 on its trained view
    pn_launches, pn_stacked, pn_inp, (pn_stk_inp, pn_cams) = train_pred_normal(torch, native, mv)
    pn_errs = check_kernels(torch, pn_inp, "mv_pn")
    log("MVDream pred_normal-view timing (256^2, C = 7; these go in the kernels line):")
    pn_timing = time_kernels(torch, pn_inp, "mv_pn")
    pn_stk_errs, pn_stk_timing = hold_stacked(torch, pn_stk_inp, pn_cams, "mv_pn_stacked")
    del pn_inp, pn_stk_inp

    trainer, _, _, _ = train_lit(torch, native, "train_background", BACKGROUND_CONFIG,
                              ["system.guidance_type=fake-sds-guidance"])
    del trainer
    torch.cuda.empty_cache()

    # image-to-3D: K5 at d = 40, the Zero123 guidance (tiny, card vs CPU;
    # then at its published widths), the zero123 YAML and its warm starts
    k5_errs.update(check_flash(torch, K5_Z123_CHECKS, seed=40))
    check_zero123_small(torch)
    z123_ckpt = write_zero123_checkpoint(torch)
    z123_k5 = zero123_guidance(torch, native, z123_ckpt)
    z123_launches, z123_inp = train_zero123(torch, native)
    z123_errs = check_kernels(torch, z123_inp, "z123")
    log("zero123 ref-view timing (128^2, the trained zero123 field; these go in the kernels "
        "line):")
    z123_timing = time_kernels(torch, z123_inp, "z123")
    del z123_inp
    k5_z123_times = time_flash(torch, K5_Z123_SHAPES, torch.bfloat16)
    # K5 past 64 columns, and the Zero123 guidance at a 512^2 conditioning
    # image, whose level 1 reaches K5 at d = 80
    k5_errs.update(check_flash(torch, K5_WIDE_CHECKS, seed=100))
    z512_k5 = zero123_guidance(torch, native, z123_ckpt, cond_size=512, calls=ZERO123_512_CALLS,
                               shapes=K5_Z512_SHAPES, label="zero123_guidance_512")
    k5_z512_times = time_flash(torch, K5_Z512_SHAPES, torch.bfloat16)
    time_flash(torch, [s for s in K5_WIDE_SHAPES if s not in K5_Z512_SHAPES], torch.bfloat16)

    # video-to-4D: K5 at the temporal guidance's CFG batch, the 4D YAMLs
    k5_errs.update(check_flash(torch, K5_GS4D_CHECKS, seed=60))
    gs4d_launches, gs4d_k5, gs4d_inp = train_gs4d(torch, native, z123_ckpt)
    gs4d_errs = check_kernels(torch, gs4d_inp, "gs4d")
    log("gs4d reference-frame timing (256^2, the trained 4D field; these go in the kernels "
        "line):")
    gs4d_timing = time_kernels(torch, gs4d_inp, "gs4d")
    del gs4d_inp
    k5_gs4d_times = time_flash(torch, K5_GS4D_SHAPES, torch.bfloat16)

    # SuGaR static: the gaussian stage (C = 4), then the sugar stage (C = 7)
    sugar_launches, sugar_inp, sugar_obj, sugar_ckpt, sugar_common = train_sugar(torch, native)
    sugar_errs = check_kernels(torch, sugar_inp, "sugar")
    log("SuGaR reference-view timing (512^2, the refined field, C = 7; these go in the kernels "
        "line):")
    sugar_timing = time_kernels(torch, sugar_inp, "sugar")
    del sugar_inp
    # --predict: the textured-mesh bake of the refined field
    bake_sugar(torch, native, sugar_ckpt, sugar_common)

    # dynamic SuGaR on the refined mesh: K5 at the temporal guidance's CFG
    # batches, the four YAMLs, K1-K4 at a timed random view and a ref view
    k5_errs.update(check_flash(torch, K5_SUGAR_DYN_CHECKS, seed=80))
    dyn_launches, dyn_k5, dyn_rand_inp, dyn_ref_inp = train_sugar_dynamic(torch, native,
                                                                          sugar_obj, z123_ckpt)
    dyn_errs, dyn_timing = {}, {}
    for label, inp in (("sugar_dyn256", dyn_rand_inp), ("sugar_dyn512", dyn_ref_inp)):
        dyn_errs[label] = check_kernels(torch, inp, label)
        log(f"dynamic SuGaR {label} timing (the trained dynamic field at its view's time, C = 7; "
            f"these go in the kernels line):")
        dyn_timing[label] = time_kernels(torch, inp, label)
    del dyn_rand_inp, dyn_ref_inp
    k5_dyn_times = time_flash(torch, K5_SUGAR_DYN_SHAPES + K5_SUGAR_DRAG_SHAPES, torch.bfloat16)

    # (row name, kernel, launches, max abs error, timings): K1-K4 at the
    # trained view, the MVDream view, the zero123 ref view and the 4D
    # reference-frame view, K5 once per main-path shape
    raster = list(RASTER_KERNELS)
    rows = [(name, name, train_launches[name], max(e[name] for e in errs.values()), timing[name])
            for name in raster]
    rows += [(f"{name}@train_stacked", name, train_stacked[name], train_stk_errs[name],
              train_stk_timing[name]) for name in raster]
    rows += [(f"{name}@stacked", name, batched_launches[name], batched_errs[name],
              batched_timing[name]) for name in raster]
    rows += [(f"{name}@dp_shard", name, dp_launches[name], shard_errs[name],
              shard_timing[name]) for name in raster]
    rows += [(f"{name}@band", name, band_launches[name], band_errs[name], band_timing[name])
             for name in raster]
    rows += [(f"{name}@mvdream256", name, mv_launches[name], mv_errs[name], mv_timing[name])
             for name in raster]
    rows += [(f"{name}@mvdream256_stacked", name, mv_stacked[name], mv_stk_errs[name],
              mv_stk_timing[name]) for name in raster]
    rows += [(f"{name}@zero123", name, z123_launches[name], z123_errs[name], z123_timing[name])
             for name in raster]
    rows += [(f"flash_attention_forward@{bh}x{n}x{d}", "flash_attention_forward",
              k5_launches[(bh, n, d)], k5_errs[(bh, n, d, "bfloat16")], k5_times[(bh, n, d)])
             for bh, n, d in K5_SHAPES]
    rows += [(f"flash_attention_forward@{bh}x{n}x{d}:f32", "flash_attention_forward",
              mv_k5[(bh, n, d)], k5_errs[(bh, n, d, "float32")], k5_mv_times[(bh, n, d)])
             for bh, n, d in K5_MV_SHAPES]
    rows += [(f"flash_attention_forward@{bh}x{n}x{d}", "flash_attention_forward",
              z123_k5[(bh, n, d)], k5_errs[(bh, n, d, "bfloat16")], k5_z123_times[(bh, n, d)])
             for bh, n, d in K5_Z123_SHAPES]
    rows += [(f"{name}@mvdream_pn", name, pn_launches[name], pn_errs[name], pn_timing[name])
             for name in raster]
    rows += [(f"{name}@mvdream_pn_stacked", name, pn_stacked[name], pn_stk_errs[name],
              pn_stk_timing[name]) for name in raster]
    rows += [(f"flash_attention_forward@{bh}x{n}x{d}", "flash_attention_forward",
              z512_k5[(bh, n, d)], k5_errs[(bh, n, d, "bfloat16")], k5_z512_times[(bh, n, d)])
             for bh, n, d in K5_Z512_SHAPES]
    rows += [(f"{name}@gs4d", name, gs4d_launches[name], gs4d_errs[name], gs4d_timing[name])
             for name in raster]
    rows += [(f"flash_attention_forward@{bh}x{n}x{d}", "flash_attention_forward",
              gs4d_k5[(bh, n, d)], k5_errs[(bh, n, d, "bfloat16")], k5_gs4d_times[(bh, n, d)])
             for bh, n, d in K5_GS4D_SHAPES]
    rows += [(f"{name}@sugar", name, sugar_launches[name], sugar_errs[name], sugar_timing[name])
             for name in raster]
    rows += [(f"{name}@{label}", name, dyn_launches[name], dyn_errs[label][name],
              dyn_timing[label][name]) for label in ("sugar_dyn256", "sugar_dyn512")
             for name in raster]
    rows += [(f"flash_attention_forward@{bh}x{n}x{d}", "flash_attention_forward",
              dyn_k5[(bh, n, d)], k5_errs[(bh, n, d, "bfloat16")], k5_dyn_times[(bh, n, d)])
             for bh, n, d in K5_SUGAR_DYN_SHAPES + K5_SUGAR_DRAG_SHAPES]
    # K6 is on no training path: its launches are its checks', its time the
    # bench scene's
    rows.append(("expand_slots", "expand_slots", k6_launches, k6_err, k6_time))
    # K7 at the cells' shapes, its launches from the training run of each
    # cell's YAML: gs4d_motion, gaussian_splatting (SD's 4 x 512^2) and MVDream
    k7_launches = {"gs4d": gs4d_launches, "sd": train_launches, "mv": mv_launches}
    rows += [(f"{name}@{case}", name, k7_launches[case][name], k7_errs[case][name],
              k7_times[case][name]) for case in k7_errs for name in PROJECT_KERNELS]
    kernels = []
    for row_name, name, launches, err, t in rows:
        kernels.append({
            "name": row_name,
            "route": "cuda",
            "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"],
            "launches": launches,
            "max_abs_err": err,
            "ms": t["ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1],
            "bound_term": t.get("bound_term", t["bound"][1]),
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
        })
    log(f"smoke run: {time.perf_counter() - t_start:.1f} s wall, the kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
