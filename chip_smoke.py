#!/usr/bin/env python3
"""Drive the PyTorch port (pixray_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. device: CUDA must be available; prints the card's name and power limit;
2. build: compiles the CUDA sources of pixray_tpu_torch/csrc (warp.cu and
   strokes.cu, one nvcc each, in parallel);
3. warp kernels (K1, K2) in their bare-warp configuration (f32, no
   jitter, no noise) vs the plain gather on the card, forward (bitwise) and
   backward, at the 45 perspective cuts of a 64-cut bank (224x224x3 canvas,
   S=224, modes 0/1/3 with a fill), at the whole 64-cut bank (K3c's
   function at the X1/X2 ablations' shapes) and a ragged small case (N=5,
   S=17, 20x28 canvas), with kernel and median times and bounds;
3a. warp_batch (K3e/K3f's single-mode function) at crosscheck's case (8
   cuts of a 224x597x3 canvas into 224): every padding mode against the
   plain warp, the reflection case timed beside grid_sample;
3b. bank kernels (K1, K2 with the bf16 rounding, jitter and noise inside)
   vs the plain composition on the card: the flagship 64-cut bank and a
   ragged tie-rich bank whose K2 blocks take both accumulation branches
   (counted by K2 itself); the pre-jitter bank of the jittered cuts
   bitwise, the bank within one bf16 ulp, the canvas gradient within
   BWD_RTOL; kernel, plain, grid_sample times and bounds;
3c. bank kernels without jitter: the flagship bank with apply = 0 on
   every row (the spot, spot_off and image-prompt banks): K1 bitwise
   against the plain composition, K2 (no saved bank) within BWD_RTOL of
   the plain gradient, and the forward-only launch of a canvas that needs
   no gradient (one K1, no K2, nothing saved); times beside 3b's;
4. stroke kernels (K4, K4s, K5) vs the plain stroke renderer on the card:
   forward, all four gradients, and K4s's saved state against its plain
   twins (each tile's stroke list exactly, its chunk-entry tile canvases
   within the forward's tolerance), on clipdraw's own init (1024 strokes,
   P=25, 384x216, white), line_sketch (24 strokes, P=65, paper background;
   also P=321 and, on 192x108, P=769, which take fewer strokes per chunk),
   a ragged case (9 strokes on 40x140: off-canvas, zero-length, exact-tie
   and alpha-0 strokes), a crowded case (300 short strokes in a 32x32
   region of 64x96: lists across build rounds and many chunks beside empty
   tiles) and the flagship's strokes
   moved off the canvas (the background back bitwise, zero stroke
   gradients, dbg == g); kernel times, plain times and bounds for
   clipdraw, line_sketch and off-canvas (the walk alone);
4b. bank kernels at the ResNet towers' cut sizes: 12 and 64 cuts of 288
   (RN50x4) and 64 of 384 (RN50x16), each under 3b's gates and timed
   beside the plain composition and grid_sample, with K2's count of blocks
   in each accumulation branch;
5. agreement: TinyTest pixel and clipdraw runs, and a tiny_test VQGAN
   under TinyTest + TinyTest48, on the card against the same runs on the
   CPU (plain versions), same latent, weights and draws, per-step losses;
   likewise the plug-ins, and a tiny ModifiedResNet (32 px), a tiny timm
   trunk (48 px) and TinyTest in one pixel run (the tiny configs put into
   the port's tables for that phase only);
5b. blocked: the pixel, clipdraw, vqgan and RN50 rows (and
   tiler_fft_shift's filter) with --steps_per_call 8
   against 1, from one seed, 16 steps after step 0 (vqgan 8): the first
   replayed step of each block bitwise an eager step from the state the
   block started from; with the learning-rate scale at 0, a blocked and
   an eager run from one state bitwise at every step (the float atomics
   of K2 and K5 part two runs after a step with the learning rate on);
   the port's kernels listed by torch.profiler in one graph replay;
   capture time, host ms per block, steps/s;
5c. layer ranges: the pixel and vqgan rows blocked (8), 24 steps after
   step 0, captured with the device layer ranges on and off from one seed:
   the ranged graph holds the other's nodes kind for kind and one
   event-record node for each event of its ranges; the first replayed
   step of each ranged block bitwise an eager step from the state the
   block started from, as in 5b; each ranged block's record holds every
   range's device ms (a tower per perceptor, the bank, the drawer's synth),
   each above 0, their sum under the ranged steps' wall time; steps/s
   with the ranges on and off;
6. main path: the bench's headline row (pixel drawer, 384x216, "sunrise",
   random-weight ViT-B/32, 64 cuts) through apply_settings + Engine, 9
   warm-up and 24 timed steps, blocked (step 0 eager, then blocks of 8 as
   CUDA graph replays); asserts the blocks, finite, descending losses, one
   K1 and one K2 launch per step (the warm-up step before the capture
   included; a replay counts what its capture recorded), and the checkin PNG;
6b. RN50 row: the main path under RN50 (random weights), timed as 6, with
   the peak device memory; asserts descent and one K1 and one K2 per step;
6c. --quality best (RN50x4 at 288 px, ViT-B/32, ViT-B/16; 12 cuts,
   batches 2) and --perceptors mixed --quality better (RN50, ViT-B/16,
   SLIP_VITB16; 36 cuts) on the pixel row, 17 steps (two blocks): finite
   losses, each tower's term, one K1 and one K2 per tower and batch each
   step, ms per step, peak device memory;
7. clipdraw path: the bench's clipdraw row (1024 strokes, same prompt,
   model, cuts and canvas), 9 + 24 steps, blocked; asserts finite, descending losses,
   one K4s + K5 + K1 + K2 launch per step, K4 at checkin, the PNG and the
   SVG of --save_svg;
8. line_sketch: 9 steps (one block) with a trainable paper color; asserts
   finite losses, launches, and that the paper color moved;
9. vqgan path: the bench's vqgan row (imagenet_f16_16384, random weights,
   under ViT-B/32 + ViT-B/16, 64 cuts, 384x208), 9 + 24 steps, blocked; asserts
   finite losses, two K1 and two K2 launches per step, that the latent
   moved within the codebook box onto other codes, and the 384x208 PNG;
10. decoder times: the VQGAN's decode forward and gradient to the latent
   at the 24x13x256 latent, and its encoder at 384x208, in bf16 and in an
   f32 copy (CUDA events);
11. default run: ``pixray_tpu_torch.run(prompts=...)`` with every other
   setting at its default (vqgan, ViT-B/32 + ViT-B/16, 30 cuts, the init
   noise resized and encoded, an LR drop), cut to 12 steps (1-8 one
   block); asserts the resolved settings, finite losses, the encoded init
   on codebook rows, the LR drop, the checkins and frames, the step video
   (steps/output.mp4, or the GIF where no MP4 encoder exists), and the
   launches;
12. image row: the pixel row (384x216, ViT-B/32, 64 cuts, "sunrise") with
   an init image, an image prompt, a spot and a spot_off prompt on the
   package's mask, a target image and a label, from PNGs the script
   writes: blocked vs eager as 5b (the first replayed step bitwise), then
   9 + 24 steps timed; 4 K1 and 3 K2 launches per step (main, spot,
   spot_off, the forward-only image prompt), the JAX package's term
   names, finite losses, steps/s, device busy and events per step;
13. overlay row: the vqgan row with an init image, an overlay every 4
   steps, an image label and init_weight_pix, --steps_per_call 4: every
   overlay ends the block before it, and the step after each overlay that
   starts a block gives the losses of an eager step from the re-encoded
   latent (the replay reads the latent the overlay wrote in place);
14. agreement: row 12 on TinyTest, card against CPU, as in 5;
15. animation row: the pixel row under --animation_dir over 3 seeded
   384x216 PNGs (the --init_image, --image_prompts and --target_images
   globs), save_every 10, 20 iterations (2 rounds x 3 frames x 10 steps,
   a blend between the rounds), blocked: blocks inside each frame's span,
   2 K1 and 1 K2 per step (the main bank and the frame's forward-only
   image-prompt bank), for each frame the first replayed step after the
   frame swap bitwise an eager step from the same latent, state and
   draws, the JAX package's term names, the frame PNGs and anim.gif;
   steps/s, device events and busy per replayed step;
16. optimizers: the pixel row under AdamW, Adagrad, Adamax, DiffGrad and
   AdamP, each blocked against eager as in 5b (8 steps, one block);
17. resume: the pixel row (24 steps, --checkpoint_every 12) and the
   clipdraw row (16, 8) against an engine resumed from the checkpoint, at
   the learning rate and at learning-rate scale 0: the restored latent,
   optimizer state, LR scale and generators bitwise the straight run's,
   the first resumed step's losses bitwise, and at scale 0 every resumed
   step's losses and the final latent bitwise (as in 5b); and a
   checkpoint written on the CPU (TinyTest) resumed on the card;
18. --make_video (6 steps of the pixel row: the per-step frames and the
   video, a GIF where there is no MP4 encoder) and --profile_dir (10
   steps, one block: a trace that names K1 and K2);
19. agreement: row 15 on TinyTest, card against CPU, both rounds, as in 5;
20. checkpoints on disk: a full-width RN50 in OpenAI's layout (RN50.pt)
   and SLIP_VITB16 in SLIP's DDP layout (slip_base_100ep.pt), seeded random
   weights written under $PIXRAY_TPU_MODELS: the perceptor built from each
   file holds the in-memory state dict's weights and gives its bf16 image
   embeddings, bitwise;
21. vdiff agreement: tiny_up, tiny_up_mod32 (tiny_up_mod's spec with
   TinyTest's 32-wide clip embedding) and tiny_test under the log schedule
   and --vdiff_skip 10, card against CPU as in 5, the re-noise draws too;
22. vdiff row: the bench's last row (bench.py:108: yfcc_2 on random weights
   drawn on the card, 256x256, ViT-B/32, 64 cuts), 9 warm-up and 24 timed
   steps, eager (the drawer re-noises after every step): finite losses,
   one K1 and one K2 per step, a fresh optimizer after every step from 1
   on at min(sigma / alpha * 0.001, 0.01) of its schedule entry, the latent
   re-noised, the 256x256 PNG; one step's host enqueue, device busy and
   events, peak device memory, the weights' init seconds;
23. cc12m: --vdiff_model cc12m_1 --clip_models ViT-B/16 at 256x256, 5
   steps: the clip embedding is the prompt's normalized ViT-B/16 embedding,
   finite losses, ms per step, peak memory;
24. cogs/pixray_vdiff.yaml as written (quality better: RN50, ViT-B/32,
   ViT-B/16), cut to 9 steps: each tower's term, 3 K1 and 3 K2 per step;
25. ESRGAN: the bench's one-shot 4x pass (bench.py:158, 256x256 ->
   1024x1024, 23 blocks, random weights) in bf16 and f32 beside its FLOP
   count, and a tiny RRDBNet card against CPU;
26. super_resolution: the pixel row's settings under --drawer
   super_resolution, blocked vs eager as in 5b, then 9 + 24 steps timed
   blocked with one K1 and one K2 per step;
27. agreement: a hex pixel run with --custom_loss resmem,style
   (--styleloss_skip 0, a style image the script writes) on TinyTest,
   card against CPU as in 5;
28. blocked: the pixel row under --pixel_type hex (the gather render and
   its inverse-map adjoint inside the graph) as in 5b;
29. the other cell geometries: the pixel row under rectshift, hex,
   diamond, tri and knit (grids 81x45, 81x63, 81x91, 113x46, 80x45 from
   the iso and edge checks), 9 + 24 steps timed blocked, descending, one
   K1 and one K2 per step; ms per blocked step, device busy and events per
   step from one replay;
30. the heavy losses: the pixel row with --custom_loss style
   --styleloss_skip 0 (VGG16 at 384x216 over three scales) and with
   --custom_loss resmem, timed as 29 (finite losses, the loss's term),
   with the peak device memory;
31. the front ends: the port's HTTP server in this process (worker on
   cuda, the repo's cogs/): /health, /products, /queue and a full
   queue's 503; pixrayapi with the pixel row as its settings YAML (40
   steps, display_every 10: at least 4 PNG parts of 384x216), text2pixel
   (30 steps; RN50, ViT-B/32, ViT-B/16), a job cut by a 4 s deadline (its
   TimeoutError part) and the pixel job again, captured while the cut
   job's runner still steps; K1/K2 per served step; time to first frame,
   ms per step, peak memory and memory after each job, job 4's within
   SERVED_MEMORY_MARGIN of job 1's; vectorize --models ViT-B/32 --inputs
   on the card against the CPU; a two-seed sweep shard (run last, after
   35: after its served jobs torch.profiler sees no kernels);
32. rung kernels: K1's int8, bf16 and high variants and K2's bf16, high
   and int8 variants (csrc/warp.cu, the JAX package's precision rungs)
   against their plain twins on the flagship bank, the ragged tie-rich
   bank, 64 cuts of 384, 16 cuts of 512 (K2-bf16's shared memory past
   48 KB) and 8 zoomed-out cuts on 384x384 (K2-int8's scatter on device
   memory): K1-int8's pre-jitter bank bitwise, the other banks within
   BANK_ULPS; K2-int8's cotangent pass and K2-int8 bitwise with and
   without jitter and the same bits twice, the float rungs within
   RUNG_BWD_RTOL of max|dwork| and bitwise on a bank where each canvas
   element takes one tap; kernel, call, CUDA-event and plain times beside the
   bounds (an s8 canvas for K1-int8);
33. tower rungs: ViT-B/32 on the flagship bank under PIXRAY_TPU_CLIP_PREC
   bf16 / int8 / int8b, _CLIP_PREQ 1 / 0 and _CLIP_LN32 0 / 1: forward +
   input gradient ms per call, and at the JAX default rung the card
   against the CPU on two cuts (equal s8 codes, embeddings within TOWER_ATOL);
   first torch._int_mm at the tower's product shapes with its second
   operand row-major and column-major (exact, ms) beside the bf16 GEMM;
34. the ladder gate: the pixel row (60 steps, blocked) at the JAX
   package's default rungs (WARP int8, CLIP int8b, PREQ 1, LN32 0) and at
   EXACT_ENV's (WARP highest, CLIP bf16, LN32 1), last5(default) -
   last5(exact) <= 0.08 as bench.py's check_precision_gate; then each knob
   of the defaults alone and the rungs no default takes (K1 bf16, K1
   high, K2 int8), 17 steps each; per row the descent, steps/s, the
   device busy (three replays for exact and each knob alone) and one
   replay's K1/K2 variants, and whether each knob alone brings the busy
   below every exact replay;
35. the parallel layer (pixray_tpu_torch/parallel), every rank spawned by
   this script on the one card, gloo between them: the pixel row on mesh
   (2, 1) and MIXED_CONFIG on (1, 2) (RN50 and SLIP_VITB16 on model index
   0, ViT-B/16 on 1), 3 eager steps each against the unsharded engine in
   this process (per-step loss within 2e-3, the final latent within 2e-3
   in the L2 norm, each beside two unsharded runs' gaps), the ranks'
   latents bitwise equal after every step, K1/K2 per rank and step (1/1
   and 1/1; 3/2 and 3/1); the dry run's sweep (run_parity on (4, 1), (2, 2)
   with 3 tiny towers placed, FSDP on (2, 2)) on four ranks; and a 1-rank
   NCCL group joined through init_distributed summing a latent gradient;
   ms per step and peak memory per rank (for the record: ranks on one
   card say nothing of scaling); (e) the sharded step in blocks on NCCL:
   one rank spawned on a 1-rank NCCL group (backend checked), the pixel
   row on its (1, 1) mesh, 17 steps eager sharded, blocked sharded (step
   0 eager, then 2 blocks of 8, each one CUDA graph with the step's sum
   over the mesh inside) and blocked unsharded: each block's first
   replayed step bitwise the eager sharded step from the state it started
   from, at learning-rate scale 0 a block bitwise its eager steps with
   the latent kept, blocked sharded within 2e-3 of blocked unsharded (per
   step loss; the final latent in the L2 norm, or within twice two
   unsharded runs' gap, which K2's atomics widen past it over 17 steps),
   K1 and K2 once per replayed step, 8 NCCL all-reduce kernel nodes in
   the captured block (counted in the graph's own dump); ms per step of
   the three, the captures' seconds and peak memory.

The product's tiler recipes (cogs/tiler_*.yaml) run with their quality's
towers (RN50, ViT-B/32, ViT-B/16) between 11 and 12.

Then one JSON line with the kernels' numbers (K1/K2 also with their
launches on the pixel, vdiff, cc12m, recipe and super_resolution rows, on
rows 29 and 30, on the served pixrayapi and text2pixel requests and per
rank on the rows of 35; each
rung variant with its launches on the ladder rows), and
as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# bench.py's _COMMON + CONFIGS["pixel"] (bench.py:76-95), restated here
# because bench.py drives the JAX package
PIXEL_CONFIG = dict(
    prompts="sunrise", clip_models="ViT-B/32", num_cuts=64, batches=1,
    save_every=100000, display_every=100000, init_noise=None, vector_prompts="none",
    seed=1, save_intermediates=False, learning_rate_drops=[],
    drawer="pixel", size=[384, 216],
)
CLIPDRAW_CONFIG = dict(PIXEL_CONFIG, drawer="clipdraw")  # CONFIGS["clipdraw"], bench.py:105
# CONFIGS["vqgan"], bench.py:100: imagenet_f16_16384 (the vqgan drawer's
# default model, random weights) under the ViT-B/32 + ViT-B/16 ensemble
VQGAN_CONFIG = dict(PIXEL_CONFIG, drawer="vqgan", clip_models="ViT-B/32,ViT-B/16")
FFT_CONFIG = dict(PIXEL_CONFIG, drawer="fft", size=[256, 256])  # CONFIGS["fft"], bench.py:97 (the fft mode)
# the pixel row under the other tower families: RN50 alone; and the presets,
# whose towers, cuts and batches come from --quality / --perceptors
RN50_CONFIG = dict(PIXEL_CONFIG, clip_models="RN50")
_PRESET_BASE = {k: v for k, v in PIXEL_CONFIG.items() if k not in ("clip_models", "num_cuts", "batches")}
BEST_CONFIG = dict(_PRESET_BASE, quality="best")  # RN50x4 (288 px), ViT-B/32, ViT-B/16; 12 cuts, batches 2
MIXED_CONFIG = dict(_PRESET_BASE, quality="better", perceptors="mixed")  # RN50, ViT-B/16, SLIP_VITB16; 36 cuts
PRESET_STEPS = 17  # step 0 (the checkin), then two blocks of 8
# the product's tiler recipes (cogs/*.yaml) with their own towers (quality
# "better": RN50, ViT-B/32, ViT-B/16, 36 cuts each)
TILER_RECIPES = ("tiler_fft", "tiler_fft_shift", "tiler_pixel_shift")
TILER_STEPS = 17  # step 0 (the checkin), then two blocks of 8
# K1/K2 at the new towers' cut sizes: (cuts, cut size) of RN50x4 (best's 12
# cuts, the bench's 64) and RN50x16
BANK_SIZES = ((12, 288), (64, 288), (64, 384))
FFT_MODE_STEPS = 9  # step 0, then one block
# the plug-ins on the card against the CPU: every filter but wallpaper (the
# tiler recipes run it) and every ported loss, under a palette string whose
# colours have distinct channels inside (0, 1) (the jitter's HSV ties,
# tests/test_torch_plugins_slice.py)
PLUGIN_EXTRA = dict(filters="lookup,tiler", custom_loss="saturation,symmetry,smoothness,palette,edge,gaussian,aesthetic",
                    palette="(200,40,70)->(40,90,200)\\4;[(230+200+60), (90+160+120)]", transparent=True)
WARMUP_STEPS = 9  # bench.py:73-74
OVERLAY_STEPS = 17  # step 0, 1-3 eager, blocks of 4 from each overlay at 4, 8, 12, step 16 eager
TIMED_STEPS = 24
LINE_SKETCH_STEPS = 9  # step 0, then one block
DEFAULT_RUN_STEPS = 12  # pixray_tpu_torch.run's defaults, cut to 12 iterations
# the pixel row under the other cell geometries, each with the grid the JAX
# drawer's iso and edge checks give the bench's default 80x45 at 384x216
GEOMETRY_GRIDS = {"rectshift": (81, 45), "hex": (81, 63), "diamond": (81, 91), "tri": (113, 46), "knit": (80, 45)}
# the pixel row with the two heavy losses: STROTSS against a style image the
# script writes (VGG16 at 384x216 over the three scales 4, 2, 1), and ResMem
STYLE_EXTRA = dict(custom_loss="style", styleloss_skip=0)
RESMEM_EXTRA = dict(custom_loss="resmem")

CODEBOOK_ATOL = 1e-5  # an encoded latent row against its nearest codebook row
FWD_ATOL = 0.0  # the bare warp: the kernel repeats the plain version's f32 ops in its order
BWD_RTOL = 5e-4  # of max|dwork|: atomics sum in a run-dependent order
# the bank (bf16, jitter, noise) against the plain composition on the card:
BANK_ULPS = 1  # per element: the jitter's f32 ops, where the card's eager ops round otherwise
# the explicit jitter adjoint vs autograd, per bf16 cotangent: f32 sums in another order
# (tests/test_torch_cutout_bank.py holds them to 1e-5 in f32), then rounded to bf16:
# |d_explicit - d_autograd| <= ADJOINT_ULP * |d_autograd| + ADJOINT_CANCEL * max|g| of the pixel
ADJOINT_ULP = 2.0 ** -7  # one bf16 ulp
ADJOINT_CANCEL = 4e-5  # where its terms cancel far below the pixel's cotangent (1.9e-5 on the CPU)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (HBM3 peak)
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# f32 operations per output pixel of K1/K2: every cut's warp (and noise), and the jittered cuts' jitter
WARP_FWD_FLOPS_PER_PIXEL = 55  # coordinates and taps ~25, 3-channel bilinear 24, noise 6
JITTER_FWD_FLOPS_PER_PIXEL = 45  # HSV round trip
WARP_BWD_FLOPS_PER_PIXEL = 49  # taps ~25, the 12 tap products 24
BARE_WARP_FWD_FLOPS_PER_PIXEL = 49  # the bare warp (f32, no jitter, no noise): coordinates and taps, bilinear
JITTER_BWD_FLOPS_PER_PIXEL = 110  # HSV state ~35, its adjoint ~75
STROKE_FLOPS_PER_SEGMENT = 18  # per kept (pixel, stroke) pair: projection, clamp, distance, min
STROKE_FLOPS_PER_PAIR = 18  # sqrt, coverage, the 4-channel over
# K5 per kept pair, the distance kept from its one pass: alpha and the transmittance 10,
# the cotangents 18, the five per-stroke terms and their sums 10, the canvas over 12
STROKE_BWD_FLOPS_PER_PAIR = 50
STROKE_BWD_FLOPS_PER_RAMP = 16  # per pair on the anti-aliasing ramp: the two end points' gradients
AGREE_ATOL = 2e-2  # per-step loss, card (bf16 epilogue) vs CPU (f32) on TinyTest
# blocked vs eager (and resumed vs straight) on the card at learning-rate scale 0: the optimizer
# state, advanced by the same gradients but for the float atomics' order, within this share of its
# largest value (on an H100: up to 4e-7, and 1.5e-2 for vqgan through its decoder; a state not
# carried from step to step: ~1)
BLOCKED_STATE_RTOL = 0.25
BLOCKED_FLOOR = 1e-5
BLOCKED_STEPS = 16  # after step 0; vqgan 8
RANGED_STEPS = 24  # after step 0: three blocks of 8
PROFILER_PAUSE_S = 0.03  # host idle on both sides of each traced call (profiled_events)
STROKE_FWD_ATOL = 1e-4  # the JAX fused-vs-XLA forward tolerance (tests/test_pallas_strokes.py:38)


def write_images(tmp):
    """Seeded PNGs for the image inputs: {init, prompt, target, overlay
    (RGBA, alpha 160), label}: paths in ``tmp``."""
    import numpy as np
    from PIL import Image

    out = {}
    for seed, (name, shape) in enumerate((("init", (216, 384, 3)), ("prompt", (300, 300, 3)),
                                          ("target", (240, 320, 3)), ("overlay", (120, 200, 4)),
                                          ("label", (208, 384, 3)))):
        arr = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
        if name == "overlay":
            arr[..., 3] = 160
        out[name] = os.path.join(tmp, f"{name}.png")
        Image.fromarray(arr).save(out[name])
    return out


def image_extra(paths):
    """Row 12's image inputs on top of a row's config."""
    return dict(init_image=paths["init"], image_prompts=paths["prompt"], spot_prompts="a face",
                spot_prompts_off="sky", target_images=paths["target"], labels="fox")


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the f32 operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fail(msg: str):
    print(f"CHIP SMOKE FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_all():
    """One nvcc per CUDA source, started together; returns seconds per library."""
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    times, errors = {}, {}

    def one(mod):
        t0 = time.perf_counter()
        try:
            mod.build(force=True)
        except Exception as exc:  # reported below, fatal
            errors[mod.LIBRARY] = exc
        times[mod.LIBRARY] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(m,)) for m in (cuda_warp, cuda_strokes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        fail(f"build failed: {errors}")
    return times


def median_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_events(step, steps):
    """The device events of ``steps`` calls of ``step`` under torch.profiler,
    each call ended by a synchronize.  One call before them is the
    profiler's warm-up step: it starts tracing the card late, and a fresh
    window loses its first kernels.  Each call sits between two host pauses
    of ``PROFILER_PAUSE_S``: the profiler drops device events that lie near
    the edges of its window, up to all of them in a window of a few short
    kernels, several windows in a row (``port_profiler_windows.py``)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    traces = []
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=steps, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule,
                                on_trace_ready=lambda p: traces.append(list(p.events()))) as prof:
        for _ in range(steps + 1):
            time.sleep(PROFILER_PAUSE_S)
            step()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAUSE_S)
            prof.step()
    if not traces:
        fail("the profiler finished no window")
    # the schedule's own step annotations also sit on the device's timeline
    return [ev for ev in traces[-1] if ev.device_type == torch.autograd.DeviceType.CUDA
            and not ev.name.startswith("ProfilerStep")]


def replay_events(graph, want, label, tries=3):
    """The device events of one replay of ``graph`` under torch.profiler,
    from the first window that lists each kernel of ``want`` ({name: count})
    exactly ``want`` times.  A replay runs the kernels its capture recorded,
    every one of them, but the profiler can drop an event of a window (one
    K1 of a pixel replay's 6,976 events, once): a window that lists fewer
    is taken again, up to ``tries`` windows, and one that lists more fails
    at once.  Returns (events, the counts seen, the windows taken)."""
    for window in range(1, tries + 1):
        events = profiled_events(graph.replay, 1)
        seen = {k: sum(k in ev.name for ev in events) for k in want}
        if seen == want:
            return events, seen, window
        if any(seen[k] > want[k] for k in want):
            break
    fail(f"{label}: one replay ran {seen}, expected {want} (window {window} of {tries})")


def kernel_times(fn, reps=5, tries=3):
    """{kernel name: summed device ms per call of ``fn``} (torch.profiler):
    the device's work, where a host clock or CUDA events around an eager
    call of hundreds of kernels measure the host's launch rate.  A window
    in which some kernel's count is not a whole multiple of ``reps`` (the
    profiler dropped events) is taken again."""
    def step():
        for _ in range(reps):
            fn()

    windows = []
    for _ in range(tries):
        sums, counts = {}, {}
        for ev in profiled_events(step, 1):
            sums[ev.name] = sums.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            counts[ev.name] = counts.get(ev.name, 0) + 1
        if counts and all(c % reps == 0 for c in counts.values()):
            return {name: us / 1e3 / reps for name, us in sums.items()}
        windows.append(counts)
    fail(f"the profiler dropped kernels of {reps} calls in {tries} windows: {windows}")


def device_ms(fn, reps=5, name=None):
    """Summed kernel time of one call of ``fn``; ``name``: only the kernels
    whose name holds it."""
    times = kernel_times(fn, reps)
    if name is not None and not any(name in k for k in times):
        fail(f"the profiler recorded no kernel named {name}")
    return sum(ms for k, ms in times.items() if name is None or name in k)


def kernel_case(work, ms, modes, fill, out_size, time_it):
    """K1/K2 vs the plain version on one bank; returns the numbers."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3
    from pixray_tpu_torch.ops.warp_batch import warp_modes_plain

    dev = work.device
    inv = inv3x3(ms.float()).to(dev).contiguous()
    modes = modes.to(dev, torch.int32).contiguous()
    n, c = ms.shape[0], work.shape[2]

    out_k = cuda_warp.launch_fwd(work, inv, modes, fill, out_size)
    out_p = warp_modes_plain(work, inv, modes, fill, out_size)
    torch.cuda.synchronize()
    if out_k.shape != (n, c, out_size, out_size) or not torch.isfinite(out_k).all():
        fail(f"K1 output malformed: {tuple(out_k.shape)}")
    fwd_err = float((out_k - out_p).abs().max())

    g = torch.randn((n, c, out_size, out_size), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    dwork_k = cuda_warp.launch_bwd(g, inv, modes, tuple(work.shape), out_size)
    w_req = work.clone().requires_grad_(True)
    (dwork_p,) = torch.autograd.grad(warp_modes_plain(w_req, inv, modes, fill, out_size), w_req, g)
    torch.cuda.synchronize()
    bwd_err = float((dwork_k - dwork_p).abs().max())
    bwd_tol = BWD_RTOL * max(float(dwork_p.abs().max()), 1e-6)
    res = {"n": n, "s": out_size, "canvas": list(work.shape), "fwd_err": fwd_err,
           "bwd_err": bwd_err, "bwd_tol": bwd_tol}
    if not fwd_err <= FWD_ATOL:
        fail(f"K1 disagrees with the plain warp: {res}")
    if not bwd_err <= bwd_tol:
        fail(f"K2 disagrees with the plain adjoint: {res}")
    if time_it:
        # the plain backward alone: autograd through a forward taken once
        w_plain = work.clone().requires_grad_(True)
        out_plain = warp_modes_plain(w_plain, inv, modes, fill, out_size)

        def plain_bwd():
            torch.autograd.grad(out_plain, w_plain, g, retain_graph=True)

        fwd = lambda: cuda_warp.launch_fwd(work, inv, modes, fill, out_size)
        bwd = lambda: cuda_warp.launch_bwd(g, inv, modes, tuple(work.shape), out_size)
        res.update(
            fwd_ms=median_ms(fwd), fwd_plain_ms=median_ms(lambda: warp_modes_plain(work, inv, modes, fill, out_size)),
            bwd_ms=median_ms(bwd), bwd_plain_ms=median_ms(plain_bwd),
            fwd_kernel_ms=device_ms(fwd, name="bank_fwd_kernel"), bwd_kernel_ms=device_ms(bwd, name="bank_bwd_kernel"),
        )
        # f32 bank and cotangent, the canvas and its gradient, one parameter row per cut
        h, w = work.shape[:2]
        rows, canvas, bank = n * 16 * 4, h * w * c * 4, n * c * out_size ** 2 * 4
        res["fwd_bound"] = bound(canvas + rows + bank, BARE_WARP_FWD_FLOPS_PER_PIXEL * n * out_size ** 2)
        res["bwd_bound"] = bound(bank + rows + canvas, WARP_BWD_FLOPS_PER_PIXEL * n * out_size ** 2)
    return res


def phase_kernels():
    import torch

    from pixray_tpu_torch.engine.cutouts import cut_transforms, draw_cut_params, persp_split

    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    # flagship: the perspective cuts of a 64-cut bank on the 384x216 canvas
    aspect = 384 / 216
    zoom, wide = cut_transforms(draw_cut_params(gen, 64, aspect), 224, aspect)
    nzp, nwp = persp_split(zoom.shape[0])[0], persp_split(wide.shape[0])[0]
    ms = torch.cat([zoom[:nzp], wide[:nwp]])
    modes = torch.tensor([i % 2 for i in range(nzp)] + [3] * nwp, dtype=torch.int32)
    work = torch.rand((224, 224, 3), generator=gen).to(dev)
    flagship = kernel_case(work, ms, modes, 0.37, 224, time_it=True)
    print(f"kernels flagship (N={ms.shape[0]}, S=224, 224x224x3): "
          f"K1 max_abs_err {flagship['fwd_err']:.3g} (tol {FWD_ATOL}), "
          f"K2 max_abs_err {flagship['bwd_err']:.3g} (tol {flagship['bwd_tol']:.3g}); "
          f"fwd {flagship['fwd_ms']:.4f} ms vs plain {flagship['fwd_plain_ms']:.4f} ms, "
          f"bwd {flagship['bwd_ms']:.4f} ms vs plain {flagship['bwd_plain_ms']:.4f} ms", flush=True)

    # the whole 64-cut bank, zoom cuts by reflection or border, wide cuts over a
    # fill: K3c's function at tools/exp8_fwd_kernel.py's shapes (the X1/X2 ablations)
    ms64 = torch.cat([zoom, wide])
    modes64 = torch.tensor([i % 2 for i in range(zoom.shape[0])] + [3] * wide.shape[0], dtype=torch.int32)
    bank64 = kernel_case(work, ms64, modes64, 0.37, 224, time_it=True)
    for name, r in (("flagship", flagship), ("flagship 64", bank64)):
        print(f"kernels {name} times (N={r['n']}, f32 bare warp; ms, kernel / CUDA events of one call): "
              f"K1 {r['fwd_kernel_ms']:.4f} / {r['fwd_ms']:.4f} (bound {r['fwd_bound'][0]:.4f}, {r['fwd_bound'][1]}), "
              f"K2 {r['bwd_kernel_ms']:.4f} / {r['bwd_ms']:.4f} (bound {r['bwd_bound'][0]:.4f}, "
              f"{r['bwd_bound'][1]}); plain {r['fwd_plain_ms']:.4f} / {r['bwd_plain_ms']:.4f}", flush=True)

    zoom, wide = cut_transforms(draw_cut_params(gen, 8, 28 / 20), 17, 28 / 20)
    ms_small = torch.cat([zoom[:3], wide[:2]])
    modes_small = torch.tensor([0, 1, 2, 3, 3], dtype=torch.int32)
    work_small = torch.rand((20, 28, 3), generator=gen).to(dev)
    small = kernel_case(work_small, ms_small, modes_small, 0.6, 17, time_it=False)
    print(f"kernels ragged (N=5, S=17, 20x28x3): K1 max_abs_err {small['fwd_err']:.3g}, "
          f"K2 max_abs_err {small['bwd_err']:.3g} (tol {small['bwd_tol']:.3g})", flush=True)
    return flagship, small, bank64


def phase_warp_batch():
    """``cuda_warp.warp_batch`` (K3e/K3f's function: one padding mode for
    every cut, K1/K2 as the bare warp) at pixray_tpu/tools/crosscheck.py's
    case: 8 cuts, each a random resized crop of a random perspective (0.4),
    of a 224x597x3 canvas into 224x224, fill 0.5.  Every mode against the
    plain warp on the card (forward bitwise, gradient within BWD_RTOL); the
    reflection case timed with its bounds, the plain version and
    grid_sample."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops import warp as W
    from pixray_tpu_torch.ops.warp_batch import source_coords, warp_modes_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    h, w, s_, n, fill = 224, 597, 224, 8, 0.5
    u = lambda *shape: torch.rand(shape, generator=gen)
    persp = W.random_perspective(h, w, 0.4, u(n, 4, 2))
    crop = W.random_resized_crop(h, w, s_, u(n) * 0.6 + 0.3, u(n) * (math.log(1.2) - math.log(0.85)) + math.log(0.85),
                                 u(n), u(n))
    ms = W.mm3(crop, persp)
    work = torch.rand((h, w, 3), generator=gen).to(dev)
    g = torch.rand((n, 3, s_, s_), generator=gen).to(dev)
    inv = W.inv3x3(ms.float()).to(dev)
    errs = {}
    for mode, code in cuda_warp.PADDING_MODES.items():
        modes = torch.full((n,), code, dtype=torch.int32, device=dev)
        w_k = work.clone().requires_grad_(True)
        out_k = cuda_warp.warp_batch(w_k, ms, s_, mode, fill)
        (d_k,) = torch.autograd.grad(out_k, w_k, g)
        w_p = work.clone().requires_grad_(True)
        out_p = warp_modes_plain(w_p, inv, modes, fill, s_)
        (d_p,) = torch.autograd.grad(out_p, w_p, g)
        errs[mode] = (float((out_k - out_p).abs().max()), float((d_k - d_p).abs().max()),
                      BWD_RTOL * max(float(d_p.abs().max()), 1e-6))
        if not (errs[mode][0] <= FWD_ATOL and errs[mode][1] <= errs[mode][2]):
            fail(f"warp_batch {mode} disagrees with the plain warp: {errs[mode]}")
    w_req = work.clone().requires_grad_(True)
    out = cuda_warp.warp_batch(w_req, ms, s_, "reflection", fill)
    w_plain = work.clone().requires_grad_(True)
    modes = torch.zeros((n,), dtype=torch.int32, device=dev)
    out_plain = warp_modes_plain(w_plain, inv, modes, fill, s_)
    sx, sy = source_coords(inv, s_)
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], dim=-1).contiguous()
    chw = work.permute(2, 0, 1).contiguous()
    chw_req = chw.clone().requires_grad_(True)
    kw_gs = dict(mode="bilinear", padding_mode="reflection", align_corners=False)
    lib_out = torch.nn.functional.grid_sample(chw_req[None].expand(n, -1, -1, -1), grid, **kw_gs)

    def no_grad(fn):
        def call():
            with torch.no_grad():
                fn()
        return call

    timed = {
        "fwd": (no_grad(lambda: cuda_warp.warp_batch(work, ms, s_, "reflection", fill)), "bank_fwd_kernel"),
        "bwd": (lambda: torch.autograd.grad(out, w_req, g, retain_graph=True), "bank_bwd_kernel"),
        "fwd_plain": (no_grad(lambda: warp_modes_plain(work, inv, modes, fill, s_)), None),
        "bwd_plain": (lambda: torch.autograd.grad(out_plain, w_plain, g, retain_graph=True), None),
        "fwd_lib": (no_grad(lambda: torch.nn.functional.grid_sample(chw[None].expand(n, -1, -1, -1), grid,
                                                                     **kw_gs)), None),
        "bwd_lib": (lambda: torch.autograd.grad(lib_out, chw_req, g, retain_graph=True), None),
    }
    res = {"errs": errs}
    for key, (fn, kernel) in timed.items():
        res[key + "_ms"], res[key + "_event_ms"] = device_ms(fn, name=kernel), median_ms(fn)
    rows, canvas, bank = n * 16 * 4, h * w * 3 * 4, n * 3 * s_ * s_ * 4
    res["fwd_bound"] = bound(canvas + rows + bank, BARE_WARP_FWD_FLOPS_PER_PIXEL * n * s_ * s_)
    res["bwd_bound"] = bound(bank + rows + canvas, WARP_BWD_FLOPS_PER_PIXEL * n * s_ * s_)
    t = lambda k: f"{res[k + '_ms']:.4f} / {res[k + '_event_ms']:.4f}"
    print("warp_batch (K3e/K3f) 8 cuts of 224x597x3 into 224, every mode vs the plain warp: "
          + ", ".join(f"{m} fwd {e[0]:.3g} bwd {e[1]:.3g} (tol {e[2]:.3g})" for m, e in errs.items()), flush=True)
    print(f"warp_batch (K3e/K3f) reflection times (ms, kernel / CUDA events of one call): K1 {t('fwd')} (bound "
          f"{res['fwd_bound'][0]:.4f}, {res['fwd_bound'][1]}), K2 {t('bwd')} (bound {res['bwd_bound'][0]:.4f}, "
          f"{res['bwd_bound'][1]}); plain {t('fwd_plain')} / {t('bwd_plain')}; grid_sample {t('fwd_lib')}, "
          f"its input gradient {t('bwd_lib')}", flush=True)
    return res


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in ulps (ordered bit patterns)."""
    import torch

    def key(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    return (key(a) - key(b)).abs()


def bank_case(name, work, ms, modes, fill, out_size, jitter, facs, planes, time_it):
    """The bank's K1/K2 (bf16, jitter, noise) vs the plain version on the
    card: the pre-jitter bank (the jittered cuts' rows, the only ones K1
    writes) bitwise; the bank within BANK_ULPS of the
    plain composition; the canvas gradient within BWD_RTOL of max|dwork| of
    the plain one made with K2's formulas (the explicit jitter adjoint,
    itself within a bf16 ulp of autograd per cotangent, see ADJOINT_ULP)."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.color import jitter_planes_adjoint
    from pixray_tpu_torch.ops.warp import inv3x3
    from pixray_tpu_torch.ops.warp_batch import warp_modes_plain

    dev, bf16 = work.device, torch.bfloat16
    inv = inv3x3(ms.float())
    params = cuda_warp.pack_params(inv, modes, jitter, facs, fill=fill)
    params_dev = params.to(dev)
    n, (h, w, _) = ms.shape[0], work.shape

    out_k, pre_k = cuda_warp.launch_bank_fwd(work, params_dev, out_size, planes, bf16, save_pre=True)
    with torch.no_grad():
        pre_p = warp_modes_plain(work, inv.to(dev), modes.to(dev, torch.int32), fill, out_size).to(bf16)
        out_p = cuda_warp.cutout_bank_plain(work, params, out_size, planes, bf16)
    torch.cuda.synchronize()
    if out_k.shape != (n, 3, out_size, out_size) or not torch.isfinite(out_k.float()).all():
        fail(f"K1 bank malformed on {name}: {tuple(out_k.shape)}")
    ulps = bf16_ulps(out_k, out_p)
    g = torch.randn((n, 3, out_size, out_size), device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    g = g.to(bf16)
    branches = torch.zeros(2, dtype=torch.int32, device=dev)
    dwork_k = cuda_warp.launch_bank_bwd(g, pre_k, params_dev, tuple(work.shape), out_size, branches)
    # the plain references: autograd through the whole composition, and the
    # explicit jitter adjoint (K2's formulas) rounded to bf16, then autograd
    # through the plain warp
    w_req = work.clone().requires_grad_(True)
    out_plain = cuda_warp.cutout_bank_plain(w_req, params, out_size, planes, bf16)
    (dwork_p,) = torch.autograd.grad(out_plain, w_req, g, retain_graph=time_it)
    pre_leaf = pre_p.clone().requires_grad_(True)
    (d_auto,) = torch.autograd.grad(cuda_warp.bank_epilogue_plain(pre_leaf, params, planes), pre_leaf, g)
    u = cuda_warp.unpack_params(params)
    d_exp = torch.stack(jitter_planes_adjoint(*pre_p.unbind(1), u["hue"].to(dev)[:, None, None],
                                              u["sat"].to(dev)[:, None, None], *g.float().unbind(1)), 1)
    d_exp = torch.where(u["apply"].to(dev)[:, None, None, None], d_exp.to(bf16), g)
    w_exp = work.clone().requires_grad_(True)
    (dwork_e,) = torch.autograd.grad(
        warp_modes_plain(w_exp, inv.to(dev), modes.to(dev, torch.int32), fill, out_size).to(bf16), w_exp, d_exp)
    torch.cuda.synchronize()
    adj_diff = (d_exp.float() - d_auto.float()).abs()
    adj_tol = ADJOINT_ULP * d_auto.float().abs() + ADJOINT_CANCEL * g.float().abs().amax(1, keepdim=True)
    scale = max(float(dwork_e.abs().max()), 1e-6)
    local, direct = branches.tolist()
    applied = jitter[2].to(dev)
    jittered = int(jitter[2].sum())
    res = {"name": name, "n": n, "s": out_size, "canvas": [h, w],
           "jittered": jittered, "pre_bitwise": torch.equal(pre_k[applied], pre_p[applied]),
           "ulp_diffs": int((ulps > 0).sum()), "max_ulps": int(ulps.max()), "elements": ulps.numel(),
           "adjoint_diffs": int((adj_diff > 0).sum()), "adjoint_excess": float((adj_diff / adj_tol).max()),
           "fwd_err": float((out_k.float() - out_p.float()).abs().max()),
           "bwd_err": float((dwork_k - dwork_e).abs().max()), "bwd_scale": scale,
           "bwd_tol": BWD_RTOL * scale, "bwd_err_autograd": float((dwork_k - dwork_p).abs().max()),
           "blocks_local": local, "blocks_direct": direct}
    if not res["pre_bitwise"]:
        bad = int((pre_k[applied] != pre_p[applied]).sum())
        fail(f"K1's pre-jitter bank differs from the plain one in {bad} elements on {name}: {res}")
    if not res["max_ulps"] <= BANK_ULPS:
        fail(f"K1's bank differs from the plain composition by {res['max_ulps']} ulps on {name}: {res}")
    if not res["adjoint_excess"] <= 1.0:
        fail(f"the explicit jitter adjoint differs from autograd beyond its tolerance on {name}: {res}")
    if not res["bwd_err"] <= res["bwd_tol"]:
        fail(f"K2 disagrees with the plain gradient on {name}: {res}")
    if time_it:
        # bf16 planes: the noise and the bank of every cut, the pre-jitter
        # bank of the jittered cuts only (K1 writes, K2 reads no other)
        plane, canvas, rows = out_size ** 2 * 2, h * w * 3 * 4, params.numel() * 4
        f_bytes = canvas + rows + 3 * n * plane * 2 + 3 * jittered * plane
        b_bytes = 3 * n * plane + 3 * jittered * plane + rows + canvas
        f_ops = (WARP_FWD_FLOPS_PER_PIXEL * n + JITTER_FWD_FLOPS_PER_PIXEL * jittered) * out_size ** 2
        b_ops = (WARP_BWD_FLOPS_PER_PIXEL * n + JITTER_BWD_FLOPS_PER_PIXEL * jittered) * out_size ** 2

        def plain_fwd():
            with torch.no_grad():
                cuda_warp.cutout_bank_plain(work, params, out_size, planes, bf16)

        def plain_bwd():
            torch.autograd.grad(out_plain, w_req, g, retain_graph=True)

        # the library yardstick: grid_sample over the same cuts' source
        # coordinates (bilinear, reflection about the pixel edges) from the
        # one canvas broadcast over the cuts, the warp without the epilogue;
        # its grid made here
        from pixray_tpu_torch.ops.warp_batch import source_coords

        sx, sy = source_coords(inv.to(dev), out_size)
        grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], dim=-1).contiguous()
        chw = work.permute(2, 0, 1).contiguous()
        chw_req = chw.clone().requires_grad_(True)
        kw_gs = dict(mode="bilinear", padding_mode="reflection", align_corners=False)
        lib_out = torch.nn.functional.grid_sample(chw_req[None].expand(n, -1, -1, -1), grid, **kw_gs)
        g32 = g.float()

        def lib_fwd():
            with torch.no_grad():
                torch.nn.functional.grid_sample(chw[None].expand(n, -1, -1, -1), grid, **kw_gs)

        def lib_bwd():
            torch.autograd.grad(lib_out, chw_req, g32, retain_graph=True)

        timed = {
            "fwd": lambda: cuda_warp.launch_bank_fwd(work, params_dev, out_size, planes, bf16, save_pre=True),
            "bwd": lambda: cuda_warp.launch_bank_bwd(g, pre_k, params_dev, tuple(work.shape), out_size),
            "fwd_plain": plain_fwd, "bwd_plain": plain_bwd, "fwd_lib": lib_fwd, "bwd_lib": lib_bwd,
        }
        for key, fn in timed.items():
            res[f"{key}_ms"], res[f"{key}_event_ms"] = device_ms(fn), median_ms(fn)
        res.update(
            fwd_bound_ms=1e3 * max(f_bytes / HBM_BYTES_PER_S, f_ops / F32_FLOPS),
            fwd_bound_by="bytes" if f_bytes / HBM_BYTES_PER_S >= f_ops / F32_FLOPS else "operations",
            bwd_bound_ms=1e3 * max(b_bytes / HBM_BYTES_PER_S, b_ops / F32_FLOPS),
            bwd_bound_by="bytes" if b_bytes / HBM_BYTES_PER_S >= b_ops / F32_FLOPS else "operations",
            fwd_bytes=f_bytes, bwd_bytes=b_bytes)
    return res


def _tie_canvas(h, w, gen):
    """A canvas with regions that tie: gray (r = g = b), r = g, r = b,
    exact 0 and 1, one channel at the clip bound."""
    import torch

    work = torch.rand((h, w, 3), generator=gen)
    work[: h // 3] = work[: h // 3, :, :1]
    work[h // 3: h // 2, :, 1] = work[h // 3: h // 2, :, 0]
    work[h // 2: 3 * h // 5, :, 2] = work[h // 2: 3 * h // 5, :, 0]
    work[3 * h // 5: 2 * h // 3] = 0.0
    work[2 * h // 3: 3 * h // 4] = 1.0
    work[3 * h // 4: 5 * h // 6, :, 0] = 1.0
    return work


def flagship_bank_inputs(n=64, s=224):
    """The flagship bank's inputs (64 cuts of 224 on the 224x224x3 work
    canvas of the 384x216 canvas, bf16 noise, the jitter drawn with p =
    0.8; or ``n`` cuts of ``s`` on the s x s x 3 canvas), and the
    generators they were drawn from: (gen, gen_dev, (work, ms, modes,
    jitter, facs, planes))."""
    import torch

    from pixray_tpu_torch.engine.cutouts import bank_order, cut_transforms, draw_cut_params, draw_noise
    from pixray_tpu_torch.ops.color import draw_jitter_params

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    gen_dev = torch.Generator(device=dev).manual_seed(0)
    aspect = 384 / 216
    zoom, wide = cut_transforms(draw_cut_params(gen, n, aspect), s, aspect)
    order = bank_order(zoom.shape[0], wide.shape[0])
    ms = torch.cat([zoom, wide])[order]
    modes = torch.tensor([i % 2 for i in range(zoom.shape[0])] + [3] * wide.shape[0], dtype=torch.int32)[order]
    jitter = draw_jitter_params(gen, n)
    facs, planes = draw_noise(gen, gen_dev, n, s, torch.bfloat16, dev)
    work = torch.rand((s, s, 3), generator=gen).to(dev)
    return gen, gen_dev, (work, ms, modes, jitter, facs, planes)


def phase_bank_no_jitter(with_jitter):
    """K1/K2 on the flagship bank with ``apply`` = 0 on every row, as the
    spot, spot_off and image-prompt banks run them: K1 bitwise against the
    plain composition, K2 (which reads no row of the saved bank) within
    BWD_RTOL of max|dwork| of the plain gradient, each through
    ``cutout_bank`` as the step calls it; and the
    forward-only launch: a canvas that needs no gradient takes one K1, no
    K2, and saves nothing.  ``with_jitter``: phase 3b's flagship numbers,
    printed beside these."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3

    bf16 = torch.bfloat16
    _, _, (work, ms, modes, _jitter, facs, planes) = flagship_bank_inputs()
    n, s, (h, w, _) = ms.shape[0], 224, work.shape
    params = cuda_warp.pack_params(inv3x3(ms.float()), modes, None, facs, fill=0.37)
    params_dev = params.to(work.device)
    w_req = work.clone().requires_grad_(True)
    out_k = cuda_warp.cutout_bank(w_req, params_dev, s, planes, bf16)
    out_p = cuda_warp.cutout_bank_plain(w_req, params, s, planes, bf16)
    g = torch.randn(out_k.shape, device=work.device, generator=torch.Generator(device=work.device).manual_seed(9))
    g = g.to(bf16)
    (dwork_k,) = torch.autograd.grad(out_k, w_req, g)
    (dwork_p,) = torch.autograd.grad(out_p, w_req, g)
    before = dict(cuda_warp.LAUNCHES)
    with torch.no_grad():
        out_f = cuda_warp.cutout_bank(w_req, params_dev, s, planes, bf16)
    launched = {k: cuda_warp.LAUNCHES[k] - before[k] for k in before}
    torch.cuda.synchronize()
    scale = max(float(dwork_p.abs().max()), 1e-6)
    res = {"n": n, "jittered": int(cuda_warp.unpack_params(params)["apply"].sum()),
           "bitwise": torch.equal(out_k, out_p.detach()), "forward_only_bitwise": torch.equal(out_f, out_p.detach()),
           "fwd_err": float((out_k.float() - out_p.detach().float()).abs().max()),
           "bwd_err": float((dwork_k - dwork_p).abs().max()), "bwd_tol": BWD_RTOL * scale,
           "forward_only_launches": launched}
    if res["jittered"] != 0:
        fail(f"the unjittered bank's rows set apply: {res}")
    if not (res["bitwise"] and res["forward_only_bitwise"]):
        fail(f"K1 without jitter differs from the plain composition: {res}")
    if not res["bwd_err"] <= res["bwd_tol"]:
        fail(f"K2 without jitter disagrees with the plain gradient: {res}")
    if launched != dict(dict.fromkeys(launched, 0), warp_fwd=1):
        fail(f"the forward-only bank launched {launched}, expected one K1 and no K2")
    plane, canvas, rows = s * s * 2, h * w * 3 * 4, params.numel() * 4
    timed = {
        "fwd": lambda: cuda_warp.launch_bank_fwd(work, params_dev, s, planes, bf16),
        "bwd": lambda: cuda_warp.launch_bank_bwd(g, None, params_dev, tuple(work.shape), s),
    }
    for key, fn in timed.items():
        res[f"{key}_ms"], res[f"{key}_event_ms"] = device_ms(fn), median_ms(fn)
    res["fwd_bound"] = bound(canvas + rows + 3 * n * plane * 2, WARP_FWD_FLOPS_PER_PIXEL * n * s * s)
    res["bwd_bound"] = bound(3 * n * plane + rows + canvas, WARP_BWD_FLOPS_PER_PIXEL * n * s * s)
    f = with_jitter
    print(f"bank kernels without jitter (flagship, N={n}, S={s}, bf16, apply = 0 on every row, noise): K1 bitwise "
          f"the plain composition {res['bitwise']} (max_abs_err {res['fwd_err']:.3g}); K2 (reads no saved row) "
          f"max_abs_err {res['bwd_err']:.3g} (tol {res['bwd_tol']:.3g}); forward-only (a canvas without "
          f"gradient): launches {launched}, bitwise {res['forward_only_bitwise']}", flush=True)
    print(f"bank kernels without jitter times (ms, summed kernel time / CUDA events of one call): K1, nothing "
          f"saved (the forward-only launch too) {res['fwd_ms']:.4f} / {res['fwd_event_ms']:.4f} (bound "
          f"{res['fwd_bound'][0]:.4f}, {res['fwd_bound'][1]}) beside 3b's K1 {f['fwd_ms']:.4f} / "
          f"{f['fwd_event_ms']:.4f}; K2 {res['bwd_ms']:.4f} / {res['bwd_event_ms']:.4f} (bound "
          f"{res['bwd_bound'][0]:.4f}, {res['bwd_bound'][1]}) beside 3b's K2 {f['bwd_ms']:.4f} / "
          f"{f['bwd_event_ms']:.4f}", flush=True)
    return res


def phase_bank_kernels():
    """K1/K2 with the epilogue at the flagship bank (64 cuts of 224 on the
    224x224x3 work canvas of the 384x216 canvas, bf16, the jitter drawn with
    p = 0.8, noise) and on a ragged tie-rich bank (9 cuts of S = 40 on a
    90x100 canvas with gray, tied, 0 and 1 regions; zoomed-out cuts whose
    footprint overflows shared memory, so both of K2's branches run)."""
    import torch

    from pixray_tpu_torch.engine.cutouts import draw_noise
    from pixray_tpu_torch.ops import warp as W

    dev = torch.device("cuda")
    gen, gen_dev, (work, ms, modes, jitter, facs, planes) = flagship_bank_inputs()
    flagship = bank_case("flagship", work, ms, modes, 0.37, 224, jitter, facs, planes, time_it=True)

    h, w, s = 90, 100, 40
    t = lambda *a: torch.tensor(a, dtype=torch.float32)
    boxes = W.crop_box_transform(t(0.0, 10.0, -120.0, 5.0, 0.0, -140.0), t(0.0, 2.0, -100.0, 20.0, 0.0, -90.0),
                                 t(100.0, 30.0, 350.0, 60.0, 100.0, 380.0), t(90.0, 28.0, 300.0, 50.0, 90.0, 270.0),
                                 s, s)
    persp = W.mm3(W.crop_box_transform(t(5.0, -10.0, 20.0), t(0.0, 10.0, -5.0), t(90.0, 80.0, 60.0),
                                       t(85.0, 70.0, 95.0), s, s),
                  W.random_perspective(h, w, 0.5, torch.rand((3, 4, 2), generator=gen)))
    ms_r = torch.cat([boxes, persp])
    modes_r = torch.tensor([1, 0, 0, 3, 3, 3, 3, 2, 0], dtype=torch.int32)
    jitter_r = (t(0.0, 0.5, 0.1, -0.1, 0.05, 0.0, 1 / 6, -0.05, 0.02),
                t(1.0, 1.0, 0.9, 1.1, 1.0, 1.05, 1.0, 0.95, 1.0),
                torch.tensor([True, True, True, False, True, True, True, True, False]))
    facs_r, planes_r = draw_noise(gen, gen_dev, 9, s, torch.bfloat16, dev)
    facs_r[::3] = 0.0
    work_r = _tie_canvas(h, w, gen).to(dev)
    ragged = bank_case("ragged ties", work_r, ms_r, modes_r, 0.5, s, jitter_r, facs_r, planes_r, time_it=False)
    if not (ragged["blocks_local"] and ragged["blocks_direct"]):
        fail(f"the ragged bank does not run both of K2's branches: {ragged}")
    for r in (flagship, ragged):
        print(f"bank kernels {r['name']} (N={r['n']}, S={r['s']}, {r['canvas'][0]}x{r['canvas'][1]}x3, bf16, "
              f"{r['jittered']} cuts jittered, noise): pre-jitter bank of the jittered cuts bitwise "
              f"{r['pre_bitwise']}; bank elements one bf16 ulp off the plain composition {r['ulp_diffs']} of "
              f"{r['elements']} (max {r['max_ulps']} ulps, tol {BANK_ULPS}); explicit jitter adjoint vs autograd: "
              f"{r['adjoint_diffs']} bf16 cotangents apart, at most {r['adjoint_excess']:.3g} of the tolerance "
              f"(one ulp + {ADJOINT_CANCEL} max|g|); K2 max_abs_err {r['bwd_err']:.3g} against max|dwork| "
              f"{r['bwd_scale']:.3g} (tol {r['bwd_tol']:.3g}), against autograd's {r['bwd_err_autograd']:.3g}; "
              f"K2 blocks summing in shared memory {r['blocks_local']}, adding to device memory "
              f"{r['blocks_direct']}", flush=True)
    f = flagship
    t = lambda k: f"{f[k + '_ms']:.4f} / {f[k + '_event_ms']:.4f}"
    print(f"bank kernels flagship times (ms, summed kernel time / CUDA events of one call): K1 {t('fwd')} "
          f"(bound {f['fwd_bound_ms']:.4f}, {f['fwd_bound_by']}, {f['fwd_bytes'] / 1e6:.2f} MB) vs plain "
          f"composition {t('fwd_plain')} vs grid_sample {t('fwd_lib')}; K2 {t('bwd')} (bound "
          f"{f['bwd_bound_ms']:.4f}, {f['bwd_bound_by']}, {f['bwd_bytes'] / 1e6:.2f} MB) vs plain backward "
          f"{t('bwd_plain')} vs grid_sample input gradient {t('bwd_lib')}", flush=True)
    return flagship, ragged


def phase_bank_sizes(flagship):
    """K1/K2 with the epilogue at the cut sizes of the ResNet towers, on
    banks drawn as the flagship's (jitter p = 0.8, noise, an s x s x 3
    canvas): RN50x4's 288 at best's 12 cuts and at 64, RN50x16's 384 at 64,
    under the flagship's gates, timed beside the plain composition and
    grid_sample, with K2's count of blocks in each accumulation branch
    (a larger cut spans more canvas per 16x16 tile).  ``flagship``: phase
    3b's numbers at 224, printed beside these."""
    import torch

    out = []
    for n, s in BANK_SIZES:
        _, _, (work, ms, modes, jitter, facs, planes) = flagship_bank_inputs(n, s)
        r = bank_case(f"{n} cuts of {s}", work, ms, modes, 0.37, s, jitter, facs, planes, time_it=True)
        out.append(r)
        t = lambda k: f"{r[k + '_ms']:.4f} / {r[k + '_event_ms']:.4f}"
        print(f"bank kernels at {s} (N={n}, S={s}, {s}x{s}x3, bf16, {r['jittered']} cuts jittered, noise): "
              f"pre-jitter bank bitwise {r['pre_bitwise']}; {r['ulp_diffs']} of {r['elements']} bank elements one "
              f"bf16 ulp off (max {r['max_ulps']}, tol {BANK_ULPS}); K2 max_abs_err {r['bwd_err']:.3g} against "
              f"max|dwork| {r['bwd_scale']:.3g} (tol {r['bwd_tol']:.3g}); K2 blocks summing in shared memory "
              f"{r['blocks_local']}, adding to device memory {r['blocks_direct']} (flagship at 224: "
              f"{flagship['blocks_local']}, {flagship['blocks_direct']})", flush=True)
        print(f"bank kernels at {s} times, N={n} (ms, summed kernel time / CUDA events of one call): K1 {t('fwd')} "
              f"(bound {r['fwd_bound_ms']:.4f}, {r['fwd_bound_by']}, {r['fwd_bytes'] / 1e6:.2f} MB) vs plain "
              f"composition {t('fwd_plain')} vs grid_sample {t('fwd_lib')}; K2 {t('bwd')} (bound "
              f"{r['bwd_bound_ms']:.4f}, {r['bwd_bound_by']}, {r['bwd_bytes'] / 1e6:.2f} MB) vs plain backward "
              f"{t('bwd_plain')} vs grid_sample input gradient {t('bwd_lib')}", flush=True)
    torch.cuda.empty_cache()  # the plain compositions' autograd buffers at 384 (~8 GB) go back to the card
    return out


def stroke_bounds(samples, widths, colors, h, w, state, chunk):
    """Bounds of K4, K4s and K5 on one scene: {kernel: (ms, "bytes" or
    "operations")}, and the counts they rest on.  The function needs a
    (pixel, stroke) pair only where the pixel centre lies in the stroke's
    margined bbox, and a (pixel, segment) distance only where it lies in the
    segment's: past the margin coverage is 0 and the segment cannot hold a
    covering minimum.  Forward: STROKE_FLOPS_PER_SEGMENT per near (pixel,
    segment) pair and STROKE_FLOPS_PER_PAIR per kept pair, alpha-0 strokes
    left out.  Backward: each near distance once, STROKE_BWD_FLOPS_PER_PAIR
    per kept pair and STROKE_BWD_FLOPS_PER_RAMP per pair on the
    anti-aliasing ramp (0 < coverage < 1, alpha != 0).  Bytes: each input
    read and each output written once, the saved state as K4s writes it and
    K5 reads it (each tile's count, its list and its used chunk-entry
    canvases); also the pairs of the tile-level test alone."""
    import torch

    from pixray_tpu_torch.ops.strokes import TILE, pack_meta, stroke_coverage

    dev = samples.device
    n, p = samples.shape[:2]
    meta = pack_meta(samples, widths, colors)
    painted = meta[:, 4] != 0
    ys = torch.arange(h, device=dev, dtype=torch.float32) + 0.5
    xs = torch.arange(w, device=dev, dtype=torch.float32) + 0.5

    def centres_in(lo, hi):  # boxes (..., 2) -> the pixel centres inside each
        in_x = ((lo[..., 0, None] <= xs) & (xs <= hi[..., 0, None])).sum(-1)
        in_y = ((lo[..., 1, None] <= ys) & (ys <= hi[..., 1, None])).sum(-1)
        return in_x * in_y

    per_stroke = centres_in(meta[:, 5:7], meta[:, 7:9])
    margin = (widths / 2.0 + 1.0)[:, None, None]
    a, b = samples[:, :-1], samples[:, 1:]
    per_segment = centres_in(torch.minimum(a, b) - margin, torch.maximum(a, b) + margin).sum(1)
    ramp, step = 0, max(1, (1 << 26) // ((p - 1) * h * w))
    with torch.no_grad():
        for i in range(0, n, step):
            cov = stroke_coverage(samples[i:i + step], widths[i:i + step], h, w)
            ramp += int(((cov > 0) & (cov < 1) & painted[i:i + step, None, None]).sum())
    pairs_fwd, pairs_bwd = int(per_stroke[painted].sum()), int(per_stroke.sum())
    near_fwd, near_bwd = int(per_segment[painted].sum()), int(per_segment.sum())
    counts = state.counts.long()
    th, tw = TILE
    ty, tx = torch.arange(0, h, th, device=dev), torch.arange(0, w, tw, device=dev)
    tile_pix = ((h - ty).clamp(max=th)[:, None] * (w - tx).clamp(max=tw)[None, :]).reshape(-1)
    slots = int(((counts + chunk - 1) // chunk).sum())
    state_bytes = 4 * (counts.numel() + int(counts.sum())) + 4 * 4 * th * tw * slots
    canvas = 4 * h * w * 4
    strokes = 4 * (samples.numel() + 5 * n + 4 * n)  # samples, widths + colors, the samples' box
    fwd_ops = STROKE_FLOPS_PER_SEGMENT * near_fwd + STROKE_FLOPS_PER_PAIR * pairs_fwd
    bwd_ops = (STROKE_FLOPS_PER_SEGMENT * near_bwd + STROKE_BWD_FLOPS_PER_PAIR * pairs_bwd
               + STROKE_BWD_FLOPS_PER_RAMP * ramp)
    work = {
        "fwd": (strokes + 2 * canvas, fwd_ops),
        "store": (strokes + 2 * canvas + state_bytes, fwd_ops),
        "bwd": (strokes + state_bytes + 2 * canvas + 4 * (samples.numel() + 5 * n), bwd_ops),
    }
    bounds = {k: (1e3 * max(b / HBM_BYTES_PER_S, o / F32_FLOPS),
                  "bytes" if b / HBM_BYTES_PER_S >= o / F32_FLOPS else "operations") for k, (b, o) in work.items()}
    return {"bounds": bounds, "pairs_fwd": pairs_fwd, "pairs_bwd": pairs_bwd, "near_fwd": near_fwd,
            "near_bwd": near_bwd, "ramp": ramp, "state_bytes": state_bytes,
            "pairs_tile": int((counts * tile_pix).sum())}


def check_tile_state(name, state, samples, widths, colors, bg_hwc, chunk):
    """K4s's saved state against its plain twins: each tile's list equal to
    tile_stroke_lists, the used chunk-entry tile canvases against
    tile_chunk_canvases.  Returns (max_abs_err of the canvases, list entries,
    canvases compared)."""
    import torch

    from pixray_tpu_torch.ops.strokes import pack_meta, tile_chunk_canvases, tile_stroke_lists

    h, w = bg_hwc.shape[:2]
    with torch.no_grad():
        lists = tile_stroke_lists(pack_meta(samples, widths, colors), h, w)
        plain = tile_chunk_canvases(samples, widths, colors, bg_hwc, lists, chunk=chunk)
    counts = state.counts.cpu().long()
    kernel_lists = state.lists.cpu().long()
    if counts.tolist() != [len(l) for l in lists]:
        fail(f"K4s's list lengths differ from tile_stroke_lists on {name}: "
             f"{counts.tolist()} vs {[len(l) for l in lists]}")
    for t, l in enumerate(lists):
        if not torch.equal(kernel_lists[t, : len(l)], l.cpu()):
            fail(f"K4s's list of tile {t} differs from tile_stroke_lists on {name}")
    slots = plain.shape[1]
    used = torch.arange(slots, device=plain.device)[None] < ((state.counts.long() + chunk - 1) // chunk)[:, None]
    diff = (state.canvases[:, :slots] - plain).abs().amax(dim=(2, 3, 4))
    err = float(diff[used].max()) if bool(used.any()) else 0.0
    return err, int(counts.sum()), int(used.sum())


def stroke_case(name, samples, widths, colors, background, time_it, background_only=False):
    """K4, K4s, K5 vs the plain renderer on one scene: forward, the saved
    tile lists and canvases, and the gradients w.r.t. samples, widths,
    colors and the premultiplied background for a seeded cotangent.
    ``background_only``: every stroke is off the canvas, so the output must
    be the background bitwise, the stroke gradients 0 and dbg == g."""
    import torch

    from pixray_tpu_torch.ops import cuda_strokes
    from pixray_tpu_torch.ops.strokes import composite_premult, premultiply

    dev = samples.device
    bg_hwc = premultiply(background).contiguous()
    bg = bg_hwc.permute(2, 0, 1).contiguous()
    h, w = bg.shape[1:]
    chunk = cuda_strokes.chunk_size(samples.shape[1])
    with torch.no_grad():
        plain = composite_premult(samples, widths, colors, bg_hwc).permute(2, 0, 1)
    g = torch.randn(tuple(bg.shape), device=dev, generator=torch.Generator(device=dev).manual_seed(11))
    leaves = [t.clone().requires_grad_(True) for t in (samples, widths, colors, bg_hwc)]
    out_plain = composite_premult(*leaves)
    plain_grads = torch.autograd.grad(out_plain, leaves, g.permute(1, 2, 0), retain_graph=time_it)
    torch.cuda.synchronize()
    out4 = cuda_strokes.launch_fwd(samples, widths, colors, bg)
    out4s, state = cuda_strokes.launch_fwd(samples, widths, colors, bg, store=True)
    dsamples, dmeta, dbg = cuda_strokes.launch_bwd(g, samples, widths, colors, state)
    torch.cuda.synchronize()
    if out4.shape != plain.shape or not torch.isfinite(out4).all():
        fail(f"K4 output malformed on {name}: {tuple(out4.shape)}")
    canvas_err, listed, slots = check_tile_state(name, state, samples, widths, colors, bg_hwc, chunk)
    r = {"name": name, "n": int(samples.shape[0]), "p": int(samples.shape[1]), "canvas": [h, w], "chunk": chunk,
         "fwd_err": float((out4 - plain).abs().max()), "canvas_err": canvas_err, "listed": listed, "slots": slots}
    r["store_err"] = max(float((out4s - plain).abs().max()), canvas_err)
    bwd = {}
    kernel_grads = (dsamples, dmeta[:, 0], dmeta[:, 1:5], dbg.permute(1, 2, 0))
    for gname, k, p in zip(("samples", "widths", "colors", "bg"), kernel_grads, plain_grads):
        bwd[gname] = (float((k - p).abs().max()), BWD_RTOL * max(float(p.abs().max()), 1e-6))
        if not bwd[gname][0] <= bwd[gname][1]:
            fail(f"K5 d{gname} disagrees with the plain gradient on {name}: {bwd[gname]}; {r}")
    r["bwd"], r["bwd_err"] = bwd, max(e for e, _ in bwd.values())
    if not r["fwd_err"] <= STROKE_FWD_ATOL:
        fail(f"K4 disagrees with the plain renderer on {name}: {r}")
    if not r["store_err"] <= STROKE_FWD_ATOL:
        fail(f"K4s or its saved tile canvases disagree with the plain version on {name}: {r}")
    if background_only:
        exact = (torch.equal(out4, bg) and torch.equal(out4s, bg) and not dsamples.any() and not dmeta.any()
                 and torch.equal(dbg, g) and listed == 0)
        if not exact:
            fail(f"the off-canvas strokes changed the canvas or took a gradient on {name}: {r}")
    if time_it:
        timed = {
            "fwd": lambda: cuda_strokes.launch_fwd(samples, widths, colors, bg),
            "store": lambda: cuda_strokes.launch_fwd(samples, widths, colors, bg, store=True),
            "bwd": lambda: cuda_strokes.launch_bwd(g, samples, widths, colors, state),
        }
        for key, fn in timed.items():
            kernel = "strokes_bwd_kernel" if key == "bwd" else "strokes_fwd_kernel"
            times = kernel_times(fn)
            r[f"{key}_ms"] = sum(ms for k, ms in times.items() if kernel in k)
            r[f"{key}_call_ms"], r[f"{key}_event_ms"] = sum(times.values()), median_ms(fn)
        r.update(stroke_bounds(samples, widths, colors, h, w, state, chunk))

        def plain_fwd():
            with torch.no_grad():
                composite_premult(samples, widths, colors, bg_hwc)

        def plain_bwd():
            torch.autograd.grad(out_plain, leaves, g.permute(1, 2, 0), retain_graph=True)

        for key, fn in (("fwd_plain", plain_fwd), ("bwd_plain", plain_bwd)):
            r[f"{key}_ms"], r[f"{key}_event_ms"] = device_ms(fn, 2), median_ms(fn, 8)
    return r


def _drawer_scene(drawer_cls, settings, seed, background):
    """A drawer's own init, sampled into polylines on the card."""
    import torch

    from pixray_tpu_torch.ops.strokes import sample_paths

    drawer = drawer_cls(settings)
    drawer.snap_canvas(settings.size)
    z = drawer.init_params(torch.Generator().manual_seed(seed))
    dev = torch.device("cuda")
    samples = sample_paths(drawer.model_params["basis"].to(dev), z["points"].to(dev)).contiguous()
    n = samples.shape[0]
    colors = z["colors"].to(dev) if "colors" in z else torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
    return samples, z["widths"].to(dev), colors, background.to(dev)


def _ragged_scene():
    """9 strokes on 40x140 (one partial chunk): one off-canvas, one
    zero-length, two 1-segment strokes with a repeated-endpoint tail (exact
    ties), one with alpha 0, four random; samples built exactly."""
    import numpy as np
    import torch

    rng = np.random.default_rng(3)
    h, w, p = 40, 140, 17
    t = np.linspace(0.0, 1.0, 9)[:, None]

    def cubic_with_tail(c):
        s = ((1 - t) ** 3 * c[0] + 3 * t * (1 - t) ** 2 * c[1] + 3 * t ** 2 * (1 - t) * c[2] + t ** 3 * c[3])
        return np.concatenate([s, np.repeat(s[-1:], p - len(s), 0)])

    strokes = [np.full((p, 2), -500.0), np.tile([70.0, 20.0], (p, 1))]
    strokes += [cubic_with_tail(rng.uniform([0, 0], [w, h], (4, 2))) for _ in range(2)]
    strokes += [np.linspace([30.0, 8.0], [110.0, 30.0], p)]
    strokes += [np.cumsum(rng.uniform(-6, 6, (p, 2)), 0) + rng.uniform([10, 5], [w - 10, h - 5]) for _ in range(4)]
    samples = np.stack(strokes).astype(np.float32)
    widths = rng.uniform(1.0, 8.0, len(strokes)).astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (len(strokes), 4)).astype(np.float32)
    colors[4, 3] = 0.0
    bg = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
    dev = torch.device("cuda")
    return tuple(torch.tensor(a, device=dev) for a in (samples, widths, colors, bg))


def phase_stroke_kernels():
    from types import SimpleNamespace

    import torch

    from pixray_tpu_torch.drawers.clipdraw import ClipDrawer
    from pixray_tpu_torch.drawers.line_sketch import PAPER_COLOR, LineDrawer
    from pixray_tpu_torch.ops.strokes import crowded_scene

    w, h = CLIPDRAW_CONFIG["size"]
    clip_settings = SimpleNamespace(size=[w, h], strokes=1024, min_stroke_width=1, max_stroke_width=5)
    clip_scene = _drawer_scene(ClipDrawer, clip_settings, 0, torch.ones((h, w, 3)))
    flagship = stroke_case("clipdraw", *clip_scene, time_it=True)
    paper = torch.tensor(PAPER_COLOR)

    def line_scene(stroke_length, size):
        settings = SimpleNamespace(size=size, strokes=24, stroke_length=stroke_length, min_stroke_width=0.5,
                                   max_stroke_width=2, allow_paper_color=True)
        return _drawer_scene(LineDrawer, settings, 1, paper.expand(size[1], size[0], 3))

    line = stroke_case("line_sketch", *line_scene(8, [w, h]), time_it=True)
    # long strokes: fewer per chunk, so that K5's chunk fits shared memory
    # (P = 321, just past the P = 294 up to which 16 fit; P = 769, 6 per chunk)
    line_long = stroke_case("line_sketch stroke_length 40", *line_scene(40, [w, h]), time_it=False)
    line_longer = stroke_case("line_sketch stroke_length 96", *line_scene(96, [w // 2, h // 2]), time_it=False)
    ragged = stroke_case("ragged", *_ragged_scene(), time_it=False)
    dev = torch.device("cuda")
    crowded = stroke_case("crowded", *(torch.tensor(a, device=dev) for a in crowded_scene()[2:]), time_it=False)
    # the flagship's strokes moved two canvas widths to the right: the walk alone
    samples, widths, colors, _ = clip_scene
    off_bg = torch.rand((h, w, 4), device=samples.device, generator=torch.Generator(device=samples.device).manual_seed(5))
    off = stroke_case("off-canvas", samples + torch.tensor([2.0 * w, 0.0], device=samples.device), widths, colors,
                      off_bg, time_it=True, background_only=True)
    scenes = (flagship, line, line_long, line_longer, ragged, crowded, off)
    for r in scenes:
        grads = ", ".join(f"d{k} {e:.3g} (tol {tol:.3g})" for k, (e, tol) in r["bwd"].items())
        print(f"stroke kernels {r['name']} (N={r['n']}, P={r['p']}, {r['canvas'][0]}x{r['canvas'][1]}, "
              f"{r['chunk']} strokes per chunk): lists equal tile_stroke_lists ({r['listed']} entries); "
              f"{r['slots']} saved tile canvases max_abs_err {r['canvas_err']:.3g}; K4 max_abs_err "
              f"{r['fwd_err']:.3g}, K4s {r['store_err']:.3g} (tol {STROKE_FWD_ATOL}); K5 {grads}", flush=True)
    print("stroke kernels off-canvas: output equals the background bitwise, stroke gradients 0, dbg == g", flush=True)
    for r in (flagship, line, off):
        k = lambda key: f"{r[key + '_ms']:.4f} ({r[key + '_call_ms']:.4f} / {r[key + '_event_ms']:.4f})"
        b = r["bounds"]
        print(f"stroke kernels {r['name']} times (ms: kernel (the launcher's kernels / CUDA events of one call)): "
              f"K4 {k('fwd')}, K4s {k('store')}, K5 {k('bwd')}; bounds K4 {b['fwd'][0]:.4f} ({b['fwd'][1]}), "
              f"K4s {b['store'][0]:.4f} ({b['store'][1]}), K5 {b['bwd'][0]:.4f} ({b['bwd'][1]}); (pixel, stroke) "
              f"pairs in the stroke's margined bbox {r['pairs_fwd']} forward, {r['pairs_bwd']} backward "
              f"({r['pairs_tile']} by the tile test alone), (pixel, segment) pairs in the segment's "
              f"{r['near_fwd']} / {r['near_bwd']}, on the ramp {r['ramp']}; saved state "
              f"{r['state_bytes'] / 1e6:.3f} MB", flush=True)
        p = lambda key: f"{r[key + '_ms']:.4f} / {r[key + '_event_ms']:.4f}"
        print(f"stroke kernels {r['name']} plain (ms, summed kernel time / CUDA events of one call): forward "
              f"{p('fwd_plain')}, backward {p('bwd_plain')}; no single PyTorch call computes them", flush=True)
    return scenes


def _draws_to(draws, device, dtype):
    """CPU draws with their noise (facs and planes, of every bank) in ``dtype``, the planes on ``device``."""
    def noise(n):
        facs, planes = n
        return facs.to(dtype), [z.to(device, dtype) for z in planes]

    out = []
    for d in draws:
        ps = []
        for p in d["perceptors"]:
            q = dict(p, noise=noise(p["noise"]))
            q.update({k: noise(p[k]) for k in ("spot", "spot_off") if k in p})
            if "image_prompts" in p:
                q["image_prompts"] = [dict(ip, noise=noise(ip["noise"])) for ip in p["image_prompts"]]
            ps.append(q)
        out.append(dict(d, perceptors=ps))
    return out


def wide_codebook_weights(name):
    """The vqgan drawer's seeded random weights for model ``name``, with
    the codebook drawn normal(0, 0.5) instead of the flax initializer's
    uniform [0, 2 / n_embed).  With the latter the clamp box is 2 / n_embed
    wide per dim: one Adam step puts the latent on a corner of it, where
    the nearest code wins by less than rounding, so codes flip between
    the card and the CPU (tiny_test) and from step to step (PERF.md)."""
    import torch

    from pixray_tpu_torch.drawers.vqgan import RANDOM_INIT_SEED
    from pixray_tpu_torch.models.vqgan import VQGAN, VQGAN_CONFIGS, init_random_

    model = init_random_(VQGAN(VQGAN_CONFIGS[name]), torch.Generator().manual_seed(RANDOM_INIT_SEED))
    sd = model.state_dict()
    table = "quantize.embedding.weight"
    sd[table] = torch.randn(sd[table].shape, generator=torch.Generator().manual_seed(1)) * 0.5
    return sd


def phase_agreement(tmp, drawer_config, label, state_dicts=None, renoise=False, **extra):
    """TinyTest on the card vs on the CPU, same latent, weights and draws:
    per-step losses.  Random weights come from fixed seeds, so both engines
    hold the same ones unless ``state_dicts`` gives them.  ``renoise``: the
    drawer re-noises its latent after each step (vdiff), both engines from
    one normal draw of the CPU's."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import tree_map

    cfg = {**drawer_config, "clip_models": "TinyTest", "size": [96, 54], "num_cuts": 8, "iterations": 10,
           "precision": "fp32", "outdir": tmp, **extra}
    cpu = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cpu", state_dicts=state_dicts)
    gpu = Engine(apply_settings(dict(cfg), apply_side_effects=False), device="cuda", state_dicts=state_dicts)
    gpu.z = tree_map(lambda t: t.to("cuda"), cpu.z)
    gpu.opt_state = gpu.optimizer.init(gpu.z)
    for k, v in cpu.drawer_params.items():
        gpu.drawer_params[k] = v.to("cuda")
    diffs = []
    gen = torch.Generator().manual_seed(7)
    for it in range(3):
        draws = cpu.draw_step()
        noise = torch.randn(cpu.z.shape, generator=gen) if renoise else None
        cpu.train(it, draws, renoise=noise)
        gpu.train(it, _draws_to(draws, torch.device("cuda"), torch.bfloat16),
                  renoise=None if noise is None else noise.to("cuda"))
        a = cpu.last_loss_values.numpy()
        b = gpu.last_loss_values.float().cpu().numpy()
        diffs.append(float(abs(a - b).max()))
    worst = max(diffs)
    print(f"agreement TinyTest {label} card vs CPU, 3 steps: max |loss diff| {worst:.3g} per step "
          f"{[float(f'{d:.3g}') for d in diffs]} (tol {AGREE_ATOL})", flush=True)
    if not worst <= AGREE_ATOL:
        fail(f"{label} card run disagrees with the CPU run: {worst}")


def drive_path(config, tmp, steps, warmup, before=None, on_engine=None, state_dicts=None):
    """An Engine on the card, stepped ``steps`` times with a host read of the
    loss after each (as bench.py reads it), blocked unless the config says
    ``steps_per_call`` 1; every launch counter is set to 0 just before the
    steps and read just after.  Returns (engine, losses, launches, init
    seconds, seconds after ``warmup``, steps the device ran in those
    seconds).  A blocked engine dispatches a block at its first step and
    the next one before it, so the steps timed are those dispatched after
    the synchronize at ``warmup`` (every one of them finished by the final
    synchronize), not the steps walked.  ``before``: a dict that receives
    a copy of the initial latent as "z"; ``on_engine``: called with the
    engine before its first step; ``state_dicts``: the engine's weights."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    settings = apply_settings(dict(config, outdir=tmp), apply_side_effects=False)
    t0 = time.perf_counter()
    engine = Engine(settings, device="cuda", state_dicts=state_dicts)
    init_s = time.perf_counter() - t0
    if before is not None:
        before["z"] = engine.z.clone()
    if on_engine is not None:
        on_engine(engine)
    dispatched = lambda it: getattr(engine, "steps_dispatched", it)  # a tree without blocks: one per step

    cuda_warp.reset_launch_counts()
    cuda_strokes.reset_launch_counts()
    losses = []
    for it in range(steps):
        if it == warmup:
            torch.cuda.synchronize()
            t0, first = time.perf_counter(), dispatched(it)
        engine.train(it)
        losses.append(float(engine.last_loss_values.float().sum()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    timed = dispatched(steps) - first
    launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite losses: {losses}")
    return engine, losses, launches, init_s, elapsed, timed


def steps_run(engine, steps):
    """Steps whose kernels launched: ``steps`` and the warm-up step before a capture."""
    blk = engine.step_block
    return steps + (1 if blk is not None and blk.graph is not None else 0)


def check_blocked(label, engine, blocks):
    """The run dispatched exactly ``blocks`` ((first step, steps) each) as graph replays."""
    blk = engine.step_block
    if engine.dispatched_blocks != blocks or (blocks and (blk is None or blk.graph is None)):
        fail(f"{label}: blocks {engine.dispatched_blocks}, expected {blocks} through a captured graph")
    return blk.capture_s if blocks else None


def check_descent(label, losses):
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if not last5 < first5 - 0.005:
        fail(f"{label}: loss did not descend: first5={first5:.4f} last5={last5:.4f}")
    return first5, last5


def check_launches(label, launches, expected):
    for name, want in expected.items():
        got = launches[name]
        if not (got >= 1 if want == "some" else got == want):
            fail(f"{label}: {name} launched {got} times, expected {want}; {launches}")


def check_png(label, path, size=None):
    """The file is a PNG (of ``size`` = (width, height), when given)."""
    if not os.path.exists(path):
        fail(f"{label}: PNG {path} missing")
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{label}: {path} is not a PNG")
    got = (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"))
    if size is not None and got != tuple(size):
        fail(f"{label}: {path} is {got[0]}x{got[1]}, expected {size[0]}x{size[1]}")


# steps 0 (the checkin) eager, then blocks of 8 to the end of the 33 steps
PATH_BLOCKS = [(1 + 8 * k, 8) for k in range(4)]


def phase_main_path(tmp, card):
    steps = WARMUP_STEPS + TIMED_STEPS
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(PIXEL_CONFIG, iterations=steps), tmp,
                                                                  steps, WARMUP_STEPS)
    capture_s = check_blocked("pixel", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    first5, last5 = check_descent("pixel", losses)
    check_launches("pixel", launches, {"warp_fwd": ran, "warp_bwd": ran, "strokes_fwd": 0,
                                       "strokes_fwd_store": 0, "strokes_bwd": 0})
    png = os.path.join(tmp, "output.png")
    check_png("pixel", png)
    rate = timed / elapsed
    print(f"main path: pixel 384x216, ViT-B/32 (random weights), 64 cuts, blocked: init {init_s:.1f} s, "
          f"capture {capture_s:.2f} s, {rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over the {timed} steps "
          f"dispatched after {WARMUP_STEPS} warm-up, on {card}", flush=True)
    print(f"main path losses: first5 {first5:.4f} -> last5 {last5:.4f}; launches {launches}; "
          f"checkin {png}", flush=True)
    return launches, ran


def phase_clipdraw_path(tmp, card):
    steps = WARMUP_STEPS + TIMED_STEPS
    engine, losses, launches, init_s, elapsed, timed = drive_path(
        dict(CLIPDRAW_CONFIG, iterations=steps, save_svg=True), tmp, steps, WARMUP_STEPS)
    capture_s = check_blocked("clipdraw", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    first5, last5 = check_descent("clipdraw", losses)
    check_launches("clipdraw", launches, {"warp_fwd": ran, "warp_bwd": ran, "strokes_fwd_store": ran,
                                          "strokes_bwd": ran, "strokes_fwd": "some"})
    png = os.path.join(tmp, "output.png")
    check_png("clipdraw", png)
    engine.cur_iteration = steps
    engine.run()  # the final checkin, then --save_svg
    svg = os.path.join(tmp, "output.svg")
    if not (os.path.exists(svg) and open(svg).read().count("<path ") == 1024):
        fail("clipdraw: the SVG of --save_svg is missing or incomplete")
    rate = timed / elapsed
    print(f"clipdraw path: 1024 strokes, 384x216, ViT-B/32 (random weights), 64 cuts, blocked: init "
          f"{init_s:.1f} s, capture {capture_s:.2f} s, {rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over the "
          f"{timed} steps dispatched after {WARMUP_STEPS} warm-up, on {card}", flush=True)
    print(f"clipdraw losses: first5 {first5:.4f} -> last5 {last5:.4f}; launches {launches}; "
          f"checkin {png}; svg {svg}", flush=True)
    return launches, ran


def phase_line_sketch(tmp):
    import torch

    from pixray_tpu_torch.drawers.line_sketch import PAPER_COLOR

    config = dict(PIXEL_CONFIG, drawer="line_sketch", allow_paper_color=True, iterations=LINE_SKETCH_STEPS)
    engine, losses, launches, _, _, _ = drive_path(config, tmp, LINE_SKETCH_STEPS, 0)
    check_blocked("line_sketch", engine, [(1, 8)])
    ran = steps_run(engine, LINE_SKETCH_STEPS)
    check_launches("line_sketch", launches, {
        "warp_fwd": ran, "warp_bwd": ran, "strokes_fwd_store": ran, "strokes_bwd": ran, "strokes_fwd": "some"})
    moved = float((engine.z["paper"].cpu() - torch.tensor(PAPER_COLOR)).abs().max())
    if not moved > 0:
        fail("line_sketch: the trainable paper color did not move")
    print(f"line_sketch: 24 strokes x 8 segments (P=65), trainable paper, {LINE_SKETCH_STEPS} steps (1-8 "
          f"one block): "
          f"losses {[round(v, 4) for v in losses]}, paper moved {moved:.3g}; launches {launches}", flush=True)


def keep_block_starts(engine):
    """``dryrun.keep_block_starts`` (at each block's dispatch, the state it
    starts from and its first step's draws), and the host ms of each block
    dispatch, the copies of the state left out.  Returns ({first step:
    {"z", "opt", "draws"}}, host ms per dispatch)."""
    from pixray_tpu_torch.parallel.dryrun import keep_block_starts as keep

    host_ms, dispatch = [], engine._dispatch_block

    def timed_dispatch(cur_it, n):
        t0 = time.perf_counter()
        out = dispatch(cur_it, n)
        host_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    engine._dispatch_block = timed_dispatch
    return keep(engine), host_ms


def state_gap(a, b):
    """The largest gap between two optimizer states, each float tensor's
    max |a - b| over its own max |b| (an integer tensor: 0 if equal, inf
    if not)."""
    from pixray_tpu_torch.engine.optimizers import state_tensors

    worst = 0.0
    for x, y in zip(state_tensors(a), state_tensors(b)):
        if not x.is_floating_point():
            worst = max(worst, 0.0 if bool((x == y).all()) else math.inf)
            continue
        gap = float((x.float() - y.float()).abs().max())
        worst = max(worst, 0.0 if gap == 0.0 else gap / max(float(y.float().abs().max()), 1e-30))
    return worst


def phase_blocked(tmp, config, label, steps, card):
    """``--steps_per_call 8`` against 1 on the card, from one seed, ``steps``
    steps after step 0 (eager in every run: its checkin ends any block).
    A replayed step can be held bitwise to an eager one only from the same
    state: after a step K2's and K5's float atomics part two runs, and
    Adam-like updates turn the bits they part by into whole steps of
    elements whose gradient is ~0, so two eager runs of the pixel row
    differ by up to 2e-3 at a step (PERF.md §6).  So:

    - learning rate on: at each block's dispatch the state it starts from
      and its draws are kept, and the block's first replayed step must give
      the losses of an eager step from them bitwise (every block; its
      forward is deterministic); the latent must have moved;
    - learning-rate scale 0, a blocked and an eager engine from one state:
      every step's losses bitwise (the staged draws, noise, shifts and loss
      slots of each step in the graph), the latent kept bitwise, and the
      optimizer state, which the same gradients but for the atomics' order
      advance every step, within BLOCKED_STATE_RTOL of its largest value.

    Then ``torch.profiler`` over one replay of the graph must list the
    port's kernels once per step and perceptor."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import leaves
    from pixray_tpu_torch.engine.optimizers import state_tensors
    from pixray_tpu_torch.parallel import dryrun

    cfg = dict(config, iterations=steps + 1, outdir=tmp)
    runs = {name: Engine(apply_settings(dict(cfg, steps_per_call=spc), apply_side_effects=False), device="cuda")
            for name, spc in (("blocked", 8), ("blocked0", 8), ("eager0", 1))}
    blocked = runs["blocked"]
    kept, host_ms = keep_block_starts(blocked)
    for engine in runs.values():
        engine.train(0)
    with torch.no_grad():
        for dst, src in zip(leaves(runs["eager0"].z) + state_tensors(runs["eager0"].opt_state),
                            leaves(runs["blocked0"].z) + state_tensors(runs["blocked0"].opt_state)):
            dst.copy_(src)
        for name in ("blocked0", "eager0"):
            runs[name].lr_scale.fill_(0.0)
    z0 = [t.clone() for t in leaves(runs["blocked0"].z)]
    losses, rates = {}, {}
    for name, engine in runs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[name] = []
        for it in range(1, steps + 1):
            engine.train(it)
            losses[name].append(engine.last_loss_values.float().cpu())
        torch.cuda.synchronize()
        rates[name] = steps / (time.perf_counter() - t0)
    blk = blocked.step_block
    expected = [(1 + 8 * k, 8) for k in range(steps // 8)]
    for name in ("blocked", "blocked0"):
        b = runs[name]
        if b.dispatched_blocks != expected or b.step_block is None or b.step_block.graph is None:
            fail(f"blocked {label}: {name} blocks {b.dispatched_blocks}, expected {expected} as graph replays")
    if runs["eager0"].dispatched_blocks:
        fail(f"blocked {label}: the --steps_per_call 1 run dispatched blocks")
    moved = not all(torch.equal(a, b) for a, b in zip(leaves(kept[1]["z"]), leaves(blocked.z)))
    starts = dryrun.block_starts_bitwise(blocked, kept, [None] + losses["blocked"])
    if sorted(starts) != [b for b, _ in expected] or not all(starts.values()) or not moved:
        fail(f"blocked {label}: the first replayed step of each block is not the eager step from the state it "
             f"started from, bitwise: {starts}; the latent moved {moved}")
    same0 = [torch.equal(a, b) for a, b in zip(losses["blocked0"], losses["eager0"])]
    kept0 = all(torch.equal(a, b) and torch.equal(a, c)
                for a, b, c in zip(leaves(runs["blocked0"].z), leaves(runs["eager0"].z), z0))
    gap0 = state_gap(runs["blocked0"].opt_state, runs["eager0"].opt_state)
    if not all(same0) or not kept0:
        fail(f"blocked {label}: with the learning-rate scale at 0 the blocked and eager runs part: losses bitwise "
             f"per step {same0}, latent kept bitwise {kept0}")
    if not gap0 <= BLOCKED_STATE_RTOL:
        fail(f"blocked {label}: with the learning-rate scale at 0 the blocked run's optimizer state is {gap0} of "
             f"its largest value from the eager run's (tol {BLOCKED_STATE_RTOL})")
    # the port's kernels inside one replay: K1 for every bank, K2 for each
    # bank but the forward-only image prompts
    batch_steps = blk.n * blocked.args.batches
    specs = blocked.step_cfg.perceptors
    want = {"bank_fwd_kernel": batch_steps * sum(s.banks for s in specs),
            "bank_bwd_kernel": batch_steps * sum(s.banks - s.n_image_prompts for s in specs)}
    if blocked.args.drawer in ("clipdraw", "line_sketch"):
        want.update(strokes_fwd_kernel=blk.n, strokes_bwd_kernel=blk.n)
    events, seen, windows = replay_events(blk.graph, want, f"blocked {label}")
    # the host's cost of a replay's launch: on an idle card, and behind a running replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blk.graph.replay()
    t1 = time.perf_counter()
    blk.graph.replay()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    print(f"blocked {label}: --steps_per_call 8 vs 1 on the card, {steps} steps after step 0 (blocks {expected}): "
          f"the first replayed step of each block bitwise the eager step from the state it started from {starts}; "
          f"learning-rate scale 0: {sum(same0)} of {steps} steps' losses bitwise, latent kept bitwise {kept0}, "
          f"optimizer state within {gap0:.2g} of its largest value (tol {BLOCKED_STATE_RTOL}); one replay under "
          f"torch.profiler: {seen} (profiler window {windows}; {len(events)} device events, "
          f"{busy_ms(events) / blk.n:.3f} ms device busy per step); capture {blk.capture_s:.3f} s; host ms per block "
          f"dispatch {[round(t, 2) for t in host_ms]} (the first includes the capture); host ms to launch a replay "
          f"{1e3 * (t1 - t0):.3f} on an idle card, {1e3 * (t2 - t1):.3f} behind a running one; steps/s over the "
          f"{steps} steps: blocked {rates['blocked']:.3f} ({steps / (steps / rates['blocked'] - blk.capture_s):.3f} "
          f"without the capture), eager {rates['eager0']:.3f}; on {card}", flush=True)
    return {"replay": seen, "events": events, "n": blk.n}


def graph_node_kinds(graph, path: str) -> dict:
    """{node kind (KERNEL, MEMSET, EVENT_RECORD, ...): count} of a captured
    block's graph, from its ``debug_dump``."""
    import collections
    import re

    graph.debug_dump(path)
    with open(path) as f:
        found = re.findall(r'"graph_\d+_node_\d+"\[[^\n]*label="(?:\{(\w+)|[^\n]*\n(\w+))', f.read())
    return dict(collections.Counter(a or b for a, b in found))


def phase_ranged_blocks(tmp, config, label, card):
    """5c: the device layer ranges (``profiling.time_layers``) on the card.
    Two engines from one seed run ``RANGED_STEPS`` steps after step 0 in
    blocks of 8, the block captured with the ranges off and on.  The ranged
    graph must be the other with one event-record node per event of its
    ranges; its replays must compute what the graph computes without them
    (each block's first replayed step bitwise the eager step from the state
    the block started from, as 5b asks); each ranged block's record must
    hold every range (each tower, the bank, the drawer's ``synth`` as
    ``decoder``) above 0 ms, summing under the ranged steps' wall time.  A
    ranged replay waits for the one before it (its events are read in
    between): the steps/s of both are printed."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine import profiling as P
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.parallel import dryrun

    cfg = dict(config, iterations=RANGED_STEPS + 1, outdir=tmp, steps_per_call=8)
    runs, rates, losses, kinds = {}, {}, {}, {}
    for name in ("off", "on"):
        engine = runs[name] = Engine(apply_settings(cfg, apply_side_effects=False), device="cuda")
        kept = keep_block_starts(engine)[0] if name == "on" else None
        was = P.time_layers(name == "on")
        try:
            engine.train(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[name] = [None]
            for it in range(1, RANGED_STEPS + 1):
                engine.train(it)
                losses[name].append(engine.last_loss_values.float().cpu())
            torch.cuda.synchronize()
            rates[name] = RANGED_STEPS / (time.perf_counter() - t0)
        finally:
            P.time_layers(was)
        capture = engine.step_block.capture_s
        rates[name] = (rates[name], RANGED_STEPS / (RANGED_STEPS / rates[name] - capture))
        check_blocked(f"ranged {label} ({name})", engine, [(1 + 8 * k, 8) for k in range(RANGED_STEPS // 8)])
        kinds[name] = graph_node_kinds(engine.step_block.graph, os.path.join(tmp, f"{name}.dot"))
    on = runs["on"]
    ranges = on.step_block.ranges
    if runs["off"].step_block.ranges is not None or ranges is None or not ranges.pairs:
        fail(f"ranged {label}: the block captured with the ranges off holds ranges, or the one with them on none")
    events = 2 * len(ranges.pairs)  # a backward's begin is its own pair's only: every event is in one pair
    want = dict(kinds["off"], EVENT_RECORD=kinds["off"].get("EVENT_RECORD", 0) + events)
    if kinds["on"] != want:
        fail(f"ranged {label}: the ranged graph's nodes {kinds['on']}, expected the unranged graph's "
             f"{kinds['off']} and {events} event records")
    starts = dryrun.block_starts_bitwise(on, kept, losses["on"])
    if sorted(starts) != [1 + 8 * k for k in range(RANGED_STEPS // 8)] or not all(starts.values()):
        fail(f"ranged {label}: the first replayed step of each ranged block is not the eager step from the state "
             f"it started from, bitwise: {starts}")
    names = {f"tower.{s.name}" for s in on.step_cfg.perceptors} | {"bank", "decoder"}
    records = [b for b in P.BLOCKS if b.engine == on.serial]
    read = [b.device_ms for b in records]
    if (len(read) != RANGED_STEPS // 8 or any(not ms or set(ms) != names or min(ms.values()) <= 0 for ms in read)):
        fail(f"ranged {label}: block ranges read {read}, expected each of {sorted(names)} above 0 in every block")
    per_step = {n: sum(ms[n] for ms in read) / RANGED_STEPS for n in sorted(names)}
    wall_ms = 1e3 / rates["on"][1]
    if not sum(per_step.values()) < wall_ms:
        fail(f"ranged {label}: the ranges sum to {sum(per_step.values()):.3f} ms a step, above the "
             f"{wall_ms:.3f} ms of wall a step")
    print(f"ranged {label}: blocks of 8, {RANGED_STEPS} steps after step 0; graph nodes off {kinds['off']}, on "
          f"{kinds['on']} ({events} event records, {len(ranges.pairs) // 8} ranges a step); first replayed step "
          f"of each ranged block bitwise the eager step from its start {starts}; device ms a step "
          f"{ {n: round(v, 3) for n, v in per_step.items()} }, sum {sum(per_step.values()):.3f} of {wall_ms:.3f} "
          f"ms of wall; steps/s (without the capture) off {rates['off'][1]:.3f}, on {rates['on'][1]:.3f}; on {card}",
          flush=True)


def busy_ms(events):
    """Device busy of a profiler window: the union of its device intervals, ms."""
    busy, cur = 0.0, None
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    return (busy + (0.0 if cur is None else cur[1] - cur[0])) / 1e3


def phase_vqgan_path(tmp, card):
    """The bench's vqgan row, timed as the pixel row is.  Its losses are
    held finite, not to descent: with random weights the latent lives in
    the codebook's 2 / n_embed-wide clamp box, which every Adam step
    crosses, so most tokens change code every step and over 33 steps the
    loss moves by less than the cutouts' noise; the descent gate then
    passes or fails with the seed, and fails at the bench's seed 1
    (PERF.md).  What is held instead: the latent moved, stayed in the
    box, and landed on other codes."""
    steps = WARMUP_STEPS + TIMED_STEPS
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(VQGAN_CONFIG, iterations=steps), tmp,
                                                                  steps, WARMUP_STEPS)
    capture_s = check_blocked("vqgan", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    check_launches("vqgan", launches, {"warp_fwd": 2 * ran, "warp_bwd": 2 * ran, "strokes_fwd": 0,
                                       "strokes_fwd_store": 0, "strokes_bwd": 0})
    drawer = engine.drawer
    quantize = drawer.model.quantize
    z = engine.z.reshape(-1, quantize.codebook.shape[1])
    changed = int((quantize.nearest(z) != quantize.nearest(engine.z_orig_flat.reshape(z.shape))).sum())
    inside = bool(((z >= drawer.z_min) & (z <= drawer.z_max)).all())
    if not (changed and inside):
        fail(f"vqgan: after {steps} steps {changed} of {z.shape[0]} codes changed; latent inside the box: {inside}")
    png = os.path.join(tmp, "output.png")
    check_png("vqgan", png, (384, 208))
    rate = timed / elapsed
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    print(f"vqgan path: imagenet_f16_16384 (random weights) 384x208, ViT-B/32 + ViT-B/16 (random weights), "
          f"64 cuts each, blocked: init {init_s:.1f} s, capture {capture_s:.2f} s, {rate:.3f} steps/s "
          f"({1000 / rate:.2f} ms/step) over the {timed} steps dispatched after {WARMUP_STEPS} warm-up, "
          f"on {card}", flush=True)
    print(f"vqgan losses (finite; not gated on descent): first5 {first5:.4f} -> last5 {last5:.4f}, "
          f"{changed} of {z.shape[0]} codes changed; names {engine.loss_names}; launches {launches}; "
          f"checkin {png}", flush=True)
    return engine


IMAGE_NAMES = ["ViT-B/32:prompt0", "ViT-B/32:prompt1", "ViT-B/32:prompt2", "ViT-B/32:spot0",
               "ViT-B/32:spot_off0", "ViT-B/32:image_prompt0"]  # target, "sunrise", the label "fox"


def phase_image_row(tmp, card):
    """Row 12: the pixel row with the image inputs; blocked vs eager (the
    first replayed step bitwise, the replay's kernels by bank), then the
    row timed as the pixel row is."""
    paths = write_images(tmp)
    config = dict(PIXEL_CONFIG, **image_extra(paths))
    with tempfile.TemporaryDirectory() as sub:
        blocked = phase_blocked(sub, config, "image row (init image, image prompt, spot, spot_off, target, label)",
                                BLOCKED_STEPS, card)
    steps = WARMUP_STEPS + TIMED_STEPS
    with tempfile.TemporaryDirectory() as sub:
        engine, losses, launches, init_s, elapsed, timed = drive_path(dict(config, iterations=steps), sub,
                                                                      steps, WARMUP_STEPS)
    capture_s = check_blocked("image row", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    check_launches("image row", launches, {"warp_fwd": 4 * ran, "warp_bwd": 3 * ran, "strokes_fwd": 0,
                                           "strokes_fwd_store": 0, "strokes_bwd": 0})
    if engine.loss_names != IMAGE_NAMES:
        fail(f"image row: term names {engine.loss_names}, expected {IMAGE_NAMES}")
    rate = timed / elapsed
    events = blocked["events"]
    print(f"image row: pixel 384x216, ViT-B/32 (random weights), 64 cuts, init image, image prompt, spot 'a face' "
          f"and spot_off 'sky' on the package's mask, target image, label 'fox', blocked: init {init_s:.1f} s, "
          f"capture {capture_s:.2f} s, {rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over the {timed} steps "
          f"dispatched after {WARMUP_STEPS} warm-up; one replay: {len(events) / blocked['n']:.1f} device events and "
          f"{busy_ms(events) / blocked['n']:.3f} ms device busy per step; on {card}", flush=True)
    print(f"image row losses (finite): first {[round(v, 4) for v in losses[:3]]} last "
          f"{dict(zip(engine.loss_names, [round(v, 4) for v in engine.last_loss_values.float().tolist()]))}; K1/K2 "
          f"launches per step {launches['warp_fwd'] / ran:.2f} / {launches['warp_bwd'] / ran:.2f} over {ran} steps "
          f"(the warm-up step before the capture included); launches {launches}", flush=True)


def phase_overlay_row(tmp, card):
    """Row 13: the vqgan row from an init image, with an overlay every 4
    steps, an image label and init_weight_pix, in blocks of 4
    (--steps_per_call 4; an overlay every 4 steps leaves no room for 8).
    Every overlay is a pre-step host event: it may start a block, never
    fall inside one.  At each overlay that starts a block, the latent and
    the optimizer state the overlay left (written in place) and the step's
    draws are kept, and an eager step from copies of them must give the
    losses the block's replay gave for that step (within BLOCKED_FLOOR;
    bitwise is expected, as for 5b's first replayed step)."""
    import copy

    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import leaves, tree_map
    from pixray_tpu_torch.engine.schedule import apply_overlay
    from pixray_tpu_torch.engine.step import draws_to_inputs, train_step
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    paths = write_images(tmp)
    config = dict(VQGAN_CONFIG, init_image=paths["init"], overlay_image=paths["overlay"], overlay_every=4,
                  image_labels=paths["label"], init_weight_pix=0.5, steps_per_call=4, iterations=OVERLAY_STEPS,
                  outdir=tmp)
    engine = Engine(apply_settings(config, apply_side_effects=False), device="cuda")
    opt = engine.optimizer
    kept, moved = {}, {}
    overlay, draw = engine.re_average_z, engine.draw_step
    state = {"drawn": 0}

    def keep_overlay():
        before = tree_map(torch.clone, engine.z)
        overlay()
        it = engine.cur_iteration
        moved[it] = max(float((a - b).abs().max()) for a, b in zip(leaves(engine.z), leaves(before)))
        kept[it] = {"z": tree_map(torch.clone, engine.z), "opt": opt.clone(engine.opt_state)}

    def keep_draws(planes_out=None):
        draws = draw(planes_out=planes_out)
        it, state["drawn"] = state["drawn"], state["drawn"] + 1
        if it in kept:
            kept[it]["draws"] = copy.deepcopy(draws)
        return draws

    engine.re_average_z, engine.draw_step = keep_overlay, keep_draws
    cuda_warp.reset_launch_counts()
    cuda_strokes.reset_launch_counts()
    losses = {}
    for it in range(OVERLAY_STEPS):
        engine.cur_iteration = it
        engine.train(it)
        losses[it] = engine.last_loss_values.float().cpu().clone()
    torch.cuda.synchronize()
    launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
    blocks = engine.dispatched_blocks
    overlays = [it for it in range(OVERLAY_STEPS) if apply_overlay(engine.args, it)]
    if blocks != [(4, 4), (8, 4), (12, 4)] or sorted(kept) != overlays or overlays != [0, 4, 8, 12, 16]:
        fail(f"overlay row: blocks {blocks}, overlays {sorted(kept)} (due {overlays})")
    for start, n in blocks:
        inside = [t for t in range(start + 1, start + n) if apply_overlay(engine.args, t)]
        if inside or engine._block_size(start) != n:
            fail(f"overlay row: block {(start, n)} holds overlays {inside} (_block_size {engine._block_size(start)})")
    if not all(v > 0 for v in moved.values()):
        fail(f"overlay row: an overlay left the latent as it was: {moved}")
    checks = {}
    for start, _ in blocks:
        k = kept[start]
        inputs = draws_to_inputs(engine.step_cfg, k["draws"], start, engine.device)
        _, values, _ = train_step(engine.step_cfg, opt, k["z"], k["opt"], engine.lr_scale, inputs)
        diff = float((values.float().cpu() - losses[start]).abs().max())
        checks[start] = (diff, torch.equal(values.float().cpu(), losses[start]))
    worst = max(d for d, _ in checks.values())
    if not worst <= BLOCKED_FLOOR:
        fail(f"overlay row: a replay after an overlay differs from the eager step from the re-encoded latent: {checks}")
    values = torch.stack(list(losses.values()))
    if not bool(torch.isfinite(values).all()):
        fail(f"overlay row: non-finite losses {values.tolist()}")
    names = [f"{m}:prompt0" for m in engine.args.clip_models] + ["image_label0", "init_weight_pix"]
    if engine.loss_names != names:
        fail(f"overlay row: term names {engine.loss_names}, expected {names}")
    ran = steps_run(engine, OVERLAY_STEPS)
    check_launches("overlay row", launches, {"warp_fwd": 2 * ran, "warp_bwd": 2 * ran})
    print(f"overlay row: vqgan 384x208, ViT-B/32 + ViT-B/16, init image, overlay every 4 (alpha 160), image label, "
          f"init_weight_pix 0.5, --steps_per_call 4, {OVERLAY_STEPS} steps: overlays before steps {sorted(kept)} "
          f"(each moved the latent by up to {[round(moved[i], 4) for i in sorted(moved)]}); blocks {blocks}, none "
          f"holding an overlay; the replayed step after each overlay against an eager step from the re-encoded "
          f"latent: max |loss diff| {[float(f'{d:.3g}') for d, _ in checks.values()]}, bitwise "
          f"{[b for _, b in checks.values()]} (tol {BLOCKED_FLOOR}); final losses "
          f"{dict(zip(engine.loss_names, [round(v, 4) for v in values[-1].tolist()]))}; launches {launches}; "
          f"on {card}", flush=True)


ANIM_FRAMES = 3  # seeded 384x216 PNGs: the init, image-prompt and target image globs
ANIM_SAVE_EVERY = 10
ANIM_ITERATIONS = 20  # 2 rounds x 3 frames x 10 steps, a blend between the rounds
ANIM_TERMS = ("prompt0", "target_frame", "image_prompt_frame")  # the JAX package's, per tower
OPTIMIZERS = ("AdamW", "Adagrad", "Adamax", "DiffGrad", "AdamP")
RESUME_STEPS = 24  # the pixel row, checkpointed at 12
RESUME_CLIPDRAW_STEPS = 16  # the clipdraw row, checkpointed at 8
VIDEO_STEPS = 6


def write_anim_frames(tmp):
    """The animation's frame files: seeded 384x216 PNGs ``frame<i>.png`` in ``tmp``; their glob."""
    import numpy as np
    from PIL import Image

    os.makedirs(tmp, exist_ok=True)
    for i in range(ANIM_FRAMES):
        arr = np.random.default_rng(100 + i).integers(0, 256, (216, 384, 3), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(tmp, f"frame{i}.png"))
    return os.path.join(tmp, "frame*.png")


def anim_extra(tmp):
    frames = write_anim_frames(os.path.join(tmp, "frames"))
    return dict(animation_dir=os.path.join(tmp, "anim"), init_image=frames, image_prompts=frames,
                target_images=frames, save_every=ANIM_SAVE_EVERY, iterations=ANIM_ITERATIONS)


def phase_animation_row(tmp, card):
    """Row 15: the pixel row under ``--animation_dir`` (3 frames, 2 rounds of
    10 steps each, blocked).  Blocks stay inside each frame's span; 2 K1
    and 1 K2 per step (the main bank, and the frame's forward-only
    image-prompt bank); for each frame, the first replayed step after the
    frame swap gives the losses of an eager step from a copy of the latent
    and the optimizer state the swap left, and the same draws, bitwise (the
    graph, captured at frame 0, reads the swapped latent and the frame's
    index from its staged inputs); the JAX package's term names; the frame
    PNGs and anim.gif."""
    import copy

    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import tree_map
    from pixray_tpu_torch.engine.step import draws_to_inputs, train_step
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    config = dict(PIXEL_CONFIG, outdir=tmp, **anim_extra(tmp))
    t0 = time.perf_counter()
    engine = Engine(apply_settings(config, apply_side_effects=False), device="cuda")
    init_s = time.perf_counter() - t0
    opt = engine.optimizer
    kept, losses = {}, {}
    dispatch, draw, train = engine._dispatch_block, engine.draw_step, engine.train
    state = {"keep": None}

    def keeping_dispatch(cur_it, n):
        if cur_it % ANIM_SAVE_EVERY == 1:  # a span's first block: the step after the frame's checkin
            key = (engine.cur_anim_index, cur_it)
            kept[key] = {"z": tree_map(torch.clone, engine.z), "opt": opt.clone(engine.opt_state)}
            state["keep"] = key
        return dispatch(cur_it, n)

    def keeping_draws(planes_out=None):
        draws = draw(planes_out=planes_out)
        if state["keep"] is not None:
            kept[state["keep"]]["draws"] = copy.deepcopy(draws)
            state["keep"] = None
        return draws

    def recording_train(it, draws=None):
        out = train(it, draws)
        losses[(engine.cur_anim_index, it)] = engine.last_loss_values.float().cpu().clone()
        return out

    engine._dispatch_block, engine.draw_step, engine.train = keeping_dispatch, keeping_draws, recording_train
    cuda_warp.reset_launch_counts()
    cuda_strokes.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
    steps = ANIM_FRAMES * ANIM_ITERATIONS
    blocks = engine.dispatched_blocks
    want = [(r * ANIM_SAVE_EVERY + 1, 8) for r in range(ANIM_ITERATIONS // ANIM_SAVE_EVERY) for _ in range(ANIM_FRAMES)]
    if blocks != want or engine.step_block is None or engine.step_block.graph is None:
        fail(f"animation row: blocks {blocks}, expected {want} as graph replays")
    if any(s % ANIM_SAVE_EVERY + n > ANIM_SAVE_EVERY for s, n in blocks):
        fail(f"animation row: a block crosses a frame's span: {blocks}")
    ran = steps_run(engine, steps)
    check_launches("animation row", launches, {"warp_fwd": 2 * ran, "warp_bwd": ran, "strokes_fwd": 0,
                                               "strokes_fwd_store": 0, "strokes_bwd": 0})
    names = [f"{engine.args.clip_models[0]}:{t}" for t in ANIM_TERMS]
    if engine.loss_names != names:
        fail(f"animation row: term names {engine.loss_names}, expected {names}")
    values = torch.stack(list(losses.values()))
    if len(losses) != steps or not bool(torch.isfinite(values).all()):
        fail(f"animation row: {len(losses)} steps recorded (expected {steps}), finite {bool(torch.isfinite(values).all())}")
    checks = {}
    for (frame, it), k in sorted(kept.items()):
        inputs = draws_to_inputs(engine.step_cfg, k["draws"], it, engine.device, anim_index=frame)
        _, eager, _ = train_step(engine.step_cfg, opt, k["z"], k["opt"], engine.lr_scale, inputs)
        checks[(frame, it)] = torch.equal(eager.float().cpu(), losses[(frame, it)])
    if sorted(checks) != sorted((f, r * ANIM_SAVE_EVERY + 1) for r in range(2) for f in range(ANIM_FRAMES)) \
            or not all(checks.values()):
        fail(f"animation row: the first replayed step after a frame swap is not the eager step: {checks}")
    anim_dir = engine.args.animation_dir
    for i in range(ANIM_FRAMES):
        check_png("animation row", os.path.join(anim_dir, f"frame{i}.png"), (engine.side_x, engine.side_y))
    with open(os.path.join(anim_dir, "anim.gif"), "rb") as f:
        if f.read(4) != b"GIF8":
            fail("animation row: anim.gif is not a GIF")
    blk = engine.step_block
    events = profiled_events(blk.graph.replay, 1)
    n = blk.n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):  # back to back: the replays' wall, the card's rate on a blocked span
        blk.graph.replay()
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t0) / (4 * n)
    print(f"animation row: pixel 384x216, ViT-B/32 (random weights), 64 cuts, 'sunrise', {ANIM_FRAMES} frames (init, "
          f"image-prompt and target globs), save_every {ANIM_SAVE_EVERY}, {ANIM_ITERATIONS} iterations: {steps} steps "
          f"in {wall:.2f} s ({steps / wall:.3f} steps/s with the checkins, the frame swaps, the blend and the GIFs); "
          f"init {init_s:.1f} s, capture {engine.step_block.capture_s:.2f} s; blocks {blocks}; the first replayed step "
          f"after each frame swap bitwise the eager step: {checks}; one replay: {len(events) / n:.1f} device events and "
          f"{busy_ms(events) / n:.3f} ms device busy per step; 4 replays back to back: {replay_ms:.3f} ms per step "
          f"({1e3 / replay_ms:.3f} steps/s); K1/K2 per step {launches['warp_fwd'] / ran:.2f} / "
          f"{launches['warp_bwd'] / ran:.2f} over {ran} steps (the warm-up step before the capture included); "
          f"launches {launches}; on {card}", flush=True)
    print(f"animation row losses (finite): last {dict(zip(engine.loss_names, [round(v, 4) for v in values[-1].tolist()]))}"
          f"; frames {sorted(os.listdir(anim_dir))}", flush=True)
    return {"launches": launches, "ran": ran}


def phase_optimizers(tmp, card):
    """Row 16: the pixel row under each of the other optimizers, blocked
    against eager as in 5b (one K1 and one K2 per step in the replay), over
    one block of 8 steps after step 0, as vqgan's row."""
    for name in OPTIMIZERS:
        with tempfile.TemporaryDirectory(dir=tmp) as sub:
            phase_blocked(sub, dict(PIXEL_CONFIG, optimiser=name), f"optimiser {name} (pixel)", 8, card)


def _resume_case(tmp, label, config, steps, every, card):
    """``config`` run ``steps`` steps with ``--checkpoint_every every`` (the
    straight run, which writes the checkpoint on the way), and a fresh
    engine resumed from the checkpoint run to the end, twice: with the
    learning rate on and with the learning-rate scale at 0 from step 1.
    The restored latent, optimizer state, LR scale and the three
    generators equal the straight run's at the checkpoint bitwise, and so
    do the first resumed step's losses.  After that step K2's and K5's
    float atomics part two runs from one state (as in 5b), so the steps
    after it are held at scale 0: every resumed step's losses and the final
    latent bitwise the straight run's, the optimizer state within
    BLOCKED_STATE_RTOL of its largest value."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine
    from pixray_tpu_torch.engine.latent import leaves
    from pixray_tpu_torch.engine.optimizers import state_tensors

    def engine(sub, **extra):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        return Engine(apply_settings(dict(config, iterations=steps, outdir=os.path.join(tmp, sub), **extra),
                                     apply_side_effects=False), device="cuda")

    def run(e, first, last):
        """Steps ``first`` to ``last`` as run() takes them (the final checkin at ``steps``); their losses."""
        out = []
        for it in range(first, last + 1):
            e.train(it)
            if it < steps:
                out.append(e.last_loss_values.float().cpu().clone())
        return out

    def leg(scale):
        sub = f"straight{scale:g}"
        straight = engine(sub, checkpoint_every=every)
        want = run(straight, 0, 0)
        straight.lr_scale.fill_(scale)
        want += run(straight, 1, every)  # through the checkpoint's step
        saved = [t.clone() for t in leaves(straight.z) + state_tensors(straight.opt_state)]
        gens = (straight.gen.get_state(), straight.gen_device.get_state(), straight.lr_scale.clone())
        want += run(straight, every + 1, steps)
        r = engine(f"resumed{scale:g}", resume_from=os.path.join(tmp, sub, "session.ckpt"))
        restored = all(torch.equal(a, b) for a, b in zip(leaves(r.z) + state_tensors(r.opt_state), saved))
        restored &= torch.equal(r.gen.get_state(), gens[0]) and torch.equal(r.gen_device.get_state(), gens[1])
        restored &= torch.equal(r.lr_scale, gens[2]) and r.cur_iteration == every + 1
        if not restored:
            fail(f"resume {label}: the restored state is not the straight run's at step {every} (LR scale {scale:g})")
        got = run(r, every + 1, steps)
        if not torch.equal(got[0], want[every + 1]):
            fail(f"resume {label}: the first resumed step's losses differ from the straight run's (LR scale "
                 f"{scale:g}): {got[0].tolist()} vs {want[every + 1].tolist()}")
        return straight, r, want[every + 1:], got

    straight, r, _, _ = leg(1.0)
    straight0, r0, want0, got0 = leg(0.0)
    same0 = [torch.equal(a, b) for a, b in zip(got0, want0)]
    latent0 = all(torch.equal(a, b) for a, b in zip(leaves(r0.z), leaves(straight0.z)))
    gap0 = state_gap(r0.opt_state, straight0.opt_state)
    if not all(same0) or not latent0 or not gap0 <= BLOCKED_STATE_RTOL:
        fail(f"resume {label}: with the learning-rate scale at 0 the resumed run parts from the straight run: "
             f"losses bitwise per step {same0}, final latent bitwise {latent0}, optimizer state {gap0} of its "
             f"largest value (tol {BLOCKED_STATE_RTOL})")
    z_dev = max(float((a - b).abs().max()) for a, b in zip(leaves(r.z), leaves(straight.z)))
    print(f"resume {label}: {steps} steps with --checkpoint_every {every} against an engine resumed at step "
          f"{every + 1}: restored latent, optimizer state, LR scale and generators bitwise and the first resumed "
          f"step's losses bitwise, at LR scale 1 and 0; at scale 0 {sum(same0)} of {len(same0)} resumed steps' "
          f"losses and the final latent bitwise {latent0}, optimizer state within {gap0:.2g} of its largest value "
          f"(tol {BLOCKED_STATE_RTOL}); at scale 1 the final latent max |diff| {z_dev:.3g} (the atomics); blocks "
          f"straight {straight.dispatched_blocks}, resumed {r.dispatched_blocks}; on {card}", flush=True)


def phase_resume(tmp, card):
    """Row 17: checkpoint and resume on the card (the pixel and clipdraw
    rows), and a checkpoint written on the CPU resumed on the card."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.checkpoint import read_manifest
    from pixray_tpu_torch.engine.core import Engine

    _resume_case(os.path.join(tmp, "pixel"), "pixel row", PIXEL_CONFIG, RESUME_STEPS, RESUME_STEPS // 2, card)
    _resume_case(os.path.join(tmp, "clipdraw"), "clipdraw row (dict latent, per-group Adam)", CLIPDRAW_CONFIG,
                 RESUME_CLIPDRAW_STEPS, RESUME_CLIPDRAW_STEPS // 2, card)
    cfg = {**PIXEL_CONFIG, "clip_models": "TinyTest", "size": [96, 54], "num_cuts": 8, "iterations": 8,
           "precision": "fp32"}
    cpu_dir, gpu_dir = os.path.join(tmp, "cpu"), os.path.join(tmp, "gpu")
    os.makedirs(cpu_dir)
    os.makedirs(gpu_dir)
    cpu = Engine(apply_settings(dict(cfg, outdir=cpu_dir, checkpoint_every=3), apply_side_effects=False), device="cpu")
    for it in range(4):
        cpu.train(it)
    path = os.path.join(cpu_dir, "session.ckpt")
    gpu = Engine(apply_settings(dict(cfg, outdir=gpu_dir, resume_from=path), apply_side_effects=False), device="cuda")
    same = torch.equal(gpu.z.cpu(), cpu.z) and gpu.cur_iteration == read_manifest(path)["iteration"] == 4
    if not same:
        fail("resume: the CPU's checkpoint did not restore its latent and iteration on the card")
    for it in range(4, 9):
        gpu.train(it)
    values = gpu.last_loss_values.float()
    if not bool(torch.isfinite(values).all()):
        fail(f"resume: the card run from the CPU's checkpoint gave non-finite losses {values.tolist()}")
    print(f"resume from a CPU checkpoint (TinyTest pixel 96x54): latent and iteration restored on the card {same}; "
          f"steps 4-8 on the card, final losses {[round(v, 4) for v in values.tolist()]}", flush=True)


def phase_video_and_trace(tmp, card):
    """Row 18: a 6-step pixel run with --make_video writes the per-step
    frames and the video; a --profile_dir run writes a trace that names K1
    and K2."""
    import pixray_tpu_torch as pixray

    video_dir = os.path.join(tmp, "video_run")
    pixray.run(**dict(PIXEL_CONFIG, outdir=video_dir, iterations=VIDEO_STEPS, make_video=True))
    frames = sorted(os.listdir(os.path.join(video_dir, "video")))
    if frames != [f"frame_{i:04d}.png" for i in range(VIDEO_STEPS)]:
        fail(f"make_video: frames {frames}")
    for f in frames:
        check_png("make_video", os.path.join(video_dir, "video", f), tuple(PIXEL_CONFIG["size"]))
    videos = [f for f in ("output.mp4", "output.gif") if os.path.exists(os.path.join(video_dir, f))]
    if not videos:
        fail(f"make_video: no video in {sorted(os.listdir(video_dir))}")
    profile_dir = os.path.join(tmp, "profile")
    trace_run = os.path.join(tmp, "trace_run")
    pixray.run(**dict(PIXEL_CONFIG, outdir=trace_run, iterations=10, profile_dir=profile_dir))
    engine = pixray.get_engine()
    check_blocked("profile_dir", engine, [(1, 8)])
    path = os.path.join(profile_dir, "trace.json")
    if not os.path.exists(path):
        fail(f"profile_dir: no trace in {os.listdir(profile_dir) if os.path.isdir(profile_dir) else profile_dir}")
    with open(path) as f:
        names = [str(e.get("name", "")) for e in json.load(f).get("traceEvents", [])]
    found = {k: sum(k in n for n in names) for k in ("bank_fwd_kernel", "bank_bwd_kernel")}
    if not all(found.values()):
        fail(f"profile_dir: the trace names no K1 or K2: {found}")
    print(f"make_video: {VIDEO_STEPS} steps of the pixel row wrote video/frame_0000-{VIDEO_STEPS - 1:04d}.png and "
          f"{videos[0]}; profile_dir: 10 steps (1-8 one block) wrote {path} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, {len(names)} events) naming K1 {found['bank_fwd_kernel']} and K2 "
          f"{found['bank_bwd_kernel']} times; on {card}", flush=True)


def phase_anim_agreement(tmp):
    """Row 19: the animation row on TinyTest, card against CPU: the same
    latent, weights and draws (the CPU's, fed to the card), every step of
    both rounds, per-step losses within AGREE_ATOL."""
    import torch

    from pixray_tpu_torch.config import apply_settings
    from pixray_tpu_torch.engine.core import Engine

    extra = anim_extra(tmp)
    cfg = {**PIXEL_CONFIG, "clip_models": "TinyTest", "size": [96, 54], "num_cuts": 8, "precision": "fp32",
           "steps_per_call": 1, **extra, "iterations": 4, "save_every": 2}
    engines, losses, queue = {}, {}, []
    for label, device in (("cpu", "cpu"), ("gpu", "cuda")):
        e = engines[label] = Engine(apply_settings(dict(cfg, outdir=os.path.join(tmp, label),
                                                        animation_dir=os.path.join(tmp, label, "anim")),
                                                   apply_side_effects=False), device=device)
        losses[label] = []
        train = e.train

        def recording(it, draws=None, e=e, train=train, out=losses[label]):
            r = train(it, draws)
            out.append(e.last_loss_values.float().cpu().clone())
            return r

        e.train = recording
    cpu, gpu = engines["cpu"], engines["gpu"]
    gpu.z = cpu.z.to(gpu.device)
    gpu.opt_state = gpu.optimizer.init(gpu.z)
    for k, v in cpu.drawer_params.items():
        gpu.drawer_params[k] = v.to(gpu.device)
    draw = cpu.draw_step
    cpu.draw_step = lambda planes_out=None: queue.append(draw()) or queue[-1]
    fed = iter(queue)
    gpu.draw_step = lambda planes_out=None: _draws_to(next(fed), gpu.device, torch.bfloat16)
    cpu.run()
    gpu.run()
    diffs = [float((a - b).abs().max()) for a, b in zip(losses["cpu"], losses["gpu"])]
    worst = max(diffs)
    print(f"agreement TinyTest animation row ({ANIM_FRAMES} frames, 2 rounds of 2 steps) card vs CPU: max |loss diff| "
          f"{worst:.3g} per step {[float(f'{d:.3g}') for d in diffs]} (tol {AGREE_ATOL}); terms {gpu.loss_names}",
          flush=True)
    if len(diffs) != 2 * ANIM_FRAMES * 2 or not worst <= AGREE_ATOL:
        fail(f"animation row card run disagrees with the CPU run: {diffs}")

def phase_rn50_path(tmp, card):
    """The pixel row under RN50 (random weights), timed as the pixel row
    is, with the peak device memory of the run; K1/K2 once per step."""
    import torch

    steps = WARMUP_STEPS + TIMED_STEPS
    torch.cuda.reset_peak_memory_stats()
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(RN50_CONFIG, iterations=steps), tmp,
                                                                  steps, WARMUP_STEPS)
    capture_s = check_blocked("rn50", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    first5, last5 = check_descent("rn50", losses)
    check_launches("rn50", launches, {"warp_fwd": ran, "warp_bwd": ran, "strokes_fwd": 0,
                                      "strokes_fwd_store": 0, "strokes_bwd": 0})
    check_png("rn50", os.path.join(tmp, "output.png"))
    rate = timed / elapsed
    print(f"rn50 path: pixel 384x216, RN50 (random weights), 64 cuts, blocked: init {init_s:.1f} s, capture "
          f"{capture_s:.2f} s, {rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over the {timed} steps dispatched "
          f"after {WARMUP_STEPS} warm-up; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"on {card}", flush=True)
    print(f"rn50 losses: first5 {first5:.4f} -> last5 {last5:.4f} (descends); K1/K2 launches per step "
          f"{launches['warp_fwd'] / ran:.2f} / {launches['warp_bwd'] / ran:.2f} over {ran} steps; launches "
          f"{launches}", flush=True)


def phase_preset_row(tmp, card, config, label):
    """The pixel row under a quality / perceptors preset (its towers, cuts
    and batches), 17 steps (step 0, two blocks of 8): finite losses, each
    tower's prompt term, one K1 and one K2 per tower and batch each step,
    ms per step after step 0 without the capture, peak device memory."""
    import torch

    from pixray_tpu_torch.config import apply_settings

    want = apply_settings(dict(config, outdir=tmp), apply_side_effects=False)
    torch.cuda.reset_peak_memory_stats()
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(config, iterations=PRESET_STEPS), tmp,
                                                                  PRESET_STEPS, 1)
    capture_s = check_blocked(label, engine, [(1, 8), (9, 8)])
    ran = steps_run(engine, PRESET_STEPS)
    per_step = len(want.clip_models) * want.batches
    check_launches(label, launches, {"warp_fwd": per_step * ran, "warp_bwd": per_step * ran, "strokes_fwd": 0,
                                     "strokes_fwd_store": 0, "strokes_bwd": 0})
    names = [f"{m}:prompt0" for m in want.clip_models]
    if engine.loss_names != names or engine.args.clip_models != want.clip_models:
        fail(f"{label}: towers {engine.args.clip_models}, terms {engine.loss_names}; expected {names}")
    sizes = sorted({p.input_resolution for p in engine.perceptors})
    check_png(label, os.path.join(tmp, "output.png"))
    print(f"{label} row: pixel 384x216, towers {','.join(want.clip_models)} (cut sizes {sizes}, random weights), "
          f"{want.num_cuts} cuts, batches {want.batches}, blocked: init {init_s:.1f} s, capture {capture_s:.2f} s, "
          f"{1e3 * (elapsed - capture_s) / timed:.2f} ms per step over the {timed} steps after step 0 (without "
          f"the capture); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; finite losses, "
          f"first {[round(v, 4) for v in losses[:3]]} last {[round(v, 4) for v in losses[-3:]]}; K1/K2 launches "
          f"per step {launches['warp_fwd'] / ran:.2f} / {launches['warp_bwd'] / ran:.2f} over {ran} steps; on "
          f"{card}", flush=True)


TINY_TOWERS = {
    # a ModifiedResNet (width 8, one block per stage) and a timm trunk at
    # 48 px, beside TinyTest's text tower widths: put into the port's tables
    # for the agreement phase only
    "CLIP_CONFIGS": {"TinyRN": dict(name="TinyRN", vision_kind="resnet", vision_width=8,
                                    vision_layers=(1, 1, 1, 1), vision_patch_size=None, vision_heads=4)},
    "SLIP_CONFIGS": {"TinyTimm48": dict(name="TinyTimm48", image_resolution=48, vision_patch_size=16,
                                        vision_style="timm")},
}


def phase_tower_agreement(tmp):
    """The tiny ResNet, the tiny timm trunk and TinyTest in one pixel run,
    card against CPU (as phase 5)."""
    import dataclasses

    from pixray_tpu_torch.models.clip import configs as cfg

    tiny = cfg.CLIP_CONFIGS["TinyTest"]
    added = [(getattr(cfg, table), name) for table, towers in TINY_TOWERS.items() for name in towers]
    for table, towers in TINY_TOWERS.items():
        for name, fields in towers.items():
            getattr(cfg, table)[name] = dataclasses.replace(tiny, **fields)
    try:
        phase_agreement(tmp, PIXEL_CONFIG, "tiny towers (ModifiedResNet 32 px, timm trunk 48 px, TinyTest)",
                        clip_models="TinyRN,TinyTimm48,TinyTest")
    finally:
        for table, name in added:
            del table[name]


def slip_layout(sd):
    """The port's state dict of a timm tower under SLIP's names (the
    inverse of the loader's renaming, checked key by key)."""
    from pixray_tpu_torch.models.clip.checkpoint import _SLIP_BLOCK, _SLIP_PREFIXES, slip_name

    out = {}
    for key, value in sd.items():
        old = key
        if old.startswith("visual.transformer.resblocks."):
            for slip, port in _SLIP_BLOCK:
                old = old.replace(port, slip)
        for slip, port in _SLIP_PREFIXES:
            if old.startswith(port):
                old = slip + old[len(port):]
                break
        if slip_name(old) != key:
            fail(f"no SLIP name for {key}: {old} maps back to {slip_name(old)}")
        out[old] = value
    out["visual.cls_token"] = out["visual.cls_token"].reshape(1, 1, -1)
    out["visual.pos_embed"] = out["visual.pos_embed"][None]
    return out


# bench.py's last row, CONFIGS["vdiff"] (bench.py:108): the vdiff drawer's
# default model (yfcc_2, 968 M parameters, random weights) at 256x256
VDIFF_CONFIG = dict(PIXEL_CONFIG, drawer="vdiff", size=[256, 256])
CC12M_CONFIG = dict(VDIFF_CONFIG, vdiff_model="cc12m_1", clip_models="ViT-B/16")  # conditioned on ViT-B/16
CC12M_STEPS = 5
VDIFF_RECIPE_STEPS = 9  # cogs/pixray_vdiff.yaml cut to 9 steps
VDIFF_PROFILE_STEPS = 3
# the pixel row's settings under the super_resolution drawer (Real-ESRGAN 4x, random weights)
SR_CONFIG = dict(PIXEL_CONFIG, drawer="super_resolution")
# the JAX package's tiny_up_mod takes a 12-wide clip embedding, TinyTest
# gives 32: the agreement runs the same spec 32 wide, put into the port's
# table for that phase only
TINY_UP_MOD32 = dict(clip_embed_dim=32, mapping_width=16, mapping_ff=8, clip_model="TinyTest")
ESRGAN_ATOL = 1e-3  # a tiny RRDBNet in f32 (TF32 off), card against CPU
ESRGAN_REPS = 3


def vdiff_weights(name):
    """The vdiff drawer's seeded random weights for model ``name``, made on
    the CPU (the drawer draws them on its device), for both engines of an
    agreement phase."""
    from pixray_tpu_torch.drawers.vdiff import build_vdiff_model

    model, _, _, _ = build_vdiff_model(name, "cpu")
    return model.state_dict()


def phase_vdiff_agreement(tmp):
    """tiny_up, tiny_up_mod32 (TinyTest's clip embedding) and tiny_test, card
    against CPU as phase 5: the same latent, weights, draws and re-noise
    draws, per-step losses within AGREE_ATOL."""
    from pixray_tpu_torch.models import vdiff_upstream as U

    U.UPSTREAM_SPECS["tiny_up_mod32"] = U.build_spec("tiny_up_mod32", 32, (8, 16), (1,), "modconv", **TINY_UP_MOD32)
    try:
        for name in ("tiny_up", "tiny_up_mod32", "tiny_test"):
            with tempfile.TemporaryDirectory() as sub:
                phase_agreement(sub, VDIFF_CONFIG, f"vdiff {name}", state_dicts={"vdiff": vdiff_weights(name)},
                                renoise=True, vdiff_model=name, vdiff_schedule="log", vdiff_skip=10)
    finally:
        del U.UPSTREAM_SPECS["tiny_up_mod32"]


def watch_vdiff(engine):
    """Wrap the engine's re-noising and optimizer rebuilds: per step (its
    ``post_step`` call) whether the latent changed, and per rebuild the
    step before it, the new state's learning rate and the drawer's."""
    import torch

    record = {"post": [], "opts": []}
    post, build = engine.drawer.post_step, engine._build_optimizer

    def watched_post(z, cur_it, noise):
        before = z.clone()
        out = post(z, cur_it, noise)
        record["post"].append((cur_it, out is not None and not torch.equal(out, before)))
        return out

    def watched_build():
        build()
        record["opts"].append((record["post"][-1][0], float(engine.opt_state.learning_rate),
                               engine.drawer.learning_rate))

    engine.drawer.post_step, engine._build_optimizer = watched_post, watched_build
    return record


def check_vdiff_schedule(label, engine, record, steps):
    """A fresh optimizer after every step from 1 on, at min(sigma / alpha *
    0.001, 0.01) of the step's schedule entry (float32 division, as the
    JAX drawer takes it), and a re-noised latent."""
    import numpy as np

    alphas, sigmas = engine.drawer.alphas_host, engine.drawer.sigmas_host
    want = [min(float(sigmas[i] / np.maximum(alphas[i], np.float32(1e-8))) * 0.001, 0.01) for i in range(1, steps)]
    got = [lr for _, _, lr in record["opts"]]
    if [it for it, _, _ in record["opts"]] != list(range(1, steps)) or got != want:
        fail(f"{label}: optimizer rebuilds {[(it, lr) for it, _, lr in record['opts']]}, expected one after each "
             f"step 1..{steps - 1} at {want}")
    if not all(opt_lr == np.float32(lr) for _, opt_lr, lr in record["opts"]):
        fail(f"{label}: the optimizers' learning rates {[o for _, o, _ in record['opts']]} are not the drawer's")
    renoised = [it for it, changed in record["post"] if changed]
    if renoised != list(range(1, steps)):
        fail(f"{label}: the latent was re-noised after steps {renoised}, expected 1..{steps - 1}")
    return want


def eager_split(engine, first, steps):
    """Host ms enqueueing ``engine.train`` and ms per step until the device
    is done (medians over ``steps`` steps, each ended by a synchronize),
    then device busy and events per step from ``torch.profiler`` over
    ``steps`` more.  Returns (enqueue ms, step ms, busy ms, events, next step)."""
    import torch

    enqueue, total = [], []
    it = first
    torch.cuda.synchronize()
    for _ in range(steps):
        t0 = time.perf_counter()
        engine.train(it)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append(1e3 * (t1 - t0))
        total.append(1e3 * (time.perf_counter() - t0))
        it += 1
    its = iter(range(it, it + steps + 1))
    events = profiled_events(lambda: engine.train(next(its)), steps)
    return (statistics.median(enqueue), statistics.median(total), busy_ms(events) / steps, len(events) / steps,
            it + steps + 1)


def phase_vdiff_path(tmp, card):
    """The bench's vdiff row at full width (yfcc_2 on random weights,
    256x256, "sunrise", ViT-B/32, 64 cuts): 9 warm-up and 24 timed steps,
    every one eager (the drawer re-noises after each); finite losses (the
    bench's gate for this row, bench.py:121), one K1 and one K2 per step,
    a fresh optimizer after every step from 1 on at the schedule's learning
    rate, the latent re-noised, the 256x256 PNG; then the split of a step
    and the device's share."""
    import torch

    steps = WARMUP_STEPS + TIMED_STEPS
    extra = 2 * VDIFF_PROFILE_STEPS + 1
    torch.cuda.reset_peak_memory_stats()
    holder = {}
    engine, losses, launches, init_s, elapsed, timed = drive_path(
        dict(VDIFF_CONFIG, iterations=steps + extra), tmp, steps, WARMUP_STEPS,
        on_engine=lambda e: holder.update(record=watch_vdiff(e)))
    record = holder["record"]
    if engine.dispatched_blocks:
        fail(f"vdiff: blocks {engine.dispatched_blocks}: a drawer with post_step runs eager")
    check_launches("vdiff", launches, {"warp_fwd": steps, "warp_bwd": steps, "strokes_fwd": 0,
                                       "strokes_fwd_store": 0, "strokes_bwd": 0})
    lrs = check_vdiff_schedule("vdiff", engine, record, steps)
    check_png("vdiff", os.path.join(tmp, "output.png"), VDIFF_CONFIG["size"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    enqueue, step_ms, busy, events, _ = eager_split(engine, steps, VDIFF_PROFILE_STEPS)
    rate = timed / elapsed
    n_params = sum(p.numel() for p in engine.drawer.model.parameters())
    print(f"vdiff path: yfcc_2 ({n_params / 1e6:.1f} M parameters, random weights drawn on the card in "
          f"{engine.drawer.init_seconds:.2f} s), 256x256, ViT-B/32 (random weights), 64 cuts, eager: init "
          f"{init_s:.1f} s, {rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over the {timed} steps after "
          f"{WARMUP_STEPS} warm-up; one step {step_ms:.2f} ms, host enqueue {enqueue:.2f} ms, device busy {busy:.2f} "
          f"ms in {events:.1f} device events (medians / {VDIFF_PROFILE_STEPS} profiled steps); peak device memory "
          f"{peak:.2f} GiB; on {card}", flush=True)
    print(f"vdiff losses (finite): first {[round(v, 4) for v in losses[:3]]} last {[round(v, 4) for v in losses[-3:]]}"
          f"; a fresh Adam after each step 1..{steps - 1} at the schedule's rate ({lrs[0]:.3g} .. {lrs[-1]:.3g}); the "
          f"latent re-noised after each; K1/K2 launches per step {launches['warp_fwd'] / steps:.2f} / "
          f"{launches['warp_bwd'] / steps:.2f} over {steps} steps", flush=True)
    return launches, steps


def phase_cc12m(tmp, card):
    """--vdiff_model cc12m_1 --clip_models ViT-B/16 at 256x256, a few steps:
    the clip embedding set, equal to the prompt's normalized ViT-B/16 text
    embedding (one prompt of weight 1), finite losses."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    engine, losses, launches, init_s, elapsed, timed = drive_path(
        dict(CC12M_CONFIG, iterations=CC12M_STEPS + 2 * VDIFF_PROFILE_STEPS + 1), tmp, CC12M_STEPS, 1)
    embed = engine.drawer.model_params.get("clip_embed")
    if embed is None or engine.drawer_params.get("clip_embed") is not embed:
        fail("cc12m: no clip embedding set in the drawer's parameters")
    text = engine.perceptors[0].encode_text("sunrise").float()
    want = text / text.norm(dim=-1, keepdim=True)
    gap = float((embed.float() - want.reshape(embed.shape)).abs().max())
    if not gap <= 1e-5:
        fail(f"cc12m: the clip embedding is {gap} from the normalized prompt embedding")
    check_launches("cc12m", launches, {"warp_fwd": CC12M_STEPS, "warp_bwd": CC12M_STEPS})
    enqueue, step_ms, busy, events, _ = eager_split(engine, CC12M_STEPS, VDIFF_PROFILE_STEPS)
    print(f"cc12m row: cc12m_1 ({sum(p.numel() for p in engine.drawer.model.parameters()) / 1e6:.1f} M parameters, "
          f"random weights), ViT-B/16, 256x256, 64 cuts, eager: init {init_s:.1f} s, {1e3 * elapsed / timed:.2f} ms "
          f"per step over {timed} steps after step 0; one step {step_ms:.2f} ms, host enqueue {enqueue:.2f} ms, "
          f"device busy {busy:.2f} ms in {events:.1f} device events; clip embedding {tuple(embed.shape)} = the normalized prompt "
          f"embedding (max gap {gap:.2g}); finite losses {[round(v, 4) for v in losses]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}", flush=True)
    return launches, CC12M_STEPS


def phase_vdiff_recipe(tmp, card):
    """cogs/pixray_vdiff.yaml as written (quality better: RN50, ViT-B/32,
    ViT-B/16; yfcc_2 on random weights), cut to 9 steps: each tower's term,
    3 K1 and 3 K2 per step, finite losses, the PNG at the recipe's size."""
    import yaml

    from pixray_tpu_torch.utils import get_file_path

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cogs", "pixray_vdiff.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("outdir")
    cfg.update(prompts="sunrise", seed=1, iterations=VDIFF_RECIPE_STEPS, save_intermediates=False)
    engine, losses, launches, init_s, elapsed, timed = drive_path(cfg, tmp, VDIFF_RECIPE_STEPS, 1)
    towers = engine.args.clip_models
    if towers != ["RN50", "ViT-B/32", "ViT-B/16"]:
        fail(f"pixray_vdiff: towers {towers}, quality better asks for RN50, ViT-B/32, ViT-B/16")
    rows = len(engine.loss_names) // len(towers)  # the text prompt, then the default vector prompt
    names = [f"{m}:prompt{i}" for m in towers for i in range(rows)]
    if engine.loss_names != names or rows < 1:
        fail(f"pixray_vdiff: terms {engine.loss_names}, expected {names}")
    n = VDIFF_RECIPE_STEPS
    check_launches("pixray_vdiff", launches, {"warp_fwd": 3 * n, "warp_bwd": 3 * n, "strokes_fwd": 0,
                                              "strokes_fwd_store": 0, "strokes_bwd": 0})
    size = (engine.side_x, engine.side_y)
    check_png("pixray_vdiff", get_file_path(tmp, engine.args.output, ".png"), size)
    print(f"recipe pixray_vdiff: vdiff yfcc_2 {size[0]}x{size[1]} (generated {engine.drawer.gen_width}x"
          f"{engine.drawer.gen_height}), towers {','.join(towers)}, {engine.args.num_cuts} cuts each, eager: init "
          f"{init_s:.1f} s, {1e3 * elapsed / timed:.2f} ms per step over {timed} steps after step 0; terms "
          f"{engine.loss_names}; finite losses; K1/K2 launches per step {launches['warp_fwd'] / n:.2f} / "
          f"{launches['warp_bwd'] / n:.2f}; on {card}", flush=True)
    return launches, n


def conv_flops(model, h, w):
    """Multiply-adds × 2 of an RRDBNet's convolutions at an (h, w) input."""
    import torch

    total = 0
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            scale = {"conv_up1": 2, "conv_up2": 4, "conv_hr": 4, "conv_last": 4}.get(name, 1)  # after the upsamplings
            total += 2 * m.in_channels * m.out_channels * m.kernel_size[0] * m.kernel_size[1] * h * w * scale * scale
    return total


def phase_esrgan(card):
    """The bench's one-shot Real-ESRGAN 4x pass (bench_esrgan_once,
    bench.py:158): 256x256 -> 1024x1024 through the 23-block RRDBNet on
    random weights, in bf16 (the port's rung under --precision bf16) and in
    f32, best of 3, each forced by a host read of the sum as the bench
    does; and a tiny RRDBNet (16 features, 1 block, growth 8) on the card
    against the CPU in f32."""
    import torch

    from pixray_tpu_torch.models.esrgan import RRDBNet, init_random_

    dev = torch.device("cuda")
    tiny = init_random_(RRDBNet(num_feat=16, num_block=1, num_grow_ch=8), torch.Generator().manual_seed(0)).eval()
    x = torch.rand((1, 3, 24, 40), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = tiny(x)
        got = tiny.to(dev)(x.to(dev)).cpu()
    err = float((got - want).abs().max())
    if not (got.shape == (1, 3, 96, 160) and err <= ESRGAN_ATOL):
        fail(f"esrgan: the tiny RRDBNet on the card is {err} from the CPU (tol {ESRGAN_ATOL}), shape {got.shape}")
    model = init_random_(RRDBNet().to(dev), torch.Generator(device=dev).manual_seed(1)).eval().requires_grad_(False)
    img = torch.rand((1, 3, 256, 256), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    flops = conv_flops(model, 256, 256)
    secs = {}
    for dtype in (torch.bfloat16, torch.float32):
        model.to_compute_dtype(dtype)
        with torch.no_grad():
            out = model(img)
            if tuple(out.shape) != (1, 3, 1024, 1024) or not bool(torch.isfinite(out).all()):
                fail(f"esrgan {dtype}: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
            best = math.inf
            for _ in range(ESRGAN_REPS):
                t0 = time.perf_counter()
                float(model(img).sum())
                best = min(best, time.perf_counter() - t0)
        secs[str(dtype).split(".")[-1]] = best
    peak = {"bfloat16": 989e12, "float32": F32_FLOPS}
    print(f"esrgan: the one-shot 4x pass 256x256 -> 1024x1024, RRDBNet 23 blocks (random weights), "
          f"{flops / 1e12:.3f} TFLOP of convolutions: "
          + ", ".join(f"{k} {v:.4f} s ({flops / v / 1e12:.1f} TFLOP/s, bound {flops / peak[k]:.4f} s)"
                      for k, v in secs.items())
          + f"; tiny RRDBNet card vs CPU max |diff| {err:.3g} (tol {ESRGAN_ATOL}); on {card}", flush=True)
    return secs


def phase_sr_path(tmp, card):
    """The super_resolution row: the pixel row's settings (384x216,
    ViT-B/32, 64 cuts) under --drawer super_resolution (the full RRDBNet,
    random weights), blocked, timed as the pixel row: finite losses, one K1
    and one K2 per step, the PNG."""
    steps = WARMUP_STEPS + TIMED_STEPS
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(SR_CONFIG, iterations=steps), tmp,
                                                                  steps, WARMUP_STEPS)
    capture_s = check_blocked("super_resolution", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    check_launches("super_resolution", launches, {"warp_fwd": ran, "warp_bwd": ran, "strokes_fwd": 0,
                                                  "strokes_fwd_store": 0, "strokes_bwd": 0})
    check_png("super_resolution", os.path.join(tmp, "output.png"), SR_CONFIG["size"])
    rate = timed / elapsed
    print(f"super_resolution path: RRDBNet 23 blocks (random weights) from a 96x54 latent to 384x216, ViT-B/32, "
          f"64 cuts, blocked: init {init_s:.1f} s, capture {capture_s:.2f} s, {rate:.3f} steps/s "
          f"({1000 / rate:.2f} ms/step) over the {timed} steps dispatched after {WARMUP_STEPS} warm-up; finite losses "
          f"first {[round(v, 4) for v in losses[:3]]} last {[round(v, 4) for v in losses[-3:]]}; K1/K2 launches per "
          f"step {launches['warp_fwd'] / ran:.2f} / {launches['warp_bwd'] / ran:.2f} over {ran} steps; on {card}",
          flush=True)
    return launches, ran


def phase_checkpoints(tmp):
    """Perceptor checkpoints found on disk: a full-width RN50 state dict in
    OpenAI's layout (seeded random weights, ``torch.save``) as RN50.pt, and
    SLIP_VITB16 in SLIP's DDP layout (``module.`` names, the run's args,
    heads the perceptor does not use) as slip_base_100ep.pt, under
    $PIXRAY_TPU_MODELS: each perceptor built from the file must hold the
    in-memory state dict's weights and give its image embeddings on the
    card (bf16), bitwise."""
    import argparse

    import torch

    from pixray_tpu_torch.models import perceptor as P

    dev = torch.device("cuda")
    env = {k: os.environ.get(k) for k in ("PIXRAY_TPU_MODELS", "PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER")}
    os.environ.update(PIXRAY_TPU_MODELS=tmp, PIXRAY_TPU_ALLOW_DEGRADED_TOKENIZER="1")
    try:
        for name in ("RN50", "SLIP_VITB16"):
            if P._find_checkpoint(name) is not None:
                fail(f"checkpoints: a {name} file exists before the phase wrote one")
            sd = {k: v.contiguous() for k, v in P.Perceptor(name, "cpu").model.state_dict().items()}
            path = os.path.join(tmp, P._CKPT_ALIASES[name][0])
            if name == "RN50":
                torch.save(sd, path)
            else:
                heads = {"logit_scale": torch.tensor(2.0), "image_mlp.layer1.weight": torch.ones(16, 768)}
                torch.save({"epoch": 99, "args": argparse.Namespace(model="SLIP_VITB16"),
                            "state_dict": {f"module.{k}": v for k, v in {**slip_layout(sd), **heads}.items()}}, path)
            t0 = time.perf_counter()
            loaded = P.Perceptor(name, dev, torch.bfloat16)
            load_s = time.perf_counter() - t0
            memory = P.Perceptor(name, dev, torch.bfloat16, state_dict=sd)
            same_weights = all(torch.equal(a, b) for a, b in zip(loaded.model.state_dict().values(),
                                                                  memory.model.state_dict().values()))
            imgs = torch.rand((8, 3, 224, 224), device=dev, generator=torch.Generator(device=dev).manual_seed(5))
            with torch.no_grad():
                a, b = loaded.image_fn(imgs.to(torch.bfloat16)), memory.image_fn(imgs.to(torch.bfloat16))
            if not (same_weights and torch.equal(a, b) and bool(torch.isfinite(a).all())):
                fail(f"checkpoints: {name} from {path} differs from the in-memory state dict: weights "
                     f"{same_weights}, embeddings max |diff| {float((a - b).abs().max())}")
            print(f"checkpoint {name}: {os.path.basename(path)} ({os.path.getsize(path) / 2**20:.1f} MiB) found "
                  f"under $PIXRAY_TPU_MODELS and loaded in {load_s:.1f} s; weights and bf16 image embeddings of 8 "
                  f"cuts bitwise the in-memory state dict's", flush=True)
            os.remove(path)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_vqgan_default(tmp):
    """``pixray_tpu_torch.run`` with its defaults (vqgan, quality normal:
    ViT-B/32 + ViT-B/16, 30 cuts, the init noise resized and encoded, the
    LR dropped at 75%, checkins every 10 with frames), cut to 12 steps."""
    import torch

    import pixray_tpu_torch as pixray
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    cuda_warp.reset_launch_counts()
    cuda_strokes.reset_launch_counts()
    pixray.run(prompts="sunrise", outdir=tmp, seed=1, iterations=DEFAULT_RUN_STEPS)
    launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
    engine = pixray.get_engine()
    args = engine.args
    if (args.drawer, args.clip_models, args.num_cuts, args.init_noise) != (
            "vqgan", ["ViT-B/32", "ViT-B/16"], 30, "pixels"):
        fail(f"default run: settings resolved to {args.drawer}, {args.clip_models}, {args.num_cuts} cuts, "
             f"init_noise {args.init_noise}")
    if args.learning_rate_drops != [8] or engine.tracker.drop_divisor == 1:
        fail(f"default run: no LR drop ({args.learning_rate_drops}, divisor {engine.tracker.drop_divisor})")
    values = engine.last_loss_values.float()
    if not torch.isfinite(values).all():
        fail(f"default run: non-finite losses {values.tolist()}")
    quantize = engine.drawer.model.quantize
    flat = engine.z_orig_flat.reshape(-1, quantize.codebook.shape[1])
    off = float((flat - quantize.codebook[quantize.nearest(flat)]).abs().max())
    if not off < CODEBOOK_ATOL:
        fail(f"default run: the encoded init is {off} off the codebook (tol {CODEBOOK_ATOL})")
    check_png("default run", os.path.join(tmp, "output.png"), (384, 208))
    for it in (0, 10, DEFAULT_RUN_STEPS):
        check_png("default run", os.path.join(tmp, "steps", f"frame_{it:04d}.png"), (384, 208))
    # step 0 (checkin) eager, 1-8 one block ending on the LR drop, 9-11 eager (a truncated span)
    check_blocked("default run", engine, [(1, 8)])
    ran = steps_run(engine, DEFAULT_RUN_STEPS)
    check_launches("default run", launches, {"warp_fwd": 2 * ran, "warp_bwd": 2 * ran,
                                             "strokes_fwd": 0, "strokes_fwd_store": 0, "strokes_bwd": 0})
    steps_dir = os.path.join(tmp, "steps")
    videos = [f for f in ("output.mp4", "output.gif") if os.path.exists(os.path.join(steps_dir, f))]
    if not videos:
        fail(f"default run: no step video in {sorted(os.listdir(steps_dir))}")
    with open(os.path.join(steps_dir, videos[0]), "rb") as f:
        head = f.read(12)
    if not (head[:4] == b"GIF8" if videos[0].endswith(".gif") else head[4:8] == b"ftyp"):
        fail(f"default run: {videos[0]} is not a {videos[0][-3:]} file")
    print(f"default run: vqgan {engine.side_x}x{engine.side_y} (noise resized from {args.size[0]}x{args.size[1]} "
          f"and encoded: {flat.shape[0]} codebook rows, max off {off:.3g}), {args.clip_models}, "
          f"{args.num_cuts} cuts, {DEFAULT_RUN_STEPS} steps (1-8 one block), LR drop at "
          f"{args.learning_rate_drops}; final losses "
          f"{dict(zip(engine.loss_names, [round(v, 4) for v in values.tolist()]))}; frames 0, 10, 12; step video "
          f"steps/{videos[0]}", flush=True)


def phase_fft_path(tmp, card):
    """The bench's fft row (bench.py:97: the fft drawer's fft mode, 256x256,
    ViT-B/32, 64 cuts, no init noise), timed as the pixel row is, gated on
    descent as bench.py:117 gates it."""
    import torch

    steps = WARMUP_STEPS + TIMED_STEPS
    z0 = {}
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(FFT_CONFIG, iterations=steps), tmp,
                                                                  steps, WARMUP_STEPS, before=z0)
    capture_s = check_blocked("fft", engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    check_launches("fft", launches, {"warp_fwd": ran, "warp_bwd": ran, "strokes_fwd": 0,
                                     "strokes_fwd_store": 0, "strokes_bwd": 0})
    moved = float((engine.z - z0["z"]).abs().max())
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    descends = last5 < first5 - 0.005
    check_png("fft", os.path.join(tmp, "output.png"), (256, 256))
    if not (descends and moved > 0 and bool(torch.isfinite(engine.z).all())):
        fail(f"fft: first5 {first5:.4f} -> last5 {last5:.4f} (descent gate 0.005), latent moved {moved:.3g}")
    rate = timed / elapsed
    print(f"fft path: fft drawer (fft mode) 256x256, ViT-B/32 (random weights), 64 cuts, blocked: init "
          f"{init_s:.1f} s, capture {capture_s:.2f} s, {rate:.3f} steps/s ({1000 / rate:.2f} ms/step) over the "
          f"{timed} steps dispatched after {WARMUP_STEPS} warm-up, on {card}", flush=True)
    print(f"fft losses: first5 {first5:.4f} -> last5 {last5:.4f} (descends), latent moved {moved:.3g}; K1/K2 "
          f"launches per step {launches['warp_fwd'] / ran:.2f} / {launches['warp_bwd'] / ran:.2f} over {ran} steps "
          f"(the warm-up step before the capture included); launches {launches}", flush=True)


def tiler_config(recipe, **overrides):
    """``cogs/<recipe>.yaml`` (its quality's towers), no LR drop and
    checkins only at step 0 (so the steps after it run blocked)."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cogs", f"{recipe}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.pop("outdir")
    cfg.update(prompts="a seamless tiled pattern", seed=1, save_every=100000,
               learning_rate_drops=[], save_intermediates=False)
    cfg.update(overrides)
    return cfg


def tiler_names(engine):
    """The term names the recipe's step must give: its filter first, each
    tower's prompts, its custom losses last."""
    args = engine.args
    want_losses = {None: [], "smoothness:0.5": ["loss:SmoothnessLoss:0"]}[args.custom_loss]
    names = engine.loss_names
    prompts = [n for n in names if ":prompt" in n]
    return (names[0] == "filter:WallpaperFilter" and names[len(names) - len(want_losses):] == want_losses
            and {n.split(":")[0] for n in prompts} == set(args.clip_models)
            and len(names) == 1 + len(prompts) + len(want_losses))


def phase_tiler_recipes(tmp, card):
    """cogs/tiler_fft.yaml (vqgan 416x416, wallpaper with edge match 4,
    smoothness clipped), tiler_fft_shift.yaml (fft dwt 720x360, wallpaper
    shift) and tiler_pixel_shift.yaml (pixel 256x128, 64x32 grid, wallpaper
    shift), each for 17 steps under its quality's towers (better: RN50,
    ViT-B/32 and ViT-B/16, 36 cuts each)."""
    for recipe in TILER_RECIPES:
        with tempfile.TemporaryDirectory() as sub:
            config = tiler_config(recipe, iterations=TILER_STEPS)
            engine, losses, launches, init_s, elapsed, timed = drive_path(config, sub, TILER_STEPS, 1)
            capture_s = check_blocked(recipe, engine, [(1, 8), (9, 8)])
            ran = steps_run(engine, TILER_STEPS)
            towers = len(engine.args.clip_models)
            if engine.args.clip_models != ["RN50", "ViT-B/32", "ViT-B/16"]:
                fail(f"{recipe}: towers {engine.args.clip_models}, its quality {config['quality']} asks for "
                     "RN50, ViT-B/32, ViT-B/16")
            check_launches(recipe, launches, {"warp_fwd": towers * ran, "warp_bwd": towers * ran, "strokes_fwd": 0,
                                              "strokes_fwd_store": 0, "strokes_bwd": 0})
            if not tiler_names(engine):
                fail(f"{recipe}: term names {engine.loss_names}")
            size = (engine.side_x, engine.side_y)
            if list(size) != list(config["size"]):
                fail(f"{recipe}: canvas {size}, the recipe asks for {config['size']}")
            check_png(recipe, os.path.join(sub, config["output"]), size)
            blocked = sum(n for _, n in engine.dispatched_blocks)
            print(f"tiler {recipe}: {config['drawer']}{'/' + config['fft_use'] if 'fft_use' in config else ''} "
                  f"{size[0]}x{size[1]}, filters {config['filters']} (type {config.get('wallpaper_type')}, edge "
                  f"match {config.get('wallpaper_edge_match', 0)}), custom loss {config.get('custom_loss')}, "
                  f"{engine.args.num_cuts} cuts per tower, towers {','.join(engine.args.clip_models)} (quality "
                  f"{config['quality']}): {blocked} of {TILER_STEPS} steps blocked; "
                  f"{1e3 * (elapsed - capture_s) / timed:.2f} ms per step over the {timed} steps after step 0 "
                  f"(without the capture, {capture_s:.2f} s); finite losses, last "
                  f"{dict(zip(engine.loss_names, [round(v, 4) for v in engine.last_loss_values.float().tolist()]))}"
                  f"; PNG {config['output']} {size[0]}x{size[1]}; launches {launches}; on {card}", flush=True)


def phase_fft_modes(tmp):
    """The fft drawer's dwt and pixel modes (bench row's shape, 9 steps,
    one block each), the CLI with a filter and a loss, and fast_pixel
    through ``pixray_tpu_torch.run`` (the verify skill's example at
    ViT-B/32)."""
    import torch

    import pixray_tpu_torch as pixray
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp

    for mode in ("dwt", "pixel"):
        with tempfile.TemporaryDirectory() as sub:
            engine, losses, launches, _, _, _ = drive_path(dict(FFT_CONFIG, fft_use=mode, iterations=FFT_MODE_STEPS),
                                                           sub, FFT_MODE_STEPS, 0)
            check_blocked(f"fft {mode}", engine, [(1, 8)])
            ran = steps_run(engine, FFT_MODE_STEPS)
            check_launches(f"fft {mode}", launches, {"warp_fwd": ran, "warp_bwd": ran})
            print(f"fft {mode} mode: 256x256, ViT-B/32, 64 cuts, {FFT_MODE_STEPS} steps (1-8 one block): losses "
                  f"{[round(v, 4) for v in losses]}; launches {launches}", flush=True)
    with tempfile.TemporaryDirectory() as sub:
        cmd = [sys.executable, "-m", "pixray_tpu_torch", "--drawer", "fft", "--fft_use", "dwt", "--filters",
               "wallpaper", "--wallpaper_type", "shift", "--custom_loss", "smoothness:0.5", "--prompts", "sunrise",
               "--clip_models", "ViT-B/32", "--size", "256", "256", "--num_cuts", "64", "--iterations", "9",
               "--save_every", "100", "--seed", "1", "--vector_prompts", "none", "--save_intermediates", "false",
               "--outdir", sub]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        if proc.returncode != 0 or "iter: 9" not in proc.stdout:
            fail(f"the CLI run failed ({proc.returncode}): {proc.stdout[-1500:]} {proc.stderr[-3000:]}")
        check_png("CLI fft dwt", os.path.join(sub, "output.png"), (256, 256))
        last = [line for line in proc.stdout.splitlines() if line.startswith("iter: ")][-1]
        print(f"CLI: python -m pixray_tpu_torch {' '.join(cmd[3:-2])}: exit 0, {last}", flush=True)
    with tempfile.TemporaryDirectory() as sub:
        cuda_warp.reset_launch_counts()
        cuda_strokes.reset_launch_counts()
        pixray.run(prompts="a red circle", drawer="fast_pixel", clip_models="ViT-B/32", size=[48, 48], iterations=6,
                   num_cuts=8, save_every=3, seed=5, vector_prompts="none", outdir=sub)
        launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
        engine = pixray.get_engine()
        values = engine.last_loss_values.float()
        if not bool(torch.isfinite(values).all()):
            fail(f"fast_pixel: non-finite losses {values.tolist()}")
        check_png("fast_pixel", os.path.join(sub, "output.png"), (48, 48))
        check_launches("fast_pixel", launches, {"warp_fwd": 6, "warp_bwd": 6})
        print(f"fast_pixel: {engine.drawer.num_cols}x{engine.drawer.num_rows} grid on 48x48, ViT-B/32, 8 cuts, "
              f"6 steps through pixray_tpu_torch.run (eager: no full block fits): final losses "
              f"{[round(v, 4) for v in values.tolist()]}; launches {launches}", flush=True)


def phase_decoder_times(model):
    """Decode forward and gradient to the latent at the 384x208 canvas's
    24x13x256 latent, and the encoder forward at 384x208, in bf16 (the
    path's model) and in an f32 copy (TF32 off): summed kernel time (the
    device's work) and CUDA-event time of an eager call (bounded below by
    the host's launches)."""
    import copy

    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cb = model.quantize.codebook
    z = cb[torch.randint(0, cb.shape[0], (13 * 24,), device=dev, generator=gen)].reshape(13, 24, -1)
    z = z.permute(2, 0, 1)[None].contiguous()
    x = torch.rand((1, 3, 208, 384), device=dev, generator=gen) * 2 - 1
    out = {}
    for label, m in (("bf16", model), ("f32", copy.deepcopy(model).to_compute_dtype(torch.float32))):
        zr = z.clone().requires_grad_(True)
        y = m.decode_from_continuous(zr)
        g = torch.randn(y.shape, device=dev, generator=gen)

        def fwd():
            with torch.no_grad():
                m.decode_from_continuous(z)

        def enc():
            with torch.no_grad():
                m.encode(x)

        def bwd():
            torch.autograd.grad(y, zr, g, retain_graph=True)

        out[label] = {name: (device_ms(f), median_ms(f, reps=10))
                      for name, f in (("decode forward", fwd), ("gradient to the latent", bwd),
                                      ("encoder forward", enc))}
        out[label]["image"] = y.detach()
    diff = float((out["bf16"].pop("image") - out["f32"].pop("image")).abs().max())
    for label, t in out.items():
        print(f"decoder {label} (kernel sum / CUDA events of an eager call, ms): "
              + ", ".join(f"{name} {k:.4f} / {e:.4f}" for name, (k, e) in t.items())
              + " (decode at the 24x13x256 latent, encoder at 384x208)", flush=True)
    print(f"decoder bf16 vs f32: decoded images differ by max |diff| {diff:.3g}", flush=True)
    return out


def write_style_image(tmp):
    """A seeded 300x400 RGB style image in ``tmp``."""
    import numpy as np
    from PIL import Image

    path = os.path.join(tmp, "style.png")
    rng = np.random.default_rng(12)
    # smooth colour fields plus texture, so the pyramid's levels all carry something
    yy, xx = np.mgrid[0:300, 0:400] / 40.0
    base = np.stack([np.sin(xx), np.cos(yy), np.sin(xx + yy)], -1) * 80 + 128
    arr = np.clip(base + rng.normal(0, 30, base.shape), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return path


def phase_row(tmp, card, config, label, descent=True, grid=None, term=None):
    """One pixel-row variant timed as the pixel row is (9 warm-up and 24
    timed steps, blocked), one K1 and one K2 per step, finite losses (and
    descent as bench.py gates it, where ``descent``), the checkin PNG, the
    drawer's grid (``grid``: (cols, rows)), the loss term ``term`` among
    the step's terms; then one replay under torch.profiler: device busy
    and events per step.  Returns (launches, steps run)."""
    steps = WARMUP_STEPS + TIMED_STEPS
    engine, losses, launches, init_s, elapsed, timed = drive_path(dict(config, iterations=steps), tmp, steps,
                                                                  WARMUP_STEPS)
    capture_s = check_blocked(label, engine, PATH_BLOCKS)
    ran = steps_run(engine, steps)
    check_launches(label, launches, {"warp_fwd": ran, "warp_bwd": ran, "strokes_fwd": 0,
                                     "strokes_fwd_store": 0, "strokes_bwd": 0})
    check_png(label, os.path.join(tmp, "output.png"), (384, 216))
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    if descent:
        check_descent(label, losses)
    if grid is not None and (engine.drawer.num_cols, engine.drawer.num_rows) != grid:
        fail(f"{label}: grid {engine.drawer.num_cols}x{engine.drawer.num_rows}, expected {grid[0]}x{grid[1]}")
    if term is not None and term not in engine.loss_names:
        fail(f"{label}: no {term} among the terms {engine.loss_names}")
    blk = engine.step_block
    events, _, windows = replay_events(blk.graph, {"bank_fwd_kernel": blk.n, "bank_bwd_kernel": blk.n}, label)
    rate = timed / elapsed
    print(f"{label}: blocked: init {init_s:.1f} s, capture {capture_s:.2f} s, {rate:.3f} steps/s "
          f"({1000 / rate:.2f} ms per blocked step) over the {timed} steps dispatched after {WARMUP_STEPS} warm-up; "
          f"one replay (profiler window {windows}): {len(events) / blk.n:.1f} device events and "
          f"{busy_ms(events) / blk.n:.3f} ms device busy per step; K1/K2 launches per step "
          f"{launches['warp_fwd'] / ran:.2f} / {launches['warp_bwd'] / ran:.2f} over {ran} steps (the warm-up step "
          f"before the capture included); on {card}", flush=True)
    by_name = {}
    for ev in events:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / blk.n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label} split: the replay's costliest kernels, ms per step: "
          f"{[(name[:60], round(ms, 3)) for name, ms in top]}", flush=True)
    print(f"{label} losses: first5 {first5:.4f} -> last5 {last5:.4f}{' (descends)' if descent else ''}; last "
          f"{dict(zip(engine.loss_names, [round(v, 5) for v in engine.last_loss_values.float().tolist()]))}",
          flush=True)
    return launches, ran


def phase_geometry_rows(tmp, card):
    """The pixel row under rectshift, hex, diamond, tri and knit: the gather
    render (``composite_cells``) and its inverse-map adjoint in the graph."""
    rows = {}
    for pixel_type, grid in GEOMETRY_GRIDS.items():
        with tempfile.TemporaryDirectory() as sub:
            rows[f"pixel {pixel_type}"] = phase_row(sub, card, dict(PIXEL_CONFIG, pixel_type=pixel_type),
                                                    f"pixel {pixel_type} row ({grid[0]}x{grid[1]} grid)", grid=grid)
    return rows


def phase_loss_rows(tmp, card):
    """The pixel row with ``--custom_loss style --styleloss_skip 0`` (a
    style image the script writes) and with ``--custom_loss resmem``:
    finite losses, the loss's own term, 1 K1 and 1 K2 per step."""
    import torch

    rows = {}
    style = write_style_image(tmp)
    for name, extra, term in (("style", dict(STYLE_EXTRA, style_file=style), "loss:StyleLoss"),
                              ("resmem", RESMEM_EXTRA, "loss:ResmemLoss")):
        with tempfile.TemporaryDirectory() as sub:
            torch.cuda.reset_peak_memory_stats()
            rows[name] = phase_row(sub, card, dict(PIXEL_CONFIG, **extra), f"{name} row (pixel 384x216, ViT-B/32, "
                                   f"64 cuts, --custom_loss {extra['custom_loss']})", descent=False, term=term)
            print(f"{name} row: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return rows


def phase_new_agreement(tmp):
    """hex + resmem + style on TinyTest, card against CPU, as in 5."""
    phase_agreement(tmp, PIXEL_CONFIG, "hex + resmem + style", pixel_type="hex", custom_loss="resmem,style",
                    styleloss_skip=0, style_file=write_style_image(tmp))


# the front ends (31): requests served by the port's HTTP server on the card
SERVED_PIXEL = dict(PIXEL_CONFIG, iterations=40, display_every=10, save_every=10)  # pixrayapi's settings YAML
SERVED_TEXT2PIXEL_STEPS = 30
CUT_STEPS, CUT_DISPLAY = 6000, 3000  # the cut job's runner goes on to its step-3000 frame past its deadline,
# long enough to outlive the next job's first frame (at step 1000 it once ended first)
CUT_TIMEOUT_S = 4.0
# job 4 (job 1's settings) against job 1, device memory allocated after each: one leaked ViT-B/32 tower set
# (~300 MiB) is larger; the three 32 MiB cuBLAS workspaces of the second handle that job 4's thread takes
# beside the cut job's runner fit under it.  With cuBLAS's workspace cache cleared, the engines alone:
SERVED_MEMORY_MARGIN = 128 * 2**20
SERVED_ENGINE_MARGIN = 32 * 2**20
VECTORIZE_ATOL = 2e-2  # ViT-B/32 rows, bf16 on the card against f32 on the CPU, unit norm
SWEEP_STEPS = 9  # step 0, then one block


def read_parts(resp, t0, on_png=None):
    """The parts of a pixrayframe multipart stream as they arrive:
    [(seconds since ``t0``, content type, payload)]; ``on_png`` is called
    when the first PNG part has arrived."""
    parts = []
    while True:
        line = resp.readline()
        if line in (b"", b"--pixrayframe--\r\n"):
            return parts
        if line != b"--pixrayframe\r\n":
            fail(f"front ends: unexpected multipart line {line[:80]!r}")
        headers = {}
        while (h := resp.readline()) != b"\r\n":
            key, value = h.decode().split(":", 1)
            headers[key.strip()] = value.strip()
        if "Content-Length" in headers:
            data = resp.read(int(headers["Content-Length"]))
            resp.readline()
        else:
            data = resp.readline().rstrip(b"\r\n")
        parts.append((time.perf_counter() - t0, headers["Content-Type"], data))
        if on_png is not None and headers["Content-Type"] == "image/png":
            on_png()
            on_png = None


def serve_request(port, product, body, label, on_png=None):
    """POST one request and read its stream: (parts, seconds, peak device
    memory during it)."""
    import http.client

    import torch

    torch.cuda.reset_peak_memory_stats()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
    t0 = time.perf_counter()
    conn.request("POST", f"/predictions/{product}", body=json.dumps(body).encode())
    resp = conn.getresponse()
    if resp.status != 200 or resp.getheader("Content-Type") != "multipart/x-mixed-replace; boundary=pixrayframe":
        fail(f"{label}: status {resp.status}, {resp.getheader('Content-Type')}")
    parts = read_parts(resp, t0, on_png)
    conn.close()
    return parts, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def retained():
    """Device memory allocated with no job running: as it stands, and with
    cuBLAS's cache of one workspace per (handle, stream) cleared (cuBLAS
    makes them again at its next call)."""
    import gc

    import torch

    gc.collect()
    raw = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return raw, torch.cuda.memory_allocated()


def png_size(data):
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("front ends: a part is not a PNG")
    return int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")


def served_line(label, parts, secs, peak, after, steps, display, card):
    """Time to the first frame, ms per step between the first and the last
    frame (the steps after the first display; checkins and copies
    included), peak and retained device memory."""
    frames = [t for t, kind, _ in parts if kind == "image/png"]
    ms = 1e3 * (frames[-1] - frames[0]) / (steps - display + 1)
    print(f"served {label}: {len(frames)} PNG parts in {secs:.2f} s; time to first frame {frames[0]:.2f} s (engine "
          f"init, towers and capture included); {ms:.2f} ms per step after it over {steps - display + 1} steps; peak "
          f"device memory {peak / 2**30:.2f} GiB, {after / 2**30:.3f} GiB allocated after the job; on {card}",
          flush=True)


def phase_front_ends(tmp, card):
    """The port's HTTP server in this process (worker on cuda, the repo's
    cogs/): /health, /products, /queue and a full queue's 503; pixrayapi on
    the bench's pixel row, text2pixel (quality better: RN50, ViT-B/32,
    ViT-B/16), a job cut by a short deadline and the pixel job again while
    the cut job's runner still steps (the next capture beside it); K1/K2
    per served step; memory after job 4 within SERVED_MEMORY_MARGIN of job
    1's, and within SERVED_ENGINE_MARGIN with cuBLAS's workspaces cleared.
    Then vectorize --inputs (card against CPU) and a two-seed sweep.
    Returns the served rows' (launches, steps)."""
    import glob
    import http.client
    from http.server import ThreadingHTTPServer

    import numpy as np
    import yaml
    from PIL import Image

    import pixray_tpu_torch
    from pixray_tpu_torch.ops import cuda_strokes, cuda_warp
    from pixray_tpu_torch.parallel import sweep
    from pixray_tpu_torch.serve import http as H
    from pixray_tpu_torch.tools import vectorize

    class Handler(H.PredictionHandler):
        def log_message(self, *args):  # no access log on stderr
            pass

    worker = H.get_worker("cuda")
    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", path)
        resp = conn.getresponse()
        out = resp.status, dict(resp.getheaders()), resp.read()
        conn.close()
        return out

    if get("/health")[::2] != (200, b"ok"):
        fail("front ends: /health")
    if json.loads(get("/products")[2]) != sorted(H.PRODUCTS) or len(H.PRODUCTS) != 10:
        fail(f"front ends: /products {get('/products')}")
    if json.loads(get("/queue")[2]) != {"pending": 0, "capacity": 4}:
        fail(f"front ends: /queue {get('/queue')}")
    full = H._Worker(max_pending=1, device="cuda")  # not started: its one job stays queued
    full.submit(H._Job("pixrayapi", {}))
    H._worker = full
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predictions/pixrayapi", body=b"{}")
        resp = conn.getresponse()
        refused = resp.status, resp.reason, resp.getheader("Retry-After")
        conn.close()
        queued = json.loads(get("/queue")[2])
    finally:
        H._worker = worker
    if refused != (503, "queue full", "30") or queued != {"pending": 1, "capacity": 4}:
        fail(f"front ends: a full queue answered {refused}, /queue {queued}")
    print(f"front ends: /health ok, /products {len(H.PRODUCTS)} products, /queue {{'pending': 0, 'capacity': 4}}; "
          f"a full queue: {refused[0]} {refused[1]}, Retry-After {refused[2]}", flush=True)

    rows, memory = {}, {}
    pixel_yaml = yaml.safe_dump(dict(SERVED_PIXEL, outdir=os.path.join(tmp, "api")))
    for job, (product, body, towers, steps) in enumerate((
            ("pixrayapi", {"settings": pixel_yaml}, 1, SERVED_PIXEL["iterations"]),
            ("text2pixel", {"prompts": "sunrise", "iterations": SERVED_TEXT2PIXEL_STEPS,
                            "outdir": os.path.join(tmp, "t2p")}, 3, SERVED_TEXT2PIXEL_STEPS)), start=1):
        cuda_warp.reset_launch_counts()
        cuda_strokes.reset_launch_counts()
        parts, secs, peak = serve_request(port, product, body, product)
        launches = {**cuda_warp.LAUNCHES, **cuda_strokes.LAUNCHES}
        after, engine_only = retained()  # the job's engine stays the package's current one
        engine = pixray_tpu_torch.get_engine()
        sizes = {png_size(data) for _, kind, data in parts if kind == "image/png"}
        if len(parts) < 4 or any(kind != "image/png" for _, kind, _ in parts) or len(sizes) != 1:
            fail(f"served {product}: parts {[(kind, len(d)) for _, kind, d in parts]}, sizes {sizes}")
        if product == "pixrayapi" and sizes != {(384, 216)}:
            fail(f"served pixrayapi: frames of {sizes}, expected 384x216")
        if len(engine.perceptors) != towers or engine.steps_dispatched != steps:
            fail(f"served {product}: {len(engine.perceptors)} towers, {engine.steps_dispatched} steps")
        ran = steps_run(engine, steps)
        check_launches(f"served {product}", launches, {"warp_fwd": towers * ran, "warp_bwd": towers * ran,
                                                       "strokes_fwd": 0, "strokes_fwd_store": 0, "strokes_bwd": 0})
        served_line(f"{product} ({','.join(engine.args.clip_models)}, {sizes.pop()}, {steps} steps)", parts, secs,
                    peak, after, steps, engine.args.display_every, card)
        print(f"served {product}: K1/K2 launches per step {launches['warp_fwd'] / ran:.2f} / "
              f"{launches['warp_bwd'] / ran:.2f} over {ran} steps; blocks {engine.dispatched_blocks}", flush=True)
        rows[f"served {product}"] = (launches, ran)
        memory[job] = after, engine_only
        del engine

    cut_yaml = yaml.safe_dump(dict(SERVED_PIXEL, iterations=CUT_STEPS, display_every=CUT_DISPLAY,
                                   save_every=CUT_DISPLAY, outdir=os.path.join(tmp, "cut")))
    worker.job_timeout = CUT_TIMEOUT_S
    try:
        parts, secs, peak = serve_request(port, "pixrayapi", {"settings": cut_yaml}, "cut job")
    finally:
        worker.job_timeout = H.JOB_TIMEOUT_S
    last = parts[-1] if parts else (0, "", b"")
    if last[1] != "text/plain" or not last[2].startswith(b"TimeoutError: render exceeded the 4s job deadline"):
        fail(f"cut job: ended with {last[1]} {last[2][:120]!r}")
    runner = worker.abandoned[-1]
    print(f"served cut job (pixrayapi, {CUT_STEPS} steps, deadline {CUT_TIMEOUT_S:g} s): {len(parts) - 1} PNG parts, "
          f"then {last[2].decode()!r} at {last[0]:.2f} s; its runner still running: {runner.is_alive()}", flush=True)

    beside = []
    parts, secs, peak = serve_request(port, "pixrayapi", {"settings": pixel_yaml}, "job after the cut",
                                      on_png=lambda: beside.append(runner.is_alive()))
    if sum(kind == "image/png" for _, kind, _ in parts) < 4 or any(kind != "image/png" for _, kind, _ in parts):
        fail(f"job after the cut: parts {[(kind, len(d)) for _, kind, d in parts]}")
    if beside != [True]:
        fail("job after the cut: the cut job's runner had stopped before this job's capture; nothing ran beside it")
    runner.join(300)
    if runner.is_alive():
        fail("the cut job's runner did not stop at its next frame")
    memory[4] = retained()
    served_line("pixrayapi after the cut job (its capture beside the cut job's runner)", parts, secs, peak,
                memory[4][0], SERVED_PIXEL["iterations"], SERVED_PIXEL["display_every"], card)
    server.shutdown()
    server.server_close()
    grown, engines = (memory[4][i] - memory[1][i] for i in (0, 1))
    print(f"front ends: device memory allocated after job 1 {memory[1][0] / 2**20:.1f} MiB, after job 2 "
          f"(text2pixel) {memory[2][0] / 2**20:.1f} MiB, after job 4 (job 1's settings; the cut job's runner "
          f"stopped) {memory[4][0] / 2**20:.1f} MiB: {grown / 2**20:+.1f} MiB against job 1 (margin "
          f"{SERVED_MEMORY_MARGIN / 2**20:.0f} MiB); with cuBLAS's workspaces cleared {memory[1][1] / 2**20:.1f}, "
          f"{memory[2][1] / 2**20:.1f}, {memory[4][1] / 2**20:.1f} MiB: {engines / 2**20:+.1f} MiB (margin "
          f"{SERVED_ENGINE_MARGIN / 2**20:.0f} MiB)", flush=True)
    if abs(grown) > SERVED_MEMORY_MARGIN or abs(engines) > SERVED_ENGINE_MARGIN:
        fail(f"front ends: memory after job 4 differs from job 1's by {grown / 2**20:.1f} MiB "
             f"({engines / 2**20:.1f} MiB without cuBLAS's workspaces)")

    # vectorize --inputs: ViT-B/32 on the card (bf16) against the CPU (f32)
    for i, shape in enumerate(((240, 320, 3), (300, 300, 3), (216, 384, 3), (400, 250, 3))):
        Image.fromarray(np.random.default_rng(40 + i).integers(0, 256, shape, dtype=np.uint8)).save(
            os.path.join(tmp, f"vec{i}.png"))
    tables = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, f"vectors_{device}.json")
        t0 = time.perf_counter()
        vectorize.main(["--models", "ViT-B/32", "--inputs", os.path.join(tmp, "vec*.png"), "--outfile", out,
                        "--device", device])
        tables[device] = (np.array(json.load(open(out))["ViT-B/32"]), time.perf_counter() - t0)
    card_rows, cpu_rows = tables["cuda"][0], tables["cpu"][0]
    err = float(np.abs(card_rows - cpu_rows).max())
    norms = np.linalg.norm(card_rows, axis=1)
    if card_rows.shape != (4, 512) or not np.isfinite(card_rows).all() or np.abs(norms - 1).max() > 1e-3 \
            or err > VECTORIZE_ATOL:
        fail(f"vectorize: rows {card_rows.shape}, norms {norms}, card against CPU {err:.3g}")
    print(f"vectorize --models ViT-B/32 --inputs (4 seeded PNGs): rows {card_rows.shape}, unit norm within "
          f"{np.abs(norms - 1).max():.1e}; card (bf16) against CPU (f32) max |diff| {err:.2e} (tol {VECTORIZE_ATOL}); "
          f"{tables['cuda'][1]:.1f} s on the card with the tower's build, {tables['cpu'][1]:.1f} s on the CPU", flush=True)

    # a two-seed sweep shard through the run module's contract
    settings = os.path.join(tmp, "sweep.yaml")
    with open(settings, "w") as f:
        yaml.safe_dump(dict(PIXEL_CONFIG, iterations=SWEEP_STEPS), f)
    t0 = time.perf_counter()
    sweep.main([settings, "--seeds", "4-5", "--outdir", os.path.join(tmp, "sweep", "%SEED%")])
    outs = sorted(glob.glob(os.path.join(tmp, "sweep", "*", "output.png")))
    if [os.path.basename(os.path.dirname(p)) for p in outs] != ["4", "5"]:
        fail(f"sweep: outputs {outs}")
    for path in outs:
        check_png("sweep", path, (384, 216))
    print(f"sweep --seeds 4-5: one 384x216 output.png per seed outdir in {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


# the precision rungs (32-34): the JAX package's default rungs and bench.py's exact-arithmetic ones
# (tools/smoke_tpu.py EXACT_ENV; the port has no CLIP_W16 knob: its weights are bf16 under
# --precision bf16 either way), as config/precision.py reads them
JAX_DEFAULT_RUNGS = {"PIXRAY_TPU_WARP_PREC": "int8", "PIXRAY_TPU_WARP_BWD_PREC": "bf16",
                     "PIXRAY_TPU_CLIP_PREC": "int8b", "PIXRAY_TPU_CLIP_PREQ": "1", "PIXRAY_TPU_CLIP_LN32": "0"}
EXACT_RUNGS = {"PIXRAY_TPU_WARP_PREC": "highest", "PIXRAY_TPU_WARP_BWD_PREC": "bf16",
               "PIXRAY_TPU_CLIP_PREC": "bf16", "PIXRAY_TPU_CLIP_PREQ": "1", "PIXRAY_TPU_CLIP_LN32": "1"}
LADDER_STEPS = 60  # bench.py's PIXRAY_TPU_SMOKE_STEPS
LADDER_BAND = 0.08  # bench.py's band: last5(default) - last5(exact) <= 0.08
BUSY_WINDOWS = 3  # replays profiled per ladder row of VERDICT_ROWS
VERDICT_ROWS = ("exact", "warp int8 alone", "tower int8b alone", "LayerNorm bf16 alone")
RUNG_STEPS = 17  # the single-knob rows: step 0, then two blocks
# (label, rungs over EXACT_RUNGS, steps): the ladder's two settings, each knob of the JAX
# defaults alone, and the rungs no default takes (K1 bf16 / high, K2 int8)
RUNG_ROWS = (
    ("exact", {}, LADDER_STEPS),
    ("JAX defaults", JAX_DEFAULT_RUNGS, LADDER_STEPS),
    ("warp int8 alone", {"PIXRAY_TPU_WARP_PREC": "int8"}, RUNG_STEPS),
    ("tower int8b alone", {"PIXRAY_TPU_CLIP_PREC": "int8b"}, RUNG_STEPS),
    ("LayerNorm bf16 alone", {"PIXRAY_TPU_CLIP_LN32": "0"}, RUNG_STEPS),
    ("warp bf16", {"PIXRAY_TPU_WARP_PREC": "bf16"}, RUNG_STEPS),
    ("warp high", {"PIXRAY_TPU_WARP_PREC": "high"}, RUNG_STEPS),
    ("warp int8, K2 int8", {"PIXRAY_TPU_WARP_PREC": "int8", "PIXRAY_TPU_WARP_BWD_PREC": "int8"}, RUNG_STEPS),
)
# the tower rungs on the card (33): (CLIP_PREC, PREQ, LN32), the card against the CPU for the marked ones
# (the bf16 rung's card-vs-CPU agreement is phase 5's and 20's)
TOWER_RUNGS = (("bf16", "1", "1", False), ("bf16", "1", "0", False), ("int8", "1", "0", False),
               ("int8b", "1", "0", True), ("int8b", "0", "0", False))
TOWER_CPU_CUTS = 2
TOWER_ATOL = 5e-2  # ViT-B/32 embeddings, card against CPU, both bf16: equal s8 codes, bf16 sums in other orders
# K2's float rungs against their plain twins, of max|dwork|: the twins do the kernels' arithmetic, so only the
# atomics' order parts them (at most 7.3e-7 on phase 32's banks on an H100); a K2-high body on the bf16 product
# reads 1.1e-3 at the flagship, one on the f32 product stays inside (one_tap_case catches it)
RUNG_BWD_RTOL = {"bf16": 1e-5, "high": 1e-5}


_VIT_B32 = {}


def vit_b32_weights():
    """One seeded random draw of ViT-B/32's weights (a state dict on the host), for phases 33 and 34."""
    import torch

    from pixray_tpu_torch.models.clip.configs import CLIP_CONFIGS
    from pixray_tpu_torch.models.clip.model import CLIP, init_random_

    if not _VIT_B32:
        model = init_random_(CLIP(CLIP_CONFIGS["ViT-B/32"]), torch.Generator().manual_seed(14))
        _VIT_B32.update({k: v.contiguous() for k, v in model.state_dict().items()})
    return _VIT_B32


class rung_env:
    """The process environment with ``rungs`` over EXACT_RUNGS for the
    ``with`` block (an engine or a perceptor reads it when it is built)."""

    def __init__(self, rungs):
        self.rungs = dict(EXACT_RUNGS, **rungs)

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.rungs}
        os.environ.update(self.rungs)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def rung_bank_case(name, work, ms, modes, fill, s, jitter, facs, planes, time_it):
    """K1's and K2's rung variants against their plain twins on the card,
    on one bank (bf16, jitter, noise): per K1 rung the pre-jitter bank of
    the jittered cuts (bitwise) and the bank (within BANK_ULPS); per K2
    rung the gradient from the explicit jitter adjoint's cotangent (int8
    bitwise, the float rungs within RUNG_BWD_RTOL of max|dwork|), and
    K2-int8 once more on the bank without jitter, where K2's cotangent is g
    itself, and a third time for the same bits.  The helper passes against their plain twins, bitwise:
    K1-int8's scale and pack passes (s_w as quantize_canvas takes it, the
    packed texels as pack_texels packs quantize_canvas's codes), K1-bf16's
    and K1-high's pack passes (pack_bf16_texels, bit for bit), K2-bf16's
    row table (tap_row_ranges) and K2-int8's cotangent pass (the jittered
    cuts' cotangent bank and s_g as bank_cotangent_plain gives them, the
    int64 canvas zeroed); K2-bf16's visit counts (row visits, and pixel
    visits: each pixel with a tap on the canvas exactly once); and the
    blocks of K2-int8's scatter that summed in shared memory and that added
    to device memory.  Times as phase 3b, the helper passes by kernel with
    bounds of their own bytes; a rung's kernel and its call (its passes
    with it) against the rung's bound, with an s8 canvas for K1-int8 (its
    pack pass reads the f32 canvas); grid_sample computes none of these
    functions."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3
    from pixray_tpu_torch.ops.warp_batch import (DEQUANT, _rung_taps, pack_bf16_texels, pack_texels, quantize_canvas,
                                                 tap_row_ranges, warp_adjoint_rung, warp_modes_prec)

    dev, bf16 = work.device, torch.bfloat16
    inv = inv3x3(ms.float())
    inv_d, modes_d = inv.to(dev), modes.to(dev, torch.int32)
    params = cuda_warp.pack_params(inv, modes, jitter, facs, fill=fill)
    params_dev = params.to(dev)
    n, (h, w, _) = ms.shape[0], work.shape
    applied = jitter[2].to(dev)
    jittered = int(jitter[2].sum())
    g = torch.randn((n, 3, s, s), device=dev, generator=torch.Generator(device=dev).manual_seed(9)).to(bf16)
    res = {"name": name, "n": n, "s": s, "canvas": [h, w], "jittered": jittered, "fwd": {}, "bwd": {}}
    plane, rows = s * s * 2, params.numel() * 4
    pres = {}
    # the helper passes against their plain twins, bitwise
    shape = tuple(work.shape)
    codes, s_w = quantize_canvas(work)
    scale_buf = cuda_warp.launch_canvas_scale(work)
    texels = cuda_warp.launch_canvas_pack(work, scale_buf)
    rows_k, rows_p = cuda_warp.launch_bank_rows(params_dev, shape, s), tap_row_ranges(inv_d, modes_d, shape, s)
    on_canvas = int(_rung_taps(shape, inv_d, modes_d, 0.0, s)[1].any(0).sum())  # pixels with a tap on the canvas
    res["helpers"] = {"scale_bitwise": torch.equal(scale_buf[:-1].max().clamp(min=1e-6), s_w) and
                      torch.equal(scale_buf[-1], s_w),
                      "pack_bitwise": torch.equal(texels, pack_texels(codes)),
                      "rows_bitwise": torch.equal(rows_k, rows_p), "on_canvas": on_canvas}
    for prec in ("bf16", "high"):  # the bits, so that a -0 against a +0 counts
        texels_k, texels_p = cuda_warp.launch_canvas_texels(work, prec), pack_bf16_texels(work, prec)
        res["helpers"][f"{prec}_pack_bitwise"] = torch.equal(texels_k.view(torch.int16), texels_p.view(torch.int16))
    if not all(v for k, v in res["helpers"].items() if k.endswith("bitwise")):
        fail(f"a helper pass of K1-int8, K1-bf16, K1-high or K2-bf16 differs from its plain twin on {name}: "
             f"{res['helpers']}")
    for prec in ("int8", "bf16", "high"):
        out_k, pre_k = cuda_warp.launch_bank_fwd(work, params_dev, s, planes, bf16, save_pre=True, prec=prec)
        with torch.no_grad():
            pre_p = warp_modes_prec(work, inv_d, modes_d, fill, s, prec).to(bf16)
            out_p = cuda_warp.cutout_bank_plain(work, params, s, planes, bf16, prec)
        torch.cuda.synchronize()
        pre_ulps, ulps = bf16_ulps(pre_k[applied], pre_p[applied]), bf16_ulps(out_k, out_p)
        r = {"pre_bitwise": torch.equal(pre_k[applied], pre_p[applied]), "pre_max_ulps": int(pre_ulps.max()),
             "max_ulps": int(ulps.max()), "ulp_diffs": int((ulps > 0).sum()),
             "max_abs_err": float((out_k.float() - out_p.float()).abs().max())}
        if not r["pre_bitwise"]:
            fail(f"K1-{prec}'s pre-jitter bank differs from its plain twin on {name}: {r}")
        if not (r["pre_max_ulps"] <= BANK_ULPS and r["max_ulps"] <= BANK_ULPS):
            fail(f"K1-{prec}'s bank differs from its plain twin beyond {BANK_ULPS} ulps on {name}: {r}")
        pres[prec] = pre_k
        if time_it:
            canvas = h * w * 3 * (1 if prec == "int8" else 4)
            r["bound"] = bound(canvas + rows + 3 * n * plane * 2 + 3 * jittered * plane,
                               (WARP_FWD_FLOPS_PER_PIXEL * n + JITTER_FWD_FLOPS_PER_PIXEL * jittered) * s * s)

            def fwd(prec=prec):
                cuda_warp.launch_bank_fwd(work, params_dev, s, planes, bf16, save_pre=True, prec=prec)

            def plain(prec=prec):
                with torch.no_grad():
                    cuda_warp.cutout_bank_plain(work, params, s, planes, bf16, prec)

            times = kernel_times(fwd)
            kernel = cuda_warp.KERNEL_NAMES[cuda_warp.FWD_COUNTERS[prec]]
            r["ms"] = sum(v for k, v in times.items() if kernel in k)
            r["call_ms"], r["event_ms"] = sum(times.values()), median_ms(fwd)  # the rung's passes too
            r["helper_ms"] = helper_ms(times, cuda_warp.FWD_COUNTERS[prec])
            if prec == "int8":
                r["helper_bound"] = {"warp_fwd_int8_scale": bound(h * w * 3 * 4, h * w * 3),
                                     "warp_fwd_int8_pack": bound(h * w * (3 * 4 + 4), h * w * 3 * 3)}
                r["helper_plain_ms"] = {
                    "warp_fwd_int8_scale": device_ms(lambda: work.abs().amax()),
                    "warp_fwd_int8_pack": device_ms(lambda: pack_texels(quantize_canvas(work)[0]))}
            else:
                # the f32 canvas read, the texels written; a conversion per value (high: and a subtraction and a
                # conversion more)
                pack = f"warp_fwd_{prec}_pack"
                r["helper_bound"] = {pack: bound(h * w * (3 * 4 + (8 if prec == "bf16" else 16)),
                                                 h * w * 3 * (1 if prec == "bf16" else 3))}
                r["helper_plain_ms"] = {pack: device_ms(lambda prec=prec: pack_bf16_texels(work, prec))}
            r["plain_ms"], r["plain_event_ms"] = device_ms(plain), median_ms(plain)
        res["fwd"][prec] = r
    # K2's cotangent: the explicit jitter adjoint (K2's formulas) rounded to bf16, as phase 3b
    pre_x = pres["int8"]
    d_exp, s_g = cuda_warp.bank_cotangent_plain(g, pre_x, params)
    cot_k, partial_k, acc_k = cuda_warp.launch_bank_cotangent(g, pre_x, params_dev, shape)
    torch.cuda.synchronize()
    res["helpers"].update({"cot_bitwise": torch.equal(cot_k[applied], d_exp[applied]),
                           "cot_diffs": int((cot_k[applied] != d_exp[applied]).sum()),
                           "cot_max_bitwise": torch.equal(partial_k[:-1].max().clamp(min=1e-20), s_g),
                           "cot_zeroed": bool((acc_k == 0).all())})
    if not (res["helpers"]["cot_bitwise"] and res["helpers"]["cot_max_bitwise"] and res["helpers"]["cot_zeroed"]):
        fail(f"K2-int8's cotangent pass differs from its plain twin on {name}: {res['helpers']}")
    params_flat = cuda_warp.pack_params(inv, modes, None, facs, fill=fill).to(dev)  # the same bank, no jitter
    for prec in ("bf16", "high", "int8"):
        branches = torch.zeros((2,), dtype=torch.int32, device=dev) if prec in ("bf16", "int8") else None
        dwork_k = cuda_warp.launch_bank_bwd(g, pre_x, params_dev, shape, s, branches=branches, prec=prec)
        dwork_p = warp_adjoint_rung(d_exp, inv_d, modes_d, shape, s, prec)
        torch.cuda.synchronize()
        scale = max(float(dwork_p.abs().max()), 1e-6)
        r = {"bitwise": torch.equal(dwork_k, dwork_p), "max_abs_err": float((dwork_k - dwork_p).abs().max()),
             "scale": scale, "diffs": int((dwork_k != dwork_p).sum())}
        if prec == "bf16":
            r["row_visits"], r["pixel_visits"] = (int(b) for b in branches.cpu())
            if r["pixel_visits"] != on_canvas:
                fail(f"K2-bf16 visited {r['pixel_visits']} pixels on {name}; {on_canvas} have a tap on the canvas")
        if prec == "int8":
            r["shared_blocks"], r["device_blocks"] = (int(b) for b in branches.cpu())
            flat_k = cuda_warp.launch_bank_bwd(g, None, params_flat, tuple(work.shape), s, prec="int8")
            flat_p = warp_adjoint_rung(g, inv_d, modes_d, tuple(work.shape), s, "int8")
            r["bitwise_without_jitter"] = torch.equal(flat_k, flat_p)
            again = cuda_warp.launch_bank_bwd(g, pre_x, params_dev, tuple(work.shape), s, prec="int8")
            r["deterministic"] = torch.equal(again, dwork_k)
            if not (r["bitwise"] and r["bitwise_without_jitter"] and r["deterministic"]):
                fail(f"K2-int8 differs from its plain twin (or from itself) on {name}: {r}")
        r["tol"] = RUNG_BWD_RTOL.get(prec, 0.0) * scale
        if not r["max_abs_err"] <= r["tol"]:
            fail(f"K2-{prec} disagrees with its plain twin on {name}: {r}")
        if time_it:
            canvas, grad = h * w * 3 * 8, h * w * 3 * 4  # the int64 canvas, the f32 gradient
            # the whole rung's work: g, the pre-jitter bank of the jittered cuts, the jitter's adjoint, the scatter
            r["bound_bytes"] = 3 * n * plane + 3 * jittered * plane + rows + grad
            r["bound"] = r["rung_bound"] = bound(r["bound_bytes"], (WARP_BWD_FLOPS_PER_PIXEL * n +
                                                                    JITTER_BWD_FLOPS_PER_PIXEL * jittered) * s * s)
            if prec == "int8":
                # the scatter's own work: the cotangent bank (g for the cuts without jitter), the partial maxima,
                # the int64 canvas; the jitter's adjoint is the cotangent pass's
                r["bound_bytes"] = 3 * n * plane + rows + 4 * (cuda_warp.scratch_layout()["cot_blocks"] + 1) + canvas
                r["bound"] = bound(r["bound_bytes"], WARP_BWD_FLOPS_PER_PIXEL * n * s * s)

            def bwd(prec=prec):
                cuda_warp.launch_bank_bwd(g, pre_x, params_dev, tuple(work.shape), s, prec=prec)

            def plain_bwd(prec=prec):
                warp_adjoint_rung(d_exp, inv_d, modes_d, tuple(work.shape), s, prec)

            times = kernel_times(bwd)
            kernel = cuda_warp.KERNEL_NAMES[cuda_warp.BWD_COUNTERS[prec]]
            # the rung's kernel; its helper passes (and the fill of K2-high's canvas) apart
            r["ms"] = sum(v for k, v in times.items() if kernel in k)
            r["call_ms"], r["event_ms"] = sum(times.values()), median_ms(bwd)
            r["kernels"] = times
            r["helper_ms"] = helper_ms(times, cuda_warp.BWD_COUNTERS[prec])
            r["plain_ms"], r["plain_event_ms"] = device_ms(plain_bwd), median_ms(plain_bwd)
            if prec == "int8":
                # g; the pre-jitter and the cotangent bank of the jittered cuts; the canvas zeroed
                cot_bytes = 3 * n * plane + 2 * 3 * jittered * plane + rows + canvas
                r["helper_bound"] = {
                    "warp_bwd_int8_cot": bound(cot_bytes, JITTER_BWD_FLOPS_PER_PIXEL * jittered * s * s),
                    "warp_bwd_int8_finish": bound(canvas + grad, 2 * h * w * 3)}
                r["helper_plain_ms"] = {
                    "warp_bwd_int8_cot": device_ms(lambda: cuda_warp.bank_cotangent_plain(g, pre_x, params)),
                    "warp_bwd_int8_finish": device_ms(lambda: acc_k.float() * (s_g / DEQUANT))}
                # the rung's three passes, against the rung's bound
                r["bytes_moved"] = cot_bytes + r["bound_bytes"] + canvas + grad
            if prec == "high":
                acc4 = torch.zeros((h, w, 4), device=dev)
                r["helper_bound"] = {"warp_bwd_high_pack": bound(h * w * 16 + grad, 0)}
                r["helper_plain_ms"] = {"warp_bwd_high_pack": device_ms(lambda: acc4[..., :3].contiguous())}
                # beyond the bound: the (H, W, 4) canvas zeroed, reduced into (in L2) and read by the pack pass
                r["bytes_moved"] = r["bound_bytes"] + 2 * h * w * 16
            if prec == "bf16":
                lay = cuda_warp.scratch_layout()
                bands, groups = -(-h // lay["band_rows"]), min(lay["band_groups"], -(-n // lay["band_cluster"]))
                partial_bytes = groups * (h + bands) * w * 3 * 4
                r["helper_bound"] = {"warp_bwd_bf16_rows": bound(rows + n * s * 8, 25 * n * s * s),
                                     "warp_bwd_bf16_sum": bound(partial_bytes + h * w * 3 * 4, groups * h * w * 3)}
                partials = torch.zeros((groups, h + bands, w, 3), device=dev)
                r["helper_plain_ms"] = {"warp_bwd_bf16_rows": device_ms(lambda: tap_row_ranges(inv_d, modes_d,
                                                                                               shape, s)),
                                        "warp_bwd_bf16_sum": device_ms(lambda: partials[:, :h].sum(0))}
                # what the bands move beyond the bound: the row table once per band, the partial canvases
                # written and read back
                r["bytes_moved"] = r["bound_bytes"] + bands * n * s * 8 + 2 * partial_bytes
        res["bwd"][prec] = r
    return res


def helper_ms(times, counter):
    """{helper counter: its kernel's summed ms} of a rung's helper passes in ``times``."""
    from pixray_tpu_torch.ops import cuda_warp

    return {c: sum(v for k, v in times.items() if cuda_warp.KERNEL_NAMES[c] in k)
            for c in cuda_warp.HELPERS.get(counter, ())}


def zoomed_out_bank(gen, gen_dev):
    """8 cuts of 224 on a 384x384x3 canvas whose 16x16 output tiles read
    canvas footprints larger than K2-int8's shared-memory budget: boxes
    3-4 times the canvas, folded by reflection, clamped at the border, off
    the canvas in zeros, and two perspective cuts over a fill.  (work, ms,
    modes, jitter, facs, planes) as flagship_bank_inputs."""
    import torch

    from pixray_tpu_torch.engine.cutouts import draw_noise
    from pixray_tpu_torch.ops import warp as W
    from pixray_tpu_torch.ops.color import draw_jitter_params

    h = w = 384
    s = 224
    t = lambda *a: torch.tensor(a, dtype=torch.float32)
    boxes = W.crop_box_transform(t(-576.0, -400.0, -300.0, -500.0, 200.0, -384.0),
                                 t(-576.0, -300.0, -500.0, -384.0, 100.0, 150.0),
                                 t(1536.0, 1300.0, 1200.0, 1400.0, 1150.0, 1250.0),
                                 t(1536.0, 1250.0, 1300.0, 1152.0, 1200.0, 1180.0), s, s)
    persp = W.mm3(W.crop_box_transform(t(-200.0, -300.0), t(-250.0, -100.0), t(900.0, 1000.0), t(950.0, 900.0), s, s),
                  W.random_perspective(h, w, 0.5, torch.rand((2, 4, 2), generator=gen)))
    modes = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3], dtype=torch.int32)
    jitter = draw_jitter_params(gen, 8)
    facs, planes = draw_noise(gen, gen_dev, 8, s, torch.bfloat16, torch.device("cuda"))
    work = torch.rand((h, w, 3), generator=gen).to("cuda")
    return work, torch.cat([boxes, persp]), modes, jitter, facs, planes


def one_tap_case():
    """K2-bf16 and K2-high bitwise against their plain twins on a bank in
    which every canvas element takes exactly one tap, so that no sum hangs
    on the atomics' order: one cut of 112 halving the 224x224x3 canvas at a
    fractional offset (hats 0.377 / 0.623 and 0.189 / 0.811).  A body on
    another rung's products differs here in most elements: K2-high on the
    f32 product in 147,738 of 150,528 on an H100, where RUNG_BWD_RTOL
    passes it on every other bank.  → {rung: elements apart}, fatal unless
    all 0."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops import warp as W
    from pixray_tpu_torch.ops.warp import inv3x3
    from pixray_tpu_torch.ops.warp_batch import MODE_REFLECT, _rung_taps, warp_adjoint_rung

    h = w = 224
    s = 112
    t = lambda *a: torch.tensor(a, dtype=torch.float32)
    inv = inv3x3(W.crop_box_transform(t(0.623), t(0.811), t(2.0 * s), t(2.0 * s), s, s))
    modes = torch.tensor([MODE_REFLECT], dtype=torch.int32)
    inv_d, modes_d = inv.to("cuda"), modes.to("cuda")
    idx, valid = _rung_taps((h, w, 3), inv_d, modes_d, 0.0, s)[:2]
    taps = torch.cat([i[v] for i, v in zip(idx, valid)])
    if taps.numel() != h * w or taps.unique().numel() != h * w:
        fail(f"the one-tap bank gives {taps.unique().numel()} of {h * w} canvas pixels {taps.numel()} taps")
    g = torch.randn((1, 3, s, s), device="cuda", generator=torch.Generator(device="cuda").manual_seed(11))
    g = g.to(torch.bfloat16)
    params = cuda_warp.pack_params(inv, modes).to("cuda")
    apart = {}
    for prec in ("bf16", "high"):
        dwork_k = cuda_warp.launch_bank_bwd(g, None, params, (h, w, 3), s, prec=prec)
        apart[prec] = int((dwork_k != warp_adjoint_rung(g, inv_d, modes_d, (h, w, 3), s, prec)).sum())
    if any(apart.values()):
        fail(f"K2's float rungs differ from their plain twins where every canvas element takes one tap: {apart}")
    return apart


def phase_rung_kernels():
    """32: the rung variants of K1/K2 against their plain twins on the
    flagship bank (64 cuts of 224 on 224x224x3, bf16, 47 jittered, noise;
    timed), the ragged tie-rich bank of phase 3b, 64 cuts of 384 on
    384x384x3 (RN50x16's, drawn as the flagship's), 16 cuts of 512 on
    512x512x3, wide enough that K2-bf16's band copy takes more than 48 KB
    of shared memory (the opt-in past the default), and zoomed_out_bank,
    whose tiles' footprints send K2-int8's scatter to device memory (fatal
    if no block of it went there); and one_tap_case, K2's float rungs
    bitwise."""
    import torch

    from pixray_tpu_torch.engine.cutouts import draw_noise
    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops import warp as W

    gen, gen_dev, (work, ms, modes, jitter, facs, planes) = flagship_bank_inputs()
    flagship = rung_bank_case("flagship", work, ms, modes, 0.37, 224, jitter, facs, planes, time_it=True)
    h, w, s = 90, 100, 40
    t = lambda *a: torch.tensor(a, dtype=torch.float32)
    boxes = W.crop_box_transform(t(0.0, 10.0, -120.0, 5.0, 0.0, -140.0), t(0.0, 2.0, -100.0, 20.0, 0.0, -90.0),
                                 t(100.0, 30.0, 350.0, 60.0, 100.0, 380.0), t(90.0, 28.0, 300.0, 50.0, 90.0, 270.0),
                                 s, s)
    persp = W.mm3(W.crop_box_transform(t(5.0, -10.0, 20.0), t(0.0, 10.0, -5.0), t(90.0, 80.0, 60.0),
                                       t(85.0, 70.0, 95.0), s, s),
                  W.random_perspective(h, w, 0.5, torch.rand((3, 4, 2), generator=gen)))
    jitter_r = (t(0.0, 0.5, 0.1, -0.1, 0.05, 0.0, 1 / 6, -0.05, 0.02), t(1.0, 1.0, 0.9, 1.1, 1.0, 1.05, 1.0, 0.95, 1.0),
                torch.tensor([True, True, True, False, True, True, True, True, False]))
    facs_r, planes_r = draw_noise(gen, gen_dev, 9, s, torch.bfloat16, torch.device("cuda"))
    ragged = rung_bank_case("ragged ties", _tie_canvas(h, w, gen).to("cuda"), torch.cat([boxes, persp]),
                            torch.tensor([1, 0, 0, 3, 3, 3, 3, 2, 0], dtype=torch.int32), 0.5, s, jitter_r, facs_r,
                            planes_r, time_it=False)
    _, _, (work_l, ms_l, modes_l, jitter_l, facs_l, planes_l) = flagship_bank_inputs(64, 384)
    large = rung_bank_case("64 cuts of 384", work_l, ms_l, modes_l, 0.37, 384, jitter_l, facs_l, planes_l,
                           time_it=False)
    _, _, (work_w, ms_w, modes_w, jitter_w, facs_w, planes_w) = flagship_bank_inputs(16, 512)
    wide = rung_bank_case("16 cuts of 512", work_w, ms_w, modes_w, 0.37, 512, jitter_w, facs_w, planes_w,
                          time_it=False)
    work_z, ms_z, modes_z, jitter_z, facs_z, planes_z = zoomed_out_bank(gen, gen_dev)
    zoomed = rung_bank_case("zoomed out on 384", work_z, ms_z, modes_z, 0.37, 224, jitter_z, facs_z, planes_z,
                            time_it=False)
    if zoomed["bwd"]["int8"]["device_blocks"] < 1:
        fail(f"no block of K2-int8's scatter added to device memory on the zoomed-out bank: {zoomed['bwd']['int8']}")
    one_tap = one_tap_case()
    print(f"rung kernels one tap a canvas element (1 cut of 112 halving 224x224x3, bf16): K2-bf16 / K2-high "
          f"elements apart from their plain twins {one_tap['bf16']} / {one_tap['high']} (bitwise)", flush=True)
    layout = cuda_warp.scratch_layout()
    for r in (flagship, ragged, large, wide, zoomed):
        f, b = r["fwd"], r["bwd"]
        print(f"rung kernels {r['name']} (N={r['n']}, S={r['s']}, {r['canvas'][0]}x{r['canvas'][1]}x3, bf16, "
              f"{r['jittered']} jittered, noise) against their plain twins: K1 pre-jitter bank bitwise "
              f"int8 {f['int8']['pre_bitwise']}, bf16 {f['bf16']['pre_bitwise']}, high {f['high']['pre_bitwise']}; "
              f"bank max ulps int8/bf16/high {f['int8']['max_ulps']}/{f['bf16']['max_ulps']}/{f['high']['max_ulps']} "
              f"(tol {BANK_ULPS}); K2-int8 bitwise {b['int8']['bitwise']} ({b['int8']['diffs']} elements apart, "
              f"max_abs_err {b['int8']['max_abs_err']:.3g}), without jitter bitwise "
              f"{b['int8']['bitwise_without_jitter']}, twice the same bits {b['int8']['deterministic']}; K2-bf16 "
              f"max_abs_err {b['bf16']['max_abs_err']:.3g}, K2-high {b['high']['max_abs_err']:.3g} against max|dwork| "
              f"{b['bf16']['scale']:.3g} (tol {b['bf16']['tol']:.3g}); bitwise their plain twins: K1-int8's scale "
              f"and pack passes {r['helpers']['scale_bitwise']} / {r['helpers']['pack_bitwise']}, K1-bf16's and "
              f"K1-high's pack passes {r['helpers']['bf16_pack_bitwise']} / {r['helpers']['high_pack_bitwise']}, "
              f"K2-bf16's row table {r['helpers']['rows_bitwise']}, K2-int8's cotangent pass "
              f"{r['helpers']['cot_bitwise']} (s_g {r['helpers']['cot_max_bitwise']}, int64 canvas zeroed {r['helpers']['cot_zeroed']}); K2-int8's "
              f"scatter blocks in shared memory / device memory {b['int8']['shared_blocks']} / "
              f"{b['int8']['device_blocks']}; K2-bf16 ({layout['band_rows']}-row bands, up to "
              f"{layout['band_groups']} clusters of {layout['band_cluster']} blocks per band) row visits "
              f"{b['bf16']['row_visits']} for {r['n'] * r['s']} rows, pixel visits {b['bf16']['pixel_visits']} "
              f"(pixels with a tap on the canvas {r['helpers']['on_canvas']})", flush=True)
    f, b = flagship["fwd"], flagship["bwd"]
    tm = lambda r: f"{r['ms']:.4f} / {r['event_ms']:.4f} (bound {r['bound'][0]:.4f}, {r['bound'][1]}; plain " \
                   f"{r['plain_ms']:.4f} / {r['plain_event_ms']:.4f})"
    hm = lambda r: ", ".join(f"{cuda_warp.KERNEL_NAMES[c]} {ms:.4f} (bound {r['helper_bound'][c][0]:.4f}, "
                             f"{r['helper_bound'][c][1]})" for c, ms in r["helper_ms"].items())
    print(f"rung kernels flagship times (ms, summed kernel time / CUDA events of one call; grid_sample computes "
          f"none of these functions): K1-int8 {tm(f['int8'])}, its passes {hm(f['int8'])}; K1-bf16 "
          f"{tm(f['bf16'])}, its pass {hm(f['bf16'])}; K1-high {tm(f['high'])}, its pass {hm(f['high'])}; the "
          f"calls with their passes against the rung's bound: K1-int8 {f['int8']['call_ms']:.4f}, K1-bf16 "
          f"{f['bf16']['call_ms']:.4f}, K1-high {f['high']['call_ms']:.4f}; K2-bf16 {tm(b['bf16'])} (bytes moved "
          f"{b['bf16']['bytes_moved'] / 1e6:.2f} MB), its passes {hm(b['bf16'])}; K2-high {tm(b['high'])} (bytes "
          f"moved {b['high']['bytes_moved'] / 1e6:.2f} MB), its pass {hm(b['high'])}; K2-int8's scatter "
          f"{tm(b['int8'])}, its passes {hm(b['int8'])}; the K2-int8 rung's three passes {b['int8']['call_ms']:.4f} "
          f"(bytes moved {b['int8']['bytes_moved'] / 1e6:.2f} MB) against the rung's bound "
          f"{b['int8']['rung_bound'][0]:.4f} ({b['int8']['rung_bound'][1]})",
          flush=True)
    return flagship, ragged, large, wide, zoomed


# torch._int_mm at the ViT-B/32 bank's products (64 cuts x 50 tokens: in_proj, out_proj, mlp_fc,
# mlp_proj) and a small shape, with its second operand row-major and column-major
INT_MM_SHAPES = ((3200, 768, 2304), (3200, 768, 768), (3200, 768, 3072), (3200, 3072, 768), (17, 64, 192))


def int_mm_layouts():
    """{shape: {layout: (exact, ms) or the refusal}, "bf16": ms, "bf16_f32": ms} on the card: the s8
    product in both layouts of its second operand against the exact float64 product, beside cuBLAS's
    bf16 GEMM and the bf16 x bf16 -> f32 product ops/quant.py takes (CUDA events, 20 calls)."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for m, k, n in INT_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev, generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
        ref = a.double() @ b.double()
        row = {}
        for layout, mat2 in (("row-major", b.contiguous()), ("column-major", b.t().contiguous().t())):
            try:
                exact = bool(torch.equal(torch._int_mm(a, mat2).double(), ref))
                row[layout] = (exact, median_ms(lambda mat2=mat2: torch._int_mm(a, mat2)))
            except RuntimeError as exc:
                row[layout] = f"refused ({str(exc).splitlines()[0][:60]})"
        ab, bb = a.bfloat16(), b.bfloat16()
        row["bf16"] = median_ms(lambda: ab @ bb)
        row["bf16_f32"] = median_ms(lambda: torch.mm(ab, bb, out_dtype=torch.float32))
        if not (isinstance(row["column-major"], tuple) and row["column-major"][0]):
            fail(f"torch._int_mm with a column-major operand at {(m, k, n)}: {row}")
        out[(m, k, n)] = row
    return out


LN_ATOL = 6.25e-2  # a LayerNorm's bf16 output, card against CPU: two bf16 ulps at |y| < 8 (sums in other orders)


def layer_norm_check(p):
    """A bf16 tower's LayerNorm affines are float32 tensors (the JAX
    ``_cast_storage``), and its first LayerNorm, with its own affine (ones
    and zeros) and with one written in float32, takes
    a bf16 input inside a captured CUDA graph: the replay bitwise the eager
    call, bf16 out, within LN_ATOL of the CPU.  Returns a summary string;
    fatal otherwise."""
    import copy

    import torch

    from pixray_tpu_torch.models.clip.model import LayerNorm

    norms = [m for m in p.model.modules() if isinstance(m, LayerNorm)]
    if not norms or any(t.dtype != torch.float32 for m in norms for t in (m.weight, m.bias)):
        fail(f"{p.name}: LayerNorm affines not all float32: {sorted({str(m.weight.dtype) for m in norms})}")
    gen = torch.Generator(device="cuda").manual_seed(16)
    errs = []
    for written in (False, True):  # the tower's own affine, then one written in f32
        ln = copy.deepcopy(norms[0])
        with torch.no_grad():
            if written:
                ln.weight.copy_(torch.rand(ln.weight.shape, device="cuda", generator=gen) + 0.5)
                ln.bias.copy_(torch.randn(ln.bias.shape, device="cuda", generator=gen) * 0.3)
            x = torch.randn((64, 50, ln.weight.shape[0]), device="cuda", generator=gen).to(torch.bfloat16)
            eager = ln(x)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = ln(x)
            graph.replay()
            torch.cuda.synchronize()
            cpu = ln.cpu()(x.cpu())
        errs.append(float((captured.float().cpu() - cpu.float()).abs().max()))
        if not (captured.dtype == torch.bfloat16 and torch.equal(captured, eager) and errs[-1] <= LN_ATOL):
            fail(f"{p.name}: LayerNorm (ln32 {ln.ln32}, written {written}) in a graph: {captured.dtype}, replay "
                 f"equal to eager {torch.equal(captured, eager)}, card vs CPU {errs[-1]:.3g}")
    return f"affines f32 ({len(norms)}), in a graph bf16 out, card vs CPU {errs[0]:.2e} / written {errs[1]:.2e}"


def phase_tower_rungs(card):
    """33: ViT-B/32 (seeded random weights) on the flagship bank at each
    tower rung: embeddings of 64 cuts forward + input gradient, summed
    kernel ms and CUDA-event ms of an eager call (the quantize passes are
    many small launches, which a captured step does not pay on the host),
    and for the marked rungs the card against the CPU on TOWER_CPU_CUTS
    cuts (equal s8 codes, max |diff| of the embeddings, TOWER_ATOL)."""
    import torch

    from pixray_tpu_torch.config.precision import Rungs
    from pixray_tpu_torch.models.perceptor import Perceptor
    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp import inv3x3

    layouts = int_mm_layouts()
    fmt = lambda v: f"{v[1]:.4f}" + ("" if v[0] else " (inexact)") if isinstance(v, tuple) else v
    print("torch._int_mm (ms per call, CUDA events; the second operand row-major / column-major) against the "
          "bf16 GEMM and the bf16 x bf16 -> f32 product: " + "; ".join(
              f"{m}x{k}x{n}: {fmt(r['row-major'])} / {fmt(r['column-major'])}, bf16 {r['bf16']:.4f}, "
              f"bf16->f32 {r['bf16_f32']:.4f}" for (m, k, n), r in layouts.items()) + f"; on {card}", flush=True)
    sd = vit_b32_weights()
    _, _, (work, ms, modes, jitter, facs, planes) = flagship_bank_inputs()
    params = cuda_warp.pack_params(inv3x3(ms.float()), modes, jitter, facs, fill=0.37)
    bank = cuda_warp.cutout_bank(work, params, 224, planes, torch.bfloat16).detach()
    out = []
    for prec, preq, ln32, on_cpu in TOWER_RUNGS:
        rungs = Rungs(clip=prec, clip_preq=preq == "1", clip_ln32=ln32 != "0")
        p = Perceptor("ViT-B/32", "cuda", torch.bfloat16, sd, rungs=rungs)
        x = bank.clone().requires_grad_(True)

        def step():
            e = p.image_fn(x)
            torch.autograd.grad(e.float().sum(), x)

        r = {"rung": f"{prec} PREQ {preq} LN32 {ln32}", "ms": device_ms(step), "event_ms": median_ms(step, reps=5),
             "quant": p.quant, "prequantized": p.quant_weights is not None, "ln": layer_norm_check(p)}
        if on_cpu:
            q = Perceptor("ViT-B/32", "cpu", torch.bfloat16, sd, rungs=rungs)
            with torch.no_grad():
                card_e = p.image_fn(bank[:TOWER_CPU_CUTS]).float().cpu()
                cpu_e = q.image_fn(bank[:TOWER_CPU_CUTS].cpu()).float()
            if p.quant_weights is not None:
                r["codes_equal"] = all(torch.equal(p.quant_weights[k].q.cpu(), q.quant_weights[k].q)
                                       for k in p.quant_weights)
            r["card_vs_cpu"] = float((card_e - cpu_e).abs().max())
            if not (r["card_vs_cpu"] <= TOWER_ATOL and r.get("codes_equal", True)):
                fail(f"tower rung {r['rung']}: the card disagrees with the CPU: {r}")
            del q
        del p
        out.append(r)
    torch.cuda.empty_cache()
    base = out[0]["ms"]
    print(f"tower rungs ViT-B/32 (random weights) on the flagship bank (64 cuts, bf16), forward + input gradient "
          f"per call: summed kernel ms (against the first rung) / CUDA events of an eager call, card against CPU on "
          f"{TOWER_CPU_CUTS} cuts (tol {TOWER_ATOL}): "
          + "; ".join(f"{r['rung']}: {r['ms']:.3f} ({r['ms'] / base:.2f}x) / {r['event_ms']:.3f} ms"
                      + f", LayerNorm {r['ln']}"
                      + (f", card vs CPU {r['card_vs_cpu']:.2e}" if "card_vs_cpu" in r else "")
                      + (f", s8 codes equal {r['codes_equal']}" if "codes_equal" in r else "") for r in out)
          + f"; on {card}", flush=True)
    return out


def ladder_launches(rows, counter):
    """A rung variant's launches over the ladder rows; fatal if no row launched it."""
    total = sum(r["launches"][counter] for r in rows.values())
    if total < 1:
        fail(f"no ladder row launched {counter}")
    return total


def phase_ladder(tmp, card):
    """34: bench.py's precision-ladder gate on the pixel row (60 steps, one
    seed, blocked) at the JAX package's default rungs against EXACT_RUNGS:
    last5(default) - last5(exact) <= LADDER_BAND, and each knob of the
    defaults alone, and the rungs no default takes, 17 steps each; per row
    the descent, steps/s, and one replay's device busy and K1/K2 variants
    (torch.profiler).  Returns {label: (launches, steps run, row)}."""
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.ops.warp_batch import bwd_prec

    sd = vit_b32_weights()
    rows = {}
    for label, rungs, steps in RUNG_ROWS:
        sub = os.path.join(tmp, label.replace(" ", "_").replace(",", ""))
        os.makedirs(sub)
        with rung_env(rungs):
            engine, losses, launches, init_s, elapsed, timed = drive_path(
                dict(PIXEL_CONFIG, iterations=steps), sub, steps, WARMUP_STEPS, state_dicts={"ViT-B/32": sd})
        rg = engine.rungs
        fwd = cuda_warp.FWD_COUNTERS[rg.warp]
        bwd = cuda_warp.BWD_COUNTERS[bwd_prec(rg.warp, rg.warp_bwd, 224)]
        blk = engine.step_block
        ran = steps_run(engine, steps)
        # each rung's kernel and its helper passes, once per step
        counters = [c for k in (fwd, bwd) for c in (k, *cuda_warp.HELPERS.get(k, ()))]
        want = {cuda_warp.KERNEL_NAMES[c]: blk.n for c in counters}
        events, seen, _ = replay_events(blk.graph, want, f"ladder {label}")
        # device busy per step; for the rows a default is decided on, from BUSY_WINDOWS replays,
        # to set a knob's change against the spread
        windows = BUSY_WINDOWS if label in VERDICT_ROWS else 1
        busy = [busy_ms(events) / blk.n] + [busy_ms(profiled_events(blk.graph.replay, 1)) / blk.n
                                            for _ in range(windows - 1)]
        if {k: launches[k] for k in cuda_warp.LAUNCHES} != {k: ran if k in counters else 0 for k in cuda_warp.LAUNCHES}:
            fail(f"ladder {label}: launches {launches}, expected {ran} of each of {counters}")
        first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        if label in ("exact", "JAX defaults"):
            check_descent(f"ladder {label}", losses)
        rows[label] = {"first5": first5, "last5": last5, "steps": steps, "rate": timed / elapsed if timed else None,
                       "busy_ms": statistics.median(busy), "busy": busy, "events": len(events) / blk.n, "replay": seen,
                       "launches": launches, "ran": ran, "quant": engine.perceptors[0].quant, "rungs": rg}
        del engine
        torch.cuda.empty_cache()
    gap = rows["JAX defaults"]["last5"] - rows["exact"]["last5"]
    for label, r in rows.items():
        rate = "" if r["rate"] is None else f"{r['rate']:.3f} steps/s over the steps after {WARMUP_STEPS}; "
        launched = {k: v for k, v in r["launches"].items() if v}
        print(f"ladder {label} (pixel 384x216, ViT-B/32, 64 cuts, {r['steps']} steps, blocked; {r['rungs']}): "
              f"first5 {r['first5']:.4f} -> last5 {r['last5']:.4f}; {rate}device busy per step "
              f"{r['busy_ms']:.3f} ms (median of the replays {[round(b, 3) for b in r['busy']]}), "
              f"{r['events']:.1f} device events per step; one replay {r['replay']}; launches {launched} over "
              f"{r['ran']} steps; on {card}", flush=True)
    ex = rows["exact"]["busy"]
    verdict = {}
    for knob, label in (("PIXRAY_TPU_WARP_PREC=int8", "warp int8 alone"),
                        ("PIXRAY_TPU_CLIP_PREC=int8b", "tower int8b alone"),
                        ("PIXRAY_TPU_CLIP_LN32=0", "LayerNorm bf16 alone")):
        b = rows[label]["busy"]
        verdict[knob] = (f"{statistics.median(b) - statistics.median(ex):+.3f} ms, "
                         + ("falls" if max(b) < min(ex) else "does not fall") + " below every exact replay")
    print(f"ladder gate (bench.py check_precision_gate): last5(JAX defaults) - last5(exact) = {gap:+.4f} "
          f"(band {LADDER_BAND}); device busy per step: JAX defaults "
          f"{rows['JAX defaults']['busy_ms']:.3f} ms, exact {rows['exact']['busy_ms']:.3f} ms; each knob alone "
          f"against exact (medians of {BUSY_WINDOWS} replays): {verdict}", flush=True)
    if not gap <= LADDER_BAND:
        fail(f"ladder gate: the JAX default rungs converge {gap:+.4f} worse than exact arithmetic "
             f"(band {LADDER_BAND})")
    return rows


PARALLEL_STEPS = 3  # run_parity's n_steps
PARALLEL_TOL = 2e-3  # run_parity's tolerances: per-step |loss delta| and the final latent's, relative
# The final latent is held in the L2 norm, ||dz|| / ||z||: run_parity's max |dz| / max |z| fails
# correct code at full width.  Adam moves each element by ~lr * sign(g) in its first steps, and an
# element whose gradient is near 0 flips with any regrouping of a sum: two unsharded bf16 runs
# part by 1.4e-2 there (K2's float atomics), and at f32 (runs bitwise-near) sharding's regrouped
# sums moved 20 of 14,400 elements by more than 1e-3.  In the L2 norm sound runs read at most
# 5.6e-4 and planted faults 8.4e-3 (each chunk stretched by its own range) and 5.7e-2 (both
# ranks on chunk 0); the loss gate reads those faults at only 2.5e-3 and 2.1e-3 (PERF.md §6).
# Both forms are printed.
PARALLEL_DEADLINE = 240.0  # per launch: each rank reaches the card (~8 s), builds its towers, steps
PARALLEL_THREADS = 2  # host threads per rank (4 ranks on the machine's 8 cores)
# (label, config, mesh, per rank: K1 and K2 launches per step); MIXED_CONFIG's
# towers RN50, ViT-B/16, SLIP_VITB16 on two groups: members 0 and 2 on group 0
PARALLEL_ROWS = (
    ("pixel (2, 1)", PIXEL_CONFIG, "2,1", [(1, 1), (1, 1)]),
    ("mixed better (1, 2)", MIXED_CONFIG, "1,2", [(3, 2), (3, 1)]),
)


def phase_parallel(card):
    """35: the parallel layer on the card.  Every rank is spawned from here
    (``pixray_tpu_torch.parallel.dryrun.launch``), shares cuda:0 with the
    others and joins a gloo group (NCCL refuses two ranks on one device):
    (a) the pixel row on mesh (2, 1) and (b) MIXED_CONFIG on (1, 2) (3
    members on 2 groups), PARALLEL_STEPS eager steps each against the same
    steps unsharded in this process, per-step loss and the final latent (in
    the L2 norm) within PARALLEL_TOL, beside the gaps of two unsharded runs;
    every rank's latent bitwise rank 0's after every step, K1 and K2 per
    rank and step as the design gives; (c) ``python -m
    pixray_tpu_torch.parallel.dryrun 4 --device cuda``'s sweep (run_parity
    on (4, 1), (2, 2) and FSDP on (2, 2), whose gathered weights are the
    unsharded ones bitwise); (d) a 1-rank NCCL group joined through
    ``init_distributed`` sums a latent-gradient-sized buffer.  A rank that
    raises, hangs past PARALLEL_DEADLINE or exits non-zero fails the phase.
    ms per step and peak memory per rank are printed for the record: ranks
    that share one card say nothing of scaling.  Returns {row: (launches
    summed over the steps, steps)} per rank."""
    import numpy as np
    import torch

    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.parallel import dryrun

    torch.cuda.empty_cache()
    fwd, bwd = cuda_warp.FWD_COUNTERS["highest"], cuda_warp.BWD_COUNTERS["highest"]
    rows, numel = {}, None
    for label, config, shape, want in PARALLEL_ROWS:
        d, m = (int(x) for x in shape.split(","))
        t0 = time.perf_counter()
        try:
            ranks = dryrun.launch(dryrun.run_config, d * m, config, PARALLEL_STEPS, "cuda", shape,
                                  deadline=PARALLEL_DEADLINE, threads=PARALLEL_THREADS)
        except Exception as exc:  # a rank's failure fails the phase
            fail(f"parallel {label}: {exc}")
        launch_s = time.perf_counter() - t0
        base = dryrun.run_config(config, PARALLEL_STEPS, "cuda")
        pair = dryrun.agreement(dryrun.run_config(config, PARALLEL_STEPS, "cuda"), base)  # the eager spread
        numel = numel or base["z"].size
        parts = []
        for r, out in enumerate(ranks):
            gap = dryrun.agreement(out, base)
            if out["mesh"] != {"data": d, "model": m} or out["names"] != base["names"]:
                fail(f"parallel {label} rank {r}: mesh {out['mesh']}, terms {out['names']} (unsharded {base['names']})")
            if not (np.all(np.isfinite(out["losses"])) and gap["loss"] <= PARALLEL_TOL and gap["z_l2"] <= PARALLEL_TOL):
                fail(f"parallel {label} rank {r}: losses {out['losses']} against unsharded {base['losses']}: "
                     f"{gap} (tolerance {PARALLEL_TOL} on loss and z_l2)")
            if not out["bitwise"] or out["z"].tobytes() != ranks[0]["z"].tobytes():
                fail(f"parallel {label} rank {r}: its latent is not rank 0's bit for bit")
            per_step = [(s.get(fwd, 0), s.get(bwd, 0)) for s in out["launches"]]
            if any(k != want[r] for k in per_step) or any(sum(s.values()) != sum(want[r]) for s in out["launches"]):
                fail(f"parallel {label} rank {r}: launches per step {out['launches']}, expected K1/K2 {want[r]}")
            rows[f"parallel {label} rank {r}"] = ({fwd: sum(k[0] for k in per_step), bwd: sum(k[1] for k in per_step)},
                                                  PARALLEL_STEPS)
            parts.append(f"rank {r}: K1/K2 per step {want[r]}, loss delta {gap['loss']:.3e}, latent delta "
                         f"{gap['z_l2']:.3e} (L2; max element {gap['z']:.3e}), ms per step "
                         f"{[round(x, 2) for x in out['ms']]}, peak {out['peak_mib']:.1f} MiB")
        print(f"parallel {label} ({config['clip_models'] if 'clip_models' in config else 'quality better, mixed'}, "
              f"{PARALLEL_STEPS} eager steps, gloo on one card): losses {[round(x, 6) for x in ranks[0]['losses']]} "
              f"against unsharded {[round(x, 6) for x in base['losses']]}; {'; '.join(parts)}; unsharded ms per step "
              f"{[round(x, 2) for x in base['ms']]}, peak {base['peak_mib']:.1f} MiB; two unsharded runs part by loss "
              f"{pair['loss']:.3e}, latent {pair['z_l2']:.3e} (L2; max element {pair['z']:.3e}); ranks' latents bitwise equal "
              f"after every step; launch {launch_s:.1f} s; on {card}", flush=True)
    t0 = time.perf_counter()
    try:
        reports = dryrun.main(["4", "--device", "cuda", "--deadline", str(PARALLEL_DEADLINE)])
    except Exception as exc:
        fail(f"parallel dryrun 4 --device cuda: {exc}")
    kinds = [(r["shape"]["data"], r["shape"]["model"], r["ensemble"], r["fsdp"]) for r in reports]
    if kinds != [(4, 1, False, 0), (2, 2, True, 0), (2, 2, False, 1)]:
        fail(f"parallel dryrun: meshes {kinds}")
    print(f"parallel dryrun 4 --device cuda: {len(reports)} meshes in {time.perf_counter() - t0:.1f} s "
          f"(FSDP's gathered weights bitwise the unsharded ones)", flush=True)
    try:
        (nccl,) = dryrun.launch(dryrun.all_reduce_check, 1, numel, deadline=PARALLEL_DEADLINE)
    except Exception as exc:
        fail(f"parallel NCCL check: {exc}")
    if nccl["backend"] != "nccl" or not nccl["exact"]:
        fail(f"parallel NCCL check: {nccl}")
    print(f"parallel NCCL: a 1-rank {nccl['backend']} group joined through init_distributed summed "
          f"{nccl['numel']} float32 (the pixel row's latent gradient) in {nccl['ms']:.3f} ms, bits kept; on {card}",
          flush=True)
    return rows


PARALLEL_BLOCK_STEPS = 17  # 35 (e): an eager step (its checkin), then 2 blocks of 8
# 35 (e) holds the final latents of the blocked sharded and unsharded runs within
# max(PARALLEL_TOL, PARALLEL_SPREAD x the L2 gap of two unsharded blocked runs from one seed):
# after 17 steps K2's float atomics, through Adam, part two unsharded runs of the pixel row by
# 6.0e-3 (L2) and the sharded run from one of them by 5.7e-3 (PERF.md §6, PR 19)
PARALLEL_SPREAD = 2.0


def phase_parallel_blocks(card):
    """35 (e): the sharded step in blocks on NCCL, at the pixel row's width,
    on one rank spawned into a 1-rank NCCL group (``init_distributed``'s
    choice with a card for the rank; checked) and its (1, 1) mesh
    (``dryrun.sharded_blocks``): (i) eager sharded, (ii) blocked sharded
    and (iii) blocked unsharded, PARALLEL_BLOCK_STEPS steps each.  Fatal
    unless: each block's first replayed step of (ii) gives the values of
    the eager sharded step from the state it started from and its draws,
    bitwise, and at learning-rate scale 0 a blocked and an eager sharded
    engine from one state give every step's values bitwise over a block
    and keep the latent bitwise (5b's two checks: K2's float atomics part
    two runs with the learning rate on); (ii) within PARALLEL_TOL of (iii)
    at every step's loss, and their final latents (L2) no farther apart
    than PARALLEL_SPREAD times two unsharded blocked runs' (or
    PARALLEL_TOL, the larger); K1 and K2 once per
    replayed step (the capture's counters); and the captured block holds
    one NCCL all-reduce kernel node per step (counted in its
    ``debug_dump``: the profiler drops events).  Prints the ms per step of
    the three (wall to a synchronize, the blocked runs' steps 1-16 less
    the capture; a replay's device ms per step by CUDA events), the
    captures' seconds and peak memory.  Returns {row: (launches, steps)}
    of (ii), its capture's warm-up step counted."""
    import numpy as np

    from pixray_tpu_torch.engine.core import BLOCK_STEPS as block
    from pixray_tpu_torch.ops import cuda_warp
    from pixray_tpu_torch.parallel import dryrun

    fwd, bwd = cuda_warp.FWD_COUNTERS["highest"], cuda_warp.BWD_COUNTERS["highest"]
    n = PARALLEL_BLOCK_STEPS
    label = "parallel blocks (1, 1) pixel"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        try:
            (out,) = dryrun.launch(dryrun.sharded_blocks, 1, PIXEL_CONFIG, n, block, os.path.join(tmp, "block.dot"),
                                   deadline=PARALLEL_DEADLINE, threads=PARALLEL_THREADS)
        except Exception as exc:  # a rank's failure fails the phase
            fail(f"{label}: {exc}")
    launch_s = time.perf_counter() - t0
    runs = out["runs"]
    if out["backend"] != "nccl":
        fail(f"{label}: the 1-rank group's backend is {out['backend']}, not nccl")
    want = [(1 + block * k, block) for k in range((n - 1) // block)]
    got = {name: run["blocks"] for name, run in runs.items()}
    if got != {"eager": [], "blocked": want, "unsharded": want, "unsharded2": want}:
        fail(f"{label}: blocks {got}, expected {want} for the blocked runs and none eager")
    if not all(np.all(np.isfinite(run["losses"])) for run in runs.values()):
        fail(f"{label}: non-finite losses {[run['losses'] for run in runs.values()]}")
    if out["starts"] != {b: True for b, _ in want} or not out["moved"]:
        fail(f"{label}: the first replayed step of each block is not the eager sharded step from the state it "
             f"started from, bitwise: {out['starts']}; the latent moved {out['moved']}")
    lr0 = out["lr0"]
    if lr0["blocks"] != [(1, block)] or not all(lr0["values_bitwise"]) or not lr0["latent_kept"]:
        fail(f"{label}: at learning-rate scale 0 the blocked sharded run parts from the eager one: {lr0}")
    gap = dryrun.agreement(runs["blocked"], runs["unsharded"])
    spread = dryrun.agreement(runs["unsharded2"], runs["unsharded"])
    z_tol = max(PARALLEL_TOL, PARALLEL_SPREAD * spread["z_l2"])
    if not (gap["loss"] <= PARALLEL_TOL and gap["z_l2"] <= z_tol):
        fail(f"{label}: blocked sharded against blocked unsharded {gap} (tolerance {PARALLEL_TOL} on the loss, "
             f"{z_tol:.3e} on z_l2; two unsharded runs part by {spread})")
    for name in ("blocked", "unsharded", "unsharded2"):
        if runs[name]["recorded"] != {fwd: block, bwd: block}:
            fail(f"{label}: one replay of the {name} block launches {runs[name]['recorded']}, expected K1 and K2 "
                 f"{block} times each")
    if out["nccl_nodes"] != block:
        fail(f"{label}: the captured block holds {out['nccl_nodes']} NCCL all-reduce kernel nodes of "
             f"{out['kernel_nodes']}, expected {block} (one a step)")
    eager_ms = statistics.median(runs["eager"]["ms"][1:])
    wall = {name: (sum(runs[name]["ms"][1:]) - 1e3 * runs[name]["capture_s"]) / (n - 1)
            for name in ("blocked", "unsharded")}
    print(f"{label} (ViT-B/32, 64 cuts, 384x216, exact rungs; one rank, backend {out['backend']}): {n} steps each, "
          f"blocks {want}; the first replayed step of each block bitwise the eager sharded step from the state it "
          f"started from {out['starts']}; learning-rate scale 0: {sum(lr0['values_bitwise'])} of {block} steps' "
          f"values bitwise, latent kept bitwise {lr0['latent_kept']}; blocked sharded against blocked unsharded: "
          f"loss {gap['loss']:.3e}, latent {gap['z_l2']:.3e} (L2; max element {gap['z']:.3e}), two unsharded runs: "
          f"loss {spread['loss']:.3e}, latent {spread['z_l2']:.3e} (L2; max element {spread['z']:.3e}); K1/K2 per replayed "
          f"step {runs['blocked']['recorded'][fwd] / block:.2f} / {runs['blocked']['recorded'][bwd] / block:.2f}; "
          f"{out['nccl_nodes']} NCCL all-reduce nodes of {out['kernel_nodes']} kernel nodes in the captured block; "
          f"ms per step (wall, blocked without the capture): (i) eager sharded {eager_ms:.3f}, (ii) blocked sharded "
          f"{wall['blocked']:.3f}, (iii) blocked unsharded {wall['unsharded']:.3f}; one replay's device ms per step "
          f"(ii) {runs['blocked']['replay_ms'] / block:.3f}, (iii) {runs['unsharded']['replay_ms'] / block:.3f}; "
          f"capture s (ii) {runs['blocked']['capture_s']:.3f}, (iii) {runs['unsharded']['capture_s']:.3f}; peak MiB "
          f"(i) {runs['eager']['peak_mib']:.1f}, (ii) {runs['blocked']['peak_mib']:.1f}, (iii) "
          f"{runs['unsharded']['peak_mib']:.1f}; launch {launch_s:.1f} s; on {card}", flush=True)
    total = {k: sum(s.get(k, 0) for s in runs["blocked"]["launches"]) for k in (fwd, bwd)}
    return {label: (total, n + 1)}


def memo_random_inits():
    """Draw each random tower and VQGAN once per process: wrap the
    ``init_random_`` that the port's perceptors and VQGAN drawer call with a
    memo keyed by the model's class, its config and the generator's seed,
    which hands a later build of the same model the same seeded weights
    (the draw takes ~3 s of host time for ViT-B/32; the script builds
    engines on random towers some dozens of times)."""
    from pixray_tpu_torch.drawers import vqgan as vqgan_drawer
    from pixray_tpu_torch.models import perceptor

    def memo(draw):
        drawn = {}

        def init_random_(model, gen):
            key = (type(model).__name__, repr(getattr(model, "config", None)), str(gen.device), gen.initial_seed())
            if key in drawn:
                model.load_state_dict(drawn[key])
            else:
                draw(model, gen)
                drawn[key] = {k: v.detach().clone() for k, v in model.state_dict().items()}
            return model

        return init_random_

    for module in (perceptor, vqgan_drawer):
        module.init_random_ = memo(module.init_random_)


def phase_timer():
    """A function that prints the seconds since its last call (or since
    this one) and since this one, under a label: where the script's time
    goes, phase by phase."""
    start = last = time.perf_counter()

    def tick(label):
        nonlocal last
        now = time.perf_counter()
        print(f"phase time: {label} {now - last:.1f} s (total {now - start:.1f} s)", flush=True)
        last = now

    return tick


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    memo_random_inits()
    tick = phase_timer()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}",
          flush=True)

    for lib, secs in build_all().items():
        print(f"build: {secs:.1f} s ({lib})", flush=True)

    flagship, small, bank64 = phase_kernels()
    tick("phase_kernels")
    warp_batch = phase_warp_batch()
    tick("phase_warp_batch")
    bank = phase_bank_kernels()
    tick("phase_bank_kernels")
    phase_bank_no_jitter(bank[0])
    tick("phase_bank_no_jitter")
    strokes = phase_stroke_kernels()
    tick("phase_stroke_kernels")
    sizes = phase_bank_sizes(bank[0])
    tick("phase_bank_sizes")
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, PIXEL_CONFIG, "pixel")
    tick("phase_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, CLIPDRAW_CONFIG, "clipdraw", strokes=16)
    tick("phase_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, VQGAN_CONFIG, "vqgan tiny_test",
                        state_dicts={"vqgan": wide_codebook_weights("tiny_test")},
                        vqgan_model="tiny_test", clip_models="TinyTest,TinyTest48")
    tick("phase_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, PIXEL_CONFIG, f"plug-ins (pixel, transparent, {PLUGIN_EXTRA['filters']}, "
                        f"{PLUGIN_EXTRA['custom_loss']}, palette {PLUGIN_EXTRA['palette']})", **PLUGIN_EXTRA)
    tick("phase_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_tower_agreement(tmp)
    tick("phase_tower_agreement")
    for config, label, steps in ((PIXEL_CONFIG, "pixel", BLOCKED_STEPS), (CLIPDRAW_CONFIG, "clipdraw", BLOCKED_STEPS),
                                 (VQGAN_CONFIG, "vqgan", 8), (RN50_CONFIG, "rn50", BLOCKED_STEPS),
                                 (tiler_config("tiler_fft_shift"), "tiler_fft_shift (a filter's shifts)",
                                  BLOCKED_STEPS)):
        with tempfile.TemporaryDirectory() as tmp:
            phase_blocked(tmp, config, label, steps, card)
    tick("phase_blocked")
    for config, label in ((PIXEL_CONFIG, "pixel"), (VQGAN_CONFIG, "vqgan")):
        with tempfile.TemporaryDirectory() as tmp:
            phase_ranged_blocks(tmp, config, label, card)
    tick("phase_ranged_blocks")
    with tempfile.TemporaryDirectory() as tmp:
        launches, main_steps = phase_main_path(tmp, card)
    tick("phase_main_path")
    with tempfile.TemporaryDirectory() as tmp:
        phase_rn50_path(tmp, card)
    tick("phase_rn50_path")
    for config, label in ((BEST_CONFIG, "best"), (MIXED_CONFIG, "mixed better")):
        with tempfile.TemporaryDirectory() as tmp:
            phase_preset_row(tmp, card, config, label)
    tick("phase_preset_row")
    with tempfile.TemporaryDirectory() as tmp:
        stroke_launches, _ = phase_clipdraw_path(tmp, card)
    tick("phase_clipdraw_path")
    with tempfile.TemporaryDirectory() as tmp:
        phase_line_sketch(tmp)
    tick("phase_line_sketch")
    with tempfile.TemporaryDirectory() as tmp:
        vqgan_engine = phase_vqgan_path(tmp, card)
    tick("phase_vqgan_path")
    phase_decoder_times(vqgan_engine.drawer.model)
    tick("phase_decoder_times")
    del vqgan_engine
    with tempfile.TemporaryDirectory() as tmp:
        phase_vqgan_default(tmp)
    tick("phase_vqgan_default")
    with tempfile.TemporaryDirectory() as tmp:
        phase_fft_path(tmp, card)
    tick("phase_fft_path")
    with tempfile.TemporaryDirectory() as tmp:
        phase_tiler_recipes(tmp, card)
    tick("phase_tiler_recipes")
    with tempfile.TemporaryDirectory() as tmp:
        phase_fft_modes(tmp)
    tick("phase_fft_modes")
    with tempfile.TemporaryDirectory() as tmp:
        phase_agreement(tmp, PIXEL_CONFIG, "image row (init image, image prompt, spot, spot_off, target, label)",
                        **image_extra(write_images(tmp)))
    tick("phase_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_image_row(tmp, card)
    tick("phase_image_row")
    with tempfile.TemporaryDirectory() as tmp:
        phase_overlay_row(tmp, card)
    tick("phase_overlay_row")
    with tempfile.TemporaryDirectory() as tmp:
        phase_animation_row(tmp, card)
    tick("phase_animation_row")
    with tempfile.TemporaryDirectory() as tmp:
        phase_optimizers(tmp, card)
    tick("phase_optimizers")
    with tempfile.TemporaryDirectory() as tmp:
        phase_resume(tmp, card)
    tick("phase_resume")
    with tempfile.TemporaryDirectory() as tmp:
        phase_video_and_trace(tmp, card)
    tick("phase_video_and_trace")
    with tempfile.TemporaryDirectory() as tmp:
        phase_anim_agreement(tmp)
    tick("phase_anim_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_checkpoints(tmp)
    tick("phase_checkpoints")
    rows = {"pixel": (launches, main_steps)}
    with tempfile.TemporaryDirectory() as tmp:
        phase_vdiff_agreement(tmp)
    tick("phase_vdiff_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        rows["vdiff"] = phase_vdiff_path(tmp, card)
    tick("phase_vdiff_path")
    with tempfile.TemporaryDirectory() as tmp:
        rows["cc12m"] = phase_cc12m(tmp, card)
    tick("phase_cc12m")
    with tempfile.TemporaryDirectory() as tmp:
        rows["pixray_vdiff.yaml"] = phase_vdiff_recipe(tmp, card)
    tick("phase_vdiff_recipe")
    phase_esrgan(card)
    tick("phase_esrgan")
    with tempfile.TemporaryDirectory() as tmp:
        phase_blocked(tmp, SR_CONFIG, "super_resolution", BLOCKED_STEPS, card)
    tick("phase_blocked")
    with tempfile.TemporaryDirectory() as tmp:
        rows["super_resolution"] = phase_sr_path(tmp, card)
    tick("phase_sr_path")
    with tempfile.TemporaryDirectory() as tmp:
        phase_new_agreement(tmp)
    tick("phase_new_agreement")
    with tempfile.TemporaryDirectory() as tmp:
        phase_blocked(tmp, dict(PIXEL_CONFIG, pixel_type="hex"), "pixel hex", BLOCKED_STEPS, card)
    tick("phase_blocked")
    with tempfile.TemporaryDirectory() as tmp:
        rows.update(phase_geometry_rows(tmp, card))
    tick("phase_geometry_rows")
    with tempfile.TemporaryDirectory() as tmp:
        rows.update(phase_loss_rows(tmp, card))
    tick("phase_loss_rows")
    rung_cases = phase_rung_kernels()
    tick("phase_rung_kernels")
    rung_flagship = rung_cases[0]
    phase_tower_rungs(card)
    tick("phase_tower_rungs")
    with tempfile.TemporaryDirectory() as tmp:
        ladder = phase_ladder(tmp, card)
    tick("phase_ladder")
    rows.update(phase_parallel(card))
    tick("phase_parallel")
    rows.update(phase_parallel_blocks(card))
    tick("phase_parallel_blocks")
    # last: after its served jobs, torch.profiler saw no kernel in 29 of 30 windows over 13 s on an H100,
    # and 32-35 time kernels by the profiler
    with tempfile.TemporaryDirectory() as tmp:
        rows.update(phase_front_ends(tmp, card))
    tick("phase_front_ends")
    per_row = lambda counter: {row: {"launches": got[counter], "steps": n} for row, (got, n) in rows.items()}

    replaces = "pixray_tpu/ops/pallas_warp.py:{}"
    warp_src = "pixray_tpu_torch/csrc/warp.cu"
    bf = bank[0]
    kernels = [
        {"name": "bank_fwd (K1)", "route": "cuda", "source": warp_src, "replaces": replaces.format(549),
         "launches": launches["warp_fwd"], "launches_by_row": per_row("warp_fwd"),
         "max_abs_err": max([flagship["fwd_err"], small["fwd_err"]] + [r["fwd_err"] for r in [*bank, *sizes]]),
         "ms": bf["fwd_ms"], "plain_ms": bf["fwd_plain_ms"], "bound_ms": bf["fwd_bound_ms"],
         "bound_by": bf["fwd_bound_by"], "library_ms": bf["fwd_lib_ms"]},
        {"name": "bank_bwd (K2)", "route": "cuda", "source": warp_src, "replaces": replaces.format(693),
         "launches": launches["warp_bwd"], "launches_by_row": per_row("warp_bwd"),
         "max_abs_err": max([flagship["bwd_err"], small["bwd_err"]] + [r["bwd_err"] for r in [*bank, *sizes]]),
         "ms": bf["bwd_ms"], "plain_ms": bf["bwd_plain_ms"], "bound_ms": bf["bwd_bound_ms"],
         "bound_by": bf["bwd_bound_by"], "library_ms": bf["bwd_lib_ms"]},
    ]
    # the rung variants: launches from the ladder rows (each driven with the counts at 0 just before it)
    from pixray_tpu_torch.ops import cuda_warp

    for prec, line in (("int8", 571), ("bf16", 587), ("high", 587)):
        counter, r = cuda_warp.FWD_COUNTERS[prec], rung_flagship["fwd"][prec]
        kernels.append({"name": f"bank_fwd_{prec} (K1-{prec})", "route": "cuda", "source": warp_src,
                        "replaces": replaces.format(line), "launches": ladder_launches(ladder, counter),
                        "launches_by_row": {k: v["launches"][counter] for k, v in ladder.items()},
                        "max_abs_err": max(x["fwd"][prec]["max_abs_err"] for x in rung_cases),
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": None})
    for prec, line in (("bf16", 754), ("high", 754), ("int8", 718)):
        counter, r = cuda_warp.BWD_COUNTERS[prec], rung_flagship["bwd"][prec]
        kernels.append({"name": f"bank_bwd_{prec} (K2-{prec})", "route": "cuda", "source": warp_src,
                        "replaces": replaces.format(line), "launches": ladder_launches(ladder, counter),
                        "launches_by_row": {k: v["launches"][counter] for k, v in ladder.items()},
                        "max_abs_err": max(x["bwd"][prec]["max_abs_err"] for x in rung_cases),
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": None})
    # the helper passes of K1-int8 (the scale, the pack), K1-bf16 and K1-high (the pack: _mm's split of the
    # canvas), K2-bf16 (the row table, the sum), K2-int8 (the cotangent pass, the finish) and K2-high (the pack):
    # the forward passes, the row table and the cotangent pass bitwise their plain twins, the others part of their
    # rung's result
    for counter, line, side, prec in (("warp_fwd_int8_scale", 823, "fwd", "int8"),
                                      ("warp_fwd_int8_pack", 824, "fwd", "int8"),
                                      ("warp_fwd_bf16_pack", 67, "fwd", "bf16"),
                                      ("warp_fwd_high_pack", 71, "fwd", "high"),
                                      ("warp_bwd_bf16_rows", 480, "bwd", "bf16"),
                                      ("warp_bwd_bf16_sum", 754, "bwd", "bf16"),
                                      ("warp_bwd_int8_cot", 777, "bwd", "int8"),
                                      ("warp_bwd_int8_finish", 803, "bwd", "int8"),
                                      ("warp_bwd_high_pack", 930, "bwd", "high")):
        r = rung_flagship[side][prec]
        err = (max(x["bwd"][prec]["max_abs_err"] for x in rung_cases)
               if counter in ("warp_bwd_bf16_sum", "warp_bwd_int8_finish", "warp_bwd_high_pack") else 0.0)
        kernels.append({"name": f"{cuda_warp.KERNEL_NAMES[counter]} ({counter})", "route": "cuda",
                        "source": warp_src, "replaces": replaces.format(line),
                        "launches": ladder_launches(ladder, counter),
                        "launches_by_row": {k: v["launches"][counter] for k, v in ladder.items()},
                        "max_abs_err": err, "ms": r["helper_ms"][counter], "plain_ms": r["helper_plain_ms"][counter],
                        "bound_ms": r["helper_bound"][counter][0], "bound_by": r["helper_bound"][counter][1],
                        "library_ms": None})
    stroke_src = "pixray_tpu_torch/csrc/strokes.cu"
    replaces = "pixray_tpu/ops/pallas_strokes.py:{}"
    sf = strokes[0]
    for name, line, counter, err, key, plain in (
            ("strokes_fwd (K4)", 116, "strokes_fwd", "fwd_err", "fwd", "fwd_plain_ms"),
            ("strokes_fwd_store (K4s)", 132, "strokes_fwd_store", "store_err", "store", "fwd_plain_ms"),
            ("strokes_bwd (K5)", 151, "strokes_bwd", "bwd_err", "bwd", "bwd_plain_ms")):
        kernels.append({"name": name, "route": "cuda", "source": stroke_src, "replaces": replaces.format(line),
                        "launches": stroke_launches[counter], "max_abs_err": max(r[err] for r in strokes),
                        "ms": sf[key + "_ms"], "plain_ms": sf[plain], "bound_ms": sf["bounds"][key][0],
                        "bound_by": sf["bounds"][key][1], "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
