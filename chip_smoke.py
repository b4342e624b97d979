#!/usr/bin/env python3
"""Smoke run of rife_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each timed against its own budget:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc compiles the six CUDA sources for sm_90a (the warp, its
   gradient, the fused pair warp + blend, the NHWC warps K3/K4, the
   convblock chain K5 and the gather probes K6-K8), one process each in
   parallel, into
   build/rife_tpu_torch/ (registers and spills from -Xptxas -v);
3. kernels: the warp kernel (K1) against its plain PyTorch version, on
   the card, at the shapes one forward of the paper model's serving path
   and one rung-1 forward of v4.25 give it (bf16), plus one f32 shape and
   a +-200 px per-8x8-block flow that leaves the frame; the fused warp +
   blend kernel against its plain version at its two serving launches
   (v4.25's blend-only, the paper model's with the pair; bf16), in f32
   and with the block flow; kernel, plain-version and library times
   beside the memory bound, and K1's launch plan at each shape (tiles,
   threads, pixels a thread, channel groups, vector runs) and K2's at its
   two launches (tiles, threads, pixels a thread, vector runs);
4. main path: InferenceEngine("rife", fast=1, bf16) with the r5 weights
   serves 3 requests of 4 pairs of 720p content (padded to 736x1280);
   each forward must launch the warp kernel 6 times and the fused kernel
   once (7 warps and no fused launch with `use_fuse_blend` off), the
   gradient kernel never; the output must be finite, in [0, 1], >= 40 dB
   PSNR against the port's own f32 output, and the f32 engine on the card
   must agree with the CPU path at 128x192;
5. v4.25: InferenceEngine("v4.25", bf16) with the in-repo v4.25 weights
   serves 3 requests of the same pairs padded to 768x1280 at rung 1 and
   at rung 0: 4 warp launches and 1 final launch (fused, or a 5th warp)
   per forward, >= 40 dB against the port's own f32, timestep 0.25 gives
   another frame than 0.5, the f32 card output agrees with the CPU path;
6. A/B: both models' rung-1 requests with the fused final level and with
   the composed one, interleaved, by CUDA events: the numbers that set
   `use_fuse_blend`'s default;
7. legacy: K3 and K4 (the NHWC warps) at every launch shape of an hdv2
   and an hd forward (batch 4, 736x1280), in every image/flow dtype
   pairing, on a smooth and a +-200 px block flow, bit-equal to their
   plain version and to K1 on the permuted planes; their f32 times beside
   the bytes bound, the plain version, the route through K1 and
   F.grid_sample, and their bf16 times; K3's launch plan (tile, threads,
   vector flow loads and stores) and, where it reads a channel slice (hd's
   half-res frame), its time on a contiguous copy of the image; the
   kernels line's K3 row names its design; then InferenceEngine("hdv2" |
   "hd") in f32 and bf16 with seeded weights (flow heads scaled) serves 3
   requests of the same pairs padded to 736x1280: each forward makes 4 K3
   + 8 K4 launches (hdv2) or 8 K3 + 8 K4 (hd) and no K1 or K2 launch (the
   warm-up's launches are the checked shapes), the output is finite and
   in [0, 1], bf16 >= 40 dB against f32, the f32 card output within 2e-4
   of the CPU path at 128x192; ms/request by CUDA events;
8. train: the gradient kernel against its plain version at the 8 warp
   shapes of one training step (batch 16, 224x224 crops, N = 32) in bf16,
   once in f32 and once with the +-200 px block flow, timed beside its
   bytes bound, the plain version and grid_sampler_2d_backward, with its
   launch plan (tile, threads, channel groups), the share of pixels that
   handed their right taps of d_img to their neighbour (the kernel's own
   count) and the call's device time split into the d_img scratch's
   memset, the kernel and the cast; then the
   training path: the r5 run resumed (params, AdamW state, step 16000)
   trains one warm-up and 10 timed bf16 steps on SyntheticTriplets
   (ms/step, samples/s; 8 forward and 8 backward warp launches per step
   and no fused launch; finite losses; every parameter moves), a profiled
   device-time breakdown of a step, the bf16 step's gradients against the
   f32 step's (cosine >= 0.99 per block), one f32 step on the card
   against the CPU path at 2x64x64 (loss <= 1e-4 relative, gradients
   <= 1e-3 relative norm per parameter), and from a random init at lr
   2e-4 30 steps whose loss must fall below its start and 20 steps on one
   fixed batch whose loss must fall by 10%;
9. convchain: K5, the IFBlock convblock chain kernel (8 x 3x3 conv + bias
   + PReLU, + x; bf16; wgmma fed by TMA over the zero-bordered flat
   layout, one launch per stage): the stage kernel's registers and spills
   (-Xptxas -v), shared memory and ring slots at each width; K5 against
   its plain version on seeded inputs at the three convblock shapes of a
   served rife request (4x46x80x240, 4x92x160x150, 4x184x320x90) and at
   C = 12 on 2x7x9, with 1 stage (every element within 1 bf16 ulp of the
   stage and 1 of the residual sum, plus the f32 summation-order term)
   and 8 (the kernel as close to the unrounded f32 chain as the plain
   version, within 5%), and the r5 weights' 8-stage chains at the served
   shapes (that, and mean relative <= 1e-3 against the plain version);
   then on the model's own data: one rife request (r5, bf16, rung 1)
   captures each block's convblock input and the module's y + x, and K5
   runs the three chains with the blocks' packed weights: 24 launches
   (and the request's 6 warp + 1 fused), mean relative <= 1e-3 against
   the plain version and < 2e-2 against the model's cuDNN chain; at each
   served shape the kernel's tiles and waves, its time (the whole call,
   the copy of x into the flat layout, the parameters' padding and the 8
   launches alone) beside the cuDNN chain (channels-last, NCHW, the convs
   alone), the NCHW -> NHWC copy, the plain version and the tensor-core
   bound.  The served forward itself keeps cuDNN: K5 makes no launch in
   phases 4-8;
10. probes: the round-3 gather probes K6-K8 (rife_tpu_torch.tools.
   gather_probe, the counterparts of tools/r3_exp1.py, r3_exp2.py and
   r3_exp21.py) driven once at the scripts' sizes: the recurrence for
   r3_exp1.py's 8 bodies at R = 4000 in both forms (the tile split into
   the rows, columns or elements a step's gathers close over, a block
   each, and the whole tile in one warp's registers) and for r3_exp2.py's
   7 at 40000 x 32 in the first (block) form, the block copy
   with a per-block source index at 64x256 and on a 181 MB stack, the
   tile gathers (lane, sublane, 8-row broadcast) at 512 and 32768 tiles,
   10 chained cb = 1 warps and 10 chained K3 warps of a 4x736x1280x3 bf16
   image, and r3_exp2.py's five warp shapes through K3/K4 and through K1,
   20 chained each: 23 + 2 + 6 + 10 launches of the new kernels (and 30
   K3, 80 K4, 100 K1); then each against its plain version: the
   recurrence bit-equal (contracting bodies over the whole run, the plain
   version on the host in worker processes; the chaotic unpack bodies
   over 4 steps, and over 4000 bodies the differing elements counted),
   the gathers and copies equal to their plain versions and library
   calls, the warps bit-equal to K3, to each other and to the plain
   version (also on a +-200 px block flow); then their times beside their
   bounds, plain versions and library calls (the cb = 1 warp's row also
   K3's time, its design and its launch plan; the recurrence's records
   its dependent-chain floor at the SM clock, bound by latency, beside
   the card-wide operations).  No launch of these
   kernels in phases 4-9;
11. ladder: the paper model's whole family at full width (batch 4, the
   720p pair padded to 736x1280, or 768x1280 where the engine pads to 64):
   K1 against its plain version at the launch shapes phase 3 does not
   check (the half-resolution context levels of rungs 2-3, rife_2r's full-
   resolution context pyramid, scale 0.5's levels at 768x1280) and K2's
   pair form at 768x1280; then InferenceEngine("rife") with the r5 weights
   at rungs 0-4 and with TTA at rung 1, rife_m (t = 0.25 and 0.5, which
   must differ) and rife_2r from seeded weights (flow heads scaled, flows
   over 2 px), and rife at scale 0.5 (scale list 8/4/2) and 2 (2/1/0.5,
   the last level above full resolution), bf16, 3 requests each: the
   warm-up's K1 launches all at checked shapes, the launches per forward
   (6 K1 + 1 K2 with the pair at rungs 0-1, 7 + 1 blend-only at rungs 2-3,
   2 + 1 blend-only at rung 4, twice with TTA), the output finite and in
   [0, 1], >= 40 dB against the port's own f32 at the same configuration,
   the f32 card output within 2e-4 of the CPU path at 128x192; ms/request
   by CUDA events, frames/s, K1's time per forward from its per-shape
   times;
12. protocol: the r5 checkpoint through the port's Vimeo90K protocol
   (PSNR on the uint8-rounded frame, ssim_matlab on the card) over r4's
   fixture in memory (32 SyntheticTriplets, 256x448, seed 777), in the
   nine configurations of tools/port_eval_checkpoint.py: the f32 rows
   exact, fast2 and fast3 within 0.02 dB PSNR and 1e-4 SSIM of the
   committed CPU rows (rife_tpu_torch/tools/eval_r5_cpu.json), every row
   printed beside them and beside the TPU's train_log_r5/eval_protocol.json,
   the launches counted over the whole phase (54 K1 + 9 K2 a triplet);
13. video: the image and video paths users run.  The native frame ops
   (built with g++) against their numpy versions on a 720p frame; the
   streaming pipeline (`interpolate_video`, an in-memory reader and
   writer) with `rife` (r5, bf16, rung 1) on 25 720x1280 u8 frames panned
   2 px a frame, padded to 736x1280, with one exact duplicate and the
   last frame inverted: at 2X (batches of 4 pairs) the exact frame counts,
   1 static pair and 1 scene cut, every batched midpoint equal to a
   direct engine call on the same stacked pairs and to the frame written
   (cuDNN deterministic), 6 K1 + 1 K2 a forward; again with cuDNN's
   defaults, timed: frames out per second beside the engine alone (CUDA
   events at batch 4 and 1) and the host seconds of upload, probe and the
   writer's fetch; at 4X (the midpoint tree, batch 1); v4.25 (in-repo
   weights, 768x1280) at 4X by timestep on 9 frames (t = 1/4, 2/4, 3/4, 4
   K1 + 1 K2 a forward); r5 exported to a reference .pkl and loaded back
   (the engine's output equal to the .rtpu engine's), `convert` .rtpu ->
   .pkl -> .rtpu (equal tensors); where cv2 is installed (decided up
   front, logged either way), `interp_img --exp 2` on two 720p PNGs,
   `interp_video --img DIR --png` on 5 frames and `DiskInterpolator` from
   3 to 9 frames, through files under build/;
14. serve: the serving app (`rife_tpu_torch.serve`) over HTTP.
   `load_engine` on train_log_r5 must give `rife`, bf16, rung 1 with the
   checkpoint's tensors; its JSON API runs on a free port of 127.0.0.1 in a
   thread, over a temporary upload and output directory: /health "ok"; a
   720x1280 PNG pair (pan 32) at passes 4 gives 17 frames from 15 batch-1
   forwards at 736x1280 (90 K1 + 15 K2 launches), frames handed to the
   encoder equal to `exp_doubling` on the same engine (cuDNN
   deterministic), disk-based equal to `DiskInterpolator`, two concurrent
   requests equal to the sequential ones, then a timed request; a 9-frame
   720p mp4v clip at 2X (17 frames read back), two 5-frame clips at 25
   and 30 fps chained with 3 transition frames, a re-encode; every mp4 of
   `_encode_frames` tagged BT.709; 403 for paths outside the directories,
   401 without credentials where auth is set; no CUDA tensor reaches a
   plain version; host seconds and frames out/s per request, the card's
   memory (`MemoryMonitor`) before and after; then every K1/K2 launch
   shape of the phase against its plain version, the batch-1 ones timed;
15. benchmarks: the six protocol benchmarks through
   `rife_tpu_torch.cli.benchmarks` on fixtures written at run time into a
   temporary directory (a 5-frame 1080p and a 9-frame 720p .yuv clip made
   by `YUV420Writer`; ucf101 2 x 256x256, the 12 Middlebury names at
   388x584 / 480x640, atd12k 2 x 540x960): hd on r5 in f32 (2 forwards at
   1088x1920), hd4x with seeded rife_m (6 at 768x1280), ucf101,
   middlebury and atd12k on r5, testtime in bf16 (20 + 20 forwards at
   480x640; its seconds/frame beside the same forward by CUDA events);
   each printed JSON line finite with the reference's keys, 6 K1 + 1 K2
   launches a forward; every launch shape against its plain version, hd's
   and hd4x's timed;
16. train family: the training of rife_m (on SyntheticSeptuplets),
   rife_2r, v4.25, hdv2 and hd (on SyntheticTriplets) at the reference
   CLI's configuration: batch 16, crop 224 (v4.25's snapped to 192), bf16
   activations with f32 parameters and AdamW state, each model's weight
   decay and schedule from its top (step 2000 of the warmup + cosine, 8000
   of the legacy models' cyclic lr); weights and launch counts from
   rife_tpu_torch/tools/train_family.py (v4.25's checkpoint, the others
   seeded, flow heads scaled).  For each model one warm-up step (its
   launches recorded) and 5 timed steps: ms/step on the host clock and
   samples/s, the launches per step of K1, K1's gradient, K2, K3 and K4
   equal to TRAIN_FAMILY_LAUNCHES (the CPU tests' counts of the plain
   versions), no CUDA tensor reaching a plain version, finite losses,
   every parameter moving; bf16 against f32 gradient cosines per block on
   a batch of the run, both as training runs (cuDNN, no TF32), >= 0.99 for
   the whole objective (the paper family, v4.25) or for the network under
   the f32 objective's cotangent (the legacy models, whose census term
   turns a bf16 frame's rounding into gradient noise; the objective's
   cosines printed beside), at the start weights and, but for the legacy
   models (reported, see TRAIN_COSINE_MIN's comment), after the timed
   steps; one f32 step on the card against the CPU path at 2x64x64 as f32
   training runs (cuDNN, no TF32: loss <= 1e-4 relative, gradients <= 1e-3
   relative norm, rife_2r's <= 5e-3 with the same step through PyTorch's
   own convs held to 1e-3 beside it); 20 steps on one fixed 2x64x64 batch
   (bf16, lr 2e-4) whose loss must fall by 10%.  Then K1, K2, K3 and K4
   against their plain versions at every launch shape of the warm-up
   steps, K1's gradient at every plane shape phase 8 did not check, and
   the NHWC warp's gradient (`warp_nhwc_bwd`: copies into NCHW planes,
   K1's gradient kernel) at every call the legacy models made, in its
   layout (channel slices included), against the plain gradient of the
   permuted planes; each timed beside its bytes bound, its plain version
   and grid_sampler_2d_backward, the NHWC ones also through the wrapper
   (copies included) and with the copies timed apart; and the training CLI
   (v4.25, septuplets, bf16, 2 steps, --vis_interval 1) writing 12 panels
   under build/.  Every check of the phase runs; it fails at its end if
   any did.

Prints a `kernels` JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Exits non-zero, without that last line,
when there is no CUDA device or any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "train_log_r5", "flownet.rtpu")
CKPT_V425 = os.path.join(ROOT, "train_log_r5_v425", "flownet.rtpu")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
TOTAL_BUDGET_S = 600
HARD_STOP_S = 1100
BUDGET_S = {"device": 30, "build": 60, "kernels": 120, "main path": 150,
            "v4.25": 150, "A/B": 90, "legacy": 200, "train": 300, "convchain": 90,
            "probes": 60, "ladder": 150, "protocol": 90, "video": 150, "serve": 150,
            "benchmarks": 150, "train family": 300}
# Phase 10 compares r3_exp2.py's chaotic bodies over this many steps of 32
# bodies (the whole run, 40000, takes the plain version minutes; the tool
# compares it).
PROBE_CHAOTIC_OUTER = 125
BATCH, FRAME_H, FRAME_W, PAN = 4, 720, 1280, 32
TIMED_LAUNCHES = 20
# One forward of the rung-1 main path at batch 4 (736x1280): each launch
# warps a batch-concatenated pair (N = 8).  (name, C, H, W, launches).
# The final level's pair is the fused kernel's launch (BLEND_LAUNCHES), or
# one more full-resolution warp launch with `use_fuse_blend` off.
MAIN_PATH_WARPS = [
    ("level-1 pair, half res", 3, 368, 640, 1),
    ("level-1 pair, full res", 3, 736, 1280, 1),
    ("context level 0", 16, 368, 640, 1),
    ("context level 1", 32, 184, 320, 1),
    ("context level 2", 64, 92, 160, 1),
    ("context level 3", 128, 46, 80, 1),
]
LAUNCHES_PER_FORWARD = sum(m[-1] for m in MAIN_PATH_WARPS)
# v4.25 at batch 4 (768x1280): the 7-channel [img | feat] pair warps
# (N = 8) per forward, by rung, before the final level.  (name, C, H, W,
# launches per rung-1 forward, per rung-0 forward.)
V425_PAD = 64
V425_WARPS = [
    ("level-1 input at 1/8", 7, 96, 160, 1, 0),
    ("level-2 input at 1/4", 7, 192, 320, 1, 0),
    ("level-3 input at 1/2", 7, 384, 640, 1, 0),
    ("full res", 7, 768, 1280, 1, 4),
]
# The fused kernel's launches on the serving paths, one per forward:
# (name, C, H, W, emit_pair); images, flow and mask bf16, N = BATCH.
BLEND_LAUNCHES = [
    ("v4.25 final level, blend only", 3, 768, 1280, False),
    ("rife final level, with the pair", 3, 736, 1280, True),
]
AB_ROUNDS, AB_REQUESTS = 10, 5
# One bf16 training step at batch 16 on 224x224 crops: 8 warps, each a
# batch-concatenated pair (N = 32) of bf16 planes, each with a backward
# launch.  The teacher's flow is f32 (ifnet.py sums it in f32); the
# others are bf16.  d_img is needed only where the warped tensor has a
# gradient (the context features).  The warm-up step checks that these
# are the launches the step makes.
# (name, C, H, W, launches, flow dtype, need_img).
TRAIN_BATCH, TRAIN_CROP = 16, 224
TRAIN_STEP_WARPS = [
    ("level 0-2 pairs", 3, 224, 224, 3, torch.bfloat16, False),
    ("teacher pair", 3, 224, 224, 1, torch.float32, False),
    ("context level 0", 16, 112, 112, 1, torch.bfloat16, True),
    ("context level 1", 32, 56, 56, 1, torch.bfloat16, True),
    ("context level 2", 64, 28, 28, 1, torch.bfloat16, True),
    ("context level 3", 128, 14, 14, 1, torch.bfloat16, True),
]
LAUNCHES_PER_STEP = sum(m[4] for m in TRAIN_STEP_WARPS)
# Phase 16's presets, their weights and their launches per training step
# are rife_tpu_torch/tools/train_family.py's, which the CPU tests share.
TRAIN_FAMILY_TIMED_STEPS = 5
# The timed runs start where the model's schedule is at its top: the end
# of the warmup (2000) or the cyclic lr's peak (8000).
TRAIN_FAMILY_START = {"rife_m": 2000, "rife_2r": 2000, "v4.25": 2000, "hdv2": 8000,
                      "hd": 8000}
# The f32 card-vs-CPU step's batch, per model: (seed, timesteps), as
# tests/test_torch_train_{objectives,hdv2,hd}.py hold each objective.
TRAIN_FAMILY_SMALL = {"rife_m": (3, 0.25), "rife_2r": (4, None), "v4.25": (5, (0.25, 0.7)),
                      "hdv2": (6, None), "hd": (6, None)}
# Phase 16's limits.  bf16 against f32 gradient cosines per block, at the
# start weights and after the timed steps: TRAIN_COSINE_MIN.  The legacy
# models' after the timed steps are reported: 5 steps at the cyclic lr's
# peak can take their flows from 0.6-2 px to tens (hd 0.64 -> 37.7 px
# mean in one run), where bf16 flows are 0.25-1 px apart, and the network
# cosines there read down to 0.64 (hd) and -0.02 (hdv2) on an H100 80GB
# HBM3 (700 W), which of the two falls changing from run to run.  After
# such steps rife_tpu's bf16 gradients stray from its f32 ones as far as
# the port's do (tests/test_torch_train_bf16.py).  One f32 step on the card against the
# CPU path, as f32 training runs (cuDNN, no TF32): loss within 1e-4
# relative and every gradient within TRAIN_F32_GRAD_MAX relative norm, or
# the model's TRAIN_F32_CUDNN_GRAD_MAX where cuDNN's own f32 algorithms
# cannot hold that.  rife_2r's first context conv (3 input channels at
# full resolution) reads 3.43e-3 on its PReLU slope, the same in six runs
# on that card; the same step with PyTorch's own convs in place of
# cuDNN's (the port's kernels and code unchanged) reads 3.7e-4, and the
# phase runs that step as the witness, held to TRAIN_F32_GRAD_MAX.
TRAIN_COSINE_MIN = 0.99
TRAIN_F32_GRAD_MAX = 1e-3
TRAIN_F32_CUDNN_GRAD_MAX = {"rife_2r": 5e-3}
TRAIN_TIMED_STEPS = 10
R5_STEPS = 16000  # the r5 run's length, its cosine horizon
SMOKE_DTYPE = torch.bfloat16
# The legacy models (hdv2, hd) at batch 4 (736x1280): no weights in the
# repo, so seeded random ones with each block's flow head scaled by
# LEGACY_FLOW_GAIN (at random init the flows stay under a pixel and would
# leave the warps idle; tests/test_torch_legacy.py scales the same way).
# Their NHWC warps per forward, f32 (name, C, N, H, W, the image's pixel
# stride, launches per hdv2 forward, per hd forward): K3 takes C < 8, K4
# C >= 8.  The flows are contiguous 2-channel NHWC tensors; hd's half-
# resolution frames are channel slices of the 6-channel downsampled pair.
LEGACY_FLOW_GAIN = 20.0
# Phase 11, the paper model's family at full width: (label, model, rung,
# scale, timestep, TTA, K1 launches per forward, whether the final K2
# launch stores the pair).  From rung 2 the refine stage runs one octave
# down (one more pair warp; its 4 context levels at half resolution), from
# rung 3 the final flow level too (scale list (4, 2, 2)), at rung 4 there
# is no refine stage; K2 stores w0/w1 only where the full-resolution U-Net
# reads them.  rife_2r has no fast rungs (its context level 0 runs at full
# resolution); TTA doubles each count.  rife_m and rife_2r have no weights
# in the repo: seeded ones, each block's flow head scaled by
# FAMILY_FLOW_GAIN (at random init their flows stay near a pixel).
LADDER_CONFIGS = [
    *((f"rife rung {r}", "rife", r, 1.0, 0.5, False, k1, pair)
      for r, k1, pair in ((0, 6, True), (1, 6, True), (2, 7, False), (3, 7, False),
                          (4, 2, False))),
    ("rife rung 1 TTA", "rife", 1, 1.0, 0.5, True, 6, True),
    ("rife_m t=0.25", "rife_m", 1, 1.0, 0.25, False, 6, True),
    ("rife_m t=0.5", "rife_m", 1, 1.0, 0.5, False, 6, True),
    ("rife_2r", "rife_2r", 1, 1.0, 0.5, False, 6, True),
    ("rife scale 0.5", "rife", 1, 0.5, 0.5, False, 6, True),
    ("rife scale 2", "rife", 1, 2.0, 0.5, False, 6, True),
]
LADDER_REQUESTS = 3
FAMILY_FLOW_GAIN = 4.0
# K1's launch shapes on phase 11's paths that phase 3 does not check (bf16
# image and flow, N = 2 x BATCH): (name, C, H, W).  The warm-up of each
# configuration records its launches, which must all be checked shapes.
LADDER_WARPS = [
    ("rungs 2-3: context level 0, half res", 16, 184, 320),
    ("rungs 2-3: context level 1, half res", 32, 92, 160),
    ("rungs 2-3: context level 2, half res", 64, 46, 80),
    ("rungs 2-3: context level 3, half res", 128, 23, 40),
    ("rife_2r: context level 0, full res", 16, 736, 1280),
    ("rife_2r: context level 1", 32, 368, 640),
    ("rife_2r: context level 2", 64, 184, 320),
    ("rife_2r: context level 3", 128, 92, 160),
    ("scale 0.5 (768x1280): level-1 input at 1/4", 3, 192, 320),
    ("scale 0.5 (768x1280): level-2 input at 1/2", 3, 384, 640),
    ("scale 0.5 (768x1280): context level 0", 16, 384, 640),
    ("scale 0.5 (768x1280): context level 1", 32, 192, 320),
    ("scale 0.5 (768x1280): context level 2", 64, 96, 160),
    ("scale 0.5 (768x1280): context level 3", 128, 48, 80),
]
# Phase 13, the video path: a clip of VIDEO_FRAMES 720p u8 frames panned
# VIDEO_PAN px a frame (probe SSIM of a pair ~0.65, far from the 0.996 and
# 0.2 gates), at 2X in batches of VIDEO_BATCH pairs and at 4X; v4.25 at 4X
# by timestep on V425_VIDEO_FRAMES frames; the CLIs through files on
# VIDEO_IO_FRAMES of them (where cv2 is installed); the engine alone timed
# over VIDEO_EVENT_REQUESTS forwards.
VIDEO_FRAMES, VIDEO_PAN, VIDEO_BATCH = 25, 2, 4
V425_VIDEO_FRAMES, VIDEO_IO_FRAMES, VIDEO_EVENT_REQUESTS = 9, 5, 20
# Phase 14, the serving app: the pair at SERVE_PASSES passes (2^4 - 1 = 15
# batch-1 forwards at 736x1280), a SERVE_CLIP_FRAMES-frame 720p clip at 2X,
# two CHAIN_FRAMES-frame clips chained with 2^CHAIN_PASSES - 1 transition
# frames; every request under a time limit.
SERVE_PASSES, SERVE_CLIP_FRAMES, CHAIN_FRAMES, CHAIN_PASSES = 4, 9, 5, 2
SERVE_REQUEST_TIMEOUT_S = 300
# Phase 15, the protocol benchmarks: .yuv clips of HD_1080_FRAMES 1080p
# frames (hd: 2 forwards at 1088x1920) and HD_720_FRAMES 720p frames (hd4x:
# 6 forwards at 768x1280), testtime's warm-up and timed forwards.
HD_1080_FRAMES, HD_720_FRAMES, TESTTIME_ITERS = 5, 9, 20
# Phase 12: the card's f32 protocol rows against the committed CPU rows.
PROTOCOL_GATED = ("exact-f32", "fast2-f32", "fast3-f32")
PROTOCOL_TOL = {"psnr": 0.02, "ssim": 1e-4}
LEGACY_WARPS = [
    ("pair of frames, full res", 3, 8, 736, 1280, 3, 4, 0),
    ("half-res frame of the 6-channel pair", 3, 4, 368, 640, 6, 0, 6),
    ("frame, full res", 3, 4, 736, 1280, 3, 0, 2),
    ("context 1/4", 32, 4, 184, 320, 32, 2, 2),
    ("context 1/8", 64, 4, 92, 160, 64, 2, 2),
    ("context 1/16", 128, 4, 46, 80, 128, 2, 2),
    ("context 1/32", 256, 4, 23, 40, 256, 2, 2),
]
LEGACY_LAUNCHES = {  # (K3, K4) per forward
    "hdv2": (sum(m[6] for m in LEGACY_WARPS if m[1] < 8),
             sum(m[6] for m in LEGACY_WARPS if m[1] >= 8)),
    "hd": (sum(m[7] for m in LEGACY_WARPS if m[1] < 8),
           sum(m[7] for m in LEGACY_WARPS if m[1] >= 8)),
}


# The designs of the NHWC warp kernels, for the kernels line (each K3
# record's `plan` and the cb = 1 row's give the tile widths and threads).
K3_DESIGN = ("a block per power-of-two tile of one row (grid: tiles x rows x images, no "
             "division), a thread's pixels a block's width apart, the flow pair in one "
             "load, taps from device memory, outputs staged in shared memory and stored as "
             "the row's span in 16-byte stores")
K1_DESIGN = ("32-bit in-plane offsets, taps from device memory; C = 3: a grid of (row "
             "tile, row block, image), no division, a thread's run of 2 consecutive "
             "pixels, the dx/dy runs and each channel's 2 outputs as 4-byte accesses where "
             "aligned, channels unrolled; feature maps: a grid of (256-pixel block, group "
             "of 16 channels, image), a pixel a thread (one 32-bit division a thread)")
BWD_DESIGN = ("a block of 256 threads per 2-D tile of one image's pixels and all its "
              "channels (threads = pixel x channel group, a warp one group's 32 pixels, no "
              "division, 32-bit in-plane offsets); d_flow summed in registers and across "
              "groups in shared memory in a fixed order, written once (one launch); d_img "
              "by global reductions into an f32 scratch (zeroed before, cast after), tap "
              "by tap, a lane's right taps handed to its right neighbour by a shuffle "
              "where they are that neighbour's left taps")
K2_DESIGN = ("K1's run layout in blocks of 64 threads: a grid of (row tile of <= 32 "
             "threads, row block, image), no division, a thread's run of 2 consecutive "
             "pixels, both images' coordinates, 32-bit tap offsets, weights and the "
             "sigmoid once a pixel, taps from device memory, the four flow runs, the mask "
             "run and each channel's output runs as 4-byte (bf16) or 8-byte (f32) "
             "accesses where aligned, channels unrolled for C = 3")
MICRO_DESIGN = ("the tile split into the groups a step's gathers close over, each its "
                "own block: a row (lane, lane2, v4row, v5row; 128 threads, shared memory "
                "and the row's barrier), a warp of 4 columns (sublane; one shuffle), a "
                "warp of 32 elements (base, mul, unpack); no tile-wide barrier")
CB1_DESIGN = ("a block per power-of-two tile of one row (grid: tiles x rows x images), a "
              "thread per 16 bytes of consecutive (pixel, channel) items, each item's pixel "
              "by a 32-bit multiply-shift and its coordinate computed by itself, one 16-byte "
              "store")


def log(*a):
    print(*a, flush=True)


class Phase:
    """Times a phase and fails it when it overruns its budget."""

    def __init__(self, name):
        self.name, self.budget = name, BUDGET_S[name]

    def __enter__(self):
        log(f"== {self.name} (budget {self.budget} s)")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        dt = time.perf_counter() - self.t0
        log(f"== {self.name}: {dt:.2f} s")
        if exc_type is None and dt > self.budget:
            raise RuntimeError(f"phase {self.name} took {dt:.1f} s, over its "
                               f"budget of {self.budget} s")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    mag = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def smooth_flow(n, h, w, amp, gen, dev, dtype):
    """Smooth flow field of about `amp` px plus a little noise."""
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    ph = torch.rand(n, 1, 1, device=dev, generator=gen) * 6.28
    dx = amp * torch.sin(yy / (0.11 * h) + ph) + 0.5 * amp * torch.cos(xx / (0.07 * w))
    dy = 0.7 * amp * torch.cos(xx / (0.13 * w) + ph) - 0.3 * amp * torch.sin(yy / (0.05 * h))
    f = torch.stack([dx, dy], 1)
    f = f + 0.25 * torch.randn(f.shape, device=dev, generator=gen)
    return f.to(dtype).contiguous()


def block_flow(n, h, w, gen, dev, dtype):
    """+-200 px, random per 8x8 block, partly out of frame."""
    blk = (torch.rand(n, 2, -(-h // 8), -(-w // 8), device=dev, generator=gen)
           * 400 - 200)
    f = blk.repeat_interleave(8, 2).repeat_interleave(8, 3)[:, :, :h, :w]
    f = f + torch.rand(f.shape, device=dev, generator=gen) * 2 - 1
    return f.to(dtype).contiguous()


def device_ms(fn, inputs) -> float:
    """Device time of one call of fn(*inputs[i]) by CUDA events around a
    captured CUDA graph of TIMED_LAUNCHES calls (utils.profiling.graph_ms).
    The calls cycle over `inputs`, copies that together exceed the 50 MB
    L2, so each call finds its operands in device memory as the main path
    mostly does."""
    from rife_tpu_torch.utils.profiling import graph_ms
    return graph_ms(fn, inputs, TIMED_LAUNCHES)


def grid_for(flow):
    """grid_sample's normalised grid (align_corners=True) for a pixel flow."""
    n, _, h, w = flow.shape
    f = flow.float()
    xs = torch.arange(w, device=f.device, dtype=torch.float32).view(1, 1, w)
    ys = torch.arange(h, device=f.device, dtype=torch.float32).view(1, h, 1)
    gx = (xs + f[:, 0]) * (2.0 / max(w - 1, 1)) - 1
    gy = (ys + f[:, 1]) * (2.0 / max(h - 1, 1)) - 1
    return torch.stack([gx, gy], -1).contiguous()


def check_fwd(warp_mod, img, flow, label) -> float:
    """The warp kernel against its plain version on one input: within
    1e-5 for an f32 image, 1 bf16 ulp for a bf16 one (the same f32 blend,
    rounded once).  Returns the largest error."""
    got = warp_mod.warp_planes(img, flow)
    want = warp_mod.warp_planes_ref(img, flow)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if img.dtype == torch.float32:
        tol, ok = "1e-5 abs", bool((err <= 1e-5).all())
    else:
        tol, ok = "1 bf16 ulp", bool((err <= bf16_ulp(want)).all())
    e = float(err.max())
    log(f"  {label}: max |kernel - plain| = {e:.3g} ({tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return e


def dtypes_label(img, flow) -> str:
    name = lambda t: str(t.dtype).replace("torch.", "")  # noqa: E731
    return name(img) if img.dtype == flow.dtype else f"{name(img)} ({name(flow)} flow)"


SHORT_DTYPE = {torch.bfloat16: "bf16", torch.float32: "f32"}


def time_fwd_launch(warp_mod, dev, gen, name, n, c, h, w, dtype=torch.bfloat16,
                    flow_dtype=None, **counts):
    """The warp kernel against its plain version at one launch shape of a
    serving path (a bf16 image and flow unless other dtypes are given;
    signed, larger values for feature channels), timed beside its bound,
    the plain version and F.grid_sample.  `counts` (launches per forward
    of a path) go into the record, with K1's launch plan."""
    from rife_tpu_torch.ops.cuda import warp as cuda_warp

    amp = 8.0 * w / 1280
    img = torch.rand(n, c, h, w, device=dev, generator=gen).to(dtype)
    if c > 3:  # context or encoder features: signed, larger
        img = (torch.randn(n, c, h, w, device=dev, generator=gen) * 3).to(dtype)
    flow = smooth_flow(n, h, w, amp, gen, dev, flow_dtype or dtype)
    err = check_fwd(warp_mod, img, flow, f"{name} {tuple(img.shape)} {dtypes_label(img, flow)}")
    nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size()
    flops = 9 * img.numel()  # 6 multiplies, 3 adds per output element
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    copies = max(1, math.ceil(160e6 / nbytes))
    inputs = [(img.clone(), flow.clone()) for _ in range(copies)]
    ms = device_ms(warp_mod.warp_planes, inputs)
    plain_ms = device_ms(warp_mod.warp_planes_ref, inputs)
    lib_inputs = [(a.float(), grid_for(f)) for a, f in inputs]
    lib = lambda a, g: F.grid_sample(a, g, mode="bilinear",  # noqa: E731
                                     padding_mode="border", align_corners=True)
    lib_err = float((lib(*lib_inputs[0]) - warp_mod.warp_planes_ref(
        img.float(), flow)).abs().max())
    library_ms = device_ms(lib, lib_inputs)
    log(f"  {name}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
        f"grid_sample(f32) {library_ms * 1e3:.1f} us, bound {bound_s * 1e6:.1f} us "
        f"({nbytes / 1e6:.1f} MB) -> {bound_s * 1e3 / ms:.1%} of the bound")
    return {"launch": name, "img": [n, c, h, w], "dtype": SHORT_DTYPE[img.dtype],
            "flow_dtype": SHORT_DTYPE[flow.dtype], **counts,
            "plan": cuda_warp.k1_plan(img, flow, 0),
            "bytes": nbytes, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
            else "operations",
            "max_abs_err": err, "grid_sample_f32_max_abs_vs_plain": lib_err}


def check_and_time_kernel(warp_mod, dev):
    """Phase 3, the warp kernel: returns the per-shape records of the paper
    model's serving launches, those of v4.25's, and the largest error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    records = [time_fwd_launch(warp_mod, dev, gen, name, 2 * BATCH, c, h, w,
                               launches_per_forward=count)
               for name, c, h, w, count in MAIN_PATH_WARPS]
    v425_records = [time_fwd_launch(warp_mod, dev, gen, f"v4.25 {name}", 2 * BATCH, c, h,
                                    w, launches_per_rung1_forward=r1,
                                    launches_per_rung0_forward=r0)
                    for name, c, h, w, r1, r0 in V425_WARPS]
    worst = max(r["max_abs_err"] for r in records + v425_records)

    def compare(img, flow, label):
        nonlocal worst
        e = check_fwd(warp_mod, img, flow, label)
        worst = max(worst, e)
        return e

    n, h, w = 2 * BATCH, 368, 640
    img32 = torch.rand(n, 3, h, w, device=dev, generator=gen)
    compare(img32, smooth_flow(n, h, w, 4.0, gen, dev, torch.float32),
            f"f32 {tuple(img32.shape)}")
    big = torch.rand(n, 3, 736, 1280, device=dev, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        compare(big.to(dtype), block_flow(n, 736, 1280, gen, dev, dtype),
                f"+-200 px 8x8-block flow {tuple(big.shape)} {dtype}")
    return records, v425_records, worst


def ulp(v: torch.Tensor, dtype) -> torch.Tensor:
    """One ulp of `dtype` (bf16 or f32) at |v|."""
    mag = v.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - (7 if dtype == torch.bfloat16 else 23))


def fused(warp_mod, a, b, flow, mask, need_pair):
    """warp2_blend_planes through the fused kernel."""
    with warp_mod.use_fuse_blend(True):
        return warp_mod.warp2_blend_planes(a, b, flow, mask, need_pair)


def check_blend(warp_mod, a, b, flow, mask, need_pair, label) -> float:
    """The fused kernel against its plain version on one input: w0 and w1
    bit-equal (K1's taps and blend), the blend within one ulp of the
    images' dtype at the magnitude of its terms (the last f32 bit of the
    sigmoid may move one rounding).  Returns the blend's largest error."""
    got = fused(warp_mod, a, b, flow, mask, need_pair)
    want = warp_mod.warp2_blend_planes_ref(a, b, flow, mask, True)
    torch.cuda.synchronize()
    got = got if need_pair else (got,)
    if any(g.dtype != a.dtype for g in got):
        raise AssertionError(f"{label}: outputs {[g.dtype for g in got]}")
    pair_ok = all(torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    err = (got[0].float() - want[0].float()).abs()
    terms = torch.maximum(want[1].float().abs(), want[2].float().abs())
    ok = pair_ok and bool((err <= ulp(terms, a.dtype)).all())
    differ = int((got[0] != want[0]).sum())
    e = float(err.max())
    log(f"  {label}: max |blend - plain| = {e:.3g} (1 ulp of its terms), "
        f"{differ} of {got[0].numel()} elements differ; "
        f"{'w0, w1 bit-equal; ' if need_pair else ''}{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fused kernel disagrees with its plain version: {label}")
    return e


def blend_inputs(n, c, h, w, gen, dev, dtype, side_dtype, flow_kind="smooth"):
    a, b = (torch.rand(n, c, h, w, device=dev, generator=gen).to(dtype) for _ in range(2))
    if flow_kind == "smooth":
        amp = 8.0 * w / 1280
        flow = torch.cat([smooth_flow(n, h, w, amp, gen, dev, side_dtype),
                          smooth_flow(n, h, w, amp, gen, dev, side_dtype)], 1)
    else:
        flow = torch.cat([block_flow(n, h, w, gen, dev, side_dtype),
                          block_flow(n, h, w, gen, dev, side_dtype)], 1)
    mask = (torch.randn(n, 1, h, w, device=dev, generator=gen) * 3).to(side_dtype)
    return a, b, flow.contiguous(), mask


def time_blend_launch(warp_mod, dev, gen, name, n, c, h, w, need_pair,
                      dtype=torch.bfloat16, side_dtype=None, **counts):
    """The fused kernel against its plain version at one launch shape (bf16
    images, flow and mask unless other dtypes are given), timed beside its
    bytes bound, the plain version, the composed route (a warp launch and
    torch's blend), the library route (F.grid_sample over the pair in f32,
    then torch.sigmoid and torch.lerp: three calls) and the other form at
    the same shape.  Returns its record, with K2's launch plan."""
    from rife_tpu_torch.ops.cuda import warp_blend as cuda_blend

    side_dtype = side_dtype or dtype
    a, b, flow, mask = blend_inputs(n, c, h, w, gen, dev, dtype, side_dtype)
    err = check_blend(warp_mod, a, b, flow, mask, need_pair,
                      f"{name} {tuple(a.shape)} {dtypes_label(a, flow)}")
    esz = a.element_size()
    nbytes = ((2 + (3 if need_pair else 1)) * a.numel() * esz
              + flow.numel() * flow.element_size() + mask.numel() * mask.element_size())
    # Per output element: two bilinear blends (9 flops each) and the
    # mask blend (3); per pixel: two coordinates and the sigmoid (~30).
    flops = 21 * a.numel() + 30 * n * h * w
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    copies = max(1, math.ceil(160e6 / nbytes))
    inputs = [(a.clone(), b.clone(), flow.clone(), mask.clone(), need_pair)
              for _ in range(copies)]
    ms = device_ms(lambda *x: fused(warp_mod, *x), inputs)
    # The other form at the same shape: how much of the difference
    # between the two launches is the form.
    other_ms = device_ms(lambda *x: fused(warp_mod, *x[:4], not need_pair), inputs)
    plain_ms = device_ms(warp_mod.warp2_blend_planes_ref, inputs)
    composed_ms = device_ms(lambda *x: warp_mod.warp2_blend_composed(*x[:4]), inputs)
    lib_inputs = [(torch.cat([x[0], x[1]], 0).float(),
                   grid_for(torch.cat([x[2][:, 0:2], x[2][:, 2:4]], 0)), x[3].float())
                  for x in inputs]

    def lib(pair, grid, m, n=n):
        wp = F.grid_sample(pair, grid, mode="bilinear", padding_mode="border",
                           align_corners=True)
        return torch.lerp(wp[n:], wp[:n], torch.sigmoid(m))

    lib_err = float((lib(*lib_inputs[0]) - warp_mod.warp2_blend_planes_ref(
        a.float(), b.float(), flow, mask, False)).abs().max())
    library_ms = device_ms(lib, lib_inputs)
    log(f"  {name}: kernel {ms * 1e3:.1f} us (the "
        f"{'blend-only' if need_pair else 'pair'} form {other_ms * 1e3:.1f} us), "
        f"plain {plain_ms * 1e3:.1f} us, "
        f"composed {composed_ms * 1e3:.1f} us, library {library_ms * 1e3:.1f} us, "
        f"bound {bound_s * 1e6:.1f} us ({nbytes / 1e6:.1f} MB) -> "
        f"{bound_s * 1e3 / ms:.1%} of the bound")
    return {
        "launch": name, "img": [n, c, h, w], "dtype": SHORT_DTYPE[a.dtype],
        "flow_dtype": SHORT_DTYPE[flow.dtype], "mask_dtype": SHORT_DTYPE[mask.dtype],
        "emit_pair": need_pair, "launches_per_forward": 1, **counts,
        "plan": cuda_blend.k2_plan(a, flow, mask, (0,) * (3 if need_pair else 1)),
        "bytes": nbytes, "ms": ms, "other_form_ms": other_ms,
        "share_of_bound": bound_s * 1e3 / ms,
        "plain_ms": plain_ms, "composed_ms": composed_ms,
        "library_ms": library_ms, "library": "F.grid_sample f32 + sigmoid + lerp",
        "bound_ms": bound_s * 1e3,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
        else "operations",
        "max_abs_err": err, "library_f32_max_abs_vs_plain": lib_err}


def check_and_time_blend(warp_mod, dev):
    """Phase 3, the fused kernel: against its plain version at its two
    serving launches (bf16), in f32 and with the +-200 px block flow; at
    the two launches its time beside its bytes bound, the plain version's,
    the composed route's (a warp launch and torch's blend) and the library
    route's (F.grid_sample over the pair in f32, then torch.sigmoid and
    torch.lerp: three calls), and the other form's at the same shape.
    Returns the records (with K2's launch plan) and the largest error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    records = [time_blend_launch(warp_mod, dev, gen, name, BATCH, c, h, w, need_pair)
               for name, c, h, w, need_pair in BLEND_LAUNCHES]
    worst = max(r["max_abs_err"] for r in records)
    for name, c, h, w, need_pair in BLEND_LAUNCHES:
        x = blend_inputs(BATCH, c, h, w, gen, dev, torch.float32, torch.float32)
        worst = max(worst, check_blend(warp_mod, *x, need_pair, f"{name} f32"))
    for dtype in (torch.bfloat16, torch.float32):
        for need_pair in (True, False):
            x = blend_inputs(BATCH, 3, 736, 1280, gen, dev, dtype, dtype, "blocks")
            worst = max(worst, check_blend(
                warp_mod, *x, need_pair,
                f"+-200 px 8x8-block flow {tuple(x[0].shape)} {dtype} "
                f"{'pair' if need_pair else 'blend only'}"))
    # The paper model's serving path passes an f32 image pair nowhere, but
    # the dtypes are independent: one mixed case (bf16 image, f32 flow and mask).
    x = blend_inputs(BATCH, 3, 736, 1280, gen, dev, torch.bfloat16, torch.float32)
    worst = max(worst, check_blend(warp_mod, *x, True, "bf16 image, f32 flow and mask"))
    return records, worst


def check_bwd(warp_mod, img, flow, g, need_img, label, need_flow=True, got=None) -> float:
    """The gradient kernel (or `got`, what a wrapper of it returned)
    against its plain version's f32 result on one input -> the largest
    error.  f32: the summation order (channels, atomics) moves a result by
    at most ~1e-7 of the sum of its terms' magnitudes; 1e-5 of it is the
    bound.  bf16: one rounding of the f32 sum, 1 bf16 ulp, plus that
    order term."""
    if got is None:
        got = warp_mod.warp_planes_bwd(img, flow, g, need_img, need_flow)
    want32 = warp_mod.warp_planes_bwd_ref(img.float(), flow.float(), g.float(),
                                          need_img, need_flow)
    mags = warp_mod._bwd_term_scale(img, flow, g)
    torch.cuda.synchronize()
    errs = []
    for name, k, w32, mag in zip(("d_img", "d_flow"), got, want32, mags):
        if w32 is None:
            if k is not None:
                raise AssertionError(f"{label}: {name} computed though not asked for")
            continue
        err = (k.float() - w32).abs()
        lim = 1e-5 * mag
        if k.dtype == torch.bfloat16:
            lim = lim + bf16_ulp(w32)
        if k.dtype != (img.dtype if name == "d_img" else flow.dtype):
            raise AssertionError(f"{label}: {name} is {k.dtype}")
        if not bool((err <= lim).all()):
            raise AssertionError(
                f"backward kernel disagrees with its plain version: {label} "
                f"{name}, max |diff| {float(err.max()):.3g}, worst excess "
                f"{float((err - lim).max()):.3g}")
        errs.append(float(err.max()))
    tol = "1e-5 x sum|terms|, + 1 bf16 ulp for a bf16 result"
    log(f"  {label}: backward max |kernel - plain| = {max(errs):.3g} ({tol}) ok")
    return max(errs)


def bwd_inputs(n, c, h, w, dtype, flow, gen):
    """An image (frames in [0, 1]; context features signed and larger) and
    a small cotangent for the gradient kernel, on the flow's device."""
    dev = flow.device
    img = torch.rand(n, c, h, w, device=dev, generator=gen)
    if c > 3:
        img = torch.randn(n, c, h, w, device=dev, generator=gen) * 3
    g = torch.randn(n, c, h, w, device=dev, generator=gen) * 1e-3
    return img.to(dtype), flow, g.to(dtype)


def time_bwd_launch(warp_mod, img, flow, g, need_img) -> dict:
    """The gradient kernel's time on one input beside its bytes bound (the
    image, the flow and the cotangent read once, d_flow and, where asked,
    d_img written once), its plain version's and grid_sampler_2d_backward's
    (f32), each over copies larger than L2."""
    esz = img.element_size()
    nbytes = (2 * img.numel() * esz + 2 * flow.numel() * flow.element_size()
              + (img.numel() * esz if need_img else 0))
    # d_flow: 2 x 12 flops, d_img: 4 x 2 flops, per element of g.
    flops = (24 + (8 if need_img else 0)) * img.numel()
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    copies = max(1, math.ceil(160e6 / nbytes))
    inputs = [(img.clone(), flow.clone(), g.clone(), need_img, True) for _ in range(copies)]
    ms = device_ms(warp_mod.warp_planes_bwd, inputs)
    plain_ms = device_ms(warp_mod.warp_planes_bwd_ref, inputs)
    mask = [need_img, True]
    lib_inputs = [(b.float(), a.float(), grid_for(f), 0, 1, True, mask)
                  for a, f, b, _, _ in inputs]
    library_ms = device_ms(torch.ops.aten.grid_sampler_2d_backward, lib_inputs)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bytes": nbytes,
            "bound_ms": bound_s * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
            else "operations"}


def check_and_time_bwd_kernel(warp_mod, dev):
    """Both kernels against their plain versions at the 8 launches of one
    bf16 training step (batch TRAIN_BATCH, crop TRAIN_CROP), with the
    image and flow dtypes the step passes; the backward also once in f32
    and with a +-200 px per-8x8-block flow in each dtype pairing; and the
    backward's time beside its bytes bound, the plain version's and
    grid_sampler_2d_backward's, its launch plan, the share of its pixels
    that handed their right taps of d_img to their right neighbour and
    its call's memset / kernel / cast split (each over copies larger than
    L2).  Returns the per-shape records, the backward's largest
    error and the forward's."""
    from rife_tpu_torch.ops.cuda import warp as cuda_warp
    from rife_tpu_torch.tools.warp_planes import bwd_split_ms, merge_share

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    records, worst, worst_fwd = [], 0.0, 0.0

    def compare(img, flow, g, need_img, label):
        nonlocal worst
        err = check_bwd(warp_mod, img, flow, g, need_img, label)
        worst = max(worst, err)
        return err

    n = 2 * TRAIN_BATCH
    for name, c, h, w, count, flow_dtype, need_img in TRAIN_STEP_WARPS:
        flow = smooth_flow(n, h, w, 8.0 * w / TRAIN_CROP, gen, dev, flow_dtype)
        img, flow, g = bwd_inputs(n, c, h, w, torch.bfloat16, flow, gen)
        label = f"{name} {tuple(img.shape)} {dtypes_label(img, flow)}"
        worst_fwd = max(worst_fwd, check_fwd(warp_mod, img, flow, label + " forward"))
        err = compare(img, flow, g, need_img, label)
        t = time_bwd_launch(warp_mod, img, flow, g, need_img)
        split = bwd_split_ms(img, flow, g, need_img)
        share = merge_share(img, flow, g, need_img)
        ms, plain_ms, library_ms, nbytes, bound_s = (
            t["ms"], t["plain_ms"], t["library_ms"], t["bytes"], t["bound_ms"] / 1e3)
        records.append({
            "launch": name, "img": [n, c, h, w], "dtype": "bf16",
            "flow_dtype": str(flow_dtype).replace("torch.", ""), "need_img": need_img,
            "launches_per_step": count, "bytes": nbytes,
            "plan": cuda_warp.bwd_plan(img.shape), "merged_tap_share": share,
            **{f"split_{k}": v for k, v in split.items()},
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_s * 1e3, "bound_by": t["bound_by"], "max_abs_err": err})
        log(f"  {name}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"grid_sampler_2d_backward(f32) {library_ms * 1e3:.1f} us, bound "
            f"{bound_s * 1e6:.1f} us ({nbytes / 1e6:.1f} MB) -> "
            f"{bound_s * 1e3 / ms:.1%} of the bound; split: memset "
            f"{split['memset_ms'] * 1e3:.1f} us, kernel {split['kernel_ms'] * 1e3:.1f}, "
            f"cast {split['cast_ms'] * 1e3:.1f}; pixels merging their right taps {share}")

    c, h, w = 16, TRAIN_CROP // 2, TRAIN_CROP // 2
    f32 = bwd_inputs(n, c, h, w, torch.float32,
                     smooth_flow(n, h, w, 4.0, gen, dev, torch.float32), gen)
    compare(*f32, True, f"f32 {tuple(f32[0].shape)}")
    h = w = TRAIN_CROP
    for dtype, flow_dtype in ((torch.bfloat16, torch.bfloat16),
                              (torch.float32, torch.float32),
                              (torch.bfloat16, torch.float32)):
        big = bwd_inputs(n, 3, h, w, dtype, block_flow(n, h, w, gen, dev, flow_dtype), gen)
        compare(*big, True, f"+-200 px 8x8-block flow {tuple(big[0].shape)} "
                f"{dtypes_label(big[0], big[1])}")
    return records, worst, worst_fwd


def smooth_pair(batch, h, w, shift, seed=7):
    """Textured smooth content panned by `shift` px on both axes (the
    recipe of bench.py's smooth_pair), as NHWC f32 numpy."""
    rng = np.random.default_rng(seed)
    m = max(128, shift + 32)
    base = rng.random((batch, h + 2 * m, w + 2 * m, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 2)
                + np.roll(base, 2, 1) + np.roll(base, 2, 2)) / 5
    a = base[:, m:m + h, m:m + w]
    b = base[:, m + shift:m + shift + h, m + shift:m + shift + w]
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(1.0 / max(mse, 1e-20))


def _counted(warp_mod) -> dict:
    """Each kernel's wrapper, by the kernel's name in the kernels line."""
    from rife_tpu_torch.ops import gather_probe as gp
    from rife_tpu_torch.ops.conv_chain import conv_chain
    return {"micro": gp.micro, "select_rows": gp.select_rows, "tile_gather": gp.tile_gather,
            "warp_nhwc_cb1": gp.warp_nhwc_cb1, "conv_chain": conv_chain,
            "warp_planes": warp_mod.warp_planes,
            "warp_planes_bwd": warp_mod.warp_planes_bwd,
            "warp_blend": warp_mod.warp2_blend_planes,
            "warp_nhwc_k3": warp_mod.warp_nhwc_k3,
            "warp_nhwc_k4": warp_mod.warp_nhwc_k4}


def reset_counts(warp_mod):
    for fn in _counted(warp_mod).values():
        fn.launches = 0


def read_counts(warp_mod) -> dict:
    return {k: fn.launches for k, fn in _counted(warp_mod).items()}


def serve(eng, a, b, requests, warp_mod, timestep=0.5):
    """`requests` requests on the card, counted from 0 -> (ms/request on
    the host clock, launch counts, the last output)."""
    reset_counts(warp_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(requests):
        out = eng.interpolate(a, b, timestep)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / requests * 1e3, read_counts(warp_mod), out


def check_counts(counts, requests, k1, k2, label, k3=0, k4=0, k5=0):
    want = {"micro": 0, "select_rows": 0, "tile_gather": 0, "warp_nhwc_cb1": 0,
            "conv_chain": k5 * requests, "warp_planes": k1 * requests, "warp_planes_bwd": 0,
            "warp_blend": k2 * requests, "warp_nhwc_k3": k3 * requests,
            "warp_nhwc_k4": k4 * requests}
    if counts != want:
        raise AssertionError(f"{label}: expected launches {want}, counted {counts}")


def check_frame(out, shape, label, dtype=torch.bfloat16):
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
        raise AssertionError(f"{label}: output {tuple(out.shape)} {out.dtype}")
    if not bool(torch.isfinite(out).all()) or float(out.min()) < 0 or float(out.max()) > 1:
        raise AssertionError(f"{label}: output not finite or outside [0, 1]")


def final_launches(warp_mod) -> tuple[int, int]:
    """(warp, fused) launches of the final level under the switch's value."""
    return (0, 1) if warp_mod._FUSE_BLEND.get() else (1, 0)


def main_path(dev, warp_mod):
    from rife_tpu_torch.engine import (InferenceEngine, load_checkpoint,
                                       state_dict_from_jax)
    from rife_tpu_torch.ops import pad_to_multiple

    t0 = time.perf_counter()
    name, tree = load_checkpoint(CKPT)
    sd = state_dict_from_jax(tree)
    a, b = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    a, pad = pad_to_multiple(torch.from_numpy(a), 32)
    b, _ = pad_to_multiple(torch.from_numpy(b), 32)
    a, b = a.to(dev), b.to(dev)
    log(f"  weights ({name}, r5) and a {tuple(a.shape)} pair ready in "
        f"{time.perf_counter() - t0:.2f} s")
    eng = InferenceEngine("rife", sd, compute_dtype=torch.bfloat16, fast=1,
                          device=dev)
    t0 = time.perf_counter()
    eng.warmup(tuple(a.shape))
    log(f"  warm-up request: {time.perf_counter() - t0:.2f} s")

    requests = 3
    ms, counts, out = serve(eng, a, b, requests, warp_mod)
    k1_last, k2 = final_launches(warp_mod)
    log(f"  {requests} requests: {ms:.2f} ms/request, "
        f"{BATCH * 1e3 / ms:.2f} interpolated frames/s; launches {counts}")
    check_counts(counts, requests, LAUNCHES_PER_FORWARD + k1_last, k2, "rife")
    check_frame(out, a.shape, "rife")

    eng32 = InferenceEngine("rife", sd, compute_dtype=torch.float32, fast=1,
                            device=dev)
    out32 = eng32.interpolate(a, b)
    quality = psnr(pad.crop(out).float(), pad.crop(out32))
    log(f"  bf16 vs the port's own f32 (TF32 off): {quality:.2f} dB PSNR (>= 40)")
    if not quality >= 40.0:
        raise AssertionError(f"bf16 output at {quality:.2f} dB against f32")

    sa, sb = smooth_pair(2, 128, 192, 6, seed=11)
    on_card = eng32.interpolate(sa, sb).cpu()
    on_cpu = InferenceEngine("rife", sd, fast=1, device="cpu").interpolate(sa, sb)
    diff = float((on_card - on_cpu).abs().max())
    log(f"  f32 on the card vs the CPU path at 128x192: max |diff| = {diff:.3g} (<= 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError("the card's f32 result disagrees with the CPU path")
    rec = {"launches": counts, "ms_per_request": ms,
           "frames_per_s": BATCH * 1e3 / ms, "psnr_bf16_vs_f32_db": quality,
           "f32_card_vs_cpu_max_abs": diff}
    return rec, {"eng": eng, "a": a, "b": b, "pad": pad, "out32": out32}


def v425_path(dev, warp_mod):
    """Phase 5: v4.25 serving at rungs 1 and 0 (see the module docstring).
    Returns the records and what the A/B needs."""
    from rife_tpu_torch.engine import (InferenceEngine, load_checkpoint,
                                       state_dict_from_jax)
    from rife_tpu_torch.ops import pad_to_multiple

    t0 = time.perf_counter()
    name, tree = load_checkpoint(CKPT_V425)
    if name != "v4.25":
        raise AssertionError(f"{CKPT_V425} holds {name!r}")
    sd = state_dict_from_jax(tree)
    a, b = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    a, pad = pad_to_multiple(torch.from_numpy(a), V425_PAD)
    b, _ = pad_to_multiple(torch.from_numpy(b), V425_PAD)
    a, b = a.to(dev), b.to(dev)
    log(f"  weights ({name}) and a {tuple(a.shape)} pair ready in "
        f"{time.perf_counter() - t0:.2f} s")
    k1_last, k2 = final_launches(warp_mod)
    rec, keep, requests = {}, {}, 3
    for rung in (1, 0):
        eng = InferenceEngine("v4.25", sd, compute_dtype=torch.bfloat16, fast=rung,
                              device=dev)
        eng.warmup(tuple(a.shape))
        ms, counts, out = serve(eng, a, b, requests, warp_mod)
        log(f"  rung {rung}, {requests} requests: {ms:.2f} ms/request, "
            f"{BATCH * 1e3 / ms:.2f} interpolated frames/s; launches {counts}")
        check_counts(counts, requests, 4 + k1_last, k2, f"v4.25 rung {rung}")
        check_frame(out, a.shape, f"v4.25 rung {rung}")
        out32 = InferenceEngine("v4.25", sd, compute_dtype=torch.float32, fast=rung,
                                device=dev).interpolate(a, b)
        quality = psnr(pad.crop(out).float(), pad.crop(out32))
        log(f"  rung {rung}: bf16 vs the port's own f32 (TF32 off): {quality:.2f} dB "
            f"PSNR (>= 40)")
        if not quality >= 40.0:
            raise AssertionError(f"v4.25 rung {rung}: bf16 at {quality:.2f} dB")
        rec[f"rung{rung}"] = {"launches": counts, "ms_per_request": ms,
                              "frames_per_s": BATCH * 1e3 / ms,
                              "psnr_bf16_vs_f32_db": quality}
        if rung == 1:
            out25 = eng.interpolate(a, b, 0.25)
            moved = float((out25.float() - out.float()).abs().mean())
            log(f"  timestep 0.25 vs 0.5: mean |diff| = {moved:.4g} (> 0)")
            if not moved > 0:
                raise AssertionError("the timestep does not reach the model")
            rec["timestep_0.25_vs_0.5_mean_abs"] = moved
            keep = {"eng": eng, "a": a, "b": b, "pad": pad, "out32": out32}
        del eng, out32

    sa, sb = smooth_pair(2, 128, 192, 6, seed=12)
    on_card = InferenceEngine("v4.25", sd, fast=1, device=dev).interpolate(sa, sb, 0.25)
    on_cpu = InferenceEngine("v4.25", sd, fast=1, device="cpu").interpolate(sa, sb, 0.25)
    diff = float((on_card.cpu() - on_cpu).abs().max())
    log(f"  f32 on the card vs the CPU path at 128x192: max |diff| = {diff:.3g} (<= 1e-3)")
    if not diff <= 1e-3:
        raise AssertionError("the card's v4.25 f32 result disagrees with the CPU path")
    rec["f32_card_vs_cpu_max_abs"] = diff
    return rec, keep


def ab_path(warp_mod, paths):
    """Phase 6: each model's rung-1 request with the final level fused and
    composed, interleaved (F C C F ...), AB_ROUNDS x AB_REQUESTS requests
    a side, device time by CUDA events; both sides' PSNR against the f32
    output.  The fused paper-model request must make 6 warp launches and
    one fused one."""
    rec = {}
    for model, p in paths.items():
        times = {True: [], False: []}
        quality = {}
        for r in range(AB_ROUNDS):
            for fuse in ((True, False) if r % 2 == 0 else (False, True)):
                with warp_mod.use_fuse_blend(fuse):
                    reset_counts(warp_mod)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(AB_REQUESTS):
                        out = p["eng"].interpolate(p["a"], p["b"])
                    end.record()
                    end.synchronize()
                    times[fuse].append(start.elapsed_time(end) / AB_REQUESTS)
                    counts = read_counts(warp_mod)
                k1 = {"rife": LAUNCHES_PER_FORWARD, "v4.25": 4}[model] + (0 if fuse else 1)
                check_counts(counts, AB_REQUESTS, k1, 1 if fuse else 0,
                             f"A/B {model} fused={fuse}")
                if r == 0:
                    quality[fuse] = psnr(p["pad"].crop(out).float(), p["pad"].crop(p["out32"]))
                    if not quality[fuse] >= 40.0:
                        raise AssertionError(f"A/B {model} fused={fuse}: "
                                             f"{quality[fuse]:.2f} dB")
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        winner = "fused" if med[True] < med[False] else "composed"
        log(f"  {model} rung 1: fused {med[True]:.3f} ms/request (median; "
            f"{', '.join(f'{t:.3f}' for t in times[True])}), composed "
            f"{med[False]:.3f} ({', '.join(f'{t:.3f}' for t in times[False])}); "
            f"PSNR vs f32 fused {quality[True]:.2f} dB, composed {quality[False]:.2f} dB;"
            f" faster: {winner}")
        rec[model] = {"fused_ms": times[True], "composed_ms": times[False],
                      "fused_median_ms": med[True], "composed_median_ms": med[False],
                      "psnr_fused_db": quality[True], "psnr_composed_db": quality[False],
                      "faster": winner}
    default = "fused" if warp_mod._FUSE_BLEND.get() else "composed"
    log(f"  use_fuse_blend default: {default}")
    rec["default"] = default
    return rec


def legacy_state_dict(model: str, seed: int = 0) -> dict:
    """Seeded random weights of a legacy model (the port's
    `ModelDef.init`), each block's flow head scaled by LEGACY_FLOW_GAIN."""
    from rife_tpu_torch.models import get_model_def

    sd = get_model_def(model).init(torch.Generator().manual_seed(seed))
    for i in range(4):
        for k in ("weight", "bias"):
            sd[f"block{i}.conv1.{k}"] *= LEGACY_FLOW_GAIN
    return sd


def nhwc_inputs(n, c, h, w, stride, gen, dev, dtype, flow_dtype, kind="smooth"):
    """An (N, H, W, C) image, the first C channels of a `stride`-channel
    NHWC tensor (frames in [0, 1]; features signed and larger), and an
    (N, H, W, 2) flow: smooth, or +-200 px per 8x8 block."""
    base = torch.rand(n, h, w, stride, device=dev, generator=gen)
    if c > 3:
        base = torch.randn(n, h, w, stride, device=dev, generator=gen) * 3
    img = base.to(dtype)[..., :c]
    flow = (smooth_flow(n, h, w, 8.0 * w / 1280, gen, dev, flow_dtype) if kind == "smooth"
            else block_flow(n, h, w, gen, dev, flow_dtype))
    return img, flow.permute(0, 2, 3, 1).contiguous()


def planes_route(warp_mod, img, flow):
    """The NHWC warp through K1: permute to planes, warp, permute back."""
    out = warp_mod.warp_planes(img.permute(0, 3, 1, 2).contiguous(),
                               flow.permute(0, 3, 1, 2).contiguous())
    return out.permute(0, 2, 3, 1).contiguous()


def check_nhwc(warp_mod, img, flow, label) -> float:
    """K3 or K4 (by C) against its plain version and against K1 on the
    permuted planes: both bit-equal (the same coordinate, tap and weight
    chain).  Returns the largest error against the plain version."""
    counter = warp_mod.warp_nhwc_k3 if img.shape[-1] < 8 else warp_mod.warp_nhwc_k4
    before = counter.launches
    got = warp_mod.warp(img, flow)
    want = warp_mod.warp_ref(img, flow)
    via_k1 = planes_route(warp_mod, img, flow)
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise AssertionError(f"{label}: the NHWC warp did not launch its kernel")
    ok = got.dtype == img.dtype and torch.equal(got, want) and torch.equal(got, via_k1)
    e = float((got.float() - want.float()).abs().max())
    log(f"  {label}: max |kernel - plain| = {e:.3g}; bit-equal to plain and to K1 on "
        f"the planes: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"NHWC kernel disagrees with its plain version or K1: {label}")
    return e


def time_nhwc_launch(warp_mod, dev, gen, name, c, n, h, w, stride, per_hdv2, per_hd):
    """K3/K4 at one legacy launch shape, in f32 (the legacy models' serving
    dtype) and bf16: times by CUDA events beside the bytes bound, the plain
    version's, the route through K1 (permute, K1, permute back) and
    F.grid_sample's (f32, border, align_corners=True)."""
    img, flow = nhwc_inputs(n, c, h, w, stride, gen, dev, torch.float32, torch.float32)
    nbytes = 2 * img.numel() * 4 + flow.numel() * 4
    flops = 9 * img.numel()
    bound_s = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    copies = max(1, math.ceil(160e6 / nbytes))
    inputs = [nhwc_inputs(n, c, h, w, stride, gen, dev, torch.float32, torch.float32)
              for _ in range(copies)]
    ms = device_ms(warp_mod.warp, inputs)
    plain_ms = device_ms(warp_mod.warp_ref, inputs)
    k1_route_ms = device_ms(lambda a, f: planes_route(warp_mod, a, f), inputs)
    lib_inputs = [(a.permute(0, 3, 1, 2), grid_for(f.permute(0, 3, 1, 2))) for a, f in inputs]
    lib = lambda a, g: F.grid_sample(a, g, mode="bilinear",  # noqa: E731
                                     padding_mode="border", align_corners=True)
    lib_err = float((lib(*lib_inputs[0]).permute(0, 2, 3, 1)
                     - warp_mod.warp_ref(*inputs[0])).abs().max())
    library_ms = device_ms(lib, lib_inputs)
    bf16_inputs = [(a.bfloat16(), f.bfloat16()) for a, f in inputs]
    bf16_ms = device_ms(warp_mod.warp, bf16_inputs)
    bf16_bound_s = (nbytes / 2) / HBM_BYTES_PER_S
    rec = {"launch": name, "kernel": "k3" if c < 8 else "k4", "img_nhwc": [n, h, w, c],
           "img_pixel_stride": stride, "dtype": "f32",
           "launches_per_hdv2_forward": per_hdv2, "launches_per_hd_forward": per_hd,
           "bytes": nbytes, "ms": ms, "plain_ms": plain_ms, "k1_route_ms": k1_route_ms,
           "library_ms": library_ms, "library": "F.grid_sample f32",
           "bound_ms": bound_s * 1e3,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
           else "operations", "bf16_ms": bf16_ms, "bf16_bound_ms": bf16_bound_s * 1e3,
           "grid_sample_f32_max_abs_vs_plain": lib_err}
    extra = ""
    if c < 8:  # K3: its launch plan, and what reading a channel slice costs it
        from rife_tpu_torch.ops.cuda.warp_nhwc import k3_plan
        rec["plan"] = k3_plan(*inputs[0], 0)
        if stride != c:
            rec["contiguous_image_ms"] = device_ms(
                warp_mod.warp, [(a.contiguous(), f) for a, f in inputs])
            rec["contiguous_image_bf16_ms"] = device_ms(
                warp_mod.warp, [(a.contiguous(), f) for a, f in bf16_inputs])
            extra = (f"; on a contiguous copy of the image {rec['contiguous_image_ms'] * 1e3:.1f}"
                     f" us, bf16 {rec['contiguous_image_bf16_ms'] * 1e3:.1f} us")
    log(f"  {name} {(n, h, w, c)} f32: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
        f"via K1 {k1_route_ms * 1e3:.1f} us, grid_sample(f32) {library_ms * 1e3:.1f} us, "
        f"bound {bound_s * 1e6:.1f} us ({nbytes / 1e6:.1f} MB) -> "
        f"{bound_s * 1e3 / ms:.1%} of the bound; bf16 {bf16_ms * 1e3:.1f} us "
        f"({bf16_bound_s * 1e3 / bf16_ms:.1%} of its bound){extra}")
    return rec


def check_and_time_nhwc(warp_mod, dev):
    """Phase 7, the kernels: K3 and K4 at every launch shape of an hdv2 and
    an hd forward (batch 4, 736x1280), in every image/flow dtype pairing,
    on a smooth flow and on the +-200 px block flow, against the plain
    version and K1; then timed.  Returns the records and the largest error."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    worst = 0.0
    pairings = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
    for name, c, n, h, w, stride, _, _ in LEGACY_WARPS:
        for dtype, flow_dtype in pairings:
            for kind in ("smooth", "blocks"):
                img, flow = nhwc_inputs(n, c, h, w, stride, gen, dev, dtype, flow_dtype,
                                        kind)
                worst = max(worst, check_nhwc(
                    warp_mod, img, flow, f"{name} {(n, h, w, c)} "
                    f"{dtypes_label(img, flow)} {kind if kind == 'smooth' else '+-200 px blocks'}"))
                del img, flow
    records = [time_nhwc_launch(warp_mod, dev, gen, *m) for m in LEGACY_WARPS]
    return records, worst


@contextlib.contextmanager
def recorded_nhwc(cuda_nhwc):
    """Inside: every K3/K4 launch also records (kernel, N, H, W, C, the
    image's pixel stride, image dtype, flow dtype) in the yielded list."""
    seen = []
    k3, k4 = cuda_nhwc.launch_k3, cuda_nhwc.launch_k4

    def wrap(kernel, fn):
        def launch(img, flow):
            seen.append((kernel, *img.shape, img.stride(2), img.dtype, flow.dtype))
            return fn(img, flow)
        return launch

    cuda_nhwc.launch_k3, cuda_nhwc.launch_k4 = wrap("k3", k3), wrap("k4", k4)
    try:
        yield seen
    finally:
        cuda_nhwc.launch_k3, cuda_nhwc.launch_k4 = k3, k4


def events_ms(eng, a, b, requests, *args) -> float:
    """ms per request on the device clock (CUDA events around `requests`
    requests; `args` follow the pair into `interpolate`)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(requests):
        eng.interpolate(a, b, *args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / requests


def legacy_path(dev, warp_mod, cuda_nhwc):
    """Phase 7, serving: InferenceEngine("hdv2" | "hd") in f32 and bf16
    serves 3 requests of 4 pairs of the 720p panned content (736x1280);
    the warm-up's NHWC launches must be the checked LEGACY_WARPS, each
    forward must make the model's K3 + K4 launches and no K1, K1-gradient
    or K2 launch; the output must be finite and in [0, 1], bf16 >= 40 dB
    against f32, and the f32 engine on the card within 2e-4 of the CPU
    path at 128x192."""
    from rife_tpu_torch.engine import InferenceEngine
    from rife_tpu_torch.ops import pad_to_multiple

    a, b = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    a, pad = pad_to_multiple(torch.from_numpy(a), 32)
    b, _ = pad_to_multiple(torch.from_numpy(b), 32)
    a, b = a.to(dev), b.to(dev)
    sa, sb = smooth_pair(2, 128, 192, 6, seed=13)
    rec, requests = {}, 3
    for model in ("hdv2", "hd"):
        k3, k4 = LEGACY_LAUNCHES[model]
        sd = legacy_state_dict(model)
        outs = {}
        for dtype in (torch.float32, torch.bfloat16):
            label = f"{model} {str(dtype).replace('torch.', '')}"
            eng = InferenceEngine(model, sd, compute_dtype=dtype, device=dev)
            t0 = time.perf_counter()
            with recorded_nhwc(cuda_nhwc) as seen:
                eng.warmup(tuple(a.shape))
            log(f"  {label}: warm-up request {time.perf_counter() - t0:.2f} s")
            if dtype == torch.float32:
                col = 6 if model == "hdv2" else 7  # launches per forward
                want = sorted([("k3" if m[1] < 8 else "k4", *m[2:5], m[1], m[5], dtype, dtype)
                               for m in LEGACY_WARPS for _ in range(m[col])], key=str)
                if sorted(seen, key=str) != want:
                    raise AssertionError(f"{label}: the forward's NHWC launches {seen} are "
                                         f"not the checked {want}")
            ms, counts, out = serve(eng, a, b, requests, warp_mod)
            dev_ms = events_ms(eng, a, b, requests)
            log(f"  {label}, {requests} requests: {dev_ms:.3f} ms/request by CUDA events "
                f"({ms:.2f} on the host clock), {BATCH * 1e3 / dev_ms:.2f} interpolated "
                f"frames/s; launches {counts}")
            check_counts(counts, requests, 0, 0, label, k3, k4)
            check_frame(out, a.shape, label, dtype)
            outs[dtype] = out
            rec[f"{model} {str(dtype).replace('torch.', '')}"] = {
                "launches": counts, "ms_per_request": dev_ms, "host_ms_per_request": ms,
                "frames_per_s": BATCH * 1e3 / dev_ms}
            if dtype == torch.float32:
                on_card = eng.interpolate(sa, sb).cpu()
                on_cpu = InferenceEngine(model, sd, device="cpu").interpolate(sa, sb)
                diff = float((on_card - on_cpu).abs().max())
                log(f"  {label} on the card vs the CPU path at 128x192: max |diff| = "
                    f"{diff:.3g} (<= 2e-4)")
                if not diff <= 2e-4:
                    raise AssertionError(f"{label}: the card disagrees with the CPU path")
                rec[f"{model} float32"]["f32_card_vs_cpu_max_abs"] = diff
            del eng
        quality = psnr(pad.crop(outs[torch.bfloat16]).float(), pad.crop(outs[torch.float32]))
        log(f"  {model}: bf16 vs the port's own f32 (TF32 off): {quality:.2f} dB PSNR (>= 40)")
        if not quality >= 40.0:
            raise AssertionError(f"{model}: bf16 output at {quality:.2f} dB against f32")
        rec[f"{model} bfloat16"]["psnr_bf16_vs_f32_db"] = quality
        torch.cuda.empty_cache()
    return rec


def _grads(model) -> dict:
    """Each parameter's gradient as f32 (zeros where it has none)."""
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float().clone()
            for k, p in model.named_parameters()}


def grad_cosines(model, batch, model_def) -> dict:
    """Cosine of the bf16 step's gradient with the f32 step's, per block
    (each block's parameters flattened into one vector), in f64."""
    from rife_tpu_torch.engine.inference import full_f32
    from rife_tpu_torch.train import loss_fn

    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        model.zero_grad(set_to_none=True)
        with full_f32():
            loss, _, _ = loss_fn(model, batch, model_def, dtype)
            loss.backward()
        grads[dtype] = _grads(model)
    model.zero_grad(set_to_none=True)
    cos = {}
    for block in ("block0", "block1", "block2", "block_tea", "contextnet", "unet"):
        a, b = (torch.cat([g[k].flatten() for k in g if k.startswith(block + ".")])
                .double() for g in (grads[torch.bfloat16], grads[torch.float32]))
        cos[block] = float(torch.dot(a, b) / (a.norm() * b.norm()))
    return cos


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@contextlib.contextmanager
def recorded_launches(cuda_warp):
    """Inside: every launch of either kernel also records (N, C, H, W,
    image dtype, flow dtype, need_img) in the yielded lists, "fwd" and "bwd"
    (need_img None for a forward)."""
    seen = {"fwd": [], "bwd": []}
    launch, launch_bwd = cuda_warp.launch, cuda_warp.launch_bwd

    def key(img, flow, need_img=None):
        return (*img.shape, img.dtype, flow.dtype, need_img)

    def fwd(img, flow):
        seen["fwd"].append(key(img, flow))
        return launch(img, flow)

    def bwd(img, flow, g, need_img, need_flow):
        seen["bwd"].append(key(img, flow, need_img))
        return launch_bwd(img, flow, g, need_img, need_flow)

    cuda_warp.launch, cuda_warp.launch_bwd = fwd, bwd
    try:
        yield seen
    finally:
        cuda_warp.launch, cuda_warp.launch_bwd = launch, launch_bwd


def train_path(dev, warp_mod, cuda_warp):
    """Phase 8: training through both kernels (see the module docstring).
    Returns the records of the run."""
    from rife_tpu_torch.data import SyntheticTriplets, batch_iterator
    from rife_tpu_torch.engine import load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.engine.inference import full_f32
    from rife_tpu_torch.models import get_model_def
    from rife_tpu_torch.train import (loss_fn, restore_checkpoint, train_init,
                                      train_step)
    from rife_tpu_torch.utils.profiling import device_breakdown

    model_def = get_model_def("rife")
    rec = {}
    # (d) Resume the r5 run (16000 steps, its cosine horizon) and train on.
    t0 = time.perf_counter()
    state = train_init(model_def, total_steps=R5_STEPS,
                       world_scale=TRAIN_BATCH / 64.0, device=dev)
    restore_checkpoint(state, CKPT)
    ds = SyntheticTriplets(n=4 * TRAIN_BATCH, h=TRAIN_CROP + 8, w=TRAIN_CROP + 8)
    it = batch_iterator(ds, TRAIN_BATCH, crop=TRAIN_CROP)
    batches = [next(it) for _ in range(TRAIN_TIMED_STEPS + 1)]
    log(f"  r5 state (step {state.step}) and {len(batches)} batches of "
        f"{TRAIN_BATCH}x{TRAIN_CROP}x{TRAIN_CROP} ready in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with recorded_launches(cuda_warp) as seen:
        train_step(state, batches[0], torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.perf_counter() - t0:.2f} s")
    # The kernels' checks above covered exactly the launches a step makes.
    bwd = sorted([(2 * TRAIN_BATCH, c, h, w, torch.bfloat16, fd, ni)
                  for _, c, h, w, k, fd, ni in TRAIN_STEP_WARPS for _ in range(k)], key=str)
    want = {"fwd": sorted([x[:6] + (None,) for x in bwd], key=str), "bwd": bwd}
    for kind in want:
        if sorted(seen[kind], key=str) != want[kind]:
            raise AssertionError(f"the step's {kind} launches {seen[kind]} are not "
                                 f"the checked {want[kind]}")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    reset_counts(warp_mod)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [train_step(state, b, torch.bfloat16)["loss"] for b in batches[1:]]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
    fwd, bwd = warp_mod.warp_planes.launches, warp_mod.warp_planes_bwd.launches
    if warp_mod.warp2_blend_planes.launches:
        raise AssertionError("training launched the fused warp + blend kernel; "
                             "the final level trains through the composed ops")
    losses = [float(x) for x in losses]
    log(f"  {TRAIN_TIMED_STEPS} bf16 steps: {dt * 1e3:.2f} ms/step, "
        f"{TRAIN_BATCH / dt:.2f} samples/s; warp launches {fwd} forward, "
        f"{bwd} backward; losses {losses[0]:.5f} .. {losses[-1]:.5f}")
    want = LAUNCHES_PER_STEP * TRAIN_TIMED_STEPS
    if fwd != want or bwd != want:
        raise AssertionError(f"expected {want} forward and {want} backward launches, "
                             f"counted {fwd} and {bwd}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    still = [k for k, v in state.model.state_dict().items() if torch.equal(v, before[k])]
    if still:
        raise AssertionError(f"{len(still)} parameters did not move, e.g. {still[:3]}")
    rec.update(ms_per_step=dt * 1e3, samples_per_s=TRAIN_BATCH / dt,
               launches=read_counts(warp_mod), losses=losses)
    del before

    prof = device_breakdown(lambda: train_step(state, batches[1], torch.bfloat16),
                            calls=3)
    idle = max(0.0, 1 - prof["kernel_ms_per_call"] / rec["ms_per_step"])
    log(f"  device time of one bf16 step: {prof['kernel_ms_per_call']:.3f} ms in "
        f"{prof['launches_per_call']:.0f} kernels, copies and memsets; idle "
        f"{idle:.1%} of an unprofiled step, {prof['idle_share']:.1%} of the profiled window "
        f"({prof['window_ms_per_call']:.3f} ms)")
    for k, v in sorted(prof["ms_per_call"].items(), key=lambda kv: -kv[1]):
        log(f"    {v:8.3f} ms  {v / prof['kernel_ms_per_call']:6.1%}  {k}")
    for name, ms, n in prof["top"][:8]:
        log(f"    top: {ms:8.3f} ms  {n:5.1f}x  {name}")
    rec["breakdown"] = {**prof, "idle_share_unprofiled": idle}

    # (f) The bf16 step's gradients against the port's own f32 step's, on
    # one batch of the run: asserted from a random init (seed 0), where the
    # gradients are far above bf16's rounding; at the converged r5 weights
    # the f32 gradient is near that floor (bf16 alone moves the loss there
    # by ~15% on the CPU at 4x128x128), so its cosines are only reported.
    cos_r5 = grad_cosines(state.model, batches[1], model_def)
    del state
    fresh = train_init(model_def, total_steps=R5_STEPS, seed=0, device=dev)
    cos = grad_cosines(fresh.model, batches[1], model_def)
    del fresh
    fmt = lambda c: ", ".join(f"{k} {v:.5f}" for k, v in c.items())  # noqa: E731
    log(f"  bf16 vs f32 gradient cosine per block, random init (>= 0.99): {fmt(cos)}")
    log(f"  the same at the r5 weights (reported only): {fmt(cos_r5)}")
    if not all(v >= 0.99 for v in cos.values()):
        raise AssertionError(f"bf16 gradients stray from f32: {cos}")
    rec["grad_cosine_bf16_vs_f32"] = {"random_init": cos, "r5": cos_r5}

    # (e) One f32 step on the card against the CPU path, 2x64x64.
    small = next(batch_iterator(SyntheticTriplets(n=4, h=72, w=72, seed=3), 2,
                                seed=3, crop=64))
    sd = state_dict_from_jax(load_checkpoint(CKPT)[1])

    def f32_step(where):
        st = train_init(model_def, total_steps=R5_STEPS, params=sd, device=where)
        with full_f32():
            loss, _, _ = loss_fn(st.model, small, model_def, torch.float32)
            loss.backward()
        return loss.item(), {k: v.cpu() for k, v in _grads(st.model).items()}

    (lc, gc), (lh, gh) = f32_step(dev), f32_step(torch.device("cpu"))
    loss_rel = abs(lc - lh) / abs(lh)
    worst = max((_rel(gc[k], gh[k]), k) for k in gh)
    log(f"  f32 step on the card vs the CPU path at 2x64x64: loss {lc:.7f} vs "
        f"{lh:.7f} (rel {loss_rel:.2e} <= 1e-4), worst gradient rel norm "
        f"{worst[0]:.2e} ({worst[1]}, <= 1e-3)")
    if not (loss_rel <= 1e-4 and worst[0] <= 1e-3):
        raise AssertionError("the card's f32 step disagrees with the CPU path")
    rec.update(f32_loss_rel_card_vs_cpu=loss_rel, f32_grad_worst_rel=worst[0])

    # (g) Loss-decrease smoke from a random init, fixed lr: over a stream
    # of batches (the per-batch losses are noisy, so this alone would pass
    # a zero or wrong-sign update), then on one fixed batch, where the mean
    # of the last 5 of 20 losses must sit 10% below that of the first 5
    # (tests/test_torch_train_smoke.py holds the same check on the CPU, and
    # shows that a zeroed or negated gradient fails it).
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    st = train_init(model_def, total_steps=30, schedule=lambda step: 2e-4, seed=0,
                    device=dev)
    it = batch_iterator(SyntheticTriplets(n=16, h=72, w=72), 2, crop=64)
    curve = [float(train_step(st, next(it), SMOKE_DTYPE)["loss"]) for _ in range(30)]
    ok = min(curve[5:]) < mean(curve[:3])
    log(f"  30 steps from a random init ({SMOKE_DTYPE}, lr 2e-4, 2x64x64): "
        f"first 3 mean {mean(curve[:3]):.5f}, min after 5 {min(curve[5:]):.5f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"loss did not decrease: {curve}")
    st = train_init(model_def, total_steps=20, schedule=lambda step: 2e-4, seed=0,
                    device=dev)
    fixed = next(batch_iterator(SyntheticTriplets(n=16, h=72, w=72), 2, crop=64))
    fixed_curve = [float(train_step(st, fixed, SMOKE_DTYPE)["loss"]) for _ in range(20)]
    ratio = mean(fixed_curve[-5:]) / mean(fixed_curve[:5])
    log(f"  20 steps on one fixed batch, the same settings: mean of the last 5 "
        f"{mean(fixed_curve[-5:]):.5f} / first 5 {mean(fixed_curve[:5]):.5f} = "
        f"{ratio:.4f} (<= 0.9) {'ok' if ratio <= 0.9 else 'FAIL'}")
    if not ratio <= 0.9:
        raise AssertionError(f"loss did not fall on a fixed batch: {fixed_curve}")
    rec.update(smoke_losses=curve, fixed_batch_losses=fixed_curve)
    return rec


def train_family_state(model: str, dev, **kw):
    """`model`'s TrainState on `dev` as the training CLI builds it at
    batch TRAIN_BATCH: its weight decay (1e-4 for v4.25 and the legacy
    models, 1e-3 otherwise) and schedule (the legacy models' cyclic lr,
    else warmup + cosine), from `train_family_weights`."""
    from rife_tpu_torch.models import get_model_def
    from rife_tpu_torch.tools.train_family import train_family_weights
    from rife_tpu_torch.train import cyclic_lr_schedule, train_init

    legacy = model in ("hd", "hdv2")
    ws = TRAIN_BATCH / 64.0
    kw.setdefault("schedule", cyclic_lr_schedule(world_scale=ws) if legacy else None)
    return train_init(get_model_def(model), total_steps=3 * TRAIN_FAMILY_START[model],
                      world_scale=ws, weight_decay=1e-4 if legacy or model == "v4.25"
                      else 1e-3, params=train_family_weights(model), device=dev, **kw)


@contextlib.contextmanager
def f32_convs(cudnn: bool):
    """Inside: full f32 (`full_f32`: no TF32 in cuDNN or in matmuls), with
    cuDNN on or off; raises if TF32 is on inside.  Only
    `torch.backends.cudnn.enabled` is toggled: `torch.backends.cudnn.flags`
    also sets allow_tf32 and the other flags to its keyword defaults,
    which turns TF32 back on inside `full_f32`."""
    from rife_tpu_torch.engine.inference import full_f32

    saved = torch.backends.cudnn.enabled
    with full_f32():
        torch.backends.cudnn.enabled = cudnn
        try:
            if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("TF32 is on inside an f32 step")
            yield
        finally:
            torch.backends.cudnn.enabled = saved


def _block_cosines(ga: dict, gb: dict) -> dict:
    """Cosine of two gradients per top-level module, in f64 (the modules
    that `gb` gives no gradient left out)."""
    cos = {}
    for block in sorted({k.split(".")[0] for k in gb}):
        a, b = (torch.cat([g[k].flatten() for k in gb if k.split(".")[0] == block]).double()
                for g in (ga, gb))
        if float(b.norm()) > 0:
            cos[block] = float(torch.dot(a, b) / (a.norm() * b.norm()))
    return cos


def family_cosines(state, batch) -> dict:
    """bf16 against f32 gradients per block on `batch`: of the whole
    objective, and of the network alone under one cotangent (the f32
    objective's gradient at the f32 output frame, backpropagated through
    the bf16 and the f32 network), and the f32 flow's mean magnitude.
    The second leaves out what the legacy objective's census term does to
    a bf16 frame's rounding.  Both run as training does (`train_step`:
    `full_f32`, cuDNN, no TF32)."""
    from rife_tpu_torch.train import loss_fn
    from rife_tpu_torch.train.loop import LEGACY, PAPER_FAMILY, dev01
    from rife_tpu_torch.train.losses import ternary_loss

    model, md = state.model, state.model_def
    full, net = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        model.zero_grad(set_to_none=True)
        with f32_convs(cudnn=True):
            loss, _, vis = loss_fn(model, batch, md, dtype)
            loss.backward()
        full[dtype] = _grads(model)
    pred = vis["pred"].clone().requires_grad_(True)
    gt = vis["gt"]
    if md.name in LEGACY:  # the legacy objective's terms in pred
        obj = torch.sqrt((pred - gt) ** 2 + 1e-6).mean() + ternary_loss(pred, gt)
    elif md.name == "v4.25":
        obj = (pred - gt).abs().mean()
    else:
        from rife_tpu_torch.ops.pyramid import lap_loss
        obj = lap_loss(pred, gt)
    g_pred, = torch.autograd.grad(obj, pred)
    b = dev01(batch, g_pred.device)
    for dtype in (torch.bfloat16, torch.float32):
        model.zero_grad(set_to_none=True)
        kw = {} if md.name in LEGACY else {"timestep": b["timestep"]}
        if md.name in PAPER_FAMILY:
            kw["gt"] = b["gt"].to(dtype)
        with f32_convs(cudnn=True):
            out = model(b["img0"].to(dtype), b["img1"].to(dtype), scale_list=md.scale_list,
                        **kw)
            out["merged"][-1].float().backward(g_pred)
        net[dtype] = _grads(model)
    model.zero_grad(set_to_none=True)
    return {"objective": _block_cosines(full[torch.bfloat16], full[torch.float32]),
            "network": _block_cosines(net[torch.bfloat16], net[torch.float32]),
            "mean_abs_flow": float(vis["flow"].abs().mean())}


def small_batch(model):
    """The f32 card-vs-CPU step's 2x64x64 batch (TRAIN_FAMILY_SMALL)."""
    from rife_tpu_torch.data import SyntheticTriplets, batch_iterator

    seed, ts = TRAIN_FAMILY_SMALL[model]
    b = next(batch_iterator(SyntheticTriplets(n=4, h=72, w=72, seed=seed), 2, seed=seed,
                            crop=64))
    if ts is not None:
        b["timestep"] = np.broadcast_to(np.asarray(ts, np.float32), (2,)).copy()
    return b


@contextlib.contextmanager
def recorded_nhwc_bwd(warp_mod):
    """Inside: every call of the NHWC warp's gradient (`warp_nhwc_bwd`,
    which `_WarpNHWC.backward` calls) also records (N, H, W, C, the
    strides of the image, the flow and the cotangent, image dtype, flow
    dtype, need_img, need_flow) in the yielded list."""
    seen = []
    fn = warp_mod.warp_nhwc_bwd

    def call(img, flow, g, need_img=True, need_flow=True):
        seen.append((*img.shape, img.stride(), flow.stride(), g.stride(), img.dtype,
                     flow.dtype, need_img, need_flow))
        return fn(img, flow, g, need_img, need_flow)

    warp_mod.warp_nhwc_bwd = call
    try:
        yield seen
    finally:
        warp_mod.warp_nhwc_bwd = fn


def strided(values: torch.Tensor, stride, dtype) -> torch.Tensor:
    """`values` copied into a tensor of `dtype` with `stride` (a channel
    slice of a wider NHWC tensor, or NCHW memory seen as NHWC)."""
    n = 1 + sum((s - 1) * st for s, st in zip(values.shape, stride))
    out = torch.zeros(n, dtype=dtype, device=values.device).as_strided(values.shape, stride)
    out.copy_(values)
    return out


def nhwc_bwd_inputs(key, gen, dev):
    """Seeded image, flow and cotangent in the layout and dtypes of one
    recorded NHWC gradient call (`recorded_nhwc_bwd`)."""
    n, h, w, c, s_img, s_flow, s_g, idt, fdt, _, _ = key
    flow = smooth_flow(n, h, w, 8.0 * w / TRAIN_CROP, gen, dev, torch.float32)
    img, _, g = bwd_inputs(n, c, h, w, torch.float32, flow, gen)
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    return (strided(nhwc(img), s_img, idt), strided(nhwc(flow), s_flow, fdt),
            strided(nhwc(g), s_g, idt))


def check_nhwc_bwd(warp_mod, img, flow, g, need_img, need_flow, label) -> float:
    """The NHWC warp's gradient (`warp_nhwc_bwd`: the copies into NCHW
    planes, K1's gradient kernel, the results seen as NHWC) on tensors in
    the layout training gives it, against the plain gradient of the
    permuted planes (`check_bwd`'s bounds) -> the largest error."""
    before = warp_mod.warp_planes_bwd.launches
    got = warp_mod.warp_nhwc_bwd(img, flow, g, need_img, need_flow)
    torch.cuda.synchronize()
    if warp_mod.warp_planes_bwd.launches != before + 1:
        raise AssertionError(f"{label}: the NHWC gradient did not launch K1's gradient kernel")
    for t, x, name in zip(got, (img, flow), ("d_img", "d_flow")):
        if t is not None and t.shape != x.shape:
            raise AssertionError(f"{label}: {name} is {tuple(t.shape)}, not {tuple(x.shape)}")
    planes = lambda t: None if t is None else t.permute(0, 3, 1, 2)  # noqa: E731
    return check_bwd(warp_mod, planes(img), planes(flow), planes(g), need_img, label,
                     need_flow=need_flow, got=tuple(planes(t) for t in got))


def train_family_path(dev, warp_mod, cuda_warp, cuda_blend, cuda_nhwc):
    """Phase 16: every other preset's training at full width (see the
    module docstring).  Returns {model: record} and the records of the
    new gradient launch shapes."""
    from rife_tpu_torch.cli import train as train_cli
    from rife_tpu_torch.data import SyntheticSeptuplets, SyntheticTriplets, batch_iterator
    from rife_tpu_torch.tools.train_family import TRAIN_FAMILY, TRAIN_FAMILY_LAUNCHES
    from rife_tpu_torch.train import loss_fn, train_step
    from rife_tpu_torch.train.loop import LEGACY

    rec, failures = {}, []

    def gate(ok: bool, msg: str):
        if not ok:
            failures.append(msg)
            log(f"  FAIL: {msg}")

    # Phase 8's plane launches; every NHWC gradient call is new (checked
    # through its wrapper, in its layout).
    checked_bwd = {(2 * TRAIN_BATCH, c, h, w, torch.bfloat16, fd, ni)
                   for _, c, h, w, _, fd, ni in TRAIN_STEP_WARPS}
    new_bwd, nhwc_bwd, fwd_keys, nhwc_keys = {}, {}, [], []
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    fmt = lambda c: ", ".join(f"{k} {v:.5f}" for k, v in c.items())  # noqa: E731
    for model in TRAIN_FAMILY:
        t0 = time.perf_counter()
        state = train_family_state(model, dev)
        md = state.model_def
        crop = max(md.pad_multiple, TRAIN_CROP // md.pad_multiple * md.pad_multiple)
        cls = SyntheticSeptuplets if model == "rife_m" else SyntheticTriplets
        it = batch_iterator(cls(n=4 * TRAIN_BATCH, h=crop + 8, w=crop + 8), TRAIN_BATCH,
                            crop=crop)
        batches = [next(it) for _ in range(TRAIN_FAMILY_TIMED_STEPS + 1)]
        state.step = TRAIN_FAMILY_START[model]
        log(f"  {model}: state (step {state.step}, lr {state.schedule(state.step):.3g}, "
            f"weight decay {state.optimizer.defaults['weight_decay']:g}) and "
            f"{len(batches)} batches of {TRAIN_BATCH}x{crop}x{crop} ready in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        with (recorded_launches(cuda_warp) as seen, recorded_blend(cuda_blend) as k2,
              recorded_nhwc(cuda_nhwc) as nhwc, recorded_nhwc_bwd(warp_mod) as nb,
              no_plain_on_the_card(warp_mod)):
            train_step(state, batches[0], torch.bfloat16)
            torch.cuda.synchronize()
        log(f"  {model} warm-up step: {time.perf_counter() - t0:.2f} s")
        if model not in LEGACY:  # the legacy models' gradient launches are all NHWC calls
            for key in seen["bwd"]:
                if key not in checked_bwd:
                    new_bwd.setdefault(key, model)
        for key in nb:
            nhwc_bwd.setdefault(key, model)
        fwd_keys += [("k1", *k[:6]) for k in seen["fwd"]] + [("k2", *k) for k in k2]
        nhwc_keys += nhwc
        before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        reset_counts(warp_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_plain_on_the_card(warp_mod):
            losses = [train_step(state, b, torch.bfloat16)["loss"] for b in batches[1:]]
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / TRAIN_FAMILY_TIMED_STEPS
        counts = read_counts(warp_mod)
        losses = [float(x) for x in losses]
        per_step = {k: v / TRAIN_FAMILY_TIMED_STEPS for k, v in counts.items()}
        log(f"  {model}: {TRAIN_FAMILY_TIMED_STEPS} bf16 steps at batch {TRAIN_BATCH}, "
            f"{crop}x{crop}: {dt * 1e3:.2f} ms/step, {TRAIN_BATCH / dt:.2f} samples/s; "
            f"launches per step {({k: v for k, v in per_step.items() if v})}; losses "
            f"{losses[0]:.5f} .. {losses[-1]:.5f}")
        want = {k: 0 for k in counts}
        want.update({k: v * TRAIN_FAMILY_TIMED_STEPS
                     for k, v in TRAIN_FAMILY_LAUNCHES[model].items()})
        if counts != want:
            raise AssertionError(f"{model}: expected launches {want}, counted {counts}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{model}: non-finite loss: {losses}")
        still = [k for k, v in state.model.state_dict().items() if torch.equal(v, before[k])]
        if still:
            raise AssertionError(f"{model}: {len(still)} parameters did not move, "
                                 f"e.g. {still[:3]}")
        del before
        r = {"crop": crop, "ms_per_step": dt * 1e3, "samples_per_s": TRAIN_BATCH / dt,
             "launches": counts, "launches_per_step": per_step, "losses": losses,
             "start_step": TRAIN_FAMILY_START[model],
             "weight_decay": state.optimizer.defaults["weight_decay"]}

        # bf16 against f32 gradients on a batch of the run, at the start
        # weights and after the timed steps at the schedule's top (the
        # legacy models' there reported: TRAIN_COSINE_MIN's comment).
        gated = "network" if model in LEGACY else "objective"
        cos = {}
        for where, st in (("trained", state), ("start", None)):
            t0 = time.perf_counter()
            st = st or train_family_state(model, dev)
            cos[where] = family_cosines(st, batches[1])
            held = where == "start" or model not in LEGACY
            at = "at the start weights" if where == "start" else "after the timed steps"
            log(f"  {model} bf16 vs f32 gradient cosine per block {at}, "
                f"{TRAIN_BATCH}x{crop}x{crop} ({time.perf_counter() - t0:.2f} s; mean |flow| "
                f"{cos[where]['mean_abs_flow']:.2f} px): objective "
                f"{fmt(cos[where]['objective'])}; network under the f32 objective's "
                f"cotangent {fmt(cos[where]['network'])} "
                f"({f'gated >= {TRAIN_COSINE_MIN}: {gated}' if held else 'reported'})")
            gate(not held or all(v >= TRAIN_COSINE_MIN for v in cos[where][gated].values()),
                 f"{model}: bf16 gradients stray from f32 ({where}): {cos[where][gated]}")
            del st
        del state
        r["grad_cosine_bf16_vs_f32"] = {**cos, "gated": gated,
                                        "trained_gated": model not in LEGACY}

        # One f32 step on the card against the CPU path at 2x64x64, as f32
        # training runs (cuDNN, no TF32); where cuDNN's algorithms take a
        # wider limit, the same step with PyTorch's own convs beside it.
        small = small_batch(model)

        def f32_step(where, cudnn=True):
            st = train_family_state(model, where)
            with f32_convs(cudnn):
                loss, _, _ = loss_fn(st.model, small, st.model_def, torch.float32)
                loss.backward()
            return loss.item(), {k: v.cpu() for k, v in _grads(st.model).items()}

        lh, gh = f32_step(torch.device("cpu"))
        lim = TRAIN_F32_CUDNN_GRAD_MAX.get(model, TRAIN_F32_GRAD_MAX)
        runs = [(True, lim)] + ([(False, TRAIN_F32_GRAD_MAX)] if lim > TRAIN_F32_GRAD_MAX
                                else [])
        for cudnn, lim in runs:
            lc, gc = f32_step(dev, cudnn)
            loss_rel = abs(lc - lh) / abs(lh)
            errs = sorted(((_rel(gc[k], gh[k]), k) for k in gh), reverse=True)
            log(f"  {model} f32 step on the card ({'cuDNN' if cudnn else 'PyTorch own'} "
                f"convs, no TF32) vs the CPU path at 2x64x64: loss {lc:.7f} vs {lh:.7f} (rel "
                f"{loss_rel:.2e} <= 1e-4), worst gradient rel norms "
                f"{', '.join(f'{e:.2e} ({k})' for e, k in errs[:3])} (<= {lim:g})")
            gate(loss_rel <= 1e-4 and errs[0][0] <= lim,
                 f"{model}: the card's f32 step ({'cuDNN' if cudnn else 'own'} convs) "
                 f"disagrees with the CPU path: loss {loss_rel:.2e}, {errs[0]}")
            r[f"f32_card_vs_cpu_{'cudnn' if cudnn else 'native_convs'}"] = {
                "loss_rel": loss_rel, "grad_worst_rel": errs[0][0],
                "grad_worst_leaf": errs[0][1], "limit": lim}

        st = train_family_state(model, dev, schedule=lambda step: 2e-4)
        fcls = SyntheticSeptuplets if model in ("rife_m", "v4.25") else SyntheticTriplets
        fixed = next(batch_iterator(fcls(n=16, h=72, w=72), 2, crop=64))
        curve = [float(train_step(st, fixed, SMOKE_DTYPE)["loss"]) for _ in range(20)]
        ratio = mean(curve[-5:]) / mean(curve[:5])
        log(f"  {model}: 20 steps on one fixed 2x64x64 batch ({SMOKE_DTYPE}, lr 2e-4): mean "
            f"of the last 5 {mean(curve[-5:]):.5f} / first 5 {mean(curve[:5]):.5f} = "
            f"{ratio:.4f} (<= 0.9) {'ok' if ratio <= 0.9 else 'FAIL'}")
        gate(ratio <= 0.9, f"{model}: loss did not fall on a fixed batch: {curve}")
        r["fixed_batch_losses"] = curve
        rec[model] = r
        del st
        torch.cuda.empty_cache()

    # The kernels at this phase's launch shapes: K1, K2, K3, K4 checked;
    # K1's gradient at the plane shapes phase 8 did not check, and through
    # the NHWC wrapper at every call the legacy models made, checked and timed.
    fwd = check_launch_keys(warp_mod, dev, fwd_keys, {}, "train family")
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    nhwc_err = 0.0
    for kernel, n, h, w, c, stride, idt, fdt in sorted(set(nhwc_keys), key=str):
        img, flow = nhwc_inputs(n, c, h, w, stride, gen, dev, idt, fdt)
        nhwc_err = max(nhwc_err, check_nhwc(warp_mod, img, flow,
                                            f"train family {kernel} {n}x{h}x{w}x{c}"))
    records, bwd_err = [], 0.0
    for (n, c, h, w, idt, fdt, need_img), model in sorted(new_bwd.items(), key=str):
        flow = smooth_flow(n, h, w, 8.0 * w / TRAIN_CROP, gen, dev, fdt)
        img, flow, g = bwd_inputs(n, c, h, w, idt, flow, gen)
        label = (f"{model} gradient {tuple(img.shape)} {dtypes_label(img, flow)} "
                 f"need_img={need_img}")
        err = check_bwd(warp_mod, img, flow, g, need_img, label)
        bwd_err = max(bwd_err, err)
        t = time_bwd_launch(warp_mod, img, flow, g, need_img)
        records.append({"launch": label, "model": model, "img": [n, c, h, w],
                        "dtype": SHORT_DTYPE[idt], "flow_dtype": SHORT_DTYPE[fdt],
                        "need_img": need_img, "nhwc": False, "max_abs_err": err, **t})
        log(f"  {label}: kernel {t['ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us, "
            f"grid_sampler_2d_backward(f32) {t['library_ms'] * 1e3:.1f} us, bound "
            f"{t['bound_ms'] * 1e3:.1f} us -> {t['bound_ms'] / t['ms']:.1%}")
    for key, model in sorted(nhwc_bwd.items(), key=str):
        n, h, w, c, s_img, _, _, idt, fdt, need_img, need_flow = key
        img, flow, g = nhwc_bwd_inputs(key, gen, dev)
        label = (f"{model} NHWC gradient {(n, h, w, c)} (pixel stride {s_img[2]}) "
                 f"{dtypes_label(img, flow)} need_img={need_img}")
        err = check_nhwc_bwd(warp_mod, img, flow, g, need_img, need_flow, label)
        bwd_err = max(bwd_err, err)
        # The kernel alone on contiguous planes; the wrapper, copies included,
        # on tensors in the recorded layout; the copies into planes apart.
        planes = [x.permute(0, 3, 1, 2).contiguous() for x in (img, flow, g)]
        t = time_bwd_launch(warp_mod, *planes, need_img)
        copies = max(1, math.ceil(160e6 / t["bytes"]))
        views = [nhwc_bwd_inputs(key, gen, dev) for _ in range(copies)]
        t["wrapper_ms"] = device_ms(warp_mod.warp_nhwc_bwd,
                                    [(*v, need_img, need_flow) for v in views])
        t["permute_copies_ms"] = device_ms(
            lambda *xs: [x.permute(0, 3, 1, 2).contiguous() for x in xs], views)
        del views
        records.append({"launch": label, "model": model, "img": [n, c, h, w],
                        "img_pixel_stride": s_img[2], "dtype": SHORT_DTYPE[idt],
                        "flow_dtype": SHORT_DTYPE[fdt], "need_img": need_img, "nhwc": True,
                        "max_abs_err": err, **t})
        log(f"  {label}: kernel {t['ms'] * 1e3:.1f} us, the wrapper (copies included) "
            f"{t['wrapper_ms'] * 1e3:.1f} us, the permute copies "
            f"{t['permute_copies_ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us, "
            f"grid_sampler_2d_backward(f32) {t['library_ms'] * 1e3:.1f} us, bound "
            f"{t['bound_ms'] * 1e3:.1f} us -> {t['bound_ms'] / t['ms']:.1%}")

    # The training CLI with panels on every step, on the card.
    log_dir = os.path.join(ROOT, "build", "chip_smoke_train_cli")
    shutil.rmtree(log_dir, ignore_errors=True)
    t0 = time.perf_counter()
    train_cli.main(["--model", "v4.25", "--septuplet", "--synthetic", "--steps", "2",
                    "--batch_size", "2", "--crop", "64", "--vis_interval", "1",
                    "--dtype", "bfloat16", "--workers", "2", "--log_dir", log_dir])
    pngs = sorted(os.path.relpath(os.path.join(d, f), log_dir)
                  for d, _, fs in os.walk(log_dir) for f in fs if f.endswith(".png"))
    want = sorted(os.path.join("panels", f"step_{s:08d}", f"{i}_{k}.png")
                  for s in (1, 2) for i in (0, 1) for k in ("img", "flow", "mask"))
    log(f"  the CLI (v4.25, septuplets, bf16, 2 steps, --vis_interval 1) in "
        f"{time.perf_counter() - t0:.2f} s: {len(pngs)} panels under "
        f"{os.path.relpath(log_dir, ROOT)}")
    gate(pngs == want, f"the CLI's panels {pngs} are not {want}")
    if failures:
        raise AssertionError(f"train family: {len(failures)} checks failed: {failures}")
    return rec, {"bwd": records, "bwd_err": bwd_err, "k1_err": fwd["k1_err"],
                 "k2_err": fwd["k2_err"], "nhwc_err": nhwc_err,
                 "shapes_checked": fwd["checked"] + len(set(nhwc_keys)) + len(records)}


def convchain_path(dev, warp_mod, chain_mod):
    """Phase 9: K5 against its plain version, then on the convblock inputs
    of one served rife request, then timed (see the module docstring).
    Returns the records."""
    from rife_tpu_torch.engine import (InferenceEngine, load_checkpoint,
                                       state_dict_from_jax)
    from rife_tpu_torch.ops import pad_to_multiple
    from rife_tpu_torch.tools import conv_chain as tool

    resources = tool.kernel_resources()
    for r in resources:
        log(f"  {tool.describe_resources(r)}")
    name, tree = load_checkpoint(CKPT)
    eng = InferenceEngine("rife", state_dict_from_jax(tree), compute_dtype=torch.bfloat16,
                          fast=1, device=dev)
    blocks = [getattr(eng.model, f"block{i}") for i in range(3)]
    rec = {"resources": resources,
           "checks": tool.check_kernel(dev, [blk.convblock for blk in blocks])}
    a, b = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    a, _ = pad_to_multiple(torch.from_numpy(a), 32)
    b, _ = pad_to_multiple(torch.from_numpy(b), 32)
    a, b = a.to(dev), b.to(dev)
    eng.warmup(tuple(a.shape))
    packed = [chain_mod.pack_chain(blk.convblock) for blk in blocks]
    seen = [{} for _ in blocks]
    hooks = []
    for blk, got in zip(blocks, seen):
        hooks.append(blk.convblock[0].register_forward_pre_hook(
            lambda m, args, got=got: got.update(x=args[0].clone())))
        hooks.append(blk.convblock[-1].register_forward_hook(
            lambda m, args, out, got=got: got.update(y=out.clone())))
    want_shapes = tool.served_shapes(BATCH, a.shape[1], a.shape[2])
    reset_counts(warp_mod)
    torch.cuda.synchronize()
    eng.interpolate(a, b)
    for h in hooks:
        h.remove()
    outs = []
    for got, p, (blk_name, n, h, w, c) in zip(seen, packed, want_shapes):
        if tuple(got["x"].shape) != (n, c, h, w):
            raise AssertionError(f"{blk_name}: convblock input {tuple(got['x'].shape)}, "
                                 f"expected {(n, c, h, w)}")
        outs.append(chain_mod.conv_chain(got["x"].permute(0, 2, 3, 1).contiguous(), *p))
    torch.cuda.synchronize()
    counts = read_counts(warp_mod)
    k1_last, k2 = final_launches(warp_mod)
    stages = sum(p[0].shape[0] for p in packed)
    log(f"  one rife request and K5 on its three convblock inputs: launches {counts}")
    check_counts(counts, 1, LAUNCHES_PER_FORWARD + k1_last, k2, "convchain path",
                 k5=stages)
    rec["launches"] = counts
    rec["model"] = []
    for got, p, out, (blk_name, n, h, w, c) in zip(seen, packed, outs, want_shapes):
        e, plain = tool.chain_errors(out, got["x"].permute(0, 2, 3, 1).contiguous(), p)
        cudnn = (got["y"] + got["x"]).permute(0, 2, 3, 1).float()
        e["mean_rel_vs_cudnn"] = float((out.float() - cudnn).abs().mean() / cudnn.abs().mean())
        e["cudnn_mean_rel_vs_plain"] = float((cudnn - plain.float()).abs().mean()
                                             / plain.float().abs().mean())
        ok = (e["mean_rel"] <= tool.CHAIN_MEAN_REL
              and e["kernel_vs_f32"] <= tool.PARITY * e["plain_vs_f32"]
              and e["mean_rel_vs_cudnn"] < 2e-2 and bool(torch.isfinite(out).all()))
        log(f"  {blk_name} {(n, h, w, c)} r5 weights, request data: K5 vs plain mean rel "
            f"{e['mean_rel']:.3g} (<= {tool.CHAIN_MEAN_REL}), max |diff| "
            f"{e['max_abs_err']:.4g}; to the f32 chain K5 {e['kernel_vs_f32']:.4g}, plain "
            f"{e['plain_vs_f32']:.4g} (<= {tool.PARITY}x); K5 vs the model's cuDNN chain "
            f"mean rel {e['mean_rel_vs_cudnn']:.3g} (< 2e-2; cuDNN vs plain "
            f"{e['cudnn_mean_rel_vs_plain']:.3g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K5 on {blk_name}'s request data disagrees")
        rec["model"].append({"block": blk_name, **e})
    del eng, seen, outs
    torch.cuda.empty_cache()
    rec["times"] = [tool.time_shape(*shape, dev) for shape in want_shapes]
    return rec


def probes_path(dev, warp_mod) -> dict:
    """Phase 10: the gather probes (see the module docstring), through the
    tool's `run`; the launches are counted from just before its `drive` to
    just after it.  Returns the records."""
    from rife_tpu_torch.tools import gather_probe as tool

    seen = {}
    recs = tool.run(dev, tiny=False, chaotic_outer=PROBE_CHAOTIC_OUTER,
                    before_drive=lambda: reset_counts(warp_mod),
                    after_drive=lambda: seen.update(read_counts(warp_mod)))
    want = {k: tool.DRIVE_LAUNCHES.get(k, 0) for k in seen}
    log(f"  the probe path's launches: {seen}")
    if seen != want:
        raise AssertionError(f"probe path: expected launches {want}, counted {seen}")
    recs["launches"] = seen
    return recs


def probe_rows(probes: dict, smi: str) -> list:
    """The kernels line's rows of K6-K8 from phase 10's records."""
    e1, e2, e21 = probes["exp1"], probes["exp2"], probes["exp21"]
    launches = probes["launches"]
    src = "rife_tpu_torch/csrc/gather_probe.cu"
    sums = lambda recs: {k: sum(r[k] for r in recs)  # noqa: E731
                         for k in ("ms", "plain_ms", "bound_ms")}
    exact = lambda recs: max(r["max_abs_err"] for r in recs)  # noqa: E731
    micro_err = max(r["max_abs_err"] for r in e1["micro"] + e2["micro"] if "max_abs_err" in r)
    big_sel = e1["select_times"][-1]
    big_tiles = [r for r in e21["times"] if r["tiles"] == max(r["tiles"] for r in e21["times"])]
    budget = e1["budget_times"]
    micro = e1["micro_times"]
    card_wide = [max(r["operations_ms"], r["bytes_ms"]) for r in micro]
    chain = sum(r["chain_floor_ms"] for r in micro)
    return [{
        "name": "micro", "wrapper": "rife_tpu_torch.ops.gather_probe.micro", "route": "cuda",
        "source": src, "replaces": "tools/r3_exp1.py:45",
        "replaces_also": "tools/r3_exp2.py:45 (micro)", "launches": launches["micro"],
        "max_abs_err": micro_err, "ms": sum(r["ms"] for r in micro),
        "plain_ms": sum(r["plain_ms"] for r in micro), "bound_ms": sum(card_wide),
        "bound_by": "operations" if all(r["operations_ms"] >= r["bytes_ms"] for r in micro)
        else "bytes", "chain_floor_ms": chain, "chain_bound_by": "latency",
        "share_of_chain_floor": chain / sum(r["ms"] for r in micro),
        "assumed_cycles": {"alu": micro[0]["alu_cycles"],
                           "smem_load_or_shuffle": micro[0]["smem_load_cycles"]},
        "library_ms": None, "warp_form_ms": sum(r["warp_form_ms"] for r in micro),
        "design": MICRO_DESIGN,
        "times_are": "r3_exp1.py's 8 bodies at R = 4000, one launch each, summed, the block "
                     "form (warp_form_ms: the tile in one warp's registers); bound: the "
                     "card-wide operations over 67 TF/s; chain_floor: the dependent chain "
                     "of each step at the SM clock (per_body: each body's); plain: the "
                     "plain version on the host, one thread",
        "per_body": e1["micro_times"] + e2["micro_times"], "checks": e1["micro"] + e2["micro"],
        "card": smi}, {
        "name": "select_rows", "wrapper": "rife_tpu_torch.ops.gather_probe.select_rows",
        "route": "cuda", "source": src, "replaces": "tools/r3_exp1.py:92",
        "launches": launches["select_rows"], "max_abs_err": exact(e1["checks"][:2]),
        **{k: big_sel[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "times_are": f"4416 permuted 8x1280 f32 blocks of a {big_sel['x']} stack; library: "
                     f"{big_sel['library']}",
        "per_shape": e1["select_times"], "card": smi}, {
        "name": "tile_gather", "wrapper": "rife_tpu_torch.ops.gather_probe.tile_gather",
        "route": "cuda", "source": src, "replaces": "tools/r3_exp21.py:31",
        "launches": launches["tile_gather"], "max_abs_err": exact(e21["checks"]),
        **sums(big_tiles), "bound_by": "bytes",
        "library_ms": sum(r["library_ms"] for r in big_tiles),
        "times_are": f"lane + sublane + bcast8 at NT = {big_tiles[0]['tiles']}, summed; "
                     f"library: torch.gather", "per_shape": e21["times"], "card": smi}, {
        "name": "warp_nhwc_cb1", "wrapper": "rife_tpu_torch.ops.gather_probe.warp_nhwc_cb1",
        "route": "cuda", "source": src, "replaces": "tools/r3_exp1.py:127",
        "launches": launches["warp_nhwc_cb1"], "max_abs_err": exact(e1["checks"][2:]),
        **{k: budget[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "k3_ms": budget["k3_ms"], "design": CB1_DESIGN, "plan": budget["plan"],
        "times_are": f"per warp of {budget['shape']} bf16 (10 chained); library: "
                     f"{budget['library']}",
        "exp2_warps": {"checks": e2["warp_checks"], "times": e2["warp_times"]},
        "probe_path_launches": launches, "card": smi}]


def family_state_dict(model: str, seed: int = 0) -> dict:
    """Seeded random weights of `rife_m` or `rife_2r` (the port's
    `ModelDef.init`), each block's flow head (lastconv's first 4 output
    channels) scaled by FAMILY_FLOW_GAIN."""
    from rife_tpu_torch.models import get_model_def

    sd = get_model_def(model).init(torch.Generator().manual_seed(seed))
    for i in range(3):
        sd[f"block{i}.lastconv.weight"][:, :4] *= FAMILY_FLOW_GAIN
        sd[f"block{i}.lastconv.bias"][:4] *= FAMILY_FLOW_GAIN
    return sd


@contextlib.contextmanager
def recorded_blend(cuda_blend):
    """Inside: every K2 launch also records (N, C, H, W, image dtype, flow
    dtype, mask dtype, whether it stores the pair) in the yielded list
    (from any thread: the HTTP server's request threads too)."""
    seen = []
    launch = cuda_blend.launch

    def recorded(a, b, flow, mask, emit_pair):
        seen.append((*a.shape, a.dtype, flow.dtype, mask.dtype, bool(emit_pair)))
        return launch(a, b, flow, mask, emit_pair)

    cuda_blend.launch = recorded
    try:
        yield seen
    finally:
        cuda_blend.launch = launch


def ladder_path(dev, warp_mod, cuda_warp, cuda_blend, checked_records):
    """Phase 11: the paper model's family at full width (see the module
    docstring).  `checked_records` are phase 3's K1 records.  Returns the
    per-configuration records, K1's records at the new shapes and both
    kernels' largest errors."""
    from rife_tpu_torch.engine import (InferenceEngine, load_checkpoint,
                                       state_dict_from_jax)
    from rife_tpu_torch.ops import pad_to_multiple

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    records = [time_fwd_launch(warp_mod, dev, gen, name, 2 * BATCH, c, h, w)
               for name, c, h, w in LADDER_WARPS]
    worst = max(r["max_abs_err"] for r in records)
    x = blend_inputs(BATCH, 3, 768, 1280, gen, dev, torch.bfloat16, torch.bfloat16)
    worst_blend = check_blend(warp_mod, *x, True, "scale 0.5 final level, with the pair "
                              f"{tuple(x[0].shape)} bf16")
    checked = {tuple(r["img"]): r for r in checked_records + records}
    weights = {"rife": state_dict_from_jax(load_checkpoint(CKPT)[1]),
               "rife_m": family_state_dict("rife_m"), "rife_2r": family_state_dict("rife_2r")}
    a_np, b_np = smooth_pair(BATCH, FRAME_H, FRAME_W, PAN)
    padded = {}
    sa, sb = smooth_pair(2, 128, 192, 6, seed=13)
    rec, outs = {}, {}
    for label, model, rung, scale, t, tta, k1, pair in LADDER_CONFIGS:
        sd = weights[model]
        eng = InferenceEngine(model, sd, compute_dtype=torch.bfloat16, fast=rung,
                              scale=scale, device=dev)
        m = eng.pad_multiple
        if m not in padded:
            pa, pad = pad_to_multiple(torch.from_numpy(a_np), m)
            padded[m] = (pa.to(dev), pad_to_multiple(torch.from_numpy(b_np), m)[0].to(dev),
                         pad)
        a, b, pad = padded[m]
        with recorded_launches(cuda_warp) as seen:  # the warm-up request
            eng.interpolate(a, b, t, tta)
            torch.cuda.synchronize()
        shapes = [s[:4] for s in seen["fwd"]]
        unchecked = sorted(set(shapes) - set(checked))
        if unchecked:
            raise AssertionError(f"{label}: K1 launches at shapes no check covered: "
                                 f"{unchecked}")
        times = 2 if tta else 1
        reset_counts(warp_mod)
        with recorded_blend(cuda_blend) as forms:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LADDER_REQUESTS):
                out = eng.interpolate(a, b, t, tta)
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / LADDER_REQUESTS * 1e3
        counts = read_counts(warp_mod)
        k1_last, k2 = final_launches(warp_mod)
        check_counts(counts, LADDER_REQUESTS, times * (k1 + k1_last), times * k2, label)
        forms = [f[-1] for f in forms]
        if forms != [pair] * (LADDER_REQUESTS * times * k2):
            raise AssertionError(f"{label}: K2 forms {forms}, expected "
                                 f"{'the pair' if pair else 'blend only'}")
        check_frame(out, a.shape, label)
        ms = events_ms(eng, a, b, LADDER_REQUESTS, t, tta)
        eng32 = InferenceEngine(model, sd, compute_dtype=torch.float32, fast=rung,
                                scale=scale, device=dev)
        quality = psnr(pad.crop(out).float(), pad.crop(eng32.interpolate(a, b, t, tta)))
        on_card = eng32.interpolate(sa, sb, t, tta).cpu()
        on_cpu = InferenceEngine(model, sd, fast=rung, scale=scale,
                                 device="cpu").interpolate(sa, sb, t, tta)
        diff = float((on_card - on_cpu).abs().max())
        r = {"model": model, "rung": rung, "scale": scale, "timestep": t, "tta": tta,
             "scale_list": list(eng.scale_list), "pair": [int(a.shape[1]), int(a.shape[2])],
             "launches": counts, "k1_per_forward": k1, "k2_per_forward": k2,
             "k2_form": "pair" if pair else "blend only",
             "k1_launch_shapes": [list(s) for s in shapes],
             "k1_ms_per_forward": sum(checked[s]["ms"] for s in shapes) / times,
             "k1_bound_ms_per_forward": sum(checked[s]["bound_ms"] for s in shapes) / times,
             "ms_per_request": ms, "host_ms_per_request": host_ms,
             "frames_per_s": BATCH * 1e3 / ms, "psnr_bf16_vs_f32_db": quality,
             "f32_card_vs_cpu_max_abs": diff}
        if model != "rife":
            _, flow = eng.forward(a, b, t, with_flow=True)
            r["max_abs_flow_px"] = float(flow.float().abs().max())
            if not r["max_abs_flow_px"] > 2.0:
                raise AssertionError(f"{label}: flows under 2 px leave the warps idle")
        log(f"  {label} ({tuple(a.shape)}, scale list {eng.scale_list}): {ms:.2f} "
            f"ms/request (host {host_ms:.2f}), {BATCH * 1e3 / ms:.2f} frames/s; "
            f"K1 {times * k1} + K2 {times * k2} ({r['k2_form']}) a request; bf16 vs f32 "
            f"{quality:.2f} dB (>= 40); f32 card vs CPU at 128x192 {diff:.3g} (<= 2e-4)"
            + (f"; max |flow| {r['max_abs_flow_px']:.1f} px" if model != "rife" else ""))
        if not quality >= 40.0:
            raise AssertionError(f"{label}: bf16 at {quality:.2f} dB against f32")
        if not diff <= 2e-4:
            raise AssertionError(f"{label}: the card's f32 result disagrees with the CPU path")
        rec[label], outs[label] = r, out
        del eng, eng32
    moved = float((outs["rife_m t=0.25"].float() - outs["rife_m t=0.5"].float()).abs().mean())
    log(f"  rife_m t=0.25 vs t=0.5: mean |diff| = {moved:.4g} (> 0)")
    if not moved > 0:
        raise AssertionError("rife_m: the timestep does not reach the model")
    rec["rife_m_t0.25_vs_t0.5_mean_abs"] = moved
    del outs, padded, weights
    torch.cuda.empty_cache()
    return rec, records, worst, worst_blend


def protocol_path(dev, warp_mod):
    """Phase 12: the r5 checkpoint through the port's Vimeo90K protocol on
    the card, over r4's fixture in memory, in the nine configurations of
    tools/port_eval_checkpoint.py; the f32 rows in PROTOCOL_GATED against
    the committed CPU rows, every row beside them and the TPU's JSON."""
    from tools.port_eval_checkpoint import CONFIGS, fixture, port_rows

    with open(os.path.join(ROOT, "rife_tpu_torch", "tools", "eval_r5_cpu.json")) as f:
        cpu = json.load(f)
    with open(os.path.join(ROOT, "train_log_r5", "eval_protocol.json")) as f:
        tpu = json.load(f)
    n = cpu["fixture"]["n"]
    triplets = fixture(n, cpu["fixture"]["seed"])
    k1_of_rung = {c[2]: c[6] for c in LADDER_CONFIGS[:5]}  # rife, rungs 0-4
    k1_last, k2 = final_launches(warp_mod)
    reset_counts(warp_mod)
    rows = port_rows(CKPT, triplets, [c[0] for c in CONFIGS], device=dev, log=log)
    counts = read_counts(warp_mod)
    check_counts(counts, n, sum(k1_of_rung[r] + k1_last for _, _, r in CONFIGS),
                 k2 * len(CONFIGS), "protocol")
    failed = []
    for label, row in rows.items():
        c, t = cpu["port"][label], tpu.get(label)
        row["cpu"] = c
        row["rife_tpu_cpu"] = cpu.get("reference_cpu", {}).get(label)
        row["tpu_json"] = None if t is None else {"psnr": t["psnr"], "ssim": t["ssim"]}
        d = {k: row[k] - c[k] for k in ("psnr", "ssim")}
        gated = label in PROTOCOL_GATED
        if gated and not all(abs(d[k]) <= PROTOCOL_TOL[k] for k in d):
            failed.append(label)
        log(f"  {label}: card {row['psnr']:.4f} dB / {row['ssim']:.6f}, CPU "
            f"{c['psnr']:.4f} / {c['ssim']:.6f} ({d['psnr']:+.4f} dB, {d['ssim']:+.2e}"
            f"{'; gate 0.02 dB, 1e-4' if gated else ', not gated'}), TPU JSON "
            + ("none" if t is None else f"{t['psnr']:.4f} / {t['ssim']:.6f}"))
    if failed:
        raise AssertionError(f"protocol rows off the committed CPU rows: {failed}")
    return {"rows": rows, "launches": counts, "triplets": n}


class ListReader:
    """An in-memory video: frames, fps and size, as the readers give them."""

    def __init__(self, frames, fps=25.0):
        self.frames, self.fps = frames, fps
        self.height, self.width = frames[0].shape[:2]
        self.frame_count = len(frames)

    def __iter__(self):
        return iter(self.frames)


class ListWriter:
    def __init__(self):
        self.frames = []

    def write(self, f):
        self.frames.append(f)

    def close(self):
        pass


class RecordingEngine:
    """An engine whose `interpolate` calls are kept (inputs, timestep and
    output) and whose host seconds in them are summed: the time the main
    thread spends queuing forwards (the pipeline reads the rest through
    to the engine)."""

    def __init__(self, eng):
        self.eng, self.calls, self.host_s = eng, [], 0.0

    def __getattr__(self, name):
        return getattr(self.eng, name)

    def interpolate(self, a, b, t=0.5, tta=False):
        t0 = time.perf_counter()
        out = self.eng.interpolate(a, b, t, tta)
        self.host_s += time.perf_counter() - t0
        self.calls.append((a, b, t, out))
        return out


def video_clip(n, h, w, pan, seed=7):
    """`n` u8 frames of smooth content (smooth_pair's recipe) panned `pan`
    px a frame to the left, HWC RGB."""
    rng = np.random.default_rng(seed)
    m = 128
    base = rng.random((h + 2 * m, w + 2 * m + n * pan, 3)).astype(np.float32)
    for _ in range(3):
        base = (base + np.roll(base, 1, 0) + np.roll(base, 1, 1)
                + np.roll(base, 2, 0) + np.roll(base, 2, 1)) / 5
    u8 = (np.clip(base, 0, 1) * 255 + 0.5).astype(np.uint8)
    return [np.ascontiguousarray(u8[m:m + h, m + i * pan:m + i * pan + w]) for i in range(n)]


def gated_clip():
    """VIDEO_FRAMES frames: the panned clip with an exact duplicate after
    its middle frame and its last frame inverted (1 static pair, 1 scene
    cut, every other pair's probe SSIM far from both gates)."""
    clip = video_clip(VIDEO_FRAMES - 1, FRAME_H, FRAME_W, VIDEO_PAN)
    mid = len(clip) // 2
    clip = clip[:mid + 1] + [clip[mid].copy()] + clip[mid + 1:]
    clip[-1] = 255 - clip[-1]
    return clip


def native_checks() -> dict:
    """Phase 13, step 1: the frame-ops binding built with g++ on this
    machine against its numpy versions on a 720p frame."""
    from rife_tpu_torch import native

    if not native.have_native():
        raise AssertionError("the native frame ops did not build (no g++?)")
    rng = np.random.default_rng(9)
    u8 = rng.integers(0, 256, (FRAME_H, FRAME_W, 3), dtype=np.uint8)
    ph = -(-FRAME_H // 32) * 32
    got, want = native.u8_to_f32_pad(u8, ph, FRAME_W), native.u8_to_f32_pad_ref(u8, ph, FRAME_W)
    ulps = int((np.abs(got - want) / np.spacing(np.maximum(np.abs(want), 1e-30))).max())
    f32 = (rng.standard_normal((ph, FRAME_W, 3)) * 0.6 + 0.5).astype(np.float32)
    crop_equal = bool(np.array_equal(native.f32_to_u8_crop(f32, FRAME_H, FRAME_W),
                                     native.f32_to_u8_crop_ref(f32, FRAME_H, FRAME_W)))
    y = rng.integers(0, 256, (FRAME_H, FRAME_W), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (FRAME_H // 2, FRAME_W // 2), dtype=np.uint8)
            for _ in range(2))
    yuv_equal = bool(np.array_equal(native.yuv420_to_rgb(y, u, v),
                                    native.yuv420_to_rgb_ref(y, u, v)))
    log(f"  native frame ops (g++): u8_to_f32_pad within {ulps} ulp of numpy (<= 1), "
        f"f32_to_u8_crop equal {crop_equal}, yuv420_to_rgb equal {yuv_equal}")
    if ulps > 1 or not crop_equal or not yuv_equal:
        raise AssertionError("the native frame ops disagree with their numpy versions")
    return {"have_native": True, "u8_to_f32_pad_max_ulp": ulps,
            "f32_to_u8_crop_equal": crop_equal, "yuv420_to_rgb_equal": yuv_equal}


def run_video(eng, frames, warp_mod, label, forwards, k1, k2, expect, **job):
    """One interpolate_video run through the in-memory reader and writer,
    the launches counted from 0: (stats, written frames, recorded calls)."""
    from rife_tpu_torch.video import VideoJob, interpolate_video

    rec, writer = RecordingEngine(eng), ListWriter()
    reset_counts(warp_mod)
    stats = interpolate_video(rec, ListReader(frames), writer, VideoJob(**job))
    torch.cuda.synchronize()
    counts = read_counts(warp_mod)
    got = tuple(stats[k] for k in ("frames_in", "frames_out", "static", "scene_cut"))
    stats["dispatch_s"] = rec.host_s
    log(f"  {label}: {len(rec.calls)} forwards, stats {stats}; launches {counts}")
    if got != expect:
        raise AssertionError(f"{label}: (in, out, static, cut) {got}, expected {expect}")
    if len(rec.calls) != forwards or len(writer.frames) != stats["frames_out"]:
        raise AssertionError(f"{label}: {len(rec.calls)} forwards, expected {forwards}")
    check_counts(counts, forwards, k1, k2, label)
    return stats, writer.frames, rec.calls, counts


def video_path(dev, warp_mod) -> dict:
    """Phase 13: the frame ops, the streaming pipeline at 2X and 4X, the
    checkpoints' .pkl route and the CLIs (see the module docstring)."""
    from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.ops.pad import plan_pad_to_multiple
    from rife_tpu_torch.video import pipeline as pl

    rec = {"native": native_checks()}
    t0 = time.perf_counter()
    clip = gated_clip()
    log(f"  a clip of {len(clip)} {FRAME_H}x{FRAME_W} u8 frames ready in "
        f"{time.perf_counter() - t0:.2f} s")
    sd = state_dict_from_jax(load_checkpoint(CKPT)[1])
    eng = InferenceEngine("rife", sd, compute_dtype=torch.bfloat16, fast=1, device=dev)
    pad = plan_pad_to_multiple(FRAME_H, FRAME_W, eng.pad_multiple)
    padded = (1, pad.padded_h, pad.padded_w, 3)
    eng.warmup((VIDEO_BATCH,) + padded[1:])
    eng.warmup(padded)
    k1_last, k2 = final_launches(warp_mod)
    k1 = LAUNCHES_PER_FORWARD + k1_last
    n = len(clip)
    gaps = n - 1  # one of them the scene cut, one the static pair's replacement
    batches = -(-(gaps - 1) // VIDEO_BATCH)
    expect2 = (n, 2 * n - 1, 1, 1)

    # 2X, checked: cuDNN's deterministic algorithms, so a second call on the
    # same inputs gives the same bits.
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        stats, frames, calls, counts = run_video(
            eng, clip, warp_mod, "2X, batch 4 (checked)", batches + 1, k1, k2, expect2, exp=1)
        shapes = [tuple(c[0].shape[:1]) for c in calls]
        if sorted(shapes) != [(1,)] + [(VIDEO_BATCH,)] * batches:
            raise AssertionError(f"2X: forwards of batch {shapes}")
        batched = [c for c in calls if c[0].shape[0] == VIDEO_BATCH]
        differ = sum(int((c[3] != eng.interpolate(c[0], c[1])).sum()) for c in batched)
        mids = np.concatenate([pl.post(c[3], pad) for c in batched])[:gaps - 1]
        written = np.stack(frames[1:2 * (gaps - 1):2])
        wrong = int((mids != written).any(axis=(1, 2, 3)).sum())
    finally:
        torch.backends.cudnn.deterministic = saved
    log(f"  2X: every batched midpoint against a direct engine call on the same stacked "
        f"pairs: {differ} elements differ (0); {wrong} of {len(written)} written "
        f"midpoints differ from them (0)")
    if differ or wrong:
        raise AssertionError("2X: the pipeline's midpoints are not the engine's")
    rec["2x_checked"] = {"stats": stats, "launches": counts, "forwards": len(calls),
                         "batched_elements_differing": differ, "written_differing": wrong}

    # 2X, timed (cuDNN's default algorithms), beside the engine alone.
    stats, _, calls, counts = run_video(eng, clip, warp_mod, "2X, batch 4 (timed)",
                                        batches + 1, k1, k2, expect2, exp=1)
    a4 = torch.zeros((VIDEO_BATCH,) + padded[1:], dtype=torch.bfloat16, device=dev)
    eng_ms = events_ms(eng, a4, a4, VIDEO_EVENT_REQUESTS)
    eng1_ms = events_ms(eng, a4[:1], a4[:1], VIDEO_EVENT_REQUESTS)
    device_s = (batches * eng_ms + eng1_ms) / 1e3
    rec["2x"] = {
        "stats": stats, "launches": counts, "forwards": len(calls),
        "engine_ms_batch4": eng_ms, "engine_ms_batch1": eng1_ms,
        "engine_alone_mids_per_s": VIDEO_BATCH * 1e3 / eng_ms,
        "engine_alone_fps_out": 2 * VIDEO_BATCH * 1e3 / eng_ms,
        "clip_forwards_device_s": device_s,
        "fps_out_if_device_bound": stats["frames_out"] / device_s}
    log(f"  2X: pipeline {stats['fps_out']:.2f} frames out/s over {stats['seconds']:.3f} s "
        f"(host: upload {stats['upload_s']:.3f} s, probe {stats['probe_s']:.3f} s, queuing "
        f"the forwards {stats['dispatch_s']:.3f} s, the writer's fetch "
        f"{stats['fetch_s']:.3f} s); the engine alone (CUDA events): "
        f"{eng_ms:.2f} ms a batch-4 forward, {eng1_ms:.2f} ms batch 1, so "
        f"{rec['2x']['engine_alone_fps_out']:.1f} frames out/s at 2X, "
        f"{rec['2x']['fps_out_if_device_bound']:.1f} for this clip's forwards")

    # 4X: the midpoint tree at batch 1 (3 forwards a gap, 1 for the static pair).
    stats, _, calls, counts = run_video(eng, clip, warp_mod, "4X, midpoint tree",
                                        3 * (gaps - 1) + 1, k1, k2,
                                        (n, n + 3 * gaps, 1, 1), exp=2)
    rec["4x"] = {"stats": stats, "launches": counts, "forwards": len(calls)}
    del eng

    # 4X by timestep with v4.25 (768x1280): t = 1/4, 2/4, 3/4 a gap.
    name, tree = load_checkpoint(CKPT_V425)
    eng = InferenceEngine("v4.25", state_dict_from_jax(tree), compute_dtype=torch.bfloat16,
                          fast=1, device=dev)
    short = video_clip(V425_VIDEO_FRAMES, FRAME_H, FRAME_W, VIDEO_PAN, seed=8)
    g = len(short) - 1
    p64 = plan_pad_to_multiple(FRAME_H, FRAME_W, eng.pad_multiple)
    eng.warmup((1, p64.padded_h, p64.padded_w, 3))
    stats, frames, calls, counts = run_video(
        eng, short, warp_mod, "v4.25 4X by timestep", 3 * g, 4 + k1_last, k2,
        (len(short), len(short) + 3 * g, 0, 0), exp=2, use_timestep=True)
    ts = [float(c[2]) for c in calls]
    if ts != [0.25, 0.5, 0.75] * g or \
            tuple(calls[0][0].shape) != (1, p64.padded_h, p64.padded_w, 3):
        raise AssertionError(f"v4.25: timesteps {ts[:6]}..., input {tuple(calls[0][0].shape)}")
    if not all(f.shape == (FRAME_H, FRAME_W, 3) for f in frames):
        raise AssertionError("v4.25: written frames of another size")
    rec["v425_4x"] = {"stats": stats, "launches": counts, "forwards": len(calls),
                      "input": list(calls[0][0].shape)}
    del eng, calls
    torch.cuda.empty_cache()
    rec["checkpoints"] = checkpoint_checks(dev, sd)
    rec["file_io"] = file_io_checks(dev, warp_mod, clip)
    return rec


def checkpoint_checks(dev, sd) -> dict:
    """Phase 13, step 5: r5 exported to a reference .pkl, loaded back into
    an engine whose output equals the .rtpu engine's; convert .rtpu ->
    .pkl -> .rtpu with equal tensors."""
    from rife_tpu_torch.cli import convert
    from rife_tpu_torch.engine import InferenceEngine, load_checkpoint, state_dict_from_jax
    from rife_tpu_torch.models.torch_export import export_ifnet, save_torch_pickle
    from rife_tpu_torch.ops import pad_to_multiple

    work = os.path.join(ROOT, "build", "chip_smoke_video")
    os.makedirs(work, exist_ok=True)
    name, tree = load_checkpoint(CKPT)
    pkl = os.path.join(work, "flownet.pkl")
    save_torch_pickle(pkl, export_ifnet(tree))
    pname, ptree = load_checkpoint(pkl)
    a, b = (pad_to_multiple(torch.from_numpy(x), 32)[0]
            for x in smooth_pair(BATCH, FRAME_H, FRAME_W, PAN))
    outs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for params in (sd, state_dict_from_jax(ptree, model=pname)):
            eng = InferenceEngine(pname, params, compute_dtype=torch.bfloat16, fast=1,
                                  device=dev)
            outs.append(eng.interpolate(a, b))
            del eng
    finally:
        torch.backends.cudnn.deterministic = saved
    differ = int((outs[0] != outs[1]).sum())
    back = os.path.join(work, "back.rtpu")
    convert.main(["--input", CKPT, "--output", os.path.join(work, "r5.pkl"), "--to", "torch"])
    convert.main(["--input", os.path.join(work, "r5.pkl"), "--output", back])
    bname, btree = load_checkpoint(back)
    want, got = state_dict_from_jax(tree), state_dict_from_jax(btree)
    unequal = [k for k in want if k not in got or not torch.equal(want[k], got[k])]
    unequal += sorted(set(got) - set(want))
    log(f"  checkpoints: r5 -> .pkl -> {pname!r} engine vs the .rtpu engine, one request: "
        f"{differ} elements differ (0); convert .rtpu -> .pkl -> .rtpu: {len(got)} tensors, "
        f"{len(unequal)} unequal (0), model {bname!r}")
    shutil.rmtree(work)
    if pname != "rife" or bname != "rife" or differ or unequal:
        raise AssertionError("the .pkl route does not give back the r5 weights")
    return {"pkl_engine_elements_differing": differ, "convert_tensors": len(got),
            "convert_unequal": unequal}


def file_io_checks(dev, warp_mod, clip) -> dict:
    """Phase 13, step 6: the CLIs and the disk interpolator through real
    files, where the host has cv2 (decided up front, not by an error)."""
    import importlib.util

    have_cv2 = importlib.util.find_spec("cv2") is not None
    have_ffmpeg = shutil.which("ffmpeg") is not None
    log(f"  cv2 {'found' if have_cv2 else 'not found'}, ffmpeg "
        f"{'found' if have_ffmpeg else 'not found'} on the host")
    rec = {"cv2": have_cv2, "ffmpeg": have_ffmpeg}
    if not have_cv2:
        log("  file IO (interp_img, interp_video --png, DiskInterpolator) skipped: no cv2")
        return rec
    import cv2

    from rife_tpu_torch.cli import interp_img, interp_video
    from rife_tpu_torch.engine import DiskInterpolator

    work = os.path.join(ROOT, "build", "chip_smoke_video")
    frames_dir, out_dir = os.path.join(work, "frames"), os.path.join(work, "out")
    os.makedirs(frames_dir, exist_ok=True)
    for i, f in enumerate(clip[:VIDEO_IO_FRAMES]):
        cv2.imwrite(os.path.join(frames_dir, f"{i:04d}.png"), f[..., ::-1])
    model_dir = os.path.dirname(CKPT)
    t0 = time.perf_counter()
    reset_counts(warp_mod)
    interp_img.main(["--img", os.path.join(frames_dir, "0000.png"),
                     os.path.join(frames_dir, "0001.png"), "--exp", "2", "--modelDir",
                     model_dir, "--output", os.path.join(out_dir, "img")])
    names = sorted(os.listdir(os.path.join(out_dir, "img")))
    shapes = {cv2.imread(os.path.join(out_dir, "img", f)).shape for f in names}
    counts = read_counts(warp_mod)
    log(f"  interp_img --exp 2 (f32, 720p): {names} {shapes} in "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    if names != [f"img{i}.png" for i in range(5)] or shapes != {(FRAME_H, FRAME_W, 3)}:
        raise AssertionError("interp_img wrote other frames")
    k1_last, k2 = final_launches(warp_mod)
    check_counts(counts, 3, LAUNCHES_PER_FORWARD + k1_last, k2, "interp_img (rung 0)")
    rec["interp_img"] = {"frames": len(names), "launches": counts}

    t0 = time.perf_counter()
    reset_counts(warp_mod)
    interp_video.main(["--img", frames_dir, "--png", "--output", os.path.join(out_dir, "vid"),
                       "--modelDir", model_dir])
    n = len(os.listdir(os.path.join(out_dir, "vid")))
    counts = read_counts(warp_mod)
    log(f"  interp_video --img ({VIDEO_IO_FRAMES} frames) --png: {n} frames in "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    if n != 2 * VIDEO_IO_FRAMES - 1:
        raise AssertionError(f"interp_video wrote {n} frames")
    check_counts(counts, -(-(VIDEO_IO_FRAMES - 1) // VIDEO_BATCH),
                 LAUNCHES_PER_FORWARD + k1_last, k2, "interp_video (bf16, rung 1)")
    rec["interp_video"] = {"frames": n, "launches": counts}

    t0 = time.perf_counter()
    from rife_tpu_torch.native import u8_to_f32
    from rife_tpu_torch.engine import build_engine

    eng = build_engine(CKPT, None, device=dev)
    ph = -(-FRAME_H // eng.pad_multiple) * eng.pad_multiple
    three = [u8_to_f32(np.pad(f, ((0, ph - FRAME_H), (0, 0), (0, 0)))) for f in clip[:3]]
    di = DiskInterpolator(eng, os.path.join(work, "disk"))
    reset_counts(warp_mod)
    out = di.interpolate(three, 9)
    counts = read_counts(warp_mod)
    log(f"  DiskInterpolator (f32, rung 0) 3 -> {len(out)} frames ({out[0].shape}) in "
        f"{time.perf_counter() - t0:.2f} s; launches {counts}")
    if len(out) != 9 or out[0].shape != (ph, FRAME_W, 3):
        raise AssertionError("DiskInterpolator gave other frames")
    check_counts(counts, 2 + 4, LAUNCHES_PER_FORWARD + k1_last, k2, "DiskInterpolator")
    rec["disk_interpolator"] = {"frames": len(out), "launches": counts}
    shutil.rmtree(work)
    return rec

@contextlib.contextmanager
def no_plain_on_the_card(warp_mod):
    """Inside: a CUDA tensor reaching a warp's plain version raises (the
    served path must launch the kernels)."""
    names = ("warp_planes_ref", "warp2_blend_planes_ref", "warp_planes_bwd_ref", "warp_ref")
    saved = {n: getattr(warp_mod, n) for n in names}

    def guard(name, fn):
        def call(*args, **kw):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                raise AssertionError(f"a CUDA tensor reached {name} on the served path")
            return fn(*args, **kw)
        return call

    for n, fn in saved.items():
        setattr(warp_mod, n, guard(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(warp_mod, n, fn)


@contextlib.contextmanager
def recorded_k1_k2(cuda_warp, cuda_blend):
    """Inside: the launch keys of K1 ("k1", N, C, H, W, image dtype, flow
    dtype) and K2 ("k2", N, C, H, W, image dtype, flow dtype, mask dtype,
    pair), from `recorded_launches` and `recorded_blend`, in the yielded
    list once the block ends."""
    keys = []
    with recorded_launches(cuda_warp) as k1, recorded_blend(cuda_blend) as k2:
        try:
            yield keys
        finally:
            keys += [("k1", *k[:6]) for k in k1["fwd"]] + [("k2", *k) for k in k2]


def check_launch_keys(warp_mod, dev, keys, timed, label) -> dict:
    """Each distinct launch key (`recorded_k1_k2`) held against its plain
    version on seeded inputs of its shape and dtypes; the keys in `timed`
    also timed beside their bounds (`time_fwd_launch`,
    `time_blend_launch`).  -> {"k1": [records], "k2": [records],
    "k1_err", "k2_err", "checked": n}."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    out = {"k1": [], "k2": [], "k1_err": 0.0, "k2_err": 0.0}
    distinct = sorted(set(keys), key=str)
    for key in distinct:
        n, c, h, w = key[1:5]
        name = f"{label}: {timed[key]}" if key in timed else label
        if key[0] == "k1":
            idt, fdt = key[5:]
            if key in timed:
                r = time_fwd_launch(warp_mod, dev, gen, name, n, c, h, w, idt, fdt)
                out["k1"].append(r)
                e = r["max_abs_err"]
            else:
                img = (torch.rand(n, c, h, w, device=dev, generator=gen) if c <= 3 else
                       torch.randn(n, c, h, w, device=dev, generator=gen) * 3).to(idt)
                flow = smooth_flow(n, h, w, 8.0 * w / 1280, gen, dev, fdt)
                e = check_fwd(warp_mod, img, flow,
                              f"{name} {tuple(img.shape)} {dtypes_label(img, flow)}")
            out["k1_err"] = max(out["k1_err"], e)
        else:
            idt, fdt, mdt, pair = key[5:]
            if mdt != fdt:
                raise AssertionError(f"{label}: K2 with a {mdt} mask and a {fdt} flow")
            if key in timed:
                r = time_blend_launch(warp_mod, dev, gen, name, n, c, h, w, pair, idt, fdt)
                out["k2"].append(r)
                e = r["max_abs_err"]
            else:
                x = blend_inputs(n, c, h, w, gen, dev, idt, fdt)
                e = check_blend(warp_mod, *x, pair, f"{name} {tuple(x[0].shape)} "
                                f"{dtypes_label(x[0], x[2])}")
            out["k2_err"] = max(out["k2_err"], e)
    out["checked"] = len(distinct)
    return out


def launch_name(key) -> str:
    n, c, h, w = key[1:5]
    if key[0] == "k2":
        return f"K2 {'pair' if key[-1] else 'blend only'} {h}x{w} N={n}"
    return f"K1 C={c} {h}x{w} N={n}"


class Http:
    """Requests to the port's JSON API on 127.0.0.1 (each with a time limit)."""

    def __init__(self, port, auth=None):
        self.base, self.auth = f"http://127.0.0.1:{port}", auth

    def __call__(self, path, body=None, auth=True):
        import base64
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.base + path, method="GET" if body is None else "POST",
            data=None if body is None else json.dumps(body).encode())
        if auth and self.auth:
            req.add_header("Authorization",
                           "Basic " + base64.b64encode(self.auth.encode()).decode())
        try:
            with urllib.request.urlopen(req, timeout=SERVE_REQUEST_TIMEOUT_S) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            data = e.read()
            return e.code, (json.loads(data) if data else None)


@contextlib.contextmanager
def http_server(app, eng, **kw):
    """The port's HTTP API on a free port of 127.0.0.1, served by a thread;
    shut down, closed and joined on exit."""
    import threading

    httpd = app.make_http_server(eng, "127.0.0.1", 0, **kw)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(60)
        if t.is_alive():
            raise RuntimeError("the HTTP server's thread did not stop")


@contextlib.contextmanager
def staged(services, imageio):
    """Inside: a pair request's host seconds by stage (utils.profiling.
    StageTimer): reading the PNGs, queuing the forwards (`exp_doubling`),
    fetching each cropped frame (which waits for the device) and encoding
    (rounding to u8, the cv2 writer, the colr atom)."""
    from rife_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    names = ((imageio, "read_image", "read PNGs"), (services, "exp_doubling", "queue forwards"),
             (services, "_fetch", "fetch frames"), (services, "_encode_frames", "encode"))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in names]

    def timed(fn, stage):
        def call(*a, **kw):
            with timer.stage(stage):
                return fn(*a, **kw)
        return call

    for (mod, attr, stage), (_, _, fn) in zip(names, saved):
        setattr(mod, attr, timed(fn, stage))
    try:
        yield timer
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def write_mp4(path, frames, fps):
    import cv2

    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def mp4_frames(path) -> int:
    import cv2

    cap, n = cv2.VideoCapture(path), 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def serve_path(dev, warp_mod, cuda_warp, cuda_blend) -> dict:
    """Phase 14: the serving app over HTTP (see the module docstring)."""
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        return _serve(dev, warp_mod, cuda_warp, cuda_blend, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _serve(dev, warp_mod, cuda_warp, cuda_blend, work) -> dict:
    import threading

    import cv2

    from rife_tpu_torch.engine import (DiskInterpolator, exp_doubling, load_checkpoint,
                                       state_dict_from_jax)
    from rife_tpu_torch.ops import pad_centered, plan_pad_centered
    from rife_tpu_torch.serve import app, config, services
    from rife_tpu_torch.utils import imageio
    from rife_tpu_torch.utils.imageio import read_image
    from rife_tpu_torch.utils.memory import MemoryMonitor
    from rife_tpu_torch.video import have_ffmpeg
    from rife_tpu_torch.video.mp4meta import read_colr

    mon = MemoryMonitor(dev)
    up, outd = os.path.join(work, "uploads"), os.path.join(work, "outputs")
    os.makedirs(up)
    os.makedirs(outd)
    a, b = smooth_pair(1, FRAME_H, FRAME_W, PAN)
    for name, img in (("i0.png", a[0]), ("i1.png", b[0])):
        cv2.imwrite(os.path.join(up, name), (np.clip(img, 0, 1) * 255 + 0.5).astype(
            np.uint8)[..., ::-1])
    clip = os.path.join(up, "clip.mp4")
    write_mp4(clip, video_clip(SERVE_CLIP_FRAMES, FRAME_H, FRAME_W, VIDEO_PAN), 25)
    chain = [os.path.join(up, f"chain{fps}.mp4") for fps in (25, 30)]
    for path, fps, seed in zip(chain, (25, 30), (11, 12)):
        write_mp4(path, video_clip(CHAIN_FRAMES, FRAME_H, FRAME_W, VIDEO_PAN, seed=seed), fps)
    log(f"  inputs: a {FRAME_H}x{FRAME_W} PNG pair (pan {PAN}), a {SERVE_CLIP_FRAMES}-frame "
        f"mp4v clip, two {CHAIN_FRAMES}-frame clips at 25 and 30 fps; ffmpeg "
        f"{'found' if have_ffmpeg() else 'not found'}, ffprobe "
        f"{'found' if shutil.which('ffprobe') else 'not found'}")
    torch.cuda.reset_peak_memory_stats(dev)  # the peak below is this phase's
    snap0 = mon.snapshot("serve: before load_engine")

    eng = app.load_engine(os.path.dirname(CKPT), device=dev)
    sd = state_dict_from_jax(load_checkpoint(CKPT)[1])
    key = "block0.lastconv.weight" if "block0.lastconv.weight" in sd else next(iter(sd))
    same = torch.equal(eng.model.state_dict()[key].cpu(), sd[key].to(torch.bfloat16))
    log(f"  load_engine: {eng.model_name}, {eng.compute_dtype}, rung {config.FAST_MODE} "
        f"(fast_level0 {eng.model_def.config.fast_level0}), {key} equal to the r5 "
        f"checkpoint's (bf16): {same}")
    if not (eng.model_name == "rife" and eng.compute_dtype == torch.bfloat16 and same
            and config.FAST_MODE == 1 and eng.model_def.config.fast_level0):
        raise AssertionError("load_engine did not give the r5 serving engine")
    app_pad = plan_pad_centered(FRAME_H, FRAME_W)  # the app's contract: %32, >= 512
    padded = (1, app_pad.padded_h, app_pad.padded_w, 3)
    eng.warmup(padded)

    encoded, lock = {}, threading.Lock()
    real_encode = services._encode_frames

    def encode(frames, out_path, fps):
        with lock:
            encoded[out_path] = [np.array(f, np.float32) for f in frames]
        return real_encode(frames, out_path, fps)

    recs, totals = {}, dict.fromkeys(_counted(warp_mod), 0)
    saved_det = torch.backends.cudnn.deterministic
    services._encode_frames = encode
    try:
        with recorded_k1_k2(cuda_warp, cuda_blend) as keys, no_plain_on_the_card(warp_mod), \
                http_server(app, eng, upload_dir=up, output_dir=outd) as port:
            api = Http(port)

            k1_last, k2_final = final_launches(warp_mod)

            def request(label, path, body, forwards, k1=None, k2=None, frames=None):
                reset_counts(warp_mod)
                t0 = time.perf_counter()
                code, r = api(path, body)
                dt = time.perf_counter() - t0
                counts = read_counts(warp_mod)
                if code != 200:
                    raise AssertionError(f"{label}: HTTP {code} {r}")
                n = r.get("frames", r.get("frames_out"))
                log(f"  {label}: {dt:.3f} s host, {n} frames"
                    + (f" ({n / dt:.2f} frames out/s)" if n else "") + f"; launches {counts}")
                if frames is not None and n != frames:
                    raise AssertionError(f"{label}: {n} frames, expected {frames}")
                if forwards is not None:
                    check_counts(counts, forwards,
                                 LAUNCHES_PER_FORWARD + k1_last if k1 is None else k1,
                                 k2_final if k2 is None else k2, label)
                for k, v in counts.items():
                    totals[k] += v
                recs[label] = {"seconds": dt, "frames": n, "launches": counts,
                               "frames_out_per_s": n / dt if n else None, "response": r}
                return r

            code, health = api("/health")
            log(f"  /health: {code} {health}")
            if (code, health.get("status")) != (200, "ok"):
                raise AssertionError(f"/health: {code} {health}")
            pair = {"img0_path": os.path.join(up, "i0.png"),
                    "img1_path": os.path.join(up, "i1.png"), "passes": SERVE_PASSES}
            rev = {**pair, "img0_path": pair["img1_path"], "img1_path": pair["img0_path"]}
            n_out, fwd = (1 << SERVE_PASSES) + 1, (1 << SERVE_PASSES) - 1

            torch.backends.cudnn.deterministic = True
            out_a = os.path.join(outd, "pair.mp4")
            request("pair (checked)", "/interpolate_pair", {**pair, "out": out_a}, fwd,
                    frames=n_out)
            img0, img1 = (read_image(p)[0] for p in (pair["img0_path"], pair["img1_path"]))
            pa, pad = pad_centered(torch.from_numpy(img0[None]).to(dev), 32, 512)
            pb, _ = pad_centered(torch.from_numpy(img1[None]).to(dev), 32, 512)
            if tuple(pa.shape) != padded:
                raise AssertionError(f"the app padded to {tuple(pa.shape)}")
            want = [pad.crop(f)[0].float().cpu().numpy()
                    for f in exp_doubling(eng, [pa, pb], SERVE_PASSES)]
            differ = [int((g != w).sum()) for g, w in zip(encoded[out_a], want)]
            log(f"  pair: the {len(want)} frames handed to the encoder against exp_doubling "
                f"on the same engine: {sum(differ)} elements differ (0)")
            if len(encoded[out_a]) != len(want) or any(differ):
                raise AssertionError("the served pair's frames are not exp_doubling's")

            out_d = os.path.join(outd, "pair_disk.mp4")
            request("pair, disk-based (checked)", "/interpolate_pair",
                    {**pair, "out": out_d, "disk_based": True}, fwd, frames=n_out)
            ha, hpad = pad_centered(torch.from_numpy(img0), 32, 512)
            hb, _ = pad_centered(torch.from_numpy(img1), 32, 512)
            di = DiskInterpolator(eng, os.path.join(work, "disk"))
            want_d = [hpad.crop(torch.from_numpy(f)).numpy()
                      for f in di.interpolate([ha.numpy(), hb.numpy()], n_out)]
            di.cleanup()
            differ = sum(int((g != w).sum()) for g, w in zip(encoded[out_d], want_d))
            log(f"  pair, disk-based: against DiskInterpolator on the same engine: {differ} "
                f"elements differ (0)")
            if len(encoded[out_d]) != n_out or differ:
                raise AssertionError("the disk-based pair's frames are not the interpolator's")

            out_b = os.path.join(outd, "pair_rev.mp4")
            request("pair, reversed (checked)", "/interpolate_pair", {**rev, "out": out_b},
                    fwd, frames=n_out)
            both = [os.path.join(outd, "concurrent_a.mp4"),
                    os.path.join(outd, "concurrent_b.mp4")]
            errs = []

            def post(body):
                code, r = api("/interpolate_pair", body)
                if code != 200:
                    errs.append((code, r))

            threads = [threading.Thread(target=post, args=({**pair, "out": both[0]},)),
                       threading.Thread(target=post, args=({**rev, "out": both[1]},))]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(SERVE_REQUEST_TIMEOUT_S)
            dt = time.perf_counter() - t0
            differ = [sum(int((g != w).sum()) for g, w in zip(encoded[c], encoded[s]))
                      for c, s in zip(both, (out_a, out_b))]
            log(f"  two concurrent pair requests: {dt:.3f} s host for {2 * n_out} frames "
                f"({2 * n_out / dt:.2f} frames out/s); against the sequential ones: "
                f"{differ} elements differ (0)")
            if errs or any(t.is_alive() for t in threads) or any(differ) or \
                    any(len(encoded[c]) != n_out for c in both):
                raise AssertionError(f"concurrent requests: {errs}, differing {differ}")
            recs["two concurrent pairs"] = {"seconds": dt, "frames": 2 * n_out,
                                            "frames_out_per_s": 2 * n_out / dt,
                                            "elements_differing": differ}
            torch.backends.cudnn.deterministic = saved_det

            with staged(services, imageio) as stages:
                request("pair (timed)", "/interpolate_pair",
                        {**pair, "out": os.path.join(outd, "pair_timed.mp4")}, fwd,
                        frames=n_out)
            recs["pair (timed)"]["stages"] = stages.report()
            log(f"  pair (timed), host seconds by stage: {stages.report()}")
            r = request("video, exp 1", "/interpolate_video", {"path": clip, "exp": 1}, None,
                        frames=2 * SERVE_CLIP_FRAMES - 1)
            vc = recs["video, exp 1"]["launches"]
            vf = vc["warp_blend"] if k2_final else vc["warp_planes"] // 7
            if not (vf >= 2 and vc["warp_planes"] == (LAUNCHES_PER_FORWARD + k1_last) * vf
                    and vc["warp_blend"] == k2_final * vf):
                raise AssertionError(f"video: launches {vc}")
            back = mp4_frames(os.path.join(outd, "video.mp4"))
            log(f"  video: stats {r}; {back} frames read back")
            if back != 2 * SERVE_CLIP_FRAMES - 1:
                raise AssertionError(f"video: {back} frames read back")
            trans = (1 << CHAIN_PASSES) - 1
            r = request("chain (25 + 30 fps)", "/chain",
                        {"videos": chain, "transition_passes": CHAIN_PASSES}, trans,
                        frames=None if have_ffmpeg() else 2 * CHAIN_FRAMES + trans)
            back = mp4_frames(os.path.join(outd, "chained.mp4"))
            log(f"  chain: {r['mode']}, {back} frames read back")
            if not have_ffmpeg() and (r["mode"] != "cv2" or back != 2 * CHAIN_FRAMES + trans):
                raise AssertionError(f"chain: {r}, {back} frames read back")
            r = request("reencode", "/reencode", {"path": clip}, 0, 0, 0)
            log(f"  reencode: {r['action']}")
            if not have_ffmpeg() and r["action"] != "reencoded_cv2":
                raise AssertionError(f"reencode: {r}")

            colr = {os.path.basename(p): read_colr(p) for p in encoded}
            log(f"  colr (primaries, transfer, matrix) of the encoded mp4s: {colr}")
            if not have_ffmpeg() and set(colr.values()) != {(1, 1, 1)}:
                raise AssertionError("an mp4 of _encode_frames lacks the BT.709 colr atom")
            codes = (api("/interpolate_pair", {**pair, "img0_path": "/etc/hostname"})[0],
                     api("/interpolate_pair", {**pair, "out": os.path.join(up, "x.mp4")})[0],
                     api("/nope", {})[0])
            log(f"  input outside the upload dir, output outside the output dir, unknown "
                f"endpoint: HTTP {codes} (403, 403, 404)")
            if codes != (403, 403, 404):
                raise AssertionError(f"confinement: {codes}")
        with http_server(app, eng, upload_dir=up, output_dir=outd,
                         auth=("smoke", "secret")) as port:
            api = Http(port, "smoke:secret")
            auth_codes = (api("/health", auth=False)[0], api("/health")[0])
        log(f"  basic auth: without credentials HTTP {auth_codes[0]} (401), with "
            f"{auth_codes[1]} (200)")
        if auth_codes != (401, 200):
            raise AssertionError(f"basic auth: {auth_codes}")
    finally:
        services._encode_frames = real_encode
        torch.backends.cudnn.deterministic = saved_det
    snap1 = mon.snapshot("serve: after the requests")
    log(f"  memory: {snap0['bytes_in_use'] / 1e9:.3f} GB in use before load_engine, "
        f"{snap1['bytes_in_use'] / 1e9:.3f} GB after (the phase's peak "
        f"{snap1['peak_bytes_in_use'] / 1e9:.3f} of {snap1['bytes_limit'] / 1e9:.1f} GB, "
        f"{snap1['pressure']})")
    # Batch 1 (K1's pairs N = 2, K2 N = 1) is new to these kernels; the
    # video's batch-4 launches are phase 3's shapes, checked again.
    timed = {k: launch_name(k) for k in keys if k[1] == (2 if k[0] == "k1" else 1)}
    shapes = check_launch_keys(warp_mod, dev, keys, timed, "serve")
    del eng
    torch.cuda.empty_cache()
    return {"requests": recs, "launches": totals, "shapes": shapes,
            "memory": [snap0, snap1], "ffmpeg": have_ffmpeg()}


def hd_frames(n, h, w, seed):
    """`n` YUV frames in [0, 1] (chroma centred at 0.5) of smooth content
    panned VIDEO_PAN px a frame, for YUV420Writer."""
    from rife_tpu_torch.video.yuv import rgb_to_yuv

    shift = np.array([0, 0.5, 0.5], np.float32)
    return [rgb_to_yuv(f.astype(np.float32) / 255.0) + shift
            for f in video_clip(n, h, w, VIDEO_PAN, seed=seed)]


def bench_fixtures(root) -> dict:
    """Phase 15's datasets, laid out as the reference reads them."""
    import cv2

    from rife_tpu_torch.video.yuv import YUV420Writer

    t0 = time.perf_counter()
    clips = {}
    for n, h, w in ((HD_1080_FRAMES, 1080, 1920), (HD_720_FRAMES, 720, 1280)):
        path = os.path.join(root, f"clip_{h}p.yuv")
        wr = YUV420Writer(path, w, h)
        for f in hd_frames(n, h, w, seed=h):
            wr.write_frame(f)
        wr.close()
        clips[h] = path

    def png(path, u8):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, u8[..., ::-1])

    for i in range(2):
        for k, f in enumerate(video_clip(3, 256, 256, 2, seed=30 + i)):
            png(os.path.join(root, "ucf", f"d{i}", ("frame_00.png", "frame_01_gt.png",
                                                    "frame_02.png")[k]), f)
        for k, f in enumerate(video_clip(3, 540, 960, 2, seed=40 + i)):
            png(os.path.join(root, "atd", f"d{i}", f"frame{k + 1}.png"), f)
    from rife_tpu_torch.cli.benchmarks import _MIDDLEBURY

    for j, name in enumerate(_MIDDLEBURY):
        h, w = (480, 640) if j % 2 else (388, 584)
        f0, gt, f1 = video_clip(3, h, w, 2, seed=50 + j)
        png(os.path.join(root, "mb", name, "frame10.png"), f0)
        png(os.path.join(root, "mb", name, "frame11.png"), f1)
        png(os.path.join(root, "mbgt", name, "frame10i11.png"), gt)
    log(f"  fixtures in {time.perf_counter() - t0:.2f} s: 1080p .yuv "
        f"{os.path.getsize(clips[1080]) / 1e6:.1f} MB ({HD_1080_FRAMES} frames), 720p .yuv "
        f"{os.path.getsize(clips[720]) / 1e6:.1f} MB ({HD_720_FRAMES}), ucf101 2 x 256x256, "
        f"middlebury 12 (388x584 / 480x640), atd12k 2 x 540x960")
    return clips


BENCH_KEYS = {"hd": ["benchmark", "psnr_y"], "hd4x": ["benchmark", "psnr_720p"],
              "ucf101": ["benchmark", "psnr", "ssim"], "middlebury": ["benchmark", "ie"],
              "atd12k": ["benchmark", "psnr", "ssim"],
              "testtime": ["benchmark", "seconds_per_frame", "fps"]}


def benchmarks_path(dev, warp_mod, cuda_warp, cuda_blend) -> dict:
    """Phase 15: the six protocol benchmarks through their CLI (see the
    module docstring)."""
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        return _benchmarks(dev, warp_mod, cuda_warp, cuda_blend, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _benchmarks(dev, warp_mod, cuda_warp, cuda_blend, work) -> dict:
    import argparse
    import io

    from rife_tpu_torch.cli import benchmarks
    from rife_tpu_torch.video.yuv import rgb_chroma_route

    log(f"  read_rgb's chroma upsample on this host: {rgb_chroma_route()}")
    clips = bench_fixtures(work)
    r5 = os.path.dirname(CKPT)
    seeded = os.path.join(work, "no_checkpoint")
    runs = [  # (name, arguments, forwards, K1 per forward)
        ("hd", ["--clips", f"{clips[1080]}:1080:1920", "--modelDir", r5],
         (HD_1080_FRAMES - 1) // 2, 6),
        ("hd4x", ["--model", "rife_m", "--modelDir", seeded,
                  "--clips", f"{clips[720]}:720:1280"], 3 * ((HD_720_FRAMES - 1) // 4), 6),
        ("ucf101", ["--root", os.path.join(work, "ucf"), "--modelDir", r5], 2, 6),
        ("middlebury", ["--root", os.path.join(work, "mb"), "--gt",
                        os.path.join(work, "mbgt"), "--modelDir", r5], 12, 6),
        ("atd12k", ["--root", os.path.join(work, "atd"), "--modelDir", r5], 2, 6),
        ("testtime", ["--warmup", str(TESTTIME_ITERS), "--iters", str(TESTTIME_ITERS),
                      "--dtype", "bfloat16", "--modelDir", r5], 2 * TESTTIME_ITERS, 6),
    ]
    rec, all_keys, timed = {}, [], {}
    k1_last, k2 = final_launches(warp_mod)
    for name, args, forwards, k1 in runs:
        buf = io.StringIO()
        with recorded_k1_k2(cuda_warp, cuda_blend) as keys, no_plain_on_the_card(warp_mod):
            reset_counts(warp_mod)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                benchmarks.main([name, *args])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = read_counts(warp_mod)
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"  {name}> {line}")
        res = json.loads(lines[-1])
        ok = sorted(res) == sorted(BENCH_KEYS[name]) and all(
            math.isfinite(v) for k, v in res.items() if k != "benchmark")
        log(f"  {name}: {dt:.2f} s host (engine build and reads included), {forwards} "
            f"forwards; launches {counts}; JSON keys and values {'ok' if ok else 'WRONG'}")
        if not ok:
            raise AssertionError(f"{name}: printed {res}")
        check_counts(counts, forwards, k1 + k1_last, k2, f"benchmarks {name}")
        rec[name] = {"seconds": dt, "forwards": forwards, "launches": counts, "result": res,
                     "k1_launch_shapes": sorted({str(k[1:5]) for k in keys if k[0] == "k1"})}
        all_keys += keys
        if name in ("hd", "hd4x"):
            timed.update({k: f"{name} {launch_name(k)}" for k in keys})
        if name == "testtime":
            eng = benchmarks._engine(argparse.Namespace(
                modelDir=r5, model=None, scale=1.0, dtype="bfloat16", fast=0, device=None))
            z = torch.zeros((1, 480, 640, 3), dtype=torch.bfloat16, device=dev)
            eng.warmup(tuple(z.shape))
            ev = events_ms(eng, z, z, TESTTIME_ITERS)
            rec[name]["events_ms_per_forward"] = ev
            log(f"  testtime: {res['seconds_per_frame'] * 1e3:.3f} ms a frame on the host "
                f"clock between two synchronisations; the same forward by CUDA events "
                f"{ev:.3f} ms")
            if not res["seconds_per_frame"] * 1e3 >= 0.9 * ev:
                raise AssertionError("testtime reports less than the forwards' device time")
            del eng
        torch.cuda.empty_cache()
    shapes = check_launch_keys(warp_mod, dev, all_keys, timed, "benchmarks")
    totals = {k: sum(r["launches"][k] for r in rec.values()) for k in _counted(warp_mod)}
    return {"runs": rec, "launches": totals, "shapes": shapes,
            "chroma_route": rgb_chroma_route()}


def main() -> int:
    t_start = time.perf_counter()
    signal.alarm(HARD_STOP_S)  # SIGALRM ends the run if anything hangs
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr, flush=True)
        return 1
    from rife_tpu_torch.ops import warp as warp_mod
    from rife_tpu_torch.ops import conv_chain as chain_mod
    from rife_tpu_torch.ops.cuda import _build
    from rife_tpu_torch.ops.cuda import conv_chain as cuda_chain
    from rife_tpu_torch.ops.cuda import gather_probe as cuda_probe
    from rife_tpu_torch.ops.cuda import warp as cuda_warp
    from rife_tpu_torch.ops.cuda import warp_blend as cuda_blend
    from rife_tpu_torch.ops.cuda import warp_nhwc as cuda_nhwc

    dev = torch.device("cuda", 0)
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
            f"nvidia-smi: {smi}; device count {torch.cuda.device_count()}")

    with Phase("build"):
        t0 = time.perf_counter()
        # One nvcc each, all started together.
        built = _build.build_all(cuda_warp.SOURCES + cuda_blend.SOURCES
                                 + cuda_nhwc.SOURCES + cuda_chain.SOURCES
                                 + cuda_probe.SOURCES)
        log(f"  {len(built)} sources built in {time.perf_counter() - t0:.2f} s")
        for b in built.values():
            log(f"  nvcc: {b.seconds:.2f} s -> {os.path.relpath(b.path, ROOT)}")
            for line in b.ptxas_log.splitlines():
                if any(k in line for k in ("registers", "spill", "Compiling entry")):
                    log(f"  ptxas: {line.strip()}")
        cuda_warp.library()
        cuda_warp.library_bwd()
        cuda_blend.library()
        cuda_nhwc.library()
        cuda_chain.library()
        cuda_probe.library()

    with Phase("kernels"):
        records, v425_records, worst = check_and_time_kernel(warp_mod, dev)
        blend_records, blend_worst = check_and_time_blend(warp_mod, dev)

    with Phase("main path"):
        main, rife_keep = main_path(dev, warp_mod)

    with Phase("v4.25"):
        v425, v425_keep = v425_path(dev, warp_mod)

    with Phase("A/B"):
        ab = ab_path(warp_mod, {"rife": rife_keep, "v4.25": v425_keep})
        del rife_keep, v425_keep
        torch.cuda.empty_cache()

    with Phase("legacy"):
        nhwc_records, nhwc_worst = check_and_time_nhwc(warp_mod, dev)
        legacy = legacy_path(dev, warp_mod, cuda_nhwc)

    with Phase("train"):
        bwd_records, bwd_worst, fwd_worst_train = check_and_time_bwd_kernel(warp_mod, dev)
        train = train_path(dev, warp_mod, cuda_warp)

    with Phase("convchain"):
        conv = convchain_path(dev, warp_mod, chain_mod)

    with Phase("probes"):
        probes = probes_path(dev, warp_mod)

    with Phase("ladder"):
        ladder, ladder_records, ladder_worst, ladder_blend_worst = ladder_path(
            dev, warp_mod, cuda_warp, cuda_blend, records)

    with Phase("protocol"):
        protocol = protocol_path(dev, warp_mod)

    with Phase("video"):
        video = video_path(dev, warp_mod)
    with Phase("serve"):
        serve_rec = serve_path(dev, warp_mod, cuda_warp, cuda_blend)

    with Phase("benchmarks"):
        bench = benchmarks_path(dev, warp_mod, cuda_warp, cuda_blend)

    with Phase("train family"):
        family, family_shapes = train_family_path(dev, warp_mod, cuda_warp, cuda_blend,
                                                  cuda_nhwc)

    path_runs = {f"video {k}": video[k]["launches"]
                  for k in ("2x_checked", "2x", "4x", "v425_4x")}
    path_runs["serve http"] = serve_rec["launches"]
    path_runs.update({f"benchmarks {k}": r["launches"] for k, r in bench["runs"].items()})
    path_runs.update({f"video {k}": video["file_io"][k]["launches"]
                       for k in ("interp_img", "interp_video", "disk_interpolator")
                       if k in video["file_io"]})
    path_runs.update({f"train {m}": r["launches"] for m, r in family.items()})

    per_fwd = lambda recs, key, n="launches_per_forward": sum(  # noqa: E731
        r[key] * r[n] for r in recs)
    per_step = lambda key: sum(r[key] * r["launches_per_step"]  # noqa: E731
                               for r in bwd_records)
    bound_by = lambda recs: ("bytes" if all(r["bound_by"] == "bytes"  # noqa: E731
                                            for r in recs) else "operations")
    by_path = lambda k: {"serve rife": main["launches"][k],  # noqa: E731
                         "serve v4.25 rung 1": v425["rung1"]["launches"][k],
                         "serve v4.25 rung 0": v425["rung0"]["launches"][k],
                         "train": train["launches"][k],
                         **{f"serve {p}": legacy[p]["launches"][k] for p in legacy},
                         **{f"serve {c[0]}": ladder[c[0]]["launches"][k]
                            for c in LADDER_CONFIGS},
                         "protocol": protocol["launches"][k],
                         **{p: c[k] for p, c in path_runs.items()}}

    def nhwc_row(kernel, replaces, **extra):
        recs = [r for r in nhwc_records if r["kernel"] == kernel]
        keys = ("ms", "plain_ms", "bound_ms", "library_ms", "k1_route_ms")
        per = lambda model: {k: per_fwd(recs, k, f"launches_per_{model}_forward")  # noqa: E731
                             for k in keys}
        n = sum(r["launches_per_hdv2_forward"] for r in recs)
        return {"name": f"warp_nhwc_{kernel}", "route": "cuda",
                "source": "rife_tpu_torch/csrc/warp_nhwc.cu", "replaces": replaces,
                "launches": sum(by_path(f"warp_nhwc_{kernel}").values()),
                "launches_by_path": by_path(f"warp_nhwc_{kernel}"),
                "max_abs_err": max(nhwc_worst, family_shapes["nhwc_err"]), **per("hdv2"),
                "bound_by": bound_by(recs),
                "times_are": f"per hdv2 f32 forward ({n} launches); library: "
                             f"F.grid_sample f32; k1_route: permute, K1, permute back",
                "hd_forward": per("hd"), "per_launch": recs, "card": smi, **extra}
    v425_blend = blend_records[0]
    log(json.dumps({"kernels": [{
        "name": "warp_planes", "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp_planes.cu",
        "replaces": "rife_tpu/ops/pallas/warp_v5.py:337",
        "launches": sum(by_path("warp_planes").values()),
        "launches_by_path": by_path("warp_planes"),
        "max_abs_err": max(worst, fwd_worst_train, ladder_worst, serve_rec["shapes"]["k1_err"],
                           bench["shapes"]["k1_err"], family_shapes["k1_err"]),
        "ms": per_fwd(records, "ms"), "plain_ms": per_fwd(records, "plain_ms"),
        "bound_ms": per_fwd(records, "bound_ms"), "bound_by": bound_by(records),
        "library_ms": per_fwd(records, "library_ms"),
        "share_of_bound": per_fwd(records, "bound_ms") / per_fwd(records, "ms"),
        "times_are": "per rife serving forward (rung 1: 6 launches, the final "
                     "level fused)",
        "design": K1_DESIGN,
        "plan": {r["launch"]: r["plan"] for r in records + v425_records},
        "v425_rung1_forward": {k: per_fwd(v425_records, k, "launches_per_rung1_forward")
                               for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "per_launch": records + v425_records, "main_path": main, "v425_path": v425,
        "ladder": {c[0]: {k: ladder[c[0]][k] for k in
                          ("k1_per_forward", "k1_ms_per_forward", "k1_bound_ms_per_forward",
                           "k2_per_forward", "k2_form")}
                   for c in LADDER_CONFIGS},
        "per_launch_ladder": ladder_records, "ladder_path": ladder,
        "protocol_path": protocol, "video_path": video,
        "per_launch_serve": serve_rec["shapes"]["k1"],
        "per_launch_benchmarks": bench["shapes"]["k1"],
        "serve_path": {k: serve_rec[k] for k in ("requests", "launches", "memory", "ffmpeg")},
        "benchmarks_path": {k: bench[k] for k in ("runs", "launches", "chroma_route")},
        "card": smi}, {
        "name": "warp_planes_bwd", "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp_planes_bwd.cu",
        "replaces": "rife_tpu/ops/pallas/warp_v5.py:337",
        "replaces_also": "rife_tpu/ops/warp.py:274 (_planes_diff_bwd)",
        "launches": sum(by_path("warp_planes_bwd").values()),
        "launches_by_path": by_path("warp_planes_bwd"),
        "max_abs_err": max(bwd_worst, family_shapes["bwd_err"]),
        "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"), "bound_by": bound_by(bwd_records),
        "library_ms": per_step("library_ms"), "times_are": "per training step",
        "share_of_bound": per_step("bound_ms") / per_step("ms"),
        "design": BWD_DESIGN,
        "plan": {r["launch"]: r["plan"] for r in bwd_records},
        "split_per_step": {k: per_step(f"split_{k}") for k in
                           ("memset_ms", "kernel_ms", "cast_ms", "call_ms")},
        "per_launch": bwd_records, "train_path": train,
        "per_launch_train_family": family_shapes["bwd"],
        "train_family_path": family, "card": smi}, {
        "name": "warp_blend", "route": "cuda",
        "source": "rife_tpu_torch/csrc/warp_blend.cu",
        "replaces": "rife_tpu/ops/pallas/warp_blend.py:215",
        "launches": sum(by_path("warp_blend").values()),
        "launches_by_path": by_path("warp_blend"),
        "max_abs_err": max(blend_worst, ladder_blend_worst, serve_rec["shapes"]["k2_err"],
                           bench["shapes"]["k2_err"], family_shapes["k2_err"]),
        "ms": v425_blend["ms"], "plain_ms": v425_blend["plain_ms"],
        "bound_ms": v425_blend["bound_ms"], "bound_by": v425_blend["bound_by"],
        "library_ms": v425_blend["library_ms"],
        "share_of_bound": v425_blend["share_of_bound"],
        "times_are": "per v4.25 forward (one blend-only launch)",
        "design": K2_DESIGN, "plan": {r["launch"]: r["plan"] for r in blend_records},
        "per_launch": blend_records, "ab": ab,
        "per_launch_serve": serve_rec["shapes"]["k2"],
        "per_launch_benchmarks": bench["shapes"]["k2"],
        "launches_per_forward_by_rung": {c[0]: {"launches": ladder[c[0]]["k2_per_forward"],
                                                "form": ladder[c[0]]["k2_form"]}
                                         for c in LADDER_CONFIGS},
        "card": smi},
        nhwc_row("k3", "rife_tpu/ops/pallas/warp.py:232", design=K3_DESIGN),
        nhwc_row("k4", "rife_tpu/ops/pallas/warp_v4.py:182", legacy_path=legacy), {
        "name": "k5", "wrapper": "rife_tpu_torch.ops.conv_chain.conv_chain",
        "route": "cuda", "source": "rife_tpu_torch/csrc/conv_chain.cu",
        "replaces": "tools/r3_exp50_pallasconv.py:86",
        "replaces_also": "tools/r3_exp50_pallasconv.py:165 (pallas_core_v2)",
        "design": "wgmma m64 x BN x k16 bf16; TMA boxes of the zero-bordered flat "
                  "layout (one A box per kernel row's three taps) into mbarrier rings "
                  "fed by a producer thread; TMA-stored epilogue; persistent grid",
        "launches": conv["launches"]["conv_chain"],
        "launches_by_path": {"rife request's three convblocks": conv["launches"]["conv_chain"],
                             **by_path("conv_chain")},
        "max_abs_err": max(r["max_abs_err"] for r in conv["checks"]),
        **{k: sum(r[k] for r in conv["times"])
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": bound_by(conv["times"]),
        "times_are": "per rife request's three convblocks (block0-2, one 8-stage chain "
                     "each, the copy into the flat layout included); library: the port's "
                     "ConvPReLU loop through cuDNN, bf16, channels-last",
        "input_copy_ms": sum(r["input_copy_ms"] for r in conv["times"]),
        "resources": conv["resources"],
        "per_shape": conv["times"], "checks": conv["checks"], "model": conv["model"],
        "card": smi}, *probe_rows(probes, smi)]}))
    total = time.perf_counter() - t_start
    log(f"total {total:.1f} s (budget {TOTAL_BUDGET_S} s)")
    if total > TOTAL_BUDGET_S:
        raise RuntimeError(f"run took {total:.1f} s, over its budget")
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
