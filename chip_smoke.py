#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`stableanimator_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port still starts and is right on
the card.

    python3 chip_smoke.py                 # every default phase, 25 Euler steps
    python3 chip_smoke.py --phases device,build,kernels   # kernel bring-up only
    python3 chip_smoke.py --phases device,build,longvideo450   # the 450-frame request

Phases, in order (any failure exits nonzero; no phase's exception is caught):
  device   card name and power limit (nvidia-smi); TF32 stated and set off;
           the L2 read rate (one sum over 32 reads of a 16 MB tensor, which L2
           holds)
  build    builds the flash-attention kernels (streamed forward, resident
           forward, backward) from csrc/ with nvcc and the skeleton raster
           (csrc/raster.cpp) with g++, one process per source, in parallel
           (a failed build fails the run); prints the ptxas report and, from cuobjdump -sass,
           the wgmma (HGMMA) and TMA (UTMALDG, UTMASTG) instructions of the
           d = 64 and d = 512 forwards, the resident forward and the d = 64
           and d = 512 backward pairs: fails on a spill in any of the three
           libraries, if one of those seven kernels uses other than its
           launch-bound register count (setmaxnreg needs it), if HGMMA or
           UTMALDG is missing from one of their instantiations, or if a
           library still holds a retired mma.sync kernel (the forward's
           flash_fwd_kernel, the backward's flash_bwd_{dkv,dq}_d512_kernel)
  kernels  the streamed forward kernels against their plain PyTorch version,
           with and without lse, at the main paths' full shapes in bf16 and
           at ragged and fp16 shapes, with the d = 64 and d = 512 kernels'
           edges (q and kv tails, strided views of a fused QKV tensor, at
           d = 512 one q tile of 50 rows and two heads); the resident
           forward kernel, in clusters of 2 CTAs (how many fit the card at
           once printed and checked), against the plain version (lse too) and
           against the streamed kernel at the UNet's generate and training
           shapes, ragged bf16/fp16 ones and its edges (q and kv tails, a
           cluster whose last CTA has no q rows, fused QKV views, fp16 at
           UNet level 1); the backward kernels (through the autograd Function)
           against the plain backward within `grad_tolerance` at the
           training shapes and ragged bf16/fp16 ones, the d = 512 pair at the
           face-opt crops 23 (529 tokens), 24 and 32 (fp16 too) and q 200 x
           kv 1024; the forward and backward also at the 576x1024 paths'
           shapes (UNet levels 0, 1, 2 at 9216, 2304 and 576 tokens, batch 32
           for the request, 16 with lse and backward for the vertical
           training step; the VAE's mid attention at [4, 9216, 1, 512]) and
           the 450-frame request's UNet levels 0 and 1 at batch 64, where
           the plain versions run over chunks of the batch (their fp32
           scores would not fit the card whole) and the whole output is
           compared; then every kernel
           timed with CUDA events at the paths' shapes beside its bound, its
           plain version and the PyTorch library call (the resident one
           beside the streamed one too); the forwards'
           rows also beside their earlier design's time and, at d = 64, the
           exponentials' bound, at d = 512 (in the log only) the bound of
           the products it issues and the time of its bytes out of L2 at the
           probe's rate; the
           backward's beside their earlier design's times and the bound of
           the products they issue (P and dS split in two), the d = 512
           pair's at crops 24 and 32; the d = 512 pair's edges too (kv off
           its 64-row block with q off its 16-row tile, and the reverse)
  small    micro-config generate, and two micro-config fp32 training
           steps, on the card against the same on the CPU
  face     the ONNX -> torch executor on the card: an iresnet100 stand-in
           (glintr100's architecture, seeded) and an SCRFD-signature
           stand-in exported with torch's legacy exporter; the executor at
           batch 16 against the module's forward and input gradient (within
           FACE_REL of their largest element), both timed beside the
           module; FaceModel's embedding of the reference image
  dwpose   DWPose at full width: YOLOX-L and RTMPose-l stand-ins (seeded,
           BatchNorm statistics from one pass over noise) exported with the
           legacy exporter; the executor at YOLOX-L batch 16 (640x640) and
           RTMPose-l batch 64 (384x288) against the modules (fp32, TF32 off,
           within DWPOSE_REL of the largest output), parameters, FLOPs
           (torch.utils.flop_counter) and times; the detector's peak memory
           with the executor at batch 64 and 8 and with a local loop that
           keeps every value (the executor before it freed values) at 8;
           WholebodyDetector.video_poses on 16 seeded 512x512 frames against
           the per-frame calls (boxes and keypoints within 1e-4, subsets
           equal), boxes per frame and ms per frame by stage (letterbox,
           detector network, decode + NMS, crops, pose network, render); a
           micro-width pair on the card against the CPU
  generate full-width (SVD-XT, CLIP ViT-H, ...) 512x512x16f generate() with
           seeded weights: one warm-up request, one timed request; output
           shape / range and the kernel launch counts are asserted; the
           timed request's launches, counted by shape, weight the forward
           kernel's per-request times; then the resident A/B: the same
           request at AB_STEPS Euler steps with
           SA_TPU_RESIDENT_KV_MAX_BYTES at 0 and at 4 MiB in
           turns (0, 4 MiB, 4 MiB, 0), each route's launches asserted
  pro      the reference's 576x1024 request (E2E_PRO_r05.json: 16 frames,
           CFG 3.0, tile 16, decode chunk 4) on the generate phase's models
           with seeded 576x1024 inputs: a 2-step warm-up and the timed
           request; frames (16, 576, 1024, 3) finite in [0, 1] and not
           constant, and the forward kernel's launches by shape asserted:
           5 x steps at each of UNet levels 0, 1 and 2 (15 a step: level 2's
           576 tokens pass the 512-key cut) and 4 at [4, 9216, 1, 512], the
           sequential decode's 4 calls of 4 frames (the fp32 VAE encode of
           the reference stays plain); seconds, frames/s, phases and peak
           memory printed
  faceopt  a micro face-opt generate, card vs CPU; then the generate
           request with the HJB face optimiser (steps 1, lr 0.1, from step
           8, crop 16; the iresnet100 stand-in as recogniser, its embedding
           of the reference as target): warm-up and timed, 17 refines and
           the plain request's 10 x steps + 1 forward launches (the crop
           decodes stay off the kernel) asserted, frames finite in [0, 1]
           and unlike the plain request's, the overhead over it and the
           identity cost before and after the refine at step 8 printed;
           then the same request at crop 32 (a 256-px face crop: each
           refine runs the d = 512 forward with lse and the d = 512 backward
           pair), 10 x steps + 1 + 17 forward and 17 + 17 d = 512 backward
           launches asserted, the rest as at crop 16; then the micro CLI
           with --face_optimize_steps 1 and the stand-in antelopev2 files
  export   the generate phase's full-width UNet through
           tools/export_model.py (torch.export) at the flat request's call:
           the kernel's custom op in the graph (10 nodes), the exported
           program's module launching the kernel (5 + 5 at UNet levels 0 and
           1) and within kernel_tolerance of the eager module; export
           seconds, ms per call of both; then the deployment path at a small
           scale (the save and load of the full-width program took ≈ 40 s):
           the micro UNet with one 64-wide head a level exported at 2 x 2
           frames of 256x256, saved and loaded back, its reloaded module
           launching the kernel as the eager one does and within
           kernel_tolerance of it
  serve    cli.serve's AnimationService at full width with the stand-in
           antelopev2 files, behind make_handler on 127.0.0.1 in a thread:
           /healthz, two 512x512x16 requests (mp4, json; launches asserted),
           a 400 and a 413; the generate phase's models are freed first
  longvideo the inference CLI (`cli.animate.main`, in this process) at full
           width on 64 seeded 512x512 pose PNGs, LONGVIDEO_STEPS (6) steps,
           with the resident budget at 4 MiB: 5 tiles in groups of 1, two
           segments of 5 and 1 steps; the exit, the files written, 2
           progress lines, the resident and streamed launches (10 x 5 x 6
           and 4) and the 4 calls the resident kernel refuses (the VAE's
           d = 512) are asserted; then the same request at budget 0 (10 x 5 x 6 + 4
           streamed launches, none resident or refused), and the two
           routes' ratio of denoise seconds per step;
           then the driving request: the CLI at 512x512 x 16 frames with
           --driving_video_folder on 16 seeded raw frames and the
           full-width DWPose stand-ins (the PoseWorker subprocess on the
           card, overlapping the model build): exit, files, 10 x steps + 1
           forward launches, pose renders not constant and the worker's
           aligned flag asserted; extraction seconds, the part the overlap
           hid, request seconds and the device's peak memory over both
           processes printed; then cli.extract_skeleton on the same frames
           and cli.extract_training_skeletons twice (the second writes
           nothing)
  longvideo450 (only when named) E2E_LONGVID_r05_450f.json's request: the
           CLI on 450 seeded 512x512 pose PNGs, 25 steps, resident budget 0:
           38 tiles in 19 groups of 2 (UNet batch 64), 1-step segments, 29
           decode groups; 25 progress lines, 19 x 10 x steps + 29 streamed
           launches (by shape too), 450 PNGs, a GIF and an mp4, frames not
           constant; seconds and peak memory printed
  ingest   the release-day path at full width: the reference's checkpoint
           tree written from seeded models into a temporary directory
           (Animation/*.pth by torch.save of the state dicts as the port
           holds them; the SVD folders' vae and image_encoder as F16
           safetensors; the antelopev2 and DWPose stand-ins at published
           widths), its predicted bytes and the free disk space logged first
           (too little fails); tools/ingest_checkpoints.main on it with
           --validate_image on the card (a frame of the dwpose phase's noise
           clip on which the DWPose stand-ins find one person): seconds by
           stage, host peak RSS, the report (ok for all five files) and the
           validation's CSIM (a finite cosine); the ingested directory
           loaded by load_state_dicts into build_models(seed=None) as the
           CLIs do, timed, host peak RSS, every parameter bit-equal to the
           written tensor loaded directly; an INGEST_STEPS-step request on
           each model set: frames equal (bound 0), 10 x 5 + 1 forward
           launches each; then tools/eval_drill.py on the card at its
           defaults (full width, 64x64, 16 frames, 2 steps), its JSON
           printed, and its CSIM, PSNR / L1 and I3D features against the
           CPU on the same frames (DRILL_CSIM_ATOL, equal, DRILL_I3D_REL);
           the files are deleted at the end
  train    full-width training (remat, bf16 over fp32 masters, trainable
           unet, pose_net, face_encoder) on a seeded 1x16x512x512 batch:
           one warm-up step and TRAIN_TIMED_STEPS (2) timed steps through
           make_train_step;
           loss / grad_norm finite, the fp32 masters moved, and the launches
           of every kernel per step asserted; then the same on the vertical
           bucket (1x16 frames of height 1024 x width 576) on the same state,
           as MixedResolutionSampler alternates buckets: 30 forward, 15 + 15
           backward launches a step, peak memory printed; then the training CLI at the
           micro scale for 2 steps on a PNG dataset, and a resume
  profile  one more request (PROFILE_STEPS steps) under torch.profiler:
           device time by kernel category, the busiest kernels, the device's
           busy share, and the seconds the profiler takes to hand over its
           events
  parallel the (data, frame) mesh on torch.distributed over NCCL in a world of
           one process (`make_mesh()`; the machine has one card): NCCL's
           all_reduce, all_gather and all_to_all_single on the mesh's groups;
           the generate phase's request through generate(mesh=), its frames
           against the generate phase's (bound PARALLEL_FRAMES_ATOL), 251
           launches asserted, timed beside a plain request; one full-width
           training step through make_train_step(mesh=) with ZeRO-1 beside
           two one-device steps on the same batch, noises and seed (loss and
           grad_norm within their run-to-run spread), time and peak memory;
           ZeRO-1's optimizer bytes per rank at data 1, 2, 4, 8 (reckoned);
           then the process group is destroyed, the generate phase's models
           go to the host (the card's free memory printed), and FRAME_RANKS
           processes of this script (`--frame_worker`) share the card in a
           gloo world on a 1 x 2 (data, frame) mesh: each first probes which
           collectives gloo takes on card tensors (all_gather,
           all_to_all_single, broadcast, all_reduce; any refusal fails),
           then two fp32 micro steps against the same in one CPU process
           (SMALL_ATOL on loss and grad_norm, the micro train check's rule
           on the masters), then FRAME_STEPS (1) full-width step (TrainConfig
           defaults, the one-device steps' batch and seed, ZeRO-1 over data
           x frame) whose loss and grad_norm must lie within
           FRAME_LOSS_RTOL / FRAME_GRAD_RTOL of the one-device step's; each
           rank prints its seconds, peak memory and launches (asserted
           20 / 10 / 10); then the training CLI runs under torchrun (one
           process) for 2 micro steps and a resume
  quant    the int8 path (W8A8, build_models(quant=True)): int8_dense on the
           card against the fp32 product (tests/test_ops.py's bounds) and
           its int8 weights against the CPU's; a micro quant generate card vs
           CPU; the full-width request built with quant=True from the same
           seed, a 5-step warm-up and the timed request (251 launches at 25
           steps), frames finite in [0, 1], their difference from the bf16
           request's printed
The phases run in the order face, dwpose, generate (with its profile, the
A/B, pro, faceopt, export, parallel and quant, which need the generate
phase's models), serve, longvideo (with the driving request), longvideo450,
ingest, train.
Each phase logs its seconds ("[chip_smoke] <phase>: N s"). Before the last
line it prints one JSON object with the kernels' numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# published peaks of one H100 SXM at 700 W: dense bf16 FLOP/s, HBM bytes/s
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
FWD_KERNEL, BWD_SOURCE = "flash_attention_fwd", "flash_attention_bwd"
RES_KERNEL = "flash_attention_resident"
DKV_KERNEL, DQ_KERNEL = "flash_attention_bwd_dkv", "flash_attention_bwd_dq"
# the d = 512 backward pair (the face optimisation's VAE mid attention)
DKV512_KERNEL, DQ512_KERNEL = "flash_attention_bwd_dkv_d512", "flash_attention_bwd_dq_d512"
BWD_KERNELS = (DKV_KERNEL, DQ_KERNEL, DKV512_KERNEL, DQ512_KERNEL)
KERNELS = (FWD_KERNEL, RES_KERNEL) + BWD_KERNELS
REPLACES = {FWD_KERNEL: "stableanimator_tpu/ops/flash_attention.py:70",
            RES_KERNEL: "stableanimator_tpu/ops/flash_attention.py:125",
            DKV_KERNEL: "stableanimator_tpu/ops/flash_attention.py:326",
            DQ_KERNEL: "stableanimator_tpu/ops/flash_attention.py:372",
            DKV512_KERNEL: "stableanimator_tpu/ops/flash_attention.py:326",
            DQ512_KERNEL: "stableanimator_tpu/ops/flash_attention.py:372"}
SOURCES = {FWD_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_fwd.cu",
           RES_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_resident.cu",
           DKV_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_bwd.cu",
           DQ_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_bwd.cu",
           DKV512_KERNEL: "stableanimator_tpu_torch/csrc/flash_bwd_d512.cuh",
           DQ512_KERNEL: "stableanimator_tpu_torch/csrc/flash_bwd_d512.cuh"}
# the resident route's budget in the longvideo phase and the A/B: every
# UNet attention of a request passes the JAX package's test at 4 MiB
RESIDENT_BUDGET = 4 * 1024 * 1024
# the forward kernel's shapes on the main paths, [B, S, H, D]: generate's
# UNet levels 0 and 1 (CFG x 16 frames) and VAE decoder mid block, and the
# training step's UNet levels 0 and 1 (16 frames), which ask for the lse
# ... and at the reference's 576x1024 sizes (latent 72x128 for the pro
# request, 128x72 for the vertical training bucket): UNet levels 0, 1 and 2
# hold 9216, 2304 and 576 tokens (level 2 passes the 512-key cut there), and
# the pro request's sequential decode runs the VAE's mid attention on 4
# frames at a time; the frame-sharded training step (1 x 2 mesh) runs levels
# 0 and 1 on each rank's 8 frames; the 450-frame request (38 tiles, two a
# UNet call) runs levels 0 and 1 at batch 64, 2375 launches each
PATH_SHAPES = (("unet_level0", (32, 4096, 5, 64), False),
               ("unet_level1", (32, 1024, 10, 64), False),
               ("vae_mid", (16, 4096, 1, 512), False),
               ("train_level0", (16, 4096, 5, 64), True),
               ("train_level1", (16, 1024, 10, 64), True),
               ("faceopt_crop32", (16, 1024, 1, 512), True),
               ("pro_level0", (32, 9216, 5, 64), False),
               ("pro_level1", (32, 2304, 10, 64), False),
               ("pro_level2", (32, 576, 20, 64), False),
               ("pro_vae_mid", (4, 9216, 1, 512), False),
               ("vtrain_level0", (16, 9216, 5, 64), True),
               ("vtrain_level1", (16, 2304, 10, 64), True),
               ("vtrain_level2", (16, 576, 20, 64), True),
               ("frame_train_level0", (8, 4096, 5, 64), True),
               ("frame_train_level1", (8, 1024, 10, 64), True),
               ("long450_level0", (64, 4096, 5, 64), False),
               ("long450_level1", (64, 1024, 10, 64), False))
# the backward kernels' shapes on the training path (d = 64; at 512x512, on
# the vertical bucket and on a rank of the frame-sharded step) and on the face optimisation's refines (d = 512:
# the VAE decoder's mid attention over a 16-frame crop of 24 and of 32
# latents; the face-opt request runs crop 32)
TRAIN_SHAPES = (("train_level0", (16, 4096, 5, 64)), ("train_level1", (16, 1024, 10, 64)),
                ("vtrain_level0", (16, 9216, 5, 64)), ("vtrain_level1", (16, 2304, 10, 64)),
                ("vtrain_level2", (16, 576, 20, 64)),
                ("frame_train_level0", (8, 4096, 5, 64)),
                ("frame_train_level1", (8, 1024, 10, 64)))
# the plain versions hold fp32 [B, H, Sq, Sk] scores (the backward two such
# tensors at once): 54 GB at the pro request's level 0, so past
# PLAIN_SCORE_BYTES of scores they run over chunks of the batch, whose rows
# are independent, and the whole output is compared; smaller shapes run whole
PLAIN_SCORE_BYTES = 12 * 2**30
FACEOPT_BWD_SHAPES = (("faceopt_crop24", (16, 576, 1, 512)),
                      ("faceopt_crop32", (16, 1024, 1, 512)))
# the resident kernel's checks (each with and without lse): (label, q shape,
# kv length, dtype, fused); generate's and the
# 64-frame request's UNet levels (timed too), the training shapes,
# tests/test_ops.py's ragged shapes, and the kernel's edges: a q length off
# the 192-row tile against 4096 keys, 150 q rows (one q tile, so the
# cluster's other CTAs have no rows), kv below and across one 128-key tile,
# q, k, v as strided views of one [B, S, 3, H, D] tensor, fp16 at UNet level 1
RESIDENT_CHECKS = (("unet_level0", (32, 4096, 5, 64), 4096, torch.bfloat16, False),
                   ("unet_level1", (32, 1024, 10, 64), 1024, torch.bfloat16, False),
                   ("train_level0", (16, 4096, 5, 64), 4096, torch.bfloat16, False),
                   ("train_level1", (16, 1024, 10, 64), 1024, torch.bfloat16, False),
                   ("ragged_300_513", (2, 300, 5, 64), 513, torch.bfloat16, False),
                   ("ragged_300_513", (2, 300, 5, 64), 513, torch.float16, False),
                   ("small_256", (2, 256, 2, 64), 256, torch.bfloat16, False),
                   ("q_tail_200", (1, 200, 3, 64), 4096, torch.bfloat16, False),
                   ("q_150_empty_cta", (2, 150, 3, 64), 1024, torch.bfloat16, False),
                   ("kv_100", (2, 256, 3, 64), 100, torch.bfloat16, False),
                   ("kv_300", (2, 256, 3, 64), 300, torch.bfloat16, False),
                   ("fused_qkv", (2, 640, 4, 64), 640, torch.bfloat16, True),
                   ("unet_level1_fp16", (32, 1024, 10, 64), 1024, torch.float16, False))
RESIDENT_TIMED = ("unet_level0", "unet_level1")
# the resident kernel's times per launch with its earlier design (mma.sync,
# the K/V of a head held in a cluster's shared memory and staged through
# registers), measured by this script on an H100 80GB HBM3 at 700 W
EARLIER_RES_MS = {"unet_level0": 4.963, "unet_level1": 0.596}
# further forward checks, (label, q shape, kv length, dtype, fused): the
# d=512 kernel in fp16, ragged sequences, the d=64 kernel's edges (a q length
# off its 192-row tile, kv below and across one 128-key tile, q, k, v as
# strided views of one [B, S, 3, H, D] tensor, fp16 at UNet level 1) and the
# d = 512 kernel's: a q length off its 64-row tile against 4096 keys, 50 q
# rows (a single q tile with fewer than 64 rows), kv below, across and past a
# whole number of 32-key tiles, two heads, fused QKV views
EXTRA_CHECKS = (("vae_mid", (2, 4096, 1, 512), 4096, torch.float16, False),
                ("ragged_576", (2, 576, 20, 64), 576, torch.bfloat16, False),
                ("ragged_300", (1, 300, 2, 64), 300, torch.bfloat16, False),
                ("ragged_300", (1, 300, 2, 64), 300, torch.float16, False),
                ("q_tail_200", (1, 200, 3, 64), 4096, torch.bfloat16, False),
                ("kv_100", (2, 256, 3, 64), 100, torch.bfloat16, False),
                ("kv_300", (2, 256, 3, 64), 300, torch.bfloat16, False),
                ("fused_qkv", (2, 640, 4, 64), 640, torch.bfloat16, True),
                ("unet_level1_fp16", (32, 1024, 10, 64), 1024, torch.float16, False),
                ("d512_q_tail_200", (1, 200, 1, 512), 4096, torch.bfloat16, False),
                ("d512_q_50", (1, 50, 1, 512), 1024, torch.bfloat16, False),
                ("d512_kv_100", (2, 256, 1, 512), 100, torch.bfloat16, False),
                ("d512_kv_300", (2, 256, 1, 512), 300, torch.bfloat16, False),
                ("d512_kv_4100", (2, 256, 1, 512), 4100, torch.bfloat16, False),
                ("d512_h2", (2, 512, 2, 512), 512, torch.bfloat16, False),
                ("d512_fused_qkv", (2, 640, 1, 512), 640, torch.bfloat16, True))
# the streamed forward's times per launch with its earlier design (mma.sync,
# before the wgmma / TMA kernels at both head dims), measured by this script
# on an H100 80GB HBM3 at 700 W; printed beside this run's
EARLIER_FWD_MS = {"unet_level0": 6.827, "unet_level1": 0.876, "vae_mid": 4.413,
                  "train_level0": 3.449, "train_level1": 0.467}
# the Hopper kernels' symbols by library, and the SASS instructions that
# show their design: wgmma (HGMMA), TMA loads (UTMALDG) and stores (UTMASTG;
# the backward stores from registers)
SM90_SYMBOLS = {FWD_KERNEL: ("flash_fwd_sm90_kernel", "flash_fwd_d512_sm90_kernel"),
                RES_KERNEL: ("flash_resident_sm90_kernel",),
                BWD_SOURCE: ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel",
                             "flash_bwd_dkv_d512_sm90_kernel", "flash_bwd_dq_d512_sm90_kernel")}
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")
# their registers per thread at launch, 65536 over their threads rounded
# down to 8 (512 threads for the d = 64 forwards, 384 for the d = 512 forward
# and both backward pairs): the consumers' setmaxnreg.inc (to 160, and to
# 240) waits for good on fewer
SM90_REGISTERS = {"flash_fwd_sm90_kernel": 128, "flash_resident_sm90_kernel": 128,
                  "flash_fwd_d512_sm90_kernel": 168,
                  "flash_bwd_dkv_sm90_kernel": 168, "flash_bwd_dq_sm90_kernel": 168,
                  "flash_bwd_dkv_d512_sm90_kernel": 168, "flash_bwd_dq_d512_sm90_kernel": 168}
# the mma.sync kernels that Hopper kernels replaced, by library: the
# forward's and the d = 512 backward pair's; no library may hold them
RETIRED_SYMBOLS = {FWD_KERNEL: ("flash_fwd_kernel",),
                   BWD_SOURCE: ("flash_bwd_dkv_d512_kernel", "flash_bwd_dq_d512_kernel")}
# the L2 read rate: one sum that reads an fp32 tensor of L2_PROBE_BYTES,
# which the 50 MB L2 holds, L2_PROBE_REPEATS times over (a stride-0 view)
L2_PROBE_BYTES, L2_PROBE_REPEATS = 16 * 2**20, 32
# MUFU exponentials per clock per SM
EXP_PER_CLOCK_PER_SM = 16
# further backward checks: (label, q shape, kv length, dtype, fused): ragged
# sequences, and the d = 64 kernels' edges: a q length off the 64-row q tile
# (dK/dV) and the 128-row one (dQ) against 4096 keys, kv below and across the
# 128-row kv block (dK/dV) and off the 64-row kv tile (dQ), q, k, v as
# strided views of one [B, S, 3, H, D] tensor, fp16 at training level 1; the
# d = 512 pair at the face-opt crops 23 (529 tokens: off every tile), 24 and
# 32, fp16 at crop 32, q 200 x kv 1024, and its edges: kv off the dK/dV
# kernel's 64-row block with q off its 16-row tile (two heads), and q off the
# dQ kernel's 64-row block with kv off its 16-row tile (fp16)
BWD_EXTRA_CHECKS = (("ragged_300", (1, 300, 2, 64), 300, torch.bfloat16, False),
                    ("ragged_300", (1, 300, 2, 64), 300, torch.float16, False),
                    ("ragged_640_576", (2, 640, 2, 64), 576, torch.bfloat16, False),
                    ("ragged_640_576", (2, 640, 2, 64), 576, torch.float16, False),
                    ("q_tail_200", (1, 200, 3, 64), 4096, torch.bfloat16, False),
                    ("kv_100", (2, 256, 3, 64), 100, torch.bfloat16, False),
                    ("kv_300", (2, 256, 3, 64), 300, torch.bfloat16, False),
                    ("fused_qkv", (2, 640, 4, 64), 640, torch.bfloat16, True),
                    ("train_level1_fp16", (16, 1024, 10, 64), 1024, torch.float16, False),
                    ("faceopt_crop23", (16, 529, 1, 512), 529, torch.bfloat16, False),
                    ("faceopt_crop24", (16, 576, 1, 512), 576, torch.bfloat16, False),
                    ("faceopt_crop32", (16, 1024, 1, 512), 1024, torch.bfloat16, False),
                    ("faceopt_crop32_fp16", (16, 1024, 1, 512), 1024, torch.float16, False),
                    ("d512_q200_kv1024", (16, 200, 1, 512), 1024, torch.bfloat16, False),
                    ("d512_q200_kv300_h2", (2, 200, 2, 512), 300, torch.bfloat16, False),
                    ("d512_q72_kv1000_fp16", (4, 72, 1, 512), 1000, torch.float16, False))
# the backward kernels' times per launch with their earlier design
# (mma.sync, before the wgmma / TMA kernels, at both head dims), measured by
# this script on an H100 80GB HBM3 at 700 W; printed beside this run's
EARLIER_BWD_MS = {DKV_KERNEL: {"train_level0": 5.378, "train_level1": 0.717},
                  DQ_KERNEL: {"train_level0": 3.145, "train_level1": 0.434},
                  DKV512_KERNEL: {"faceopt_crop24": 0.584, "faceopt_crop32": 1.575},
                  DQ512_KERNEL: {"faceopt_crop24": 0.346, "faceopt_crop32": 0.769}}
# products of 2 B H Sq Sk d operations each kernel issues, P and dS fed to
# the tensor cores as hi + lo: dK/dV S^T, dP^T, 2 dV, 2 dK; dQ S, dP, 2 dQ;
# the d = 512 dK/dV kernel computes S^T and dP^T once for each of its 2
# column slices: 2 x 2 + 4
ISSUED_PRODUCTS = {DKV_KERNEL: 6, DQ_KERNEL: 4, DKV512_KERNEL: 8, DQ512_KERNEL: 4}
ALL_PHASES = ("device", "build", "kernels", "small", "face", "dwpose", "generate", "pro",
              "faceopt", "export", "parallel", "quant", "serve", "longvideo", "ingest", "train",
              "profile")
# phases run only when --phases names them (each takes minutes of its own)
EXTRA_PHASES = ("longvideo450",)
# the parallel phase: the world-of-one mesh request runs the plain request's
# kernels in the same order on the same inputs, so its frames must equal the
# generate phase's exactly; the mesh training step's loss and grad_norm must
# lie within the one-device step's run-to-run spread (two fresh states, the
# same batch, noises and seed), measured in the run: 0 on an H100 80GB HBM3
# at 700 W (the bf16 step is deterministic there), so the bound is floored
# at PARALLEL_SPREAD_FLOOR of the value, a few fp32 roundings, in case a
# kernel ever sums in another order
PARALLEL_FRAMES_ATOL, PARALLEL_SPREAD_FLOOR = 0.0, 1e-6
# the parallel phase's frame-sharded steps: FRAME_RANKS processes share the
# card in a gloo world (NCCL refuses two ranks on one device) on a 1 x 2
# (data, frame) mesh, ZeRO-1 over both axes. The full-width bf16 step on the
# one-device runs' batch, draws and seed computes their function in another
# rounding: each rank's bf16 weight gradients sum 8 frames' rows in the GEMM
# and round once, then the two halves add in fp32 (the one-device step rounds
# the 16 frames' sum once); the temporal GroupNorms' fp32 sums and the halo
# convolutions' cuDNN algorithms differ. A bf16 rounding is 2^-9 of a value;
# the loss, a mean over 262,144 latent elements of values that moved by such
# roundings through the UNet, within FRAME_LOSS_RTOL of the one-device loss,
# and grad_norm, over 1.6 B gradients each moved by a few roundings, within
# FRAME_GRAD_RTOL. The micro fp32 step on the card (TF32 off) against one CPU
# process: SMALL_ATOL relative on loss and grad_norm, and _small_train's rule
# on the masters. FRAME_STEPS full-width steps: the first (update 0, at lr
# 0) is compared; one step, its seconds cold (a second, warm step added ≈ 25 s
# of host-staged gloo to the default run). So the update at lr > 0 across the
# frame mesh is the micro steps' to show: their masters must move by more
# than lr / 2 on at least FRAME_MOVED_SHARE of the elements (0.725 did)
FRAME_RANKS, FRAME_LOSS_RTOL, FRAME_GRAD_RTOL, FRAME_STEPS = 2, 1e-3, 1e-2, 1
FRAME_MOVED_SHARE = 0.5
# seconds the full-width ranks may take, start to exit
FRAME_TIMEOUT = 600
# the frame-sharded step's peak device memory per rank, predicted before the
# first run (PERF.md): half the AdamW moments of the one-device step's 41.0
# GiB and about half its activations
FRAME_PREDICTED_GIB = (29.0, 36.0)
# the quant phase's micro generate, card vs CPU: the int8 path is
# discontinuous (an activation on a rounding boundary moves by one int8
# step, and the next layers' inputs with it), so the bound is not rounding:
# on the CPU the same micro quant generate at 1 and 8 threads differs by
# mean 1.0e-2, max 0.12, corrcoef 0.9978 (the plain one by 2.8e-5, 4.3e-4)
SMALL_QUANT_MEAN, SMALL_QUANT_CORR = 3e-2, 0.99
# device kernels by name, for the profile's breakdown (first match wins)
CATEGORIES = (("flash_attention_fwd", r"flash_fwd_\w*kernel"),
              ("flash_attention_resident", r"flash_resident_sm90_kernel"),
              ("flash_attention_bwd_dkv", r"flash_bwd_dkv_sm90_kernel"),
              ("flash_attention_bwd_dq", r"flash_bwd_dq_sm90_kernel"),
              ("flash_attention_bwd_dkv_d512", r"flash_bwd_dkv_d512_sm90_kernel"),
              ("flash_attention_bwd_dq_d512", r"flash_bwd_dq_d512_sm90_kernel"),
              ("conv", r"conv|cudnn|fprop|dgrad|wgrad|implicit_convolve|winograd"),
              ("gemm", r"gemm|gemv|nvjet|cutlass|xmma|sm90_|cublas|matmul"),
              ("norm/softmax/reduce", r"reduce|softmax|norm|welford"),
              ("optimizer", r"foreach|multi_tensor|adam"),
              ("copy/layout", r"copy|cat|transpose|permute|index|gather|scatter|fill"),
              ("elementwise", r"elementwise|vectorized|unrolled|pointwise"))
# forward kernel vs plain version: the output within `kernel_tolerance`
# (one output ulp plus 2 eps of the output's rms); lse is fp32 in both, so
# summation order only. Backward: every gradient within `grad_tolerance`.
LSE_ATOL = 1e-3
# fp32 micro generate, card vs CPU (TF32 off): reduction order only
SMALL_ATOL = 2e-3
# fp32 micro training, card vs CPU (TF32 off), 128x128 so that the UNet's
# deepest level is 2x2 (at 64x64 it is 1x1 and the gradient ill-conditioned,
# tests/test_torch_train.py): loss and grad_norm within 1e-4 relative
# (summation order: ~2e-6 of the gradient's norm between CPU thread
# counts, tests/test_torch_train.py); the masters
# after two steps (update 0 at lr 0, update 1 at lr) within 1e-6 where the
# update was decided (|update| > lr / 2 on both), and the rms of the
# difference within 1 % of the update's rms overall: AdamW moves an element
# whose gradient is zero in exact arithmetic by lr * noise / (|noise| + eps)
SMALL_TRAIN_RTOL, SMALL_TRAIN_LR = 1e-4, 1e-4
# per training step with remat at the UNet block boundaries: 10 attentions
# (5 at level 0, 5 at level 1) run forward twice (the pass, then the
# recomputation in the backward) and backward once; nothing else launches
# a kernel (the VAE encode is fp32, CLIP's 257 tokens and UNet level 2 take
# the plain path)
TRAIN_LAUNCHES = {FWD_KERNEL: 20, RES_KERNEL: 0, DKV_KERNEL: 10, DQ_KERNEL: 10,
                  DKV512_KERNEL: 0, DQ512_KERNEL: 0}
# (2 timed steps: the step is host-bound and its time is read in alternating
# runs of one call, not from this mean)
TRAIN_TIMED_STEPS = 2
# the vertical bucket (cli/train.py's AnimationDataset(..., 576, 1024):
# width 576, height 1024; latent 128x72), stepped on the 512x512 steps'
# state: UNet level 2 (576 tokens) joins the kernel, so 15 attentions run
# forward twice and backward once
VERTICAL_HW = (1024, 576)
VTRAIN_LAUNCHES = {FWD_KERNEL: 30, RES_KERNEL: 0, DKV_KERNEL: 15, DQ_KERNEL: 15,
                   DKV512_KERNEL: 0, DQ512_KERNEL: 0}
# the pro request (E2E_PRO_r05.json: 576x1024, 16 frames, 25 steps, CFG 3.0,
# tile 16, decode chunk 4): the flat path, 15 kernel attentions per UNet
# call (5 at each of levels 0, 1 and 2), and a latent volume of 16 x 72 x 128
# past batched_decode_max_latent_volume, so the decode runs 4 calls of 4
# frames, one d = 512 launch each; its warm-up runs PRO_WARMUP_STEPS
PRO_HW, PRO_UNET_ATTENTIONS, PRO_DECODE_CALLS, PRO_WARMUP_STEPS = (576, 1024), 15, 4, 2
# the long-video requests through the CLI, by frame count: (tiles at tile
# 16 / overlap 4, UNet calls per Euler step, steps per segment, decode
# groups). 64 frames: 5 tiles denoised in groups of 1 (UNet batch 2 x 16, as
# the flat request's), 5-step segments, 4 decode groups of 16 frames. 450
# frames (E2E_LONGVID_r05_450f.json, the longvideo450 phase): 38 tiles in
# groups of 2 (UNet batch 2 x 2 x 16), 1-step segments (30 tile slots a
# segment over 38 a step), 28 decode groups of 16 frames and one of 2
LONG_PLANS = {64: (5, 5, 5, 4), 450: (38, 19, 1, 29)}
LONGVIDEO_FRAMES, LONG450_FRAMES = 64, 450
# both 64-frame requests (budget 4 MiB and 0) run LONGVIDEO_STEPS Euler steps
# (at most --steps), two segments of 5 and 1 steps, so the segmented loop
# continues from a later step: the routes are compared per denoise step, and
# the default run's time goes to the ingest phase and the kernels' rows
LONGVIDEO_STEPS = 6
# the quant phase's warm-up request runs QUANT_SHORT_STEPS Euler steps; its
# timed request runs --steps
QUANT_SHORT_STEPS = 5
# the profile phase's request runs PROFILE_STEPS Euler steps (at most
# --steps): the profiler's
# hand-over of its events grows with them (≈ 5 s a step on the H100's host),
# and the default run's time goes to the ingest phase
PROFILE_STEPS = 5
# the A/B's four flat requests run AB_STEPS Euler steps: enough for the
# routes' ratio, and the run's time goes to the parallel phase's ranks
AB_STEPS = 5
# the ingest phase: its requests on the ingested and the directly loaded
# full-width models run INGEST_STEPS Euler steps (10 x steps + 1 forward
# launches each); the host must hold the release tree and its ingested copy
# with INGEST_DISK_MARGIN bytes to spare. The evaluation drill on the card
# against the CPU on the same frames: CSIM (mean and least) within
# DRILL_CSIM_ATOL (tests/test_torch_evaluate.py's CSIM_ATOL: a keypoint
# that moves by ~4e-5 can move a crop pixel by one level), PSNR / L1 equal
# (numpy on the same PNGs), and the I3D stand-in's features (fp32 Conv3d,
# TF32 off) within DRILL_I3D_REL of the largest |feature| (summation order)
INGEST_STEPS, INGEST_DISK_MARGIN = 5, 2 * 10**9
# the validation image: frame INGEST_IMAGE of the dwpose phase's seeded
# noise clip, the first on which the full-width DWPose stand-ins find one
# person (boxes per frame 3, 4, 2, 3, 2, 3, 3, 1, ... in the dwpose phase),
# so the skeleton alignment has a body to fit (with none it raises, as the
# reference's does); the generate inputs' reference finds several
INGEST_IMAGE = 7
DRILL_CSIM_ATOL, DRILL_I3D_REL = 1e-3, 1e-4
# the face phase: the ONNX executor on an iresnet100 stand-in (glintr100's
# architecture) at batch 16 against the torch module. In fp64 on both sides
# the output and the input gradient must agree within 1e-9 of their largest
# element (the same function, summation order only). In fp32 (TF32 off) the
# output within 1e-4; the fp32 gradient is printed, not bounded: the
# executor's BatchNorm and PReLU round differently from cuDNN's, and a
# pre-activation that moves by ~1e-7 across 0 switches a PReLU's slope
# (1 <-> ~0.25), so single gradient elements differ by up to ~1e-3 of the
# largest while both are right (H100, iresnet100 at batch 16)
FACE_BATCH, FACE_REL, FACE_REL64 = 16, 1e-4, 1e-9
# the face-opt request: FaceOptConfig(steps=1) with the JAX package's other
# defaults (lr 0.1, start step 8, crop 16) refines x0_hat at steps 8..24; then
# the same at crop 32 (a 256-px face crop), whose decodes put 1024 tokens
# into the VAE's mid attention: the d = 512 forward (with lse) and backward
# pair once a refine
FACEOPT_START, FACEOPT_BIG_CROP = 8, 32
# the dwpose phase: DWPose's networks at full width (YOLOX-L at batch 16 of
# 640x640, RTMPose-l at batch 64 of 384x288; seeded stand-ins) through the
# ONNX executor against their torch modules in fp32 with TF32 off, each
# output within DWPOSE_REL of its largest element. Random weights at these
# depths amplify rounding (on the CPU a 1e-6 relative nudge of the input
# moves YOLOX-L's backbone output by ~5e-5), and the exporter folds each
# BatchNorm into the convolution before it, so the file rounds otherwise than
# the module; the module's own change under such a nudge is printed beside
# the error
DWPOSE_DET_BATCH, DWPOSE_POSE_BATCH, DWPOSE_REL = 16, 64, 1e-3
# the detector's peak memory: the executor at MAX_FRAME_BATCH (64) and at
# DWPOSE_BEFORE_BATCH, and a loop that keeps every value at DWPOSE_BEFORE_BATCH
DWPOSE_BEFORE_BATCH = 8
# the clip of the dwpose phase and of the driving request: 16 seeded
# 512x512 noise frames; batched against per-frame calls, and the micro pair
# (write_dwpose at depth 0.33, width 0.125) card against CPU: boxes and
# keypoints within DWPOSE_TOL (rtol and atol), subsets equal
DWPOSE_FRAMES, DWPOSE_HW, DWPOSE_TOL, DWPOSE_MICRO = 16, 512, 1e-4, (0.33, 0.125)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _plain_rows(q, k) -> int:
    """Batch rows per call of a plain version on q [B, Sq, H, D] and k
    [B, Sk, H, D]: B when its fp32 scores fit PLAIN_SCORE_BYTES."""
    b, sq, h, _ = q.shape
    return max(1, min(b, PLAIN_SCORE_BYTES // (4 * h * sq * k.shape[1])))


def _plain(fn, q, k, *rest, **kw):
    """A plain version `fn` (q, k, then more batch-first tensors) over the
    whole batch, in chunks of `_plain_rows` rows; outputs concatenated."""
    rows = _plain_rows(q, k)
    if rows == q.shape[0]:
        return fn(q, k, *rest, **kw)
    parts = [fn(*(t[i:i + rows] for t in (q, k) + rest), **kw)
             for i in range(0, q.shape[0], rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def _chunks_note(q, k) -> str:
    rows = _plain_rows(q, k)
    return "" if rows == q.shape[0] else f", plain version in batch chunks of {rows}"


def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    # fp32 matmuls and convolutions in full fp32 (the VAE encoder island and
    # the plain attention's fp32 logits); cuDNN would otherwise use TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}; TF32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"[device] bounds reckoned at H100 SXM peaks: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
        f"{PEAK_BYTES / 1e12:.2f} TB/s")
    return l2_read_rate()


def l2_read_rate() -> float:
    """Bytes per second that the card reads out of L2: the CUDA-event time of
    one sum of each of L2_PROBE_REPEATS rows, each row a stride-0 view of the
    same fp32 tensor of L2_PROBE_BYTES, which stays in the 50 MB L2; a lower
    estimate, since a reduction is not a pure read."""
    x = torch.ones(L2_PROBE_BYTES // 4, device="cuda")
    rows = x.expand(L2_PROBE_REPEATS, x.numel())
    sec = cuda_ms(lambda: rows.sum(1), iters=30, warmup=3) / 1e3
    rate = L2_PROBE_REPEATS * L2_PROBE_BYTES / sec
    log(f"[device] L2 read rate: {rate / 1e12:.3f} TB/s ({L2_PROBE_REPEATS} reads of a "
        f"{L2_PROBE_BYTES >> 20} MB fp32 tensor by one sum)")
    return rate


def _registers(report: str, symbol: str) -> dict:
    """By instantiation of the kernel `symbol`, the registers that ptxas's
    report (-v) says it uses."""
    regs, func = {}, None
    for line in report.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if entry:
            func = entry.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and func and symbol in func:
            regs[func] = int(used.group(1))
    return regs


def _sass_counts(path, symbol: str, ops=SASS_OPS) -> dict:
    """By instantiation of the kernel `symbol` in the built library, the
    count of each of `ops` in its SASS (cuobjdump -sass)."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if symbol in name:
            counts[name] = {op: func.count(op) for op in ops}
    return counts


def phase_build():
    from stableanimator_tpu_torch.ops import build

    from stableanimator_tpu_torch.preproc import native_raster

    t0 = time.perf_counter()
    sources = (FWD_KERNEL, RES_KERNEL, BWD_SOURCE, native_raster.LIBRARY)
    # one compiler per source (nvcc for the kernels, g++ for the raster)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(build.build_kernel, sources)))
    log(f"[build] {', '.join(paths)} in {time.perf_counter() - t0:.1f} s; the skeleton raster "
        f"{paths[native_raster.LIBRARY].name}, {paths[native_raster.LIBRARY].stat().st_size} bytes")
    for name, path in paths.items():
        log_file = path.with_suffix(".log")
        report = log_file.read_text() if log_file.exists() else ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "C75" in line:
                log(f"[build]   {name}: {line.strip()}")
        spills = [ln for ln in report.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        if name in SM90_SYMBOLS and spills:
            raise SystemExit(f"{name} spills registers: {spills}")
        for symbol in SM90_SYMBOLS.get(name, ()):
            regs = _registers(report, symbol)
            if not regs or any(n != SM90_REGISTERS[symbol] for n in regs.values()):
                raise SystemExit(f"{symbol} must use {SM90_REGISTERS[symbol]} registers "
                                 f"(ptxas): {regs}")
            counts = _sass_counts(path, symbol)
            for func, ops in counts.items():
                log(f"[build] {name} SASS {func[:160]}: "
                    + ", ".join(f"{op} {n}" for op, n in ops.items()))
            if not counts or any(ops[op] == 0 for ops in counts.values() for op in SASS_OPS[:2]):
                raise SystemExit(f"{symbol} lacks wgmma or TMA loads in its SASS: {counts}")
    for name, symbols in RETIRED_SYMBOLS.items():
        for symbol in symbols:
            retired = _sass_counts(paths[name], symbol)
            log(f"[build] {name}: {len(retired)} instantiations of {symbol} (a retired mma.sync "
                "kernel) in the library")
            if retired:
                raise SystemExit(f"{name} still holds {symbol}: {sorted(retired)}")


def _qkv(shape, dtype, seed, sk=None, fused=False):
    """Seeded q [B, Sq, H, D] and k, v [B, sk, H, D]; `fused` makes them
    strided views of one [B, S, 3, H, D] tensor (sk must then be Sq)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, h, d = shape
    if fused:
        if sk not in (None, sq):
            raise ValueError("a fused QKV tensor has one sequence length")
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        return [qkv[:, :, i] for i in range(3)]
    return [torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.float32).to(dtype)
            for s in (sq, sk or sq, sk or sq)]


def _exp_rate() -> tuple[float, int, float]:
    """Exponentials per second of the card's MUFU units, 16 per clock per SM
    at the maximum SM clock, with its SM count and that clock in MHz."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def _check(lbl, q, k, v) -> float:
    """The forward kernel, with and without lse, against its plain version;
    returns the largest absolute error of the output."""
    from stableanimator_tpu_torch.ops import flash_attention as fa

    ref_o, ref_lse = _plain(fa.flash_attention_reference, q, k, v, with_lse=True)
    bound = fa.kernel_tolerance(ref_o)
    o = fa.flash_attention(q, k, v)
    o2, lse = fa.flash_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    err = share = 0.0
    for out in (o, o2):
        diff = (out.float() - ref_o.float()).abs()
        err = max(err, diff.max().item())
        share = max(share, (diff / bound).max().item())
    err_lse = (lse - ref_lse).abs().max().item()
    ok = share <= 1.0 and err_lse <= LSE_ATOL
    log(f"[kernels] fwd {lbl} q {tuple(q.shape)} kv {k.shape[1]} {str(q.dtype)[6:]}"
        f"{' (strided views of one QKV tensor)' if not q.is_contiguous() else ''}"
        f"{_chunks_note(q, k)}: max|o-ref| {err:.3e}, {share:.3f} of the bound (eps|ref| + 2 eps "
        f"rms(ref), rms "
        f"{ref_o.float().square().mean().sqrt().item():.3e}); max|lse-ref| {err_lse:.3e} tol "
        f"{LSE_ATOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{FWD_KERNEL} disagrees with its plain version at {lbl}")
    return err


def _check_resident(lbl, q, k, v) -> float:
    """The resident kernel, with and without lse, against the plain version
    and against the streamed kernel; returns
    the largest absolute error of its output against the plain version."""
    from stableanimator_tpu_torch.ops import flash_attention as fa

    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, with_lse=True)
    streamed = fa._flash_forward(q, k, v, 1.0 / q.shape[-1] ** 0.5, False)
    o = fa.flash_attention_resident(q, k, v)
    o2, lse = fa.flash_attention_resident(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    err = share = 0.0
    for out in (o, o2):
        diff = (out.float() - ref_o.float()).abs()
        err = max(err, diff.max().item())
        share = max(share, (diff / fa.kernel_tolerance(ref_o)).max().item())
    vs_streamed = (o.float() - streamed.float()).abs()
    share_streamed = (vs_streamed / fa.kernel_tolerance(streamed)).max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = share <= 1.0 and share_streamed <= 1.0 and err_lse <= LSE_ATOL
    log(f"[kernels] resident {lbl} q {tuple(q.shape)} kv {k.shape[1]} {str(q.dtype)[6:]}"
        f"{' (strided views of one QKV tensor)' if not q.is_contiguous() else ''} (lse "
        f"checked): max|o-ref| {err:.3e}, {share:.3f} of the bound; vs the streamed kernel "
        f"max {vs_streamed.max().item():.3e}, {share_streamed:.3f} of its bound; max|lse-ref| "
        f"{err_lse:.3e} tol {LSE_ATOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{RES_KERNEL} disagrees with its plain version or the streamed kernel "
                         f"at {lbl}")
    return err


def _check_bwd(lbl, q, k, v, do) -> dict:
    """dQ, dK, dV through the autograd Function (the backward kernels)
    against the plain backward on the o and lse the forward kernel gives;
    returns the largest absolute error of each kernel's outputs."""
    from stableanimator_tpu_torch.ops import flash_attention as fa

    qkv = [t.detach().requires_grad_() for t in (q, k, v)]   # strides kept
    out = fa.flash_attention(*qkv)
    if out.grad_fn is None:
        raise SystemExit("flash_attention's output on the card carries no grad_fn")
    got = torch.autograd.grad(out, qkv, do)
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    want = _plain(fa.flash_attention_bwd_reference, q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs, shares = [], []
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        errs.append(diff.max().item())
        shares.append((diff / fa.grad_tolerance(w)).max().item())
    ok = max(shares) <= 1.0
    log(f"[kernels] bwd {lbl} q {tuple(q.shape)} kv {k.shape[1]} {str(q.dtype)[6:]}"
        f"{' (strided views of one QKV tensor)' if not q.is_contiguous() else ''}"
        f"{_chunks_note(q, k)}: max|g-ref| dq/dk/dv " + " ".join(f"{e:.3e}" for e in errs)
        + ", share of grad_tolerance (eps|ref| + eps/4 rms(ref)) "
        + " ".join(f"{s:.3f}" for s in shares)
        + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the backward kernels disagree with the plain backward at {lbl}")
    dkv, dq = fa.bwd_kernel_names(q.shape[-1])
    return {dq: errs[0], dkv: max(errs[1:])}


def _time_bwd(lbl, shape) -> dict:
    """CUDA-event times of each backward kernel of the shape's head dim at a
    training (d = 64) or face-opt (d = 512) shape, beside its bound, the
    plain backward and SDPA's backward; the log line also gives its earlier
    design's time (d = 64) and the bound of the products it issues."""
    import math

    from stableanimator_tpu_torch.ops import flash_attention as fa

    b, s, h, d = shape
    q, k, v, do = _qkv(shape, torch.bfloat16, seed=11) + _qkv(shape, torch.bfloat16, seed=12)[:1]
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    _, launch = fa.bwd_launchers(q, k, v, o, lse, do, 1.0 / math.sqrt(d))
    plain_ms = cuda_ms(lambda: _plain(fa.flash_attention_bwd_reference, q, k, v, o, lse, do),
                       iters=2, warmup=1)
    # SDPA's backward: its forward + backward less its forward
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = cuda_ms(lambda: sdpa(qt, kt, vt), iters=10)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(sdpa(qt, kt, vt), (qt, kt, vt), dot), iters=10)
    io = 2.0 * b * s * h * d                   # bytes of one [B, S, H, D] bf16 tensor
    vec = 4.0 * b * s * h                      # bytes of lse or delta
    dkv, dq = fa.bwd_kernel_names(d)
    work = {dkv: (8.0 * b * h * s * s * d, 4 * io + 2 * vec + 2 * io),
            dq: (6.0 * b * h * s * s * d, 4 * io + 2 * vec + io)}
    rows = {}
    for name, (flops, nbytes) in work.items():
        ms = cuda_ms(launch[name], iters=10)
        bound_ms, bound_by = _bound(flops, nbytes)
        issued_ms = ISSUED_PRODUCTS[name] * 2.0 * b * h * s * s * d / PEAK_FLOPS * 1e3
        rows[name] = dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                          library_ms=sdpa_fb - sdpa_fwd, bound_ms=bound_ms, bound_by=bound_by,
                          tflops=flops / ms / 1e9)
        earlier = EARLIER_BWD_MS.get(name, {}).get(lbl)
        log(f"[kernels] {name} {lbl} {tuple(shape)} bf16: kernel {ms:.3f} ms "
            f"({rows[name]['tflops']:.0f} TFLOP/s; earlier design "
            f"{'none' if earlier is None else f'{earlier:.3f} ms'}), bound "
            f"{bound_ms:.4f} ms ({bound_by}), issued-product bound {issued_ms:.4f} ms "
            f"({ISSUED_PRODUCTS[name]} products, {issued_ms / ms:.1%} of it); plain "
            f"backward {plain_ms:.2f} ms{_chunks_note(q, k)}, sdpa backward "
            f"{sdpa_fb - sdpa_fwd:.3f} ms "
            f"(fwd+bwd {sdpa_fb:.3f} - fwd {sdpa_fwd:.3f})")
    return rows


def phase_kernels(l2_rate: float):
    from stableanimator_tpu_torch.ops.flash_attention import (
        RESIDENT_CLUSTER,
        flash_attention,
        flash_attention_reference,
        flash_attention_resident,
        resident_max_clusters,
    )

    max_err = {name: 0.0 for name in KERNELS}
    for lbl, shape, sk, dtype, fused in EXTRA_CHECKS:
        max_err[FWD_KERNEL] = max(max_err[FWD_KERNEL],
                                  _check(lbl, *_qkv(shape, dtype, seed=len(lbl), sk=sk, fused=fused)))
        torch.cuda.empty_cache()
    exp_per_s, sms, mhz = _exp_rate()
    log(f"[kernels] exponentials' bound: B*H*Sq*Sk / ({EXP_PER_CLOCK_PER_SM} per clock x {sms} SMs "
        f"x {mhz:.0f} MHz max SM clock) = {exp_per_s / 1e12:.3f} T/s")
    n = resident_max_clusters()
    log(f"[kernels] resident kernel in clusters of {RESIDENT_CLUSTER}: {n} run at once "
        f"(cudaOccupancyMaxActiveClusters), {n * RESIDENT_CLUSTER} CTAs, one per SM, on {sms} SMs")
    if not 1 <= n * RESIDENT_CLUSTER <= sms:
        raise SystemExit(f"the resident kernel's clusters do not fit the card at one CTA per SM: "
                         f"{n} clusters of {RESIDENT_CLUSTER}")
    for lbl, shape, sk, dtype, fused in RESIDENT_CHECKS:
        max_err[RES_KERNEL] = max(max_err[RES_KERNEL], _check_resident(
            lbl, *_qkv(shape, dtype, seed=len(lbl) + 1, sk=sk, fused=fused)))
        torch.cuda.empty_cache()

    rows = {name: [] for name in KERNELS}
    for lbl, shape, with_lse in PATH_SHAPES:
        b, s, h, d = shape
        q, k, v = _qkv(shape, torch.bfloat16, seed=7)
        max_err[FWD_KERNEL] = max(max_err[FWD_KERNEL], _check(lbl, q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v, with_lse=with_lse), iters=20)
        plain_ms = cuda_ms(lambda: _plain(flash_attention_reference, q, k, v, with_lse=with_lse),
                           iters=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                         iters=20)
        flops = 4.0 * b * h * s * s * d
        nbytes = 4.0 * b * s * h * d * 2 + (4.0 * b * s * h if with_lse else 0.0)
        bound_ms, bound_by = _bound(flops, nbytes)
        row = dict(shape=list(shape), with_lse=with_lse, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        if d == 64:
            second = f", exponentials' bound {b * h * s * s / exp_per_s * 1e3:.3f} ms"
        else:
            # the products it issues are the function's own (the reduction
            # split, not repeated), so their bound is the bound; out of L2 it
            # reads every K and V tile once per 64-row q tile, and q and o
            # once: an estimate at the probe's rate (a lower estimate of it),
            # kept to the log
            l2_bytes = 2.0 * 2 * b * h * -(-s // 64) * s * d + nbytes / 2
            second = (f", issued-product bound {flops / PEAK_FLOPS * 1e3:.3f} ms (= the bound), "
                      f"L2-bytes estimate {l2_bytes / l2_rate * 1e3:.3f} ms "
                      f"({l2_bytes / 1e9:.2f} GB at the probe's {l2_rate / 1e12:.3f} TB/s)")
        earlier = EARLIER_FWD_MS.get(lbl)
        log(f"[kernels] {FWD_KERNEL} {lbl} {tuple(shape)} bf16 lse={with_lse}: kernel {ms:.3f} "
            f"ms ({row['tflops']:.0f} TFLOP/s; earlier design "
            f"{'none' if earlier is None else f'{earlier:.3f} ms'}), bound "
            f"{bound_ms:.3f} ms ({bound_by}){second}, plain {plain_ms:.2f} ms"
            f"{_chunks_note(q, k)}, sdpa {lib_ms:.3f} ms")
        rows[FWD_KERNEL].append((lbl, row))
        if lbl in RESIDENT_TIMED:
            res_ms = cuda_ms(lambda: flash_attention_resident(q, k, v), iters=20)
            rows[RES_KERNEL].append((lbl, dict(row, ms=res_ms, streamed_ms=ms,
                                               tflops=flops / res_ms / 1e9)))
            log(f"[kernels] {RES_KERNEL} {lbl} {tuple(shape)} bf16: kernel {res_ms:.3f} ms in "
                f"clusters of {RESIDENT_CLUSTER} ({flops / res_ms / 1e9:.0f} TFLOP/s; "
                f"earlier design {EARLIER_RES_MS[lbl]:.3f} ms), streamed kernel {ms:.3f} ms, "
                f"bound {bound_ms:.3f} ms ({bound_by}){second}, plain {plain_ms:.2f} ms, sdpa "
                f"{lib_ms:.3f} ms")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for lbl, shape, sk, dtype, fused in BWD_EXTRA_CHECKS:
        errs = _check_bwd(lbl, *_qkv(shape, dtype, seed=len(lbl), sk=sk, fused=fused),
                          _qkv(shape, dtype, seed=99)[0])
        for name, e in errs.items():
            max_err[name] = max(max_err[name], e)
        torch.cuda.empty_cache()
    for lbl, shape in TRAIN_SHAPES + FACEOPT_BWD_SHAPES:
        q, k, v = _qkv(shape, torch.bfloat16, seed=5)
        errs = _check_bwd(lbl, q, k, v, _qkv(shape, torch.bfloat16, seed=6)[0])
        for name, e in errs.items():
            max_err[name] = max(max_err[name], e)
        del q, k, v
        torch.cuda.empty_cache()
        for name, row in _time_bwd(lbl, shape).items():
            rows[name].append((lbl, row))
        torch.cuda.empty_cache()
    return max_err, rows


def _inputs(h, w, f, id_dim, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    ref = torch.rand((1, h, w, 3), generator=gen, device=device)
    pose = torch.rand((f, h, w, 3), generator=gen, device=device) * 2.0 - 1.0
    face = torch.randn((1, id_dim), generator=gen, device=device)
    aug = torch.randn((1, h, w, 3), generator=gen, device=device)
    return ref, pose, face, aug


def _train_batch(b, f, h, w, id_dim, device, seed=0):
    """A seeded synthetic training batch of b clips of f frames at height h
    and width w (the layout `train_loss` takes); the face mask is a box in
    the upper middle of every frame, rows h/8 to h/2 and columns 3w/8 to
    5w/8."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    mask = torch.zeros((b, f, h, w, 1), device=device)
    mask[:, :, h // 8:h // 2, 3 * w // 8:5 * w // 8] = 1.0
    return {"frames": uniform(-1, 1, b, f, h, w, 3), "ref_image": uniform(0, 1, b, h, w, 3),
            "pose_pixels": uniform(-1, 1, b, f, h, w, 3),
            "face_embed": torch.randn((b, id_dim), generator=gen, device=device),
            "face_mask": mask}


def _small_train():
    """Two fp32 micro training steps on the card against the same on the
    CPU, with the same weights, batch and random draws."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.train.train_step import (
        create_train_state,
        draw_noises,
        make_train_step,
    )

    cfg = TrainConfig(mixed_precision="no", learning_rate=SMALL_TRAIN_LR, lr_warmup_steps=1)
    seeded = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    runs = {}
    for device in ("cpu", "cuda"):
        models = build_models(**micro_model_kwargs(), dtype=torch.float32, device=device,
                              seed=None)
        for a, b in zip(seeded, models):
            b.load_state_dict(a.state_dict())
        state = create_train_state(models, cfg)
        before = [m.clone() for m in state.masters]
        step_fn = make_train_step(models, cfg, PipelineConfig(), conditioning_dropout_prob=0.0)
        batch = _train_batch(1, 2, 128, 128, models.face_encoder.config.id_embeddings_dim, "cpu",
                             seed=1)
        gen = torch.Generator().manual_seed(2)
        metrics = []
        for _ in range(2):
            noises = draw_noises(batch, 4, 0.0, None, gen)
            state, m = step_fn(state, {k: v.to(device) for k, v in batch.items()},
                               noises={k: v.to(device) for k, v in noises.items()})
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        runs[device] = (metrics, [m.cpu() for m in state.masters], before)
    (m_cpu, p_cpu, before), (m_gpu, p_gpu, _) = runs["cpu"], runs["cuda"]
    rel = max(abs(a - b) / abs(a) for x, y in zip(m_cpu, m_gpu) for a, b in zip(x, y))
    diff = torch.cat([(a - b).flatten() for a, b in zip(p_gpu, p_cpu)])
    upd_cpu = torch.cat([(a - b).flatten() for a, b in zip(p_cpu, before)])
    upd_gpu = torch.cat([(a - b).flatten() for a, b in zip(p_gpu, before)])
    decided = (upd_cpu.abs() > SMALL_TRAIN_LR / 2) & (upd_gpu.abs() > SMALL_TRAIN_LR / 2)
    err_decided = diff[decided].abs().max().item()
    rms_share = (diff.square().mean().sqrt() / upd_cpu.square().mean().sqrt()).item()
    ok = rel <= SMALL_TRAIN_RTOL and err_decided <= 1e-6 and rms_share <= 1e-2
    log(f"[small] micro train fp32 128x128, 2 steps, card vs CPU: loss/grad_norm "
        + "; ".join(f"cpu {a[0]:.6f}/{a[1]:.5f} card {b[0]:.6f}/{b[1]:.5f}"
                    for a, b in zip(m_cpu, m_gpu))
        + f", max rel {rel:.2e} (tol {SMALL_TRAIN_RTOL}); masters: max|diff| {err_decided:.2e} on "
        f"the {int(decided.sum())} of {diff.numel()} elements whose update exceeded lr/2 (tol "
        f"1e-6), rms(diff)/rms(update) {rms_share:.2e} (tol 1e-2), max|diff| overall "
        f"{diff.abs().max().item():.2e} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the micro training step on the card disagrees with the CPU")


def phase_small():
    from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate

    cfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    cpu = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    gpu = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cuda", seed=None)
    for a, b in zip(cpu, gpu):
        b.load_state_dict(a.state_dict())
    ref, pose, face, aug = _inputs(64, 64, 4, 32, "cpu", seed=3)
    init = torch.randn((1, 4, 8, 8, 4), generator=torch.Generator().manual_seed(4))
    out_cpu = generate(cpu, ref, pose, face, cfg, aug_noise=aug, init_noise=init, device="cpu")
    out_gpu = generate(gpu, ref, pose, face, cfg, aug_noise=aug, init_noise=init,
                       device="cuda").cpu()
    err = (out_cpu - out_gpu).abs().max().item()
    log(f"[small] micro generate fp32, card vs CPU: max abs {err:.3e} tol {SMALL_ATOL}")
    if not err <= SMALL_ATOL:
        raise SystemExit("micro generate on the card disagrees with the CPU")
    _small_train()


def phase_generate(steps: int):
    from stableanimator_tpu_torch.core.config import PipelineConfig
    from stableanimator_tpu_torch.ops.flash_attention import flash_attention, reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate

    t0 = time.perf_counter()
    models = build_models(dtype=torch.bfloat16, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in models for p in m.parameters())
    log(f"[generate] built full-size models ({n_params / 1e9:.3f} B parameters, seeded) in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = PipelineConfig(num_inference_steps=steps)
    ref, pose, face, _ = _inputs(cfg.height, cfg.width, cfg.num_frames,
                                 models.face_encoder.config.id_embeddings_dim, "cuda")
    expected = 10 * steps + 1
    results = {}
    for run in ("warm-up", "timed"):
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = generate(models, ref, pose, face, cfg, device="cuda", timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = flash_attention.launches
        by_shape = dict(flash_attention.launches_by_shape)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(frames).all())
        lo, hi = frames.min().item(), frames.max().item()
        log(f"[generate] {run}: {total:.2f} s, {cfg.num_frames / total:.3f} frames/s; phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
            + f"; peak {peak_gb:.1f} GiB; flash launches {launches} (expected {expected}), "
            "by (B, Sq, Sk, H, D) " + ", ".join(f"{key}: {n}" for key, n in by_shape.items())
            + f"; out {tuple(frames.shape)} finite={finite} range [{lo:.4f}, {hi:.4f}] "
            f"mean {frames.float().mean().item():.5f}")
        if tuple(frames.shape) != (cfg.num_frames, cfg.height, cfg.width, 3):
            raise SystemExit(f"bad output shape {tuple(frames.shape)}")
        if not finite or lo < 0.0 or hi > 1.0:
            raise SystemExit("output not finite or outside [0, 1]")
        if launches != expected:
            raise SystemExit(f"flash kernel launched {launches} times, expected {expected}")
        results[run] = dict(seconds=total, phases=timings, launches=launches,
                            by_shape=by_shape, peak_gib=peak_gb)
    return results, (models, cfg, ref, pose, face), frames


def _launch_counts() -> dict:
    """Launches since the last reset, by kernel, and by (kernel, shape); and
    the calls the resident route's capacity test refused."""
    from stableanimator_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_resident,
    )

    counts = {FWD_KERNEL: flash_attention.launches,
              RES_KERNEL: flash_attention_resident.launches,
              **{name: flash_attention_bwd.launches[name] for name in BWD_KERNELS}}
    by_shape = {(FWD_KERNEL, key): n for key, n in flash_attention.launches_by_shape.items()}
    by_shape.update({(RES_KERNEL, key): n
                     for key, n in flash_attention_resident.launches_by_shape.items()})
    by_shape.update(flash_attention_bwd.launches_by_shape)
    return {"by_kernel": counts, "by_shape": by_shape,
            "refused": flash_attention_resident.refused}


@contextlib.contextmanager
def _resident_budget(nbytes: int):
    """SA_TPU_RESIDENT_KV_MAX_BYTES set to `nbytes` inside the block (the
    port reads it at every call), restored after."""
    from stableanimator_tpu_torch.ops.flash_attention import RESIDENT_BUDGET_ENV

    before = os.environ.get(RESIDENT_BUDGET_ENV)
    os.environ[RESIDENT_BUDGET_ENV] = str(nbytes)
    try:
        yield
    finally:
        if before is None:
            del os.environ[RESIDENT_BUDGET_ENV]
        else:
            os.environ[RESIDENT_BUDGET_ENV] = before


def phase_ab(models, cfg, ref, pose, face):
    """The flat 16-frame request at AB_STEPS Euler steps with the resident
    budget at 0 (streamed kernel) and at 4 MiB (resident kernel at UNet
    levels 0 and 1), in turns 0, 4 MiB, 4 MiB, 0; each run's launches
    asserted."""
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import generate

    cfg = dataclasses.replace(cfg, num_inference_steps=min(AB_STEPS, cfg.num_inference_steps))
    steps = cfg.num_inference_steps
    expected = {0: {FWD_KERNEL: 10 * steps + 1, RES_KERNEL: 0},
                RESIDENT_BUDGET: {FWD_KERNEL: 1, RES_KERNEL: 10 * steps}}
    times = {0: [], RESIDENT_BUDGET: []}
    for budget in (0, RESIDENT_BUDGET, RESIDENT_BUDGET, 0):
        with _resident_budget(budget):
            reset_launch_counts()
            t0 = time.perf_counter()
            generate(models, ref, pose, face, cfg, device="cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = _launch_counts()
        got = {k: counts["by_kernel"][k] for k in (FWD_KERNEL, RES_KERNEL)}
        log(f"[ab] budget {budget} B: {sec:.3f} s, launches {got}, refused {counts['refused']}")
        if got != expected[budget]:
            raise SystemExit(f"A/B at budget {budget}: launches {got}, expected {expected[budget]}")
        times[budget].append(sec)
    mean = {b: sum(t) / len(t) for b, t in times.items()}
    log(f"[ab] flat {cfg.num_frames}-frame {steps}-step request: streamed route (budget 0) "
        f"{', '.join(f'{t:.3f}' for t in times[0])} s, mean {mean[0]:.3f} s; resident route "
        f"(budget {RESIDENT_BUDGET}) {', '.join(f'{t:.3f}' for t in times[RESIDENT_BUDGET])} s, "
        f"mean {mean[RESIDENT_BUDGET]:.3f} s; resident / streamed "
        f"{mean[RESIDENT_BUDGET] / mean[0]:.4f}")


def phase_pro(models, steps: int) -> dict:
    """The reference's 576x1024 request (E2E_PRO_r05.json) on the generate
    phase's models with seeded 576x1024 inputs: a PRO_WARMUP_STEPS-step
    warm-up, then the timed request at `steps`. Asserted: frames
    (16, 576, 1024, 3) finite in [0, 1] and not constant; the forward
    kernel's launches by shape: 5 x steps at each of UNet levels 0, 1 and 2
    (batch 32) and one per 4-frame decode call at [4, 9216, 1, 512] (the
    sequential decode branch), nothing else (the fp32 VAE encode of the
    reference stays plain)."""
    from stableanimator_tpu_torch.core.config import PipelineConfig
    from stableanimator_tpu_torch.ops.flash_attention import flash_attention, reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import generate

    h, w = PRO_HW
    ref, pose, face, _ = _inputs(h, w, 16, models.face_encoder.config.id_embeddings_dim, "cuda",
                                 seed=1)
    results = {}
    for run, n_steps in (("warm-up", PRO_WARMUP_STEPS), ("timed", steps)):
        cfg = PipelineConfig(height=h, width=w, num_inference_steps=n_steps)
        tokens = [(h // 8 >> lvl) * (w // 8 >> lvl) for lvl in range(3)]
        unet = PRO_UNET_ATTENTIONS // len(tokens) * n_steps
        rows = 2 * cfg.num_frames                      # CFG x the one tile's frames
        want = {(rows, s, s, heads, 64): unet for s, heads in zip(tokens, (5, 10, 20))}
        n_tok = tokens[0]
        want[(cfg.decode_chunk_size, n_tok, n_tok, 1, 512)] = PRO_DECODE_CALLS
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = generate(models, ref, pose, face, cfg, device="cuda", timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        by_shape = dict(flash_attention.launches_by_shape)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        f32 = frames.float()
        finite = bool(torch.isfinite(f32).all())
        lo, hi, std = f32.min().item(), f32.max().item(), f32.std().item()
        motion = f32.std(dim=0).mean().item()
        log(f"[pro] {run} {w}x{h} (width x height) x {cfg.num_frames} frames x {n_steps} steps: "
            f"{total:.2f} s, {cfg.num_frames / total:.3f} frames/s; phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
            + f"; peak {peak_gb:.1f} GiB; flash launches {flash_attention.launches} (expected "
            f"{sum(want.values())}), by (B, Sq, Sk, H, D) "
            + ", ".join(f"{key}: {n}" for key, n in by_shape.items())
            + f"; out {tuple(frames.shape)} finite={finite} range [{lo:.4f}, {hi:.4f}] std "
            f"{std:.4f}, frame-to-frame std {motion:.4f}")
        checks = {
            f"frames (16, {h}, {w}, 3)": tuple(frames.shape) == (cfg.num_frames, h, w, 3),
            "finite in [0, 1]": finite and lo >= 0.0 and hi <= 1.0,
            "not constant": std > 1e-3 and motion > 0.0,
            "launches by shape (the sequential decode's 4 at d = 512)": by_shape == want,
        }
        failed = [name for name, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"the {h}x{w} request ({run}) failed its checks: {failed}")
        results[run] = dict(seconds=total, phases=timings, launches=flash_attention.launches,
                            by_shape=by_shape, peak_gib=peak_gb, steps=n_steps)
    del frames, f32
    torch.cuda.empty_cache()
    return results


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to the real stdout."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def _write_longvideo_inputs(root: str, n_frames: int, hw: int):
    """A seeded reference image and `n_frames` pose PNGs (a moving figure of
    filled boxes on black), at hw x hw."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8)).save(
        os.path.join(root, "reference.png"))
    poses = os.path.join(root, "poses")
    os.makedirs(poses)
    boxes = rng.integers(0, hw // 2, (6, 4))
    colours = rng.integers(64, 255, (6, 3))
    for i in range(n_frames):
        img = np.zeros((hw, hw, 3), np.uint8)
        shift = int(hw / 4 * np.sin(2 * np.pi * i / n_frames))
        for (y, x, dy, dx), c in zip(boxes, colours):
            y0, x0 = hw // 4 + y // 2, (hw // 4 + x // 2 + shift) % (hw - 40)
            img[y0:y0 + 8 + dy // 4, x0:x0 + 8 + dx // 4] = c
        Image.fromarray(img).save(os.path.join(poses, f"frame_{i}.png"))
    return os.path.join(root, "reference.png"), poses


def _longvideo_request(steps: int, budget: int, n_frames: int = LONGVIDEO_FRAMES):
    """`cli.animate.main` at full width on an `n_frames`-frame 512x512 request
    (LONG_PLANS) with the resident budget at `budget` bytes; counts and
    outputs asserted: at 4 MiB every UNet attention takes the resident
    kernel and the VAE's d = 512 ones are refused to the streamed kernel, at
    0 all take the streamed kernel."""
    import numpy as np
    from PIL import Image

    from stableanimator_tpu_torch.cli import animate
    from stableanimator_tpu_torch.diffusion.tiling import tile_indices
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts

    hw = 512
    n_tiles, calls, per_segment, decode_groups = LONG_PLANS[n_frames]
    with tempfile.TemporaryDirectory() as tmp:
        ref, poses = _write_longvideo_inputs(tmp, n_frames, hw)
        out = os.path.join(tmp, "out")
        argv = ["--checkpoint_dir", os.path.join(tmp, "nockpt"), "--reference_image", ref,
                "--pose_control_folder", poses, "--output_dir", out, "--height", str(hw),
                "--width", str(hw), "--num_inference_steps", str(steps), "--allow_random_init",
                "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _resident_budget(budget):
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(_Tee()) as printed:
                info = animate.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        progress = [ln for ln in printed.getvalue().splitlines() if "denoise step" in ln]
        names = sorted(os.listdir(os.path.join(out, "animated_images")))
        frames = np.stack([np.asarray(Image.open(os.path.join(out, "animated_images", n)))
                           for n in names])
        with Image.open(os.path.join(out, "animation_video.gif")) as gif:
            gif_frames = gif.n_frames
        mp4_bytes = os.path.getsize(os.path.join(out, "animation_video.mp4"))
    sec = info["seconds"]
    unet = 10 * calls * steps                    # UNet attentions at levels 0 and 1
    route = RES_KERNEL if budget else FWD_KERNEL
    rows = 2 * (n_tiles // calls) * 16           # CFG x a group's tiles x 16 frames
    want_unet = {(route, (rows, s, s, heads, 64)): unet // 2
                 for s, heads in (((hw // 8) ** 2, 5), ((hw // 16) ** 2, 10))}
    want = ({RES_KERNEL: unet, FWD_KERNEL: decode_groups, "refused": decode_groups} if budget
            else {RES_KERNEL: 0, FWD_KERNEL: unet + decode_groups, "refused": 0})
    got = {k: counts["by_kernel"][k] for k in KERNELS}
    motion = frames.astype(np.float32).std(axis=0).mean()
    log(f"[longvideo] cli {n_frames} frames {hw}x{hw}, {steps} steps, resident budget "
        f"{budget} B: request {sec:.2f} s, {n_frames / sec:.3f} frames/s; phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in info["phases"].items())
        + f"; main() {wall:.1f} s in all (model build, pose PNGs, outputs); peak "
        f"{peak_gb:.1f} GiB; warm {info['warm']}; {n_tiles} tiles, {calls} UNet calls a step; "
        f"launches {got}, refused {counts['refused']} (by (B, Sq, Sk, H, D) "
        + ", ".join(f"{k}: {n}" for k, n in counts["by_shape"].items())
        + f"); {len(progress)} progress lines; {len(names)} PNGs {frames.shape} mean "
        f"{frames.mean():.3f} std {frames.std():.3f}, frame-to-frame std {motion:.3f}; gif "
        f"{gif_frames} frames, mp4 {mp4_bytes} bytes")
    checks = {
        f"{n_tiles} tiles": tile_indices(n_frames, 16, 4).shape[0] == n_tiles,
        f"{n_frames} PNGs of 512x512x3": frames.shape == (n_frames, hw, hw, 3),
        f"gif of {n_frames} frames, mp4 written": gif_frames == n_frames and mp4_bytes > 0,
        "frames not constant": frames.std() > 1.0 and motion > 0.0,
        f"one progress line per {per_segment}-step segment":
            len(progress) == -(-steps // per_segment),
        f"{want[RES_KERNEL]} resident launches": got[RES_KERNEL] == want[RES_KERNEL],
        f"{want[FWD_KERNEL]} streamed launches": got[FWD_KERNEL] == want[FWD_KERNEL],
        f"UNet launches at batch {rows}": all(counts["by_shape"].get(k) == n
                                              for k, n in want_unet.items()),
        f"{want['refused']} refused": counts["refused"] == want["refused"],
        "no backward launches": got[DKV_KERNEL] == got[DQ_KERNEL] == 0,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the {n_frames}-frame CLI request at budget {budget} failed its "
                         f"checks: {failed}")
    return dict(seconds=sec, wall=wall, phases=info["phases"], peak_gib=peak_gb, steps=steps,
                **counts)


def phase_longvideo(steps: int):
    """The 64-frame CLI request on the resident route (budget 4 MiB), then on
    the streamed route (budget 0), each at LONGVIDEO_STEPS (at most
    `steps`); the routes compared by denoise seconds per step. Returns the
    first, with the second under "streamed"."""
    resident = _longvideo_request(min(steps, LONGVIDEO_STEPS), RESIDENT_BUDGET)
    torch.cuda.empty_cache()
    streamed = _longvideo_request(min(steps, LONGVIDEO_STEPS), 0)
    per_step = {name: r["phases"]["denoise"] / r["steps"]
                for name, r in (("resident", resident), ("streamed", streamed))}
    log(f"[longvideo] 64-frame request, denoise seconds per step: resident route (budget "
        f"{RESIDENT_BUDGET}, {resident['steps']} steps) {per_step['resident']:.4f} s, streamed "
        f"route (budget 0, {streamed['steps']} steps) {per_step['streamed']:.4f} s, resident / "
        f"streamed {per_step['resident'] / per_step['streamed']:.4f}")
    return dict(resident, streamed=streamed)


def phase_longvideo450(steps: int) -> dict:
    """E2E_LONGVID_r05_450f.json's request: the CLI on 450 seeded 512x512 pose
    PNGs at resident budget 0 (the port's default)."""
    return _longvideo_request(steps, 0, LONG450_FRAMES)


def _keep_every_value(fn, *inputs):
    """The ONNX executor's node loop before it freed values: every value stays
    in `env` until the call returns. The "before" of the executor that drops
    each value after its last use."""
    env = dict(fn.static_params)
    env.update(fn.weights)
    env.update(zip(fn.input_names, inputs))
    for node in fn.graph.nodes:
        outs = fn._exec(node, [env[i] if i else None for i in node.inputs])
        for name, val in zip(node.outputs, outs if isinstance(outs, (list, tuple)) else [outs]):
            if name:
                env[name] = val
    return [env[o] for o in fn.graph.outputs]


def _peak_gib(fn) -> float:
    """The most memory allocated while fn() runs (no grad) above what was
    allocated before it, GiB."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _noise_frames(n: int, hw: int, seed: int):
    """`n` seeded uniform-noise RGB frames of hw x hw (the stand-in detector is
    calibrated on noise, so a few of its anchors pass the thresholds)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8) for _ in range(n)]


def _poses_close(got, want) -> bool:
    import numpy as np

    close = lambda a, b: a.shape == b.shape and np.allclose(a, b, rtol=DWPOSE_TOL,  # noqa: E731
                                                            atol=DWPOSE_TOL)
    return (np.array_equal(got["bodies"]["subset"], want["bodies"]["subset"])
            and close(got["bodies"]["candidate"], want["bodies"]["candidate"])
            and close(got["hands"], want["hands"]) and close(got["faces"], want["faces"]))


def phase_dwpose(root: str) -> str:
    """DWPose at full width on the card. The seeded YOLOX-L and RTMPose-l
    stand-ins exported with the legacy exporter into `root`/DWPose; each
    network through the ONNX executor against its module (fp32, TF32 off),
    with its parameters, FLOPs and times; the detector's peak memory with the
    executor at MAX_FRAME_BATCH and at DWPOSE_BEFORE_BATCH, and with a loop
    that keeps every value at DWPOSE_BEFORE_BATCH; WholebodyDetector.
    video_poses on a 16-frame clip against the per-frame calls, the boxes
    per frame and the time per frame of each stage; a micro-width pair on the
    card against the CPU. Returns the stand-ins' directory."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from stableanimator_tpu_torch.preproc import standins
    from stableanimator_tpu_torch.preproc.detection import PersonDetector, letterbox
    from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function
    from stableanimator_tpu_torch.preproc.skeleton_render import draw_pose
    from stableanimator_tpu_torch.preproc.wholebody import WholebodyDetector

    t0 = time.perf_counter()
    modules = {"YOLOX-L": standins.seeded_yolox(0), "RTMPose-l": standins.seeded_rtmpose(0)}
    directory = standins.write_dwpose(os.path.join(root, "DWPose"),
                                      models=tuple(modules.values()))
    paths = {"YOLOX-L": os.path.join(directory, "yolox_l.onnx"),
             "RTMPose-l": os.path.join(directory, "dw-ll_ucoco_384.onnx")}
    log(f"[dwpose] seeded, calibrated and exported the stand-ins in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{n} {os.path.getsize(p) / 2**20:.1f} MiB" for n, p in paths.items()))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"YOLOX-L": torch.randint(0, 256, (DWPOSE_DET_BATCH, 3, 640, 640), generator=gen,
                                       device="cuda").float(),
              "RTMPose-l": torch.randn((DWPOSE_POSE_BATCH, 3, 384, 288), generator=gen,
                                       device="cuda")}

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    for name, module in modules.items():
        module.cuda()
        x = inputs[name]
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            module(x[:1])
        fn = load_onnx_function(paths[name], device="cuda")
        with torch.no_grad():
            got, want = fn(x), module(x)
            want = want if isinstance(want, tuple) else (want,)
            nudge = 1.0 + 1e-6 * torch.randn(x.shape, generator=gen, device="cuda")
            nudged = module(x * nudge)
            nudged = nudged if isinstance(nudged, tuple) else (nudged,)
            err = max(rel(g, w) for g, w in zip(got, want))
            sens = max(rel(n, w) for n, w in zip(nudged, want))
            ms = {"executor": cuda_ms(lambda: fn(x), iters=5),
                  "module": cuda_ms(lambda: module(x), iters=5)}
        log(f"[dwpose] {name}: {sum(p.numel() for p in module.parameters()) / 1e6:.3f} M "
            f"parameters, {counter.get_total_flops() / 1e9:.2f} GFLOP per image "
            f"(torch.utils.flop_counter); executor ({len(fn.graph.nodes)} nodes) at batch "
            f"{x.shape[0]}x{tuple(x.shape[1:])} against the module, fp32 TF32 off: outputs "
            f"{[tuple(o.shape) for o in got]}, max|err| / max|out| {err:.2e} (tol {DWPOSE_REL}; "
            f"the module's own change for a 1e-6 relative nudge of its input {sens:.2e}); "
            f"executor {ms['executor']:.3f} ms, module {ms['module']:.3f} ms per batch")
        if not err <= DWPOSE_REL:
            raise SystemExit(f"the ONNX executor disagrees with the {name} module: {err:.2e}")
        del module, fn, got, want, nudged
    modules.clear()
    inputs.clear()

    fn = load_onnx_function(paths["YOLOX-L"], device="cuda")
    produced = len({o for n in fn.graph.nodes for o in n.outputs if o})
    big = torch.randint(0, 256, (PersonDetector.MAX_FRAME_BATCH, 3, 640, 640), generator=gen,
                        device="cuda").float()
    small = big[:DWPOSE_BEFORE_BATCH].clone()
    peak = {f"executor, batch {PersonDetector.MAX_FRAME_BATCH}": _peak_gib(lambda: fn(big)),
            f"executor, batch {DWPOSE_BEFORE_BATCH}": _peak_gib(lambda: fn(small)),
            f"every value kept, batch {DWPOSE_BEFORE_BATCH}":
                _peak_gib(lambda: _keep_every_value(fn, small))}
    log(f"[dwpose] YOLOX-L detector's peak memory above its weights and input: "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peak.items())
        + f"; the executor holds at most {fn.peak_values} of the {produced} values it computes")
    del fn, big, small
    torch.cuda.empty_cache()

    wb = WholebodyDetector(paths["YOLOX-L"], paths["RTMPose-l"], device="cuda")
    frames = _noise_frames(DWPOSE_FRAMES, DWPOSE_HW, seed=1)
    boxes = wb.detector.detect_batch(frames)
    serial_boxes = [wb.detector(f) for f in frames]
    batched = wb.video_poses(frames)
    serial = [wb(f) for f in frames]
    counts = [len(b) for b in boxes]
    boxes_ok = all(b.shape == s.shape and np.allclose(b, s, rtol=DWPOSE_TOL, atol=DWPOSE_TOL)
                   for b, s in zip(boxes, serial_boxes))
    poses_ok = all(_poses_close(b, s) for b, s in zip(batched, serial))
    # stage by stage, twice (the second is timed)
    for _ in range(2):
        t = [time.perf_counter()]
        prepped = [letterbox(f, wb.detector.input_size) for f in frames]
        batch = np.stack([p[0] for p in prepped])
        t.append(time.perf_counter())
        raw = wb.detector._fn(batch)                         # ends with the copy to the host
        t.append(time.perf_counter())
        stage_boxes = [wb.detector._postprocess(raw[i], prepped[i][1], 0.45, 0.1, 0.3)
                       for i in range(len(frames))]
        t.append(time.perf_counter())
        crops = [c for f, b in zip(frames, stage_boxes) for c in wb.pose._prep(f, b)[0]]
        t.append(time.perf_counter())
        wb.pose._run_crops(crops)
        t.append(time.perf_counter())
        renders = [draw_pose(p, DWPOSE_HW, DWPOSE_HW) for p in batched]
        t.append(time.perf_counter())
    stage_ms = dict(zip(("letterbox", "detector network", "decode + NMS", "pose crops",
                         "pose network", "render"),
                        (1e3 * (b - a) / len(frames) for a, b in zip(t, t[1:]))))
    candidates = [int(((r[:, 4:5] * r[:, 5:]) > 0.1).any(axis=1).sum()) for r in raw]
    log(f"[dwpose] WholebodyDetector on {len(frames)} seeded {DWPOSE_HW}x{DWPOSE_HW} noise frames: "
        f"anchors past score_thr 0.1 per frame {candidates}, person boxes per frame {counts}, "
        f"{len(crops)} pose crops; detect_batch against per-frame calls {boxes_ok}, video_poses "
        f"against per-frame calls {poses_ok} (within {DWPOSE_TOL}, subsets equal); ms per frame "
        + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items())
        + f"; renders mean {np.mean(renders):.3f}")
    if not (boxes_ok and poses_ok):
        raise SystemExit("the batched DWPose path disagrees with the per-frame calls")
    if not (0 < sum(counts) and max(counts) <= PersonDetector.MAX_PERSONS_PER_FRAME):
        raise SystemExit(f"the stand-in detector gave {counts} boxes per frame")
    del wb
    torch.cuda.empty_cache()

    micro = standins.write_dwpose(os.path.join(root, "DWPose_micro"), depth=DWPOSE_MICRO[0],
                                  width=DWPOSE_MICRO[1])
    small_frames = _noise_frames(4, 256, seed=2)
    poses = {dev: WholebodyDetector(os.path.join(micro, "yolox_l.onnx"),
                                    os.path.join(micro, "dw-ll_ucoco_384.onnx"),
                                    device=dev).video_poses(small_frames)
             for dev in ("cpu", "cuda")}
    micro_ok = all(_poses_close(g, w) for g, w in zip(poses["cuda"], poses["cpu"]))
    log(f"[dwpose] micro stand-ins (depth {DWPOSE_MICRO[0]}, width {DWPOSE_MICRO[1]}), 4 frames "
        f"256x256, video_poses on the card against the CPU: "
        f"{[len(p['bodies']['subset']) for p in poses['cuda']]} bodies per frame, equal within "
        f"{DWPOSE_TOL}: {micro_ok}")
    if not micro_ok:
        raise SystemExit("the micro DWPose pair on the card disagrees with the CPU")
    return directory


class _DevicePeak:
    """The most device memory in use, all processes together
    (torch.cuda.mem_get_info), sampled every 20 ms on a thread while the
    block runs."""

    def __enter__(self):
        import threading

        self.peak, self._done = 0, threading.Event()
        self.before = self._used()

        def sample():
            while not self._done.wait(0.02):
                self.peak = max(self.peak, self._used())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _used() -> int:
        free, total = torch.cuda.mem_get_info()
        return total - free

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join()
        self.peak = max(self.peak, self._used())


def phase_driving(steps: int, dwpose_dir: str) -> dict:
    """`cli.animate.main` at the generate cell's configuration (512x512, 16
    frames) on 16 seeded raw frames with --driving_video_folder and the
    full-width DWPose stand-ins: the PoseWorker extracts on the card while
    the models build. Exit, files, the plain request's forward launches,
    pose renders that are not constant and the worker's aligned flag
    asserted; extraction and request times and the device's peak memory
    over both processes printed. Then both extract CLIs on the same frames,
    the training one twice (the second writes nothing)."""
    import numpy as np
    from PIL import Image

    import stableanimator_tpu_torch.pipeline.animation as animation
    from stableanimator_tpu_torch.cli import (
        animate,
        extract_skeleton,
        extract_training_skeletons,
    )
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts

    hw, n = DWPOSE_HW, DWPOSE_FRAMES
    seen = []
    real_generate = animation.generate

    def spy(models, ref, pose, *args, **kwargs):           # the pose frames the CLI passes
        seen.append(pose.float())
        return real_generate(models, ref, pose, *args, **kwargs)

    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "reference.png")
        Image.fromarray(np.random.default_rng(0).integers(0, 255, (hw, hw, 3), dtype=np.uint8)
                        ).save(ref)
        driving = os.path.join(tmp, "driving")
        images = os.path.join(tmp, "data", "clip0", "images")
        for folder in (driving, images):
            os.makedirs(folder)
            for i, frame in enumerate(_noise_frames(n, hw, seed=1)):
                Image.fromarray(frame).save(os.path.join(folder, f"frame_{i}.png"))
        out = os.path.join(tmp, "out")
        argv = ["--checkpoint_dir", os.path.join(tmp, "nockpt"), "--reference_image", ref,
                "--driving_video_folder", driving, "--dwpose_dir", dwpose_dir, "--output_dir", out,
                "--height", str(hw), "--width", str(hw), "--num_inference_steps", str(steps),
                "--allow_random_init", "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        animation.generate = spy
        try:
            with _DevicePeak() as device_peak:
                reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(_Tee()) as printed:
                    info = animate.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = _launch_counts()
        finally:
            animation.generate = real_generate
        names = sorted(os.listdir(os.path.join(out, "animated_images")))
        frames = np.stack([np.asarray(Image.open(os.path.join(out, "animated_images", f)))
                           for f in names])
        with Image.open(os.path.join(out, "animation_video.gif")) as gif:
            gif_frames = gif.n_frames
        mp4_bytes = os.path.getsize(os.path.join(out, "animation_video.mp4"))
        printed = printed.getvalue()
        extraction = [ln for ln in printed.splitlines() if "DWPose extraction" in ln]

        t0 = time.perf_counter()
        written = extract_skeleton.main(["--target_image_folder_path", driving,
                                         "--ref_image_path", ref, "--poses_folder_path",
                                         os.path.join(tmp, "poses"), "--dwpose_dir", dwpose_dir,
                                         "--device", "cuda"])
        cli_sec = time.perf_counter() - t0
        train_argv = ["--video_folder", os.path.join(tmp, "data"), "--dwpose_dir", dwpose_dir,
                      "--device", "cuda"]
        t0 = time.perf_counter()
        first = extract_training_skeletons.main(train_argv)
        train_sec = time.perf_counter() - t0
        second = extract_training_skeletons.main(train_argv)
        rerun_sec = time.perf_counter() - t0 - train_sec
        pose_pngs = len(os.listdir(os.path.join(tmp, "poses")))
        train_pngs = len(os.listdir(os.path.join(tmp, "data", "clip0", "poses")))
    pose = seen[0] if seen else torch.zeros(1)
    got = {k: counts["by_kernel"][k] for k in KERNELS}
    want = 10 * steps + 1
    pinfo = info.get("pose") or {}
    log(f"[driving] cli {n} raw frames {hw}x{hw}, {steps} steps, DWPose in the worker subprocess "
        f"on the card: extraction {pinfo.get('extract_seconds')} s in the worker, ready "
        f"{pinfo.get('ready_seconds', float('nan')):.2f} s after the worker started, "
        f"{pinfo.get('waited_seconds', float('nan')):.2f} s waited after the warm (hidden "
        f"{pinfo.get('ready_seconds', 0) - pinfo.get('waited_seconds', 0):.2f} s); request "
        f"{info['seconds']:.2f} s, {n / info['seconds']:.3f} frames/s; phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in info["phases"].items())
        + f"; main() {wall:.1f} s in all; device memory in use, both processes: "
        f"{device_peak.before / 2**30:.2f} GiB before, peak {device_peak.peak / 2**30:.2f} GiB "
        f"(this process's allocator peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB); "
        f"warm {info['warm']}; launches {got}; {extraction}; pose frames "
        f"{tuple(pose.shape)} mean {pose.mean().item():.3f} std {pose.std().item():.3f}; "
        f"{len(names)} PNGs {frames.shape} mean {frames.mean():.3f} std {frames.std():.3f}; "
        f"gif {gif_frames} frames, mp4 {mp4_bytes} bytes")
    log(f"[driving] extract_skeleton: {written} poses ({pose_pngs} PNGs) in {cli_sec:.1f} s; "
        f"extract_training_skeletons: {first} then {second} written ({train_pngs} PNGs) in "
        f"{train_sec:.1f} s and {rerun_sec:.1f} s")
    checks = {
        f"{n} PNGs of {hw}x{hw}x3": frames.shape == (n, hw, hw, 3),
        f"gif of {n} frames, mp4 written": gif_frames == n and mp4_bytes > 0,
        "frames not constant": frames.std() > 1.0,
        f"{want} forward launches": got[FWD_KERNEL] == want and got[RES_KERNEL] == 0,
        "no backward launches": got[DKV_KERNEL] == got[DQ_KERNEL] == 0,
        "pose renders not constant": tuple(pose.shape) == (n, hw, hw, 3)
        and pose.std().item() > 0.0 and pose.std(dim=0).mean().item() > 0.0,
        "the worker's aligned flag printed": len(extraction) == 1 and "aligned" in extraction[0]
        and "aligned" in pinfo,
        f"extract_skeleton wrote {n}": written == pose_pngs == n,
        f"extract_training_skeletons wrote {n}, then none": (first, second, train_pngs) == (n, 0, n),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the driving-video request failed its checks: {failed}")
    return dict(seconds=info["seconds"], wall=wall, pose=pinfo, device_peak_gib=device_peak.peak
                / 2**30, **counts)


def _u8(x: torch.Tensor):
    """[..., 3] pixels in [0, 1] on any device -> uint8 numpy."""
    return (x.float() * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).cpu().numpy()


def phase_face(root: str) -> dict:
    """The ONNX -> torch executor on the card: the iresnet100 stand-in
    (glintr100's architecture, seeded, BatchNorm statistics not the
    identity) exported with the legacy exporter into `root`/antelopev2 beside
    an SCRFD-signature stand-in whose score head detects; the executor at
    batch 16 against the module's own forward and input gradient, both timed;
    then FaceModel.get_id_embedding of the generate phase's reference image.
    Returns the stand-ins' paths and that embedding (the face-opt target)."""
    from stableanimator_tpu_torch.preproc import standins
    from stableanimator_tpu_torch.preproc.face import FaceModel
    from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

    import numpy as np
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    log(f"[face] torch {torch.__version__}: the legacy exporter's "
        f"{onnx_proto_utils.__name__} is present")
    t0 = time.perf_counter()
    ant = standins.write_antelopev2(os.path.join(root, "antelopev2"))
    det_path, rec_path = (os.path.join(ant, n) for n in ("scrfd_10g_bnkps.onnx",
                                                         "glintr100.onnx"))
    log(f"[face] exported the stand-ins (SCRFD signature at 640x640; iresnet100, "
        f"{os.path.getsize(rec_path) / 2**20:.1f} MiB) in {time.perf_counter() - t0:.1f} s")
    model = standins.seeded_iresnet(0).cuda()
    fn = load_onnx_function(rec_path, device="cuda")
    ops = sorted({n.op_type for n in fn.graph.nodes})
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((FACE_BATCH, 3, 112, 112), generator=gen, device="cuda") * 2.0 - 1.0
    t = torch.randn((FACE_BATCH, 512), generator=gen, device="cuda")

    def grad_of(f, x=x, t=t):
        xr = x.clone().requires_grad_(True)
        return torch.autograd.grad((f(xr) * t).sum(), xr)[0]

    def executor(v, weights=None):
        return fn(v, _weights=weights)[0]

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    with torch.no_grad():
        emb, ref = executor(x), model(x)
    fwd_err = rel(emb, ref)
    g_exec, g_mod = grad_of(executor), grad_of(model)
    grad_err = rel(g_exec, g_mod)
    grad_norm_err = ((g_exec - g_mod).norm() / g_mod.norm()).item()
    # the same in fp64: the weights of both cast up, the host-side small
    # initializers (fp32 numbers) promoted by the ops
    w64 = {k: v.double() for k, v in fn.weights.items()}
    model64 = standins.seeded_iresnet(0).cuda().double()
    x64, t64 = x.double(), t.double()
    with torch.no_grad():
        fwd_err64 = rel(executor(x64, w64), model64(x64))
    grad_err64 = rel(grad_of(lambda v: executor(v, w64), x64, t64), grad_of(model64, x64, t64))
    del w64, model64
    with torch.no_grad():
        ms = {"executor": cuda_ms(lambda: executor(x), iters=10),
              "module": cuda_ms(lambda: model(x), iters=10)}
    ms_fb = {"executor": cuda_ms(lambda: grad_of(executor), iters=5),
             "module": cuda_ms(lambda: grad_of(model), iters=5)}
    log(f"[face] executor on iresnet100 ({len(fn.graph.nodes)} nodes: {', '.join(ops)}), batch "
        f"{FACE_BATCH}x3x112x112, against the module: fp64 output max|err| / max|out| "
        f"{fwd_err64:.2e}, input gradient of sum(emb * t) {grad_err64:.2e} (tol {FACE_REL64}); "
        f"fp32 output {fwd_err:.2e} (tol {FACE_REL}), gradient max {grad_err:.2e} and norm "
        f"{grad_norm_err:.2e} of the module's (not bounded: PReLU kinks); fp32 forward "
        f"{ms['executor']:.3f} ms (module {ms['module']:.3f} ms), forward+backward "
        f"{ms_fb['executor']:.3f} ms (module {ms_fb['module']:.3f} ms)")
    if not (fwd_err64 <= FACE_REL64 and grad_err64 <= FACE_REL64 and fwd_err <= FACE_REL):
        raise SystemExit("the ONNX executor disagrees with the torch module on the card")
    del model, fn
    ref_u8 = _u8(_inputs(512, 512, 1, 512, "cuda")[0][0])   # the generate phase's reference
    face_model = FaceModel(det_path, rec_path, device="cuda")
    t0 = time.perf_counter()
    target = face_model.get_id_embedding(ref_u8[..., ::-1])   # the reference channel order
    sec = time.perf_counter() - t0
    if target is None or not np.isfinite(target).all() or not np.any(target):
        raise SystemExit(f"FaceModel found no usable face in the reference: {target}")
    log(f"[face] FaceModel.get_id_embedding of the 512x512 reference on the card: "
        f"{len(face_model.detector(ref_u8[..., ::-1])[0])} faces, embedding {target.shape} "
        f"norm {np.linalg.norm(target):.4f} in {sec * 1e3:.1f} ms")
    return dict(root=root, rec_path=rec_path, target=target)


def _small_faceopt(root: str):
    """A micro face-opt generate (fp32, a small iresnet recogniser) on the
    card against the same on the CPU, within SMALL_ATOL."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate
    from stableanimator_tpu_torch.pipeline.face_opt import FaceOptConfig, make_face_optimizer
    from stableanimator_tpu_torch.preproc import standins
    from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

    rec = standins.export_onnx(
        standins.seeded_iresnet(0, layers=(1, 1, 1, 1), widths=(16, 32, 32, 64),
                                num_features=64),
        (torch.zeros(1, 3, 112, 112),), os.path.join(root, "small_rec.onnx"),
        constant_folding=False)
    cfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    seeded = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    ref, pose, face, aug = _inputs(64, 64, 4, 32, "cpu", seed=3)
    init = torch.randn((1, 4, 8, 8, 4), generator=torch.Generator().manual_seed(4))
    target = torch.randn(64, generator=torch.Generator().manual_seed(5)).numpy()
    out = {}
    for device in ("cpu", "cuda"):
        models = build_models(**micro_model_kwargs(), dtype=torch.float32, device=device,
                              seed=None)
        for a, b in zip(seeded, models):
            b.load_state_dict(a.state_dict())
        opt = make_face_optimizer(models, FaceOptConfig(steps=1, start_step=0),
                                  load_onnx_function(rec, device=device), target, pose, 8, 8)
        out[device] = generate(models, ref, pose, face, cfg, aug_noise=aug, init_noise=init,
                               face_opt=opt, device=device).cpu()
    err = (out["cpu"] - out["cuda"]).abs().max().item()
    log(f"[faceopt] micro face-opt generate fp32 (refine at both steps), card vs CPU: max abs "
        f"{err:.3e} tol {SMALL_ATOL}")
    if not err <= SMALL_ATOL:
        raise SystemExit("the micro face-opt generate on the card disagrees with the CPU")


def phase_faceopt(models, cfg, ref, pose, face, gen: dict, plain_frames, face_info: dict):
    """The generate phase's request (same models, inputs and seed) with the
    HJB face optimiser: FaceOptConfig(steps=1) (lr 0.1, start step 8), the
    iresnet100 stand-in as recogniser, its embedding of the reference as
    target, boxes from the seeded pose renders; at crop 16 (its decodes stay
    off the kernels), then at crop 32 (each refine runs the d = 512 forward
    with lse and the d = 512 backward pair). Warm-up and timed run of each;
    refines, launches, output and the identity cost at step 8 checked and
    printed; then the micro CLI with --face_optimize_steps."""
    _small_faceopt(face_info["root"])
    steps = cfg.num_inference_steps
    refines = max(steps - FACEOPT_START, 0)
    plain = {FWD_KERNEL: 10 * steps + 1, RES_KERNEL: 0, **{k: 0 for k in BWD_KERNELS}}
    results = _faceopt_request(models, cfg, ref, pose, face, gen, plain_frames, face_info,
                               16, plain)
    big = dict(plain, **{FWD_KERNEL: 10 * steps + 1 + refines, DKV512_KERNEL: refines,
                         DQ512_KERNEL: refines})
    results[f"crop{FACEOPT_BIG_CROP}"] = _faceopt_request(
        models, cfg, ref, pose, face, gen, plain_frames, face_info, FACEOPT_BIG_CROP, big)
    results["cli"] = _cli_faceopt(face_info["root"])
    return results


def _faceopt_request(models, cfg, ref, pose, face, gen: dict, plain_frames, face_info: dict,
                     crop: int, want: dict) -> dict:
    """One face-opt request at latent crop `crop`, warm-up and timed, its
    launches held to `want` (by kernel); the identity cost at step 8 before
    the refine and after one step along it."""
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import generate
    from stableanimator_tpu_torch.pipeline.face_opt import FaceOptConfig, make_face_optimizer
    from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function

    steps = cfg.num_inference_steps
    arc = load_onnx_function(face_info["rec_path"], device="cuda")
    opt = make_face_optimizer(models, FaceOptConfig(steps=1, latent_crop=crop), arc,
                              face_info["target"], pose, cfg.height // 8, cfg.width // 8,
                              channel_order="reference")
    refine = opt.refine
    refined_at, probe = [], {}

    def counting_refine(x0, i):
        out = refine(x0, i)
        if out is not x0:
            refined_at.append(int(i))
            if int(i) == FACEOPT_START:
                probe["x0"] = x0.clone()
        return out

    opt.refine = counting_refine
    plain_sec = gen["timed"]["seconds"]
    tag = f"[faceopt] crop {crop}"
    results = {}
    for run in ("warm-up", "timed"):
        refined_at.clear()
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        frames = generate(models, ref, pose, face, cfg, device="cuda", timings=timings,
                          face_opt=opt)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = _launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(frames).all())
        lo, hi = frames.min().item(), frames.max().item()
        moved = (frames - plain_frames).abs()
        log(f"{tag} {run}: {total:.2f} s (plain request {plain_sec:.2f} s: overhead "
            f"{total - plain_sec:.2f} s, x{total / plain_sec:.3f}); phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
            + f"; peak {peak_gb:.1f} GiB; {len(refined_at)} refines (at steps {refined_at}); "
            "launches "
            + ", ".join(f"{k} {n}" for k, n in counts["by_kernel"].items())
            + f" (expected {want}); by shape "
            + ", ".join(f"{k}: {n}" for k, n in counts["by_shape"].items())
            + f"; out {tuple(frames.shape)} finite={finite} range [{lo:.4f}, {hi:.4f}]; "
            f"against the plain request's frames max|diff| {moved.max().item():.4f} mean "
            f"{moved.mean().item():.5f}")
        checks = {
            f"{max(steps - FACEOPT_START, 0)} refines": len(refined_at) == max(steps -
                                                                               FACEOPT_START, 0),
            f"launches {want}": counts["by_kernel"] == want,
            "frames finite in [0, 1]": finite and lo >= 0.0 and hi <= 1.0,
            "frames differ from the plain request's": moved.max().item() > 0.0,
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise SystemExit(f"the face-opt request at crop {crop} ({run}) failed its checks: "
                             f"{failed}")
        results[run] = dict(seconds=total, phases=timings, peak_gib=peak_gb,
                            refines=len(refined_at), **counts)
    if "x0" in probe:
        # the cost along the refine's own direction, at its lr and larger ones
        along = {}
        for lr in (opt.cfg.lr, 1.0, 10.0, 100.0):
            step = opt.with_boxes(opt.face_boxes)
            step.cfg = dataclasses.replace(opt.cfg, lr=lr)
            with torch.inference_mode():
                along[lr] = step.identity_cost(step.refine(probe["x0"], FACEOPT_START)).item()
        with torch.inference_mode():
            before = opt.identity_cost(probe["x0"]).item()
        log(f"{tag} identity cost at step {FACEOPT_START}: {before:.6f} before the refine; "
            "after one step at lr " + ", ".join(f"{lr:g}: {c:.6f}" for lr, c in along.items()))
        results["identity_cost"] = dict(before=before, after=along)
    del opt.refine      # the counter closes a cycle through opt that would keep the models
    return results


def phase_export(models, cfg) -> dict:
    """The generate phase's full-width bf16 UNet through
    `tools/export_model.py::export_unet` at the flat request's call (the
    CFG pair of 16 frames at 512x512): the graph holds the kernel's custom
    op; the exported program's module launches the kernel at both UNet
    levels and matches the eager module within `kernel_tolerance`. Export
    seconds, and the two modules' times per call. Then the tool's deployment
    path, a program saved and loaded back, at a small scale
    (`_export_roundtrip`)."""
    from stableanimator_tpu_torch.ops import flash_attention as fa
    from stableanimator_tpu_torch.tools import export_model as em

    unet = models.unet
    b, f, h8, w8 = 2, cfg.num_frames, cfg.height // 8, cfg.width // 8
    t0 = time.perf_counter()
    program = em.export_unet(unet, b, f, h8, w8)
    t_export = time.perf_counter() - t0
    ops = collections.Counter(str(n.target) for n in program.graph.nodes
                              if n.op == "call_function" and
                              str(n.target).startswith("stableanimator."))
    exported = program.module()
    del program
    args = em.unet_inputs(unet, b, f, h8, w8, "cuda", seed=1)
    with torch.no_grad():
        fa.reset_launch_counts()
        got = exported(*args)
        torch.cuda.synchronize()
        by_shape = dict(fa.flash_attention.launches_by_shape)
        want = unet(*args)
        share = ((got.float() - want.float()).abs() / fa.kernel_tolerance(want)).max().item()
        ms = {"eager": cuda_ms(lambda: unet(*args), iters=3, warmup=1),
              "exported": cuda_ms(lambda: exported(*args), iters=3, warmup=1)}
    expected = {(b * f, h8 * w8, h8 * w8, 5, 64): 5, (b * f, h8 * w8 // 4, h8 * w8 // 4, 10, 64): 5}
    log(f"[export] full-width UNet at [{b}, {f}, {h8}, {w8}, 8]: export {t_export:.1f} s; "
        f"custom-op nodes {dict(ops)}; the exported program's flash launches {by_shape} "
        f"(expected {expected}); output {tuple(got.shape)} {str(got.dtype)[6:]}, max "
        f"|exported - eager| "
        f"{(got.float() - want.float()).abs().max().item():.3e}, {share:.3f} of "
        f"kernel_tolerance; ms per call eager {ms['eager']:.1f}, exported {ms['exported']:.1f}")
    checks = {"the custom op in the graph": ops.get("stableanimator.flash_attention_fwd.default", 0)
              == 10,
              "kernel launches from the exported program": by_shape == expected,
              "output within kernel_tolerance of the eager module": share <= 1.0}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the exported UNet failed its checks: {failed}")
    del exported
    torch.cuda.empty_cache()
    return dict(export_s=t_export, ms=ms, max_share=share, roundtrip=_export_roundtrip())


def _export_roundtrip() -> dict:
    """`tools/export_model.py`'s deployment path on the card, at a small
    scale: the micro UNet with one 64-wide head a level (the kernel's d),
    bf16, exported at the CFG pair of 2 frames of 256x256 (level 0: 1024
    tokens, the kernel's route), saved with torch.export.save and loaded
    back from the bytes; the reloaded module launches the kernel as the
    eager module does (the custom op deserialised) and matches it within
    `kernel_tolerance`."""
    from stableanimator_tpu_torch.core.config import micro_model_kwargs
    from stableanimator_tpu_torch.ops import flash_attention as fa
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.tools import export_model as em

    kw = micro_model_kwargs()
    kw["unet_cfg"] = dataclasses.replace(kw["unet_cfg"], block_out_channels=(64,) * 4,
                                         num_attention_heads=(1,) * 4)
    unet = build_models(**kw, dtype=torch.bfloat16, device="cuda", seed=0).unet
    b, f, h8, w8 = 2, 2, 32, 32
    sec = [time.perf_counter()]
    program = em.export_unet(unet, b, f, h8, w8)
    sec.append(time.perf_counter())
    buf = io.BytesIO()
    torch.export.save(program, buf)
    size = buf.getbuffer().nbytes
    sec.append(time.perf_counter())
    buf.seek(0)
    reloaded = torch.export.load(buf).module()
    sec.append(time.perf_counter())
    export_s, save_s, load_s = (t1 - t0 for t0, t1 in zip(sec, sec[1:]))
    args = em.unet_inputs(unet, b, f, h8, w8, "cuda", seed=1)
    with torch.no_grad():
        fa.reset_launch_counts()
        want = unet(*args)
        torch.cuda.synchronize()
        eager = dict(fa.flash_attention.launches_by_shape)
        fa.reset_launch_counts()
        got = reloaded(*args)
        torch.cuda.synchronize()
        by_shape = dict(fa.flash_attention.launches_by_shape)
    share = ((got.float() - want.float()).abs() / fa.kernel_tolerance(want)).max().item()
    log(f"[export] micro UNet (one 64-wide head a level) at [{b}, {f}, {h8}, {w8}, 8]: export "
        f"{export_s:.1f} s, save {save_s:.1f} s ({size / 1e6:.1f} MB), load {load_s:.1f} s; the "
        f"reloaded program's flash launches {by_shape} (the eager module's {eager}); max "
        f"|reloaded - eager| "
        f"{(got.float() - want.float()).abs().max().item():.3e}, {share:.3f} of "
        "kernel_tolerance")
    checks = {"kernel launches from the reloaded program": bool(by_shape) and by_shape == eager,
              "output within kernel_tolerance of the eager module": share <= 1.0}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the saved and reloaded UNet failed its checks: {failed}")
    return dict(export_s=export_s, save_s=save_s, load_s=load_s, bytes=size,
                launches=by_shape, max_share=share)


def _cli_faceopt(root: str) -> dict:
    """`cli.animate.main` in this process at the micro scale on the card,
    with the stand-in antelopev2 files in the checkpoint dir and
    --face_optimize_steps 1 from step 1 of 4."""
    import numpy as np
    from PIL import Image

    from stableanimator_tpu_torch.cli import animate

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        Image.fromarray(rng.integers(0, 255, (80, 72, 3), dtype=np.uint8)).save(
            os.path.join(tmp, "ref.png"))
        os.makedirs(os.path.join(tmp, "poses"))
        for i in range(6):
            img = np.zeros((64, 64, 3), np.uint8)
            img[10 + 3 * i:30 + 3 * i, 20:40] = 255
            Image.fromarray(img).save(os.path.join(tmp, "poses", f"frame_{i}.png"))
        out = os.path.join(tmp, "out")
        argv = ["--checkpoint_dir", root, "--reference_image", os.path.join(tmp, "ref.png"),
                "--pose_control_folder", os.path.join(tmp, "poses"), "--output_dir", out,
                "--height", "64", "--width", "64", "--tile_size", "4", "--frames_overlap", "1",
                "--num_inference_steps", "4", "--decode_chunk_size", "2", "--model_scale",
                "micro", "--allow_random_init", "--device", "cuda", "--face_optimize_steps",
                "1", "--face_opt_start_step", "1"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee()) as printed:
            info = animate.main(argv)
        wall = time.perf_counter() - t0
        text = printed.getvalue()
        pngs = sorted(os.listdir(os.path.join(out, "animated_images")))
        files = [os.path.exists(os.path.join(out, f"animation_video.{e}")) for e in ("gif", "mp4")]
    log(f"[faceopt] micro CLI with --face_optimize_steps 1: {wall:.1f} s, face_opt "
        f"{info['face_opt']}, {len(pngs)} PNGs, gif/mp4 {files}")
    checks = {"the HJB face optimization line": "HJB face optimization" in text,
              "no zero identity embedding": "zero identity embedding" not in text,
              "face optimisation ran": info["face_opt"],
              "6 PNGs, a GIF and an mp4": len(pngs) == 6 and all(files)}
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the micro face-opt CLI run failed its checks: {failed}")
    return dict(seconds=info["seconds"], wall=wall)


def phase_serve(root: str, gen: dict | None, steps: int) -> dict:
    """cli.serve's AnimationService at full width (seeded weights, the
    stand-in antelopev2 files in its checkpoint dir, so FaceModel runs) behind
    make_handler on 127.0.0.1, port 0, in a thread: /healthz, two 512x512x16
    POST /animate requests (mp4, json), a 400 (bad size) and a 413 (over
    --max_request_mb); launches per request asserted."""
    import base64
    import http.client
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    from PIL import Image

    from stableanimator_tpu_torch.cli import serve
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts

    def b64_png(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def request(addr, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection(*addr, timeout=600)
        if headers is not None:           # a bare request with these headers, no body
            conn.putrequest(method, path)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
        else:
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"} if body else {})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, resp.getheader("Content-Type"), data

    args = serve.parse_args(["--checkpoint_dir", root, "--allow_random_init", "--port", "0",
                             "--num_inference_steps", str(steps), "--device", "cuda"])
    before_gb = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    service = serve.AnimationService(args)
    torch.cuda.synchronize()
    log(f"[serve] AnimationService at full width ({args.height}x{args.width}, {steps} steps, "
        f"seeded weights, face model {'on' if service.face_model else 'OFF'}) in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated ({before_gb:.2f} GiB before it)")
    if service.face_model is None:
        raise SystemExit("the server did not load the stand-in antelopev2 face model")
    ref, pose, _, _ = _inputs(512, 512, 16, 512, "cuda")
    body = {"reference": b64_png(_u8(ref[0])),
            "poses": [b64_png(p) for p in _u8((pose + 1.0) / 2.0)]}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    gen_sec = gen["timed"]["seconds"] if gen else float("nan")
    want = {FWD_KERNEL: 10 * steps + 1, RES_KERNEL: 0, **{k: 0 for k in BWD_KERNELS}}
    results = {"requests": []}
    try:
        addr = httpd.server_address
        status, _, data = request(addr, "GET", "/healthz")
        health = json.loads(data)
        log(f"[serve] GET /healthz: {status} {health}")
        if status != 200 or health["device"] != torch.cuda.get_device_name(0):
            raise SystemExit(f"/healthz answered {status} {health}")
        for fmt in ("mp4", "json"):
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            status, ctype, data = request(addr, "POST", "/animate", dict(body, format=fmt))
            wall = time.perf_counter() - t0
            counts = _launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            held_gb = torch.cuda.memory_allocated() / 2**30
            served = (json.loads(data)["seconds"] if fmt == "json" and status == 200
                      else float("nan"))
            mp4 = base64.b64decode(json.loads(data)["mp4"]) if fmt == "json" else data
            log(f"[serve] POST /animate 16 frames {fmt}: {status} {ctype}, {len(data)} bytes in "
                f"{wall:.2f} s at the client (server's generate {served:.2f} s; the generate "
                f"phase's timed request {gen_sec:.2f} s); peak {peak_gb:.1f} GiB, "
                f"{held_gb:.2f} GiB allocated after it; launches "
                + ", ".join(f"{k} {n}" for k, n in counts["by_kernel"].items()))
            if status != 200 or b"ftyp" not in mp4[:64] or counts["by_kernel"] != want:
                raise SystemExit(f"POST /animate ({fmt}) answered {status}, launches "
                                 f"{counts['by_kernel']} (expected {want})")
            results["requests"].append(dict(format=fmt, wall=wall, seconds=served,
                                            peak_gib=peak_gb, held_gib=held_gb, **counts))
        results["peak_gib"] = max(r["peak_gib"] for r in results["requests"])
        status_400, _, data_400 = request(addr, "POST", "/animate", dict(body, height=100))
        status_413, _, data_413 = request(addr, "POST", "/animate", headers={
            "Content-Type": "application/json", "Content-Length": str(10**12)})
        log(f"[serve] bad size: {status_400} {data_400[:80]!r}; 10^12-byte claim: {status_413} "
            f"{data_413[:80]!r}; peak {results['peak_gib']:.1f} GiB over the two requests")
        if (status_400, status_413) != (400, 413):
            raise SystemExit(f"the rejections answered {status_400} and {status_413}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    del service
    return results


def _train_steps(state, step_fn, batch, generator, tag: str, expected: dict):
    """One warm-up and TRAIN_TIMED_STEPS timed steps of `step_fn` on `batch`;
    loss and grad_norm finite, the launches of every kernel equal to
    `expected`, and the sampled fp32 masters moved by every update at a
    nonzero lr (update 0 runs at lr 0). Returns the steps' records and the
    timed steps' mean seconds and phases."""
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts

    b, f, h, w, _ = batch["frames"].shape
    # a sample of every master: the first 4096 elements of each tensor
    sample = [m.flatten()[:4096].clone() for m in state.masters]
    steps = []
    for i in range(1 + TRAIN_TIMED_STEPS):
        run = "warm-up" if i == 0 else f"timed {i}"
        torch.cuda.reset_peak_memory_stats()
        timings: dict = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, generator=generator, timings=timings)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = _launch_counts()
        loss, gn = metrics["loss"].item(), metrics["grad_norm"].item()
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        moved = sum(int((m.flatten()[:4096] != s).sum()) for m, s in zip(state.masters, sample))
        sample = [m.flatten()[:4096].clone() for m in state.masters]
        lr = state.optimizer.param_groups[0]["lr"]
        log(f"[train] {tag}step {state.step} ({run}, update {state.updates - 1} at lr "
            f"{lr:.3e}): {total:.3f} s; phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f"; peak {peak_gb:.1f} GiB; loss {loss:.5f} grad_norm {gn:.4f}; sampled masters "
            f"moved {moved} of {sum(s.numel() for s in sample)}; launches "
            + ", ".join(f"{k} {n}" for k, n in counts["by_kernel"].items()))
        if not (torch.isfinite(torch.tensor([loss, gn])).all() and gn > 0):
            raise SystemExit(f"{tag}training step {state.step}: loss {loss}, grad_norm {gn}")
        if counts["by_kernel"] != expected:
            raise SystemExit(f"{tag}training step launched {counts['by_kernel']}, expected "
                             f"{expected}")
        if lr > 0 and moved == 0:
            raise SystemExit(f"the fp32 master parameters did not move in update "
                             f"{state.updates - 1} at lr {lr}")
        steps.append(dict(seconds=total, phases=timings, loss=loss, grad_norm=gn,
                          peak_gib=peak_gb, **counts))
    timed = steps[1:]
    sec = sum(s["seconds"] for s in timed) / len(timed)
    phases = {k: sum(s["phases"][k] for s in timed) / len(timed) for k in timed[0]["phases"]}
    peak = max(s["peak_gib"] for s in steps)
    log(f"[train] {tag}{len(timed)} timed steps: {sec:.3f} s/step, {3600.0 / sec:.1f} clips/hour "
        f"({b} clip of {f} frames at {h}x{w} (height x width) per step); phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; peak {peak:.1f} GiB of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f} GiB")
    return dict(steps=steps, sec_per_step=sec, phases=phases, peak_gib=peak)


def phase_train():
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.train.train_step import create_train_state, make_train_step

    t0 = time.perf_counter()
    # fp32 first: create_train_state keeps fp32 masters and stores the
    # models in bf16
    models = build_models(dtype=torch.float32, device="cuda", seed=0, remat=True)
    cfg = TrainConfig()
    state = create_train_state(models, cfg)
    torch.cuda.synchronize()
    n_train = sum(m.numel() for m in state.masters)
    log(f"[train] built full-size models and the train state ({n_train / 1e9:.3f} B trainable "
        f"parameters: {', '.join(state.trainable)}; {cfg.mixed_precision}, remat, AdamW lr "
        f"{cfg.learning_rate} warm-up {cfg.lr_warmup_steps}, clip {cfg.max_grad_norm}) in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        "allocated")
    pipe = PipelineConfig()
    step_fn = make_train_step(models, cfg, pipe)
    id_dim = models.face_encoder.config.id_embeddings_dim
    batch = _train_batch(1, cfg.sample_n_frames, pipe.height, pipe.width, id_dim, "cuda")
    generator = torch.Generator(device="cuda").manual_seed(0)
    out = _train_steps(state, step_fn, batch, generator, "", TRAIN_LAUNCHES)
    # the vertical bucket on the same state, as MixedResolutionSampler
    # alternates buckets (the step takes any frame size)
    vbatch = _train_batch(1, cfg.sample_n_frames, *VERTICAL_HW, id_dim, "cuda", seed=1)
    out["vertical"] = _train_steps(state, step_fn, vbatch, generator, "vertical ",
                                   VTRAIN_LAUNCHES)
    return out


def _write_dataset(root: str, n_frames: int, hw: int) -> str:
    """One clip of PNG frames, poses and face masks in the training layout;
    returns the path-list file."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    clip = os.path.join(root, "clip0")
    for sub in ("images", "poses", "faces"):
        os.makedirs(os.path.join(clip, sub))
    for i in range(n_frames):
        Image.fromarray(rng.integers(0, 255, (hw, hw, 3), dtype=np.uint8)).save(
            os.path.join(clip, "images", f"{i:05d}.png"))
        pose = np.zeros((hw, hw, 3), np.uint8)
        pose[10 + i:30 + i, 20:40] = 255
        Image.fromarray(pose).save(os.path.join(clip, "poses", f"{i:05d}.png"))
        mask = np.zeros((hw, hw), np.uint8)
        mask[8:24, 24:40] = 255
        Image.fromarray(mask).save(os.path.join(clip, "faces", f"{i:05d}.png"))
    listing = os.path.join(root, "rec.txt")
    with open(listing, "w") as fh:
        fh.write(clip + "\n")
    return listing


def train_cli():
    """`python -m stableanimator_tpu_torch.cli.train --model_scale micro` on
    the card for 2 steps, then a resume from `latest` to step 3."""
    with tempfile.TemporaryDirectory() as tmp:
        listing = _write_dataset(tmp, n_frames=4, hw=128)
        out = os.path.join(tmp, "out")
        common = [sys.executable, "-m", "stableanimator_tpu_torch.cli.train",
                  "--checkpoint_dir", os.path.join(tmp, "nockpt"), "--output_dir", out,
                  "--data_root_path", tmp, "--rec_data_path", listing,
                  "--dataset_width", "128", "--dataset_height", "128", "--sample_n_frames", "2",
                  "--model_scale", "micro", "--allow_random_init", "--gradient_checkpointing",
                  "--checkpointing_steps", "2", "--num_workers", "2"]
        here = os.path.dirname(os.path.abspath(__file__))
        for extra in (["--max_train_steps", "2"],
                      ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"]):
            t0 = time.perf_counter()
            proc = subprocess.run(common + extra, cwd=here, capture_output=True, text=True,
                                  timeout=300)
            lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith("WARNING")]
            log(f"[train] cli {' '.join(extra)}: rc {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s: {' | '.join(lines)}")
            if proc.returncode != 0:
                raise SystemExit(f"the training CLI failed:\n{proc.stderr[-3000:]}")
        saved = sorted(int(d) for d in os.listdir(out) if d.isdigit())
        with open(os.path.join(out, "metrics.jsonl")) as fh:
            n_metrics = sum(1 for _ in fh)
        log(f"[train] cli checkpoints {saved}, {n_metrics} metrics lines")
        if saved != [2, 3] or "resumed from step 2" not in proc.stdout:
            raise SystemExit(f"the CLI's resume did not continue from step 2: {saved}")


def category(kernel_name: str) -> str:
    """The profile's category of a device kernel: the first of CATEGORIES
    whose pattern its name matches, else "other"."""
    return next((c for c, pat in CATEGORIES if re.search(pat, kernel_name, re.I)), "other")


def _profile(label: str, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the host ops that launched them carry the
    # same time again as their "self device time"
    rows = [(ev.self_device_time_total / 1e6, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    handover = time.perf_counter() - t0 - wall
    busy = sum(r[0] for r in rows)
    log(f"[profile] {label} under the profiler: wall {wall:.3f} s, device kernel time "
        f"{busy:.3f} s, busy share {busy / wall if wall else 0:.3f}, idle share "
        f"{1 - busy / wall if wall else 0:.3f}; the profiler's hand-over of its events "
        f"{handover:.1f} s")
    if not rows:
        log("[profile] the profiler saw no device time")
        return
    cats: dict = {}
    for sec, _, name in rows:
        cat = category(name)
        cats[cat] = cats.get(cat, 0.0) + sec
    log(f"[profile] {label}: device time by category: " + ", ".join(
        f"{c} {v:.3f} s ({v / busy:.1%})" for c, v in sorted(cats.items(), key=lambda x: -x[1])))
    for sec, count, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {sec:8.3f} s  {count:6d}x  {name[:110]}")


def profile_generate(models, cfg, ref, pose, face):
    from stableanimator_tpu_torch.pipeline.animation import generate

    cfg = dataclasses.replace(cfg, num_inference_steps=min(PROFILE_STEPS,
                                                           cfg.num_inference_steps))
    _profile(f"one {cfg.num_inference_steps}-step request",
             lambda: generate(models, ref, pose, face, cfg, device="cuda"))


# ---------------------------------------------------------------------------
# parallel and quant (the (data, frame) mesh on torch.distributed, the int8
# path)
# ---------------------------------------------------------------------------

def _nccl_check(mesh):
    """all_reduce, all_gather and all_to_all_single over the mesh's groups
    on a card tensor: NCCL takes them in this world (of one rank, each the
    identity)."""
    import torch.distributed as dist

    x = torch.arange(8.0, device="cuda")
    for axis in ("data", "frame"):
        group = mesh.group(axis)
        y = x.clone()
        dist.all_reduce(y, group=group)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        z = torch.empty_like(x)
        dist.all_to_all_single(z, x, group=group)
        if not (torch.equal(y, x * dist.get_world_size(group)) and torch.equal(parts[0], x)
                and torch.equal(z, x)):
            raise SystemExit(f"NCCL collectives over the {axis} group gave wrong values")


def _zero_bytes(masters, ns=(1, 2, 4, 8)) -> dict:
    """Per-rank bytes of AdamW's two fp32 moments under ZeRO-1 at each data
    axis size n (`zero_sharding_for`'s rule on the masters' shapes),
    reckoned, not run."""
    from types import SimpleNamespace

    from stableanimator_tpu_torch.parallel.mesh import zero_sharding_for

    out = {}
    for n in ns:
        fake = SimpleNamespace(shape={"data": n, "frame": 1})
        out[n] = 8 * sum(m.numel() // n if any(zero_sharding_for(m, fake).spec) else m.numel()
                         for m in masters)
    return out


def _parallel_train(mesh) -> dict:
    """One full-width training step through make_train_step(mesh=) with
    ZeRO-1 beside the one-device step on the same batch, noises and seed
    (update 0, at lr 0, so the masters stay and every state sees the same
    weights): two one-device steps first, from two fresh states, give the
    run-to-run spread of loss and grad_norm."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.train.train_step import create_train_state, make_train_step

    models = build_models(dtype=torch.float32, device="cuda", seed=0, remat=True)
    cfg, pipe = TrainConfig(), PipelineConfig()
    batch = _train_batch(1, cfg.sample_n_frames, pipe.height, pipe.width,
                         models.face_encoder.config.id_embeddings_dim, "cuda")
    runs = {}
    zero = n_train = None
    for run in ("one-device", "one-device again", "mesh (ZeRO-1)"):
        on_mesh = run.startswith("mesh")
        state = create_train_state(models, cfg, mesh=mesh if on_mesh else None)
        if zero is None:
            zero = _zero_bytes(state.masters)
            n_train = sum(m.numel() for m in state.masters)
        step_fn = make_train_step(models, cfg, pipe, mesh=mesh if on_mesh else None)
        generator = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, generator=generator)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        runs[run] = dict(seconds=sec, loss=metrics["loss"].item(),
                         grad_norm=metrics["grad_norm"].item(),
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30, **counts)
        log(f"[parallel] train step, {run}: {sec:.3f} s, loss {runs[run]['loss']!r}, grad_norm "
            f"{runs[run]['grad_norm']!r}, peak {runs[run]['peak_gib']:.1f} GiB, launches "
            + ", ".join(f"{k} {n}" for k, n in counts["by_kernel"].items()))
        if counts["by_kernel"] != TRAIN_LAUNCHES:
            raise SystemExit(f"{run} training step launched {counts['by_kernel']}")
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    a, b, m = runs["one-device"], runs["one-device again"], runs["mesh (ZeRO-1)"]
    ok = True
    for key in ("loss", "grad_norm"):
        spread = max(abs(a[key] - b[key]), PARALLEL_SPREAD_FLOOR * abs(a[key]))
        diff = abs(m[key] - a[key])
        log(f"[parallel] {key}: mesh - one-device {diff:.3e}, one-device run-to-run "
            f"{abs(a[key] - b[key]):.3e}, bound {spread:.3e}")
        ok &= diff <= spread
    log(f"[parallel] ZeRO-1 optimizer bytes per rank (AdamW's fp32 moments of the "
        f"{n_train / 1e9:.3f} B trainable parameters; reckoned): "
        + ", ".join(f"data {n}: {v / 1e9:.3f} GB" for n, v in zero.items()))
    if not ok:
        raise SystemExit("the mesh training step disagrees with the one-device step")
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, zero_bytes=zero)


def _torchrun_cli():
    """The training CLI under torchrun (one process, NCCL): 2 micro steps,
    then a resume from `latest` to step 3."""
    with tempfile.TemporaryDirectory() as tmp:
        listing = _write_dataset(tmp, n_frames=4, hw=128)
        out = os.path.join(tmp, "out")
        common = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                  "--nproc_per_node", "1", "-m", "stableanimator_tpu_torch.cli.train",
                  "--checkpoint_dir", os.path.join(tmp, "nockpt"), "--output_dir", out,
                  "--data_root_path", tmp, "--rec_data_path", listing,
                  "--dataset_width", "128", "--dataset_height", "128", "--sample_n_frames", "2",
                  "--model_scale", "micro", "--allow_random_init", "--gradient_checkpointing",
                  "--checkpointing_steps", "2", "--num_workers", "2"]
        here = os.path.dirname(os.path.abspath(__file__))
        for extra in (["--max_train_steps", "2"],
                      ["--max_train_steps", "3", "--resume_from_checkpoint", "latest"]):
            t0 = time.perf_counter()
            proc = subprocess.run(common + extra, cwd=here, capture_output=True, text=True,
                                  timeout=300)
            lines = [ln for ln in proc.stdout.splitlines() if not ln.startswith("WARNING")]
            log(f"[parallel] torchrun cli {' '.join(extra)}: rc {proc.returncode} in "
                f"{time.perf_counter() - t0:.1f} s: {' | '.join(lines)}")
            if proc.returncode != 0:
                raise SystemExit(f"the training CLI under torchrun failed:\n{proc.stderr[-3000:]}")
        saved = sorted(int(d) for d in os.listdir(out) if d.isdigit())
        if (saved != [2, 3] or "resumed from step 2" not in proc.stdout
                or "mesh: 1 devices, global batch 1" not in proc.stdout):
            raise SystemExit(f"the torchrun CLI's run and resume: {saved}")


def _gloo_probe(mesh) -> dict:
    """Which of the collectives that the frame-sharded step runs gloo takes
    on card tensors in this world: each one's outcome, "accepted" (the
    right values), "wrong values" or "refused: <error>"."""
    import torch.distributed as dist

    group = mesh.group("frame")
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = torch.arange(2.0 * n, device="cuda") + 100 * r
    out = {}

    def probe(name, fn):
        try:
            out[name] = "accepted" if fn() else "wrong values"
        except RuntimeError as e:        # the probe reports, the step never falls back
            out[name] = f"refused: {str(e).splitlines()[0][:200]}"

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return all(torch.equal(p, x - 100 * r + 100 * i) for i, p in enumerate(parts))

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        want = torch.cat([torch.arange(2.0 * r, 2.0 * r + 2, device="cuda") + 100 * i
                          for i in range(n)])
        return torch.equal(y, want)

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=mesh.src_rank("frame"), group=group)
        return torch.equal(y, x - 100 * r)

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=group)
        return torch.equal(y, n * (x - 100 * r) + 100 * sum(range(n)))

    for fn in (all_gather, all_to_all_single, broadcast, all_reduce):
        probe(fn.__name__, fn)
    return out


def _frame_micro(mesh, tmp: str) -> dict:
    """Two fp32 micro training steps on the card, this rank's block of the
    batch (tmp/micro_inputs.pt: weights, batch, draws)."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.train.train_step import (
        create_train_state,
        make_train_step,
        shard_batch,
    )

    probe = _gloo_probe(mesh)
    log(f"[parallel] gloo on card tensors, world {mesh.size} on one card: "
        + ", ".join(f"{k} {v}" for k, v in probe.items()))
    if any(v != "accepted" for v in probe.values()):
        raise SystemExit(f"gloo does not take every collective on card tensors: {probe}")
    inputs = torch.load(os.path.join(tmp, "micro_inputs.pt"), weights_only=False)
    models = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cuda", seed=None)
    for m, sd in zip(models, inputs["state_dicts"]):
        m.load_state_dict(sd)
    cfg = TrainConfig(mixed_precision="no", learning_rate=SMALL_TRAIN_LR, lr_warmup_steps=1)
    state = create_train_state(models, cfg, mesh=mesh)
    step_fn = make_train_step(models, cfg, PipelineConfig(), conditioning_dropout_prob=0.0,
                              mesh=mesh)
    batch = shard_batch({k: v.to("cuda") for k, v in inputs["batch"].items()}, mesh)
    metrics = []
    for noises in inputs["noises"]:
        state, m = step_fn(state, batch, noises={k: v.to("cuda") for k, v in noises.items()})
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return {"probe": probe, "metrics": metrics, "masters": [m.cpu() for m in state.masters]}


def _frame_full(mesh, tmp: str) -> dict:
    """FRAME_STEPS full-width training steps (TrainConfig defaults, remat,
    1x16x512x512, the one-device runs' batch and generator seed) on this
    rank's 8 frames; each step's seconds, peak memory, launches (which must
    be TRAIN_LAUNCHES), loss and grad_norm."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.train.train_step import (
        create_train_state,
        make_train_step,
        shard_batch,
    )

    t0 = time.perf_counter()
    models = build_models(dtype=torch.float32, device="cuda", seed=0, remat=True)
    cfg, pipe = TrainConfig(), PipelineConfig()
    state = create_train_state(models, cfg, mesh=mesh)
    step_fn = make_train_step(models, cfg, pipe, mesh=mesh)
    batch = shard_batch(_train_batch(1, cfg.sample_n_frames, pipe.height, pipe.width,
                                     models.face_encoder.config.id_embeddings_dim, "cuda"), mesh)
    generator = torch.Generator(device="cuda").manual_seed(0)
    rank = mesh.axis_index(("data", "frame"))
    log(f"[parallel] frame rank {rank}: models and ZeRO-1 state built in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"allocated; frames {tuple(batch['frames'].shape)}")
    steps = []
    for i in range(FRAME_STEPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timings: dict = {}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, generator=generator, timings=timings)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        step = dict(seconds=sec, phases=timings, loss=metrics["loss"].item(),
                    grad_norm=metrics["grad_norm"].item(),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30, **counts)
        steps.append(step)
        log(f"[parallel] frame rank {rank} step {i + 1}: {sec:.3f} s; phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f"; peak {step['peak_gib']:.2f} GiB; loss {step['loss']!r} grad_norm "
            f"{step['grad_norm']!r}; launches "
            + ", ".join(f"{k} {n}" for k, n in counts["by_kernel"].items()))
        if counts["by_kernel"] != TRAIN_LAUNCHES:
            raise SystemExit(f"frame rank {rank} step {i + 1} launched {counts['by_kernel']}")
    held = 4 * sum(v.numel() for st in state.optimizer.state.values() for v in st.values()
                   if v.dim() > 0)
    return {"steps": steps, "moment_bytes": held}


def _frame_worker(task: str, rank: int, world: int, tmp: str) -> int:
    """One rank of the parallel phase's frame-sharded runs, a process of its
    own (`python3 chip_smoke.py --frame_worker TASK --rank R --world N
    --tmp DIR`): a gloo world of `world` processes on the one card (its
    FileStore in tmp), a 1 x world mesh, TASK ("micro" or "full"); its
    result goes to tmp/<task><rank>.pt."""
    import torch.distributed as dist

    from stableanimator_tpu_torch.parallel import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"{task}_store"),
                                                         world), rank=rank, world_size=world)
    try:
        mesh = make_mesh(1, world, device="cuda")          # the gloo world's
        out = {"micro": _frame_micro, "full": _frame_full}[task](mesh, tmp)
        torch.save(out, os.path.join(tmp, f"{task}{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _frame_ranks(task: str, tmp: str, timeout: float, while_running=None):
    """Run `task` in FRAME_RANKS processes on the card (`_frame_worker`);
    call while_running() meanwhile; print each rank's log; their results in
    rank order, and while_running's result. Every rank is stopped before
    this returns; a rank that fails fails the run."""
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, "--frame_worker", task, "--rank", str(r),
                               "--world", str(FRAME_RANKS), "--tmp", tmp],
                              cwd=os.path.dirname(here), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(FRAME_RANKS)]
    logs = []
    try:
        side = while_running() if while_running is not None else None
        deadline = time.monotonic() + timeout
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, text in enumerate(logs):
        for line in text.splitlines():
            if not line.startswith("WARNING") and "UserWarning" not in line:
                log(f"[parallel] rank {r} | {line}")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise SystemExit(f"the frame-sharded {task} ranks failed: {bad}")
    return [torch.load(os.path.join(tmp, f"{task}{r}.pt"), weights_only=False)
            for r in range(FRAME_RANKS)], side


def _frame_micro_check(tmp: str):
    """The micro fp32 step on a 1 x 2 frame mesh of two processes on the
    card against the same two steps in one CPU process (the gloo probe
    first, in the ranks)."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models
    from stableanimator_tpu_torch.train.train_step import (
        create_train_state,
        draw_noises,
        make_train_step,
    )

    cpu = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    batch = _train_batch(1, 4, 128, 128, cpu.face_encoder.config.id_embeddings_dim, "cpu",
                         seed=1)
    gen = torch.Generator().manual_seed(2)
    noises = [draw_noises(batch, 4, 0.0, None, gen) for _ in range(2)]
    torch.save({"state_dicts": [m.state_dict() for m in cpu], "batch": batch,
                "noises": noises}, os.path.join(tmp, "micro_inputs.pt"))
    cfg = TrainConfig(mixed_precision="no", learning_rate=SMALL_TRAIN_LR, lr_warmup_steps=1)

    def one_process():
        state = create_train_state(cpu, cfg)
        before = [m.clone() for m in state.masters]
        step_fn = make_train_step(cpu, cfg, PipelineConfig(), conditioning_dropout_prob=0.0)
        metrics = []
        for nz in noises:
            state, m = step_fn(state, batch, noises=nz)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        return metrics, state.masters, before

    ranks, (m_cpu, p_cpu, before) = _frame_ranks("micro", tmp, 300, one_process)
    for r, got in enumerate(ranks):
        rel = max(abs(a - b) / abs(a) for x, y in zip(m_cpu, got["metrics"])
                  for a, b in zip(x, y))
        diff = torch.cat([(a - b).flatten() for a, b in zip(got["masters"], p_cpu)])
        upd_cpu = torch.cat([(a - b).flatten() for a, b in zip(p_cpu, before)])
        upd = torch.cat([(a - b).flatten() for a, b in zip(got["masters"], before)])
        decided = (upd_cpu.abs() > SMALL_TRAIN_LR / 2) & (upd.abs() > SMALL_TRAIN_LR / 2)
        err_decided = diff[decided].abs().max().item()
        rms_share = (diff.square().mean().sqrt() / upd_cpu.square().mean().sqrt()).item()
        moved = (upd.abs() > SMALL_TRAIN_LR / 2).float().mean().item()
        ok = (rel <= SMALL_ATOL and err_decided <= 1e-6 and rms_share <= 1e-2
              and moved >= FRAME_MOVED_SHARE)
        log(f"[parallel] micro fp32 128x128x4 frames, 2 steps on a 1 x {FRAME_RANKS} frame mesh "
            f"of gloo ranks on the card, rank {r} vs one CPU process: loss/grad_norm "
            + "; ".join(f"cpu {a[0]:.6f}/{a[1]:.5f} card {b[0]:.6f}/{b[1]:.5f}"
                        for a, b in zip(m_cpu, got["metrics"]))
            + f", max rel {rel:.2e} (tol {SMALL_ATOL}); masters: max|diff| {err_decided:.2e} "
            f"on the {int(decided.sum())} of {diff.numel()} elements whose update exceeded "
            f"lr/2 (tol 1e-6), rms(diff)/rms(update) {rms_share:.2e} (tol 1e-2); the card's "
            f"masters moved by more than lr/2 on {moved:.3f} of them (at least "
            f"{FRAME_MOVED_SHARE}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("the micro frame-sharded step on the card disagrees with the CPU")
    return ranks[0]["probe"]


@contextlib.contextmanager
def _offloaded(models):
    """`models` on the host and the card's cached blocks freed inside the
    block; back on the card after."""
    for m in models:
        m.to("cpu")
    gc.collect()
    torch.cuda.empty_cache()
    try:
        yield
    finally:
        for m in models:
            m.to("cuda")


def _frame_train(one_device: dict) -> dict:
    """The frame-sharded full-width step in FRAME_RANKS processes sharing
    the card, against the one-device step's loss and grad_norm."""
    free, total = torch.cuda.mem_get_info()
    lo, hi = FRAME_PREDICTED_GIB
    log(f"[parallel] before the frame ranks: the card has {free / 2**30:.1f} of "
        f"{total / 2**30:.1f} GiB free ({(total - free) / 2**30:.1f} GiB held, this process's "
        f"context and {torch.cuda.memory_reserved() / 2**30:.2f} GiB of its cache); "
        f"{FRAME_RANKS} ranks at the predicted {lo}-{hi} GiB of peak allocation each")
    with tempfile.TemporaryDirectory() as tmp:
        probe = _frame_micro_check(tmp)
        t0 = time.perf_counter()
        ranks, _ = _frame_ranks("full", tmp, FRAME_TIMEOUT)
        wall = time.perf_counter() - t0
    first = [r["steps"][0] for r in ranks]
    ok = all(s["loss"] == first[0]["loss"] and s["grad_norm"] == first[0]["grad_norm"]
             for s in first)
    for key, rtol in (("loss", FRAME_LOSS_RTOL), ("grad_norm", FRAME_GRAD_RTOL)):
        rel = abs(first[0][key] - one_device[key]) / abs(one_device[key])
        log(f"[parallel] frame-sharded {key} {first[0][key]!r} vs one-device "
            f"{one_device[key]!r}: relative {rel:.3e} (bound {rtol})")
        ok &= rel <= rtol
    for r, rank in enumerate(ranks):
        peak = max(s["peak_gib"] for s in rank["steps"])
        log(f"[parallel] frame rank {r}: steps "
            + ", ".join(f"{s['seconds']:.3f} s" for s in rank["steps"])
            + f"; peak {peak:.2f} GiB (predicted {lo}-{hi} GiB; one-device "
            f"{one_device['peak_gib']:.2f} GiB); AdamW moments held "
            f"{rank['moment_bytes'] / 1e9:.3f} GB")
    log(f"[parallel] the frame ranks ran in {wall:.1f} s, start to exit")
    if not ok:
        raise SystemExit("the frame-sharded training step disagrees with the one-device step")
    return dict(probe=probe, ranks=[r["steps"] for r in ranks], wall_seconds=wall)


def phase_parallel(models, cfg, ref, pose, face, gen: dict, plain_frames) -> dict:
    """The (data, frame) mesh on torch.distributed over NCCL, in a world of
    one process (the machine has one card): the generate phase's request
    through generate(mesh=) against its frames and beside a plain request,
    one full-width ZeRO-1 training step beside the one-device step, the
    ZeRO-1 bytes per rank reckoned at data 1-8; then the process group goes,
    the generate phase's models leave the card, and two gloo processes
    sharing the card run a micro step against the CPU and the full-width
    step on a 1 x 2 frame mesh against the one-device step; then the
    training CLI under torchrun."""
    import torch.distributed as dist

    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.parallel import make_mesh
    from stableanimator_tpu_torch.pipeline.animation import generate

    mesh = make_mesh()
    log(f"[parallel] {mesh}, backend {dist.get_backend()}, world {dist.get_world_size()}")
    _nccl_check(mesh)
    expected = 10 * cfg.num_inference_steps + 1
    out = {}
    for run, kw in (("mesh", dict(mesh=mesh)), ("plain", {})):
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timings: dict = {}
        t0 = time.perf_counter()
        frames = generate(models, ref, pose, face, cfg, device="cuda", timings=timings, **kw)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        diff = (frames.float() - plain_frames.float()).abs().max().item()
        out[run] = dict(seconds=sec, phases=timings, max_diff=diff,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30, **counts)
        log(f"[parallel] {run} request: {sec:.3f} s ({cfg.num_frames / sec:.3f} frames/s; the "
            f"generate phase's timed request {gen['timed']['seconds']:.3f} s); phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
            + f"; flash launches {counts['by_kernel'][FWD_KERNEL]} (expected {expected}); max "
            f"|frames - the generate phase's frames| {diff!r} (bound {PARALLEL_FRAMES_ATOL})")
        if counts["by_kernel"][FWD_KERNEL] != expected:
            raise SystemExit(f"{run} request launched {counts['by_kernel']}")
        if not diff <= PARALLEL_FRAMES_ATOL:
            raise SystemExit(f"the {run} request's frames differ from the plain request's")
    del frames
    out["train"] = _parallel_train(mesh)
    dist.destroy_process_group()
    with _offloaded(models):
        out["frame_train"] = _frame_train(out["train"]["runs"]["one-device"])
    _torchrun_cli()
    return out


def _quant_dense_check():
    """int8_dense on the card: tests/test_ops.py::TestInt8Quant's shape and
    bounds against the fp32 product, and the card's int8 weight values and
    scales against the CPU's."""
    from stableanimator_tpu_torch.ops.quant import int8_dense, quantize_weight

    gen = torch.Generator().manual_seed(5)
    x = torch.randn((64, 320), generator=gen)
    w = torch.randn((1280, 320), generator=gen) * 0.05
    b = torch.randn((1280,), generator=gen) * 0.1
    out = int8_dense(x.cuda(), w.cuda(), b.cuda()).cpu()
    ref = x.double() @ w.double().t() + b.double()
    denom = torch.maximum(ref.abs(), ref.abs().quantile(0.5))
    med = ((out.double() - ref).abs() / denom).median().item()
    corr = torch.corrcoef(torch.stack([out.double().flatten(), ref.flatten()]))[0, 1].item()
    wq, ws = quantize_weight(w.cuda())
    wq_cpu, ws_cpu = quantize_weight(w)
    same = torch.equal(wq.cpu(), wq_cpu) and torch.equal(ws.cpu(), ws_cpu)
    log(f"[quant] int8_dense [64, 320] x [320, 1280] on the card against fp32: median relative "
        f"error {med:.4f} (bound 0.02), corrcoef {corr:.6f} (bound 0.999); int8 weights and "
        f"scales equal to the CPU's: {same}")
    if not (med < 0.02 and corr > 0.999 and same):
        raise SystemExit("int8_dense on the card fails its bounds")


def _small_quant():
    """A micro quant=True generate (fp32), card against CPU: the int8 path
    is discontinuous, so the bound is the CPU's own spread between thread
    counts (tests/test_torch_quant.py), not rounding."""
    from stableanimator_tpu_torch.core.config import PipelineConfig, micro_model_kwargs
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate

    cfg = PipelineConfig(num_frames=4, tile_size=4, tile_overlap=1, num_inference_steps=2,
                         decode_chunk_size=2)
    seeded = build_models(**micro_model_kwargs(), dtype=torch.float32, device="cpu", seed=0)
    outs = {}
    for device in ("cpu", "cuda"):
        models = build_models(**micro_model_kwargs(), dtype=torch.float32, device=device,
                              seed=None, quant=True)
        for a, b in zip(seeded, models):
            b.load_state_dict(a.state_dict())
        ref, pose, face, aug = _inputs(64, 64, 4, 32, "cpu", seed=3)
        init = torch.randn((1, 4, 8, 8, 4), generator=torch.Generator().manual_seed(4))
        outs[device] = generate(models, ref, pose, face, cfg, aug_noise=aug, init_noise=init,
                                device=device).cpu()
    d = (outs["cpu"] - outs["cuda"]).abs()
    corr = torch.corrcoef(torch.stack([outs["cpu"].flatten(), outs["cuda"].flatten()]))[0, 1]
    log(f"[quant] micro quant generate fp32, card vs CPU: max {d.max().item():.3e}, mean "
        f"{d.mean().item():.3e} (bound {SMALL_QUANT_MEAN}), corrcoef {corr.item():.5f} (bound "
        f"{SMALL_QUANT_CORR})")
    if not (d.mean().item() <= SMALL_QUANT_MEAN and corr.item() >= SMALL_QUANT_CORR):
        raise SystemExit("the micro quant generate on the card disagrees with the CPU")


def phase_quant(cfg, ref, pose, face, gen: dict, plain_frames) -> dict:
    """The int8 path (W8A8, build_models(quant=True)): int8_dense on the
    card, a micro quant generate card vs CPU, then the full-width request
    built with quant=True from the generate phase's seed (a
    QUANT_SHORT_STEPS-step warm-up, then the timed request at the generate
    phase's steps), its launches, frames and, for the timed one, their
    difference from the bf16 request's."""
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate

    _quant_dense_check()
    _small_quant()
    models = build_models(dtype=torch.bfloat16, device="cuda", seed=0, quant=True)
    short = dataclasses.replace(cfg, num_inference_steps=min(QUANT_SHORT_STEPS,
                                                             cfg.num_inference_steps))
    out = {}
    for run, run_cfg in (("warm-up", short), ("timed", cfg)):
        expected = 10 * run_cfg.num_inference_steps + 1
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        timings: dict = {}
        t0 = time.perf_counter()
        frames = generate(models, ref, pose, face, run_cfg, device="cuda", timings=timings)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _launch_counts()
        f32 = frames.float()
        finite = bool(torch.isfinite(f32).all())
        lo, hi = f32.min().item(), f32.max().item()
        out[run] = dict(seconds=sec, phases=timings,
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30, **counts)
        against = ""
        if run_cfg is cfg:            # the bf16 request's steps: its frames compare
            p32 = plain_frames.float()
            d = (f32 - p32).abs()
            corr = torch.corrcoef(torch.stack([f32.flatten(), p32.flatten()]))[0, 1].item()
            out[run].update(mean_diff=d.mean().item(), max_diff=d.max().item(), corrcoef=corr)
            against = (f"; against the bf16 frames: mean |diff| {out[run]['mean_diff']:.4e}, "
                       f"max {out[run]['max_diff']:.4e}, corrcoef {corr:.5f}")
        log(f"[quant] {run} request (quant=True, {run_cfg.num_inference_steps} steps): {sec:.3f} "
            f"s, {run_cfg.num_frames / sec:.3f} frames/s "
            f"(bf16 request {gen['timed']['seconds']:.3f} s); phases "
            + ", ".join(f"{k} {v:.2f} s" for k, v in timings.items())
            + f"; peak {out[run]['peak_gib']:.1f} GiB; flash launches "
            f"{counts['by_kernel'][FWD_KERNEL]} (expected {expected}); frames finite={finite} "
            f"range [{lo:.4f}, {hi:.4f}]{against}")
        if counts["by_kernel"][FWD_KERNEL] != expected:
            raise SystemExit(f"the quant request launched {counts['by_kernel']}")
        if not finite or lo < 0.0 or hi > 1.0:
            raise SystemExit("quant request frames not finite or outside [0, 1]")
    del models, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# ingest: the release-day path at full width
# ---------------------------------------------------------------------------

class _HostPeak(_DevicePeak):
    """This process's most host memory (VmRSS of /proc/self/status; the
    card's machine refuses the reset of VmHWM through /proc/self/clear_refs),
    sampled every 20 ms on a thread while the block runs."""

    @staticmethod
    def _used() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise RuntimeError("no VmRSS in /proc/self/status")

    def note(self) -> str:
        import resource

        return (f"host peak RSS {self.peak / 2**30:.2f} GiB ({self.before / 2**30:.2f} before; "
                "VmRSS sampled every 20 ms), resource.getrusage ru_maxrss over the process's "
                f"life {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")


def _tree_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)


def _write_release(root: str, models, antelopev2: str, dwpose: str) -> dict:
    """The reference's checkpoint tree under `root` from `models` (seeded):
    Animation/{unet,pose_net,face_encoder}.pth (torch.save of the state
    dicts as the port holds them), the SVD folders' vae and image_encoder
    in F16 safetensors (`write_safetensors`), and copies of the antelopev2
    and DWPose stand-ins. Checks the disk first: the tree and the tool's
    output must fit with INGEST_DISK_MARGIN to spare. Returns the state
    dicts as written (CPU tensors; numpy fp16 for the safetensors files)."""
    from stableanimator_tpu_torch.convert.safetensors_io import write_safetensors
    from stableanimator_tpu_torch.tools.ingest_checkpoints import SVD_ROOT

    onnx = _tree_bytes(antelopev2) + _tree_bytes(dwpose)
    sizes = {name: sum(p.numel() * p.element_size() for p in getattr(models, name).parameters())
             for name in ("unet", "pose_net", "face_encoder")}
    numels = {name: sum(p.numel() for p in getattr(models, name).parameters())
              for name in ("unet", "vae", "clip", "pose_net", "face_encoder")}
    # the tree: .pth as held, F16 safetensors; the output: .pth's floats as
    # fp32 .npz, the F16 files as fp16 .npz; the ONNX files twice
    tree = sum(sizes.values()) + 2 * (numels["vae"] + numels["clip"]) + onnx
    out = 4 * sum(numels[n] for n in sizes) + 2 * (numels["vae"] + numels["clip"]) + onnx
    free = shutil.disk_usage(root).free
    log(f"[ingest] release tree at {root}: {tree / 1e9:.3f} GB predicted (the three .pth "
        f"{sum(sizes.values()) / 1e9:.3f}, the F16 safetensors "
        f"{2 * (numels['vae'] + numels['clip']) / 1e9:.3f}, ONNX {onnx / 1e9:.3f}), the tool's "
        f"output {out / 1e9:.3f} GB; free disk there {free / 1e9:.3f} GB")
    if free < tree + out + INGEST_DISK_MARGIN:
        raise SystemExit(f"the host cannot hold the release tree ({tree} B) and its ingested "
                         f"copy ({out} B) with {INGEST_DISK_MARGIN} B to spare: {free} B free "
                         f"at {root}")
    written = {}
    os.makedirs(os.path.join(root, "Animation"))
    for name in sizes:
        sd = {k: v.detach().cpu() for k, v in getattr(models, name).state_dict().items()}
        torch.save(sd, os.path.join(root, "Animation", f"{name}.pth"))
        written[name] = sd
    for name, rel in (("vae", f"{SVD_ROOT}/vae/diffusion_pytorch_model.fp16.safetensors"),
                      ("clip", f"{SVD_ROOT}/image_encoder/model.fp16.safetensors")):
        sd = {k: v.detach().to(torch.float16).cpu().numpy()
              for k, v in getattr(models, name).state_dict().items()}
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        write_safetensors(os.path.join(root, rel), sd, {"format": "pt"})
        written[name] = sd
    shutil.copytree(antelopev2, os.path.join(root, "antelopev2"))
    shutil.copytree(dwpose, os.path.join(root, "DWPose"))
    log(f"[ingest] wrote the tree: {_tree_bytes(root)} B ("
        + ", ".join(f"{os.path.relpath(os.path.join(d, f), root)} "
                    f"{os.path.getsize(os.path.join(d, f))}"
                    for d, _, fs in sorted(os.walk(root)) for f in sorted(fs)) + ")")
    return written


def _same_parameters(loaded, direct) -> tuple[int, list]:
    """(parameters compared, those not bit-equal) of two AnimationModels."""
    n, differ = 0, []
    for name in loaded._fields:
        want = getattr(direct, name).state_dict()
        for k, v in getattr(loaded, name).state_dict().items():
            n += 1
            if not (v.dtype == want[k].dtype and torch.equal(v, want[k])):
                differ.append(f"{name}.{k}")
    return n, differ


def _drill_check(work: str, metrics: dict) -> dict:
    """The drill's CSIM, PSNR / L1 and I3D features on the card against the
    same on the CPU, from the drill's own files in `work`."""
    import numpy as np
    from PIL import Image

    from stableanimator_tpu_torch.preproc.onnx_to_torch import load_onnx_function
    from stableanimator_tpu_torch.tools import eval_drill, evaluate

    frames_a, frames_b = (evaluate.load_frames(os.path.join(work, f"out_{t}", "animated_images"))
                          for t in ("a", "b"))
    ref = np.asarray(Image.open(os.path.join(work, "reference.png")).convert("RGB"))
    cpu = evaluate.csim(frames_a, ref, os.path.join(work, "antelopev2"), device="cpu")
    cpu.update(evaluate.reconstruction(frames_a, frames_b))
    clip_len = eval_drill.fvd_clip_len(len(frames_a))
    clips = evaluate._windows(frames_a, clip_len) + evaluate._windows(frames_b, clip_len)
    i3d = os.path.join(work, "i3d.onnx")
    feats = {d: evaluate._i3d_features(clips, load_onnx_function(i3d, device=d))
             for d in ("cuda", "cpu")}
    i3d_err = float(np.abs(feats["cuda"] - feats["cpu"]).max() / np.abs(feats["cpu"]).max())
    csim_err = max(abs(metrics[k] - cpu[k]) for k in ("csim_mean", "csim_min"))
    log(f"[ingest] drill, the card against the CPU on the same frames: csim_mean "
        f"{metrics['csim_mean']:.6f} / {cpu['csim_mean']:.6f}, csim_min {metrics['csim_min']:.6f}"
        f" / {cpu['csim_min']:.6f} (max diff {csim_err:.3e}, bound {DRILL_CSIM_ATOL}); l1 "
        f"{metrics['l1_mean']} / {cpu['l1_mean']}, psnr {metrics['psnr_mean']} / "
        f"{cpu['psnr_mean']}; I3D features {feats['cpu'].shape} max diff {i3d_err:.3e} of the "
        f"largest |feature| {np.abs(feats['cpu']).max():.4f} (bound {DRILL_I3D_REL})")
    checks = {
        "CSIM within DRILL_CSIM_ATOL of the CPU's": csim_err <= DRILL_CSIM_ATOL,
        "faces found as on the CPU": metrics["frames_with_face"] == cpu["frames_with_face"],
        "PSNR / L1 equal to the CPU's": all(metrics[k] == cpu[k]
                                            for k in ("l1_mean", "psnr_mean", "num_frames")),
        "I3D features within DRILL_I3D_REL of the CPU's": i3d_err <= DRILL_I3D_REL,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the evaluation drill on the card disagrees with the CPU: {failed}")
    return dict(csim_err=csim_err, i3d_err=i3d_err)


def phase_ingest(standins: str, dwpose: str | None) -> dict:
    """The release-day path: the reference's checkpoint tree written from
    seeded full-width models, `tools/ingest_checkpoints.main` on it (dump,
    check, copy, and the validation render on the card), the CLIs' load of
    the ingested directory timed and held bit for bit against the written
    tensors, a 5-step request on the ingested models against one on the
    directly loaded ones, then the evaluation drill on the card against the
    CPU. Returns the request's launches and the numbers read."""
    import numpy as np
    from PIL import Image

    from stableanimator_tpu_torch.convert.checkpoints import load_state_dicts
    from stableanimator_tpu_torch.core.config import PipelineConfig
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import build_models, generate
    from stableanimator_tpu_torch.preproc import standins as standin_files
    from stableanimator_tpu_torch.tools import eval_drill, ingest_checkpoints

    kwargs = dict(dtype=torch.bfloat16, device="cuda")
    antelopev2 = os.path.join(standins, "antelopev2")
    if not os.path.exists(os.path.join(antelopev2, "glintr100.onnx")):
        standin_files.write_antelopev2(antelopev2)
    if dwpose is None:
        dwpose = standin_files.write_dwpose(os.path.join(standins, "DWPose"))
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_release_")
    try:
        src, ckpt = os.path.join(tmp, "checkpoints"), os.path.join(tmp, "ckpt")
        os.makedirs(src)
        t0 = time.perf_counter()
        seeded = build_models(**kwargs, seed=0)
        written = _write_release(src, seeded, antelopev2, dwpose)
        id_dim = seeded.face_encoder.config.id_embeddings_dim
        del seeded
        out["write_s"] = time.perf_counter() - t0
        out["tree_bytes"] = _tree_bytes(src)
        cfg = PipelineConfig(num_inference_steps=INGEST_STEPS)
        ref, pose, face, _ = _inputs(cfg.height, cfg.width, cfg.num_frames, id_dim, "cuda")
        ref_png = os.path.join(tmp, "validate.png")
        Image.fromarray(_noise_frames(INGEST_IMAGE + 1, cfg.height, seed=1)[INGEST_IMAGE]
                        ).save(ref_png)
        log(f"[ingest] wrote the release tree in {out['write_s']:.1f} s")

        # the tool, with its validation render on the card
        stages: dict = {}
        t0 = time.perf_counter()
        with _HostPeak() as host:
            report = ingest_checkpoints.main(["--source", src, "--output", ckpt,
                                              "--validate_image", ref_png, "--device", "cuda"],
                                             timings=stages)
        out["ingest_s"], out["ingest_host_gib"] = time.perf_counter() - t0, host.peak / 2**30
        out["ingest_stages"], out["report"] = stages, report
        out["ckpt_bytes"] = _tree_bytes(ckpt)
        csim = report.get("csim") or {}
        log(f"[ingest] tools/ingest_checkpoints: {out['ingest_s']:.1f} s ("
            + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items())
            + f"); output {out['ckpt_bytes']} B; {host.note()}; report {json.dumps(report)}")
        oks = [npz for _, npz, _ in ingest_checkpoints.PLAN
               if str(report.get(npz, "")).startswith("ok:")]
        if len(oks) != len(ingest_checkpoints.PLAN):
            raise SystemExit(f"the ingest report lacks ok for {sorted(set(report) - set(oks))}")
        mean = csim.get("csim_mean")
        if not (mean is not None and np.isfinite(mean) and -1.0 <= mean <= 1.0):
            raise SystemExit(f"the validation's CSIM is not a finite cosine: {csim}")

        # the CLIs' load (cli/animate.py's `_prepare`), timed, beside the
        # written tensors loaded directly
        t0 = time.perf_counter()
        with _HostPeak() as host:
            loaded = build_models(**kwargs, seed=None)
            names = load_state_dicts(ckpt, loaded, allow_random_init=False,
                                     init_id_adapter=False)
            torch.cuda.synchronize()
        out["load_s"], out["load_host_gib"] = time.perf_counter() - t0, host.peak / 2**30
        log(f"[ingest] load_state_dicts of {names} into build_models(seed=None) on the card: "
            f"{out['load_s']:.2f} s; {host.note()}")
        direct = build_models(**kwargs, seed=None)
        for name, sd in written.items():
            getattr(direct, name).load_state_dict(
                {k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
        del written
        n, differ = _same_parameters(loaded, direct)
        log(f"[ingest] {n} parameters compared with the written tensors cast to each "
            f"parameter's dtype: {len(differ)} differ {differ[:10]}")
        if differ or n == 0:
            raise SystemExit(f"ingested parameters differ from the written ones: {differ[:10]}")

        # a request on each: the same frames, through the forward kernels
        expected = 10 * INGEST_STEPS + 1
        frames = {}
        for tag, models in (("ingested", loaded), ("direct", direct)):
            reset_launch_counts()
            t0 = time.perf_counter()
            frames[tag] = generate(models, ref, pose, face, cfg, device="cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = _launch_counts()
            log(f"[ingest] {INGEST_STEPS}-step request on the {tag} models: {sec:.2f} s, flash "
                f"launches {counts['by_kernel'][FWD_KERNEL]} (expected {expected})")
            if counts["by_kernel"][FWD_KERNEL] != expected:
                raise SystemExit(f"the {tag} request launched the forward kernel "
                                 f"{counts['by_kernel'][FWD_KERNEL]} times, expected {expected}")
            out.setdefault("requests", {})[tag] = dict(seconds=sec, **counts)
        diff = (frames["ingested"].float() - frames["direct"].float()).abs().max().item()
        log(f"[ingest] frames on the ingested models against the directly loaded ones: max "
            f"|diff| {diff} (bound 0), shape {tuple(frames['direct'].shape)}")
        if diff != 0 or not bool(torch.isfinite(frames["direct"]).all()):
            raise SystemExit(f"the ingested models' frames differ by {diff}")
        del loaded, direct, frames
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the evaluation drill on the card, against the CPU on its frames
    work = tempfile.mkdtemp(prefix="chip_smoke_drill_")
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_Tee()):
            drill = eval_drill.main(["--device", "cuda", "--work_dir", work])
        out["drill_s"] = time.perf_counter() - t0
        log(f"[ingest] eval drill on the card: {out['drill_s']:.1f} s; " + json.dumps(drill))
        out["drill"] = dict(drill, **_drill_check(work, drill["metrics"]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def _kernel_entries(max_err, rows, gen, longvideo, train, faceopt=None, served=None,
                    parallel=None, quant=None, pro=None, ingest=None) -> list:
    """The JSON line's entries: each kernel's times at its shapes, weighted
    by the launches the main paths made at those shapes (generate's timed
    request, the timed 576x1024 request, the timed face-opt request, the
    mesh request and the mesh training step, the timed quant request, the
    server's first request, the 64-frame CLI request, one timed training
    step at 512x512 and one on the vertical bucket, and the timed face-opt
    request at crop 32, the first frame-sharded step on both ranks, and the
    ingest phase's request on the ingested models)."""
    paths = {}
    if gen:
        paths["generate"] = {(FWD_KERNEL, key): n for key, n in gen["timed"]["by_shape"].items()}
    if pro:
        paths["pro"] = {(FWD_KERNEL, key): n for key, n in pro["timed"]["by_shape"].items()}
    if faceopt:
        paths["faceopt"] = faceopt["timed"]["by_shape"]
        paths[f"faceopt_crop{FACEOPT_BIG_CROP}"] = (
            faceopt[f"crop{FACEOPT_BIG_CROP}"]["timed"]["by_shape"])
    if parallel:
        paths["parallel"] = parallel["mesh"]["by_shape"]
        paths["parallel_train"] = parallel["train"]["runs"]["mesh (ZeRO-1)"]["by_shape"]
        # the frame-sharded step's first step, both ranks' launches
        paths["parallel_frame_train"] = collections.Counter()
        for steps in parallel["frame_train"]["ranks"]:
            paths["parallel_frame_train"].update(steps[0]["by_shape"])
    if quant:
        paths["quant"] = quant["timed"]["by_shape"]
    if served:
        paths["serve"] = served["requests"][0]["by_shape"]
    if longvideo:
        paths["longvideo"] = longvideo["by_shape"]
    if ingest:
        paths["ingest"] = ingest["requests"]["ingested"]["by_shape"]
    if train:
        paths["train"] = train["steps"][-1]["by_shape"]
        paths["train_vertical"] = train["vertical"]["steps"][-1]["by_shape"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    entries = []
    for name in KERNELS:
        by_key = {}
        for _, r in rows[name]:
            b, s, h, d = r["shape"]
            by_key[(name, (b, s, s, h, d))] = r
        launches = {p: {k: n for k, n in counts.items() if k[0] == name}
                    for p, counts in paths.items()}
        untimed = {k for c in launches.values() for k in c} - set(by_key)
        if untimed:
            raise SystemExit(f"the main paths launched {name} at shapes not timed: "
                             f"{sorted(untimed)}")
        total = {key: None for key in keys}
        per_path = {}
        if paths:
            for p, counts in launches.items():
                per_path[p] = dict(launches=sum(counts.values()),
                                   **{key: sum(by_key[k][key] * n for k, n in counts.items())
                                      for key in keys})
            total = {key: sum(pp[key] for pp in per_path.values()) for key in keys}
        # what bounds the larger part of bound_ms over the paths' launches
        # (every timed shape's when no path ran)
        share = collections.Counter()
        for counts in launches.values():
            for k, n in counts.items():
                share[by_key[k]["bound_by"]] += by_key[k]["bound_ms"] * n
        if not +share:
            share.update(r["bound_by"] for _, r in rows[name])
        bound_by = max(("operations", "bytes"), key=lambda by: share[by])
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(pp["launches"] for pp in per_path.values()) if paths else None,
            "max_abs_err": max_err[name],
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": bound_by,
            "library_ms": total["library_ms"],
            "per_request_of": "sum over the launches of generate's timed request, of the "
                              "timed 576x1024 request, of the timed face-opt requests at "
                              "crops 16 and 32, of the mesh request and the mesh training "
                              "step, of the timed quant request, of the server's first "
                              "request, of the 64-frame CLI request, of one timed "
                              "training step at 512x512 and one on the vertical bucket, "
                              "of the first frame-sharded step on both ranks, and of the "
                              "ingest phase's request on the ingested models",
            "per_path": per_path,
            "library_of": ("scaled_dot_product_attention" if name in (FWD_KERNEL, RES_KERNEL)
                           else "scaled_dot_product_attention's backward (fwd+bwd less fwd), "
                           "which computes dq, dk and dv together"),
            "plain_of": ("flash_attention_reference" if name in (FWD_KERNEL, RES_KERNEL) else
                         "flash_attention_bwd_reference, which computes dq, dk and dv together"),
            "shapes": {lbl: r for lbl, r in rows[name]},
        })
    return entries


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(ALL_PHASES),
                        help=f"comma-separated subset of {ALL_PHASES + EXTRA_PHASES}; the "
                        f"default is {ALL_PHASES} ({EXTRA_PHASES} only when named, e.g. "
                        "--phases device,build,longvideo450)")
    parser.add_argument("--steps", type=int, default=25, help="Euler steps per request")
    # one rank of the parallel phase's frame-sharded runs (started by it)
    parser.add_argument("--frame_worker", choices=("micro", "full"), help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tmp", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.frame_worker is not None:
        return _frame_worker(args.frame_worker, args.rank, args.world, args.tmp)
    phases = args.phases.split(",")
    unknown = set(phases) - set(ALL_PHASES + EXTRA_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import stableanimator_tpu_torch  # noqa: F401  (fails outside a checkout)
    from stableanimator_tpu_torch.ops.flash_attention import RESIDENT_BUDGET_ENV

    # the resident route is off (the port's default) except where a phase
    # turns it on: the streamed kernel's checks and timings, generate and
    # train run the default route
    os.environ.pop(RESIDENT_BUDGET_ENV, None)
    t_start = time.perf_counter()
    standins = tempfile.mkdtemp(prefix="chip_smoke_standins_")   # the ONNX stand-ins' files
    try:
        return _run(phases, args.steps, t_start, standins)
    finally:
        shutil.rmtree(standins, ignore_errors=True)


def _run(phases, steps: int, t_start: float, standins: str) -> int:
    last = [t_start]

    def took(name):
        # seconds since the previous phase ended, so a run near its time limit
        # shows which phase grew
        now = time.perf_counter()
        log(f"[chip_smoke] {name}: {now - last[0]:.1f} s (at {now - t_start:.1f} s)")
        last[0] = now

    l2_rate = None
    if "device" in phases:
        l2_rate = phase_device()
    if "build" in phases:
        phase_build()
        took("build")
    gen = longvideo = train = face = faceopt = served = parallel = quant = pro = ingest = None
    if "kernels" in phases:
        max_err, rows = phase_kernels(l2_rate or l2_read_rate())
        took("kernels")
    if "small" in phases:
        phase_small()
        took("small")
    if {"face", "faceopt", "serve"} & set(phases):
        face = phase_face(standins)
        took("face")
    dwpose = None
    if "dwpose" in phases:
        dwpose = phase_dwpose(standins)
        torch.cuda.empty_cache()
        took("dwpose")
    if "generate" in phases:
        gen, state, plain_frames = phase_generate(steps)
        if "profile" in phases:
            profile_generate(*state)
        phase_ab(*state)
        took("generate")
        if "pro" in phases:
            pro = phase_pro(state[0], steps)
            took("pro")
        if "faceopt" in phases:
            faceopt = phase_faceopt(*state, gen, plain_frames, face)
            took("faceopt")
        if "export" in phases:
            phase_export(*state[:2])
            took("export")
        if "parallel" in phases:
            parallel = phase_parallel(*state, gen, plain_frames)
            took("parallel")
        if "quant" in phases:
            quant = phase_quant(*state[1:], gen, plain_frames)
            took("quant")
        del state, plain_frames
        gc.collect()                 # the generate phase's models go before the server's come
        torch.cuda.empty_cache()
    if "serve" in phases:
        served = phase_serve(standins, gen, steps)
        gc.collect()
        torch.cuda.empty_cache()
        took("serve")
    if "longvideo" in phases:
        longvideo = phase_longvideo(steps)
        torch.cuda.empty_cache()
        if dwpose is None:
            from stableanimator_tpu_torch.preproc.standins import write_dwpose

            dwpose = write_dwpose(os.path.join(standins, "DWPose"))
        phase_driving(steps, dwpose)
        torch.cuda.empty_cache()
        took("longvideo")
    if "longvideo450" in phases:
        phase_longvideo450(steps)
        torch.cuda.empty_cache()
        took("longvideo450")
    if "ingest" in phases:
        ingest = phase_ingest(standins, dwpose)
        torch.cuda.empty_cache()
        took("ingest")
    if "train" in phases:
        train = phase_train()
        torch.cuda.empty_cache()
        train_cli()
        took("train")
    if "kernels" in phases:
        log(json.dumps({"kernels": _kernel_entries(max_err, rows, gen, longvideo, train, faceopt,
                                                   served, parallel, quant, pro, ingest)}))
    log(f"[chip_smoke] phases {phases} done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
