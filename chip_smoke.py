#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`stableanimator_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port still starts and is right on
the card.

    python3 chip_smoke.py                 # every phase, 25 Euler steps
    python3 chip_smoke.py --phases device,build,kernels   # kernel bring-up only

Phases, in order (any failure exits nonzero; no phase's exception is caught):
  device   card name and power limit (nvidia-smi); TF32 stated and set off
  build    builds the flash-attention kernels (streamed forward, resident
           forward, backward) from csrc/ with nvcc, one process per source,
           in parallel; prints the ptxas report and, from cuobjdump -sass,
           the wgmma (HGMMA) and TMA (UTMALDG, UTMASTG) instructions of the
           d = 64 forward and of both backward kernels: fails on a spill in
           the forward or the backward, if one of those three kernels uses
           other than its launch-bound register count (setmaxnreg needs it),
           or if HGMMA or UTMALDG is missing from one of them
  kernels  the streamed forward kernel against its plain PyTorch version,
           with and without lse, at the main paths' full shapes in bf16 and
           at ragged and fp16 shapes, with the d = 64 kernel's edges (q and
           kv tails, strided views of a fused QKV tensor); the resident
           forward kernel against
           the plain version (lse too) and against the streamed kernel at
           the UNet's generate and training shapes and ragged bf16/fp16
           ones; the backward kernels (through the autograd Function)
           against the plain backward within `grad_tolerance` at the
           training shapes and ragged bf16/fp16 ones; then every kernel
           timed with CUDA events at the paths' shapes beside its bound, its
           plain version and the PyTorch library call (the resident one
           beside the streamed one too); the streamed forward's rows also
           beside its earlier design's time and, at d = 64, the
           exponentials' bound; the backward's beside their earlier design's
           times and the bound of the products they issue (P and dS split
           in two)
  small    micro-config generate, and two micro-config fp32 training
           steps, on the card against the same on the CPU
  generate full-width (SVD-XT, CLIP ViT-H, ...) 512x512x16f generate() with
           seeded weights: one warm-up request, one timed request; output
           shape / range and the kernel launch counts are asserted; the
           timed request's launches, counted by shape, weight the forward
           kernel's per-request times; then the resident A/B: the same
           request with SA_TPU_RESIDENT_KV_MAX_BYTES at 0 and at 4 MiB in
           turns (0, 4 MiB, 4 MiB, 0), each route's launches asserted
  longvideo the inference CLI (`cli.animate.main`, in this process) at full
           width on 64 seeded 512x512 pose PNGs, 25 steps, with the resident
           budget at 4 MiB: 5 tiles in groups of 1 and 5-step segments; the
           exit, the files written, 5 progress lines, the resident and
           streamed launches (10 x 5 x steps and 4) and the 4 calls the
           card's capacity sent to the streamed kernel are asserted
  train    full-width training (remat, bf16 over fp32 masters, trainable
           unet, pose_net, face_encoder) on a seeded 1x16x512x512 batch:
           one warm-up step and three timed steps through make_train_step;
           loss / grad_norm finite, the fp32 masters moved, and the launches
           of every kernel per step asserted; then the training CLI at the
           micro scale for 2 steps on a PNG dataset, and a resume
  profile  one more request and one more training step under
           torch.profiler: device time by kernel category, the busiest
           kernels, and the device's busy share
The phases run in the order generate (with its profile and the A/B),
longvideo, train.
Before the last line it prints one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
KERNELS = (FWD_KERNEL, RES_KERNEL, DKV_KERNEL, DQ_KERNEL)
REPLACES = {FWD_KERNEL: "stableanimator_tpu/ops/flash_attention.py:70",
            RES_KERNEL: "stableanimator_tpu/ops/flash_attention.py:125",
            DKV_KERNEL: "stableanimator_tpu/ops/flash_attention.py:326",
            DQ_KERNEL: "stableanimator_tpu/ops/flash_attention.py:372"}
SOURCES = {FWD_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_fwd.cu",
           RES_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_resident.cu",
           DKV_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_bwd.cu",
           DQ_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_bwd.cu"}
# the resident route's budget in the longvideo phase and the A/B: every
# UNet attention of a request passes the JAX package's test at 4 MiB
RESIDENT_BUDGET = 4 * 1024 * 1024
# the forward kernel's shapes on the main paths, [B, S, H, D]: generate's
# UNet levels 0 and 1 (CFG x 16 frames) and VAE decoder mid block, and the
# training step's UNet levels 0 and 1 (16 frames), which ask for the lse
PATH_SHAPES = (("unet_level0", (32, 4096, 5, 64), False),
               ("unet_level1", (32, 1024, 10, 64), False),
               ("vae_mid", (16, 4096, 1, 512), False),
               ("train_level0", (16, 4096, 5, 64), True),
               ("train_level1", (16, 1024, 10, 64), True))
# the backward kernels' shapes on the training path
TRAIN_SHAPES = (("train_level0", (16, 4096, 5, 64)), ("train_level1", (16, 1024, 10, 64)))
# the resident kernel's checks: (label, q shape, kv length, dtype, with lse);
# generate's and the 64-frame request's UNet levels (timed too), the
# training shapes with lse, and tests/test_ops.py's ragged shapes
RESIDENT_CHECKS = (("unet_level0", (32, 4096, 5, 64), 4096, torch.bfloat16, False),
                   ("unet_level1", (32, 1024, 10, 64), 1024, torch.bfloat16, False),
                   ("train_level0", (16, 4096, 5, 64), 4096, torch.bfloat16, True),
                   ("train_level1", (16, 1024, 10, 64), 1024, torch.bfloat16, True),
                   ("ragged_300_513", (2, 300, 5, 64), 513, torch.bfloat16, True),
                   ("ragged_300_513", (2, 300, 5, 64), 513, torch.float16, True),
                   ("small_256", (2, 256, 2, 64), 256, torch.bfloat16, True))
RESIDENT_TIMED = ("unet_level0", "unet_level1")
# further forward checks, (label, q shape, kv length, dtype, fused): the
# d=512 instantiation in fp16, ragged sequences, and the d=64 kernel's edges:
# a q length off its 192-row tile, kv below and across one 128-key tile,
# q, k, v as strided views of one [B, S, 3, H, D] tensor, fp16 at UNet level 1
EXTRA_CHECKS = (("vae_mid", (2, 4096, 1, 512), 4096, torch.float16, False),
                ("ragged_576", (2, 576, 20, 64), 576, torch.bfloat16, False),
                ("ragged_300", (1, 300, 2, 64), 300, torch.bfloat16, False),
                ("ragged_300", (1, 300, 2, 64), 300, torch.float16, False),
                ("q_tail_200", (1, 200, 3, 64), 4096, torch.bfloat16, False),
                ("kv_100", (2, 256, 3, 64), 100, torch.bfloat16, False),
                ("kv_300", (2, 256, 3, 64), 300, torch.bfloat16, False),
                ("fused_qkv", (2, 640, 4, 64), 640, torch.bfloat16, True),
                ("unet_level1_fp16", (32, 1024, 10, 64), 1024, torch.float16, False))
# the streamed forward's times per launch with its earlier design (mma.sync
# at both head dims, before the d = 64 wgmma / TMA kernel), measured by this
# script on an H100 80GB HBM3 at 700 W; printed beside this run's
EARLIER_FWD_MS = {"unet_level0": 6.827, "unet_level1": 0.876, "vae_mid": 4.421,
              "train_level0": 3.449, "train_level1": 0.467}
# the Hopper kernels' symbols by library, and the SASS instructions that
# show their design: wgmma (HGMMA), TMA loads (UTMALDG) and stores (UTMASTG;
# the backward stores from registers)
SM90_SYMBOLS = {FWD_KERNEL: ("flash_fwd_sm90_kernel",),
                BWD_SOURCE: ("flash_bwd_dkv_sm90_kernel", "flash_bwd_dq_sm90_kernel")}
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG")
# their registers per thread at launch, 65536 over their threads rounded
# down to 8 (512 threads for the forward, 384 for the backward): the
# consumers' setmaxnreg.inc (to 160, and to 240) waits for good on fewer
SM90_REGISTERS = {"flash_fwd_sm90_kernel": 128, "flash_bwd_dkv_sm90_kernel": 168,
                  "flash_bwd_dq_sm90_kernel": 168}
# MUFU exponentials per clock per SM
EXP_PER_CLOCK_PER_SM = 16
# further backward checks: (label, q shape, kv length, dtype, fused): ragged
# sequences, and the kernels' edges: a q length off the 64-row q tile (dK/dV)
# and the 128-row one (dQ) against 4096 keys, kv below and across the 128-row
# kv block (dK/dV) and off the 64-row kv tile (dQ), q, k, v as strided views
# of one [B, S, 3, H, D] tensor, fp16 at training level 1
BWD_EXTRA_CHECKS = (("ragged_300", (1, 300, 2, 64), 300, torch.bfloat16, False),
                    ("ragged_300", (1, 300, 2, 64), 300, torch.float16, False),
                    ("ragged_640_576", (2, 640, 2, 64), 576, torch.bfloat16, False),
                    ("ragged_640_576", (2, 640, 2, 64), 576, torch.float16, False),
                    ("q_tail_200", (1, 200, 3, 64), 4096, torch.bfloat16, False),
                    ("kv_100", (2, 256, 3, 64), 100, torch.bfloat16, False),
                    ("kv_300", (2, 256, 3, 64), 300, torch.bfloat16, False),
                    ("fused_qkv", (2, 640, 4, 64), 640, torch.bfloat16, True),
                    ("train_level1_fp16", (16, 1024, 10, 64), 1024, torch.float16, False))
# the backward kernels' times per launch with their earlier design
# (mma.sync, before the wgmma / TMA kernels), measured by this script on an
# H100 80GB HBM3 at 700 W; printed beside this run's
EARLIER_BWD_MS = {DKV_KERNEL: {"train_level0": 5.378, "train_level1": 0.717},
                  DQ_KERNEL: {"train_level0": 3.145, "train_level1": 0.434}}
# products of 2 B H Sq Sk d operations each kernel issues, P and dS fed to
# the tensor cores as hi + lo: dK/dV S^T, dP^T, 2 dV, 2 dK; dQ S, dP, 2 dQ
ISSUED_PRODUCTS = {DKV_KERNEL: 6, DQ_KERNEL: 4}
ALL_PHASES = ("device", "build", "kernels", "small", "generate", "longvideo", "train",
              "profile")
# device kernels by name, for the profile's breakdown (first match wins)
CATEGORIES = (("flash_attention_fwd", r"flash_fwd_(sm90_)?kernel"),
              ("flash_attention_resident", r"flash_resident_kernel"),
              ("flash_attention_bwd_dkv", r"flash_bwd_dkv_sm90_kernel"),
              ("flash_attention_bwd_dq", r"flash_bwd_dq_sm90_kernel"),
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
TRAIN_LAUNCHES = {FWD_KERNEL: 20, RES_KERNEL: 0, DKV_KERNEL: 10, DQ_KERNEL: 10}
TRAIN_TIMED_STEPS = 3
# the long-video request: 64 frames at tile 16 / overlap 4 are 5 tiles,
# denoised in groups of 1 (UNet batch 2 x 16, as the flat request's) and
# 5-step segments; decoded in 4 groups of 16 frames
LONGVIDEO_FRAMES, LONGVIDEO_TILES, LONGVIDEO_DECODE_GROUPS = 64, 5, 4


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


def _sass_counts(path, symbol: str) -> dict:
    """By instantiation of the kernel `symbol` in the built library, the
    count of each of SASS_OPS in its SASS (cuobjdump -sass)."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if symbol in name:
            counts[name] = {op: func.count(op) for op in SASS_OPS}
    return counts


def phase_build():
    from stableanimator_tpu_torch.ops import build

    t0 = time.perf_counter()
    sources = (FWD_KERNEL, RES_KERNEL, BWD_SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        paths = dict(zip(sources, pool.map(build.build_kernel, sources)))
    log(f"[build] {', '.join(paths)} in {time.perf_counter() - t0:.1f} s")
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
                log(f"[build] {name} SASS {func[:100]}: "
                    + ", ".join(f"{op} {n}" for op, n in ops.items()))
            if not counts or any(ops[op] == 0 for ops in counts.values() for op in SASS_OPS[:2]):
                raise SystemExit(f"{symbol} lacks wgmma or TMA loads in its SASS: {counts}")


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

    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, with_lse=True)
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
        f"{' (strided views of one QKV tensor)' if not q.is_contiguous() else ''}: max|o-ref| {err:.3e}, "
        f"{share:.3f} of the bound (eps|ref| + 2 eps rms(ref), rms "
        f"{ref_o.float().square().mean().sqrt().item():.3e}); max|lse-ref| {err_lse:.3e} tol "
        f"{LSE_ATOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{FWD_KERNEL} disagrees with its plain version at {lbl}")
    return err


def _check_resident(lbl, q, k, v, with_lse) -> float:
    """The resident kernel, with and without lse, against the plain version
    and against the streamed kernel; returns the largest absolute error of
    its output against the plain version."""
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
    log(f"[kernels] resident {lbl} q {tuple(q.shape)} kv {k.shape[1]} {str(q.dtype)[6:]} "
        f"(cluster {fa.resident_cluster_size(k.shape[1])}, lse checked, path with_lse="
        f"{with_lse}): max|o-ref| {err:.3e}, {share:.3f} of the bound; vs the streamed kernel "
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
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    errs, shares = [], []
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        errs.append(diff.max().item())
        shares.append((diff / fa.grad_tolerance(w)).max().item())
    ok = max(shares) <= 1.0
    log(f"[kernels] bwd {lbl} q {tuple(q.shape)} kv {k.shape[1]} {str(q.dtype)[6:]}"
        f"{' (strided views of one QKV tensor)' if not q.is_contiguous() else ''}: "
        "max|g-ref| dq/dk/dv " + " ".join(f"{e:.3e}" for e in errs) + ", share of "
        "grad_tolerance (eps|ref| + eps/4 rms(ref)) " + " ".join(f"{s:.3f}" for s in shares)
        + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the backward kernels disagree with the plain backward at {lbl}")
    return {DQ_KERNEL: errs[0], DKV_KERNEL: max(errs[1:])}


def _time_bwd(lbl, shape) -> dict:
    """CUDA-event times of each backward kernel at a training shape, beside
    its bound, the plain backward and SDPA's backward; the log line also
    gives its earlier design's time and the bound of the products it
    issues."""
    import math

    from stableanimator_tpu_torch.ops import flash_attention as fa

    b, s, h, d = shape
    q, k, v, do = _qkv(shape, torch.bfloat16, seed=11) + _qkv(shape, torch.bfloat16, seed=12)[:1]
    o, lse = fa.flash_attention(q, k, v, with_lse=True)
    _, launch = fa.bwd_launchers(q, k, v, o, lse, do, 1.0 / math.sqrt(d))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do),
                       iters=2, warmup=1)
    # SDPA's backward: its forward + backward less its forward
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = cuda_ms(lambda: sdpa(qt, kt, vt), iters=10)
    sdpa_fb = cuda_ms(lambda: torch.autograd.grad(sdpa(qt, kt, vt), (qt, kt, vt), dot), iters=10)
    io = 2.0 * b * s * h * d                   # bytes of one [B, S, H, D] bf16 tensor
    vec = 4.0 * b * s * h                      # bytes of lse or delta
    work = {DKV_KERNEL: (8.0 * b * h * s * s * d, 4 * io + 2 * vec + 2 * io),
            DQ_KERNEL: (6.0 * b * h * s * s * d, 4 * io + 2 * vec + io)}
    rows = {}
    for name, (flops, nbytes) in work.items():
        ms = cuda_ms(launch[name], iters=10)
        bound_ms, bound_by = _bound(flops, nbytes)
        issued_ms = ISSUED_PRODUCTS[name] * 2.0 * b * h * s * s * d / PEAK_FLOPS * 1e3
        rows[name] = dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                          library_ms=sdpa_fb - sdpa_fwd, bound_ms=bound_ms, bound_by=bound_by,
                          tflops=flops / ms / 1e9)
        log(f"[kernels] {name} {lbl} {tuple(shape)} bf16: kernel {ms:.3f} ms "
            f"({rows[name]['tflops']:.0f} TFLOP/s; earlier design {EARLIER_BWD_MS[name][lbl]:.3f} "
            f"ms), bound "
            f"{bound_ms:.4f} ms ({bound_by}), issued-product bound {issued_ms:.4f} ms "
            f"({ISSUED_PRODUCTS[name]} products, {issued_ms / ms:.1%} of it); plain "
            f"backward {plain_ms:.2f} ms, sdpa backward {sdpa_fb - sdpa_fwd:.3f} ms "
            f"(fwd+bwd {sdpa_fb:.3f} - fwd {sdpa_fwd:.3f})")
    return rows


def phase_kernels():
    from stableanimator_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    from stableanimator_tpu_torch.ops.flash_attention import flash_attention_resident

    max_err = {name: 0.0 for name in KERNELS}
    for lbl, shape, sk, dtype, fused in EXTRA_CHECKS:
        max_err[FWD_KERNEL] = max(max_err[FWD_KERNEL],
                                  _check(lbl, *_qkv(shape, dtype, seed=len(lbl), sk=sk, fused=fused)))
        torch.cuda.empty_cache()
    exp_per_s, sms, mhz = _exp_rate()
    log(f"[kernels] exponentials' bound: B*H*Sq*Sk / ({EXP_PER_CLOCK_PER_SM} per clock x {sms} SMs "
        f"x {mhz:.0f} MHz max SM clock) = {exp_per_s / 1e12:.3f} T/s")
    for lbl, shape, sk, dtype, with_lse in RESIDENT_CHECKS:
        max_err[RES_KERNEL] = max(max_err[RES_KERNEL], _check_resident(
            lbl, *_qkv(shape, dtype, seed=len(lbl) + 1, sk=sk), with_lse))
        torch.cuda.empty_cache()

    rows = {name: [] for name in KERNELS}
    for lbl, shape, with_lse in PATH_SHAPES:
        b, s, h, d = shape
        q, k, v = _qkv(shape, torch.bfloat16, seed=7)
        max_err[FWD_KERNEL] = max(max_err[FWD_KERNEL], _check(lbl, q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v, with_lse=with_lse), iters=20)
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, with_lse=with_lse),
                           iters=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                         iters=20)
        flops = 4.0 * b * h * s * s * d
        nbytes = 4.0 * b * s * h * d * 2 + (4.0 * b * s * h if with_lse else 0.0)
        bound_ms, bound_by = _bound(flops, nbytes)
        exp_ms = b * h * s * s / exp_per_s * 1e3 if d == 64 else None
        row = dict(shape=list(shape), with_lse=with_lse, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        log(f"[kernels] {FWD_KERNEL} {lbl} {tuple(shape)} bf16 lse={with_lse}: kernel {ms:.3f} "
            f"ms ({row['tflops']:.0f} TFLOP/s; earlier design {EARLIER_FWD_MS[lbl]:.3f} ms), bound "
            f"{bound_ms:.3f} ms ({bound_by})"
            + (f", exponentials' bound {exp_ms:.3f} ms" if exp_ms is not None else "")
            + f", plain {plain_ms:.2f} ms, sdpa {lib_ms:.3f} ms")
        rows[FWD_KERNEL].append((lbl, row))
        if lbl in RESIDENT_TIMED:
            res_ms = cuda_ms(lambda: flash_attention_resident(q, k, v), iters=20)
            rows[RES_KERNEL].append((lbl, dict(row, ms=res_ms, streamed_ms=ms,
                                               tflops=flops / res_ms / 1e9)))
            log(f"[kernels] {RES_KERNEL} {lbl} {tuple(shape)} bf16: kernel {res_ms:.3f} ms "
                f"({flops / res_ms / 1e9:.0f} TFLOP/s), streamed kernel {ms:.3f} ms, bound "
                f"{bound_ms:.3f} ms ({bound_by}), plain {plain_ms:.2f} ms, sdpa {lib_ms:.3f} ms")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for lbl, shape, sk, dtype, fused in BWD_EXTRA_CHECKS:
        errs = _check_bwd(lbl, *_qkv(shape, dtype, seed=len(lbl), sk=sk, fused=fused),
                          _qkv(shape, dtype, seed=99)[0])
        for name, e in errs.items():
            max_err[name] = max(max_err[name], e)
        torch.cuda.empty_cache()
    for lbl, shape in TRAIN_SHAPES:
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


def _train_batch(b, f, hw, id_dim, device, seed=0):
    """A seeded synthetic training batch (the layout `train_loss` takes);
    the face mask is a box in the upper middle of every frame."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    mask = torch.zeros((b, f, hw, hw, 1), device=device)
    mask[:, :, hw // 8:hw // 2, 3 * hw // 8:5 * hw // 8] = 1.0
    return {"frames": uniform(-1, 1, b, f, hw, hw, 3), "ref_image": uniform(0, 1, b, hw, hw, 3),
            "pose_pixels": uniform(-1, 1, b, f, hw, hw, 3),
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
        batch = _train_batch(1, 2, 128, models.face_encoder.config.id_embeddings_dim, "cpu", seed=1)
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
    return results, (models, cfg, ref, pose, face)


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
              DKV_KERNEL: flash_attention_bwd.launches[DKV_KERNEL],
              DQ_KERNEL: flash_attention_bwd.launches[DQ_KERNEL]}
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
    """The flat 16-frame request with the resident budget at 0 (streamed
    kernel) and at 4 MiB (resident kernel at UNet levels 0 and 1), in turns
    0, 4 MiB, 4 MiB, 0; each run's launches asserted."""
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
    from stableanimator_tpu_torch.pipeline.animation import generate

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
    log(f"[ab] flat {cfg.num_frames}-frame request: streamed route (budget 0) "
        f"{', '.join(f'{t:.3f}' for t in times[0])} s, mean {mean[0]:.3f} s; resident route "
        f"(budget {RESIDENT_BUDGET}) {', '.join(f'{t:.3f}' for t in times[RESIDENT_BUDGET])} s, "
        f"mean {mean[RESIDENT_BUDGET]:.3f} s; resident / streamed "
        f"{mean[RESIDENT_BUDGET] / mean[0]:.4f}")


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


def phase_longvideo(steps: int):
    """`cli.animate.main` at full width on a 64-frame 512x512 request with the
    resident budget at 4 MiB; counts and outputs asserted."""
    import numpy as np
    from PIL import Image

    from stableanimator_tpu_torch.cli import animate
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts

    hw = 512
    with tempfile.TemporaryDirectory() as tmp:
        ref, poses = _write_longvideo_inputs(tmp, LONGVIDEO_FRAMES, hw)
        out = os.path.join(tmp, "out")
        argv = ["--checkpoint_dir", os.path.join(tmp, "nockpt"), "--reference_image", ref,
                "--pose_control_folder", poses, "--output_dir", out, "--height", str(hw),
                "--width", str(hw), "--num_inference_steps", str(steps), "--allow_random_init",
                "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _resident_budget(RESIDENT_BUDGET):
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
    res_expected = 10 * LONGVIDEO_TILES * steps
    got = {k: counts["by_kernel"][k] for k in KERNELS}
    log(f"[longvideo] cli {LONGVIDEO_FRAMES} frames {hw}x{hw}, {steps} steps: request "
        f"{sec:.2f} s, {LONGVIDEO_FRAMES / sec:.3f} frames/s; phases "
        + ", ".join(f"{k} {v:.2f} s" for k, v in info["phases"].items())
        + f"; main() {wall:.1f} s in all (model build, pose PNGs, outputs); peak "
        f"{peak_gb:.1f} GiB; warm {info['warm']}; launches {got}, refused {counts['refused']} "
        "(by (B, Sq, Sk, H, D) " + ", ".join(f"{k}: {n}" for k, n in counts["by_shape"].items())
        + f"); {len(progress)} progress lines; {len(names)} PNGs {frames.shape} mean "
        f"{frames.mean():.3f} std {frames.std():.3f}, frame-to-frame std "
        f"{frames.astype(np.float32).std(axis=0).mean():.3f}; gif {gif_frames} frames, mp4 "
        f"{mp4_bytes} bytes")
    checks = {
        "64 PNGs of 512x512x3": frames.shape == (LONGVIDEO_FRAMES, hw, hw, 3),
        "gif of 64 frames, mp4 written": gif_frames == LONGVIDEO_FRAMES and mp4_bytes > 0,
        "frames not constant": frames.std() > 1.0
        and frames.astype(np.float32).std(axis=0).mean() > 0.0,
        "one progress line per 5-step segment": len(progress) == -(-steps // 5),
        f"{res_expected} resident launches": got[RES_KERNEL] == res_expected,
        f"{LONGVIDEO_DECODE_GROUPS} streamed launches": got[FWD_KERNEL] == LONGVIDEO_DECODE_GROUPS,
        f"{LONGVIDEO_DECODE_GROUPS} refused": counts["refused"] == LONGVIDEO_DECODE_GROUPS,
        "no backward launches": got[DKV_KERNEL] == got[DQ_KERNEL] == 0,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"the 64-frame CLI request failed its checks: {failed}")
    return dict(seconds=sec, wall=wall, phases=info["phases"], peak_gib=peak_gb, **counts)


def phase_train():
    from stableanimator_tpu_torch.core.config import PipelineConfig, TrainConfig
    from stableanimator_tpu_torch.ops.flash_attention import reset_launch_counts
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
    batch = _train_batch(1, cfg.sample_n_frames, pipe.height,
                         models.face_encoder.config.id_embeddings_dim, "cuda")
    generator = torch.Generator(device="cuda").manual_seed(0)
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
        log(f"[train] step {state.step} ({run}, update {state.updates - 1} at lr "
            f"{state.optimizer.param_groups[0]['lr']:.3e}): {total:.3f} s; phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f"; peak {peak_gb:.1f} GiB; loss {loss:.5f} grad_norm {gn:.4f}; sampled masters "
            f"moved {moved} of {sum(s.numel() for s in sample)}; launches "
            + ", ".join(f"{k} {n}" for k, n in counts["by_kernel"].items()))
        if not (torch.isfinite(torch.tensor([loss, gn])).all() and gn > 0):
            raise SystemExit(f"training step {state.step}: loss {loss}, grad_norm {gn}")
        if counts["by_kernel"] != TRAIN_LAUNCHES:
            raise SystemExit(f"training step launched {counts['by_kernel']}, expected "
                             f"{TRAIN_LAUNCHES}")
        # update 0 runs at lr 0; update 1 at lr 2e-8 moves the fp32 masters
        if i == 1 and moved == 0:
            raise SystemExit("the fp32 master parameters did not move in update 1")
        steps.append(dict(seconds=total, phases=timings, loss=loss, grad_norm=gn,
                          peak_gib=peak_gb, **counts))
    timed = steps[1:]
    sec = sum(s["seconds"] for s in timed) / len(timed)
    phases = {k: sum(s["phases"][k] for s in timed) / len(timed) for k in timed[0]["phases"]}
    log(f"[train] {len(timed)} timed steps: {sec:.3f} s/step, {3600.0 / sec:.1f} clips/hour "
        f"(1 clip of {cfg.sample_n_frames} frames at {pipe.height}x{pipe.width} per step); "
        "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
        + f"; peak {max(s['peak_gib'] for s in timed):.1f} GiB")
    return dict(steps=steps, sec_per_step=sec, phases=phases), (state, step_fn, batch, generator)


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


def _profile(label: str, fn):
    import re

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
    busy = sum(r[0] for r in rows)
    log(f"[profile] {label} under the profiler: wall {wall:.3f} s, device kernel time "
        f"{busy:.3f} s, busy share {busy / wall if wall else 0:.3f}, idle share "
        f"{1 - busy / wall if wall else 0:.3f}")
    if not rows:
        log("[profile] the profiler saw no device time")
        return
    cats: dict = {}
    for sec, _, name in rows:
        cat = next((c for c, pat in CATEGORIES if re.search(pat, name, re.I)), "other")
        cats[cat] = cats.get(cat, 0.0) + sec
    log(f"[profile] {label}: device time by category: " + ", ".join(
        f"{c} {v:.3f} s ({v / busy:.1%})" for c, v in sorted(cats.items(), key=lambda x: -x[1])))
    for sec, count, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {sec:8.3f} s  {count:6d}x  {name[:110]}")


def profile_generate(models, cfg, ref, pose, face):
    from stableanimator_tpu_torch.pipeline.animation import generate

    _profile(f"one {cfg.num_inference_steps}-step request",
             lambda: generate(models, ref, pose, face, cfg, device="cuda"))


def _kernel_entries(max_err, rows, gen, longvideo, train) -> list:
    """The JSON line's entries: each kernel's times at its shapes, weighted
    by the launches the main paths made at those shapes (generate's timed
    request, the 64-frame CLI request and one timed training step)."""
    paths = {}
    if gen:
        paths["generate"] = {(FWD_KERNEL, key): n for key, n in gen["timed"]["by_shape"].items()}
    if longvideo:
        paths["longvideo"] = longvideo["by_shape"]
    if train:
        paths["train"] = train["steps"][-1]["by_shape"]
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
        entries.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": sum(pp["launches"] for pp in per_path.values()) if paths else None,
            "max_abs_err": max_err[name],
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": ("operations" if all(r["bound_by"] == "operations" for _, r in rows[name])
                         else "bytes"),
            "library_ms": total["library_ms"],
            "per_request_of": "sum over the launches of generate's timed request, of the "
                              "64-frame CLI request and of one timed training step",
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
                        help=f"comma-separated subset of {ALL_PHASES}")
    parser.add_argument("--steps", type=int, default=25, help="Euler steps per request")
    args = parser.parse_args()
    phases = args.phases.split(",")
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
    if "device" in phases:
        phase_device()
    if "build" in phases:
        phase_build()
    gen = longvideo = train = None
    if "kernels" in phases:
        max_err, rows = phase_kernels()
    if "small" in phases:
        phase_small()
    if "generate" in phases:
        gen, state = phase_generate(args.steps)
        if "profile" in phases:
            profile_generate(*state)
        phase_ab(*state)
        del state
        torch.cuda.empty_cache()
    if "longvideo" in phases:
        longvideo = phase_longvideo(args.steps)
        torch.cuda.empty_cache()
    if "train" in phases:
        train, (state, step_fn, batch, generator) = phase_train()
        if "profile" in phases:
            _profile("one training step",
                     lambda: step_fn(state, batch, generator=generator))
        del state, step_fn, batch
        torch.cuda.empty_cache()
        train_cli()
    if "kernels" in phases:
        log(json.dumps({"kernels": _kernel_entries(max_err, rows, gen, longvideo, train)}))
    log(f"[chip_smoke] phases {phases} done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
