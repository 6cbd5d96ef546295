#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`stableanimator_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port still starts and is right on
the card.

    python3 chip_smoke.py                 # every phase, 25 Euler steps
    python3 chip_smoke.py --phases device,build,kernels   # kernel bring-up only

Phases, in order (any failure exits nonzero; no phase's exception is caught):
  device   card name and power limit (nvidia-smi); TF32 stated and set off
  build    builds the flash-attention forward and backward kernels from
           csrc/ with nvcc, one process per source, in parallel
  kernels  the forward kernel against its plain PyTorch version, with and
           without lse, at both main paths' full shapes in bf16 and at
           ragged and fp16 shapes; the backward kernels (through the
           autograd Function) against the plain backward within
           `grad_tolerance` at the training shapes and ragged bf16/fp16
           ones; then every kernel timed with CUDA events at the paths'
           shapes beside its bound, its plain version and the PyTorch
           library call
  small    micro-config generate, and two micro-config fp32 training
           steps, on the card against the same on the CPU
  generate full-width (SVD-XT, CLIP ViT-H, ...) 512x512x16f generate() with
           seeded weights: one warm-up request, one timed request; output
           shape / range and the kernel launch counts are asserted; the
           timed request's launches, counted by shape, weight the forward
           kernel's per-request times
  train    full-width training (remat, bf16 over fp32 masters, trainable
           unet, pose_net, face_encoder) on a seeded 1x16x512x512 batch:
           one warm-up step and three timed steps through make_train_step;
           loss / grad_norm finite, the fp32 masters moved, and the launches
           of every kernel per step asserted; then the training CLI at the
           micro scale for 2 steps on a PNG dataset, and a resume
  profile  one more request and one more training step under
           torch.profiler: device time by kernel category, the busiest
           kernels, and the device's busy share
Before the last line it prints one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

# published peaks of one H100 SXM at 700 W: dense bf16 FLOP/s, HBM bytes/s
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
FWD_KERNEL, BWD_SOURCE = "flash_attention_fwd", "flash_attention_bwd"
DKV_KERNEL, DQ_KERNEL = "flash_attention_bwd_dkv", "flash_attention_bwd_dq"
REPLACES = {FWD_KERNEL: "stableanimator_tpu/ops/flash_attention.py:70",
            DKV_KERNEL: "stableanimator_tpu/ops/flash_attention.py:326",
            DQ_KERNEL: "stableanimator_tpu/ops/flash_attention.py:372"}
SOURCES = {FWD_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_fwd.cu",
           DKV_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_bwd.cu",
           DQ_KERNEL: "stableanimator_tpu_torch/csrc/flash_attention_bwd.cu"}
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
# further forward checks: the d=512 instantiation in fp16, ragged sequences
EXTRA_CHECKS = (("vae_mid", (2, 4096, 1, 512), torch.float16),
                ("ragged_576", (2, 576, 20, 64), torch.bfloat16),
                ("ragged_300", (1, 300, 2, 64), torch.bfloat16),
                ("ragged_300", (1, 300, 2, 64), torch.float16))
# further backward checks: (label, q shape, kv length, dtype)
BWD_EXTRA_CHECKS = (("ragged_300", (1, 300, 2, 64), 300, torch.bfloat16),
                    ("ragged_300", (1, 300, 2, 64), 300, torch.float16),
                    ("ragged_640_576", (2, 640, 2, 64), 576, torch.bfloat16),
                    ("ragged_640_576", (2, 640, 2, 64), 576, torch.float16))
ALL_PHASES = ("device", "build", "kernels", "small", "generate", "train", "profile")
# device kernels by name, for the profile's breakdown (first match wins)
CATEGORIES = (("flash_attention_fwd", r"flash_fwd_kernel"),
              ("flash_attention_bwd_dkv", r"flash_bwd_dkv_kernel"),
              ("flash_attention_bwd_dq", r"flash_bwd_dq_kernel"),
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
TRAIN_LAUNCHES = {FWD_KERNEL: 20, DKV_KERNEL: 10, DQ_KERNEL: 10}
TRAIN_TIMED_STEPS = 3


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


def phase_build():
    from stableanimator_tpu_torch.ops import build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:   # one nvcc per source
        paths = dict(zip((FWD_KERNEL, BWD_SOURCE),
                         pool.map(build.build_kernel, (FWD_KERNEL, BWD_SOURCE))))
    log(f"[build] {', '.join(paths)} in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log_file = path.with_suffix(".log")
        report = log_file.read_text() if log_file.exists() else ""
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {name}: {line.strip()}")


def _qkv(shape, dtype, seed, sk=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, h, d = shape
    return [torch.randn((b, s, h, d), generator=gen, device="cuda", dtype=torch.float32).to(dtype)
            for s in (sq, sk or sq, sk or sq)]


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
    log(f"[kernels] fwd {lbl} {tuple(q.shape)} {str(q.dtype)[6:]}: max|o-ref| {err:.3e}, "
        f"{share:.3f} of the bound (eps|ref| + 2 eps rms(ref), rms "
        f"{ref_o.float().square().mean().sqrt().item():.3e}); max|lse-ref| {err_lse:.3e} tol "
        f"{LSE_ATOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{FWD_KERNEL} disagrees with its plain version at {lbl}")
    return err


def _check_bwd(lbl, q, k, v, do) -> dict:
    """dQ, dK, dV through the autograd Function (the backward kernels)
    against the plain backward on the o and lse the forward kernel gives;
    returns the largest absolute error of each kernel's outputs."""
    from stableanimator_tpu_torch.ops import flash_attention as fa

    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
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
    log(f"[kernels] bwd {lbl} q {tuple(q.shape)} kv {k.shape[1]} {str(q.dtype)[6:]}: "
        "max|g-ref| dq/dk/dv " + " ".join(f"{e:.3e}" for e in errs) + ", share of "
        "grad_tolerance (eps|ref| + eps/4 rms(ref)) " + " ".join(f"{s:.3f}" for s in shares)
        + f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"the backward kernels disagree with the plain backward at {lbl}")
    return {DQ_KERNEL: errs[0], DKV_KERNEL: max(errs[1:])}


def _time_bwd(lbl, shape) -> dict:
    """CUDA-event times of each backward kernel at a training shape, beside
    its bound, the plain backward and SDPA's backward."""
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
        rows[name] = dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                          library_ms=sdpa_fb - sdpa_fwd, bound_ms=bound_ms, bound_by=bound_by,
                          tflops=flops / ms / 1e9)
        log(f"[kernels] {name} {lbl} {tuple(shape)} bf16: kernel {ms:.3f} ms "
            f"({rows[name]['tflops']:.0f} TFLOP/s), bound {bound_ms:.4f} ms ({bound_by}); plain "
            f"backward {plain_ms:.2f} ms, sdpa backward {sdpa_fb - sdpa_fwd:.3f} ms "
            f"(fwd+bwd {sdpa_fb:.3f} - fwd {sdpa_fwd:.3f})")
    return rows


def phase_kernels():
    from stableanimator_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    max_err = {FWD_KERNEL: 0.0, DKV_KERNEL: 0.0, DQ_KERNEL: 0.0}
    for lbl, shape, dtype in EXTRA_CHECKS:
        max_err[FWD_KERNEL] = max(max_err[FWD_KERNEL],
                                  _check(lbl, *_qkv(shape, dtype, seed=len(lbl))))
    torch.cuda.empty_cache()

    rows = {FWD_KERNEL: [], DKV_KERNEL: [], DQ_KERNEL: []}
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
        row = dict(shape=list(shape), with_lse=with_lse, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops=flops / ms / 1e9)
        log(f"[kernels] {FWD_KERNEL} {lbl} {tuple(shape)} bf16 lse={with_lse}: kernel {ms:.3f} "
            f"ms ({row['tflops']:.0f} TFLOP/s), bound {bound_ms:.3f} ms ({bound_by}), plain "
            f"{plain_ms:.2f} ms, sdpa {lib_ms:.3f} ms")
        rows[FWD_KERNEL].append((lbl, row))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()

    for lbl, shape, sk, dtype in BWD_EXTRA_CHECKS:
        errs = _check_bwd(lbl, *_qkv(shape, dtype, seed=len(lbl), sk=sk),
                          _qkv(shape, dtype, seed=99)[0])
        for name, e in errs.items():
            max_err[name] = max(max_err[name], e)
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
    """Launches since the last reset, by kernel, and by (kernel, shape)."""
    from stableanimator_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd

    counts = {FWD_KERNEL: flash_attention.launches, **flash_attention_bwd.launches}
    by_shape = {(FWD_KERNEL, key): n for key, n in flash_attention.launches_by_shape.items()}
    by_shape.update(flash_attention_bwd.launches_by_shape)
    return {"by_kernel": counts, "by_shape": by_shape}


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


def _kernel_entries(max_err, rows, gen, train) -> list:
    """The JSON line's entries: each kernel's times at its shapes, weighted
    by the launches the main paths made at those shapes (generate's timed
    request and one timed training step)."""
    paths = {}
    if gen:
        paths["generate"] = {(FWD_KERNEL, key): n for key, n in gen["timed"]["by_shape"].items()}
    if train:
        paths["train"] = train["steps"][-1]["by_shape"]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    entries = []
    for name in (FWD_KERNEL, DKV_KERNEL, DQ_KERNEL):
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
            "per_request_of": "sum over the launches of generate's timed request and of one "
                              "timed training step",
            "per_path": per_path,
            "library_of": ("scaled_dot_product_attention" if name == FWD_KERNEL else
                           "scaled_dot_product_attention's backward (fwd+bwd less fwd), which "
                           "computes dq, dk and dv together"),
            "plain_of": ("flash_attention_reference" if name == FWD_KERNEL else
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

    t_start = time.perf_counter()
    if "device" in phases:
        phase_device()
    if "build" in phases:
        phase_build()
    gen = train = None
    if "kernels" in phases:
        max_err, rows = phase_kernels()
    if "small" in phases:
        phase_small()
    if "generate" in phases:
        gen, state = phase_generate(args.steps)
        if "profile" in phases:
            profile_generate(*state)
        del state
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
        log(json.dumps({"kernels": _kernel_entries(max_err, rows, gen, train)}))
    log(f"[chip_smoke] phases {phases} done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
