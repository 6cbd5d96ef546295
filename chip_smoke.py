#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`stableanimator_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port still starts and is right on
the card.

    python3 chip_smoke.py                 # every phase, 25 Euler steps
    python3 chip_smoke.py --phases device,build,kernels   # kernel bring-up only

Phases, in order (any failure exits nonzero; no phase's exception is caught):
  device   card name and power limit (nvidia-smi); TF32 stated and set off
  build    builds the flash-attention kernel from csrc/ with nvcc
  kernels  the kernel against its plain PyTorch version, with and without
           lse, at the main path's full shapes in bf16 and at ragged and
           fp16 shapes; then timed at the path's shapes with CUDA events
           beside its bound, its plain version and the PyTorch library call
  small    micro-config generate on the card against the same on the CPU
  generate full-width (SVD-XT, CLIP ViT-H, ...) 512x512x16f generate() with
           seeded weights: one warm-up request, one timed request; output
           shape / range and the kernel launch counts are asserted; the
           timed request's launches, counted by shape, weight the kernel's
           per-request times
  profile  one more request under torch.profiler: device time by kernel
           category, the busiest kernels, and the device's busy share
Before the last line it prints one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

# published peaks of one H100 SXM at 700 W: dense bf16 FLOP/s, HBM bytes/s
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
KERNEL_NAME = "flash_attention_fwd"
# the kernel's shapes on the main path, [B, S, H, D]: UNet levels 0 and 1
# (CFG x 16 frames) and the VAE decoder's mid block
PATH_SHAPES = (("unet_level0", (32, 4096, 5, 64)), ("unet_level1", (32, 1024, 10, 64)),
               ("vae_mid", (16, 4096, 1, 512)))
# further checks: the d=512 instantiation in fp16, ragged sequences
EXTRA_CHECKS = (("vae_mid", (2, 4096, 1, 512), torch.float16),
                ("ragged_576", (2, 576, 20, 64), torch.bfloat16),
                ("ragged_300", (1, 300, 2, 64), torch.bfloat16),
                ("ragged_300", (1, 300, 2, 64), torch.float16))
ALL_PHASES = ("device", "build", "kernels", "small", "generate", "profile")
# device kernels by name, for the profile's breakdown (first match wins)
CATEGORIES = (("flash_attention_fwd", r"flash_fwd_kernel"),
              ("conv", r"conv|cudnn|fprop|dgrad|implicit_convolve|winograd"),
              ("gemm", r"gemm|gemv|nvjet|cutlass|xmma|sm90_|cublas|matmul"),
              ("norm/softmax/reduce", r"reduce|softmax|norm|welford"),
              ("copy/layout", r"copy|cat|transpose|permute|index|gather|scatter|fill"),
              ("elementwise", r"elementwise|vectorized|unrolled|pointwise"))
# kernel vs plain version: the output within `kernel_tolerance` (one output
# ulp plus 2 eps of the output's rms); lse is fp32 in both, so summation
# order only
LSE_ATOL = 1e-3
# fp32 micro generate, card vs CPU (TF32 off): reduction order only
SMALL_ATOL = 2e-3


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
    path = build.build_kernel(KERNEL_NAME)
    log(f"[build] {KERNEL_NAME} in {time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build]   {line.strip()}")


def _qkv(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, h, d = shape
    return [torch.randn((b, sq, h, d), generator=gen, device="cuda", dtype=torch.float32).to(dtype)
            for _ in range(3)]


def _check(lbl, q, k, v) -> float:
    """The kernel, with and without lse, against its plain version; returns
    the largest absolute error of the output."""
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
    log(f"[kernels] {lbl} {tuple(q.shape)} {str(q.dtype)[6:]}: max|o-ref| {err:.3e}, "
        f"{share:.3f} of the bound (eps|ref| + 2 eps rms(ref), rms "
        f"{ref_o.float().square().mean().sqrt().item():.3e}); max|lse-ref| {err_lse:.3e} tol "
        f"{LSE_ATOL} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{KERNEL_NAME} disagrees with its plain version at {lbl}")
    return err


def phase_kernels():
    from stableanimator_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )

    max_err = 0.0
    for lbl, shape, dtype in EXTRA_CHECKS:
        max_err = max(max_err, _check(lbl, *_qkv(shape, dtype, seed=len(lbl))))
    torch.cuda.empty_cache()

    per_shape = []
    for lbl, shape in PATH_SHAPES:
        b, s, h, d = shape
        q, k, v = _qkv(shape, torch.bfloat16, seed=7)
        max_err = max(max_err, _check(lbl, q, k, v))
        ms = cuda_ms(lambda: flash_attention(q, k, v), iters=20)
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v), iters=2, warmup=1)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                         iters=20)
        flops = 4.0 * b * h * s * s * d
        nbytes = 4.0 * b * s * h * d * 2          # q, k, v read once, o written once
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=list(shape), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tflops=flops / ms / 1e9)
        log(f"[kernels] {lbl} {tuple(shape)} bf16: kernel {ms:.3f} ms ({row['tflops']:.0f} "
            f"TFLOP/s), bound {row['bound_ms']:.3f} ms ({row['bound_by']}), plain "
            f"{plain_ms:.2f} ms, sdpa {lib_ms:.3f} ms")
        per_shape.append((lbl, row))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return max_err, per_shape


def _inputs(h, w, f, id_dim, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    ref = torch.rand((1, h, w, 3), generator=gen, device=device)
    pose = torch.rand((f, h, w, 3), generator=gen, device=device) * 2.0 - 1.0
    face = torch.randn((1, id_dim), generator=gen, device=device)
    aug = torch.randn((1, h, w, 3), generator=gen, device=device)
    return ref, pose, face, aug


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


def phase_profile(models, cfg, ref, pose, face):
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stableanimator_tpu_torch.pipeline.animation import generate

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate(models, ref, pose, face, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: the host ops that launched them carry the
    # same time again as their "self device time"
    rows = [(ev.self_device_time_total / 1e6, ev.count, ev.key) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    log(f"[profile] one {cfg.num_inference_steps}-step request under the profiler: wall "
        f"{wall:.2f} s, device kernel time {busy:.2f} s, busy share "
        f"{busy / wall if wall else 0:.3f}, idle share {1 - busy / wall if wall else 0:.3f}")
    if not rows:
        log("[profile] the profiler saw no device time")
        return
    cats: dict = {}
    for sec, _, name in rows:
        cat = next((c for c, pat in CATEGORIES if re.search(pat, name, re.I)), "other")
        cats[cat] = cats.get(cat, 0.0) + sec
    log("[profile] device time by category: " + ", ".join(
        f"{c} {v:.3f} s ({v / busy:.1%})" for c, v in sorted(cats.items(), key=lambda x: -x[1])))
    for sec, count, name in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {sec:8.3f} s  {count:6d}x  {name[:110]}")


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
    kernels = []
    if "build" in phases:
        phase_build()
    gen = None
    if "kernels" in phases:
        max_err, per_shape = phase_kernels()
    if "small" in phases:
        phase_small()
    if "generate" in phases:
        gen, state = phase_generate(args.steps)
        if "profile" in phases:
            phase_profile(*state)
            del state
    if "kernels" in phases:
        rows = [r for _, r in per_shape]
        keys = ("ms", "plain_ms", "library_ms", "bound_ms")
        per_req = dict.fromkeys(keys)
        # the timed request's launches by shape weight each shape's times
        counts = gen["timed"]["by_shape"] if gen else {}
        for r in rows:
            b, s, h, d = r["shape"]
            r["launches_per_request"] = counts.get((b, s, s, h, d), 0) if gen else None
        if gen:
            timed = {(b, s, s, h, d) for b, s, h, d in (r["shape"] for r in rows)}
            if set(counts) - timed:
                raise SystemExit(f"the main path launched {KERNEL_NAME} at shapes not timed: "
                                 f"{sorted(set(counts) - timed)}")
            per_req = {key: sum(r[key] * r["launches_per_request"] for r in rows) for key in keys}
        kernels.append({
            "name": KERNEL_NAME, "route": "cuda",
            "source": "stableanimator_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "stableanimator_tpu/ops/flash_attention.py:70",
            "launches": gen["timed"]["launches"] if gen else None,
            "max_abs_err": max_err,
            "ms": per_req["ms"], "plain_ms": per_req["plain_ms"],
            "bound_ms": per_req["bound_ms"],
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows)
            else "bytes",
            "library_ms": per_req["library_ms"],
            "per_request_of": "sum over the main path's launches of one request",
            "shapes": {lbl: r for lbl, r in per_shape},
        })
        log(json.dumps({"kernels": kernels}))
    log(f"[chip_smoke] phases {phases} done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
