"""Two builds of the flash-attention backward on the card, side by side: this
checkout's `csrc/flash_attention_bwd.cu` and the same source of another
checkout (for example the parent commit, unpacked with `git archive`), on
the same inputs.

    python -m stableanimator_tpu_torch.tools.bwd_ab --watchdog
    python -m stableanimator_tpu_torch.tools.bwd_ab --other parent_checkout [--other ...]

Each build is compiled by nvcc with `build.NVCC_FLAGS` into a directory of
its own under `--out` (default `csrc/_build/bwd_ab/`) and bound with ctypes
(`bind_bwd_library`); its ptxas report (registers, spills) and, from
`cuobjdump -sass`, each d = 512 kernel's wgmma (HGMMA), TMA load (UTMALDG)
and mma.sync (HMMA) counts are printed. Then this build's d = 512 pair, and
the d = 64 pair at two shapes, are held against the plain backward within
`grad_tolerance` at edge shapes (single and ragged streamed tiles, q shorter
than kv and the reverse, two heads, fused QKV views, fp16), twice each, the
two runs equal bit for bit. A failed check exits 1 before anything is timed.

`--watchdog` builds the sources (this checkout's and every `--other`'s)
with an mbarrier wait that traps after about 4 s of the SM clock
(`watchdog_source`), so that a deadlock in a kernel's barriers is a launch
error and not a card that hangs until the call's time limit: the first run
after a change to the barriers. Every build is then checked and none is
timed (the trapping wait changes the code around it).

`--other DIR` (repeatable: a checkout, or a variant of this one's sources
under a directory that `.gitignore` lists) then times each d = 512 kernel
of every build with CUDA events at the face optimisation's shapes (crops 24
and 32, bf16), the builds in turns (the others, this, this, the others in
reverse), and prints the card's name and power limit beside them. Only this
build is checked: a variant may be wrong on purpose, to time what a part of
the kernel costs. Runs on the card only.
"""

from __future__ import annotations

import argparse
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from stableanimator_tpu_torch.ops import build
from stableanimator_tpu_torch.ops import flash_attention as fa

# the d = 512 pair's check shapes: (q shape [B, Sq, H, D], kv length, dtype,
# fused QKV views); a q tile or kv tile shorter than one streamed tile, one
# kv tile only, q and kv off the 64-row block and the 16-row tile, two heads,
# the face optimisation's crops 23 (529 tokens), 24 and 32 (fp16 too)
D512_CHECKS = (((1, 8, 1, 512), 40, torch.bfloat16, False),
               ((2, 40, 1, 512), 8, torch.bfloat16, False),
               ((2, 100, 2, 512), 300, torch.bfloat16, False),
               ((2, 200, 2, 512), 300, torch.bfloat16, False),
               ((1, 200, 1, 512), 1024, torch.bfloat16, False),
               ((4, 72, 1, 512), 1000, torch.float16, False),
               ((2, 640, 1, 512), 640, torch.bfloat16, True),
               ((16, 529, 1, 512), 529, torch.bfloat16, False),
               ((16, 576, 1, 512), 576, torch.bfloat16, False),
               ((16, 1024, 1, 512), 1024, torch.bfloat16, False),
               ((16, 1024, 1, 512), 1024, torch.float16, False))
# the d = 64 pair, built from the same source
D64_CHECKS = (((2, 1024, 5, 64), 1024, torch.bfloat16, False),
              ((1, 300, 2, 64), 300, torch.float16, False))
TIMED = (("faceopt_crop24", (16, 576, 1, 512)), ("faceopt_crop32", (16, 1024, 1, 512)))
D512_SYMBOLS = ("flash_bwd_dkv_d512", "flash_bwd_dq_d512")
# SM clocks the watchdog's mbarrier wait spins before it traps: ~4 s at the
# H100's 1,980 MHz
WATCHDOG_CLOCKS = 8_000_000_000
ITERS = 20  # timed launches of each kernel per turn
_WAIT_LOOP = "  uint32_t done = 0;\n  while (!done) {\n"


def watchdog_source(sm90: str) -> str:
    """`csrc/sm90.cuh`'s text with its mbarrier wait made to trap after
    WATCHDOG_CLOCKS clocks of spinning."""
    if sm90.count(_WAIT_LOOP) != 1:
        raise ValueError("sm90.cuh's mbarrier wait loop is not where the watchdog expects it")
    return sm90.replace(_WAIT_LOOP, (
        "  uint32_t done = 0;\n  const long long watchdog_t0 = clock64();\n  while (!done) {\n"
        f"    if (clock64() - watchdog_t0 > {WATCHDOG_CLOCKS}LL) __trap();\n"))


def build_library(csrc: Path, out: Path, watchdog: bool = False) -> Path:
    """Compile `csrc`'s flash_attention_bwd.cu (with its headers copied to
    `out`, sm90.cuh made a watchdog if asked) into `out`; prints the ptxas
    lines of the d = 512 kernels and returns the library's path."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for src in list(csrc.glob("*.cu")) + list(csrc.glob("*.cuh")):
        text = src.read_text()
        if watchdog and src.name == "sm90.cuh":
            text = watchdog_source(text)
        (out / src.name).write_text(text)
    lib = out / "libflash_attention_bwd.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / "flash_attention_bwd.cu")], capture_output=True, text=True)
    (out / "ptxas.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {csrc} (rc {proc.returncode}):\n{proc.stderr[-6000:]}")
    func = None
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if entry:
            func = entry.group(1)
        spills = "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
        if func and (spills or any(s in func for s in D512_SYMBOLS) and (
                "registers" in line or "spill" in line)):
            print(f"[build] {out.name} {func[-90:]}: {line.strip()}", flush=True)
    cuobjdump = shutil.which("cuobjdump") or str(Path(build._nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if any(s in name for s in D512_SYMBOLS):
            print(f"[build] {out.name} SASS {name[-90:]}: "
                  + ", ".join(f"{op} {body.count(op)}" for op in ("HGMMA", "UTMALDG", "HMMA")),
                  flush=True)
    return lib


def _inputs(shape, sk, dtype, fused, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, sq, h, d = shape
    if fused:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen, device="cuda").to(dtype)
        q, k, v = (qkv[:, :, i] for i in range(3))
    else:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
                   for s in (sq, sk, sk))
    do = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _run(kernels, q, k, v, o, lse, do):
    grads, launch = fa.bwd_launchers(q, k, v, o, lse, do, 1.0 / math.sqrt(q.shape[-1]),
                                     kernels=kernels)
    for name in fa.bwd_kernel_names(q.shape[-1]):
        launch[name]()
    return grads


def check(kernels) -> bool:
    """The build's kernels against the plain backward at the check shapes;
    prints each gradient's share of grad_tolerance, returns whether all hold
    and every second run equals the first."""
    ok = True
    for shape, sk, dtype, fused in D512_CHECKS + D64_CHECKS:
        q, k, v, do = _inputs(shape, sk, dtype, fused, seed=sum(shape) + sk)
        o, lse = fa.flash_attention(q, k, v, with_lse=True)
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
        got = _run(kernels, q, k, v, o, lse, do)
        again = _run(kernels, q, k, v, o, lse, do)
        torch.cuda.synchronize()
        shares = [((g.float() - w.float()).abs() / fa.grad_tolerance(w)).max().item()
                  for g, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        good = max(shares) <= 1.0 and same
        ok &= good
        print(f"[check] q {shape} kv {sk} {str(dtype)[6:]}{' fused' if fused else ''}: "
              "share of grad_tolerance dq/dk/dv " + " ".join(f"{x:.3f}" for x in shares)
              + f", same bits twice {same} -> {'ok' if good else 'FAIL'}", flush=True)
    return ok


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def time_builds(builds: dict) -> None:
    """Each d = 512 kernel of each build at the TIMED shapes, the builds in
    turns: the others, this, this, the others in reverse."""
    others = [key for key in builds if key != "this"]
    order = others + ["this", "this"] + others[::-1]
    for lbl, shape in TIMED:
        q, k, v, do = _inputs(shape, shape[1], torch.bfloat16, False, seed=3)
        o, lse = fa.flash_attention(q, k, v, with_lse=True)
        times = {name: {key: [] for key in builds} for name in fa.bwd_kernel_names(512)}
        for key in order:
            _, launch = fa.bwd_launchers(q, k, v, o, lse, do, 1.0 / math.sqrt(512),
                                         kernels=builds[key])
            for name, fn in launch.items():
                times[name][key].append(cuda_ms(fn, ITERS))
        for name, by_build in times.items():
            print(f"[ab] {name} {lbl} {shape} bf16: "
                  + "; ".join(f"{key} " + " ".join(f"{t:.4f}" for t in ts) + " ms"
                              for key, ts in by_build.items())
                  + f" (order {', '.join(order)}; {ITERS} launches each)", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, action="append", default=[],
                        help="a checkout whose backward to time beside (repeatable)")
    parser.add_argument("--watchdog", action="store_true",
                        help="build this checkout with trapping mbarrier waits")
    parser.add_argument("--out", type=Path, default=build.CSRC / "_build" / "bwd_ab",
                        help="where the builds go (a directory .gitignore lists)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ab needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    suffix = "_watchdog" if args.watchdog else ""
    builds = {"this": fa.bind_bwd_library(build_library(
        build.CSRC, args.out / f"this{suffix}", watchdog=args.watchdog))}
    if not check(builds["this"]):
        print("[check] FAIL", flush=True)
        return 1
    others = {}
    for other in args.other:
        lib = build_library(other / "stableanimator_tpu_torch" / "csrc",
                            args.out / f"{other.name}{suffix}", watchdog=args.watchdog)
        others[other.name] = fa.bind_bwd_library(lib)
        if args.watchdog:
            print(f"[check] {other.name}:", flush=True)
            if not check(others[other.name]):
                print("[check] FAIL", flush=True)
                return 1
    if others and not args.watchdog:
        time_builds({**others, **builds})
    return 0


if __name__ == "__main__":
    sys.exit(main())
