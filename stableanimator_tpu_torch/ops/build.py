"""Builds the port's native sources into shared libraries, on first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper (sm_90a), each `csrc/<name>.cpp` (host code: the skeleton
raster) by `g++`, into `csrc/_build/lib<name>_<hash>.so`, where the hash
covers the source, every header under `csrc/` (`*.cuh`, `*.h`: any source
may include any of them) and the compiler's flags: a changed source or
header builds anew, an unchanged tree is reused. The library is loaded with
ctypes by the module that wraps it. Nothing is built at import time.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
HEADER_SUFFIXES = (".cuh", ".h")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                           "CUDA kernels are built on the machine with the GPU")
    return path


def _source(name: str) -> Path:
    """`csrc/<name>.cu`, or `csrc/<name>.cpp` where there is no `.cu`."""
    src = CSRC / f"{name}.cu"
    return src if src.exists() else CSRC / f"{name}.cpp"


def _command(src: Path, out: Path) -> list:
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return ["g++", *GXX_FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` (or `.cpp`) builds to:
    `csrc/_build/lib<name>_<hash>.so`, the hash over the source, each header
    under `csrc/` (its path and bytes) and its compiler's flags."""
    build_dir = CSRC / "_build"
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.rglob("*")):
        if header.suffix in HEADER_SUFFIXES and build_dir not in header.parents:
            digest.update(b"\0" + header.relative_to(CSRC).as_posix().encode() + b"\0")
            digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS).encode())
    return build_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_kernel(name: str) -> Path:
    """Compile `csrc/<name>.cu` (or `.cpp`) unless the library for this exact
    source, headers and flags is already built; returns its path. The
    compiler's report (for nvcc: ptxas registers, shared memory, spills) is
    kept beside it as `.log`."""
    src = _source(name)
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(_command(src, tmp), capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        compiler = "nvcc" if src.suffix == ".cu" else "g++"
        raise RuntimeError(f"{compiler} failed for {src.name} (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out
