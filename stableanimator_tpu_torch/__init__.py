"""StableAnimator in PyTorch + CUDA for NVIDIA Hopper: a port of the JAX
package `stableanimator_tpu`, which stays the reference it is tested against.

Same layout as the JAX package (core/, ops/, models/, diffusion/,
pipeline/, convert/), same channels-last layouts at the public functions,
diffusers / reference parameter names. Kernels written by hand live in
csrc/ and are built with nvcc on first use (ops/build.py). Entry points
run on CUDA unless the caller passes device="cpu".
"""

import os

__version__ = "0.1.0"

# the directory that holds the package
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subprocess_env() -> dict:
    """This process's environment with ROOT first on PYTHONPATH, for the
    port's modules run in subprocesses (`python -m stableanimator_tpu_torch...`)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env
