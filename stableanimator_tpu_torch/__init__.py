"""StableAnimator in PyTorch + CUDA for NVIDIA Hopper: a port of the JAX
package `stableanimator_tpu`, which stays the reference it is tested against.

Same layout as the JAX package (core/, ops/, models/, diffusion/,
pipeline/, convert/), same channels-last layouts at the public functions,
diffusers / reference parameter names. Kernels written by hand live in
csrc/ and are built with nvcc on first use (ops/build.py). Entry points
run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
