"""The active mesh (port of the JAX package's `ops/gate.py`).

Modules deep inside the UNet (the temporal resnet and transformer blocks)
need the mesh to run their frame-axis collectives, but threading it
through every forward would change every signature. The pipeline sets this
contextvar around a mesh-sharded call instead; `use_mesh` scopes it.
"""

from __future__ import annotations

import contextlib
import contextvars

ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "sa_active_mesh", default=None)


def set_active_mesh(mesh):
    """Returns a token; ACTIVE_MESH.reset(token) when the call is done."""
    return ACTIVE_MESH.set(mesh)


def active_mesh():
    return ACTIVE_MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """`mesh` (None: no mesh) is the active mesh inside the block."""
    token = ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        ACTIVE_MESH.reset(token)
