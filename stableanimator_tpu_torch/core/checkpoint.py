"""Training checkpoints over `torch.save` (the port's counterpart of the JAX
package's orbax `core/checkpoint.py`): step-numbered directories
`<directory>/<step>/state.pt`, `latest` resolution, and a retention limit,
the reference's `--checkpointing_steps`, `--checkpoints_total_limit` and
`--resume_from_checkpoint="latest"` (command_train.sh:18-21). The files are
the port's own; orbax compatibility is not a goal.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, total_limit: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.total_limit = total_limit
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """The steps with a complete checkpoint, oldest first."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.exists(os.path.join(self.directory, d, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> str:
        """Write `state` (anything torch.save takes) as step `step`, replacing
        an earlier save of the same step; then drop the oldest checkpoints
        beyond the limit. Returns the file's path."""
        folder = os.path.join(self.directory, str(int(step)))
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, STATE_FILE)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        if self.total_limit is not None:
            for old in self.all_steps()[:-self.total_limit or None]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        return path

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """The state saved at `step`; step=None -> latest."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self.directory, str(int(step)), STATE_FILE)
        return torch.load(path, map_location=map_location, weights_only=True)
