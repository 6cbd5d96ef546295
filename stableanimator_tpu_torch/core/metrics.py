"""Persistent training-metrics stream (port of the JAX package's
`core/metrics.py`): the reference's `--report_to` accelerate/wandb intent.

Always writes JSONL (one object per logged step, trivially greppable /
plottable, survives crashes since each line is flushed); optionally mirrors
to TensorBoard when the writer is available.

  logger = MetricsLogger(output_dir, report_to="jsonl")
  logger.log(step, {"loss": 0.12, "grad_norm": 3.4})
  logger.close()
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str, report_to: str = "jsonl"):
        """report_to: 'jsonl' | 'tensorboard' (implies jsonl too) | 'none'."""
        self.report_to = report_to
        self._fh = None
        self._tb = None
        if report_to == "none":
            return
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        if report_to == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
            except ImportError:
                print("WARNING: tensorboard writer unavailable; "
                      "metrics.jsonl only")

    def log(self, step: int, metrics: Dict[str, float],
            wall_time: Optional[float] = None):
        if self._fh is None:
            return
        rec = {"step": int(step), "time": wall_time or time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
