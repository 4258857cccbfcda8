"""The metric stream: the port's copy of
``munit_tpu/utils/logging.py``. Metric names match the reference
(loss_gen_adv_a, loss_dis_total, ...); every metric line of
``metrics.jsonl`` is ``{"step": step, name: float, ...}``."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class MetricLogger:
    """stdout and ``<output_dir>/metrics.jsonl`` (appended). A logger that
    is not ``enabled`` (a data-parallel group's other ranks) writes
    nothing."""

    def __init__(self, output_dir: Optional[str] = None, stdout: bool = True,
                 enabled: bool = True):
        self.stdout = stdout and enabled
        self.jsonl = None
        if output_dir and enabled:
            os.makedirs(output_dir, exist_ok=True)
            self.jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")

    def log_metrics(self, metrics: Dict, step: int):
        scalars = {k: float(v) for k, v in metrics.items()}
        if self.jsonl:
            self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
            self.jsonl.flush()
        if self.stdout:
            parts = " ".join(f"{k}={v:.4f}" for k, v in scalars.items())
            print(f"[{step}] {parts}", flush=True)

    def log_parameters(self, params: Dict):
        if self.jsonl:
            self.jsonl.write(json.dumps({"parameters": params}) + "\n")
            self.jsonl.flush()

    def close(self):
        if self.jsonl:
            self.jsonl.close()
            self.jsonl = None
