"""Training metrics: JSONL on disk + a stdout summary line (the port's own
copy of vorta_tpu/io/metrics.py, the same record and line)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir, filename: str = "metrics.jsonl"):
        self.path = Path(log_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], lr: float = None) -> str:
        rec = {"step": step, "wall_s": round(time.time() - self._t0, 2)}
        if lr is not None:
            rec["lr"] = float(lr)
        for k, v in metrics.items():
            rec[k] = float(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        parts = [f"step {step}"] + [
            f"{k}: {float(v):.3e}" for k, v in metrics.items() if k != "timestep"]
        if "timestep" in metrics:
            parts.append(f"t: {float(metrics['timestep']):.0f}")
        return " | ".join(parts)

    def close(self):
        self._fh.close()
