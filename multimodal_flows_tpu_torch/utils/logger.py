"""Experiment logging (port of `multimodal_flows_tpu/utils/logger.py`):
console messages and the metric sinks of an experiment directory,
`metrics.jsonl` and `metrics.csv`.  The TensorBoard and wandb sinks are
not ported."""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Dict


class SimpleLogger:
    """Colored console logging."""

    @staticmethod
    def info(message):
        print("\033[94m\033[1mINFO:\033[0m\033[00m", message)

    @staticmethod
    def warn(message):
        print("\033[31m\033[1mWARNING:\033[0m\033[00m", message)


class MetricSink:
    def log(self, step: int, metrics: Dict[str, float]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONLSink(MetricSink):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step, metrics):
        self._f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")

    def close(self):
        self._f.close()


class CSVSink(MetricSink):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self._f = None
        self._writer = None

    def log(self, step, metrics):
        row = {"step": step, **metrics}
        if self._writer is None:
            exists = os.path.exists(self.path)
            self._f = open(self.path, "a", newline="", buffering=1)
            self._writer = csv.DictWriter(self._f, fieldnames=list(row), extrasaction="ignore")
            if not exists:
                self._writer.writeheader()
        self._writer.writerow(row)

    def close(self):
        if self._f:
            self._f.close()


class MetricsLogger:
    """Writes each record to `metrics.jsonl` and `metrics.csv` in the
    experiment directory."""

    def __init__(self, experiment_dir: str):
        os.makedirs(experiment_dir, exist_ok=True)
        self.sinks = [JSONLSink(os.path.join(experiment_dir, "metrics.jsonl")),
                      CSVSink(os.path.join(experiment_dir, "metrics.csv"))]

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        clean = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        for s in self.sinks:
            s.log(step, clean)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
