"""Rich progress display for training (PyTorch port of
`multimodal_flows_tpu/utils/progress.py`, itself the reference's
`ProgressBarCallback`).

Optional: falls back to no-op when `rich` is unavailable or when running
non-interactively (CI, batch jobs).  No torch: it shows host numbers.
"""

from __future__ import annotations

import sys
from typing import Optional


class EpochProgress:
    """Per-epoch progress bar showing step throughput and running loss."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = sys.stderr.isatty()
        self.enabled = enabled
        self._progress = None
        self._task = None
        if not enabled:
            return
        try:
            from rich.progress import (BarColumn, Progress, TextColumn,
                                       TimeElapsedColumn, TimeRemainingColumn)

            self._progress = Progress(
                TextColumn("[progress.description]{task.description}"),
                BarColumn(),
                TextColumn("{task.completed}/{task.total}"),
                TimeElapsedColumn(),
                TimeRemainingColumn(),
                TextColumn("{task.fields[loss]}"),
                transient=True,
            )
        except ImportError:
            self.enabled = False

    def start_epoch(self, epoch: int, total_steps: int) -> None:
        if not self.enabled:
            return
        self._progress.start()
        self._task = self._progress.add_task(
            f"epoch {epoch}", total=total_steps, loss="")

    def update(self, loss: float) -> None:
        if not self.enabled or self._task is None:
            return
        if loss == loss:  # skip NaN placeholders between logging steps
            self._progress.update(self._task, advance=1, loss=f"loss={loss:.4f}")
        else:
            self._progress.update(self._task, advance=1)

    def end_epoch(self) -> None:
        if not self.enabled or self._task is None:
            return
        self._progress.remove_task(self._task)
        self._progress.stop()
        self._task = None
