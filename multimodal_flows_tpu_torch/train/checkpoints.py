"""Checkpoints on `torch.save` (port of `multimodal_flows_tpu/train/checkpoints.py`).

A checkpoint is one dictionary (model, optimizer and EMA state, step,
epoch) saved atomically as `<slot>.pt` in the checkpoint directory.
`last` is written every time; per monitored metric the `top_k` best
checkpoints are kept as `{slot}-ep{epoch}.pt`, ranked in `index.json`,
and the plain slot (`best`, `best_mse`, `best_ce`) is a symlink to the #1
of its ranking.  `best_physics` follows the tie-to-later rule when
`physics_margin` > 0: it holds the latest checkpoint within
(1 + margin) of the best score seen; a score beyond the margin freezes
it.  Its metric exists only on physics-eval epochs, so it stays empty
while physics evaluation is off.

Over several processes every rank calls `save` with the same (full)
state and metrics and keeps the same index, but only rank 0 touches the
files: it writes `tmp`, renames it into place, repoints the symlinks,
evicts and writes `index.json`, with barriers around the writes so that
no rank reads a half-written slot.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Optional

import torch

from multimodal_flows_tpu_torch.parallel.mesh import is_primary, sync_hosts

MONITORS = {
    "best": "val_loss",
    "best_mse": "val_loss_mse",
    "best_ce": "val_loss_ce",
    "best_physics": "val_w1_physics",
}


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitors: Optional[Dict[str, str]] = None,
                 top_k: int = 10, physics_margin: float = 0.0):
        self.dir = os.path.abspath(ckpt_dir)
        self._primary = is_primary()
        if self._primary:
            os.makedirs(self.dir, exist_ok=True)
        self.monitors = dict(monitors) if monitors is not None else dict(MONITORS)
        self.top_k = int(top_k)
        self.physics_margin = float(physics_margin)
        self._index_path = os.path.join(self.dir, "index.json")
        self.index: Dict[str, Any] = {"best_values": {}, "history": []}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.index = json.load(f)
        self.index.setdefault("topk", {})

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name + ".pt")

    def _save_to(self, name: str, state) -> None:
        sync_hosts(f"ckpt-pre-save-{name}")
        if self._primary:
            path = self._path(name)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
        sync_hosts(f"ckpt-post-save-{name}")

    def _write_index(self) -> None:
        if not self._primary:
            return
        tmp = self._index_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.index, f, indent=1)
        os.replace(tmp, self._index_path)

    def save(self, state, metrics: Dict[str, float], epoch: int) -> Dict[str, bool]:
        """Save `last` and, per monitor, keep the `top_k` best checkpoints.
        Returns which slots were written: `written[slot]` means a new #1,
        `written[slot + "_topk"]` that the value entered the top k."""
        written = {"last": True}
        self._save_to("last", state)

        for slot, metric in self.monitors.items():
            value = metrics.get(metric)
            written[slot] = written[slot + "_topk"] = False
            if value is None:
                continue
            value = float(value)
            # a diverged (NaN/inf) metric never enters the ranking: NaN
            # comparisons would scramble the sort
            if not math.isfinite(value):
                continue
            margin_mode = slot == "best_physics" and self.physics_margin > 0
            if margin_mode:
                rec = self.index["best_values"].get(slot) or {}
                best_val = min(value, rec.get("min_value", value))
                healthy = value <= best_val * (1 + self.physics_margin)
                if healthy:
                    self._save_to(slot, state)
                    written[slot] = True
                self.index["best_values"][slot] = {
                    "min_value": best_val,
                    "value": value if healthy else rec.get("value"),
                    "epoch": epoch if healthy else rec.get("epoch"),
                    "frozen": not healthy,
                }
            ranked = self.index["topk"].setdefault(slot, [])
            # a resume from a slot other than `last` re-runs ranked epochs:
            # replace the stale entry rather than add a second one
            name = f"{slot}-ep{epoch}"
            ranked[:] = [e for e in ranked if e["name"] != name]
            if not (len(ranked) < self.top_k or value < ranked[-1]["value"]):
                continue
            entry = {"value": value, "epoch": epoch, "name": name}
            self._save_to(name, state)
            ranked.append(entry)
            ranked.sort(key=lambda e: e["value"])
            evicted = ranked[self.top_k:]
            del ranked[self.top_k:]
            written[slot + "_topk"] = True
            link = self._path(slot)
            if not margin_mode and ranked[0]["name"] == name:
                # the plain slot links to the new #1; it is re-pointed
                # before any eviction, so it never dangles
                if self._primary:
                    if os.path.lexists(link):
                        os.unlink(link)
                    os.symlink(os.path.basename(self._path(name)), link)
                self.index["best_values"][slot] = {"value": value, "epoch": epoch}
                written[slot] = True
            if self._primary:
                link_target = os.readlink(link) if os.path.islink(link) else None
                for ev in evicted:
                    path = self._path(ev["name"])
                    if os.path.basename(path) != link_target and os.path.exists(path):
                        os.remove(path)

        self.index["history"].append(
            {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}})
        self._write_index()
        sync_hosts("ckpt-index")
        return written

    def load(self, name: str = "last", map_location=None):
        """The checkpoint dictionary of slot `name`."""
        path = self._path(name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint slot {name!r} in {self.dir}")
        return self.load_path(path, map_location)

    def has(self, name: str) -> bool:
        return os.path.exists(self._path(name))

    @staticmethod
    def load_path(path: str, map_location=None):
        """Load a checkpoint file written by `save` (a warm start from
        outside the experiment)."""
        path = os.path.abspath(path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return torch.load(path, map_location=map_location, weights_only=True)
