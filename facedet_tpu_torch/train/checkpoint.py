"""Checkpoint and resume of training state.

Counterpart of facedet_tpu/train/checkpoint.py. The state (a dict such as
``train_state`` builds: the model's state dict, the optimizer's and its
schedule's, the step) is written with ``torch.save`` under
``directory/step_N/state.pt``; ``CheckpointManager`` keeps the same best /
last / periodic policy and prunes the same way. The trainers' ``.npz``
exports (flax's flat ``params/...`` layout) stay the interchange format.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "CheckpointManager",
    "train_state",
    "load_train_state",
]

_FILE = "state.pt"


def save_checkpoint(directory: str, state: Any, step: int, force: bool = True) -> str:
    """Save ``state`` under ``directory/step_N``; with ``force=False`` an
    existing step raises."""
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    if os.path.exists(path) and not force:
        raise FileExistsError(path)
    os.makedirs(path, exist_ok=True)
    torch.save(state, os.path.join(path, _FILE))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_", 1)[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None, map_location=None) -> tuple[Any, int]:
    """Restore the given (or latest) step: (state, step). Tensors land on
    ``map_location`` (their saved devices by default)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}", _FILE)
    return torch.load(path, map_location=map_location, weights_only=True), step


class CheckpointManager:
    """Rolling manager with the reference's save policy: keep best + last,
    and periodic snapshots every ``save_period`` steps (``max_keep`` of
    them)."""

    def __init__(self, directory: str, save_period: int = 5, max_keep: int = 5):
        self.directory = directory
        self.save_period = save_period
        self.max_keep = max_keep
        self.best_metric = float("inf")

    def step_end(self, state: Any, step: int, metric: float) -> dict:
        actions = {"saved_last": True, "saved_best": False, "saved_periodic": False}
        self._save("last", state, step, keep=1)
        if metric < self.best_metric - 1e-9:
            self.best_metric = metric
            self._save("best", state, step, keep=1)
            actions["saved_best"] = True
        if self.save_period and (step + 1) % self.save_period == 0:
            self._save("periodic", state, step, keep=self.max_keep)
            actions["saved_periodic"] = True
        return actions

    def _save(self, kind: str, state: Any, step: int, keep: int) -> None:
        directory = os.path.join(self.directory, kind)
        save_checkpoint(directory, state, step)
        steps = sorted(int(n.split("_", 1)[1]) for n in os.listdir(directory) if n.startswith("step_"))
        for s in steps[:-keep]:
            shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)

    def resume(self, map_location=None) -> Optional[tuple[Any, int]]:
        """Restore from last/ if present (the resume path)."""
        last_dir = os.path.join(self.directory, "last")
        if latest_step(last_dir) is None:
            return None
        return restore_checkpoint(last_dir, map_location=map_location)


def train_state(model: torch.nn.Module, tx, step: int) -> dict:
    """{model, optimizer, scheduler, step} of a model and its optimizer
    (``make_optimizer``'s, or a plain ``torch.optim`` one: no scheduler)."""
    inner = getattr(tx, "optimizer", tx)
    scheduler = getattr(tx, "scheduler", None)
    return {
        "model": model.state_dict(),
        "optimizer": inner.state_dict(),
        "scheduler": None if scheduler is None else scheduler.state_dict(),
        "step": int(step),
    }


def load_train_state(model: torch.nn.Module, tx, state: dict) -> int:
    """Put a ``train_state`` back into the model and its optimizer; returns
    the step."""
    model.load_state_dict(state["model"])
    getattr(tx, "optimizer", tx).load_state_dict(state["optimizer"])
    if state["scheduler"] is not None:
        tx.scheduler.load_state_dict(state["scheduler"])
    return state["step"]
