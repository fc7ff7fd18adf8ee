"""Training checkpoint / resume (torch).

Port of ``stopthepop_tpu/train/checkpoint.py``: the model's and the
optimizer's ``state_dict``, the step count and the densification stats,
through ``torch.save``/``torch.load`` in place of Orbax. Densification
resizes the model, so loading first resizes the model's parameters to the
saved shapes and points the optimizer's groups at them.
"""

from __future__ import annotations

import os

import torch

from .trainer import DensifyStats, TrainState


def save_checkpoint(directory: str, state: TrainState, stats: DensifyStats,
                    step=None) -> str:
    """Save a checkpoint file; returns its path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    step = state.step if step is None else step
    path = os.path.join(directory, f"ckpt_{step}.pt")
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "stats": stats._asdict(),
    }, path)
    return path


def load_checkpoint(path: str, state: TrainState):
    """Load into ``state``'s model and optimizer (resized to the saved
    shapes, on the model's device). Returns (state, stats)."""
    model, optimizer = state.model, state.optimizer
    dev = model.means3d.device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    by_id = {}
    for name, value in ckpt["model"].items():
        old = getattr(model, name)
        by_id[id(old)] = name
        setattr(model, name, torch.nn.Parameter(value))
    for group in optimizer.param_groups:
        group["params"] = [getattr(model, by_id[id(p)]) for p in group["params"]]
    optimizer.state.clear()
    optimizer.load_state_dict(ckpt["optimizer"])
    stats = DensifyStats(**ckpt["stats"])
    return state._replace(step=ckpt["step"]), stats
