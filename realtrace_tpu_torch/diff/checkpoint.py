"""Checkpoint and resume for inverse-rendering (training) runs.

Counterpart of ``realtrace_tpu/diff/checkpoint.py``: the step, the
parameters and the optimiser state go into one ``torch.save`` file per step,
``step_XXXXXXXX.pt``, and load back in place into the parameters and the
optimiser that ``diff.inverse.make_train_step`` made, so its step callable
continues the run.
"""
from __future__ import annotations

from pathlib import Path

import torch

from realtrace_tpu_torch.core.types import tensor_leaves


def save_train_state(directory: str | Path, step: int, params: dict,
                     optimizer: torch.optim.Optimizer) -> Path:
    """Write (step, params, optimizer state) to ``directory/step_XXXXXXXX.pt``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step:08d}.pt"
    torch.save({"step": int(step), "params": [p.detach() for p in tensor_leaves(params)],
                "optimizer": optimizer.state_dict()}, path)
    return path


def restore_train_state(path: str | Path, params: dict,
                        optimizer: torch.optim.Optimizer) -> int:
    """Load a ``save_train_state`` file into ``params`` (in place, leaf by
    leaf, in ``tensor_leaves`` order) and ``optimizer``; returns the step."""
    leaves = tensor_leaves(params)
    state = torch.load(path, map_location=leaves[0].device if leaves else "cpu",
                       weights_only=True)
    saved = state["params"]
    if len(saved) != len(leaves) or any(a.shape != b.shape for a, b in zip(saved, leaves)):
        raise ValueError(f"{path}: the saved parameters do not match the given ones")
    with torch.no_grad():
        for p, v in zip(leaves, saved):
            p.copy_(v)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def latest_checkpoint(directory: str | Path) -> Path | None:
    """The newest ``step_*`` file in ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    cands = sorted(directory.glob("step_*"))
    return cands[-1] if cands else None
