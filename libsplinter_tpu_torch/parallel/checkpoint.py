"""Trainer checkpoint / resume, the counterpart of the JAX package's
orbax-backed ``parallel/checkpoint.py`` (orbax is not on the card):

  - save(state, path): ``torch.save`` of {params, optimizer state,
    step} to ``path/<step>``, written under a temporary name, flushed
    to disk and renamed into place, and the directory flushed after
    the rename, so a crash leaves the previous checkpoints whole; the
    newest 3 are kept;
  - restore(path, like): back into a trainer's fresh TrainState;
  - latest_step(path): resume from the newest without bookkeeping
    files;
  - save_params_npz(state, path): the parameters under the JAX
    package's keys and layouts, so the JAX package reads back what the
    port trained.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..models.encoder import params_to_jax
from .train import TrainState

KEEP = 3


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    return sorted(int(n) for n in os.listdir(path) if n.isdigit())


def save(state: TrainState, path: str, *, step: int | None = None) -> int:
    """Persist `state` under `path` keyed by `step` (default state.step)
    and return the step saved.  Durable when it returns; keeps the
    newest 3."""
    step = state.step if step is None else int(step)
    os.makedirs(path, exist_ok=True)
    for name in os.listdir(path):       # left by a save that crashed
        if name.startswith(".") and name.endswith(".tmp"):
            os.remove(os.path.join(path, name))
    tmp = os.path.join(path, f".{step}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        torch.save({"params": state.module.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": step}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, str(step)))
    for old in _steps(path)[:-KEEP]:
        os.remove(os.path.join(path, str(old)))
    fd = os.open(path, os.O_RDONLY)     # the rename and removals too
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return step


def latest_step(path: str) -> int | None:
    """Newest saved step under `path`, or None if nothing is there."""
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, like: TrainState, *,
            step: int | None = None) -> TrainState:
    """Load a checkpoint (step=None: the newest) into `like`, a fresh
    TrainState from the trainer that will resume: its module and
    optimizer are loaded in place, on their own device, and returned
    with the saved step.  Raises FileNotFoundError when nothing is
    saved."""
    step = latest_step(path) if step is None else int(step)
    file = None if step is None else os.path.join(path, str(step))
    if file is None or not os.path.isfile(file):
        raise FileNotFoundError(f"no checkpoint under {path}"
                                + ("" if step is None else f" at {step}"))
    dev = next(like.module.parameters()).device
    ck = torch.load(file, map_location=dev, weights_only=True)
    like.module.load_state_dict(ck["params"])
    like.optimizer.load_state_dict(ck["optimizer"])
    return TrainState(like.module, like.optimizer, int(ck["step"]))


def save_params_npz(state: TrainState, path: str) -> None:
    """Flat .npz of the parameters under the JAX package's keys
    (``params/layer_0/attn/qkv/kernel`` as (in, out), ...), the file
    its own ``save_params_npz`` writes for a flax tree."""
    np.savez(path, **params_to_jax(state.module))
