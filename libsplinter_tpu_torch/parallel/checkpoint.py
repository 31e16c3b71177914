"""Trainer checkpoint / resume, the counterpart of the JAX package's
orbax-backed ``parallel/checkpoint.py`` (orbax is not on the card):

  - save(state, path): ``torch.save`` of {params, optimizer state,
    step} to ``path/<step>``, written under a temporary name, flushed
    to disk and renamed into place, and the directory flushed after
    the rename, so a crash leaves the previous checkpoints whole; the
    newest 3 are kept;
  - restore(path, like): back into a trainer's fresh TrainState;
  - a sharded trainer's state (parallel/train.ShardedEncoder) is saved
    as the whole model's: its state_dict and its optimizer's moments
    gathered from the shards, in the single-card optimizer's layout,
    and restore re-splits them onto a sharded `like` — so a single-card
    checkpoint resumes on the mesh trainers and the other way round;
  - latest_step(path): resume from the newest without bookkeeping
    files;
  - save_params_npz(state, path): the parameters under the JAX
    package's keys and layouts, so the JAX package reads back what the
    port trained.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..models.encoder import Encoder, params_to_jax
from .train import ShardedEncoder, TrainState

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
    if isinstance(state.module, ShardedEncoder):
        params = state.module.full_state_dict()
        optimizer = _gather_optimizer(state.module, state.optimizer)
    else:
        params = state.module.state_dict()
        optimizer = state.optimizer.state_dict()
    with open(tmp, "wb") as f:
        torch.save({"params": params, "optimizer": optimizer,
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
    if isinstance(like.module, ShardedEncoder):
        like.module.load_full(ck["params"])
        like.optimizer.load_state_dict(
            _split_optimizer(like.module, like.optimizer, ck["optimizer"]))
    else:
        like.module.load_state_dict(ck["params"])
        like.optimizer.load_state_dict(ck["optimizer"])
    return TrainState(like.module, like.optimizer, int(ck["step"]))


def _slot_params(module: ShardedEncoder, opt) -> list[tuple[int, str]]:
    """(slot, parameter name) of each parameter of the sharded
    optimizer's one group, in its order."""
    where = {id(p): (k, name) for k, m in enumerate(module.shards)
             for name, p in m.named_parameters()}
    if len(opt.param_groups) != 1:
        raise ValueError("a sharded trainer's optimizer has one group")
    return [where[id(p)] for p in opt.param_groups[0]["params"]]


def _shaped(v) -> bool:
    """An optimizer state entry shaped like its parameter (a moment),
    not a scalar (Adam's step)."""
    return torch.is_tensor(v) and v.dim() > 0


def _gather_optimizer(module: ShardedEncoder, opt) -> dict:
    """The sharded optimizer's state_dict as the whole model's: entry j
    is the Encoder's j-th parameter, each moment gathered from the tp
    positions of dp = sp = 0 (the replicas hold the same), a scalar
    (Adam's step) taken from tp = 0."""
    sd = opt.state_dict()
    index = {key: j for j, key in enumerate(_slot_params(module, opt))}
    names = [n for n, _ in module.shards[0].named_parameters()]
    state = {}
    for j, name in enumerate(names):
        parts = [sd["state"].get(index[module.slot(0, t, 0), name])
                 for t in range(module.tp)]
        if parts[0] is None:
            continue
        state[j] = {k: (module.gather(name, [p[k] for p in parts])
                        if _shaped(v) else v)
                    for k, v in parts[0].items()}
    group = dict(sd["param_groups"][0], params=list(range(len(names))))
    return {"state": state, "param_groups": [group]}


def _split_optimizer(module: ShardedEncoder, opt, full: dict) -> dict:
    """The inverse of _gather_optimizer: a whole model's optimizer
    state_dict (a single-card trainer's) as the sharded optimizer's."""
    index = {n: j for j, (n, _) in
             enumerate(module.shards[0].named_parameters())}
    state = {}
    for i, (slot, name) in enumerate(_slot_params(module, opt)):
        entry = full["state"].get(index[name])
        if entry is None:
            continue
        t = module.position(slot)[1]
        # a copy per slot: each parameter's step updates its moments
        # and its step count in place
        state[i] = {k: ((module.split(name, v)[t] if _shaped(v) else v)
                        .clone() if torch.is_tensor(v) else v)
                    for k, v in entry.items()}
    n = len(opt.param_groups[0]["params"])
    group = dict(full["param_groups"][0], params=list(range(n)))
    return {"state": state, "param_groups": [group]}


def _whole_module(state: TrainState) -> Encoder:
    module = state.module
    if not isinstance(module, ShardedEncoder):
        return module
    with torch.device("meta"):
        whole = Encoder(dataclasses.replace(module.cfg, ring_axis=None))
    whole = whole.to_empty(device="cpu")
    whole.load_state_dict({k: v.cpu()
                           for k, v in module.full_state_dict().items()})
    return whole


def save_params_npz(state: TrainState, path: str) -> None:
    """Flat .npz of the parameters under the JAX package's keys
    (``params/layer_0/attn/qkv/kernel`` as (in, out), ...), the file
    its own ``save_params_npz`` writes for a flax tree; a sharded
    trainer's gathered first."""
    np.savez(path, **params_to_jax(_whole_module(state)))
