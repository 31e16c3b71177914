"""Contrastive training step for the embedding encoder (PyTorch), the
counterpart of the JAX package's ``parallel/train.py`` single-device
trainer: in-batch InfoNCE over text pairs, AdamW over every parameter.

The encoder keeps f32 master parameters and computes in ``cfg.dtype``
(bf16 by default), as flax's Dense/Embed do; buckets at or above
``cfg.flash_min_seq`` attend through K1 forward and K6 backward
(ops/flash_attention.py), so a training step launches K6 once per
layer per tower.

The mesh-sharded and ring (sequence-parallel) trainers of the JAX
package need more than one card and are not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..models.encoder import (Encoder, EncoderConfig, init_params,
                              params_from_jax)
from ..utils.device import resolve_device

BATCH_KEYS = ("ids_a", "mask_a", "ids_b", "mask_b")


@dataclasses.dataclass
class TrainState:
    """The trainer's state: the encoder (f32 master parameters), the
    optimizer over all of its parameters, and the steps taken.

    PyTorch's optimizers own their moments and update parameters in
    place, so ``step_fn`` mutates `module` and `optimizer` and returns
    a new TrainState that shares them, with ``step + 1``."""
    module: Encoder
    optimizer: torch.optim.Optimizer
    step: int


def adamw(params) -> torch.optim.AdamW:
    """The default optimizer, optax.adamw(1e-4, weight_decay=0.01) of
    the JAX trainer: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, decoupled decay lr * wd * p on EVERY parameter (optax's
    mask=None: norms and biases decay too)."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


def info_nce_loss(za: torch.Tensor, zb: torch.Tensor,
                  temperature: float = 0.05) -> torch.Tensor:
    """Symmetric in-batch InfoNCE over f32 logits: row i of za matches
    row i of zb."""
    logits = (za.float() @ zb.float().T) / temperature
    labels = torch.arange(za.shape[0], device=za.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2.0


def _batch_on(device, batch) -> list[torch.Tensor]:
    """ids as int64 and masks as bool on `device` (numpy or tensors)."""
    out = []
    for key in BATCH_KEYS:
        t = torch.as_tensor(batch[key], device=device)
        out.append(t.bool() if key.startswith("mask") else t.long())
    return out


def loss_fn(module: Encoder, batch, temperature: float = 0.05):
    """Both towers through `module` and the InfoNCE between them.
    batch: dict(ids_a, mask_a, ids_b, mask_b) of (B, S) arrays."""
    dev = next(module.parameters()).device
    ids_a, mask_a, ids_b, mask_b = _batch_on(dev, batch)
    return info_nce_loss(module(ids_a, mask_a), module(ids_b, mask_b),
                         temperature)


def make_train_step(cfg: EncoderConfig,
                    optimizer: Callable | None = None,
                    temperature: float = 0.05, *, device=None):
    """Returns (init_fn, step_fn).

    init_fn(generator, sample_ids, sample_mask) -> TrainState: a new
    encoder on the trainer's device, seeded through ``init_params``
    from `generator` (a torch.Generator on that device); the sample
    batch (B, S) is checked against the config, as the JAX trainer
    traces its module on it.  step_fn(state, batch) -> (state, loss)
    with batch dict(ids_a, mask_a, ids_b, mask_b).

    optimizer: a callable from the parameter list to a
    torch.optim.Optimizer (default ``adamw``).  device: "cuda" unless
    the caller asks for "cpu"; raises without a card."""
    dev = resolve_device(device)
    make_opt = optimizer or adamw

    def init_fn(generator: torch.Generator, sample_ids,
                sample_mask) -> TrainState:
        shape = tuple(np.shape(sample_ids))
        if len(shape) != 2 or tuple(np.shape(sample_mask)) != shape \
                or shape[1] > cfg.max_len:
            raise ValueError(f"sample batch {shape} / mask "
                             f"{tuple(np.shape(sample_mask))}: want two "
                             f"equal (B, S) shapes, S <= {cfg.max_len}")
        with torch.device(dev):
            module = Encoder(cfg)
        init_params(module, generator)
        return TrainState(module, make_opt(list(module.parameters())), 0)

    def step_fn(state: TrainState, batch) -> tuple[TrainState,
                                                   torch.Tensor]:
        module, opt = state.module, state.optimizer
        loss = loss_fn(module, batch, temperature)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return TrainState(module, opt, state.step + 1), loss.detach()

    return init_fn, step_fn


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside an adamw chain's
    state tuple, found by its fields."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            got = _adam_state(sub)
            if got is not None:
                return got
    return None


def state_from_jax(jax_state, cfg: EncoderConfig,
                   optimizer: Callable | None = None, *,
                   device=None) -> TrainState:
    """A TrainState from the JAX package's TrainState (params, opt_state,
    step): parameters through ``params_from_jax``; the adamw chain's mu
    and nu become AdamW's exp_avg and exp_avg_sq (kernels transposed as
    the weights are) and its count the optimizer's step."""
    dev = resolve_device(device)
    with torch.device(dev):
        module = Encoder(cfg)
    module.load_state_dict(params_from_jax(jax_state.params, cfg))
    opt = (optimizer or adamw)(list(module.parameters()))
    adam = _adam_state(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments "
                         "(count, mu, nu)")
    mu = params_from_jax(adam.mu, cfg)
    nu = params_from_jax(adam.nu, cfg)
    count = float(np.asarray(adam.count))
    for name, p in module.named_parameters():
        opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                        "exp_avg": mu[name].to(dev, copy=True),
                        "exp_avg_sq": nu[name].to(dev, copy=True)}
    return TrainState(module, opt, int(np.asarray(jax_state.step)))
