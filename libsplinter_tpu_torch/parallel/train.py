"""Contrastive training for the embedding encoder (PyTorch), the
counterpart of the JAX package's ``parallel/train.py``: in-batch
InfoNCE over text pairs, AdamW over every parameter, on one card
(``make_train_step``), sharded dp x tp over a mesh
(``make_sharded_train_step``) or sequence-parallel dp x sp with ring
attention (``make_ring_train_step``).

The encoder keeps f32 master parameters and computes in ``cfg.dtype``
(bf16 by default), as flax's Dense/Embed do; buckets at or above
``cfg.flash_min_seq`` attend through K1 forward and K6 backward
(ops/flash_attention.py), so a training step launches K6 once per
layer per tower — on every tensor-parallel shard at heads / tp.

Where GSPMD partitions the JAX step, the port's ``ShardedEncoder``
holds one Encoder at the per-shard geometry (``EncoderConfig.shard``)
for each (dp, tp, sp) slot of the mesh and drives them layer by layer,
as parallel/serve.ShardedDecoder drives the decoder:

  - qkv, gate and up split their outputs on tp and out and down their
    inputs, so each layer reduces twice over tp (after ``attn.out`` and
    after ``mlp.down``; their biases are added once, after the
    reduction); the fused qkv weight is regrouped by head group first
    ([q_0 k_0 v_0 | q_1 k_1 v_1 ...]), so a contiguous split gives each
    shard its own heads' q, k and v;
  - the token table (and bert's position table) splits its rows on tp:
    each shard looks up the ids in its range, zeros elsewhere, and one
    reduction completes the lookup exactly;
  - with ``cfg.ring_axis = "sp"`` each sp shard holds a chunk of the
    sequence: rotary angles and bert positions start at the chunk's
    offset, attention is ring attention (parallel/ring_attention.py;
    K1 is not taken), and the pool's sums and counts are reduced over
    sp before the mean;
  - the embeddings are gathered over dp before the loss, so the
    in-batch negatives span the global batch (what GSPMD computes for
    the JAX step).

The loss is computed once, so the backward gives each copy of a
parameter its part of the gradient: summing the copies' gradients
(``sync_grads``; no division — the JAX ring step divides by dp * sp
because each of its devices computes the whole loss) and stepping one
optimizer over every copy keeps the dp replicas bit-identical.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.encoder import (Encoder, EncoderConfig, _rotary_angles_at,
                              init_params, params_from_jax, pool_finish,
                              pool_sums)
from ..ops._cuda import LAUNCHES
from ..utils.device import resolve_device
from .mesh import (Mesh, all_reduce_groups, all_reduce_sum, param_pspec,
                   shard_tensor)
from .ring_attention import ring_attention

BATCH_KEYS = ("ids_a", "mask_a", "ids_b", "mask_b")


@dataclasses.dataclass
class TrainState:
    """The trainer's state: the encoder (f32 master parameters; a
    ShardedEncoder under the mesh trainers), the optimizer over all of
    its parameters, and the steps taken.

    PyTorch's optimizers own their moments and update parameters in
    place, so ``step_fn`` mutates `module` and `optimizer` and returns
    a new TrainState that shares them, with ``step + 1``."""
    module: nn.Module
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


def _check_sample(cfg: EncoderConfig, sample_ids, sample_mask) -> None:
    shape = tuple(np.shape(sample_ids))
    if len(shape) != 2 or tuple(np.shape(sample_mask)) != shape \
            or shape[1] > cfg.max_len:
        raise ValueError(f"sample batch {shape} / mask "
                         f"{tuple(np.shape(sample_mask))}: want two "
                         f"equal (B, S) shapes, S <= {cfg.max_len}")


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
        _check_sample(cfg, sample_ids, sample_mask)
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


# ------------------------------------------------------------ the mesh

_COL_BIAS = ("qkv", "gate", "up")


def train_param_pspec(name: str, tensor) -> tuple:
    """The split of an encoder state_dict entry for the per-shard
    modules of ShardedEncoder: the encoder rule (mesh.param_pspec),
    with the column-parallel biases split with their outputs — GSPMD
    may keep them whole, a module that computes only its own outputs
    holds only their biases."""
    if tensor.ndim == 1 and name.endswith("bias") \
            and any(k in name for k in _COL_BIAS):
        return ("tp",)
    return param_pspec(name, tensor)


def _is_qkv(name: str) -> bool:
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def regroup_qkv(t: torch.Tensor, tp: int) -> torch.Tensor:
    """The fused qkv rows [q | k | v] regrouped by head group into
    [q_0 k_0 v_0 | q_1 k_1 v_1 | ...], so that the contiguous split on
    tp gives shard t its own heads' q, k and v rows.  t: (3 * hidden,
    ...) — the weight (out, in) or the bias."""
    n = t.shape[0] // 3
    return t.reshape(3, tp, n // tp, *t.shape[1:]).transpose(0, 1) \
        .reshape(t.shape)


def ungroup_qkv(t: torch.Tensor, tp: int) -> torch.Tensor:
    """The inverse of regroup_qkv."""
    n = t.shape[0] // 3
    return t.reshape(tp, 3, n // tp, *t.shape[1:]).transpose(0, 1) \
        .reshape(t.shape)


class ShardedEncoder(nn.Module):
    """One Encoder at ``cfg.shard(tp)`` per (dp, tp, sp) slot of the
    mesh, slot (d, t, i) at index (d * tp + t) * sp + i on
    ``mesh.devices[d, t, i, 0, 0]``, driven layer by layer (module
    docstring).  Called like Encoder.forward on the WHOLE batch,
    (B, S) ids and mask -> (B, out_dim) f32 embeddings gathered over dp
    on the first slot's device; B splits over dp and, with
    ``cfg.ring_axis``, S over sp.  ``load_full`` seats a whole model's
    state_dict and ``full_state_dict`` gathers it back."""

    def __init__(self, cfg: EncoderConfig, mesh: Mesh):
        super().__init__()
        for axis in ("ep", "pp"):
            if mesh.shape[axis] != 1:
                raise ValueError(f"the encoder trains over dp, tp and sp; "
                                 f"{axis}={mesh.shape[axis]}")
        if cfg.ring_axis not in (None, "sp"):
            raise ValueError(f"ring_axis={cfg.ring_axis!r}: the port runs "
                             "the ring over the mesh's sp axis")
        self.dp, self.tp, self.sp = (mesh.shape[a] for a in ("dp", "tp",
                                                              "sp"))
        if self.sp > 1 and not cfg.ring_axis:
            raise ValueError(f"sp={self.sp} splits the sequence: set "
                             "cfg.ring_axis='sp' (make_ring_train_step)")
        if cfg.weights_int8:
            raise ValueError("the trainer trains float weights "
                             "(weights_int8 is a serving residency)")
        self.cfg = cfg
        self.mesh = mesh
        self.shard_cfg = cfg.shard(self.tp)
        self.devices = [mesh.devices[d, t, i, 0, 0]
                        for d in range(self.dp) for t in range(self.tp)
                        for i in range(self.sp)]
        shards = []
        for dev in self.devices:
            with torch.device("meta"):
                m = Encoder(self.shard_cfg)
            shards.append(m.to_empty(device=dev))
        self.shards = nn.ModuleList(shards)
        # reduction groups: slots that differ only in their tp (resp.
        # sp) position
        self._tp_groups = [[self.slot(d, t, i) for t in range(self.tp)]
                           for d in range(self.dp) for i in range(self.sp)]
        self._sp_groups = [[self.slot(d, t, i) for i in range(self.sp)]
                           for d in range(self.dp) for t in range(self.tp)]

    def slot(self, d: int, t: int, i: int) -> int:
        return (d * self.tp + t) * self.sp + i

    def position(self, slot: int) -> tuple[int, int, int]:
        d, rest = divmod(slot, self.tp * self.sp)
        return (d, *divmod(rest, self.sp))

    # -- the whole model's tensors <-> the shards' ----------------------

    def split(self, name: str, full: torch.Tensor) -> list[torch.Tensor]:
        """A whole model's tensor `name` (a parameter, its gradient or
        an optimizer moment) as its part for each tp position."""
        spec = train_param_pspec(name, full)
        if self.tp == 1 or "tp" not in spec:
            return [full] * self.tp
        if _is_qkv(name):
            full = regroup_qkv(full, self.tp)
        return [shard_tensor(name, full, spec, {"tp": (t, self.tp)})
                for t in range(self.tp)]

    def gather(self, name: str, parts: list[torch.Tensor]) -> torch.Tensor:
        """The inverse of split: the tp positions' parts of `name` (in
        tp order) as the whole model's tensor, on parts[0]'s device."""
        spec = train_param_pspec(name, parts[0])
        if self.tp == 1 or "tp" not in spec:
            return parts[0].detach().clone()
        whole = torch.cat([p.detach().to(parts[0].device) for p in parts],
                          spec.index("tp"))
        return ungroup_qkv(whole, self.tp) if _is_qkv(name) else whole

    @torch.no_grad()
    def load_full(self, state_dict: dict) -> "ShardedEncoder":
        """Seat a whole model's state_dict (Encoder(cfg).state_dict())
        in every slot: each tp position's part, every dp and sp replica
        the same values."""
        names = dict(self.shards[0].named_parameters())
        if set(state_dict) != set(names):
            raise ValueError(f"state_dict entries differ from the "
                             f"encoder's: {sorted(set(state_dict) ^ set(names))}")
        for name, full in state_dict.items():
            parts = self.split(name, full)
            for k, m in enumerate(self.shards):
                m.get_parameter(name).copy_(parts[self.position(k)[1]])
        return self

    def full_state_dict(self) -> dict:
        """The whole model's state_dict, gathered from dp = sp = 0."""
        return {name: self.gather(name, [
                    self.shards[self.slot(0, t, 0)].get_parameter(name)
                    for t in range(self.tp)])
                for name, _ in self.shards[0].named_parameters()}

    def _copy_groups(self, name: str, tensor) -> list[list[int]]:
        """The slots holding the same part of `name`: those of one tp
        position when it splits on tp, else all."""
        if self.tp > 1 and "tp" in train_param_pspec(name, tensor):
            return [[k for k in range(len(self.shards))
                     if self.position(k)[1] == t] for t in range(self.tp)]
        return [list(range(len(self.shards)))]

    @torch.no_grad()
    def sync_grads(self) -> None:
        """Give every copy of a parameter the sum of the copies'
        gradients (a copy the loss did not reach counts zero), summed in
        slot order and copied out, so every replica steps on the same
        bits."""
        for name, p0 in self.shards[0].named_parameters():
            params = [m.get_parameter(name) for m in self.shards]
            for group in self._copy_groups(name, p0):
                grads = [params[k].grad for k in group
                         if params[k].grad is not None]
                if not grads:
                    continue
                acc = grads[0].clone()
                for g in grads[1:]:
                    acc += g.to(acc.device)
                for k in group:
                    params[k].grad = acc.to(params[k].device, copy=True)

    def replica_mismatches(self) -> list[str]:
        """Names of the parameters whose copies differ in any bit (the
        replicas of a step that went right: none)."""
        bad = []
        for name, p0 in self.shards[0].named_parameters():
            params = [m.get_parameter(name) for m in self.shards]
            for group in self._copy_groups(name, p0):
                lead = params[group[0]]
                if not all(torch.equal(lead, params[k].to(lead.device))
                           for k in group[1:]):
                    bad.append(name)
                    break
        return bad

    # -- the forward ----------------------------------------------------

    def _lookup(self, table: str, ids: list) -> list:
        """The token (or position) lookup: each tp shard's partial,
        reduced over tp."""
        if self.tp == 1:
            return [getattr(m, table)(x) for m, x in zip(self.shards, ids)]
        parts = [getattr(m, table).partial(x, self.position(k)[1])
                 for k, (m, x) in enumerate(zip(self.shards, ids))]
        return all_reduce_groups(parts, self._tp_groups)

    def _row_parallel(self, dense, h, groups) -> list:
        """A row-parallel projection over tp: the shards' partial
        products reduced, then the bias once (one shard: the Dense
        whole, bias and all)."""
        if self.tp == 1:
            return [d(x) for d, x in zip(dense, h)]
        dt = self.cfg.dtype
        parts = [F.linear(x.to(dt), d.weight.to(dt))
                 for d, x in zip(dense, h)]
        return [r + d.bias.to(dt)
                for d, r in zip(dense, all_reduce_groups(parts, groups))]

    def forward(self, token_ids, attn_mask):
        cfg = self.cfg
        b, s = token_ids.shape
        if b % self.dp or s % self.sp:
            raise ValueError(f"batch (B, S) = ({b}, {s}) does not split "
                             f"over dp={self.dp} x sp={self.sp}")
        if cfg.variant == "bert" and s > cfg.max_len:
            raise ValueError(
                f"bert variant: global sequence {self.sp}x{s // self.sp} "
                f"exceeds the learned position table max_len={cfg.max_len}"
                "; raise max_len or use the rotary 'nomic' variant for "
                "long context")
        rb, c = b // self.dp, s // self.sp
        pos = [self.position(k) for k in range(len(self.shards))]
        ids = [token_ids[d * rb:(d + 1) * rb, i * c:(i + 1) * c].to(dev)
               for (d, _, i), dev in zip(pos, self.devices)]
        masks = [attn_mask[d * rb:(d + 1) * rb, i * c:(i + 1) * c].to(dev)
                 for (d, _, i), dev in zip(pos, self.devices)]
        offsets = [i * c + torch.arange(c, device=dev)
                   for (_, _, i), dev in zip(pos, self.devices)]
        pos_rows = (self._lookup("pos_emb", offsets)
                    if cfg.variant == "bert" else [None] * len(ids))
        xs = [m.embed_norm(x, p) for m, x, p in zip(
            self.shards, self._lookup("tok_emb", ids), pos_rows)]
        rot = [_rotary_angles_at(o, self.shard_cfg.head_dim)
               if cfg.variant == "nomic" else None for o in offsets]
        for li in range(cfg.layers):
            layers = [getattr(m, f"layer_{li}") for m in self.shards]
            qkv = [ly.attn.project(x, r)
                   for ly, x, r in zip(layers, xs, rot)]
            outs = self._attend(layers, qkv, masks)
            h = [o.reshape(rb, c, -1) for o in outs]
            r = self._row_parallel([ly.attn.out for ly in layers], h,
                                   self._tp_groups)
            xs = [ly.after_attn(x, a) for ly, x, a in zip(layers, xs, r)]
            h = [ly.mlp.act(x) for ly, x in zip(layers, xs)]
            r = self._row_parallel([ly.mlp.down for ly in layers], h,
                                   self._tp_groups)
            xs = [ly.after_mlp(x, a) for ly, x, a in zip(layers, xs, r)]
        return self._pool(xs, masks)

    def _attend(self, layers, qkv, masks) -> list:
        if self.sp == 1:
            outs = []
            try:
                for k, (ly, (q, kk, v), m) in enumerate(zip(layers, qkv,
                                                            masks)):
                    LAUNCHES.shard = k       # the kernels' per-shard count
                    outs.append(ly.attn.attend(q, kk, v, m))
            finally:
                LAUNCHES.shard = None
            return outs
        outs = [None] * len(qkv)
        for g in self._sp_groups:
            got = ring_attention([qkv[k][0] for k in g],
                                 [qkv[k][1] for k in g],
                                 [qkv[k][2] for k in g],
                                 [masks[k] for k in g])
            for k, o in zip(g, got):
                outs[k] = o
        return outs

    def _pool(self, xs, masks):
        """Each dp row's embeddings from its tp = 0 slots, the pool's
        sums and counts reduced over sp, gathered over dp on the first
        slot's device."""
        zs = []
        for d in range(self.dp):
            group = [self.slot(d, 0, i) for i in range(self.sp)]
            sums, counts = zip(*(pool_sums(xs[k], masks[k]) for k in group))
            zs.append(pool_finish(self.cfg,
                                  all_reduce_sum(list(sums))[0],
                                  all_reduce_sum(list(counts))[0]))
        dev = self.devices[0]
        return torch.cat([z.to(dev) for z in zs], dim=0)


def _sharded_state(cfg: EncoderConfig, mesh: Mesh, make_opt,
                   generator: torch.Generator, sample_ids,
                   sample_mask) -> TrainState:
    """init_params of the whole model from `generator` (on the mesh's
    first device) split onto the mesh: the single-card init of the same
    generator, sharded."""
    _check_sample(cfg, sample_ids, sample_mask)
    with torch.device(mesh.devices.flat[0]):
        whole = Encoder(dataclasses.replace(cfg, ring_axis=None))
    init_params(whole, generator)
    module = ShardedEncoder(cfg, mesh).load_full(whole.state_dict())
    del whole
    return TrainState(module, make_opt(list(module.parameters())), 0)


def _sharded_step(temperature: float):
    def step_fn(state: TrainState, batch) -> tuple[TrainState,
                                                   torch.Tensor]:
        module, opt = state.module, state.optimizer
        ids_a, mask_a, ids_b, mask_b = _batch_on(module.devices[0], batch)
        loss = info_nce_loss(module(ids_a, mask_a), module(ids_b, mask_b),
                             temperature)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        module.sync_grads()
        opt.step()
        return TrainState(module, opt, state.step + 1), loss.detach()
    return step_fn


def make_sharded_train_step(cfg: EncoderConfig, mesh: Mesh,
                            optimizer: Callable | None = None,
                            temperature: float = 0.05):
    """The train step over a dp x tp mesh: the batch split on dp, the
    parameters on tp (ShardedEncoder).  Returns sharded_init(generator,
    sample_ids, sample_mask) -> (state, step), step(state, batch) ->
    (state, loss) with the same batch and loss as make_train_step's.
    The mesh's devices are the trainer's (make_mesh: cuda unless asked
    for cpu)."""
    make_opt = optimizer or adamw
    step_fn = _sharded_step(temperature)

    def sharded_init(generator: torch.Generator, sample_ids, sample_mask):
        return (_sharded_state(cfg, mesh, make_opt, generator, sample_ids,
                               sample_mask), step_fn)

    return sharded_init


def make_ring_train_step(cfg: EncoderConfig, mesh: Mesh,
                         optimizer: Callable | None = None,
                         temperature: float = 0.05):
    """The sequence-parallel train step: cfg.ring_axis names the mesh's
    sequence axis ("sp"); the batch splits on dp and the sequence on
    sp, each shard runs the encoder on its chunk with K/V rotating
    around the ring, and the embeddings are gathered over dp for the
    in-batch InfoNCE.  Returns (init_fn, step_fn) as make_train_step
    does; batches are the WHOLE (B, S) arrays."""
    if not cfg.ring_axis or cfg.ring_axis not in mesh.axis_names:
        raise ValueError("cfg.ring_axis must name a mesh axis (e.g. 'sp')")
    make_opt = optimizer or adamw

    def init_fn(generator: torch.Generator, sample_ids,
                sample_mask) -> TrainState:
        return _sharded_state(cfg, mesh, make_opt, generator, sample_ids,
                              sample_mask)

    return init_fn, _sharded_step(temperature)
