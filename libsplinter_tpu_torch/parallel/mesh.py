"""Device mesh for the port's multi-GPU serving — the counterpart of the
JAX package's parallel/mesh.py.

A ``Mesh`` is a named (dp, tp, sp, ep, pp) grid of ``torch.device``s
driven by ONE controller (this process):

  dp — data parallel (batch; the row blocks of a sharded vector lane)
  tp — tensor parallel (heads / MLP lanes)
  sp — sequence parallel (long context)
  ep — expert parallel (the stacked MoE expert axis)
  pp — pipeline parallel (layer stages)

Where the JAX package lets GSPMD place each parameter by a
PartitionSpec and insert the collectives, the port splits each
``state_dict`` entry by the same rules (``param_pspec`` for the
encoder, ``decoder_param_pspec`` for the decoder families) into one
tensor per shard, and the sharded modules call the collectives below
themselves.  A spec is a tuple with one entry per dimension of the
TORCH tensor — the mesh axis that dimension splits on, or None — and
``()`` replicates.  ``nn.Linear.weight`` is (out, in), the transpose of
flax's (in, out) kernel: column-parallel projections split dim 0 and
row-parallel ones dim 1.

The collectives work on lists of per-shard tensors, out of place, so
serving under no_grad and training under autograd share them.  Shards
on one device are summed there; shards on distinct cards reach the first
shard's card by peer copies.  NCCL (``torch.distributed`` or
``torch.cuda.nccl``) takes their place once a multi-card cell exists to
measure it; until then a mesh may repeat a device (the tests' CPU
shards, one card standing in for several).
"""
from __future__ import annotations

import numpy as np
import torch

AXES = ("dp", "tp", "sp", "ep", "pp")


class Mesh:
    """A (dp, tp, sp, ep, pp) grid of devices; ``shape`` maps each axis
    name to its size, as jax.sharding.Mesh.shape does."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray):
        if devices.ndim != len(AXES):
            raise ValueError(f"a mesh is {len(AXES)}-d over {AXES}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, every other axis at position 0."""
        idx = [0] * len(AXES)
        idx[AXES.index(axis)] = slice(None)
        return list(self.devices[tuple(idx)])

    def serving_devices(self) -> list[torch.device]:
        """The tp x ep grid a sharded model serves on (every other axis
        at position 0), tp-major: slot t * ep + e is (tp=t, ep=e)."""
        return list(self.devices[0, :, 0, :, 0].reshape(-1))

    def __repr__(self) -> str:
        kinds = sorted({str(d) for d in self.devices.reshape(-1)})
        return f"Mesh({self.shape}, devices={kinds})"


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1,
              ep: int = 1, pp: int = 1, devices=None, *,
              device: str | torch.device = "cuda") -> Mesh:
    """Build a (dp, tp, sp, ep, pp) mesh.  dp=None uses all remaining
    devices.  devices=None takes every visible card on ``cuda`` (the
    call refuses when their count does not fit the axes) and on ``cpu``
    as many CPU shards as the axes need.  An explicit `devices` list
    may repeat a device: several shards then share it."""
    rest = tp * sp * ep * pp
    if devices is None:
        kind = torch.device(device).type
        if kind == "cuda":
            from ..utils.device import resolve_device
            resolve_device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        elif kind == "cpu":
            devices = [torch.device("cpu")] * ((dp or 1) * rest)
        else:
            raise ValueError(f"no mesh over {kind!r} devices")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        if n % rest:
            raise ValueError(
                f"{n} devices not divisible by tp*sp*ep*pp={rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(f"dp*tp*sp*ep*pp={dp * rest} != #devices={n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, tp, sp, ep, pp))


# ------------------------------------------------------------ split rules

_COL = ("q", "k", "v", "gate", "up")     # column parallel: split outputs
_ROW = ("out", "down")                   # row parallel: split inputs


def param_pspec(name: str, tensor) -> tuple:
    """Tensor-parallel split of an ENCODER state_dict entry (the torch
    form of the JAX package's param_pspec): Megatron-style within each
    block — qkv/gate/up weights split their outputs on tp, attn.out and
    mlp.down weights their inputs, so the pair needs one reduction per
    block; the token and position tables split the vocab axis; the rest
    replicates.  Substring tests as in the JAX rule."""
    colp = any(k in name for k in ("qkv", "gate", "up"))
    rowp = any(k in name for k in ("attn.out", "mlp.down"))
    ndim = tensor.ndim
    if ndim == 2:
        if "tok_emb" in name or "pos_emb" in name:
            return ("tp", None)           # vocab-sharded embedding
        if name.endswith("weight"):       # nn.Linear (out, in)
            if colp:
                return ("tp", None)
            if rowp:
                return (None, "tp")
        if name.endswith("wq"):           # ChannelQuantDense (in, out)
            if colp:
                return (None, "tp")
            if rowp:
                return ("tp", None)
    if ndim == 1 and name.endswith("wscale"):
        # per-output-channel scales go with column-parallel outputs;
        # row-parallel outputs are full-width partial sums, so scaling
        # each before the reduction is exact and the scales replicate
        return ("tp",) if colp else ()
    return ()


def decoder_param_pspec(name: str, tensor) -> tuple:
    """Split of a Decoder / MoE decoder state_dict entry (the torch form
    of the JAX package's decoder_param_pspec): attention and the dense
    MLP split on tp, the stacked expert tensors their expert axis on
    ep; routers, norms, embeddings and the LM head replicate.

    The int8 residencies keep the JAX layouts (models/quant.py): Q8_0
    ``q`` (in/32, 32, out) and ``scale`` (in/32, out) split outputs on
    column-parallel layers and input BLOCKS on row-parallel ones;
    per-channel ``wq`` (in, out) splits like the float kernel and
    ``wscale`` (out,) goes with column-parallel outputs."""
    ndim = tensor.ndim
    if ndim == 3 and name.endswith("_experts"):
        return ("ep", None, None)
    if ndim == 4 and name.endswith("_experts_q"):
        return ("ep", None, None, None)
    if ndim == 3 and name.endswith("_experts_scale"):
        return ("ep", None, None)
    parts = name.split(".")
    proj, leaf = (parts[-2], parts[-1]) if len(parts) > 1 else ("", name)
    if proj in _COL + _ROW:
        colp = proj in _COL
        if leaf == "q":
            return (None, None, "tp") if colp else ("tp", None, None)
        if leaf == "scale":
            return (None, "tp") if colp else ("tp", None)
        if leaf == "wq":
            return (None, "tp") if colp else ("tp", None)
        if leaf == "wscale":
            return ("tp",) if colp else ()
    if ndim == 2 and "router" not in name and leaf == "weight":
        if proj in _COL:
            return ("tp", None)
        if proj in _ROW:
            return (None, "tp")
    return ()


def shard_tensor(name: str, tensor: torch.Tensor, spec: tuple,
                 position: dict[str, tuple[int, int]]) -> torch.Tensor:
    """The block of `tensor` a shard holds: for each dimension the spec
    names an axis of, slice `position[axis]` = (index, size) of it; a
    dimension the axis size does not divide is refused (never padded:
    a row-parallel Q8_0 weight splits whole 32-wide input blocks)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        idx, size = position.get(axis, (0, 1))
        if size == 1:
            continue
        n = tensor.shape[dim]
        if n % size:
            raise ValueError(
                f"{name}: dimension {dim} of {n} does not split over "
                f"{axis}={size}")
        tensor = tensor.narrow(dim, idx * (n // size), n // size)
    return tensor


def shard_state_dict(state_dict: dict, position: dict[str, tuple[int, int]],
                     rules=decoder_param_pspec) -> dict:
    """One shard's state_dict: every entry split by `rules` at
    `position` ({axis: (index, size)}); replicated entries are shared."""
    return {name: shard_tensor(name, t, rules(name, t), position)
            for name, t in state_dict.items()}


def shard_params(state_dict: dict, mesh: Mesh, *, pspec_fn=None
                 ) -> list[dict]:
    """A state_dict split for each serving slot of the mesh (tp-major
    over tp x ep, Mesh.serving_devices' order) by `pspec_fn` (default
    the encoder's param_pspec; parallel/serve passes the decoder's)."""
    rules = pspec_fn or param_pspec
    tp, ep = mesh.shape["tp"], mesh.shape["ep"]
    return [shard_state_dict(state_dict, {"tp": (s // ep, tp),
                                          "ep": (s % ep, ep)}, rules)
            for s in range(tp * ep)]


def param_shardings(state_dict: dict, mesh: Mesh) -> dict:
    """Each entry's split under the encoder's rules (name -> spec)."""
    del mesh
    return {name: param_pspec(name, t) for name, t in state_dict.items()}


def batch_sharding(mesh: Mesh) -> tuple:
    """A batch splits its leading dimension on dp."""
    del mesh
    return ("dp",)


def replicated(mesh: Mesh) -> tuple:
    del mesh
    return ()


# ------------------------------------------------------------ collectives

def all_reduce_sum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of the shards' partial tensors, taken in shard order on
    the first shard's device, and the same sum on every shard's device.
    Out of place, so autograd goes through it: the backward of the
    reduction is the broadcast of the gradient, the backward of each
    copy (``.to``) a copy back.  Shards on one device share one result
    tensor, so every shard reads identical bits, and what follows must
    not write into it."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p.to(acc.device)
    return _broadcast(acc, parts)


def all_reduce_groups(parts: list[torch.Tensor], groups
                      ) -> list[torch.Tensor]:
    """all_reduce_sum within each group of shard indices (the shards
    that differ only in their position on the reduced axis); entry k of
    the result is shard k's sum."""
    out = [None] * len(parts)
    for g in groups:
        for k, r in zip(g, all_reduce_sum([parts[k] for k in g])):
            out[k] = r
    return out


def all_gather(parts: list[torch.Tensor], dim: int = 0
               ) -> list[torch.Tensor]:
    """The shards' tensors concatenated along `dim` in shard order, on
    every shard's device.  Out of place, so autograd goes through it
    (the backward of the concatenation slices each shard's part
    back)."""
    dev = parts[0].device
    whole = torch.cat([p.to(dev) for p in parts], dim)
    return _broadcast(whole, parts)


def _broadcast(value: torch.Tensor, parts) -> list[torch.Tensor]:
    copies = {value.device: value}
    out = []
    for p in parts:
        if p.device not in copies:
            copies[p.device] = value.to(p.device)
        out.append(copies[p.device])
    return out
