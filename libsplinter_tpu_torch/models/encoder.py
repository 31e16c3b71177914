"""Text embedding encoder (PyTorch), the counterpart of the JAX
package's flax encoder:

  - Nomic-BERT geometry by default (bert-base sized: 12 layers, 768
    hidden, 12 heads, vocab 30528) with rotary position embeddings and
    a SwiGLU MLP — the nomic-embed-text-v1.5 architecture family;
  - a `bert` variant (learned absolute positions, GELU MLP);
  - post-LN layers; mean pooling over valid tokens + L2 normalisation,
    with optional matryoshka truncation;
  - bfloat16 activations and matmul weights on the card (layer norms
    keep f32 parameters and compute in f32, as flax's LayerNorm does),
    float32 output;
  - flax's dtype / param_dtype split: parameters are created in f32 and
    the projections and embeddings compute in ``cfg.dtype``, so a
    trainer (parallel/train.py) updates f32 master weights while the
    forward runs in bf16.  Serving casts the module's matmul weights
    to bf16 once, which makes the per-call cast a no-op;
  - ``weights_int8`` keeps the attention and MLP projections on the card
    as per-output-channel int8 codes + f32 scales (models/quant.py).

A config also describes one shard of the multi-GPU trainers
(parallel/train.py): ``shard(tp)`` gives a tensor-parallel shard's
geometry, ``ring_axis`` a sequence-parallel chunk's.

Buckets at or above ``flash_min_seq`` attend through kernel K1
(ops/flash_attention.py); shorter ones through the plain masked
softmax, as in the JAX package.

Weights load from a GGUF file (models/gguf.py) or a safetensors file
(this module's own small reader, so the port needs no safetensors
package), or bridge from the JAX package's flax tree
(``params_from_jax``); otherwise the model runs with seeded random
weights drawn from an explicit torch.Generator.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..obs.devtime import DEVTIME
from ..ops.flash_attention import _mha_plain, flash_attention
from ..utils.device import DeviceFuture, resolve_device
from .quant import (ENCODER_QUANT_LEAVES, ChannelQuantDense,
                    quantize_state_dict)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 30528
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 2048
    variant: str = "nomic"        # "nomic" (rotary+swiglu) | "bert"
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16   # activation dtype
    out_dim: int = 768            # matryoshka truncation target
    # buckets at/above this width attend through kernel K1
    # (ops/flash_attention.py): no device-quadratic logits, so long
    # buckets keep real batch sizes.  0 disables (always plain).
    flash_min_seq: int = 512
    # per-output-channel int8 weight residency (models/quant.py
    # ChannelQuantDense, shared with the decoder's --weights-int8): the
    # attention and MLP projections keep int8 codes + f32 scales on the
    # card, their biases float
    weights_int8: bool = False
    # sequence parallelism: the mesh axis a sequence is split over
    # (conventionally "sp").  A module under such a config computes one
    # chunk, with ring attention over the others' keys, and is driven
    # by parallel/train.ShardedEncoder
    ring_axis: str | None = None
    # tensor-parallel shards this config describes ONE of (shard()):
    # heads, mlp_dim and the rows of the token (and bert position)
    # table are then that shard's; 1 = the model
    tp: int = 1

    @classmethod
    def tiny(cls, **kw) -> "EncoderConfig":
        """Small config for tests and CPU CI; kw overrides any field."""
        base = dict(vocab_size=1024, hidden=64, layers=2, heads=4,
                    mlp_dim=128, max_len=128)
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.hidden // (self.heads * self.tp)

    def shard(self, tp: int) -> "EncoderConfig":
        """The per-shard geometry of a tensor-parallel shard: heads/tp
        heads and mlp_dim/tp MLP lanes (the column-parallel outputs and
        row-parallel inputs it holds) and vocab_size/tp rows of the
        token table (max_len/tp of bert's position table): the encoder
        rule splits both tables on tp (parallel/mesh.param_pspec)."""
        if self.tp != 1:
            raise ValueError("shard() takes the whole model's config")
        names = ["heads", "mlp_dim", "vocab_size"]
        if self.variant == "bert":
            names.append("max_len")
        for name in names:
            if getattr(self, name) % tp:
                raise ValueError(f"{name}={getattr(self, name)} must "
                                 f"divide the tp={tp} mesh axis")
        return dataclasses.replace(self, heads=self.heads // tp,
                                   mlp_dim=self.mlp_dim // tp, tp=tp)


def _rotary_angles(seq_len: int, head_dim: int, device,
                   base: float = 10000.0):
    """Rotary (cos, sin), each (S, head_dim / 2) f32."""
    return _rotary_angles_at(torch.arange(seq_len, dtype=torch.float32,
                                          device=device), head_dim, base)


def _rotary_angles_at(pos, head_dim: int, base: float = 10000.0):
    """Rotary (cos, sin) at explicit positions (S,): a sequence-parallel
    chunk needs its GLOBAL positions (the JAX package's
    ``_rotary_angles_at``)."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (torch.arange(0, half, dtype=torch.float32,
                                         device=pos.device) / half))
    ang = pos.float()[:, None] * freqs[None, :]
    return torch.cos(ang), torch.sin(ang)


def _apply_rotary(x, cos, sin):
    """x: (B, S, H, D).  Rotates pairs (x1, x2) = (x[..., :half], rest)
    with cos/sin cast to x's dtype first: (S, D/2) shared across the
    batch, or (B, S, D/2) per row (the decoder's left-padded batches
    offset each row's positions)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class LayerNorm(nn.Module):
    """flax's LayerNorm arithmetic: f32 statistics with the fast
    variance E[x^2] - E[x]^2, f32 parameters, output in x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Dense(nn.Linear):
    """flax's Dense(dtype=...): input, weight and bias cast to `dtype`
    for the product, whatever the parameters' own dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Embed(nn.Embedding):
    """flax's Embed(dtype=...): the table cast to `dtype`, then the
    gather."""

    def __init__(self, num: int, dim: int, dtype: torch.dtype):
        super().__init__(num, dim)
        self.dtype = dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.dtype))

    def partial(self, ids, index: int):
        """One tensor-parallel shard's part of the lookup: this table
        holds rows [index * n, (index + 1) * n) of the whole one; ids
        outside them give zeros, so the sum over the shards is the
        whole lookup, exactly (one term of each sum is not zero)."""
        n = self.num_embeddings
        local = ids - index * n
        hit = (local >= 0) & (local < n)
        rows = self(torch.where(hit, local, 0))
        return torch.where(hit[..., None], rows, 0.0)


def _dense(cfg: EncoderConfig, din: int, dout: int) -> nn.Module:
    """The encoder's projection: Dense, or the per-output-channel int8
    residency when cfg.weights_int8 (same module name either way, so
    state_dicts convert in place via quant.quantize_state_dict)."""
    if cfg.weights_int8:
        return ChannelQuantDense(din, dout, cfg.dtype, use_bias=True)
    return Dense(din, dout, cfg.dtype)


class SelfAttention(nn.Module):
    """The attention block; a tensor-parallel shard's (cfg.tp > 1) holds
    its heads' rows of qkv, [q_t k_t v_t], and its columns of out."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.heads * cfg.head_dim
        self.qkv = _dense(cfg, cfg.hidden, 3 * width)
        self.out = _dense(cfg, width, cfg.hidden)

    def project(self, x, rotary=None):
        """q, k, v as (B, S, heads, head_dim) views of one projection,
        rotated for the nomic variant."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self.qkv(x).split(cfg.heads * cfg.head_dim, dim=-1)
        q = q.reshape(b, s, cfg.heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.heads, cfg.head_dim)
        if cfg.variant == "nomic":
            q = _apply_rotary(q, *rotary)
            k = _apply_rotary(k, *rotary)
        return q, k, v

    def attend(self, q, k, v, mask):
        """Attention over the whole (local) sequence: K1 at and above
        flash_min_seq, the plain masked softmax below it."""
        cfg = self.cfg
        if cfg.flash_min_seq and q.shape[1] >= cfg.flash_min_seq:
            return flash_attention(q, k, v, mask)
        # short buckets: the plain masked softmax, shared with the
        # kernel's CPU path so the attention paths cannot drift
        return _mha_plain(q, k, v, mask)

    def forward(self, x, mask, rotary=None):
        b, s, _ = x.shape
        out = self.attend(*self.project(x, rotary), mask)
        return self.out(out.reshape(b, s, -1))


class Mlp(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.variant = cfg.variant
        if cfg.variant == "nomic":
            self.gate = _dense(cfg, cfg.hidden, cfg.mlp_dim)
        self.up = _dense(cfg, cfg.hidden, cfg.mlp_dim)
        self.down = _dense(cfg, cfg.mlp_dim, cfg.hidden)

    def act(self, x):
        """The activations `down` reads: silu(gate) * up, or gelu(up)."""
        if self.variant == "nomic":
            return F.silu(self.gate(x)) * self.up(x)
        return F.gelu(self.up(x), approximate="tanh")

    def forward(self, x):
        return self.down(self.act(x))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.attn = SelfAttention(cfg)
        self.ln_attn = LayerNorm(cfg.hidden, cfg.layer_norm_eps)
        self.mlp = Mlp(cfg)
        self.ln_mlp = LayerNorm(cfg.hidden, cfg.layer_norm_eps)

    # post-LN (BERT family): sublayer -> residual -> LN.  The two steps
    # take the sublayer's output, so parallel/train.ShardedEncoder runs
    # them on its tp-reduced sums in the same order
    def after_attn(self, x, a):
        return self.ln_attn(x + a)

    def after_mlp(self, x, a):
        return self.ln_mlp(x + a)

    def forward(self, x, mask, rotary=None):
        x = self.after_attn(x, self.attn(x, mask, rotary))
        return self.after_mlp(x, self.mlp(x))


class Encoder(nn.Module):
    """Bidirectional encoder producing L2-normalised mean-pooled
    embeddings.  Submodule names mirror the flax tree (tok_emb,
    pos_emb, ln_emb, layer_<i>.{attn.{qkv,out},ln_attn,mlp.{gate,up,
    down},ln_mlp}), so params_from_jax maps leaf by leaf."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = Embed(cfg.vocab_size // cfg.tp, cfg.hidden, cfg.dtype)
        if cfg.variant == "bert":
            self.pos_emb = Embed(cfg.max_len // cfg.tp, cfg.hidden,
                                 cfg.dtype)
        self.ln_emb = LayerNorm(cfg.hidden, cfg.layer_norm_eps)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg))

    def layer_modules(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def embed_norm(self, x, pos_rows=None):
        """The embedding's end: the (bert) position rows added to the
        token rows, then ln_emb.  ShardedEncoder passes its tp-reduced
        lookups."""
        if pos_rows is not None:
            x = x + pos_rows[None]
        return self.ln_emb(x)

    def forward(self, token_ids, attn_mask):
        """token_ids: (B, S) int; attn_mask: (B, S) bool.  Returns
        (B, out_dim) f32."""
        cfg = self.cfg
        if cfg.tp != 1 or cfg.ring_axis:
            raise ValueError("a shard's encoder (tp > 1 or ring_axis) "
                             "computes part of the model: drive it through "
                             "parallel/train.ShardedEncoder")
        s = token_ids.shape[1]
        pos_rows = (self.pos_emb(torch.arange(s, device=token_ids.device))
                    if cfg.variant == "bert" else None)
        x = self.embed_norm(self.tok_emb(token_ids), pos_rows)
        rotary = (_rotary_angles(s, cfg.hidden // cfg.heads,
                                 token_ids.device)
                  if cfg.variant == "nomic" else None)
        for layer in self.layer_modules():
            x = layer(x, attn_mask, rotary)
        return pool_normalize(cfg, x, attn_mask)


def pool_normalize(cfg: EncoderConfig, x, attn_mask):
    """The encoder's output head: masked mean pool in f32, matryoshka
    truncation to out_dim, L2 normalize.  x: (..., S, hidden);
    attn_mask: (..., S)."""
    return pool_finish(cfg, *pool_sums(x, attn_mask))


def pool_sums(x, attn_mask):
    """The pool's f32 sums over the valid tokens and their counts.  A
    sequence-parallel encoder adds each chunk's before pool_finish
    divides (the JAX package's psum over the ring axis)."""
    xf = x.float()
    m = attn_mask.float()[..., None]
    return (xf * m).sum(dim=-2), m.sum(dim=-2)


def pool_finish(cfg: EncoderConfig, sums, counts):
    """The mean from the pool's sums and counts, truncated to out_dim
    and L2-normalized."""
    pooled = sums / torch.clamp(counts, min=1.0)
    pooled = pooled[..., : cfg.out_dim]
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / torch.clamp(norm, min=1e-9)


@torch.no_grad()
def init_params(module: Encoder, generator: torch.Generator) -> None:
    """Seeded random init drawn from `generator` (on the module's
    device): flax's defaults — Dense kernels normal(0, 1/fan_in)
    variance, zero biases, embeddings normal(0, 1/hidden) variance,
    layer norms at identity; int8-resident projections draw their codes
    (quant.ChannelQuantDense.init_weights)."""
    for m in module.modules():
        if isinstance(m, ChannelQuantDense):
            m.init_weights(generator)
        elif isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=generator)
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def state_dict_from_flax(flax_params) -> dict:
    """A flax tree (``{"params": ...}`` or the inner dict; leaves numpy
    or array-likes) -> a state_dict of f32 tensors named by the tree's
    paths.  Dense kernels transpose from (in, out) to (out, in);
    `embedding` and norm `scale` leaves become `weight`.  The int8
    residencies' leaf sets ({q, scale}, {wq, wscale} and {wq, wscale,
    bias}; models/quant.py) and stacked MoE experts' `*_experts_q`
    codes keep their names, layouts and dtypes (int8 codes, f32
    scales)."""
    tree = flax_params.get("params", flax_params)
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, val in node.items():
            if isinstance(val, dict) and _quant_leaves(val):
                for leaf, arr in val.items():
                    arr = np.asarray(arr)
                    arr = arr.astype(np.int8 if leaf in ("q", "wq")
                                     else np.float32)
                    out[".".join(path + [name, leaf])] = torch.from_numpy(
                        np.ascontiguousarray(arr))
                continue
            if isinstance(val, dict):
                walk(val, path + [name])
                continue
            arr = np.asarray(val, np.int8 if name.endswith("_experts_q")
                             else np.float32)
            if name == "kernel":
                arr, name = arr.T, "weight"
            elif name in ("embedding", "scale"):
                name = "weight"
            out[".".join(path + [name])] = torch.from_numpy(
                np.ascontiguousarray(arr))

    walk(tree, [])
    return out


def _quant_leaves(node: dict) -> bool:
    """True for a quantized projection's leaf set: a bare `q` or `wq`
    array (the attention's `q` PROJECTION is a dict)."""
    return any(k in node and not isinstance(node[k], dict)
               for k in ("q", "wq"))


def params_from_jax(flax_params, cfg: EncoderConfig) -> dict:
    """The weight bridge: a flax encoder tree -> this Encoder's
    state_dict (``state_dict_from_flax``; the nomic variant drops the
    unused position table)."""
    out = state_dict_from_flax(flax_params)
    if cfg.variant == "nomic":
        out.pop("pos_emb.weight", None)
    return out


def params_to_jax(module: Encoder) -> dict[str, np.ndarray]:
    """The bridge back: this Encoder's parameters under the JAX
    package's flat keys and layouts (``params/layer_0/attn/qkv/kernel``
    as (in, out), ``.../embedding``, norm ``.../scale``) as f32 numpy —
    what its ``save_params_npz`` writes for a flax tree."""
    out: dict[str, np.ndarray] = {}
    for name, m in module.named_modules():
        if isinstance(m, nn.Linear):
            leaves = {"kernel": m.weight.T, "bias": m.bias}
        elif isinstance(m, nn.Embedding):
            leaves = {"embedding": m.weight}
        elif isinstance(m, LayerNorm):
            leaves = {"scale": m.weight, "bias": m.bias}
        else:
            continue
        prefix = "/".join(["params", *name.split(".")])
        for leaf, t in leaves.items():
            out[f"{prefix}/{leaf}"] = np.ascontiguousarray(
                t.detach().float().cpu().numpy())
    return out


# -- safetensors ------------------------------------------------------------

_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
              "BF16": np.uint16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8}


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """Every tensor of a safetensors file as float32 numpy — the
    container is an 8-byte little-endian header length, a JSON header
    {name: {dtype, shape, data_offsets}}, then the raw data.  bf16 is
    read as uint16 and widened through torch's bfloat16 view."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out: dict[str, np.ndarray] = {}
    for name, ent in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES.get(ent["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name} has unsupported "
                             f"dtype {ent['dtype']}")
        lo, hi = ent["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=dt).reshape(ent["shape"])
        if ent["dtype"] == "BF16":
            arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).float().numpy()
        out[name] = arr.astype(np.float32)
    return out


def write_safetensors(path: str, tensors: dict[str, np.ndarray]) -> None:
    """Write float32 tensors in the container ``read_safetensors``
    reads: the JSON header padded with spaces to an 8-byte multiple."""
    header, blobs, off = {}, [], 0
    for name, arr in tensors.items():
        data = np.ascontiguousarray(arr, np.float32).tobytes()
        header[name] = {"dtype": "F32", "shape": list(np.shape(arr)),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for data in blobs:
            f.write(data)


def _hf_layer_names(i: int) -> dict[str, list[str]]:
    """Logical slot -> candidate HF tensor names for layer i: nomic_bert
    naming (fused Wqkv, SwiGLU fc11/fc12/fc2, norm1/norm2) and classic
    bert-base naming (split query/key/value, intermediate/output)."""
    n = f"encoder.layers.{i}"          # nomic family
    b = f"encoder.layer.{i}"           # bert family
    return {
        "qkv.weight": [f"{n}.attn.Wqkv.weight", f"{b}.attn.Wqkv.weight"],
        "qkv.bias": [f"{n}.attn.Wqkv.bias", f"{b}.attn.Wqkv.bias"],
        "q.weight": [f"{b}.attention.self.query.weight"],
        "q.bias": [f"{b}.attention.self.query.bias"],
        "k.weight": [f"{b}.attention.self.key.weight"],
        "k.bias": [f"{b}.attention.self.key.bias"],
        "v.weight": [f"{b}.attention.self.value.weight"],
        "v.bias": [f"{b}.attention.self.value.bias"],
        "attn_out.weight": [f"{n}.attn.out_proj.weight",
                            f"{b}.attention.output.dense.weight"],
        "attn_out.bias": [f"{n}.attn.out_proj.bias",
                          f"{b}.attention.output.dense.bias"],
        "ln_attn.weight": [f"{n}.norm1.weight",
                           f"{b}.attention.output.LayerNorm.weight"],
        "ln_attn.bias": [f"{n}.norm1.bias",
                         f"{b}.attention.output.LayerNorm.bias"],
        "gate.weight": [f"{n}.mlp.fc11.weight"],
        "gate.bias": [f"{n}.mlp.fc11.bias"],
        "up.weight": [f"{n}.mlp.fc12.weight",
                      f"{b}.intermediate.dense.weight"],
        "up.bias": [f"{n}.mlp.fc12.bias", f"{b}.intermediate.dense.bias"],
        "down.weight": [f"{n}.mlp.fc2.weight", f"{b}.output.dense.weight"],
        "down.bias": [f"{n}.mlp.fc2.bias", f"{b}.output.dense.bias"],
        "ln_mlp.weight": [f"{n}.norm2.weight",
                          f"{b}.output.LayerNorm.weight"],
        "ln_mlp.bias": [f"{n}.norm2.bias", f"{b}.output.LayerNorm.bias"],
    }


_HF_TOP_NAMES = {
    "tok_emb": ["embeddings.word_embeddings.weight",
                "bert.embeddings.word_embeddings.weight"],
    "pos_emb": ["embeddings.position_embeddings.weight",
                "bert.embeddings.position_embeddings.weight"],
    "ln_emb.weight": ["emb_ln.weight", "embeddings.LayerNorm.weight",
                      "bert.embeddings.LayerNorm.weight"],
    "ln_emb.bias": ["emb_ln.bias", "embeddings.LayerNorm.bias",
                    "bert.embeddings.LayerNorm.bias"],
}


def load_safetensors_params(path: str, cfg: EncoderConfig) -> dict:
    """Map a HF safetensors checkpoint onto this Encoder's state_dict.
    HF linear weights are already (out, in), PyTorch's layout; split
    q/k/v checkpoints are fused into qkv along the output axis in
    q, k, v order (the packing nomic's Wqkv uses).  Unresolved tensors
    fail loudly with the candidate names."""
    tensors = read_safetensors(path)

    def take(aliases: list[str], *, required: bool = True):
        for a in aliases:
            if a in tensors:
                return tensors[a]
        if required:
            raise KeyError(
                f"checkpoint {path} has none of {aliases}; present keys "
                f"include {sorted(tensors)[:8]}...")
        return None

    sd: dict[str, np.ndarray] = {}
    tok = take(_HF_TOP_NAMES["tok_emb"])
    if tok.shape[0] < cfg.vocab_size:
        raise ValueError(
            f"checkpoint vocab {tok.shape[0]} < cfg.vocab_size "
            f"{cfg.vocab_size} — shrink cfg.vocab_size to the "
            "checkpoint's")
    sd["tok_emb.weight"] = tok[:cfg.vocab_size]
    if cfg.variant == "bert":
        pos = take(_HF_TOP_NAMES["pos_emb"])
        if pos.shape[0] < cfg.max_len:
            raise ValueError(
                f"checkpoint has {pos.shape[0]} position rows < "
                f"cfg.max_len {cfg.max_len}; lower cfg.max_len to the "
                "checkpoint's trained length")
        sd["pos_emb.weight"] = pos[:cfg.max_len]
    sd["ln_emb.weight"] = take(_HF_TOP_NAMES["ln_emb.weight"])
    sd["ln_emb.bias"] = take(_HF_TOP_NAMES["ln_emb.bias"])
    for i in range(cfg.layers):
        names = _hf_layer_names(i)
        p = f"layer_{i}"
        fused = take(names["qkv.weight"], required=False)
        if fused is not None:
            sd[f"{p}.attn.qkv.weight"] = fused
            sd[f"{p}.attn.qkv.bias"] = take(names["qkv.bias"])
        else:
            sd[f"{p}.attn.qkv.weight"] = np.concatenate(
                [take(names[f"{x}.weight"]) for x in "qkv"], axis=0)
            sd[f"{p}.attn.qkv.bias"] = np.concatenate(
                [take(names[f"{x}.bias"]) for x in "qkv"])
        sd[f"{p}.attn.out.weight"] = take(names["attn_out.weight"])
        sd[f"{p}.attn.out.bias"] = take(names["attn_out.bias"])
        sd[f"{p}.ln_attn.weight"] = take(names["ln_attn.weight"])
        sd[f"{p}.ln_attn.bias"] = take(names["ln_attn.bias"])
        mlps = ("gate", "up", "down") if cfg.variant == "nomic" \
            else ("up", "down")
        for m in mlps:
            sd[f"{p}.mlp.{m}.weight"] = take(names[f"{m}.weight"])
            sd[f"{p}.mlp.{m}.bias"] = take(names[f"{m}.bias"])
        sd[f"{p}.ln_mlp.weight"] = take(names["ln_mlp.weight"])
        sd[f"{p}.ln_mlp.bias"] = take(names["ln_mlp.bias"])
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def export_safetensors_params(params: dict, cfg: EncoderConfig,
                              path: str) -> None:
    """Write an Encoder state_dict (a trainer's f32 parameters, say) as
    the HF-style checkpoint ``load_safetensors_params`` reads back:
    nomic_bert naming for the nomic variant, bert-base naming (q, k, v
    split) for bert — the inverse the JAX package's
    ``export_safetensors_params`` is of its loader."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in params.items()}
    nomic = cfg.variant == "nomic"
    alias = 0 if nomic else 1       # which of _hf_layer_names' candidates
    out = {_HF_TOP_NAMES["tok_emb"][0]: sd["tok_emb.weight"]}
    if not nomic:
        out[_HF_TOP_NAMES["pos_emb"][0]] = sd["pos_emb.weight"]
    for leaf in ("weight", "bias"):
        out[_HF_TOP_NAMES[f"ln_emb.{leaf}"][alias]] = sd[f"ln_emb.{leaf}"]
    mlps = ("gate", "up", "down") if nomic else ("up", "down")
    for i in range(cfg.layers):
        names, p = _hf_layer_names(i), f"layer_{i}"
        slots = {"attn_out": f"{p}.attn.out", "ln_attn": f"{p}.ln_attn",
                 "ln_mlp": f"{p}.ln_mlp"}
        slots.update({m: f"{p}.mlp.{m}" for m in mlps})
        for slot, key in slots.items():
            for leaf in ("weight", "bias"):
                out[names[f"{slot}.{leaf}"][alias]] = sd[f"{key}.{leaf}"]
        for leaf in ("weight", "bias"):
            fused = sd[f"{p}.attn.qkv.{leaf}"]
            if nomic:
                out[names[f"qkv.{leaf}"][0]] = fused
            else:
                for x, part in zip("qkv", np.split(fused, 3, axis=0)):
                    out[names[f"{x}.{leaf}"][0]] = part
    write_safetensors(path, out)


# -- the serving front end ----------------------------------------------------

def _to_host_f32(t: torch.Tensor) -> np.ndarray:
    """One device->host copy in the wire dtype, widened to f32 on the
    host (int8 at the fixed x127 scale)."""
    host = t.cpu()
    if host.dtype == torch.int8:
        return host.numpy().astype(np.float32) * np.float32(1.0 / 127.0)
    return host.float().numpy()


class PendingEmbeddings:
    """An encode dispatched but not yet fetched.  PyTorch queues CUDA
    work asynchronously, so the card computes while the host does
    other work; materialize() blocks for the result.  The batch may
    have been padded — only the first `n` rows are real."""

    __slots__ = ("_out", "n", "_mark")

    def __init__(self, out, n: int, mark=None):
        # a numpy result (custom encoder_fn lanes) is already host
        # memory; a tensor gets a CUDA event behind it
        self._out = out if isinstance(out, np.ndarray) \
            else DeviceFuture(out)
        self.n = n
        self._mark = mark             # devtime DispatchMark: closed at
        # materialize — the collect point that already exists

    def is_ready(self) -> bool:
        """True when materialize() will not block: the device work
        behind this future has completed (its CUDA event fired), or
        the result is already host memory.  The commit pipeline
        resolves futures in COMPLETION order with this."""
        out = self._out
        return True if isinstance(out, np.ndarray) else out.is_ready()

    def materialize(self) -> np.ndarray:
        out = self._out
        if isinstance(out, np.ndarray):
            host = out[: self.n].astype(np.float32, copy=False)
        else:
            host = _to_host_f32(out.value[: self.n])
        mark, self._mark = self._mark, None
        if mark is not None:
            mark.close()
        return host


class _RingOutput(DeviceFuture):
    """A ring dispatch's (depth, B, out_dim) wire-dtype tensor under
    the array protocol engine/resident.RingResult fetches through:
    one device->host copy of the whole ring, widened to f32."""

    __slots__ = ()

    def __array__(self, dtype=None, copy=None):
        host = _to_host_f32(self.value)
        return host if dtype is None else host.astype(dtype)


def _batch_pad(n: int) -> int:
    """Next power of two >= n: the batch dimension comes from a small
    fixed set of shapes, so the shape ledger and the matmul library's
    per-shape choices stay bounded."""
    return 1 << max(n - 1, 0).bit_length()


_WIRES = {None: None, "f16": torch.float16, "bf16": torch.bfloat16,
          "int8": torch.int8}


class EmbeddingModel:
    """Bucketed embedding front end on one device.

    Sequences are padded to the nearest bucket and batches to the next
    power of two, so the encoder runs at a small, fixed set of shapes.
    The attention mask is derived from the lengths on the device: the
    host ships (B, S) ids + (B,) lengths.
    """

    def __init__(self, cfg: EncoderConfig, *, seed: int = 0,
                 buckets: tuple[int, ...] = (16, 32, 64, 128, 256, 512,
                                             1024, 2048),
                 params: dict | None = None, weights: str | None = None,
                 fetch_dtype: str | None = None, device=None):
        """params: an Encoder state_dict (e.g. from params_from_jax);
        weights: a .gguf or .safetensors checkpoint path.  device: "cuda"
        (default) or "cpu".  fetch_dtype: None returns f32 embeddings
        from the device; "f16"/"bf16" cast the (already f32-pooled,
        L2-normalized) output on the device and fetch 2 bytes per
        component; "int8" fetches 1 byte per component at a FIXED x127
        scale (unit vectors need no per-vector scale).  materialize()
        always hands the caller f32.  cfg.weights_int8 keeps the
        projections int8-resident; a float state_dict is converted at
        load (quant.quantize_state_dict, idempotent)."""
        if fetch_dtype not in _WIRES:
            raise ValueError(f"fetch_dtype {fetch_dtype!r} not in "
                             f"(None, 'f16', 'bf16', 'int8')")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.fetch_dtype = fetch_dtype
        self._wire = _WIRES[fetch_dtype]
        # always include max_len itself: a text between buckets[-1] and
        # the window must not be silently truncated.  Sorted + deduped:
        # buckets_for's searchsorted requires ascending order.
        self.buckets = tuple(sorted(
            {b for b in buckets if b < cfg.max_len} | {cfg.max_len}))
        self._buckets_arr = np.asarray(self.buckets, np.int64)
        if params is None and weights is not None:
            if weights.endswith(".gguf"):
                from .gguf import load_encoder_params
                params = load_encoder_params(weights, cfg)
            else:
                params = load_safetensors_params(weights, cfg)
        with torch.device(self.device):
            module = Encoder(cfg)
        if params is not None and cfg.weights_int8:
            params = quantize_state_dict(params, ENCODER_QUANT_LEAVES,
                                         mode="channel")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            init_params(module, gen)
        else:
            module.load_state_dict(params)
        # matmul weights and embeddings in the activation dtype; layer
        # norms keep f32 parameters (flax's param_dtype), int8-resident
        # projections their codes and f32 scales
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.to(cfg.dtype)
        self.module = module.eval().requires_grad_(False)
        self._fn = DEVTIME.register("embedder.encode", self._forward)
        self._ring_fn = DEVTIME.register("embedder.ring",
                                         self._ring_forward)
        self._shapes: set[tuple[int, ...]] = set()

    @torch.no_grad()
    def _forward(self, token_ids, lengths):
        mask = (torch.arange(token_ids.shape[1], device=self.device)[None]
                < lengths[:, None])
        out = self.module(token_ids, mask)
        if self._wire is None:
            return out
        if self._wire == torch.int8:
            return torch.clamp(torch.round(out * 127.0),
                               -127.0, 127.0).to(torch.int8)
        return out.to(self._wire)

    @torch.no_grad()
    def _ring_forward(self, ids_ring, lens_ring, n_valid: int):
        depth, b = ids_ring.shape[0], ids_ring.shape[1]
        dim = min(self.cfg.out_dim, self.cfg.hidden)   # pooled width
        out = torch.zeros((depth, b, dim),
                          dtype=self._wire or torch.float32,
                          device=self.device)
        for i in range(n_valid):
            out[i] = self._forward(ids_ring[i], lens_ring[i])
        return out

    def compile_count(self) -> int:
        """Distinct (batch, bucket) shapes the encoder has run, plus
        distinct (depth, batch, bucket) ring shapes.  PyTorch has no
        jit cache: this is the shape-leak signal that rides the
        heartbeat — a count still growing after warmup means some
        drain geometry escapes the bucket set."""
        return len(self._shapes)

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def buckets_for(self, lengths: np.ndarray) -> np.ndarray:
        """Vectorised bucket_for: (N,) lengths -> (N,) bucket widths."""
        i = np.searchsorted(self._buckets_arr, lengths, side="left")
        return self._buckets_arr[np.minimum(i, len(self.buckets) - 1)]

    def _ids(self, token_ids: np.ndarray, lengths: np.ndarray):
        ids = torch.from_numpy(np.ascontiguousarray(token_ids, np.int64))
        lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int64))
        return ids.to(self.device), lens.to(self.device)

    def encode_ids_async(self, token_ids: np.ndarray,
                         lengths: np.ndarray) -> PendingEmbeddings:
        """Queue an encode without fetching the result.  token_ids:
        (B, S) int with S a bucket width; lengths: (B,) valid counts.
        The batch is padded to a power of two (padded rows have length
        0 and pool to the zero vector; rows are independent, so real
        rows' numerics are unchanged)."""
        n = token_ids.shape[0]
        bpad = _batch_pad(n)
        if bpad != n:
            token_ids = np.concatenate(
                [token_ids, np.zeros((bpad - n, token_ids.shape[1]),
                                     token_ids.dtype)])
            lengths = np.concatenate(
                [lengths, np.zeros(bpad - n, lengths.dtype)])
        self._shapes.add((bpad, int(token_ids.shape[1])))
        out = self._fn(*self._ids(token_ids, lengths))
        return PendingEmbeddings(out, n,
                                 mark=DEVTIME.take_mark("embedder.encode"))

    def encode_ids(self, token_ids: np.ndarray,
                   lengths: np.ndarray) -> np.ndarray:
        """token_ids: (B, S) int already padded to a bucket length;
        lengths: (B,) valid lengths.  Returns (B, out_dim) float32."""
        return self.encode_ids_async(token_ids, lengths).materialize()

    # -- multi-batch ring --------------------------------------------------

    def encode_ring_async(self, ids_ring: np.ndarray,
                          lens_ring: np.ndarray, n_valid: int,
                          *, retry=None):
        """Queue the first n_valid of `depth` pre-staged (B, S) batches
        and return a RingResult whose slot(i, n) views satisfy the
        PendingEmbeddings contract — the whole ring fetches in one
        copy on first materialize.  The slots run as back-to-back
        per-call forwards on the current stream (one CUDA graph for the
        ring is later work).  `retry` ((slot_i, n) -> f32 rows) arms
        the per-slot fallback for collect-time failures."""
        from ..engine.resident import RingResult
        from ..utils.faults import fault

        depth, b = int(ids_ring.shape[0]), int(ids_ring.shape[1])
        if not 1 <= n_valid <= depth:
            raise ValueError(f"n_valid {n_valid} outside 1..{depth}")
        fault("resident.ring_dispatch")
        self._shapes.add((depth, b, int(ids_ring.shape[2])))
        ring = self._ring_fn(*self._ids(ids_ring, lens_ring), n_valid)
        return RingResult(_RingOutput(ring), n_valid, retry=retry,
                          mark=DEVTIME.take_mark("embedder.ring"))

    def warmup_ring(self, depth: int, batch: int,
                    buckets: tuple[int, ...] | None = None) -> None:
        """Run the ring once per bucket at the serving (depth,
        batch-pad) geometry (allocator growth and the matmul library's
        per-shape choices happen here, off the wake path)."""
        if depth <= 1:
            return
        bpad = _batch_pad(batch)
        with DEVTIME.warmup_phase():
            for b in buckets or self.buckets:
                ids = np.zeros((depth, bpad, b), np.int32)
                lens = np.zeros((depth, bpad), np.int32)
                lens[0, :] = b
                self.encode_ring_async(ids, lens, 1).materialize_host()

    def warmup(self, batch_sizes: tuple[int, ...] = (8,)) -> None:
        """Run each (batch, bucket) shape once off the hot path."""
        with DEVTIME.warmup_phase():
            for bsz in batch_sizes:
                for b in self.buckets:
                    ids = np.zeros((bsz, b), np.int32)
                    lens = np.full((bsz,), b, np.int32)
                    self.encode_ids(ids, lens)
