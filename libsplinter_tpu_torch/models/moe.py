"""Mixture-of-Experts decoder family (Mixtral-style) on one card — the
counterpart of the JAX package's models/moe.py.

  - the expert FFNs are STACKED weight tensors (E, hidden, mlp) and the
    layer is three einsums over the expert axis: dense compute, every
    expert runs for every token, and the router's top-k gates weight
    the combine (the reference computes it so; no kernel);
  - the router is an f32 projection with a softmax; gates renormalise
    over the selected top-k (Mixtral convention) and are cast to the
    activation dtype before the combine;
  - int8 residency (``cfg.quantized`` or ``cfg.weights_int8``) keeps
    each stack as Q8_0 blocks, ``{name}_q`` (E, din/32, 32, dout) int8
    + ``{name}_scale`` (E, din/32, dout) f32, dequantized before the
    einsum (quant.expert_weight).

``MoeDecoder`` is the shared Decoder trunk with ``MoeMlp`` mounted at
``layer_<i>.moe`` (decoder.DecoderLayer's mlp_cls hook), so the
completion daemon's CompletionModel serves it unchanged, prefills
through K4 and decodes through K5.

Expert parallelism: over a mesh the stacked expert tensors split their
expert axis on ``ep`` (parallel/mesh.decoder_param_pspec).  An ep
shard's MoeMlp holds n_experts/ep experts from ``expert_base``, routes
over ALL experts (the router replicates) and returns the gated partial
sum of its own; the sharded trunk (parallel/serve.ShardedDecoder) closes
each layer with one reduction over ep, and attention splits on tp
independently.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .decoder import CompletionModel, Decoder, DecoderConfig
from .quant import QBLOCK, _int8_uniform, expert_weight

EXPERT_LEAVES = ("gate_experts", "up_experts", "down_experts")


@dataclasses.dataclass(frozen=True)
class MoeDecoderConfig(DecoderConfig):
    n_experts: int = 8
    top_k: int = 2
    # expert-parallel shards this config describes one of (shard()):
    # n_experts is then that shard's, its first expert is expert_base
    ep: int = 1
    expert_base: int = 0

    @classmethod
    def tiny(cls, **kw) -> "MoeDecoderConfig":
        kw = {"vocab_size": 1024, "hidden": 64, "layers": 2, "heads": 4,
              "kv_heads": 2, "mlp_dim": 128, "max_len": 128,
              "n_experts": 4, "top_k": 2, **kw}
        return cls(**kw)

    def shard(self, tp: int, ep: int = 1,
              ep_index: int = 0) -> "MoeDecoderConfig":
        """The (tp, ep) shard's geometry: attention heads split on tp
        (decoder.DecoderConfig.shard), the experts on ep; the expert
        FFNs keep their full mlp_dim."""
        if self.n_experts % ep:
            raise ValueError(
                f"n_experts={self.n_experts} must divide the ep={ep} mesh "
                "axis (expert tensors shard their E dimension)")
        view = super().shard(tp)
        n = self.n_experts // ep
        return dataclasses.replace(view, mlp_dim=self.mlp_dim, n_experts=n,
                                   ep=ep, expert_base=ep_index * n)


class MoeRouter(nn.Module):
    """The f32 routing projection (E, hidden), bias-free; a module of
    its own (not an nn.Linear) so the trunk's cast to the activation
    dtype leaves it f32."""

    def __init__(self, hidden: int, n_experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_experts, hidden))

    def forward(self, x):
        return x.float() @ self.weight.t()


class MoeMlp(nn.Module):
    """Top-k routed SwiGLU experts, computed densely over stacked
    (E, ...) weights and combined with renormalised gates."""

    def __init__(self, cfg: MoeDecoderConfig):
        super().__init__()
        self.cfg = cfg
        e, h, m = cfg.n_experts, cfg.hidden, cfg.mlp_dim
        self.router = MoeRouter(h, e * cfg.ep)      # routes over all
        self.quantized = cfg.quantized or cfg.weights_int8
        for name, (din, dout) in zip(EXPERT_LEAVES,
                                     ((h, m), (h, m), (m, h))):
            if not self.quantized:
                self.register_parameter(name, nn.Parameter(
                    torch.empty((e, din, dout), dtype=cfg.dtype)))
                continue
            if din % QBLOCK:
                raise ValueError(
                    f"expert weight input dim {din} not a multiple of "
                    f"the quantization block {QBLOCK}")
            nb = din // QBLOCK
            self.register_buffer(f"{name}_q", torch.zeros(
                (e, nb, QBLOCK, dout), dtype=torch.int8))
            self.register_buffer(f"{name}_scale", torch.zeros(
                (e, nb, dout), dtype=torch.float32))

    def expert(self, name: str) -> torch.Tensor:
        """The (E, din, dout) stack `name` in the activation dtype."""
        if not self.quantized:
            return getattr(self, name)
        return expert_weight(getattr(self, f"{name}_q"),
                             getattr(self, f"{name}_scale"), self.cfg.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded draws from `generator`: float stacks normal(0,
        1/fan_in) variance; int8 stacks codes uniform in [-127, 127]
        under scales 1 / (127 sqrt(fan_in)).  The router is drawn like
        a Dense kernel."""
        w = self.router.weight
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                / math.sqrt(w.shape[1]))
        for name in EXPERT_LEAVES:
            if not self.quantized:
                p = getattr(self, name)
                p.copy_(torch.randn(p.shape, generator=generator,
                                    device=p.device) / math.sqrt(p.shape[1]))
                continue
            q = getattr(self, f"{name}_q")
            q.copy_(_int8_uniform(q.shape, generator, q.device))
            getattr(self, f"{name}_scale").fill_(
                1.0 / (127.0 * math.sqrt(q.shape[1] * QBLOCK)))

    def forward(self, x):
        cfg = self.cfg
        probs = torch.softmax(self.router(x), dim=-1)       # (B, S, E) f32
        topv, topi = torch.topk(probs, cfg.top_k, dim=-1)
        gates = torch.zeros_like(probs).scatter(-1, topi, topv)
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        # an ep shard combines its own experts: a partial sum over E
        gates = gates[..., cfg.expert_base:cfg.expert_base + cfg.n_experts]
        gates = gates.to(cfg.dtype)
        xd = x.to(cfg.dtype)
        g = torch.einsum("bsh,ehm->bsem", xd, self.expert("gate_experts"))
        u = torch.einsum("bsh,ehm->bsem", xd, self.expert("up_experts"))
        out = torch.einsum("bsem,emh->bseh", F.silu(g) * u,
                           self.expert("down_experts"))
        return torch.einsum("bseh,bse->bsh", out, gates)


def _check_ep(cfg: MoeDecoderConfig, mesh) -> None:
    ep = mesh.shape.get("ep", 1)
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts={cfg.n_experts} must divide the ep={ep} mesh "
            "axis (expert tensors shard their E dimension)")


def MoeDecoder(cfg: MoeDecoderConfig, mesh=None):
    """Causal MoE LM: the shared Decoder trunk with MoeMlp as each
    layer's MLP; the state_dict differs only inside each layer
    (layer_<i>.moe.{router.weight, *_experts}).  With a mesh: the shard
    modules of a parallel/serve.ShardedDecoder (attention on tp, experts
    on ep), their weights as constructed."""
    if mesh is None:
        return Decoder(cfg, mlp_cls=MoeMlp)
    _check_ep(cfg, mesh)
    from ..parallel.serve import ShardedDecoder
    return ShardedDecoder.empty(cfg, mesh, MoeMlp)


def moe_completion_model(cfg: MoeDecoderConfig, mesh=None,
                         **kw) -> CompletionModel:
    """CompletionModel over the MoE family; pass a mesh for sharded
    (tp attention + ep experts) serving."""
    if mesh is None:
        return CompletionModel(cfg, mlp_cls=MoeMlp, **kw)
    _check_ep(cfg, mesh)
    from ..parallel.serve import ShardedCompletionModel
    return ShardedCompletionModel(cfg, mesh, mlp_cls=MoeMlp, **kw)
