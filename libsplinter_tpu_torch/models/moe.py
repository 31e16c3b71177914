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
through K4 and decodes through K5.  Expert parallelism (the JAX
package's ``ep`` mesh axis) belongs to the multi-GPU slice.
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

    @classmethod
    def tiny(cls, **kw) -> "MoeDecoderConfig":
        kw = {"vocab_size": 1024, "hidden": 64, "layers": 2, "heads": 4,
              "kv_heads": 2, "mlp_dim": 128, "max_len": 128,
              "n_experts": 4, "top_k": 2, **kw}
        return cls(**kw)


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
        self.router = MoeRouter(h, e)
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
        gates = gates.to(cfg.dtype)
        xd = x.to(cfg.dtype)
        g = torch.einsum("bsh,ehm->bsem", xd, self.expert("gate_experts"))
        u = torch.einsum("bsh,ehm->bsem", xd, self.expert("up_experts"))
        out = torch.einsum("bsem,emh->bseh", F.silu(g) * u,
                           self.expert("down_experts"))
        return torch.einsum("bseh,bse->bsh", out, gates)


def MoeDecoder(cfg: MoeDecoderConfig) -> Decoder:
    """Causal MoE LM: the shared Decoder trunk with MoeMlp as each
    layer's MLP; the state_dict differs only inside each layer
    (layer_<i>.moe.{router.weight, *_experts})."""
    return Decoder(cfg, mlp_cls=MoeMlp)


def moe_completion_model(cfg: MoeDecoderConfig, mesh=None,
                         **kw) -> CompletionModel:
    """CompletionModel over the MoE family on one card.  A mesh (tensor
    attention + expert-parallel experts) is refused until the multi-GPU
    slice."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE serving over a mesh is not yet ported to "
            "the torch package (ROADMAP Queue A, multi-GPU: parallel/"
            "serve.py); one card serves the whole model")
    return CompletionModel(cfg, mlp_cls=MoeMlp, **kw)
