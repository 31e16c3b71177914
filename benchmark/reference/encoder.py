"""Plain float32 forward passes of the benchmark's two encoder families,
written from their published descriptions, one sequence at a time.

  nomic_bert (nomic-embed-text-v1.5): token embedding, LayerNorm; per
    layer a fused q/k/v projection without bias, rotary positions on
    the whole head (the non-interleaved form: the two halves of a head
    rotate as a pair, angle pos / base^(i / half)), softmax attention,
    the output projection, residual then LayerNorm (post-norm), a SwiGLU
    MLP silu(x Wg) * (x Wu) Wd without biases, residual then LayerNorm.
  bert (e5-large-v2): token plus learned absolute position embeddings,
    LayerNorm; per layer q/k/v and output projections with biases,
    softmax attention, residual then LayerNorm, a GELU MLP with biases,
    residual then LayerNorm.

Both pool the last hidden states by their mean over the tokens and
normalise the mean to unit length.  Each departure of the configuration
as run from the published model is listed in the configuration's file
under `reduced` and `departures`; this module follows the file.

Parameters come in the benchmark's own naming (harness/weights.py):
`tok_emb.weight`, `pos_emb.weight`, `ln_emb.{weight,bias}`, and per
layer `layer_<i>.attn.qkv`, `.attn.out`, `.ln_attn`, `.mlp.gate`,
`.mlp.up`, `.mlp.down`, `.ln_mlp`, each `{weight,bias}`; a projection's
weight is (out, in).

`quant`, when given, rounds both operands of every product (the
projections and the two attention products) before it, and the product
sums in float32: the control computes the same function in a lower
precision through it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _mm(x, w, quant):
    """x (..., in) @ w (out, in)^T."""
    if quant is not None:
        x, w = quant(x), quant(w, weight=True)
    return x @ w.T


def _linear(x, p, name, quant):
    y = _mm(x, p[f"{name}.weight"], quant)
    b = p.get(f"{name}.bias")
    return y if b is None else y + b


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def _rotary(x, base):
    """x (S, H, D): the non-interleaved rotary embedding on all of D."""
    s, _, d = x.shape
    half = d // 2
    freqs = 1.0 / (base ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, quant):
    """(S, H, D) each -> (S, H * D)."""
    s, h, d = q.shape
    q, k, v = (t.permute(1, 0, 2) for t in (q, k, v))        # (H, S, D)
    if quant is not None:
        q, k, v = quant(q), quant(k), quant(v)
    logits = (q @ k.transpose(1, 2)) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1)
    if quant is not None:
        probs = quant(probs)
    return (probs @ v).permute(1, 0, 2).reshape(s, h * d)


def hidden_states(spec: dict, p: dict, ids: torch.Tensor,
                  quant=None) -> torch.Tensor:
    """The last layer's (S, hidden) states of one sequence of ids."""
    family, eps = spec["family"], spec["eps"]
    s = ids.shape[0]
    x = p["tok_emb.weight"][ids]
    if family == "bert":
        x = x + p["pos_emb.weight"][:s]
    x = _ln(x, p, "ln_emb", eps)
    heads = spec["heads"]
    for i in range(spec["layers"]):
        pre = f"layer_{i}"
        qkv = _linear(x, p, f"{pre}.attn.qkv", quant)
        q, k, v = (t.reshape(s, heads, -1) for t in qkv.chunk(3, dim=-1))
        if family == "nomic_bert":
            q, k = _rotary(q, spec["rotary_base"]), _rotary(k, spec["rotary_base"])
        a = _linear(_attention(q, k, v, quant), p, f"{pre}.attn.out", quant)
        x = _ln(x + a, p, f"{pre}.ln_attn", eps)
        if family == "nomic_bert":
            h = F.silu(_linear(x, p, f"{pre}.mlp.gate", quant)) \
                * _linear(x, p, f"{pre}.mlp.up", quant)
        else:
            h = F.gelu(_linear(x, p, f"{pre}.mlp.up", quant),
                       approximate=spec["gelu"])
        m = _linear(h, p, f"{pre}.mlp.down", quant)
        x = _ln(x + m, p, f"{pre}.ln_mlp", eps)
    return x


@torch.no_grad()
def embed(spec: dict, p: dict, ids: torch.Tensor, quant=None) -> torch.Tensor:
    """The unit-length mean-pooled embedding of one sequence, float32."""
    pooled = hidden_states(spec, p, ids, quant).mean(dim=0)[: spec["out_dim"]]
    return pooled / torch.clamp(torch.linalg.vector_norm(pooled), min=1e-9)


def fp8_e4m3(x: torch.Tensor, weight: bool = False) -> torch.Tensor:
    """x rounded through float8 e4m3 and back: one scale for a weight
    matrix, one per row (token) for an activation, each mapping the
    largest magnitude to e4m3's largest finite value, 448."""
    if weight:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=-1, keepdim=True)
    scale = 448.0 / torch.clamp(amax, min=1e-12)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale
