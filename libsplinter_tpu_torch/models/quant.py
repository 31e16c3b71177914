"""Int8 weight residency for the decoder and the encoder (PyTorch): the
projection weights stay on the card as int8 codes plus f32 scales, in
the JAX package's two geometries.

  - ``QuantDense`` (Q8_0 blocks, the decoder's ``--quantized``): blocks
    of 32 consecutive INPUT elements share one scale, buffers ``q``
    (in/32, 32, out) int8 and ``scale`` (in/32, out) f32.  The scale
    varies along the contraction axis, so the weight is dequantized in
    the activation dtype BEFORE the product, as the reference does.
  - ``ChannelQuantDense`` (one scale per OUTPUT column, the decoder's
    ``--weights-int8`` and the encoder's ``weights_int8``): buffers
    ``wq`` (in, out) int8 and ``wscale`` (out,) f32, plus an optional
    float ``bias``.  The scale is constant along the contraction axis,
    so the product runs first and the scale multiplies its f32 output.
    The reference accumulates that product in f32
    (``preferred_element_type=float32``); here both operands are cast
    to the activation dtype and then widened to f32, so the product
    sees exactly the reference's operand values and keeps an f32
    result (no bf16 rounding before the scale).

The numpy quantizers and the leaf sets are the JAX package's, unchanged;
the tree walkers are this package's own (numpy dicts, no jax.tree) and
``quantize_state_dict`` applies the same per-leaf quantizers to a
state_dict, which is how a float checkpoint (safetensors, GGUF, a
bridged flax tree) becomes int8-resident at load.  Requantizing a Q8_0
GGUF's dequantized weights is lossless: every block's largest element
maps to +-127 again, so d and q come back exactly.

The LM head and the embeddings stay float.  Stacked MoE experts
(models/moe.py) take the Q8_0 geometry in either residency:
``{name}_q`` (E, din/32, 32, dout) int8 and ``{name}_scale`` (E,
din/32, dout) f32, dequantized before the einsum (``expert_weight``).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

QBLOCK = 32                           # ggml Q8_0 block width


class QuantDense(nn.Module):
    """Bias-free projection whose weight lives as Q8_0-geometry int8
    blocks + f32 scales (the decoder's ``--quantized``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, block: int = QBLOCK):
        super().__init__()
        if in_features % block:
            raise ValueError(
                f"QuantDense input dim {in_features} not a multiple of "
                f"the quantization block {block}")
        nb = in_features // block
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.register_buffer(
            "q", torch.zeros((nb, block, out_features), dtype=torch.int8))
        self.register_buffer(
            "scale", torch.zeros((nb, out_features), dtype=torch.float32))

    def forward(self, x):
        dt = self.dtype
        w = (self.q.to(dt) * self.scale[:, None, :].to(dt)).reshape(
            self.in_features, self.out_features)
        return x.to(dt) @ w

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded codes uniform in [-127, 127] and scales 1 / (127
        sqrt(fan_in)): dequantized weights near lecun-normal size."""
        self.q.copy_(_int8_uniform(self.q.shape, generator, self.q.device))
        self.scale.fill_(1.0 / (127.0 * math.sqrt(self.in_features)))


class ChannelQuantDense(nn.Module):
    """Projection with per-output-channel int8 residency: the product
    first (f32 result), then the f32 scale, the cast to the activation
    dtype and the optional float bias (the encoder's BERT-family dense
    layers carry one)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, use_bias: bool = False):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.register_buffer(
            "wq", torch.zeros((in_features, out_features), dtype=torch.int8))
        self.register_buffer(
            "wscale", torch.zeros((out_features,), dtype=torch.float32))
        if use_bias:
            self.register_buffer(
                "bias", torch.zeros((out_features,), dtype=torch.float32))
        else:
            self.bias = None

    def forward(self, x):
        dt = self.dtype
        y = x.to(dt).float() @ self.wq.to(dt).float()
        y = (y * self.wscale).to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded codes uniform in [-127, 127], scales 1 / (127
        sqrt(fan_in)), a zero bias."""
        self.wq.copy_(_int8_uniform(self.wq.shape, generator,
                                    self.wq.device))
        self.wscale.fill_(1.0 / (127.0 * math.sqrt(self.in_features)))
        if self.bias is not None:
            self.bias.zero_()


def expert_weight(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Stacked expert weight (E, din, dout) in `dtype` from int8-resident
    blocks, dequantized as QuantDense does: q (E, din/32, 32, dout)
    int8, scale (E, din/32, dout) f32."""
    e, nb, block, dout = q.shape
    return (q.to(dtype) * scale[:, :, None, :].to(dtype)).reshape(
        e, nb * block, dout)


def _int8_uniform(shape, generator: torch.Generator, device):
    return torch.randint(-127, 128, tuple(shape), generator=generator,
                         device=device, dtype=torch.int32).to(torch.int8)


def resident_bytes(module: nn.Module) -> int:
    """Bytes the quantized projections of `module` hold (codes, scales
    and biases)."""
    return sum(b.numel() * b.element_size()
               for m in module.modules()
               if isinstance(m, (QuantDense, ChannelQuantDense))
               for b in m.buffers(recurse=False))


# -- the JAX package's numpy quantizers, unchanged ---------------------------

def quantize_kernel(kernel: np.ndarray,
                    block: int = QBLOCK) -> dict[str, np.ndarray]:
    """Float (in, out) kernel -> Q8_0-geometry {q, scale}.

    Symmetric per-block: d = max|w| / 127 over each block of `block`
    consecutive INPUT rows (ggml blocks run along the contraction dim),
    q = round(w / d).  Max roundoff per element is d/2."""
    din, dout = kernel.shape
    if din % block:
        raise ValueError(f"kernel input dim {din} not a multiple of "
                         f"the quantization block {block}")
    w = np.asarray(kernel, np.float32).reshape(din // block, block, dout)
    d = np.abs(w).max(axis=1) / 127.0            # (nb, out)
    d = np.where(d == 0, 1.0, d)                 # all-zero block
    q = np.clip(np.round(w / d[:, None, :]), -127, 127).astype(np.int8)
    return {"q": q, "scale": d.astype(np.float32)}


def dequantize_kernel(qp: dict, block: int = QBLOCK) -> np.ndarray:
    """Inverse of quantize_kernel (exact for its own output)."""
    q = np.asarray(qp["q"], np.float32)
    scale = np.asarray(qp["scale"], np.float32)
    nb, b, dout = q.shape
    return (q * scale[:, None, :]).reshape(nb * b, dout)


def quantize_channel_kernel(kernel: np.ndarray) -> dict[str, np.ndarray]:
    """Float (in, out) kernel -> per-output-channel {wq, wscale}:
    d = max|w_column| / 127 over each OUTPUT column (the scale is
    constant along the contraction axis, which is what lets
    ChannelQuantDense dequantize after the matmul), q = round(w/d).
    Max roundoff per element is d/2."""
    w = np.asarray(kernel, np.float32)
    d = np.abs(w).max(axis=0) / 127.0            # (out,)
    d = np.where(d == 0, 1.0, d)                 # all-zero column
    q = np.clip(np.round(w / d[None, :]), -127, 127).astype(np.int8)
    return {"wq": q, "wscale": d.astype(np.float32)}


def dequantize_channel_kernel(qp: dict) -> np.ndarray:
    """Inverse of quantize_channel_kernel (exact for its own output)."""
    return (np.asarray(qp["wq"], np.float32)
            * np.asarray(qp["wscale"], np.float32)[None, :])


# dense leaves the decoder quantizes: attention projections + MLP
QUANT_LEAVES = ("q", "k", "v", "out", "gate", "up", "down")

# dense leaves the ENCODER quantizes (EncoderConfig.weights_int8):
# the fused qkv projection plus the same out/MLP set
ENCODER_QUANT_LEAVES = ("qkv", "out", "gate", "up", "down")


# -- tree walkers (flax-layout numpy dicts) ----------------------------------

def quantize_encoder_params(params) -> dict:
    """A float encoder tree ({"params": ...}, flax layout, array-like
    leaves) -> the per-output-channel layout: every attention/MLP kernel
    becomes {wq, wscale} with its bias riding along float; embeddings
    and norms stay float.  Idempotent: converted modules pass through.
    Returns {"params": tree} of numpy arrays."""

    def walk(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        out = {}
        for k, v in node.items():
            if (k in ENCODER_QUANT_LEAVES and isinstance(v, dict)
                    and "kernel" in v and "wq" not in v):
                qk = quantize_channel_kernel(np.asarray(v["kernel"]))
                out[k] = {**qk, **{n: np.asarray(b) for n, b in v.items()
                                   if n != "kernel"}}
            else:
                out[k] = walk(v)
        return out

    return {"params": walk(params["params"])}


def quantize_decoder_params(params, block: int = QBLOCK,
                            mode: str = "block") -> dict:
    """A float decoder tree ({"params": ...}, flax layout) -> every
    attention/MLP kernel as {q, scale} (mode="block", QuantDense) or
    {wq, wscale} (mode="channel", ChannelQuantDense); stacked MoE expert
    tensors (`*_experts`, (E, din, dout)) become `*_experts_q` +
    `*_experts_scale` (always block: they dequantize through
    expert_weight); embeddings, norms, routers and the LM head stay
    float.  Idempotent: already-quantized leaves (no bare {kernel})
    pass through.  Returns {"params": tree} of numpy arrays."""
    if mode not in ("block", "channel"):
        raise ValueError(f"unknown quantization mode {mode!r}")

    def walk(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        out = {}
        for k, v in node.items():
            if (k in QUANT_LEAVES and isinstance(v, dict)
                    and set(v) == {"kernel"}):
                kern = np.asarray(v["kernel"])
                out[k] = (quantize_channel_kernel(kern) if mode == "channel"
                          else quantize_kernel(kern, block))
            elif k.endswith("_experts") and not isinstance(v, dict):
                out.update(_quantize_experts(k, np.asarray(v), block))
            else:
                out[k] = walk(v)
        return out

    return {"params": walk(params["params"])}


def _quantize_experts(name: str, arr: np.ndarray,
                      block: int) -> dict[str, np.ndarray]:
    """(E, din, dout) float experts -> {name_q, name_scale}, each expert
    through quantize_kernel."""
    qs = [quantize_kernel(arr[e], block) for e in range(arr.shape[0])]
    return {f"{name}_q": np.stack([x["q"] for x in qs]),
            f"{name}_scale": np.stack([x["scale"] for x in qs])}


def quantize_state_dict(sd: dict, leaves: tuple[str, ...],
                        mode: str = "block", block: int = QBLOCK) -> dict:
    """The walkers' conversion on a state_dict: every float
    ``<path>.<leaf>.weight`` (out, in) whose leaf is in `leaves` becomes
    ``<path>.<leaf>.q``/``.scale`` (mode "block") or ``.wq``/``.wscale``
    (mode "channel"), from the same numpy quantizers on its (in, out)
    kernel; a float ``<path>.<name>_experts`` stack (E, din, dout)
    becomes ``<name>_experts_q``/``_scale`` (block, in either mode, as
    the walker does); biases and every other tensor pass through.
    Idempotent."""
    if mode not in ("block", "channel"):
        raise ValueError(f"unknown quantization mode {mode!r}")
    out: dict[str, torch.Tensor] = {}
    for name, t in sd.items():
        parts = name.split(".")
        if parts[-1].endswith("_experts") and t.dim() == 3:
            prefix = ".".join(parts[:-1] + [""])
            for leaf, arr in _quantize_experts(
                    parts[-1], t.detach().float().cpu().numpy(),
                    block).items():
                out[prefix + leaf] = torch.from_numpy(arr)
            continue
        if not (len(parts) >= 2 and parts[-1] == "weight"
                and parts[-2] in leaves and t.dim() == 2):
            out[name] = t
            continue
        prefix = ".".join(parts[:-1])
        kern = t.detach().float().cpu().numpy().T
        qp = (quantize_channel_kernel(kern) if mode == "channel"
              else quantize_kernel(kern, block))
        for leaf, arr in qp.items():
            out[f"{prefix}.{leaf}"] = torch.from_numpy(
                np.ascontiguousarray(arr))
    return out
