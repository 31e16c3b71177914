"""An encoder's weights drawn from the seed on the device, in the type
they are served in, in one call: normal(0, init_std) for every
projection and embedding, zero biases, LayerNorms at identity.  The
program and the reference are handed the same tensors; the names are
the port's state-dict names, which the reference reads too."""
from __future__ import annotations

import torch


def param_shapes(spec: dict) -> dict[str, tuple]:
    h, f = spec["hidden"], spec["mlp"]
    shapes = {"tok_emb.weight": (spec["vocab"], h)}
    if spec["family"] == "bert":
        shapes["pos_emb.weight"] = (spec["max_len"], h)
    shapes["ln_emb.weight"] = shapes["ln_emb.bias"] = (h,)
    mlp = ("gate", "up") if spec["family"] == "nomic_bert" else ("up",)
    for i in range(spec["layers"]):
        p = f"layer_{i}"
        shapes[f"{p}.attn.qkv.weight"] = (3 * h, h)
        shapes[f"{p}.attn.qkv.bias"] = (3 * h,)
        shapes[f"{p}.attn.out.weight"] = (h, h)
        shapes[f"{p}.attn.out.bias"] = (h,)
        for name in mlp:
            shapes[f"{p}.mlp.{name}.weight"] = (f, h)
            shapes[f"{p}.mlp.{name}.bias"] = (f,)
        shapes[f"{p}.mlp.down.weight"] = (h, f)
        shapes[f"{p}.mlp.down.bias"] = (h,)
        for ln in ("ln_attn", "ln_mlp"):
            shapes[f"{p}.{ln}.weight"] = shapes[f"{p}.{ln}.bias"] = (h,)
    return shapes


@torch.no_grad()
def make_params(spec: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Matrices (views of one bf16 draw) in bf16; biases and LayerNorm
    parameters in f32.  The port keeps biases when the published model
    has none; the benchmark sets them to zero, the published function."""
    shapes = param_shapes(spec)
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    total = sum(a * b for a, b in mats.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.bfloat16).mul_(spec["init_std"])
    out, lo = {}, 0
    for k, (a, b) in mats.items():
        out[k] = flat[lo: lo + a * b].view(a, b)
        lo += a * b
    for k, s in shapes.items():
        if len(s) == 1:
            fill = 1.0 if k.endswith(".weight") else 0.0
            out[k] = torch.full(s, fill, device=device)
    return out


def reference_params(params: dict[str, torch.Tensor], spec: dict,
                     device) -> dict[str, torch.Tensor]:
    """The same values in float32, without the bias tensors the published
    model does not have."""
    out = {}
    for k, v in params.items():
        projection_bias = k.endswith(".bias") and "ln_" not in k
        if projection_bias and not spec["biases"]:
            continue
        out[k] = v.to(device=device, dtype=torch.float32)
    return out
