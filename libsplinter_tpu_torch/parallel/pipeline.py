"""Pipeline parallelism for the encoder: GPipe microbatching over the
mesh's ``pp`` axis, the counterpart of the JAX package's
parallel/pipeline.py.

  - the transformer LAYER stack is the pipelined region: the layers'
    parameters stack into (layers, ...) tensors (``stack_layer_params``)
    and each stage's device holds only its own (layers / stages) of
    them (``stage_params``); the token table and ``ln_emb`` sit on the
    first stage's device, the only one that reads them (the JAX
    package replicates them because GSPMD runs one program on every
    stage);
  - the GPipe schedule: at step t stage s runs microbatch t - s, and
    activations hop stage to stage by a copy to the next stage's
    device.  The JAX program computes masked garbage in the bubble
    steps; one controller simply skips them.  Stages on distinct cards
    overlap, since their launches are asynchronous;
  - the pool runs at the last stage, on the (B, S, hidden)
    activations, before the (B, out_dim) result is replicated (here:
    copied to the first stage's device);
  - everything is differentiable (the copies, the layer calls), so a
    backward pass through ``pipeline_encode`` is pipeline-parallel
    training: each stage's layers run K6 on their microbatches.

Exact-parity contract: pipeline_encode(...) equals Encoder.forward on
the same parameters for any stage count and microbatch split, up to
the GEMMs over a smaller M summing in another order.

Parameters are a whole encoder's state_dict (tensors that require
grad keep their gradients through the copies); each layer runs as the
encoder's own EncoderLayer through ``torch.func.functional_call``, so
no math is duplicated to drift.
"""
from __future__ import annotations

import torch

from ..models.encoder import (Embed, EncoderConfig, EncoderLayer, LayerNorm,
                              _rotary_angles, pool_normalize)
from .mesh import Mesh

_OUTER = ("tok_emb.weight", "ln_emb.weight", "ln_emb.bias")


def stack_layer_params(params, cfg: EncoderConfig) -> dict:
    """The layer_0 .. layer_{L-1} entries of a state_dict stacked by
    leaf: {"attn.qkv.weight": (L, 3 * hidden, hidden), ...}, weights in
    the port's (L, out, in) layout (the JAX package's kernels stack as
    (L, in, out))."""
    leaves = [n[len("layer_0."):] for n in params
              if n.startswith("layer_0.")]
    return {leaf: torch.stack([params[f"layer_{i}.{leaf}"]
                               for i in range(cfg.layers)])
            for leaf in leaves}


def stage_params(params, cfg: EncoderConfig, mesh: Mesh,
                 axis: str = "pp"):
    """ONE-TIME setup for the pipeline: split the parameters into
    (outer, staged) and place them.  outer: the non-layer parameters
    (tok_emb, ln_emb) on the first stage's device, where the embedding
    runs; staged: per stage, {leaf: (layers / stages, ...)} of its own layers
    on its device.  Pass the result to pipeline_encode_staged (or use
    make_pipeline_encode_fn): the whole layer stack never sits on one
    device."""
    stages = mesh.shape[axis]
    if cfg.layers % stages:
        raise ValueError(f"layers={cfg.layers} must divide into "
                         f"{stages} pipeline stages")
    per = cfg.layers // stages
    devs = mesh.axis_devices(axis)
    stacked = stack_layer_params(params, cfg)
    outer = {n: params[n].to(devs[0]) for n in _OUTER}
    staged = [{leaf: a[s * per:(s + 1) * per].to(dev)
               for leaf, a in stacked.items()}
              for s, dev in enumerate(devs)]
    return outer, staged


def pipeline_encode(cfg: EncoderConfig, mesh: Mesh, params, token_ids,
                    attn_mask, *, microbatches: int, axis: str = "pp"):
    """Stage `params` and run one pipelined forward.  token_ids: (B, S)
    int; attn_mask: (B, S) bool.  Returns (B, out_dim) f32 on the first
    stage's device — Encoder.forward's result on the same parameters.
    For repeated use call stage_params once (make_pipeline_encode_fn)."""
    outer, staged = stage_params(params, cfg, mesh, axis)
    return pipeline_encode_staged(cfg, mesh, outer, staged, token_ids,
                                  attn_mask, microbatches=microbatches,
                                  axis=axis)


def pipeline_encode_staged(cfg: EncoderConfig, mesh: Mesh, outer, staged,
                           token_ids, attn_mask, *, microbatches: int,
                           axis: str = "pp"):
    """The pipelined forward over pre-staged parameters (stage_params),
    differentiable in them."""
    if cfg.variant != "nomic":
        raise ValueError("pipeline_encode supports the rotary 'nomic' "
                         "variant (bert adds a position table)")
    if cfg.ring_axis:
        raise ValueError(
            "pipeline_encode is mutually exclusive with ring_axis: the "
            "layers would treat the whole sequence as sp-local chunks and "
            "mis-position and mis-pool it; compose pp with dp/tp instead")
    stages = mesh.shape[axis]
    devs = mesh.axis_devices(axis)
    ids = torch.as_tensor(token_ids, device=devs[0]).long()
    mask = torch.as_tensor(attn_mask, device=devs[0]).bool()
    b, s = ids.shape
    m = microbatches
    if b % m:
        raise ValueError(f"batch {b} must divide into {m} microbatches")
    mb = b // m
    per = cfg.layers // stages

    # the encoder's own modules, on the meta device: functional_call
    # runs them on each stage's tensors
    with torch.device("meta"):
        emb = Embed(cfg.vocab_size, cfg.hidden, cfg.dtype)
        ln = LayerNorm(cfg.hidden, cfg.layer_norm_eps)
        layer = EncoderLayer(cfg)
    call = torch.func.functional_call
    x = call(emb, {"weight": outer["tok_emb.weight"]}, (ids,))
    x = call(ln, {"weight": outer["ln_emb.weight"],
                  "bias": outer["ln_emb.bias"]}, (x,))
    x_mb = x.split(mb)
    masks = [[t.to(dev) for t in mask.split(mb)] for dev in devs]
    rot = [_rotary_angles(s, cfg.hidden // cfg.heads, dev) for dev in devs]

    def stage_fn(st: int, h, mk):
        for j in range(per):
            h = call(layer, {leaf: a[j] for leaf, a in staged[st].items()},
                     (h, mk, rot[st]))
        return h

    recv: list = [None] * stages
    outs: list = [None] * m
    for t in range(m + stages - 1):
        sent: list = [None] * stages
        for st in range(stages):
            j = t - st                   # the microbatch stage st runs
            if not 0 <= j < m:
                continue                 # a bubble step: nothing to run
            h = stage_fn(st, x_mb[j] if st == 0 else recv[st],
                         masks[st][j])
            if st == stages - 1:
                outs[j] = h
            else:
                sent[st + 1] = h.to(devs[st + 1])   # the hop to st + 1
        recv = sent
    # pool BEFORE replicating: the copy carries (B, out_dim), not the
    # S-times-larger activations
    pooled = pool_normalize(cfg, torch.cat(outs), torch.cat(masks[-1]))
    return pooled.to(devs[0])


def make_pipeline_encode_fn(cfg: EncoderConfig, mesh: Mesh, params, *,
                            microbatches: int, axis: str = "pp"):
    """Stage the parameters ONCE (each stage's device keeps only its
    layers; see stage_params) and return fn(token_ids, attn_mask) ->
    (B, out_dim)."""
    outer, staged = stage_params(params, cfg, mesh, axis)

    def fn(token_ids, attn_mask):
        return pipeline_encode_staged(cfg, mesh, outer, staged, token_ids,
                                      attn_mask, microbatches=microbatches,
                                      axis=axis)
    return fn
