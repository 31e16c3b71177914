"""Ring attention: sequence (context) parallelism over the mesh's ``sp``
axis, the counterpart of the JAX package's parallel/ring_attention.py.

Each sp shard holds one chunk of the sequence.  Attention runs
blockwise with an online (flash-style) softmax while the K/V chunks
and their key masks rotate one hop around the ring per step, so a
shard only ever holds O(S/n) keys:

  - softmax statistics are carried in f32 whatever the input dtype;
    masked keys take the finite bias ``NEG_INF`` and the running max
    starts at ``ACC_MIN``, so a row with no visible key stays NaN-free;
  - a causal mask compares GLOBAL positions (chunk i holds positions
    [i * S_local, (i + 1) * S_local));
  - the last step does not rotate;
  - each block step is recomputed in backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``),
    so backward memory stays O(S/n) per shard.

The JAX ring is jnp with ``lax.ppermute`` inside shard_map and has no
Pallas kernel; the port's ring step is plain torch the same way.  One
controller drives the shards: ``ring_attention`` takes the chunks as
per-shard lists and a rotation is a copy of each chunk to the next
shard's device (autograd's backward of the copy is the inverse
rotation).  A ring step built on K1's row statistics is later work.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .mesh import AXES, Mesh

NEG_INF = -1e9          # masked-score bias (finite: keeps softmax NaN-free)
ACC_MIN = -1e30         # initial running max


def _block_scores(q, k, scale):
    # q: (B, Sq, H, D)  k: (B, Sk, H, D)  ->  (B, H, Sq, Sk) in f32
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def _online_update(o, m, den, q, k, v, bias):
    """One flash-attention accumulation step: o (B, Sq, H, D) f32
    accumulator, m (B, H, Sq) running max, den (B, H, Sq) running
    denominator; bias broadcasts to (B, H, Sq, Sk)."""
    s = _block_scores(q, k, 1.0) + bias         # scale folded into q
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)                 # rescale old accumulator
    p = torch.exp(s - m_new[..., None])
    den = den * alpha + p.sum(dim=-1)
    o_blk = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o = o * alpha.transpose(1, 2)[..., None] + o_blk
    return o, m_new, den


def _rotate(parts: list) -> list:
    """One hop around the ring: shard i receives shard i - 1's tensor
    (lax.ppermute with (i, i + 1) pairs)."""
    n = len(parts)
    return [parts[(i - 1) % n].to(parts[i].device) for i in range(n)]


def ring_attention(qs: list, ks: list, vs: list, kv_masks: list, *,
                   causal: bool = False,
                   scale: float | None = None) -> list:
    """Blockwise ring attention over the sequence shards of one ring.

    qs, ks, vs: per shard (B, S_local, H, D), shard i on its device and
    holding chunk i.  kv_masks: per shard (B, S_local) bool key
    validity of its chunk; it rotates with K and V.  Returns per shard
    (B, S_local, H, D) in q's dtype."""
    n = len(qs)
    b, s, h, d = qs[0].shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = [q.float() * scale for q in qs]
    acc = [(torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, s), ACC_MIN, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, s), dtype=torch.float32, device=q.device))
           for q in qs]
    kr, vr, mr = list(ks), list(vs), list(kv_masks)
    for step in range(n):
        for i in range(n):
            src = (i - step) % n                 # the chunk shard i holds
            dev = qs[i].device
            bias = torch.where(mr[i][:, None, None, :], 0.0, NEG_INF)
            if causal:
                q_pos = i * s + torch.arange(s, device=dev)
                kv_pos = src * s + torch.arange(s, device=dev)
                bias = bias + torch.where(
                    q_pos[:, None] >= kv_pos[None, :], 0.0, NEG_INF)
            acc[i] = checkpoint(_online_update, *acc[i], qf[i], kr[i],
                                vr[i], bias, use_reentrant=False)
        if step != n - 1:
            kr, vr, mr = _rotate(kr), _rotate(vr), _rotate(mr)
    return [(o / torch.clamp(den, min=1e-30).transpose(1, 2)[..., None])
            .to(q.dtype) for (o, _, den), q in zip(acc, qs)]


def dense_reference(q, k, v, kv_mask, *, causal: bool = False,
                    scale: float | None = None):
    """Single-device dense attention with the ring's masking — the
    correctness oracle of the ring tests.  (B, S, H, D) in q's dtype."""
    s, d = q.shape[1], q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    scores = _block_scores(q, k, scale)
    bias = torch.where(kv_mask[:, None, None, :], 0.0, NEG_INF)
    if causal:
        pos = torch.arange(s, device=q.device)
        bias = bias + torch.where(pos[:, None] >= pos[None, :], 0.0,
                                  NEG_INF)
    p = torch.softmax(scores + bias, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def ring_attention_sharded(mesh: Mesh, q, k, v, kv_mask, *,
                           axis: str = "sp", causal: bool = False):
    """Split whole (B, S, H, D) q/k/v and the (B, S) key mask on the
    sequence over the mesh's `axis` (the batch over ``dp`` too), run
    one ring per dp row and put the chunks back together: (B, S, H, D)
    on q's device.  Differentiable in q, k and v."""
    if axis not in AXES:
        raise ValueError(f"no mesh axis {axis!r} in {AXES}")
    n = mesh.shape[axis]
    dp = mesh.shape["dp"] if axis != "dp" else 1
    b, s = q.shape[:2]
    if b % dp or s % n:
        raise ValueError(f"(B, S) = ({b}, {s}) does not split over "
                         f"dp={dp} x {axis}={n}")
    rb, c = b // dp, s // n
    rows = []
    for r in range(dp):
        devs = []
        for i in range(n):
            idx = [0] * len(AXES)
            idx[AXES.index("dp")] = r
            idx[AXES.index(axis)] = i
            devs.append(mesh.devices[tuple(idx)])

        def chunks(t):
            return [t[r * rb:(r + 1) * rb, i * c:(i + 1) * c].to(dev)
                    for i, dev in enumerate(devs)]

        outs = ring_attention(chunks(q), chunks(k), chunks(v),
                              chunks(kv_mask), causal=causal)
        rows.append(torch.cat([o.to(q.device) for o in outs], dim=1))
    return torch.cat(rows, dim=0)
