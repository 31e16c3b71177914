"""Tensor-parallel completion serving: the decoder sharded over a mesh —
the counterpart of the JAX package's parallel/serve.py.

Megatron-style over the mesh's ``tp`` axis, as there:

  - q/k/v and gate/up projections split their OUTPUT features (heads,
    MLP lanes) — column parallel; out and down split their INPUT
    features — row parallel, so each block closes with exactly two
    reductions, after ``attn.out`` and after ``down``;
  - each shard's KV cache holds its kv-head slice (query heads split
    consistently, so GQA's head sharing stays inside a shard), and the
    paged pools are per-shard tensors of (n_blocks, KH/tp, page, D)
    under ONE host-side page scheduler (models/decoder.PagedKVCache):
    tables, lengths, admission and copy-on-write are the unsharded
    pool's, while cache bytes per shard divide by tp;
  - embeddings, norms and the LM head replicate, and so do the logits:
    the sampler runs once, on shard 0 with the model's own
    torch.Generator, exactly as the unsharded model's does;
  - MoE experts (models/moe.py) split their stacked expert axis on
    ``ep``; each ep shard's gated partial sum closes with a reduction
    over ep, while attention splits on tp independently.

Where GSPMD partitions one program, the port runs one shard module per
(tp, ep) slot of the mesh — a ``Decoder`` built on the per-shard
geometry (``DecoderConfig.shard``) — and ``ShardedDecoder`` drives them
layer by layer in lockstep, reducing between the halves of each layer
(decoder.DecoderLayer.attn / .mlp) with parallel/mesh.all_reduce_groups.
Every shard runs the hand-written kernels at its own shapes: K4 on
prefill chunks of flash_min_seq and more at heads/tp, K5 over its pool.

``ShardedCompletionModel`` IS a CompletionModel: the same prefill /
decode / batched / paged surface and the same page wire (a tp = 2 wire
page carries the tp = 1 page's bytes), so the completion daemon, the
split lanes and the KV tier drive it unchanged — scale-out is a
constructor swap.  Requires cfg.heads % tp == 0 and cfg.kv_heads % tp
== 0.
"""
from __future__ import annotations

import logging

import torch
from torch import nn

from ..models.decoder import (CompletionModel, Decoder, init_cache,
                              init_params, quantize_params, seat_module)
from ..ops._cuda import LAUNCHES
from .mesh import (Mesh, all_reduce_groups, decoder_param_pspec,
                   make_mesh, shard_params)

log = logging.getLogger("libsplinter_tpu_torch.serve")


def shard_decoder_params(state_dict: dict, mesh: Mesh) -> list[dict]:
    """A Decoder / MoE decoder state_dict split per decoder_param_pspec
    into one state_dict per serving slot of the mesh (tp-major over the
    tp x ep grid, as Mesh.serving_devices orders them)."""
    return shard_params(state_dict, mesh, pspec_fn=decoder_param_pspec)


class ShardedDecoder(nn.Module):
    """The per-slot shard modules of one decoder, driven in lockstep.

    Called like Decoder.forward — (token_ids, cache, pos, start, *,
    last, lengths, tables, n_valid) -> (B, S or 1, V) f32 logits on
    shard 0's device — where `cache` holds one Decoder cache per slot
    (a dense per-layer list each, or a sharded PagedKVCache's
    layers()).  Per layer every slot computes its attention partial;
    the partials reduce over tp (within each ep position) and add to
    each slot's copy of the residual stream; then the MLP partials
    reduce over tp for a dense MLP or over ep for MoE experts."""

    def __init__(self, cfg, shards: list[Decoder], mesh: Mesh):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.tp, self.ep = mesh.shape["tp"], mesh.shape["ep"]
        if len(shards) != self.tp * self.ep:
            raise ValueError(f"{len(shards)} shard modules for a "
                             f"tp={self.tp} x ep={self.ep} grid")
        self.shards = nn.ModuleList(shards)
        self.mlp_cls = shards[0].mlp_cls
        self.devices = mesh.serving_devices()
        ep = self.ep
        # reduction groups: slots that differ only in their tp (resp.
        # ep) position
        self._tp_groups = [[t * ep + e for t in range(self.tp)]
                           for e in range(ep)]
        self._ep_groups = [[t * ep + e for e in range(ep)]
                           for t in range(self.tp)]

    @classmethod
    def empty(cls, cfg, mesh: Mesh, mlp_cls=None) -> "ShardedDecoder":
        """Shard modules at the per-shard geometry on the mesh's serving
        devices, their weights as constructed (seat them with
        load_shards)."""
        tp, ep = mesh.shape["tp"], mesh.shape["ep"]
        shards = []
        for s, dev in enumerate(mesh.serving_devices()):
            with torch.device(dev):
                shards.append(Decoder(cfg.shard(tp, ep, s % ep), mlp_cls))
        return cls(cfg, shards, mesh)

    def load_shards(self, state_dict: dict) -> "ShardedDecoder":
        """Split the whole model's state_dict by the rules and seat each
        shard's part (decoder.seat_module: the activation-dtype cast)."""
        for m, sd in zip(self.shards, shard_decoder_params(state_dict,
                                                           self.mesh)):
            seat_module(m, sd)
        return self.eval().requires_grad_(False)

    def forward(self, token_ids, cache, pos: int, start=None, *,
                last: int | None = None, lengths=None, tables=None,
                n_valid: int | None = None):
        cfg = self.cfg
        if lengths is None and pos + token_ids.shape[1] > cfg.max_len:
            raise ValueError(f"slots {pos}..{pos + token_ids.shape[1] - 1} "
                             f"exceed the {cfg.max_len}-slot cache")

        def on(dev, t):
            return None if t is None else t.to(dev)

        shards, devs = list(self.shards), self.devices
        xs = [m.tok_emb(on(d, token_ids)) for m, d in zip(shards, devs)]
        starts = [on(d, start) for d in devs]
        lens = [on(d, lengths) for d in devs]
        tabs = [on(d, tables) for d in devs]
        mlp_groups = self._tp_groups if self.mlp_cls is None \
            else self._ep_groups
        for li in range(cfg.layers):
            layers = [getattr(m, f"layer_{li}") for m in shards]
            parts = []
            try:
                for s, (m, ly, x) in enumerate(zip(shards, layers, xs)):
                    LAUNCHES.shard = s       # the kernels' per-shard count
                    parts.append(ly.attn(ly.ln_attn(x), cache[s][li], pos,
                                         starts[s], (m.rot_cos, m.rot_sin),
                                         lens[s], tabs[s], n_valid))
            finally:
                LAUNCHES.shard = None
            xs = [x + r for x, r in zip(
                xs, all_reduce_groups(parts, self._tp_groups))]
            parts = [ly.mlp(ly.ln_mlp(x)) for ly, x in zip(layers, xs)]
            xs = [x + r for x, r in zip(
                xs, all_reduce_groups(parts, mlp_groups))]
        head = shards[0]
        x = head.ln_out(xs[0])
        if last is not None:
            x = x[:, last:last + 1]
        return head.lm_head(x.float())


class ShardedCompletionModel(CompletionModel):
    """CompletionModel whose weights and KV caches live sharded on a
    mesh: the prefill / decode / batched / paged surface, the sampler
    and the page wire are inherited, the cache hooks keep one cache per
    shard slot.

    module=: a ShardedDecoder over this mesh serves the weights it
    holds (a self-draft's view of its target).  A custom module NOT
    built for the mesh is served whole on the mesh's first device with
    the paged lane off for this instance (paged_supported False; the
    completion daemon then serves dense), as the JAX package demotes a
    meshless module."""

    paged_supported = True

    def __init__(self, cfg, mesh: Mesh | None = None, *, device=None,
                 **kw):
        if mesh is None:
            mesh = make_mesh(device=device or "cuda")
        self.mesh = mesh
        tp = mesh.shape["tp"]
        if cfg.heads % tp or cfg.kv_heads % tp:
            raise ValueError(
                f"heads={cfg.heads}/kv_heads={cfg.kv_heads} must divide "
                f"the tp={tp} mesh axis")
        first = mesh.serving_devices()[0]
        if device is not None and torch.device(device).type != first.type:
            raise ValueError(f"device={device!r} but the mesh is on "
                             f"{first.type}")
        module = kw.get("module")
        if module is not None and not isinstance(module, ShardedDecoder):
            self.paged_supported = False
            log.warning("sharded serving with a module not built for the "
                        "mesh: it runs whole on %s, dense lane only", first)
        super().__init__(cfg, device=first, **kw)

    def _build(self, cfg, seed: int, params, mlp_cls):
        module = ShardedDecoder.empty(cfg, self.mesh, mlp_cls)
        if params is None:
            # the unsharded model's seeded draw, then split: a seed
            # gives the same weights at every tp
            with torch.device(self.device):
                whole = Decoder(cfg, mlp_cls)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            init_params(whole, gen)
            params = whole.state_dict()
            del whole
        return module.load_shards(quantize_params(cfg, params))

    @property
    def _sharded(self) -> bool:
        return isinstance(self.module, ShardedDecoder)

    # -- per-shard caches ----------------------------------------------------

    def _slots(self):
        """(device, shard config) per serving slot."""
        return [(d, m.cfg) for d, m in zip(self.module.devices,
                                           self.module.shards)]

    def _fresh_cache(self, batch: int):
        if not self._sharded:
            return super()._fresh_cache(batch)
        return [init_cache(c, batch, d) for d, c in self._slots()]

    def _row_cache(self, row: int):
        if not self._sharded:
            return super()._row_cache(row)
        return [[(k[row:row + 1], v[row:row + 1]) for k, v in c]
                for c in self._cache]

    def _cache_rows(self) -> int:
        if not self._sharded:
            return super()._cache_rows()
        return self._cache[0][0][0].shape[0]

    def _paged_scratch(self, bucket: int):
        if not self._sharded:
            return super()._paged_scratch(bucket)
        import dataclasses
        return [init_cache(dataclasses.replace(c, max_len=bucket), 1, d)
                for d, c in self._slots()]

    def _pool_shards(self):
        if not self._sharded:
            return super()._pool_shards()
        ep = self.mesh.shape["ep"]
        return [(d, s // ep) for s, d in enumerate(self.module.devices)]

    def _per_shard(self, cache) -> list:
        return cache if self._sharded else [cache]
