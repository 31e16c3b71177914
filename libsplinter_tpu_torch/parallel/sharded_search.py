"""Sharded similarity search: the store's vector lane split row-wise
over a mesh axis; each shard computes its local top-k with the
similarity kernels, then the per-shard candidates are gathered and
merged — the counterpart of the JAX package's parallel/sharded_search.py.

Each shard's local pass runs kernel K2 (fused scores + top-k) when its
k is at most FUSED_K_MAX, else kernel K3 (the score matrix) and a
stable sort.  On CUDA blocks the kernels launch or raise; their plain
versions serve only CPU blocks.  The merge keeps the JAX program's
order: (score desc, then shard, then the shard's own order), so the
merged rows are the one-shard kernel's, ties and filler included.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops._cuda import LAUNCHES
from ..ops.similarity import (FUSED_K_MAX, _fused_topk_plain, _stable_topk,
                              cosine_scores, fused_topk_cuda)
from .mesh import Mesh, all_gather, make_mesh


def shard_vectors(mesh: Mesh, vectors, axis: str = "dp"
                  ) -> list[torch.Tensor]:
    """A host (N, D) matrix as row blocks, one per device along `axis`,
    each its own contiguous f32 tensor on its device (N must divide the
    axis)."""
    devs = mesh.axis_devices(axis)
    v = torch.as_tensor(np.asarray(vectors, np.float32)) \
        if not isinstance(vectors, torch.Tensor) else vectors.float()
    n = v.shape[0]
    if n % len(devs):
        raise ValueError("row count must divide the mesh axis")
    t = n // len(devs)
    return [v[i * t:(i + 1) * t].to(d).contiguous()
            for i, d in enumerate(devs)]


def _local_topk(block, queries, mask, k: int, mxu_bf16: bool):
    """One shard's (Q, k) scores and rows: K2 for k <= FUSED_K_MAX
    ((NEG_INF, -1) filler past the candidates), else K3 + a stable sort
    (filler rows keep their NEG_INF-scored indices, as lax.top_k's)."""
    if k <= FUSED_K_MAX:
        if block.is_cuda:
            return fused_topk_cuda(block, queries, k, mask,
                                   mxu_bf16=mxu_bf16)
        return _fused_topk_plain(block, queries, k, mask, mxu_bf16=mxu_bf16)
    scores = cosine_scores(block, queries, mask, mxu_bf16=mxu_bf16)
    return _stable_topk(scores.T, k)


def _merge(scores: torch.Tensor, rows: torch.Tensor, k: int):
    """Top k of (Q, C) candidates in their given order: a stable sort,
    so equal scores keep the earlier candidate (lax.top_k's rule)."""
    s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[:, :k], torch.gather(rows, 1, order[:, :k])


def _split_mask(mask, blocks) -> list:
    """Per-block f32 masks on the blocks' devices (None: no mask)."""
    if mask is None:
        return [None] * len(blocks)
    m = mask.float() if isinstance(mask, torch.Tensor) \
        else torch.as_tensor(np.asarray(mask, np.float32))
    t = blocks[0].shape[0]
    return [m[i * t:(i + 1) * t].to(b.device).contiguous()
            for i, b in enumerate(blocks)]


def local_candidates(blocks: list[torch.Tensor], query, k: int, mask=None,
                     *, offset: int = 0, mxu_bf16: bool = False):
    """The merged top-k over row blocks, as device tensors: ((Q, k')
    scores, (Q, k') GLOBAL rows) with k' = min(k, rows), rows offset by
    `offset` + the block's start; filler rows stay -1."""
    local_n = int(blocks[0].shape[0])
    k_local = min(k, local_n)
    q = torch.as_tensor(np.asarray(query, np.float32)) \
        if not isinstance(query, torch.Tensor) else query.float()
    if q.ndim == 1:
        q = q[None, :]
    ss, ii = [], []
    for b, (block, m) in enumerate(zip(blocks, _split_mask(mask, blocks))):
        LAUNCHES.shard = b                  # the kernels' per-shard count
        try:
            s, i = _local_topk(block, q.to(block.device).contiguous(), m,
                               k_local, mxu_bf16)
        finally:
            LAUNCHES.shard = None
        i = i.to(torch.int64)
        ss.append(s)
        ii.append(torch.where(i >= 0, i + (offset + b * local_n), -1))
    all_s = all_gather(ss, dim=1)[0]          # (Q, m * k_local)
    all_i = all_gather(ii, dim=1)[0]
    return _merge(all_s, all_i, min(k, local_n * len(blocks)))


def sharded_topk(mesh: Mesh, vectors, query, k: int, mask=None,
                 axis: str = "dp", mxu_bf16: bool = False
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Top-k over row-sharded vectors.

    vectors: (N, D) host rows (split here) or shard_vectors' blocks;
    query: (D,) or (Q, D); mask: optional (N,) {0,1} prefilter.
    Returns numpy (scores, GLOBAL rows) of the top min(k, N): shape
    (k,) for one query, (Q, k) for a batch."""
    blocks = vectors if isinstance(vectors, (list, tuple)) \
        else shard_vectors(mesh, vectors, axis)
    one = np.ndim(query) == 1
    s, i = local_candidates(blocks, query, k, mask, mxu_bf16=mxu_bf16)
    s, i = s.cpu().numpy(), i.cpu().numpy()
    return (s[0], i[0]) if one else (s, i)


class PodSearch:
    """End-to-end sharded search over per-host store lanes.

    Every worker runs this with its OWN host-local store: its (nslots,
    dim) lane, zero-padded to the mesh tile, becomes this host's blocks
    of one global row-sharded matrix (global row g lives on host
    g // local_pad at slot g % local_pad; every host pads to the same
    local_pad, validated at init).  search() merges this host's
    shards' candidates on its devices, then the hosts' candidate lists
    meet in one gloo all-gather (parallel/multihost), and the owners of
    the winning rows contribute their key bytes in another.

    Staging is epoch-diffed: a refresh with no store writes touches no
    device data; updates scatter only the changed rows into their
    shard's block.  With several processes the hosts all-gather their
    per-shard dirty counts and agree on the shared bucket (_bucket), so
    the choice between a scatter and a full restage is the same on
    every host.  One process splits its one lane over its mesh's
    `axis`."""

    def __init__(self, store, mesh: Mesh | None = None, *,
                 axis: str = "dp", device: str = "cuda"):
        from .multihost import init_distributed, process_span

        init_distributed()
        self.store = store
        self.axis = axis
        self.mesh = mesh or make_mesh(device=device)
        self.devices = self.mesh.axis_devices(axis)
        self.pid, self.pcount = process_span()
        self.local_n = store.nslots
        self.per_host_shards = len(self.devices)
        # pad each host's block with zero rows to the shard tile; zero
        # vectors are never candidates (the kernels' row-norm exclusion)
        self.local_pad = -(-self.local_n // self.per_host_shards) * \
            self.per_host_shards
        self.tile = self.local_pad // self.per_host_shards
        self.global_n = self.local_pad * self.pcount
        if self.pcount > 1:
            geo = _allgather(np.array([self.local_n, self.local_pad,
                                       store.vec_dim], np.int64))
            if not (geo == geo[0]).all():
                raise ValueError(
                    "PodSearch requires identical store geometry on "
                    "every worker; got per-host (nslots, local_pad, "
                    f"vec_dim) = {geo.tolist()}")
        self._blocks: list[torch.Tensor] | None = None
        self._staged: np.ndarray | None = None   # epochs rows staged at
        # transfer accounting (tests + perf docs)
        self.full_stages = 0
        self.rows_staged = 0

    # -- staging -----------------------------------------------------------

    def _gather_local(self):
        """Full torn-safe local lane, zero-padded to local_pad rows.
        Rows mid-write stage as zeros this pass (never candidates) and
        re-stage next refresh via their unchanged staged epoch."""
        rows = np.arange(self.local_n, dtype=np.uint32)
        vecs, eps = self.store.vec_gather(rows)
        torn = eps == self.store.GATHER_TORN
        vecs[torn] = 0.0
        staged = np.where(torn, np.uint64(1), eps)   # odd = restage
        if self.local_pad != self.local_n:
            vecs = np.pad(vecs,
                          ((0, self.local_pad - self.local_n), (0, 0)))
        return vecs, staged

    def _place(self, local: np.ndarray) -> list[torch.Tensor]:
        t = self.tile
        return [torch.from_numpy(local[i * t:(i + 1) * t]).to(d)
                .contiguous() for i, d in enumerate(self.devices)]

    def _full_stage(self):
        local, self._staged = self._gather_local()
        self._blocks = self._place(local)
        self.full_stages += 1

    def refresh(self) -> list[torch.Tensor]:
        """Bring this host's blocks up to date (epoch-diffed)."""
        if self._blocks is None:
            self._full_stage()
            return self._blocks
        e = self.store.epochs()
        changed = np.nonzero(e != self._staged)[0]
        if self.pcount > 1:
            # agree on the largest per-shard dirty count any host sees:
            # past the point where a padded scatter ships as many rows as
            # the lane holds, a full restage is cheaper, and every host
            # takes the same branch
            local_max = int(np.bincount(
                changed // self.tile,
                minlength=self.per_host_shards).max()) if changed.size \
                else 0
            maxc = int(_allgather(np.array([local_max], np.int64)).max())
            if maxc == 0:
                return self._blocks
            if _bucket(maxc) * self.per_host_shards >= self.local_pad:
                self._full_stage()
                return self._blocks
        if changed.size:
            vecs, eps = self.store.vec_gather(changed.astype(np.uint32))
            torn = eps == self.store.GATHER_TORN
            if self.pcount > 1:
                # the collective path stages torn rows as zeros with an
                # odd epoch (never candidates, retried next refresh)
                vecs[torn] = 0.0
                eps = np.where(torn, np.uint64(1), eps)
                ok = np.ones_like(torn)
            else:
                ok = ~torn
            rows = changed[ok]
            if rows.size:
                self._scatter(rows, vecs[ok])
                # marked staged only AFTER the scatter: an exception
                # above leaves them dirty for the next refresh
                self._staged[rows] = eps[ok]
                self.rows_staged += int(rows.size)
        return self._blocks

    def _scatter(self, rows: np.ndarray, vecs: np.ndarray) -> None:
        shard, off = rows // self.tile, rows % self.tile
        for b, block in enumerate(self._blocks):
            sel = shard == b
            if sel.any():
                block[torch.from_numpy(off[sel]).to(block.device)] = \
                    torch.from_numpy(vecs[sel]).to(block.device)

    # -- query -------------------------------------------------------------

    def search(self, query, k: int, *, mask=None, refresh: bool = True,
               mxu_bf16: bool = False) -> list[dict]:
        """Global top-k.  Returns [{host, slot, key, similarity}, ...]
        sorted by similarity desc.  mask: optional per-host (nslots,)
        {0,1} candidate prefilter (bloom/regex/scratch exclusion),
        applied on this host's rows.  Must be called collectively (same
        query, same k on every worker)."""
        if refresh or self._blocks is None:
            self.refresh()
        lm = None
        if mask is not None:
            lm = np.zeros(self.local_pad, np.float32)
            lm[: self.local_n] = np.asarray(mask, np.float32)
        s, gi = local_candidates(self._blocks, np.asarray(query, np.float32),
                                 k, lm, offset=self.pid * self.local_pad,
                                 mxu_bf16=mxu_bf16)
        s, gi = s[0].cpu().numpy(), gi[0].cpu().numpy()
        if self.pcount > 1:
            # every host's merged list, in host order, then one merge
            both = _allgather(np.stack([s.astype(np.float64),
                                        gi.astype(np.float64)]))
            ms, mi = _merge(torch.from_numpy(both[:, 0].reshape(1, -1)),
                            torch.from_numpy(
                                both[:, 1].reshape(1, -1).astype(np.int64)),
                            min(k, self.global_n))
            s, gi = ms[0].numpy().astype(np.float32), mi[0].numpy()
        keep = s > -1e29
        s, gi = s[keep], gi[keep]
        keys = self._resolve_keys(gi)
        return [{"host": int(g) // self.local_pad,
                 "slot": int(g) % self.local_pad,
                 "key": key, "similarity": float(score)}
                for score, g, key in zip(s, gi, keys)]

    def _resolve_keys(self, global_rows: np.ndarray) -> list[str]:
        """Owner hosts contribute key bytes; one all-gather merges."""
        from .. import _native as N
        kmax = N.KEY_MAX
        mine = np.zeros((len(global_rows), kmax), np.uint8)
        for j, g in enumerate(np.asarray(global_rows)):
            host = int(g) // self.local_pad
            slot = int(g) % self.local_pad
            if host == self.pid and slot < self.local_n:
                key = self.store.key_at(slot) or ""
                raw = key.encode()[:kmax]
                mine[j, :len(raw)] = np.frombuffer(raw, np.uint8)
        if self.pcount > 1:
            mine = _allgather(mine).max(axis=0)  # the owner's row is the
            # only nonzero one
        return [bytes(row[row != 0]).decode(errors="replace")
                for row in mine]


def _allgather(arr: np.ndarray) -> np.ndarray:
    """(processes, *arr.shape): every process's `arr` over the gloo
    group (host-side control data only)."""
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _bucket(n: int) -> int:
    """Shared pad bucket: few distinct sizes -> few compiled programs."""
    b = 8
    while b < n:
        b *= 8
    return b
