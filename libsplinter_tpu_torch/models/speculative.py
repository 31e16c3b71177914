"""Speculative decoding (PyTorch, on the card): a draft decoder
proposes, the target verifies — the counterpart of the JAX package's
models/speculative.py.

A cheap draft runs gamma autoregressive steps, then the target scores
all gamma+1 positions in ONE forward, and the standard rejection rule
keeps the target's exact distribution:

  accept draft token x_i with prob min(1, p_t(x_i) / p_d(x_i));
  at the first rejection resample from normalize(max(p_t - p_d, 0));
  if all gamma are accepted, draw one bonus token from the target's
  last-position distribution.

Greedy (temp <= 0) degenerates to: accept while the draft token equals
the target's argmax, so greedy speculative output is the target's own
greedy output token for token.  Sampled tokens draw from a
``torch.Generator`` (seeded ``seed + 17``) where the JAX package splits
a threefry key, so only greedy runs can match it.

SELF-DRAFTING (``self_draft_model``): the draft is the target's own
first k layers plus its embedding, final norm and LM head, the very
module objects (no parameter is copied).  A sharded target's draft is
a ShardedCompletionModel over the same mesh whose shard modules are
such views of the target's shards.

Two lanes:

  - serial (``generate_tokens``): one step over the dense caches runs
    the gamma draft steps, the extra d_gamma ingest that closes the
    all-accept K/V hole, one target forward over [tok, d_1..d_gamma],
    the acceptance and the residual or bonus draw; positions park at
    the accepted end;
  - paged (the surface ``run_continuous`` drives: ``init_paged``,
    ``paged_prefill_row``, ``paged_decode_chunk(_async)``,
    ``warmup_paged``): target and draft each own a block pool of the
    same page geometry (``SpecPagedCache``), and one batched step runs
    the gamma draft steps through the paged forward (K5 at S = 1), the
    ingest, ONE target forward over the (B, gamma+1) stack — K5's
    multi-query form, token t attending keys j < length + t — and a
    vectorised acceptance and resample on the device.  The host reads
    (out (B, gamma+1), n_valid (B,)) once per step.  Rejected and
    frozen rows leave stale K/V in their pages that the next append
    overwrites (lengths advance only past accepted history); a per-row
    FIFO adapts the ragged yield to the daemon's fixed chunk cadence,
    and a row at its window edge or pool margin makes the step a plain
    paged step for the whole batch.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F

from ..obs.devtime import DEVTIME
from .decoder import CompletionModel, Decoder, _host, _nucleus_logits


def _filtered_probs(logits, top_p: float, temp: float):
    """The sampler chain's categorical distribution over the last axis
    (the decoder's sampler draws from exactly this: both read
    _nucleus_logits).  temp <= 0 is greedy: a one-hot at the argmax."""
    if temp <= 0:
        return F.one_hot(torch.argmax(logits, dim=-1),
                         logits.shape[-1]).to(torch.float32)
    order, masked = _nucleus_logits(logits, top_p, temp)
    p_sorted = torch.softmax(masked, dim=-1)
    return torch.zeros_like(p_sorted).scatter(-1, order, p_sorted)


def _draw(generator, probs, temp: float):
    """(..., V) distributions -> (...) int64 ids: the argmax when greedy
    (the distributions are one-hot), otherwise a Gumbel-max draw over
    log p with uniforms from `generator`."""
    if temp <= 0:
        return torch.argmax(probs, dim=-1)
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(torch.log(probs.clamp_min(1e-30)) + gumbel, dim=-1)


def _accept(generator, dtoks, dprobs, tprobs, temp: float):
    """The rejection rule for a batch of rows, all on the device.
    dtoks (B, g) proposals, dprobs (B, g, V) the draft distributions
    they were drawn from, tprobs (B, g+1, V) the target's over
    [tok, d_1..d_g].  The uniforms are drawn up front; the first
    rejection sticks through a cumulative product.  Returns out
    (B, g+1) — the accepted proposals, then the resampled (or bonus)
    token, then zeros — and n_valid (B,) = accepted + 1."""
    b, g = dtoks.shape
    u = torch.rand((b, g), generator=generator, device=dtoks.device)
    x = dtoks[..., None]
    ratio = (tprobs[:, :g].gather(-1, x)[..., 0]
             / dprobs.gather(-1, x)[..., 0].clamp_min(1e-30))
    ok = u < ratio.clamp(max=1.0)
    n_acc = torch.cumprod(ok.long(), dim=1).sum(dim=1)          # (B,)
    at = n_acc[:, None, None].expand(b, 1, tprobs.shape[-1])
    tp_n = tprobs.gather(1, at)[:, 0]
    dp_n = torch.where((n_acc < g)[:, None],
                       dprobs.gather(1, at.clamp(max=g - 1))[:, 0], 0.0)
    resid = (tp_n - dp_n).clamp_min(0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    dist = torch.where(rs > 1e-30, resid / rs.clamp_min(1e-30), tp_n)
    final = _draw(generator, dist, temp)
    idx = torch.arange(g + 1, device=dtoks.device)[None]
    out = torch.where(idx < n_acc[:, None], F.pad(dtoks, (0, 1)), 0)
    out = torch.where(idx == n_acc[:, None], final[:, None], out)
    return out, n_acc + 1


class _ReadySpecChunk:
    """A resolved paged-spec chunk wearing the PendingChunk contract
    (models/decoder.py): the wrapper computes synchronously, so block()
    is a no-op fetch, and `last` hands the final column to the daemon's
    carry protocol (which the wrapper supersedes with its own per-row
    input state)."""

    __slots__ = ("_block", "last", "n")

    def __init__(self, block: np.ndarray):
        self._block = block
        self.last = block[:, -1].copy()
        self.n = block.shape[1]

    def is_ready(self) -> bool:
        return True

    def block(self) -> np.ndarray:
        return self._block


def _layer_view(mod: Decoder, layers: int) -> Decoder:
    """A Decoder holding `mod`'s tok_emb, ln_out, lm_head and first
    `layers` layer modules (the objects themselves), built on the meta
    device so it allocates nothing."""
    with torch.device("meta"):
        view = Decoder(dataclasses.replace(mod.cfg, layers=layers))
    for name in ("tok_emb", "ln_out", "lm_head"):
        setattr(view, name, getattr(mod, name))
    for i in range(layers):
        setattr(view, f"layer_{i}", getattr(mod, f"layer_{i}"))
    view.rot_cos, view.rot_sin = mod.rot_cos, mod.rot_sin
    return view


def self_draft_model(target: CompletionModel,
                     draft_layers: int) -> CompletionModel:
    """A draft that is the target's OWN first `draft_layers` layers:
    its trunk holds the target's tok_emb, ln_out, lm_head and
    layer_0..layer_{k-1} module objects (no parameter copied, no extra
    device memory beyond the draft's pools).  Works for float and
    int8-resident targets alike, and for a sharded target
    (parallel/serve.ShardedCompletionModel: the draft is one over the
    same mesh, each shard module a view of the target's); sampler
    settings copy from the target, so the acceptance rule divides by
    the right proposal distribution."""
    cfg = target.cfg
    if not 1 <= draft_layers < cfg.layers:
        raise ValueError(
            f"draft_layers {draft_layers} must be in [1, "
            f"{cfg.layers - 1}] (a full-depth draft is just the target)")
    mod = target.module
    mesh = getattr(target, "mesh", None)
    shards = list(getattr(mod, "shards", [mod])) if mesh is not None \
        else [mod]
    if any(type(m) is not Decoder or m.mlp_cls is not None
           for m in shards):
        raise ValueError(
            "self-drafting needs the plain Decoder trunk (layer_i "
            "modules slice cleanly); custom/MoE modules need their own "
            "draft checkpoint")
    dcfg = dataclasses.replace(cfg, layers=draft_layers)
    kw = dict(buckets=target.buckets, top_p=target.top_p,
              temp=target.temp, kv_dtype=target.kv_dtype,
              suffix_buckets=target.suffix_buckets)
    if mesh is None:
        return CompletionModel(dcfg, module=_layer_view(mod, draft_layers),
                               device=target.device, **kw)
    from ..parallel.serve import ShardedCompletionModel, ShardedDecoder
    view = ShardedDecoder(dcfg, [_layer_view(m, draft_layers)
                                 for m in shards], mesh)
    return ShardedCompletionModel(dcfg, mesh, module=view, **kw)


class SpecPagedCache:
    """Paired (target, draft) block pools for paged speculative
    serving: the completion daemon sees ONE cache with the PagedKVCache
    surface, and every scheduling operation (ensure / free_row / reset)
    mirrors onto both pools so their page tables stay in lockstep (same
    page geometry and pool size; the draft pool is shallower).
    `lengths` IS the target pool's array (token counts are identical by
    construction).

    pages_needed and ensure over-reserve by the spec step's overshoot:
    a step appends up to gamma+1 tokens of K/V past the accepted
    history, and the FIFO that adapts ragged acceptance to the daemon's
    chunk cadence can hold up to a chunk + gamma produced but
    undelivered tokens, so an admitted row never strands the pool
    mid-step."""

    # paired pools never attach a prefix cache (the daemon reads this)
    prefix_cache = None

    def __init__(self, target_cache, draft_cache, gamma: int):
        self.target = target_cache
        self.draft = draft_cache
        self.gamma = gamma
        self.fifo = [deque() for _ in range(target_cache.batch)]
        self.next_input = np.zeros((target_cache.batch,), np.int64)

    # -- the PagedKVCache surface the daemon schedules against ----------
    @property
    def batch(self) -> int:
        return self.target.batch

    @property
    def page(self) -> int:
        return self.target.page

    @property
    def lengths(self):
        return self.target.lengths

    @property
    def free_pages(self) -> int:
        return min(self.target.free_pages, self.draft.free_pages)

    @property
    def available_pages(self) -> int:
        # paired pools never attach a prefix cache: available == free
        return min(self.target.available_pages, self.draft.available_pages)

    @property
    def used_pages(self) -> int:
        return self.target.used_pages

    @property
    def quantized(self) -> bool:
        return self.target.quantized

    @property
    def kv_dtype(self) -> str:
        return self.target.kv_dtype

    @property
    def _margin(self) -> int:
        # stale verify appends (gamma+1) plus the FIFO's undelivered tail
        return 2 * (self.gamma + 1)

    def pages_needed(self, tokens: int) -> int:
        return self.target.pages_needed(
            min(int(tokens) + self._margin, self.target.cfg.max_len))

    def ensure(self, row: int, tokens: int) -> bool:
        # reserve the SAME margin pages_needed advertises: admission
        # checks pages_needed against the free pages and then calls
        # ensure, and reserving less would let a later admission take
        # the margin and strand this row's spec step mid-decode
        tokens = min(int(tokens) + self._margin, self.target.cfg.max_len)
        return (self.target.ensure(row, tokens)
                and self.draft.ensure(row, tokens))

    def free_row(self, row: int) -> None:
        self.target.free_row(row)
        self.draft.free_row(row)
        self.fifo[row].clear()
        self.next_input[row] = 0

    def reset(self) -> None:
        for r in range(self.batch):
            self.free_row(r)

    def live_tokens(self) -> int:
        return self.target.live_tokens()

    def device_mb(self) -> float:
        return round(self.target.device_mb() + self.draft.device_mb(), 3)


class SpeculativeCompletionModel:
    """generate_tokens-compatible front end over (target, draft), and a
    paged continuous-batching model (the CompletionModel paged surface)
    when both halves support it: the completion daemon's run_continuous
    drives this wrapper unchanged.

    Both models must share the tokenizer and vocab; sampler settings
    come from the TARGET (the proposal distribution must be the one the
    acceptance rule divides by)."""

    def __init__(self, target: CompletionModel, draft: CompletionModel,
                 *, gamma: int = 4, seed: int = 0):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target/draft vocab mismatch")
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        self.target = target
        self.draft = draft
        self.gamma = gamma
        self.cfg = target.cfg
        self._gen = torch.Generator(device=target.device)
        self._gen.manual_seed(seed + 17)
        self._shapes: set[tuple] = set()
        self._step_fn = DEVTIME.register("completer.spec_step", self._step)
        self._paged_step_fn = DEVTIME.register("completer.spec_paged_step",
                                               self._paged_step)
        self.stats_proposed = 0            # draft tokens proposed
        self.stats_accepted = 0            # proposals the target kept
        self.stats_verified = 0            # positions the target scored

    # -- the paged-serving contract (CompletionModel surface) -----------

    @property
    def paged_supported(self) -> bool:
        return (getattr(self.target, "paged_supported", False)
                and getattr(self.draft, "paged_supported", False))

    @property
    def buckets(self):
        return self.target.buckets

    def sample(self, logits) -> int:
        return self.target.sample(logits)

    def _fprobs(self, logits):
        return _filtered_probs(logits, self.target.top_p, self.target.temp)

    # -- the propose + verify + accept step ------------------------------

    @torch.no_grad()
    def _step(self, pos: int, tok, g: int):
        """One serial step over the dense caches at slot `pos`, `tok`
        (1,) the last sampled token: the draft feeds [tok, d_1..d_{g-1}]
        at slots pos.., ingests d_g at pos+g (no K/V hole after an
        all-accept), the target scores [tok, d_1..d_g] in one forward.
        Returns (g+2,) = out (g+1) then n_valid, on the device."""
        t, d = self.target, self.draft
        self._shapes.add(("spec_step", g))
        temp = t.temp
        cur, dtoks, dprobs = tok, [], []
        for i in range(g):
            logits = d.module(cur[:, None], d._cache, pos + i)
            p = self._fprobs(logits[:, 0])
            cur = _draw(self._gen, p, temp)
            dtoks.append(cur)
            dprobs.append(p)
        d.module(cur[:, None], d._cache, pos + g)
        dtoks = torch.stack(dtoks, dim=1)                          # (1, g)
        tlogits = t.module(torch.cat([tok[:, None], dtoks], dim=1),
                           t._cache, pos)
        out, n_valid = _accept(self._gen, dtoks, torch.stack(dprobs, dim=1),
                               self._fprobs(tlogits), temp)
        return torch.cat([out, n_valid[:, None]], dim=1)[0]

    @torch.no_grad()
    def _paged_step(self, t_cache, d_cache, t_tables, t_lengths, d_tables,
                    d_lengths, toks):
        """One batched step over the block pools: gamma draft steps
        through the paged forward (K5 at S = 1), the d_gamma ingest, ONE
        target forward over the (B, gamma+1) stack (K5's multi-query
        form), the acceptance and resample on the device.  Returns
        (B, gamma+2) = out (B, gamma+1) then n_valid."""
        g, temp = self.gamma, self.target.temp
        self._shapes.add(("spec_paged_step", g, t_cache.batch,
                          t_cache.kv_dtype))
        d_mod, d_layers = self.draft.module, d_cache.layers()
        cur, dlen, dtoks, dprobs = toks, d_lengths, [], []
        for _ in range(g):
            logits = d_mod(cur[:, None], d_layers, 0, lengths=dlen,
                           tables=d_tables)
            p = self._fprobs(logits[:, 0])
            cur = _draw(self._gen, p, temp)
            dtoks.append(cur)
            dprobs.append(p)
            dlen = dlen + 1
        d_mod(cur[:, None], d_layers, 0, lengths=dlen, tables=d_tables)
        dtoks = torch.stack(dtoks, dim=1)                          # (B, g)
        tlogits = self.target.module(
            torch.cat([toks[:, None], dtoks], dim=1), t_cache.layers(), 0,
            lengths=t_lengths, tables=t_tables)
        out, n_valid = _accept(self._gen, dtoks, torch.stack(dprobs, dim=1),
                               self._fprobs(tlogits), temp)
        return torch.cat([out, n_valid[:, None]], dim=1)

    # -- paged serving surface (run_continuous drives this) --------------

    def init_paged(self, batch: int, *, page: int = 128,
                   pool_pages: int | None = None,
                   kv_dtype: str | None = None) -> SpecPagedCache:
        """Paired pools of IDENTICAL page geometry (the draft's is
        shallower); kv_dtype threads to both, so int8/int4 pools and
        speculative decode compose."""
        t = self.target.init_paged(batch, page=page, pool_pages=pool_pages,
                                   kv_dtype=kv_dtype)
        d = self.draft.init_paged(batch, page=page, pool_pages=pool_pages,
                                  kv_dtype=kv_dtype)
        return SpecPagedCache(t, d, self.gamma)

    def paged_prefill_row(self, cache: SpecPagedCache, prompt_ids,
                          row: int):
        """Prefill the row into BOTH pools; returns the TARGET's
        last-token logits for sampling the first output token."""
        logits = self.target.paged_prefill_row(cache.target, prompt_ids,
                                               row)
        self.draft.paged_prefill_row(cache.draft, prompt_ids, row)
        cache.fifo[row].clear()
        return logits

    def _spec_step(self, cache: SpecPagedCache, col: np.ndarray):
        """Dispatch one batched spec step and read (out, n_valid) back
        in one copy.  Host bookkeeping (lengths, FIFO, stats) is the
        caller's: it knows which rows consume the step."""
        h2d = self.target._h2d
        t, d = cache.target, cache.draft
        res = self._paged_step_fn(t, d, h2d(t.tables), h2d(t.lengths),
                                  h2d(d.tables), h2d(d.lengths),
                                  h2d(col.astype(np.int64)))
        host = _host(res, "completer.spec_paged_step")
        return host[:, :-1], host[:, -1]

    def _plain_step(self, cache: SpecPagedCache, col: np.ndarray,
                    freeze: list[int]):
        """One NON-speculative paged step on both pools (same input
        column; the draft's sample is discarded, its K/V ingest is the
        point, so the draft pool never grows holes).  Rows in `freeze`
        keep their lengths on both pools (their appends stale-rewrite,
        as a rejected proposal's do)."""
        t_before = cache.target.lengths.copy()
        d_before = cache.draft.lengths.copy()
        blk = self.target.paged_decode_chunk(cache.target, col, 1)
        self.draft.paged_decode_chunk(cache.draft, col, 1)
        for r in freeze:
            cache.target.lengths[r] = t_before[r]
            cache.draft.lengths[r] = d_before[r]
        return blk[:, 0]

    def paged_decode_chunk_async(self, cache: SpecPagedCache, tokens,
                                 n: int, carry=None):
        """The daemon's chunk contract — (batch, n) sampled ids per
        dispatch — served speculatively: spec steps run until every live
        row's FIFO holds n tokens, then the chunk pops exactly n per row
        (surplus carries to the next chunk).  Per iteration a row
        already sated discards its outputs (lengths frozen), and if any
        advancing row lacks window or page room for the gamma+1 stack
        the iteration is a plain paged step.  `tokens[r] >= 0` marks a
        freshly joined row (its prefill sample); the carry of the base
        model is subsumed by the wrapper's own per-row input state, so
        the returned chunk is already resolved."""
        bp = cache.batch
        toks = np.full((bp,), -1, np.int64)
        toks[: len(tokens)] = np.asarray(tokens).astype(np.int64)
        for r in range(bp):
            if toks[r] >= 0:           # freshly joined / host-fed row
                cache.next_input[r] = toks[r]
                cache.fifo[r].clear()

        def live_rows():
            return [r for r in range(bp) if cache.target.lengths[r] > 0]

        g = self.gamma
        rounds = 0
        while any(len(cache.fifo[r]) < n for r in live_rows()):
            rounds += 1
            if rounds > 4 * n + 8:     # each round adds >= 1 token to
                raise RuntimeError(    # every needy row: unreachable
                    "paged speculative chunk failed to converge")
            rows = live_rows()
            advance = [r for r in rows if len(cache.fifo[r]) < n]
            frozen = [r for r in rows if r not in advance]
            col = np.zeros((bp,), np.int64)
            col[rows] = cache.next_input[rows]
            # batch-wide: ONE infeasible advancing row (window edge,
            # pool margin) makes the whole iteration a plain step; the
            # daemon force-finishes rows within a chunk of their window
            # first, so only rows about to finish ever trip this
            spec_ok = all(
                int(cache.target.lengths[r]) + g + 1 <= self.cfg.max_len
                and cache.ensure(r, int(cache.target.lengths[r]) + g + 1)
                for r in advance)
            if spec_ok:
                out, n_valid = self._spec_step(cache, col)
                for r in advance:
                    nv = int(n_valid[r])
                    cache.fifo[r].extend(int(x) for x in out[r, :nv])
                    cache.next_input[r] = int(out[r, nv - 1])
                    cache.target.lengths[r] += nv
                    cache.draft.lengths[r] += nv
                    self.stats_proposed += g
                    self.stats_accepted += nv - 1
                    self.stats_verified += g + 1
                # frozen rows: outputs discarded, lengths untouched
            else:
                outc = self._plain_step(cache, col, frozen)
                for r in advance:
                    cache.fifo[r].append(int(outc[r]))
                    cache.next_input[r] = int(outc[r])

        block = np.zeros((bp, n), np.int32)
        for r in live_rows():
            for c in range(n):
                block[r, c] = cache.fifo[r].popleft()
        return _ReadySpecChunk(block)

    def paged_decode_chunk(self, cache: SpecPagedCache, tokens,
                           n: int) -> np.ndarray:
        return self.paged_decode_chunk_async(cache, tokens, n).block()

    def warmup_paged(self, cache: SpecPagedCache, chunk: int = 8,
                     max_prompt: int | None = None) -> None:
        """Run the whole spec-paged program set — both halves' prefill
        buckets, commit scatters and chunk steps (the plain fall-back)
        and one spec chunk through a real row — against the pool
        geometry run_continuous serves with; the drill's stats roll
        back so the acceptance gauges measure real traffic only."""
        with DEVTIME.warmup_phase():
            self.target.warmup_paged(cache.target, chunk=chunk,
                                     max_prompt=max_prompt)
            self.draft.warmup_paged(cache.draft, chunk=chunk,
                                    max_prompt=max_prompt)
            ones = np.ones((cache.batch,), np.int64)
            self.target.paged_decode_chunk(cache.target, ones, 1)
            self.draft.paged_decode_chunk(cache.draft, ones, 1)
            cache.target.reset()
            cache.draft.reset()
            stats = (self.stats_proposed, self.stats_accepted,
                     self.stats_verified)
            logits = self.paged_prefill_row(cache, np.ones((3,), np.int32),
                                            0)
            toks = np.full((cache.batch,), -1, np.int64)
            toks[0] = int(np.argmax(logits))
            self.paged_decode_chunk(cache, toks, max(1, chunk))
            cache.reset()
            (self.stats_proposed, self.stats_accepted,
             self.stats_verified) = stats

    def compile_count(self) -> int:
        """Distinct (program, shape) pairs across target, draft and the
        spec steps: the shape-leak signal the daemon pins flat after
        warmup."""
        return (self.target.compile_count() + self.draft.compile_count()
                + len(self._shapes))

    # -- generation surface -------------------------------------------------

    def reset(self) -> None:
        self.target.reset()
        self.draft.reset()

    def generate_tokens(self, prompt_ids: np.ndarray, max_new: int,
                        *, eos_id: int | None = None, chunk: int = 0):
        """Generator of sampled ids (the generate_tokens contract of
        models/decoder.py).  `chunk` is accepted for signature
        compatibility and ignored: the speculative step IS the chunk."""
        t, d = self.target, self.draft
        logits = t.prefill(np.asarray(prompt_ids, np.int32))
        d.prefill(np.asarray(prompt_ids, np.int32))
        tok = t.sample(logits)
        yield int(tok)
        if eos_id is not None and tok == eos_id:
            return
        produced = 1
        while produced < max_new:
            room = min(t.cfg.max_len - t._pos - 1,
                       d.cfg.max_len - d._pos - 1, max_new - produced)
            if room <= 0:
                break
            g = min(self.gamma, room)
            res = self._step_fn(t._pos, torch.tensor(
                [int(tok)], dtype=torch.int64, device=t.device), g)
            host = _host(res, "completer.spec_step")
            out, n_valid = host[:-1], int(host[-1])
            # both caches hold slots written beyond the accepted
            # history; parking the positions at the accepted end makes
            # them unreachable until overwritten
            t._pos += n_valid
            d._pos += n_valid
            self.stats_proposed += g
            self.stats_accepted += n_valid - 1
            self.stats_verified += g + 1
            for i in range(n_valid):
                tokn = int(out[i])
                yield tokn
                produced += 1
                if eos_id is not None and tokn == eos_id:
                    return
                if produced >= max_new:
                    return
            tok = int(out[n_valid - 1])

    def warmup(self, chunk: int = 8) -> None:
        """Run the prefill and step once (one short generation); `chunk`
        is accepted for surface compatibility with
        CompletionModel.warmup."""
        with DEVTIME.warmup_phase():
            n = min(8, self.cfg.max_len - self.gamma - 3)
            ids = np.ones((max(1, n),), np.int32)
            for _ in self.generate_tokens(ids, self.gamma + 1):
                pass
            self.reset()

    @property
    def acceptance_rate(self) -> float:
        return (self.stats_accepted / self.stats_proposed
                if self.stats_proposed else 0.0)
