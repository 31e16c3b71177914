"""Causal decoder LM (PyTorch) for the completion daemon — the dense
counterpart of the JAX package's flax decoder:

  - llama-family geometry: pre-norm RMSNorm, rotary positions, SwiGLU
    MLP, causal attention with grouped-query kv heads;
  - a static-shape KV cache of length ``max_len`` per layer, updated IN
    PLACE (a slice assign at the chunk's slots) where the JAX package
    threads a donated buffer through each program;
  - bfloat16 activations and projection weights on the card, RMSNorm
    statistics and scales in f32, an f32 LM head over the hidden cast
    to f32 (flax's ``Dense(dtype=float32)``);
  - the reference's sampler chain (top-p 0.9 -> temp 0.7 -> draw), with
    a ``torch.Generator`` in place of the threefry key: the two draw
    different numbers from the same seed, so only greedy decoding
    (temp <= 0) can match the JAX package token for token.

Prefill chunks at or above ``flash_min_seq`` attend through kernel K4
(ops/flash_attention.causal_flash_attention); shorter chunks and the
S = 1 decode steps through the plain masked softmax, as in the JAX
package.  The block-paged continuous lane (``PagedKVCache``, kernel K5)
is not ported yet: ``CompletionModel.paged_supported`` is False.

Weights load from a llama-family safetensors file (the port's own
reader), bridge from the JAX package's flax tree (``params_from_jax``),
or are seeded random draws from an explicit torch.Generator.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..obs.devtime import DEVTIME, close_mark
from ..ops.flash_attention import (causal_attention_plain,
                                  causal_flash_attention)
from ..utils.device import resolve_device
from .encoder import (_apply_rotary, _rotary_angles, read_safetensors,
                      state_dict_from_flax, write_safetensors)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    kv_heads: int = 12            # grouped-query attention when < heads
    mlp_dim: int = 2048
    max_len: int = 2048           # KV cache length = context window
    rope_base: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16   # activation dtype
    # prefill chunks at/above this width attend through kernel K4: long
    # prompts stop materialising (B, H, S, T) logits.  0 = off.
    flash_min_seq: int = 512

    @classmethod
    def tiny(cls, **kw) -> "DecoderConfig":
        """Small config for tests and CPU CI; kw overrides any field."""
        base = dict(vocab_size=1024, hidden=64, layers=2, heads=4,
                    kv_heads=2, mlp_dim=128, max_len=128)
        base.update(kw)
        return cls(**base)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def init_cache(cfg: DecoderConfig, batch: int, device=None):
    """Fresh zeroed KV cache: a list of (k, v) per layer, each
    (B, max_len, kv_heads, head_dim) in the activation dtype."""
    shape = (batch, cfg.max_len, cfg.kv_heads, cfg.head_dim)
    return [tuple(torch.zeros(shape, dtype=cfg.dtype, device=device)
                  for _ in range(2)) for _ in range(cfg.layers)]


class RMSNorm(nn.Module):
    """f32 statistics and f32 scale, output in the activation dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(self.dtype)


class CausalAttention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.head_dim
        self.q = nn.Linear(cfg.hidden, cfg.heads * d, bias=False)
        self.k = nn.Linear(cfg.hidden, cfg.kv_heads * d, bias=False)
        self.v = nn.Linear(cfg.hidden, cfg.kv_heads * d, bias=False)
        self.out = nn.Linear(cfg.heads * d, cfg.hidden, bias=False)

    def forward(self, x, cache_kv, pos: int, start, rotary):
        """x: (B, S, hidden), the chunk at cache slots pos..pos+S-1.
        cache_kv: (k, v) each (B, T, KH, D), written in place at those
        slots.  start: None, or (B,) left-pad offsets — row r's real
        tokens occupy slots start[r].., its rotary position at slot s is
        s - start[r], and slots below start[r] are masked.  rotary: the
        (T, D/2) cos/sin tables."""
        cfg = self.cfg
        b, s, _ = x.shape
        d = cfg.head_dim
        q = self.q(x).reshape(b, s, cfg.heads, d)
        k = self.k(x).reshape(b, s, cfg.kv_heads, d)
        v = self.v(x).reshape(b, s, cfg.kv_heads, d)
        cos_t, sin_t = rotary
        slots = pos + torch.arange(s, device=x.device)
        if start is None:
            cos, sin = cos_t[slots], sin_t[slots]            # (S, D/2)
        else:
            rp = torch.clamp(slots[None, :] - start[:, None], min=0)
            cos, sin = cos_t[rp], sin_t[rp]                  # (B, S, D/2)
        q = _apply_rotary(q, cos, sin)
        k = _apply_rotary(k, cos, sin)
        ck, cv = cache_kv
        ck[:, pos:pos + s] = k
        cv[:, pos:pos + s] = v
        if cfg.flash_min_seq and s >= cfg.flash_min_seq:
            # long-prompt prefill: kernel K4 over the unrepeated cache
            out = causal_flash_attention(q, ck, cv, pos, start)
        else:
            rep = cfg.heads // cfg.kv_heads
            kk = ck.repeat_interleave(rep, dim=2) if rep > 1 else ck
            vv = cv.repeat_interleave(rep, dim=2) if rep > 1 else cv
            if start is None:
                start = torch.zeros(b, dtype=torch.int32, device=x.device)
            out = causal_attention_plain(q, kk, vv, pos, start)
        return self.out(out.reshape(b, s, cfg.heads * d))


class DecoderLayer(nn.Module):
    """Pre-norm attention + SwiGLU MLP; the gate/up/down projections sit
    directly under the layer, as in the flax tree."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.attn = CausalAttention(cfg)
        self.ln_attn = RMSNorm(cfg.hidden, cfg.rms_eps, cfg.dtype)
        self.ln_mlp = RMSNorm(cfg.hidden, cfg.rms_eps, cfg.dtype)
        self.gate = nn.Linear(cfg.hidden, cfg.mlp_dim, bias=False)
        self.up = nn.Linear(cfg.hidden, cfg.mlp_dim, bias=False)
        self.down = nn.Linear(cfg.mlp_dim, cfg.hidden, bias=False)

    def forward(self, x, cache_kv, pos, start, rotary):
        x = x + self.attn(self.ln_attn(x), cache_kv, pos, start, rotary)
        h = self.ln_mlp(x)
        return x + self.down(F.silu(self.gate(h)) * self.up(h))


class Decoder(nn.Module):
    """Causal LM over a static KV cache; one forward serves prefill
    (S = bucket) and decode (S = 1).  Submodule names mirror the flax
    tree (tok_emb, layer_<i>.{attn.{q,k,v,out},ln_attn,ln_mlp,gate,up,
    down}, ln_out, lm_head), so params_from_jax maps leaf by leaf."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_emb = nn.Embedding(cfg.vocab_size, cfg.hidden)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg))
        self.ln_out = RMSNorm(cfg.hidden, cfg.rms_eps, cfg.dtype)
        self.lm_head = nn.Linear(cfg.hidden, cfg.vocab_size, bias=False)
        cos, sin = _rotary_angles(cfg.max_len, cfg.head_dim,
                                  self.lm_head.weight.device, cfg.rope_base)
        self.register_buffer("rot_cos", cos, persistent=False)
        self.register_buffer("rot_sin", sin, persistent=False)

    def layer_modules(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.layers)]

    def forward(self, token_ids, cache, pos: int, start=None, *,
                last: int | None = None):
        """token_ids: (B, S) int; cache: list of per-layer (k, v),
        updated in place; pos: cache slot of token_ids[:, 0]; start:
        optional (B,) left-pad offsets.  Returns (B, S, V) float32
        logits — or (B, 1, V) at chunk position `last` only, which is
        all a prefill samples from (the LM head is row-wise)."""
        if pos + token_ids.shape[1] > self.cfg.max_len:
            raise ValueError(f"slots {pos}..{pos + token_ids.shape[1] - 1} "
                             f"exceed the {self.cfg.max_len}-slot cache")
        x = self.tok_emb(token_ids)
        rotary = (self.rot_cos, self.rot_sin)
        for layer, kv in zip(self.layer_modules(), cache):
            x = layer(x, kv, pos, start, rotary)
        x = self.ln_out(x)
        if last is not None:
            x = x[:, last:last + 1]
        return self.lm_head(x.float())


@torch.no_grad()
def init_params(module: Decoder, generator: torch.Generator) -> None:
    """Seeded random init drawn from `generator`: Dense kernels
    normal(0, 1/fan_in) variance, embeddings normal(0, 1/hidden)
    variance, RMSNorm scales at 1."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features),
                             generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                             generator=generator)
        elif isinstance(m, RMSNorm):
            m.weight.fill_(1.0)


def params_from_jax(flax_params, cfg: DecoderConfig) -> dict:
    """The weight bridge: a flax decoder tree -> this Decoder's
    state_dict (every flax leaf has a module twin of the same path)."""
    return state_dict_from_flax(flax_params)


# ---------------------------------------------------------------- sampling

def _nucleus_logits(logits, top_p: float, temp: float):
    """The sampler chain's filter over the last axis: descending order
    (stable, ties to the lower id), temperature, and the top-p nucleus
    (always keeps the top token).  Returns (order, masked sorted
    logits), the rest at -inf."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order) / temp
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    return order, sorted_logits.masked_fill(~keep, -math.inf)


def _sample_rows(generator, logits, top_p: float, temp: float):
    """Per-row sampling shared by every path (prefill tail and the chunk
    loop): logits (B, V) -> (B,) int64 ids, on the logits' device.
    temp <= 0 is greedy (first max on ties); otherwise a Gumbel-max draw
    from the nucleus with uniforms from `generator`."""
    if temp <= 0:
        return torch.argmax(logits, dim=-1)
    order, masked = _nucleus_logits(logits, top_p, temp)
    u = torch.rand(masked.shape, generator=generator, device=masked.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    choice = torch.argmax(masked + gumbel, dim=-1, keepdim=True)
    return torch.gather(order, -1, choice)[:, 0]


def sample_top_p(generator, logits, *, top_p: float = 0.9,
                 temp: float = 0.7) -> int:
    """The reference's sampler chain on one (V,) logits row."""
    return int(_sample_rows(generator, logits[None], top_p, temp)[0])


def sample_top_p_batch(generator, logits, *, top_p: float = 0.9,
                       temp: float = 0.7):
    """(B, V) logits -> (B,) ids in one pass."""
    return _sample_rows(generator, logits, top_p, temp)


# ------------------------------------------------------------- front end

def _host(t: torch.Tensor, program: str) -> np.ndarray:
    """One device->host copy, then close the program's device window
    (the copy waited for it)."""
    host = t.cpu().numpy()
    close_mark(DEVTIME.take_mark(program))
    return host


class CompletionModel:
    """Bucketed prefill + token-at-a-time decode with a persistent cache
    on one device.

    The generation surface the completion daemon drives:
        logits = model.prefill(prompt_ids)
        tok = model.sample(logits)
        while ...: logits = model.decode_one(tok); tok = model.sample(...)
    and the batched one: prefill_batch / decode_chunk_batch /
    generate_batch over left-padded rows.  The cache stays on the device
    between calls; the host sees the sampled ids once per chunk.
    """

    # the block-paged continuous lane (kernel K5) is not ported yet
    paged_supported = False

    def __init__(self, cfg: DecoderConfig, *, seed: int = 0,
                 buckets: tuple[int, ...] = (64, 128, 256, 512, 1024),
                 params: dict | None = None, weights: str | None = None,
                 top_p: float = 0.9, temp: float = 0.7, device=None):
        """params: a Decoder state_dict (e.g. from params_from_jax);
        weights: a .safetensors checkpoint path.  device: "cuda"
        (default) or "cpu"."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.buckets = tuple(b for b in buckets if b <= cfg.max_len)
        if not self.buckets or self.buckets[-1] < cfg.max_len:
            # a prompt longer than the largest bucket (but inside the
            # window) must still have a shape to land in
            self.buckets = self.buckets + (cfg.max_len,)
        self.top_p, self.temp = top_p, temp
        if params is None and weights is not None:
            if weights.endswith(".gguf"):
                raise NotImplementedError(
                    "GGUF checkpoints are not yet ported to the torch "
                    "package; convert to .safetensors")
            params = load_safetensors_params(weights, cfg)
        with torch.device(self.device):
            module = Decoder(cfg)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            init_params(module, gen)
        else:
            module.load_state_dict(params)
        # projections and the embedding table in the activation dtype;
        # the norms and the LM head stay f32 (flax's param/compute dtypes)
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)) \
                    and m is not module.lm_head:
                m.to(cfg.dtype)
        self.module = module.eval().requires_grad_(False)
        self._fn = DEVTIME.register("completer.trunk", self._forward)
        self._chunk_fn = DEVTIME.register("completer.chunk", self._chunk)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed + 1)
        self._cache = None
        self._pos = 0
        self._start = None            # (B,) left-pad offsets when batched
        self._batch = 0
        self._shapes: set[tuple] = set()

    def bucket_for(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        return self.buckets[-1]

    def reset(self) -> None:
        """llama_memory_clear analog (splainference.cpp:378)."""
        self._cache = None
        self._pos = 0
        self._start = None
        self._batch = 0

    @property
    def pos(self) -> int:
        return self._pos

    def compile_count(self) -> int:
        """Distinct (program, shape) pairs run — PyTorch has no jit
        cache, so this is the shape-leak signal: a count still growing
        after warmup means some serving geometry escapes the bucket
        set."""
        return len(self._shapes)

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

    @torch.no_grad()
    def _forward(self, ids, cache, pos: int, start=None, last=None):
        self._shapes.add(("trunk", *ids.shape))
        return self.module(ids, cache, pos, start, last=last)

    def prefill(self, prompt_ids: np.ndarray) -> np.ndarray:
        """prompt_ids: (P,) int, 0 < P < max_len.  Pads to a bucket, runs
        one prefill, returns the last real token's logits (V,) f32."""
        n = len(prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if n >= self.cfg.max_len:
            raise ValueError("prompt exceeds context window")
        b = self.bucket_for(n)
        ids = np.zeros((1, b), np.int64)
        ids[0, :n] = prompt_ids
        # slots n..b-1 hold pad-token K/V, but a query at slot p attends
        # only j <= p, and every slot <= p is rewritten with real data
        # before the first query that could see it
        self._cache = init_cache(self.cfg, 1, self.device)
        logits = self._fn(self._ids(ids), self._cache, 0, last=n - 1)
        self._pos, self._start, self._batch = n, None, 1
        return _host(logits[0, 0], "completer.trunk")

    def decode_one(self, token: int) -> np.ndarray:
        """Append one token at the current position; returns logits (V,)."""
        if self._cache is None:
            raise RuntimeError("prefill first")
        if self._pos >= self.cfg.max_len:
            raise RuntimeError("context window full")
        ids = torch.full((1, 1), int(token), dtype=torch.int64,
                         device=self.device)
        logits = self._fn(ids, self._cache, self._pos)
        self._pos += 1
        return _host(logits[0, 0], "completer.trunk")

    def sample(self, logits: np.ndarray) -> int:
        return sample_top_p(self._gen, torch.from_numpy(logits).to(
            self.device), top_p=self.top_p, temp=self.temp)

    def sample_batch(self, logits: np.ndarray) -> np.ndarray:
        """(B, V) logits -> (B,) sampled ids."""
        ids = sample_top_p_batch(self._gen, torch.from_numpy(logits).to(
            self.device), top_p=self.top_p, temp=self.temp)
        return ids.cpu().numpy().astype(np.int32)

    # -- chunked decode (the tokens/sec path) -----------------------------

    @torch.no_grad()
    def _chunk(self, toks, n: int):
        """n decode steps for the (bp,) token column `toks` on the
        device: per step, forward one token per row at the next slot and
        sample the next in place (the same sampler as the prefill tail).
        Nothing reaches the host inside the loop; returns (bp, n) ids."""
        self._shapes.add(("chunk", n, toks.shape[0]))
        out = torch.empty((toks.shape[0], n), dtype=torch.int64,
                          device=self.device)
        for i in range(n):
            logits = self.module(toks[:, None], self._cache, self._pos + i,
                                 self._start)
            toks = _sample_rows(self._gen, logits[:, 0], self.top_p,
                                self.temp)
            out[:, i] = toks
        return out

    def decode_chunk(self, token: int, n: int) -> np.ndarray:
        """Append `token`, then decode and sample n tokens on the device
        with one host sync.  Returns the n sampled ids.  A mid-chunk EOG
        wastes at most n-1 speculative steps (their cache slots lie past
        the final position and are reset with the request)."""
        if self._cache is None:
            raise RuntimeError("prefill first")
        if self._pos + n > self.cfg.max_len:
            raise RuntimeError("context window full")
        toks = torch.tensor([int(token)], dtype=torch.int64,
                            device=self.device)
        out = self._chunk_fn(toks, n)
        self._pos += n
        return _host(out[0], "completer.chunk")

    def generate_tokens(self, prompt_ids: np.ndarray, max_new: int,
                        *, chunk: int = 8, eos_id: int | None = None):
        """Generator of sampled token ids: bucketed prefill, then
        chunk-at-a-time on-device decode (single-token steps near the
        window/budget tail).

        With eos_id=None the generator keeps yielding the chunk's
        SPECULATIVE tokens after an end-of-generation token — the
        consumer detects its own stop condition and breaks (the
        completion daemon does).  Pass eos_id to stop right after
        yielding that token."""
        logits = self.prefill(np.asarray(prompt_ids, np.int32))
        tok = self.sample(logits)
        yield int(tok)
        if eos_id is not None and tok == eos_id:
            return
        produced = 1
        while produced < max_new:
            room = min(self.cfg.max_len - self._pos, max_new - produced)
            if room <= 0:
                break
            if room < chunk:
                logits = self.decode_one(tok)
                tok = self.sample(logits)
                yield int(tok)
                if eos_id is not None and tok == eos_id:
                    return
                produced += 1
                continue
            toks = self.decode_chunk(tok, chunk)
            for t in toks:
                yield int(t)
                if eos_id is not None and int(t) == eos_id:
                    return
            tok = int(toks[-1])
            produced += chunk

    # -- batched generation (the aggregate-throughput path) ----------------
    #
    # Batched serving left-pads the prompts into one bucket so every
    # row's NEXT slot is uniform: row r's tokens occupy slots
    # [bucket - P_r, bucket) and decode proceeds at slot bucket,
    # bucket+1, ... for all rows at once — only the positions need the
    # per-row offsets (`start`).

    def prefill_batch(self, prompts: list[np.ndarray]) -> np.ndarray:
        """Left-padded batched prefill.  prompts: list of (P_i,) int,
        each 0 < P_i < max_len.  Returns the last real token's logits
        per row, (B, vocab) float32."""
        n_rows = len(prompts)
        if n_rows == 0:
            raise ValueError("empty batch")
        lens = [len(p) for p in prompts]
        if min(lens) == 0:
            raise ValueError("empty prompt")
        if max(lens) >= self.cfg.max_len:
            raise ValueError("prompt exceeds context window")
        b = self.bucket_for(max(lens))
        bp = 1 << max(n_rows - 1, 0).bit_length()   # batch power-of-two pad
        ids = np.zeros((bp, b), np.int64)
        start = np.full((bp,), b, np.int32)          # pad rows: no real slots
        for r, p in enumerate(prompts):
            ids[r, b - lens[r]:] = p
            start[r] = b - lens[r]
        self._cache = init_cache(self.cfg, bp, self.device)
        self._start = torch.from_numpy(start).to(self.device)
        # every row's last REAL token sits in the last slot (left pad)
        logits = self._fn(self._ids(ids), self._cache, 0, self._start,
                          last=b - 1)
        self._pos, self._batch = b, n_rows
        return _host(logits[:n_rows, 0], "completer.trunk")

    def decode_chunk_batch(self, tokens: np.ndarray, n: int) -> np.ndarray:
        """Append tokens (B,), decode+sample n steps on the device for
        the whole batch.  Returns (B, n) sampled ids.  Rows that already
        finished keep decoding speculatively — the caller discards."""
        if self._cache is None or self._start is None:
            raise RuntimeError("prefill_batch first")
        if self._pos + n > self.cfg.max_len:
            raise RuntimeError("context window full")
        toks = np.zeros((self._cache[0][0].shape[0],), np.int64)
        toks[: self._batch] = np.asarray(tokens, np.int64)
        out = self._chunk_fn(self._ids(toks), n)
        self._pos += n
        return _host(out[: self._batch], "completer.chunk")

    def join_row(self, prompt_ids: np.ndarray, row: int) -> np.ndarray:
        """Prefill `prompt_ids` into row `row` of the live batched cache,
        ending at the current decode position.  The prompt is clipped to
        the most recent tokens that fit the widest bucket at or below
        the position (a joiner cannot reach behind the batch's shared
        window).  Updates the row's start offset; returns its last-token
        logits (V,) for sampling its first output token."""
        if self._cache is None or self._start is None:
            raise RuntimeError("prefill_batch first")
        n = len(prompt_ids)
        if n == 0:
            raise ValueError("empty prompt")
        fit = [bb for bb in self.buckets if bb <= self._pos]
        b = next((bb for bb in fit if bb >= n), fit[-1])
        if n > b:
            prompt_ids = prompt_ids[-b:]      # keep recent context
            n = b
        ids = np.zeros((1, b), np.int64)
        ids[0, b - n:] = prompt_ids[-n:]
        start_row = torch.tensor([self._pos - n], dtype=torch.int32,
                                 device=self.device)
        # row views of the batch cache: the forward writes through them
        row_cache = [(k[row:row + 1], v[row:row + 1]) for k, v in self._cache]
        logits = self._fn(self._ids(ids), row_cache, self._pos - b,
                          start_row, last=b - 1)
        self._start[row] = self._pos - n
        return _host(logits[0, 0], "completer.trunk")

    def join_budget(self) -> int:
        """Largest prompt a joiner can bring into the live batch without
        losing context: the widest bucket at or below the current decode
        position."""
        if self._cache is None:
            return 0
        return max((b for b in self.buckets if b <= self._pos), default=0)

    def generate_batch(self, prompts: list[np.ndarray], max_new: int,
                       *, chunk: int = 8):
        """Generator over token COLUMNS for a batch of prompts: first the
        (B,) post-prefill samples, then one (B,) column per decoded
        step, chunk steps per host sync.  Rows past their stop
        condition yield speculative tokens — the consumer tracks per-row
        completion and discards (as generate_tokens with eos_id=None)."""
        logits = self.prefill_batch(prompts)
        toks = self.sample_batch(logits)
        yield toks.copy()
        produced = 1
        while produced < max_new:
            room = min(self.cfg.max_len - self._pos, max_new - produced)
            if room <= 0:
                break
            step = min(chunk, room)
            block = self.decode_chunk_batch(toks, step)   # (B, step)
            for c in range(step):
                yield block[:, c].copy()
            toks = block[:, -1].astype(np.int32)
            produced += step

    def warmup(self, chunk: int = 8, batch: int = 1) -> None:
        """Run every prefill bucket, decode-one and the chunked decode
        once off the serving path; batch > 1 also runs the batched
        shapes (prefill_batch per bucket + the batched chunk)."""
        with DEVTIME.warmup_phase():
            for b in self.buckets:
                self.prefill(np.ones((max(1, b - 1),), np.int32))
                self.decode_one(1)
            # the loop leaves the position at max_len, where no chunk
            # fits: re-prefill short so the chunk shape runs too
            self.reset()
            self.prefill(np.ones((max(1, self.buckets[0] - 1),), np.int32))
            if self._pos + chunk <= self.cfg.max_len:
                self.decode_chunk(1, chunk)
            self.reset()
            if batch > 1:
                chunk_done = False
                for b in self.buckets:
                    n = max(1, b - 1)
                    self.prefill_batch([np.ones((n,), np.int32)] * batch)
                    if not chunk_done and b + chunk <= self.cfg.max_len:
                        self.decode_chunk_batch(
                            np.ones((batch,), np.int32), chunk)
                        chunk_done = True
                    self.reset()


# ------------------------------------------------------ checkpoint loading

def _hf_names(cfg: DecoderConfig) -> dict[str, str]:
    """This Decoder's state_dict names -> HF llama-family tensor names
    (model.embed_tokens, model.layers.{i}.self_attn.{q,k,v,o}_proj,
    mlp.{gate,up,down}_proj, input/post_attention_layernorm,
    model.norm, lm_head).  Both sides keep Linear weights (out, in)."""
    names = {"tok_emb.weight": "model.embed_tokens.weight",
             "ln_out.weight": "model.norm.weight",
             "lm_head.weight": "lm_head.weight"}
    for i in range(cfg.layers):
        n, p = f"model.layers.{i}", f"layer_{i}"
        names[f"{p}.ln_attn.weight"] = f"{n}.input_layernorm.weight"
        names[f"{p}.ln_mlp.weight"] = f"{n}.post_attention_layernorm.weight"
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("out", "o_proj")):
            names[f"{p}.attn.{src}.weight"] = f"{n}.self_attn.{dst}.weight"
        for m in ("gate", "up", "down"):
            names[f"{p}.{m}.weight"] = f"{n}.mlp.{m}_proj.weight"
    return names


def load_safetensors_params(path: str, cfg: DecoderConfig) -> dict:
    """Map a HF llama-family safetensors checkpoint onto this Decoder's
    state_dict; the LM head ties to the embeddings when the file has
    none, and padded-vocab exports are cut to cfg.vocab_size."""
    tensors = read_safetensors(path)
    sd: dict[str, torch.Tensor] = {}
    for name, hf in _hf_names(cfg).items():
        if hf == "lm_head.weight" and hf not in tensors:
            hf = "model.embed_tokens.weight"        # tied embeddings
        if hf not in tensors:
            raise KeyError(f"checkpoint {path} lacks {hf}; present keys "
                           f"include {sorted(tensors)[:8]}...")
        arr = tensors[hf]
        if name in ("tok_emb.weight", "lm_head.weight"):
            if arr.shape[0] < cfg.vocab_size:
                raise ValueError(
                    f"checkpoint {hf} vocab {arr.shape[0]} < "
                    f"cfg.vocab_size {cfg.vocab_size}")
            arr = arr[:cfg.vocab_size]
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return sd


def export_safetensors_params(state_dict: dict, cfg: DecoderConfig,
                              path: str) -> None:
    """Inverse of load_safetensors_params (llama naming), in f32."""
    write_safetensors(path, {
        hf: state_dict[name].detach().float().cpu().numpy()
        for name, hf in _hf_names(cfg).items()})
