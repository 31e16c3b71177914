"""Streaming completion daemon (PyTorch, on the card) — the dense
lane of the JAX package's completer, and like it the replacement for
the reference's completion sidecar (splainference.cpp; SURVEY.md §2.2,
§3.3).  Clients write a prompt to a key, set the inference-waiting
label (0x1<<60) and bump; this daemon:

  - claims shard 0x5F1A at priority 200 and re-bids every 32 generated
    tokens (splainference.cpp:51-62,355-364);
  - wakes on its signal group, enumerates waiting keys
    (splainference.cpp:582-589);
  - per key: epoch-stable prompt read → fetches the system-prompt key
    FRESH each request (splainference.cpp:114-128,212-215) → renders a
    chat template with bare fallback (splainference.cpp:132-169) →
    flips WAITING→SERVICING + bump → overwrites the slot with the
    rendered prompt (splainference.cpp:266-269) → prefills the decoder
    → token loop sampling top-p 0.9 / temp 0.7, streaming pieces into
    the slot via append flushed at word boundaries or every 8 tokens
    (splainference.cpp:86,102-109,306-365) so readers watch val_len
    grow → truncates at max_val with an oom marker
    (splainference.cpp:336-344) → clears the KV cache, backfills ctime,
    flips SERVICING→READY + bump (splainference.cpp:378-392);
  - appends debug chatter to the shared __debug key
    (splainference.cpp:94-100);
  - cold-start: drains any pre-existing waiting keys
    (splainference.cpp:541-551).

Two lanes serve the same protocol.  run()/run_once() drain waiting
keys in batches of batch_cap through one left-padded decode each
(models/decoder.py generate_batch; prefill buckets of 512 tokens and
up attend through kernel K4), or one at a time for a custom
generate_fn.  run_continuous() is the block-paged lane (--continuous):
requests join and leave a live batch of 32 rows at chunk edges over a
PagedKVCache, a radix prefix cache (engine/prefix_cache.py) maps shared
prompt pages instead of re-prefilling them, and every decode step and
suffix prefill attends through kernel K5.  The label protocol, flush
cadence, truncation, ctime backfill and __debug lines are the JAX
daemon's, so torch and JAX daemons share one store.  ``main`` serves a
.gguf checkpoint from the file alone (geometry, tokenizer, chat
template, weights; a Mixtral-family file as the MoE decoder,
models/moe.py), int8-resident weights (--quantized, --weights-int8),
speculative decoding (--draft-layers, a self-draft that also serves the
continuous lane; --draft-weights, a .gguf draft; models/speculative.py)
with an acceptance floor that demotes to the plain target
(--spec-min-acceptance), a host-DRAM KV tier under the prefix cache
(--kv-tier-pages, its warm snapshots with --kv-tier-persist;
engine/kv_tier.py) and the disaggregated prefill/decode lanes (--phase;
engine/disagg.py subclasses this daemon through the _lane_* hooks
below).  Not ported yet: sharded serving (--tp, --ep) — ``main`` refuses
those flags instead of serving another way.
"""
from __future__ import annotations

import dataclasses
import errno
import itertools
import logging
import os
import time
from collections import deque
from typing import Callable, Iterator

import numpy as np

from .. import _native as N
from ..obs.devtime import DEVTIME
from ..obs.recorder import FlightRecorder
from ..obs.spans import SpanWriter
from ..ops._cuda import LAUNCHES
from ..store import Store
from ..utils import faults
from ..utils.faults import fault
from ..utils.trace import tracer
from . import protocol as P
from .qos import (AdmissionController, TenantLedger, WaitingRow,
                  parse_tenant_quotas, parse_tenant_weights,
                  prune_idle_counters)

log = logging.getLogger("libsplinter_tpu_torch.completer")

# A generator backend: (prompt_text) -> iterator of byte pieces.
GenerateFn = Callable[[str], Iterator[bytes]]

OOM_MARKER = b"\n[truncated: value buffer full]"


TEMPLATES = ("none", "chatml", "llama2", "llama3")


def render_prompt(user: str, system: str | None,
                  template: str = "chatml") -> str:
    """Chat-template render with bare fallback
    (splainference.cpp:132-169: llama_chat_apply_template else
    'system\\n\\nuser' concatenation).  Supported: chatml, llama2,
    llama3, none.  Unknown names raise — 'auto' must be resolved via
    detect_template() BEFORE construction, never silently rendered as
    some default dialect."""
    if template == "none" or not template:
        return f"{system}\n\n{user}" if system else user
    if template == "llama2":
        sys_block = f"<<SYS>>\n{system}\n<</SYS>>\n\n" if system else ""
        return f"<s>[INST] {sys_block}{user} [/INST]"
    if template == "llama3":
        out = ["<|begin_of_text|>"]
        if system:
            out.append("<|start_header_id|>system<|end_header_id|>\n\n"
                       f"{system}<|eot_id|>")
        out.append("<|start_header_id|>user<|end_header_id|>\n\n"
                   f"{user}<|eot_id|>")
        out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(out)
    if template == "chatml":
        out = []
        if system:
            out.append(f"<|im_start|>system\n{system}<|im_end|>\n")
        out.append(f"<|im_start|>user\n{user}<|im_end|>\n")
        out.append("<|im_start|>assistant\n")
        return "".join(out)
    raise ValueError(
        f"unknown chat template {template!r} (supported: "
        f"{', '.join(TEMPLATES)}; 'auto' resolves via detect_template)")


def detect_template(chat_template: str | None) -> str:
    """Map a checkpoint's embedded Jinja chat template (GGUF metadata
    tokenizer.chat_template) to the nearest built-in renderer — the
    analog of llama.cpp's template fingerprinting.  Unknown templates
    fall back to bare concatenation rather than guessing a wrong
    special-token dialect."""
    if not chat_template:
        return "none"
    if "<|im_start|>" in chat_template:
        return "chatml"
    if "<|start_header_id|>" in chat_template:
        return "llama3"
    if "[INST]" in chat_template:
        return "llama2"
    return "none"


@dataclasses.dataclass
class CompleterStats:
    wakes: int = 0
    completions: int = 0
    tokens: int = 0
    truncated: int = 0
    raced: int = 0
    vanished: int = 0                 # keys deleted mid-request
    faults: int = 0                   # per-key failures the firewall ate
    reclaimed: int = 0                # stranded SERVICING rows re-queued
    join_backpressure: int = 0        # admissions deferred: pool full
    # -- multi-tenant QoS (engine/qos.py) ----------------------------
    deadline_expired: int = 0         # fast-failed: deadline passed
    shed: int = 0                     # typed overloaded + retry hint
    deferred: int = 0                 # held for a later drain/chunk
    # -- the continuous lane: un-awaited decode chunks held while the
    # host emits/admits, and rows retired at a chunk edge because their
    # deadline passed mid-decode --------------------------------------
    inflight_peak: int = 0
    killed_mid_decode: int = 0
    # model failures the lane caught: live rows finalized with what they
    # had streamed and the pool rebuilt (abort_all), or an in-flight
    # chunk that failed to resolve at stop
    aborts: int = 0
    spec_demotions: int = 0           # speculative -> plain fallbacks


class Completer:
    """Drive with run() (blocking loop), run_once() (single drain), or
    process_key() directly.  A fake generate_fn substitutes for the
    decoder in tests."""

    LANE = "completer"
    HB_KEY = P.KEY_COMPLETE_STATS
    WATCH_BIT = P.BIT_INFER_REQ

    def __init__(self, store: Store, generate_fn: GenerateFn | None = None,
                 *, model=None, tokenizer=None,
                 max_new_tokens: int = 256,
                 flush_tokens: int = 8,
                 rebid_tokens: int = 32,
                 template: str = "chatml",
                 group: int = P.GROUP_INFER,
                 batch_cap: int | None = None,
                 page_size: int = 128,
                 pool_pages: int | None = None,
                 kv_dtype: str | None = None,
                 inflight_depth: int | None = None,
                 spec_min_acceptance: float = 0.2,
                 queue_high_water: int | None = None,
                 retry_after_ms: int | None = None,
                 tenant_weights: dict[int, float] | None = None,
                 prefix_cache: bool = True,
                 prefix_cache_pages: int | None = None,
                 prefix_quotas: dict[int, int] | None = None,
                 prefix_default_quota: int | None = None,
                 kv_tier_pages: int = 0,
                 kv_tier_persist: str | None = None,
                 replica: int = 0,
                 device=None):
        """model: a CompletionModel; when neither it nor generate_fn is
        given, a seeded-random one is built on `device` ("cuda" by
        default, or "cpu").  page_size, pool_pages, kv_dtype,
        inflight_depth, the prefix_* and the kv_tier_* arguments shape
        the continuous lane (run_continuous).  spec_min_acceptance: a
        speculative model whose rolling draft acceptance falls below it
        is demoted to its target (0 disables the floor)."""
        self.store = store
        # elastic lanes (protocol.StripeView): replica r drains only
        # its own slot-index stripe; stranded-SERVICING reclaim is
        # stripe-scoped too, so a restarted replica can never steal a
        # live peer's in-flight rows
        self.replica = int(replica)
        self.stripes = P.StripeView(store, self.LANE, self.replica)
        self._hb_key = P.replica_stats_key(self.HB_KEY, self.replica)
        self._trace_key = P.replica_stats_key(P.KEY_COMPLETE_TRACE,
                                              self.replica)
        self.max_new = max_new_tokens
        self.flush_tokens = flush_tokens
        self.rebid_tokens = rebid_tokens
        # per-lane defaults: a wider dense batch multiplies (B, max_len,
        # KH, D) cache memory, while the paged pool's memory scales with
        # live tokens; an explicit batch_cap applies to both lanes
        self.batch_cap = 8 if batch_cap is None else batch_cap
        self.paged_batch_cap = 32 if batch_cap is None else batch_cap
        self.page_size = page_size
        self.pool_pages = pool_pages
        # paged-pool storage (--kv-dtype): int8 halves the cache bytes
        # per token against bf16 (per-page scales, dequantized inside
        # K5), int4 packs two codes per byte (a quarter); None keeps the
        # model's activation dtype
        if kv_dtype not in (None, "bf16", "f32", "int8", "int4"):
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r} (bf16 | f32 | int8 | int4)")
        self.kv_dtype = kv_dtype
        # the continuous lane's chunk pipeline depth: dispatch chunk K,
        # then collect the OLDEST while the newest computes (the token
        # hand-off between chunks stays on the device); 1 = collect each
        # chunk before dispatching the next
        self.inflight_depth = (2 if inflight_depth is None
                               else max(1, inflight_depth))
        # speculative decoding's acceptance floor (_maybe_demote_spec):
        # (proposed, accepted) samples over the recent drains, and the
        # rolling rate that tripped the floor (kept for the heartbeat)
        self.spec_min_acceptance = spec_min_acceptance
        self._spec_hist: list[tuple[int, int]] = []
        self._spec_acceptance_rolling: float | None = None
        self._paged_cache = None
        # join-backpressure memo, idx -> (slot epoch, pages needed):
        # instance state so the heartbeat can publish its size and the
        # sweep can bound it
        self._bp_memo: dict[int, tuple[int, int]] = {}
        self._bp_memo_cap = 4096
        # cross-request prefix sharing over the paged pool, built with
        # the pool (engine/prefix_cache.py; plain PagedKVCache only: the
        # paired speculative pools don't share)
        self._prefix_enabled = bool(prefix_cache)
        self._prefix_cache_pages = prefix_cache_pages
        self._prefix_quotas = dict(prefix_quotas or {})
        self._prefix_default_quota = prefix_default_quota
        self.prefix_cache = None
        # pool-occupancy high-water marks (chunk edges + heartbeats)
        self._pages_used_peak = 0
        self._pool_mb_peak = 0.0
        # multi-tenant QoS (engine/qos.py): every drain orders the
        # waiting keys fairly across tenants (stride credit persists,
        # so a starved tenant leads the next cycle); queue_high_water
        # bounds the waiting backlog — overflow is claimed and
        # READY-flipped with a typed overloaded JSON value carrying
        # retry_after_ms.  Deadline fast-fail is always on for requests
        # carrying a deadline stamp.
        self.qos = AdmissionController(
            weights=tenant_weights, high_water=queue_high_water,
            **({"retry_after_ms": retry_after_ms}
               if retry_after_ms is not None else {}))
        # phase-aware deadline slack: a request whose deadline passes
        # before the lane's service phase even starts fast-fails NOW.
        # The prefill lane (engine/disagg.py) feeds it a rolling
        # prefill-wall EMA; 0.0 keeps the exact-expiry check.
        self.qos_slack_s = 0.0
        self.tenants = TenantLedger()
        self._had_deferred = False
        # the host-DRAM spill tier under the radix tree
        # (engine/kv_tier.py): evicted zero-ref pages demote to host RAM
        # instead of being dropped, and a hit on a demoted page readmits
        # it (a host->device copy + block-table write) instead of a
        # re-prefill.  kv_tier_persist names a file-backed store segment
        # the warm set checkpoints into, so a restart attaches WARM;
        # replica 0 writes the snapshots, every replica loads.
        self._tier_pages = max(0, int(kv_tier_pages))
        self._tier_persist_name = kv_tier_persist
        self.kv_tier = None
        self._tier_store = None
        self._tier_restore: tuple[int, str] = (0, "off")
        self._tier_last_save = 0.0
        # the disaggregated decode lane (engine/disagg.py): when set,
        # run_continuous's admission delegates to this callable —
        # ADOPTION of DECODE_READY handoffs instead of WAITING joins
        self._lane_admit = None
        if template not in TEMPLATES:
            raise ValueError(
                f"unknown chat template {template!r} (supported: "
                f"{', '.join(TEMPLATES)}; resolve 'auto' with "
                "detect_template first)")
        self.template = template
        self.group = group
        self.stats = CompleterStats()
        # flight recorder for the serial (process_key) path: clients
        # stamp infer requests exactly like embed ones
        # (protocol.stamp_trace); the batched path aggregates through
        # the span histograms only
        self.recorder = FlightRecorder()
        self.spans = SpanWriter(store, self.LANE)
        # pending spans between _prepare and _finalize, keyed by the
        # request key (every service path pairs the two); bounded by
        # in-flight work, with a hard cap against pathological leaks
        self._live_spans: dict[str, object] = {}
        self._trace_published = 0      # ring state last published
        self.generation = 0            # bumped at attach (restart marker)
        self._bid = -1
        self._running = False

        if generate_fn is not None:
            self.generate_fn = generate_fn
        else:
            if model is None:
                from ..models import CompletionModel, DecoderConfig
                # default vocab sized for the byte tokenizer (259 ids,
                # padded to 512); real checkpoints bring their own
                # matching cfg+tokenizer pair
                model = CompletionModel(DecoderConfig(vocab_size=512),
                                        device=device)
            if tokenizer is None:
                from ..models import ByteTokenizer
                tokenizer = ByteTokenizer()
            self._model = model
            self._tok = tokenizer
            self.generate_fn = self._model_generate

    # -- wiring ------------------------------------------------------------

    def attach(self) -> None:
        st = self.store
        try:
            self._bid = st.shard_claim(P.SHARD_COMPLETE, N.ADV_WILLNEED,
                                       P.PRIO_COMPLETE, 30_000_000)
        except OSError:
            self._bid = -1
        st.watch_label_register(self.WATCH_BIT, self.group)
        st.bus_attach()   # adopts the bus when a crashed owner
                          # left a dead pid in the header
        self.generation = P.bump_generation(st, self._hb_key)
        # compile events ledgered from here carry this generation —
        # a restart's re-warmup is distinguishable in the ring
        DEVTIME.generation = max(DEVTIME.generation, self.generation)
        self._reclaim_stranded()

    def _reclaim_stranded(self) -> int:
        """Crash recovery: a daemon that died mid-completion leaves
        its key in SERVICING — no label watch fires for it again, so
        without this it is wedged forever.  Each stripe has ONE owner
        (the supervisor's invariant, per-replica under elastic
        lanes), so at attach every SERVICING row in OUR stripes is a
        previous generation's stranded request: flip it back to
        WAITING and let the cold-start drain re-serve it (the client
        sees a restarted stream, same as the reference's crash
        story).  Rows outside our stripes belong to live peer
        replicas mid-service — never touched; a permanently-dead
        replica's rows are the supervisor's straggler reclaim.

        Known bound (mirrors Supervisor._reclaim_closed's): a live
        peer's claim that predates a re-stripe can sit in OUR
        current stripes and would be re-queued here as stranded —
        the window needs an in-flight request to span a stripe
        promotion AND our own crash+respawn; claim-owner stamping
        is the follow-up that would close it."""
        st = self.store
        self.stripes.refresh()
        n = 0
        for idx in st.enumerate_indices(P.LBL_SERVICING):
            if not self.stripes.owns(idx):
                continue
            key = st.key_at(idx)
            if key is None:
                continue
            try:
                st.label_clear(key, P.LBL_SERVICING)
                st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
                n += 1
            except (KeyError, OSError):
                continue
        if n:
            self.stats.reclaimed += n
            self._debug(f"reclaimed {n} stranded SERVICING requests")
        return n

    def _requeue_failed(self, idxs: list[int]) -> int:
        """Firewall tail for run_once: an exception escaping
        process_key/process_batch after _prepare flipped rows to
        SERVICING leaves them label-invisible — the sweep enumerates
        LBL_INFER_REQ and, with the daemon still alive, the attach()
        reclaim never runs.  Flip the failed batch's SERVICING rows
        back to WAITING so the next sweep re-serves them instead of
        wedging their clients until timeout."""
        st = self.store
        n = 0
        for idx in idxs:
            try:
                if not (st.labels_at(idx) & P.LBL_SERVICING):
                    continue
                key = st.key_at(idx)
                if key is None:
                    continue
                st.label_clear(key, P.LBL_SERVICING)
                st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
                n += 1
            except (KeyError, OSError):
                continue
        if n:
            self.stats.reclaimed += n
            self._debug(f"re-queued {n} SERVICING rows after a drain "
                        "fault")
        return n

    # -- multi-tenant QoS --------------------------------------------------

    def _qos_meta(self, idx: int) -> tuple[int, float | None]:
        """(tenant, deadline) for a waiting slot — tenant from the
        label word (free: one read), deadline from the companion stamp
        only when LBL_DEADLINE flags it."""
        st = self.store
        try:
            labels = st.labels_at(idx)
        except (KeyError, OSError):
            return 0, None
        deadline = None
        if labels & P.LBL_DEADLINE:
            try:
                deadline = P.read_deadline(st, idx,
                                           epoch=st.epoch_at(idx))
            except (KeyError, OSError):
                deadline = None
        return P.read_tenant(labels), deadline

    def _terminal_reject(self, idx: int, payload: bytes,
                         counter: str, tenant: int) -> bool:
        """Claim-and-reject a waiting request without spending a batch
        slot: the slot's value becomes the typed JSON payload
        (overloaded + retry_after_ms, or deadline_expired) and the
        label trifecta lands at READY — the client (engine/client.py)
        parses the record instead of burning its timeout."""
        st = self.store
        span = None
        try:
            if st.epoch_at(idx) & 1:
                return False          # writer active: next cycle
            labels = st.labels_at(idx)
            if not labels & P.LBL_INFER_REQ:
                return False          # recycled since enumeration
            key = st.key_at(idx)
            if key is None:
                return False
            if labels & P.LBL_TRACED:
                # the typed reject is this request's whole service:
                # open + commit its span around the claim (before the
                # payload write moves the epoch), then retire the
                # stamp the span protocol left in place
                span = self.spans.begin(idx, st.epoch_at(idx),
                                        tenant=tenant)
                P.consume_trace_stamp(st, idx)
            st.label_clear(key, P.LBL_INFER_REQ | P.LBL_WAITING)
            st.set(key, payload)
            st.label_or(key, P.LBL_READY)
            st.bump(key)
        except (KeyError, OSError):
            return False
        self.spans.commit(span, status=(
            P.ERR_DEADLINE if counter == "deadline_expired"
            else P.ERR_OVERLOADED))
        P.clear_deadline(st, idx)
        setattr(self.stats, counter,
                getattr(self.stats, counter) + 1)
        self.tenants.bump(tenant, counter)
        return True

    def _admit_waiting(self, idxs: list[int],
                       capacity: int) -> list[int]:
        """Order one cycle's waiting keys through the shared admission
        policy: expired deadlines reject fast, the fairness-ordered
        admit set (up to capacity) is returned for service, overflow
        past queue_high_water is shed with the typed overloaded
        record, the rest stay WAITING (their tenants lead the next
        cycle — stride state persists).  With no QoS config and no
        stamped rows this is a cheap pass-through."""
        if not idxs:
            return idxs
        rows: list[WaitingRow] = []
        tagged = False
        for idx in idxs:
            tenant, deadline = self._qos_meta(idx)
            tagged = tagged or tenant or deadline is not None
            rows.append(WaitingRow(idx, tenant, deadline))
        if not tagged and self.qos.high_water is None \
                and capacity >= len(idxs):
            self._had_deferred = False
            return idxs
        plan = self.qos.plan(rows, capacity, slack_s=self.qos_slack_s)
        for row in plan.expired:
            self._terminal_reject(row.item,
                                  P.DEADLINE_EXPIRED_DIAGNOSTIC,
                                  "deadline_expired", row.tenant)
        for row in plan.shed:
            self._terminal_reject(
                row.item,
                P.overloaded_payload(self.qos.retry_after_ms),
                "shed", row.tenant)
        self.stats.deferred += len(plan.deferred)
        self._had_deferred = bool(plan.deferred)
        return [row.item for row in plan.admit]

    def _sweep_bp_memo(self) -> int:
        """Bound the join-backpressure memo on the heartbeat cadence:
        evict entries whose slot epoch moved on or whose request label
        is gone, then enforce the hard cap (_bound_bp_memo)."""
        st = self.store
        dropped = 0
        for idx, (e, _need) in list(self._bp_memo.items()):
            try:
                if st.epoch_at(idx) != e or \
                        not st.labels_at(idx) & P.LBL_INFER_REQ:
                    del self._bp_memo[idx]
                    dropped += 1
            except (KeyError, OSError):
                self._bp_memo.pop(idx, None)
                dropped += 1
        return dropped + self._bound_bp_memo()

    def _bound_bp_memo(self) -> int:
        """The memo's hard size cap, evicting stale slot epochs first
        (a live entry is a denied request the memo keeps cheap), then in
        insertion order."""
        over = len(self._bp_memo) - self._bp_memo_cap
        if over <= 0:
            return 0
        st = self.store
        dropped = 0
        for idx, (e, _need) in list(self._bp_memo.items()):
            if dropped >= over:
                break
            try:
                stale = st.epoch_at(idx) != e
            except (KeyError, OSError):
                stale = True
            if stale:
                self._bp_memo.pop(idx, None)
                dropped += 1
        while len(self._bp_memo) > self._bp_memo_cap:
            self._bp_memo.pop(next(iter(self._bp_memo)))
            dropped += 1
        return dropped

    def _debug(self, msg: str) -> None:
        """Append to the shared debug log key
        (splainference.cpp:94-100)."""
        st = self.store
        try:
            if P.KEY_DEBUG not in st:
                st.set(P.KEY_DEBUG, b"")
                st.label_or(P.KEY_DEBUG, P.LBL_DEBUG)
            st.append(P.KEY_DEBUG, f"[{self.LANE}] {msg}\n")
        except OSError:
            pass                      # debug channel full: not an error

    # -- model backend -----------------------------------------------------

    def _clip_context(self, ids: list[int], *, bucketed: bool) -> list[int]:
        """Keep the most recent context that still leaves max_new decode
        slots in the window.  Serial prefill parks the decode position
        at the REAL prompt length, so its budget is raw
        (max_len - max_new - 1).  Batched prefill left-pads to a bucket
        and parks at the BUCKET width (models/decoder.py prefill_batch),
        so the batched budget must be the largest bucket that still
        fits — a raw budget would round up into the window and strand
        every row with ~zero decode room."""
        m = self._model
        if bucketed:
            budget = self._batched_budget()
            assert budget is not None, \
                "run_once must route to serial when no bucket fits"
        else:
            budget = m.cfg.max_len - self.max_new - 1
            if budget < 1:
                budget = m.cfg.max_len // 2
        return ids[-budget:] if len(ids) > budget else ids

    def _batched_budget(self) -> int | None:
        """Largest prompt budget the BATCHED path can serve: the widest
        padding bucket strictly inside the window (prefill_batch
        requires max(lens) < max_len and parks the decode position at
        the bucket width), preferring one that also leaves max_new
        decode slots.  None when every bucket is the window itself —
        batched prefill would have zero decode room, so run_once falls
        back to serial serving for that geometry."""
        m = self._model
        usable = [b for b in m.buckets if b < m.cfg.max_len]
        if not usable:
            return None
        fit = [b for b in usable if b + self.max_new <= m.cfg.max_len]
        return fit[-1] if fit else usable[-1]

    def _model_generate(self, prompt: str) -> Iterator[bytes]:
        m, tok = self._model, self._tok
        ids = self._clip_context(tok.encode(prompt), bucketed=False)
        try:
            # chunk-at-a-time on-device decode: the host syncs once per
            # flush_tokens tokens, not once per token (VERDICT r1
            # item 5; cadence from splainference.cpp:333-354)
            for t in m.generate_tokens(np.asarray(ids, np.int32),
                                       self.max_new,
                                       chunk=max(1, self.flush_tokens)):
                if t == tok.eos_id:
                    break
                yield tok.token_to_piece(t)
        finally:
            m.reset()                 # llama_memory_clear analog

    # -- the completion ----------------------------------------------------

    def _read_rendered(self, idx: int):
        """Guarded prompt read + fresh system-prompt fetch + template
        render — NO side effects, so callers can peek a request (e.g.
        to check it fits a live batch) without claiming it.  Returns
        (key, rendered) or None."""
        st = self.store
        e = st.epoch_at(idx)
        if e & 1:
            return None               # writer active: next wake
        if not st.labels_at(idx) & P.LBL_INFER_REQ:
            return None               # slot recycled since enumeration:
                                      # never service a key that didn't ask
        key = st.key_at(idx)
        if key is None:
            return None
        try:
            prompt = st.get_at(idx).rstrip(b"\0").decode(
                "utf-8", errors="replace")
        except Exception:
            return None
        if st.epoch_at(idx) != e:
            self.stats.raced += 1
            return None               # torn read: re-queued by next wake

        # system prompt fetched fresh each request
        system = None
        try:
            system = st.get(P.KEY_SYSTEM_PROMPT).decode(
                "utf-8", errors="replace")
        except KeyError:
            pass
        return key, render_prompt(prompt, system, self.template)

    def _prepare(self, idx: int, peek: tuple | None = None):
        """The per-key request head (splainference.cpp:190-269):
        _read_rendered plus the claim side effects — WAITING→SERVICING
        flip, slot overwrite with the rendered prompt.  A caller that
        already peeked passes its (key, rendered) to avoid re-reading.
        Returns (key, rendered, t0, stamp) or None; stamp is the
        request's consumed trace stamp (serial path records it, the
        batched/continuous paths aggregate via spans only — consuming
        HERE means no path can leave a stale stamp to corrupt a later
        request's flight record)."""
        fault("completer.render")
        st = self.store
        if peek is None:
            peek = self._read_rendered(idx)
        if peek is None:
            return None
        key, rendered = peek

        stamp = None
        if st.labels_at(idx) & P.LBL_TRACED:
            # span begin consumes the stamp (the unstaged consume-
            # early discipline — exactly the old consume semantics),
            # and the PendingSpan carries the context to _finalize.
            # Consumed even with tracing OFF; recorded only when on.
            span = self.spans.begin(idx, st.epoch_at(idx),
                                    tenant=P.read_tenant(
                                        st.labels_at(idx)))
            if span is not None:
                if len(self._live_spans) > 1024:
                    self._live_spans.clear()   # spans are best-effort
                self._live_spans[key] = span
                stamp = span.stamp if tracer.enabled else None

        # QoS accounting at the claim (the real admission moment):
        # tagged requests count per tenant, and a consumed deadline
        # stamp must not linger to misjudge a later slot occupant
        try:
            labels_now = st.labels_at(idx)
        except (KeyError, OSError):
            labels_now = 0
        if labels_now & (P.TENANT_MASK | P.LBL_DEADLINE):
            self.tenants.bump(P.read_tenant(labels_now), "admitted")
            if labels_now & P.LBL_DEADLINE:
                P.clear_deadline(st, idx)

        # WAITING → SERVICING, visible to watchers immediately
        st.label_clear(key, P.LBL_INFER_REQ | P.LBL_WAITING)
        st.label_or(key, P.LBL_SERVICING)
        st.bump(key)

        # slot now holds the rendered prompt; generation appends after it
        t0 = Store.now()
        data = rendered.encode("utf-8")
        try:
            st.set(key, data)
        except OSError:               # rendered prompt alone overflows —
            st.set(key, data[: st.max_val - 1])   # slice BYTES, not chars
        return key, rendered, t0, stamp

    def _finalize(self, key: str, t0: int, n_tok: int,
                  truncated: bool, vanished: bool = False,
                  stages: dict | None = None) -> None:
        """The per-key request tail: oom bookkeeping, ctime backfill
        with tick delta (splainference.cpp:282,383-387),
        SERVICING→READY flip.  A key deleted mid-request must fail
        alone — in a batch, a raising tail would strand the SIBLING
        rows in SERVICING forever — and is counted as vanished, not as
        a completion or a max_val truncation."""
        fault("completer.commit")
        st = self.store
        span = self._live_spans.pop(key, None)
        # the request's device window (dispatch->collect across its
        # prefill and decode chunks) — drain-scoped, SpanWriter.commit.
        # The programs register under "completer.*", so a split lane
        # drains that accumulator too
        device_ms = DEVTIME.take_lane_ms(self.LANE)
        if self.LANE != "completer":
            device_ms += DEVTIME.take_lane_ms("completer")
        if span is None and stages:
            # tail-based retention: a slow request that carried no
            # trace stamp still keeps full INFER_STAGES detail — one
            # `tail: true` span, slow-log-resolvable by trace id
            thr = self.recorder.slow_threshold_ms()
            wall = sum(stages.values())
            if thr is not None and wall > thr:
                tid = self.spans.tail_span(
                    key, wall, stages=stages,
                    extra={"tokens": n_tok},
                    device_ms=device_ms if device_ms > 0 else None)
                if tid is not None:
                    self.recorder.record(
                        tid, key, wall,
                        [[n, round(float(ms), 3)]
                         for n, ms in stages.items()])
        if vanished:
            self.stats.vanished += 1
            self._debug(f"key {key!r} vanished mid-request")
            self.spans.commit(span, status="error", stages=stages)
            return
        if truncated:
            self.stats.truncated += 1
            self._debug(f"completion for {key!r} truncated at max_val")
        try:
            st.stamp(key, which=0, ticks_ago=Store.now() - t0)
        except Exception:
            pass
        try:
            # DECODE_READY cleared too, as the JAX daemon does (a
            # no-op here; the disaggregated decode lane needs it)
            st.label_clear(key, P.LBL_SERVICING | P.LBL_DECODE_READY)
            st.label_or(key, P.LBL_READY)
            st.bump(key)
        except (KeyError, OSError):
            self.stats.vanished += 1
            self._debug(f"key {key!r} vanished mid-request")
            self.spans.commit(span, status="error", stages=stages)
            return
        self.spans.commit(span, stages=stages,
                          extra={"tokens": n_tok},
                          device_ms=device_ms if device_ms > 0
                          else None)
        self.stats.completions += 1
        self.stats.tokens += n_tok
        try:
            tenant = P.read_tenant(st.labels(key))
        except (KeyError, OSError):
            tenant = 0
        if tenant:
            # tenant bits survive the claim (only INFER/WAITING were
            # cleared), so goodput attribution needs no plumbing
            self.tenants.bump(tenant, "served_tokens", n_tok)

    # -- disaggregated-lane hooks (engine/disagg.py overrides) -------------

    def _lane_row_done(self, row: dict) -> None:
        """A continuous-lane row retired (finish or mid-decode kill).
        The decode lane deletes the row's handoff record + wire pages
        here; the unified lane has nothing to clean up."""

    def _lane_payload(self, payload: dict) -> None:
        """Lane-specific heartbeat sections (handoff counters, adoption
        gauges) land here just before publish."""

    def _rebid(self) -> None:
        if self._bid >= 0:
            try:
                self.store.shard_rebid(self._bid)
            except OSError:
                pass

    def process_key(self, idx: int) -> bool:
        """Run one completion for slot idx.  Returns True if serviced.

        With SPTPU_TRACE=1 the request decomposes into the
        protocol.INFER_STAGES histogram spans, and a client-stamped
        request (protocol.stamp_trace) gets a flight-recorder entry
        with the stage event sequence + client-measured wall time."""
        traced = tracer.enabled
        tr0 = time.perf_counter()
        prep = self._prepare(idx)
        if prep is None:
            return False
        tr1 = time.perf_counter()
        key, rendered, t0, stamp = prep
        n_tok, pending = 0, b""
        truncated = vanished = False
        try:
            fault("completer.generate")
            for piece in self.generate_fn(rendered):
                pending += piece
                n_tok += 1
                boundary = piece.endswith((b" ", b"\n", b"\t"))
                if boundary or n_tok % self.flush_tokens == 0:
                    r = self._flush(key, pending)
                    if r != "ok":
                        truncated = r == "full"
                        vanished = r == "gone"
                        break
                    pending = b""
                if self.rebid_tokens and n_tok % self.rebid_tokens == 0:
                    self._rebid()
            if pending and not truncated and not vanished:
                r = self._flush(key, pending)
                truncated = r == "full"
                vanished = r == "gone"
        except Exception as ex:       # model failure must not wedge WAITING
            self._debug(f"generation failed for {key!r}: {ex}")
        tr2 = time.perf_counter()
        self._finalize(key, t0, n_tok, truncated, vanished)
        if traced:
            tr3 = time.perf_counter()
            stages = ((tr1 - tr0) * 1e3, (tr2 - tr1) * 1e3,
                      (tr3 - tr2) * 1e3)
            for name, ms in zip(P.INFER_STAGES, stages):
                tracer.record(f"infer.{name}", ms)
            tracer.record("infer.e2e", (tr3 - tr0) * 1e3)
            if stamp is not None:
                tid, ts = stamp
                wall = ((time.time() - ts) * 1e3 if ts > 0
                        else (tr3 - tr0) * 1e3)
                self.recorder.record(
                    tid, key, wall,
                    [[n, round(ms, 3)]
                     for n, ms in zip(P.INFER_STAGES, stages)])
        return True

    def process_batch(self, idxs: list[int]) -> int:
        """Service up to batch_cap waiting keys as ONE batched decode.

        The reference is strictly serial — one llama.cpp context per
        request (splainference.cpp:414-448, 306-365).  Here the decoder
        left-pads every prompt into one bucket and decodes all rows per
        device step (models/decoder.py generate_batch), so N concurrent
        requests cost ~one request's wall clock.  Per-key protocol is
        IDENTICAL to process_key: label trifecta, rendered-prompt
        overwrite, word-boundary/8-token streaming appends, per-row oom
        truncation, ctime backfill, __debug on failure."""
        m, tok = self._model, self._tok
        prepped = []                  # (key, t0, ids)
        done_early = 0
        for idx in idxs:
            prep = self._prepare(idx)
            if prep is None:
                continue
            key, rendered, t0, _stamp = prep   # consumed by _prepare
            ids = self._clip_context(tok.encode(rendered), bucketed=True)
            if not len(ids):
                # an empty prompt must fail alone, not poison the whole
                # batch via prefill_batch's empty-prompt ValueError
                self._finalize(key, t0, 0, False)
                done_early += 1
                continue
            prepped.append((key, t0, np.asarray(ids, np.int32)))
        if not prepped:
            return done_early

        B = len(prepped)
        n_tok = [0] * B
        pending = [b""] * B
        done = [False] * B
        truncated = [False] * B
        vanished = [False] * B
        total = 0
        try:
            fault("completer.generate")
            gen = m.generate_batch([p[2] for p in prepped], self.max_new,
                                   chunk=max(1, self.flush_tokens))
            for col in gen:           # (B,) token column per step
                for r in range(B):
                    if done[r]:
                        continue      # speculative token: discard
                    t = int(col[r])
                    if t == tok.eos_id:
                        done[r] = True
                        continue
                    key = prepped[r][0]
                    piece = tok.token_to_piece(t)
                    pending[r] += piece
                    n_tok[r] += 1
                    boundary = piece.endswith((b" ", b"\n", b"\t"))
                    if boundary or n_tok[r] % self.flush_tokens == 0:
                        res = self._flush(key, pending[r])
                        if res != "ok":
                            truncated[r] = res == "full"
                            vanished[r] = res == "gone"
                            done[r] = True
                        pending[r] = b""
                total += 1
                if self.rebid_tokens and total % self.rebid_tokens == 0:
                    self._rebid()
                if all(done):
                    break
        except Exception as ex:       # model failure must not wedge WAITING
            self._debug(f"batched generation failed: {ex}")
        finally:
            m.reset()
        for r in range(B):
            key, t0, _ = prepped[r]
            if pending[r] and not truncated[r] and not vanished[r]:
                res = self._flush(key, pending[r])
                truncated[r] = res == "full"
                vanished[r] = res == "gone"
            self._finalize(key, t0, n_tok[r], truncated[r], vanished[r])
        return B + done_early

    def _flush(self, key: str, data: bytes) -> str:
        """Append a flushed run; on overflow truncate-and-mark
        (splainference.cpp:336-344).  Returns "ok", "full" (value at
        max_val — an OOM truncation), or "gone" (client deleted the
        key mid-request — stops THIS row without touching its batch,
        and must NOT be reported as a truncation)."""
        st = self.store
        try:
            st.append(key, data)
            return "ok"
        except KeyError:
            return "gone"
        except OSError as ex:
            if ex.errno != errno.EMSGSIZE:
                raise
            try:
                room = st.max_val - 1 - st.value_len(key)
                tail = data[: max(0, room - len(OOM_MARKER))] + OOM_MARKER
                st.append(key, tail[: max(0, room)])
            except (KeyError, OSError):
                pass
            return "full"

    # -- continuous batching (block-paged) --------------------------------

    def _paged_ok(self) -> bool:
        """True when the model serves the block-paged lane
        (paged_supported) with a usable bucket geometry."""
        m = getattr(self, "_model", None)
        return (m is not None
                and getattr(m, "paged_supported", False)
                and self.paged_batch_cap >= 2
                and self._batched_budget() is not None)

    def _ensure_paged_cache(self):
        if self._paged_cache is None:
            self._paged_cache = self._model.init_paged(
                self.paged_batch_cap, page=self.page_size,
                pool_pages=self.pool_pages, kv_dtype=self.kv_dtype)
            cache = self._paged_cache
            if self._prefix_enabled and hasattr(cache, "map_shared"):
                # (re)bind the radix tree to THIS pool: a rebuilt pool
                # (abort recovery, spec demotion) invalidates every
                # cached page id, so attach() empties the tree
                if self.prefix_cache is None:
                    from .prefix_cache import PrefixCache
                    self.prefix_cache = PrefixCache(
                        self.page_size,
                        max_pages=self._prefix_cache_pages,
                        tenant_quotas=self._prefix_quotas,
                        default_quota=self._prefix_default_quota)
                self.prefix_cache.attach(cache)
                cache.prefix_cache = self.prefix_cache
                if self._tier_pages:
                    self._bind_tier(cache)
        return self._paged_cache

    def _bind_tier(self, cache) -> None:
        """Wire the host-DRAM tier under the freshly attached radix
        tree, then (with persistence on) load the last good snapshot so
        THIS pool starts warm.  attach() just cleared the tree and the
        tier, so a rebuilt pool reloads from the persistent segment
        rather than trusting stale page ids."""
        from .kv_tier import HostTier, TierPersist, tier_geometry
        m = self._model
        if self.kv_tier is None:
            self.kv_tier = HostTier(self._tier_pages)
        self.prefix_cache.bind_tier(
            self.kv_tier,
            export_page=lambda bid, _c=cache, _m=m:
                _m.export_page_bytes(_c, bid),
            import_page=lambda bid, buf, sbuf, _c=cache, _m=m:
                _m.import_page_bytes(_c, bid, buf, sbuf))
        if not self._tier_persist_name:
            return
        geom = tier_geometry(m, cache)
        try:
            if self._tier_store is None:
                self._tier_store = TierPersist(
                    self._tier_persist_name,
                    capacity_pages=self._tier_pages,
                    max_len=m.cfg.max_len,
                    page_bytes=geom["page_bytes"])
            self._tier_restore = self._tier_store.load(
                self.prefix_cache, self.kv_tier, geom)
        except OSError:
            # persistence degraded (segment unopenable): serve cold with
            # the in-RAM tier; the reason reaches the heartbeat
            self._tier_store = None
            self._tier_restore = (0, "restore_failed")

    def warmup_paged(self) -> None:
        """Run the continuous lane's whole program set against the pool
        geometry run_continuous will serve with, so compile_count stays
        flat across join/finish/join cycles afterwards."""
        if not self._paged_ok():
            return
        cache = self._ensure_paged_cache()
        self._model.warmup_paged(cache, chunk=max(1, self.flush_tokens),
                                 max_prompt=self._batched_budget())
        if self.kv_tier is not None:
            # demotions and readmissions ride the page wire
            self._model.warmup_handoff(cache, export=True, adopt=True)

    def run_continuous(self, *, idle_timeout_ms: int = 100,
                       stop_after: float | None = None) -> None:
        """Continuous batched serving over the block-paged KV pool:
        requests join and leave the live batch at chunk boundaries.

        paged_batch_cap rows decode together, each over its OWN
        positions 0..len-1 in pages of a global pool: a joiner prefills
        its full prompt into freshly allocated pages at any time (only
        its uncached suffix when the prefix cache maps a shared
        prefix), a finished row's pages return to the pool at once, and
        a row ends at ITS window edge.  Admission reserves each request's
        worst case (prompt + max_new rounded up to a chunk, capped at the
        window); a request the pool cannot cover stays WAITING
        (join_backpressure) — backpressure, never a mid-decode strand.
        Up to inflight_depth decode chunks fly un-awaited, the token
        hand-off between them staying on the device.  Models without the
        paged surface, and window-only bucket geometries, fall back to
        run()."""
        if not self._paged_ok():
            return self.run(idle_timeout_ms=idle_timeout_ms,
                            stop_after=stop_after)
        m = self._model
        st = self.store
        tok_izer = self._tok
        B = self.paged_batch_cap
        cfg = m.cfg
        cache = self._ensure_paged_cache()
        self._running = True
        deadline = (time.monotonic() + stop_after) if stop_after else None
        last = st.signal_count(self.group)
        next_beat = time.monotonic() + 2.0
        self.publish_stats()          # the attach-complete signal

        rows: list[dict | None] = [None] * B
        # K-deep chunk window: each entry snapshots (row, serial) of the
        # rows live at its dispatch, so a lagged collect never emits into
        # a row a later admission re-seated.  Pages a stale in-flight
        # chunk touches are still the finished row's or are overwritten
        # by the joiner's commit scatter, which the device runs after
        # it: every pool write and K5 launch is on the one current
        # stream, in dispatch order.
        window: deque = deque()       # (PendingChunk, [(row, serial)])
        serial = itertools.count()
        carry = None                  # device-side last-token column
        # host-fed first tokens (a joiner's prefill sample); -1 = carry
        fresh = np.full((B,), -1, np.int64)
        rebid_due = 0
        step = max(1, self.flush_tokens)   # decode chunk granularity
        bp_memo = self._bp_memo
        bp_memo.clear()

        def worst_len(n_ids: int) -> int:
            """Worst-case cache length of an admitted prompt: the first
            output token comes from the prefill sample, the remaining
            max_new - 1 in whole `step`-token chunks (the last chunk can
            run up to step - 1 tokens past the budget)."""
            chunks = (-(-(self.max_new - 1) // step)
                      if self.max_new > 1 else 0)
            return min(n_ids + chunks * step, cfg.max_len)

        def span(row: dict | None, name: str, ms: float) -> None:
            tracer.record(f"infer.{name}", ms)
            if row is not None and row.get("spans") is not None:
                row["spans"].append([name, round(ms, 3)])

        def _lane_ctx() -> dict:
            """What a disaggregated decode lane's _lane_admit seats rows
            through — everything a join touches, read fresh (abort_all
            rebinds the cache)."""
            return {"rows": rows, "fresh": fresh, "cache": cache,
                    "serial": serial, "step": step,
                    "worst_len": worst_len, "span": span,
                    "finish": finish}

        def admit() -> int:
            """Fill free rows from waiting keys; every admission is a
            join that prefills right here, batch empty or mid-decode."""
            free = [r for r in range(B) if rows[r] is None]
            if not free:
                return 0
            if self._lane_admit is not None:
                # the disaggregated decode lane: admission is ADOPTION
                # of DECODE_READY handoffs at this chunk edge
                return self._lane_admit(free, _lane_ctx())
            self.stripes.refresh()    # admission IS this lane's drain
            waiting = [i for i in st.enumerate_indices(P.LBL_INFER_REQ)
                       if self.stripes.owns(int(i))]
            if not waiting:
                return 0
            # pool-backpressured rows stay out of the fairness plan
            # (they are not admissible this cycle); an expired one is
            # rejected typed right here
            plannable = []
            now_wall = time.time()
            for w_idx in waiting:
                memo = bp_memo.get(w_idx)
                if memo is not None \
                        and memo[0] == st.epoch_at(w_idx) \
                        and memo[1] > cache.available_pages:
                    tenant, dl = self._qos_meta(w_idx)
                    if dl is not None and dl <= now_wall:
                        if self._terminal_reject(
                                w_idx, P.DEADLINE_EXPIRED_DIAGNOSTIC,
                                "deadline_expired", tenant):
                            bp_memo.pop(w_idx, None)
                    continue
                plannable.append(w_idx)
            n = 0
            traced = tracer.enabled
            pc = cache.prefix_cache
            for idx in self._admit_waiting(plannable, len(free)):
                if not free:
                    break
                e = st.epoch_at(idx)
                memo = bp_memo.get(idx)
                if memo is not None and memo[0] == e:
                    if memo[1] > cache.available_pages:
                        continue      # still too big: skip the render
                    del bp_memo[idx]
                # peek BEFORE claiming: a backpressured request stays
                # WAITING untouched
                peek = self._read_rendered(idx)
                if peek is None:
                    continue
                ids = self._clip_context(tok_izer.encode(peek[1]),
                                         bucketed=True)
                # radix walk BEFORE the page math: hit pages need no
                # free page, so the reservation counts only the uncached
                # suffix, plus one page for the copy-on-write a fully
                # cached prompt's replay append takes
                hit_bids: list[int] = []
                match = 0
                tier_nodes: list = []
                if pc is not None and len(ids):
                    # tier-aware walk: a run of pool pages, then a run of
                    # demoted pages whose bytes sit in host RAM (a
                    # readmission each instead of a re-prefill; their
                    # pool pages come out of the same `need` budget)
                    hit_bids, match, tier_nodes = pc.lookup_tiered(ids)
                    if (match + len(tier_nodes) * cache.page == len(ids)
                            and len(ids) < 2):
                        # a fully covered 1-token prompt would enter at
                        # lengths 0, the dead-row sentinel: a miss
                        hit_bids, match, tier_nodes = [], 0, []
                match_all = match + len(tier_nodes) * cache.page
                full_cover = ((bool(hit_bids) or bool(tier_nodes))
                              and match_all == len(ids))
                reserve = 0
                if len(ids):
                    reserve = min(worst_len(len(ids))
                                  + (step if full_cover else 0),
                                  cfg.max_len)
                    need = (cache.pages_needed(reserve) - len(hit_bids)
                            + (1 if full_cover else 0))
                    # zero-ref hit pages count as reclaimable supply, but
                    # map_shared is about to pin them
                    pinned = sum(1 for b in hit_bids
                                 if cache.refcounts[b] == 0)
                    if need > cache.available_pages - pinned:
                        self.stats.join_backpressure += 1
                        bp_memo[idx] = (e, need + pinned)
                        self._bound_bp_memo()
                        continue      # pool full: next cycle retries
                tenant, _dl = self._qos_meta(idx)
                prep = self._prepare(idx, peek=peek)
                if prep is None:
                    continue
                key, rendered, t0, stamp = prep
                if not len(ids):
                    self._finalize(key, t0, 0, False)
                    continue
                r = free.pop(0)
                rows[r] = {"key": key, "t0": t0, "n_tok": 0,
                           "pending": b"", "remaining": self.max_new,
                           "stamp": stamp,
                           # retained for the chunk-edge deadline abort
                           "deadline": _dl, "tenant": tenant,
                           # the lagged-collect guard, and the decode
                           # steps still dispatchable for the budget
                           "serial": next(serial),
                           "disp_left": self.max_new - 1,
                           "spans": ([] if traced and stamp is not None
                                     else None),
                           "wall0": time.perf_counter()}
                ta = time.perf_counter()
                if hit_bids or tier_nodes:
                    fault("completer.prefix_map")
                    if hit_bids:
                        # pin the pool prefix FIRST: readmission below
                        # may reclaim, and an unpinned zero-ref hit page
                        # would be fair game for that eviction
                        cache.map_shared(r, hit_bids)
                    if tier_nodes:
                        # host-DRAM hit: readmitted pages come back at
                        # refcount 1; drop each to zero-ref (tree-held)
                        # and map, so map_shared's 0 -> 1 bump pins it
                        # for this row.  A partial readmission shortens
                        # the hit; the rest prefills
                        tier_bids = pc.readmit(tier_nodes, cache)
                        for b in tier_bids:
                            cache._decref(b)
                        if tier_bids:
                            cache.map_shared(r, tier_bids)
                        hit_bids = hit_bids + tier_bids
                        match += len(tier_bids) * cache.page
                        if len(tier_bids) < len(tier_nodes):
                            full_cover = False
                    if not hit_bids:
                        pc.note_miss()    # every readmission failed
                    else:
                        cache.lengths[r] = (len(ids) - 1 if full_cover
                                            else match)
                        pc.commit_hit(ids, match)
                        pc.stats.bytes_saved += \
                            match * cache.kv_bytes_per_token()
                        if tenant:
                            self.tenants.bump(tenant, "prefix_hit_pages",
                                              len(hit_bids))
                elif pc is not None and len(ids):
                    pc.note_miss()
                # the uncached tail AFTER readmission: a partial
                # readmission lengthens the suffix the prefill covers
                suffix = ids[match:]
                if not cache.ensure(r, reserve):
                    # defensive: the pinned-aware gate above makes this
                    # unreachable; a seated row WITHOUT its reservation
                    # would strand mid-decode, so re-queue it
                    cache.free_row(r)
                    rows[r] = None
                    free.insert(0, r)
                    self._live_spans.pop(key, None)
                    self.stats.join_backpressure += 1
                    self._requeue_failed([idx])
                    continue
                if traced and hit_bids:
                    span(rows[r], "prefix_hit",
                         (time.perf_counter() - ta) * 1e3)
                if cache.quantized and suffix:
                    fault("completer.kv_quant_commit")
                if suffix:
                    ta = time.perf_counter()
                    if hit_bids:
                        # the uncached tail only, attending the mapped
                        # prefix through K5's multi-query stack
                        logits = m.paged_append_prefill(
                            cache, np.asarray(suffix, np.int32), r)
                    else:
                        logits = m.paged_prefill_row(
                            cache, np.asarray(ids, np.int32), r)
                    tb = time.perf_counter()
                    if pc is not None:
                        # the committed full prompt pages join the tree
                        # now, donor still live
                        ins = pc.insert(ids, cache, r, tenant)
                        if ins and tenant:
                            self.tenants.bump(
                                tenant, "prefix_cached_pages", ins)
                    t = int(m.sample(logits))
                    if traced:
                        tc = time.perf_counter()
                        span(rows[r], "join", (tb - ta) * 1e3)
                        span(rows[r], "sample", (tc - tb) * 1e3)
                    emit(r, t)
                    if rows[r] is not None:
                        fresh[r] = t  # read by the next dispatch
                else:
                    # FULLY cached prompt: no prefill.  The row enters at
                    # lengths = P-1 and the next chunk replays the last
                    # prompt token into the shared tail page's private
                    # copy, taken EAGERLY here (the admission counted
                    # that page; a later admission must not consume it)
                    m._cow_fixups(cache)
                    rows[r]["disp_left"] = self.max_new
                    fresh[r] = int(ids[-1])
                n += 1
            return n

        def emit(r: int, t: int) -> None:
            """One sampled token for row r: eos / flush / budget."""
            row = rows[r]
            if t == tok_izer.eos_id:
                finish(r)
                return
            row["pending"] += tok_izer.token_to_piece(t)
            row["n_tok"] += 1
            row["remaining"] -= 1
            boundary = row["pending"].endswith((b" ", b"\n", b"\t"))
            if boundary or row["n_tok"] % self.flush_tokens == 0:
                tf = time.perf_counter()
                res = self._flush(row["key"], row["pending"])
                if tracer.enabled:
                    span(row, "flush", (time.perf_counter() - tf) * 1e3)
                row["pending"] = b""
                if res != "ok":
                    finish(r, truncated=res == "full",
                           vanished=res == "gone")
                    return
            if row["remaining"] <= 0:
                finish(r)

        def finish(r: int, truncated: bool = False,
                   vanished: bool = False) -> None:
            row = rows[r]
            if row["pending"] and not truncated and not vanished:
                res = self._flush(row["key"], row["pending"])
                truncated = res == "full"
                vanished = res == "gone"
            stages = None
            if row.get("spans"):
                stages = {}
                for name, ms in row["spans"]:
                    stages[name] = stages.get(name, 0.0) + ms
            self._finalize(row["key"], row["t0"], row["n_tok"],
                           truncated, vanished, stages=stages)
            if row.get("stamp") is not None \
                    and row.get("spans") is not None:
                tid, ts = row["stamp"]
                wall = ((time.time() - ts) * 1e3 if ts > 0 else
                        (time.perf_counter() - row["wall0"]) * 1e3)
                self.recorder.record(tid, row["key"], wall, row["spans"])
            self._lane_row_done(row)  # decode lane: retire the handoff
            cache.free_row(r)         # pages back to the pool NOW
            rows[r] = None
            fresh[r] = -1

        def kill_expired() -> int:
            """Chunk-edge deadline aborts: a live row whose deadline
            passed is retired with the typed DEADLINE_EXPIRED record and
            its pages freed at once; lagged in-flight chunks are
            serial-guarded, so its tokens evaporate."""
            now_wall = time.time()
            n = 0
            for r in range(B):
                row = rows[r]
                if row is None or not row.get("deadline") \
                        or row["deadline"] > now_wall:
                    continue
                key = row["key"]
                span_rec = self._live_spans.pop(key, None)
                try:
                    st.label_clear(key, P.LBL_SERVICING
                                   | P.LBL_DECODE_READY)
                    st.set(key, P.DEADLINE_EXPIRED_DIAGNOSTIC)
                    st.label_or(key, P.LBL_READY)
                    st.bump(key)
                except (KeyError, OSError):
                    pass
                self.spans.commit(span_rec, status=P.ERR_DEADLINE)
                self._lane_row_done(row)
                cache.free_row(r)
                rows[r] = None
                fresh[r] = -1
                self.stats.killed_mid_decode += 1
                self.stats.deadline_expired += 1
                if row.get("tenant"):
                    self.tenants.bump(row["tenant"], "deadline_expired")
                n += 1
            return n

        def collect(entry) -> None:
            """Resolve one in-flight chunk (its one device->host copy)
            and emit its columns to the rows live at ITS dispatch,
            serial-guarded."""
            pend, live = entry
            tc0 = time.perf_counter()
            blk = pend.block()
            used = cache.used_pages
            if used > self._pages_used_peak:
                self._pages_used_peak = used
            if tracer.enabled:
                ms = (time.perf_counter() - tc0) * 1e3
                tracer.record("infer.collect", ms)
                for r, ser in live:
                    row = rows[r]
                    if row is not None and row["serial"] == ser \
                            and row.get("spans") is not None:
                        row["spans"].append(["collect", round(ms, 3)])
            for c in range(pend.n):
                for r, ser in live:
                    row = rows[r]
                    if row is not None and row["serial"] == ser:
                        emit(r, int(blk[r, c]))

        def abort_all(reason: str) -> None:
            """A model failure must not wedge WAITING/SERVICING: every
            live row finalizes with what it streamed and the pool is
            rebuilt (a failure mid-program may have left it half
            written)."""
            nonlocal cache, carry
            self._debug(f"continuous batch aborted: {reason}")
            self.stats.aborts += 1
            window.clear()
            carry = None
            fresh[:] = -1
            for r in range(B):
                if rows[r] is not None:
                    finish(r)
            self._paged_cache = None
            cache = self._ensure_paged_cache()
            bp_memo.clear()

        try:
            while self._running:
                now = time.monotonic()
                if deadline and now > deadline:
                    break
                if now >= next_beat:
                    next_beat = now + 2.0
                    # the acceptance floor rides the beat on this lane
                    # (run_once's per-drain hook never fires here): a
                    # tripped floor swaps self._model to the target
                    # NOW, and the lane adopts it at the next idle point
                    self._maybe_demote_spec()
                    self._sweep_bp_memo()
                    self.publish_stats()
                    # the warm set's checkpoint rides the beat (dirty-
                    # gated: a quiet tier costs one flag read)
                    self._tier_checkpoint()

                try:
                    if all(r is None for r in rows):
                        # nothing live: retire in-flight chunks (serial
                        # guards drop every column), reset the carry
                        while window:
                            collect(window.popleft())
                        carry = None
                        if self._model is not m:
                            # a demotion decided mid-run: adopt the
                            # target at this idle point (no live rows,
                            # no chunk in flight); the paired spec pools
                            # retire with their wrapper and a fresh pool
                            # serves the plain model
                            m = self._model
                            self._paged_cache = None
                            cache = self._ensure_paged_cache()
                            bp_memo.clear()
                            self._debug("continuous lane adopted the "
                                        "demoted (plain) model")
                        if admit() == 0:
                            if self.replica \
                                    and self.stripes.poll_retired():
                                self._debug("replica destriped — retiring")
                                break
                            got = st.signal_wait(
                                self.group, last,
                                timeout_ms=idle_timeout_ms)
                            if got is not None:
                                last = got
                                self.stats.wakes += 1
                        continue

                    if any(r is None for r in rows):
                        admit()       # joiners enter at ANY time

                    kill_expired()

                    # rows without window room for the next chunk, or
                    # whose whole budget is in flight, are not
                    # dispatched again: collect oldest-first until they
                    # finish, then force any survivor (a true window-
                    # edge row) closed
                    edge = [r for r in range(B) if rows[r] is not None
                            and (int(cache.lengths[r]) + step
                                 > cfg.max_len
                                 or rows[r]["disp_left"] <= 0)]
                    if edge:
                        while window and any(rows[r] is not None
                                             for r in edge):
                            collect(window.popleft())
                        for r in edge:
                            if rows[r] is not None:
                                finish(r)
                    if all(r is None for r in rows):
                        continue

                    td = time.perf_counter()
                    pend = m.paged_decode_chunk_async(
                        cache, fresh, step, carry=carry)
                    live = [(r, rows[r]["serial"]) for r in range(B)
                            if rows[r] is not None]
                    if tracer.enabled:
                        ms = (time.perf_counter() - td) * 1e3
                        tracer.record("infer.decode", ms)
                        for r, _ in live:
                            if rows[r].get("spans") is not None:
                                rows[r]["spans"].append(
                                    ["decode", round(ms, 3)])
                    carry = pend.last
                    fresh[:] = -1
                    for r, _ in live:
                        rows[r]["disp_left"] -= step
                    window.append((pend, live))
                    self.stats.inflight_peak = max(
                        self.stats.inflight_peak, len(window))
                    rebid_due += step
                    if self.rebid_tokens and rebid_due >= self.rebid_tokens:
                        rebid_due = 0
                        self._rebid()
                    # collect the oldest only once inflight_depth chunks
                    # are un-awaited: its emit/flush host work overlaps
                    # the newest chunk's device compute
                    while len(window) >= self.inflight_depth:
                        collect(window.popleft())
                except Exception as ex:
                    abort_all(str(ex))
        finally:
            # stop()/stop_after mid-batch: deliver in-flight tokens,
            # strand no key in SERVICING, return the WHOLE pool (cached
            # pages included: the zero-leaked-pages contract)
            try:
                while window:
                    collect(window.popleft())
            except Exception:
                self.stats.aborts += 1    # a poisoned chunk: keep what landed
            for r in range(B):
                if rows[r] is not None:
                    finish(r)
            cache.reset()
            if self.prefix_cache is not None:
                # with the tier bound every reclaimed page DEMOTES to
                # host RAM first (demote-on-retire), and the forced
                # checkpoint persists the whole warm set
                self.prefix_cache.reclaim(cache.n_blocks)
            self._tier_checkpoint(force=True)

    def _tier_checkpoint(self, force: bool = False) -> None:
        """Snapshot the radix index + host-tier pages into the
        persistent segment (kv_tier.TierPersist.save: payload under the
        new epoch first, the index record last, so a torn write leaves
        the previous snapshot authoritative).  Replica 0 writes; peers
        only load.  Beat-cadence calls are dirty-gated and rate-limited;
        force is the retire path."""
        if (self._tier_store is None or self.kv_tier is None
                or self.prefix_cache is None or self.replica != 0):
            return
        now = time.monotonic()
        if not force and (not self.kv_tier.dirty
                          or now - self._tier_last_save < 5.0):
            return
        self._tier_last_save = now
        from .kv_tier import tier_geometry
        try:
            self._tier_store.save(
                self.prefix_cache, self.kv_tier,
                tier_geometry(self._model, self._paged_cache))
        except Exception as ex:
            self._debug(f"tier checkpoint failed: {ex}")

    # -- drain loop --------------------------------------------------------

    def run_once(self) -> int:
        """Enumerate waiting keys and service them (cold-start drain and
        per-wake drain are the same sweep, splainference.cpp:541-551).
        With a model backend, waiting keys are served in batches of
        batch_cap through one left-padded decode each; a custom
        generate_fn serves serially (its contract is one prompt)."""
        st = self.store
        self.stripes.refresh()        # a re-stripe lands HERE, at the
        idxs = [i for i in st.enumerate_indices(P.LBL_INFER_REQ)
                if self.stripes.owns(int(i))]   # drain boundary
        if not idxs:
            self._had_deferred = False    # nothing waiting: the
            return 0                      # redrain loop must end
        # multi-tenant admission: fair order across tenants, expired
        # deadlines rejected fast, backlog past high water shed with
        # the typed overloaded record.  With a high-water mark set,
        # one drain also bounds its own work to the mark (deferred
        # rows stay WAITING; run()'s work-conserving re-drain takes
        # them next, in fair slices)
        cap = (len(idxs) if self.qos.high_water is None
               else min(len(idxs), max(1, self.qos.high_water)))
        idxs = self._admit_waiting(idxs, cap)
        if not idxs:
            return 0
        if self._bid >= 0:
            try:
                st.shard_rebid(self._bid)
                st.madvise(self._bid, N.ADV_WILLNEED, timeout_ms=0)
            except OSError:
                pass
        n = 0
        batched = getattr(self, "_model", None) is not None \
            and self.generate_fn == self._model_generate \
            and self.batch_cap > 1 \
            and hasattr(self._model, "prefill_batch") \
            and self._batched_budget() is not None
        # per-key/per-batch exception firewall: generation failures are
        # already contained inside process_key/process_batch, so
        # anything raising through is a protocol/store-level surprise —
        # it must cost ITS keys (any left SERVICING are flipped back to
        # WAITING for the next sweep), never the drain's siblings or
        # the run loop itself
        if batched:
            for lo in range(0, len(idxs), self.batch_cap):
                batch = idxs[lo: lo + self.batch_cap]
                try:
                    n += self.process_batch(batch)
                except Exception as ex:
                    self.stats.faults += 1
                    self._debug(f"batch drain failed: {ex}")
                    self._requeue_failed(batch)
        else:
            for idx in idxs:
                self._rebid()
                try:
                    if self.process_key(idx):
                        n += 1
                except Exception as ex:
                    self.stats.faults += 1
                    self._debug(f"request at slot {idx} failed: {ex}")
                    self._requeue_failed([idx])
        if n:
            self._maybe_demote_spec()
        self.spans.flush()            # oneshot drains land their
        return n                      # spans; run() uses heartbeats

    # -- speculative degradation -------------------------------------------

    def _spec_acceptance(self) -> float | None:
        """The live speculative acceptance rate, or None when the model
        is not speculative (after a demotion too: the rate that tripped
        the floor survives in _spec_acceptance_rolling)."""
        m = getattr(self, "_model", None)
        if m is None or not hasattr(m, "acceptance_rate"):
            return None
        return float(m.acceptance_rate)

    def _maybe_demote_spec(self) -> None:
        """The acceptance floor: a draft the target keeps rejecting costs
        a draft forward per proposal and buys nothing, so a speculative
        model is worse than its plain target below some acceptance.
        Track a rolling acceptance over the recent drains (or beats);
        when it sits under spec_min_acceptance with 32 proposals or
        more behind it, swap the model for its own target and decode
        plain for the rest of the run (spec_demotions counts it; 0
        disables the floor)."""
        m = getattr(self, "_model", None)
        if (m is None or self.spec_min_acceptance <= 0
                or not hasattr(m, "acceptance_rate")
                or not hasattr(m, "target")):
            return
        if not self._spec_hist:
            self._spec_hist.append((0, 0))
        self._spec_hist.append((m.stats_proposed, m.stats_accepted))
        if len(self._spec_hist) > 8:
            self._spec_hist.pop(0)
        p0, a0 = self._spec_hist[0]
        dp = m.stats_proposed - p0
        if dp < 32:
            return                    # not enough evidence yet
        rate = (m.stats_accepted - a0) / dp
        self._spec_acceptance_rolling = rate
        if rate < self.spec_min_acceptance:
            self.stats.spec_demotions += 1
            self._debug(
                f"speculative acceptance {rate:.3f} < floor "
                f"{self.spec_min_acceptance}: demoting to plain decode "
                "(target model) for the rest of the run")
            self._model = m.target

    def publish_stats(self) -> None:
        """Heartbeat: JSON stats snapshot into the debug-labeled
        __completer_stats key (the structured counterpart of the
        reference's __debug chatter; sidecar group-63 watch surfaces
        it).  SPTPU_TRACE=1 adds histogram-sourced INFER_STAGES
        quantiles, recorder accounting, and the slow log.  The fields
        are the JAX daemon's dense- and continuous-lane ones, its KV-tier
        and speculative gauges and the split lanes' sections (the
        sharded gauges arrive with that lane)."""
        self.spans.flush()            # heartbeat cadence, off the
        payload = dataclasses.asdict(self.stats)      # wake path
        payload["spans_obs"] = self.spans.counters()
        payload["generation"] = self.generation
        if self.replica or self.stripes.epoch:
            payload["replica"] = self.replica
            payload["stripe"] = self.stripes.snapshot()
        cache = self._paged_cache
        if not self.stats.killed_mid_decode and cache is None:
            payload.pop("killed_mid_decode", None)   # dense lane
        payload["inflight_depth"] = self.inflight_depth
        payload["bp_memo"] = len(self._bp_memo)
        if self.qos.high_water is not None:
            payload["qos"] = {
                "queue_high_water": self.qos.high_water,
                "retry_after_ms": self.qos.retry_after_ms}
        tenants = self.tenants.snapshot()
        if tenants:
            # per-tenant admitted/shed/deadline_expired/served_tokens
            payload["tenants"] = tenants
        prune_idle_counters(
            payload, bool(self.qos.high_water is not None or tenants))
        if not self._bp_memo and cache is None:
            payload.pop("bp_memo", None)             # dense lane
        acc = self._spec_acceptance()
        if acc is None:
            # demoted: keep the rolling rate that tripped the floor
            acc = self._spec_acceptance_rolling
        if acc is not None:
            payload["spec_acceptance"] = round(acc, 4)
        m_now = getattr(self, "_model", None)
        if hasattr(m_now, "stats_proposed"):
            # drafted = proposals the draft generated, accepted = the
            # proposals the target kept, verified = positions it scored
            payload["spec_draft_tokens"] = int(m_now.stats_proposed)
            payload["spec_accepted_tokens"] = int(m_now.stats_accepted)
            payload["spec_verified_tokens"] = int(m_now.stats_verified)
        if cache is not None:
            # pool gauges (sptpu_completer_pages_{free,used})
            payload["pages_free"] = cache.free_pages
            payload["pages_used"] = cache.used_pages
            payload["live_tokens"] = cache.live_tokens()
            self._pages_used_peak = max(self._pages_used_peak,
                                        cache.used_pages)
            payload["pages_used_peak"] = self._pages_used_peak
        pc = self.prefix_cache
        if pc is not None:
            s = pc.stats
            payload["prefix_hits"] = s.hits
            payload["prefix_misses"] = s.misses
            payload["prefix_hit_tokens"] = s.hit_tokens
            payload["prefix_evictions"] = s.evictions
            payload["prefix_shared_pages"] = pc.shared_pages()
            payload["prefix_evictable"] = pc.evictable_count()
            payload["prefix_cow_copies"] = s.cow_copies
            payload["prefix_bytes_saved"] = s.bytes_saved
            for t, pages in pc.tenant_pages().items():
                # per-tenant cache residency beside the QoS counters;
                # untagged traffic (tenant 0) never creates the section
                if t:
                    tenants.setdefault(str(t), {})["prefix_pages"] = pages
            if tenants and "tenants" not in payload:
                payload["tenants"] = tenants
        if self.kv_tier is not None:
            tier = self.kv_tier
            payload["tier_pages"] = len(tier)
            payload["tier_mb"] = round(tier.bytes_held() / 2**20, 3)
            payload["tier_spills"] = tier.spills
            payload["tier_spill_failures"] = tier.spill_failures
            payload["tier_demotions"] = tier.demotions
            payload["tier_readmits"] = tier.readmits
            payload["tier_readmit_failures"] = tier.readmit_failures
            payload["tier_capacity_drops"] = tier.capacity_drops
            payload["tier_restored"] = self._tier_restore[0]
            if self._tier_restore[1] not in ("", "off"):
                payload["tier_restore_reason"] = self._tier_restore[1]
            if pc is not None:
                payload["tier_demoted"] = pc.demoted_pages()
            if self._tier_store is not None:
                payload["tier_snapshot_epoch"] = self._tier_store.epoch
        if cache is not None:
            # the pool's storage dtype and the bytes of its device
            # tensors (values + scales)
            payload["kv_dtype"] = cache.kv_dtype
            payload["pool_mb"] = cache.device_mb()
            self._pool_mb_peak = max(self._pool_mb_peak, payload["pool_mb"])
            payload["pool_mb_peak"] = round(self._pool_mb_peak, 3)
        if faults.armed():
            payload["faults"] = faults.stats()
        payload["compile_events"] = DEVTIME.compile_events(self.LANE)
        devtime = DEVTIME.heartbeat_section(self.LANE)
        if self.LANE != "completer":
            # a split lane's programs register under "completer.*"
            payload["compile_events"] += DEVTIME.compile_events("completer")
            devtime.update(DEVTIME.heartbeat_section("completer"))
        if devtime:
            payload["devtime"] = devtime
        # this process's hand-written kernel launches by name (the
        # counterpart of the JAX lanes' device-program ledger in
        # devtime), in the size-droppable "dispatch" section that `spt
        # metrics` renders flat: sptpu_<lane>_kernel_<name>
        payload.setdefault("dispatch", {}).update(
            LAUNCHES.heartbeat_fields())
        self._lane_payload(payload)
        DEVTIME.flush(self.store)
        if tracer.enabled:
            P.attach_trace_sections(payload, tracer, self.recorder,
                                    "infer.")
        P.publish_heartbeat(self.store, self._hb_key, payload)
        if tracer.enabled:
            self._trace_published = P.maybe_publish_trace_ring(
                self.store, self._trace_key, self.recorder,
                self._trace_published)

    def run(self, *, idle_timeout_ms: int = 100,
            stop_after: float | None = None) -> None:
        self._running = True
        last = self.store.signal_count(self.group)
        deadline = (time.monotonic() + stop_after) if stop_after else None
        next_sweep = time.monotonic() + 2.0
        self.publish_stats()          # the attach-complete signal
        self.run_once()               # cold start
        while self._running:
            got = self.store.signal_wait(self.group, last,
                                         timeout_ms=idle_timeout_ms)
            now = time.monotonic()
            # heartbeat cadence is independent of the wake path — a
            # daemon at full load must still look alive to watchers
            do_sweep = now >= next_sweep
            if do_sweep:
                next_sweep = now + 2.0
            # loop-level firewall (run_once already contains per-key
            # failures; this catches gather/store-level surprises)
            try:
                if got is not None:
                    last = got
                    self.stats.wakes += 1
                    self.run_once()
                    # work-conserving under a high-water drain bound:
                    # deferred WAITING rows re-drain immediately in
                    # fair slices instead of waiting out the sweep
                    redrains = 0
                    while self._had_deferred and self._running \
                            and redrains < 256:
                        redrains += 1
                        self.run_once()
                elif do_sweep:
                    self.run_once()
                if do_sweep:
                    self._sweep_bp_memo()
                    self.publish_stats()
                    if self.replica and self.stripes.poll_retired():
                        # scale-down drain: the drains above finished
                        # in-flight work; exit and let the supervisor
                        # reap us
                        log.info("replica %d destriped — retiring",
                                 self.replica)
                        break
            except Exception as ex:
                self.stats.faults += 1
                log.exception("run loop cycle failed; continuing")
                self._debug(f"run loop cycle failed: {ex}")
            if deadline and now > deadline:
                break

    def stop(self) -> None:
        self._running = False


# flags of the JAX daemon whose lanes the port does not have yet: each
# refuses to start rather than serve another way (see ROADMAP.md)
_NOT_PORTED = (
    ("tp", "--tp", "Queue A, multi-GPU: tensor-parallel serving"),
    ("ep", "--ep", "Queue A, multi-GPU: expert parallelism"),
)


def _refuse_not_ported(args) -> None:
    """SystemExit naming the first not-yet-ported option that is set
    (`--tp 1` and `--ep 1` name this very lane)."""
    this_lane = {"tp": 1, "ep": 1}
    for dest, flag, where in _NOT_PORTED:
        if getattr(args, dest) not in (None, False, this_lane.get(dest)):
            raise SystemExit(
                f"{flag} is not yet ported to the torch package (ROADMAP "
                f"{where}); the JAX daemon, python -m "
                "libsplinter_tpu.engine.completer, serves it")


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu_torch.engine.completer
    --store NAME [--device cuda|cpu]"""
    import argparse

    from ..utils.device import DEVICE_CHOICES

    ap = argparse.ArgumentParser(
        description="splinter-tpu completion daemon, PyTorch port "
                    "(streaming decoder on the card over the store's "
                    "label protocol)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--device", choices=DEVICE_CHOICES, default="cuda",
                    help="run the decoder on the card (default) or on "
                         "the CPU with the kernels' plain versions; "
                         "never falls back from one to the other")
    ap.add_argument("--oneshot", action="store_true")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--template", default="auto",
                    help="chat template: chatml, llama2, llama3, or none "
                         "(bare system\\n\\nprompt); auto fingerprints "
                         "a .gguf's tokenizer.chat_template, and is none "
                         "without one")
    ap.add_argument("--temp", type=float, default=0.7)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--idle-timeout-ms", type=int, default=100)
    ap.add_argument("--replica", type=int, default=0,
                    help="striped replica index (elastic lanes): "
                         "drain only the stripes the lane's stripe "
                         "map assigns this replica; heartbeat "
                         "publishes replica-suffixed "
                         "(__completer_stats.rN)")
    ap.add_argument("--weights",
                    help="decoder checkpoint: .gguf (geometry, tokenizer "
                         "and chat template all from the file) or "
                         ".safetensors (HF llama naming; default "
                         "geometry, byte-level tokenizer).  The literal "
                         "'int8' means no checkpoint: seeded-random "
                         "weights held per-output-channel int8 "
                         "(--weights-int8 with no path)")
    ap.add_argument("--n-ctx", type=int, default=None,
                    help="context window / KV-cache length (default: "
                         "a .gguf's context length, else 2048)")
    ap.add_argument("--batch-cap", type=int, default=None,
                    help="serve up to this many waiting keys "
                         "concurrently (1 = serial, the reference's "
                         "cadence).  Default: 32 with --continuous (the "
                         "paged pool's memory scales with live tokens), "
                         "8 otherwise (a wider dense batch multiplies "
                         "B x max_len cache memory)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every prefill bucket and the decode "
                         "shapes once before serving (with "
                         "--continuous: the paged program set)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: requests join/leave the "
                         "live batch at chunk boundaries over the "
                         "block-paged KV pool (run_continuous; kernel K5 "
                         "on every decode step)")
    ap.add_argument("--phase", choices=("unified", "prefill", "decode"),
                    default="unified",
                    help="disaggregated serving (engine/disagg.py): "
                         "'prefill' runs only the prompt prefill and "
                         "hands each row's pages off at DECODE_READY; "
                         "'decode' adopts handoffs at chunk edges and "
                         "runs only paged decode.  Both imply "
                         "--continuous.  Default: the unified lane")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 weight residency: the attention/MLP "
                         "projections stay on the card as Q8_0-geometry "
                         "int8 + per-block f32 scales (models/quant.py; "
                         "dequantized before the product)")
    ap.add_argument("--weights-int8", action="store_true",
                    help="per-output-channel int8 weight residency "
                         "(models/quant.py ChannelQuantDense): the "
                         "product runs on the int8 codes with an f32 "
                         "result and one scale per output column after "
                         "it.  Mutually exclusive with --quantized")
    ap.add_argument("--page-size", type=int, default=128,
                    help="KV pool page size in tokens (continuous lane)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="total pages in the paged KV pool (default: "
                         "batch-cap full windows; admission "
                         "backpressures when the pool is full)")
    ap.add_argument("--kv-dtype", choices=("bf16", "f32", "int8", "int4"),
                    default=None,
                    help="paged KV pool storage (continuous lane; "
                         "default: the activation dtype).  int8 keeps "
                         "per-page per-kv-head scales and halves the "
                         "cache bytes per token against bf16; int4 packs "
                         "two codes per byte (a quarter); K5 dequantizes "
                         "inside its page loop")
    ap.add_argument("--inflight-depth", type=int, default=None,
                    help="continuous lane: decode chunks in flight "
                         "before the oldest is collected (default 2; 1 "
                         "collects every chunk before the next)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable cross-request prefix sharing on the "
                         "continuous lane (default on: shared prompt "
                         "prefixes map refcounted pool pages instead of "
                         "re-prefilling — engine/prefix_cache.py)")
    ap.add_argument("--prefix-cache-pages", type=int, default=None,
                    help="global cap on pool pages the prefix cache may "
                         "retain (default: unlimited; zero-ref pages are "
                         "reclaimed LRU-first when the pool needs them)")
    ap.add_argument("--prefix-quota", default=None,
                    help="per-tenant prefix-cache page quotas, "
                         "TENANT:PAGES[,TENANT:PAGES...]")
    ap.add_argument("--kv-tier-pages", type=int, default=0,
                    help="host-DRAM KV spill tier capacity in pool pages "
                         "(engine/kv_tier.py): evicted zero-ref prefix "
                         "pages demote to host RAM and a later hit "
                         "readmits them instead of re-prefilling "
                         "(default 0: off)")
    ap.add_argument("--kv-tier-persist", nargs="?", const="auto",
                    default=None,
                    help="checkpoint the radix index + host-tier pages "
                         "into a file-backed store segment so restarts "
                         "attach WARM (torn snapshots fall back cold, "
                         "typed in the heartbeat).  The optional value "
                         "names the segment; the bare flag derives "
                         "<store>-kvtier.  Replica 0 writes, all load")
    ap.add_argument("--queue-high-water", type=int, default=None,
                    help="multi-tenant QoS: max waiting backlog — "
                         "overflow is claimed and READY-flipped with "
                         "a typed {\"err\": \"overloaded\", "
                         "\"retry_after_ms\": N} value instead of "
                         "queueing unboundedly (default: never shed)")
    ap.add_argument("--retry-after-ms", type=int, default=None,
                    help="retry hint carried by shed responses")
    ap.add_argument("--tenant-weights", default=None,
                    help="per-tenant fair-share weights, "
                         "TENANT:W[,TENANT:W...] (unlisted weigh 1)")
    ap.add_argument("--draft-weights",
                    help="speculative decoding: a small draft .gguf "
                         "(geometry and vocab from its metadata) proposes "
                         "--gamma tokens per target forward "
                         "(models/speculative.py); serial lane")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="SELF-DRAFTING speculative decode: the draft is "
                         "the target's own first N layers (shared "
                         "embedding, final norm and LM head; no extra "
                         "weights).  Serves the continuous lane too: the "
                         "drafts verify through K5's multi-query stack")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative proposal length per verify step")
    ap.add_argument("--spec-min-acceptance", type=float, default=0.2,
                    help="speculative decoding floor: when the rolling "
                         "draft acceptance stays below this, demote to "
                         "plain decode for the rest of the run (0 "
                         "disables; the heartbeat publishes "
                         "spec_acceptance)")
    not_ported = ap.add_argument_group(
        "not yet ported (the JAX daemon's; each refuses to start)")
    for flag in ("--tp", "--ep"):
        not_ported.add_argument(flag, type=int, default=None)
    args = ap.parse_args(argv)
    _refuse_not_ported(args)
    if args.weights == "int8":
        args.weights = None
        args.weights_int8 = True
    if args.quantized and args.weights_int8:
        raise SystemExit(
            "--quantized and --weights-int8 are mutually exclusive: "
            "both claim the attention/MLP kernels (Q8_0 blocks vs "
            "per-output-channel) — pick one weight residency")

    if args.draft_weights and args.draft_layers:
        raise SystemExit(
            "--draft-weights and --draft-layers are mutually exclusive: "
            "the first drafts with a separate checkpoint (serial lane "
            "only), the second with a truncated view of the target "
            "(continuous lane capable) — pick one")
    if args.draft_weights and not args.draft_weights.endswith(".gguf"):
        # a safetensors file carries no geometry metadata, and a draft
        # small enough to be useful is never default-sized
        raise SystemExit(
            "--draft-weights requires a .gguf draft (geometry and "
            "tokenizer come from its metadata); export the draft via "
            "models/gguf_writer.py if needed")

    logging.basicConfig(level=logging.INFO)
    if os.environ.get("SPTPU_CHIP_PIN"):
        # supervisor lane placement (--pin-chips): prefill and decode
        # replicas land on disjoint cards
        from ..utils.device import apply_chip_pin
        args.device = str(apply_chip_pin(os.environ["SPTPU_CHIP_PIN"],
                                         args.device))
    from ..models import (CompletionModel, DecoderConfig, GgufFile,
                          MoeDecoderConfig, SpeculativeCompletionModel,
                          decoder_config_from_gguf, load_tokenizer,
                          moe_completion_model, self_draft_model)

    tokenizer = None
    template = args.template
    if args.weights and args.weights.endswith(".gguf"):
        overrides = {"max_len": args.n_ctx} if args.n_ctx else {}
        with GgufFile(args.weights) as gf:   # parse the container once
            cfg = decoder_config_from_gguf(gf, **overrides)
            tokenizer = load_tokenizer(gf)
            if template == "auto":
                # fingerprint the checkpoint's embedded Jinja template
                # (llama.cpp reads the same metadata for its pick)
                template = detect_template(
                    gf.metadata.get("tokenizer.chat_template"))
                log.info("--template auto resolved to %r", template)
    else:
        cfg = DecoderConfig(max_len=args.n_ctx or 2048)
        if args.weights:
            log.warning(
                "--weights %s has no tokenizer metadata; falling back to "
                "the byte-level tokenizer, which will NOT match a real "
                "checkpoint's vocabulary — use the model's .gguf export",
                args.weights)
    if template == "auto":
        # no GGUF metadata to fingerprint: the reference's own fallback
        # when llama_chat_apply_template has no template is bare
        # system\n\nprompt concatenation
        template = "none"
        log.info("--template auto with no GGUF metadata: using 'none'")
    if args.quantized:
        cfg = dataclasses.replace(cfg, quantized=True)
    if args.weights_int8:
        fault("completer.weight_quant")
        cfg = dataclasses.replace(cfg, weights_int8=True)
    mkw = dict(weights=args.weights, top_p=args.top_p, temp=args.temp,
               device=args.device)
    if isinstance(cfg, MoeDecoderConfig):
        # a Mixtral-family GGUF resolves to the MoE config; the same
        # daemon stack serves it (models/moe.py)
        log.info("MoE checkpoint: %d experts, top-%d routing",
                 cfg.n_experts, cfg.top_k)
        model = moe_completion_model(cfg, **mkw)
    else:
        model = CompletionModel(cfg, **mkw)
    if args.draft_weights:
        with GgufFile(args.draft_weights) as gf:
            dcfg = decoder_config_from_gguf(gf)
        draft = CompletionModel(dcfg, weights=args.draft_weights,
                                top_p=args.top_p, temp=args.temp,
                                device=args.device)
        model = SpeculativeCompletionModel(model, draft, gamma=args.gamma)
        log.info("speculative decoding: gamma=%d draft=%s", args.gamma,
                 args.draft_weights)
    elif args.draft_layers:
        draft = self_draft_model(model, args.draft_layers)
        model = SpeculativeCompletionModel(model, draft, gamma=args.gamma)
        log.info("self-drafting speculative decode: first %d of %d "
                 "layers, gamma=%d (drafts verify through K5 on the "
                 "continuous lane)", args.draft_layers, cfg.layers,
                 args.gamma)
    store = Store.open(args.store, persistent=args.persistent)
    cls = Completer
    if args.phase != "unified":
        from .disagg import DecodeLane, PrefillLane
        cls = PrefillLane if args.phase == "prefill" else DecodeLane
    comp = cls(store, model=model, tokenizer=tokenizer,
                     max_new_tokens=args.max_new_tokens,
                     template=template, batch_cap=args.batch_cap,
                     page_size=args.page_size, pool_pages=args.pool_pages,
                     kv_dtype=args.kv_dtype,
                     inflight_depth=args.inflight_depth,
                     spec_min_acceptance=args.spec_min_acceptance,
                     queue_high_water=args.queue_high_water,
                     retry_after_ms=args.retry_after_ms,
                     tenant_weights=parse_tenant_weights(
                         args.tenant_weights),
                     prefix_cache=not args.no_prefix_cache,
                     prefix_cache_pages=args.prefix_cache_pages,
                     prefix_quotas=parse_tenant_quotas(args.prefix_quota),
                     kv_tier_pages=args.kv_tier_pages,
                     kv_tier_persist=(f"{args.store}-kvtier"
                                      if args.kv_tier_persist == "auto"
                                      else args.kv_tier_persist),
                     replica=args.replica)
    comp.attach()
    continuous = args.continuous or args.phase != "unified"
    if args.warmup:
        t0 = time.monotonic()
        if continuous and comp._paged_ok():
            # the continuous lane only ever runs the paged program set
            comp.warmup_paged()
        else:
            kw = {}
            if comp.batch_cap > 1 and hasattr(model, "prefill_batch") \
                    and comp._batched_budget() is not None:
                kw["batch"] = comp.batch_cap    # the dense batched shapes
            model.warmup(chunk=comp.flush_tokens, **kw)
        log.info("warmup ran in %.1fs", time.monotonic() - t0)
    if args.oneshot:
        n = comp.run_once()
        log.info("oneshot serviced %d completions", n)
        return 0
    try:
        if continuous:
            comp.run_continuous(idle_timeout_ms=args.idle_timeout_ms)
        else:
            comp.run(idle_timeout_ms=args.idle_timeout_ms)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
