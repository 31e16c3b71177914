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

Waiting keys are served in batches of batch_cap through one left-padded
decode each (models/decoder.py generate_batch; prefill buckets of 512
tokens and up attend through kernel K4), or one at a time for a custom
generate_fn.  The label protocol, flush cadence, truncation, ctime
backfill and __debug lines are the JAX daemon's, so torch and JAX
daemons share one store.  Not ported yet: the block-paged continuous
lane and what rides on it, GGUF checkpoints, quantized weights,
speculative decoding and sharded serving — ``main`` refuses their
flags instead of serving another way.
"""
from __future__ import annotations

import dataclasses
import errno
import logging
import time
from typing import Callable, Iterator

import numpy as np

from .. import _native as N
from ..obs.devtime import DEVTIME
from ..obs.recorder import FlightRecorder
from ..obs.spans import SpanWriter
from ..store import Store
from ..utils import faults
from ..utils.faults import fault
from ..utils.trace import tracer
from . import protocol as P
from .qos import (AdmissionController, TenantLedger, WaitingRow,
                  parse_tenant_weights, prune_idle_counters)

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
    # -- multi-tenant QoS (engine/qos.py) ----------------------------
    deadline_expired: int = 0         # fast-failed: deadline passed
    shed: int = 0                     # typed overloaded + retry hint
    deferred: int = 0                 # held for a later drain/chunk

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
                 queue_high_water: int | None = None,
                 retry_after_ms: int | None = None,
                 tenant_weights: dict[int, float] | None = None,
                 replica: int = 0,
                 device=None):
        """model: a CompletionModel; when neither it nor generate_fn is
        given, a seeded-random one is built on `device` ("cuda" by
        default, or "cpu")."""
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
        # a wider dense batch multiplies (B, max_len, KH, D) cache memory
        self.batch_cap = 8 if batch_cap is None else batch_cap
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
        self.tenants = TenantLedger()
        self._had_deferred = False
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
        plan = self.qos.plan(rows, capacity)
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
        # prefill and decode chunks) — drain-scoped, SpanWriter.commit
        device_ms = DEVTIME.take_lane_ms(self.LANE)
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
        self.spans.flush()            # oneshot drains land their
        return n                      # spans; run() uses heartbeats

    def publish_stats(self) -> None:
        """Heartbeat: JSON stats snapshot into the debug-labeled
        __completer_stats key (the structured counterpart of the
        reference's __debug chatter; sidecar group-63 watch surfaces
        it).  SPTPU_TRACE=1 adds histogram-sourced INFER_STAGES
        quantiles, recorder accounting, and the slow log.  The fields
        are the JAX daemon's dense-lane ones; the paged, speculative
        and sharded gauges arrive with those lanes."""
        self.spans.flush()            # heartbeat cadence, off the
        payload = dataclasses.asdict(self.stats)      # wake path
        payload["spans_obs"] = self.spans.counters()
        payload["generation"] = self.generation
        if self.replica or self.stripes.epoch:
            payload["replica"] = self.replica
            payload["stripe"] = self.stripes.snapshot()
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
        if faults.armed():
            payload["faults"] = faults.stats()
        payload["compile_events"] = DEVTIME.compile_events(self.LANE)
        devtime = DEVTIME.heartbeat_section(self.LANE)
        if devtime:
            payload["devtime"] = devtime
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
    ("continuous", "--continuous",
     "Queue A item 6: the block-paged continuous lane, kernel K5"),
    ("phase", "--phase prefill|decode",
     "Queue A item 6: the disaggregated prefill/decode lanes"),
    ("kv_dtype", "--kv-dtype", "Queue A item 6: the paged KV pools"),
    ("quantized", "--quantized",
     "Queue A item 8: int8 weight residency (models/quant.py)"),
    ("weights_int8", "--weights-int8 / --weights int8",
     "Queue A item 8: int8 weight residency (models/quant.py)"),
    ("draft_weights", "--draft-weights",
     "Queue A item 8: speculative decoding"),
    ("draft_layers", "--draft-layers",
     "Queue A item 8: speculative decoding"),
    ("tp", "--tp", "Queue A item 9: tensor-parallel serving"),
    ("ep", "--ep", "Queue A items 8-9: MoE expert parallelism"),
)


def _refuse_not_ported(args) -> None:
    """SystemExit naming the first not-yet-ported option that is set
    (`--phase unified`, `--tp 1` and `--ep 1` name this very lane)."""
    this_lane = {"phase": "unified", "tp": 1, "ep": 1}
    if args.weights == "int8":       # the JAX daemon's --weights-int8
        args.weights_int8 = True
    for dest, flag, where in _NOT_PORTED:
        if getattr(args, dest) not in (None, False, this_lane.get(dest)):
            raise SystemExit(
                f"{flag} is not yet ported to the torch package (ROADMAP "
                f"{where}); the JAX daemon, python -m "
                "libsplinter_tpu.engine.completer, serves it")
    if args.weights and args.weights.endswith(".gguf"):
        raise SystemExit(
            "GGUF checkpoints are not yet ported to the torch package "
            "(ROADMAP Queue A item 7: gguf.py load_decoder_params); "
            "convert to .safetensors")


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
                         "(bare system\\n\\nprompt); auto means none "
                         "until GGUF metadata can be read")
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
                    help="decoder checkpoint: .safetensors (HF llama "
                         "naming); .gguf is not yet ported")
    ap.add_argument("--n-ctx", type=int, default=None,
                    help="context window / KV-cache length (default "
                         "2048)")
    ap.add_argument("--batch-cap", type=int, default=None,
                    help="serve up to this many waiting keys in one "
                         "left-padded batch (1 = serial, the "
                         "reference's cadence; default 8)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every prefill bucket and the decode "
                         "shapes once before serving")
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
    not_ported = ap.add_argument_group(
        "not yet ported (the JAX daemon's; each refuses to start)")
    for flag in ("--continuous", "--quantized", "--weights-int8"):
        not_ported.add_argument(flag, action="store_true")
    for flag in ("--tp", "--ep", "--draft-layers"):
        not_ported.add_argument(flag, type=int, default=None)
    for flag in ("--phase", "--kv-dtype", "--draft-weights"):
        not_ported.add_argument(flag, default=None)
    args = ap.parse_args(argv)
    _refuse_not_ported(args)

    logging.basicConfig(level=logging.INFO)
    from ..models import CompletionModel, DecoderConfig

    template = args.template
    if template == "auto":
        # no GGUF metadata to fingerprint: the reference's own fallback
        # when llama_chat_apply_template has no template is bare
        # system\n\nprompt concatenation
        template = "none"
        log.info("--template auto with no GGUF metadata: using 'none'")
    if args.weights:
        log.warning(
            "--weights %s has no tokenizer metadata; falling back to "
            "the byte-level tokenizer, which will NOT match a real "
            "checkpoint's vocabulary", args.weights)
    cfg = DecoderConfig(max_len=args.n_ctx or 2048)
    model = CompletionModel(cfg, weights=args.weights, top_p=args.top_p,
                            temp=args.temp, device=args.device)
    store = Store.open(args.store, persistent=args.persistent)
    comp = Completer(store, model=model,
                     max_new_tokens=args.max_new_tokens,
                     template=template, batch_cap=args.batch_cap,
                     queue_high_water=args.queue_high_water,
                     retry_after_ms=args.retry_after_ms,
                     tenant_weights=parse_tenant_weights(
                         args.tenant_weights),
                     replica=args.replica)
    comp.attach()
    if args.warmup:
        t0 = time.monotonic()
        kw = {}
        if comp.batch_cap > 1 and comp._batched_budget() is not None:
            kw["batch"] = comp.batch_cap    # the dense batched shapes
        model.warmup(chunk=comp.flush_tokens, **kw)
        log.info("warmup ran in %.1fs", time.monotonic() - t0)
    if args.oneshot:
        n = comp.run_once()
        log.info("oneshot serviced %d completions", n)
        return 0
    try:
        comp.run(idle_timeout_ms=args.idle_timeout_ms)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
