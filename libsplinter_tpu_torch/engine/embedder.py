"""Event-driven micro-batching embedding daemon (PyTorch, on the card).

The torch counterpart of the JAX package's embedder lane, and like it
the replacement for the reference's splinference sidecar
(splinference.cpp).  Where the reference polls a signal counter every
50 ms and decodes ONE key at a time through llama.cpp on the CPU, this
daemon:

  - blocks on the store's event bus / signal group (C-side wait, no spin);
  - drains the dirty mask per wake and gathers ALL pending candidates;
  - snapshots (text, epoch) per candidate under the seqlock read protocol;
  - pads each gather into per-bucket batches and runs one encoder call
    per bucket on the card (long buckets attend through kernel K1);
  - pipelines the drain: encode futures are held, not forced — the host
    tokenizes/buckets/pads batch N+1 while batch N computes on-device,
    and the epoch-gated commit stage resolves futures in COMPLETION
    order (CommitPipeline), so wake->commit never pays a synchronous
    device round-trip it could have overlapped; tiny drains take a
    short-circuit lane onto pre-compiled small-bucket programs;
  - commits the whole batch of vectors with a single epoch-gated native
    call (spt_vec_commit_batch) — rows whose slot changed mid-flight are
    dropped, mirroring the reference's post-decode epoch+2 verification
    (splinference.cpp:275-287) but amortized over the batch.

Protocol fidelity (all reference behaviors preserved):
  label 0x1 wake, WAITING(0x40) clear, context-exceeded marker (zero
  vector + diagnostic value + label 0x80 + bump), --vector-training
  write-once gate, backfill sweep (SEQUENTIAL rebid + madvise), --oneshot,
  cold-start epoch baselining of keys that already carry vectors.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Sequence

import numpy as np

from .. import _native as N
from ..obs.devtime import DEVTIME
from ..obs.recorder import FlightRecorder
from ..obs.spans import SpanWriter
from ..ops._cuda import LAUNCHES
from ..store import Store
from ..utils import faults
from ..utils.faults import fault
from ..utils.trace import device_profile, tracer
from . import protocol as P
from .qos import (AdmissionController, TenantLedger, WaitingRow,
                  parse_tenant_weights, prune_idle_counters)
from .resident import InflightWindow

log = logging.getLogger("libsplinter_tpu_torch.embedder")

# a row whose encode/commit batch failed this many times is failed
# terminally (labels cleared, client unblocked) instead of wedging the
# degradation ladder forever
ROW_STRIKE_LIMIT = 3

# An encoder takes a list of texts and returns (B, dim) float32 vectors.
EncoderFn = Callable[[Sequence[str]], np.ndarray]




@dataclasses.dataclass
class EmbedderStats:
    wakes: int = 0
    batches: int = 0
    embedded: int = 0
    raced: int = 0
    skipped_write_once: int = 0
    ctx_exceeded: int = 0
    backfilled: int = 0
    # -- failure-domain accounting (the per-batch firewall) ----------
    batch_faults: int = 0       # encode/commit batches that failed
    embed_failed: int = 0       # rows failed terminally after strikes
    drain_faults: int = 0       # run-loop cycles the firewall absorbed
    # -- multi-tenant QoS (engine/qos.py) ----------------------------
    deadline_expired: int = 0   # fast-failed: client deadline passed
    shed: int = 0               # unblocked label-only past high water
    deferred: int = 0           # held for a later drain (fairness)
    # -- commit-pipeline telemetry (the overlap is measured, not
    # asserted: bench.py's p50 stage table reads these) --------------
    futures_dispatched: int = 0
    futures_resolved: int = 0
    ready_commits: int = 0      # future already complete at commit time
    blocking_waits: int = 0     # host had to block on a device future
    inflight_peak: int = 0      # max dispatched-uncommitted depth seen
    probe_lane_hits: int = 0    # drains through the small-batch lane
    # -- resident-ring telemetry (engine/resident.py): one ring
    # dispatch services ring_occupancy batches, so the per-drain
    # dispatch floor amortizes to ~floor/occupancy -----------------
    ring_dispatches: int = 0    # resident device programs dispatched
    resident_iterations: int = 0  # batches serviced inside rings
    ring_occupancy: int = 0     # last ring's occupied slot count
    ring_occupancy_peak: int = 0
    ring_faults: int = 0        # ring dispatches degraded to per-call
    device_wait_ms: float = 0.0  # host wall time blocked in materialize
    overlap_ms: float = 0.0      # device in-flight time host spent staging
    commit_host_ms: float = 0.0  # epoch-gated commit + protocol tail

    def overlap_ratio(self) -> float:
        """Fraction of total device in-flight time the host spent doing
        useful work instead of blocking (1.0 = the device never stalled
        the host; 0.0 = every batch was a synchronous round-trip)."""
        total = self.overlap_ms + self.device_wait_ms
        return self.overlap_ms / total if total > 0 else 0.0


class CommitPipeline(InflightWindow):
    """The drain stage of the embed->commit lane — the original
    instance of the K-deep overlap pattern, now built on the shared
    InflightWindow skeleton (engine/resident.py) the searcher and the
    continuous decode lane reuse.

    Dispatched encode futures (PendingEmbeddings, or ring slot views
    of a resident multi-batch dispatch) queue here instead of being
    forced inline.  Commits resolve in COMPLETION order: any future
    that has finished is committed immediately (zero wait) while later
    batches are still being tokenized/dispatched, and the host only
    blocks on the device when the in-flight bound is hit with nothing
    ready — back-pressure, not a synchronous round-trip per batch.
    The old path forced each batch FIFO with a blocking device_get
    inside the wake handler: wake->commit paid the full device
    round-trip every time (BENCH_r05: 62.2 of the 67.2 ms p50).
    """

    def __init__(self, commit_fn, stats: EmbedderStats, depth: int,
                 *, stage_acc: dict | None = None, on_error=None):
        super().__init__(depth)
        self._commit = commit_fn      # (rows, epochs, f32 vecs) -> int
        self._stats = stats
        # per-batch failure domain: (rows, epochs, exc) -> None.  With
        # a handler armed, a batch whose materialize or commit raises
        # fails ALONE (the handler re-queues or fails its rows) and
        # the pipeline keeps resolving siblings; without one, the old
        # raise-through behavior stands.
        self._on_error = on_error
        # per-drain PIPELINE_STAGES accumulator (tracing only): the
        # resolve path adds its device_wait/commit wall here so traced
        # requests get real stage events, not re-measured estimates
        self._stage_acc = stage_acc
        self._blocked_ms = 0.0        # cumulative materialize-block time
        self.committed = 0

    def push(self, rows, epochs, pending) -> None:
        self._stats.futures_dispatched += 1
        self.push_entry((rows, epochs, pending, time.perf_counter(),
                         self._blocked_ms))
        self._stats.inflight_peak = max(self._stats.inflight_peak,
                                        self.inflight_peak)

    def _entry_ready(self, item) -> bool:
        return item[2].is_ready()

    def _resolve(self, item) -> None:
        rows, epochs, pending, t_dispatch, blocked_at_dispatch = item
        st = self._stats
        ready = pending.is_ready()
        t0 = time.perf_counter()
        # time the future flew while the host did USEFUL staging work:
        # the raw dwell minus any interval the host spent blocked in
        # OTHER futures' materialize (counting that too would let a
        # fully-stalled pipeline still report ~50% overlap)
        dwell_ms = (t0 - t_dispatch) * 1e3
        st.overlap_ms += max(
            dwell_ms - (self._blocked_ms - blocked_at_dispatch), 0.0)
        try:
            fault("embedder.encode")
            vecs = pending.materialize()
        except Exception as ex:
            self._blocked_ms += (time.perf_counter() - t0) * 1e3
            if self._on_error is None:
                raise
            self._on_error(rows, epochs, ex)
            return
        t1 = time.perf_counter()
        wait_ms = (t1 - t0) * 1e3
        st.device_wait_ms += wait_ms
        self._blocked_ms += wait_ms
        if ready:
            st.ready_commits += 1
        else:
            st.blocking_waits += 1
        try:
            self.committed += self._commit(rows, epochs, vecs)
        except Exception as ex:
            if self._on_error is None:
                raise
            self._on_error(rows, epochs, ex)
            return
        commit_ms = (time.perf_counter() - t1) * 1e3
        st.commit_host_ms += commit_ms
        st.futures_resolved += 1
        if tracer.enabled:
            # histogram records from the timings above — no extra
            # span machinery in the per-batch resolve path
            tracer.record("embed.device_wait", wait_ms)
            tracer.record("embed.commit", commit_ms)
            acc = self._stage_acc
            if acc is not None:
                acc["device_wait"] += wait_ms
                acc["commit"] += commit_ms


class Embedder:
    """The daemon object.  Drive it with run() (blocking loop), run_once()
    (single drain — the reference's --oneshot), or embed tests through a
    fake encoder_fn."""

    def __init__(self, store: Store, encoder_fn: EncoderFn | None = None,
                 *, model=None, tokenizer=None,
                 max_ctx: int = 2048,
                 vector_training: bool = False,
                 group: int = P.GROUP_EMBED,
                 batch_cap: int = 256,
                 inflight_depth: int | None = None,
                 ring_depth: int | None = None,
                 probe_batch_max: int | None = None,
                 admit_cap: int | None = None,
                 queue_high_water: int | None = None,
                 retry_after_ms: int | None = None,
                 tenant_weights: dict[int, float] | None = None,
                 replica: int = 0,
                 device=None):
        """device: where the default model runs when `model` is not
        given — "cuda" (default) or "cpu"."""
        self.store = store
        self.max_ctx = max_ctx
        self.vector_training = vector_training
        self.group = group
        self.batch_cap = batch_cap
        # elastic lanes (protocol.StripeView): replica r of a striped
        # group drains only its own slot-index stripe — the map is
        # store state, re-read at each drain, so a supervisor
        # re-stripe lands at the next drain boundary.  replica 0 with
        # no map is the classic single-process deployment.
        self.replica = int(replica)
        self.stripes = P.StripeView(store, "embedder", self.replica)
        self._hb_key = P.replica_stats_key(P.KEY_EMBED_STATS,
                                           self.replica)
        self._trace_key = P.replica_stats_key(P.KEY_EMBED_TRACE,
                                              self.replica)
        self._inflight_override = inflight_depth
        self._ring_override = ring_depth
        # drains at or below this size take the latency short-circuit
        # lane (no sort, no windowing — straight to the pre-compiled
        # small-bucket programs)
        self.probe_batch_max = (P.PROBE_BATCH_MAX_DEFAULT
                                if probe_batch_max is None
                                else probe_batch_max)
        # multi-tenant QoS (engine/qos.py): admit_cap bounds rows per
        # drain (fairness granularity — the rest stay pending and the
        # next drain re-plans with stride credit); queue_high_water
        # bounds that backlog — overflow rows are unblocked label-only
        # (the embed lane has no value channel to spare for a typed
        # record: the slot holds the client's text, so the shed signal
        # is the cleared label + zero vector + the heartbeat's shed /
        # per-tenant counters).  Deadline fast-fail is always on for
        # rows carrying a deadline stamp.
        self.admit_cap = admit_cap
        self.qos = AdmissionController(
            weights=tenant_weights, high_water=queue_high_water,
            **({"retry_after_ms": retry_after_ms}
               if retry_after_ms is not None else {}))
        self.tenants = TenantLedger()
        self._had_deferred = False
        self._row_labels: dict[int, int] = {}
        self.stats = EmbedderStats()
        # flight recorder: per-request wake->commit traces for rows
        # whose client stamped a trace id (protocol.stamp_trace);
        # published next to the heartbeat (KEY_EMBED_TRACE)
        self.recorder = FlightRecorder()
        self.spans = SpanWriter(store, "embedder")
        self._live_spans: list = []           # pending spans this drain
        self._trace_published = 0             # ring state last published
        self._stage_acc: dict | None = None   # live drain's stage sums
        self._traced_hits: list | None = None  # LBL_TRACED rows seen
        self._drain_t0: float | None = None
        self._known_epochs: dict[int, int] = {}
        # rows believed to need embedding: fed by the dirty mask (hot
        # path) and by label sweeps (cold start + periodic reconcile).
        # Raced/torn rows stay here and retry next drain — so the hot
        # path never needs the O(nslots) label scan (VERDICT r1 item 6).
        self._pending: set[int] = set()
        # failure-domain state: a failed encode/commit batch halves
        # the effective batch cap (the bucket) for subsequent drains —
        # a poison batch is bisected until the bad rows stand alone —
        # and per-row strike counts fail repeat offenders terminally
        # (keyed by slot, scoped to the request epoch: a rewrite must
        # not inherit the old text's strikes)
        self._cap_degraded: int | None = None
        self._strikes: dict[int, tuple[int, int]] = {}
        self.generation = 0          # bumped at attach (restart marker)
        self._bid = -1
        self._running = False

        if encoder_fn is not None:
            self.encoder_fn = encoder_fn
            self._tok = tokenizer
        else:
            if model is None:
                from ..models import EmbeddingModel, EncoderConfig
                model = EmbeddingModel(
                    EncoderConfig(out_dim=store.vec_dim, max_len=max_ctx),
                    device=device)
            if tokenizer is None:
                from ..models import default_tokenizer
                tokenizer = default_tokenizer(model.cfg.vocab_size)
            self._model = model
            self._tok = tokenizer
            self.encoder_fn = self._model_encode

    # -- wiring ------------------------------------------------------------

    def attach(self) -> None:
        """Claim the shard, bind the wake label, arm/join the event bus,
        and baseline epochs of already-embedded keys (cold start)."""
        st = self.store
        try:
            self._bid = st.shard_claim(P.SHARD_EMBED, N.ADV_WILLNEED,
                                       P.PRIO_EMBED_LIVE, 30_000_000)
        except OSError:
            self._bid = -1          # bid table full: run unadvised
        st.watch_label_register(P.BIT_EMBED_REQ, self.group)
        st.bus_attach()   # adopts the bus when a crashed owner
                          # left a dead pid in the header
        self.generation = P.bump_generation(st, self._hb_key)
        # compile events ledgered from here carry this generation —
        # a restart's re-warmup is distinguishable in the ring
        DEVTIME.generation = max(DEVTIME.generation, self.generation)
        self._baseline_existing()
        # cold start: pre-existing requests enter the pending set once
        # (reference drains pre-existing WAITING keys on startup,
        # splinference.cpp:463-493); after this the hot path is fed by
        # the dirty mask alone
        self._pending.update(st.enumerate_indices(P.LBL_EMBED_REQ))

    def _baseline_existing(self) -> None:
        """Cold start: keys that already carry a non-zero vector are
        treated as up to date at their current epoch
        (reference: splinference.cpp:463-493)."""
        st = self.store
        vecs = st.vectors
        live = np.abs(vecs).max(axis=1) > 0
        for idx in np.nonzero(live)[0]:
            self._known_epochs[int(idx)] = st.epoch_at(int(idx))

    # -- encoding ----------------------------------------------------------

    def _model_encode(self, texts: Sequence[str]) -> np.ndarray:
        # tokenize first; the padding bucket comes from REAL token counts
        # (a whitespace heuristic undercounts punctuation-dense text and
        # would silently truncate it)
        if hasattr(self._tok, "encode_batch"):
            # one native GIL-releasing call for the whole micro-batch
            # (wptok.c); Unicode rows fall back internally
            ids_full, lens = self._tok.encode_batch(
                list(texts), self._model.cfg.max_len)
            return self._encode_bucketed(ids_full, lens)
        encs = [self._tok.encode(t, max_len=self._model.cfg.max_len)
                for t in texts]
        bucket = self._model.bucket_for(max(len(e) for e in encs))
        ids = np.full((len(encs), bucket), self._tok.pad_id, np.int32)
        lens = np.zeros(len(encs), np.int32)
        for i, e in enumerate(encs):
            e = e[:bucket]
            ids[i, : len(e)] = e
            lens[i] = len(e)
        return self._model.encode_ids(ids, lens)

    def _dispatch_bucketed(self, ids: np.ndarray, lens: np.ndarray):
        """Group rows by their own padding bucket and dispatch one
        encode per (bucket, <=batch_cap) group, without forcing any
        result.  Yields (row_selection, pending) lazily so the
        consumer's in-flight bound actually applies back-pressure
        between dispatches (an eager list would enqueue the whole
        window on the device before the first commit).

        Grouping matters: the reference pays each text its own length
        (serial llama.cpp decode); a naive batch pays every text the
        LONGEST text's bucket.  Grouping keeps short texts on narrow
        programs — most of the padding FLOPs come back.

        When a bucket group yields two or more FULL batches and the
        model supports the ring, those batches pre-stage into a
        (ring_depth, cap, bucket) ring queued as one unit
        (encode_ring_async) and fetched in one copy.  The short tail
        batch rides the per-call path on its own."""
        cap = self.effective_batch_cap
        depth = self.ring_depth
        ring_async = (getattr(self._model, "encode_ring_async", None)
                      if depth > 1 else None)
        bkts = self._model.buckets_for(np.asarray(lens))
        for b in np.unique(bkts):
            sel = np.nonzero(bkts == b)[0]
            chunks = [sel[lo: lo + cap]
                      for lo in range(0, len(sel), cap)]
            full = len(chunks) - (1 if len(chunks[-1]) < cap else 0)
            lo = 0
            if ring_async is not None and full >= 2:
                while full - lo >= 2:
                    group = chunks[lo: lo + min(depth, full - lo)]
                    yield from self._dispatch_ring(ids, lens, group,
                                                   int(b), cap)
                    lo += len(group)
            for ss in chunks[lo:]:
                yield ss, self._model.encode_ids_async(
                    np.ascontiguousarray(ids[ss, : int(b)]),
                    np.minimum(lens[ss], b).astype(np.int32))

    def _dispatch_ring(self, ids, lens, group, b: int, cap: int):
        """Pre-stage `group` (full cap-sized chunks of one bucket)
        into a host-fed ring and queue it once; yields one RingSlot
        pending per chunk so the CommitPipeline consumes ring and
        per-call dispatches identically.  A ring dispatch that fails
        degrades to the per-call path for its chunks (ring_faults
        counts it) — the ring must never cost a drain."""
        from ..models.encoder import _batch_pad

        depth = self.ring_depth
        bpad = _batch_pad(cap)
        ids_ring = np.zeros((depth, bpad, b), np.int32)
        lens_ring = np.zeros((depth, bpad), np.int32)
        for j, ss in enumerate(group):
            ids_ring[j, : len(ss)] = ids[ss, :b]
            lens_ring[j, : len(ss)] = np.minimum(lens[ss], b)
        st = self.stats

        def retry(j: int, n: int) -> np.ndarray:
            # collect-time fallback: asynchronous CUDA work surfaces
            # device failures at the ring FETCH — re-encode the one
            # slot per-call so a transient error costs a re-dispatch,
            # never a failed batch (one poisoned ring would otherwise
            # halve the cap and strike rows once PER SLOT)
            st.ring_faults += 1
            log.warning("resident ring collect failed; re-encoding "
                        "slot %d of %d per-call", j, len(group))
            return self._model.encode_ids_async(
                np.ascontiguousarray(ids_ring[j, :n]),
                lens_ring[j, :n].copy()).materialize()

        try:
            ring = self._model.encode_ring_async(ids_ring, lens_ring,
                                                 len(group),
                                                 retry=retry)
        except Exception as ex:
            st.ring_faults += 1
            log.warning("resident ring dispatch of %d batches failed "
                        "(%s); falling back to per-call", len(group),
                        ex)
            for ss in group:
                yield ss, self._model.encode_ids_async(
                    np.ascontiguousarray(ids[ss, :b]),
                    np.minimum(lens[ss], b).astype(np.int32))
            return
        st.ring_dispatches += 1
        st.resident_iterations += len(group)
        st.ring_occupancy = len(group)
        st.ring_occupancy_peak = max(st.ring_occupancy_peak,
                                     len(group))
        for j, ss in enumerate(group):
            yield ss, ring.slot(j, len(ss))

    def _encode_bucketed(self, ids: np.ndarray, lens: np.ndarray):
        """Synchronous encode tail for the public encoder_fn surface."""
        vecs = np.zeros((len(lens), self._model.cfg.out_dim), np.float32)
        for sel, pend in self._dispatch_bucketed(ids, lens):
            vecs[sel] = pend.materialize()
        return vecs

    def _too_long(self, text: str) -> bool:
        if self._tok is None:
            return len(text.split()) >= int(self.max_ctx *
                                            P.CTX_GUARD_FRACTION)
        n = len(self._tok.encode(text))
        return n >= int(self.max_ctx * P.CTX_GUARD_FRACTION)

    # -- candidate gathering ----------------------------------------------

    def _candidates(self, indices: Sequence[int]) -> list[int]:
        st = self.store
        out = []
        self._row_labels.clear()      # per-drain QoS metadata only
        traced = self._traced_hits
        for idx in indices:
            labels = st.labels_at(idx)
            if not labels & P.LBL_EMBED_REQ:
                self._pending.discard(idx)    # done or never requested
                if labels & (P.LBL_TRACED | P.LBL_DEBUG
                             | P.LBL_DEADLINE):
                    # a stamp that landed after its request was
                    # serviced surfaces here (its own write dirtied
                    # the stamp slot) — shed it or it leaks forever
                    P.shed_orphan_stamp(st, idx, labels)
                continue
            if not self.stripes.owns(idx):
                continue              # a peer replica's stripe: stays
                                      # pending, ours after a re-stripe
            self._row_labels[idx] = labels    # tenant/deadline for QoS
            e = st.epoch_at(idx)
            if e & 1:
                self._pending.add(idx)        # writer active: next drain
                continue
            if self._known_epochs.get(idx, -1) >= e:
                self._pending.discard(idx)    # already embedded this epoch
                continue
            if labels & P.LBL_TRACED and traced is not None:
                traced.append(idx)   # stamp read deferred to _begin_trace
            out.append(idx)
        return out

    def _gather(self, rows: list[int]):
        """Snapshot (text, epoch) per row under the read protocol."""
        st = self.store
        texts, epochs, keep = [], [], []
        for idx in rows:
            e = st.epoch_at(idx)
            if e & 1:
                continue
            try:
                raw = st.get_at(idx)
            except Exception:
                continue
            if st.epoch_at(idx) != e:
                continue                      # torn: re-queued by next wake
            texts.append(raw.rstrip(b"\0").decode("utf-8", errors="replace"))
            epochs.append(e)
            keep.append(idx)
        return keep, texts, epochs

    # -- the drain ---------------------------------------------------------

    def _mark_ctx_exceeded(self, idx: int) -> None:
        st = self.store
        key = st.key_at(idx)
        if key is None:
            return
        st.vec_set_at(idx, np.zeros(st.vec_dim, np.float32))
        st.set(key, P.CTX_EXCEEDED_DIAGNOSTIC)
        st.label_or(key, P.LBL_CTX_EXCEEDED)
        st.label_clear(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
        self._known_epochs[idx] = st.epoch_at(idx)
        self._pending.discard(idx)
        st.bump(key)
        self.stats.ctx_exceeded += 1

    def _ctx_flags_and_ids(self, texts):
        """Context-guard decisions for a gather, with the token ids as a
        byproduct when the real model drives encoding.

        Fused path: ONE native batch tokenization (wptok.c) yields both
        the too-long flags and the ids the encoder will consume — the
        old flow tokenized every text twice (_too_long + _model_encode).
        Rows truncated at the model window necessarily exceed the guard
        threshold, so capped lens stay decision-exact."""
        fused = (getattr(self, "_model", None) is not None
                 and self.encoder_fn == self._model_encode
                 and self._tok is not None
                 and hasattr(self._tok, "encode_batch"))
        if fused:
            thr = int(self.max_ctx * P.CTX_GUARD_FRACTION)
            if thr <= self._model.cfg.max_len:
                ids, lens = self._tok.encode_batch(
                    list(texts), self._model.cfg.max_len)
                return lens >= thr, ids, lens
        return (np.array([self._too_long(t) for t in texts], bool),
                None, None)

    # how many dispatched encode batches may be outstanding before the
    # host blocks to commit the oldest: CUDA work queues asynchronously,
    # so the card works on batch k+1..k+depth while the host commits k.
    # Tunable three ways, all read live on every drain: the
    # constructor's inflight_depth, assigning .inflight_depth on an
    # instance, or the legacy class-attribute path
    # (`Embedder._INFLIGHT_DEPTH = 4`).
    _INFLIGHT_DEPTH = 2

    @property
    def inflight_depth(self) -> int:
        return (type(self)._INFLIGHT_DEPTH
                if self._inflight_override is None
                else self._inflight_override)

    @inflight_depth.setter
    def inflight_depth(self, value: int) -> None:
        self._inflight_override = value

    # ring depth: how many full same-bucket batches one ring dispatch
    # services (engine/resident.py).  <=1 disables — every batch is
    # queued and fetched on its own.  Same three-way tunability as
    # inflight_depth.
    _RING_DEPTH = 8

    @property
    def ring_depth(self) -> int:
        return (type(self)._RING_DEPTH
                if self._ring_override is None
                else self._ring_override)

    @ring_depth.setter
    def ring_depth(self, value: int) -> None:
        self._ring_override = value

    @property
    def effective_batch_cap(self) -> int:
        """batch_cap, halved per failed batch while the degradation
        ladder is active (restored multiplicatively after clean
        drains) — the poison-batch bisection bound."""
        if self._cap_degraded is None:
            return self.batch_cap
        return min(self._cap_degraded, self.batch_cap)

    # -- failure domains ---------------------------------------------------

    def _on_batch_error(self, rows, epochs, ex: Exception) -> None:
        """One encode/commit batch failed (CUDA out of memory, a store
        commit surprise, an injected fault): halve the bucket so
        the retry bisects toward the poison row, strike each row, and
        fail rows past the strike limit terminally.  Surviving rows
        stay in the pending set — the next drain retries them at the
        degraded cap; the run loop itself never sees the exception."""
        self.stats.batch_faults += 1
        cap = self._cap_degraded or min(self.batch_cap, len(rows))
        self._cap_degraded = max(1, cap // 2)
        log.warning("encode batch of %d failed (%s); batch cap "
                    "degraded to %d", len(rows), ex,
                    self._cap_degraded)
        for idx, epoch in zip(rows, epochs):
            idx, epoch = int(idx), int(epoch)
            prev_epoch, n = self._strikes.get(idx, (epoch, 0))
            if prev_epoch != epoch:
                n = 0                 # rewritten since: clean slate
            self._strikes[idx] = (epoch, n + 1)
            if n + 1 >= ROW_STRIKE_LIMIT:
                self._mark_embed_failed(idx, epoch)

    def _mark_embed_failed(self, idx: int, epoch: int) -> None:
        """Terminal per-row failure: clear the request labels and bump
        so a blocked client unblocks (it finds no vector and degrades
        client-side) instead of waiting out its timeout against a row
        that will never embed.  Epoch-gated like every other terminal
        path: a client rewrite racing the final strike must keep ITS
        request — the new epoch re-candidates the row with a clean
        slate instead of being silently dropped."""
        st = self.store
        self._strikes.pop(idx, None)
        try:
            if st.epoch_at(idx) != epoch:
                return                # rewritten mid-strike: keep it
            self.stats.embed_failed += 1
            self._pending.discard(idx)
            key = st.key_at(idx)
            if key is not None:
                st.label_clear(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
                st.bump(key)
            self._known_epochs[idx] = st.epoch_at(idx)
        except (KeyError, OSError):
            pass
        log.error("row %d failed %d encode attempts; giving up",
                  idx, ROW_STRIKE_LIMIT)

    def _admission(self, rows: list[int]) -> list[int]:
        """Multi-tenant QoS over one drain's candidates: expired
        deadlines fail fast, the fairness-ordered admit set (up to
        admit_cap) proceeds, overflow past queue_high_water is shed,
        the rest stay pending with their tenants' stride credit
        intact.  With no QoS config and no stamped rows this is a
        cheap pass-through."""
        labels_of = self._row_labels
        qos_rows: list[WaitingRow] = []
        tagged = False
        for idx in rows:
            labels = labels_of.get(idx, 0)
            deadline = None
            if labels & P.LBL_DEADLINE:
                deadline = P.read_deadline(
                    self.store, idx, epoch=self.store.epoch_at(idx))
            tenant = P.read_tenant(labels)
            tagged = tagged or tenant or deadline is not None
            qos_rows.append(WaitingRow(idx, tenant, deadline))
        if not tagged and self.admit_cap is None \
                and self.qos.high_water is None:
            self._had_deferred = False
            return rows
        cap = self.admit_cap if self.admit_cap else len(rows)
        plan = self.qos.plan(qos_rows, cap)
        for row in plan.expired:
            self._fail_deadline(row.item, row.tenant)
        for row in plan.shed:
            self._shed_row(row.item, row.tenant)
        self.stats.deferred += len(plan.deferred)
        self._had_deferred = bool(plan.deferred)
        for row in plan.admit:
            if row.tenant or row.deadline is not None:
                self.tenants.bump(row.tenant, "admitted")
            if row.deadline is not None:
                P.clear_deadline(self.store, row.item)
        # deferred rows stay in the pending set — the next drain (the
        # work-conserving re-drain in run(), or the next wake)
        # reconsiders them
        self._pending.update(row.item for row in plan.deferred)
        return [row.item for row in plan.admit]

    def _reject_row(self, idx: int, status: str,
                    tenant: int = 0) -> None:
        """Shared terminal-reject tail for deadline expiry and shed:
        ZERO the vector lane first — a re-embed request's slot still
        holds the PREVIOUS text's vector, and without the scrub a
        rejected update would be indistinguishable from success (the
        client would read the stale vector as the new embedding; the
        contract is cleared label + zero vector = not embedded) —
        then unblock the row (labels cleared, bump).  The slot's text
        is untouched; a rewrite re-candidates it."""
        st = self.store
        self._pending.discard(idx)
        P.clear_deadline(st, idx)
        # a rejected request's trace context must not leak — and the
        # reject IS the request's whole service, so it gets a typed
        # span like every other lane's shed path (begin consumes the
        # stamp; an untraced row costs one label test)
        try:
            if st.labels_at(idx) & P.LBL_TRACED:
                self.spans.commit(
                    self.spans.begin(idx, st.epoch_at(idx),
                                     tenant=tenant),
                    status=status)
        except (KeyError, OSError):
            pass
        P.clear_span_stage(st, idx)
        try:
            st.vec_set_at(idx, np.zeros(st.vec_dim, np.float32))
            key = st.key_at(idx)
            if key is not None:
                st.label_clear(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
                st.bump(key)
            self._known_epochs[idx] = st.epoch_at(idx)
        except (KeyError, OSError):
            pass

    def _fail_deadline(self, idx: int, tenant: int) -> None:
        """Deadline fast-fail: the client stopped waiting — unblock
        the row without spending a batch slot on a vector nobody
        reads."""
        self.stats.deadline_expired += 1
        self.tenants.bump(tenant, "deadline_expired")
        self._reject_row(idx, P.ERR_DEADLINE, tenant)

    def _shed_row(self, idx: int, tenant: int) -> None:
        """High-water shed: unblock the row label-only (the embed slot
        holds the client's text, so there is no value channel for a
        typed record — the cleared label + zero vector IS the signal,
        and the heartbeat's shed / per-tenant counters plus
        qos.retry_after_ms tell a monitoring client when to retry)."""
        self.stats.shed += 1
        self.tenants.bump(tenant, "shed")
        self._reject_row(idx, P.ERR_OVERLOADED, tenant)

    def process_rows(self, rows: list[int]) -> int:
        """Embed a set of candidate slot indices; returns committed count.

        The drain is a two-lane pipeline feeding a CommitPipeline:
        tiny drains (<= probe_batch_max rows — latency probes, single
        hot keys) short-circuit straight to tokenize->dispatch on the
        pre-compiled small-bucket programs; everything bigger runs the
        windowed big-batch lane, where the host stages window k+1
        (tokenize/bucket/pad/gather) while window k's encode runs on
        the device, and finished futures commit the moment they
        complete — the wake handler never parks on a device round-trip
        it could overlap."""
        st = self.store
        # armed BEFORE the candidate filter: it discovers traced rows
        # from the label word it reads anyway (zero extra store ops).
        # Always armed — an untraced daemon must still SHED stamps an
        # instrumented client leaves, or every stamped request leaks a
        # __tr_<idx> key + a permanent LBL_TRACED bit
        self._traced_hits = []
        rows = self._admission(self._candidates(rows))
        if not rows:
            self._traced_hits = None
            return 0
        self._pending.update(rows)            # until each row resolves
        keep, texts, epochs = self._gather(rows)
        if not keep:
            return 0
        traced = self._begin_trace(keep, epochs)

        t_start = Store.now()
        faults0 = self.stats.batch_faults
        pipe = CommitPipeline(
            lambda r, e, v: self._commit_batch(r, e, v, t_start),
            self.stats, self.inflight_depth,
            stage_acc=self._stage_acc,
            on_error=self._on_batch_error)
        if len(keep) <= self.probe_batch_max:
            self.stats.probe_lane_hits += 1
            out = self._guard_rows(keep, texts, epochs)
            if out[0]:
                self._dispatch_guarded(pipe, *out)
        else:
            self._drain_windowed(pipe, keep, texts, epochs)
        pipe.flush()
        self._end_trace(traced)
        if (self._cap_degraded is not None
                and self.stats.batch_faults == faults0):
            # clean drain under a degraded cap: restore multiplicatively
            # (the additive-increase analog of the halving decrease)
            self._cap_degraded *= 2
            if self._cap_degraded >= self.batch_cap:
                self._cap_degraded = None

        self.stats.embedded += pipe.committed
        if pipe.committed and P.KEY_DONE_LANE in st:
            st.bump(P.KEY_DONE_LANE)
        return pipe.committed

    # -- flight recording --------------------------------------------------

    def _begin_trace(self, keep: list[int],
                     epochs: list[int]) -> list | None:
        """Arm the drain's PIPELINE_STAGES accumulator and open spans
        for the LBL_TRACED rows the candidate filter flagged.  Span
        capture is ALWAYS on (bounded by head sampling — only stamped
        rows pay anything); the histogram tracer additionally arms
        the stage accumulator when SPTPU_TRACE=1.  Stamps are
        epoch-checked against the gathered request: a stale stamp (a
        request serviced before its stamp landed) is consumed, never
        attributed to this drain.  begin() consumes the stamp while
        the slot is still this request's (the consume-early
        discipline) and the span record buffers until the heartbeat-
        cadence flush."""
        hits, self._traced_hits = self._traced_hits, None
        self._live_spans = []
        if tracer.enabled:
            acc = dict.fromkeys(P.PIPELINE_STAGES, 0.0)
            # the drain stage: signal drain + candidate filter +
            # seqlock gather — everything between the wake and the
            # first tokenize (disjoint from the other stages; the
            # WHOLE drain's wall, stages nested, is embed.drain_cycle)
            if self._drain_t0 is not None:
                acc["drain"] = \
                    (time.perf_counter() - self._drain_t0) * 1e3
                self._drain_t0 = None
                tracer.record("embed.drain", acc["drain"])
            self._stage_acc = acc
        else:
            self._stage_acc = None
        traced = []
        if hits:
            kept = {idx: e for idx, e in zip(keep, epochs)}
            for idx in hits:
                if idx not in kept:
                    continue          # torn/raced: retried next drain
                span = self.spans.begin(
                    idx, kept[idx],
                    tenant=P.read_tenant(
                        self._row_labels.get(idx, 0)))
                if span is None:
                    continue          # stale stamp: already shed
                self._live_spans.append(span)
                if tracer.enabled:
                    traced.append((span.key, span.tid, span.t_queue))
        return traced

    def _end_trace(self, traced: list | None) -> None:
        """Commit the drain's spans and emit one flight-recorder
        record per traced request: the drain's stage sums as an
        ordered wake->commit event sequence, wall time measured from
        the client's stamp timestamp."""
        acc, self._stage_acc = self._stage_acc, None
        spans, self._live_spans = self._live_spans, []
        stage_map = ({s: acc[s] for s in P.PIPELINE_STAGES}
                     if acc is not None else None)
        # the drain's device window (dispatch->collect wall across all
        # its encode programs) rides the FIRST committed span —
        # drain-scoped attribution, see SpanWriter.commit
        device_ms = DEVTIME.take_lane_ms("embedder")
        for i, span in enumerate(spans):
            self.spans.commit(span, stages=stage_map,
                              device_ms=device_ms if i == 0 else None)
        if acc is None:
            return
        # e2e records for EVERY traced drain (not just stamped ones):
        # the heartbeat's e2e quantiles must sample the same
        # population as the per-stage quantiles, or comparing them is
        # comparing different workloads
        stage_sum = sum(acc.values())
        tracer.record("embed.e2e", stage_sum)
        if not spans:
            # tail-based retention: a drain past the slow threshold
            # whose requests carried no trace stamp still keeps full
            # stage detail — one synthesized `tail: true` span, and a
            # recorder entry under the same trace id so the slow log
            # resolves via `spt trace show`
            thr = self.recorder.slow_threshold_ms()
            if thr is not None and stage_sum > thr:
                tid = self.spans.tail_span(
                    "<drain>", stage_sum, stages=stage_map,
                    device_ms=device_ms if device_ms > 0 else None)
                if tid is not None:
                    self.recorder.record(
                        tid, "<drain>", stage_sum,
                        [[s, round(acc[s], 3)]
                         for s in P.PIPELINE_STAGES])
        if not traced:
            return
        now_wall = time.time()
        events = [[s, round(acc[s], 3)] for s in P.PIPELINE_STAGES]
        for key, tid, ts in traced:
            wall = (now_wall - ts) * 1e3 if ts > 0 else stage_sum
            self.recorder.record(tid, key, wall,
                                 [list(e) for e in events])

    def _drain_windowed(self, pipe: CommitPipeline, keep, texts,
                        epochs) -> None:
        # order the drain by text byte length (a cheap token-count
        # proxy): windows become nearly bucket-homogeneous, so the
        # bucket grouping fills whole batch_cap batches instead of
        # fragmenting every window into per-bucket stragglers
        order = sorted(range(len(keep)), key=lambda i: len(texts[i]))
        keep = [keep[i] for i in order]
        texts = [texts[i] for i in order]
        epochs = [epochs[i] for i in order]

        # guard + tokenize run per window (a few batch_caps): the fused
        # tokenization materializes (window, max_len) ids, which must
        # stay bounded on huge drains (backfill sweeps), while giving
        # the bucket grouping enough rows to fill homogeneous batches.
        # While this window's encodes fly, the next window tokenizes —
        # and any future that lands mid-stage commits via drain_ready.
        window = max(self.batch_cap * 4, 512)
        for lo in range(0, len(keep), window):
            ch = slice(lo, lo + window)
            out = self._guard_rows(keep[ch], texts[ch], epochs[ch])
            if out[0]:
                self._dispatch_guarded(pipe, *out)
            pipe.drain_ready()

    def _guard_rows(self, ch_rows, ch_texts, ch_eps):
        """Context-window guard (reference: splinference.cpp:226-233)
        over one gather window; violators are marked ctx-exceeded.
        Returns (ok_rows, ok_texts, ok_epochs, ok_i, ids, lens) — ids
        is None outside the fused model path."""
        t0 = time.perf_counter()
        too_long, ids, lens = self._ctx_flags_and_ids(ch_texts)
        if tracer.enabled:
            dt = (time.perf_counter() - t0) * 1e3
            tracer.record("embed.tokenize", dt)
            if self._stage_acc is not None:
                self._stage_acc["tokenize"] += dt
        ok_rows, ok_texts, ok_epochs, ok_i = [], [], [], []
        for j, (idx, text, e) in enumerate(
                zip(ch_rows, ch_texts, ch_eps)):
            if too_long[j]:
                self._mark_ctx_exceeded(idx)
            else:
                ok_rows.append(idx)
                ok_texts.append(text)
                ok_epochs.append(e)
                ok_i.append(j)
        return ok_rows, ok_texts, ok_epochs, ok_i, ids, lens

    def _dispatch_guarded(self, pipe: CommitPipeline, ok_rows, ok_texts,
                          ok_epochs, ok_i, ids, lens) -> None:
        """Dispatch one guarded window into the pipeline WITHOUT forcing
        any result (the span measures host-side dispatch; device time
        surfaces as embed.device_wait only when the host truly blocks)."""
        from ..models.encoder import PendingEmbeddings

        acc = self._stage_acc
        # pipe.push may commit ready futures inline (drain_ready):
        # that wall belongs to device_wait/commit, which _resolve
        # accrues itself — subtract it so the stage values stay
        # disjoint (the drain stages must sum to the drain, not above)
        nested0 = (acc["commit"] + acc["device_wait"]) \
            if acc is not None else 0.0
        t0 = time.perf_counter()
        if ids is not None:
            # ids already tokenized by the guard pass: group by
            # per-row bucket and dispatch async
            rows_a = np.asarray(ok_rows)
            eps_a = np.asarray(ok_epochs)
            for ss, pend in self._dispatch_bucketed(
                    ids[ok_i], lens[ok_i]):
                pipe.push([int(x) for x in rows_a[ss]],
                          [int(x) for x in eps_a[ss]], pend)
        else:
            cap = self.effective_batch_cap
            for slo in range(0, len(ok_rows), cap):
                sl = slice(slo, slo + cap)
                try:
                    # splint: ignore[SPL201] reason=the custom-encoder inline lane: encoder_fn is a user callable with no async contract (usually host numpy already) — the model path resolves through PendingEmbeddings instead
                    vecs = np.asarray(self.encoder_fn(ok_texts[sl]),
                                      np.float32)
                except Exception as ex:
                    # a raising encoder_fn fails its slice alone (the
                    # model path's materialize failures resolve inside
                    # the pipeline; this is the inline-encode analog)
                    self._on_batch_error(ok_rows[sl], ok_epochs[sl], ex)
                    continue
                pipe.push(ok_rows[sl], ok_epochs[sl],
                          PendingEmbeddings(vecs, len(vecs)))
        if tracer.enabled:
            nested = (acc["commit"] + acc["device_wait"] - nested0) \
                if acc is not None else 0.0
            dt = max((time.perf_counter() - t0) * 1e3 - nested, 0.0)
            tracer.record("embed.dispatch", dt)
            if acc is not None:
                acc["dispatch"] += dt

    def _commit_batch(self, ok_rows, ok_epochs, vecs: np.ndarray,
                      t_start: int) -> int:
        """Epoch-gated bulk vector commit + per-row protocol tail
        (labels, ctime stamp, the reference's epoch==pre+2 race check,
        splinference.cpp:275-287).  Returns the committed count."""
        fault("embedder.commit")
        st = self.store
        committed = 0
        results = st.vec_commit_batch(
            np.asarray(ok_rows, np.uint32),
            np.asarray(ok_epochs, np.uint64),
            vecs, write_once=self.vector_training)
        self.stats.batches += 1
        for idx, e, r in zip(ok_rows, ok_epochs, results):
            if r == 0:
                committed += 1
                self._strikes.pop(idx, None)  # clean commit: slate wiped
                expected = e + 2              # our commit's epoch bump
                key = st.key_at(idx)
                if key is not None:
                    st.label_clear(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
                    try:
                        st.stamp(key, which=0,
                                 ticks_ago=Store.now() - t_start)
                        expected += 2         # stamp's epoch bump
                    except Exception:
                        pass
                # a content writer racing between our commit and here
                # must not be masked: only record the slot as done if
                # the epoch is exactly what OUR mutations produced
                if st.epoch_at(idx) == expected:
                    self._known_epochs[idx] = expected
                    self._pending.discard(idx)
                else:
                    self._known_epochs.pop(idx, None)
                    if key is not None:
                        try:  # restore the wake label we cleared
                            st.label_or(key, P.LBL_EMBED_REQ)
                        except KeyError:
                            pass
            elif r == -17:  # EEXIST: write-once gate
                self.stats.skipped_write_once += 1
                self._known_epochs[idx] = e
                self._pending.discard(idx)
            else:           # ESTALE: raced with a writer; retry later
                self.stats.raced += 1
        return committed

    def drain(self, *, sweep: bool = False) -> int:
        """One drain cycle.  The hot path (sweep=False) is fed ONLY by
        the dirty mask + the carried pending set — cost proportional to
        actual write traffic, independent of nslots.  sweep=True adds
        the O(nslots) label enumeration (cold start, --oneshot, and the
        periodic reconciliation that catches labels whose dirty bits a
        crashed consumer drained and lost)."""
        st = self.store
        # trace anchor: _begin_trace turns this into the per-request
        # "drain" stage (wake -> first tokenize).  The WHOLE drain's
        # wall — stages nested, empty idle sweeps included — records
        # separately as drain_cycle, so the PIPELINE_STAGES "drain"
        # histogram and the flight-recorder "drain" event measure the
        # same disjoint slice
        self._drain_t0 = time.perf_counter() if tracer.enabled else None
        with tracer.span("embed.drain_cycle"):
            fault("embedder.drain")
            self.stripes.refresh()    # a re-stripe lands HERE, at the
            bits = st.drain_dirty()   # drain boundary
            rows = set(st.dirty_to_indices(bits))
            rows.update(self._pending)
            if sweep or self.stripes.epoch or self.replica:
                # striped deployments sweep EVERY drain: drain_dirty
                # is fetch-and-clear store-global, so a peer replica's
                # drain eats the dirty bits for rows in OUR stripes —
                # without the label walk those rows would wait out the
                # 10s reconcile cadence (the searcher pays the same
                # enumeration every drain)
                rows.update(st.enumerate_indices(P.LBL_EMBED_REQ))
            if self._bid >= 0:
                try:
                    st.shard_rebid(self._bid)
                    st.madvise(self._bid, N.ADV_WILLNEED, timeout_ms=0)
                except OSError:
                    pass
            if not rows:
                self._had_deferred = False    # nothing pending: the
                return 0                      # redrain loop must end
            # device profile only around real work: a busy daemon runs
            # many empty sweep drains per second — capturing those
            # would pile up trace dirs with nothing in them
            with device_profile("drain"):
                return self.process_rows(sorted(rows))

    def run_once(self) -> int:
        """One full drain cycle (--oneshot): dirty mask + label sweep.
        Buffered span records flush here (oneshot = drain to a
        consistent observable state); the run loop flushes them on
        the heartbeat cadence instead."""
        n = self.drain(sweep=True)
        self.spans.flush()
        return n

    def publish_stats(self) -> None:
        """Heartbeat: JSON stats snapshot into the debug-labeled
        __embedder_stats key (observability counterpart of the
        reference's __debug channel; the sidecar's group-63 watch
        surfaces every update)."""
        self.spans.flush()            # heartbeat cadence, off the
        payload = {**dataclasses.asdict(self.stats),  # wake path
                   "spans_obs": self.spans.counters(),
                   "overlap_ratio": round(self.stats.overlap_ratio(), 4),
                   "generation": self.generation,
                   "pending": len(self._pending)}
        if self.replica or self.stripes.epoch:
            payload["replica"] = self.replica
            payload["stripe"] = self.stripes.snapshot()
        # dispatch-overlap gauges ride their own SECTION so a tiny
        # store's max_val drops them (publish_heartbeat's size
        # degradation) instead of losing the whole heartbeat; `spt
        # metrics` renders them flat (sptpu_embedder_ring_depth etc.).
        # Saturation of the overlap window is visible when
        # ring_occupancy pins at ring_depth / inflight_peak pins at
        # inflight_depth.
        payload["dispatch"] = {
            "inflight_depth": self.inflight_depth,
            "ring_depth": self.ring_depth,
            **{k: payload.pop(k)
               for k in ("ring_dispatches", "resident_iterations",
                         "ring_occupancy", "ring_occupancy_peak",
                         "ring_faults")}}
        if self.admit_cap or self.qos.high_water is not None:
            payload["qos"] = {
                "admit_cap": self.admit_cap or 0,
                "queue_high_water": self.qos.high_water
                if self.qos.high_water is not None else -1,
                "retry_after_ms": self.qos.retry_after_ms}
        tenants = self.tenants.snapshot()
        if tenants:
            # per-tenant admitted/shed/deadline_expired counters —
            # `spt metrics` renders one labeled series per tenant
            payload["tenants"] = tenants
        prune_idle_counters(
            payload, bool(self.admit_cap
                          or self.qos.high_water is not None
                          or tenants))
        if faults.armed():
            payload["faults"] = faults.stats()
        model = getattr(self, "_model", None)
        if model is not None and hasattr(model, "compile_count"):
            payload["compile_count"] = model.compile_count()
        # device-time & compile attribution: runtime-cause compile
        # count (must stay 0 after warmup) + per-program device
        # quantiles; the buffered ledger lands in the __compile_<i>
        # ring on the same cadence
        payload["compile_events"] = DEVTIME.compile_events("embedder")
        devtime = DEVTIME.heartbeat_section("embedder")
        if devtime:
            payload["devtime"] = devtime
        # this process's hand-written kernel launches by name (the
        # counterpart of the JAX lanes' device-program ledger in
        # devtime), in the size-droppable "dispatch" section that `spt
        # metrics` renders flat: sptpu_<lane>_kernel_<name>
        payload.setdefault("dispatch", {}).update(
            LAUNCHES.heartbeat_fields())
        DEVTIME.flush(self.store)
        for k in ("device_wait_ms", "overlap_ms", "commit_host_ms"):
            payload[k] = round(payload[k], 3)
        if tracer.enabled:
            # histogram-sourced per-stage quantiles under the
            # PIPELINE_STAGES names — what bench.py's stage table and
            # `spt metrics` consume (true percentiles, never means)
            P.attach_trace_sections(payload, tracer, self.recorder,
                                    "embed.")
        P.publish_heartbeat(self.store, self._hb_key, payload)
        if tracer.enabled:
            # the flight-recorder ring rides its own key so `spt trace
            # tail` reconstructs individual requests cross-process
            self._trace_published = P.maybe_publish_trace_ring(
                self.store, self._trace_key, self.recorder,
                self._trace_published)

    def run(self, *, idle_timeout_ms: int = 100,
            stop_after: float | None = None,
            sweep_interval_s: float = 10.0) -> None:
        """The daemon loop: block on the signal group, drain, repeat.
        Each periodic sweep also publishes the stats heartbeat."""
        self._running = True
        last = self.store.signal_count(self.group)
        deadline = (time.monotonic() + stop_after) if stop_after else None
        next_sweep = time.monotonic() + sweep_interval_s
        next_retire_check = 0.0
        # first heartbeat NOW, not a sweep interval away: it is the
        # attach-complete signal the supervisor's scale-up promotion
        # (and every liveness probe) waits on
        self.publish_stats()
        while self._running:
            got = self.store.signal_wait(self.group, last,
                                         timeout_ms=idle_timeout_ms)
            now = time.monotonic()
            do_sweep = now >= next_sweep
            if do_sweep:
                next_sweep = now + sweep_interval_s
            # loop-level exception firewall: per-batch failures are
            # absorbed inside process_rows (_on_batch_error); anything
            # reaching here is a gather/store-level surprise — log and
            # keep serving, the run loop never unwinds
            try:
                if got is not None:
                    last = got
                    self.stats.wakes += 1
                    self.drain(sweep=do_sweep)
                    # work-conserving under admit_cap: deferred rows
                    # stay in the pending set — re-drain immediately
                    # in fair slices instead of waiting for the next
                    # wake or the sweep cadence
                    redrains = 0
                    while self._had_deferred and self._running \
                            and redrains < 256:
                        redrains += 1
                        self.drain()
                elif do_sweep:
                    # periodic reconciliation only — an idle daemon
                    # must not walk the whole label lane on every idle
                    # timeout.  A restarted daemon's first sweep also
                    # reclaims requests a crashed predecessor stranded
                    # (label bit set, no inflight owner).
                    self.drain(sweep=True)
                if do_sweep:
                    self.publish_stats()
                if self.replica and now >= next_retire_check:
                    # scale-down drain (own 1s cadence — the sweep
                    # interval is slower than the supervisor's drain
                    # deadline): the supervisor closed our stripes;
                    # the drains above finished any in-flight work,
                    # so exit cleanly and let it reap us
                    next_retire_check = now + 1.0
                    if self.stripes.poll_retired():
                        log.info("replica %d destriped — retiring",
                                 self.replica)
                        self.publish_stats()
                        break
            except Exception:
                self.stats.drain_faults += 1
                log.exception("run loop cycle failed; continuing")
            if deadline and now > deadline:
                break

    def stop(self) -> None:
        self._running = False

    # -- backfill ----------------------------------------------------------

    def backfill(self) -> int:
        """Sweep: embed every VARTEXT key whose vector is all zeros
        (reference --backfill-text-keys, splinference.cpp:289-325).
        Re-bids SEQUENTIAL at backfill priority for the sweep."""
        st = self.store
        bid = -1
        try:
            bid = st.shard_claim(P.SHARD_EMBED, N.ADV_SEQUENTIAL,
                                 P.PRIO_EMBED_BACKFILL, 30_000_000)
            st.madvise(bid, N.ADV_SEQUENTIAL, timeout_ms=0)
        except OSError:
            pass
        vecs = st.vectors
        zero = np.abs(vecs).max(axis=1) == 0
        rows = []
        for idx in np.nonzero(zero)[0]:
            idx = int(idx)
            if st.epoch_at(idx) == 0:
                continue                      # empty slot
            if not st.flags_at(idx) & N.T_VARTEXT:
                continue
            self._known_epochs.pop(idx, None)
            key = st.key_at(idx)
            if key is not None:
                st.label_or(key, P.LBL_EMBED_REQ)
            rows.append(idx)
        n = self.process_rows(rows)
        self.stats.backfilled += n
        if bid >= 0:
            st.shard_release(bid)
        return n


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu_torch.engine.embedder
    --store NAME [--device cuda|cpu]"""
    import argparse

    from ..utils.device import DEVICE_CHOICES

    ap = argparse.ArgumentParser(
        description="splinter-tpu embedding daemon, PyTorch port "
                    "(micro-batched encoder on the card over the store's "
                    "event bus)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--device", choices=DEVICE_CHOICES, default="cuda",
                    help="run the encoder on the card (default) or on "
                         "the CPU with the kernels' plain versions; "
                         "never falls back from one to the other")
    ap.add_argument("--oneshot", action="store_true")
    ap.add_argument("--backfill-text-keys", action="store_true")
    ap.add_argument("--vector-training", action="store_true",
                    help="write-once vectors: never overwrite an existing "
                         "non-zero embedding")
    ap.add_argument("--max-ctx", type=int, default=None,
                    help="context window override (default: a .gguf's "
                         "context length, else 2048)")
    ap.add_argument("--batch-cap", type=int, default=256,
                    help="rows per encode batch (padding bucket "
                         "grouping happens under this cap)")
    ap.add_argument("--ring-depth", type=int, default=None,
                    help="service up to this many full same-bucket "
                         "batches per ring dispatch (default 8, <=1 "
                         "disables)")
    ap.add_argument("--inflight-depth", type=int, default=None,
                    help="K-deep dispatch overlap: un-awaited encode "
                         "futures held before the host blocks on the "
                         "oldest (default 2)")
    ap.add_argument("--idle-timeout-ms", type=int, default=100)
    ap.add_argument("--replica", type=int, default=0,
                    help="striped replica index (elastic lanes): "
                         "drain only the slot-index stripes the "
                         "lane's stripe map assigns this replica; "
                         "heartbeat publishes replica-suffixed "
                         "(__embedder_stats.rN)")
    ap.add_argument("--admit-cap", type=int, default=None,
                    help="multi-tenant QoS: max rows embedded per "
                         "drain (fairness granularity; backlog stays "
                         "pending with stride credit; default: "
                         "unlimited)")
    ap.add_argument("--queue-high-water", type=int, default=None,
                    help="multi-tenant QoS: max deferred backlog — "
                         "overflow rows are unblocked label-only "
                         "(shed; the heartbeat counters carry the "
                         "evidence; default: never shed)")
    ap.add_argument("--retry-after-ms", type=int, default=None,
                    help="retry hint published in the qos heartbeat "
                         "section when shedding")
    ap.add_argument("--tenant-weights", default=None,
                    help="per-tenant fair-share weights, "
                         "TENANT:W[,TENANT:W...] (unlisted weigh 1)")
    ap.add_argument("--warmup", action="store_true",
                    help="run the (1, bucket) and (batch_cap, bucket) "
                         "encoder shapes once before serving")
    ap.add_argument("--weights",
                    help="encoder checkpoint: .gguf (geometry, tokenizer "
                         "and weights all from the file) or .safetensors "
                         "(HF naming; default geometry, hashed-vocab "
                         "tokenizer)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from ..models import (EmbeddingModel, EncoderConfig, GgufFile,
                          encoder_config_from_gguf, load_tokenizer)

    store = Store.open(args.store, persistent=args.persistent)
    tokenizer = None
    if args.weights and args.weights.endswith(".gguf"):
        overrides = {"max_len": args.max_ctx} if args.max_ctx else {}
        with GgufFile(args.weights) as gf:   # parse the container once
            cfg = encoder_config_from_gguf(gf, out_dim=store.vec_dim,
                                           **overrides)
            tokenizer = load_tokenizer(gf)
    else:
        cfg = EncoderConfig(out_dim=store.vec_dim,
                            max_len=args.max_ctx or 2048)
        if args.weights:
            log.warning(
                "--weights %s has no tokenizer metadata; falling back to "
                "the hashed-vocab tokenizer, which will NOT match a real "
                "checkpoint's vocabulary — use the model's .gguf export",
                args.weights)
    model = EmbeddingModel(cfg, weights=args.weights, device=args.device)
    emb = Embedder(store, model=model, tokenizer=tokenizer,
                   max_ctx=cfg.max_len,
                   batch_cap=args.batch_cap,
                   ring_depth=args.ring_depth,
                   inflight_depth=args.inflight_depth,
                   vector_training=args.vector_training,
                   admit_cap=args.admit_cap,
                   queue_high_water=args.queue_high_water,
                   retry_after_ms=args.retry_after_ms,
                   tenant_weights=parse_tenant_weights(
                       args.tenant_weights),
                   replica=args.replica)
    emb.attach()
    if args.warmup:
        t0 = time.monotonic()
        # probe-lane pad sizes (powers of two up to probe_batch_max)
        # run too, or the first latency probe of each size pays its
        # first-shape cost on the wake path
        probe_pads = []
        b = 1
        while b <= emb.probe_batch_max:
            probe_pads.append(b)
            b *= 2
        emb._model.warmup(
            batch_sizes=tuple(dict.fromkeys(probe_pads
                                            + [emb.batch_cap])))
        emb._model.warmup_ring(emb.ring_depth, emb.batch_cap)
        log.info("warmup ran in %.1fs", time.monotonic() - t0)
    if args.backfill_text_keys:
        n = emb.backfill()
        log.info("backfill embedded %d keys", n)
    if args.oneshot:
        n = emb.run_once()
        log.info("oneshot embedded %d keys", n)
        return 0
    try:
        emb.run(idle_timeout_ms=args.idle_timeout_ms)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
