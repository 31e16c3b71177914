"""Event-driven query-coalescing search daemon (PyTorch, on the card).

The torch counterpart of the JAX package's searcher.  Scoring runs
server-side, one device dispatch per coalesced batch instead of one
per client, mirroring the embedder's drain/wake structure
(engine/embedder.py):

  - blocks on the store's signal group (LBL_SEARCH_REQ label watch);
  - drains ALL pending search requests per wake and COALESCES them
    into QB-bucketed batches through the top-k programs
    (ops/similarity.topk_program — kernel K2, the fused streaming
    top-k, for k <= FUSED_K_MAX; kernel K3 + a stable sort beyond);
  - scores against its own StagedLane (full upload once, O(dirty)
    refresh per drain);
  - commits per-request results back as __sr_<idx> rows and clears
    the request label — N concurrent clients cost ceil(N / QB)
    device dispatches, not N.

Request contract (one slot per request):
  value       JSON {"k": int, "bloom": int?} — the search params
  vector lane the query vector in the SAME slot (the embedding daemon
              puts it there when the client labels its scratch key
              LBL_EMBED_REQ first — the classic CLI flow — or the
              client writes it directly with vec_set)
  labels      LBL_SEARCH_REQ (+ LBL_WAITING), then bump.

Result contract: JSON in search_result_key(request_slot_index) —
{"s": scores, "i": slot indices, "keys": resolved keys, "fetched": K,
"n": valid candidate count} — sorted by similarity desc, system keys
("__" prefix: scratch rows, heartbeats, other requests' slots)
already dropped.  The daemon clears LBL_SEARCH_REQ + LBL_WAITING and
bumps the request key; clients poll their own request key.  A request
whose slot changed mid-service (epoch mismatch) is NOT committed and
is retried next drain — the embedder's race discipline.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Sequence

import numpy as np

import torch

from .. import _native as N
from ..obs.devtime import DEVTIME
from ..obs.recorder import FlightRecorder
from ..obs.spans import SpanWriter, sweep_span_stages
from ..store import Store
from ..ops._cuda import LAUNCHES
from ..ops.similarity import fetch_topk
from ..utils import faults
from ..utils.device import DeviceFuture
from ..utils.faults import fault
from ..utils.trace import device_profile, tracer
from . import protocol as P
from .qos import (AdmissionController, TenantLedger, WaitingRow,
                  parse_tenant_weights, prune_idle_counters)
from .resident import CallbackWindow

log = logging.getLogger("libsplinter_tpu_torch.searcher")

# query-count pad buckets: a drain's requests batch into the smallest
# bucket that holds them (chunked through the largest otherwise), so
# the daemon runs a handful of shapes, not one per concurrency level.
# The floor of 8 matches the kernels' narrowest query tile — a single
# query already computes 8 columns, so coalescing up to 8 is free.
QB_BUCKETS = (8, 32, 256)

# fetch-k pad buckets (candidates pulled per query).  Bounded by
# ops.similarity.FUSED_K_MAX — the cushion above the request's k
# absorbs post-select drops (system keys, the requester's own row).
K_BUCKETS = (16, 32, 64, 128)
K_CUSHION = 4

# orphaned __sr_<idx> result rows older than this are reaped by the
# periodic sweep (a client that timed out never calls consume_result);
# generous vs the CLI's 2 s submit timeout so no live poller races it
RESULT_TTL_S = 120.0


def _k_bucket(k: int) -> int:
    for b in K_BUCKETS:
        if k <= b:
            return b
    return k                     # beyond the schedule: exact (legacy path)


def _qb_chunks(nq: int) -> list[int]:
    """Decompose a drain's query count into QB bucket sizes with
    padding waste bounded at 2x (the StagedLane _chunk_plan
    discipline): 40 queries batch as [32, 8], never one 256-query
    dispatch scoring 216 zero rows."""
    out: list[int] = []
    smallest, largest = QB_BUCKETS[0], QB_BUCKETS[-1]
    while nq > 0:
        if nq >= largest:
            out.append(largest)
            nq -= largest
            continue
        cover = next(b for b in QB_BUCKETS if nq <= b)
        if cover <= 2 * nq or cover == smallest:
            out.append(cover)                 # tail: waste <= 2x
            break
        out.append(max(b for b in QB_BUCKETS if b <= nq))
        nq -= out[-1]
    return out


@dataclasses.dataclass
class SearcherStats:
    wakes: int = 0
    drains: int = 0
    requests: int = 0            # requests gathered (incl. retried)
    served: int = 0              # results committed
    dispatches: int = 0          # device top-k program calls
    coalesced_max: int = 0       # most requests in one dispatch
    parse_errors: int = 0        # malformed / vectorless requests
    raced: int = 0               # slot changed mid-service; retried
    full_refreshes: int = 0      # lane full uploads
    # -- K-deep dispatch overlap (engine/resident.py): batch k's
    # select+commit resolve while batches k+1..k+K compute ---------
    inflight_peak: int = 0       # max un-awaited batch dispatches held
    ready_selects: int = 0       # batch already complete at select
    blocking_selects: int = 0    # host blocked on the device fetch
    # -- failure-domain accounting (the per-batch firewall) ----------
    batch_faults: int = 0        # batches that failed and degraded
    retried_unfused: int = 0     # recovered by the unfused retry
    retried_single: int = 0      # requests recovered one-by-one
    req_failures: int = 0        # requests failed with error records
    drain_faults: int = 0        # whole drains failed by the firewall
    results_reaped: int = 0      # orphaned __sr_ rows retired
    # -- multi-tenant QoS (engine/qos.py) ----------------------------
    deadline_expired: int = 0    # fast-failed: client deadline passed
    shed: int = 0                # typed overloaded + retry_after_ms
    deferred: int = 0            # held for a later drain (fairness)

    def coalesce_ratio(self) -> float:
        """Requests served per device dispatch (1.0 = no batching win;
        the whole point of the daemon is pushing this toward QB)."""
        return self.served / self.dispatches if self.dispatches else 0.0


class _Request:
    __slots__ = ("idx", "epoch", "k", "bloom", "fast", "qvec", "stamp",
                 "tenant", "deadline", "traced", "span")

    def __init__(self, idx, epoch, k, bloom, fast, qvec, stamp,
                 tenant=0, deadline=None, traced=False):
        self.idx = idx
        self.epoch = epoch
        self.k = k
        self.bloom = bloom
        self.fast = fast         # bf16-product scoring requested
        self.qvec = qvec
        self.stamp = stamp       # (trace_id, client_wall_ts) | None
        self.tenant = tenant     # label-word tenant id (0 = untagged)
        self.deadline = deadline  # absolute wall-clock deadline | None
        self.traced = traced     # LBL_TRACED seen at gather (the span
                                 # opens at ADMISSION, not gather — a
                                 # deferred request keeps its stamp
                                 # for the drain that serves it)
        self.span = None         # obs.spans.PendingSpan | None


class Searcher:
    """The daemon object.  Drive it with run() (blocking loop) or
    run_once() (single drain — tests and --oneshot)."""

    def __init__(self, store: Store, *, lane=None,
                 group: int = P.GROUP_SEARCH,
                 mxu_bf16: bool = False,
                 fused: bool | None = None,
                 inflight_depth: int = 2,
                 coalesce_window_ms: float = 0.0,
                 admit_cap: int | None = None,
                 queue_high_water: int | None = None,
                 retry_after_ms: int | None = None,
                 tenant_weights: dict[int, float] | None = None,
                 replica: int = 0,
                 device=None):
        """device: the staged lane's home when `lane` is not given —
        "cuda" (default: kernels K2/K3) or "cpu" (their plain
        versions)."""
        from ..ops import StagedLane

        self.store = store
        self.group = group
        # elastic lanes (protocol.StripeView): replica r drains only
        # its own slot-index stripe of the request space; the map is
        # store state re-read at each drain, so a supervisor
        # re-stripe lands at the next drain boundary
        self.replica = int(replica)
        self.stripes = P.StripeView(store, "searcher", self.replica)
        self._hb_key = P.replica_stats_key(P.KEY_SEARCH_STATS,
                                           self.replica)
        self._trace_key = P.replica_stats_key(P.KEY_SEARCH_TRACE,
                                              self.replica)
        self.mxu_bf16 = mxu_bf16
        self.fused = fused
        # K-deep dispatch overlap: un-awaited top-k batch dispatches
        # held before the oldest's select+commit resolves — batch k's
        # host-side commit work overlaps the device computing batches
        # k+1..k+K, so the per-dispatch runtime round trip amortizes
        # to ~floor/K on multi-batch drains.  1 = the pre-PR-7
        # fetch-in-dispatch-order behavior.
        self.inflight_depth = max(1, inflight_depth)
        # >0: sleep this long after a wake before draining, widening
        # the coalescing window at the cost of per-request latency.
        # 0 (default): the natural window — requests landing while a
        # drain's device work flies batch into the next drain.
        self.coalesce_window_ms = coalesce_window_ms
        # multi-tenant QoS (engine/qos.py): admit_cap bounds how many
        # requests one drain services (the fairness granularity —
        # backlog beyond it re-plans next drain with accumulated
        # stride credit; None = service everything, the pre-QoS
        # behavior); queue_high_water bounds the deferred backlog —
        # overflow is shed with the typed overloaded record instead of
        # queueing unboundedly.  Deadline fast-fail is always on: a
        # request that stamps a deadline gets expiry checked whether
        # or not admission control is configured.
        self.admit_cap = admit_cap
        self.qos = AdmissionController(
            weights=tenant_weights, high_water=queue_high_water,
            **({"retry_after_ms": retry_after_ms}
               if retry_after_ms is not None else {}))
        self.tenants = TenantLedger()
        self._had_deferred = False
        self.lane = lane or StagedLane(store, device=device)
        self._all_req_rows: list[int] = []
        self.stats = SearcherStats()
        self.generation = 0          # bumped at attach (restart marker)
        self.recorder = FlightRecorder()
        self.spans = SpanWriter(store, "searcher")
        self._trace_published = 0
        self._stage_acc: dict | None = None
        self._bid = -1
        self._running = False

    # -- wiring ------------------------------------------------------------

    def attach(self) -> None:
        """Claim the shard, bind the wake label, arm/join the event
        bus — the embedder's attach sequence under the search ids."""
        st = self.store
        try:
            self._bid = st.shard_claim(P.SHARD_SEARCH, N.ADV_WILLNEED,
                                       P.PRIO_SEARCH, 30_000_000)
        except OSError:
            self._bid = -1
        st.watch_label_register(P.BIT_SEARCH_REQ, self.group)
        st.bus_attach()   # adopts the bus when a crashed owner
                          # left a dead pid in the header
        self.generation = P.bump_generation(st, self._hb_key)
        # compile events ledgered from here carry this generation —
        # a restart's re-warmup is distinguishable in the ring
        DEVTIME.generation = max(DEVTIME.generation, self.generation)

    def warmup(self, ks: Sequence[int] = (10, 64)) -> None:
        """Run the QB-bucketed top-k programs once against the live
        lane (kernel builds, the allocator's first growth) so the first
        coalesced drain of each shape does not pay them on the wake
        path.  `ks` are REQUEST k values: they map through the same
        cushion + bucket + lane clamp as a real drain's.  The defaults
        cover the CLI's limit-10 fetch (bucket 64 -> k_fetch 128) and
        direct k<=12 API requests (k_fetch 16)."""
        with DEVTIME.warmup_phase():
            arr = self.lane.refresh()
            d = self.store.vec_dim
            mask = np.ones(self.store.nslots, np.float32)
            for k in ks:
                k_fetch = min(_k_bucket(k + K_CUSHION),
                              self.store.nslots)
                # both precision variants: a --fast client's first
                # request must not stall a whole coalesced drain
                for fast in (False, True):
                    fn = self._program(k_fetch, mxu_bf16=fast)
                    for qb in QB_BUCKETS:
                        fn(arr, np.zeros((qb, d), np.float32), mask,
                           self.lane.norms)

    def _program(self, k_fetch: int, mxu_bf16: bool = False):
        from ..ops.similarity import topk_program

        return topk_program(k_fetch, batched=True,
                            mxu_bf16=self.mxu_bf16 or mxu_bf16,
                            fused=self.fused)

    # -- request gathering -------------------------------------------------

    def _gather_requests(self) -> list[_Request]:
        """Drain stage: discover labelled rows, parse params, gather
        query vectors torn-safely.  Rows mid-write stay labelled and
        retry next drain; rows with malformed params or no query
        vector get an error result immediately (they can never
        succeed, so retrying would spin)."""
        fault("searcher.gather")
        st = self.store
        self.stripes.refresh()        # a re-stripe lands HERE, at the
        rows = st.enumerate_indices(P.LBL_SEARCH_REQ)  # drain boundary
        # the UNfiltered enumeration doubles as this drain's
        # request-scratch mask input (_mask_for): a peer replica's
        # pending request rows hold query vectors too
        self._all_req_rows = [int(i) for i in rows]
        rows = [i for i in rows if self.stripes.owns(int(i))]
        if not rows:
            return []
        out: list[_Request] = []
        rows_a = np.asarray(rows, np.uint32)
        vecs, eps = st.vec_gather(rows_a)
        for j, idx in enumerate(rows):
            idx = int(idx)
            e = int(eps[j])
            if eps[j] == Store.GATHER_TORN:
                continue                      # writer active: next drain
            labels = st.labels_at(idx)
            if not labels & P.LBL_SEARCH_REQ:
                continue                      # serviced by a peer drain
            try:
                raw = st.get_at(idx)
            except (KeyError, OSError):
                continue
            if st.epoch_at(idx) != e:
                continue                      # torn: retried next wake
            self.stats.requests += 1
            try:
                req = json.loads(raw.rstrip(b"\0"))
                k = int(req["k"])
                if k <= 0:
                    raise ValueError("k must be positive")
                bloom = int(req.get("bloom", 0))
                fast = bool(req.get("fast", False))
                deadline = req.get("deadline")
                deadline = float(deadline) if deadline else None
            except (ValueError, KeyError, TypeError):
                self._fail(idx, e, "bad request params")
                continue
            # deadline may also ride the companion stamp (the generic
            # wire form the raw-text lanes use); the JSON field wins
            if deadline is None and labels & P.LBL_DEADLINE:
                deadline = P.read_deadline(st, idx, epoch=e)
            qvec = vecs[j]
            if not np.abs(qvec).max() > 0:
                self._fail(idx, e, "no query vector in request slot")
                continue
            out.append(_Request(idx, e, k, bloom, fast, qvec, None,
                                tenant=P.read_tenant(labels),
                                deadline=deadline,
                                traced=bool(labels & P.LBL_TRACED)))
        return out

    # -- admission (multi-tenant QoS) --------------------------------------

    def _admit(self, reqs: list[_Request]) -> list[_Request]:
        """Partition the gathered requests through the shared admission
        policy: expired deadlines fail fast with a typed record, the
        fairness-ordered admit set (up to admit_cap) is serviced now,
        overflow past queue_high_water is shed with `overloaded` +
        retry_after_ms, and the rest stay labelled for the next drain
        (their tenants lead it — stride state persists)."""
        if not reqs:
            self._had_deferred = False    # backlog gone (or raced):
            return reqs                   # the redrain loop must end
        cap = self.admit_cap if self.admit_cap else len(reqs)
        plan = self.qos.plan(
            [WaitingRow(r, r.tenant, r.deadline) for r in reqs], cap)
        # spans open at the admission decision, not at gather: a
        # DEFERRED request keeps its stamp (and LBL_TRACED) for the
        # drain that actually serves it.  begin() consumes the stamp
        # (the consume-early discipline; span records buffer until
        # the heartbeat-cadence flush).
        for row in (*plan.admit, *plan.expired, *plan.shed):
            r = row.item
            if r.traced:
                r.span = self.spans.begin(r.idx, r.epoch,
                                          tenant=r.tenant)
                r.stamp = r.span.stamp if r.span is not None else None
        for row in plan.expired:
            r = row.item
            self.tenants.bump(r.tenant, "deadline_expired")
            P.clear_deadline(self.store, r.idx)
            self._fail(r.idx, r.epoch, P.ERR_DEADLINE,
                       counter="deadline_expired")
            self.spans.commit(r.span, status=P.ERR_DEADLINE)
        for row in plan.shed:
            r = row.item
            self.tenants.bump(r.tenant, "shed")
            self.stats.shed += 1
            P.clear_deadline(self.store, r.idx)
            self._commit_result(
                r.idx, r.epoch,
                P.overloaded_record(self.qos.retry_after_ms))
            self.spans.commit(r.span, status=P.ERR_OVERLOADED)
        self.stats.deferred += len(plan.deferred)
        self._had_deferred = bool(plan.deferred)
        for row in plan.admit:
            if row.item.tenant or row.item.deadline is not None:
                self.tenants.bump(row.item.tenant, "admitted")
            if row.item.deadline is not None:
                P.clear_deadline(self.store, row.item.idx)
        return [row.item for row in plan.admit]

    def _fail(self, idx: int, epoch: int, err: str, *,
              counter: str = "parse_errors") -> None:
        """Terminal per-request failure: commit an error record and
        clear the labels so the client unblocks immediately instead of
        burning its timeout (parse errors and post-retry batch
        failures share this path; `counter` says which)."""
        setattr(self.stats, counter, getattr(self.stats, counter) + 1)
        self._commit_result(idx, epoch, {"err": err})

    def _fail_span(self, r: _Request) -> None:
        """Commit a FAILED request's span with a typed status — a
        trace tree must never render an error-recorded hop as ok —
        and detach it so _end_trace cannot double-commit."""
        span, r.span = r.span, None
        self.spans.commit(span, status="error")

    # -- masks -------------------------------------------------------------

    def _mask_for(self, bloom: int, req_rows: np.ndarray) -> np.ndarray:
        """Candidate mask for one bloom group (the shared
        protocol.candidate_mask definition); every CURRENT request row
        is masked out of every group (request slots hold query vectors
        — without this, concurrent similar queries would surface each
        other's scratch rows at the top).  The WHOLE enumeration the
        drain's gather captured (_all_req_rows) — not just this
        batch's rows — is what gets masked: under striped replicas a
        peer's still-pending request rows are request scratch too,
        and masking only our own stripe would make R=2 results
        diverge from R=1 (caught by tests/test_elastic.py).  Reusing
        the gather's enumeration costs no extra label scan per bloom
        group."""
        mask = P.candidate_mask(self.store, bloom)
        mask[req_rows] = 0.0
        pending = getattr(self, "_all_req_rows", None)
        if pending:
            mask[np.asarray(pending, np.int64)] = 0.0
        return mask

    # -- the drain ---------------------------------------------------------

    def drain(self, *, wake_ms: float = 0.0) -> int:
        """One drain cycle: gather -> coalesce -> dispatch -> commit.
        Returns the number of requests served."""
        st = self.store
        self.stats.drains += 1
        acc = (dict.fromkeys(P.SEARCH_STAGES, 0.0)
               if tracer.enabled else None)
        self._stage_acc = acc
        if acc is not None:
            acc["wake"] = wake_ms
        with tracer.span("search.drain_cycle"):
            t0 = time.perf_counter()
            reqs = self._admit(self._gather_requests())
            if acc is not None:
                acc["drain"] = (time.perf_counter() - t0) * 1e3
            if not reqs:
                # idle drains stay out of the stage histograms —
                # quantiles must describe serviced requests, not
                # reconciliation sweeps (drain_cycle still counts all)
                self._stage_acc = None
                return 0
            if acc is not None:
                tracer.record("search.wake", wake_ms)
                tracer.record("search.drain", acc["drain"])
            if self._bid >= 0:
                try:
                    st.shard_rebid(self._bid)
                except OSError:
                    pass
            with device_profile("search"):
                try:
                    served = self._service(reqs)
                except Exception as ex:
                    # drain-level firewall: _service already contains
                    # per-batch failures, so anything landing here
                    # (lane refresh, mask build, an exhausted retry
                    # budget) fails the WHOLE drain's requests with
                    # error records — clients unblock, the run loop
                    # never unwinds
                    log.exception("drain failed; failing %d requests",
                                  len(reqs))
                    self.stats.drain_faults += 1
                    for r in reqs:
                        try:
                            self._fail(r.idx, r.epoch,
                                       f"drain failed: {ex}",
                                       counter="req_failures")
                        except Exception:
                            pass      # store down too: retried next drain
                        self._fail_span(r)
                    served = 0
        self._end_trace(reqs)
        self.stats.served += served
        return served

    def _service(self, reqs: list[_Request]) -> int:
        """Score stage (lane refresh + async batched dispatch), select
        stage (the device fetches), commit stage (result rows + label
        clears) — select+commit resolve through a K-deep
        InflightWindow (engine/resident.py), so batch k's host-side
        fetch/commit work overlaps the device computing batches
        k+1..k+K instead of every batch queueing behind a full drain
        of dispatches.  Every batch is its own failure domain: a batch
        whose dispatch or fetch raises degrades through
        _score_degraded (unfused retry, then request-by-request) while
        its siblings commit normally — a device failure mid-service
        must never unwind the run loop or starve unrelated requests."""
        acc = self._stage_acc
        t0 = time.perf_counter()
        full0 = self.lane.full_uploads
        arr = self.lane.refresh()
        self.stats.full_refreshes += self.lane.full_uploads - full0
        req_rows = np.asarray([r.idx for r in reqs], np.int64)

        # select/commit wall + served count accrued by the window's
        # resolver as batches complete (out of lockstep with dispatch)
        state = {"served": 0, "select_ms": 0.0, "commit_ms": 0.0}
        win = CallbackWindow(
            self.inflight_depth,
            lambda payload, pend, ready: self._resolve_batch(
                arr, payload, pend, ready, state))

        # group by (bloom prefilter, bf16 flag) — the kernel mask and
        # the product precision are shared across a batch — bucket
        # each group's queries, dispatch each batch and push it into
        # the window: CUDA work queues back to back, and the window
        # resolves whatever completes (its CUDA event fired) while
        # later batches are still being staged
        groups: dict[tuple, list[_Request]] = {}
        for r in reqs:
            groups.setdefault((r.bloom, r.fast), []).append(r)
        # one mask per BLOOM value: the fast/exact split shares it, and
        # the default mask's O(nslots) epochs() snapshot runs once per
        # drain, not once per precision group
        masks = {bloom: torch.from_numpy(self._mask_for(bloom, req_rows))
                 .to(arr.device)
                 for bloom in {b for b, _ in groups}}
        for (bloom, fast), group in groups.items():
            mask = masks[bloom]
            lo = 0
            for qb in _qb_chunks(len(group)):
                chunk = group[lo: lo + qb]
                lo += len(chunk)
                # clamped to the lane: an oversized client k (or the
                # CLI's x8 growth crossing nslots) must cost a smaller
                # fetch, never a top-k past the rows that poison-pills
                # the drain
                k_fetch = min(
                    _k_bucket(max(r.k for r in chunk) + K_CUSHION),
                    self.store.nslots)
                q = np.zeros((qb, self.store.vec_dim), np.float32)
                for i, r in enumerate(chunk):
                    q[i] = r.qvec
                # dispatch failures defer to the select stage's
                # degradation ladder (pend=None) so sibling batches
                # still queue on the device back to back
                try:
                    fault("searcher.dispatch")
                    fn = self._program(k_fetch, mxu_bf16=fast)
                    pend = DeviceFuture(fn(arr, q, mask, self.lane.norms))
                except Exception as ex:
                    log.warning("batch dispatch failed: %s", ex)
                    pend = None
                self.stats.dispatches += 1
                self.stats.coalesced_max = max(
                    self.stats.coalesced_max, len(chunk))
                win.push((chunk, k_fetch, mask, q), pend)
        win.flush()
        self.stats.inflight_peak = max(self.stats.inflight_peak,
                                       win.inflight_peak)
        self.stats.ready_selects += win.ready_resolves
        self.stats.blocking_selects += win.blocking_resolves
        t3 = time.perf_counter()
        if acc is not None:
            # the resolver accrued select/commit; score is the
            # remaining host-side wall of the service (refresh, mask
            # build, batching, dispatch) — the stages stay disjoint
            acc["select"] = state["select_ms"]
            acc["commit"] = state["commit_ms"]
            acc["score"] = max(
                (t3 - t0) * 1e3 - state["select_ms"]
                - state["commit_ms"], 0.0)
            for stage in ("score", "select", "commit"):
                tracer.record(f"search.{stage}", acc[stage])
        return state["served"]

    def _resolve_batch(self, arr, payload, pend, ready: bool,
                       state: dict) -> None:
        """Window resolver: one batch's select (device fetch, with the
        per-batch degradation ladder) + commit, in COMPLETION order —
        runs while sibling batches still compute on-device."""
        chunk, k_fetch, mask, q = payload
        t1 = time.perf_counter()
        try:
            fault("searcher.select")
            if pend is None:
                raise RuntimeError("batch dispatch failed")
            # scores and rows in ONE device->host copy
            s_all, i_all = fetch_topk(*pend.value)
            ok = None
        except Exception as ex:
            s_all, i_all, ok = self._score_degraded(
                arr, chunk, q, mask, k_fetch, ex)
        t2 = time.perf_counter()
        state["select_ms"] += (t2 - t1) * 1e3
        for i, r in enumerate(chunk):
            if ok is not None and not ok[i]:
                continue           # already failed with an error record
            try:
                state["served"] += self._commit_hits(
                    r, np.asarray(s_all[i]), np.asarray(i_all[i]),
                    k_fetch)
            except Exception as ex:
                self._fail(r.idx, r.epoch,
                           f"result commit failed: {ex}",
                           counter="req_failures")
                self._fail_span(r)
        state["commit_ms"] += (time.perf_counter() - t2) * 1e3

    def _score_degraded(self, arr, chunk: list[_Request], q, mask,
                        k_fetch: int, ex: Exception):
        """The per-batch degradation ladder: a failed fused batch
        retries UNFUSED at the same shape (K3 + the stable sort), then
        request-by-request at the smallest QB bucket.
        Requests that still fail get error records via _fail — fewer
        served queries beat an unwound daemon.  Returns
        (s_all, i_all, ok_rows); ok_rows[i] False = row i already
        failed terminally."""
        from ..ops.similarity import topk_program

        self.stats.batch_faults += 1
        log.warning("search batch of %d failed (%s); retrying unfused",
                    len(chunk), ex)
        norms = self.lane.norms
        try:
            fault("searcher.dispatch")
            fn = topk_program(k_fetch, batched=True, mxu_bf16=False,
                              fused=False)
            s_all, i_all = fetch_topk(*fn(arr, q, mask, norms))
            self.stats.retried_unfused += 1
            return s_all, i_all, None
        except Exception as ex2:
            log.warning("unfused retry failed (%s); degrading to "
                        "single-query dispatches", ex2)
        qb0 = QB_BUCKETS[0]
        s_out = np.full((len(chunk), k_fetch), -np.inf, np.float32)
        i_out = np.full((len(chunk), k_fetch), -1, np.int64)
        ok = [False] * len(chunk)
        for i, r in enumerate(chunk):
            try:
                fault("searcher.dispatch")
                q1 = np.zeros((qb0, self.store.vec_dim), np.float32)
                q1[0] = r.qvec
                fn = topk_program(k_fetch, batched=True, mxu_bf16=False,
                                  fused=False)
                s1, i1 = fetch_topk(*fn(arr, q1, mask, norms))
                s_out[i], i_out[i] = s1[0], i1[0]
                ok[i] = True
                self.stats.retried_single += 1
            except Exception as ex3:
                try:
                    self._fail(r.idx, r.epoch,
                               f"search failed after retries: {ex3}",
                               counter="req_failures")
                except Exception:
                    pass          # store down too: retried next drain
                self._fail_span(r)
        return s_out, i_out, ok

    # -- commit ------------------------------------------------------------

    def _commit_hits(self, r: _Request, scores: np.ndarray,
                     idxs: np.ndarray, k_fetch: int) -> int:
        """Filter one request's fetched candidates (valid score, live
        key, not a system/scratch row) down to its k and commit."""
        st = self.store
        n_valid = 0
        out_s, out_i, out_k = [], [], []
        for score, idx in zip(scores, idxs):
            if score <= -1e29 or idx < 0:
                break                         # sorted desc: filler next
            n_valid += 1
            if len(out_s) >= r.k:
                continue                      # n_valid still counts
            key = st.key_at(int(idx))
            if key is None or key.startswith("__"):
                continue                      # system/scratch rows
            out_s.append(round(float(score), 6))
            out_i.append(int(idx))
            out_k.append(key)
        rec = {"s": out_s, "i": out_i, "keys": out_k,
               "fetched": int(min(k_fetch, st.nslots)), "n": n_valid}
        return self._commit_result(r.idx, r.epoch, rec)

    def _commit_result(self, idx: int, epoch: int, rec: dict) -> int:
        """Epoch-gated result commit: write __sr_<idx>, clear the
        request labels, bump — but ONLY if the request slot is
        unchanged since the gather (a client racing a rewrite must
        get the NEW query serviced, not the old result).  The record
        carries the request epoch (`e`) and a wall timestamp (`ts`):
        the orphan sweep retires rows whose slot moved on or whose
        client never consumed them."""
        fault("searcher.commit")
        st = self.store
        if st.epoch_at(idx) != epoch:
            self.stats.raced += 1
            return 0
        key = st.key_at(idx)
        if key is None:
            return 0
        rec = dict(rec)
        rec["e"] = int(epoch)
        rec["ts"] = round(time.time(), 3)
        rkey = P.search_result_key(idx)
        # an oversized result halves its hit list until it fits —
        # fewer candidates beat a request wedged forever
        # (publish_trace_ring's degradation discipline)
        while True:
            try:
                st.set(rkey, json.dumps(rec))
                break
            except OSError:
                if not rec.get("s"):
                    rec = {"err": "result too large for store max_val",
                           "e": int(epoch), "ts": round(time.time(), 3)}
                    try:
                        st.set(rkey, json.dumps(rec))
                    except OSError:
                        return 0
                    break
                half = max(len(rec["s"]) // 2, 0)
                rec["s"] = rec["s"][:half]
                rec["i"] = rec["i"][:half]
                rec["keys"] = rec["keys"][:half]
                rec["truncated"] = True
            except KeyError:
                return 0
        # recheck the epoch right before the label flip: the result
        # write above took real time (size-degradation retries), and a
        # client rewriting its slot in that window must get its NEW
        # request serviced next drain — clearing the label here would
        # hand it the OLD query's answer.  (The label stays set, so
        # submit_search never reads the stale __sr_ row, and the next
        # service overwrites it.)
        if st.epoch_at(idx) != epoch:
            self.stats.raced += 1
            return 0
        try:
            st.label_or(rkey, P.LBL_READY)
            st.label_clear(key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
            st.bump(key)
        except (KeyError, OSError):
            return 0
        return 1

    # -- flight recording --------------------------------------------------

    def _end_trace(self, reqs: list[_Request]) -> None:
        acc, self._stage_acc = self._stage_acc, None
        stage_map = ({s: acc[s] for s in P.SEARCH_STAGES}
                     if acc is not None else None)
        # the drain's device window rides the first committed span
        # (drain-scoped attribution, SpanWriter.commit)
        device_ms = DEVTIME.take_lane_ms("searcher")
        committed = 0
        # span commits run whether or not the histogram tracer is on:
        # span capture is always-on, bounded by head sampling
        for r in reqs:
            if r.span is not None:
                self.spans.commit(
                    r.span, stages=stage_map,
                    device_ms=device_ms if committed == 0 else None)
                committed += 1
        if acc is None:
            return
        stage_sum = sum(acc.values())
        tracer.record("search.e2e", stage_sum)
        if not committed:
            # tail-based retention: slow unstamped drains keep full
            # SEARCH_STAGES detail (one `tail: true` span + a slow-log
            # entry resolvable via `spt trace show`)
            thr = self.recorder.slow_threshold_ms()
            if thr is not None and stage_sum > thr:
                tid = self.spans.tail_span(
                    "<drain>", stage_sum, stages=stage_map,
                    device_ms=device_ms if device_ms > 0 else None)
                if tid is not None:
                    self.recorder.record(
                        tid, "<drain>", stage_sum,
                        [[s, round(acc[s], 3)]
                         for s in P.SEARCH_STAGES])
        now_wall = time.time()
        events = [[s, round(acc[s], 3)] for s in P.SEARCH_STAGES]
        for r in reqs:
            if r.stamp is None:
                continue
            tid, ts = r.stamp
            try:
                key = self.store.key_at(r.idx)
            except (KeyError, OSError):
                key = None
            wall = (now_wall - ts) * 1e3 if ts > 0 else stage_sum
            self.recorder.record(tid, key, wall,
                                 [list(e) for e in events])

    # -- daemon loop -------------------------------------------------------

    def run_once(self) -> int:
        """One full drain (tests, --oneshot).  Buffered span records
        flush here; the run loop flushes on the heartbeat cadence."""
        n = self.drain()
        self.spans.flush()
        return n

    def sweep_results(self, *, ttl_s: float = RESULT_TTL_S,
                      now: float | None = None) -> int:
        """Retire orphaned __sr_<idx> result rows.  A client that
        times out never calls consume_result, and a daemon that
        crashed mid-commit leaves rows no client is polling — without
        a reaper they accumulate until the store is full of corpses.
        A row is an orphan when its request slot is gone, its slot
        epoch moved past the one the result was committed under (a
        NEW request owns the slot; its service will write a fresh
        row), or it outlived ttl_s.  Runs on the heartbeat cadence
        (O(nslots) key walk — never on the wake path); a restarted
        daemon's first sweep reclaims the previous generation's
        leftovers.  Returns the reaped count."""
        fault("searcher.sweep")
        st = self.store
        now = time.time() if now is None else now
        pfx = P.SEARCH_RESULT_PREFIX
        reaped = 0
        for key in st.list():
            if not key.startswith(pfx):
                continue
            try:
                idx = int(key[len(pfx):])
            except ValueError:
                continue
            try:
                rec = json.loads(st.get(key).rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                continue              # unreadable now: next sweep
            if not isinstance(rec, dict):
                rec = {}
            e, ts = rec.get("e"), rec.get("ts")
            if idx >= st.nslots or st.key_at(idx) is None:
                retire = True         # request slot gone entirely
            elif isinstance(e, int) and st.epoch_at(idx) != e:
                retire = True         # slot epoch moved on
            elif isinstance(ts, (int, float)):
                retire = (now - float(ts)) > ttl_s
            else:
                retire = True         # pre-TTL format: unowned legacy row
            if retire:
                try:
                    st.unset(key)
                    reaped += 1
                except (KeyError, OSError):
                    pass
        self.stats.results_reaped += reaped
        # the pending-span staging rows share the same reaper cadence
        # (orphans: raced rewrites, crashed drains nobody re-ran)
        sweep_span_stages(st, ttl_s=ttl_s, now=now)
        return reaped

    def publish_stats(self) -> None:
        """Heartbeat: JSON stats snapshot into __searcher_stats (the
        CLI's daemon-liveness probe reads its ts; `spt metrics`
        renders the rest).  With tracing on, the SEARCH_STAGES
        quantiles and the flight-recorder ring ride along — same
        section contract as the other daemons."""
        self.spans.flush()            # heartbeat cadence, off the
        payload = {**dataclasses.asdict(self.stats),  # wake path
                   "spans_obs": self.spans.counters(),
                   "coalesce_ratio": round(
                       self.stats.coalesce_ratio(), 4),
                   "generation": self.generation,
                   # overlap-window gauge: inflight_peak pinned at
                   # inflight_depth means the window saturates (raise
                   # --inflight-depth for more dispatch amortization)
                   "inflight_depth": self.inflight_depth,
                   "lane": self.lane.counters()}
        if self.replica or self.stripes.epoch:
            payload["replica"] = self.replica
            payload["stripe"] = self.stripes.snapshot()
        if self.admit_cap or self.qos.high_water is not None:
            payload["qos"] = {
                "admit_cap": self.admit_cap or 0,
                "queue_high_water": self.qos.high_water
                if self.qos.high_water is not None else -1,
                "retry_after_ms": self.qos.retry_after_ms}
        tenants = self.tenants.snapshot()
        if tenants:
            # per-tenant admitted/shed/deadline_expired/served_tokens:
            # `spt metrics` renders one labeled series per tenant
            payload["tenants"] = tenants
        prune_idle_counters(
            payload, bool(self.admit_cap
                          or self.qos.high_water is not None
                          or tenants))
        if faults.armed():
            payload["faults"] = faults.stats()
        payload["compile_events"] = DEVTIME.compile_events("searcher")
        devtime = DEVTIME.heartbeat_section("searcher")
        if devtime:
            payload["devtime"] = devtime
        # this process's hand-written kernel launches by name (the
        # counterpart of the JAX lanes' device-program ledger in
        # devtime), in the size-droppable "dispatch" section that `spt
        # metrics` renders flat: sptpu_<lane>_kernel_<name>
        payload.setdefault("dispatch", {}).update(
            LAUNCHES.heartbeat_fields())
        DEVTIME.flush(self.store)
        if tracer.enabled:
            P.attach_trace_sections(payload, tracer, self.recorder,
                                    "search.")
        P.publish_heartbeat(self.store, self._hb_key, payload)
        if tracer.enabled:
            self._trace_published = P.maybe_publish_trace_ring(
                self.store, self._trace_key, self.recorder,
                self._trace_published)

    def run(self, *, idle_timeout_ms: int = 100,
            stop_after: float | None = None,
            heartbeat_interval_s: float = 5.0) -> None:
        """The daemon loop: block on the signal group, drain, repeat.
        The heartbeat doubles as the liveness signal the CLI's
        dispatch check reads, so it publishes on an interval even
        when idle."""
        self._running = True
        st = self.store
        last = st.signal_count(self.group)
        deadline = (time.monotonic() + stop_after) if stop_after else None
        next_beat = 0.0                       # publish immediately
        next_retire_check = 0.0
        while self._running:
            got = st.signal_wait(self.group, last,
                                 timeout_ms=idle_timeout_ms)
            t_wake = time.perf_counter()
            # loop-level exception firewall: the drain already fails
            # requests instead of raising, so anything landing here is
            # a gather/store-level surprise — log it and keep serving
            # (the crash-only discipline: the loop never unwinds, and
            # a real crash is the supervisor's job to absorb)
            try:
                if got is not None:
                    last = got
                    self.stats.wakes += 1
                    if self.coalesce_window_ms > 0:
                        time.sleep(self.coalesce_window_ms / 1e3)
                    self.drain(
                        wake_ms=(time.perf_counter() - t_wake) * 1e3)
                    # work-conserving under admit_cap: a drain that
                    # deferred backlog (fairness granularity, not a
                    # throughput cap) re-drains immediately — each
                    # pass re-plans admission with accumulated stride
                    # credit, so the backlog clears in fair slices
                    # instead of waiting out the heartbeat cadence
                    redrains = 0
                    while self._had_deferred and self._running \
                            and redrains < 256:
                        redrains += 1
                        self.drain()
                now = time.monotonic()
                if now >= next_beat:
                    if got is None:
                        # reconciliation on the heartbeat cadence,
                        # never per idle timeout: a request whose
                        # pulse raced a prior drain (or a torn row
                        # left pending) retries here without an
                        # O(nslots) label scan every idle wakeup.  A
                        # restarted daemon's FIRST pass through here
                        # reclaims the stranded requests (label bit
                        # set, no inflight owner) a crashed
                        # predecessor left behind.
                        self.drain()
                    self.sweep_results()
                    self.publish_stats()
                    next_beat = now + heartbeat_interval_s
                if self.replica and now >= next_retire_check:
                    # scale-down drain: stripes closed by the
                    # supervisor; the drain above finished in-flight
                    # work, so exit cleanly and let it reap us
                    next_retire_check = now + 1.0
                    if self.stripes.poll_retired():
                        log.info("replica %d destriped — retiring",
                                 self.replica)
                        self.publish_stats()
                        break
            except Exception:
                self.stats.drain_faults += 1
                log.exception("run loop cycle failed; continuing")
                now = time.monotonic()
            if deadline and now > deadline:
                break

    def stop(self) -> None:
        self._running = False


# -- client side -----------------------------------------------------------

def daemon_live(store: Store, *, max_age_s: float = 15.0) -> bool:
    """True when a search daemon is live enough to route a query
    through — the CLI's dispatch probe.  Heartbeat freshness alone
    used to hold the answer for max_age_s after a crash (every client
    then burned its full submit timeout); now the heartbeat's pid is
    kill-0 probed, so a dead daemon reads dead instantly, and a
    supervisor heartbeat whose breaker marked the search lane down
    vetoes dispatch outright (protocol.heartbeat_live)."""
    return P.heartbeat_live(store, P.KEY_SEARCH_STATS,
                            max_age_s=max_age_s, lane="searcher")


def submit_search(store: Store, key: str, k: int, *, bloom: int = 0,
                  fast: bool = False,
                  timeout_ms: int = 2000,
                  tenant: int = 0,
                  deadline_ms: float | None = None,
                  trace=None,
                  retry: bool = True) -> dict | None:
    """Client side: turn `key` (whose vector lane already holds the
    embedded query) into a search request and wait for the daemon's
    result.  fast requests bf16-product scoring server-side (the CLI's
    --fast).  Returns the result record, or None on timeout (callers
    fall back to client-side scoring).

    `tenant` tags the request's label word for per-tenant admission;
    `deadline_ms` (relative) rides the request JSON as an absolute
    wall-clock deadline the daemon fast-fails behind.  The submit
    routes through the shared retry wrapper (engine/client.py): a
    typed `overloaded` shed is retried after its retry_after_ms hint
    (jittered) inside the same timeout budget, and a lane whose
    supervisor breaker is open fails fast instead of burning the
    timeout (retry=False restores one bare attempt)."""
    from .client import PENDING, call_with_retries, wait_with_repulse

    deadline_ts = (time.time() + deadline_ms / 1e3
                   if deadline_ms is not None else None)

    def attempt(left_ms: float) -> dict | None:
        idx = store.find_index(key)
        req = {"k": int(k), "bloom": int(bloom), "fast": bool(fast)}
        if deadline_ts is not None:
            req["deadline"] = round(deadline_ts, 6)
        store.set(key, json.dumps(req))
        if tenant:
            P.stamp_tenant(store, key, tenant)
        if trace:
            P.stamp_trace_ctx(store, key, trace)
        store.label_or(key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
        store.bump(key)

        def check():
            if store.labels(key) & P.LBL_SEARCH_REQ:
                return PENDING
            try:
                raw = store.get(P.search_result_key(idx))
                return json.loads(raw.rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                return None

        return wait_with_repulse(store, key, left_ms, check)

    if not retry:
        return attempt(timeout_ms)
    return call_with_retries(attempt, timeout_ms=timeout_ms,
                             store=store, lane="searcher")


def consume_result(store: Store, key: str) -> None:
    """Retire a serviced request: drop the result row (the request key
    itself is the caller's to keep or unset)."""
    try:
        store.unset(P.search_result_key(store.find_index(key)))
    except (KeyError, OSError):
        pass


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu_torch.engine.searcher
    --store NAME [--device cuda|cpu]"""
    import argparse

    from ..utils.device import DEVICE_CHOICES

    ap = argparse.ArgumentParser(
        description="splinter-tpu search daemon, PyTorch port "
                    "(query-coalescing fused top-k over the store's "
                    "vector lane on the card)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--device", choices=DEVICE_CHOICES, default="cuda",
                    help="stage the lane on the card (default: kernels "
                         "K2/K3) or on the CPU (their plain versions); "
                         "never falls back from one to the other")
    ap.add_argument("--oneshot", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="bf16 products (f32 sums), ~2e-2 score "
                         "precision")
    ap.add_argument("--coalesce-window-ms", type=float, default=0.0)
    ap.add_argument("--inflight-depth", type=int, default=2,
                    help="K-deep dispatch overlap: un-awaited top-k "
                         "batch dispatches held before the oldest's "
                         "select+commit resolves (1 = fetch in "
                         "dispatch order)")
    ap.add_argument("--idle-timeout-ms", type=int, default=100)
    ap.add_argument("--replica", type=int, default=0,
                    help="striped replica index (elastic lanes): "
                         "drain only the stripes the lane's stripe "
                         "map assigns this replica; heartbeat "
                         "publishes replica-suffixed "
                         "(__searcher_stats.rN)")
    ap.add_argument("--admit-cap", type=int, default=None,
                    help="multi-tenant QoS: max requests serviced per "
                         "drain (the fairness granularity; backlog "
                         "re-plans next drain with stride credit; "
                         "default: unlimited)")
    ap.add_argument("--queue-high-water", type=int, default=None,
                    help="multi-tenant QoS: max deferred backlog — "
                         "overflow is shed with a typed `overloaded` "
                         "result + retry_after_ms hint (default: "
                         "never shed)")
    ap.add_argument("--retry-after-ms", type=int, default=None,
                    help="retry hint carried by shed results")
    ap.add_argument("--tenant-weights", default=None,
                    help="per-tenant fair-share weights, "
                         "TENANT:W[,TENANT:W...] (unlisted tenants "
                         "weigh 1)")
    ap.add_argument("--warmup", action="store_true",
                    help="run the QB-bucketed top-k programs once "
                         "before serving")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    store = Store.open(args.store, persistent=args.persistent)
    sr = Searcher(store, mxu_bf16=args.fast,
                  inflight_depth=args.inflight_depth,
                  coalesce_window_ms=args.coalesce_window_ms,
                  admit_cap=args.admit_cap,
                  queue_high_water=args.queue_high_water,
                  retry_after_ms=args.retry_after_ms,
                  tenant_weights=parse_tenant_weights(
                      args.tenant_weights),
                  replica=args.replica,
                  device=args.device)
    sr.attach()
    if args.warmup:
        t0 = time.monotonic()
        sr.warmup()
        log.info("warmup ran in %.1fs", time.monotonic() - t0)
    if args.oneshot:
        n = sr.run_once()
        log.info("oneshot served %d searches", n)
        return 0
    try:
        sr.run(idle_timeout_ms=args.idle_timeout_ms)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
