"""Disaggregated prefill/decode serving lanes (ROADMAP item 1).

Prefill is compute-bound (dense bucket programs + the per-bucket
commit scatter); decode is memory-bound (the ragged paged-attention
chunk).  The unified continuous completer interleaves both, so a long
joiner's prefill stalls every live decode chunk and drains the K-deep
window.  These two Completer subclasses split the phases across lane
types behind the UNCHANGED label protocol (TPLA, arxiv 2508.15881, is
the blueprint; the queue-wait/service decomposition the spans already
measure per phase says the split pays):

  PrefillLane   WAITING -> SERVICING: renders + claims exactly like
                the unified lane, runs ONLY dense bucket prefill into
                a scratch pool row (suffix-only under prefix sharing),
                samples + streams the first token, exports the row's
                pages to `__ho_<idx>` wire keys, lands the handoff
                record, and flips the row to DECODE_READY.  QoS here
                is phase-aware: plan() gets the rolling prefill-wall
                EMA as slack, so a deadline that would expire inside
                prefill fast-fails BEFORE paying it.

  DecodeLane    DECODE_READY -> SERVICING|DECODE_READY: adopts
                committed rows at chunk edges through run_continuous's
                _lane_admit hook and runs ONLY ragged paged decode —
                its K-deep window is never again stalled by a joiner's
                prefill.  Adoption seats the row exactly where a
                unified join would have left it (carry token, budget,
                reservation), so greedy output is byte-identical.

The handoff is crash-safe both directions: a died prefill lane's
half-committed row is still SERVICING in ITS stripes — stripe-scoped
recovery sweeps the orphan wire keys and re-queues it WAITING; a died
decode lane's adopted rows carry SERVICING|DECODE_READY — recovery
truncates the slot back to the handoff byte length (`plen`) and drops
SERVICING, so any live decode replica re-adopts from the wire pages
(or re-prefills from the recorded token ids when the wire is gone).
Zero admitted requests are ever lost.

PR 15's elastic lanes get what they were built for: `prefill` and
`decode` are two supervisor LaneSpec types with different autoscaler
signals (prefill scales on queue pressure, decode on pool occupancy),
their own stripe maps, replica heartbeats (__prefill_stats /
__decode_stats) and devtime programs (prefill.bucket_commit /
decode.paged_chunk).
"""
from __future__ import annotations

import time

from ..obs.devtime import DEVTIME
from ..utils.faults import fault
from ..utils.trace import tracer
from . import protocol as P
from .completer import Completer

__all__ = ["PrefillLane", "DecodeLane"]


class PrefillLane(Completer):
    """The compute-bound half: dense bucket prefill + commit scatter
    only, handing each committed row off at DECODE_READY."""

    LANE = "prefill"
    HB_KEY = P.KEY_PREFILL_STATS

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if getattr(self, "_model", None) is None:
            raise ValueError(
                "disaggregated lanes require a model backend "
                "(generate_fn cannot export KV pages)")
        # paged programs register under "prefill.*" (the alias maps
        # paged_commit -> bucket_commit, so the ledger shows the
        # ROADMAP's `prefill.bucket_commit`); the trunk + samplers
        # stay canonical "completer.*"
        self._model.devtime_lane = self.LANE
        # rolling prefill wall EMA (seconds) — the phase-aware QoS
        # slack: a deadline inside the expected prefill cost
        # fast-fails before paying it
        self._pf_ema_s = 0.0
        self._lane_stats = {"handoffs": 0, "handoff_failed": 0,
                            "handoff_wire_mb": 0.0}

    def _max_wire_pages(self) -> int:
        """Worst-case wire-page count one slot's handoff can occupy —
        the sweep bound when no record survived to consult."""
        cfg = self._model.cfg
        return -(-cfg.max_len // max(1, self.page_size))

    def _reclaim_stranded(self) -> int:
        """Prefill-crash recovery: a SERVICING row in OUR stripes died
        mid-prefill or mid-export (the DECODE_READY flip lands LAST,
        after the record) — sweep any orphan wire keys and re-queue it
        WAITING.  The restarted stream re-renders from scratch, same
        as the unified lane's crash story.

        Rows carrying DECODE_READY are past the flip and belong to
        the decode lane (its stripe map is independent over the same
        slot space — a live decode replica may be mid-decode on the
        row under SERVICING|DECODE_READY): never touch their record
        or wire pages here."""
        st = self.store
        self.stripes.refresh()
        n = 0
        for idx in st.enumerate_indices(P.LBL_SERVICING):
            if not self.stripes.owns(int(idx)):
                continue
            try:
                labels = st.labels_at(idx)
            except (KeyError, OSError):
                continue
            if labels & P.LBL_DECODE_READY:
                continue
            key = st.key_at(idx)
            if key is None:
                continue
            P.clear_handoff(st, idx, pages=self._max_wire_pages())
            try:
                st.label_clear(key, P.LBL_SERVICING)
                st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
                n += 1
            except (KeyError, OSError):
                continue
        if n:
            self.stats.reclaimed += n
            self._debug(f"reclaimed {n} stranded prefill rows")
        return n

    def warmup_paged(self) -> None:
        super().warmup_paged()
        if self._paged_ok():
            # the first handoff at serve time must not compile
            self._model.warmup_handoff(self._ensure_paged_cache(),
                                       export=True, adopt=False)

    def _lane_payload(self, payload: dict) -> None:
        payload["lane"] = self.LANE
        payload.update(self._lane_stats)
        payload["prefill_wall_ema_ms"] = round(self._pf_ema_s * 1e3, 3)

    # -- the prefill+handoff service ---------------------------------------

    def _handoff_one(self, idx: int) -> bool:
        """Serve one WAITING slot: claim, dense prefill into the
        scratch row, sample + stream the first token, export the pages
        to wire keys, land the record, flip DECODE_READY.  Returns
        True when the slot was consumed (handed off, finished, or
        typed-rejected); False leaves it WAITING for the next cycle
        (backpressure / race)."""
        import numpy as np
        st = self.store
        m, tok = self._model, self._tok
        cache = self._ensure_paged_cache()
        peek = self._read_rendered(idx)
        if peek is None:
            return False
        ids = self._clip_context(tok.encode(peek[1]), bucketed=True)
        pc = getattr(cache, "prefix_cache", None)
        hit_bids: list[int] = []
        match = 0
        tier_nodes: list = []
        if pc is not None and len(ids):
            hit_bids, match, tier_nodes = pc.lookup_tiered(ids)
            # keep >= 1 suffix token to prefill: the handoff needs
            # the last-position logits for the first sample (the
            # unified lane's fully-covered replay trick needs a
            # decode chunk this lane never runs).  Trim the DRAM run
            # first — dropping a tier node costs nothing readmitted
            # yet, dropping an HBM page forfeits committed work
            while tier_nodes \
                    and match + len(tier_nodes) * cache.page \
                    >= len(ids):
                tier_nodes = tier_nodes[:-1]
            while hit_bids and not tier_nodes and match >= len(ids):
                hit_bids = hit_bids[:-1]
                match -= cache.page
            if not hit_bids and not tier_nodes:
                match = 0
        if len(ids):
            # peek-before-claim backpressure, prompt-only: the DECODE
            # reservation is the adopting lane's pool's problem
            need = cache.pages_needed(len(ids)) - len(hit_bids)
            pinned = sum(1 for b in hit_bids
                         if cache.refcounts[b] == 0)
            if need > cache.available_pages - pinned:
                self.stats.join_backpressure += 1
                return False
        tenant, dl = self._qos_meta(idx)
        prep = self._prepare(idx, peek=peek)
        if prep is None:
            return False
        key, _rendered, t0, _stamp = prep
        if not len(ids):
            self._finalize(key, t0, 0, False)
            return True
        tp0 = time.perf_counter()
        row = 0                       # serial scratch row
        if hit_bids or tier_nodes:
            fault("completer.prefix_map")
            if hit_bids:
                # pin the HBM prefix FIRST: readmission allocations
                # below can trigger reclaim, and an unpinned zero-ref
                # hit page would be fair game for that eviction pass
                cache.map_shared(row, hit_bids)
            if tier_nodes:
                # DRAM hit: readmitted pages arrive holding refcount
                # 1 — drop each to zero-ref (tree-retained), then let
                # map_shared's 0→1 bump pin them for the scratch row.
                # Partial readmission just lengthens the suffix
                tier_bids = pc.readmit(tier_nodes, cache)
                for b in tier_bids:
                    cache._decref(b)
                if tier_bids:
                    cache.map_shared(row, tier_bids)
                hit_bids = hit_bids + tier_bids
                match += len(tier_bids) * cache.page
            if not hit_bids:
                pc.note_miss()       # every readmit failed
            else:
                cache.lengths[row] = match
                pc.commit_hit(ids, match)
                pc.stats.bytes_saved += \
                    match * cache.kv_bytes_per_token()
                if tenant:
                    self.tenants.bump(tenant, "prefix_hit_pages",
                                      len(hit_bids))
        elif pc is not None:
            pc.note_miss()
        suffix = ids[match:]
        if not cache.ensure(row, len(ids)):
            # defensive (pinned-aware gate above): re-queue, same as
            # the unified admit()'s unreachable branch
            cache.free_row(row)
            self.stats.join_backpressure += 1
            self._requeue_failed([idx])
            return True
        try:
            if getattr(cache, "quantized", False) and suffix:
                fault("completer.kv_quant_commit")
            if hit_bids:
                logits = m.paged_append_prefill(
                    cache, np.asarray(suffix, np.int32), row)
            else:
                logits = m.paged_prefill_row(
                    cache, np.asarray(ids, np.int32), row)
            if pc is not None:
                ins = pc.insert(ids, cache, row, tenant)
                if ins and tenant:
                    self.tenants.bump(tenant, "prefix_cached_pages",
                                      ins)
            # splint: ignore[SPL201] reason=the documented host "sample" stage (CONT_INFER_STAGES): one scalar draw per request so the first token streams before the handoff
            t = int(m.sample(logits))
            tp1 = time.perf_counter()
            tracer.record("infer.join", (tp1 - tp0) * 1e3)

            n_tok = truncated = vanished = 0
            if t != tok.eos_id:
                res = self._flush(key, tok.token_to_piece(t))
                truncated, vanished = res == "full", res == "gone"
                n_tok = 1
            if t == tok.eos_id or self.max_new <= 1 \
                    or truncated or vanished:
                # nothing left to decode (or the slot is full/gone):
                # this row finishes IN the prefill lane — no handoff
                self._finalize(key, t0, n_tok, bool(truncated),
                               bool(vanished))
                return True

            # -- the handoff: wire pages, record, DECODE_READY flip --
            wire_pages = 0
            if m.page_wire_bytes(cache) < st.max_val - 1:
                try:
                    pages_b, scales_b = m.export_row_pages(cache, row)
                    for j, buf in enumerate(pages_b):
                        pk = P.handoff_page_key(idx, j)
                        st.set(pk, buf)
                        st.label_or(pk, P.LBL_DEBUG)
                        if scales_b[j] is not None:
                            sk = P.handoff_scale_key(idx, j)
                            st.set(sk, scales_b[j])
                            st.label_or(sk, P.LBL_DEBUG)
                    wire_pages = len(pages_b)
                    self._lane_stats["handoff_wire_mb"] = round(
                        self._lane_stats["handoff_wire_mb"]
                        + wire_pages * m.page_wire_bytes(cache) / 1e6,
                        3)
                except (KeyError, OSError):
                    # store too full for the wire: the record's token
                    # ids still let the decode lane re-prefill
                    P.clear_handoff(st, idx,
                                    pages=self._max_wire_pages())
                    wire_pages = 0
            # the chaos matrix crashes HERE — wire keys written, no
            # record, row still SERVICING: _reclaim_stranded must
            # sweep the orphans and re-queue (tests/test_disagg.py)
            fault("prefill.handoff")
            rec = {"len": int(len(ids)),
                   "ids": [int(i) for i in ids],
                   "carry": t, "n_tok": 1,
                   "remaining": self.max_new - 1,
                   "disp_left": self.max_new - 1,
                   "plen": st.value_len(key), "t0": int(t0),
                   "tenant": int(tenant),
                   "deadline": dl, "wire_pages": wire_pages,
                   "quant": bool(getattr(cache, "quantized", False))}
            if not P.write_handoff_record(st, idx, rec):
                # no record -> no adoption, ever: finish with the
                # token already streamed instead of stranding the
                # client (runbook triage: handoff_failed)
                P.clear_handoff(st, idx, pages=max(wire_pages, 1))
                self._lane_stats["handoff_failed"] += 1
                self._finalize(key, t0, 1, False)
                return True
            span = self._live_spans.pop(key, None)
            device_ms = DEVTIME.take_lane_ms(self.LANE) \
                + DEVTIME.take_lane_ms("completer")
            st.label_clear(key, P.LBL_SERVICING)
            st.label_or(key, P.LBL_DECODE_READY)
            # the handoff has LANDED (record + DECODE_READY): from
            # here on nothing may escape — run_continuous's failure
            # handler would re-queue a row the decode lane already
            # owns (WAITING|DECODE_READY with no record = the first
            # token streams twice).  Bookkeeping errors are swallowed.
            try:
                st.bump(key)
            except (KeyError, OSError):
                pass
            wall = time.perf_counter() - tp0
            try:
                tracer.record("infer.handoff",
                              (time.perf_counter() - tp1) * 1e3)
                self.spans.commit(
                    span,
                    stages={"join": round((tp1 - tp0) * 1e3, 3),
                            "handoff": round(
                                (time.perf_counter() - tp1) * 1e3, 3)},
                    extra={"tokens": 1},
                    device_ms=device_ms if device_ms > 0 else None)
            except Exception:
                pass
            self._lane_stats["handoffs"] += 1
            self.stats.tokens += 1
            # the phase-aware slack: admission rejects deadlines that
            # land inside the NEXT request's expected prefill wall
            self._pf_ema_s = (0.8 * self._pf_ema_s + 0.2 * wall
                              if self._pf_ema_s else wall)
            self.qos_slack_s = self._pf_ema_s
            return True
        finally:
            cache.free_row(row)

    def run_continuous(self, *, idle_timeout_ms: int = 100,
                       stop_after: float | None = None) -> None:
        """The prefill lane's serve loop: drain WAITING keys through
        _handoff_one, phase-aware admission order, heartbeat cadence
        and scale-down retire identical to the sibling lanes.  Models
        without the paged surface fall back to the unified lane."""
        if not self._paged_ok():
            return super().run_continuous(
                idle_timeout_ms=idle_timeout_ms, stop_after=stop_after)
        st = self.store
        self._running = True
        deadline = (time.monotonic() + stop_after) if stop_after else None
        last = st.signal_count(self.group)
        next_beat = time.monotonic() + 2.0
        cache = self._ensure_paged_cache()
        self.publish_stats()          # the attach-complete signal
        while self._running:
            now = time.monotonic()
            if deadline and now > deadline:
                break
            if now >= next_beat:
                next_beat = now + 2.0
                self.publish_stats()
                if self.replica and self.stripes.poll_retired():
                    self._debug("replica destriped — retiring")
                    break
            try:
                self.stripes.refresh()
                waiting = [i for i in
                           st.enumerate_indices(P.LBL_INFER_REQ)
                           if self.stripes.owns(int(i))]
                n = 0
                if waiting:
                    cap = (len(waiting) if self.qos.high_water is None
                           else min(len(waiting),
                                    max(1, self.qos.high_water)))
                    for idx in self._admit_waiting(waiting, cap):
                        if not self._running:
                            break
                        try:
                            if self._handoff_one(idx):
                                n += 1
                        except Exception as ex:
                            self.stats.faults += 1
                            self._debug(
                                f"prefill of slot {idx} failed: {ex}")
                            try:
                                handed = bool(
                                    st.labels_at(idx)
                                    & P.LBL_DECODE_READY)
                            except (KeyError, OSError):
                                handed = False
                            if not handed:
                                # only rows still on OUR side of the
                                # flip are re-queued; a DECODE_READY
                                # row belongs to the decode lane and
                                # keeps its record + wire pages
                                self._requeue_failed([idx])
                                P.clear_handoff(
                                    st, idx,
                                    pages=self._max_wire_pages())
                            # the failure may have escaped a donating
                            # program: rebuild the pool outright (the
                            # unified abort_all recovery)
                            self._paged_cache = None
                            cache = self._ensure_paged_cache()
                if n == 0:
                    got = st.signal_wait(self.group, last,
                                         timeout_ms=idle_timeout_ms)
                    if got is not None:
                        last = got
                        self.stats.wakes += 1
            except Exception as ex:
                self.stats.faults += 1
                self._debug(f"prefill cycle failed: {ex}")


class DecodeLane(Completer):
    """The memory-bound half: ragged paged decode only.  Admission is
    ADOPTION of DECODE_READY handoffs at chunk edges — the lane's
    K-deep window is never stalled by a joiner's prefill."""

    LANE = "decode"
    HB_KEY = P.KEY_DECODE_STATS
    WATCH_BIT = P.BIT_DECODE_READY

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if getattr(self, "_model", None) is None:
            raise ValueError(
                "disaggregated lanes require a model backend "
                "(generate_fn cannot import KV pages)")
        self._model.devtime_lane = self.LANE
        self._lane_admit = self._adopt_ready
        self._lane_stats = {"adopted": 0, "readopted": 0,
                            "adopt_backpressure": 0,
                            "handoff_refill": 0}

    def _reclaim_stranded(self) -> int:
        """Decode-crash recovery: an adopted row in OUR stripes
        carries SERVICING|DECODE_READY.  Truncate the slot back to
        the handoff byte length (`plen` — drop the dead adopter's
        partial tail, greedy re-decode reproduces it byte-exact) and
        drop SERVICING, so any live decode replica re-adopts it from
        the wire pages (or re-prefills from the record's ids).  A
        DECODE_READY row with no surviving record falls back to the
        WAITING queue.

        SERVICING-only rows are NOT ours: decode ownership always
        carries SERVICING|DECODE_READY, so a bare SERVICING row is a
        live prefill replica's in-flight claim (the two lanes' stripe
        maps are independent over the same slot space) — touching it
        would double-service the request."""
        st = self.store
        self.stripes.refresh()
        n = 0
        for idx in st.enumerate_indices(P.LBL_SERVICING):
            if not self.stripes.owns(int(idx)):
                continue
            key = st.key_at(idx)
            if key is None:
                continue
            try:
                labels = st.labels_at(idx)
            except (KeyError, OSError):
                continue
            if not labels & P.LBL_DECODE_READY:
                continue
            rec = P.read_handoff_record(st, idx)
            try:
                if rec is not None:
                    plen = int(rec.get("plen", 0))
                    if plen and st.value_len(key) > plen:
                        st.set(key, st.get(key)[:plen])
                    st.label_clear(key, P.LBL_SERVICING)
                    st.bump(key)      # back to bare DECODE_READY
                else:
                    P.clear_handoff(st, idx)
                    st.label_clear(key, P.LBL_SERVICING
                                   | P.LBL_DECODE_READY)
                    st.label_or(key,
                                P.LBL_INFER_REQ | P.LBL_WAITING)
                n += 1
            except (KeyError, OSError):
                continue
        if n:
            self.stats.reclaimed += n
            self._debug(f"re-opened {n} adopted rows for re-adoption")
        return n

    def warmup_paged(self) -> None:
        super().warmup_paged()
        if self._paged_ok():
            # the first adoption at serve time must not compile
            self._model.warmup_handoff(self._ensure_paged_cache(),
                                       export=False, adopt=True)

    def _lane_payload(self, payload: dict) -> None:
        payload["lane"] = self.LANE
        payload.update(self._lane_stats)

    def _lane_row_done(self, row: dict) -> None:
        """A finished/killed adopted row retires its handoff state —
        record + wire pages leave the store with the request."""
        idx = row.get("ho_idx")
        if idx is not None:
            P.clear_handoff(self.store, idx)

    def _reject_ready(self, idx: int, key: str, rec: dict) -> bool:
        """Deadline-expired before adoption: typed terminal reject of
        a DECODE_READY row (the handoff analog of _terminal_reject —
        that one requires LBL_INFER_REQ, which the prefill claim
        consumed)."""
        st = self.store
        try:
            st.label_clear(key, P.LBL_DECODE_READY)
            st.set(key, P.DEADLINE_EXPIRED_DIAGNOSTIC)
            st.label_or(key, P.LBL_READY)
            st.bump(key)
        except (KeyError, OSError):
            return False
        P.clear_handoff(st, idx)
        self.stats.deadline_expired += 1
        tenant = int(rec.get("tenant") or 0)
        if tenant:
            self.tenants.bump(tenant, "deadline_expired")
        return True

    def _adopt_ready(self, free: list[int], ctx: dict) -> int:
        """run_continuous's admission, decode edition: enumerate
        DECODE_READY handoffs in OUR stripes and seat each exactly
        where a unified join would have left it — carry token riding
        the fresh column, full worst-case page reservation, serial
        guard.  A row the pool cannot cover stays DECODE_READY
        (adopt_backpressure — never a mid-decode strand)."""
        import numpy as np
        st = self.store
        m = self._model
        cache = ctx["cache"]
        rows, fresh = ctx["rows"], ctx["fresh"]
        self.stripes.refresh()
        ready = [i for i in st.enumerate_indices(P.LBL_DECODE_READY)
                 if self.stripes.owns(int(i))]
        if not ready:
            return 0
        n = 0
        now_wall = time.time()
        for idx in ready:
            if not free:
                break
            try:
                labels = st.labels_at(idx)
            except (KeyError, OSError):
                continue
            if labels & P.LBL_SERVICING \
                    or not labels & P.LBL_DECODE_READY:
                continue              # adopted already / raced away
            rec = P.read_handoff_record(st, idx)
            if rec is None:
                continue              # record not landed yet
            key = st.key_at(idx)
            if key is None:
                continue
            dl = rec.get("deadline")
            if dl is not None and dl <= now_wall:
                # phase-aware QoS, decode side: an expired handoff
                # dies before consuming pool or a batch slot
                self._reject_ready(idx, key, rec)
                continue
            plen = int(rec.get("plen", 0))
            reserve = ctx["worst_len"](int(rec["len"]))
            if cache.pages_needed(reserve) > cache.available_pages:
                self._lane_stats["adopt_backpressure"] += 1
                continue              # stays DECODE_READY
            ta = time.perf_counter()
            try:
                st.label_or(key, P.LBL_SERVICING)
                st.bump(key)
            except (KeyError, OSError):
                continue
            # the chaos matrix crashes HERE — row claimed, nothing
            # imported: recovery re-opens it for re-adoption
            fault("decode.adopt")
            try:
                if plen and st.value_len(key) > plen:
                    # a dead adopter's partial tail (re-adoption
                    # without an intervening restart): greedy decode
                    # reproduces it byte-exact from the carry
                    st.set(key, st.get(key)[:plen])
                    self._lane_stats["readopted"] += 1
            except (KeyError, OSError):
                pass
            r = free[0]
            adopted = False
            wire = int(rec.get("wire_pages", 0))
            if wire > 0:
                pages_b, scales_b = [], []
                try:
                    for j in range(wire):
                        pages_b.append(
                            bytes(st.get(P.handoff_page_key(idx, j))))
                        if rec.get("quant"):
                            scales_b.append(bytes(
                                st.get(P.handoff_scale_key(idx, j))))
                        else:
                            scales_b.append(None)
                    adopted = m.paged_adopt_row(
                        cache, r, int(rec["len"]), pages_b,
                        scales_b if rec.get("quant") else None)
                except (KeyError, OSError, ValueError):
                    adopted = False
            if not adopted:
                # wire pages gone/mismatched (or never written): the
                # record's token ids re-prefill the prompt here —
                # greedy determinism keeps the bytes exact, and the
                # recorded carry still supplies the first token
                if not cache.ensure(r, int(rec["len"])):
                    self._unadopt(key)
                    continue
                self._lane_stats["handoff_refill"] += 1
                m.paged_prefill_row(
                    cache,
                    np.asarray(rec["ids"], np.int32), r)
            if not cache.ensure(r, reserve):
                # defensive: the reservation gate above makes this
                # unreachable — un-claim rather than strand mid-decode
                cache.free_row(r)
                self._unadopt(key)
                self._lane_stats["adopt_backpressure"] += 1
                continue
            free.pop(0)
            rows[r] = {"key": key, "t0": int(rec["t0"]),
                       "n_tok": int(rec["n_tok"]), "pending": b"",
                       "remaining": int(rec["remaining"]),
                       "stamp": None, "deadline": dl,
                       "tenant": int(rec.get("tenant") or 0),
                       "serial": next(ctx["serial"]),
                       "disp_left": int(rec["disp_left"]),
                       "spans": None,
                       "wall0": time.perf_counter(),
                       "ho_idx": int(idx)}
            fresh[r] = int(rec["carry"])
            ctx["span"](rows[r], "adopt",
                        (time.perf_counter() - ta) * 1e3)
            self._lane_stats["adopted"] += 1
            n += 1
        return n

    def _unadopt(self, key: str) -> None:
        """Back out a claimed-but-unseatable adoption: drop SERVICING,
        keep DECODE_READY — the row stays adoptable."""
        try:
            self.store.label_clear(key, P.LBL_SERVICING)
            self.store.bump(key)
        except (KeyError, OSError):
            pass
