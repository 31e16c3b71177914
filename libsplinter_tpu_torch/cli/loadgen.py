"""`spt loadgen` — the open-loop multi-tenant traffic generator.

Every bench phase before this was a CLOSED loop: N well-behaved
clients each waiting for their last request before issuing the next,
so offered load could never exceed service rate and the admission /
fairness / shedding machinery (engine/qos.py) had nothing to survive.
An open-loop generator issues arrivals on a clock — Poisson or fixed
rate — whether or not the server kept up (the CPU-inference paper's
point: throughput claims are meaningless without an arrival model
that can outrun the server).  This is the harness that turns the
three fast lanes into one testable serving system:

  - mixed embed / search / complete traffic in one run (configurable
    weights), against whatever daemons serve the store — in-process
    threads (tests), `spt supervise` children (the chaos drill), or a
    production deployment;
  - N tenants, each with its own arrival rate, deadline, and weight
    (`--tenant ID:RATE[:DEADLINE_MS[:WEIGHT]]`), tenant ids riding
    the bloom label word per engine/protocol.py;
  - Zipf hot-key skew over the seeded corpus (`--zipf`), so cache and
    coalescing behavior sees realistic popularity, not uniform picks;
  - per-tenant / per-lane p50/p95/p99 from the PR 2 log-bucketed
    histograms (obs/hist.py — the same quantile machinery the daemon
    heartbeats publish), goodput vs shed vs expired vs lost, and SLO
    pass/fail against thresholds given on the command line (non-zero
    exit on violation: CI gates on it);
  - `--scenario rag-churn`: each arrival is a scripted RAG pipeline —
    ingest a fresh doc -> wait for its embedding -> top-k search with
    a query derived from it -> complete a prompt built from the hits —
    the end-to-end flow the north star describes, deadline-checked as
    one request.  Run it against a `spt supervise`d stack with
    SPTPU_FAULT killing a lane mid-run and the report's `lost` count
    is the zero-admitted-request-loss evidence (stranded reclaim +
    supervisor restart under concurrent mixed traffic).

The generator is deliberately single-threaded: one loop issues due
arrivals and polls outstanding requests, so results are deterministic
under --seed and the generator itself can never outrun its own GIL
into measurement noise.  Open-loop fidelity comes from NON-BLOCKING
submits: a request is labels-and-bump, never a wait.
"""
from __future__ import annotations

import dataclasses
import json
import random
import time

import numpy as np

from ..engine import protocol as P
from ..obs.hist import LogHistogram
from .main import CliError, command

LANES = ("embed", "search", "complete")

# --- scenario registry ----------------------------------------------------
# A scenario turns each arrival into a multi-stage workload instead of
# a single-lane request.  "client" scenarios chain the stages from
# THIS process (one submit + poll round trip per stage — the pre-
# pipeline-lane baseline); "script" scenarios submit ONE pipeline-lane
# request naming a stored script (scripting/library.py) and the whole
# chain runs server-side.  New scenarios plug in here; an unknown
# name fails loudly with the valid set.


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    kind: str                    # "client-rag" | "script"
    script: str | None = None    # stored-script name (script kind)
    lane: str = "rag"            # report lane label


SCENARIOS: dict[str, Scenario] = {
    # the client-side chain: ingest -> embed -> top-k -> complete,
    # each hop a client round trip (the baseline the pipeline lane
    # is measured against)
    "rag-churn": Scenario("rag-churn", "client-rag"),
    # the same chain as ONE stored script in the pipeline lane
    "rag-churn-script": Scenario("rag-churn-script", "script",
                                 script="rag-churn", lane="script"),
    # script-only scenarios (no client-side equivalent exists):
    # iterative agent, two-hop retrieval, fan-out/fan-in summarize
    "agent-loop": Scenario("agent-loop", "script",
                           script="agent-loop", lane="script"),
    "multi-hop": Scenario("multi-hop", "script",
                          script="multi-hop", lane="script"),
    "map-reduce": Scenario("map-reduce", "script",
                           script="map-reduce", lane="script"),
    # complete-only arrivals where (by default) 90% of prompts draw
    # from a small pool of long common prefixes — the reproducible
    # hot-prefix mix the continuous lane's radix prefix cache
    # (engine/prefix_cache.py) is measured against; the summary
    # reports the completer's cache hit rate beside the per-tenant
    # SLOs.  `--shared-prefix P:LEN` overrides the 0.9:192 default.
    "shared-prefix": Scenario("shared-prefix", "complete",
                              lane="complete"),
    # complete-only arrivals in TWO traffic classes: a steady
    # decode floor (tenant 1: short prompts, full-length
    # completions — inter-chunk latency is its SLO) under a
    # piecewise prefill-heavy burst (tenant 2: long unique prompts,
    # rate stepped by --rate-profile; the floor tenant's rate is
    # NOT stepped).  The report carries TTFT p50/p99 and
    # inter-chunk p99 per phase per class — the disaggregated
    # prefill/decode lanes' proof harness (a unified lane's decode
    # p99 degrades with the burst; split lanes hold it flat).
    "prefill-burst": Scenario("prefill-burst", "prefill-burst",
                              lane="complete"),
}

# shared-prefix scenario defaults: (fraction of arrivals drawing a
# pooled prompt, pooled-prompt length in characters)
SHARED_PREFIX_DEFAULT = (0.9, 192)
SHARED_PREFIX_POOL = 4

# terminal states a request can reach
OK = "ok"               # served (within deadline unless counted late)
OK_LATE = "ok_late"     # served, but past the client deadline
SHED = "shed"           # typed overloaded (or embed label-only shed)
EXPIRED = "expired"     # daemon fast-failed the deadline
ERROR = "error"         # typed error record / ctx-exceeded
UNSERVED = "unserved"   # still WAITING when the run ended (backpressure)
LOST = "lost"           # admitted (claimed) but never completed — the
                        # zero-loss chaos assertion counts THESE


@dataclasses.dataclass
class TenantSpec:
    tenant: int
    rate: float                      # arrivals / second
    deadline_ms: float | None = None
    weight: float = 1.0

    @classmethod
    def parse(cls, spec: str) -> "TenantSpec":
        """ID:RATE[:DEADLINE_MS[:WEIGHT]]"""
        parts = spec.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"tenant spec {spec!r}: want ID:RATE[:DEADLINE_MS"
                "[:WEIGHT]]")
        t = cls(tenant=int(parts[0]), rate=float(parts[1]))
        if len(parts) > 2 and parts[2]:
            t.deadline_ms = float(parts[2])
        if len(parts) > 3 and parts[3]:
            t.weight = float(parts[3])
        if not 0 <= t.tenant <= P.MAX_TENANT or t.rate <= 0:
            raise ValueError(f"tenant spec {spec!r}: id 0..15, rate>0")
        return t


def parse_rate_profile(spec: str) -> list[tuple[float, float]]:
    """`--rate-profile 1x:10,8x:20,1x:10` -> [(mult, dur_s), ...]:
    a piecewise-constant schedule of offered-rate multipliers over
    the open-loop clock (the elastic-lane proof harness: step the
    rate, watch replicas follow).  The trailing `x` is optional."""
    out: list[tuple[float, float]] = []
    for part in spec.split(","):
        mult_s, sep, dur_s = part.strip().partition(":")
        if not sep:
            raise ValueError(
                f"rate profile wants MULTx:SECONDS[,...], got "
                f"{part.strip()!r}")
        if mult_s.endswith(("x", "X")):
            mult_s = mult_s[:-1]
        try:
            mult, dur = float(mult_s), float(dur_s)
        except ValueError:
            raise ValueError(
                f"rate profile wants MULTx:SECONDS[,...], got "
                f"{part.strip()!r}") from None
        if mult <= 0 or dur <= 0:
            raise ValueError("rate profile wants mult > 0, dur > 0")
        out.append((mult, dur))
    if not out:
        raise ValueError("empty rate profile")
    return out


class _Req:
    __slots__ = ("lane", "tenant", "key", "t_submit", "deadline_ts",
                 "state", "stage", "doc_key", "query_key", "hits",
                 "tid", "hops", "phase", "sub_len", "last_len",
                 "ttft_ms", "t_lastchunk", "gaps")

    def __init__(self, lane, tenant, key, t_submit, deadline_ts):
        self.lane = lane
        self.tenant = tenant
        self.key = key               # the key currently being polled
        self.t_submit = t_submit     # monotonic submit time
        self.deadline_ts = deadline_ts   # wall-clock deadline | None
        self.state = None            # terminal state once classified
        self.stage = 0               # rag pipeline position
        self.doc_key = None
        self.query_key = None
        self.hits = []
        self.tid = 0                 # head-sampled trace id (0 = off)
        self.hops = 0                # trace hops stamped so far
        self.phase = 0               # rate-profile phase index
        # streaming-progress probes (prefill-burst scenario): value
        # growth past the submitted prompt marks token flushes
        self.sub_len = None          # value_len at submit (prompt)
        self.last_len = None         # newest observed value_len
        self.ttft_ms = None          # first flush after submit
        self.t_lastchunk = None      # monotonic time of last flush
        self.gaps = []               # inter-chunk gaps (ms)


class LoadGenerator:
    """Programmatic surface (tests and the bench phase drive this
    directly; `spt loadgen` is a thin flag parser over it)."""

    def __init__(self, store, tenants: list[TenantSpec], *,
                 duration_s: float = 5.0,
                 mix: dict[str, float] | None = None,
                 arrivals: str = "poisson",
                 zipf: float = 1.1,
                 corpus: int = 32,
                 seed: int = 0,
                 scenario: str | None = None,
                 search_k: int = 4,
                 drain_s: float | None = None,
                 trace_sample: float = 0.0,
                 prompt: str = "summarize: ",
                 shared_prefix: tuple[float, int] | None = None,
                 rate_profile: list[tuple[float, float]]
                 | None = None):
        if arrivals not in ("poisson", "fixed"):
            raise ValueError("arrivals must be poisson|fixed")
        if scenario is not None and scenario not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {scenario!r} (available: "
                f"{', '.join(sorted(SCENARIOS))})")
        self._scen = SCENARIOS.get(scenario) if scenario else None
        self.store = store
        self.tenants = tenants
        self.duration_s = duration_s
        mix = dict(mix or {"embed": 1.0, "search": 1.0,
                           "complete": 1.0})
        bad = [ln for ln in mix if ln not in LANES]
        if bad:
            raise ValueError(f"unknown lanes in mix: {bad}")
        total = sum(mix.values()) or 1.0
        self.mix = {ln: mix.get(ln, 0.0) / total for ln in LANES}
        self.arrivals = arrivals
        self.zipf = zipf
        self.corpus = corpus
        self.scenario = scenario
        self.search_k = search_k
        # head sampling: each arrival is traced with probability p
        # (seeded — reruns trace the SAME arrivals), every hop of a
        # traced chain stamped with one trace id so an SLO miss is
        # one `spt trace show` away from per-hop attribution
        if not 0.0 <= trace_sample <= 1.0:
            raise ValueError("trace_sample must be in [0, 1]")
        self.trace_sample = trace_sample
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        # post-arrival grace: outstanding requests get this long to
        # resolve (a supervised restart mid-chaos needs real seconds)
        max_dl = max((t.deadline_ms or 0.0) for t in tenants)
        self.drain_s = drain_s if drain_s is not None \
            else max(2.0, 2 * max_dl / 1e3)
        self.prompt = prompt
        # hot-prefix traffic shaping: with (frac, length) set, `frac`
        # of complete-lane arrivals draw their WHOLE prompt from a
        # small pool of `length`-char common prompts (deterministic
        # content, seeded draw order — reruns produce the same mix),
        # so prefix-cache behavior is reproducible; the rest stay
        # unique.  The shared-prefix scenario defaults this on.
        if shared_prefix is None and scenario == "shared-prefix":
            shared_prefix = SHARED_PREFIX_DEFAULT
        if shared_prefix is not None:
            frac, plen = shared_prefix
            if not 0.0 < frac <= 1.0 or plen < 1:
                raise ValueError(
                    "shared_prefix wants (fraction in (0,1], "
                    "length >= 1)")
        self.shared_prefix = shared_prefix
        self._prefix_pool: list[str] = []
        # piecewise rate-step schedule (parse_rate_profile): phase p
        # multiplies every tenant's arrival rate by rate_profile[p][0]
        # for rate_profile[p][1] seconds; duration_s becomes the
        # profile's total, and the report gains a per-phase section
        # (seeded like everything else — reruns step identically)
        self.rate_profile = list(rate_profile) if rate_profile \
            else None
        if self.rate_profile:
            self.duration_s = sum(d for _, d in self.rate_profile)
        # prefill-burst scenario wiring: a default burst schedule, a
        # second (burst) tenant when only one was given, and the
        # floor-tenant marker _schedule consults (the floor's rate is
        # never stepped — the burst rides the profile alone)
        self._floor_tenant: int | None = None
        self.burst_metrics: dict[tuple[int, str],
                                 dict[str, list[float]]] = {}
        if self._scen is not None \
                and self._scen.kind == "prefill-burst":
            if self.rate_profile is None:
                self.rate_profile = parse_rate_profile(
                    "1x:4,10x:6,1x:4")
                self.duration_s = sum(
                    d for _, d in self.rate_profile)
            if len(self.tenants) == 1:
                t0 = self.tenants[0]
                self.tenants = [t0, TenantSpec(
                    tenant=min(P.MAX_TENANT, t0.tenant + 1),
                    rate=t0.rate, deadline_ms=t0.deadline_ms,
                    weight=t0.weight)]
            self._floor_tenant = self.tenants[0].tenant
        self._n = 0
        # per-phase accounting (rate profiles): state counts and an
        # exact-latency list per phase index
        self.phase_counts: dict[int, dict[str, int]] = {}
        self.phase_ms: dict[int, list[float]] = {}
        # per-(tenant, lane) latency histograms — the PR 2 log-bucketed
        # quantile machinery, so p50/p95/p99 here and in the daemon
        # heartbeats come from the same estimator
        self.hists: dict[tuple[int, str], LogHistogram] = {}
        self.counts: dict[tuple[int, str], dict[str, int]] = {}
        # exact per-request latencies (ms), alongside the log-bucketed
        # report quantiles: the histogram's ~19%-wide buckets are fine
        # for dashboards but too coarse for A/B latency GATES (the
        # pipeline-lane p50 bar) — those read raw_ms and take an
        # exact percentile
        self.raw_ms: dict[tuple[int, str], list[float]] = {}
        # (latency_ms, trace_id, lane) per COMPLETED traced request,
        # per tenant — the report surfaces each tenant's k slowest
        self.traced_done: dict[int, list[tuple]] = {}

    # -- corpus ------------------------------------------------------------

    def seed_corpus(self) -> None:
        """Pre-seed `corpus` doc rows with deterministic unit vectors
        so the search lane has candidates from the first arrival (the
        rag-churn scenario grows it live through real ingests too)."""
        st = self.store
        d = st.vec_dim
        for i in range(self.corpus):
            key = f"lgd{i}"
            st.set(key, f"seed document {i} about topic {i % 7}")
            v = self.np_rng.standard_normal(d).astype(np.float32)
            st.vec_set(key, v / (np.linalg.norm(v) or 1.0))
        if self._scen is not None and self._scen.kind == "script":
            # script scenarios run the STORED library program: seed it
            # so the pipeline lane resolves {"name": ...} requests
            from ..scripting.library import seed_library
            seed_library(st, [self._scen.script])

    def _zipf_doc(self) -> int:
        """Zipf-skewed corpus pick: rank r with p ∝ 1/r^s."""
        if self.corpus <= 1:
            return 0
        # inverse-CDF over precomputed weights (tiny corpus: fine)
        if not hasattr(self, "_zipf_cdf"):
            w = np.arange(1, self.corpus + 1, dtype=np.float64) \
                ** -max(self.zipf, 0.0)
            self._zipf_cdf = np.cumsum(w / w.sum())
        return int(np.searchsorted(self._zipf_cdf, self.rng.random()))

    def _complete_prompt(self) -> str:
        """One complete-lane prompt: a pooled hot-prefix prompt with
        probability `shared_prefix[0]`, else a unique Zipf-doc one."""
        sp = self.shared_prefix
        if sp is not None and self.rng.random() < sp[0]:
            if not self._prefix_pool:
                frac, plen = sp
                for i in range(SHARED_PREFIX_POOL):
                    seed_txt = (f"system preamble {i}: you are a "
                                f"careful assistant. context shard "
                                f"{i} of the corpus follows. ")
                    reps = -(-plen // len(seed_txt))
                    self._prefix_pool.append(
                        (seed_txt * reps)[:plen])
            return self._prefix_pool[
                self.rng.randrange(len(self._prefix_pool))]
        return f"{self.prompt}document {self._zipf_doc()}"

    def _query_vec(self, doc_key: str) -> np.ndarray:
        st = self.store
        try:
            v = st.vec_get(doc_key).astype(np.float32)
        except (KeyError, OSError):
            v = np.zeros(st.vec_dim, np.float32)
        if not np.abs(v).max() > 0:
            v = self.np_rng.standard_normal(st.vec_dim) \
                .astype(np.float32)
        v = v + 0.1 * self.np_rng.standard_normal(len(v)) \
            .astype(np.float32)
        return v / (np.linalg.norm(v) or 1.0)

    # -- non-blocking submits ----------------------------------------------

    def _stamp(self, key: str, tenant: int,
               deadline_ts: float | None) -> None:
        if tenant:
            P.stamp_tenant(self.store, key, tenant)
        if deadline_ts is not None:
            P.stamp_deadline(self.store, key, deadline_ts)

    def _trace_stamp(self, req: _Req) -> None:
        """One trace id across every hop of a sampled request: the
        first hop is the root span (span id == trace id), later hops
        of a client-side chain hang under it — the same tree shape
        the pipeline lane produces for a stored script."""
        if not req.tid:
            return
        if req.hops == 0:
            P.stamp_trace(self.store, req.key, trace_id=req.tid,
                          parent=0, span=req.tid)
        else:
            P.stamp_trace(self.store, req.key, trace_id=req.tid,
                          parent=req.tid)
        req.hops += 1

    def _submit_embed(self, req: _Req, text: str | None = None) -> None:
        st = self.store
        st.set(req.key, text if text is not None else
               f"live document {self._n} about topic {self._n % 7}")
        self._stamp(req.key, req.tenant, req.deadline_ts)
        self._trace_stamp(req)
        st.label_or(req.key, P.LBL_EMBED_REQ | P.LBL_WAITING)
        st.bump(req.key)

    def _submit_search(self, req: _Req, qvec: np.ndarray) -> None:
        st = self.store
        params = {"k": self.search_k}
        if req.deadline_ts is not None:
            params["deadline"] = round(req.deadline_ts, 6)
        st.set(req.key, json.dumps(params))
        st.vec_set(req.key, qvec)
        self._stamp(req.key, req.tenant, None)  # deadline rides JSON
        self._trace_stamp(req)
        st.label_or(req.key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
        st.bump(req.key)

    def _submit_complete(self, req: _Req, prompt: str) -> None:
        st = self.store
        st.set(req.key, prompt)
        self._stamp(req.key, req.tenant, req.deadline_ts)
        self._trace_stamp(req)
        st.label_or(req.key, P.LBL_INFER_REQ | P.LBL_WAITING)
        st.bump(req.key)

    def _submit_script(self, req: _Req, name: str, args: list) -> None:
        """One pipeline-lane request: the whole chain is the stored
        script's business — the deadline rides the request JSON (the
        searcher's form) and the tenant rides the label word, so QoS
        spans every verb the script dispatches."""
        st = self.store
        body: dict = {"name": name, "args": args}
        if req.deadline_ts is not None:
            body["deadline"] = round(req.deadline_ts, 6)
        st.set(req.key, json.dumps(body))
        self._stamp(req.key, req.tenant, None)  # deadline rides JSON
        self._trace_stamp(req)
        st.label_or(req.key, P.LBL_SCRIPT_REQ | P.LBL_WAITING)
        st.bump(req.key)

    def _issue(self, tenant: TenantSpec, phase: int = 0) -> _Req:
        self._n += 1
        n = self._n
        deadline_ts = (time.time() + tenant.deadline_ms / 1e3
                       if tenant.deadline_ms else None)
        if self._scen is not None:
            lane = self._scen.lane
        else:
            r = self.rng.random()
            acc = 0.0
            lane = LANES[-1]
            for ln in LANES:
                acc += self.mix[ln]
                if r < acc:
                    lane = ln
                    break
        req = _Req(lane, tenant.tenant, f"lg{lane[0]}{n}",
                   time.monotonic(), deadline_ts)
        req.phase = phase
        if self.trace_sample and \
                self.rng.random() < self.trace_sample:
            req.tid = P.next_trace_id()
        if lane == "embed":
            self._submit_embed(req)
        elif lane == "search":
            req.key = f"lgq{n}"
            self._submit_search(
                req, self._query_vec(f"lgd{self._zipf_doc()}"))
        elif lane == "complete":
            if self._floor_tenant is not None:
                # prefill-burst classes: the floor's short prompt is
                # decode-bound (full max_new completion), the burst's
                # long UNIQUE prompt is prefill-bound (no prefix
                # cache hit can absorb it); the class rides req.lane
                # so the report splits them without new plumbing
                if tenant.tenant == self._floor_tenant:
                    req.lane = "decode-floor"
                    prompt = f"floor {n} go"
                else:
                    req.lane = "prefill-burst"
                    prompt = (f"analyze shard {n}: "
                              + f"ctx{n % 97} " * 48)
                self._submit_complete(req, prompt)
                req.sub_len = self.store.value_len(req.key)
                req.last_len = req.sub_len
            else:
                self._submit_complete(req, self._complete_prompt())
        elif lane == "script":        # one server-side scripted chain
            req.doc_key = f"lgr{n}"
            req.key = f"lgp{n}"
            self._submit_script(req, self._scen.script,
                                [req.doc_key, n])
        else:                         # rag-churn stage 0: ingest
            req.doc_key = f"lgr{n}"
            req.key = req.doc_key
            req.stage = 0
            self._submit_embed(
                req, f"churn document {n} about topic {n % 7}")
        return req

    # -- polling / classification ------------------------------------------

    def _poll(self, req: _Req) -> bool:
        """True when `req` reached a terminal state (req.state set)."""
        try:
            labels = self.store.labels(req.key)
        except KeyError:
            req.state = LOST          # key vanished mid-request
            return True
        lane = req.lane if req.lane != "rag" else \
            ("embed", "search", "complete")[req.stage]
        if lane == "script":
            if labels & P.LBL_SCRIPT_REQ:
                return False          # the chain is the lane's business
            rec = None
            try:
                idx = self.store.find_index(req.key)
                raw = self.store.get(P.script_result_key(idx))
                rec = json.loads(raw.rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                pass
            if rec is None:
                req.state = LOST      # label cleared, result missing
                return True
            err = rec.get("err")
            if err == P.ERR_OVERLOADED:
                req.state = SHED
            elif err == P.ERR_DEADLINE:
                req.state = EXPIRED
            elif err:
                req.state = ERROR
            else:
                self._finish_ok(req)
            from ..engine.pipeliner import consume_script_result
            consume_script_result(self.store, req.key)
            return True
        if lane == "embed":
            if labels & P.LBL_EMBED_REQ:
                return False          # still queued
            if labels & P.LBL_CTX_EXCEEDED:
                req.state = ERROR
                return True
            vec_ok = False
            try:
                vec_ok = bool(
                    np.abs(self.store.vec_get(req.key)).max() > 0)
            except (KeyError, OSError):
                pass
            if not vec_ok:
                # label-only unblock with no vector: the embed lane's
                # shed/deadline signal (the daemon counters say which)
                req.state = SHED if req.deadline_ts is None \
                    or time.time() < req.deadline_ts else EXPIRED
                return True
            return self._advance(req)
        if lane == "search":
            if labels & P.LBL_SEARCH_REQ:
                return False
            rec = None
            try:
                idx = self.store.find_index(req.key)
                raw = self.store.get(P.search_result_key(idx))
                rec = json.loads(raw.rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                pass
            if rec is None:
                req.state = LOST      # label cleared, result missing
                return True
            err = rec.get("err")
            if err == P.ERR_OVERLOADED:
                req.state = SHED
            elif err == P.ERR_DEADLINE:
                req.state = EXPIRED
            elif err:
                req.state = ERROR
            else:
                req.hits = list(rec.get("keys", []))
                from ..engine.searcher import consume_result
                consume_result(self.store, req.key)
                return self._advance(req)
            from ..engine.searcher import consume_result
            consume_result(self.store, req.key)
            return True
        # complete lane
        if req.sub_len is not None:
            self._chunk_probe(req)
        if not labels & P.LBL_READY:
            return False
        rec = None
        try:
            rec = P.parse_error_payload(self.store.get(req.key))
        except (KeyError, OSError):
            req.state = LOST
            return True
        if rec is not None:
            err = rec.get("err")
            req.state = (SHED if err == P.ERR_OVERLOADED
                         else EXPIRED if err == P.ERR_DEADLINE
                         else ERROR)
            return True
        return self._advance(req)

    def _chunk_probe(self, req: _Req) -> None:
        """Streaming-progress probe (prefill-burst): every value_len
        growth past the last observation is a token flush — the first
        one is TTFT, the rest accumulate inter-chunk gaps.  Flush
        granularity (--flush-tokens) is part of what's measured: the
        client-visible chunk cadence IS the streaming SLO."""
        try:
            vl = self.store.value_len(req.key)
        except (KeyError, OSError):
            return
        if vl <= (self.last_len_of(req)):
            return
        now = time.monotonic()
        if req.ttft_ms is None:
            req.ttft_ms = (now - req.t_submit) * 1e3
        elif req.t_lastchunk is not None:
            req.gaps.append((now - req.t_lastchunk) * 1e3)
        req.t_lastchunk = now
        req.last_len = vl

    @staticmethod
    def last_len_of(req: _Req) -> int:
        return req.last_len if req.last_len is not None \
            else (req.sub_len or 0)

    def _advance(self, req: _Req) -> bool:
        """One stage done: terminal for plain lanes, next stage for the
        rag pipeline."""
        if req.lane != "rag" or req.stage >= 2:
            self._finish_ok(req)
            return True
        req.stage += 1
        n = self._n
        if req.stage == 1:            # ingest done -> search
            req.query_key = f"lgrq{req.doc_key}"
            qvec = self._query_vec(req.doc_key)
            req.key = req.query_key
            self._submit_search(req, qvec)
        else:                         # search done -> complete
            ctx = ", ".join(req.hits[:3]) or "nothing"
            req.key = f"lgrc{req.doc_key}"
            self._submit_complete(
                req, f"context: {ctx}\nquestion: what is "
                     f"{req.doc_key} about?")
        return False

    def _finish_ok(self, req: _Req) -> None:
        late = (req.deadline_ts is not None
                and time.time() > req.deadline_ts)
        req.state = OK_LATE if late else OK

    def _record(self, req: _Req) -> None:
        lane = req.lane
        key = (req.tenant, lane)
        self.counts.setdefault(key, {})
        self.counts[key][req.state] = \
            self.counts[key].get(req.state, 0) + 1
        if self.rate_profile:
            pc = self.phase_counts.setdefault(req.phase, {})
            pc[req.state] = pc.get(req.state, 0) + 1
        if req.state in (OK, OK_LATE):
            ms = (time.monotonic() - req.t_submit) * 1e3
            self.hists.setdefault(key, LogHistogram()).record(ms)
            self.raw_ms.setdefault(key, []).append(ms)
            if self.rate_profile:
                self.phase_ms.setdefault(req.phase, []).append(ms)
            if req.tid:
                self.traced_done.setdefault(req.tenant, []).append(
                    (ms, req.tid, lane))
            if req.sub_len is not None:
                m = self.burst_metrics.setdefault(
                    (req.phase, lane), {"ttft": [], "gaps": []})
                if req.ttft_ms is not None:
                    m["ttft"].append(req.ttft_ms)
                m["gaps"].extend(req.gaps)
        # recycle terminal keys so a long run cannot exhaust slots
        for k in (req.key, req.doc_key, req.query_key):
            if k and req.state != LOST:
                try:
                    self.store.unset(k)
                except (KeyError, OSError):
                    pass

    # -- the run -----------------------------------------------------------

    def _phase_at(self, when: float) -> int:
        """The rate-profile phase covering offset `when` (0 with no
        profile)."""
        if not self.rate_profile:
            return 0
        acc = 0.0
        for p, (_m, dur) in enumerate(self.rate_profile):
            acc += dur
            if when < acc:
                return p
        return len(self.rate_profile) - 1

    def _schedule(self) -> list[tuple[float, TenantSpec, int]]:
        """Precompute every arrival's offset: open loop means the
        clock, not the server, decides when requests exist.  With a
        rate profile, each phase multiplies every tenant's rate —
        gaps are drawn at the LIVE phase's rate, so the offered load
        steps exactly at the phase boundaries."""
        out: list[tuple[float, TenantSpec, int]] = []
        for t in self.tenants:
            # prefill-burst: the decode-floor tenant's rate is steady
            # by construction — only the burst tenant steps
            steady = (self._floor_tenant is not None
                      and t.tenant == self._floor_tenant)
            when = 0.0
            while True:
                mult = (self.rate_profile[self._phase_at(when)][0]
                        if self.rate_profile and not steady else 1.0)
                rate = t.rate * mult
                if self.arrivals == "poisson":
                    when += self.rng.expovariate(rate)
                else:
                    when += 1.0 / rate
                if when >= self.duration_s:
                    break
                out.append((when, t, self._phase_at(when)))
        out.sort(key=lambda x: x[0])
        return out

    def run(self) -> dict:
        self.seed_corpus()
        schedule = self._schedule()
        t0 = time.monotonic()
        outstanding: list[_Req] = []
        done: list[_Req] = []
        i = 0
        hard_stop = t0 + self.duration_s + self.drain_s
        while True:
            now = time.monotonic()
            while i < len(schedule) and schedule[i][0] <= now - t0:
                outstanding.append(self._issue(schedule[i][1],
                                               schedule[i][2]))
                i += 1
            still: list[_Req] = []
            for req in outstanding:
                if self._poll(req):
                    done.append(req)
                    self._record(req)
                else:
                    still.append(req)
            outstanding = still
            if i >= len(schedule) and not outstanding:
                break
            if now >= hard_stop:
                break
            # pace the poll loop without closing the arrival loop
            next_due = (schedule[i][0] + t0 if i < len(schedule)
                        else now + 0.005)
            time.sleep(min(max(next_due - now, 0.0), 0.005))
        # whatever is still outstanding: backpressure or in-flight
        # (request label still up, or SERVICING = a live daemon is
        # mid-generation at the cutoff) vs LOST (no label at all and
        # no terminal signal: the request fell out of the protocol —
        # the chaos drill's zero-loss assertion counts these)
        for req in outstanding:
            try:
                labels = self.store.labels(req.key)
            except KeyError:
                labels = 0
            req.state = UNSERVED if labels & (
                P.LBL_EMBED_REQ | P.LBL_SEARCH_REQ | P.LBL_INFER_REQ
                | P.LBL_SCRIPT_REQ | P.LBL_SERVICING
                | P.LBL_WAITING) else LOST
            done.append(req)
            self._record(req)
        return self.report(done, time.monotonic() - t0)

    # -- reporting ---------------------------------------------------------

    def report(self, done: list[_Req], wall_s: float) -> dict:
        totals = dict.fromkeys(
            (OK, OK_LATE, SHED, EXPIRED, ERROR, UNSERVED, LOST), 0)
        for req in done:
            totals[req.state] = totals.get(req.state, 0) + 1
        issued = len(done)
        per_tenant: dict = {}
        for (tenant, lane), counts in sorted(self.counts.items()):
            sect = per_tenant.setdefault(str(tenant), {})
            row = dict(counts)
            h = self.hists.get((tenant, lane))
            if h is not None and h.n:
                row.update(n=h.n,
                           p50_ms=round(h.quantile(0.5), 3),
                           p95_ms=round(h.quantile(0.95), 3),
                           p99_ms=round(h.quantile(0.99), 3))
            sect[lane] = row
        # each tenant's k slowest traced requests: an SLO miss is one
        # `spt trace show <id>` away from per-hop attribution
        for tenant, rows in self.traced_done.items():
            sect = per_tenant.setdefault(str(tenant), {})
            sect["slow_traces"] = [
                {"trace": f"{tid:#x}", "ms": round(ms, 3),
                 "lane": lane}
                for ms, tid, lane in sorted(rows, reverse=True)[:3]]
        rep = {
            "scenario": self.scenario or "mixed",
            "arrivals": self.arrivals,
            "duration_s": round(wall_s, 3),
            "issued": issued,
            **totals,
            "goodput_rps": round(totals[OK] / wall_s, 3)
            if wall_s > 0 else 0.0,
            "goodput_ratio": round(totals[OK] / issued, 4)
            if issued else 0.0,
            "per_tenant": per_tenant,
        }
        pfx = self._prefix_cache_report()
        if pfx is not None:
            rep["prefix_cache"] = pfx
        if self.rate_profile:
            rep["rate_profile"] = self._phase_report()
        if self._floor_tenant is not None:
            rep["prefill_burst"] = self._burst_report()
        return rep

    @staticmethod
    def _exact_pct(ms: list[float], q: float) -> float:
        s = sorted(ms)
        return round(s[min(len(s) - 1, int(len(s) * q))], 3)

    def _burst_report(self) -> list[dict]:
        """Per-phase, per-class streaming quantiles for the
        prefill-burst scenario: the decode floor's inter-chunk p99
        across the burst phases IS the disaggregation proof (flat
        under split lanes, degraded under a unified one), and the
        burst class's TTFT shows what the prefill queue is doing."""
        out = []
        for p, (mult, dur) in enumerate(self.rate_profile or []):
            row: dict = {"phase": p, "mult": mult, "dur_s": dur}
            for cls in ("decode-floor", "prefill-burst"):
                m = self.burst_metrics.get((p, cls))
                if not m:
                    continue
                sect: dict = {"n": len(m["ttft"])}
                if m["ttft"]:
                    sect["ttft_p50_ms"] = self._exact_pct(
                        m["ttft"], 0.5)
                    sect["ttft_p99_ms"] = self._exact_pct(
                        m["ttft"], 0.99)
                if m["gaps"]:
                    sect["interchunk_p50_ms"] = self._exact_pct(
                        m["gaps"], 0.5)
                    sect["interchunk_p99_ms"] = self._exact_pct(
                        m["gaps"], 0.99)
                row[cls] = sect
            out.append(row)
        return out

    def _phase_report(self) -> list[dict]:
        """Per-phase goodput + exact p50/p99 for a rate-profile run
        (exact percentiles from raw latencies — the log-histogram's
        ~19%-wide buckets are too coarse to judge a step response)."""
        out = []
        for p, (mult, dur) in enumerate(self.rate_profile or []):
            counts = dict(self.phase_counts.get(p, {}))
            issued = sum(counts.values())
            ok = counts.get(OK, 0)
            row = {"phase": p, "mult": mult, "dur_s": dur,
                   "issued": issued, **counts,
                   "goodput_ratio": round(ok / issued, 4)
                   if issued else 0.0}
            ms = sorted(self.phase_ms.get(p, []))
            if ms:
                row["p50_ms"] = round(ms[len(ms) // 2], 3)
                row["p99_ms"] = round(
                    ms[min(len(ms) - 1, int(len(ms) * 0.99))], 3)
            out.append(row)
        return out

    def _prefix_cache_report(self) -> dict | None:
        """The completer's prefix-cache gauges as of its LAST
        heartbeat (the generator only sees the store — counts lag by
        at most one heartbeat interval).  None when no continuous
        completer published them (cache off, dense lane, or no
        completer at all)."""
        try:
            raw = self.store.get(P.KEY_COMPLETE_STATS)
            snap = json.loads(raw.rstrip(b"\0"))
        except (KeyError, OSError, ValueError):
            return None
        if not isinstance(snap, dict) or "prefix_hits" not in snap:
            return None
        hits = int(snap.get("prefix_hits", 0))
        misses = int(snap.get("prefix_misses", 0))
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            "hit_tokens": snap.get("prefix_hit_tokens", 0),
            "shared_pages": snap.get("prefix_shared_pages", 0),
            "evictions": snap.get("prefix_evictions", 0),
            "cow_copies": snap.get("prefix_cow_copies", 0),
            "bytes_saved": snap.get("prefix_bytes_saved", 0),
        }


def evaluate_slo(report: dict, *, p99_ms: float | None = None,
                 goodput: float | None = None,
                 max_lost: int = 0) -> list[str]:
    """SLO thresholds -> list of violations (empty = pass).  The
    zero-admitted-loss bound is always enforced (max_lost)."""
    out: list[str] = []
    if report.get("lost", 0) > max_lost:
        out.append(f"lost={report['lost']} admitted requests never "
                   f"completed (max {max_lost})")
    if goodput is not None:
        if not report.get("issued"):
            # zero arrivals measured nothing — an SLO gate that
            # silently passes an empty run is worse than no gate
            out.append("no requests issued — goodput SLO unevaluable")
        elif report["goodput_ratio"] < goodput:
            out.append(f"goodput {report['goodput_ratio']:.3f} < "
                       f"SLO {goodput}")
    if p99_ms is not None:
        for tenant, lanes in report.get("per_tenant", {}).items():
            for lane, row in lanes.items():
                if not isinstance(row, dict):
                    continue          # slow_traces list rides along
                p99 = row.get("p99_ms")
                if p99 is not None and p99 > p99_ms:
                    out.append(f"tenant {tenant} {lane} p99 "
                               f"{p99:.1f}ms > SLO {p99_ms}ms")
    return out


@command("loadgen",
         "loadgen [--duration S] [--rate R] [--tenants N] "
         "[--tenant ID:RATE[:DEADLINE_MS[:WEIGHT]]]... "
         "[--mix embed:W,search:W,complete:W] "
         "[--arrivals poisson|fixed] [--zipf S] [--corpus N] "
         "[--seed N] [--scenario rag-churn|rag-churn-script|"
         "agent-loop|multi-hop|map-reduce|shared-prefix|"
         "prefill-burst] [--k K] "
         "[--shared-prefix P:LEN] [--rate-profile 1x:10,8x:20,"
         "1x:10] [--drain-s S] "
         "[--trace-sample P] [--slo-p99-ms MS] [--slo-goodput F] "
         "[--json]",
         "open-loop multi-tenant load generator with per-tenant "
         "p50/p95/p99, goodput vs shed, SLO pass/fail, and head-"
         "sampled tracing (--trace-sample: each tenant's slowest "
         "trace ids land in the summary; --shared-prefix P:LEN "
         "draws that fraction of complete prompts from a pooled "
         "hot-prefix set and the summary reports the completer's "
         "prefix-cache hit rate; --rate-profile steps the offered "
         "rate piecewise over the open-loop clock — the elastic-"
         "lane proof harness — with per-phase goodput/p99 in the "
         "summary; --scenario prefill-burst runs a steady decode-"
         "floor tenant under a rate-stepped prefill-heavy burst "
         "tenant and reports TTFT p50/p99 + inter-chunk p99 per "
         "phase per class — the disaggregated-lane harness)")
def cmd_loadgen(ses, args):
    duration = 5.0
    rate = 20.0
    n_tenants = 1
    tenants: list[TenantSpec] = []
    mix = None
    arrivals = "poisson"
    zipf = 1.1
    corpus = 32
    seed = 0
    scenario = None
    k = 4
    drain_s = None
    trace_sample = 0.0
    shared_prefix = None
    rate_profile = None
    slo_p99 = None
    slo_goodput = None
    as_json = False

    it = iter(args)

    def val(flag):
        try:
            return next(it)
        except StopIteration:
            raise CliError(f"{flag} requires a value") from None

    for a in it:
        if a == "--duration":
            duration = float(val(a))
        elif a == "--rate":
            rate = float(val(a))
        elif a == "--tenants":
            n_tenants = int(val(a))
        elif a == "--tenant":
            try:
                tenants.append(TenantSpec.parse(val(a)))
            except ValueError as e:
                raise CliError(str(e)) from None
        elif a == "--mix":
            mix = {}
            for part in val(a).split(","):
                ln, sep, w = part.partition(":")
                if not sep:
                    raise CliError("--mix wants lane:W[,lane:W...]")
                mix[ln.strip()] = float(w)
        elif a == "--arrivals":
            arrivals = val(a)
        elif a == "--zipf":
            zipf = float(val(a))
        elif a == "--corpus":
            corpus = int(val(a))
        elif a == "--seed":
            seed = int(val(a))
        elif a == "--scenario":
            scenario = val(a)
        elif a == "--k":
            k = int(val(a))
        elif a == "--drain-s":
            drain_s = float(val(a))
        elif a == "--trace-sample":
            trace_sample = float(val(a))
        elif a == "--shared-prefix":
            frac, sep, plen = val(a).partition(":")
            if not sep:
                raise CliError("--shared-prefix wants P:LEN (e.g. "
                               "0.9:192)")
            try:
                shared_prefix = (float(frac), int(plen))
            except ValueError:
                raise CliError(
                    "--shared-prefix wants P:LEN (fraction:chars)"
                ) from None
        elif a == "--rate-profile":
            try:
                rate_profile = parse_rate_profile(val(a))
            except ValueError as e:
                raise CliError(str(e)) from None
        elif a == "--slo-p99-ms":
            slo_p99 = float(val(a))
        elif a == "--slo-goodput":
            slo_goodput = float(val(a))
        elif a == "--json":
            as_json = True
        else:
            raise CliError(f"unknown flag {a!r} (see `help loadgen`)")

    if not tenants:
        # N identical tenants sharing --rate (ids 1..N); the id space
        # is the label field's 15 — validate HERE, not mid-run when
        # the first arrival's stamp_tenant would raise
        if not 1 <= n_tenants <= P.MAX_TENANT:
            raise CliError(
                f"--tenants wants 1..{P.MAX_TENANT} (tenant ids ride "
                "a 4-bit label field)")
        per = rate / n_tenants
        tenants = [TenantSpec(tenant=i + 1, rate=per)
                   for i in range(n_tenants)]
    try:
        gen = LoadGenerator(ses.store, tenants, duration_s=duration,
                            mix=mix, arrivals=arrivals, zipf=zipf,
                            corpus=corpus, seed=seed,
                            scenario=scenario, search_k=k,
                            drain_s=drain_s,
                            trace_sample=trace_sample,
                            shared_prefix=shared_prefix,
                            rate_profile=rate_profile)
    except ValueError as e:
        raise CliError(str(e)) from None
    report = gen.run()
    violations = evaluate_slo(report, p99_ms=slo_p99,
                              goodput=slo_goodput)
    report["slo"] = {"pass": not violations,
                     "violations": violations}
    if as_json:
        print(json.dumps(report, indent=2))
    else:
        print(f"loadgen {report['scenario']} — {report['issued']} "
              f"issued over {report['duration_s']}s "
              f"({report['arrivals']} arrivals)")
        print(f"  ok={report['ok']} ok_late={report['ok_late']} "
              f"shed={report['shed']} expired={report['expired']} "
              f"error={report['error']} unserved={report['unserved']} "
              f"lost={report['lost']}")
        print(f"  goodput {report['goodput_rps']} req/s "
              f"({report['goodput_ratio']:.1%} of issued)")
        for row in report.get("rate_profile", []):
            q = (f" p50={row['p50_ms']}ms p99={row['p99_ms']}ms"
                 if "p50_ms" in row else "")
            cnt = " ".join(f"{s}={row[s]}" for s in
                           (OK, OK_LATE, SHED, EXPIRED, ERROR,
                            UNSERVED, LOST) if row.get(s))
            print(f"  phase {row['phase']} ({row['mult']:g}x for "
                  f"{row['dur_s']:g}s): {row['issued']} issued, "
                  f"goodput {row['goodput_ratio']:.1%} {cnt}{q}")
        for row in report.get("prefill_burst", []):
            parts = []
            for cls in ("decode-floor", "prefill-burst"):
                sect = row.get(cls)
                if not sect:
                    continue
                bits = [f"{cls} n={sect['n']}"]
                if "ttft_p50_ms" in sect:
                    bits.append(f"ttft p50={sect['ttft_p50_ms']}ms "
                                f"p99={sect['ttft_p99_ms']}ms")
                if "interchunk_p99_ms" in sect:
                    bits.append(
                        f"interchunk p99="
                        f"{sect['interchunk_p99_ms']}ms")
                parts.append(" ".join(bits))
            print(f"  burst phase {row['phase']} "
                  f"({row['mult']:g}x for {row['dur_s']:g}s): "
                  + " | ".join(parts or ["no completions"]))
        pfx = report.get("prefix_cache")
        if pfx:
            print(f"  prefix cache: hit rate {pfx['hit_rate']:.1%} "
                  f"({pfx['hits']} hits / {pfx['misses']} misses, "
                  f"{pfx['shared_pages']} shared pages, "
                  f"{pfx['cow_copies']} cow, "
                  f"{pfx['bytes_saved'] / 1e6:.2f} MB saved)")
        for tenant, lanes in report["per_tenant"].items():
            for lane, row in lanes.items():
                if lane == "slow_traces":
                    ids = " ".join(
                        f"{r['trace']}({r['ms']}ms)" for r in row)
                    print(f"  tenant {tenant} slowest traces: {ids} "
                          f"— `spt trace show <id>` for the hop "
                          f"breakdown")
                    continue
                q = (f" p50={row['p50_ms']}ms p95={row['p95_ms']}ms "
                     f"p99={row['p99_ms']}ms" if "p50_ms" in row
                     else "")
                cnt = " ".join(f"{s}={c}" for s, c in row.items()
                               if s in (OK, OK_LATE, SHED, EXPIRED,
                                        ERROR, UNSERVED, LOST))
                print(f"  tenant {tenant} {lane:<9} {cnt}{q}")
    if violations:
        raise CliError("SLO FAIL: " + "; ".join(violations))
    print("SLO PASS" if (slo_p99 is not None
                         or slo_goodput is not None) else "done")
