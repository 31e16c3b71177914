"""The pipeline lane — server-side scripted RAG chains.

Every multi-stage workload before this daemon chained client-side:
`spt loadgen --scenario rag-churn` pays a client round trip per
ingest -> embed -> top-k -> complete hop, each hop a submit + poll
against a different lane.  The reference's whole identity is the
opposite — a "cooperative userspace hypervisor" running Lua programs
*next to the data* (splinter_cli_cmd_lua.c) — so this lane moves the
orchestration server-side: a request is ONE slot carrying a Lua
script (inline source, or the name of a stored `__script_<name>`
program), executed in a sandboxed runtime whose splinter verbs are
**yielding coroutine awaits**:

  - `splinter.submit_embed(key, text)`, `submit_search(key, k)`,
    `submit_completion(key, prompt)`, `sleep(s)` issue the
    NON-BLOCKING submit (set + QoS stamps + label + bump — the
    engine/client.py wire discipline) and suspend the script's
    coroutine; ONE drain loop multiplexes every in-flight script,
    polling awaited slots and resuming whichever became ready — no
    blocking wait anywhere on the lane's pump path;
  - every verb inherits the REQUEST's tenant id and absolute
    deadline (`stamp_tenant` / `stamp_deadline` ride through), so
    admission, stride fairness, and deadline fast-fail in the
    downstream lanes span the whole chain, not one hop;
  - sandboxing is enforced in the host (scripting/sandbox.py): step
    budget, verb budget, capped coroutines, allocation guard,
    deadline-derived wall clock, no `os`/`io` — a hostile script dies
    with a typed record (`budget_exceeded` / `deadline_expired` /
    `script_error`) while sibling in-flight scripts run unharmed.

Request contract (one slot per request):
  value    JSON {"script": "<lua source>"} or {"name": "<stored>"},
           optional "args": [...] (script `arg` table / varargs),
           optional "deadline": absolute wall-clock ts (the searcher's
           JSON form; the `__dl_<idx>` companion stamp works too)
  labels   LBL_SCRIPT_REQ (+ LBL_WAITING), tenant bits, then bump.

Result contract: JSON in script_result_key(request_slot_index)
(`__pr_<idx>`) — {"ok": true, "ret": [...]} or a typed error record —
then LBL_SCRIPT_REQ + LBL_WAITING clear and the request key bumps.
LBL_SCRIPT_REQ stays SET while a script executes: a lane crash
mid-script leaves the label up, so the restarted daemon's first drain
reclaims and re-runs the request (crash-only recovery — scripts are
re-runnable by contract, like every slot protocol here).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import time

from .. import _native as N
from ..obs.recorder import FlightRecorder
from ..obs.devtime import DEVTIME
from ..obs.spans import SpanWriter, sweep_span_stages
from ..scripting.microlua import LuaCoroutine, LuaError, LuaTable
from ..scripting.sandbox import (KILL_BUDGET, KILL_DEADLINE,
                                 ScriptBudget, compile_chunk,
                                 make_sandboxed_runtime)
from ..store import Store
from ..utils import faults
from ..utils.faults import fault
from ..utils.trace import tracer
from . import protocol as P
from .qos import (AdmissionController, TenantLedger, WaitingRow,
                  parse_tenant_weights, prune_idle_counters)

log = logging.getLogger("libsplinter_tpu.pipeliner")

# orphaned __pr_<idx> result rows older than this are reaped by the
# heartbeat-cadence sweep (the searcher's __sr_ discipline)
RESULT_TTL_S = 120.0

# typed error vocabulary beyond the protocol's overload/deadline pair
ERR_SCRIPT = "script_error"

# async verbs must resolve through the lane's pump loop; everything
# else in the splinter table is a fast host call
ASYNC_VERBS = ("submit_embed", "submit_search", "submit_completion",
               "sleep")


@dataclasses.dataclass
class PipelinerStats:
    wakes: int = 0
    drains: int = 0
    requests: int = 0            # script requests gathered
    parse_errors: int = 0        # malformed request JSON / bad source
    scripts_started: int = 0
    scripts_completed: int = 0   # finished ok (result committed)
    scripts_failed: int = 0      # typed script_error results
    scripts_killed: int = 0      # budget/deadline kills
    killed_budget: int = 0
    killed_deadline: int = 0
    verbs_total: int = 0         # async verb dispatches, all scripts
    raced: int = 0               # slot changed mid-script; not committed
    results_reaped: int = 0      # orphaned __pr_ rows retired
    # -- multi-tenant QoS (engine/qos.py) ----------------------------
    deadline_expired: int = 0    # fast-failed at admission
    shed: int = 0                # typed overloaded + retry_after_ms
    deferred: int = 0            # held for a later drain (fairness)


class _Await:
    """One suspended verb: what the script is waiting for and where.
    The pump loop polls these; `wake_ts` serves the sleep verb."""

    __slots__ = ("kind", "key", "idx", "k", "wake_ts", "t0")

    def __init__(self, kind, key=None, idx=-1, k=0, wake_ts=0.0):
        self.kind = kind
        self.key = key
        self.idx = idx
        self.k = k
        self.wake_ts = wake_ts
        self.t0 = time.perf_counter()


class ScriptRun:
    """One admitted script's runtime state."""

    __slots__ = ("idx", "epoch", "key", "tenant", "deadline", "rt",
                 "co", "await_", "verbs", "verb_counts", "stages",
                 "span", "t_start", "label")

    def __init__(self, idx, epoch, key, tenant, deadline, rt, co,
                 span, label):
        self.idx = idx
        self.epoch = epoch
        self.key = key
        self.tenant = tenant
        self.deadline = deadline
        self.rt = rt
        self.co = co
        self.await_ = None
        self.verbs = 0
        self.verb_counts: dict[str, int] = {}
        self.stages = dict.fromkeys(P.SCRIPT_STAGES, 0.0)
        self.span = span             # obs.spans.PendingSpan | None
        self.t_start = time.perf_counter()
        self.label = label           # "inline" or the stored name

    @property
    def stamp(self):
        """(trace_id, client_wall_ts) | None — the recorder's view."""
        return self.span.stamp if self.span is not None else None


class _Request:
    __slots__ = ("idx", "epoch", "src", "args", "label", "tenant",
                 "deadline", "traced", "fresh")

    def __init__(self, idx, epoch, src, args, label, tenant, deadline,
                 traced):
        self.idx = idx
        self.epoch = epoch
        self.src = src
        self.args = args
        self.label = label
        self.tenant = tenant
        self.deadline = deadline
        self.traced = traced
        self.fresh = True        # first gather (False = deferred memo)


def _lua_to_json(v, depth: int = 0):
    """Script return values -> JSON-able (bounded; a LuaTable renders
    as a list when array-like, else a string-keyed dict)."""
    if depth > 4:
        return "..."
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, LuaTable):
        n = v.length()
        if n and len(v.data) == n:
            return [_lua_to_json(v.get(i + 1), depth + 1)
                    for i in range(min(n, 64))]
        return {str(k): _lua_to_json(val, depth + 1)
                for k, val in list(v.data.items())[:64]}
    return str(v)


class Pipeliner:
    """The daemon object.  Drive it with run() (blocking loop) or
    run_once() (pump to idle — tests and --oneshot).  Deliberately
    jax-free: the lane orchestrates the other three daemons' work, it
    never touches a device itself."""

    def __init__(self, store: Store, *, group: int = P.GROUP_SCRIPT,
                 max_scripts: int = 32,
                 max_steps: int | None = None,
                 max_coroutines: int | None = None,
                 max_sleep_s: float | None = None,
                 max_verbs: int | None = None,
                 queue_high_water: int | None = None,
                 retry_after_ms: int | None = None,
                 tenant_weights: dict[int, float] | None = None,
                 replica: int = 0):
        self.store = store
        self.group = group
        # elastic lanes (protocol.StripeView): replica r gathers only
        # its own slot-index stripe; in-flight scripts keep their
        # request label SET while executing, so closed stripes during
        # a scale-down drain are what keeps a survivor from re-running
        # a retiring replica's live chains
        self.replica = int(replica)
        self.stripes = P.StripeView(store, "pipeliner", self.replica)
        self._hb_key = P.replica_stats_key(P.KEY_SCRIPT_STATS,
                                           self.replica)
        self._trace_key = P.replica_stats_key(P.KEY_SCRIPT_TRACE,
                                              self.replica)
        # max_scripts is the lane's admit cap: the concurrency bound
        # (each in-flight script pins one sandbox + one host
        # coroutine thread) and the fairness granularity in one knob
        self.max_scripts = max(1, max_scripts)
        budget_kw = {}
        if max_steps is not None:
            budget_kw["max_steps"] = max_steps
        if max_coroutines is not None:
            budget_kw["max_coroutines"] = max_coroutines
        if max_sleep_s is not None:
            budget_kw["max_sleep_s"] = max_sleep_s
        if max_verbs is not None:
            budget_kw["max_verbs"] = max_verbs
        self._budget_kw = budget_kw
        self.qos = AdmissionController(
            weights=tenant_weights, high_water=queue_high_water,
            **({"retry_after_ms": retry_after_ms}
               if retry_after_ms is not None else {}))
        self.tenants = TenantLedger()
        self.stats = PipelinerStats()
        self.verb_counts: dict[str, int] = {}
        self.runs: dict[int, ScriptRun] = {}
        # deferred-backlog memo: a row gathered but not admitted keeps
        # its PARSED request here, so later drains neither re-parse
        # its JSON / re-fetch its stored source nor re-count it in
        # the requests/deferred stats (the busy loop re-plans
        # admission every time capacity frees)
        self._parsed: dict[tuple[int, int], _Request] = {}
        self.generation = 0
        self.recorder = FlightRecorder()
        # staged (crash recovery with attempt counts: scripts live
        # whole chains) + eager (the pump is host orchestration, not
        # a device wake path — spans land the moment a script ends)
        self.spans = SpanWriter(store, "pipeliner", staged=True,
                                eager=True)
        self._trace_published = 0
        self._bid = -1
        self._running = False

    # -- wiring ------------------------------------------------------------

    def attach(self) -> None:
        st = self.store
        try:
            self._bid = st.shard_claim(P.SHARD_SCRIPT, N.ADV_WILLNEED,
                                       P.PRIO_SCRIPT, 30_000_000)
        except OSError:
            self._bid = -1
        st.watch_label_register(P.BIT_SCRIPT_REQ, self.group)
        st.bus_attach()   # adopts the bus when a crashed owner
                          # left a dead pid in the header
        self.generation = P.bump_generation(st, self._hb_key)

    # -- request gathering -------------------------------------------------

    def _gather(self) -> list[_Request]:
        st = self.store
        self.stripes.refresh()        # a re-stripe lands HERE, at the
        rows = st.enumerate_indices(P.LBL_SCRIPT_REQ)  # gather boundary
        out: list[_Request] = []
        for idx in rows:
            idx = int(idx)
            if not self.stripes.owns(idx) and idx not in self.runs:
                continue              # a peer replica's stripe (rows
                                      # WE are executing stay ours)
            e = st.epoch_at(idx)
            live = self.runs.get(idx)
            if live is not None:
                if live.epoch == e:
                    continue                  # already executing
                # raced rewrite: the client rewrote the slot while its
                # old script ran — retire the stale run uncommitted,
                # the fresh request is gathered below
                self._retire(live, raced=True)
            labels = st.labels_at(idx)
            if not labels & P.LBL_SCRIPT_REQ:
                continue
            cached = self._parsed.get((idx, e))
            if cached is not None:
                cached.fresh = False
                out.append(cached)
                continue
            try:
                raw = st.get_at(idx)
            except (KeyError, OSError):
                continue
            if st.epoch_at(idx) != e or (e & 1):
                continue                      # torn: next drain
            self.stats.requests += 1
            src = None
            label = "inline"
            try:
                req = json.loads(raw.rstrip(b"\0"))
                if not isinstance(req, dict):
                    raise ValueError("request must be a JSON object")
                if req.get("script"):
                    src = str(req["script"])
                elif req.get("name"):
                    label = str(req["name"])
                    src = self._stored_source(label)
                    if src is None:
                        self._fail(idx, e,
                                   f"unknown stored script {label!r}")
                        continue
                else:
                    raise ValueError("request names no script")
                args = req.get("args") or []
                if not isinstance(args, list):
                    raise ValueError("args must be a list")
                deadline = req.get("deadline")
                deadline = float(deadline) if deadline else None
            except (ValueError, KeyError, TypeError) as ex:
                self._fail(idx, e, f"bad script request: {ex}")
                continue
            if deadline is None and labels & P.LBL_DEADLINE:
                deadline = P.read_deadline(st, idx, epoch=e)
            req = _Request(idx, e, src, args, label,
                           P.read_tenant(labels), deadline,
                           bool(labels & P.LBL_TRACED))
            self._parsed[(idx, e)] = req
            out.append(req)
        # prune memo entries whose row is no longer pending (label
        # cleared by a commit we missed, raced rewrite, key vanished)
        live = {(r.idx, r.epoch) for r in out}
        for k in list(self._parsed):
            if k not in live:
                del self._parsed[k]
        return out

    def _stored_source(self, name: str) -> str | None:
        try:
            raw = self.store.get(P.stored_script_key(name))
        except (KeyError, OSError):
            return None
        return raw.rstrip(b"\0").decode("utf-8", "replace")

    # -- admission (multi-tenant QoS) --------------------------------------

    def _admit(self, reqs: list[_Request]) -> None:
        """The shared admission policy over the gathered backlog:
        capacity is the lane's free concurrency (max_scripts minus
        in-flight), expired deadlines fail fast typed, overflow past
        the high-water mark sheds typed, the rest stay labelled for a
        later drain with stride credit."""
        if not reqs:
            return
        cap = self.max_scripts - len(self.runs)
        plan = self.qos.plan(
            [WaitingRow(r, r.tenant, r.deadline) for r in reqs], cap)
        for row in (*plan.admit, *plan.expired, *plan.shed):
            r = row.item
            if r.traced:
                r.traced = False
                # span begin reads the stamp NON-destructively (it
                # must survive a mid-chain crash so the restarted
                # lane's re-run keeps the chain identity) and stages
                # the pending span; the commit retires both
                span = self.spans.begin(r.idx, r.epoch,
                                        tenant=r.tenant)
            else:
                span = None
            row.span = span       # type: ignore[attr-defined]
        for row in plan.expired:
            r = row.item
            self._parsed.pop((r.idx, r.epoch), None)
            self.stats.deadline_expired += 1
            self.tenants.bump(r.tenant, "deadline_expired")
            P.clear_deadline(self.store, r.idx)
            self._commit(r.idx, r.epoch, {"err": P.ERR_DEADLINE})
            self.spans.commit(getattr(row, "span", None),
                              status=P.ERR_DEADLINE)
        for row in plan.shed:
            r = row.item
            self._parsed.pop((r.idx, r.epoch), None)
            self.stats.shed += 1
            self.tenants.bump(r.tenant, "shed")
            P.clear_deadline(self.store, r.idx)
            self._commit(r.idx, r.epoch,
                         P.overloaded_record(self.qos.retry_after_ms))
            self.spans.commit(getattr(row, "span", None),
                              status=P.ERR_OVERLOADED)
        # deferral counts FIRST sights only: the memo re-offers a
        # deferred row every re-plan, which must not inflate the stat
        self.stats.deferred += sum(
            1 for row in plan.deferred if row.item.fresh)
        for row in plan.admit:
            r = row.item
            self._parsed.pop((r.idx, r.epoch), None)
            if r.tenant or r.deadline is not None:
                self.tenants.bump(r.tenant, "admitted")
            if r.deadline is not None:
                P.clear_deadline(self.store, r.idx)
            self._start(r, getattr(row, "span", None))

    # -- script lifecycle --------------------------------------------------

    def _start(self, req: _Request, span) -> None:
        """Parse stage: build the sandbox, compile the chunk, wrap it
        in the host coroutine, then run its first slice."""
        t0 = time.perf_counter()
        key = self.store.key_at(req.idx)
        if key is None:
            return
        budget = ScriptBudget(deadline_ts=req.deadline,
                              **self._budget_kw)
        try:
            rt = make_sandboxed_runtime(self.store, budget)
            run = ScriptRun(req.idx, req.epoch, key, req.tenant,
                            req.deadline, rt, None, span, req.label)
            self._overlay_verbs(rt, run)
            fn = compile_chunk(rt, req.src, chunk_name=req.label)
            arg = LuaTable({0: req.label})
            for i, a in enumerate(req.args):
                arg.set(i + 1, a)
            rt.globals["arg"] = arg
            run.co = LuaCoroutine(fn, rt)
        except LuaError as ex:
            self._fail(req.idx, req.epoch, f"parse: {ex}")
            self.spans.commit(span, status=ERR_SCRIPT)
            return
        run.stages["parse"] = (time.perf_counter() - t0) * 1e3
        self.stats.scripts_started += 1
        self.runs[req.idx] = run
        self._resume(run, tuple(req.args))

    def _resume(self, run: ScriptRun, values: tuple) -> None:
        """One execution slice: resume the script's coroutine with the
        awaited result and interpret how it came back (suspended on a
        new await, returned, or died).  The fault site here is the
        exec path: a `raise` fails ONE script typed, a `crash` is the
        supervised-restart drill."""
        t0 = time.perf_counter()
        try:
            fault("pipeliner.exec")
            out = run.co.resume(values)
        except Exception as ex:             # injected raise / host bug
            run.stages["exec"] += (time.perf_counter() - t0) * 1e3
            self._finish(run, {"err": ERR_SCRIPT,
                               "detail": f"exec failed: {ex}"})
            return
        run.stages["exec"] += (time.perf_counter() - t0) * 1e3
        if out[0] and run.co.status == "suspended":
            payload = out[1] if len(out) > 1 else None
            if isinstance(payload, _Await):
                run.await_ = payload
                return
            # a stray top-level coroutine.yield is not an await — the
            # script has no resumer but us, so it can only die
            self._finish(run, {"err": ERR_SCRIPT,
                               "detail": "yield outside an async "
                                         "splinter verb"})
            return
        if out[0]:                           # returned cleanly
            ret = [_lua_to_json(v) for v in out[1:]]
            self._finish(run, {"ok": True, "ret": ret})
            return
        self._finish(run, self._error_record(run, out[1]))

    def _error_record(self, run: ScriptRun, payload) -> dict:
        """Classify a script death: the sandbox's typed kills first
        (kill_reason survives the coroutine boundary), then a script
        that error()'d a bare typed string propagates it (the library
        scripts re-raise a downstream verb's typed rejection), else a
        plain script_error."""
        reason = run.rt.kill_reason
        if reason == KILL_BUDGET:
            return {"err": KILL_BUDGET, "detail": str(payload)}
        if reason == KILL_DEADLINE:
            return {"err": P.ERR_DEADLINE, "detail": str(payload)}
        if payload == P.ERR_OVERLOADED:
            return P.overloaded_record(self.qos.retry_after_ms)
        if payload == P.ERR_DEADLINE:
            return {"err": P.ERR_DEADLINE}
        return {"err": ERR_SCRIPT, "detail": str(payload)}

    def _finish(self, run: ScriptRun, rec: dict) -> None:
        """Terminal: account, commit the typed/ok record, retire."""
        err = rec.get("err")
        if err is None:
            self.stats.scripts_completed += 1
        elif err == KILL_BUDGET:
            self.stats.scripts_killed += 1
            self.stats.killed_budget += 1
        elif err == P.ERR_DEADLINE:
            self.stats.scripts_killed += 1
            self.stats.killed_deadline += 1
            self.tenants.bump(run.tenant, "deadline_expired")
        else:
            self.stats.scripts_failed += 1
        t0 = time.perf_counter()
        self._commit(run.idx, run.epoch, rec)
        run.stages["commit"] = (time.perf_counter() - t0) * 1e3
        self.spans.commit(
            run.span, status=err or "ok",
            stages={s: run.stages[s] for s in P.SCRIPT_STAGES},
            extra={"script": run.label, "verbs": run.verbs})
        self._record_trace(run)
        self._retire(run)

    def _retire(self, run: ScriptRun, raced: bool = False) -> None:
        if raced:
            self.stats.raced += 1
        self.runs.pop(run.idx, None)
        try:
            if run.co is not None and run.co.status == "suspended":
                run.co.close()
            run.rt.close()
        except Exception:                    # reclaim must never wedge
            pass

    def _kill(self, run: ScriptRun, reason: str, detail: str) -> None:
        """Kill a SUSPENDED script from the pump loop (deadline passed
        while it waited): typed record out, coroutine unwound."""
        run.rt.kill_reason = run.rt.kill_reason or reason
        rec = ({"err": P.ERR_DEADLINE, "detail": detail}
               if reason == KILL_DEADLINE
               else {"err": KILL_BUDGET, "detail": detail})
        self._finish(run, rec)

    def _fail(self, idx: int, epoch: int, detail: str) -> None:
        self.stats.parse_errors += 1
        self._commit(idx, epoch, {"err": ERR_SCRIPT, "detail": detail})

    # -- the sandboxed verb surface ----------------------------------------

    def _overlay_verbs(self, rt, run: ScriptRun) -> None:
        """Swap the lane's async verbs into the runtime's splinter
        table.  Each verb issues the non-blocking submit with the
        REQUEST's tenant + deadline stamped through, then suspends the
        script's coroutine on an _Await the pump loop resolves."""
        st = self.store
        spl = rt.modules["splinter"]

        def guard(name: str) -> None:
            fault("pipeliner.verb")
            run.verbs += 1
            run.verb_counts[name] = run.verb_counts.get(name, 0) + 1
            self.stats.verbs_total += 1
            self.verb_counts[name] = self.verb_counts.get(name, 0) + 1
            if run.verbs > rt.budget.max_verbs:
                rt.kill(KILL_BUDGET,
                        f"script exceeded its "
                        f"{rt.budget.max_verbs}-verb budget")
            if rt.budget.expired():
                # killed BEFORE dispatching the verb: an expired
                # script must not submit work nobody waits for
                rt.kill(KILL_DEADLINE,
                        f"deadline passed before verb {name!r}")
            if not rt._co_stack or rt._co_stack[-1] is not run.co:
                raise LuaError(f"{name}: async splinter verbs must "
                               f"be called from the script's main "
                               f"body, not a nested coroutine")

        def suspend(aw: _Await):
            got = run.co.yield_((aw,))
            return got if len(got) != 1 else got[0]

        def _stamp(key: str) -> None:
            if run.tenant:
                P.stamp_tenant(st, key, run.tenant)
            if run.deadline is not None:
                P.stamp_deadline(st, key, run.deadline)
            _stamp_trace(key)

        def _stamp_trace(key: str) -> None:
            # trace-context propagation: every verb the script
            # dispatches joins the REQUEST's trace, parented on the
            # script's own span — one trace id spans the whole chain
            if run.span is not None:
                P.stamp_trace(st, key, trace_id=run.span.tid,
                              parent=run.span.span)

        def submit_embed(key, text):
            guard("submit_embed")
            key = str(key)
            st.set(key, str(text))
            # a reused key may still carry CTX_EXCEEDED from a
            # previous over-long text (the client helper's discipline)
            st.label_clear(key, P.LBL_CTX_EXCEEDED)
            _stamp(key)
            st.label_or(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
            st.bump(key)
            return suspend(_Await("embed", key))

        def submit_search(key, k, bloom=0):
            guard("submit_search")
            key = str(key)
            params = {"k": int(k), "bloom": int(bloom or 0)}
            if run.deadline is not None:
                params["deadline"] = round(run.deadline, 6)
            st.set(key, json.dumps(params))
            idx = st.find_index(key)
            if run.tenant:
                P.stamp_tenant(st, key, run.tenant)
            _stamp_trace(key)
            st.label_or(key, P.LBL_SEARCH_REQ | P.LBL_WAITING)
            st.bump(key)
            return suspend(_Await("search", key, idx=idx, k=int(k)))

        def submit_completion(key, prompt):
            guard("submit_completion")
            key = str(key)
            st.set(key, str(prompt))
            st.label_clear(key, P.LBL_READY | P.LBL_SERVICING)
            _stamp(key)
            st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
            st.bump(key)
            return suspend(_Await("complete", key))

        def sleep(seconds):
            guard("sleep")
            wake = time.time() + rt.budget.clamp_sleep(float(seconds))
            suspend(_Await("sleep", wake_ts=wake))
            return 0

        for name, fn in (("submit_embed", submit_embed),
                         ("submit_search", submit_search),
                         ("submit_completion", submit_completion),
                         ("sleep", sleep)):
            spl.set(name, fn)

    # -- await resolution --------------------------------------------------

    def _poll_await(self, aw: _Await):
        """(ready, result) for one suspended verb.  `result` is what
        the verb returns to the script: True / LuaTable / str on
        success, (None, "<typed err>") on a downstream rejection."""
        st = self.store
        if aw.kind == "sleep":
            return (time.time() >= aw.wake_ts, 0)
        try:
            labels = st.labels(aw.key)
        except KeyError:
            return True, (None, "key vanished mid-request")
        if aw.kind == "embed":
            from .client import PENDING, classify_embed_result
            res = classify_embed_result(st, aw.key, labels)
            if res is PENDING:
                return False, None
            if res is True:
                return True, True
            return True, (None, str(res.get("err")))
        if aw.kind == "search":
            if labels & P.LBL_SEARCH_REQ:
                return False, None
            rec = None
            try:
                raw = st.get(P.search_result_key(aw.idx))
                rec = json.loads(raw.rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                pass
            try:
                st.unset(P.search_result_key(aw.idx))
            except (KeyError, OSError):
                pass
            if not isinstance(rec, dict):
                return True, (None, "search result lost")
            if rec.get("err"):
                return True, (None, str(rec["err"]))
            return True, LuaTable.from_list(
                [str(k) for k in rec.get("keys", [])])
        # complete
        if not labels & P.LBL_READY:
            return False, None
        try:
            raw = st.get(aw.key)
        except (KeyError, OSError):
            return True, (None, "completion lost")
        rec = P.parse_error_payload(raw)
        if rec is not None:
            return True, (None, str(rec.get("err")))
        return True, raw.rstrip(b"\0").decode("utf-8", "replace")

    # -- result commit -----------------------------------------------------

    def _commit(self, idx: int, epoch: int, rec: dict) -> int:
        """Epoch-gated result commit (the searcher's __sr_ discipline):
        write __pr_<idx>, clear the request labels, bump — only if the
        slot is unchanged since the gather."""
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
        rkey = P.script_result_key(idx)
        try:
            st.set(rkey, json.dumps(rec))
        except OSError:
            rec.pop("ret", None)
            rec["err"] = rec.get("err", "result too large for store")
            rec["truncated"] = True
            try:
                st.set(rkey, json.dumps(rec))
            except (KeyError, OSError):
                return 0
        except KeyError:
            return 0
        if st.epoch_at(idx) != epoch:
            self.stats.raced += 1
            return 0
        try:
            st.label_or(rkey, P.LBL_READY)
            st.label_clear(key, P.LBL_SCRIPT_REQ | P.LBL_WAITING)
            st.bump(key)
        except (KeyError, OSError):
            return 0
        return 1

    # -- the pump ----------------------------------------------------------

    def pump(self, gather: bool = True) -> int:
        """One scheduler pass: admit new requests (skippable — the
        run loop only gathers when the wake signal moved, so the
        sub-ms await-polling cadence never pays the backlog scan),
        kill expired scripts, resume every script whose await
        resolved.  Returns the number of resumes (0 = nothing to do;
        callers idle)."""
        self.stats.drains += 1
        if gather:
            self._admit(self._gather())
        moved = 0
        for run in list(self.runs.values()):
            if self.runs.get(run.idx) is not run:
                continue                      # retired by a sibling
            if run.rt.budget.expired():
                self._kill(run, KILL_DEADLINE,
                           "deadline passed while the script was "
                           "suspended")
                moved += 1
                continue
            aw = run.await_
            if aw is None:
                continue
            ready, result = self._poll_await(aw)
            if not ready:
                continue
            run.stages["verb"] += (time.perf_counter() - aw.t0) * 1e3
            run.await_ = None
            moved += 1
            self._resume(run, result if isinstance(result, tuple)
                         else (result,))
        return moved

    def run_once(self, *, timeout_s: float = 30.0) -> int:
        """Pump until the lane is idle (no in-flight scripts and no
        labelled backlog) or `timeout_s` passes — tests and --oneshot.
        Returns completed+failed+killed script count for the call."""
        t0 = time.monotonic()
        done0 = (self.stats.scripts_completed + self.stats.scripts_failed
                 + self.stats.scripts_killed + self.stats.parse_errors)
        while time.monotonic() - t0 < timeout_s:
            moved = self.pump()
            if not self.runs and not moved and \
                    not self.store.enumerate_indices(P.LBL_SCRIPT_REQ):
                break
            if not moved:
                time.sleep(0.001)
        return (self.stats.scripts_completed + self.stats.scripts_failed
                + self.stats.scripts_killed + self.stats.parse_errors
                - done0)

    # -- housekeeping ------------------------------------------------------

    def sweep_results(self, *, ttl_s: float = RESULT_TTL_S,
                      now: float | None = None) -> int:
        """Retire orphaned __pr_<idx> rows (client timed out and never
        consumed, or a previous generation's leftovers) — the
        searcher's sweep discipline on the heartbeat cadence."""
        st = self.store
        now = time.time() if now is None else now
        pfx = P.SCRIPT_RESULT_PREFIX
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
                continue
            if not isinstance(rec, dict):
                rec = {}
            e, ts = rec.get("e"), rec.get("ts")
            if idx >= st.nslots or st.key_at(idx) is None:
                retire = True
            elif isinstance(e, int) and st.epoch_at(idx) != e:
                retire = True
            elif isinstance(ts, (int, float)):
                retire = (now - float(ts)) > ttl_s
            else:
                retire = True
            if retire:
                try:
                    st.unset(key)
                    reaped += 1
                except (KeyError, OSError):
                    pass
        self.stats.results_reaped += reaped
        # the pending-span staging rows share the same reaper cadence
        # (orphans: raced rewrites, crashed chains nobody re-drained)
        sweep_span_stages(st, ttl_s=ttl_s, now=now)
        return reaped

    def _record_trace(self, run: ScriptRun) -> None:
        if not tracer.enabled:
            return
        for stage in P.SCRIPT_STAGES:
            tracer.record(f"script.{stage}", run.stages[stage])
        wall = (time.perf_counter() - run.t_start) * 1e3
        tracer.record("script.e2e", wall)
        if run.stamp is not None:
            tid, ts = run.stamp
            client_wall = ((time.time() - ts) * 1e3 if ts > 0
                           else wall)
            slot = self.recorder.record(
                tid, run.key, client_wall,
                [[s, round(run.stages[s], 3)]
                 for s in P.SCRIPT_STAGES])
            # chain identity on the ring entry: the script name, its
            # span id, and the per-verb dispatch counts — `spt trace
            # tail` on the script lane correlates with `spt trace
            # show <id>`'s span tree.  ALWAYS assigned: ring slots
            # are REUSED dicts, and a stale key left by the previous
            # occupant would attach phantom verbs to the wrong script
            slot["script"] = run.label
            slot["span"] = (run.span.span if run.span is not None
                            else None)
            slot["verbs"] = (dict(run.verb_counts)
                             if run.verb_counts else None)

    def publish_stats(self) -> None:
        payload = {**dataclasses.asdict(self.stats),
                   "spans_obs": self.spans.counters(),
                   "scripts_active": len(self.runs),
                   "max_scripts": self.max_scripts,
                   "generation": self.generation}
        if self.replica or self.stripes.epoch:
            payload["replica"] = self.replica
            payload["stripe"] = self.stripes.snapshot()
        if self.verb_counts:
            # per-verb dispatch counters: `spt metrics` renders one
            # sptpu_pipeliner_verb_<name> series per verb
            payload["verbs"] = dict(self.verb_counts)
        if self.qos.high_water is not None:
            payload["qos"] = {
                "admit_cap": self.max_scripts,
                "queue_high_water": self.qos.high_water,
                "retry_after_ms": self.qos.retry_after_ms}
        tenants = self.tenants.snapshot()
        if tenants:
            payload["tenants"] = tenants
        prune_idle_counters(
            payload, bool(self.qos.high_water is not None or tenants))
        if faults.armed():
            payload["faults"] = faults.stats()
        # the pipeliner dispatches no jitted programs of its own, but
        # in-process co-located lanes may have buffered ledger events
        # — flush on the same heartbeat cadence as every other lane
        DEVTIME.flush(self.store)
        if tracer.enabled:
            P.attach_trace_sections(payload, tracer, self.recorder,
                                    "script.")
        P.publish_heartbeat(self.store, self._hb_key, payload)
        if tracer.enabled:
            self._trace_published = P.maybe_publish_trace_ring(
                self.store, self._trace_key, self.recorder,
                self._trace_published)

    # -- daemon loop -------------------------------------------------------

    def run(self, *, idle_timeout_ms: int = 50,
            stop_after: float | None = None,
            heartbeat_interval_s: float = 5.0) -> None:
        """The daemon loop: block on the signal group while idle, poll
        tightly while scripts are in flight (their awaits resolve via
        OTHER lanes' bumps on OTHER keys — the short poll is what
        keeps chain hops at milliseconds instead of wake latencies)."""
        self._running = True
        st = self.store
        last = st.signal_count(self.group)
        deadline = (time.monotonic() + stop_after) if stop_after \
            else None
        next_beat = 0.0
        next_retire_check = 0.0
        re_gather = False
        while self._running:
            try:
                if self.runs:
                    # in-flight scripts: sub-ms await polling (each
                    # chain hop costs the downstream lane's service
                    # time plus THIS cadence — a 5 ms quantum here
                    # would hand back most of the round trips the
                    # lane exists to remove); the backlog scan runs
                    # only when the wake signal moved
                    cnt = st.signal_count(self.group)
                    gather = cnt != last or re_gather
                    if cnt != last:
                        last = cnt
                        self.stats.wakes += 1
                    moved = self.pump(gather=gather)
                    # a finished script freed capacity: the next pass
                    # re-plans admission over any deferred backlog
                    re_gather = bool(moved)
                    if not moved:
                        time.sleep(0.0002)
                else:
                    got = st.signal_wait(self.group, last,
                                         timeout_ms=idle_timeout_ms)
                    if got is not None:
                        last = got
                        self.stats.wakes += 1
                    self.pump()
                now = time.monotonic()
                if now >= next_beat:
                    self.sweep_results()
                    self.publish_stats()
                    next_beat = now + heartbeat_interval_s
                if self.replica and not self.runs \
                        and now >= next_retire_check:
                    # scale-down drain: stripes closed, every live
                    # chain committed — exit and let the supervisor
                    # reap us
                    next_retire_check = now + 1.0
                    if self.stripes.poll_retired():
                        log.info("replica %d destriped — retiring",
                                 self.replica)
                        self.publish_stats()
                        break
            except Exception:
                log.exception("run loop cycle failed; continuing")
                now = time.monotonic()
            if deadline and now > deadline:
                break
        # leave no parked coroutine threads behind
        for run in list(self.runs.values()):
            self._retire(run)

    def stop(self) -> None:
        self._running = False


# -- client side -----------------------------------------------------------

def daemon_live(store: Store, *, max_age_s: float = 15.0) -> bool:
    """True when a pipeline lane is live enough to route scripts to
    (heartbeat fresh + pid alive + breaker not open)."""
    return P.heartbeat_live(store, P.KEY_SCRIPT_STATS,
                            max_age_s=max_age_s, lane="pipeliner")


def store_script(store: Store, name: str, source: str) -> None:
    """Publish a named script (`spt pipeline put`): the server-side
    program a request can invoke by name."""
    store.set(P.stored_script_key(name), source)


def submit_script(store: Store, key: str, *, script: str | None = None,
                  name: str | None = None, args: list | None = None,
                  timeout_ms: float = 10_000,
                  tenant: int = 0,
                  deadline_ms: float | None = None,
                  trace=None,
                  retry: bool = True):
    """Client side: submit a script request on `key` and wait for its
    result record.  Returns the parsed __pr_ record ({"ok": true,
    "ret": [...]} or a typed error dict), or None on timeout / down
    lane.  Exactly one of `script` (inline source) / `name` (stored)
    is required."""
    from .client import (PENDING, call_with_retries, _stamp_qos,
                         wait_with_repulse)

    if bool(script) == bool(name):
        raise ValueError("need exactly one of script= / name=")
    deadline_ts = (time.time() + deadline_ms / 1e3
                   if deadline_ms is not None else None)

    def attempt(left_ms: float):
        req: dict = {"args": list(args or [])}
        if script:
            req["script"] = script
        else:
            req["name"] = name
        if deadline_ts is not None:
            req["deadline"] = round(deadline_ts, 6)
        store.set(key, json.dumps(req))
        idx = store.find_index(key)
        _stamp_qos(store, key, tenant, None,   # deadline rides JSON
                   trace)
        store.label_or(key, P.LBL_SCRIPT_REQ | P.LBL_WAITING)
        store.bump(key)

        def check():
            try:
                labels = store.labels(key)
            except KeyError:
                return None
            if labels & P.LBL_SCRIPT_REQ:
                return PENDING
            try:
                raw = store.get(P.script_result_key(idx))
                return json.loads(raw.rstrip(b"\0"))
            except (KeyError, OSError, ValueError):
                return None

        return wait_with_repulse(store, key, left_ms, check)

    if not retry:
        return attempt(timeout_ms)
    return call_with_retries(attempt, timeout_ms=timeout_ms,
                             store=store, lane="pipeliner")


def consume_script_result(store: Store, key: str) -> None:
    """Retire a serviced script request's result row."""
    try:
        store.unset(P.script_result_key(store.find_index(key)))
    except (KeyError, OSError):
        pass


def main(argv: list[str] | None = None) -> int:
    """CLI entry: python -m libsplinter_tpu.engine.pipeliner
    --store NAME.  Deliberately jax-free — the lane starts in
    milliseconds, so supervised restarts are cheap."""
    import argparse

    ap = argparse.ArgumentParser(
        description="splinter-tpu pipeline lane (server-side scripted "
                    "RAG chains in a sandboxed Lua host)")
    ap.add_argument("--store", required=True)
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--oneshot", action="store_true")
    ap.add_argument("--max-scripts", type=int, default=32,
                    help="in-flight script cap (concurrency bound AND "
                         "admission capacity per drain)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="per-script interpreter step budget "
                         "(default 1000000; past it the script dies "
                         "with a typed budget_exceeded record)")
    ap.add_argument("--max-verbs", type=int, default=None,
                    help="per-script async-verb budget (default 256)")
    ap.add_argument("--max-sleep-s", type=float, default=None,
                    help="per-call splinter.sleep clamp (default 30)")
    ap.add_argument("--max-coroutines", type=int, default=None,
                    help="per-script coroutine cap (default 16)")
    ap.add_argument("--queue-high-water", type=int, default=None,
                    help="max deferred backlog — overflow is shed "
                         "with a typed `overloaded` result")
    ap.add_argument("--retry-after-ms", type=int, default=None)
    ap.add_argument("--tenant-weights", default=None,
                    help="per-tenant fair-share weights, "
                         "TENANT:W[,TENANT:W...]")
    ap.add_argument("--idle-timeout-ms", type=int, default=50)
    ap.add_argument("--replica", type=int, default=0,
                    help="striped replica index (elastic lanes): "
                         "gather only the stripes the lane's stripe "
                         "map assigns this replica; heartbeat "
                         "publishes replica-suffixed "
                         "(__pipeliner_stats.rN)")
    ap.add_argument("--seed-library", action="store_true",
                    help="store the built-in scenario scripts "
                         "(rag-churn / agent-loop / multi-hop / "
                         "map-reduce) before serving")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    store = Store.open(args.store, persistent=args.persistent)
    pl = Pipeliner(store, max_scripts=args.max_scripts,
                   max_steps=args.max_steps,
                   max_verbs=args.max_verbs,
                   max_sleep_s=args.max_sleep_s,
                   max_coroutines=args.max_coroutines,
                   queue_high_water=args.queue_high_water,
                   retry_after_ms=args.retry_after_ms,
                   tenant_weights=parse_tenant_weights(
                       args.tenant_weights),
                   replica=args.replica)
    pl.attach()
    if args.seed_library:
        from ..scripting.library import seed_library
        seed_library(store)
    pl.publish_stats()
    if args.oneshot:
        n = pl.run_once()
        log.info("oneshot ran %d scripts", n)
        return 0
    try:
        pl.run(idle_timeout_ms=args.idle_timeout_ms)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
