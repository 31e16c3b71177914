"""Sandboxed Lua execution — the budget-enforced runtime the pipeline
lane and the CLI `spt lua` host share.

The reference runs user programs *next to the data* (its "cooperative
userspace hypervisor" framing); doing that server-side means a hostile
or buggy script must be containable by the HOST, not by convention:

  - **step budget**: every interpreter tick counts against
    `max_steps`; past it the script dies with a typed
    `budget_exceeded` kill.  The kill exception is NOT a LuaError, so
    `pcall` cannot swallow it — an infinite `while true do
    pcall(...) end` dies exactly as fast as a bare loop.
  - **deadline-derived wall clock**: with a deadline set, the tick
    check (every 1024 steps — one modulo, nothing on the common path)
    and every host verb kill the script the moment the request's
    deadline passes (`deadline_expired`).
  - **allocation guard**: `string.rep` / `string.char` results are
    capped at `max_str_len` — the one stdlib amplifier that can turn
    O(1) steps into O(GB) host memory.
  - **coroutine cap**: `max_coroutines` bounds the OS threads a
    script's own `coroutine.create` fan-out can pin (the lane runs
    each script inside one host coroutine already, so depth here is
    the script's own nesting).
  - **no `os`**: the sandboxed runtime drops the `os` table (`io`
    never existed in microlua); wall-clock access rides the budget,
    not the script.

One constructor (`make_sandboxed_runtime`) builds the runtime for
BOTH the pipeline lane and `spt lua`, so the two hosts' sandbox
semantics cannot drift: the CLI passes generous defaults, the lane
passes per-request budgets derived from the request's deadline.
"""
from __future__ import annotations

import dataclasses
import time

from .microlua import LuaError, LuaRuntime, LuaTable

# lane defaults: a tree-walking interpreter runs ~1M steps/s, so the
# default step budget kills a pure-compute runaway in about a second
LANE_MAX_STEPS = 1_000_000
LANE_MAX_COROUTINES = 16
LANE_MAX_SLEEP_S = 30.0
LANE_MAX_STR_LEN = 1 << 20
LANE_MAX_VERBS = 256

# kill reasons — the typed-record vocabulary the pipeline lane commits
KILL_BUDGET = "budget_exceeded"
KILL_DEADLINE = "deadline_expired"


class ScriptKilled(Exception):
    """A budget/deadline kill unwinding a sandboxed script.

    Deliberately NOT a LuaError: `pcall` catches LuaError (and the
    coroutine machinery converts it to a resume error), so a hostile
    script could otherwise catch its own kill and keep running.  This
    unwinds through every Lua frame and surfaces at the coroutine /
    run boundary; `SandboxedRuntime.kill_reason` carries the typed
    reason for the host to report."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason


@dataclasses.dataclass
class ScriptBudget:
    """One script's resource envelope.  `deadline_ts` is an ABSOLUTE
    wall-clock deadline (seconds since the epoch, None = none) — the
    lane derives it from the request's QoS deadline stamp so the
    sandbox's clock and admission's clock are the same clock."""

    max_steps: int = LANE_MAX_STEPS
    max_coroutines: int = LANE_MAX_COROUTINES
    max_sleep_s: float = LANE_MAX_SLEEP_S
    max_str_len: int = LANE_MAX_STR_LEN
    max_verbs: int = LANE_MAX_VERBS
    deadline_ts: float | None = None

    def remaining_s(self, now: float | None = None) -> float | None:
        """Seconds until the deadline (None = unbounded)."""
        if self.deadline_ts is None:
            return None
        return self.deadline_ts - (time.time() if now is None else now)

    def expired(self, now: float | None = None) -> bool:
        rem = self.remaining_s(now)
        return rem is not None and rem <= 0

    def clamp_sleep(self, seconds: float) -> float:
        """The `splinter.sleep` clamp: never past max_sleep_s, never
        past the remaining deadline (a sleep that would outlive the
        request is pointless — wake at the deadline and die typed)."""
        s = max(0.0, float(seconds))
        s = min(s, self.max_sleep_s)
        rem = self.remaining_s()
        if rem is not None:
            s = min(s, max(0.0, rem))
        return s


class SandboxedRuntime(LuaRuntime):
    """LuaRuntime with the ScriptBudget enforced in the interpreter
    itself (tick-level), not by convention in the host functions."""

    # deadline probe cadence: power of two so the tick check is one
    # AND; at ~1M steps/s this is a wall-clock read every ~1 ms
    _DEADLINE_TICK_MASK = 1024 - 1

    def __init__(self, budget: ScriptBudget, output=None):
        self.budget = budget
        self.kill_reason: str | None = None
        super().__init__(output=output, max_steps=budget.max_steps,
                         max_coroutines=budget.max_coroutines)
        del self.globals["os"]          # no wall clock, no process info
        self._guard_string_alloc()

    def kill(self, reason: str, detail: str):
        """Arm the typed kill and raise it (host verbs and the lane's
        pump loop call this; _tick calls it from inside the
        interpreter).  The first reason wins — a deadline kill racing
        a budget kill stays a deadline kill."""
        if self.kill_reason is None:
            self.kill_reason = reason
        raise ScriptKilled(self.kill_reason, detail)

    def _tick(self, line: int) -> None:
        self.steps += 1
        if self.steps > self.max_steps:
            self.kill(KILL_BUDGET,
                      f"line {line}: script exceeded its "
                      f"{self.max_steps}-step budget")
        if (self.steps & self._DEADLINE_TICK_MASK) == 0 \
                and self.budget.expired():
            self.kill(KILL_DEADLINE,
                      f"line {line}: request deadline passed "
                      f"mid-script")

    def _guard_string_alloc(self) -> None:
        """Cap the stdlib's allocation amplifiers: `string.rep` (and
        `char`'s argv is naturally bounded, but cap its output too for
        symmetry) can conjure max_str_len-dwarfing strings in ONE
        step, which the step budget cannot see."""
        cap = self.budget.max_str_len
        strlib = self.globals["string"]
        orig_rep = strlib.get("rep")

        def _rep(s, n, sep=None):
            n = int(n)
            unit = len(s) + (len(str(sep)) if sep is not None else 0)
            if n > 0 and unit * n > cap:
                raise LuaError(
                    f"string.rep result would exceed the sandbox's "
                    f"{cap}-byte string budget")
            return orig_rep(s, n, sep)

        strlib.set("rep", _rep)


def make_sandboxed_runtime(store, budget: ScriptBudget | None = None,
                           output=None) -> SandboxedRuntime:
    """THE sandbox constructor both hosts share: a SandboxedRuntime
    with the `splinter` module registered (its `sleep` clamped by the
    same budget).  The pipeline lane overlays its async verbs on the
    returned runtime's splinter table; `spt lua` runs it as-is."""
    from .lua_host import make_splinter_module

    budget = budget or ScriptBudget()
    rt = SandboxedRuntime(budget, output=output)
    rt.register_module("splinter",
                       make_splinter_module(store, budget=budget))
    return rt


def compile_chunk(rt: LuaRuntime, src: str,
                  chunk_name: str = "script"):
    """Parse a chunk into a callable LuaFunction (varargs = the
    script's `...`) without executing it — the pipeline lane wraps it
    in a coroutine so host verbs can suspend the script.  Parse errors
    raise LuaError with the chunk name attached."""
    from .microlua import LuaFunction, _Env, _lex, _Parser

    try:
        ast = _Parser(_lex(src)).parse_chunk()
    except LuaError as e:
        raise LuaError(f"{chunk_name}: {e}") from None
    return LuaFunction([], True, ast, _Env(rt.globals, None),
                       name=chunk_name)
