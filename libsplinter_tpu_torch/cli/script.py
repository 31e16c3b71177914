"""CLI scripting hosts: the `lua` and `wasm` commands.

Reference parity: splinter_cli_cmd_lua.c (embedded Lua 5.4 with splinter.*
host functions) and splinter_cli_cmd_wasm.c (WasmEdge VM with splinter.get/
set host imports).  Neither runtime ships in this image, so both hosts run
on in-tree interpreters (libsplinter_tpu.scripting).
"""
from __future__ import annotations

import sys
from pathlib import Path

from .main import CliError, command


@command("lua", "lua [--max-steps N] [--deadline-ms MS] "
         "[--max-sleep-s S] [--max-coroutines N] "
         "SCRIPT.lua [ARGS...] | lua ... -e 'CHUNK'",
         "run a Lua script against the store (splinter.* host API) "
         "in the sandboxed runtime the pipeline lane uses")
def cmd_lua(ses, args):
    import time

    from ..scripting.microlua import LuaError
    from ..scripting.sandbox import (LuaRuntime, ScriptBudget,
                                     ScriptKilled,
                                     make_sandboxed_runtime)

    # same budget knobs as the pipeline lane (one sandbox constructor
    # — semantics cannot drift), with CLI-generous defaults: the step
    # ceiling is the interpreter's historical default, not the lane's
    # 1M-per-request budget
    budget_kw: dict = {"max_steps": LuaRuntime.MAX_STEPS_DEFAULT,
                       "max_coroutines":
                           LuaRuntime.MAX_COROUTINES_DEFAULT}
    args = list(args)
    flags = {"--max-steps": ("max_steps", int),
             "--max-sleep-s": ("max_sleep_s", float),
             "--max-coroutines": ("max_coroutines", int)}
    while args and args[0] in (*flags, "--deadline-ms"):
        flag = args.pop(0)
        if not args:
            raise CliError(f"{flag} requires a value")
        val = args.pop(0)
        try:
            if flag == "--deadline-ms":
                budget_kw["deadline_ts"] = \
                    time.time() + float(val) / 1e3
            else:
                name, conv = flags[flag]
                budget_kw[name] = conv(val)
        except ValueError:
            raise CliError(f"{flag}: bad value {val!r}") from None
    if not args:
        raise CliError("usage: lua [budget flags] SCRIPT.lua "
                       "[ARGS...] | lua [budget flags] -e 'CHUNK'")
    if args[0] == "-e":
        if len(args) < 2:
            raise CliError("lua -e needs a chunk")
        src, chunk_name, script_args = args[1], "=(command line)", args[2:]
    else:
        path = Path(args[0])
        if not path.exists():
            raise CliError(f"no such script: {path}")
        src, chunk_name, script_args = (path.read_text(), str(path),
                                        list(args[1:]))
    # context manager: unwinds any coroutine the script left suspended
    # so a REPL running many scripts can't accumulate parked threads
    with make_sandboxed_runtime(ses.store,
                                ScriptBudget(**budget_kw)) as rt:
        try:
            rt.run(src, script_args=script_args, chunk_name=chunk_name)
        except ScriptKilled as e:
            raise CliError(f"lua: script killed ({e.reason}): {e}") \
                from None
        except LuaError as e:
            raise CliError(f"lua: {e}") from None


@command("wasm", "wasm MODULE.wasm [FUNC] [ARGS...]",
         "run a WebAssembly module against the store (splinter host imports)")
def cmd_wasm(ses, args):
    from ..scripting.microwasm import WasmError, instantiate
    from ..scripting.wasm_host import make_host_imports

    if not args:
        raise CliError("usage: wasm MODULE.wasm [FUNC] [ARGS...]")
    path = Path(args[0])
    if not path.exists():
        raise CliError(f"no such module: {path}")
    func = args[1] if len(args) > 1 else None
    call_args = [int(a, 0) for a in args[2:]]
    try:
        inst = instantiate(path.read_bytes(),
                           make_host_imports(ses.store,
                                             out=sys.stdout.write))
        if func is None:
            for cand in ("_start", "main", "run"):
                if cand in inst.exports:
                    func = cand
                    break
        if func is None or func not in inst.exports:
            raise CliError(
                f"no runnable export (have: {', '.join(inst.exports)})")
        res = inst.invoke(func, call_args)
        if res:
            print(" ".join(str(v) for v in res))
    except WasmError as e:
        raise CliError(f"wasm: {e}") from None
