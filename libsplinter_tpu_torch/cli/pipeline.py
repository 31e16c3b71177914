"""`spt pipeline` — the pipeline lane's client surface.

Submit a script (inline, from a file, or a stored name) to the
pipeline daemon, and manage the store's named-script library
(`__script_<name>` keys — the reference's "programs next to the
data").  The daemon side is `python -m libsplinter_tpu.engine.
pipeliner` (or lane `pipeliner` under `spt supervise`); sandbox
semantics are documented in docs/operations.md §Pipeline lane.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from ..engine import protocol as P
from .main import CliError, command

_NAME_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def _script_names(store) -> list[str]:
    pfx = P.SCRIPT_STORE_PREFIX
    return sorted(k[len(pfx):] for k in store.list()
                  if k.startswith(pfx))


@command("pipeline",
         "pipeline run (FILE | -e CHUNK | @NAME) [--tenant N] "
         "[--deadline-ms MS] [--timeout-ms MS] [--key KEY] [--json] "
         "[ARGS...] [-- LITERAL_ARGS...] | pipeline put NAME FILE | "
         "pipeline ls | pipeline cat NAME | pipeline rm NAME | "
         "pipeline seed",
         "run scripts server-side in the pipeline lane's sandboxed "
         "Lua host; manage the stored-script library")
def cmd_pipeline(ses, args):
    from ..engine.pipeliner import (consume_script_result, daemon_live,
                                    store_script, submit_script)

    if not args:
        raise CliError("usage: pipeline run|put|ls|cat|rm|seed ... "
                       "(see `help pipeline`)")
    sub, rest = args[0], list(args[1:])
    st = ses.store

    if sub == "put":
        if len(rest) != 2:
            raise CliError("usage: pipeline put NAME FILE")
        name, path = rest
        if not _NAME_RE.match(name):
            raise CliError(f"bad script name {name!r} "
                           "(want [A-Za-z0-9_.-]{1,64})")
        p = Path(path)
        if not p.exists():
            raise CliError(f"no such script: {p}")
        store_script(st, name, p.read_text())
        print(f"stored {name} ({p.stat().st_size}B)")
        return
    if sub == "ls":
        for name in _script_names(st):
            print(name)
        return
    if sub == "cat":
        if len(rest) != 1:
            raise CliError("usage: pipeline cat NAME")
        try:
            print(st.get_str(P.stored_script_key(rest[0])))
        except KeyError:
            raise CliError(f"no stored script {rest[0]!r}") from None
        return
    if sub == "rm":
        if len(rest) != 1:
            raise CliError("usage: pipeline rm NAME")
        try:
            st.unset(P.stored_script_key(rest[0]))
        except KeyError:
            raise CliError(f"no stored script {rest[0]!r}") from None
        return
    if sub == "seed":
        from ..scripting.library import seed_library
        print("seeded: " + ", ".join(seed_library(st)))
        return
    if sub != "run":
        raise CliError(f"unknown pipeline subcommand {sub!r} "
                       "(run|put|ls|cat|rm|seed)")

    tenant = 0
    deadline_ms = None
    timeout_ms = 10_000.0
    key = None
    as_json = False
    script = None
    name = None
    script_args: list = []
    i = 0
    while i < len(rest):
        a = rest[i]

        def val():
            nonlocal i
            i += 1
            if i >= len(rest):
                raise CliError(f"{a} requires a value")
            return rest[i]

        def arg_value(raw: str):
            # numbers pass as numbers so Lua arithmetic works
            try:
                return int(raw)
            except ValueError:
                try:
                    return float(raw)
                except ValueError:
                    return raw

        if a == "--":
            # terminator: the rest is script args verbatim (lets a
            # script receive literal "--tenant" / "-e" strings)
            script_args.extend(arg_value(r) for r in rest[i + 1:])
            break
        elif a == "--tenant":
            tenant = int(val())
        elif a == "--deadline-ms":
            deadline_ms = float(val())
        elif a == "--timeout-ms":
            timeout_ms = float(val())
        elif a == "--key":
            key = val()
        elif a == "--json":
            as_json = True
        elif a == "-e":
            if script is not None or name is not None:
                raise CliError("script already given — exactly one "
                               "of FILE, -e CHUNK, or @NAME")
            script = val()
        elif script is None and name is None and a.startswith("@"):
            name = a[1:]
        elif script is None and name is None:
            p = Path(a)
            if not p.exists():
                raise CliError(f"no such script: {p}")
            script = p.read_text()
        else:
            # everything after the script designator: script args
            script_args.append(arg_value(a))
        i += 1
    if script is None and name is None:
        raise CliError(
            "usage: pipeline run (FILE | -e CHUNK | @NAME) [ARGS...]")
    if not daemon_live(st):
        raise CliError("no live pipeline lane (start one: `python -m "
                       "libsplinter_tpu.engine.pipeliner --store ...` "
                       "or `spt supervise --lanes ...,pipeliner`)")
    key = key or f"__pl_req_{P.next_trace_id():x}"
    try:
        rec = submit_script(st, key, script=script, name=name,
                            args=script_args, timeout_ms=timeout_ms,
                            tenant=tenant, deadline_ms=deadline_ms)
    except ValueError as e:
        raise CliError(str(e)) from None
    consume_script_result(st, key)
    try:
        st.unset(key)
    except (KeyError, OSError):
        pass
    if rec is None:
        raise CliError("pipeline request timed out (lane busy or "
                       "down; see `spt metrics`)")
    if as_json:
        print(json.dumps(rec, indent=2))
    elif rec.get("ok"):
        ret = rec.get("ret") or []
        print("ok" + (": " + ", ".join(str(v) for v in ret)
                      if ret else ""))
    else:
        detail = rec.get("detail")
        raise CliError(f"script failed ({rec.get('err')})"
                       + (f": {detail}" if detail else ""))
