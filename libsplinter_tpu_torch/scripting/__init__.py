"""Embedded scripting hosts for the CLI.

The reference CLI embeds Lua 5.4 and a WasmEdge VM as scripting hosts
(splinter_cli_cmd_lua.c, splinter_cli_cmd_wasm.c).  This build image ships
neither runtime, so both hosts are self-contained:

- ``microlua``: a from-scratch interpreter for the Lua 5.4 subset the
  scripting surface uses (functions, closures, tables, control flow,
  string/table/math stdlib) — see its docstring for the exact subset;
- ``microwasm``: a from-scratch WebAssembly-MVP interpreter executing
  binary modules with imported host functions.

Both expose the same ``splinter`` host API as the reference
(get/set/tandem/math/watch/label/bump/sleep/embeddings) over a Store.
"""
from .microlua import LuaError, LuaRuntime, LuaTable  # noqa: F401
