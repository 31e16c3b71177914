"""The `splinter` Lua module: store bindings for the scripting host.

Same host-function surface as the reference's embedded Lua
(splinter_cli_cmd_lua.c:365-386): get, get_tandem, set, set_tandem, math,
watch, unwatch, label, unset, bump, sleep, get_embedding, set_embedding —
plus epoch/list/poll which scripts kept reimplementing via watch loops.

Value conventions match the reference host:
  - get returns a string, or a Lua integer for BIGUINT slots, or nil;
  - set accepts strings or numbers (non-negative integers are stored as
    decimal text then auto-promoted to BIGUINT so splinter.math works on
    them; negatives and floats stay text — BIGUINT is unsigned);
  - embeddings cross the boundary as 1-based Lua arrays of numbers;
  - errors return nil (+ message where useful) rather than raising, so
    scripts can `or`-chain defaults, e.g. `bus.get(k) or 0`.
"""
from __future__ import annotations

import time

from .. import _native as N
from .microlua import LuaRuntime, LuaTable, _wrap_i64

_IOPS = {
    "and": N.IOP_AND, "or": N.IOP_OR, "xor": N.IOP_XOR, "not": N.IOP_NOT,
    "inc": N.IOP_INC, "dec": N.IOP_DEC, "add": N.IOP_ADD, "sub": N.IOP_SUB,
}


def make_splinter_module(store, budget=None) -> LuaTable:
    """Build the `splinter` table over a libsplinter_tpu.store.Store.

    `budget` (scripting.sandbox.ScriptBudget) clamps the blocking
    verbs — today `sleep`, which used to honor any float a script
    passed (`sleep(1e9)` wedged the host for 31 years): with a budget
    it sleeps at most `max_sleep_s` and never past the session's
    remaining deadline.  The CLI host and the pipeline lane both pass
    one, so their sandbox semantics cannot drift."""

    def _get(key):
        if key is None:
            return None
        key = str(key)
        try:
            if store.get_type(key) & N.T_BIGUINT:
                return store.get_uint(key)
            raw = store.get(key)
        except (OSError, KeyError, ValueError):
            return None
        if raw is None:
            return None
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw.decode("latin-1")

    def _set(key, value):
        if key is None or value is None:
            return None
        key = str(key)
        try:
            if isinstance(value, bool):
                store.set(key, b"1" if value else b"0")
            elif isinstance(value, int) and 0 <= value < 2**64:
                # uint64-range numbers become BIGUINT so splinter.math
                # works right away; negatives and >=2^64 stay text
                # (promotion would fail or wrap after the write)
                store.set(key, str(value).encode())
                store.set_type(key, N.T_BIGUINT)
            elif isinstance(value, int):
                store.set(key, str(value).encode())
            elif isinstance(value, float):
                store.set(key, repr(value).encode())
            else:
                store.set(key, str(value).encode())
        except (OSError, KeyError) as e:
            return (None, str(e))
        return 0

    def _unset(key):
        try:
            store.unset(str(key))
            return 0
        except (OSError, KeyError):
            return None

    def _get_tandem(base, order):
        try:
            raw = store.tandem_get(str(base), int(order))
        except (OSError, KeyError):
            return None
        return None if raw is None else raw.decode("utf-8", "replace")

    def _set_tandem(base, order, value):
        try:
            store.tandem_set_at(str(base), int(order), str(value))
            return 0
        except (OSError, KeyError):
            return None

    def _math(key, op, operand=0):
        op = str(op).lower()
        if op not in _IOPS:
            return (None, f"unknown op '{op}'")
        try:
            return store.integer_op(str(key), _IOPS[op], int(operand))
        except (OSError, KeyError) as e:
            return (None, str(e))

    def _watch(key, group):
        try:
            store.watch_register(str(key), int(group))
            return 0
        except (OSError, KeyError):
            return None

    def _unwatch(key, group):
        try:
            store.watch_unregister(str(key), int(group))
            return 0
        except (OSError, KeyError):
            return None

    def _label(key, mask, clear=None):
        try:
            if clear:
                store.label_clear(str(key), int(mask))
            else:
                store.label_or(str(key), int(mask))
            return 0
        except (OSError, KeyError):
            return None

    def _labels(key):
        """Read a key's bloom label mask (nil on a missing key) — the
        counterpart scripts need now that 5.4 bitwise operators make
        mask tests (m & BIT ~= 0) expressible in-script.  Wrapped to
        the interpreter's signed-i64 convention so a mask with bit 63
        set compares equal to the in-script `1 << 63` constant."""
        try:
            return _wrap_i64(store.labels(str(key)))
        except (OSError, KeyError):
            return None

    def _bump(key):
        try:
            store.bump(str(key))
            return 0
        except (OSError, KeyError):
            return None

    def _sleep(seconds):
        s = float(seconds)
        if budget is not None:
            s = budget.clamp_sleep(s)
        time.sleep(s)
        return 0

    def _get_embedding(key):
        try:
            vec = store.vec_get(str(key))
        except (OSError, KeyError):
            return None
        if vec is None:
            return None
        return LuaTable.from_list([float(x) for x in vec])

    def _set_embedding(key, tbl):
        if not isinstance(tbl, LuaTable):
            return None
        vals = [float(v) for v in tbl.to_list()]
        try:
            store.vec_set(str(key), vals)
            return 0
        except (OSError, KeyError, ValueError) as e:
            return (None, str(e))

    def _epoch(key):
        try:
            return store.epoch(str(key))
        except (OSError, KeyError):
            return None

    def _list():
        return LuaTable.from_list(store.list())

    def _poll(key, timeout_ms):
        try:
            return 0 if store.poll(str(key), int(timeout_ms)) else None
        except (OSError, KeyError):
            return None

    def _signal_count(group):
        return store.signal_count(int(group))

    return LuaTable({
        "get": _get,
        "set": _set,
        "unset": _unset,
        "get_tandem": _get_tandem,
        "set_tandem": _set_tandem,
        "math": _math,
        "watch": _watch,
        "unwatch": _unwatch,
        "label": _label,
        "labels": _labels,
        "bump": _bump,
        "sleep": _sleep,
        "get_embedding": _get_embedding,
        "set_embedding": _set_embedding,
        "epoch": _epoch,
        "list": _list,
        "poll": _poll,
        "signal_count": _signal_count,
    })


def make_runtime(store, output=None, budget=None) -> LuaRuntime:
    """LuaRuntime with the splinter module registered (require-able and
    predeclared as the global `splinter`).  With `budget` given the
    blocking verbs are clamped (the sandboxed hosts go further — see
    scripting.sandbox.make_sandboxed_runtime)."""
    rt = LuaRuntime(output=output)
    rt.register_module("splinter", make_splinter_module(store,
                                                        budget=budget))
    return rt
