"""Host imports for the wasm scripting host: the `splinter` module.

The reference registers splinter.get / splinter.set host functions in its
WasmEdge VM (splinter_cli_cmd_wasm.c:85-143); this host exposes the same
pair plus the small protocol surface wasm clients need (unset, append,
bump, labels, epoch) and an `env.print` for diagnostics.

ABI (all i32 unless noted): strings/buffers cross as (ptr, len) pairs into
the instance's linear memory; rc follows the store's negative-errno
discipline, and get returns the value length written (truncated to cap).
"""
from __future__ import annotations

import errno
from typing import Callable

from .microwasm import Instance


def make_host_imports(store, out: Callable[[str], None] | None = None
                      ) -> dict:
    emit = out or (lambda s: None)

    def _key(inst: Instance, ptr: int, ln: int) -> str:
        return inst.mem_read(ptr, ln).decode("utf-8", "replace")

    def sp_get(inst: Instance, kp, kl, op, cap):
        try:
            val = store.get(_key(inst, kp, kl))
        except KeyError:
            return -errno.ENOENT
        except OSError as e:
            return -e.errno
        n = min(len(val), cap)
        inst.mem_write(op, val[:n])
        return n

    def sp_set(inst: Instance, kp, kl, vp, vl):
        try:
            store.set(_key(inst, kp, kl), inst.mem_read(vp, vl))
            return 0
        except (OSError, KeyError) as e:
            return -getattr(e, "errno", errno.EINVAL)

    def sp_unset(inst: Instance, kp, kl):
        try:
            store.unset(_key(inst, kp, kl))
            return 0
        except KeyError:
            return -errno.ENOENT
        except OSError as e:
            return -e.errno

    def sp_append(inst: Instance, kp, kl, vp, vl):
        try:
            store.append(_key(inst, kp, kl), inst.mem_read(vp, vl))
            return 0
        except KeyError:
            return -errno.ENOENT
        except OSError as e:
            return -e.errno

    def sp_bump(inst: Instance, kp, kl):
        try:
            store.bump(_key(inst, kp, kl))
            return 0
        except KeyError:
            return -errno.ENOENT
        except OSError as e:
            return -e.errno

    def sp_label_or(inst: Instance, kp, kl, mask):
        try:
            store.label_or(_key(inst, kp, kl), mask)
            return 0
        except KeyError:
            return -errno.ENOENT
        except OSError as e:
            return -e.errno

    def sp_label_clear(inst: Instance, kp, kl, mask):
        try:
            store.label_clear(_key(inst, kp, kl), mask)
            return 0
        except KeyError:
            return -errno.ENOENT
        except OSError as e:
            return -e.errno

    def sp_epoch(inst: Instance, kp, kl):
        try:
            return store.epoch(_key(inst, kp, kl))   # i64
        except (OSError, KeyError):
            return 0

    def env_print(inst: Instance, ptr, ln):
        emit(inst.mem_read(ptr, ln).decode("utf-8", "replace"))
        return None

    return {
        ("splinter", "get"): sp_get,
        ("splinter", "set"): sp_set,
        ("splinter", "unset"): sp_unset,
        ("splinter", "append"): sp_append,
        ("splinter", "bump"): sp_bump,
        ("splinter", "label_or"): sp_label_or,
        ("splinter", "label_clear"): sp_label_clear,
        ("splinter", "epoch"): sp_epoch,
        ("env", "print"): env_print,
    }
