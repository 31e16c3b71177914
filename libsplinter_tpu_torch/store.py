"""High-level Python surface over the native seqlock store.

This is the first-class binding of the framework (the reference ships
TS/Rust FFI bindings over its C ABI — bindings/ts/splinter.ts; here Python
is primary because the JAX tier lives in Python).  Semantics follow the
native ABI in native/include/sptpu.h: -EAGAIN is a retry signal and is
handled internally with bounded retries; real errors raise OSError/KeyError.

The vector lane is exposed as a zero-copy numpy view `store.vectors`
shaped (nslots, vec_dim) float32 — this is the matrix the JAX engine
stages to TPU HBM.
"""
from __future__ import annotations

import ctypes as C
import errno
import os
import time
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from . import _native as N
from .utils.faults import fault

_RETRIES = 1024


class Eagain(OSError):
    """Seqlock contention persisted past the retry budget.

    An OSError (errno EAGAIN) so generic `except OSError` handlers — the
    CLI, the scripting hosts — degrade gracefully under contention instead
    of crashing; callers that care retry by catching Eagain itself.
    """

    def __init__(self, key: str = ""):
        super().__init__(errno.EAGAIN, os.strerror(errno.EAGAIN), key)


@dataclass
class HeaderInfo:
    magic: int
    version: int
    nslots: int
    max_val: int
    vec_dim: int
    mop_mode: int
    map_size: int
    global_epoch: int
    core_flags: int
    user_flags: int
    parse_failures: int
    last_failure_epoch: int
    bus_pid: int
    used_slots: int


@dataclass
class SlotInfo:
    key: str
    index: int
    epoch: int
    labels: int
    watcher_mask: int
    val_len: int
    flags: int
    ctime: int
    atime: int

    @property
    def type(self) -> int:
        return self.flags & N.T_MASK


@dataclass
class BidInfo:
    index: int
    pid: int
    shard_id: int
    claimed_at: int
    duration: int
    intent: int
    priority: int
    live: bool


def _ck(rc: int, *, key: str | None = None) -> int:
    """Map a negative-errno return to an exception."""
    if rc >= 0:
        return rc
    e = -rc
    if e == errno.ENOENT:
        raise KeyError(key if key is not None else "<slot>")
    if e == errno.EAGAIN:
        raise Eagain(key or "")
    raise OSError(e, os.strerror(e), key)


def _retry(fn, *args, key: str | None = None):
    for _ in range(_RETRIES):
        rc = fn(*args)
        if rc != -errno.EAGAIN:
            return _ck(rc, key=key)
        time.sleep(0)  # yield to the writer
    raise Eagain(key or "")


class _LaneView(np.ndarray):
    """ndarray subclass that pins the owning Store (see Store.vectors)."""

    _store = None

    def __array_finalize__(self, obj):
        if obj is not None:
            self._store = getattr(obj, "_store", None)


class Store:
    """A handle on a shared-memory (or file-backed) splinter-tpu store."""

    def __init__(self, handle: int, name: str, flags: int):
        self._lib = N.get_lib()
        self._h = C.c_void_p(handle)
        self.name = name
        self.flags = flags
        self._vectors: np.ndarray | None = None

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, name: str, nslots: int = 1024, max_val: int = 4096,
               vec_dim: int = 768, *, persistent: bool = False,
               overwrite: bool = False) -> "Store":
        """Create a new store.  Creation is always exclusive (re-creating a
        live store would corrupt its peers); pass overwrite=True to unlink
        any existing store of that name first."""
        lib = N.get_lib()
        flags = (N.BACKEND_FILE if persistent else N.BACKEND_SHM)
        if overwrite:
            lib.spt_unlink(name.encode(), flags)
        h = lib.spt_create(name.encode(), nslots, max_val, vec_dim, flags)
        if not h:
            e = lib.spt_last_error()
            raise OSError(e, os.strerror(e), name)
        return cls(h, name, flags)

    @classmethod
    def open(cls, name: str, *, persistent: bool = False) -> "Store":
        lib = N.get_lib()
        flags = N.BACKEND_FILE if persistent else N.BACKEND_SHM
        h = lib.spt_open(name.encode(), flags)
        if not h:
            e = lib.spt_last_error()
            raise OSError(e, os.strerror(e), name)
        return cls(h, name, flags)

    @classmethod
    def open_numa(cls, name: str, node: int, *,
                  persistent: bool = False) -> tuple["Store", int]:
        """Open and mbind the mapping to a NUMA node (reference parity:
        splinter_open_numa, splinter.c:250-264).  Returns (store, bind_rc);
        bind_rc is 0 on success or -errno — advisory, the store is usable
        either way (e.g. -ENOSYS on kernels without NUMA)."""
        lib = N.get_lib()
        flags = N.BACKEND_FILE if persistent else N.BACKEND_SHM
        rc = C.c_int32(0)
        h = lib.spt_open_numa(name.encode(), flags, node, C.byref(rc))
        if not h:
            e = lib.spt_last_error()
            raise OSError(e, os.strerror(e), name)
        return cls(h, name, flags), int(rc.value)

    @staticmethod
    def unlink(name: str, *, persistent: bool = False) -> None:
        lib = N.get_lib()
        lib.spt_unlink(name.encode(),
                       N.BACKEND_FILE if persistent else N.BACKEND_SHM)

    def close(self) -> None:
        if self._h:
            self._lib.spt_close(self._h)
            self._h = C.c_void_p(None)
            self._vectors = None

    def __enter__(self) -> "Store":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- geometry ----------------------------------------------------------

    @property
    def nslots(self) -> int:
        return self._lib.spt_nslots(self._h)

    @property
    def max_val(self) -> int:
        return self._lib.spt_max_val(self._h)

    @property
    def vec_dim(self) -> int:
        return self._lib.spt_vec_dim(self._h)

    @property
    def vectors(self) -> np.ndarray:
        """Zero-copy (nslots, vec_dim) float32 view of the vector lane.

        The view aliases the mmap'd region: it keeps a reference to this
        Store so garbage collection can't unmap underneath it, but an
        EXPLICIT close() does unmap — drop all views before closing.
        """
        if self._vectors is None:
            dim = self.vec_dim
            if dim == 0:
                raise ValueError("store has no vector lane (vec_dim=0)")
            base = self._lib.spt_vec_lane(self._h)
            n = self.nslots
            buf = (C.c_float * (n * dim)).from_address(base)
            arr = np.frombuffer(buf, dtype=np.float32).reshape(n, dim)
            arr = arr.view(_LaneView)
            arr._store = self  # keep the mapping alive while views exist
            self._vectors = arr
        return self._vectors

    # -- KV ----------------------------------------------------------------

    def set(self, key: str, val: bytes | str) -> None:
        fault("store.set")
        if isinstance(val, str):
            val = val.encode()
        _retry(self._lib.spt_set, self._h, key.encode(), val, len(val),
               key=key)

    def get(self, key: str) -> bytes:
        cap = self.max_val
        buf = C.create_string_buffer(cap)
        length = C.c_uint32()
        _retry(self._lib.spt_get, self._h, key.encode(), buf, cap,
               C.byref(length), key=key)
        return buf.raw[: length.value]

    def get_str(self, key: str) -> str:
        return self.get(key).decode(errors="replace")

    def value_len(self, key: str) -> int:
        length = C.c_uint32()
        _retry(self._lib.spt_get, self._h, key.encode(), None, 0,
               C.byref(length), key=key)
        return length.value

    def unset(self, key: str) -> None:
        _retry(self._lib.spt_unset, self._h, key.encode(), key=key)

    def append(self, key: str, val: bytes | str) -> None:
        fault("store.append")
        if isinstance(val, str):
            val = val.encode()
        _retry(self._lib.spt_append, self._h, key.encode(), val, len(val),
               key=key)

    def list(self) -> list[str]:
        n = self.nslots
        buf = C.create_string_buffer(n * N.KEY_MAX)
        count = _ck(self._lib.spt_list(self._h, buf, n))
        # one copy of the buffer for all keys: buf.raw copies all of it
        # (n * KEY_MAX bytes), so reading it per key is quadratic
        raw = buf.raw
        out = []
        for i in range(count):
            key = raw[i * N.KEY_MAX:(i + 1) * N.KEY_MAX]
            out.append(key.split(b"\0", 1)[0].decode(errors="replace"))
        return out

    def __contains__(self, key: str) -> bool:
        return self._lib.spt_find_index(self._h, key.encode()) >= 0

    def __iter__(self) -> Iterator[str]:
        return iter(self.list())

    def poll(self, key: str, timeout_ms: int = -1) -> bool:
        rc = self._lib.spt_poll(self._h, key.encode(), timeout_ms)
        if rc == -errno.ETIMEDOUT:
            return False
        _ck(rc, key=key)
        return True

    # -- index accessors ---------------------------------------------------

    def find_index(self, key: str) -> int:
        return _ck(self._lib.spt_find_index(self._h, key.encode()), key=key)

    def key_at(self, idx: int) -> str | None:
        buf = C.create_string_buffer(N.KEY_MAX)
        rc = self._lib.spt_key_at(self._h, idx, buf)
        if rc == -errno.ENOENT:
            return None
        _ck(rc)
        return buf.value.decode(errors="replace")

    def epoch_at(self, idx: int) -> int:
        return self._lib.spt_epoch_at(self._h, idx)

    def epoch(self, key: str) -> int:
        return self.epoch_at(self.find_index(key))

    def get_at(self, idx: int) -> bytes:
        cap = self.max_val
        buf = C.create_string_buffer(cap)
        length = C.c_uint32()
        _retry(self._lib.spt_get_at, self._h, idx, buf, cap,
               C.byref(length))
        return buf.raw[: length.value]

    def labels_at(self, idx: int) -> int:
        return self._lib.spt_labels_at(self._h, idx)

    def flags_at(self, idx: int) -> int:
        return self._lib.spt_flags_at(self._h, idx)

    # -- snapshots ---------------------------------------------------------

    def header(self) -> HeaderInfo:
        v = N.HeaderView()
        _ck(self._lib.spt_header_snapshot(self._h, C.byref(v)))
        return HeaderInfo(
            magic=v.magic, version=v.version, nslots=v.nslots,
            max_val=v.max_val, vec_dim=v.vec_dim, mop_mode=v.mop_mode,
            map_size=v.map_size, global_epoch=v.global_epoch,
            core_flags=v.core_flags, user_flags=v.user_flags,
            parse_failures=v.parse_failures,
            last_failure_epoch=v.last_failure_epoch,
            bus_pid=v.bus_pid, used_slots=v.used_slots)

    def slot(self, key: str) -> SlotInfo:
        v = N.SlotView()
        _retry(self._lib.spt_slot_snapshot, self._h, key.encode(),
               C.byref(v), key=key)
        return self._slotinfo(v)

    def slot_at(self, idx: int) -> SlotInfo:
        v = N.SlotView()
        _retry(self._lib.spt_slot_snapshot_at, self._h, idx, C.byref(v))
        return self._slotinfo(v)

    @staticmethod
    def _slotinfo(v: N.SlotView) -> SlotInfo:
        return SlotInfo(
            key=v.key.split(b"\0", 1)[0].decode(errors="replace"),
            index=v.index, epoch=v.epoch, labels=v.labels,
            watcher_mask=v.watcher_mask, val_len=v.val_len, flags=v.flags,
            ctime=v.ctime, atime=v.atime)

    # -- types -------------------------------------------------------------

    def set_type(self, key: str, type_flag: int) -> None:
        _retry(self._lib.spt_set_type, self._h, key.encode(), type_flag,
               key=key)

    def get_type(self, key: str) -> int:
        t = C.c_uint32()
        _retry(self._lib.spt_get_type, self._h, key.encode(), C.byref(t),
               key=key)
        return t.value

    def integer_op(self, key: str, op: int, operand: int = 0) -> int:
        r = C.c_uint64()
        _retry(self._lib.spt_integer_op, self._h, key.encode(), op,
               operand, C.byref(r), key=key)
        return r.value

    def get_uint(self, key: str) -> int:
        raw = self.get(key)
        if len(raw) != 8:
            raise ValueError(f"{key}: not a BIGUINT slot")
        return int.from_bytes(raw, "little")

    def set_uint(self, key: str, value: int) -> None:
        self.set(key, value.to_bytes(8, "little"))
        self.set_type(key, N.T_BIGUINT)

    # -- tandem ------------------------------------------------------------

    def tandem_set(self, base: str, chunks: Sequence[bytes | str]) -> int:
        for i, ch in enumerate(chunks):
            self.tandem_set_at(base, i, ch)
        return len(chunks)

    def tandem_set_at(self, base: str, order: int,
                      val: bytes | str) -> None:
        """Write a single tandem order (0 = the base key itself)."""
        if isinstance(val, str):
            val = val.encode()
        _retry(self._lib.spt_tandem_set, self._h, base.encode(), order,
               val, len(val), key=base)

    def tandem_get(self, base: str, order: int) -> bytes:
        cap = self.max_val
        buf = C.create_string_buffer(cap)
        length = C.c_uint32()
        _retry(self._lib.spt_tandem_get, self._h, base.encode(), order,
               buf, cap, C.byref(length), key=base)
        return buf.raw[: length.value]

    def tandem_count(self, base: str) -> int:
        return _ck(self._lib.spt_tandem_count(self._h, base.encode()))

    def tandem_unset(self, base: str, max_order: int = 4096) -> int:
        return _ck(self._lib.spt_tandem_unset(self._h, base.encode(),
                                              max_order))

    # -- labels ------------------------------------------------------------

    def label_or(self, key: str, mask: int) -> None:
        _retry(self._lib.spt_label_or, self._h, key.encode(), mask, key=key)

    def label_clear(self, key: str, mask: int) -> None:
        _retry(self._lib.spt_label_andnot, self._h, key.encode(), mask,
               key=key)

    def labels(self, key: str) -> int:
        v = C.c_uint64()
        _retry(self._lib.spt_get_labels, self._h, key.encode(),
               C.byref(v), key=key)
        return v.value

    def enumerate_indices(self, mask: int) -> list[int]:
        n = self.nslots
        out = (C.c_uint32 * n)()
        count = _ck(self._lib.spt_enumerate(self._h, mask, out, n))
        return list(out[:count])

    def enumerate_keys(self, mask: int) -> list[str]:
        keys = []
        for idx in self.enumerate_indices(mask):
            k = self.key_at(idx)
            if k is not None:
                keys.append(k)
        return keys

    # -- signals -----------------------------------------------------------

    def watch_register(self, key: str, group: int) -> None:
        _retry(self._lib.spt_watch_register, self._h, key.encode(), group,
               key=key)

    def watch_unregister(self, key: str, group: int) -> None:
        _retry(self._lib.spt_watch_unregister, self._h, key.encode(),
               group, key=key)

    def watch_label_register(self, bloom_bit: int, group: int) -> None:
        _ck(self._lib.spt_watch_label_register(self._h, bloom_bit, group))

    def watch_label_unregister(self, bloom_bit: int, group: int) -> None:
        _ck(self._lib.spt_watch_label_unregister(self._h, bloom_bit, group))

    def signal_count(self, group: int) -> int:
        return self._lib.spt_signal_count(self._h, group)

    def pulse(self, group: int) -> None:
        _ck(self._lib.spt_signal_pulse(self._h, group))

    def bump(self, key: str) -> None:
        _retry(self._lib.spt_bump, self._h, key.encode(), key=key)

    def signal_wait(self, group: int, last: int,
                    timeout_ms: int = -1) -> int | None:
        """Block (in C, GIL released) until the group count moves past
        `last`.  Returns the new count, or None on timeout."""
        out = C.c_uint64()
        rc = self._lib.spt_signal_wait(self._h, group, last, timeout_ms,
                                       C.byref(out))
        if rc == -errno.ETIMEDOUT:
            return None
        _ck(rc)
        return out.value

    # -- event bus ---------------------------------------------------------

    def bus_init(self) -> None:
        _ck(self._lib.spt_bus_init(self._h))

    def bus_open(self) -> bool:
        """Attach to the owner's eventfd.  False if pidfd_getfd is
        unavailable (callers fall back to polling drain_dirty)."""
        rc = self._lib.spt_bus_open(self._h)
        if rc in (-errno.ENOSYS, -errno.EPERM):
            return False
        _ck(rc)
        return True

    def bus_attach(self) -> bool:
        """Join the event bus as owner or subscriber, whichever the
        header calls for.  A recorded owner that died without
        resigning (crashed lanes exit via os._exit, skipping
        bus_close) leaves its pid in the header; pidfd_open on it
        fails ESRCH forever, which used to kill every respawned lane
        at attach.  Adopt the bus instead: bus_init atomically
        installs this process as the new owner and bumps bus_gen, so
        surviving subscribers re-attach on their next ensure-open.
        False = no eventfd path on this host (pidfd_getfd denied) —
        the caller's polling drain still works."""
        if self.header().bus_pid == 0:
            self.bus_init()
            return True
        try:
            return self.bus_open()
        except OSError:
            # owner unreachable (dead pid, stale fd): take over
            self.bus_init()
            return True

    def bus_wait(self, timeout_ms: int) -> bool:
        rc = self._lib.spt_bus_wait(self._h, timeout_ms)
        if rc in (-errno.ETIMEDOUT, -errno.ENOTCONN, -errno.ENOSYS):
            return False
        _ck(rc)
        return True

    def bus_close(self) -> None:
        _ck(self._lib.spt_bus_close(self._h))

    def drain_dirty(self) -> list[int]:
        """Fetch-and-clear the dirty mask; return dirty *bit* numbers.
        When nslots <= 1024 a bit number IS the slot index."""
        words = (C.c_uint64 * N.DIRTY_WORDS)()
        n = _ck(self._lib.spt_bus_drain(self._h, words))
        if n == 0:
            return []
        bits = []
        for w in range(N.DIRTY_WORDS):
            v = words[w]
            while v:
                b = (v & -v).bit_length() - 1
                bits.append(w * 64 + b)
                v &= v - 1
        return bits

    def dirty_to_indices(self, bits: list[int]) -> list[int]:
        """Expand dirty bits to candidate slot indices (bit = idx % 1024)."""
        n = self.nslots
        if n <= 1024:
            return [b for b in bits if b < n]
        out = []
        for b in bits:
            out.extend(range(b, n, 1024))
        return out

    # -- shard bids --------------------------------------------------------

    def shard_claim(self, shard_id: int, intent: int = N.ADV_WILLNEED,
                    priority: int = 1,
                    duration_us: int = 30_000_000) -> int:
        return _ck(self._lib.spt_shard_claim(self._h, shard_id, intent,
                                             priority, duration_us))

    def shard_claim_ex(self, shard_id: int, pid: int, intent: int,
                       priority: int, duration_us: int,
                       claimed_at_us: int) -> int:
        return _ck(self._lib.spt_shard_claim_ex(
            self._h, shard_id, pid, intent, priority, duration_us,
            claimed_at_us))

    def shard_rebid(self, bid_idx: int) -> None:
        _ck(self._lib.spt_shard_rebid(self._h, bid_idx))

    def shard_release(self, bid_idx: int) -> None:
        _ck(self._lib.spt_shard_release(self._h, bid_idx))

    def shard_election(self) -> int | None:
        rc = self._lib.spt_shard_election(self._h)
        if rc == -errno.ENOENT:
            return None
        return _ck(rc)

    def bid_info(self, bid_idx: int) -> BidInfo:
        v = N.BidView()
        _ck(self._lib.spt_bid_info(self._h, bid_idx, C.byref(v)))
        return BidInfo(index=bid_idx, pid=v.pid, shard_id=v.shard_id,
                       claimed_at=v.claimed_at, duration=v.duration,
                       intent=v.intent, priority=v.priority,
                       live=bool(v.live))

    def bid_table(self) -> list[BidInfo]:
        return [self.bid_info(i) for i in range(N.MAX_BIDS)]

    def madvise(self, bid_idx: int, advice: int, *, offset: int = 0,
                length: int = 0, timeout_ms: int = 0) -> bool:
        """True if the advisement was issued; False if deferred (-EAGAIN)
        or the wait timed out."""
        rc = self._lib.spt_madvise(self._h, bid_idx, offset, length,
                                   advice, timeout_ms)
        if rc in (-errno.EAGAIN, -errno.ETIMEDOUT):
            return False
        _ck(rc)
        return True

    # -- mop / purge / recovery -------------------------------------------

    def set_mop(self, mode: int) -> None:
        _ck(self._lib.spt_set_mop(self._h, mode))

    def get_mop(self) -> int:
        return self._lib.spt_get_mop(self._h)

    def purge(self) -> int:
        return _ck(self._lib.spt_purge(self._h))

    def retrain(self, key: str) -> None:
        _retry(self._lib.spt_retrain, self._h, key.encode(), key=key)

    # -- system keys / flags ----------------------------------------------

    def set_system(self, key: str) -> None:
        _retry(self._lib.spt_set_system, self._h, key.encode(), key=key)

    def slot_usr_set(self, key: str, bits: int) -> None:
        _retry(self._lib.spt_slot_usr_set, self._h, key.encode(), bits,
               key=key)

    def slot_usr_get(self, key: str) -> int:
        v = C.c_uint8()
        _retry(self._lib.spt_slot_usr_get, self._h, key.encode(),
               C.byref(v), key=key)
        return v.value

    def config_set_user(self, bits: int) -> None:
        _ck(self._lib.spt_config_set_user(self._h, bits))

    def config_get_user(self) -> int:
        return self._lib.spt_config_get_user(self._h)

    # -- timestamps --------------------------------------------------------

    @staticmethod
    def now() -> int:
        return N.get_lib().spt_now()

    @staticmethod
    def ticks_per_us() -> int:
        return N.get_lib().spt_ticks_per_us()

    def stamp(self, key: str, which: int = 2, ticks_ago: int = 0) -> None:
        _retry(self._lib.spt_stamp, self._h, key.encode(), which,
               ticks_ago, key=key)

    # -- vectors -----------------------------------------------------------

    def vec_set(self, key: str, vec: np.ndarray) -> None:
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        _retry(self._lib.spt_vec_set, self._h, key.encode(),
               vec.ctypes.data_as(C.c_void_p), vec.size, key=key)

    def vec_get(self, key: str) -> np.ndarray:
        dim = self.vec_dim
        out = np.empty(dim, dtype=np.float32)
        _retry(self._lib.spt_vec_get, self._h, key.encode(),
               out.ctypes.data_as(C.c_void_p), dim, key=key)
        return out

    def vec_set_at(self, idx: int, vec: np.ndarray) -> None:
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        _retry(self._lib.spt_vec_set_at, self._h, idx,
               vec.ctypes.data_as(C.c_void_p), vec.size)

    def vec_get_at(self, idx: int) -> np.ndarray:
        dim = self.vec_dim
        out = np.empty(dim, dtype=np.float32)
        _retry(self._lib.spt_vec_get_at, self._h, idx,
               out.ctypes.data_as(C.c_void_p), dim)
        return out

    def epochs(self) -> np.ndarray:
        """Bulk snapshot of every slot's epoch as a (nslots,) uint64 array.
        Diff consecutive snapshots to find changed rows (the device-lane
        cache's dirty detector)."""
        out = np.empty(self.nslots, dtype=np.uint64)
        _ck(self._lib.spt_epochs(
            self._h, out.ctypes.data_as(C.POINTER(C.c_uint64))))
        return out

    GATHER_TORN = np.uint64(0xFFFFFFFFFFFFFFFF)

    def vec_gather(self, rows: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Torn-safe gather of vector rows.  Returns (vecs, epochs):
        vecs is (len(rows), vec_dim) float32; epochs[i] is the stable
        epoch of row i (0 = stable never-written slot, zeros row), or
        GATHER_TORN if that row was mid-write / out of range (its vecs
        row is undefined — retry it next pass)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        n = rows.size
        vecs = np.zeros((n, self.vec_dim), dtype=np.float32)
        eps = np.zeros(n, dtype=np.uint64)
        _ck(self._lib.spt_vec_gather(
            self._h, rows.ctypes.data_as(C.POINTER(C.c_uint32)), n,
            vecs.ctypes.data_as(C.c_void_p),
            eps.ctypes.data_as(C.POINTER(C.c_uint64))))
        return vecs, eps

    def vec_gather_iter(self, rows: np.ndarray, chunks: Sequence[int]
                        ) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
        """Chunked torn-safe gather: yields (offset, vecs, epochs) per
        chunk, where `chunks` is a sequence of chunk lengths that
        partitions `rows` (a short final chunk is clipped; lengths past
        the end of `rows` yield nothing).  Bounds the host-side copy to
        one chunk at a time and lets a consumer overlap the gather of
        chunk i+1 with device work dispatched on chunk i — the
        StagedLane refresh path's pipelining contract."""
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        lo = 0
        for length in chunks:
            if lo >= rows.size:
                return
            sub = rows[lo: lo + int(length)]
            vecs, eps = self.vec_gather(sub)
            yield lo, vecs, eps
            lo += sub.size

    def vec_commit_batch(self, rows: np.ndarray, epochs: np.ndarray,
                         vecs: np.ndarray, *,
                         write_once: bool = False) -> np.ndarray:
        """Commit a batch of vectors gated on captured epochs.  Returns the
        per-row int32 results (0 ok / -ESTALE raced / -EEXIST skip)."""
        fault("store.vec_commit")
        rows = np.ascontiguousarray(rows, dtype=np.uint32)
        epochs = np.ascontiguousarray(epochs, dtype=np.uint64)
        vecs = np.ascontiguousarray(vecs, dtype=np.float32)
        n = rows.size
        results = np.zeros(n, dtype=np.int32)
        rc = self._lib.spt_vec_commit_batch(
            self._h,
            rows.ctypes.data_as(C.POINTER(C.c_uint32)),
            epochs.ctypes.data_as(C.POINTER(C.c_uint64)),
            vecs.ctypes.data_as(C.c_void_p),
            n, vecs.shape[-1], int(write_once),
            results.ctypes.data_as(C.POINTER(C.c_int32)))
        _ck(rc)
        return results

    # -- diagnostics -------------------------------------------------------

    def report_parse_failure(self) -> None:
        _ck(self._lib.spt_report_parse_failure(self._h))
