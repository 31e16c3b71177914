"""splinterctl-style CLI / REPL for the splinter-tpu store.

Command-set parity with the reference CLI (SURVEY.md §2.3: module
registry + dispatch, one-shot mode, quote-aware REPL, ~/.splinterrc label
table, namespace prefix env).  Python replaces the reference's C module
system; the vector-search command scores on the port's hand-written
CUDA kernels instead of a scalar CPU scan.

Device rule: a command that scores nothing (get, set, list, health,
metrics, top, ...) imports no torch, so it never builds a CUDA context
beside the daemons that hold the card.  `search` scores on the card
unless it is given --cpu, and never falls back to the CPU in silence.

Environment:
  SPTPU_DEFAULT_STORE  store name used when --store is omitted
  SPTPU_NS_PREFIX      transparent key namespace prefix
  SPTPU_HISTORY        REPL history file (default ~/.sptpu_history)
  ~/.sptpurc           label name table:  name = 0xMASK  per line
"""
from __future__ import annotations

import json
import os
import re
import shlex
import sys
import time
import uuid as uuidlib
from pathlib import Path

import numpy as np

from .. import _native as N
from ..store import Store
from ..engine import protocol as P

TYPE_NAMES = {
    N.T_VOID: "VOID", N.T_BIGINT: "BIGINT", N.T_BIGUINT: "BIGUINT",
    N.T_JSON: "JSON", N.T_BINARY: "BINARY", N.T_IMGDATA: "IMGDATA",
    N.T_AUDIO: "AUDIO", N.T_VARTEXT: "VARTEXT",
}
NAME_TYPES = {v: k for k, v in TYPE_NAMES.items()}
ADVICE_NAMES = {"normal": N.ADV_NORMAL, "sequential": N.ADV_SEQUENTIAL,
                "random": N.ADV_RANDOM, "willneed": N.ADV_WILLNEED,
                "dontneed": N.ADV_DONTNEED}
IOP_NAMES = {"and": N.IOP_AND, "or": N.IOP_OR, "xor": N.IOP_XOR,
             "not": N.IOP_NOT, "inc": N.IOP_INC, "dec": N.IOP_DEC,
             "add": N.IOP_ADD, "sub": N.IOP_SUB}


class CliError(Exception):
    pass


def load_labelrc() -> dict[str, int]:
    table: dict[str, int] = {}
    path = Path(os.environ.get("SPTPU_RC", Path.home() / ".sptpurc"))
    if path.exists():
        for line in path.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if "=" in line:
                name, _, val = line.partition("=")
                try:
                    table[name.strip()] = int(val.strip(), 0)
                except ValueError:
                    pass
    return table


class Session:
    """CLI session state (mirrors the reference's cli_user_t)."""

    def __init__(self, store_name: str | None = None,
                 persistent: bool = False):
        self.store_name = store_name or os.environ.get(
            "SPTPU_DEFAULT_STORE", "/sptpu_default")
        self.persistent = persistent
        self.ns_prefix = os.environ.get("SPTPU_NS_PREFIX", "")
        self.labels = load_labelrc()
        self._store: Store | None = None
        self._lanes: dict = {}          # device -> StagedLane, lazy
                                        # (search caches the device lane
                                        # across REPL cmds)
        self._lane = None               # the lane last searched (metrics)
        self.pod_search = None          # PodSearch, lazy (search --sharded)

    @property
    def store(self) -> Store:
        if self._store is None:
            try:
                self._store = Store.open(self.store_name,
                                         persistent=self.persistent)
            except OSError as e:
                raise CliError(
                    f"cannot open store {self.store_name!r}: {e} "
                    f"(run `init` first?)") from e
        return self._store

    def key(self, k: str) -> str:
        return self.ns_prefix + k

    def label_mask(self, spec: str) -> int:
        if spec in self.labels:
            return self.labels[spec]
        return int(spec, 0)

    def lane(self, device):
        """Device-resident vector lane cache on `device`, created on
        the first search there and refreshed incrementally (dirty rows
        only) on later ones — the REPL amortizes the full upload across
        its lifetime.  One lane per device, so a REPL that mixes --cpu
        and card searches never scores on the wrong one."""
        key = str(device)
        if key not in self._lanes:
            from ..ops import StagedLane
            self._lanes[key] = StagedLane(self.store, device=device)
        self._lane = self._lanes[key]
        return self._lane

    def close(self) -> None:
        self._lanes.clear()
        self._lane = None
        self.pod_search = None
        if self._store is not None:
            self._store.close()
            self._store = None


# ---------------------------------------------------------------- commands

COMMANDS: dict[str, tuple] = {}


def command(name, usage, help_):
    def deco(fn):
        COMMANDS[name] = (fn, usage, help_)
        return fn
    return deco


@command("init", "init [nslots] [max_val] [vec_dim]",
         "create the store (default 1024 slots, 4 KiB values, 768-d)")
def cmd_init(ses, args):
    nslots = int(args[0]) if len(args) > 0 else 1024
    max_val = int(args[1]) if len(args) > 1 else 4096
    vec_dim = int(args[2]) if len(args) > 2 else 768
    st = Store.create(ses.store_name, nslots, max_val, vec_dim,
                      persistent=ses.persistent)
    ses._store = st
    print(f"created {ses.store_name}: {nslots} slots x {st.max_val}B, "
          f"vec {vec_dim}d")


@command("set", "set KEY VALUE...", "set a key")
def cmd_set(ses, args):
    if len(args) < 2:
        raise CliError("usage: set KEY VALUE")
    ses.store.set(ses.key(args[0]), " ".join(args[1:]))


@command("get", "get KEY", "print a key's value")
def cmd_get(ses, args):
    if not args:
        raise CliError("usage: get KEY")
    sys.stdout.write(ses.store.get_str(ses.key(args[0])))
    sys.stdout.write("\n")


@command("append", "append KEY VALUE...", "append to a key's value")
def cmd_append(ses, args):
    if len(args) < 2:
        raise CliError("usage: append KEY VALUE")
    ses.store.append(ses.key(args[0]), " ".join(args[1:]))


@command("unset", "unset KEY [--tandem]",
         "delete a key (--tandem removes the whole ordered set)")
def cmd_unset(ses, args):
    if not args:
        raise CliError("usage: unset KEY")
    if "--tandem" in args:
        base = [a for a in args if not a.startswith("--")][0]
        n = ses.store.tandem_unset(ses.key(base))
        print(f"removed {n} keys")
    else:
        ses.store.unset(ses.key(args[0]))


@command("list", "list [REGEX]", "list keys (optionally regex-filtered)")
def cmd_list(ses, args):
    keys = ses.store.list()
    if args:
        rx = re.compile(args[0])
        keys = [k for k in keys if rx.search(k)]
    for k in sorted(keys):
        print(k)


@command("head", "head KEY", "dump slot metadata incl. vector stats")
def cmd_head(ses, args):
    if not args:
        raise CliError("usage: head KEY")
    st = ses.store
    s = st.slot(ses.key(args[0]))
    print(f"key      {s.key}")
    print(f"index    {s.index}")
    print(f"epoch    {s.epoch}")
    print(f"type     {TYPE_NAMES.get(s.type, hex(s.type))}")
    print(f"len      {s.val_len}")
    print(f"labels   {s.labels:#018x}")
    print(f"watchers {s.watcher_mask:#018x}")
    print(f"ctime    {s.ctime}  atime {s.atime}")
    if st.vec_dim:
        v = st.vec_get_at(s.index)
        mag = float(np.linalg.norm(v))
        csum = int(np.bitwise_xor.reduce(v.view(np.uint32))) \
            if v.size else 0
        print(f"vector   dim={st.vec_dim} |v|={mag:.4f} "
              f"xor={csum:#010x}")


@command("type", "type KEY [TYPENAME]", "get/set a slot's named type")
def cmd_type(ses, args):
    if not args:
        raise CliError("usage: type KEY [TYPENAME]")
    key = ses.key(args[0])
    if len(args) == 1:
        print(TYPE_NAMES.get(ses.store.get_type(key), "?"))
    else:
        t = NAME_TYPES.get(args[1].upper())
        if t is None:
            raise CliError(f"unknown type {args[1]} "
                           f"(one of {', '.join(NAME_TYPES)})")
        ses.store.set_type(key, t)


@command("label", "label KEY [+MASK|-MASK]",
         "get/set bloom labels (MASK may be a ~/.sptpurc name)")
def cmd_label(ses, args):
    if not args:
        raise CliError("usage: label KEY [+MASK|-MASK]")
    key = ses.key(args[0])
    if len(args) == 1:
        print(f"{ses.store.labels(key):#018x}")
    else:
        spec = args[1]
        if spec.startswith("-"):
            ses.store.label_clear(key, ses.label_mask(spec[1:]))
        else:
            ses.store.label_or(key, ses.label_mask(spec.lstrip("+")))


@command("bump", "bump KEY|@GROUP",
         "pulse a key's watcher groups (or a group directly)")
def cmd_bump(ses, args):
    if not args:
        raise CliError("usage: bump KEY|@GROUP")
    if args[0].startswith("@"):
        ses.store.pulse(int(args[0][1:]))
    else:
        ses.store.bump(ses.key(args[0]))


@command("math", "math KEY OP [OPERAND]",
         "atomic integer op on a BIGUINT slot (and/or/xor/not/inc/dec/"
         "add/sub)")
def cmd_math(ses, args):
    if len(args) < 2:
        raise CliError("usage: math KEY OP [OPERAND]")
    op = IOP_NAMES.get(args[1].lower())
    if op is None:
        raise CliError(f"unknown op {args[1]}")
    operand = int(args[2], 0) if len(args) > 2 else 0
    print(ses.store.integer_op(ses.key(args[0]), op, operand))


@command("orders", "orders BASE", "show a tandem key set")
def cmd_orders(ses, args):
    if not args:
        raise CliError("usage: orders BASE")
    base = ses.key(args[0])
    n = ses.store.tandem_count(base)
    print(f"{base}: {n} orders")
    for i in range(n):
        k = base if i == 0 else f"{base}.{i}"
        print(f"  [{i}] {k} ({ses.store.value_len(k)}B)")


@command("watch", "watch KEY|@GROUP [TIMEOUT_MS] [--oneshot]",
         "continuous change watch (Ctrl-] or stdin EOF aborts); with "
         "TIMEOUT_MS or --oneshot: stop after the first event")
def cmd_watch(ses, args):
    """Continuous key/group watch (reference behavior:
    splinter_cli_cmd_watch.c:73-183 — raw-terminal loop, Ctrl-] abort,
    `size:value` per key change, pulse lines per group signal).

    TPU-idiom differences: waits block in C on the event bus / poll
    with a short timeout instead of a 50 ms usleep spin, and stdin EOF
    aborts too, so scripts can drive the loop through a pipe (the
    cli_regression.sh interactive check does exactly that).

    Back-compat: `watch KEY TIMEOUT_MS` = one bounded wait, then exit
    (prints `timeout` if nothing changed) — the r1/r2 behavior.
    """
    args = list(args)
    oneshot = "--oneshot" in args
    if oneshot:
        args.remove("--oneshot")
    if not args:
        raise CliError("usage: watch KEY|@GROUP [TIMEOUT_MS] [--oneshot]")
    timeout = int(args[1]) if len(args) > 1 else None
    if timeout is not None:
        oneshot = True
    # continuous loop: short waits so the Ctrl-]/EOF abort check runs;
    # oneshot with no TIMEOUT_MS: block indefinitely for the first event
    bounded = timeout if timeout is not None else (-1 if oneshot else 100)

    import contextlib
    import select

    @contextlib.contextmanager
    def raw_stdin():
        """Raw terminal so Ctrl-] arrives unbuffered; restored on exit.
        Non-tty stdin (pipe) needs no mode change — select + read works
        as-is and EOF doubles as the abort signal."""
        fd = None
        try:
            if sys.stdin.isatty():
                import termios
                import tty
                fd = sys.stdin.fileno()
                saved = termios.tcgetattr(fd)
                tty.setcbreak(fd)
            yield
        finally:
            if fd is not None:
                termios.tcsetattr(fd, termios.TCSADRAIN, saved)

    def abort_requested() -> bool:
        try:
            r, _, _ = select.select([sys.stdin], [], [], 0)
        except (OSError, ValueError):
            return False
        if not r:
            return False
        data = os.read(sys.stdin.fileno(), 1)
        return data in (b"\x1d", b"")        # Ctrl-] or EOF

    if not oneshot:
        print("watching — press Ctrl-] to stop", file=sys.stderr)

    got_event = False
    with raw_stdin():
        if args[0].startswith("@"):
            g = int(args[0][1:])
            last = ses.store.signal_count(g)
            while True:
                # stdin abort applies to the continuous loop only: a
                # backgrounded oneshot (stdin /dev/null or exhausted)
                # must honor its bounded wait, not exit instantly on EOF
                if not oneshot and abort_requested():
                    break
                got = ses.store.signal_wait(g, last, bounded)
                if got is not None:
                    print(f"group {g} pulsed (total {got})", flush=True)
                    last = got
                    got_event = True
                    if oneshot:
                        break
                elif oneshot:
                    break
        else:
            # track the last-reported epoch across iterations: a write
            # landing between two poll() calls (each snapshots its own
            # baseline) must still be reported, not missed
            key = ses.key(args[0])
            e_last = ses.store.epoch_at(ses.store.find_index(key))

            def report() -> bool:
                """Print the value if the epoch moved; True on print."""
                nonlocal e_last, got_event
                try:
                    # re-resolve the slot every time: unset + re-create
                    # can move the key, and a pinned index would read a
                    # stale (or recycled) slot's epoch forever
                    idx = ses.store.find_index(key)
                    e = ses.store.epoch_at(idx)
                    if e == e_last or (e & 1):
                        return False
                    # exact bytes, no trimming: the size:value framing
                    # must match value_len for piped consumers, and
                    # binary values may legitimately end in NULs
                    val = ses.store.get(key)
                except KeyError:
                    return False              # vanished: caller decides
                e_last = e
                sys.stdout.buffer.write(
                    f"{len(val)}:".encode() + val + b"\n")
                sys.stdout.flush()
                got_event = True
                return True

            vanished_at = None            # when the key went missing
            while True:
                if not oneshot and abort_requested():
                    break
                if report():
                    vanished_at = None
                    if oneshot:
                        break
                    continue
                try:
                    changed = ses.store.poll(key, bounded)
                    vanished_at = None
                except KeyError:
                    # key unset mid-watch — but unset + re-create is a
                    # legitimate transition (the new slot may be
                    # elsewhere; report() re-resolves), and a poll
                    # racing that tiny gap must not silently end a
                    # continuous watch.  Linger one grace interval;
                    # only a key that STAYS gone ends the loop.
                    now = time.monotonic()
                    if vanished_at is None:
                        vanished_at = now
                    if now - vanished_at > 0.25:
                        break             # really deleted: watch over
                    time.sleep(0.01)
                    continue
                if not changed and oneshot:
                    # a write in the window between report()'s epoch
                    # read and poll()'s baseline snapshot would be
                    # invisible to both — one final re-check
                    report()
                    break
    if oneshot and not got_event:
        print("timeout")


@command("retrain", "retrain KEY",
         "backward-epoch recovery of a stuck slot (scrubs its vector)")
def cmd_retrain(ses, args):
    if not args:
        raise CliError("usage: retrain KEY")
    ses.store.retrain(ses.key(args[0]))


@command("config", "config [mop N | user N | purge]",
         "store-level config and maintenance")
def cmd_config(ses, args):
    st = ses.store
    if not args:
        h = st.header()
        print(f"store        {ses.store_name}")
        print(f"geometry     {h.nslots} slots x {h.max_val}B, "
              f"vec {h.vec_dim}d, map {h.map_size}B")
        print(f"used         {h.used_slots}")
        print(f"epoch        {h.global_epoch}")
        print(f"mop          {h.mop_mode}")
        print(f"user flags   {h.user_flags:#x}")
        print(f"bus owner    {h.bus_pid or '-'}")
        print(f"parse fails  {h.parse_failures}")
    elif args[0] == "mop":
        st.set_mop(int(args[1]))
    elif args[0] == "user":
        st.config_set_user(int(args[1], 0))
    elif args[0] == "purge":
        print(f"swept {st.purge()} slots")
    else:
        raise CliError("usage: config [mop N | user N | purge]")


@command("caps", "caps", "print build capabilities")
def cmd_caps(ses, args):
    print(f"build          {N.build_id()}")
    print(f"store format   v{N.get_lib() and 1}")
    print(f"key max        {N.KEY_MAX}")
    print(f"signal groups  {N.SIGNAL_GROUPS}")
    print(f"bid slots      {N.MAX_BIDS}")
    print("backends       shm, file (runtime flag)")
    try:
        import torch
        where = (f"cuda: {torch.cuda.get_device_name(0)}"
                 if torch.cuda.is_available() else "cpu")
        print(f"torch          {torch.__version__} [{where}]")
    except Exception:
        print("torch          unavailable")


@command("health", "health", "daemon liveness + store vitals")
def cmd_health(ses, args):
    """Operator one-look: daemon heartbeat ages (__embedder_stats /
    __completer_stats, engine/protocol.publish_heartbeat), live shard
    bids, active signal groups, store occupancy.  The reference's
    nearest analog is eyeballing the sidecar TUI + `head __debug`."""
    st = ses.store
    h = st.header()
    print(f"store          {h.used_slots}/{st.nslots} slots, "
          f"global epoch {h.global_epoch}")
    # heartbeat keys are daemon-owned well-known names: NOT namespaced
    # (the daemons write the literal protocol constants); scaled
    # lanes add replica-suffixed keys, discovered per protocol
    lanes_hb = (("embedder", P.KEY_EMBED_STATS),
                ("completer", P.KEY_COMPLETE_STATS),
                ("searcher", P.KEY_SEARCH_STATS),
                ("pipeliner", P.KEY_SCRIPT_STATS))
    disc = P.replica_heartbeat_map(st, [k for _, k in lanes_hb])
    rows = []
    for label, key in lanes_hb:
        for r, rkey in disc[key]:
            rows.append((label if r == 0 else f"{label}.r{r}", rkey))
    rows.append(("autoscaler", P.KEY_AUTOSCALER_STATS))
    rows.append(("supervisor", P.KEY_SUPERVISOR_STATS))
    for label, key in rows:
        try:
            raw = st.get(key)
        except KeyError:
            print(f"{label:<14} no heartbeat (daemon not attached?)")
            continue
        except OSError:               # sustained writer contention
            print(f"{label:<14} heartbeat unreadable (contended)")
            continue
        try:
            snap = json.loads(raw.rstrip(b"\0"))
            age = time.time() - snap.pop("ts", 0)
            pid = snap.pop("pid", None)
            dead = (isinstance(pid, int)
                    and not P.pid_alive(pid))
            spans = snap.pop("spans", None)
            lanes = snap.pop("lanes", None)   # supervisor sections
            vitals = ", ".join(
                f"{k}={v}" for k, v in snap.items()
                if not isinstance(v, (dict, list)))
            stale = ("  [DEAD pid]" if dead
                     else "  [STALE]" if age > 30 else "")
            print(f"{label:<14} {age:5.1f}s ago{stale}  {vitals}")
            if spans:
                for name, s in spans.items():
                    print(f"    {name:<18} n={s['n']} "
                          f"total={s['total_ms']}ms max={s['max_ms']}ms")
            if lanes:
                for name, ln in lanes.items():
                    if not isinstance(ln, dict):
                        continue
                    if "state" not in ln:     # autoscaler decision
                        print(f"    {name:<11} target_r="   # rows
                              f"{ln.get('target')} "
                              f"pressure={ln.get('pressure')} "
                              f"({ln.get('reason')})")
                        continue
                    extra = (f" r={ln['r']}" if ln.get("r", 1) > 1
                             else "")
                    print(f"    {name:<11} {ln.get('state', '?'):<9}"
                          f" pid={ln.get('pid')} "
                          f"gen={ln.get('generation')} "
                          f"restarts={ln.get('restarts')} "
                          f"breaker_opens={ln.get('breaker_opens')}"
                          f"{extra}")
        except (ValueError, AttributeError, TypeError, KeyError):
            print(f"{label:<14} unparseable heartbeat")
    live_bids = [b for b in st.bid_table() if b.pid and b.live]
    if live_bids:
        for b in live_bids:
            print(f"bid            shard {b.shard_id:#x} pid {b.pid} "
                  f"prio {b.priority} intent {b.intent}")
    else:
        print("bid            none (or expired)")
    active = [(g, st.signal_count(g)) for g in range(N.SIGNAL_GROUPS)]
    active = [(g, c) for g, c in active if c]
    shown = ", ".join(f"g{g}={c}" for g, c in active[:12])
    more = f", +{len(active) - 12} more" if len(active) > 12 else ""
    print("signals        " + (shown + more if active else "quiet"))


@command("uuid", "uuid [KEY]", "generate a uuid (optionally store it)")
def cmd_uuid(ses, args):
    u = str(uuidlib.uuid4())
    if args:
        ses.store.set(ses.key(args[0]), u)
    print(u)


@command("clear", "clear", "clear the terminal")
def cmd_clear(ses, args):
    sys.stdout.write("\x1b[2J\x1b[H")


@command("use", "use STORE_NAME", "switch to another store")
def cmd_use(ses, args):
    if not args:
        raise CliError("usage: use STORE_NAME")
    ses.close()
    ses.store_name = args[0]
    print(f"using {args[0]}")


@command("shard", "shard table|who|claim ID PRIO|rebid IDX|release IDX|"
         "advise IDX ADVICE", "cooperative shard bid operations")
def cmd_shard(ses, args):
    st = ses.store
    sub = args[0] if args else "table"
    if sub == "table":
        print(" idx pid      shard        intent prio claimed_at   live")
        for b in st.bid_table():
            if b.pid == 0:
                continue
            print(f" {b.index:3d} {b.pid:<8d} {b.shard_id:#012x} "
                  f"{b.intent:6d} {b.priority:4d} {b.claimed_at:<12d} "
                  f"{'yes' if b.live else 'no'}")
    elif sub == "who":
        w = st.shard_election()
        if w is None:
            print("no sovereign (no live bids)")
        else:
            b = st.bid_info(w)
            print(f"sovereign: bid {w} pid {b.pid} "
                  f"shard {b.shard_id:#x} prio {b.priority}")
    elif sub == "claim":
        if len(args) < 3:
            raise CliError("usage: shard claim ID PRIO [ADVICE] [DUR_US]")
        adv = ADVICE_NAMES.get(args[3].lower(), N.ADV_WILLNEED) \
            if len(args) > 3 else N.ADV_WILLNEED
        dur = int(args[4]) if len(args) > 4 else 30_000_000
        idx = st.shard_claim(int(args[1], 0), adv, int(args[2]), dur)
        print(f"bid {idx}")
    elif sub == "rebid":
        st.shard_rebid(int(args[1]))
    elif sub == "release":
        st.shard_release(int(args[1]))
    elif sub == "advise":
        adv = ADVICE_NAMES.get(args[2].lower())
        if adv is None:
            raise CliError(f"unknown advice {args[2]}")
        ok = st.madvise(int(args[1]), adv, timeout_ms=0)
        print("advised" if ok else "deferred (not sovereign)")
    else:
        raise CliError("usage: shard table|who|claim|rebid|release|advise")


@command("hist", "hist", "show REPL history")
def cmd_hist(ses, args):
    path = os.environ.get("SPTPU_HISTORY",
                          str(Path.home() / ".sptpu_history"))
    if Path(path).exists():
        sys.stdout.write(Path(path).read_text())


@command("bind", "bind BLOOM_BIT GROUP [--remove]",
         "bind a bloom label bit to a signal group")
def cmd_bind(ses, args):
    if len(args) < 2:
        raise CliError("usage: bind BLOOM_BIT GROUP [--remove]")
    bit, group = int(args[0]), int(args[1])
    if "--remove" in args:
        ses.store.watch_label_unregister(bit, group)
    else:
        ses.store.watch_label_register(bit, group)


@command("help", "help [COMMAND]", "this help")
def cmd_help(ses, args):
    if args and args[0] in COMMANDS:
        fn, usage, help_ = COMMANDS[args[0]]
        print(f"{usage}\n  {help_}")
    else:
        width = max(len(u) for _, u, _ in COMMANDS.values())
        for name in sorted(COMMANDS):
            _, usage, help_ = COMMANDS[name]
            print(f"  {usage:<{width}}  {help_}")


# search / ingest / export / scripting / obs hosts live in their own
# modules
from .search import cmd_search  # noqa: E402  (registers itself)
from .ingest import cmd_ingest, cmd_export  # noqa: E402
from .script import cmd_lua, cmd_wasm  # noqa: E402
from .metrics import cmd_metrics, cmd_trace  # noqa: E402
from .top import cmd_top  # noqa: E402
from .supervise import cmd_supervise  # noqa: E402
from .loadgen import cmd_loadgen  # noqa: E402
from .lint import cmd_lint  # noqa: E402
from .pipeline import cmd_pipeline  # noqa: E402
from .scale import cmd_scale  # noqa: E402


# ------------------------------------------------------------------- REPL

def repl(ses: Session) -> int:
    try:
        import readline
        hist = os.environ.get("SPTPU_HISTORY",
                              str(Path.home() / ".sptpu_history"))
        try:
            readline.read_history_file(hist)
        except OSError:
            pass
        readline.set_completer(_completer)
        readline.parse_and_bind("tab: complete")
    except ImportError:
        readline = None
        hist = None
    print(f"splinter-tpu CLI — store {ses.store_name} "
          f"(type 'help', ctrl-d to exit)")
    while True:
        try:
            line = input("sptpu> ")
        except EOFError:
            print()
            break
        except KeyboardInterrupt:
            print()
            continue
        line = line.strip()
        if not line:
            continue
        if line in ("exit", "quit"):
            break
        try:
            dispatch(ses, shlex.split(line))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:   # a bad command must never kill the REPL
            print(f"error: {e}", file=sys.stderr)
    if readline and hist:
        try:
            readline.write_history_file(hist)
        except OSError:
            pass
    return 0


def _completer(text, state):
    matches = [c for c in COMMANDS if c.startswith(text)]
    return matches[state] if state < len(matches) else None


def dispatch(ses: Session, argv: list[str]) -> None:
    if not argv:
        return
    name, args = argv[0], argv[1:]
    if name not in COMMANDS:
        raise CliError(f"unknown command {name!r} (try 'help')")
    COMMANDS[name][0](ses, args)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    store_name = None
    persistent = False
    while argv and argv[0].startswith("--"):
        if argv[0] == "--store" and len(argv) > 1:
            store_name = argv[1]
            argv = argv[2:]
        elif argv[0] == "--persistent":
            persistent = True
            argv = argv[1:]
        elif argv[0] == "--help":
            print(__doc__)
            cmd_help(None, [])
            return 0
        else:
            print(f"unknown flag {argv[0]}", file=sys.stderr)
            return 2
    ses = Session(store_name, persistent)
    try:
        if argv:
            try:
                dispatch(ses, argv)
                return 0
            except BrokenPipeError:
                # downstream pager/head closed; exit quietly like cat(1)
                try:
                    sys.stdout.close()
                except OSError:
                    pass
                return 0
            except (CliError, KeyError, OSError, ValueError,
                    IndexError) as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        return repl(ses)
    finally:
        ses.close()


if __name__ == "__main__":
    raise SystemExit(main())
