"""What every cell's run shares: the generator processes, the daemon's
thread, the measured window, the raw samples, and the result line."""
from __future__ import annotations

import dataclasses
import json
import math
import multiprocessing
import sys
import threading
import time

import numpy as np

from . import gen, stats
from .guard import FORBIDDEN, forbidden_modules

READY_TIMEOUT_S = 300.0


class Generators:
    """The client processes of a traffic mix (spawned: each starts from a
    fresh interpreter that imports numpy and the store client only)."""

    def __init__(self, traffic: dict, store_path: str, seed: int):
        ctx = multiprocessing.get_context("spawn")
        n = traffic["generators"]
        self.procs, self.conns = [], []
        for g in range(n):
            mine, theirs = ctx.Pipe()
            clients = list(range(g, traffic["clients"], n))
            p = ctx.Process(target=gen.client_main,
                            args=(theirs, store_path, traffic, seed, clients),
                            daemon=True)
            p.start()
            theirs.close()
            self.procs.append(p)
            self.conns.append(mine)

    def wait_ready(self) -> None:
        for c in self.conns:
            if not c.poll(READY_TIMEOUT_S):
                raise RuntimeError("a generator did not get ready")
            c.recv()

    def start(self, t0: float, t1: float) -> None:
        for c in self.conns:
            c.send(("start", t0, t1))

    def collect(self, timeout_s: float):
        recs, gstats, bad = [], [], []
        for c in self.conns:
            if not c.poll(timeout_s):
                raise RuntimeError("a generator did not report")
            _, r, s, forbidden = c.recv()
            recs.extend(r)
            gstats.append(s)
            bad.extend(forbidden)
        return recs, gstats, sorted(set(bad))

    def close(self) -> None:
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        # spawning started multiprocessing's resource tracker: stop and reap
        # it here, or it outlives the run as an orphan
        from multiprocessing import resource_tracker

        resource_tracker._resource_tracker._stop()


class Daemon:
    """The port's daemon loop (`run`) on a thread of this process."""

    def __init__(self, daemon):
        self.daemon = daemon
        self.error: BaseException | None = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            self.daemon.run(idle_timeout_ms=100)
        except BaseException as ex:           # reported by stop()
            self.error = ex

    def start(self):
        self.thread.start()

    def stop(self):
        self.daemon.stop()
        self.thread.join(timeout=120)
        if self.thread.is_alive():
            raise RuntimeError("the daemon's loop did not stop")
        if self.error is not None:
            raise RuntimeError("the daemon's loop failed") from self.error


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    records: list              # (client, n, slot, t_due, payload, t_done, result)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def issued(self) -> list:
        return [r for r in self.records if self.t0 <= r[3] < self.t1]

    def done_in(self, a: float, b: float) -> list:
        return [r for r in self.records
                if not math.isnan(r[5]) and a <= r[5] < b]


class Context:
    """What a per-layer metric's reader may read, all of the profiled
    sub-window: its length `sub_s`, the daemon's counters at its edges
    (`edges[0]`, `edges[1]`), the requests `done` in it, the `profile`
    read from its trace, and what a driver adds."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @classmethod
    def of(cls, cell, prof, profile, edges, recs, **kw):
        if not (prof.done and len(edges) == 2):
            return cls(cell=cell, profile=None, edges={}, sub_s=0.0,
                       done=[], **kw)
        a, b = prof.mono
        return cls(cell=cell, profile=profile, edges=edges, sub_s=b - a,
                   done=[r for r in Window(a, b, recs).done_in(a, b)
                         if r[6] is not None], **kw)


def read_per_layer(cell: Cell, ctx) -> dict:
    from .spec import metric_reader

    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def latencies_ms(recs: list, ok) -> np.ndarray:
    """Due-to-seen latency of each request; inf where it failed."""
    return np.asarray([(r[5] - r[3]) * 1e3 if ok(r) else math.inf
                       for r in recs], np.float64)


def summary_line(what: str, lat_ms: np.ndarray, window_s: float,
                 done: int) -> str:
    finite = lat_ms[np.isfinite(lat_ms)]
    med = float(np.median(finite)) if finite.size else math.inf
    return (f"{what}: attempted {lat_ms.size}, completed in the window "
            f"{done} ({done / window_s:.4f}/s), failed "
            f"{int((~np.isfinite(lat_ms)).sum())}, latency median "
            f"{med:.4f} ms, p90 {stats.percentile(lat_ms, 90):.4f} ms, p95 "
            f"{stats.percentile(lat_ms, 95):.4f} ms, p99 "
            f"{stats.percentile(lat_ms, 99):.4f} ms, max "
            f"{float(lat_ms.max()) if lat_ms.size else math.nan:.4f} ms")


def finish(*, cell, checks: dict, attempted: int, failed: int,
           metrics: dict, device: dict, breakdown: dict | None,
           gen_bad: list) -> int:
    """Print the checks on stderr and the result as stdout's last line;
    the exit code.  A module of JAX or the JAX package in this process or
    a generator fails the run with no result."""
    bad = sorted(set(forbidden_modules()) | set(gen_bad))
    if bad:
        print(f"import guard: {bad} loaded; no result", file=sys.stderr)
        return 3
    print(f"import guard: none of {sorted(FORBIDDEN)} loaded in this "
          f"process or its generators")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


def flush_to_disk(path: str) -> None:
    """Write the store file's dirty pages out now, in set-up: left to the
    kernel's writeback they land inside the measured window."""
    import os

    t = time.monotonic()
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    print(f"store file flushed in {time.monotonic() - t:.3f} s")


def device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def counters(obj) -> dict:
    return dataclasses.asdict(obj.stats)


def sample_rows(rng: np.random.Generator, n: int, want: int) -> np.ndarray:
    return np.sort(rng.choice(n, size=min(n, want), replace=False))
