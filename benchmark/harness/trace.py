"""The traced run's device profile and host spans.

torch.profiler records host ops only on the thread that started it, so
the profile starts and stops inside the daemon's own thread: `Window`
wraps the daemon's drain and, at the first drain after p0, starts the
profiler; at the first drain after p1 it stops it.  Device activity is
recorded for the whole process either way.

The trace is read raw (kineto_results.events()): building the
profiler's Python event tree over a run's events takes seconds to
minutes.  Busy time is the union of device intervals inside the
window; each idle gap is charged to the innermost host op or benchmark
span open at the gap's midpoint on the daemon's thread.
"""
from __future__ import annotations

import functools
import time

import numpy as np

NO_OP = "host: no recorded op"
NAME_MAX = 160
GAPS_NAMED = 4000          # longest gaps named one by one; the rest pooled


def annotate(obj, names: dict[str, str]) -> None:
    """Wrap obj.<attr> in a record_function span "bench:<label>" for
    each attr -> label, on this instance only."""
    from torch.profiler import record_function

    for attr, label in names.items():
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _label=f"bench:{label}", **kw):
            with record_function(_label):
                return _fn(*a, **kw)

        setattr(obj, attr, wrapped)


def _profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_profiler() -> None:
    """Start and stop a profiler once, off the window: the first start
    initialises the tracer, which takes seconds."""
    prof = _profiler()
    prof.start()
    prof.stop()


class Window:
    """Profile the daemon's own thread for the middle half of the
    measured window: from its first tick at or after t0 + seconds / 4,
    for seconds / 2.  The wrapped call (the daemon loop's wait for a
    wake, at least every idle timeout) ticks; start and stop both happen
    on the daemon's thread, which a profiler needs.  `on_edge(which)`
    runs there at the start (0) and the stop (1)."""

    def __init__(self, seconds: float, on_edge=None):
        self.seconds = seconds
        self.on_edge = on_edge
        self.p0 = float("inf")
        self.prof = None
        self.wall_ns = [0, 0]
        self.mono = [0.0, 0.0]
        self.done = False

    def arm(self, t0: float) -> None:
        self.p0 = t0 + 0.25 * self.seconds

    def wrap(self, obj, attr: str) -> None:
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            self._tick()
            return fn(*a, **kw)

        setattr(obj, attr, wrapped)

    def _tick(self) -> None:
        if self.done:
            return
        now = time.monotonic()
        if self.prof is None and now >= self.p0:
            self.prof = _profiler()
            self.prof.start()
            self.wall_ns[0], self.mono[0] = time.time_ns(), time.monotonic()
            if self.on_edge:
                self.on_edge(0)
        elif self.prof is not None \
                and now >= self.mono[0] + 0.5 * self.seconds:
            import torch

            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.wall_ns[1], self.mono[1] = time.time_ns(), time.monotonic()
            if self.on_edge:
                self.on_edge(1)
            self.prof.stop()
            self.done = True

    def wait(self, timeout_s: float = 120.0) -> None:
        """Block until the daemon's thread has stopped the profile."""
        deadline = time.monotonic() + timeout_s
        while not self.done and time.monotonic() < deadline:
            time.sleep(0.05)

    def summary(self) -> dict | None:
        if not self.done:
            return None
        return read_events(self.prof.profiler.kineto_results.events(),
                           *self.wall_ns)


def _union(starts: np.ndarray, ends: np.ndarray):
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    seg_s, seg_e = [], []
    for a, b in zip(s.tolist(), e.tolist()):
        if seg_e and a <= seg_e[-1]:
            seg_e[-1] = max(seg_e[-1], b)
        else:
            seg_s.append(a)
            seg_e.append(b)
    return np.asarray(seg_s, np.int64), np.asarray(seg_e, np.int64)


def read_events(events, w0: int, w1: int) -> dict:
    """busy_s, window_s, the device ops that took most time and the idle
    time by what the host was doing, from raw kineto events whose times
    are wall-clock ns; [w0, w1] is the profiled window."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev_s, dev_e, by_name = [], [], {}
    host = []
    for evt in events:
        a, d = evt.start_ns(), evt.duration_ns()
        if evt.is_user_annotation() or evt.name().startswith("bench:"):
            if evt.device_type() == cuda:
                continue          # a host span's mirror on the device row
            host.append((a, a + d, evt.name()[:NAME_MAX]))
            continue
        if evt.device_type() == cuda:
            lo, hi = max(a, w0), min(a + d, w1)
            if hi <= lo:
                continue
            dev_s.append(lo)
            dev_e.append(hi)
            name = evt.name()[:NAME_MAX]
            by_name[name] = by_name.get(name, 0) + (hi - lo)
        elif d > 0:
            host.append((a, a + d, evt.name()[:NAME_MAX]))
    window_s = (w1 - w0) / 1e9
    if dev_s:
        seg_s, seg_e = _union(np.asarray(dev_s), np.asarray(dev_e))
    else:
        seg_s = seg_e = np.zeros(0, np.int64)
    busy_s = float((seg_e - seg_s).sum()) / 1e9
    gap_s = np.concatenate([[w0], seg_e])
    gap_e = np.concatenate([seg_s, [w1]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    idle = _name_gaps(gap_s, gap_e, host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": idle,
            "device_by_name_s": {n: ns / 1e9 for n, ns in by_name.items()}}


def _name_gaps(gap_s, gap_e, host) -> list:
    """Idle seconds by the innermost host op open at each gap's midpoint,
    the 10 largest sums."""
    by: dict[str, int] = {}
    if gap_s.size == 0:
        return []
    hs = np.asarray([h[0] for h in host], np.int64)
    he = np.asarray([h[1] for h in host], np.int64)
    names = [h[2] for h in host]
    length = gap_e - gap_s
    order = np.argsort(-length)
    for j, g in enumerate(order.tolist()):
        if j >= GAPS_NAMED:
            by["shorter gaps, unnamed"] = by.get("shorter gaps, unnamed", 0) \
                + int(length[g])
            continue
        mid = (gap_s[g] + gap_e[g]) // 2
        name = NO_OP
        if hs.size:
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            if cover.size:
                name = names[int(cover[np.argmin(he[cover] - hs[cover])])]
        by[name] = by.get(name, 0) + int(length[g])
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return [[n, ns / 1e9] for n, ns in top]
