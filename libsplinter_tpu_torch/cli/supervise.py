"""CLI `supervise` — run the daemon lanes under the supervisor.

`spt supervise` is the one-command serving bring-up: each requested
lane (embedder / completer / searcher) starts as a child process and
stays up — crashes restart with jittered exponential backoff, crash
loops trip a circuit breaker that marks the lane down in the
supervisor heartbeat (so `search` clients fall back to client-side
scoring instantly instead of burning their timeout), and everything
is observable via `spt metrics` / `spt health`.

See docs/operations.md for the runbook (fault-point catalog, breaker
semantics, what a crashed lane looks like in the metrics).
"""
from __future__ import annotations

from .main import CliError, command


@command("supervise",
         "supervise [--lanes L1,L2] [--breaker-threshold N] "
         "[--breaker-window-s S] [--breaker-cooldown-s S] "
         "[--backoff-base-ms MS] [--heartbeat-timeout-s S] "
         "[--poll-interval-s S] [--stop-after S] [--keep-faults] "
         "[--scale LANE=MIN:MAX]... [--scale-interval-s S] "
         "[--scale-up-threshold Q] [--scale-down-threshold Q] "
         "[--scale-cooldown-s S] [--drain-deadline-s S] "
         "[--lane-args LANE:ARGS...]",
         "supervise the daemon lanes as child processes (restart on "
         "crash with backoff; circuit breaker marks crash-looping "
         "lanes down; --scale arms striped replica sets + the "
         "autoscaler lane)")
def cmd_supervise(ses, args):
    import shlex

    from ..engine.supervisor import LANES, Supervisor, arm_scale

    lanes_csv = "embedder,completer,searcher"
    # only user-set options are forwarded: Supervisor.__init__ (and
    # Supervisor.run) stay the single source of truth for defaults
    sup_kw: dict = {}
    run_kw: dict = {}
    lane_args: dict[str, list[str]] = {}
    scale_specs: list[str] = []
    scale_knobs: dict = {}
    it = iter(args)

    def arg_of(flag):
        try:
            return next(it)
        except StopIteration:
            raise CliError(f"{flag} requires a value") from None

    sup_flags = {"--backoff-base-ms": ("backoff_base_ms", float),
                 "--backoff-max-ms": ("backoff_max_ms", float),
                 "--breaker-threshold": ("breaker_threshold", int),
                 "--breaker-window-s": ("breaker_window_s", float),
                 "--breaker-cooldown-s": ("breaker_cooldown_s", float),
                 "--heartbeat-timeout-s": ("heartbeat_timeout_s",
                                           float),
                 "--startup-grace-s": ("startup_grace_s", float),
                 "--drain-deadline-s": ("drain_deadline_s", float)}
    knob_flags = {"--scale-interval-s": "interval_s",
                  "--scale-up-threshold": "up_threshold",
                  "--scale-down-threshold": "down_threshold",
                  "--scale-cooldown-s": "cooldown_s"}
    for a in it:
        if a == "--lanes":
            lanes_csv = arg_of(a)
        elif a in sup_flags:
            name, conv = sup_flags[a]
            sup_kw[name] = conv(arg_of(a))
        elif a == "--scale":
            scale_specs.append(arg_of(a))
        elif a in knob_flags:
            try:
                scale_knobs[knob_flags[a]] = float(arg_of(a))
            except ValueError:
                raise CliError(f"{a} wants a number") from None
        elif a == "--poll-interval-s":
            run_kw["poll_interval_s"] = float(arg_of(a))
        elif a == "--stop-after":
            run_kw["stop_after"] = float(arg_of(a))
        elif a == "--keep-faults":
            sup_kw["keep_faults"] = True
        elif a == "--lane-args":
            spec = arg_of(a)
            lane, sep, rest = spec.partition(":")
            if not sep or lane not in LANES:
                raise CliError(
                    f"--lane-args wants LANE:ARGS with LANE one of "
                    f"{sorted(LANES)}, got {spec!r}")
            lane_args[lane] = shlex.split(rest)
        else:
            raise CliError(f"unknown flag {a!r} (see `help supervise`)")

    lanes = [ln.strip() for ln in lanes_csv.split(",") if ln.strip()]
    bad = [ln for ln in lanes if ln not in LANES]
    if bad:
        raise CliError(f"unknown lanes {bad} "
                       f"(supervisable: {sorted(LANES)})")
    if scale_specs:
        try:
            # shared plumbing (engine/supervisor.arm_scale): parse
            # bounds, auto-arm telemetry+autoscaler, forward the
            # controller knobs to the autoscaler child's argv
            sup_kw["scale"] = arm_scale(lanes, scale_specs,
                                        scale_knobs, lane_args)
        except ValueError as ex:
            raise CliError(str(ex)) from None
        sup_kw["scale_knobs"] = scale_knobs
    elif scale_knobs:
        raise CliError("--scale-* knobs need at least one --scale "
                       "LANE=MIN:MAX bound")
    lanes = tuple(lanes)
    ses.store                 # fail fast if the store doesn't exist
    sup = Supervisor(
        ses.store_name, lanes=lanes, persistent=ses.persistent,
        lane_args=lane_args, **sup_kw)
    scaled = ""
    if scale_specs:
        scaled = " (elastic: " + ", ".join(
            f"{ln}={lo}:{hi}"
            for ln, (lo, hi) in sup.scale.items()) + ")"
    print(f"supervising {', '.join(lanes)} over {ses.store_name}"
          f"{scaled} (ctrl-c stops children cleanly)")
    try:
        sup.run(**run_kw)
    except KeyboardInterrupt:
        sup.shutdown()
