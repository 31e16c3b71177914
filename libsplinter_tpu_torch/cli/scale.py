"""`spt scale` — the elastic-lane operator surface.

`scale status` renders the whole control loop from plain store
reads: the supervisor-published policy (`__scale_policy` — per-lane
min:max bounds + controller knobs), the live desired counts
(the per-lane `__scale_tgt_<lane>` keys, with their source: auto
vs manual hold), the
supervisor's ACTIVE replica sets (its heartbeat's per-lane `r`), and
the autoscaler's recent decisions + per-lane pressure/reason (its
`__autoscaler_stats` heartbeat) — the flapping / stuck-scale-down
triage read (docs/operations.md "Elastic lanes").

`scale set LANE=N` writes a MANUAL target: the supervisor applies it
on its next poll and the autoscaler holds off that lane until
`scale set LANE=auto` hands it back.
"""
from __future__ import annotations

import time

from ..engine import protocol as P
from .main import CliError, command


def _status(ses) -> None:
    st = ses.store
    from .metrics import _read_json

    policy = P.read_scale_policy(st)
    targets = P.read_scale_targets(st)
    sup = _read_json(st, P.KEY_SUPERVISOR_STATS)
    ctl = _read_json(st, P.KEY_AUTOSCALER_STATS)
    if policy is None and not targets and ctl is None:
        print("no scaling policy (start one: `spt supervise --scale "
              "LANE=MIN:MAX ...`; manual targets: `spt scale set "
              "LANE=N`)")
        return
    knobs = []
    if policy:
        for k in ("interval_s", "up_threshold", "down_threshold",
                  "cooldown_s"):
            if policy.get(k) is not None:
                knobs.append(f"{k}={policy[k]}")
    print("scale policy   " + (" ".join(knobs) if knobs
                               else "controller defaults"))
    lanes = sorted(set((policy or {}).get("lanes", {}))
                   | set(targets)
                   | set((ctl or {}).get("lanes") or {}))
    sup_lanes = (sup or {}).get("lanes") or {}
    print(f"{'lane':<11} {'bounds':>7} {'live r':>6} {'target':>6} "
          f"{'src':>6}  pressure/reason")
    for lane in lanes:
        b = (policy or {}).get("lanes", {}).get(lane)
        bounds = f"{b['min']}:{b['max']}" if isinstance(b, dict) \
            else "—"
        live = sup_lanes.get(lane, {}).get("r", "—") \
            if isinstance(sup_lanes.get(lane), dict) else "—"
        tgt = targets.get(lane) or {}
        crow = ((ctl or {}).get("lanes") or {}).get(lane) or {}
        why = ""
        if crow:
            why = (f"{crow.get('pressure', 0)} "
                   f"({crow.get('reason', '')})")
        print(f"{lane:<11} {bounds:>7} {live!s:>6} "
              f"{tgt.get('r', '—')!s:>6} "
              f"{tgt.get('src', '—')!s:>6}  {why}")
    if ctl is not None:
        hist = ctl.get("history") or []
        if hist:
            print("recent decisions (newest last):")
            for row in hist[-8:]:
                try:
                    ts, lane, frm, to, reason = row
                    ago = time.time() - float(ts)
                    print(f"  {ago:6.1f}s ago  {lane:<10} "
                          f"{frm}->{to}  {reason}")
                except (ValueError, TypeError):
                    continue
        age = time.time() - float(ctl.get("ts", 0.0))
        print(f"autoscaler     heartbeat {age:.1f}s ago, "
              f"ticks={ctl.get('ticks')} ups={ctl.get('scale_ups')} "
              f"downs={ctl.get('scale_downs')} "
              f"holds={ctl.get('holds')}")
    else:
        print("autoscaler     not running (spt supervise --scale "
              "... arms it; manual targets still apply)")


def _set(ses, specs: list[str]) -> None:
    if not specs:
        raise CliError("usage: scale set LANE=N|auto [LANE=N ...]")
    from ..engine.supervisor import LANES

    st = ses.store
    for spec in specs:
        lane, sep, val = spec.partition("=")
        lane, val = lane.strip(), val.strip()
        if not sep or not lane or not val:
            raise CliError(f"scale set wants LANE=N|auto, got "
                           f"{spec!r}")
        if lane not in LANES:
            raise CliError(f"unknown lane {lane!r} "
                           f"(supervisable: {sorted(LANES)})")
        if val == "auto":
            P.write_scale_target(st, lane, None)
            print(f"{lane}: manual hold cleared (autoscaler may "
                  "drive it again)")
            continue
        try:
            r = int(val)
        except ValueError:
            raise CliError(f"scale set wants LANE=N|auto, got "
                           f"{spec!r}") from None
        cap = LANES[lane].max_replicas
        if not 1 <= r <= cap:
            raise CliError(f"{lane}: replicas must be 1..{cap}")
        P.write_scale_target(st, lane, r, src="manual")
        print(f"{lane}: manual target r={r} (supervisor applies on "
              "its next poll; autoscaler holds off until "
              f"`scale set {lane}=auto`)")


@command("scale", "scale status | set LANE=N|auto [LANE=N ...]",
         "elastic lanes: show scaling policy/targets/decisions, or "
         "set a manual replica-count override")
def cmd_scale(ses, args):
    if not args or args[0] == "status":
        return _status(ses)
    if args[0] == "set":
        return _set(ses, args[1:])
    raise CliError("usage: scale status | set LANE=N|auto")
