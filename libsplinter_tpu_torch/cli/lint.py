"""`spt lint` — splint for the port (`libsplinter_tpu_torch/analysis/`).

Runs the registry-sync (SPL1xx) and torch dispatch-hazard (SPL2xx)
rule families over `libsplinter_tpu_torch/` and reports
`file:line · RULE_ID · message`.  Exit 1 on any unsuppressed,
unbaselined finding.  The flags are the JAX package's command's:
`--rules`, `--no-baseline`, `--write-baseline` (refused under a rule
filter) and `--root`.

The analysis layer is stdlib-only (`ast`): no store is opened, no
torch is imported; `lint` is safe on a box with daemons holding the
card.  The JAX package's sources stay with its own splint
(`python -m libsplinter_tpu.cli lint`, `make lint-check`).
"""
from __future__ import annotations

import os
import sys

from .main import CliError, command


@command("lint",
         "lint [--rules SPL1,SPL2] [--no-baseline] [--write-baseline]",
         "splint static analysis: protocol-registry sync + torch "
         "dispatch-hazard rules (exit 1 on findings)")
def cmd_lint(ses, args):
    from ..analysis import registry as R
    from ..analysis import runner

    root = R.REPO_ROOT
    rule_ids = None
    use_baseline = True
    write = False
    i = 0
    while i < len(args):
        a = args[i]
        if a == "--rules" and i + 1 < len(args):
            rule_ids = [r.strip() for r in args[i + 1].split(",")
                        if r.strip()]
            i += 2
        elif a == "--no-baseline":
            use_baseline = False
            i += 1
        elif a == "--write-baseline":
            write = True
            i += 1
        elif a == "--root" and i + 1 < len(args):
            root = args[i + 1]
            i += 2
        else:
            raise CliError(f"unknown lint argument {a!r} (usage: "
                           f"lint [--rules IDS] [--no-baseline] "
                           f"[--write-baseline] [--root DIR])")
    if write:
        if rule_ids or not use_baseline:
            # a baseline written under a rule filter would silently
            # absorb findings from rules the user never reviewed
            raise CliError("--write-baseline takes no other flags: "
                           "it re-scans with EVERY rule")
        try:
            path = runner.update_baseline(root)
        except ValueError as ex:       # engine-layer findings
            raise CliError(str(ex)) from None
        print(f"baseline written: {os.path.relpath(path, root)}")
        return
    try:
        rep = runner.scan(root, use_baseline=use_baseline,
                          rule_ids=rule_ids)
    except ValueError as ex:           # unknown --rules selection
        raise CliError(str(ex)) from None
    print(rep.render())
    for f, sup in rep.suppressed:
        print(f"  suppressed: {f.render()}  "
              f"[reason={sup.reason}]", file=sys.stderr)
    if not rep.clean:
        raise CliError(
            f"{len(rep.findings) + len(rep.parse_errors)} "
            f"unsuppressed splint finding(s)")
