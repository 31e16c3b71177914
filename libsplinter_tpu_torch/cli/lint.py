"""`spt lint` — refused in the port.

splint (the JAX package's `analysis/`) scans the JAX package's own
sources with JAX dispatch-hazard rules, and its --write-baseline
writes into that package.  It has no port counterpart: the command is
kept so `help` lists the same command names, and it points at the JAX
package's CLI and the make target that run it.
"""
from __future__ import annotations

from .main import CliError, command


@command("lint",
         "lint [--rules SPL1,SPL2] [--no-baseline] [--write-baseline]",
         "splint static analysis: not in the port — run `python -m "
         "libsplinter_tpu.cli lint` or `make lint-check` (exit 1)")
def cmd_lint(ses, args):
    raise CliError("splint scans the JAX package's sources and has no "
                   "port counterpart (ROADMAP.md Queue A item 4): run "
                   "`python -m libsplinter_tpu.cli lint` or "
                   "`make lint-check`")
