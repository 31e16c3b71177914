"""splint rule-engine core for the port: findings, the rule catalog,
suppression and baseline semantics (the JAX package's
`analysis/core.py`, with the port's own baseline path, baseline
header and rule-catalog markers).

A rule is a function `check(ctx) -> list[Finding]` registered under a
stable `SPL###` id.  Findings render as `file:line · RULE_ID ·
message` — the grep-able, clickable report format that
`python -m libsplinter_tpu_torch.cli lint` emits.

Two escape hatches, both auditable:

- **Inline suppression** — a comment `splint: ignore[SPL201]
  reason=...` on the flagged line (or the line directly above it,
  as its own comment line).  The reason is
  MANDATORY: a suppression without one is itself a finding (SPL001).
  This is the "yes, splint is right that this blocks, and here is
  why it must" annotation.
- **Baseline** — `analysis/splint_baseline.txt`, a checked-in list of
  finding fingerprints tolerated at gate-introduction time so the
  gate lands green on day one.  New findings never match the
  baseline; fixing a baselined finding leaves a stale entry that
  `python -m libsplinter_tpu_torch.cli lint --write-baseline`
  prunes.  Policy: the engine layer (`libsplinter_tpu_torch/engine/`)
  must stay OUT of the baseline — hot path invariants get fixed or
  explicitly suppressed, never backlogged
  (`tests/test_torch_splint.py` pins this).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str                     # repo-relative, forward slashes
    line: int                     # 1-based
    rule: str                     # SPL###
    message: str

    def render(self) -> str:
        return f"{self.file}:{self.line} · {self.rule} · {self.message}"

    def fingerprint(self) -> str:
        """Line-number-free identity: baselines must survive
        unrelated edits shifting the file."""
        return f"{self.rule} · {self.file} · {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    family: str                   # "registry" | "dispatch" | "meta"
    title: str
    doc: str                      # one-line catalog description
    check: object                 # callable(ctx) -> list[Finding]


RULES: dict[str, Rule] = {}


def rule(rule_id: str, family: str, title: str, doc: str):
    """Register a rule in the catalog (decorator).  The catalog IS
    the source of the port's rule table in README.md — the meta-test
    fails when they drift."""
    def wrap(fn):
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id}")
        RULES[rule_id] = Rule(rule_id, family, title, doc, fn)
        return fn
    return wrap


# The port's catalog has markers of its own, so that it can never be
# taken for the JAX package's (docs/operations.md, SPL202/203/205
# included) or the JAX package's for it.
RULES_BEGIN = ("<!-- splint-torch:rule-catalog:begin — rendered by "
               "libsplinter_tpu_torch/analysis/core.py "
               "render_rule_table(); edit the rule docs there -->")
RULES_END = "<!-- splint-torch:rule-catalog:end -->"


def render_rule_table() -> str:
    """The operator-facing rule catalog (README.md, the port's
    section) — rendered from the live registry so the table can never
    list a rule that doesn't run, or miss one that does."""
    rows = ["| rule | family | checks |",
            "|---|---|---|"]
    for rid, r in sorted(RULES.items()):
        doc = r.doc.replace("|", "\\|")
        rows.append(f"| `{rid}` | {r.family} | {doc} |")
    return "\n".join(rows)


@dataclasses.dataclass
class SourceFile:
    relpath: str                  # forward-slash repo-relative path
    text: str
    tree: ast.AST | None = None
    error: str | None = None

    def __post_init__(self):
        if self.tree is None and self.error is None:
            try:
                self.tree = ast.parse(self.text)
            except SyntaxError as ex:
                self.error = f"syntax error: {ex}"

    @property
    def lines(self) -> list[str]:
        return self.text.splitlines()


@dataclasses.dataclass
class Context:
    """Everything a rule may read.  Built from the working tree by
    runner.scan(); built by hand (synthetic sources / docs / registry)
    in the fixture tests."""
    registry: object              # registry.ProtocolRegistry
    files: dict[str, SourceFile]  # every scanned source
    fault_sites: list             # registry.FaultSite
    fault_site_docs: dict         # site -> description
    docs: dict[str, str]          # "operations" / "bloom-labels" text
    tests_text: str               # concatenated tests/ corpus
    protocol_relpath: str         # registry source, excluded from SPL102

    def engine_files(self):
        for rel, sf in sorted(self.files.items()):
            if sf.tree is not None:
                yield rel, sf


# --- suppressions ---------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"#\s*splint:\s*ignore\[([A-Za-z0-9_,\s]+)\]"
    r"(?:\s+reason=(\S.*))?")


@dataclasses.dataclass(frozen=True)
class Suppression:
    relpath: str
    line: int                     # the comment's own line
    rules: tuple[str, ...]
    reason: str


def collect_suppressions(sf: SourceFile) -> list[Suppression]:
    out = []
    for i, line in enumerate(sf.lines, 1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = tuple(s.strip() for s in m.group(1).split(",")
                    if s.strip())
        out.append(Suppression(sf.relpath, i, ids,
                               (m.group(2) or "").strip()))
    return out


def suppression_covers(sup: Suppression, finding: Finding) -> bool:
    """A suppression applies to its own line and to the line directly
    below it (comment-above style), for the listed rule ids."""
    return (sup.relpath == finding.file
            and finding.rule in sup.rules
            and sup.line in (finding.line, finding.line - 1))


# --- baseline -------------------------------------------------------------

BASELINE_RELPATH = os.path.join("libsplinter_tpu_torch", "analysis",
                                "splint_baseline.txt")


def load_baseline(path: str) -> set[str]:
    """Fingerprint set from the baseline file; `#` comments and blank
    lines ignored.  A missing file is an empty baseline."""
    if not os.path.exists(path):
        return set()
    out = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


BASELINE_HEADER = """\
# splint baseline — findings tolerated when the gate was introduced.
# One fingerprint per line: `RULE · file · message` (no line numbers,
# so unrelated edits don't churn it).  Regenerate with
#   python -m libsplinter_tpu_torch.cli lint --write-baseline
# Policy: entries under libsplinter_tpu_torch/engine/ are FORBIDDEN
# (the hot path gets fixed or inline-suppressed with a reason, never
# backlogged) — tests/test_torch_splint.py enforces this.
"""


def write_baseline(path: str, findings: list[Finding]) -> None:
    with open(path, "w") as f:
        f.write(BASELINE_HEADER)
        for fp in sorted({fn.fingerprint() for fn in findings}):
            f.write(fp + "\n")
