"""The port's splint runner: build the Context from a working tree, run
every cataloged rule, apply suppressions + baseline, render the report.

Scanned surface (default): every `.py` under `libsplinter_tpu_torch/`.
The JAX package and `scripts/` are the JAX splint's
(`libsplinter_tpu/analysis/`).  `tests/` is never scanned (tests seed
hazards on purpose); it is instead the *corpus* SPL104 checks
fault-site reachability against.
"""
from __future__ import annotations

import dataclasses
import os

from . import registry as R
from .core import (BASELINE_RELPATH, Context, Finding, RULES,
                   SourceFile, collect_suppressions, load_baseline,
                   suppression_covers, write_baseline)

# rule modules register themselves into RULES at import
from . import registry_rules as _rr    # noqa: F401
from . import torch_rules as _tr       # noqa: F401

SCAN_RELPATHS = ("libsplinter_tpu_torch",)
DOC_PATHS = {"operations": os.path.join("docs", "operations.md"),
             "bloom-labels": os.path.join("docs", "api",
                                          "bloom-labels.md")}


@dataclasses.dataclass
class Report:
    findings: list[Finding]            # unsuppressed, unbaselined
    suppressed: list[tuple]            # (Finding, Suppression)
    baselined: list[Finding]
    files_scanned: int
    parse_errors: list[tuple[str, str]]

    @property
    def clean(self) -> bool:
        return not self.findings and not self.parse_errors

    def render(self) -> str:
        lines = [f.render() for f in
                 sorted(self.findings,
                        key=lambda f: (f.file, f.line, f.rule))]
        for rel, err in self.parse_errors:
            lines.append(f"{rel}:1 · SPL000 · {err}")
        tail = (f"splint: {len(self.findings)} finding(s), "
                f"{len(self.suppressed)} suppressed, "
                f"{len(self.baselined)} baselined, "
                f"{self.files_scanned} files, "
                f"{len(RULES)} rules")
        return "\n".join(lines + [tail])


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def build_context(root: str | None = None) -> Context:
    root = root or R.REPO_ROOT
    files: dict[str, SourceFile] = {}
    for rel in SCAN_RELPATHS:
        for r in R._iter_py(root, rel):
            key = r.replace(os.sep, "/")
            files[key] = SourceFile(key,
                                    _read(os.path.join(root, r)))
    docs = {name: _read(os.path.join(root, rel))
            for name, rel in DOC_PATHS.items()}
    tests_text = []
    tests_dir = os.path.join(root, "tests")
    if os.path.isdir(tests_dir):
        for fn in sorted(os.listdir(tests_dir)):
            if fn.endswith(".py"):
                tests_text.append(_read(os.path.join(tests_dir, fn)))
    return Context(
        registry=R.extract_registry(
            os.path.join(root, R.PROTOCOL_RELPATH)),
        files=files,
        fault_sites=R.fault_sites(root),
        fault_site_docs=R.FAULT_SITE_DOCS,
        docs=docs,
        tests_text="\n".join(tests_text),
        protocol_relpath=R.PROTOCOL_RELPATH.replace(os.sep, "/"))


def run_rules(ctx: Context,
              rule_ids: list[str] | None = None) -> list[Finding]:
    if rule_ids:
        unknown = sorted(set(rule_ids) - set(RULES))
        if unknown:
            # the fault-spec lesson (utils/faults.FaultSpecError): a
            # typo'd selection must fail loudly, never run zero rules
            # and report a clean tree
            raise ValueError(
                f"unknown rule id(s) {', '.join(unknown)} — "
                f"catalog: {', '.join(sorted(RULES))}")
    findings: list[Finding] = []
    for rid, rl in sorted(RULES.items()):
        if rule_ids and rid not in rule_ids:
            continue
        findings.extend(rl.check(ctx))
    return findings


def scan(root: str | None = None, *,
         baseline_path: str | None = None,
         use_baseline: bool = True,
         rule_ids: list[str] | None = None,
         ctx: Context | None = None) -> Report:
    root = root or R.REPO_ROOT
    if ctx is None:
        ctx = build_context(root)
    all_findings = run_rules(ctx, rule_ids)

    sups = []
    for sf in ctx.files.values():
        sups.extend(collect_suppressions(sf))
    kept: list[Finding] = []
    suppressed = []
    for f in all_findings:
        cover = next((s for s in sups if suppression_covers(s, f)),
                     None)
        if cover is not None:
            suppressed.append((f, cover))
        else:
            kept.append(f)

    baselined: list[Finding] = []
    if use_baseline:
        if baseline_path is None:
            baseline_path = os.path.join(root, BASELINE_RELPATH)
        base = load_baseline(baseline_path)
        still: list[Finding] = []
        for f in kept:
            (baselined if f.fingerprint() in base else still).append(f)
        kept = still

    errors = [(rel, sf.error) for rel, sf in sorted(ctx.files.items())
              if sf.error]
    return Report(findings=kept, suppressed=suppressed,
                  baselined=baselined,
                  files_scanned=len(ctx.files),
                  parse_errors=errors)


ENGINE_PREFIX = "libsplinter_tpu_torch/engine/"


def update_baseline(root: str | None = None) -> str:
    """`lint --write-baseline`: re-scan without the baseline and
    persist every surviving finding as the new tolerated set.

    The no-engine-entries policy is enforced HERE, at the mechanism:
    an engine-layer finding refuses to baseline (nothing is written),
    so the documented workflow cannot mask a live hot-path hazard
    that only a later test run would catch."""
    root = root or R.REPO_ROOT
    rep = scan(root, use_baseline=False)
    engine = [f for f in rep.findings
              if f.file.startswith(ENGINE_PREFIX)]
    if engine:
        raise ValueError(
            "engine-layer findings cannot be baselined — fix them "
            "or add a justified inline suppression:\n" +
            "\n".join(f.render() for f in engine))
    path = os.path.join(root, BASELINE_RELPATH)
    write_baseline(path, rep.findings)
    return path
