"""Registry-sync rules (SPL1xx) over the port: the cross-file protocol
invariants (the JAX package's `analysis/registry_rules.py`, reading the
port's `protocol.py`, fault sites and `cli/metrics.py`).

Each rule checks one hand-maintained agreement the registry makes
machine-checkable: label bits don't collide, raw bit literals don't
leak out of protocol.py, every fault site is documented and
chaos-reachable, `spt metrics` renders exactly the heartbeat keys the
daemons publish, the doc tables match the registry, and stage-name
literals stay inside the pinned tuples.  `docs/` is the JAX package's,
rendered by its `scripts/gen_api_docs.py`; the port's protocol and
fault sites carry the same names, so the port is held to those pages.
"""
from __future__ import annotations

import ast

from .core import (Context, Finding, RULES, collect_suppressions,
                   rule)

# --- SPL001: suppression hygiene -----------------------------------------


@rule("SPL001", "meta", "suppression without reason or unknown rule",
      "every inline splint suppression must name a cataloged rule "
      "id and carry a non-empty `reason=`")
def check_suppression_hygiene(ctx: Context) -> list[Finding]:
    out = []
    for rel, sf in ctx.engine_files():
        for sup in collect_suppressions(sf):
            unknown = [r for r in sup.rules if r not in RULES]
            if unknown:
                out.append(Finding(
                    rel, sup.line, "SPL001",
                    f"suppression names unknown rule(s) "
                    f"{', '.join(unknown)}"))
            if not sup.reason:
                out.append(Finding(
                    rel, sup.line, "SPL001",
                    "suppression carries no reason= — justify why "
                    "the rule does not apply here"))
    return out


# --- SPL101: label-bit overlap -------------------------------------------


@rule("SPL101", "registry", "label-bit collision",
      "no two `LBL_*` labels / label fields in protocol.py may "
      "share a bit")
def check_label_overlap(ctx: Context) -> list[Finding]:
    reg = ctx.registry
    out = []
    owner: dict[int, object] = {}
    defs = sorted({**reg.labels, **reg.fields}.values(),
                  key=lambda d: d.lineno)
    for d in defs:
        for b in d.bits:
            prev = owner.get(b)
            if prev is not None and prev.name != d.name:
                out.append(Finding(
                    ctx.protocol_relpath, d.lineno, "SPL101",
                    f"{d.name} (mask {d.mask:#x}) collides with "
                    f"{prev.name} on bit {b}"))
            else:
                owner[b] = d
    return out


# --- SPL108: BIT_* index drift -------------------------------------------


@rule("SPL108", "registry", "BIT_* index out of sync with its label",
      "every `BIT_X` watch-registration index must equal the bit "
      "position of `LBL_X`")
def check_bit_indices(ctx: Context) -> list[Finding]:
    reg = ctx.registry
    out = []
    for name, idx in reg.bit_indices.items():
        lbl = reg.labels.get("LBL_" + name[len("BIT_"):])
        if lbl is None:
            out.append(Finding(
                ctx.protocol_relpath, 1, "SPL108",
                f"{name} has no matching LBL_ constant"))
            continue
        if lbl.bits != (idx,):
            out.append(Finding(
                ctx.protocol_relpath, lbl.lineno, "SPL108",
                f"{name}={idx} but {lbl.name} mask {lbl.mask:#x} "
                f"occupies bit(s) {list(lbl.bits)}"))
    return out


# --- SPL102: raw label-bit literals outside protocol.py -------------------

_LABEL_CALLEES = {"label_or", "label_clear", "label_andnot",
                  "watch_label_register", "watch_label_unregister",
                  "enumerate_indices", "candidate_mask",
                  "tenant_label"}
_LABELISH_NAME = ("label", "lbl", "bloom", "mask")


def _callee_name(call: ast.Call) -> str | None:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _is_high_shift(node: ast.AST, high_bits: set[int]) -> int | None:
    """`1 << N` / `0x1 << N` with N a registered high label bit."""
    if (isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift)
            and isinstance(node.left, ast.Constant)
            and node.left.value == 1
            and isinstance(node.right, ast.Constant)
            and isinstance(node.right.value, int)
            and node.right.value in high_bits):
        return node.right.value
    return None


def _labelish(node: ast.AST) -> bool:
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return bool(name) and any(t in name.lower()
                              for t in _LABELISH_NAME)


@rule("SPL102", "registry", "raw label-bit literal outside protocol.py",
      "label bits must be spelled via `protocol.LBL_*` / `BIT_*`: "
      "flags `1 << <high label bit>` anywhere, and literal masks in "
      "label-API calls or bitwise ops against label-named values")
def check_raw_label_bits(ctx: Context) -> list[Finding]:
    reg = ctx.registry
    high = reg.high_bits()
    mask_names = {v: k for k, v in reg.masks().items()}
    out = []
    for rel, sf in ctx.engine_files():
        if rel == ctx.protocol_relpath:
            continue
        for node in ast.walk(sf.tree):
            sh = _is_high_shift(node, high)
            if sh is not None:
                out.append(Finding(
                    rel, node.lineno, "SPL102",
                    f"raw `1 << {sh}` is label bit {sh} "
                    f"({mask_names.get(1 << sh, '?')}) — use the "
                    f"protocol constant"))
                continue
            if isinstance(node, ast.Call) and \
                    _callee_name(node) in _LABEL_CALLEES:
                for arg in list(node.args) + \
                        [kw.value for kw in node.keywords]:
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, int) and \
                            arg.value in mask_names:
                        out.append(Finding(
                            rel, arg.lineno, "SPL102",
                            f"literal {arg.value:#x} in "
                            f"{_callee_name(node)}() is "
                            f"{mask_names[arg.value]} — use the "
                            f"protocol constant"))
            if isinstance(node, ast.BinOp) and \
                    isinstance(node.op, (ast.BitAnd, ast.BitOr)):
                for lit, other in ((node.left, node.right),
                                   (node.right, node.left)):
                    if isinstance(lit, ast.Constant) and \
                            isinstance(lit.value, int) and \
                            lit.value in mask_names and \
                            _labelish(other):
                        out.append(Finding(
                            rel, lit.lineno, "SPL102",
                            f"literal {lit.value:#x} in a bitwise op "
                            f"against a label word is "
                            f"{mask_names[lit.value]} — use the "
                            f"protocol constant"))
    return out


# --- SPL103: fault site documented ----------------------------------------


@rule("SPL103", "registry", "fault site missing from the catalog",
      "every `fault(\"site\")` call must have a FAULT_SITE_DOCS "
      "entry (analysis/registry.py) and appear in the "
      "docs/operations.md fault-point catalog")
def check_fault_sites_documented(ctx: Context) -> list[Finding]:
    ops = ctx.docs.get("operations", "")
    out = []
    for s in ctx.fault_sites:
        if s.site not in ctx.fault_site_docs:
            out.append(Finding(
                s.relpath, s.lineno, "SPL103",
                f"fault site {s.site!r} has no FAULT_SITE_DOCS entry "
                f"— document it in "
                f"libsplinter_tpu_torch/analysis/registry.py"))
        elif f"`{s.site}`" not in ops:
            out.append(Finding(
                s.relpath, s.lineno, "SPL103",
                f"fault site {s.site!r} missing from the "
                f"docs/operations.md catalog — the port's sites "
                f"carry the JAX package's names"))
    return out


# --- SPL104: fault site chaos-reachable -----------------------------------


@rule("SPL104", "registry", "fault site unreachable from the chaos tier",
      "every fault site must be exercised (or at least referenced) "
      "by tests/ — an undrilled site is an untested recovery claim")
def check_fault_sites_reached(ctx: Context) -> list[Finding]:
    out = []
    for s in ctx.fault_sites:
        if s.site not in ctx.tests_text:
            out.append(Finding(
                s.relpath, s.lineno, "SPL104",
                f"fault site {s.site!r} is referenced nowhere under "
                f"tests/ — add it to the chaos matrix or a "
                f"containment test"))
    return out


# --- SPL105: spt metrics <-> heartbeat keys -------------------------------

_METRICS_RELPATH = "libsplinter_tpu_torch/cli/metrics.py"


@rule("SPL105", "registry", "metrics/heartbeat key drift",
      "`spt metrics` must read heartbeat store keys via protocol "
      "constants only, must render every published `KEY_*_STATS` / "
      "`KEY_*_TRACE` key, and — when the protocol defines a replica "
      "suffix — must discover replica-suffixed heartbeat keys via "
      "the protocol helper, never a one-key-per-lane read")
def check_metrics_backing(ctx: Context) -> list[Finding]:
    sf = ctx.files.get(_METRICS_RELPATH)
    if sf is None or sf.tree is None:
        return []
    reg = ctx.registry
    out = []
    key_values = set(reg.keys.values())
    referenced: set[str] = set()
    helpers: set[str] = set()
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Attribute) and \
                node.attr.startswith("KEY_"):
            referenced.add(node.attr)
        if isinstance(node, ast.Attribute):
            helpers.add(node.attr)
        elif isinstance(node, ast.Name):
            helpers.add(node.id)
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                node.value.startswith("__"):
            if node.value in key_values:
                out.append(Finding(
                    _METRICS_RELPATH, node.lineno, "SPL105",
                    f"heartbeat key {node.value!r} hardcoded — use "
                    f"the protocol KEY_ constant"))
            else:
                out.append(Finding(
                    _METRICS_RELPATH, node.lineno, "SPL105",
                    f"store key {node.value!r} read by spt metrics "
                    f"is not a registered well-known key — no "
                    f"daemon publishes it"))
    for name in sorted(reg.keys):
        if (name.endswith("_STATS") or name.endswith("_TRACE")) \
                and name not in referenced:
            out.append(Finding(
                _METRICS_RELPATH, 1, "SPL105",
                f"published heartbeat key {name} "
                f"({reg.keys[name]}) is never rendered by spt "
                f"metrics — operators cannot see that lane"))
    if getattr(reg, "replica_suffix", "") \
            and not helpers & {"replica_heartbeat_keys",
                               "replica_heartbeat_map"}:
        out.append(Finding(
            _METRICS_RELPATH, 1, "SPL105",
            "protocol defines a replica heartbeat-key suffix "
            f"({reg.replica_suffix!r}) but spt metrics never calls "
            "replica_heartbeat_keys()/replica_heartbeat_map() — a "
            "scaled lane's extra replicas would be invisible (stale "
            "one-key-per-lane read)"))
    return out


# --- SPL106: doc tables derived from the registry -------------------------


@rule("SPL106", "registry", "doc table drift",
      "the label-bit table (docs/api/bloom-labels.md) and fault "
      "catalog (docs/operations.md) must byte-match what the port's "
      "registry renders — the port's protocol.py and fault sites "
      "stay the JAX package's")
def check_doc_tables(ctx: Context) -> list[Finding]:
    from . import registry as R
    out = []
    label_tbl = R.render_label_table(ctx.registry)
    bl = ctx.docs.get("bloom-labels", "")
    if label_tbl not in bl:
        out.append(Finding(
            "docs/api/bloom-labels.md", 1, "SPL106",
            "label-bit table differs from the port's protocol.py — "
            "keep engine/protocol.py the JAX package's copy"))
    fault_tbl = R.render_fault_table(ctx.fault_sites)
    ops = ctx.docs.get("operations", "")
    if fault_tbl not in ops:
        out.append(Finding(
            "docs/operations.md", 1, "SPL106",
            "fault-point catalog differs from the port's "
            "instrumented sites — keep them the JAX package's"))
    return out


# --- SPL107: stage-name literals -----------------------------------------

# tracer span names outside the pinned per-request stage tuples that
# are legitimately recorded (whole-cycle aggregates)
_EXTRA_SPANS = {"e2e", "drain_cycle"}
_PREFIX_FAMILIES = {"embed": ("PIPELINE_STAGES",),
                    "infer": ("INFER_STAGES", "CONT_INFER_STAGES"),
                    "search": ("SEARCH_STAGES",),
                    "script": ("SCRIPT_STAGES",)}


@rule("SPL107", "registry", "unknown stage name in tracer span",
      "stage-name literals recorded to tracers must come from the "
      "pinned `*_STAGES` tuples (plus e2e/drain_cycle aggregates) — "
      "a typo silently creates a histogram no dashboard reads")
def check_stage_names(ctx: Context) -> list[Finding]:
    reg = ctx.registry
    all_stages = reg.stage_names()
    out = []
    for rel, sf in ctx.engine_files():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            # tracer.record("prefix.stage", ...) / tracer.span(...)
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in ("record", "span") and \
                    isinstance(fn.value, ast.Name) and \
                    fn.value.id == "tracer" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        "." in arg.value:
                    prefix, stage = arg.value.split(".", 1)
                    fams = _PREFIX_FAMILIES.get(prefix)
                    if fams is None:
                        continue      # not a stage histogram family
                    ok = stage in _EXTRA_SPANS or any(
                        stage in reg.stages.get(f, ())
                        for f in fams)
                    if not ok:
                        out.append(Finding(
                            rel, arg.lineno, "SPL107",
                            f"span {arg.value!r}: {stage!r} is not "
                            f"in {' / '.join(fams)}"))
            # span(row, "stage", ms) — the continuous lane's local
            # helper accumulating CONT_INFER_STAGES events
            elif isinstance(fn, ast.Name) and fn.id == "span" and \
                    len(node.args) >= 2:
                arg = node.args[1]
                if isinstance(arg, ast.Constant) and \
                        isinstance(arg.value, str) and \
                        arg.value not in all_stages:
                    out.append(Finding(
                        rel, arg.lineno, "SPL107",
                        f"stage {arg.value!r} is not in any "
                        f"*_STAGES tuple"))
    return out
