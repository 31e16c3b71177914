"""splint for the port (libsplinter_tpu_torch/analysis/): registry
extraction against the port's live protocol.py, each rule's positive
and negative fixtures, the torch host-sync forms of SPL201 each beside
its clean twin, suppression + baseline semantics, the live-port-tree
gate, the rule table in README.md, and the isolation of the port's
catalog from the JAX package's (tests/test_splint.py holds that one).

The port's analysis package is imported by its dotted name; it is
stdlib-only, so none of this needs torch or the built kernels.
"""
from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys
import types

import pytest

from libsplinter_tpu_torch.analysis import (core, registry as R,
                                            registry_rules as RR, runner)
import libsplinter_tpu_torch.analysis as splint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "libsplinter_tpu_torch"
ENGINE = f"{PKG}/engine/foo.py"

# ------------------------------------------------------------ fixtures

PROTO_OK = """\
LBL_A = 0x1                    # label a
LBL_B = 0x40                   # label b
LBL_HIGH = 0x1 << 57           # high label
TENANT_SHIFT = 48
TENANT_BITS = 4
TENANT_MASK = ((1 << TENANT_BITS) - 1) << TENANT_SHIFT
BIT_A = 0
BIT_B = 6
PIPELINE_STAGES = ("drain", "commit")
SEARCH_STAGES = ("wake", "drain", "score", "select", "commit")
KEY_EMBED_STATS = "__embedder_stats"
SEARCH_RESULT_PREFIX = "__sr_"
"""

PROTO_RELPATH = f"{PKG}/engine/protocol.py"


def make_ctx(files=None, proto=PROTO_OK, docs=None, tests_text="",
             fault_docs=None):
    files = files or {}
    return core.Context(
        registry=R.extract_registry(source=proto),
        files={rel: core.SourceFile(rel, text)
               for rel, text in files.items()},
        fault_sites=R.fault_sites(sources=files),
        fault_site_docs=(R.FAULT_SITE_DOCS if fault_docs is None
                         else fault_docs),
        docs=docs or {},
        tests_text=tests_text,
        protocol_relpath=PROTO_RELPATH)


def run_rule(rule_id, **kw):
    return runner.run_rules(make_ctx(**kw), [rule_id])


def _jax_reason(rel: str) -> str:
    """The reason of the JAX package's SPL201 suppression in `rel`, read
    as text (the JAX package is not imported)."""
    with open(os.path.join(ROOT, "libsplinter_tpu", rel)) as f:
        m = re.search(r"splint: ignore\[SPL201\] reason=(.*)", f.read())
    return m.group(1).strip()


# --------------------------------------- registry vs live protocol.py

def test_registry_extracts_live_protocol():
    reg = splint.extract_registry()
    assert reg.path.endswith(os.path.join(PKG, "engine", "protocol.py"))
    assert reg.labels["LBL_EMBED_REQ"].mask == 0x1
    assert reg.labels["LBL_READY"].mask == 1 << 62
    assert reg.labels["LBL_SEARCH_REQ"].bits == (57,)
    assert reg.fields["TENANT_MASK"].bits == tuple(range(48, 52))
    assert reg.stages["PIPELINE_STAGES"] == (
        "drain", "tokenize", "dispatch", "device_wait", "commit")
    assert reg.stages["CONT_INFER_STAGES"] == (
        "join", "sample", "decode", "collect", "flush", "prefix_hit",
        "handoff", "adopt")
    assert reg.keys["KEY_SEARCH_STATS"] == "__searcher_stats"
    assert reg.prefixes["SEARCH_RESULT_PREFIX"] == "__sr_"
    assert reg.prefixes["DEADLINE_STAMP_PREFIX"] == "__dl_"
    assert reg.bit_indices["BIT_INFER_REQ"] == 60
    assert "wakes the embedding daemon" in \
        reg.labels["LBL_EMBED_REQ"].comment


def test_live_fault_sites_discovered():
    found = splint.fault_sites(ROOT)
    sites = {s.site for s in found}
    assert {"searcher.gather", "embedder.encode", "completer.render",
            "completer.kv_quant_commit", "resident.ring_collect",
            "supervisor.poll", "store.set", "store.vec_commit"} <= sites
    assert sites <= set(splint.FAULT_SITE_DOCS)
    assert all(s.relpath.startswith(PKG + "/") for s in found)


# ----------------------------------------------------- the live gate

def test_live_tree_is_clean():
    """The acceptance gate: the port's splint reports nothing on the
    tree at HEAD, and its only suppressions are the two intentional
    host syncs, each with the JAX package's reason."""
    rep = runner.scan(ROOT)
    assert rep.clean, "\n" + rep.render()
    assert rep.files_scanned >= 70
    assert all(f.file.startswith(PKG + "/") for f, _ in rep.suppressed)
    got = {f.file: (f.rule, sup.reason) for f, sup in rep.suppressed}
    assert got == {
        f"{PKG}/engine/completer.py":
            ("SPL201", _jax_reason("engine/completer.py")),
        f"{PKG}/engine/embedder.py":
            ("SPL201", _jax_reason("engine/embedder.py"))}


def test_baseline_has_no_engine_entries():
    path = os.path.join(ROOT, core.BASELINE_RELPATH)
    assert path.startswith(os.path.join(ROOT, PKG, "analysis"))
    entries = core.load_baseline(path)
    assert not {e for e in entries if f"{PKG}/engine/" in e}
    assert entries == set()            # ships empty — keep it so
    with open(path) as f:
        assert "python -m libsplinter_tpu_torch.cli lint " \
            "--write-baseline" in f.read()


# ------------------------------------------- SPL101/SPL108: registry

@pytest.mark.parametrize("extra, names", [
    ("LBL_EVIL = 0x40        # collides with LBL_B\n",
     ("LBL_EVIL", "bit 6")),
    ("LBL_EVIL = 0x1 << 50   # inside TENANT_MASK\n", ("TENANT_MASK",)),
], ids=["label", "field"])
def test_label_collision_detected(extra, names):
    fs = run_rule("SPL101", proto=PROTO_OK + extra)
    assert len(fs) == 1 and fs[0].rule == "SPL101"
    assert all(n in fs[0].message for n in names)


def test_live_protocol_has_no_collisions():
    with open(os.path.join(ROOT, PROTO_RELPATH)) as f:
        live = f.read()
    assert run_rule("SPL101", proto=live) == []
    assert run_rule("SPL108", proto=live) == []


def test_bit_index_mismatch_detected():
    bad = PROTO_OK.replace("BIT_B = 6", "BIT_B = 7")
    fs = run_rule("SPL108", proto=bad)
    assert len(fs) == 1 and "BIT_B=7" in fs[0].message


# ------------------------------------------- SPL102: raw bit literals

@pytest.mark.parametrize("src, word", [
    ("MASK = 1 << 57\n", "bit 57"),
    ("def f(store, key):\n    store.label_or(key, 0x40)\n", "label_or"),
    ("def f(labels):\n    return labels & 0x40\n", "LBL_B"),
], ids=["high_shift", "label_api", "label_bitop"])
def test_raw_label_literal_flagged(src, word):
    fs = run_rule("SPL102", files={ENGINE: src})
    assert len(fs) == 1 and word in fs[0].message


def test_innocent_literals_not_flagged():
    src = ("def f(v, store):\n"
           "    buf = bytearray(0x40)\n"
           "    store.set('k', 'x' * 64)\n"
           "    return v & 0x3F\n")
    assert run_rule("SPL102", files={
        ENGINE: src,
        PROTO_RELPATH: "LBL_B = 0x40\nX = LBL_B & 0x40\n"}) == []


# --------------------------------------- SPL103/SPL104: fault sites

def test_undocumented_fault_site_flagged():
    src = "def f():\n    fault('new.site')\n"
    fs = run_rule("SPL103", files={ENGINE: src}, tests_text="new.site")
    assert len(fs) == 1 and "FAULT_SITE_DOCS" in fs[0].message


def test_documented_site_missing_from_ops_doc():
    src = "def f():\n    fault('new.site')\n"
    fs = run_rule("SPL103", files={ENGINE: src},
                  fault_docs={"new.site": "somewhere"},
                  docs={"operations": "no table here"})
    assert len(fs) == 1 and "operations.md" in fs[0].message
    assert run_rule("SPL103", files={ENGINE: src},
                    fault_docs={"new.site": "somewhere"},
                    docs={"operations": "| `new.site` | somewhere |"}) \
        == []


def test_chaos_unreached_site_flagged():
    src = "def f():\n    fault('lonely.site')\n"
    fs = run_rule("SPL104", files={ENGINE: src},
                  tests_text="tests mention other.site only")
    assert len(fs) == 1 and "lonely.site" in fs[0].message
    assert run_rule("SPL104", files={ENGINE: src},
                    tests_text="SPTPU_FAULT=lonely.site:crash@1") == []


# ----------------------------------------- SPL105: metrics/heartbeat

METRICS_RELPATH = f"{PKG}/cli/metrics.py"


def test_metrics_path_is_the_ports():
    """SPL105 reads the port's cli/metrics.py: pointed at the JAX
    package's path it would check nothing on this tree."""
    ctx = runner.build_context(ROOT)
    assert METRICS_RELPATH in ctx.files
    assert run_rule("SPL105", files={
        METRICS_RELPATH: "K = '__mystery_key'\n"}) != []
    assert run_rule("SPL105", files={
        "libsplinter_tpu/cli/metrics.py": "K = '__mystery_key'\n"}) == []


def test_hardcoded_heartbeat_key_flagged():
    src = ("from ..engine import protocol as P\n"
           "KEYS = [P.KEY_EMBED_STATS]\n"
           "BAD = '__embedder_stats'\n")
    fs = run_rule("SPL105", files={METRICS_RELPATH: src})
    assert len(fs) == 1 and "hardcoded" in fs[0].message


def test_unrendered_heartbeat_key_flagged():
    proto = PROTO_OK + 'KEY_NEWLANE_STATS = "__newlane_stats"\n'
    src = "from ..engine import protocol as P\nK = P.KEY_EMBED_STATS\n"
    fs = run_rule("SPL105", proto=proto, files={METRICS_RELPATH: src})
    assert len(fs) == 1 and "KEY_NEWLANE_STATS" in fs[0].message


def test_unknown_store_key_flagged():
    fs = run_rule("SPL105", files={METRICS_RELPATH: "K = '__mystery_key'\n"})
    assert len(fs) == 2     # hardcoded-unknown + unrendered KEY_EMBED
    assert any("not a registered" in f.message for f in fs)


# ------------------------------------------- SPL106: doc-table drift

def test_doc_table_drift_flagged():
    fs = run_rule("SPL106",
                  docs={"operations": "stale", "bloom-labels": "stale"})
    assert {f.rule for f in fs} == {"SPL106"} and len(fs) == 2


def test_doc_tables_in_sync_pass():
    reg = R.extract_registry(source=PROTO_OK)
    ctx = make_ctx(files={ENGINE: "def f():\n    fault('searcher.gather')\n"})
    ctx.docs = {"bloom-labels": R.render_label_table(reg),
                "operations": R.render_fault_table(ctx.fault_sites)}
    assert runner.run_rules(ctx, ["SPL106"]) == []


# ------------------------------------------- SPL107: stage names

@pytest.mark.parametrize("src, bad", [
    ("def f(tracer):\n"
     "    tracer.record('search.scoree', 1.0)\n"
     "    tracer.record('search.score', 1.0)\n"
     "    tracer.record('search.e2e', 1.0)\n", "scoree"),
    ("def f(span, r):\n"
     "    span(r, 'wake', 1.0)\n"
     "    span(r, 'jion', 1.0)\n", "jion"),
], ids=["tracer_record", "span_helper"])
def test_stage_typo_flagged(src, bad):
    fs = run_rule("SPL107", files={ENGINE: src})
    assert len(fs) == 1 and bad in fs[0].message


# ------------------------------------------- SPL201: host syncs

# (form, a hazard line inside a drain function, its clean twin): the
# twin is the same call where it does not block the lane (outside a
# drain function) or the same coercion of a value already on the host
SYNC_FORMS = [
    ("item", "n = self.pend.item()", "helper"),
    ("tolist", "rows = self.pend.tolist()", "helper"),
    ("cpu", "out = self.pend.cpu()", "helper"),
    ("numpy", "out = self.pend.numpy()", "helper"),
    ("cuda_synchronize", "torch.cuda.synchronize()", "helper"),
    ("stream_synchronize", "self.stream.synchronize()", "helper"),
    ("event_synchronize", "self.done_event.synchronize()", "helper"),
    ("int", "t = int(self.m.sample(self.logits))", "t = int(self.count)"),
    ("float", "x = float(torch.max(self.pend))", "x = float(len(self.q))"),
    ("np_asarray", "v = np.asarray(self.encoder_fn(['x']))",
     "v = np.asarray(self.lens)"),
    ("np_array", "v = np.array(self.model(self.ids), np.float32)",
     "v = np.array(np.zeros(3))"),
]


def _drain_src(line, fn="run_once"):
    return ("import numpy as np\nimport torch\n\n"
            "class D:\n"
            f"    def {fn}(self):\n"
            f"        {line}\n")


@pytest.mark.parametrize("form, hazard, twin", SYNC_FORMS,
                         ids=[f[0] for f in SYNC_FORMS])
def test_host_sync_form_flagged_beside_its_clean_twin(form, hazard, twin):
    fs = run_rule("SPL201", files={ENGINE: _drain_src(hazard)})
    assert [(f.rule, f.line) for f in fs] == [("SPL201", 6)], fs
    assert "run_once()" in fs[0].message
    clean = (_drain_src(hazard, "helper") if twin == "helper"
             else _drain_src(twin))
    assert run_rule("SPL201", files={ENGINE: clean}) == []


DRAIN_BAD = """\
import numpy as np
import torch

class D:
    def run_continuous(self):
        toks = self.dispatch()
        t = int(self.m.sample(toks))
        return toks.tolist(), t

    def _dispatch_ring(self):
        vecs = np.asarray(self.encoder_fn(['x']), np.float32)
        torch.cuda.synchronize()
        return vecs

    def helper(self):
        return self.x.item()                 # not a drain fn: allowed

    def _service(self):
        n = int(self.count)                  # Name arg: no fetch
        lens = np.asarray(self.lens)         # Name arg: no fetch
        k = int(len(self.rows))              # len: host only
        return n, lens, k
"""


def test_host_sync_in_drain_flagged():
    fs = run_rule("SPL201", files={ENGINE: DRAIN_BAD})
    assert sorted(f.line for f in fs) == [7, 8, 11, 12], fs


def test_acceptance_seeded_sync_fails_gate():
    """Seed a synchronize into a run_continuous body: the gate fails
    with a `file:line · RULE_ID` report."""
    src = ("import torch\n"
           "def run_continuous(self):\n"
           "    torch.cuda.synchronize()\n")
    ctx = make_ctx(files={f"{PKG}/engine/evil.py": src})
    rep = runner.scan(ctx=ctx, use_baseline=False, rule_ids=["SPL201"])
    assert not rep.clean
    line = rep.render().splitlines()[0]
    assert re.match(r"libsplinter_tpu_torch/engine/evil\.py:3 · SPL201 · ",
                    line)


# ----------------------------------- suppression + baseline semantics

SEEDED = ("import torch\n"
          "def run_continuous(self):\n"
          "    return self.pend.item()\n")


def test_suppression_with_reason_suppresses():
    src = SEEDED.replace(
        "    return", "    # splint: ignore[SPL201] reason=measured: the "
        "fetch overlaps the next dispatch\n    return")
    rep = runner.scan(ctx=make_ctx(files={ENGINE: src}),
                      use_baseline=False, rule_ids=["SPL201", "SPL001"])
    assert [f.rule for f in rep.findings] == []
    assert len(rep.suppressed) == 1
    assert "overlaps" in rep.suppressed[0][1].reason


@pytest.mark.parametrize("src", [
    SEEDED.replace(".item()\n", ".item()  # splint: ignore[SPL201]\n"),
    "x = 1  # splint: ignore[SPL999] reason=no such rule\n",
    # a JAX-only rule is unknown to the port's catalog
    "x = 1  # splint: ignore[SPL202] reason=donation\n",
], ids=["no_reason", "unknown_rule", "jax_only_rule"])
def test_suppression_hygiene_is_a_finding(src):
    rep = runner.scan(ctx=make_ctx(files={ENGINE: src}),
                      use_baseline=False, rule_ids=["SPL201", "SPL001"])
    assert [f.rule for f in rep.findings] == ["SPL001"]


def test_baseline_hides_only_matching_findings(tmp_path):
    rep = runner.scan(ctx=make_ctx(files={ENGINE: SEEDED}),
                      use_baseline=False, rule_ids=["SPL201"])
    assert len(rep.findings) == 1
    base = tmp_path / "base.txt"
    base.write_text(rep.findings[0].fingerprint() + "\n")
    rep2 = runner.scan(ctx=make_ctx(files={ENGINE: SEEDED}),
                       baseline_path=str(base), rule_ids=["SPL201"])
    assert rep2.clean and len(rep2.baselined) == 1
    # another hazard class, so another fingerprint, is not baselined
    src2 = SEEDED.replace("self.pend.item()", "torch.cuda.synchronize()")
    rep3 = runner.scan(ctx=make_ctx(files={ENGINE: src2}),
                       baseline_path=str(base), rule_ids=["SPL201"])
    assert not rep3.clean


def test_write_baseline_refuses_engine_findings(tmp_path):
    """The no-engine-entries policy lives in the mechanism: an engine
    finding refuses to baseline (nothing written)."""
    pkg = tmp_path / PKG / "engine"
    pkg.mkdir(parents=True)
    (pkg / "protocol.py").write_text(PROTO_OK)
    (pkg / "evil.py").write_text(SEEDED)
    with pytest.raises(ValueError, match="engine-layer"):
        runner.update_baseline(str(tmp_path))
    base = tmp_path / PKG / "analysis" / "splint_baseline.txt"
    assert not base.exists()
    # the same hazard outside the engine layer baselines fine
    ops = tmp_path / PKG / "ops"
    ops.mkdir()
    (pkg / "evil.py").rename(ops / "evil.py")
    base.parent.mkdir()
    runner.update_baseline(str(tmp_path))
    text = base.read_text()
    assert "SPL201" in text and f"{PKG}/ops/evil.py" in text
    assert not (tmp_path / "libsplinter_tpu").exists()


def test_write_baseline_roundtrip(tmp_path):
    f = core.Finding(f"{PKG}/ops/x.py", 3, "SPL102", "msg")
    path = tmp_path / "b.txt"
    core.write_baseline(str(path), [f])
    assert core.load_baseline(str(path)) == {f.fingerprint()}


def test_unknown_rule_selection_fails_loudly():
    ctx = make_ctx()
    with pytest.raises(ValueError, match="SPL999"):
        runner.run_rules(ctx, ["SPL999"])
    with pytest.raises(ValueError, match="SPL205"):
        runner.scan(ctx=ctx, rule_ids=["SPL101", "SPL205"])


# ------------------------------------------- SPL204: fault-path RNG

@pytest.mark.parametrize("draw, seeded", [
    ("random.random()", "rng.random()"),
    ("np.random.rand()", "rng.random()"),
    ("torch.rand(1).item()", "torch.rand(1, generator=g).item()"),
    ("torch.randn(1).item()", "torch.randn(1, generator=g).item()"),
    ("torch.randint(0, 2, (1,)).item()",
     "torch.randint(0, 2, (1,), generator=g).item()"),
    ("torch.multinomial(p, 1).item()",
     "torch.multinomial(p, 1, generator=g).item()"),
], ids=["random", "np_random", "torch_rand", "torch_randn",
        "torch_randint", "torch_multinomial"])
def test_global_rng_in_fault_path_flagged(draw, seeded):
    src = ("import random\nimport numpy as np\nimport torch\n"
           "def step(rng, g, p):\n"
           "    fault('x.y')\n"
           f"    if {draw} < 0.5:\n"
           "        return 1\n")
    fs = run_rule("SPL204", files={ENGINE: src})
    assert len(fs) == 1 and fs[0].line == 6, fs
    assert run_rule("SPL204", files={ENGINE: src.replace(draw, seeded)}) \
        == []
    # the same draw outside a fault path is not this rule's business
    assert run_rule("SPL204", files={
        ENGINE: src.replace("    fault('x.y')\n", "")}) == []


def test_torch_rng_state_calls_not_flagged():
    src = ("import torch\n"
           "def step():\n"
           "    fault('x.y')\n"
           "    torch.random.manual_seed(0)\n"
           "    return torch.randn_like\n")
    assert run_rule("SPL204", files={ENGINE: src}) == []


# ----------------------------------------------- meta + report shape

def _readme_table():
    with open(os.path.join(ROOT, "README.md")) as f:
        text = f.read()
    begin = text.index(core.RULES_BEGIN)
    end = text.index(core.RULES_END)
    return text[begin + len(core.RULES_BEGIN):end]


def test_rule_catalog_matches_readme_table():
    """The port's rule table in README.md (between the port's own
    markers) lists exactly the rules that run, and is what
    render_rule_table() renders."""
    table = _readme_table()
    assert set(re.findall(r"\| `(SPL\d+)` \|", table)) == set(core.RULES)
    assert table.strip() == core.render_rule_table()


def test_port_catalog_is_its_own():
    assert set(core.RULES) == {"SPL001", "SPL101", "SPL102", "SPL103",
                               "SPL104", "SPL105", "SPL106", "SPL107",
                               "SPL108", "SPL201", "SPL204"}
    assert "splint:rule-catalog" not in core.RULES_BEGIN + core.RULES_END
    with open(os.path.join(ROOT, "docs", "operations.md")) as f:
        assert core.RULES_BEGIN not in f.read()


def test_report_line_format():
    f = core.Finding("a/b.py", 7, "SPL101", "boom")
    assert f.render() == "a/b.py:7 · SPL101 · boom"
    assert f.fingerprint() == "SPL101 · a/b.py · boom"


def test_every_rule_has_fixture_coverage():
    """Each cataloged rule id must appear in this test file beyond the
    catalog itself — a rule without a fixture is unverified."""
    with open(os.path.abspath(__file__)) as f:
        me = f.read()
    for rid in core.RULES:
        assert me.count(f'"{rid}"') >= 2, f"no fixture exercises {rid}"


# --------------------------------- held against the JAX package's splint
#
# The port's core, registry, registry_rules and runner are the JAX
# package's with the port's paths (tests/test_torch_imports.py holds the
# text).  Here both splints run on the same inputs and must find the same
# things: every fixture below through both, and the port's live tree
# through the JAX splint given the port's paths.  The JAX splint is
# loaded through its own `_load.py` under a module name of its own, so
# its RULES are this module's alone and the `_splint_analysis` that the
# JAX package's tests and scripts share is never touched.

JAX_PKG = "libsplinter_tpu"


@pytest.fixture(scope="module")
def jax_splint():
    spec = importlib.util.spec_from_file_location(
        "_splint_torch_test_jax_load",
        os.path.join(ROOT, JAX_PKG, "analysis", "_load.py"))
    load = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(load)
    name = "_splint_torch_test_jax_reference"
    pkg = load.load(name)
    yield types.SimpleNamespace(
        pkg=JAX_PKG, core=load.submodule(pkg, "core"),
        registry=load.submodule(pkg, "registry"),
        registry_rules=load.submodule(pkg, "registry_rules"),
        runner=load.submodule(pkg, "runner"))
    for mod in [m for m in sys.modules if m.split(".")[0] == name]:
        del sys.modules[mod]


PORT_SPLINT = types.SimpleNamespace(pkg=PKG, core=core, registry=R,
                                    runner=runner)


def _moved(rel, pkg):
    """A port-relative fixture path as it lies in package `pkg`."""
    return pkg + rel[len(PKG):] if rel.startswith(PKG + "/") else rel


def _ctx_of(side, files=None, proto=PROTO_OK, docs=None, tests_text="",
            fault_docs=None):
    """make_ctx through the splint `side` (the port's or the JAX
    package's), the fixture's files moved into that side's package."""
    files = {_moved(rel, side.pkg): text
             for rel, text in (files or {}).items()}
    reg = side.registry
    return side.core.Context(
        registry=reg.extract_registry(source=proto),
        files={rel: side.core.SourceFile(rel, text)
               for rel, text in files.items()},
        fault_sites=reg.fault_sites(sources=files),
        fault_site_docs=(reg.FAULT_SITE_DOCS if fault_docs is None
                         else fault_docs),
        docs=docs or {},
        tests_text=tests_text,
        protocol_relpath=_moved(PROTO_RELPATH, side.pkg))


# rules whose messages the port words for itself: SPL103 names the
# port's registry file after its " — " where the JAX rule says to
# regenerate the docs; SPL106 says the port's protocol and sites must
# stay the JAX package's where the JAX rule says the page is stale.  The
# rest of each finding is compared.
PORT_WORDED = {"SPL103": lambda m: m.split(" — ")[0],
               "SPL106": lambda m: ""}


def _as_port(findings, pkg):
    """(file, line, rule, message) in the port's paths, the message as
    far as the port words it as the JAX package does."""
    out = []
    for f in findings:
        msg = f.message.replace(pkg + "/", PKG + "/") if pkg != PKG \
            else f.message
        msg = PORT_WORDED.get(f.rule, str)(msg)
        out.append((_moved_back(f.file, pkg), f.line, f.rule, msg))
    return sorted(out)


def _moved_back(rel, pkg):
    return PKG + rel[len(pkg):] if rel.startswith(pkg + "/") else rel


def _with_live_proto():
    with open(os.path.join(ROOT, PROTO_RELPATH)) as f:
        return f.read()


_OP_DOC = "| `new.site` | somewhere |"
_METRICS_OK = ("from ..engine import protocol as P\n"
               "KEYS = [P.KEY_EMBED_STATS]\n")

# every registry-rule fixture of this file, positive and negative
SHARED_CASES = {
    "label_collision": dict(
        proto=PROTO_OK + "LBL_EVIL = 0x40        # collides with LBL_B\n"),
    "field_collision": dict(
        proto=PROTO_OK + "LBL_EVIL = 0x1 << 50   # inside TENANT_MASK\n"),
    "bit_index_mismatch": dict(
        proto=PROTO_OK.replace("BIT_B = 6", "BIT_B = 7")),
    "live_protocol": dict(proto=_with_live_proto()),
    "raw_high_shift": dict(files={ENGINE: "MASK = 1 << 57\n"}),
    "raw_label_api": dict(files={ENGINE: (
        "def f(store, key):\n    store.label_or(key, 0x40)\n")}),
    "raw_label_bitop": dict(files={ENGINE: (
        "def f(labels):\n    return labels & 0x40\n")}),
    "innocent_literals": dict(files={
        ENGINE: ("def f(v, store):\n"
                 "    buf = bytearray(0x40)\n"
                 "    store.set('k', 'x' * 64)\n"
                 "    return v & 0x3F\n"),
        PROTO_RELPATH: "LBL_B = 0x40\nX = LBL_B & 0x40\n"}),
    "undocumented_site": dict(
        files={ENGINE: "def f():\n    fault('new.site')\n"},
        tests_text="new.site"),
    "site_missing_from_ops_doc": dict(
        files={ENGINE: "def f():\n    fault('new.site')\n"},
        fault_docs={"new.site": "somewhere"},
        docs={"operations": "no table here"}),
    "site_in_ops_doc": dict(
        files={ENGINE: "def f():\n    fault('new.site')\n"},
        fault_docs={"new.site": "somewhere"},
        docs={"operations": _OP_DOC}, tests_text="new.site"),
    "chaos_unreached": dict(
        files={ENGINE: "def f():\n    fault('lonely.site')\n"},
        tests_text="tests mention other.site only"),
    "chaos_reached": dict(
        files={ENGINE: "def f():\n    fault('lonely.site')\n"},
        tests_text="SPTPU_FAULT=lonely.site:crash@1"),
    "metrics_clean": dict(files={f"{PKG}/cli/metrics.py": _METRICS_OK}),
    "metrics_hardcoded": dict(files={f"{PKG}/cli/metrics.py": (
        _METRICS_OK + "BAD = '__embedder_stats'\n")}),
    "metrics_unrendered": dict(
        proto=PROTO_OK + 'KEY_NEWLANE_STATS = "__newlane_stats"\n',
        files={f"{PKG}/cli/metrics.py": _METRICS_OK}),
    "metrics_unknown_key": dict(
        files={f"{PKG}/cli/metrics.py": "K = '__mystery_key'\n"}),
    "doc_tables_stale": dict(
        docs={"operations": "stale", "bloom-labels": "stale"}),
    "stage_tracer_typo": dict(files={ENGINE: (
        "def f(tracer):\n"
        "    tracer.record('search.scoree', 1.0)\n"
        "    tracer.record('search.score', 1.0)\n"
        "    tracer.record('search.e2e', 1.0)\n")}),
    "stage_span_typo": dict(files={ENGINE: (
        "def f(span, r):\n"
        "    span(r, 'wake', 1.0)\n"
        "    span(r, 'jion', 1.0)\n")}),
    "suppression_no_reason": dict(files={ENGINE: (
        "x = 1  # splint: ignore[SPL102]\n")}),
    "suppression_unknown_rule": dict(files={ENGINE: (
        "x = 1  # splint: ignore[SPL999] reason=no such rule\n")}),
    "rng_random": dict(files={ENGINE: (
        "import random\n"
        "def step(rng):\n"
        "    fault('x.y')\n"
        "    if random.random() < 0.5:\n"
        "        return rng.random()\n")}),
    "rng_np_random": dict(files={ENGINE: (
        "import numpy as np\n"
        "def step(rng):\n"
        "    fault('x.y')\n"
        "    return np.random.rand() + rng.random()\n")}),
    "drain_bad": dict(files={ENGINE: DRAIN_BAD}),
}
# the rules each fixture is for, by the first word of its name
_CASE_RULE = {"label": ("SPL101",), "field": ("SPL101",),
              "bit": ("SPL108",), "live": ("SPL101", "SPL108"),
              "raw": ("SPL102",), "innocent": ("SPL102",),
              "undocumented": ("SPL103",), "site": ("SPL103",),
              "chaos": ("SPL104",), "metrics": ("SPL105",),
              "doc": ("SPL106",), "stage": ("SPL107",),
              "suppression": ("SPL001",), "rng": ("SPL204",),
              "drain": ("SPL201",), "sync": ("SPL201",)}
# SPL201's forms that both rules know, each hazard beside its clean twin
for _form, _hazard, _twin in SYNC_FORMS:
    if _twin != "helper":
        SHARED_CASES[f"sync_{_form}"] = dict(
            files={ENGINE: _drain_src(_hazard)})
        SHARED_CASES[f"sync_{_form}_twin"] = dict(
            files={ENGINE: _drain_src(_twin)})


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_rules_find_what_the_jax_splints_find(case, jax_splint):
    """Every rule the port shares with the JAX splint finds the same
    things on the same fixture, apart from the package in the paths.
    The fixtures hold only SPL201 forms both rules know, but for
    DRAIN_BAD, whose torch forms on lines 8 and 12 (`.tolist()`,
    `torch.cuda.synchronize()`) the port's rule alone finds."""
    kw = SHARED_CASES[case]
    rules = sorted(core.RULES)
    port = _as_port(runner.run_rules(_ctx_of(PORT_SPLINT, **kw), rules),
                    PKG)
    ref = _as_port(jax_splint.runner.run_rules(
        _ctx_of(jax_splint, **kw), rules), JAX_PKG)
    if case == "drain_bad":
        port = [f for f in port
                if not (f[2] == "SPL201" and f[1] in (8, 12))]
    assert port == ref
    # and the fixture's own rule finds what the fixture is for
    rid = _CASE_RULE[case.split("_")[0]]
    mine = [f for f in port if f[2] in rid]
    negative = case.endswith(("_twin", "_clean", "_reached")) or case in (
        "live_protocol", "innocent_literals", "site_in_ops_doc")
    assert bool(mine) != negative, port


@pytest.mark.parametrize("form, hazard, twin", [
    f for f in SYNC_FORMS if f[2] == "helper"], ids=[
        f[0] for f in SYNC_FORMS if f[2] == "helper"])
def test_torch_sync_forms_are_the_ports_widening(form, hazard, twin,
                                                 jax_splint):
    """The torch host syncs are what the port's SPL201 adds to the JAX
    rule: the JAX splint finds nothing there, the port's one finding."""
    kw = dict(files={ENGINE: _drain_src(hazard)})
    assert jax_splint.runner.run_rules(_ctx_of(jax_splint, **kw),
                                       ["SPL201"]) == []
    assert len(runner.run_rules(_ctx_of(PORT_SPLINT, **kw),
                                ["SPL201"])) == 1


def test_suppressions_and_baseline_match_the_jax_splints(jax_splint,
                                                         tmp_path):
    """scan() over a hazard both rules know, bare, suppressed with a
    reason and baselined: the same findings, suppressions and baseline
    fingerprints from both splints."""
    bare = _drain_src("t = int(self.m.sample(self.logits))",
                      "run_continuous")
    kept = bare.replace(
        "        t =", "        # splint: ignore[SPL201] reason=measured: "
        "the fetch overlaps the next dispatch\n        t =")
    reps = {}
    for side in (PORT_SPLINT, jax_splint):
        base = tmp_path / f"{side.pkg}.txt"
        first = side.runner.scan(ctx=_ctx_of(side, files={ENGINE: bare}),
                                 use_baseline=False, rule_ids=["SPL201"])
        side.core.write_baseline(str(base), first.findings)
        reps[side.pkg] = [
            (_as_port(first.findings, side.pkg), base.read_text().replace(
                side.pkg + "/", PKG + "/").splitlines()[-1])]
        for src, path in ((kept, None), (bare, str(base))):
            rep = side.runner.scan(
                ctx=_ctx_of(side, files={ENGINE: src}),
                baseline_path=path, use_baseline=path is not None,
                rule_ids=["SPL201", "SPL001"])
            reps[side.pkg].append((
                _as_port(rep.findings, side.pkg),
                [(_moved_back(f.file, side.pkg), f.line, f.rule, s.reason)
                 for f, s in rep.suppressed],
                _as_port(rep.baselined, side.pkg)))
    assert reps[PKG] == reps[JAX_PKG]
    assert len(reps[PKG][0][0]) == 1 and len(reps[PKG][1][1]) == 1 \
        and len(reps[PKG][2][2]) == 1


def test_live_port_tree_as_the_jax_splint_sees_it(jax_splint, monkeypatch):
    """The JAX splint given the port's paths (scanned tree, protocol,
    fault-site directories, metrics file, engine prefix) finds on the
    port's tree what the port's splint finds: before suppression the two
    SPL201 host syncs and nothing from the registry rules; after it,
    nothing, with the same two suppressions and reasons."""
    j = jax_splint
    for ref, port, name in ((j.registry, R, "PROTOCOL_RELPATH"),
                            (j.registry, R, "FAULT_SCAN_RELPATHS"),
                            (j.registry_rules, RR, "_METRICS_RELPATH"),
                            (j.runner, runner, "SCAN_RELPATHS"),
                            (j.runner, runner, "ENGINE_PREFIX")):
        monkeypatch.setattr(ref, name, getattr(port, name))
    rules = sorted(core.RULES)
    ctxs = [side.build_context(ROOT) for side in (runner, j.runner)]
    assert sorted(ctxs[0].files) == sorted(ctxs[1].files)
    reps = [side.scan(ROOT, use_baseline=False, rule_ids=rules, ctx=ctx)
            for side, ctx in zip((runner, j.runner), ctxs)]
    # before suppression: every finding, suppressed or not
    raw = [_as_port(rep.findings + [f for f, _ in rep.suppressed], pkg)
           for rep, pkg in zip(reps, (PKG, JAX_PKG))]
    assert raw[0] == raw[1]
    assert [(f[0], f[2]) for f in raw[0]] == [
        (f"{PKG}/engine/completer.py", "SPL201"),
        (f"{PKG}/engine/embedder.py", "SPL201")]
    assert all(rep.clean for rep in reps)
    sups = [[(f.file, f.line, f.rule, s.reason) for f, s in rep.suppressed]
            for rep in reps]
    assert sups[0] == sups[1] and len(sups[0]) == 2
    assert reps[0].files_scanned == reps[1].files_scanned


# ----------------------------------------------- isolation from JAX's

_ISOLATION = """
import importlib.util, os, sys
root = {root!r}
sys.path.insert(0, root)


def load_port():
    import libsplinter_tpu_torch.analysis as port
    return port


def load_jax():
    spec = importlib.util.spec_from_file_location(
        "_splint_load", os.path.join(root, "libsplinter_tpu", "analysis",
                                     "_load.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


first, second = {order!r}
mods = {{}}
for which in (first, second):
    mods[which] = load_port() if which == "port" else load_jax()
jax_core = sys.modules[mods["jax"].__name__ + ".core"]
port_core = sys.modules["libsplinter_tpu_torch.analysis.core"]
want = {{"SPL001", "SPL201", "SPL202", "SPL203", "SPL204", "SPL205"}} | {{
    f"SPL10{{i}}" for i in range(1, 9)}}
assert set(jax_core.RULES) == want, sorted(jax_core.RULES)
with open(os.path.join(root, "docs", "operations.md")) as f:
    assert jax_core.render_rule_table() in f.read()
assert set(port_core.RULES) == want - {{"SPL202", "SPL203", "SPL205"}}
assert jax_core.RULES is not port_core.RULES
assert mods["jax"].__name__ == "_splint_analysis"
for name, mod in list(sys.modules.items()):
    home = os.path.dirname(getattr(mod, "__file__", None) or "")
    if name.startswith("_splint_analysis"):
        assert home == os.path.join(root, "libsplinter_tpu", "analysis"), name
    if name.startswith("libsplinter_tpu_torch.analysis"):
        assert home == os.path.join(root, "libsplinter_tpu_torch",
                                    "analysis"), name
print("ISOLATED", first, second)
"""


@pytest.mark.parametrize("order", [("port", "jax"), ("jax", "port")],
                         ids=["port_first", "jax_first"])
def test_jax_splint_undisturbed_by_the_ports(order):
    """Loading the port's splint and the JAX package's (through its own
    `_load.py`) in one process, in either order, leaves the JAX
    catalog exactly SPL001, SPL101-108, SPL201-205 and its rendered
    table the one in docs/operations.md."""
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATION.format(root=ROOT, order=order)],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert f"ISOLATED {order[0]} {order[1]}" in out.stdout


def test_port_splint_needs_no_torch_and_no_jax():
    """The analysis package and `lint` run where torch, JAX and the JAX
    package cannot be imported."""
    code = f"""
import sys
for name in ("torch", "jax", "jaxlib", "flax", "libsplinter_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
from libsplinter_tpu_torch.cli.main import main
rc = main(["lint"])
assert not [m for m in sys.modules if m.split(".")[0] in
            ("torch", "jax", "libsplinter_tpu") and sys.modules[m] is not None]
assert "_splint_analysis" not in sys.modules
print("RC", rc)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "RC 0" in out.stdout
    assert "splint: 0 finding(s), 2 suppressed" in out.stdout
