"""The port's splint protocol registry — ONE machine-readable view of
the cross-file invariants the engine hand-maintains.

`engine/protocol.py` (a verbatim copy of the JAX package's) is the
coordination contract: label bits, stage tuples, well-known keys,
companion-key prefixes.  `utils/faults.py` call sites are the chaos
surface.  They must stay consistent with `docs/api/bloom-labels.md`,
`docs/operations.md` (both rendered from the JAX package, whose fault
sites and labels the port carries under the same names), the chaos
matrix, and `cli/metrics.py`.  This module extracts all of it
STATICALLY (stdlib `ast`, no imports of the package, no torch, no
native lib) so the splint rules and the tests share one source of
truth.
"""
from __future__ import annotations

import ast
import dataclasses
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PROTOCOL_RELPATH = os.path.join("libsplinter_tpu_torch", "engine",
                                "protocol.py")

# Where fault() call sites live (relative to the repo root).  The
# chaos layer instruments the daemons, the device-op layer, and the
# store binding; a site added anywhere else still gets discovered as
# long as its directory is listed here.
FAULT_SCAN_RELPATHS = (
    os.path.join("libsplinter_tpu_torch", "engine"),
    os.path.join("libsplinter_tpu_torch", "ops"),
    os.path.join("libsplinter_tpu_torch", "models"),
    os.path.join("libsplinter_tpu_torch", "store.py"),
)

# The fault-point catalog: site -> operator-facing description, copied
# from the JAX package's registry (the port's sites carry the same
# names).  Splint rule SPL103 fails any `fault("...")` call site that
# has no entry here or no row in docs/operations.md's catalog.
FAULT_SITE_DOCS: dict[str, str] = {
    "searcher.gather":
        "request discovery / param parse, start of the drain",
    "searcher.dispatch":
        "each top-k program dispatch (incl. degradation retries)",
    "searcher.select":
        "each batch's blocking device fetch",
    "searcher.commit":
        "each `__sr_<idx>` result commit",
    "searcher.sweep":
        "the orphaned-result TTL sweep (heartbeat cadence; the "
        "run-loop firewall contains a raise — `drain_faults` counts "
        "it)",
    "embedder.drain":
        "start of the embed drain cycle",
    "embedder.encode":
        "each encode batch's materialize",
    "embedder.commit":
        "each epoch-gated vector batch commit",
    "completer.render":
        "the per-request head (before the SERVICING claim)",
    "completer.generate":
        "entry of the token loop (after the claim)",
    "completer.commit":
        "the per-request tail (READY flip)",
    "completer.sharded_dispatch":
        "each paged decode-chunk dispatch on the POD-SHARDED "
        "continuous lane only (`--tp N --continuous`; a `raise` "
        "aborts the live batch — rows finalize with what they "
        "streamed, the pool rebuilds — and a `crash` drills the "
        "supervised-restart path, `tests/test_crash_recovery.py::"
        "test_supervise_restores_sharded_completer_lane`)",
    "completer.kv_quant_commit":
        "the QUANTIZED append/commit path only (`--kv-dtype int8` "
        "continuous lane): fires after a request is claimed and "
        "right before the commit scatter quantizes its prompt K/V "
        "into int8 pages — a `crash` dies with half-written pool "
        "state and proves the restart serves from a clean pool, no "
        "poisoned pages (`tests/chaos_child.py completer_quant`; "
        "`tests/test_crash_recovery.py::"
        "test_supervise_restores_quantized_commit_crash`)",
    "completer.weight_quant":
        "the daemon's per-output-channel weight-quantization step "
        "(`--weights-int8` / `--weights int8`): fires at boot, "
        "right before the checkpoint is converted to int8-resident "
        "kernels (models/quant.py quantize_decoder_params "
        "mode=\"channel\") — BEFORE any program compiles, so a "
        "`crash` proves the supervisor restart rebuilds the "
        "quantized tree from the float checkpoint with nothing "
        "half-converted (`tests/test_quant_int4.py`)",
    "completer.prefix_map":
        "a prefix-cache HIT's table mapping only (continuous lane, "
        "after the claim, before map_shared bumps any refcount): a "
        "`crash` dies mid table-mapping with the request claimed — "
        "pool, refcounts, and radix tree are host state that die "
        "with the process, so the drill proves the restarted lane "
        "rebuilds a clean pool with zero stranded refcounts and "
        "re-serves the reclaimed request (`tests/chaos_child.py` "
        "completer_prefix; `tests/test_prefix_cache.py::"
        "test_supervised_prefix_map_crash_strands_nothing`)",
    "resident.ring_dispatch":
        "each resident multi-batch ring dispatch (embedder "
        "`--ring-depth`; a `raise` here degrades that ring to the "
        "per-call programs — `ring_faults` counts it)",
    "resident.ring_collect":
        "the whole-ring device→host fetch (a `stall` here models a "
        "device wedged INSIDE a resident program — the supervisor's "
        "hung-heartbeat kill is the recovery path, "
        "`tests/test_resident.py`)",
    "pipeliner.exec":
        "each script execution slice (start + every coroutine "
        "resume) on the pipeline lane: a `raise` fails ONE script "
        "with a typed record while siblings keep running, a `crash` "
        "dies mid-chain with LBL_SCRIPT_REQ still up — the "
        "supervised restart reclaims and re-runs the stranded "
        "scripts (`tests/test_pipeliner.py`)",
    "pipeliner.verb":
        "each async splinter verb a script dispatches "
        "(submit_embed / submit_search / submit_completion / sleep), "
        "before the downstream submit",
    "prefill.handoff":
        "the disaggregated PREFILL lane's page-ownership transfer "
        "(engine/disagg.py): fires after the row's KV pages and "
        "first sampled token are written to the `__ho_<idx>` wire "
        "keys but BEFORE the handoff record that makes them visible "
        "— a `crash` dies with the row SERVICING and half a handoff "
        "on the wire, proving the stripe-scoped reclaim (lane "
        "attach, or the supervisor's post-reap sweep) drops the "
        "orphan wire keys and re-queues the request to WAITING with "
        "zero loss (`tests/chaos_child.py prefill_lane`; "
        "`tests/test_disagg.py`)",
    "decode.adopt":
        "the disaggregated DECODE lane's row adoption (engine/"
        "disagg.py): fires after the DECODE_READY row is claimed "
        "(SERVICING set) but before its wire pages are imported "
        "into the decode pool — a `crash` dies holding an adopted "
        "row, proving recovery rolls it BACK to bare DECODE_READY "
        "truncated to the record's prompt length for a surviving "
        "replica to re-adopt from the carry token "
        "(`tests/chaos_child.py decode_lane`; "
        "`tests/test_disagg.py`)",
    "tier.spill":
        "the host-DRAM shadow copy of one frozen prefix page "
        "(engine/prefix_cache.py _spill, write-through at insert and "
        "the evictor's second chance): fires before the device "
        "export, so a `crash` dies between \"page frozen in the "
        "tree\" and \"shadow taken\" — the HBM copy stays "
        "authoritative and the unshadowed page simply drops cold at "
        "eviction instead of demoting, proving a mid-spill death "
        "strands nothing and loses no admitted request "
        "(`tests/chaos_child.py tier_completer`; "
        "`tests/test_kv_tier.py::"
        "test_supervised_mid_spill_crash_strands_nothing`)",
    "tier.readmit":
        "each demoted page's DRAM→HBM readmission (engine/"
        "prefix_cache.py readmit, on a tier hit at admission): fires "
        "after the host shadow is fetched but before the pool page "
        "is allocated and imported — a `raise` shortens the hit (the "
        "suffix re-prefills, `tier_readmit_failures` counts it) and "
        "a `crash` dies mid-readmission with the shadow intact and "
        "the node still DRAM-resident, proving the restarted lane "
        "re-serves from a clean pool with zero stranded pages "
        "(`tests/chaos_child.py tier_completer`; "
        "`tests/test_kv_tier.py::"
        "test_supervised_mid_readmit_crash_strands_nothing`)",
    "tier.restore":
        "the warm-restart snapshot adoption (engine/kv_tier.py "
        "TierPersist.load): fires after EVERY byte of the persistent "
        "snapshot has validated and right before the radix chains "
        "are adopted — a `raise` proves the clean cold fallback "
        "(empty tree + tier, typed `tier_restore_reason` "
        "\"restore_failed\" in heartbeat), and a `crash` dies "
        "mid-restore so the supervised respawn (fault stripped) "
        "attaches warm from the SAME untouched snapshot — zero "
        "admitted loss either way (`tests/chaos_child.py "
        "tier_completer`; `tests/test_kv_tier.py::"
        "test_supervised_mid_restore_crash_attaches_warm`)",
    "supervisor.poll":
        "each supervision step",
    "supervisor.retire":
        "the scale-down drain's first move (elastic lanes): fires as "
        "a replica's stripes are marked CLOSED, before the "
        "epoch-bumped map write — a `raise` aborts that poll step "
        "(run()'s step firewall contains it, the replica set stays "
        "as it was), and the chaos drill crash-kills the RETIRING "
        "replica instead, proving the post-reap straggler reclaim "
        "strands nothing (`tests/test_elastic.py`)",
    "autoscaler.decide":
        "each lane's decision step in the scaling controller "
        "(engine/autoscaler.py), before the telemetry rings are "
        "read: a `raise` fails one control cycle (the run loop's "
        "firewall continues; targets keep their last value), a "
        "`crash` kills the controller mid-decision — the supervised "
        "restart resumes from the live policy + targets "
        "(`tests/test_elastic.py`)",
    "store.set":
        "the store binding's `set` write op",
    "store.append":
        "the store binding's `append` write op",
    "store.vec_commit":
        "the store binding's bulk vector-lane commit",
}

# Multi-bit label FIELDS (mask constants that are not single LBL_
# bits) and their doc-table descriptions.  The overlap rule treats
# them exactly like labels: no field may share a bit with any label
# or any other field.
FIELD_DOCS: dict[str, str] = {
    "TENANT_MASK":
        "multi-tenant QoS tenant-id field (ids 1..15; 0 = untagged; "
        "survives the WAITING→SERVICING→READY trifecta)",
}


@dataclasses.dataclass(frozen=True)
class LabelDef:
    """One label constant (or multi-bit field) from protocol.py."""
    name: str
    mask: int
    lineno: int
    comment: str

    @property
    def bits(self) -> tuple[int, ...]:
        return tuple(i for i in range(self.mask.bit_length())
                     if self.mask >> i & 1)


@dataclasses.dataclass
class ProtocolRegistry:
    """The canonical protocol surface, extracted from protocol.py."""
    path: str
    labels: dict[str, LabelDef]            # LBL_*  (single purpose bit)
    fields: dict[str, LabelDef]            # multi-bit fields (FIELD_DOCS)
    bit_indices: dict[str, int]            # BIT_*  (watch registration)
    stages: dict[str, tuple[str, ...]]     # *_STAGES tuples
    keys: dict[str, str]                   # KEY_*  well-known keys
    prefixes: dict[str, str]               # *_PREFIX companion-key pfx
    # elastic lanes: the replica heartbeat-key suffix convention
    # (protocol.REPLICA_SUFFIX — "<KEY_*_STATS><suffix><N>").  Its
    # presence obligates readers: SPL105 requires `spt metrics` to
    # discover replica-suffixed keys via the protocol helper instead
    # of the one-key-per-lane read.
    replica_suffix: str = ""

    def masks(self) -> dict[str, int]:
        """name -> mask for every label AND field."""
        out = {n: d.mask for n, d in self.labels.items()}
        out.update({n: d.mask for n, d in self.fields.items()})
        return out

    def mask_bits(self) -> dict[int, str]:
        """bit index -> owning label/field name (post-overlap-check
        this is well defined; pre-check, last writer wins)."""
        out: dict[int, str] = {}
        for name, d in {**self.labels, **self.fields}.items():
            for b in d.bits:
                out[b] = name
        return out

    def high_bits(self) -> set[int]:
        """Label bits >= 32 — the range where a bare `1 << N` in code
        can only plausibly mean a label bit."""
        return {b for b in self.mask_bits() if b >= 32}

    def stage_names(self) -> set[str]:
        return {s for tup in self.stages.values() for s in tup}


class _ConstEval(ast.NodeVisitor):
    """Evaluate the constant integer/str expressions protocol.py uses
    for its module-level assignments (literals, <<, |, &, -, +, ~,
    and references to previously bound module constants)."""

    def __init__(self, env: dict[str, object]):
        self.env = env

    def eval(self, node: ast.AST):
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            raise ValueError(f"unresolved name {node.id}")
        if isinstance(node, ast.BinOp):
            lhs, rhs = self.eval(node.left), self.eval(node.right)
            op = type(node.op)
            if op is ast.LShift:
                return lhs << rhs
            if op is ast.RShift:
                return lhs >> rhs
            if op is ast.BitOr:
                return lhs | rhs
            if op is ast.BitAnd:
                return lhs & rhs
            if op is ast.BitXor:
                return lhs ^ rhs
            if op is ast.Add:
                return lhs + rhs
            if op is ast.Sub:
                return lhs - rhs
            if op is ast.Mult:
                return lhs * rhs
            raise ValueError(f"unsupported operator {op.__name__}")
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand)
            if isinstance(node.op, ast.Invert):
                return ~v
            if isinstance(node.op, ast.USub):
                return -v
            raise ValueError("unsupported unary op")
        if isinstance(node, ast.Tuple):
            return tuple(self.eval(e) for e in node.elts)
        raise ValueError(
            f"unsupported constant expression ({ast.dump(node)[:60]})")


def _trailing_comment(lines: list[str], lineno: int) -> str:
    """The inline `# ...` comment on a 1-based source line (protocol's
    label definitions each carry their meaning there — the generated
    doc table reuses it verbatim, so the doc cannot drift)."""
    line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
    if "#" in line:
        return line.split("#", 1)[1].strip()
    return ""


def extract_registry(path: str | None = None,
                     source: str | None = None) -> ProtocolRegistry:
    """Parse protocol.py (or an explicit `source` for fixtures) into
    the registry.  Purely static — never imports the module."""
    if path is None:
        path = os.path.join(REPO_ROOT, PROTOCOL_RELPATH)
    if source is None:
        with open(path) as f:
            source = f.read()
    tree = ast.parse(source)
    lines = source.splitlines()

    env: dict[str, object] = {}
    ev = _ConstEval(env)
    labels: dict[str, LabelDef] = {}
    fields: dict[str, LabelDef] = {}
    bit_indices: dict[str, int] = {}
    stages: dict[str, tuple[str, ...]] = {}
    keys: dict[str, str] = {}
    prefixes: dict[str, str] = {}
    replica_suffix = ""

    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        name = tgt.id
        try:
            value = ev.eval(node.value)
        except ValueError:
            continue                  # runtime expression: not registry
        env[name] = value
        cmt = _trailing_comment(lines, node.lineno)
        if name.startswith("LBL_") and isinstance(value, int):
            labels[name] = LabelDef(name, value, node.lineno, cmt)
        elif name in FIELD_DOCS and isinstance(value, int):
            fields[name] = LabelDef(name, value, node.lineno,
                                    cmt or FIELD_DOCS[name])
        elif name.startswith("BIT_") and isinstance(value, int):
            bit_indices[name] = value
        elif name.endswith("_STAGES") and isinstance(value, tuple):
            stages[name] = tuple(str(s) for s in value)
        elif name.startswith("KEY_") and isinstance(value, str):
            keys[name] = value
        elif name.endswith("_PREFIX") and isinstance(value, str):
            prefixes[name] = value
        elif name == "REPLICA_SUFFIX" and isinstance(value, str):
            replica_suffix = value
    return ProtocolRegistry(path=path, labels=labels, fields=fields,
                            bit_indices=bit_indices, stages=stages,
                            keys=keys, prefixes=prefixes,
                            replica_suffix=replica_suffix)


# --- fault-site discovery -------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSite:
    site: str
    relpath: str
    lineno: int


def _iter_py(root: str, rel: str):
    path = os.path.join(root, rel)
    if os.path.isfile(path):
        yield rel
        return
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, fn), root)


def fault_sites(root: str | None = None,
                sources: dict[str, str] | None = None
                ) -> list[FaultSite]:
    """Every `fault("<site>")` call site across the instrumented
    layers, discovered by AST.  `sources` (relpath -> text) overrides
    the filesystem for fixtures."""
    root = root or REPO_ROOT
    out: list[FaultSite] = []
    if sources is None:
        sources = {}
        for rel in FAULT_SCAN_RELPATHS:
            for r in _iter_py(root, rel):
                with open(os.path.join(root, r)) as f:
                    sources[r] = f.read()
    for rel in sorted(sources):
        try:
            tree = ast.parse(sources[rel])
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name != "fault" or not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                            str):
                out.append(FaultSite(arg.value, rel.replace(os.sep, "/"),
                                     node.lineno))
    return out


# --- doc tables -----------------------------------------------------------
# docs/api/bloom-labels.md (label table) and docs/operations.md (fault
# catalog) hold these tables as the JAX package renders them.  Splint
# rule SPL106 renders both from the port's registry and fails when
# either is missing from its page, so the port's protocol and fault
# sites cannot drift from the documented ones.


def _bits_str(d: LabelDef) -> str:
    bits = d.bits
    if not bits:
        return "—"
    if len(bits) == 1:
        return str(bits[0])
    lo, hi = bits[0], bits[-1]
    if bits == tuple(range(lo, hi + 1)):
        return f"{lo}–{hi}"
    return ", ".join(str(b) for b in bits)


def render_label_table(reg: ProtocolRegistry) -> str:
    """The bloom-label bit map, straight from protocol.py: name, bit
    position(s), mask, and the inline comment as the meaning."""
    rows = ["| label | bit(s) | mask | meaning |",
            "|---|---|---|---|"]
    defs = sorted({**reg.labels, **reg.fields}.values(),
                  key=lambda d: (d.bits[0] if d.bits else -1))
    for d in defs:
        meaning = d.comment or FIELD_DOCS.get(d.name, "")
        meaning = meaning.replace("|", "\\|")
        rows.append(f"| `{d.name}` | {_bits_str(d)} | `{d.mask:#x}` "
                    f"| {meaning} |")
    return "\n".join(rows)


def render_fault_table(sites: list[FaultSite] | None = None,
                       root: str | None = None) -> str:
    """The fault-point catalog table: one row per DISCOVERED site (so
    an undocumented site shows up as a blank row in review even
    before splint flags it), descriptions from FAULT_SITE_DOCS."""
    if sites is None:
        sites = fault_sites(root)
    seen: dict[str, str] = {}
    for s in sites:
        seen.setdefault(s.site, FAULT_SITE_DOCS.get(s.site, ""))
    # documented-but-vanished sites are splint SPL103's problem; the
    # table renders only what the tree actually instruments
    rows = ["| site | where it fires |",
            "|---|---|"]
    for site in sorted(seen, key=_site_order):
        rows.append(f"| `{site}` | {seen[site]} |")
    return "\n".join(rows)


def _site_order(site: str) -> tuple:
    """Catalog ordering: group by lane prefix in the runbook's
    traditional order, then by name."""
    prefix = site.split(".", 1)[0]
    order = {"searcher": 0, "embedder": 1, "completer": 2,
             "pipeliner": 3, "resident": 4, "supervisor": 5,
             "store": 6}
    return (order.get(prefix, 9), site)

