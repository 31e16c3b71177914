"""The torch port stands alone: it imports neither JAX (nor flax or
safetensors) nor anything of the JAX package, and its copies of the
JAX package's jax-free modules stay copies — the protocol above all,
whose label bits, key names and JSON contracts let torch and JAX
daemons share one store."""
import ast
import filecmp
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "libsplinter_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "safetensors", "libsplinter_tpu")

# modules copied verbatim from the JAX package (imports are relative,
# so not even those changed)
VERBATIM = ("_native.py", "utils/faults.py",
            "engine/protocol.py", "engine/qos.py", "engine/resident.py",
            "engine/client.py", "engine/prefix_cache.py", "obs/hist.py",
            "obs/recorder.py", "obs/prom.py", "obs/spans.py",
            "models/gguf_writer.py", "engine/kv_tier.py",
            "engine/disagg.py", "engine/telemetry.py",
            "engine/autoscaler.py", "engine/pipeliner.py",
            "scripting/__init__.py", "scripting/microlua.py",
            "scripting/sandbox.py", "scripting/library.py",
            "scripting/lua_host.py", "scripting/microwasm.py",
            "scripting/wasm_host.py", "utils/fingerprint.py",
            "cli/__init__.py", "cli/__main__.py", "cli/ingest.py",
            "cli/metrics.py", "cli/top.py", "cli/supervise.py",
            "cli/scale.py", "cli/pipeline.py", "cli/script.py",
            "cli/loadgen.py")

# the parts of models/gguf.py copied unchanged from the JAX package's:
# the container reader, every ggml dequantizer and the tokenizers (the
# config derivation and the weight loaders are the port's own)
GGUF_COPIED = ("GgufError", "TensorInfo", "GgufFile", "_dequant_q8_0",
               "_dequant_q4_0", "_dequant_q4_1", "_dequant_q5_0",
               "_dequant_q5_1", "_kq_blocks", "_scale_min_k4",
               "_dequant_q4_k", "_dequant_q5_k", "_dequant_q6_k",
               "_dequant_q2_k", "_dequant_q3_k", "_dequant_q8_k", "_take",
               "_SpecialTokens", "load_tokenizer", "UnigramTokenizer",
               "_as_gguf", "_MaybeClose", "_gpt2_byte_map",
               "ByteBpeTokenizer")

# the numpy quantizers of models/quant.py, copied unchanged (the torch
# modules and the tree walkers are the port's own)
QUANT_COPIED = ("quantize_kernel", "dequantize_kernel",
                "quantize_channel_kernel", "dequantize_channel_kernel")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path}: imports {name}"


def test_whole_port_imports_with_jax_blocked():
    """Every module of the package, and chip_smoke.py, imports in a
    fresh interpreter where importing JAX or the JAX package fails."""
    code = f"""
import importlib, importlib.util, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
import libsplinter_tpu_torch
# a package's __main__ runs its entry point when imported
mods = [m.name for m in pkgutil.walk_packages(
    libsplinter_tpu_torch.__path__, "libsplinter_tpu_torch.")
    if not m.name.endswith(".__main__")]
assert "libsplinter_tpu_torch.cli.search" in mods
for m in mods:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules
          if m.split(".")[0] in {FORBIDDEN!r} and sys.modules[m] is not None]
assert not leaked, leaked
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_stay_verbatim(rel):
    assert filecmp.cmp(PORT / rel, ROOT / "libsplinter_tpu" / rel,
                       shallow=False), rel


def _without_store_list(path):
    """store.py's text with Store.list's lines taken out."""
    text = path.read_text()
    tree = ast.parse(text)
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "Store")
    fn = next(n for n in cls.body
              if isinstance(n, ast.FunctionDef) and n.name == "list")
    lines = text.splitlines()
    return lines[:fn.lineno - 1] + lines[fn.end_lineno:]


def test_store_copy_differs_only_in_list():
    """store.py is the JAX package's but for Store.list, which the port
    reads in one copy of the key buffer (the JAX package's copies the
    whole buffer once per key: minutes at 250,000 keys, where the
    supervisor and the searcher list keys every poll)."""
    assert _without_store_list(PORT / "store.py") == \
        _without_store_list(ROOT / "libsplinter_tpu" / "store.py")


def _search_lines(path):
    """cli/search.py's text without the parts the port owns: the module
    docstring, the command's help text, the body of the --sharded
    branch, `_local_search`, `_bucket` and the line importing it."""
    text = path.read_text()
    tree = ast.parse(text)
    lines = text.splitlines()
    cut = set(range(tree.body[0].lineno - 1, tree.body[0].end_lineno))
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        if fn.name in ("_local_search", "_bucket"):
            cut |= set(range(fn.lineno - 1, fn.end_lineno))
        for deco in fn.decorator_list:
            cut |= set(range(deco.lineno - 1, deco.end_lineno))
        for node in ast.walk(fn):
            if isinstance(node, ast.If) and "sharded" in \
                    ast.unparse(node.test):
                cut |= set(range(node.lineno, node.body[-1].end_lineno))
    kept = [ln for i, ln in enumerate(lines) if i not in cut
            and "sharded_search import _bucket" not in ln]
    while kept and not kept[-1].strip():
        kept.pop()
    return kept


def test_search_copy_differs_only_in_local_path():
    """cli/search.py follows the JAX package's line by line except in
    `_local_search` (the port's K3 on the session lane's device), the
    --sharded branch (a refusal until the multi-GPU slice) and
    `_bucket`, which the port keeps in the module (the JAX package
    imports it from parallel/sharded_search.py, which the port lacks) —
    and in the docstring and help text that say so."""
    import inspect

    from libsplinter_tpu.parallel import sharded_search as ref

    from libsplinter_tpu_torch.cli import search as port
    assert _search_lines(PORT / "cli" / "search.py") == \
        _search_lines(ROOT / "libsplinter_tpu" / "cli" / "search.py")
    assert inspect.getsource(port._bucket) == inspect.getsource(ref._bucket)


def test_store_list_matches_jax_package():
    import os
    import uuid

    import libsplinter_tpu

    from libsplinter_tpu_torch import Store
    name = f"/spt-tlist-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=1024, max_val=64, vec_dim=0)
    try:
        for i in range(700):
            st.set(f"k/{i}" + "x" * (i % 40), b"v")
        ref = libsplinter_tpu.Store.open(name)
        try:
            want = ref.list()
        finally:
            ref.close()
        got = st.list()
        assert got == want and len(got) == 700
    finally:
        st.close()
        Store.unlink(name)


@pytest.mark.parametrize("name", GGUF_COPIED)
def test_gguf_copied_parts_stay_verbatim(name):
    import inspect

    from libsplinter_tpu.models import gguf as ref

    from libsplinter_tpu_torch.models import gguf as port
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name)), name


@pytest.mark.parametrize("name", QUANT_COPIED)
def test_quant_copied_parts_stay_verbatim(name):
    import inspect

    from libsplinter_tpu.models import quant as ref

    from libsplinter_tpu_torch.models import quant as port
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name)), name


def test_quant_constants_equal():
    """The Q8_0 block width and the leaf sets each model quantizes."""
    from libsplinter_tpu.models import quant as ref

    from libsplinter_tpu_torch.models import quant as port
    for name in ("QBLOCK", "QUANT_LEAVES", "ENCODER_QUANT_LEAVES"):
        assert getattr(port, name) == getattr(ref, name), name


def test_gguf_constants_equal():
    """The ggml type ids, metadata value types and token types."""
    from libsplinter_tpu.models import gguf as ref

    from libsplinter_tpu_torch.models import gguf as port
    names = [n for n in dir(ref) if n.lstrip("_").isupper()
             and isinstance(getattr(ref, n), (int, dict))]
    assert {"GGUF_MAGIC", "QK_K", "GGML_Q6_K", "_T_ARRAY", "_SCALAR_FMT",
            "_TYPE_NAMES", "TOKTYPE_BYTE"} <= set(names)
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name


def test_protocol_constants_equal():
    from libsplinter_tpu.engine import protocol as ref

    from libsplinter_tpu_torch.engine import protocol as port
    names = [n for n in dir(ref) if n.isupper()
             and isinstance(getattr(ref, n), (int, str, bytes, tuple,
                                              frozenset))]
    assert len(names) > 40
    for name in names:
        assert getattr(port, name) == getattr(ref, name), name
    for fn in ("search_result_key", "trace_stamp_key", "compile_ring_key",
               "replica_stats_key"):
        if hasattr(ref, fn):
            args = (7,) if fn != "replica_stats_key" else ("__x", 2)
            assert getattr(port, fn)(*args) == getattr(ref, fn)(*args)


def test_native_abi_constants_equal():
    from libsplinter_tpu import _native as ref

    from libsplinter_tpu_torch import _native as port
    for name in [n for n in dir(ref) if n.isupper()]:
        assert getattr(port, name) == getattr(ref, name), name
    assert port._LIB_PATH == ref._LIB_PATH      # one shared native build
