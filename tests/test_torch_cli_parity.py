"""The torch port's CLI held against the JAX package's on the CPU.

(a) Transcripts: one command sequence goes through both packages'
`main` on two fresh stores of one geometry; stdout and exit codes are
equal after the masks named in MASKS (store names, pids, uuids,
timestamps, heartbeat ages) and the lines the port changes on purpose
(CHANGED: `caps`' runtime line, `help`'s `search` and `lint` lines);
`ingest` reads one fixed clock in both.

(b) Local search: both packages search one store of 4,096 rows x 64-d
from a numpy seed (no tied scores): the JAX CLI's `search --local
--json` (its CPU default) against the port's `search --local --cpu
--json`, plain and with --bloom, --regex, --similarity and --distance
cuts — the same keys in the same order, similarity within 1e-5 and
distance within 1e-4 — and --fast (bf16 products on both sides) within
2e-2, its ranks compared only where the gaps exceed 4e-2.  The
`gpu`-marked case holds the card's local search (K3 at Q = 1) to
--cpu on the same store."""
import contextlib
import io
import json
import os
import re
import threading
import types
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.cli.main import main as port_main
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.embedder import Embedder


def jax_main(argv):
    """The JAX package's CLI entry (imported here, so the gpu case runs
    on a machine without JAX)."""
    from libsplinter_tpu.cli.main import main
    return main(argv)


# (name, pattern, replacement): what varies between two runs of one
# sequence and is not the CLI's doing
MASKS = (
    ("store name", None, "<store>"),
    ("uuid", r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
             r"[0-9a-f]{12}", "<uuid>"),
    ("slot times", r"(ctime|atime)(\"?:?\s+)\d+", r"\1\2<t>"),
    ("pid", r"(pid|owner)(\s+)\d+", r"\1\2<pid>"),
    ("heartbeat age", r"\d+\.\ds ago", "<age> ago"),
    ("bid claim time", r"(?m) \d+(  (yes|no))$", r" <t>\1"),
)

# lines the port changes on purpose
CHANGED = (
    ("caps runtime line", r"^(jax {12}|torch {10}).*$", "<runtime>"),
    ("help: search", r"^  search \[--json\].*$", "<search help>"),
    ("help: lint", r"^  lint \[--rules.*$", "<lint help>"),
)


def _mask(text: str, store: str) -> str:
    text = text.replace(store, "<store>")
    for _, pat, rep in MASKS[1:]:
        text = re.sub(pat, rep, text)
    for _, pat, rep in CHANGED:
        text = re.sub(pat, rep, text, flags=re.M)
    return text


def _sequences(tmp):
    doc = tmp / "doc.txt"
    doc.write_text("lorem ipsum dolor sit amet " * 60)
    lua = tmp / "s.lua"
    lua.write_text('local bus = require("splinter")\n'
                   'bus.set(arg[1], "from cli lua")\n'
                   'print("wrote " .. arg[1], bus.get(arg[1]))\n')
    from test_wasm import host_module
    wasm = tmp / "m.wasm"
    wasm.write_bytes(host_module())
    return {
        "kv": [
            ["init", "128", "512", "16"], ["set", "greet", "hello", "world"],
            ["get", "greet"], ["append", "greet", ", again"],
            ["get", "greet"], ["set", "counter", "41"],
            ["type", "counter", "BIGUINT"], ["type", "counter"],
            ["math", "counter", "inc"], ["math", "counter", "add", "10"],
            ["math", "counter", "bogus"], ["label", "greet", "+0x40"],
            ["label", "greet"], ["label", "greet", "-0x40"],
            ["label", "greet"], ["bump", "greet"], ["bump", "@3"],
            ["set", "doc", "part0"], ["set", "doc.1", "part1"],
            ["set", "doc.2", "part2"], ["orders", "doc"], ["list"],
            ["list", "^d"], ["head", "greet"], ["unset", "greet"],
            ["get", "greet"], ["unset", "doc", "--tandem"], ["list"],
            ["uuid"], ["health"], ["nosuch"], ["get"],
        ],
        "store_ops": [
            ["init", "64", "256", "8"], ["config"],
            ["config", "user", "0x3"], ["config", "mop", "2"],
            ["config"], ["shard", "claim", "0x5F10", "40"],
            ["shard", "who"], ["shard", "table"],
            ["shard", "advise", "0", "willneed"],
            ["shard", "release", "0"], ["shard", "who"],
            ["bind", "3", "7"], ["bind", "3", "7", "--remove"],
            ["config", "purge"], ["help"], ["help", "get"], ["caps"],
        ],
        "ingest_export": [
            ["init", "64", "512", "8"],
            ["ingest", "docs/d1", str(doc), "--no-embed"],
            ["ingest", "docs/d2", str(doc), "--label", "0x100"],
            ["set", "n", "7"], ["type", "n", "BIGUINT"],
            ["export"], ["export", "--regex", "d1"],
            ["export", "--values", "^n$"],
            ["export", "--out", str(tmp / "dump.json")],
        ],
        "search_degraded": [
            ["init", "64", "256", "8"], ["set", "alone", "no daemon"],
            ["set", "other", "text"], ["label", "other", "+0x100"],
            ["search", "--timeout", "50", "--json", "anything"],
            ["search", "--timeout", "50", "--bloom", "0x100", "q"],
            ["search", "--timeout", "50", "--regex", "^al", "q"],
            ["search", "--timeout", "50"], ["search", "--limit"],
        ],
        "scripting": [
            ["init", "64", "256", "8"],
            ["lua", str(lua), "cli_key"], ["get", "cli_key"],
            ["lua", "-e", "print(1 + 2, splinter.get('cli_key'))"],
            ["lua", "-e", "error('boom')"],
            ["lua", "--max-steps", "2000", "-e", "while true do end"],
            ["wasm", str(wasm), "run"], ["get", "wkey"],
            ["wasm", str(tmp / "missing.wasm")],
        ],
    }


# the ingest record's clock (its "ingested_at" sets the record's
# length): one fixed instant for both packages
FIXED_CLOCK = types.SimpleNamespace(time=lambda: 1760000000.25)


def _transcript(main, store, seq, monkeypatch):
    monkeypatch.setenv("SPTPU_DEFAULT_STORE", store)
    monkeypatch.setattr("libsplinter_tpu.cli.ingest.time", FIXED_CLOCK)
    monkeypatch.setattr("libsplinter_tpu_torch.cli.ingest.time",
                        FIXED_CLOCK)
    out = []
    try:
        for argv in seq:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rc = main(list(argv))
            out.append((argv[0], rc, _mask(buf.getvalue(), store)))
    finally:
        Store.unlink(store)
    return out


@pytest.mark.parametrize("seq", ["kv", "store_ops", "ingest_export",
                                 "search_degraded", "scripting"])
def test_transcripts_equal(seq, tmp_path, monkeypatch):
    monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)
    monkeypatch.setenv("SPTPU_RC", str(tmp_path / "no-rc"))
    cmds = _sequences(tmp_path)[seq]
    tag = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
    ref = _transcript(jax_main, f"/spt-tpar-j-{tag}", cmds, monkeypatch)
    got = _transcript(port_main, f"/spt-tpar-t-{tag}", cmds, monkeypatch)
    assert len(got) == len(ref)
    for (name, rc_r, out_r), (_, rc_g, out_g) in zip(ref, got):
        assert (rc_g, out_g) == (rc_r, out_r), name
    # every sequence ends in its own state: not a run of refusals
    assert sum(rc == 0 for _, rc, _ in got) >= len(got) // 2


# ---------------------------------------------------------- local search

N, DIM = 4096, 64


@pytest.fixture(scope="module")
def lane_store():
    """4,096 unit rows x 64-d from a seed, a few labeled for --bloom, and
    the query every search embeds: the scores have no ties."""
    rng = np.random.default_rng(2024)
    name = f"/spt-tpar-lane-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=N, max_val=256, vec_dim=DIM)
    vecs = rng.standard_normal((N - 64, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    q = rng.standard_normal(DIM).astype(np.float32)
    q /= np.linalg.norm(q)
    # eight rows planted at cosines 0.93, 0.83, ... 0.23 to the query:
    # a head whose gaps survive --fast's bf16 products
    for j in range(8):
        v = vecs[11 * j + 3] - (vecs[11 * j + 3] @ q) * q
        c = 0.93 - 0.1 * j
        vecs[11 * j + 3] = c * q + np.sqrt(1 - c * c) * v / np.linalg.norm(v)
    for i, v in enumerate(vecs):
        k = f"row/{i:05d}"
        st.set(k, "x")
        st.vec_set(k, v)
        if i % 7 == 0:
            st.label_or(k, 0x100)
    yield name, st, q.astype(np.float32)
    st.close()
    Store.unlink(name)


def _search(main, name, st, q, argv, monkeypatch):
    """One `search` through `main` with an embedding daemon (the fake
    encoder answers every text with `q`) drained in a thread."""
    monkeypatch.setenv("SPTPU_DEFAULT_STORE", name)
    emb = Embedder(st, encoder_fn=lambda ts: np.tile(q, (len(ts), 1)),
                   max_ctx=64)
    emb.attach()
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            emb.run_once()
            stop.wait(0.005)

    t = threading.Thread(target=loop)
    t.start()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(["search", "--json", "--local", *argv, "query"])
    finally:
        stop.set()
        t.join()
    assert rc == 0
    return json.loads(buf.getvalue())


CUTS = {
    "plain": ["--limit", "50"],
    "bloom": ["--limit", "20", "--bloom", "0x100"],
    "regex": ["--limit", "20", "--regex", "/0001"],
    "similarity": ["--limit", "500", "--similarity", "0.3"],
    "distance": ["--limit", "500", "--distance", "1.2"],
}


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_local_search_matches_jax_package(cut, lane_store, monkeypatch):
    name, st, q = lane_store
    monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)
    ref = _search(jax_main, name, st, q, CUTS[cut], monkeypatch)
    got = _search(port_main, name, st, q, ["--cpu", *CUTS[cut]],
                  monkeypatch)
    assert len(ref) >= 5
    assert [r["key"] for r in got] == [r["key"] for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["similarity"] - r["similarity"]) <= 1e-5
        assert abs(g["distance"] - r["distance"]) <= 1e-4
    if cut == "bloom":
        ids = [int(r["key"].split("/")[1]) for r in got]
        assert all(i % 7 == 0 for i in ids)


def _gapped(rows, gap):
    """Indices whose similarity is more than `gap` from both neighbours:
    their rank cannot move under a score error below gap / 2."""
    s = [r["similarity"] for r in rows]
    return [i for i in range(len(s))
            if (i == 0 or s[i - 1] - s[i] > gap)
            and (i == len(s) - 1 or s[i] - s[i + 1] > gap)]


def test_local_search_fast_within_bound(lane_store, monkeypatch):
    """--fast: bf16 products on both sides; similarity within 2e-2 of
    the JAX package's exact scores, ranks compared where gaps > 4e-2."""
    name, st, q = lane_store
    monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)
    exact = _search(jax_main, name, st, q, ["--limit", "4096"], monkeypatch)
    got = _search(port_main, name, st, q,
                  ["--cpu", "--fast", "--limit", "40"], monkeypatch)
    by_key = {r["key"]: r for r in exact}
    for g in got:
        assert abs(g["similarity"] - by_key[g["key"]]["similarity"]) \
            <= 2e-2
    head = exact[:40]
    pos = {r["key"]: i for i, r in enumerate(got)}
    checked = 0
    for i in _gapped(head, 4e-2):
        key = head[i]["key"]
        if i < len(got) - 1:
            assert pos.get(key) == i, (key, i)
            checked += 1
    assert checked >= 5


@pytest.mark.gpu
def test_card_local_search_matches_cpu(lane_store, monkeypatch):
    """The card's local search (K3 at Q = 1) against --cpu on one
    store: same keys in order, similarity 1e-5, distance 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name, st, q = lane_store
    for cut in sorted(CUTS):
        ref = _search(port_main, name, st, q, ["--cpu", *CUTS[cut]],
                      monkeypatch)
        got = _search(port_main, name, st, q, CUTS[cut], monkeypatch)
        assert [r["key"] for r in got] == [r["key"] for r in ref], cut
        for g, r in zip(got, ref):
            assert abs(g["similarity"] - r["similarity"]) <= 1e-5
            assert abs(g["distance"] - r["distance"]) <= 1e-4
