"""The torch port's CLI (`python -m libsplinter_tpu_torch.cli`), driven
through its real entry point on the CPU: the port's counterparts of the
JAX package's tests/test_cli.py (init/set/get/head/list/type/unset/
config/export/bump/append/uuid/math/label/shard/watch/search, the
port's Embedder with the fake encoder, `search --cpu` where the JAX
package's test let its CPU default score; `search --sharded --cpu` on
the pod path, its fetch growing past stale scratch rows), then what only
the port has: `lint` runs the port's splint (clean on the tree, exit 1
on a hazard seeded under --root), a local-path search and a
sharded one without --cpu refuse on a host without CUDA, the commands
that score nothing run with torch unimportable, the stale-scratch growth
on the search daemon's path, and the REPL's second local search staging
only the dirty rows."""
import json
import os
import subprocess
import sys
import threading
import time
import uuid as uuidlib
from pathlib import Path

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.cli.main import main
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.embedder import Embedder
from libsplinter_tpu_torch.engine.searcher import Searcher, daemon_live

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def cli(monkeypatch):
    name = f"/spt-tcli-{os.getpid()}-{uuidlib.uuid4().hex[:8]}"
    monkeypatch.setenv("SPTPU_DEFAULT_STORE", name)
    monkeypatch.delenv("SPTPU_NS_PREFIX", raising=False)

    def run(*args):
        return main(list(args))

    run("init", "128", "512", "32")
    yield run, name
    Store.unlink(name)


def out_of(capsys):
    return capsys.readouterr().out


def test_set_get(cli, capsys):
    run, _ = cli
    assert run("set", "greet", "hello", "world") == 0
    assert run("get", "greet") == 0
    assert out_of(capsys).endswith("hello world\n")


def test_get_missing_errors(cli, capsys):
    run, _ = cli
    assert run("get", "nope") == 1


def test_append(cli, capsys):
    run, _ = cli
    run("set", "log", "a")
    run("append", "log", "b")
    run("get", "log")
    assert out_of(capsys).endswith("ab\n")


def test_list_regex(cli, capsys):
    run, _ = cli
    run("set", "apple", "1")
    run("set", "banana", "2")
    run("list", "^app")
    out = out_of(capsys)
    assert "apple" in out and "banana" not in out


def test_type_roundtrip(cli, capsys):
    run, _ = cli
    run("set", "t", "text")
    run("type", "t", "VARTEXT")
    run("type", "t")
    assert "VARTEXT" in out_of(capsys)


def test_math(cli, capsys):
    run, _ = cli
    run("set", "n", "41")
    run("type", "n", "BIGUINT")
    run("math", "n", "inc")
    assert out_of(capsys).strip().endswith("42")


def test_label_names_from_rc(cli, capsys, tmp_path, monkeypatch):
    rc = tmp_path / "rc"
    rc.write_text("hot = 0x10\n# comment\n")
    monkeypatch.setenv("SPTPU_RC", str(rc))
    run, _ = cli
    run("set", "k", "v")
    run("label", "k", "+hot")
    run("label", "k")
    assert "0x" in out_of(capsys)
    st = Store.open(os.environ["SPTPU_DEFAULT_STORE"])
    assert st.labels("k") == 0x10
    st.close()


def test_head_shows_vector_stats(cli, capsys):
    run, name = cli
    run("set", "h", "x")
    st = Store.open(name)
    st.vec_set("h", np.ones(32, np.float32))
    st.close()
    run("head", "h")
    out = out_of(capsys)
    assert "epoch" in out and "|v|=" in out


def test_health_reports_daemon_vitals(cli, capsys):
    run, name = cli
    st = Store.open(name)
    emb = Embedder(st, encoder_fn=lambda ts: np.zeros(
        (len(ts), 32), np.float32), max_ctx=64)
    emb.attach()
    st.set("k", "text")
    st.set_type("k", 0x80)
    st.label_or("k", P.LBL_EMBED_REQ)
    emb.run_once()
    emb.publish_stats()
    st.close()
    assert run("health") == 0
    out = out_of(capsys)
    assert "embedder" in out and "embedded=1" in out
    assert "no heartbeat" in out          # completer not attached
    assert "bid" in out and "0x5f10" in out
    assert "signals" in out


def test_health_ignores_ns_prefix(cli, capsys, monkeypatch):
    run, name = cli
    st = Store.open(name)
    emb = Embedder(st, encoder_fn=lambda ts: np.zeros(
        (len(ts), 32), np.float32), max_ctx=64)
    emb.attach()
    emb.publish_stats()
    st.close()
    monkeypatch.setenv("SPTPU_NS_PREFIX", "teamA.")
    assert run("health") == 0
    out = out_of(capsys)
    assert "no heartbeat" not in out.split("completer")[0], out


def test_config_dump_and_purge(cli, capsys):
    run, _ = cli
    run("config")
    out = out_of(capsys)
    assert "geometry" in out and "128 slots" in out
    run("config", "purge")
    assert "swept" in out_of(capsys)


def test_unset_tandem(cli, capsys):
    run, name = cli
    st = Store.open(name)
    st.tandem_set("doc", [b"a", b"b", b"c"])
    st.close()
    run("orders", "doc")
    assert "3 orders" in out_of(capsys)
    run("unset", "doc", "--tandem")
    assert "removed 3" in out_of(capsys)


def test_shard_workflow(cli, capsys):
    run, _ = cli
    run("shard", "claim", "0x5F10", "40")
    assert "bid" in out_of(capsys)
    run("shard", "who")
    assert "sovereign" in out_of(capsys)
    run("shard", "table")
    assert "5f10" in out_of(capsys).lower()
    run("shard", "advise", "0", "willneed")
    assert "advised" in out_of(capsys)
    run("shard", "release", "0")
    run("shard", "who")
    assert "no sovereign" in out_of(capsys)


def test_uuid(cli, capsys):
    run, name = cli
    run("uuid", "myid")
    u = out_of(capsys).strip()
    st = Store.open(name)
    assert st.get_str("myid") == u
    st.close()


def test_ns_prefix(cli, capsys, monkeypatch):
    run, name = cli
    monkeypatch.setenv("SPTPU_NS_PREFIX", "app1/")
    run("set", "k", "scoped")
    st = Store.open(name)
    assert st.get_str("app1/k") == "scoped"
    st.close()


def test_ingest_and_export(cli, capsys, tmp_path):
    run, name = cli
    doc = tmp_path / "doc.txt"
    doc.write_text("lorem ipsum " * 200)   # forces multiple chunks
    run("ingest", "docs/d1", str(doc), "--no-embed")
    out = out_of(capsys)
    assert "ingested" in out
    st = Store.open(name)
    n = st.tandem_count("docs/d1")
    assert n >= 2
    meta = json.loads(st.get_str("docs/d1.meta"))
    assert meta["chunks"] == n
    assert st.labels("docs/d1") & P.LBL_CHUNK
    st.close()
    run("export", "--regex", "docs/")
    dump = json.loads(out_of(capsys))
    recs = dump["slots"]
    assert dump["count"] == len(recs)
    keys = {r["key"] for r in recs}
    assert "docs/d1" in keys and "docs/d1.meta" in keys
    epochs = [r["epoch"] for r in recs]
    assert epochs == sorted(epochs, reverse=True)


def fake_encoder(texts):
    out = np.zeros((len(texts), 32), np.float32)
    for i, t in enumerate(texts):
        h = abs(hash(t)) % 997
        rng = np.random.default_rng(h)
        out[i] = rng.normal(size=32)
        out[i] /= np.linalg.norm(out[i])
    return out


class _Daemons:
    """The port's embedder (fake encoder) and, optionally, its searcher
    on the CPU, drained in one background thread."""

    def __init__(self, st, *, searcher=False):
        self.emb = Embedder(st, encoder_fn=fake_encoder, max_ctx=512)
        self.emb.attach()
        self.sr = None
        if searcher:
            self.sr = Searcher(st, device="cpu")
            self.sr.attach()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop)

    def _loop(self):
        while not self._stop.is_set():
            self.emb.run_once()
            if self.sr is not None:
                self.sr.run_once()
                self.sr.publish_stats()
            self._stop.wait(0.01)

    def __enter__(self):
        self.emb.run_once()
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join()


def _docs(st, n=8):
    for i in range(n):
        st.set(f"doc{i}", f"document number {i}")
        st.label_or(f"doc{i}", P.LBL_EMBED_REQ)


def test_search_end_to_end(cli, capsys):
    """search writes the scratch key, the daemon embeds it, and ranked
    results come back — the demo loop through the CLI, scored locally
    by K3's plain version (--cpu)."""
    run, name = cli
    st = Store.open(name)
    _docs(st)
    with _Daemons(st):
        rc = run("search", "--cpu", "--json", "--limit", "3",
                 "document number 3")
        assert rc == 0
        rows = json.loads(out_of(capsys))
        assert len(rows) == 3
        assert rows[0]["key"] == "doc3"     # same text -> same fake vec
        assert rows[0]["similarity"] == pytest.approx(1.0, abs=1e-4)
        assert rows[0]["distance"] == pytest.approx(0.0, abs=1e-2)
    assert not any(k.startswith(P.SEARCH_SCRATCH_PREFIX) for k in st.list())
    st.close()


def test_search_grows_past_stale_scratch_on_daemon_path(cli, capsys):
    """Stale __sqtmp_ scratch rows (crashed searches) hold QUERY
    embeddings, so they rank at the very top of a repeated query; the
    search must still come back with --limit real results.  The JAX
    package holds this on its pod path (tests/test_cli.py:271); the
    port, which has no pod path yet, holds it on the search daemon's
    path, served by the port's Searcher on the CPU."""
    run, name = cli
    st = Store.open(name)
    query = "document number 3"
    _docs(st)
    for i in range(5):
        k = f"{P.SEARCH_SCRATCH_PREFIX}{40000 + i}"
        st.set(k, query)
        st.label_or(k, P.LBL_EMBED_REQ)
    with _Daemons(st, searcher=True) as d:
        deadline = time.monotonic() + 30
        while not daemon_live(st) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert daemon_live(st)
        rc = run("search", "--json", "--limit", "8", query)
        assert rc == 0
        rows = json.loads(out_of(capsys))
        served = d.sr.stats.served
    assert len(rows) == 8
    assert {r["key"] for r in rows} == {f"doc{i}" for i in range(8)}
    assert rows[0]["key"] == "doc3"
    assert served >= 1                      # the daemon scored it
    assert all(r["distance"] is not None for r in rows)
    st.close()


def test_search_degrades_without_daemon(cli, capsys):
    run, name = cli
    st = Store.open(name)
    st.set("alone", "no daemon here")
    st.close()
    rc = run("search", "--timeout", "50", "--json", "anything")
    assert rc == 0
    rows = json.loads(out_of(capsys))
    assert any(r["key"] == "alone" for r in rows)
    assert all(r["similarity"] is None for r in rows)


def test_sharded_search_served(cli, capsys):
    """search --sharded serves the pod path (PodSearch over a CPU mesh
    with --cpu): host-tagged rows ranked as the committed vectors rank
    against the query's, its own scratch row masked out and retired."""
    run, name = cli
    st = Store.open(name)
    _docs(st)
    with _Daemons(st):
        rc = run("search", "--sharded", "--cpu", "--json", "--limit", "3",
                 "--timeout", "60000", "document number 3")
        rows = json.loads(out_of(capsys))
    assert rc == 0 and len(rows) == 3
    q = st.vec_get("doc3")                  # same text -> same fake vec
    sims = {f"doc{i}": float(st.vec_get(f"doc{i}") @ q
                             / np.linalg.norm(st.vec_get(f"doc{i}"))
                             / np.linalg.norm(q)) for i in range(8)}
    want = sorted(sims, key=lambda k: -sims[k])[:3]
    assert [r["key"] for r in rows] == want and want[0] == "doc3"
    for r in rows:
        assert r["host"] == 0 and r["slot"] == st.find_index(r["key"])
        assert r["similarity"] == pytest.approx(sims[r["key"]], abs=1e-5)
    assert not any(k.startswith(P.SEARCH_SCRATCH_PREFIX) for k in st.list())
    st.close()


def test_sharded_search_without_cuda_refuses(cli, capsys):
    """Without --cpu the pod path's mesh is the host's cards: a host
    without CUDA exits 1 naming --cpu and leaves no scratch key."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal of a host without CUDA")
    run, name = cli
    st = Store.open(name)
    _docs(st)
    with _Daemons(st):
        rc = run("search", "--sharded", "--json", "--timeout", "60000",
                 "document number 3")
    cap = capsys.readouterr()
    assert rc == 1 and "--sharded --cpu" in cap.err
    assert not any(k.startswith(P.SEARCH_SCRATCH_PREFIX) for k in st.list())
    st.close()


def test_sharded_search_grows_past_stale_scratch(cli, capsys):
    """The counterpart of tests/test_cli.py:271: stale __sqtmp_ scratch
    rows hold QUERY embeddings, so they rank at the very top of a
    repeated query; the pod path grows its fetch on the _bucket
    schedule until --limit real results come back."""
    run, name = cli
    st = Store.open(name)
    query = "document number 3"
    _docs(st)
    for i in range(5):
        k = f"{P.SEARCH_SCRATCH_PREFIX}{40000 + i}"
        st.set(k, query)
        st.label_or(k, P.LBL_EMBED_REQ)
    with _Daemons(st):
        # limit 8 = all real docs; the first fetch (8 + 4) is swamped by
        # the 5 stale scratch rows and must grow
        rc = run("search", "--sharded", "--cpu", "--json", "--limit", "8",
                 "--timeout", "60000", query)
        assert rc == 0
        rows = json.loads(out_of(capsys))
    assert len(rows) == 8
    assert {r["key"] for r in rows} == {f"doc{i}" for i in range(8)}
    assert rows[0]["key"] == "doc3"
    st.close()


def test_lint_clean_on_the_tree(cli, capsys):
    """`lint` runs the port's splint over libsplinter_tpu_torch/: no
    finding, the two intentional host syncs suppressed with reasons."""
    run, _ = cli
    assert run("lint") == 0
    cap = capsys.readouterr()
    assert "splint: 0 finding(s), 2 suppressed, 0 baselined" in cap.out
    assert "11 rules" in cap.out
    assert cap.err.count("  suppressed: libsplinter_tpu_torch/engine/") == 2


@pytest.mark.parametrize("hazard", [False, True], ids=["clean", "hazard"])
def test_lint_on_a_seeded_tree(cli, capsys, tmp_path, hazard):
    """Under --root, a tree holding the port's protocol.py and docs is
    clean (exit 0); a synchronize seeded into a drain loop fails it
    (exit 1) with a `file:line · RULE_ID` line."""
    run, _ = cli
    engine = tmp_path / "libsplinter_tpu_torch" / "engine"
    engine.mkdir(parents=True)
    (engine / "protocol.py").write_text(
        (ROOT / "libsplinter_tpu_torch" / "engine" / "protocol.py")
        .read_text())
    for rel in ("docs/operations.md", "docs/api/bloom-labels.md"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text((ROOT / rel).read_text())
    if hazard:
        (engine / "evil.py").write_text(
            "import torch\n"
            "def run_continuous(self):\n"
            "    torch.cuda.synchronize()\n")
    assert run("lint", "--root", str(tmp_path)) == int(hazard)
    cap = capsys.readouterr()
    line = ("libsplinter_tpu_torch/engine/evil.py:3 · SPL201 · "
            "torch.cuda.synchronize() in run_continuous()")
    assert (line in cap.out) == hazard
    assert ("1 unsuppressed splint finding(s)" in cap.err) == hazard


def test_local_search_without_cuda_refuses(cli, capsys):
    """On a host without CUDA a local-path search without --cpu exits 1
    with resolve_device's message and names --cpu: it never scores on
    the CPU in silence."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal of a host without CUDA")
    run, name = cli
    st = Store.open(name)
    _docs(st)
    with _Daemons(st):
        rc = run("search", "--json", "document number 3")
    cap = capsys.readouterr()
    assert rc == 1
    assert "torch.cuda.is_available() is False" in cap.err
    assert "--cpu" in cap.err
    assert cap.out == ""
    assert not any(k.startswith(P.SEARCH_SCRATCH_PREFIX) for k in st.list())
    st.close()


def test_commands_that_score_nothing_import_no_torch(tmp_path):
    """init, set, get, list, head, health, metrics and top --once run
    through main() in a fresh interpreter where importing torch fails:
    no such command builds a CUDA context beside the daemons."""
    name = f"/spt-tcli-nt-{os.getpid()}-{uuidlib.uuid4().hex[:8]}"
    code = f"""
import os, sys
sys.modules["torch"] = None
sys.path.insert(0, {str(ROOT)!r})
from libsplinter_tpu_torch.cli.main import main
cmds = [["init", "64", "256", "16"], ["set", "a", "hello"], ["get", "a"],
        ["list"], ["head", "a"], ["health"], ["metrics"],
        ["top", "--once"]]
rcs = [main(["--store", {name!r}] + c) for c in cmds]
print("RCS", rcs)
assert not [m for m in sys.modules
            if m.split(".")[0] == "torch" and sys.modules[m] is not None]
"""
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(tmp_path))
    finally:
        Store.unlink(name)
    assert out.returncode == 0, out.stderr
    assert "RCS [0, 0, 0, 0, 0, 0, 0, 0]" in out.stdout, out.stdout
    assert "hello" in out.stdout


def test_repl_second_local_search_stages_only_dirty_rows(
        cli, capsys, monkeypatch):
    """Two local searches in one REPL session: the first uploads the
    lane in full, the second (after one more document lands) stages
    only the changed rows — read back through `metrics`, which exposes
    the session's lane counters."""
    import io

    run, name = cli
    st = Store.open(name)
    _docs(st)
    with _Daemons(st):
        script = "\n".join([
            "search --cpu --local --json --limit 2 document number 1",
            "set doc9 document number 9",
            "label doc9 +0x1",
            "bump doc9",
            "search --cpu --local --json --limit 2 document number 9",
            "metrics",
        ]) + "\n"
        monkeypatch.setattr("sys.stdin", io.StringIO(script))
        assert main([]) == 0
    out = capsys.readouterr().out
    assert "sptpu_staged_lane_full_uploads 1" in out
    assert "sptpu_staged_lane_refreshes 2" in out
    staged = [ln for ln in out.splitlines()
              if ln.startswith("sptpu_staged_lane_rows_staged ")]
    assert staged, out
    n = int(float(staged[0].split()[1]))
    assert 1 <= n <= 8, n                   # dirty rows only, not 128
    assert '"key": "doc1"' in out
    st.close()


def test_supervise_exits_zero_on_sigterm_with_no_child_left(cli, tmp_path):
    """`python -m libsplinter_tpu_torch.cli --store S supervise` started
    from a directory without the package: its torch-free lanes come up,
    and SIGTERM ends it with exit 0 and no child left (Supervisor.run
    takes SIGTERM on the main thread, so `spt supervise` stops as the
    supervisor's own entry point does)."""
    import signal

    _, name = cli
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SPTPU_FAULT", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "libsplinter_tpu_torch.cli", "--store", name,
         "supervise", "--lanes", "pipeliner,telemetry",
         "--poll-interval-s", "0.1"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    st = Store.open(name)
    try:
        pids = {}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                len(pids) == 2
                and P.heartbeat_live(st, P.KEY_SCRIPT_STATS)
                and P.heartbeat_live(st, P.KEY_TELEMETRY_STATS)):
            try:
                snap = json.loads(
                    st.get(P.KEY_SUPERVISOR_STATS).rstrip(b"\0"))
                pids = {n: s["pid"] for n, s in snap["lanes"].items()
                        if s["state"] in ("starting", "running")
                        and s["pid"]}
            except (KeyError, ValueError):
                pass
            time.sleep(0.2)
        assert len(pids) == 2, proc.stderr.read() if proc.poll() else pids
        assert P.heartbeat_live(st, P.KEY_SCRIPT_STATS)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "supervising pipeliner, telemetry" in proc.stdout.read()
        for pid in pids.values():
            assert not P.pid_alive(pid)
    finally:
        st.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.slow
def test_cli_regression_script(tmp_path):
    """The shell workflow regression (tests/cli_regression.sh) against
    the port's CLI: a copy of the script with the module path swapped."""
    src = (ROOT / "tests" / "cli_regression.sh").read_text()
    assert src.count("libsplinter_tpu.cli") == 1
    script = tmp_path / "cli_regression.sh"
    script.write_text(src.replace("libsplinter_tpu.cli",
                                  "libsplinter_tpu_torch.cli")
                         .replace('REPO=$(cd "$(dirname "$0")/.." && pwd)',
                                  f"REPO={ROOT}"))
    env = dict(os.environ, PYTHON=sys.executable)
    r = subprocess.run(["sh", str(script)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"


# --------------------------------------------- watch (continuous)

def test_watch_oneshot_timeout(cli, capsys):
    run, _ = cli
    run("set", "w", "v0")
    assert run("watch", "w", "60") == 0
    assert out_of(capsys).endswith("timeout\n")


def test_watch_oneshot_catches_change(cli, capsys):
    run, name = cli
    run("set", "w", "v0")
    st = Store.open(name)

    def writer():
        time.sleep(0.1)
        st.set("w", "fresh value")

    t = threading.Thread(target=writer)
    t.start()
    try:
        assert run("watch", "w", "3000") == 0
    finally:
        t.join()
    st.close()
    assert "11:fresh value" in out_of(capsys)


_CAPTURED = {"buf": ""}


def _read_captured(capsys) -> str:
    out = capsys.readouterr().out
    _CAPTURED["buf"] += out
    return _CAPTURED["buf"]


def test_watch_continuous_streams_until_ctrl_bracket(cli, capsys,
                                                    monkeypatch):
    run, name = cli
    _CAPTURED["buf"] = ""
    run("set", "w", "v0")
    st = Store.open(name)
    r, w = os.pipe()
    monkeypatch.setattr("sys.stdin", os.fdopen(r, "rb", buffering=0))
    rc_box = {}

    def watcher():
        rc_box["rc"] = run("watch", "w")

    t = threading.Thread(target=watcher)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        st.set("w", "one")
        st.set("w", "two")
        while "2:" not in _read_captured(capsys) and \
                time.monotonic() < deadline:
            st.set("w", "two")
            time.sleep(0.05)
        os.write(w, b"\x1d")                # Ctrl-]
        t.join(timeout=5)
        assert not t.is_alive(), "watch did not abort on Ctrl-]"
    finally:
        os.close(w)
        if t.is_alive():
            t.join(timeout=1)
    st.close()
    assert rc_box["rc"] == 0
    assert "3:two" in _CAPTURED["buf"]


def test_watch_group_oneshot(cli, capsys):
    run, name = cli
    st = Store.open(name)
    st.set("g", "x")
    st.watch_register("g", 5)

    def pulser():
        time.sleep(0.1)
        st.bump("g")

    t = threading.Thread(target=pulser)
    t.start()
    try:
        assert run("watch", "@5", "3000") == 0
    finally:
        t.join()
    st.close()
    assert "group 5 pulsed" in out_of(capsys)


def test_watch_oneshot_ignores_stdin_eof(cli, capsys, monkeypatch):
    run, name = cli
    run("set", "w", "v0")
    r, w = os.pipe()
    os.close(w)                                # stdin is instantly EOF
    monkeypatch.setattr("sys.stdin", os.fdopen(r, "rb", buffering=0))
    st = Store.open(name)

    def writer():
        time.sleep(0.3)
        st.set("w", "late")

    t = threading.Thread(target=writer)
    t.start()
    try:
        assert run("watch", "w", "3000") == 0
    finally:
        t.join()
    st.close()
    assert "4:late" in out_of(capsys)


def test_watch_survives_unset_recreate(cli, capsys, monkeypatch):
    run, name = cli
    _CAPTURED["buf"] = ""
    run("set", "w", "v0")
    st = Store.open(name)
    r, w = os.pipe()
    monkeypatch.setattr("sys.stdin", os.fdopen(r, "rb", buffering=0))
    out_box = {}

    def watcher():
        out_box["rc"] = run("watch", "w")

    t = threading.Thread(target=watcher)
    t.start()
    try:
        time.sleep(0.1)
        st.unset("w")
        for i in range(8):
            st.set(f"filler/{i}", "x")
        st.set("w", "reborn")
        deadline = time.monotonic() + 15.0
        while "6:reborn" not in _read_captured(capsys) and \
                time.monotonic() < deadline:
            st.bump("w")
            time.sleep(0.05)
        os.write(w, b"\x1d")
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        os.close(w)
        if t.is_alive():
            t.join(timeout=1)
    st.close()
    assert "6:reborn" in _CAPTURED["buf"]
