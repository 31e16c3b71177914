"""The torch port's completion daemon on real stores, on the CPU:
mirrors of tests/test_completer.py (label trifecta, streaming appends,
system-prompt key, templates, truncation, failure release), the
batched drain through the tiny torch decoder, the CLI, and the JAX
daemon's protocol outcome on the same requests.

Tolerance for the JAX comparison: none — at temp=0 with the same
bridged f32 weights both daemons must leave byte-identical slots and
labels (greedy argmax over logits that agree within 1e-4; the seeded
inputs have no near-tie)."""
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from libsplinter_tpu_torch import Store
from libsplinter_tpu_torch.engine import completer as tcomp
from libsplinter_tpu_torch.engine import protocol as P
from libsplinter_tpu_torch.engine.completer import (OOM_MARKER, Completer,
                                                    detect_template,
                                                    render_prompt)
from libsplinter_tpu_torch.models import (ByteTokenizer, CompletionModel,
                                          DecoderConfig)


@pytest.fixture
def stores():
    made = []

    def make(max_val=1024):
        name = f"/spt-tc-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        st = Store.create(name, nslots=256, max_val=max_val, vec_dim=0)
        made.append((st, name))
        return st

    yield make
    for st, name in made:
        st.close()
        Store.unlink(name)


@pytest.fixture
def st(stores):
    return stores()


def fake_generate(prompt):
    """Deterministic 'decoder': streams a fixed reply word by word."""
    for w in ["the", " answer", " is", " 42", "\n"]:
        yield w.encode()


def _request(store, key, prompt):
    store.set(key, prompt)
    store.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
    store.bump(key)


def _served(store, key):
    labels = store.labels(key)
    return bool(labels & P.LBL_READY) and not labels & (
        P.LBL_INFER_REQ | P.LBL_SERVICING | P.LBL_WAITING)


def test_completion_round_trip(st):
    c = Completer(st, generate_fn=fake_generate)
    c.attach()
    _request(st, "q1", "what is the answer?")
    assert c.run_once() == 1
    out = st.get_str("q1")
    # slot = rendered prompt + streamed reply
    assert out.startswith("<|im_start|>user\nwhat is the answer?")
    assert out.endswith("the answer is 42\n")
    assert _served(st, "q1")
    assert c.stats.completions == 1 and c.stats.tokens == 5


def test_system_prompt_fetched_fresh(st):
    c = Completer(st, generate_fn=fake_generate)
    c.attach()
    st.set(P.KEY_SYSTEM_PROMPT, "be terse")
    _request(st, "q1", "hi")
    c.run_once()
    assert "<|im_start|>system\nbe terse<|im_end|>" in st.get_str("q1")
    st.set(P.KEY_SYSTEM_PROMPT, "be verbose")
    _request(st, "q2", "hi again")
    c.run_once()
    assert "be verbose" in st.get_str("q2")
    assert "be terse" not in st.get_str("q2")


def test_bare_template_fallback(st):
    c = Completer(st, generate_fn=fake_generate, template="none")
    c.attach()
    st.set(P.KEY_SYSTEM_PROMPT, "sys")
    _request(st, "q", "user text")
    c.run_once()
    assert st.get_str("q").startswith("sys\n\nuser text")
    assert render_prompt("u", None, "none") == "u"


def test_streaming_appends_visible_mid_generation(st):
    lengths = []

    def slow_generate(prompt):
        for w in ["alpha ", "beta ", "gamma "]:
            yield w.encode()
            lengths.append(st.value_len("q"))

    c = Completer(st, generate_fn=slow_generate)
    c.attach()
    _request(st, "q", "p")
    c.run_once()
    # each word ends with a boundary => flushed before the next yield
    assert lengths == sorted(lengths)
    assert lengths[1] > lengths[0]


def test_truncation_at_max_val(st):
    def endless(prompt):
        while True:
            yield b"xxxxxxxx "

    c = Completer(st, generate_fn=endless, max_new_tokens=10 ** 6)
    c.attach()
    _request(st, "q", "p")
    c.run_once()
    out = st.get("q")
    assert len(out) <= st.max_val
    assert OOM_MARKER.rstrip(b"\0") in out or len(out) >= st.max_val - 1
    assert c.stats.truncated == 1
    assert st.labels("q") & P.LBL_READY


def test_generation_failure_releases_labels(st):
    def broken(prompt):
        yield b"partial "
        raise RuntimeError("model fell over")

    c = Completer(st, generate_fn=broken)
    c.attach()
    _request(st, "q", "p")
    c.run_once()
    assert _served(st, "q")                      # never wedged
    assert "[completer]" in st.get_str(P.KEY_DEBUG)


def test_signal_driven_run_loop(st):
    c = Completer(st, generate_fn=fake_generate)
    c.attach()
    t = threading.Thread(target=c.run, kwargs={"stop_after": 5.0})
    t.start()
    try:
        time.sleep(0.1)
        _request(st, "live", "ping")
        deadline = time.time() + 4.0
        while time.time() < deadline and not _served(st, "live"):
            time.sleep(0.01)
        assert _served(st, "live")
    finally:
        c.stop()
        t.join()
    c.publish_stats()
    beat = st.get_str(P.KEY_COMPLETE_STATS)
    assert '"completions": 1' in beat and '"generation": 1' in beat


def test_templates():
    with pytest.raises(ValueError, match="unknown chat template"):
        render_prompt("u", None, "auto")
    assert detect_template("{%...<|im_start|>...%}") == "chatml"
    assert detect_template("...<|start_header_id|>...") == "llama3"
    assert detect_template("...[INST]...") == "llama2"
    assert detect_template(None) == "none"
    assert render_prompt("u", "s", "llama2") == \
        "<s>[INST] <<SYS>>\ns\n<</SYS>>\n\nu [/INST]"


def _tiny_model(temp=1.0, params=None, seed=0):
    cfg = DecoderConfig.tiny(vocab_size=300, dtype=torch.float32,
                             flash_min_seq=32)
    return CompletionModel(cfg, buckets=(16, 32, 64), temp=temp,
                           params=params, seed=seed, device="cpu")


def test_batched_drain_of_mixed_prompt_lengths(st):
    """Prompts of 2..60 bytes ride one left-padded batch (bucket 64, K4's
    CPU path on its prefill); a serial request serves through
    process_key."""
    model = _tiny_model()
    c = Completer(st, model=model, max_new_tokens=8, template="none")
    c.attach()
    prompts = {f"k{i}": "ab" * n for i, n in enumerate((1, 5, 12, 30, 3))}
    for key, text in prompts.items():
        _request(st, key, text)
    assert c.run_once() == len(prompts)
    for key, text in prompts.items():
        assert _served(st, key)
        assert st.get(key).startswith(text.encode())
    assert c.stats.completions == len(prompts)
    assert 0 < c.stats.tokens <= 8 * len(prompts)
    assert model.pos == 0                         # reset after the drain
    _request(st, "serial", "hello")
    assert c.process_key(st.find_index("serial"))
    assert _served(st, "serial")
    assert model.compile_count() >= 2


def test_same_outcome_as_the_jax_daemon(stores):
    """One set of requests, bridged weights, greedy: the JAX daemon and
    the torch daemon leave the same bytes and labels in their stores."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
    jcomp = pytest.importorskip("libsplinter_tpu.engine.completer")
    from libsplinter_tpu_torch.models.decoder import params_from_jax

    cfg_j = jdec.DecoderConfig.tiny(vocab_size=300, dtype=jnp.float32,
                                    flash_min_seq=32)
    params = jdec.Decoder(cfg_j).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32),
                                      jdec.init_cache(cfg_j, 1),
                                      jnp.int32(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)
    jm = jdec.CompletionModel(cfg_j, params=params, buckets=(16, 32, 64),
                              temp=0.0)
    tm = _tiny_model(temp=0.0, params=params_from_jax(params, cfg_j))
    requests = {"a": "hi", "b": "tell me a story", "c": "x" * 40}
    outs = []
    for daemon_cls, model in ((jcomp.Completer, jm), (Completer, tm)):
        store = stores()
        d = daemon_cls(store, model=model, tokenizer=ByteTokenizer(),
                       max_new_tokens=10, template="chatml")
        d.attach()
        for key, text in requests.items():
            _request(store, key, text)
        assert d.run_once() == len(requests)
        outs.append({k: (store.get(k), store.labels(k)) for k in requests})
        assert d.stats.tokens > 0
    assert outs[0] == outs[1]


def test_main_serves_on_the_cpu(st, monkeypatch):
    """--device cpu runs the daemon on the plain versions at full width
    (a short window); the default --device cuda raises with no card."""
    _request(st, "q", "hello")
    assert tcomp.main(["--store", st.name, "--device", "cpu", "--oneshot",
                       "--n-ctx", "256", "--max-new-tokens", "3",
                       "--phase", "unified", "--tp", "1"]) == 0
    assert _served(st, "q")
    assert st.get("q").startswith(b"hello")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcomp.main(["--store", st.name, "--oneshot"])


# explicit ids: each case keeps the id it had in the list of flags the
# port once refused — the KV tier (flags0, flags1), the disaggregated
# lanes (flags2, flags3, flags11), speculative decoding (flags6, flags7,
# flags13, flags14), int8 weights (flags8-flags10), a .gguf (flags12) and
# sharded serving (flags4, flags5), all served now
@pytest.mark.parametrize("flags,tp,ep", [
    (["--tp", "2"], 2, 1), (["--ep", "2"], 1, 2),
], ids=[f"flags{i}" for i in (4, 5)])
def test_sharded_flags_serve_on_the_cpu(st, monkeypatch, flags, tp, ep):
    """--tp / --ep build a mesh of CPU shards with --device cpu and serve
    through a ShardedCompletionModel; on a CUDA host with fewer cards
    than tp * ep the daemon exits nonzero naming the card count, never
    falling back to a CPU lane or to tp = 1."""
    from libsplinter_tpu_torch.parallel import ShardedCompletionModel
    seen = []
    run_once = tcomp.Completer.run_once

    def recording(self):
        seen.append(self._model)
        return run_once(self)

    monkeypatch.setattr(tcomp.Completer, "run_once", recording)
    _request(st, "q", "hello")
    assert tcomp.main(["--store", st.name, "--device", "cpu", "--oneshot",
                       "--n-ctx", "256", "--max-new-tokens", "3",
                       *flags]) == 0
    assert _served(st, "q") and st.get("q").startswith(b"hello")
    model, = seen
    assert isinstance(model, ShardedCompletionModel)
    assert (model.mesh.shape["tp"], model.mesh.shape["ep"]) == (tp, ep)
    assert all(d.type == "cpu" for d in model.module.devices)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        tcomp.main(["--store", "/spt-never-opened", *flags])
    msg = str(exc.value.code)
    assert exc.value.code not in (0, None)
    assert "needs 2 cuda devices" in msg and "this host has 1" in msg
