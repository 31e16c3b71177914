"""The torch port's int8 weight residency (models/quant.py) against the
JAX package's, on the CPU, on shared seeded weights.

  - the numpy quantizers copied from the JAX package give identical
    output, and the port's tree walkers give leaves exactly equal to
    quantize_decoder_params / quantize_encoder_params (block and
    channel, idempotent); the state_dict quantizer gives the same codes;
  - QuantDense and ChannelQuantDense against the flax modules: f32
    within 1e-5; bf16 within one bf16 step of the output's magnitude
    (2^-7 max|y|: both round their output to bf16 after an f32-
    accumulated product of the same bf16 operands, so a value near a
    rounding tie may land one step apart);
  - a quantized and a weights_int8 tiny decoder: prefill and decode
    logits within 1e-5 (f32) of the JAX package's dense CompletionModel
    on the same quantized tree, and the paged lane over quantized
    weights within 1e-4 of that dense anchor;
  - the weights_int8 encoder within 1e-5 of the JAX EmbeddingModel;
  - a tiny all-Q8_0 GGUF opened with quantized=True holds the file's
    codes and scales exactly;
  - `completer.main --quantized` and `--weights-int8` serve to READY on
    --device cpu, and both together are refused as the JAX daemon
    refuses them."""
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jq = pytest.importorskip("libsplinter_tpu.models.quant")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")

from libsplinter_tpu_torch import Store  # noqa: E402
from libsplinter_tpu_torch.engine import completer as tcomp  # noqa: E402
from libsplinter_tpu_torch.engine import protocol as P  # noqa: E402
from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.models import quant as tq  # noqa: E402

ATOL = 1e-5
MODES = {"block": dict(quantized=True), "channel": dict(weights_int8=True)}


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _tree_equal(a, b):
    """Exactly equal nested dicts of arrays, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _decoder_params(seed=0):
    cfg = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    params = jdec.Decoder(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg, 1), jnp.int32(0))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


def _encoder_params(cfg_j, seed=0):
    params = jenc.Encoder(cfg_j).init(jax.random.PRNGKey(seed),
                                      np.ones((1, 8), np.int32),
                                      np.ones((1, 8), bool))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), params)


# -- the copied numpy quantizers and the walkers ----------------------------

@pytest.mark.parametrize("shape", [(64, 48), (96, 7), (32, 1)])
def test_numpy_quantizers_identical_to_jax(shape):
    """The copied functions give the JAX package's output bit for bit,
    an all-zero block and column included."""
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    w[:32, 0] = 0.0
    a, b = tq.quantize_kernel(w), jq.quantize_kernel(w)
    _tree_equal(a, b)
    assert np.array_equal(tq.dequantize_kernel(a), jq.dequantize_kernel(b))
    a, b = tq.quantize_channel_kernel(w), jq.quantize_channel_kernel(w)
    _tree_equal(a, b)
    assert np.array_equal(tq.dequantize_channel_kernel(a),
                          jq.dequantize_channel_kernel(b))
    assert (tq.QBLOCK, tq.QUANT_LEAVES, tq.ENCODER_QUANT_LEAVES) == \
        (jq.QBLOCK, jq.QUANT_LEAVES, jq.ENCODER_QUANT_LEAVES)
    with pytest.raises(ValueError, match="not a multiple"):
        tq.quantize_kernel(w[:31])


@pytest.mark.parametrize("mode", list(MODES))
def test_decoder_walker_leaves_equal_jax(mode):
    """Every leaf of the port's quantize_decoder_params equals the JAX
    package's, and a second pass changes nothing (idempotent)."""
    params = _decoder_params()
    got = tq.quantize_decoder_params(params, mode=mode)
    _tree_equal(got, jax.tree.map(np.asarray,
                                  jq.quantize_decoder_params(params,
                                                             mode=mode)))
    _tree_equal(tq.quantize_decoder_params(got, mode=mode), got)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tq.quantize_decoder_params(params, mode="int3")
    # stacked MoE experts: *_experts_q / *_experts_scale (block in
    # either mode), equal to the JAX package's leaves, idempotent
    w = np.random.default_rng(2).normal(size=(2, 64, 8)).astype(np.float32)
    moe = {"params": {"layer_0": {"moe": {
        "gate_experts": w, "router": {"kernel": w[0, :, :2].copy()}}}}}
    got = tq.quantize_decoder_params(moe, mode=mode)
    _tree_equal(got, jax.tree.map(np.asarray,
                                  jq.quantize_decoder_params(moe, mode=mode)))
    assert sorted(got["params"]["layer_0"]["moe"]) == [
        "gate_experts_q", "gate_experts_scale", "router"]
    _tree_equal(tq.quantize_decoder_params(got, mode=mode), got)


@pytest.mark.parametrize("variant", ["nomic", "bert"])
def test_encoder_walker_leaves_equal_jax(variant):
    cfg_j = jenc.EncoderConfig.tiny(variant=variant, dtype=jnp.float32)
    params = _encoder_params(cfg_j)
    got = tq.quantize_encoder_params(params)
    _tree_equal(got, jax.tree.map(np.asarray,
                                  jq.quantize_encoder_params(params)))
    _tree_equal(tq.quantize_encoder_params(got), got)


@pytest.mark.parametrize("mode", list(MODES))
def test_state_dict_quantizer_matches_the_walker(mode):
    """quantize_state_dict on a float state_dict equals the bridge of the
    walker's tree (what a checkpoint loaded as floats becomes), and is
    idempotent; the head and embeddings stay float."""
    params = _decoder_params()
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32, **MODES[mode])
    sd = tq.quantize_state_dict(tdec.params_from_jax(params, cfg),
                                tq.QUANT_LEAVES, mode=mode)
    want = tdec.params_from_jax(
        tq.quantize_decoder_params(params, mode=mode), cfg)
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].dtype == want[k].dtype and torch.equal(sd[k], want[k]), k
    again = tq.quantize_state_dict(sd, tq.QUANT_LEAVES, mode=mode)
    assert all(again[k] is sd[k] for k in sd)
    assert sd["lm_head.weight"].dtype == torch.float32
    leaf = "q" if mode == "block" else "wq"
    assert sd[f"layer_0.attn.k.{leaf}"].dtype == torch.int8


# -- the modules against flax ---------------------------------------------

def _module_pair(kind, dtype_j, dtype_t, din=64, dout=40, bias=False):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(din, dout)).astype(np.float32) / 8
    x = rng.normal(size=(3, 5, din)).astype(np.float32)
    if kind == "block":
        leaves = jq.quantize_kernel(w)
        jm = jq.QuantDense(dout, dtype=dtype_j)
        tm = tq.QuantDense(din, dout, dtype_t)
        tm.q.copy_(torch.from_numpy(leaves["q"]))
        tm.scale.copy_(torch.from_numpy(leaves["scale"]))
    else:
        leaves = jq.quantize_channel_kernel(w)
        if bias:
            leaves["bias"] = rng.normal(size=(dout,)).astype(np.float32)
        jm = jq.ChannelQuantDense(dout, dtype=dtype_j, use_bias=bias)
        tm = tq.ChannelQuantDense(din, dout, dtype_t, use_bias=bias)
        tm.wq.copy_(torch.from_numpy(leaves["wq"]))
        tm.wscale.copy_(torch.from_numpy(leaves["wscale"]))
        if bias:
            tm.bias.copy_(torch.from_numpy(leaves["bias"]))
    want = np.asarray(jm.apply({"params": leaves}, jnp.asarray(x)),
                      np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).float().numpy()
    return got, want


@pytest.mark.parametrize("kind,bias", [("block", False), ("channel", False),
                                       ("channel", True)])
def test_modules_match_flax_f32(kind, bias):
    got, want = _module_pair(kind, jnp.float32, torch.float32, bias=bias)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind,bias", [("block", False), ("channel", False),
                                       ("channel", True)])
def test_modules_match_flax_bf16(kind, bias):
    """bf16: within one bf16 step of the output's magnitude."""
    got, want = _module_pair(kind, jnp.bfloat16, torch.bfloat16, bias=bias)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())


def test_quant_dense_guards_and_seeded_init():
    """The JAX module's error for an input width off the block; seeded
    codes uniform in [-127, 127] under scales 1/(127 sqrt(fan_in)), the
    same draw for the same seed; the resident bytes of the geometry."""
    with pytest.raises(ValueError, match="QuantDense input dim 40 not a "
                                         "multiple of the quantization "
                                         "block 32"):
        tq.QuantDense(40, 8, torch.float32)
    m = tq.QuantDense(256, 64, torch.bfloat16)
    m.init_weights(torch.Generator().manual_seed(0))
    assert m.q.dtype == torch.int8 and int(m.q.abs().max()) == 127
    assert torch.all(m.scale == np.float32(1 / (127 * np.sqrt(256))))
    m2 = tq.QuantDense(256, 64, torch.bfloat16)
    m2.init_weights(torch.Generator().manual_seed(0))
    assert torch.equal(m.q, m2.q)
    c = tq.ChannelQuantDense(256, 64, torch.bfloat16, use_bias=True)
    c.init_weights(torch.Generator().manual_seed(0))
    assert int(c.wq.abs().max()) == 127 and not c.bias.any()
    # Q8_0: 32 code bytes + one f32 scale per 32 weights = 0.5625 of bf16;
    # per channel: one byte a weight + 4 bytes a column (+ the bias)
    assert tq.resident_bytes(m) / (256 * 64 * 2) == 0.5625
    assert tq.resident_bytes(c) == 256 * 64 + 64 * 4 + 64 * 4


# -- the decoder --------------------------------------------------------------

def _decoders(mode):
    params = _decoder_params()
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32, **MODES[mode])
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32, **MODES[mode])
    common = dict(buckets=(16, 32), temp=0.0, suffix_buckets=(8,))
    jm = jdec.CompletionModel(cfg_j, params=params, **common)
    # the port quantizes the FLOAT state_dict at load, as the JAX model
    # quantizes the float tree
    tm = tdec.CompletionModel(cfg_t, params=tdec.params_from_jax(params,
                                                                 cfg_t),
                              device="cpu", **common)
    return jm, tm


@pytest.mark.parametrize("mode", list(MODES))
def test_quantized_decoder_matches_jax_dense(mode):
    """Prefill and decode logits within 1e-5 of the JAX package's dense
    CompletionModel over the same quantized weights; the projections are
    int8-resident and the head float."""
    jm, tm = _decoders(mode)
    prompt = np.random.default_rng(5).integers(3, 1024, 19).astype(np.int32)
    np.testing.assert_allclose(tm.prefill(prompt), jm.prefill(prompt),
                               rtol=0, atol=ATOL)
    for tok in (7, 300, 12):
        np.testing.assert_allclose(tm.decode_one(tok), jm.decode_one(tok),
                                   rtol=0, atol=ATOL)
    attn = tm.module.layer_0.attn.q
    cls = tq.QuantDense if mode == "block" else tq.ChannelQuantDense
    assert isinstance(attn, cls) and isinstance(tm.module.layer_1.down, cls)
    assert tm.module.lm_head.weight.dtype == torch.float32


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_lane_over_quantized_weights(mode):
    """The paged prefill and three paged decode steps over quantized
    weights within 1e-4 of the JAX dense anchor (greedy tokens fed to
    both)."""
    jm, tm = _decoders(mode)
    prompt = np.random.default_rng(6).integers(3, 1024, 21).astype(np.int32)
    cache = tm.init_paged(2, page=8)
    got = tm.paged_prefill_row(cache, prompt, 1)
    want = np.asarray(jm.prefill(prompt))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for _ in range(3):
        tok = int(np.argmax(want))
        toks = torch.zeros((2, 1), dtype=torch.int64)
        toks[1, 0] = tok
        with torch.no_grad():
            step = tm.module(toks, cache.layers(), 0,
                             lengths=torch.from_numpy(cache.lengths.copy()),
                             tables=torch.from_numpy(cache.tables.copy()))
        cache.lengths[1] += 1
        assert cache.ensure(1, int(cache.lengths[1]) + 1)
        want = np.asarray(jm.decode_one(tok))
        np.testing.assert_allclose(step[1, 0].numpy(), want, rtol=0,
                                   atol=1e-4)


def test_decoder_seeded_init_and_exclusion():
    """Checkpoint-free quantized models draw their codes from the seed;
    the two residencies together are refused."""
    cfg = tdec.DecoderConfig.tiny(quantized=True)
    a = tdec.CompletionModel(cfg, seed=3, device="cpu")
    b = tdec.CompletionModel(cfg, seed=3, device="cpu")
    qa, qb = a.module.layer_0.gate.q, b.module.layer_0.gate.q
    assert qa.dtype == torch.int8 and torch.equal(qa, qb)
    assert a.module.layer_0.gate.scale.dtype == torch.float32
    assert np.isfinite(a.prefill(np.arange(1, 9, dtype=np.int32))).all()
    with pytest.raises(ValueError, match="pick one"):
        tdec.CompletionModel(tdec.DecoderConfig.tiny(quantized=True,
                                                     weights_int8=True),
                             device="cpu")


# -- the encoder --------------------------------------------------------------

@pytest.mark.parametrize("variant", ["nomic", "bert"])
def test_weights_int8_encoder_matches_jax(variant):
    """The weights_int8 EmbeddingModel (float tree quantized at load on
    both sides) within 1e-5 of the JAX package's, at a flash bucket and
    a plain one."""
    cfg_j = jenc.EncoderConfig.tiny(variant=variant, dtype=jnp.float32,
                                    weights_int8=True, flash_min_seq=32)
    cfg_t = tenc.EncoderConfig.tiny(variant=variant, dtype=torch.float32,
                                    weights_int8=True, flash_min_seq=32)
    fcfg = jenc.EncoderConfig.tiny(variant=variant, dtype=jnp.float32)
    params = _encoder_params(fcfg)
    jm = jenc.EmbeddingModel(cfg_j, params=params, buckets=(16, 32))
    tm = tenc.EmbeddingModel(cfg_t, params=tenc.params_from_jax(params,
                                                                cfg_t),
                             buckets=(16, 32), device="cpu")
    assert isinstance(tm.module.layer_0.attn.qkv, tq.ChannelQuantDense)
    rng = np.random.default_rng(4)
    for s, lens in ((16, [16, 9, 3]), (32, [32, 20, 7])):
        ids = rng.integers(0, 1024, (3, s)).astype(np.int32)
        np.testing.assert_allclose(
            tm.encode_ids(ids, np.asarray(lens)),
            np.asarray(jm.encode_ids(ids, np.asarray(lens))),
            rtol=0, atol=ATOL)


# -- a Q8_0 GGUF ---------------------------------------------------------------

def test_q8_0_gguf_keeps_the_files_codes(tmp_path):
    """An all-Q8_0 tiny GGUF opened with quantized=True: every
    projection's codes and scales equal the file's blocks exactly
    (requantizing Q8_0 is lossless), and the logits equal the float
    model's on the file within 1e-5."""
    from test_torch_gguf import _decoder_file

    from libsplinter_tpu_torch.models.gguf import GgufFile
    from libsplinter_tpu_torch.models.gguf_writer import GGML_Q8_0
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    path = str(tmp_path / "q8.gguf")
    _decoder_file(path, cfg_j, _decoder_params(7)["params"],
                  gtypes=(GGML_Q8_0,))
    cfg = tdec.DecoderConfig.tiny(dtype=torch.float32)
    qm = tdec.CompletionModel(tdec.DecoderConfig.tiny(dtype=torch.float32,
                                                      quantized=True),
                              weights=path, buckets=(16,), temp=0.0,
                              device="cpu")
    block = np.dtype([("d", "<f2"), ("qs", "i1", (32,))])
    names = {"attn.q": "attn_q", "attn.k": "attn_k", "attn.v": "attn_v",
             "attn.out": "attn_output", "gate": "ffn_gate", "up": "ffn_up",
             "down": "ffn_down"}
    with GgufFile(path) as gf:
        for i in range(cfg.layers):
            for mod, gname in names.items():
                ti = gf.tensors[f"blk.{i}.{gname}.weight"]
                assert ti.ggml_type == GGML_Q8_0
                din, dout = ti.dims          # ne[0] is the input width
                raw = np.frombuffer(gf._mm, block, count=din * dout // 32,
                                    offset=gf._data_start + ti.offset)
                raw = raw.reshape(dout, din // 32).copy()
                m = qm.module.get_submodule(f"layer_{i}.{mod}")
                q = raw["qs"].transpose(1, 2, 0)          # (nb, 32, out)
                assert torch.equal(m.q, torch.from_numpy(q.copy()))
                assert torch.equal(m.scale, torch.from_numpy(
                    raw["d"].astype(np.float32).T.copy()))
    fm = tdec.CompletionModel(cfg, weights=path, buckets=(16,), temp=0.0,
                              device="cpu")
    prompt = np.array([1, 5, 9, 300, 17, 2, 44], np.int32)
    np.testing.assert_allclose(qm.prefill(prompt), fm.prefill(prompt),
                               rtol=0, atol=ATOL)


# -- the daemon -----------------------------------------------------------------

@pytest.fixture
def store():
    name = f"/spt-tquant-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    st = Store.create(name, nslots=64, max_val=4096, vec_dim=0)
    yield st
    st.close()
    Store.unlink(name)


@pytest.mark.parametrize("flags,cls", [
    (["--quantized"], tq.QuantDense),
    (["--weights-int8"], tq.ChannelQuantDense),
    (["--weights", "int8", "--continuous"], tq.ChannelQuantDense)],
    ids=["quantized", "weights-int8", "weights-int8-continuous"])
def test_main_serves_int8_weights_on_the_cpu(store, monkeypatch, flags, cls):
    """`main --quantized` / `--weights-int8` / `--weights int8` build the
    full-width decoder int8-resident (a short window) and serve to
    READY on --device cpu."""
    built = {}
    orig = tcomp.Completer.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        built["model"] = self._model

    monkeypatch.setattr(tcomp.Completer, "__init__", spy)
    run_orig = tcomp.Completer.run_continuous

    def run_then_stop(self, **kw):
        th = threading.Thread(target=run_orig, args=(self,),
                              kwargs=dict(idle_timeout_ms=20,
                                          stop_after=300.0), daemon=True)
        th.start()
        deadline = time.time() + 280
        while time.time() < deadline \
                and not store.labels("q") & P.LBL_READY:
            time.sleep(0.02)
        self.stop()
        th.join(timeout=60)

    monkeypatch.setattr(tcomp.Completer, "run_continuous", run_then_stop)
    store.set("q", "hello")
    store.label_or("q", P.LBL_INFER_REQ)
    store.bump("q")
    argv = ["--store", store.name, "--device", "cpu", "--n-ctx", "128",
            "--max-new-tokens", "3", "--batch-cap", "2", *flags]
    if "--continuous" not in flags:
        argv.append("--oneshot")
    assert tcomp.main(argv) == 0
    assert store.labels("q") & P.LBL_READY
    assert store.get("q").startswith(b"hello")
    assert isinstance(built["model"].module.layer_0.attn.q, cls)


def test_main_refuses_both_residencies():
    for flags in (["--quantized", "--weights-int8"],
                  ["--quantized", "--weights", "int8"]):
        with pytest.raises(SystemExit) as exc:
            tcomp.main(["--store", "/spt-never-opened", "--device", "cpu",
                        *flags])
        assert "mutually exclusive" in str(exc.value.code)
