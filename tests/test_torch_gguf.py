"""The torch port's GGUF support (libsplinter_tpu_torch/models/gguf.py)
against the JAX package's reader, on the same files, on the CPU.

Every file is written here with the port's gguf_writer (or, for the
ggml types the writer does not emit, as raw blocks) from seeded numpy.

Tolerances: none for the container, the dequantizers (bit-identical
arrays), the loaded state dicts (equal to the bridged source or to the
bridged JAX load) and the tokenizers (identical ids, pieces and
decodes); 1e-5 for encoder vectors and decoder logits in f32, the
forward passes' sums being taken in another order by the two
frameworks."""
import os
import struct
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jgguf = pytest.importorskip("libsplinter_tpu.models.gguf")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")

from libsplinter_tpu_torch import Store  # noqa: E402
from libsplinter_tpu_torch.engine import completer as tcomp  # noqa: E402
from libsplinter_tpu_torch.engine import protocol as P  # noqa: E402
from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.models import gguf as tgguf  # noqa: E402
from libsplinter_tpu_torch.models.gguf_writer import (  # noqa: E402
    GGML_F32, GGML_Q4_0, GGML_Q8_0, kv_f32, kv_f32_array, kv_i32_array,
    kv_str, kv_str_array, kv_u32, write_gguf)

ATOL = 1e-5


def _s(txt: str) -> bytes:
    b = txt.encode()
    return struct.pack("<Q", len(b)) + b


def _f32_tree(params, rng, scale=0.05):
    """A flax tree as f32 numpy, each leaf moved off its init so norms
    are not at identity."""
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=scale, size=x.shape).astype(np.float32), params)


def _assert_state_dicts_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------- container

def test_container_metadata_and_tensors_match_jax(tmp_path):
    path = tmp_path / "m.gguf"
    rng = np.random.default_rng(0)
    arr = rng.standard_normal((8, 64)).astype(np.float32)
    write_gguf(path, {"t.weight": (arr, GGML_F32),
                      "q.weight": (arr * 2, GGML_Q8_0)},
               [kv_str("general.name", "demo"),
                kv_u32("demo.n_layer", 3),
                kv_f32("demo.eps", 1e-6),
                kv_f32_array("demo.scores", [0.5, -1.0]),
                kv_i32_array("demo.types", [1, 3, -2]),
                kv_str_array("demo.tokens", ["a", "ß", ""])],
               align=64)
    with tgguf.GgufFile(path) as got, jgguf.GgufFile(path) as want:
        assert got.metadata == want.metadata
        assert got.metadata["demo.tokens"] == ["a", "ß", ""]
        assert got._data_start == want._data_start
        assert {n: (t.dims, t.ggml_type, t.offset)
                for n, t in got.tensors.items()} == \
            {n: (t.dims, t.ggml_type, t.offset)
             for n, t in want.tensors.items()}
        for name in want.tensors:
            a, b = got.tensor(name), want.tensor(name)
            assert a.shape == b.shape == (8, 64)
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
        np.testing.assert_array_equal(got.tensor("t.weight"), arr)
        with pytest.raises(KeyError, match="no tensor"):
            got.tensor("missing")


def _huge_array(p):
    body = struct.pack("<IIQQ", 0x46554747, 3, 0, 1)     # 0 tensors, 1 kv
    body += _s("evil.key") + struct.pack("<I", 9)        # an array
    body += struct.pack("<IQ", 8, 1 << 60)               # of strings
    p.write_bytes(body)


def _huge_string(p):
    body = struct.pack("<IIQQ", 0x46554747, 3, 0, 1)
    body += struct.pack("<Q", 1 << 62)                   # key length
    p.write_bytes(body)


def _huge_kv_count(p):
    p.write_bytes(struct.pack("<IIQQ", 0x46554747, 3, 0, 1 << 58))


def _bad_magic(p):
    p.write_bytes(b"NOPE" + b"\0" * 64)


@pytest.mark.parametrize("make,match", [
    (_bad_magic, "magic"), (_huge_array, "exceeds remaining"),
    (_huge_string, "exceeds remaining"),
    (_huge_kv_count, "exceeds remaining"),
], ids=["bad_magic", "huge_array", "huge_string", "huge_kv_count"])
def test_corrupt_files_fail_fast(tmp_path, make, match):
    p = tmp_path / "evil.gguf"
    make(p)
    with pytest.raises(tgguf.GgufError, match=match) as got:
        tgguf.GgufFile(p)
    with pytest.raises(jgguf.GgufError) as want:
        jgguf.GgufFile(p)
    assert str(got.value) == str(want.value)


# --------------------------------------------------------- dequantization

# each block-quantized type's record, as ggml lays it out: (elements per
# block, fields); every field is filled with seeded values (finite
# scales, integers over their whole range)
_BLOCKS = {
    tgguf.GGML_Q8_0: (32, [("d", "<f2"), ("qs", "i1", (32,))]),
    tgguf.GGML_Q4_0: (32, [("d", "<f2"), ("qs", "u1", (16,))]),
    tgguf.GGML_Q4_1: (32, [("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))]),
    tgguf.GGML_Q5_0: (32, [("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))]),
    tgguf.GGML_Q5_1: (32, [("d", "<f2"), ("m", "<f2"), ("qh", "<u4"),
                           ("qs", "u1", (16,))]),
    tgguf.GGML_Q2_K: (256, [("scales", "u1", (16,)), ("qs", "u1", (64,)),
                            ("d", "<f2"), ("dmin", "<f2")]),
    tgguf.GGML_Q3_K: (256, [("hmask", "u1", (32,)), ("qs", "u1", (64,)),
                            ("scales", "u1", (12,)), ("d", "<f2")]),
    tgguf.GGML_Q4_K: (256, [("d", "<f2"), ("dmin", "<f2"),
                            ("scales", "u1", (12,)), ("qs", "u1", (128,))]),
    tgguf.GGML_Q5_K: (256, [("d", "<f2"), ("dmin", "<f2"),
                            ("scales", "u1", (12,)), ("qh", "u1", (32,)),
                            ("qs", "u1", (128,))]),
    tgguf.GGML_Q6_K: (256, [("ql", "u1", (128,)), ("qh", "u1", (64,)),
                            ("sc", "i1", (16,)), ("d", "<f2")]),
    tgguf.GGML_Q8_K: (256, [("d", "<f4"), ("qs", "i1", (256,)),
                            ("bsums", "<i2", (16,))]),
}
_DEQUANT_TYPES = (tgguf.GGML_F32, tgguf.GGML_F16, tgguf.GGML_BF16,
                  *_BLOCKS)


def _payload(gtype: int, n: int, rng) -> bytes:
    if gtype == tgguf.GGML_F32:
        return rng.standard_normal(n).astype("<f4").tobytes()
    if gtype == tgguf.GGML_F16:
        return rng.standard_normal(n).astype("<f2").tobytes()
    if gtype == tgguf.GGML_BF16:
        f = rng.standard_normal(n).astype("<f4")
        return (f.view(np.uint32) >> 16).astype("<u2").tobytes()
    block, fields = _BLOCKS[gtype]
    rec = np.zeros(n // block, np.dtype(fields))
    for name in rec.dtype.names:
        dt = rec.dtype[name].base
        shape = rec[name].shape
        if dt.kind == "f":
            rec[name] = (rng.standard_normal(shape) * 0.05).astype(dt)
        else:
            info = np.iinfo(dt)
            rec[name] = rng.integers(info.min, info.max, size=shape,
                                     dtype=dt, endpoint=True)
    return rec.tobytes()


def _write_raw(path, name: str, shape: tuple, gtype: int, payload: bytes):
    """One tensor of any ggml type, its bytes given as they lie on disk."""
    ne = tuple(reversed(shape))
    head = struct.pack("<IIQQ", 0x46554747, 3, 1, 0)
    head += (_s(name) + struct.pack("<I", len(ne))
             + struct.pack(f"<{len(ne)}Q", *ne)
             + struct.pack("<IQ", gtype, 0))
    head += b"\0" * ((-len(head)) % 32)
    path.write_bytes(head + payload)


@pytest.mark.parametrize("gtype", _DEQUANT_TYPES,
                         ids=[tgguf._TYPE_NAMES[t] for t in _DEQUANT_TYPES])
def test_dequantization_bit_identical_to_jax(tmp_path, gtype):
    shape = (4, 512)                      # 8 super-blocks, 64 blocks
    rng = np.random.default_rng(100 + gtype)
    path = tmp_path / f"t{gtype}.gguf"
    _write_raw(path, "w", shape, gtype, _payload(gtype, 4 * 512, rng))
    with tgguf.GgufFile(path) as got_f, jgguf.GgufFile(path) as want_f:
        got, want = got_f.tensor("w"), want_f.tensor("w")
    # float32, except Q3_K's float64 (the reader's np.where promotes;
    # the weight loaders cast to float32)
    assert got.dtype == want.dtype
    assert got.dtype == (np.float64 if gtype == tgguf.GGML_Q3_K
                         else np.float32)
    assert got.shape == want.shape == shape
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


# ------------------------------------------------------ encoder round trip

def _encoder_file(path, cfg_j, p, *, split_qkv=False, token_types=None):
    """A bert/nomic-bert GGUF of the flax tree p (f32 numpy), with the
    metadata config derivation reads."""
    arch = "bert" if cfg_j.variant == "bert" else "nomic-bert"
    t = {"token_embd.weight": p["tok_emb"]["embedding"],
         "token_embd_norm.weight": p["ln_emb"]["scale"],
         "token_embd_norm.bias": p["ln_emb"]["bias"]}
    if token_types is not None:
        t["token_types.weight"] = token_types
    if cfg_j.variant == "bert":
        t["position_embd.weight"] = p["pos_emb"]["embedding"]
    for i in range(cfg_j.layers):
        lp = p[f"layer_{i}"]
        b = f"blk.{i}"
        qkv = lp["attn"]["qkv"]
        if split_qkv:
            for part, w, bias in zip(
                    "qkv", np.split(qkv["kernel"].T, 3),
                    np.split(qkv["bias"], 3)):
                t[f"{b}.attn_{part}.weight"] = w.copy()
                t[f"{b}.attn_{part}.bias"] = bias
        else:
            t[f"{b}.attn_qkv.weight"] = qkv["kernel"].T.copy()
            t[f"{b}.attn_qkv.bias"] = qkv["bias"]
        t[f"{b}.attn_output.weight"] = lp["attn"]["out"]["kernel"].T.copy()
        t[f"{b}.attn_output.bias"] = lp["attn"]["out"]["bias"]
        t[f"{b}.attn_output_norm.weight"] = lp["ln_attn"]["scale"]
        t[f"{b}.attn_output_norm.bias"] = lp["ln_attn"]["bias"]
        t[f"{b}.layer_output_norm.weight"] = lp["ln_mlp"]["scale"]
        t[f"{b}.layer_output_norm.bias"] = lp["ln_mlp"]["bias"]
        for name in lp["mlp"]:
            t[f"{b}.ffn_{name}.weight"] = lp["mlp"][name]["kernel"].T.copy()
            t[f"{b}.ffn_{name}.bias"] = lp["mlp"][name]["bias"]
    md = [kv_str("general.architecture", arch),
          kv_u32(f"{arch}.embedding_length", cfg_j.hidden),
          kv_u32(f"{arch}.block_count", cfg_j.layers),
          kv_u32(f"{arch}.attention.head_count", cfg_j.heads),
          kv_u32(f"{arch}.feed_forward_length", cfg_j.mlp_dim),
          kv_u32(f"{arch}.context_length", cfg_j.max_len),
          kv_f32(f"{arch}.attention.layer_norm_epsilon", 1e-12)]
    write_gguf(path, {k: (v, GGML_F32) for k, v in t.items()}, md)


@pytest.mark.parametrize("variant", ["nomic", "bert"])
def test_encoder_round_trip(tmp_path, variant):
    """nomic: fused QKV, the state dict equals params_from_jax of the
    source exactly.  bert: split q/k/v and a token_types table, whose
    row 0 the loader folds into the embedding as the JAX package does.
    Both: vectors within 1e-5 of the JAX EmbeddingModel on the file."""
    cfg_j = jenc.EncoderConfig.tiny(variant=variant, dtype=jnp.float32)
    cfg_t = tenc.EncoderConfig.tiny(variant=variant, dtype=torch.float32)
    rng = np.random.default_rng(11)
    params = _f32_tree(jenc.Encoder(cfg_j).init(
        jax.random.PRNGKey(2), np.ones((1, 8), np.int32),
        np.ones((1, 8), bool)), rng)
    p = params["params"]
    tt = None
    if variant == "bert":
        tt = rng.normal(scale=0.1, size=(2, cfg_j.hidden)).astype(np.float32)
    path = tmp_path / f"{variant}.gguf"
    _encoder_file(path, cfg_j, p, split_qkv=variant == "bert",
                  token_types=tt)

    got = tgguf.load_encoder_params(str(path), cfg_t)
    want_tree = jax.tree.map(lambda x: x, params)
    if tt is not None:
        want_tree["params"]["tok_emb"]["embedding"] = (
            p["tok_emb"]["embedding"] + tt[0][None, :])
    _assert_state_dicts_equal(got, tenc.params_from_jax(want_tree, cfg_t))
    _assert_state_dicts_equal(got, tenc.params_from_jax(
        jgguf.load_encoder_params(str(path), cfg_j), cfg_t))

    jm = jenc.EmbeddingModel(cfg_j, weights=str(path), buckets=(16, 32))
    tm = tenc.EmbeddingModel(cfg_t, weights=str(path), buckets=(16, 32),
                             device="cpu")
    lens = np.array([3, 16, 9, 1], np.int32)
    ids = rng.integers(5, cfg_j.vocab_size, (4, 16)).astype(np.int32)
    ids[np.arange(16)[None] >= lens[:, None]] = 0
    want = np.asarray(jm.encode_ids(ids, lens))
    got_v = np.asarray(tm.encode_ids(ids, lens))
    np.testing.assert_allclose(got_v, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got_v, axis=1), 1.0,
                               atol=1e-5)


def test_encoder_vocab_cut_and_guards(tmp_path):
    """A file vocab larger than the config's is cut to its first rows,
    as the JAX package cuts it; a smaller one, or fewer position rows
    than max_len, raises in both."""
    cfg_j = jenc.EncoderConfig.tiny(variant="bert", dtype=jnp.float32)
    params = _f32_tree(jenc.Encoder(cfg_j).init(
        jax.random.PRNGKey(3), np.ones((1, 8), np.int32),
        np.ones((1, 8), bool)), np.random.default_rng(12))
    path = tmp_path / "bert.gguf"
    _encoder_file(path, cfg_j, params["params"])
    for vocab in (1000, cfg_j.vocab_size):
        cj = jenc.EncoderConfig.tiny(variant="bert", vocab_size=vocab)
        ct = tenc.EncoderConfig.tiny(variant="bert", vocab_size=vocab)
        got = tgguf.load_encoder_params(str(path), ct)
        assert got["tok_emb.weight"].shape == (vocab, cfg_j.hidden)
        _assert_state_dicts_equal(got, tenc.params_from_jax(
            jgguf.load_encoder_params(str(path), cj), ct))
    for kw, match in (({"vocab_size": 2048}, "GGUF vocab"),
                      ({"max_len": 256}, "position rows")):
        ct = tenc.EncoderConfig.tiny(variant="bert", **kw)
        with pytest.raises(ValueError, match=match):
            tgguf.load_encoder_params(str(path), ct)


# ------------------------------------------------------ decoder round trip

_CHATML = ("{% for m in messages %}<|im_start|>{{ m.role }}\n"
           "{{ m.content }}<|im_end|>\n{% endfor %}<|im_start|>assistant\n")


def _unigram_vocab(n: int, rng):
    """A llama (unigram) vocab of n pieces: <unk> <s> </s>, the 256
    byte pieces, the chatml markers as control tokens, then seeded
    word pieces with seeded scores."""
    T = tgguf
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [T.TOKTYPE_UNKNOWN, T.TOKTYPE_CONTROL, T.TOKTYPE_CONTROL] \
        + [T.TOKTYPE_BYTE] * 256
    tokens += ["<|im_start|>", "<|im_end|>"]
    types += [T.TOKTYPE_CONTROL] * 2
    base = ["the", "cat", "sat", "on", "mat", "hello", "world", "user",
            "a", "b", "at", "he", "llo"]
    pieces = [f"▁{w}" for w in base] + base + ["▁"]
    letters = list("abcdefghijklmnopqrstuvwxyz")
    seen = set(tokens) | set(pieces)
    while len(tokens) + len(pieces) < n:
        w = "".join(rng.choice(letters, int(rng.integers(1, 6))))
        w = ("▁" + w) if rng.random() < 0.5 else w
        if w not in seen:
            seen.add(w)
            pieces.append(w)
    tokens += pieces
    types += [T.TOKTYPE_NORMAL] * len(pieces)
    scores = [0.0] * 261 + [-float(len(t)) ** 0.5 - rng.random()
                            for t in pieces]
    return tokens, scores, types


def _decoder_file(path, cfg_j, p, *, tied=False, gtypes=(GGML_F32,),
                  vocab=None, experts=0):
    """A llama-family GGUF of the flax decoder tree p (f32 numpy), each
    layer's projections in gtypes[i % len(gtypes)], with the metadata
    keys the JAX package's tests write and a unigram tokenizer.  With
    experts, a Mixtral-family file: each layer's moe subtree as the
    router blk.N.ffn_gate_inp and the stacked blk.N.ffn_{gate,up,down}_exps
    (F32), and the expert_count / expert_used_count keys."""
    def g(i):
        return gtypes[i % len(gtypes)]

    t = {"token_embd.weight": (p["tok_emb"]["embedding"], g(0)),
         "output_norm.weight": (p["ln_out"]["scale"], GGML_F32)}
    if not tied:
        t["output.weight"] = (p["lm_head"]["kernel"].T.copy(), g(0))
    for i in range(cfg_j.layers):
        lp = p[f"layer_{i}"]
        b = f"blk.{i}"
        t[f"{b}.attn_norm.weight"] = (lp["ln_attn"]["scale"], GGML_F32)
        t[f"{b}.ffn_norm.weight"] = (lp["ln_mlp"]["scale"], GGML_F32)
        for src, dst in (("q", "attn_q"), ("k", "attn_k"),
                         ("v", "attn_v"), ("out", "attn_output")):
            t[f"{b}.{dst}.weight"] = (lp["attn"][src]["kernel"].T.copy(),
                                      g(i))
        if experts:
            moe = lp["moe"]
            t[f"{b}.ffn_gate_inp.weight"] = (
                moe["router"]["kernel"].T.copy(), GGML_F32)
            for name in ("gate", "up", "down"):
                # (E, in, out) -> the file's (E, out, in) numpy view
                t[f"{b}.ffn_{name}_exps.weight"] = (np.ascontiguousarray(
                    moe[f"{name}_experts"].transpose(0, 2, 1)), GGML_F32)
            continue
        for name in ("gate", "up", "down"):
            t[f"{b}.ffn_{name}.weight"] = (lp[name]["kernel"].T.copy(), g(i))
    tokens, scores, types = vocab or _unigram_vocab(
        cfg_j.vocab_size, np.random.default_rng(0))
    md = [kv_str("general.architecture", "llama"),
          kv_u32("llama.block_count", cfg_j.layers),
          kv_u32("llama.embedding_length", cfg_j.hidden),
          kv_u32("llama.attention.head_count", cfg_j.heads),
          kv_u32("llama.attention.head_count_kv", cfg_j.kv_heads),
          kv_u32("llama.feed_forward_length", cfg_j.mlp_dim),
          kv_u32("llama.context_length", cfg_j.max_len),
          kv_f32("llama.rope.freq_base", 10000.0),
          kv_f32("llama.attention.layer_norm_rms_epsilon", 1e-5),
          kv_str("tokenizer.ggml.model", "llama"),
          kv_str_array("tokenizer.ggml.tokens", tokens),
          kv_f32_array("tokenizer.ggml.scores", scores),
          kv_i32_array("tokenizer.ggml.token_type", types),
          kv_u32("tokenizer.ggml.bos_token_id", 1),
          kv_u32("tokenizer.ggml.eos_token_id", 2),
          kv_u32("tokenizer.ggml.unknown_token_id", 0),
          kv_str("tokenizer.chat_template", _CHATML)]
    if experts:
        md += [kv_u32("llama.expert_count", experts),
               kv_u32("llama.expert_used_count", 2)]
    write_gguf(path, t, md)


def _decoder_params(cfg_j, seed):
    return _f32_tree(jdec.Decoder(cfg_j).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0)),
        np.random.default_rng(seed))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_decoder_round_trip(tmp_path, tied):
    """Layer 0 in F32, layer 1 in Q8_0, the embedding (and head) in F32;
    then the same with Q4_0: the state dict equals the bridged JAX load
    exactly (the source itself in F32), logits within 1e-5 of the JAX
    CompletionModel on the same file."""
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    cfg_t = tdec.DecoderConfig.tiny(dtype=torch.float32)
    params = _decoder_params(cfg_j, 4)
    p = params["params"]
    if tied:
        p["lm_head"]["kernel"] = p["tok_emb"]["embedding"].T.copy()
    for gtypes in ((GGML_F32, GGML_Q8_0), (GGML_Q4_0, GGML_F32)):
        path = tmp_path / f"lm-{gtypes[0]}-{gtypes[1]}.gguf"
        _decoder_file(path, cfg_j, p, tied=tied, gtypes=gtypes)
        got = tgguf.load_decoder_params(str(path), cfg_t)
        _assert_state_dicts_equal(got, tdec.params_from_jax(
            jgguf.load_decoder_params(str(path), cfg_j), cfg_t))
        if tied:
            assert torch.equal(got["lm_head.weight"], got["tok_emb.weight"])
        if gtypes[0] == GGML_F32:
            src = tdec.params_from_jax(params, cfg_t)
            for k in ("tok_emb.weight", "lm_head.weight",
                      "layer_0.attn.q.weight", "layer_0.down.weight",
                      "layer_1.ln_attn.weight"):
                assert torch.equal(got[k], src[k]), k
        jm = jdec.CompletionModel(cfg_j, weights=str(path), buckets=(16,),
                                  temp=0.0)
        tm = tdec.CompletionModel(cfg_t, weights=str(path), buckets=(16,),
                                  temp=0.0, device="cpu")
        prompt = np.array([1, 5, 9, 300, 17, 2, 44], np.int32)
        np.testing.assert_allclose(tm.prefill(prompt), jm.prefill(prompt),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(tm.decode_one(7), jm.decode_one(7),
                                   rtol=0, atol=ATOL)


def test_decoder_vocab_cut_and_guards(tmp_path):
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    path = tmp_path / "lm.gguf"
    _decoder_file(path, cfg_j, _decoder_params(cfg_j, 5)["params"],
                  tied=True)
    cj = jdec.DecoderConfig.tiny(vocab_size=1000)
    ct = tdec.DecoderConfig.tiny(vocab_size=1000)
    got = tgguf.load_decoder_params(str(path), ct)
    assert got["lm_head.weight"].shape == (1000, cfg_j.hidden)
    _assert_state_dicts_equal(got, tdec.params_from_jax(
        jgguf.load_decoder_params(str(path), cj), ct))
    with pytest.raises(ValueError, match="GGUF vocab"):
        tgguf.load_decoder_params(str(path),
                                  tdec.DecoderConfig.tiny(vocab_size=2048))
    with pytest.raises(KeyError, match="blk.2.attn_norm"):
        tgguf.load_decoder_params(str(path), tdec.DecoderConfig.tiny(
            layers=3))


# ------------------------------------------------------ config derivation

def _same_fields(got, want):
    """Every field the two configs share equal; dtypes by name."""
    import dataclasses
    names = ({f.name for f in dataclasses.fields(got)}
             & {f.name for f in dataclasses.fields(want)}) - {"dtype"}
    assert len(names) > 5
    for n in names:
        assert getattr(got, n) == getattr(want, n), n
    assert str(got.dtype).removeprefix("torch.") == \
        np.dtype(want.dtype).name


@pytest.mark.parametrize("overrides", [{}, {"max_len": 64},
                                       {"dtype": "float32"}],
                         ids=["file", "max_len", "dtype"])
def test_config_derivation_matches_jax(tmp_path, overrides):
    cfg_j = jdec.DecoderConfig.tiny(kv_heads=2, rope_base=50000.0)
    dpath = tmp_path / "lm.gguf"
    _decoder_file(dpath, cfg_j, _decoder_params(cfg_j, 6)["params"])
    ecfg = jenc.EncoderConfig.tiny(variant="bert", dtype=jnp.float32)
    epath = tmp_path / "enc.gguf"
    _encoder_file(epath, ecfg, _f32_tree(jenc.Encoder(ecfg).init(
        jax.random.PRNGKey(0), np.ones((1, 8), np.int32),
        np.ones((1, 8), bool)), np.random.default_rng(0))["params"])

    def kw(mod):
        out = dict(overrides)
        if "dtype" in out:
            out["dtype"] = getattr(mod, out["dtype"])
        return out

    got = tgguf.decoder_config_from_gguf(str(dpath), **kw(torch))
    want = jgguf.decoder_config_from_gguf(str(dpath), **kw(jnp))
    assert isinstance(got, tdec.DecoderConfig)
    _same_fields(got, want)
    assert (got.vocab_size, got.kv_heads, got.rms_eps) == \
        (cfg_j.vocab_size, 2, np.float32(1e-5))
    with tgguf.GgufFile(epath) as gf:          # an open file is accepted
        got = tgguf.encoder_config_from_gguf(gf, out_dim=32, **kw(torch))
        assert gf.metadata                     # and left open
    want = jgguf.encoder_config_from_gguf(str(epath), out_dim=32,
                                          **kw(jnp))
    assert isinstance(got, tenc.EncoderConfig) and got.variant == "bert"
    _same_fields(got, want)


def test_missing_metadata_is_loud(tmp_path):
    p = tmp_path / "sparse.gguf"
    write_gguf(p, {"token_embd.weight":
                   (np.zeros((8, 4), np.float32), GGML_F32)},
               [kv_str("general.architecture", "llama")])
    for fn in (tgguf.decoder_config_from_gguf,
               tgguf.encoder_config_from_gguf):
        with pytest.raises(tgguf.GgufError, match="lacks"):
            fn(str(p))
    with pytest.raises(tgguf.GgufError, match="no tokenizer metadata"):
        tgguf.load_tokenizer(str(p))


def test_moe_file_is_refused_with_roadmap_pointer(tmp_path):
    """A Mixtral-family file, once refused by the port, now resolves and
    loads as the JAX package does: the same MoeDecoderConfig (experts,
    top-k and every other field), a state_dict equal leaf by leaf to the
    bridged JAX load, logits within 1e-5 of the JAX MoE CompletionModel
    on the same file, and completer.main serving it on the CPU."""
    jmoe = pytest.importorskip("libsplinter_tpu.models.moe")
    from libsplinter_tpu_torch.models import moe as tmoe

    cfg_j = jmoe.MoeDecoderConfig.tiny(dtype=jnp.float32, n_experts=4)
    params = _f32_tree(jmoe.MoeDecoder(cfg_j).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(cfg_j, 1), jnp.int32(0)),
        np.random.default_rng(7))
    path = tmp_path / "moe.gguf"
    _decoder_file(path, cfg_j, params["params"], experts=cfg_j.n_experts)
    jcfg = jgguf.decoder_config_from_gguf(str(path), dtype=jnp.float32)
    tcfg = tgguf.decoder_config_from_gguf(str(path), dtype=torch.float32)
    assert type(jcfg).__name__ == "MoeDecoderConfig"
    assert isinstance(tcfg, tmoe.MoeDecoderConfig)
    for f in ("vocab_size", "hidden", "layers", "heads", "kv_heads",
              "mlp_dim", "max_len", "n_experts", "top_k"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    got = tgguf.load_decoder_params(str(path), tcfg)
    _assert_state_dicts_equal(got, tdec.params_from_jax(
        jgguf.load_decoder_params(str(path), jcfg), tcfg))
    assert got["layer_1.moe.down_experts"].shape == (
        4, cfg_j.mlp_dim, cfg_j.hidden)
    jm = jmoe.moe_completion_model(jcfg, weights=str(path), buckets=(16,),
                                   temp=0.0)
    tm = tmoe.moe_completion_model(tcfg, weights=str(path), buckets=(16,),
                                   temp=0.0, device="cpu")
    prompt = np.array([1, 5, 9, 300, 17, 2, 44], np.int32)
    np.testing.assert_allclose(tm.prefill(prompt), jm.prefill(prompt),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.decode_one(7), jm.decode_one(7),
                               rtol=0, atol=ATOL)
    name = f"/spt-tgm-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=64, max_val=2048, vec_dim=0)
    try:
        st.set("q", "hello experts")
        st.label_or("q", P.LBL_INFER_REQ | P.LBL_WAITING)
        st.bump("q")
        assert tcomp.main(["--store", name, "--device", "cpu", "--weights",
                           str(path), "--oneshot", "--max-new-tokens", "4",
                           "--template", "auto"]) == 0
        assert st.labels("q") & P.LBL_READY
        assert st.get("q").rstrip(b"\0").startswith(b"<|im_start|>user")
    finally:
        st.close()
        Store.unlink(name)


# -------------------------------------------------------------- tokenizers

TEXTS = ["the cat sat on the mat", "Hello, World!  two  spaces",
         "<|im_start|>user\nhello<|im_end|>\n<|im_start|>assistant\n",
         "naïve café ☕ über", "tab\tand\nnewline\n", " leading space",
         "unknownwordzz 12345", "", "a<|im_end|>b<s></s>"]


def _bert_file(path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat",
             "sat", "on", "mat", "hello", "world", ",", "!", "two",
             "spaces", "##s", "##ly", "un", "##known", "##word", "1",
             "##2", "##3", "na", "##ive", "cafe", "caf", "##e"]
    write_gguf(path, {"dummy": (np.zeros((1, 1), np.float32), GGML_F32)},
               [kv_str("tokenizer.ggml.model", "bert"),
                kv_str_array("tokenizer.ggml.tokens", vocab)])
    return len(vocab)


def _llama_file(path):
    tokens, scores, types = _unigram_vocab(600, np.random.default_rng(1))
    write_gguf(path, {"dummy": (np.zeros((1, 1), np.float32), GGML_F32)},
               [kv_str("tokenizer.ggml.model", "llama"),
                kv_str_array("tokenizer.ggml.tokens", tokens),
                kv_f32_array("tokenizer.ggml.scores", scores),
                kv_i32_array("tokenizer.ggml.token_type", types),
                kv_u32("tokenizer.ggml.bos_token_id", 1),
                kv_u32("tokenizer.ggml.eos_token_id", 2),
                kv_u32("tokenizer.ggml.unknown_token_id", 0)])
    return len(tokens)


def _gpt2_file(path):
    b2u = tgguf._gpt2_byte_map()
    sp = b2u[ord(" ")]
    vocab = [b2u[b] for b in range(256)]
    merges = [f"{sp} c", "a t", f"{sp}c at", "h e", "l l", "ll o",
              "he llo", f"{sp} hello", "t h", "th e", f"{sp} the"]
    for m in merges:
        vocab.append(m.replace(" ", ""))
    vocab += ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    types = [tgguf.TOKTYPE_NORMAL] * (len(vocab) - 3) \
        + [tgguf.TOKTYPE_CONTROL, tgguf.TOKTYPE_CONTROL,
           tgguf.TOKTYPE_USER_DEFINED]
    write_gguf(path, {"dummy": (np.zeros((1, 1), np.float32), GGML_F32)},
               [kv_str("tokenizer.ggml.model", "gpt2"),
                kv_str_array("tokenizer.ggml.tokens", vocab),
                kv_str_array("tokenizer.ggml.merges", merges),
                kv_i32_array("tokenizer.ggml.token_type", types),
                kv_u32("tokenizer.ggml.eos_token_id", len(vocab) - 3)])
    return len(vocab)


@pytest.mark.parametrize("make", [_bert_file, _llama_file, _gpt2_file],
                         ids=["bert", "llama", "gpt2"])
def test_tokenizers_match_jax(tmp_path, make):
    path = tmp_path / "tok.gguf"
    n = make(path)
    got = tgguf.load_tokenizer(str(path))
    want = jgguf.load_tokenizer(str(path))
    assert type(got).__name__ == type(want).__name__
    assert got.pad_id == want.pad_id and got.eos_id == want.eos_id
    for i in range(n + 2):                    # two ids past the vocab
        assert got.token_to_piece(i) == want.token_to_piece(i), i
    if make is _bert_file:
        for text in TEXTS:
            assert got.encode(text) == want.encode(text), text
            assert got.encode(text, max_len=4) == \
                want.encode(text, max_len=4), text
        g_ids, g_lens = got.encode_batch(TEXTS, 16)
        w_ids, w_lens = want.encode_batch(TEXTS, 16)
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_array_equal(g_lens, w_lens)
        return
    seen_special = seen_byte = False
    for text in TEXTS:
        for bos in (True, False):
            ids = got.encode(text, add_bos=bos)
            assert ids == want.encode(text, add_bos=bos), (text, bos)
            assert got.decode(ids) == want.decode(ids), text
            seen_special |= any(i in got.special.ids.values() for i in ids)
            seen_byte |= any(got.tokens[i].startswith("<0x") for i in ids)
        assert got.encode(text, 3) == want.encode(text, 3)
    assert seen_special
    assert seen_byte or make is _gpt2_file


# ------------------------------------------- the decoder daemon on a GGUF

@pytest.fixture
def store():
    name = f"/spt-tg-{uuid.uuid4().hex[:8]}"
    st = Store.create(name, nslots=64, max_val=2048, vec_dim=0)
    yield st
    st.close()
    Store.unlink(name)


def test_gguf_decoder_greedy_and_completer_main(tmp_path, store):
    """A tiny GGUF decoder: the port's CompletionModel on the file gives
    the JAX CompletionModel's greedy tokens; completer.main, given the
    file alone, resolves --template auto to chatml from the file's
    tokenizer.chat_template and serves a request to READY."""
    cfg_j = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    path = tmp_path / "chat.gguf"
    _decoder_file(path, cfg_j, _decoder_params(cfg_j, 8)["params"],
                  gtypes=(GGML_F32, GGML_Q8_0))
    tok = tgguf.load_tokenizer(str(path))
    prompt = np.asarray(tok.encode("the cat sat on the mat"), np.int32)
    cfg_t = tgguf.decoder_config_from_gguf(str(path), dtype=torch.float32)
    jm = jdec.CompletionModel(jgguf.decoder_config_from_gguf(
        str(path), dtype=jnp.float32), weights=str(path), buckets=(16,),
        temp=0.0)
    tm = tdec.CompletionModel(cfg_t, weights=str(path), buckets=(16,),
                              temp=0.0, device="cpu")
    want = list(jm.generate_tokens(prompt, 12, chunk=4))
    got = list(tm.generate_tokens(prompt, 12, chunk=4))
    assert got == want

    store.set("ask", "hello world")
    store.label_or("ask", P.LBL_INFER_REQ | P.LBL_WAITING)
    store.bump("ask")
    assert tcomp.main(["--store", store.name, "--device", "cpu",
                       "--oneshot", "--weights", str(path), "--template",
                       "auto", "--max-new-tokens", "6"]) == 0
    labels = store.labels("ask")
    assert labels & P.LBL_READY
    assert not labels & (P.LBL_INFER_REQ | P.LBL_SERVICING | P.LBL_WAITING)
    out = store.get("ask").rstrip(b"\0")
    rendered = b"<|im_start|>user\nhello world<|im_end|>\n" \
        b"<|im_start|>assistant\n"
    assert out.startswith(rendered)           # chatml, from the file
    tok.decode(tok.encode(out[len(rendered):].decode("utf-8", "replace"),
                          add_bos=False))
