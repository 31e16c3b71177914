"""GGUF container writer + encoder checkpoint export.

The reference consumes GGUF checkpoints through llama.cpp
(splinference.cpp:423-447); this module is the other half of that
story for the TPU framework: export a trained/seeded encoder (and its
tokenizer) as a self-describing GGUF that the framework's own loader
(`gguf.load_encoder_params` / `gguf.load_tokenizer` /
`gguf.encoder_config_from_gguf`) — or llama.cpp-lineage tooling — can
open cold.  Used by the pinned end-to-end golden fixture
(tests/fixtures/, VERDICT r2 #5) and by `scripts/make_golden_fixture.py`.

Layout notes (GGUF v3, little-endian):
  header | metadata kv* | tensor infos | pad to `align` | tensor data
  (each tensor offset aligned).  ne[] is written fastest-dim-first like
  real GGUF, i.e. reversed from the numpy shape.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# ggml tensor types (subset the framework reads+writes)
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q4_1 = 0, 1, 2, 3
GGML_Q8_0 = 8
GGML_BF16 = 30

_T_U32, _T_I32, _T_F32, _T_STRING, _T_ARRAY, _T_U64 = 4, 5, 6, 8, 9, 10


def _s(txt: str) -> bytes:
    b = txt.encode()
    return struct.pack("<Q", len(b)) + b


def _kv(key: str, vtype: int, payload: bytes) -> bytes:
    return _s(key) + struct.pack("<I", vtype) + payload


def kv_u32(key: str, v: int) -> bytes:
    return _kv(key, _T_U32, struct.pack("<I", v))


def kv_i32(key: str, v: int) -> bytes:
    return _kv(key, _T_I32, struct.pack("<i", v))


def kv_f32(key: str, v: float) -> bytes:
    return _kv(key, _T_F32, struct.pack("<f", v))


def kv_str(key: str, v: str) -> bytes:
    return _kv(key, _T_STRING, _s(v))


def kv_str_array(key: str, items: list[str]) -> bytes:
    body = struct.pack("<IQ", _T_STRING, len(items))
    body += b"".join(_s(t) for t in items)
    return _kv(key, _T_ARRAY, body)


def kv_f32_array(key: str, items: list[float]) -> bytes:
    body = struct.pack("<IQ", _T_F32, len(items))
    body += struct.pack(f"<{len(items)}f", *items)
    return _kv(key, _T_ARRAY, body)


def kv_i32_array(key: str, items: list[int]) -> bytes:
    body = struct.pack("<IQ", _T_I32, len(items))
    body += struct.pack(f"<{len(items)}i", *items)
    return _kv(key, _T_ARRAY, body)


def quantize_q8_0(flat: np.ndarray) -> bytes:
    """Block-32 symmetric int8: d = absmax/127 (fp16), qs int8[32]."""
    out = []
    for blk in np.asarray(flat, np.float32).reshape(-1, 32):
        d = float(np.abs(blk).max()) / 127.0 or 1e-8
        qs = np.clip(np.round(blk / d), -127, 127).astype(np.int8)
        out.append(struct.pack("<e", d) + qs.tobytes())
    return b"".join(out)


def quantize_q4_0(flat: np.ndarray) -> bytes:
    """Block-32 symmetric 4-bit: d = absmax/7 (fp16), nibbles +8."""
    out = []
    for blk in np.asarray(flat, np.float32).reshape(-1, 32):
        d = float(np.abs(blk).max()) / 7.0 or 1e-8
        q = np.clip(np.round(blk / d) + 8, 0, 15).astype(np.uint8)
        packed = (q[:16] | (q[16:] << 4)).astype(np.uint8)
        out.append(struct.pack("<e", d) + packed.tobytes())
    return b"".join(out)


def quantize_q4_1(flat: np.ndarray) -> bytes:
    """Block-32 affine 4-bit: d=(max-min)/15, m=min (both fp16)."""
    out = []
    for blk in np.asarray(flat, np.float32).reshape(-1, 32):
        mn = float(blk.min())
        d = (float(blk.max()) - mn) / 15.0 or 1e-8
        q = np.clip(np.round((blk - mn) / d), 0, 15).astype(np.uint8)
        packed = (q[:16] | (q[16:] << 4)).astype(np.uint8)
        out.append(struct.pack("<ee", d, mn) + packed.tobytes())
    return b"".join(out)


def write_gguf(path, tensors: dict[str, tuple[np.ndarray, int]],
               metadata: list[bytes] = (), align: int = 32) -> None:
    """tensors: name -> (array [numpy layout, slowest-first], ggml_type)."""
    header = struct.pack("<IIQQ", 0x46554747, 3, len(tensors),
                         len(metadata))
    meta = b"".join(metadata)
    infos, data = b"", b""
    for name, (arr, gtype) in tensors.items():
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        if gtype == GGML_F32:
            payload = flat.tobytes()
        elif gtype == GGML_F16:
            payload = flat.astype(np.float16).tobytes()
        elif gtype == GGML_BF16:
            payload = ((flat.astype(np.float32).view(np.uint32) >> 16)
                       .astype(np.uint16).tobytes())
        elif gtype == GGML_Q8_0:
            payload = quantize_q8_0(flat)
        elif gtype == GGML_Q4_0:
            payload = quantize_q4_0(flat)
        elif gtype == GGML_Q4_1:
            payload = quantize_q4_1(flat)
        else:
            raise ValueError(f"writer does not emit ggml type {gtype}")
        pad = (-len(data)) % align
        data += b"\0" * pad
        ne = tuple(reversed(arr.shape))
        infos += (_s(name) + struct.pack("<I", len(ne)) +
                  struct.pack(f"<{len(ne)}Q", *ne) +
                  struct.pack("<IQ", gtype, len(data)))
        data += payload
    head = header + meta + infos
    pad = (-len(head)) % align
    with open(path, "wb") as f:
        f.write(head + b"\0" * pad + data)


def encoder_tensor_map(params: dict) -> dict[str, np.ndarray]:
    """Flatten a nomic-variant Encoder param tree into llama.cpp-style
    tensor names (the naming `gguf.load_encoder_params` reads back).
    Dense kernels are transposed to (out, in) storage like real GGUF."""
    p = params["params"] if "params" in params else params
    t = {
        "token_embd.weight": np.asarray(p["tok_emb"]["embedding"]),
        "token_embd_norm.weight": np.asarray(p["ln_emb"]["scale"]),
        "token_embd_norm.bias": np.asarray(p["ln_emb"]["bias"]),
    }
    i = 0
    while f"layer_{i}" in p:
        lp = p[f"layer_{i}"]
        b = f"blk.{i}"
        t[f"{b}.attn_qkv.weight"] = np.asarray(
            lp["attn"]["qkv"]["kernel"]).T.copy()
        t[f"{b}.attn_qkv.bias"] = np.asarray(lp["attn"]["qkv"]["bias"])
        t[f"{b}.attn_output.weight"] = np.asarray(
            lp["attn"]["out"]["kernel"]).T.copy()
        t[f"{b}.attn_output.bias"] = np.asarray(lp["attn"]["out"]["bias"])
        t[f"{b}.attn_output_norm.weight"] = np.asarray(
            lp["ln_attn"]["scale"])
        t[f"{b}.attn_output_norm.bias"] = np.asarray(lp["ln_attn"]["bias"])
        t[f"{b}.layer_output_norm.weight"] = np.asarray(
            lp["ln_mlp"]["scale"])
        t[f"{b}.layer_output_norm.bias"] = np.asarray(lp["ln_mlp"]["bias"])
        for name in ("gate", "up", "down"):
            t[f"{b}.ffn_{name}.weight"] = np.asarray(
                lp["mlp"][name]["kernel"]).T.copy()
            t[f"{b}.ffn_{name}.bias"] = np.asarray(lp["mlp"][name]["bias"])
        i += 1
    return t


def export_encoder_gguf(params, cfg, path: str | Path, *,
                        tokenizer_vocab: list[str] | None = None,
                        arch: str = "nomic-bert",
                        gtype: int = GGML_F32) -> None:
    """Write an Encoder checkpoint as a self-describing GGUF.

    cfg: EncoderConfig (nomic variant).  tokenizer_vocab embeds a
    WordPiece vocab as tokenizer.ggml.model="bert" + tokens, making the
    file loadable cold with no side-channel config — the property the
    golden e2e fixture pins.
    """
    if cfg.variant != "nomic":
        raise ValueError("export supports the nomic variant "
                         f"(got {cfg.variant!r})")
    md = [
        kv_str("general.architecture", arch),
        kv_str("general.name", "libsplinter-tpu encoder export"),
        kv_u32(f"{arch}.embedding_length", cfg.hidden),
        kv_u32(f"{arch}.block_count", cfg.layers),
        kv_u32(f"{arch}.attention.head_count", cfg.heads),
        kv_u32(f"{arch}.feed_forward_length", cfg.mlp_dim),
        kv_u32(f"{arch}.context_length", cfg.max_len),
        kv_f32(f"{arch}.attention.layer_norm_epsilon",
               cfg.layer_norm_eps),
    ]
    if tokenizer_vocab is not None:
        md += [kv_str("tokenizer.ggml.model", "bert"),
               kv_str_array("tokenizer.ggml.tokens", tokenizer_vocab)]
    tensors = {name: (a, gtype)
               for name, a in encoder_tensor_map(params).items()}
    write_gguf(path, tensors, md)
