"""GGUF model files for the PyTorch port: the container reader, the
ggml dequantizers, the embedded tokenizers, config derivation and the
weight mapping onto the port's Encoder and Decoder.

The reference loads every model from GGUF through llama.cpp
(splinference.cpp:423-447, splainference.cpp:414-444); the JAX package
reads the same files natively, and this module is its copy for the port:

  - the GGUF v2/v3 container, memory-mapped, with every u64 count
    bounded against the mapped size (corrupt files fail fast), the ggml
    dequantizers to float32 (F32, F16, BF16, Q4_0/Q4_1/Q5_0/Q5_1/Q8_0
    and the K-quant super-blocks Q2_K/Q3_K/Q4_K/Q5_K/Q6_K/Q8_K) and the
    three embedded tokenizers (WordPiece for bert, SentencePiece-style
    unigram for llama, GPT-2 byte-level BPE for gpt2) are the JAX
    package's source unchanged (tests/test_torch_imports.py holds each
    part to it).  They are numpy on the host: loading happens once, at
    start-up, before anything runs on the card;
  - config derivation builds the port's EncoderConfig / DecoderConfig
    (a ``dtype`` override takes a torch.dtype);
  - the weight loaders build the JAX package's numpy tree from the
    llama.cpp tensor names and hand it to the port's ``params_from_jax``
    bridges, which return the Encoder / Decoder state_dict.

Mixtral-family (MoE) files ({arch}.expert_count, blk.N.ffn_gate_inp and
the stacked blk.N.ffn_{gate,up,down}_exps) resolve to the port's
MoeDecoderConfig and load onto models/moe.py's MoeMlp.
"""
from __future__ import annotations

import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = (
    6, 7, 8, 9, 10, 11, 12)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor dtypes (ids from ggml)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = (
    10, 11, 12, 13, 14, 15)
GGML_I8, GGML_I16, GGML_I32 = 24, 25, 26
GGML_BF16 = 30

QK_K = 256  # K-quant super-block length

_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q8_0: "Q8_0", GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1",
    GGML_Q5_0: "Q5_0", GGML_Q5_1: "Q5_1",
    GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K", GGML_Q8_K: "Q8_K",
    GGML_I8: "I8", GGML_I16: "I16", GGML_I32: "I32",
}


class GgufError(Exception):
    pass


@dataclass
class TensorInfo:
    name: str
    dims: tuple[int, ...]      # ne[] as stored: ne[0] is FASTEST-varying
    ggml_type: int
    offset: int                # relative to the data section


class GgufFile:
    """A parsed GGUF container.  Metadata is eagerly decoded; tensor data
    is mmap'd and dequantized on access."""

    def __init__(self, path: str | Path):
        self.path = str(path)
        self._f: BinaryIO = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except (ValueError, OSError) as e:   # empty/odd file
            self._f.close()
            raise GgufError(f"{self.path}: cannot map ({e})") from None
        self._pos = 0
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        try:
            self._parse()
        except (GgufError, struct.error, IndexError) as e:
            self.close()   # don't leak the fd/mapping on a corrupt file
            if isinstance(e, GgufError):
                raise
            raise GgufError(f"{self.path}: truncated or corrupt "
                            f"({e})") from None

    # -- low-level readers -------------------------------------------------
    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        try:
            v = struct.unpack_from(fmt, self._mm, self._pos)
        except struct.error as e:
            # corrupt counts within file size can still run the cursor
            # off the map; fail with the documented error type
            raise GgufError(f"{self.path}: truncated read at offset "
                            f"{self._pos}: {e}") from e
        self._pos += size
        return v[0] if len(v) == 1 else v

    def _bound(self, count: int, what: str, elem_bytes: int = 1) -> int:
        """Reject attacker-controlled u64 counts that exceed what the
        remaining mapped bytes could possibly hold — a corrupt file must
        fail with GgufError before ballooning memory."""
        remaining = len(self._mm) - self._pos
        if count < 0 or count * elem_bytes > remaining:
            raise GgufError(
                f"{self.path}: {what} count {count} exceeds remaining "
                f"file size ({remaining} bytes)")
        return count

    def _read_string(self) -> str:
        n = self._bound(self._read("<Q"), "string length")
        s = bytes(self._mm[self._pos:self._pos + n])
        self._pos += n
        return s.decode("utf-8", "replace")

    def _read_value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self._read(_SCALAR_FMT[vtype])
        if vtype == _T_BOOL:
            return bool(self._read("<B"))
        if vtype == _T_STRING:
            return self._read_string()
        if vtype == _T_ARRAY:
            etype = self._read("<I")
            count = self._read("<Q")
            if etype in _SCALAR_FMT:
                fmt1 = _SCALAR_FMT[etype]
                self._bound(count, "array", struct.calcsize(fmt1))
                fmt = "<" + str(count) + fmt1[1]
                vals = struct.unpack_from(fmt, self._mm, self._pos)
                self._pos += struct.calcsize(fmt)
                return list(vals)
            # string / nested-array elements each need at least an 8-byte
            # length or count prefix — bounding those with elem_bytes=1
            # would let a corrupt count escape as a raw struct.error deep
            # in the element loop instead of failing fast here.  BOOL
            # elements are 1 byte; the 8-byte bound would falsely reject
            # valid arrays near end of file.
            self._bound(count, "array",
                        8 if etype in (_T_STRING, _T_ARRAY) else 1)
            return [self._read_value(etype) for _ in range(count)]
        raise GgufError(f"unknown metadata value type {vtype}")

    # -- container parse ---------------------------------------------------
    def _parse(self) -> None:
        magic = self._read("<I")
        if magic != GGUF_MAGIC:
            raise GgufError(f"not a GGUF file (magic {magic:#x})")
        version = self._read("<I")
        if version not in (2, 3):
            raise GgufError(f"unsupported GGUF version {version}")
        n_tensors = self._bound(self._read("<Q"), "tensor table", 24)
        n_kv = self._bound(self._read("<Q"), "metadata KV table", 12)
        for _ in range(n_kv):
            key = self._read_string()
            vtype = self._read("<I")
            self.metadata[key] = self._read_value(vtype)
        infos = []
        for _ in range(n_tensors):
            name = self._read_string()
            n_dims = self._read("<I")
            dims = tuple(self._read("<Q") for _ in range(n_dims))
            ggml_type = self._read("<I")
            offset = self._read("<Q")
            infos.append(TensorInfo(name, dims, ggml_type, offset))
        align = int(self.metadata.get("general.alignment", 32))
        self._data_start = -(-self._pos // align) * align
        for ti in infos:
            self.tensors[ti.name] = ti

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- tensor access ------------------------------------------------------
    def tensor(self, name: str) -> np.ndarray:
        """Dequantized float32 (or integer) tensor in numpy (row-major,
        slowest dim first — i.e. shape is reversed ne[])."""
        ti = self.tensors.get(name)
        if ti is None:
            raise KeyError(
                f"{self.path} has no tensor {name!r}; present: "
                f"{sorted(self.tensors)[:8]}...")
        n_elems = int(np.prod(ti.dims)) if ti.dims else 1
        start = self._data_start + ti.offset
        raw = self._mm
        t = ti.ggml_type
        if t == GGML_F32:
            flat = np.frombuffer(raw, np.float32, n_elems, start).copy()
        elif t == GGML_F16:
            flat = np.frombuffer(raw, np.float16, n_elems,
                                 start).astype(np.float32)
        elif t == GGML_BF16:
            u16 = np.frombuffer(raw, np.uint16, n_elems, start)
            flat = (u16.astype(np.uint32) << 16).view(np.float32).copy()
        elif t == GGML_Q8_0:
            flat = _dequant_q8_0(raw, start, n_elems)
        elif t == GGML_Q4_0:
            flat = _dequant_q4_0(raw, start, n_elems)
        elif t == GGML_Q4_1:
            flat = _dequant_q4_1(raw, start, n_elems)
        elif t == GGML_Q5_0:
            flat = _dequant_q5_0(raw, start, n_elems)
        elif t == GGML_Q5_1:
            flat = _dequant_q5_1(raw, start, n_elems)
        elif t == GGML_Q2_K:
            flat = _dequant_q2_k(raw, start, n_elems)
        elif t == GGML_Q3_K:
            flat = _dequant_q3_k(raw, start, n_elems)
        elif t == GGML_Q4_K:
            flat = _dequant_q4_k(raw, start, n_elems)
        elif t == GGML_Q5_K:
            flat = _dequant_q5_k(raw, start, n_elems)
        elif t == GGML_Q6_K:
            flat = _dequant_q6_k(raw, start, n_elems)
        elif t == GGML_Q8_K:
            flat = _dequant_q8_k(raw, start, n_elems)
        elif t == GGML_I8:
            flat = np.frombuffer(raw, np.int8, n_elems, start).copy()
        elif t == GGML_I16:
            flat = np.frombuffer(raw, np.int16, n_elems, start).copy()
        elif t == GGML_I32:
            flat = np.frombuffer(raw, np.int32, n_elems, start).copy()
        else:
            raise GgufError(
                f"tensor {name}: unsupported ggml type {t} "
                f"({_TYPE_NAMES.get(t, '?')}) — supported: "
                f"{sorted(_TYPE_NAMES.values())}")
        return flat.reshape(tuple(reversed(ti.dims)))


def _dequant_q8_0(buf, start: int, n: int) -> np.ndarray:
    """Q8_0: blocks of 32 elems = [f16 scale][32 x i8]."""
    nblocks = n // 32
    if n % 32:
        raise GgufError("Q8_0 tensor size not a multiple of 32")
    rec = np.dtype([("d", "<f2"), ("qs", "i1", (32,))])
    blocks = np.frombuffer(buf, rec, nblocks, start)
    return (blocks["d"].astype(np.float32)[:, None] *
            blocks["qs"].astype(np.float32)).reshape(-1)


def _dequant_q4_0(buf, start: int, n: int) -> np.ndarray:
    """Q4_0: blocks of 32 = [f16 scale][16 bytes of 2x4-bit], value =
    (nibble - 8) * scale; low nibbles are elems 0..15, high 16..31."""
    nblocks = n // 32
    if n % 32:
        raise GgufError("Q4_0 tensor size not a multiple of 32")
    rec = np.dtype([("d", "<f2"), ("qs", "u1", (16,))])
    blocks = np.frombuffer(buf, rec, nblocks, start)
    lo = (blocks["qs"] & 0x0F).astype(np.int8) - 8
    hi = (blocks["qs"] >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (blocks["d"].astype(np.float32)[:, None] * q).reshape(-1)


def _dequant_q4_1(buf, start: int, n: int) -> np.ndarray:
    """Q4_1: blocks of 32 = [f16 scale][f16 min][16 bytes], value =
    nibble * scale + min."""
    nblocks = n // 32
    if n % 32:
        raise GgufError("Q4_1 tensor size not a multiple of 32")
    rec = np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))])
    blocks = np.frombuffer(buf, rec, nblocks, start)
    lo = (blocks["qs"] & 0x0F).astype(np.float32)
    hi = (blocks["qs"] >> 4).astype(np.float32)
    q = np.concatenate([lo, hi], axis=1)
    return (blocks["d"].astype(np.float32)[:, None] * q +
            blocks["m"].astype(np.float32)[:, None]).reshape(-1)


def _dequant_q5_0(buf, start: int, n: int) -> np.ndarray:
    """Q5_0: blocks of 32 = [f16 scale][4B high-bit mask][16B nibbles],
    value = ((nibble | hi<<4) - 16) * scale; high bit j of the u32 mask
    belongs to element j (low nibbles 0..15, high nibbles 16..31)."""
    nblocks = n // 32
    if n % 32:
        raise GgufError("Q5_0 tensor size not a multiple of 32")
    rec = np.dtype([("d", "<f2"), ("qh", "<u4"), ("qs", "u1", (16,))])
    B = np.frombuffer(buf, rec, nblocks, start)
    qh = B["qh"][:, None].astype(np.uint32)
    j = np.arange(16, dtype=np.uint32)
    lo = (B["qs"] & 0x0F) | (((qh >> j) & 1) << 4).astype(np.uint8)
    hi = (B["qs"] >> 4) | (((qh >> (j + 16)) & 1) << 4).astype(np.uint8)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 16.0
    return (B["d"].astype(np.float32)[:, None] * q).reshape(-1)


def _dequant_q5_1(buf, start: int, n: int) -> np.ndarray:
    """Q5_1: blocks of 32 = [f16 scale][f16 min][4B mask][16B nibbles],
    value = 5-bit * scale + min."""
    nblocks = n // 32
    if n % 32:
        raise GgufError("Q5_1 tensor size not a multiple of 32")
    rec = np.dtype([("d", "<f2"), ("m", "<f2"), ("qh", "<u4"),
                    ("qs", "u1", (16,))])
    B = np.frombuffer(buf, rec, nblocks, start)
    qh = B["qh"][:, None].astype(np.uint32)
    j = np.arange(16, dtype=np.uint32)
    lo = (B["qs"] & 0x0F) | (((qh >> j) & 1) << 4).astype(np.uint8)
    hi = (B["qs"] >> 4) | (((qh >> (j + 16)) & 1) << 4).astype(np.uint8)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (B["d"].astype(np.float32)[:, None] * q +
            B["m"].astype(np.float32)[:, None]).reshape(-1)


def _kq_blocks(buf, start: int, n: int, rec: np.dtype, name: str):
    if n % QK_K:
        raise GgufError(f"{name} tensor size not a multiple of {QK_K}")
    return np.frombuffer(buf, rec, n // QK_K, start)


def _scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the Q4_K/Q5_K 12-byte scale table into 8 six-bit
    (scale, min) pairs per super-block (ggml get_scale_min_k4)."""
    q = scales.astype(np.uint8)
    nb = q.shape[0]
    sc = np.empty((nb, 8), np.float32)
    mn = np.empty((nb, 8), np.float32)
    for j in range(4):
        sc[:, j] = q[:, j] & 63
        mn[:, j] = q[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (q[:, j + 4] & 0x0F) | ((q[:, j - 4] >> 6) << 4)
        mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


def _dequant_q4_k(buf, start: int, n: int) -> np.ndarray:
    """Q4_K: 256-elem super-blocks = [f16 d][f16 dmin][12B packed 6-bit
    scales/mins x8][128B nibbles]; value = d*sc*nibble - dmin*mn per
    32-elem sub-block."""
    rec = np.dtype([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                    ("qs", "u1", (128,))])
    B = _kq_blocks(buf, start, n, rec, "Q4_K")
    nb = len(B)
    d = B["d"].astype(np.float32)[:, None, None]
    dmin = B["dmin"].astype(np.float32)[:, None, None]
    sc, mn = _scale_min_k4(B["scales"])
    qs = B["qs"].reshape(nb, 4, 32)
    y = np.empty((nb, 4, 64), np.float32)
    y[:, :, :32] = (d * sc.reshape(nb, 4, 2)[:, :, 0:1] *
                    (qs & 0x0F).astype(np.float32) -
                    dmin * mn.reshape(nb, 4, 2)[:, :, 0:1])
    y[:, :, 32:] = (d * sc.reshape(nb, 4, 2)[:, :, 1:2] *
                    (qs >> 4).astype(np.float32) -
                    dmin * mn.reshape(nb, 4, 2)[:, :, 1:2])
    return y.reshape(-1)


def _dequant_q5_k(buf, start: int, n: int) -> np.ndarray:
    """Q5_K: Q4_K layout + a 32B high-bit plane; value =
    d*sc*(nibble + 16*hi) - dmin*mn."""
    rec = np.dtype([("d", "<f2"), ("dmin", "<f2"), ("scales", "u1", (12,)),
                    ("qh", "u1", (32,)), ("qs", "u1", (128,))])
    B = _kq_blocks(buf, start, n, rec, "Q5_K")
    nb = len(B)
    d = B["d"].astype(np.float32)[:, None, None]
    dmin = B["dmin"].astype(np.float32)[:, None, None]
    sc, mn = _scale_min_k4(B["scales"])
    sc = sc.reshape(nb, 4, 2)
    mn = mn.reshape(nb, 4, 2)
    qs = B["qs"].reshape(nb, 4, 32)
    qh = B["qh"][:, None, :]                       # (nb,1,32)
    g = np.arange(4)[None, :, None]                # group index
    hi_lo = ((qh >> (2 * g)) & 1).astype(np.float32)       # u1 = 1<<2g
    hi_hi = ((qh >> (2 * g + 1)) & 1).astype(np.float32)   # u2 = 2<<2g
    y = np.empty((nb, 4, 64), np.float32)
    y[:, :, :32] = (d * sc[:, :, 0:1] *
                    ((qs & 0x0F).astype(np.float32) + 16.0 * hi_lo) -
                    dmin * mn[:, :, 0:1])
    y[:, :, 32:] = (d * sc[:, :, 1:2] *
                    ((qs >> 4).astype(np.float32) + 16.0 * hi_hi) -
                    dmin * mn[:, :, 1:2])
    return y.reshape(-1)


def _dequant_q6_k(buf, start: int, n: int) -> np.ndarray:
    """Q6_K: 256-elem super-blocks = [128B low nibbles][64B 2-bit high
    planes][16 i8 scales][f16 d]; value = d * sc[l/16] * (6-bit - 32)."""
    rec = np.dtype([("ql", "u1", (128,)), ("qh", "u1", (64,)),
                    ("sc", "i1", (16,)), ("d", "<f2")])
    B = _kq_blocks(buf, start, n, rec, "Q6_K")
    nb = len(B)
    d = B["d"].astype(np.float32).reshape(nb, 1, 1)
    ql = B["ql"].reshape(nb, 2, 64).astype(np.int16)
    qh = B["qh"].reshape(nb, 2, 32).astype(np.int16)
    sc = B["sc"].reshape(nb, 2, 8).astype(np.float32)
    q1 = ((ql[:, :, :32] & 0x0F) | (((qh >> 0) & 3) << 4)) - 32
    q2 = ((ql[:, :, 32:] & 0x0F) | (((qh >> 2) & 3) << 4)) - 32
    q3 = ((ql[:, :, :32] >> 4) | (((qh >> 4) & 3) << 4)) - 32
    q4 = ((ql[:, :, 32:] >> 4) | (((qh >> 6) & 3) << 4)) - 32
    sidx = np.arange(32) // 16                     # 16-elem scale groups
    y = np.empty((nb, 2, 128), np.float32)
    y[:, :, 0:32] = sc[:, :, sidx + 0] * q1
    y[:, :, 32:64] = sc[:, :, sidx + 2] * q2
    y[:, :, 64:96] = sc[:, :, sidx + 4] * q3
    y[:, :, 96:128] = sc[:, :, sidx + 6] * q4
    return (d * y).reshape(-1)


def _dequant_q2_k(buf, start: int, n: int) -> np.ndarray:
    """Q2_K: 256-elem super-blocks = [16B scales (lo=scale, hi=min)]
    [64B 2-bit quants][f16 d][f16 dmin]; value = d*(sc&0xF)*q2 -
    dmin*(sc>>4) per 16-elem sub-block."""
    rec = np.dtype([("scales", "u1", (16,)), ("qs", "u1", (64,)),
                    ("d", "<f2"), ("dmin", "<f2")])
    B = _kq_blocks(buf, start, n, rec, "Q2_K")
    nb = len(B)
    d = B["d"].astype(np.float32).reshape(nb, 1, 1, 1)
    dmin = B["dmin"].astype(np.float32).reshape(nb, 1, 1, 1)
    scales = B["scales"].reshape(nb, 2, 4, 2)      # [half][j][sub]
    qs = B["qs"].reshape(nb, 2, 32)                # per half
    shift = np.arange(4).reshape(1, 1, 4, 1)
    q2 = ((qs[:, :, None, :] >> (2 * shift)) & 3).astype(np.float32)
    q2 = q2.reshape(nb, 2, 4, 2, 16)               # split 32 -> 2x16
    sc = (scales & 0x0F).astype(np.float32)[..., None]
    mn = (scales >> 4).astype(np.float32)[..., None]
    y = d[..., None] * sc * q2 - dmin[..., None] * mn
    return y.reshape(-1)


def _dequant_q3_k(buf, start: int, n: int) -> np.ndarray:
    """Q3_K: 256-elem super-blocks = [32B high-bit mask][64B 2-bit
    quants][12B packed 6-bit scales x16][f16 d]; value =
    d*(sc-32)*(q2 + hi*4 - 4) ... precisely d*sc*(q - (hm?0:4))."""
    rec = np.dtype([("hmask", "u1", (32,)), ("qs", "u1", (64,)),
                    ("scales", "u1", (12,)), ("d", "<f2")])
    B = _kq_blocks(buf, start, n, rec, "Q3_K")
    nb = len(B)
    d = B["d"].astype(np.float32).reshape(nb, 1, 1, 1, 1)
    # unpack 12 bytes -> 16 signed 6-bit scales (ggml kmask shuffle)
    a = B["scales"].view("<u4").reshape(nb, 3)
    k1, k2 = np.uint32(0x03030303), np.uint32(0x0F0F0F0F)
    words = np.stack([
        (a[:, 0] & k2) | (((a[:, 2] >> 0) & k1) << 4),
        (a[:, 1] & k2) | (((a[:, 2] >> 2) & k1) << 4),
        ((a[:, 0] >> 4) & k2) | (((a[:, 2] >> 4) & k1) << 4),
        ((a[:, 1] >> 4) & k2) | (((a[:, 2] >> 6) & k1) << 4),
    ], axis=1).astype("<u4")
    sc = (words.view(np.uint8).reshape(nb, 16).astype(np.int8)
          .astype(np.float32) - 32.0)
    sc = sc.reshape(nb, 2, 4, 2)[..., None]        # [half][j][sub][1]
    qs = B["qs"].reshape(nb, 2, 32)
    hm = B["hmask"][:, None, None, :]              # (nb,1,1,32)
    shift = np.arange(4).reshape(1, 1, 4, 1)
    q2 = ((qs[:, :, None, :] >> (2 * shift)) & 3).astype(np.float32)
    half = np.arange(2).reshape(1, 2, 1, 1)
    bit = 4 * half + shift                         # m = 1 << (4n + j)
    hi = ((hm >> bit) & 1).astype(np.float32)      # (nb,2,4,32)
    q2 = q2.reshape(nb, 2, 4, 2, 16)
    hi = hi.reshape(nb, 2, 4, 2, 16)
    y = d * sc * (q2 - np.where(hi > 0, 0.0, 4.0))
    return y.reshape(-1)


def _dequant_q8_k(buf, start: int, n: int) -> np.ndarray:
    """Q8_K: 256-elem super-blocks = [f32 d][256 i8][16 i16 bsums];
    value = d * q."""
    rec = np.dtype([("d", "<f4"), ("qs", "i1", (256,)),
                    ("bsums", "<i2", (16,))])
    B = _kq_blocks(buf, start, n, rec, "Q8_K")
    return (B["d"][:, None] * B["qs"].astype(np.float32)).reshape(-1)


# ======================================================= weight tree mapping

def _take(gf: GgufFile, aliases: list[str], *, required: bool = True):
    for a in aliases:
        if a in gf.tensors:
            return gf.tensor(a)
    if required:
        raise KeyError(
            f"{gf.path} has none of {aliases}; present tensors include "
            f"{sorted(gf.tensors)[:8]}...")
    return None


def load_decoder_params(path: str, cfg) -> dict:
    """Map a llama-family GGUF onto the Decoder's state_dict (llama.cpp
    names: token_embd, blk.N.attn_{q,k,v,output}, blk.N.ffn_{gate,up,
    down}, blk.N.{attn,ffn}_norm, output_norm, output; no output means
    a head tied to the embedding; a Mixtral-family block's router
    blk.N.ffn_gate_inp and stacked experts blk.N.ffn_{gate,up,down}_exps
    map onto layer_N.moe).  Builds the JAX package's flax tree in numpy
    and bridges it (decoder.params_from_jax), so the two packages load
    the same file into the same values."""
    from .decoder import params_from_jax

    with GgufFile(path) as gf:
        def kern(names):
            return {"kernel": _take(gf, names).T.astype(np.float32)}

        tok = _take(gf, ["token_embd.weight"])
        if tok.shape[0] < cfg.vocab_size:
            raise ValueError(
                f"GGUF vocab {tok.shape[0]} < cfg.vocab_size "
                f"{cfg.vocab_size}")
        p: dict[str, Any] = {
            "tok_emb": {"embedding":
                        tok[:cfg.vocab_size].astype(np.float32)},
            "ln_out": {"scale":
                       _take(gf, ["output_norm.weight"])
                       .astype(np.float32)},
        }
        head = _take(gf, ["output.weight"], required=False)
        if head is not None:
            p["lm_head"] = {"kernel":
                            head[:cfg.vocab_size].T.astype(np.float32)}
        else:   # tied embeddings
            p["lm_head"] = {"kernel": p["tok_emb"]["embedding"].T.copy()}
        for i in range(cfg.layers):
            b = f"blk.{i}"
            layer = {
                "ln_attn": {"scale":
                            _take(gf, [f"{b}.attn_norm.weight"])
                            .astype(np.float32)},
                "attn": {
                    "q": kern([f"{b}.attn_q.weight"]),
                    "k": kern([f"{b}.attn_k.weight"]),
                    "v": kern([f"{b}.attn_v.weight"]),
                    "out": kern([f"{b}.attn_output.weight"]),
                },
                "ln_mlp": {"scale":
                           _take(gf, [f"{b}.ffn_norm.weight"])
                           .astype(np.float32)},
            }
            if f"{b}.ffn_gate_exps.weight" in gf.tensors:
                # Mixtral-family block: stacked experts (E, out, in) in
                # the numpy view -> (E, in, out) for the einsums
                # (moe.MoeMlp); the router is a plain Dense kernel
                def exps(name):
                    a = _take(gf, [f"{b}.{name}.weight"])
                    return a.transpose(0, 2, 1).astype(np.float32)

                layer["moe"] = {
                    "router": kern([f"{b}.ffn_gate_inp.weight"]),
                    "gate_experts": exps("ffn_gate_exps"),
                    "up_experts": exps("ffn_up_exps"),
                    "down_experts": exps("ffn_down_exps"),
                }
            else:
                layer["gate"] = kern([f"{b}.ffn_gate.weight"])
                layer["up"] = kern([f"{b}.ffn_up.weight"])
                layer["down"] = kern([f"{b}.ffn_down.weight"])
            p[f"layer_{i}"] = layer
    return params_from_jax({"params": p}, cfg)


def load_encoder_params(path: str, cfg) -> dict:
    """Map a bert/nomic-bert-family GGUF onto the Encoder's state_dict.
    llama.cpp bert-family names: token_embd(+_norm), position_embd,
    blk.N.attn_{q,k,v}|attn_qkv (fused, nomic), blk.N.attn_output,
    blk.N.attn_output_norm, blk.N.ffn_{up,gate,down},
    blk.N.layer_output_norm.  Builds the JAX package's flax tree in
    numpy and bridges it (encoder.params_from_jax)."""
    from .encoder import params_from_jax

    with GgufFile(path) as gf:
        def linear(wnames, bnames):
            w = _take(gf, wnames)
            bias = _take(gf, bnames, required=False)
            out = {"kernel": w.T.astype(np.float32)}
            out["bias"] = (bias.astype(np.float32) if bias is not None
                           else np.zeros((w.shape[0],), np.float32))
            return out

        tok = _take(gf, ["token_embd.weight"])
        if tok.shape[0] < cfg.vocab_size:
            raise ValueError(
                f"GGUF vocab {tok.shape[0]} < cfg.vocab_size "
                f"{cfg.vocab_size}")
        tok = tok[:cfg.vocab_size].astype(np.float32)
        # bert GGUFs ship a token_types table added to every embedding
        # before token_embd_norm; this pipeline uses type 0 for all
        # tokens, so fold row 0 straight into the embedding table
        tt = _take(gf, ["token_types.weight"], required=False)
        if tt is not None:
            tok = tok + tt[0].astype(np.float32)[None, :]
        p: dict[str, Any] = {
            "tok_emb": {"embedding": tok},
            "ln_emb": {
                "scale": _take(gf, ["token_embd_norm.weight"])
                .astype(np.float32),
                "bias": _take(gf, ["token_embd_norm.bias"])
                .astype(np.float32),
            },
        }
        if cfg.variant == "bert":
            pos = _take(gf, ["position_embd.weight"])
            if pos.shape[0] < cfg.max_len:
                raise ValueError(
                    f"GGUF has {pos.shape[0]} position rows < cfg.max_len "
                    f"{cfg.max_len}")
            p["pos_emb"] = {"embedding":
                            pos[:cfg.max_len].astype(np.float32)}
        for i in range(cfg.layers):
            b = f"blk.{i}"
            fused = _take(gf, [f"{b}.attn_qkv.weight"], required=False)
            if fused is not None:
                bias = _take(gf, [f"{b}.attn_qkv.bias"], required=False)
                qkv = {"kernel": fused.T.astype(np.float32),
                       "bias": (bias.astype(np.float32)
                                if bias is not None else
                                np.zeros((fused.shape[0],), np.float32))}
            else:
                ws = [_take(gf, [f"{b}.attn_{part}.weight"])
                      for part in ("q", "k", "v")]
                bs = [_take(gf, [f"{b}.attn_{part}.bias"], required=False)
                      for part in ("q", "k", "v")]
                bs = [x if x is not None else
                      np.zeros((w.shape[0],), np.float32)
                      for x, w in zip(bs, ws)]
                qkv = {"kernel": np.concatenate(
                           [w.T for w in ws], axis=1).astype(np.float32),
                       "bias": np.concatenate(bs).astype(np.float32)}
            layer: dict[str, Any] = {
                "attn": {
                    "qkv": qkv,
                    "out": linear([f"{b}.attn_output.weight"],
                                  [f"{b}.attn_output.bias"]),
                },
                "ln_attn": {
                    "scale": _take(gf, [f"{b}.attn_output_norm.weight"])
                    .astype(np.float32),
                    "bias": _take(gf, [f"{b}.attn_output_norm.bias"])
                    .astype(np.float32),
                },
                "ln_mlp": {
                    "scale": _take(gf, [f"{b}.layer_output_norm.weight"])
                    .astype(np.float32),
                    "bias": _take(gf, [f"{b}.layer_output_norm.bias"])
                    .astype(np.float32),
                },
            }
            mlp: dict[str, Any] = {
                "up": linear([f"{b}.ffn_up.weight"], [f"{b}.ffn_up.bias"]),
                "down": linear([f"{b}.ffn_down.weight"],
                               [f"{b}.ffn_down.bias"]),
            }
            if cfg.variant == "nomic":
                mlp["gate"] = linear([f"{b}.ffn_gate.weight"],
                                     [f"{b}.ffn_gate.bias"])
            layer["mlp"] = mlp
            p[f"layer_{i}"] = layer
    return params_from_jax({"params": p}, cfg)


# ============================================================== tokenizers

# tokenizer.ggml.token_type values (ggml vocabulary classes)
TOKTYPE_NORMAL, TOKTYPE_UNKNOWN, TOKTYPE_CONTROL = 1, 2, 3
TOKTYPE_USER_DEFINED, TOKTYPE_UNUSED, TOKTYPE_BYTE = 4, 5, 6


class _SpecialTokens:
    """Atomic matching of control / user-defined tokens inside raw text.

    Chat-template markup rendered as text (<|im_start|>, <|eot_id|>,
    <s>, ...) must tokenize to its single control-token id, not be
    byte-BPE'd / SPM-segmented into ordinary pieces — llama.cpp's
    parse_special behavior.  Built from tokenizer.ggml.token_type;
    pieces are matched greedily longest-first before the normal
    pipeline sees the text."""

    def __init__(self, tokens: list[str],
                 token_types: list[int] | None):
        import re
        self.ids: dict[str, int] = {}
        control: set[int] = set()
        if token_types:
            for i, (piece, tt) in enumerate(zip(tokens, token_types)):
                if tt in (TOKTYPE_CONTROL, TOKTYPE_USER_DEFINED) and piece:
                    self.ids[piece] = i
                    if tt == TOKTYPE_CONTROL:
                        control.add(i)
        # only CONTROL tokens are suppressed from streamed output;
        # USER_DEFINED tokens carry real surface text and llama.cpp's
        # token_to_piece emits them verbatim
        self.control_ids = frozenset(control)
        if self.ids:
            alts = sorted(self.ids, key=len, reverse=True)
            self._re = re.compile("|".join(re.escape(a) for a in alts))
        else:
            self._re = None

    def split(self, text: str) -> list[tuple[str, int | None]]:
        """[(fragment, special_id | None), ...] in order."""
        if self._re is None:
            return [(text, None)] if text else []
        out: list[tuple[str, int | None]] = []
        pos = 0
        for m in self._re.finditer(text):
            if m.start() > pos:
                out.append((text[pos:m.start()], None))
            out.append((m.group(0), self.ids[m.group(0)]))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], None))
        return out


def load_tokenizer(path_or_gguf) -> Any:
    """Build a tokenizer from tokenizer.ggml.* metadata.

    - model "bert"  -> WordPieceTokenizer over the embedded vocab;
    - model "llama" -> SentencePiece-style unigram (Viterbi over the
      embedded scores, byte fallback);
    - model "gpt2"  -> GPT-2-style byte-level BPE over the embedded
      vocab + merges (qwen/falcon/gpt2 lineage).

    Control / user-defined tokens (tokenizer.ggml.token_type) are parsed
    atomically by the unigram and BPE tokenizers (llama.cpp's
    parse_special), so chat-template markup survives round trips.
    """
    with _MaybeClose(*_as_gguf(path_or_gguf)) as gf:
        model = gf.metadata.get("tokenizer.ggml.model")
        tokens = gf.metadata.get("tokenizer.ggml.tokens")
        if model is None or tokens is None:
            raise GgufError(
                f"{gf.path} carries no tokenizer metadata "
                "(tokenizer.ggml.model/tokens)")
        if model == "bert":
            from .tokenizer import WordPieceTokenizer
            return WordPieceTokenizer.from_vocab_list(tokens)
        meta = {
            k.rsplit(".", 1)[-1]: v for k, v in gf.metadata.items()
            if k.startswith("tokenizer.ggml.") and k.endswith("_token_id")
        }
        meta["token_types"] = gf.metadata.get("tokenizer.ggml.token_type")
        if model == "llama":
            scores = gf.metadata.get("tokenizer.ggml.scores")
            return UnigramTokenizer(tokens, scores, **meta)
        if model == "gpt2":
            merges = gf.metadata.get("tokenizer.ggml.merges")
            if merges is None:
                raise GgufError(
                    f"{gf.path}: gpt2 tokenizer without "
                    "tokenizer.ggml.merges")
            return ByteBpeTokenizer(tokens, merges, **meta)
        raise GgufError(
            f"tokenizer model {model!r} is not supported "
            "(bert, llama, gpt2 are)")


class UnigramTokenizer:
    """SentencePiece-style unigram tokenizer (llama family).

    Viterbi segmentation over piece log-probabilities — the same model
    class SentencePiece decodes with; llama.cpp's bigram-merge procedure
    converges to the same segmentation for these vocabularies in
    practice.  Spaces become U+2581; unknown bytes fall back to the
    <0xXX> byte pieces when present, else UNK.
    """

    SPACE = "▁"

    def __init__(self, tokens: list[str], scores: list[float] | None,
                 *, bos_token_id: int = 1, eos_token_id: int = 2,
                 unknown_token_id: int = 0, padding_token_id: int = 0,
                 token_types: list[int] | None = None, **_ignored):
        self.tokens = list(tokens)
        self.scores = (list(scores) if scores is not None
                       else [0.0] * len(tokens))
        self.index = {t: i for i, t in enumerate(self.tokens)}
        self.bos_id = bos_token_id
        self.eos_id = eos_token_id
        self.unk_id = unknown_token_id
        self.pad_id = padding_token_id
        self.max_piece = max((len(t) for t in self.tokens), default=1)
        self._byte_ids = {
            bytes([b]): self.index[f"<0x{b:02X}>"]
            for b in range(256) if f"<0x{b:02X}>" in self.index
        }
        self.special = _SpecialTokens(self.tokens, token_types)

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _viterbi(self, text: str) -> list[int]:
        n = len(text)
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        UNK_PENALTY = -100.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                piece = text[i:j]
                tid = self.index.get(piece)
                if tid is not None:
                    s = best[i] + self.scores[tid]
                    if s > best[j]:
                        best[j] = s
                        back[j] = (i, tid)
            # single-char fallback (unk or byte pieces) keeps the lattice
            # connected for characters outside the vocabulary
            j = i + 1
            if back[j] is None and best[j] < best[i] + UNK_PENALTY:
                best[j] = best[i] + UNK_PENALTY
                back[j] = (i, -1)
        out: list[int] = []
        pos = n
        while pos > 0:
            prev, tid = back[pos]
            if tid >= 0:
                out.append(tid)
            else:   # unknown char: byte fallback pieces, else UNK
                ch = text[prev:pos].encode("utf-8")
                ids = [self._byte_ids.get(bytes([b]), self.unk_id)
                       for b in ch]
                out.extend(reversed(ids))
            pos = prev
        out.reverse()
        return out

    def encode(self, text: str, max_len: int | None = None,
               *, add_bos: bool = True) -> list[int]:
        ids: list[int] = [self.bos_id] if add_bos else []
        prefix = True      # SPM dummy-space: at text start AND after
        for frag, special in self.special.split(text):   # every special
            if special is not None:
                ids.append(special)
                prefix = True
            else:
                norm = frag.replace(" ", self.SPACE)
                if prefix:
                    norm = self.SPACE + norm
                ids.extend(self._viterbi(norm))
                prefix = False
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def token_to_piece(self, tok: int) -> bytes:
        """Raw byte piece for one token id (llama_token_to_piece analog):
        byte-fallback pieces yield their byte, specials yield b'',
        ordinary pieces yield utf-8 text with U+2581 as space."""
        if tok in (self.bos_id, self.eos_id, self.pad_id) or \
                tok in self.special.control_ids or \
                not 0 <= tok < len(self.tokens):
            return b""
        piece = self.tokens[tok]
        if len(piece) == 6 and piece.startswith("<0x") and \
                piece.endswith(">"):
            try:
                return bytes([int(piece[3:5], 16)])
            except ValueError:
                pass
        return piece.replace(self.SPACE, " ").encode("utf-8")

    def decode(self, ids: list[int]) -> str:
        out = b"".join(self.token_to_piece(i) for i in ids)
        # strip exactly ONE leading space (the SPM prefix encode added);
        # deeper indentation in the text itself must survive
        return out.decode("utf-8", errors="replace").removeprefix(" ")


# ======================================================== config derivation

def _as_gguf(path_or_gguf):
    """(GgufFile, owns_it) — lets daemon startup parse the file once and
    share it across config/tokenizer/metadata reads."""
    if isinstance(path_or_gguf, GgufFile):
        return path_or_gguf, False
    return GgufFile(path_or_gguf), True


class _MaybeClose:
    def __init__(self, gf, own):
        self.gf, self.own = gf, own

    def __enter__(self):
        return self.gf

    def __exit__(self, *exc):
        if self.own:
            self.gf.close()


def decoder_config_from_gguf(path_or_gguf, **overrides):
    """Derive a DecoderConfig from GGUF metadata (llama.* keys).  The
    architecture prefix is read from general.architecture so mistral/qwen
    exports (same llama graph, different prefix) work too.  Accepts a
    path or an already-open GgufFile; a file with experts
    ({arch}.expert_count > 0) resolves to MoeDecoderConfig."""
    from .decoder import DecoderConfig

    with _MaybeClose(*_as_gguf(path_or_gguf)) as gf:
        path = gf.path
        md = gf.metadata
        arch = md.get("general.architecture", "llama")

        def g(suffix, default=None):
            return md.get(f"{arch}.{suffix}", default)

        tokens = md.get("tokenizer.ggml.tokens")
        vocab = len(tokens) if tokens else None
        if vocab is None:
            ti = gf.tensors.get("token_embd.weight")
            vocab = ti.dims[-1] if ti else None  # ne: [hidden, vocab]
        heads = g("attention.head_count")
        kw = dict(
            vocab_size=vocab,
            hidden=g("embedding_length"),
            layers=g("block_count"),
            heads=heads,
            kv_heads=g("attention.head_count_kv", heads),
            mlp_dim=g("feed_forward_length"),
            max_len=g("context_length"),
            rope_base=g("rope.freq_base", 10000.0),
        )
        missing = [k for k, v in kw.items() if v is None]
        if missing:
            raise GgufError(
                f"{path} metadata lacks {missing} "
                f"(architecture prefix {arch!r})")
        eps = g("attention.layer_norm_rms_epsilon")
        if eps is not None:
            kw["rms_eps"] = float(eps)
        kw.update(overrides)
        n_experts = g("expert_count")
        if n_experts:
            # Mixtral-family checkpoint: llama.cpp publishes
            # {arch}.expert_count / expert_used_count and stacks the
            # expert FFNs in blk.N.ffn_{gate,up,down}_exps
            from .moe import MoeDecoderConfig
            kw.setdefault("n_experts", int(n_experts))
            kw.setdefault("top_k", int(g("expert_used_count", 2)))
            return MoeDecoderConfig(**kw)
        return DecoderConfig(**kw)


def encoder_config_from_gguf(path_or_gguf, **overrides):
    """Derive an EncoderConfig from GGUF metadata (bert/nomic-bert
    arch keys).  Accepts a path or an already-open GgufFile."""
    from .encoder import EncoderConfig

    with _MaybeClose(*_as_gguf(path_or_gguf)) as gf:
        path = gf.path
        md = gf.metadata
        arch = md.get("general.architecture", "nomic-bert")

        def g(suffix, default=None):
            return md.get(f"{arch}.{suffix}", default)

        tokens = md.get("tokenizer.ggml.tokens")
        vocab = len(tokens) if tokens else None
        if vocab is None:
            ti = gf.tensors.get("token_embd.weight")
            vocab = ti.dims[-1] if ti else None
        kw = dict(
            vocab_size=vocab,
            hidden=g("embedding_length"),
            layers=g("block_count"),
            heads=g("attention.head_count"),
            mlp_dim=g("feed_forward_length"),
            max_len=g("context_length"),
            variant="bert" if arch == "bert" else "nomic",
        )
        missing = [k for k, v in kw.items() if v is None]
        if missing:
            raise GgufError(
                f"{path} metadata lacks {missing} "
                f"(architecture prefix {arch!r})")
        eps = g("attention.layer_norm_epsilon")
        if eps is not None:
            kw["layer_norm_eps"] = float(eps)
        kw.update(overrides)
        return EncoderConfig(**kw)


def _gpt2_byte_map() -> dict[int, str]:
    """GPT-2's reversible byte <-> unicode table: printable bytes map to
    themselves, the rest to U+0100+offset, so every byte has a visible
    single-character stand-in inside vocab/merge strings."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class ByteBpeTokenizer:
    """GPT-2-style byte-level BPE (tokenizer.ggml.model == "gpt2":
    gpt2/qwen/falcon lineage GGUFs).

    Text is mapped byte-for-byte through the reversible GPT-2 byte table,
    pre-split on the classic contraction/word/number/space pattern, then
    merged bottom-up by merge-rank — the same procedure as the original
    encoder.  Decode inverts the byte table exactly.
    """

    def __init__(self, tokens: list[str], merges: list[str], *,
                 bos_token_id: int | None = None,
                 eos_token_id: int | None = None,
                 unknown_token_id: int = 0,
                 padding_token_id: int = 0,
                 token_types: list[int] | None = None, **_ignored):
        # eos defaults to None, NOT 0: id 0 is a real token ('!') in
        # GPT-2-family vocabs, and a wrong eos truncates generation
        self.tokens = list(tokens)
        self.index = {t: i for i, t in enumerate(self.tokens)}
        self.ranks = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r
        self.bos_id = bos_token_id
        self.eos_id = eos_token_id
        self.unk_id = unknown_token_id
        self.pad_id = padding_token_id
        self._b2u = _gpt2_byte_map()
        self._u2b = {u: b for b, u in self._b2u.items()}
        import re
        self._pre = re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+",
            re.UNICODE)
        self.special = _SpecialTokens(self.tokens, token_types)

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _bpe(self, chunk: str) -> list[str]:
        parts = list(chunk)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        return parts

    def encode(self, text: str, max_len: int | None = None,
               *, add_bos: bool = True) -> list[int]:
        ids: list[int] = []
        if add_bos and self.bos_id is not None:
            ids.append(self.bos_id)
        for frag, special in self.special.split(text):
            if special is not None:
                ids.append(special)
                continue
            for chunk in self._pre.findall(frag):
                mapped = "".join(self._b2u[b]
                                 for b in chunk.encode("utf-8"))
                for piece in self._bpe(mapped):
                    ids.append(self.index.get(piece, self.unk_id))
        if max_len is not None:
            ids = ids[:max_len]
        return ids

    def token_to_piece(self, tok: int) -> bytes:
        if tok == self.eos_id or tok == self.bos_id or \
                tok in self.special.control_ids or \
                not 0 <= tok < len(self.tokens):
            return b""
        return bytes(self._u2b.get(ch, ord("?") & 0xFF)
                     for ch in self.tokens[tok])

    def decode(self, ids: list[int]) -> str:
        return b"".join(self.token_to_piece(i) for i in ids).decode(
            "utf-8", errors="replace")
