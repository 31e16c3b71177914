"""libsplinter_tpu_torch — the PyTorch + CUDA port of libsplinter_tpu
for NVIDIA Hopper (H100).

The JAX package beside it stays the reference; this package imports
nothing from it (nor JAX).  Layers mirror the reference layout:

  native/           C11 seqlock store + coordination (shared, host side)
  store.py          Python binding (ctypes over the C ABI; a copy)
  models/           PyTorch encoder + tokenizers
  ops/              hand-written CUDA kernels (csrc/) with their plain
                    PyTorch versions: flash attention (forward and
                    backward), cosine scores, fused streaming top-k,
                    causal prefill and paged decode attention
  engine/           event-driven daemons: the embedder, the searcher
                    and the completer
  parallel/         the encoder's contrastive trainer and its
                    checkpoints (one card)
  obs/, utils/      telemetry, tracing, fault injection
  scripting/        the Lua and WASM hosts
  cli/              the operator CLI: python -m libsplinter_tpu_torch.cli

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from . import _native as native_abi
from ._native import (
    ADV_DONTNEED, ADV_NORMAL, ADV_RANDOM, ADV_SEQUENTIAL, ADV_WILLNEED,
    IOP_ADD, IOP_AND, IOP_DEC, IOP_INC, IOP_NOT, IOP_OR, IOP_SUB, IOP_XOR,
    MOP_FULL, MOP_HYBRID, MOP_OFF,
    T_AUDIO, T_BIGINT, T_BIGUINT, T_BINARY, T_IMGDATA, T_JSON, T_MASK,
    T_VARTEXT, T_VOID,
)
from .store import BidInfo, Eagain, HeaderInfo, SlotInfo, Store

__version__ = "0.1.0"

__all__ = [
    "Store", "SlotInfo", "HeaderInfo", "BidInfo", "Eagain", "native_abi",
    "T_VOID", "T_BIGINT", "T_BIGUINT", "T_JSON", "T_BINARY", "T_IMGDATA",
    "T_AUDIO", "T_VARTEXT", "T_MASK",
    "IOP_AND", "IOP_OR", "IOP_XOR", "IOP_NOT", "IOP_INC", "IOP_DEC",
    "IOP_ADD", "IOP_SUB",
    "ADV_NORMAL", "ADV_SEQUENTIAL", "ADV_RANDOM", "ADV_WILLNEED",
    "ADV_DONTNEED",
    "MOP_OFF", "MOP_HYBRID", "MOP_FULL",
    "__version__",
]
