"""Deterministic text -> vector oracle for MRMW integrity harnesses.

Shared by tests/test_mrmw_embed.py (CI scale) and
scripts/bench_mrmw_embed.py (sustained) so both validate against the
SAME oracle: a committed vector must equal the fingerprint of a
version the key actually held — a torn or mixed read yields a vector
matching no version (the TPU-framework analog of the reference MRMW
harness's validated payload format, splinter_stress.c parse_ver).
"""
from __future__ import annotations

import numpy as np

DIM = 8


def fingerprint(text: str, dim: int = DIM) -> np.ndarray:
    """Any torn/mixed read yields a vector matching no (key, version)."""
    h = np.frombuffer(text.encode().ljust(64, b"\0")[:64], np.uint8)
    v = np.zeros(dim, np.float32)
    for i, b in enumerate(h):
        v[i % dim] += float(b) * (1 + i)
    return v


def lane_text(lane: int, i: int, ver: int) -> str:
    """The harnesses' canonical key-version payload."""
    return f"lane{lane} key{i} ver{ver}"
