"""The hashed-vocabulary word tokenizer, written out plainly.

A word (lower-cased, split on whitespace and ASCII punctuation) maps to
4 + FNV-1a-64(word) mod (vocab_size - 4); ids 0, 1, 2, 3 are [PAD],
[CLS], [SEP], [UNK]; a text encodes as [CLS] words... [SEP], cut to
max_len with [SEP] kept last.  This is the tokenizer the benchmark's
configurations are served with (no trained vocabulary ships with the
repository), frozen here so the reference does not read the program's.
The benchmark's texts are lower-case ASCII words joined by spaces.
"""
from __future__ import annotations

import numpy as np

PAD, CLS, SEP = 0, 1, 2
_FNV_BASIS = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_U64 = (1 << 64) - 1


def fnv1a64(data: bytes) -> int:
    h = _FNV_BASIS
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _U64
    return h


def _words(text: str) -> list[str]:
    out, word = [], []
    for ch in text.lower():
        if ch.isspace():
            if word:
                out.append("".join(word))
                word = []
        elif not ch.isalnum():
            if word:
                out.append("".join(word))
                word = []
            out.append(ch)
        else:
            word.append(ch)
    if word:
        out.append("".join(word))
    return out


def encode(text: str, vocab_size: int, max_len: int) -> np.ndarray:
    """The ids of one ASCII text, (n,) int64."""
    if not text.isascii():
        raise ValueError("the reference tokenizer takes ASCII text only")
    ids = [CLS]
    memo: dict[str, int] = {}
    for w in _words(text):
        i = memo.get(w)
        if i is None:
            i = memo[w] = 4 + fnv1a64(w.encode()) % (vocab_size - 4)
        ids.append(i)
    ids.append(SEP)
    if len(ids) > max_len:
        ids = ids[: max_len - 1] + [SEP]
    return np.asarray(ids, np.int64)
