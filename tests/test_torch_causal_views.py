"""The views the decoder hands kernel K4 meet its bf16 alignment rule.

K4's tensor-core arm copies 16-byte chunks with cp.async, so
``causal_fwd_cuda`` raises on a bf16 base or (batch, seq, head) stride
that is not a multiple of 16 bytes (``_check_aligned``, the rule K1
and K6 hold too).  These tests run the check on the CPU, on the very
views a bf16 decoder's prefill and ``join_row`` pass to
``causal_flash_attention``, on a split of a fused qkv projection, and
on views that must fail it.
"""
import numpy as np
import pytest
import torch

from libsplinter_tpu_torch.models import decoder as dec
from libsplinter_tpu_torch.ops.flash_attention import _check_aligned


def test_decoder_prefill_and_join_views_are_aligned(monkeypatch):
    seen = []
    real = dec.causal_flash_attention

    def checked(q, kk, vv, pos, start=None):
        _check_aligned("causal_fwd_cuda", (q, kk, vv))
        seen.append((tuple(q.shape), tuple(kk.shape), pos))
        return real(q, kk, vv, pos, start)

    monkeypatch.setattr(dec, "causal_flash_attention", checked)
    cfg = dec.DecoderConfig.tiny(dtype=torch.bfloat16, flash_min_seq=16)
    m = dec.CompletionModel(cfg, buckets=(16, 32), temp=0.0, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 1024, n).astype(np.int32)
               for n in (30, 9, 2)]
    m.prefill_batch(prompts)
    m.join_row(prompts[1][:5], 2)
    # the bucket-32 batch over the whole cache, then one row of it
    assert [s[2] for s in seen] == [0] * cfg.layers + [16] * cfg.layers
    assert seen[0][1][0] >= 3 and seen[-1][1][0] == 1   # padded batch


def test_fused_qkv_split_is_aligned_and_odd_views_are_not():
    qkv = torch.zeros(2, 64, 3 * 2 * 64, dtype=torch.bfloat16)
    q, k, v = (x.reshape(2, 64, 2, 64) for x in qkv.split(128, dim=-1))
    _check_aligned("causal_fwd_cuda", (q, k, v, k[1:], q[:, 8:]))
    x = torch.zeros(2, 64, 2 * 64 + 1, dtype=torch.bfloat16)
    for bad in (x[..., 1:].reshape(2, 64, 2, 64),      # base + 2 bytes
                x[..., :-1].reshape(2, 64, 2, 64)):    # stride 258 bytes
        with pytest.raises(ValueError, match="16 bytes"):
            _check_aligned("causal_fwd_cuda", (q, bad))
