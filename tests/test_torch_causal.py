"""K4's plain PyTorch version (the CPU path of the torch port's
causal_flash_attention) against the JAX package's causal Pallas kernel
run in interpret mode, as tests/test_causal_flash.py runs it, and the
plain math against the JAX package's ``_causal_jnp``.

Inputs come from seeded numpy and go to both frameworks.  Tolerances:
f32 atol 2e-5 (one f32 softmax against another over a cache of up to
64 keys, sums in another order — the bar test_causal_flash.py holds the
kernel to); bf16 atol 2e-2 (logits and probabilities round to bf16 in
both, at other places).  The kernel itself runs only on the card
(tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
ref = pytest.importorskip("libsplinter_tpu.ops.flash_attention")

from libsplinter_tpu_torch.ops.flash_attention import (  # noqa: E402
    causal_attention_plain, causal_flash_attention, causal_fwd_cuda)

ATOL = 2e-5


def _inputs(seed, b, s, t, h, kh, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kk, vv = (rng.standard_normal((b, t, kh, d)).astype(np.float32)
              for _ in range(2))
    return q, kk, vv


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("s,t,bq,pos,starts,kh", [
    (32, 64, 16, 0, (0, 5), 2),     # prefill at slot 0, left-padded rows
    (24, 64, 16, 8, (0, 0), 2),     # joiner-style offset prefill, padded S
    (16, 32, 16, 16, (4, 12), 2),   # chunk at the window tail
    (32, 64, 16, 0, (0, 3), 1),     # GQA: 4 query heads share 1 kv head
    (32, 64, 16, 0, (0, 32), 2),    # a batch-pad row: no query sees a key
    (20, 64, 16, 30, (40, 64), 1),  # pos > 0, left-pad queries, pad row
])
def test_causal_plain_matches_pallas_interpret(s, t, bq, pos, starts, kh):
    q, kk, vv = _inputs(s + t + pos + kh, 2, s, t, 4, kh, 8)
    start = np.asarray(starts, np.int32)
    want = np.asarray(ref.causal_flash_attention(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv), jnp.int32(pos),
        jnp.asarray(start), block_q=bq, interpret=True))
    got = causal_flash_attention(*_torch(q, kk, vv), pos,
                                 torch.from_numpy(start)).numpy()
    assert got.shape == want.shape == q.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_keyless_queries_average_all_cache_slots():
    """A query at slot pos + i < start[b] sees no key: the reference's
    softmax over T finite -1e30 logits is uniform, so the output is the
    mean of V over all T slots — finite, never NaN."""
    q, kk, vv = _inputs(7, 2, 16, 48, 4, 2, 8)
    start = torch.tensor([10, 48], dtype=torch.int32)
    got = causal_flash_attention(*_torch(q, kk, vv), 0, start).numpy()
    mean = np.repeat(vv.mean(axis=1), 2, axis=1)          # (B, H, D)
    np.testing.assert_allclose(got[1], np.broadcast_to(mean[1], got[1].shape),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[0, :10],
                               np.broadcast_to(mean[0], got[0, :10].shape),
                               atol=1e-6, rtol=0)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_plain_matches_causal_jnp(dtype):
    q, kk, vv = _inputs(3, 3, 12, 40, 4, 4, 16)
    start = np.asarray([0, 7, 40], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(ref._causal_jnp(
        *(jnp.asarray(x, jdt) for x in (q, kk, vv)), jnp.int32(20),
        jnp.asarray(start)).astype(jnp.float32))
    got = causal_attention_plain(
        *(x.to(tdt) for x in _torch(q, kk, vv)), 20,
        torch.from_numpy(start)).float().numpy()
    atol = ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_start_none_is_all_zero_offsets():
    q, kk, vv = _torch(*_inputs(5, 2, 16, 32, 4, 2, 8))
    zero = torch.zeros(2, dtype=torch.int32)
    torch.testing.assert_close(causal_flash_attention(q, kk, vv, 4),
                               causal_flash_attention(q, kk, vv, 4, zero),
                               atol=0, rtol=0)


def test_kernel_launcher_refuses_cpu_tensors():
    """The CPU path is the plain math; the launcher itself only takes
    CUDA tensors (a CUDA tensor launches K4 or raises)."""
    q, kk, vv = _torch(*_inputs(6, 1, 16, 32, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        causal_fwd_cuda(q, kk, vv, 0, torch.zeros(1, dtype=torch.int32))
