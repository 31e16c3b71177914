"""K6's plain PyTorch version and the port's differentiable
flash_attention (the CPU route of the autograd Function: K1's and K6's
plain versions) against the JAX package: its blockwise backward kernel
in interpret mode, and jax.grad through its custom VJP.

Inputs come from seeded numpy and go to both frameworks.  Tolerances:
the plain backward against the Pallas backward at f32 atol 1e-5 (the
same formulas, sums in another order); gradients through the whole
function at 3e-4 in the padded and fully-masked cases, as the JAX
package's own test of them holds its kernel to its plain math
(tests/test_flash_attention.py), and 2e-5 in f32 with no padding.  The
kernel itself runs only on the card (tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
ref = pytest.importorskip("libsplinter_tpu.ops.flash_attention")

from libsplinter_tpu_torch.ops.flash_attention import (  # noqa: E402
    _mha_plain, flash_attention, flash_attention_bwd_plain)


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mask(s, lens):
    return np.arange(s)[None, :] < np.asarray(lens)[:, None]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("b,s,h,d,bq,lens", [
    (3, 64, 2, 16, 32, (64, 20, 0)),     # two query blocks, a dead row
    (2, 48, 2, 32, 16, (48, 1)),         # three blocks, one live key
    (1, 128, 1, 64, 128, (100,)),        # one block, D = 64
])
def test_bwd_plain_matches_pallas_interpret(b, s, h, d, bq, lens):
    rng = np.random.default_rng(s + d)
    q, k, v, o, do = (_rand(rng, (b, s, h, d)) for _ in range(5))
    mask = _mask(s, lens)
    tr = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v, o, do)]
    maskf = jnp.asarray(mask.astype(np.float32)[:, None, :])
    want = ref._flash_bwd_pallas(*tr, maskf, block_q=bq, interpret=True,
                                 hi_prec=True)
    got = flash_attention_bwd_plain(*_t(q, k, v, o, do, mask))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w).transpose(0, 2, 1, 3), atol=1e-5,
            rtol=0, err_msg=name)


def _torch_grads(q, k, v, mask, roww, bq):
    q, k, v = (x.requires_grad_(True) for x in _t(q, k, v))
    (mask_t,) = _t(mask)
    out = flash_attention(q, k, v, mask_t, block_q=bq)
    loss = ((out * torch.from_numpy(roww)) ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (q, k, v))]


def _jax_grads(q, k, v, mask, roww, bq):
    m = jnp.asarray(mask)

    def loss(q, k, v):
        out = ref.flash_attention(q, k, v, m, block_q=bq, interpret=True)
        return jnp.sum((out * roww) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("s,bq,lens,tol", [
    (48, 32, (48, 20, 1), 3e-4),    # S not a block multiple: padded
    (32, 16, (32, 0, 7), 3e-4),     # one fully-masked row in the batch
    (48, 32, (48, 20, 0), 3e-4),    # both: padding and a dead row
    (64, 32, (64, 64, 64), 2e-5),   # f32, no padding, nothing masked
])
def test_grads_match_jax_grad_through_the_kernel(s, bq, lens, tol):
    """jax.grad through the Pallas forward and its blockwise backward
    (the custom VJP) against torch.autograd through the port's
    Function.  Dead rows are pooling-excluded don't-cares: the loss
    weighs rows by validity, as the JAX package's test does."""
    b, h, d = 3, 2, 8
    rng = np.random.default_rng(s + bq)
    q, k, v = (_rand(rng, (b, s, h, d)) for _ in range(3))
    mask = _mask(s, lens)
    roww = mask.any(axis=1).astype(np.float32)[:, None, None, None]
    got = _torch_grads(q, k, v, mask, roww, bq)
    want = _jax_grads(q, k, v, mask, roww, bq)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("s,bq,lens", [
    (40, 16, (40, 9)),              # padded 40 -> 48
    (32, 32, (32, 32)),             # no padding, nothing masked
    (48, 32, (48, 0, 30)),          # padding and a dead row
])
def test_function_backward_matches_autograd_of_plain(s, bq, lens):
    """The Function's CPU backward (K6's plain formulas on the padded
    layout) against autograd of the plain forward, in f32."""
    b, h, d = len(lens), 2, 16
    rng = np.random.default_rng(s * 3 + bq)
    q, k, v = (_rand(rng, (b, s, h, d)) for _ in range(3))
    mask = _mask(s, lens)
    roww = mask.any(axis=1).astype(np.float32)[:, None, None, None]
    got = _torch_grads(q, k, v, mask, roww, bq)
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
    out = _mha_plain(qt, kt, vt, torch.from_numpy(mask))
    loss = ((out * torch.from_numpy(roww)) ** 2).sum()
    want = torch.autograd.grad(loss, (qt, kt, vt))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


def test_no_grad_path_is_unchanged():
    """Under no_grad, or with no input requiring grad, flash_attention
    takes the serving path: no autograd graph behind its output."""
    rng = np.random.default_rng(0)
    q, k, v = _t(*(_rand(rng, (2, 40, 2, 16)) for _ in range(3)))
    (mask,) = _t(_mask(40, (40, 11)))
    plain = flash_attention(q, k, v, mask, block_q=16)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert flash_attention(qg, k, v, mask, block_q=16).grad_fn is None
    diff = flash_attention(qg, k, v, mask, block_q=16)
    assert diff.grad_fn is not None
    torch.testing.assert_close(diff.detach(), plain, atol=0, rtol=0)
