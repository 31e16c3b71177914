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
kernel itself runs only on the card (tests/test_torch_kernels_gpu.py).

In bf16 the kernel rounds P and dS to bf16 before their products; the
plain backward's ``round_p=True`` does the same on the CPU, and its
result must stay inside the bound the card's checks hold the kernel to
(per element 2^-7 |ref| + 2^-8 of the rounding terms + 1e-5 max(1,
max |ref|), against the f32 plain version)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
ref = pytest.importorskip("libsplinter_tpu.ops.flash_attention")

from libsplinter_tpu_torch.ops.flash_attention import (  # noqa: E402
    _mha_plain, flash_attention, flash_attention_bwd_plain,
    flash_bwd_plain_and_terms, flash_row_stats_plain)


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


@pytest.mark.parametrize("b,s,h,d,lens", [
    (3, 64, 2, 16, (64, 20, 0)),     # a fully-masked row
    (2, 100, 2, 32, (100, 37)),      # S not a multiple of the tile
    (2, 128, 2, 64, (128, 0)),       # D = 64, a dead row
    (1, 96, 2, 128, (50,)),          # D = 128
])
def test_bf16_rounding_stays_inside_the_kernel_bound(b, s, h, d, lens):
    """The plain backward with P and dS rounded to bf16 (what K6 does
    on the tensor cores) against the f32 plain version on the same
    bf16 values: inside the bound of the card's checks, at least a
    tenth of the way to it somewhere (not vacuous), and outside the
    bound without its rounding term (the term is needed)."""
    rng = np.random.default_rng(s + d)
    q, k, v, do = (torch.from_numpy(_rand(rng, (b, s, h, d)))
                   .to(torch.bfloat16) for _ in range(4))
    mask = torch.from_numpy(_mask(s, lens))
    o = _mha_plain(q, k, v, mask)
    ref, terms = flash_bwd_plain_and_terms(q, k, v, o, do, mask)
    emu = flash_attention_bwd_plain(q, k, v, o, do, mask, round_p=True)
    for name, e, r, term in zip(("dq", "dk", "dv"), emu, ref, terms):
        assert e.dtype == torch.bfloat16
        err = (e.float() - r.to(torch.bfloat16).float()).abs()
        without = 2.0 ** -7 * r.abs() + 1e-5 * max(1.0, r.abs().max().item())
        worst = (err / (without + 2.0 ** -8 * term)).max().item()
        assert 0.1 <= worst <= 1.0, f"{name}: {worst:.3f} of the bound"
        assert (err > without).any(), f"{name}: the rounding term is idle"


def test_round_p_off_is_the_f32_products():
    """round_p is off by default: P and dS stay f32 and the result is
    the f32 computation rounded once at the end."""
    rng = np.random.default_rng(4)
    q, k, v, o, do = (torch.from_numpy(_rand(rng, (2, 32, 2, 16)))
                      .to(torch.bfloat16) for _ in range(5))
    mask = torch.from_numpy(_mask(32, (32, 9)))
    got = flash_attention_bwd_plain(q, k, v, o, do, mask)
    want = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)),
                                     mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.bfloat16))


@pytest.mark.parametrize("lens", [(48, 20, 0), (48, 1, 48)])
def test_row_stats_plain_rebuild_the_softmax(lens):
    """K1's stats output, as its plain helper gives it: exp(x - m) / l
    is the softmax of the masked logits, and a fully-masked row keeps
    m = -1e30 and l = S (not their log-sum-exp, which rounds to -1e30)."""
    b, s, h, d = len(lens), 48, 2, 16
    rng = np.random.default_rng(sum(lens))
    q, k, v = _t(*(_rand(rng, (b, s, h, d)) for _ in range(3)))
    (mask,) = _t(_mask(s, lens))
    m, l = flash_row_stats_plain(q, k, mask)
    assert m.shape == l.shape == (b, h, s)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / d ** 0.5
    logits = torch.where(mask[:, None, None, :], logits, -1e30)
    p = torch.exp(logits - m[..., None]) / l[..., None]
    torch.testing.assert_close(p, torch.softmax(logits, dim=-1), atol=1e-6,
                               rtol=1e-5)
    dead = [i for i, n in enumerate(lens) if n == 0]
    for i in dead:
        assert (m[i] == -1e30).all() and (l[i] == s).all()
