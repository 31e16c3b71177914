"""The torch port's contrastive trainer (parallel/train.py) against the
JAX package's, on the CPU: the tiny encoder in f32 with
flash_min_seq = 16 at S = 32, so attention goes through the port's
autograd Function (K1's and K6's plain versions here) and, on the JAX
side, through flash_attention's plain math.

Inputs (token ids, masks, a perturbation of every parameter leaf so
biases and layer norms are not at their identity init) come from
seeded numpy.  Tolerances: the loss at 1e-5; each parameter's gradient
within 1e-4 of its tensor's largest |g| (the same math in two
frameworks, sums in another order); parameters after an AdamW step
within 1e-6 wherever |g| > 1e-6, elsewhere within 2 * lr (Adam's first
step moves a parameter by about lr * sign(g) whatever the size of g,
so the sign of a gradient at rounding level decides it); bf16 compute
at cosine >= 0.99 per tensor to the f32 gradient, and no farther from
it than the JAX package's own bf16 gradient (bf16 rounds at other
places in the two frameworks)."""
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jtrain = pytest.importorskip("libsplinter_tpu.parallel.train")

from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    info_nce_loss, loss_fn, make_train_step, state_from_jax)

# the module (ops/__init__ re-exports a function of the same name)
tfa = importlib.import_module("libsplinter_tpu_torch.ops.flash_attention")

LR = 1e-4
S = 32


def _configs(dtype_j=jnp.float32, dtype_t=torch.float32):
    kw = dict(flash_min_seq=16, out_dim=48)
    return (jenc.EncoderConfig.tiny(dtype=dtype_j, **kw),
            tenc.EncoderConfig.tiny(dtype=dtype_t, **kw))


def _jax_params(cfg_j, seed=0):
    ids = np.ones((1, 8), np.int32)
    params = jenc.Encoder(cfg_j).init(jax.random.PRNGKey(seed), ids,
                                      np.ones((1, 8), bool))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x, np.float32) + rng.normal(
            scale=0.05, size=x.shape).astype(np.float32)), params)


def _batch(cfg, seed=1, b=8):
    """b pairs at S = 32: lengths in [8, 32]; ids_b is ids_a with ~30%
    of its tokens replaced and its own lengths, so the towers differ.
    Token ids follow Zipf's law, as words of text do, so texts share
    frequent tokens and the loss is not near 0 from the start."""
    rng = np.random.default_rng(seed)

    def tokens(shape):
        return (np.minimum(rng.zipf(1.1, shape), cfg.vocab_size)
                - 1).astype(np.int32)

    ids = tokens((b, S))
    ids_b = ids.copy()
    swap = rng.random(ids.shape) < 0.3
    ids_b[swap] = tokens(int(swap.sum()))
    lens_a, lens_b = rng.integers(8, S + 1, (2, b))
    return {"ids_a": ids, "mask_a": np.arange(S)[None] < lens_a[:, None],
            "ids_b": ids_b, "mask_b": np.arange(S)[None] < lens_b[:, None]}


def _jax_state(cfg_j, params):
    opt = optax.adamw(LR, weight_decay=0.01)
    return jtrain.TrainState(params, opt.init(params),
                             jnp.zeros((), jnp.int32))


def _jax_loss_and_grads(cfg_j, params, batch):
    module = jenc.Encoder(cfg_j)

    def f(p):
        za = module.apply(p, batch["ids_a"], batch["mask_a"])
        zb = module.apply(p, batch["ids_b"], batch["mask_b"])
        return jtrain.info_nce_loss(za, zb)

    loss, grads = jax.value_and_grad(f)(params)
    return float(loss), tenc.params_from_jax(grads, tenc.EncoderConfig.tiny())


def _torch_loss_and_grads(module, batch):
    module.zero_grad(set_to_none=True)
    loss = loss_fn(module, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                         for n, p in module.named_parameters()}


def test_info_nce_matches_jax():
    rng = np.random.default_rng(3)
    za, zb = (rng.standard_normal((6, 16)).astype(np.float32)
              for _ in range(2))
    za /= np.linalg.norm(za, axis=1, keepdims=True)
    zb /= np.linalg.norm(zb, axis=1, keepdims=True)
    for t in (0.05, 0.5):
        want = float(jtrain.info_nce_loss(jnp.asarray(za), jnp.asarray(zb),
                                          t))
        got = float(info_nce_loss(torch.from_numpy(za),
                                  torch.from_numpy(zb), t))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_loss_and_gradients_match_jax(monkeypatch):
    cfg_j, cfg_t = _configs()
    params = _jax_params(cfg_j)
    batch = _batch(cfg_t)
    want_loss, want = _jax_loss_and_grads(cfg_j, params, batch)
    state = state_from_jax(_jax_state(cfg_j, params), cfg_t, device="cpu")
    # the attention of every layer goes through the autograd Function
    calls = []
    apply = tfa._FlashAttention.apply
    monkeypatch.setattr(tfa._FlashAttention, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    got_loss, got = _torch_loss_and_grads(state.module, batch)
    assert len(calls) == 2 * cfg_t.layers
    assert got_loss == pytest.approx(want_loss, abs=1e-5)
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = float(w.abs().max())
        assert scale > 0, name
        err = float((g - w).abs().max())
        assert err <= 1e-4 * scale, f"{name}: {err} > 1e-4 * {scale}"


def _check_params(module, jax_params, jax_grads, cfg_t):
    want = tenc.params_from_jax(jax_params, cfg_t)
    for name, p in module.named_parameters():
        diff = (p.detach() - want[name]).abs()
        big = jax_grads[name].abs() > 1e-6
        assert not big.any() or float(diff[big].max()) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR, name


def test_adamw_steps_match_optax():
    """One step from the bridged state, then a second step from
    state_from_jax of the JAX trainer's state after its first: AdamW's
    moments and count come over with the weights."""
    cfg_j, cfg_t = _configs()
    _, jstep = jtrain.make_train_step(cfg_j)
    jstep = jax.jit(jstep)
    js0 = _jax_state(cfg_j, _jax_params(cfg_j))
    b1, b2 = _batch(cfg_t, 1), _batch(cfg_t, 2)
    _, step_fn = make_train_step(cfg_t, device="cpu")

    _, g1 = _jax_loss_and_grads(cfg_j, js0.params, b1)
    js1, jl1 = jstep(js0, b1)
    st1, l1 = step_fn(state_from_jax(js0, cfg_t, device="cpu"), b1)
    assert st1.step == 1
    assert float(l1) == pytest.approx(float(jl1), abs=1e-5)
    _check_params(st1.module, js1.params, g1, cfg_t)

    _, g2 = _jax_loss_and_grads(cfg_j, js1.params, b2)
    js2, jl2 = jstep(js1, b2)
    resumed = state_from_jax(js1, cfg_t, device="cpu")
    assert resumed.step == 1
    st2, l2 = step_fn(resumed, b2)
    assert st2.step == 2
    assert float(l2) == pytest.approx(float(jl2), abs=1e-5)
    _check_params(st2.module, js2.params, g2, cfg_t)


def _cosine(a, b):
    return float(torch.nn.functional.cosine_similarity(
        a.flatten(), b.flatten(), dim=0))


def test_bf16_gradients_match_jax():
    """bf16 compute over f32 master weights.  The reference for the
    gradient is the JAX package's f32 gradient on the same weights and
    batch: each tensor of the port's bf16 gradient at cosine >= 0.99 to
    it.  The JAX package's own bf16 gradient is no exact anchor — its
    bf16 backward rounds in other places (its bias gradients reduce
    bf16 cotangents, to cosine 0.989 of f32 on this batch) — so the
    port's is held to be no farther from f32 than the JAX package's
    bf16 gradient is, less 1e-3."""
    cfg_j, cfg_t = _configs(jnp.bfloat16, torch.bfloat16)
    cfg_j32, _ = _configs()
    params = _jax_params(cfg_j)
    batch = _batch(cfg_t)
    want_loss, want = _jax_loss_and_grads(cfg_j, params, batch)
    _, want32 = _jax_loss_and_grads(cfg_j32, params, batch)
    state = state_from_jax(_jax_state(cfg_j, params), cfg_t, device="cpu")
    assert all(p.dtype == torch.float32
               for p in state.module.parameters())   # f32 master weights
    got_loss, got = _torch_loss_and_grads(state.module, batch)
    assert np.isfinite(got_loss)
    assert got_loss == pytest.approx(want_loss, rel=0.05)
    for name, g in got.items():
        assert g.dtype == torch.float32, name
        cos = _cosine(g, want32[name])
        assert cos >= 0.99, f"{name}: cosine {cos} to the f32 gradient"
        ref_cos = _cosine(want[name], want32[name])
        assert cos >= ref_cos - 1e-3, \
            f"{name}: cosine {cos} to f32, the JAX package's bf16 {ref_cos}"


def test_loss_falls_on_a_fixed_batch():
    _, cfg_t = _configs()
    init_fn, step_fn = make_train_step(cfg_t, device="cpu")
    batch = _batch(cfg_t, 5)
    state = init_fn(torch.Generator().manual_seed(0), batch["ids_a"],
                    batch["mask_a"])
    losses = []
    for _ in range(10):
        state, loss = step_fn(state, batch)
        losses.append(float(loss))
    assert state.step == 10
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_init_is_seeded_by_the_generator():
    _, cfg_t = _configs()
    init_fn, _ = make_train_step(cfg_t, device="cpu")
    ids, mask = np.zeros((2, S), np.int32), np.ones((2, S), bool)
    a, b, c = (init_fn(torch.Generator().manual_seed(s), ids, mask)
               for s in (0, 0, 1))
    wa, wb, wc = (st.module.layer_0.attn.qkv.weight for st in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    with pytest.raises(ValueError):
        init_fn(torch.Generator(), ids, mask[:, :16])


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg_t = _configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg_t)
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_jax(None, cfg_t)
