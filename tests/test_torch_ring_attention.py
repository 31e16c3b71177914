"""The torch port's ring attention and sequence-parallel trainer
(parallel/{ring_attention,train}.py) on the CPU, against the port's
dense oracle and the JAX package's ring on its virtual 8-device CPU
mesh — every case of tests/test_ring_attention.py:

  - ring vs dense attention, causal and not, at dp = 2 x sp = 4 and
    sp = 8;
  - dq, dk and dv through the ring (the K/V cotangents flow back through
    the rotation's copies) against the dense gradients;
  - the sequence-parallel encoder (ring attention, global rotary or
    bert positions, the pool's sums reduced over sp) for nomic and bert
    against the dense forward;
  - one SGD step of make_ring_train_step against the single-card step
    and the JAX ring step (no division by dp * sp: the port computes
    the loss once);
  - the missing-axis ValueError.

The same seeded numpy inputs and weights go to both packages (weights
through params_from_jax).  Tolerances, as the JAX tests hold theirs:
outputs and losses 1e-5, parameters after a step 1e-5, gradients 1e-4
(f32 sums in another order)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jpar = pytest.importorskip("libsplinter_tpu.parallel")
jmesh = pytest.importorskip("libsplinter_tpu.parallel.mesh")

from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    ShardedEncoder, dense_reference, make_mesh, make_ring_train_step,
    make_train_step, ring_attention_sharded)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_ring(mesh, causal):
    """The JAX package's ring under jit (one compile instead of op by op
    dispatch inside shard_map)."""
    return jax.jit(lambda q, k, v, m: jpar.ring_attention_sharded(
        mesh, q, k, v, m, causal=causal))


@pytest.fixture(scope="module")
def qkvm():
    rng = np.random.default_rng(0)
    b, s, h, d = 2, 32, 4, 16
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((b, s)) > 0.2
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(qkvm, causal):
    q, k, v, mask = qkvm
    args = [_t(x) for x in (q, k, v, mask)]
    ref = dense_reference(*args, causal=causal)
    out = ring_attention_sharded(make_mesh(dp=2, sp=4, device="cpu"),
                                 *args, causal=causal)
    assert float((out - ref).abs().max()) < 1e-5
    jref = jpar.dense_reference(*map(jnp.asarray, (q, k, v, mask)),
                                causal=causal)
    jout = _jax_ring(jmesh.make_mesh(dp=2, tp=1, sp=4), causal)(
        *map(jnp.asarray, (q, k, v, mask)))
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_gradient_matches_dense(qkvm, causal):
    """dq, dk and dv of sum(out^2) through the ring against the dense
    oracle's and the JAX ring's."""
    q, k, v, mask = qkvm
    mesh = make_mesh(dp=2, sp=4, device="cpu")

    def grads(fn):
        ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
        (fn(*ts, _t(mask), causal=causal) ** 2).sum().backward()
        return [t.grad for t in ts]

    g_ring = grads(lambda *a, **kw: ring_attention_sharded(mesh, *a, **kw))
    g_ref = grads(dense_reference)
    jm = jmesh.make_mesh(dp=2, tp=1, sp=4)
    jm_mask = jnp.asarray(mask)
    g_jax = jax.jit(jax.grad(lambda q, k, v: (jpar.ring_attention_sharded(
        jm, q, k, v, jm_mask, causal=causal) ** 2).sum(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for a, b, c, name in zip(g_ring, g_ref, g_jax, "qkv"):
        assert float((a - b).abs().max()) < 1e-4, f"d/d{name} vs dense"
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=1e-4,
                                   rtol=0, err_msg=f"d/d{name} vs JAX")


def test_sp8_full_ring(qkvm):
    """All eight shards on the ring (sp = 8, no dp)."""
    q, k, v, mask = qkvm
    args = [_t(x) for x in (q, k, v, mask)]
    ref = dense_reference(*args)
    out = ring_attention_sharded(make_mesh(dp=1, sp=8, device="cpu"),
                                 *args)
    assert float((out - ref).abs().max()) < 1e-5
    jout = _jax_ring(jmesh.make_mesh(dp=1, tp=1, sp=8), False)(
        *map(jnp.asarray, (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def enc_setup():
    rng = np.random.default_rng(1)
    cfg_j = jenc.EncoderConfig.tiny(out_dim=16, dtype=jnp.float32)
    b, s = 4, 32
    ids = rng.integers(0, cfg_j.vocab_size, size=(b, s)).astype(np.int32)
    lens = rng.integers(s // 2, s + 1, size=(b,))
    mask = np.arange(s)[None] < lens[:, None]
    return cfg_j, ids, mask


def _torch_cfg(cfg_j, **kw):
    return tenc.EncoderConfig.tiny(out_dim=cfg_j.out_dim,
                                   dtype=torch.float32,
                                   variant=cfg_j.variant, **kw)


@pytest.mark.parametrize("variant", ["nomic", "bert"])
def test_sequence_parallel_encoder_matches_dense(enc_setup, variant):
    """The encoder sequence-sharded over sp (ring attention, global
    rotary or absolute positions, pooled sums reduced over sp) gives the
    dense embeddings — the port's and the JAX package's, on the same
    weights."""
    cfg_j, ids, mask = enc_setup
    cfg_j = dataclasses.replace(cfg_j, variant=variant)
    params = jenc.Encoder(cfg_j).init(jax.random.PRNGKey(0), ids, mask)
    want = np.asarray(jenc.Encoder(cfg_j).apply(params, ids, mask))
    cfg = _torch_cfg(cfg_j)
    sd = tenc.params_from_jax(params, cfg)
    dense = tenc.Encoder(cfg)
    dense.load_state_dict(sd)
    ring = ShardedEncoder(dataclasses.replace(cfg, ring_axis="sp"),
                          make_mesh(dp=2, sp=4, device="cpu")).load_full(sd)
    with torch.no_grad():
        ref = dense(_t(ids).long(), _t(mask))
        out = ring(_t(ids).long(), _t(mask))
    assert float((out - ref).abs().max()) < 1e-5
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=0)


def test_sequence_parallel_bert_refuses_past_its_table(enc_setup):
    """bert's learned positions end at max_len: a global sequence
    longer than the table is refused, as the JAX encoder refuses it."""
    cfg_j, ids, mask = enc_setup
    cfg = _torch_cfg(cfg_j, max_len=16, ring_axis="sp")
    cfg = dataclasses.replace(cfg, variant="bert")
    ring = ShardedEncoder(cfg, make_mesh(dp=1, sp=4, device="cpu"))
    with pytest.raises(ValueError, match="max_len"):
        ring(_t(ids).long(), _t(mask))


def test_ring_train_step_matches_dense(enc_setup):
    """One SGD step of the sequence-parallel trainer equals one step of
    the single-card trainer and of the JAX ring trainer: the same loss,
    every parameter within 1e-5."""
    cfg_j, ids, mask = enc_setup
    lr = 0.1
    batch = {"ids_a": ids, "mask_a": mask,
             "ids_b": (ids + 7) % cfg_j.vocab_size, "mask_b": mask}
    cfg = _torch_cfg(cfg_j)
    init_d, step_d = make_train_step(
        cfg, optimizer=lambda p: torch.optim.SGD(p, lr=lr), device="cpu")
    init_r, step_r = make_ring_train_step(
        dataclasses.replace(cfg, ring_axis="sp"),
        make_mesh(dp=2, sp=4, device="cpu"),
        optimizer=lambda p: torch.optim.SGD(p, lr=lr))
    sd = init_d(torch.Generator().manual_seed(0), ids[:1], mask[:1])
    sr = init_r(torch.Generator().manual_seed(0), ids[:1], mask[:1])
    # the same generator gives the same weights, split
    start = sr.module.full_state_dict()
    for name, p in sd.module.state_dict().items():
        assert torch.equal(start[name], p), name
    sd2, ld = step_d(sd, batch)
    sr2, lr_ = step_r(sr, batch)
    assert abs(float(ld) - float(lr_)) < 1e-5
    got = sr2.module.full_state_dict()
    for name, p in sd2.module.state_dict().items():
        assert float((got[name] - p).abs().max()) < 1e-5, name
    assert sr2.step == 1 and not sr2.module.replica_mismatches()

    # the JAX ring step from the same weights
    jmesh_ = jmesh.make_mesh(dp=2, tp=1, sp=4)
    opt = optax.sgd(lr)
    jinit, jstep = jpar.make_ring_train_step(
        dataclasses.replace(cfg_j, ring_axis="sp"), jmesh_, optimizer=opt)
    js = jinit(jax.random.PRNGKey(0), ids[:1], mask[:1])
    jparams = jax.tree.map(jnp.asarray, _jax_tree(start, cfg))
    js = js._replace(params=jparams, opt_state=opt.init(jparams))
    js2, jl = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(jl) - float(lr_)) < 1e-5
    want = tenc.params_from_jax(js2.params, cfg)
    for name, p in got.items():
        assert float((want[name] - p).abs().max()) < 1e-5, name


def _jax_tree(state_dict, cfg):
    """A whole model's state_dict as the JAX package's param tree."""
    with torch.device("meta"):
        whole = tenc.Encoder(cfg)
    whole = whole.to_empty(device="cpu")
    whole.load_state_dict(state_dict)
    tree: dict = {}
    for key, arr in tenc.params_to_jax(whole).items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def test_ring_train_step_rejects_missing_axis(enc_setup):
    cfg_j, _, _ = enc_setup
    cfg = _torch_cfg(cfg_j)
    mesh = make_mesh(dp=8, device="cpu")
    with pytest.raises(ValueError, match="ring_axis"):
        make_ring_train_step(cfg, mesh)            # no ring_axis set
    with pytest.raises(ValueError, match="ring_axis"):
        make_ring_train_step(dataclasses.replace(cfg, ring_axis="seq"),
                             mesh)                 # names no mesh axis
    with pytest.raises(ValueError):
        jpar.make_ring_train_step(cfg_j, jmesh.make_mesh(dp=8, tp=1))
