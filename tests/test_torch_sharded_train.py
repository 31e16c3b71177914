"""The torch port's dp x tp sharded trainer (parallel/train.py
make_sharded_train_step, ShardedEncoder) on the CPU, against the JAX
package's make_sharded_train_step on its virtual 8-device CPU mesh and
against the port's single-card step:

  - one step at dp = 4 x tp = 2 under SGD (optax.sgd /
    torch.optim.SGD) and under AdamW (optax.adamw / the port's adamw):
    the loss and every gathered parameter after the step;
  - the qkv regroup: it round-trips, and a contiguous split of the
    fused qkv weight (shard 0 holding all of q and half of k) gives
    another forward;
  - the vocab-parallel token lookup is exact;
  - the dp replicas stay bit-identical, a second step runs, the
    sharded init is the single-card init of the same generator split,
    and the trainer runs on cuda unless the mesh is on the CPU.

The same seeded numpy batch and the JAX init's weights (through
params_from_jax) go to both packages.  Tolerance: loss and parameters
1e-5 in f32 (the same math, sums taken in another order and the
reductions over tp in shard order); the lookup exact."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jpar = pytest.importorskip("libsplinter_tpu.parallel")

from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    ShardedEncoder, adamw, make_mesh, make_sharded_train_step,
    make_train_step)
from libsplinter_tpu_torch.parallel import train as ttrain  # noqa: E402

LR_SGD = 0.1
OPTS = {"sgd": (lambda: optax.sgd(LR_SGD),
                lambda p: torch.optim.SGD(p, lr=LR_SGD)),
        "adamw": (lambda: optax.adamw(1e-4, weight_decay=0.01), adamw)}


def _cfgs(**kw):
    base = dict(out_dim=16, flash_min_seq=16, **kw)
    return (jenc.EncoderConfig.tiny(dtype=jnp.float32, **base),
            tenc.EncoderConfig.tiny(dtype=torch.float32, **base))


def _batch(cfg, seed=0, b=8, s=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.arange(s)[None] < rng.integers(8, s + 1, (b, 1))
    ids_b = ids.copy()
    swap = rng.random(ids.shape) < 0.3
    ids_b[swap] = rng.integers(0, cfg.vocab_size, int(swap.sum()))
    return {"ids_a": ids, "mask_a": mask, "ids_b": ids_b,
            "mask_b": np.arange(s)[None] < rng.integers(8, s + 1, (b, 1))}


def _cpu_mesh(dp=4, tp=2, **kw):
    return make_mesh(dp=dp, tp=tp, device="cpu", **kw)


@pytest.fixture(scope="module", params=sorted(OPTS))
def one_step(request):
    """One step from the JAX init's weights, perturbed, by the JAX
    sharded trainer (dp = 4 x tp = 2), the port's sharded trainer on the
    same mesh and the port's single-card trainer."""
    jopt, topt = OPTS[request.param]
    cfg_j, cfg = _cfgs()
    batch = _batch(cfg)
    jinit = jpar.make_sharded_train_step(
        cfg_j, jpar.make_mesh(dp=4, tp=2), optimizer=jopt())
    js, jstep = jinit(jax.random.PRNGKey(0), batch["ids_a"][:1],
                      batch["mask_a"][:1])
    # every leaf perturbed, so biases and norms are off their identity
    # init (a row-parallel bias added once per tp shard would show);
    # the moments stay at their zero init
    rng = np.random.default_rng(7)
    js = js._replace(params=jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x) + rng.normal(
            scale=0.05, size=x.shape).astype(np.float32)), js.params))
    sd = tenc.params_from_jax(js.params, cfg)
    js2, jl = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})

    sinit = make_sharded_train_step(cfg, _cpu_mesh(), optimizer=topt)
    ss, step = sinit(torch.Generator().manual_seed(0), batch["ids_a"][:1],
                     batch["mask_a"][:1])
    ss.module.load_full(sd)
    ss2, sl = step(ss, batch)

    init1, step1 = make_train_step(cfg, optimizer=topt, device="cpu")
    s1 = init1(torch.Generator().manual_seed(0), batch["ids_a"][:1],
               batch["mask_a"][:1])
    s1.module.load_state_dict(sd)
    s12, l1 = step1(s1, batch)
    return {"jax": (float(jl), tenc.params_from_jax(js2.params, cfg)),
            "sharded": (float(sl), ss2.module.full_state_dict()),
            "single": (float(l1), s12.module.state_dict()),
            "state": ss2, "step": step, "batch": batch}


@pytest.mark.parametrize("ref", ["jax", "single"])
def test_one_step_matches(one_step, ref):
    """Loss and every gathered parameter after one step equal the JAX
    sharded trainer's and the port's single-card trainer's within
    1e-5."""
    loss, params = one_step["sharded"]
    want_loss, want = one_step[ref]
    assert loss == pytest.approx(want_loss, abs=1e-5)
    assert set(params) == set(want)
    for name, p in params.items():
        err = float((p - want[name]).abs().max())
        assert err <= 1e-5, f"{name}: {err} off the {ref} step"


def test_replicas_equal_and_a_second_step_runs(one_step):
    state, step = one_step["state"], one_step["step"]
    assert state.step == 1
    assert state.module.replica_mismatches() == []
    state, loss = step(state, _batch(tenc.EncoderConfig.tiny(), seed=1))
    assert state.step == 2 and np.isfinite(float(loss))
    assert state.module.replica_mismatches() == []


def test_sharded_init_is_the_single_card_init_split():
    _, cfg = _cfgs()
    ids, mask = np.zeros((2, 32), np.int32), np.ones((2, 32), bool)
    init1, _ = make_train_step(cfg, device="cpu")
    whole = init1(torch.Generator().manual_seed(3), ids, mask)
    ss, _ = make_sharded_train_step(cfg, _cpu_mesh())(
        torch.Generator().manual_seed(3), ids, mask)
    got = ss.module.full_state_dict()
    for name, p in whole.module.state_dict().items():
        assert torch.equal(got[name], p), name
    # each shard holds heads / tp and mlp_dim / tp, vocab / tp rows
    shard = ss.module.shards[0]
    assert shard.cfg.heads == cfg.heads // 2
    assert shard.layer_0.attn.qkv.weight.shape == (3 * cfg.hidden // 2,
                                                   cfg.hidden)
    assert shard.layer_0.mlp.down.weight.shape == (cfg.hidden,
                                                   cfg.mlp_dim // 2)
    assert shard.tok_emb.weight.shape == (cfg.vocab_size // 2, cfg.hidden)


def test_qkv_regroup_round_trips():
    tp, n = 4, 8
    w = torch.arange(3 * n * 5.0).reshape(3 * n, 5)
    b = torch.arange(3.0 * n)
    for t in (w, b):
        g = ttrain.regroup_qkv(t, tp)
        assert torch.equal(ttrain.ungroup_qkv(g, tp), t)
        assert not torch.equal(g, t)
    # shard 1's rows after the contiguous split: its q, k and v rows
    g = ttrain.regroup_qkv(b, tp).reshape(tp, -1)
    q, k, v = b.reshape(3, tp, -1)[:, 1]
    assert torch.equal(g[1], torch.cat([q, k, v]))


def test_a_contiguous_qkv_split_is_wrong(monkeypatch):
    """Without the regroup, shard 0 holds all of q and half of k: the
    sharded forward then leaves the dense one.  With it, they agree."""
    _, cfg = _cfgs()
    whole = tenc.Encoder(cfg)
    tenc.init_params(whole, torch.Generator().manual_seed(0))
    b = _batch(cfg)
    ids, mask = torch.from_numpy(b["ids_a"]).long(), \
        torch.from_numpy(b["mask_a"])
    with torch.no_grad():
        want = whole(ids, mask)
        good = ShardedEncoder(cfg, _cpu_mesh(dp=1)).load_full(
            whole.state_dict())(ids, mask)
        monkeypatch.setattr(ttrain, "regroup_qkv", lambda t, tp: t)
        monkeypatch.setattr(ttrain, "ungroup_qkv", lambda t, tp: t)
        bad = ShardedEncoder(cfg, _cpu_mesh(dp=1)).load_full(
            whole.state_dict())(ids, mask)
    assert float((good - want).abs().max()) < 1e-5
    assert float((bad - want).abs().max()) > 1e-2


def test_vocab_parallel_lookup_is_exact():
    """Each tp shard looks up the ids in its row range and gives zeros
    elsewhere: the sum over the shards is the whole table's lookup, bit
    for bit, in f32 and bf16."""
    rng = np.random.default_rng(4)
    for dtype in (torch.float32, torch.bfloat16):
        whole = tenc.Embed(64, 8, dtype)
        whole.weight.data = torch.from_numpy(
            rng.standard_normal((64, 8)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, 64, (3, 11)))
        for tp in (2, 4):
            parts = []
            for t in range(tp):
                shard = tenc.Embed(64 // tp, 8, dtype)
                shard.weight.data = whole.weight.data[t * 64 // tp:
                                                      (t + 1) * 64 // tp]
                parts.append(shard.partial(ids, t))
            assert all(p.dtype == dtype for p in parts)
            assert torch.equal(sum(parts), whole(ids))


def test_mesh_axes_the_trainer_refuses():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="ring_axis"):
        ShardedEncoder(cfg, make_mesh(dp=2, sp=2, device="cpu"))
    with pytest.raises(ValueError, match="pp"):
        ShardedEncoder(cfg, make_mesh(dp=1, pp=2, device="cpu"))
    with pytest.raises(ValueError, match="divide"):
        ShardedEncoder(dataclasses.replace(cfg, heads=3), _cpu_mesh())


def test_default_mesh_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(dp=1, tp=2)
