"""Trainer checkpoints of the torch port (parallel/checkpoint.py), after
the JAX package's checkpoint tests: save -> restore resumes training
identically, latest_step, a missing path raises, and the npz export
loads into the JAX package's Encoder.apply; the trained parameters also
serve through EmbeddingModel (params= or a safetensors file); a
single-card checkpoint resumes on the dp x tp sharded trainer and a
sharded one on the single-card trainer (tests/test_checkpoint.py's
restore onto the sharded trainer, both ways).  CPU, the tiny encoder in
f32.

Tolerances: resume is exact (the same arithmetic on the same values:
losses equal to 1e-6 relative, as the JAX test holds orbax); the JAX
encoder on the exported npz against the port at atol 1e-5 on the
unit-norm embeddings (the same math in two frameworks); across the
single-card / sharded boundary the restored weights and moments are
exact, and the next two losses equal the uninterrupted trainer's
within 1e-5 (the sharded step sums in another order)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")

from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_sharded_train_step, make_train_step)
from libsplinter_tpu_torch.parallel import checkpoint as ckpt  # noqa: E402

CFG = tenc.EncoderConfig.tiny(out_dim=16, dtype=torch.float32,
                              flash_min_seq=16)


def _batch(seed=0, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, size=(8, s)).astype(np.int32)
    mask = np.arange(s)[None] < rng.integers(4, s + 1, (8, 1))
    return {"ids_a": ids, "mask_a": mask,
            "ids_b": ((ids + 1) % CFG.vocab_size).astype(np.int32),
            "mask_b": mask}


def _trained(steps=2, seed=0):
    init_fn, step_fn = make_train_step(CFG, device="cpu")
    b = _batch()
    state = init_fn(torch.Generator().manual_seed(seed), b["ids_a"],
                    b["mask_a"])
    for i in range(steps):
        state, _ = step_fn(state, _batch(i))
    return init_fn, step_fn, state


def _fresh(init_fn, seed=7):
    b = _batch()
    return init_fn(torch.Generator().manual_seed(seed), b["ids_a"],
                   b["mask_a"])


def _flat_optimizer(opt):
    return [(i, k, v) for i, st in enumerate(opt.state.values())
            for k, v in sorted(st.items())]


def test_save_restore_resumes_identically(tmp_path):
    init_fn, step_fn, state = _trained()
    path = str(tmp_path / "ck")
    assert ckpt.save(state, path) == 2
    assert ckpt.latest_step(path) == 2

    got = ckpt.restore(path, like=_fresh(init_fn))
    assert got.step == 2
    for (na, va), (nb, vb) in zip(state.module.state_dict().items(),
                                  got.module.state_dict().items()):
        assert na == nb
        assert torch.equal(va, vb), na
    flat_a = _flat_optimizer(state.optimizer)
    flat_b = _flat_optimizer(got.optimizer)
    assert len(flat_a) == len(flat_b) > 0
    for (i, ka, va), (_, kb, vb) in zip(flat_a, flat_b):
        assert ka == kb and torch.equal(va, vb), (i, ka)

    # resumed training == uninterrupted training
    cont_a, loss_a = step_fn(state, _batch(2))
    cont_b, loss_b = step_fn(got, _batch(2))
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-6)
    assert cont_b.step == 3
    _, loss_a = step_fn(cont_a, _batch(3))
    _, loss_b = step_fn(cont_b, _batch(3))
    assert float(loss_a) == pytest.approx(float(loss_b), rel=1e-6)


def test_latest_step_and_keep_newest_three(tmp_path):
    _, _, state = _trained(steps=1)
    path = str(tmp_path / "ck")
    assert ckpt.latest_step(path) is None
    for step in (1, 5, 3, 9):
        ckpt.save(state, path, step=step)
    assert ckpt.latest_step(path) == 9
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["3", "5", "9"]
    init_fn, _ = make_train_step(CFG, device="cpu")
    assert ckpt.restore(path, _fresh(init_fn), step=5).step == 5


def test_save_clears_a_crashed_save(tmp_path):
    """A temporary file left by a save that crashed before its rename
    is neither a step nor kept: the next save removes it."""
    _, _, state = _trained(steps=1)
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / ".4.999.tmp").write_bytes(b"half a checkpoint")
    assert ckpt.latest_step(str(ck)) is None
    ckpt.save(state, str(ck))
    assert sorted(p.name for p in ck.iterdir()) == ["1"]


def test_missing_checkpoint_raises(tmp_path):
    init_fn, _ = make_train_step(CFG, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nope"), like=_fresh(init_fn))
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    _, _, state = _trained(steps=1)
    ckpt.save(state, str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "ck"), like=_fresh(init_fn), step=4)


def _unflatten(flat):
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def test_npz_loads_into_the_jax_encoder(tmp_path):
    _, _, state = _trained()
    p = tmp_path / "params.npz"
    ckpt.save_params_npz(state, str(p))
    loaded = dict(np.load(p))
    cfg_j = jenc.EncoderConfig.tiny(out_dim=16, dtype=np.float32,
                                    flash_min_seq=16)
    ids = np.ones((1, 8), np.int32)
    want_keys = {"/".join(getattr(k, "key", str(k)) for k in path)
                 for path, _ in jax.tree_util.tree_leaves_with_path(
                     jenc.Encoder(cfg_j).init(jax.random.PRNGKey(0), ids,
                                              np.ones((1, 8), bool)))}
    assert set(loaded) == want_keys
    assert loaded["params/layer_0/attn/qkv/kernel"].shape == \
        (CFG.hidden, 3 * CFG.hidden)                       # (in, out)
    b = _batch(11, s=24)
    want = np.asarray(jenc.Encoder(cfg_j).apply(
        _unflatten(loaded), b["ids_a"], b["mask_a"]))
    with torch.no_grad():
        got = state.module(torch.from_numpy(b["ids_a"]).long(),
                           torch.from_numpy(b["mask_a"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_trained_params_serve_through_embedding_model(tmp_path):
    """The trainer's parameters through EmbeddingModel, by params= and
    by a safetensors file, give the trainer module's embeddings."""
    _, _, state = _trained()
    b = _batch(12, s=32)
    lens = b["mask_a"].sum(axis=1)
    with torch.no_grad():
        want = state.module(torch.from_numpy(b["ids_a"]).long(),
                            torch.from_numpy(b["mask_a"])).numpy()
    path = str(tmp_path / "trained.safetensors")
    tenc.export_safetensors_params(state.module.state_dict(), CFG, path)
    for kw in ({"params": state.module.state_dict()}, {"weights": path}):
        model = tenc.EmbeddingModel(CFG, device="cpu", buckets=(32,), **kw)
        got = model.encode_ids(b["ids_a"], lens)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _sharded(seed=7):
    sinit = make_sharded_train_step(CFG, make_mesh(dp=2, tp=2,
                                                   device="cpu"))
    b = _batch()
    return sinit(torch.Generator().manual_seed(seed), b["ids_a"],
                 b["mask_a"])


def _same_moments(single, sharded):
    """The single-card optimizer's moments equal the sharded one's,
    gathered, exactly."""
    full = ckpt._gather_optimizer(sharded.module, sharded.optimizer)
    params = list(single.module.parameters())
    assert len(full["state"]) == len(params)
    for j, p in enumerate(params):
        for k, v in single.optimizer.state[p].items():
            assert torch.equal(v, full["state"][j][k]), (j, k)


@pytest.mark.parametrize("direction", ["single_to_sharded",
                                       "sharded_to_single"])
def test_restore_across_the_mesh(tmp_path, direction):
    """A single-card checkpoint restored onto the dp = 2 x tp = 2
    trainer, and a sharded one onto the single-card trainer: weights and
    AdamW moments exact (the qkv regroup undone), the step kept, and two
    more steps give the uninterrupted trainer's losses."""
    path = str(tmp_path / "ck")
    init_fn, step_fn = make_train_step(CFG, device="cpu")
    if direction == "single_to_sharded":
        _, _, src = _trained()
        src_step = step_fn
        like, dst_step = _sharded()
    else:
        src, src_step = _sharded(seed=0)
        for i in range(2):
            src, _ = src_step(src, _batch(i))
        like, dst_step = _fresh(init_fn), step_fn
    ckpt.save(src, path)
    got = ckpt.restore(path, like=like)
    assert got.step == src.step == 2
    single, sharded = (src, got) if direction == "single_to_sharded" \
        else (got, src)
    full = sharded.module.full_state_dict()
    for name, p in single.module.state_dict().items():
        assert torch.equal(full[name], p), name
    _same_moments(single, sharded)
    for i in (2, 3):
        src, loss_a = src_step(src, _batch(i))
        got, loss_b = dst_step(got, _batch(i))
        assert float(loss_b) == pytest.approx(float(loss_a), abs=1e-5)
    assert got.step == 4
    if direction == "single_to_sharded":
        assert got.module.replica_mismatches() == []


def test_sharded_npz_is_the_whole_model(tmp_path):
    """save_params_npz of a sharded trainer writes the gathered model."""
    state, _ = _sharded()
    p = tmp_path / "params.npz"
    ckpt.save_params_npz(state, str(p))
    loaded = dict(np.load(p))
    whole = state.module.full_state_dict()
    np.testing.assert_array_equal(
        loaded["params/layer_0/attn/qkv/kernel"],
        whole["layer_0.attn.qkv.weight"].T.numpy())
    assert loaded["params/tok_emb/embedding"].shape == (CFG.vocab_size,
                                                        CFG.hidden)
