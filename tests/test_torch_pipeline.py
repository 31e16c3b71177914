"""The torch port's GPipe pipeline encoder (parallel/pipeline.py) on the
CPU, mirroring tests/test_pipeline.py: the pipelined forward equals the
dense Encoder forward for every (stages, microbatches) case and the
JAX package's pipeline_encode on the same weights; it is
differentiable, with the dense model's gradients; stack_layer_params
equals the JAX package's, transposed; the guards; each stage's layers
sit on its own device.

Weights come from the JAX init through params_from_jax, the batch from
seeded numpy (ragged lengths).  Tolerances, as the JAX test holds its
own: embeddings 2e-5; gradients rtol 1e-3, atol 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jmesh = pytest.importorskip("libsplinter_tpu.parallel.mesh")
jpipe = pytest.importorskip("libsplinter_tpu.parallel.pipeline")

from libsplinter_tpu_torch.models import encoder as tenc  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_pipeline_encode_fn, pipeline_encode,
    stack_layer_params)
from libsplinter_tpu_torch.parallel.pipeline import stage_params  # noqa

CFG_J = jenc.EncoderConfig.tiny(out_dim=16, layers=4, dtype=jnp.float32)
CFG = tenc.EncoderConfig.tiny(out_dim=16, layers=4, dtype=torch.float32)


def _mesh(pp):
    return make_mesh(pp=pp, device="cpu")


@pytest.fixture(scope="module")
def setup():
    b, s = 8, 16
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG.vocab_size, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    mask[1, 10:] = False                      # ragged lengths
    mask[5, 4:] = False
    params = jenc.Encoder(CFG_J).init(jax.random.PRNGKey(0), ids, mask)
    sd = tenc.params_from_jax(params, CFG)
    dense = tenc.Encoder(CFG)
    dense.load_state_dict(sd)
    with torch.no_grad():
        want = dense(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    return params, sd, ids, mask, want.numpy()


@pytest.mark.parametrize("stages,micro", [(2, 2), (2, 4), (4, 2),
                                          (4, 8), (1, 1)])
def test_matches_dense_forward(setup, stages, micro):
    params, sd, ids, mask, dense = setup
    with torch.no_grad():
        got = pipeline_encode(CFG, _mesh(stages), sd, ids, mask,
                              microbatches=micro)
    np.testing.assert_allclose(got.numpy(), dense, rtol=2e-5, atol=2e-5)
    jgot = jpipe.make_pipeline_encode_fn(     # jitted: one compile
        CFG_J, jmesh.make_mesh(pp=stages), params,
        microbatches=micro)(ids, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=2e-5,
                               atol=2e-5)


def test_staged_and_differentiable(setup):
    """make_pipeline_encode_fn stages once; the gradients of a seeded
    random projection of the embeddings through the pipeline equal the
    dense model's for every parameter."""
    _, sd, ids, mask, dense = setup
    mesh = _mesh(2)
    fn = make_pipeline_encode_fn(CFG, mesh, sd, microbatches=4)
    with torch.no_grad():
        got = fn(ids, mask)
    np.testing.assert_allclose(got.numpy(), dense, rtol=2e-5, atol=2e-5)

    w = torch.from_numpy(np.random.default_rng(3).standard_normal(
        dense.shape).astype(np.float32))
    leaves = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
    (pipeline_encode(CFG, mesh, leaves, ids, mask, microbatches=4)
     * w).sum().backward()
    model = tenc.Encoder(CFG)
    model.load_state_dict(sd)
    (model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
     * w).sum().backward()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(leaves[name].grad.numpy(),
                                   p.grad.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=name)
    assert any(float(p.grad.abs().max()) > 1e-3
               for p in model.parameters())


def test_stack_layer_params_matches_jax(setup):
    """The port's (L, out, in) stacks are the JAX package's (L, in, out)
    ones transposed; vectors stack alike."""
    params, sd, *_ = setup
    got = stack_layer_params(sd, CFG)
    want = jpipe.stack_layer_params(params, CFG_J)
    assert got["attn.qkv.weight"].shape == (CFG.layers, 3 * CFG.hidden,
                                            CFG.hidden)
    flat = {".".join(getattr(k, "key", str(k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    assert len(flat) == len(got)
    for key, arr in flat.items():
        mod, leaf = key.rsplit(".", 1)
        name = mod + "." + {"kernel": "weight", "scale": "weight"}.get(
            leaf, leaf)
        t = got[name].numpy()
        if leaf == "kernel":
            t = t.transpose(0, 2, 1)
        np.testing.assert_array_equal(t, arr, err_msg=key)


def test_guards(setup):
    _, sd, ids, mask, _ = setup
    with pytest.raises(ValueError, match="divide"):       # 4 layers / 8
        pipeline_encode(CFG, _mesh(8), sd, ids, mask, microbatches=2)
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_encode(CFG, _mesh(2), sd, ids, mask, microbatches=3)
    with pytest.raises(ValueError, match="nomic"):
        pipeline_encode(dataclasses.replace(CFG, variant="bert"), _mesh(2),
                        sd, ids, mask, microbatches=2)


def test_ring_axis_rejected(setup):
    _, sd, ids, mask, _ = setup
    rcfg = dataclasses.replace(CFG, ring_axis="sp")
    with pytest.raises(ValueError, match="ring_axis"):
        pipeline_encode(rcfg, _mesh(2), sd, ids, mask, microbatches=2)


def test_staged_params_on_their_own_devices(setup):
    """stage_params gives each stage only its own layers, on that
    stage's device, and tok_emb / ln_emb on the first stage's device
    only (the one that reads them)."""
    _, sd, *_ = setup
    devs = ["meta", "cpu", "meta", "cpu"]      # four distinct placements
    mesh = make_mesh(pp=4, devices=devs)
    outer, staged = stage_params(sd, CFG, mesh)
    assert len(staged) == 4
    for s, dev in enumerate(devs):
        assert staged[s]["attn.qkv.weight"].shape[0] == CFG.layers // 4
        assert {t.device.type for t in staged[s].values()} == {dev}
    assert set(outer) == {"tok_emb.weight", "ln_emb.weight", "ln_emb.bias"}
    assert {t.device.type for t in outer.values()} == {devs[0]}
    assert torch.equal(staged[1]["attn.qkv.weight"][0],
                       sd["layer_1.attn.qkv.weight"])
    assert torch.equal(staged[3]["attn.qkv.weight"][0],
                       sd["layer_3.attn.qkv.weight"])
