"""The torch port's MoE decoder family (models/moe.py) against the JAX
package's, on the CPU, f32, on shared seeded weights bridged through
params_from_jax (layer_<i>/moe/{router, gate_experts, up_experts,
down_experts} leaf by leaf):

  - MoeMlp within 1e-5 of the flax module; top-1 routing is the argmax
    expert's FFN alone and top-2 gates renormalise over the pair
    (tests/test_moe.py's numpy references), the router probabilities
    checked free of ties at the top-k boundary so torch.topk and
    jax.lax.top_k pick the same experts;
  - the MoE decoder's prefill and decode logits within 1e-5 of the JAX
    MoE CompletionModel, prefill + decode equal to one full forward,
    greedy moe_completion_model tokens equal to the JAX package's, the
    paged lane's greedy tokens equal to the dense lane's;
  - int8 experts (quantized=True): the state_dict quantizer's expert
    leaves equal the JAX walker's, logits within 1e-5 of the JAX
    quantized MoE, resident expert bytes 0.5625 x bf16;
  - expert parallelism at ep = 2 x tp = 2 on four CPU shards: the
    experts split on ep, greedy tokens (dense and paged lanes, float
    and int8 experts) equal the unmeshed model's, and an expert count
    the ep axis does not divide is refused with the JAX package's text;
    the completer serves a MoE model on the continuous lane."""
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jmoe = pytest.importorskip("libsplinter_tpu.models.moe")
jq = pytest.importorskip("libsplinter_tpu.models.quant")

from libsplinter_tpu_torch import Store  # noqa: E402
from libsplinter_tpu_torch.engine import protocol as P  # noqa: E402
from libsplinter_tpu_torch.engine.completer import Completer  # noqa: E402
from libsplinter_tpu_torch.models import decoder as tdec  # noqa: E402
from libsplinter_tpu_torch.models import moe as tmoe  # noqa: E402
from libsplinter_tpu_torch.models import quant as tq  # noqa: E402

ATOL = 1e-5
PROMPT = np.array([5, 9, 2, 7, 1, 3, 11], np.int32)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + rng.normal(scale=0.05, size=x.shape).astype(np.float32), tree)


def _configs(**kw):
    return (jmoe.MoeDecoderConfig.tiny(dtype=jnp.float32, **kw),
            tmoe.MoeDecoderConfig.tiny(dtype=torch.float32, **kw))


def _mlp_pair(seed, **kw):
    cfg_j, cfg_t = _configs(**kw)
    x = np.random.default_rng(seed).normal(size=(2, 3, cfg_j.hidden)) \
        .astype(np.float32)
    params = _perturb(jmoe.MoeMlp(cfg_j).init(jax.random.PRNGKey(seed), x),
                      seed)
    mlp = tmoe.MoeMlp(cfg_t)
    mlp.load_state_dict(tdec.params_from_jax(params, cfg_t))
    return cfg_j, params, mlp, x


def _assert_no_routing_tie(x, router_kernel, k):
    """The k-th and (k+1)-th router probabilities of every token differ:
    the two packages' top-k cannot pick different experts."""
    logits = x @ router_kernel
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[..., ::-1]
    if k < p.shape[-1]:
        assert (p[..., k - 1] - p[..., k]).min() > 1e-4


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_moe_mlp_matches_jax(top_k):
    cfg_j, params, mlp, x = _mlp_pair(0, top_k=top_k)
    _assert_no_routing_tie(x, params["params"]["router"]["kernel"], top_k)
    want = np.asarray(jmoe.MoeMlp(cfg_j).apply(params, x))
    got = mlp(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert mlp.router.weight.dtype == torch.float32


def _ffn(vec, wg, wu, wd, e):
    h = vec @ wg[e]
    u = vec @ wu[e]
    return (h / (1 + np.exp(-h)) * u) @ wd[e]


@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_is_the_selected_experts_renormalised(top_k):
    """top_k = 1: the argmax expert's FFN alone; top_k = 2: w1 FFN(e1) +
    w2 FFN(e2) with the two routing probabilities renormalised to sum
    to 1 (Mixtral convention), not the raw softmax masses."""
    cfg_j, params, mlp, x = _mlp_pair(3, top_k=top_k)
    p = params["params"]
    _assert_no_routing_tie(x, p["router"]["kernel"], top_k)
    out = mlp(torch.from_numpy(x)).detach().numpy()
    logits = x @ p["router"]["kernel"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    wg, wu, wd = (p[f"{n}_experts"] for n in ("gate", "up", "down"))
    for b in range(2):
        for s in range(3):
            top = np.argsort(-probs[b, s])[:top_k]
            w = probs[b, s, top] / probs[b, s, top].sum()
            want = sum(w[i] * _ffn(x[b, s], wg, wu, wd, top[i])
                       for i in range(top_k))
            np.testing.assert_allclose(out[b, s], want, rtol=1e-5,
                                       atol=ATOL)


def _model_pair(quantized=False, seed=1):
    cfg_j, cfg_t = _configs(quantized=quantized)
    fcfg = jmoe.MoeDecoderConfig.tiny(dtype=jnp.float32)
    params = _perturb(jmoe.MoeDecoder(fcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jdec.init_cache(fcfg, 1), jnp.int32(0)), seed)
    jparams = jq.quantize_decoder_params(params) if quantized else params
    jm = jmoe.moe_completion_model(cfg_j, params=jparams, buckets=(16,),
                                   temp=0.0)
    tm = tmoe.moe_completion_model(
        cfg_t, params=tdec.params_from_jax(params, cfg_t), buckets=(16,),
        temp=0.0, device="cpu")
    return jm, tm, params


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-experts"])
def test_decoder_logits_and_greedy_tokens_equal_jax(quantized):
    """Prefill and decode logits within 1e-5 of the JAX MoE model (the
    int8 case quantizes the float state_dict at load, the JAX case
    through its walker), and greedy generate_tokens equal."""
    jm, tm, _ = _model_pair(quantized)
    np.testing.assert_allclose(tm.prefill(PROMPT), jm.prefill(PROMPT),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.decode_one(4), jm.decode_one(4), rtol=0,
                               atol=ATOL)
    tm.reset()
    jm.reset()
    want = [int(t) for t in jm.generate_tokens(PROMPT, 12, chunk=4)]
    got = [int(t) for t in tm.generate_tokens(PROMPT, 12, chunk=4)]
    tm.reset()
    assert got == want
    layer = tm.module.layer_0
    assert isinstance(layer.moe, tmoe.MoeMlp) and not hasattr(layer, "gate")
    if quantized:
        assert layer.moe.gate_experts_q.dtype == torch.int8


def test_prefill_then_decode_matches_full_forward():
    """KV-cache decode equals one full forward on the same ids (the
    Decoder family's invariant holds for the MoE family)."""
    _, tm, _ = _model_pair()
    ids = torch.from_numpy(PROMPT[:6].astype(np.int64))[None]
    with torch.no_grad():
        full = tm.module(ids, tdec.init_cache(tm.cfg, 1), 0)[0]
    np.testing.assert_allclose(tm.prefill(PROMPT[:4]), full[3].numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tm.decode_one(int(PROMPT[4])),
                               full[4].numpy(), rtol=0, atol=1e-4)
    tm.reset()


def test_paged_lane_matches_the_dense_lane():
    """The MoE trunk on the block-paged lane (K5's plain version on the
    CPU): greedy tokens equal the dense lane's."""
    _, tm, _ = _model_pair()
    want = [int(t) for t in tm.generate_tokens(PROMPT, 10, chunk=3)]
    tm.reset()
    cache = tm.init_paged(2, page=8)
    got = [int(np.argmax(tm.paged_prefill_row(cache, PROMPT, 1)))]
    toks = np.array([-1, got[0]])
    for _ in range(3):
        blk = tm.paged_decode_chunk(cache, toks, 3)
        got += [int(t) for t in blk[1]]
        toks = blk[:, -1]
    assert got == want
    cache.reset()
    assert cache.used_pages == 0


def test_expert_quantization_and_resident_bytes():
    """The state_dict quantizer's expert leaves equal the JAX walker's
    (codes int8, scales f32, block geometry in either residency), the
    router stays float, and the resident experts hold 0.5625 x their
    bf16 bytes (1 byte a weight + one f32 scale per 32)."""
    _, tm, params = _model_pair()
    cfg_t = tm.cfg
    for mode in ("block", "channel"):
        sd = tq.quantize_state_dict(tdec.params_from_jax(params, cfg_t),
                                    tq.QUANT_LEAVES, mode=mode)
        want = tdec.params_from_jax(
            jax.tree.map(np.asarray, jq.quantize_decoder_params(
                params, mode=mode)), cfg_t)
        assert sorted(sd) == sorted(want)
        for k in want:
            assert sd[k].dtype == want[k].dtype and torch.equal(
                sd[k], want[k]), k
        assert sd["layer_0.moe.up_experts_q"].dtype == torch.int8
        assert sd["layer_0.moe.router.weight"].dtype == torch.float32
    qcfg = tmoe.MoeDecoderConfig.tiny(dtype=torch.bfloat16, quantized=True)
    qm = tmoe.moe_completion_model(qcfg, params=tdec.params_from_jax(
        params, qcfg), device="cpu")
    held = sum(b.numel() * b.element_size()
               for n, b in qm.module.named_buffers() if "_experts_" in n)
    e, h, m = qcfg.n_experts, qcfg.hidden, qcfg.mlp_dim
    assert held / (qcfg.layers * 3 * e * h * m * 2) == 0.5625


def test_n_experts_must_divide_ep():
    """The counterpart of tests/test_moe.py's refusal: the expert axis
    must split evenly over ep (no padding experts)."""
    from libsplinter_tpu_torch.parallel import make_mesh
    cfg = tmoe.MoeDecoderConfig.tiny(dtype=torch.float32, n_experts=3)
    mesh = make_mesh(dp=2, tp=2, ep=2, device="cpu")
    with pytest.raises(ValueError, match="n_experts=3 must divide"):
        tmoe.moe_completion_model(cfg, mesh)
    with pytest.raises(ValueError, match="n_experts=3 must divide"):
        tmoe.MoeDecoder(cfg, mesh)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "int8-experts"])
def test_expert_parallel_generation_identical(quantized):
    """ep = 2 x tp = 2 sharded MoE serving (four CPU shards) generates
    exactly the unmeshed model's greedy tokens on the dense and the
    paged lane, the stacked experts split on ep and attention on tp."""
    from libsplinter_tpu_torch.parallel import make_mesh
    _, tm, _ = _model_pair(quantized)
    mesh = make_mesh(tp=2, ep=2, device="cpu")
    served = tmoe.moe_completion_model(
        tm.cfg, mesh, params=tm.module.state_dict(), buckets=(16,),
        temp=0.0)
    e = tm.cfg.n_experts
    leaf = "gate_experts_q" if quantized else "gate_experts"
    for s, shard in enumerate(served.module.shards):
        moe = shard.layer_0.moe
        assert getattr(moe, leaf).shape[0] == e // 2
        assert moe.router.weight.shape[0] == e           # routes over all
        want = getattr(tm.module.layer_0.moe, leaf)[(s % 2) * e // 2:
                                                    (s % 2 + 1) * e // 2]
        assert torch.equal(getattr(moe, leaf), want)
        assert shard.layer_0.attn.k.out_features * 2 == \
            tm.module.layer_0.attn.k.out_features
    want = [int(t) for t in tm.generate_tokens(PROMPT, 10, chunk=5)]
    tm.reset()
    got = [int(t) for t in served.generate_tokens(PROMPT, 10, chunk=5)]
    served.reset()
    assert got == want
    cache = served.init_paged(2, page=8)
    paged = [int(np.argmax(served.paged_prefill_row(cache, PROMPT, 0)))]
    blk = served.paged_decode_chunk(cache, np.array([paged[0], -1]), 9)
    assert paged + [int(t) for t in blk[0]] == want


def test_completer_serves_a_moe_model_on_the_continuous_lane():
    """The completion daemon's continuous lane serves the MoE model
    unchanged: three requests through run_continuous, every one READY
    with the greedy bytes of the dense lane, no page leaked."""
    _, tm, _ = _model_pair()
    prompts = {"a": "one expert", "b": "two experts here", "c": "x"}
    outs = []
    for lane in ("dense", "continuous"):
        name = f"/spt-tmoe-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        st = Store.create(name, nslots=64, max_val=2048, vec_dim=0)
        try:
            comp = Completer(st, model=tm, max_new_tokens=10,
                             flush_tokens=4, template="none", batch_cap=2,
                             page_size=8)
            comp.attach()
            for k, text in prompts.items():
                st.set(k, text)
                st.label_or(k, P.LBL_INFER_REQ)
                st.bump(k)
            if lane == "dense":
                assert comp.run_once() == len(prompts)
            else:
                th = threading.Thread(
                    target=comp.run_continuous,
                    kwargs=dict(idle_timeout_ms=20, stop_after=120.0),
                    daemon=True)
                th.start()
                deadline = time.time() + 100
                while time.time() < deadline and not all(
                        st.labels(k) & P.LBL_READY for k in prompts):
                    time.sleep(0.02)
                comp.stop()
                th.join(timeout=30)
                assert comp._paged_cache.used_pages == 0
            assert all(st.labels(k) & P.LBL_READY for k in prompts)
            assert comp.stats.aborts == 0
            outs.append({k: st.get(k) for k in prompts})
        finally:
            st.close()
            Store.unlink(name)
    assert outs[0] == outs[1]
