"""The torch port's parallel layer (parallel/{mesh,multihost,
sharded_search}.py) on the CPU, against the JAX package's on its virtual
8-device CPU mesh:

  - make_mesh's shapes and errors (tests/test_parallel.py's cases), the
    CPU shards, a repeated device list, and a CUDA mesh refused on a
    host with fewer cards than its axes;
  - the split rules: for every leaf of a tiny Decoder, MoE decoder,
    Q8_0 and per-channel int8 decoder and encoder tree, the port's spec
    of the bridged state_dict entry is JAX's decoder_param_pspec /
    param_pspec mapped through the (in, out) -> (out, in) transpose, and
    the REAL per-shard shapes of shard_state_dict at tp = 2 (ep = 2 for
    the experts) are the JAX shard's, transposed;
  - the collectives: the reduction in shard order, one result per device;
  - sharded_topk against JAX's sharded_topk at dp = 2 and 4, with and
    without a mask, k on both sides of FUSED_K_MAX: the same rows,
    scores within 1e-6; the merge keeps the one-shard order (ties to
    the lower row, (NEG_INF, -1) filler);
  - init_distributed is a no-op in one process; PodSearch in one
    process over a dp = 2 CPU mesh, epoch-diffed; and two processes
    joined over gloo, each with its own store, whose merged hits equal
    one search over the concatenated lanes."""
import json
import os
import socket
import subprocess
import sys
import textwrap
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
jdec = pytest.importorskip("libsplinter_tpu.models.decoder")
jenc = pytest.importorskip("libsplinter_tpu.models.encoder")
jmoe = pytest.importorskip("libsplinter_tpu.models.moe")
jq = pytest.importorskip("libsplinter_tpu.models.quant")
jmesh = pytest.importorskip("libsplinter_tpu.parallel.mesh")
jserve = pytest.importorskip("libsplinter_tpu.parallel.serve")
jsearch = pytest.importorskip("libsplinter_tpu.parallel.sharded_search")

from libsplinter_tpu_torch import Store  # noqa: E402
from libsplinter_tpu_torch.models.encoder import \
    state_dict_from_flax  # noqa: E402
from libsplinter_tpu_torch.parallel import (  # noqa: E402
    PodSearch, all_gather, all_reduce_sum, decoder_param_pspec, make_mesh,
    multihost, param_pspec, shard_state_dict, shard_vectors, sharded_topk)
from libsplinter_tpu_torch.parallel.mesh import shard_tensor  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


# -- the mesh ---------------------------------------------------------------

def test_make_mesh_shapes():
    """tests/test_parallel.py's cases over eight CPU shards."""
    cpu8 = ["cpu"] * 8
    m = make_mesh(dp=4, tp=2, devices=cpu8)
    assert m.shape == {"dp": 4, "tp": 2, "sp": 1, "ep": 1, "pp": 1}
    m2 = make_mesh(tp=2, devices=cpu8)          # dp inferred = 4
    assert m2.shape["dp"] == 4
    m3 = make_mesh(tp=2, ep=2, devices=cpu8)    # dp inferred = 2
    assert m3.shape == {"dp": 2, "tp": 2, "sp": 1, "ep": 2, "pp": 1}
    with pytest.raises(ValueError, match=r"dp\*tp\*sp\*ep\*pp=9 != "
                                         r"#devices=8"):
        make_mesh(dp=3, tp=3, devices=cpu8)
    with pytest.raises(ValueError, match="8 devices not divisible by "
                                         r"tp\*sp\*ep\*pp=3"):
        make_mesh(tp=3, devices=cpu8)
    # the JAX package raises on the same shapes
    with pytest.raises(ValueError):
        jmesh.make_mesh(dp=3, tp=3)


def test_cpu_shards_and_serving_grid():
    """device="cpu" takes as many CPU shards as the axes need (dp = 1
    when not given); the serving grid is tp-major over tp x ep."""
    m = make_mesh(tp=2, ep=2, device="cpu")
    assert m.shape == {"dp": 1, "tp": 2, "sp": 1, "ep": 2, "pp": 1}
    assert m.size == 4
    assert m.serving_devices() == [torch.device("cpu")] * 4
    assert len(make_mesh(dp=4, device="cpu").axis_devices("dp")) == 4


def test_cuda_mesh_refused_without_the_cards(monkeypatch):
    """On "cuda" the visible cards are the devices: one card cannot hold
    a tp = 2 mesh, and a host without CUDA cannot hold any."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 devices not divisible"):
        make_mesh(tp=2)
    assert make_mesh().shape["dp"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(tp=2)


def test_collectives_sum_in_shard_order():
    parts = [torch.full((3,), float(i + 1)) for i in range(4)]
    want = torch.full((3,), 10.0)
    out = all_reduce_sum([p.clone() for p in parts])
    assert len(out) == 4 and all(torch.equal(o, want) for o in out)
    assert all(o is out[0] for o in out)        # one device, one result
    g = all_gather(parts, dim=0)
    assert torch.equal(g[0], torch.cat(parts)) and len(g) == 4


# -- the split rules against the JAX package's --------------------------------

def _jax_decoder(cfg, moe=False):
    module = (jmoe.MoeDecoder if moe else jdec.Decoder)(cfg)
    return module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                       jdec.init_cache(cfg, 1), jnp.int32(0))


def _jax_encoder(cfg):
    ids = np.ones((1, 8), np.int32)
    return jenc.Encoder(cfg).init(jax.random.PRNGKey(0), ids,
                                  np.ones((1, 8), bool))


def _leaves(tree):
    """(JAX path, port state_dict name, JAX leaf, transposed?) for every
    leaf, named as models/encoder.state_dict_from_flax names them."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", str(p)) for p in path]
        if keys[0] == "params":
            keys = keys[1:]
        leaf_name, parent = keys[-1], keys[:-1]
        node = tree["params"]
        for k in parent:
            node = node[k]
        quant = any(k in node and not isinstance(node[k], dict)
                    for k in ("q", "wq"))
        kernel = leaf_name == "kernel" and not quant
        if not quant and leaf_name in ("kernel", "embedding", "scale"):
            leaf_name = "weight"
        out.append((path, ".".join(parent + [leaf_name]), np.asarray(leaf),
                    kernel))
    return out


def _norm(spec, ndim) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return () if all(a is None for a in spec) else spec


def _trees():
    dcfg = jdec.DecoderConfig.tiny(dtype=jnp.float32)
    mcfg = jmoe.MoeDecoderConfig.tiny(dtype=jnp.float32)
    ecfg = jenc.EncoderConfig.tiny(dtype=jnp.float32)
    dec = _jax_decoder(dcfg)
    moe = _jax_decoder(mcfg, moe=True)
    enc = _jax_encoder(ecfg)
    return {
        "decoder": (dec, jserve.decoder_param_pspec, decoder_param_pspec),
        "moe": (moe, jserve.decoder_param_pspec, decoder_param_pspec),
        "q8_0": (jq.quantize_decoder_params(dec, mode="block"),
                 jserve.decoder_param_pspec, decoder_param_pspec),
        "channel": (jq.quantize_decoder_params(dec, mode="channel"),
                    jserve.decoder_param_pspec, decoder_param_pspec),
        "moe_q8_0": (jq.quantize_decoder_params(moe),
                     jserve.decoder_param_pspec, decoder_param_pspec),
        "encoder": (enc, jmesh.param_pspec, param_pspec),
        "encoder_channel": (jq.quantize_encoder_params(enc),
                            jmesh.param_pspec, param_pspec),
    }


@pytest.mark.parametrize("tree", ["decoder", "moe", "q8_0", "channel",
                                  "moe_q8_0", "encoder", "encoder_channel"])
def test_split_rules_match_jax(tree):
    """Every leaf: the port's spec is JAX's through the transpose, and
    the per-shard shapes at tp = 2 x ep = 2 are the JAX shard's."""
    params, jax_rule, port_rule = _trees()[tree]
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params))
    leaves = _leaves(params)
    assert sorted(name for _, name, _, _ in leaves) == sorted(sd)
    sizes = {"tp": 2, "ep": 2}
    split = 0
    for path, name, leaf, kernel in leaves:
        jspec = _norm(jax_rule(path, leaf), leaf.ndim)
        want = tuple(reversed(jspec)) if kernel and jspec else jspec
        got = _norm(port_rule(name, sd[name]), leaf.ndim)
        assert got == want, (name, got, jspec)
        # the real split: JAX's shard shape, transposed for kernels
        jshape = [n // sizes[a] if a else n for n, a in
                  zip(leaf.shape, jspec or (None,) * leaf.ndim)]
        if kernel:
            jshape = jshape[::-1]
        for ti in range(2):
            for ei in range(2):
                part = shard_tensor(name, sd[name], port_rule(name, sd[name]),
                                    {"tp": (ti, 2), "ep": (ei, 2)})
                assert list(part.shape) == jshape, name
        split += bool(jspec)
    assert split >= 4


def test_shard_params_per_serving_slot():
    """shard_params splits per (tp, ep) slot, tp-major, by the encoder's
    rules unless given the decoder's; the batch and replica specs."""
    from libsplinter_tpu_torch.parallel import (batch_sharding,
                                                param_shardings, replicated,
                                                shard_params)
    from libsplinter_tpu_torch.parallel.serve import shard_decoder_params
    mesh = make_mesh(tp=2, ep=2, device="cpu")
    sd = {"layer_0.attn.qkv.weight": torch.arange(32.0).reshape(8, 4),
          "layer_0.moe.up_experts": torch.zeros(4, 2, 2)}
    parts = shard_params(sd, mesh)
    assert len(parts) == 4
    assert torch.equal(parts[2]["layer_0.attn.qkv.weight"],
                       sd["layer_0.attn.qkv.weight"][4:])     # tp = 1
    assert parts[1]["layer_0.moe.up_experts"].shape == (4, 2, 2)
    dec = shard_decoder_params(sd, mesh)
    assert dec[1]["layer_0.moe.up_experts"].shape == (2, 2, 2)  # ep = 1
    assert param_shardings(sd, mesh)["layer_0.attn.qkv.weight"] == \
        ("tp", None)
    assert batch_sharding(mesh) == ("dp",) and replicated(mesh) == ()


def test_shard_state_dict_blocks_and_refusals():
    """The shards' column blocks concatenate back to the whole weight;
    a dimension the axis does not divide is refused, never padded (a
    row-parallel Q8_0 weight splits whole 32-wide input blocks)."""
    w = torch.arange(24.0).reshape(6, 4)
    sd = {"layer_0.attn.q.weight": w, "layer_0.attn.out.weight": w}
    parts = [shard_state_dict(sd, {"tp": (t, 2)}) for t in range(2)]
    assert torch.equal(torch.cat([p["layer_0.attn.q.weight"]
                                  for p in parts], 0), w)
    assert torch.equal(torch.cat([p["layer_0.attn.out.weight"]
                                  for p in parts], 1), w)
    q = torch.zeros((3, 32, 8), dtype=torch.int8)    # 3 input blocks
    with pytest.raises(ValueError, match="does not split over tp=2"):
        shard_state_dict({"layer_0.down.q": q}, {"tp": (0, 2)})


# -- sharded top-k against the JAX package's ---------------------------------

@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_sharded_topk_matches_jax(dp, k, masked):
    rng = np.random.default_rng(dp * 1000 + k)
    vectors = rng.normal(size=(1024, 64)).astype(np.float32)
    query = rng.normal(size=64).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random(1024) > 0.3).astype(np.float32)
    jm = jmesh.make_mesh(dp=dp, devices=jax.devices()[:dp])
    js, ji = jsearch.sharded_topk(jm, jsearch.shard_vectors(jm, vectors),
                                  query, k, mask=mask)
    mesh = make_mesh(dp=dp, device="cpu")
    s, i = sharded_topk(mesh, shard_vectors(mesh, vectors), query, k,
                        mask=mask)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(s, np.asarray(js), rtol=0, atol=1e-6)
    # and the dense answer
    vn = vectors / np.linalg.norm(vectors, axis=1, keepdims=True)
    sc = vn @ (query / np.linalg.norm(query))
    if mask is not None:
        sc = np.where(mask > 0, sc, -np.inf)
    np.testing.assert_array_equal(i, np.argsort(-sc, kind="stable")[:k])


def test_sharded_topk_merge_keeps_the_one_shard_order():
    """Ties go to the lower row across shards, the filler past the
    candidates is (NEG_INF, -1) as one shard's K2 plain version gives,
    and a batch of queries merges row by row."""
    from libsplinter_tpu_torch.ops.similarity import _fused_topk_plain
    v = np.zeros((16, 4), np.float32)
    v[[1, 5, 9, 14], 0] = 1.0              # four tied rows
    v[[3, 12], 1] = 1.0
    mask = np.ones(16, np.float32)
    mask[3] = 0.0
    q = np.array([[1, 0, 0, 0], [0, 1, 0, 0]], np.float32)
    mesh = make_mesh(dp=4, device="cpu")
    s, i = sharded_topk(mesh, v, q, 8, mask=mask)
    ws, wi = _fused_topk_plain(torch.from_numpy(v), torch.from_numpy(q), 8,
                               torch.from_numpy(mask))
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_array_equal(s, ws.numpy())
    assert i[0, :4].tolist() == [1, 5, 9, 14] and i[1, 0] == 12
    assert (i[:, 6:] == -1).all()


# -- multi-process --------------------------------------------------------------

def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed() is False
    assert multihost.process_span() == (0, 1)
    assert multihost.host_store_name("/spt") == "/spt"
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(num_processes=2, process_id=0)


def _lane(seed: int, n: int = 40, d: int = 16):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _fill(name: str, host: int, vecs: np.ndarray) -> Store:
    st = Store.create(name, nslots=64, max_val=64, vec_dim=vecs.shape[1])
    for j, vec in enumerate(vecs):
        key = f"h{host}/k{j}"
        st.set(key, "x")
        st.vec_set(key, vec)
    return st


def test_pod_search_single_process_epoch_diffed():
    """One process: the lane split over a dp = 2 CPU mesh, hits equal
    the dense top-k; a write re-stages that one row, not the lane."""
    name = f"/spt-tpod-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    vecs = _lane(5)
    st = _fill(name, 0, vecs)
    try:
        pod = PodSearch(st, make_mesh(dp=2, device="cpu"))
        q = vecs[7] + 0.01
        hits = pod.search(q, 5)
        assert pod.full_stages == 1 and pod.tile == 32
        rows = [st.find_index(f"h0/k{j}") for j in range(len(vecs))]
        vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        want = np.argsort(-(vn @ (q / np.linalg.norm(q))))[:5]
        assert [h["key"] for h in hits] == [f"h0/k{j}" for j in want]
        assert [h["slot"] for h in hits] == [rows[j] for j in want]
        st.vec_set("h0/k3", q)
        hits = pod.search(q, 1)
        assert hits[0]["key"] == "h0/k3"
        assert pod.full_stages == 1 and pod.rows_staged == 1
        masked = np.ones(st.nslots, np.float32)
        masked[rows[3]] = 0.0
        assert pod.search(q, 1, mask=masked)[0]["key"] == f"h0/k{want[0]}"
    finally:
        st.close()
        Store.unlink(name)


_WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    sys.path.insert(0, sys.argv[1])
    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.parallel import PodSearch, make_mesh
    rank = int(os.environ["RANK"])
    name, n, d = sys.argv[2] + str(rank), 40, 16
    vecs = np.random.default_rng(100 + rank).normal(size=(n, d)).astype(
        np.float32)
    st = Store.create(name, nslots=64, max_val=64, vec_dim=d)
    try:
        for j, v in enumerate(vecs):
            st.set(f"h{rank}/k{j}", "x")
            st.vec_set(f"h{rank}/k{j}", v)
        pod = PodSearch(st, make_mesh(dp=2, device="cpu"))
        q = np.asarray(json.loads(sys.argv[3]), np.float32)
        hits = pod.search(q, 12)
        st.vec_set(f"h{rank}/k0", q)          # one dirty row per host
        again = pod.search(q, 3)
        slots = [st.find_index(f"h{rank}/k{j}") for j in range(n)]
        print(json.dumps({"hits": hits, "again": again, "slots": slots,
                          "full": pod.full_stages,
                          "staged": pod.rows_staged,
                          "span": [pod.pid, pod.pcount]}))
    finally:
        st.close()
        Store.unlink(name)
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_pod_search_two_processes_over_gloo():
    """Two processes, each with its own store, joined by init_distributed
    from torch's standard environment: the merged hits equal one search
    over the two lanes concatenated (host h's slot s is global row
    h * local_pad + s), and an incremental refresh stays incremental."""
    q = _lane(7, n=1)[0]
    port = _free_port()
    base = f"/spt-tgloo-{os.getpid()}-{uuid.uuid4().hex[:6]}-"
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(ROOT), base,
             json.dumps(q.tolist())], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=55)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [o["span"] for o in outs] == [[0, 2], [1, 2]]
    assert outs[0]["hits"] == outs[1]["hits"]
    # the reference: one lane of both hosts' rows at their global rows
    lanes = [np.random.default_rng(100 + r).normal(size=(40, 16)).astype(
        np.float32) for r in range(2)]
    local_pad = 64
    glob = np.zeros((2 * local_pad, 16), np.float32)
    keys = {}
    for r, lane in enumerate(lanes):
        for j, slot in enumerate(outs[r]["slots"]):
            glob[r * local_pad + slot] = lane[j]
            keys[r * local_pad + slot] = f"h{r}/k{j}"
    mesh = make_mesh(dp=2, device="cpu")
    s, i = sharded_topk(mesh, glob, q, 12)
    hits = outs[0]["hits"]
    assert [h["host"] * local_pad + h["slot"] for h in hits] == i.tolist()
    assert [h["key"] for h in hits] == [keys[g] for g in i]
    np.testing.assert_allclose([h["similarity"] for h in hits], s,
                               rtol=0, atol=1e-6)
    again = outs[0]["again"]
    assert outs[0]["again"] == outs[1]["again"]
    assert {h["key"] for h in again[:2]} == {"h0/k0", "h1/k0"}
    assert [o["full"] for o in outs] == [1, 1]
    assert [o["staged"] for o in outs] == [1, 1]
