"""The plain references against the port at small sizes on the CPU in
float32: the encoder of both families and the tokenizer."""
import numpy as np
import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import encoder as ref_enc
from benchmark.reference import tokenizer as ref_tok

import cells


def _port_model(spec, params):
    from libsplinter_tpu_torch.models import EmbeddingModel, EncoderConfig

    cfg = EncoderConfig(vocab_size=spec["vocab"], hidden=spec["hidden"],
                        layers=spec["layers"], heads=spec["heads"],
                        mlp_dim=spec["mlp"], max_len=spec["max_len"],
                        variant="nomic" if spec["family"] == "nomic_bert"
                        else "bert",
                        layer_norm_eps=spec["eps"], out_dim=spec["out_dim"],
                        dtype=torch.float32)
    return EmbeddingModel(cfg, params={k: v.float() for k, v in params.items()},
                          device="cpu")


@pytest.mark.parametrize("name", ["nomic-v1.5-ingest-docs",
                                  "e5-large-v2-ingest-chunks"])
def test_reference_encoder_matches_the_port_in_f32(name):
    cell = cells.tiny_ingest(name)
    spec = cell.counter.spec(cell.config)
    params = weights.make_params(spec, 2**31 + 3, torch.device("cpu"))
    model = _port_model(spec, params)
    p = weights.reference_params(params, spec, torch.device("cpu"))
    rng = np.random.default_rng(0)
    for n in (5, 17, 64, 100):
        ids = np.concatenate([[1], rng.integers(4, spec["vocab"], n - 2), [2]])
        b = model.bucket_for(n)
        pad = np.zeros((1, b), np.int32)
        pad[0, :n] = ids
        got = model.encode_ids(pad, np.array([n], np.int32))[0]
        want = ref_enc.embed(spec, p, torch.from_numpy(ids)).numpy()
        assert np.abs(got - want).max() < 2e-5


def test_nomic_reference_has_no_projection_biases():
    cell = cells.tiny_ingest("nomic-v1.5-ingest-docs")
    spec = cell.counter.spec(cell.config)
    p = weights.reference_params(
        weights.make_params(spec, 1, torch.device("cpu")), spec,
        torch.device("cpu"))
    assert not [k for k in p if k.endswith(".bias") and "ln_" not in k]


def test_reference_tokenizer_matches_the_ports():
    from libsplinter_tpu_torch.models import HashTokenizer

    tok = HashTokenizer(30528)
    for text in ("the quick brown fox", "ab cd, ef! gh", "x " * 300):
        want = tok.encode(text, max_len=128)
        got = ref_tok.encode(text, 30528, 128)
        assert list(got) == list(want)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(1))
    e8 = (ref_enc.fp8_e4m3(x) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 4 * e16
