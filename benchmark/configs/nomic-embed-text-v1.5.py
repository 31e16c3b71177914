"""nomic-embed-text-v1.5 as the benchmark runs it: the shapes the
reference and the weights are built from, and the counts of work and
bytes that the per-layer metrics divide by the chip's peaks."""
from __future__ import annotations


def spec(cfg: dict) -> dict:
    """The shapes as run: the published numbers, with the port's
    departures (cfg["departures"][key]["run"]) in their place."""
    base = cfg["departures"]["rotary_emb_base"]["run"]
    return {"family": "nomic_bert", "hidden": cfg["n_embd"],
            "heads": cfg["n_head"], "mlp": cfg["n_inner"],
            "layers": cfg["n_layer"], "vocab": cfg["vocab_size"],
            "max_len": cfg["n_positions"], "eps": cfg["layer_norm_epsilon"],
            "rotary_base": float(base), "gelu": None,
            "out_dim": cfg["out_dim"], "init_std": cfg["initializer_range"],
            "biases": cfg["qkv_proj_bias"] or cfg["mlp_fc1_bias"]}


def layer_matmul_params(cfg: dict) -> int:
    """Weights of one layer's products: q/k/v, out, and the SwiGLU's
    gate, up and down."""
    h, f = cfg["n_embd"], cfg["n_inner"]
    return 4 * h * h + 3 * h * f


def flops(cfg: dict, ntokens) -> float:
    """Model FLOPs of requests of `ntokens` real tokens each (an array):
    2 x the layers' product weights a token, plus 4 L^2 hidden a layer
    for the two attention products (q k^T and p v) over L tokens."""
    import numpy as np

    n = np.asarray(ntokens, np.float64)
    p = cfg["n_layer"] * layer_matmul_params(cfg)
    return float((2.0 * p * n + cfg["n_layer"] * 4.0 * n * n
                  * cfg["n_embd"]).sum())


def weight_bytes(cfg: dict) -> int:
    """Bytes of the product weights, read once a batch, in bf16."""
    return 2 * cfg["n_layer"] * layer_matmul_params(cfg)
