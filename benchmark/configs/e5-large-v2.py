"""e5-large-v2 as the benchmark runs it: the shapes the reference and
the weights are built from, and the counts of work and bytes that the
per-layer metrics divide by the chip's peaks."""
from __future__ import annotations


def spec(cfg: dict) -> dict:
    """The shapes as run: the published numbers, with the port's
    departures (cfg["departures"][key]["run"]) in their place."""
    act = cfg["departures"]["hidden_act"]["run"]
    gelu = {"gelu": "none", "gelu_pytorch_tanh": "tanh"}[act]
    return {"family": "bert", "hidden": cfg["hidden_size"],
            "heads": cfg["num_attention_heads"],
            "mlp": cfg["intermediate_size"],
            "layers": cfg["num_hidden_layers"], "vocab": cfg["vocab_size"],
            "max_len": cfg["max_position_embeddings"],
            "eps": cfg["layer_norm_eps"], "rotary_base": None, "gelu": gelu,
            "out_dim": cfg["out_dim"], "init_std": cfg["initializer_range"],
            "biases": True}


def layer_matmul_params(cfg: dict) -> int:
    """Weights of one layer's products: q/k/v, out, and the GELU MLP's
    up and down."""
    h, f = cfg["hidden_size"], cfg["intermediate_size"]
    return 4 * h * h + 2 * h * f


def flops(cfg: dict, ntokens) -> float:
    """Model FLOPs of requests of `ntokens` real tokens each (an array):
    2 x the layers' product weights a token, plus 4 L^2 hidden a layer
    for the two attention products (q k^T and p v) over L tokens."""
    import numpy as np

    n = np.asarray(ntokens, np.float64)
    p = cfg["num_hidden_layers"] * layer_matmul_params(cfg)
    return float((2.0 * p * n + cfg["num_hidden_layers"] * 4.0 * n * n
                  * cfg["hidden_size"]).sum())


def weight_bytes(cfg: dict) -> int:
    """Bytes of the product weights, read once a batch, in bf16."""
    return 2 * cfg["num_hidden_layers"] * layer_matmul_params(cfg)
