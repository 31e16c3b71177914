"""Tiny versions of the benchmark's cells for CPU tests: the published
shapes cut to a few layers and a small width, the traffic to a few
clients."""
from benchmark.harness import spec as S


def tiny_ingest(name: str = "nomic-v1.5-ingest-docs"):
    cell = S.load_cell(name)
    c = dict(cell.config)
    if "n_embd" in c:
        c.update(n_embd=64, n_head=4, n_inner=128, n_layer=2, vocab_size=1024,
                 n_positions=128, out_dim=64)
    else:
        c.update(hidden_size=64, num_attention_heads=4, intermediate_size=128,
                 num_hidden_layers=2, vocab_size=1024,
                 max_position_embeddings=128, out_dim=64)
    c["serve_dtype"] = "float32"
    cell.config = c
    cell.traffic = dict(cell.traffic, clients=4, outstanding=4, generators=2,
                        key_space=64, grace_s=30,
                        tokens=dict(cell.traffic["tokens"], mean_words=24,
                                    max=110))
    cell.workload = dict(cell.workload, batch_cap=8,
                         store={"nslots": 4096, "max_val": 2048},
                         check=dict(cell.workload["check"], sample=16))
    return cell

