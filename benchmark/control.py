"""The control of `correct`: the plain reference put in the program's
place and computed in the next precision below the configuration's
(bfloat16 served: every product's operands rounded through float8 e4m3,
reference/encoder.py fp8_e4m3), at the cell's own sizes, on as many
texts as a run samples, drawn from the cell's mix, the longest length of
the mix among them, then judged by the same comparison a run makes.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

prints one line per seed with each compared number beside the cell's
limit.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ingest_control(cell, seed: int, device, n_texts: int | None = None):
    import numpy as np
    import torch

    from benchmark.harness import gen, ingest, weights
    from benchmark.reference import encoder as ref_enc
    from benchmark.reference import tokenizer as ref_tok

    spec = cell.counter.spec(cell.config)
    traffic = cell.traffic
    p = weights.reference_params(weights.make_params(spec, seed, device),
                                 spec, device)
    grid = gen.length_grid(traffic["tokens"])
    words = gen.vocabulary(traffic["vocab_words"])
    n = n_texts or cell.workload["check"]["sample"] + 1
    rng = np.random.default_rng([seed, 9])
    got, want = [], []
    for j in range(n):
        cid, num = int(rng.integers(traffic["clients"])), int(rng.integers(1000))
        _, text = gen.embed_request(traffic, grid, words, seed, cid, num)
        if j == 0:                      # the mix's longest length
            text = " ".join(words[rng.integers(0, len(words),
                                               int(grid[-1]) - 2)])
        ids = torch.from_numpy(ref_tok.encode(text, spec["vocab"],
                                              spec["max_len"])).to(device)
        want.append(ref_enc.embed(spec, p, ids))
        got.append(ref_enc.embed(spec, p, ids, quant=ref_enc.fp8_e4m3))
    worst_abs, worst_cos = ingest.compare_vectors(got, want)
    return {"max_abs_err": worst_abs, "cos_dist": worst_cos}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(x) for x in args.seeds.split(",")):
        got = ingest_control(cell, seed, device)
        limits = {k: cell.workload["check"][k] for k in got}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "fails": any(got[k] > limits[k] for k in got)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
