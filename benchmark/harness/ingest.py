"""An ingest cell: clients write texts into a file-backed store, the
port's Embedder (engine/embedder.py) embeds them through the bucketed
encoder and commits the vectors; a request is done when the client sees
its vector committed.

`correct` compares, for a sample of the keys the window wrote last
(drawn from the seed, the longest text among them), the vector read
back from the store's lane with the plain float32 reference
(reference/encoder.py) run over the reference tokenizer's ids of the
same text.
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import numpy as np

from . import gen, runner, stats, trace, weights
from .spec import Cell


def cell_buckets(model_buckets, tokens: dict) -> list[int]:
    """The encoder's buckets the mix's lengths fall into."""
    out = []
    for b in model_buckets:
        lower = max([x for x in model_buckets if x < b], default=0)
        if tokens["min"] <= b and tokens["max"] > lower:
            out.append(b)
    return out


def batch_pads(cap: int) -> list[int]:
    """The batch sizes the encoder pads a chunk of <= cap rows to."""
    out, b = [], 1
    while b < cap:
        out.append(b)
        b *= 2
    return out + [b]


def run(cell: Cell, *, seed: int, seconds: int, trace_on: bool, device,
        t_proc0: float) -> int:
    import torch

    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.models import (EmbeddingModel, EncoderConfig,
                                              HashTokenizer)
    from libsplinter_tpu_torch.store import Store

    wl, cfg, traffic = cell.workload, cell.config, cell.traffic
    spec = cell.counter.spec(cfg)
    tmp = tempfile.mkdtemp(prefix="bench-ingest-")
    path = os.path.join(tmp, "store.spt")
    st = Store.create(path, nslots=wl["store"]["nslots"],
                      max_val=wl["store"]["max_val"],
                      vec_dim=spec["out_dim"], persistent=True)
    gens = runner.Generators(traffic, path, seed)
    marks = [("imports, store, generators spawned", time.monotonic())]
    try:
        params = weights.make_params(spec, seed, device)
        ecfg = EncoderConfig(vocab_size=spec["vocab"], hidden=spec["hidden"],
                             layers=spec["layers"], heads=spec["heads"],
                             mlp_dim=spec["mlp"], max_len=spec["max_len"],
                             variant=("nomic" if spec["family"] == "nomic_bert"
                                      else "bert"),
                             layer_norm_eps=spec["eps"],
                             out_dim=spec["out_dim"],
                             dtype=getattr(torch, cfg["serve_dtype"]))
        model = EmbeddingModel(ecfg, params=params, device=device)
        emb = Embedder(st, model=model, tokenizer=HashTokenizer(spec["vocab"]),
                       max_ctx=spec["max_len"], batch_cap=wl["batch_cap"])
        emb.attach()
        buckets = cell_buckets(model.buckets, traffic["tokens"])
        for bsz in batch_pads(wl["batch_cap"]):
            for b in buckets:
                model.encode_ids(np.zeros((bsz, b), np.int32),
                                 np.full(bsz, b, np.int32))
        model.warmup_ring(emb.ring_depth, wl["batch_cap"], buckets=buckets)
        marks.append(("weights, model, warm-up", time.monotonic()))
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        edges = {}
        prof = None
        if trace_on:
            trace.warm_profiler()
            prof = trace.Window(seconds, on_edge=lambda w: edges.__setitem__(
                w, runner.counters(emb)))
            trace.annotate(emb, {"drain": "embedder.drain",
                                 "_gather": "embedder.gather",
                                 "_ctx_flags_and_ids": "embedder.tokenize",
                                 "_dispatch_guarded": "embedder.dispatch",
                                 "_commit_batch": "embedder.commit"})
            trace.annotate(st, {"signal_wait": "embedder.wait_for_wake"})
            prof.wrap(st, "signal_wait")
            marks.append(("profiler", time.monotonic()))
        gens.wait_ready()
        marks.append(("generators ready", time.monotonic()))
        runner.flush_to_disk(path)
        marks.append(("store flushed", time.monotonic()))

        daemon = runner.Daemon(emb)
        t0 = time.monotonic() + wl["daemon_lead_s"]
        t1 = t0 + seconds
        if prof is not None:
            prof.arm(t0)
        setup_s = t0 - t_proc0
        daemon.start()
        gens.start(t0, t1)
        time.sleep(max(t0 - time.monotonic(), 0.0))
        c0 = runner.counters(emb)
        time.sleep(max(t1 - time.monotonic(), 0.0))
        c1 = runner.counters(emb)
        recs, gstats, gen_bad = gens.collect(traffic["grace_s"] + 60.0)
        if prof is not None:
            prof.wait()
        daemon.stop()
        dev = runner.device_info(torch, device)
        profile = prof.summary() if prof is not None else None

        w = runner.Window(t0, t1, recs)
        issued = w.issued()
        lat = runner.latencies_ms(issued, lambda r: r[6] is not None)
        done = [r for r in w.done_in(t0, t1) if r[6] is not None]
        failed = int((~np.isfinite(lat)).sum())
        print(runner.summary_line("set -> vector", lat, seconds, len(done)))
        print(f"generators: {gstats}")
        print("set-up: " + ", ".join(
            f"{what} {t - prev:.3f} s" for (what, t), prev in
            zip(marks, [t_proc0] + [t for _, t in marks[:-1]])))
        print(f"embedder counters over the window: "
              f"{ {k: c1[k] - c0[k] for k in c0 if isinstance(c0[k], (int, float))} }")

        del daemon, emb, model
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = _check(cell, spec, st, issued, seed, params, device)
        checks["lost"] = {"value": failed, "limit": 0}

        if not trace_on:
            metrics = {
                "embeddings_per_s": {"value": len(done) / seconds,
                                     "unit": "embeddings/s"},
                "set_to_vector_p95_ms": {"value": stats.percentile(lat, 95),
                                         "unit": "ms"},
                "setup_s": {"value": setup_s, "unit": "s"}}
            breakdown = None
        else:
            ctx = runner.Context.of(cell, prof, profile, edges, recs)
            metrics = runner.read_per_layer(cell, ctx)
            if profile is not None:
                dev["busy_s"] = profile["busy_s"]
                dev["window_s"] = profile["window_s"]
                breakdown = {"device_ops": profile["device_ops"],
                             "idle_gaps": profile["idle_gaps"]}
            else:
                breakdown = None
        return runner.finish(cell=cell, checks=checks, attempted=len(issued),
                             failed=failed, metrics=metrics, device=dev,
                             breakdown=breakdown, gen_bad=gen_bad)
    finally:
        gens.close()
        st.close()
        Store.unlink(path, persistent=True)
        shutil.rmtree(tmp, ignore_errors=True)


def compare_vectors(got: list, want: list) -> tuple[float, float]:
    """(the largest |got - want| of any component, the largest 1 - cosine)
    over pairs of vectors; want is unit length."""
    import torch

    worst_abs = worst_cos = 0.0
    for g, w in zip(got, want):
        worst_abs = max(worst_abs, float((g - w).abs().max()))
        cos = float(g @ w / torch.clamp(torch.linalg.vector_norm(g), min=1e-12))
        worst_cos = max(worst_cos, 1.0 - cos)
    return worst_abs, worst_cos


def _check(cell: Cell, spec: dict, st, issued: list, seed: int, params,
           device) -> dict:
    """The sampled keys' vectors against the reference."""
    import torch

    from ..reference import encoder as ref_enc
    from ..reference import tokenizer as ref_tok

    lim = cell.workload["check"]
    last: dict[int, tuple] = {}
    for r in issued:
        if r[6] is not None and (r[2] not in last or r[3] > last[r[2]][3]):
            last[r[2]] = r
    keys = sorted(last)
    rng = np.random.default_rng([seed, 7])
    pick = {keys[i] for i in runner.sample_rows(rng, len(keys),
                                                lim["sample"])}
    if keys:
        pick.add(max(keys, key=lambda k: (last[k][4], k)))
    grid = gen.length_grid(cell.traffic["tokens"])
    words = gen.vocabulary(cell.traffic["vocab_words"])
    p = weights.reference_params(params, spec, device)
    del params
    mismatched, got, want = 0, [], []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for idx in sorted(pick):
            cid, n = last[idx][0], last[idx][1]
            _, text = gen.embed_request(cell.traffic, grid, words, seed, cid, n)
            if st.get_at(idx).rstrip(b"\0").decode() != text:
                mismatched += 1
                continue
            ids = torch.from_numpy(ref_tok.encode(text, spec["vocab"],
                                                  spec["max_len"])).to(device)
            want.append(ref_enc.embed(spec, p, ids))
            got.append(torch.from_numpy(st.vec_get_at(idx)).to(device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    worst_abs, worst_cos = compare_vectors(got, want)
    print(f"reference check: {len(pick)} keys of {len(keys)} written in "
          f"the window, longest {max((last[k][4] for k in keys), default=0)} "
          f"tokens")
    return {"text_mismatch": {"value": mismatched, "limit": 0},
            "max_abs_err": {"value": worst_abs, "limit": lim["max_abs_err"]},
            "cos_dist": {"value": worst_cos, "limit": lim["cos_dist"]}}
