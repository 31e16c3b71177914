"""Drive the torch port's embed -> vector-commit -> search path, its
dense completion lane, its continuous (block-paged) completion lane,
the encoder's contrastive trainer, GGUF checkpoints opened cold by the
embedder and the completer, the completer's serving variants
(int8-resident weights, the host-DRAM KV tier, the disaggregated
prefill/decode lanes), speculative decoding, a Mixtral-family MoE
checkpoint, the whole serving surface as supervised child processes,
the operator CLI over it, sharded serving (tensor- and
expert-parallel decoding, sharded search) and multi-GPU training (the
dp x tp sharded trainer, the ring trainer, the pipeline encoder) on one
NVIDIA GPU, with every
CUDA kernel held against its plain PyTorch version.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure exits non-zero and prints no result line; each runs
under a deadline of about 3x its wall on the card, PHASE_DEADLINE_S, and
a phase that passes it fails naming itself; phases 8-15 run the
full-width geometries at CUT_LAYERS = 4 of their 12 layers):

  1. device: the card's name and count, nvidia-smi's name + power limit;
  2. build: compile the kernels (csrc/*.cu, one nvcc per source, all
     started together), print the build seconds, ptxas' registers and
     spills per kernel (the D = 64 tensor-core kernels and every D = 64
     K5 kernel must not spill) and the HMMA/HGMMA count of K1's, K4's
     and K6's SASS (cuobjdump -sass; must be above 0);
  3. kernels: each kernel against its plain version at the main path's
     shapes (K1 flash attention at B=8 S=2048 and B=32 S=512, bf16 and
     f32, its row max/sum for K6 against the plain helper and its output
     identical with and without them; K6, its backward, at B=8 S=2048
     and B=16 S=512, bf16 and f32, with SDPA's backward as the
     yardstick; K1/K6 with their TFLOP/s, each and its SDPA yardstick
     timed by CUDA graph replay with the eager pace beside; K3 cosine
     scores at Q = 1
     (the CLI's local search, exact and mxu_bf16), 8, 32 and 256 and K2
     fused top-k at Q = 8, 32 and 256 by k = 16 and 128,
     over a 1,048,576 x 768 f32 lane, with their share of the bound; K4
     causal prefill
     attention over a 2048-slot cache at B=8 S=1024, B=1 S=2048, a
     joiner at pos > 0 and GQA 12/4, bf16 and f32, each with queries
     that see no key; K5 ragged paged attention over a 513-block pool
     at B=32 H=12 D=64 page 128 with seeded lengths, a dead row and a
     page-boundary row, over bf16, f32, int8 and int4 pools, GQA 12/4,
     8 long live rows of 32, a 64-token multi-query stack and the
     speculative lane's verify stack (32 rows x gamma + 1 = 5), each
     case with its split count and also launched with f32 queries over
     f32 or quantized pools and held to 1e-5), with CUDA-event times of
     the kernel, the plain version and a PyTorch yardstick call the
     port never makes, beside the bound (the larger of bytes / 3.35
     TB/s and FLOPs / the card's peak for the input type).  K5 and its
     yardstick, and K4 and its yardstick, are timed by replaying a CUDA
     graph of their calls: they take less device time than their
     wrappers' host work, so events around eager calls would time the
     host (that pace is printed beside);
  4. end to end: a file-backed store with 1,048,576 slots of 768-d
     vectors (~1,000,000 committed through the store's batch commit;
     the file stays for phase 13),
     the embedder at full Nomic-Embed-Text-v1.5 width (bf16, seeded
     random weights) draining ~64 texts over buckets 16..2048 (so K1
     runs), a few vectors checked against the same model in f32 on the
     CPU, then k=10 (K2) and k=200 (K3 + stable sort) searches through
     submit_search with a Searcher draining in-process, held against
     the plain top-k on the card;
  5. completion: the full-width default decoder (DecoderConfig(): 12
     layers, hidden 768, vocab 32000, bf16, seeded random weights)
     behind an in-process Completer on a store: one run_once drains 8
     prompts of 40-900 bytes as one bucket-1024 batched prefill (K4 on
     every layer) plus decode, then one serial ~1500-byte request lands
     in bucket 2048; every key must end READY with its completion
     appended; the batched prefill logits are held against the same
     weights with flash_min_seq=0 (the plain attention); a profiled
     warm drain splits the device time by kernel class;
  6. continuous lane: the same decoder behind a Completer at the lane's
     defaults (32 rows, page 128, 513 blocks, prefix cache on, two
     chunks in flight), 128 new tokens a request: 48 requests in two
     waves (24 distinct prompts of 40-1500 bytes, 22 sharing a 700-byte
     prefix, 2 exact repeats), the second queued while the first
     decodes; every key READY, no failure caught by the lane and every
     request's 128 tokens streamed, K5 launched on decode and on suffix
     prefills, >= 20 prefix hits, no page leaked, the pool's bytes equal
     to its geometry; a warm and a profiled drain of 8; 4 requests
     again over int8 and int4 pools (K5 launched, no abort, full token
     count); a paged prefill + decode step
     against the dense prefill + decode_one (cosine >= 0.999);
  7. training: make_train_step(EncoderConfig()) (bf16 compute, f32
     master weights, AdamW) on a fixed seeded batch of 16 pairs at
     S=512, lengths 128-512: a warm-up step, 20 timed steps (K1 and K6
     24 times a step; the loss must fall), a profiled step split by
     kernel class, 2 steps of 4 pairs at S=2048; one f32 step's
     gradients through K1/K6 against the plain attention (1e-4 of each
     tensor's max |g|, TF32 off); save -> restore -> the next step's
     loss within 1e-6 relative of the uninterrupted one's; the trained
     weights served through EmbeddingModel against the trainer's own
     forward;
  8. gguf: the committed golden fixture (tests/fixtures/) opened cold
     in f32 (TF32 off): config and token ids exact, vectors within
     1e-5 of golden_expected.json, directly and committed by an
     in-process Embedder; embedder.main on the file alone (bf16,
     cosine >= 0.999).  Then EncoderConfig(layers=4) from seeded
     weights written as an F16 GGUF with a 30528-entry WordPiece vocab
     and DecoderConfig(layers=4) as F16 with layer 0's attention in
     Q8_0 and its MLP in Q4_0, a 32000-piece unigram vocab and a chatml
     template,
     each opened cold with every tensor bit-exact (the f16 rounding or
     the numpy dequantizer's output); the encoder serves 64 texts
     (K1 on buckets 512 and 1024) and a k=16 search (K2), and
     completer.main --weights <file> --continuous --template auto
     resolves chatml and serves 8 requests (K4, K5) with no abort.
     Write and cold-load seconds and each lane's rate are printed;
  9. serving variants, all at DecoderConfig(layers=4) width on the
     continuous lane with greedy sampling, 64 new tokens a request:
     quant — the seeded float weights held as Q8_0 blocks
     (--quantized) and per output channel (--weights-int8), each
     variant's first-step logits against the float model on the
     dequantized weights (f32 within 1e-3, bf16 cosine >= 0.999), the
     projection bytes resident against bf16 (0.5625 and ~0.5), 16
     requests through run_continuous, and phase 8's decoder file opened
     with quantized=True, layer 0's Q8_0 codes and scales on the card
     equal to the file's blocks; tier — a 24-page pool with a host-DRAM
     tier: a shared-prefix prompt served, served again resident, pushed
     out by four long prompts (demoted) and served a third time
     (readmitted: tier_readmits > 0, its completion byte-identical to
     the resident one's), then export_page_bytes / import_page_bytes
     timed per page; disagg — a PrefillLane and a DecodeLane on two
     threads over one file-backed store (a 4.7 MB wire page per value)
     serve 16 requests, compared with the unified lane's completions,
     and each prompt's first decode step over adopted wire pages held
     against the same step over the pages it was prefilled into
     (cosine >= 0.999; bit-identical expected); the handoff MB and wall;
 10. speculative: the same decoder, greedy, on the continuous lane at
     its defaults, 8 of phase 9's prompts x 64 tokens, a self-draft of
     its first 3 of 4 layers with gamma 4 (the acceptance floor off) against
     the plain lane (prefix cache off: the paired pools have none), in
     f32 (TF32 off) and bf16, the ids read back exactly: every first
     divergence must be a near-tie of the plain lane's logits there
     (f32: top-2 within 1e-4; bf16: within 4 bf16 ulps), K5 must run
     the verify stack (S = 5), verified > proposed, and no page may be
     held on either pool once the last request is READY; a demotion
     drill (4 requests, floor 0.99: spec_demotions 1 in the heartbeat,
     the plain target adopted with a fresh pool, all READY); a
     DecoderConfig(layers=2) draft written by gguf_writer behind phase
     8's file on the serial lane in f32 (greedy bytes equal the
     target-only lane's) and through completer.main --draft-weights;
 11. moe: DecoderConfig(layers=4) geometry with 8 experts, top-2,
     written as an F16 Mixtral-family GGUF (router, stacked experts,
     expert_count) on phase 8's vocab and chatml template (~0.42 GB),
     read back
     bit-exact, served by completer.main --weights <file> --continuous
     --template auto (8 requests x 64 tokens, greedy) with completions
     byte-identical to an in-process moe_completion_model's on the same
     file, and again with --quantized (experts resident 0.5625 x bf16);
     the int8-expert model's first-step logits within 1e-5 of the float
     model on the dequantized weights in f32;
 12. supervision: `python -m libsplinter_tpu_torch.engine.supervisor`
     started from a directory without the package, over the embedder,
     searcher, completer, pipeliner, telemetry and autoscaler lanes on a
     file-backed store of 65,536 slots x 768-d (~62,500 unit vectors),
     phase 8's two files as the model lanes' weights (the completer
     --continuous --temp 0 --max-new-tokens 32, pinned to card 0), and
     SPTPU_FAULT crashing the embedder at its first encode, the
     searcher at its first gather and the completer at its first
     commit: 32 texts embedded (16 in buckets >= 512; 8 against an
     in-process model on the file, cosine >= 0.999), k = 10 and k = 200
     searches equal to the plain top-k on the card, 8 prompts of
     40-1500 bytes READY with 32 new tokens each and no page held, a
     Lua RAG chain through the pipeliner whose hits equal a direct
     search's, a manual scale to two embedder replicas (a burst of 32
     served by both) and back to one (replica 1 drains and retires,
     nothing stranded), telemetry rings for every lane; each of the
     three model lanes restarted once and never down, the torch-free
     lanes never; every child lane's kernel launches read from its
     heartbeat (K1 in the embedder, K2 and K3 in the searcher, K4 and
     K5 in the completer, each > 0); SIGTERM ends the supervisor with
     exit 0 and no child left; the card's free memory before and after;
 13. cli: `python -m libsplinter_tpu_torch.cli --store <phase 4's
     file> --persistent supervise --lanes embedder,searcher,completer,
     pipeliner,telemetry` started from a directory without the package
     (phase 8's files as the weights, the completer --continuous --temp
     0 --max-new-tokens 32), then the CLI against it, as subprocesses
     and in this process through cli.main.main: `health` (its wall is
     the CLI's start-up) listing every lane's heartbeat; `lint` (the
     port's splint over the checkout) with no finding; `ingest` of 64
     texts (16 in buckets >= 512) through one REPL, all 64 vectors
     landed, 8 against an in-process model on the file (cosine >=
     0.999); `search --local --json` in this process (one K3 launch at
     Q = 1; its upload, K3, distances and argsort timed from inside)
     equal to the plain version; `search --json` at k = 10 and --limit
     200 through the searcher, equal to the plain top-k; one REPL
     session fed on stdin with four local searches (the card lane
     uploaded once and then only dirty rows staged; --cpu within 1e-5
     / 1e-4, --fast keeping every row whose gaps exceed 4e-2);
     `metrics` with each model lane's kernel_* counts, `metrics
     --history`, `top --once`, `scale set` / `scale status`; a Lua RAG
     chain through `pipeline run` whose hits equal a direct search's,
     its record read back by `lua`, `wasm` of tests/test_wasm.py's host
     module; `loadgen` for 10 s of mixed traffic at 3 requests/s with
     nothing lost (p50/p99 by lane), `trace export`; the children's
     launches (K1, K2, K3, K5) from their heartbeats; SIGTERM to
     `spt supervise`: exit 0, no child left;
 14. sharded: a tp = 2 mesh of two shards (real cards where the host
     has two, else both shards on cuda:0, which is printed): K4 at the
     per-shard shape of the main case (B=8 S=1024 H=KH=6) and K5 at
     H=KH=6 over bf16, int8 and int4 pools against their plain versions
     (graph replay, as phase 3's rows); the continuous lane at tp = 2 at
     DecoderConfig(layers=4) through Completer, 8 requests x 64 tokens
     (prompts up to ~1500 tokens, so K4 runs on each shard), greedy,
     against tp = 1 on the same weights: f32 tokens identical, bf16
     agreement and first divergences printed, each shard's K4 and K5
     launches > 0; the tp = 2 target's self-draft (3 layers, gamma 4,
     8 requests) against its plain lane in f32; the split lanes at
     tp = 2 (bf16, 8 requests) identical to the unified lane, the wire
     MB printed; phase 11's MoE geometry in f32 at ep = 2 x tp = 2
     against ep = 1, tokens identical; sharded_topk over phase 4's lane
     at dp = 2 against the one-shard kernels (K2 at Q = 8 k = 16, and
     over a sparse mask with tied twins and filler; K3 at k = 200), rows
     identical; `spt search --sharded` (k = 10 and 200) on phase 4's
     store with an in-process embedder answering, equal to the plain
     version; `completer.main --tp 2` on one card refused, naming the
     count.  Its wall and per-shard launch counts are printed;
 15. train_parallel: a prediction line, then on a mesh of four shards
     (real cards where the host has them, else all on cuda:0): K1 and
     K6 at one tp = 2 shard's training shape (bf16 B=8 S=512 H=6)
     against their plain versions, timed by graph replay beside SDPA;
     make_sharded_train_step at dp = 2 x tp = 2 on EncoderConfig(): one
     f32 SGD step over 8 pairs x 512 against make_train_step from the
     same generator (the init identical, loss within 1e-5 relative,
     gathered gradients within 1e-4 of each tensor's max |g|, every
     parameter within lr 1e-4 max|g| + 2^-22 max|p|; K1 and K6 96 times),
     then phase 7's 16 pairs in bf16 with AdamW for 5 timed steps (the
     loss falls, the dp replicas bit-identical, steps/s and peak memory
     beside the single-card losses) and one profiled step; make_ring_train_step at dp = 1 x
     sp = 4 over 4 pairs x 2048 in f32 against the single-card step under
     the same bounds (the single-card step runs K1/K6 24 times, the ring
     none), each side's warm step wall and peak memory; pipeline_encode
     at pp = 4 with 4 microbatches over 16 x 512 in bf16 (cosine >= 0.999
     to Encoder.forward, K1 48 times; a backward through it runs K6 48
     times, gradients at cosine >= 0.99) and f32 (embeddings within 1e-5,
     gradients within 1e-4 of max |g|);
 16. launch counts: how often each kernel ran in phases 4 (K1-K3), 5
     and 6 (K4, their sum; each phase's count in the timings line), 6
     (K5, by query tokens and by splits: a launch of more than one
     split runs the combine kernel too), 7 (K6), 8 (K1, K2, K4, K5
     from GGUF weights), 9-11 (K4, K5 on each path), 12 (K1-K5 in
     the supervised children, each process counting from its start)
     13 (K3 in the CLI's own process, K1-K5 in the children), 14
     (K2-K5 on the sharded paths) and 15 (K1, K6 on the training
     paths), each counted from 0 just before its path runs, phases 8-15
     added to the sums.

Before the kernels' record comes `phase walls: {...}`, each phase's
wall in seconds.  The line before the last is the kernels' JSON record;
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import json
import os
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

# H100 SXM published peaks (dense) and memory rate; see PERF.md
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
MEM_BPS = 3.35e12

REPLACES = {
    "flash_fwd": "libsplinter_tpu/ops/flash_attention.py:45",
    "flash_bwd": "libsplinter_tpu/ops/flash_attention.py:101",
    "fused_topk": "libsplinter_tpu/ops/similarity.py:280",
    "cosine_scores": "libsplinter_tpu/ops/similarity.py:44",
    "causal_fwd": "libsplinter_tpu/ops/flash_attention.py:182",
    "paged_fwd": "libsplinter_tpu/ops/paged_attention.py:130",
}
SOURCES = {
    "flash_fwd": "libsplinter_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd": "libsplinter_tpu_torch/csrc/flash_bwd.cu",
    "fused_topk": "libsplinter_tpu_torch/csrc/fused_topk.cu",
    "cosine_scores": "libsplinter_tpu_torch/csrc/cosine_scores.cu",
    "causal_fwd": "libsplinter_tpu_torch/csrc/causal_fwd.cu",
    "paged_fwd": "libsplinter_tpu_torch/csrc/paged_fwd.cu",
}

LANE_DIM = 768
F32_ATOL = 1e-5
# K1's, K4's, K5's and K6's bf16 outputs against the f32 plain version
# on the same values rounded to bf16, per element:
#   - one bf16 ulp of |ref|, at most 2^-7 |ref| (bf16 keeps 8
#     significant bits): the kernel's f32 value and the reference's may
#     round to neighbouring bf16 values;
#   - where the kernel rounds the probabilities to bf16 before P.V (K1,
#     K4; K5 over bf16 pools), each P_j moves by at most 2^-8 P_j (bf16's
#     unit roundoff), so the output by at most 2^-8 sum_j P_j |V_j|:
#     2^-8 of the attention-weighted mean of |V|.  K6 rounds P and dS
#     to bf16 before its products, as the TPU kernel's default-precision
#     dots round their f32 inputs, so its gradients move by at most 2^-8
#     of the same sums over absolute values: |P|^T |dO| for dv,
#     |dS|^T |Q| for dk, |dS| |K| for dq (flash_bwd_plain_and_terms);
#   - the f32 tolerance for the sums taken in another order.
BF16_ULP, BF16_P_ROUND = 2.0 ** -7, 2.0 ** -8


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


# -- timing -------------------------------------------------------------------

# Each phase's deadline: about 3x its wall on the card (NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md section 6), 60 s at least.  A phase that passes
# it fails, naming itself, long before the smoke's own time limit.
PHASE_DEADLINE_S = {
    "device": 60, "build": 150, "flash": 60, "flash_bwd": 60,
    "search_kernels": 60, "causal": 60, "paged": 60, "lane": 160,
    "completion": 180, "continuous": 240, "train": 60, "gguf": 60,
    "variants": 60, "speculative": 100, "moe": 90, "supervision": 280,
    "cli": 320, "sharded": 160, "train_parallel": 110,
}
# a phase stuck where no signal reaches it (a call that never returns to
# the interpreter) is ended this long after its deadline
HARD_GRACE_S = 60


class PhaseClock:
    """Seconds of wall per phase, and each phase's deadline.

    ``with clock.phase(name):`` arms SIGALRM for PHASE_DEADLINE_S[name]:
    a phase that outlives it raises PhaseError naming the phase in the
    main thread, so the phase's own ``finally`` blocks still stop its
    children.  A watchdog thread ends a phase stuck past its deadline
    plus HARD_GRACE_S: it prints the stacks, kills every process this
    one started and exits 1."""

    # when the running phase's deadline passes (time.monotonic()), read by
    # phase_left(); outside a phase, the longest deadline from now
    ends = None

    def __init__(self):
        self.walls: dict[str, float] = {}
        self._current = None            # (name, hard deadline)
        signal.signal(signal.SIGALRM, self._expired)
        threading.Thread(target=self._watchdog, daemon=True).start()

    def _expired(self, signum, frame):
        name = self._current[0] if self._current else "?"
        raise PhaseError(f"phase {name} passed its deadline of "
                         f"{PHASE_DEADLINE_S.get(name)}s")

    def _watchdog(self):
        while True:
            time.sleep(1.0)
            cur = self._current
            if cur is None or time.monotonic() < cur[1]:
                continue
            print(f"chip_smoke: phase {cur[0]} is stuck "
                  f"{HARD_GRACE_S}s past its deadline of "
                  f"{PHASE_DEADLINE_S[cur[0]]}s; killing its processes",
                  file=sys.stderr, flush=True)
            faulthandler.dump_traceback(all_threads=True)
            print(f"phase walls (to the failure): {self}", flush=True)
            for pid in _descendants(os.getpid()):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
            os._exit(1)

    @contextlib.contextmanager
    def phase(self, name: str):
        limit = PHASE_DEADLINE_S[name]
        t0 = time.perf_counter()
        PhaseClock.ends = time.monotonic() + limit
        self._current = (name, PhaseClock.ends + HARD_GRACE_S)
        signal.setitimer(signal.ITIMER_REAL, limit)
        try:
            yield
        except BaseException:
            log(f"chip_smoke: phase {name} failed")
            raise
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            self._current = None
            PhaseClock.ends = None
            self.walls[name] = round(time.perf_counter() - t0, 1)

    def __str__(self):
        return json.dumps(self.walls)


def phase_left() -> float:
    """Seconds left before the running phase's deadline: the bound of
    every wait inside a phase (a lane's drain, a search, a child's
    command), so that no wait outlasts its phase."""
    if PhaseClock.ends is None:
        return float(max(PHASE_DEADLINE_S.values()))
    return max(1.0, PhaseClock.ends - time.monotonic())


def _descendants(pid: int) -> list[int]:
    """Every live process below `pid`, read from /proc."""
    kids: dict[int, list[int]] = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        kids.setdefault(ppid, []).append(int(d))
    out, todo = [], [pid]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c)
    return out


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call from CUDA events around `reps` back-to-back
    calls, after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20, loops: int = 5) -> float:
    """Mean ms per call of `reps` back-to-back calls captured in one
    CUDA graph, replayed `loops` times between CUDA events: the device
    time of a call whose own host work (a wrapper's checks and
    allocations) would otherwise set the pace of the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(loops):
        graph.replay()
    e1.record()
    e1.synchronize()
    del graph
    return e0.elapsed_time(e1) / (reps * loops)


def bound(nbytes: float, flops: float, kind: str) -> tuple[float, str]:
    t_bytes = nbytes / MEM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phases -------------------------------------------------------------------

def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {name} x{count} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(card)
    return name, count, card


def _sass_mma_count(name: str) -> int:
    """HMMA/HGMMA (tensor-core) instructions in a built kernel library,
    counted in ``cuobjdump -sass``."""
    from libsplinter_tpu_torch.ops import _cuda

    tool = os.path.join(os.path.dirname(_cuda.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(_cuda.library_path(name))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {name}: {out.stderr}")
    return len(re.findall(r"\bH(?:G)?MMA\b", out.stdout))


# the tensor-core instantiations of the main path (D = 64) must not
# spill: ptxas' "N bytes spill stores, N bytes spill loads" read 0
NO_SPILL = ("flash_fwd_mma_kernel<64>", "bwd_dkdv_mma_kernel<64>",
            "bwd_dq_mma_kernel<64>", "causal_fwd_mma_kernel<64>")
# kernels whose ptxas lines are printed one by one, and whose SASS must
# hold tensor-core instructions
PTXAS_EACH = ("flash_fwd", "flash_bwd", "causal_fwd", "fused_topk",
              "cosine_scores", "paged_fwd")
TENSOR_CORE = ("flash_fwd", "flash_bwd", "causal_fwd")


def _kernel_label(fn: str) -> str:
    """A mangled kernel name as name<dtype, D>: the anonymous-namespace
    prefix nvcc gives every kernel makes the raw name unreadable."""
    for m in re.finditer(r"(?<!\d)(\d+)(?=[A-Za-z_])", fn):
        end = m.end() + int(m.group(1))
        name = fn[m.end():end]
        if name.endswith("_kernel") and fn[end:end + 1] == "I":
            args = fn[end + 1:fn.find("EEv", end)] + "E"
            kind = ("bf16" if "bfloat16" in args else
                    "f32" if args.startswith("f") else "")
            dims = [v if t == "i" else ("false", "true")[v == "1"]
                    for t, v in re.findall(r"L([ib])(\d+)E", args)]
            return f"{name}<{', '.join([kind] * bool(kind) + dims)}>"
    return fn[:70]


def _ptxas_table(log_text: str) -> dict[str, tuple[int, int]]:
    """kernel label -> (registers, spill bytes stored + loaded) from
    nvcc's -Xptxas=-v output."""
    table, fn, spill = {}, "?", 0
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            fn = _kernel_label(line.split("'")[1])
        elif "spill" in line:
            spill = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                   line))
        elif "Used" in line and "registers" in line:
            table[fn] = (int(re.search(r"Used (\d+) registers",
                                       line).group(1)), spill)
    return table


def phase_build():
    """Build every kernel; print registers and spills per kernel of
    K1/K2/K4/K6 (and a summary of the others), require no spill in the
    D = 64 tensor-core kernels and tensor-core instructions in K1's,
    K4's and K6's SASS."""
    from libsplinter_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    built = _cuda.build(verbose=True, force=True)
    log(f"build: {len(built)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s (parallel nvcc)")
    check(set(built) == set(_cuda.SOURCES), "not every kernel built")
    tables = {name: _ptxas_table(rec["log"]) for name, rec in built.items()}
    for name, table in tables.items():
        check(table, f"{name}: no ptxas register line")
        if name in PTXAS_EACH:
            for fn, (regs, spill) in sorted(table.items()):
                log(f"  ptxas {name} {fn}: {regs} registers, {spill} bytes "
                    f"of spill")
        else:
            regs = [r for r, _ in table.values()]
            spilled = {fn: sp for fn, (_, sp) in table.items() if sp}
            log(f"  ptxas {name}: {len(table)} kernels, {min(regs)}-"
                f"{max(regs)} registers, {len(spilled)} with spill "
                f"(max {max(spilled.values(), default=0)} bytes)")
        for fn in NO_SPILL:
            if fn in table:
                check(table[fn][1] == 0, f"{fn} spills {table[fn][1]} "
                      f"bytes")
        if name == "paged_fwd":          # every K5 kernel at D = 64
            d64 = {fn: sp for fn, (_, sp) in table.items()
                   if fn.startswith("paged_fwd_kernel<")
                   and fn.split(", ")[2] == "64"}
            check(len(d64) == 14, f"K5's D = 64 kernels: {sorted(d64)}")
            check(not any(d64.values()), f"K5 D = 64 spills: {d64}")
    for name in TENSOR_CORE:
        n = _sass_mma_count(name)
        log(f"  sass {name}: {n} HMMA/HGMMA instructions (tensor cores)")
        check(n > 0, f"{name}: no tensor-core instruction in its SASS")
    for fn in NO_SPILL:
        check(any(fn in table for table in tables.values()),
              f"no ptxas line for {fn} in "
              f"{[sorted(tables[n]) for n in TENSOR_CORE]}")


def _attn_case(b, s, dtype, seed, h=12):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, 64, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    lens = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lens[-1] = 0                                      # fully-masked row
    mask = torch.arange(s, device="cuda")[None] < lens[:, None]
    return q, k, v, mask


def phase_flash(results):
    import torch
    import torch.nn.functional as F

    from libsplinter_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain, flash_fwd_cuda,
        flash_row_stats_plain)

    for b, s in ((8, 2048), (32, 512)):
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32,
                                                       "f32")):
            q, k, v, mask = _attn_case(b, s, dtype, seed=b + s)
            got = flash_attention(q, k, v, mask)
            qf, kf, vf = q.float(), k.float(), v.float()
            ref32 = flash_attention_plain(qf, kf, vf, mask)
            if kind == "f32":
                lim, atol = F32_ATOL, f"{F32_ATOL}"
            else:                          # the bound beside BF16_ULP
                lim = (BF16_ULP * ref32.abs() + BF16_P_ROUND
                       * flash_attention_plain(qf, kf, vf.abs(), mask)
                       + F32_ATOL)
                atol = "2^-7 |ref| + 2^-8 P|V| + 1e-5"
            diff = (got.float() - ref32.to(dtype).float()).abs()
            torch.cuda.synchronize()
            err = diff.max().item()
            worst = (diff / lim).max().item()
            check(worst <= 1.0, f"K1 {kind} B={b} S={s}: max err {err}, "
                  f"{worst:.3f} of its limit {atol}")
            # the fully-masked row: uniform over all S keys
            uniform = vf[-1].sum(0) / s
            udiff = (got[-1].float() - uniform[None]).abs()
            ulim = lim if kind == "f32" else lim[-1]
            check(bool((udiff <= ulim).all()),
                  f"K1 fully-masked row not uniform: {udiff.max().item()}")
            # the row max and sum K6 takes: the output is the same bit
            # for bit with them, and they match the plain helper's
            got2, stats = flash_fwd_cuda(q, k, v, mask.float(), stats=True)
            want = flash_row_stats_plain(qf, kf, mask)
            check(torch.equal(got2, got),
                  f"K1 {kind} B={b} S={s}: output differs with stats")
            serr = ((stats - want).abs() / (want.abs() + 1)).max().item()
            check(serr <= 1e-5 and bool((stats[:, -1] == want[:, -1]).all()),
                  f"K1 {kind} B={b} S={s}: row max/sum off by {serr}")
            del qf, kf, vf, ref32, diff, udiff, got2, stats, want
            # kernel and yardstick by graph replay (the wrapper's host
            # work can set the pace of eager calls at the small shapes);
            # the eager pace is printed beside
            reps = (10, 3) if s > 512 else (20, 5)
            ms = graph_ms(lambda: flash_attention(q, k, v, mask), *reps)
            wrapper_ms = cuda_ms(lambda: flash_attention(q, k, v, mask),
                                 reps=5)
            plain_ms = cuda_ms(
                lambda: flash_attention_plain(q, k, v, mask), reps=3)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            bias = mask[:, None, None, :]
            lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias), *reps)
            h, d = q.shape[2:]
            nbytes = 4 * b * s * h * d * q.element_size() + b * s * 4
            flops = 4.0 * b * h * s * s * d
            bms, by = bound(nbytes, flops, kind)
            rec = {"shape": f"B={b} S={s} H={h} D={d} {kind}",
                   "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bms, "bound_by": by,
                   "tflops": flops / ms / 1e9}
            log(f"K1 flash_fwd {rec['shape']}: err {err:.3g} (limit "
                f"{atol}; worst {worst:.3f} of it; row max/sum within "
                f"{serr:.2g}, output identical with them); kernel "
                f"{ms:.4f} ms = {rec['tflops']:.1f} TFLOP/s (graph replay; "
                f"{wrapper_ms:.4f} ms a call through the wrapper), plain "
                f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms (graph replay), "
                f"bound {bms:.4f} ms ({by}, {flops / bms / 1e9:.0f} "
                f"TFLOP/s; {bms / ms:.1%} of it)")
            results.setdefault("flash_fwd", []).append(rec)
            del q, k, v, got, qt, kt, vt
            torch.cuda.empty_cache()


def _bwd_bound(shape, elt, kind):
    """K6's least time at q's (B, S, H, D): the JAX kernel's five
    S x S x D products, 10 B H S^2 D FLOPs; the bytes of q, k, v, o and
    dO read, dq, dk and dv written, and the mask."""
    b, s, h, d = shape
    return bound(8.0 * b * s * h * d * elt + 4.0 * b * s,
                 10.0 * b * h * s * s * d, kind)


def phase_flash_bwd(results):
    """K6 against its plain version at the training path's shapes, one
    fully-masked batch row in each case; the yardstick is SDPA's
    backward with the same mask (forward + backward minus forward)."""
    import torch
    import torch.nn.functional as F

    from libsplinter_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_bwd_cuda, flash_bwd_plain_and_terms,
        flash_fwd_cuda)

    for b, s in ((8, 2048), (16, 512)):
        for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32,
                                                       "f32")):
            q, k, v, mask = _attn_case(b, s, dtype, seed=3 * b + s)
            g = torch.Generator(device="cuda").manual_seed(b * s)
            do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
            maskf = mask.float()
            o, stats = flash_fwd_cuda(q, k, v, maskf, stats=True)
            got = flash_bwd_cuda(q, k, v, o, do, maskf, stats)
            f32 = [t.float() for t in (q, k, v, o, do)]
            ref, terms = (flash_bwd_plain_and_terms(*f32, mask)
                          if kind == "bf16" else
                          (flash_attention_bwd_plain(*f32, mask),
                           (0.0, 0.0, 0.0)))
            del f32
            torch.cuda.synchronize()
            err, worst, dead = 0.0, 0.0, 0.0
            for name, gt, rt, term in zip(("dq", "dk", "dv"), got, ref,
                                          terms):
                check(bool(torch.isfinite(gt.float()).all()),
                      f"K6 {kind} B={b} S={s}: non-finite {name}")
                f32_tol = F32_ATOL * max(1.0, rt.abs().max().item())
                lim = f32_tol if kind == "f32" \
                    else BF16_ULP * rt.abs() + BF16_P_ROUND * term + f32_tol
                diff = (gt.float() - rt.to(dtype).float()).abs()
                err = max(err, diff.max().item())
                dead = max(dead, diff[-1].max().item())
                w = (diff / lim).max().item()
                worst = max(worst, w)
                check(w <= 1.0, f"K6 {kind} B={b} S={s} {name}: max err "
                      f"{diff.max().item()}, {w:.3f} of its limit")
            # the dead row's P is uniform over the S keys, so its dV is
            # the mean of dO over the queries
            udv = do[-1].float().sum(0) / s
            ulim = F32_ATOL * max(1.0, udv.abs().max().item())
            if kind == "bf16":
                ulim = BF16_ULP * udv.abs() + ulim
            check(bool(((got[2][-1].float() - udv[None]).abs()
                        <= ulim).all()),
                  f"K6 {kind} B={b} S={s}: dead row's dV is not the mean "
                  f"of dO")
            del ref, terms
            # kernel and yardstick by graph replay, the eager pace beside
            reps = (10, 3) if s > 512 else (20, 5)
            ms = graph_ms(lambda: flash_bwd_cuda(q, k, v, o, do, maskf,
                                                 stats), *reps)
            wrapper_ms = cuda_ms(lambda: flash_bwd_cuda(
                q, k, v, o, do, maskf, stats), reps=5)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(
                q, k, v, o, do, mask), reps=2)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            bias = mask[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=bias)

            def sdpa_fwd_bwd():
                return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

            with torch.no_grad():
                fwd_ms = graph_ms(sdpa, *reps)
            lib_ms = graph_ms(sdpa_fwd_bwd, *reps) - fwd_ms
            bms, by = _bwd_bound(q.shape, q.element_size(), kind)
            limit = (f"{F32_ATOL} max(1, max|ref|)" if kind == "f32"
                     else "2^-7 |ref| + 2^-8 (|P|^T|dO|, |dS|^T|Q|, |dS||K|)"
                     " + 1e-5 max(1, max|ref|)")
            h, d = q.shape[2:]
            flops = 10.0 * b * h * s * s * d          # the bound's count
            rec = {"shape": f"B={b} S={s} H={h} D={d} {kind}",
                   "max_abs_err": err, "dead_row_err": dead, "ms": ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "sdpa_fwd_ms": fwd_ms,
                   "bound_ms": bms, "bound_by": by,
                   "tflops": flops / ms / 1e9}
            log(f"K6 flash_bwd {rec['shape']}: err {err:.3g} (limit "
                f"{limit}; worst {worst:.3f} of it; fully-masked row "
                f"{dead:.3g}, its dV the mean of dO); kernel {ms:.4f} ms = "
                f"{rec['tflops']:.1f} TFLOP/s on the bound's 10 S^2 D "
                f"({1.4 * rec['tflops']:.1f} on the 14 it runs; graph "
                f"replay; {wrapper_ms:.4f} ms a call through the wrapper), "
                f"plain {plain_ms:.3f} ms, sdpa backward {lib_ms:.4f} ms "
                f"(graph replay, fwd+bwd minus fwd {fwd_ms:.4f}), bound "
                f"{bms:.4f} ms ({by}, {flops / bms / 1e9:.0f} TFLOP/s; "
                f"{bms / ms:.1%} of it)")
            results.setdefault("flash_bwd", []).append(rec)
            del q, k, v, o, do, got, qt, kt, vt, dot
            torch.cuda.empty_cache()


# K4 cases: (B, S, T, H, KH, pos, starts).  Rows whose start lies past
# pos + S - 1 are batch-pad rows (prefill_batch gives them start =
# bucket); a start above pos left-pads the row's first queries.  All
# of them see no key and must come out as the mean of V over T.
CAUSAL_CASES = (
    (8, 1024, 2048, 12, 12, 0, (0, 124, 300, 524, 700, 900, 984, 1024)),
    (1, 2048, 2048, 12, 12, 0, (248,)),
    (1, 512, 2048, 12, 12, 528, (740,)),            # join_row at pos > 0
    (8, 1024, 2048, 12, 4, 0, (0, 10, 200, 333, 512, 800, 1000, 1024)),
)
CAUSAL_MAIN = "B=8 S=1024 T=2048 H=12 KH=12 pos=0 bf16"


def _causal_shape(b, s, t, h, kh, pos, kind):
    return f"B={b} S={s} T={t} H={h} KH={kh} pos={pos} {kind}"


def _causal_bound(b, s, t, h, kh, d, pos, starts, elt, kind):
    """The least time for this run's inputs: 4 D FLOPs per (query,
    visible key) pair, and the bytes of q, out, start, the visible K/V
    of each (row, kv head) and all T of V where a query sees no key
    (its output is the mean of V over T)."""
    pairs, kv_rows = 0, 0
    for st in starts:
        st = max(st, 0)
        vis = [max(0, pos + i - st + 1) for i in range(s)]
        pairs += sum(vis)
        rows = max(0, pos + s - st)
        kv_rows += rows + (t if min(vis) == 0 else rows)
    flops = 4.0 * d * h * pairs
    nbytes = (2.0 * b * s * h * d + kv_rows * kh * d) * elt + 4 * b
    return bound(nbytes, flops, kind)


def phase_causal(results, cases=CAUSAL_CASES):
    import torch
    import torch.nn.functional as F

    from libsplinter_tpu_torch.ops.flash_attention import (
        causal_attention_plain, causal_flash_attention)

    d = 64
    for b, s, t, h, kh, pos, starts in cases:
        rep = h // kh
        start = torch.tensor(starts, dtype=torch.int32, device="cuda")
        slots = pos + torch.arange(s, device="cuda")
        keys = torch.arange(t, device="cuda")
        visible = ((keys[None, :] <= slots[:, None])[None]
                   & (keys[None, None, :] >= start[:, None, None]))
        has_key = visible.any(dim=-1)                    # (B, S)
        check(bool((~has_key).any()), "K4 case has no keyless query")
        for dtype, kind in ((torch.bfloat16, "bf16"),
                            (torch.float32, "f32")):
            g = torch.Generator(device="cuda").manual_seed(s + t + pos + kh)
            q = torch.randn(b, s, h, d, generator=g, device="cuda").to(dtype)
            kk, vv = (torch.randn(b, t, kh, d, generator=g, device="cuda")
                      .to(dtype) for _ in range(2))
            got = causal_flash_attention(q, kk, vv, pos, start)
            kr, vr = (x.float().repeat_interleave(rep, dim=2)
                      for x in (kk, vv))
            ref32 = causal_attention_plain(q.float(), kr, vr, pos, start)
            mean = vr.mean(dim=1)[:, None]               # (B, 1, H, D)
            if kind == "f32":
                lim = mlim = F32_ATOL
                limit = f"atol {F32_ATOL}"
            else:                          # the bound beside BF16_ULP
                lim = (BF16_ULP * ref32.abs() + BF16_P_ROUND
                       * causal_attention_plain(q.float(), kr, vr.abs(),
                                                pos, start) + F32_ATOL)
                mlim = (BF16_ULP * mean.abs() + BF16_P_ROUND
                        * vr.abs().mean(dim=1)[:, None] + F32_ATOL)
                limit = "2^-7 |ref| + 2^-8 P|V| + 1e-5"
            diff = (got.float() - ref32.to(dtype).float()).abs()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"K4 {kind} B={b} S={s}: non-finite output")
            err = diff.max().item()
            worst = (diff / lim).max().item()
            check(worst <= 1.0, f"K4 {kind} B={b} S={s} pos={pos} KH={kh}: "
                  f"max err {err}, {worst:.3f} of its limit {limit}")
            empty = ~has_key
            mdiff = (got.float() - mean).abs()
            merr = mdiff[empty].max().item()
            mworst = (mdiff / mlim)[empty].max().item()
            check(mworst <= 1.0, f"K4 keyless queries not the mean of V: "
                  f"{merr}, {mworst:.3f} of the limit")
            del diff, mdiff, lim, mlim
            # the kernel's device time from graph replays, as K5's; the
            # wrapper's own pace (events around eager calls) beside it
            ms = graph_ms(lambda: causal_flash_attention(q, kk, vv, pos,
                                                         start), reps=10)
            wrapper_ms = cuda_ms(lambda: causal_flash_attention(
                q, kk, vv, pos, start), reps=5)
            plain_ms = cuda_ms(lambda: causal_attention_plain(
                q, kk.repeat_interleave(rep, dim=2),
                vv.repeat_interleave(rep, dim=2), pos, start), reps=3)
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kk, vv))
            mask = visible[:, None]

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=rep > 1)

            lib_ms = graph_ms(sdpa, reps=10)
            lib = sdpa().transpose(1, 2)
            lib_err = (lib.float() - got.float()).abs()[has_key].max().item()
            bms, by = _causal_bound(b, s, t, h, kh, d, pos, starts,
                                    q.element_size(), kind)
            rec = {"shape": _causal_shape(b, s, t, h, kh, pos, kind),
                   "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bms, "bound_by": by}
            log(f"K4 causal_fwd {rec['shape']}: err {err:.3g} (limit "
                f"{limit}; worst {worst:.3f} of it), keyless rows "
                f"{int(empty.sum())} = mean of V (err {merr:.3g}, "
                f"{mworst:.3f} of the limit); kernel {ms:.4f} ms (graph "
                f"replay; {wrapper_ms:.4f} ms a call through the wrapper), "
                f"plain {plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms (graph "
                f"replay; vs kernel on rows with keys: {lib_err:.3g}), "
                f"bound {bms:.4f} ms ({by}; {bms / ms:.1%} of it)")
            results.setdefault("causal_fwd", []).append(rec)
            del q, kk, vv, got, ref32, kr, vr, mean, qt, kt, vt, lib
            torch.cuda.empty_cache()


# K5 cases: (q tokens S, kv heads KH, pool storage, lengths).  B = 32
# rows of the continuous lane's batch at page 128 with P = 16 table
# entries (a 2048 window), H = 12, D = 64; the lengths are seeded in
# [1, 2047] with a dead row (0) and a row ending on a page boundary.
# The few-live case is the batch a decode step of `_step_costs` sees, 8
# live rows and 24 dead, with the live rows long (1500-2047), where the
# split over pages matters most.  The multi-query cases are a suffix
# prefill's bucket-64 stack on one row at length 700 and the speculative
# lane's verify stack, gamma + 1 = 5 tokens on each of the 32 rows.
PAGED_MAIN = "B=32 S=1 H=12 KH=12 page=128 P=16 bf16"


def _paged_lengths(b):
    lens = np.random.default_rng(17).integers(1, 2048, b)
    lens[5], lens[9] = 0, 1024
    return lens


def _few_live_lengths(b, live=8):
    lens = np.zeros(b, np.int64)
    lens[:live] = np.random.default_rng(19).integers(1500, 2048, live)
    return lens


PAGED_CASES = (
    (1, 12, "bf16", _paged_lengths(32)),
    (1, 12, "bf16", _few_live_lengths(32)),         # 8 live rows of 32
    (1, 12, "f32", _paged_lengths(32)),
    (1, 12, "int8", _paged_lengths(32)),
    (1, 12, "int4", _paged_lengths(32)),
    (1, 4, "bf16", _paged_lengths(32)),              # GQA 12/4
    (64, 12, "bf16", np.array([700])),               # multi-query stack
    (5, 12, "bf16", _paged_lengths(32)),             # spec verify stack
)


def _paged_inputs(s, kh, kind, lens, page=128, n_pages=16, h=12, d=64):
    """A pool of 1 + B * P blocks (the lane's 513 at B = 32), each row's
    pages distinct and shuffled, unused table entries at the trash
    block 0.  Queries bf16 except over f32 pools (the model's
    activations); quantized pools hold random codes and scales of unit
    magnitude."""
    import torch

    b = len(lens)
    g = torch.Generator(device="cuda").manual_seed(int(s + kh + len(kind)))
    n_blocks = 1 + b * n_pages
    shape = (n_blocks, kh, page, d // 2 if kind == "int4" else d)
    scales = None
    if kind in ("bf16", "f32"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        kp, vp = (torch.randn(shape, generator=g, device="cuda").to(dt)
                  for _ in range(2))
    else:
        lo, hi, dt, amp = ((-127, 128, torch.int8, 0.02) if kind == "int8"
                           else (0, 256, torch.uint8, 0.3))
        kp, vp = (torch.randint(lo, hi, shape, generator=g, device="cuda",
                                dtype=dt) for _ in range(2))
        scales = [torch.rand((n_blocks, kh), generator=g, device="cuda")
                  * amp + amp / 10 for _ in range(2)]
    perm = torch.randperm(n_blocks - 1, generator=g, device="cuda") + 1
    tables = perm.reshape(b, n_pages).to(torch.int32)
    need = torch.from_numpy(-(-(lens + s - 1) // page)).cuda()
    tables[torch.arange(n_pages, device="cuda")[None] >= need[:, None]] = 0
    qdt = torch.float32 if kind == "f32" else torch.bfloat16
    qshape = (b, h, d) if s == 1 else (b, s, h, d)
    q = torch.randn(qshape, generator=g, device="cuda").to(qdt)
    lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
    return q, kp, vp, scales, tables, lengths


def _paged_bound(lens, s, h, kh, d, page, n_pages, kind, qelt):
    """The least time for this run's inputs: the bytes of q, the output,
    the tables and lengths, each row's visible K/V (keys below
    length + S - 1) and, for quantized pools, the scales of the pages
    read; the FLOPs 4 D per (query, visible key) pair and head."""
    row_bytes = {"bf16": 2 * d, "f32": 4 * d, "int8": d, "int4": d // 2}
    vis = np.minimum(lens + s - 1, n_pages * page).clip(0)
    nbytes = 2.0 * vis.sum() * kh * row_bytes[kind]
    if kind in ("int8", "int4"):
        nbytes += 2.0 * (-(-vis // page)).sum() * kh * 4
    nbytes += 2.0 * len(lens) * s * h * d * qelt + len(lens) * (n_pages + 1) * 4
    pairs = sum(int(min(n + t, n_pages * page)) for n in lens
                for t in range(s) if n + t > 0)
    flops = 4.0 * d * h * pairs
    return bound(nbytes, flops, "f32" if kind == "f32" else "bf16")


def _paged_shape(lens, s, kh, kind, h=12):
    live = int((lens > 0).sum())
    return (f"B={len(lens)} S={s} H={h} KH={kh} page=128 P=16 {kind}"
            + (f" len={int(lens[0])}" if len(lens) == 1 else "")
            + (f" live={live}" if live < len(lens) - 1 else ""))


def phase_paged(results, cases=PAGED_CASES, h=12):
    import torch
    import torch.nn.functional as F

    from libsplinter_tpu_torch.ops.paged_attention import (
        _paged_plan, dequantize_pool, paged_attention, paged_attention_plain)

    page, n_pages, d = 128, 16, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for s, kh, kind, lens in cases:
        q, kp, vp, scales, tables, lengths = _paged_inputs(s, kh, kind, lens,
                                                           h=h)
        kw = {} if scales is None else {"k_scales": scales[0],
                                        "v_scales": scales[1]}
        got = paged_attention(q, kp, vp, tables, lengths, **kw)
        # f32 pools and queries: bf16 pools widened, quantized pools as
        # they are (the kernel dequantizes to f32 itself)
        fk, fv = (kp, vp) if scales else (kp.float(), vp.float())
        ref32 = paged_attention_plain(q.float(), fk, fv, tables, lengths,
                                      *(scales or ()))
        # the same launch in f32 holds the kernel to 1e-5: every storage
        # kind's dequantization, every tile of a long row, and the
        # multi-query stack (the bf16 launch alone is held to rounding)
        got32 = got if q.dtype == torch.float32 else paged_attention(
            q.float(), fk, fv, tables, lengths, **kw)
        torch.cuda.synchronize()

        def by_token(x):
            return x.float() if s > 1 else x.float()[:, None]

        g4, r4 = by_token(got), by_token(ref32.to(q.dtype))
        sees = (lengths.long()[:, None]
                + torch.arange(s, device="cuda")[None]) > 0      # (B, S)
        check(bool(torch.isfinite(g4[sees]).all()),
              f"K5 {kind}: non-finite output")
        diff = (g4[sees] - r4[sees]).abs()
        err = diff.max().item()
        if q.dtype == torch.float32:
            atol = f"{F32_ATOL}"
            check(err <= F32_ATOL, f"K5 {kind} S={s} KH={kh}: max err {err}")
        else:
            lim = BF16_ULP * by_token(ref32)[sees].abs() + F32_ATOL
            atol = "2^-7 |ref|"
            if kind == "bf16":
                lim += BF16_P_ROUND * by_token(paged_attention_plain(
                    q.float(), fk, fv.abs(), tables, lengths))[sees]
                atol += " + 2^-8 P|V|"
            worst = (diff / lim).max().item()
            check(worst <= 1.0, f"K5 {kind} S={s} KH={kh}: max err {err}, "
                  f"{worst:.3f} of its limit {atol}")
            atol += f" + {F32_ATOL}; worst {worst:.3f} of it"
        g32 = by_token(got32)
        err32 = (g32[sees] - by_token(ref32)[sees]).abs().max().item()
        check(err32 <= F32_ATOL,
              f"K5 {kind} S={s} KH={kh}, f32 queries: max err {err32}")
        dead = int((~sees).sum())
        check(bool((g4[~sees] == 0).all() and (g32[~sees] == 0).all()),
              "K5 dead rows not exactly 0")
        # the kernel's device time from graph replays; the wrapper's own
        # pace (its checks and allocations on the host) beside it
        ms = graph_ms(lambda: paged_attention(q, kp, vp, tables, lengths,
                                              **kw))
        wrapper_ms = cuda_ms(lambda: paged_attention(
            q, kp, vp, tables, lengths, **kw), reps=50)
        pps, splits = _paged_plan(len(lens), kh, n_pages, page, s, sms)
        plain_ms = cuda_ms(lambda: paged_attention_plain(
            q, kp, vp, tables, lengths, *(scales or ())), reps=3)

        # the yardstick: SDPA over a dense view gathered beforehand (the
        # gather, with the dequantization, timed on its own)
        def gather():
            ks, vs = kp, vp
            if scales:
                ks, vs = (dequantize_pool(p, sc).to(q.dtype)
                          for p, sc in zip((kp, vp), scales))
            t = tables.long()
            return [x[t].permute(0, 2, 1, 3, 4).reshape(
                len(lens), kh, n_pages * page, d) for x in (ks, vs)]

        gather_ms = graph_ms(gather, reps=5)
        kd, vd = gather()
        qt = (q[:, None] if s == 1 else q).transpose(1, 2)
        keys = torch.arange(n_pages * page, device="cuda")
        mask = (keys[None, None, :]
                < (lengths.long()[:, None, None]
                   + torch.arange(s, device="cuda")[None, :, None]))[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kd, vd, attn_mask=mask, enable_gqa=kh < h)

        lib_ms = graph_ms(sdpa)
        lib = sdpa().transpose(1, 2).float()
        lib_err = (lib[sees] - g4[sees]).abs().max().item()
        bms, by = _paged_bound(lens, s, h, kh, d, page, n_pages, kind,
                               q.element_size())
        rec = {"shape": _paged_shape(lens, s, kh, kind, h),
               "max_abs_err": err, "f32_query_err": err32, "ms": ms,
               "wrapper_ms": wrapper_ms, "splits": splits,
               "pages_per_split": pps, "plain_ms": plain_ms,
               "library_ms": lib_ms, "gather_ms": gather_ms,
               "bound_ms": bms, "bound_by": by}
        log(f"K5 paged_fwd {rec['shape']}: {splits} splits of {pps} "
            f"pages; err {err:.3g} (atol {atol}), f32 queries over "
            f"f32/quantized pools err {err32:.3g} (atol {F32_ATOL}), "
            f"{dead} dead query rows exactly 0; kernel {ms:.4f} ms (graph "
            f"replay; {wrapper_ms:.4f} ms a call through the wrapper), "
            f"plain {plain_ms:.3f} ms, sdpa on the gathered view "
            f"{lib_ms:.4f} ms (+ gather {gather_ms:.3f} ms; vs kernel "
            f"{lib_err:.3g}), bound {bms:.4f} ms ({by}; {bms / ms:.1%} of "
            f"it)")
        results.setdefault("paged_fwd", []).append(rec)
        del q, kp, vp, fk, fv, scales, got, got32, ref32, kd, vd, lib
        torch.cuda.empty_cache()


def _quantized_lane(n, d, seed):
    """Small integers over 4: every dot product and squared norm is
    exact in f32, so kernel and plain scores agree bit for bit and the
    top-k must be identical, ties included."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    vec = torch.randint(-4, 5, (n, d), generator=g, device="cuda",
                        dtype=torch.int8).float() / 4.0
    vec[n // 3] = vec[5]                     # exact duplicates of row 5
    vec[n - 1] = vec[5]
    vec[n // 2] = vec[5] * 2.0               # colinear: the same cosine
    vec[1000:3000] = 0.0                     # un-embedded (zero) rows
    mask = torch.ones(n, device="cuda")
    mask[5000:9000] = 0.0                    # filtered rows
    return vec, mask


def phase_search_kernels(results, n):
    import torch

    from libsplinter_tpu_torch.ops.similarity import (
        _cosine_scores_plain, _fused_topk_plain, cosine_scores_cuda,
        fused_topk_cuda)

    d = LANE_DIM
    g = torch.Generator(device="cuda").manual_seed(7)
    lane = torch.randn(n, d, generator=g, device="cuda")
    mask = (torch.rand(n, generator=g, device="cuda") > 0.01).float()
    # Q = 1 is the CLI's local search (exact and --fast); 8, 32 and 256
    # the searcher's query tiles
    for nq, bf16 in ((1, False), (1, True), (8, False), (32, False),
                     (256, False)):
        qry = torch.randn(nq, d, generator=g, device="cuda")
        got = cosine_scores_cuda(lane, qry, mask, mxu_bf16=bf16)
        ref = _cosine_scores_plain(lane, qry, mask, mxu_bf16=bf16)
        err = (got - ref).abs().max().item()
        check(err <= F32_ATOL, f"K3 Q={nq} mxu_bf16={bf16}: max err {err}")
        ms = cuda_ms(lambda: cosine_scores_cuda(lane, qry, mask,
                                                mxu_bf16=bf16), reps=10)
        plain_ms = cuda_ms(lambda: _cosine_scores_plain(
            lane, qry, mask, mxu_bf16=bf16), reps=5)

        def library():
            dots = torch.matmul(lane, qry.T)
            return dots / (torch.linalg.vector_norm(lane, dim=1,
                                                    keepdim=True)
                           * torch.linalg.vector_norm(qry, dim=1))

        lib_ms = cuda_ms(library, reps=5)
        nbytes = 4.0 * (n * d + nq * d + n + nq + n * nq)
        flops = 2.0 * n * d * nq + 2.0 * n * d
        bms, by = bound(nbytes, flops, "f32")
        shape = f"N={n} D={d} Q={nq} f32" + (" mxu_bf16" if bf16 else "")
        rec = {"shape": shape, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bms, "bound_by": by}
        log(f"K3 cosine_scores {rec['shape']}: err {err:.3g} (atol "
            f"{F32_ATOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"matmul+norms {lib_ms:.3f} ms, bound {bms:.3f} ms ({by}; "
            f"kernel at {bms / ms:.1%} of it)")
        results.setdefault("cosine_scores", []).append(rec)
        del got, ref
    del lane, mask
    torch.cuda.empty_cache()

    vec, mask = _quantized_lane(n, d, seed=11)
    for nq in (8, 32, 256):
        qry = torch.cat([vec[[5]], torch.randint(
            -4, 5, (nq - 1, d), generator=g, device="cuda",
            dtype=torch.int8).float() / 4.0])
        for k in (16, 128):
            gs, gi = fused_topk_cuda(vec, qry, k, mask)
            rs, ri = _fused_topk_plain(vec, qry, k, mask)
            torch.cuda.synchronize()
            check(torch.equal(gi, ri), f"K2 Q={nq} k={k}: rows differ")
            err = (gs - rs).abs().max().item()
            check(err == 0.0, f"K2 Q={nq} k={k}: score err {err}")
            check(gi[0, :4].tolist() == [5, n // 3, n // 2, n - 1],
                  f"K2 ties: {gi[0, :4].tolist()}")
            reps = 5 if nq < 256 else 2
            ms = cuda_ms(lambda: fused_topk_cuda(vec, qry, k, mask),
                         reps=reps)
            plain_ms = cuda_ms(
                lambda: _fused_topk_plain(vec, qry, k, mask), reps=2)
            lib_ms = cuda_ms(lambda: torch.topk(
                torch.matmul(qry, vec.T), k, dim=1), reps=reps)
            nbytes = 4.0 * (n * d + nq * d + n + nq) + 8.0 * nq * k
            flops = 2.0 * n * d * nq + 2.0 * n * d
            bms, by = bound(nbytes, flops, "f32")
            rec = {"shape": f"N={n} D={d} Q={nq} k={k} f32",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}
            log(f"K2 fused_topk {rec['shape']}: rows identical, err "
                f"{err}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"matmul+topk {lib_ms:.3f} ms, bound {bms:.3f} ms ({by}; "
                f"kernel at {bms / ms:.1%} of it)")
            results.setdefault("fused_topk", []).append(rec)
    # fewer candidates than k: (NEG_INF, -1) filler, identical rows
    few = torch.zeros(n, device="cuda")
    few[123456:123456 + 50] = 1.0
    qry = vec[[5, 77, 99, 1234, 4321, 7, 8, 9]]
    gs, gi = fused_topk_cuda(vec, qry, 128, few)
    rs, ri = _fused_topk_plain(vec, qry, 128, few)
    check(torch.equal(gi, ri) and torch.equal(gs, rs),
          "K2 filler case differs from plain")
    check(bool((gi[:, 50:] == -1).all()), "K2 filler rows not -1")
    log("K2 fused_topk fewer-than-k case: 50 candidates, k=128: filler "
        "(-1e30, -1) identical to plain")
    del vec, mask, few
    torch.cuda.empty_cache()


# -- phase 4: the lane ---------------------------------------------------------

def _texts(rng):
    """~64 texts whose token counts (words + [CLS] + [SEP]) cover the
    buckets 16..2048; twins are exact duplicates under another key.
    Bucket 2048 holds 8 rows and bucket 512 holds 32, the shapes of
    phase 3's K1 checks."""
    words = ["".join(rng.choice(list("abcdefghij"), int(rng.integers(1, 3))))
             for _ in range(400)]

    def text(ntok):
        return " ".join(rng.choice(words, ntok - 2))

    out = {}
    spans = [(1100, 1800)] * 7 + [(600, 1000)] * 4 + [(300, 500)] * 31 \
        + [(8, 14), (20, 30), (40, 60), (70, 120), (140, 250)] * 4
    for i, (lo, hi) in enumerate(spans):
        out[f"text/{i:02d}"] = text(int(rng.integers(lo, hi)))
    twins = {"twin/a": "text/00", "twin/b": "text/11", "twin/c": "text/42",
             "twin/d": "text/45"}
    for twin, src in twins.items():
        out[twin] = out[src]
    return out, twins


def _fill_lane(st, n_syn, seed):
    import torch

    for i in range(n_syn):
        st.set(f"syn/{i}", b"s")
    eps = st.epochs()
    rows = np.nonzero(eps)[0].astype(np.uint32)
    g = torch.Generator(device="cuda").manual_seed(seed)
    chunk = 1 << 17
    for lo in range(0, rows.size, chunk):
        r = rows[lo:lo + chunk]
        v = torch.randn(r.size, LANE_DIM, generator=g, device="cuda")
        v /= torch.linalg.vector_norm(v, dim=1, keepdim=True)
        res = st.vec_commit_batch(r, eps[r], v.cpu().numpy())
        check(bool((res == 0).all()), "synthetic vector commit raced")
    return rows.size


def _plain_topk_keys(st, lane, q, mask, k_fetch, k):
    """The plain top-k on the card, filtered as the searcher's commit
    filters: (rows, scores) of the first k keyed, non-system rows."""
    import torch

    from libsplinter_tpu_torch.ops.similarity import (_cosine_scores_plain,
                                                      _stable_topk)

    s = _cosine_scores_plain(lane, torch.from_numpy(q[None]).cuda(), mask)
    ts, ti = _stable_topk(s.T, k_fetch)
    rows, scores = [], []
    for score, idx in zip(ts[0].tolist(), ti[0].tolist()):
        if score <= -1e29 or len(rows) >= k:
            break
        key = st.key_at(int(idx))
        if key is None or key.startswith("__"):
            continue
        rows.append(int(idx))
        scores.append(score)
    return rows, scores, ts[0].cpu().numpy(), ti[0].cpu().numpy()


def _same_ranking(got_rows, got_scores, want_rows, all_s, all_i):
    """Rows equal position by position, except where two candidates
    score within 2e-6 (kernel and plain sums round differently there);
    returns the number of such near-tie swaps, raises otherwise."""
    score_of = {int(i): float(s) for s, i in zip(all_s, all_i)}
    swaps = 0
    check(len(got_rows) == len(want_rows),
          f"result length {len(got_rows)} != plain {len(want_rows)}")
    for g, w, gs in zip(got_rows, want_rows, got_scores):
        if g == w:
            continue
        check(g in score_of and abs(score_of[g] - score_of[w]) <= 2e-6,
              f"row {g} (score {gs}) where plain has {w}")
        swaps += 1
    for g, gs in zip(got_rows, got_scores):
        check(abs(score_of[g] - gs) <= 2e-6, f"row {g} score {gs} vs "
              f"plain {score_of[g]}")
    return swaps


def phase_lane(nslots, card, timings, keep):
    """Phase 4 over a new file-backed store in the directory `keep`; the
    file stays there for phase 13 when the phase passes."""
    import torch

    from libsplinter_tpu_torch import T_VARTEXT, Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.engine.searcher import (Searcher,
                                                       consume_result,
                                                       submit_search)
    from libsplinter_tpu_torch.models import EmbeddingModel, EncoderConfig
    from libsplinter_tpu_torch.ops import _cuda

    path = os.path.join(keep, "lane.spt")
    st = None
    searcher = None
    stop = threading.Event()
    ok = False
    try:
        t0 = time.perf_counter()
        st = Store.create(path, nslots=nslots, max_val=8192,
                          vec_dim=LANE_DIM, persistent=True)
        n_syn = int(nslots * 0.9537)                 # 1,000,000 at 1 Mi
        n_syn = _fill_lane(st, n_syn, seed=3)
        st.drain_dirty()     # the synthetic rows are no embed requests
        setup_s = time.perf_counter() - t0
        log(f"lane: file-backed store, {nslots} slots x {LANE_DIM}-d, "
            f"{n_syn} synthetic unit vectors committed in {setup_s:.1f}s")

        cfg = EncoderConfig(out_dim=LANE_DIM, max_len=2048)
        t0 = time.perf_counter()
        model = EmbeddingModel(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"model: EncoderConfig() full width, bf16, seeded, built in "
            f"{time.perf_counter() - t0:.2f}s")
        emb = Embedder(st, model=model, max_ctx=2048)
        emb.attach()
        rng = np.random.default_rng(0)
        texts, twins = _texts(rng)
        for key, text in texts.items():
            st.set(key, text)
            st.set_type(key, T_VARTEXT)
            st.label_or(key, P.LBL_EMBED_REQ)
            st.bump(key)

        _cuda.LAUNCHES.reset()                       # the main path
        t0 = time.perf_counter()
        n = emb.run_once()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        check(n == len(texts), f"embedded {n} of {len(texts)}")
        log(f"embed drain, cold: {n} requests in {drain_s:.3f}s = "
            f"{n / drain_s:.1f} embeddings/s, buckets "
            f"{sorted(model._shapes)} [{card}] (first reading)")
        timings["embed"] = {"requests": n, "drain_s": drain_s,
                            "embeddings_per_s": n / drain_s}
        for key in texts:
            idx = st.find_index(key)
            v = st.vec_get(key)
            check(abs(float(np.linalg.norm(v)) - 1.0) < 1e-4,
                  f"{key}: norm {np.linalg.norm(v)}")
            check(not st.labels(key) & (P.LBL_EMBED_REQ | P.LBL_WAITING),
                  f"{key}: labels not cleared")
            e = st.epoch_at(idx)
            check(e % 2 == 0 and emb._known_epochs.get(idx) == e,
                  f"{key}: epoch {e} not current")
        for twin, src in twins.items():
            check(np.array_equal(st.vec_get(twin), st.vec_get(src)),
                  f"{twin} differs from {src}")
        # the same texts rewritten (a rewrite is a new request) and
        # drained again: once timed warm, once under torch.profiler to
        # see where the drain's device time goes
        _requeue(st, P, texts)
        t0 = time.perf_counter()
        check(emb.run_once() == len(texts), "warm drain")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        log(f"embed drain, warm: {n} requests in {warm_s:.3f}s = "
            f"{n / warm_s:.1f} embeddings/s [{card}] (first reading)")
        timings["embed_warm"] = {"drain_s": warm_s,
                                 "embeddings_per_s": n / warm_s}
        _requeue(st, P, texts)
        timings["profile"] = _profile_drain(emb.run_once, len(texts), warm_s,
                                        card)

        # the same model, moved to the CPU in f32 (the plain path)
        cpu_cfg = EncoderConfig(out_dim=LANE_DIM, max_len=2048,
                                dtype=torch.float32)
        state = {k: v.float().cpu()
                 for k, v in model.module.state_dict().items()}
        cpu_model = EmbeddingModel(cpu_cfg, params=state, device="cpu")
        for key in ("text/03", "text/09", "text/20", "text/60"):
            ids, lens = emb._tok.encode_batch([texts[key]], 2048)
            b = cpu_model.bucket_for(int(lens[0]))
            ref = cpu_model.encode_ids(ids[:, :b], lens)[0]
            got = st.vec_get(key)
            cos = float(got @ ref / np.linalg.norm(ref))
            err = float(np.abs(got - ref).max())
            log(f"cpu f32 check {key} ({int(lens[0])} tokens, bucket "
                f"{b}): cosine {cos:.6f}, max abs err {err:.4g}")
            check(cos >= 0.99, f"{key}: bf16 card vs f32 cpu cosine {cos}")

        # searches: k=10 (K2) and k=200 (K3 + stable sort)
        searcher = Searcher(st, device="cuda")
        searcher.attach()
        queries = {}
        for j, (twin, src) in enumerate(twins.items()):
            key = f"__q/{j}"
            st.set(key, "q")
            st.vec_set(key, st.vec_get(src))
            queries[key] = (src, twin)

        def drain_loop():
            while not stop.is_set():
                searcher.run_once()
                time.sleep(0.002)

        drainer = threading.Thread(target=drain_loop, daemon=True)
        drainer.start()
        search = {}
        for k in (10, 200):
            recs = {}

            def client(key, k=k, recs=recs):
                recs[key] = submit_search(st, key, k,
                                          timeout_ms=phase_left() * 1000)

            t0 = time.perf_counter()
            clients = [threading.Thread(target=client, args=(key,))
                       for key in queries]
            for c in clients:
                c.start()
            for c in clients:
                c.join(timeout=phase_left())
            wall = time.perf_counter() - t0
            check(all(not c.is_alive() for c in clients),
                  "search clients did not finish")
            search[k] = (recs, wall)
            log(f"search k={k}: {len(recs)} requests in {wall:.3f}s wall "
                f"(first includes the lane's full upload) [{card}]")
        stop.set()
        drainer.join(timeout=60)
        check(not drainer.is_alive(), "searcher thread did not stop")
        counts = dict(_cuda.LAUNCHES)

        lane = searcher.lane.array
        base = torch.from_numpy(P.candidate_mask(st, 0)).cuda()
        for idx in (st.find_index(key) for key in queries):
            base[idx] = 0.0
        swaps = 0
        for k, (recs, _) in search.items():
            k_fetch = 16 if k == 10 else 204
            for key, (src, twin) in queries.items():
                rec = recs.get(key)
                check(rec is not None and "err" not in rec,
                      f"search {key} k={k}: {rec}")
                check(len(rec["keys"]) == k, f"{key}: {len(rec['keys'])}")
                check(set(rec["keys"][:2]) == {src, twin},
                      f"{key}: first two {rec['keys'][:2]}")
                want, _, all_s, all_i = _plain_topk_keys(
                    st, lane, st.vec_get(src), base, k_fetch, k)
                swaps += _same_ranking(rec["i"], rec["s"], want, all_s,
                                       all_i)
                consume_result(st, key)
        log(f"search results: rows equal the plain top-k on the card "
            f"({swaps} swaps of candidates scoring within 2e-6)")
        timings["search"] = {k: w for k, (_, w) in search.items()}
        timings["setup_s"] = setup_s
        timings["n_syn"] = n_syn
        ok = True
        return counts
    finally:
        stop.set()
        if st is not None:
            st.close()
            if not ok:
                Store.unlink(path, persistent=True)


def _kernel_class(name: str) -> str:
    if "flash_fwd_" in name:
        return "K1 flash_fwd"
    if "causal_fwd_" in name:           # the bf16 mma and f32 FMA kernels
        return "K4 causal_fwd"
    if "paged_fwd_kernel" in name or "paged_combine_kernel" in name:
        return "K5 paged_fwd"
    if any(t in name for t in ("bwd_rowsum_", "bwd_dkdv_", "bwd_dq_")):
        return "K6 flash_bwd"
    # before the GEMM names: a K2 or K3 kernel may carry "gemm" in its own
    if "topk_partial_kernel" in name or "topk_merge_kernel" in name:
        return "K2 fused_topk"
    if "cosine_scores_kernel" in name:
        return "K3 cosine_scores"
    if "multi_tensor_apply" in name:
        return "optimizer (foreach AdamW)"
    if any(t in name for t in ("gemm", "cutlass", "sm90_", "cublas",
                               "nvjet")):
        return "GEMM (cuBLAS)"
    if "Memcpy" in name or "Memset" in name:
        return "copies"
    return "other (elementwise, norms, reductions)"


def _requeue(st, P, texts):
    for key, text in texts.items():
        st.set(key, text)
        st.label_or(key, P.LBL_EMBED_REQ)
        st.bump(key)


def _profile_sums(prof) -> tuple[dict, dict, dict]:
    """Device ms by kernel class, by kernel name and by the aten op that
    launched the kernel, read from the raw trace: prof.events() and
    key_averages() build a Python event tree, minutes for a drain's
    ~10^6 events.  A device event's linked_correlation_id is the
    correlation id of the CPU op that launched it; each kernel is
    charged to that op only (key_averages()' self device time charges by
    its own rule, so the op sums are a reading, not its numbers)."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    op_names = {e.correlation_id(): e.name() for e in events
                if e.device_type() != cuda}
    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    by_op: dict[str, float] = {}
    for evt in events:
        if evt.device_type() != cuda:
            continue
        name, ms = evt.name(), evt.duration_ns() / 1e6
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        by_name[name] = by_name.get(name, 0.0) + ms
        op = op_names.get(evt.linked_correlation_id(), "")
        if op.startswith("aten::"):
            by_op[op] = by_op.get(op, 0.0) + ms
    return by_class, by_name, by_op


def _check_profile_sums(drive, card) -> dict:
    """_profile_sums against torch.profiler's own event tree on one
    profiled run of `drive`: the class and kernel sums equal within
    1e-6 ms; both walls.  The op sums are printed beside
    key_averages()' self device time, held to no limit: the two charge
    a kernel to an op by different rules."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = _profile_sums(prof)
    raw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            cls = _kernel_class(evt.name)
            by_class[cls] = by_class.get(cls, 0.0) + evt.device_time / 1e3
            by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                 + evt.device_time / 1e3)
    by_op = {e.key: e.self_device_time_total / 1e3
             for e in prof.key_averages() if e.key.startswith("aten::")}
    tree_s = time.perf_counter() - t0

    def worst(a, b):
        return max(abs(a.get(k, 0.0) - b.get(k, 0.0)) for k in {*a, *b})

    busy = sum(by_class.values())
    errs = [worst(x, y) for x, y in zip(sums, (by_class, by_name, by_op))]
    check(busy > 0 and errs[0] <= 1e-6 and errs[1] <= 1e-6,
          f"profile sums from the raw trace differ from the event tree's: "
          f"class {errs[0]}, kernel {errs[1]} ms of {busy}")
    log(f"profile sums from the raw trace: {raw_s:.3f}s against the event "
        f"tree's {tree_s:.3f}s on one step ({busy:.2f} ms of device "
        f"time); class and kernel sums within {max(errs[:2]):.2g} ms (limit "
        f"1e-6); op sums {errs[2]:.4g} ms from key_averages()' self time "
        f"({errs[2] / busy:.3g} of busy, no limit) [{card}]")
    return {"raw_s": raw_s, "tree_s": tree_s, "busy_ms": busy,
            "class_err_ms": errs[0], "kernel_err_ms": errs[1],
            "op_gap_ms": errs[2]}


def _profile_drain(drive, n_texts, warm_s, card):
    """Run `drive` (one drain of a lane, returning the requests it
    served) under torch.profiler and sum the device time of each kernel
    by class; returns the summary (device ms per class, and as a share
    of the unprofiled warm drain's wall `warm_s`) or
    {"not_measured": reason}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = drive()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(n == n_texts, f"profiled drain served {n} of {n_texts}")
    by_class, by_name, by_op = _profile_sums(prof)
    busy = sum(by_class.values())
    if busy <= 0:
        log("profiled drain: the profiler saw no device time (not "
            "measured)")
        return {"not_measured": "no device events"}
    log(f"profiled drain: {n} requests, wall {wall_ms:.1f} ms with the "
        f"profiler on; device busy {busy:.1f} ms = "
        f"{100 * busy / (warm_s * 1e3):.1f}% of the unprofiled warm "
        f"drain's {warm_s * 1e3:.1f} ms [{card}]")
    for cls, ms in sorted(by_class.items(), key=lambda x: -x[1]):
        log(f"  {cls}: {ms:.2f} ms ({100 * ms / busy:.1f}% of device)")
    for name, ms in sorted(by_name.items(), key=lambda x: -x[1])[:6]:
        log(f"  top kernel {ms:8.2f} ms  {name[:90]}")
    # the PyTorch operators whose own launches took that time
    for op, ms in sorted(by_op.items(), key=lambda x: -x[1])[:6]:
        log(f"  top operator {ms:8.2f} ms  {op}")
    return {"wall_ms": wall_ms, "device_ms": busy,
            "by_class_ms": by_class}


# -- phase 5: the completion lane ---------------------------------------------

def _prompts(rng):
    """8 prompts of 40-900 bytes (one bucket-1024 batch after BOS) and
    one of ~1500 bytes for the serial path's bucket 2048."""
    words = ["".join(rng.choice(list("abcdefghijklmnop"),
                                int(rng.integers(2, 8))))
             for _ in range(300)]

    def text(nbytes):
        out = ""
        while len(out) < nbytes:
            out += rng.choice(words) + " "
        return out[:nbytes]

    batch = {f"ask/{i}": text(n) for i, n in
             enumerate((40, 130, 260, 390, 520, 650, 780, 900))}
    return batch, ("ask/serial", text(1500))


def _ask(st, P, prompts):
    for key, text in prompts.items():
        st.set(key, text)
        st.label_or(key, P.LBL_INFER_REQ | P.LBL_WAITING)
        st.bump(key)


def _piece_tokenizer():
    """The byte tokenizer, with every id past its 259-entry table folded
    onto a byte: with random weights over 32,000 ids almost no sampled
    token would otherwise stream a byte, and the check below could not
    see a completion land."""
    from libsplinter_tpu_torch.models import ByteTokenizer

    class PieceTokenizer(ByteTokenizer):
        # no id ends a completion early, so every request streams exactly
        # max_new_tokens and a lane's token count is known in advance
        eos_id = -1

        def token_to_piece(self, tok: int) -> bytes:
            return bytes([(tok - 3) % 256]) if tok >= 3 else b""

    return PieceTokenizer()


def _check_served(st, P, prompts):
    """Every key READY with SERVICING and the request labels cleared,
    its slot holding the rendered prompt (template none: the prompt)
    with the completion appended after it."""
    for key, text in prompts.items():
        labels = st.labels(key)
        check(labels & P.LBL_READY, f"{key}: not READY")
        check(not labels & (P.LBL_SERVICING | P.LBL_INFER_REQ
                            | P.LBL_WAITING), f"{key}: labels {labels:#x}")
        got = st.get(key).rstrip(b"\0")
        check(got.startswith(text.encode()), f"{key}: prompt not kept")
        check(len(got) > len(text), f"{key}: no completion appended")


def phase_completion(card, timings):
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig
    from libsplinter_tpu_torch.ops import _cuda

    name = f"/spt-smoke-c{os.getpid()}"
    st = None
    try:
        st = Store.create(name, nslots=256, max_val=8192, vec_dim=0)
        cfg = DecoderConfig()
        t0 = time.perf_counter()
        model = CompletionModel(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"decoder: DecoderConfig() full width (12 layers, hidden 768, "
            f"vocab {cfg.vocab_size}, bf16, seeded), buckets "
            f"{model.buckets}, built in {time.perf_counter() - t0:.2f}s")
        comp = Completer(st, model=model, tokenizer=_piece_tokenizer(),
                         template="none")
        comp.attach()
        rng = np.random.default_rng(5)
        batch, (skey, stext) = _prompts(rng)
        _ask(st, P, batch)

        _cuda.LAUNCHES.reset()                       # the main path
        t0 = time.perf_counter()
        n = comp.run_once()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        tokens = comp.stats.tokens
        check(n == len(batch), f"served {n} of {len(batch)}")
        check(_cuda.LAUNCHES["causal_fwd"] == cfg.layers,
              f"K4 launches in the bucket-1024 drain: "
              f"{_cuda.LAUNCHES['causal_fwd']} != {cfg.layers}")
        st.set(skey, stext)
        st.label_or(skey, P.LBL_INFER_REQ | P.LBL_WAITING)
        st.bump(skey)
        t0 = time.perf_counter()
        check(comp.process_key(st.find_index(skey)), "serial request")
        torch.cuda.synchronize()
        serial_s = time.perf_counter() - t0
        counts = dict(_cuda.LAUNCHES)
        check(counts["causal_fwd"] == 2 * cfg.layers,
              f"K4 launches after the bucket-2048 request: {counts}")
        check(comp.stats.completions == len(batch) + 1, "completions")
        _check_served(st, P, {**batch, skey: stext})
        serial_tok = comp.stats.tokens - tokens
        log(f"completion drain, cold: {n} requests, {tokens} tokens in "
            f"{drain_s:.3f}s = {tokens / drain_s:.1f} tokens/s "
            f"(bucket 1024, batch 8, incl. prefill) [{card}] (first "
            f"reading)")
        log(f"serial request: {len(stext)} bytes, bucket 2048, "
            f"{serial_tok} tokens in {serial_s:.3f}s [{card}]")
        timings["complete"] = {"requests": n, "tokens": tokens,
                               "drain_s": drain_s,
                               "tokens_per_s": tokens / drain_s,
                               "serial_s": serial_s,
                               "serial_tokens": serial_tok}

        _ask(st, P, batch)
        t0 = time.perf_counter()
        check(comp.run_once() == len(batch), "warm drain")
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        warm_tok = comp.stats.tokens - tokens - serial_tok
        log(f"completion drain, warm: {warm_tok} tokens in {warm_s:.3f}s "
            f"= {warm_tok / warm_s:.1f} tokens/s [{card}] (first reading)")
        timings["complete_warm"] = {"drain_s": warm_s, "tokens": warm_tok,
                                    "tokens_per_s": warm_tok / warm_s}
        _ask(st, P, batch)
        timings["complete_profile"] = _profile_drain(
            comp.run_once, len(batch), warm_s, card)

        # K4 in the whole model: the same weights with the plain
        # attention on every prefill
        ids = [np.asarray(comp._tok.encode(t), np.int32)
               for t in batch.values()]
        plain = CompletionModel(dataclasses.replace(cfg, flash_min_seq=0),
                                params=model.module.state_dict(),
                                device="cuda")
        got = model.prefill_batch(ids)
        want = plain.prefill_batch(ids)
        model.reset()
        plain.reset()
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        err = float(np.abs(got - want).max())
        check(np.isfinite(got).all(), "non-finite prefill logits")
        check(float(cos.min()) >= 0.999,
              f"bf16 prefill logits, K4 vs plain attention: cosine "
              f"{cos.min()}")
        log(f"bucket-1024 prefill logits, K4 vs flash_min_seq=0 (bf16, "
            f"same weights): min cosine {cos.min():.6f}, max abs err "
            f"{err:.4g}")
        timings["complete_logits"] = {"min_cosine": float(cos.min()),
                                      "max_abs_err": err}
        return counts
    finally:
        if st is not None:
            st.close()
            Store.unlink(name)


# -- phase 6: the continuous completion lane ----------------------------------

def _continuous_prompts(rng):
    """48 requests: 24 distinct prompts of 40-1500 bytes (one of 767
    bytes: with BOS exactly 6 pages of 128 tokens), 22 sharing one
    700-byte prefix then 20-200 bytes of their own, and 2 exact repeats
    of the 767-byte prompt (full-cover prefix hits).  Wave 1 and wave 2
    hold 24 each; the repeats and half of each family are in wave 2."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                int(rng.integers(2, 9))))
             for _ in range(500)]

    def text(nbytes):
        out = ""
        while len(out) < nbytes:
            out += rng.choice(words) + " "
        return out[:nbytes]

    distinct = [text(int(n)) for n in rng.integers(40, 1501, 23)]
    page_exact = text(767)
    prefix = text(700)
    shared = [prefix + text(int(n)) for n in rng.integers(20, 201, 22)]
    wave1 = {f"d/{i:02d}": t for i, t in enumerate(distinct[:12])}
    wave1["d/page6"] = page_exact
    wave1.update({f"s/{i:02d}": t for i, t in enumerate(shared[:11])})
    wave2 = {f"d/{i:02d}": t for i, t in enumerate(distinct[12:], 12)}
    wave2.update({f"s/{i:02d}": t for i, t in enumerate(shared[11:], 11)})
    wave2.update({"r/0": page_exact, "r/1": page_exact})
    return wave1, wave2


def _drive_continuous(comp, st, P, waves):
    """Queue waves[0], run the continuous lane on this thread (the
    profiler sees its operators), queue each later wave once the lane
    streams into the previous one, and stop the lane when every key is
    READY, or at the phase's deadline.  Returns (requests served, wall
    seconds to the last READY)."""
    keys = [k for w in waves for k in w]
    done = {}
    t0 = time.perf_counter()
    deadline = time.monotonic() + phase_left()

    def feeder():
        for prev, wave in zip(waves, waves[1:]):
            first = next(iter(prev))
            while time.monotonic() < deadline and \
                    st.value_len(first) <= len(prev[first]):
                time.sleep(0.005)
            _ask(st, P, wave)
        busy = P.LBL_INFER_REQ | P.LBL_WAITING | P.LBL_SERVICING
        while time.monotonic() < deadline:
            # READY and no longer asked for (a re-asked key keeps the
            # READY bit of its previous round until it is claimed)
            if all(st.labels(k) & P.LBL_READY and not st.labels(k) & busy
                   for k in keys):
                done["wall"] = time.perf_counter() - t0
                break
            time.sleep(0.01)
        comp.stop()

    _ask(st, P, waves[0])
    th = threading.Thread(target=feeder, daemon=True)
    th.start()
    comp.run_continuous(idle_timeout_ms=20, stop_after=phase_left())
    th.join(timeout=60)
    check("wall" in done, f"continuous lane served {comp.stats.completions}"
          f" of {len(keys)} before the time limit")
    return len(keys), done["wall"]


def _check_no_abort(comp, tokens, n_req, what):
    """The lane caught no failure (a model error inside run_continuous
    finalizes its live rows READY and rebuilds the pool, so READY keys
    alone do not show it) and streamed every request's full budget: the
    smoke's tokenizer has no EOS and no prompt reaches the window's
    edge."""
    check(comp.stats.aborts == 0 and comp.stats.faults == 0,
          f"{what}: {comp.stats.aborts} lane aborts, {comp.stats.faults} "
          f"key faults")
    want = n_req * comp.max_new
    check(tokens == want, f"{what}: {tokens} tokens streamed, {want} due")


def _pool_bytes(cfg, n_blocks, kv_dtype):
    """The paged pool's bytes from its geometry: values (int4 packs two
    codes per byte) plus the quantized pools' (n_blocks, KH) f32 scales,
    k and v, every layer."""
    per = {"bf16": 2.0, "f32": 4.0, "int8": 1.0, "int4": 0.5}[kv_dtype]
    vals = n_blocks * cfg.kv_heads * 128 * cfg.head_dim * per
    scales = n_blocks * cfg.kv_heads * 4 if kv_dtype in ("int8", "int4") \
        else 0
    return 2 * cfg.layers * (vals + scales)


def _step_costs(model, kv_dtype, ids):
    """Host wall (the lane is host-bound) of one paged decode step with 8
    live rows of 32, and of one 64-token suffix stack over a mapped
    512-token prefix, for one pool storage."""
    import torch

    cache = model.init_paged(32, kv_dtype=kv_dtype)
    for r in range(8):
        model.paged_prefill_row(cache, ids[:500 + r], r)
    model.paged_decode_chunk(cache, np.ones(32, np.int64), 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        model.paged_decode_chunk(cache, np.ones(32, np.int64), 8)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 24 * 1e3
    cache.map_shared(9, [int(b) for b in cache.tables[0, :4]])
    cache.lengths[9] = 512
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.paged_append_prefill(cache, ids[:64], 9)
    torch.cuda.synchronize()
    suffix_ms = (time.perf_counter() - t0) * 1e3
    return step_ms, suffix_ms


def phase_continuous(card, timings):
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig
    from libsplinter_tpu_torch.ops import _cuda
    from libsplinter_tpu_torch.ops.paged_attention import (
        LAUNCHES_BY_QTOKENS, LAUNCHES_BY_SPLITS)

    name = f"/spt-smoke-p{os.getpid()}"
    st = None
    try:
        st = Store.create(name, nslots=512, max_val=8192, vec_dim=0)
        cfg = DecoderConfig()
        model = CompletionModel(cfg, seed=0, device="cuda")
        comp = Completer(st, model=model, tokenizer=_piece_tokenizer(),
                         template="none", max_new_tokens=128)
        comp.attach()
        check(comp.paged_batch_cap == 32 and comp.page_size == 128
              and comp.inflight_depth == 2 and comp._prefix_enabled,
              "the lane's defaults changed")
        wave1, wave2 = _continuous_prompts(np.random.default_rng(9))

        _cuda.LAUNCHES.reset()                       # the main path
        LAUNCHES_BY_QTOKENS.clear()
        LAUNCHES_BY_SPLITS.clear()
        n, wall = _drive_continuous(comp, st, P, [wave1, wave2])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        by_q = dict(LAUNCHES_BY_QTOKENS)
        by_split = dict(LAUNCHES_BY_SPLITS)
        combines = sum(v for k, v in by_split.items() if k > 1)
        tokens = comp.stats.tokens
        cache, pc = comp._paged_cache, comp.prefix_cache
        check(comp.stats.completions == n == 48,
              f"continuous lane: {comp.stats.completions} of 48 served")
        _check_no_abort(comp, tokens, n, "continuous lane")
        _check_served(st, P, {**wave1, **wave2})
        check(by_q.get(1, 0) > 0, f"K5 never launched on decode: {by_q}")
        check(sum(v for k, v in by_q.items() if k > 1) > 0,
              f"K5 never launched on a suffix prefill: {by_q}")
        check(combines > 0, f"K5 never split a row's pages: {by_split}")
        check(pc.stats.hits >= 20, f"prefix hits {pc.stats.hits} < 20")
        check(pc.stats.cow_copies >= 2, f"COW copies {pc.stats.cow_copies}")
        check(cache.used_pages == 0 and pc.shared_pages() == 0,
              f"pages leaked: {cache.used_pages} used after stop")
        want_mb = round(_pool_bytes(cfg, cache.n_blocks, "bf16") / 1e6, 3)
        check(cache.n_blocks == 513 and cache.device_mb() == want_mb,
              f"pool {cache.device_mb()} MB, computed {want_mb} MB")
        log(f"continuous lane, cold: 48 requests in two waves, {tokens} "
            f"tokens in {wall:.3f}s = {tokens / wall:.1f} tokens/s "
            f"(prefill included; 32 rows, page 128, 513 blocks, pool "
            f"{cache.device_mb():.1f} MB bf16) [{card}] (first reading)")
        log(f"  prefix cache: {pc.stats.hits} hits, {pc.stats.misses} "
            f"misses, {pc.stats.hit_tokens} tokens served from the tree, "
            f"{pc.stats.cow_copies} COW copies; K5 launches by query "
            f"tokens {by_q}, by splits {by_split} ({combines} of them ran "
            f"the combine kernel too); K4 launches {counts['causal_fwd']} "
            f"(prefills of 512 tokens and up); join backpressure "
            f"{comp.stats.join_backpressure}, inflight peak "
            f"{comp.stats.inflight_peak}")
        timings["continuous"] = {
            "requests": n, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall, "prefix_hits": pc.stats.hits,
            "cow_copies": pc.stats.cow_copies, "k5_by_q_tokens": by_q,
            "k5_by_splits": by_split, "k5_combines": combines,
            "pool_mb": cache.device_mb()}

        # warm: 8 of the requests again, then the same under the
        # profiler (the lane runs on this thread)
        warm = {k: t for k, t in list(wave1.items())[:4]
                + list(wave2.items())[:4]}
        t_before = comp.stats.tokens
        _, warm_s = _drive_continuous(comp, st, P, [warm])
        warm_tok = comp.stats.tokens - t_before
        _check_no_abort(comp, warm_tok, len(warm), "continuous lane, warm")
        log(f"continuous lane, warm: {len(warm)} requests, {warm_tok} "
            f"tokens in "
            f"{warm_s:.3f}s = {warm_tok / warm_s:.1f} tokens/s [{card}]")
        timings["continuous_warm"] = {"wall_s": warm_s, "tokens": warm_tok,
                                      "tokens_per_s": warm_tok / warm_s}
        timings["continuous_profile"] = _profile_drain(
            lambda: _drive_continuous(comp, st, P, [warm])[0], len(warm),
            warm_s, card)
        _check_no_abort(comp, comp.stats.tokens - t_before - warm_tok,
                        len(warm), "continuous lane, profiled")
        comp._paged_cache = None
        torch.cuda.empty_cache()

        for kvd in ("int8", "int4"):
            qst = Store.create(f"{name}{kvd}", nslots=128, max_val=8192,
                               vec_dim=0)
            try:
                qc = Completer(qst, model=model, tokenizer=_piece_tokenizer(),
                               template="none", max_new_tokens=128,
                               kv_dtype=kvd)
                qc.attach()
                some = {k: t for k, t in list(wave1.items())[:2]
                        + list(wave1.items())[-2:]}
                _cuda.LAUNCHES.reset()
                LAUNCHES_BY_QTOKENS.clear()
                _, qwall = _drive_continuous(qc, qst, P, [some])
                torch.cuda.synchronize()
                q_by = dict(LAUNCHES_BY_QTOKENS)
                check(_cuda.LAUNCHES["paged_fwd"] > 0 and q_by.get(1, 0) > 0,
                      f"{kvd}: K5 never launched on decode: {q_by}")
                _check_no_abort(qc, qc.stats.tokens, len(some),
                                f"continuous lane, kv_dtype {kvd}")
                _check_served(qst, P, some)
                qcache = qc._paged_cache
                check(qcache.used_pages == 0, f"{kvd}: pages leaked")
                want = round(_pool_bytes(cfg, qcache.n_blocks, kvd) / 1e6, 3)
                ratio = qcache.device_mb() / want_mb
                check(qcache.device_mb() == want,
                      f"{kvd} pool {qcache.device_mb()} MB, computed {want}")
                log(f"continuous lane, kv_dtype {kvd}: {len(some)} "
                    f"requests, {qc.stats.tokens} tokens in {qwall:.3f}s; "
                    f"pool "
                    f"{qcache.device_mb():.1f} MB = {ratio:.4f} x bf16 "
                    f"(values {0.5 if kvd == 'int8' else 0.25} + scales); "
                    f"{qc.prefix_cache.stats.hits} prefix hits [{card}]")
                timings[f"continuous_{kvd}"] = {
                    "wall_s": qwall, "tokens": qc.stats.tokens,
                    "pool_mb": qcache.device_mb(), "ratio_to_bf16": ratio}
                qc._paged_cache = None
            finally:
                qst.close()
                Store.unlink(f"{name}{kvd}")
            torch.cuda.empty_cache()

        # what a decode step and a suffix stack cost per pool storage
        page_ids = np.asarray(comp._tok.encode(wave1["d/page6"]), np.int32)
        costs = {}
        for kvd in ("bf16", "int8", "int4"):
            costs[kvd] = _step_costs(model, kvd, page_ids)
            torch.cuda.empty_cache()
            log(f"  {kvd} pool: paged decode step (8 live rows of 32) "
                f"{costs[kvd][0]:.1f} ms, 64-token suffix stack "
                f"{costs[kvd][1]:.1f} ms (host wall) [{card}]")
        timings["continuous_step_costs"] = costs

        # one paged prefill + one paged decode step (K5) against the
        # dense prefill + decode_one on the same weights
        ids = np.asarray(comp._tok.encode(wave1["s/00"]), np.int32)
        cache = model.init_paged(2)
        rows = [model.paged_prefill_row(cache, ids, 0), model.prefill(ids)]
        tok = int(np.argmax(rows[1]))
        with torch.no_grad():
            step = model.module(
                torch.tensor([[tok], [0]], device="cuda"), cache.layers(),
                0, lengths=torch.from_numpy(cache.lengths).cuda(),
                tables=torch.from_numpy(cache.tables).cuda())
        rows += [step[0, 0].float().cpu().numpy(), model.decode_one(tok)]
        model.reset()
        cache.reset()
        cos = [float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
               for a, b in ((rows[0], rows[1]), (rows[2], rows[3]))]
        check(min(cos) >= 0.999, f"paged vs dense logits cosine {cos}")
        log(f"paged vs dense on the same bf16 weights ({len(ids)}-token "
            f"prompt): prefill logits cosine {cos[0]:.6f}, decode step "
            f"(K5 vs the dense plain attention) cosine {cos[1]:.6f}")
        timings["continuous_logits"] = {"prefill_cosine": cos[0],
                                        "step_cosine": cos[1]}
        return counts
    finally:
        if st is not None:
            st.close()
            Store.unlink(name)


# -- phase 7: the trainer -----------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 16, 512, 20


def _train_batch(rng, vocab, b, s, lo):
    """b pairs at width s, lengths in [lo, s]; ids_b is ids_a with ~10%
    of its tokens replaced (the same lengths).  Token ids follow Zipf's
    law (exponent 1.1), as words of text do: with uniform ids every pair
    of texts shares almost no token, a random-weight encoder tells them
    apart at once and the f32 loss underflows to 0 within a few steps;
    shared frequent tokens keep the in-batch negatives close."""
    def tokens(shape):
        return np.minimum(rng.zipf(1.1, shape), vocab) - 1

    ids = tokens((b, s))
    ids_b = ids.copy()
    swap = rng.random(ids.shape) < 0.1
    ids_b[swap] = tokens(int(swap.sum()))
    mask = np.arange(s)[None] < rng.integers(lo, s + 1, b)[:, None]
    return {"ids_a": ids, "mask_a": mask, "ids_b": ids_b, "mask_b": mask}


def _f32_grads_match_plain(state, batch, cfg):
    """One f32 step's gradients through K1/K6 against the same step with
    the plain attention (flash_min_seq=0), on the trainer's current
    weights: each tensor within 1e-4 of its largest |g| (TF32 is off)."""
    import torch

    from libsplinter_tpu_torch.models.encoder import Encoder
    from libsplinter_tpu_torch.ops import _cuda
    from libsplinter_tpu_torch.parallel import loss_fn

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    sd = state.module.state_dict()
    grads, launches = [], []
    for c in (cfg32, dataclasses.replace(cfg32, flash_min_seq=0)):
        with torch.device("cuda"):
            module = Encoder(c)
        module.load_state_dict(sd)
        _cuda.LAUNCHES.reset()
        loss_fn(module, batch).backward()
        launches.append(_cuda.LAUNCHES["flash_bwd"])
        grads.append({n: p.grad for n, p in module.named_parameters()})
        del module
    check(launches == [2 * cfg.layers, 0],
          f"K6 launches in the f32 steps (flash, plain): {launches}")
    worst, where = 0.0, ""
    for name, gp in grads[1].items():
        w = ((grads[0][name] - gp).abs().max() / gp.abs().max()).item()
        if w > worst:
            worst, where = w, name
    check(worst <= 1e-4, f"f32 gradients, K1/K6 vs plain attention: "
          f"{where} off by {worst:.3g} of its max |g| (> 1e-4)")
    return worst, where


def phase_train(card, timings):
    """The encoder's contrastive trainer at full width on the card, then
    a checkpoint round trip and the trained weights served through
    EmbeddingModel."""
    import torch

    from libsplinter_tpu_torch.models import EmbeddingModel, EncoderConfig
    from libsplinter_tpu_torch.ops import _cuda
    from libsplinter_tpu_torch.parallel import checkpoint, make_train_step

    cfg = EncoderConfig()
    per_step = 2 * cfg.layers                # two towers, every layer
    init_fn, step_fn = make_train_step(cfg)
    rng = np.random.default_rng(23)
    batch = _train_batch(rng, cfg.vocab_size, TRAIN_B, TRAIN_S, 128)
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device="cuda").manual_seed(0),
                    batch["ids_a"], batch["mask_a"])
    state, loss = step_fn(state, batch)                  # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    log(f"trainer: EncoderConfig() full width (12 layers, hidden 768, "
        f"vocab {cfg.vocab_size}, bf16 compute, f32 master weights, "
        f"AdamW), init + warm-up step {time.perf_counter() - t0:.2f}s")

    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.reset()                       # the main path
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, loss = step_fn(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(counts["flash_bwd"] == per_step * TRAIN_STEPS
          and counts["flash_fwd"] == per_step * TRAIN_STEPS,
          f"K1/K6 launches over {TRAIN_STEPS} steps: {counts}")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    real = int(batch["mask_a"].sum() + batch["mask_b"].sum())
    padded = 2 * TRAIN_B * TRAIN_S
    log(f"train {TRAIN_B} pairs x S={TRAIN_S}: {TRAIN_STEPS} steps in "
        f"{wall:.3f}s = {TRAIN_STEPS / wall:.3f} steps/s, "
        f"{padded * TRAIN_STEPS / wall:.0f} tokens/s ({real * TRAIN_STEPS / wall:.0f} "
        f"unpadded), peak {peak_gb:.2f} GB allocated; loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; K6 {counts['flash_bwd']} "
        f"launches ({per_step} a step) [{card}]")
    timings["train"] = {"steps": TRAIN_STEPS, "wall_s": wall,
                        "steps_per_s": TRAIN_STEPS / wall,
                        "tokens_per_s": padded * TRAIN_STEPS / wall,
                        "unpadded_tokens_per_s": real * TRAIN_STEPS / wall,
                        "peak_gb": peak_gb, "loss_first": losses[0],
                        "loss_last": losses[-1]}

    def one_step():
        nonlocal state
        state, _ = step_fn(state, batch)
        return 1

    timings["train_profile"] = _profile_drain(one_step, 1,
                                              wall / TRAIN_STEPS, card)
    timings["profile_sums_check"] = _check_profile_sums(one_step, card)

    long = _train_batch(rng, cfg.vocab_size, 4, 2048, 512)
    state, _ = step_fn(state, long)              # allocator, cuBLAS shapes
    torch.cuda.synchronize()
    _cuda.LAUNCHES.reset()
    t0 = time.perf_counter()
    long_losses = []
    for _ in range(2):
        state, loss = step_fn(state, long)
        long_losses.append(float(loss))
    long_s = (time.perf_counter() - t0) / 2
    check(all(np.isfinite(long_losses)), f"S=2048 losses {long_losses}")
    check(_cuda.LAUNCHES["flash_bwd"] == 2 * per_step,
          f"K6 launches in 2 steps at S=2048: {_cuda.LAUNCHES['flash_bwd']}")
    log(f"train 4 pairs x S=2048: {long_s * 1e3:.1f} ms a step "
        f"({2 * 4 * 2048 / long_s:.0f} tokens/s), losses {long_losses} "
        f"[{card}]")
    timings["train_2048"] = {"step_ms": long_s * 1e3}

    worst, where = _f32_grads_match_plain(
        state, {k: x[:8] for k, x in batch.items()}, cfg)
    log(f"f32 step, 8 pairs x S={TRAIN_S}: gradients through K1/K6 vs "
        f"the plain attention within {worst:.3g} of each tensor's max |g| "
        f"(worst {where}; limit 1e-4, TF32 off)")
    timings["train_f32_vs_plain"] = worst
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="sptk-ckpt-")
    try:
        t0 = time.perf_counter()
        saved = checkpoint.save(state, tmp)
        save_s = time.perf_counter() - t0
        state, loss_a = step_fn(state, batch)    # uninterrupted
        like = init_fn(torch.Generator(device="cuda").manual_seed(1),
                       batch["ids_a"], batch["mask_a"])
        t0 = time.perf_counter()
        resumed = checkpoint.restore(tmp, like)
        restore_s = time.perf_counter() - t0
        check(resumed.step == saved == state.step - 1,
              f"restored step {resumed.step}, saved {saved}")
        resumed, loss_b = step_fn(resumed, batch)
        la, lb = float(loss_a), float(loss_b)
        rel = abs(la - lb) / abs(la)
        check(rel <= 1e-6, f"resumed loss {lb} vs uninterrupted {la}")
        log(f"checkpoint: step {saved} saved in {save_s:.2f}s, restored "
            f"in {restore_s:.2f}s; the next step's loss {lb:.9g} vs "
            f"uninterrupted {la:.9g} (relative {rel:.3g}, limit 1e-6)")
        del like, resumed
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the trained weights served: EmbeddingModel's bf16 copy against the
    # trainer module's own forward (the same bf16 weights and kernels)
    n = 8
    ids, mask = batch["ids_a"][:n], batch["mask_a"][:n]
    model = EmbeddingModel(cfg, params=state.module.state_dict(),
                           device="cuda")
    got = model.encode_ids(ids, mask.sum(axis=1))
    with torch.no_grad():
        want = state.module(torch.from_numpy(ids).cuda(),
                            torch.from_numpy(mask).cuda()).cpu().numpy()
    err = float(np.abs(got - want).max())
    check(got.shape == (n, cfg.out_dim) and np.isfinite(got).all()
          and err <= F32_ATOL,
          f"served embeddings vs the trainer's forward: max err {err}")
    log(f"served: EmbeddingModel on the trained weights, {n} texts at "
        f"bucket {TRAIN_S}: max abs err {err:.3g} against the trainer's "
        f"forward (limit {F32_ATOL})")
    del state, model
    torch.cuda.empty_cache()
    return counts


# -- phase 8: GGUF checkpoints, opened cold ----------------------------------

# Phases 8-15 run the full-width geometries cut in depth, so the smoke
# stays well inside its time limit: CUT_LAYERS of the 12 layers of
# DecoderConfig() and EncoderConfig() (MoE and the trainers included).
# Phases 4-7 run all 12.
CUT_LAYERS = 4

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")
GGUF_NEW_TOKENS = 32
CHATML_TEMPLATE = ("{% for m in messages %}<|im_start|>{{ m.role }}\n"
                   "{{ m.content }}<|im_end|>\n{% endfor %}"
                   "<|im_start|>assistant\n")


def _gguf_golden(card, timings):
    """The committed golden fixture, cold, on the card: its config and
    token ids exact, its f32 vectors (TF32 off) within 1e-5 of
    golden_expected.json, directly and committed by an in-process
    Embedder (f32 fetch wire); then embedder.main on the file alone
    (bf16, as the daemon derives it: cosine >= 0.999)."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import embedder as emb_mod
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.models import (EmbeddingModel, GgufFile,
                                              encoder_config_from_gguf,
                                              load_tokenizer)

    path = os.path.join(FIXTURES, "golden_encoder.gguf")
    with open(os.path.join(FIXTURES, "golden_expected.json")) as f:
        golden = json.load(f)
    t0 = time.perf_counter()
    with GgufFile(path) as gf:
        cfg = encoder_config_from_gguf(gf, out_dim=32, dtype=torch.float32)
        tok = load_tokenizer(gf)
    model = EmbeddingModel(cfg, weights=path, buckets=(32,), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = golden["config"]
    check((cfg.vocab_size, cfg.hidden, cfg.layers, cfg.out_dim, cfg.variant)
          == (want["vocab_size"], want["hidden"], want["layers"],
              want["out_dim"], "nomic"), f"golden config {cfg}")
    worst = 0.0
    texts, vecs = {}, {}
    for i, case in enumerate(golden["texts"]):
        ids = tok.encode(case["text"])
        check(ids == case["token_ids"],
              f"golden token ids of {case['text']!r}: {ids}")
        arr = np.full((1, 32), tok.pad_id, np.int32)
        arr[0, :len(ids)] = ids
        vec = model.encode_ids(arr, np.array([len(ids)], np.int32))[0]
        vecs[f"g/{i}"] = np.asarray(case["vector"], np.float32)
        texts[f"g/{i}"] = case["text"]
        worst = max(worst, float(np.abs(vec - vecs[f"g/{i}"]).max()))
    check(worst <= F32_ATOL, f"golden vectors: worst abs err {worst}")

    names = [f"/spt-smoke-g{os.getpid()}{s}" for s in "ab"]
    stores = []
    try:
        for name in names:
            stores.append(Store.create(name, nslots=64, max_val=1024,
                                       vec_dim=32))
            _requeue(stores[-1], P, texts)
        emb = emb_mod.Embedder(stores[0], model=model, tokenizer=tok,
                               max_ctx=cfg.max_len)
        emb.attach()
        check(emb.run_once() == len(texts), "golden: embedder drain")
        lane_err = max(float(np.abs(stores[0].vec_get(k) - v).max())
                       for k, v in vecs.items())
        check(lane_err <= F32_ATOL,
              f"golden: committed vectors, worst abs err {lane_err}")
        t0 = time.perf_counter()
        check(emb_mod.main(["--store", names[1], "--weights", path,
                            "--oneshot"]) == 0, "golden: embedder.main")
        main_s = time.perf_counter() - t0
        cos = min(float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))
                  for k, w in vecs.items() for g in [stores[1].vec_get(k)])
        check(cos >= 0.999, f"golden: embedder.main (bf16) cosine {cos}")
    finally:
        for st, name in zip(stores, names):
            st.close()
            Store.unlink(name)
    log(f"gguf golden: cold load {load_s:.3f}s, f32 vectors worst abs err "
        f"{worst:.3g} (bar 1e-5), committed through the Embedder "
        f"{lane_err:.3g}; embedder.main on the file (bf16) min cosine "
        f"{cos:.6f} in {main_s:.2f}s [{card}]")
    timings["gguf_golden"] = {"load_s": load_s, "max_abs_err": worst,
                              "embedder_max_abs_err": lane_err,
                              "main_min_cosine": cos, "main_s": main_s}


def _wordpiece_vocab(n, rng):
    """A WordPiece vocab of n entries: the five bert specials, seeded
    words and ##pieces."""
    letters = list("abcdefghijklmnopqrstuvwxyz")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    seen, words = set(vocab), []
    while len(vocab) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        if rng.random() < 0.3:
            w = "##" + w
        if w not in seen:
            seen.add(w)
            vocab.append(w)
            if not w.startswith("##"):
                words.append(w)
    return vocab, words


def _nest(flat):
    """params_to_jax's flat "params/a/b/leaf" keys -> a nested tree."""
    tree = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")[1:]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _gguf_encoder(card, timings, tmp):
    """EncoderConfig(layers=CUT_LAYERS) from seeded weights written as an
    F16 GGUF with a 30528-entry WordPiece vocab, opened cold: every
    loaded tensor equal to the f16 rounding of its source; the embed
    lane over 64 texts
    (K1 in the bucket-1024 ones) and a k = 16 search (K2)."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.engine.searcher import (Searcher,
                                                       consume_result,
                                                       submit_search)
    from libsplinter_tpu_torch.models import (EmbeddingModel, EncoderConfig,
                                              GgufFile,
                                              encoder_config_from_gguf,
                                              load_encoder_params,
                                              load_tokenizer)
    from libsplinter_tpu_torch.models.encoder import (Encoder, init_params,
                                                      params_to_jax)
    from libsplinter_tpu_torch.models.gguf_writer import (GGML_F16,
                                                          export_encoder_gguf)
    from libsplinter_tpu_torch.ops import _cuda

    cfg = EncoderConfig(layers=CUT_LAYERS)
    rng = np.random.default_rng(31)
    with torch.device("cuda"):
        src = Encoder(cfg)
    init_params(src, torch.Generator(device="cuda").manual_seed(31))
    tree = _nest(params_to_jax(src))
    want = {k: v.float().cpu().half().float()
            for k, v in src.state_dict().items()}
    del src
    vocab, words = _wordpiece_vocab(cfg.vocab_size, rng)
    path = os.path.join(tmp, "encoder-f16.gguf")
    t0 = time.perf_counter()
    export_encoder_gguf(tree, cfg, path, tokenizer_vocab=vocab,
                        gtype=GGML_F16)
    write_s = time.perf_counter() - t0
    del tree

    t0 = time.perf_counter()
    with GgufFile(path) as gf:
        lcfg = encoder_config_from_gguf(gf, out_dim=LANE_DIM)
        tok = load_tokenizer(gf)
    sd = load_encoder_params(path, lcfg)
    model = EmbeddingModel(lcfg, params=sd, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fields = ("vocab_size", "hidden", "layers", "heads", "mlp_dim",
              "max_len", "variant", "out_dim", "dtype")
    check(all(getattr(lcfg, f) == getattr(cfg, f) for f in fields),
          f"encoder config from the file {lcfg} != {cfg}")
    check(sorted(sd) == sorted(want), "encoder: state_dict keys")
    bad = [k for k in want if not torch.equal(sd[k], want[k])]
    check(not bad, f"encoder: {len(bad)} tensors differ from the f16 "
          f"rounding of their source, e.g. {bad[:3]}")
    del sd, want
    log(f"gguf encoder: EncoderConfig(layers={cfg.layers}) as F16 "
        f"({os.path.getsize(path)} "
        f"bytes, vocab {len(vocab)}) written in {write_s:.2f}s, cold load "
        f"(open, config, tokenizer, dequantize, to the card) {load_s:.2f}s; "
        f"every tensor equal to the f16 rounding of its source [{card}]")

    name = f"/spt-smoke-ge{os.getpid()}"
    st = searcher = None
    stop = threading.Event()
    try:
        st = Store.create(name, nslots=4096, max_val=8192, vec_dim=LANE_DIM)
        emb = Embedder(st, model=model, tokenizer=tok, max_ctx=lcfg.max_len)
        emb.attach()
        spans = [(600, 900)] * 2 + [(300, 500)] * 6 + [(8, 200)] * 56
        texts = {f"gguf/{i:02d}": " ".join(rng.choice(words,
                                                       int(rng.integers(*s))))
                 for i, s in enumerate(spans)}
        _requeue(st, P, texts)
        _cuda.LAUNCHES.reset()                       # this slice's path
        t0 = time.perf_counter()
        n = emb.run_once()
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t0
        check(n == len(texts), f"gguf encoder: embedded {n} of {len(texts)}")
        for key in texts:
            v = st.vec_get(key)
            check(np.isfinite(v).all() and
                  abs(float(np.linalg.norm(v)) - 1.0) < 1e-4,
                  f"gguf encoder {key}: norm {np.linalg.norm(v)}")

        searcher = Searcher(st, device="cuda")
        searcher.attach()

        def drain_loop():
            while not stop.is_set():
                searcher.run_once()
                time.sleep(0.002)

        drainer = threading.Thread(target=drain_loop, daemon=True)
        drainer.start()
        src_key = "gguf/00"
        st.set("__q/gguf", "q")
        st.vec_set("__q/gguf", st.vec_get(src_key))
        rec = submit_search(st, "__q/gguf", 16, timeout_ms=phase_left() * 1000)
        stop.set()
        drainer.join(timeout=60)
        check(not drainer.is_alive(), "searcher thread did not stop")
        check(rec is not None and "err" not in rec and len(rec["keys"]) == 16
              and rec["keys"][0] == src_key,
              f"gguf encoder: k=16 search for {src_key}: {rec}")
        consume_result(st, "__q/gguf")
        counts = dict(_cuda.LAUNCHES)
        check(counts["flash_fwd"] > 0 and counts["fused_topk"] > 0,
              f"gguf encoder lane: K1/K2 never launched: {counts}")
        log(f"gguf encoder lane: {n} texts in {drain_s:.3f}s = "
            f"{n / drain_s:.1f} embeddings/s (cold, buckets "
            f"{sorted(model._shapes)}), k=16 search returns the key "
            f"itself first; K1 launches {counts['flash_fwd']}, K2 "
            f"{counts['fused_topk']} [{card}] (first reading)")
        timings["gguf_encoder"] = {
            "write_s": write_s, "load_s": load_s,
            "file_bytes": os.path.getsize(path), "requests": n,
            "drain_s": drain_s, "embeddings_per_s": n / drain_s}
        return {k: counts[k] for k in ("flash_fwd", "fused_topk")}
    finally:
        stop.set()
        if st is not None:
            st.close()
            Store.unlink(name)
        del model
        torch.cuda.empty_cache()


def _unigram_vocab(n, rng):
    """A llama (unigram) vocab of n pieces: <unk> <s> </s>, the byte
    pieces <0x00>-<0xFF>, the chatml markers as user-defined tokens,
    then seeded pieces with seeded scores; also the words that are
    whole "▁" pieces."""
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += ["<|im_start|>", "<|im_end|>"]
    types = [2, 3, 3] + [6] * 256 + [4, 4]        # ggml token types
    scores = [0.0] * len(tokens)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    seen, words = set(tokens), []
    while len(tokens) < n:
        w = "".join(rng.choice(letters, int(rng.integers(1, 8))))
        piece = "▁" + w if rng.random() < 0.6 else w
        if piece in seen:
            continue
        seen.add(piece)
        tokens.append(piece)
        types.append(1)
        scores.append(-len(piece) ** 0.5 - float(rng.random()))
        if piece.startswith("▁"):
            words.append(w)
    return tokens, scores, types, words


def _gguf_decoder_file(cfg, tmp, rng, name="decoder-f16-q8-q4.gguf",
                       mixed=True, seed=37):
    """`cfg` from seeded weights (torch seed `seed`) as a llama GGUF in
    `tmp`/`name`: F16, with layer 0's attention in Q8_0 and its MLP in
    Q4_0 when `mixed`, a 32000-piece unigram vocab drawn from `rng` and
    a chatml chat template.  A MoeDecoderConfig writes a Mixtral-family
    file: each layer's router as blk.N.ffn_gate_inp, its stacked experts
    as blk.N.ffn_{gate,up,down}_exps and the expert_count /
    expert_used_count keys.  Returns (path, write seconds, the expected
    loaded state_dict, the vocab's words)."""
    import torch

    from libsplinter_tpu_torch.models import gguf
    from libsplinter_tpu_torch.models.decoder import Decoder, init_params
    from libsplinter_tpu_torch.models.gguf_writer import (
        GGML_F16, GGML_Q4_0, GGML_Q8_0, kv_f32_array, kv_i32_array, kv_str,
        kv_str_array, kv_u32, quantize_q4_0, quantize_q8_0, write_gguf)
    from libsplinter_tpu_torch.models.moe import MoeDecoder, MoeDecoderConfig

    moe = isinstance(cfg, MoeDecoderConfig)
    with torch.device("cuda"):
        src = MoeDecoder(cfg) if moe else Decoder(cfg)
    init_params(src, torch.Generator(device="cuda").manual_seed(seed))
    state = {k: v.float().cpu().numpy() for k, v in src.state_dict().items()}
    del src
    top = {"tok_emb.weight": "token_embd.weight",
           "ln_out.weight": "output_norm.weight",
           "lm_head.weight": "output.weight"}
    per_layer = {"ln_attn": "attn_norm", "ln_mlp": "ffn_norm",
                 "attn.q": "attn_q", "attn.k": "attn_k", "attn.v": "attn_v",
                 "attn.out": "attn_output", "gate": "ffn_gate",
                 "up": "ffn_up", "down": "ffn_down",
                 "moe.router": "ffn_gate_inp", "moe.gate_experts":
                 "ffn_gate_exps", "moe.up_experts": "ffn_up_exps",
                 "moe.down_experts": "ffn_down_exps"}
    quant = {"layer_0.attn.q.weight": GGML_Q8_0,
             "layer_0.attn.k.weight": GGML_Q8_0,
             "layer_0.attn.v.weight": GGML_Q8_0,
             "layer_0.attn.out.weight": GGML_Q8_0,
             "layer_0.gate.weight": GGML_Q4_0,
             "layer_0.up.weight": GGML_Q4_0,
             "layer_0.down.weight": GGML_Q4_0} if mixed else {}
    tensors, expect = {}, {}
    for key, arr in state.items():
        out = arr
        if key in top:
            gname = top[key]
        else:
            layer, rest = key.split(".", 1)
            gname = (f"blk.{layer.split('_')[1]}."
                     f"{per_layer[rest.removesuffix('.weight')]}.weight")
            if rest.endswith("_experts"):
                # the file's (E, out, in) numpy view of the (E, in, out)
                # stack
                out = np.ascontiguousarray(arr.transpose(0, 2, 1))
        gtype = quant.get(key, GGML_F16)
        tensors[gname] = (out, gtype)
        if gtype == GGML_F16:
            want = arr.astype(np.float16).astype(np.float32)
        else:
            quantize, dequant = {GGML_Q8_0: (quantize_q8_0, gguf._dequant_q8_0),
                                 GGML_Q4_0: (quantize_q4_0, gguf._dequant_q4_0)
                                 }[gtype]
            want = dequant(quantize(arr.reshape(-1)), 0,
                           arr.size).reshape(arr.shape)
        expect[key] = torch.from_numpy(want)
    tokens, scores, types, words = _unigram_vocab(cfg.vocab_size, rng)
    md = [kv_str("general.architecture", "llama"),
          kv_u32("llama.block_count", cfg.layers),
          kv_u32("llama.embedding_length", cfg.hidden),
          kv_u32("llama.attention.head_count", cfg.heads),
          kv_u32("llama.attention.head_count_kv", cfg.kv_heads),
          kv_u32("llama.feed_forward_length", cfg.mlp_dim),
          kv_u32("llama.context_length", cfg.max_len),
          kv_str("tokenizer.ggml.model", "llama"),
          kv_str_array("tokenizer.ggml.tokens", tokens),
          kv_f32_array("tokenizer.ggml.scores", scores),
          kv_i32_array("tokenizer.ggml.token_type", types),
          kv_u32("tokenizer.ggml.bos_token_id", 1),
          kv_u32("tokenizer.ggml.eos_token_id", 2),
          kv_u32("tokenizer.ggml.unknown_token_id", 0),
          kv_str("tokenizer.chat_template", CHATML_TEMPLATE)]
    if moe:
        md += [kv_u32("llama.expert_count", cfg.n_experts),
               kv_u32("llama.expert_used_count", cfg.top_k)]
    path = os.path.join(tmp, name)
    t0 = time.perf_counter()
    write_gguf(path, tensors, md)
    return path, time.perf_counter() - t0, expect, words


def _gguf_decoder(card, timings, tmp):
    """DecoderConfig(layers=CUT_LAYERS) as a GGUF opened cold (every
    loaded tensor equal to its source's f16 rounding or, for the Q8_0
    and Q4_0 ones, to the numpy dequantizer's output), then
    completer.main on the file alone
    with --continuous --template auto: chatml from the file, 8 requests
    served on the card with K4 and K5."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import completer as comp_mod
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.models import (CompletionModel, DecoderConfig,
                                              GgufFile,
                                              decoder_config_from_gguf,
                                              load_decoder_params,
                                              load_tokenizer)
    from libsplinter_tpu_torch.ops import _cuda

    cfg = DecoderConfig(layers=CUT_LAYERS)
    rng = np.random.default_rng(37)
    path, write_s, expect, words = _gguf_decoder_file(cfg, tmp, rng)
    t0 = time.perf_counter()
    with GgufFile(path) as gf:
        lcfg = decoder_config_from_gguf(gf)
        tok = load_tokenizer(gf)
    sd = load_decoder_params(path, lcfg)
    model = CompletionModel(lcfg, params=sd, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(lcfg == cfg, f"decoder config from the file {lcfg} != {cfg}")
    check(sorted(sd) == sorted(expect), "decoder: state_dict keys")
    bad = [k for k in expect if not torch.equal(sd[k], expect[k])]
    check(not bad, f"decoder: {len(bad)} tensors differ from their "
          f"source's dequantized value, e.g. {bad[:3]}")
    del model, sd, expect
    torch.cuda.empty_cache()
    log(f"gguf decoder: DecoderConfig(layers={cfg.layers}) as F16 + layer "
        f"0 Q8_0/Q4_0 "
        f"({os.path.getsize(path)} bytes, vocab {tok.vocab_size}) written "
        f"in {write_s:.2f}s, cold load (open, config, tokenizer, "
        f"dequantize, to the card) {load_s:.2f}s; every tensor equal to "
        f"its source's dequantized value [{card}]")

    def text(nwords):
        return " ".join(rng.choice(words, nwords))

    prompts = {f"chat/{i}": text(n)
               for i, n in enumerate((30, 90, 160, 240, 320, 400, 520, 640))}
    base = comp_mod.Completer
    made = []

    class Recording(base):
        """The daemon's Completer, kept for the checks below, with each
        request's streamed token count."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.n_tok = {}
            made.append(self)

        def _finalize(self, key, t0, n_tok, *a, **kw):
            self.n_tok[key] = n_tok
            return super()._finalize(key, t0, n_tok, *a, **kw)

    name = f"/spt-smoke-gd{os.getpid()}"
    st = Store.create(name, nslots=128, max_val=16384, vec_dim=0)
    done, finished = {}, threading.Event()

    def feeder():
        deadline = time.monotonic() + phase_left()
        while not made:                 # main builds the lane's Completer
            if finished.wait(0.01) or time.monotonic() > deadline:
                return
        t1 = time.perf_counter()
        _ask(st, P, prompts)
        busy = P.LBL_INFER_REQ | P.LBL_WAITING | P.LBL_SERVICING
        while time.monotonic() < deadline:
            if all(st.labels(k) & P.LBL_READY and not st.labels(k) & busy
                   for k in prompts):
                done["wall"] = time.perf_counter() - t1
                break
            time.sleep(0.01)
        while not finished.is_set():      # stop the lane once it runs
            made[0].stop()
            finished.wait(0.5)

    th = threading.Thread(target=feeder, daemon=True)
    try:
        _cuda.LAUNCHES.reset()                       # this slice's path
        comp_mod.Completer = Recording
        th.start()
        t0 = time.perf_counter()
        rc = comp_mod.main(["--store", name, "--weights", path,
                            "--continuous", "--template", "auto",
                            "--max-new-tokens", str(GGUF_NEW_TOKENS),
                            "--idle-timeout-ms", "20"])
        main_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
    finally:
        comp_mod.Completer = base
        finished.set()
        th.join(timeout=60)
        served = {k: (st.labels(k), st.get(k).rstrip(b"\0")) for k in prompts}
        st.close()
        Store.unlink(name)
    check(rc == 0 and made and "wall" in done,
          f"completer.main on the GGUF: rc {rc}, {len(made)} lanes, "
          f"served {made[0].stats.completions if made else 0} of "
          f"{len(prompts)}")
    comp = made[0]
    check(comp.template == "chatml",
          f"--template auto resolved to {comp.template!r}, not chatml")
    check(comp.stats.aborts == 0 and comp.stats.faults == 0,
          f"gguf lane: {comp.stats.aborts} aborts, {comp.stats.faults} "
          f"key faults")
    check(comp.stats.completions == len(prompts),
          f"gguf lane: {comp.stats.completions} completions")
    for key, user in prompts.items():
        labels, got = served[key]
        check(labels & P.LBL_READY and not labels & (
            P.LBL_SERVICING | P.LBL_INFER_REQ | P.LBL_WAITING),
            f"{key}: labels {labels:#x}")
        rendered = comp_mod.render_prompt(user, None, "chatml").encode()
        check(got.startswith(rendered), f"{key}: chatml prompt not kept")
        check(1 <= comp.n_tok.get(key, 0) <= GGUF_NEW_TOKENS,
              f"{key}: {comp.n_tok.get(key)} tokens streamed")
        piece = got[len(rendered):].decode("utf-8", errors="replace")
        tok.decode(tok.encode(piece, add_bos=False))
    check(counts["causal_fwd"] > 0 and counts["paged_fwd"] > 0,
          f"gguf lane: K4/K5 never launched: {counts}")
    tokens = comp.stats.tokens
    log(f"gguf decoder lane: completer.main --weights <file> --continuous "
        f"--template auto -> chatml; {len(prompts)} requests, {tokens} "
        f"tokens in {done['wall']:.3f}s = {tokens / done['wall']:.1f} "
        f"tokens/s (cold, prefill included; main {main_s:.2f}s with its "
        f"own load); K4 launches {counts['causal_fwd']}, K5 "
        f"{counts['paged_fwd']} [{card}] (first reading)")
    timings["gguf_decoder"] = {
        "write_s": write_s, "load_s": load_s,
        "file_bytes": os.path.getsize(path), "requests": len(prompts),
        "tokens": tokens, "wall_s": done["wall"],
        "tokens_per_s": tokens / done["wall"], "main_s": main_s}
    return {k: counts[k] for k in ("causal_fwd", "paged_fwd")}


def phase_gguf(card, timings, tmp):
    """GGUF checkpoints opened cold by the port on the card: the golden
    fixture, then full-width encoder and decoder files written into
    `tmp` (phase 9 opens the decoder file again)."""
    t0 = time.perf_counter()
    _gguf_golden(card, timings)
    counts = _gguf_encoder(card, timings, tmp)
    counts.update(_gguf_decoder(card, timings, tmp))
    timings["gguf_s"] = time.perf_counter() - t0
    log(f"gguf phase: {timings['gguf_s']:.1f}s [{card}]")
    return counts


# -- phase 9: serving variants ------------------------------------------------

VARIANT_NEW_TOKENS = 64


def _variant_prompts(rng, n):
    """n of phase 6's prompts (distinct and shared-prefix, 40-1500
    bytes; some land in buckets of 512 and up, so K4 runs)."""
    wave1, wave2 = _continuous_prompts(rng)
    both = [(k, t) for k, t in {**wave1, **wave2}.items()
            if not k.startswith("r/")]
    return dict(both[:n])


def _served_bytes(st, prompts):
    return {k: bytes(st.get(k).rstrip(b"\0")) for k in prompts}


def _lane_run(comp, st, P, prompts, what):
    """Serve `prompts` through run_continuous (on this thread, stopped
    when all are READY) with K4/K5 counted from 0; check READY, the
    full token budget and no abort.  Returns (launches, wall s)."""
    import torch

    from libsplinter_tpu_torch.ops import _cuda

    _cuda.LAUNCHES.reset()
    t_before = comp.stats.tokens
    n, wall = _drive_continuous(comp, st, P, [prompts])
    torch.cuda.synchronize()
    counts = {k: _cuda.LAUNCHES[k] for k in ("causal_fwd", "paged_fwd")}
    _check_no_abort(comp, comp.stats.tokens - t_before, n, what)
    _check_served(st, P, prompts)
    check(counts["causal_fwd"] > 0 and counts["paged_fwd"] > 0,
          f"{what}: K4/K5 never launched: {counts}")
    return counts, wall


def _proj_bytes_bf16(cfg):
    """bf16 bytes of the decoder's attention + MLP projections."""
    d = cfg.head_dim
    per_layer = (cfg.hidden * cfg.heads * d * 2 + cfg.hidden * cfg.kv_heads
                 * d * 2 + 3 * cfg.hidden * cfg.mlp_dim)
    return 2 * cfg.layers * per_layer


def _dequantized_state(qsd):
    """A quantized state_dict's projections as float (out, in) weights,
    and its stacked MoE experts as float (E, in, out) stacks: the values
    the int8 codes and scales stand for."""
    import torch

    from libsplinter_tpu_torch.models.quant import (dequantize_channel_kernel,
                                                    dequantize_kernel,
                                                    expert_weight)
    out = {}
    for k, v in qsd.items():
        head, leaf = k.rsplit(".", 1)
        if leaf.endswith("_experts_q"):
            stack = leaf.removesuffix("_q")
            out[f"{head}.{stack}"] = expert_weight(
                v, qsd[f"{head}.{stack}_scale"], torch.float32)
        elif leaf.endswith("_experts_scale"):
            continue
        elif leaf == "q":
            w = dequantize_kernel({"q": v.numpy(),
                                   "scale": qsd[f"{head}.scale"].numpy()})
            out[f"{head}.weight"] = torch.from_numpy(w.T.copy())
        elif leaf == "wq":
            w = dequantize_channel_kernel(
                {"wq": v.numpy(), "wscale": qsd[f"{head}.wscale"].numpy()})
            out[f"{head}.weight"] = torch.from_numpy(w.T.copy())
        elif leaf not in ("scale", "wscale"):
            out[k] = v
    return out


def _variants_quant(card, timings, sd, prompts, gguf_path):
    """--quantized and --weights-int8 from the same seeded float weights:
    first-step logits against the float model on the dequantized
    weights (f32: within 1e-3 of |logit| <= ~10, the same weights in
    another rounding order; bf16: cosine >= 0.999), the projection bytes
    resident against bf16, 16 requests through run_continuous, and phase
    8's decoder GGUF opened quantized with layer 0's Q8_0 codes equal to
    the file's."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.models import (CompletionModel, DecoderConfig,
                                              GgufFile,
                                              decoder_config_from_gguf)
    from libsplinter_tpu_torch.models.quant import (QUANT_LEAVES,
                                                    quantize_state_dict,
                                                    resident_bytes)

    cfg = DecoderConfig(layers=CUT_LAYERS)
    ids = np.asarray(_piece_tokenizer().encode(prompts["s/00"]), np.int32)
    launches, out = {}, {}
    for variant, mode in (("quantized", "block"), ("weights_int8", "channel")):
        qsd = quantize_state_dict(sd, QUANT_LEAVES, mode=mode)
        dq = _dequantized_state(qsd)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            qcfg = dataclasses.replace(cfg, dtype=dt, **{variant: True})
            qm = CompletionModel(qcfg, params=qsd, temp=0.0, device="cuda")
            fm = CompletionModel(dataclasses.replace(cfg, dtype=dt),
                                 params=dq, temp=0.0, device="cuda")
            a, b = qm.prefill(ids), fm.prefill(ids)
            tok = int(np.argmax(b))
            a2, b2 = qm.decode_one(tok), fm.decode_one(tok)
            cos = min(float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
                      for x, y in ((a, b), (a2, b2)))
            err = max(float(np.abs(a - b).max()), float(np.abs(a2 - b2).max()))
            errs[str(dt).removeprefix("torch.")] = (err, cos)
            if dt == torch.float32:
                check(err <= 1e-3, f"{variant} f32: logits {err} from the "
                      f"float model on the dequantized weights (bar 1e-3)")
            else:
                check(cos >= 0.999, f"{variant} bf16: logits cosine {cos}")
                model = qm
            del fm
        torch.cuda.empty_cache()
        ratio = resident_bytes(model.module) / _proj_bytes_bf16(cfg)
        want = 0.5625 if mode == "block" else 0.5 + 2 / cfg.hidden
        check(abs(ratio - want) < 0.01, f"{variant}: projections hold "
              f"{ratio:.4f} x bf16, geometry {want:.4f}")
        name = f"/spt-smoke-q{os.getpid()}"
        st = Store.create(name, nslots=128, max_val=8192, vec_dim=0)
        try:
            comp = Completer(st, model=model, tokenizer=_piece_tokenizer(),
                             template="none",
                             max_new_tokens=VARIANT_NEW_TOKENS)
            comp.attach()
            counts, wall = _lane_run(comp, st, P, prompts, variant)
        finally:
            st.close()
            Store.unlink(name)
        tokens = len(prompts) * VARIANT_NEW_TOKENS
        launches[variant] = counts
        log(f"variants, {variant}: first-step logits vs the float model on "
            f"the dequantized weights: f32 max err {errs['float32'][0]:.3e} "
            f"(bar 1e-3), bf16 max err {errs['bfloat16'][0]:.4f} cosine "
            f"{errs['bfloat16'][1]:.6f} (bar 0.999); projections resident "
            f"{resident_bytes(model.module)} bytes = {ratio:.4f} x bf16; "
            f"{len(prompts)} requests, {tokens} tokens in {wall:.3f}s = "
            f"{tokens / wall:.1f} tokens/s (cold, prefill included); K4 "
            f"{counts['causal_fwd']}, K5 {counts['paged_fwd']} [{card}]")
        out[variant] = {"f32_max_err": errs["float32"][0],
                        "bf16_max_err": errs["bfloat16"][0],
                        "bf16_cosine": errs["bfloat16"][1],
                        "resident_ratio": ratio, "wall_s": wall,
                        "tokens_per_s": tokens / wall}
        del model, comp
        torch.cuda.empty_cache()

    # phase 8's decoder file, served quantized: layer 0's attention is
    # Q8_0 there, and requantizing Q8_0 is lossless
    with GgufFile(gguf_path) as gf:
        gcfg = decoder_config_from_gguf(gf, quantized=True)
        block = np.dtype([("d", "<f2"), ("qs", "i1", (32,))])
        raw = {}
        for gname in ("attn_q", "attn_k", "attn_v", "attn_output"):
            ti = gf.tensors[f"blk.0.{gname}.weight"]
            din, dout = ti.dims
            raw[gname] = np.frombuffer(
                gf._mm, block, count=din * dout // 32,
                offset=gf._data_start + ti.offset).reshape(
                    dout, din // 32).copy()
    t0 = time.perf_counter()
    gm = CompletionModel(gcfg, weights=gguf_path, device="cuda")
    load_s = time.perf_counter() - t0
    for mod, gname in (("q", "attn_q"), ("k", "attn_k"), ("v", "attn_v"),
                       ("out", "attn_output")):
        m = getattr(gm.module.layer_0.attn, mod)
        q = torch.from_numpy(raw[gname]["qs"].transpose(1, 2, 0).copy())
        d = torch.from_numpy(raw[gname]["d"].astype(np.float32).T.copy())
        check(torch.equal(m.q.cpu(), q) and torch.equal(m.scale.cpu(), d),
              f"gguf --quantized: layer 0 {gname} codes/scales differ from "
              f"the file's Q8_0 blocks")
    del gm
    torch.cuda.empty_cache()
    log(f"variants, gguf --quantized: layer 0 attention's int8 codes and "
        f"scales on the card equal the file's Q8_0 blocks exactly (4 "
        f"tensors); load + requantize {load_s:.2f}s [{card}]")
    out["gguf_quantized_load_s"] = load_s
    timings["variants_quant"] = out
    return launches


def _variants_tier(card, timings, model, prompts):
    """The lane over a pool too small to keep finished prompts, with a
    host-DRAM tier: a shared-prefix prompt served, served again while
    its pages are resident, pushed out by long prompts (its pages
    demote), then served a third time (its pages readmitted) — the third
    completion byte-identical to the second; then the wire's export and
    import per page."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.ops import _cuda

    hot = {k: t for k, t in prompts.items() if k.startswith("s/")}
    key = next(iter(hot))
    fill = sorted(((k, t) for k, t in prompts.items()
                   if k.startswith("d/")), key=lambda kt: -len(kt[1]))[:4]
    name = f"/spt-smoke-t{os.getpid()}"
    st = Store.create(name, nslots=128, max_val=8192, vec_dim=0)
    try:
        comp = Completer(st, model=model, tokenizer=_piece_tokenizer(),
                         template="none", max_new_tokens=VARIANT_NEW_TOKENS,
                         pool_pages=24, kv_tier_pages=128)
        comp.attach()
        _cuda.LAUNCHES.reset()
        t0 = time.perf_counter()
        outs = []
        for rnd in range(3):
            if rnd == 2:
                for fk, ft in fill:
                    _drive_continuous(comp, st, P, [{fk: ft}])
            _drive_continuous(comp, st, P, [{key: hot[key]}])
            outs.append(bytes(st.get(key).rstrip(b"\0")))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = {k: _cuda.LAUNCHES[k] for k in ("causal_fwd", "paged_fwd")}
        comp.publish_stats()
        snap = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
        _check_no_abort(comp, comp.stats.tokens, 3 + len(fill),
                        "tier lane")
        check(snap["tier_readmits"] > 0 and snap["tier_demotions"] > 0,
              f"tier lane: demotions {snap['tier_demotions']}, readmits "
              f"{snap['tier_readmits']}")
        check(outs[2] == outs[1], "tier lane: the readmitted prompt's "
              "completion differs from the resident one's")
        check(counts["causal_fwd"] > 0 and counts["paged_fwd"] > 0,
              f"tier lane: K4/K5 never launched: {counts}")
        check(comp._paged_cache.used_pages == 0, "tier lane: pages leaked")
    finally:
        st.close()
        Store.unlink(name)

    # the wire alone: one row's pages out to host bytes and back in
    ids = np.asarray(_piece_tokenizer().encode(fill[0][1]), np.int32)
    cache = model.init_paged(2)
    model.paged_prefill_row(cache, ids, 0)
    n_pages = len(cache._owned[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pages = [model.export_page_bytes(cache, int(b))
             for b in cache.tables[0, :n_pages]]
    export_ms = (time.perf_counter() - t0) / n_pages * 1e3
    check(cache.ensure(1, len(ids)), "tier wire: no room for the copy")
    t0 = time.perf_counter()
    for p, (buf, sbuf) in enumerate(pages):
        model.import_page_bytes(cache, int(cache.tables[1, p]), buf, sbuf)
    torch.cuda.synchronize()
    import_ms = (time.perf_counter() - t0) / n_pages * 1e3
    for li in range(model.cfg.layers):
        a = cache.k_pools[li][cache.tables[0, :n_pages]]
        b = cache.k_pools[li][cache.tables[1, :n_pages]]
        check(torch.equal(a, b), "tier wire: imported pages differ")
    page_mb = model.page_wire_bytes(cache) / 1e6
    cache.reset()
    del cache
    torch.cuda.empty_cache()
    log(f"variants, tier: pool 24 pages + host tier 128; "
        f"tier_demotions {snap['tier_demotions']}, tier_readmits "
        f"{snap['tier_readmits']}, tier_spills {snap['tier_spills']}, "
        f"prefix hits {snap['prefix_hits']}; the readmitted prompt's "
        f"completion byte-identical to the resident one's; {wall:.2f}s "
        f"for {3 + len(fill)} requests; K4 {counts['causal_fwd']}, K5 "
        f"{counts['paged_fwd']} [{card}]")
    log(f"  page wire (bf16, {page_mb:.3f} MB a page, host wall): "
        f"export_page_bytes {export_ms:.3f} ms a page, import_page_bytes "
        f"{import_ms:.3f} ms a page ({n_pages} pages) [{card}]")
    timings["variants_tier"] = {
        "tier_readmits": snap["tier_readmits"],
        "tier_demotions": snap["tier_demotions"], "wall_s": wall,
        "export_ms_per_page": export_ms, "import_ms_per_page": import_ms,
        "page_mb": page_mb}
    return counts


def _variants_disagg(card, timings, model, prompts, tmp,
                     what="variants, disagg", record="variants_disagg"):
    """A PrefillLane and a DecodeLane on the one card over one store (one
    process, the lanes on two threads); completions against the unified
    lane's on the same prompts, and each prompt's first decode step over
    adopted wire pages against the same step over the pages it was
    prefilled into.  The record goes to timings[record]."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.engine.disagg import DecodeLane, PrefillLane
    from libsplinter_tpu_torch.ops import _cuda

    kw = dict(tokenizer=_piece_tokenizer(), template="none",
              max_new_tokens=VARIANT_NEW_TOKENS)
    walls = []

    class TimedPrefill(PrefillLane):
        def _handoff_one(self, idx):
            t0 = time.perf_counter()
            done = super()._handoff_one(idx)
            walls.append(time.perf_counter() - t0)
            return done

    outs = {}
    # the handoff writes each wire page (4.7 MB at 12 layers) as one
    # store value: the split lanes share a file-backed store whose
    # values hold a page
    wire_path = os.path.join(tmp, "disagg.spt")
    for tag in ("unified", "split"):
        if tag == "unified":
            name = f"/spt-smoke-du{os.getpid()}"
            st = Store.create(name, nslots=256, max_val=8192, vec_dim=0)
        else:
            name = wire_path
            st = Store.create(name, nslots=512, max_val=5 << 20, vec_dim=0,
                              persistent=True)
        try:
            if tag == "unified":
                comp = Completer(st, model=model, **kw)
                comp.attach()
                _, uwall = _drive_continuous(comp, st, P, [prompts])
                outs[tag] = _served_bytes(st, prompts)
                continue
            pf, dl = TimedPrefill(st, model=model, **kw), \
                DecodeLane(st, model=model, **kw)
            pf.attach()
            dl.attach()
            _cuda.LAUNCHES.reset()
            th = threading.Thread(target=pf.run_continuous,
                                  kwargs=dict(idle_timeout_ms=20,
                                              stop_after=phase_left()),
                                  daemon=True)
            th.start()
            n, wall = _drive_continuous(dl, st, P, [prompts])
            pf.stop()
            th.join(timeout=60)
            torch.cuda.synchronize()
            counts = {k: _cuda.LAUNCHES[k]
                      for k in ("causal_fwd", "paged_fwd")}
            _check_served(st, P, prompts)
            _check_no_abort(dl, dl.stats.tokens, n, "disagg decode lane")
            check(pf.stats.faults == 0, f"disagg prefill lane: "
                  f"{pf.stats.faults} key faults")
            pstats, dstats = dict(pf._lane_stats), dict(dl._lane_stats)
            check(pstats["handoffs"] == n and dstats["adopted"] == n
                  and dstats["handoff_refill"] == 0
                  and pstats["handoff_failed"] == 0,
                  f"disagg: prefill {pstats}, decode {dstats}")
            check(counts["causal_fwd"] > 0 and counts["paged_fwd"] > 0,
                  f"disagg: K4/K5 never launched: {counts}")
            outs[tag] = _served_bytes(st, prompts)
        finally:
            st.close()
            Store.unlink(name, persistent=tag == "split")
    same = sum(outs["split"][k] == outs["unified"][k] for k in prompts)

    # the wire itself: each prompt's first decode step over its adopted
    # pages against the same step over the pages it was prefilled into
    worst_cos, worst_err, exact = 1.0, 0.0, 0
    src, dst = model.init_paged(2), model.init_paged(2)
    tok_izer = _piece_tokenizer()
    for key, text in prompts.items():
        ids = np.asarray(tok_izer.encode(text), np.int32)
        logits = model.paged_prefill_row(src, ids, 0)
        pages, scales = model.export_row_pages(src, 0)
        check(model.paged_adopt_row(dst, 0, len(ids), pages, scales),
              "disagg wire: adoption backpressured in an empty pool")
        tok = int(np.argmax(logits))
        steps = []
        for cache in (src, dst):
            with torch.no_grad():
                toks = torch.zeros((2, 1), dtype=torch.int64, device="cuda")
                toks[0, 0] = tok
                lg = model.module(
                    toks, cache.layers(), 0,
                    lengths=torch.from_numpy(cache.lengths.copy()).cuda(),
                    tables=torch.from_numpy(cache.tables.copy()).cuda())
            steps.append(lg[0, 0].float().cpu().numpy())
        a, b = steps
        exact += int(np.array_equal(a, b))
        worst_err = max(worst_err, float(np.abs(a - b).max()))
        worst_cos = min(worst_cos, float(a @ b / (np.linalg.norm(a)
                                                  * np.linalg.norm(b))))
        src.free_row(0)
        dst.free_row(0)
    check(worst_cos >= 0.999, f"disagg wire: first-step logits cosine "
          f"{worst_cos} over adopted pages")
    del src, dst
    torch.cuda.empty_cache()
    wire_mb = pstats["handoff_wire_mb"]
    log(f"{what}: the unified lane (bf16 weights) first, {n} "
        f"requests, {n * VARIANT_NEW_TOKENS} tokens in {uwall:.3f}s = "
        f"{n * VARIANT_NEW_TOKENS / uwall:.1f} tokens/s; PrefillLane + "
        f"DecodeLane, {n * VARIANT_NEW_TOKENS} tokens in {wall:.3f}s = "
        f"{n * VARIANT_NEW_TOKENS / wall:.1f} tokens/s; {same} of {n} "
        f"completions identical to the unified lane's; handoffs "
        f"{pstats['handoffs']}, wire {wire_mb:.3f} MB "
        f"({wire_mb / n:.3f} MB a handoff), prefill + handoff wall "
        f"{np.mean(walls) * 1e3:.1f} ms a handoff (mean of {len(walls)}); "
        f"first decode step over adopted pages vs the prefilled ones: "
        f"{exact} of {n} bit-identical, max err {worst_err:.3e}, cosine "
        f">= {worst_cos:.6f}; K4 {counts['causal_fwd']}, K5 "
        f"{counts['paged_fwd']} [{card}]")
    timings[record] = {
        "requests": n, "identical": same, "wall_s": wall,
        "unified_wall_s": uwall,
        "wire_mb": wire_mb, "handoff_ms": float(np.mean(walls) * 1e3),
        "step_exact": exact, "step_max_err": worst_err}
    return counts


def phase_variants(card, timings, tmp):
    """Int8-resident weights, the host-DRAM KV tier and the disaggregated
    lanes, each at DecoderConfig(layers=CUT_LAYERS) on the continuous lane
    with greedy sampling; returns K4/K5 launches by path."""
    import torch

    from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig

    t0 = time.perf_counter()
    model = CompletionModel(DecoderConfig(layers=CUT_LAYERS), seed=0,
                            temp=0.0, device="cuda")
    # the float weights every variant starts from, f32 on the host
    sd = {k: v.float().cpu() for k, v in model.module.state_dict().items()}
    prompts = _variant_prompts(np.random.default_rng(11), 16)
    # one entry a path: the two weight residencies, the tier, the split
    launches = _variants_quant(card, timings, sd, prompts,
                               os.path.join(tmp, "decoder-f16-q8-q4.gguf"))
    launches["tier"] = _variants_tier(card, timings, model, prompts)
    launches["disagg"] = _variants_disagg(card, timings, model, prompts, tmp)
    del model, sd
    torch.cuda.empty_cache()
    timings["variants_s"] = time.perf_counter() - t0
    log(f"variants phase: {timings['variants_s']:.1f}s [{card}]")
    return launches


# -- phase 10: speculative decoding ------------------------------------------

SPEC_NEW_TOKENS = 64
SPEC_DRAFT_LAYERS, SPEC_GAMMA = 3, 4       # 3 of CUT_LAYERS


def _id_tokenizer():
    """The piece tokenizer with every id streamed as its own "<id>"
    piece, so a completion reads back as its exact token ids (phase 10
    compares lanes token by token)."""
    class IdTokenizer(type(_piece_tokenizer())):
        def token_to_piece(self, tok: int) -> bytes:
            return f"<{tok}>".encode()

    return IdTokenizer()


def _pool_used(cache) -> tuple:
    """Pages held: (target, draft) for the paired speculative pools."""
    pair = getattr(cache, "draft", None)
    if pair is not None:
        return cache.target.used_pages, pair.used_pages
    return (cache.used_pages,)


def _ids_lane(model, prompts, what, **kw):
    """`prompts` through run_continuous on a fresh store with the id
    tokenizer: (token ids per key, wall s, K4/K5 launches, K5 launches
    by query tokens, the Completer, the pool pages held once the last
    key was READY)."""
    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.ops.paged_attention import LAUNCHES_BY_QTOKENS

    name = f"/spt-smoke-s{os.getpid()}"
    st = Store.create(name, nslots=128, max_val=8192, vec_dim=0)
    try:
        comp = Completer(st, model=model, tokenizer=_id_tokenizer(),
                         template="none", max_new_tokens=SPEC_NEW_TOKENS,
                         **kw)
        comp.attach()
        held = {}
        stop = comp.stop

        def stop_after_release():
            # the feeder stops the lane once every key is READY; a row's
            # pages return right after its READY flip
            deadline = time.monotonic() + 2.0
            while any(_pool_used(comp._paged_cache)) \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            held["pages"] = _pool_used(comp._paged_cache)
            stop()

        comp.stop = stop_after_release
        LAUNCHES_BY_QTOKENS.clear()
        counts, wall = _lane_run(comp, st, P, prompts, what)
        by_q = dict(LAUNCHES_BY_QTOKENS)
        ids = {k: [int(x) for x in re.findall(
            rb"<(\d+)>", st.get(k).rstrip(b"\0")[len(t.encode()):])]
            for k, t in prompts.items()}
    finally:
        st.close()
        Store.unlink(name)
    check(all(len(v) == SPEC_NEW_TOKENS for v in ids.values()),
          f"{what}: a completion did not read back as {SPEC_NEW_TOKENS} ids")
    return ids, wall, counts, by_q, comp, held["pages"]


def _lane_logits(model, ids, history):
    """The plain continuous lane's logits for output position
    len(history) of one row: its prompt `ids` prefilled into a 32-row
    pool (the lane's geometry; the other rows dead), then `history` fed
    back one decode step at a time, as the lane's chunks do."""
    import torch

    cache = model.init_paged(32)
    check(cache.ensure(0, len(ids) + len(history) + 1), "scratch pool full")
    logits = model.paged_prefill_row(cache, np.asarray(ids, np.int32), 0)
    tables = model._h2d(cache.tables)
    toks = torch.zeros((32, 1), dtype=torch.int64, device="cuda")
    for t in history:
        toks[0, 0] = int(t)
        with torch.no_grad():
            step = model.module(toks, cache.layers(), 0, tables=tables,
                                lengths=model._h2d(cache.lengths))
        logits = step[0, 0].float().cpu().numpy()
        cache.lengths[0] += 1
    cache.reset()
    return logits


def _first_divergences(model, comp, prompts, plain, spec, near_tie):
    """Per request, the first position where the speculative lane's
    greedy ids leave the plain lane's; each must be a near-tie of the
    plain lane's logits there (near_tie(top1, top2) true).  Returns
    (token agreement, [(key, position, top1, top2)])."""
    agree, cases = [], []
    for key, text in prompts.items():
        a, b = plain[key], spec[key]
        agree.append(float(np.mean(np.array(a) == np.array(b))))
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is None:
            continue
        ids = comp._clip_context(comp._tok.encode(text), bucketed=True)
        top = np.sort(_lane_logits(model, ids, a[:pos]))[::-1]
        cases.append((key, pos, float(top[0]), float(top[1])))
        check(near_tie(top[0], top[1]),
              f"{key}: speculative greedy leaves the plain lane at output "
              f"{pos} ({b[pos]} for {a[pos]}) where the plain top-2 logits "
              f"{top[0]:.6f} and {top[1]:.6f} are no near-tie")
    return float(np.mean(agree)), cases


def _bf16_near_tie(top1, top2):
    """Within 4 bf16 ulps of the larger logit."""
    ulp = 2.0 ** (np.floor(np.log2(abs(top1))) - 7)
    return top1 - top2 <= 4 * ulp


def _spec_pair(model):
    from libsplinter_tpu_torch.models import (SpeculativeCompletionModel,
                                              self_draft_model)

    return SpeculativeCompletionModel(
        model, self_draft_model(model, SPEC_DRAFT_LAYERS), gamma=SPEC_GAMMA)


def _spec_compare(card, model, prompts, what, near_tie, tie_text):
    """The plain lane and the speculative lane (a self-draft of the
    first SPEC_DRAFT_LAYERS layers, gamma 4, the acceptance floor off so
    the lane stays speculative) over the same prompts, both without the
    prefix cache (the paired pools have none); returns the record and
    launches."""
    plain, p_wall, p_counts, p_by_q, p_comp, p_held = _ids_lane(
        model, prompts, f"{what} plain", prefix_cache=False)
    spec_model = _spec_pair(model)
    spec, s_wall, s_counts, s_by_q, s_comp, s_held = _ids_lane(
        spec_model, prompts, f"{what} speculative",
        spec_min_acceptance=0.0)
    check(isinstance(s_comp._model, type(spec_model)),
          f"{what}: the speculative lane was demoted")
    check(p_held == (0,) and s_held == (0, 0),
          f"{what}: pages held after the drain: plain {p_held}, "
          f"speculative (target, draft) {s_held}")
    check(s_by_q.get(SPEC_GAMMA + 1, 0) > 0 and s_by_q.get(1, 0) > 0,
          f"{what}: K5 launches by query tokens {s_by_q}: no verify stack")
    m = spec_model
    check(m.stats_verified > m.stats_proposed > 0,
          f"{what}: verified {m.stats_verified} <= proposed "
          f"{m.stats_proposed}")
    agree, cases = _first_divergences(model, p_comp, prompts, plain, spec,
                                      near_tie)
    tokens = len(prompts) * SPEC_NEW_TOKENS
    log(f"speculative, {what}: {len(prompts)} requests x "
        f"{SPEC_NEW_TOKENS} tokens; greedy token agreement with the plain "
        f"lane {agree:.4f}, {len(cases)} first divergences, each a "
        f"near-tie of the plain lane's logits ({tie_text}): {cases}; "
        f"acceptance {m.acceptance_rate:.4f} (proposed {m.stats_proposed}, "
        f"accepted {m.stats_accepted}, verified {m.stats_verified}); "
        f"plain {tokens / p_wall:.1f} tokens/s, speculative "
        f"{tokens / s_wall:.1f} tokens/s (cold, prefill included); K4 "
        f"{p_counts['causal_fwd']} + {s_counts['causal_fwd']}, K5 "
        f"{p_counts['paged_fwd']} + {s_counts['paged_fwd']} (plain + "
        f"speculative), K5 by query tokens: plain {p_by_q}, speculative "
        f"{s_by_q}; pages held after the drain {s_held} [{card}]")
    rec = {"agreement": agree, "divergences": cases,
           "acceptance": m.acceptance_rate, "proposed": m.stats_proposed,
           "accepted": m.stats_accepted, "verified": m.stats_verified,
           "plain_tokens_per_s": tokens / p_wall,
           "spec_tokens_per_s": tokens / s_wall,
           "k5_by_q_tokens_spec": s_by_q}
    launches = {k: p_counts[k] + s_counts[k]
                for k in ("causal_fwd", "paged_fwd")}
    return rec, launches


def _spec_demotion_drill(card, model, prompts):
    """4 requests on a speculative lane with --spec-min-acceptance 0.99:
    the floor trips at a heartbeat, the heartbeat shows spec_demotions
    1, the lane adopts the plain target with a fresh pool at its next
    idle point, and every request ends READY."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.models.decoder import PagedKVCache
    from libsplinter_tpu_torch.ops import _cuda

    spec_model = _spec_pair(model)
    name = f"/spt-smoke-sd{os.getpid()}"
    st = Store.create(name, nslots=64, max_val=8192, vec_dim=0)
    out = {}
    try:
        comp = Completer(st, model=spec_model, tokenizer=_piece_tokenizer(),
                         template="none", max_new_tokens=SPEC_NEW_TOKENS,
                         spec_min_acceptance=0.99)
        comp.attach()

        def feeder():
            t0 = time.perf_counter()
            deadline = time.monotonic() + 120
            _ask(st, P, prompts)
            while time.monotonic() < deadline and not (
                    all(st.labels(k) & P.LBL_READY for k in prompts)
                    and isinstance(comp._paged_cache, PagedKVCache)):
                time.sleep(0.01)
            out["wall"] = time.perf_counter() - t0
            comp.stop()

        _cuda.LAUNCHES.reset()
        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        comp.run_continuous(idle_timeout_ms=20, stop_after=180)
        th.join(timeout=30)
        torch.cuda.synchronize()
        counts = {k: _cuda.LAUNCHES[k] for k in ("causal_fwd", "paged_fwd")}
        comp.publish_stats()
        beat = json.loads(st.get(P.KEY_COMPLETE_STATS).rstrip(b"\0"))
        _check_served(st, P, prompts)
    finally:
        st.close()
        Store.unlink(name)
    check(beat.get("spec_demotions") == 1 and comp._model is model,
          f"demotion drill: heartbeat spec_demotions "
          f"{beat.get('spec_demotions')}, model demoted "
          f"{comp._model is model}")
    check(isinstance(comp._paged_cache, PagedKVCache),
          "demotion drill: the lane kept the paired speculative pools")
    _check_no_abort(comp, comp.stats.tokens, len(prompts), "demotion drill")
    log(f"speculative, demotion drill: {len(prompts)} requests, floor "
        f"0.99; heartbeat spec_demotions {beat['spec_demotions']}, "
        f"spec_acceptance {beat.get('spec_acceptance')}, the lane adopted "
        f"the plain target with a fresh pool; all READY in "
        f"{out['wall']:.2f}s [{card}]")
    return {"spec_demotions": beat["spec_demotions"],
            "spec_acceptance": beat.get("spec_acceptance"),
            "wall_s": out["wall"]}, counts


def _spec_draft_weights(card, tmp):
    """--draft-weights: a DecoderConfig(layers=2) draft on phase 8's
    vocab written by gguf_writer, behind phase 8's decoder file.  In f32
    (TF32 off), built as completer.main builds it: the serial lane's
    greedy output for 2 requests equals the target-only output.  Then
    completer.main itself with --draft-weights serves the 2 requests on
    the card (bf16)."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import completer as comp_mod
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.models import (CompletionModel, DecoderConfig,
                                              GgufFile,
                                              SpeculativeCompletionModel,
                                              decoder_config_from_gguf,
                                              load_tokenizer)
    from libsplinter_tpu_torch.ops import _cuda

    target_path = os.path.join(tmp, "decoder-f16-q8-q4.gguf")
    rng = np.random.default_rng(37)          # phase 8's vocab draw
    draft_path, _, _, words = _gguf_decoder_file(
        DecoderConfig(layers=2), tmp, rng, name="draft-2-layers.gguf",
        mixed=False, seed=43)
    prompts = {f"draft/{i}": " ".join(rng.choice(words, n))
               for i, n in enumerate((40, 200))}
    with GgufFile(target_path) as gf:
        tcfg = decoder_config_from_gguf(gf, dtype=torch.float32)
        tok = load_tokenizer(gf)
    with GgufFile(draft_path) as gf:
        dcfg = decoder_config_from_gguf(gf, dtype=torch.float32)
    target = CompletionModel(tcfg, weights=target_path, temp=0.0,
                             device="cuda")
    draft = CompletionModel(dcfg, weights=draft_path, temp=0.0,
                            device="cuda")
    spec = SpeculativeCompletionModel(target, draft, gamma=SPEC_GAMMA)
    served = []
    _cuda.LAUNCHES.reset()
    for model in (target, spec):
        name = f"/spt-smoke-dw{os.getpid()}"
        st = Store.create(name, nslots=64, max_val=16384, vec_dim=0)
        try:
            comp = comp_mod.Completer(st, model=model, tokenizer=tok,
                                      template="chatml", batch_cap=1,
                                      max_new_tokens=SPEC_NEW_TOKENS)
            comp.attach()
            _ask(st, P, prompts)
            t0 = time.perf_counter()
            check(comp.run_once() == len(prompts), "serial lane: not served")
            wall = time.perf_counter() - t0
            served.append(_served_bytes(st, prompts))
            check(comp.stats.faults == 0 and comp.stats.completions == 2,
                  f"serial lane: {comp.stats}")
        finally:
            st.close()
            Store.unlink(name)
    check(served[0] == served[1], "--draft-weights serial lane: greedy "
          "output differs from the target-only output (f32)")
    torch.cuda.synchronize()
    counts = {k: _cuda.LAUNCHES[k] for k in ("causal_fwd", "paged_fwd")}
    acc = spec.acceptance_rate
    del target, draft, spec
    torch.cuda.empty_cache()

    # the flag itself, through completer.main on the card (bf16)
    name = f"/spt-smoke-dm{os.getpid()}"
    st = Store.create(name, nslots=64, max_val=16384, vec_dim=0)
    try:
        _ask(st, P, prompts)
        t0 = time.perf_counter()
        rc = comp_mod.main(["--store", name, "--weights", target_path,
                            "--draft-weights", draft_path, "--gamma",
                            str(SPEC_GAMMA), "--oneshot", "--template",
                            "auto", "--temp", "0", "--batch-cap", "1",
                            "--max-new-tokens", str(SPEC_NEW_TOKENS)])
        main_s = time.perf_counter() - t0
        ok = all(st.labels(k) & P.LBL_READY for k in prompts)
    finally:
        st.close()
        Store.unlink(name)
    check(rc == 0 and ok, f"completer.main --draft-weights: rc {rc}, "
          f"READY {ok}")
    log(f"speculative, --draft-weights ({os.path.getsize(draft_path)} "
        f"bytes, DecoderConfig(layers=2) on phase 8's vocab) behind phase "
        f"8's file: f32 serial lane, 2 requests x {SPEC_NEW_TOKENS} "
        f"tokens, greedy output byte-identical to the target-only lane's "
        f"(acceptance {acc:.4f}); completer.main --draft-weights served "
        f"both READY in {main_s:.2f}s (bf16, load included) [{card}]")
    return {"acceptance": acc, "main_s": main_s}, counts


def phase_speculative(card, timings, tmp):
    """Speculative decoding on the continuous lane at DecoderConfig()
    width and CUT_LAYERS depth, greedy, 8 of phase 9's prompts x 64
    tokens, a self-draft of 3 of 4 layers and gamma 4: f32 (TF32 off)
    and bf16 against the plain lane token for token (first divergences
    only at near-ties), acceptance
    and counters, no page held; the demotion drill; the serial lane
    with a --draft-weights GGUF.  Returns K4/K5 launches by path."""
    import torch

    from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig

    t0 = time.perf_counter()
    prompts = _variant_prompts(np.random.default_rng(11), 8)
    out, launches = {}, {}
    m32 = CompletionModel(DecoderConfig(layers=CUT_LAYERS,
                                        dtype=torch.float32), seed=0,
                          temp=0.0, device="cuda")
    out["f32"], launches["f32"] = _spec_compare(
        card, m32, prompts, "f32", lambda a, b: a - b < 1e-4,
        "top-2 within 1e-4")
    del m32
    torch.cuda.empty_cache()
    model = CompletionModel(DecoderConfig(layers=CUT_LAYERS), seed=0,
                            temp=0.0, device="cuda")
    out["bf16"], launches["bf16"] = _spec_compare(
        card, model, prompts, "bf16", _bf16_near_tie,
        "top-2 within 4 bf16 ulps of the larger")
    out["demotion"], launches["demotion"] = _spec_demotion_drill(
        card, model, dict(list(prompts.items())[:4]))
    del model
    torch.cuda.empty_cache()
    out["draft_weights"], launches["draft_weights"] = _spec_draft_weights(
        card, tmp)
    timings["speculative"] = out
    timings["speculative_s"] = time.perf_counter() - t0
    log(f"speculative phase: {timings['speculative_s']:.1f}s [{card}]")
    return launches


# -- phase 11: MoE on one card ------------------------------------------------

MOE_NEW_TOKENS = 64


def _moe_main(card, path, prompts, extra, what):
    """completer.main --weights <file> --continuous --template auto
    (greedy) over `prompts` on a fresh store, stopped once every key is
    READY: (the lane's Completer, served bytes, wall s, K4/K5
    launches)."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import completer as comp_mod
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.ops import _cuda

    base, made = comp_mod.Completer, []

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    name = f"/spt-smoke-moe{os.getpid()}"
    st = Store.create(name, nslots=64, max_val=16384, vec_dim=0)
    done, finished = {}, threading.Event()

    def feeder():
        deadline = time.monotonic() + phase_left()
        while not made:
            if finished.wait(0.01) or time.monotonic() > deadline:
                return
        t1 = time.perf_counter()
        _ask(st, P, prompts)
        busy = P.LBL_INFER_REQ | P.LBL_WAITING | P.LBL_SERVICING
        while time.monotonic() < deadline:
            if all(st.labels(k) & P.LBL_READY and not st.labels(k) & busy
                   for k in prompts):
                done["wall"] = time.perf_counter() - t1
                break
            time.sleep(0.01)
        while not finished.is_set():
            made[0].stop()
            finished.wait(0.5)

    th = threading.Thread(target=feeder, daemon=True)
    try:
        _cuda.LAUNCHES.reset()
        comp_mod.Completer = Recording
        th.start()
        rc = comp_mod.main(["--store", name, "--weights", path,
                            "--continuous", "--template", "auto", "--temp",
                            "0", "--max-new-tokens", str(MOE_NEW_TOKENS),
                            "--idle-timeout-ms", "20", *extra])
        torch.cuda.synchronize()
        counts = {k: _cuda.LAUNCHES[k] for k in ("causal_fwd", "paged_fwd")}
    finally:
        comp_mod.Completer = base
        finished.set()
        th.join(timeout=60)
        served = _served_bytes(st, prompts)
        labels = {k: st.labels(k) for k in prompts}
        st.close()
        Store.unlink(name)
    check(rc == 0 and made and "wall" in done,
          f"{what}: rc {rc}, served {made[0].stats.completions if made else 0}"
          f" of {len(prompts)}")
    comp = made[0]
    check(comp.template == "chatml", f"{what}: template {comp.template!r}")
    check(all(v & P.LBL_READY for v in labels.values()), f"{what}: READY")
    _check_no_abort(comp, comp.stats.tokens, len(prompts), what)
    check(counts["causal_fwd"] > 0 and counts["paged_fwd"] > 0,
          f"{what}: K4/K5 never launched: {counts}")
    return comp, served, done["wall"], counts


def _moe_reference(path, prompts):
    """The served bytes of a moe_completion_model built in-process from
    the same file, greedy, on the continuous lane (the same per-row
    computation as the daemon's)."""
    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.completer import Completer
    from libsplinter_tpu_torch.models import (GgufFile,
                                              decoder_config_from_gguf,
                                              load_tokenizer,
                                              moe_completion_model)

    with GgufFile(path) as gf:
        cfg = decoder_config_from_gguf(gf)
        tok = load_tokenizer(gf)
    model = moe_completion_model(cfg, weights=path, temp=0.0, device="cuda")
    name = f"/spt-smoke-mr{os.getpid()}"
    st = Store.create(name, nslots=64, max_val=16384, vec_dim=0)
    try:
        comp = Completer(st, model=model, tokenizer=tok, template="chatml",
                         max_new_tokens=MOE_NEW_TOKENS)
        comp.attach()
        _drive_continuous(comp, st, P, [prompts])
        return _served_bytes(st, prompts), model
    finally:
        st.close()
        Store.unlink(name)


def _expert_bytes(module):
    """Bytes the quantized expert stacks hold (codes and scales)."""
    return sum(b.numel() * b.element_size()
               for n, b in module.named_buffers() if "_experts_" in n)


def phase_moe(card, timings, tmp):
    """A Mixtral-family GGUF at DecoderConfig() geometry with 8 experts,
    top-2 (F16, phase 8's vocab and chatml template), opened cold and
    served by completer.main on the continuous lane, float and
    --quantized; returns K4/K5 launches by path."""
    import torch

    from libsplinter_tpu_torch.models import (GgufFile, MoeDecoderConfig,
                                              decoder_config_from_gguf,
                                              load_decoder_params,
                                              moe_completion_model)
    from libsplinter_tpu_torch.models.quant import (QUANT_LEAVES,
                                                    quantize_state_dict)

    t0 = time.perf_counter()
    cfg = MoeDecoderConfig(n_experts=8, top_k=2, layers=CUT_LAYERS)
    rng = np.random.default_rng(37)              # phase 8's vocab draw
    path, write_s, expect, words = _gguf_decoder_file(
        cfg, tmp, rng, name="moe-8x-f16.gguf", mixed=False, seed=47)
    t1 = time.perf_counter()
    with GgufFile(path) as gf:
        lcfg = decoder_config_from_gguf(gf)
    sd = load_decoder_params(path, lcfg)
    load_s = time.perf_counter() - t1
    check(lcfg == cfg, f"MoE config from the file {lcfg} != {cfg}")
    bad = [k for k in expect if not torch.equal(sd[k], expect[k])]
    check(sorted(sd) == sorted(expect) and not bad,
          f"MoE file: {len(bad)} tensors differ, e.g. {bad[:3]}")
    del expect
    prompts = {f"moe/{i}": " ".join(rng.choice(words, n))
               for i, n in enumerate((30, 90, 160, 240, 320, 400, 520, 640))}
    log(f"moe: MoeDecoderConfig(8 experts, top-2, {cfg.layers} layers) at "
        f"DecoderConfig() width as F16 ({os.path.getsize(path)} bytes) "
        f"written in {write_s:.2f}s, "
        f"config + state_dict read back in {load_s:.2f}s, every tensor its "
        f"source's f16 rounding [{card}]")

    launches, out = {}, {}
    comp, served, wall, launches["float"] = _moe_main(
        card, path, prompts, [], "moe lane")
    tokens = comp.stats.tokens
    del comp
    torch.cuda.empty_cache()
    want, ref = _moe_reference(path, prompts)
    check(served == want, "moe lane: completer.main's completions differ "
          "from an in-process moe_completion_model's on the same file")
    del ref
    torch.cuda.empty_cache()
    out["float"] = {"tokens_per_s": tokens / wall, "wall_s": wall}
    log(f"moe lane: completer.main --weights <file> --continuous --template "
        f"auto, {len(prompts)} requests x {MOE_NEW_TOKENS} tokens, "
        f"{tokens / wall:.1f} tokens/s (cold, prefill included), "
        f"completions byte-identical to an in-process moe_completion_model"
        f"'s; K4 {launches['float']['causal_fwd']}, K5 "
        f"{launches['float']['paged_fwd']} [{card}]")

    comp, _, qwall, launches["quantized"] = _moe_main(
        card, path, prompts, ["--quantized"], "moe lane --quantized")
    qtokens = comp.stats.tokens
    ratio = _expert_bytes(comp._model.module) / (
        cfg.layers * 3 * cfg.n_experts * cfg.hidden * cfg.mlp_dim * 2)
    check(abs(ratio - 0.5625) < 1e-9, f"moe --quantized: experts hold "
          f"{ratio} x bf16, geometry 0.5625")
    del comp
    torch.cuda.empty_cache()

    # first-step logits of the int8-expert model against the float model
    # on the dequantized weights, f32 (TF32 off)
    qcfg = dataclasses.replace(lcfg, dtype=torch.float32, quantized=True)
    qsd = quantize_state_dict(sd, QUANT_LEAVES)
    ids = np.asarray(_chatml_ids(path, prompts["moe/2"]), np.int32)
    qm = moe_completion_model(qcfg, params=qsd, temp=0.0, device="cuda")
    fm = moe_completion_model(dataclasses.replace(lcfg, dtype=torch.float32),
                              params=_dequantized_state(qsd), temp=0.0,
                              device="cuda")
    a, b = qm.prefill(ids), fm.prefill(ids)
    tok = int(np.argmax(b))
    err = max(float(np.abs(a - b).max()),
              float(np.abs(qm.decode_one(tok) - fm.decode_one(tok)).max()))
    check(err <= 1e-5, f"moe --quantized f32: logits {err} from the float "
          f"model on the dequantized weights (bar 1e-5)")
    del qm, fm, qsd, sd
    torch.cuda.empty_cache()
    out["quantized"] = {"tokens_per_s": qtokens / qwall, "wall_s": qwall,
                        "expert_ratio": ratio, "f32_max_err": err}
    log(f"moe lane --quantized: {len(prompts)} requests, "
        f"{qtokens / qwall:.1f} tokens/s; experts resident {ratio:.4f} x "
        f"bf16; first-step logits vs the float model on the dequantized "
        f"weights, f32: max err {err:.3e} (bar 1e-5); K4 "
        f"{launches['quantized']['causal_fwd']}, K5 "
        f"{launches['quantized']['paged_fwd']} [{card}]")
    out.update(write_s=write_s, load_s=load_s,
               file_bytes=os.path.getsize(path))
    timings["moe"] = out
    timings["moe_s"] = time.perf_counter() - t0
    log(f"moe phase: {timings['moe_s']:.1f}s [{card}]")
    return launches


# -- phase 12: supervision ----------------------------------------------------

SUP_SLOTS = 65536
SUP_NEW_TOKENS = 32
SUP_LANES = ("embedder", "searcher", "completer", "pipeliner", "telemetry",
             "autoscaler")
SUP_FAULT = ("embedder.encode:crash@1,searcher.gather:crash@1,"
             "completer.commit:crash@1")
# a child's first load on the card (torch import, kernel libraries, CUDA
# context, a full-width model from its GGUF) before its first heartbeat
SUP_GRACE_S = 120
# the Lua RAG chain of tests/test_torch_pipeliner.py: embed the query,
# search with its vector, complete on the top hit's text
RAG_SCRIPT = """
local qkey, text, k, ckey = ...
local ok, err = splinter.submit_embed(qkey, text)
if not ok then error(err) end
local scratch = qkey .. "/q"
splinter.set(scratch, "scratch")
splinter.set_embedding(scratch, splinter.get_embedding(qkey))
local hits, serr = splinter.submit_search(scratch, k)
splinter.unset(scratch)
if not hits then error(serr) end
local out, cerr = splinter.submit_completion(
    ckey, "ctx: " .. splinter.get(hits[1]) .. " q: " .. text)
if not out then error(cerr) end
return hits, out
"""


def _wait_for(pred, timeout, what, dt=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(dt)
    check(pred(), f"supervision: timed out after {timeout}s waiting for "
          f"{what}")


def _heartbeat_launches(hb) -> dict:
    """A lane's kernel launches from the kernel_<name> fields of its
    heartbeat's "dispatch" section."""
    return {k[len("kernel_"):]: v for k, v in hb.get("dispatch", {}).items()
            if k.startswith("kernel_")}


def _read_json(st, key):
    try:
        return json.loads(st.get(key).rstrip(b"\0"))
    except (KeyError, OSError, ValueError):
        return None


class _SupervisorWatch:
    """Samples __supervisor_stats every 50 ms on a thread: every child pid
    it ever names, when each lane first ran, when the supervisor saw each
    crash and when the next generation's first heartbeat came."""

    def __init__(self, st, P, t0):
        self.st, self.P, self.t0 = st, P, t0
        self.pids: set[int] = set()
        self.first_run: dict[str, float] = {}
        self.crash: dict[str, float] = {}
        self.back: dict[str, float] = {}
        self.stats = None
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._loop, daemon=True)
        self._th.start()

    def _loop(self):
        while not self._stop.wait(0.05):
            snap = _read_json(self.st, self.P.KEY_SUPERVISOR_STATS)
            if snap is None:
                continue
            self.stats = snap
            now = time.perf_counter() - self.t0
            for lane, sec in snap.get("lanes", {}).items():
                for rep in [sec] + list(sec.get("replicas", {}).values()):
                    if rep.get("pid"):
                        self.pids.add(int(rep["pid"]))
                if sec.get("state") == "running":
                    self.first_run.setdefault(lane, now)
                if sec.get("last_exit") is not None:
                    self.crash.setdefault(lane, now)
                if (lane in self.crash and sec.get("restarts", 0) >= 1
                        and sec.get("state") == "running"):
                    self.back.setdefault(lane, now)

    def lane(self, name):
        return (self.stats or {}).get("lanes", {}).get(name, {})

    def close(self):
        self._stop.set()
        self._th.join(timeout=5)


def _sup_texts(rng, words, n_long, n_short, prefix):
    """n_long texts of 300-900 vocab words (buckets 512 and 1024: K1)
    and n_short of 8-200."""
    spans = [(300, 900)] * n_long + [(8, 200)] * n_short
    return {f"{prefix}/{i:02d}": " ".join(rng.choice(words,
                                                      int(rng.integers(*s))))
            for i, s in enumerate(spans)}


def phase_supervision(card, timings, tmp):
    """`python -m libsplinter_tpu_torch.engine.supervisor` over all six
    lanes on one file-backed store, phase 8's full-width GGUF files as
    the model lanes' weights, SPTPU_FAULT crashing the embedder, the
    searcher and the completer once each: embeds, searches, completions,
    a Lua RAG chain through the pipeliner, a scale-up to two embedder
    replicas and back, then SIGTERM.  Returns each lane's kernel
    launches, read from its heartbeat."""
    import torch

    from libsplinter_tpu_torch import T_VARTEXT, Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.engine.pipeliner import submit_script
    from libsplinter_tpu_torch.engine.searcher import (consume_result,
                                                       submit_search)
    from libsplinter_tpu_torch.engine.telemetry import read_history
    from libsplinter_tpu_torch.models import (EmbeddingModel, GgufFile,
                                              encoder_config_from_gguf,
                                              load_tokenizer)

    enc = os.path.join(tmp, "encoder-f16.gguf")
    dec = os.path.join(tmp, "decoder-f16-q8-q4.gguf")
    check(os.path.exists(enc) and os.path.exists(dec),
          "supervision: phase 8's GGUF files are missing")
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="spt-smoke-sup-")
    path = os.path.join(work, "lane.spt")
    logf = open(os.path.join(work, "supervisor.log"), "w+")
    st = proc = watch = ref_st = None
    ref_name = f"/spt-smoke-supref{os.getpid()}"
    ok = False
    try:
        st = Store.create(path, nslots=SUP_SLOTS, max_val=8192,
                          vec_dim=LANE_DIM, persistent=True)
        n_syn = _fill_lane(st, int(SUP_SLOTS * 0.9537), seed=5)
        st.drain_dirty()     # the synthetic rows are no embed requests
        fill_s = time.perf_counter() - t0
        with GgufFile(enc) as gf:
            ecfg = encoder_config_from_gguf(gf, out_dim=LANE_DIM)
            etok = load_tokenizer(gf)
            words = [w for w in gf.metadata["tokenizer.ggml.tokens"][5:]
                     if not w.startswith("##")]
        rng = np.random.default_rng(12)

        # the supervisor as users start it, from a directory that does not
        # hold the package: its own import comes from PYTHONPATH, its
        # children's from the PYTHONPATH it hands them
        env = dict(os.environ, SPTPU_FAULT=SUP_FAULT,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        argv = [sys.executable, "-m",
                "libsplinter_tpu_torch.engine.supervisor", "--store", path,
                "--persistent",
                "--lanes", ",".join(SUP_LANES),
                "--embedder-args", f"--weights {enc}",
                "--completer-args",
                f"--weights {dec} --continuous --temp 0 --max-new-tokens "
                f"{SUP_NEW_TOKENS}",
                "--pin-chips", "completer=0",
                "--startup-grace-s", str(SUP_GRACE_S)]
        t_sup = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=work, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        watch = _SupervisorWatch(st, P, t_sup)
        log(f"supervision: file-backed store {SUP_SLOTS} slots x "
            f"{LANE_DIM}-d, {n_syn} synthetic unit vectors in {fill_s:.1f}s; "
            f"supervisor pid {proc.pid} over {', '.join(SUP_LANES)}, "
            f"SPTPU_FAULT={SUP_FAULT}, --pin-chips completer=0, startup "
            f"grace {SUP_GRACE_S}s; card free {free0 / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB before")

        # 3. embed: 32 texts, 16 of them in buckets >= 512 (K1); the
        # embedder's first encode crashes it.  The 8 completions of step
        # 5 go in at the same moment: the two lanes' crashes and
        # restarts overlap (the steps' checks run in order below)
        texts = _sup_texts(rng, words, 16, 16, "sup")
        prompts = {f"ask/{i}": _sup_prompt(rng, n) for i, n in
                   enumerate((40, 150, 300, 500, 700, 900, 1200, 1500))}
        t_emb = time.perf_counter()
        for key, text in texts.items():
            st.set(key, text)
            st.set_type(key, T_VARTEXT)
            st.label_or(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
            st.bump(key)
        _ask(st, P, prompts)
        busy = P.LBL_EMBED_REQ | P.LBL_WAITING
        _wait_for(lambda: not any(st.labels(k) & busy for k in texts),
                  phase_left(), "the 32 embeds")
        embed_s = time.perf_counter() - t_emb
        for key in texts:
            v = st.vec_get(key)
            check(np.isfinite(v).all()
                  and abs(float(np.linalg.norm(v)) - 1.0) < 1e-3,
                  f"supervised embed {key}: norm {np.linalg.norm(v)}")
        _wait_for(lambda: watch.lane("embedder").get("restarts", 0) >= 1,
                  30, "the embedder's restart in __supervisor_stats")
        check(watch.lane("embedder").get("state") != "down",
              "supervision: the embedder's breaker opened")
        # the same file in-process on the card: what one replica commits
        ref_st = Store.create(ref_name, nslots=4096, max_val=8192,
                              vec_dim=LANE_DIM)
        ref_emb = Embedder(ref_st, model=EmbeddingModel(ecfg, weights=enc,
                                                        device="cuda"),
                           tokenizer=etok, max_ctx=ecfg.max_len)
        ref_emb.attach()

        def ref_cosines(keys):
            for key in keys:
                ref_st.set(key, st.get(key).rstrip(b"\0"))
                ref_st.set_type(key, T_VARTEXT)
                ref_st.label_or(key, P.LBL_EMBED_REQ)
                ref_st.bump(key)
            check(ref_emb.run_once() == len(keys), "in-process reference")
            return {k: float(st.vec_get(k) @ ref_st.vec_get(k))
                    for k in keys}

        some = list(texts)[::4]                      # 8: 4 long, 4 short
        cos = ref_cosines(some)
        check(min(cos.values()) >= 0.999, f"supervised embeds against the "
              f"in-process model: cosines {cos}")
        log(f"supervised embed: 32 texts committed in {embed_s:.2f}s "
            f"(the first encode crashed the lane: restarts "
            f"{watch.lane('embedder')['restarts']}); 8 against the "
            f"in-process model on the file: cosine >= "
            f"{min(cos.values()):.6f} [{card}]")

        # 4. search: k = 10 (K2) and k = 200 (K3); the searcher's first
        # gather crashes it
        srcs = list(texts)[16:18]
        for j, src in enumerate(srcs):
            st.set(f"__q/sup{j}", "q")
            st.vec_set(f"__q/sup{j}", st.vec_get(src))
        t_srch = time.perf_counter()
        recs = {k: {f"__q/sup{j}": submit_search(
            st, f"__q/sup{j}", k, timeout_ms=phase_left() * 1000)
            for j in range(len(srcs))} for k in (10, 200)}
        search_s = time.perf_counter() - t_srch
        _wait_for(lambda: watch.lane("searcher").get("restarts", 0) >= 1,
                  30, "the searcher's restart")
        check(watch.lane("searcher").get("state") != "down",
              "supervision: the searcher's breaker opened")
        # a copy of the lane as it stands now, on the card
        lane = torch.from_numpy(np.array(st.vectors.view(np.ndarray))).cuda()
        base = torch.from_numpy(P.candidate_mask(st, 0)).cuda()
        for j in range(len(srcs)):
            base[st.find_index(f"__q/sup{j}")] = 0.0
        swaps = 0
        for k, by_key in recs.items():
            for j, src in enumerate(srcs):
                key = f"__q/sup{j}"
                rec = by_key[key]
                check(rec is not None and "err" not in rec
                      and len(rec["keys"]) == k and rec["keys"][0] == src,
                      f"supervised search {key} k={k}: {rec}")
                want, _, all_s, all_i = _plain_topk_keys(
                    st, lane, st.vec_get(src), base,
                    16 if k == 10 else 204, k)
                swaps += _same_ranking(rec["i"], rec["s"], want, all_s,
                                       all_i)
                consume_result(st, key)
        del lane, base
        torch.cuda.empty_cache()
        log(f"supervised search: k=10 and k=200 x {len(srcs)} in "
            f"{search_s:.2f}s (the lane's upload included; the searcher "
            f"crashed at its first gather: restarts "
            f"{watch.lane('searcher')['restarts']}); rows equal the plain "
            f"top-k on the card ({swaps} near-tie swaps) [{card}]")

        # 5. complete: 8 prompts of 40-1500 bytes (submitted with the
        # embeds); the completer crashes at its first commit and the next
        # generation re-serves all 8
        cbusy = P.LBL_INFER_REQ | P.LBL_WAITING | P.LBL_SERVICING
        _wait_for(lambda: all(st.labels(k) & P.LBL_READY
                              and not st.labels(k) & cbusy
                              for k in prompts), 300, "the 8 completions")
        complete_s = time.perf_counter() - t_emb
        _wait_for(lambda: watch.lane("completer").get("restarts", 0) >= 1,
                  30, "the completer's restart")
        check(watch.lane("completer").get("state") != "down",
              "supervision: the completer's breaker opened")
        for key, text in prompts.items():
            got = st.get(key).rstrip(b"\0")
            check(text.encode() in got, f"{key}: the prompt is not in the "
                  f"served slot")

        def settled():
            hb = _read_json(st, P.KEY_COMPLETE_STATS)
            return (hb is not None and hb.get("completions") == len(prompts)
                    and hb.get("live_tokens") == 0 and hb)

        _wait_for(settled, 30, "the completer's heartbeat after the drain")
        chb = settled()
        held = chb["pages_used"] - chb.get("prefix_evictable", 0)
        check(chb["tokens"] == SUP_NEW_TOKENS * len(prompts)
              and chb["aborts"] == 0 and held == 0,
              f"completer heartbeat: tokens {chb['tokens']} (want "
              f"{SUP_NEW_TOKENS * len(prompts)}), aborts {chb['aborts']}, "
              f"{held} pages held by a row ({chb['pages_used']} used, "
              f"{chb.get('prefix_evictable')} reclaimable prefix pages)")
        log(f"supervised completion: 8 prompts of 40-1500 bytes READY "
            f"{complete_s:.2f}s after they were submitted, each with {SUP_NEW_TOKENS} new tokens "
            f"(the first generation crashed at its first commit and its "
            f"successor reclaimed {chb['reclaimed']} stranded rows); no "
            f"page held after the drain [{card}]")

        # 6. one Lua RAG chain through the pipeliner
        qtext = texts[srcs[1]]
        t_rag = time.perf_counter()
        rag = submit_script(st, "__rag/sup", script=RAG_SCRIPT,
                            args=["__rag/q", qtext, 5, "rag/answer"],
                            timeout_ms=phase_left() * 1000)
        rag_s = time.perf_counter() - t_rag
        check(rag is not None and rag.get("ok") is True,
              f"RAG chain: {rag}")
        hits = rag["ret"][0]
        st.set("__q/rag", "q")
        st.vec_set("__q/rag", st.vec_get("__rag/q"))
        direct = submit_search(st, "__q/rag", 5,
                               timeout_ms=phase_left() * 1000)
        check(direct is not None and direct.get("keys") == hits
              and hits[0] == srcs[1],
              f"RAG chain hits {hits} != a direct search's {direct}")
        consume_result(st, "__q/rag")
        check(st.labels("rag/answer") & P.LBL_READY
              and not st.labels("rag/answer") & cbusy,
              "RAG chain: the completion is not READY")
        log(f"supervised pipeline: a Lua RAG chain (embed -> k=5 search -> "
            f"complete) in {rag_s:.2f}s, its hits equal a direct search's, "
            f"the completion READY [{card}]")

        def fresh(key, after):
            hb = _read_json(st, key)
            return hb if hb is not None and hb["ts"] > after else None

        # 7. scale the embedder to two replicas, a burst, then back to one
        P.write_scale_target(st, "embedder", 2, src="manual")
        t_up = time.perf_counter()

        def promoted():
            rec = P.read_stripe_map(st, "embedder")
            return (rec is not None and "1" in rec.get("owners", {})
                    and not rec.get("pending"))

        _wait_for(promoted, phase_left(), "replica 1's promotion")
        up_s = time.perf_counter() - t_up
        t_hb = time.time()
        _wait_for(lambda: fresh(P.KEY_EMBED_STATS, t_hb), 30,
                  "the embedder's heartbeat before the burst")
        before = fresh(P.KEY_EMBED_STATS, t_hb)["embedded"]
        burst = _sup_texts(rng, words, 8, 24, "burst")
        t_burst = time.perf_counter()
        for key, text in burst.items():
            st.set(key, text)
            st.set_type(key, T_VARTEXT)
            st.label_or(key, P.LBL_EMBED_REQ | P.LBL_WAITING)
            st.bump(key)
        _wait_for(lambda: not any(st.labels(k) & busy for k in burst),
                  phase_left(), "the burst")
        burst_s = time.perf_counter() - t_burst
        r1_key = P.replica_stats_key(P.KEY_EMBED_STATS, 1)

        def shares():
            h0, h1 = _read_json(st, P.KEY_EMBED_STATS), _read_json(st,
                                                                  r1_key)
            if h0 is None or h1 is None:
                return None
            return h0["embedded"] - before, h1["embedded"], h1

        _wait_for(lambda: (s := shares()) is not None
                  and s[0] + s[1] >= len(burst), 30,
                  "both replicas' heartbeats after the burst")
        n0, n1, r1_hb = shares()
        check(n0 > 0 and n1 > 0, f"burst split {n0} / {n1}: a replica "
              f"served nothing")
        cos = ref_cosines(list(burst))
        check(min(cos.values()) >= 0.999, f"burst vectors against the "
              f"in-process model: min cosine {min(cos.values())}")
        P.write_scale_target(st, "embedder", 1, src="manual")
        t_down = time.perf_counter()
        _wait_for(lambda: watch.stats is not None
                  and watch.stats.get("retired", 0) >= 1
                  and "replicas" not in watch.lane("embedder")
                  and watch.lane("embedder").get("r") == 1, 120,
                  "replica 1's retirement")
        down_s = time.perf_counter() - t_down
        check(all(not st.labels(k) & busy for k in burst),
              "a burst row was stranded")
        rings = {ln: read_history(st, ln) is not None
                 for ln in ("embedder", "searcher", "completer",
                            "pipeliner")}
        check(all(rings.values()), f"telemetry rings missing: {rings}")
        log(f"supervised scale: replica 1 promoted {up_s:.2f}s after the "
            f"target; a burst of 32 in {burst_s:.2f}s split {n0} / {n1}, "
            f"cosine >= {min(cos.values()):.6f} against the in-process "
            f"model; replica 1 drained and retired {down_s:.2f}s after the "
            f"target of 1; telemetry rings for {', '.join(rings)} [{card}]")

        # 8. the children's kernel launches, from their heartbeats
        t_read = time.time() + 0.5
        launches = {}
        for lane, key in (("embedder", P.KEY_EMBED_STATS),
                          ("searcher", P.KEY_SEARCH_STATS),
                          ("completer", P.KEY_COMPLETE_STATS)):
            _wait_for(lambda: fresh(key, t_read), 30, f"{lane}'s heartbeat")
            launches[lane] = _heartbeat_launches(fresh(key, t_read))
        launches["embedder.r1"] = _heartbeat_launches(r1_hb)
        want = {"embedder": ("flash_fwd",),
                "searcher": ("fused_topk", "cosine_scores"),
                "completer": ("causal_fwd", "paged_fwd")}
        for lane, names in want.items():
            for name in names:
                check(launches[lane][name] > 0, f"supervised {lane}: "
                      f"{name} never launched: {launches[lane]}")
        restarts = {ln: watch.lane(ln).get("restarts") for ln in SUP_LANES}
        check(all(restarts[ln] == 0 for ln in ("pipeliner", "telemetry",
                                               "autoscaler")),
              f"a torch-free lane restarted: {restarts}")

        # shutdown: SIGTERM, exit 0, no child left
        watch.close()
        pids = set(watch.pids)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"supervisor exit code {rc} after SIGTERM")
        _wait_for(lambda: not any(P.pid_alive(p) for p in pids), 30,
                  "every child to exit")
        torch.cuda.synchronize()
        free1, _ = torch.cuda.mem_get_info()
        wall = time.perf_counter() - t0
        walls = {ln: {"first_running_s": watch.first_run.get(ln),
                      "restart_s": (watch.back[ln] - watch.crash[ln]
                                    if ln in watch.back else None)}
                 for ln in SUP_LANES}
        log(f"supervision: {len(pids)} child processes, all gone after "
            f"SIGTERM (exit 0); restarts {restarts}; restart wall (crash "
            f"seen -> next generation's first heartbeat seen) "
            + ", ".join(f"{ln} {w['restart_s']:.2f}s" for ln, w in
                        walls.items() if w["restart_s"] is not None)
            + "; first running after spawn "
            + ", ".join(f"{ln} {w['first_running_s']:.2f}s" for ln, w in
                        walls.items() if w["first_running_s"] is not None)
            + f"; card free {free1 / 2**30:.2f} GiB after (before "
            f"{free0 / 2**30:.2f}) [{card}]")
        log(f"supervision: kernel launches by lane {json.dumps(launches)}")
        log(f"supervision phase: {wall:.1f}s [{card}]")
        timings["supervision"] = {
            "wall_s": wall, "fill_s": fill_s, "embed_s": embed_s,
            "search_s": search_s, "complete_s": complete_s, "rag_s": rag_s,
            "scale_up_s": up_s, "burst_s": burst_s, "scale_down_s": down_s,
            "restarts": restarts, "walls": walls, "burst_split": [n0, n1],
            "free_gib_before": free0 / 2**30,
            "free_gib_after": free1 / 2**30}
        ok = True
        out = {}
        for counts in launches.values():
            for name, n in counts.items():
                out[name] = out.get(name, 0) + n
        return launches, out
    finally:
        if watch is not None:
            watch.close()
        if not ok and st is not None:
            print(f"__supervisor_stats: "
                  f"{_read_json(st, P.KEY_SUPERVISOR_STATS)}",
                  file=sys.stderr)
        if proc is not None and proc.poll() is None:
            proc.terminate()          # the supervisor ends its children
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        if not ok:
            logf.seek(0)
            tail = logf.read()[-6000:]
            print(f"supervisor log (tail):\n{tail}", file=sys.stderr)
        logf.close()
        if st is not None:
            st.close()
            Store.unlink(path, persistent=True)
        if ref_st is not None:
            ref_st.close()
            Store.unlink(ref_name)
        shutil.rmtree(work, ignore_errors=True)


def _sup_prompt(rng, nbytes):
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"),
                                int(rng.integers(2, 9)))) for _ in range(200)]
    out = ""
    while len(out) < nbytes:
        out += rng.choice(words) + " "
    return out[:nbytes].strip()


def _chatml_ids(path, text):
    """`text` rendered with chatml and encoded by the file's tokenizer,
    as the daemon encodes a request."""
    from libsplinter_tpu_torch.engine.completer import render_prompt
    from libsplinter_tpu_torch.models import GgufFile, load_tokenizer

    with GgufFile(path) as gf:
        tok = load_tokenizer(gf)
    return tok.encode(render_prompt(text, None, "chatml"))


# -- phase 13: the operator CLI -----------------------------------------------

CLI_LANES = ("embedder", "searcher", "completer", "pipeliner", "telemetry")
CLI_NEW_TOKENS = 32
# loadgen: a low fixed rate of mixed traffic for LOADGEN_S seconds
LOADGEN_S, LOADGEN_RATE = 10.0, 3.0
# the host module of tests/test_wasm.py (host_module()): imports
# splinter.set/get and env.print; run() sets "wkey" to "hello wasm",
# reads it back, prints it and returns its length (10)
WASM_HOST_MODULE = (
    "0061736d01000000011a0460047f7f7f7f017f60047f7f7f7f017f60027f7f006000"
    "017f022b030873706c696e7465720373657400000873706c696e7465720367657400"
    "0103656e76057072696e7400020302010305030100010707010372756e00030a2701"
    "2501017f410041044108410a10001a4100410441c00041201001210041c000200010"
    "0220000b0b19020041000b04776b65790041080b0a68656c6c6f207761736d")
# the CLI's local Lua host reads the chain's record back from the store
LUA_READBACK = """
local qkey, ckey = arg[1], arg[2]
local v = splinter.get_embedding(qkey)
local s = 0
for i = 1, #v do s = s + v[i] * v[i] end
print("query", qkey, #v, string.format("%.4f", math.sqrt(s)))
print("answer", ckey, #splinter.get(ckey))
"""


def _spt_argv(path, *args):
    return [sys.executable, "-m", "libsplinter_tpu_torch.cli", "--store",
            path, "--persistent", *args]


def _spt(path, args, env, cwd, *, stdin=None, ok=True):
    """One `python -m libsplinter_tpu_torch.cli` as a subprocess, ended
    at the phase's deadline: (exit code, stdout, stderr, wall s)."""
    t0 = time.perf_counter()
    r = subprocess.run(_spt_argv(path, *args), cwd=cwd, env=env,
                       input=stdin, capture_output=True, text=True,
                       timeout=phase_left())
    wall = time.perf_counter() - t0
    if ok:
        check(r.returncode == 0, f"spt {' '.join(args)[:80]}: exit "
              f"{r.returncode}\n{r.stderr[-3000:]}")
    return r.returncode, r.stdout, r.stderr, wall


def _spt_here(path, args, stdin=None):
    """The same command through cli.main.main in this process (the
    smoke's launch counters see it): (exit code, stdout)."""
    import contextlib
    import io

    from libsplinter_tpu_torch.cli.main import main
    buf, old = io.StringIO(), sys.stdin
    try:
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        with contextlib.redirect_stdout(buf):
            rc = main(["--store", path, "--persistent", *args])
    finally:
        sys.stdin = old
    return rc, buf.getvalue()


class _LocalSplit:
    """Times the parts of the CLI's local search from inside it: the
    lane refresh (the upload on a session's first search), K3, the
    distances and the argsort, each between device syncs, and keeps
    the lane it staged for the plain checks."""

    def __init__(self):
        self.parts: dict[str, float] = {}
        self.lane = self.norms = None

    def __enter__(self):
        import torch

        from libsplinter_tpu_torch.cli import search as cs
        from libsplinter_tpu_torch.ops import similarity as sim
        from libsplinter_tpu_torch.ops import staged_lane as sl

        def timed(name, fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.parts[name] = time.perf_counter() - t0
                return out
            return run

        refresh = sl.StagedLane.refresh

        def staged(lane):
            arr = timed("upload", refresh)(lane)
            self.lane, self.norms = arr, lane.norms
            return arr

        class _Np:
            def __getattr__(_, name):
                return getattr(np, name)

            argsort = staticmethod(timed("argsort", np.argsort))

        self._saved = [(sl.StagedLane, "refresh", refresh),
                       (sim, "cosine_scores", sim.cosine_scores),
                       (sim, "euclidean_distances",
                        sim.euclidean_distances), (cs, "np", cs.np)]
        sl.StagedLane.refresh = staged
        sim.cosine_scores = timed("k3", sim.cosine_scores)
        sim.euclidean_distances = timed("distances",
                                        sim.euclidean_distances)
        cs.np = _Np()
        return self

    def __exit__(self, *exc):
        for obj, name, val in self._saved:
            setattr(obj, name, val)


def _plain_rows(st, lane, q, mask, k, keep):
    """The plain version of a search on the card: K3's plain scores,
    stably sorted, the first k rows whose key `keep` accepts:
    [(key, score, row)]."""
    import torch

    from libsplinter_tpu_torch.ops.similarity import (_cosine_scores_plain,
                                                      _stable_topk)
    s = _cosine_scores_plain(lane, torch.from_numpy(q[None]).cuda(), mask)
    ts, ti = _stable_topk(s.T, min(lane.shape[0], 4 * k + 64))
    out = []
    for score, idx in zip(ts[0].tolist(), ti[0].tolist()):
        if score <= -1e29 or len(out) >= k:
            break
        key = st.key_at(int(idx))
        if keep(key):
            out.append((key, score, int(idx)))
    return out


def _same_rows(what, got, want, tol):
    """CLI rows against (key, score) pairs position by position, except
    where two candidates score within `tol`; each reported similarity
    within `tol` (+ its 6-decimal rounding) of the reference's."""
    check(len(got) == len(want), f"{what}: {len(got)} rows, reference "
          f"{len(want)}")
    score = {k: s for k, s in want}
    swaps = 0
    for g, (wk, ws) in zip(got, want):
        if g["key"] != wk:
            check(g["key"] in score and abs(score[g["key"]] - ws) <= tol,
                  f"{what}: {g['key']} where the reference has {wk}")
            swaps += 1
        check(abs(g["similarity"] - score.get(g["key"], 9.0))
              <= tol + 5e-7, f"{what}: {g['key']} similarity "
              f"{g['similarity']} vs {score.get(g['key'])}")
    return swaps


def _repl_outputs(out):
    """The REPL's stdout split per command: the text after each prompt."""
    return out.split("sptpu> ")[1:]


def phase_cli(card, timings, tmp, lane_path):
    """The operator CLI over phase 4's store: `spt supervise` starts the
    stack, then ingest, daemon and local searches (K3 at Q = 1 in this
    process), the REPL, the operator surfaces, Lua, the pipeline, WASM,
    loadgen and trace export, then SIGTERM.  Returns (the children's
    launches by lane, this process's CLI launches)."""
    import torch

    from libsplinter_tpu_torch import T_VARTEXT, Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.client import submit_embed
    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.engine.searcher import submit_search
    from libsplinter_tpu_torch.models import (EmbeddingModel, GgufFile,
                                              encoder_config_from_gguf,
                                              load_tokenizer)
    from libsplinter_tpu_torch.ops import _cuda

    enc = os.path.join(tmp, "encoder-f16.gguf")
    dec = os.path.join(tmp, "decoder-f16-q8-q4.gguf")
    check(os.path.exists(enc) and os.path.exists(dec),
          "cli: phase 8's GGUF files are missing")
    check(os.path.exists(lane_path), "cli: phase 4's store is missing")
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="spt-smoke-cli-")
    logf = open(os.path.join(work, "supervise.log"), "w+")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    env.pop("SPTPU_FAULT", None)
    st = proc = watch = ref_st = None
    ref_name = f"/spt-smoke-cliref{os.getpid()}"
    ok = False
    try:
        st = Store.open(lane_path, persistent=True)
        nslots, n_used = st.nslots, st.header().used_slots
        with GgufFile(enc) as gf:
            ecfg = encoder_config_from_gguf(gf, out_dim=LANE_DIM)
            etok = load_tokenizer(gf)
            words = [w for w in gf.metadata["tokenizer.ggml.tokens"][5:]
                     if not w.startswith("##")]
        rng = np.random.default_rng(13)

        # 1. the stack, started through the CLI from a directory without
        # the package (phase 4's in-process lanes left heartbeats behind)
        for key in (P.KEY_EMBED_STATS, P.KEY_SEARCH_STATS):
            try:
                st.unset(key)
            except KeyError:
                pass
        argv = _spt_argv(
            lane_path, "supervise", "--lanes", ",".join(CLI_LANES),
            "--lane-args", f"embedder:--weights {enc}",
            "--lane-args", f"completer:--weights {dec} --continuous "
            f"--temp 0 --max-new-tokens {CLI_NEW_TOKENS}",
            "--startup-grace-s", str(SUP_GRACE_S))
        t_sup = time.perf_counter()
        proc = subprocess.Popen(argv, cwd=work, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        watch = _SupervisorWatch(st, P, t_sup)
        hb_keys = {"embedder": P.KEY_EMBED_STATS,
                   "searcher": P.KEY_SEARCH_STATS,
                   "completer": P.KEY_COMPLETE_STATS,
                   "pipeliner": P.KEY_SCRIPT_STATS,
                   "telemetry": P.KEY_TELEMETRY_STATS}
        _wait_for(lambda: all(P.heartbeat_live(st, k, max_age_s=30)
                              for k in hb_keys.values()), 240,
                  "every lane's heartbeat under `spt supervise`")
        up_s = time.perf_counter() - t_sup
        log(f"cli: `spt --store <phase 4's file> --persistent supervise "
            f"--lanes {','.join(CLI_LANES)}` over {nslots} slots "
            f"({n_used} used): every lane's heartbeat {up_s:.2f}s after "
            f"the start [{card}]")

        # 2. one-shot commands that score nothing: the CLI's start-up
        _, out, _, health_s = _spt(lane_path, ["health"], env, work)
        for label in ("embedder", "completer", "searcher", "pipeliner",
                      "supervisor"):
            line = next((ln for ln in out.splitlines()
                         if ln.startswith(label + " ")), "")
            check("s ago" in line and "[DEAD" not in line
                  and "[STALE" not in line, f"health: {label}: {line!r}")
        _, _, _, config_s = _spt(lane_path, ["config"], env, work)
        # the port's splint over the checkout's libsplinter_tpu_torch/
        _, out, _, lint_s = _spt(lane_path, ["lint"], env, work)
        lint_tail = out.strip().splitlines()[-1]
        check(lint_tail.startswith("splint: 0 finding(s)"),
              f"lint: {out[-2000:]}")
        log(f"cli: one-shot torch-free commands: health {health_s:.3f}s "
            f"(every lane's heartbeat listed), config {config_s:.3f}s, "
            f"lint {lint_s:.3f}s (exit 0: {lint_tail}) [{card}]")

        # 3. ingest 64 texts (16 in buckets >= 512) through one REPL
        texts = _sup_texts(rng, words, 16, 48, "cli")
        lines = []
        for i, (key, text) in enumerate(texts.items()):
            f = os.path.join(work, f"doc{i:02d}.txt")
            with open(f, "w") as fh:
                fh.write(text)
            lines.append(f"ingest {key} {f}")
        _, out, _, ingest_s = _spt(lane_path, [], env, work,
                                   stdin="\n".join(lines) + "\n")
        check(out.count("ingested 1 chunks") == len(texts),
              f"ingest: {out[-500:]}")
        t_emb = time.perf_counter()
        busy = P.LBL_EMBED_REQ | P.LBL_WAITING
        _wait_for(lambda: not any(st.labels(k) & busy for k in texts),
                  phase_left(), "the 64 ingested vectors")
        land_s = time.perf_counter() - t_emb
        for key in texts:
            v = st.vec_get(key)
            check(np.isfinite(v).all()
                  and abs(float(np.linalg.norm(v)) - 1.0) < 1e-3,
                  f"ingested {key}: norm {np.linalg.norm(v)}")
        ref_st = Store.create(ref_name, nslots=4096, max_val=8192,
                              vec_dim=LANE_DIM)
        ref_emb = Embedder(ref_st, model=EmbeddingModel(ecfg, weights=enc,
                                                        device="cuda"),
                           tokenizer=etok, max_ctx=ecfg.max_len)
        ref_emb.attach()
        some = list(texts)[::8]                        # 2 long, 6 short
        for key in some:
            ref_st.set(key, texts[key])
            ref_st.set_type(key, T_VARTEXT)
            ref_st.label_or(key, P.LBL_EMBED_REQ)
            ref_st.bump(key)
        check(ref_emb.run_once() == len(some), "in-process reference")
        cos = {k: float(st.vec_get(k) @ ref_st.vec_get(k)) for k in some}
        check(min(cos.values()) >= 0.999, f"ingested vectors against the "
              f"in-process model: {cos}")
        log(f"cli: ingest of 64 texts (16 in buckets >= 512) through one "
            f"REPL in {ingest_s:.2f}s, all 64 vectors landed "
            f"{land_s:.2f}s later; 8 against the in-process model on the "
            f"file: cosine >= {min(cos.values()):.6f} [{card}]")

        # the query: one ingested text; its vector as the embedder child
        # computes it alone (as it computes the CLI's scratch key)
        qkey = list(texts)[40]
        qtext = texts[qkey]
        check(submit_embed(st, "__q/cli", qtext, timeout_ms=120_000)
              is True, "cli: the query's embed")
        q = st.vec_get("__q/cli").copy()
        st.unset("__q/cli")

        # 4. local search in this process: K3 at Q = 1, split in parts
        _cuda.LAUNCHES.reset()                       # the CLI's own path
        with _LocalSplit() as split:
            t_loc = time.perf_counter()
            rc, out = _spt_here(lane_path, ["search", "--local", "--json",
                                            "--timeout", "60000",
                                            "--limit", "10", qtext])
            local_s = time.perf_counter() - t_loc
        check(rc == 0, f"local search: exit {rc}")
        local = json.loads(out)
        k3_one = _cuda.LAUNCHES["cosine_scores"]
        check(k3_one == 1 and _cuda.LAUNCHES["fused_topk"] == 0,
              f"local search launches {dict(_cuda.LAUNCHES)}")
        lane, parts = split.lane, split.parts
        mask = torch.from_numpy(P.candidate_mask(st, 0)).cuda()
        want = _plain_rows(st, lane, q, mask, 10, lambda k: k is not None
                           and not k.startswith(P.SEARCH_SCRATCH_PREFIX))
        swaps = _same_rows("local search", local,
                           [(k, s) for k, s, _ in want], 2e-6)
        check(local[0]["key"] == qkey, f"local search: top hit "
              f"{local[0]['key']}, not {qkey}")
        log(f"cli: `search --local` in this process: {local_s:.3f}s whole "
            f"(embed round trip included): upload "
            f"{parts['upload']:.3f}s, K3 at Q = 1 "
            f"{parts['k3'] * 1e3:.3f} ms, distances "
            f"{parts['distances'] * 1e3:.3f} ms, argsort "
            f"{parts['argsort'] * 1e3:.3f} ms; rows equal the plain "
            f"version ({swaps} near-tie swaps); K3 launched {k3_one} in "
            f"this process [{card}]")

        # 5. the daemon path: k = 10 (K2 in the searcher) as a one-shot
        # subprocess, whose wall holds the child's first lane upload and
        # the interpreter's torch import; then k = 10 again and --limit
        # 200 (fetch 512 > FUSED_K_MAX: K3) in this process, and the
        # import alone
        served0 = _read_json(st, P.KEY_SEARCH_STATS)["served"]
        _, out, _, one_shot_s = _spt(lane_path, [
            "search", "--json", "--timeout", "120000", "--limit", "10",
            qtext], env, work)
        daemon, dwall = {10: json.loads(out)}, {}
        for k in (10, 200):
            t_in = time.perf_counter()
            rc, out = _spt_here(lane_path, [
                "search", "--json", "--timeout", "120000", "--limit", str(k),
                qtext])
            dwall[k] = time.perf_counter() - t_in
            check(rc == 0, f"daemon search k={k}: exit {rc}")
            rows = json.loads(out)
            check(k != 10 or rows == daemon[10], "the in-process k=10 "
                  "rows differ from the one-shot's")
            daemon[k] = rows
            want = _plain_rows(st, lane, q, mask, k,
                               lambda key: key is not None
                               and not key.startswith("__"))
            _same_rows(f"daemon search k={k}", rows,
                       [(key, s) for key, s, _ in want], 2e-6)
        t_imp = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "import libsplinter_tpu_torch.engine.searcher"],
                       cwd=work, env=env, timeout=phase_left(), check=True)
        import_s = time.perf_counter() - t_imp
        t_hb = time.time()
        _wait_for(lambda: (hb := _read_json(st, P.KEY_SEARCH_STATS))
                  is not None and hb["ts"] > t_hb, 30,
                  "the searcher's heartbeat")
        served = _read_json(st, P.KEY_SEARCH_STATS)["served"] - served0
        check(served >= 3, f"the searcher served {served} requests, "
              f"not the 3 searches")
        sys_free = [r for r in local if not r["key"].startswith("__")]
        n = min(len(sys_free), 10)
        _same_rows("local against daemon", sys_free[:n],
                   [(r["key"], r["similarity"]) for r in daemon[10][:n]],
                   2e-6)
        log(f"cli: `search --json` through the searcher: one-shot k=10 "
            f"{one_shot_s:.3f}s (the child's first search: its lane "
            f"upload included; a fresh interpreter importing the "
            f"searcher module, torch with it, takes {import_s:.3f}s); in "
            f"this process k=10 {dwall[10]:.3f}s, --limit 200 "
            f"{dwall[200]:.3f}s; each equal to the plain top-k on the "
            f"card, the local ranking equal to the daemon's [{card}]")

        # 6. the REPL: the card lane staged once, then only dirty rows;
        # --fast and --cpu beside it (one lane per device)
        srch = (f"search --local --json --timeout 60000 --limit 10 "
                f"{shlex.quote(qtext)}")
        script = "\n".join([
            srch, srch.replace("--local", "--local --fast"),
            srch.replace("--local", "--local --cpu"), srch, "metrics"])
        t_repl = time.perf_counter()
        rc, out = _spt_here(lane_path, [], stdin=script + "\n")
        repl_s = time.perf_counter() - t_repl
        check(rc == 0, f"REPL exit {rc}")
        outs = _repl_outputs(out)
        first, fast, cpu, second = (json.loads(o) for o in outs[:4])
        metrics = outs[4]

        def gauge(name):
            m = re.search(rf"^sptpu_staged_lane_{name} (\S+)$", metrics,
                          re.M)
            check(m is not None, f"REPL metrics: no {name}")
            return float(m.group(1))

        uploads, refreshes = gauge("full_uploads"), gauge("refreshes")
        staged_rows = gauge("rows_staged")
        check(uploads == 1 and refreshes == 3
              and 1 <= staged_rows <= 1024,
              f"REPL card lane: {uploads} uploads, {refreshes} refreshes, "
              f"{staged_rows} rows staged")
        for what, got in (("REPL", first), ("REPL again", second)):
            _same_rows(what, got, [(r["key"], r["similarity"])
                                   for r in local], 2e-6)
        _same_rows("--cpu", cpu, [(r["key"], r["similarity"])
                                  for r in first], 1e-5)
        dist = {r["key"]: r["distance"] for r in first}
        derr = max(abs(r["distance"] - dist[r["key"]]) for r in cpu)
        check(derr <= 1e-4, f"--cpu distances off by {derr}")
        sims = [r["similarity"] for r in first]
        gapped = [i for i in range(len(sims))
                  if (i == 0 or sims[i - 1] - sims[i] > 4e-2)
                  and (i == len(sims) - 1 or sims[i] - sims[i + 1] > 4e-2)]
        check(gapped and all(fast[i]["key"] == first[i]["key"]
                             for i in gapped),
              f"--fast: rows {gapped} moved: {fast}")
        exact = {r["key"]: r["similarity"] for r in first}
        ferr = max(abs(r["similarity"] - exact[r["key"]]) for r in fast
                   if r["key"] in exact)
        check(ferr <= 2e-2, f"--fast scores off by {ferr}")
        log(f"cli: one REPL session, 4 local searches in {repl_s:.2f}s: "
            f"the card lane uploaded {uploads:.0f} time, refreshed "
            f"{refreshes:.0f} times staging {staged_rows:.0f} dirty rows; "
            f"--cpu within 1e-5 / 1e-4 (distance err {derr:.2e}); --fast "
            f"keeps the {len(gapped)} gapped rows (score err {ferr:.2e}) "
            f"[{card}]")
        cli_counts = dict(_cuda.LAUNCHES)
        del lane, split
        torch.cuda.empty_cache()

        # 7. operator surfaces
        _, mout, _, _ = _spt(lane_path, ["metrics"], env, work)
        for name in ("sptpu_embedder_kernel_flash_fwd",
                     "sptpu_searcher_kernel_fused_topk",
                     "sptpu_searcher_kernel_cosine_scores",
                     "sptpu_completer_kernel_paged_fwd",
                     "sptpu_pipeliner_", "sptpu_telemetry_samples",
                     "sptpu_supervisor_polls"):
            check(name in mout, f"metrics: no {name}")
        _, hout, _, _ = _spt(lane_path, ["metrics", "--history"], env, work)
        check("[embedder]" in hout and "queue_depth" in hout,
              f"metrics --history: {hout[-400:]}")
        _, tout, _, _ = _spt(lane_path, ["top", "--once"], env, work)
        check("spt top" in tout and "searcher" in tout,
              f"top --once: {tout[-400:]}")
        _spt(lane_path, ["scale", "set", "embedder=1"], env, work)
        _, sout, _, _ = _spt(lane_path, ["scale", "status"], env, work)
        row = next((ln for ln in sout.splitlines()
                    if ln.startswith("embedder ")), "")
        check(re.search(r"\b1\s+manual\b", row) is not None,
              f"scale status: {row!r}")
        _spt(lane_path, ["scale", "set", "embedder=auto"], env, work)
        log(f"cli: metrics (every lane, the model lanes' kernel_* "
            f"counts), metrics --history, top --once and scale (target "
            f"read back: {row.split()[:5]}) rendered [{card}]")

        # 8. scripting: the RAG chain through `pipeline run`, its record
        # read back by the CLI's own Lua host, and WASM
        rag = os.path.join(work, "rag.lua")
        with open(rag, "w") as fh:
            fh.write(RAG_SCRIPT)
        _, out, _, rag_s = _spt(lane_path, [
            "pipeline", "run", rag, "--json", "--timeout-ms", "300000",
            "__rag/q", qtext, "5", "rag/cli"], env, work)
        rec = json.loads(out)
        check(rec.get("ok") is True, f"RAG chain: {rec}")
        hits = rec["ret"][0]
        st.set("__q/rag", "q")
        st.vec_set("__q/rag", st.vec_get("__rag/q"))
        direct = submit_search(st, "__q/rag", 5,
                               timeout_ms=phase_left() * 1000)
        check(direct is not None and direct.get("keys") == hits
              and hits[0] == qkey, f"RAG hits {hits} != a direct "
              f"search's {direct}")
        lua = os.path.join(work, "readback.lua")
        with open(lua, "w") as fh:
            fh.write(LUA_READBACK)
        _, out, _, _ = _spt(lane_path, ["lua", lua, "__rag/q", "rag/cli"],
                            env, work)
        check(f"query\t__rag/q\t{LANE_DIM}\t1.0000" in out
              and "answer\trag/cli" in out, f"lua: {out!r}")
        wasm = os.path.join(work, "host.wasm")
        with open(wasm, "wb") as fh:
            fh.write(bytes.fromhex(WASM_HOST_MODULE))
        _, out, _, _ = _spt(lane_path, ["wasm", wasm, "run"], env, work)
        check("hello wasm" in out and out.strip().endswith("10")
              and st.get("wkey").rstrip(b"\0") == b"hello wasm",
              f"wasm: {out!r}")
        log(f"cli: `pipeline run` of a Lua RAG chain in {rag_s:.2f}s, "
            f"hits equal a direct search's; `lua` read its record back; "
            f"`wasm` ran the host module [{card}]")

        # 9. loadgen: mixed traffic at a low fixed rate, then trace export
        _, out, _, lg_s = _spt(lane_path, [
            "loadgen", "--duration", str(LOADGEN_S), "--rate",
            str(LOADGEN_RATE), "--arrivals", "fixed", "--mix",
            "embed:1,search:1,complete:1", "--seed", "13",
            "--trace-sample", "1.0", "--drain-s", "60", "--json"],
            env, work)
        rep, end = json.JSONDecoder().raw_decode(out)
        check(out[end:].strip() == "done", f"loadgen: {out[end:]!r}")
        check(rep["lost"] == 0 and rep["issued"] >= LOADGEN_S
              * LOADGEN_RATE * 0.8, f"loadgen: {rep}")
        lanes_q = {lane: {k: row.get(k) for k in ("p50_ms", "p99_ms")}
                   for tenant in rep["per_tenant"].values()
                   for lane, row in tenant.items()
                   if isinstance(row, dict) and "p50_ms" in row}
        check({"embed", "search", "complete"} <= set(lanes_q),
              f"loadgen lanes: {sorted(lanes_q)}")
        trace = os.path.join(work, "trace.json")
        _, out, _, _ = _spt(lane_path, ["trace", "export", "--out", trace],
                            env, work)
        with open(trace) as fh:
            doc = json.load(fh)
        check(doc.get("traceEvents"), "trace export: no events")
        log(f"cli: loadgen {LOADGEN_S:g}s at {LOADGEN_RATE:g} req/s "
            f"(embed, search, complete): issued {rep['issued']}, ok "
            f"{rep['ok']}, ok_late {rep['ok_late']}, lost {rep['lost']} in "
            f"{lg_s:.2f}s; p50/p99 ms by lane {json.dumps(lanes_q)}; "
            f"`trace export` wrote {len(doc['traceEvents'])} events "
            f"[{card}]")

        # 10. the children's kernel launches, from their heartbeats
        def fresh(key, after):
            hb = _read_json(st, key)
            return hb if hb is not None and hb["ts"] > after else None

        t_read = time.time() + 0.5
        launches = {}
        for lane_name in ("embedder", "searcher", "completer"):
            key = hb_keys[lane_name]
            _wait_for(lambda: fresh(key, t_read), 30,
                      f"{lane_name}'s heartbeat")
            launches[lane_name] = _heartbeat_launches(fresh(key, t_read))
        # (loadgen's prompts are short: their prefills stay under K4's
        # 512-token floor, so the completer runs K5 alone here)
        want_k = {"embedder": ("flash_fwd",),
                  "searcher": ("fused_topk", "cosine_scores"),
                  "completer": ("paged_fwd",)}
        for lane_name, names in want_k.items():
            for name in names:
                check(launches[lane_name][name] > 0, f"cli stack: "
                      f"{lane_name} never launched {name}: "
                      f"{launches[lane_name]}")

        # 11. SIGTERM: exit 0, no child left
        watch.close()
        pids = set(watch.pids)
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"`spt supervise` exit code {rc} after SIGTERM")
        _wait_for(lambda: not any(P.pid_alive(p) for p in pids), 30,
                  "every child to exit")
        wall = time.perf_counter() - t0
        log(f"cli: `spt supervise` exited 0 on SIGTERM, its {len(pids)} "
            f"children gone; kernel launches by lane "
            f"{json.dumps(launches)}, in this process {cli_counts}")
        log(f"cli phase: {wall:.1f}s [{card}]")
        timings["cli"] = {
            "wall_s": wall, "stack_up_s": up_s, "health_s": health_s,
            "config_s": config_s, "lint_s": lint_s, "ingest_s": ingest_s,
            "land_s": land_s,
            "local_s": local_s, "local_parts_s": parts,
            "daemon_search_one_shot_s": one_shot_s,
            "daemon_search_s": dwall, "searcher_import_s": import_s,
            "repl_s": repl_s,
            "repl_rows_staged": staged_rows, "rag_s": rag_s,
            "loadgen": {"issued": rep["issued"], "ok": rep["ok"],
                        "lost": rep["lost"], "lanes_ms": lanes_q}}
        ok = True
        return launches, cli_counts
    finally:
        if watch is not None:
            watch.close()
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        if not ok:
            logf.seek(0)
            print(f"supervise log (tail):\n{logf.read()[-6000:]}",
                  file=sys.stderr)
        logf.close()
        if st is not None:
            st.close()
        if ref_st is not None:
            ref_st.close()
            Store.unlink(ref_name)
        shutil.rmtree(work, ignore_errors=True)


# -- phase 14: sharded serving ------------------------------------------------

# the per-shard shapes of the main K4 and K5 cases at tp = 2: each shard
# holds 6 of the 12 heads and 6 of the 12 kv heads
SHARD_CAUSAL_CASES = ((8, 1024, 2048, 6, 6, 0, CAUSAL_CASES[0][6]),)
SHARD_PAGED_CASES = tuple((1, 6, kind, _paged_lengths(32))
                          for kind in ("bf16", "int8", "int4"))
SHARD_KERNELS = ("fused_topk", "cosine_scores", "causal_fwd", "paged_fwd")


def _shard_mesh(**axes):
    """A mesh of `axes` over real cards where the host has enough, else
    a virtual one whose shards all share cuda:0: (mesh, description)."""
    import torch

    from libsplinter_tpu_torch.parallel import make_mesh

    n = int(np.prod(list(axes.values())))
    if torch.cuda.device_count() >= n:
        devs = [f"cuda:{i}" for i in range(n)]
        how = f"real cards {devs}"
    else:
        devs = ["cuda:0"] * n
        how = f"virtual: all {n} shards on cuda:0"
    return make_mesh(devices=devs, **axes), how


def _by_shard():
    """This path's launches per (kernel, shard), as "kernel/shard"."""
    from libsplinter_tpu_torch.ops import _cuda

    return {f"{k}/{s}": n for (k, s), n in sorted(
        _cuda.LAUNCHES.by_shard.items())}


def _agreement(a: dict, b: dict):
    """Token agreement of two lanes' id lists and each key's first
    divergence (position, a's id, b's id)."""
    same = sum(int(x == y) for k in a for x, y in zip(a[k], b[k]))
    total = sum(len(v) for v in a.values())
    first = {}
    for k in a:
        for i, (x, y) in enumerate(zip(a[k], b[k])):
            if x != y:
                first[k] = (i, x, y)
                break
    return same / total, first


def _sharded_lanes(card, mesh, prompts, out, tmp):
    """tp = 1 against tp = 2 on the continuous lane, f32 then bf16, and
    the tp = 2 target's self-draft; returns launches by path."""
    import torch

    from libsplinter_tpu_torch.models import CompletionModel, DecoderConfig
    from libsplinter_tpu_torch.parallel import ShardedCompletionModel

    launches = {}
    tok = _piece_tokenizer()
    longest = max(len(tok.encode(t)) for t in prompts.values())
    check(longest > 512, f"no prompt reaches K4's buckets ({longest} tokens)")
    for kind, cfg in (("f32", DecoderConfig(layers=CUT_LAYERS,
                                            dtype=torch.float32)),
                      ("bf16", DecoderConfig(layers=CUT_LAYERS))):
        one = CompletionModel(cfg, seed=0, temp=0.0, device="cuda")
        two = ShardedCompletionModel(cfg, mesh,
                                     params=one.module.state_dict(),
                                     temp=0.0)
        ids1, w1, _, _, _, held1 = _ids_lane(one, prompts, f"tp=1 {kind}")
        ids2, w2, c2, _, _, held2 = _ids_lane(two, prompts, f"tp=2 {kind}")
        shards = _by_shard()
        # the prefix cache keeps the prompts' pages after the drain; one
        # page scheduler keeps the same number at either tp
        check(held1 == held2, f"{kind}: pages held after the drain: tp=1 "
              f"{held1}, tp=2 {held2}")
        for s in range(2):
            check(shards.get(f"causal_fwd/{s}", 0) > 0
                  and shards.get(f"paged_fwd/{s}", 0) > 0,
                  f"tp=2 {kind}: shard {s} did not launch K4 and K5: "
                  f"{shards}")
        agree, first = _agreement(ids1, ids2)
        if kind == "f32":
            check(ids1 == ids2, f"tp=2 f32 tokens differ from tp=1: "
                  f"agreement {agree:.4f}, first divergences {first}")
        tokens = len(prompts) * SPEC_NEW_TOKENS
        log(f"sharded, {kind}: {len(prompts)} requests x {SPEC_NEW_TOKENS} "
            f"tokens (longest prompt {longest} tokens) through Completer; "
            f"tp=2 greedy tokens against tp=1: agreement {agree:.4f}, first "
            f"divergences {first or 'none'}; tp=1 {tokens / w1:.1f} "
            f"tokens/s, tp=2 {tokens / w2:.1f} tokens/s (cold, prefill "
            f"included; both shards time-share the card when the mesh is "
            f"virtual); tp=2 K4 {c2['causal_fwd']}, K5 {c2['paged_fwd']}, "
            f"by shard {shards}; pages kept by the prefix cache after the "
            f"drain {held2[0]} at both tp [{card}]")
        out[kind] = {"agreement": agree, "first_divergences": first,
                     "tp1_tokens_per_s": tokens / w1,
                     "tp2_tokens_per_s": tokens / w2, "by_shard": shards}
        launches[kind] = c2
        if kind == "f32":
            # the self-draft of the tp = 2 target (3 layers, gamma 4)
            # against its plain lane
            eight = dict(list(prompts.items())[:8])
            rec, launches["spec"] = _spec_compare(
                card, two, eight, "tp=2 f32", lambda a, b: a - b < 1e-4,
                "top-2 within 1e-4")
            out["spec"] = rec
        else:
            check(two.page_wire_bytes(two.init_paged(2))
                  == one.page_wire_bytes(one.init_paged(2)),
                  "a tp=2 wire page is not the tp=1 page's size")
            eight = dict(list(prompts.items())[:8])
            launches["disagg"] = _variants_disagg(
                card, out, two, eight, tmp, what="sharded, disagg at tp=2",
                record="disagg")
            d = out["disagg"]
            check(d["identical"] == d["requests"], f"tp=2 split lanes: "
                  f"{d['identical']} of {d['requests']} completions equal "
                  f"the unified lane's")
        del one, two
        torch.cuda.empty_cache()
    return launches


def _sharded_moe(card, prompts, out):
    """Phase 11's MoE geometry (DecoderConfig() width, 4 layers, 8
    experts, top-2) in f32 at ep = 2 x tp = 2 against ep = 1, seeded
    weights."""
    import torch

    from libsplinter_tpu_torch.models import (MoeDecoderConfig,
                                              moe_completion_model)

    mesh, how = _shard_mesh(tp=2, ep=2)
    cfg = MoeDecoderConfig(n_experts=8, top_k=2, layers=CUT_LAYERS,
                           dtype=torch.float32)
    one = moe_completion_model(cfg, seed=0, temp=0.0, device="cuda")
    four = moe_completion_model(cfg, mesh, params=one.module.state_dict(),
                                temp=0.0)
    experts = [m.layer_0.moe.gate_experts.shape[0]
               for m in four.module.shards]
    check(experts == [4, 4, 4, 4], f"MoE shards hold {experts} experts")
    ids1, w1, _, _, _, held1 = _ids_lane(one, prompts, "moe ep=1 f32")
    ids4, w4, c4, _, _, held = _ids_lane(four, prompts,
                                         "moe ep=2 x tp=2 f32")
    shards = _by_shard()
    agree, first = _agreement(ids1, ids4)
    check(ids1 == ids4 and held == held1, f"MoE ep=2 x tp=2 f32 tokens "
          f"against ep=1: agreement {agree:.4f}, first divergences {first}; "
          f"pages held {held1}, {held}")
    tokens = len(prompts) * SPEC_NEW_TOKENS
    log(f"sharded, moe: MoeDecoderConfig(8 experts, top-2) f32, mesh "
        f"{mesh.shape} ({how}), 4 experts a shard; {len(prompts)} requests "
        f"x {SPEC_NEW_TOKENS} tokens identical to ep=1; ep=1 "
        f"{tokens / w1:.1f} tokens/s, ep=2 x tp=2 {tokens / w4:.1f} "
        f"tokens/s; K4 {c4['causal_fwd']}, K5 {c4['paged_fwd']}, by shard "
        f"{shards} [{card}]")
    out["moe"] = {"tokens_equal": True, "ep1_tokens_per_s": tokens / w1,
                  "ep2tp2_tokens_per_s": tokens / w4, "by_shard": shards}
    del one, four
    torch.cuda.empty_cache()
    return c4


def _sharded_search(card, lane_path, out):
    """sharded_topk over phase 4's lane at dp = 2 against the one-shard
    kernels (K2 at Q = 8 k = 16, ties and filler included; K3 at
    k = 200), then `spt search --sharded` on the store through the CLI
    with an in-process embedder answering; returns launches by path."""
    import torch

    from libsplinter_tpu_torch import Store
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.engine.client import submit_embed
    from libsplinter_tpu_torch.engine.embedder import Embedder
    from libsplinter_tpu_torch.models import EmbeddingModel, EncoderConfig
    from libsplinter_tpu_torch.ops import _cuda
    from libsplinter_tpu_torch.ops.similarity import (_stable_topk,
                                                      cosine_scores,
                                                      fused_topk_cuda)
    from libsplinter_tpu_torch.parallel import PodSearch
    from libsplinter_tpu_torch.parallel.sharded_search import \
        local_candidates

    launches = {}
    st = Store.open(lane_path, persistent=True)
    stop = threading.Event()
    th = None
    try:
        emb = Embedder(st, model=EmbeddingModel(
            EncoderConfig(out_dim=LANE_DIM, max_len=2048), seed=0,
            device="cuda"), max_ctx=2048)
        emb.attach()

        def answer():
            while not stop.is_set():
                emb.run_once()
                stop.wait(0.01)

        th = threading.Thread(target=answer, daemon=True)
        th.start()
        texts, twins = _texts(np.random.default_rng(0))
        qtext = texts["text/40"]
        check(submit_embed(st, "__q/shard", qtext, timeout_ms=120_000)
              is True, "sharded search: the query's embed")
        q = st.vec_get("__q/shard").copy()
        st.unset("__q/shard")

        mesh, how = _shard_mesh(dp=2)
        t0 = time.perf_counter()
        pod = PodSearch(st, mesh)
        blocks = pod.refresh()
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        whole = torch.cat([b.to("cuda:0") for b in blocks])
        n = whole.shape[0]
        mask = torch.from_numpy(P.candidate_mask(st, 0)).cuda()
        # Q = 8: the query and seven texts' own vectors
        rows = [st.find_index(k) for k in list(texts)[:7]]
        queries = torch.cat([torch.from_numpy(q[None]).cuda(),
                             whole[rows]]).contiguous()
        # a sparse mask over a few rows, twin pairs among them: ties, and
        # filler past the 10 candidates
        few = [st.find_index(k) for k in (*twins, *twins.values())] \
            + rows[2:4]
        sparse = torch.zeros_like(mask)
        sparse[few] = 1.0
        rec = {}
        for k, m, tag in ((16, mask, "k=16"), (16, sparse, "k=16 sparse"),
                          (200, mask, "k=200")):
            _cuda.LAUNCHES.reset()
            s2, i2 = local_candidates(blocks, queries, k, m)
            torch.cuda.synchronize()
            launches[tag] = {kk: _cuda.LAUNCHES[kk] for kk in SHARD_KERNELS}
            shards = _by_shard()
            if k <= 128:
                s1, i1 = fused_topk_cuda(whole, queries, k, m)
            else:
                s1, i1 = _stable_topk(cosine_scores(whole, queries, m).T, k)
            check(torch.equal(i2, i1.long()), f"sharded top-k {tag}: rows "
                  f"differ from the one-shard kernel's")
            err = (s2 - s1).abs()[s1 > -1e29].max().item()
            check(err <= 1e-6 and bool(((s1 > -1e29) == (s2 > -1e29)).all()),
                  f"sharded top-k {tag}: scores differ by {err}")
            filler = int((i2 == -1).sum())
            if tag == "k=16 sparse":
                check(filler == 8 * (k - len(few)), f"sparse: {filler} "
                      f"filler rows")
                ties = int(((s2[:, 1:] == s2[:, :-1])
                            & (s2[:, 1:] > -1e29)).sum())
                check(ties > 0, "sparse: no tied scores among the twins")
            ms = cuda_ms(lambda: local_candidates(blocks, queries, k, m),
                         reps=5)
            ms1 = cuda_ms((lambda: fused_topk_cuda(whole, queries, k, m))
                          if k <= 128 else (lambda: _stable_topk(
                              cosine_scores(whole, queries, m).T, k)),
                          reps=5)
            rec[tag] = {"ms_dp2": ms, "ms_one": ms1, "max_abs_err": err,
                        "filler": filler, "by_shard": shards}
            log(f"sharded search {tag}, N={n} D={LANE_DIM} Q=8 over mesh "
                f"{mesh.shape} ({how}): rows identical to the one-shard "
                f"{'K2' if k <= 128 else 'K3 + sort'} (score err {err:.3g}, "
                f"{filler} filler rows); dp=2 {ms:.3f} ms, one shard "
                f"{ms1:.3f} ms (events; the shards time-share the card when "
                f"the mesh is virtual); launches by shard {shards} [{card}]")
        # the operator CLI's pod path on the store (in this process)
        keep = (lambda key: key is not None
                and not key.startswith(P.SEARCH_SCRATCH_PREFIX))
        cli = {}
        for limit in (10, 200):
            _cuda.LAUNCHES.reset()
            t1 = time.perf_counter()
            rc, text = _spt_here(lane_path, [
                "search", "--sharded", "--json", "--timeout", "120000",
                "--limit", str(limit), qtext])
            wall = time.perf_counter() - t1
            torch.cuda.synchronize()
            check(rc == 0, f"spt search --sharded --limit {limit}: exit {rc}")
            launches[f"cli {limit}"] = {kk: _cuda.LAUNCHES[kk]
                                        for kk in SHARD_KERNELS}
            got = json.loads(text)
            want = _plain_rows(st, whole, q, mask, limit, keep)
            swaps = _same_rows(f"spt search --sharded --limit {limit}", got,
                               [(kk, sc) for kk, sc, _ in want], 2e-6)
            check(all(r["slot"] == w[2] for r, w in zip(got, want)
                      if r["key"] == w[0]), "sharded rows: wrong slots")
            cli[limit] = {"wall_s": wall, "swaps": swaps}
            log(f"sharded search, `spt search --sharded --limit {limit}`: "
                f"{len(got)} rows equal the plain version ({swaps} near-tie "
                f"swaps) in {wall:.2f}s (the lane staged on the host's one "
                f"mesh shard per card, embed round trip included); "
                f"launches {launches[f'cli {limit}']} [{card}]")
        out["search"] = dict(rec, cli=cli, stage_s=stage_s)
    finally:
        stop.set()
        if th is not None:
            th.join(timeout=30)
        st.close()
    return launches


def _sharded_refusal(card, out):
    """completer.main --tp 2 on a host with one card exits nonzero
    naming the count (with two or more cards the mesh is real)."""
    import torch

    from libsplinter_tpu_torch.engine import completer as tcomp

    if torch.cuda.device_count() >= 2:
        log(f"sharded: {torch.cuda.device_count()} cards, --tp 2 has its "
            f"mesh; no refusal to show [{card}]")
        return
    try:
        tcomp.main(["--store", f"/spt-smoke-never-{os.getpid()}", "--tp",
                    "2", "--oneshot"])
    except SystemExit as ex:
        msg = str(ex.code)
        check(ex.code not in (0, None) and "this host has 1" in msg,
              f"completer --tp 2 on one card: {msg}")
        log(f"sharded: `completer.main --tp 2` on one card exits nonzero: "
            f"{msg} [{card}]")
        out["refusal"] = msg
        return
    check(False, "completer --tp 2 on one card did not refuse")


def phase_sharded(card, timings, tmp, results, lane_path):
    """Sharded serving on the card: the per-shard K4 and K5 shapes
    against their plain versions, the continuous lane at tp = 2 (f32
    tokens identical to tp = 1, bf16 agreement), the tp = 2 self-draft,
    the tp = 2 split lanes, MoE at ep = 2 x tp = 2, sharded search and
    `spt search --sharded`, and the --tp refusal on one card.  Returns
    (launches by path, the sums by kernel)."""
    import torch

    t0 = time.perf_counter()
    mesh, how = _shard_mesh(tp=2)
    log(f"sharded: mesh {mesh.shape} ({how}) [{card}]")
    phase_causal(results, SHARD_CAUSAL_CASES)
    phase_paged(results, SHARD_PAGED_CASES, h=6)
    out: dict = {"mesh": how}
    prompts = _variant_prompts(np.random.default_rng(11), 8)
    launches = _sharded_lanes(card, mesh, prompts, out, tmp)
    launches["moe"] = _sharded_moe(card, prompts, out)
    launches.update(_sharded_search(card, lane_path, out))
    _sharded_refusal(card, out)
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    sums = dict.fromkeys(SHARD_KERNELS, 0)
    for path in launches.values():
        for k, v in path.items():
            sums[k] += v
    check(all(sums[k] > 0 for k in SHARD_KERNELS),
          f"sharded: a kernel never ran: {sums}")
    out["wall_s"] = wall
    timings["sharded"] = out
    log(f"sharded phase: {wall:.1f}s; launches by path "
        f"{json.dumps(launches)} [{card}]")
    return launches, sums

# -- phase 15: multi-GPU training ---------------------------------------------

# (A) dp = 2 x tp = 2: the f32 parity step over 8 pairs, then phase 7's
# 16 pairs in bf16 with AdamW for PAR_STEPS timed steps after a warm-up;
# (B) dp = 1 x sp = 4 over 4 pairs at S = 2048 (chunks of 512) in f32;
# (C) pp = 4 with 4 microbatches over phase 7's 16 x 512
PAR_STEPS, PAR_LR = 5, 0.1
# one tp = 2 shard's attention in the bf16 run: a dp row of 8 pairs at
# S = 512, 6 of the 12 heads
SHARD_FLASH = (8, 512, 6)


def _flash_shard_rows(results, card):
    """K1 and K6 at one tp = 2 shard's training shape (bf16, B=8 S=512
    H=6 D=64, a fully-masked row) against their plain versions, each
    timed by graph replay beside SDPA's forward and backward (graph
    replay too: at this size events would time the host)."""
    import torch
    import torch.nn.functional as F

    from libsplinter_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain,
        flash_bwd_cuda, flash_bwd_plain_and_terms, flash_fwd_cuda)

    b, s, h = SHARD_FLASH
    q, k, v, mask = _attn_case(b, s, torch.bfloat16, seed=151, h=h)
    maskf = mask.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    got = flash_attention(q, k, v, mask)
    ref32 = flash_attention_plain(qf, kf, vf, mask)
    lim = (BF16_ULP * ref32.abs() + BF16_P_ROUND
           * flash_attention_plain(qf, kf, vf.abs(), mask) + F32_ATOL)
    diff = (got.float() - ref32.to(torch.bfloat16).float()).abs()
    err, worst = diff.max().item(), (diff / lim).max().item()
    check(worst <= 1.0, f"K1 per shard: max err {err}, {worst:.3f} of "
          f"its limit")
    g = torch.Generator(device="cuda").manual_seed(152)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, stats = flash_fwd_cuda(q, k, v, maskf, stats=True)
    grads = flash_bwd_cuda(q, k, v, o, do, maskf, stats)
    ref, terms = flash_bwd_plain_and_terms(qf, kf, vf, o.float(),
                                           do.float(), mask)
    berr, bworst = 0.0, 0.0
    for name, gt, rt, term in zip(("dq", "dk", "dv"), grads, ref, terms):
        f32_tol = F32_ATOL * max(1.0, rt.abs().max().item())
        bl = BF16_ULP * rt.abs() + BF16_P_ROUND * term + f32_tol
        bd = (gt.float() - rt.to(torch.bfloat16).float()).abs()
        berr = max(berr, bd.max().item())
        bworst = max(bworst, (bd / bl).max().item())
    check(bworst <= 1.0, f"K6 per shard: max err {berr}, {bworst:.3f} of "
          f"its limit")
    del qf, kf, vf, ref32, diff, lim, ref, terms

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot, bias = do.transpose(1, 2).contiguous(), mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    with torch.no_grad():
        ms = graph_ms(lambda: flash_attention(q, k, v, mask))
        fwd_lib = graph_ms(sdpa)
    bms_k6 = graph_ms(lambda: flash_bwd_cuda(q, k, v, o, do, maskf, stats))
    lib_k6 = graph_ms(sdpa_fwd_bwd) - fwd_lib
    plain = cuda_ms(lambda: flash_attention_plain(q, k, v, mask), reps=3)
    plain_k6 = cuda_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, do, mask), reps=2)
    elt = q.element_size()
    nb = 4 * b * s * h * 64 * elt + b * s * 4
    k1_bound = bound(nb, 4.0 * b * h * s * s * 64, "bf16")
    k6_bound = _bwd_bound(q.shape, elt, "bf16")
    shape = f"B={b} S={s} H={h} D=64 bf16"
    rows = {"flash_fwd": {"shape": shape, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain, "library_ms": fwd_lib,
                          "bound_ms": k1_bound[0],
                          "bound_by": k1_bound[1]},
            "flash_bwd": {"shape": shape, "max_abs_err": berr,
                          "ms": bms_k6, "plain_ms": plain_k6,
                          "library_ms": lib_k6, "bound_ms": k6_bound[0],
                          "bound_by": k6_bound[1]}}
    for name, rec in rows.items():
        log(f"{'K1' if name == 'flash_fwd' else 'K6'} {name} per shard "
            f"{shape}, graph replay: kernel {rec['ms']:.4f} ms, sdpa "
            f"{rec['library_ms']:.4f}, plain {rec['plain_ms']:.3f}, bound "
            f"{rec['bound_ms']:.4f} ({rec['bound_by']}; "
            f"{rec['bound_ms'] / rec['ms']:.1%}), err {rec['max_abs_err']:.3g}"
            f" (worst {worst if name == 'flash_fwd' else bworst:.3f} of the "
            f"limit) [{card}]")
        results.setdefault(name, []).append(rec)
    del q, k, v, o, do, grads, qt, kt, vt, dot
    torch.cuda.empty_cache()
    return rows


def _grad_err(grads, want):
    """Worst over tensors of max |g - want| / max |want|, and where."""
    worst, where = 0.0, ""
    for name, w in want.items():
        e = ((grads[name] - w).abs().max() / w.abs().max()).item()
        if e > worst:
            worst, where = e, name
    return worst, where


def _param_err(got, want, grads, lr):
    """Worst over tensors of max |p - want| over its limit: one SGD step
    moves p by -lr g, so a gradient within 1e-4 of max |g| moves it by
    at most lr 1e-4 max |g|, plus two f32 roundings of p (2^-23 |p|
    each)."""
    worst, where = 0.0, ""
    for name, w in want.items():
        lim = (lr * 1e-4 * grads[name].abs().max()
               + 2.0 ** -22 * w.abs().max()).item()
        e = (got[name] - w).abs().max().item() / lim
        if e > worst:
            worst, where = e, name
    return worst, where


def _to_host(tensors: dict) -> dict:
    """Copies on the host: the references of a parity check stay out of
    the other trainer's peak device memory."""
    import torch

    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in tensors.items()}


def _init_and_step(sharded_init):
    """make_sharded_train_step's sharded_init(generator, ids, mask) ->
    (state, step) as the (init_fn, step_fn) pair the other trainers
    return."""
    step_of = {}

    def init_fn(generator, ids, mask):
        state, step_of["step"] = sharded_init(generator, ids, mask)
        return state

    return init_fn, lambda state, batch: step_of["step"](state, batch)


def _one_step_parity(card, what, single, sharded, batch, counts_want,
                     held):
    """One SGD step of `single` (make_train_step's (init, step)) and of
    `sharded` ((init, step) of a mesh trainer) from the same generator:
    the init identical, the losses within 1e-5 relative, the gathered
    gradients within 1e-4 of each tensor's max |g| (phase 7's bound;
    TF32 off), every parameter after the step within _param_err's
    limit (compared on the host).  Each trainer's second step on the
    same batch gives its warm wall and peak allocated memory (its own
    state alone on the card; `held`, what earlier phases still hold,
    subtracted).  Returns (sharded launches of the
    counted step, readings)."""
    import torch

    from libsplinter_tpu_torch.ops import _cuda

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    out, launches = {}, {}
    sample = (batch["ids_a"][:1], batch["mask_a"][:1])
    for side, (init, step) in (("single", single), ("sharded", sharded)):
        state = init(gen(), *sample)
        if side == "single":
            start = _to_host(state.module.state_dict())
        else:
            full = _to_host(state.module.full_state_dict())
            check(all(torch.equal(full[k], v) for k, v in start.items()),
                  f"{what}: the sharded init differs from the single-card "
                  "init of the same generator")
            del full
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()                   # this path, from 0
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        launches[side] = {k: _cuda.LAUNCHES[k] for k in ("flash_fwd",
                                                         "flash_bwd")}
        if side == "single":
            grads = _to_host({n: p.grad for n, p in
                              state.module.named_parameters()})
            params = _to_host(state.module.state_dict())
        else:
            m = state.module
            sg = _to_host({n: m.gather(n, [m.shards[m.slot(0, t, 0)]
                                           .get_parameter(n).grad
                                           for t in range(m.tp)])
                           for n, _ in m.shards[0].named_parameters()})
            sp = _to_host(m.full_state_dict())
            del m
        out[f"{side}_loss"] = float(loss)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _ = step(state, batch)            # warm wall, peak
        torch.cuda.synchronize()
        out[f"{side}_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{side}_peak_gb"] = (torch.cuda.max_memory_allocated()
                                  - held) / 1e9
        if side == "sharded":
            mismatch = state.module.replica_mismatches()
        del state
        torch.cuda.empty_cache()
    rel = abs(out["sharded_loss"] - out["single_loss"]) / abs(
        out["single_loss"])
    gerr, gwhere = _grad_err(sg, grads)
    perr, pwhere = _param_err(sp, params, grads, PAR_LR)
    check(rel <= 1e-5, f"{what}: loss {out['sharded_loss']} vs single "
          f"{out['single_loss']} (relative {rel:.3g} > 1e-5)")
    check(gerr <= 1e-4, f"{what}: gradient {gwhere} off by {gerr:.3g} of "
          f"its max |g| (> 1e-4)")
    check(perr <= 1.0, f"{what}: parameter {pwhere} at {perr:.3f} of its "
          f"limit after the step")
    check(mismatch == [], f"{what}: replicas differ in {mismatch}")
    check(launches == counts_want, f"{what}: launches {launches}, want "
          f"{counts_want}")
    out.update(loss_rel=rel, grad_err=gerr, grad_worst=gwhere,
               param_err=perr, param_worst=pwhere, launches=launches)
    log(f"{what}: one SGD step (lr {PAR_LR}) loss {out['sharded_loss']:.9g}"
        f" vs single-card {out['single_loss']:.9g} (relative {rel:.3g}, "
        f"limit 1e-5); gradients within {gerr:.3g} of each tensor's max "
        f"|g| (worst {gwhere}; limit 1e-4); parameters at {perr:.3f} of "
        f"lr 1e-4 max|g| + 2^-22 max|p| (worst {pwhere}); replicas "
        f"identical; launches {launches}; warm step {out['sharded_step_ms']:.1f}"
        f" ms vs {out['single_step_ms']:.1f}, peak {out['sharded_peak_gb']:.2f}"
        f" GB vs {out['single_peak_gb']:.2f} allocated above the earlier "
        f"phases' [{card}]")
    return launches["sharded"], out


def _train_sharded_bf16(card, cfg, mesh, batch, out, held):
    """make_sharded_train_step in bf16 with AdamW over phase 7's batch:
    a warm-up step, PAR_STEPS timed steps (the loss falls, the replicas
    stay bit-identical, K1 and K6 2 x layers x 4 shards a step), one
    profiled step split by kernel class, beside the single-card
    trainer's losses on the same init and batch."""
    import torch

    from libsplinter_tpu_torch.ops import _cuda
    from libsplinter_tpu_torch.parallel import (make_sharded_train_step,
                                                make_train_step)

    per_step = 2 * cfg.layers * mesh.size
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, step = make_sharded_train_step(cfg, mesh)(
        gen, batch["ids_a"], batch["mask_a"])
    state, loss = step(state, batch)                     # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.reset()                               # the main path
    t0 = time.perf_counter()
    for _ in range(PAR_STEPS):
        state, loss = step(state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: _cuda.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd")}
    shards = _by_shard()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = [float(x) for x in losses]
    mismatch = state.module.replica_mismatches()

    def one_step():
        nonlocal state
        state, _ = step(state, batch)
        return 1

    profile = _profile_drain(one_step, 1, wall / PAR_STEPS, card)
    del state
    torch.cuda.empty_cache()
    check(counts == {"flash_fwd": per_step * PAR_STEPS,
                     "flash_bwd": per_step * PAR_STEPS},
          f"sharded bf16: K1/K6 launches {counts} over {PAR_STEPS} steps")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"sharded bf16: losses {losses}")
    check(mismatch == [], f"sharded bf16: replicas differ in {mismatch}")
    init1, step1 = make_train_step(cfg)
    s1 = init1(torch.Generator(device="cuda").manual_seed(0),
               batch["ids_a"], batch["mask_a"])
    single = []
    for _ in range(PAR_STEPS + 1):
        s1, l1 = step1(s1, batch)
        single.append(float(l1))
    del s1
    torch.cuda.empty_cache()
    out["bf16"] = {"steps_per_s": PAR_STEPS / wall,
                   "step_ms": wall / PAR_STEPS * 1e3, "peak_gb": peak,
                   "losses": losses, "single_losses": single,
                   "launches": counts, "by_shard": shards,
                   "profile": profile}
    log(f"sharded bf16 AdamW dp=2 x tp=2, {TRAIN_B} pairs x S={TRAIN_S}: "
        f"{PAR_STEPS} steps in {wall:.3f}s = {PAR_STEPS / wall:.3f} steps/s "
        f"({wall / PAR_STEPS * 1e3:.1f} ms a step), peak {peak:.2f} GB "
        f"allocated; losses {[round(x, 6) for x in losses]} (single-card "
        f"on the same init {[round(x, 6) for x in single]}; bf16 partial "
        f"sums round apart: no claim); replicas bit-identical; K1/K6 "
        f"{counts} ({per_step} a step), K1 by shard {shards} [{card}]")
    return counts


def _pipeline_check(card, cfg, mesh, batch, out):
    """pipeline_encode at pp = 4 with 4 microbatches on the full-width
    encoder: bf16 embeddings against Encoder.forward on the same weights
    (cosine >= 0.999 per row; the worst error printed: bf16 GEMMs over
    a smaller M may take other algorithms), K1 12 x 4 times; a bf16
    backward (K6 12 x 4 times) with every gradient at cosine >= 0.99 to
    the dense model's; in f32 the embeddings within 1e-5 and the
    gradients within 1e-4 of each tensor's max |g|."""
    import torch

    from libsplinter_tpu_torch.models.encoder import Encoder, init_params
    from libsplinter_tpu_torch.ops import _cuda
    from libsplinter_tpu_torch.parallel import pipeline_encode

    m = 4
    want = cfg.layers * m
    ids = torch.from_numpy(batch["ids_a"]).cuda()
    mask = torch.from_numpy(batch["mask_a"]).cuda()
    counts = dict.fromkeys(("flash_fwd", "flash_bwd"), 0)
    for dtype in (torch.bfloat16, torch.float32):
        c = dataclasses.replace(cfg, dtype=dtype)
        with torch.device("cuda"):
            dense = Encoder(c)
        init_params(dense, torch.Generator(device="cuda").manual_seed(0))
        w = torch.randn((ids.shape[0], c.out_dim), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
        zd = dense(ids, mask)
        (zd * w).sum().backward()
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in dense.named_parameters()}
        torch.cuda.synchronize()
        _cuda.LAUNCHES.reset()                           # the main path
        t0 = time.perf_counter()
        zp = pipeline_encode(c, mesh, leaves, ids, mask, microbatches=m)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        k1 = _cuda.LAUNCHES["flash_fwd"]
        (zp * w).sum().backward()
        torch.cuda.synchronize()
        k6 = _cuda.LAUNCHES["flash_bwd"]
        check(k1 == want and k6 == want, f"pipeline {c.dtype}: K1 {k1} / "
              f"K6 {k6} launches, want {want} each")
        counts["flash_fwd"] += k1
        counts["flash_bwd"] += k6
        err = (zp - zd).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(zp, zd, dim=-1).min() \
            .item()
        grads = {n: p.grad for n, p in dense.named_parameters()}
        got = {n: leaves[n].grad for n in grads}
        if dtype == torch.bfloat16:
            gcos = min(torch.nn.functional.cosine_similarity(
                got[n].flatten(), grads[n].flatten(), dim=0).item()
                for n in grads)
            check(cos >= 0.999 and gcos >= 0.99,
                  f"pipeline bf16: embedding cosine {cos}, worst gradient "
                  f"cosine {gcos}")
            rec = {"max_abs_err": err, "min_cosine": cos,
                   "grad_min_cosine": gcos}
            limits = "cosine limits 0.999 / 0.99"
        else:
            gerr, gwhere = _grad_err(got, grads)
            check(err <= F32_ATOL and gerr <= 1e-4,
                  f"pipeline f32: embeddings off by {err}, gradient "
                  f"{gwhere} by {gerr:.3g} of its max |g|")
            rec = {"max_abs_err": err, "grad_err": gerr,
                   "grad_worst": gwhere}
            limits = "limits 1e-5 / 1e-4 of max |g|"
        rec.update(fwd_s=fwd_s, k1=k1, k6=k6)
        out[f"pipeline_{'bf16' if dtype == torch.bfloat16 else 'f32'}"] = \
            rec
        log(f"pipeline pp=4, {m} microbatches, {ids.shape[0]} x "
            f"{ids.shape[1]} {c.dtype}: embeddings vs Encoder.forward max "
            f"err {err:.3g}, min cosine {cos:.7f}; gradients "
            f"{json.dumps({k: v for k, v in rec.items() if 'grad' in k})} "
            f"({limits}); K1 {k1}, K6 {k6} launches; forward "
            f"{fwd_s * 1e3:.1f} ms (cold) [{card}]")
        del dense, leaves, zd, zp, grads, got
        torch.cuda.empty_cache()
    return counts


def phase_train_parallel(card, timings, results):
    """Multi-GPU training on the card's virtual mesh: K1/K6 at the
    per-shard shape, the dp x tp sharded trainer (f32 parity with the
    single-card step, then bf16 AdamW), the ring trainer at dp x sp
    (f32 parity at S = 2048) and the pipeline encoder at pp = 4.
    Returns the launches of K1 and K6 on its paths, each counted from 0
    just before the path runs."""
    import torch

    from libsplinter_tpu_torch.models import EncoderConfig
    from libsplinter_tpu_torch.parallel import (make_ring_train_step,
                                                make_sharded_train_step,
                                                make_train_step)

    t0 = time.perf_counter()
    # the peaks below count this phase's tensors alone: what earlier
    # phases still hold (their cyclic garbage collected first) is
    # subtracted
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log("train_parallel prediction (PERF.md section 6): K1 per shard "
        "0.025-0.045 ms, K6 0.06-0.10 ms by graph replay; f32 sharded and "
        "ring steps within 1e-5 relative of the single-card loss and 1e-4 "
        "of max |g|; bf16 dp=2 x tp=2 at 0.25-0.4x phase 7's steps/s, "
        "peak 20-30 GB; the ring step 2-3x the single-card f32 step at "
        "S=2048, its peak 4-8 GB above; the pipeline's bf16 embeddings at "
        f"cosine >= 0.999; the phase 40-90 s [{card}]")
    _flash_shard_rows(results, card)
    out: dict = {}
    counts = dict.fromkeys(("flash_fwd", "flash_bwd"), 0)

    def add(c):
        for k, v in c.items():
            counts[k] += v

    cfg = EncoderConfig()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rng = np.random.default_rng(23)                  # phase 7's batch
    batch = _train_batch(rng, cfg.vocab_size, TRAIN_B, TRAIN_S, 128)

    def sgd(p):
        return torch.optim.SGD(p, lr=PAR_LR)

    # (A) dp = 2 x tp = 2
    mesh, how = _shard_mesh(dp=2, tp=2)
    log(f"train_parallel: mesh {mesh.shape} ({how}); earlier phases hold "
        f"{held / 1e9:.2f} GB, left out of the peaks below [{card}]")
    per = 2 * cfg.layers
    half = {k: x[:TRAIN_B // 2] for k, x in batch.items()}
    c, out["sharded_f32"] = _one_step_parity(
        card, "sharded f32 dp=2 x tp=2, 8 pairs x S=512",
        make_train_step(cfg32, sgd),
        _init_and_step(make_sharded_train_step(cfg32, mesh, sgd)),
        half, {"single": {"flash_fwd": per, "flash_bwd": per},
               "sharded": {"flash_fwd": per * 4, "flash_bwd": per * 4}},
        held)
    add(c)
    add(_train_sharded_bf16(card, cfg, mesh, batch, out, held))

    # (B) dp = 1 x sp = 4 at S = 2048
    ring_mesh, how = _shard_mesh(dp=1, sp=4)
    long = _train_batch(np.random.default_rng(31), cfg.vocab_size, 4, 2048,
                        512)
    c, out["ring_f32"] = _one_step_parity(
        card, f"ring f32 dp=1 x sp=4 ({how}), 4 pairs x S=2048",
        make_train_step(cfg32, sgd),
        make_ring_train_step(dataclasses.replace(cfg32, ring_axis="sp"),
                             ring_mesh, sgd),
        long, {"single": {"flash_fwd": per, "flash_bwd": per},
               "sharded": {"flash_fwd": 0, "flash_bwd": 0}}, held)
    add(c)

    # (C) pp = 4
    pipe_mesh, how = _shard_mesh(pp=4)
    log(f"pipeline: mesh {pipe_mesh.shape} ({how}) [{card}]")
    add(_pipeline_check(card, cfg, pipe_mesh, batch, out))
    wall = time.perf_counter() - t0
    out["wall_s"] = wall
    timings["train_parallel"] = out
    log(f"train_parallel phase: {wall:.1f}s; K1/K6 launches on its paths "
        f"{counts} [{card}]")
    return counts


def _lane_slots(requested: int) -> int:
    """The requested slot count, cut to 262,144 when the temp dir
    cannot hold the file-backed store (~11.5 KB per slot mapped)."""
    free = shutil.disk_usage(tempfile.gettempdir()).free
    need = requested * (8192 + LANE_DIM * 4 + 512)
    if free >= need:
        return requested
    log(f"lane: temp dir has {free / 1e9:.1f} GB free < {need / 1e9:.1f} "
        f"GB for {requested} slots; cutting to 262144 slots")
    return 262144


def main() -> int:
    try:
        import torch
    except ImportError as ex:
        print(f"chip_smoke: torch is not importable ({ex})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import libsplinter_tpu_torch  # noqa: F401
    except ImportError as ex:
        print(f"chip_smoke: the libsplinter_tpu_torch package is missing "
              f"beside this script ({ex})", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    results: dict = {}
    timings: dict = {}
    t_start = time.perf_counter()
    clock = PhaseClock()
    tmp = tempfile.mkdtemp(prefix="spt-smoke-files-")
    try:
        with clock.phase("device"):
            name, count, card = phase_device()
        with clock.phase("build"):
            phase_build()
        with clock.phase("flash"):
            phase_flash(results)
        with clock.phase("flash_bwd"):
            phase_flash_bwd(results)
        with clock.phase("search_kernels"):
            phase_search_kernels(results, 1 << 20)
        with clock.phase("causal"):
            phase_causal(results)
        with clock.phase("paged"):
            phase_paged(results)
        with clock.phase("lane"):
            counts = phase_lane(_lane_slots(1 << 20), card, timings, tmp)
        with clock.phase("completion"):
            k4 = {"phase 5": phase_completion(card, timings)["causal_fwd"]}
        with clock.phase("continuous"):
            cont = phase_continuous(card, timings)
        counts["paged_fwd"] = cont["paged_fwd"]
        # K4 runs on both completion lanes, each counted from 0 just
        # before its path: the record carries their sum
        k4["phase 6"] = cont["causal_fwd"]
        counts["causal_fwd"] = sum(k4.values())
        timings["causal_fwd_launches"] = k4
        with clock.phase("train"):
            counts["flash_bwd"] = phase_train(card, timings)["flash_bwd"]
        # K1, K2, K4 and K5 again from GGUF-loaded weights, counted from
        # 0 before each of this phase's paths: the record carries sums
        with clock.phase("gguf"):
            gguf = phase_gguf(card, timings, tmp)
        for k, v in gguf.items():
            counts[k] += v
        timings["gguf_launches"] = gguf
        # K4 and K5 once more on each serving variant's path (int8
        # weights, the KV tier, the split lanes), each counted from 0
        with clock.phase("variants"):
            variants = phase_variants(card, timings, tmp)
        for path in variants.values():
            for k, v in path.items():
                counts[k] += v
        timings["variants_launches"] = variants
        # and on the speculative lanes and the MoE lanes, each path
        # counted from 0 just before it runs
        for phase, key in ((phase_speculative, "speculative_launches"),
                           (phase_moe, "moe_launches")):
            with clock.phase(phase.__name__[len("phase_"):]):
                paths = phase(card, timings, tmp)
            for path in paths.values():
                for k, v in path.items():
                    counts[k] += v
            timings[key] = paths
        # the whole serving surface as supervised child processes: each
        # lane's launches come from its own heartbeat, every child
        # starting from 0 after this point
        with clock.phase("supervision"):
            sup, sup_counts = phase_supervision(card, timings, tmp)
        for k, v in sup_counts.items():
            counts[k] += v
        timings["supervision_launches"] = sup
        # the operator CLI over phase 4's store: the children's launches
        # from their heartbeats, the CLI's own (K3 at Q = 1) from this
        # process, each counting from 0 after this point
        with clock.phase("cli"):
            cli, cli_counts = phase_cli(card, timings, tmp,
                                        os.path.join(tmp, "lane.spt"))
        for path in list(cli.values()) + [cli_counts]:
            for k, v in path.items():
                counts[k] += v
        timings["cli_launches"] = dict(cli, cli=cli_counts)
        # sharded serving: K2-K5 at their per-shard shapes on each path,
        # each counted from 0 just before it runs
        with clock.phase("sharded"):
            sharded, sharded_sums = phase_sharded(
                card, timings, tmp, results, os.path.join(tmp, "lane.spt"))
        for k, v in sharded_sums.items():
            counts[k] += v
        timings["sharded_launches"] = sharded
        # multi-GPU training: K1 and K6 at the per-shard and per-stage
        # shapes on each path, each counted from 0 just before it runs
        with clock.phase("train_parallel"):
            par = phase_train_parallel(card, timings, results)
        for k, v in par.items():
            counts[k] += v
        timings["train_parallel_launches"] = par
    except Exception:
        traceback.print_exc()
        log(f"phase walls (to the failure): {clock}")
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log(f"phase walls: {clock}")
    log(json.dumps({"kernels": counts}))
    if not all(counts[k] > 0 for k in REPLACES):
        print(f"chip_smoke: a kernel never ran on the main path: {counts}",
              file=sys.stderr)
        return 1
    # the record per kernel: its main-path shape (bf16 K1 at B=8 S=2048;
    # K2 at Q=8 k=16 and K3 at Q=8, the searcher's batches of phase 4;
    # K4 at the bucket-1024 batch of phase 5; K5 at a decode step of the
    # continuous lane's 32 rows of phase 6; K6 at the training batch of
    # phase 7, one tower of 16 x 512)
    main_shape = {"flash_fwd": "B=8 S=2048 H=12 D=64 bf16",
                  "flash_bwd": f"B={TRAIN_B} S={TRAIN_S} H=12 D=64 bf16",
                  "fused_topk": f"N={1 << 20} D={LANE_DIM} Q=8 k=16 f32",
                  "cosine_scores": f"N={1 << 20} D={LANE_DIM} Q=8 f32",
                  "causal_fwd": CAUSAL_MAIN,
                  "paged_fwd": PAGED_MAIN}
    kernels = []
    for kname in ("flash_fwd", "flash_bwd", "fused_topk", "cosine_scores",
                  "causal_fwd", "paged_fwd"):
        rec = next(r for r in results[kname]
                   if r["shape"] == main_shape[kname])
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    log(f"timings: {json.dumps(timings, default=str)}")
    log(f"total {time.perf_counter() - t_start:.1f}s [{card}]")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
