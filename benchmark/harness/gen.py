"""The one traffic generator: numpy and the store's client API, nothing
else (no torch, no model), so that clients run in processes of their
own and never share the daemon's interpreter lock.

A traffic mix is a data file (benchmark/traffic/<mix>.json).  Each
request writes a text under a key, labels it for the embedder, and
waits for its vector; the loop is closed (a client sends its next
request the moment one of its own completes).

  clients       client streams, `outstanding` requests in flight each
  generators    processes the clients are spread over
  key_space     keys written, split evenly over the clients
  tokens        {"mean_words", "sigma", "min", "max", "strata"}: a text
                of lognormal length in words, with that mean and sigma,
                plus [CLS] and [SEP], clipped to [min, max] tokens
  vocab_words   size of the synthetic word list the texts draw on
  source        where the lengths and the load come from
  assumed       what the source does not give, and why each value

Every seed gives the same work in another order: lengths come from a
fixed grid of the distribution's quantiles, each client taking one from
every stratum of the grid per round, the same ones for every seed, in
an order drawn from the seed.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np

VOCAB_SEED = 20240229          # the word list is part of the mix, not the run
GRID = 4096                    # quantiles of a length distribution


# -- content ---------------------------------------------------------------

def length_grid(tokens: dict) -> np.ndarray:
    """The fixed, sorted grid of token lengths a mix draws from: words
    lognormal with mean tokens["mean_words"], two special tokens more."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / GRID)
                  for i in range(GRID)])
    sigma = tokens["sigma"]
    mu = math.log(tokens["mean_words"]) - sigma * sigma / 2.0
    n = np.rint(np.exp(mu + sigma * z)) + 2
    return np.clip(n, tokens["min"], tokens["max"]).astype(np.int64)


def vocabulary(n_words: int) -> np.ndarray:
    """`n_words` distinct lower-case words of 2 to 8 letters."""
    rng = np.random.default_rng(VOCAB_SEED)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words: dict[str, None] = {}
    while len(words) < n_words:
        size = int(rng.integers(2, 9))
        words["".join(rng.choice(letters, size))] = None
    return np.array(list(words))


def request_rng(seed: int, client: int, n: int) -> np.random.Generator:
    return np.random.default_rng([seed, client, n])


def length_index(traffic: dict, seed: int, client: int, n: int) -> int:
    """The grid index of request n's length: one length from every
    stratum of the grid per round of `strata` requests, in an order drawn
    from the seed.  Which length of a stratum a round takes walks the
    stratum the same way for every seed, so every seed sends the same
    lengths, round by round, in another order."""
    strata = traffic["tokens"]["strata"]
    per = GRID // strata
    rnd = n // strata
    order = np.random.default_rng([seed, client, rnd, 1]).permutation(strata)
    pick = (rnd * 97 + client * 31) % per
    return int(order[n % strata]) * per + pick


def embed_request(traffic: dict, grid: np.ndarray, words: np.ndarray,
                  seed: int, client: int, n: int) -> tuple[int, str]:
    """(tokens, text) of request n of a client: its length from the grid,
    then tokens - 2 words ([CLS] and [SEP] are the rest)."""
    ntok = int(grid[length_index(traffic, seed, client, n)])
    rng = request_rng(seed, client, n)
    text = " ".join(words[rng.integers(0, len(words), ntok - 2)])
    return ntok, text


def client_keys(traffic: dict, client: int) -> list[str]:
    per = traffic["key_space"] // traffic["clients"]
    return [f"doc/{client * per + j}" for j in range(per)]


# -- the process -----------------------------------------------------------

class _Client:
    def __init__(self, cid, keys):
        self.cid = cid
        self.n = 0                       # next request number
        self.free = keys                 # keys with nothing outstanding
        self.live: dict[int, tuple] = {}  # slot index -> request state
        self.refused: set[int] = set()   # keys whose last text was refused


def client_main(conn, store_path: str, traffic: dict, seed: int,
                clients: list[int]) -> None:
    """Run `clients` against the store at `store_path`: report ready,
    wait for ("start", t0, t1) (CLOCK_MONOTONIC seconds), issue requests
    in [t0, t1), then wait for the outstanding ones until t1 +
    traffic["grace_s"], and send back one record per request."""
    from libsplinter_tpu_torch.engine import protocol as P
    from libsplinter_tpu_torch.store import Store

    from .guard import forbidden_modules

    st = Store.open(store_path, persistent=True)
    cap = traffic["outstanding"]
    grid = length_grid(traffic["tokens"])
    words = vocabulary(traffic["vocab_words"])
    cl = []
    for c in clients:
        keys = client_keys(traffic, c)
        order = np.random.default_rng([seed, c, 3]).permutation(len(keys))
        keys = [keys[i] for i in order]
        for key in keys:
            if key not in st:
                st.set(key, b"-")
        cl.append(_Client(c, [st.find_index(k) for k in keys]))
    key_of = {idx: st.key_at(idx) for c in cl for idx in c.free}
    recs: list[tuple] = []
    conn.send(("ready", os.getpid()))
    _, t0, t1 = conn.recv()
    end = t1 + traffic["grace_s"]
    busy = 0.0
    passes, pass_max = 0, 0.0
    while True:
        now = time.monotonic()
        if now < t0:
            time.sleep(min(t0 - now, 0.01))
            continue
        live = sum(len(c.live) for c in cl)
        if now >= end or (now >= t1 and live == 0):
            break
        b0 = now
        acted = False
        for c in cl:
            for idx, req in list(c.live.items()):
                labels = st.labels_at(idx)
                if labels & P.LBL_EMBED_REQ or st.epoch_at(idx) < req[3]:
                    continue
                t_done = time.monotonic()
                # a refused text (the context guard) is a failure
                result = None if labels & P.LBL_CTX_EXCEEDED else True
                if result is None:
                    c.refused.add(idx)
                recs.append((c.cid, req[0], idx, req[1], req[2], t_done,
                             result))
                del c.live[idx]
                c.free.append(idx)
                acted = True
            while c.free and len(c.live) < cap:
                t_issue = time.monotonic()
                if t_issue >= t1:
                    break
                idx = c.free.pop(0)
                n = c.n
                c.n += 1
                key = key_of[idx]
                ntok, text = embed_request(traffic, grid, words, seed,
                                           c.cid, n)
                if idx in c.refused:
                    st.label_clear(key, P.LBL_CTX_EXCEEDED)
                    c.refused.discard(idx)
                st.set(key, text)
                want = st.epoch_at(idx) + 2
                st.label_or(key, P.LBL_EMBED_REQ)
                st.bump(key)
                c.live[idx] = (n, t_issue, ntok, want)
                acted = True
        t_end = time.monotonic()
        busy += t_end - b0
        passes += 1
        pass_max = max(pass_max, t_end - b0)
        if not acted:
            time.sleep(traffic["poll_s"])
    for c in cl:                          # never completed: lost
        for idx, req in c.live.items():
            recs.append((c.cid, req[0], idx, req[1], req[2], math.nan, None))
    wall = max(time.monotonic() - t0, 1e-9)
    conn.send(("done", recs, {"busy_share": busy / wall, "passes": passes,
                              "pass_ms_max": pass_max * 1e3},
               forbidden_modules()))
    st.close()
