"""CLI `search` — semantic vector search over the store.

Protocol parity with the reference search command (SURVEY.md §3.4):
write the query to a scratch key __sqtmp_<pid>, label it 0x1 + bump so
the embedding daemon picks it up, poll for the vector, then score every
candidate — except the scoring is the hand-written CUDA cosine kernel
(K3, ops/similarity.cosine_scores) over the device-resident vector lane
instead of a scalar C loop, or the search daemon's fused top-k.  The
card is the default; --cpu scores with the kernels' plain versions, and
a host without CUDA refuses the local path rather than scoring on the
CPU in silence.  --sharded (the pod path) waits for the multi-GPU slice.
"""
from __future__ import annotations

import json
import os
import re
import sys

import numpy as np

from ..engine import protocol as P
from .main import CliError, command


@command("search", "search [--json] [--limit N] [--similarity S] "
         "[--distance D] [--bloom MASK] [--regex RX] [--timeout MS] "
         "[--cpu] [--sharded] [--fast] [--local] QUERY...",
         "semantic vector search (CUDA top-k; --fast = bf16 products, "
         "~2e-2 score precision; --cpu scores on the CPU; a live search "
         "daemon is used automatically — --local forces client-side "
         "scoring)")
def cmd_search(ses, args):
    opts = {"json": False, "limit": 10, "similarity": None,
            "distance": None, "bloom": 0, "regex": None, "timeout": 2000,
            "cpu": False, "sharded": False, "fast": False,
            "local": False}
    query_words = []
    it = iter(args)

    def arg_of(flag):
        try:
            return next(it)
        except StopIteration:
            raise CliError(f"{flag} requires a value") from None

    try:
        for a in it:
            if a == "--json":
                opts["json"] = True
            elif a == "--cpu":
                opts["cpu"] = True
            elif a == "--sharded":
                opts["sharded"] = True
            elif a == "--local":
                opts["local"] = True
            elif a == "--fast":
                # bf16 MXU scoring (pallas path only): 2x matmul
                # throughput, scores good to ~2e-2 absolute — fine for
                # ranking; --similarity thresholds should allow slack
                opts["fast"] = True
            elif a == "--limit":
                opts["limit"] = int(arg_of(a))
            elif a == "--similarity":
                opts["similarity"] = float(arg_of(a))
            elif a == "--distance":
                opts["distance"] = float(arg_of(a))
            elif a == "--bloom":
                opts["bloom"] = ses.label_mask(arg_of(a))
            elif a == "--regex":
                opts["regex"] = arg_of(a)
            elif a == "--timeout":
                opts["timeout"] = int(arg_of(a))
            elif a == "-":
                query_words.append(sys.stdin.read())
            elif a.startswith("--file"):
                query_words.append(open(arg_of(a)).read())
            else:
                query_words.append(a)
    except ValueError as e:
        raise CliError(f"bad flag value: {e}") from None
    query = " ".join(query_words).strip()
    if not query:
        raise CliError("usage: search [flags] QUERY")
    st = ses.store
    if st.vec_dim == 0:
        raise CliError("store has no vector lane")

    # 1. scratch key -> label 0x1 -> bump: wake the embedding daemon
    scratch = f"{P.SEARCH_SCRATCH_PREFIX}{os.getpid()}"
    st.set(scratch, query)
    from .. import T_VARTEXT
    st.set_type(scratch, T_VARTEXT)
    st.label_or(scratch, P.LBL_EMBED_REQ)
    st.bump(scratch)

    # 2. wait for the vector
    qvec = None
    st.poll(scratch, timeout_ms=opts["timeout"])
    v = st.vec_get(scratch)
    if np.abs(v).max() > 0:
        qvec = v
    if qvec is None:
        # degrade without scoring, like the reference: list candidates
        print("warning: no embedding daemon answered; listing unscored "
              "candidates", file=sys.stderr)

    # 3. candidate mask: ONE bulk epoch snapshot (or a native bloom
    # enumeration) — never a per-slot FFI loop.  Keys are fetched lazily
    # for the ranked head only, so regex/scratch filtering costs
    # O(results inspected), not O(nslots).
    rx = re.compile(opts["regex"]) if opts["regex"] else None
    # THE candidate-mask definition, shared with the search daemon
    # (engine/protocol.candidate_mask) so client-side and server-side
    # candidate sets cannot diverge
    mask = P.candidate_mask(st, opts["bloom"])

    def key_ok(k: str | None) -> bool:
        if k is None or k.startswith(P.SEARCH_SCRATCH_PREFIX):
            return False
        return rx is None or bool(rx.search(k))

    rows = []
    if qvec is not None and opts["sharded"]:
        # pod path: the multi-GPU slice is not ported; retire the
        # scratch key and refuse (never a quiet single-card search)
        try:
            st.unset(scratch)
        except KeyError:
            pass
        raise CliError("search --sharded needs the multi-GPU slice "
                       "(ROADMAP.md Queue A item 5), not yet ported; "
                       "drop --sharded to search this card's lane")
    elif qvec is not None and mask.any():
        served = None
        if not opts["cpu"] and not opts["local"]:
            # a live search daemon coalesces concurrent queries into
            # QB-bucketed fused-kernel batches server-side: dispatch
            # there instead of paying a private device round trip.
            # Timeout / error falls back to client-side scoring.
            from ..engine.searcher import daemon_live
            if daemon_live(st):
                served = _daemon_search(st, scratch, qvec, opts, key_ok)
        if served is not None:
            rows = served
        else:
            rows = _local_search(ses, st, qvec, mask, opts, key_ok)
    else:
        # degraded path (no embedding answered): list the CANDIDATES —
        # the mask already encodes the bloom prefilter
        cand = (st.key_at(int(i)) for i in np.nonzero(mask)[0])
        keys = sorted(k for k in cand if key_ok(k))
        rows = [{"key": k, "similarity": None, "distance": None}
                for k in keys[: opts["limit"]]]

    # 4. cleanup + output (the daemon result row rides the scratch
    # slot's index — retire it with the scratch key)
    try:
        st.unset(P.search_result_key(st.find_index(scratch)))
    except (KeyError, OSError):
        pass
    try:
        st.unset(scratch)
    except KeyError:
        pass
    if opts["json"]:
        print(json.dumps(rows, indent=2))
    else:
        if not rows:
            print("no matches")
        for r in rows:
            if r["similarity"] is None:
                print(r["key"])
            elif "host" in r:                   # sharded hit: host-tagged
                print(f"{r['similarity']:+.4f}  h{r['host']}/"
                      f"{r['slot']:<6d}  {r['key']}")
            else:                               # local AND daemon rows
                print(f"{r['similarity']:+.4f}  {r['distance']:8.4f}  "
                      f"{r['key']}")


def _daemon_search(st, scratch, qvec, opts, key_ok) -> list[dict] | None:
    """Route the query through the search daemon (engine/searcher.py):
    the scratch key already holds the embedded query vector, so the
    request is a value rewrite + relabel on the same slot.  Returns
    result rows, or None when the daemon times out / errors (the
    caller falls back to client-side scoring).

    Over-fetch and GROW like the sharded path: the daemon drops
    system/scratch rows server-side, but regex misses and similarity
    cutoffs are client-side concerns, and the growth stays on the
    daemon's bucketed fetch-k schedule."""
    from ..engine.searcher import consume_result, submit_search

    fetch_k = _bucket(opts["limit"] + (8 if opts["regex"] else 4))
    rows: list[dict] = []
    while True:
        rec = submit_search(st, scratch, fetch_k, bloom=opts["bloom"],
                            fast=opts["fast"],
                            timeout_ms=opts["timeout"])
        consume_result(st, scratch)
        if rec is None or rec.get("err"):
            return None
        rows.clear()
        satisfied = False
        for key, sim, idx in zip(rec["keys"], rec["s"], rec["i"]):
            if not key_ok(key):
                continue
            sim = round(sim, 6)
            if opts["similarity"] is not None and \
                    sim < opts["similarity"]:
                satisfied = True              # sorted desc: all below now
                break
            # exact distance for the ranked head only: O(k) row
            # fetches, never an O(nslots) second score pass — computed
            # unconditionally so the row shape matches the local path
            # regardless of which side scored (daemon liveness must
            # never change the output contract)
            dist = float(np.linalg.norm(st.vec_get_at(int(idx))
                                        - qvec))
            if opts["distance"] is not None and dist > opts["distance"]:
                continue
            rows.append({"key": key, "similarity": sim,
                         "distance": round(dist, 6)})
            if len(rows) >= opts["limit"]:
                satisfied = True
                break
        if satisfied or rec["n"] < rec["fetched"] \
                or fetch_k >= st.nslots:      # lane exhausted: no growth
            return rows
        fetch_k *= 8                          # stays on the bucket schedule


def _local_search(ses, st, qvec, mask, opts, key_ok) -> list[dict]:
    """Client-side scoring over the session's device-resident lane
    (the pre-daemon path, kept for --local, --cpu, and fallback): K3
    with one query on the card, its plain version with --cpu."""
    from ..ops.similarity import cosine_scores, euclidean_distances
    from ..utils.device import resolve_device
    try:
        device = resolve_device("cpu" if opts["cpu"] else None)
    except RuntimeError as e:
        try:
            st.unset(f"{P.SEARCH_SCRATCH_PREFIX}{os.getpid()}")
        except KeyError:
            pass
        raise CliError(f"{e}; `search --cpu` scores on the CPU") from None
    # device-resident lane cache: full upload on the session's first
    # search, O(dirty rows) re-staging afterwards (VERDICT r1 item 2)
    staged = ses.lane(device)
    lane = staged.refresh()
    scores = cosine_scores(lane, qvec, mask, mxu_bf16=opts["fast"],
                           vnorm=staged.norms)[:, 0].cpu().numpy()
    dists = euclidean_distances(lane, qvec, mask)[:, 0].cpu().numpy()
    order = np.argsort(-scores)
    rows: list[dict] = []
    for i in order:
        i = int(i)
        sim, dist = float(scores[i]), float(dists[i])
        if sim <= -1e29:
            break                             # sorted: only filler left
        if opts["similarity"] is not None and sim < opts["similarity"]:
            break                             # sorted desc: all below now
        if opts["distance"] is not None and dist > opts["distance"]:
            continue
        k = st.key_at(i)
        if not key_ok(k):
            continue
        rows.append({"key": k, "similarity": round(sim, 6),
                     "distance": round(dist, 6)})
        if len(rows) >= opts["limit"]:
            break
    return rows


def _bucket(n: int) -> int:
    """Shared pad bucket: few distinct sizes -> few compiled programs."""
    b = 8
    while b < n:
        b *= 8
    return b
