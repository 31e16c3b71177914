"""Tiered KV: HBM -> host-DRAM spill tier + persistent warm layer.

Before this module every page the radix prefix cache gave back was
GONE: `PrefixCache._evict_one` dropped the block to the free list and
the next identical prompt paid a full re-prefill, and every supervised
restart or PR 15 scale-up attached stone cold — elastic capacity
bought cold caches (the failure mode ROADMAP item 3 names).  The tier
splits "reclaim the HBM page" from "forget the KV":

  HBM (tier 0)    the paged pool — pages the ragged kernel reads.
  DRAM (tier 1)   `HostTier`: host copies of FROZEN tree pages (PR
                  14's freeze/refcount machinery marks them immutable,
                  hence safely copyable).  Eviction DEMOTES a page
                  here instead of dropping it; the radix node survives
                  with a `tier` tag and re-admission is a device_put +
                  block-table write (`PrefixCache.readmit`), not a
                  re-prefill.  PowerInfer (arxiv 2312.12456) grounds
                  the hot-set-in-fast-tier split: the working set
                  stays in HBM, the long tail pays one PCIe copy.
  File (warm)     `TierPersist`: the radix index + host-tier pages
                  checkpoint into a file-backed persistent store
                  segment (store.py BACKEND_FILE — the reference's
                  `libsplinter_p.so` build variant, PAPER.md §L2), so
                  a supervised restart or a scale-up replica attaches
                  WARM.

Host copies are written THROUGH at insert time (`PrefixCache._spill`,
fault site `tier.spill`): a page enters the tree frozen and its DRAM
shadow is taken immediately, so demotion at eviction time is pure
bookkeeping and the persistent snapshot always covers the live warm
set — not just whatever happened to be evicted before the crash.

Snapshot protocol (the `__ho_<idx>` write-record-last idiom from the
disagg handoff, epoch-bumped): payload keys land FIRST under an
epoch-namespaced prefix (`__tier_e<E>.p<i>` / `.s<i>` / `.n<i>`), the
index record (`__tier_index`) lands LAST naming that epoch, and only
then is the previous epoch swept.  A crash mid-save leaves the old
record pointing at the old epoch's untouched keys — still a valid
snapshot.  `load()` validates EVERY byte before mutating anything
(version, geometry, per-page lengths), so a torn/partial snapshot is
detected and discarded with a typed reason the heartbeat surfaces
(`tier_restore_reason`), never half-loaded; fault site `tier.restore`
fires between validation and adoption so the chaos drill can prove a
mid-restore death falls back cold with zero admitted loss.
"""
from __future__ import annotations

import json
from collections import OrderedDict

from ..utils.faults import fault

__all__ = ["HostTier", "TierPersist", "tier_geometry"]

# the persistent segment's index record key: written LAST, read FIRST
INDEX_KEY = "__tier_index"


def _page_key(epoch: int, i: int) -> str:
    return f"__tier_e{epoch}.p{i}"


def _scale_key(epoch: int, i: int) -> str:
    return f"__tier_e{epoch}.s{i}"


def _entry_key(epoch: int, i: int) -> str:
    return f"__tier_e{epoch}.n{i}"


def tier_geometry(model, cache) -> dict:
    """The pool geometry a snapshot was taken under.  A restored page
    is raw device bytes — replaying it into a pool with ANY other
    shape/dtype would serve silent garbage, so load() refuses on the
    slightest mismatch (typed reason: geometry_mismatch)."""
    cfg = model.cfg
    return {"page": int(cache.page), "layers": int(cfg.layers),
            "kv_heads": int(cfg.kv_heads),
            "head_dim": int(cfg.head_dim),
            "quantized": bool(getattr(cache, "quantized", False)),
            "wire_dtype": str(model._page_wire_dtype(cache)),
            "page_bytes": int(model.page_wire_bytes(cache))}


def _iter_nodes(pc):
    """(node, full token prefix) over every tree node — the chain a
    node's page was computed under IS its identity (KV at position p
    depends on every token before p)."""
    stack = [((), n) for n in pc._children.values()]
    while stack:
        prefix, node = stack.pop()
        full = prefix + node.toks
        yield node, full
        stack.extend((full, c) for c in node.children.values())


class HostTier:
    """Host-RAM page pool: node -> (page bytes, scale bytes | None),
    LRU-bounded at `capacity` pages.  Single-owner like the tree it
    shadows (the lane thread); dropping an entry for a DRAM-resident
    (tier 1) node makes that node unservable, so the PrefixCache
    prunes it — put() returns the overflow victims for exactly that.
    """

    def __init__(self, capacity_pages: int):
        self.capacity = max(1, int(capacity_pages))
        self._entries: "OrderedDict" = OrderedDict()
        self.dirty = False            # snapshot content changed
        # counters the heartbeat publishes (tier_* gauges)
        self.spills = 0               # host shadow copies taken
        self.spill_failures = 0       # export failed: page stayed HBM
        self.demotions = 0            # evictions turned into demotes
        self.readmits = 0             # DRAM -> HBM device_put returns
        self.readmit_failures = 0
        self.capacity_drops = 0       # shadows LRU-dropped at capacity
        self.restored = 0             # pages adopted from a snapshot

    def __len__(self) -> int:
        return len(self._entries)

    def bytes_held(self) -> int:
        return sum(len(b) + (len(s) if s else 0)
                   for b, s in self._entries.values())

    def has(self, node) -> bool:
        """Membership without an LRU touch — lookups that may be
        denied must not refresh recency (same purity contract as
        PrefixCache.lookup)."""
        return node in self._entries

    def peek(self, node):
        return self._entries.get(node)

    def get(self, node):
        """Fetch for readmission: LRU-touches the entry."""
        ent = self._entries.get(node)
        if ent is not None:
            self._entries.move_to_end(node)
        return ent

    def put(self, node, page_bytes: bytes,
            scale_bytes: bytes | None) -> list:
        """Insert/refresh a shadow; returns the LRU overflow victims
        (nodes whose shadows were dropped to stay under capacity —
        the caller prunes any that were DRAM-resident)."""
        self._entries[node] = (page_bytes, scale_bytes)
        self._entries.move_to_end(node)
        self.dirty = True
        dropped = []
        while len(self._entries) > self.capacity:
            victim, _ = self._entries.popitem(last=False)
            self.capacity_drops += 1
            dropped.append(victim)
        return dropped

    def drop(self, node) -> None:
        if self._entries.pop(node, None) is not None:
            self.dirty = True

    def clear(self) -> None:
        if self._entries:
            self.dirty = True
        self._entries.clear()


class TierPersist:
    """The file-backed warm layer: one persistent store segment per
    serving lane family (BACKEND_FILE — mmap survives the process),
    holding the radix index + host-tier page payloads, epoch-bumped
    and write-record-last.  Replica 0 writes; every spawning replica
    reads, so a scale-up attaches warm from the leader's snapshot."""

    def __init__(self, name: str, *, capacity_pages: int,
                 max_len: int, page_bytes: int):
        from ..store import Store
        self.name = name
        self.epoch = 0
        # per entry: page payload + entry meta (+ scales when
        # quantized) = 3 keys; two epochs coexist transiently during
        # a save, plus the index record and slack
        nslots = 8 * max(8, int(capacity_pages)) + 64
        # the entry meta's token chain is the long pole: up to
        # max_len ids rendered as JSON ints
        max_val = max(4096, int(page_bytes) + 256,
                      int(max_len) * 8 + 512)
        st = None
        try:
            st = Store.open(name, persistent=True)
            if st.max_val < max_val or st.nslots < nslots:
                # geometry grew across a restart (bigger pages or a
                # raised tier capacity): the old segment cannot hold
                # the new snapshot — recreate cold
                st.close()
                st = None
                Store.unlink(name, persistent=True)
        except OSError:
            st = None
        if st is None:
            st = Store.create(name, nslots=nslots, max_val=max_val,
                              vec_dim=8, persistent=True,
                              overwrite=True)
        self.store = st

    def close(self) -> None:
        try:
            self.store.close()
        except Exception:
            pass

    @staticmethod
    def unlink(name: str) -> None:
        from ..store import Store
        Store.unlink(name, persistent=True)

    # -- save ---------------------------------------------------------------

    def save(self, pc, tier: HostTier, geom: dict) -> bool:
        """Checkpoint every shadowed page + its token chain.  Payload
        keys first under the NEW epoch, index record last, previous
        epoch swept only after the record lands — a death anywhere in
        between leaves the old snapshot authoritative."""
        st = self.store
        entries = []
        for node, full in _iter_nodes(pc):
            ent = tier.peek(node)
            if ent is not None:
                entries.append((full, int(node.tenant), ent))
        epoch = self.epoch + 1
        try:
            for i, (full, tenant, (buf, sbuf)) in enumerate(entries):
                st.set(_page_key(epoch, i), buf)
                slen = 0
                if sbuf is not None:
                    st.set(_scale_key(epoch, i), sbuf)
                    slen = len(sbuf)
                st.set(_entry_key(epoch, i), json.dumps(
                    {"ids": [int(t) for t in full],
                     "plen": len(buf), "slen": slen,
                     "tenant": tenant}))
            st.set(INDEX_KEY, json.dumps(
                {"v": 1, "epoch": epoch, "count": len(entries),
                 "geom": geom}))
        except (KeyError, OSError, ValueError):
            # partial new epoch: the old record still points at the
            # old epoch's untouched keys — sweep our orphans
            self._sweep(keep=self.epoch)
            return False
        self.epoch = epoch
        self._sweep(keep=epoch)
        tier.dirty = False
        return True

    def _sweep(self, keep: int) -> None:
        """Drop every epoch-namespaced key outside `keep`; never
        raises (a failed sweep only wastes slots until the next)."""
        st = self.store
        prefix_keep = f"__tier_e{keep}."
        try:
            for key in st.list():
                if key.startswith("__tier_e") \
                        and not key.startswith(prefix_keep):
                    try:
                        st.unset(key)
                    except (KeyError, OSError):
                        continue
        except (KeyError, OSError):
            pass

    # -- load ---------------------------------------------------------------

    def load(self, pc, tier: HostTier, geom: dict) -> tuple[int, str]:
        """Attach warm: validate the whole snapshot, then adopt every
        chain as DRAM-tier radix nodes (readmission to HBM happens
        lazily, on the first hit).  Returns (pages restored, typed
        cold-fallback reason) — reason "" means warm.  NOTHING is
        mutated until every byte has been validated, so a torn
        snapshot is discarded, never half-loaded."""
        st = self.store
        try:
            raw = st.get(INDEX_KEY)
        except (KeyError, OSError):
            return 0, "missing_record"
        try:
            rec = json.loads(raw)
        except ValueError:
            return 0, "torn_header"
        if not isinstance(rec, dict) or rec.get("v") != 1:
            return 0, "torn_header"
        try:
            epoch = int(rec["epoch"])
            count = int(rec["count"])
        except (KeyError, TypeError, ValueError):
            return 0, "torn_header"
        if rec.get("geom") != geom:
            return 0, "geometry_mismatch"
        self.epoch = max(self.epoch, epoch)
        chains = []
        for i in range(count):
            try:
                meta = json.loads(st.get(_entry_key(epoch, i)))
                buf = bytes(st.get(_page_key(epoch, i)))
            except (KeyError, OSError, ValueError):
                return 0, "torn_page"
            ids = meta.get("ids") if isinstance(meta, dict) else None
            if not isinstance(ids, list) \
                    or int(meta.get("plen", -1)) != len(buf) \
                    or len(buf) != geom["page_bytes"]:
                return 0, "torn_page"
            sbuf = None
            slen = int(meta.get("slen", 0))
            if slen:
                try:
                    sbuf = bytes(st.get(_scale_key(epoch, i)))
                except (KeyError, OSError):
                    return 0, "torn_page"
                if len(sbuf) != slen:
                    return 0, "torn_page"
            chains.append((ids, int(meta.get("tenant", 0)),
                           buf, sbuf))
        # every byte validated — the chaos drill crashes/raises HERE
        # (tests/chaos_child.py tier_restore): a mid-restore death
        # must fall back cold, never serve a half-adopted tree
        try:
            fault("tier.restore")
            n = 0
            # parents first, so every chain extends an existing path
            chains.sort(key=lambda c: len(c[0]))
            for ids, tenant, buf, sbuf in chains:
                node = pc.adopt_tiered(ids, tenant)
                if node is None:
                    continue
                for dead in tier.put(node, buf, sbuf):
                    pc._drop_tiered(dead)
                n += 1
        except Exception:
            # clean cold fallback: empty the half-built tree + tier
            if pc._cache is not None:
                pc.attach(pc._cache)
            tier.clear()
            return 0, "restore_failed"
        tier.restored += n
        tier.dirty = False
        return n, ""
