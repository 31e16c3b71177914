"""Host-side radix prefix cache over the block-paged KV pool.

Millions of requests share the same system prompts, few-shot headers,
and RAG boilerplate — and before this module every admission
re-prefilled and re-committed identical pages: a 67 ms bucket-64
prefill that could have been a host-side block-table write.  The
block-paged pool (models/decoder.PagedKVCache) already reads
exclusively through per-row block tables, so the ragged paged kernel
(ops/paged_attention) serves SHARED pages with zero changes — all the
sharing machinery is host-side:

  - **Refcounted pages** (PagedKVCache.refcounts): block tables from
    different rows point at the same full pages; a page returns to
    the free list only when its refcount hits zero.
  - **This tree**: full-page prefixes indexed by token ids, page
    granular — node j of a chain holds the pool page with the K/V of
    tokens [j*page, (j+1)*page) computed IN CONTEXT of the whole
    prefix (K/V at position p depend on every token before p, so a
    page is only reusable under the exact token prefix it was
    computed under — hence a radix tree, not a flat page hash).
  - **Copy-on-write** (PagedKVCache / CompletionModel._cow_fixups):
    a decode append whose target page is shared (or tree-frozen)
    copies the page first, so a writer never mutates a page another
    row — or a future joiner — reads.  Tree pages are otherwise
    FROZEN read-only; for int8 pools that means their per-page scales
    never rescale, which *removes* the stale-scale hazard
    quantize-on-commit pools otherwise carry.

Lifecycle: pages enter the tree at admission (after the committing
row's prefill), while the donor row is still live — a mid-flight
joiner may map a prefix another row is actively decoding from (the
donor's appends only ever touch pages past its prompt).  When every
mapping row finishes, the page's refcount hits zero and it becomes
EVICTABLE: it stays allocated (and instantly re-mappable) until the
pool actually needs the page back, at which point eviction takes the
least-recently-matched zero-ref chain tails first.  Per-tenant page
quotas (engine/qos.py `parse_tenant_quotas`, surfaced through the
tenant ledger in the completer heartbeat) bound how much of the pool
any one tenant's prefixes may squat on.

Invariants the churn drill (tests/test_prefix_cache.py) pins:
refcount 0 <=> (free list membership XOR tree retention); no page is
ever in the free list while a table or the tree references it; a
row's mapped prefix path has monotonically non-increasing refcounts
root -> tail (rows always map whole prefixes), so a zero-ref node's
entire subtree is zero-ref and leaf-first eviction can always make
progress.
"""
from __future__ import annotations

import dataclasses
import itertools

from ..utils.faults import fault


@dataclasses.dataclass
class PrefixCacheStats:
    """Counters the completer heartbeat publishes (prefix_* gauges in
    `spt metrics`, ring history in the telemetry lane, sparklines in
    `spt top`)."""

    hits: int = 0             # admissions matching >= 1 full page
    misses: int = 0           # admissions matching nothing
    hit_tokens: int = 0       # prompt tokens served from the tree
    inserts: int = 0          # pages registered
    evictions: int = 0        # pages reclaimed for the free list
    cow_copies: int = 0       # copy-on-write page copies
    quota_rejects: int = 0    # inserts skipped: tenant over quota
    bytes_saved: int = 0      # KV bytes not re-prefilled/committed


class _Node:
    __slots__ = ("toks", "bid", "parent", "children", "lru", "tenant",
                 "tier")

    def __init__(self, toks: tuple, bid: int, parent, tenant: int):
        self.toks = toks            # this page's token ids (exact)
        self.bid = bid              # pool block id holding its K/V
        self.parent = parent        # _Node | None (root child)
        self.children: dict[tuple, _Node] = {}
        self.lru = 0                # last-matched clock tick
        self.tenant = tenant
        # 0 = HBM-resident (bid is a live pool page), 1 = demoted to
        # the host-DRAM tier (bid is -1; the bytes live in the bound
        # HostTier and readmit() device_puts them back on a hit).
        # Leaf-first eviction demotes tails before parents, so on any
        # root->leaf path the tier-1 nodes are a contiguous SUFFIX —
        # the invariant lookup_tiered and readmit ride.
        self.tier = 0


class PrefixCache:
    """One instance per continuous-batching completer, bound to its
    pool via attach() (re-bound — and emptied — whenever the lane
    rebuilds the pool: abort recovery, spec demotion).  All methods
    are called from the single lane thread; there is no locking, by
    the same single-owner contract as the pool's host scheduler."""

    def __init__(self, page: int, *, max_pages: int | None = None,
                 tenant_quotas: dict[int, int] | None = None,
                 default_quota: int | None = None):
        if page < 1:
            raise ValueError("page must be >= 1")
        self.page = page
        self.max_pages = max_pages
        self.tenant_quotas = dict(tenant_quotas or {})
        self.default_quota = default_quota
        self.stats = PrefixCacheStats()
        self._cache = None            # the bound PagedKVCache
        self._children: dict[tuple, _Node] = {}   # root level
        self._by_bid: dict[int, _Node] = {}
        self._tenant_pages: dict[int, int] = {}
        self._clock = itertools.count(1)
        # zero-ref tree pages, maintained INCREMENTALLY on the pool's
        # refcount 0<->1 transitions (on_zero_ref / on_ref) — the
        # admission path reads evictable_count per waiting request,
        # so an O(tree) scan there would tax the lane thread
        self._zero_ref = 0
        # host-DRAM spill tier (engine/kv_tier.HostTier): eviction
        # demotes frozen pages here instead of dropping them, and a
        # DRAM hit readmits via device_put instead of re-prefilling.
        # Bound by the owning lane (bind_tier) together with the
        # per-page export/import callables closed over its model+pool.
        self.tier = None
        self._export_page = None      # (bid) -> (bytes, bytes|None)
        self._import_page = None      # (bid, bytes, bytes|None)
        self._demoted = 0             # tier-1 node count (gauge)

    # -- binding -----------------------------------------------------------

    def attach(self, cache) -> None:
        """Bind (or re-bind) to a pool.  The tree references pool
        block ids, so a rebuilt pool invalidates every node — the old
        pool's pages died with it and must not be returned anywhere.
        Host-tier shadows are keyed by node, so they die with the
        tree (the persistent warm layer, if any, survives and the
        owning lane re-loads it after re-binding)."""
        self._cache = cache
        self._children = {}
        self._by_bid = {}
        self._tenant_pages = {}
        self._zero_ref = 0
        self._demoted = 0
        if self.tier is not None:
            self.tier.clear()

    def bind_tier(self, tier, export_page=None,
                  import_page=None) -> None:
        """Arm the DRAM spill tier: `export_page(bid)` host-copies
        one frozen pool page, `import_page(bid, buf, sbuf)` scatters
        one back (models/decoder.py export_page_bytes /
        import_page_bytes, closed over the CURRENT pool — the lane
        re-binds after every pool rebuild)."""
        self.tier = tier
        self._export_page = export_page
        self._import_page = import_page

    # -- lookup / mapping ---------------------------------------------------

    def lookup(self, ids) -> tuple[list[int], int]:
        """Walk the tree over `ids` at page granularity.  Returns
        (matched block ids in prefix order, matched token count).
        PURE: no stats, no LRU touch — a lookup whose admission is
        then denied (backpressure, raced slot) must neither inflate
        the hit rate the runbook triages on nor refresh LRU stamps
        for a prefix that never got served.  The admitting caller
        records the outcome via commit_hit() / note_miss()."""
        page = self.page
        n_full = len(ids) // page
        bids: list[int] = []
        cur = self._children
        for j in range(n_full):
            chunk = tuple(int(t) for t in ids[j * page:(j + 1) * page])
            node = cur.get(chunk)
            if node is None:
                break
            bids.append(node.bid)
            cur = node.children
        return bids, len(bids) * page

    def lookup_tiered(self, ids
                      ) -> tuple[list[int], int, list["_Node"]]:
        """lookup() extended through the DRAM tier: returns
        (hbm_bids, hbm_match_tokens, tier_nodes) where tier_nodes are
        the consecutive DEMOTED nodes continuing the match past the
        HBM prefix (the tier-1-suffix invariant: demotion is
        leaf-first, so they can only trail).  The caller prices them
        as readmit cost — a device_put per page — against the
        re-prefill a miss would pay, and readmit() brings them back.
        PURE like lookup(): no stats, no LRU touch."""
        page = self.page
        n_full = len(ids) // page
        bids: list[int] = []
        nodes: list[_Node] = []
        cur = self._children
        tier = self.tier
        for j in range(n_full):
            chunk = tuple(int(t) for t in ids[j * page:(j + 1) * page])
            node = cur.get(chunk)
            if node is None:
                break
            if node.tier:
                if tier is None or not tier.has(node):
                    break             # shadow gone: unservable tail
                nodes.append(node)
            elif nodes:
                break                 # defensive: HBM past a demote
            else:
                bids.append(node.bid)
            cur = node.children
        return bids, len(bids) * page, nodes

    def commit_hit(self, ids, match: int) -> None:
        """An admission actually mapped `match` tokens of `ids`: count
        the hit and LRU-touch the served path (re-walk — match/page
        node hops, cheap next to the admission it accompanies)."""
        page = self.page
        tick = next(self._clock)
        cur = self._children
        for j in range(match // page):
            node = cur.get(tuple(int(t)
                                 for t in ids[j * page:(j + 1) * page]))
            if node is None:
                break                  # evicted mid-admission: stale
            node.lru = tick
            cur = node.children
        self.stats.hits += 1
        self.stats.hit_tokens += match

    def note_miss(self) -> None:
        self.stats.misses += 1

    # -- insertion ----------------------------------------------------------

    def insert(self, ids, cache, row: int, tenant: int = 0) -> int:
        """Register the FULL prompt pages of `row` (its table entries
        for pages [0, len(ids)//page)) under their token prefix.
        Pages already present are skipped (the hit path mapped them;
        the row's own duplicates stay private).  Returns pages
        inserted.  A page enters FROZEN: the pool will copy-on-write
        before any append could touch it, and for int8 pools its
        scale never rescales again."""
        if cache is not self._cache:
            return 0                  # stale pool: never adopt its ids
        page = self.page
        n_full = len(ids) // page
        inserted = 0
        parent = None
        cur = self._children
        tick = next(self._clock)
        for j in range(n_full):
            chunk = tuple(int(t) for t in ids[j * page:(j + 1) * page])
            node = cur.get(chunk)
            if node is None:
                bid = int(cache.tables[row, j])
                if bid == 0 or bid in self._by_bid:
                    break             # trash / already-owned: stop
                if not self._admit_page(tenant):
                    break
                node = _Node(chunk, bid, parent, tenant)
                cur[chunk] = node
                self._by_bid[bid] = node
                self._tenant_pages[tenant] = \
                    self._tenant_pages.get(tenant, 0) + 1
                self.stats.inserts += 1
                inserted += 1
                # write-through: the page is frozen as of THIS
                # registration, so its host shadow is taken now —
                # demotion later is pure bookkeeping, and the warm
                # snapshot covers the live set, not just evictees
                self._spill(node)
            elif node.tier:
                # a demoted node on the row's freshly prefilled path:
                # the row holds an identical page (same token chain =>
                # same K/V), so promote the node onto the row's block
                bid = int(cache.tables[row, j])
                if bid == 0 or bid in self._by_bid:
                    break
                if not self._admit_page(node.tenant):
                    break
                node.bid = bid
                node.tier = 0
                self._demoted -= 1
                self._by_bid[bid] = node
                self._tenant_pages[node.tenant] = \
                    self._tenant_pages.get(node.tenant, 0) + 1
                self.stats.inserts += 1
                inserted += 1
                if self.tier is not None and not self.tier.has(node):
                    self._spill(node)
            node.lru = tick
            parent = node
            cur = node.children
        return inserted

    def _spill(self, node) -> bool:
        """Take the host-DRAM shadow of a frozen page (fault site
        `tier.spill` — a death mid-spill leaves the HBM copy
        authoritative and the shadow simply untaken).  Overflow
        victims the tier's LRU drops are pruned: a tier-1 node
        without bytes is unservable."""
        tier = self.tier
        if tier is None or self._export_page is None or node.bid <= 0:
            return False
        try:
            fault("tier.spill")
            buf, sbuf = self._export_page(node.bid)
        except Exception:
            tier.spill_failures += 1
            return False              # HBM copy stays authoritative
        tier.spills += 1
        for dead in tier.put(node, buf, sbuf):
            self._drop_tiered(dead)
        return True

    def _drop_tiered(self, node) -> None:
        """A node's host shadow was dropped (tier capacity).  An
        HBM-resident node just loses its shadow (re-spilled on the
        next insert touch); a DRAM-resident one is unservable — prune
        its whole subtree (all tier-1 by the suffix invariant)."""
        if node.tier == 0:
            return
        siblings = (node.parent.children if node.parent is not None
                    else self._children)
        siblings.pop(node.toks, None)
        stack = [node]
        while stack:
            n2 = stack.pop()
            if self.tier is not None:
                self.tier.drop(n2)
            if n2.tier:
                self._demoted -= 1
            stack.extend(n2.children.values())
            n2.children = {}

    def _admit_page(self, tenant: int) -> bool:
        """Quota + global-cap gate for one insert.  Over quota, the
        tenant's own least-recent zero-ref tail evicts first; only
        when the tenant has nothing reclaimable is the insert
        skipped (quota_rejects)."""
        quota = self.tenant_quotas.get(tenant, self.default_quota)
        if quota is not None and \
                self._tenant_pages.get(tenant, 0) >= quota:
            if not self._evict_one(tenant=tenant):
                self.stats.quota_rejects += 1
                return False
        if self.max_pages is not None and \
                len(self._by_bid) >= self.max_pages:
            if not self._evict_one():
                return False
        return True

    # -- pool hooks (called by PagedKVCache) --------------------------------

    def retains(self, bid: int) -> bool:
        """True when the tree references `bid` — the pool asks on
        every COW decision (a frozen page must never be appended
        into, even at refcount 1)."""
        return bid in self._by_bid

    def on_zero_ref(self, bid: int) -> bool:
        """The pool's refcount for `bid` just hit zero.  True = the
        tree retains it (keep it OFF the free list; it is now
        evictable), False = not ours, free normally."""
        if bid in self._by_bid:
            self._zero_ref += 1
            return True
        return False

    def on_ref(self, bid: int) -> None:
        """`bid` went 0 -> 1 references (a joiner mapped an evictable
        page): it is pinned again, not reclaimable."""
        if bid in self._by_bid:
            self._zero_ref -= 1

    def reclaim(self, n: int) -> int:
        """Evict up to `n` least-recently-matched zero-ref pages back
        to the pool's free list (leaf-first; evicting a tail exposes
        its parent).  Returns pages actually reclaimed — the pool's
        allocator calls this when its free list runs dry."""
        done = 0
        while done < n and self._evict_one():
            done += 1
        return done

    def _evict_one(self, tenant: int | None = None) -> bool:
        cache = self._cache
        if cache is None:
            return False
        victim = None
        for node in self._by_bid.values():
            if any(c.tier == 0 for c in node.children.values()):
                continue              # leaf-first among HBM residents
                                      # (cascade exposes it; tier-1
                                      # children already gave back
                                      # their pages)
            if cache.refcounts[node.bid] != 0:
                continue              # mapped by a live row
            if tenant is not None and node.tenant != tenant:
                continue
            if victim is None or node.lru < victim.lru:
                victim = node
        if victim is None:
            return False
        tier = self.tier
        if tier is not None and not tier.has(victim):
            # no shadow yet (write-through failed or was LRU-dropped):
            # one more chance to demote instead of drop
            self._spill(victim)
        bid = victim.bid
        if tier is not None and tier.has(victim):
            # DEMOTE: the HBM page returns to the pool, the node
            # survives DRAM-resident — a future hit readmits it with
            # a device_put instead of a re-prefill.  Same path parks
            # paused sessions' prefixes.
            del self._by_bid[bid]
            self._tenant_pages[victim.tenant] = \
                max(0, self._tenant_pages.get(victim.tenant, 0) - 1)
            self._zero_ref -= 1        # victims are zero-ref by test
            cache._free.append(bid)
            victim.bid = -1
            victim.tier = 1
            self._demoted += 1
            tier.demotions += 1
            self.stats.evictions += 1
            return True
        siblings = (victim.parent.children if victim.parent is not None
                    else self._children)
        siblings.pop(victim.toks, None)
        # dropping an interior node strands any tier-1 children it
        # still carried (their shadows become unreachable chains)
        for child in victim.children.values():
            child.parent = None
            self._drop_tiered(child)
        victim.children = {}
        del self._by_bid[bid]
        self._tenant_pages[victim.tenant] = \
            max(0, self._tenant_pages.get(victim.tenant, 0) - 1)
        self._zero_ref -= 1            # victims are zero-ref by test
        cache._free.append(bid)
        self.stats.evictions += 1
        return True

    # -- DRAM tier: readmission + warm restore ------------------------------

    def readmit(self, nodes, cache) -> list[int]:
        """Bring demoted pages back to HBM in path order: alloc +
        device_put + re-registration, no re-prefill (fault site
        `tier.readmit` fires before each page's alloc so the chaos
        drill can die between a DRAM hit and its import — the shadow
        stays intact and the node stays DRAM-resident).  Pages return
        holding refcount 1; the caller transfers that reference into
        the admitted row's block table (decref-then-map_shared, like
        any freshly committed page).  Stops at the first failure —
        the admission simply prefills the remaining suffix."""
        if cache is not self._cache or self.tier is None \
                or self._import_page is None:
            return []
        tier = self.tier
        out: list[int] = []
        for node in nodes:
            if node.tier == 0:
                break                  # raced back already: stale list
            ent = tier.get(node)       # LRU-touches the shadow
            if ent is None:
                break
            try:
                fault("tier.readmit")
                bid = cache._alloc_page()
            except Exception:
                tier.readmit_failures += 1
                break
            try:
                self._import_page(bid, ent[0], ent[1])
            except Exception:
                cache.refcounts[bid] = 0
                cache._free.append(bid)
                tier.readmit_failures += 1
                break
            node.bid = bid
            node.tier = 0
            self._demoted -= 1
            self._by_bid[bid] = node
            self._tenant_pages[node.tenant] = \
                self._tenant_pages.get(node.tenant, 0) + 1
            node.lru = next(self._clock)
            tier.readmits += 1
            out.append(bid)
        return out

    def adopt_tiered(self, ids, tenant: int = 0):
        """Warm-restore adoption: create (or extend) the chain of
        DRAM-resident nodes covering `ids`' full pages and return the
        tail node (None for sub-page chains).  Restored nodes carry
        no HBM page — the first hit readmits them."""
        page = self.page
        n_full = len(ids) // page
        if n_full == 0:
            return None
        cur = self._children
        parent = None
        node = None
        for j in range(n_full):
            chunk = tuple(int(t) for t in ids[j * page:(j + 1) * page])
            node = cur.get(chunk)
            if node is None:
                node = _Node(chunk, -1, parent, tenant)
                node.tier = 1
                self._demoted += 1
                cur[chunk] = node
            parent = node
            cur = node.children
        return node

    # -- gauges -------------------------------------------------------------

    def evictable_count(self) -> int:
        """Zero-ref tree pages: reclaimable capacity the admission
        path may count on top of the free list (a zero-ref node's
        whole subtree is zero-ref — see the module invariants — so
        every one of them is reachable by leaf-first eviction).
        O(1): maintained incrementally on the pool's refcount
        transitions; the churn drill pins it against a brute-force
        recount."""
        return self._zero_ref if self._cache is not None else 0

    def shared_pages(self) -> int:
        return len(self._by_bid)

    def demoted_pages(self) -> int:
        """DRAM-resident (tier 1) node count — the heartbeat's tier
        occupancy gauge, O(1) like evictable_count."""
        return self._demoted

    def tenant_pages(self) -> dict[int, int]:
        return {t: n for t, n in self._tenant_pages.items() if n}
