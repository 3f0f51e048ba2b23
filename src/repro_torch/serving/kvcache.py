"""Paged KV-cache manager: refcounted block tables with copy-on-write
sharing, a hash-chain prefix index, and preemption swap.

TPU adaptation of PagedAttention bookkeeping: 128-token pages (lane-aligned;
GPU vLLM uses 16).  The manager is used (a) by the serving engine to model
KV memory pressure and preemption swap cost, and (b) by the JaxBackend /
Pallas paged-attention kernel for real block tables.

Shared-prefix reuse (DESIGN.md §6): blocks carry refcounts so many
sequences can reference one page.  Finished sequences *register* their
pages under a chain hash of the token content (one hash per full page,
plus at most one partial-tail entry per chain); released-but-registered
blocks are not recycled — they wait in LRU order as *reclaimable* cache
until pool pressure reclaims them.  A new sequence looks up the longest
cached prefix of its prompt (`match`), attaches the hit pages with
`adopt`, and copy-on-write forks any shared page before appending into it
(`fork_for_append`), so sharers and future cache hits never observe a
mutation."""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

BLOCK_TOKENS = 128

# Default per-token KV footprint (llama-8b preset: 32 layers × 8 KV heads ×
# 128 head_dim × 2 (K+V) × 2 B).  Shared with the scheduler's EngineView so
# the preemption cost model and the BlockManager can never silently
# disagree about block geometry.
KV_BYTES_PER_TOKEN = 131072


def block_bytes(kv_bytes_per_token: float = KV_BYTES_PER_TOKEN,
                block_tokens: int = BLOCK_TOKENS) -> int:
    """Bytes of KV per page — the one place block geometry is derived."""
    return int(kv_bytes_per_token * block_tokens)


# ---------------------------------------------------------------------------
# Prefix identity: position-anchored chain hashes over token content.
# h_i covers pages 0..i, so equal hashes ⇒ equal prefix ⇒ equal KV (K/V at
# position p depends on the whole prefix ≤ p, not just the token at p).
# ---------------------------------------------------------------------------
_ROOT_HASH = 0x9E3779B97F4A7C15


def chain_hash(prev: int, tokens) -> int:
    """Extend chain `prev` by a token segment (deterministic across runs,
    unlike Python's salted hash())."""
    h = hashlib.blake2b(prev.to_bytes(8, "little")
                        + np.asarray(tokens, np.int64).tobytes(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little")


def page_hash_chain(tokens, page: int) -> List[int]:
    """Chain hash per FULL page of `tokens` (the partial tail is hashed
    separately by register/match)."""
    toks = np.asarray(tokens, np.int64)
    out: List[int] = []
    h = _ROOT_HASH
    for i in range(len(toks) // page):
        h = chain_hash(h, toks[i * page:(i + 1) * page])
        out.append(h)
    return out


@dataclasses.dataclass
class SeqAlloc:
    blocks: List[int]
    tokens: int = 0
    swapped: bool = False
    cached_tokens: int = 0        # prefix attached from cache at adopt time


class BlockManager:
    """``num_blocks``/``kv_bytes_per_token`` describe the replica's
    MESH-WIDE aggregate pool: under serving tensor parallelism (DESIGN.md
    §8) each device holds a KV-head slice of every page, so per-token
    bytes stay the full-model figure while the page count scales with the
    mesh.  ``tp`` here is the PAGE-split factor (the backend's
    ``kv_shard_degree``) — 1 under the replicated-KV fallback even on a
    wider mesh — so ``device_bytes_per_block`` stays honest."""

    def __init__(self, num_blocks: int, block_tokens: int = BLOCK_TOKENS,
                 kv_bytes_per_token: float = KV_BYTES_PER_TOKEN,
                 tp: int = 1):
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self.kv_bytes_per_token = kv_bytes_per_token
        self.tp = max(int(tp), 1)
        self.free: List[int] = list(range(num_blocks))
        self.refcnt: List[int] = [0] * num_blocks
        self.seqs: Dict[int, SeqAlloc] = {}
        self.swapped_tokens = 0
        self.peak_used = 0
        # prefix index: full-page chain hash -> block; one partial-tail
        # entry per chain prefix (prev hash -> (ntoks, segment hash, block))
        self._index: Dict[int, int] = {}
        self._tail: Dict[int, Tuple[int, int, int]] = {}
        self._keys: Dict[int, Tuple[str, int]] = {}   # block -> its entry
        # released-but-registered blocks, oldest first — the reclaim order
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.reclaimed_blocks = 0

    # ------------------------------------------------------------------
    @property
    def used_blocks(self) -> int:
        """Blocks referenced by live sequences (cold cache excluded)."""
        return self.num_blocks - len(self.free) - len(self._lru)

    @property
    def reclaimable_blocks(self) -> int:
        """Unreferenced cached blocks — free the moment pressure demands."""
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation can obtain: free + reclaimable cold cache.
        The ONE definition of KV headroom — the engine's preemption cost
        model and the cluster's least-kv pressure signal both derive from
        it, so cold cache never reads as phantom pressure anywhere."""
        return len(self.free) + len(self._lru)

    @property
    def available_frac(self) -> float:
        return self.available_blocks / max(self.num_blocks, 1)

    def free_tokens(self) -> int:
        return self.available_blocks * self.block_tokens

    def device_bytes_per_block(self) -> float:
        """Per-DEVICE bytes one page occupies (the aggregate split over
        the tp-way mesh; equals the full page at tp=1)."""
        return self.kv_bytes_per_token * self.block_tokens / self.tp

    def can_fit(self, tokens: int) -> bool:
        need = -(-tokens // self.block_tokens)
        return need <= self.available_blocks

    # ------------------------------------------------------------------
    def _alloc(self) -> Optional[int]:
        """One private block: free list first, then reclaim the coldest
        cached block (its index entry dies with it)."""
        if self.free:
            b = self.free.pop()
        elif self._lru:
            b, _ = self._lru.popitem(last=False)
            self._drop_key(b)
            self.reclaimed_blocks += 1
        else:
            return None
        self.refcnt[b] = 1
        self.peak_used = max(self.peak_used, self.used_blocks)
        return b

    def _drop_key(self, b: int) -> None:
        key = self._keys.pop(b, None)
        if key is None:
            return
        kind, h = key
        if kind == "full":
            if self._index.get(h) == b:
                del self._index[h]
        elif self._tail.get(h, (0, 0, -1))[2] == b:
            del self._tail[h]

    def _incref(self, b: int) -> None:
        if self.refcnt[b] == 0:
            self._lru.pop(b, None)        # resurrect from cold cache
        self.refcnt[b] += 1

    def _decref(self, b: int) -> None:
        self.refcnt[b] -= 1
        assert self.refcnt[b] >= 0, f"double free of block {b}"
        if self.refcnt[b] == 0:
            if b in self._keys:
                self._lru[b] = None       # cold cache, youngest at the end
                self._lru.move_to_end(b)
            else:
                self.free.append(b)

    # ------------------------------------------------------------------
    def ensure(self, rid: int, tokens: int) -> bool:
        """Grow rid's allocation to cover `tokens`; False if OOM.  A failed
        first allocation must NOT leave an empty SeqAlloc behind — phantom
        zero-token holders would look like eviction victims whose swap-out
        frees nothing."""
        a = self.seqs.get(rid)
        if a is None:
            a = SeqAlloc(blocks=[])
        need = -(-tokens // self.block_tokens) - len(a.blocks)
        if need > len(self.free) + len(self._lru):
            return False
        self.seqs[rid] = a
        for _ in range(max(need, 0)):
            a.blocks.append(self._alloc())
        a.tokens = max(a.tokens, tokens)
        a.swapped = False
        return True

    def release(self, rid: int):
        a = self.seqs.pop(rid, None)
        if a is None:
            return
        if a.swapped:
            # a swapped-out sequence can be released (e.g. a preempted
            # request shed by the scheduler): its host copy is dropped,
            # so the swapped-footprint counter must come back down
            self.swapped_tokens -= a.tokens
            return
        for b in a.blocks:
            self._decref(b)

    # ------------------------------------------------------------------
    # Prefix cache: match / adopt / register / COW fork
    # ------------------------------------------------------------------
    def match(self, tokens, max_tokens: Optional[int] = None
              ) -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens`: full pages down the chain
        index, then at most one partial tail.  Returns (blocks,
        cached_tokens) with cached_tokens capped at `max_tokens` (callers
        cap at prompt_len-1 so every request computes ≥1 suffix token and
        the write lands behind a COW fork, never in a shared page).  Takes
        no references — pair with adopt()."""
        toks = np.asarray(tokens, np.int64)
        P = self.block_tokens
        cap = len(toks) if max_tokens is None else min(len(toks), max_tokens)
        if cap <= 0:
            return [], 0
        blocks: List[int] = []
        h, n = _ROOT_HASH, 0
        for i in range(len(toks) // P):
            h2 = chain_hash(h, toks[i * P:(i + 1) * P])
            b = self._index.get(h2)
            if b is None:
                break
            blocks.append(b)
            h, n = h2, (i + 1) * P
            if n >= cap:
                break
        if n < cap:
            e = self._tail.get(h)
            if e is not None:
                ntoks, seg_h, b = e
                if n + ntoks <= len(toks) and \
                        seg_h == chain_hash(h, toks[n:n + ntoks]):
                    blocks.append(b)
                    n += ntoks
        return blocks, min(n, cap)

    def adopt(self, rid: int, blocks, tokens: int) -> bool:
        """Attach pages to a fresh sequence.  Two forms:

        * ``blocks`` is a list — a matched cached prefix: incref every
          block (resurrecting cold ones out of the LRU); ``tokens`` is the
          cached length, credited as ``cached_tokens``.
        * ``blocks`` is an int ``n_pages`` — live KV migration (DESIGN.md
          §12): materialize that many FRESH private pages for a
          migrated-in sequence of ``tokens`` context.  ``cached_tokens``
          stays 0 — the content was computed on another replica, not
          served from this pool's cache — so destination accounting never
          claims prefix-cache credit for migrated work.  Returns False
          (allocating nothing) when the pool can't supply the pages.
        """
        assert rid not in self.seqs, f"r{rid} already allocated"
        if isinstance(blocks, (int, np.integer)):
            n_pages = int(blocks)
            assert n_pages >= -(-tokens // self.block_tokens), \
                f"{n_pages} pages cannot hold {tokens} tokens"
            if n_pages > self.available_blocks:
                return False
            bs = [self._alloc() for _ in range(n_pages)]
            self.seqs[rid] = SeqAlloc(blocks=bs, tokens=tokens)
            self.peak_used = max(self.peak_used, self.used_blocks)
            return True
        for b in blocks:
            self._incref(b)
        self.seqs[rid] = SeqAlloc(blocks=list(blocks), tokens=tokens,
                                  cached_tokens=tokens)
        self.peak_used = max(self.peak_used, self.used_blocks)
        return True

    def park_swapped(self, rid: int, tokens: int) -> None:
        """Register a sequence whose KV lives host-side only — a migration
        that landed under pool pressure (DESIGN.md §12).  Zero device
        pages, ``swapped=True``: the ordinary swap-in path (``ensure`` +
        ``Backend.kv_swap_in``) restores it once blocks free up, exactly
        like a preempted-and-swapped local request."""
        assert rid not in self.seqs, f"r{rid} already allocated"
        self.seqs[rid] = SeqAlloc(blocks=[], tokens=tokens, swapped=True)
        self.swapped_tokens += tokens

    def fork_for_append(self, rid: int, pos: int
                        ) -> Optional[Tuple[int, int]]:
        """Make the page holding `pos` privately writable before tokens are
        appended there.  Returns (old, new) when the caller must copy page
        contents old→new, (b, b) when the page is already private, None on
        OOM.  Registered pages are immutable even when sole-owned: forking
        them keeps the index entry alive for future matchers (the freed
        original returns to the cold cache, not the free list)."""
        a = self.seqs[rid]
        i = pos // self.block_tokens
        if i >= len(a.blocks):            # fresh page — ensure() allocates
            return (-1, -1)
        b = a.blocks[i]
        if self.refcnt[b] == 1 and b not in self._keys:
            return (b, b)
        nb = self._alloc()
        if nb is None:
            return None
        a.blocks[i] = nb
        self._decref(b)
        return (b, nb)

    def register(self, rid: int, tokens, boundaries=()) -> int:
        """Publish rid's pages into the prefix index before release: one
        full-page entry per chain hash (first writer wins), plus partial
        tails (latest writer wins) at the end of `tokens` AND at each
        extra boundary in `boundaries`.  The engine passes the prompt
        boundary there: on a real backend the generated continuation is
        unknowable to future prompts, so the prompt-depth tail is the one
        a follower can actually match.  `tokens` must be exactly the
        content whose KV the pages hold — callers pass prompt+output minus
        the final sampled token, whose KV slot is never written.  Returns
        the number of entries added."""
        a = self.seqs.get(rid)
        if a is None or a.swapped:
            return 0
        toks = np.asarray(tokens, np.int64)
        P = self.block_tokens
        n = min(len(toks), a.tokens, len(a.blocks) * P)
        added = 0
        hs = [_ROOT_HASH]                 # hs[i] = chain after i full pages
        for i in range(n // P):
            h2 = chain_hash(hs[-1], toks[i * P:(i + 1) * P])
            b = a.blocks[i]
            if h2 not in self._index and b not in self._keys:
                self._index[h2] = b
                self._keys[b] = ("full", h2)
                added += 1
            hs.append(h2)
        # shallower boundaries first: when two boundaries land in ONE
        # block, the earlier (prompt) tail wins the block's single entry
        for bt in sorted({min(int(b), n) for b in (*boundaries, n)}):
            rem = bt % P
            i = bt // P
            if rem == 0 or i >= len(a.blocks):
                continue
            b = a.blocks[i]
            if b in self._keys:
                continue
            h = hs[i]
            old = self._tail.get(h)
            if old is not None:
                ob = old[2]
                self._keys.pop(ob, None)
                if self.refcnt[ob] == 0 and ob in self._lru:
                    del self._lru[ob]
                    self.free.append(ob)
            self._tail[h] = (rem, chain_hash(h, toks[i * P:bt]), b)
            self._keys[b] = ("tail", h)
            added += 1
        return added

    # ------------------------------------------------------------------
    def swap_out(self, rid: int) -> float:
        """Preemption: move rid's blocks to host; returns bytes moved.
        Shared pages stay device-resident for their other referents (and
        the cache) — only this sequence's references are dropped; swap-in
        restores the whole context into private pages."""
        a = self.seqs.get(rid)
        if a is None or a.swapped:
            return 0.0
        for b in a.blocks:
            self._decref(b)
        a.blocks = []
        a.swapped = True
        a.cached_tokens = 0
        self.swapped_tokens += a.tokens
        return a.tokens * self.kv_bytes_per_token

    def swap_in(self, rid: int) -> Optional[float]:
        a = self.seqs.get(rid)
        if a is None or not a.swapped:
            return 0.0
        if not self.ensure(rid, a.tokens):
            return None
        self.swapped_tokens -= a.tokens
        return a.tokens * self.kv_bytes_per_token

    def truncate(self, rid: int, tokens: int) -> int:
        """Shrink rid's allocation to cover exactly `tokens` — the
        speculative-decoding rejection path (DESIGN.md §11): drafted
        positions past the accepted prefix wrote KV into pages the window
        over-allocated; whole pages past ceil(tokens/page) are just COW
        reference drops (shared pages stay alive for their other
        referents, registered pages fall back to the cold cache).  Stale
        entries *inside* the kept tail page need no cleanup: the causal
        context mask hides them and the next accepted tokens overwrite
        them.  Returns the number of dropped page references."""
        a = self.seqs.get(rid)
        if a is None or a.swapped:
            return 0
        keep = -(-tokens // self.block_tokens)
        dropped = 0
        while len(a.blocks) > keep:
            self._decref(a.blocks.pop())
            dropped += 1
        a.tokens = min(a.tokens, tokens)
        a.cached_tokens = min(a.cached_tokens, a.tokens)
        return dropped

    def block_table(self, rid: int) -> List[int]:
        a = self.seqs.get(rid)
        return list(a.blocks) if a else []

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Refcount/ownership invariants (exercised by the property test):
        every block is exactly one of free / referenced / cold-cached,
        refcounts equal table occurrences, and no referenced or cached
        block sits in the free list (no double-free, shared pages never
        recycled while referenced)."""
        ref: Dict[int, int] = {}
        for a in self.seqs.values():
            if not a.swapped:
                for b in a.blocks:
                    ref[b] = ref.get(b, 0) + 1
        for b in range(self.num_blocks):
            assert self.refcnt[b] == ref.get(b, 0), \
                f"block {b}: refcnt {self.refcnt[b]} != {ref.get(b, 0)} refs"
        free_set, lru_set = set(self.free), set(self._lru)
        held = {b for b, c in ref.items() if c > 0}
        assert len(free_set) == len(self.free), "duplicate in free list"
        assert not free_set & lru_set, "block both free and cached"
        assert not (free_set | lru_set) & held, \
            "referenced block in free/cache"
        assert len(free_set) + len(lru_set) + len(held) == self.num_blocks
        for b in free_set:
            assert b not in self._keys, f"free block {b} still indexed"
        for b in lru_set:
            assert b in self._keys, f"cached block {b} has no index entry"
        for h, b in self._index.items():
            assert self._keys.get(b) == ("full", h)
        for h, (_, _, b) in self._tail.items():
            assert self._keys.get(b) == ("tail", h)
