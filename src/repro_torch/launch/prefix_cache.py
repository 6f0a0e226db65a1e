"""Radix prefix index over the shared paged KV pool (prefix sharing) — the
port's own copy of the reference's ``launch/prefix_cache.py`` (numpy only),
with its host-tier demote/promote hooks and the router's read-only
``probe``.

The serve engine's page tables decouple a slot's logical token positions
from physical KV storage; this module adds the cross-request half of that
decoupling: a radix/trie index that keys FULL physical pages by the chain
of page-sized token chunks leading to them, so a new request whose prompt
starts with an already-served prefix maps those logical pages straight
onto the SAME physical pages instead of recomputing them.

Design
------
* One trie node per cached full page. A node's identity is the hash chain
  of token chunks from the root — implemented as nested dicts keyed by the
  exact ``page_size``-token tuple, which is a collision-proof hash chain
  (Python dict hashing on the chunk, scoped per parent). Partial tail
  pages are never indexed: only pages whose every token slot holds prompt
  KV are safe to alias.
* The index OWNS one pool reference per node (``PagePool.share`` at
  insert). A slot mapping a hit takes its own reference, so eviction of an
  index entry can never yank a page out from under a live request — the
  page simply leaves the index and dies when its last slot reference
  drops.
* Eviction is LRU over LEAVES: an interior node is pinned by its
  descendants (evicting it would orphan their hash chains). ``match`` and
  ``insert`` touch every node they traverse, so hot prefixes stay
  resident. ``evict(need)`` frees leaves until ``need`` pages actually
  reached the pool free list (a leaf whose page a live slot still shares
  leaves the index without freeing memory) or the index is empty — the
  engine calls it from watermark admission and decode-OOM before falling
  back to preemption, which is what lets a cache-hot pool degrade
  gracefully to the no-sharing engine instead of thrashing.
* ``max_pages`` caps the index footprint; inserts beyond it evict LRU
  leaves first and simply stop publishing if nothing is evictable.
* With a host tier, eviction DEMOTES a page (``demote_fn`` copies its
  content to host memory before the index's pool ref drops) and a later
  ``match`` that walks off the trie PROMOTES it back (``promote_fn``
  restores it into a fresh pool page, which re-enters the index).

The index is pure host-side bookkeeping — it never touches device memory.
All device effects (table entries, COW page copies) live in the engine.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class _Node:
    chunk: tuple          # the page_size token ids this page holds
    page: int             # physical page id (index holds one pool ref)
    parent: "_Node | None"
    children: dict = dataclasses.field(default_factory=dict)
    last_used: int = 0


class PrefixCache:
    """Trie of published full pages over a ``PagePool``.

    Parameters
    ----------
    pool : the engine's ``PagePool`` (supplies ``page_size`` and holds the
        refcounts backing every cached page).
    max_pages : cap on cached pages; 0 means the pool's allocatable
        capacity (the index can never pin more than the pool holds).
    demote_fn : optional ``(prefix_tokens, page) -> None`` hook, called for
        a node leaving the index under LRU/pressure eviction (NOT on
        ``clear``) BEFORE its pool ref drops — the engine copies the page's
        content to the host tier there. ``prefix_tokens`` is the full token
        prefix the page caches (root chunk chain included).
    promote_fn : optional ``(prefix_tokens) -> int | None`` hook consulted
        when ``match`` walks off the indexed trie: a returned page id is a
        FRESHLY allocated pool page holding the demoted content (rc=1, the
        ref becomes the index's — mirror of ``insert``'s share), and the
        walk re-adopts it as a node and keeps matching. None = genuine miss.
    """

    def __init__(self, pool, max_pages: int = 0, *, demote_fn=None, promote_fn=None):
        self.pool = pool
        self.page_size = pool.page_size
        self.max_pages = max_pages if max_pages > 0 else pool.capacity
        self.demote_fn = demote_fn
        self.promote_fn = promote_fn
        self._root = _Node(chunk=(), page=-1, parent=None)
        self._clock = itertools.count(1)
        self.size = 0  # pages currently indexed
        # cumulative counters (engine resets via reset_stats)
        self.hit_pages = 0
        self.lookups = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------- helpers
    def _chunks(self, tokens) -> Iterator[tuple]:
        toks = np.asarray(tokens).reshape(-1).tolist()
        for i in range(0, len(toks) - self.page_size + 1, self.page_size):
            yield tuple(toks[i : i + self.page_size])

    def _touch(self, node: _Node) -> None:
        node.last_used = next(self._clock)

    def _leaves(self) -> list[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def _prefix_tokens(self, node: _Node) -> tuple:
        """Full token prefix cached by ``node``: the chunk chain from the
        root, flattened — the host-tier key for demoted content."""
        chunks = []
        while node is not self._root:
            chunks.append(node.chunk)
            node = node.parent
        return tuple(t for chunk in reversed(chunks) for t in chunk)

    def _evict_node(self, node: _Node, *, demote: bool = True) -> None:
        assert not node.children, "only leaves are evictable"
        if demote and self.demote_fn is not None:
            self.demote_fn(self._prefix_tokens(node), node.page)
        del node.parent.children[node.chunk]
        self.pool.free([node.page])  # page dies iff no slot still shares it
        self.size -= 1
        self.evicted_pages += 1

    def _evict_lru_leaf(self, protect: set[int]) -> bool:
        victims = [n for n in self._leaves() if id(n) not in protect]
        if not victims:
            return False
        self._evict_node(min(victims, key=lambda n: n.last_used))
        return True

    # ----------------------------------------------------------------- api
    def probe(self, tokens) -> int:
        """Read-only hit prediction: how many leading full pages of
        ``tokens`` are indexed. Unlike ``match`` it touches no LRU clock,
        counts no lookup and takes no page reference, so a router can score
        every replica's cache affinity for a prompt without moving any
        replica's eviction order or hit rate."""
        node, pages = self._root, 0
        for chunk in self._chunks(tokens):
            node = node.children.get(chunk)
            if node is None:
                break
            pages += 1
        return pages

    def match(self, tokens) -> list[int]:
        """Longest indexed prefix of ``tokens`` in full pages: physical
        page ids, in logical order. Touches the matched path (LRU).

        When the walk falls off the trie and a ``promote_fn`` is wired,
        the demoted tier gets one shot per chunk: a promoted page re-enters
        the index as a fresh node (its rc=1 ref becomes the index's) and
        the match keeps extending — LRU-evicting around the CURRENT path
        if the index is at its page cap, never through it."""
        self.lookups += 1
        node, pages = self._root, []
        toks = np.asarray(tokens).reshape(-1).tolist()
        path: set[int] = set()
        for depth, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None and self.promote_fn is not None:
                page = self.promote_fn(tuple(toks[: (depth + 1) * self.page_size]))
                if page is not None:
                    ok = True
                    while self.size >= self.max_pages and ok:
                        ok = self._evict_lru_leaf(path)
                    if not ok:
                        # cap reached and every leaf is on the current
                        # path: drop the restored page (it is a cache)
                        self.pool.free([page])
                    else:
                        child = _Node(chunk=chunk, page=page, parent=node)
                        node.children[chunk] = child
                        self.size += 1
                        self.inserted_pages += 1
            if child is None:
                break
            self._touch(child)
            path.add(id(child))
            pages.append(child.page)
            node = child
        self.hit_pages += len(pages)
        return pages

    def insert(self, tokens, pages: list[int]) -> int:
        """Publish ``tokens``'s full pages (page j holds tokens
        ``[j*page_size, (j+1)*page_size)``) into the index, taking one pool
        reference per NEWLY indexed page. Chunks already indexed keep their
        existing physical page (dedup — the caller's copy dies with the
        caller's refs). Returns the number of pages newly published."""
        node, added, path = self._root, 0, set()
        for chunk, page in zip(self._chunks(tokens), pages):
            child = node.children.get(chunk)
            if child is None:
                while self.size >= self.max_pages:
                    if not self._evict_lru_leaf(path):
                        return added  # index full of pinned/fresh pages
                self.pool.share(page)
                child = _Node(chunk=chunk, page=page, parent=node)
                node.children[chunk] = child
                self.size += 1
                added += 1
                self.inserted_pages += 1
            self._touch(child)
            path.add(id(child))
            node = child
        return added

    def evict(self, need: int) -> int:
        """Evict LRU leaves until ``need`` pages actually returned to the
        pool's free list, or the index is empty. Returns pages freed (an
        evicted page still shared by a live slot frees nothing yet).

        One trie walk total: the leaf set goes into a heap and parents are
        pushed as their last child dies, so a multi-page pressure event
        costs O(N + evicted·log N), not one full walk per page."""
        freed0 = self.pool.available
        heap = [(n.last_used, id(n), n) for n in self._leaves()]
        heapq.heapify(heap)
        while heap and self.pool.available - freed0 < need:
            _, _, node = heap[0]
            heapq.heappop(heap)
            parent = node.parent
            self._evict_node(node)
            if parent is not self._root and not parent.children:
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return self.pool.available - freed0

    def clear(self) -> None:
        """Drop every entry (one pool ref each). Counters survive; the
        engine resets those separately. A reset is not memory pressure, so
        nothing demotes to the host tier."""
        for leaf in self._leaves():
            node = leaf
            while node is not self._root and not node.children:
                parent = node.parent
                self._evict_node(node, demote=False)
                node = parent

    def reset_stats(self) -> None:
        self.hit_pages = 0
        self.lookups = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
