"""[PyTorch port: a copy of ``repro.serving.prefixindex``, kept here so the port imports
nothing of the JAX package.]

Prefix-cache-aware request homes: a radix index over token prompts.

The serving mapping (scheduler.py header) defines a request's locality domain
as "the pod holding its prefix/KV-cache home" — but production traffic does
not arrive with that label.  This module derives it the way RadixAttention
derives prefix reuse: a radix tree over token sequences records, per cached
prefix, which domains' slot pools last held it, and answers

    home(prompt) -> (domain, matched_len)

by longest-prefix match.  When several domains hold the same longest prefix,
the tie breaks toward the least-occupied one (live per-domain claims from
``PlacementTelemetry.per_domain_occupancy``), so a hot prefix replicated
across pods drains onto the pod with headroom.  A prompt matching nothing
falls back to the least-occupied domain outright — the cold-start rule.

The index is *descriptive*, not prescriptive: it is fed from actual
placements (``DecodeEngine`` records where the slot cache really put each
sequence, at admission and again at retirement), so hot prefixes re-home to
wherever placement spilled them instead of pinning to a stale oracle.  The
``matched_len`` half of the answer is the engine's migration discount: only
the uncached suffix of the KV moves when a slot lands off-home.

Structure: a path-compressed radix tree (token runs live on edges, one split
per divergence point — the sglang/RadixAttention shape), with monotonic
stamps for recency and a capacity bound enforced by pruning the
least-recently-touched leaves.  Pure python, no jax — the smoke benchmark
lane exercises build/lookup/re-home without an accelerator.
"""

from __future__ import annotations

import heapq


def _common_len(edge, tokens, start: int) -> int:
    """Length of the common run between ``edge`` and ``tokens[start:]``."""
    n = min(len(edge), len(tokens) - start)
    k = 0
    while k < n and edge[k] == tokens[start + k]:
        k += 1
    return k


class _Node:
    """One radix node: the token run on its incoming edge, children keyed by
    their edge's first token, and the domains whose pools last held the
    prefix this node spells (domain -> last-touch stamp)."""

    __slots__ = ("edge", "children", "domains", "stamp")

    def __init__(self, edge=()):
        self.edge = tuple(edge)
        self.children: dict[int, _Node] = {}
        self.domains: dict[int, int] = {}
        self.stamp = 0


class PrefixIndex:
    """Radix index mapping token prefixes to their KV-cache home domains.

    ``n_domains`` bounds valid domains and enables the cold-start fallback;
    ``occupancy`` is a zero-arg callable returning a live ``{domain: claims}``
    map (wire it to ``PlacementTelemetry.per_domain_occupancy``); ``capacity``
    caps the node count — LRU leaves are pruned when inserts exceed it.
    """

    def __init__(self, *, n_domains: int | None = None, occupancy=None,
                 capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.n_domains = n_domains
        self.occupancy = occupancy
        self.capacity = capacity
        self.root = _Node()
        self.n_nodes = 0          # excludes the root
        self.records = 0
        self.lookups = 0
        self.hits = 0             # lookups that matched >= 1 token
        self._stamp = 0

    def __len__(self) -> int:
        return self.n_nodes

    @staticmethod
    def _key(tokens) -> tuple[int, ...]:
        return tuple(int(t) for t in tokens)

    def _check_domain(self, domain: int) -> None:
        limit = self.n_domains
        if domain is None or domain < 0 or (limit is not None and domain >= limit):
            raise ValueError(
                f"domain {domain!r} out of range for prefix index "
                f"({'unbounded' if limit is None else f'{limit} domains'})"
            )

    # -- write path ------------------------------------------------------------
    def record(self, tokens, domain: int) -> None:
        """Record that ``domain``'s slot pool now holds (a KV cache covering)
        ``tokens``; every prefix of the sequence is held along with it."""
        self._check_domain(domain)
        tokens = self._key(tokens)
        if not tokens:
            return
        self.records += 1
        self._stamp += 1
        stamp = self._stamp
        node, i = self.root, 0
        while i < len(tokens):
            head = tokens[i]
            child = node.children.get(head)
            if child is None:
                child = _Node(tokens[i:])
                node.children[head] = child
                self.n_nodes += 1
            else:
                k = _common_len(child.edge, tokens, i)
                if k < len(child.edge):
                    # diverged (or ran out) mid-edge: split so the shared run
                    # gets its own node, which inherits the deep side's
                    # holders — a holder of a sequence holds all its prefixes
                    mid = _Node(child.edge[:k])
                    mid.children[child.edge[k]] = child
                    mid.domains = dict(child.domains)
                    mid.stamp = child.stamp
                    child.edge = child.edge[k:]
                    node.children[head] = mid
                    self.n_nodes += 1
                    child = mid
            # the child's edge is now fully consumed (new leaf, full match,
            # or the freshly split shared run), so the path node it spells is
            # a prefix of ``tokens`` — tag it as held by ``domain``
            i += len(child.edge)
            child.domains[domain] = stamp
            child.stamp = stamp
            node = child
        if self.n_nodes > self.capacity:
            self._evict()

    # -- read path -------------------------------------------------------------
    def home(self, tokens) -> tuple[int | None, int]:
        """Longest-prefix match: the domain whose pool holds the longest
        cached prefix of ``tokens`` (ties -> least occupied), plus the number
        of matched tokens.  (fallback domain, 0) on a total miss — the least
        occupied domain when ``n_domains`` is known, else ``None``."""
        tokens = self._key(tokens)
        self.lookups += 1
        node, i = self.root, 0
        best, best_len = None, 0
        path = []
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            k = _common_len(child.edge, tokens, i)
            if k == 0:
                break
            path.append(child)
            if child.domains:
                # a partial edge match still matches: the node's sequence
                # extends the query's matched prefix, so its holders hold it
                best, best_len = child, i + k
            i += k
            if k < len(child.edge):
                break
            node = child
        if best is None:
            return self._fallback(), 0
        self.hits += 1
        self._stamp += 1
        for n in path:  # touch the matched path so hot prefixes survive LRU
            n.stamp = self._stamp
        occ = self.occupancy() if self.occupancy is not None else {}
        domain = min(
            best.domains.items(),
            key=lambda kv: (occ.get(kv[0], 0), -kv[1], kv[0]),
        )[0]
        return domain, min(best_len, len(tokens))

    def holders(self, tokens) -> dict[int, int]:
        """Every domain holding a cached prefix of ``tokens``, with the
        longest held length: ``{domain: matched_len}`` (lengths in tokens,
        domains absent when they hold nothing).  This is the per-holder view
        behind ``home()``'s single answer — the federation reads it to price
        *shipping* a remote holding against re-prefilling (a summary already
        advertises full token runs, so the shippable length per replica is
        exactly the matched run here).  Read-only: no stamps touched, no
        lookup counted — pricing probes must not look like traffic."""
        tokens = self._key(tokens)
        out: dict[int, int] = {}
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            k = _common_len(child.edge, tokens, i)
            if k == 0:
                break
            # as in home(): a partial edge match still matches — the node's
            # sequence extends the query's prefix, so its holders hold it
            for d in child.domains:
                if i + k > out.get(d, 0):
                    out[d] = i + k
            i += k
            if k < len(child.edge):
                break
            node = child
        return out

    def _fallback(self) -> int | None:
        if self.n_domains is None:
            return None
        occ = self.occupancy() if self.occupancy is not None else {}
        return min(range(self.n_domains), key=lambda d: (occ.get(d, 0), d))

    # -- federation export -----------------------------------------------------
    def summary(self, top_k: int = 8) -> list[tuple[tuple[int, ...], int]]:
        """The ``top_k`` hottest cached prefixes as ``(tokens, stamp)`` pairs,
        hottest first — the compact state a fleet/router tier aggregates
        (``repro.router.federation``).  Hotness is last-touch recency; among
        nodes of equal stamp the deeper path wins and subsumed prefixes (a
        path that is a prefix of an already-chosen one) are skipped, so the K
        slots carry K distinct maximal runs rather than one run K times."""
        scored = []
        stack = [(self.root, ())]
        while stack:
            node, path = stack.pop()
            for child in node.children.values():
                cpath = path + child.edge
                scored.append((-child.stamp, -len(cpath), cpath))
                stack.append((child, cpath))
        scored.sort()
        out: list[tuple[tuple[int, ...], int]] = []
        for neg_stamp, _, cpath in scored:
            if any(chosen[: len(cpath)] == cpath for chosen, _ in out):
                continue  # subsumed: a deeper, at-least-as-hot path is in
            ext = next(
                (i for i, (chosen, _) in enumerate(out)
                 if cpath[: len(chosen)] == chosen),
                None,
            )
            if ext is not None:
                # a colder extension of a chosen run: deepen that entry in
                # place (recording the extension covers every prefix of it)
                # rather than spending a second slot on the same run
                out[ext] = (cpath, out[ext][1])
            elif len(out) < top_k:
                out.append((cpath, -neg_stamp))
        return out

    # -- capacity --------------------------------------------------------------
    def _evict(self) -> None:
        """Prune least-recently-touched leaves until 3/4 of capacity.  Rounds
        repeat because pruning exposes new leaves; interior nodes left with a
        single child are not re-merged (the next split is cheap and rare)."""
        target = max(1, self.capacity * 3 // 4)
        while self.n_nodes > target:
            leaves = []
            stack = [self.root]
            while stack:
                node = stack.pop()
                for head, child in node.children.items():
                    if child.children:
                        stack.append(child)
                    else:
                        leaves.append((child.stamp, head, node))
            if not leaves:
                break
            for _, head, parent in heapq.nsmallest(
                self.n_nodes - target, leaves
            ):
                del parent.children[head]
                self.n_nodes -= 1

    def clear(self) -> None:
        self.root = _Node()
        self.n_nodes = 0
