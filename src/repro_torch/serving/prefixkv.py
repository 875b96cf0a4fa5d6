"""[PyTorch port: a copy of ``repro.serving.prefixkv``, kept here so the port imports
nothing of the JAX package.  Only this docstring differs.]

Prefix-KV reuse: an LRU store of prefilled (batch=1) caches by prompt.

After each admission the engine deposits the prompt's prefilled cache here,
and a later prompt that *extends* a stored prefix resumes from the stored
cache: the KV write position is seeded past the cached run and only the
uncached suffix is computed (``prefill_cont`` on the packed path, one
``decode_step`` per suffix token on the per-request path).
``DecodeEngine.prefill_positions`` counts exactly how many positions were
computed, so tests and benchmarks can pin the savings.

Entries are tensors the store owns.  The reference keeps references to
immutable jax arrays; the port's caches are written in place
(``DecoderLM.decode_step`` and ``_merge_kv`` write the cache they are
handed, ``SlotCache`` copies into its live lanes), so an entry that shared
storage with a live cache would change under the store.  The engine
deposits only fresh tensors (``SlotCache.fit_single`` and ``extract``
return copies) and steps a clone of an entry when it resumes one; the
store itself copies nothing.

Keys are exact token prefixes: an entry is only usable when its key equals
``prompt[:len(key)]`` (the cache encodes those tokens and nothing else), so
lookup is longest-stored-prefix, not longest-common-run.  Entries are LRU
over a bounded count, and each holds a full per-request cache, so the bound
is the memory knob.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any


class PrefixKVStore:
    """LRU ``token-prefix -> (cache, logits)`` store for prefill reuse."""

    def __init__(self, capacity: int = 16, *, min_plant: int = 4) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        # shortest common run worth planting a boundary entry for (shorter
        # runs are chance collisions: the split prefill would cost a jit
        # trace to save almost nothing)
        self.min_plant = min_plant
        self._lru: "OrderedDict[tuple[int, ...], tuple[Any, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.reused_tokens = 0

    @staticmethod
    def _key(tokens) -> tuple[int, ...]:
        return tuple(int(t) for t in tokens)

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, tokens) -> bool:
        return self._key(tokens) in self._lru

    def put(self, tokens, cache, logits) -> None:
        """Deposit the prefilled cache (+ next-token logits) for ``tokens``.
        Re-putting an existing key refreshes it (and its recency)."""
        key = self._key(tokens)
        if not key:
            return
        self._lru.pop(key, None)
        self._lru[key] = (cache, logits)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    def longest(self, tokens) -> tuple[int, Any, Any] | None:
        """Longest stored key that is an exact prefix of ``tokens`` ->
        ``(matched_len, cache, logits)``, or None.  The hit is touched so hot
        prefixes survive the LRU."""
        key = self._key(tokens)
        best = None
        for stored in self._lru:
            if len(stored) <= len(key) and stored == key[: len(stored)]:
                if best is None or len(stored) > len(best):
                    best = stored
        if best is None:
            self.misses += 1
            return None
        self.hits += 1
        self.reused_tokens += len(best)
        self._lru.move_to_end(best)
        cache, logits = self._lru[best]
        return len(best), cache, logits

    def peek(self, tokens) -> int:
        """Length (in tokens) of the longest stored key that exactly prefixes
        ``tokens`` — ``longest`` without the side effects: no hit/miss
        counting, no LRU touch.  The router prices ship/re-prefill decisions
        from this, and a price probe must not look like traffic."""
        key = self._key(tokens)
        best = 0
        for stored in self._lru:
            if len(stored) > best and len(stored) <= len(key) and stored == key[: len(stored)]:
                best = len(stored)
        return best

    def get(self, tokens) -> tuple[Any, Any] | None:
        """The ``(cache, logits)`` bundle stored under exactly ``tokens``,
        or None.  Touches recency (an export for shipping is a real use —
        the prefix is hot somewhere) but not the hit/miss counters, which
        count prefill-path lookups only."""
        key = self._key(tokens)
        if key not in self._lru:
            return None
        self._lru.move_to_end(key)
        return self._lru[key]

    def common_run(self, tokens) -> int:
        """Longest common token run between ``tokens`` and any stored key —
        the boundary-planting hint when no stored key is an exact prefix
        (shared-system-prompt traffic: stored ``P+s1`` vs incoming ``P+s2``
        share the run ``P`` but neither prefixes the other)."""
        key = self._key(tokens)
        best = 0
        for stored in self._lru:
            n = min(len(stored), len(key))
            k = 0
            while k < n and stored[k] == key[k]:
                k += 1
            best = max(best, k)
        return best

    def clear(self) -> None:
        self._lru.clear()
