"""Batched KV/recurrent cache slots for continuous batching.

PyTorch counterpart of ``repro.serving.kvcache.SlotCache`` without a
topology (NUMA-homed placement waits for its slice).  The engine owns one
cache with a slot (decode-batch) axis, and ``pos`` is (n_slots,).  Each
leaf's batch axis and kind come from the model's ``cache_logical`` tree, as
in the reference: stacked attention KV (L, B, S, kv, hd), unrolled KV
(B, S, kv, hd), RG-LRU state (L?, B, W), SSD state (L?, B, H, P, N) and
conv tails (L?, B, K-1, C).
Only attention KV is fitted along its sequence axis (trimmed or
zero-padded to this cache's length); state leaves are copied whole.

The logical tree is built from the segment structure, not from leaf ranks:
the reference's rank rules give a stacked (L, B, W) state and a stacked
(L, B, K-1, C) mamba2 conv tail the batch axis 0 (ROADMAP §C).

Where the reference builds new arrays, this one writes the claimed lane IN
PLACE (``copy_``), and ``extract`` returns a copy, so a stashed lane never
aliases the live cache.
"""

from __future__ import annotations

import heapq

import torch


def _leaves(tree, is_leaf) -> list:
    """The leaves of nested tuples, in order."""
    if is_leaf(tree):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub, is_leaf)]


def _tensors(cache: dict) -> list:
    """The cache's tensors (every key but ``pos``), in a fixed order."""
    return [t for key in cache if key != "pos"
            for t in _leaves(cache[key], lambda x: isinstance(x, torch.Tensor))]


def _fit_into(dst: torch.Tensor, src: torch.Tensor, seq_ax: int | None) -> None:
    """Copy lane ``src`` into lane ``dst``.  A KV lane (``seq_ax`` given) is
    trimmed or zero-padded along its sequence axis to the destination's
    length; a state lane must match."""
    if seq_ax is None:
        dst.copy_(src)
        return
    n = min(src.shape[seq_ax], dst.shape[seq_ax])
    dst.narrow(seq_ax, 0, n).copy_(src.narrow(seq_ax, 0, n))
    dst.narrow(seq_ax, n, dst.shape[seq_ax] - n).zero_()


class SlotCache:
    """Cache tensors + slot bookkeeping."""

    def __init__(self, cache: dict, logical: dict, n_slots: int):
        self.cache = cache
        self.n_slots = n_slots
        # per leaf, in _tensors order: (batch axis, KV sequence axis of the
        # lane or None)
        axes = []
        for key in cache:
            if key == "pos":
                continue
            for log in _leaves(logical[key], lambda x: isinstance(x[0], (str, type(None)))):
                ax = log.index("batch")
                seq = log.index("kv_seq") if "kv_seq" in log else None
                axes.append((ax, None if seq is None else seq - (seq > ax)))
        if len(axes) != len(_tensors(cache)):
            raise ValueError("cache_logical does not mirror the cache")
        self.axes = axes
        self.owner: dict[int, object] = {}
        # placement is not ported: every claim is local (the engine charges
        # migration stalls from this, as it does in the reference)
        self.last_distance = 0
        self._free = list(range(n_slots))  # a fresh range is a valid heap

    @property
    def n_free(self) -> int:
        return len(self._free)

    @classmethod
    def zeros(cls, model, n_slots: int, cache_len: int):
        cache = model.cache_zeros(n_slots, cache_len)
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=model.device)
        return cls(cache, model.cache_logical(), n_slots)

    def claim(self, owner, domain: int | None = None) -> int:
        """Claim the lowest free slot for ``owner`` (``domain`` is ignored
        without placement, as on the reference's baseline path)."""
        if not self._free:
            raise IndexError("claim from an exhausted SlotCache")
        slot = heapq.heappop(self._free)
        self.owner[slot] = owner
        return slot

    def release(self, slot: int):
        self.owner.pop(slot, None)
        # a freed slot must not advertise a stale sequence
        self.cache["pos"][slot] = 0
        heapq.heappush(self._free, slot)

    def _rebuild(self, leaves: list, like: dict) -> dict:
        """``leaves`` (in _tensors order) in the tree structure of ``like``."""
        it = iter(leaves)

        def build(node):
            if isinstance(node, torch.Tensor):
                return next(it)
            return tuple(build(n) for n in node)

        return {key: build(node) for key, node in like.items() if key != "pos"}

    def fit_single(self, single_cache: dict) -> dict:
        """A (batch=1) cache with every KV leaf padded/trimmed to this
        cache's sequence length."""
        out = []
        for dst, src, (ax, seq) in zip(_tensors(self.cache), _tensors(single_cache), self.axes):
            shape = list(dst.shape)
            shape[ax] = 1
            t = torch.zeros(shape, dtype=dst.dtype, device=dst.device)
            _fit_into(t.select(ax, 0), src.select(ax, 0), seq)
            out.append(t)
        new = self._rebuild(out, self.cache)
        new["pos"] = torch.as_tensor(single_cache["pos"]).to(torch.int32)
        return new

    def extract(self, slot: int) -> dict:
        """A copy of ``slot``'s lane as a standalone (batch=1) cache, ``pos``
        as the scalar the model's prefill emits."""
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        if slot not in self.owner:
            raise ValueError(
                f"extract from unowned slot {slot}: claim/insert it first "
                "(released slots hold stale or zero KV)"
            )
        out = [t.narrow(ax, slot, 1).clone() for t, (ax, _) in zip(_tensors(self.cache), self.axes)]
        new = self._rebuild(out, self.cache)
        new["pos"] = self.cache["pos"][slot].clone()
        return new

    def insert_row(self, slot: int, batched_cache: dict, row: int):
        """Copy lane ``row`` of a batched cache (a packed prefill's output)
        into ``slot``, in place, KV fitted to this cache's length."""
        for dst, src, (ax, seq) in zip(_tensors(self.cache), _tensors(batched_cache), self.axes):
            _fit_into(dst.select(ax, slot), src.select(ax, row), seq)
        self.cache["pos"][slot] = torch.as_tensor(batched_cache["pos"])[row].to(torch.int32)

    def insert(self, slot: int, single_cache: dict):
        """Insert a (batch=1) prefill cache into ``slot``."""
        for dst, src, (ax, seq) in zip(_tensors(self.cache), _tensors(single_cache), self.axes):
            _fit_into(dst.select(ax, slot), src.select(ax, 0), seq)
        self.cache["pos"][slot] = torch.as_tensor(single_cache["pos"]).to(torch.int32)
