"""Batched KV cache slots for continuous batching.

PyTorch counterpart of ``repro.serving.kvcache.SlotCache`` without a
topology (NUMA-homed placement waits for its slice).  The engine owns one
cache with a slot (decode-batch) axis: KV leaves are (L, n_slots, S, Hkv, hd)
with the slot on axis 1, and ``pos`` is (n_slots,).  Where the reference
builds new arrays, this one writes the claimed lane IN PLACE (``copy_``),
and ``extract`` returns a copy, so a stashed lane never aliases the live
cache.
"""

from __future__ import annotations

import heapq

import torch

def _kv_leaves(cache: dict):
    """The KV tensors of a cache, in a fixed order (every key but ``pos``)."""
    return [t for key in cache if key != "pos" for kv in cache[key] for t in kv]


def _map_kv(fn, *caches) -> dict:
    """Apply ``fn`` leaf by leaf over the KV tuples of ``caches``."""
    first = caches[0]
    return {
        key: tuple(tuple(fn(*ts) for ts in zip(*kvs)) for kvs in zip(*(c[key] for c in caches)))
        for key in first if key != "pos"
    }


def _fit_into(dst_lane: torch.Tensor, src_lane: torch.Tensor) -> None:
    """Copy ``src_lane`` into ``dst_lane`` (both (L, S, kv, hd)), trimming
    or zero-padding the sequence axis to the destination's length."""
    n = min(src_lane.shape[1], dst_lane.shape[1])
    dst_lane[:, :n].copy_(src_lane[:, :n])
    dst_lane[:, n:].zero_()


class SlotCache:
    """Cache tensors + slot bookkeeping."""

    def __init__(self, cache: dict, n_slots: int):
        self.cache = cache
        self.n_slots = n_slots
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
        return cls(cache, n_slots)

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

    def fit_single(self, single_cache: dict) -> dict:
        """A (batch=1) cache padded/trimmed to this cache's sequence length."""
        def fit(dst, src):
            out = torch.zeros((dst.shape[0], 1) + tuple(dst.shape[2:]), dtype=dst.dtype, device=dst.device)
            _fit_into(out[:, 0], src[:, 0])
            return out

        new = _map_kv(fit, self.cache, single_cache)
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
        new = _map_kv(lambda t: t[:, slot : slot + 1].clone(), self.cache)
        new["pos"] = self.cache["pos"][slot].clone()
        return new

    def insert_row(self, slot: int, batched_cache: dict, row: int):
        """Copy lane ``row`` of a batched cache (a packed prefill's output)
        into ``slot``, in place, fitted to this cache's length."""
        for dst, src in zip(_kv_leaves(self.cache), _kv_leaves(batched_cache)):
            _fit_into(dst[:, slot], src[:, row])
        self.cache["pos"][slot] = torch.as_tensor(batched_cache["pos"])[row].to(torch.int32)

    def insert(self, slot: int, single_cache: dict):
        """Insert a (batch=1) prefill cache into ``slot``."""
        for dst, src in zip(_kv_leaves(self.cache), _kv_leaves(single_cache)):
            _fit_into(dst[:, slot], src[:, 0])
        self.cache["pos"][slot] = torch.as_tensor(single_cache["pos"]).to(torch.int32)
