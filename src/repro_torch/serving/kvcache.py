"""Batched KV/recurrent cache slots for continuous batching.

PyTorch counterpart of ``repro.serving.kvcache.SlotCache``.  The engine
owns one cache with a slot (decode-batch) axis, and ``pos`` is (n_slots,).  Each
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

Slot selection is the reference's: without a ``topology`` one heap of free
slots (lowest-first); with one, ``repro_torch.placement`` partitions the
slots into per-domain pools, and ``claim(owner, domain)`` places each request
in (or nearest to) its KV/prefix home domain under the configured policy,
charging distance-aware migration on misses and recording per-domain
telemetry.  The bookkeeping is host-side Python: no decision reads a tensor.
"""

from __future__ import annotations

import heapq

import torch

from repro_torch.placement import DomainFreeLists, PlacementTelemetry, get_policy


def _leaves(tree, is_leaf) -> list:
    """The leaves of nested tuples, in order."""
    if is_leaf(tree):
        return [tree]
    return [leaf for sub in tree for leaf in _leaves(sub, is_leaf)]


def _tensors(cache: dict) -> list:
    """The cache's tensors (every key but ``pos``), in a fixed order."""
    return [t for key in cache if key != "pos"
            for t in _leaves(cache[key], lambda x: isinstance(x, torch.Tensor))]


def leaf_axes(cache: dict, logical: dict) -> list:
    """Per tensor of ``cache``, in ``_tensors`` order: (batch axis, KV
    sequence axis of the lane or None), read from the model's
    ``cache_logical`` tree."""
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
    return axes


def rebuild(leaves: list, like: dict) -> dict:
    """``leaves`` (in ``_tensors`` order) in the tree structure of ``like``,
    without ``pos``."""
    it = iter(leaves)
    return {key: _build(node, it) for key, node in like.items() if key != "pos"}


def _build(node, it):
    # a module-level recursion: a nested one would hold ``it``, and with it
    # the leaves, in a reference cycle until the next garbage collection
    if isinstance(node, torch.Tensor):
        return next(it)
    return tuple(_build(n, it) for n in node)


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

    def __init__(
        self, cache: dict, logical: dict, n_slots: int, *, topology=None,
        policy="nearest_spill", cost_model=None,
    ):
        self.cache = cache
        self.n_slots = n_slots
        self.axes = leaf_axes(cache, logical)
        self.owner: dict[int, object] = {}
        # distance/migration cost of the most recent claim (0 for a home hit
        # or the baseline path); the engine charges stall time from these.
        # ``last_domain`` is where the slot landed (None on the baseline
        # path): the prefix index re-homes hot prefixes from it.
        self.last_distance = 0
        self.last_migration_cycles = 0
        self.last_domain = None
        # CostModel pricing telemetry's migration_cycles (None -> the
        # placement layer's TWO_SOCKET default)
        self.cost_model = cost_model
        if topology is None:
            self.pools = None
            self.policy = None
            self.telemetry = None
            self._free = list(range(n_slots))  # a fresh range is a valid heap
        else:
            self.pools = DomainFreeLists(n_slots, topology)
            self.policy = get_policy(policy)
            self.telemetry = PlacementTelemetry(n_domains=self.pools.topology.n_domains)
            self._free = None

    @property
    def n_free(self) -> int:
        """Free-slot count: the O(1) check for the engine's admit loop."""
        if self.pools is not None:
            return len(self.pools)
        return len(self._free)

    @property
    def free(self) -> list[int]:
        """Free slots, ascending (a copy: mutate through claim/release)."""
        if self.pools is not None:
            return self.pools.free_slots()
        return sorted(self._free)

    @classmethod
    def zeros(
        cls, model, n_slots: int, cache_len: int, *, topology=None,
        policy="nearest_spill", cost_model=None,
    ):
        cache = model.cache_zeros(n_slots, cache_len)
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=model.device)
        return cls(
            cache, model.cache_logical(), n_slots,
            topology=topology, policy=policy, cost_model=cost_model,
        )

    def claim(self, owner, domain: int | None = None) -> int:
        """Claim a free slot for ``owner``.  ``domain`` is the request's
        KV/prefix home; the baseline path ignores it (lowest free slot).
        Under placement the domain is required and range-checked up front,
        so a bad home cannot pass as domain-0 traffic in the telemetry."""
        if self.pools is not None:
            topo = self.pools.topology
            if domain is None:
                raise ValueError(
                    "claim under placement needs the request's KV/prefix home "
                    "domain (got domain=None); derive one (PrefixIndex.home) "
                    "or pass it explicitly"
                )
            if not 0 <= domain < topo.n_domains:
                raise ValueError(
                    f"domain {domain} out of range for topology "
                    f"{topo.name!r} ({topo.n_domains} domains)"
                )
            p = self.policy.place(self.pools, domain, self.cost_model)
            if p is None:
                raise IndexError("claim from an exhausted SlotCache")
            self.telemetry.record_placement(p)
            self.last_distance = p.distance
            self.last_migration_cycles = p.migration_cycles
            self.last_domain = p.slot_domain
            slot = p.slot
        else:
            if not self._free:
                raise IndexError("claim from an exhausted SlotCache")
            slot = heapq.heappop(self._free)
            self.last_distance = 0
            self.last_migration_cycles = 0
            self.last_domain = None
        self.owner[slot] = owner
        return slot

    def release(self, slot: int):
        self.owner.pop(slot, None)
        # a freed slot must not advertise a stale sequence
        self.cache["pos"][slot] = 0
        if self.pools is not None:
            self.telemetry.record_release(self.pools.release(slot))
        else:
            heapq.heappush(self._free, slot)

    @property
    def active(self) -> list[int]:
        return sorted(self.owner)

    def slot_domain(self, slot: int) -> int | None:
        """Home domain of ``slot``'s pool (None on the baseline path)."""
        if self.pools is None:
            return None
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range")
        return self.pools.slot_domain[slot]

    def fit_single(self, single_cache: dict) -> dict:
        """A (batch=1) cache with every KV leaf padded/trimmed to this
        cache's sequence length: new tensors, ``pos`` included, that share
        no storage with ``single_cache`` (what the prefix-KV store keeps)."""
        out = []
        for dst, src, (ax, seq) in zip(_tensors(self.cache), _tensors(single_cache), self.axes):
            shape = list(dst.shape)
            shape[ax] = 1
            t = torch.zeros(shape, dtype=dst.dtype, device=dst.device)
            _fit_into(t.select(ax, 0), src.select(ax, 0), seq)
            out.append(t)
        new = rebuild(out, self.cache)
        new["pos"] = torch.as_tensor(single_cache["pos"]).to(torch.int32, copy=True)
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
        new = rebuild(out, self.cache)
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
