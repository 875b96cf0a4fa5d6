"""Continuous-batching decode engine.

PyTorch counterpart of ``repro.serving.engine``: one ``decode_step`` per
tick advances every slot (per-slot positions); admission order between
waiting requests is the scheduler's (CNA or FIFO).  With ``batching=True``
admission goes through the bucketed, packed prefill layer: at most one
packed prefill call per ``step()``, interleaved with running decode.

Same units, counters and span names as the reference (``sim_time`` in
scheduler ticks, ``prefill_positions`` and ``reused_positions`` in KV
positions).  The per-request path (``batching=False``) serves every ported
family, the hybrid RG-LRU and SSM ones included; the packed path refuses
what the model's ``supports_packed_prefill`` refuses, with ``ValueError``.

``prefix_kv`` (``True`` or a ``PrefixKVStore``) resumes prefill from
stored caches on both paths, deposits retiring conversations back, and
exports and imports stored prefixes (``export_kv`` / ``import_kv`` /
``peek_match``).  The port's caches are written in place, so every entry
the store holds is a tensor no live path writes: deposits go through
``SlotCache.fit_single`` or ``extract`` (copies), the continuation pack
stacks copies, and the per-request resume loop steps a clone of the entry.

``placement`` makes the slot cache NUMA-homed over the scheduler's topology
(``repro_torch.placement``), and ``prefix_index`` derives ``domain=None``
homes from cached prefixes, discounts the migration charge by the matched
run and sheds saturated homes through an adaptive controller, as in the
reference.  All of it is host-side bookkeeping over Python ints and token
lists: ``sim_time`` and the telemetry never read a tensor.  Paging is not
ported and raises ``NotImplementedError``.

Greedy sampling (argmax) keeps the engine deterministic for tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .batching import CountingCall, PrefillBatcher
from .kvcache import SlotCache
from .prefixindex import PrefixIndex
from .prefixkv import PrefixKVStore
from .scheduler import CNAScheduler


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    domain: int | None = 0
    out: list = field(default_factory=list)
    submit_t: int = 0
    admit_t: int = -1             # scheduler tick the request won a slot
    finish_t: int = -1
    matched_len: int = 0

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class DecodeEngine:
    """Continuous-batching decode engine over a CNA-disciplined scheduler.

    ``model`` is a ``repro_torch`` model; the engine runs on its device.
    ``prefill_positions`` / ``reused_positions`` count KV positions computed
    / resumed from stored caches, ``kv_deposits`` the retirement-time
    deposits made back into the store.  ``placement`` (a policy name or
    instance) needs a topology on the scheduler; ``prefix_index`` (``True``
    or a ``PrefixIndex``) needs placement."""

    def __init__(
        self,
        model,
        params,
        *,
        n_slots: int = 4,
        cache_len: int = 256,
        scheduler=None,
        eos: int | None = None,
        domain_switch_cost: int = 4,
        topology=None,
        placement=None,
        slot_migration_cost: int = 2,
        prefix_index=None,
        prefix_kv=None,
        batching: bool = False,
        pack_width: int | None = None,
        tracer=None,  # repro_torch.obs.Tracer | None (None => zero-cost off)
        paging: bool = False,
    ):
        if paging:
            raise NotImplementedError("paging is not ported to the PyTorch engine yet")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.cache_len = cache_len
        # NB: schedulers define __len__, so `scheduler or default` would
        # silently replace an *empty* scheduler — compare to None explicitly.
        if scheduler is not None and topology is not None:
            raise ValueError(
                "pass topology via the scheduler (e.g. CNAScheduler(topology=...)); "
                "an explicit scheduler's topology would silently win otherwise"
            )
        self.scheduler = scheduler if scheduler is not None else CNAScheduler(topology=topology)
        if tracer is not None:
            self.scheduler.tracer = tracer
        self.tracer = self.scheduler.tracer
        self.eos = eos
        if placement is not None and self.scheduler.topology is None:
            raise ValueError("placement needs a topology (e.g. CNAScheduler(topology=...))")
        self.slots = SlotCache.zeros(
            model, n_slots, cache_len,
            topology=self.scheduler.topology if placement is not None else None,
            policy=placement if placement is not None else "nearest_spill",
        )
        if self.slots.telemetry is not None:
            self.scheduler.metrics.placement = self.slots.telemetry
        # the index learns from where the slot cache actually puts each
        # prefix, so it needs placement
        if prefix_index is True:
            prefix_index = PrefixIndex()
        if prefix_index is not None and placement is None:
            raise ValueError(
                "a prefix index needs placement=... — derived homes are "
                "learned from where the slot cache actually puts each prefix"
            )
        self.prefix_index = prefix_index
        if prefix_index is not None:
            n_domains = self.scheduler.topology.n_domains
            if prefix_index.n_domains is None:
                prefix_index.n_domains = n_domains
            elif prefix_index.n_domains != n_domains:
                raise ValueError(
                    f"prefix index spans {prefix_index.n_domains} domains but "
                    f"the topology has {n_domains}"
                )
            # bind occupancy to THIS engine's telemetry unconditionally: a
            # warm index handed over from a retired engine must not keep
            # reading the old engine's frozen counters
            telemetry = self.slots.telemetry
            prefix_index.occupancy = lambda: telemetry.per_domain_occupancy
        # controller-coupled shedding: a saturated home domain sheds new
        # admissions to same-group siblings before nearest_spill goes
        # cross-group; rebound unconditionally, as the index is
        ctl = self.scheduler.controller
        if ctl is not None and self.slots.telemetry is not None:
            tel = self.slots.telemetry
            ctl.occupancy = lambda: tel.per_domain_occupancy
            ctl.shed_topology = self.scheduler.topology
            ctl.domain_capacity = self.slots.pools.domain_capacity
        if prefix_kv is True:
            prefix_kv = PrefixKVStore()
        self.prefix_kv = prefix_kv
        self.prefill_positions = 0
        self.reused_positions = 0
        self.kv_deposits = 0
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=model.device)
        self.active_req: dict[int, Request] = {}
        self.domain_switch_cost = domain_switch_cost
        self.slot_migration_cost = slot_migration_cost
        self.sim_time = 0
        self._prefill = CountingCall(model.prefill)
        self._step = CountingCall(model.decode_step)
        self.batcher = None
        if batching:
            self.batcher = PrefillBatcher(
                model, cache_len=cache_len, pack_width=pack_width or n_slots,
            )
            # every bucket runs once here, none first in the serving loop
            self.batcher.warm(params, cont=self.prefix_kv is not None)

    @property
    def compile_counts(self) -> dict:
        """Distinct input signatures per entry point: what the JAX engine's
        ``compile_counts`` reports as jit traces on the same workload."""
        out = {"prefill": self._prefill.traces, "decode": self._step.traces}
        if self.batcher is not None:
            out["packed_prefill"] = self.batcher.packed.traces
            out["cont_prefill"] = self.batcher.cont.traces
        return out

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request):
        """Queue ``req`` for admission.  Prompts that cannot fit the cache are
        rejected here.  ``domain=None`` derives the home from the prefix
        index (longest cached prefix; explicit domains remain an override),
        or takes domain 0 without an index or on a cold one."""
        if len(req.prompt) >= self.cache_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit cache_len="
                f"{self.cache_len} (need len(prompt) < cache_len to leave "
                "room for decode); truncate the prompt or grow the cache"
            )
        derived = req.domain is None
        if self.tracer:
            self.tracer.begin(
                "request", req.rid, self.scheduler.now, prompt_len=len(req.prompt)
            )
        if req.domain is None:
            if self.prefix_index is not None:  # implies placement
                domain, matched = self.prefix_index.home(req.prompt)
                req.matched_len = matched
                self.slots.telemetry.record_derived_home(matched, len(req.prompt))
            else:
                domain = None
            req.domain = 0 if domain is None else domain
        if self.tracer:
            now = self.scheduler.now
            self.tracer.span(
                "home_derivation", req.rid, now, now,
                domain=req.domain, matched=req.matched_len, derived=derived,
            )
        ctl = self.scheduler.controller
        if ctl is not None and self.slots.telemetry is not None:
            shed = ctl.shed_home(req.domain)
            if shed != req.domain:
                # home saturated, a same-group sibling has headroom: re-home
                # the admission there; the matched-prefix discount no longer
                # applies at the new home
                if self.tracer:
                    now = self.scheduler.now
                    self.tracer.span(
                        "shed", req.rid, now, now, home=req.domain, to=shed
                    )
                req.domain = shed
                req.matched_len = 0
                self.slots.telemetry.record_shed()
        req.submit_t = self.scheduler.now
        self.scheduler.submit(req, req.domain)

    def _claim_and_charge(self, req: Request, switch_distance: int) -> int:
        """Claim a slot for a granted request and charge its admission
        stalls (domain switch + KV migration); returns the slot."""
        slot = self.slots.claim(req.rid, req.domain)
        migration = self.slot_migration_cost * self.slots.last_distance
        if req.matched_len and len(req.prompt):
            # only the uncached suffix of the KV is charged for an off-home
            # placement (the reference's model: a matched prefix is resident
            # where the slot lands); Python ints, as sim_time is compared
            # for equality with the reference
            uncached = max(0, len(req.prompt) - req.matched_len)
            migration = migration * uncached // len(req.prompt)
        stall = self.domain_switch_cost * switch_distance + migration
        self.sim_time += stall
        if self.tracer:
            now = self.scheduler.now
            sp = self.tracer.span(
                "admit", req.rid, now, now, slot=slot, domain=req.domain,
                switch_distance=switch_distance, stall_cycles=stall,
            )
            if self.slots.last_distance:
                self.tracer.span(
                    "migrate", req.rid, now, now, parent=sp,
                    distance=self.slots.last_distance, cycles=migration,
                )
        if self.prefix_index is not None:
            # re-home: the prefix now lives where placement put it
            self.prefix_index.record(req.prompt, self.slots.last_domain)
        self.scheduler.observe_handover(stall)
        req.admit_t = self.scheduler.now
        return slot

    def _admit(self):
        if self.batcher is not None:
            self._admit_packed()
            return
        while self.slots.n_free and len(self.scheduler):
            req = self.scheduler.next_request()
            if req is None:
                break
            slot = self._claim_and_charge(req, self.scheduler.last_admit_distance)
            p0, r0 = self.prefill_positions, self.reused_positions
            logits, cache = self._prefill_reuse(req.prompt, req.matched_len)
            if self.tracer:
                computed = self.prefill_positions - p0
                reused = self.reused_positions - r0
                kind = "reuse" if computed == 0 else ("cont" if reused else "fresh")
                now = self.scheduler.now
                self.tracer.span(
                    "prefill", req.rid, now, now,
                    kind=kind, computed=computed, reused=reused,
                )
                self.tracer.begin("decode", req.rid, now)
            self.slots.insert(slot, cache)
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            self.tokens[slot, 0] = tok
            self.active_req[slot] = req

    def _admit_packed(self):
        """Packed admission: at most one packed prefill call (plus at most
        one continuation call when a prefix-KV store is wired) per ``step``;
        grants beyond ``pack_width`` stay queued for the next tick.  Store
        hits ride the continuation pack, boundary plants ride the fresh pack
        as extra rows, and ``prefill_positions``/``reused_positions`` charge
        what the per-request path would."""
        k = min(self.slots.n_free, self.batcher.pack_width)
        if k <= 0:
            return
        reqs = self.scheduler.next_batch(k)
        if not reqs:
            return
        store = self.prefix_kv
        admitted = [
            (req, self._claim_and_charge(req, dist))
            for req, dist in zip(reqs, self.scheduler.last_batch_distances)
        ]
        fresh = []   # (req, slot, boundary-plant hint)
        cont = []    # (req, slot, matched, stored cache)
        ready = []   # (req, slot, stored logits): whole prompt cached
        if store is None:
            fresh = [(req, slot, 0) for req, slot in admitted]
        else:
            for req, slot in admitted:
                reuse = store.longest(req.prompt)
                if reuse is not None:
                    matched, cache, logits = reuse
                    self.reused_positions += matched
                    if matched == len(req.prompt):
                        self.slots.insert(slot, cache)  # a copy into the lane
                        store.put([int(t) for t in req.prompt], cache, logits)
                        ready.append((req, slot, logits))
                    else:
                        cont.append((req, slot, matched, cache))
                else:
                    hint = max(int(req.matched_len), store.common_run(req.prompt))
                    if hint < store.min_plant or hint > len(req.prompt):
                        hint = 0
                    fresh.append((req, slot, hint))

        assign = []  # (req, slot, device first-token scalar)
        if fresh:
            rows = [req.prompt for req, _, _ in fresh]
            # boundary plants ride the same pack as extra rows when there is
            # room; their positions replicate the full row's prefix, so they
            # are not charged again
            plant = []
            for req, _, hint in fresh:
                if hint and len(rows) < self.batcher.pack_width:
                    plant.append((len(rows), [int(t) for t in req.prompt[:hint]]))
                    rows.append(req.prompt[:hint])
            logits, cache = self.batcher.prefill(self.params, rows)
            nxt = torch.argmax(logits, dim=-1)
            for i, (req, slot, _hint) in enumerate(fresh):
                self.slots.insert_row(slot, cache, i)
                self.prefill_positions += len(req.prompt)
                if self.tracer:
                    now = self.scheduler.now
                    self.tracer.span(
                        "prefill", req.rid, now, now,
                        kind="fresh", computed=len(req.prompt), reused=0,
                    )
                assign.append((req, slot, nxt[i]))
                if store is not None:
                    single = self.slots.fit_single(self.batcher.extract_row(cache, i))
                    store.put([int(t) for t in req.prompt], single, logits[i : i + 1])
            for i, boundary in plant:
                single = self.slots.fit_single(self.batcher.extract_row(cache, i))
                store.put(boundary, single, logits[i : i + 1])
        if cont:
            rows = [c for _, _, _, c in cont]
            suffixes = [req.prompt[matched:] for req, _, matched, _ in cont]
            logits, cache = self.batcher.continue_rows(self.params, rows, suffixes)
            nxt = torch.argmax(logits, dim=-1)
            for i, (req, slot, matched, _c) in enumerate(cont):
                self.slots.insert_row(slot, cache, i)
                self.prefill_positions += len(req.prompt) - matched
                if self.tracer:
                    now = self.scheduler.now
                    self.tracer.span(
                        "prefill", req.rid, now, now, kind="cont",
                        computed=len(req.prompt) - matched, reused=matched,
                    )
                assign.append((req, slot, nxt[i]))
                single = self.slots.fit_single(self.batcher.extract_row(cache, i))
                store.put([int(t) for t in req.prompt], single, logits[i : i + 1])
        for req, slot, logits in ready:
            if self.tracer:
                now = self.scheduler.now
                self.tracer.span(
                    "prefill", req.rid, now, now,
                    kind="reuse", computed=0, reused=len(req.prompt),
                )
            assign.append((req, slot, torch.argmax(logits[0])))

        # ONE host transfer for every admitted request's first token
        toks = torch.stack([t for _, _, t in assign]).tolist() if assign else []
        for (req, slot, _), tok in zip(assign, toks):
            req.out.append(tok)
            self.tokens[slot, 0] = tok
            self.active_req[slot] = req
            if self.tracer:
                self.tracer.begin("decode", req.rid, self.scheduler.now)

    def _prefill_reuse(self, prompt, hint_len: int = 0):
        """Prefill ``prompt``, resuming from the longest stored prefix cache
        when a ``PrefixKVStore`` is wired: only the uncached suffix is
        computed, one ``decode_step`` per suffix token, over a CLONE of the
        stored cache (``decode_step`` writes the cache it is handed, and the
        entry must stay as stored).  ``prefill_positions`` counts positions
        actually computed.

        ``hint_len`` (a request's ``matched_len``; 0 without a prefix index)
        or the store's longest common run against a stored key, whichever is
        longer, splits a miss at that boundary: the boundary cache is
        deposited, so the next prompt sharing the run resumes from it."""
        store = self.prefix_kv
        if store is None:
            logits, cache = self._prefill(self.params, {"tokens": np.asarray(prompt, np.int32)[None]})
            self.prefill_positions += len(prompt)
            return logits, cache
        reuse = store.longest(prompt)
        if reuse is None:
            hint_len = max(int(hint_len), store.common_run(prompt))
            if hint_len < store.min_plant:
                hint_len = 0
        if reuse is not None:
            matched, cache, logits = reuse
            self.reused_positions += matched
        elif 0 < hint_len <= len(prompt):
            boundary = [int(t) for t in prompt[:hint_len]]
            logits, cache = self._prefill(self.params, {"tokens": np.asarray(boundary, np.int32)[None]})
            # every stored entry shares one (batch=1, cache_len) shape
            cache = self.slots.fit_single(cache)
            store.put(boundary, cache, logits)
            matched = hint_len
            self.prefill_positions += hint_len
        else:
            matched = 0
        if matched == 0:
            logits, cache = self._prefill(self.params, {"tokens": np.asarray(prompt, np.int32)[None]})
            cache = self.slots.fit_single(cache)
            self.prefill_positions += len(prompt)
        elif matched < len(prompt):
            cache = _clone(cache)
            for i in range(matched, len(prompt)):
                tok = torch.tensor([[int(prompt[i])]], dtype=torch.int32, device=self.model.device)
                logits, cache = self._step(self.params, cache, tok)
            self.prefill_positions += len(prompt) - matched
        store.put([int(t) for t in prompt], cache, logits)
        return logits, cache

    # -- KV shipping -------------------------------------------------------------
    def export_kv(self, prompt):
        """The longest stored prefix cache for ``prompt``, for a transfer to
        another engine -> ``(tokens, (cache, logits))``, or None when no
        store is wired or nothing prefixes the prompt.  The bundle is the
        store's own tensors: the receiver copies them (``import_kv``), and
        nothing writes them."""
        if self.prefix_kv is None:
            return None
        matched = self.prefix_kv.peek(prompt)
        if matched <= 0:
            return None
        key = tuple(int(t) for t in prompt)[:matched]
        entry = self.prefix_kv.get(key)
        if entry is None:
            return None
        return key, entry

    def import_kv(self, tokens, payload) -> bool:
        """Land a shipped prefix bundle in this engine's store (refitted to
        this engine's ``cache_len``, a copy), so the next admission of a
        prompt extending ``tokens`` resumes from it.  Refuses (returns False)
        when no store is wired or the bundle cannot fit ``cache_len``; the
        caller then re-prefills."""
        if self.prefix_kv is None:
            return False
        cache, logits = payload
        if len(tokens) >= self.cache_len:
            return False
        self.prefix_kv.put(list(tokens), self.slots.fit_single(cache), logits)
        return True

    def peek_match(self, prompt) -> int:
        """Tokens of ``prompt`` resumable from the store (0 without one),
        side-effect-free."""
        return self.prefix_kv.peek(prompt) if self.prefix_kv is not None else 0

    # -- federation export -----------------------------------------------------
    def summary(self, top_k: int = 8) -> dict:
        """Compact replica-state export: live occupancy (decoding + queued)
        against slot capacity, plus the prefix index's hottest cached
        prefixes (empty without an index)."""
        return {
            "occupancy": len(self.active_req) + len(self.scheduler),
            "capacity": self.n_slots,
            "prefixes": tuple(self.prefix_index.summary(top_k))
            if self.prefix_index is not None
            else (),
        }

    # -- decode ----------------------------------------------------------------
    def step(self):
        """One engine tick: admit, one fused decode step, retire finished."""
        self.scheduler.tick()
        self._admit()
        if not self.active_req:
            self.sim_time += 1
            return
        logits, new_cache = self._step(self.params, self.slots.cache, self.tokens)
        self.slots.cache = new_cache
        self.sim_time += 1
        # next-token feedback stays on device; the per-slot bookkeeping below
        # needs exactly ONE host transfer per tick
        nxt = torch.argmax(logits, dim=-1)
        self.tokens = nxt[:, None].to(torch.int32)
        nxt_host, pos_host = torch.stack([nxt, new_cache["pos"].to(nxt.dtype)]).tolist()
        for slot, req in list(self.active_req.items()):
            tok = int(nxt_host[slot])
            req.out.append(tok)
            hit_eos = self.eos is not None and tok == self.eos
            # a sliding-window model's ring (min(cache_len, window) slots)
            # is written at pos % ring, so it never overflows; retirement
            # follows cache_len for every model, as in the reference
            past_len = int(pos_host[slot]) >= self.cache_len - 1
            if req.done or hit_eos or past_len:
                req.finish_t = self.scheduler.now
                deposits_before = self.kv_deposits
                if self.prefix_kv is not None:
                    # retirement-time deposit: the slot's cache now encodes
                    # prompt + out[:-1] (the final token was emitted, never
                    # fed), and this step's logits row predicts out[-1]; a
                    # follow-up extending prompt + output resumes from here.
                    # extract copies the lane, so the entry is the store's.
                    seq = [int(t) for t in req.prompt] + [int(t) for t in req.out[:-1]]
                    pos = int(pos_host[slot])
                    if 0 < pos < self.cache_len and pos == len(seq):
                        self.prefix_kv.put(
                            seq, self.slots.extract(slot), logits[slot : slot + 1]
                        )
                        self.kv_deposits += 1
                if self.prefix_index is not None:
                    # the retiring slot's pool now holds KV for the full
                    # sequence: index it before release (host token lists)
                    self.prefix_index.record(
                        np.concatenate([np.asarray(req.prompt), np.asarray(req.out)]),
                        self.slots.slot_domain(slot),
                    )
                if self.tracer:
                    now = self.scheduler.now
                    self.tracer.end(
                        self.tracer.open_span(req.rid, "decode"), now,
                        tokens=len(req.out),
                    )
                    root = self.tracer.open_span(req.rid, "request")
                    if self.kv_deposits > deposits_before:
                        self.tracer.event(root, "deposit", now)
                    self.tracer.event(root, "retire", now, slot=slot)
                    self.tracer.end(root, now)
                self.slots.release(slot)
                del self.active_req[slot]

    def run(self, requests: list[Request], max_ticks: int = 10_000) -> list[Request]:
        """Submit ``requests`` and step until all retire (or ``max_ticks``
        scheduler ticks elapse); returns the same list, outputs filled."""
        for r in requests:
            self.submit(r)
        ticks = 0
        while (len(self.scheduler) or self.active_req) and ticks < max_ticks:
            self.step()
            ticks += 1
        return requests


def _clone(node):
    """A copy of a cache tree (a dict of tuples of tensors, ``pos``) that
    shares no storage with it."""
    if isinstance(node, torch.Tensor):
        return node.clone()
    if isinstance(node, dict):
        return {key: _clone(n) for key, n in node.items()}
    return tuple(_clone(n) for n in node)
