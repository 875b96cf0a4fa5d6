"""Continuous-batching decode engine.

PyTorch counterpart of ``repro.serving.engine``: one ``decode_step`` per
tick advances every slot (per-slot positions); admission order between
waiting requests is the scheduler's (CNA or FIFO).  With ``batching=True``
admission goes through the bucketed, packed prefill layer: at most one
packed prefill call per ``step()``, interleaved with running decode.

Same units, counters and span names as the reference (``sim_time`` in
scheduler ticks, ``prefill_positions`` in KV positions).  Placement, the
prefix index, the prefix-KV store and paging are not ported in this slice
and raise ``NotImplementedError``.

Greedy sampling (argmax) keeps the engine deterministic for tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .batching import CountingCall, PrefillBatcher
from .kvcache import SlotCache
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

    ``model`` is a ``repro_torch`` model; the engine runs on its device."""

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
        for name, value in (("placement", placement), ("prefix_index", prefix_index),
                            ("prefix_kv", prefix_kv), ("paging", paging or None)):
            if value is not None:
                raise NotImplementedError(f"{name} is not ported to the PyTorch engine yet")
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
        self.slots = SlotCache.zeros(model, n_slots, cache_len)
        self.prefill_positions = 0
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
            self.batcher.warm(params)

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
        rejected here.  ``domain=None`` takes domain 0: without a prefix
        index there is no home to derive."""
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
            req.domain = 0
        if self.tracer:
            now = self.scheduler.now
            self.tracer.span(
                "home_derivation", req.rid, now, now,
                domain=req.domain, matched=req.matched_len, derived=derived,
            )
        req.submit_t = self.scheduler.now
        self.scheduler.submit(req, req.domain)

    def _claim_and_charge(self, req: Request, switch_distance: int) -> int:
        """Claim a slot for a granted request and charge its admission
        stalls (domain switch + KV migration); returns the slot."""
        slot = self.slots.claim(req.rid, req.domain)
        migration = self.slot_migration_cost * self.slots.last_distance
        stall = self.domain_switch_cost * switch_distance + migration
        self.sim_time += stall
        if self.tracer:
            now = self.scheduler.now
            self.tracer.span(
                "admit", req.rid, now, now, slot=slot, domain=req.domain,
                switch_distance=switch_distance, stall_cycles=stall,
            )
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
            logits, cache = self._prefill(self.params, {"tokens": np.asarray(req.prompt)[None]})
            self.prefill_positions += len(req.prompt)
            if self.tracer:
                now = self.scheduler.now
                self.tracer.span(
                    "prefill", req.rid, now, now,
                    kind="fresh", computed=len(req.prompt), reused=0,
                )
                self.tracer.begin("decode", req.rid, now)
            self.slots.insert(slot, cache)
            tok = int(torch.argmax(logits[0]))
            req.out.append(tok)
            self.tokens[slot, 0] = tok
            self.active_req[slot] = req

    def _admit_packed(self):
        """Packed admission: at most one packed prefill call per ``step``;
        grants beyond ``pack_width`` stay queued for the next tick."""
        k = min(self.slots.n_free, self.batcher.pack_width)
        if k <= 0:
            return
        reqs = self.scheduler.next_batch(k)
        if not reqs:
            return
        fresh = [
            (req, self._claim_and_charge(req, dist))
            for req, dist in zip(reqs, self.scheduler.last_batch_distances)
        ]
        logits, cache = self.batcher.prefill(self.params, [req.prompt for req, _ in fresh])
        nxt = torch.argmax(logits, dim=-1)
        for i, (req, slot) in enumerate(fresh):
            self.slots.insert_row(slot, cache, i)
            self.prefill_positions += len(req.prompt)
            if self.tracer:
                now = self.scheduler.now
                self.tracer.span(
                    "prefill", req.rid, now, now,
                    kind="fresh", computed=len(req.prompt), reused=0,
                )
        # ONE host transfer for every admitted request's first token
        toks = nxt[: len(fresh)].tolist()
        for (req, slot), tok in zip(fresh, toks):
            req.out.append(tok)
            self.tokens[slot, 0] = tok
            self.active_req[slot] = req
            if self.tracer:
                self.tracer.begin("decode", req.rid, self.scheduler.now)

    # -- federation export -----------------------------------------------------
    def summary(self, top_k: int = 8) -> dict:
        """Compact replica-state export: live occupancy (decoding + queued)
        against slot capacity; no prefix index, so no prefixes."""
        return {
            "occupancy": len(self.active_req) + len(self.scheduler),
            "capacity": self.n_slots,
            "prefixes": (),
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
            past_len = int(pos_host[slot]) >= self.cache_len - 1
            if req.done or hit_eos or past_len:
                req.finish_t = self.scheduler.now
                if self.tracer:
                    now = self.scheduler.now
                    self.tracer.end(
                        self.tracer.open_span(req.rid, "decode"), now,
                        tokens=len(req.out),
                    )
                    root = self.tracer.open_span(req.rid, "request")
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
