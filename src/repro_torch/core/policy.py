"""[PyTorch port: a copy of ``repro.core.policy``, kept here so the port imports
nothing of the JAX package.]

The CNA admission policy as a reusable, domain-generic queue.

This is the load-bearing abstraction that carries the paper's idea into the
rest of the framework: a queue of work items, each tagged with a *locality
domain* (NUMA socket in the paper; TPU pod / KV-cache home in this framework),
served with CNA's discipline.  Since the refactor the discipline itself lives
in ``repro.core.discipline`` — shared verbatim with the threaded lock and the
discrete-event simulator — and this module is only the adapter that gives it
the push/pop vocabulary schedulers expect, plus ``PolicyStats`` folded from
the core's typed events.

State is compact by construction: two deques and a counter — no per-domain
structure, which is the whole point of the paper (contrast a "cohort
scheduler" that would keep one queue per pod).

``max_active`` layers GCR-style concurrency restriction over the discipline
(``RestrictedDiscipline``): only that many items circulate in the CNA queues,
the rest wait on a passivation list — admission control for schedulers whose
scan/restructure costs grow with queue depth.  It takes either a static int
or an ``repro.placement.AdaptiveController``; with a controller, callers feed
``observe_handover(latency)`` after each grant and the active-set cap tracks
the observed handover cost online (the GCR feedback loop).

``fissile=True`` layers the fissile fast path (``FissileDiscipline``,
arXiv 2003.05025) outermost: a lone waiter is granted in O(1) with no
``decide()`` call, no RNG draw and no restriction bookkeeping; the first
contended push inflates to the full discipline stack, which deflates again
when it drains.  At saturation the wrapper is bitwise-invisible.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Generic, Iterable, TypeVar

from .discipline import (
    THRESHOLD,
    THRESHOLD2,
    CNADiscipline,
    DisciplineStats,
    FIFODiscipline,
    FissileDiscipline,
    RestrictedDiscipline,
)

T = TypeVar("T")


@dataclass
class PolicyStats(DisciplineStats):
    """Alias of the unified event-derived stats (kept for the old name;
    ``flushes``/``shuffles``/``scanned``/``locality`` read as before)."""


class CNAAdmissionQueue(Generic[T]):
    def __init__(
        self,
        *,
        threshold: int = THRESHOLD,
        shuffle_reduction: bool = False,
        threshold2: int = THRESHOLD2,
        seed: int = 0xC0A,
        max_active: "int | Any | None" = None,
        rotate_after: int = 64,
        fissile: bool = False,
    ) -> None:
        # NOTE (adaptation decision): in the *lock*, shuffle reduction exists
        # to avoid the memory-system cost of restructuring the waiter queue
        # at low contention.  In a *scheduler*, restructuring is a couple of
        # deque ops — negligible next to a request handover — while skipping
        # the scan forfeits locality whenever items complete (they never
        # rejoin, so the secondary queue stays empty and the fast path pins
        # the discipline at FIFO).  Hence default off; the flag remains for
        # the faithful-lock benchmarks.
        self._d = CNADiscipline(
            threshold=threshold,
            shuffle_reduction=shuffle_reduction,
            threshold2=threshold2,
            rng=random.Random(seed),
        )
        if max_active is not None:
            self._d = RestrictedDiscipline(self._d, max_active=max_active, rotate_after=rotate_after)
        if fissile:
            # outermost, so a lone waiter bypasses both the CNA core *and* the
            # restriction bookkeeping (one item trivially satisfies any cap)
            self._d = FissileDiscipline(self._d)
        self.stats = PolicyStats()
        # the most recent pop's Grant — kind + discipline events survive the
        # (value, domain) narrowing so tracers can attach them to spans
        self.last_grant = None

    def fast_ready(self) -> bool:
        """True when the next ``pop`` is an uncontended fissile fast-path
        grant (False for non-fissile queues) — schedulers gate their own
        bypasses on this."""
        f = getattr(self._d, "fast_ready", None)
        return f() if f is not None else False

    def fast_peek(self) -> tuple[T, int] | None:
        """The ``(value, domain)`` the fissile fast slot would grant next, or
        None (always None for non-fissile queues)."""
        f = getattr(self._d, "fast_peek", None)
        return f() if f is not None else None

    @property
    def controller(self):
        """The adaptive-cap controller, or None under a static/absent cap."""
        return getattr(self._d, "controller", None)

    @property
    def max_active(self) -> int | None:
        return getattr(self._d, "max_active", None)

    def observe_handover(self, latency) -> None:
        """Feed one handover-latency sample to the adaptive controller (no-op
        without one) — the caller-side half of the GCR feedback loop."""
        c = self.controller
        if c is not None:
            c.observe(latency)

    def __len__(self) -> int:
        return len(self._d)

    def push(self, value: T, domain: int) -> None:
        """New arrivals always join the main queue (paper Section 4)."""
        self.stats.consume(None, self._d.arrive(value, domain))

    def extend(self, values: Iterable[tuple[T, int]]) -> None:
        for v, d in values:
            self.push(v, d)

    def pop(self, current_domain: int) -> tuple[T, int] | None:
        """Grant the next item under the CNA discipline.

        Returns ``(value, domain)`` or ``None`` if empty.  ``current_domain``
        plays the lock holder's socket.
        """
        g = self._d.release(current_domain)
        if g is None:
            return None
        self.stats.consume(g)
        self.last_grant = g
        return g.item, g.domain

    def drain(self) -> list[tuple[T, int]]:
        return self._d.drain()


class FIFOAdmissionQueue(Generic[T]):
    """Baseline discipline (MCS analogue) with the same interface.

    Accepts the restriction knobs ``CNAAdmissionQueue`` does — and honours
    them (``RestrictedDiscipline`` over the FIFO core: restriction bounds the
    *active set*, which is orthogonal to grant order) — so baseline arms of a
    benchmark can run under the same admission control as the CNA arm.  It
    deliberately does not accept anything else: a misspelled or inapplicable
    kwarg (``fairness_threshold`` has no FIFO analogue) is a TypeError, not a
    silently different experiment."""

    def __init__(
        self,
        *,
        max_active: "int | Any | None" = None,
        rotate_after: int = 64,
    ) -> None:
        self._d: "FIFODiscipline | RestrictedDiscipline" = FIFODiscipline()
        if max_active is not None:
            self._d = RestrictedDiscipline(self._d, max_active=max_active, rotate_after=rotate_after)
        self.stats = PolicyStats()
        # most recent pop's Grant (see CNAAdmissionQueue.last_grant)
        self.last_grant = None

    @property
    def controller(self):
        """The adaptive-cap controller, or None under a static/absent cap."""
        return getattr(self._d, "controller", None)

    @property
    def max_active(self) -> int | None:
        return getattr(self._d, "max_active", None)

    def observe_handover(self, latency) -> None:
        """Feed one handover-latency sample to the adaptive controller (no-op
        without one) — interface parity with CNAAdmissionQueue."""
        c = self.controller
        if c is not None:
            c.observe(latency)

    def __len__(self) -> int:
        return len(self._d)

    def push(self, value: T, domain: int) -> None:
        self.stats.consume(None, self._d.arrive(value, domain))

    def extend(self, values: Iterable[tuple[T, int]]) -> None:
        for v, d in values:
            self.push(v, d)

    def pop(self, current_domain: int) -> tuple[T, int] | None:
        g = self._d.release(current_domain)
        if g is None:
            return None
        self.stats.consume(g)
        self.last_grant = g
        return g.item, g.domain

    def drain(self) -> list[tuple[T, int]]:
        return self._d.drain()
