"""[PyTorch port: a copy of ``repro.core.discipline``, kept here so the port imports
nothing of the JAX package.]

The CNA discipline as a pure transition core shared by every driver.

The paper's contribution is one compact policy — a main queue, a secondary
queue, and a fairness threshold — yet the seed repo transcribed it three
times (threaded lock, discrete-event sim, serving admission queue) with
drifting semantics.  This module is the single source of truth; the drivers
keep only their medium-specific concerns:

  ``repro.core.cna.CNALock``        atomics emulation + thread parking,
                                    applies decisions to linked CNANodes;
  ``repro.core.locks_sim.CNASim``   event-loop cost charging, consumes
                                    ``Scan``/``Grant`` events to charge
                                    ``c_scan_*`` / ``charge_xfer``;
  ``repro.core.policy``             the domain-generic admission queue.

Two layers:

  * ``decide(main_domains, n_secondary, holder_domain, rng, cfg)`` — a pure
    function from a queue *snapshot* to a ``Decision`` (which structural
    action the paper's release path takes) plus typed events.  Determinism
    contract: given the same snapshot and RNG stream it consumes the same
    number of random draws in the same order in every driver, which is what
    makes the grant-order equivalence test (tests/test_discipline.py) one
    test over three drivers.
  * ``CNADiscipline`` — the stateful form over (item, domain) deques, for
    drivers whose queue *is* a deque.  ``arrive`` / ``release`` return typed
    events instead of bumping ad-hoc counters.

Paper mapping (Dice & Kogan, EuroSys 2019): ``decide`` covers Fig. 4 L40-49
and Fig. 5 (find_successor, keep_lock_local) plus the Section 6 shuffle
reduction; the main-queue-empty promote path is Fig. 4 L27-31.

``RestrictedDiscipline`` layers GCR-style concurrency restriction ("Avoiding
Scalability Collapse by Restricting Concurrency", Dice & Kogan 2019) over any
discipline with this interface: at most ``max_active`` waiters circulate in
the inner queue, the excess parks on a passivation list (emitting ``Park`` so
drivers can model them as non-runnable), and a grant-count timeout rotates
passivated waiters in so nobody starves.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterator, Sequence

# Long-term fairness threshold (paper Fig. 5: 0xffff) and the Section-6
# shuffle-reduction threshold (0xff).  Tests/benchmarks scale them down so
# flush/fast-path events happen at simulated-run frequency.
THRESHOLD = 0xFFFF
THRESHOLD2 = 0xFF


@dataclass(frozen=True)
class DisciplineConfig:
    threshold: int = THRESHOLD
    shuffle_reduction: bool = False
    threshold2: int = THRESHOLD2


# -- typed events -------------------------------------------------------------
# Emitted by transitions instead of mutating ad-hoc counters; each driver
# folds them into its own accounting (CNAStats / SimResult / PolicyStats).


@dataclass(frozen=True)
class Scan:
    """find_successor inspected ``n_local`` holder-domain and ``n_remote``
    other-domain waiters (each inspection touches that waiter's cache line)."""

    n_local: int
    n_remote: int


@dataclass(frozen=True)
class Shuffle:
    """A skipped remote-domain prefix of ``n_moved`` waiters moved from the
    main queue to the secondary queue (Fig. 5 L64-68)."""

    n_moved: int


@dataclass(frozen=True)
class SecondaryFlush:
    """The secondary queue (``n_flushed`` waiters) re-entered the main queue —
    the fairness/starvation-bound path (Fig. 4 L27-31 / L43-46)."""

    n_flushed: int


@dataclass(frozen=True)
class Park:
    """Concurrency restriction moved an arriving waiter to the passive list."""

    item: Any
    domain: int


@dataclass(frozen=True)
class Unpark:
    """Concurrency restriction re-activated a passivated waiter."""

    item: Any
    domain: int


@dataclass(frozen=True)
class Inflate:
    """A fissile wrapper's first contended arrival moved ``n_moved`` waiters
    (the fast-path occupant plus the new arrival) into the full two-queue
    core — the fast path is now off until both queues drain."""

    n_moved: int


@dataclass(frozen=True)
class Deflate:
    """A fissile wrapper's inner queues drained; the next uncontended
    arrival takes the fast path again."""


@dataclass(frozen=True)
class Grant:
    """The next holder was chosen.  ``local`` is the paper's same-socket
    handover; ``kind`` names the path that produced it; ``events`` carries
    the satellite events of the same transition, in order."""

    item: Any
    domain: int
    local: bool
    kind: str  # "promote" | "fast_path" | "scan" | "flush" | "fifo" | "fast"
    events: tuple = ()


# -- the pure decision function ----------------------------------------------


class _DomainView:
    """Lazy, read-only view of the domains in a deque of (item, domain).

    ``decide`` draws its fast-path/keep_lock_local randomness *before*
    scanning, so on most releases (shuffle-reduction hit, FIFO grant) it never
    iterates — passing a view instead of a materialized list keeps those
    grants O(1) in queue length."""

    __slots__ = ("_q",)

    def __init__(self, q) -> None:
        self._q = q

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return (dom for _, dom in self._q)


@dataclass(frozen=True)
class Decision:
    """Structural action for one release, expressed over queue positions so
    linked-list drivers can replay it on pointers and deque drivers on deques.

      "none"       both queues empty: the lock becomes free
      "promote"    main empty: secondary head takes over, rest becomes main
      "fast_path"  Section-6 shuffle reduction: grant main[0], skip the scan
      "scan"       find_successor hit: grant main[index], move main[:index]
                   to the secondary queue
      "flush"      no local waiter (or fairness roll failed): grant the
                   secondary head, splice the rest in front of main
      "fifo"       no local waiter, secondary empty: grant main[0]
    """

    kind: str
    index: int = 0
    events: tuple = ()


def decide(
    main_domains: "Sequence[int] | _DomainView",
    n_secondary: int,
    holder_domain: int,
    rng: random.Random,
    cfg: DisciplineConfig,
) -> Decision:
    if not main_domains:
        if n_secondary == 0:
            return Decision("none")
        return Decision("promote", events=(SecondaryFlush(n_secondary),))

    # Section 6 shuffle reduction: with an empty secondary queue, skip
    # find_successor with high probability and grant the immediate successor.
    if cfg.shuffle_reduction and n_secondary == 0 and rng.getrandbits(30) & cfg.threshold2:
        return Decision("fast_path")

    if rng.getrandbits(30) & cfg.threshold:  # keep_lock_local (Fig. 5 L77)
        n_remote = 0
        for i, d in enumerate(main_domains):
            if d == holder_domain:
                events: list = [Scan(1, n_remote)]
                if i:
                    events.append(Shuffle(i))
                return Decision("scan", index=i, events=tuple(events))
            n_remote += 1
        # find_successor returned NULL (L74): every inspected waiter was
        # remote; nothing moved.
        scan = Scan(0, n_remote)
        if n_secondary:
            return Decision("flush", events=(scan, SecondaryFlush(n_secondary)))
        return Decision("fifo", events=(scan,))

    if n_secondary:
        return Decision("flush", events=(SecondaryFlush(n_secondary),))
    return Decision("fifo")


# -- unified stats vocabulary -------------------------------------------------


@dataclass
class DisciplineStats:
    """One stats vocabulary for every driver, folded from events."""

    grants: int = 0
    local_grants: int = 0
    flushes: int = 0
    shuffles: int = 0
    scanned_local: int = 0
    scanned_remote: int = 0
    parked: int = 0
    unparked: int = 0
    # fissile fast path (FissileDiscipline): grants that bypassed the
    # two-queue core, and the mode transitions around them
    fast_grants: int = 0
    inflations: int = 0
    deflations: int = 0

    @property
    def locality(self) -> float:
        return self.local_grants / max(1, self.grants)

    @property
    def scanned(self) -> int:
        return self.scanned_local + self.scanned_remote

    def consume(self, grant: "Grant | None", events: tuple = ()) -> None:
        if grant is not None:
            self.grants += 1
            if grant.local:
                self.local_grants += 1
            if grant.kind == "fast":
                self.fast_grants += 1
            events = grant.events + tuple(events)
        for ev in events:
            if isinstance(ev, Scan):
                self.scanned_local += ev.n_local
                self.scanned_remote += ev.n_remote
            elif isinstance(ev, Shuffle):
                self.shuffles += 1
            elif isinstance(ev, SecondaryFlush):
                self.flushes += 1
            elif isinstance(ev, Park):
                self.parked += 1
            elif isinstance(ev, Unpark):
                self.unparked += 1
            elif isinstance(ev, Inflate):
                self.inflations += 1
            elif isinstance(ev, Deflate):
                self.deflations += 1


# -- the stateful core --------------------------------------------------------


class CNADiscipline:
    """The two queues + RNG stream, with ``arrive``/``release`` transitions.

    Items are opaque; each carries the locality domain it was tagged with at
    arrival.  ``release(holder_domain)`` plays the paper's unlock: it chooses
    the next holder and restructures the queues, returning a ``Grant`` (with
    the transition's satellite events attached) or ``None`` when empty.

    ``threshold`` is a probability bitmask, not a time or a count:
    ``keep_lock_local`` succeeds whenever a 30-bit draw ANDs non-zero with
    it, so 0 = strict FIFO (the MCS limit), 0xF = local-preferred 15/16,
    0xFFFF = the paper's long-term fairness default (~1 remote flush per
    65k grants).  The discipline carries no notion of cycles or ticks —
    costs are the *drivers'* concern; it only ever compares domains."""

    def __init__(
        self,
        *,
        threshold: int = THRESHOLD,
        shuffle_reduction: bool = False,
        threshold2: int = THRESHOLD2,
        rng: random.Random | None = None,
        seed: int = 0x5EED,
    ) -> None:
        self.cfg = DisciplineConfig(threshold, shuffle_reduction, threshold2)
        self.rng = rng if rng is not None else random.Random(seed)
        self._main: deque[tuple[Any, int]] = deque()
        self._secondary: deque[tuple[Any, int]] = deque()

    def __len__(self) -> int:
        return len(self._main) + len(self._secondary)

    def __iter__(self) -> Iterator[tuple[Any, int]]:
        yield from self._main
        yield from self._secondary

    @property
    def n_secondary(self) -> int:
        return len(self._secondary)

    def arrive(self, item: Any, domain: int) -> tuple:
        """New waiters always join the main queue (paper Section 4)."""
        self._main.append((item, domain))
        return ()

    def release(self, holder_domain: int) -> Grant | None:
        d = decide(
            _DomainView(self._main),
            len(self._secondary),
            holder_domain,
            self.rng,
            self.cfg,
        )
        if d.kind == "none":
            return None
        if d.kind in ("promote", "flush"):
            # Grant the secondary head; the rest of the secondary queue is
            # spliced in front of whatever remains of the main queue.
            item, dom = self._secondary.popleft()
            self._secondary.extend(self._main)
            self._main = self._secondary
            self._secondary = deque()
        elif d.kind == "scan":
            for _ in range(d.index):  # skipped remote prefix -> secondary
                self._secondary.append(self._main.popleft())
            item, dom = self._main.popleft()
        else:  # "fast_path" | "fifo"
            item, dom = self._main.popleft()
        return Grant(item, dom, local=dom == holder_domain, kind=d.kind, events=d.events)

    def drain(self) -> list[tuple[Any, int]]:
        out = list(self._main) + list(self._secondary)
        self._main.clear()
        self._secondary.clear()
        return out


class FIFODiscipline:
    """Strict arrival order over one deque — the MCS baseline behind the FIFO
    admission queue, with the same ``arrive``/``release``/``drain`` interface
    as ``CNADiscipline`` so ``RestrictedDiscipline`` can wrap either core
    (GCR restriction is orthogonal to the grant order)."""

    def __init__(self) -> None:
        self._q: deque[tuple[Any, int]] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self) -> Iterator[tuple[Any, int]]:
        yield from self._q

    @property
    def n_secondary(self) -> int:
        return 0

    def arrive(self, item: Any, domain: int) -> tuple:
        self._q.append((item, domain))
        return ()

    def release(self, holder_domain: int) -> Grant | None:
        if not self._q:
            return None
        item, dom = self._q.popleft()
        return Grant(item, dom, local=dom == holder_domain, kind="fifo")

    def drain(self) -> list[tuple[Any, int]]:
        out = list(self._q)
        self._q.clear()
        return out


class RestrictedDiscipline:
    """GCR-style concurrency restriction over any discipline core.

    At most ``max_active`` waiters circulate in the inner queue; later
    arrivals park on a passivation FIFO (``Park``) where drivers treat them
    as non-runnable — that is the whole mechanism by which restriction avoids
    scalability collapse under oversubscription.  Activation (``Unpark``)
    happens (a) whenever a grant opens an active slot, and (b) every
    ``rotate_after`` grants *unconditionally* — the grant-count analog of
    GCR's timeout, bounding any waiter's passive residence even if the
    active set never drains.  Locality is untouched: the inner discipline
    still orders the active set.

    ``max_active`` is either a static int or any object with a ``cap``
    attribute (``repro.placement.AdaptiveController``): the cap is re-read on
    every transition, so a controller fed with handover latencies adjusts the
    active set online.  A cap that shrinks below the current active count is
    honoured lazily — arrivals park and the refill loop stays idle until
    grants drain the active set under the new cap.
    """

    def __init__(self, inner, *, max_active: "int | Any" = 8, rotate_after: int = 64) -> None:
        self.inner = inner
        if isinstance(max_active, int):
            if max_active < 1:
                raise ValueError("max_active must be >= 1")
            self.controller = None
            self._max_active = max_active
        else:
            if getattr(max_active, "cap", 0) < 1:
                raise ValueError("controller cap must be >= 1")
            self.controller = max_active
            self._max_active = None
        self.rotate_after = rotate_after
        self._passive: deque[tuple[Any, int]] = deque()
        self._grants = 0

    @property
    def max_active(self) -> int:
        if self.controller is not None:
            return self.controller.cap
        return self._max_active

    @max_active.setter
    def max_active(self, value: int) -> None:
        if self.controller is not None:
            raise AttributeError("max_active is controller-driven; adjust the controller")
        if value < 1:
            raise ValueError("max_active must be >= 1")
        self._max_active = value

    def __len__(self) -> int:
        return len(self.inner) + len(self._passive)

    def __iter__(self) -> Iterator[tuple[Any, int]]:
        yield from self.inner
        yield from self._passive

    @property
    def n_passive(self) -> int:
        return len(self._passive)

    def arrive(self, item: Any, domain: int) -> tuple:
        if len(self.inner) < self.max_active:
            return self.inner.arrive(item, domain)
        self._passive.append((item, domain))
        return (Park(item, domain),)

    def _activate_one(self) -> Unpark:
        item, dom = self._passive.popleft()
        self.inner.arrive(item, dom)
        return Unpark(item, dom)

    def release(self, holder_domain: int) -> Grant | None:
        extra: list = []
        self._grants += 1
        if self._passive and self._grants % self.rotate_after == 0:
            extra.append(self._activate_one())  # fairness rotation (timeout)
        g = self.inner.release(holder_domain)
        if g is None:
            if not self._passive:
                return None
            extra.append(self._activate_one())
            g = self.inner.release(holder_domain)
            assert g is not None
        while self._passive and len(self.inner) < self.max_active:
            extra.append(self._activate_one())
        if extra:
            g = Grant(g.item, g.domain, g.local, g.kind, g.events + tuple(extra))
        return g

    def drain(self) -> list[tuple[Any, int]]:
        out = self.inner.drain() + list(self._passive)
        self._passive.clear()
        return out


class FissileDiscipline:
    """Contention-adaptive fast path in front of any discipline core, after
    Fissile Locks (Dice & Kogan, arXiv 2003.05025): a TS-style fast path
    serves uncontended traffic without touching the two-queue machinery, and
    *inflates* to the full inner discipline at the first contended arrival.

    Two modes:

      * ``"fast"`` (deflated) — the inner core is empty and untouched; at
        most one waiter occupies a single slot (the TS word's analog).  An
        uncontended grant is one slot read: no ``decide()`` call, no RNG
        draw, no queue restructuring, no satellite events — ``Grant`` kind
        ``"fast"``.
      * ``"inflated"`` — every ``arrive``/``release`` delegates verbatim to
        the inner core (same RNG stream, same splicing), so an inflated run
        is *bitwise-identical* to running the inner discipline bare.  The
        mode transitions are the only additions: the arrival that finds the
        fast slot occupied moves both waiters into the inner core in arrival
        order (``Inflate``), and the grant that drains both inner queues
        re-arms the fast path (``Deflate``, attached to that grant's events).

    Equivalence contract (tests/test_fissile.py, tests/test_discipline.py):
    under saturation — the queue never empties between the first contended
    arrival and the last grant — the wrapper never takes the fast path, so
    grant orders match a bare inner core with the same seed exactly.  Off
    saturation, a fast grant is *forced* (its waiter is the only one), so
    the fast path can never reorder grants; it only skips the RNG draws the
    inner core would have spent choosing among one.

    Barging is structurally impossible: the fast slot is used only in fast
    mode, and fast mode requires the inner core (both queues *and* any
    restriction passive list) to be empty — no arrival can bypass inflated
    waiters, unlike the raw TS path of a real fissile lock.

    Composes outside ``RestrictedDiscipline`` (the uncontended case trivially
    satisfies any ``max_active >= 1`` cap, so restriction only matters once
    inflated) and exposes the same ``controller``/``max_active`` surface so
    adapters are wrapper-agnostic."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.mode = "fast"
        self._slot: tuple[Any, int] | None = None
        self.fast_grants = 0
        self.inflations = 0
        self.deflations = 0

    # -- adapter passthroughs (CNAAdmissionQueue reads these) -----------------
    @property
    def controller(self):
        return getattr(self.inner, "controller", None)

    @property
    def max_active(self):
        return getattr(self.inner, "max_active", None)

    @property
    def n_secondary(self) -> int:
        return self.inner.n_secondary if self.mode == "inflated" else 0

    @property
    def n_passive(self) -> int:
        return getattr(self.inner, "n_passive", 0)

    def __len__(self) -> int:
        return len(self.inner) + (1 if self._slot is not None else 0)

    def __iter__(self) -> Iterator[tuple[Any, int]]:
        if self._slot is not None:
            yield self._slot
        yield from self.inner

    def fast_ready(self) -> bool:
        """True when the next ``release`` will be an uncontended fast-path
        grant — drivers gate *their own* bypasses (skip pricing, skip
        candidate scans) on this so every skipped side effect is confined to
        transitions that are bitwise-invisible at saturation."""
        return self.mode == "fast" and self._slot is not None

    def fast_peek(self) -> tuple[Any, int] | None:
        """The ``(item, domain)`` the fast slot would grant next, or None —
        lets a driver check preconditions (headroom at the item's home)
        *before* committing to the bypass."""
        return self._slot if self.mode == "fast" else None

    def arrive(self, item: Any, domain: int) -> tuple:
        if self.mode == "inflated":
            return self.inner.arrive(item, domain)
        if self._slot is None:
            self._slot = (item, domain)  # the single CAS-analog decision
            return ()
        # first contended arrival: inflate to the full two-queue state, in
        # arrival order (the fast occupant was there first)
        first, self._slot = self._slot, None
        self.mode = "inflated"
        self.inflations += 1
        events: tuple = (Inflate(2),)
        events += tuple(self.inner.arrive(*first))
        events += tuple(self.inner.arrive(item, domain))
        return events

    def release(self, holder_domain: int) -> Grant | None:
        if self.mode == "fast":
            if self._slot is None:
                return None
            (item, dom), self._slot = self._slot, None
            self.fast_grants += 1
            return Grant(item, dom, local=dom == holder_domain, kind="fast")
        g = self.inner.release(holder_domain)
        if g is None:  # defensive: an empty inflated core deflates silently
            self.mode = "fast"
            self.deflations += 1
            return None
        if not len(self.inner):  # both queues (and any passive list) drained
            self.mode = "fast"
            self.deflations += 1
            g = Grant(g.item, g.domain, g.local, g.kind, g.events + (Deflate(),))
        return g

    def drain(self) -> list[tuple[Any, int]]:
        out = ([self._slot] if self._slot is not None else []) + self.inner.drain()
        self._slot = None
        self.mode = "fast"
        return out
