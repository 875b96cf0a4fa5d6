"""[PyTorch port: a copy of ``repro.core.cna``, kept here so the port imports
nothing of the JAX package.]

Compact NUMA-aware lock (CNA) — the threaded driver of the discipline core.

This module keeps the *medium-specific* half of the paper's Figures 2-5:
Python has no raw CAS/SWAP on object attributes, so the two atomic
instructions of the algorithm (SWAP on lock.tail in `lock`, CAS on lock.tail
in `unlock`) are emulated by a single internal mutex guarding *only* those two
operations — exactly the two touch points the paper identifies — plus the
local-spin thread parking and the linked-node pointer manipulation.  *Which*
waiter gets the lock (find_successor, keep_lock_local, the Section-6 shuffle
reduction) is decided by ``repro.core.discipline.decide`` — the same pure core
the discrete-event simulator and the serving admission queue drive, so all
three produce identical grant orders on a common schedule and seed.  The GIL
makes wall-clock throughput meaningless here; this implementation is for
*algorithmic correctness* (mutual exclusion, queue splicing, starvation
freedom); performance reproduction lives in ``repro.core.numasim`` /
``repro.core.locks_sim``.

The ``spin`` field carries, as in the paper, either 0 (wait), 1 (lock granted,
empty secondary queue) or a reference to the head node of the secondary queue
(lock granted, non-empty secondary queue).  In C this is pointer-stuffing into
one word; in Python the union is explicit.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field

from .discipline import THRESHOLD, THRESHOLD2, DisciplineConfig, decide
from .topology import Topology, flat


class CNANode:
    """Queue node (paper Fig. 2).  One per (thread, nesting level)."""

    __slots__ = ("spin", "socket", "sec_tail", "next")

    def __init__(self) -> None:
        self.spin: object = 0          # 0 | 1 | CNANode (head of secondary queue)
        self.socket: int = -1
        self.sec_tail: CNANode | None = None
        self.next: CNANode | None = None


class _chain_domains:
    """Lazy domain view over a linked CNANode chain for ``decide`` — iterated
    only when the decision scans, never materialized."""

    __slots__ = ("head",)

    def __init__(self, head: CNANode | None) -> None:
        self.head = head

    def __bool__(self) -> bool:
        return self.head is not None

    def __iter__(self):
        node = self.head
        while node is not None:
            yield node.socket
            node = node.next


@dataclass
class CNAStats:
    """Optional bookkeeping used by tests/benchmarks (not part of the lock word)."""

    handovers: int = 0
    local_handovers: int = 0
    secondary_flushes: int = 0
    shuffles: int = 0
    # fissile fast path (fissile=True): acquisitions that never built a queue
    # node linkage, and the mode transitions around them
    fast_acquires: int = 0
    inflations: int = 0
    deflations: int = 0


class CNALock:
    """CNA lock.  The lock *state* is one word: ``tail``.

    ``numa_node_of`` maps a thread to its (virtual) NUMA node; on a real
    machine this is ``rdtscp``/``getcpu``; here it is injectable so tests can
    build arbitrary topologies on a single-core container.
    """

    def __init__(
        self,
        numa_node_of=None,
        threshold: int = THRESHOLD,
        shuffle_reduction: bool = False,
        threshold2: int = THRESHOLD2,
        seed: int = 0x5EED,
        fissile: bool = False,
    ) -> None:
        self.tail: CNANode | None = None          # <-- the single word of state
        self._atomic = threading.Lock()           # emulates SWAP/CAS only
        self._numa_node_of = numa_node_of or (lambda: 0)
        self._cfg = DisciplineConfig(threshold, shuffle_reduction, threshold2)
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self.stats = CNAStats()
        # fissile fast path (Dice & Kogan, arXiv 2003.05025): a TS-word analog
        # in front of the queue.  ``_fast_held`` is the TS bit; ``_fast_head``
        # is where a slow-path acquirer that found an empty queue registers so
        # the fast holder's release can adopt it as its successor chain.
        self._fissile = fissile
        self._fast_held = False
        self._fast_holder: CNANode | None = None
        self._fast_head: CNANode | None = None

    # -- emulated atomics ---------------------------------------------------
    def _swap_tail(self, new: CNANode | None) -> CNANode | None:
        with self._atomic:
            old, self.tail = self.tail, new
            return old

    def _cas_tail(self, expected: CNANode | None, new: CNANode | None) -> bool:
        with self._atomic:
            if self.tail is expected:
                self.tail = new
                return True
            return False

    # -- fissile fast path ----------------------------------------------------
    def _try_fast_takeover(self, me: CNANode) -> bool:
        """A slow-path acquirer whose SWAP found an empty queue: either the
        lock is genuinely free (take it, True) or a fast-path holder is in
        flight — register as the handover target its release will adopt and
        return False (caller spins on ``me.spin``)."""
        with self._atomic:
            if not self._fast_held:
                me.spin = 1
                return True
            self._fast_head = me
            return False

    # -- paper Fig. 3: cna_lock ---------------------------------------------
    def acquire(self, me: CNANode) -> None:
        me.next = None                             # L2
        me.socket = -1                             # L3
        me.spin = 0                                # L4
        if self._fissile:
            # the single CAS-analog decision: free *and* deflated -> no node
            # linkage, no SWAP on tail, no queue state touched at all
            with self._atomic:
                if self.tail is None and not self._fast_held:
                    self._fast_held = True
                    self._fast_holder = me
                    me.spin = 1
                    self.stats.fast_acquires += 1
                    return
        tail = self._swap_tail(me)                 # L6  (the one atomic)
        if tail is None:                           # L8: no one there?
            if self._fissile and not self._try_fast_takeover(me):
                while me.spin == 0:                # fast holder hands over
                    time.sleep(0)
                return
            me.spin = 1
            return
        me.socket = self._numa_node_of()           # L10
        tail.next = me                             # L11
        while me.spin == 0:                        # L13: local spinning
            time.sleep(0)                          # CPU_PAUSE under the GIL

    # -- paper Fig. 4: cna_unlock --------------------------------------------
    def release(self, me: CNANode) -> None:
        if me is self._fast_holder:                # fissile fast-path release
            with self._atomic:
                self._fast_holder = None
                if self.tail is None:              # nobody arrived: deflate —
                    self._fast_held = False        # TS bit clears in the same
                    self.stats.deflations += 1     # atomic step as the check
                    return
            # contended during our CS: inflate.  Adopt the queue head as our
            # successor chain and fall into the normal CNA release below, so
            # the very first contended handover already runs the full decide()
            # over every waiter — identical to a plain-CNA holder's release.
            while True:
                with self._atomic:
                    head = self._fast_head
                    if head is not None:           # L36-analog: wait for the
                        self._fast_head = None     # head to register itself
                        self._fast_held = False
                        break
                time.sleep(0)
            me.next = head
            self.stats.inflations += 1
        if me.next is None:                        # L18: successor in main queue?
            if me.spin == 1:                       # L20: secondary queue empty?
                if self._cas_tail(me, None):       # L23
                    return
            else:
                sec_head = me.spin                 # L27
                if self._cas_tail(me, sec_head.sec_tail):  # L28
                    sec_head.spin = 1              # L31: pass lock to sec. head
                    self.stats.handovers += 1
                    self.stats.secondary_flushes += 1
                    return
            while me.next is None:                 # L36: wait for successor link
                time.sleep(0)

        # L38-49 + Section 6: hand the shared core a *lazy* view of the main
        # chain (walked only if the decision actually scans — the fast path
        # and FIFO grants stay O(1), mirroring the deque drivers' _DomainView;
        # interior links are stable and the chain only grows past the walked
        # tail, so the live walk is one valid linearization, exactly like the
        # paper's find_successor), then replay the decision on the pointers.
        # n_secondary is only branched on for emptiness (its exact value feeds
        # event payloads this driver discards), so the O(1) spin-field test
        # stands in for counting the chain.
        my_socket = me.socket
        if my_socket == -1:                        # L54 (uncontended acquirer)
            my_socket = self._numa_node_of()
        with self._rng_lock:
            d = decide(
                _chain_domains(me.next),
                1 if isinstance(me.spin, CNANode) else 0,
                my_socket,
                self._rng,
                self._cfg,
            )

        self.stats.handovers += 1
        if d.kind == "scan":                       # find_successor hit (L51-69)
            prev, succ = None, me.next
            for _ in range(d.index):               # re-walk the skipped prefix
                prev, succ = succ, succ.next
            if d.index:                            # skipped prefix -> secondary
                sec_head, sec_tail = me.next, prev
                if isinstance(me.spin, CNANode):   # L64: secondary non-empty
                    me.spin.sec_tail.next = sec_head  # L65
                else:
                    me.spin = sec_head             # L66
                sec_tail.next = None               # L67
                me.spin.sec_tail = sec_tail        # L68
                self.stats.shuffles += 1
            succ.spin = me.spin                    # L42 (never 0: 1 or node)
            self.stats.local_handovers += 1
        elif d.kind == "flush":                    # L43-46: secondary head next
            succ = me.spin
            succ.sec_tail.next = me.next           # L45: splice sec. queue in front
            succ.spin = 1                          # L46
            self.stats.secondary_flushes += 1
        else:                                      # "fifo" (L48) / "fast_path" (§6)
            me.next.spin = 1


class MCSLock:
    """Classic MCS lock (Mellor-Crummey & Scott 1991) — the paper's baseline."""

    def __init__(self) -> None:
        self.tail: CNANode | None = None
        self._atomic = threading.Lock()

    def acquire(self, me: CNANode) -> None:
        me.next = None
        me.spin = 0
        with self._atomic:
            tail, self.tail = self.tail, me
        if tail is None:
            me.spin = 1
            return
        tail.next = me
        while me.spin == 0:
            time.sleep(0)

    def release(self, me: CNANode) -> None:
        if me.next is None:
            with self._atomic:
                if self.tail is me:
                    self.tail = None
                    return
            while me.next is None:
                time.sleep(0)
        me.next.spin = 1


@dataclass
class _Shared:
    counter: int = 0
    per_thread: dict = field(default_factory=dict)


def run_lock_stress(
    lock_factory,
    n_threads: int,
    n_sockets: int | None = None,
    iters: int = 100,
    *,
    cs_work: int = 0,
    topology: Topology | None = None,
) -> _Shared:
    """Drive ``n_threads`` through acquire/CS/release cycles; return the shared
    cell for invariant checking (counter == n_threads * iters proves mutual
    exclusion held for the increment sequence).  Thread -> virtual-socket
    placement comes from ``topology`` (default: ``flat(n_sockets)``)."""

    if topology is None:
        topology = flat(n_sockets if n_sockets is not None else 2)
    elif n_sockets is not None and n_sockets != topology.n_domains:
        raise ValueError(
            f"n_sockets={n_sockets} conflicts with topology "
            f"{topology.name!r} ({topology.n_domains} domains); pass one"
        )
    tls = threading.local()

    def socket_of() -> int:
        return tls.socket

    lock = lock_factory(socket_of)
    shared = _Shared()

    def body(tid: int) -> None:
        tls.socket = topology.domain_of(tid)
        node = CNANode()
        for _ in range(iters):
            lock.acquire(node)
            # critical section: racy read-modify-write, only safe under mutex
            v = shared.counter
            for _ in range(cs_work):
                pass
            shared.counter = v + 1
            shared.per_thread[tid] = shared.per_thread.get(tid, 0) + 1
            lock.release(node)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return shared
