"""[PyTorch port: a copy of ``repro.core.numasim``, kept here so the port imports
nothing of the JAX package.]

Deterministic discrete-event NUMA simulator for lock-algorithm evaluation.

The paper evaluates CNA on 2- and 4-socket Xeons.  This container has one CPU
core, so wall-clock lock benchmarks are meaningless; instead we reproduce the
paper's *dynamics* with a seeded discrete-event simulation whose cost model has
exactly the ingredients the paper reasons about:

  * an atomic RMW (SWAP/CAS) on the lock word,
  * cache-line transfer latency, local (same socket) vs remote (cross socket),
  * per-critical-section shared-data lines whose home socket follows the last
    writer (this is what makes NUMA-aware *admission order* matter),
  * global-spinning coherence storms that scale with the number of spinners
    (TAS/ticket/HBO), vs local spinning (MCS/CNA/cohort),
  * queue-node scan costs for CNA's find_successor.

Time is in CPU cycles; throughput is reported in ops/us assuming ``freq_ghz``.
Everything is driven by one ``random.Random(seed)`` => bit-for-bit
reproducible.  The simulator is intentionally *not* a cycle-accurate cache
model — it is the smallest model that exhibits the paper's phenomena
(Figs. 6-10): MCS collapse from 1->2 threads, flat MCS under contention,
CNA == MCS single-thread, CNA ~ hierarchical locks contended, fairness factors,
and remote-miss-rate separation.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field, replace

from .topology import Topology, flat


@dataclass(frozen=True)
class CostModel:
    """Cycle costs.  Presets calibrated against the paper's two machines."""

    freq_ghz: float = 2.3
    c_atomic: int = 30          # uncontended atomic RMW
    c_l1: int = 8               # hit on socket-local (or own) line
    c_local_xfer: int = 60      # cache-line transfer within a socket
    c_remote_xfer: int = 400    # cache-line transfer across sockets
    c_cross_xfer: int = 1000    # cache-line transfer across groups (e.g. pods)
    c_storm: int = 18           # extra per-spinner cost for global spinning
    c_scan_local: int = 10      # CNA find_successor: inspect local node
    c_scan_remote: int = 70     # CNA find_successor: inspect remote node
    c_preempt: int = 10_000     # effective cycles lost when the grantee was
                                # descheduled (oversubscription, n_cores set).
                                # Fitted against the published GCR collapse
                                # curves — an order-of-magnitude throughput
                                # drop at 2x oversubscription (Dice & Kogan
                                # 2019, Figs. 1-2); the grid fit lives in
                                # benchmarks/restriction_bench.py calibrate()
                                # and asserts this default stays the argmin.
    cs_base: int = 450          # critical-section compute (AVL ops etc.)
    n_write_lines: int = 2      # shared lines written per CS (migrate w/ owner)
    n_read_lines: int = 4       # shared lines read per CS (miss if dirty-remote)
    noncs_base: int = 150       # non-critical work between ops ("external work")

    def xfer(self, s_from: int, s_to: int) -> int:
        return self.c_local_xfer if s_from == s_to else self.c_remote_xfer


# Two machines from the paper (Section 7).  The 4-socket machine has a higher
# remote-miss cost — the paper infers this from the deeper 1->2 thread drop.
TWO_SOCKET = CostModel()
FOUR_SOCKET = replace(TWO_SOCKET, c_remote_xfer=700, c_scan_remote=100)


@dataclass
class SimResult:
    name: str
    n_threads: int
    n_sockets: int
    ops: int
    cycles: int
    per_thread_ops: list[int] = field(default_factory=list)
    remote_transfers: int = 0
    local_transfers: int = 0
    handovers: int = 0
    shuffles: int = 0
    preemptions: int = 0

    @property
    def throughput_ops_per_us(self) -> float:
        if self.cycles == 0:
            return 0.0
        us = self.cycles / (TWO_SOCKET.freq_ghz * 1000.0)
        return self.ops / us

    @property
    def fairness_factor(self) -> float:
        """Paper Section 7.1.1: sort per-thread op counts descending; fraction
        of total ops done by the top half of threads.  0.5 = strictly fair."""
        counts = sorted(self.per_thread_ops, reverse=True)
        total = sum(counts)
        if total == 0:
            return 1.0
        half = max(1, len(counts) // 2)
        return sum(counts[:half]) / total

    @property
    def remote_rate(self) -> float:
        """Remote cache-line transfers per operation — the LLC-miss proxy."""
        return self.remote_transfers / max(1, self.ops)


class LockSim:
    """Base class for simulated lock disciplines.

    Subclasses see only: thread arrival, release, and the shared RNG/cost
    model; they return grant decisions and charge transfer costs through
    the provided ``charge`` callbacks so accounting stays centralised.
    """

    name = "base"

    def __init__(self, sim: "Simulator") -> None:
        self.sim = sim
        self.cm = sim.cm
        self.rng = sim.rng
        # tids currently passivated (blocked in the kernel, not runnable);
        # maintained by concurrency-restricting disciplines, read by the
        # simulator's oversubscription/preemption model.
        self.parked: set[int] = set()

    # returns cycles-until-grant if the arriving thread acquires immediately,
    # or None if it must wait.
    def arrive(self, tid: int) -> int | None:
        raise NotImplementedError

    # returns (next_tid, handover_cycles) or None if the lock becomes free.
    def release(self, tid: int) -> tuple[int, int] | None:
        raise NotImplementedError

    # Called by the event loop with the *total* handover latency (discipline
    # cost + any preemption penalty) after every handover.  Adaptive locks
    # forward this to their concurrency controller; the default is a no-op.
    def observe_handover(self, cycles: int) -> None:
        pass

    def socket(self, tid: int) -> int:
        return self.sim.socket_of(tid)


class Simulator:
    """Event loop.  Threads cycle: non-CS work -> arrive -> (wait) -> CS -> release."""

    def __init__(
        self,
        lock_cls,
        n_threads: int,
        n_sockets: int | None = None,
        cm: CostModel | None = None,
        *,
        seed: int = 42,
        duration_cycles: int = 20_000_000,
        noncs_cycles: int | None = None,
        lock_kwargs: dict | None = None,
        topology: Topology | None = None,
        n_cores: int | None = None,
    ) -> None:
        if topology is None:
            topology = flat(n_sockets if n_sockets is not None else 2)
        elif n_sockets is not None and n_sockets != topology.n_domains:
            raise ValueError(
                f"n_sockets={n_sockets} conflicts with topology "
                f"{topology.name!r} ({topology.n_domains} domains); pass one"
            )
        self.topology = topology
        self.cm = cm or TWO_SOCKET
        self.rng = random.Random(seed)
        self.n_threads = n_threads
        self.n_sockets = topology.n_domains
        self.duration = duration_cycles
        self.noncs = self.cm.noncs_base if noncs_cycles is None else noncs_cycles
        # n_cores models oversubscription: when more threads are runnable than
        # cores, a granted thread may have been descheduled and eats a quantum
        # (c_preempt) before it notices the handover — the collapse mechanism
        # concurrency restriction exists to avoid.  None disables the model.
        self.n_cores = n_cores
        self.lock = lock_cls(self, **(lock_kwargs or {}))
        # shared-data line ownership (tid of last writer); -1 = clean.
        # Core granularity matters: a line written by another core on the
        # *same* socket still costs an L2/LLC transfer (c_local_xfer), which
        # is why contended-local CS is slower than single-thread CS.
        self._write_owner = [-1] * self.cm.n_write_lines
        self._read_dirty = [-1] * self.cm.n_read_lines
        self.result = SimResult(
            name=self.lock.name,
            n_threads=n_threads,
            n_sockets=self.n_sockets,  # topology's domain count, never None
            ops=0,
            cycles=0,
            per_thread_ops=[0] * n_threads,
        )
        self._events: list[tuple[int, int, str, int]] = []  # (time, seq, kind, tid)
        self._seq = 0

    # Thread placement is the topology's business (the paper does not pin
    # threads; flat round-robin approximates a loaded scheduler's spread).
    def socket_of(self, tid: int) -> int:
        return self.topology.domain_of(tid)

    # -- accounting helpers used by lock disciplines -------------------------
    def charge_xfer(self, s_from: int, s_to: int) -> int:
        if s_from == s_to:
            self.result.local_transfers += 1
            return self.cm.c_local_xfer
        self.result.remote_transfers += 1
        return self.topology.xfer_cycles(self.cm, s_from, s_to)

    def preempt_penalty(self) -> int:
        """Grantee-wakeup penalty under oversubscription (0 if n_cores unset,
        so pre-existing seeds consume an identical RNG stream)."""
        if self.n_cores is None:
            return 0
        runnable = self.n_threads - len(self.lock.parked)
        if runnable <= self.n_cores:
            return 0
        if self.rng.random() < 1.0 - self.n_cores / runnable:
            self.result.preemptions += 1
            return self.cm.c_preempt
        return 0

    def _push(self, t: int, kind: str, tid: int) -> None:
        self._seq += 1
        heapq.heappush(self._events, (t, self._seq, kind, tid))

    def _cs_cycles(self, tid: int) -> int:
        """Critical-section cost under the data-locality model."""
        s = self.socket_of(tid)
        cm = self.cm
        c = cm.cs_base

        def line_cost(owner_tid: int) -> int:
            if owner_tid in (-1, tid):
                return cm.c_l1
            return self.charge_xfer(self.socket_of(owner_tid), s)

        for i in range(cm.n_write_lines):
            c += line_cost(self._write_owner[i])
            self._write_owner[i] = tid
        for i in range(cm.n_read_lines):
            c += line_cost(self._read_dirty[i])
            self._read_dirty[i] = -1  # read pulls the line into shared state
        # occasionally a read line is written (update ops) => dirty again
        if self.rng.random() < 0.25:
            self._read_dirty[self.rng.randrange(cm.n_read_lines)] = tid
        return c

    def _noncs_cycles(self) -> int:
        if self.noncs == 0:
            return self.rng.randrange(20, 60)  # loop overhead/jitter
        return int(self.noncs * self.rng.uniform(0.9, 1.1))

    # -- main loop ------------------------------------------------------------
    def run(self) -> SimResult:
        for tid in range(self.n_threads):
            self._push(self._noncs_cycles(), "arrive", tid)
        now = 0
        while self._events:
            now, _, kind, tid = heapq.heappop(self._events)
            if now >= self.duration:
                break
            if kind == "arrive":
                delay = self.lock.arrive(tid)
                if delay is not None:
                    self._push(now + delay, "enter", tid)
            elif kind == "enter":  # lock granted; run the critical section
                self._push(now + self._cs_cycles(tid), "release", tid)
            elif kind == "release":
                self.result.ops += 1
                self.result.per_thread_ops[tid] += 1
                nxt = self.lock.release(tid)
                if nxt is not None:
                    ntid, cost = nxt
                    cost += self.preempt_penalty()
                    self.result.handovers += 1
                    self.lock.observe_handover(cost)
                    self._push(now + cost, "enter", ntid)
                self._push(now + self._noncs_cycles(), "arrive", tid)
        self.result.cycles = min(now, self.duration)
        return self.result


def run_sweep(
    lock_cls,
    thread_counts,
    n_sockets: int | None = None,
    cm: CostModel | None = None,
    *,
    seed: int = 42,
    duration_cycles: int = 20_000_000,
    noncs_cycles: int | None = None,
    lock_kwargs: dict | None = None,
    topology: Topology | None = None,
    n_cores: int | None = None,
) -> list[SimResult]:
    out = []
    for n in thread_counts:
        sim = Simulator(
            lock_cls,
            n,
            n_sockets,
            cm,
            seed=seed,
            duration_cycles=duration_cycles,
            noncs_cycles=noncs_cycles,
            lock_kwargs=lock_kwargs,
            topology=topology,
            n_cores=n_cores,
        )
        out.append(sim.run())
    return out
