"""The port's threaded CNA lock (``repro_torch.core.cna``), on the CPU.

The counterparts of ``tests/test_cna_lock.py`` at its sizes: mutual
exclusion, the secondary-queue flush paths, shuffle reduction, the MCS
baseline, no starvation and locality stats.  Each stress runs in a daemon
thread joined with a timeout, so a lost wake-up fails the test instead of
hanging the run.
"""

import threading

import pytest

from repro_torch.core.cna import CNALock, CNANode, MCSLock, run_lock_stress

TIMEOUT_S = 60.0


def _stress(factory, n_threads, n_sockets, iters):
    """``run_lock_stress`` in a daemon thread; fails after ``TIMEOUT_S``."""
    box = {}

    def body():
        try:
            box["shared"] = run_lock_stress(factory, n_threads, n_sockets, iters=iters)
        except BaseException as e:  # surfaced in the test thread
            box["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(TIMEOUT_S)
    assert not t.is_alive(), f"lock stress did not finish within {TIMEOUT_S} s"
    if "error" in box:
        raise box["error"]
    return box["shared"]


@pytest.mark.parametrize("n_threads,n_sockets", [(2, 1), (4, 2), (8, 2), (9, 3), (16, 4)])
def test_mutual_exclusion(n_threads, n_sockets):
    shared = _stress(lambda sock: CNALock(numa_node_of=sock), n_threads, n_sockets, 300)
    assert shared.counter == n_threads * 300


def test_mutual_exclusion_small_threshold_exercises_flush_paths():
    shared = _stress(lambda sock: CNALock(numa_node_of=sock, threshold=1), 8, 2, 300)
    assert shared.counter == 8 * 300


def test_mutual_exclusion_shuffle_reduction():
    shared = _stress(
        lambda sock: CNALock(numa_node_of=sock, shuffle_reduction=True, threshold2=3), 8, 2, 300
    )
    assert shared.counter == 8 * 300


def test_mcs_baseline_mutual_exclusion():
    shared = _stress(lambda sock: MCSLock(), 8, 2, 300)
    assert shared.counter == 8 * 300


def test_no_starvation_every_thread_completes():
    shared = _stress(lambda sock: CNALock(numa_node_of=sock, threshold=0xF), 8, 2, 200)
    assert sorted(shared.per_thread.values()) == [200] * 8


def test_single_thread_uncontended_path_records_no_socket():
    lock = CNALock(numa_node_of=lambda: 7)
    node = CNANode()
    lock.acquire(node)
    assert node.socket == -1
    assert node.spin == 1
    lock.release(node)
    assert lock.tail is None


def _spin_until(cond):
    """Busy-wait on ``cond`` with the stress's timeout."""
    import time

    deadline = time.monotonic() + TIMEOUT_S
    while not cond():
        assert time.monotonic() < deadline, "interleaving did not form in time"


def test_handover_passes_secondary_head_through_spin_field():
    """Fig. 1 (a)-(b): holder on socket 0, queue = [remote(1), local(0)], so
    the remote waiter moves to the secondary queue and the local waiter gets
    its head through the spin field."""
    sockets = {}
    lock = CNALock(numa_node_of=lambda: sockets[threading.get_ident()])
    n_holder, n_remote, n_local = CNANode(), CNANode(), CNANode()
    order = []
    ready = threading.Barrier(3, timeout=TIMEOUT_S)
    release_holder = threading.Event()

    def holder():
        sockets[threading.get_ident()] = 0
        lock.acquire(n_holder)
        ready.wait()
        release_holder.wait(TIMEOUT_S)
        lock.release(n_holder)

    def remote():
        sockets[threading.get_ident()] = 1
        ready.wait()
        lock.acquire(n_remote)
        order.append("remote")
        lock.release(n_remote)

    def local():
        sockets[threading.get_ident()] = 0
        ready.wait()
        _spin_until(lambda: lock.tail is n_remote)  # enqueue after the remote
        lock.acquire(n_local)
        order.append("local")
        lock.release(n_local)

    ts = [threading.Thread(target=f, daemon=True) for f in (holder, remote, local)]
    for t in ts:
        t.start()
    _spin_until(lambda: n_remote.next is n_local)
    release_holder.set()
    for t in ts:
        t.join(TIMEOUT_S)
        assert not t.is_alive()
    assert order == ["local", "remote"]
    assert lock.stats.local_handovers >= 1
    assert lock.stats.shuffles >= 1
    assert lock.tail is None


def test_stats_locality_under_contention():
    holder = {}

    def factory(sock):
        holder["lock"] = CNALock(numa_node_of=sock)
        return holder["lock"]

    shared = _stress(factory, 8, 2, 400)
    assert shared.counter == 8 * 400
    stats = holder["lock"].stats
    if stats.handovers > 100:
        assert stats.local_handovers / stats.handovers > 0.5
