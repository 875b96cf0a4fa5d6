"""The port's NUMA simulator and its eleven simulated locks against the
reference's, on the CPU.

``repro_torch.core.numasim`` and ``repro_torch.core.locks_sim`` are copies of
the reference's modules; every lock of ``ALL_LOCKS`` runs on the same seed,
cost model and thread counts through both, and the ``SimResult``s must be
equal field for field (exact: the simulators are integer event loops over a
seeded ``random.Random``).
"""

import dataclasses

import pytest

from repro.core import locks_sim as ref_locks
from repro.core import numasim as ref_sim
from repro_torch.core import locks_sim as port_locks
from repro_torch.core import numasim as port_sim

DUR = 2_000_000
THREADS = (1, 4, 9, 16)
COST_MODELS = ("TWO_SOCKET", "FOUR_SOCKET")


def _fields(results):
    return [dataclasses.asdict(r) for r in results]


def test_lock_tables_and_cost_models_match():
    assert list(port_locks.ALL_LOCKS) == list(ref_locks.ALL_LOCKS)
    assert len(port_locks.ALL_LOCKS) == 11
    for name in COST_MODELS:
        assert dataclasses.asdict(getattr(port_sim, name)) == dataclasses.asdict(
            getattr(ref_sim, name)
        )


@pytest.mark.parametrize("cm", COST_MODELS)
@pytest.mark.parametrize("lock", list(ref_locks.ALL_LOCKS))
def test_sweep_equals_reference(lock, cm):
    n_sockets = 4 if cm == "FOUR_SOCKET" else 2
    kw = dict(seed=11, duration_cycles=DUR)
    ref = ref_sim.run_sweep(
        ref_locks.ALL_LOCKS[lock], THREADS, n_sockets, getattr(ref_sim, cm), **kw
    )
    port = port_sim.run_sweep(
        port_locks.ALL_LOCKS[lock], THREADS, n_sockets, getattr(port_sim, cm), **kw
    )
    assert _fields(port) == _fields(ref)
    assert all(r.ops == sum(r.per_thread_ops) > 0 for r in port)


@pytest.mark.parametrize("cm", COST_MODELS)
@pytest.mark.parametrize("lock", list(ref_locks.ALL_LOCKS))
def test_oversubscribed_simulator_equals_reference(lock, cm):
    """One seeded ``Simulator`` per lock with more threads than cores (the
    preemption model and the restricted locks' parking), and a fixed
    non-critical-section length."""
    n_sockets = 4 if cm == "FOUR_SOCKET" else 2
    kw = dict(seed=5, duration_cycles=DUR, noncs_cycles=0, n_cores=6)

    def run(sim, locks):
        return sim.Simulator(
            locks.ALL_LOCKS[lock], 12, n_sockets, getattr(sim, cm), **kw
        ).run()

    assert dataclasses.asdict(run(port_sim, port_locks)) == dataclasses.asdict(
        run(ref_sim, ref_locks)
    )
