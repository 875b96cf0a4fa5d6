"""The port's placement layer (``repro_torch.placement``) against the
reference's, on the CPU.

Both packages' ``DomainFreeLists``, policies, ``PlacementTelemetry`` and
``AdaptiveController`` are driven side by side through the same seeded
claim/release and latency sequences; slots, domains, migration cycles and
every counter must be identical.  The adaptive lock simulator
(``AdaptiveRCNASim`` with a controller) must give the reference's results.
"""

import dataclasses
import random

import pytest

import repro.core.discipline as ref_discipline
import repro.core.locks_sim as ref_locks
import repro.core.numasim as ref_sim
import repro.core.topology as ref_topo
import repro.placement as ref_pl
import repro_torch.core.discipline as port_discipline
import repro_torch.core.locks_sim as port_locks
import repro_torch.core.numasim as port_sim
import repro_torch.core.topology as port_topo
import repro_torch.placement as port_pl

POLICIES = ("lowest_free", "home_domain", "nearest_spill")
TOPOLOGIES = {
    "pod2x2": lambda t: t.pod(2, 2),
    "pod1x2": lambda t: t.pod(1, 2),
    "flat3": lambda t: t.flat(3),
    "pod2x3": lambda t: t.pod(2, 3),
}
SIDES = ((ref_pl, ref_topo, ref_sim), (port_pl, port_topo, port_sim))


def _telemetry(tel) -> dict:
    out = dataclasses.asdict(tel)
    out.update(locality=tel.locality, spills=tel.spills, mean_handover=tel.mean_handover,
               prefix_hit_rate=tel.prefix_hit_rate, fairness=tel.fairness_factor())
    return out


def _churn(pl, topo_mod, sim, policy, topo_name, seed, n_slots=10, n_ops=300):
    """A seeded claim/release/handover sequence through one package's
    placement layer; returns everything it observed."""
    rng = random.Random(seed)
    topo = TOPOLOGIES[topo_name](topo_mod)
    fl = pl.DomainFreeLists(n_slots, topo)
    pol = pl.get_policy(policy)
    tel = pl.PlacementTelemetry(n_domains=topo.n_domains)
    ctl = pl.AdaptiveController(
        initial=4, max_cap=16, window=8, occupancy=lambda: tel.per_domain_occupancy,
        domain_capacity=fl.domain_capacity, shed_topology=topo,
    )
    live, seen = [], []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.55 and len(fl):
            home = ctl.shed_home(rng.randrange(topo.n_domains))
            p = pol.place(fl, home, sim.TWO_SOCKET if rng.random() < 0.5 else sim.FOUR_SOCKET)
            tel.record_placement(p)
            live.append(p.slot)
            seen.append(("claim", home, p.slot, p.slot_domain, p.distance,
                         p.migration_cycles, p.local))
        elif r < 0.9 and live:
            slot = live.pop(rng.randrange(len(live)))
            dom = fl.release(slot)
            tel.record_release(dom)
            seen.append(("release", slot, dom))
        else:
            lat = rng.choice([0, 40, 60, 70, 400, 10_060])
            tel.record_handover(lat)
            seen.append(("observe", ctl.observe(lat)))
        if rng.random() < 0.05:
            tel.record_derived_home(rng.randrange(8), 8)
        if rng.random() < 0.05:
            tel.record_shed()
        seen.append(("free", fl.free_slots(), [fl.free_count(d) for d in range(topo.n_domains)]))
    return {
        "seen": seen,
        "telemetry": _telemetry(tel),
        "spill_order": fl.spill_order,
        "capacity": fl.domain_capacity,
        "controller": (ctl.cap, ctl.samples, ctl.stalls, ctl.ewma, ctl.floor,
                       ctl.trajectory, ctl.stall_rate, ctl.settled_cap()),
    }


@pytest.mark.parametrize("topo_name", list(TOPOLOGIES))
@pytest.mark.parametrize("policy", POLICIES)
def test_seeded_churn_equals_reference(policy, topo_name):
    for seed in (0, 1, 2):
        ref, port = (_churn(*side, policy, topo_name, seed) for side in SIDES)
        assert port == ref
        assert any(s[0] == "claim" for s in port["seen"])


def test_errors_match_reference():
    for pl, topo_mod, _ in SIDES:
        fl = pl.DomainFreeLists(4, topo_mod.pod(2, 2))
        with pytest.raises(ValueError):
            fl.release(0)  # already free
        with pytest.raises(ValueError):
            fl.release(9)
        with pytest.raises(ValueError):
            pl.DomainFreeLists(2, topo_mod.pod(1, 2), slot_domain=[0, 5])
        with pytest.raises(KeyError):
            pl.get_policy("nope")
        with pytest.raises(TypeError):
            pl.get_policy(3)
        with pytest.raises(ValueError):
            pl.AdaptiveController(initial=0)
    assert sorted(port_pl.POLICIES) == sorted(ref_pl.POLICIES)


def test_explicit_slot_domain_map_equals_reference():
    out = []
    for pl, topo_mod, sim in SIDES:
        fl = pl.DomainFreeLists(6, topo_mod.pod(2, 2), slot_domain=[3, 3, 0, 1, 2, 0])
        pol = pl.get_policy(pl.NearestSpill)
        out.append([dataclasses.astuple(pol.place(fl, 3, sim.TWO_SOCKET)) for _ in range(6)]
                   + [fl.domain_capacity, pol.place(fl, 0) is None])
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", [3, 9])
def test_controller_trace_equals_reference(seed):
    rng = random.Random(seed)
    trace = [rng.choice([0, 60, 60, 70, 400, 10_060]) for _ in range(512)]
    out = []
    for pl, _, _ in SIDES:
        c = pl.AdaptiveController(initial=24, max_cap=32, window=16)
        caps = [c.observe(x) for x in trace]
        out.append((caps, c.trajectory, c.ewma, c.floor, c.stalls, c.settled_cap(),
                    c.settled_cap(0.5), [c.is_stall(x) for x in (0, 60, 10_000)]))
    assert out[0] == out[1]
    assert len(set(out[1][0])) > 1


def test_restricted_discipline_reads_port_controller_cap_live():
    ctrl = port_pl.AdaptiveController(initial=2, window=4, tolerance=0)
    r = port_discipline.RestrictedDiscipline(
        port_discipline.CNADiscipline(rng=random.Random(1)), max_active=ctrl
    )
    for i in range(6):
        r.arrive(i, 0)
    assert len(r.inner) == 2 and r.n_passive == 4
    for _ in range(4):
        ctrl.observe(10)
    assert r.max_active == 3
    assert r.release(0) is not None and len(r.inner) == 3


def test_cap_trajectories_identical_across_port_sim_and_scheduler():
    """One controller type drives the port's lock simulator and the port's
    scheduler; the same handover trace gives the same cap trajectory, and
    the reference's."""
    from repro_torch.serving.scheduler import CNAScheduler

    rng = random.Random(9)
    trace = [rng.choice([60, 60, 70, 400, 10_060]) for _ in range(512)]
    params = dict(initial=24, max_cap=32, window=16)
    sims = []
    for locks, sim, pl in ((ref_locks, ref_sim, ref_pl), (port_locks, port_sim, port_pl)):
        s = sim.Simulator(locks.AdaptiveRCNASim, n_threads=8, n_sockets=2,
                          lock_kwargs={"controller": pl.AdaptiveController(**params)})
        sims.append([s.lock.observe_handover(x) or s.lock.controller.cap for x in trace])
    sched = CNAScheduler(max_active=port_pl.AdaptiveController(**params))
    caps_sched = []
    for x in trace:
        sched.observe_handover(x)
        caps_sched.append(sched.controller.cap)
    assert sims[1] == sims[0] == caps_sched


@pytest.mark.parametrize("with_controller", [True, False])
def test_adaptive_sim_equals_reference(with_controller):
    """``AdaptiveRCNASim`` at 4x oversubscription: the port's run, the
    controller's trajectory included, equals the reference's, and the
    controller settles near the core count as the reference test pins.
    Without a controller the lock builds its own (the lazy import)."""
    kw = dict(n_threads=32, n_sockets=2, seed=42, duration_cycles=3_000_000,
              noncs_cycles=0, n_cores=8)
    out = []
    for locks, sim, pl in ((ref_locks, ref_sim, ref_pl), (port_locks, port_sim, port_pl)):
        lock_kwargs = {"threshold": 0xFF}
        if with_controller:
            lock_kwargs["controller"] = pl.AdaptiveController(initial=32, max_cap=32, window=16)
        s = sim.Simulator(locks.AdaptiveRCNASim, lock_kwargs=lock_kwargs, **kw)
        res = s.run()
        ctl = s.lock.controller
        assert type(ctl) is pl.AdaptiveController
        out.append((dataclasses.asdict(res), ctl.trajectory, ctl.cap))
    assert out[1] == out[0]
    if with_controller:
        assert out[1][2] <= 10
