"""The port's engine with NUMA placement, the prefix index and derived homes
against the JAX package's engine, on the CPU.

Reduced granite in float32 on one torch thread, with the reference's
weights (``DecoderLM.init`` through ``convert.params_from_jax``), on both
admission paths (``batching=True`` and ``False``).  Each case is the
workload of a reference test:

* ``invariance``: ``tests/test_serving.py::
  test_placement_engine_outputs_invariant_and_telemetry``;
* ``matched_len``: ``tests/test_serving.py::
  test_matched_len_aware_prefill_skips_cached_positions`` (index + store);
* ``derived``: ``tests/test_prefixindex.py::
  test_engine_derives_homes_and_learns_from_placements``, two waves;
* ``derived_kv``: the same waves with a prefix-KV store as well;
* ``shedding``: ``tests/test_serving.py::
  test_engine_auto_wires_controller_shedding``, then run to the end.

Tokens, claim order, homes, ``matched_len``, ``sim_time``, the position and
store counters, ``compile_counts``, every placement-telemetry field, the
scheduler's locality counters and the index's state must be identical
(exact: every decision is integer host bookkeeping).  Reduced
recurrentgemma and mamba2 each take one per-request placement case against
a JAX engine whose ``cache_logical`` is corrected on the test's own model
instance (ROADMAP §C).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.core.topology as jax_topo  # noqa: E402
import repro.placement as jax_pl  # noqa: E402
from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import CNAScheduler as JaxCNAScheduler  # noqa: E402
import repro_torch.core.topology as port_topo  # noqa: E402
import repro_torch.placement as port_pl  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import CNAScheduler, DecodeEngine, PrefixIndex, Request  # noqa: E402
from repro_torch.serving.kvcache import SlotCache  # noqa: E402

JAX = dict(engine=JaxEngine, request=JaxRequest, scheduler=JaxCNAScheduler, topo=jax_topo,
           pl=jax_pl)
PORT = dict(engine=DecodeEngine, request=Request, scheduler=CNAScheduler, topo=port_topo,
            pl=port_pl)
CASES = ("invariance", "matched_len", "derived", "derived_kv", "shedding")
KEYS = ("tokens", "claims", "homes", "sim_time", "positions", "store", "compile_counts",
        "telemetry", "scheduler", "index")


def _port(name, n_layers=None, fix_jax_cache_logical=False):
    cfg = jax_reduced_config(name).replace(dtype="float32")
    tcfg = get_reduced_config(name).replace(dtype="float32")
    if n_layers:
        cfg, tcfg = cfg.replace(n_layers=n_layers), tcfg.replace(n_layers=n_layers)
    jmodel = jax_build_model(cfg)
    if fix_jax_cache_logical:
        jmodel.cache_logical = _structural_cache_logical(jmodel)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, (jmodel, jparams), (tmodel, tparams)


def _structural_cache_logical(jmodel):
    """The reference's ``cache_logical`` with the batch axis of every leaf
    read from the segment structure: axis 1 in a scanned segment, 0 in an
    unrolled one.  A copy of tests/test_torch_hybrid_engine.py's."""
    def fixed(cache_abstract):
        out = {}
        for seg in jmodel.segments:
            lead = ("layers",) if seg.mode == "scan" else ()
            out[seg.name] = jax.tree.map(
                lambda s, lead=lead: lead + ("batch",) + (None,) * (len(s.shape) - len(lead) - 1),
                cache_abstract[seg.name])
        out["pos"] = ()
        return out
    return fixed


@functools.lru_cache(maxsize=1)
def _granite():
    return _port("granite_3_8b")


def _telemetry(tel):
    if tel is None:
        return None
    out = dataclasses.asdict(tel)
    out.update(locality=tel.locality, spills=tel.spills, mean_handover=tel.mean_handover,
               prefix_hit_rate=tel.prefix_hit_rate, fairness=tel.fairness_factor())
    return out


def _shared_prefix_requests(Req, phase, n=6):
    """n requests over 3 shared 6-token prefixes with unique 2-token tails
    (tests/test_prefixindex.py's), homes left to the index."""
    prefixes = [[10 + p, 11 + p, 12 + p, 13 + p, 14 + p, 15 + p] for p in (0, 20, 40)]
    return [Req(rid=100 * phase + i,
                prompt=np.array(prefixes[i % 3] + [70 + 10 * phase + i, 80 + i], dtype=np.int32),
                max_new=3, domain=None)
            for i in range(n)]


def _engine(side, model, params, batching, **kw):
    eng = side["engine"](model, params, batching=batching, **kw)
    claims = []
    orig = eng.slots.claim

    def claim(owner, domain=None):
        slot = orig(owner, domain)
        claims.append((owner, domain, slot, eng.slots.last_domain, eng.slots.last_distance))
        return slot

    eng.slots.claim = claim
    return eng, claims


def _observed(eng, claims, reqs):
    store, idx, m = eng.prefix_kv, eng.prefix_index, eng.scheduler.metrics
    return {
        "tokens": [list(r.out) for r in reqs],
        "claims": claims,
        "homes": [(r.rid, r.domain, r.matched_len, r.submit_t, r.admit_t, r.finish_t)
                  for r in reqs],
        "sim_time": eng.sim_time,
        "positions": (eng.prefill_positions, eng.reused_positions, eng.kv_deposits),
        "store": None if store is None else (store.hits, store.misses, store.reused_tokens,
                                             list(store._lru)),
        "compile_counts": eng.compile_counts,
        "telemetry": _telemetry(eng.slots.telemetry),
        "scheduler": (m.admitted, m.local_admits, m.domain_switches, m.locality),
        "index": None if idx is None else (idx.summary(8), len(idx), idx.records, idx.lookups,
                                           idx.hits, eng.summary()),
    }


def _case(side, case, batching, model, params, vocab):
    Req, topo, Sched = side["request"], side["topo"], side["scheduler"]
    if case == "invariance":
        rng = np.random.default_rng(7)
        reqs = [Req(rid=i, prompt=rng.integers(0, vocab, 8).astype(np.int32), max_new=5,
                    domain=i % 4) for i in range(10)]
        eng, claims = _engine(side, model, params, batching, n_slots=4, cache_len=64,
                              scheduler=Sched(fairness_threshold=0xF, topology=topo.pod(2, 2)),
                              placement="nearest_spill")
        eng.run(reqs)
    elif case == "matched_len":
        rng = np.random.default_rng(12)
        shared = rng.integers(0, vocab, 12).astype(np.int32)
        reqs = [Req(rid=i, prompt=np.concatenate(
                    [shared, rng.integers(0, vocab, 4).astype(np.int32)]), max_new=3, domain=None)
                for i in range(3)]
        eng, claims = _engine(side, model, params, batching, n_slots=1, cache_len=64,
                              topology=topo.pod(1, 2), placement="nearest_spill",
                              prefix_index=True, prefix_kv=True)
        eng.run(reqs)
    elif case in ("derived", "derived_kv"):
        eng, claims = _engine(side, model, params, batching, n_slots=4, cache_len=64,
                              scheduler=Sched(fairness_threshold=0xF, topology=topo.pod(2, 2)),
                              placement="nearest_spill", prefix_index=True,
                              prefix_kv=True if case == "derived_kv" else None)
        reqs = _shared_prefix_requests(Req, 0)
        eng.run(reqs)
        wave2 = _shared_prefix_requests(Req, 1)
        eng.run(wave2)
        reqs += wave2
    else:
        ctl = side["pl"].AdaptiveController(initial=8)
        eng, claims = _engine(side, model, params, batching, n_slots=8, cache_len=32,
                              scheduler=Sched(topology=topo.pod(2, 2), max_active=ctl),
                              placement="nearest_spill")
        reqs = []
        for rid in range(5):  # homed at 0, admitted at once, none retires yet
            reqs.append(Req(rid=rid, prompt=np.arange(4, dtype=np.int32), max_new=30, domain=0))
            eng.submit(reqs[-1])
            eng.step()
        eng.run([])
    return _observed(eng, claims, reqs), eng


@functools.lru_cache(maxsize=None)
def _jax_observed(case, batching):
    cfg, (jmodel, jparams), _ = _granite()
    return _case(JAX, case, batching, jmodel, jparams, cfg.vocab)[0]


@functools.lru_cache(maxsize=None)
def _torch_run(case, batching):
    cfg, _, (tmodel, tparams) = _granite()
    return _case(PORT, case, batching, tmodel, tparams, cfg.vocab)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax_engine(case, batching, key):
    assert _torch_run(case, batching)[0][key] == _jax_observed(case, batching)[key]


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_placement_outputs_invariant_and_telemetry(batching):
    """Placement changes where caches live, never what is decoded: the
    tokens equal the placement-free port engine's, and the telemetry is the
    scheduler's."""
    cfg, _, (tmodel, tparams) = _granite()
    obs, eng = _torch_run("invariance", batching)
    tel = eng.slots.telemetry
    assert eng.scheduler.metrics.placement is tel
    assert tel.placements == tel.releases == 10
    assert tel.placements == tel.local_placements + tel.spills
    assert tel.handover_samples == 10
    assert sum(tel.per_domain_occupancy.values()) == 0
    rng = np.random.default_rng(7)
    base = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 8).astype(np.int32), max_new=5,
                    domain=i % 4) for i in range(10)]
    DecodeEngine(tmodel, tparams, n_slots=4, cache_len=64, batching=batching,
                 scheduler=CNAScheduler(fairness_threshold=0xF)).run(base)
    assert obs["tokens"] == [list(r.out) for r in base]


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_matched_len_skips_cached_positions(batching):
    """Each shared prefix is computed once; later prompts compute only their
    suffix, with the counts of the reference test.  The three are submitted
    together, so every home is derived from a cold index."""
    obs, eng = _torch_run("matched_len", batching)
    if not batching:
        assert eng.prefill_positions == 16 + 16 + 4
        assert eng.reused_positions == 12 and eng.prefix_kv.hits == 1
    assert [m for _, _, m, *_ in obs["homes"]] == [0, 0, 0]
    assert eng.slots.telemetry.derived_homes == 3 and eng.prefix_index.records >= 3


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_derived_homes_learn_from_placements(batching):
    obs, eng = _torch_run("derived", batching)
    tel = eng.slots.telemetry
    assert tel.derived_homes == 12
    assert all(m >= 6 for _, _, m, *_ in obs["homes"][6:])
    assert tel.prefix_hit_rate == pytest.approx(0.375)
    assert eng.summary()["prefixes"]


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_controller_sheds_before_spilling(batching):
    obs, eng = _torch_run("shedding", batching)
    tel = eng.slots.telemetry
    assert [d for _, d, *_ in obs["homes"]] == [0, 0, 1, 1, 0]
    assert tel.sheds == 2 and tel.cross_spills == 1 and tel.sibling_spills == 0
    assert tel.migration_cycles > 0


def test_derived_homes_match_an_oracle_caller():
    """The warm index's homes drive the same claim sequence an oracle caller
    passing those homes explicitly gets, and the matched-prefix discount
    never charges more (tests/test_prefixindex.py's contract)."""
    _, _, (tmodel, tparams) = _granite()
    obs_d, eng_d = _torch_run("derived", False)
    homes = {rid: dom for rid, dom, *_ in obs_d["homes"]}
    eng_o, claims_o = _engine(PORT, tmodel, tparams, False, n_slots=4, cache_len=64,
                              scheduler=CNAScheduler(fairness_threshold=0xF,
                                                     topology=port_topo.pod(2, 2)),
                              placement="nearest_spill")
    for phase in (0, 1):
        eng_o.run([Request(r.rid, r.prompt, r.max_new, domain=homes[r.rid])
                   for r in _shared_prefix_requests(Request, phase)])
    assert [c[:3] for c in obs_d["claims"]] == [c[:3] for c in claims_o]
    assert eng_d.sim_time <= eng_o.sim_time


def test_wiring_rules_match_reference():
    _, _, (tmodel, tparams) = _granite()
    with pytest.raises(ValueError, match="placement needs a topology"):
        DecodeEngine(tmodel, tparams, placement="nearest_spill")
    with pytest.raises(ValueError, match="prefix index needs placement"):
        DecodeEngine(tmodel, tparams, prefix_index=PrefixIndex())

    def placed(**kw):
        return DecodeEngine(tmodel, tparams, n_slots=4, cache_len=64,
                            scheduler=CNAScheduler(topology=port_topo.pod(2, 2)),
                            placement="nearest_spill", **kw)

    eng = placed(prefix_index=True)
    assert eng.prefix_index.n_domains == 4
    # a warm index handed to a new engine reads the new engine's telemetry
    eng2 = placed(prefix_index=eng.prefix_index)
    assert eng2.prefix_index.occupancy() is eng2.slots.telemetry.per_domain_occupancy
    with pytest.raises(ValueError, match="spans 4 domains"):
        DecodeEngine(tmodel, tparams, n_slots=4, cache_len=64,
                     scheduler=CNAScheduler(topology=port_topo.pod(1, 2)),
                     placement="nearest_spill", prefix_index=eng.prefix_index)
    ctl = port_pl.AdaptiveController(initial=8)
    for _ in range(2):  # reused controllers are rebound as well
        e = DecodeEngine(tmodel, tparams, n_slots=8, cache_len=32,
                         scheduler=CNAScheduler(topology=port_topo.pod(2, 2), max_active=ctl),
                         placement="nearest_spill")
        assert ctl.occupancy() is e.slots.telemetry.per_domain_occupancy
        assert ctl.domain_capacity == (2, 2, 2, 2) and ctl.shed_topology is e.scheduler.topology


def test_slot_cache_claim_validates_domain_and_exhaustion():
    _, _, (tmodel, _) = _granite()
    sc = SlotCache.zeros(tmodel, 2, 16, topology=port_topo.pod(1, 2))
    with pytest.raises(ValueError, match="domain=None"):
        sc.claim("a")
    with pytest.raises(ValueError, match="out of range"):
        sc.claim("a", 2)
    assert sc.free == [0, 1] and sc.slot_domain(1) == 1
    s0 = sc.claim("a", 1)
    sc.cache["pos"][s0] = 5
    assert (s0, sc.last_domain, sc.last_distance) == (1, 1, 0)
    s1 = sc.claim("b", 1)
    assert (s1, sc.last_domain, sc.last_distance) == (0, 0, 1)
    assert sc.last_migration_cycles > 0 and sc.n_free == 0 and sc.active == [0, 1]
    with pytest.raises(IndexError, match="exhausted"):
        sc.claim("c", 0)
    sc.release(s0)
    assert int(sc.cache["pos"][s0]) == 0 and sc.free == [1]
    assert sc.telemetry.releases == 1 and sc.telemetry.per_domain_occupancy == {0: 1, 1: 0}
    base = SlotCache.zeros(tmodel, 2, 16)
    assert base.claim("a", 1) == 0 and base.last_domain is None and base.slot_domain(0) is None
    base.claim("b")
    with pytest.raises(IndexError, match="exhausted"):
        base.claim("c")


def _recurrent_case(side, model, params, vocab, lens):
    rng = np.random.default_rng(3)
    reqs = [side["request"](rid=i, prompt=rng.integers(0, vocab, int(rng.choice(lens))).astype(
                np.int32), max_new=4, domain=int(rng.integers(0, 4))) for i in range(8)]
    eng, claims = _engine(side, model, params, False, n_slots=4, cache_len=80,
                          scheduler=side["scheduler"](topology=side["topo"].pod(2, 2)),
                          placement="nearest_spill")
    eng.run(reqs)
    return _observed(eng, claims, reqs)


@pytest.mark.parametrize("name,n_layers,lens", [("recurrentgemma_2b", 5, (6, 21, 40)),
                                                ("mamba2_130m", None, (2, 20, 45))])
def test_recurrent_families_per_request_placement(name, n_layers, lens):
    cfg, (jmodel, jparams), (tmodel, tparams) = _port(name, n_layers, fix_jax_cache_logical=True)
    want = _recurrent_case(JAX, jmodel, jparams, cfg.vocab, lens)
    got = _recurrent_case(PORT, tmodel, tparams, cfg.vocab, lens)
    for key in KEYS:
        assert got[key] == want[key], key
    assert got["telemetry"]["placements"] == 8 and got["telemetry"]["spills"] > 0


def test_serve_derived_homes_matches_reference_driver(capsys):
    """``repro_torch.launch.serve --derived-homes`` on the CPU prints the
    reference driver's numbers (the weights differ, the decisions do not
    read them); only the wall time and the device differ."""
    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve

    lines = []
    for main, argv in ((jax_serve.main, []), (serve.main, ["--device", "cpu"])):
        assert main(argv + ["--derived-homes", "--requests", "12"]) in (0, None)
        out = capsys.readouterr().out.strip().splitlines()
        lines.append([[f for f in line.split() if not f.startswith(("wall=", "device="))]
                      for line in out if line.startswith("[")])
    assert lines[1] == lines[0] and len(lines[1]) == 2
    assert all("derived=12" in line for line in lines[1])
