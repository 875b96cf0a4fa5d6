"""The port's serving engine against the JAX package's, on the CPU.

Both engines run ``DecodeEngine(batching=True)`` under the CNA scheduler on
the reduced granite config in float32 with the same weights (the
reference's ``DecoderLM.init`` through ``convert.params_from_jax``), the same
12 requests over two domains, and ``cache_len=64`` (the reduced config's
``attn_chunk``: ``supports_packed_prefill`` refuses a longer cache).  Greedy
tokens, admission order, ``sim_time``, ``prefill_positions``, scheduler
locality and switches, and ``compile_counts`` must be identical.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import CNAScheduler as JaxCNAScheduler  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import CNAScheduler, DecodeEngine, FIFOScheduler, Request  # noqa: E402
from repro_torch.serving.batching import PrefillBatcher, plan_packs, prompt_buckets  # noqa: E402
from repro_torch.serving.kvcache import SlotCache  # noqa: E402

CACHE_LEN = 64
N_SLOTS = 4
MAX_NEW = 6


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = jax_reduced_config("granite_3_8b").replace(dtype="float32")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("granite_3_8b").replace(dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _workload(seed=0, n=12):
    rng = np.random.default_rng(seed)
    vocab = _setup()[0].vocab
    out = []
    for i in range(n):
        length = int(rng.integers(2, CACHE_LEN - MAX_NEW - 1))
        out.append((i, rng.integers(0, vocab, length).astype(np.int32), int(rng.integers(0, 2))))
    return out


def _observed(eng, reqs):
    m = eng.scheduler.metrics
    return {
        "tokens": [list(r.out) for r in reqs],
        "order": sorted((r.admit_t, r.rid) for r in reqs),
        "finish": [r.finish_t for r in reqs],
        "sim_time": eng.sim_time,
        "prefill_positions": eng.prefill_positions,
        "locality": m.locality,
        "switches": m.domain_switches,
        "compile_counts": eng.compile_counts,
    }


@functools.lru_cache(maxsize=1)
def _jax_run():
    _, jmodel, jparams, _, _ = _setup()
    reqs = [JaxRequest(rid, prompt, MAX_NEW, dom) for rid, prompt, dom in _workload()]
    eng = JaxEngine(jmodel, jparams, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                    scheduler=JaxCNAScheduler(), batching=True)
    eng.run(reqs)
    return _observed(eng, reqs)


@functools.lru_cache(maxsize=1)
def _default_torch_run():
    return _torch_run()


def _torch_run(scheduler=None, batching=True, tracer=None):
    _, _, _, tmodel, tparams = _setup()
    reqs = [Request(rid, prompt, MAX_NEW, dom) for rid, prompt, dom in _workload()]
    eng = DecodeEngine(tmodel, tparams, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       scheduler=scheduler if scheduler is not None else CNAScheduler(),
                       batching=batching, tracer=tracer)
    eng.run(reqs)
    return eng, reqs


@pytest.mark.parametrize("key", [
    "tokens", "order", "finish", "sim_time", "prefill_positions", "locality",
    "switches", "compile_counts",
])
def test_engine_matches_jax_engine(key):
    eng, reqs = _default_torch_run()
    assert _observed(eng, reqs)[key] == _jax_run()[key]


def test_every_request_retires_with_max_new_tokens():
    eng, reqs = _default_torch_run()
    assert all(len(r.out) == MAX_NEW and r.finish_t >= r.admit_t >= 0 for r in reqs)
    assert not eng.active_req and not len(eng.scheduler)
    assert eng.slots.n_free == N_SLOTS
    assert eng.summary() == {"occupancy": 0, "capacity": N_SLOTS, "prefixes": ()}


def test_per_request_path_gives_the_batched_tokens():
    """batching=False (one prefill per admission) emits the same greedy
    tokens as the packed path on this workload."""
    _, preqs = _default_torch_run()
    single, sreqs = _torch_run(batching=False)
    assert [r.out for r in sreqs] == [r.out for r in preqs]
    assert single.compile_counts["decode"] == 1
    assert single.compile_counts["prefill"] == len({len(r.prompt) for r in sreqs})


def test_fifo_scheduler_admits_in_arrival_order():
    _, reqs = _torch_run(scheduler=FIFOScheduler())
    assert [rid for _, rid in sorted((r.admit_t, r.rid) for r in reqs)] == sorted(r.rid for r in reqs)


def test_tracer_records_a_closed_span_tree():
    from repro_torch.obs import Tracer

    tracer = Tracer()
    _, reqs = _torch_run(tracer=tracer)
    assert tracer.check() == []
    names = {sp.name for sp in tracer}
    assert {"request", "home_derivation", "queue_wait", "admit", "prefill", "decode"} <= names
    assert set(tracer.traces()) == {r.rid for r in reqs}


def test_unported_options_raise():
    _, _, _, tmodel, tparams = _setup()
    with pytest.raises(NotImplementedError):
        DecodeEngine(tmodel, tparams, n_slots=2, cache_len=CACHE_LEN, paging=True)


def test_submit_rejects_prompts_that_cannot_fit():
    _, _, _, tmodel, tparams = _setup()
    eng = DecodeEngine(tmodel, tparams, n_slots=2, cache_len=16)
    with pytest.raises(ValueError):
        eng.submit(Request(0, np.zeros(16, np.int32), 2))


def test_batcher_buckets_and_plan_match_reference():
    from repro.serving import batching as jb

    for cache_len in (2, 3, 16, 64, 100, 1024):
        assert prompt_buckets(cache_len) == jb.prompt_buckets(cache_len)
    lengths = [3, 17, 9, 33, 1, 60, 2]
    buckets = prompt_buckets(64)
    assert plan_packs(lengths, pack_width=3, buckets=buckets) == jb.plan_packs(
        lengths, pack_width=3, buckets=buckets)
    _, _, _, tmodel, _ = _setup()
    with pytest.raises(ValueError):
        PrefillBatcher(tmodel, cache_len=128, pack_width=2)  # above attn_chunk


def test_slot_cache_insert_extract_release():
    _, _, _, tmodel, tparams = _setup()
    slots = SlotCache.zeros(tmodel, 3, 32)
    logits, cache = tmodel.prefill(tparams, {"tokens": np.arange(5, dtype=np.int32)[None]})
    slot = slots.claim("a")
    slots.insert(slot, cache)
    out = slots.extract(slot)
    (k, _), = out["blocks"]
    (src, _), = cache["blocks"]
    assert k.shape[2] == 32 and int(out["pos"]) == 5
    np.testing.assert_array_equal(k[:, 0, :5].numpy(), src[:, 0, :5].numpy())
    assert not k[:, 0, 5:].any()
    fitted = slots.fit_single(cache)
    np.testing.assert_array_equal(fitted["blocks"][0][0].numpy(), k.numpy())
    slots.release(slot)
    assert int(slots.cache["pos"][slot]) == 0 and slots.n_free == 3
    with pytest.raises(ValueError):
        slots.extract(slot)


@pytest.mark.parametrize("argv", [
    ["--requests", "4", "--scheduler", "cna"],
    ["--requests", "4", "--arrivals", "1.0"],
])
def test_serve_driver_runs_on_cpu(argv, capsys):
    from repro_torch.launch.serve import main

    assert main(["--device", "cpu", "--max-new", "3", "--cache-len", "32"] + argv) == 0
    out = capsys.readouterr().out
    assert "tokens=12" in out and "device=cpu" in out
