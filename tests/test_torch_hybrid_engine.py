"""The port's slot cache and serving engine on the hybrid (RG-LRU) model.

Reduced recurrentgemma at 5 layers (a ``cyc`` segment of (rec, rec, attn),
plus ``tail3`` and ``tail4``, window 32) in float32, with the reference's
weights through ``convert.params_from_jax``.

The JAX engine is the oracle for admission order, counters and tokens, with
one correction made here and not in the reference: its ``SlotCache`` takes
each leaf's batch axis from ``DecoderLM.cache_logical``, whose rank rules
put the batch axis of the stacked recurrent leaves ((L, B, W) and
(L, B, K-1, W)) at 0 instead of 1, so with more than one slot its inserts
overwrite other slots' recurrent state and its tokens are not those of its
own per-request decode (ROADMAP §C).  The oracle engine here runs on a model
instance whose ``cache_logical`` names the batch axis from the segment
structure; the tokens are also held against the reference model's own
per-request greedy decode, which has no slot cache at all.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.scheduler import CNAScheduler as JaxCNAScheduler  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import CNAScheduler, DecodeEngine, Request  # noqa: E402
from repro_torch.serving.kvcache import SlotCache  # noqa: E402

N_LAYERS = 5
CACHE_LEN = 64
N_SLOTS = 4
MAX_NEW = 6
# prompt lengths drawn from a few values, so the JAX engine compiles few
# prefill shapes; two are past the window of 32 (ring layout, wrap in decode)
PROMPT_LENS = (6, 21, 40, 45)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = jax_reduced_config("recurrentgemma_2b").replace(n_layers=N_LAYERS, dtype="float32")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("recurrentgemma_2b").replace(n_layers=N_LAYERS, dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _workload(seed=0, n=10):
    rng = np.random.default_rng(seed)
    vocab = _setup()[0].vocab
    return [(i, rng.integers(0, vocab, int(rng.choice(PROMPT_LENS))).astype(np.int32),
             int(rng.integers(0, 2))) for i in range(n)]


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


def _structural_cache_logical(jmodel):
    """The reference's ``cache_logical`` with the batch axis of every leaf
    read from the segment structure: axis 1 in a scanned segment, 0 in an
    unrolled one (only the batch axis is read by its ``SlotCache``)."""
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
def _jax_run():
    cfg, _, jparams, _, _ = _setup()
    jmodel = jax_build_model(cfg)  # its own instance: the correction stays here
    jmodel.cache_logical = _structural_cache_logical(jmodel)
    reqs = [JaxRequest(rid, prompt, MAX_NEW, dom) for rid, prompt, dom in _workload()]
    eng = JaxEngine(jmodel, jparams, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                    scheduler=JaxCNAScheduler(), batching=False)
    eng.run(reqs)
    return _observed(eng, reqs)


@functools.lru_cache(maxsize=1)
def _torch_run():
    _, _, _, tmodel, tparams = _setup()
    reqs = [Request(rid, prompt, MAX_NEW, dom) for rid, prompt, dom in _workload()]
    eng = DecodeEngine(tmodel, tparams, n_slots=N_SLOTS, cache_len=CACHE_LEN,
                       scheduler=CNAScheduler(), batching=False)
    eng.run(reqs)
    return eng, reqs


@pytest.mark.parametrize("key", [
    "tokens", "order", "finish", "sim_time", "prefill_positions", "locality",
    "switches", "compile_counts",
])
def test_engine_matches_jax_engine(key):
    eng, reqs = _torch_run()
    assert _observed(eng, reqs)[key] == _jax_run()[key]


def test_engine_tokens_match_jax_per_request_decode():
    """Each request's greedy tokens are those of the reference model's own
    prefill and decode_step at batch 1, with no slot cache in between."""
    cfg, jmodel, jparams, _, _ = _setup()
    _, reqs = _torch_run()
    prefill, step = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    for r in reqs:
        logits, cache = prefill(jparams, {"tokens": jnp.asarray(r.prompt)[None]})
        toks = [int(jnp.argmax(logits[0]))]
        for _ in range(MAX_NEW - 1):
            logits, cache = step(jparams, cache, jnp.asarray([[toks[-1]]], jnp.int32))
            toks.append(int(jnp.argmax(logits[0])))
        assert r.out == toks, r.rid


def test_every_request_retires_and_slots_free():
    eng, reqs = _torch_run()
    assert all(len(r.out) == MAX_NEW and r.finish_t >= r.admit_t >= 0 for r in reqs)
    assert not eng.active_req and eng.slots.n_free == N_SLOTS
    assert any(len(r.prompt) > 32 for r in reqs)


def test_batching_refused_as_reference():
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    with pytest.raises(ValueError):
        DecodeEngine(tmodel, tparams, n_slots=2, cache_len=CACHE_LEN, batching=True)
    with pytest.raises(ValueError):
        JaxEngine(jmodel, jparams, n_slots=2, cache_len=CACHE_LEN, batching=True)


def test_slot_cache_axes_follow_the_structure():
    _, _, _, tmodel, _ = _setup()
    slots = SlotCache.zeros(tmodel, N_SLOTS, CACHE_LEN)
    # cyc: (h, conv) x 2 stacked, (k, v) stacked ring; tail3/tail4: (h, conv)
    assert slots.axes == [(1, None)] * 4 + [(1, 1)] * 2 + [(0, None)] * 4
    (h, conv), _, (k, v) = slots.cache["cyc"]
    assert tuple(h.shape) == (1, N_SLOTS, 64) and h.dtype == torch.float32
    assert tuple(conv.shape) == (1, N_SLOTS, 3, 64)
    assert tuple(k.shape) == (1, N_SLOTS, 32, 1, 16)  # ring: min(cache_len, window)
    assert tuple(slots.cache["tail4"][0].shape) == (N_SLOTS, 64)


def test_slot_cache_insert_extract_release_hybrid():
    """Insert two prefilled lanes (one past the window), extract them back
    leaf for leaf, and check an insert leaves every other lane untouched."""
    cfg, _, _, tmodel, tparams = _setup()
    slots = SlotCache.zeros(tmodel, 3, CACHE_LEN)
    rng = np.random.default_rng(3)
    singles = []
    for n in (44, 7):
        _, cache = tmodel.prefill(tparams, {"tokens": rng.integers(0, cfg.vocab, (1, n))})
        slot = slots.claim(n)
        before = [t.clone() for t in _tensors(slots.cache)]
        slots.insert(slot, cache)
        for t, b, (ax, _) in zip(_tensors(slots.cache), before, slots.axes):
            others = [i for i in range(3) if i != slot]
            assert torch.equal(t.index_select(ax, torch.tensor(others)),
                               b.index_select(ax, torch.tensor(others)))
        singles.append((slot, cache))
    for slot, cache in singles:
        out = slots.extract(slot)
        assert int(out["pos"]) == int(cache["pos"])
        for got, want in zip(_tensors(out), _tensors(cache)):
            assert torch.equal(got, want)  # ring 32 == min(64, 32): no fitting
        fitted = slots.fit_single(cache)
        for got, want in zip(_tensors(fitted), _tensors(out)):
            assert torch.equal(got, want)
    slot = singles[0][0]
    slots.release(slot)
    assert int(slots.cache["pos"][slot]) == 0 and slots.n_free == 2
    with pytest.raises(ValueError):
        slots.extract(slot)


def test_slot_cache_fits_ring_kv_to_a_shorter_cache():
    """cache_len below the window: the ring is cache_len long and only the
    KV leaves are trimmed; state leaves are copied whole."""
    cfg, _, _, tmodel, tparams = _setup()
    slots = SlotCache.zeros(tmodel, 2, 16)
    _, cache = tmodel.prefill(tparams, {"tokens": np.arange(10)[None]})
    slots.insert(1, cache)
    (h, conv), _, (k, _) = slots.cache["cyc"]
    (sh, sconv), _, (sk, _) = cache["cyc"]
    assert tuple(k.shape) == (1, 2, 16, 1, 16)
    assert torch.equal(k[:, 1], sk[:, 0, :16]) and torch.equal(h[:, 1], sh[:, 0])
    assert torch.equal(conv[:, 1], sconv[:, 0])


def _tensors(cache):
    from repro_torch.serving.kvcache import _tensors as tensors

    return tensors(cache)


@pytest.mark.parametrize("argv", [
    ["--arch", "recurrentgemma-2b", "--no-batching", "--requests", "4", "--scheduler", "cna"],
    ["--arch", "recurrentgemma-2b", "--no-batching", "--requests", "4", "--arrivals", "1.0"],
])
def test_serve_driver_runs_hybrid_on_cpu(argv, capsys):
    from repro_torch.launch.serve import main

    assert main(["--device", "cpu", "--max-new", "3", "--cache-len", "48"] + argv) == 0
    out = capsys.readouterr().out
    assert "tokens=12" in out and "device=cpu" in out
