"""The port's slot cache and serving engine on the SSM (Mamba-2) model.

Reduced mamba2 (2 SSD layers, chunk 32) in float32, with the reference's
weights through ``convert.params_from_jax``.

The JAX engine is the oracle for admission order, counters and tokens, with
one correction made here and not in the reference: its ``SlotCache`` takes
each leaf's batch axis from ``DecoderLM.cache_logical``, whose rank rule
names the stacked conv tail (L, B, K-1, C), a rank-4 leaf, as
("batch", None, None, None), which puts the batch axis on the layer axis, so
its inserts write the wrong lanes and its tokens after the first are not
those of its own per-request decode, with 1 slot or 4 (ROADMAP §C).  The
oracle engine here runs on a model instance whose ``cache_logical`` names
the batch axis from the segment structure; the tokens are also held against
the reference model's own per-request greedy decode, which has no slot
cache at all.
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
from repro_torch.serving.kvcache import SlotCache, _tensors  # noqa: E402

CACHE_LEN = 80  # above the longest prompt plus MAX_NEW: no request retires on length
N_SLOTS = 4
MAX_NEW = 6
# prompt lengths drawn from a few values, so the JAX engine compiles few
# prefill shapes: shorter than the conv tail (K-1 = 3), under one chunk of
# 32, two chunks exactly, and ragged over the chunk
PROMPT_LENS = (2, 20, 45, 64)


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = jax_reduced_config("mamba2_130m").replace(dtype="float32")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("mamba2_130m").replace(dtype="float32")
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
    unrolled one (only the batch axis is read by its ``SlotCache``).  A copy
    of tests/test_torch_hybrid_engine.py's."""
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


@functools.lru_cache(maxsize=2)
def _torch_run(n_slots=N_SLOTS):
    _, _, _, tmodel, tparams = _setup()
    reqs = [Request(rid, prompt, MAX_NEW, dom) for rid, prompt, dom in _workload()]
    eng = DecodeEngine(tmodel, tparams, n_slots=n_slots, cache_len=CACHE_LEN,
                       scheduler=CNAScheduler(), batching=False)
    eng.run(reqs)
    return eng, reqs


@functools.lru_cache(maxsize=1)
def _jax_per_request_tokens():
    """Each request's greedy tokens from the reference model's own prefill
    and decode_step at batch 1, with no slot cache in between."""
    _, jmodel, jparams, _, _ = _setup()
    prefill, step = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)
    out = []
    for _, prompt, _ in _workload():
        logits, cache = prefill(jparams, {"tokens": jnp.asarray(prompt)[None]})
        toks = [int(jnp.argmax(logits[0]))]
        for _ in range(MAX_NEW - 1):
            logits, cache = step(jparams, cache, jnp.asarray([[toks[-1]]], jnp.int32))
            toks.append(int(jnp.argmax(logits[0])))
        out.append(toks)
    return out


@pytest.mark.parametrize("key", [
    "tokens", "order", "finish", "sim_time", "prefill_positions", "locality",
    "switches", "compile_counts",
])
def test_engine_matches_jax_engine(key):
    eng, reqs = _torch_run()
    assert _observed(eng, reqs)[key] == _jax_run()[key]


@pytest.mark.parametrize("n_slots", [1, N_SLOTS])
def test_engine_tokens_match_jax_per_request_decode(n_slots):
    _, reqs = _torch_run(n_slots)
    assert [r.out for r in reqs] == _jax_per_request_tokens()


def test_reference_cache_logical_misplaces_stacked_conv_tail():
    """The reference fault the oracle engine corrects: its rank rule puts
    the batch axis of the stacked conv tail (L, B, K-1, C) on the layer axis;
    the stacked SSD state (L, B, H, P, N) is named correctly.  The port names
    both from the structure."""
    _, jmodel, _, tmodel, _ = _setup()
    (jstate, jconv), = jmodel.cache_logical(jmodel.cache_abstract(2, CACHE_LEN))["blocks"]
    assert jconv.index("batch") == 0 and jstate.index("batch") == 1
    (tstate, tconv), = tmodel.cache_logical()["blocks"]
    assert tconv.index("batch") == 1 and tstate.index("batch") == 1


def test_every_request_retires_and_slots_free():
    eng, reqs = _torch_run()
    assert all(len(r.out) == MAX_NEW and r.finish_t >= r.admit_t >= 0 for r in reqs)
    assert not eng.active_req and eng.slots.n_free == N_SLOTS
    assert {len(r.prompt) for r in reqs} == set(PROMPT_LENS)


def test_batching_refused_as_reference():
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    with pytest.raises(ValueError):
        DecodeEngine(tmodel, tparams, n_slots=2, cache_len=CACHE_LEN, batching=True)
    with pytest.raises(ValueError):
        JaxEngine(jmodel, jparams, n_slots=2, cache_len=CACHE_LEN, batching=True)


def test_slot_cache_axes_follow_the_structure():
    cfg, _, _, tmodel, _ = _setup()
    slots = SlotCache.zeros(tmodel, N_SLOTS, CACHE_LEN)
    # blocks: (s, conv) stacked over the 2 layers; neither is fitted along a sequence
    assert slots.axes == [(1, None), (1, None)]
    (s, conv), = slots.cache["blocks"]
    assert tuple(s.shape) == (2, N_SLOTS, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    assert s.dtype == torch.float32
    assert tuple(conv.shape) == (2, N_SLOTS, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)


def test_slot_cache_insert_extract_release_ssm():
    """Insert two prefilled lanes, extract them back leaf for leaf, and check
    an insert leaves every other lane untouched."""
    cfg, _, _, tmodel, tparams = _setup()
    slots = SlotCache.zeros(tmodel, 3, CACHE_LEN)
    rng = np.random.default_rng(3)
    singles = []
    for n in (45, 2):
        _, cache = tmodel.prefill(tparams, {"tokens": rng.integers(0, cfg.vocab, (1, n))})
        slot = slots.claim(n)
        before = [t.clone() for t in _tensors(slots.cache)]
        slots.insert(slot, cache)
        others = torch.tensor([i for i in range(3) if i != slot])
        for t, b, (ax, _) in zip(_tensors(slots.cache), before, slots.axes):
            assert torch.equal(t.index_select(ax, others), b.index_select(ax, others))
        singles.append((slot, cache))
    for slot, cache in singles:
        out = slots.extract(slot)
        assert int(out["pos"]) == int(cache["pos"])
        for got, want in zip(_tensors(out), _tensors(cache)):
            assert torch.equal(got, want)  # state is copied whole, never fitted
        for got, want in zip(_tensors(slots.fit_single(cache)), _tensors(out)):
            assert torch.equal(got, want)
    slot = singles[0][0]
    slots.release(slot)
    assert int(slots.cache["pos"][slot]) == 0 and slots.n_free == 2
    with pytest.raises(ValueError):
        slots.extract(slot)


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2-130m", "--no-batching", "--requests", "4", "--scheduler", "cna"],
    ["--arch", "mamba2-130m", "--no-batching", "--requests", "4", "--arrivals", "1.0"],
])
def test_serve_driver_runs_ssm_on_cpu(argv, capsys):
    from repro_torch.launch.serve import main

    assert main(["--device", "cpu", "--max-new", "3", "--cache-len", "48"] + argv) == 0
    out = capsys.readouterr().out
    assert "tokens=12" in out and "device=cpu" in out
