"""The port's prefix-KV reuse against the JAX package's, on the CPU.

The store (a copy), continuation prefill, the batcher's continuation rows
and the engine's three admission routes (full hit, partial hit through the
continuation pack or the per-request resume loop, boundary plant), the
retirement deposits and the KV-shipping hooks.  Reduced granite in float32
on one torch thread, with the reference's weights (``DecoderLM.init``
through ``convert.params_from_jax``); reduced recurrentgemma and mamba2 for
the per-request path.

Tolerances, float32: the port against JAX 1e-4 (atol and rtol), the port's
continuation against its own fresh packed prefill 1e-5.  Cache writes
(``_scatter_rows``, untouched rows, ``pos``) are exact.  The engines
compare exactly: tokens, order, counters and signature counts.

The port writes caches in place, where the reference builds new arrays, so
the aliasing tests pin that a stored entry is never written: it stays
bitwise equal to a clone taken when it was stored, whatever the engine does
with its prefix afterwards.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models import transformer as jax_tfm  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.serving.batching import PrefillBatcher as JaxBatcher  # noqa: E402
from repro.serving.engine import DecodeEngine as JaxEngine  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.kvcache import SlotCache as JaxSlotCache  # noqa: E402
from repro.serving.prefixkv import PrefixKVStore as JaxStore  # noqa: E402
from repro.serving.scheduler import CNAScheduler as JaxCNAScheduler  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.serving import CNAScheduler, DecodeEngine, PrefixKVStore, Request  # noqa: E402
from repro_torch.serving.batching import PrefillBatcher  # noqa: E402
from repro_torch.serving.kvcache import SlotCache, _tensors  # noqa: E402

JAX_TOL = 1e-4
SELF_TOL = 1e-5
CACHE_LEN = 64
PACK = 4


def _port(name, n_layers=None):
    cfg = jax_reduced_config(name).replace(dtype="float32")
    tcfg = get_reduced_config(name).replace(dtype="float32")
    if n_layers:
        cfg, tcfg = cfg.replace(n_layers=n_layers), tcfg.replace(n_layers=n_layers)
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


@functools.lru_cache(maxsize=1)
def _setup():
    return _port("granite_3_8b")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _entries(store):
    """(key, cache, logits) of every stored entry, in LRU order."""
    return [(key, cache, logits) for key, (cache, logits) in store._lru.items()]


def _snapshot(store):
    """Each entry's own tensors beside clones of them."""
    return [(key, cache, logits, [t.clone() for t in _tensors(cache)], cache["pos"].clone(),
             logits.clone()) for key, cache, logits in _entries(store)]


def _unchanged(snapshot):
    """Keys whose entry is no longer bitwise what it was when snapshotted."""
    return [key for key, cache, logits, ts, pos, lg in snapshot
            if not (all(torch.equal(a, b) for a, b in zip(_tensors(cache), ts))
                    and torch.equal(cache["pos"], pos) and torch.equal(logits, lg))]


# ---------------------------------------------------------------------------
# the store (a copy of the reference's)
# ---------------------------------------------------------------------------

def _store_ops(seed, n=60):
    """A seeded sequence of store operations over short token runs that
    share prefixes, so hits, misses, common runs and evictions all occur."""
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(0, 4, 12)]
    ops = []
    for i in range(n):
        cut = int(rng.integers(0, 12))
        tokens = base[:cut] + [int(t) for t in rng.integers(0, 4, int(rng.integers(0, 4)))]
        ops.append((["put", "longest", "peek", "common_run", "get"][int(rng.integers(0, 5))],
                    tokens, i))
    return ops


@pytest.mark.parametrize("seed,capacity,min_plant", [(0, 3, 4), (1, 5, 2), (2, 1, 4), (3, 16, 1)])
def test_store_matches_reference(seed, capacity, min_plant):
    ours, ref = PrefixKVStore(capacity, min_plant=min_plant), JaxStore(capacity, min_plant=min_plant)
    for op, tokens, i in _store_ops(seed):
        if op == "put":
            ours.put(tokens, f"c{i}", f"l{i}")
            ref.put(tokens, f"c{i}", f"l{i}")
        else:
            assert getattr(ours, op)(tokens) == getattr(ref, op)(tokens), (op, tokens)
        assert list(ours._lru.items()) == list(ref._lru.items())  # keys, values, LRU order
        assert (ours.hits, ours.misses, ours.reused_tokens) == (ref.hits, ref.misses, ref.reused_tokens)
        assert len(ours) == len(ref) and (tokens in ours) == (tokens in ref)
    ours.clear()
    assert len(ours) == 0


def test_store_exact_prefix_lookup_and_lru():
    s = PrefixKVStore(capacity=2)
    s.put([1, 2, 3], "c123", "l123")
    s.put([1, 2], "c12", "l12")
    assert s.longest([1, 2, 3, 4]) == (3, "c123", "l123")
    assert s.longest([1, 2, 9]) == (2, "c12", "l12")
    assert s.longest([9, 9]) is None
    assert s.common_run([1, 2, 9]) == 2
    s.put([7, 7, 7], "c777", "l777")
    assert len(s) == 2 and [1, 2, 3] not in s
    with pytest.raises(ValueError):
        PrefixKVStore(capacity=0)


# ---------------------------------------------------------------------------
# continuation prefill
# ---------------------------------------------------------------------------

def test_scatter_rows_matches_reference():
    """Exact: both copy the suffix K/V into the columns; row 2 has length 0
    and row 3 a start past the suffix's reach of the cache's end."""
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((4, 16, 2, 8), dtype=np.float32)
    new = rng.standard_normal((4, 5, 2, 8), dtype=np.float32)
    start, length = np.array([0, 7, 3, 13], np.int32), np.array([5, 2, 0, 3], np.int32)
    want = jax_tfm._scatter_rows(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(start),
                                 jnp.asarray(length))
    tcache = torch.from_numpy(cache.copy())
    got = tfm._scatter_rows(tcache, torch.from_numpy(new), torch.from_numpy(start),
                            torch.from_numpy(length))
    assert got is tcache  # written in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[2].numpy(), cache[2])


def test_attn_rows_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 6, 4, 8), dtype=np.float32)
    k = rng.standard_normal((3, 20, 2, 8), dtype=np.float32)
    v = rng.standard_normal((3, 20, 2, 8), dtype=np.float32)
    start = np.array([0, 9, 14], np.int32)
    want = jax_tfm._attn_rows(*(jnp.asarray(a) for a in (q, k, v, start)))
    got = tfm._attn_rows(*(torch.from_numpy(a) for a in (q, k, v, start)))
    _close(got, want, JAX_TOL)


# (full length, seeded prefix) per row; the last has no suffix (length 0)
CONT_ROWS = [(30, 12), (9, 1), (40, 33), (7, 7)]


def _cont_inputs(seed=3):
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in CONT_ROWS]
    jslots, tslots = JaxSlotCache.zeros(jmodel, PACK, CACHE_LEN), SlotCache.zeros(tmodel, PACK, CACHE_LEN)
    jrows, trows = [], []
    for p, (_, m) in zip(prompts, CONT_ROWS):
        jrows.append(jslots.fit_single(jmodel.prefill(jparams, {"tokens": jnp.asarray(p[:m])[None]})[1]))
        trows.append(tslots.fit_single(tmodel.prefill(tparams, {"tokens": p[:m][None]})[1]))
    suffixes = [p[m:] for p, (_, m) in zip(prompts, CONT_ROWS)]
    return prompts, jrows, trows, suffixes


def test_prefill_cont_matches_reference():
    """Logits of the rows with a suffix, every cache leaf and ``pos``; the
    length-0 row's KV is exactly its seed."""
    _, jmodel, jparams, tmodel, tparams = _setup()
    _, jrows, trows, suffixes = _cont_inputs()
    jb = JaxBatcher(jmodel, cache_len=CACHE_LEN, pack_width=PACK)
    tb = PrefillBatcher(tmodel, cache_len=CACHE_LEN, pack_width=PACK)
    toks, lens = tb.pack_tokens(suffixes)
    jl, jc = jmodel.prefill_cont(jparams, jb._stack(jrows), jnp.asarray(toks), jnp.asarray(lens))
    seeded = tb._stack(trows)
    tl, tc = tmodel.prefill_cont(tparams, seeded, toks, lens)
    real = lens > 0
    _close(tl[real], np.asarray(jl)[real], JAX_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for got, want in zip(_tensors(tc), jax.tree.leaves({k: v for k, v in jc.items() if k != "pos"})):
        _close(got, want, JAX_TOL)
    (k, v), = tc["blocks"]
    (k0, v0), = trows[3]["blocks"]
    assert torch.equal(k[:, 3:4], k0) and torch.equal(v[:, 3:4], v0)
    assert tc["blocks"][0][0] is seeded["blocks"][0][0]  # written in place


def test_prefill_cont_matches_own_packed_prefill():
    """Continuation over seeded prefixes against the port's fresh packed
    prefill of the whole prompts: last-token logits of the rows with a
    suffix (a length-0 row's logits are garbage by contract) and the KV of
    every position of every row, 1e-5."""
    _, _, _, tmodel, tparams = _setup()
    prompts, _, trows, suffixes = _cont_inputs()
    tb = PrefillBatcher(tmodel, cache_len=CACHE_LEN, pack_width=PACK)
    slots = SlotCache.zeros(tmodel, PACK, CACHE_LEN)
    cl, cc = tb.continue_rows(tparams, trows, suffixes)
    fl, fc = tb.prefill(tparams, prompts)
    np.testing.assert_array_equal(cc["pos"].numpy(), [len(p) for p in prompts])
    real = [len(s) > 0 for s in suffixes]
    _close(cl[real], fl[real], SELF_TOL)
    for i in range(PACK):
        got = slots.fit_single(tb.extract_row(cc, i))
        want = slots.fit_single(tb.extract_row(fc, i))
        for a, b in zip(_tensors(got), _tensors(want)):
            _close(a, b, SELF_TOL)


def test_prefill_cont_refuses_recurrent_blocks():
    _, _, _, tmodel, tparams = _port("recurrentgemma_2b", n_layers=3)
    cache = tmodel.cache_zeros(1, 16)
    cache["pos"] = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="'attn' blocks"):
        tmodel.prefill_cont(tparams, cache, np.zeros((1, 2), np.int32), np.ones((1,), np.int32))


def test_batcher_rows_and_signatures_match_reference():
    """``_stack`` and ``extract_row`` as the reference's, leaf for leaf, and
    ``warm(cont=True)`` then ``continue_rows`` over stored-shape rows (a
    prefill deposit, a packed row, a slot extract) add no signature: the
    counts equal the JAX batcher's traces."""
    _, jmodel, jparams, tmodel, tparams = _setup()
    _, jrows, trows, suffixes = _cont_inputs(seed=4)
    jb = JaxBatcher(jmodel, cache_len=CACHE_LEN, pack_width=PACK)
    tb = PrefillBatcher(tmodel, cache_len=CACHE_LEN, pack_width=PACK)
    as_jax = [jax.tree.map(lambda t: jnp.asarray(t.numpy()), r) for r in trows]
    got, want = tb._stack(trows), jb._stack(as_jax)
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for a, b in zip(_tensors(got), jax.tree.leaves({k: v for k, v in want.items() if k != "pos"})):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jb.warm(jparams, cont=True)
    tb.warm(tparams, cont=True)
    counts = (tb.packed.traces, tb.cont.traces)
    assert counts == (jb.packed.traces, jb.cont.traces) == (len(tb.buckets),) * 2
    jl, jc = jb.prefill(jparams, suffixes)
    tl, tc = tb.prefill(tparams, suffixes)
    row = tb.extract_row(tc, 1)
    jrow = jb.extract_row(jc, 1)
    assert int(row["pos"]) == int(jrow["pos"]) == len(suffixes[1])
    for got, want in zip(_tensors(row), jax.tree.leaves({k: v for k, v in jrow.items() if k != "pos"})):
        _close(got, want, JAX_TOL)
    tslots = SlotCache.zeros(tmodel, PACK, CACHE_LEN)
    tslots.insert_row(tslots.claim("x"), tc, 0)
    packed_row = tslots.fit_single(row)
    extracted = tslots.extract(0)
    tb.continue_rows(tparams, [trows[0], packed_row, extracted], [[1, 2], [3], [4, 5, 6]])
    jslots = JaxSlotCache.zeros(jmodel, PACK, CACHE_LEN)
    jslots.insert_row(jslots.claim("x"), jc, 0)
    jb.continue_rows(jparams, [jrows[0], jslots.fit_single(jrow), jslots.extract(0)],
                     [[1, 2], [3], [4, 5, 6]])
    assert (tb.packed.traces, tb.cont.traces) == counts == (jb.packed.traces, jb.cont.traces)
    assert tb.cont.calls == jb.cont.calls == len(tb.buckets) + 1


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _shared_prefix_workload(Req, vocab):
    """The workload of ``tests/test_batching.py::
    test_batched_prefix_kv_matches_from_scratch``: five suffixes off a shared
    system prompt (boundary plants), three exact repeats (full hits), two
    follow-ups extending a prompt (partial hits)."""
    rng = np.random.default_rng(5)
    sys_p = np.random.default_rng(42).integers(0, vocab, 10).astype(np.int32)
    reqs = []
    for i in range(5):
        sfx = rng.integers(0, vocab, 3 + i).astype(np.int32)
        reqs.append(Req(rid=i, prompt=np.concatenate([sys_p, sfx]), max_new=3, domain=i % 2))
    for i in range(3):
        reqs.append(Req(rid=5 + i, prompt=reqs[i].prompt.copy(), max_new=3, domain=i % 2))
    for i in range(2):
        ext = np.concatenate([reqs[i].prompt, rng.integers(0, vocab, 3).astype(np.int32)])
        reqs.append(Req(rid=8 + i, prompt=ext, max_new=3, domain=i % 2))
    return reqs


def _observed(eng, reqs):
    store = eng.prefix_kv
    return {
        "tokens": [list(r.out) for r in reqs],
        "order": sorted((r.admit_t, r.rid) for r in reqs),
        "sim_time": eng.sim_time,
        "prefill_positions": eng.prefill_positions,
        "reused_positions": eng.reused_positions,
        "kv_deposits": eng.kv_deposits,
        "compile_counts": eng.compile_counts,
        "store": None if store is None else (store.hits, store.misses, store.reused_tokens,
                                             list(store._lru)),
    }


@functools.lru_cache(maxsize=None)
def _jax_run(batching):
    cfg, jmodel, jparams, _, _ = _setup()
    reqs = _shared_prefix_workload(JaxRequest, cfg.vocab)
    eng = JaxEngine(jmodel, jparams, n_slots=4, cache_len=CACHE_LEN, scheduler=JaxCNAScheduler(),
                    prefix_kv=True, batching=batching)
    eng.run(reqs)
    return _observed(eng, reqs)


def _torch_run(batching, prefix_kv=True, tracer=None):
    cfg, _, _, tmodel, tparams = _setup()
    reqs = _shared_prefix_workload(Request, cfg.vocab)
    eng = DecodeEngine(tmodel, tparams, n_slots=4, cache_len=CACHE_LEN, scheduler=CNAScheduler(),
                       prefix_kv=prefix_kv, batching=batching, tracer=tracer)
    eng.run(reqs)
    return eng, reqs


@functools.lru_cache(maxsize=None)
def _torch_observed(batching):
    return _observed(*_torch_run(batching))


@pytest.mark.parametrize("key", ["tokens", "order", "sim_time", "prefill_positions",
                                 "reused_positions", "kv_deposits", "compile_counts", "store"])
@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_engine_matches_jax_engine(batching, key):
    assert _torch_observed(batching)[key] == _jax_run(batching)[key]


def test_engine_routes_fire():
    """Every admission route ran: full hits, continuation packs, plants
    (the batched path), resumes (the per-request path), deposits; and the
    two paths charge the same total positions."""
    bat, per = _torch_observed(True), _torch_observed(False)
    assert bat["compile_counts"]["cont_prefill"] == bat["compile_counts"]["packed_prefill"]
    assert bat["reused_positions"] > 0 and per["reused_positions"] > 0
    assert bat["kv_deposits"] == per["kv_deposits"] == 10
    assert (bat["prefill_positions"] + bat["reused_positions"]
            == per["prefill_positions"] + per["reused_positions"])
    eng, reqs = _torch_run(True, tracer=Tracer())
    tracer = eng.tracer
    assert tracer.check() == []
    kinds = {sp.attrs.get("kind") for sp in tracer if sp.name == "prefill"}
    assert kinds == {"fresh", "cont", "reuse"}


def test_batched_tokens_equal_no_store_engine():
    _, reqs = _torch_run(True, prefix_kv=None)
    assert [r.out for r in reqs] == _torch_observed(True)["tokens"]


def _conversation(Eng, Req, model, params, *, batching, vocab, seed=13):
    """A prompt, then (a) an extension of it and (b) a follow-up on the
    first exchange's prompt + output: only the new tokens are computed
    (plus, for (b), the emitted token the cache never encoded)."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, vocab, 10).astype(np.int32)
    eng = Eng(model, params, n_slots=2, cache_len=CACHE_LEN, prefix_kv=True, batching=batching)
    r1 = Req(rid=0, prompt=first, max_new=4)
    eng.run([r1])
    ext = np.concatenate([first, rng.integers(0, vocab, 5).astype(np.int32)])
    follow = np.concatenate([first, np.asarray(r1.out, np.int32),
                             rng.integers(0, vocab, 3).astype(np.int32)])
    computed = []
    reqs = [r1]
    for rid, prompt in ((1, ext), (2, follow)):
        before = eng.prefill_positions
        r = Req(rid=rid, prompt=prompt, max_new=3)
        eng.run([r])
        computed.append(eng.prefill_positions - before)
        reqs.append(r)
    return [r.out for r in reqs], computed, eng


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_conversation_extension_and_follow_up_match_jax(batching):
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    got = _conversation(DecodeEngine, Request, tmodel, tparams, batching=batching, vocab=cfg.vocab)
    want = _conversation(JaxEngine, JaxRequest, jmodel, jparams, batching=batching, vocab=cfg.vocab)
    assert got[:2] == want[:2]
    assert got[1] == [5, 4]
    assert got[2].kv_deposits == want[2].kv_deposits == 3


def test_export_import_round_trip():
    """A prefix shipped between two port engines resumes there and gives the
    tokens of a from-scratch run; the matched lengths are the JAX
    engine's; an over-length bundle is refused."""
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    rng = np.random.default_rng(7)
    shared = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    prompt = np.concatenate([shared, rng.integers(0, cfg.vocab, 5).astype(np.int32)])

    def ship(Eng, Req, model, params):
        src = Eng(model, params, n_slots=1, cache_len=CACHE_LEN, prefix_kv=True)
        src.run([Req(rid=0, prompt=shared, max_new=2)])
        exported = src.export_kv(prompt)
        dst = Eng(model, params, n_slots=1, cache_len=CACHE_LEN, prefix_kv=True)
        peek0 = dst.peek_match(prompt)
        assert dst.import_kv(*exported)
        peek1 = dst.peek_match(prompt)
        r = Req(rid=1, prompt=prompt, max_new=5)
        dst.run([r])
        tiny = Eng(model, params, n_slots=1, cache_len=8, prefix_kv=True)
        refused = not tiny.import_kv(*exported) and len(tiny.prefix_kv) == 0
        return (len(exported[0]), src.peek_match(prompt), peek0, peek1, dst.reused_positions,
                r.out, refused, Eng(model, params).export_kv(prompt), Eng(model, params).peek_match(prompt))

    got = ship(DecodeEngine, Request, tmodel, tparams)
    assert got == ship(JaxEngine, JaxRequest, jmodel, jparams)
    assert got[:5] == (12, 12, 0, 12, 12) and got[6] and got[7] is None and got[8] == 0
    fresh = DecodeEngine(tmodel, tparams, n_slots=1, cache_len=CACHE_LEN)
    r = Request(rid=2, prompt=prompt, max_new=5)
    fresh.run([r])
    assert r.out == got[5]
    # the shipped bundle is the source's own entry, and the receiver's is a copy
    src = DecodeEngine(tmodel, tparams, n_slots=1, cache_len=CACHE_LEN, prefix_kv=True)
    src.run([Request(rid=0, prompt=shared, max_new=1)])
    key, (cache, _) = src.export_kv(prompt)
    dst = DecodeEngine(tmodel, tparams, n_slots=1, cache_len=CACHE_LEN, prefix_kv=True)
    dst.import_kv(key, src.prefix_kv.get(key))
    (_, mine, _), = [e for e in _entries(dst.prefix_kv) if e[0] == key]
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(_tensors(mine) + [mine["pos"]], _tensors(cache) + [cache["pos"]]))


# ---------------------------------------------------------------------------
# aliasing: stored entries are never written
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_request"])
def test_stored_entries_survive_resume_decode_release_and_reuse(batching):
    """Store a prompt's cache, then resume its prefix (a partial hit), hit
    it whole, decode several steps, release the slots and serve other
    requests in them: every entry stored before stays bitwise as it was."""
    cfg, _, _, tmodel, tparams = _setup()
    rng = np.random.default_rng(21)
    base = rng.integers(0, cfg.vocab, 14).astype(np.int32)
    eng = DecodeEngine(tmodel, tparams, n_slots=2, cache_len=CACHE_LEN, prefix_kv=True,
                       batching=batching)
    eng.run([Request(rid=0, prompt=base, max_new=2)])
    snap = _snapshot(eng.prefix_kv)
    assert {len(key) for key, *_ in snap} == {14, 15}  # the prompt and its deposit
    later = [
        Request(rid=1, prompt=np.concatenate([base, rng.integers(0, cfg.vocab, 6).astype(np.int32)]),
                max_new=8),
        Request(rid=2, prompt=base.copy(), max_new=8),
    ]
    eng.run(later)
    assert eng.reused_positions == 2 * len(base)
    eng.run([Request(rid=3 + i, prompt=rng.integers(0, cfg.vocab, 9 + i).astype(np.int32),
                     max_new=5) for i in range(3)])
    assert eng.slots.n_free == 2 and _unchanged(snap) == []
    # the full hit re-put the entry itself: the store still holds those tensors
    assert eng.prefix_kv.get(list(base))[0] is snap[0][1]


@pytest.mark.parametrize("name,n_layers", [("recurrentgemma_2b", 5), ("mamba2_130m", None)])
def test_per_request_extension_on_recurrent_families(name, n_layers):
    """The per-request path takes the store for the hybrid and SSM models,
    their state leaves stored whole: an extension computes only its new
    tokens, emits what the port's own split decomposition emits (prefill of
    the first prompt, then ``decode_step`` over the extension), and leaves
    the stored entry as it was."""
    cfg, _, _, tmodel, tparams = _port(name, n_layers)
    rng = np.random.default_rng(13)
    first = rng.integers(0, cfg.vocab, 10).astype(np.int32)
    ext = np.concatenate([first, rng.integers(0, cfg.vocab, 5).astype(np.int32)])
    eng = DecodeEngine(tmodel, tparams, n_slots=2, cache_len=CACHE_LEN, prefix_kv=True)
    eng.run([Request(rid=0, prompt=first, max_new=3)])
    snap = _snapshot(eng.prefix_kv)
    before = eng.prefill_positions
    r = Request(rid=1, prompt=ext, max_new=4)
    eng.run([r])
    assert eng.prefill_positions - before == 5 and eng.reused_positions == 10
    assert _unchanged(snap) == []

    logits, cache = tmodel.prefill(tparams, {"tokens": first[None]})
    for t in ext[10:]:
        logits, cache = tmodel.decode_step(tparams, cache, torch.tensor([[int(t)]]))
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(3):
        logits, cache = tmodel.decode_step(tparams, cache, torch.tensor([[toks[-1]]]))
        toks.append(int(torch.argmax(logits[0])))
    assert r.out == toks
    with pytest.raises(ValueError):
        DecodeEngine(tmodel, tparams, n_slots=2, cache_len=CACHE_LEN, prefix_kv=True, batching=True)
