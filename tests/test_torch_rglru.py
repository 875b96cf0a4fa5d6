"""The port's RG-LRU path and hybrid model against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go to both packages in float32.
Tolerances:
  * the scan and the RG-LRU block functions: atol 1e-5, rtol 1e-4, as
    tests/test_recurrent.py holds the reference's own scan implementations
    against each other (the port walks the recurrence in order, the
    reference's ``impl="assoc"`` sums in a tree);
  * the hybrid model (reduced recurrentgemma at 5 layers: a ``cyc``
    segment of (rec, rec, attn) plus ``tail3`` and ``tail4``): 1e-4, as
    tests/test_torch_model.py holds the dense model.

The CUDA scan kernel is held against its plain version on the card in
tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.rglru_scan.ops import linear_scan as jax_linear_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import linear_scan_ref  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models.common import ParamBuilder as JaxParamBuilder  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.rglru_scan import linear_scan  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4   # scan and block functions, float32
TOL = 1e-4                # model, float32
N_LAYERS = 5              # cyc (rec, rec, attn) x 1 + tail3 + tail4
SCAN_SHAPES = [           # (B, S, W): ragged S and W, no block multiples
    (1, 37, 50),
    (2, 300, 130),
    (3, 1, 7),
    (1, 257, 129),
]


def _scan_inputs(shape, seed=0):
    b, s, w = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.999, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w), dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32)
    return a, bb, h0


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=[str(s) for s in SCAN_SHAPES])
def test_plain_scan_matches_jax_reference_and_pallas(shape):
    a, b, h0 = _scan_inputs(shape)
    before = linear_scan.launches
    got = linear_scan(*map(torch.from_numpy, (a, b, h0)))
    assert linear_scan.launches == before, "a CPU tensor must not count as a launch"
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    want_ref = np.asarray(linear_scan_ref(a, b, h0))
    want_pallas = np.asarray(jax_linear_scan(a, b, h0))  # interpret mode on the CPU
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=ATOL, rtol=RTOL)


def test_scan_wrapper_raises_off_cpu_and_cuda():
    a = torch.zeros(1, 4, 8, device="meta")
    before = linear_scan.launches
    with pytest.raises(ValueError):
        linear_scan(a, a, torch.zeros(1, 8, device="meta"))
    assert linear_scan.launches == before


def _rglru_params(width=24, d_model=16, seed=0):
    """The reference's declaration and init, as numpy and as torch tensors."""
    pb = JaxParamBuilder(dtype=jnp.float32)
    jrg.declare_rglru(pb, "rec", d_model, width, 4)
    jp = jax.tree.map(np.asarray, pb.init(jax.random.PRNGKey(seed))["rec"])
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("impl", ["assoc", "pallas"])
def test_rglru_scan_matches_reference(impl):
    jp, tp = _rglru_params()
    rng = np.random.default_rng(1)
    xc = rng.standard_normal((2, 40, 24), dtype=np.float32)
    h0 = rng.standard_normal((2, 24), dtype=np.float32)
    for h in (None, h0):
        jy, jh = jrg.rglru_scan(jp, xc, h, impl=impl)
        ty, th = rglru.rglru_scan(tp, torch.from_numpy(xc), None if h is None else torch.from_numpy(h))
        assert th.dtype == torch.float32
        _close(ty, jy)
        _close(th, jh)


@pytest.mark.parametrize("impl", ["assoc", "pallas"])
def test_rglru_block_matches_reference(impl):
    jp, tp = _rglru_params()
    x = np.random.default_rng(2).standard_normal((2, 33, 16), dtype=np.float32)
    jy, (jh, jconv) = jrg.rglru_block(jp, x, scan_impl=impl)
    ty, (th, tconv) = rglru.rglru_block(tp, torch.from_numpy(x))
    _close(ty, jy)
    _close(th, jh)
    _close(tconv, jconv)
    # a prompt shorter than the conv tail: left zero padding
    jy, (_, jconv) = jrg.rglru_block(jp, x[:, :2], scan_impl=impl)
    ty, (_, tconv) = rglru.rglru_block(tp, torch.from_numpy(x[:, :2]))
    _close(ty, jy)
    _close(tconv, jconv)


def test_rglru_block_step_matches_reference():
    jp, tp = _rglru_params()
    rng = np.random.default_rng(3)
    jstate = (rng.standard_normal((2, 24), dtype=np.float32),
              rng.standard_normal((2, 3, 24), dtype=np.float32))
    tstate = tuple(torch.from_numpy(s) for s in jstate)
    for _ in range(5):
        x_t = rng.standard_normal((2, 1, 16), dtype=np.float32)
        jy, jstate = jrg.rglru_block_step(jp, x_t, jstate)
        ty, tstate = rglru.rglru_block_step(tp, torch.from_numpy(x_t), tstate)
        _close(ty, jy)
        for t, j in zip(tstate, jstate):
            _close(t, j)


def test_causal_conv1d_and_step_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 24), dtype=np.float32)
    w = rng.standard_normal((4, 24), dtype=np.float32)
    b = rng.standard_normal(24, dtype=np.float32)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(rglru.causal_conv1d(tx, tw, tb), jrg.causal_conv1d(x, w, b))
    state = rng.standard_normal((2, 3, 24), dtype=np.float32)
    jo, js = jrg.conv1d_step(x[:, 0], state, w, b)
    to, ts = rglru.conv1d_step(tx[:, 0], torch.from_numpy(state), tw, tb)
    _close(to, jo)
    _close(ts, js)


def test_lambda_init_and_dtype():
    """Λ has sigmoid(Λ) in [0.9, 0.999] and stays float32 in a bf16 model,
    as the reference's ``abstract()`` keeps it."""
    model = build_model(get_reduced_config("recurrentgemma_2b"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    lam = params["cyc0"][0]["rec"]["lam"]
    assert lam.dtype == torch.float32 and params["cyc0"][0]["rec"]["wa"].dtype == torch.bfloat16
    a = torch.sigmoid(lam)
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


# ---------------------------------------------------------------------------
# the hybrid model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _setup():
    cfg = jax_reduced_config("recurrentgemma_2b").replace(n_layers=N_LAYERS, dtype="float32")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("recurrentgemma_2b").replace(n_layers=N_LAYERS, dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _assert_cache_close(tc, jc, tol):
    """Every leaf of the reference's cache against the port's leaf at the
    same key path."""
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(flat) == 2 * N_LAYERS + 1
    for path, want in flat:
        got = tc
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, (name, tuple(got.shape), want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def test_config_matches_published_recurrentgemma_widths():
    cfg = get_config("recurrentgemma-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff, cfg.vocab,
            cfg.lru_width, cfg.conv_width, cfg.window, cfg.mlp, cfg.dtype) == (
        26, 2560, 10, 1, 256, 7680, 256000, 2560, 4, 2048, "geglu", "bfloat16")
    from repro.models.transformer import build_segments as jax_build_segments
    from repro_torch.models.transformer import build_segments

    full = [(s.mode, s.name, s.kinds, s.n_rep) for s in build_segments(cfg)]
    assert full == [("scan", "cyc", ("rec", "rec", "attn"), 8), ("unroll", "tail24", ("rec",), 1),
                    ("unroll", "tail25", ("rec",), 1)]
    for c in (cfg, cfg.replace(n_layers=N_LAYERS), get_config("granite-3-8b")):
        jc = jax_reduced_config("granite_3_8b").replace(**{
            f: getattr(c, f) for f in ("n_layers", "block_pattern", "family")})
        assert [(s.mode, s.name, s.kinds, s.n_rep) for s in build_segments(c)] == [
            (s.mode, s.name, s.kinds, s.n_rep) for s in jax_build_segments(jc)]


def test_params_match_reference_declaration():
    _, jmodel, jparams, tmodel, tparams = _setup()
    assert tmodel.pb.shapes == {p: tuple(s) for p, s in jmodel.pb.shapes.items()}
    assert sorted(tparams) == sorted(jparams)
    assert len(tparams["cyc0"]) == 1 and isinstance(tparams["tail3"], dict)


def test_prefill_matches_jax():
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    for s in (12, 44):  # inside the window of 32, and past it (ring layout)
        toks = np.random.default_rng(s).integers(0, cfg.vocab, (2, s)).astype(np.int32)
        jl, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": toks})
        tl, tc = tmodel.prefill(tparams, {"tokens": toks})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        _assert_cache_close(tc, jc, TOL)


def test_decode_past_the_window_matches_jax():
    """A 40-token prompt, then 8 steps: the ring wraps (window 32) and the
    recurrent states carry, every leaf held at every step."""
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    _, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": toks})
    _, tc = tmodel.prefill(tparams, {"tokens": toks})
    step = jax.jit(jmodel.decode_step)
    for _ in range(8):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = step(jparams, jc, nxt)
        tl, tc = tmodel.decode_step(tparams, tc, nxt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        _assert_cache_close(tc, jc, TOL)
    assert int(tc["pos"]) == 48


def test_decode_per_lane_positions_match_jax():
    """The engine's batched form: per-lane ``pos``, one lane past the
    window and one inside it."""
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    rng = np.random.default_rng(8)
    lens = (36, 9)
    jparts, tparts = [], []
    for n in lens:
        toks = rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)
        jparts.append(jax.jit(jmodel.prefill)(jparams, {"tokens": toks})[1])
        tparts.append(tmodel.prefill(tparams, {"tokens": toks})[1])
    # the two B=1 caches side by side on each leaf's batch axis
    jcache, tcache = {}, {}
    for seg in tmodel.segments:
        ax = 1 if seg.mode == "scan" else 0
        jcache[seg.name] = jax.tree.map(lambda a, b: jnp.concatenate((a, b), ax),
                                        *(c[seg.name] for c in jparts))
        tcache[seg.name] = jax.tree.map(lambda a, b: torch.cat((a, b), ax),
                                        *(c[seg.name] for c in tparts))
    jcache["pos"] = jnp.asarray(lens, jnp.int32)
    tcache["pos"] = torch.tensor(lens, dtype=torch.int32)
    step = jax.jit(jmodel.decode_step)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jcache = step(jparams, jcache, nxt)
        tl, tcache = tmodel.decode_step(tparams, tcache, nxt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_cache_close(tcache, jcache, TOL)


def test_hybrid_model_refuses_packed_prefill_as_reference():
    _, jmodel, _, tmodel, _ = _setup()
    for cache_len in (None, 16, 64):
        assert tmodel.supports_packed_prefill(cache_len) is False
        assert jmodel.supports_packed_prefill(cache_len) is False
