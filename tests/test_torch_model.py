"""The port's dense decoder against the JAX package's, on the CPU.

Weights come from ``repro``'s ``DecoderLM.init`` on the reduced granite
config in float32 and pass through ``repro_torch.convert.params_from_jax``;
tokens come from numpy with a seed and go to both packages.  Held at
atol/rtol 1e-4 in float32 (the two frameworks sum in other orders):
``prefill``, ``prefill_packed`` (mixed lengths and a zero-length dummy row)
and 8 ``decode_step``s — logits, every K/V cache leaf and ``pos``.  The
port's packed rows are also held against its own per-request prefill within
1e-5 (not bitwise: the reference's own bitwise claim is red on this jax
build).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

TOL = 1e-4          # port vs JAX, float32
SELF_TOL = 1e-5     # port packed row vs port per-request prefill, float32
LENGTHS = [5, 16, 9, 0]  # mixed lengths + a zero-length dummy row
BUCKET = 16


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = jax_reduced_config("granite_3_8b").replace(dtype="float32")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    tcfg = get_reduced_config("granite_3_8b").replace(dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(np_tree, tcfg, device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _leaves(cache):
    """(name, array) for every K/V leaf and pos of either package's cache."""
    (k, v), = cache["blocks"]
    return [("k", k), ("v", v), ("pos", cache["pos"])]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_cache_close(got, want, tol):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


def _packed_tokens(seed=0):
    vocab = _setup()[0].vocab
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(LENGTHS), BUCKET), np.int32)
    for i, n in enumerate(LENGTHS):
        toks[i, :n] = rng.integers(0, vocab, n)
    return toks, np.asarray(LENGTHS, np.int32)


def test_config_matches_published_granite_widths():
    cfg = get_config("granite-3-8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab) == (
        40, 4096, 32, 8, 12800, 49155)
    assert cfg.dtype == "bfloat16" and cfg.hd == 128
    red = get_reduced_config("granite_3_8b")
    assert (red.n_layers, red.d_model, red.attn_chunk) == (2, 64, 64)


def test_params_match_reference_declaration():
    """Same paths and shapes as the reference's ParamBuilder, and the same
    init rules (zeros for norms; std 1/sqrt(shape[-2]) or the given scale)."""
    cfg, jmodel, _, tmodel, _ = _setup()
    assert tmodel.pb.shapes == {p: tuple(s) for p, s in jmodel.pb.shapes.items()}
    params = tmodel.init(torch.Generator().manual_seed(0))
    assert len(params["blocks"]) == cfg.n_layers
    assert float(params["blocks"][0]["ln1"].abs().max()) == 0.0
    wq = torch.stack([p["wq"] for p in params["blocks"]])
    assert abs(float(wq.std()) - 1 / np.sqrt(cfg.n_heads)) < 0.05
    assert abs(float(params["embed"].std()) - 0.02) < 0.002


def test_norms_and_rope_match_reference():
    from repro.models import common as jcommon

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    scale = rng.standard_normal(64, dtype=np.float32) * 0.1
    bias = rng.standard_normal(64, dtype=np.float32) * 0.1
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    np.testing.assert_allclose(
        common.rmsnorm(tx, ts).numpy(), np.asarray(jcommon.rmsnorm(x, scale)), atol=1e-5)
    np.testing.assert_allclose(
        common.layernorm(tx, ts, tb).numpy(),
        np.asarray(jcommon.layernorm(x, scale, bias)), atol=1e-5)
    pos = np.arange(7, dtype=np.int32)
    cos, sin = common.rope_angles(torch.from_numpy(pos), 16, 1e4)
    jcos, jsin = jcommon.rope_angles(pos, 16, 1e4)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    q = rng.standard_normal((1, 7, 4, 16), dtype=np.float32)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(q), cos, sin).numpy(),
        np.asarray(jcommon.apply_rope(q, jcos, jsin)), atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(kind):
    from repro.models.mlp import mlp_apply as jax_mlp
    from repro_torch.models.mlp import mlp_apply

    rng = np.random.default_rng(4)
    p = {n: rng.standard_normal(s, dtype=np.float32) * 0.2
         for n, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    x = rng.standard_normal((2, 3, 32), dtype=np.float32)
    got = mlp_apply({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mlp(p, x, kind)), atol=1e-4, rtol=1e-4)


def test_prefill_matches_jax():
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": toks})
    tl, tc = tmodel.prefill(tparams, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc, TOL)


def test_prefill_packed_and_decode_match_jax():
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    toks, lens = _packed_tokens()
    jl, jc = jax.jit(jmodel.prefill_packed)(jparams, toks, lens)
    tl, tc = tmodel.prefill_packed(tparams, toks, lens)
    real = lens > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc, TOL)
    # the dummy row's KV and pos stay zero
    (k, v), = tc["blocks"]
    assert not k[:, ~torch.from_numpy(real)].any() and int(tc["pos"][-1]) == 0

    step = jax.jit(jmodel.decode_step)
    rng = np.random.default_rng(2)
    for _ in range(8):
        nxt = rng.integers(0, cfg.vocab, (len(LENGTHS), 1)).astype(np.int32)
        jl, jc = step(jparams, jc, nxt)
        tl, tc = tmodel.decode_step(tparams, tc, nxt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        _assert_cache_close(tc, jc, TOL)


def test_packed_rows_match_own_per_request_prefill():
    cfg, _, _, tmodel, tparams = _setup()
    toks, lens = _packed_tokens(seed=5)
    tl, tc = tmodel.prefill_packed(tparams, toks, lens)
    (pk, pv), = tc["blocks"]
    for i, n in enumerate(LENGTHS):
        if n == 0:
            continue
        sl, sc = tmodel.prefill(tparams, {"tokens": toks[i : i + 1, :n]})
        (sk, sv), = sc["blocks"]
        np.testing.assert_allclose(tl[i].numpy(), sl[0].numpy(), atol=SELF_TOL, rtol=SELF_TOL)
        np.testing.assert_allclose(pk[:, i, :n].numpy(), sk[:, 0, :n].numpy(), atol=SELF_TOL, rtol=SELF_TOL)
        np.testing.assert_allclose(pv[:, i, :n].numpy(), sv[:, 0, :n].numpy(), atol=SELF_TOL, rtol=SELF_TOL)
        assert int(tc["pos"][i]) == int(sc["pos"]) == n


def test_supports_packed_prefill_gate_matches_reference():
    _, jmodel, _, tmodel, _ = _setup()
    for cache_len in (32, 64, 65, 1024):
        assert tmodel.supports_packed_prefill(cache_len) == jmodel.supports_packed_prefill(cache_len)
    xla = build_model(get_reduced_config("granite_3_8b").replace(attn_impl="xla"), device="cpu")
    assert xla.supports_packed_prefill(1024)


def test_unported_kinds_and_default_device_raise():
    with pytest.raises(NotImplementedError):
        build_model(get_reduced_config("granite_3_8b").replace(n_patches=4), device="cpu")
    with pytest.raises(NotImplementedError):
        build_model(get_reduced_config("granite_3_8b").replace(n_experts=4, top_k=2), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            build_model(get_reduced_config("granite_3_8b"))  # device="cuda" by default
