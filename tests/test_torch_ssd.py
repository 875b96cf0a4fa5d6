"""The port's Mamba-2 SSD path and mamba2 model against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go to both packages in float32.
Tolerances:
  * the intra-chunk term (the kernel's plain version): atol 1e-4, rtol
    1e-4, as tests/test_kernels.py holds the reference's Pallas kernel
    against its oracle (sums over N and L in another order);
  * ``ssd_chunked``, ``ssd_step`` and the blocks: atol 1e-4, rtol 1e-4 (the
    port contracts the chunk states and the state-to-output term as two
    two-operand products where the reference writes three-operand
    einsums, so the sums run in another order);
  * the reduced model (2 SSD layers): 1e-4, as tests/test_torch_model.py
    holds the dense model.

The CUDA kernel is held against its plain version on the card in
tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import get_reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_intra as jax_ssd_intra  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_intra_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.common import ParamBuilder as JaxParamBuilder  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.common import ParamBuilder  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

ATOL = RTOL = 1e-4   # the intra term, the SSD functions and blocks, float32
TOL = 1e-4           # the model, float32
# (B, nc, L, H, P, N): tests/test_kernels.py's three shapes, then L under a
# chunk and a ragged one with B 2
INTRA_SHAPES = [
    (2, 3, 16, 2, 8, 4),
    (1, 2, 32, 4, 16, 16),
    (1, 4, 64, 3, 32, 8),
    (1, 1, 77, 3, 16, 8),
    (2, 2, 20, 5, 12, 10),
]


def _intra_inputs(shape, seed=0, da_range=(-0.5, -0.01)):
    b, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, l, h, p), dtype=np.float32)
    dac = rng.uniform(*da_range, (b, h, nc, l)).astype(np.float32)
    bc = rng.standard_normal((b, nc, l, n), dtype=np.float32)
    cc = rng.standard_normal((b, nc, l, n), dtype=np.float32)
    return xc, dac, bc, cc


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("da_range", [(-0.5, -0.01), (-1.6, 0.0)], ids=["test_kernels", "dt_A"])
@pytest.mark.parametrize("shape", INTRA_SHAPES, ids=[str(s) for s in INTRA_SHAPES])
def test_plain_intra_matches_jax_reference_and_pallas(shape, da_range):
    """dA in tests/test_kernels.py's range and in the range dt * A takes in
    the model (dt up to 0.1, A down to -16)."""
    inputs = _intra_inputs(shape, da_range=da_range)
    before = ssd_intra.launches
    got = ssd_intra(*map(torch.from_numpy, inputs))
    assert ssd_intra.launches == before, "a CPU tensor must not count as a launch"
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:5]
    _close(got, ssd_intra_ref(*inputs))
    _close(got, jax_ssd_intra(*inputs))  # Pallas, interpret mode on the CPU
    _close(ssd_intra_plain(*map(torch.from_numpy, inputs)), ssd_intra_ref(*inputs))


def test_plain_intra_masks_by_select():
    """A dA large enough that exp(cum_l - cum_s) above the diagonal would
    overflow: the result stays finite (no inf * 0)."""
    xc, dac, bc, cc = _intra_inputs((1, 1, 128, 2, 8, 4), da_range=(-16.0, -8.0))
    got = ssd_intra_plain(*map(torch.from_numpy, (xc, dac, bc, cc)))
    assert bool(torch.isfinite(got).all())
    _close(got, ssd_intra_ref(xc, dac, bc, cc))


def test_intra_wrapper_raises_off_cpu_and_cuda():
    t = torch.zeros(1, 1, 4, 2, 8, device="meta")
    before = ssd_intra.launches
    with pytest.raises(ValueError):
        ssd_intra(t, torch.zeros(1, 2, 1, 4, device="meta"), torch.zeros(1, 1, 4, 3, device="meta"),
                  torch.zeros(1, 1, 4, 3, device="meta"))
    assert ssd_intra.launches == before


def _chunk_inputs(bs, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, s, h, p), dtype=np.float32)
    dt = rng.uniform(0.001, 0.1, (bs, s, h)).astype(np.float32)
    a = -rng.uniform(1.0, 16.0, h).astype(np.float32)
    b = rng.standard_normal((bs, s, n), dtype=np.float32)
    c = rng.standard_normal((bs, s, n), dtype=np.float32)
    s0 = rng.standard_normal((bs, h, p, n), dtype=np.float32)
    return x, dt, a, b, c, s0


@pytest.mark.parametrize("intra_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("s", [45, 10, 32], ids=["ragged", "under_a_chunk", "two_chunks"])
def test_ssd_chunked_matches_reference(s, intra_impl):
    x, dt, a, b, c, s0 = _chunk_inputs(2, s, 3, 8, 6, seed=s)
    for init in (None, s0):
        jy, js = jssm.ssd_chunked(x, dt, a, b, c, chunk=16, s0=init, intra_impl=intra_impl)
        ty, ts = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), chunk=16,
                                 s0=None if init is None else torch.from_numpy(init))
        assert ts.dtype == torch.float32 and tuple(ty.shape) == x.shape
        _close(ty, jy)
        _close(ts, js)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(5)
    x, dt, a, b, c, s0 = _chunk_inputs(2, 1, 3, 8, 6, seed=5)
    jstate, tstate = s0, torch.from_numpy(s0)
    for _ in range(4):
        x_t = rng.standard_normal((2, 3, 8), dtype=np.float32)
        jy, jstate = jssm.ssd_step(x_t, dt[:, 0], a, b[:, 0], c[:, 0], jstate)
        ty, tstate = ssm.ssd_step(torch.from_numpy(x_t), *map(torch.from_numpy, (dt[:, 0], a, b[:, 0],
                                                                                   c[:, 0])), tstate)
        _close(ty, jy)
        _close(tstate, jstate)


def _ssd_params(seed=0):
    """The reduced mamba2 config and the reference's declaration and init of
    one SSD block, as numpy and as torch tensors."""
    cfg = jax_reduced_config("mamba2_130m").replace(dtype="float32")
    pb = JaxParamBuilder(dtype=jnp.float32)
    jssm.declare_ssd(pb, "ssd", cfg)
    jp = jax.tree.map(np.asarray, pb.init(jax.random.PRNGKey(seed))["ssd"])
    return cfg, jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("intra_impl", ["jnp", "pallas"])
def test_ssd_block_matches_reference(intra_impl):
    cfg, jp, tp = _ssd_params()
    x = np.random.default_rng(2).standard_normal((2, 45, cfg.d_model), dtype=np.float32)
    block = jax.jit(functools.partial(jssm.ssd_block, cfg=cfg, intra_impl=intra_impl))
    # ragged over chunk 32, under a chunk, and shorter than the conv tail (K-1 = 3)
    for s in (45, 20, 2):
        jy, (js, jconv) = block(jp, x[:, :s])
        ty, (ts, tconv) = ssm.ssd_block(tp, torch.from_numpy(x[:, :s]), cfg)
        assert tuple(tconv.shape) == (2, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.ssm_state)
        _close(ty, jy)
        _close(ts, js)
        _close(tconv, jconv)


def test_ssd_block_step_matches_reference():
    cfg, jp, tp = _ssd_params()
    rng = np.random.default_rng(3)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    jstate = (rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                                  dtype=np.float32),
              rng.standard_normal((2, cfg.conv_width - 1, conv_ch), dtype=np.float32))
    tstate = tuple(torch.from_numpy(s) for s in jstate)
    for _ in range(5):
        x_t = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
        jy, jstate = jssm.ssd_block_step(jp, x_t, jstate, cfg)
        ty, tstate = ssm.ssd_block_step(tp, torch.from_numpy(x_t), tstate, cfg)
        _close(ty, jy)
        for t, j in zip(tstate, jstate):
            _close(t, j)


def test_ssm_inits_are_float32_and_in_range():
    """a_log = log A with A in [1, 16]; dt_bias the inverse softplus of dt in
    [0.001, 0.1]; both stay float32 in a bf16 model, as the reference's
    ``abstract()`` keeps them."""
    cfg = get_config("mamba2-130m")
    pb = ParamBuilder(dtype=torch.bfloat16)
    ssm.declare_ssd(pb, "ssd", cfg)
    p = pb.init(torch.Generator().manual_seed(0), "cpu")["ssd"]
    assert p["a_log"].dtype == torch.float32 and p["dt_bias"].dtype == torch.float32
    assert p["in_proj"].dtype == torch.bfloat16
    a = torch.exp(p["a_log"])
    assert float(a.min()) >= 1.0 - 1e-5 and float(a.max()) <= 16.0 + 1e-4
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 0.001 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    jpb = JaxParamBuilder(dtype=jnp.bfloat16)
    jssm.declare_ssd(jpb, "ssd", jax_get_config("mamba2_130m"))
    jdt = {k: str(v.dtype) for k, v in jpb.abstract()["ssd"].items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in p.items()} == jdt


def test_config_matches_published_mamba2_widths():
    cfg = get_config("mamba2-130m")
    assert (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.ssm_state, cfg.ssm_expand, cfg.d_inner,
            cfg.ssm_head_dim, cfg.ssm_heads, cfg.ssm_chunk, cfg.conv_width, cfg.tie_embeddings,
            cfg.dtype) == (24, 768, 50280, 128, 2, 1536, 64, 24, 128, 4, True, "bfloat16")
    for ours, theirs in ((cfg, jax_get_config("mamba2_130m")),
                         (get_reduced_config("mamba2_130m"), jax_reduced_config("mamba2_130m"))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    from repro_torch.models.transformer import build_segments

    assert [(s.mode, s.name, s.kinds, s.n_rep) for s in build_segments(cfg)] == [
        ("scan", "blocks", ("ssd",), 24)]


def test_full_width_params_match_reference_declaration():
    """Names, shapes and dtypes of every leaf of the full-width model, from
    the declarations alone (nothing is drawn)."""
    tmodel = build_model(get_config("mamba2-130m"), device="cpu")
    jmodel = jax_build_model(jax_get_config("mamba2_130m"))
    assert tmodel.pb.shapes == {p: tuple(s) for p, s in jmodel.pb.shapes.items()}
    flat = jax.tree_util.tree_flatten_with_path(jmodel.pb.abstract())[0]
    assert len(flat) == len(tmodel.pb.shapes)
    for path, sds in flat:
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        assert str(tmodel.pb.leaf_dtype(name)).split(".")[-1] == str(sds.dtype), name
    n = sum(math.prod(s) for s in tmodel.pb.shapes.values())
    assert 125e6 < n < 135e6, n


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _setup():
    cfg = jax_reduced_config("mamba2_130m").replace(dtype="float32")
    jmodel = jax_build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = get_reduced_config("mamba2_130m").replace(dtype="float32")
    tmodel = build_model(tcfg, device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def _assert_cache_close(tc, jc, tol):
    flat = jax.tree_util.tree_flatten_with_path(jc)[0]
    assert len(flat) == 3  # blocks: ((s, conv),) stacked over the layers, and pos
    for path, want in flat:
        got = tc
        for p in path:
            got = got[getattr(p, "key", getattr(p, "idx", None))]
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, (name, tuple(got.shape), want.shape)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def test_params_match_reference_tree():
    _, jmodel, jparams, tmodel, tparams = _setup()
    assert tmodel.pb.shapes == {p: tuple(s) for p, s in jmodel.pb.shapes.items()}
    assert sorted(tparams) == sorted(jparams) == ["blocks", "embed", "final_norm"]
    assert len(tparams["blocks"]) == 2 and sorted(tparams["blocks"][0]) == ["ln1", "ssd"]


@pytest.mark.parametrize("s", [45, 20, 64], ids=["ragged", "under_a_chunk", "two_chunks"])
def test_prefill_matches_jax(s):
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    toks = np.random.default_rng(s).integers(0, cfg.vocab, (2, s)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": toks})
    tl, tc = tmodel.prefill(tparams, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    _assert_cache_close(tc, jc, TOL)


def test_decode_matches_jax():
    """A ragged prompt, then 6 steps: the SSD state and conv tail carry,
    every leaf held at every step."""
    cfg, jmodel, jparams, tmodel, tparams = _setup()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    _, jc = jax.jit(jmodel.prefill)(jparams, {"tokens": toks})
    _, tc = tmodel.prefill(tparams, {"tokens": toks})
    step = jax.jit(jmodel.decode_step)
    for _ in range(6):
        nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = step(jparams, jc, nxt)
        tl, tc = tmodel.decode_step(tparams, tc, nxt)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        _assert_cache_close(tc, jc, TOL)
    assert int(tc["pos"]) == 43


def test_ssm_model_refuses_packed_prefill_as_reference():
    _, jmodel, _, tmodel, _ = _setup()
    for cache_len in (None, 16, 64):
        assert tmodel.supports_packed_prefill(cache_len) is False
        assert jmodel.supports_packed_prefill(cache_len) is False
