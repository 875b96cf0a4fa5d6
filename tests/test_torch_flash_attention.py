"""The port's flash attention against the JAX package's.

On the CPU the port's wrapper runs its plain version; it is held against
``repro.kernels.flash_attention.ops.flash_attention`` run in interpret mode
(as tests/test_kernels.py runs it) over the same seven shapes.  Inputs come
from numpy with a seed and go to both packages.  Tolerances are those of
tests/test_kernels.py: 2e-5 in float32, 3e-2 in bfloat16 (bf16 rounds at
other places in the two frameworks).

The tests marked ``cuda`` hold the CUDA kernel against the plain version on
the card and skip where there is none.  JAX is imported inside the tests
that use it, so the card's machine, which has no JAX, collects this file.

The bf16 kernel runs its products on the tensor cores and rounds P to bf16
before the PV product.  ``_emulate_bf16_kernel`` repeats that arithmetic in
plain PyTorch on the CPU (tile by tile, as the kernel does) so that the
tests here show the rounding fits the bf16 tolerance the card applies.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.flash_attention import attention_plain, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models.attention import attention, attn_xla  # noqa: E402

FA_CASES = [
    # b, sq, skv, h, hkv, hd, causal, window, dtype
    (2, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 256, 4, 4, 32, True, 64, "float32"),
    (1, 256, 256, 8, 1, 16, True, 0, "float32"),      # MQA
    (2, 64, 192, 2, 1, 16, False, 0, "bfloat16"),     # cross attention
    (1, 100, 100, 4, 2, 64, True, 0, "float32"),      # ragged: not a tile multiple
    (1, 128, 128, 2, 2, 128, True, 32, "bfloat16"),   # narrow window
    (3, 96, 96, 6, 3, 48, True, 0, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, seed=0):
    b, sq, skv, h, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, sq, h, hd), dtype=np.float32),
        rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
        rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
    )


def _to_torch(arrays, dt, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=TORCH_DT[dt]) for a in arrays]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_plain_matches_jax_flash_attention(case):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention

    causal, window, dt = case[6], case[7], case[8]
    q, k, v = _inputs(case)
    want = jax_flash_attention(
        jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
        causal=causal, window=window, block_q=64, block_k=64,
    )
    tq, tk, tv = _to_torch((q, k, v), dt)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert flash_attention.launches == before, "a CPU tensor must not count as a launch"
    assert got.dtype == TORCH_DT[dt] and got.shape == tq.shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dt], rtol=TOL[dt]
    )


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_attention_dispatcher_on_cpu_matches_plain(case):
    """The model's dispatcher takes ``attn_xla`` on the CPU; it computes the
    same function as the kernel's plain version (float32 inputs, 2e-5)."""
    causal, window = case[6], case[7]
    tq, tk, tv = _to_torch(_inputs(case, seed=1), "float32")
    want = attention_plain(tq, tk, tv, causal=causal, window=window)
    got = attention(tq, tk, tv, impl="chunked", causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    got_xla = attn_xla(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(got_xla.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


# recurrentgemma's heads: hd 256, one KV head (MQA), a sliding window;
# ragged S, and S past the window so the window cuts causal rows
RG_CASES = [
    # b, sq, skv, h, hkv, hd, causal, window, dtype
    (1, 150, 150, 10, 1, 256, True, 64, "float32"),
    (2, 97, 97, 4, 1, 256, True, 32, "bfloat16"),
    (1, 80, 80, 2, 1, 200, True, 0, "float32"),  # hd between 128 and 256
]


@pytest.mark.parametrize("case", RG_CASES, ids=[str(c) for c in RG_CASES])
def test_plain_matches_jax_reference_at_recurrentgemma_heads(case):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ref import attention_ref

    causal, window, dt = case[6], case[7], case[8]
    q, k, v = _inputs(case, seed=2)
    want = attention_ref(jnp.asarray(q, dt), jnp.asarray(k, dt), jnp.asarray(v, dt),
                         causal=causal, window=window)
    got = flash_attention(*_to_torch((q, k, v), dt), causal=causal, window=window)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dt], rtol=TOL[dt]
    )


def test_wrapper_raises_off_cpu_and_cuda():
    """Neither a CPU nor a CUDA tensor: no plain fallback, no launch."""
    q = torch.zeros(1, 8, 4, 16, device="meta")
    before = flash_attention.launches
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)
    assert flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_kernel_matches_plain_on_card(case, cuda_device):
    causal, window, dt = case[6], case[7], case[8]
    tq, tk, tv = _to_torch(_inputs(case), dt, cuda_device)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), atol=TOL[dt], rtol=TOL[dt]
    )


@pytest.mark.cuda
def test_kernel_matches_plain_at_granite_shape(cuda_device):
    case = (2, 777, 777, 32, 8, 128, True, 0, "bfloat16")  # ragged, granite heads
    tq, tk, tv = _to_torch(_inputs(case), "bfloat16", cuda_device)
    got = flash_attention(tq, tk, tv, causal=True)
    want = attention_plain(tq, tk, tv, causal=True)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), atol=3e-2, rtol=3e-2
    )


@pytest.mark.cuda
@pytest.mark.parametrize("case", RG_CASES + [(1, 3000, 3000, 10, 1, 256, True, 2048, "bfloat16")],
                         ids=[str(c) for c in RG_CASES] + ["recurrentgemma-2b"])
def test_kernel_matches_plain_at_recurrentgemma_heads(case, cuda_device):
    causal, window, dt = case[6], case[7], case[8]
    tq, tk, tv = _to_torch(_inputs(case), dt, cuda_device)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    want = attention_plain(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), atol=TOL[dt], rtol=TOL[dt]
    )


# ---------------------------------------------------------------------------
# The bf16 kernel's numerics, emulated on the CPU
# ---------------------------------------------------------------------------


def _emulate_bf16_kernel(q, k, v, *, causal=True, window=0, split_p=True):
    """The bf16 CUDA kernel's arithmetic in plain PyTorch, for these tests
    only: kv tiles of the kernel's width (64 at hd <= 64, 32 above), S in
    float32 from the bf16 inputs, masked scores -inf, a
    base-2 online softmax with scale * log2(e) folded in, l summed from the
    float32 p, and P fed to the PV product as bf16 hi + lo parts
    (``split_p=False``: P rounded once to bf16, which the kernel does not
    do)."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    bk = 32 if hd > 64 else 64
    scale_log2 = math.log2(math.e) / math.sqrt(hd)
    qf = q.float().transpose(1, 2)  # (b, h, sq, hd)
    kf = k.float().repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    i = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, hd))
    for k0 in range(0, skv, bk):
        j = torch.arange(k0, min(k0 + bk, skv))[None, :]
        s = qf @ kf[:, :, k0 : k0 + bk].transpose(-1, -2)
        live = torch.ones((sq, j.shape[1]), dtype=torch.bool)
        if causal:
            live &= j <= i
        if window > 0:
            live &= i - j < window
        s = torch.where(live, s, torch.tensor(-math.inf))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - mx) * scale_log2)
        p = torch.exp2(s * scale_log2 - mx * scale_log2)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, :, k0 : k0 + bk]
        if split_p:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vf[:, :, k0 : k0 + bk]
        acc = acc * alpha + pv
        m = mx
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(q.dtype)


# the models' scales under the reference's init rule: granite-3-8b's q, k, v
# entries have std ~11.3, ~22.6, ~22.6 (scores of std ~256), recurrentgemma-
# 2b's ~16, ~50.6, ~50.6 (one KV head: scores of std ~800): near one-hot rows
GRANITE_STD, RG_STD = (11.3, 22.6, 22.6), (16.0, 50.6, 50.6)
EMU_CASES = [
    # b, sq, skv, h, hkv, hd, causal, window, (q, k, v std): reduced granite
    # heads (GQA 4:1, hd 128) and recurrentgemma heads (MQA, hd 256, a
    # window); ragged S, a window under one kv tile, Sq != Skv; then the
    # models' scales
    (2, 200, 200, 8, 2, 128, True, 0, (1.0, 1.0, 1.0)),
    (1, 300, 300, 4, 1, 256, True, 64, (1.0, 1.0, 1.0)),
    (2, 77, 77, 4, 2, 128, True, 0, (1.0, 1.0, 1.0)),
    (1, 150, 150, 2, 1, 256, True, 16, (1.0, 1.0, 1.0)),
    (1, 65, 130, 4, 2, 72, False, 0, (1.0, 1.0, 1.0)),
    (2, 160, 160, 8, 2, 128, True, 0, GRANITE_STD),
    (1, 200, 200, 4, 1, 256, True, 64, RG_STD),
]
EMU_TOL = 3e-2  # the bf16 tolerance of the card's checks (chip_smoke.TOL)


def _emu_inputs(case, seed=3):
    b, sq, skv, h, hkv, hd, *_, (q_std, k_std, v_std) = case
    rng = np.random.default_rng(seed)
    return (
        q_std * rng.standard_normal((b, sq, h, hd), dtype=np.float32),
        k_std * rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
        v_std * rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
    )


@pytest.mark.parametrize("case", EMU_CASES, ids=[str(c) for c in EMU_CASES])
def test_bf16_kernel_numerics_match_plain(case):
    causal, window = case[6], case[7]
    tq, tk, tv = _to_torch(_emu_inputs(case), "bfloat16")
    got = _emulate_bf16_kernel(tq, tk, tv, causal=causal, window=window)
    want = attention_plain(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=EMU_TOL, rtol=EMU_TOL)


@pytest.mark.parametrize("case", EMU_CASES[:4] + EMU_CASES[5:],
                         ids=[str(c) for c in EMU_CASES[:4] + EMU_CASES[5:]])
def test_bf16_kernel_numerics_match_jax_flash_attention(case):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention

    causal, window = case[6], case[7]
    q, k, v = (t.float().numpy() for t in _to_torch(_emu_inputs(case), "bfloat16"))
    want = jax_flash_attention(
        jnp.asarray(q, "bfloat16"), jnp.asarray(k, "bfloat16"), jnp.asarray(v, "bfloat16"),
        causal=causal, window=window, block_q=64, block_k=64,
    )
    got = _emulate_bf16_kernel(*_to_torch((q, k, v), "bfloat16"), causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=EMU_TOL, rtol=EMU_TOL)


@pytest.mark.parametrize("model,hd,hkv,window,std", [
    ("granite-3-8b", 128, 8, 0, GRANITE_STD), ("recurrentgemma-2b", 256, 1, 256, RG_STD)])
def test_p_split_holds_the_tolerance_at_model_scale(model, hd, hkv, window, std):
    """Why the kernel splits P into bf16 hi + lo parts: at the models' scale
    (one prompt of 600 tokens, 8 query heads) P rounded once to bf16 puts
    outputs outside the bf16 tolerance where large V rows cancel; the split
    keeps every output inside it."""
    case = (1, 600, 600, 8, hkv, hd, True, window, std)
    tq, tk, tv = _to_torch(_emu_inputs(case, seed=4), "bfloat16")
    want = attention_plain(tq, tk, tv, window=window).float()
    tol = EMU_TOL + EMU_TOL * want.abs()
    once = _emulate_bf16_kernel(tq, tk, tv, window=window, split_p=False).float()
    split = _emulate_bf16_kernel(tq, tk, tv, window=window).float()
    assert int(((once - want).abs() > tol).sum()) > 0, model
    assert int(((split - want).abs() > tol).sum()) == 0, model


# ---------------------------------------------------------------------------
# The bf16 kernel's edges on the card
# ---------------------------------------------------------------------------

BF16_EDGE_CASES = [
    # b, sq, skv, h, hkv, hd, causal, window, dtype
    (2, 130, 130, 4, 2, 72, True, 0, "bfloat16"),      # hd padded to 128 in shared memory
    (1, 300, 300, 3, 1, 200, True, 64, "bfloat16"),    # hd padded to 256, windowed
    (2, 200, 200, 4, 4, 64, True, 0, "bfloat16"),      # hd 64, no window
    (1, 333, 333, 4, 1, 256, True, 0, "bfloat16"),     # hd 256, no window
    (3, 1, 1, 4, 2, 128, True, 0, "bfloat16"),         # one row
    (2, 65, 65, 4, 1, 256, True, 0, "bfloat16"),       # one past a tile
    (2, 777, 777, 4, 2, 128, True, 0, "bfloat16"),
    (2, 65, 777, 4, 2, 128, False, 0, "bfloat16"),     # Sq != Skv, not causal
    (1, 777, 65, 2, 1, 256, False, 0, "bfloat16"),
    (2, 1, 777, 8, 2, 128, False, 0, "bfloat16"),
    (2, 256, 256, 4, 2, 128, True, 16, "bfloat16"),    # window under one kv tile
    (1, 200, 200, 2, 1, 256, True, 16, "bfloat16"),
    (7, 100, 100, 19, 19, 128, True, 0, "bfloat16"),   # B*H = 133, not a multiple of 132
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_EDGE_CASES, ids=[str(c) for c in BF16_EDGE_CASES])
def test_bf16_kernel_matches_plain_at_edges_on_card(case, cuda_device):
    causal, window, dt = case[6], case[7], case[8]
    tq, tk, tv = _to_torch(_inputs(case), dt, cuda_device)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    torch.cuda.synchronize()
    want = attention_plain(tq, tk, tv, causal=causal, window=window)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(
        got.float().cpu().numpy(), want.float().cpu().numpy(), atol=TOL[dt], rtol=TOL[dt]
    )


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hkv,window", [(128, 8, 0), (256, 1, 2048)], ids=["hd128", "hd256"])
def test_bf16_call_is_one_launch_on_card(hd, hkv, window, cuda_device):
    case = (1, 300, 300, 2 * hkv if hkv > 1 else 10, hkv, hd, True, window, "bfloat16")
    tq, tk, tv = _to_torch(_inputs(case), "bfloat16", cuda_device)
    before = flash_attention.launches
    flash_attention(tq, tk, tv, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
