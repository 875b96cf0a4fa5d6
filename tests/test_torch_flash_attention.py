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
"""

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
