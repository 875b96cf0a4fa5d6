"""The arithmetic of the port's two scan kernels, emulated on the CPU.

The CUDA kernels run only on the card, so their arithmetic is repeated here
in torch, step for step as the sources do it, and held against the kernels'
plain versions and the JAX package (its reference and, where the shapes are
small, its Pallas kernel in interpret mode).  Inputs come from numpy with a
seed.

* ``linear_scan.cu``: chunks of T = 256 steps, each of NSUB = 8 runs of
  R = 32 steps.  A run's aggregate (prod a, h from 0), a chunk's aggregate
  from its runs, carries folded along S in chunk order from h0, then each
  run walked again from its carry.  Tolerance atol 1e-5, rtol 1e-4, as
  tests/test_torch_rglru.py holds the plain version against the reference.
  Where the state grows large (a near 1 with an input not scaled by
  sqrt(1 - a^2)) no float32 order holds that tolerance of the exact answer,
  the plain walk included; there both are held against float64 within the
  rounding of a chunk's 256-factor product of a, 256 * 2^-24 * max|h|.
* ``ssd_intra.cu``: 3xTF32 tensor-core products (x = hi + lo, hi rounded to
  TF32 to nearest, lo = x - hi read by the tensor core truncated to TF32;
  lo*hi + hi*lo + hi*hi summed in float32), cum in float64,
  decay exp((cum_l - cum_s) in float32) under a select.  Tolerance atol
  1e-3, rtol 1e-4, the kernel's own against its plain version on the card
  (chip_smoke.py, tests/test_torch_cuda.py).  One TF32 pass is pinned
  outside that tolerance at the served widths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.rglru_scan.ops import linear_scan as jax_linear_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import linear_scan_ref  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_intra as jax_ssd_intra  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_intra_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import linear_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra_plain  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4          # the scan
SSD_ATOL, SSD_RTOL = 1e-3, 1e-4  # the SSD intra-chunk term
T, NSUB = 256, 8                 # linear_scan.cu: steps a chunk, runs a chunk
R = T // NSUB                    # steps a run


# --- the scan ------------------------------------------------------------

def emulate_chunked_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """``linear_scan.cu``'s arithmetic in float32: a/b (B, S, W), h0 (B, W)."""
    a, b, h0 = a.float(), b.float(), h0.float()
    bsz, s, w = a.shape
    nch = -(-s // T)
    pad = nch * T - s  # the kernel's masked steps: a = 1, b = 0
    a = torch.cat([a, torch.ones(bsz, pad, w)], 1).reshape(bsz, nch, NSUB, R, w)
    b = torch.cat([b, torch.zeros(bsz, pad, w)], 1).reshape(bsz, nch, NSUB, R, w)
    # each run's aggregate: h from 0 (the first step gives b), prod a
    run_a, run_h = a[:, :, :, 0].clone(), b[:, :, :, 0].clone()
    for u in range(1, R):
        run_h = a[:, :, :, u] * run_h + b[:, :, :, u]
        run_a = a[:, :, :, u] * run_a
    # each chunk's aggregate from its runs
    ch_a, ch_h = run_a[:, :, 0].clone(), run_h[:, :, 0].clone()
    for q in range(1, NSUB):
        ch_h = run_a[:, :, q] * ch_h + run_h[:, :, q]
        ch_a = run_a[:, :, q] * ch_a
    out = torch.empty(bsz, nch, NSUB, R, w)
    carry = h0
    for k in range(nch):
        h_run = carry
        for q in range(NSUB):
            h = h_run
            for u in range(R):  # the run walked again from its carry
                h = a[:, k, q, u] * h + b[:, k, q, u]
                out[:, k, q, u] = h
            h_run = run_a[:, k, q] * h_run + run_h[:, k, q]
        carry = ch_a[:, k] * carry + ch_h[:, k]  # the next chunk's carry
    return out.reshape(bsz, nch * T, w)[:, :s]


def _scan_inputs(shape, seed, a_range=(0.2, 0.999), normalized=False):
    b, s, w = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(*a_range, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    if normalized:  # the RG-LRU's input, sqrt(1 - a^2) * x (models/rglru.py)
        x = (np.sqrt(1.0 - a.astype(np.float64) ** 2) * x).astype(np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32)
    return a, x, h0


def _scan_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


SCAN_S = [1, T - 1, T, T + 1, 4 * T + 7]


@pytest.mark.parametrize("s", SCAN_S, ids=[f"S{s}" for s in SCAN_S])
def test_chunked_scan_matches_plain_and_jax(s):
    """S = 1, a step under, at and past one chunk, and several chunks; ragged
    W; h0 != 0."""
    a, b, h0 = _scan_inputs((2, s, 37), seed=s)
    got = emulate_chunked_scan(*map(torch.from_numpy, (a, b, h0)))
    _scan_close(got, linear_scan_plain(*map(torch.from_numpy, (a, b, h0))))
    _scan_close(got, linear_scan_ref(a, b, h0))
    _scan_close(got, jax_linear_scan(a, b, h0))  # Pallas, interpret mode on the CPU


@pytest.mark.parametrize("a_range,normalized", [((0.0, 1e-3), False), ((0.9999, 1.0), True)],
                         ids=["a_near_0", "a_near_1"])
def test_chunked_scan_at_extreme_decays(a_range, normalized):
    """a near 0 (a chunk's product underflows) and near 1 with the RG-LRU's
    normalized input, over many chunks."""
    a, b, h0 = _scan_inputs((2, 3 * T + 5, 33), seed=6, a_range=a_range, normalized=normalized)
    got = emulate_chunked_scan(*map(torch.from_numpy, (a, b, h0)))
    _scan_close(got, linear_scan_plain(*map(torch.from_numpy, (a, b, h0))))
    _scan_close(got, linear_scan_ref(a, b, h0))


def test_chunked_scan_with_a_large_state_against_float64():
    """a near 1 and an input not scaled by sqrt(1 - a^2): h walks to ~10^2,
    and float32 rounding of the state alone puts the plain walk outside the
    scan's tolerance of the exact answer; the chunked arithmetic and the
    plain walk both stay within a chunk's product rounding of it."""
    a, b, h0 = _scan_inputs((2, 3 * T + 5, 130), seed=6, a_range=(0.9999, 1.0))
    exact = np.empty(a.shape)
    h = h0.astype(np.float64)
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        exact[:, t] = h
    atol = T * 2.0 ** -24 * np.abs(exact).max()
    plain = linear_scan_plain(*map(torch.from_numpy, (a, b, h0))).numpy()
    assert not np.allclose(plain, exact, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(plain, exact, atol=atol, rtol=RTOL)
    got = emulate_chunked_scan(*map(torch.from_numpy, (a, b, h0))).numpy()
    np.testing.assert_allclose(got, exact, atol=atol, rtol=RTOL)


# --- the SSD intra-chunk term -----------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as the kernel's split does: add half of the dropped 13 bits'
    range, then mask them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: its top 19 bits."""
    return (x.float().contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on the tensor cores: one TF32 pass, or 3xTF32 (lo*hi + hi*lo +
    hi*hi, float32 sums)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate_ssd_intra(xc, dac, bc, cc, passes: int = 3) -> torch.Tensor:
    """``ssd_intra.cu``'s arithmetic: xc (B, nc, L, H, P), dac (B, H, nc, L),
    bc/cc (B, nc, L, N) -> (B, nc, L, H, P) float32."""
    xc, dac, bc, cc = (t.float() for t in (xc, dac, bc, cc))
    l = xc.shape[2]
    g = _mm(cc, bc.transpose(-1, -2), passes)                # (B, nc, L, L)
    cum = torch.cumsum(dac.double(), dim=-1)                   # (B, H, nc, L) float64
    diff = (cum[..., :, None] - cum[..., None, :]).float()    # cum_l - cum_s
    live = torch.tril(torch.ones(l, l, dtype=torch.bool))
    decay = torch.where(live, torch.exp(torch.where(live, diff, 0.0)), 0.0)
    scores = g[:, :, None] * decay.permute(0, 2, 1, 3, 4)         # (B, nc, H, L, L)
    y = _mm(scores, xc.permute(0, 1, 3, 2, 4), passes)       # (B, nc, H, L, P)
    return y.permute(0, 1, 3, 2, 4)


def _intra_inputs(shape, seed, da_range):
    b, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, l, h, p), dtype=np.float32)
    dac = rng.uniform(*da_range, (b, h, nc, l)).astype(np.float32)
    bc = rng.standard_normal((b, nc, l, n), dtype=np.float32)
    cc = rng.standard_normal((b, nc, l, n), dtype=np.float32)
    return xc, dac, bc, cc


def _ssd_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SSD_ATOL, rtol=SSD_RTOL)


# tests/test_torch_ssd.py's INTRA_SHAPES (B, nc, L, H, P, N)
INTRA_SHAPES = [
    (2, 3, 16, 2, 8, 4),
    (1, 2, 32, 4, 16, 16),
    (1, 4, 64, 3, 32, 8),
    (1, 1, 77, 3, 16, 8),
    (2, 2, 20, 5, 12, 10),
]


@pytest.mark.parametrize("da_range", [(-0.5, -0.01), (-1.6, 0.0)], ids=["test_kernels", "dt_A"])
@pytest.mark.parametrize("shape", INTRA_SHAPES, ids=[str(s) for s in INTRA_SHAPES])
def test_3xtf32_intra_matches_plain_and_jax(shape, da_range):
    inputs = _intra_inputs(shape, seed=0, da_range=da_range)
    got = emulate_ssd_intra(*map(torch.from_numpy, inputs))
    assert bool(torch.isfinite(got).all())
    _ssd_close(got, ssd_intra_plain(*map(torch.from_numpy, inputs)))
    _ssd_close(got, ssd_intra_ref(*inputs))
    _ssd_close(got, jax_ssd_intra(*inputs))  # Pallas, interpret mode on the CPU


SERVED_CHUNK = (1, 1, 128, 24, 64, 128)  # one chunk of mamba2-130m: L 128, H 24, P 64, N 128


def _served_chunk():
    inputs = _intra_inputs(SERVED_CHUNK, seed=1, da_range=(-1.6, 0.0))
    want = ssd_intra_plain(*map(torch.from_numpy, inputs)).numpy()
    return inputs, want


def test_3xtf32_intra_at_served_widths():
    inputs, want = _served_chunk()
    got = emulate_ssd_intra(*map(torch.from_numpy, inputs))
    _ssd_close(got, want)
    _ssd_close(got, ssd_intra_ref(*inputs))


def test_one_tf32_pass_misses_the_tolerance_at_served_widths():
    """Why the kernel splits every operand: one TF32 pass (10 mantissa bits)
    puts the served widths' outputs well outside the tolerance that 3xTF32
    holds."""
    inputs, want = _served_chunk()
    once = emulate_ssd_intra(*map(torch.from_numpy, inputs), passes=1).numpy()
    worst = float((np.abs(once - want) / (SSD_ATOL + SSD_RTOL * np.abs(want))).max())
    assert worst > 10.0, worst
    three = emulate_ssd_intra(*map(torch.from_numpy, inputs)).numpy()
    assert float((np.abs(three - want) / (SSD_ATOL + SSD_RTOL * np.abs(want))).max()) < 0.5
