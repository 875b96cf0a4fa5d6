"""The RG-LRU scan and SSD intra-chunk kernels against their plain versions on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so the card's machine,
which has no JAX, collects it:

    python -m pytest -q -m cuda tests/test_torch_cuda.py tests/test_torch_flash_attention.py

Inputs come from numpy with a seed.  Tolerances, float32:
  * the scan: atol 1e-5, rtol 1e-4, as tests/test_torch_rglru.py holds the
    plain version against the reference (within a 32-step run the kernel
    walks the plain version's recurrence with a fused FMA; the carry into
    the run is the same product of the steps before it, associated in runs
    of 32 and 256 steps);
  * the SSD intra-chunk term: atol 1e-3, rtol 1e-4.  The two sum over N and
    L in other orders, and cum = cumsum(dA) reaches about -100 to -200 over
    a 128-step chunk with dA in [-1.6, 0], where one ulp (~1e-5) moves a
    decay factor by ~1e-5 relative; the plain version in float32 against
    float64 at mamba2-130m's shape (a CPU run) is off by up to 5.7e-4 on
    outputs up to ~200.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.kernels.rglru_scan import linear_scan, linear_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.common import ParamBuilder  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
SCAN_SHAPES = [  # (B, S, W): ragged S and W; the last is recurrentgemma-2b's longest prefill
    (1, 37, 50),
    (2, 300, 130),
    (3, 1, 7),
    (1, 257, 129),
    (1, 3000, 2560),
]
# linear_scan.cu: a block owns 32 channels x 256 steps (a chunk of S), and
# chunks pass carries along S; shapes at its edges: S = 1, one step under,
# at and past a chunk, many chunks, B > 1, W not a multiple of 32
SCAN_CHUNK, SCAN_TILE = 256, 32
SCAN_EDGES = [
    (1, 1, 2560),
    (1, SCAN_CHUNK - 1, SCAN_TILE),
    (1, SCAN_CHUNK, SCAN_TILE),
    (1, SCAN_CHUNK + 1, SCAN_TILE),
    (2, 12 * SCAN_CHUNK + 3, 100),
    (3, 2 * SCAN_CHUNK + 1, 2561),
    (4, 1000, SCAN_TILE + 1),
]


SSD_ATOL, SSD_RTOL = 1e-3, 1e-4
SSD_SHAPES = [  # (B, nc, L, H, P, N): mamba2-130m's longest prompt (2000 -> 16 x 128),
    (1, 16, 128, 24, 64, 128),  # a prompt under one chunk, then ragged L, P, N
    (1, 1, 77, 24, 64, 128),
    (2, 3, 100, 5, 80, 40),
    (3, 2, 1, 3, 16, 200),
]
# ssd_intra.cu: 16-row strips and 8-column tiles of the (L, L) scores, P in
# passes of 64; L at 1, one strip, one past it and a whole chunk; P and N
# not multiples of 8
SSD_EDGES = [
    (1, 2, 1, 3, 64, 128),
    (1, 2, 16, 4, 64, 128),
    (2, 2, 17, 3, 64, 128),
    (1, 3, 128, 5, 64, 128),
    (1, 2, 128, 3, 20, 36),
    (2, 2, 17, 2, 13, 11),
    (1, 1, 100, 2, 130, 203),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _scan_inputs(shape, device, seed=0):
    b, s, w = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.999, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w), dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32)
    return [torch.from_numpy(t).to(device) for t in (a, bb, h0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=[str(s) for s in SCAN_SHAPES])
def test_scan_kernel_matches_plain_on_card(shape, cuda_device):
    a, b, h0 = _scan_inputs(shape, cuda_device)
    before = linear_scan.launches
    got = linear_scan(a, b, h0)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    want = linear_scan_plain(a, b, h0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_EDGES, ids=[str(s) for s in SCAN_EDGES])
def test_scan_kernel_at_chunk_edges_on_card(shape, cuda_device):
    a, b, h0 = _scan_inputs(shape, cuda_device, seed=5)
    got = linear_scan(a, b, h0)
    torch.cuda.synchronize()
    want = linear_scan_plain(a, b, h0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_scan_kernel_near_zero_and_one_on_card(cuda_device):
    """a near 0 (a chunk's product underflows), and near 1 with the RG-LRU's
    input sqrt(1 - a^2) * x, across several chunks, against the plain
    version; a near 1 with x unscaled, where h walks to ~10^2 and no float32
    order holds the tolerance of the exact answer (the plain walk neither;
    tests/test_torch_scan_numerics.py), against float64 within the rounding
    of a chunk's 256-factor product of a, 256 * 2^-24 * max|h|."""
    _, x, h0 = _scan_inputs((2, 3 * SCAN_CHUNK + 5, 130), cuda_device, seed=6)
    rng = np.random.default_rng(6)
    for lo, hi, scale in ((0.0, 1e-3, False), (0.9999, 1.0, True), (0.9999, 1.0, False)):
        a = torch.from_numpy(rng.uniform(lo, hi, x.shape).astype(np.float32)).to(cuda_device)
        b = torch.sqrt(1.0 - a.double() ** 2).float() * x if scale else x
        got = linear_scan(a, b, h0).cpu().numpy()
        if lo == 0.0 or scale:
            want = linear_scan_plain(a, b, h0).cpu().numpy()
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
            continue
        exact, h = np.empty(got.shape), h0.double().cpu().numpy()
        an, bn = a.double().cpu().numpy(), b.double().cpu().numpy()
        for t in range(got.shape[1]):
            h = an[:, t] * h + bn[:, t]
            exact[:, t] = h
        np.testing.assert_allclose(got, exact, atol=SCAN_CHUNK * 2.0 ** -24 * np.abs(exact).max(),
                                   rtol=RTOL)


@pytest.mark.cuda
def test_scan_kernel_repeats_bitwise_on_card(cuda_device):
    """20 calls at recurrentgemma-2b's longest prefill give the same bits:
    a carry is folded in chunk order whichever chunk the look-back stops at,
    so the order in which blocks publish does not show."""
    a, b, h0 = _scan_inputs((1, 2915, 2560), cuda_device, seed=7)
    first = linear_scan(a, b, h0)
    for _ in range(19):
        assert torch.equal(linear_scan(a, b, h0), first)


@pytest.mark.cuda
def test_rglru_scan_launches_the_kernel_on_card(cuda_device):
    """The model's ``rglru_scan`` on a CUDA tensor goes through the kernel,
    once per call, and returns y in the input's dtype and h_last float32."""
    w = 64
    rng = np.random.default_rng(1)
    params = {n: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1).to(cuda_device)
              for n, s in (("wa", (w, w)), ("wi", (w, w)), ("ba", (w,)), ("bi", (w,)), ("lam", (w,)))}
    xc = torch.from_numpy(rng.standard_normal((2, 50, w), dtype=np.float32)).to(cuda_device)
    before = linear_scan.launches
    y, h_last = rglru.rglru_scan(params, xc.bfloat16())
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    assert bool(torch.isfinite(h_last).all())


def _ssd_inputs(shape, device, seed=0):
    """xc contiguous; dac a permuted view and bc/cc slices of one wider
    tensor, as ``ssm.ssd_chunked`` passes them (the kernel reads strides)."""
    b, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, l, h, p), dtype=np.float32)
    da = rng.uniform(-1.6, 0.0, (b, nc, l, h)).astype(np.float32)
    bcc = rng.standard_normal((b, nc, l, 2 * n + 3), dtype=np.float32)
    xc, da, bcc = (torch.from_numpy(t).to(device) for t in (xc, da, bcc))
    return xc, da.permute(0, 3, 1, 2), bcc[..., :n], bcc[..., n : 2 * n]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=[str(s) for s in SSD_SHAPES])
def test_ssd_intra_kernel_matches_plain_on_card(shape, cuda_device):
    xc, dac, bc, cc = _ssd_inputs(shape, cuda_device)
    assert not dac.is_contiguous() and not bc.is_contiguous()
    before = ssd_intra.launches
    got = ssd_intra(xc, dac, bc, cc)
    torch.cuda.synchronize()
    assert ssd_intra.launches == before + 1
    want = ssd_intra_plain(xc, dac, bc, cc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("contiguous", [False, True], ids=["views", "contiguous"])
@pytest.mark.parametrize("shape", SSD_EDGES, ids=[str(s) for s in SSD_EDGES])
def test_ssd_intra_kernel_at_tile_edges_on_card(shape, contiguous, cuda_device):
    """The permuted dac and sliced bc/cc views of the model (16-byte copies
    of B and C ruled out by their odd row stride), and contiguous copies
    (16-byte copies where N allows)."""
    xc, dac, bc, cc = _ssd_inputs(shape, cuda_device, seed=8)
    if contiguous:
        dac, bc, cc = dac.contiguous(), bc.contiguous(), cc.contiguous()
    got = ssd_intra(xc, dac, bc, cc)
    torch.cuda.synchronize()
    want = ssd_intra_plain(xc, dac, bc, cc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.cuda
def test_ssd_block_launches_the_kernel_on_card(cuda_device):
    """The model's ``ssd_block`` on a CUDA tensor goes through the kernel,
    once per call, and agrees with the same block on the CPU (the plain
    version) in float32."""
    cfg = get_reduced_config("mamba2_130m").replace(dtype="float32")
    pb = ParamBuilder(dtype=torch.float32)
    ssm.declare_ssd(pb, "ssd", cfg)
    params = pb.init(torch.Generator().manual_seed(0), "cpu")["ssd"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 45, cfg.d_model),
                                                                  dtype=np.float32))
    want, (ws, _) = ssm.ssd_block(params, x, cfg)
    before = ssd_intra.launches
    got, (gs, _) = ssm.ssd_block({k: v.to(cuda_device) for k, v in params.items()},
                                 x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert ssd_intra.launches == before + 1
    assert gs.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)
    np.testing.assert_allclose(gs.cpu().numpy(), ws.numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)
