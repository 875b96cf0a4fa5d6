"""The RG-LRU scan kernel against its plain version on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so the card's machine,
which has no JAX, collects it:

    python -m pytest -q -m cuda tests/test_torch_cuda.py tests/test_torch_flash_attention.py

Inputs come from numpy with a seed.  Tolerance atol 1e-5, rtol 1e-4 in
float32, as tests/test_torch_rglru.py holds the plain version against the
reference (the kernel and the plain version run the same recurrence in the
same order, so they differ only where the compiler fuses the FMA).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels.rglru_scan import linear_scan, linear_scan_plain  # noqa: E402
from repro_torch.models import rglru  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
SCAN_SHAPES = [  # (B, S, W): ragged S and W; the last is recurrentgemma-2b's longest prefill
    (1, 37, 50),
    (2, 300, 130),
    (3, 1, 7),
    (1, 257, 129),
    (1, 3000, 2560),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel runs only on the card")
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
