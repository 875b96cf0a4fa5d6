"""Plain PyTorch version of the SSD intra-chunk kernel.

Follows ``repro.kernels.ssd_scan.ref.ssd_intra_ref``: a segment sum of dA
with -inf above the diagonal, ``exp`` of it as the decay matrix, then one
four-operand einsum, all in float32.  The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import torch


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) cumulative segment sums, -inf above the
    diagonal (so that ``exp`` gives 0 there, never inf * 0)."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_intra_plain(xc, dac, bc, cc) -> torch.Tensor:
    """Intra-chunk SSD term.

    xc:  (B, nc, L, H, P)  dt-weighted inputs
    dac: (B, H, nc, L)     dt * A
    bc:  (B, nc, L, N)
    cc:  (B, nc, L, N)
    ->   (B, nc, L, H, P) float32
    """
    lmat = torch.exp(_segsum(dac.float()))
    return torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", cc.float(), bc.float(), lmat, xc.float())
