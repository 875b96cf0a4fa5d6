"""Plain PyTorch version of the RG-LRU linear-scan kernel.

Follows ``repro.kernels.rglru_scan.ref.linear_scan_ref``: a sequential walk
of h_t = a_t * h_{t-1} + b_t over the sequence axis, in float32.  The CPU
tests run it, and ``chip_smoke.py`` holds the CUDA kernel against it on the
card.
"""

from __future__ import annotations

import torch


def linear_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a/b: (B, S, W); h0: (B, W) -> (B, S, W) float32."""
    a, b = a.float(), b.float()
    h = h0.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
