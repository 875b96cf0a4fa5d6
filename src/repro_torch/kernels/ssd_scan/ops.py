"""Wrapper of the CUDA SSD intra-chunk kernel.

PyTorch counterpart of ``repro.kernels.ssd_scan.ops.ssd_intra``, with its
signature and layouts: xc (B, nc, L, H, P), dac (B, H, nc, L), bc/cc
(B, nc, L, N) in, (B, nc, L, H, P) float32 out.  The kernel
(``csrc/ssd_intra.cu``) replaces the Pallas kernel
``repro/kernels/ssd_scan/kernel.py::_ssd_kernel``.

The kernel reads every input through its strides, so the views that
``models.ssm.ssd_chunked`` passes (dac a permuted view of dA, bc/cc slices
of the conv output) go in without a copy.  The one copy the wrapper makes
is of an input whose last axis (P or N) is not contiguous, which the kernel
cannot read with strides.

A tensor on the CPU takes the plain version (``ref.ssd_intra_plain``); a
CUDA tensor launches the kernel or raises.  ``ssd_intra.launches`` counts
the launches.
"""

from __future__ import annotations

import torch

from ... import _build
from .ref import ssd_intra_plain

MAX_L = 128  # the kernel keeps one chunk's (L, L) tiles in shared memory


def _inner_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 or t.shape[-1] == 1 else t.contiguous()


def ssd_intra(xc: torch.Tensor, dac: torch.Tensor, bc: torch.Tensor, cc: torch.Tensor) -> torch.Tensor:
    if xc.device.type == "cpu":
        return ssd_intra_plain(xc, dac, bc, cc)
    if xc.device.type != "cuda":
        raise ValueError(f"ssd_intra runs on cuda or cpu tensors, not {xc.device}")
    if xc.dim() != 5:
        raise ValueError(f"need xc (B, nc, L, H, P): {tuple(xc.shape)}")
    bsz, nc, l, h, p = xc.shape
    if (dac.dim() != 4 or tuple(dac.shape) != (bsz, h, nc, l) or bc.dim() != 4
            or tuple(bc.shape[:3]) != (bsz, nc, l) or bc.shape != cc.shape):
        raise ValueError(f"need dac (B, H, nc, L) and bc/cc (B, nc, L, N) for xc {tuple(xc.shape)}: "
                         f"{tuple(dac.shape)}, {tuple(bc.shape)}, {tuple(cc.shape)}")
    if any(t.device != xc.device for t in (dac, bc, cc)):
        raise ValueError("xc, dac, bc and cc must be on one device")
    if any(t.dtype != torch.float32 for t in (xc, dac, bc, cc)):
        raise ValueError("ssd_intra takes float32 inputs, as the model passes them")
    if l > MAX_L:
        raise ValueError(f"chunk length {l} > {MAX_L}: the kernel holds one chunk in shared memory")
    out = torch.empty((bsz, nc, l, h, p), dtype=torch.float32, device=xc.device)
    if out.numel() == 0:
        return out
    xc, bc, cc = (_inner_contiguous(t) for t in (xc, bc, cc))
    lib = _build.load("ssd_intra")
    err = lib.ssd_intra_fwd(
        xc.data_ptr(), dac.data_ptr(), bc.data_ptr(), cc.data_ptr(), out.data_ptr(),
        bsz, nc, l, h, p, bc.shape[-1],
        *xc.stride()[:4], *dac.stride(), *bc.stride()[:3], *cc.stride()[:3],
        torch.cuda.current_stream(xc.device).cuda_stream,
    )
    if err != 0:
        msg = lib.ssd_intra_error_string(err).decode()
        raise RuntimeError(f"ssd_intra_fwd launch failed: {msg} ({err})")
    ssd_intra.launches += 1
    return out


ssd_intra.launches = 0
