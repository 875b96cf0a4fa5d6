"""Wrapper of the CUDA RG-LRU linear-scan kernel.

PyTorch counterpart of ``repro.kernels.rglru_scan.ops.linear_scan``, with
its signature and contract: h_t = a_t * h_{t-1} + b_t, a/b (B, S, W) and h0
(B, W) in, (B, S, W) float32 out.  The kernel (``csrc/linear_scan.cu``)
replaces the Pallas kernel
``repro/kernels/rglru_scan/kernel.py::_scan_kernel``; it masks ragged S and
W itself, so the wrapper makes no padded copy (the reference pads to block
multiples with a=1, b=0).  The kernel scans chunks of S in parallel and
passes carries between them through scratch that the wrapper allocates for
each call as one zeroed buffer: a ticket and chunk flags, then the chunks'
aggregates.

A tensor on the CPU takes the plain version (``ref.linear_scan_plain``); a
CUDA tensor launches the kernel or raises.  ``linear_scan.launches`` counts
the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import _build
from .ref import linear_scan_plain


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return linear_scan_plain(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan runs on cuda or cpu tensors, not {a.device}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"need a/b (B, S, W) and h0 (B, W): {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(h0.shape)}")
    if not (b.device == a.device and h0.device == a.device):
        raise ValueError("a, b and h0 must be on one device")
    bsz, s, w = a.shape
    out = torch.empty((bsz, s, w), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    a, b, h0 = (t.float().contiguous() for t in (a, b, h0))
    lib = _build.load("linear_scan")
    n_ints, n_floats = _scratch_size(bsz, s, w)
    # one allocation and one memset a call: the ticket and flags need zeros,
    # the aggregates (after them) take any contents
    scratch = torch.zeros(n_ints + n_floats, dtype=torch.int32, device=a.device)
    err = lib.linear_scan_fwd(
        a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr() + 4 * n_ints, bsz, s, w,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        msg = lib.linear_scan_error_string(err).decode()
        raise RuntimeError(f"linear_scan_fwd launch failed: {msg} ({err})")
    linear_scan.launches += 1
    return out


linear_scan.launches = 0


@functools.lru_cache(maxsize=64)
def _scratch_size(bsz: int, s: int, w: int) -> tuple[int, int]:
    """(int32 words, float32 words) of scratch the kernel needs at (B, S, W),
    from its own tile geometry."""
    n_ints, n_floats = ctypes.c_longlong(), ctypes.c_longlong()
    _build.load("linear_scan").linear_scan_scratch(bsz, s, w, ctypes.byref(n_ints),
                                                   ctypes.byref(n_floats))
    return n_ints.value, n_floats.value
