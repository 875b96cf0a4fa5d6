"""Wrapper of the CUDA flash-attention kernel.

PyTorch counterpart of ``repro.kernels.flash_attention.ops.flash_attention``
with the same public layout: q (B, Sq, H, hd), k/v (B, Skv, Hkv, hd).  The
kernel (``csrc/flash_attention_fwd.cu``) replaces the Pallas kernel
``repro/kernels/flash_attention/kernel.py::_fa_kernel``; it reads this layout
directly, so the wrapper makes no transposed or padded copy.

A tensor on the CPU takes the plain version (``ref.attention_plain``); a
CUDA tensor launches the kernel or raises.  ``flash_attention.launches``
counts the launches.
"""

from __future__ import annotations

import torch

from ... import _build
from .ref import attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")
    b, sq, h, hd = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v must be (B, Skv, Hkv, hd) matching q {tuple(q.shape)}: "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} kv heads")
    if hd % 8 or not 0 < hd <= 256:
        raise ValueError(f"head dim {hd} must be a multiple of 8 up to 256")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of float32, bfloat16")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load("flash_attention_fwd")
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, sq, skv, h, h // hkv, hd, int(causal), int(window), sq, skv,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
