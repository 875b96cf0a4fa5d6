"""Feed-forward blocks: SwiGLU / GEGLU / GELU / squared-ReLU (nemotron).

PyTorch counterpart of ``repro.models.mlp``.  The products stay
``torch.matmul``, as the reference leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ParamBuilder


def declare_mlp(pb: ParamBuilder, prefix: str, d_model: int, d_ff: int, kind: str, stack: int = 0):
    """Declare FFN params under ``prefix``; optional leading stack dim."""
    lead = (stack,) if stack else ()
    gated = kind in ("swiglu", "geglu")
    pb.declare(f"{prefix}/wi", lead + (d_model, d_ff), stack=bool(stack))
    if gated:
        pb.declare(f"{prefix}/wg", lead + (d_model, d_ff), stack=bool(stack))
    pb.declare(f"{prefix}/wo", lead + (d_ff, d_model), stack=bool(stack))


def mlp_apply(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """x: (B, S, D)."""
    h = x @ params["wi"]
    if kind == "swiglu":
        g = x @ params["wg"]
        h = F.silu(g.float()).to(h.dtype) * h
    elif kind == "geglu":
        g = x @ params["wg"]
        h = F.gelu(g.float(), approximate="tanh").to(h.dtype) * h
    elif kind == "gelu":
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    elif kind == "relu2":  # nemotron-4: squared ReLU
        h = torch.square(F.relu(h.float())).to(h.dtype)
    else:
        raise ValueError(kind)
    return h @ params["wo"]
