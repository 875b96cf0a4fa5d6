"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

PyTorch counterpart of ``repro.models.rglru``.  Block: x -> [branch1:
linear -> GeLU] * [branch2: linear -> causal depthwise conv1d -> RG-LRU] ->
out linear.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a xc_t + b_a)          recurrence gate
    i_t = sigmoid(W_x xc_t + b_x)          input gate
    log a_t = c * r_t * log_sigmoid(Lambda)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * xc_t)

Prefill runs the linear recurrence through ``kernels.rglru_scan``: on a
CUDA tensor the hand-written kernel, as the reference's ``impl="pallas"``
runs its Pallas kernel; on the CPU its plain version.  The reference's
``impl="assoc"`` (``lax.associative_scan``) computes the same function and
has no counterpart here.  Decode is the one-step update.

The gates' float32 products run in full float32 on the card only with TF32
off (``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default,
which ``chip_smoke.py`` sets explicitly); with TF32 on they keep about three
decimal digits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rg_ops

from .common import ParamBuilder

RGLRU_C = 8.0


def declare_rglru(pb: ParamBuilder, prefix: str, d_model: int, width: int, conv_width: int,
                  stack: int = 0):
    lead = (stack,) if stack else ()
    st = bool(stack)
    pb.declare(f"{prefix}/wy", lead + (d_model, width), stack=st)
    pb.declare(f"{prefix}/wx", lead + (d_model, width), stack=st)
    pb.declare(f"{prefix}/conv_w", lead + (conv_width, width), stack=st)
    pb.declare(f"{prefix}/conv_b", lead + (width,), init="zeros", stack=st)
    pb.declare(f"{prefix}/wa", lead + (width, width), init="normal", stack=st)
    pb.declare(f"{prefix}/ba", lead + (width,), init="zeros", stack=st)
    pb.declare(f"{prefix}/wi", lead + (width, width), init="normal", stack=st)
    pb.declare(f"{prefix}/bi", lead + (width,), init="zeros", stack=st)
    pb.declare(f"{prefix}/lam", lead + (width,), init="rglru_a", stack=st)
    pb.declare(f"{prefix}/wo", lead + (width, d_model), stack=st)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, W); w: (K, W); b: (W,)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):  # K is tiny (4): unrolled adds, as the reference
        out = out + xp[:, i : i + x.shape[1], :] * w[i]
    return out + b


def conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One decode step.  x_t: (B, W); conv_state: (B, K-1, W) past inputs."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, W)
    out = torch.einsum("bkw,kw->bw", window, w) + b
    return out, window[:, 1:, :]


def _gates(params, xc):
    xf = xc.float()
    r = torch.sigmoid(xf @ params["wa"].float() + params["ba"].float())
    i = torch.sigmoid(xf @ params["wi"].float() + params["bi"].float())
    log_a = RGLRU_C * r * F.logsigmoid(params["lam"].float())
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated_in


def rglru_scan(params: dict, xc: torch.Tensor, h0: torch.Tensor | None = None):
    """xc: (B, S, W) conv output -> (y (B, S, W) in xc's dtype, h_last (B, W)
    float32)."""
    a, gi = _gates(params, xc)
    h0 = torch.zeros_like(a[:, 0]) if h0 is None else h0.float()
    y = rg_ops.linear_scan(a, gi, h0)
    return y.to(xc.dtype), y[:, -1]


def rglru_step(params: dict, xc_t: torch.Tensor, h_prev: torch.Tensor):
    """One decode step.  xc_t: (B, W); h_prev: (B, W) float32."""
    a, gi = _gates(params, xc_t)
    h = a * h_prev.float() + gi
    return h.to(xc_t.dtype), h


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def rglru_block(params: dict, x: torch.Tensor):
    """Full Griffin recurrent block, prefill mode.

    x: (B, S, D) -> (y (B, S, D), state (h_last float32, conv_tail))."""
    y_branch = _gelu(x @ params["wy"])
    xb = x @ params["wx"]
    xc = causal_conv1d(xb, params["conv_w"], params["conv_b"])
    h, h_last = rglru_scan(params, xc)
    out = (h * y_branch) @ params["wo"]
    k = params["conv_w"].shape[0]
    if xb.shape[1] >= k - 1:
        conv_tail = xb[:, xb.shape[1] - (k - 1) :, :]
    else:
        conv_tail = F.pad(xb, (0, 0, k - 1 - xb.shape[1], 0))
    return out, (h_last, conv_tail)


def rglru_block_step(params: dict, x_t: torch.Tensor, state):
    """Decode step.  x_t: (B, 1, D); state = (h (B, W) float32, conv (B, K-1, W))."""
    h_prev, conv_state = state
    xt = x_t[:, 0, :]
    y_branch = _gelu(xt @ params["wy"])
    xb = xt @ params["wx"]
    xc, conv_state = conv1d_step(xb, conv_state.to(xb.dtype), params["conv_w"], params["conv_b"])
    h, h_new = rglru_step(params, xc, h_prev)
    out = (h * y_branch) @ params["wo"]
    return out[:, None, :], (h_new, conv_state)
