"""Mamba-2 SSD (state-space duality) blocks, arXiv:2405.21060.

PyTorch counterpart of ``repro.models.ssm``.  The SSD layer computes, per
head h with state size N and head dim P:

    s_t = exp(dt_t * A_h) * s_{t-1} + dt_t * B_t x_t^T        (s: (N, P))
    y_t = C_t^T s_t + D_h x_t

The chunked algorithm splits the sequence into chunks of length L: a
quadratic intra-chunk term (the masked decay product) plus a linear
inter-chunk state recurrence.  The intra-chunk term runs through
``kernels.ssd_scan``: on a CUDA tensor the hand-written kernel, as the
reference's ``intra_impl="pallas"`` runs its Pallas kernel; on the CPU its
plain version.  The chunk states, the inter-chunk recurrence (a Python loop
over chunks where the reference has ``lax.scan``) and the state-to-output
term stay plain PyTorch, as the reference leaves them to XLA.

Shapes follow the Mamba-2 convention: X (B,S,H,P), dt (B,S,H), A (H,) < 0,
B/C (B,S,N) with one head group broadcast over H.  The float32 products
here run in full float32 on the card only with TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops

from .common import ParamBuilder, rmsnorm
from .rglru import causal_conv1d, conv1d_step


def declare_ssd(pb: ParamBuilder, prefix: str, cfg, stack: int = 0):
    lead = (stack,) if stack else ()
    st = bool(stack)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n  # conv over [x, B, C]
    pb.declare(f"{prefix}/in_proj", lead + (d, 2 * di + 2 * n + h), stack=st)
    pb.declare(f"{prefix}/conv_w", lead + (cfg.conv_width, conv_ch), stack=st)
    pb.declare(f"{prefix}/conv_b", lead + (conv_ch,), init="zeros", stack=st)
    pb.declare(f"{prefix}/a_log", lead + (h,), init="ssm_a", stack=st)
    pb.declare(f"{prefix}/d_skip", lead + (h,), init="ones", stack=st)
    pb.declare(f"{prefix}/dt_bias", lead + (h,), init="dt_bias", stack=st)
    pb.declare(f"{prefix}/norm_w", lead + (di,), init="zeros", stack=st)
    pb.declare(f"{prefix}/out_proj", lead + (di, d), stack=st)


def ssd_chunked(x, dt, a, b, c, *, chunk: int = 128, s0=None):
    """SSD scan over raw x (not dt-weighted).

    x: (B,S,H,P); dt: (B,S,H) post-softplus; a: (H,) negative; b/c: (B,S,N).
    Returns (y (B,S,H,P) in x's dtype, s_last (B,H,P,N) float32).  The
    sequence is zero-padded to a multiple of ``L = min(chunk, S)``, so a
    prompt under one chunk is one chunk of length S."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    l = min(chunk, s)
    if s % l:
        pad = l - s % l
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    s_pad = x.shape[1]
    nc = s_pad // l

    xd = (x * dt[..., None]).float()                         # dt-weighted input
    da = dt.float() * a.float()                              # (B,S,H)

    # chunk views; dac is a permuted view the kernel reads through strides
    xc = xd.reshape(bs, nc, l, h, p)
    dac = da.reshape(bs, nc, l, h).permute(0, 3, 1, 2)      # (B,H,nc,L)
    bc = b.reshape(bs, nc, l, n).float()
    cc = c.reshape(bs, nc, l, n).float()
    da_cs = torch.cumsum(dac, dim=-1)                        # (B,H,nc,L)

    # 1) intra-chunk (diagonal blocks): the kernel
    y_diag = ssd_ops.ssd_intra(xc, dac, bc, cc)

    # 2) per-chunk input -> state contribution
    decay_states = torch.exp(da_cs[..., -1:] - da_cs)        # (B,H,nc,L)
    states = torch.einsum("bcln,bclhp->bchpn", bc, xc * decay_states.permute(0, 2, 3, 1)[..., None])

    # 3) inter-chunk recurrence, linear in nc
    chunk_decay = torch.exp(da_cs[..., -1])                  # (B,H,nc)
    state = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device) if s0 is None \
        else s0.float()
    enter = []
    for ci in range(nc):
        enter.append(state)
        state = chunk_decay[:, :, ci, None, None] * state + states[:, ci]
    s_enter = torch.stack(enter, dim=1)                      # (B,nc,H,P,N)

    # 4) state -> output within each chunk
    out_decay = torch.exp(da_cs).permute(0, 2, 3, 1)[..., None]  # (B,nc,L,H,1)
    y_off = torch.einsum("bcln,bchpn->bclhp", cc, s_enter) * out_decay

    y = (y_diag + y_off).reshape(bs, s_pad, h, p)[:, :s]
    return y.to(x.dtype), state


def ssd_step(x_t, dt_t, a, b_t, c_t, s_prev):
    """One decode step.  x_t: (B,H,P); dt_t: (B,H); b_t/c_t: (B,N);
    s_prev: (B,H,P,N) float32 -> (y (B,H,P), s_new)."""
    da = torch.exp(dt_t.float() * a.float())                 # (B,H)
    inp = torch.einsum("bhp,bn->bhpn", (x_t * dt_t[..., None]).float(), b_t.float())
    s_new = da[..., None, None] * s_prev + inp
    y = torch.einsum("bhpn,bn->bhp", s_new, c_t.float())
    return y.to(x_t.dtype), s_new


def _split_proj(cfg, proj):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di, n, n, h], dim=-1)      # z, x, B, C, dt


def _gated_out(params, y, z):
    """Gated RMSNorm, then the out-projection."""
    y = rmsnorm(y * F.silu(z.float()).to(z.dtype), params["norm_w"])
    return y @ params["out_proj"]


def ssd_block(params: dict, x: torch.Tensor, cfg):
    """Full Mamba-2 block, prefill.  x: (B,S,D) -> (y, (s_last, conv_tail))."""
    bsz, s, _ = x.shape
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, b, c, dt_raw = _split_proj(cfg, x @ params["in_proj"])

    conv_in = torch.cat([xin, b, c], dim=-1)
    conv = F.silu(causal_conv1d(conv_in, params["conv_w"], params["conv_b"]).float()).to(x.dtype)
    xin, b, c = conv[..., :di], conv[..., di : di + n], conv[..., di + n :]

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    xh = xin.reshape(bsz, s, h, p)
    y, s_last = ssd_chunked(xh, dt, a, b, c, chunk=cfg.ssm_chunk)
    y = y + params["d_skip"].float()[None, None, :, None] * xh.float()
    out = _gated_out(params, y.reshape(bsz, s, di).to(x.dtype), z)
    k = params["conv_w"].shape[0]
    if s >= k - 1:
        conv_tail = conv_in[:, s - (k - 1) :, :]
    else:
        conv_tail = F.pad(conv_in, (0, 0, k - 1 - s, 0))
    return out, (s_last, conv_tail)


def ssd_block_step(params: dict, x_t: torch.Tensor, state, cfg):
    """Decode step.  x_t: (B,1,D); state = (s (B,H,P,N) float32, conv (B,K-1,C))."""
    s_prev, conv_state = state
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, b, c, dt_raw = _split_proj(cfg, x_t[:, 0, :] @ params["in_proj"])

    conv_in = torch.cat([xin, b, c], dim=-1)
    conv, conv_state = conv1d_step(conv_in, conv_state.to(conv_in.dtype), params["conv_w"],
                                   params["conv_b"])
    conv = F.silu(conv.float()).to(x_t.dtype)
    xin, b, c = conv[..., :di], conv[..., di : di + n], conv[..., di + n :]

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    xh = xin.reshape(-1, h, p)
    y, s_new = ssd_step(xh, dt, a, b, c, s_prev)
    y = y + params["d_skip"].float()[None, :, None] * xh.float()
    out = _gated_out(params, y.reshape(-1, di).to(x_t.dtype), z)
    return out[:, None, :], (s_new, conv_state)
