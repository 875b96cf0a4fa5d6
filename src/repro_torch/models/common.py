"""Shared layers: norms, rotary embeddings, initializers, param declaration.

PyTorch counterpart of ``repro.models.common``.  Parameters are plain
dictionaries of tensors; ``ParamBuilder`` keeps the reference's declaration
table (``/``-path names, shapes, init rules) so a checkpoint of either
package maps leaf for leaf onto the other (``repro_torch.convert``).
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# init rules whose leaves stay float32 whatever the model dtype (the
# reference's ``ParamBuilder.abstract``)
F32_INITS = ("rglru_a", "ssm_a", "dt_bias")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` is the default and
    needs a card: without one this raises instead of falling back to the
    CPU, which callers must ask for by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


class ParamBuilder:
    """Collects (shape, init) declarations, then materialises parameters.

    ``stack`` marks a leaf whose leading axis is the layer axis of a scanned
    segment in the reference: its declared shape keeps that axis (so names
    and shapes match ``repro.models.common.ParamBuilder``), and ``init``
    returns it as a list of per-layer tensors, one draw per layer, which
    also keeps the float32 scratch of a draw to one layer's size.

    Leaves with an init in ``F32_INITS`` stay float32 in a bf16 model, as in
    the reference's ``abstract()``; ``leaf_dtype`` says which dtype a leaf
    has."""

    def __init__(self, dtype=torch.bfloat16):
        self.dtype = dtype
        self.shapes: dict = {}
        self.inits: dict = {}
        self.stacked: dict = {}

    def declare(self, tree_path: str, shape, init="normal", scale=None, stack: bool = False):
        if tree_path in self.shapes:
            raise ValueError(f"{tree_path} declared twice")
        self.shapes[tree_path] = tuple(shape)
        self.inits[tree_path] = (init, scale)
        self.stacked[tree_path] = stack

    def leaf_dtype(self, path: str) -> torch.dtype:
        return torch.float32 if self.inits[path][0] in F32_INITS else self.dtype

    def _init_leaf(self, gen: torch.Generator, shape, path, device):
        kind, scale = self.inits[path]
        full = self.shapes[path]
        if kind == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=device)
        if kind == "ones":
            return torch.ones(shape, dtype=self.dtype, device=device)
        if kind == "normal":
            # the std rule of the reference's _init_leaf, read from the
            # declared (stacked) shape
            s = scale if scale is not None else (
                1.0 / math.sqrt(full[-2] if len(full) >= 2 else full[-1])
            )
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            return (x * s).to(self.dtype)
        if kind == "rglru_a":
            # Λ such that a = sigmoid(Λ) in [0.9, 0.999]
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            u = 0.9 + 0.099 * u
            return torch.log(u / (1 - u))
        if kind == "ssm_a":
            # log A for A uniform in [1, 16] (the block uses -exp(a_log))
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            return torch.log(1.0 + 15.0 * u)
        if kind == "dt_bias":
            # inverse softplus of dt, log-uniform in [0.001, 0.1]
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
            return dt + torch.log(-torch.expm1(-dt))
        raise ValueError(f"init {kind!r} of {path} is not ported yet")

    @staticmethod
    def nest(flat: dict) -> dict:
        out: dict = {}
        for path, v in flat.items():
            node = out
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return out

    def init(self, gen: torch.Generator, device) -> dict:
        """Draw every leaf from ``gen`` on ``device``, in sorted path order."""
        flat = {}
        for p in sorted(self.shapes):
            shape = self.shapes[p]
            if self.stacked[p]:
                flat[p] = [self._init_leaf(gen, shape[1:], p, device) for _ in range(shape[0])]
            else:
                flat[p] = self._init_leaf(gen, shape, p, device)
        return self.nest(flat)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x * (1.0 + scale.float())
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def norm(kind: str, x, scale, bias=None):
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(half, dtype=torch.float32, device=positions.device) / half
    )
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B?, S, hd//2) broadcastable."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :]  # (B, S, 1, hd//2)
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)
