"""Parameters of the JAX package's models as the port's tensors.

``params_from_jax`` takes the nested dict of numpy arrays that
``repro.models.transformer.DecoderLM.init`` gives (``np.asarray`` on every
leaf), checks each leaf against the port's declaration table, unstacks the
scanned ``(L, ...)`` leaves into per-layer tensors and returns the port's
parameter dict.  It reads numpy arrays only: it imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build_model


def _tensor(arr, dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":  # ml_dtypes bfloat16
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def params_from_jax(numpy_tree: dict, cfg, device="cuda") -> dict:
    device = resolve_device(device)
    model = build_model(cfg, device=device)
    pb = model.pb
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                flat[path] = v

    walk(numpy_tree, "")
    if set(flat) != set(pb.shapes):
        raise ValueError(
            f"parameter paths differ: missing {sorted(set(pb.shapes) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(pb.shapes))}"
        )
    out = {}
    for path, arr in flat.items():
        if tuple(np.shape(arr)) != pb.shapes[path]:
            raise ValueError(f"{path}: shape {np.shape(arr)} != declared {pb.shapes[path]}")
        t = _tensor(arr, pb.dtype, device)
        out[path] = list(t.unbind(0)) if pb.stacked[path] else t
    return model.unstack(pb.nest(out))
