"""Continuous-batching prefill: bucketed and packed.

PyTorch counterpart of ``repro.serving.batching``.  The planning core
(``prompt_buckets`` / ``bucket_for`` / ``plan_packs``) is a copy of the
reference's.  ``PrefillBatcher`` packs up to ``pack_width`` prompts into one
``prefill_packed`` call padded to a power-of-two bucket.  PyTorch runs
eagerly, so nothing is traced; ``CountingCall`` counts the distinct
input-shape signatures a function is called with, which is what ``jax.jit``
traces once each, so ``compile_counts`` reads the same as the JAX engine's
on the same workload.  Prefix-KV resumes go through ``continue_rows``: one
``prefill_cont`` call extends up to ``pack_width`` stored (batch=1) caches
by their suffixes, over a freshly stacked cache, so no stored entry is
written.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .kvcache import _tensors, leaf_axes, rebuild


# ---------------------------------------------------------------------------
# planning core (a copy of the reference's)
# ---------------------------------------------------------------------------

def prompt_buckets(cache_len: int) -> list[int]:
    """Power-of-two prompt-length buckets ``[2, 4, ...]`` up to the first
    bucket covering the longest admissible prompt (``cache_len - 1``)."""
    if cache_len < 2:
        raise ValueError(f"cache_len {cache_len} leaves no room for a prompt")
    out, b = [], 2
    while b < cache_len - 1:
        out.append(b)
        b *= 2
    out.append(b)
    return out


def bucket_for(length: int, buckets: list[int]) -> int:
    """Smallest bucket holding ``length`` tokens."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"length {length} exceeds the largest bucket {buckets[-1]}")


def plan_packs(lengths, *, pack_width: int, buckets) -> list[tuple[int, list[int]]]:
    """Plan packed prefill calls over prompts of the given ``lengths``:
    greedy in admission order, ``pack_width`` rows per call, each call
    padded to the bucket of its longest member."""
    packs, cur = [], []
    for i in range(len(lengths)):
        cur.append(i)
        if len(cur) == pack_width:
            packs.append(cur)
            cur = []
    if cur:
        packs.append(cur)
    return [
        (bucket_for(max(lengths[i] for i in rows), buckets), rows)
        for rows in packs
    ]


# ---------------------------------------------------------------------------
# call counting
# ---------------------------------------------------------------------------

def _signature(x):
    """Shapes and dtypes of the array leaves of ``x`` (what a jit trace is
    keyed on); other leaves count by type only."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return (type(x).__name__, tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    return type(x).__name__


class CountingCall:
    """Counts calls and the distinct input-shape signatures among them:
    ``traces`` is the number ``jax.jit`` would have traced."""

    def __init__(self, fn):
        self._fn = fn
        self._seen: set = set()
        self.calls = 0

    @property
    def traces(self) -> int:
        return len(self._seen)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        self._seen.add(_signature((args, kwargs)))
        return self._fn(*args, **kwargs)


class PrefillBatcher:
    """Owns the bucketed/packed prefill calls for one engine.

    All packed calls share a fixed row count (``pack_width``): partial packs
    pad with length-0 dummy rows, so the signature varies only in the
    bucket.  ``warm`` runs every bucket once at construction."""

    def __init__(self, model, *, cache_len: int, pack_width: int, cache_headroom: int = 8):
        gate = getattr(model, "supports_packed_prefill", None)
        if gate is None or not gate(cache_len):
            raise ValueError(
                "this arch cannot take the packed-prefill path bitwise-safely "
                "(recurrent/SSM/MoE/sliding-window/VLM state absorbs padded "
                "positions, or a bucket would leave the attn_xla dispatch of "
                "the per-request reference); run the engine with batching off"
            )
        self.model = model
        self.cache_len = cache_len
        self.pack_width = pack_width
        self.buckets = prompt_buckets(cache_len)
        self.packed = CountingCall(
            functools.partial(model.prefill_packed, cache_headroom=cache_headroom)
        )
        self.cont = CountingCall(model.prefill_cont)
        # per-leaf batch axes (as SlotCache reads them) and a zero (batch=1)
        # row of the shape SlotCache.fit_single gives a stored entry: the
        # pad filler for partial continuation packs and the warm template,
        # so serving adds no continuation signature
        self._zero_row = model.cache_zeros(1, cache_len)
        self.axes = leaf_axes(self._zero_row, model.cache_logical())

    def pack_tokens(self, prompts):
        """Right-pad ``prompts`` (<= pack_width of them) into one
        (pack_width, bucket) token array + true lengths; trailing rows are
        dummies (length 0)."""
        if len(prompts) > self.pack_width:
            raise ValueError(f"{len(prompts)} prompts exceed pack_width={self.pack_width}")
        b = bucket_for(max((len(p) for p in prompts), default=1), self.buckets)
        toks = np.zeros((self.pack_width, b), np.int32)
        lens = np.zeros((self.pack_width,), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = np.asarray(p, np.int32)
            lens[i] = len(p)
        return toks, lens

    def prefill(self, params, prompts):
        """One packed prefill call: (per-row logits, cache with per-row pos)."""
        toks, lens = self.pack_tokens(prompts)
        return self.packed(params, toks, lens)

    def continue_rows(self, params, rows, suffixes):
        """One continuation call: extend each (batch=1) seeded cache in
        ``rows`` by its suffix.  Rows must share the ``SlotCache.fit_single``
        shape (stored prefix caches do, by the store's deposit contract).
        The rows are copied into one stacked cache, which ``prefill_cont``
        then writes; the rows themselves are only read."""
        if len(rows) != len(suffixes) or len(rows) > self.pack_width:
            raise ValueError("rows/suffixes mismatch or pack_width exceeded")
        toks, lens = self.pack_tokens(suffixes)
        cache = self._stack(list(rows) + [self._zero_row] * (self.pack_width - len(rows)))
        return self.cont(params, cache, toks, lens)

    # -- row plumbing ----------------------------------------------------------
    def _stack(self, rows):
        """Concatenate ``pack_width`` (batch=1) caches along each leaf's batch
        axis into one new batched cache with ``pos`` (pack_width,) int32."""
        leaves = [torch.cat(ts, dim=ax)
                  for ts, (ax, _) in zip(zip(*(_tensors(r) for r in rows)), self.axes)]
        out = rebuild(leaves, rows[0])
        out["pos"] = torch.stack([torch.as_tensor(r["pos"]).to(torch.int32).reshape(())
                                  for r in rows])
        return out

    def extract_row(self, cache, row: int):
        """Lane ``row`` of a packed cache as a (batch=1) cache with the scalar
        ``pos`` the per-request ``prefill`` emits.  The leaves are views into
        ``cache``: ``SlotCache.fit_single`` copies them before anything keeps
        them."""
        out = rebuild([t.narrow(ax, row, 1) for t, (ax, _) in zip(_tensors(cache), self.axes)],
                      cache)
        out["pos"] = cache["pos"][row]
        return out

    def warm(self, params, *, cont: bool = False):
        """Run every bucket once ahead of serving, as the reference compiles
        every bucket trace at construction, and with ``cont`` one
        continuation call per bucket over a stack of zero rows."""
        cache = self._stack([self._zero_row] * self.pack_width) if cont else None
        for b in self.buckets:
            toks = np.zeros((self.pack_width, b), np.int32)
            lens = np.zeros((self.pack_width,), np.int32)
            self.packed(params, toks, lens)
            if cont:
                self.cont(params, cache, toks, lens)
