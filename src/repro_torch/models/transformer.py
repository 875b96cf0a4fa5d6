"""Decoder-LM assembly: the dense ``attn``, hybrid (RG-LRU) and SSM (Mamba-2) families.

PyTorch counterpart of ``repro.models.transformer``.  The layer stack is
the reference's list of segments (``build_segments``):

  * ``("scan", name, kinds, n_rep)`` — ``n_rep`` repetitions of the block-kind
    cycle ``kinds``.  The reference scans stacked parameters with
    ``lax.scan``; here each stacked parameter group is a list of per-layer
    dicts and the scan is a Python loop.
  * ``("unroll", name, kind)`` — a single layer (hybrid pattern remainders).

Parameters and caches are keyed as the reference keys them, so the two
compare leaf for leaf: a uniform stack is one ``"blocks"`` segment
(``{"blocks": ((k, v),), "pos"}``, k/v (L, B, S, Hkv, hd)); recurrentgemma
is ``{"cyc": ((h, conv), (h, conv), (k, v)), "tail24": (h, conv),
"tail25": (h, conv), "pos"}`` with the ``cyc`` leaves stacked over its
repetitions; mamba2 is ``{"blocks": ((s, conv),), "pos"}``.  Sliding-window
attention keeps a ring of ``window`` slots (token i in slot i % window); a
recurrent block keeps h (B, W) in float32 and the conv tail (B, K-1, W); an
SSD block keeps its state (B, H, P, N) in float32 and the conv tail
(B, K-1, d_inner + 2N).

Block kinds ported: ``attn``, ``rec`` and ``ssd``.  ``moe``,
cross-attention and patch prefixes raise ``NotImplementedError``, and so
does continuation prefill (``prefill_cont``), which waits for the prefix-KV
store.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .attention import NEG_INF, attention, attn_decode
from .common import DTYPES, ParamBuilder, apply_rope, embed_lookup, norm, rope_angles
from .mlp import declare_mlp, mlp_apply
from .rglru import declare_rglru, rglru_block, rglru_block_step
from .ssm import declare_ssd, ssd_block, ssd_block_step

PORTED_KINDS = ("attn", "rec", "ssd")


# ---------------------------------------------------------------------------
# segments (a copy of the reference's)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Segment:
    mode: str              # "scan" | "unroll"
    name: str
    kinds: tuple[str, ...]  # block kind per position in the cycle
    n_rep: int = 1


def layer_kinds(cfg) -> list[str]:
    if cfg.family == "ssm":
        return ["ssd"] * cfg.n_layers
    kinds = []
    for i, k in enumerate(cfg.blocks):
        if k == "rec":
            kinds.append("rec")
        elif cfg.n_experts and i >= cfg.first_k_dense:
            kinds.append("moe")
        else:
            kinds.append("attn")
    return kinds


def build_segments(cfg) -> list[Segment]:
    kinds = layer_kinds(cfg)
    segs: list[Segment] = []
    i = 0
    # leading unrolled layers (deepseek first-k-dense)
    while i < len(kinds) and cfg.first_k_dense and i < cfg.first_k_dense:
        segs.append(Segment("unroll", f"layer{i}", (kinds[i],)))
        i += 1
    rest = kinds[i:]
    if not rest:
        return segs
    if len(set(rest)) == 1:
        segs.append(Segment("scan", "blocks", (rest[0],), len(rest)))
        return segs
    p = len(cfg.block_pattern)
    n_full = len(rest) // p
    if n_full:
        segs.append(Segment("scan", "cyc", tuple(rest[:p]), n_full))
    for j in range(n_full * p, len(rest)):
        segs.append(Segment("unroll", f"tail{j}", (rest[j],)))
    return segs


def param_names(seg: Segment) -> list[str]:
    """The parameter-group key of each position of ``seg``'s cycle."""
    if seg.mode == "scan" and len(seg.kinds) > 1:
        return [f"{seg.name}{j}" for j in range(len(seg.kinds))]
    return [seg.name]


def _check_supported(cfg) -> None:
    unported = set(layer_kinds(cfg)) - set(PORTED_KINDS)
    if unported:
        raise NotImplementedError(
            f"block kinds {sorted(unported)} are not ported yet; the port "
            f"serves {list(PORTED_KINDS)} stacks"
        )
    if cfg.family == "encdec" or cfg.enc_layers:
        raise NotImplementedError("cross-attention (encoder-decoder) is not ported yet")
    if cfg.n_patches:
        raise NotImplementedError("patch prefixes (VLM) are not ported yet")
    if cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"position scheme {cfg.pos!r} is not ported yet")


# ---------------------------------------------------------------------------
# per-block param declaration
# ---------------------------------------------------------------------------

def declare_block(pb: ParamBuilder, prefix: str, cfg, kind: str, stack: int = 0):
    lead = (stack,) if stack else ()
    st = bool(stack)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd

    def decl_norm(n):
        pb.declare(f"{prefix}/{n}", lead + (d,), init="zeros", stack=st)
        if cfg.norm == "layernorm":
            pb.declare(f"{prefix}/{n}_b", lead + (d,), init="zeros", stack=st)

    decl_norm("ln1")
    if kind == "attn":
        pb.declare(f"{prefix}/wq", lead + (d, h, hd), stack=st)
        pb.declare(f"{prefix}/wk", lead + (d, kv, hd), stack=st)
        pb.declare(f"{prefix}/wv", lead + (d, kv, hd), stack=st)
        pb.declare(f"{prefix}/wo", lead + (h, hd, d), stack=st)
    elif kind == "rec":
        declare_rglru(pb, f"{prefix}/rec", d, cfg.lru_width or d, cfg.conv_width, stack)
    elif kind == "ssd":  # the Mamba-2 block is the whole layer: no ln2, no MLP
        declare_ssd(pb, f"{prefix}/ssd", cfg, stack)
        return
    else:
        raise ValueError(kind)
    decl_norm("ln2")
    declare_mlp(pb, f"{prefix}/mlp", d, cfg.d_ff, cfg.mlp, stack)


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _norm(params, name, x, cfg):
    return norm(cfg.norm, x, params[name], params.get(f"{name}_b"))


def _proj_heads(x, w):
    """(B, S, D) @ (D, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).reshape(*x.shape[:-1], h, hd)


def _merge_heads(o, w):
    """(B, S, H, hd) @ (H, hd, D) -> (B, S, D)."""
    h, hd, d = w.shape
    return o.reshape(*o.shape[:-2], h * hd) @ w.reshape(h * hd, d)


def _attn_full(params, x, cfg, rope_cs, *, causal=True):
    """Attention sublayer, full-sequence mode.  Returns (x_out, (k, v))."""
    h = _norm(params, "ln1", x, cfg)
    q = _proj_heads(h, params["wq"])
    k = _proj_heads(h, params["wk"])
    v = _proj_heads(h, params["wv"])
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = attention(q, k, v, impl=cfg.attn_impl, causal=causal, window=cfg.window)
    return x + _merge_heads(o, params["wo"]), (k, v)


def _rope_pos(pos: torch.Tensor) -> torch.Tensor:
    """pos: () or (B,) -> positions shaped for rope_angles broadcasting."""
    return pos[None, None] if pos.ndim == 0 else pos[:, None]


def _attn_step(params, x_t, cfg, pos, cache, *, ring: bool):
    """Attention sublayer, one-token decode.  ``cache`` = (k_cache, v_cache)
    is read-only here: the new token's (k, v) are returned for the caller to
    write once per step."""
    h = _norm(params, "ln1", x_t, cfg)
    q = _proj_heads(h, params["wq"])
    k = _proj_heads(h, params["wk"])
    v = _proj_heads(h, params["wv"])
    if cfg.pos == "rope":
        cos, sin = rope_angles(_rope_pos(pos), cfg.hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k_cache, v_cache = cache
    new_kv = (k.to(k_cache.dtype), v.to(v_cache.dtype))
    o = attn_decode(q, k_cache, v_cache, pos, window=cfg.window, ring=ring, extra_kv=new_kv)
    return x_t + _merge_heads(o, params["wo"]), new_kv


def _to_ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """A full-sequence KV (B, S, kv, hd) in the ring layout decode expects
    for sliding-window archs: slot i % window holds token i, keeping the last
    ``window`` tokens."""
    b, s, kv, hd = k.shape
    if s <= window:
        return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, window - s))
    slots = torch.remainder(torch.arange(s - window, s, device=k.device), window)
    out = torch.zeros((b, window, kv, hd), dtype=k.dtype, device=k.device)
    out[:, slots] = k[:, s - window :]
    return out


def block_full(params, x, cfg, kind, rope_cs, *, causal=True):
    """Full-sequence block.  Returns (x, state): the raw (k, v) of an
    ``attn`` block (the caller lays them out), (h_last, conv_tail) of a
    ``rec`` block, (s_last, conv_tail) of an ``ssd`` block."""
    if kind == "ssd":
        y, state = ssd_block(params["ssd"], _norm(params, "ln1", x, cfg), cfg)
        return x + y, state
    if kind == "attn":
        x, state = _attn_full(params, x, cfg, rope_cs, causal=causal)
    elif kind == "rec":
        h = _norm(params, "ln1", x, cfg)
        y, state = rglru_block(params["rec"], h)
        x = x + y
    else:
        raise ValueError(kind)
    h = _norm(params, "ln2", x, cfg)
    return x + mlp_apply(params["mlp"], h, cfg.mlp), state


def block_step(params, x_t, cfg, kind, pos, cache):
    """One-token decode block.  Returns (x_t, new state): the new token's
    (k, v) for ``attn``, the next (h, conv) for ``rec``, the next (s, conv)
    for ``ssd``."""
    if kind == "ssd":
        y, new = ssd_block_step(params["ssd"], _norm(params, "ln1", x_t, cfg), cache, cfg)
        return x_t + y, new
    if kind == "attn":
        x_t, new = _attn_step(params, x_t, cfg, pos, cache, ring=cfg.window > 0)
    elif kind == "rec":
        h = _norm(params, "ln1", x_t, cfg)
        y, new = rglru_block_step(params["rec"], h, cache)
        x_t = x_t + y
    else:
        raise ValueError(kind)
    h = _norm(params, "ln2", x_t, cfg)
    return x_t + mlp_apply(params["mlp"], h, cfg.mlp), new


def cfg_cache_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def block_cache_shape(cfg, kind: str, batch: int, cache_len: int):
    """((shape, dtype), ...) of one block's cache leaves (no stack axis)."""
    cdt = cfg_cache_dtype(cfg)
    if kind == "attn":
        s = min(cache_len, cfg.window) if cfg.window > 0 else cache_len
        kv = (batch, s, cfg.n_kv, cfg.hd)
        return ((kv, cdt), (kv, cdt))
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return (((batch, w), torch.float32), ((batch, cfg.conv_width - 1, w), cdt))
    if kind == "ssd":
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        state = (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        return ((state, torch.float32), ((batch, cfg.conv_width - 1, conv_ch), cdt))
    raise ValueError(kind)


def block_cache_logical(kind: str, stacked: bool):
    """Logical axes of one block's cache leaves, as the reference's
    ``cache_logical`` names them, read from the segment structure: a
    stacked leaf leads with ``"layers"``."""
    if kind == "attn":
        base = (("batch", "kv_seq", "kv_heads", None),) * 2
    elif kind == "rec":
        base = (("batch", "mlp"), ("batch", None, "mlp"))
    elif kind == "ssd":
        base = (("batch", None, None, None), ("batch", None, "mlp"))
    else:
        raise ValueError(kind)
    return tuple(("layers",) + b if stacked else b for b in base)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class DecoderLM:
    """Decoder-only LM over the segment stack.

    ``params`` is a dict: ``embed``, ``final_norm``, ``lm_head`` (unless
    tied), one list of per-layer dicts per scanned parameter group
    (``blocks``, or ``cyc0``/``cyc1``/``cyc2``) and one dict per unrolled
    layer (``tail24``), with the reference's leaf names."""

    def __init__(self, cfg, device="cuda"):
        from .common import resolve_device

        _check_supported(cfg)
        self.cfg = cfg
        self.segments = build_segments(cfg)
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.pb = ParamBuilder(dtype=self.dtype)
        self._declare()

    # -- params --------------------------------------------------------------
    def _declare(self):
        cfg, pb = self.cfg, self.pb
        pb.declare("embed", (cfg.padded_vocab, cfg.d_model), init="normal", scale=0.02)
        for seg in self.segments:
            stack = seg.n_rep if seg.mode == "scan" else 0
            for name, kind in zip(param_names(seg), seg.kinds):
                declare_block(pb, name, cfg, kind, stack=stack)
        pb.declare("final_norm", (cfg.d_model,), init="zeros")
        if cfg.norm == "layernorm":
            pb.declare("final_norm_b", (cfg.d_model,), init="zeros")
        if not cfg.tie_embeddings:
            pb.declare("lm_head", (cfg.d_model, cfg.padded_vocab), init="normal", scale=0.02)

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters drawn from ``gen`` on the model's device."""
        return self.unstack(self.pb.init(gen, self.device))

    def unstack(self, tree: dict) -> dict:
        """Turn the declaration tree (stacked leaves as per-layer lists) into
        the model's layout: each scanned group as one dict per layer."""

        def layer(node, i):
            return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

        out = dict(tree)
        for seg in self.segments:
            if seg.mode == "scan":
                for name in param_names(seg):
                    out[name] = [layer(tree[name], i) for i in range(seg.n_rep)]
        return out

    def _layers(self, params, seg: Segment):
        """[(kind, [per-repetition params]), ...] over ``seg``'s cycle."""
        if seg.mode == "unroll":
            return [(seg.kinds[0], [params[seg.name]])]
        return [(kind, params[name]) for name, kind in zip(param_names(seg), seg.kinds)]

    # -- embedding / logits ----------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _logits(self, params, x):
        cfg = self.cfg
        x = norm(cfg.norm, x, params["final_norm"], params.get("final_norm_b"))
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = x @ head.to(x.dtype)
        vmask = torch.where(
            torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab, 0.0, NEG_INF
        )
        return logits + vmask.to(logits.dtype)

    def _rope(self, seq_len):
        if self.cfg.pos != "rope":
            return None
        return rope_angles(torch.arange(seq_len, device=self.device), self.cfg.hd, self.cfg.rope_theta)

    # -- caches ------------------------------------------------------------------
    def _alloc(self, seg: Segment, batch: int, cache_len: int) -> tuple:
        """Zero cache leaves of ``seg``: a tuple per cycle position for a
        scanned segment (each leaf with a leading repetition axis), the
        block's own tuple for an unrolled one."""
        lead = (seg.n_rep,) if seg.mode == "scan" else ()
        per = tuple(
            tuple(torch.zeros(lead + shape, dtype=dt, device=self.device)
                  for shape, dt in block_cache_shape(self.cfg, kind, batch, cache_len))
            for kind in seg.kinds
        )
        return per if seg.mode == "scan" else per[0]

    def cache_zeros(self, batch: int, cache_len: int) -> dict:
        """An all-zero cache of ``batch`` lanes (the reference's
        ``cache_abstract``, materialised): scalar ``pos``."""
        caches = {seg.name: self._alloc(seg, batch, cache_len) for seg in self.segments}
        caches["pos"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return caches

    def cache_logical(self) -> dict:
        """Logical axes of every cache leaf, in the cache's tree: where the
        batch axis is and which axis is a KV sequence."""
        out = {}
        for seg in self.segments:
            per = tuple(block_cache_logical(k, seg.mode == "scan") for k in seg.kinds)
            out[seg.name] = per if seg.mode == "scan" else per[0]
        return out

    # -- full pass -------------------------------------------------------------
    def _run_full(self, params, x, headroom: int):
        """All layers over x (B, S, D).  Each block's state lands in its
        segment's preallocated cache: attention K/V at positions 0..S-1 of an
        (S + headroom)-long cache, or in ring layout for a windowed model;
        recurrent (h, conv) and SSD (s, conv) whole.  A stack costs no extra copy."""
        cfg = self.cfg
        b, s = x.shape[:2]
        rope_cs = self._rope(s)
        seq = cfg.window if cfg.window > 0 else s + headroom
        caches = {}
        for seg in self.segments:
            bufs = self._alloc(seg, b, seq)
            per = bufs if seg.mode == "scan" else (bufs,)
            layers = self._layers(params, seg)
            for r in range(seg.n_rep):
                for (kind, ps), dst in zip(layers, per):
                    x, state = block_full(ps[r], x, cfg, kind, rope_cs)
                    dst_r = tuple(t[r] for t in dst) if seg.mode == "scan" else dst
                    for d, src in zip(dst_r, state):
                        if kind != "attn":
                            d.copy_(src)
                        elif cfg.window > 0:
                            d.copy_(_to_ring(src, cfg.window))
                        else:
                            d[:, :s] = src
            caches[seg.name] = bufs
        return x, caches

    # -- public API --------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, *, cache_headroom: int = 8):
        """-> (last-token logits (B, Vpad), cache dict).  Full-attention KV
        caches carry ``cache_headroom`` spare positions for the decode steps
        that follow; ring and recurrent caches have a fixed size."""
        x = embed_lookup(params["embed"], self._tokens(batch["tokens"]))
        x, caches = self._run_full(params, x, cache_headroom)
        logits = self._logits(params, x[:, -1:])
        caches["pos"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
        return logits[:, 0], caches

    def supports_packed_prefill(self, cache_len: int | None = None) -> bool:
        """The reference's gate, kept as it is: every block plain dense
        attention, no window, and (unless ``attn_impl == "xla"``) no bucket
        above ``attn_chunk``."""
        cfg = self.cfg
        ok = cfg.window == 0 and cfg.n_patches == 0 and set(layer_kinds(cfg)) == {"attn"}
        if ok and cache_len is not None and cfg.attn_impl != "xla":
            ok = cache_len <= cfg.attn_chunk
        return ok

    def _mask_packed(self, caches, lengths):
        """Zero every KV position >= the row's true length, in place: padded
        rows compute garbage K/V past the prompt, and zeroing matches the
        zero padding of ``SlotCache`` fitting."""
        for seg in self.segments:
            per = caches[seg.name] if seg.mode == "scan" else (caches[seg.name],)
            for kind, kv in zip(seg.kinds, per):
                if kind != "attn":
                    continue
                for t in kv:  # (L, B, S, kv, hd) scanned | (B, S, kv, hd)
                    s_ax = t.ndim - 3
                    pad = torch.arange(t.shape[s_ax], device=t.device)[None, :] >= lengths[:, None]
                    t.masked_fill_(pad[..., None, None], 0)
        return caches

    @torch.no_grad()
    def prefill_packed(self, params, tokens, lengths, *, cache_headroom: int = 8):
        """Packed prefill: ``tokens`` (B, S) right-padded prompt rows,
        ``lengths`` (B,) true lengths -> (per-row last-real-token logits
        (B, Vpad), cache with per-row ``pos``).  Rows with ``length == 0``
        are dummies: their logits are garbage and their KV/pos stay zero."""
        lengths = torch.as_tensor(lengths, device=self.device).to(torch.int32)
        x = embed_lookup(params["embed"], self._tokens(tokens))
        x, caches = self._run_full(params, x, cache_headroom)
        caches = self._mask_packed(caches, lengths)
        idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), idx][:, None]
        logits = self._logits(params, x_last)
        caches["pos"] = lengths
        return logits[:, 0], caches

    def prefill_cont(self, params, cache, tokens, lengths):
        raise NotImplementedError(
            "continuation prefill waits for the prefix-KV store slice of the port"
        )

    def _merge_kv(self, old: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Write the (..., B, 1, kv, hd) new-token slices into the (..., B,
        S, kv, hd) cache at ``pos`` (the ring slot ``pos % S`` for a windowed
        model), IN PLACE (the reference builds a new array with a masked
        select).  Without a ring, a lane whose ``pos`` is past the cache (an
        idle slot keeps counting) is left as it is, as the reference's select
        leaves it."""
        s_max = old.shape[-3]
        slot = torch.remainder(pos, s_max) if self.cfg.window > 0 else pos
        new = new[..., 0, :, :].to(old.dtype)
        if slot.ndim == 0:
            if int(slot) < s_max:
                old[..., int(slot), :, :] = new
            return old
        lanes = torch.arange(old.shape[-4], device=old.device)
        col = torch.clamp(slot.long(), max=s_max - 1)
        keep = (slot >= s_max)[:, None, None]
        old[..., lanes, col, :, :] = torch.where(keep, old[..., lanes, col, :, :], new)
        return old

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> (logits (B, Vpad), cache).  The cache's K/V are
        read-only inside the layer loop and updated once per segment, in
        place; a recurrent block's state is overwritten in place right after
        its own step (no other layer reads it).  The returned dict holds the
        same tensors, updated, and a new ``pos``."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_lookup(params["embed"], self._tokens(tokens))
        for seg in self.segments:
            stacked = seg.mode == "scan"
            per = cache[seg.name] if stacked else (cache[seg.name],)
            layers = self._layers(params, seg)
            new_kv = [[] for _ in layers]
            for r in range(seg.n_rep):
                for j, ((kind, ps), state) in enumerate(zip(layers, per)):
                    state_r = tuple(t[r] for t in state) if stacked else state
                    x, new = block_step(ps[r], x, cfg, kind, pos, state_r)
                    if kind == "attn":
                        new_kv[j].append(new)
                    else:
                        for t, n in zip(state_r, new):
                            t.copy_(n)
            for (kind, _), state, news in zip(layers, per, new_kv):
                if kind == "attn":
                    for t, n in zip(state, zip(*news)):
                        self._merge_kv(t, torch.stack(n) if stacked else n[0], pos)
        logits = self._logits(params, x)
        new_cache = dict(cache)
        new_cache["pos"] = pos + 1
        return logits[:, 0], new_cache
