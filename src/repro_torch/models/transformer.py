"""Decoder-LM assembly for the dense ``attn`` family.

PyTorch counterpart of ``repro.models.transformer``.  The reference scans
stacked per-layer parameters with ``lax.scan``; here the stack is a Python
loop over a list of per-layer parameter dicts.  The caches keep the
reference's layout so the two compare leaf for leaf:
``{"blocks": ((k, v),), "pos": ...}`` with k/v of shape (L, B, S, Hkv, hd).

Only the ``attn`` block kind is ported in this slice: the ``rec``, ``ssd``
and ``moe`` kinds, cross-attention, sliding-window ring caches and patch
prefixes raise ``NotImplementedError``, and so does continuation prefill
(``prefill_cont``), which waits for the prefix-KV store.
"""

from __future__ import annotations

import torch

from .attention import NEG_INF, attention, attn_decode
from .common import DTYPES, ParamBuilder, apply_rope, embed_lookup, norm, rope_angles
from .mlp import declare_mlp, mlp_apply

SEGMENT = "blocks"  # the reference's one scanned segment of a uniform stack


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


def _check_supported(cfg) -> None:
    kinds = set(layer_kinds(cfg))
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"block kinds {sorted(kinds - {'attn'})} are not ported yet; this "
            "slice serves dense 'attn' stacks"
        )
    if cfg.family == "encdec" or cfg.enc_layers:
        raise NotImplementedError("cross-attention (encoder-decoder) is not ported yet")
    if cfg.n_patches:
        raise NotImplementedError("patch prefixes (VLM) are not ported yet")
    if cfg.window > 0:
        raise NotImplementedError("sliding-window ring caches are not ported yet")
    if cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"position scheme {cfg.pos!r} is not ported yet")


def declare_block(pb: ParamBuilder, prefix: str, cfg, stack: int = 0):
    lead = (stack,) if stack else ()
    st = bool(stack)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd

    def decl_norm(n):
        pb.declare(f"{prefix}/{n}", lead + (d,), init="zeros", stack=st)
        if cfg.norm == "layernorm":
            pb.declare(f"{prefix}/{n}_b", lead + (d,), init="zeros", stack=st)

    decl_norm("ln1")
    pb.declare(f"{prefix}/wq", lead + (d, h, hd), stack=st)
    pb.declare(f"{prefix}/wk", lead + (d, kv, hd), stack=st)
    pb.declare(f"{prefix}/wv", lead + (d, kv, hd), stack=st)
    pb.declare(f"{prefix}/wo", lead + (h, hd, d), stack=st)
    decl_norm("ln2")
    declare_mlp(pb, f"{prefix}/mlp", d, cfg.d_ff, cfg.mlp, stack)


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


def _attn_step(params, x_t, cfg, pos, cache):
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
    o = attn_decode(q, k_cache, v_cache, pos, window=cfg.window, ring=False, extra_kv=new_kv)
    return x_t + _merge_heads(o, params["wo"]), new_kv


def block_full(params, x, cfg, rope_cs, *, causal=True):
    """Full-sequence ``attn`` block.  Returns (x, (k, v))."""
    x, kv = _attn_full(params, x, cfg, rope_cs, causal=causal)
    h = _norm(params, "ln2", x, cfg)
    return x + mlp_apply(params["mlp"], h, cfg.mlp), kv


def block_step(params, x_t, cfg, pos, cache):
    """One-token decode ``attn`` block.  Returns (x_t, (k_new, v_new))."""
    x_t, new_kv = _attn_step(params, x_t, cfg, pos, cache)
    h = _norm(params, "ln2", x_t, cfg)
    return x_t + mlp_apply(params["mlp"], h, cfg.mlp), new_kv


def cfg_cache_dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class DecoderLM:
    """Decoder-only LM over a Python loop of ``attn`` blocks.

    ``params`` is a dict: ``embed``, ``final_norm``, ``lm_head`` (unless
    tied) and ``blocks``, a list of per-layer dicts with the reference's
    leaf names (``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``,
    ``mlp/{wi,wg,wo}``)."""

    def __init__(self, cfg, device="cuda"):
        from .common import resolve_device

        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.pb = ParamBuilder(dtype=self.dtype)
        self._declare()

    # -- params --------------------------------------------------------------
    def _declare(self):
        cfg, pb = self.cfg, self.pb
        pb.declare("embed", (cfg.padded_vocab, cfg.d_model), init="normal", scale=0.02)
        declare_block(pb, SEGMENT, cfg, stack=cfg.n_layers)
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
        the model's layout: ``blocks`` as one dict per layer."""
        out = {k: v for k, v in tree.items() if k != SEGMENT}
        seg = tree[SEGMENT]

        def layer(node, i):
            return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

        out[SEGMENT] = [layer(seg, i) for i in range(self.cfg.n_layers)]
        return out

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

    # -- full pass -------------------------------------------------------------
    def _run_full(self, params, x, headroom: int):
        """All layers over x (B, S, D).  The K/V of every layer land in one
        preallocated (L, B, S + headroom, Hkv, hd) pair, so the stack and
        the headroom pad of the reference cost no extra copy."""
        cfg = self.cfg
        b, s = x.shape[:2]
        rope_cs = self._rope(s)
        shape = (cfg.n_layers, b, s + headroom, cfg.n_kv, cfg.hd)
        cdt = cfg_cache_dtype(cfg)
        kc = torch.zeros(shape, dtype=cdt, device=x.device)
        vc = torch.zeros(shape, dtype=cdt, device=x.device)
        for i, p in enumerate(params[SEGMENT]):
            x, (k, v) = block_full(p, x, cfg, rope_cs)
            kc[i, :, :s] = k
            vc[i, :, :s] = v
        return x, {SEGMENT: ((kc, vc),)}

    # -- public API --------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, params, batch, *, cache_headroom: int = 8):
        """-> (last-token logits (B, Vpad), cache dict).  KV caches carry
        ``cache_headroom`` spare positions for the decode steps that follow."""
        x = embed_lookup(params["embed"], self._tokens(batch["tokens"]))
        x, caches = self._run_full(params, x, cache_headroom)
        logits = self._logits(params, x[:, -1:])
        caches["pos"] = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
        return logits[:, 0], caches

    def supports_packed_prefill(self, cache_len: int | None = None) -> bool:
        """The reference's gate, kept as it is: every block plain dense
        attention, and (unless ``attn_impl == "xla"``) no bucket above
        ``attn_chunk``."""
        cfg = self.cfg
        ok = cfg.window == 0 and cfg.n_patches == 0 and set(layer_kinds(cfg)) == {"attn"}
        if ok and cache_len is not None and cfg.attn_impl != "xla":
            ok = cache_len <= cfg.attn_chunk
        return ok

    @staticmethod
    def _mask_packed(caches, lengths):
        """Zero every KV position >= the row's true length, in place: padded
        rows compute garbage K/V past the prompt, and zeroing matches the
        zero padding of ``SlotCache`` fitting."""
        for kv in caches[SEGMENT]:
            for t in kv:  # (L, B, S, kv, hd)
                pad = torch.arange(t.shape[2], device=t.device)[None, :] >= lengths[:, None]
                t.masked_fill_(pad[None, :, :, None, None], 0)
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
        """Write the (L, B, 1, kv, hd) new-token slices into the (L, B, S,
        kv, hd) cache at ``pos``, IN PLACE (the reference builds a new array
        with a masked select).  A lane whose ``pos`` is past the cache (an
        idle slot keeps counting) is left as it is, as the reference's
        select leaves it."""
        s_max = old.shape[2]
        new = new[:, :, 0].to(old.dtype)
        if pos.ndim == 0:
            if int(pos) < s_max:
                old[:, :, int(pos)] = new
            return old
        lanes = torch.arange(old.shape[1], device=old.device)
        col = torch.clamp(pos.long(), max=s_max - 1)
        keep = (pos >= s_max)[None, :, None, None]
        old[:, lanes, col] = torch.where(keep, old[:, lanes, col], new)
        return old

    @torch.no_grad()
    def decode_step(self, params, cache, tokens):
        """tokens: (B, 1) -> (logits (B, Vpad), cache).  The cache's K/V are
        read-only inside the layer loop and updated once per step, in place:
        the returned dict holds the same K/V tensors with the new token
        written, and a new ``pos``."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_lookup(params["embed"], self._tokens(tokens))
        (kc, vc), = cache[SEGMENT]
        new_k, new_v = [], []
        for i, p in enumerate(params[SEGMENT]):
            x, (k, v) = block_step(p, x, cfg, pos, (kc[i], vc[i]))
            new_k.append(k)
            new_v.append(v)
        new_cache = dict(cache)
        new_cache[SEGMENT] = ((
            self._merge_kv(kc, torch.stack(new_k), pos),
            self._merge_kv(vc, torch.stack(new_v), pos),
        ),)
        logits = self._logits(params, x)
        new_cache["pos"] = pos + 1
        return logits[:, 0], new_cache

    # -- caches ------------------------------------------------------------------
    def cache_zeros(self, batch: int, cache_len: int) -> dict:
        """An all-zero cache of ``batch`` lanes (the reference's
        ``cache_abstract``, materialised): scalar ``pos``."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.hd)
        cdt = cfg_cache_dtype(cfg)
        kv = (torch.zeros(shape, dtype=cdt, device=self.device),
              torch.zeros(shape, dtype=cdt, device=self.device))
        return {SEGMENT: (kv,), "pos": torch.zeros((), dtype=torch.int32, device=self.device)}
