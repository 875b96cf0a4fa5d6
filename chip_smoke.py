#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
every CUDA kernel of the port from the sources in the checkout, holds each
kernel against its plain PyTorch version on the card, serves requests
through full-width granite-3-8b (random weights from a seed, drawn on the
card) with ``DecodeEngine(batching=True)`` under the CNA scheduler, checks
that the serving path went through the kernels, and checks the kernel inside
the model against the plain attention.  Every phase passes or raises.

Output: progress lines, then the card's name and power limit, one JSON line
``{"kernels": [...]}`` with each kernel's launches on the serving path,
error, times and bound, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside this file, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# allclose-style tolerances, |got - want| <= tol + tol * |want|: float32
# against the plain version in float32; bfloat16 as tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# kernel vs attn_xla inside full-width granite, free-running over the first
# MODEL_CHECK_LAYERS layers with the weights in float32: the two sum in other
# orders (~1e-7 relative), which the model carries to ~2e-4 of the logit
# range at this depth (a CPU run of the same comparison, the plain version
# standing in for the kernel, at full width with the vocabulary cut to 4096
# and an 860-token prompt); 2e-3 leaves room and still fails a wrong kernel,
# whose logits decorrelate.  In bf16, or deeper, the random model is chaotic
# (phase_model_check).
MODEL_CHECK_LAYERS = 2
MODEL_TOL_FRAC = 2e-3

FA_CASES = [  # b, sq, skv, h, hkv, hd, causal, window, dtype (tests/test_kernels.py)
    (2, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 256, 4, 4, 32, True, 64, "float32"),
    (1, 256, 256, 8, 1, 16, True, 0, "float32"),
    (2, 64, 192, 2, 1, 16, False, 0, "bfloat16"),
    (1, 100, 100, 4, 2, 64, True, 0, "float32"),
    (1, 128, 128, 2, 2, 128, True, 32, "bfloat16"),
    (3, 96, 96, 6, 3, 48, True, 0, "float32"),
]
GRANITE_ATTN = (8, 1024, 1024, 32, 8, 128, True, 0, "bfloat16")  # pack 8, largest bucket


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def attention_bound(case) -> tuple[float, str]:
    """Least time the card could take for this attention call: the larger of
    the live (q, k) pairs' FLOPs (QK^T and PV, 2 each per pair and head dim)
    over the peak rate of the input type, and q/k/v/o bytes (each once) over
    the memory rate.  The live pairs are counted from this call's mask."""
    b, sq, skv, h, hkv, hd, causal, window, dt = case
    live = 0
    for i in range(sq):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(skv, i + 1) if causal else skv
        live += max(0, hi - lo)
    flops = 4.0 * b * h * hd * live
    itemsize = 2 if dt == "bfloat16" else 4
    nbytes = itemsize * (2 * b * sq * h * hd + 2 * b * skv * hkv * hd)
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    return smi


def phase_build(build_mod) -> None:
    t0 = time.perf_counter()
    logs = build_mod.build()
    for name, text in logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {name}: {build_mod.lib_path(name).name} "
            f"({len(regs)} kernel instances; {regs[0] if regs else 'cached'})")
    log(f"[build] {time.perf_counter() - t0:.2f}s")


def phase_kernel(torch, fa_ops, fa_ref) -> dict:
    """The flash kernel against its plain version on the card."""
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator("cuda").manual_seed(1)
    cases = [
        GRANITE_ATTN,
        GRANITE_ATTN[:8] + ("float32",),
        (8, 777, 777, 32, 8, 128, True, 0, "bfloat16"),    # ragged S
        (8, 1024, 1024, 32, 8, 128, True, 256, "bfloat16"),  # windowed
    ] + FA_CASES
    result = {}
    for case in cases:
        b, sq, skv, h, hkv, hd, causal, window, dt = case
        q = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(dts[dt])
        k = torch.randn(b, skv, hkv, hd, generator=gen, device="cuda").to(dts[dt])
        v = torch.randn(b, skv, hkv, hd, generator=gen, device="cuda").to(dts[dt])
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa_ref.attention_plain(q, k, v, causal=causal, window=window)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        tol = TOL[dt]
        ok = bool((diff <= tol + tol * want.float().abs()).all())
        log(f"[kernel] flash_attention_fwd {case}: max_abs_err={err!r} tol={tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version at {case}")
        if case == GRANITE_ATTN:
            result["max_abs_err"] = err
            result["ms"] = median_ms(torch, lambda: fa_ops.flash_attention(q, k, v, causal=True))
            result["plain_ms"] = median_ms(torch, lambda: fa_ref.attention_plain(q, k, v, causal=True))
            # yardstick only: one library call on the same inputs, K/V
            # repeated to H heads outside the timed call
            import torch.nn.functional as F

            qt = q.transpose(1, 2)
            kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
            vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
            result["library_ms"] = median_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
            result["bound_ms"], result["bound_by"] = attention_bound(case)
            log(f"[kernel] granite shape {case}: kernel_ms={result['ms']!r} "
                f"plain_ms={result['plain_ms']!r} library_ms={result['library_ms']!r} "
                f"bound_ms={result['bound_ms']!r} ({result['bound_by']})")
        del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    return result


class TimedPrefill:
    """Stands in for the engine's packed-prefill call while serving: times
    each call (synchronised) and checks the real rows' logits are finite.
    Reads ``traces``/``calls`` through to the wrapped counter."""

    def __init__(self, torch, inner, vocab: int, sync):
        self.torch, self.inner, self.vocab, self.sync = torch, inner, vocab, sync
        self.ms: list[float] = []
        self.finite: list[bool] = []

    @property
    def traces(self):
        return self.inner.traces

    @property
    def calls(self):
        return self.inner.calls

    def __call__(self, params, toks, lens):
        torch = self.torch
        self.sync()
        t0 = time.perf_counter()
        logits, cache = self.inner(params, toks, lens)
        self.sync()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        real = torch.as_tensor(lens, device=logits.device) > 0
        self.finite.append(bool(torch.isfinite(logits[real, : self.vocab]).all()))
        return logits, cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_serve(torch, np, fa_ops, cfg, device, *, n_slots=8, cache_len=1024,
                n_requests=16, prompt_lens=(64, 1000), max_new=16) -> dict:
    """The main path: ``DecodeEngine(batching=True)`` under the CNA
    scheduler, serving ``n_requests`` prompts.  The flash launch count is
    set to 0 just before the engine is built (its bucket warm-up is part of
    the path) and read just after the last request retires."""
    from repro_torch.models.registry import build_model
    from repro_torch.serving import CNAScheduler, DecodeEngine, Request

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16), drawn on {device} in "
        f"{time.perf_counter() - t0:.2f}s")

    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(*prompt_lens))).astype(np.int32),
                max_new=max_new, domain=int(rng.integers(0, 2)))
        for i in range(n_requests)
    ]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # --- the main path: counts set to 0 just before, read just after ---
    fa_ops.flash_attention.launches = 0
    t_build = time.perf_counter()
    eng = DecodeEngine(model, params, batching=True, n_slots=n_slots, cache_len=cache_len,
                       scheduler=CNAScheduler())
    sync()
    warm_s = time.perf_counter() - t_build
    timed = TimedPrefill(torch, eng.batcher.packed, cfg.vocab, sync)
    eng.batcher.packed = timed
    submit_at = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    ttft, tick_ms = {}, []
    while len(eng.scheduler) or eng.active_req:
        calls = timed.calls
        t = time.perf_counter()
        eng.step()  # ends in the tick's one host read
        now = time.perf_counter()
        if timed.calls == calls:
            tick_ms.append((now - t) * 1e3)
        for r in reqs:
            if r.rid not in ttft and r.out:
                ttft[r.rid] = (now - submit_at) * 1e3
    sync()
    wall = time.perf_counter() - submit_at
    launches = fa_ops.flash_attention.launches
    # --- end of the main path ---

    n_buckets = len(eng.batcher.buckets)
    tokens = sum(len(r.out) for r in reqs)
    waits = np.array([ttft[r.rid] for r in reqs])
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    log(f"[serve] warm={warm_s:.2f}s ({n_buckets} buckets) requests={len(reqs)} "
        f"tokens={tokens} wall_s={wall!r} tokens_per_s={tokens / wall!r} "
        f"ttft_p50_ms={float(np.percentile(waits, 50))!r} "
        f"ttft_p99_ms={float(np.percentile(waits, 99))!r}")
    log(f"[serve] packed prefill calls={len(timed.ms)} ms_per_call={timed.ms!r}")
    log(f"[serve] decode-only ticks={len(tick_ms)} median_ms_per_tick="
        f"{sorted(tick_ms)[len(tick_ms) // 2] if tick_ms else float('nan')!r} "
        f"sim_time={eng.sim_time} locality={eng.scheduler.metrics.locality!r} "
        f"switches={eng.scheduler.metrics.domain_switches} "
        f"compile_counts={eng.compile_counts} peak_mem_gb={peak!r}")
    if not all(len(r.out) == max_new for r in reqs):
        raise AssertionError(f"not every request retired with {max_new} tokens: "
                             f"{[len(r.out) for r in reqs]}")
    if not (timed.finite and all(timed.finite)):
        raise AssertionError("a first-token logit is not finite")
    return {"launches": launches, "packed_calls": n_buckets + len(timed.ms),
            "model": model, "params": params, "prompt": reqs[0].prompt}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _logit_diff(cfg, got, want) -> tuple[float, float, bool]:
    got, want = got[0, : cfg.vocab].float(), want[0, : cfg.vocab].float()
    return (float((got - want).abs().max()), float(want.abs().max()),
            int(got.argmax()) == int(want.argmax()))


def phase_model_check(torch, cfg, served, device, fa_ref) -> None:
    """The kernel inside the model, on one served prompt, same weights.

    1. Every layer of the full-depth bf16 ``prefill``: the kernel's output on
       that layer's own q/k/v against the plain version (held, bf16
       tolerance).
    2. The full-depth bf16 ``prefill`` with the kernel against
       ``cfg.replace(attn_impl="xla")`` (the plain attention), printed and
       not held, beside a control with no kernel in it (the kernel's plain
       version inside the model against ``attn_xla``).  With the
       reference's init rule the random model's attention is near one-hot
       (q/k entries of std ~11 and ~23, scores of std ~256), so a one-ulp
       difference flips which key a head picks, and the layers decorrelate
       the logits whichever two implementations are compared.
    3. The same on the first ``MODEL_CHECK_LAYERS`` layers with the weights
       cast to float32, where rounding is too small to flip a pick:
       last-token logits held within ``MODEL_TOL_FRAC`` of their range."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model

    model, params, prompt = served["model"], served["params"], served["prompt"]
    batch = {"tokens": prompt[None]}
    dispatch = tfm.attention
    errs = []

    def checked(q, k, v, **kw):
        out = dispatch(q, k, v, **kw)
        want = fa_ref.attention_plain(q, k, v, causal=kw["causal"], window=kw["window"])
        diff = (out.float() - want.float()).abs()
        tol = TOL[cfg.dtype]
        errs.append((float(diff.max()), bool((diff <= tol + tol * want.float().abs()).all())))
        return out

    def plain(q, k, v, **kw):
        return fa_ref.attention_plain(q, k, v, causal=kw["causal"], window=kw["window"])

    def prefill(m, p, attention=None):
        tfm.attention = attention or dispatch
        try:
            return m.prefill(p, batch)[0]
        finally:
            tfm.attention = dispatch

    got = prefill(model, params, checked)
    log(f"[model] prompt of {len(prompt)} tokens, per layer kernel vs plain on the layer's "
        f"q/k/v: max_abs_err={max(e for e, _ in errs)!r} tol={TOL[cfg.dtype]} "
        f"layers={len(errs)} ok={sum(ok for _, ok in errs)}")
    if len(errs) != cfg.n_layers or not all(ok for _, ok in errs):
        raise AssertionError(f"kernel disagrees with its plain version inside the model: {errs}")

    xla_cfg = cfg.replace(attn_impl="xla")
    want = prefill(build_model(xla_cfg, device=device), params)
    control = prefill(model, params, plain)
    free = _logit_diff(cfg, got, want)
    ctrl = _logit_diff(cfg, control, want)
    log(f"[model] {cfg.n_layers} layers, last-token logits (not held): kernel vs attn_xla "
        f"max_abs_diff={free[0]!r} same_argmax={free[2]}; control, plain version vs "
        f"attn_xla max_abs_diff={ctrl[0]!r} same_argmax={ctrl[2]}; max|logit| {free[1]!r}")

    n = MODEL_CHECK_LAYERS
    cut = _cast(dict(params, blocks=params["blocks"][:n]), torch.float32)
    got = prefill(build_model(cfg.replace(n_layers=n, dtype="float32"), device=device), cut)
    want = prefill(build_model(xla_cfg.replace(n_layers=n, dtype="float32"), device=device), cut)
    diff, scale, same = _logit_diff(cfg, got, want)
    tol = MODEL_TOL_FRAC * scale
    log(f"[model] first {n} layers in float32, last-token logits kernel vs attn_xla: "
        f"max_abs_diff={diff!r} tol={tol!r} (= {MODEL_TOL_FRAC} x max|logit| {scale!r}) "
        f"same_argmax={same}")
    if not diff <= tol:
        raise AssertionError(f"kernel and plain attention disagree inside the model: {diff} > {tol}")


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: {src / 'repro_torch'} not found; run from a checkout")
    import numpy as np
    import torch

    smi = phase_device(torch)
    sys.path.insert(0, str(src))
    from repro_torch import _build
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build(_build)
    kern = phase_kernel(torch, fa_ops, fa_ref)
    cfg = get_config("granite_3_8b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff, cfg.vocab,
            cfg.dtype) == (40, 4096, 32, 8, 12800, 49155, "bfloat16"), cfg
    served = phase_serve(torch, np, fa_ops, cfg, "cuda")
    expected = cfg.n_layers * served["packed_calls"]
    log(f"[serve] flash launches={served['launches']} (expected {cfg.n_layers} layers x "
        f"{served['packed_calls']} packed prefill calls = {expected})")
    if served["launches"] != expected or expected == 0:
        raise AssertionError(f"flash launches {served['launches']} != {expected}")
    phase_model_check(torch, cfg, served, "cuda", fa_ref)
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:38",
        "launches": served["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
