#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card.  It builds
every CUDA kernel of the port from the sources in the checkout (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card (the flash kernel also at the edges of its
bf16 tensor-core instances: padded head dims, single and ragged rows, Sq !=
Skv, a window under one kv tile), and drives the port's three serving paths
with random weights from a seed, drawn on the card:

  * full-width granite-3-8b through ``DecodeEngine(batching=True)`` (packed
    prefill; the flash kernel in every layer);
  * full-width recurrentgemma-2b through ``DecodeEngine(batching=False)``
    (per-request prefill; the RG-LRU scan kernel in its 18 recurrent layers,
    the flash kernel at head dim 256 with a 2048-token window in its 8
    attention layers; prompts past the window, so the ring wraps);
  * full-width mamba2-130m through ``DecodeEngine(batching=False)``
    (per-request prefill; the SSD intra-chunk kernel in its 24 layers;
    prompts of 64-2000 tokens, one under a chunk and one an exact multiple
    of it);

all under the CNA scheduler.  Each path's launch counts are set to 0 just
before it and read just after, and must match its prefill calls.  Then the
kernels are checked inside each model against the plain versions.  Every
phase passes or raises.

Output: progress lines, then the card's name and power limit, one JSON line
``{"kernels": [...]}`` with each kernel's launches on its serving path,
error, times (each with the wrapper's host latency inside; the scan's
and the SSD kernel's also with L2 cold, ``cold_ms``, and as device time
alone, ``device_ms`` and ``device_cold_ms``; null for flash, not
measured), bound, achieved TFLOP/s and time over bound, and as the last
line ``{"ok": true, "device":
{...}}``.  Without a CUDA device, or without the rest of the repository
beside this file, it exits non-zero and prints no result.
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
# the scan kernel against its plain version, float32 (tests/test_recurrent.py):
# the two run one recurrence in one order, the kernel with a fused FMA
SCAN_ATOL, SCAN_RTOL = 1e-5, 1e-4
# the SSD kernel against its plain version, float32: the two sum over N =
# 128 and L = 128 in other orders, and cum = cumsum(dA) falls to about -100
# to -200 over a chunk with dA in [-1.6, 0], where one ulp (~1e-5) moves a
# decay factor by ~1e-5 relative; the plain version in float32 against
# float64 at the longest served shape (a CPU run) is off by up to 5.7e-4 on
# outputs up to ~200
SSD_ATOL, SSD_RTOL = 1e-3, 1e-4
# kernels vs plain versions inside a full-width model, free-running over its
# first layers with the weights in float32: the two sum in other orders
# (~1e-7 relative), which the model carries to ~2e-4 of the logit range at
# this depth (granite: a CPU run of the same comparison, the plain version
# standing in for the kernel, at full width with the vocabulary cut to 4096
# and an 860-token prompt); 2e-3 leaves room and still fails a wrong kernel,
# whose logits decorrelate.  In bf16, or deeper, the random models are
# chaotic (phase_model_check).
MODEL_CHECK_LAYERS = {"granite-3-8b": 2, "recurrentgemma-2b": 3}  # rg: one (rec, rec, attn)
MODEL_TOL_FRAC = 2e-3
# mamba2-130m at full depth in float32, the SSD kernel against its plain
# version: an SSM has no softmax to turn one ulp into another pick, so the
# difference stays at rounding level through all 24 layers (a CPU run of
# the 24-layer model at half width, d 384, on a 1000-token prompt, with the
# intra term in float64 against float32: 4.3e-6 of the logit range); 1e-4
# leaves room and still fails a wrong kernel
SSM_MODEL_TOL_FRAC = 1e-4

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
# the bf16 tensor-core kernel's edges (tests/test_torch_flash_attention.py)
FA_BF16_EDGES = [
    (2, 130, 130, 4, 2, 72, True, 0, "bfloat16"),      # hd padded to 128 in shared memory
    (1, 300, 300, 3, 1, 200, True, 64, "bfloat16"),    # hd padded to 256, windowed
    (2, 200, 200, 4, 4, 64, True, 0, "bfloat16"),      # hd 64, no window
    (1, 333, 333, 4, 1, 256, True, 0, "bfloat16"),     # hd 256, no window
    (3, 1, 1, 4, 2, 128, True, 0, "bfloat16"),         # one row
    (2, 65, 65, 4, 1, 256, True, 0, "bfloat16"),       # one past a tile
    (2, 777, 777, 4, 2, 128, True, 0, "bfloat16"),
    (2, 65, 777, 4, 2, 128, False, 0, "bfloat16"),     # Sq != Skv, not causal
    (1, 777, 65, 2, 1, 256, False, 0, "bfloat16"),
    (2, 1, 777, 8, 2, 128, False, 0, "bfloat16"),
    (2, 256, 256, 4, 2, 128, True, 16, "bfloat16"),    # window under one kv tile
    (1, 200, 200, 2, 1, 256, True, 16, "bfloat16"),
    (7, 100, 100, 19, 19, 128, True, 0, "bfloat16"),   # B*H = 133, not a multiple of 132
]
SCAN_RAGGED = [(3, 1, 7), (2, 300, 130), (1, 257, 129), (4, 1000, 2561)]  # (B, S, W)
# (B, nc, L, H, P, N): B 2 at the served widths, then ragged L, P and N
SSD_RAGGED = [(2, 4, 128, 24, 64, 128), (2, 3, 100, 5, 80, 40), (3, 2, 1, 3, 16, 200),
              (1, 5, 128, 7, 130, 33)]

# the recurrentgemma-2b workload: 16 prompts of 64-3000 tokens, the first 4
# drawn past the 2048-token window, all shuffled by numpy's default_rng(0)
RG_REQUESTS, RG_LONG, RG_PROMPTS, RG_WINDOW = 16, 4, (64, 3001), 2048
# the mamba2-130m workload: 16 prompts of 64-2000 tokens (its training
# context is 2048): one under a 128-token chunk, one an exact multiple of
# it, the longest 2000 (padded to 16 chunks), and 13 drawn by numpy's
# default_rng(0), all shuffled
M2_REQUESTS, M2_PROMPTS, M2_FIXED, M2_CHUNK = 16, (64, 2000), (77, 1024, 2000), 128


def log(msg: str) -> None:
    print(msg, flush=True)


# cold-L2 timing: this many bytes are written between two timed calls, more
# than twice the H100's 50 MB L2, so the call finds none of its inputs there
FLUSH_BYTES = 256 * 2**20
# device-time timing: cycles the card spins (torch.cuda._sleep, ~0.5 ms)
# ahead of each timed call, so that the host has enqueued the call before
# the start event is reached
LEAD_CYCLES = 1_000_000
# the scan's repeated-call check: calls at the longest served shape that
# must agree bit for bit
SCAN_REPEATS = 20


def median_ms(torch, fn, reps: int = 25, warmup: int = 3, cold: bool = False,
              device: bool = False) -> float:
    """Median of ``reps`` single-call CUDA-event timings after warm-up.  The
    card is idle at the start event, so a time holds the wrapper's host
    latency as well as the kernel, unless ``device``: then ``LEAD_CYCLES``
    run ahead of each call and the events bracket device work only.
    ``cold``: ``FLUSH_BYTES`` written and waited for before each call,
    outside the timed window, so L2 holds none of its inputs."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda") if cold else None
    for _ in range(warmup):
        fn()
    times = []
    for i in range(reps):
        if cold:
            flush.fill_(float(i))
            torch.cuda.synchronize()
        if device:
            torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    times.sort()
    return times[len(times) // 2]


def scan_timings(torch, fn) -> dict:
    """A scan kernel's ``ms`` (as the other kernels', host latency inside)
    and, L2 cold and as device time, ``cold_ms``, ``device_ms`` and
    ``device_cold_ms``."""
    return {"ms": median_ms(torch, fn), "cold_ms": median_ms(torch, fn, cold=True),
            "device_ms": median_ms(torch, fn, device=True),
            "device_cold_ms": median_ms(torch, fn, cold=True, device=True)}


def attention_bound(case) -> tuple[float, str, float]:
    """Least time the card could take for this attention call: the larger of
    the live (q, k) pairs' FLOPs (QK^T and PV, 2 each per pair and head dim)
    over the peak rate of the input type, and q/k/v/o bytes (each once) over
    the memory rate.  The live pairs are counted from this call's mask.
    Returns (ms, what bounds it, FLOPs)."""
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
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def scan_bound(shape) -> tuple[float, str, float]:
    """Least time for one linear scan: a and b read once, h0 read once, the
    (B, S, W) float32 output written once, over the memory rate; its one
    FMA per element is ~1e-4 of that at the float32 peak."""
    b, s, w = shape
    nbytes, flops = 4 * (3 * b * s * w + b * w), 2.0 * b * s * w
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def ssd_bound(shape) -> tuple[float, str, float]:
    """Least time for one SSD intra-chunk call: xc, dac, bc, cc read once and
    the output written once over the memory rate, against the live (l >= s)
    pairs' FLOPs with C B^T formed once per chunk (2 * N per pair) and the
    scores applied to every head's X (2 * H * P per pair), over the float32
    peak of the CUDA cores."""
    b, nc, l, h, p, n = shape
    nbytes = 4 * (2 * b * nc * l * h * p + 2 * b * nc * l * n + b * h * nc * l)
    flops = 2.0 * (l * (l + 1) // 2) * (n + h * p) * b * nc
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def rates(r) -> str:
    """Achieved TFLOP/s (the bound's FLOPs over the kernel's time) and the
    kernel's time over its bound, as printed on the ``[kernel]`` lines."""
    return f"tflops={r['tflops']!r} ms_over_bound={r['ms_over_bound']!r}"


def with_rates(r: dict, bound) -> dict:
    """``r`` with bound_ms, bound_by, tflops and ms_over_bound filled in from
    ``bound`` = (ms, what bounds it, FLOPs) and r["ms"]."""
    r["bound_ms"], r["bound_by"], flops = bound
    r["tflops"] = flops / (r["ms"] * 1e-3) / 1e12
    r["ms_over_bound"] = r["ms"] / r["bound_ms"]
    return r


def m2_prompt_lengths(np) -> list[int]:
    rng = np.random.default_rng(0)
    lens = list(M2_FIXED)
    lens += [int(x) for x in rng.integers(*M2_PROMPTS, M2_REQUESTS - len(M2_FIXED))]
    rng.shuffle(lens)
    return lens


def ssd_shape(s: int, cfg) -> tuple:
    """The intra-chunk call of a prompt of ``s`` tokens: L = min(chunk, s),
    the prompt padded to nc chunks."""
    l = min(cfg.ssm_chunk, s)
    return (1, -(-s // l), l, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


def rg_prompt_lengths(np) -> list[int]:
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(RG_WINDOW + 1, RG_PROMPTS[1], RG_LONG)]
    lens += [int(x) for x in rng.integers(*RG_PROMPTS, RG_REQUESTS - RG_LONG)]
    rng.shuffle(lens)
    return lens


def _close(torch, got, want, atol, rtol) -> tuple[float, bool]:
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= atol + rtol * want.float().abs()).all())


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
        entries = ptxas_entries(text)
        log(f"[build] {name}: {build_mod.lib_path(name).name} ({len(entries)} kernel instances, "
            f"registers max {max(r for _, r, _ in entries) if entries else 'cached'}, "
            f"spill stores {sum(sp for *_, sp in entries)} bytes)")
        bf16 = bf16_instances(text)
        if bf16:
            log(f"[build] {name} bf16 tensor-core instances (hd_pad, warps, BK, blocks/SM): "
                + "; ".join(f"{args} registers {r} spill stores {sp} bytes"
                            for args, r, sp in bf16))
        elif entries:
            log(f"[build] {name} instances (mangled): "
                + "; ".join(f"{fn} registers {r} spill stores {sp} bytes" for fn, r, sp in entries))
    log(f"[build] {time.perf_counter() - t0:.2f}s")


def ptxas_entries(text: str) -> list:
    """(mangled name, registers, spill-store bytes) of each entry function
    in a ``ptxas -v`` log."""
    out, name, spill = [], None, 0
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], 0
        elif name is not None and "spill stores" in ln:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif name is not None and "Used " in ln and "registers" in ln:
            out.append((name, int(ln.split("Used ")[1].split()[0]), spill))
            name = None
    return out


def bf16_instances(text: str) -> list:
    """(template arguments, registers, spill-store bytes) of each bf16
    flash instance in a ``ptxas -v`` log."""
    import re

    out = []
    for mangled, r, sp in ptxas_entries(text):
        m = re.search(r"fa_fwd_bf16_kernelI((?:Li\d+E)+)E", mangled)
        if m:
            out.append((tuple(int(x) for x in re.findall(r"Li(\d+)E", m.group(1))), r, sp))
    return out


def _time_attention(torch, fa_ops, fa_ref, case, q, k, v) -> dict:
    """Kernel, plain version and the library yardstick on one case's inputs."""
    import torch.nn.functional as F

    b, sq, skv, h, hkv, hd, causal, window, dt = case
    out = {
        "ms": median_ms(torch, lambda: fa_ops.flash_attention(q, k, v, causal=causal, window=window)),
        "plain_ms": median_ms(
            torch, lambda: fa_ref.attention_plain(q, k, v, causal=causal, window=window), reps=10),
    }
    # yardstick only, never called by the port: one library call on the same
    # inputs, K/V repeated to H heads (and the band mask built) outside the
    # timed call
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(h // hkv, dim=2).transpose(1, 2)
    if window > 0:
        i = torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None, :]
        band = (j <= i) & (i - j < window)
        out["library_ms"] = median_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band))
    else:
        out["library_ms"] = median_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
    return with_rates(out, attention_bound(case))


def phase_flash(torch, fa_ops, fa_ref, rg_len: int) -> dict:
    """The flash kernel against its plain version on the card, at both
    paths' shapes and at the bf16 kernel's edges; timed at each path's
    largest, and the float32 (CUDA-core) instance at granite's."""
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    gen = torch.Generator("cuda").manual_seed(1)
    rg_attn = (1, rg_len, rg_len, 10, 1, 256, True, RG_WINDOW, "bfloat16")
    cases = [
        GRANITE_ATTN,
        GRANITE_ATTN[:8] + ("float32",),
        (8, 777, 777, 32, 8, 128, True, 0, "bfloat16"),    # ragged S
        (8, 1024, 1024, 32, 8, 128, True, 256, "bfloat16"),  # windowed
        rg_attn,
        rg_attn[:8] + ("float32",),
        (2, 2100, 2100, 10, 1, 256, True, RG_WINDOW, "bfloat16"),  # B 2, just past the window
        (1, 555, 555, 10, 1, 256, True, RG_WINDOW, "float32"),     # inside the window, ragged
    ] + FA_CASES + FA_BF16_EDGES
    timed = {"granite-3-8b": GRANITE_ATTN, "recurrentgemma-2b": rg_attn,
             "granite-3-8b@float32": GRANITE_ATTN[:8] + ("float32",)}
    result = {}
    for case in cases:
        b, sq, skv, h, hkv, hd, causal, window, dt = case
        q = torch.randn(b, sq, h, hd, generator=gen, device="cuda").to(dts[dt])
        k = torch.randn(b, skv, hkv, hd, generator=gen, device="cuda").to(dts[dt])
        v = torch.randn(b, skv, hkv, hd, generator=gen, device="cuda").to(dts[dt])
        got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa_ref.attention_plain(q, k, v, causal=causal, window=window)
        err, ok = _close(torch, got, want, TOL[dt], TOL[dt])
        log(f"[kernel] flash_attention_fwd {case}: max_abs_err={err!r} tol={TOL[dt]} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version at {case}")
        for path, tcase in timed.items():
            if case == tcase:
                r = result[path] = {"max_abs_err": err, "shape": case,
                                    **_time_attention(torch, fa_ops, fa_ref, case, q, k, v)}
                log(f"[kernel] flash at the {path} shape {case}: kernel_ms={r['ms']!r} "
                    f"plain_ms={r['plain_ms']!r} library_ms={r['library_ms']!r} "
                    f"bound_ms={r['bound_ms']!r} ({r['bound_by']}) {rates(r)}")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return result


def phase_scan(torch, rg_ops, rg_ref, lengths: list[int]) -> dict:
    """The scan kernel against its plain version on the card: at every
    served prompt's shape (B 1, W 2560) and at ragged shapes, all with
    h0 != 0; at the longest served prompt, ``SCAN_REPEATS`` calls agree bit
    for bit (the carries between chunks must not depend on the order in
    which blocks run), and it is timed there with L2 warm and cold."""
    gen = torch.Generator("cuda").manual_seed(2)
    longest = (1, max(lengths), 2560)
    shapes = [(1, s, 2560) for s in sorted(set(lengths))] + SCAN_RAGGED
    errs, result = [], {}
    for shape in shapes:
        a = 0.2 + 0.799 * torch.rand(shape, generator=gen, device="cuda")
        b = torch.randn(shape, generator=gen, device="cuda")
        h0 = torch.randn(shape[0], shape[2], generator=gen, device="cuda")
        got = rg_ops.linear_scan(a, b, h0)
        torch.cuda.synchronize()
        want = rg_ref.linear_scan_plain(a, b, h0)
        err, ok = _close(torch, got, want, SCAN_ATOL, SCAN_RTOL)
        errs.append((shape, err, ok))
        if not ok:
            raise AssertionError(f"scan kernel disagrees with its plain version at {shape}: {err}")
        if shape == longest:
            same = sum(bool(torch.equal(rg_ops.linear_scan(a, b, h0), got))
                       for _ in range(SCAN_REPEATS - 1))
            log(f"[kernel] linear_scan repeated {SCAN_REPEATS} times at {shape}: "
                f"{same + 1} of {SCAN_REPEATS} bitwise equal")
            if same != SCAN_REPEATS - 1:
                raise AssertionError(f"linear_scan is not deterministic at {shape}")
            result = {"max_abs_err": err, "shape": shape,
                      **scan_timings(torch, lambda: rg_ops.linear_scan(a, b, h0)),
                      "plain_ms": median_ms(torch, lambda: rg_ref.linear_scan_plain(a, b, h0),
                                            reps=5, warmup=1),
                      "library_ms": None}
            with_rates(result, scan_bound(shape))
    log(f"[kernel] linear_scan vs plain at {len(shapes)} shapes (B, S, W), h0 != 0: "
        f"max_abs_err={max(e for _, e, _ in errs)!r} atol={SCAN_ATOL} rtol={SCAN_RTOL} "
        f"ok={sum(ok for *_, ok in errs)}; ragged {[(s, e) for s, e, _ in errs[-len(SCAN_RAGGED):]]}")
    log(f"[kernel] linear_scan at the recurrentgemma-2b shape {longest}: "
        f"kernel_ms={result['ms']!r} cold_ms={result['cold_ms']!r} "
        f"device_ms={result['device_ms']!r} device_cold_ms={result['device_cold_ms']!r} "
        f"plain_ms={result['plain_ms']!r} library_ms=none "
        f"(no single PyTorch call computes a linear recurrence) "
        f"bound_ms={result['bound_ms']!r} ({result['bound_by']}) {rates(result)}")
    torch.cuda.empty_cache()
    return result


def phase_ssd(torch, ssd_ops, ssd_ref, cfg, lengths: list[int]) -> dict:
    """The SSD kernel against its plain version on the card, dA in [-1.6, 0]
    (the range dt * A takes): at every served prompt's shape, and at B 2
    and ragged shapes whose dac is a permuted view and bc/cc slices of one
    wider tensor, as the model passes them; timed at the longest served
    prompt with L2 warm and cold."""
    gen = torch.Generator("cuda").manual_seed(3)
    longest = ssd_shape(max(lengths), cfg)
    served = sorted({ssd_shape(s, cfg) for s in lengths})
    errs, result = [], {}
    for shape in served + SSD_RAGGED:
        b, nc, l, h, p, n = shape
        xc = torch.randn(b, nc, l, h, p, generator=gen, device="cuda")
        if shape in served:
            dac = -1.6 * torch.rand(b, h, nc, l, generator=gen, device="cuda")
            bc = torch.randn(b, nc, l, n, generator=gen, device="cuda")
            cc = torch.randn(b, nc, l, n, generator=gen, device="cuda")
        else:
            dac = (-1.6 * torch.rand(b, nc, l, h, generator=gen, device="cuda")).permute(0, 3, 1, 2)
            bcc = torch.randn(b, nc, l, 2 * n + 3, generator=gen, device="cuda")
            bc, cc = bcc[..., :n], bcc[..., n : 2 * n]
        got = ssd_ops.ssd_intra(xc, dac, bc, cc)
        torch.cuda.synchronize()
        want = ssd_ref.ssd_intra_plain(xc, dac, bc, cc)
        err, ok = _close(torch, got, want, SSD_ATOL, SSD_RTOL)
        ok = ok and bool(torch.isfinite(got).all())
        errs.append((shape, err, ok))
        if not ok:
            raise AssertionError(f"ssd_intra disagrees with its plain version at {shape}: {err}")
        if shape == longest:
            result = {"max_abs_err": err, "shape": shape,
                      **scan_timings(torch, lambda: ssd_ops.ssd_intra(xc, dac, bc, cc)),
                      "plain_ms": median_ms(torch, lambda: ssd_ref.ssd_intra_plain(xc, dac, bc, cc),
                                            reps=10),
                      "library_ms": None}
            with_rates(result, ssd_bound(shape))
    log(f"[kernel] ssd_intra vs plain at {len(errs)} shapes (B, nc, L, H, P, N), dA in [-1.6, 0]: "
        f"max_abs_err={max(e for _, e, _ in errs)!r} atol={SSD_ATOL} rtol={SSD_RTOL} "
        f"ok={sum(ok for *_, ok in errs)}; per shape {[(s, e) for s, e, _ in errs]}")
    log(f"[kernel] ssd_intra at the mamba2-130m shape {longest}: "
        f"kernel_ms={result['ms']!r} cold_ms={result['cold_ms']!r} "
        f"device_ms={result['device_ms']!r} device_cold_ms={result['device_cold_ms']!r} "
        f"plain_ms={result['plain_ms']!r} library_ms=none "
        f"(no single PyTorch call computes the masked-decay product) "
        f"bound_ms={result['bound_ms']!r} ({result['bound_by']}) {rates(result)}")
    torch.cuda.empty_cache()
    return result


class TimedCall:
    """Stands in for the engine's prefill call while serving: times each
    call (synchronised), records its prompt length and checks the real
    rows' logits are finite.  Reads ``traces``/``calls`` through to the
    wrapped counter."""

    def __init__(self, torch, inner, vocab: int, sync, packed: bool):
        self.torch, self.inner, self.vocab, self.sync, self.packed = torch, inner, vocab, sync, packed
        self.ms: list[float] = []
        self.lens: list[int] = []
        self.finite: list[bool] = []

    @property
    def traces(self):
        return self.inner.traces

    @property
    def calls(self):
        return self.inner.calls

    def __call__(self, params, *args):
        torch = self.torch
        self.sync()
        t0 = time.perf_counter()
        logits, cache = self.inner(params, *args)
        self.sync()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        if self.packed:  # (tokens, lengths): rows of length 0 are dummies
            real = torch.as_tensor(args[1], device=logits.device) > 0
            self.lens.append(int(max(args[1])))
        else:  # ({"tokens": (1, S)},)
            real = slice(None)
            self.lens.append(int(args[0]["tokens"].shape[1]))
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


def phase_serve(torch, np, counters, cfg, device, *, batching, lengths, n_slots=8,
                cache_len=1024, max_new=16) -> dict:
    """One serving path: ``DecodeEngine(batching=...)`` under the CNA
    scheduler.  ``lengths`` is either a list with one prompt length per
    request, or a (low, high) range from which each of 16 requests draws
    its length in turn with its tokens and domain.  The
    launch counts in ``counters`` (name -> wrapper) are set to 0 just before
    the engine is built (a packed engine's bucket warm-up is part of the
    path) and read just after the last request retires."""
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
    reqs = []
    for i in range(16 if isinstance(lengths, tuple) else len(lengths)):
        n = int(rng.integers(*lengths)) if isinstance(lengths, tuple) else lengths[i]
        reqs.append(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                            max_new=max_new, domain=int(rng.integers(0, 2))))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # --- the path: counts set to 0 just before, read just after ---
    for fn in counters.values():
        fn.launches = 0
    t_build = time.perf_counter()
    eng = DecodeEngine(model, params, batching=batching, n_slots=n_slots, cache_len=cache_len,
                       scheduler=CNAScheduler())
    sync()
    warm_s = time.perf_counter() - t_build
    if batching:
        timed = eng.batcher.packed = TimedCall(torch, eng.batcher.packed, cfg.vocab, sync, True)
    else:
        timed = eng._prefill = TimedCall(torch, eng._prefill, cfg.vocab, sync, False)
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
    launches = {name: fn.launches for name, fn in counters.items()}
    # --- end of the path ---

    warm_calls = len(eng.batcher.buckets) if batching else 0
    tokens = sum(len(r.out) for r in reqs)
    waits = np.array([ttft[r.rid] for r in reqs])
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else float("nan")
    log(f"[serve] {cfg.name} batching={batching} warm={warm_s:.2f}s ({warm_calls} buckets) "
        f"requests={len(reqs)} tokens={tokens} wall_s={wall!r} tokens_per_s={tokens / wall!r} "
        f"ttft_p50_ms={float(np.percentile(waits, 50))!r} "
        f"ttft_p99_ms={float(np.percentile(waits, 99))!r}")
    log(f"[serve] {cfg.name} prefill calls={len(timed.ms)} (prompt or bucket length, ms): "
        f"{[(n, round(ms, 3)) for n, ms in zip(timed.lens, timed.ms)]!r}")
    log(f"[serve] {cfg.name} decode-only ticks={len(tick_ms)} median_ms_per_tick="
        f"{sorted(tick_ms)[len(tick_ms) // 2] if tick_ms else float('nan')!r} "
        f"sim_time={eng.sim_time} locality={eng.scheduler.metrics.locality!r} "
        f"switches={eng.scheduler.metrics.domain_switches} "
        f"compile_counts={eng.compile_counts} peak_mem_gb={peak!r}")
    if not all(len(r.out) == max_new for r in reqs):
        raise AssertionError(f"not every request retired with {max_new} tokens: "
                             f"{[len(r.out) for r in reqs]}")
    if not (timed.finite and all(timed.finite)):
        raise AssertionError("a first-token logit is not finite")
    longest = max(reqs, key=lambda r: len(r.prompt))
    return {"launches": launches, "prefill_calls": warm_calls + len(timed.ms),
            "model": model, "params": params, "prompt": longest.prompt}


def _check_launches(cfg, served, per_call: dict) -> None:
    """Each kernel launched once per layer of its kind in every prefill call."""
    for name, layers in per_call.items():
        expected = layers * served["prefill_calls"]
        got = served["launches"][name]
        log(f"[serve] {cfg.name} {name} launches={got} (expected {layers} layers x "
            f"{served['prefill_calls']} prefill calls = {expected})")
        if got != expected or expected == 0:
            raise AssertionError(f"{cfg.name}: {name} launches {got} != {expected}")


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


class Patched:
    """Routes the model's attention and scan calls through checking or
    plain stand-ins while a prefill runs, and puts the originals back."""

    def __init__(self, tfm, rglru_mod):
        self.tfm, self.rglru_mod = tfm, rglru_mod
        self.attention, self.rg_ops = tfm.attention, rglru_mod.rg_ops

    def prefill(self, model, params, batch, attention=None, linear_scan=None):
        from types import SimpleNamespace

        self.tfm.attention = attention or self.attention
        if linear_scan is not None:
            self.rglru_mod.rg_ops = SimpleNamespace(linear_scan=linear_scan)
        try:
            return model.prefill(params, batch)[0]
        finally:
            self.tfm.attention, self.rglru_mod.rg_ops = self.attention, self.rg_ops


def phase_model_check(torch, cfg, served, device, fa_ref, rg_ref) -> None:
    """The kernels inside the model, on the longest served prompt, same
    weights.

    1. Every layer of the full-depth bf16 ``prefill``: each kernel's output
       on that layer's own inputs against its plain version (held): the
       flash kernel on each ``attn`` layer's q/k/v (bf16 tolerance) against
       the plain version in float64, the exact function of those inputs;
       the scan kernel on each ``rec`` layer's (a, gated input, h0)
       (float32, as the scan runs in float32 in a bf16 model).  Against the
       plain version in float32 the flash kernel is printed, not held:
       recurrentgemma's scores reach ~40000 before scaling, where one
       float32 ulp is ~0.004, and in rows whose two top keys nearly tie and
       whose V rows cancel to an output near 0 the float32 plain version is
       itself off the exact answer by up to ~94 % of the tolerance, so two
       float32 computations that sum Q K^T in other orders stand outside it
       of each other (``tools/flash_tiles.py`` counts them).
    2. The full-depth bf16 ``prefill`` with the kernels against the
       all-plain model (``attn_impl="xla"``, the scan's plain version),
       printed and not held, beside a control with no kernel in it (the
       kernels' plain versions inside the model).  With the reference's init
       rule the random models' attention is near one-hot (granite: q/k
       entries of std ~11 and ~23, scores of std ~256; recurrentgemma's one
       KV head gives scores of std ~800), so a one-ulp difference flips
       which key a head picks, and the layers decorrelate the logits
       whichever two implementations are compared.
    3. The same on the first ``MODEL_CHECK_LAYERS`` layers with the weights
       cast to float32, where rounding is too small to flip a pick:
       last-token logits held within ``MODEL_TOL_FRAC`` of their range,
       same argmax.  For recurrentgemma that is one (rec, rec, attn)
       repetition, on a prompt past the window."""
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model

    model, params, prompt = served["model"], served["params"], served["prompt"]
    batch = {"tokens": prompt[None]}
    patch = Patched(tfm, rglru_mod)
    attn_errs, attn32, scan_errs = [], [], []

    def checked_attention(q, k, v, **kw):
        out = patch.attention(q, k, v, **kw)
        want = fa_ref.attention_plain(q.double(), k.double(), v.double(), causal=kw["causal"],
                                      window=kw["window"])
        attn_errs.append(_close(torch, out, want, TOL[cfg.dtype], TOL[cfg.dtype]))
        want32 = fa_ref.attention_plain(q, k, v, causal=kw["causal"], window=kw["window"])
        attn32.append(_close(torch, out, want32, TOL[cfg.dtype], TOL[cfg.dtype]))
        return out

    def checked_scan(a, b, h0):
        out = patch.rg_ops.linear_scan(a, b, h0)
        scan_errs.append(_close(torch, out, rg_ref.linear_scan_plain(a, b, h0),
                                SCAN_ATOL, SCAN_RTOL))
        return out

    def plain_attention(q, k, v, **kw):
        return fa_ref.attention_plain(q, k, v, causal=kw["causal"], window=kw["window"])

    kinds = tfm.layer_kinds(cfg)
    got = patch.prefill(model, params, batch, checked_attention, checked_scan)
    for name, errs, kind, plain in (("flash", attn_errs, "attn", "plain in float64"),
                                    ("linear_scan", scan_errs, "rec", "plain")):
        n = kinds.count(kind)
        if not n:
            continue
        log(f"[model] {cfg.name} prompt of {len(prompt)} tokens, per layer {name} kernel vs "
            f"{plain} on the layer's own inputs: max_abs_err={max(e for e, _ in errs)!r} "
            f"layers={len(errs)} ok={sum(ok for _, ok in errs)}")
        if len(errs) != n or not all(ok for _, ok in errs):
            raise AssertionError(f"{name} disagrees with its plain version inside the model: {errs}")
    if attn32:
        log(f"[model] {cfg.name} per layer flash kernel vs plain in float32 (not held): "
            f"max_abs_err={max(e for e, _ in attn32)!r} layers={len(attn32)} "
            f"ok={sum(ok for _, ok in attn32)}")

    def all_plain(m, p):
        return patch.prefill(m, p, batch, None, rg_ref.linear_scan_plain)

    xla_cfg = cfg.replace(attn_impl="xla")
    want = all_plain(build_model(xla_cfg, device=device), params)
    control = patch.prefill(model, params, batch, plain_attention, rg_ref.linear_scan_plain)
    free = _logit_diff(cfg, got, want)
    ctrl = _logit_diff(cfg, control, want)
    log(f"[model] {cfg.name} {cfg.n_layers} layers bf16, last-token logits (not held): kernels vs "
        f"all-plain max_abs_diff={free[0]!r} same_argmax={free[2]}; control, plain versions vs "
        f"all-plain max_abs_diff={ctrl[0]!r} same_argmax={ctrl[2]}; max|logit| {free[1]!r}")

    n = MODEL_CHECK_LAYERS[cfg.name]
    small = build_model(cfg.replace(n_layers=n, dtype="float32"), device=device)
    # the first layers' parameters: each scanned group of the cut model takes
    # the first repetitions of the full model's group of the same name
    reps = {name: seg.n_rep for seg in small.segments for name in tfm.param_names(seg)}
    cut = _cast({k: v[: reps[k]] if k in reps else v for k, v in params.items()
                 if k in reps or isinstance(v, torch.Tensor)}, torch.float32)
    got = patch.prefill(small, cut, batch)
    want = all_plain(build_model(xla_cfg.replace(n_layers=n, dtype="float32"), device=device), cut)
    diff, scale, same = _logit_diff(cfg, got, want)
    tol = MODEL_TOL_FRAC * scale
    log(f"[model] {cfg.name} first {n} layers in float32, last-token logits kernels vs all-plain: "
        f"max_abs_diff={diff!r} tol={tol!r} (= {MODEL_TOL_FRAC} x max|logit| {scale!r}) "
        f"same_argmax={same}")
    if not (diff <= tol and same):
        raise AssertionError(f"{cfg.name}: kernels and plain versions disagree inside the model: "
                             f"{diff} > {tol} or another argmax")


def phase_ssm_model_check(torch, cfg, served, device, ssd_ref) -> None:
    """The SSD kernel inside mamba2-130m, on the longest served prompt, same
    weights.

    1. Every layer of the full-depth bf16 ``prefill``: the kernel's output on
       that layer's own (xc, dac, bc, cc) against its plain version (held,
       float32: the intra term runs in float32 in a bf16 model).
    2. The full-depth bf16 ``prefill`` with the kernel against the same model
       with the plain version (printed, not held: bf16 rounds the layers'
       outputs, so the two drift apart by bf16 ulps).
    3. The same at full depth with the weights cast to float32: last-token
       logits held within ``SSM_MODEL_TOL_FRAC`` of their range, same
       argmax."""
    from types import SimpleNamespace

    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.registry import build_model

    model, params, prompt = served["model"], served["params"], served["prompt"]
    batch = {"tokens": prompt[None]}
    kernel = ssm_mod.ssd_ops
    errs = []

    def run(m, p, intra):
        ssm_mod.ssd_ops = SimpleNamespace(ssd_intra=intra)
        try:
            return m.prefill(p, batch)[0]
        finally:
            ssm_mod.ssd_ops = kernel

    def checked(xc, dac, bc, cc):
        out = kernel.ssd_intra(xc, dac, bc, cc)
        errs.append(_close(torch, out, ssd_ref.ssd_intra_plain(xc, dac, bc, cc), SSD_ATOL, SSD_RTOL))
        return out

    got = run(model, params, checked)
    log(f"[model] {cfg.name} prompt of {len(prompt)} tokens, per layer ssd_intra kernel vs plain "
        f"on the layer's own inputs: max_abs_err={max(e for e, _ in errs)!r} layers={len(errs)} "
        f"ok={sum(ok for _, ok in errs)}")
    if len(errs) != cfg.n_layers or not all(ok for _, ok in errs):
        raise AssertionError(f"ssd_intra disagrees with its plain version inside the model: {errs}")

    want = run(model, params, ssd_ref.ssd_intra_plain)
    free = _logit_diff(cfg, got, want)
    log(f"[model] {cfg.name} {cfg.n_layers} layers bf16, last-token logits (not held): kernel vs "
        f"plain max_abs_diff={free[0]!r} same_argmax={free[2]} max|logit| {free[1]!r}")

    m32 = build_model(cfg.replace(dtype="float32"), device=device)
    p32 = _cast(params, torch.float32)
    got = run(m32, p32, kernel.ssd_intra)
    want = run(m32, p32, ssd_ref.ssd_intra_plain)
    diff, scale, same = _logit_diff(cfg, got, want)
    tol = SSM_MODEL_TOL_FRAC * scale
    log(f"[model] {cfg.name} {cfg.n_layers} layers in float32, last-token logits kernel vs plain: "
        f"max_abs_diff={diff!r} tol={tol!r} (= {SSM_MODEL_TOL_FRAC} x max|logit| {scale!r}) "
        f"same_argmax={same}")
    if not (diff <= tol and same):
        raise AssertionError(f"{cfg.name}: kernel and plain version disagree inside the model: "
                             f"{diff} > {tol} or another argmax")


def _entry(name, source, replaces, launches, r) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "cold_ms": r.get("cold_ms"), "device_ms": r.get("device_ms"),
            "device_cold_ms": r.get("device_cold_ms"), "tflops": r["tflops"],
            "ms_over_bound": r["ms_over_bound"], "shape": list(r["shape"])}


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
    from repro_torch.kernels.rglru_scan import ops as rg_ops, ref as rg_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref

    # float32 products in full float32 (the RG-LRU gates, the SSD chunk
    # states, the float32 checks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build(_build)
    rg_lens = rg_prompt_lengths(np)
    flash = phase_flash(torch, fa_ops, fa_ref, max(rg_lens))
    scan = phase_scan(torch, rg_ops, rg_ref, rg_lens)
    mcfg = get_config("mamba2_130m")
    assert (mcfg.n_layers, mcfg.d_model, mcfg.vocab, mcfg.ssm_state, mcfg.d_inner,
            mcfg.ssm_head_dim, mcfg.ssm_heads, mcfg.ssm_chunk, mcfg.conv_width, mcfg.dtype) == (
        24, 768, 50280, 128, 1536, 64, 24, M2_CHUNK, 4, "bfloat16"), mcfg
    m2_lens = m2_prompt_lengths(np)
    assert max(m2_lens) == 2000 and any(s < M2_CHUNK for s in m2_lens)
    assert any(s % M2_CHUNK == 0 for s in m2_lens)
    ssd = phase_ssd(torch, ssd_ops, ssd_ref, mcfg, m2_lens)
    log(f"[time] kernels checked at {time.perf_counter() - t0:.1f}s")

    gcfg = get_config("granite_3_8b")
    assert (gcfg.n_layers, gcfg.d_model, gcfg.n_heads, gcfg.n_kv, gcfg.d_ff, gcfg.vocab,
            gcfg.dtype) == (40, 4096, 32, 8, 12800, 49155, "bfloat16"), gcfg
    served = phase_serve(torch, np, {"flash": fa_ops.flash_attention}, gcfg, "cuda",
                         batching=True, lengths=(64, 1000), cache_len=1024)
    _check_launches(gcfg, served, {"flash": gcfg.n_layers})
    phase_model_check(torch, gcfg, served, "cuda", fa_ref, rg_ref)
    granite_flash = served["launches"]["flash"]
    del served
    torch.cuda.empty_cache()
    log(f"[time] granite-3-8b done at {time.perf_counter() - t0:.1f}s")

    rcfg = get_config("recurrentgemma_2b")
    assert (rcfg.n_layers, rcfg.d_model, rcfg.n_heads, rcfg.n_kv, rcfg.hd, rcfg.d_ff, rcfg.vocab,
            rcfg.lru_width, rcfg.window, rcfg.dtype) == (
        26, 2560, 10, 1, 256, 7680, 256000, 2560, RG_WINDOW, "bfloat16"), rcfg
    assert sum(n > RG_WINDOW for n in rg_lens) >= RG_LONG
    served = phase_serve(torch, np, {"flash": fa_ops.flash_attention, "linear_scan": rg_ops.linear_scan},
                         rcfg, "cuda", batching=False, lengths=rg_lens, cache_len=4096)
    kinds = [k for k in rcfg.blocks]
    _check_launches(rcfg, served, {"linear_scan": kinds.count("rec"), "flash": kinds.count("attn")})
    phase_model_check(torch, rcfg, served, "cuda", fa_ref, rg_ref)
    rg_launches = served["launches"]
    del served
    torch.cuda.empty_cache()
    log(f"[time] recurrentgemma-2b done at {time.perf_counter() - t0:.1f}s")

    served = phase_serve(torch, np, {"ssd_intra": ssd_ops.ssd_intra}, mcfg, "cuda",
                         batching=False, lengths=m2_lens, cache_len=2048)
    _check_launches(mcfg, served, {"ssd_intra": mcfg.n_layers})
    phase_ssm_model_check(torch, mcfg, served, "cuda", ssd_ref)
    m2_launches = served["launches"]
    del served
    log(f"[done] {time.perf_counter() - t0:.1f}s")

    fa_src = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu"
    fa_rep = "src/repro/kernels/flash_attention/kernel.py:38"
    kernels = [
        _entry("flash_attention_fwd", fa_src, fa_rep, granite_flash, flash["granite-3-8b"]),
        _entry("flash_attention_fwd@recurrentgemma-2b", fa_src, fa_rep,
               rg_launches["flash"], flash["recurrentgemma-2b"]),
        _entry("linear_scan", "src/repro_torch/kernels/rglru_scan/csrc/linear_scan.cu",
               "src/repro/kernels/rglru_scan/kernel.py:31", rg_launches["linear_scan"], scan),
        _entry("ssd_intra", "src/repro_torch/kernels/ssd_scan/csrc/ssd_intra.cu",
               "src/repro/kernels/ssd_scan/kernel.py:24", m2_launches["ssd_intra"], ssd),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
