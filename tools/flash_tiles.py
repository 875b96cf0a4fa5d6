#!/usr/bin/env python3
"""Tile shapes of the bf16 flash-attention kernel, compared on one CUDA card.

    python3 tools/flash_tiles.py [substring ...]

Run from the root of a checkout on a machine with a CUDA card.  Each
variant is the kernel source
(``src/repro_torch/kernels/flash_attention/csrc/flash_attention_fwd.cu``)
with the hd-128 or hd-256 instance of ``dispatch_bf16`` replaced by another
(head dim padded, warps a block, kv rows a tile, blocks an SM), another
unroll depth of the Q K^T loop, or P fed to the PV product in one bf16
part instead of hi + lo (what the lo part costs, and what it buys).  All variants are built at
once (one ``nvcc`` each, into ``build/tiles/``), then each is checked
against the plain version and timed at granite-3-8b's prefill shape (B 8,
S 1024, 32/8 heads, hd 128, causal) and recurrentgemma-2b's (B 1, S 2915,
10/1 heads, hd 256, window 2048), all in bf16, in two passes in opposite
orders.  Each line gives the variant's registers and spill stores per bf16
instance (``ptxas -v``) and its median time of 30 CUDA-event timings.

The check against the plain version is held on inputs of unit scale.  At
the models' scale (q, k, v entries of std 11.3, 22.6, 22.6 for granite and
16, 50.6, 50.6 for recurrentgemma, as the reference's init rule gives them:
near one-hot rows) each line also counts the outputs outside the bf16
tolerance, not held, since some variants are there to show what fails; the
first pass also counts them for the float32 CUDA-core instance run on the
same inputs in float32 and rounded to bf16.  The same count is taken on the
models' own attention inputs: every attention layer's q, k, v in the bf16
prefill of random prompts (granite-3-8b: one of 910 tokens;
recurrentgemma-2b: three of 2915, 24 layers in all) at full width with the
weights of ``chip_smoke.py`` (seed 0), as ``chip_smoke.py``'s model check
holds them.

Each count is taken against the plain version in float32 (the reference of
``chip_smoke.py``'s model check before the bf16 kernel moved to the tensor
cores) and in float64 (its reference now).  On those layer inputs it also counts how far float32
computations of the same function stand from each other and from float64:
the plain version, the plain version with the Q K^T sum taken in 16-deep
steps (the order of the tensor-core kernel), and the float32 CUDA-core
instance.

With arguments, only the variants whose names contain one of them run
(and the committed source always).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tiles"
H128 = "launch_bf16<128, 4, 32, 3>("
H256 = "launch_bf16<256, 4, 32, 2>("
UNROLL = "constexpr int KS_UNROLL = HDP > 128 ? 4 : HDP / 16;"
S_SUMS = "constexpr bool S_STEP_SUMS = HDP > 128;"
P_DECL = "      float pr[NT][4], alpha[2];\n"
KV_OFF = "  const int64_t kv_off = ((int64_t)b * Skv * hkv + kh) * hd;\n"
QROW = "  const uint32_t q_row = sQ + (uint32_t)((warp * 16 + a_row) * HDP * 2);\n"
LO_MMAS = """          mma_bf16(acc[2 * nd], lo, bv[0], bv[1]);
          mma_bf16(acc[2 * nd + 1], lo, bv[2], bv[3]);
"""
# name -> substitutions in the source
VARIANTS = {
    "as committed": [],
    "hd128 8 warps BK 64, 1 block/SM": [(H128, "launch_bf16<128, 8, 64, 1>(")],
    "hd128 8 warps BK 64, 2 blocks/SM": [(H128, "launch_bf16<128, 8, 64, 2>(")],
    "hd128 8 warps BK 32, 2 blocks/SM": [(H128, "launch_bf16<128, 8, 32, 2>(")],
    "hd128 4 warps BK 64, 2 blocks/SM": [(H128, "launch_bf16<128, 4, 64, 2>(")],
    "hd128 4 warps BK 48, 3 blocks/SM": [(H128, "launch_bf16<128, 4, 48, 3>(")],
    "hd128 4 warps BK 32, 4 blocks/SM": [(H128, "launch_bf16<128, 4, 32, 4>(")],
    "hd256 4 warps BK 16, 2 blocks/SM": [(H256, "launch_bf16<256, 4, 16, 2>(")],
    "hd256 Q K^T fully unrolled": [(UNROLL, "constexpr int KS_UNROLL = HDP / 16;")],
    # P rounded once to bf16: the PV product's cost without the lo part
    # (outside the bf16 tolerance at the models' scale, so not an option)
    "P in one bf16 part": [(LO_MMAS, "")],
    # how Q K^T sums its 16-deep steps (see S_STEP_SUMS in the source)
    "S steps chained at every hd": [(S_SUMS, "constexpr bool S_STEP_SUMS = false;")],
    "S steps added in float32 at every hd": [(S_SUMS, "constexpr bool S_STEP_SUMS = true;")],
    # register pressure: P written over S
    "P over S": [(P_DECL, "      float alpha[2];\n      auto& pr = s;\n")],
    # K/V row pointers kept in registers across the loop
    "K/V bases in registers": [(KV_OFF, KV_OFF + "  const bf16* kg = k + kv_off;\n"
                                "  const bf16* vg = v + kv_off;\n"),
                               ("(it + 1) & 1) * STAGE, k + kv_off, kv_rs,",
                                "(it + 1) & 1) * STAGE, kg, kv_rs,"),
                               ("(it + 1) & 1) * STAGE, v + kv_off, kv_rs,",
                                "(it + 1) & 1) * STAGE, vg, kv_rs,")],
    # K's lane offsets from Q's (one XOR a use) instead of 4 registers
    "K offsets from Q's": [(QROW, QROW + "  const uint32_t xab = oa[0] ^ ob[0];\n"),
                           ("(k4 << 5) + ob[c]);", "(k4 << 5) + (oa[c] ^ xab));")],
    "hd128 Q K^T unrolled 4": [(UNROLL, "constexpr int KS_UNROLL = 4;")],
}
CASES = {
    "granite": (8, 1024, 1024, 32, 8, 128, True, 0),
    "recurrentgemma": (1, 2915, 2915, 10, 1, 256, True, 2048),
}
MODEL_STD = {"granite": (11.3, 22.6, 22.6), "recurrentgemma": (16.0, 50.6, 50.6)}
TOL = 3e-2


def build(name: str, src: str, nvcc: list[str]):
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"flash_tiles: {old!r} not in the source; update VARIANTS")
        src = src.replace(old, new)
    stem = OUT / re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")
    stem.with_suffix(".cu").write_text(src)
    so = stem.with_suffix(".so")
    r = subprocess.run([*nvcc, "-o", str(so), str(stem.with_suffix(".cu"))],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"flash_tiles: nvcc failed for {name}:\n{r.stdout}{r.stderr}")
    return so, r.stdout + r.stderr


def layer_inputs(torch, np, name: str, length: int, seed: int) -> list:
    """(q, k, v, causal, window, plain output in float32, the same in float64
    held as float32) of every attention layer in the bf16 prefill of one
    random prompt of ``length`` tokens drawn with ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ref
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model

    cfg = get_config(name)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab, length).astype(np.int32)
    captured, attention = [], tfm.attention

    def capture(q, k, v, **kw):
        want = ref.attention_plain(q, k, v, causal=kw["causal"], window=kw["window"])
        exact = ref.attention_plain(q.double(), k.double(), v.double(), causal=kw["causal"],
                                    window=kw["window"]).float()
        captured.append((q.contiguous(), k.contiguous(), v.contiguous(), kw["causal"],
                         kw["window"], want, exact))
        return want

    tfm.attention = capture
    try:
        with torch.no_grad():
            model.prefill(params, {"tokens": prompt[None]})
    finally:
        tfm.attention = attention
    del model, params
    torch.cuda.empty_cache()
    return captured


def plain_chunked(torch, q, k, v, causal, window):
    """The plain version with each score summed over hd in 16-deep steps."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float()
    kf = k.float().repeat_interleave(h // hkv, dim=2)
    vf = v.float().repeat_interleave(h // hkv, dim=2)
    s = sum(torch.einsum("bqhd,bkhd->bhqk", qf[..., c : c + 16], kf[..., c : c + 16])
            for c in range(0, hd, 16)) / hd**0.5
    i = torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(skv, device=q.device)[None, :]
    live = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        live &= j <= i
    if window > 0:
        live &= i - j < window
    s = torch.where(live, s, torch.full((), -1e30, device=q.device))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vf).to(q.dtype)


def describe(torch, q, k, causal, window, got, want, limit=4):
    """Print the rows (b, i, h) holding outputs outside the tolerance of
    ``want``, with each row's two highest scaled scores in float64 and their
    gap."""
    diff = (got.float() - want.float()).abs()
    bad = diff > TOL + TOL * want.float().abs()
    rows = sorted({(int(b), int(i), int(h)) for b, i, h, _ in bad.nonzero().tolist()})
    h_kv = q.shape[2] // k.shape[2]
    for b, i, h in rows[:limit]:
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else k.shape[1]
        s = (k[b, lo:hi, h // h_kv].double() @ q[b, i, h].double()) / q.shape[-1] ** 0.5
        top = torch.topk(s, min(2, s.numel()))
        gap = float(top.values[0] - top.values[-1])
        n_bad = int(bad[b, i, h].sum())
        print(f"[tiles]   row b {b} i {i} h {h}: {n_bad} outputs outside, top keys "
              f"{[lo + int(x) for x in top.indices]} scores {top.values.tolist()} gap {gap!r}",
              flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_tiles: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import bf16_instances, median_ms
    from repro_torch import _build
    from repro_torch.kernels.flash_attention import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    pick = sys.argv[1:]
    for name in [n for n in VARIANTS if n != "as committed"]:
        if pick and not any(p in name for p in pick):
            del VARIANTS[name]
    src = _build.KERNELS["flash_attention_fwd"][0].read_text()
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(lambda n: build(n, src, nvcc), VARIANTS)))
    print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.1f}s", flush=True)

    gen = torch.Generator("cuda").manual_seed(1)
    inputs, scaled = {}, {}
    for key, (b, sq, skv, h, hkv, hd, causal, window) in CASES.items():
        for dst, std in ((inputs, (1.0, 1.0, 1.0)), (scaled, MODEL_STD[key])):
            q, k, v = (x * torch.randn(b, s, n, hd, generator=gen, device="cuda").bfloat16()
                       for x, s, n in zip(std, (sq, skv, skv), (h, hkv, hkv)))
            dst[key] = (q, k, v, ref.attention_plain(q, k, v, causal=causal, window=window))

    def outside(got, want):
        diff = (got.float() - want.float()).abs()
        return int((diff > TOL + TOL * want.float().abs()).sum()), float(diff.max())

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    layers = {"granite": layer_inputs(torch, np, "granite_3_8b", 910, 0),
              "recurrentgemma": sum((layer_inputs(torch, np, "recurrentgemma_2b", 2915, seed)
                                     for seed in range(3)), [])}

    def on_layers(fn, dtype):
        """Per model: layers with every output inside tol, outputs outside tol
        and max abs error of ``fn`` on each layer's own inputs against the
        float32 plain version; outputs outside tol against float64."""
        out = []
        for key, caps in layers.items():
            good, n_out, err, n64 = 0, 0, 0.0, 0
            for q, k, v, causal, window, want, exact in caps:
                b, sq, h, hd = q.shape
                skv, hkv = k.shape[1], k.shape[2]
                q, k, v = (x.to(dtype) for x in (q, k, v))
                o = torch.empty_like(q)
                if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      int(dtype == torch.bfloat16), b, sq, skv, h, h // hkv, hd, int(causal),
                      window, sq, skv, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("launch failed")
                torch.cuda.synchronize()
                n, e = outside(o.bfloat16(), want)
                good, n_out, err = good + (n == 0), n_out + n, max(err, e)
                n64 += outside(o.bfloat16(), exact)[0]
            out.append(f"{key} layers {good}/{len(caps)} inside tol, {n_out} outputs outside "
                       f"(max_abs_err {err!r}), against float64 {n64} outside")
        return "; ".join(out)

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(built["as committed"][0])).flash_attention_fwd
    fn.argtypes, fn.restype = [P] * 4 + [I] * 11 + [P], I
    line = []
    for key, (b, sq, skv, h, hkv, hd, causal, window) in CASES.items():
        q, k, v, want = (x.float() for x in scaled[key])
        o = torch.empty_like(q)
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0, b, sq, skv, h, h // hkv,
           hd, int(causal), window, sq, skv, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        n_out, err = outside(o.bfloat16(), want)
        line.append(f"{key} at model scale {n_out} outside tol (max_abs_err {err!r})")
    print(f"[tiles] float32 CUDA-core instance: {', '.join(line)}; on the models' layer "
          f"inputs: {on_layers(fn, torch.float32)}", flush=True)
    for key, caps in layers.items():
        counts = {"float32 plain vs float64": 0, "chunked float32 plain vs float64": 0,
                  "chunked float32 plain vs float32 plain": 0,
                  "float32 CUDA-core instance vs float64": 0, "bf16 kernel vs float64": 0}
        for q, k, v, causal, window, want, exact in caps:
            b, sq, h, hd = q.shape
            skv, hkv = k.shape[1], k.shape[2]
            counts["float32 plain vs float64"] += outside(want, exact)[0]
            chunked = plain_chunked(torch, q, k, v, causal, window)
            counts["chunked float32 plain vs float64"] += outside(chunked, exact)[0]
            counts["chunked float32 plain vs float32 plain"] += outside(chunked, want)[0]
            for dtype, name in ((torch.float32, "float32 CUDA-core instance vs float64"),
                                (torch.bfloat16, "bf16 kernel vs float64")):
                qq, kk, vv = (x.to(dtype) for x in (q, k, v))
                o = torch.empty_like(qq)
                fn(qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(),
                   int(dtype == torch.bfloat16), b, sq, skv, h, h // hkv, hd, int(causal),
                   window, sq, skv, torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                counts[name] += outside(o.bfloat16(), exact)[0]
                if dtype == torch.bfloat16:
                    describe(torch, q, k, causal, window, o.bfloat16(), want)
        print(f"[tiles] {key} layer inputs, outputs outside the bf16 tolerance: "
              + ", ".join(f"{n} {c}" for n, c in counts.items()), flush=True)
    first = list(built)
    for order in (first, first[::-1]):
        for name in order:
            so, log = built[name]
            fn = ctypes.CDLL(str(so)).flash_attention_fwd
            fn.argtypes, fn.restype = [P] * 4 + [I] * 11 + [P], I
            line = []
            for key, (b, sq, skv, h, hkv, hd, causal, window) in CASES.items():
                q, k, v, want = inputs[key]
                o = torch.empty_like(q)
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, b, sq,
                             skv, h, h // hkv, hd, int(causal), window, sq, skv, stream)
                    if err:
                        raise RuntimeError(f"{name}: launch failed ({err})")

                call()
                torch.cuda.synchronize()
                diff = (o.float() - want.float()).abs()
                if not bool((diff <= 3e-2 + 3e-2 * want.float().abs()).all()):
                    raise AssertionError(f"{name} disagrees with the plain version at {key}")
                ms = median_ms(torch, call, reps=30)
                q, k, v, want = scaled[key]
                call()
                torch.cuda.synchronize()
                n_out, err = outside(o, want)
                line.append(f"{key} {ms!r} ms (max_abs_err {float(diff.max())!r}; at model "
                            f"scale {n_out} outside tol, max_abs_err {err!r})")
            insts = "; ".join(f"{a} registers {r} spill stores {s} bytes"
                              for a, r, s in bf16_instances(log))
            models = on_layers(fn, torch.bfloat16) if order is first else "(first pass)"
            print(f"[tiles] {name}: {', '.join(line)}; {insts}; on the models' layer inputs: "
                  f"{models}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
