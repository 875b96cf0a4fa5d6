"""The RG-LRU scan and SSD intra-chunk kernels against their plain versions on the card,
prefix-KV reuse (continuation prefill, the engine's store) on the card, and
NUMA placement with derived homes on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA device.
The file imports neither JAX nor the JAX package, so the card's machine,
which has no JAX, collects it:

    python -m pytest -q -m cuda tests/test_torch_cuda.py tests/test_torch_flash_attention.py

Inputs come from numpy with a seed.  Tolerances, float32:
  * the scan: atol 1e-5, rtol 1e-4, as tests/test_torch_rglru.py holds the
    plain version against the reference (within a 32-step run the kernel
    walks the plain version's recurrence with a fused FMA; the carry into
    the run is the same product of the steps before it, associated in runs
    of 32 and 256 steps);
  * the SSD intra-chunk term: atol 1e-3, rtol 1e-4.  The two sum over N and
    L in other orders, and cum = cumsum(dA) reaches about -100 to -200 over
    a 128-step chunk with dA in [-1.6, 0], where one ulp (~1e-5) moves a
    decay factor by ~1e-5 relative; the plain version in float32 against
    float64 at mamba2-130m's shape (a CPU run) is off by up to 5.7e-4 on
    outputs up to ~200;
  * continuation prefill on the card against the same call on the CPU
    (reduced granite, float32): atol and rtol 1e-4.  The seeded prefixes come
    from each device's own prefill, the flash kernel's float32 instance on
    the card and the plain version on the CPU, and the products sum in other
    orders on the two devices (~1e-6 relative), which the two layers carry
    to about 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.core.topology import pod  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import linear_scan, linear_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_intra, ssd_intra_plain  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models.common import ParamBuilder  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving import CNAScheduler, DecodeEngine, Request  # noqa: E402
from repro_torch.serving.batching import PrefillBatcher  # noqa: E402
from repro_torch.serving.kvcache import SlotCache, _tensors  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
SCAN_SHAPES = [  # (B, S, W): ragged S and W; the last is recurrentgemma-2b's longest prefill
    (1, 37, 50),
    (2, 300, 130),
    (3, 1, 7),
    (1, 257, 129),
    (1, 3000, 2560),
]
# linear_scan.cu: a block owns 32 channels x 256 steps (a chunk of S), and
# chunks pass carries along S; shapes at its edges: S = 1, one step under,
# at and past a chunk, many chunks, B > 1, W not a multiple of 32
SCAN_CHUNK, SCAN_TILE = 256, 32
SCAN_EDGES = [
    (1, 1, 2560),
    (1, SCAN_CHUNK - 1, SCAN_TILE),
    (1, SCAN_CHUNK, SCAN_TILE),
    (1, SCAN_CHUNK + 1, SCAN_TILE),
    (2, 12 * SCAN_CHUNK + 3, 100),
    (3, 2 * SCAN_CHUNK + 1, 2561),
    (4, 1000, SCAN_TILE + 1),
]


SSD_ATOL, SSD_RTOL = 1e-3, 1e-4
SSD_SHAPES = [  # (B, nc, L, H, P, N): mamba2-130m's longest prompt (2000 -> 16 x 128),
    (1, 16, 128, 24, 64, 128),  # a prompt under one chunk, then ragged L, P, N
    (1, 1, 77, 24, 64, 128),
    (2, 3, 100, 5, 80, 40),
    (3, 2, 1, 3, 16, 200),
]
# ssd_intra.cu: 16-row strips and 8-column tiles of the (L, L) scores, P in
# passes of 64; L at 1, one strip, one past it and a whole chunk; P and N
# not multiples of 8
SSD_EDGES = [
    (1, 2, 1, 3, 64, 128),
    (1, 2, 16, 4, 64, 128),
    (2, 2, 17, 3, 64, 128),
    (1, 3, 128, 5, 64, 128),
    (1, 2, 128, 3, 20, 36),
    (2, 2, 17, 2, 13, 11),
    (1, 1, 100, 2, 130, 203),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _scan_inputs(shape, device, seed=0):
    b, s, w = shape
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.999, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w), dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32)
    return [torch.from_numpy(t).to(device) for t in (a, bb, h0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=[str(s) for s in SCAN_SHAPES])
def test_scan_kernel_matches_plain_on_card(shape, cuda_device):
    a, b, h0 = _scan_inputs(shape, cuda_device)
    before = linear_scan.launches
    got = linear_scan(a, b, h0)
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    want = linear_scan_plain(a, b, h0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_EDGES, ids=[str(s) for s in SCAN_EDGES])
def test_scan_kernel_at_chunk_edges_on_card(shape, cuda_device):
    a, b, h0 = _scan_inputs(shape, cuda_device, seed=5)
    got = linear_scan(a, b, h0)
    torch.cuda.synchronize()
    want = linear_scan_plain(a, b, h0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.cuda
def test_scan_kernel_near_zero_and_one_on_card(cuda_device):
    """a near 0 (a chunk's product underflows), and near 1 with the RG-LRU's
    input sqrt(1 - a^2) * x, across several chunks, against the plain
    version; a near 1 with x unscaled, where h walks to ~10^2 and no float32
    order holds the tolerance of the exact answer (the plain walk neither;
    tests/test_torch_scan_numerics.py), against float64 within the rounding
    of a chunk's 256-factor product of a, 256 * 2^-24 * max|h|."""
    _, x, h0 = _scan_inputs((2, 3 * SCAN_CHUNK + 5, 130), cuda_device, seed=6)
    rng = np.random.default_rng(6)
    for lo, hi, scale in ((0.0, 1e-3, False), (0.9999, 1.0, True), (0.9999, 1.0, False)):
        a = torch.from_numpy(rng.uniform(lo, hi, x.shape).astype(np.float32)).to(cuda_device)
        b = torch.sqrt(1.0 - a.double() ** 2).float() * x if scale else x
        got = linear_scan(a, b, h0).cpu().numpy()
        if lo == 0.0 or scale:
            want = linear_scan_plain(a, b, h0).cpu().numpy()
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
            continue
        exact, h = np.empty(got.shape), h0.double().cpu().numpy()
        an, bn = a.double().cpu().numpy(), b.double().cpu().numpy()
        for t in range(got.shape[1]):
            h = an[:, t] * h + bn[:, t]
            exact[:, t] = h
        np.testing.assert_allclose(got, exact, atol=SCAN_CHUNK * 2.0 ** -24 * np.abs(exact).max(),
                                   rtol=RTOL)


@pytest.mark.cuda
def test_scan_kernel_repeats_bitwise_on_card(cuda_device):
    """20 calls at recurrentgemma-2b's longest prefill give the same bits:
    a carry is folded in chunk order whichever chunk the look-back stops at,
    so the order in which blocks publish does not show."""
    a, b, h0 = _scan_inputs((1, 2915, 2560), cuda_device, seed=7)
    first = linear_scan(a, b, h0)
    for _ in range(19):
        assert torch.equal(linear_scan(a, b, h0), first)


@pytest.mark.cuda
def test_rglru_scan_launches_the_kernel_on_card(cuda_device):
    """The model's ``rglru_scan`` on a CUDA tensor goes through the kernel,
    once per call, and returns y in the input's dtype and h_last float32."""
    w = 64
    rng = np.random.default_rng(1)
    params = {n: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * 0.1).to(cuda_device)
              for n, s in (("wa", (w, w)), ("wi", (w, w)), ("ba", (w,)), ("bi", (w,)), ("lam", (w,)))}
    xc = torch.from_numpy(rng.standard_normal((2, 50, w), dtype=np.float32)).to(cuda_device)
    before = linear_scan.launches
    y, h_last = rglru.rglru_scan(params, xc.bfloat16())
    torch.cuda.synchronize()
    assert linear_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    assert bool(torch.isfinite(h_last).all())


def _ssd_inputs(shape, device, seed=0):
    """xc contiguous; dac a permuted view and bc/cc slices of one wider
    tensor, as ``ssm.ssd_chunked`` passes them (the kernel reads strides)."""
    b, nc, l, h, p, n = shape
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((b, nc, l, h, p), dtype=np.float32)
    da = rng.uniform(-1.6, 0.0, (b, nc, l, h)).astype(np.float32)
    bcc = rng.standard_normal((b, nc, l, 2 * n + 3), dtype=np.float32)
    xc, da, bcc = (torch.from_numpy(t).to(device) for t in (xc, da, bcc))
    return xc, da.permute(0, 3, 1, 2), bcc[..., :n], bcc[..., n : 2 * n]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=[str(s) for s in SSD_SHAPES])
def test_ssd_intra_kernel_matches_plain_on_card(shape, cuda_device):
    xc, dac, bc, cc = _ssd_inputs(shape, cuda_device)
    assert not dac.is_contiguous() and not bc.is_contiguous()
    before = ssd_intra.launches
    got = ssd_intra(xc, dac, bc, cc)
    torch.cuda.synchronize()
    assert ssd_intra.launches == before + 1
    want = ssd_intra_plain(xc, dac, bc, cc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("contiguous", [False, True], ids=["views", "contiguous"])
@pytest.mark.parametrize("shape", SSD_EDGES, ids=[str(s) for s in SSD_EDGES])
def test_ssd_intra_kernel_at_tile_edges_on_card(shape, contiguous, cuda_device):
    """The permuted dac and sliced bc/cc views of the model (16-byte copies
    of B and C ruled out by their odd row stride), and contiguous copies
    (16-byte copies where N allows)."""
    xc, dac, bc, cc = _ssd_inputs(shape, cuda_device, seed=8)
    if contiguous:
        dac, bc, cc = dac.contiguous(), bc.contiguous(), cc.contiguous()
    got = ssd_intra(xc, dac, bc, cc)
    torch.cuda.synchronize()
    want = ssd_intra_plain(xc, dac, bc, cc)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)


@pytest.mark.cuda
def test_ssd_block_launches_the_kernel_on_card(cuda_device):
    """The model's ``ssd_block`` on a CUDA tensor goes through the kernel,
    once per call, and agrees with the same block on the CPU (the plain
    version) in float32."""
    cfg = get_reduced_config("mamba2_130m").replace(dtype="float32")
    pb = ParamBuilder(dtype=torch.float32)
    ssm.declare_ssd(pb, "ssd", cfg)
    params = pb.init(torch.Generator().manual_seed(0), "cpu")["ssd"]
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 45, cfg.d_model),
                                                                  dtype=np.float32))
    want, (ws, _) = ssm.ssd_block(params, x, cfg)
    before = ssd_intra.launches
    got, (gs, _) = ssm.ssd_block({k: v.to(cuda_device) for k, v in params.items()},
                                 x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert ssd_intra.launches == before + 1
    assert gs.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)
    np.testing.assert_allclose(gs.cpu().numpy(), ws.numpy(), atol=SSD_ATOL, rtol=SSD_RTOL)


CONT_TOL = 1e-4
CONT_CACHE_LEN = 64


def _granite(device):
    """Reduced granite in float32 with the same weights on ``device``."""
    cfg = get_reduced_config("granite_3_8b").replace(dtype="float32")
    params = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, list):
            return [move(v) for v in node]
        return node.to(device)

    return cfg, build_model(cfg, device=device), move(params)


@pytest.mark.cuda
def test_prefill_cont_on_card_matches_cpu(cuda_device):
    """Seeded rows extended by ragged suffixes (one row without a suffix):
    logits of the rows with a suffix, every KV leaf and ``pos`` on the card
    against the CPU; no flash launch in the continuation."""
    rng = np.random.default_rng(3)
    vocab = get_reduced_config("granite_3_8b").vocab
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in (30, 9, 40, 7)]
    splits = (12, 1, 33, 7)
    out = []
    for device in (torch.device("cpu"), cuda_device):
        cfg, model, params = _granite(device)
        slots = SlotCache.zeros(model, 4, CONT_CACHE_LEN)
        rows = [slots.fit_single(model.prefill(params, {"tokens": p[:m][None]})[1])
                for p, m in zip(prompts, splits)]
        batcher = PrefillBatcher(model, cache_len=CONT_CACHE_LEN, pack_width=4)
        before = fa_ops.flash_attention.launches
        logits, cache = batcher.continue_rows(params, rows, [p[m:] for p, m in zip(prompts, splits)])
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert fa_ops.flash_attention.launches == before
        out.append((logits.cpu(), [t.cpu() for t in _tensors(cache)], cache["pos"].cpu()))
    (cl, ct, cp), (gl, gt, gp) = out
    assert torch.equal(cp, gp) and cp.tolist() == [30, 9, 40, 7]
    np.testing.assert_allclose(gl[:3].numpy(), cl[:3].numpy(), atol=CONT_TOL, rtol=CONT_TOL)
    for g, c in zip(gt, ct):
        np.testing.assert_allclose(g.numpy(), c.numpy(), atol=CONT_TOL, rtol=CONT_TOL)


@pytest.mark.cuda
def test_prefix_kv_engine_on_card(cuda_device):
    """A batched prefix-KV engine on the card, shared-prefix traffic with
    repeats and follow-ups: every fresh pack launches the flash kernel once
    a layer and the continuation packs launch none; every entry stored
    after the first wave is bitwise unchanged after the second."""
    cfg, model, params = _granite(cuda_device)
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab, 12).astype(np.int32)
    first = [Request(rid=i, prompt=np.concatenate([system, rng.integers(0, cfg.vocab, 3 + i)]).astype(np.int32),
                     max_new=4, domain=i % 2) for i in range(4)]
    first += [Request(rid=4 + i, prompt=first[i].prompt.copy(), max_new=4) for i in range(2)]
    before = fa_ops.flash_attention.launches
    eng = DecodeEngine(model, params, n_slots=4, cache_len=CONT_CACHE_LEN, prefix_kv=True,
                       batching=True, scheduler=CNAScheduler())
    eng.run(first)
    snap = [(cache, [t.clone() for t in _tensors(cache)], logits, logits.clone())
            for cache, logits in eng.prefix_kv._lru.values()]
    follow = [Request(rid=10 + i, prompt=np.concatenate(
        [r.prompt, np.asarray(r.out, np.int32), rng.integers(0, cfg.vocab, 5).astype(np.int32)]),
        max_new=4) for i, r in enumerate(first[:3])]
    eng.run(follow)
    torch.cuda.synchronize()
    assert all(len(r.out) == 4 for r in first + follow)
    assert eng.batcher.cont.calls > len(eng.batcher.buckets)  # continuation packs served
    assert fa_ops.flash_attention.launches - before == cfg.n_layers * eng.batcher.packed.calls
    assert eng.reused_positions > 0 and eng.kv_deposits == len(first) + len(follow)
    for cache, ts, logits, lg in snap:
        assert all(torch.equal(a, b) for a, b in zip(_tensors(cache), ts)) and torch.equal(logits, lg)


@pytest.mark.cuda
def test_placement_slot_cache_on_card(cuda_device):
    """A placement-aware ``SlotCache`` over CUDA tensors: claims land in
    their home pools or spill as on the CPU, an inserted lane holds its
    prefill, and a release zeroes the slot's ``pos`` on the card and returns
    the slot to its domain's pool."""
    out = []
    for device in (torch.device("cpu"), cuda_device):
        cfg, model, params = _granite(device)
        slots = SlotCache.zeros(model, 4, 32, topology=pod(2, 2))
        _, single = model.prefill(params, {"tokens": np.arange(5, dtype=np.int32)[None] % cfg.vocab})
        seen = []
        for owner, home in enumerate((1, 1, 3, 0)):
            slot = slots.claim(owner, home)
            slots.insert(slot, single)
            seen.append((slot, slots.last_domain, slots.last_distance, slots.last_migration_cycles))
        assert slots.cache["pos"].device.type == device.type
        assert slots.cache["pos"].tolist() == [5, 5, 5, 5] and slots.n_free == 0
        slots.release(seen[1][0])
        assert slots.cache["pos"].tolist()[seen[1][0]] == 0
        assert slots.free == [seen[1][0]] and slots.slot_domain(seen[1][0]) == seen[1][1]
        tel = slots.telemetry
        out.append((seen, tel.placements, tel.local_placements, tel.spills, tel.releases,
                    tel.migration_cycles, dict(tel.per_domain_occupancy)))
    assert out[0] == out[1]


@pytest.mark.cuda
def test_derived_homes_engine_on_card(cuda_device, capsys):
    """``serve.py --derived-homes`` on the card prints what it prints on the
    CPU (every number but the wall time), and a placement + index + store
    engine on the card makes the CPU's decisions: no decision reads a
    number the model computes."""
    from repro_torch.launch import serve

    lines = []
    for device in ("cpu", "cuda"):
        assert serve.main(["--device", device, "--derived-homes", "--scheduler", "cna"]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        lines.append([f for f in line.split() if not f.startswith(("wall=", "device="))])
    assert lines[0] == lines[1] and any(f.startswith("derived=24") for f in lines[1])

    seen = []
    for device in (torch.device("cpu"), cuda_device):
        cfg, model, params = _granite(device)
        eng = DecodeEngine(model, params, n_slots=4, cache_len=CONT_CACHE_LEN, batching=True,
                           scheduler=CNAScheduler(topology=pod(2, 2)), placement="nearest_spill",
                           prefix_index=True, prefix_kv=True)
        rng = np.random.default_rng(9)
        shared = [rng.integers(0, cfg.vocab, 10).astype(np.int32) for _ in range(2)]
        for wave in range(2):
            eng.run([Request(rid=10 * wave + i, prompt=np.concatenate(
                [shared[i % 2], rng.integers(0, cfg.vocab, 3).astype(np.int32)]),
                max_new=3, domain=None) for i in range(6)])
        tel = eng.slots.telemetry
        seen.append((eng.sim_time, eng.prefill_positions, eng.reused_positions, eng.kv_deposits,
                     eng.prefix_kv.hits, eng.compile_counts, tel.placements, tel.spills,
                     tel.migration_cycles, tel.derived_homes, tel.prefix_hit_tokens, tel.sheds))
    assert seen[0] == seen[1] and seen[1][9] == 12 and seen[1][10] > 0
