"""Serving driver: continuous batching with the CNA admission scheduler.

PyTorch counterpart of ``repro.launch.serve`` (its default run path,
``--derived-homes`` and ``--arrivals``), with ``--device`` added:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 32 --domains 2 --scheduler cna
    PYTHONPATH=src python -m repro_torch.launch.serve --arrivals 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch recurrentgemma-2b --no-batching
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-130m --no-batching
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --derived-homes

The default path prints per-policy throughput/locality/fairness on the
reduced config of ``--arch`` (granite-3-8b, recurrentgemma-2b or
mamba2-130m) with the per-request engine; ``--arrivals RATE`` drives a
Poisson arrival process against the bucketed/packed engine
(``--no-batching``: the per-request one, which recurrentgemma and mamba2
need) and prints tokens/s and TTFT p50/p99 (wall clock, so on a card only
after ``torch.cuda.synchronize``).  ``--derived-homes`` submits
``domain=None`` over shared prefixes with unique tails, derives homes from
the prefix index over a placement-aware slot cache (``pod(1, domains)``,
``nearest_spill``) in two waves, and prints the derived homes, the prefix
hit rate and the placement locality.  ``--replicas``, ``--regions``,
``--paged``, ``--trace`` and ``--metrics`` wait for the slices that port
their layers.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import arch_module, get_reduced_config
from repro_torch.core.topology import pod
from repro_torch.models.common import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import DecodeEngine, Request
from repro_torch.serving.scheduler import CNAScheduler, FIFOScheduler


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _model(args):
    device = resolve_device(args.device)
    cfg = get_reduced_config(arch_module(args.arch))
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(args.seed))
    return cfg, model, params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--domains", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--scheduler", default="both", choices=["cna", "fifo", "both"])
    ap.add_argument("--fairness-threshold", type=lambda x: int(x, 0), default=0xF)
    ap.add_argument("--switch-cost", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--derived-homes", action="store_true",
                    help="submit domain=None and derive homes from the prefix "
                         "index over a placement-aware slot cache")
    ap.add_argument("--arrivals", type=float, default=None, metavar="RATE",
                    help="drive a continuous Poisson arrival process at RATE "
                         "requests/tick (mixed prompt lengths) and print "
                         "tokens/sec + TTFT p50/p99")
    ap.add_argument("--no-batching", action="store_true",
                    help="with --arrivals: use the per-request prefill engine "
                         "instead of the bucketed/packed batched one")
    args = ap.parse_args(argv)

    if args.arrivals is not None:
        return serve_arrivals(args)

    cfg, model, params = _model(args)
    rng = np.random.default_rng(args.seed)
    if args.derived_homes:
        # a small pool of shared prefixes + unique tails: the index has
        # prefixes to re-match
        n_shared = max(2, args.prompt_len // 2)
        shared = [rng.integers(0, cfg.vocab, n_shared).astype(np.int32)
                  for _ in range(max(2, args.domains))]
        base = [
            Request(rid=i,
                    prompt=np.concatenate([
                        shared[int(rng.integers(0, len(shared)))],
                        rng.integers(0, cfg.vocab, args.prompt_len - n_shared).astype(np.int32),
                    ]),
                    max_new=args.max_new, domain=None)
            for i in range(args.requests)
        ]
    else:
        base = [
            Request(rid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                    max_new=args.max_new, domain=int(rng.integers(0, args.domains)))
            for i in range(args.requests)
        ]

    def engine_kwargs(mk_sched):
        if not args.derived_homes:
            return dict(scheduler=mk_sched())
        return dict(scheduler=mk_sched(topology=pod(1, args.domains)),
                    placement="nearest_spill", prefix_index=True)

    policies = {"cna": lambda **kw: CNAScheduler(fairness_threshold=args.fairness_threshold, **kw),
                "fifo": lambda **kw: FIFOScheduler(**kw)}
    run = [args.scheduler] if args.scheduler != "both" else ["cna", "fifo"]
    for name in run:
        reqs = [Request(r.rid, r.prompt, r.max_new, r.domain) for r in base]
        eng = DecodeEngine(model, params, n_slots=args.slots, cache_len=args.cache_len,
                           domain_switch_cost=args.switch_cost, **engine_kwargs(policies[name]))
        t0 = time.time()
        if args.derived_homes:
            mid = len(reqs) // 2
            eng.run(reqs[:mid])  # first wave warms the index from placements
            eng.run(reqs[mid:])  # second wave homes by matched prefixes
        else:
            eng.run(reqs)
        _sync(model.device)
        wall = time.time() - t0
        m = eng.scheduler.metrics
        tokens = sum(len(r.out) for r in reqs)
        extra = ""
        if eng.prefix_index is not None:
            tel = eng.slots.telemetry
            extra = (f" derived={tel.derived_homes} "
                     f"prefix_hit_rate={tel.prefix_hit_rate:.2f} "
                     f"placement_locality={tel.locality:.2f}")
        print(f"[{name}] requests={len(reqs)} tokens={tokens} sim_time={eng.sim_time} "
              f"locality={m.locality:.2f} switches={m.domain_switches} "
              f"fairness={m.fairness_factor():.3f} wall={wall:.1f}s "
              f"tok_per_simtick={tokens / max(1, eng.sim_time):.2f}{extra} "
              f"device={model.device}")
    return 0


def serve_arrivals(args) -> int:
    """A continuous Poisson arrival process against the batched engine,
    wall-clock measured.  TTFT is submit-to-first-token including queueing."""
    cfg, model, params = _model(args)
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(2, args.cache_len - 1, args.requests)
    reqs = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(l)).astype(np.int32),
                max_new=args.max_new, domain=int(rng.integers(0, args.domains)))
        for i, l in enumerate(lens)
    ]
    arrivals = np.floor(
        np.cumsum(rng.exponential(1.0 / args.arrivals, args.requests))
    ).astype(int).tolist()

    batched = not args.no_batching
    t_build = time.time()
    eng = DecodeEngine(model, params, n_slots=args.slots, cache_len=args.cache_len,
                       scheduler=CNAScheduler(fairness_threshold=args.fairness_threshold),
                       domain_switch_cost=args.switch_cost, batching=batched)
    _sync(model.device)
    warm = time.time() - t_build  # every bucket runs once in here, not below

    submit_at, ttft = {}, {}
    i = tick = 0
    t0 = time.time()
    while i < len(reqs) or len(eng.scheduler) or eng.active_req:
        while i < len(reqs) and arrivals[i] <= tick:
            submit_at[reqs[i].rid] = time.time()
            eng.submit(reqs[i])
            i += 1
        eng.step()  # ends in a host read of the tick's tokens
        for r in reqs:
            if r.rid not in ttft and r.out:
                ttft[r.rid] = time.time() - submit_at[r.rid]
        tick += 1
    _sync(model.device)
    wall = time.time() - t0

    tokens = sum(len(r.out) for r in reqs)
    waits = np.array([ttft[r.rid] for r in reqs])
    cc = eng.compile_counts
    traces = cc["prefill"] + cc.get("packed_prefill", 0) + cc.get("cont_prefill", 0)
    mode = "batched" if batched else "per-request"
    print(f"[arrivals {mode}] rate={args.arrivals}/tick requests={len(reqs)} "
          f"tokens={tokens} tokens_per_sec={tokens / wall:.1f} "
          f"ttft_p50={np.percentile(waits, 50) * 1e3:.0f}ms "
          f"ttft_p99={np.percentile(waits, 99) * 1e3:.0f}ms "
          f"prefill_shapes={traces} decode_shapes={cc['decode']} "
          f"warmup={warm:.1f}s wall={wall:.1f}s device={model.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
