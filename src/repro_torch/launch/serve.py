"""Serving launcher (port of ``repro.launch.serve``): the continuous-
batching engine on one card.

Batch mode (lockstep generate):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --batch 4 --prompt-len 32 --new-tokens 32 --quant w8a8_nibble

Request-level workloads (per-slot positions, slot refill, per-request
latency), optionally over the paged KV cache and with a priority mix:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --workload staggered --requests 16 --stagger-ms 50 \\
        --cache-mode paged --page-size 8 --priority-mix 0.25

Overcommitted pool (incremental page allocation and evict-and-resume
preemption; ``--num-pages`` may sit below the sum of worst cases):

    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --arch yi-6b --workload bursty --cache-mode paged \\
        --page-size 16 --alloc-mode incremental --num-pages 19 \\
        --prompt-len 128 --new-tokens 64 --requests 16 \\
        --quant w8a8_nibble

Shared system prompts through the prefix cache, and host swap-resume on
an overcommitted pool:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload bursty --cache-mode paged --page-size 16 \
        --alloc-mode incremental --num-pages 19 --prompt-len 128 \
        --new-tokens 64 --requests 16 --prefix-cache --shared-prefix 0.75 \
        --swap-mode host

Self-speculative decoding (the nibble draft, a dense verifier), and the
wave prefill (chunked prefill with grouped admission):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload uniform --cache-mode paged --page-size 16 \
        --alloc-mode incremental --spec-decode --spec-k 4 \
        --spec-quant w8a8_nibble
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload bursty --cache-mode paged --page-size 16 \
        --prefill-chunk 32 --admit-group 4

Data parallelism (``--dp`` engine replicas behind one admission router,
sharing the card and the weights), the capacity model's prediction next
to the measurement (``--predict``), and the knob search over the capacity
model (``--autotune``, no model run; the counterpart of the reference's
``tools/autotune.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload bursty --requests 16 --cache-mode paged \
        --page-size 16 --prefix-cache --shared-prefix 0.75 --dp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload uniform --cache-mode paged --page-size 16 --predict
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --workload uniform --autotune max-tok-s --ttft-slo-ms 100

``--temperature 0.7`` samples (any workload, also with ``--spec-decode``)
under the reference's index-derived keys; ``--verify`` needs greedy
streams.  On the card the decode chunk (the draft and the verify under
``--spec-decode``) replays from CUDA graphs.

``--arch`` takes gemma3-1b, gemma-7b, qwen3-4b, yi-6b, mamba2-780m,
phi-3-vision-4.2b, whisper-base, deepseek-v3-671b,
llama4-maverick-400b-a17b and jamba-v0.1-52b (a mamba model prefills at
the exact prompt length, so ``--prompt-len`` is then a prompt-length
bound, not a pad; phi-3-vision and whisper are served text-only, without
patches or frames, as the reference serves them).  ``--reduced`` (the
default) runs the arch's smoke-scale variant, ``--full`` its published
widths and depth; weights are random, from seed 0.  It runs on the CUDA
device, every projection through the CUDA kernels
(``--quant-backend cuda``) and attention through the flash and paged
kernels, unless ``--device cpu`` is given: there the same wrappers run
their plain versions, and ``--quant-backend torch`` is allowed too.  The
warm-up (which builds the kernels on first use) is timed apart from the
steady state.  The flags of tensor parallelism (``--tp``, ``--mesh``), not
ported yet, stay in the parser and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import model_init
from repro_torch.serve import Engine, Router, ServeConfig, \
    run_timed_workload

# flag -> (default, where ROADMAP.md places the work that ports it)
_UNPORTED_FLAGS = {
    "tp": (1, "queue 1 item 4, tensor parallelism on torch.distributed"),
    "mesh": (None, "queue 1 item 4, tensor parallelism on "
                   "torch.distributed"),
}


def _check_ported(args) -> None:
    for name, (default, item) in _UNPORTED_FLAGS.items():
        if getattr(args, name) != default:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag}={getattr(args, name)!r} is not ported yet "
                f"(ROADMAP {item})")
    if args.device != "cpu" and args.quant_backend != "cuda":
        raise SystemExit("--quant-backend torch runs the plain PyTorch "
                         "formulas; on the card the launcher serves "
                         "through the CUDA kernels (use --device cpu)")


def _config(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return cfg.replace(quant_mode=args.quant, attn_impl="flash")


def _build(args, reference=False):
    """Build the engine (a ``Router`` of ``--dp`` replicas when above 1)
    for ``args``; ``reference=True`` builds the baseline of ``--verify``
    from the same flags: one engine, with every tail-latency mechanism off
    (monolithic prefill, serialized admission, replay-only resume), as the
    reference's launcher does."""
    cfg = _config(args)
    params = model_init(cfg, seed=0, device=args.device)
    max_len = args.prompt_len + args.new_tokens
    if args.cache_mode == "paged":
        # the paged pool is page-granular; round the budget up
        max_len += (-max_len) % args.page_size
    scfg = ServeConfig(batch=args.batch,
                       max_len=max_len,
                       temperature=args.temperature,
                       prefill_len=args.prompt_len,
                       decode_chunk=args.decode_chunk,
                       priority_aging_s=args.priority_aging_s,
                       alloc_mode=args.alloc_mode,
                       quant_backend=args.quant_backend,
                       cache_mode=args.cache_mode,
                       page_size=args.page_size,
                       num_pages=args.num_pages or None,
                       prefix_cache=args.prefix_cache,
                       prefix_cache_pages=args.prefix_cache_pages,
                       spec_decode=args.spec_decode,
                       spec_k=args.spec_k,
                       spec_quant_mode=args.spec_quant,
                       prefill_chunk=0 if reference else args.prefill_chunk,
                       admit_group=1 if reference else args.admit_group,
                       swap_mode="off" if reference else args.swap_mode,
                       host_pages=args.host_pages)
    if args.dp > 1 and not reference:
        return cfg, params, Router(cfg, params, scfg, replicas=args.dp,
                                   device=args.device)
    return cfg, params, Engine(cfg, params, scfg, device=args.device)


def run_batch(args, cfg, engine):
    """Lockstep generate: every slot starts and stops together.  The
    prompts come from a ``torch.Generator`` seeded 1 (the reference draws
    them from a JAX key, which no other framework reproduces)."""
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen)
    t0 = time.perf_counter()
    engine.generate(prompts, min(args.new_tokens, 2))
    t_compile = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new_tokens)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"arch={cfg.name} quant={args.quant} backend={args.quant_backend} "
          f"device={engine.device} workload=batch")
    print(f"  compile+warmup: {t_compile:.2f}s   "
          f"(compilations: {engine.compile_counts}, CUDA graphs: "
          f"{engine.capture_counts})")
    print(f"  steady-state:   {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, batch={args.batch})")
    print("  sample token ids:", out[0, -16:].tolist())


def _run_workload(args, cfg, engine, collect_streams=False):
    stagger = args.stagger_ms / 1000.0 \
        if args.workload in ("staggered", "bursty") else 0.0
    return run_timed_workload(engine, cfg.vocab_size,
                              requests=args.requests,
                              prompt_budget=args.prompt_len,
                              new_tokens=args.new_tokens, stagger_s=stagger,
                              priority_mix=args.priority_mix,
                              shared_prefix=args.shared_prefix,
                              arrival_mode="bursty"
                              if args.workload == "bursty" else "uniform",
                              collect_streams=collect_streams)


def _check_leaks(args, engine):
    """Every page, device and host, must be back once the prefix index
    lets go."""
    if args.cache_mode != "paged":
        return
    engine.release_prefix_cache()
    leaked = engine.leaked_pages()
    if leaked:
        raise SystemExit(f"page leak: {leaked} page(s) still booked "
                         f"after drain + prefix-cache release")


def _verify(args, cfg, r):
    """Re-run the identical workload on a reference build and demand
    token-for-token equality (greedy streams).  The reference's baseline
    is one engine with every tail-latency mechanism off (the prefix cache
    stays, as in the reference).  Dense only when ``--dp > 1``: w8a8
    activation scales span the batch, and placement changes which
    requests share a decode chunk."""
    if args.temperature > 0:
        raise SystemExit("--verify needs greedy streams "
                         "(--temperature 0)")
    if args.dp > 1 and args.quant != "dense":
        raise SystemExit("--verify with --dp > 1 needs --quant dense: "
                         "batched activation quantization is batch-"
                         "composition-dependent, so placement changes "
                         "quantized streams")
    cfg_ref, _, ref = _build(args, reference=True)
    ref_r = _run_workload(args, cfg_ref, ref, collect_streams=True)
    _check_leaks(args, ref)
    if r["streams"] != ref_r["streams"]:
        bad = [i for i in r["streams"]
               if r["streams"][i] != ref_r["streams"][i]]
        raise SystemExit(f"verify FAILED: {len(bad)}/{len(r['streams'])} "
                         f"stream(s) diverge from the reference build "
                         f"(request ids {bad[:8]})")
    print(f"  verify: {len(r['streams'])} streams bit-match the "
          f"reference build")


def _workload_shape(args):
    from repro_torch.capacity import WorkloadShape
    stagger = args.stagger_ms / 1000.0 \
        if args.workload in ("staggered", "bursty") else 0.0
    return WorkloadShape(requests=args.requests,
                         prompt_budget=args.prompt_len,
                         new_tokens=args.new_tokens, stagger_s=stagger,
                         priority_mix=args.priority_mix,
                         shared_prefix=args.shared_prefix,
                         arrival_mode="bursty"
                         if args.workload == "bursty" else "uniform")


def _predict(args, engine, r):
    """Calibrate the engine and print the capacity model's prediction
    for the workload just measured, beside the measurement."""
    if args.dp > 1:
        print("  capacity model: (skipped: it covers one engine; a --dp "
              "fleet carries no prediction)")
        return None
    from repro_torch.capacity import Knobs, predict
    from repro_torch.capacity.calibrate import calibrate_engine
    costs = calibrate_engine(engine)
    p = predict(Knobs.from_engine(engine), _workload_shape(args), costs,
                cache_token_bytes=int(engine.cache_token_bytes),
                acceptance=(r["acceptance_rate"]
                            if args.spec_decode else None))
    if not p["feasible"] or "tok_per_s" not in p:
        print(f"  capacity model: infeasible: {p['infeasible_reason']}")
        return p
    err = 100.0 * abs(p["tok_per_s"] - r["tok_per_s"]) \
        / max(r["tok_per_s"], 1e-9)
    print(f"  capacity model: predicted {p['tok_per_s']:.1f} tok/s "
          f"(measured {r['tok_per_s']:.1f}, {err:.0f}% off), "
          f"ttft p50={p['ttft_p50_ms']:.0f}ms "
          f"p99={p['ttft_p99_ms']:.0f}ms, "
          f"preemptions {p['preemptions']}, "
          f"cache {p['cache_kb_per_req']:.1f} KiB/req")
    return p


def run_autotune(args):
    """``--autotune``: the knob-grid search over the capacity model for
    this invocation's workload shape (H100 peak rates); prints the
    prediction table and the winning ServeConfig kwargs.  No model run."""
    import json

    from repro_torch.capacity.tune import knob_grid, search, table_lines
    if args.workload == "batch":
        raise SystemExit("--autotune plans request workloads "
                         "(uniform/staggered/bursty), not batch mode")
    cfg = _config(args)
    shape = _workload_shape(args)
    max_len = args.prompt_len + args.new_tokens
    max_len += (-max_len) % args.page_size
    cells = knob_grid(shape, batch=args.batch, max_len=max_len,
                      prefill_len=args.prompt_len)
    results, winner = search(cfg, shape, cells, objective=args.autotune,
                             ttft_slo_ms=args.ttft_slo_ms, alpha=0.8)
    print(f"# autotune: {len(cells)} cells, objective={args.autotune}"
          + (f", ttft_slo={args.ttft_slo_ms}ms"
             if args.ttft_slo_ms else ""))
    for line in table_lines(results, winner):
        print(line)
    if winner is None:
        print("# no admissible configuration")
        return 1
    print("# winning ServeConfig kwargs:")
    print(json.dumps(winner["knobs"].to_dict(), indent=1))
    return 0


def run_requests(args, cfg, engine):
    """Request-level workload: ``uniform`` submits everything at t=0,
    ``staggered`` spaces arrivals by --stagger-ms, ``bursty`` clusters
    Poisson bursts at the same mean load with Pareto heavy-tail prompt
    lengths (slots refill mid-stream in all three)."""
    r = _run_workload(args, cfg, engine, collect_streams=args.verify)
    _check_leaks(args, engine)
    print(f"arch={cfg.name} quant={args.quant} backend={args.quant_backend} "
          f"cache={args.cache_mode} workload={args.workload} "
          f"requests={args.requests} slots={args.batch}")
    print(f"  topology: {r['device_count']} device(s) ({engine.device}), "
          f"per-engine mesh {tuple(r['mesh_shape'])}, "
          f"dp_replicas={r['dp_replicas']}")
    print(f"  compile+warmup: {r['compile_s']:.2f}s   "
          f"(compilations: {r['compile_counts']}, CUDA graphs: "
          f"{engine.capture_counts})")
    print(f"  steady-state:   {r['tokens']} tokens in {r['wall_s']:.2f}s "
          f"({r['tok_per_s']:.1f} tok/s)")
    print(f"  request latency p50={r['req_p50_ms']:.0f}ms "
          f"p99={r['req_p99_ms']:.0f}ms   "
          f"ttft p50={r['ttft_p50_ms']:.0f}ms "
          f"p99={r['ttft_p99_ms']:.0f}ms   "
          f"itl p50={r['itl_p50_ms']:.1f}ms p99={r['itl_p99_ms']:.1f}ms")
    print(f"  cache HBM/request: {r['cache_kb_per_req']:.1f} KiB")
    if args.spec_decode:
        print(f"  spec decode: k={args.spec_k} "
              f"draft={args.spec_quant or args.quant} "
              f"acceptance={r['acceptance_rate']:.0%} "
              f"tokens/step={r['tokens_per_step']:.2f} "
              f"rollback_pages={r['spec_rollback_pages']}")
    if args.cache_mode == "paged":
        print(f"  pool: {r['pool_pages']} pages, mean occupancy "
              f"{r['occupancy']:.0%}, mean concurrency "
              f"{r['concurrency']:.2f}, preemptions {r['preemptions']}")
    if args.prefix_cache:
        print(f"  prefix cache: hit rate {r['prefix_hit_rate']:.0%} of "
              f"prompt tokens, {r['prefill_tokens']} tokens prefilled")
    if args.prefill_chunk or args.admit_group > 1:
        print(f"  wave prefill: {r['prefill_waves']} waves "
              f"(chunk={args.prefill_chunk or args.prompt_len} "
              f"group={args.admit_group}), "
              f"{r['decode_chunks']} decode chunks")
    if args.swap_mode == "host":
        print(f"  host swap: {r['swap_out']} out / {r['swap_in']} in, "
              f"{r['replay_steps_saved']} replay steps saved, "
              f"{r['prefix_cold_hits']} cold prefix pages promoted")
    for pr in r.get("per_replica", ()):
        print(f"  replica {pr['replica']}: {pr['placed']} placed, "
              f"affinity hit rate {pr['affinity_hit_rate']:.0%}, "
              f"prefix hit rate {pr['prefix_hit_rate']:.0%}, "
              f"preemptions {pr['preemptions']}")
    if r["truncated"]:
        print(f"  WARNING: {r['truncated']} request(s) truncated at the "
              f"max_len budget")
    if "hi_req_p50_ms" in r:
        hi, lo = r["hi_req_p50_ms"], r["lo_req_p50_ms"]
        hi_s = "n/a (no hi requests)" if hi is None else f"p50={hi:.0f}ms"
        lo_s = "n/a (no lo requests)" if lo is None else f"p50={lo:.0f}ms"
        print(f"  priority split:  hi {hi_s}  lo {lo_s}")
    if args.predict:
        r["prediction"] = _predict(args, engine, r)
    if args.verify:
        _verify(args, cfg, r)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the arch's smoke-scale variant (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the arch's published widths and depth")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slot count")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="slot prompt budget (requests pad up to this)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples from logits / "
                         "temperature (index-derived keys, base seed 0)")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="decode steps per decode chunk")
    ap.add_argument("--workload", default="batch",
                    choices=["batch", "uniform", "staggered", "bursty"],
                    help="batch = lockstep generate; uniform/staggered/"
                         "bursty = request queue with slot refill "
                         "(bursty clusters Poisson-burst arrivals with "
                         "Pareto heavy-tail prompt lengths)")
    ap.add_argument("--requests", type=int, default=8,
                    help="request count for queued workloads")
    ap.add_argument("--stagger-ms", type=float, default=50.0,
                    help="arrival spacing for the staggered workload; "
                         "mean inter-arrival for bursty")
    ap.add_argument("--quant", default="dense",
                    choices=["dense", "w8a8_nibble", "w4a8_nibble", "lut"])
    ap.add_argument("--quant-backend", default="cuda",
                    choices=["torch", "cuda"],
                    help="cuda = the hand-written kernels (their plain "
                         "versions on CPU tensors); torch = the plain "
                         "PyTorch formulas (--device cpu only)")
    ap.add_argument("--cache-mode", default="dense",
                    choices=["dense", "paged"],
                    help="paged = shared page pools + page-table "
                         "indirection (cache memory scales with live "
                         "tokens)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (paged cache mode)")
    ap.add_argument("--alloc-mode", default="reserve",
                    choices=["reserve", "incremental"],
                    help="reserve = book worst-case pages at admission; "
                         "incremental = book live-token pages per decode "
                         "chunk with evict-and-resume preemption "
                         "(allows an overcommitted --num-pages)")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV pool size in pages, trash page included (0 = "
                         "parity with the dense slab); set below the "
                         "worst-case sum to overcommit with --alloc-mode "
                         "incremental")
    ap.add_argument("--shared-prefix", type=float, default=0.0,
                    help="fraction of workload requests that begin with "
                         "one fixed system-prompt head of prompt-len/2 "
                         "tokens")
    ap.add_argument("--priority-mix", type=float, default=0.0,
                    help="fraction of workload requests submitted at "
                         "priority 1 (rest 0); reports per-class latency")
    ap.add_argument("--priority-aging-s", type=float, default=1.0,
                    help="queue-wait seconds per +1 effective priority "
                         "(anti-starvation aging; 0 = strict priorities)")
    ap.add_argument("--verify", action="store_true",
                    help="re-run the workload on the reference build and "
                         "require token-for-token stream equality")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share read-only prompt-prefix pages across "
                         "requests (paged cache; COW on a fully covered "
                         "prompt)")
    ap.add_argument("--prefix-cache-pages", type=int, default=0,
                    help="cap on pages the prefix index may pin (LRU "
                         "reclaim; demotes to the host tier with "
                         "--swap-mode host); 0 = uncapped")
    ap.add_argument("--swap-mode", default="off", choices=["off", "host"],
                    help="host = evicted requests' KV pages go to a host "
                         "pool and come back by copy (resume without "
                         "replay); also the prefix cache's cold tier")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host pool pages for --swap-mode host (0 = twice "
                         "the device pool)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="self-speculative decoding: the --spec-quant "
                         "datapath drafts, the dense one verifies (greedy "
                         "streams equal the dense engine's)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculation round")
    ap.add_argument("--spec-quant", default=None,
                    choices=["dense", "qat", "w8a8_nibble", "w4a8_nibble",
                             "lut"],
                    help="the draft's quant mode (default: --quant)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: prompt tokens per wave chunk "
                         "(paged cache; 0 = monolithic prefill)")
    ap.add_argument("--admit-group", type=int, default=1,
                    help="grouped admission: prefilling requests one wave "
                         "advances together (paged cache)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel engine replicas behind one "
                         "admission router (least-loaded placement with "
                         "priority ordering and prefix-cache affinity), "
                         "sharing the device and the weights")
    ap.add_argument("--predict", action="store_true",
                    help="after the measured run, calibrate the engine's "
                         "per-dispatch stage costs and print the capacity "
                         "model's prediction for the same workload beside "
                         "the measurement (one engine; skipped at --dp > 1)")
    ap.add_argument("--autotune", default=None, metavar="OBJECTIVE",
                    choices=["max-tok-s", "min-pages"],
                    help="skip the run: search the serving knob grid with "
                         "the capacity model for this workload shape and "
                         "print the winning ServeConfig (max-tok-s under "
                         "--ttft-slo-ms, or min-pages at zero predicted "
                         "preemptions)")
    ap.add_argument("--ttft-slo-ms", type=float, default=None,
                    help="p99 TTFT SLO an --autotune max-tok-s winner must "
                         "meet")
    # the reference's flags of tensor parallelism, not ported yet: kept so
    # that a command line written for the reference fails loudly
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)

    _check_ported(args)
    if args.workload == "batch" and args.dp > 1:
        raise SystemExit("--dp applies to request workloads "
                         "(uniform/staggered/bursty), not batch mode")
    if args.autotune:
        return run_autotune(args)
    cfg, _, engine = _build(args)
    if args.workload == "batch":
        run_batch(args, cfg, engine)
    else:
        run_requests(args, cfg, engine)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
