"""Smoke run of the torch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths on the card -- the online-Cori paged serving
loop and the paper's offline Cori pipeline -- and checks every kernel they
run against the kernel's plain PyTorch version.  Phases (each prints its
own lines and its seconds; any failure raises and the script exits
non-zero):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: ``nvcc`` compiles the three kernels for sm_90a from
     ``src/repro_torch/kernels/csrc``, one process per source, all at once
     (each -Xptxas -v report is printed);
  3. kernel vs plain version on the card: the main-path shape and a GQA /
     window / softcap grid, float32 and bfloat16, with stated tolerances
     and each active row's mass summing to 1;
  4. full-width qwen3-14b (all 40 layers, float32 weights from a seeded
     init) served by the macro-step ``ContinuousBatcher`` over
     ``SharedPagedPools`` + ``TieringManager`` + ``OnlineTuner``: 8
     requests until drained.  The kernel's launch count must equal
     40 x the decode steps run;
  5. parity on the card: on a reduced GQA config, the batcher's greedy
     streams (macro and per-token) equal ``generate``'s (dense attention,
     no kernel);
  6. kernel timing at the main-path shape (CUDA events, L2 flushed
     between launches) beside its plain version, a library yardstick and
     the bandwidth bound;
  7. the offline path's kernels vs their plain versions on the card:
     ``page_hist`` over an alpha/threshold grid with -1 padding, odd
     footprints and out-of-range ids (bit-equal); ``bin_trace`` of all
     nine full-size traces (array-equal to numpy's bincount); ``sim_scan``
     bit-equal to ``sim_scan_plain`` on full-size backprop's exhaustive
     candidate stack (its largest group and its longest candidate) and on
     a tie-heavy 20-page toy, both schedulers (and the toy against the
     numpy oracle ``simulate_reference``);
  8. the paper's pipeline at full size: ``study`` and
     ``baseline_trials_all`` for backprop, lud and kmeans under both
     schedulers, held to the bars of tests/test_claims.py, with the
     kernels' launch counts (one ``page_hist`` per study, one ``sim_scan``
     per ``simulate`` and per candidate chunk of each ``sweep``);
  9. timing of the offline kernels at the main-path shapes: ``page_hist``
     at backprop's ``bin_trace`` shape and ``sim_scan`` over backprop's
     whole exhaustive sweep, beside their plain versions, a library
     yardstick where one exists and their bounds.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 without tensor
# cores (the kernel's arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SEED = 0
DEV = torch.device("cuda")


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def phase_device() -> str:
    print("== phase 1: device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices "
          f"{torch.cuda.device_count()}", flush=True)
    return smi.splitlines()[0]


def phase_build(build, kernels) -> None:
    """Build every kernel's library at once (one nvcc per source)."""
    print("== phase 2: build", flush=True)
    t0 = time.monotonic()
    libs = build.build_many([(k.NAME, k.NVCC_FLAGS) for k in kernels])
    print(f"built {len(libs)} kernels in {time.monotonic() - t0:.1f} s",
          flush=True)
    for k, lib in zip(kernels, libs):
        print(f"-- {lib.name} (nvcc {' '.join(k.NVCC_FLAGS)})", flush=True)
        print(lib.with_suffix(".log").read_text().strip(), flush=True)


def _kernel_case(pa, *, b, h, kv, d, page, n, p_phys, lengths, dtype,
                 window=0, softcap=0.0, ragged=True, seed=0):
    """Random q / pools / table on the card; returns the inputs."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((p_phys, page, kv, d), generator=g, device=dev).to(dtype)
    table = torch.randperm(p_phys, generator=g, device=dev)[: b * n] \
        .reshape(b, n).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if ragged:   # rows shorter than the table are padded with -1
        for row, length in enumerate(lengths):
            table[row, -(-length // page):] = -1
    return dict(q=q, k_pages=kp, v_pages=vp, page_table=table, lengths=ln,
                window=window, softcap=softcap)


def phase_kernel_check(pa) -> float:
    """Kernel vs plain version; returns the largest float32 error seen."""
    print("== phase 3: kernel vs plain version on the card", flush=True)
    tol = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2e-2, 1e-5)}
    main = dict(b=4, h=40, kv=8, d=128, page=16, n=64, p_phys=256,
                lengths=[1024, 777, 0, 301])
    grid = [dict(main)]
    for h, kv in ((4, 4), (8, 2), (8, 1)):
        for window, softcap in ((0, 0.0), (3, 0.0), (0, 5.0), (3, 5.0)):
            grid.append(dict(b=3, h=h, kv=kv, d=64, page=16, n=6, p_phys=32,
                             lengths=[96, 37, 5], window=window,
                             softcap=softcap))
    worst_f32 = 0.0
    for i, case in enumerate(grid):
        for dtype in (torch.float32, torch.bfloat16):
            args = _kernel_case(pa, dtype=dtype, seed=i, **case)
            out, mass = pa.paged_attention(**args)
            torch.cuda.synchronize()
            ref_o, ref_m = pa.paged_attention_plain(**args)
            err_o = float((out.float() - ref_o.float()).abs().max())
            err_m = float((mass - ref_m).abs().max())
            active = args["lengths"] > 0
            err_sum = float((mass.sum(dim=1)[active] - 1).abs().max())
            t_o, t_m = tol[dtype]
            ok = err_o <= t_o and err_m <= t_m and err_sum <= 1e-5
            print(f"case {i} {str(dtype)[6:]} H={case['h']} KV={case['kv']} "
                  f"D={case['d']} n={case['n']} "
                  f"window={case.get('window', 0)} "
                  f"softcap={case.get('softcap', 0.0)}: out err {err_o:.3g} "
                  f"(tol {t_o}), mass err {err_m:.3g} (tol {t_m}), "
                  f"|row mass sum - 1| {err_sum:.3g} (tol 1e-5) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                _fail(f"kernel disagrees with its plain version (case {i})")
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err_o, err_m)
            if not bool(torch.all(mass[~active] == 0)) \
                    or not bool(torch.all(out[~active] == 0)):
                _fail("a length-0 row must give zeros")
    return worst_f32


def _reset_counts(kernels) -> None:
    for k in kernels:
        getattr(k, k.NAME).launches = 0


def phase_serve(C, mdl, pa, S, memtier, cori, telemetry, kernels):
    print("== phase 4: full-width qwen3-14b serving (macro-step batcher)",
          flush=True)
    cfg = C.get("qwen3-14b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = mdl.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"init: {cfg.name}, {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {n_params / 1e9:.3f} B "
          f"float32 params ({cfg.param_count() / 1e9:.3f} B without norms) "
          f"in {time.monotonic() - t0:.1f} s", flush=True)

    n_logical, hbm_pages, page = 256, 128, 16
    pools = memtier.SharedPagedPools.create(n_logical, hbm_pages)
    mgr = memtier.TieringManager(n_logical, memtier.TierConfig(
        page_size=page, hbm_pages=hbm_pages, period_steps=8))
    tuner = cori.OnlineTuner(n_logical, default_period=8)
    mon = S.TrafficMonitor(pools, mgr, tuner)
    b = S.ContinuousBatcher(params, cfg, monitor=mon, max_active=4,
                            max_len=1024, page_size=page)
    pool_bytes = sum(t.numel() * t.element_size()
                     for leaves in pools.kv_layers.values() for t in leaves)
    print(f"pools: {n_logical} logical pages, {hbm_pages} HBM slots, page "
          f"{page}: {pool_bytes / 1e9:.2f} GB of float32 k/v over "
          f"{len(pools.kv_layers['k_hbm'])} slot(s) x {pools.layer_meta[0]} "
          "repeats", flush=True)

    rng = np.random.default_rng(SEED)
    reqs = []
    for i in range(8):
        plen = int(rng.integers(128, 513))
        reqs.append(S.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen).astype(
                np.int32),
            max_new_tokens=int(rng.integers(48, 97)),
            temperature=0.8 if i in (2, 5) else 0.0, seed=SEED + i))
    print("requests (prompt, new, temperature): "
          + ", ".join(f"({len(r.prompt)}, {r.max_new_tokens}, "
                      f"{r.temperature})" for r in reqs), flush=True)

    rec = telemetry.install(telemetry.Recorder())
    for r in reqs:
        b.submit(r)
    _reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = b.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = pa.paged_attention.launches

    n_tok = sum(len(v) for v in out.values())
    macros = rec.events("serve.macro")
    walls = sorted(e["wall_ms"] for e in macros)
    admits = rec.events("serve.admit")
    print(f"served {len(out)} requests, {n_tok} tokens in {wall:.2f} s: "
          f"{n_tok / wall:.2f} tokens/s end to end (prefill included)",
          flush=True)
    print(f"macros {len(macros)}, decode steps {b.decode_steps}, macro wall "
          f"p50 {float(np.median(walls)):.1f} ms (min {walls[0]:.1f}, max "
          f"{walls[-1]:.1f}), admissions {len(admits)} taking "
          f"{sum(e['wall_ms'] for e in admits) / 1e3:.2f} s", flush=True)
    print(f"tiering: migrations {mgr.migrations}, hits {mgr.hits}, misses "
          f"{mgr.misses}, modeled time {mgr.modeled_time:.0f}, pages moved "
          f"{mgr.data_moved_pages}, period {mgr.period}", flush=True)
    print(f"tuner: state {tuner.state}, period {tuner.period}, steps "
          f"{tuner.step}, retunes {tuner.retunes}, dominant reuse "
          f"{tuner.dominant_reuse}, candidates {tuner.candidates.tolist()}, "
          f"tried {tuner.tried}, history {tuner.history}", flush=True)
    print(f"macro lengths: {[e['n_steps'] for e in macros]}", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB", flush=True)
    print(f"paged_attention launches {launches} = {cfg.num_layers} layers x "
          f"{b.decode_steps} decode steps -> "
          f"{launches == cfg.num_layers * b.decode_steps}", flush=True)

    if sorted(out) != list(range(8)):
        _fail(f"not every request completed: {sorted(out)}")
    for r in reqs:
        toks = out[r.rid]
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in toks):
            _fail(f"request {r.rid}: {len(toks)} tokens, expected "
                  f"{r.max_new_tokens} in [0, {cfg.vocab_size})")
    if b.decode_steps <= 0 or launches != cfg.num_layers * b.decode_steps:
        _fail("the kernel's launches do not match 40 x the decode steps")
    if not all(math.isfinite(c) for c in tuner.cost_log):
        _fail("non-finite tuner cost")
    if pools.free_pages != n_logical:
        _fail("pages leaked after the drain")
    telemetry.install(telemetry.Recorder())
    result = dict(tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                  macro_p50_ms=float(np.median(walls)), macros=len(macros),
                  decode_steps=b.decode_steps, launches=launches)
    _profile_macro(b, S, cfg, rng)
    del b, mon, pools, params
    torch.cuda.empty_cache()
    return result


def _profile_macro(b, S, cfg, rng) -> None:
    """Where one full-width decode macro's time goes: four fresh requests
    are admitted (unprofiled step), then one decode macro runs under
    ``torch.profiler``.  Prints the macro's wall time, the device time the
    profiler attributes to kernels (busy share = device time / wall) and
    the kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(4):
        b.submit(S.Request(rid=100 + i, prompt=rng.integers(
            0, cfg.vocab_size, 256).astype(np.int32), max_new_tokens=40))
    b.step()                                   # admission + first macro
    torch.cuda.synchronize()
    steps0 = b.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        b.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    steps = b.decode_steps - steps0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {"matmul (cuBLAS)": 0.0, "paged_attention (this repo)": 0.0,
              "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = ("paged_attention (this repo)"
               if "paged_attention" in name or "page_mass" in name
               else "matmul (cuBLAS)" if "gemm" in name or "gemv" in name
               else "other")
        groups[key] += e.self_device_time_total / 1e3
    print(f"profiled decode macro: {steps} steps in {wall_ms:.1f} ms wall "
          f"({wall_ms / max(1, steps):.1f} ms/step); device time "
          f"{dev_ms:.1f} ms -> busy {dev_ms / wall_ms * 100:.1f}%, idle "
          f"{100 - dev_ms / wall_ms * 100:.1f}%"
          if dev_ms > 0 else "profiled decode macro: the profiler saw no "
          "device time (not measured)", flush=True)
    for key, ms in groups.items():
        print(f"  {key}: {ms:.1f} ms ({ms / max(1, steps):.2f} ms/step)",
              flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    b.run()


def phase_parity(C, mdl, S, memtier, cori, engine):
    print("== phase 5: parity on the card (reduced GQA config, float32)",
          flush=True)
    cfg = dataclasses.replace(C.reduced("qwen3-14b"), num_kv_heads=2,
                              segments=((("attn",), 2),), dtype="float32")
    params = mdl.init(cfg, seed=SEED)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 9, 5, 11)]
    new = (6, 4, 9, 7)
    ref = {i: engine.generate(params, cfg, p[None], steps=new[i])[0]
           .tolist() for i, p in enumerate(prompts)}
    for macro in (True, False):
        mon = S.TrafficMonitor(
            memtier.SharedPagedPools.create(48, 10),
            memtier.TieringManager(48, memtier.TierConfig(
                page_size=4, hbm_pages=10, period_steps=2)),
            cori.OnlineTuner(48, default_period=2, profile_steps=8,
                             trial_steps=4))
        b = S.ContinuousBatcher(params, cfg, monitor=mon, max_active=2,
                                max_len=32, page_size=4, macro=macro)
        for i in (0, 1):
            b.submit(S.Request(rid=i, prompt=prompts[i],
                               max_new_tokens=new[i]))
        steps = 0
        while not b.idle:
            if steps in (1, 3):
                i = 2 if steps == 1 else 3
                b.submit(S.Request(rid=i, prompt=prompts[i],
                                   max_new_tokens=new[i]))
            b.step()
            steps += 1
        got = {r.rid: r.tokens for r in b.completed}
        same = got == ref
        print(f"{'macro' if macro else 'per-token'} batcher greedy streams "
              f"== generate: {same}", flush=True)
        if not same:
            _fail(f"batcher streams {got} differ from generate {ref}")


def _time(fn, iters, flush_buf):
    """Mean ms per call over ``iters`` calls, each timed with its own CUDA
    event pair after a write that flushes the 50 MB L2."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush_buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.mean(times))


def phase_timing(pa):
    print("== phase 6: kernel timing at the main-path shape", flush=True)
    import torch.nn.functional as F
    b, h, kv, d, page, n = 4, 40, 8, 128, 16, 64
    lengths = [1024, 777, 513, 301]
    args = _kernel_case(pa, b=b, h=h, kv=kv, d=d, page=page, n=n,
                        p_phys=256, lengths=lengths, dtype=torch.float32)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    before = pa.paged_attention.launches
    ms = _time(lambda: pa.paged_attention(**args), 50, flush)
    plain_ms = _time(lambda: pa.paged_attention_plain(**args), 20, flush)
    pa.paged_attention.launches = before      # timing launches not counted

    # yardstick: one SDPA call over the same K/V, gathered beforehand
    t = n * page
    idx = args["page_table"].clamp_min(0).long()
    k = args["k_pages"][idx].reshape(b, t, kv, d).transpose(1, 2).contiguous()
    v = args["v_pages"][idx].reshape(b, t, kv, d).transpose(1, 2).contiguous()
    qs = args["q"][:, :, None, :]
    mask = (torch.arange(t, device="cuda")[None, :]
            < args["lengths"][:, None].long())[:, None, None, :]
    library_ms = _time(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True), 50, flush)

    tokens = sum(lengths)
    kv_bytes = 2 * tokens * kv * d * 4
    io_bytes = (b * h * d * 4 * 2 + b * n * 4        # q + out, mass
                + b * n * 4 + b * 4)                 # table, lengths
    flops = 4 * tokens * h * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"B={b} H={h} KV={kv} D={d} page={page} n={n} lengths {lengths} "
          f"float32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA over "
          f"pre-gathered K/V {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {(kv_bytes + io_bytes) / 1e6:.2f} MB at 3.35 TB/s; "
          f"{flops / 1e9:.3f} GFLOP at 67 TFLOP/s) -> "
          f"{bound_ms / ms * 100:.1f}% of the bound", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _scan_kw(sim, cfg, num_pages, scheduler):
    return dict(predictive=(scheduler == "predictive"),
                capacity=cfg.fast_capacity(num_pages), lat_fast=cfg.lat_fast,
                lat_slow=cfg.lat_slow, bw_slow=cfg.bw_slow,
                bw_penalty=cfg.bw_penalty, mig_cost=cfg.mig_cost,
                period_overhead=cfg.period_overhead(num_pages),
                ema_alpha=cfg.ema_alpha)


def _sweep_stacks(sim, bins, periods):
    """What ``sim.sweep`` launches for ``periods``: [(ks, stack, nreals)],
    one per chunk, with ``nreals`` an int32 tensor on the card."""
    return [(ks, stack, torch.tensor(nr, dtype=torch.int32, device=DEV))
            for ks, stack, nr in sim.sweep_stacks(bins, periods)]


def phase_offline_kernels(ph, ss, sim, traces) -> dict:
    """page_hist / bin_trace / sim_scan against their plain versions."""
    print("== phase 7: offline kernels vs plain versions on the card",
          flush=True)
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst_ph = 0.0
    for rows, width, n in ((3277, 100, 4096), (4800, 100, 4096),
                           (1, 100, 512), (9, 1000, 1000), (5, 257, 300)):
        ids = torch.randint(-1, n, (rows, width), generator=g, device=dev,
                            dtype=torch.int32)
        ids[0, :3] = torch.tensor([n, n + 7, -3], dtype=torch.int32)
        hot = torch.rand((n,), generator=g, device=dev) * 3
        for alpha, thr in ((0.5, 1.0), (0.3, 0.7), (0.9, 2.5)):
            got = ph.page_hist(ids, hot, alpha=alpha, threshold=thr)
            torch.cuda.synchronize()
            ref = ph.page_hist_plain(ids, hot, alpha=alpha, threshold=thr)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, ref))
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            worst_ph = max(worst_ph, err)
            if not same:
                _fail(f"page_hist [{rows}, {width}] over {n} pages, alpha "
                      f"{alpha}: differs from its plain version by {err}")
        print(f"page_hist ids [{rows}, {width}], {n} pages, alpha/threshold "
              f"grid of 3: bit-equal to the plain version", flush=True)
    for app in traces.available_traces():
        tr = traces.generate(app)
        bins = sim.bin_trace(tr)
        nb = bins.num_blocks
        ref = np.bincount(np.arange(len(tr.pages)) // bins.block * tr.num_pages
                          + tr.pages, minlength=nb * tr.num_pages)
        same = np.array_equal(bins.block_hist.cpu().numpy(),
                              ref.reshape(nb, tr.num_pages))
        print(f"bin_trace {app}: {len(tr.pages)} accesses, [{nb}, "
              f"{tr.num_pages}] ({nb * tr.num_pages * 4 / 1e6:.1f} MB) == "
              f"numpy bincount: {same}", flush=True)
        if not same:
            _fail(f"bin_trace({app}) differs from numpy's bincount")

    cfg = sim.SimConfig()
    cases = []
    bp = sim.bin_trace(traces.generate("backprop"))
    stacks = _sweep_stacks(sim, bp, sim.exhaustive_periods(bp, 96))
    longest = min(stacks, key=lambda st: min(st[0]))
    largest = max(stacks, key=lambda st: len(st[0]))
    cases += [("backprop longest candidate", bp, longest),
              ("backprop largest group", bp, largest)]
    rng = np.random.default_rng(7)
    toy_tr = traces.Trace("toy", rng.integers(0, 20, 3000).astype(np.int64),
                          20, np.asarray([50]))
    toy = sim.bin_trace(toy_tr, block=50)
    toy_periods = [100, 250, 600, 1500]
    cases += [("toy 20 pages", toy, st)
              for st in _sweep_stacks(sim, toy, toy_periods)]
    for sched in ("reactive", "predictive"):
        for label, bins, (ks, stack, nreals) in cases:
            kw = _scan_kw(sim, cfg, bins.num_pages, sched)
            init = torch.from_numpy(sim._interleaved_init(
                bins.num_pages, kw["capacity"])).to(dev)
            t0 = time.monotonic()
            got = ss.sim_scan(stack, nreals, init, **kw)
            torch.cuda.synchronize()
            t1 = time.monotonic()
            ref = ss.sim_scan_plain(stack, nreals, init, **kw)
            torch.cuda.synchronize()
            t2 = time.monotonic()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            print(f"sim_scan {sched} {label}: {len(ks)} candidate(s) x "
                  f"{stack.shape[1]} periods (real {nreals.tolist()}), "
                  f"{bins.num_pages} pages: bit-equal {same} (runtime "
                  f"{got[0].tolist()}, swaps {got[1].tolist()}, hits "
                  f"{got[2].tolist()}); kernel {t1 - t0:.3f} s, plain "
                  f"{t2 - t1:.3f} s", flush=True)
            if not same:
                _fail(f"sim_scan differs from its plain version ({label}, "
                      f"{sched}): {got} vs {ref}")
        res = sim.sweep(toy, toy_periods, sched)
        for period, r in res.items():
            o = sim.simulate_reference(toy, period, sched)
            if (r.migrations, r.fast_hits) != (o.migrations, o.fast_hits) \
                    or abs(r.runtime - o.runtime) > 1e-5 * o.runtime:
                _fail(f"toy sweep {sched} at {period} disagrees with the "
                      f"numpy oracle: {r} vs {o}")
        print(f"toy sweep {sched} == numpy simulate_reference (migrations, "
              f"hits exact; runtime rtol 1e-5)", flush=True)
    return dict(page_hist=worst_ph, sim_scan=0.0)


def phase_offline_pipeline(sim, pipeline, traces, kernels, ph, ss) -> dict:
    """The paper's evaluation at full size, on the card."""
    print("== phase 8: the paper's offline Cori pipeline at full size",
          flush=True)
    apps, scheds = ("backprop", "lud", "kmeans"), ("reactive", "predictive")
    calls = {"simulate": 0, "chunks": 0}
    simulate, sweep = sim.simulate, sim.sweep

    def counting_simulate(*args, **kw):
        calls["simulate"] += 1
        return simulate(*args, **kw)

    def counting_sweep(bins, periods, *args, **kw):
        calls["chunks"] += len(sim.sweep_plan(bins, periods))
        return sweep(bins, periods, *args, **kw)

    sim.simulate, sim.sweep = counting_simulate, counting_sweep
    studies, base, walls = {}, [], []
    total = {"page_hist": 0, "sim_scan": 0}
    try:
        for app in apps:
            for sched in scheds:
                _reset_counts(kernels)
                calls.update(simulate=0, chunks=0)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                st = pipeline.study(app, sched)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                n_ph, n_ss = ph.page_hist.launches, ss.sim_scan.launches
                expect = calls["simulate"] + calls["chunks"]
                if n_ph != 1 or n_ss != expect:
                    _fail(f"{app}/{sched}: launches page_hist {n_ph} (want "
                          f"1), sim_scan {n_ss} (want {calls['simulate']} "
                          f"simulate + {calls['chunks']} sweep chunks)")
                total["page_hist"] += n_ph
                total["sim_scan"] += n_ss
                studies[(app, sched)] = st
                walls.append(wall)
                gaps = st.table_i_slowdowns()
                worst = max(gaps, key=gaps.get)
                print(f"{app}/{sched}: optimal period {st.optimal_period:.0f}"
                      f" (runtime {st.optimal_runtime:.1f}), Cori chose "
                      f"{st.cori.chosen_period:.0f} after {st.cori.trials} "
                      f"trials (DR {st.cori.dominant_reuse:.0f}, "
                      f"trials-to-best {st.cori_trials_to_best}), slack vs "
                      f"optimal {st.cori_slowdown_vs_optimal * 100:.2f}%, "
                      f"worst Table-I gap {gaps[worst] * 100:.1f}% ({worst}); "
                      f"study wall {wall:.2f} s; launches page_hist {n_ph}, "
                      f"sim_scan {n_ss} = {calls['simulate']} simulate + "
                      f"{calls['chunks']} sweep chunks", flush=True)
            bins = sim.bin_trace(traces.generate(app))
            for sched in scheds:
                t0 = time.monotonic()
                b = pipeline.baseline_trials_all(bins, sched, seeds=3)
                base.extend(b.values())
                print(f"{app}/{sched} Eq.-3 baselines trials-to-best "
                      f"{b} in {time.monotonic() - t0:.2f} s", flush=True)
    finally:
        sim.simulate, sim.sweep = simulate, sweep
    slacks = [st.cori_slowdown_vs_optimal for st in studies.values()]
    worst_gaps = [max(st.table_i_slowdowns().values())
                  for st in studies.values()]
    near = None
    for st in studies.values():
        gaps = st.table_i_slowdowns()
        best = min(gaps.values())
        cell = {k for k, v in gaps.items() if v <= best + 0.01}
        near = cell if near is None else near & cell
    cori_trials = [st.cori_trials_to_best for st in studies.values()]
    ratio = float(np.mean(base) / np.mean(cori_trials))
    print(f"claims: mean slack {np.mean(slacks) * 100:.2f}% (bar 5%), max "
          f"{max(slacks) * 100:.2f}% (bar 15%); worst Table-I gap per cell "
          f"{[round(g * 100, 1) for g in worst_gaps]}% (bars >= 10% each, "
          f">= 80% somewhere); Table-I values near-best everywhere: "
          f"{sorted(near)} (bar: none); trials-to-best Cori "
          f"{np.mean(cori_trials):.2f} (bar <= 8) vs baselines "
          f"{np.mean(base):.2f}: {ratio:.2f}x (bar >= 3x); study wall "
          f"mean {np.mean(walls):.2f} s, max {max(walls):.2f} s", flush=True)
    if not (np.mean(slacks) <= 0.05 and max(slacks) <= 0.15):
        _fail("Cori is not within the slack bars of optimal")
    if min(worst_gaps) < 0.10 or max(worst_gaps) < 0.80:
        _fail("the Table-I gap bars do not hold")
    if near:
        _fail(f"a single Table-I value is near-best everywhere: {near}")
    if ratio < 3.0 or np.mean(cori_trials) > 8.0:
        _fail("Cori does not need several-fold fewer trials")
    return dict(launches=total, slack_mean=float(np.mean(slacks)),
                slack_max=max(slacks), trials_ratio=ratio,
                study_wall_mean_s=float(np.mean(walls)))


def _time_once(fn, flush_buf):
    """ms of one call (CUDA events, L2 flushed before it)."""
    flush_buf.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_offline_timing(ph, ss, sim, traces, kernels) -> dict:
    print("== phase 9: offline kernel timing at the main-path shapes",
          flush=True)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=DEV)
    before = {k.NAME: getattr(k, k.NAME).launches for k in kernels}
    tr = traces.generate("backprop")
    n, block = tr.num_pages, sim.DEFAULT_BLOCK
    rows = -(-len(tr.pages) // block)
    ids = np.full(rows * block, -1, np.int32)
    ids[: len(tr.pages)] = tr.pages
    ids = torch.from_numpy(ids).to(DEV).reshape(rows, block)
    zeros = torch.zeros((n,), device=DEV)
    ms = _time(lambda: ph.page_hist(ids, zeros), 20, flush)
    plain_ms = _time(lambda: ph.page_hist_plain(ids, zeros), 20, flush)
    flat = (torch.arange(rows, device=DEV)[:, None] * n
            + ids.long())[ids >= 0]
    library_ms = _time(lambda: torch.bincount(flat, minlength=rows * n), 20,
                       flush)
    nbytes = rows * block * 4 + n * 4 + rows * n * (4 + 4 + 1)
    flops = 3 * rows * n + rows * block
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    hist = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"page_hist ids [{rows}, {block}] over {n} pages (backprop's "
          f"bin_trace): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, one "
          f"torch.bincount (counts only) {library_ms:.4f} ms, bound "
          f"{hist['bound_ms']:.4f} ms ({hist['bound_by']}: "
          f"{nbytes / 1e6:.2f} MB at 3.35 TB/s; {flops / 1e6:.1f} MFLOP at "
          f"67 TFLOP/s) -> {hist['bound_ms'] / ms * 100:.1f}% of the bound",
          flush=True)

    bins = sim.bin_trace(tr)
    cfg = sim.SimConfig()
    kw = _scan_kw(sim, cfg, n, "reactive")
    init = torch.from_numpy(sim._interleaved_init(n, kw["capacity"])).to(DEV)
    stacks = _sweep_stacks(sim, bins, sim.exhaustive_periods(bins, 96))

    def kernel_sweep():
        for _, stack, nreals in stacks:
            ss.sim_scan(stack, nreals, init, **kw)

    def plain_sweep():
        for _, stack, nreals in stacks:
            ss.sim_scan_plain(stack, nreals, init, **kw)

    kernel_sweep()
    sweep_ms = [_time_once(kernel_sweep, flush) for _ in range(3)]
    plain_sweep_ms = _time_once(plain_sweep, flush)
    real = sum(int(nr.sum()) for _, _, nr in stacks)
    cands = sum(len(ks) for ks, _, _ in stacks)
    serial = max(int(nr.max()) for _, _, nr in stacks)
    serial_sum = sum(int(nr.max()) for _, _, nr in stacks)
    nbytes = real * n * 4 + n + cands * (4 + 3 * 4)
    flops = 10 * real * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    scan = dict(ms=float(np.mean(sweep_ms)), plain_ms=plain_sweep_ms,
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"sim_scan over backprop's exhaustive sweep (reactive): "
          f"{len(stacks)} launches, {cands} candidates, {real} real period "
          f"rows of {n} pages; longest candidate {serial} periods, "
          f"{serial_sum} periods on the launches' serial paths: kernel "
          f"{scan['ms']:.3f} ms (runs {[round(t, 3) for t in sweep_ms]}; "
          f"{scan['ms'] * 1e3 / serial_sum:.2f} us per serial period), "
          f"plain {plain_sweep_ms:.1f} ms, library none, bound "
          f"{scan['bound_ms']:.4f} ms ({scan['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s; {flops / 1e9:.2f} GFLOP at "
          f"67 TFLOP/s) -> {scan['bound_ms'] / scan['ms'] * 100:.2f}% of "
          f"the bound", flush=True)
    for k in kernels:                          # timing launches not counted
        getattr(k, k.NAME).launches = before[k.NAME]
    return dict(page_hist=hist, sim_scan=scan)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is visible", flush=True)
        return 1
    root = pathlib.Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        print(f"FAIL: the port's sources are not beside this script "
              f"({src / 'repro_torch'})", flush=True)
        return 1
    sys.path.insert(0, str(src))
    import repro_torch.configs as C
    from repro_torch import resolve_device
    from repro_torch.core import cori, pipeline, sim, traces
    from repro_torch import memtier
    from repro_torch.kernels import _build
    from repro_torch.kernels import page_hist as ph
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sim_step as ss
    from repro_torch.models import model as mdl
    from repro_torch.obs import telemetry
    from repro_torch.serve import engine
    from repro_torch.serve import sched as S

    kernels = (pa, ph, ss)
    secs = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        secs[name] = round(time.monotonic() - t0, 1)
        print(f"-- {name}: {secs[name]} s", flush=True)
        return out

    resolve_device()                       # pins float32 matmuls (no TF32)
    card = timed("device", phase_device)
    timed("build", phase_build, _build, kernels)
    err = timed("paged_attention check", phase_kernel_check, pa)
    serve = timed("serving", phase_serve, C, mdl, pa, S, memtier, cori,
                  telemetry, kernels)
    timed("parity", phase_parity, C, mdl, S, memtier, cori, engine)
    timing = timed("paged_attention timing", phase_timing, pa)
    errs = timed("offline kernels check", phase_offline_kernels, ph, ss,
                 sim, traces)
    offline = timed("offline pipeline", phase_offline_pipeline, sim,
                    pipeline, traces, kernels, ph, ss)
    off_timing = timed("offline timing", phase_offline_timing, ph, ss, sim,
                       traces, kernels)
    print(f"card: {card}; serving {serve}; offline {offline}; phase seconds "
          f"{secs}", flush=True)
    print(json.dumps({"kernels": [
        dict(name="paged_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_attention.cu",
             replaces="src/repro/kernels/paged_attention.py:121",
             launches=serve["launches"], max_abs_err=err, **timing),
        dict(name="page_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/page_hist.cu",
             replaces="src/repro/kernels/page_hist.py:45",
             launches=offline["launches"]["page_hist"],
             max_abs_err=errs["page_hist"], **off_timing["page_hist"]),
        dict(name="sim_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/sim_scan.cu",
             replaces="src/repro/kernels/sim_step.py:104",
             launches=offline["launches"]["sim_scan"],
             max_abs_err=errs["sim_scan"], **off_timing["sim_scan"])]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
