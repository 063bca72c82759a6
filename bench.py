#!/usr/bin/env python
"""Headline benchmark: end-to-end genotype calling throughput, 1 chip.

Generates a ~30x-coverage simulated diploid pileup (BASELINE config 2) and
runs the full pipeline (parse -> dedup -> device kernels -> CSV) for all
four calling methods on the default JAX device, interleaved with the
reference-equivalent single-threaded C++ baseline binary so each pair shares
the same machine state. Reports the median of K interleaved pairs (host
timings are noisy; medians of same-run pairs are the honest comparison).

It measures in this one process and exits non-zero on any failure.
``SIDTPU_PLATFORM`` (e.g. ``cpu``) picks the JAX platform explicitly.

Prints ONE JSON line on stdout:
    {"metric": "local_...", "value": N, "unit": "sites/s",
     "vs_baseline": N, "methods": {<per-method medians and ratios>}}
Per-method JSON lines and component timings go to stderr.

vs_baseline is measured against this repo's reference-equivalent
single-threaded C++ baseline (tools/baseline, all four methods), built from
source on first use.

The double-single (DS) legs, fit rows and kernel microbench entries run only
under ``SIDTPU_WARM_DS=1`` (``sid_tpu.ops.likelihoods_ds.ds_requested``).
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# SMOKE mode (tests/test_bench_stdout.py): tiny input, 1 round, no grammar-rich
# config, no device-forced legs, no microbench — just enough to exercise the
# end-to-end measurement loop and the stdout contract in seconds on CPU.
SMOKE = bool(os.environ.get("SIDTPU_BENCH_SMOKE"))
N_SITES = int(os.environ.get("SIDTPU_BENCH_SITES", "5000" if SMOKE else "1000000"))
BWA_SITES = int(os.environ.get("SIDTPU_BENCH_BWA_SITES", "1000000"))
ROUNDS = int(os.environ.get("SIDTPU_BENCH_ROUNDS", "1" if SMOKE else "3"))

# (method, baseline argv flags, Options kwargs)
METHODS = [
    ("local", [], {}),
    ("quality", ["-m", "quality"], {"method": "quality"}),
    ("bayes", ["-m", "bayes"], {"method": "bayes"}),
    # -R -m likelihood_ratio is the reference thesis-pipeline config
    ("likelihood_ratio", ["-R", "-m", "likelihood_ratio"],
     {"method": "likelihood_ratio", "estimate_prior": True}),
]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def generate(n_sites):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    import numpy as np
    from synth import make_pileup_text_fast

    rng = np.random.default_rng(7)
    # fast vectorized simulation (pi=1e-3, eps=1e-2, ~30x)
    cov = rng.poisson(30, n_sites).clip(1)
    is_het = rng.uniform(size=n_sites) < 1e-3
    major = rng.integers(0, 4, n_sites)
    counts = np.zeros((n_sites, 4), np.int64)
    n_err = rng.binomial(cov, 0.01)
    n_good = cov - n_err
    counts[np.arange(n_sites), major] = n_good
    # heterozygous sites split between two alleles
    het_idx = np.nonzero(is_het)[0]
    second = (major[het_idx] + 1 + rng.integers(0, 3, het_idx.size)) % 4
    half = counts[het_idx, major[het_idx]] // 2
    counts[het_idx, major[het_idx]] -= half
    counts[het_idx, second] += half
    err_base = rng.integers(0, 4, n_sites)
    counts[np.arange(n_sites), err_base] += n_err
    return make_pileup_text_fast(counts.astype(np.int32))


def generate_bwa(n_sites):
    """Grammar-rich input (BWA/samtools artifact mix): indels, ^X/$ markers,
    '*', N refs, Phred variance — the AVX2 escape fallback and the fused
    terms-only path run for real. Seeded + slow to build, so cached on disk.
    """
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    cache = os.path.join(tempfile.gettempdir(), f"sidtpu_bench_bwa_{n_sites}.pileup")
    if os.path.exists(cache) and os.path.getsize(cache) > 0:
        with open(cache, "rb") as f:
            return f.read(), cache
    from synth import make_bwa_like_pileup_scaled

    text = make_bwa_like_pileup_scaled(n_sites)
    with open(cache, "wb") as f:
        f.write(text)
    return text, cache


def measure_baseline(exe, flags, pileup_path):
    t0 = time.time()
    subprocess.run(
        [exe] + flags + [pileup_path], stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, check=True,
    )
    return time.time() - t0


def _measure_config(label, text, path, n_sites, rounds=ROUNDS,
                    extra_opts=None, env=None, with_baseline=True):
    """Interleaved ours/baseline medians for one input config.

    Each of our runs records the per-stage wall (parse/call/serialize) and
    the device split (device-stage seconds + dispatch count), so the JSON
    carries device_fraction — the accelerator's actual share of the
    end-to-end wall (verdict-r2 #4: keep the host-vs-device story visible).

    ``extra_opts``/``env`` parameterize forced-device configs
    (mesh_devices=1, SIDTPU_DEVICE_PREC=ds); ``with_baseline=False`` skips
    the C++ baseline re-runs (the caller reuses the default config's
    baseline medians — the input is identical).
    """
    from sid_tpu.config import Options
    from sid_tpu import engine
    from sid_tpu.utils import profiling

    saved_env = {}
    for k, v in (env or {}).items():
        saved_env[k] = os.environ.get(k)
        os.environ[k] = v
    try:
        return _measure_config_inner(
            label, text, path, n_sites, rounds, extra_opts or {}, with_baseline
        )
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _measure_config_inner(label, text, path, n_sites, rounds, extra_opts,
                          with_baseline):
    from sid_tpu.config import Options
    from sid_tpu import engine
    from sid_tpu.utils import profiling

    opts = {m: Options(**{**kw, **extra_opts}) for m, _, kw in METHODS}

    log(f"  [{label}] warmup (compilation)...")
    for m, _, _ in METHODS:
        t0 = time.time()
        engine.run(text, opts[m], binary=True)
        log(f"  [{label}] warmup {m}: {time.time()-t0:.1f}s")

    exe = None
    if with_baseline:
        from tools.baseline.build import ensure_built

        exe = ensure_built()

    ours = {m: [] for m, _, _ in METHODS}
    base = {m: [] for m, _, _ in METHODS}
    dev_s = {m: [] for m, _, _ in METHODS}
    disp = {m: [] for m, _, _ in METHODS}
    stage_acc = {m: {} for m, _, _ in METHODS}
    expected_rows = {}
    for r in range(rounds):
        for m, flags, _ in METHODS:
            prof = profiling.StageProfile()
            profiling.activate(prof)
            t0 = time.time()
            csv = engine.run(text, opts[m], binary=True)
            ours[m].append(time.time() - t0)
            profiling.activate(None)
            dev_s[m].append(profiling.device_seconds(prof))
            disp[m].append(int(prof.counters.get("device_dispatches", 0)))
            for name, sec in prof.stages:
                stage_acc[m].setdefault(name, []).append(sec)
            n_rows = csv.count(b"\n") - 1
            if m in expected_rows:
                assert n_rows == expected_rows[m], (m, n_rows)
            else:
                expected_rows[m] = n_rows
                assert 0 < n_rows <= n_sites, (m, n_rows)
            if exe is not None:
                base[m].append(measure_baseline(exe, flags, path))
            log(f"  [{label}] round {r+1} {m}: ours {ours[m][-1]:.2f}s "
                f"(device {dev_s[m][-1]:.3f}s/{disp[m][-1]} dispatches)"
                + (f", baseline {base[m][-1]:.2f}s" if exe else ""))

    methods_out = {}
    for m, _, _ in METHODS:
        t_ours = statistics.median(ours[m])
        sps = n_sites / t_ours
        t_dev = statistics.median(dev_s[m])
        stages = {
            name: round(statistics.median(vals), 4)
            for name, vals in stage_acc[m].items()
        }
        methods_out[m] = {
            "sites_per_sec": round(sps),
            "device_seconds": round(t_dev, 4),
            "device_fraction": round(t_dev / t_ours, 4) if t_ours else 0.0,
            "device_dispatches": disp[m][-1],
            "stages": stages,
        }
        if exe is not None:
            anchor = n_sites / statistics.median(base[m])
            methods_out[m]["baseline_sites_per_sec"] = round(anchor)
            methods_out[m]["vs_baseline"] = round(sps / anchor, 3)
        log(f"  [{label}] {m}: {round(sps):,} sites/s, device "
            f"{t_dev:.3f}s ({100*t_dev/t_ours:.0f}%), stages {stages}")
    return methods_out


def precisions():
    """Device precisions the forced legs and the fit rows measure."""
    from sid_tpu.ops.likelihoods_ds import ds_requested

    return ("f64", "ds") if ds_requested() else ("f64",)


def _device_microbench():
    """Per-kernel device throughput at the 1M-row bucket + fit iteration rate.

    Measures the mesh-sharded executables the device-forced e2e runs use
    (sid_tpu.utils.warmup.microbench_kernels): the slim local classify and
    the quality finalize, f64 vs double-single. Two numbers per kernel:

    - ``per_dispatch_wall_s``: median wall of one dispatch on device-resident
      inputs — what one classify costs the pipeline end to end.
    - ``per_execution_s``: kernel execution time proper, measured by running
      the kernel K times inside ONE dispatch (on-device fori_loop with a
      value-preserving data dependency, warmup.make_looped_kernel) at two
      loop lengths and differencing: (wall(K2) - wall(K1)) / (K2 - K1). The
      dispatch floor, transfers and host overhead cancel exactly.

    FLOPs come from XLA's cost analysis of the single-dispatch optimized
    module (HLO-level op counts).
    """
    import statistics as stats

    import jax

    from sid_tpu.utils.warmup import (
        LOOP_K_BIG,
        LOOP_K_SMALL,
        MICROBENCH_U,
        make_looped_kernel,
        microbench_inputs,
        microbench_kernels,
    )

    out = {}
    import numpy as np

    def sync(x):
        """Completion barrier: fetch one element to host."""
        leaf = jax.tree_util.tree_leaves(x)[0]
        np.asarray(leaf.ravel()[:1] if leaf.ndim else leaf)

    # distinct-content input variants (same shapes/dtypes -> one
    # executable), each synced before any timing
    n_variants = 6
    variants = [microbench_inputs(seed=i) for i in range(n_variants)]
    for v in variants:
        for leaf in jax.tree_util.tree_leaves(v):
            np.asarray(leaf.ravel()[:1] if leaf.ndim else leaf)
    args = variants[0]
    for name, fn in microbench_kernels():
        sync(fn(args))  # compile/warm (variant 0)
        times = []
        for r in range(5):
            v = variants[1 + r % (n_variants - 1)]
            t0 = time.perf_counter()
            sync(fn(v))
            times.append(time.perf_counter() - t0)
        t_dispatch = stats.median(times)

        # per-execution via the two-point on-device loop
        t_loop = {}
        for k in (LOOP_K_SMALL, LOOP_K_BIG):
            looped = make_looped_kernel(fn, k)
            sync(looped(args))  # compile/warm (variant 0)
            samples = []
            for r in range(3):
                v = variants[1 + r]
                t0 = time.perf_counter()
                sync(looped(v))
                samples.append(time.perf_counter() - t0)
            t_loop[k] = stats.median(samples)
        t_exec = max(
            (t_loop[LOOP_K_BIG] - t_loop[LOOP_K_SMALL])
            / (LOOP_K_BIG - LOOP_K_SMALL),
            1e-9,
        )
        entry = {
            "rows": MICROBENCH_U,
            "per_dispatch_wall_s": round(t_dispatch, 5),
            "per_execution_s": round(t_exec, 6),
            "loop_walls_s": {
                str(k): round(v, 5) for k, v in sorted(t_loop.items())
            },
            "rows_per_sec_execution": round(MICROBENCH_U / t_exec),
            "rows_per_sec_dispatch": round(MICROBENCH_U / t_dispatch),
        }
        try:
            cost = jax.jit(fn).lower(args).compile().cost_analysis()
            flops = float(cost.get("flops", 0.0))
            entry["hlo_flops"] = flops
            entry["hlo_flops_per_sec_execution"] = round(flops / t_exec)
        except Exception as exc:  # cost analysis is best-effort
            entry["cost_analysis_error"] = str(exc)[:120]
        out[name] = entry
        log(f"  [micro] {name}: {entry}")

    # fit time at the production 8192 bucket, at each of precisions(),
    # through the same sharded path the device-forced e2e uses
    # (fit_lynch_global)
    rng = np.random.default_rng(1)
    u = 2000
    profiles = rng.multinomial(30, [0.85, 0.08, 0.05, 0.02], (u,)).astype(np.int32)
    mult = rng.integers(1, 1000, u).astype(np.int64)
    from sid_tpu.parallel.fit import fit_lynch_global
    from sid_tpu.parallel.mesh import make_site_mesh

    mesh = make_site_mesh(1)
    for prec in precisions():
        saved = os.environ.get("SIDTPU_DEVICE_PREC")
        os.environ["SIDTPU_DEVICE_PREC"] = prec
        try:
            fit_lynch_global(profiles, mult, mesh)  # compile/warm
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                pi, eps, _, _, _ = fit_lynch_global(profiles, mult, mesh)
                times.append(time.perf_counter() - t0)
        finally:
            if saved is None:
                os.environ.pop("SIDTPU_DEVICE_PREC", None)
            else:
                os.environ["SIDTPU_DEVICE_PREC"] = saved
        t = stats.median(times)
        out[f"fit_lynch_{prec}"] = {
            "unique_profiles": u,
            "pad_bucket": 8192,
            "seconds": round(t, 4),
            "pi": pi,
            "eps": eps,
        }
        log(f"  [micro] fit_lynch_{prec}: {out[f'fit_lynch_{prec}']}")
    return out


def main():
    import sid_tpu  # noqa: F401

    log(f"generating {N_SITES} simulated sites...")
    t0 = time.time()
    text = generate(N_SITES)
    log(f"  generate: {time.time()-t0:.1f}s ({len(text)/1e6:.0f} MB)")
    path = os.path.join(tempfile.gettempdir(), "sidtpu_bench.pileup")
    with open(path, "wb") as f:
        f.write(text)

    if not SMOKE:
        log(f"generating {BWA_SITES} grammar-rich (BWA-artifact) sites...")
        t0 = time.time()
        bwa_text, bwa_path = generate_bwa(BWA_SITES)
        log(f"  generate/load: {time.time()-t0:.1f}s ({len(bwa_text)/1e6:.0f} MB)")

    # forced-device configs: the same clean input with every stage on the
    # accelerator (mesh_devices=1 engages the sharded kernels and the device
    # psum fit — the multi-chip path, measured on one chip)
    dev_rounds = int(os.environ.get("SIDTPU_BENCH_DEV_ROUNDS", "2"))
    device_forced = {}
    if not SMOKE:
        for prec in precisions():
            device_forced[prec] = _measure_config(
                f"device_{prec}", text, path, N_SITES, rounds=dev_rounds,
                extra_opts={"mesh_devices": 1},
                env={"SIDTPU_DEVICE_PREC": prec}, with_baseline=False,
            )

    micro = {} if SMOKE else _device_microbench()

    methods_out = _measure_config("clean", text, path, N_SITES)
    bwa_out = {} if SMOKE else _measure_config("bwa_mix", bwa_text, bwa_path, BWA_SITES)

    # vs_baseline for the forced-device legs reuses the clean config's
    # baseline medians (identical input and flags)
    for prec in device_forced:
        for m in device_forced[prec]:
            anchor = methods_out[m]["baseline_sites_per_sec"]
            device_forced[prec][m]["baseline_sites_per_sec"] = anchor
            device_forced[prec][m]["vs_baseline"] = round(
                device_forced[prec][m]["sites_per_sec"] / anchor, 3
            )

    import jax

    platform = jax.devices()[0].platform
    for m, _, _ in METHODS:
        log(json.dumps({"metric": f"{m}_end_to_end_sites_per_sec_1chip",
                        "value": methods_out[m]["sites_per_sec"],
                        "unit": "sites/s",
                        "vs_baseline": methods_out[m]["vs_baseline"],
                        "platform": platform}))

    head = methods_out["local"]
    detail = {
        "metric": "local_method_end_to_end_sites_per_sec_1chip",
        "value": head["sites_per_sec"],
        "unit": "sites/s",
        "vs_baseline": head["vs_baseline"],
        "platform": platform,
        "rounds": ROUNDS,
        "methods": methods_out,
        "methods_bwa_mix": bwa_out,
        "device_forced": device_forced,
        "device_microbench": micro,
    }
    detail_path = os.environ.get(
        "SIDTPU_BENCH_DETAIL",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "BENCH_detail.json"),
    )
    try:
        with open(detail_path, "w") as f:
            json.dump(detail, f, indent=1)
        log(f"full detail written to {detail_path}")
    except OSError as exc:
        log(f"could not write detail file: {exc}")
    log(json.dumps(detail))  # full record on stderr too

    # stdout contract: EXACTLY ONE compact JSON line (< ~1 KB), so a reader
    # that keeps a 2000-char tail of the output and parses its last line
    # never sees it truncated. Detail lives in the file/stderr
    # (tests/test_bench_stdout.py pins both properties).
    compact = {
        "metric": "local_method_end_to_end_sites_per_sec_1chip",
        "value": head["sites_per_sec"],
        "unit": "sites/s",
        "vs_baseline": head["vs_baseline"],
        "platform": platform,
        "rounds": ROUNDS,
        "methods_sites_per_sec": {
            m: methods_out[m]["sites_per_sec"] for m, _, _ in METHODS
        },
        "methods_vs_baseline": {
            m: methods_out[m]["vs_baseline"] for m, _, _ in METHODS
        },
    }
    if device_forced:
        compact["device_forced_sites_per_sec"] = {
            prec: {m: v[m]["sites_per_sec"] for m in v}
            for prec, v in device_forced.items()
        }
    line = json.dumps(compact, separators=(",", ":"))
    if len(line) > 1800:  # hard guard: never regress the tail-parse contract
        line = json.dumps(
            {k: compact[k] for k in
             ("metric", "value", "unit", "vs_baseline", "platform", "rounds")},
            separators=(",", ":"),
        )
    sys.stderr.flush()
    print(line, flush=True)


if __name__ == "__main__":
    platform = os.environ.get("SIDTPU_PLATFORM")
    if platform:
        import jax

        jax.config.update("jax_platforms", platform)
    main()
