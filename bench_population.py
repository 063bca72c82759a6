#!/usr/bin/env python
"""Population-batch throughput (BASELINE config 5 shape, at reduced scale).

BASELINE.json config 5 is "100-sample population batch on one H100"; this
measures the same code path at reduced scale: S samples of N sites each
through call_population in both modes (pooled = one global Lynch fit over the union histogram; independent =
vmapped per-sample fits batched over the sample axis), single mesh and — with
SIDTPU_POP_MESH=k — a k-device mesh sharding the SAMPLE axis (the BASELINE
config's layout; see models/population.py and __graft_entry__'s
population-sample-axis dryrun).

Prints one JSON line per (mode, mesh) config:
    {"metric": "population_<mode>_sites_per_sec", "samples": S, ...}

Usage:
    SIDTPU_SCALING_CPU=1 python bench_population.py   # CPU backend, 8 vdev
    python bench_population.py                        # default device, mesh=None
"""

import json
import os
import sys
import time

if os.environ.get("SIDTPU_SCALING_CPU"):
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))

S = int(os.environ.get("SIDTPU_POP_SAMPLES", "100"))
N = int(os.environ.get("SIDTPU_POP_SITES", "20000"))
ROUNDS = int(os.environ.get("SIDTPU_POP_ROUNDS", "3"))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import sid_tpu  # noqa: F401
    from sid_tpu.config import Options
    from sid_tpu.io.pileup import parse_pileup
    from sid_tpu.models.population import call_population
    from synth import make_pileup_text_fast

    rng = np.random.default_rng(5)
    log(f"generating {S} samples x {N} sites...")
    samples = []
    for s in range(S):
        cov = rng.poisson(30, N).clip(1)
        major = rng.integers(0, 4, N)
        counts = np.zeros((N, 4), np.int64)
        n_err = rng.binomial(cov, 0.01)
        counts[np.arange(N), major] = cov - n_err
        counts[np.arange(N), rng.integers(0, 4, N)] += n_err
        text = make_pileup_text_fast(counts.astype(np.int32))
        samples.append(parse_pileup(text, False, False))
    total_sites = S * N

    from sid_tpu.utils import profiling

    mesh_env = os.environ.get("SIDTPU_POP_MESH")
    mesh_devices = int(mesh_env) if mesh_env else None
    results = {}
    for mode in ("pooled", "independent"):
        opts = Options(method="bayes", mesh_devices=mesh_devices)
        t0 = time.time()
        call_population(samples, opts, mode=mode)  # warm/compile
        log(f"  warm {mode}: {time.time() - t0:.1f}s")
        walls = []
        disp = dev_s = 0
        for r in range(ROUNDS):
            prof = profiling.StageProfile()
            profiling.activate(prof)
            t0 = time.time()
            try:
                res = call_population(samples, opts, mode=mode)
            finally:
                profiling.activate(None)
            walls.append(time.time() - t0)
            disp = int(prof.counters.get("device_dispatches", 0))
            dev_s = profiling.device_seconds(prof)
            assert len(res) == S
            log(f"  {mode} round {r + 1}: {walls[-1]:.2f}s "
                f"({disp} device dispatches, {dev_s:.2f}s device)")
        wall = sorted(walls)[len(walls) // 2]
        results[mode] = {
            "metric": f"population_{mode}_sites_per_sec",
            "value": round(total_sites / wall),
            "unit": "sites/s",
            "samples": S,
            "sites_per_sample": N,
            "mesh_devices": mesh_devices,
            "platform": jax.devices()[0].platform,
            "wall_s": round(wall, 3),
            # the r5 claim: classification dispatches are independent of S
            # (one batched marginal call; fits were already batched)
            "device_dispatches": disp,
            "device_seconds": round(dev_s, 3),
        }
        print(json.dumps(results[mode]))


if __name__ == "__main__":
    main()
