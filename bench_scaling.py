#!/usr/bin/env python
"""Scaling benchmark harness: sites/s efficiency across mesh sizes.

This harness (a) validates numerical shard-invariance across mesh sizes on
whatever devices exist (virtual CPU devices via
--xla_force_host_platform_device_count with SIDTPU_SCALING_CPU=1, or the
local GPUs), and (b) measures the sharded Lynch fit + classification wall
time per mesh size. On a multi-GPU host, run:

    python bench_scaling.py

Prints one JSON line per mesh size.
"""

import json
import os
import sys
import time

if os.environ.get("SIDTPU_SCALING_CPU", "0") == "1":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import numpy as np  # noqa: E402

import sid_tpu  # noqa: F401,E402
from sid_tpu.ops.profiles import (  # noqa: E402
    filter_min_coverage,
    nucleotide_distribution,
    unique_profiles,
)
from sid_tpu.parallel.fit import fit_lynch_global  # noqa: E402
from sid_tpu.parallel.mesh import make_site_mesh  # noqa: E402

N_SITES = int(os.environ.get("SIDTPU_SCALING_SITES", "200000"))

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)


def collective_census(hlo_text: str):
    """Count collective ops in compiled (post-SPMD-partitioning) HLO.

    This is the checkable basis for scaling extrapolation on hardware this
    container lacks: an op count of zero means the kernel is communication-
    free SPMD (scaling limited only by load balance); for the fit, the
    all-reduce payload is a scalar f64 per objective evaluation.
    """
    out = {}
    for c in _COLLECTIVES:
        # an HLO instruction reads '%name = type all-reduce(operands...)';
        # counting ' all-reduce(' matches op instances, not metadata
        n = hlo_text.count(" " + c + "(")
        if n:
            out[c] = n
    return out


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from synth import simulate_diploid_counts

    counts = simulate_diploid_counts(N_SITES, coverage=30, pi=0.01, eps=0.005)
    profiles, mult, _ = unique_profiles(counts)
    profiles, mult, _ = filter_min_coverage(profiles, mult, 4)
    n_dev = len(jax.devices())
    print(f"# devices: {n_dev} ({jax.devices()[0].platform})", file=sys.stderr)

    import jax.numpy as jnp

    from sid_tpu.models.local import classify_local
    from sid_tpu.ops.lgamma import lgamma_int_table, table_size
    from sid_tpu.parallel.mesh import row_sharding

    # a large per-site workload for throughput scaling (the embarrassingly
    # parallel axis); the fit is latency-bound and reported separately
    big = np.repeat(counts, max(1, 2_000_000 // N_SITES), axis=0).astype(np.int32)
    pad = (-big.shape[0]) % 64
    big = np.pad(big, [(0, pad), (0, 0)])
    tab = jnp.asarray(lgamma_int_table(table_size(int(big.sum(1).max()))))

    fit_times = {}
    cls_times = {}
    pi_1 = eps_1 = None
    platform = jax.devices()[0].platform
    # the efficiency caveat rides in every JSONL row so the artifact cannot
    # be over-read later: on a host with few cores, k>1 virtual devices
    # oversubscribe the cores and efficiency_vs_1
    # decays for host reasons — it is a lower bound under oversubscription,
    # not a design property. The checkable scaling argument is the census
    # fields (zero classify collectives; scalar-only fit all-reduces),
    # hard-asserted below.
    caveat = (
        "virtual CPU mesh on a 2-core host: k>1 oversubscribes cores; "
        "lower bound only — see *_collectives for the scaling argument"
    ) if platform == "cpu" else None
    sizes = [k for k in (1, 2, 4, 8, 16, 32, 64) if k <= n_dev]
    for k in sizes:
        mesh = make_site_mesh(k)
        fit_lynch_global(profiles, mult, mesh)  # warm/compile
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            pi, eps, lh, lt, nt = fit_lynch_global(profiles, mult, mesh)
        fit_times[k] = (time.time() - t0) / reps

        big_dev = jax.device_put(big, row_sharding(mesh, 2))
        args = (jnp.float64(0.1), jnp.float64(0.05), jnp.float64(-1.0), tab)
        jax.block_until_ready(classify_local(big_dev, *args))  # warm
        t0 = time.time()
        for _ in range(reps):
            out = classify_local(big_dev, *args)
        jax.block_until_ready(out)
        cls_times[k] = (time.time() - t0) / reps

        # collective census of the compiled (SPMD-partitioned) modules:
        # the hardware-independent scaling evidence
        cls_hlo = classify_local.lower(big_dev, *args).compile().as_text()
        from sid_tpu.models.lynch import fit_lynch as _fit_jit
        from sid_tpu.parallel.mesh import shard_profiles as _shard
        from sid_tpu.utils.padding import bucket_size as _bucket

        b = _bucket(max(profiles.shape[0], 1))
        b = ((b + k - 1) // k) * k
        pp = np.zeros((b, 4), np.int32)
        pp[: profiles.shape[0]] = profiles
        mm = np.zeros(b, np.int64)
        mm[: profiles.shape[0]] = mult
        ps, ms = _shard(mesh, pp, mm)
        nt_j = jnp.asarray(nucleotide_distribution(profiles, mult))
        tab_f = jnp.asarray(
            lgamma_int_table(table_size(int(profiles.sum(-1).max())))
        )
        fit_hlo = _fit_jit.lower(ps, ms, nt_j, tab_f).compile().as_text()

        # ---- hard asserts: the artifact's claims, enforced not narrated ----
        cls_census = collective_census(cls_hlo)
        fit_census = collective_census(fit_hlo)
        # classify is communication-free SPMD at every mesh size
        assert cls_census == {}, (
            f"classify module grew collectives at k={k}: {cls_census}"
        )
        # the fit's only collectives are all-reduces (scalar objective /
        # convergence state); any other collective type is a regression
        assert set(fit_census) <= {"all-reduce"}, (
            f"fit module has non-all-reduce collectives at k={k}: {fit_census}"
        )
        if k > 1:
            assert fit_census.get("all-reduce", 0) >= 1, (
                f"sharded fit lost its all-reduce at k={k}"
            )
        # fitted params are bitwise shard-invariant across mesh sizes
        if pi_1 is None:
            pi_1, eps_1 = pi, eps
        assert pi == pi_1 and eps == eps_1, (
            f"fit params not bitwise shard-invariant at k={k}: "
            f"({pi}, {eps}) vs 1-way ({pi_1}, {eps_1})"
        )

        row = {
            "metric": "scaling",
            "mesh_devices": k,
            "fit_seconds": round(fit_times[k], 4),
            "classify_sites_per_sec": round(big.shape[0] / cls_times[k]),
            "classify_scaling_efficiency_vs_1": round(
                cls_times[sizes[0]] / (cls_times[k] * k), 3
            ),
            "classify_collectives": cls_census,
            "fit_collectives": fit_census,
            "pi_eps_bitwise_equal_vs_1way": True,  # asserted above
            "pi": round(pi, 8),
            "eps": round(eps, 8),
        }
        if caveat:
            row["efficiency_caveat"] = caveat
        print(json.dumps(row))


if __name__ == "__main__":
    main()
