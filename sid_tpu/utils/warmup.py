"""Deliberate kernel-cache warmup (``sid-tpu --warm-cache``).

Instead of paying cold XLA compiles mid-run, the CLI offers a warmup
subcommand that compiles every production kernel shape bucket into the
persistent cache up front:

- all four calling methods' classify kernels (local/bayes/LR per-profile
  chains, quality per-site finalize),
- the Lynch fit ``lax.while_loop`` (via ``-R`` on likelihood_ratio and the
  bayes path),
- the lgamma table builders at their floor bucket.

Shape bucketing (utils/padding.bucket_size, floor 8192; ops/lgamma
floor 1024) means a small synthetic input compiles the *same* kernels a
production run uses, as long as the production unique-profile count stays
within the floor bucket; bigger inputs add at most log-many pow-2 buckets,
each a one-time compile.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from sid_tpu.config import Options

# deterministic ~30x synthetic sites: a rotating mix of hom/het/error
# profiles with both quality columns so the quality method's terms path
# compiles too. Small enough to parse in milliseconds; profile count is far
# below the 8192-row floor bucket.
_N_SITES = 2048


def _synthetic_pileup() -> bytes:
    bases = b"ACGT"
    lines = []
    for i in range(_N_SITES):
        ref = bases[i & 3]
        cov = 24 + (i % 13)
        n_err = i % 3
        n_second = (cov // 2) if i % 97 == 0 else 0
        n_major = cov - n_err - n_second
        col = (
            b"." * n_major
            + bases[(i + 1) & 3 : ((i + 1) & 3) + 1] * n_second
            + bases[(i + 2) & 3 : ((i + 2) & 3) + 1] * n_err
        )
        qual = bytes(33 + 20 + (j % 20) for j in range(cov))
        lines.append(
            b"chrW\t%d\t%c\t%d\t%s\t%s\t%s" % (i + 1, ref, cov, col, qual, qual)
        )
    return b"\n".join(lines) + b"\n"


def warm_cache(
    options: Options, log: Optional[Callable[[str], None]] = None
) -> int:
    """Compile all production kernels; returns the number of runs executed.

    Respects ``options.platform``/engine knobs so ``--platform cpu
    --warm-cache`` warms the CPU cache instead.
    """
    from sid_tpu import engine

    log = log or (lambda s: None)
    text = _synthetic_pileup()
    # (method, estimate_prior): -R on likelihood_ratio compiles the fit
    # loop + prior-weighted classify; bayes compiles the fit-with-posterior
    # path; local/quality compile the per-site kernels and erfc chain.
    plan = [
        # (method, estimate_prior, extra Options overrides, env overrides)
        ("local", False, {}, {}),
        ("quality", False, {}, {}),
        ("bayes", False, {}, {}),
        ("likelihood_ratio", True, {}, {}),
        ("local", True, {}, {}),  # -R local: fit-for-prior + capped-error classify
        # explicit device paths (defaults run these stages on host since r3):
        # the jitted Lynch fit while-loop, the full device local classify,
        # and the device quality finalize
        ("bayes", False, {"fit_backend": "device"}, {}),
        ("likelihood_ratio", True, {"fit_backend": "device"}, {}),
        ("local", False, {"exact_pvalues": False}, {}),
        ("quality", False, {"exact_pvalues": False}, {}),
        # forced-device configs (bench.py device_forced: mesh_devices=1
        # engages the sharded kernels + device fit on the single chip)
        ("local", False, {"mesh_devices": 1}, {}),
        ("quality", False, {"mesh_devices": 1}, {}),
        ("bayes", False, {"mesh_devices": 1}, {}),
        ("likelihood_ratio", True, {"mesh_devices": 1}, {}),
    ]
    import os

    from sid_tpu.ops.likelihoods_ds import ds_requested

    # the double-single kernels and the 1M-row microbench shapes serve only
    # SIDTPU_DEVICE_PREC=ds runs and bench.py's microbench, which no default
    # run takes
    warm_ds = ds_requested()
    if warm_ds:
        plan += [
            # double-single f32 device kernels (SIDTPU_DEVICE_PREC=ds): slim
            # local classify, quality finalize, and the DS fit while-loop
            ("local", False, {"mesh_devices": 1}, {"SIDTPU_DEVICE_PREC": "ds"}),
            ("quality", False, {"mesh_devices": 1}, {"SIDTPU_DEVICE_PREC": "ds"}),
            ("bayes", False, {"mesh_devices": 1}, {"SIDTPU_DEVICE_PREC": "ds"}),
            ("likelihood_ratio", True, {"mesh_devices": 1},
             {"SIDTPU_DEVICE_PREC": "ds"}),
        ]

    for method, est, extra, env in plan:
        opts = dataclasses.replace(
            options, method=method, estimate_prior=est, diagnostics=False,
            stream=False, population="", multihost=False, **extra,
        )
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        t0 = time.time()
        try:
            engine.run(text, opts, binary=True)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        flag = " -R" if est else ""
        suffix = "".join(f" {k}={v}" for k, v in extra.items())
        suffix += "".join(f" {k}={v}" for k, v in env.items())
        log(f"# warm {method}{flag}{suffix}: {time.time() - t0:.1f}s")

    # microbench / device-forced throughput shapes: the slim local kernel and
    # the quality finalize at the 1M-site bucket (2^20 rows), f64 and DS —
    # compiled directly so bench.py's kernel microbench is compile-free
    if warm_ds:
        _warm_microbench_shapes(log)

    # slim device local kernel (local_log_likelihoods): default single-device
    # local runs host long-double since r3, so force the device branch by
    # zeroing the exact-local cap — this bucket still serves meshes and
    # U > SIDTPU_EXACT_LOCAL_MAX_U inputs
    prev = os.environ.get("SIDTPU_EXACT_LOCAL_MAX_U")
    os.environ["SIDTPU_EXACT_LOCAL_MAX_U"] = "0"
    try:
        opts = dataclasses.replace(
            options, method="local", estimate_prior=False, diagnostics=False,
            stream=False, population="", multihost=False,
        )
        t0 = time.time()
        engine.run(text, opts, binary=True)
        log(f"# warm local slim-device: {time.time() - t0:.1f}s")
    finally:
        if prev is None:
            os.environ.pop("SIDTPU_EXACT_LOCAL_MAX_U", None)
        else:
            os.environ["SIDTPU_EXACT_LOCAL_MAX_U"] = prev
    return len(plan) + 1


MICROBENCH_U = 1 << 20  # the 1M-site shape bucket bench.py microbenches at


def microbench_inputs(n: int = MICROBENCH_U, seed: int = 0):
    """Deterministic 1M-row kernel inputs, device-put on a 1-device mesh.

    ``seed`` varies the CONTENT, never the shapes/dtypes, so the compiled
    executable is shared between variants.

    These are exactly the executables the device-forced e2e bench runs
    (mesh_devices=1, site axis sharded), so compiling them here makes
    bench.py's kernel microbench and 1M quality leg compile-free.

    ALL constant tables (f64 lgamma, DS log/lgamma splits) are device_put
    here, outside any timed region, so a timed call holds no host table
    build and no h2d transfer.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sid_tpu.models.common import major_allele_indices_np
    from sid_tpu.ops import ds
    from sid_tpu.ops.lgamma import lgamma_int_table
    from sid_tpu.ops.likelihoods_ds import lgamma_table_ds, log_int_table_ds
    from sid_tpu.parallel.mesh import make_site_mesh, row_sharding

    rng = np.random.default_rng(seed)
    profiles = rng.multinomial(30, [0.85, 0.08, 0.05, 0.02], (n,)).astype(np.int32)
    major, second = major_allele_indices_np(profiles.astype(np.int64))
    log_hom = rng.uniform(-40.0, -1.0, n)
    log_het = rng.uniform(-40.0, -1.0, n)
    idx = np.arange(n)
    n_top2 = (profiles[idx, major] + profiles[idx, second]).astype(np.uint16)
    k_sec = profiles[idx, second].astype(np.uint16)
    mesh = make_site_mesh(1)
    sh2 = row_sharding(mesh, 2)
    sh1 = row_sharding(mesh, 1)
    repl = NamedSharding(mesh, P())  # tables: replicated on the same mesh

    def put_ds(t: ds.DS) -> ds.DS:
        return ds.DS(jax.device_put(t.hi, repl), jax.device_put(t.lo, repl))

    return dict(
        profiles=jax.device_put(profiles, sh2),
        major=jax.device_put(major, sh1),
        second=jax.device_put(second, sh1),
        log_hom=jax.device_put(log_hom, sh1),
        log_het=jax.device_put(log_het, sh1),
        n_top2=jax.device_put(n_top2, sh1),
        k_sec=jax.device_put(k_sec, sh1),
        lgamma_tab=jax.device_put(
            jnp.asarray(lgamma_int_table(1023)), repl
        ),
        log_tab_ds=put_ds(log_int_table_ds(1024)),
        lgamma_tab_ds=put_ds(lgamma_table_ds(1024)),
    )


def microbench_kernels():
    """(name, callable) kernel list shared by warmup and bench.py.

    Each callable takes the microbench_inputs dict — every array AND table in
    it already device-resident — and returns device output to block on, so a
    timed call contains exactly one dispatch of the production executable and
    nothing else. Covers the slim local classify and the quality finalize as
    mesh-sharded executables, in f64, and in double-single too where
    ``ds_requested()``.
    """
    import jax.numpy as jnp

    from sid_tpu.ops.likelihoods_ds import ds_requested

    from sid_tpu.models.local import (
        _local_log_likelihoods_ds_jit,
        local_log_likelihoods,
    )
    from sid_tpu.models.quality import (
        _finalize_quality_ds_jit,
        _finalize_quality_het_nk_ds_jit,
        finalize_quality,
        finalize_quality_het_nk,
    )

    thr = 0.1
    entries = [
        (
            "local_log_likelihoods_f64",
            lambda a: local_log_likelihoods(
                a["profiles"], a["major"], a["second"], jnp.float64(thr),
                a["lgamma_tab"],
            ),
        ),
        (
            "local_log_likelihoods_ds",
            lambda a: _local_log_likelihoods_ds_jit(
                a["profiles"], a["major"], a["second"], jnp.float64(thr),
                a["log_tab_ds"], a["lgamma_tab_ds"],
            ),
        ),
        (
            "finalize_quality_f64",
            lambda a: finalize_quality(
                a["profiles"], a["major"], a["second"], a["log_hom"],
                a["log_het"], jnp.float64(-1.0), jnp.float64(0.05),
                a["lgamma_tab"],
            ),
        ),
        (
            "finalize_quality_ds",
            lambda a: _finalize_quality_ds_jit(
                a["profiles"], a["major"], a["second"], a["log_hom"],
                a["log_het"], jnp.float64(-1.0), a["lgamma_tab_ds"],
            ),
        ),
        # the transfer-lean (n, k)-plane finalize (the sharded production
        # path since r5; the full kernels above remain non-exact_pvalues)
        (
            "finalize_quality_het_f64",
            lambda a: finalize_quality_het_nk(
                a["n_top2"], a["k_sec"], a["log_het"], a["lgamma_tab"],
            ),
        ),
        (
            "finalize_quality_het_ds",
            lambda a: _finalize_quality_het_nk_ds_jit(
                a["n_top2"], a["k_sec"], a["log_het"], a["lgamma_tab_ds"],
            ),
        ),
    ]
    with_ds = ds_requested()
    return [(name, fn) for name, fn in entries if with_ds or not name.endswith("_ds")]


# On-device repetition harness: run a kernel K times inside ONE dispatch so
# per-execution time can be measured as (wall(K2) - wall(K1)) / (K2 - K1) —
# the dispatch floor, transfer latency and host overhead difference out
# exactly. The data dependency between iterations (a bump derived from the
# previous output, always 0 at runtime) stops XLA from collapsing the loop
# while leaving every iteration's values identical to a single production
# dispatch.
LOOP_K_SMALL = 8
LOOP_K_BIG = 264


def make_looped_kernel(fn, k: int):
    """jit(args -> scalar) running ``fn`` k times back-to-back on device.

    The iteration-to-iteration data dependency must touch an input the
    kernel actually READS, or XLA hoists the loop-invariant body and the
    loop measures nothing (caught r5: the (n, k)-plane finalize ignores
    ``major``, and a major-only bump collapsed its 264-iteration loop to
    one execution — 8- and 264-trip walls within 10%). The bump (always 0
    at runtime) is therefore added to EVERY integer-dtype input plane;
    every microbench kernel consumes at least one.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def looped(args):
        def body(_, carry):
            bump, acc = carry
            a2 = {
                name: (
                    v + bump.astype(v.dtype)
                    if getattr(v, "dtype", None) is not None
                    and v.dtype.kind in "iu"
                    else v
                )
                for name, v in args.items()
            }
            out = fn(a2)
            s = sum(
                jnp.sum(o.astype(jnp.float64))
                for o in jax.tree_util.tree_leaves(out)
            )
            # the bump must be UNPROVABLY zero, or XLA constant-folds it and
            # hoists the loop-invariant body so K iterations run as one.
            # The barrier hides s's provenance from the simplifier; isnan of
            # an opaque f64 cannot fold. (A genuinely NaN kernel output would
            # perturb later iterations' values — acceptable in a timing
            # harness; all microbench kernels produce finite sums.)
            s = jax.lax.optimization_barrier(s)
            bump = jnp.where(jnp.isnan(s), 1, 0).astype(jnp.int32)
            return bump, acc + s

        _, acc = jax.lax.fori_loop(
            0, k, body, (jnp.int32(0), jnp.float64(0.0))
        )
        return acc

    return looped


def _warm_microbench_shapes(log) -> None:
    """Compile the kernel-microbench shapes (bench.py device_microbench),
    including the K-iteration on-device loops the per-execution timing uses."""
    import jax

    args = microbench_inputs()
    for name, fn in microbench_kernels():
        t0 = time.time()
        jax.block_until_ready(fn(args))
        log(f"# warm {name}@{MICROBENCH_U}: {time.time() - t0:.1f}s")
        for k in (LOOP_K_SMALL, LOOP_K_BIG):
            t0 = time.time()
            jax.block_until_ready(make_looped_kernel(fn, k)(args))
            log(f"# warm {name}@{MICROBENCH_U} x{k} loop: "
                f"{time.time() - t0:.1f}s")
