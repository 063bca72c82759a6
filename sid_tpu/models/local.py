"""Method ``local`` (the default): per-site maximum-likelihood error rates.

Reference: callSiteMLError (call.cpp:213-289). Per unique profile, plug-in
error rates — hom: (cov - n_major)/cov, het: 1.5*(cov - n1 - n2)/cov, both
capped at the -E threshold — feed the fixed-allele likelihood kernels; LRT
p-values (no multiple-testing correction); het iff l2 > l1 and p2 < alpha.
No coverage filter: every input site is emitted.

Device mapping: one fused elementwise kernel over the unique-profile axis
(vmapped log-space likelihoods + erfc), with U bucket-padded to stabilize
compiled shapes. Zero-coverage profiles reproduce the reference's NaN error
edge case (0/0 -> NaN -> powl(x,0)==1 semantics, call.cpp:243-254).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sid_tpu.config import Options
from sid_tpu.models import common
from sid_tpu.ops import likelihoods, stats
from sid_tpu.ops.lgamma import lgamma_int_table, table_size
from sid_tpu.ops.profiles import unique_profiles
from sid_tpu.utils.padding import pad_axis0


@functools.partial(jax.jit, static_argnames=("ld_parity",))
def classify_local(
    profiles: jnp.ndarray,
    error_threshold: jnp.ndarray,
    significance_level: jnp.ndarray,
    snp_prior: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
    ld_parity: bool = True,
):
    """Per-profile classification kernel (call.cpp:238-273), batched over U."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1).astype(jnp.float64)
    major, second = common.major_allele_indices(profiles)
    n1 = jnp.take_along_axis(profiles, major[..., None], -1)[..., 0].astype(jnp.float64)
    n2 = jnp.take_along_axis(profiles, second[..., None], -1)[..., 0].astype(jnp.float64)

    error1 = (cov - n1) / cov  # 0/0 -> NaN, reference edge case
    error1 = jnp.where(error1 > error_threshold, error_threshold, error1)
    l1 = likelihoods.log_hom_fixed(profiles, error1, major, lgamma_tab)

    error2 = 1.5 * (cov - n1 - n2) / cov
    error2 = jnp.where(error2 > error_threshold, error_threshold, error2)
    l2 = likelihoods.log_het_fixed(profiles, error2, major, second, lgamma_tab)

    if ld_parity:
        l1 = common.clamp_ld_underflow(l1)
        l2 = common.clamp_ld_underflow(l2)

    prior_on = snp_prior > 0
    l1 = l1 + jnp.where(prior_on, jnp.log(1.0 - snp_prior), 0.0)
    l2 = l2 + jnp.where(prior_on, jnp.log(snp_prior), 0.0)

    p1 = stats.lrt_pvalue_from_logs(l2, l1)
    p2 = stats.lrt_pvalue_from_logs(l1, l2)
    is_het = (l2 > l1) & (p2 < significance_level)
    # l1/l2 (post-prior) ride along so exact_pvalues can redo the LRT on host
    return is_het, major, second, p1, p2, l1, l2


@jax.jit
def local_log_likelihoods(
    profiles: jnp.ndarray,
    major: jnp.ndarray,
    second: jnp.ndarray,
    error_threshold: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
):
    """Transfer-lean local kernel: only the transcendental-heavy log
    likelihoods run on device; plug-in errors are recomputed on device from
    the profiles (elementary IEEE ops — bitwise equal to a host computation)
    and only (l1, l2) come back. Everything else (major selection, LRT,
    thresholds) is elementary host work that would only add transfer bytes
    on the device."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1).astype(jnp.float64)
    n1 = jnp.take_along_axis(profiles, major[..., None], -1)[..., 0].astype(jnp.float64)
    n2 = jnp.take_along_axis(profiles, second[..., None], -1)[..., 0].astype(jnp.float64)
    error1 = (cov - n1) / cov
    error1 = jnp.where(error1 > error_threshold, error_threshold, error1)
    l1 = likelihoods.log_hom_fixed(profiles, error1, major, lgamma_tab)
    error2 = 1.5 * (cov - n1 - n2) / cov
    error2 = jnp.where(error2 > error_threshold, error_threshold, error2)
    l2 = likelihoods.log_het_fixed(profiles, error2, major, second, lgamma_tab)
    return common.clamp_ld_underflow(l1), common.clamp_ld_underflow(l2)


@jax.jit
def _local_log_likelihoods_ds_jit(profiles, major, second, thr, log_tab, lgamma_tab):
    """Jitted double-single slim kernel (likelihoods_ds spec)."""
    from sid_tpu.ops.likelihoods_ds import local_fixed_log_likelihoods_ds

    return local_fixed_log_likelihoods_ds(
        profiles, major, second, thr, log_tab, lgamma_tab
    )


def classify_profiles_local(
    profiles: np.ndarray, options: Options, snp_prior: float, mesh_devices=None
):
    """Per-class local classification; returns 5 host arrays over U."""
    import os

    from sid_tpu.utils import profiling

    u = profiles.shape[0]
    max_u = int(os.environ.get("SIDTPU_EXACT_LOCAL_MAX_U", "1000000"))
    if mesh_devices is None and options.exact_pvalues and 0 < u <= max_u:
        # single-device path: run the whole per-profile loop in oracle
        # long-double arithmetic on host (native threaded kernel, byte-equal
        # to the exact engine BY CONSTRUCTION — the same pattern as the
        # "auto" exact fit). The device kernels below are the sharded-mesh
        # path. call.cpp:238-273.
        from sid_tpu.exact.lynch_ld import native_local_classify_ld

        major, second = common.major_allele_indices_np(profiles)
        with profiling.maybe_stage("host:local_classify_ld"):
            nat = native_local_classify_ld(
                profiles, major, second, options.site_error_threshold,
                snp_prior, options.significance_level,
            )
        if nat is not None:
            is_het, p1, p2 = nat
            return is_het, major, second, p1, p2
    max_cov = int(profiles.sum(-1).max()) if u else 0
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
    mesh = None
    if mesh_devices is not None:
        from sid_tpu.parallel.mesh import make_site_mesh, row_sharding

        mesh = make_site_mesh(mesh_devices)
    # pad to a bucket the mesh divides, so every device holds rows
    padded = pad_axis0(
        np.asarray(profiles, np.int32),
        multiple=1 if mesh is None else mesh.devices.size,
    )

    if options.exact_pvalues:
        # slim path (default): host major selection + prior + LRT; device
        # computes only the log likelihoods and ships 2 f64 arrays back
        major, second = common.major_allele_indices_np(padded.astype(np.int64))
        prof_dev = padded
        if mesh is not None:
            sh1 = row_sharding(mesh, 1)
            prof_dev = jax.device_put(padded, row_sharding(mesh, 2))
            major = jax.device_put(major, sh1)
            second = jax.device_put(second, sh1)
        from sid_tpu.ops.likelihoods_ds import device_precision

        if device_precision() == "ds":
            # double-single f32 kernel: transcendental-free (integer-log
            # table gathers + DS adds)
            from sid_tpu.ops.likelihoods_ds import (
                lgamma_table_ds,
                log_int_table_ds,
            )

            tsize = table_size(max_cov)
            with profiling.device_stage("local_log_likelihoods_ds"):
                l1, l2 = _local_log_likelihoods_ds_jit(
                    jnp.asarray(prof_dev),
                    jnp.asarray(major),
                    jnp.asarray(second),
                    jnp.float64(options.site_error_threshold),
                    log_int_table_ds(tsize),
                    lgamma_table_ds(tsize),
                )
                l1 = np.asarray(l1)[:u]
                l2 = np.asarray(l2)[:u]
        else:
            with profiling.device_stage("local_log_likelihoods"):
                l1, l2 = local_log_likelihoods(
                    jnp.asarray(prof_dev),
                    jnp.asarray(major),
                    jnp.asarray(second),
                    jnp.float64(options.site_error_threshold),
                    tab,
                )
                l1 = np.asarray(l1)[:u]
                l2 = np.asarray(l2)[:u]
        major = np.asarray(major)[:u]
        second = np.asarray(second)[:u]
        if snp_prior > 0:
            # glibc log, matching the oracle's prior arithmetic
            l1 = l1 + np.log(np.float64(1.0 - snp_prior))
            l2 = l2 + np.log(np.float64(snp_prior))
        p1 = stats.lrt_pvalue_from_logs_np(l2, l1)
        p2 = stats.lrt_pvalue_from_logs_np(l1, l2)
        with np.errstate(invalid="ignore"):
            is_het = (l2 > l1) & (p2 < options.significance_level)
        return is_het, major, second, p1, p2

    # non-exact_pvalues branch: SIDTPU_DEVICE_PREC=ds is deliberately ignored
    # here (stays f64) — the DS kernels have no device erfc and require the
    # host-LRT flow (exact_pvalues), mirroring quality.py's guard. Placement
    # comparisons with exact_pvalues off therefore always measure f64.
    prof_dev = jnp.asarray(padded)
    if mesh is not None:
        prof_dev = jax.device_put(padded, row_sharding(mesh, 2))
    with profiling.device_stage("classify_local"):
        out = classify_local(
            prof_dev,
            jnp.float64(options.site_error_threshold),
            jnp.float64(options.significance_level),
            jnp.float64(snp_prior),
            tab,
        )
        is_het, major, second, p1, p2, l1, l2 = (np.asarray(o)[:u] for o in out)
    return is_het, major, second, p1, p2


def call_local(batch, options: Options, diag=None) -> common.CallResult:
    """End-to-end ``local`` call on a parsed batch (device compute path)."""
    profiles, mult, inverse = unique_profiles(batch.counts)
    u = profiles.shape[0]
    if u == 0:
        return common.gather_result(
            batch,
            "p_value",
            inverse,
            np.zeros(0, bool),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.float64),
            np.zeros(0, np.float64),
        )

    snp_prior = options.snp_prior
    if options.estimate_prior:
        from sid_tpu.models.lynch import estimate_prior_heterozygosity

        snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)

    cls = classify_profiles_local(profiles, options, snp_prior, options.mesh_devices)
    return common.gather_result(batch, "p_value", inverse, *cls)
