"""Method ``quality``: per-read Phred-quality genotype likelihoods.

Reference: callQualityBasedSimple (call.cpp:291-372) — the only per-site
(not per-profile) method and the reference's only OpenMP-parallel loop. Per
read j: error = 10^(-min(bq_j, mq_j)/10); log P(hom) accumulates
ln(1-e)/ln(e) by major-allele match, log P(het) accumulates ln(1-2e/3) /
ln(2e/3) by top-2 match, plus an allele-balance log-binomial; LRT p-values;
het iff p2 < alpha. Every input site is emitted in order.

Work split: the per-read stage is a pure 256-entry table lookup + masked
sorted-segment sum — memory-bound host work (Phred values are integers, so
every transcendental collapses into the table; the sequential
np.add.reduceat matches the reference's per-site accumulation order
exactly). The per-site finalization (allele-balance binomial, LRT via erfc,
thresholds) is elementwise f64, on the host for one device and on the
device, sharded over the site mesh, for an explicit mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sid_tpu.config import Options
from sid_tpu.models import common
from sid_tpu.ops import stats
from sid_tpu.ops.lgamma import lgamma_int_table, table_size
from sid_tpu.ops.profiles import unique_profiles
from sid_tpu.utils.padding import pad_axis0

_TERM_TABLE = None


def quality_term_tables() -> np.ndarray:
    """(256, 4) f64 table of per-read log terms by Phred value q.

    Columns: [ln(1-e), ln(e), ln(1-2e/3), ln(2e/3)] with e = 10^(-q/10)
    (call.cpp:331-342 computes these per read).
    """
    global _TERM_TABLE
    if _TERM_TABLE is None:
        q = np.arange(256, dtype=np.float64)
        e = np.power(10.0, q / -10.0)
        with np.errstate(divide="ignore"):
            _TERM_TABLE = np.stack(
                [np.log(1.0 - e), np.log(e), np.log(1.0 - 2.0 / 3.0 * e),
                 np.log(2.0 / 3.0 * e)], axis=1,
            )
    return _TERM_TABLE


def accumulate_read_terms(batch, major: np.ndarray, second: np.ndarray):
    """Host per-read stage: (log_hom, log_het) sums per site, f64.

    Table-lookup terms, masked by major/top-2 membership, reduced per site
    with np.add.reduceat. This is the fallback when the native parser is
    unavailable: the production path computes the same sums inline during
    the threaded parse (native/parser.cpp) in the reference's strict
    per-read order. reduceat's pairwise partial sums can differ from that
    order in the last ulps (no cancellation is possible — all terms share a
    sign — so the difference is bounded by O(n_reads * eps)).
    """
    n = batch.num_sites
    offsets = batch.read_offsets
    lens = np.diff(offsets)
    site_of_read = np.repeat(np.arange(n, dtype=np.int64), lens)
    minq = np.minimum(batch.read_bq, batch.read_mq).astype(np.int64)
    code = batch.read_code.astype(np.int64)

    tab = quality_term_tables()
    rows = tab[minq]  # (R, 4)
    is_major = code == major[site_of_read]
    is_top2 = is_major | (code == second[site_of_read])
    hom_terms = np.where(is_major, rows[:, 0], rows[:, 1])
    het_terms = np.where(is_top2, rows[:, 2], rows[:, 3])

    log_hom = np.zeros(n, np.float64)
    log_het = np.zeros(n, np.float64)
    nonempty = lens > 0
    if hom_terms.size:
        starts = offsets[:-1][nonempty]
        log_hom[nonempty] = np.add.reduceat(hom_terms, starts)
        log_het[nonempty] = np.add.reduceat(het_terms, starts)
    return log_hom, log_het


@jax.jit
def finalize_quality_het(
    counts: jnp.ndarray,  # (N, 4) uint16/int32 (padded)
    major: jnp.ndarray,
    second: jnp.ndarray,
    log_het: jnp.ndarray,  # (N,) f64 per-site het sums
    lgamma_tab: jnp.ndarray,
):
    """Device half of the sharded finalize: ONLY the het side needs the
    device (allele-balance binomial from counts, call.cpp:344-347); the hom
    side is a clamp + one scalar prior log the host does bitwise-identically,
    so shipping log_hom up and both post-prior logs back would double the
    transfer bytes for no compute. Returns clamp(log_het + binom) — the
    prior add runs host-side after (same f64 add, bitwise equal)."""
    counts = counts.astype(jnp.int32)
    n = jnp.take_along_axis(counts, major[:, None].astype(jnp.int32), 1)[:, 0] + (
        jnp.take_along_axis(counts, second[:, None].astype(jnp.int32), 1)[:, 0]
    )
    k = jnp.take_along_axis(counts, second[:, None].astype(jnp.int32), 1)[:, 0]
    return finalize_quality_het_nk(n, k, log_het, lgamma_tab)


@jax.jit
def finalize_quality_het_nk(
    n: jnp.ndarray,  # (N,) top-2 count sum (uint16/int32, padded)
    k: jnp.ndarray,  # (N,) second-allele count
    log_het: jnp.ndarray,  # (N,) f64 per-site het sums
    lgamma_tab: jnp.ndarray,
):
    """Narrowest device half: the binomial only reads (n, k) = (top-2 sum,
    second count), so the production sharded path ships those two narrow
    planes instead of the full (N, 4) counts + two index planes — another
    third off the h2d bytes on top of the het-only split. Host computes
    n/k from counts bitwise-identically (exact integer gathers)."""
    n = n.astype(jnp.int32)
    k = k.astype(jnp.int32)
    log_het = log_het + stats.log_binomial_coefficient(n, k, lgamma_tab) - (
        n.astype(jnp.float64) * jnp.log(2.0)
    )
    return common.clamp_ld_underflow(log_het)


@jax.jit
def finalize_quality(
    counts: jnp.ndarray,  # (N, 4) int32 (padded)
    major: jnp.ndarray,
    second: jnp.ndarray,
    log_hom: jnp.ndarray,  # (N,) f64 per-site sums
    log_het: jnp.ndarray,
    snp_prior: jnp.ndarray,
    significance_level: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
):
    """Per-site finalization (call.cpp:344-369), elementwise on device."""
    counts = counts.astype(jnp.int32)
    # allele-balance binomial: ln C(n1+n2, n2) - (n1+n2) ln 2
    n = jnp.take_along_axis(counts, major[:, None], 1)[:, 0] + (
        jnp.take_along_axis(counts, second[:, None], 1)[:, 0]
    )
    k = jnp.take_along_axis(counts, second[:, None], 1)[:, 0]
    log_het = log_het + stats.log_binomial_coefficient(n, k, lgamma_tab) - (
        n.astype(jnp.float64) * jnp.log(2.0)
    )

    # the reference exponentiates into linear long double before the LRT;
    # values below the 80-bit underflow line become exactly 0 there
    log_pp1 = common.clamp_ld_underflow(log_hom)
    log_pp2 = common.clamp_ld_underflow(log_het)
    prior_on = snp_prior > 0
    log_pp1 = log_pp1 + jnp.where(prior_on, jnp.log(1.0 - snp_prior), 0.0)
    log_pp2 = log_pp2 + jnp.where(prior_on, jnp.log(snp_prior), 0.0)

    p1 = stats.lrt_pvalue_from_logs(log_pp2, log_pp1)
    p2 = stats.lrt_pvalue_from_logs(log_pp1, log_pp2)
    is_het = p2 < significance_level
    # post-prior logs ride along so exact_pvalues can redo the LRT on host
    return is_het, p1, p2, log_pp1, log_pp2


def finalize_quality_np(
    counts: np.ndarray,
    major: np.ndarray,
    second: np.ndarray,
    log_hom: np.ndarray,
    log_het: np.ndarray,
    snp_prior: float,
    lgamma_tab: np.ndarray,
):
    """Host finalization, operation-for-operation the device kernel.

    All the arithmetic here is elementary IEEE f64 (table gathers,
    add/mul/compare) except the prior logs, which use glibc log — the same
    libm the long-double oracle uses. Used on single-device runs; sharded
    runs keep the device kernel.
    """
    counts = counts.astype(np.int64)
    idx = np.arange(counts.shape[0])
    n = counts[idx, major] + counts[idx, second]
    k = counts[idx, second]
    log_c = lgamma_tab[n + 1] - lgamma_tab[n - k + 1] - lgamma_tab[k + 1]
    log_het = log_het + log_c - n.astype(np.float64) * np.log(2.0)

    log_pp1 = common.clamp_ld_underflow_np(log_hom)
    log_pp2 = common.clamp_ld_underflow_np(log_het)
    if snp_prior > 0:
        log_pp1 = log_pp1 + np.log(np.float64(1.0 - snp_prior))
        log_pp2 = log_pp2 + np.log(np.float64(snp_prior))
    return log_pp1, log_pp2


def _quality_finalize_native(
    counts, major, second, log_hom, log_het, snp_prior, alpha, lgamma_tab
):
    """Fused native finalize+LRT (one threaded pass); None if unavailable."""
    import ctypes
    import os

    if os.environ.get("SIDTPU_NO_NATIVE_FINALIZE"):
        return None
    from sid_tpu.io.native import _load

    lib = _load()
    if lib is None or not hasattr(lib, "sidtpu_quality_finalize"):
        return None
    if not getattr(lib, "_sidtpu_qfin_configured", False):
        lib.sidtpu_quality_finalize.restype = ctypes.c_int
        lib.sidtpu_quality_finalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
        ]
        lib._sidtpu_qfin_configured = True
    n = int(np.shape(log_hom)[0])
    counts = np.ascontiguousarray(counts[:n], np.uint16)
    major = np.ascontiguousarray(major, np.int32)
    second = np.ascontiguousarray(second, np.int32)
    log_hom = np.ascontiguousarray(log_hom, np.float64)
    log_het = np.ascontiguousarray(log_het, np.float64)
    tab = np.ascontiguousarray(lgamma_tab, np.float64)
    use_prior = 1 if snp_prior > 0 else 0
    lp_hom = float(np.log(np.float64(1.0 - snp_prior))) if use_prior else 0.0
    lp_het = float(np.log(np.float64(snp_prior))) if use_prior else 0.0
    p1 = np.empty(n, np.float64)
    p2 = np.empty(n, np.float64)
    het = np.empty(n, np.uint8)
    rc = lib.sidtpu_quality_finalize(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        major.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        second.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        log_hom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        log_het.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tab.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        tab.shape[0],
        lp_hom,
        lp_het,
        use_prior,
        float(alpha),
        float(common.LONG_DOUBLE_UNDERFLOW_LOG),
        n,
        p1.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        p2.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        het.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        0,
    )
    if rc != 0:
        return None
    return het.astype(bool), p1, p2


@jax.jit
def _finalize_quality_ds_jit(
    counts, major, second, log_hom, log_het, snp_prior, lgamma_tab_ds
):
    """Jitted double-single quality finalize (likelihoods_ds spec)."""
    from sid_tpu.ops.likelihoods_ds import finalize_quality_logs_ds

    return finalize_quality_logs_ds(
        counts, major, second, log_hom, log_het, snp_prior, lgamma_tab_ds
    )


@jax.jit
def _finalize_quality_het_ds_jit(counts, major, second, log_het, lgamma_tab_ds):
    """Jitted DS het-only finalize (transfer-lean sharded path)."""
    from sid_tpu.ops.likelihoods_ds import finalize_quality_het_ds

    return finalize_quality_het_ds(counts, major, second, log_het, lgamma_tab_ds)


@jax.jit
def _finalize_quality_het_nk_ds_jit(n, k, log_het, lgamma_tab_ds):
    """Jitted DS (n, k)-plane finalize (the narrowest sharded path)."""
    from sid_tpu.ops.likelihoods_ds import finalize_quality_het_nk_ds

    return finalize_quality_het_nk_ds(n, k, log_het, lgamma_tab_ds)


def call_quality(batch, options: Options, diag=None) -> common.CallResult:
    from sid_tpu.utils import profiling

    n = batch.num_sites
    snp_prior = options.snp_prior
    if options.estimate_prior:
        from sid_tpu.models.lynch import estimate_prior_heterozygosity

        profiles, mult, _ = unique_profiles(batch.counts)
        snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)

    if batch.q_log_hom is not None:
        # the native parser accumulated the per-read terms inline (same
        # table, same order — bitwise equal to accumulate_read_terms)
        major, second = batch.q_major, batch.q_second
        log_hom, log_het = batch.q_log_hom, batch.q_log_het
    else:
        counts64 = batch.counts.astype(np.int64)
        major, second = common.major_allele_indices_np(counts64)
        log_hom, log_het = accumulate_read_terms(batch, major, second)

    if options.mesh_devices is None and options.exact_pvalues:
        # single-device path: the finalization is elementary elementwise f64
        # — host-side it costs ~30 ms/M sites and zero transfers. The fused
        # native kernel (one threaded pass) is bitwise-identical to the
        # numpy composition below (tests/test_quality_finalize_native.py).
        max_cov = int(batch.counts.sum(-1).max()) if n else 0
        tab_np = lgamma_int_table(table_size(2 * max_cov))
        fused = _quality_finalize_native(
            batch.counts, major[:n], second[:n], log_hom[:n], log_het[:n],
            snp_prior, options.significance_level, tab_np,
        )
        if fused is not None:
            is_het, p1, p2 = fused
        else:
            lpp1, lpp2 = finalize_quality_np(
                batch.counts, major[:n], second[:n], log_hom[:n], log_het[:n],
                snp_prior, tab_np,
            )
            p1 = stats.lrt_pvalue_from_logs_np(lpp2, lpp1)
            p2 = stats.lrt_pvalue_from_logs_np(lpp1, lpp2)
            with np.errstate(invalid="ignore"):
                is_het = p2 < options.significance_level
        return common.CallResult(
            chrom_id=batch.chrom_id,
            chrom_table=batch.chrom_table,
            pos=batch.pos,
            is_het=is_het,
            major=major[:n].astype(np.int32),
            second=second[:n].astype(np.int32),
            conf_hom=p1,
            conf_het=p2,
            conf_type="p_value",
        )

    mesh = None
    if options.mesh_devices is not None:
        from sid_tpu.parallel.mesh import make_site_mesh, row_sharding

        mesh = make_site_mesh(options.mesh_devices)

    def pad(a):
        # a bucket the mesh divides, so every device holds rows
        return pad_axis0(a, multiple=1 if mesh is None else mesh.devices.size)

    def shard(arrays):
        if mesh is None:
            return arrays
        return [jax.device_put(a, row_sharding(mesh, a.ndim)) for a in arrays]

    log_het_p = pad(log_het)
    max_cov = int(batch.counts.sum(-1).max()) if n else 0
    tab = jnp.asarray(lgamma_int_table(table_size(2 * max_cov)))

    from sid_tpu.ops.likelihoods_ds import device_precision

    if options.exact_pvalues:
        # Sharded finalize, transfer-lean: only the HET side touches the
        # device, and the binomial reads nothing but (n, k) = (top-2 count
        # sum, second count) — two narrow integer planes computed on host
        # from exact integer gathers. The hom clamp and the two scalar prior
        # adds are elementary host f64, bitwise-identical to on-device adds.
        # h2d is (n, k, log_het), d2h one f64 plane.
        counts64 = batch.counts.astype(np.int64) if n else np.zeros((0, 4), np.int64)
        idx = np.arange(n)
        n_top2 = counts64[idx, major[:n]] + counts64[idx, second[:n]]
        k_sec = counts64[idx, second[:n]]
        nk_dtype = (
            np.uint16 if (n == 0 or int(n_top2.max()) < 65536) else np.int32
        )
        n_p = pad(n_top2.astype(nk_dtype))
        k_p = pad(k_sec.astype(nk_dtype))
        arrays = shard([n_p, k_p, log_het_p])
        if device_precision() == "ds":
            from sid_tpu.ops.likelihoods_ds import lgamma_table_ds

            tab_ds = lgamma_table_ds(table_size(2 * max_cov))
            with profiling.device_stage("finalize_quality_het_ds"):
                dev = [jnp.asarray(a) for a in arrays]
                het_dev = _finalize_quality_het_nk_ds_jit(*dev, tab_ds)
                lpp2 = np.asarray(het_dev)[:n]  # d2h inside the stage
        else:
            with profiling.device_stage("finalize_quality_het"):
                dev = [jnp.asarray(a) for a in arrays]
                het_dev = finalize_quality_het_nk(*dev, tab)
                lpp2 = np.asarray(het_dev)[:n]  # d2h inside the stage
        lpp1 = common.clamp_ld_underflow_np(log_hom[:n])
        if snp_prior > 0:
            lpp1 = lpp1 + np.log(np.float64(1.0 - snp_prior))
            lpp2 = lpp2 + np.log(np.float64(snp_prior))
        p1 = stats.lrt_pvalue_from_logs_np(lpp2, lpp1)
        p2 = stats.lrt_pvalue_from_logs_np(lpp1, lpp2)
        is_het = p2 < options.significance_level
    else:
        # device-LRT flavor: full finalize kernel (narrow lossless dtypes)
        counts_src = batch.counts
        if counts_src.dtype != np.uint16 and n and int(counts_src.max()) < 65536:
            counts_src = counts_src.astype(np.uint16)
        elif counts_src.dtype != np.uint16:
            counts_src = counts_src.astype(np.int32)
        counts_p = pad(counts_src)
        major_p = pad(major.astype(np.int8))
        second_p = pad(second.astype(np.int8))
        log_hom_p = pad(log_hom)
        arrays = shard([counts_p, major_p, second_p, log_hom_p, log_het_p])
        with profiling.device_stage("finalize_quality"):
            dev = [jnp.asarray(a) for a in arrays]
            out = finalize_quality(
                *dev,
                jnp.float64(snp_prior),
                jnp.float64(options.significance_level),
                tab,
            )
            is_het = np.asarray(out[0])[:n]
            p1 = np.asarray(out[1])[:n]
            p2 = np.asarray(out[2])[:n]
    return common.CallResult(
        chrom_id=batch.chrom_id,
        chrom_table=batch.chrom_table,
        pos=batch.pos,
        is_het=is_het,
        major=major[:n].astype(np.int32),
        second=second[:n].astype(np.int32),
        conf_hom=p1,
        conf_het=p2,
        conf_type="p_value",
    )
