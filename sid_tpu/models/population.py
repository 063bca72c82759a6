"""Population batches: joint calling over many samples (BASELINE config 5).

Two estimation modes over S samples' profile histograms:

- ``independent``: S separate Lynch fits, batched on device by vmapping the
  nmsimplex2 while-loop over the sample axis (lax.while_loop batching masks
  converged lanes), so 100 samples cost one compiled program.
- ``pooled`` (default): the sequencing error rate is a property of the
  platform, not the individual — fit (pi, eps) once on the *pooled*
  histogram (sufficient statistics add across samples), then hold eps fixed
  and fit each sample's heterozygosity pi with a batched 1-D nmsimplex.

Per-sample genotype calls then run through the standard per-method
machinery with the sample's (pi, eps) as the model state.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sid_tpu.config import Options
from sid_tpu.models.common import CallResult
from sid_tpu.ops import likelihoods
from sid_tpu.ops.lgamma import lgamma_int_table, table_size
from sid_tpu.ops.nmsimplex import minimize_nmsimplex2_jax
from sid_tpu.ops.profiles import (
    filter_min_coverage,
    nucleotide_distribution,
    unique_profiles,
)
from sid_tpu.parallel.distributed import merge_histograms
from sid_tpu.utils.padding import bucket_size, pad_axis0


@dataclasses.dataclass
class SampleFit:
    pi: float
    eps: float
    converged: bool


def _pad_stack(
    histograms: Sequence[Tuple[np.ndarray, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-sample (profiles, mult) into (S, U_pad, 4) / (S, U_pad).

    U_pad is the standard shape bucket (pow-2, 8192 floor — utils.padding),
    NOT the raw cohort maximum: every new cohort shape would otherwise be a
    fresh multi-minute remote compile on the real chip (CLAUDE.md: keep
    shapes in the existing buckets). Zero-mult padding rows are inert in the
    fit objective.
    """
    u_max = max((p.shape[0] for p, _ in histograms), default=1)
    u_pad = bucket_size(max(u_max, 1))
    s = len(histograms)
    profs = np.zeros((s, u_pad, 4), np.int32)
    mults = np.zeros((s, u_pad), np.int64)
    for i, (p, m) in enumerate(histograms):
        profs[i, : p.shape[0]] = p
        mults[i, : m.shape[0]] = m
    return profs, mults


@jax.jit
def _fit_pooled(pp, pm, pnt, ptab):
    """Jitted pooled-histogram 2-D fit (one trace per shape bucket; the
    eager while_loop re-traced its body on every cohort, ~0.8 s host)."""

    def objective(theta):
        return likelihoods.compound_neg_log_likelihood(theta, pp, pm, pnt, ptab)

    return minimize_nmsimplex2_jax(
        objective, jnp.asarray([1e-3, 1e-3]), jnp.asarray([1e-4, 1e-4])
    )


@jax.jit
def _fit_batched(profs, mults, nts, tab):
    """vmapped independent 2-D fits: (S,U,4),(S,U),(S,4) -> per-sample results."""

    def one(profiles, mult, nt):
        def objective(theta):
            return likelihoods.compound_neg_log_likelihood(
                theta, profiles, mult, nt, tab
            )

        return minimize_nmsimplex2_jax(
            objective, jnp.asarray([1e-3, 1e-3]), jnp.asarray([1e-4, 1e-4])
        )

    return jax.vmap(one)(profs, mults, nts)


def _fit_batched_shardmap(mesh, profs, mults, nts, tab):
    """Sample-axis shard_map around the vmapped independent fits.

    Under plain jit+GSPMD a sharded vmapped ``lax.while_loop`` must keep its
    (scalar) loop condition globally consistent, which inserts an all-reduce
    of the any-lane-unconverged predicate on EVERY iteration and locksteps
    all devices to the slowest sample. shard_map gives each device its own
    block of samples to fit with an independent while-loop: zero collectives,
    every device stops at its own block's convergence (the BASELINE config-5
    layout: embarrassingly parallel per-sample fits across a pod slice).
    Per-lane results are bitwise equal to the unsharded vmap (while-loop
    batching masks each lane independently of its batchmates).
    """
    from jax.sharding import PartitionSpec as P

    from sid_tpu.parallel.mesh import SITE_AXIS

    fn = jax.shard_map(
        _fit_batched,
        mesh=mesh,
        in_specs=(P(SITE_AXIS), P(SITE_AXIS), P(SITE_AXIS), P()),
        out_specs=P(SITE_AXIS),
        # the body is purely per-shard (no collectives); the vma check
        # rejects lax.cond branches that mix invariant initial-simplex
        # constants with varying fit state, so it is disabled. TODO: scope
        # the disable to the nmsimplex lax.cond once the vma checker learns
        # that pattern. With the check off, a collective accidentally added
        # inside _fit_batched would NOT be caught at trace time — the guard
        # is tests/test_population.py::test_sharded_fits_identical (bitwise
        # vmap-equality), which must stay in CI as long as check_vma=False.
        check_vma=False,
    )
    return jax.jit(fn)(profs, mults, nts, tab)


def _fit_pi_batched_shardmap(mesh, profs, mults, nts, eps, tab):
    """Sample-axis shard_map around the batched 1-D pi fits (see above)."""
    from jax.sharding import PartitionSpec as P

    from sid_tpu.parallel.mesh import SITE_AXIS

    fn = jax.shard_map(
        _fit_pi_batched,
        mesh=mesh,
        in_specs=(P(SITE_AXIS), P(SITE_AXIS), P(SITE_AXIS), P(), P()),
        out_specs=P(SITE_AXIS),
        check_vma=False,  # per-shard only; guarded by the same bitwise
        # vmap-equality test as _fit_batched_shardmap (see comment there)
    )
    return jax.jit(fn)(profs, mults, nts, eps, tab)


@jax.jit
def _fit_pi_batched(profs, mults, nts, eps, tab):
    """vmapped 1-D heterozygosity fits at a shared fixed error rate."""

    def one(profiles, mult, nt):
        def objective(theta):
            full = jnp.stack([theta[0], eps])
            return likelihoods.compound_neg_log_likelihood(
                full, profiles, mult, nt, tab
            )

        return minimize_nmsimplex2_jax(
            objective, jnp.asarray([1e-3]), jnp.asarray([1e-4])
        )

    return jax.vmap(one)(profs, mults, nts)


def fit_population(
    histograms: Sequence[Tuple[np.ndarray, np.ndarray]],
    mode: str = "pooled",
    diag=None,
    mesh_devices: Optional[int] = None,
) -> Tuple[List[SampleFit], Optional[SampleFit]]:
    """Fit the Lynch model over per-sample (cov>=4-filtered) histograms.

    Returns (per-sample fits, pooled fit or None). ``mode`` is "pooled" or
    "independent". With ``mesh_devices``, the vmapped per-sample fits shard
    over the SAMPLE axis of a device mesh (BASELINE config 5: 100-sample
    batches across a pod slice) — each device runs its samples' while-loops
    independently, zero collectives; the S axis is padded to a multiple of
    the mesh with inert all-zero histograms.
    """
    max_cov = max(
        (int(p.sum(-1).max()) for p, _ in histograms if p.shape[0]), default=0
    )
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
    profs, mults = _pad_stack(histograms)
    nts = np.stack([nucleotide_distribution(p, m) for p, m in histograms])

    s_real = len(histograms)
    mesh = None
    if mesh_devices is not None:
        from sid_tpu.parallel.mesh import make_site_mesh, row_sharding

        mesh = make_site_mesh(mesh_devices)
        n_dev = int(np.prod(mesh.devices.shape))
        s_pad = -(-s_real // n_dev) * n_dev
        if s_pad != s_real:
            profs = np.concatenate(
                [profs, np.zeros((s_pad - s_real,) + profs.shape[1:], profs.dtype)]
            )
            mults = np.concatenate(
                [mults, np.zeros((s_pad - s_real,) + mults.shape[1:], mults.dtype)]
            )
            # uniform nt keeps the inert lanes' objective finite
            nts = np.concatenate(
                [nts, np.full((s_pad - s_real, 4), 0.25, nts.dtype)]
            )
        profs = jax.device_put(profs, row_sharding(mesh, 3))
        mults = jax.device_put(mults, row_sharding(mesh, 2))
        nts = jax.device_put(nts, row_sharding(mesh, 2))

    pooled = None
    if mode == "pooled":
        pp, pm = merge_histograms(list(histograms))
        pnt = nucleotide_distribution(pp, pm)
        pmax = int(pp.sum(-1).max()) if pp.shape[0] else 0
        ptab = jnp.asarray(lgamma_int_table(table_size(pmax)))
        # bucket-pad the pooled histogram too (zero-mult rows are inert)
        pp_pad = pad_axis0(np.asarray(pp, np.int32))
        pm_pad = pad_axis0(np.asarray(pm, np.int64))
        res = _fit_pooled(
            jnp.asarray(pp_pad), jnp.asarray(pm_pad), jnp.asarray(pnt), ptab
        )
        pooled = SampleFit(float(res.x[0]), float(res.x[1]), bool(res.converged))
        if diag:
            diag(f"# pooled heterozygosity: {pooled.pi:.6e}")
            diag(f"# pooled error: {pooled.eps:.6e}")
        if mesh is not None:
            r = _fit_pi_batched_shardmap(
                mesh, jnp.asarray(profs), jnp.asarray(mults),
                jnp.asarray(nts), jnp.float64(pooled.eps), tab,
            )
        else:
            r = _fit_pi_batched(
                jnp.asarray(profs), jnp.asarray(mults), jnp.asarray(nts),
                jnp.float64(pooled.eps), tab,
            )
        xs, conv = np.asarray(r.x), np.asarray(r.converged)
        fits = [
            SampleFit(float(xs[i, 0]), pooled.eps, bool(conv[i]))
            for i in range(s_real)
        ]
    elif mesh is not None:
        r = _fit_batched_shardmap(
            mesh, jnp.asarray(profs), jnp.asarray(mults), jnp.asarray(nts),
            tab,
        )
        xs, conv = np.asarray(r.x), np.asarray(r.converged)
        fits = [
            SampleFit(float(xs[i, 0]), float(xs[i, 1]), bool(conv[i]))
            for i in range(s_real)
        ]
    else:
        r = _fit_batched(jnp.asarray(profs), jnp.asarray(mults), jnp.asarray(nts), tab)
        xs, conv = np.asarray(r.x), np.asarray(r.converged)
        fits = [
            SampleFit(float(xs[i, 0]), float(xs[i, 1]), bool(conv[i]))
            for i in range(s_real)
        ]
    return fits, pooled


def classify_sample_profiles(
    profiles: np.ndarray,
    mult: np.ndarray,
    fit: SampleFit,
    options: Options,
):
    """Per-class tables for one sample at its fitted (pi, eps).

    Returns (cls 5-tuple over classes, filtered: bool, conf_type). For the
    profile-deduplicated methods only; ``filtered`` says whether the class
    table covers the cov>=4-filtered profiles (bayes/likelihood_ratio omit
    filtered-out sites) or all profiles (local). Cohort callers
    (call_population*) use classify_population_profiles instead — it batches
    the device work for ALL samples into O(1) dispatches.
    """
    cls_list, filtered, conf_type = classify_population_profiles(
        [(profiles, mult)], [fit], options
    )
    return cls_list[0], filtered, conf_type


@jax.jit
def _classify_local_full_batched(profs, thr, alpha, priors, tab):
    """vmapped full local classify (device LRT) with per-sample priors."""
    from sid_tpu.models.local import classify_local

    def one(p, prior):
        return classify_local(p, thr, alpha, prior, tab)

    return jax.vmap(one)(profs, priors)


@jax.jit
def _marginals_batched(profs, epss, nts, tab):
    """vmapped marginal likelihoods: (S,U,4),(S,),(S,4) -> 2x (S,U) f64.

    One device dispatch covers every sample's class table — the per-sample
    kernels are elementwise over profiles, so vmap over the sample axis is
    bitwise-identical per lane to S separate calls (verified on CPU) while
    collapsing ~2S dispatches into one (the structural analogue of
    _fit_batched for the classify half).
    Reference semantics per sample: call.cpp:62-211.
    """

    def one(p, e, nt):
        return (
            likelihoods.log_hom_marginal(p, e, nt, tab),
            likelihoods.log_het_marginal(p, e, nt, tab),
        )

    return jax.vmap(one)(profs, epss, nts)


def classify_population_profiles(
    per_sample: Sequence[Tuple[np.ndarray, np.ndarray]],
    fits: Sequence[SampleFit],
    options: Options,
):
    """Per-class tables for a whole cohort in O(1) device dispatches.

    ``per_sample`` is the UNFILTERED (profiles, mult) per sample;
    bayes/likelihood_ratio apply the cov>=4 filter internally (reference
    semantics). Returns (list of per-sample cls 5-tuples, filtered,
    conf_type). The device work — marginal likelihoods for bayes/LR, the
    slim fixed-allele kernel for local — runs as ONE bucket-padded
    (S, U_pad, ...) dispatch; per-sample priors, LRT and BH stay host-side
    per sample (BH's domain is each sample's own unique profiles,
    call.cpp:120-138).
    """
    method = options.method
    if method == "local":
        return _classify_local_population(per_sample, fits, options), False, "p_value"
    if method not in ("bayes", "likelihood_ratio"):
        raise ValueError(f"population mode does not support method {method!r}")

    filtered = [filter_min_coverage(p, m, 4)[:2] for p, m in per_sample]
    lhom, lhet = _population_marginals(filtered, fits, options)
    out = []
    for (fp, fm), fit, lh, lt in zip(filtered, fits, lhom, lhet):
        u = fp.shape[0]
        if method == "bayes":
            out.append(_bayes_post(fp, lh[:u], lt[:u], fit))
        else:
            out.append(_lr_post(fp, lh[:u], lt[:u], fit, options))
    if method == "bayes":
        return out, True, "probability"
    return out, True, "p_value"


def _population_marginals(
    filtered: Sequence[Tuple[np.ndarray, np.ndarray]],
    fits: Sequence[SampleFit],
    options: Options,
):
    """One batched device call for the cohort's (hom, het) marginal tables."""
    from sid_tpu.utils import profiling

    profs, mults = _pad_stack(filtered)
    nts = np.stack([nucleotide_distribution(p, m) for p, m in filtered])
    epss = np.array([f.eps for f in fits], np.float64)
    max_cov = max(
        (int(p.sum(-1).max()) for p, _ in filtered if p.shape[0]), default=0
    )
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))

    if options.mesh_devices is not None:
        from sid_tpu.parallel.mesh import make_site_mesh, row_sharding

        mesh = make_site_mesh(options.mesh_devices)
        n_dev = int(np.prod(mesh.devices.shape))
        s_real = profs.shape[0]
        s_pad = -(-s_real // n_dev) * n_dev
        if s_pad != s_real:
            profs = np.concatenate(
                [profs, np.zeros((s_pad - s_real,) + profs.shape[1:], profs.dtype)]
            )
            # benign values for the inert lanes (results are sliced away)
            nts = np.concatenate(
                [nts, np.full((s_pad - s_real, 4), 0.25, nts.dtype)]
            )
            epss = np.concatenate(
                [epss, np.full(s_pad - s_real, 0.01, epss.dtype)]
            )
        profs = jax.device_put(profs, row_sharding(mesh, 3))
        epss = jax.device_put(epss, row_sharding(mesh, 1))
        nts = jax.device_put(nts, row_sharding(mesh, 2))
    with profiling.device_stage("population_marginals"):
        lhom, lhet = _marginals_batched(
            jnp.asarray(profs), jnp.asarray(epss), jnp.asarray(nts), tab
        )
        lhom = np.asarray(lhom)
        lhet = np.asarray(lhet)
    return lhom, lhet


def _classify_local_population(per_sample, fits, options):
    """Cohort ``local`` tables: host-LD per sample when that path is free of
    device work anyway, else ONE batched slim-kernel dispatch."""
    import os

    from sid_tpu.models.local import classify_profiles_local

    max_u = int(os.environ.get("SIDTPU_EXACT_LOCAL_MAX_U", "1000000"))
    host_ld = (
        options.mesh_devices is None
        and options.exact_pvalues
        and all(0 < p.shape[0] <= max_u for p, _ in per_sample)
    )
    if host_ld:
        # the native long-double classifier dispatches nothing: the
        # per-sample loop is already O(0) device round trips (and byte-equal
        # to the oracle by construction) — keep it (models/local.py)
        return [
            classify_profiles_local(p, options, fit.pi, None)
            for (p, _), fit in zip(per_sample, fits)
        ]
    return _classify_local_batched(per_sample, fits, options)


def _classify_local_batched(per_sample, fits, options):
    """Batched slim local kernel over (S, U_pad): one dispatch, host LRT.

    Mirrors models/local.classify_profiles_local's slim branch (the kernels
    are elementwise with leading batch axes); the per-sample fitted prior is
    applied host-side after the kernel, exactly as the slim path does.
    """
    from sid_tpu.models import common
    from sid_tpu.models.local import (
        _local_log_likelihoods_ds_jit,
        local_log_likelihoods,
    )
    from sid_tpu.ops import stats
    from sid_tpu.ops.likelihoods_ds import device_precision
    from sid_tpu.utils import profiling

    profs, _ = _pad_stack(per_sample)
    s, u_pad = profs.shape[0], profs.shape[1]
    flat = profs.reshape(-1, 4).astype(np.int64)
    major, second = common.major_allele_indices_np(flat)
    major = major.reshape(s, u_pad)
    second = second.reshape(s, u_pad)
    max_cov = max(
        (int(p.sum(-1).max()) for p, _ in per_sample if p.shape[0]), default=0
    )
    arrays = [profs, major, second]
    if options.mesh_devices is not None:
        from sid_tpu.parallel.mesh import make_site_mesh, row_sharding

        mesh = make_site_mesh(options.mesh_devices)
        n_dev = int(np.prod(mesh.devices.shape))
        if s % n_dev != 0:
            s_pad = -(-s // n_dev) * n_dev
            arrays = [
                np.concatenate(
                    [a, np.zeros((s_pad - s,) + a.shape[1:], a.dtype)]
                )
                for a in arrays
            ]
        arrays = [
            jax.device_put(a, row_sharding(mesh, a.ndim)) for a in arrays
        ]
    profs_d, major_d, second_d = (jnp.asarray(a) for a in arrays)
    if not options.exact_pvalues:
        # device-LRT flavor: vmap the full classify kernel with per-sample
        # priors (same erfc path per lane as classify_local standalone)
        from sid_tpu.models.local import classify_local

        tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
        priors = np.array([f.pi for f in fits], np.float64)
        if priors.shape[0] != profs_d.shape[0]:  # mesh S padding
            priors = np.concatenate(
                [priors, np.zeros(profs_d.shape[0] - priors.shape[0])]
            )
        with profiling.device_stage("population_classify_local"):
            out_dev = _classify_local_full_batched(
                profs_d,
                jnp.float64(options.site_error_threshold),
                jnp.float64(options.significance_level),
                jnp.asarray(priors),
                tab,
            )
            is_het_b, major_b, second_b, p1_b, p2_b = (
                np.asarray(o) for o in out_dev[:5]
            )
        return [
            (
                is_het_b[i, : p.shape[0]],
                major_b[i, : p.shape[0]],
                second_b[i, : p.shape[0]],
                p1_b[i, : p.shape[0]],
                p2_b[i, : p.shape[0]],
            )
            for i, (p, _) in enumerate(per_sample)
        ]
    if device_precision() == "ds" and options.exact_pvalues:
        from sid_tpu.ops.likelihoods_ds import lgamma_table_ds, log_int_table_ds

        tsize = table_size(max_cov)
        with profiling.device_stage("population_local_ds"):
            l1, l2 = _local_log_likelihoods_ds_jit(
                profs_d, major_d, second_d,
                jnp.float64(options.site_error_threshold),
                log_int_table_ds(tsize), lgamma_table_ds(tsize),
            )
            l1 = np.asarray(l1)
            l2 = np.asarray(l2)
    else:
        tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
        with profiling.device_stage("population_local"):
            l1, l2 = local_log_likelihoods(
                profs_d, major_d, second_d,
                jnp.float64(options.site_error_threshold), tab,
            )
            l1 = np.asarray(l1)
            l2 = np.asarray(l2)

    out = []
    for i, ((p, _), fit) in enumerate(zip(per_sample, fits)):
        u = p.shape[0]
        a, b = l1[i, :u].copy(), l2[i, :u].copy()
        if fit.pi > 0:
            a = a + np.log(np.float64(1.0 - fit.pi))
            b = b + np.log(np.float64(fit.pi))
        p1 = stats.lrt_pvalue_from_logs_np(b, a)
        p2 = stats.lrt_pvalue_from_logs_np(a, b)
        with np.errstate(invalid="ignore"):
            is_het = (b > a) & (p2 < options.significance_level)
        out.append((is_het, major[i, :u], second[i, :u], p1, p2))
    return out


def call_population(
    batches: Sequence,
    options: Options,
    mode: str = "pooled",
    diag=None,
) -> List[CallResult]:
    """Per-sample genotype calls with population-level model fitting.

    All four methods: local uses the sample's fitted pi as prior (-R
    semantics), bayes/likelihood_ratio classify at the sample's (pi, eps),
    quality (per-site) uses the fitted pi as its SNP prior.
    """
    from sid_tpu.models import common
    histograms = []
    uniques = []
    for b in batches:
        p, m, inv = unique_profiles(b.counts)
        uniques.append((p, m, inv))
        fp, fm, _ = filter_min_coverage(p, m, 4)
        histograms.append((fp, fm))

    fits, pooled = fit_population(
        histograms, mode=mode, diag=diag, mesh_devices=options.mesh_devices
    )

    results = []
    if options.method == "quality":
        # per-site method: classification is per read column, so each sample
        # runs through call_quality with its fitted pi as the SNP prior
        from sid_tpu.models.quality import call_quality

        for b, fit in zip(batches, fits):
            opts = dataclasses.replace(
                options, estimate_prior=False, snp_prior=fit.pi
            )
            results.append(call_quality(b, opts))
        return results
    # cohort classify: ONE batched device dispatch for all samples' class
    # tables (the fits above are likewise batched), then per-sample joins
    cls_list, filtered, conf_type = classify_population_profiles(
        [(p, m) for p, m, _ in uniques], fits, options
    )
    for b, (p, m, inv), cls in zip(batches, uniques, cls_list):
        keep = filter_min_coverage(p, m, 4)[2] if filtered else None
        results.append(
            common.gather_result(b, conf_type, inv, *cls, keep_u=keep)
        )
    return results


def call_population_streaming(
    paths: Sequence[str],
    options: Options,
    mode: str = "pooled",
    diag=None,
    chunk_bytes: int = 64 << 20,
) -> List[int]:
    """Streamed population calling: 100 samples without RAM-resident parses.

    Pass 1 folds each sample into its unique-profile histogram
    (accumulate_histogram); the population fit runs on the tiny histograms;
    pass 2 re-parses each sample chunk-by-chunk, classifying through the
    per-class join (or per-site quality calls) and appending to
    ``<path>.calls.csv``. Returns per-sample record counts.
    """
    from sid_tpu.io.pileup import parse_pileup
    from sid_tpu.io.stream import accumulate_histogram, iter_chunks, pack_profiles
    from sid_tpu.models import common

    full_hists = []
    for p in paths:
        profiles, mult, _ = accumulate_histogram(p, chunk_bytes, options.io_backend)
        full_hists.append((profiles, mult))
    filtered_hists = [
        filter_min_coverage(p, m, 4)[:2] for p, m in full_hists
    ]
    fits, pooled = fit_population(
        filtered_hists, mode=mode, diag=diag, mesh_devices=options.mesh_devices
    )

    needs_reads = options.method == "quality"
    if not needs_reads:
        # cohort classify up front: one batched device dispatch covers every
        # sample's class table before the chunked pass-2 re-parses begin
        cls_all, filtered, conf_type = classify_population_profiles(
            full_hists, fits, options
        )
    counts = []
    for i, (path, (profiles, mult), fit) in enumerate(
        zip(paths, full_hists, fits)
    ):
        out_path = path + ".calls.csv"
        emitted = 0
        if needs_reads:
            from sid_tpu.models.quality import call_quality

            opts = dataclasses.replace(
                options, estimate_prior=False, snp_prior=fit.pi
            )
            cls = keys = None
        else:
            cls = cls_all[i]
            src = filter_min_coverage(profiles, mult, 4)[0] if filtered else profiles
            keys = pack_profiles(src)
        with open(out_path, "wb") as out:
            out.write((common.CSV_HEADER + "\n").encode())
            for chunk in iter_chunks(path, chunk_bytes):
                batch = parse_pileup(
                    chunk, needs_reads, needs_reads, backend=options.io_backend
                )
                if batch.num_sites == 0:
                    continue
                if needs_reads:
                    res = call_quality(batch, opts)
                else:
                    res = common.join_class_table(batch, keys, cls, conf_type)
                out.write(res.to_csv_bytes(include_header=False))
                emitted += res.num_records
        if diag:
            diag(f"# wrote {out_path} ({emitted} records)")
        counts.append(emitted)
    return counts


def _classify_lr_fixed(profiles, mult, fit: SampleFit, options: Options):
    """likelihood_ratio per-class classification at a fixed (pi, eps).

    Reference semantics per sample (call.cpp:62-143): marginal likelihoods
    at the fitted error rate, optional -R prior weighting by the sample's
    pi, two LRT p-values, BH correction across the sample's own unique
    profiles, het iff adjusted p2 < alpha. Single-sample entry point (the
    cohort path dispatches the marginals batched and shares _lr_post).
    """
    u = profiles.shape[0]
    nt = nucleotide_distribution(profiles, mult)
    max_cov = int(profiles.sum(-1).max()) if u else 0
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
    # bucket-padded device call (shape discipline: one compile per bucket)
    prof = jnp.asarray(pad_axis0(np.asarray(profiles, np.int32)))
    log_l_hom = np.asarray(
        likelihoods.log_hom_marginal(prof, jnp.float64(fit.eps), nt, tab)
    )[:u]
    log_l_het = np.asarray(
        likelihoods.log_het_marginal(prof, jnp.float64(fit.eps), nt, tab)
    )[:u]
    return _lr_post(profiles, log_l_hom, log_l_het, fit, options)


def _lr_post(profiles, log_l_hom, log_l_het, fit: SampleFit, options: Options):
    """Host half of the LR classification: prior, LRT, per-sample BH."""
    from sid_tpu.models import common
    from sid_tpu.ops import stats

    log_l_hom = common.clamp_ld_underflow_np(log_l_hom)
    log_l_het = common.clamp_ld_underflow_np(log_l_het)
    if options.estimate_prior and fit.pi > 0:
        with np.errstate(divide="ignore"):
            log_l_het = common.clamp_ld_underflow_np(log_l_het + np.log(fit.pi))
            log_l_hom = common.clamp_ld_underflow_np(log_l_hom + np.log(1.0 - fit.pi))
    if options.exact_pvalues:
        # host LRT + host BH (default): like the main LR method, zero device
        # round trips after the likelihood kernels
        p1 = stats.lrt_pvalue_from_logs_np(log_l_het, log_l_hom)
        p2 = stats.lrt_pvalue_from_logs_np(log_l_hom, log_l_het)
        adj_p1 = stats.adjust_benjamini_hochberg_np(p1)
        adj_p2 = stats.adjust_benjamini_hochberg_np(p2)
    else:
        p1 = stats.lrt_pvalue_from_logs(jnp.asarray(log_l_het), jnp.asarray(log_l_hom))
        p2 = stats.lrt_pvalue_from_logs(jnp.asarray(log_l_hom), jnp.asarray(log_l_het))
        adj_p1 = np.asarray(stats.adjust_benjamini_hochberg(p1))
        adj_p2 = np.asarray(stats.adjust_benjamini_hochberg(p2))
    is_het = adj_p2 < options.significance_level
    major, second = common.major_allele_indices_np(profiles)
    return is_het, major, second, adj_p1, adj_p2


def _classify_bayes_fixed(profiles, mult, fit: SampleFit):
    """Bayes per-class classification at a fixed (pi, eps); single-sample
    entry (the cohort path dispatches the marginals batched + _bayes_post)."""
    u = profiles.shape[0]
    # nucleotide distribution from the sample's own filtered histogram
    nt = nucleotide_distribution(profiles, mult)
    max_cov = int(profiles.sum(-1).max()) if u else 0
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
    # bucket-padded device call (shape discipline: one compile per bucket)
    prof = jnp.asarray(pad_axis0(np.asarray(profiles, np.int32)))
    log_l_hom = np.asarray(
        likelihoods.log_hom_marginal(prof, jnp.float64(fit.eps), nt, tab)
    )[:u]
    log_l_het = np.asarray(
        likelihoods.log_het_marginal(prof, jnp.float64(fit.eps), nt, tab)
    )[:u]
    return _bayes_post(profiles, log_l_hom, log_l_het, fit)


def _bayes_post(profiles, log_l_hom, log_l_het, fit: SampleFit):
    """Host half of the Bayes classification: posterior odds at (pi, eps)."""
    from sid_tpu.models import common

    pi = fit.pi
    log_apost_hom = log_l_hom + np.log(np.float64(1.0 - pi))
    log_apost_het = (
        log_l_het + np.log(np.float64(pi)) if pi > 0 else np.full_like(log_l_hom, -np.inf)
    )
    with np.errstate(invalid="ignore", over="ignore"):
        mx = np.maximum(log_apost_hom, log_apost_het)
        wh = np.exp(log_apost_hom - mx)
        wt = np.exp(log_apost_het - mx)
        denom = wh + wt
        prob_hom = wh / denom
        prob_het = wt / denom
        is_het = prob_het > prob_hom
    major, second = common.major_allele_indices_np(profiles)
    return is_het, major, second, prob_hom, prob_het
