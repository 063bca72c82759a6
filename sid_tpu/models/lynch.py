"""The Lynch (2008) genome-wide model fit, device path.

estimateProfileGenotypeLikelihoods (lynch.cpp:17-35) as one jitted program:
nmsimplex2 over the compound log-likelihood (start (1e-3, 1e-3), step 1e-4),
then per-profile log L_hom/L_het at the fitted epsilon. The objective is a
sum over the unique-profile axis — under a site-sharded mesh XLA turns that
reduction into a psum, which is the framework's only cross-shard collective
during fitting (SURVEY §5.8).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sid_tpu.config import Options
from sid_tpu.ops import likelihoods
from sid_tpu.ops.lgamma import lgamma_int_table, table_size
from sid_tpu.ops.nmsimplex import NmResult, minimize_nmsimplex2_jax
from sid_tpu.ops.profiles import filter_min_coverage, nucleotide_distribution
from sid_tpu.utils.padding import pad_axis0

DEFAULT_START = (1e-3, 1e-3)
DEFAULT_STEP = (1e-4, 1e-4)

# "auto" fit backend: ceiling on unique profiles for the exact host fit.
# The native long-double objective costs ~7 us/k-profiles/eval (2 threads);
# a 500k-profile fit is ~3 s — still noise against genome-scale parse time,
# and byte parity with the oracle is unconditional below this.
import os as _os

EXACT_FIT_MAX_U = int(_os.environ.get("SIDTPU_EXACT_FIT_MAX_U", "500000"))
# without libsidtpu the numpy longdouble objective is ~30x slower
_EXACT_FIT_MAX_U_NUMPY = 4096


def resolve_fit_backend(options: Options, u: int) -> str:
    """Resolve the "auto" fit backend (config.py fit_backend).

    Exact host fit — the byte-parity path — for single-mesh runs whenever it
    is cheap; the device psum fit for explicit meshes or very large
    histograms. Explicit "exact"/"device" are honored unchanged.
    """
    if options.fit_backend != "auto":
        return options.fit_backend
    if options.mesh_devices is not None:
        return "device"
    if u > EXACT_FIT_MAX_U:
        return "device"
    from sid_tpu.exact.lynch_ld import _native_lynch_lib

    if _native_lynch_lib() is None and u > _EXACT_FIT_MAX_U_NUMPY:
        return "device"
    return "exact"


@jax.jit
def fit_lynch(
    profiles: jnp.ndarray,
    mult: jnp.ndarray,
    nt: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
) -> Tuple[NmResult, jnp.ndarray, jnp.ndarray]:
    """Fit (pi, epsilon) and evaluate per-profile log likelihoods.

    Returns (NmResult, log_l_hom (U,), log_l_het (U,)). Zero-mult padding
    rows are inert in the objective and produce discardable likelihood rows.
    """

    def objective(theta):
        return likelihoods.compound_neg_log_likelihood(
            theta, profiles, mult, nt, lgamma_tab
        )

    res = minimize_nmsimplex2_jax(
        objective, jnp.asarray(DEFAULT_START), jnp.asarray(DEFAULT_STEP)
    )
    eps = res.x[1]
    log_l_hom = likelihoods.log_hom_marginal(profiles, eps, nt, lgamma_tab)
    log_l_het = likelihoods.log_het_marginal(profiles, eps, nt, lgamma_tab)
    return res, log_l_hom, log_l_het


@jax.jit
def fit_lynch_ds(
    profiles: jnp.ndarray,
    mult: jnp.ndarray,
    nt: jnp.ndarray,
    lgamma_tab_ds,
) -> Tuple[NmResult, jnp.ndarray, jnp.ndarray]:
    """``fit_lynch`` with double-single f32 device kernels (SIDTPU_DEVICE_PREC=ds).

    Same nmsimplex2 f64 loop (the simplex state is tiny scalar work); the
    per-profile objective and post-fit marginals run in DS arithmetic
    (ops/likelihoods_ds.py). The objective's profile-axis sum still lowers
    to a psum under a sharded mesh. Confidences derived from this fit agree
    with the f64 path to ~1e-13 relative (not bitwise; the trajectory may
    part at branch ties).
    """
    from sid_tpu.ops import ds as _ds
    from sid_tpu.ops import likelihoods_ds as _lds

    def objective(theta):
        return _lds.compound_neg_log_likelihood_ds(
            theta, profiles, mult, nt, lgamma_tab_ds
        )

    res = minimize_nmsimplex2_jax(
        objective, jnp.asarray(DEFAULT_START), jnp.asarray(DEFAULT_STEP)
    )
    eps = res.x[1]
    log_l_hom = _ds.to_f64(_lds.log_hom_marginal_ds(profiles, eps, nt, lgamma_tab_ds))
    log_l_het = _ds.to_f64(_lds.log_het_marginal_ds(profiles, eps, nt, lgamma_tab_ds))
    return res, log_l_hom, log_l_het


def run_device_fit(prof_dev, mult_dev, nt, max_cov):
    """Dispatch the jitted device fit at the configured device precision.

    ``SIDTPU_DEVICE_PREC=ds`` selects the double-single f32 kernels
    (fit_lynch_ds); the default is the f64 fit. Inputs must already
    be padded/sharded; blocks until the result is ready so the profiling
    stage brackets real device time.
    """
    from sid_tpu.ops.likelihoods_ds import device_precision, lgamma_table_ds
    from sid_tpu.utils import profiling

    if device_precision() == "ds":
        tab_ds = lgamma_table_ds(table_size(max_cov))
        with profiling.device_stage("fit_lynch_ds"):
            out = fit_lynch_ds(prof_dev, mult_dev, jnp.asarray(nt), tab_ds)
            jax.block_until_ready(out)
        return out
    tab = jnp.asarray(lgamma_int_table(table_size(max_cov)))
    with profiling.device_stage("fit_lynch"):
        out = fit_lynch(prof_dev, mult_dev, jnp.asarray(nt), tab)
        jax.block_until_ready(out)
    return out


def fit_on_filtered_profiles(
    profiles: np.ndarray,
    mult: np.ndarray,
    diag: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """Host driver: nt distribution + device fit on (already filtered) profiles.

    Returns (pi, eps, log_l_hom (U,), log_l_het (U,), nt). Reproduces the
    minimizer's stderr convergence diagnostics (optimization.hpp:69-77).
    """
    from sid_tpu.utils import profiling

    nt = nucleotide_distribution(profiles, mult)
    max_cov = int(profiles.sum(-1).max()) if profiles.shape[0] else 0
    u = profiles.shape[0]
    prof_pad = pad_axis0(np.asarray(profiles, np.int32))
    mult_pad = pad_axis0(np.asarray(mult, np.int64))
    res, log_l_hom, log_l_het = run_device_fit(
        jnp.asarray(prof_pad), jnp.asarray(mult_pad), nt, max_cov
    )
    iters = int(res.iterations)
    if diag is not None:
        if bool(res.converged):
            diag(f"# GSL function minimization converged in {iters} iterations.")
        else:
            diag(f"# Error: GSL function minimization did not converge in {iters} iterations!")
    return (
        float(res.x[0]),
        float(res.x[1]),
        np.asarray(log_l_hom)[:u],
        np.asarray(log_l_het)[:u],
        nt,
    )


def fit_profiles(
    profiles: np.ndarray,
    mult: np.ndarray,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """Backend-dispatching fit on already-filtered profiles.

    Returns (pi, eps, log_l_hom, log_l_het, nt). ``fit_backend="exact"`` runs
    the long-double host optimizer (bit-faithful trajectory) and logs the
    linear likelihoods; "device" runs the jitted while-loop fit.
    """
    if resolve_fit_backend(options, profiles.shape[0]) == "exact":
        from sid_tpu.exact.lynch_ld import estimate_profile_genotype_likelihoods_ld

        nt = nucleotide_distribution(profiles, mult)
        pi, eps, l_hom, l_het = estimate_profile_genotype_likelihoods_ld(
            profiles, mult, nt, log=diag
        )
        with np.errstate(divide="ignore"):
            log_l_hom = np.log(l_hom).astype(np.float64)
            log_l_het = np.log(l_het).astype(np.float64)
        return pi, eps, log_l_hom, log_l_het, nt
    if options.mesh_devices is not None:
        from sid_tpu.parallel.fit import fit_lynch_global
        from sid_tpu.parallel.mesh import make_site_mesh

        mesh = make_site_mesh(options.mesh_devices)
        return fit_lynch_global(profiles, mult, mesh, diag)
    return fit_on_filtered_profiles(profiles, mult, diag)


def estimate_prior_heterozygosity(
    profiles: np.ndarray,
    mult: np.ndarray,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> float:
    """The -R estimate-prior path shared by local/quality (call.cpp:223-234).

    Filters cov>=4, fits, returns the heterozygosity as the SNP prior.
    """
    fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)
    if resolve_fit_backend(options, fprof.shape[0]) == "exact":
        from sid_tpu.exact.lynch_ld import estimate_profile_genotype_likelihoods_ld

        nt = nucleotide_distribution(fprof, fmult)
        pi, _, _, _ = estimate_profile_genotype_likelihoods_ld(fprof, fmult, nt, log=diag)
        return pi
    pi, _, _, _, _ = fit_on_filtered_profiles(fprof, fmult, diag)
    return pi
