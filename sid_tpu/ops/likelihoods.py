"""Genotype-likelihood kernels, f64 log-space, vectorized over profiles.

The math of lynch.hpp:48-96, re-derived for device execution: every kernel
returns *log* likelihoods (the reference's long-double linear space is
replaced by f64 log-space, which clears the CSV's 6-significant-digit bar and
never underflows). All kernels are elementwise over a (U,) profile axis —
work that XLA fuses into a handful of vector loops; the lgamma
lookup is a gather from a device-resident integer table (the reference's
memoized gsl_sf_lngamma, lynch.hpp:11-31).

Shapes: ``profiles`` is (..., 4) integer counts; ``lgamma_tab`` is a f64
table with ``lgamma_tab[k] = lngamma(k)``, covering k <= max coverage + 1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# unordered heterozygous base pairs (i < j), lynch.hpp:59-60
PAIR_I = np.array([0, 0, 0, 1, 1, 2], np.int32)
PAIR_J = np.array([1, 2, 3, 2, 3, 3], np.int32)

NEG_INF = -jnp.inf


def _xlogy(x, logy):
    """x * logy with the powl(base, 0) == 1 convention: 0 * (-inf) -> 0."""
    return jnp.where(x == 0, 0.0, x * logy)


def log_multinomial(profiles: jnp.ndarray, lgamma_tab: jnp.ndarray) -> jnp.ndarray:
    """log multinomialCoefficient (lynch.hpp:48-55): lngamma(cov+1) - sum lngamma(n_i+1)."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    return lgamma_tab[cov + 1] - lgamma_tab[profiles + 1].sum(-1)


def log_het_marginal(
    profiles: jnp.ndarray,
    error_probability,
    nucleotide_distribution: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
) -> jnp.ndarray:
    """log heterozygousLikelihood marginalized over base pairs (lynch.hpp:57-74).

    L = multinom * sum_{i<j} nt_i nt_j ((1-2e/3)/2)^(n_i+n_j) (e/3)^(cov-n_i-n_j),
    renormalized by (1 - sum_i nt_i^2) for the excluded (i,i) pairs.
    """
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1, keepdims=True)  # (..., 1)
    nt = jnp.asarray(nucleotide_distribution)
    e = jnp.asarray(error_probability, jnp.float64)

    n_pair = profiles[..., PAIR_I] + profiles[..., PAIR_J]  # (..., 6)
    log_w = jnp.log(nt[PAIR_I] * nt[PAIR_J])  # (6,)
    log_match = jnp.log((1.0 - 2.0 / 3.0 * e) / 2.0)
    log_err = jnp.log(e / 3.0)
    terms = log_w + _xlogy(n_pair, log_match) + _xlogy(cov - n_pair, log_err)
    s = jnp.sum(nt * nt)
    return (
        log_multinomial(profiles, lgamma_tab)
        + jax.scipy.special.logsumexp(terms, axis=-1)
        - jnp.log1p(-s)
    )


def log_hom_marginal(
    profiles: jnp.ndarray,
    error_probability,
    nucleotide_distribution: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
) -> jnp.ndarray:
    """log homozygousLikelihood marginalized over the reference base (lynch.hpp:82-90).

    L = multinom * sum_i nt_i (1-e)^(n_i) (e/3)^(cov-n_i).
    """
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1, keepdims=True)
    nt = jnp.asarray(nucleotide_distribution)
    e = jnp.asarray(error_probability, jnp.float64)

    log_match = jnp.log1p(-e)
    log_err = jnp.log(e / 3.0)
    terms = jnp.log(nt) + _xlogy(profiles, log_match) + _xlogy(cov - profiles, log_err)
    return log_multinomial(profiles, lgamma_tab) + jax.scipy.special.logsumexp(
        terms, axis=-1
    )


def log_het_fixed(
    profiles: jnp.ndarray,
    error_probability,
    ref0: jnp.ndarray,
    ref1: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
) -> jnp.ndarray:
    """log heterozygousLikelihood at fixed alleles (ref0, ref1) (lynch.hpp:76-80).

    ``error_probability`` may be per-profile (broadcast against the batch).
    """
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    e = jnp.asarray(error_probability, jnp.float64)
    n01 = jnp.take_along_axis(profiles, ref0[..., None], axis=-1)[..., 0] + (
        jnp.take_along_axis(profiles, ref1[..., None], axis=-1)[..., 0]
    )
    log_match = jnp.log((1.0 - 2.0 / 3.0 * e) / 2.0)
    log_err = jnp.log(e / 3.0)
    return (
        log_multinomial(profiles, lgamma_tab)
        + _xlogy(n01, log_match)
        + _xlogy(cov - n01, log_err)
    )


def log_hom_fixed(
    profiles: jnp.ndarray,
    error_probability,
    ref: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
) -> jnp.ndarray:
    """log homozygousLikelihood at a fixed allele (lynch.hpp:92-96)."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    e = jnp.asarray(error_probability, jnp.float64)
    n0 = jnp.take_along_axis(profiles, ref[..., None], axis=-1)[..., 0]
    log_match = jnp.log1p(-e)
    log_err = jnp.log(e / 3.0)
    return (
        log_multinomial(profiles, lgamma_tab)
        + _xlogy(n0, log_match)
        + _xlogy(cov - n0, log_err)
    )


def compound_neg_log_likelihood(
    theta: jnp.ndarray,
    profiles: jnp.ndarray,
    mult: jnp.ndarray,
    nucleotide_distribution: jnp.ndarray,
    lgamma_tab: jnp.ndarray,
) -> jnp.ndarray:
    """The Lynch-fit objective (lynch.cpp:37-61) for theta = (pi, epsilon).

    -sum_profiles mult * log[(1-pi) L_hom + pi L_het], with the reference's
    out-of-[0,1]^2 box penalty DBL_MAX, skipped L<=0 terms, and +-inf clamp.
    Padded profiles (mult == 0) contribute exactly zero.
    """
    pi = theta[..., 0]
    eps = theta[..., 1]
    in_box = (pi >= 0) & (pi <= 1) & (eps >= 0) & (eps <= 1)
    # evaluate at a box-clamped epsilon to keep the log args valid; the
    # result is discarded (penalty) when out of box
    eps_safe = jnp.clip(eps, 0.0, 1.0)
    pi_safe = jnp.clip(pi, 0.0, 1.0)
    lhom = log_hom_marginal(profiles, eps_safe, nucleotide_distribution, lgamma_tab)
    lhet = log_het_marginal(profiles, eps_safe, nucleotide_distribution, lgamma_tab)
    log_mix = jnp.logaddexp(jnp.log1p(-pi_safe) + lhom, jnp.log(pi_safe) + lhet)
    terms = jnp.where(jnp.isneginf(log_mix), 0.0, log_mix * mult)
    total = jnp.sum(terms)
    dbl_max = jnp.finfo(jnp.float64).max
    total = jnp.clip(total, -dbl_max, dbl_max)
    return jnp.where(in_box, -total, dbl_max)
