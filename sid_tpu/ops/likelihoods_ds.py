"""Double-single (two-f32) genotype-likelihood kernels.

These re-derive the math of the f64 kernels in ``ops.likelihoods``
(lynch.hpp:48-96, optimization.hpp:46-72 objective) in double-single f32
arithmetic (ops.ds, ~2^-48), with one structural upgrade the f64 kernels
can't make:

**The fixed-allele kernels contain no transcendental evaluation at all.**
The plug-in error rates of the ``local`` method are ratios of small integers
(error1 = (cov-n1)/cov, error2 = 1.5(cov-n1-n2)/cov; call.cpp:242-254), so
every log the kernel needs is the log of an integer <= cov:

    log1p(-e1)      = log(n1)        - log(cov)
    log(e1/3)       = log(cov-n1)    - log(cov) - log 3
    log((1-2e2/3)/2)= log(n1+n2)     - log(cov) - log 2
    log(e2/3)       = log(cov-n1-n2) - log(cov) - log 2

All come from one precomputed f64-accurate integer-log table (gathered as an
f32 hi/lo pair), turning the hot per-profile chain into pure gathers + DS
adds. The capped branch (error > -E threshold) uses DS scalars computed once
from the threshold. Cap decisions are made in f64 — bit-identical branch
selection to the f64 kernels.

Padded rows (all-zero profiles) produce multinomial(0)=0 rows, discarded by
the caller exactly as in the f64 kernels.

Enabled by ``SIDTPU_DEVICE_PREC=ds`` (see models/*.py call sites).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sid_tpu.models.common import LONG_DOUBLE_UNDERFLOW_LOG
from sid_tpu.ops import ds
from sid_tpu.ops.lgamma import lgamma_int_table
from sid_tpu.ops.likelihoods import PAIR_I, PAIR_J

_F32 = jnp.float32


def device_precision() -> str:
    """Device kernel precision: "f64" (default) or "ds" (double-single f32)."""
    return os.environ.get("SIDTPU_DEVICE_PREC", "f64")


def ds_requested() -> bool:
    """Whether ``--warm-cache`` and ``bench.py`` include the double-single
    paths: only under ``SIDTPU_WARM_DS=1``, since no default run takes them."""
    return bool(os.environ.get("SIDTPU_WARM_DS"))


@lru_cache(maxsize=8)
def _log_int_table_np(size: int):
    """(hi, lo) f32 split of log(k) for k in [0, size); log(0) = -inf."""
    k = np.arange(size, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.log(k)
    return ds.split_f64_np(t)


@lru_cache(maxsize=8)
def _lgamma_table_np(size: int):
    """(hi, lo) f32 split of the integer-lgamma table (lgamma.py spec)."""
    return ds.split_f64_np(lgamma_int_table(size - 1))


def log_int_table_ds(size: int) -> ds.DS:
    hi, lo = _log_int_table_np(size)
    return ds.DS(jnp.asarray(hi), jnp.asarray(lo))


def lgamma_table_ds(size: int) -> ds.DS:
    hi, lo = _lgamma_table_np(size)
    return ds.DS(jnp.asarray(hi), jnp.asarray(lo))


def _gather(tab: ds.DS, idx: jnp.ndarray) -> ds.DS:
    return ds.DS(tab.hi[idx], tab.lo[idx])


def log_multinomial_ds(profiles: jnp.ndarray, lgamma_tab: ds.DS) -> ds.DS:
    """log multinomialCoefficient (lynch.hpp:48-55) in DS: pure gathers+adds."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    out = _gather(lgamma_tab, cov + 1)
    for i in range(4):
        out = ds.sub(out, _gather(lgamma_tab, profiles[..., i] + 1))
    return out


def _log_ratio(log_tab: ds.DS, num: jnp.ndarray, log_cov: ds.DS, c: ds.DS) -> ds.DS:
    """log(num / (k*cov)) = log_tab[num] - log_cov - log(k) for exact ints."""
    return ds.sub(ds.sub(_gather(log_tab, num), log_cov), c)


_LOG2 = ds.const_np(np.log(np.float64(2.0)))
_LOG3 = ds.const_np(np.log(np.float64(3.0)))


def _const(pair) -> ds.DS:
    return ds.DS(jnp.float32(pair[0]), jnp.float32(pair[1]))


def _capped_logs(thr: jnp.ndarray) -> Tuple[ds.DS, ds.DS, ds.DS]:
    """DS scalars for the capped branch: log1p(-t), log(t/3), log((1-2t/3)/2)."""
    # all three via ds.log of the f64 quotient: a zero argument gives a
    # clean -inf (a DS subtract of a -inf log would poison the lo word)
    log1p_m = ds.log(ds.from_f64(1.0 - thr))
    log_t3 = ds.log(ds.from_f64(thr / 3.0))
    log_match2 = ds.log(ds.from_f64((1.0 - 2.0 / 3.0 * thr) * 0.5))
    return log1p_m, log_t3, log_match2


def _int_ratio_log(num: jnp.ndarray, den: jnp.ndarray) -> ds.DS:
    """DS log(num/den) for exact-in-f32 integer operands, gather-free.

    One DS division of the exact integers + one DS log (~2 kFLOP of f32
    work per element), in place of the gather formulation
    (log_tab[num] - log_tab[den]).
    """
    ratio = ds.div(ds.from_f32(num.astype(_F32)), ds.from_f32(den.astype(_F32)))
    return ds.log(ratio)


def local_fixed_log_likelihoods_ds(
    profiles: jnp.ndarray,
    major: jnp.ndarray,
    second: jnp.ndarray,
    error_threshold: jnp.ndarray,
    log_tab: ds.DS,
    lgamma_tab: ds.DS,
    use_tables: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """The ``local`` method's per-profile (log_l1, log_l2) in DS, as f64.

    Matches models/local.local_log_likelihoods semantics (call.cpp:238-254)
    including the f64 cap comparisons and the long-double underflow clamp;
    returns f64 arrays ready for the host LRT. ``use_tables`` selects the
    integer-log-table formulation (fewer FLOPs, 6 more gathers per profile,
    see _int_ratio_log).
    """
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    n1 = jnp.take_along_axis(profiles, major[..., None], -1)[..., 0]
    n2 = jnp.take_along_axis(profiles, second[..., None], -1)[..., 0]
    covf = cov.astype(jnp.float64)

    log1p_cap, log_t3_cap, log_match2_cap = _capped_logs(error_threshold)
    if use_tables:
        log_cov = _gather(log_tab, cov)

        def ratio_log3(num):  # log(num/(3 cov))
            return _log_ratio(log_tab, num, log_cov, _const(_LOG3))

        def ratio_log2(num):  # log(num/(2 cov))
            return _log_ratio(log_tab, num, log_cov, _const(_LOG2))

        def ratio_log1(num):  # log(num/cov)
            return ds.sub(_gather(log_tab, num), log_cov)

    else:

        def ratio_log3(num):
            return _int_ratio_log(num, 3 * cov)

        def ratio_log2(num):
            return _int_ratio_log(num, 2 * cov)

        def ratio_log1(num):
            return _int_ratio_log(num, cov)

    # hom: e1 = (cov-n1)/cov, capped at threshold (f64 compare; NaN at cov=0
    # stays uncapped, and its n==0 operands zero both xlogy terms anyway)
    e1 = (covf - n1.astype(jnp.float64)) / covf
    cap1 = e1 > error_threshold
    log1p_e1 = ds.where(cap1, log1p_cap, ratio_log1(n1))
    log_e1_3 = ds.where(cap1, log_t3_cap, ratio_log3(cov - n1))
    l1 = ds.add_terms(
        [
            log_multinomial_ds(profiles, lgamma_tab),
            ds.xlogy_int(n1, log1p_e1),
            ds.xlogy_int(cov - n1, log_e1_3),
        ]
    )

    # het: e2 = 1.5(cov-n1-n2)/cov; log terms are integer-ratio logs again
    n12 = n1 + n2
    e2 = 1.5 * (covf - n12.astype(jnp.float64)) / covf
    cap2 = e2 > error_threshold
    log_match = ds.where(cap2, log_match2_cap, ratio_log2(n12))
    log_err = ds.where(cap2, log_t3_cap, ratio_log2(cov - n12))
    l2 = ds.add_terms(
        [
            log_multinomial_ds(profiles, lgamma_tab),
            ds.xlogy_int(n12, log_match),
            ds.xlogy_int(cov - n12, log_err),
        ]
    )

    l1_64 = ds.to_f64(l1)
    l2_64 = ds.to_f64(l2)
    neginf = -jnp.inf
    l1_64 = jnp.where(l1_64 < LONG_DOUBLE_UNDERFLOW_LOG, neginf, l1_64)
    l2_64 = jnp.where(l2_64 < LONG_DOUBLE_UNDERFLOW_LOG, neginf, l2_64)
    return l1_64, l2_64


# ---------------------------------------------------------------------------
# marginalized kernels (the Lynch-fit objective and post-fit likelihoods)
# ---------------------------------------------------------------------------


def _marginal_scalar_logs(eps: jnp.ndarray):
    """DS scalars log1p(-e), log(e/3), log((1-2e/3)/2) for a traced f64 eps."""
    # via ds.log of f64 quotients (mirrors the f64 kernels' log(e/3.0) and
    # keeps eps == 0 a clean -inf; a DS subtract of -inf would produce NaN)
    log1p_m = ds.log(ds.from_f64(1.0 - eps))
    log_e3 = ds.log(ds.from_f64(eps / 3.0))
    log_match = ds.log(ds.from_f64((1.0 - 2.0 / 3.0 * eps) * 0.5))
    return log1p_m, log_e3, log_match


def log_hom_marginal_ds(
    profiles: jnp.ndarray,
    eps: jnp.ndarray,
    nt: jnp.ndarray,
    lgamma_tab: ds.DS,
) -> ds.DS:
    """log homozygousLikelihood marginalized over bases (lynch.hpp:82-90)."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    log1p_m, log_e3, _ = _marginal_scalar_logs(eps)
    terms = []
    for i in range(4):
        n_i = profiles[..., i]
        log_nt_i = ds.log(ds.from_f64(nt[i]))  # scalar; nt_i == 0 -> -inf
        t = ds.add_terms(
            [
                ds.DS(jnp.broadcast_to(log_nt_i.hi, n_i.shape),
                      jnp.broadcast_to(log_nt_i.lo, n_i.shape)),
                ds.xlogy_int(n_i, log1p_m),
                ds.xlogy_int(cov - n_i, log_e3),
            ]
        )
        terms.append(t)
    lse = ds.logsumexp_last(ds.stack_last(terms))
    return ds.add(log_multinomial_ds(profiles, lgamma_tab), lse)


def log_het_marginal_ds(
    profiles: jnp.ndarray,
    eps: jnp.ndarray,
    nt: jnp.ndarray,
    lgamma_tab: ds.DS,
) -> ds.DS:
    """log heterozygousLikelihood marginalized over base pairs (lynch.hpp:57-74)."""
    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)
    _, log_e3, log_match = _marginal_scalar_logs(eps)
    terms = []
    for i, j in zip(PAIR_I.tolist(), PAIR_J.tolist()):
        n_pair = profiles[..., i] + profiles[..., j]
        # pair weight log(nt_i * nt_j): one scalar DS log of the f64 product
        # (a zero weight cleanly gives -inf rather than a -inf + -inf NaN)
        log_w = ds.log(ds.from_f64(nt[i] * nt[j]))
        t = ds.add_terms(
            [
                ds.DS(jnp.broadcast_to(log_w.hi, n_pair.shape),
                      jnp.broadcast_to(log_w.lo, n_pair.shape)),
                ds.xlogy_int(n_pair, log_match),
                ds.xlogy_int(cov - n_pair, log_e3),
            ]
        )
        terms.append(t)
    lse = ds.logsumexp_last(ds.stack_last(terms))
    # renormalize by (1 - sum nt_i^2) for the excluded (i,i) pairs
    s = jnp.sum(nt * nt)
    log_renorm = ds.log(ds.from_f64(1.0 - s))
    return ds.sub(
        ds.add(log_multinomial_ds(profiles, lgamma_tab), lse), log_renorm
    )


def compound_neg_log_likelihood_ds(
    theta: jnp.ndarray,
    profiles: jnp.ndarray,
    mult: jnp.ndarray,
    nt: jnp.ndarray,
    lgamma_tab: ds.DS,
) -> jnp.ndarray:
    """The Lynch-fit objective (lynch.cpp:37-61) with DS vector math.

    Same contract as likelihoods.compound_neg_log_likelihood: f64 scalar in,
    f64 scalar out (the nmsimplex state stays f64 — tiny scalar work).

    Structurally fused for compile economy: the mix
    ``log[(1-pi) L_hom + pi L_het]`` is ONE logsumexp over 10 weighted terms
    (4 hom bases + 6 het pairs, sharing the multinomial factor) —

        t_i = log((1-pi) nt_i)            + n_i   log(1-e)  + (cov-n_i)   log(e/3)
        t_p = log(pi nt_i nt_j / (1-s))   + n_p   log_match + (cov-n_p)   log(e/3)

    — mathematically identical to the f64 kernel's hom-lse + het-lse +
    logaddexp, but with a single exp/log pair on the (U, 10) term tensor.
    The 10 weight logs are one vectorized DS log of an f64 weight vector;
    the final mult-weighted reduction runs in f64 (exact relative
    to the DS terms).

    Fitted-parameter drift bound (tests/test_ds.py::TestFitParameterDrift):
    driving the GSL nmsimplex2 rule with this objective lands on the same
    (pi, eps) as the f64 objective — bitwise identical on CPU for both
    realistic and degenerate histograms; the regression tolerance is
    |d_pi| <= max(1e-8, 1e-4 pi) / |d_eps| <= max(1e-9, 1e-5 eps) on
    realistic inputs and |d_pi| <= 1e-6 absolute on degenerate near-zero-pi
    fits.
    """
    pi = theta[..., 0]
    eps = theta[..., 1]
    in_box = (pi >= 0) & (pi <= 1) & (eps >= 0) & (eps <= 1)
    eps_safe = jnp.clip(eps, 0.0, 1.0)
    pi_safe = jnp.clip(pi, 0.0, 1.0)

    profiles = profiles.astype(jnp.int32)
    cov = profiles.sum(-1)

    # (10,) f64 term weights; zero weights (pi at a box corner, absent
    # bases) become clean -inf logs in DS
    s = jnp.sum(nt * nt)
    w_hom = (1.0 - pi_safe) * nt  # (4,)
    w_het = pi_safe * (nt[PAIR_I] * nt[PAIR_J]) / (1.0 - s)  # (6,)
    log_w = ds.log(ds.from_f64(jnp.concatenate([w_hom, w_het])))  # (10,)

    log1p_m, log_e3, log_match = _marginal_scalar_logs(eps_safe)
    # per-term "match" log: log(1-e) for the hom lanes, log((1-2e/3)/2) for
    # the het lanes — assembled by broadcasting the two scalars, no slicing
    match = ds.DS(
        jnp.concatenate(
            [jnp.broadcast_to(log1p_m.hi, (4,)), jnp.broadcast_to(log_match.hi, (6,))]
        ),
        jnp.concatenate(
            [jnp.broadcast_to(log1p_m.lo, (4,)), jnp.broadcast_to(log_match.lo, (6,))]
        ),
    )

    n_pair = profiles[..., PAIR_I] + profiles[..., PAIR_J]  # (U, 6)
    n_all = jnp.concatenate([profiles, n_pair], axis=-1)  # (U, 10)

    terms = ds.add_terms(
        [
            ds.DS(
                jnp.broadcast_to(log_w.hi, n_all.shape),
                jnp.broadcast_to(log_w.lo, n_all.shape),
            ),
            ds.xlogy_int(n_all, match),
            ds.xlogy_int(cov[..., None] - n_all, log_e3),
        ]
    )
    # add_terms: an all-(-inf) lse row (both likelihoods underflowed to 0)
    # must stay -inf through the multinomial add, not turn NaN
    mix = ds.add_terms(
        [log_multinomial_ds(profiles, lgamma_tab), ds.logsumexp_last(terms)]
    )
    mix64 = ds.to_f64(mix)
    terms64 = jnp.where(jnp.isneginf(mix64), 0.0, mix64 * mult.astype(jnp.float64))
    total = jnp.sum(terms64)
    dbl_max = jnp.finfo(jnp.float64).max
    total = jnp.clip(total, -dbl_max, dbl_max)
    return jnp.where(in_box, -total, dbl_max)


# ---------------------------------------------------------------------------
# quality-method finalize
# ---------------------------------------------------------------------------


def finalize_quality_het_ds(
    counts: jnp.ndarray,
    major: jnp.ndarray,
    second: jnp.ndarray,
    log_het: jnp.ndarray,
    lgamma_tab: ds.DS,
) -> jnp.ndarray:
    """Device half of the sharded DS finalize: het binomial only (see
    models/quality.finalize_quality_het — the hom clamp and both prior adds
    are elementary host f64). Returns the clamped pre-prior het log."""
    counts = counts.astype(jnp.int32)
    major = major.astype(jnp.int32)
    second = second.astype(jnp.int32)
    n = (
        jnp.take_along_axis(counts, major[:, None], 1)[:, 0]
        + jnp.take_along_axis(counts, second[:, None], 1)[:, 0]
    )
    k = jnp.take_along_axis(counts, second[:, None], 1)[:, 0]
    return finalize_quality_het_nk_ds(n, k, log_het, lgamma_tab)


def finalize_quality_het_nk_ds(
    n: jnp.ndarray,
    k: jnp.ndarray,
    log_het: jnp.ndarray,
    lgamma_tab: ds.DS,
) -> jnp.ndarray:
    """Narrowest DS device half: binomial from (n, k) planes only (see
    models/quality.finalize_quality_het_nk)."""
    n = n.astype(jnp.int32)
    k = k.astype(jnp.int32)
    log_c = ds.sub(
        ds.sub(_gather(lgamma_tab, n + 1), _gather(lgamma_tab, n - k + 1)),
        _gather(lgamma_tab, k + 1),
    )
    het = ds.add_terms(
        [
            ds.from_f64(log_het),
            log_c,
            ds.neg(ds.xlogy_int(n, _const(_LOG2))),
        ]
    )
    het64 = ds.to_f64(het)
    return jnp.where(het64 < LONG_DOUBLE_UNDERFLOW_LOG, -jnp.inf, het64)


def finalize_quality_logs_ds(
    counts: jnp.ndarray,
    major: jnp.ndarray,
    second: jnp.ndarray,
    log_hom: jnp.ndarray,
    log_het: jnp.ndarray,
    snp_prior: jnp.ndarray,
    lgamma_tab: ds.DS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Quality per-site finalize (call.cpp:344-353) in DS: post-prior logs.

    The per-read sums arrive as f64 (host-accumulated); the allele-balance
    binomial is lgamma-table gathers + DS adds; output f64 logs feed the
    host LRT (the exact_pvalues flow — the DS path requires it).
    """
    counts = counts.astype(jnp.int32)
    n = (
        jnp.take_along_axis(counts, major[:, None], 1)[:, 0]
        + jnp.take_along_axis(counts, second[:, None], 1)[:, 0]
    )
    k = jnp.take_along_axis(counts, second[:, None], 1)[:, 0]
    log_c = ds.sub(
        ds.sub(_gather(lgamma_tab, n + 1), _gather(lgamma_tab, n - k + 1)),
        _gather(lgamma_tab, k + 1),
    )
    het = ds.add_terms(
        [
            ds.from_f64(log_het),
            log_c,
            ds.neg(ds.xlogy_int(n, _const(_LOG2))),
        ]
    )
    hom64 = log_hom  # untouched by the binomial
    het64 = ds.to_f64(het)

    neginf = -jnp.inf
    lpp1 = jnp.where(hom64 < LONG_DOUBLE_UNDERFLOW_LOG, neginf, hom64)
    lpp2 = jnp.where(het64 < LONG_DOUBLE_UNDERFLOW_LOG, neginf, het64)
    prior_on = snp_prior > 0
    # the two prior logs are host-scalar work: compute them in plain f64
    # exactly like the f64 kernel (finalize_quality) — a DS/f32-range log
    # would turn priors below ~1e-38 into -inf instead of the finite
    # log(prior) the f64 path produces (ADVICE r4 #3)
    lp_hom = jnp.log(1.0 - snp_prior)
    lp_het = jnp.log(snp_prior)
    lpp1 = lpp1 + jnp.where(prior_on, lp_hom, 0.0)
    lpp2 = lpp2 + jnp.where(prior_on, lp_het, 0.0)
    return lpp1, lpp2
