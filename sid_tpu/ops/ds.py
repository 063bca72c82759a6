"""Double-single (two-float32) arithmetic for device kernels.

The classic double-word arithmetic (Dekker 1971, Knuth TAOCP 4.2.2, and the
QD library's float-float algorithms) implemented directly on f32 pairs,
giving ~2^-48 relative precision — comfortably above the CSV's
6-significant-digit bar — with every operation in f32, and one f32 word
where it suffices (integer counts, comparisons, table indices). It is the
alternative device precision to f64, selected by ``SIDTPU_DEVICE_PREC=ds``.

A DS value is a pair ``(hi, lo)`` of f32 arrays with ``hi = fl(hi + lo)``.
Precision: ~2^-48 relative. Range: f32's (|x| in [1e-38, 3e38]); values
below the f32 normal range flush to zero, which the log-space kernels
tolerate by construction (contributions below 2^-48 of the running maximum
are invisible anyway). The ``exp``/``log`` here are accurate to a few units
of 2^-48.

Error-free transforms are fragile under value-changing compiler rewrites.
XLA does not reassociate floating-point adds, and FMA contraction can only
alter the small correction terms (two_sum is mul-free; in two_prod a
contracted ``fma(a, b, -p)`` is the *exact* error term), so the algorithms
hold under jit; tests/test_ds.py pins the accuracy on every platform the
suite runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32

# Dekker split constant for binary32: 2^12 + 1 (24-bit significand).
_SPLIT = np.float32(4097.0)

# Below this, exp() underflows the f32 normal range: flush to zero. (The
# threshold is conservative: expf(-87.3) is the true edge.)
_EXP_UNDERFLOW = np.float32(-87.0)


class DS(NamedTuple):
    """A double-single number: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jnp.ndarray
    lo: jnp.ndarray


def zeros_like(x: DS) -> DS:
    return DS(jnp.zeros_like(x.hi), jnp.zeros_like(x.hi))


def const(x: float) -> DS:
    """Split a Python/f64 scalar into an exact-as-possible DS constant."""
    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return DS(jnp.float32(hi), jnp.float32(lo))


def const_np(x: float):
    """Host-side (numpy scalar) split, for building tables."""
    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return hi, lo


def split_f64_np(x: np.ndarray):
    """Host split of an f64 array into (hi, lo) f32 arrays (non-finite lo=0)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(hi), (x - hi.astype(np.float64)), 0.0).astype(
            np.float32
        )
    return hi, lo


def from_f64(x: jnp.ndarray) -> DS:
    """Device split of an f64 array (non-finite values get lo = 0)."""
    hi = x.astype(_F32)
    lo = jnp.where(
        jnp.isfinite(hi), (x - hi.astype(x.dtype)).astype(_F32), jnp.float32(0)
    )
    return DS(hi, lo)


def from_f32(hi: jnp.ndarray) -> DS:
    return DS(hi.astype(_F32), jnp.zeros_like(hi, _F32))


def to_f64(x: DS) -> jnp.ndarray:
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


# ---------------------------------------------------------------------------
# error-free transforms
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """Knuth's branch-free exact addition: a + b = s + err exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Exact addition assuming |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's exact product: a * b = p + err exactly (no FMA required)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def add(x: DS, y: DS) -> DS:
    """Accurate (IEEE-style) DS addition; handles cancellation exactly."""
    s1, s2 = two_sum(x.hi, y.hi)
    t1, t2 = two_sum(x.lo, y.lo)
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    s1, s2 = quick_two_sum(s1, s2)
    return DS(s1, s2)


def add_f32(x: DS, b) -> DS:
    s1, s2 = two_sum(x.hi, b)
    s2 = s2 + x.lo
    return DS(*quick_two_sum(s1, s2))


def neg(x: DS) -> DS:
    return DS(-x.hi, -x.lo)


def sub(x: DS, y: DS) -> DS:
    return add(x, neg(y))


def mul(x: DS, y: DS) -> DS:
    p1, p2 = two_prod(x.hi, y.hi)
    p2 = p2 + (x.hi * y.lo + x.lo * y.hi)
    return DS(*quick_two_sum(p1, p2))


def mul_f32(x: DS, b) -> DS:
    """DS * f32 (b need not be exact-representable; full two_prod path)."""
    p1, p2 = two_prod(x.hi, b)
    p2 = p2 + x.lo * b
    return DS(*quick_two_sum(p1, p2))


def mul_pow2(x: DS, s: float) -> DS:
    """Exact scaling by a power of two."""
    s = np.float32(s)
    return DS(x.hi * s, x.lo * s)


def sqr(x: DS) -> DS:
    p1, p2 = two_prod(x.hi, x.hi)
    p2 = p2 + 2.0 * (x.hi * x.lo)
    return DS(*quick_two_sum(p1, p2))


def div(x: DS, y: DS) -> DS:
    """Three-quotient long division (QD accurate_div): ~2^-47 relative."""
    q1 = x.hi / y.hi
    r = sub(x, mul_f32(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f32(y, q2))
    q3 = r.hi / y.hi
    s1, s2 = quick_two_sum(q1, q2)
    return add_f32(DS(s1, s2), q3)


def where(mask, x: DS, y: DS) -> DS:
    return DS(jnp.where(mask, x.hi, y.hi), jnp.where(mask, x.lo, y.lo))


def sum_last(x: DS) -> DS:
    """Reduce DS values over the last axis through f64.

    The converts are elementwise and the f64 reduction is exact to 2^-52 —
    tighter than DS itself — at a cost of K f64 adds per row. (A
    slice-and-tree of DS adds is avoided deliberately: slicing a computed DS
    array and re-combining the slices sends XLA's CPU fusion/codegen into a
    minutes-long compile on kernels this deep; measured 56 s vs 0.5 s.)
    """
    return from_f64(jnp.sum(to_f64(x), axis=-1))


def stack_last(parts: Sequence[DS]) -> DS:
    return DS(
        jnp.stack([p.hi for p in parts], axis=-1),
        jnp.stack([p.lo for p in parts], axis=-1),
    )


# ---------------------------------------------------------------------------
# transcendentals
# ---------------------------------------------------------------------------

# ln 2 in three f32 pieces (Cody-Waite): k*C1 and k*C2 stay exactly
# representable through two_prod; the C3 tail keeps k*ln2 accurate to
# ~2^-75 so the reduced argument carries full DS precision.
_LN2 = np.log(np.float64(2.0))
_LN2_C1 = np.float32(_LN2)
_LN2_C2 = np.float32(_LN2 - np.float64(_LN2_C1))
_LN2_C3 = np.float32(_LN2 - np.float64(_LN2_C1) - np.float64(_LN2_C2))
_INV_LN2 = np.float32(1.0 / _LN2)

# exp Taylor coefficients 1/n! for n = 0..13 (|r| <= ln2/2 = 0.347:
# 0.347^13/13! ~ 1.8e-16 < 2^-48).
_EXP_N = 13
_EXP_COEFS = [const_np(1.0 / float(math.factorial(n))) for n in range(_EXP_N + 1)]

# atanh series coefficients 1/(2j+1), j = 0..10 (|z| <= 0.2:
# 0.2^23/23 ~ 4e-18 relative to z).
_ATANH_J = 10
_ATANH_COEFS = [const_np(1.0 / (2 * j + 1)) for j in range(_ATANH_J + 1)]


def exp(x: DS) -> DS:
    """exp of a DS value.

    Valid for x.hi <= ~88 (f32 overflow); results below the f32 normal
    range flush to exactly zero — by construction the log-space kernels only
    call this on max-subtracted arguments (<= 0) where a 1e-38 contribution
    is far below DS precision of the accumulated sum (>= 1).
    """
    # range-reduce: x = k*ln2 + r, |r| <= ln2/2
    k = jnp.round(x.hi * _INV_LN2)
    r = sub(x, DS(*two_prod(k, _LN2_C1)))
    r = sub(r, DS(*two_prod(k, _LN2_C2)))
    r = add_f32(r, -(k * _LN2_C3))

    # Horner over the Taylor series
    acc = DS(
        jnp.full_like(x.hi, _EXP_COEFS[_EXP_N][0]),
        jnp.full_like(x.hi, _EXP_COEFS[_EXP_N][1]),
    )
    for n in range(_EXP_N - 1, -1, -1):
        c_hi, c_lo = _EXP_COEFS[n]
        acc = add(mul(acc, r), DS(jnp.float32(c_hi), jnp.float32(c_lo)))

    # scale by 2^k (exact); clamp k so ldexp stays in range, then flush
    kc = jnp.clip(k, -127.0, 127.0).astype(jnp.int32)
    out = DS(jnp.ldexp(acc.hi, kc), jnp.ldexp(acc.lo, kc))
    tiny = x.hi < _EXP_UNDERFLOW
    return DS(
        jnp.where(tiny, jnp.float32(0), out.hi),
        jnp.where(tiny, jnp.float32(0), out.lo),
    )


def log(x: DS) -> DS:
    """ln of a DS value; log(0) = -inf, log(<0) = NaN, DS-accurate.

    Range reduction x = 2^k * m with m in [2/3, 4/3), then
    ln m = 2 atanh(z), z = (m-1)/(m+1), |z| <= 0.2.
    """
    safe_hi = jnp.where(x.hi > 0, x.hi, jnp.float32(1.0))
    m_hi, k = jnp.frexp(safe_hi)  # m in [0.5, 1)
    adj = m_hi < jnp.float32(2.0 / 3.0)
    m_hi = jnp.where(adj, m_hi * 2, m_hi)
    k = jnp.where(adj, k - 1, k).astype(jnp.int32)
    m_lo = jnp.ldexp(jnp.where(x.hi > 0, x.lo, jnp.float32(0)), -k)
    m = DS(m_hi, m_lo)

    z = div(add_f32(m, np.float32(-1.0)), add_f32(m, np.float32(1.0)))
    w = sqr(z)
    acc = DS(
        jnp.full_like(x.hi, _ATANH_COEFS[_ATANH_J][0]),
        jnp.full_like(x.hi, _ATANH_COEFS[_ATANH_J][1]),
    )
    for j in range(_ATANH_J - 1, -1, -1):
        c_hi, c_lo = _ATANH_COEFS[j]
        acc = add(mul(acc, w), DS(jnp.float32(c_hi), jnp.float32(c_lo)))
    ln_m = mul_pow2(mul(z, acc), 2.0)

    kf = k.astype(_F32)
    res = add(ln_m, DS(*two_prod(kf, _LN2_C1)))
    res = add(res, DS(*two_prod(kf, _LN2_C2)))
    res = add_f32(res, kf * _LN2_C3)

    neg_inf = jnp.float32(-np.inf)
    nan = jnp.float32(np.nan)
    hi = jnp.where(x.hi == 0, neg_inf, jnp.where(x.hi < 0, nan, res.hi))
    lo = jnp.where((x.hi > 0) & jnp.isfinite(hi), res.lo, jnp.float32(0))
    # +inf input -> +inf
    hi = jnp.where(jnp.isposinf(x.hi), jnp.float32(np.inf), hi)
    return DS(hi, lo)


def xlogy_int(n: jnp.ndarray, logval: DS) -> DS:
    """n * logval with the reference's powl(x, 0) == 1 convention.

    ``n`` is an exact-in-f32 integer count (< 2^24). n == 0 gives exactly 0
    even when logval is -inf; n > 0 with logval = -inf gives -inf (the
    linear-space likelihood underflowed to zero).
    """
    nf = n.astype(_F32)
    p1, p2 = two_prod(nf, logval.hi)
    p2 = p2 + nf * logval.lo
    prod = DS(*quick_two_sum(p1, p2))
    neginf = jnp.isneginf(logval.hi)
    hi = jnp.where(n == 0, jnp.float32(0), jnp.where(neginf, logval.hi, prod.hi))
    lo = jnp.where((n == 0) | neginf, jnp.float32(0), prod.lo)
    return DS(hi, lo)


def add_terms(parts: Sequence[DS]) -> DS:
    """Sum log-space terms: any -inf summand makes the result exactly -inf
    (DS adds would otherwise produce inf - inf = NaN in the correction)."""
    out = parts[0]
    any_neginf = jnp.isneginf(parts[0].hi)
    for p in parts[1:]:
        out = add(out, p)
        any_neginf = any_neginf | jnp.isneginf(p.hi)
    return DS(
        jnp.where(any_neginf, jnp.float32(-np.inf), out.hi),
        jnp.where(any_neginf, jnp.float32(0), out.lo),
    )


def logsumexp_last(terms: DS) -> DS:
    """log(sum(exp(terms))) over the last axis, DS throughout.

    The max is taken on the hi words only (a <=2^-24-relative slack in the
    shift, absorbed exactly by exp); all-(-inf) rows return -inf.
    """
    m = jnp.max(terms.hi, axis=-1)
    finite = jnp.isfinite(m)
    m_safe = jnp.where(finite, m, jnp.float32(0))
    shifted = add_f32(terms, -m_safe[..., None])
    # exp flushes the -inf (masked) lanes to zero via its underflow clamp
    shifted = DS(
        jnp.where(jnp.isneginf(terms.hi), jnp.float32(-200.0), shifted.hi),
        jnp.where(jnp.isneginf(terms.hi), jnp.float32(0), shifted.lo),
    )
    s64 = jnp.sum(to_f64(exp(shifted)), axis=-1)
    out = add_f32(log(from_f64(s64)), m_safe)
    return DS(
        jnp.where(finite, out.hi, m),
        jnp.where(finite, out.lo, jnp.float32(0)),
    )
