"""Double-single (two-f32) device kernels: accuracy and CSV parity.

The ds kernels (ops/ds.py, ops/likelihoods_ds.py) are the alternative
device precision (SIDTPU_DEVICE_PREC=ds): f32-pair arithmetic at ~2^-48
precision. On CPU (this suite) they are slower than native f64 — these
tests pin accuracy and output parity, not speed.

Parity contract tested here:
- core DS ops and transcendentals: ~1e-13 relative or better under jit;
- the fixed/marginal kernels and the fit objective agree with the f64
  kernels to ~1e-12 absolute on log-likelihoods, with identical -inf sets
  and identical error-cap branch decisions;
- the full engine at SIDTPU_DEVICE_PREC=ds (device classify paths forced)
  emits byte-identical CSV to the default f64 engine on realistic inputs;
- the GSL-rule trajectory driven by the DS objective converges to the same
  (pi, eps) as the long-double oracle at the CSV's %g granularity.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sid_tpu.config import Options
from sid_tpu.models.common import major_allele_indices_np
from sid_tpu.ops import ds
from sid_tpu.ops import likelihoods as lk
from sid_tpu.ops import likelihoods_ds as lds
from sid_tpu.ops.lgamma import lgamma_int_table


def _profiles(u=4096, seed=3, cov_mean=30):
    rng = np.random.default_rng(seed)
    cov = rng.poisson(cov_mean, u).clip(0)
    cov[0] = 0  # zero-coverage edge case
    out = np.zeros((u, 4), np.int32)
    for i in range(u):
        p = rng.dirichlet([8, 1, 0.5, 0.2])
        out[i] = rng.multinomial(cov[i], p)
    return out


class TestCore:
    def test_arithmetic_accuracy(self):
        # op error is measured against the DS-representable inputs (hi+lo
        # recombined in f64), so cancellation in add doesn't charge the op
        # with the 2^-49 input representation error
        rng = np.random.default_rng(0)
        x = rng.uniform(-1e4, 1e4, 50000)
        y = rng.uniform(1e-6, 1e6, 50000)
        xh, xl = ds.split_f64_np(x)
        yh, yl = ds.split_f64_np(y)
        xr = xh.astype(np.float64) + xl.astype(np.float64)
        yr = yh.astype(np.float64) + yl.astype(np.float64)

        @jax.jit
        def probe(x64, y64):
            a = ds.from_f64(x64)
            b = ds.from_f64(y64)
            return (
                ds.to_f64(ds.add(a, b)),
                ds.to_f64(ds.mul(a, b)),
                ds.to_f64(ds.div(a, b)),
            )

        add, mul, div = (np.asarray(v) for v in probe(jnp.asarray(x), jnp.asarray(y)))
        for name, got, want in [("add", add, xr + yr), ("mul", mul, xr * yr),
                                ("div", div, xr / yr)]:
            # relative to the larger operand scale for add (cancellation)
            scale = np.maximum(np.abs(want), np.abs(xr) + np.abs(yr))
            rel = np.max(np.abs(got - want) / np.maximum(scale, 1e-300))
            assert rel < 5e-14, (name, rel)

    def test_two_sum_exactness_under_jit(self):
        # the error-free transform must survive compilation: recombining
        # (s, err) in f64 reproduces the f64 sum of the f32 inputs exactly
        rng = np.random.default_rng(1)
        a = rng.uniform(-1e6, 1e6, 10000).astype(np.float32)
        b = (rng.uniform(-1, 1, 10000)).astype(np.float32)

        @jax.jit
        def probe(a32, b32):
            s, e = ds.two_sum(a32, b32)
            return s.astype(jnp.float64) + e.astype(jnp.float64)

        got = np.asarray(probe(jnp.asarray(a), jnp.asarray(b)))
        want = a.astype(np.float64) + b.astype(np.float64)
        np.testing.assert_array_equal(got, want)

    def test_two_prod_exactness_under_jit(self):
        rng = np.random.default_rng(2)
        a = rng.uniform(-1e3, 1e3, 10000).astype(np.float32)
        b = rng.uniform(-1e3, 1e3, 10000).astype(np.float32)

        @jax.jit
        def probe(a32, b32):
            p, e = ds.two_prod(a32, b32)
            return p.astype(jnp.float64) + e.astype(jnp.float64)

        got = np.asarray(probe(jnp.asarray(a), jnp.asarray(b)))
        want = a.astype(np.float64) * b.astype(np.float64)
        np.testing.assert_array_equal(got, want)

    def test_exp_log_accuracy(self):
        rng = np.random.default_rng(3)

        @jax.jit
        def pexp(x64):
            return ds.to_f64(ds.exp(ds.from_f64(x64)))

        @jax.jit
        def plog(x64):
            return ds.to_f64(ds.log(ds.from_f64(x64)))

        x = rng.uniform(-50, 10, 100000)
        e = np.asarray(pexp(jnp.asarray(x)))
        # relative error dominated by the 2^-49 input representation: |x|*2e-15
        rel = np.abs(e - np.exp(x)) / np.exp(x)
        assert np.max(rel) < 2e-13, np.max(rel)

        # supported range: |value| within the f32 range with a NORMAL lo
        # word (|y| >~ 2^-100); below that the lo word goes subnormal and
        # accuracy degrades gracefully toward f32 (documented in ops/ds.py)
        y = np.exp(rng.uniform(-60, 60, 100000))
        l = np.asarray(plog(jnp.asarray(y)))
        err = np.abs(l - np.log(y)) / np.maximum(np.abs(np.log(y)), 1.0)
        assert np.max(err) < 1e-14, np.max(err)

    def test_exp_log_edges(self):
        @jax.jit
        def probe():
            lg = ds.log(ds.from_f64(jnp.asarray([0.0, 1.0, -1.0, np.inf])))
            ex = ds.exp(ds.from_f64(jnp.asarray([-500.0, 0.0])))
            return lg.hi, ex.hi

        lg, ex = (np.asarray(v) for v in probe())
        assert np.isneginf(lg[0]) and lg[1] == 0.0 and np.isnan(lg[2])
        assert np.isposinf(lg[3])
        assert ex[0] == 0.0 and ex[1] == 1.0

    def test_logsumexp(self):
        from scipy.special import logsumexp as slse

        rng = np.random.default_rng(4)
        t = rng.uniform(-300, -100, (20000, 6))
        t[:, 0] += 200  # dominant lane

        @jax.jit
        def plse(t64):
            return ds.to_f64(ds.logsumexp_last(ds.from_f64(t64)))

        got = np.asarray(plse(jnp.asarray(t)))
        want = slse(t, axis=-1)
        assert np.max(np.abs(got - want) / np.abs(want)) < 1e-14

        ti = np.full((3, 4), -np.inf)
        ti[0, 2] = -7.0
        got = np.asarray(plse(jnp.asarray(ti)))
        assert got[0] == -7.0 and np.isneginf(got[1]) and np.isneginf(got[2])


class TestKernels:
    def test_fixed_local_kernel_vs_f64(self):
        profiles = _profiles()
        major, second = major_allele_indices_np(profiles.astype(np.int64))
        tab64 = jnp.asarray(lgamma_int_table(1023))
        ltab = lds.log_int_table_ds(1024)
        gtab = lds.lgamma_table_ds(1024)
        from sid_tpu.models.local import local_log_likelihoods

        a1, a2 = local_log_likelihoods(
            jnp.asarray(profiles), jnp.asarray(major), jnp.asarray(second),
            jnp.float64(0.1), tab64,
        )
        f = jax.jit(lds.local_fixed_log_likelihoods_ds)
        b1, b2 = f(
            jnp.asarray(profiles), jnp.asarray(major), jnp.asarray(second),
            jnp.float64(0.1), ltab, gtab,
        )
        for a, b in [(np.asarray(a1), np.asarray(b1)), (np.asarray(a2), np.asarray(b2))]:
            assert np.array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            assert np.max(np.abs(a[fin] - b[fin])) < 1e-11

    @pytest.mark.parametrize("eps", [0.0, 1e-4, 1e-2, 0.3, 1.0])
    def test_marginals_vs_f64(self, eps):
        profiles = _profiles(u=2048)
        mult = np.random.default_rng(5).integers(1, 100, 2048).astype(np.float64)
        nt = (profiles * mult[:, None]).sum(0).astype(np.float64)
        nt /= nt.sum()
        tab64 = jnp.asarray(lgamma_int_table(1023))
        gtab = lds.lgamma_table_ds(1024)

        a1 = np.asarray(lk.log_hom_marginal(jnp.asarray(profiles), eps, jnp.asarray(nt), tab64))
        a2 = np.asarray(lk.log_het_marginal(jnp.asarray(profiles), eps, jnp.asarray(nt), tab64))
        f = jax.jit(
            lambda e: (
                ds.to_f64(lds.log_hom_marginal_ds(jnp.asarray(profiles), e, jnp.asarray(nt), gtab)),
                ds.to_f64(lds.log_het_marginal_ds(jnp.asarray(profiles), e, jnp.asarray(nt), gtab)),
            )
        )
        b1, b2 = (np.asarray(v) for v in f(jnp.float64(eps)))
        for a, b in [(a1, b1), (a2, b2)]:
            assert np.array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(a)
            if fin.any():
                assert np.max(np.abs(a[fin] - b[fin])) < 1e-11

    def test_objective_vs_f64(self):
        profiles = _profiles(u=2048)
        mult = np.random.default_rng(6).integers(1, 1000, 2048).astype(np.float64)
        nt = (profiles * mult[:, None]).sum(0).astype(np.float64)
        nt /= nt.sum()
        tab64 = jnp.asarray(lgamma_int_table(1023))
        gtab = lds.lgamma_table_ds(1024)
        obj64 = jax.jit(
            lambda th: lk.compound_neg_log_likelihood(
                th, jnp.asarray(profiles), jnp.asarray(mult), jnp.asarray(nt), tab64
            )
        )
        objds = jax.jit(
            lambda th: lds.compound_neg_log_likelihood_ds(
                th, jnp.asarray(profiles), jnp.asarray(mult), jnp.asarray(nt), gtab
            )
        )
        for th in [(1e-3, 1e-3), (0.1, 0.01), (0.0, 0.0), (1.0, 1.0), (0.0, 1.0),
                   (0.37, 0.11), (-0.1, 0.5), (0.5, 1.2)]:
            a = float(obj64(jnp.asarray(th, jnp.float64)))
            b = float(objds(jnp.asarray(th, jnp.float64)))
            assert abs(a - b) / max(abs(a), 1e-300) < 1e-13, (th, a, b)

    def test_ds_objective_drives_gsl_rule_to_oracle_fit(self):
        """The nmsimplex2 trajectory on the DS objective lands on the
        oracle's (pi, eps) at %g granularity (the mesh-path claim)."""
        from sid_tpu.exact.lynch_ld import estimate_profile_genotype_likelihoods_ld
        from sid_tpu.exact.nmsimplex import minimize_nmsimplex2
        from sid_tpu.ops.profiles import nucleotide_distribution

        profiles = _profiles(u=512, seed=11)
        keep = profiles.sum(-1) >= 4
        profiles = profiles[keep]
        mult = np.random.default_rng(7).integers(1, 500, profiles.shape[0]).astype(np.int64)
        nt = nucleotide_distribution(profiles, mult)
        pi_ld, eps_ld, _, _ = estimate_profile_genotype_likelihoods_ld(
            profiles, mult, nt
        )
        gtab = lds.lgamma_table_ds(1024)
        objds = jax.jit(
            lambda th: lds.compound_neg_log_likelihood_ds(
                th, jnp.asarray(profiles), jnp.asarray(mult.astype(np.float64)),
                jnp.asarray(nt), gtab
            )
        )
        res = minimize_nmsimplex2(
            lambda x: float(objds(jnp.asarray(x))), (1e-3, 1e-3), (1e-4, 1e-4)
        )
        assert res.converged
        assert f"{res.x[0]:g}" == f"{pi_ld:g}", (res.x[0], pi_ld)
        assert f"{res.x[1]:g}" == f"{eps_ld:g}", (res.x[1], eps_ld)


def _run_engine(text, prec_env, **opt_kw):
    """Run the engine with SIDTPU_DEVICE_PREC set, restoring env after."""
    from sid_tpu import engine

    saved = {}
    for k, v in prec_env.items():
        saved[k] = os.environ.get(k)
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        return engine.run(text, Options(**opt_kw), binary=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class TestEngineParity:
    """Forced-device runs at ds precision vs the default engine: same CSV."""

    @pytest.fixture(scope="class")
    def text(self):
        import synth

        return synth.make_bwa_like_pileup_scaled(4000)

    FORCE_DEVICE = {
        "SIDTPU_DEVICE_PREC": "ds",
        "SIDTPU_EXACT_LOCAL_MAX_U": "0",   # bypass the host-LD classifier
        "SIDTPU_NO_NATIVE_FINALIZE": "1",  # bypass the native quality finalize
    }

    def test_local_csv_equal(self, text):
        want = _run_engine(text, {}, method="local")
        got = _run_engine(text, self.FORCE_DEVICE, method="local")
        assert got == want

    def test_local_prior_csv_equal(self, text):
        want = _run_engine(text, {}, method="local", estimate_prior=True)
        got = _run_engine(text, self.FORCE_DEVICE, method="local", estimate_prior=True)
        assert got == want

    def test_quality_csv_equal(self, text):
        # mesh_devices=1 engages the device finalize path (single-device
        # default finalizes on host regardless of precision)
        want = _run_engine(text, {}, method="quality")
        got = _run_engine(text, self.FORCE_DEVICE, method="quality", mesh_devices=1)
        assert got == want

    def test_local_mesh8_csv_equal(self, text):
        want = _run_engine(text, {}, method="local")
        got = _run_engine(text, self.FORCE_DEVICE, method="local", mesh_devices=8)
        assert got == want


class TestFitParameterDrift:
    """DS-vs-f64 fitted-parameter agreement.

    The kernel- and CSV-level DS tests above cannot see a drifting fit
    OPTIMUM; this bounds |pi_ds - pi_f64| and |eps_ds - eps_f64| directly.
    Measured on CPU the two trajectories are bitwise identical (the
    objectives agree to ~1e-13 relative, and the 1e-5-size GSL stop makes
    the discrete trajectory insensitive at that gap) on realistic AND
    degenerate inputs; the tolerances below leave headroom for XLA version
    skew and for device libm differences.
    """

    def _fit_pair(self, profiles, mult):
        from sid_tpu.ops.nmsimplex import minimize_nmsimplex2_jax
        from sid_tpu.ops.profiles import nucleotide_distribution
        from sid_tpu.utils.padding import pad_axis0

        nt = nucleotide_distribution(profiles, mult)
        tab64 = jnp.asarray(lgamma_int_table(1023))
        gtab = lds.lgamma_table_ds(1024)
        fpad = jnp.asarray(pad_axis0(profiles.astype(np.int32)))
        mpad = jnp.asarray(pad_axis0(mult.astype(np.int64)))
        r64 = minimize_nmsimplex2_jax(
            lambda th: lk.compound_neg_log_likelihood(
                th, fpad, mpad, jnp.asarray(nt), tab64
            ),
            jnp.asarray([1e-3, 1e-3]), jnp.asarray([1e-4, 1e-4]),
        )
        rds = minimize_nmsimplex2_jax(
            lambda th: lds.compound_neg_log_likelihood_ds(
                th, fpad, mpad.astype(jnp.float64), jnp.asarray(nt), gtab
            ),
            jnp.asarray([1e-3, 1e-3]), jnp.asarray([1e-4, 1e-4]),
        )
        return (
            (float(r64.x[0]), float(r64.x[1])),
            (float(rds.x[0]), float(rds.x[1])),
        )

    def test_realistic_fit_params_agree(self):
        import sys

        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from synth import simulate_diploid_counts

        from sid_tpu.ops.profiles import filter_min_coverage, unique_profiles

        counts = simulate_diploid_counts(
            20000, coverage=30, pi=1e-3, eps=0.01, seed=41
        )
        p, m, _ = unique_profiles(counts)
        fp, fm, _ = filter_min_coverage(p, m, 4)
        (pi64, eps64), (pids, epsds) = self._fit_pair(fp, fm)
        assert abs(pi64 - pids) <= max(1e-8, 1e-4 * pi64), (pi64, pids)
        assert abs(eps64 - epsds) <= max(1e-9, 1e-5 * eps64), (eps64, epsds)

    def test_degenerate_near_zero_pi_fit_params_agree(self):
        # the bench microbench histogram: optimum pi ~ 3e-7 against a huge
        # eps — the most sensitive shape for a cross-precision fit
        rng = np.random.default_rng(1)
        u = 2000
        profiles = rng.multinomial(
            30, [0.85, 0.08, 0.05, 0.02], (u,)
        ).astype(np.int32)
        mult = rng.integers(1, 1000, u).astype(np.int64)
        (pi64, eps64), (pids, epsds) = self._fit_pair(profiles, mult)
        assert abs(pi64 - pids) <= 1e-6, (pi64, pids)
        assert abs(eps64 - epsds) <= max(1e-7, 1e-4 * eps64), (eps64, epsds)
