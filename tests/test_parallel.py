"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY §4).

Shard the same pileup 1-way vs N-way and assert identical output; validate
the globally-sharded Lynch fit against the single-device fit and the
per-shard-fit (reference script semantics) mode.
"""

import numpy as np
import pytest

import jax

from sid_tpu.config import Options
from sid_tpu.engine import call_batch
from sid_tpu.io.pileup import parse_pileup
from sid_tpu.models.lynch import fit_on_filtered_profiles
from sid_tpu.ops.profiles import filter_min_coverage, unique_profiles
from sid_tpu.parallel.fit import fit_lynch_global
from sid_tpu.parallel.mesh import SITE_AXIS, make_site_mesh
from sid_tpu.parallel.pipeline import call_per_shard, split_by_chromosome, split_ranges

from synth import make_pileup_text, simulate_diploid_counts


@pytest.fixture(scope="module")
def batch():
    counts = simulate_diploid_counts(500, coverage=25, pi=0.02, eps=0.01)
    text = make_pileup_text(counts, with_qualities=True)
    return parse_pileup(text, True, True, backend="python")


@pytest.fixture(scope="module")
def two_chrom_batch():
    c1 = simulate_diploid_counts(300, coverage=20, pi=0.02, eps=0.01, seed=1)
    c2 = simulate_diploid_counts(200, coverage=20, pi=0.05, eps=0.02, seed=2)
    text = make_pileup_text(c1, chrom="chr1", with_qualities=True) + make_pileup_text(
        c2, chrom="chr2", with_qualities=True, seed=9
    )
    return parse_pileup(text, True, True, backend="python")


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


class TestGlobalShardedFit:
    def test_matches_single_device_fit(self, batch):
        profiles, mult, _ = unique_profiles(batch.counts)
        profiles, mult, _ = filter_min_coverage(profiles, mult, 4)
        pi1, eps1, lh1, lt1, nt1 = fit_on_filtered_profiles(profiles, mult)
        mesh = make_site_mesh(8)
        pi8, eps8, lh8, lt8, nt8 = fit_lynch_global(profiles, mult, mesh)
        # the sharded reduction reorders sums; the optimum must agree tightly
        assert pi8 == pytest.approx(pi1, rel=1e-6, abs=1e-9)
        assert eps8 == pytest.approx(eps1, rel=1e-6, abs=1e-9)
        np.testing.assert_allclose(lh8, lh1, rtol=1e-9)
        np.testing.assert_allclose(lt8, lt1, rtol=1e-9)

    def test_mesh_sizes_agree(self, batch):
        profiles, mult, _ = unique_profiles(batch.counts)
        profiles, mult, _ = filter_min_coverage(profiles, mult, 4)
        results = []
        for k in (1, 2, 8):
            mesh = make_site_mesh(k)
            pi, eps, _, _, _ = fit_lynch_global(profiles, mult, mesh)
            results.append((pi, eps))
        for pi, eps in results[1:]:
            assert pi == pytest.approx(results[0][0], rel=1e-6, abs=1e-9)
            assert eps == pytest.approx(results[0][1], rel=1e-6, abs=1e-9)

    def test_method_csv_with_mesh(self, batch):
        base = call_batch(batch, Options(method="bayes"))
        meshy = call_batch(batch, Options(method="bayes", mesh_devices=8))
        assert base.to_csv() == meshy.to_csv()


class TestShardInvariance:
    """Per-site/per-profile methods must be exactly shard-invariant."""

    @pytest.mark.parametrize("method", ["local", "quality"])
    def test_range_split_identical(self, batch, method, monkeypatch):
        opts = Options(method=method)
        whole = call_batch(batch, opts).to_csv()
        from sid_tpu.engine import call_batch as cb
        from sid_tpu.parallel.pipeline import concat_results

        parts = [cb(s, opts) for s in split_ranges(batch, 4)]
        merged = concat_results(parts).to_csv()
        assert merged == whole


class TestUnevenMesh:
    """A mesh whose size does not divide the power-of-two bucket still
    shards every input: the site axis pads to a multiple of the mesh size."""

    @pytest.mark.parametrize("exact", [True, False], ids=["exact_pvalues", "device_erfc"])
    @pytest.mark.parametrize("method", ["local", "quality"])
    @pytest.mark.parametrize("n_dev", [3, 6])
    def test_matches_one_device(self, batch, n_dev, method, exact, monkeypatch):
        one = call_batch(
            batch, Options(method=method, mesh_devices=1, exact_pvalues=exact)
        ).to_csv()
        placed = []
        device_put = jax.device_put

        def recording_put(x, *args, **kwargs):
            out = device_put(x, *args, **kwargs)
            placed.append(out)
            return out

        monkeypatch.setattr(jax, "device_put", recording_put)
        many = call_batch(
            batch, Options(method=method, mesh_devices=n_dev, exact_pvalues=exact)
        ).to_csv()
        monkeypatch.undo()
        assert many == one
        sharded = [
            a for a in placed
            if isinstance(a.sharding, jax.sharding.NamedSharding)
            and a.sharding.spec and a.sharding.spec[0] == SITE_AXIS
        ]
        assert sharded
        for a in sharded:
            rows = [s.data.shape[0] for s in a.addressable_shards]
            assert len(rows) == n_dev
            assert min(rows) > 0 and sum(rows) == a.shape[0]


class TestPerShardFit:
    def test_per_chromosome_semantics(self, two_chrom_batch):
        opts = Options(method="likelihood_ratio", per_shard_fit=True)
        merged = call_batch(two_chrom_batch, opts).to_csv()

        # manual per-chromosome runs (the GNU-parallel semantics)
        shards = split_by_chromosome(two_chrom_batch)
        opts1 = Options(method="likelihood_ratio")
        parts = [call_batch(s, opts1) for s in shards]
        manual = (
            parts[0].to_csv()
            + parts[1].to_csv(include_header=False)
        )
        assert merged == manual

    def test_differs_from_global_fit(self, two_chrom_batch):
        # chr1 and chr2 were simulated with different (pi, eps): per-shard
        # and global fits must produce different confidences
        global_csv = call_batch(
            two_chrom_batch, Options(method="bayes")
        ).to_csv()
        per_shard_csv = call_batch(
            two_chrom_batch, Options(method="bayes", per_shard_fit=True)
        ).to_csv()
        assert global_csv != per_shard_csv


class TestConcatPayload:
    def test_concat_keeps_indexed_class_payload(self, two_chrom_batch):
        from sid_tpu.parallel.pipeline import concat_results

        shards = split_by_chromosome(two_chrom_batch)
        opts = Options(method="local")
        parts = [call_batch(s, opts) for s in shards]
        merged = concat_results(parts)
        # the per-class payload survives the merge (indexed CSV fast path)
        assert merged.class_idx is not None
        assert merged.cls_is_het.shape[0] == sum(p.cls_is_het.shape[0] for p in parts)
        # and the indexed serialization equals the per-row path
        row_wise = "".join(
            p.to_csv(include_header=(i == 0)) for i, p in enumerate(parts)
        )
        assert merged.to_csv() == row_wise
        np.testing.assert_array_equal(
            merged.cls_is_het[merged.class_idx], merged.is_het
        )
