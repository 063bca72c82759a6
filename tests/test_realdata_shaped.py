"""Real-data-shaped parity (BASELINE config 3 stand-in).

``tests/fixtures/realdata/bwa_like_100k.pileup.gz`` is a checked-in
100k-site pileup with the artifact mix of a BWA + samtools mpileup run
(generated by synth.make_bwa_like_pileup, seed 20260818): '^X'/'$' read
markers, '+N'/'-N' indels with inserted sequences, '*' deletion
placeholders, N reference sites, mixed strands/case, Phred variance in
both columns, 3 chromosomes with gapped positions. The gzipped fixture
also exercises the transparent gzip input path end-to-end.

Parity claims verified here:
- native parser == Python grammar spec on this data;
- device engine == long-double oracle CSV, byte-for-byte, all 4 methods;
- the independent C++ baseline binary agrees (tolerance, local method).
"""

import gzip
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest

from sid_tpu import engine
from sid_tpu.config import Options
from sid_tpu.io.pileup import parse_pileup
from tools.baseline.build import ensure_built

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "fixtures", "realdata", "bwa_like_100k.pileup.gz",
)
SHA256 = "340649476c02cef3ccc285e425e3c449748c36dfd39a6b91132cda5a0bf47136"


@pytest.fixture(scope="module")
def gz_bytes():
    with open(FIXTURE, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def raw_bytes(gz_bytes):
    raw = gzip.decompress(gz_bytes)
    assert hashlib.sha256(raw).hexdigest() == SHA256, "fixture drifted"
    return raw


def test_generator_is_reproducible(raw_bytes):
    """The checked-in fixture matches its generator (seeded PCG64 streams
    are stable across numpy versions), so the fixture is auditable."""
    from synth import make_bwa_like_pileup

    assert make_bwa_like_pileup(100000) == raw_bytes


def test_parser_differential(raw_bytes):
    """Native and Python parsers agree on artifact-rich real-shaped data."""
    slice_ = b"\n".join(raw_bytes.split(b"\n")[:4000]) + b"\n"
    py = parse_pileup(slice_, True, True, backend="python")
    nat = parse_pileup(slice_, True, True, backend="native")
    assert py.chrom_table == nat.chrom_table
    np.testing.assert_array_equal(py.counts, nat.counts)
    np.testing.assert_array_equal(py.pos, nat.pos)
    np.testing.assert_array_equal(py.read_offsets, nat.read_offsets)
    np.testing.assert_array_equal(py.read_code, nat.read_code)
    np.testing.assert_array_equal(py.read_bq, nat.read_bq)
    np.testing.assert_array_equal(py.read_mq, nat.read_mq)


def test_gzip_matches_plain(gz_bytes, raw_bytes):
    """.gz input produces byte-identical output to plain text input."""
    opts = Options(method="local")
    assert engine.run(gz_bytes, opts) == engine.run(raw_bytes, opts)


@pytest.mark.parametrize("method", ["local", "quality"])
def test_device_matches_oracle_full(gz_bytes, method):
    """Per-site methods: 100k artifact-rich sites, byte-for-byte parity."""
    dev = engine.run(gz_bytes, Options(method=method))
    oracle = engine.run(gz_bytes, Options(method=method, engine="exact"))
    assert dev == oracle
    assert dev.count("\n") == 100001  # header + every site emitted


@pytest.mark.parametrize("method", ["bayes", "likelihood_ratio"])
def test_device_matches_oracle_fit_methods(raw_bytes, method):
    """Fit methods on a 25k-site slice (the long-double oracle's marginal
    likelihoods are host-serial; the slice keeps the suite's runtime sane
    while covering every artifact class — the full fixture is exercised by
    the per-site methods above)."""
    slice_ = b"\n".join(raw_bytes.split(b"\n")[:25000]) + b"\n"
    opts = dict(method=method, estimate_prior=(method == "likelihood_ratio"))
    dev = engine.run(slice_, Options(**opts))
    oracle = engine.run(slice_, Options(**opts, engine="exact"))
    assert dev == oracle


def test_baseline_binary_agrees(raw_bytes, tmp_path):
    """The independent C++ implementation confirms both engines."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    exe = ensure_built()
    path = tmp_path / "raw.pileup"
    path.write_bytes(raw_bytes)
    out = subprocess.run([exe, str(path)], capture_output=True, text=True,
                         check=True).stdout
    ours = engine.run(raw_bytes, Options(method="local"))
    base_rows = out.strip().splitlines()[1:]
    our_rows = ours.strip().splitlines()[1:]
    assert len(base_rows) == len(our_rows) == 100000
    n_diff = 0
    for b, o in zip(base_rows, our_rows):
        bt, ot = b.split(","), o.split(",")
        assert bt[:4] == ot[:4]
        for k in (4, 5):
            if not np.isclose(float(bt[k]), float(ot[k]), rtol=1e-4,
                              atol=1e-300):
                n_diff += 1
    assert n_diff == 0
