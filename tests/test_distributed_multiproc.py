"""Real multi-process jax.distributed execution (verdict-r2 #2).

Spawns two OS processes on the CPU backend (Gloo collectives over
127.0.0.1), drives the actual ``--multihost`` CLI surface in both, and
asserts the merged output is byte-equal to a single-process run of the same
input. This is the first execution of the ``jax.process_count() > 1``
branches: allgather_histogram's padded uint64 gather + per-process unpack
(distributed.py), the parts barrier, and the coordinator merge.

Reference mapping: the reference's multi-node story is the GNU-parallel
per-chromosome fan-out (scripts/sid-pipeline/parallel-run-sid.sh:2) with
per-shard statistics; this backend upgrades it to a single global fit
(SURVEY §5.8) while keeping byte-identical output for any process count.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from synth import make_pileup_text, simulate_diploid_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _subprocess_env(extra):
    env = dict(os.environ)
    # one CPU device per process: drop the test harness's 8-virtual-device
    # forcing so the subprocesses model two plain hosts
    flags = env.get("XLA_FLAGS", "")
    env["XLA_FLAGS"] = " ".join(
        f for f in flags.split() if "host_platform_device_count" not in f
    )
    env["SIDTPU_PLATFORM"] = "cpu"
    # pin the BACKEND too: SIDTPU_PLATFORM only steers the CLI, so a
    # raw-script child would otherwise default to an accelerator, whose
    # client allocations would pollute the RSS-bounded merge assertion;
    # these children model plain CPU hosts
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _run_cli(args, env, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", "sid_tpu.cli", *args],
        env=env,
        cwd=REPO,
        capture_output=True,
        timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    return proc


def _spawn_multihost(args, n, port):
    procs = []
    for pid in range(n):
        env = _subprocess_env(
            {
                "SIDTPU_COORDINATOR": f"127.0.0.1:{port}",
                "SIDTPU_NUM_PROCESSES": str(n),
                "SIDTPU_PROCESS_ID": str(pid),
            }
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "sid_tpu.cli", *args],
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, _, err in outs:
        assert rc == 0, err.decode()[-2000:]
    return outs


@pytest.fixture(scope="module")
def pileup_file(tmp_path_factory):
    # two "chromosomes" with different diversity so the per-process byte
    # ranges produce histograms of DIFFERENT sizes — exercising the u_max
    # padding in allgather_histogram
    rng_counts = simulate_diploid_counts(400, coverage=22, pi=0.03, eps=0.012)
    uniform = np.tile(np.array([[20, 0, 0, 0]]), (400, 1))
    counts = np.concatenate([rng_counts, uniform])
    text = make_pileup_text(counts, with_qualities=True)
    path = tmp_path_factory.mktemp("mh") / "in.pileup"
    path.write_bytes(text)
    return str(path)


@pytest.mark.slow
@pytest.mark.parametrize(
    "method_args",
    [
        ["-R", "-m", "likelihood_ratio"],  # fit + BH + omitted-site join
        ["-R", "-m", "quality"],  # per-site path + global prior
        ["-m", "bayes"],
        ["-m", "local"],
    ],
    ids=["lr_R", "quality_R", "bayes", "local"],
)
def test_two_process_byte_equal(pileup_file, tmp_path, method_args):
    single = tmp_path / "single.csv"
    multi = tmp_path / "multi.csv"

    env1 = _subprocess_env({})
    _run_cli([*method_args, "--output", str(single), pileup_file], env1)

    port = _free_port()
    _spawn_multihost(
        [*method_args, "--multihost", "--output", str(multi), pileup_file],
        2,
        port,
    )
    assert multi.read_bytes() == single.read_bytes()


@pytest.mark.slow
def test_two_process_tiny_chunks_byte_equal(pileup_file, tmp_path):
    # memory-bounded multihost (verdict-r2 #3): with a 4 KB chunk size each
    # process's ranges split into many chunks, so both the histogram pass
    # and the classify/write pass genuinely stream; output must not change
    single = tmp_path / "single.csv"
    multi = tmp_path / "multi.csv"
    env1 = _subprocess_env({})
    _run_cli(
        ["-R", "-m", "likelihood_ratio", "--output", str(single), pileup_file],
        env1,
    )
    port = _free_port()
    procs = []
    for pid in range(2):
        env = _subprocess_env(
            {
                "SIDTPU_COORDINATOR": f"127.0.0.1:{port}",
                "SIDTPU_NUM_PROCESSES": "2",
                "SIDTPU_PROCESS_ID": str(pid),
                "SIDTPU_CHUNK_BYTES": "4096",
            }
        )
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "sid_tpu.cli", "-R", "-m",
                    "likelihood_ratio", "--multihost", "--output", str(multi),
                    pileup_file,
                ],
                env=env,
                cwd=REPO,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]
    assert multi.read_bytes() == single.read_bytes()


@pytest.mark.slow
def test_three_process_uneven_ranges(pileup_file, tmp_path):
    # 3 processes over 800 lines: ranges are not equal-sized and histogram
    # cardinalities differ per process
    single = tmp_path / "single.csv"
    multi = tmp_path / "multi.csv"
    env1 = _subprocess_env({})
    _run_cli(["-m", "bayes", "--output", str(single), pileup_file], env1)
    port = _free_port()
    _spawn_multihost(
        ["-m", "bayes", "--multihost", "--output", str(multi), pileup_file],
        3,
        port,
    )
    assert multi.read_bytes() == single.read_bytes()


@pytest.mark.slow
def test_checkpoint_resume_two_process(pileup_file, tmp_path):
    """--checkpoint persists the merged histogram; --resume skips pass 1
    (all-processes decision) and reuses completed parts; output unchanged."""
    ckpt = tmp_path / "hist.npz"
    out1 = tmp_path / "first.csv"
    out2 = tmp_path / "resumed.csv"
    args = ["-R", "-m", "likelihood_ratio", "--multihost",
            "--checkpoint", str(ckpt)]
    port = _free_port()
    _spawn_multihost([*args, "--output", str(out1), pileup_file], 2, port)
    assert ckpt.exists()
    port = _free_port()
    _spawn_multihost(
        [*args, "--resume", "--output", str(out2), pileup_file], 2, port
    )
    assert out2.read_bytes() == out1.read_bytes()


def test_part_resume_reuses_completed_ranges(pileup_file, tmp_path):
    """Single-process mechanism test: a part with a matching .done
    fingerprint is reused verbatim; a stale-fingerprint part is recomputed."""
    import dataclasses

    from sid_tpu.config import Options
    from sid_tpu.parallel.distributed import byte_ranges, run_multihost
    from sid_tpu.utils.checkpoint import input_fingerprint

    opts = Options(method="local", resume=True, output="ignored")
    out = tmp_path / "o.csv"
    ranges = byte_ranges(pileup_file, 2)
    fp = input_fingerprint(pileup_file)

    # plant a sentinel part for the SECOND range with a valid marker
    sentinel = b"SENTINEL-REUSED\n"
    start = ranges[1][0]
    part = f"{out}.part{start:016d}"
    with open(part, "wb") as f:
        f.write(sentinel)
    with open(part + ".done", "w") as f:
        f.write(fp)
    run_multihost(pileup_file, opts, str(out), ranges_per_process=2)
    data = out.read_bytes()
    assert sentinel in data  # the completed range was reused, not recomputed

    # same plant but with a stale fingerprint: must be recomputed
    out_b = tmp_path / "b.csv"
    part_b = f"{out_b}.part{start:016d}"
    with open(part_b, "wb") as f:
        f.write(sentinel)
    with open(part_b + ".done", "w") as f:
        f.write("stale:fingerprint")
    run_multihost(pileup_file, opts, str(out_b), ranges_per_process=2)
    assert sentinel not in out_b.read_bytes()

@pytest.mark.slow
def test_coordinator_merge_memory_bounded(pileup_file, tmp_path):
    """The ordered merge must stream part files, not materialize them
    (verdict-r3 weak #2): with two planted ~96 MB parts, the merge's RSS
    high-water delta must stay far below one part's size."""
    script = r"""
import resource, sys
from sid_tpu.config import Options
from sid_tpu.parallel.distributed import byte_ranges, run_multihost
from sid_tpu.utils.checkpoint import input_fingerprint

src, out = sys.argv[1], sys.argv[2]
ranges = byte_ranges(src, 2)
fp = input_fingerprint(src)
row = b"chr1,1,hom,AA,1,0,p_value\n"
blob = row * (96 * 1024 * 1024 // len(row))
for start, _ in ranges:
    part = f"{out}.part{start:016d}"
    with open(part, "wb") as f:
        f.write(blob)
    with open(part + ".done", "w") as f:
        f.write(fp)
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
run_multihost(src, Options(method="local", resume=True, output="x"), out,
              ranges_per_process=2)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
delta_mb = (after - before) / 1024.0
print(f"merge RSS delta: {delta_mb:.1f} MB")
assert delta_mb < 48, f"merge materialized parts: +{delta_mb:.1f} MB"
"""
    env = _subprocess_env({})
    out = tmp_path / "merged.csv"
    proc = subprocess.run(
        [sys.executable, "-c", script, pileup_file, str(out)],
        env=env, cwd=REPO, capture_output=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    # both parts landed in the merged output
    assert out.stat().st_size > 2 * 90 * 1024 * 1024
