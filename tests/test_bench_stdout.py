"""The bench's stdout contract: exactly one compact, parseable JSON line.

A harness that keeps only a 2000-char tail of bench output and json-parses
its last line loses a record whose single line grows past that. This test
runs the real bench.py in a subprocess (CPU backend, SMOKE mode: tiny
input, no device legs) and asserts that parse recipe works:

- stdout is exactly one line,
- that line is valid JSON with the required fields,
- the line is short enough to survive the 2000-char tail even with a few
  hundred chars of trailing noise after it.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


@pytest.mark.slow
def test_bench_stdout_is_one_compact_json_line(tmp_path):
    env = dict(
        os.environ,
        SIDTPU_BENCH_SMOKE="1",
        SIDTPU_PLATFORM="cpu",
        SIDTPU_BENCH_DETAIL=str(tmp_path / "detail.json"),
    )
    proc = subprocess.run(
        [sys.executable, BENCH],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=env,
        timeout=600,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    out = proc.stdout.decode()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, f"stdout must be one JSON line, got {len(lines)}: {out[:500]}"
    line = lines[0]
    # the driver sees only the last 2000 combined-output chars; leave margin
    assert len(line) < 1900, f"compact line too long ({len(line)} chars)"
    rec = json.loads(line)
    assert rec["metric"] == "local_method_end_to_end_sites_per_sec_1chip"
    assert rec["unit"] == "sites/s"
    assert rec["value"] > 0
    assert "vs_baseline" in rec
    assert rec["platform"] == "cpu"
    # the full record went to the detail file instead of stdout
    detail = json.loads((tmp_path / "detail.json").read_text())
    assert detail["methods"]["local"]["sites_per_sec"] == pytest.approx(
        rec["value"]
    )
