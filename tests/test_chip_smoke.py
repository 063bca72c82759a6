"""The GPU bring-up script and the compile-cache rule, checked on the CPU.

``chip_smoke.py`` itself runs only on a GPU; here it must refuse the CPU,
and its CSV comparison rule (device rows vs host rows) is pinned case by
case.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHIP_SMOKE = os.path.join(REPO, "chip_smoke.py")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_dir(tmp_path, env_set):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    got = subprocess.run(
        [sys.executable, "-c",
         "import sid_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True,
        timeout=120,
    ).stdout.strip()
    if env_set:
        assert got == str(tmp_path / "cache")
    else:
        assert got == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu():
    proc = subprocess.run(
        [sys.executable, CHIP_SMOKE], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a GPU" in proc.stderr


HEADER = "chrom,pos,label,gt,hom_conf,het_conf,conf_type"
ROWS = [
    "chr1,1,hom,GG,1.92946e-09,1,p_value",
    "chr1,2,het,AC,1,0.0499999,p_value",
    "chr1,3,hom,TT,0.999,0.001,probability",
    "chr1,4,hom,AA,nan,nan,p_value",
]


def _csv(rows):
    return ("\n".join([HEADER] + rows) + "\n").encode()


@pytest.mark.parametrize(
    "row,changed,failures,borderline",
    [
        (0, "chr1,1,hom,GG,1.92946e-09,1,p_value", 0, 0),  # byte-equal
        (0, "chr1,1,hom,GG,1.92955e-09,1,p_value", 0, 0),  # 4.7e-5 relative
        (0, "chr1,1,hom,GG,1.93146e-09,1,p_value", 1, 0),  # 1e-3 relative
        (2, "chr1,3,het,TG,0.999,0.001,probability", 1, 0),  # label flip
        (1, "chr1,2,hom,AA,1,0.0500000,p_value", 0, 1),  # flip at alpha
        (0, "chr1,7,hom,GG,1.92946e-09,1,p_value", 1, 0),  # pos changed
        (3, "chr1,4,hom,AA,-nan,-nan,p_value", 0, 0),  # NaN sign
    ],
    ids=["equal", "rtol", "beyond_rtol", "label_flip", "flip_at_alpha",
         "pos_changed", "nan_sign"],
)
def test_compare_csv_rule(row, changed, failures, borderline):
    cs = _load_chip_smoke()
    got_rows = list(ROWS)
    got_rows[row] = changed
    res = cs.compare_csv(_csv(ROWS), _csv(got_rows))
    assert res["rows"] == len(ROWS)
    assert res["not_byte_equal"] == int(changed != ROWS[row])
    assert len(res["failures"]) == failures
    assert len(res["borderline"]) == borderline
