#!/usr/bin/env python
"""Bring-up check of sid-tpu's device path on a GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # only the four-card site-mesh phase

One card runs the four calling methods (``local``, ``quality``, ``bayes``,
``-R -m likelihood_ratio``) through ``engine.run`` on a seeded 1M-site ~30x
pileup (``bench.generate``) and on the 100k-site grammar-rich fixture, in
three legs each:

- (a) default flags (host long-double classify and fit);
- (b) ``mesh_devices=1``: the sharded device kernels and the psum fit;
- (c) on a 50k-site slice, the device functions no CLI flag reaches:
  ``exact_pvalues=False`` (device erfc LRT) and ``fit_backend="device"``.

Every (b) and (c) leg must make device dispatches. (a) must equal the
long-double oracle (``--engine exact``) byte for byte on the slice; (b) and
(c) must equal (a) under the rule of ``compare_csv``. The device fit's
(pi, eps) must be within 1e-6 relative of the exact host fit's.

Exits non-zero at the first failure and on any platform but a GPU. The last
line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "realdata", "bwa_like_100k.pileup.gz")
CLEAN_SITES = 1_000_000
SLICE_SITES = 50_000
ALPHA = 0.05  # the default -p
CONF_RTOL = 1e-4
FIT_RTOL = 1e-6
# (name, Options kwargs); -R -m likelihood_ratio is the reference's pipeline
METHODS = [
    ("local", {"method": "local"}),
    ("quality", {"method": "quality"}),
    ("bayes", {"method": "bayes"}),
    ("likelihood_ratio", {"method": "likelihood_ratio", "estimate_prior": True}),
]
# the jitted kernels whose compiled memory footprint is reported
KERNELS = [
    ("sid_tpu.models.local", "local_log_likelihoods"),
    ("sid_tpu.models.quality", "finalize_quality_het_nk"),
    ("sid_tpu.models.lynch", "fit_lynch"),
]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- comparison


def _conf_close(a: str, b: str) -> bool:
    x, y = float(a), float(b)
    if x != x and y != y:  # both NaN ("nan"/"-nan")
        return True
    return abs(x - y) <= CONF_RTOL * abs(y) + 1e-300


def compare_csv(want: bytes, got: bytes, alpha: float = ALPHA) -> dict:
    """Compare two sid CSVs under the device-vs-host rule.

    ``chrom,pos,label,gt,conf_type`` must be equal and ``hom_conf,het_conf``
    agree to rtol 1e-4 (the rule of tests/test_baseline_binary.py). A
    ``label`` (and so ``gt``) may differ only on a p-value row whose het
    confidence lies within 1e-6 relative of ``alpha``: such rows are
    returned as ``borderline``. Returns the row count, the count of rows
    that are not byte-equal, the borderline rows and the failures.
    """
    a_rows = want.rstrip(b"\n").split(b"\n")
    b_rows = got.rstrip(b"\n").split(b"\n")
    out = {"rows": len(a_rows) - 1, "not_byte_equal": 0, "borderline": [], "failures": []}
    if a_rows[0] != b_rows[0] or len(a_rows) != len(b_rows):
        out["failures"].append(
            f"header/row count differ: {a_rows[0]!r} x{len(a_rows)} vs {b_rows[0]!r} x{len(b_rows)}"
        )
        return out
    for ra, rb in zip(a_rows[1:], b_rows[1:]):
        if ra == rb:
            continue
        out["not_byte_equal"] += 1
        fa = ra.decode().split(",")
        fb = rb.decode().split(",")
        if len(fa) != 7 or len(fb) != 7 or fa[:2] != fb[:2] or fa[6] != fb[6]:
            out["failures"].append(f"{ra.decode()} | {rb.decode()}")
            continue
        if not (_conf_close(fb[4], fa[4]) and _conf_close(fb[5], fa[5])):
            out["failures"].append(f"{ra.decode()} | {rb.decode()}")
            continue
        if fa[2:4] != fb[2:4]:
            near = fa[6] == "p_value" and any(
                abs(float(p) - alpha) <= 1e-6 * alpha for p in (fa[5], fb[5])
            )
            (out["borderline"] if near else out["failures"]).append(
                f"{ra.decode()} | {rb.decode()}"
            )
    return out


# ------------------------------------------------------------------- phases


def check_platform():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is {dev.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    return dev


def identify(dev) -> None:
    import jax

    import sid_tpu  # noqa: F401  (sets the compile cache)

    print(f"jax {jax.__version__}")
    print(f"device_kind {dev.device_kind}, devices {len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print("nvidia-smi name, power.limit:")
    print(smi)
    print(f"host cores {os.cpu_count()}")
    print(f"compile cache {jax.config.jax_compilation_cache_dir}")


def build() -> None:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "sid_tpu.native.build"], cwd=REPO, check=True)
    from tools.baseline.build import ensure_built

    ensure_built()
    from sid_tpu.io import native

    check(native.available(), "libsidtpu did not load after the build")
    print(f"built libsidtpu and sid_baseline in {time.perf_counter() - t0:.1f}s")


def head_sites(text: bytes, n: int) -> bytes:
    end = -1
    for _ in range(n):
        end = text.find(b"\n", end + 1)
        if end < 0:
            return text
    return text[: end + 1]


def make_inputs(clean_sites: int = CLEAN_SITES) -> dict:
    import bench

    t0 = time.perf_counter()
    clean = bench.generate(clean_sites)
    with gzip.open(FIXTURE, "rb") as f:
        bwa = f.read()
    print(f"inputs in {time.perf_counter() - t0:.1f}s: clean {clean.count(b'\n')} sites "
          f"({len(clean)} B), bwa_like {bwa.count(b'\n')} sites ({len(bwa)} B)")
    return {"clean": clean, "bwa_like": bwa}


class KernelRecorder:
    """Wraps the jitted kernels to record the abstract arguments they see."""

    def __init__(self):
        import importlib

        self.calls = {}
        self._saved = []
        for mod_name, fn_name in KERNELS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            self._saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, self._wrap(fn_name, fn))

    def _wrap(self, name, fn):
        import jax

        def wrapper(*args):
            spec = tuple(
                jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding)
                if isinstance(a, jax.Array) else a
                for a in args
            )
            key = tuple((s.shape, str(s.dtype)) if hasattr(s, "shape") else s for s in spec)
            self.calls.setdefault(name, {}).setdefault(key, (fn, spec, args))
            return fn(*args)

        return wrapper

    def restore(self):
        for mod, fn_name, fn in self._saved:
            setattr(mod, fn_name, fn)

    def print_memory(self):
        for name, by_shape in self.calls.items():
            for key, (fn, spec, _) in by_shape.items():
                mem = fn.lower(*spec).compile().memory_analysis()
                fields = {
                    f: getattr(mem, f) for f in (
                        "argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "generated_code_size_in_bytes",
                    ) if mem is not None and hasattr(mem, f)
                }
                shapes = [k[0] for k in key if isinstance(k, tuple)]
                print(f"memory_analysis {name} {shapes}: {fields}")

    def print_shardings(self):
        for name, by_shape in self.calls.items():
            for _, (_, _, args) in by_shape.items():
                for a in args:
                    if hasattr(a, "addressable_shards") and a.ndim:
                        rows = {s.device.id: s.data.shape[0] for s in a.addressable_shards}
                        print(f"sharding {name} {a.shape}: {a.sharding} rows/device {rows}")


def run_leg(label: str, text: bytes, opts) -> tuple:
    """engine.run under an active stage profile; returns (csv, dispatches)."""
    import jax.monitoring

    from sid_tpu import engine
    from sid_tpu.utils import profiling

    compile_s = [0.0]

    def on_duration(event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            compile_s[0] += duration

    prof = profiling.StageProfile()
    profiling.activate(prof)
    jax.monitoring.register_event_duration_secs_listener(on_duration)
    t0 = time.perf_counter()
    try:
        csv = engine.run(text, opts, binary=True)
    finally:
        wall = time.perf_counter() - t0
        jax.monitoring.unregister_event_duration_listener(on_duration)
        profiling.activate(None)
    dev = {}
    for name, sec in prof.stages:
        if name.startswith("device:"):
            dev[name] = round(dev.get(name, 0.0) + sec, 4)
    n = int(prof.counters.get("device_dispatches", 0))
    print(f"leg {label}: wall {wall:.3f}s, compile {compile_s[0]:.3f}s, "
          f"device_dispatches {n}, device stages {dev}, rows {csv.count(b'\n') - 1}")
    return csv, n


def require_device(label: str, n_dispatch: int) -> None:
    check(n_dispatch > 0, f"{label}: no device dispatch")


def report_compare(label: str, want: bytes, got: bytes) -> None:
    res = compare_csv(want, got)
    print(f"compare {label}: {res['rows']} rows, {res['not_byte_equal']} not byte-equal, "
          f"{len(res['borderline'])} borderline label flips, {len(res['failures'])} failures")
    for row in res["borderline"][:20]:
        print(f"  borderline {row}")
    for row in res["failures"][:20]:
        print(f"  FAIL {row}")
    check(not res["failures"], f"{label}: device rows differ beyond the rule")


def check_fits(label: str, text: bytes, mesh_devices: int = 1) -> None:
    """Device fits (psum over the mesh, and fit_lynch alone) vs the exact fit."""
    from sid_tpu.exact.lynch_ld import estimate_profile_genotype_likelihoods_ld
    from sid_tpu.io.pileup import parse_pileup
    from sid_tpu.models.lynch import fit_on_filtered_profiles
    from sid_tpu.ops.profiles import filter_min_coverage, nucleotide_distribution, unique_profiles
    from sid_tpu.parallel.fit import fit_lynch_global
    from sid_tpu.parallel.mesh import make_site_mesh

    batch = parse_pileup(text)
    profiles, mult, _ = unique_profiles(batch.counts)
    fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)

    def iterations(lines):
        for line in lines:
            m = re.search(r"in (\d+) iterations", line)
            if m:
                return int(m.group(1))
        return None

    lines = []
    t0 = time.perf_counter()
    pi0, eps0, _, _ = estimate_profile_genotype_likelihoods_ld(
        fprof, fmult, nucleotide_distribution(fprof, fmult), log=lines.append
    )
    print(f"fit {label} exact: pi {pi0!r} eps {eps0!r} iterations {iterations(lines)} "
          f"U {fprof.shape[0]} ({time.perf_counter() - t0:.3f}s)")
    routes = [
        (f"psum mesh {mesh_devices}",
         lambda log: fit_lynch_global(fprof, fmult, make_site_mesh(mesh_devices), log)),
        ("fit_lynch", lambda log: fit_on_filtered_profiles(fprof, fmult, log)),
    ]
    for route, fit in routes:
        lines = []
        t0 = time.perf_counter()
        pi, eps, _, _, _ = fit(lines.append)
        d_pi, d_eps = abs(pi - pi0) / abs(pi0), abs(eps - eps0) / abs(eps0)
        print(f"fit {label} device {route}: pi {pi!r} eps {eps!r} iterations "
              f"{iterations(lines)} rel d_pi {d_pi:.3e} d_eps {d_eps:.3e} "
              f"({time.perf_counter() - t0:.3f}s)")
        check(d_pi <= FIT_RTOL and d_eps <= FIT_RTOL,
              f"fit {label} {route}: (pi, eps) beyond {FIT_RTOL} relative")


def one_card(clean_sites: int = CLEAN_SITES, slice_sites: int = SLICE_SITES) -> None:
    from sid_tpu.config import Options

    recorder = KernelRecorder()
    try:
        for name, text in make_inputs(clean_sites).items():
            part = head_sites(text, slice_sites)
            for method, kw in METHODS:
                tag = f"{name}/{method}"
                a_full, _ = run_leg(f"{tag} (a) default", text, Options(**kw))
                a_part, _ = run_leg(f"{tag} (a) default slice", part, Options(**kw))
                exact, _ = run_leg(f"{tag} exact slice", part, Options(engine="exact", **kw))
                check(a_part == exact, f"{tag}: default output differs from --engine exact")
                print(f"compare {tag} (a) vs exact on {slice_sites}-site slice: byte-equal")
                b_full, n = run_leg(f"{tag} (b) mesh_devices=1", text,
                                    Options(mesh_devices=1, **kw))
                require_device(f"{tag} (b)", n)
                report_compare(f"{tag} (b) vs (a)", a_full, b_full)
                c_part, n = run_leg(f"{tag} (c) device-only functions slice", part,
                                    Options(exact_pvalues=False, fit_backend="device", **kw))
                require_device(f"{tag} (c)", n)
                report_compare(f"{tag} (c) vs (a) slice", a_part, c_part)
            check_fits(name, text)
            check_fits(f"{name} slice", part)
        recorder.print_memory()
    finally:
        recorder.restore()


def multi_card(n_cards: int, clean_sites: int = CLEAN_SITES) -> None:
    import jax

    from sid_tpu.config import Options

    check(len(jax.devices()) >= n_cards,
          f"--cards {n_cards}: only {len(jax.devices())} devices visible")
    text = make_inputs(clean_sites)["clean"]
    for method, kw in METHODS:
        one, n1 = run_leg(f"clean/{method} mesh_devices=1", text, Options(mesh_devices=1, **kw))
        recorder = KernelRecorder()
        try:
            many, n = run_leg(f"clean/{method} mesh_devices={n_cards}", text,
                              Options(mesh_devices=n_cards, **kw))
            recorder.print_shardings()
        finally:
            recorder.restore()
        require_device(f"{method} mesh_devices={n_cards}", min(n1, n))
        if method in ("local", "quality"):
            check(one == many, f"{method}: {n_cards}-card CSV differs from one card")
            print(f"compare {method} mesh {n_cards} vs mesh 1: byte-equal")
        else:
            report_compare(f"{method} mesh {n_cards} vs mesh 1", one, many)
    check_fits("clean", text, mesh_devices=n_cards)
    import __graft_entry__

    __graft_entry__.dryrun_multichip(n_cards)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the site-mesh phase on this many cards (default: one card, every phase)")
    args = ap.parse_args(argv)
    dev = check_platform()
    identify(dev)
    build()
    t0 = time.perf_counter()
    try:
        if args.cards > 1:
            multi_card(args.cards)
        else:
            one_card()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    import jax

    print(f"phases done in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
