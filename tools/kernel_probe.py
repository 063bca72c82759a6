#!/usr/bin/env python
"""Time each step of bench.py's kernel microbench, and trace a kernel.

    python tools/kernel_probe.py                      # every f64 kernel
    python tools/kernel_probe.py --ds local_log_likelihoods_ds
    python tools/kernel_probe.py --trace 20 local_log_likelihoods_f64

For each kernel of ``sid_tpu.utils.warmup.microbench_kernels``, at the
2^20-row bucket unless ``--rows`` says otherwise, it prints, step by step,
the seconds to lower, compile and run the single dispatch, then the same for
the K-iteration on-device loops that bench.py's per-execution timing builds. A ``start`` line is printed and
flushed before every step, so a run cut by a time limit shows the step it
was in.

``--trace N`` runs each kernel N more times under ``jax.profiler`` and
reduces the trace: device nanoseconds per call for every op on the device's
streams, their sum, and the bytes of the arguments and outputs over that
sum.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def step(name: str, label: str, fn):
    print(f"start {name} {label}", flush=True)
    t0 = time.perf_counter()
    out = fn()
    print(f"done  {name} {label}: {time.perf_counter() - t0:.3f}s", flush=True)
    return out


def device_ops(trace_dir: str, calls: int) -> dict:
    """Per-call device ns of each op on the device planes of the newest trace."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
                  key=os.path.getmtime)[-1]
    ops = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                ops[ev.name] = ops.get(ev.name, 0.0) + ev.duration_ns / calls
    return ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", help="kernel names (default: all)")
    ap.add_argument("--ds", action="store_true", help="include the double-single kernels")
    ap.add_argument("--no-loops", action="store_true", help="skip the K-iteration loops")
    ap.add_argument("--rows", type=int, default=None, help="input rows (default 2^20)")
    ap.add_argument("--trace", type=int, default=0, metavar="N",
                    help="trace N calls of each kernel and reduce the trace")
    ap.add_argument("--trace-dir", default=os.path.join(REPO, ".kernel_trace"))
    args = ap.parse_args(argv)
    if args.ds:
        os.environ["SIDTPU_WARM_DS"] = "1"

    import jax

    import sid_tpu  # noqa: F401  (x64 and the compile cache)
    from sid_tpu.utils.warmup import (
        LOOP_K_BIG, LOOP_K_SMALL, MICROBENCH_U, make_looped_kernel,
        microbench_inputs, microbench_kernels,
    )

    dev = jax.devices()[0]
    print(f"jax {jax.__version__} {dev.platform} {dev.device_kind}", flush=True)
    rows = args.rows or MICROBENCH_U
    inputs = step("inputs", f"{rows} rows", lambda: microbench_inputs(rows))
    kernels = [(n, f) for n, f in microbench_kernels() if not args.kernels or n in args.kernels]
    if not kernels:
        print(f"no kernel matches {args.kernels}", file=sys.stderr)
        return 1
    for name, fn in kernels:
        jitted = jax.jit(fn)
        lowered = step(name, "lower", lambda: jitted.lower(inputs))
        compiled = step(name, "compile", lowered.compile)
        step(name, "execute", lambda: jax.block_until_ready(compiled(inputs)))
        if args.trace:
            # the executable's own arguments (jit drops inputs it never
            # reads) and outputs
            mem = compiled.memory_analysis()
            n_bytes = mem.argument_size_in_bytes + mem.output_size_in_bytes
            tdir = os.path.join(args.trace_dir, name)
            with jax.profiler.trace(tdir):
                for _ in range(args.trace):
                    jax.block_until_ready(compiled(inputs))
            ops = device_ops(tdir, args.trace)
            total = sum(ops.values())
            for op, ns in sorted(ops.items(), key=lambda kv: -kv[1]):
                print(f"trace {name} {op}: {ns / 1e3:.1f} us per call")
            rate = f"{n_bytes / total:.3f} GB/s" if total else "no device ops"
            print(f"trace {name}: {total / 1e3:.1f} us of device time per call, "
                  f"{n_bytes} B of arguments and outputs, {rate}", flush=True)
        if args.no_loops:
            continue
        for k in (LOOP_K_SMALL, LOOP_K_BIG):
            looped = make_looped_kernel(fn, k)
            lowered = step(name, f"x{k} loop lower", lambda: looped.lower(inputs))
            compiled = step(name, f"x{k} loop compile", lowered.compile)
            step(name, f"x{k} loop execute", lambda: jax.block_until_ready(compiled(inputs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
