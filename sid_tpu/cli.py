"""Command-line interface, flag-compatible with the reference ``sid``.

Reproduces sid.cpp:11-110: the same short flags with the same defaults and
help text (-m method, -r fixed prior, -R estimated prior, -p significance
level, -E site error cap, -h), the header-only output for unrecognized
methods, "No file name given!" on missing input, and exit codes. Framework
knobs (engine/fit backend, mesh shape, output path) are long options the
reference never had, so every reference invocation works unchanged.
"""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

from sid_tpu.config import Options

# (name-for-help, takes_arg, description) in the reference's map order
# (std::map<char, ...> iterates in char order: E R h m p r; sid.cpp:26-58)
_REF_OPTIONS = [
    ("E", "ERROR", True,
     "Maximum allowed site error rate for 'local' method. Default: 0.1"),
    ("R", "", False,
     "Estimate SNP prior from data, applicable for methods 'likelihood_ratio', 'local', 'quality'. Conflicts -r."),
    ("h", "help", False, "Print this help message"),
    ("m", "METHOD", True,
     "Select the method to use for SNP calling: 'likelihood_ratio' , 'bayes', 'local' or 'quality', default: local"),
    ("p", "LEVEL", True,
     "Significance level for statistical tests, only applicable for methods 'likelihood_ratio', 'local'. Default: 0.05"),
    ("r", "PRIOR", True,
     "Use the given prior for SNPs, applicable for methods 'local', 'quality'. Conflicts -R. Default: no prior"),
]

_LONG_OPTIONS = [
    ("engine=", "Compute engine: 'device' (JAX, default) or 'exact' (host long-double oracle)"),
    ("fit=", "Lynch fit backend: 'auto' (default: exact host fit when cheap), 'device', or 'exact'"),
    ("io=", "Pileup parser backend: 'auto' (default), 'native', 'python'"),
    ("output=", "Output CSV path ('-' = stdout, default)"),
    ("devices=", "Number of mesh devices for the site axis (default: all local)"),
    ("per-shard-fit", "Fit the Lynch model per shard (reference-script semantics) instead of globally"),
    ("stream", "Two-pass streaming mode: memory bounded by --chunk-mb, identical output"),
    ("chunk-mb=", "Streaming chunk size in MB (default 64)"),
    ("profile", "Print per-stage timing report to stderr"),
    ("platform=", "Force the JAX platform (e.g. 'cpu'); also honored from SIDTPU_PLATFORM"),
    ("checkpoint=", "Persist/reuse the pass-1 histogram (.npz) in streaming or multihost mode"),
    ("resume", "Resume a streaming/multihost run: reuse checkpoint + completed chunks/parts"),
    ("population=", "Joint multi-sample calling: 'pooled' (shared error rate) or 'independent'; all positional args are sample pileups, outputs <input>.calls.csv"),
    ("multihost", "Multi-host data-parallel run (jax.distributed): requires --output; honors SIDTPU_COORDINATOR/SIDTPU_NUM_PROCESSES/SIDTPU_PROCESS_ID or JAX's cluster auto-detection"),
    ("warm-cache", "Compile all production kernel shape buckets into the persistent XLA cache, then exit (no input file needed)"),
    ("help", "Print this help message"),
]


def _print_help(out=None) -> None:
    out = out if out is not None else sys.stdout
    print("sid [flags] input_file", file=out)
    for char, name, has_arg, desc in _REF_OPTIONS:
        arg = f" {name}" if has_arg else ""
        print(f"\t-{char}{arg}\t{desc}", file=out)
    for name, desc in _LONG_OPTIONS:
        arg = name.rstrip("=")
        suffix = " VALUE" if name.endswith("=") else ""
        print(f"\t--{arg}{suffix}\t{desc}", file=out)


def _atof(s: str) -> float:
    """C atof: parse a leading float, 0.0 on garbage (sid.cpp uses atof)."""
    import re

    m = re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|"
                 r"0[xX][0-9a-fA-F]+|inf(inity)?|nan)", s)
    if not m:
        return 0.0
    try:
        return float(m.group(0))
    except ValueError:
        return 0.0


def parse_args(argv: List[str]) -> Optional[tuple]:
    """Returns (options, input_path) or None if already handled (help)."""
    opts = Options()
    shortopts = "E:Rhm:p:r:"
    longopts = [name for name, _ in _LONG_OPTIONS]
    try:
        parsed, rest = getopt.gnu_getopt(argv, shortopts, longopts)
    except getopt.GetoptError as e:
        # C getopt prints its own diagnostic before the reference exits
        print(f"sid: {e.msg}", file=sys.stderr)
        sys.exit(1)  # unknown flag: exit(EXIT_FAILURE) (sid.cpp:80)

    for flag, value in parsed:
        if flag in ("-h", "--help"):
            # the reference prints help and keeps going: `sid -h` with no
            # file still errors with "No file name given!" (sid.cpp:75-108)
            _print_help()
        elif flag == "-m":
            opts.method = value
        elif flag == "-r":
            opts.snp_prior = _atof(value)
        elif flag == "-R":
            opts.estimate_prior = True
        elif flag == "-p":
            opts.significance_level = _atof(value)
        elif flag == "-E":
            opts.site_error_threshold = _atof(value)
        elif flag == "--engine":
            opts.engine = value
        elif flag == "--fit":
            opts.fit_backend = value
        elif flag == "--io":
            opts.io_backend = value
        elif flag == "--output":
            opts.output = value
        elif flag == "--devices":
            opts.mesh_devices = int(value)
        elif flag == "--per-shard-fit":
            opts.per_shard_fit = True
        elif flag == "--stream":
            opts.stream = True
        elif flag == "--chunk-mb":
            opts.chunk_mb = int(value)
        elif flag == "--profile":
            opts.profile = True
        elif flag == "--platform":
            opts.platform = value
        elif flag == "--checkpoint":
            opts.checkpoint = value
        elif flag == "--resume":
            opts.resume = True
        elif flag == "--population":
            opts.population = value
        elif flag == "--multihost":
            opts.multihost = True
        elif flag == "--warm-cache":
            opts.warm_cache = True

    if opts.warm_cache:
        return opts, rest[0] if rest else ""
    if not rest:
        print("No file name given!", file=sys.stderr)
        sys.exit(1)
    try:
        # unknown -m keeps the reference's header-only behavior (sid.cpp:92-102)
        opts.validate(allow_unknown_method=True)
    except ValueError as e:
        print(f"sid: {e}", file=sys.stderr)
        sys.exit(1)
    if opts.population:
        return opts, rest
    return opts, rest[0]


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parsed = parse_args(argv)
    if parsed is None:
        return 0
    options, input_path = parsed
    import os as _os

    platform = options.platform or _os.environ.get("SIDTPU_PLATFORM")
    if platform:
        # must happen before any backend initializes
        import jax

        jax.config.update("jax_platforms", platform)
    if options.warm_cache:
        from sid_tpu.utils.warmup import warm_cache

        n = warm_cache(options, log=lambda l: print(l, file=sys.stderr))
        print(f"# warm-cache: {n} method configs compiled", file=sys.stderr)
        return 0
    if options.population:
        return _main_population(options, input_path)
    if options.multihost or _os.environ.get("SIDTPU_NUM_PROCESSES"):
        return _main_multihost(options, input_path)
    try:
        f = open(input_path, "rb")
    except OSError:
        print(f"Could not open file: {input_path}", file=sys.stderr)
        sys.exit(1)

    from sid_tpu import engine
    from sid_tpu.utils.profiling import StageProfile, activate

    def diag(line: str) -> None:
        if options.diagnostics:
            print(line, file=sys.stderr)

    prof = StageProfile(enabled=options.profile)
    activate(prof if options.profile else None)

    if options.stream:
        f.close()
        if options.output in ("-", ""):
            out_stream = getattr(sys.stdout, "buffer", sys.stdout)
            n = engine.run_streaming(
                input_path, options, out_stream, diag,
                chunk_bytes=options.chunk_mb << 20,
                checkpoint=options.checkpoint, resume=options.resume,
            )
        else:
            from sid_tpu.utils.checkpoint import StreamProgress

            mode = "r+b" if options.resume and __import__("os").path.exists(options.output) else "wb"
            with open(options.output, mode) as out:
                n = engine.run_streaming(
                    input_path, options, out, diag,
                    chunk_bytes=options.chunk_mb << 20,
                    checkpoint=options.checkpoint, resume=options.resume,
                    progress=StreamProgress(options.output),
                )
        prof.count("sites", n)
    else:
        from sid_tpu.utils.errors import SidParseError

        try:
            f.close()  # engine takes the path (enables the chunk pipeline)
            csv = engine.run(input_path, options, diag, binary=True)
        except SidParseError as e:
            # the reference dies on the uncaught std::invalid_argument; we
            # report the same message with the offending line number
            print(f"{e} (line {e.line_number})", file=sys.stderr)
            sys.exit(1)
        prof.count("sites", max(csv.count(b"\n") - 1, 0))
        if options.output in ("-", ""):
            buf = getattr(sys.stdout, "buffer", None)
            if buf is not None:
                buf.write(csv)
                buf.flush()
            else:
                sys.stdout.write(csv.decode("latin1"))
        else:
            with open(options.output, "wb") as out:
                out.write(csv)
    if options.profile:
        prof.report(log=lambda l: print(l, file=sys.stderr))
        activate(None)
    return 0


def _main_multihost(options: Options, input_path: str) -> int:
    """Multi-host data-parallel run: every process executes this same CLI.

    The reference's multi-node story is the GNU-parallel chromosome fan-out
    (scripts/sid-pipeline/parallel-run-sid.sh); here each process parses its
    newline-aligned byte range, histograms all-gather so every process fits
    the identical global model, and output parts merge on the coordinator.
    """
    import os as _os

    from sid_tpu.parallel import distributed

    if options.output in ("-", ""):
        print("sid: --multihost requires --output PATH", file=sys.stderr)
        sys.exit(1)
    nprocs = _os.environ.get("SIDTPU_NUM_PROCESSES")
    procid = _os.environ.get("SIDTPU_PROCESS_ID")
    distributed.initialize(
        _os.environ.get("SIDTPU_COORDINATOR"),
        int(nprocs) if nprocs else None,
        int(procid) if procid else None,
    )

    def diag(line: str) -> None:
        if options.diagnostics:
            print(line, file=sys.stderr)

    out = distributed.run_multihost(input_path, options, options.output, diag)
    if out is not None:
        diag(f"# wrote {out}")
    return 0


def _main_population(options: Options, paths: List[str]) -> int:
    """Joint multi-sample calling: one output CSV per sample."""
    from sid_tpu.io.pileup import parse_pileup
    from sid_tpu.models.population import call_population, call_population_streaming

    def diag(line: str) -> None:
        if options.diagnostics:
            print(line, file=sys.stderr)

    for p in paths:
        import os as _os

        if not _os.path.exists(p):
            print(f"Could not open file: {p}", file=sys.stderr)
            sys.exit(1)
    if options.stream:
        # streamed ingest: histograms accumulate chunk-by-chunk, no sample
        # is ever RAM-resident (BASELINE config 5 at scale)
        call_population_streaming(
            paths, options, mode=options.population, diag=diag,
            chunk_bytes=options.chunk_mb << 20,
        )
        return 0
    needs_reads = options.method == "quality"
    batches = []
    for p in paths:
        with open(p, "rb") as f:
            batches.append(
                parse_pileup(f, needs_reads, needs_reads, backend=options.io_backend)
            )
    results = call_population(batches, options, mode=options.population, diag=diag)
    for p, res in zip(paths, results):
        out_path = p + ".calls.csv"
        with open(out_path, "wb") as out:
            out.write(res.to_csv_bytes())
        diag(f"# wrote {out_path} ({res.num_records} records)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
