"""Top-level dispatch: parsed batch + options -> CallResult.

Mirrors the reference's method dispatch (sid.cpp:92-100), including the
quirk that an unrecognized method produces no records (the CLI then prints
only the CSV header). ``options.engine`` selects the device compute path
(default) or the host-exact long-double oracle.
"""

from __future__ import annotations

from typing import Callable, Optional

from sid_tpu.config import Options
from sid_tpu.io.pileup import PileupBatch, parse_pileup
from sid_tpu.models.common import CallResult


def call_batch(
    batch: PileupBatch,
    options: Options,
    diag: Optional[Callable[[str], None]] = None,
) -> Optional[CallResult]:
    """Dispatch one parsed batch to the selected method implementation."""
    method = options.method
    if options.engine == "exact":
        # host-only oracle: never touch the accelerator, no backend init
        from sid_tpu.exact import engine as exact_engine

        table = {
            "local": exact_engine.call_local_exact,
            "bayes": exact_engine.call_bayes_exact,
            "likelihood_ratio": exact_engine.call_likelihood_ratio_exact,
            "quality": exact_engine.call_quality_exact,
        }
    else:
        from sid_tpu.models import bayes, likelihood_ratio, local, quality

        table = {
            "local": local.call_local,
            "bayes": bayes.call_bayes,
            "likelihood_ratio": likelihood_ratio.call_likelihood_ratio,
            "quality": quality.call_quality,
        }
    fn = table.get(method)
    if fn is None:
        return None  # unknown method: header-only output (sid.cpp:92-102)
    if options.per_shard_fit:
        from sid_tpu.parallel.pipeline import call_per_shard

        return call_per_shard(batch, options, fn, diag, by="chromosome")
    return fn(batch, options, diag)


def run(
    src,
    options: Optional[Options] = None,
    diag: Optional[Callable[[str], None]] = None,
    binary: bool = False,
):
    """Parse + call + serialize: the whole tool as a function returning CSV.

    ``binary=True`` returns bytes from the native serializer with no
    transcoding (the CLI's path); default returns str.
    """
    from sid_tpu.utils import profiling

    options = options or Options()
    if isinstance(src, (bytes, bytearray)) and _pipeline_eligible(options, len(src)):
        return _run_pipelined_single_pass(bytes(src), options, diag, binary)
    import os as _os

    if isinstance(src, (str, _os.PathLike)) and _pipeline_eligible(
        options, _os.path.getsize(src)
    ):
        return _run_pipelined_single_pass(src, options, diag, binary)
    needs_reads = options.method == "quality"
    with profiling.maybe_stage("parse"):
        batch = parse_pileup(
            src,
            parse_base_qualities=needs_reads,
            parse_mapping_qualities=needs_reads,
            backend=options.io_backend,
            quality_terms_only=needs_reads and options.engine == "device",
        )
    with profiling.maybe_stage("call"):
        result = call_batch(batch, options, diag)
    if result is None:
        from sid_tpu.models.common import CSV_HEADER

        header = CSV_HEADER + "\n"
        return header.encode() if binary else header
    with profiling.maybe_stage("serialize"):
        return result.to_csv_bytes() if binary else result.to_csv()


def run_streaming(
    src,
    options: Optional[Options] = None,
    out=None,
    diag: Optional[Callable[[str], None]] = None,
    chunk_bytes: int = 64 << 20,
    checkpoint: Optional[str] = None,
    resume: bool = False,
    progress=None,
) -> int:
    """Memory-bounded whole-genome calling (BASELINE config 4).

    Two-pass pipeline: pass 1 folds chunks into the unique-profile histogram
    (the fit's sufficient statistic), the per-class classification table is
    computed once globally, pass 2 re-parses chunk-by-chunk and appends CSV
    rows joined through a packed-key binary search. Output semantics are
    identical to the in-memory path (including the global BH correction and
    cov>=4 omission). Returns the number of emitted records.

    ``checkpoint`` persists the pass-1 histogram (.npz) so re-runs with
    ``resume=True`` skip the first full parse; ``progress`` (a
    StreamProgress) adds chunk-level pass-2 resume for file outputs.
    ``out`` is a binary or text file object (default: stdout).
    """
    import sys
    import os as _os

    import numpy as np

    from sid_tpu.io.stream import accumulate_histogram, iter_chunks, pack_profiles
    from sid_tpu.io.pileup import parse_pileup
    from sid_tpu.models import common
    from sid_tpu.ops.profiles import filter_min_coverage
    from sid_tpu.utils import profiling

    if not isinstance(src, (str, bytes, _os.PathLike)):
        raise TypeError("run_streaming needs a re-readable source (path or bytes)")
    import io as _io

    options = options or Options()
    out = out or sys.stdout
    is_binary = "b" in getattr(out, "mode", "") or isinstance(
        out, (_io.RawIOBase, _io.BufferedIOBase)
    )
    # binary sinks take the serializer's bytes untranscoded; text sinks decode
    write = out.write if is_binary else (lambda b: out.write(b.decode("latin1")))
    method = options.method

    start_chunk = 0
    if progress is not None and resume:
        start_chunk, bytes_written = progress.load()
        if start_chunk > 0:
            out.seek(bytes_written)
            out.truncate()
        else:
            # absent/corrupt sidecar: restart from scratch — drop any stale
            # output from a previous run rather than overwriting in place
            try:
                out.seek(0)
                out.truncate()
            except (OSError, ValueError):
                pass
    if start_chunk == 0:
        write((common.CSV_HEADER + "\n").encode())
    if method not in ("local", "bayes", "likelihood_ratio", "quality"):
        return 0  # header-only, like the reference's unknown-method path

    needs_reads = method == "quality"
    emitted = 0

    # ---- pass 1: histogram (skipped for quality without -R) ----
    def histogram():
        from sid_tpu.utils.checkpoint import input_fingerprint

        fp = input_fingerprint(src) if checkpoint else ""
        if checkpoint and resume:
            from sid_tpu.utils.checkpoint import load_fit_state

            state = load_fit_state(checkpoint, fingerprint=fp)
            if state is not None:
                return state["profiles"], state["mult"]
        with profiling.maybe_stage("histogram"):
            profiles, mult, _ = accumulate_histogram(src, chunk_bytes, options.io_backend)
        if checkpoint:
            from sid_tpu.utils.checkpoint import save_fit_state

            save_fit_state(checkpoint, profiles, mult, fingerprint=fp)
        return profiles, mult

    cls = None
    keys = None
    conf_type = "p_value"
    snp_prior = options.snp_prior
    if method == "quality":
        if options.estimate_prior:
            from sid_tpu.models.lynch import estimate_prior_heterozygosity

            profiles, mult = histogram()
            snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
    else:
        profiles, mult = histogram()
        with profiling.maybe_stage("fit+classify"):
            if method == "local":
                if options.estimate_prior:
                    from sid_tpu.models.lynch import estimate_prior_heterozygosity

                    snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
                from sid_tpu.models.local import classify_profiles_local

                cls = classify_profiles_local(
                    profiles, options, snp_prior, options.mesh_devices
                )
                keys = pack_profiles(profiles)
            else:
                fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)
                if method == "bayes":
                    from sid_tpu.models.bayes import classify_profiles_bayes

                    cls = classify_profiles_bayes(fprof, fmult, options, diag)
                    conf_type = "probability"
                else:
                    from sid_tpu.models.likelihood_ratio import classify_profiles_lr

                    cls = classify_profiles_lr(fprof, fmult, options, diag)
                keys = pack_profiles(fprof)

    # ---- pass 2: classify/join chunk by chunk ----
    for chunk_no, chunk in enumerate(iter_chunks(src, chunk_bytes)):
        if chunk_no < start_chunk:
            continue
        batch = parse_pileup(chunk, needs_reads, needs_reads, backend=options.io_backend,
                             quality_terms_only=needs_reads)
        if batch.num_sites == 0:
            continue
        if method == "quality":
            from sid_tpu.models.quality import call_quality

            import dataclasses as _dc

            opts = _dc.replace(options, estimate_prior=False, snp_prior=snp_prior)
            res = call_quality(batch, opts)
        else:
            res = common.join_class_table(batch, keys, cls, conf_type)
        write(res.to_csv_bytes(include_header=False))
        emitted += res.num_records
        if progress is not None:
            out.flush()
            progress.save(chunk_no + 1, out.tell())
    if progress is not None:
        progress.finish()
    return emitted


# Chunked overlap engages only for inputs too big to hold comfortably in RAM
# (SIDTPU_PIPELINE_MB); below the threshold the monolithic path (one
# dispatch) runs. Both knobs are read per call so tests can drive the
# pipeline on small inputs (tests/test_pipeline_overlap.py asserts byte
# equality with the monolithic path).
import os as _os_env


def _pipeline_threshold_bytes() -> int:
    return int(_os_env.environ.get("SIDTPU_PIPELINE_MB", "1024")) << 20


def _pipeline_chunk_bytes() -> int:
    return int(_os_env.environ.get("SIDTPU_PIPELINE_CHUNK_MB", "128")) << 20


def _run_pipelined_single_pass(data, options: Options, diag, binary: bool = False):
    """Overlapped chunk pipeline for per-site/per-profile methods.

    For ``local``/``quality`` without an estimated prior, classification is
    independent per chunk, so parse of chunk k+1 (C++, GIL released)
    overlaps device classify + C++ serialization of chunk k. Output is
    byte-identical to the monolithic path.
    """
    from concurrent.futures import ThreadPoolExecutor

    from sid_tpu.io.stream import iter_chunks
    from sid_tpu.models.common import CSV_HEADER
    from sid_tpu.utils import profiling

    needs_reads = options.method == "quality"

    def parse(chunk):
        return parse_pileup(chunk, needs_reads, needs_reads, backend=options.io_backend,
                            quality_terms_only=needs_reads)

    def process(batch):
        result = call_batch(batch, options, diag)
        if binary:
            return result.to_csv_bytes(include_header=False)
        return result.to_csv(include_header=False)

    header = CSV_HEADER + "\n"
    parts = [header.encode() if binary else header]
    with profiling.maybe_stage("pipeline"), ThreadPoolExecutor(1) as ex:
        it = iter_chunks(data, _pipeline_chunk_bytes())
        first = next(it, None)
        if first is None:
            return parts[0]
        fut = ex.submit(parse, first)
        for chunk in it:
            nxt = ex.submit(parse, chunk)
            parts.append(process(fut.result()))
            fut = nxt
        parts.append(process(fut.result()))
    return (b"" if binary else "").join(parts)


def _pipeline_eligible(options: Options, size: int) -> bool:
    return (
        options.method in ("local", "quality")
        and not options.estimate_prior
        and not options.per_shard_fit
        and options.engine == "device"
        and size >= _pipeline_threshold_bytes()
    )
