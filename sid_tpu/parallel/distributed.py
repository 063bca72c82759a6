"""Multi-host scale-out: jax.distributed init, byte-range sharding, ordered merge.

SURVEY §5.8: each host's CPU parses its newline-aligned byte range of the
pileup; the unique-profile histograms are all-gathered and merged so every
process computes the identical global fit and class table; each host writes
its own coordinate-ordered CSV part, and the coordinator concatenates parts
in range order. The only cross-host payloads are the tiny histograms and
the fit scalars — the design goal is latency tolerance, not bandwidth.

Single-process (num_processes=1) degenerates to the local pipeline and is
what the unit tests exercise; real multi-host runs initialize via
``initialize()`` on every host with the same coordinator address.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from sid_tpu.config import Options


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed bring-up.

    With no explicit arguments, relies on JAX's cluster auto-detection. Auto-detection failures are logged, and escalate to a hard
    error when the environment said a multi-process run was intended
    (SIDTPU_NUM_PROCESSES > 1): a silently-degraded wrong-world-size run is
    worse than no run (SURVEY §5.3 failure-detection mandate).
    """
    import logging

    import jax

    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception as exc:
            env_n = os.environ.get("SIDTPU_NUM_PROCESSES")
            if env_n and int(env_n) > 1:
                raise RuntimeError(
                    "jax.distributed auto-initialization failed but "
                    f"SIDTPU_NUM_PROCESSES={env_n} requested a multi-process "
                    f"run: {exc}"
                ) from exc
            logging.getLogger("sid_tpu.distributed").warning(
                "jax.distributed auto-initialization failed (%s); "
                "continuing single-process", exc,
            )
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except Exception as exc:
        raise RuntimeError(
            "jax.distributed initialization failed for coordinator="
            f"{coordinator_address!r} num_processes={num_processes} "
            f"process_id={process_id}: {exc}"
        ) from exc


def byte_ranges(path: str, n: int) -> List[Tuple[int, int]]:
    """Split a file into n newline-aligned (start, end) byte ranges."""
    size = os.path.getsize(path)
    if n <= 1 or size == 0:
        return [(0, size)]
    bounds = [0]
    with open(path, "rb") as f:
        for k in range(1, n):
            guess = size * k // n
            if guess <= bounds[-1]:
                continue
            f.seek(guess)
            f.readline()  # advance to the next newline
            b = f.tell()
            if b > bounds[-1] and b < size:
                bounds.append(b)
    bounds.append(size)
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]


def merge_histograms(
    parts: List[Tuple[np.ndarray, np.ndarray]]
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge (profiles, mult) histograms from all ranges/hosts."""
    from sid_tpu.io.stream import pack_profiles, unpack_profiles

    keys = np.concatenate([pack_profiles(p) for p, _ in parts]) if parts else np.zeros(0, np.uint64)
    weights = np.concatenate([m for _, m in parts]) if parts else np.zeros(0, np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    mult = np.zeros(uniq.shape[0], np.int64)
    np.add.at(mult, inv, weights.astype(np.int64))
    return unpack_profiles(uniq), mult


def allgather_histogram(
    profiles: np.ndarray, mult: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """All-gather per-host histograms across processes and merge.

    Uses process_allgather over a padded fixed-size buffer (histograms are
    small); identical merged output on every process.
    """
    import jax

    if jax.process_count() == 1:
        return merge_histograms([(profiles, mult)])
    from jax.experimental import multihost_utils

    from sid_tpu.io.stream import pack_profiles

    u = np.int64(profiles.shape[0])
    u_all = multihost_utils.process_allgather(np.array([u]))
    u_max = int(np.max(u_all))
    keys = np.zeros(u_max, np.uint64)
    keys[: int(u)] = pack_profiles(profiles)
    mults = np.zeros(u_max, np.int64)
    mults[: int(u)] = mult
    keys_all = multihost_utils.process_allgather(keys)  # (P, u_max)
    mults_all = multihost_utils.process_allgather(mults)
    parts = []
    from sid_tpu.io.stream import unpack_profiles

    for p in range(keys_all.shape[0]):
        k = int(u_all[p])
        parts.append((unpack_profiles(keys_all[p, :k]), mults_all[p, :k]))
    return merge_histograms(parts)


def run_multihost(
    path: str,
    options: Options,
    out_path: str,
    diag=None,
    ranges_per_process: int = 1,
) -> Optional[str]:
    """Data-parallel multi-host calling over byte ranges of one pileup file.

    Every process: parse own range -> local histogram -> allgather+merge ->
    identical global class table -> classify own range -> write part file.
    Process 0 concatenates parts in range order and returns the output path.
    """
    import jax

    from sid_tpu.io.pileup import parse_pileup
    from sid_tpu.io.stream import (
        accumulate_histogram_chunks,
        iter_range_chunks,
        pack_profiles,
    )
    from sid_tpu.models import common
    from sid_tpu.ops.profiles import filter_min_coverage

    pid = jax.process_index()
    nproc = jax.process_count()
    ranges = byte_ranges(path, nproc * ranges_per_process)
    my_ranges = [r for i, r in enumerate(ranges) if i % nproc == pid]
    method = options.method
    needs_reads = method == "quality"
    # SIDTPU_CHUNK_BYTES lets tests force sub-MB chunking
    chunk_bytes = int(os.environ.get("SIDTPU_CHUNK_BYTES", options.chunk_mb << 20))

    # pass 1 (only when a global histogram is needed — quality without -R is
    # per-site): fold newline-aligned chunks of my ranges into the local
    # unique-profile histogram, never materializing a parsed range. Memory
    # is bounded by chunk_bytes per process (run-sid.sh:4-18's per-
    # chromosome zcat streaming, upgraded to byte ranges + global fit).
    # --checkpoint persists the MERGED global histogram (fingerprint-keyed);
    # on --resume every process tries to load it, and pass 1 + the allgather
    # are skipped only when ALL processes loaded it (the decision is itself
    # all-gathered so no process deadlocks on a missing collective).
    fp = ""
    if options.checkpoint or options.resume:
        from sid_tpu.utils.checkpoint import input_fingerprint

        fp = input_fingerprint(path)

    need_hist = method != "quality" or options.estimate_prior
    if need_hist:
        loaded = None
        if options.checkpoint:
            from sid_tpu.utils.checkpoint import load_fit_state

            if options.resume:
                state = load_fit_state(options.checkpoint, fingerprint=fp)
                if state is not None:
                    loaded = (state["profiles"], state["mult"])
        all_loaded = loaded is not None
        if nproc > 1:
            from jax.experimental import multihost_utils

            flags = multihost_utils.process_allgather(
                np.array([1 if loaded is not None else 0])
            )
            all_loaded = bool(np.min(flags) == 1)
        if all_loaded:
            profiles, mult = loaded
        else:
            def _my_chunks():
                for start, end in my_ranges:
                    yield from iter_range_chunks(path, start, end, chunk_bytes)

            lp, lm, _ = accumulate_histogram_chunks(
                _my_chunks(), options.io_backend
            )
            profiles, mult = allgather_histogram(lp, lm)
            if options.checkpoint and pid == 0:
                from sid_tpu.utils.checkpoint import save_fit_state

                save_fit_state(options.checkpoint, profiles, mult, fingerprint=fp)

    # identical global classification table on every process
    conf_type = "p_value"
    cls = keys = None
    snp_prior = options.snp_prior
    if method == "local":
        from sid_tpu.models.local import classify_profiles_local

        if options.estimate_prior:
            from sid_tpu.models.lynch import estimate_prior_heterozygosity

            snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
        cls = classify_profiles_local(
            profiles, options, snp_prior, options.mesh_devices
        )
        keys = pack_profiles(profiles)
    elif method == "bayes":
        from sid_tpu.models.bayes import classify_profiles_bayes

        fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)
        cls = classify_profiles_bayes(fprof, fmult, options, diag)
        keys = pack_profiles(fprof)
        conf_type = "probability"
    elif method == "likelihood_ratio":
        from sid_tpu.models.likelihood_ratio import classify_profiles_lr

        fprof, fmult, _ = filter_min_coverage(profiles, mult, 4)
        cls = classify_profiles_lr(fprof, fmult, options, diag)
        keys = pack_profiles(fprof)
    elif method == "quality":
        # per-site method: only the -R prior is global state; every process
        # derives the identical snp_prior from the merged histogram
        if options.estimate_prior:
            from sid_tpu.models.lynch import estimate_prior_heterozygosity

            snp_prior = estimate_prior_heterozygosity(profiles, mult, options, diag)
    else:
        raise ValueError(f"run_multihost does not support method {method!r}")

    # pass 2: re-parse own ranges chunk-by-chunk, classify, append to the
    # part file — the parsed batch never outlives its chunk. Parts are
    # written to a .tmp and atomically renamed with a .done marker, so
    # --resume skips ranges a previous (crashed) run completed: rerunnable
    # shards (SURVEY §5.4), per range rather than per chromosome.
    import dataclasses as _dc

    part_paths = []
    for start, end in my_ranges:
        part = f"{out_path}.part{start:016d}"
        done = part + ".done"
        if options.resume and os.path.exists(done) and os.path.exists(part):
            # the marker stores the input fingerprint: a part from a
            # different/modified input is never silently reused
            try:
                with open(done) as df:
                    marker_fp = df.read().strip()
            except OSError:
                marker_fp = None
            if marker_fp == fp:
                part_paths.append(part)
                continue
        tmp = part + ".tmp"
        with open(tmp, "wb") as f:
            for chunk in iter_range_chunks(path, start, end, chunk_bytes):
                batch = parse_pileup(
                    chunk, needs_reads, needs_reads, backend=options.io_backend
                )
                if method == "quality":
                    from sid_tpu.models.quality import call_quality

                    opts = _dc.replace(
                        options, estimate_prior=False, snp_prior=snp_prior
                    )
                    res = call_quality(batch, opts)
                else:
                    res = common.join_class_table(batch, keys, cls, conf_type)
                f.write(res.to_csv_bytes(include_header=False))
        os.replace(tmp, part)
        with open(done, "w") as df:
            df.write(fp)
        part_paths.append(part)

    if nproc > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("sid_tpu_parts_written")
    if pid != 0:
        return None

    # ordered merge on the coordinator: only the parts named by this run's
    # range list (a glob could pick up stale parts from an aborted run).
    # Streamed copy — a part can be a whole-genome-share CSV (GBs), so
    # materializing it would undo the memory-boundedness of the passes above.
    import shutil

    with open(out_path, "wb") as f:
        f.write((common.CSV_HEADER + "\n").encode())
        for start, _ in ranges:
            part = f"{out_path}.part{start:016d}"
            with open(part, "rb") as pf:
                shutil.copyfileobj(pf, f, 8 << 20)
            os.remove(part)
            try:
                os.remove(part + ".done")
            except OSError:
                pass
    return out_path
