"""Run configuration.

Mirrors the reference CLI's ``GlobalOptions`` (sid.cpp:11-17) — same fields,
same defaults — and adds the framework knobs (mesh shape, fit backend,
precision, IO backend) that have no reference equivalent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Options:
    # --- reference-compatible options (sid.cpp:11-17) ---
    method: str = "local"
    estimate_prior: bool = False          # -R
    snp_prior: float = -1.0               # -r (<=0 means "no prior")
    significance_level: float = 0.05      # -p
    site_error_threshold: float = 0.1     # -E

    # --- framework options (no reference equivalent) ---
    # "device": JAX kernels for all per-profile/per-site math (the scale
    # path). "exact": host long-double oracle (bit-faithful to the
    # reference's precision semantics; slow, for parity/debug).
    engine: str = "device"
    # "auto" (default): the exact host long-double fit (native libsidtpu
    #          kernels, bitwise-compatible with the reference's GSL nmsimplex2
    #          trajectory) whenever the run is single-mesh and the histogram
    #          is small enough that the host fit is cheap — this makes CSV
    #          byte-parity with the oracle unconditional on every realistic
    #          input; falls back to "device" above SIDTPU_EXACT_FIT_MAX_U
    #          unique profiles or under an explicit device mesh.
    # "exact": always the host long-double fit.
    # "device": always the JAX f64 fit (lax.while_loop + psum over shards).
    fit_backend: str = "auto"
    # pileup parser backend: "native" (C++ shared lib) with "python" fallback.
    io_backend: str = "auto"
    # exact p-values (default): the LRT's erfc runs on the host through
    # glibc libm (the oracle's math.erfc) from device-computed
    # log-likelihoods, so CSV parity is independent of the XLA backend's
    # erfc approximation. False keeps the whole LRT fused on device
    # (XLA erfc, ~4e-8 relative error — fine when results stay on device).
    exact_pvalues: bool = True
    # number of devices along the site-sharding mesh axis (None = all local)
    mesh_devices: Optional[int] = None
    # fit the Lynch model per shard (reference scripts' semantics,
    # scripts/sid-pipeline/parallel-run-sid.sh) instead of globally (psum).
    per_shard_fit: bool = False
    # emit reference-identical stderr diagnostics (call.cpp:72,78-80)
    diagnostics: bool = True
    # output path ("-" = stdout)
    output: str = "-"
    # streaming two-pass mode (memory bounded by chunk_mb)
    stream: bool = False
    chunk_mb: int = 64
    # per-stage timing report
    profile: bool = False
    # streaming checkpoint/resume
    checkpoint: Optional[str] = None
    resume: bool = False
    # multi-sample population mode: "", "pooled", or "independent"
    population: str = ""
    # multi-host data-parallel execution (jax.distributed): every process
    # parses its byte range, histograms all-gather, output parts merge on
    # the coordinator. Also auto-engaged when jax.process_count() > 1.
    multihost: bool = False
    # force a JAX platform for this run (e.g. "cpu"); None = default
    platform: Optional[str] = None
    # compile every production kernel shape bucket into the persistent XLA
    # cache and exit (no input file needed), so later runs are compile-free.
    warm_cache: bool = False

    def validate(self, allow_unknown_method: bool = False) -> None:
        """Reject inconsistent option combinations.

        The CLI calls this with allow_unknown_method=True: the reference
        silently prints only the CSV header for unknown -m values
        (sid.cpp:92-102 falls through every branch), and that observable
        behavior is preserved; the API default rejects them.
        """
        if not allow_unknown_method and self.method not in (
            "local", "bayes", "likelihood_ratio", "quality", ""
        ):
            raise ValueError(f"unknown method: {self.method!r}")
        if self.fit_backend not in ("auto", "exact", "device"):
            raise ValueError(f"unknown fit backend: {self.fit_backend!r}")
        if self.io_backend not in ("auto", "native", "python"):
            raise ValueError(f"unknown io backend: {self.io_backend!r}")
        if self.engine not in ("device", "exact"):
            raise ValueError(f"unknown engine: {self.engine!r}")
        if self.population not in ("", "pooled", "independent"):
            raise ValueError(f"unknown population mode: {self.population!r}")
        if self.chunk_mb <= 0:
            raise ValueError("chunk_mb must be positive")
        if self.multihost and self.output in ("-", ""):
            raise ValueError("--multihost requires --output (parts merge into a file)")
        if self.multihost and self.population:
            raise ValueError("--multihost and --population are mutually exclusive")
