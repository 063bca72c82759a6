"""sid-tpu: an accelerator-backed diploid genotype-calling engine.

A from-scratch framework with the capabilities of the reference C++ tool
``sid`` (EvolBioInf/sid): it reads ``samtools mpileup`` text and emits one CSV
row per genome site with the most likely diploid genotype and confidence
values, via four calling methods (``local``, ``bayes``, ``likelihood_ratio``,
``quality``; reference dispatch at sid.cpp:92-100).

Architecture (device-first, not a port):

- host runtime (C++ / NumPy): streaming mpileup parser -> dense per-site
  tensors; CSV serialization with C++-ostream-compatible ``%.6g`` floats.
- device engine (JAX/XLA, float64 log-space): vectorized genotype-likelihood
  kernels, a GSL-nmsimplex2-faithful batched Nelder-Mead fit of the Lynch
  (pi, epsilon) model under ``lax.while_loop``, p-values/BH corrections.
- parallel layer: ``jax.sharding.Mesh`` over the site axis; the global model
  fit reduces sufficient statistics with ``psum`` across shards.

Float64 is enabled globally at import: the output CSV exposes 6 significant
digits (C++ default ostream precision, call.hpp:29-38) and the engine computes
in f64 log-space to clear that bar.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR
# itself; otherwise the cache sits at a fixed path in the checkout, so a
# later run finds what an earlier one compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"

from sid_tpu.config import Options  # noqa: E402,F401
