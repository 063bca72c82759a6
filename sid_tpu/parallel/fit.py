"""Globally-sharded Lynch fit: the framework's one cross-shard reduction.

The compound log-likelihood is a sum over unique profiles (lynch.cpp:46-52);
with the profile histogram sharded over the mesh, the jitted fit's reduction
lowers to an XLA all-reduce (psum) per objective evaluation — the
distributed-communication design of SURVEY §5.8. The (pi, epsilon) simplex
state stays replicated (tiny), so each nmsimplex2 iteration costs one or two
fused sharded-reduce evaluations.

Semantically this *global* fit is an upgrade over the reference scripts'
independent per-chromosome fits (parallel-run-sid.sh); ``per_shard_fit``
selects the reference behavior instead (sid_tpu.parallel.pipeline).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from sid_tpu.models.lynch import run_device_fit
from sid_tpu.ops.profiles import nucleotide_distribution
from sid_tpu.parallel.mesh import shard_profiles
from sid_tpu.utils.padding import bucket_size


def fit_lynch_global(
    profiles: np.ndarray,
    mult: np.ndarray,
    mesh: Mesh,
    diag: Optional[Callable[[str], None]] = None,
) -> Tuple[float, float, np.ndarray, np.ndarray, np.ndarray]:
    """Fit (pi, epsilon) with the profile histogram sharded over ``mesh``.

    Returns (pi, eps, log_l_hom, log_l_het, nt) like fit_on_filtered_profiles;
    the per-profile likelihood rows come back sharded and are gathered here.
    """
    u = profiles.shape[0]
    n_dev = int(np.prod(mesh.devices.shape))
    nt = nucleotide_distribution(profiles, mult)
    max_cov = int(profiles.sum(-1).max()) if u else 0

    # pad to a bucket divisible by the mesh size; zero-mult rows are inert
    b = bucket_size(max(u, 1), multiple=n_dev)
    prof_pad = np.zeros((b, 4), np.int32)
    prof_pad[:u] = profiles
    mult_pad = np.zeros(b, np.int64)
    mult_pad[:u] = mult

    prof_s, mult_s = shard_profiles(mesh, prof_pad, mult_pad)
    res, log_l_hom, log_l_het = run_device_fit(prof_s, mult_s, nt, max_cov)

    iters = int(res.iterations)
    if diag is not None:
        if bool(res.converged):
            diag(f"# GSL function minimization converged in {iters} iterations.")
        else:
            diag(
                f"# Error: GSL function minimization did not converge in {iters} iterations!"
            )
    return (
        float(res.x[0]),
        float(res.x[1]),
        np.asarray(log_l_hom)[:u],
        np.asarray(log_l_het)[:u],
        nt,
    )
