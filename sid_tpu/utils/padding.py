"""Static-shape bucketing for device arrays.

XLA compiles one executable per shape; padding the unique-profile and site
axes up to bucket boundaries keeps recompilation bounded (log-many buckets)
while masked/zero-mult padding rows contribute nothing to results.
"""

from __future__ import annotations

import numpy as np


def bucket_size(n: int, minimum: int = 8192, multiple: int = 1) -> int:
    """Next power-of-two bucket >= n (>= minimum), rounded up to ``multiple``.

    The floor is high (8192) so realistic unique-profile counts all land in
    one bucket: one XLA compile ever per kernel on a given platform.
    ``multiple`` is the mesh size of a sharded array, so the site axis always
    splits evenly over the devices.
    """
    b = minimum
    while b < n:
        b *= 2
    return -(-b // multiple) * multiple


def pad_axis0(a: np.ndarray, minimum: int = 8192, fill=0, multiple: int = 1) -> np.ndarray:
    """Pad axis 0 up to the bucket size with ``fill``."""
    n = a.shape[0]
    b = bucket_size(n, minimum, multiple)
    if b == n:
        return a
    # np.empty + two slice assignments: ~3x faster than np.pad on MB-scale
    # arrays (np.pad round-trips through a zeros allocation + generic copy)
    out = np.empty((b,) + a.shape[1:], dtype=a.dtype)
    out[:n] = a
    out[n:] = fill
    return out
