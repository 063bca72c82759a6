"""Shared calling-method machinery: allele selection, results, CSV assembly.

``CallResult`` is a struct-of-arrays over output sites (the reference's
vector<OutputRecord>, call.hpp:23-38); CSV assembly reproduces the ostream
serializer byte-for-byte, including `%g` float formatting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from sid_tpu.utils.format import fmt_g

CSV_HEADER = "chrom,pos,label,gt,hom_conf,het_conf,conf_type"

# natural log of the smallest positive 80-bit-extended subnormal (2^-16445):
# linear long-double likelihoods below this underflow to exactly 0 in the
# reference, which flips its l2>l1 and LRT l_H0==0 branches. The device
# log-space kernels clamp to -inf at this point to reproduce that behavior.
LONG_DOUBLE_UNDERFLOW_LOG = -16445.0 * math.log(2.0)

ALLELES = np.frombuffer(b"ACGT", np.uint8)


def major_allele_indices_np(counts: np.ndarray):
    """Top-2 allele indices with the reference's tie-break (call.cpp:52-60).

    The reference ascending-sorts {0,1,2,3} by count with what is in practice
    a stable sort (libstdc++ insertion sort at n=4) and takes positions 3, 2:
    among tied counts the *higher* base index wins. Encoding count*4+index
    makes that tie-break explicit.
    """
    counts = np.asarray(counts, np.int64)
    scores = counts * 4 + np.arange(4, dtype=np.int64)
    order = np.argsort(scores, axis=-1)
    return order[..., 3].astype(np.int32), order[..., 2].astype(np.int32)


def major_allele_indices(counts: jnp.ndarray):
    """Device version of the top-2 allele selection (same tie-break).

    Branchless two-pass max over the tie-break-encoded scores (no sort
    over the tiny inner axis).
    """
    counts = counts.astype(jnp.int64)
    scores = counts * 4 + jnp.arange(4, dtype=jnp.int64)
    s_max = scores.max(axis=-1, keepdims=True)
    major = (s_max[..., 0] & 3).astype(jnp.int32)
    second_scores = jnp.where(scores == s_max, jnp.int64(-1), scores)
    second = (second_scores.max(axis=-1) & 3).astype(jnp.int32)
    return major, second


def clamp_ld_underflow(log_l: jnp.ndarray) -> jnp.ndarray:
    """Map log-likelihoods the reference would underflow to 0 onto -inf."""
    return jnp.where(log_l < LONG_DOUBLE_UNDERFLOW_LOG, -jnp.inf, log_l)


def clamp_ld_underflow_np(log_l: np.ndarray) -> np.ndarray:
    """Host version of clamp_ld_underflow (same 80-bit subnormal line)."""
    log_l = np.asarray(log_l, np.float64)
    return np.where(log_l < LONG_DOUBLE_UNDERFLOW_LOG, -np.inf, log_l)


@dataclasses.dataclass
class CallResult:
    """Struct-of-arrays over the emitted sites, in output order."""

    chrom_id: np.ndarray  # (M,) int32 -> chrom_table
    chrom_table: List[str]
    pos: np.ndarray  # (M,) int32
    is_het: np.ndarray  # (M,) bool
    major: np.ndarray  # (M,) int32  allele index
    second: np.ndarray  # (M,) int32
    conf_hom: np.ndarray  # (M,) float64
    conf_het: np.ndarray  # (M,) float64
    conf_type: str  # "p_value" | "probability"
    # optional per-unique-profile payload: when present, the serializer
    # formats each class once and joins via class_idx (M,) -> class row
    class_idx: Optional[np.ndarray] = None
    cls_is_het: Optional[np.ndarray] = None
    cls_major: Optional[np.ndarray] = None
    cls_second: Optional[np.ndarray] = None
    cls_conf_hom: Optional[np.ndarray] = None
    cls_conf_het: Optional[np.ndarray] = None

    @property
    def num_records(self) -> int:
        return int(self.pos.shape[0])

    def labels(self) -> np.ndarray:
        return np.where(self.is_het, "het", "hom")

    def genotypes(self) -> List[str]:
        a = ALLELES[self.major]
        b = np.where(self.is_het, ALLELES[self.second], ALLELES[self.major])
        return [chr(x) + chr(y) for x, y in zip(a, b)]

    def to_csv_lines(self) -> List[str]:
        """One CSV line per record (operator<<, call.hpp:29-38)."""
        table = self.chrom_table
        gts = self.genotypes()
        out = []
        for k in range(self.num_records):
            label = "het" if self.is_het[k] else "hom"
            out.append(
                f"{table[self.chrom_id[k]]},{self.pos[k]},{label},{gts[k]},"
                f"{fmt_g(float(self.conf_hom[k]))},{fmt_g(float(self.conf_het[k]))},"
                f"{self.conf_type}"
            )
        return out

    def to_csv(self, include_header: bool = True) -> str:
        native = self._to_csv_native(include_header)
        if native is not None:
            return native.decode("latin1")
        lines = self.to_csv_lines()
        head = [CSV_HEADER] if include_header else []
        body = head + lines
        return "\n".join(body) + "\n" if body else ""

    def to_csv_bytes(self, include_header: bool = True) -> bytes:
        """CSV as bytes — the zero-transcode path for file/stdout output.

        The native serializer produces ASCII bytes; returning them directly
        skips a latin1 decode plus the eventual re-encode on write (~80 MB
        of transcoding per 1M sites).
        """
        native = self._to_csv_native(include_header)
        if native is not None:
            return native
        return self.to_csv(include_header).encode("latin1")

    def _to_csv_native(self, include_header: bool) -> Optional[bytes]:
        """Multithreaded C++ serializer (glibc %g == ostream default)."""
        try:
            from sid_tpu.io import native as native_mod

            lib = native_mod._load()
        except Exception:
            return None
        if lib is None:
            return None
        import ctypes

        from sid_tpu.native.bridge import _configure_writer

        _configure_writer(lib)
        from sid_tpu.native.bridge import encode_chrom_blob

        n = self.num_records
        blob = encode_chrom_blob(self.chrom_table)
        chrom_id = np.ascontiguousarray(self.chrom_id, np.int32)
        pos = np.ascontiguousarray(self.pos, np.int32)
        out = ctypes.POINTER(ctypes.c_char)()
        i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        u8p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        f64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self.class_idx is not None:
            cls_is_het = np.ascontiguousarray(self.cls_is_het, np.uint8)
            cls_major = np.ascontiguousarray(self.cls_major, np.int32)
            cls_second = np.ascontiguousarray(self.cls_second, np.int32)
            cls_ch = np.ascontiguousarray(self.cls_conf_hom, np.float64)
            cls_ct = np.ascontiguousarray(self.cls_conf_het, np.float64)
            length = lib.sidtpu_write_csv_indexed(
                blob, len(blob), i32p(chrom_id), i32p(pos), i32p(self.class_idx), n,
                u8p(cls_is_het), i32p(cls_major), i32p(cls_second),
                f64p(cls_ch), f64p(cls_ct), cls_ch.shape[0],
                self.conf_type.encode(), int(include_header), 0,
                ctypes.byref(out),
            )
        else:
            is_het = np.ascontiguousarray(self.is_het, np.uint8)
            major = np.ascontiguousarray(self.major, np.int32)
            second = np.ascontiguousarray(self.second, np.int32)
            ch = np.ascontiguousarray(self.conf_hom, np.float64)
            ct = np.ascontiguousarray(self.conf_het, np.float64)
            length = lib.sidtpu_write_csv(
                blob, len(blob), i32p(chrom_id), i32p(pos), u8p(is_het), i32p(major),
                i32p(second), f64p(ch), f64p(ct), self.conf_type.encode(),
                n, int(include_header), 0, ctypes.byref(out),
            )
        try:
            return ctypes.string_at(out, length)
        finally:
            lib.sidtpu_buffer_free(out)


def join_class_table(
    batch,
    keys: np.ndarray,
    cls,
    conf_type: str,
) -> CallResult:
    """Join a per-class table onto a batch through packed-profile search.

    ``keys`` is the sorted packed-uint64 profile table; ``cls`` is the
    5-tuple (is_het, major, second, conf_hom, conf_het) over classes. Sites
    whose profile is absent from ``keys`` (e.g. cov<4-filtered) are omitted,
    in input order — the streaming/multi-host analogue of the
    map<profile_t,size_t> join (call.cpp:129-140).
    """
    from sid_tpu.io.stream import pack_profiles

    site_keys = pack_profiles(batch.counts)
    idx = np.searchsorted(keys, site_keys)
    idx_c = np.minimum(idx, max(len(keys) - 1, 0))
    found = keys[idx_c] == site_keys if len(keys) else np.zeros(len(site_keys), bool)
    class_idx = idx_c[found].astype(np.int32)
    cls_conf_hom = np.asarray(cls[3], np.float64)
    cls_conf_het = np.asarray(cls[4], np.float64)
    return CallResult(
        chrom_id=batch.chrom_id[found],
        chrom_table=batch.chrom_table,
        pos=batch.pos[found],
        is_het=cls[0][class_idx],
        major=cls[1][class_idx],
        second=cls[2][class_idx],
        conf_hom=cls_conf_hom[class_idx],
        conf_het=cls_conf_het[class_idx],
        conf_type=conf_type,
        class_idx=class_idx,
        cls_is_het=np.asarray(cls[0]),
        cls_major=np.asarray(cls[1]),
        cls_second=np.asarray(cls[2]),
        cls_conf_hom=cls_conf_hom,
        cls_conf_het=cls_conf_het,
    )


def gather_result(
    batch,
    conf_type: str,
    inverse: np.ndarray,
    is_het_u: np.ndarray,
    major_u: np.ndarray,
    second_u: np.ndarray,
    p1_u: np.ndarray,
    p2_u: np.ndarray,
    keep_u: Optional[np.ndarray] = None,
) -> CallResult:
    """Join per-unique-profile classifications back onto input sites.

    Replaces the reference's map<profile_t,size_t> join (call.cpp:129-140):
    ``inverse`` maps each site to its unique-profile row; sites whose profile
    was filtered out (``keep_u`` False) are omitted from the output, in input
    order, like the cov<4 drop in likelihood_ratio/bayes.
    """
    if keep_u is not None:
        site_keep = keep_u[inverse]
        # remap site -> unfiltered-U -> filtered-U row
        filtered_row = np.cumsum(keep_u) - 1
        inverse = filtered_row[inverse[site_keep]]
        chrom_id = batch.chrom_id[site_keep]
        pos = batch.pos[site_keep]
    else:
        chrom_id = batch.chrom_id
        pos = batch.pos
    is_het_u = np.asarray(is_het_u)
    major_u = np.asarray(major_u)
    second_u = np.asarray(second_u)
    p1_u = np.asarray(p1_u, np.float64)
    p2_u = np.asarray(p2_u, np.float64)
    return CallResult(
        chrom_id=chrom_id,
        chrom_table=batch.chrom_table,
        pos=pos,
        is_het=is_het_u[inverse],
        major=major_u[inverse],
        second=second_u[inverse],
        conf_hom=p1_u[inverse],
        conf_het=p2_u[inverse],
        conf_type=conf_type,
        class_idx=np.ascontiguousarray(inverse, np.int32),
        cls_is_het=is_het_u,
        cls_major=major_u,
        cls_second=second_u,
        cls_conf_hom=p1_u,
        cls_conf_het=p2_u,
    )
