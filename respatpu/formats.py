"""Host-side sparse matrix containers and device-format builders.

Replaces the reference's ``CSR``/``COO`` structs and COO->CSR conversion
(ReadMatrixMarket/loadMatrixMarket.h:17-36, loadMatrixMarket.cpp:216-242) with
numpy-backed containers plus padded static-shape device layouts.

Design: host-side structure (numpy int32 index arrays) is analyzed once per
matrix; device kernels only ever see *static-shape* dense arrays produced here
(padded row-block "ELLR" layout, level-set schedules, ...), so everything under
``jit`` is shape-static and XLA can fuse it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "EllpackR",
    "coo_to_csr",
    "csr_to_coo",
    "csr_transpose",
    "build_ellr",
    "split_triangular",
]


@dataclass
class COOMatrix:
    """Coordinate-format sparse matrix (host, numpy).

    Mirrors the capability of the reference ``COO`` struct
    (ReadMatrixMarket/loadMatrixMarket.h:29-36) minus the 1-base option:
    indices are always 0-based here; base conversion is an I/O concern.
    """

    shape: Tuple[int, int]
    row: np.ndarray  # int32[nnz]
    col: np.ndarray  # int32[nnz]
    val: np.ndarray  # float64[nnz] (canonical host precision)

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def tocsr(self) -> "CSRMatrix":
        return coo_to_csr(self)


@dataclass
class CSRMatrix:
    """Compressed-sparse-row matrix (host, numpy), canonical container.

    Mirrors the reference ``CSR`` struct (ReadMatrixMarket/loadMatrixMarket.h:17-27).
    Column indices within each row are sorted ascending (the reference sorts
    per-row too, loadMatrixMarket.cpp:237-242).
    """

    shape: Tuple[int, int]
    indptr: np.ndarray  # int32[m+1]
    indices: np.ndarray  # int32[nnz]
    data: np.ndarray  # float64[nnz]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def nrows(self) -> int:
        return self.shape[0]

    @property
    def ncols(self) -> int:
        return self.shape[1]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def tocoo(self) -> COOMatrix:
        return csr_to_coo(self)

    def toarray(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.data.dtype)
        rows = np.repeat(np.arange(m), self.row_lengths())
        out[rows, self.indices] = self.data
        return out

    def transpose(self) -> "CSRMatrix":
        return csr_transpose(self)

    def diagonal(self) -> np.ndarray:
        m, n = self.shape
        d = np.zeros(min(m, n), dtype=self.data.dtype)
        rows = np.repeat(np.arange(m), self.row_lengths())
        mask = rows == self.indices
        d[rows[mask]] = self.data[mask]
        return d


def coo_to_csr(a: COOMatrix, sum_duplicates: bool = True) -> CSRMatrix:
    """COO -> CSR with per-row sorted columns.

    Equivalent of the reference's counting-sort + per-row qsort conversion
    (loadMatrixMarket.cpp:216-242), including the duplicate handling the
    reference *lacks* (its symmetric-expansion bug, SURVEY.md quirk #1).
    """
    m, n = a.shape
    # lexsort by (row, col): stable counting via argsort on fused key
    key = a.row.astype(np.int64) * n + a.col.astype(np.int64)
    order = np.argsort(key, kind="stable")
    row = a.row[order]
    col = a.col[order]
    val = a.val[order]
    if sum_duplicates and len(key) > 0:
        k = key[order]
        uniq = np.empty(len(k), dtype=bool)
        uniq[0] = True
        np.not_equal(k[1:], k[:-1], out=uniq[1:])
        seg = np.cumsum(uniq) - 1
        val = np.bincount(seg, weights=val, minlength=seg[-1] + 1 if len(seg) else 0)
        row = row[uniq]
        col = col[uniq]
    counts = np.bincount(row, minlength=m)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    indptr = indptr.astype(np.int32) if indptr[-1] < 2**31 else indptr
    return CSRMatrix(
        shape=(m, n),
        indptr=np.ascontiguousarray(indptr, dtype=np.int32),
        indices=np.ascontiguousarray(col, dtype=np.int32),
        data=np.ascontiguousarray(val, dtype=np.float64),
    )


def csr_to_coo(a: CSRMatrix) -> COOMatrix:
    rows = np.repeat(np.arange(a.nrows, dtype=np.int32), a.row_lengths())
    return COOMatrix(shape=a.shape, row=rows, col=a.indices.copy(), val=a.data.copy())


def csr_transpose(a: CSRMatrix) -> CSRMatrix:
    """CSR transpose == CSC view of A, built with a counting sort.

    Covers the reference's transpose-on-load path used to feed CSC consumers
    (loadMatrixMarket.cpp:79-81, test_superLU_MT.c:85).
    """
    m, n = a.shape
    coo = csr_to_coo(a)
    return coo_to_csr(COOMatrix(shape=(n, m), row=coo.col, col=coo.row, val=coo.val),
                      sum_duplicates=False)


# ---------------------------------------------------------------------------
# Padded row-block device layout (ELLPACK-R with long-row splitting)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EllrMeta:
    """Static (hashable) metadata for an EllpackR layout; safe to close over in jit."""

    nrows: int
    ncols: int
    nnz: int
    k: int  # nnz slots per sub-row
    nsub: int  # number of sub-rows (padded)
    max_parts: int  # max sub-rows per original row


@dataclass
class EllpackR:
    """Device layout for SpMV: fixed-K padded sub-rows.

    Rows longer than K nnz are split into several sub-rows; a second static
    combine stage (``part_idx``/``part_mask``) sums sub-row partials back into
    row results. All arrays are static-shape; padding slots carry col=0/val=0 so
    gathered garbage is multiplied by zero.

    This is our replacement for the MKL/cuSPARSE CSR SpMV handle
    (test_spmv.c:91,148; GPU/spmv.cu:130-164): structure is analyzed once on
    host, numeric work on device is dense, maskable and shape-static.
    """

    meta: EllrMeta
    cols: np.ndarray  # int32[nsub, k]
    vals: np.ndarray  # float64[nsub, k] (cast at device-put time)
    # combine stage: row i = sum over p of partials[part_idx[i, p]] * part_mask[i, p]
    part_idx: np.ndarray  # int32[nrows, max_parts]
    part_mask: np.ndarray  # float32[nrows, max_parts]


def _choose_k(row_len: np.ndarray, candidates=(4, 8, 16, 32, 64, 128, 256)) -> int:
    """Pick K minimizing padded volume nsub*K (sub-rows = ceil(len/K), min 1)."""
    best_k, best_vol = candidates[0], None
    for k in candidates:
        nsub = np.maximum((row_len + k - 1) // k, 1).sum()
        vol = nsub * k
        if best_vol is None or vol < best_vol:
            best_k, best_vol = k, vol
    return int(best_k)


def build_ellr(a: CSRMatrix, k: Optional[int] = None, sub_align: int = 8) -> EllpackR:
    """Build the padded row-block layout from host CSR."""
    m, n = a.shape
    row_len = a.row_lengths().astype(np.int64)
    if k is None:
        k = _choose_k(row_len)
    parts = np.maximum((row_len + k - 1) // k, 1)  # sub-rows per row (>=1)
    max_parts = int(parts.max()) if m else 1
    sub_start = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(parts, out=sub_start[1:])
    nsub_real = int(sub_start[-1])
    nsub = ((nsub_real + sub_align - 1) // sub_align) * sub_align

    cols = np.zeros((nsub, k), dtype=np.int32)
    vals = np.zeros((nsub, k), dtype=np.float64)
    # Scatter each nnz to (subrow, slot).
    rows = np.repeat(np.arange(m, dtype=np.int64), row_len)
    pos_in_row = np.arange(a.nnz, dtype=np.int64) - np.repeat(a.indptr[:-1].astype(np.int64), row_len)
    sub = sub_start[rows] + pos_in_row // k
    slot = pos_in_row % k
    cols[sub, slot] = a.indices
    vals[sub, slot] = a.data

    part_idx = np.zeros((m, max_parts), dtype=np.int32)
    part_mask = np.zeros((m, max_parts), dtype=np.float32)
    for p in range(max_parts):
        has = parts > p
        part_idx[has, p] = (sub_start[:-1] + p)[has]
        part_mask[has, p] = 1.0
    meta = EllrMeta(nrows=m, ncols=n, nnz=a.nnz, k=int(k), nsub=nsub, max_parts=max_parts)
    return EllpackR(meta=meta, cols=cols, vals=vals, part_idx=part_idx, part_mask=part_mask)


def split_triangular(a: CSRMatrix, unit_diag_lower: bool = True):
    """Split square CSR A into (L, D, U): strict lower CSR, diagonal vector, upper CSR.

    Used by ILU(0)/LU apply paths (GPU/ilu0.cu:122-141 descriptor equivalent).
    ``U`` includes the diagonal; ``L`` is strict lower (unit diagonal implied
    when ``unit_diag_lower``).
    """
    m, n = a.shape
    assert m == n, "triangular split requires square matrix"
    rows = np.repeat(np.arange(m, dtype=np.int32), a.row_lengths())
    lower = a.indices < rows
    upper = a.indices > rows
    diag_mask = a.indices == rows
    d = np.zeros(m, dtype=a.data.dtype)
    d[rows[diag_mask]] = a.data[diag_mask]

    def _sub(mask, include_diag=False):
        sel = mask | (diag_mask if include_diag else np.zeros_like(mask))
        counts = np.bincount(rows[sel], minlength=m)
        indptr = np.zeros(m + 1, dtype=np.int32)
        np.cumsum(counts, out=indptr[1:])
        return CSRMatrix(shape=(m, n), indptr=indptr.astype(np.int32),
                         indices=a.indices[sel].copy(), data=a.data[sel].copy())

    L = _sub(lower)
    U = _sub(upper, include_diag=True)
    return L, d, U
