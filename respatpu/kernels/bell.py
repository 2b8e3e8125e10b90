"""Block-ELL (BELL) SpMV: R x C blocklets with row-group-shared gathers.

A blocked SpMV layout for matrices with *mesh locality* (FEM corpus
entries: 2cubes_sphere, cfd2, offshore, ...). RG-ELL (kernels/rgell.py) pays
one gather per (row, 8-col-group) slot; BELL shares each gather across R
consecutive rows: entries are binned into R x C dense blocklets keyed by
(row//R, col//C), so all entries of R neighbouring mesh rows that touch the
same C-wide column segment cost ONE x-gather:

    xg[s]   = x2[sc[s], :]                  # [ns, C] row gather (shared)
    part[s] = sum_c blk[s, :, c] * xg[s, c] # dense blocklet FMA (streamed)
    y       = per-group reduction of part   # reshape-sum + tiny gather

The per-group reduction pads each group's slot run to a multiple of
``KFIX`` in the slot stream (zero blocklets), reduces with a static
reshape-sum, and combines the few sub-partials per group with an R-wide row
gather — all static shapes, no scatter, so results are deterministic.

Block shape (R, C) is chosen per matrix as the candidate that streams the
fewest bytes (blocklets, segment indices and gathered x rows): the apply is
memory-bound, and the byte count follows from the structure alone.

Replaces the same vendor calls as kernels/spmv.py (mkl_sparse_?_mv,
test_spmv.c:168-180; cusparseSpMV, GPU/spmv.cu:176-195) for the
unstructured part of the corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import CSRMatrix
from ..precision import Policy, get_policy

__all__ = ["BellMatrix", "build_bell", "DeviceBell", "bell_to_device",
           "bell_spmv", "bell_bytes", "choose_block_shape"]

KFIX = 8  # slot-stream alignment per group (stage-1 reshape-sum width)


@dataclasses.dataclass
class BellMatrix:
    """Host BELL arrays."""

    nrows: int
    ncols: int
    nnz: int
    r: int
    c: int
    ns: int  # padded slot count (multiple of KFIX per group)
    blk: np.ndarray  # float32[ns, r, c]
    sc: np.ndarray  # int32[ns] column-segment index into x2
    part_idx: np.ndarray  # int32[ngrp, max_parts] sub-partial ids
    part_mask: np.ndarray  # float32[ngrp, max_parts]
    slots_per_entry: float


def _slot_counts(a: CSRMatrix, r: int, c: int) -> Tuple[int, int, np.ndarray]:
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_lengths())
    nbc = -(-a.ncols // c)
    key = (rows // r) * nbc + (a.indices.astype(np.int64) // c)
    uk = np.unique(key)
    ngrp = -(-a.nrows // r)
    grp_counts = np.bincount((uk // nbc).astype(np.int64), minlength=ngrp)
    return uk.size, ngrp, grp_counts


def bell_bytes(a: CSRMatrix, r: int, c: int) -> int:
    """Bytes one fp32 BELL SpMV with block shape (r, c) reads: padded
    blocklets, their segment indices and gathered x rows, plus the
    combine-stage gather of ``r``-wide sub-partials."""
    _, ngrp, grp_counts = _slot_counts(a, r, c)
    padded = np.maximum(-(-grp_counts // KFIX), (grp_counts > 0)) * KFIX
    ns_pad = int(padded.sum())
    mp = int(max((padded // KFIX).max(), 1))
    return ns_pad * (r * c * 4 + c * 4 + 4) + ngrp * mp * (r * 4 + 8)


_CANDIDATES = ((8, 8), (8, 32), (16, 16), (16, 32), (32, 32))


def choose_block_shape(a: CSRMatrix) -> Tuple[int, int]:
    """The candidate shape whose SpMV reads the fewest bytes."""
    return min(_CANDIDATES, key=lambda rc: bell_bytes(a, *rc))


def build_bell(a: CSRMatrix, r: Optional[int] = None,
               c: Optional[int] = None) -> BellMatrix:
    if r is None or c is None:
        r, c = choose_block_shape(a)
    m, n = a.shape
    rows = np.repeat(np.arange(m, dtype=np.int64), a.row_lengths())
    cols = a.indices.astype(np.int64)
    nbc = -(-n // c)
    ngrp = -(-m // r)
    key = (rows // r) * nbc + (cols // c)
    uk, inv = np.unique(key, return_inverse=True)
    ns = uk.size
    usg = (uk // nbc).astype(np.int64)
    usc = (uk % nbc).astype(np.int32)
    grp_counts = np.bincount(usg, minlength=ngrp)
    padded = np.maximum(-(-grp_counts // KFIX), (grp_counts > 0)) * KFIX
    pad_off = np.zeros(ngrp + 1, dtype=np.int64)
    np.cumsum(padded, out=pad_off[1:])
    ns_pad = int(pad_off[-1])
    # rank of each unique slot within its group (uk is sorted by (group, seg))
    grp_start = np.zeros(ngrp + 1, dtype=np.int64)
    np.cumsum(grp_counts, out=grp_start[1:])
    rank = np.arange(ns, dtype=np.int64) - grp_start[usg]
    pos = pad_off[usg] + rank  # padded-stream position of each unique slot

    blk = np.zeros((ns_pad, r, c), dtype=np.float32)
    np.add.at(blk, (pos[inv], (rows % r).astype(np.int64),
                    (cols % c).astype(np.int64)), a.data.astype(np.float32))
    sc = np.zeros(ns_pad, dtype=np.int32)
    sc[pos] = usc  # padding slots gather segment 0 against zero blocklets

    parts = (padded // KFIX).astype(np.int64)
    mp = int(max(parts.max(), 1))
    part_idx = np.zeros((ngrp, mp), dtype=np.int32)
    part_mask = np.zeros((ngrp, mp), dtype=np.float32)
    sub_off = pad_off // KFIX
    for p in range(mp):
        has = parts > p
        part_idx[has, p] = (sub_off[:-1][has] + p).astype(np.int32)
        part_mask[has, p] = 1.0
    return BellMatrix(nrows=m, ncols=n, nnz=a.nnz, r=int(r), c=int(c),
                      ns=ns_pad, blk=blk, sc=sc, part_idx=part_idx,
                      part_mask=part_mask,
                      slots_per_entry=ns_pad / max(a.nnz, 1))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceBell:
    nrows: int
    ncols: int
    nnz: int
    r: int
    c: int
    policy_name: str
    blk: jax.Array
    sc: jax.Array
    part_idx: jax.Array
    part_mask: jax.Array

    def tree_flatten(self):
        return ((self.blk, self.sc, self.part_idx, self.part_mask),
                (self.nrows, self.ncols, self.nnz, self.r, self.c,
                 self.policy_name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def policy(self) -> Policy:
        return get_policy(self.policy_name)

    @property
    def shape(self):
        return (self.nrows, self.ncols)


def bell_to_device(a: Union[CSRMatrix, BellMatrix],
                   policy: Union[str, Policy] = "fp32",
                   r: Optional[int] = None,
                   c: Optional[int] = None) -> DeviceBell:
    policy = get_policy(policy)
    if policy.double_word:
        raise NotImplementedError(
            "BELL is a low-precision fast path; use fmt='rgell'/'ell' for "
            "the df64 reference SpMV")
    b = a if isinstance(a, BellMatrix) else build_bell(a, r=r, c=c)
    (blk,) = policy.cast_host(b.blk)
    return DeviceBell(nrows=b.nrows, ncols=b.ncols, nnz=b.nnz, r=b.r, c=b.c,
                      policy_name=policy.name,
                      blk=jnp.asarray(blk),
                      sc=jnp.asarray(b.sc),
                      part_idx=jnp.asarray(b.part_idx),
                      part_mask=jnp.asarray(b.part_mask))


@jax.jit
def _bell_single(a: DeviceBell, x: jax.Array) -> jax.Array:
    dt = a.blk.dtype
    c = a.c
    npad = -(-a.ncols // c) * c
    xp = jnp.zeros(npad, dt).at[:a.ncols].set(x[:a.ncols].astype(dt))
    x2 = xp.reshape(-1, c)
    xg = jnp.take(x2, a.sc, axis=0)  # [ns, c] shared row gather
    part = jnp.sum(a.blk * xg[:, None, :], axis=2,
                   dtype=a.policy.accum_dtype)  # [ns, r]
    sub = part.reshape(-1, KFIX, a.r).sum(axis=1)  # [ns/KFIX, r]
    g = jnp.take(sub, a.part_idx, axis=0)  # [ngrp, mp, r]
    y = jnp.sum(g * a.part_mask[:, :, None], axis=1)  # [ngrp, r]
    return y.reshape(-1)[:a.nrows].astype(dt)


def bell_spmv(a: DeviceBell, x) -> jax.Array:
    return _bell_single(a, jnp.asarray(x))
