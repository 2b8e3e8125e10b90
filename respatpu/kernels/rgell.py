"""Row-gather ELL (RG-ELL): unstructured SpMV via 8-wide row gathers.

RG-ELL replaces element gathers with gathers of *contiguous rows* of a 2-D
table: x is reshaped to (n/8, 8) groups; each stored entry addresses
its group by one row-gather, and the within-group position is resolved by a
precomputed 8-wide weight stripe (value placed at lane col%8, zeros
elsewhere). Entries of the same (sub-row, group) pair share one gather and
one stripe, so clustered columns (post-RCM) amortize the 8x stripe padding:

    g[s, t, :]  = x2[grp[s, t], :]            # 8-wide row gather
    y_sub[s]    = sum_{t, j} w8[s, t, j] * g[s, t, j]

Traffic per stored slot: 4 B (grp) + 32 B (w8 fp32) amortized over the
entries sharing the slot; the gather does the rest. This is the
unstructured-matrix counterpart of the DIA fast path (kernels/dia.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import precision as prec
from ..formats import CSRMatrix
from ..precision import DF, Policy, get_policy

__all__ = ["RgellMatrix", "build_rgell", "DeviceRgell", "rgell_to_device",
           "rgell_spmv"]

G = 8  # group width (row-gather stripe)


@dataclasses.dataclass
class RgellMatrix:
    """Host RG-ELL arrays."""

    nrows: int
    ncols: int
    nnz: int
    kprime: int  # group-slots per sub-row
    nsub: int
    max_parts: int
    grp: np.ndarray  # int32[nsub, kprime] group index into x2
    w8: np.ndarray  # float64[nsub, kprime, G]
    part_idx: np.ndarray  # int32[nrows, max_parts]
    part_mask: np.ndarray  # float32[nrows, max_parts]
    slots_per_entry: float  # diagnostics: kprime-slot amortization


def build_rgell(a: CSRMatrix, kprime: Optional[int] = None,
                sub_align: int = 8) -> RgellMatrix:
    m, n = a.shape
    row_len = a.row_lengths()
    # per row: group columns by col//G — fully vectorized (round 2: the old
    # per-entry dict loop took hours at big-group scale, SURVEY §2 native rule)
    rows = np.repeat(np.arange(m, dtype=np.int64), row_len.astype(np.int64))
    cols = np.asarray(a.indices, dtype=np.int64)
    vals = np.asarray(a.data, dtype=np.float64)
    ngrp_cols = max(1, -(-n // G))
    key = rows * ngrp_cols + cols // G
    uk, inv = np.unique(key, return_inverse=True)  # sorted: (row, g) order
    slot_row = uk // ngrp_cols
    slot_g = (uk % ngrp_cols).astype(np.int32)
    slot_counts = np.bincount(slot_row, minlength=m).astype(np.int64)
    total_slots = int(np.maximum(slot_counts, 1).sum())
    slot_counts1 = np.maximum(slot_counts, 1)
    if kprime is None:
        # minimize padded volume like _choose_k
        best = None
        for k in (2, 4, 8, 16, 32, 64, 128):
            nsub_k = int(np.maximum(-(-slot_counts1 // k), 1).sum())
            vol = nsub_k * k
            if best is None or vol < best[1]:
                best = (k, vol)
        kprime = best[0]
    parts = np.maximum(-(-slot_counts1 // kprime), 1)
    max_parts = int(parts.max()) if m else 1
    sub_start = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(parts, out=sub_start[1:])
    nsub = int(sub_start[-1])
    nsub = ((nsub + sub_align - 1) // sub_align) * sub_align

    grp = np.zeros((nsub, kprime), dtype=np.int32)
    w8 = np.zeros((nsub, kprime, G), dtype=np.float64)
    # slot index t within its row, then (sub, pos) coordinates
    row_start = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(slot_counts, out=row_start[1:])
    t = np.arange(uk.size, dtype=np.int64) - row_start[slot_row]
    sub = sub_start[slot_row] + t // kprime
    pos = t % kprime
    grp[sub, pos] = slot_g
    np.add.at(w8, (sub[inv], pos[inv], cols % G), vals)
    pm = np.arange(max_parts, dtype=np.int64)[None, :] < parts[:, None]
    part_idx = np.where(
        pm, sub_start[:m, None] + np.arange(max_parts, dtype=np.int64)[None, :],
        0).astype(np.int32)
    part_mask = pm.astype(np.float32)
    return RgellMatrix(nrows=m, ncols=n, nnz=a.nnz, kprime=int(kprime),
                       nsub=nsub, max_parts=max_parts, grp=grp, w8=w8,
                       part_idx=part_idx, part_mask=part_mask,
                       slots_per_entry=total_slots / max(a.nnz, 1))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceRgell:
    nrows: int
    ncols: int
    nnz: int
    policy_name: str
    grp: jax.Array
    w8: Tuple[jax.Array, ...]
    part_idx: jax.Array
    part_mask: jax.Array

    def tree_flatten(self):
        return ((self.grp, self.w8, self.part_idx, self.part_mask),
                (self.nrows, self.ncols, self.nnz, self.policy_name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def policy(self) -> Policy:
        return get_policy(self.policy_name)

    @property
    def shape(self):
        return (self.nrows, self.ncols)


def rgell_to_device(a: Union[CSRMatrix, RgellMatrix],
                    policy: Union[str, Policy] = "fp32") -> DeviceRgell:
    policy = get_policy(policy)
    r = a if isinstance(a, RgellMatrix) else build_rgell(a)
    if policy.double_word:
        w = prec.df_from_f64_host(r.w8)
    else:
        w = policy.cast_host(r.w8)
    return DeviceRgell(nrows=r.nrows, ncols=r.ncols, nnz=r.nnz,
                       policy_name=policy.name,
                       grp=jnp.asarray(r.grp),
                       w8=tuple(jnp.asarray(x) for x in w),
                       part_idx=jnp.asarray(r.part_idx),
                       part_mask=jnp.asarray(r.part_mask))


def _x_groups(x, ncols):
    npad = -(-ncols // G) * G
    xp = jnp.zeros(npad, x.dtype).at[:ncols].set(x[:ncols])
    return xp.reshape(-1, G)


@jax.jit
def _rgell_single(a: DeviceRgell, x: jax.Array) -> jax.Array:
    dt = a.w8[0].dtype
    x2 = _x_groups(x.astype(dt), a.ncols)
    g = jnp.take(x2, a.grp, axis=0)  # [nsub, k', G] row gather
    part = jnp.sum(a.w8[0] * g, axis=(1, 2))
    if a.part_idx.shape[1] == 1:
        y = jnp.take(part, a.part_idx[:, 0])
    else:
        y = jnp.sum(jnp.take(part, a.part_idx, axis=0) * a.part_mask, axis=1)
    return y.astype(dt)


@jax.jit
def _rgell_df(a: DeviceRgell, x: DF) -> DF:
    xh2 = _x_groups(x.hi, a.ncols)
    xl2 = _x_groups(x.lo, a.ncols)
    gh = jnp.take(xh2, a.grp, axis=0)
    gl = jnp.take(xl2, a.grp, axis=0)
    prod = prec.df_mul(DF(a.w8[0], a.w8[1]), DF(gh, gl))
    flat = DF(prod.hi.reshape(prod.hi.shape[0], -1),
              prod.lo.reshape(prod.lo.shape[0], -1))
    part = prec.df_sum(flat, axis=1)
    if a.part_idx.shape[1] == 1:
        return DF(jnp.take(part.hi, a.part_idx[:, 0]),
                  jnp.take(part.lo, a.part_idx[:, 0]))
    ph = jnp.take(part.hi, a.part_idx, axis=0) * a.part_mask
    pl = jnp.take(part.lo, a.part_idx, axis=0) * a.part_mask
    return prec.df_sum(DF(ph, pl), axis=1)


def rgell_spmv(a: DeviceRgell, x):
    if a.policy.double_word:
        if not isinstance(x, DF):
            x = prec._as_df(jnp.asarray(x))
        return _rgell_df(a, x)
    return _rgell_single(a, jnp.asarray(x))
