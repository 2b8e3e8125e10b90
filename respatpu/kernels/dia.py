"""Diagonal-format (DIA) SpMV: gather-free streaming kernel.

CSR-style SpMV reads a column index per entry and gathers x. Stencil and
near-stencil matrices (5/7/27-point Laplacians: ecology2, atmosmodd/l,
tmt_unsym, parabolic_fem class) are better served by the diagonal format:

    y += D_k * shift(x, off_k)      for each stored diagonal k

which is pure contiguous streaming (values + one slice of x per diagonal, no
index array at all) and is bounded by device-memory bandwidth -- below the
CSR byte model, since column indices vanish. The host analyzer picks the
diagonals worth densifying; leftover entries fall back to the ELL gather path
(hybrid), so any matrix can use this kernel with the dense-diagonal fraction
riding the fast path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import precision as prec
from ..formats import COOMatrix, CSRMatrix, coo_to_csr
from ..precision import DF, Policy, get_policy

__all__ = ["DiaMatrix", "build_dia", "DeviceDia", "dia_to_device", "dia_spmv",
           "dia_coverage"]


@dataclasses.dataclass
class DiaMatrix:
    """Host DIA + CSR remainder."""

    n: int
    ncols: int
    offsets: np.ndarray  # int64[ndiag], sorted
    diags: np.ndarray  # float64[ndiag, n]; diags[k, i] = A[i, i + off_k]
    remainder: Optional[CSRMatrix]  # entries not on stored diagonals
    nnz_dia: int


def dia_coverage(a: CSRMatrix, min_fill: float = 0.25):
    """Which diagonals are worth densifying: occupancy >= min_fill."""
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_lengths())
    offs = a.indices.astype(np.int64) - rows
    uniq, counts = np.unique(offs, return_counts=True)
    keep = counts >= max(1, int(min_fill * a.nrows))
    covered = counts[keep].sum()
    return uniq[keep], covered / max(a.nnz, 1)


def build_dia(a: CSRMatrix, min_fill: float = 0.25,
              max_diags: int = 512) -> DiaMatrix:
    n, ncols = a.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    offs = a.indices.astype(np.int64) - rows
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts)
    keep_offs = []
    for k in order[:max_diags]:
        if counts[k] >= max(1, int(min_fill * n)):
            keep_offs.append(uniq[k])
    keep_offs = np.sort(np.asarray(keep_offs, dtype=np.int64))
    keep_set = set(int(o) for o in keep_offs)

    ndiag = len(keep_offs)
    diags = np.zeros((max(ndiag, 1), n), dtype=np.float64)
    off_pos = {int(o): k for k, o in enumerate(keep_offs)}
    on_dia = np.array([int(o) in keep_set for o in offs]) if a.nnz else np.zeros(0, bool)
    if ndiag:
        k_idx = np.array([off_pos[int(o)] for o in offs[on_dia]], dtype=np.int64)
        diags[k_idx, rows[on_dia]] = a.data[on_dia]
    rem = None
    n_rem = int((~on_dia).sum())
    if n_rem:
        rem = coo_to_csr(COOMatrix(a.shape,
                                   rows[~on_dia].astype(np.int32),
                                   a.indices[~on_dia].copy(),
                                   a.data[~on_dia].copy()))
    return DiaMatrix(n=n, ncols=ncols, offsets=keep_offs, diags=diags[:ndiag],
                     remainder=rem, nnz_dia=int(a.nnz - n_rem))


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceDia:
    n: int
    ncols: int
    offsets: Tuple[int, ...]  # static! unrolled into the jitted kernel
    policy_name: str
    diags: Tuple[jax.Array, ...]  # [ndiag, n] x (1 or 2 words)
    xpad: int  # static pad amount

    def tree_flatten(self):
        return ((self.diags,), (self.n, self.ncols, self.offsets,
                                self.policy_name, self.xpad))

    @classmethod
    def tree_unflatten(cls, aux, children):
        n, ncols, offsets, policy_name, xpad = aux
        return cls(n, ncols, offsets, policy_name, children[0], xpad)

    @property
    def policy(self) -> Policy:
        return get_policy(self.policy_name)


def dia_to_device(d: DiaMatrix, policy: Union[str, Policy] = "fp32") -> DeviceDia:
    policy = get_policy(policy)
    if policy.double_word:
        arrs = prec.df_from_f64_host(d.diags)
    else:
        arrs = policy.cast_host(d.diags)
    xpad = int(max([abs(int(o)) for o in d.offsets], default=0))
    return DeviceDia(n=d.n, ncols=d.ncols,
                     offsets=tuple(int(o) for o in d.offsets),
                     policy_name=policy.name,
                     diags=tuple(jnp.asarray(v) for v in arrs),
                     xpad=xpad)


@jax.jit
def _dia_spmv_single(d: DeviceDia, x: jax.Array) -> jax.Array:
    # like the ELL kernel: x rounded to the storage dtype (and flushed under
    # FTZ), products and sums in the policy's accumulation dtype
    dt = d.diags[0].dtype
    acc = d.policy.accum_dtype
    xs = prec.ftz(x.astype(dt)[:d.ncols], d.policy.flush_to_zero)
    xp = jnp.zeros(d.n + 2 * d.xpad, dtype=acc).at[d.xpad:d.xpad + d.ncols].set(
        xs.astype(acc))
    y = jnp.zeros(d.n, dtype=acc)
    for k, off in enumerate(d.offsets):  # static unroll -> one fused pass
        y = y + d.diags[0][k].astype(acc) * jax.lax.dynamic_slice(
            xp, (d.xpad + off,), (d.n,))
    return y.astype(dt)


@jax.jit
def _dia_spmv_df(d: DeviceDia, x: DF) -> DF:
    npd = d.n + 2 * d.xpad
    xh = jnp.zeros(npd, jnp.float32).at[d.xpad:d.xpad + d.ncols].set(x.hi[:d.ncols])
    xl = jnp.zeros(npd, jnp.float32).at[d.xpad:d.xpad + d.ncols].set(x.lo[:d.ncols])
    acc = DF(jnp.zeros(d.n, jnp.float32), jnp.zeros(d.n, jnp.float32))
    dh, dl = d.diags
    for k, off in enumerate(d.offsets):
        xs = DF(jax.lax.dynamic_slice(xh, (d.xpad + off,), (d.n,)),
                jax.lax.dynamic_slice(xl, (d.xpad + off,), (d.n,)))
        acc = prec.df_add(acc, prec.df_mul(DF(dh[k], dl[k]), xs))
    return acc


def dia_spmv(d: DeviceDia, x):
    if d.policy.double_word:
        if not isinstance(x, DF):
            x = prec._as_df(jnp.asarray(x))
        return _dia_spmv_df(d, x)
    return _dia_spmv_single(d, jnp.asarray(x))
