"""CSR SpMV: padded row-block (ELLPACK-R) gather kernel, all precisions.

Replaces ``mkl_sparse_d_mv``/``mkl_sparse_s_mv`` (test_spmv.c:168-180) and
``cusparseSpMV`` (GPU/spmv.cu:176-195). Structure is preprocessed on host into
the static-shape :class:`respatpu.formats.EllpackR` layout; the device kernel
is then a dense gather + multiply + row reduction that XLA fuses into a single
memory-bound pass:

    xg[s, t] = x[cols[s, t]]          # gather (ordinary loads on the GPU)
    part[s]  = sum_t vals[s, t] * xg[s, t]
    y[i]     = sum_p part[part_idx[i, p]] * part_mask[i, p]

For the df64 (emulated fp64) policy the multiply and the row reduction run in
double-float arithmetic (respatpu.precision), with a log-depth pairwise tree
for the per-row sum so the result is deterministic and ~fp64-accurate.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import precision as prec
from ..formats import CSRMatrix, EllpackR, EllrMeta, build_ellr
from ..precision import DF, Policy, get_policy

__all__ = ["DeviceEllr", "to_device", "spmv", "spmv_csr_reference"]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceEllr:
    """Device-resident EllpackR matrix under a fixed precision policy."""

    meta: EllrMeta  # static
    policy_name: str  # static
    cols: jax.Array  # int32[nsub, k]
    vals: Tuple[jax.Array, ...]  # (v,) or (hi, lo) for df64
    part_idx: jax.Array  # int32[nrows, max_parts]
    part_mask: jax.Array  # float32[nrows, max_parts]

    def tree_flatten(self):
        return ((self.cols, self.vals, self.part_idx, self.part_mask),
                (self.meta, self.policy_name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        meta, policy_name = aux
        cols, vals, part_idx, part_mask = children
        return cls(meta, policy_name, cols, vals, part_idx, part_mask)

    @property
    def policy(self) -> Policy:
        return get_policy(self.policy_name)

    @property
    def shape(self):
        return (self.meta.nrows, self.meta.ncols)

    @property
    def nnz(self):
        return self.meta.nnz


_FORMATS = ("ell", "dia", "auto", "bell", "rgell")


def to_device(a: Union[CSRMatrix, EllpackR], policy: Union[str, Policy] = "fp32",
              k: Optional[int] = None, fmt: str = "ell"):
    """Pack a host CSR (or prebuilt EllpackR) into device arrays under a policy.

    ``fmt``: "ell" (gather kernel), "dia" (diagonal streaming kernel, with ELL
    remainder), "bell"/"rgell" (blocked layouts, see their modules), or
    "auto": DIA when dense diagonals cover >=90% of nnz with at most 3x
    padding (the stencil class), ELL otherwise, in every policy. The rule
    reads only the matrix structure.
    """
    if fmt not in _FORMATS:
        raise ValueError(f"unknown SpMV format {fmt!r}; available: {_FORMATS}")
    policy = get_policy(policy)
    if fmt == "rgell" and isinstance(a, CSRMatrix):
        from . import rgell as _rgell
        return _rgell.rgell_to_device(a, policy)
    if fmt == "bell" and isinstance(a, CSRMatrix):
        from . import bell as _bell
        return _bell.bell_to_device(a, policy)
    if fmt in ("auto", "dia") and isinstance(a, CSRMatrix):
        if fmt == "dia":
            return hybrid_to_device(a, policy)
        from . import dia as _dia
        offs, cov = _dia.dia_coverage(a)
        waste = len(offs) * a.shape[0] / max(a.nnz, 1)
        if cov >= 0.90 and waste <= 3.0:
            return hybrid_to_device(a, policy)
    ell = a if isinstance(a, EllpackR) else build_ellr(a, k=k)
    vals_host = policy.cast_host(ell.vals)
    return DeviceEllr(
        meta=ell.meta,
        policy_name=policy.name,
        cols=jnp.asarray(ell.cols),
        vals=tuple(jnp.asarray(v) for v in vals_host),
        part_idx=jnp.asarray(ell.part_idx),
        part_mask=jnp.asarray(ell.part_mask),
    )


def _combine_parts(partials, part_idx, part_mask):
    """Second stage: sum sub-row partials back into rows (static gather)."""
    if part_idx.shape[1] == 1:
        # common case: no split rows; partials are already row results gathered
        return jnp.take(partials, part_idx[:, 0], axis=0)
    g = jnp.take(partials, part_idx, axis=0)  # [nrows, max_parts]
    return jnp.sum(g * part_mask, axis=1)


def _combine_parts_df(partials: DF, part_idx, part_mask) -> DF:
    if part_idx.shape[1] == 1:
        return DF(jnp.take(partials.hi, part_idx[:, 0]),
                  jnp.take(partials.lo, part_idx[:, 0]))
    hi = jnp.take(partials.hi, part_idx, axis=0) * part_mask
    lo = jnp.take(partials.lo, part_idx, axis=0) * part_mask
    return prec.df_sum(DF(hi, lo), axis=1)


@functools.partial(jax.jit, static_argnames=("ftz_in",))
def _spmv_single(a: DeviceEllr, x: jax.Array, ftz_in: bool = False):
    policy = a.policy
    xx = x.astype(a.vals[0].dtype)
    if ftz_in or policy.flush_to_zero:
        xx = prec.ftz(xx)
    xg = jnp.take(xx, a.cols, axis=0, fill_value=0)  # [nsub, k]
    # products and sums in the accumulation dtype; only storage is narrow
    acc = policy.accum_dtype
    part = jnp.sum(a.vals[0].astype(acc) * xg.astype(acc), axis=1)
    y = _combine_parts(part, a.part_idx, a.part_mask)
    return y.astype(a.vals[0].dtype)


@jax.jit
def _spmv_df(a: DeviceEllr, x: DF) -> DF:
    vhi, vlo = a.vals
    xhi = jnp.take(x.hi, a.cols, axis=0, fill_value=0)
    xlo = jnp.take(x.lo, a.cols, axis=0, fill_value=0)
    prod = prec.df_mul(DF(vhi, vlo), DF(xhi, xlo))
    part = prec.df_sum(prod, axis=1)
    return _combine_parts_df(part, a.part_idx, a.part_mask)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceHybrid:
    """DIA fast path + optional ELL remainder (off-diagonal stragglers)."""

    dia: object  # DeviceDia
    rem: Optional[DeviceEllr]

    def tree_flatten(self):
        return ((self.dia, self.rem), ())

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def policy(self) -> Policy:
        return self.dia.policy

    @property
    def shape(self):
        return (self.dia.n, self.dia.ncols)


def hybrid_to_device(a: CSRMatrix, policy: Union[str, Policy]) -> DeviceHybrid:
    from . import dia as _dia
    policy = get_policy(policy)
    d = _dia.build_dia(a)
    rem = to_device(d.remainder, policy, fmt="ell") if d.remainder is not None else None
    return DeviceHybrid(dia=_dia.dia_to_device(d, policy), rem=rem)


def spmv(a, x, ftz_in: bool = False):
    """y = A @ x under the matrix's precision policy.

    ``a`` is a DeviceEllr or DeviceHybrid from :func:`to_device`. ``x`` may be
    a jax array (cast to the policy dtype) or a
    :class:`~respatpu.precision.DF` pair for the df64 policy. Returns an array
    (fp32/bf16 policies) or a DF pair (df64).
    """
    from .bell import DeviceBell, bell_spmv
    from .rgell import DeviceRgell, rgell_spmv
    if isinstance(a, DeviceBell):
        return bell_spmv(a, x)
    if isinstance(a, DeviceRgell):
        return rgell_spmv(a, x)
    if isinstance(a, DeviceHybrid):
        from . import dia as _dia
        y = _dia.dia_spmv(a.dia, x)
        if a.rem is not None:
            yr = spmv(a.rem, x, ftz_in=ftz_in)
            y = prec.df_add(y, yr) if isinstance(y, DF) else y + yr
        return y
    if a.policy.double_word:
        if not isinstance(x, DF):
            x = prec._as_df(jnp.asarray(x))
        return _spmv_df(a, x)
    return _spmv_single(a, jnp.asarray(x), ftz_in=ftz_in)


def spmv_csr_reference(a: CSRMatrix, x: np.ndarray) -> np.ndarray:
    """Host fp64 oracle (row-wise dot), used by tests and residual gates."""
    m, _ = a.shape
    y = np.zeros(m, dtype=np.float64)
    for i in range(m):
        s, e = a.indptr[i], a.indptr[i + 1]
        y[i] = np.dot(a.data[s:e], x[a.indices[s:e]])
    return y
