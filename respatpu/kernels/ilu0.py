"""ILU(0) factorization via fine-grained fixed-point sweeps.

Replaces ``cusparseXcsrilu02`` (GPU/ilu0.cu:197-275). Algorithm: Chow & Patel,
"Fine-grained parallel incomplete LU factorization" (SIAM J. Sci. Comput.,
2015) — every stored entry is updated independently from the current L/U
values, so one sweep is a fully parallel gather/multiply/reduce over all nnz
with static shapes (schedule from :func:`respatpu.analysis.chow_patel_schedule`):

    s      = a_ij - sum_k l_ik * u_kj        (k < min(i,j), k in both patterns)
    val_ij = s / u_jj   if i > j   else   s

The fixed point is exactly ILU(0); running it on a *filled* pattern
(analysis.symbolic_fill_lu) makes the fixed point the exact LU factorization,
which is how the direct-solver path reuses this kernel. Convergence is
monitored with the nonlinear residual max|val - F(val)|.

Zero-pivot (structural or numerical) detection is returned as data, mirroring
``cusparseXcsrilu02_zeroPivot`` (GPU/ilu0.cu:221-226,278-282), with optional
PARDISO-style pivot perturbation (test_pardiso.c:144-148: threshold eps*||A||,
eps = 1e-4 single / 1e-13 double).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import precision as prec
from ..analysis import IluSchedule, chow_patel_schedule
from ..formats import CSRMatrix
from ..precision import DF, Policy, get_policy

__all__ = ["DeviceIluSchedule", "ilu_schedule_to_device", "ilu0_factor",
           "ilu0_converged", "CP_CONVERGED", "Ilu0Result",
           "ilu0_host_reference"]

# relative fixed-point residual (max|F(v) - v| / max|a|) below which the
# Chow-Patel sweeps count as converged
CP_CONVERGED = 1e-2


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceIluSchedule:
    nnz: int
    t_max: int
    policy_name: str
    pairs_a: jax.Array  # int32[nnz, t_max], -1 padded -> masked
    pairs_b: jax.Array
    is_lower: jax.Array  # float mask [nnz]
    diag_pos_col: jax.Array  # int32[nnz]
    diag_pos: jax.Array  # int32[n]

    def tree_flatten(self):
        return ((self.pairs_a, self.pairs_b, self.is_lower, self.diag_pos_col,
                 self.diag_pos), (self.nnz, self.t_max, self.policy_name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def policy(self) -> Policy:
        return get_policy(self.policy_name)


def ilu_schedule_to_device(sched: IluSchedule,
                           policy: Union[str, Policy] = "fp32") -> DeviceIluSchedule:
    policy = get_policy(policy)
    return DeviceIluSchedule(
        nnz=sched.nnz, t_max=sched.t_max, policy_name=policy.name,
        pairs_a=jnp.asarray(sched.pairs_a.astype(np.int32)),
        pairs_b=jnp.asarray(sched.pairs_b.astype(np.int32)),
        is_lower=jnp.asarray(sched.is_lower),
        diag_pos_col=jnp.asarray(sched.diag_pos_col.astype(np.int32)),
        diag_pos=jnp.asarray(sched.diag_pos.astype(np.int32)),
    )


class Ilu0Result(NamedTuple):
    values: object  # jax array [nnz] or DF: factor values on A's pattern
    n_pivot_perturbed: jax.Array  # int32 scalar
    residual: jax.Array  # float32: max |val - F(val)| of last sweep


def _mask_gather(vals, idx):
    g = jnp.take(vals, jnp.clip(idx, 0, vals.shape[0] - 1), axis=0)
    return g * (idx >= 0)


@functools.partial(jax.jit, static_argnames=("sweeps",))
def _ilu0_single(s: DeviceIluSchedule, a_vals: jax.Array, pivot_eps: jax.Array,
                 sweeps: int = 5):
    dt = a_vals.dtype

    def pivot_fix(vals):
        d = jnp.take(vals, jnp.clip(s.diag_pos, 0, s.nnz - 1))
        bad = (jnp.abs(d) <= pivot_eps.astype(dt)) & (s.diag_pos >= 0)
        fixed = jnp.where(d < 0, -1.0, 1.0) * pivot_eps.astype(dt)
        # out-of-bounds sentinel for rows without a (bad) diagonal; dropped
        idx = jnp.where(bad, s.diag_pos, s.nnz)
        vals = vals.at[idx].set(fixed, mode="drop")
        return vals, jnp.sum(bad)

    def sweep(vals):
        la = _mask_gather(vals, s.pairs_a)
        ub = _mask_gather(vals, s.pairs_b)
        acc = jnp.sum(la * ub, axis=1)
        snew = a_vals - acc
        dj = jnp.take(vals, jnp.clip(s.diag_pos_col, 0, s.nnz - 1))
        dj = jnp.where(s.diag_pos_col >= 0, dj, jnp.ones_like(dj))
        dj = jnp.where(dj == 0, jnp.full_like(dj, 1.0), dj)
        return jnp.where(s.is_lower, snew / dj, snew)

    vals = a_vals
    vals, nbad0 = pivot_fix(vals)
    vals = jax.lax.fori_loop(0, sweeps, lambda _, v: pivot_fix(sweep(v))[0], vals)
    final = sweep(vals)
    resid = jnp.max(jnp.abs(final - vals)) / (jnp.max(jnp.abs(a_vals)) + 1e-30)
    return Ilu0Result(final, nbad0.astype(jnp.int32), resid.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("sweeps",))
def _ilu0_df(s: DeviceIluSchedule, a_vals: DF, pivot_eps: jax.Array,
             sweeps: int = 5):
    def gather(v: DF, idx):
        m = (idx >= 0)
        cid = jnp.clip(idx, 0, s.nnz - 1)
        return DF(jnp.take(v.hi, cid, axis=0) * m, jnp.take(v.lo, cid, axis=0) * m)

    def sweep(vals: DF) -> DF:
        la = gather(vals, s.pairs_a)
        ub = gather(vals, s.pairs_b)
        acc = prec.df_sum(prec.df_mul(la, ub), axis=1)
        snew = prec.df_sub(a_vals, acc)
        cid = jnp.clip(s.diag_pos_col, 0, s.nnz - 1)
        dj = DF(jnp.take(vals.hi, cid), jnp.take(vals.lo, cid))
        good = (s.diag_pos_col >= 0) & (dj.hi != 0)
        dj = DF(jnp.where(good, dj.hi, 1.0), jnp.where(good, dj.lo, 0.0))
        q = prec.df_div(snew, dj)
        return DF(jnp.where(s.is_lower, q.hi, snew.hi),
                  jnp.where(s.is_lower, q.lo, snew.lo))

    def pivot_fix(vals: DF):
        d = jnp.take(vals.hi, jnp.clip(s.diag_pos, 0, s.nnz - 1))
        bad = (jnp.abs(d) <= pivot_eps) & (s.diag_pos >= 0)
        idx = jnp.where(bad, s.diag_pos, s.nnz)  # out-of-bounds pads dropped
        hi = vals.hi.at[idx].set(jnp.where(d < 0, -pivot_eps, pivot_eps), mode="drop")
        lo = vals.lo.at[idx].set(0.0, mode="drop")
        return DF(hi, lo), jnp.sum(bad)

    vals = a_vals
    vals, nbad0 = pivot_fix(vals)
    vals = jax.lax.fori_loop(0, sweeps, lambda _, v: pivot_fix(sweep(v))[0], vals)
    final = sweep(vals)
    resid = jnp.max(jnp.abs(final.hi - vals.hi)) / (jnp.max(jnp.abs(a_vals.hi)) + 1e-30)
    return Ilu0Result(final, nbad0.astype(jnp.int32), resid.astype(jnp.float32))


def ilu0_factor(a: CSRMatrix, sched: Optional[IluSchedule] = None,
                policy: Union[str, Policy] = "fp32", sweeps: int = 8,
                pivot_eps: Optional[float] = None,
                values: Optional[np.ndarray] = None) -> Tuple[Ilu0Result, IluSchedule]:
    """Factor A ~= L*U on A's own pattern (values in-place layout, like csrilu02).

    Returns the factor values on A's CSR pattern (L strict-lower with unit
    diagonal implied; U upper including diagonal) plus breakdown diagnostics.
    """
    policy = get_policy(policy)
    if sched is None:
        sched = chow_patel_schedule(a)
    dev = ilu_schedule_to_device(sched, policy)
    data = a.data if values is None else np.asarray(values, np.float64)
    if pivot_eps is None:
        # PARDISO defaults: 1e-4 single, 1e-13 double (test_pardiso.c:144-148)
        eps_rel = 1e-13 if policy.double_word else 1e-4
        pivot_eps = eps_rel * float(np.abs(data).max() if data.size else 1.0)
    if policy.double_word:
        av = prec.df_from_f64(data)
        res = _ilu0_df(dev, av, jnp.float32(pivot_eps), sweeps=sweeps)
    else:
        av = policy.cast_values(data)
        res = _ilu0_single(dev, av, jnp.asarray(pivot_eps, av.dtype), sweeps=sweeps)
    return res, sched


def ilu0_converged(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                   sweeps: int = 8):
    """ILU(0) on A's pattern: ``sweeps`` Chow-Patel sweeps, or the exact
    level-scheduled factorization (kernels/splu.py) when the sweeps have not
    reached the fixed point. They can grow transiently before settling: the
    residual was 4e7 after 8 sweeps on a 25k-row FEM stand-in, where 16
    sweeps reach 3e-4. Returns (result, Chow-Patel residual)."""
    res, _ = ilu0_factor(a, policy=policy, sweeps=sweeps)
    cp = float(res.residual)
    if cp <= CP_CONVERGED:
        return res, cp
    from .splu import scheduled_lu_factor
    return scheduled_lu_factor(a, policy=policy)[0], cp


def ilu0_host_reference(a: CSRMatrix) -> np.ndarray:
    """Host fp64 oracle: standard IKJ in-place ILU(0) (same layout as device)."""
    n = a.nrows
    indptr, indices = a.indptr, a.indices
    vals = a.data.astype(np.float64).copy()
    # position lookup per row
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        row_cols = indices[s:e]
        for ki, k in enumerate(row_cols):
            if k >= i:
                break
            ks, ke = indptr[k], indptr[k + 1]
            kcols = indices[ks:ke]
            dpos = np.searchsorted(kcols, k)
            if dpos >= kcols.size or kcols[dpos] != k or vals[ks + dpos] == 0:
                continue
            lik = vals[s + ki] / vals[ks + dpos]
            vals[s + ki] = lik
            # update a_ij for j > k in row i where u_kj exists
            upper = kcols > k
            for jp, j in zip(np.flatnonzero(upper), kcols[upper]):
                pos = np.searchsorted(row_cols, j)
                if pos < row_cols.size and row_cols[pos] == j:
                    vals[s + pos] -= lik * vals[ks + jp]
    return vals
