"""Dense double-float (emulated fp64) linear algebra building blocks.

Used by the banded LU factorization's df64 path. A matrix unit's fp32
accumulation rounds, so it cannot form error-free products; df64 dense
kernels run as vectorized elementwise error-free transforms with
loop-carried accumulation: a P x P df64 matmul is P rank-1 df updates. This
is ~30x the flops of fp32, the cost of emulating fp64 with fp32 words.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import precision as prec
from ..precision import DF

__all__ = ["df_matmul", "df_lu_unpivoted", "df_tri_solve_lower",
           "df_tri_solve_right_upper", "lu_unpivoted"]


def df_matmul(a: DF, b: DF) -> DF:
    """C = A @ B in df64; A: [m, k], B: [k, n] via loop of rank-1 updates."""
    m, k = a.hi.shape
    _, n = b.hi.shape

    def body(i, acc: DF) -> DF:
        col = DF(jax.lax.dynamic_slice(a.hi, (0, i), (m, 1)),
                 jax.lax.dynamic_slice(a.lo, (0, i), (m, 1)))
        row = DF(jax.lax.dynamic_slice(b.hi, (i, 0), (1, n)),
                 jax.lax.dynamic_slice(b.lo, (i, 0), (1, n)))
        outer = prec.df_mul(DF(jnp.broadcast_to(col.hi, (m, n)),
                               jnp.broadcast_to(col.lo, (m, n))),
                            DF(jnp.broadcast_to(row.hi, (m, n)),
                               jnp.broadcast_to(row.lo, (m, n))))
        return prec.df_add(acc, outer)

    z = DF(jnp.zeros((m, n), jnp.float32), jnp.zeros((m, n), jnp.float32))
    return jax.lax.fori_loop(0, k, body, z)


def lu_unpivoted(d: jax.Array, eps: jax.Array):
    """In-place unpivoted dense LU of a single-word P x P block.

    Returns (lu, n_perturbed): unit-lower L below diagonal, U on/above.
    |pivot| <= eps is replaced by sign(pivot)*eps (PARDISO-style static
    perturbation, test_pardiso.c:144-148).
    """
    p = d.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (p, 1), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)

    def body(j, carry):
        m, nbad = carry
        piv = m[j, j]
        bad = jnp.abs(piv) <= eps
        piv = jnp.where(bad, jnp.where(piv < 0, -eps, eps), piv)
        m = m.at[j, j].set(piv)
        below = (rows > j)
        lcol = jnp.where(below[:, 0], m[:, j] / piv, 0.0)
        right = (cols > j)
        urow = jnp.where(right[0, :], m[j, :], 0.0)
        m = m - jnp.outer(lcol, urow)
        m = m.at[:, j].set(jnp.where(below[:, 0], lcol, m[:, j]))
        return m, nbad + bad.astype(jnp.int32)

    return jax.lax.fori_loop(0, p, body, (d, jnp.int32(0)))


def df_lu_unpivoted(d: DF, eps: jax.Array):
    """Unpivoted dense LU of a df64 P x P block (elementwise, loop over pivots)."""
    p = d.hi.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (p, 1), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)

    def body(j, carry):
        m, nbad = carry
        pivh = m.hi[j, j]
        pivl = m.lo[j, j]
        bad = jnp.abs(pivh) <= eps
        pivh = jnp.where(bad, jnp.where(pivh < 0, -eps, eps), pivh)
        pivl = jnp.where(bad, 0.0, pivl)
        m = DF(m.hi.at[j, j].set(pivh), m.lo.at[j, j].set(pivl))
        below = (rows > j)[:, 0]
        colj = DF(m.hi[:, j], m.lo[:, j])
        piv = DF(jnp.broadcast_to(pivh, (p,)), jnp.broadcast_to(pivl, (p,)))
        l = prec.df_div(colj, piv)
        l = DF(jnp.where(below, l.hi, 0.0), jnp.where(below, l.lo, 0.0))
        right = (cols > j)[0, :]
        u = DF(jnp.where(right, m.hi[j, :], 0.0), jnp.where(right, m.lo[j, :], 0.0))
        outer = prec.df_mul(DF(jnp.broadcast_to(l.hi[:, None], (p, p)),
                               jnp.broadcast_to(l.lo[:, None], (p, p))),
                            DF(jnp.broadcast_to(u.hi[None, :], (p, p)),
                               jnp.broadcast_to(u.lo[None, :], (p, p))))
        m = prec.df_sub(m, outer)
        m = DF(m.hi.at[:, j].set(jnp.where(below, l.hi, m.hi[:, j])),
               m.lo.at[:, j].set(jnp.where(below, l.lo, m.lo[:, j])))
        return m, nbad + bad.astype(jnp.int32)

    return jax.lax.fori_loop(0, p, body, (d, jnp.int32(0)))


def df_tri_solve_lower(l: DF, b: DF, unit_diag: bool = True) -> DF:
    """Solve L X = B with L lower-triangular df64, X/B: [p, n] (forward subst)."""
    p, n = b.hi.shape

    def body(i, x: DF) -> DF:
        # acc = sum_k<i L[i,k] X[k,:]
        lrow = DF(l.hi[i, :], l.lo[i, :])
        mask = (jax.lax.broadcasted_iota(jnp.int32, (p,), 0) < i)
        lrow = DF(jnp.where(mask, lrow.hi, 0.0), jnp.where(mask, lrow.lo, 0.0))
        prod = prec.df_mul(DF(jnp.broadcast_to(lrow.hi[:, None], (p, n)),
                              jnp.broadcast_to(lrow.lo[:, None], (p, n))), x)
        acc = prec.df_sum(prod, axis=0)
        bi = DF(b.hi[i, :], b.lo[i, :])
        xi = prec.df_sub(bi, acc)
        if not unit_diag:
            d = DF(jnp.broadcast_to(l.hi[i, i], (n,)),
                   jnp.broadcast_to(l.lo[i, i], (n,)))
            xi = prec.df_div(xi, d)
        return DF(x.hi.at[i, :].set(xi.hi), x.lo.at[i, :].set(xi.lo))

    x0 = DF(jnp.zeros_like(b.hi), jnp.zeros_like(b.lo))
    return jax.lax.fori_loop(0, p, body, x0)


def df_tri_solve_right_upper(b: DF, u: DF) -> DF:
    """Solve X U = B with U upper-triangular (non-unit) df64, X/B: [m, p].

    Column-forward substitution: X[:, j] = (B[:, j] - X[:, :j] U[:j, j]) / U[j, j].
    """
    m, p = b.hi.shape

    def body(j, x: DF) -> DF:
        ucol = DF(u.hi[:, j], u.lo[:, j])
        mask = (jax.lax.broadcasted_iota(jnp.int32, (p,), 0) < j)
        ucol = DF(jnp.where(mask, ucol.hi, 0.0), jnp.where(mask, ucol.lo, 0.0))
        prod = prec.df_mul(x, DF(jnp.broadcast_to(ucol.hi[None, :], (m, p)),
                                 jnp.broadcast_to(ucol.lo[None, :], (m, p))))
        acc = prec.df_sum(prod, axis=1)
        bj = DF(b.hi[:, j], b.lo[:, j])
        d = DF(jnp.broadcast_to(u.hi[j, j], (m,)),
               jnp.broadcast_to(u.lo[j, j], (m,)))
        xj = prec.df_div(prec.df_sub(bj, acc), d)
        return DF(x.hi.at[:, j].set(xj.hi), x.lo.at[:, j].set(xj.lo))

    x0 = DF(jnp.zeros_like(b.hi), jnp.zeros_like(b.lo))
    return jax.lax.fori_loop(0, p, body, x0)
