"""Blocked banded LU factorization and solve on the device (direct solver path).

This is our replacement for the sparse LU backends (PARDISO phases 22/33,
test_pardiso.c:204-244; SuperLU_MT pdgssv, test_superLU_MT.c:168-172): after a
bandwidth-reducing RCM ordering the matrix is stored as a *block-aligned dense
band*, and the factorization becomes a sequence of dense P x P block
operations — dense matrix products, which the device's matrix units run at
their highest rate. Fill-in of an unpivoted band
LU stays inside the band, so shapes are static and no symbolic factorization
is needed.

Layout: ``band[r, p, w]`` holds A[r*P + p, (r - ml)*P + w] for a block row r,
with ml/mu = lower/upper block bandwidths and W = (ml + mu + 1)*P. Padded
rows (beyond n) carry an identity diagonal.

Factorization (scan over block rows; right-looking):

    D            = band[r][:, ml*P:(ml+1)*P]         # diagonal block
    L_D, U_D     = unpivoted dense LU of D (static pivot perturbation)
    Y            = L_D^-1 @ band[r][:, (ml+1)P:]     # U block-row, one TRSM
    for d = 1..ml:                                   # L block-column + update
        X_d      = band[r+d][:, (ml-d)P:(ml-d+1)P] @ U_D^-1     # TRSM
        band[r+d][:, (ml-d+1)P : (ml-d+1+mu)P] -= X_d @ Y       # GEMM

No pivoting: like PARDISO's default, tiny pivots are perturbed
(test_pardiso.c:144-148) and accuracy is recovered by mixed-precision
iterative refinement (solve.py), which is the subject of the reference study.

Precisions: fp32/bf16 single-word (GEMMs), df64 double-float (elementwise
error-free transforms, kernels/dflinalg.py) for the emulated-fp64 reference
path.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import precision as prec
from ..formats import CSRMatrix
from ..precision import DF, Policy, get_policy
from . import dflinalg

__all__ = ["BandMatrix", "csr_to_band", "band_memory_bytes", "DeviceBand",
           "band_to_device", "band_lu", "band_solve", "BandLuResult"]

_TRI = jax.lax.linalg.triangular_solve


@dataclasses.dataclass
class BandMatrix:
    """Host block-aligned band storage."""

    n: int
    p: int  # block size
    ml: int  # lower block bandwidth
    mu: int  # upper block bandwidth
    data: np.ndarray  # float64[nb, p, (ml+mu+1)*p]

    @property
    def nb(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[2]


def band_memory_bytes(n: int, bl: int, bu: int, p: int = 128,
                      double_word: bool = False) -> int:
    ml = max(1, -(-bl // p))
    mu = max(1, -(-bu // p))
    nb = -(-n // p)
    return nb * p * (ml + mu + 1) * p * 4 * (2 if double_word else 1)


def csr_to_band(a: CSRMatrix, p: int = 128) -> BandMatrix:
    """Pack CSR into block-aligned band storage (host)."""
    n = a.nrows
    assert a.shape[0] == a.shape[1], "band LU requires square matrix"
    rows = np.repeat(np.arange(n, dtype=np.int64), a.row_lengths())
    cols = a.indices.astype(np.int64)
    diff = cols - rows
    bl = int(max(0, -diff.min())) if diff.size else 0
    bu = int(max(0, diff.max())) if diff.size else 0
    ml = max(1, -(-bl // p))
    mu = max(1, -(-bu // p))
    nb = -(-n // p)
    w = (ml + mu + 1) * p
    data = np.zeros((nb, p, w), dtype=np.float64)
    r = rows // p
    pr = rows % p
    wc = cols - (r - ml) * p
    data[r, pr, wc] = a.data
    # identity padding rows
    for i in range(n, nb * p):
        data[i // p, i % p, ml * p + i % p] = 1.0
    return BandMatrix(n=n, p=p, ml=ml, mu=mu, data=data)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceBand:
    n: int
    p: int
    ml: int
    mu: int
    policy_name: str
    data: Tuple[jax.Array, ...]  # (band,) or (hi, lo)

    def tree_flatten(self):
        return ((self.data,), (self.n, self.p, self.ml, self.mu, self.policy_name))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*aux, *children)

    @property
    def policy(self) -> Policy:
        return get_policy(self.policy_name)

    @property
    def nb(self) -> int:
        return self.data[0].shape[0]


def band_to_device(b: BandMatrix, policy: Union[str, Policy] = "fp32") -> DeviceBand:
    policy = get_policy(policy)
    if policy.double_word:
        arrs = prec.df_from_f64_host(b.data)
    else:
        arrs = policy.cast_host(b.data)
    return DeviceBand(n=b.n, p=b.p, ml=b.ml, mu=b.mu, policy_name=policy.name,
                      data=tuple(jnp.asarray(x) for x in arrs))


class BandLuResult(NamedTuple):
    lu: object  # DeviceBand with factor values
    n_pivot_perturbed: jax.Array


def _mm(a, b):
    return jnp.dot(a, b, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def _lu_core(bdata: jax.Array, p: int, ml: int, mu: int,
             eps: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Right-looking blocked band LU on raw band storage [nb, p, w].

    Pure function (shapes static) so it can run standalone under jit or as
    the per-shard factorization inside a ``shard_map`` (dist_lu.py SPIKE)."""
    nb = bdata.shape[0]
    w = (ml + mu + 1) * p
    dt = bdata.dtype

    def step(carry, r):
        b, nbad = carry
        row = jax.lax.dynamic_slice(b, (r, 0, 0), (1, p, w))[0]
        d = row[:, ml * p:(ml + 1) * p].astype(jnp.float32)
        lu_d, bad = dflinalg.lu_unpivoted(d, eps)
        t = row[:, (ml + 1) * p:].astype(jnp.float32)
        y = _TRI(lu_d, t, left_side=True, lower=True, unit_diagonal=True)
        row = jax.lax.dynamic_update_slice(row, lu_d.astype(dt), (0, ml * p))
        row = jax.lax.dynamic_update_slice(row, y.astype(dt), (0, (ml + 1) * p))
        b = jax.lax.dynamic_update_slice(b, row[None], (r, 0, 0))

        def dstep(d_, b_):
            rr = jnp.clip(r + d_, 0, nb - 1)
            valid = (r + d_ < nb).astype(jnp.float32)
            srow = jax.lax.dynamic_slice(b_, (rr, 0, 0), (1, p, w))[0]
            off = (ml - d_) * p
            s = jax.lax.dynamic_slice(srow, (0, off), (p, p)).astype(jnp.float32)
            x = _TRI(lu_d, s, left_side=False, lower=False, unit_diagonal=False)
            c = jax.lax.dynamic_slice(srow, (0, off + p), (p, mu * p)).astype(jnp.float32)
            c = c - _mm(x, y)
            x = valid * x + (1 - valid) * s
            cold = jax.lax.dynamic_slice(srow, (0, off + p), (p, mu * p)).astype(jnp.float32)
            c = valid * c + (1 - valid) * cold
            srow = jax.lax.dynamic_update_slice(srow, x.astype(dt), (0, off))
            srow = jax.lax.dynamic_update_slice(srow, c.astype(dt), (0, off + p))
            return jax.lax.dynamic_update_slice(b_, srow[None], (rr, 0, 0))

        b = jax.lax.fori_loop(1, ml + 1, dstep, b)
        return (b, nbad + bad), None

    (bout, nbad), _ = jax.lax.scan(step, (bdata, jnp.int32(0)),
                                   jnp.arange(nb))
    return bout, nbad


@jax.jit
def _band_lu_single(band: DeviceBand, eps: jax.Array) -> Tuple[jax.Array, jax.Array]:
    return _lu_core(band.data[0], band.p, band.ml, band.mu, eps)


@functools.partial(jax.jit, static_argnames=("use_ozaki",))
def _band_lu_df(band: DeviceBand, eps: jax.Array,
                use_ozaki: bool = False) -> Tuple[Tuple[jax.Array, jax.Array], jax.Array]:
    # use_ozaki runs the trailing GEMMs as exact bf16 matrix products
    # (kernels/ozaki.py); it compiles far longer than the elementwise
    # double-float loop, so it stays opt-in.
    from .ozaki import ozaki_matmul
    p, ml, mu = band.p, band.ml, band.mu
    nb = band.nb
    w = (ml + mu + 1) * p

    def rd(bh, bl_, r, c0, rows, cols):
        return DF(jax.lax.dynamic_slice(bh, (r, 0, c0), (1, rows, cols))[0],
                  jax.lax.dynamic_slice(bl_, (r, 0, c0), (1, rows, cols))[0])

    def wr(bh, bl_, v: DF, r, c0):
        bh = jax.lax.dynamic_update_slice(bh, v.hi[None], (r, 0, c0))
        bl_ = jax.lax.dynamic_update_slice(bl_, v.lo[None], (r, 0, c0))
        return bh, bl_

    def step(carry, r):
        bh, bl_, nbad = carry
        d = rd(bh, bl_, r, ml * p, p, p)
        lu_d, bad = dflinalg.df_lu_unpivoted(d, eps)
        t = rd(bh, bl_, r, (ml + 1) * p, p, mu * p)
        y = dflinalg.df_tri_solve_lower(lu_d, t, unit_diag=True)
        bh, bl_ = wr(bh, bl_, lu_d, r, ml * p)
        bh, bl_ = wr(bh, bl_, y, r, (ml + 1) * p)

        def dstep(d_, bb):
            bh_, bl2 = bb
            rr = jnp.clip(r + d_, 0, nb - 1)
            valid = (r + d_ < nb).astype(jnp.float32)
            off = (ml - d_) * p
            s = rd(bh_, bl2, rr, 0, p, w)  # full row
            sblk = DF(jax.lax.dynamic_slice(s.hi, (0, off), (p, p)),
                      jax.lax.dynamic_slice(s.lo, (0, off), (p, p)))
            x = dflinalg.df_tri_solve_right_upper(sblk, lu_d)
            cblk = DF(jax.lax.dynamic_slice(s.hi, (0, off + p), (p, mu * p)),
                      jax.lax.dynamic_slice(s.lo, (0, off + p), (p, mu * p)))
            if use_ozaki:
                # trailing GEMM as exact bf16 matrix products (Ozaki
                # slicing); the TRSMs above stay elementwise double-float
                xy = ozaki_matmul(x, y)
            else:
                xy = dflinalg.df_matmul(x, y)
            c = prec.df_sub(cblk, xy)
            x = DF(valid * x.hi + (1 - valid) * sblk.hi,
                   valid * x.lo + (1 - valid) * sblk.lo)
            c = DF(valid * c.hi + (1 - valid) * cblk.hi,
                   valid * c.lo + (1 - valid) * cblk.lo)
            shi = jax.lax.dynamic_update_slice(s.hi, x.hi, (0, off))
            slo = jax.lax.dynamic_update_slice(s.lo, x.lo, (0, off))
            shi = jax.lax.dynamic_update_slice(shi, c.hi, (0, off + p))
            slo = jax.lax.dynamic_update_slice(slo, c.lo, (0, off + p))
            bh_ = jax.lax.dynamic_update_slice(bh_, shi[None], (rr, 0, 0))
            bl2 = jax.lax.dynamic_update_slice(bl2, slo[None], (rr, 0, 0))
            return bh_, bl2

        bh, bl_ = jax.lax.fori_loop(1, ml + 1, dstep, (bh, bl_))
        return (bh, bl_, nbad + bad), None

    (bh, bl_, nbad), _ = jax.lax.scan(
        step, (band.data[0], band.data[1], jnp.int32(0)), jnp.arange(nb))
    return (bh, bl_), nbad


def band_lu(band: DeviceBand, pivot_eps: Optional[float] = None,
            use_ozaki: bool = False) -> BandLuResult:
    """Factor the band in place; returns factor band (L unit-lower in-band)."""
    policy = band.policy
    if pivot_eps is None:
        amax = float(jnp.max(jnp.abs(band.data[0])))
        eps_rel = 1e-13 if policy.double_word else 1e-4
        pivot_eps = eps_rel * max(amax, 1.0)
    eps = jnp.float32(pivot_eps)
    if policy.double_word:
        (bh, bl_), nbad = _band_lu_df(band, eps, use_ozaki=use_ozaki)
        out = DeviceBand(band.n, band.p, band.ml, band.mu, band.policy_name, (bh, bl_))
    else:
        bout, nbad = _band_lu_single(band, eps)
        out = DeviceBand(band.n, band.p, band.ml, band.mu, band.policy_name, (bout,))
    return BandLuResult(out, nbad)


def _solve_core(band: jax.Array, bp: jax.Array, p: int, ml: int,
                mu: int) -> jax.Array:
    """Block forward+backward substitution on raw factor storage.

    ``band``: factored [nb, p, w]; ``bp``: padded RHS [nb, p, nrhs].
    Pure/static so it serves both the single-chip solve and the per-shard
    solves of the distributed SPIKE path (dist_lu.py)."""
    nb = band.shape[0]
    nrhs = bp.shape[2]

    # forward: L y = b  (block forward substitution)
    def fstep(y, r):
        row = jax.lax.dynamic_slice(band, (r, 0, 0), (1, p, (ml + mu + 1) * p))[0]
        acc = bp[r]

        def dacc(d_, a_):
            rr = jnp.clip(r - d_, 0, nb - 1)
            valid = (r - d_ >= 0).astype(jnp.float32)
            lblk = jax.lax.dynamic_slice(row, (0, (ml - d_) * p), (p, p)).astype(jnp.float32)
            yprev = jax.lax.dynamic_slice(y, (rr, 0, 0), (1, p, nrhs))[0]
            return a_ - valid * _mm(lblk, yprev)

        acc = jax.lax.fori_loop(1, ml + 1, dacc, acc)
        d = row[:, ml * p:(ml + 1) * p].astype(jnp.float32)
        yr = _TRI(d, acc, left_side=True, lower=True, unit_diagonal=True)
        y = jax.lax.dynamic_update_slice(y, yr[None], (r, 0, 0))
        return y, None

    y, _ = jax.lax.scan(fstep, jnp.zeros((nb, p, nrhs), jnp.float32),
                        jnp.arange(nb))

    # backward: U x = y
    def bstep(x, r):
        row = jax.lax.dynamic_slice(band, (r, 0, 0), (1, p, (ml + mu + 1) * p))[0]
        acc = jax.lax.dynamic_slice(y, (r, 0, 0), (1, p, nrhs))[0]

        def eacc(e_, a_):
            rr = jnp.clip(r + e_, 0, nb - 1)
            valid = (r + e_ < nb).astype(jnp.float32)
            ublk = jax.lax.dynamic_slice(row, (0, (ml + e_) * p), (p, p)).astype(jnp.float32)
            xnext = jax.lax.dynamic_slice(x, (rr, 0, 0), (1, p, nrhs))[0]
            return a_ - valid * _mm(ublk, xnext)

        acc = jax.lax.fori_loop(1, mu + 1, eacc, acc)
        d = row[:, ml * p:(ml + 1) * p].astype(jnp.float32)
        xr = _TRI(d, acc, left_side=True, lower=False, unit_diagonal=False)
        x = jax.lax.dynamic_update_slice(x, xr[None], (r, 0, 0))
        return x, None

    x, _ = jax.lax.scan(bstep, jnp.zeros((nb, p, nrhs), jnp.float32),
                        jnp.arange(nb - 1, -1, -1))
    return x


@jax.jit
def _band_solve_single(lu: DeviceBand, b: jax.Array) -> jax.Array:
    """Solve for one RHS (n,) or many (n, nrhs): block substitution; the
    per-block ops become (P,P)@(P,nrhs) GEMMs — efficient for nrhs > 1."""
    p = lu.p
    nb = lu.nb
    npad = nb * p
    single = b.ndim == 1
    b2 = b[:, None] if single else b
    nrhs = b2.shape[1]
    bp = jnp.zeros((npad, nrhs), jnp.float32).at[:lu.n].set(b2.astype(jnp.float32))
    x = _solve_core(lu.data[0], bp.reshape(nb, p, nrhs), p, lu.ml, lu.mu)
    out = x.reshape(npad, nrhs)[:lu.n]
    return out[:, 0] if single else out


@jax.jit
def _band_solve_df(lu: DeviceBand, b: DF) -> DF:
    p, ml, mu = lu.p, lu.ml, lu.mu
    nb = lu.nb
    bh, bl_ = lu.data
    npad = nb * p
    bph = jnp.zeros(npad, jnp.float32).at[:lu.n].set(b.hi).reshape(nb, p)
    bpl = jnp.zeros(npad, jnp.float32).at[:lu.n].set(b.lo).reshape(nb, p)

    def rd_blk(r, c0):
        return DF(jax.lax.dynamic_slice(bh, (r, 0, c0), (1, p, p))[0],
                  jax.lax.dynamic_slice(bl_, (r, 0, c0), (1, p, p))[0])

    def fstep(carry, r):
        yh, yl = carry
        acc = DF(jax.lax.dynamic_slice(bph, (r, 0), (1, p))[0],
                 jax.lax.dynamic_slice(bpl, (r, 0), (1, p))[0])

        def dacc(d_, a_):
            ah, al = a_
            rr = jnp.clip(r - d_, 0, nb - 1)
            valid = (r - d_ >= 0).astype(jnp.float32)
            lblk = rd_blk(r, (ml - d_) * p)
            yprev = DF(jax.lax.dynamic_slice(yh, (rr, 0), (1, p))[0][:, None],
                       jax.lax.dynamic_slice(yl, (rr, 0), (1, p))[0][:, None])
            m = dflinalg.df_matmul(lblk, yprev)
            r_ = prec.df_sub(DF(ah, al), DF(valid * m.hi[:, 0], valid * m.lo[:, 0]))
            return (r_.hi, r_.lo)

        acc = DF(*jax.lax.fori_loop(1, ml + 1, dacc, (acc.hi, acc.lo)))
        d = rd_blk(r, ml * p)
        yr = dflinalg.df_tri_solve_lower(d, DF(acc.hi[:, None], acc.lo[:, None]),
                                         unit_diag=True)
        yh = jax.lax.dynamic_update_slice(yh, yr.hi[:, 0][None], (r, 0))
        yl = jax.lax.dynamic_update_slice(yl, yr.lo[:, 0][None], (r, 0))
        return (yh, yl), None

    (yh, yl), _ = jax.lax.scan(fstep, (jnp.zeros((nb, p), jnp.float32),
                                       jnp.zeros((nb, p), jnp.float32)),
                               jnp.arange(nb))

    def bstep(carry, r):
        xh, xl = carry
        acc = DF(jax.lax.dynamic_slice(yh, (r, 0), (1, p))[0],
                 jax.lax.dynamic_slice(yl, (r, 0), (1, p))[0])

        def eacc(e_, a_):
            ah, al = a_
            rr = jnp.clip(r + e_, 0, nb - 1)
            valid = (r + e_ < nb).astype(jnp.float32)
            ublk = rd_blk(r, (ml + e_) * p)
            xnext = DF(jax.lax.dynamic_slice(xh, (rr, 0), (1, p))[0][:, None],
                       jax.lax.dynamic_slice(xl, (rr, 0), (1, p))[0][:, None])
            m = dflinalg.df_matmul(ublk, xnext)
            r_ = prec.df_sub(DF(ah, al), DF(valid * m.hi[:, 0], valid * m.lo[:, 0]))
            return (r_.hi, r_.lo)

        acc = DF(*jax.lax.fori_loop(1, mu + 1, eacc, (acc.hi, acc.lo)))
        d = rd_blk(r, ml * p)
        # upper solve via flip -> lower solve (non-unit)
        dflip = DF(d.hi[::-1, ::-1], d.lo[::-1, ::-1])
        bflip = DF(acc.hi[::-1][:, None], acc.lo[::-1][:, None])
        xr = dflinalg.df_tri_solve_lower(dflip, bflip, unit_diag=False)
        xr = DF(xr.hi[::-1, 0], xr.lo[::-1, 0])
        xh = jax.lax.dynamic_update_slice(xh, xr.hi[None], (r, 0))
        xl = jax.lax.dynamic_update_slice(xl, xr.lo[None], (r, 0))
        return (xh, xl), None

    (xh, xl), _ = jax.lax.scan(bstep, (jnp.zeros((nb, p), jnp.float32),
                                       jnp.zeros((nb, p), jnp.float32)),
                               jnp.arange(nb - 1, -1, -1))
    return DF(xh.reshape(npad)[:lu.n], xl.reshape(npad)[:lu.n])


def band_solve(lu: DeviceBand, b):
    """Solve A x = b given the factored band (forward + backward block subst)."""
    if lu.policy.double_word:
        if not isinstance(b, DF):
            b = prec._as_df(jnp.asarray(b))
        return _band_solve_df(lu, b)
    return _band_solve_single(lu, jnp.asarray(b))
