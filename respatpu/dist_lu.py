"""Distributed direct band LU over a device mesh — the SPIKE algorithm.

This fills the reference's MUMPS slot (job=4 analyze+factorize at
test_mumps.c:121-128, job=3 solve at test_mumps.c:136-143): a *direct*
distributed sparse solver. The reference delegates to MUMPS's multifrontal
factorization over MPI/ScaLAPACK; a device-mesh design wants bulk dense
GEMM work per device with few, small, statically-shaped collectives — which is exactly
the SPIKE partitioned-band algorithm (Polizzi & Sameh), not a translated
block-cyclic ScaLAPACK loop:

  1. RCM ordering (analysis.rcm_ordering) makes A banded; the band is packed
     into block-aligned storage (kernels/bandlu.csr_to_band) and split into
     ``ndev`` contiguous block-row partitions — one per mesh device.
  2. Cross-partition entries are carved out of each local band into small
     dense coupling blocks: ``B_j`` (mu·p × mu·p, couples partition j to the
     first rows of j+1) and ``C_j`` (ml·p × ml·p, couples to the last rows of
     j-1). Each device then owns an *independent* diagonal band block A_j.
  3. Factor phase (perfectly parallel, zero communication in the LU itself):
     every device runs the blocked band LU scan (kernels/bandlu._lu_core) on
     its own A_j, then computes the SPIKE tips — the top/bottom (ml+mu)·p
     rows of V_j = A_j⁻¹[0;B_j] and W_j = A_j⁻¹[C_j;0] via the multi-RHS
     block-substitution solve (GEMMs). One ``all_gather`` of the tips
     builds the *reduced system* R (block tridiagonal, order
     ndev·(ml+mu)·p), which is LU-factored once, replicated.
  4. Solve phase: g_j = A_j⁻¹ b_j locally; ``all_gather`` the (ml+mu)·p tip
     entries of g; solve the reduced system replicated (small dense
     lu_solve); each device slices its interface unknowns u_{j+1}, d_{j-1}
     and back-substitutes x_j = A_j⁻¹(b_j − [0;B_j u_{j+1}] − [C_j d_{j-1};0])
     — the memory-lean "on-the-fly" SPIKE variant (spikes are never stored,
     only their tips).

Accuracy follows the study's recipe: the fp32 distributed factorization is
wrapped in df64 iterative refinement (`solve_refined`), reaching
reference-fp64 residuals (PeerJ CS 8:e778 headline) without any fp64
hardware. Like the single-chip band path, tiny pivots are perturbed
(PARDISO-style, test_pardiso.c:144-148) and the count is psum'd across the
mesh into the report.

Communication cost per solve: one all_gather of (ml+mu)·p·nrhs floats per
device + a replicated dense solve of the reduced system — no other
traffic; the factorization itself is communication-free.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import precision as prec
from .analysis import permute_csr, rcm_ordering
from .dist import make_mesh
from .formats import CSRMatrix
from .kernels import bandlu
from .kernels.bandlu import _lu_core, _solve_core
from .precision import Policy, get_policy
from .solve import SolveReport, relative_residual

__all__ = ["DistBandLu", "dist_factorize_band", "dist_solve_refined"]


def _host_matvec(a: CSRMatrix, x: np.ndarray) -> np.ndarray:
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    y = np.zeros(a.nrows)
    np.add.at(y, rows, a.data * x[a.indices])
    return y


def _split_coupling(data: np.ndarray, ndev: int, nb_loc: int, p: int,
                    ml: int, mu: int):
    """Carve cross-partition band entries into dense coupling blocks.

    Returns (local_bands [ndev, nb_loc, p, w], B [ndev, mu*p, mu*p],
    C [ndev, ml*p, ml*p]); ``data`` is consumed (entries moved, not copied).
    """
    w = (ml + mu + 1) * p
    loc = data.reshape(ndev, nb_loc, p, w)
    B = np.zeros((ndev, mu * p, mu * p), dtype=data.dtype)
    C = np.zeros((ndev, ml * p, ml * p), dtype=data.dtype)
    for j in range(ndev):
        r0, r1 = j * nb_loc, (j + 1) * nb_loc
        # rows whose window can reach past the right partition edge
        for rl in range(max(0, nb_loc - mu), nb_loc):
            r = r0 + rl
            for t in range(ml + mu + 1):
                c = r - ml + t
                if c >= r1:
                    rr = rl - (nb_loc - mu)
                    B[j, rr * p:(rr + 1) * p, (c - r1) * p:(c - r1 + 1) * p] = \
                        loc[j, rl, :, t * p:(t + 1) * p]
                    loc[j, rl, :, t * p:(t + 1) * p] = 0.0
        # rows whose window reaches past the left partition edge
        for rl in range(min(ml, nb_loc)):
            r = r0 + rl
            for t in range(ml + mu + 1):
                c = r - ml + t
                if 0 <= c < r0:
                    cc = c - (r0 - ml)
                    C[j, rl * p:(rl + 1) * p, cc * p:(cc + 1) * p] = \
                        loc[j, rl, :, t * p:(t + 1) * p]
                    loc[j, rl, :, t * p:(t + 1) * p] = 0.0
    return loc, B, C


def _make_factor_fn(p: int, ml: int, mu: int, nb_loc: int, mesh: Mesh,
                    axis: str, eps: float):
    """Per-shard band LU + SPIKE tip computation (communication-free)."""
    eps_c = jnp.float32(eps)

    def kernel(lb, B, C):
        lu, nbad = _lu_core(lb[0], p, ml, mu, eps_c)
        # V = A_j^-1 [0; B_j]  (RHS nonzero only in the last mu block rows)
        ev = jnp.zeros((nb_loc, p, mu * p), jnp.float32)
        ev = jax.lax.dynamic_update_slice(
            ev, B[0].reshape(mu, p, mu * p), (nb_loc - mu, 0, 0))
        V = _solve_core(lu, ev, p, ml, mu).reshape(nb_loc * p, mu * p)
        # W = A_j^-1 [C_j; 0]
        ew = jnp.zeros((nb_loc, p, ml * p), jnp.float32)
        ew = jax.lax.dynamic_update_slice(
            ew, C[0].reshape(ml, p, ml * p), (0, 0, 0))
        W = _solve_core(lu, ew, p, ml, mu).reshape(nb_loc * p, ml * p)
        return (lu[None], V[:mu * p][None], V[-ml * p:][None],
                W[:mu * p][None], W[-ml * p:][None], nbad[None])

    spec = P(axis)
    return jax.jit(shard_map(kernel, mesh=mesh, in_specs=(spec,) * 3,
                             out_specs=(spec,) * 6, check_vma=False))


def _make_solve_fn(p: int, ml: int, mu: int, nb_loc: int, ndev: int,
                   mesh: Mesh, axis: str):
    """Local solve + tip gather + replicated reduced solve + back-substitute."""
    s0 = (ml + mu) * p

    def kernel(lu, B, C, rlu, rpiv, bp):
        lu1, bp1 = lu[0], bp[0]  # [nb_loc,p,w], [nb_loc,p,nrhs]
        nrhs = bp1.shape[2]
        g = _solve_core(lu1, bp1, p, ml, mu).reshape(nb_loc * p, nrhs)
        tips = jnp.concatenate([g[:mu * p], g[-ml * p:]], axis=0)  # [s0,nrhs]
        allt = jax.lax.all_gather(tips, axis)  # [ndev, s0, nrhs]
        y = jax.scipy.linalg.lu_solve((rlu, rpiv),
                                      allt.reshape(ndev * s0, nrhs))
        j = jax.lax.axis_index(axis)
        # u_{j+1} = top mu*p of partition j+1; d_{j-1} = bottom ml*p of j-1.
        # dynamic_slice clamps out-of-range starts; mask the invalid edges.
        u_next = jax.lax.dynamic_slice(y, ((j + 1) * s0, 0), (mu * p, nrhs))
        u_next = jnp.where(j < ndev - 1, u_next, 0.0)
        d_prev = jax.lax.dynamic_slice(y, ((j - 1) * s0 + mu * p, 0),
                                       (ml * p, nrhs))
        d_prev = jnp.where(j > 0, d_prev, 0.0)
        bu = jnp.dot(B[0], u_next, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
        cd = jnp.dot(C[0], d_prev, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
        bf = bp1.reshape(nb_loc * p, nrhs)
        bf = bf.at[-mu * p:].add(-bu).at[:ml * p].add(-cd)
        x = _solve_core(lu1, bf.reshape(nb_loc, p, nrhs), p, ml, mu)
        return x.reshape(1, nb_loc * p, nrhs)

    spec = P(axis)
    in_specs = (spec, spec, spec, P(), P(), spec)
    return jax.jit(shard_map(kernel, mesh=mesh, in_specs=in_specs,
                             out_specs=spec, check_vma=False))


class DistBandLu:
    """Distributed direct solver: RCM + partitioned band LU (SPIKE).

    The MUMPS-replacement pipeline with the same phase structure the
    reference times — analyze (host ordering/packing/partitioning),
    factorize (parallel device scans, job=4), solve (job=3) — reported in a
    `SolveReport` like the single-chip solvers.
    """

    def __init__(self, a: CSRMatrix, mesh: Optional[Mesh] = None,
                 axis: str = "row", policy: Union[str, Policy] = "fp32",
                 order: str = "rcm", p: int = 128,
                 pivot_eps: Optional[float] = None,
                 max_reduced: int = 16384,
                 max_band_bytes: int = 8 << 30):
        policy = get_policy(policy)
        if policy.double_word:
            raise NotImplementedError(
                "df64 distributed factorization: use policy='fp32' + "
                "dist_solve_refined (df64 residual refinement) for "
                "reference-fp64 accuracy")
        self.policy = policy
        self.a = a
        self.mesh = mesh = mesh or make_mesh()
        self.axis = axis
        ndev = int(mesh.devices.size)
        self.ndev = ndev
        self.report = SolveReport(policy=f"{policy.name}+spike{ndev}")

        t0 = time.perf_counter()
        if order == "rcm":
            self.perm = rcm_ordering(a)
        else:
            self.perm = np.arange(a.nrows, dtype=np.int32)
        ap = permute_csr(a, self.perm)
        band = bandlu.csr_to_band(ap, p=p)
        ml, mu = band.ml, band.mu
        need = band.data.nbytes // 2  # fp32 on device
        if need > max_band_bytes:
            raise MemoryError(
                f"band storage would need {need/2**30:.1f} GiB across the "
                f"mesh (bandwidth {ml*p}+{mu*p} after RCM)")
        # partition block rows; tips must not overlap: nb_loc >= ml+mu
        nb_loc = max(-(-band.nb // ndev), ml + mu)
        nb_pad = nb_loc * ndev
        s0 = (ml + mu) * p
        if ndev * s0 > max_reduced:
            raise MemoryError(
                f"reduced system order {ndev*s0} exceeds {max_reduced}; "
                "bandwidth too large for the dense reduced solve — "
                "use the iterative distributed stack (dist.py)")
        data = np.zeros((nb_pad, p, band.width), dtype=np.float64)
        data[:band.nb] = band.data
        for i in range(band.nb * p, nb_pad * p):  # identity padding rows
            data[i // p, i % p, ml * p + i % p] = 1.0
        loc, B, C = _split_coupling(data, ndev, nb_loc, p, ml, mu)
        self.n, self.p, self.ml, self.mu, self.nb_loc = a.nrows, p, ml, mu, nb_loc
        sh = NamedSharding(mesh, P(axis))
        rep = NamedSharding(mesh, P())
        self._lb = jax.device_put(loc.astype(np.float32), sh)
        self._B = jax.device_put(B.astype(np.float32), sh)
        self._C = jax.device_put(C.astype(np.float32), sh)
        if pivot_eps is None:
            amax = float(np.abs(a.data).max()) if a.nnz else 1.0
            pivot_eps = 1e-4 * max(amax, 1.0)
        self.report.t_analyze = time.perf_counter() - t0

        # ---- factorize (job=4): parallel local LU + spike tips ----
        t0 = time.perf_counter()
        factor = _make_factor_fn(p, ml, mu, nb_loc, mesh, axis, pivot_eps)
        lu, vt, vb, wt, wb, nbad = factor(self._lb, self._B, self._C)
        jax.block_until_ready(lu)
        self._lu = lu
        # reduced system R: identity + spike-tip coupling (host assemble, small)
        vt_h, vb_h = np.asarray(vt, np.float64), np.asarray(vb, np.float64)
        wt_h, wb_h = np.asarray(wt, np.float64), np.asarray(wb, np.float64)
        s = ndev * s0
        R = np.eye(s)
        for j in range(ndev):
            ru = slice(j * s0, j * s0 + mu * p)
            rd = slice(j * s0 + mu * p, (j + 1) * s0)
            if j < ndev - 1:
                cu = slice((j + 1) * s0, (j + 1) * s0 + mu * p)
                R[ru, cu] += vt_h[j]
                R[rd, cu] += vb_h[j]
            if j > 0:
                cd = slice((j - 1) * s0 + mu * p, j * s0)
                R[ru, cd] += wt_h[j]
                R[rd, cd] += wb_h[j]
        rlu, rpiv = jax.scipy.linalg.lu_factor(jnp.asarray(R, jnp.float32))
        self._rlu = jax.device_put(rlu, rep)
        self._rpiv = jax.device_put(rpiv, rep)
        jax.block_until_ready(self._rlu)
        self.report.t_factorize = time.perf_counter() - t0
        self.report.n_pivot_perturbed = int(np.asarray(nbad).sum())
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        self.report.pivot_growth = float(jnp.max(jnp.abs(lu))) / max(amax, 1e-300)
        self.report.factor_bytes = (lu.size * 4 + rlu.size * 4 +
                                    B.size * 4 + C.size * 4)
        self._solve_fn = _make_solve_fn(p, ml, mu, nb_loc, ndev, mesh, axis)
        self._x_sh = sh

    def _shard_rhs(self, b: np.ndarray) -> jax.Array:
        npts = self.ndev * self.nb_loc * self.p
        b2 = np.asarray(b, np.float64)
        if b2.ndim == 1:
            b2 = b2[:, None]
        bp = np.zeros((npts, b2.shape[1]))
        bp[:self.n] = b2[self.perm]
        return jax.device_put(
            bp.reshape(self.ndev, self.nb_loc, self.p, -1).astype(np.float32),
            self._x_sh)

    def solve_device(self, bp_dev: jax.Array) -> jax.Array:
        """Sharded solve in permuted coordinates ([ndev, nb_loc*p, nrhs])."""
        return self._solve_fn(self._lu, self._B, self._C, self._rlu,
                              self._rpiv, bp_dev)

    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve A x = b (host in/out) — the MUMPS job=3 slot."""
        t0 = time.perf_counter()
        single = np.asarray(b).ndim == 1
        xs = self.solve_device(self._shard_rhs(b))
        xh = np.asarray(xs, np.float64).reshape(-1, xs.shape[-1])[:self.n]
        x = np.empty_like(xh)
        x[self.perm] = xh
        if single:
            x = x[:, 0]
        self.report.t_solve = time.perf_counter() - t0
        if single:
            self.report.residual = relative_residual(
                self.a, x, np.asarray(b, np.float64))
        return x


def dist_factorize_band(a: CSRMatrix, mesh: Optional[Mesh] = None,
                        **kw) -> DistBandLu:
    return DistBandLu(a, mesh=mesh, **kw)


def dist_solve_refined(a: CSRMatrix, b: np.ndarray,
                       fac: Optional[DistBandLu] = None,
                       mesh: Optional[Mesh] = None,
                       tol: float = 1e-12, max_iters: int = 40
                       ) -> Tuple[np.ndarray, SolveReport]:
    """Distributed fp32 factorization + fp64 iterative refinement.

    The distributed analogue of solve.solve_refined: correction solves run
    on the mesh (SPIKE), residuals in host fp64 (exact oracle; a df64
    on-mesh residual via dist.DistSpmv is the zero-copy variant). Reaches
    reference-fp64 residuals from the fp32 factorization — the study's
    headline applied to the MUMPS slot.
    """
    if fac is None:
        fac = DistBandLu(a, mesh=mesh)
    rep = SolveReport(policy=fac.report.policy + "+ir",
                      t_analyze=fac.report.t_analyze,
                      t_factorize=fac.report.t_factorize,
                      n_pivot_perturbed=fac.report.n_pivot_perturbed)
    t0 = time.perf_counter()
    bh = np.asarray(b, np.float64)
    nb = np.linalg.norm(bh)
    nb = nb if nb > 0 else 1.0
    x = np.zeros_like(bh)
    hist = []
    for _ in range(max_iters):
        r = bh - _host_matvec(a, x)
        rnorm = float(np.linalg.norm(r)) / nb
        hist.append(rnorm)
        if rnorm < tol:
            break
        x = x + fac.solve(r)
    rep.t_solve = time.perf_counter() - t0
    rep.residual = hist[-1]
    rep.iterations = len(hist) - 1
    rep.converged = hist[-1] < tol
    return x, rep
