#!/usr/bin/env python
"""Smoke run of the solver stack on NVIDIA GPUs, at corpus catalogue size.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the distributed phase only

Phases on one GPU, each checked against a host fp64 (numpy/scipy) oracle:

  spmv    ``kernels.spmv.to_device(fmt="auto")`` + ``spmv`` on 2cubes_sphere,
          dc1 and a 110^3 Laplacian in fp32, fp32_ftz, bf16 and df64, with
          componentwise bounds against (|A||x|)_i; a subnormal probe
  eft     ``precision.eft_selfcheck()`` on the GPU
  krylov  ILU(0) + BiCGSTAB on 2cubes_sphere (true residual <= 1e-6)
  direct  ``solve.factorize`` + ``solve_refined`` on dc1 (residual <= 1e-10)
  ozaki   exact-slice df64 matmul at 512 x 512

With ``--four-cards``: ``dist.dist_bicgstab`` on 2cubes_sphere and
``DistSubtreeLu.solve_refined`` on a 15,000-node ``mesh_fem_3d`` stand-in,
each over one and over four GPUs, against each other and the scipy oracle.

Matrices are the seeded corpus stand-ins (``bench/corpus.py``) unless a real
``.mtx`` sits under ``matrices/``. The script refuses to run without a GPU,
prints the card's name and power limit first, and ends with one JSON line:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Any phase failure raises, so the script exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# componentwise tolerances (see phase_spmv): fp32 dot-product bound, bf16
# storage rounding on top of it, and df64's ~49-bit significand with slack
U32 = 2.0 ** -23
BF16_STORE = 2.0 ** -7
DF64_U = 2.0 ** -44
# the subtree-sharded direct solve's FEM stand-in (bench/synth.mesh_fem_3d)
FOUR_CARD_FEM_NODES = 15_000


def log(*a):
    print(*a, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_gpu(count: int):
    """The GPU devices JAX sees; exits non-zero when there are fewer than
    ``count`` (the smoke never carries on on the CPU)."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        print(f"chip_smoke: needs {count} GPU device(s), JAX has {devs}",
              file=sys.stderr)
        sys.exit(2)
    return devs


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def to_scipy(a):
    import scipy.sparse as sp
    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)


def phase_spmv(mats: dict, seed: int = 0, reps: int = 10) -> list:
    """SpMV through ``to_device(fmt="auto")`` in every policy.

    x is drawn bf16-representable, so only the matrix values and the
    arithmetic round. Bounds on |y_i - (A x)_i| / (|A||x|)_i, with k the
    longest row: fp32 k*2^-23; bf16 2^-7 + k*2^-23; df64 k*2^-44."""
    import jax
    import jax.numpy as jnp
    from respatpu import precision as prec
    from respatpu.kernels.spmv import spmv, to_device

    rows = []
    rng = np.random.default_rng(seed)
    for name, a in mats.items():
        x = np.asarray(jnp.asarray(rng.standard_normal(a.ncols),
                                   jnp.bfloat16).astype(jnp.float32),
                       np.float64)
        y_ref = to_scipy(a) @ x
        scale = abs(to_scipy(a)) @ np.abs(x)
        scale = np.where(scale > 0, scale, 1.0)
        k = int(a.row_lengths().max())
        for pol in ("fp32", "fp32_ftz", "bf16", "df64"):
            dev, t_build = _timed(lambda: jax.block_until_ready(
                to_device(a, pol, fmt="auto")))
            call = jax.jit(spmv)
            if pol == "df64":
                xin = prec.df_from_f64(x)
                get = prec.df_to_f64
                tol = k * DF64_U
            else:
                xin = jnp.asarray(x, jnp.float32)
                get = lambda y: np.asarray(y, np.float64)  # noqa: E731
                tol = (BF16_STORE if pol == "bf16" else 0.0) + k * U32
            y, t_first = _timed(lambda: jax.block_until_ready(call(dev, xin)))

            def batch():
                for _ in range(reps):
                    out = call(dev, xin)
                return jax.block_until_ready(out)
            t_exec = _timed(batch)[1] / reps
            err = float(np.max(np.abs(get(y) - y_ref) / scale))
            row = dict(matrix=name, n=a.nrows, nnz=a.nnz, policy=pol,
                       fmt=type(dev).__name__, k=k, err=err, tol=tol,
                       t_build_s=round(t_build, 4),
                       t_compile_s=round(max(t_first - t_exec, 0.0), 4),
                       t_exec_us=round(t_exec * 1e6, 2))
            log("spmv", json.dumps(row))
            if not err <= tol:
                raise AssertionError(f"spmv {name} {pol}: componentwise "
                                     f"error {err:.3e} > {tol:.3e}")
            rows.append(row)
    return rows


def phase_ftz_probe():
    """fp32_ftz flushes a subnormal product to zero; fp32 keeps it."""
    import jax.numpy as jnp
    from respatpu.formats import CSRMatrix
    from respatpu.kernels.spmv import spmv, to_device

    sub = float(np.float32(1e-39))
    a = CSRMatrix((2, 2), np.array([0, 1, 2], np.int32),
                  np.array([0, 1], np.int32), np.array([sub, 1.0]))
    x = jnp.ones(2, jnp.float32)
    y32 = np.asarray(spmv(to_device(a, "fp32", fmt="auto"), x))
    yftz = np.asarray(spmv(to_device(a, "fp32_ftz", fmt="auto"), x))
    log(f"ftz probe: fp32 y0={y32[0]!r} fp32_ftz y0={yftz[0]!r}")
    if not (y32[0] == np.float32(sub) and yftz[0] == 0.0):
        raise AssertionError("subnormal probe: fp32 must keep 1e-39 and "
                             "fp32_ftz must flush it")


def phase_eft():
    from respatpu import precision as prec
    ok = prec.eft_selfcheck(warn=False)
    log(f"eft: selfcheck={ok}")
    if not ok:
        raise AssertionError("error-free transforms miscompiled: df64 would "
                             "carry fp32 accuracy")


def phase_krylov(a, rehearse_on=None, seed: int = 2) -> dict:
    """ILU(0)(fp32) + BiCGSTAB; run twice (cold includes compilation).
    ``rehearse_on``: a device to repeat the same calls on for comparison of
    the iteration count (the host CPU on a GPU machine).

    The known solution is random: with x = 1 on a FEM matrix, b = A x is
    ~25x smaller than |A||x|, and merely storing x in fp32 leaves a true
    residual above the 1e-6 gate."""
    import jax
    from respatpu import solve as slv

    x_true = np.random.default_rng(seed).standard_normal(a.ncols)
    b, _ = slv.make_rhs_for_known_x(a, x_true)

    pre = slv.ilu0(a, policy="fp32")
    x, rep = slv.bicgstab(a, b, precond=pre)
    _, warm = slv.bicgstab(a, b, precond=pre)
    res = slv.relative_residual(a, x, b)
    out = dict(n=a.nrows, nnz=a.nnz, iterations=rep.iterations,
               converged=rep.converged, residual=res,
               t_ilu_factor_s=round(pre.report.t_factorize, 3),
               t_ilu_analyze_s=round(pre.report.t_analyze, 3),
               t_solve_cold_s=round(rep.t_solve, 3),
               t_solve_warm_s=round(warm.t_solve, 3))
    if rehearse_on is not None:
        with jax.default_device(rehearse_on):
            _, rep_cpu = slv.bicgstab(a, b, precond=slv.ilu0(a, policy="fp32"))
        out["iterations_rehearsal"] = rep_cpu.iterations
        out["rehearsal_device"] = str(rehearse_on)
    log("krylov", json.dumps(out))
    if not (rep.converged and res <= 1e-6):
        raise AssertionError(f"krylov: converged={rep.converged} "
                             f"residual={res:.3e} (gate 1e-6)")
    return out


def phase_direct(a, **factorize_kw) -> dict:
    """factorize(fp32) + df64 iterative refinement; solve run twice."""
    from respatpu import solve as slv

    b, _ = slv.make_rhs_for_known_x(a)
    fac = slv.factorize(a, policy="fp32", **factorize_kw)
    x, rep = slv.solve_refined(a, b, fac=fac)
    _, warm = slv.solve_refined(a, b, fac=fac)
    res = slv.relative_residual(a, x, b)
    out = dict(n=a.nrows, nnz=a.nnz, notes=rep.notes,
               ir_iterations=rep.iterations, residual=res,
               t_analyze_s=round(fac.report.t_analyze, 3),
               t_factorize_s=round(fac.report.t_factorize, 3),
               t_solve_cold_s=round(rep.t_solve, 3),
               t_solve_warm_s=round(warm.t_solve, 3))
    if hasattr(fac, "refactorize_timed"):
        out["t_factorize_warm_s"] = round(fac.refactorize_timed(), 3)
    log("direct", json.dumps(out))
    if not res <= 1e-10:
        raise AssertionError(f"direct: residual {res:.3e} > 1e-10")
    return out


def phase_ozaki(n: int = 512, seed: int = 1) -> dict:
    """Exact bf16-slice df64 matmul vs the host fp64 product; the bound is
    the df64 one, n*2^-44 against (|A||B|)_ij."""
    import jax
    from respatpu import precision as prec
    from respatpu.kernels.ozaki import ozaki_matmul

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    b = rng.standard_normal((n, n))
    c, t = _timed(lambda: jax.block_until_ready(
        ozaki_matmul(prec.df_from_f64(a), prec.df_from_f64(b))))
    err = float(np.max(np.abs(prec.df_to_f64(c) - a @ b)
                       / (np.abs(a) @ np.abs(b))))
    tol = n * DF64_U
    out = dict(n=n, err=err, tol=tol, t_first_s=round(t, 3))
    log("ozaki", json.dumps(out))
    if not err <= tol:
        raise AssertionError(f"ozaki: error {err:.3e} > {tol:.3e}")
    return out


def phase_four_cards(a_iter, a_direct, ndev: int = 4, seed: int = 3) -> dict:
    """dist_bicgstab and DistSubtreeLu.solve_refined over ``ndev`` devices,
    each against the same call over one device and the scipy oracle."""
    from respatpu import dist
    from respatpu.dist_snlu_sub import DistSubtreeLu

    def resid(a, x, b):
        return float(np.linalg.norm(to_scipy(a) @ x - b) / np.linalg.norm(b))

    out = {}
    rng = np.random.default_rng(seed)  # random x_true: see phase_krylov
    b = to_scipy(a_iter) @ rng.standard_normal(a_iter.ncols)
    xs = {}
    for nd in (1, ndev):
        # tol as in solve.bicgstab: the fp32 recursive residual runs
        # ahead of the true one, so the 1e-6 gate needs a tighter stop
        (x, iters), t = _timed(lambda: dist.dist_bicgstab(
            a_iter, b, mesh=dist.make_mesh(nd), tol=1e-8))
        xs[nd] = x
        out[f"bicgstab_{nd}dev"] = dict(iterations=int(iters),
                                        residual=resid(a_iter, x, b),
                                        t_s=round(t, 3))
    out["bicgstab_diff"] = float(np.max(np.abs(xs[ndev] - xs[1]))
                                 / np.max(np.abs(xs[1])))
    b = to_scipy(a_direct) @ rng.standard_normal(a_direct.ncols)
    for nd in (1, ndev):
        fac, t_fac = _timed(lambda: DistSubtreeLu(a_direct,
                                                  mesh=dist.make_mesh(nd)))
        x, t_sol = _timed(lambda: fac.solve_refined(b))
        xs[nd] = x
        out[f"subtree_lu_{nd}dev"] = dict(
            residual=resid(a_direct, x, b),
            ir_iterations=fac.report.iterations,
            local_pool_bytes=int(fac.local_pool_bytes),
            t_analyze_s=round(fac.report.t_analyze, 3),
            t_factor_total_s=round(t_fac, 3), t_solve_s=round(t_sol, 3))
    out["subtree_lu_diff"] = float(np.max(np.abs(xs[ndev] - xs[1]))
                                   / np.max(np.abs(xs[1])))
    log("four_cards", json.dumps(out))
    for nd in (1, ndev):
        # 1e-5: the block-Jacobi iteration's fp32 recursive residual stops
        # at 1e-8, and its true residual has been seen to trail by ~100x
        if not out[f"bicgstab_{nd}dev"]["residual"] <= 1e-5:
            raise AssertionError(f"dist_bicgstab on {nd} device(s) missed "
                                 f"the 1e-5 residual gate")
        if not out[f"subtree_lu_{nd}dev"]["residual"] <= 1e-10:
            raise AssertionError(f"DistSubtreeLu on {nd} device(s) missed "
                                 f"the 1e-10 residual gate")
    if not out["bicgstab_diff"] <= 1e-3:
        raise AssertionError("dist_bicgstab: 1- and n-device solutions "
                             "differ by more than 1e-3")
    if not out["subtree_lu_diff"] <= 1e-8:
        raise AssertionError("DistSubtreeLu: 1- and n-device solutions "
                             "differ by more than 1e-8")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the distributed phase, over four GPUs")
    args = p.parse_args(argv)
    count = 4 if args.four_cards else 1

    devs = require_gpu(count)
    log(gpu_name_and_power())
    import jax
    log(f"devices: {devs}; kinds: {[d.device_kind for d in devs]}")
    log(f"JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS')!r} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}")

    from respatpu.bench.corpus import load_matrix
    from respatpu.bench.synth import laplacian_3d, mesh_fem_3d
    from respatpu.config import enable_compile_cache
    from respatpu.io import native
    log(f"compile cache: {enable_compile_cache()}")
    log(f"native host library in use: {native.available()}")

    def load(name):
        a, synthetic = load_matrix(name)
        log(f"matrix {name}: n={a.nrows} nnz={a.nnz} synthetic={synthetic}")
        return a

    t0 = time.perf_counter()
    cubes = load("2cubes_sphere")
    if args.four_cards:
        fem = mesh_fem_3d(FOUR_CARD_FEM_NODES, seed=5)
        log(f"matrix mesh_fem_3d({FOUR_CARD_FEM_NODES}): n={fem.nrows} "
            f"nnz={fem.nnz}")
        phase_four_cards(cubes, fem, ndev=count)
    else:
        dc1 = load("dc1")
        lap = laplacian_3d(110, 110, 110)
        log(f"matrix laplacian_3d(110,110,110): n={lap.nrows} nnz={lap.nnz}")
        phases = [
            ("spmv", lambda: phase_spmv({"2cubes_sphere": cubes, "dc1": dc1,
                                         "laplacian_3d_110": lap})),
            ("ftz", phase_ftz_probe),
            ("eft", phase_eft),
            ("krylov", lambda: phase_krylov(
                cubes, rehearse_on=jax.devices("cpu")[0])),
            ("direct", lambda: phase_direct(dc1)),
            ("ozaki", phase_ozaki),
        ]
        for name, fn in phases:
            _, t = _timed(fn)
            log(f"phase {name}: ok in {t:.1f} s")
    stats = devs[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    log(f"total wall: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
