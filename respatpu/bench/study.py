"""Reproduction of the ReSpaSol precision study (the paper's experiment).

For each corpus matrix, solve A x = b under several precision configurations
and record phase times + relative residuals:

  * df64   — emulated fp64 direct band LU (the "reference" config)
  * fp32   — fp32 band LU, raw
  * fp32_ftz — fp32 with explicit subnormal flush (the paper's FTZ config;
               XLA keeps subnormals unless asked, so this isolates the
               subnormal effect the paper reports)
  * fp32+ir — fp32 LU + df64 iterative refinement (the paper's conclusion:
              low-precision factorization can deliver fp64-level accuracy)

Outputs CSV rows + a JSON summary with the fp32/df64 time ratios (the paper's
headline is ~2x, README.md:5-7 -> PeerJ CS 8:e778).
"""
from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence

import numpy as np

from . import corpus
from .. import solve as slv

__all__ = ["run_study", "summarize"]

CONFIGS = ("df64", "fp32", "fp32_ftz", "fp32+ir", "bf16+ir")


def run_study(names: Optional[Sequence[str]] = None,
              csv_path: Optional[str] = None,
              max_synth_nnz: Optional[int] = 2_000_000,
              max_band_bytes: int = 4 << 30,
              method: str = "auto", matching="auto",
              verbose: bool = True) -> List[dict]:
    """Each matrix goes through ``solve.factorize``'s auto chain (band ->
    multifrontal -> scheduled, GESP matching auto-on for unsymmetric
    patterns), matching the reference driver's all-matrices coverage
    (test_pardiso.c:185-244). The serving method is recorded per row."""
    from .fetch import attempt_fetch
    from .runner import _append, _ts
    names = names or [e.name for e in corpus.MODERATE]
    attempt_fetch(names)  # no-op seconds in zero-egress environments
    header = ["matrix", "n", "nnz", "synthetic", "config", "method",
              "t_factor_s", "t_factor_warm_s", "t_solve_s", "iterations",
              "rel_residual", "status", "timestamp"]
    rows = []
    for name in names:
        a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
        b, _ = slv.make_rhs_for_known_x(a)
        for config in CONFIGS:
            t_warm = float("nan")
            used = ""
            try:
                if config.endswith("+ir"):
                    fac = slv.factorize(a, policy=config[:-3], method=method,
                                        matching=matching,
                                        max_band_bytes=max_band_bytes)
                    used = fac.report.notes
                    x, rep = slv.solve_refined(a, b, fac=fac, tol=1e-12)
                else:
                    fac = slv.factorize(a, policy=config, method=method,
                                        matching=matching,
                                        max_band_bytes=max_band_bytes)
                    used = fac.report.notes
                    if config != "df64" and hasattr(fac, "refactorize_timed"):
                        # warm (exec-only) retiming; skipped for df64 whose
                        # factorization is minutes-long (elementwise
                        # double-float) and dominated by execution
                        t_warm = fac.refactorize_timed()
                    if (config == "df64" and
                            isinstance(fac, slv.SupernodalLuFactorization)):
                        # the multifrontal numeric phase is fp32-only;
                        # the df64 *reference* config there is fp32 factors
                        # + df64 IR driven to ~1e-14 — the standard
                        # mixed-precision reference-accuracy recipe
                        used += ",df64_ref=fp32+ir"
                        x, rep = slv.solve_refined(a, b, fac=fac, tol=1e-14)
                    else:
                        x = fac.solve(b)
                        rep = fac.report
                # "ok" requires convergence: a refined config that
                # stagnated above its gate reads "stagnated" with the
                # residual kept (the raw fp32/fp32_ftz configs report
                # their residual informationally and always converge in
                # the direct-solve sense) — test_superLU_MT.c:230-234
                status = ("ok" if getattr(rep, "converged", True)
                          else "stagnated")
            except MemoryError:
                rep = slv.SolveReport(policy=config)
                status = "infeasible"
            except Exception as e:
                rep = slv.SolveReport(policy=config,
                                      notes=f"{type(e).__name__}: {e}")
                status = "error"
            row = dict(zip(header, [name, a.shape[0], a.nnz, int(synth),
                                    config, used, round(rep.t_factorize, 4),
                                    round(t_warm, 4),
                                    round(rep.t_solve, 4), rep.iterations,
                                    f"{rep.residual:.3e}", status, _ts()]))
            _append(csv_path, header, list(row.values()))
            rows.append(row)
            if verbose:
                print(f"[study] {name}/{config}: {status} [{used}] "
                      f"factor={rep.t_factorize:.3f}s resid={rep.residual:.2e}")
        # drop this matrix's compiled executables before the next one
        # (vm.max_map_count exhaustion guard; see bench/runner.sweep_lu)
        import jax
        if jax.default_backend() == "cpu":
            jax.clear_caches()  # vm.max_map_count guard (XLA:CPU only)
    return rows


def summarize(rows: List[dict]) -> dict:
    """Paper-style summary: speedups and residual ratios fp32 vs df64."""
    by = {}
    for r in rows:
        by.setdefault(r["matrix"], {})[r["config"]] = r
    speedups, resid32, resid_ir = [], [], []
    def t_of(r):
        tw = float(r.get("t_factor_warm_s", float("nan")))
        return tw if np.isfinite(tw) else float(r["t_factor_s"])

    for m, cfgs in by.items():
        if "df64" in cfgs and "fp32" in cfgs:
            t64 = t_of(cfgs["df64"])
            t32 = t_of(cfgs["fp32"])
            if t32 > 0 and cfgs["fp32"]["status"] == "ok":
                speedups.append(t64 / t32)
            if cfgs["fp32"]["status"] == "ok":
                resid32.append(float(cfgs["fp32"]["rel_residual"]))
        if "fp32+ir" in cfgs and cfgs["fp32+ir"]["status"] == "ok":
            resid_ir.append(float(cfgs["fp32+ir"]["rel_residual"]))
    return {
        "n_matrices": len(by),
        "fp32_vs_df64_factor_speedup_median": float(np.median(speedups)) if speedups else None,
        "fp32_residual_median": float(np.median(resid32)) if resid32 else None,
        "fp32_ir_residual_median": float(np.median(resid_ir)) if resid_ir else None,
        "fp32_ir_reaches_1e-10_frac": float(np.mean([r < 1e-10 for r in resid_ir])) if resid_ir else None,
    }


if __name__ == "__main__":
    import sys
    names = sys.argv[1:] or None
    rows = run_study(names)
    print(json.dumps(summarize(rows), indent=2))
