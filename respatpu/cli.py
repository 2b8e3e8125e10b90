"""Command-line drivers: the reference's L3 workload binaries as one CLI.

  python -m respatpu spmv  <matrix.mtx|corpus-name> [--csv out.csv] ...
  python -m respatpu ilu0  <matrix.mtx|corpus-name> ...
  python -m respatpu lu    <matrix.mtx|corpus-name> [--policy fp32] [--refine]
  python -m respatpu sweep {spmv|ilu0|lu} [--group moderate|big|all]
  python -m respatpu fetch {moderate|big|all}

Precision and FTZ are runtime flags (--policy fp32|fp32_ftz|bf16|df64),
replacing the reference's recompile-per-experiment protocol (README.md:77-97).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load(spec: str):
    from .bench.corpus import _BY_NAME, load_matrix
    if os.path.exists(spec):
        from .io import load_csr
        return load_csr(spec), False, os.path.basename(spec)
    if spec in _BY_NAME:
        a, synth = load_matrix(spec)
        return a, synth, spec
    raise SystemExit(f"matrix {spec!r}: no such file or corpus entry")


def cmd_spmv(args):
    from .bench import runner
    if os.path.exists(args.matrix):
        from . import solve as slv
        a, _, name = _load(args.matrix)
        x = np.random.default_rng(args.seed).standard_normal(a.shape[1])
        y_hi, t_hi = slv.spmv_timed(a, x, "df64", reps=args.reps)
        y_lo, t_lo = slv.spmv_timed(a, x, args.policy, reps=args.reps)
        from .solve import _to_host_f64
        err = float(np.abs(_to_host_f64(y_hi) - _to_host_f64(y_lo)).mean())
        print(f"{name}: t_df64={t_hi*1e3:.3f}ms t_{args.policy}={t_lo*1e3:.3f}ms "
              f"mean_abs_err={err:.3e}")
    else:
        runner.sweep_spmv([args.matrix], csv_path=args.csv,
                          policies=("df64", args.policy), reps=args.reps)


def cmd_ilu0(args):
    from . import solve as slv
    a, synth, name = _load(args.matrix)
    pre = slv.Ilu0Preconditioner(a, policy=args.policy, sweeps=args.sweeps)
    r = pre.report
    print(f"{name}{' (synthetic)' if synth else ''}: "
          f"analyze={r.t_analyze:.3f}s factor={r.t_factorize:.3f}s "
          f"pivots_perturbed={r.n_pivot_perturbed} {r.notes}")


def cmd_lu(args):
    from . import solve as slv
    a, synth, name = _load(args.matrix)
    b, x_true = slv.make_rhs_for_known_x(a)
    matching = {"auto": "auto", "on": True, "off": False}[args.matching]
    if args.method == "subtree":
        # distributed (MUMPS job=4/3 slot): subtree-owner-sharded
        # multifrontal over every local device
        from .dist import make_mesh
        from .dist_snlu_sub import DistSubtreeLu
        fac = DistSubtreeLu(a, mesh=make_mesh())
        fac.report.notes = (f"method=subtree x{fac.ndev}dev "
                            f"local_pool={fac.local_pool_bytes/2**20:.0f}MiB "
                            f"(replicated {fac.replicated_pool_bytes/2**20:.0f})")
        if args.refine:
            x = fac.solve_refined(b)
        else:
            x = fac.solve(b)
        rep = fac.report
        print(f"{name}{' (synthetic)' if synth else ''}: policy={rep.policy} "
              f"[{rep.notes}] analyze={rep.t_analyze:.3f}s "
              f"factor={rep.t_factorize:.3f}s solve={rep.t_solve:.3f}s "
              f"rel_residual={rep.residual:.3e} "
              f"inf_err={slv.inf_norm_error(x, x_true):.3e}")
        return
    fac = slv.factorize(a, policy=args.policy, method=args.method,
                        matching=matching)
    if args.refine:
        x, rep = slv.solve_refined(a, b, fac=fac)
    else:
        x = fac.solve(b)
        rep = fac.report
    print(f"{name}{' (synthetic)' if synth else ''}: policy={rep.policy} "
          f"[{fac.report.notes}] "
          f"analyze={fac.report.t_analyze:.3f}s factor={rep.t_factorize:.3f}s "
          f"solve={rep.t_solve:.3f}s iters={rep.iterations} "
          f"rel_residual={rep.residual:.3e} "
          f"inf_err={slv.inf_norm_error(x, x_true):.3e}")
    if rep.residual > 1e-10 and (args.policy == "df64" or args.refine):
        print("WARNING: residual above 1e-10 gate", file=sys.stderr)


def cmd_sweep(args):
    from .bench import runner
    kw = {}
    if args.max_synth_nnz is not None:
        kw["max_synth_nnz"] = args.max_synth_nnz
    if args.kind == "spmv":
        runner.run_sweep("spmv", group=args.group, csv_path=args.csv,
                         policies=("df64", args.policy), **kw)
    elif args.kind == "ilu0dist":
        runner.run_sweep("ilu0dist", group=args.group, csv_path=args.csv, **kw)
    else:
        runner.run_sweep(args.kind, group=args.group, csv_path=args.csv,
                         policy=args.policy, **kw)


def cmd_fetch(args):
    from .bench import fetch
    fetch.main([args.group])


def cmd_study(args):
    import json
    from .bench import study
    names = args.matrices or None
    rows = study.run_study(names, csv_path=args.csv,
                           max_synth_nnz=args.max_synth_nnz)
    print(json.dumps(study.summarize(rows), indent=2))


def cmd_scaling(args):
    import json
    from .bench import scaling
    print(json.dumps(scaling.measure_scaling(args.matrix), indent=2))


def main(argv=None):
    p = argparse.ArgumentParser(prog="respatpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--policy", default="fp32",
                        help="fp32 | fp32_ftz | bf16 | df64 (fp64-emulated)")
        sp.add_argument("--csv", default=None)
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--reps", type=int, default=5)

    sp = sub.add_parser("spmv", help="dual-precision SpMV benchmark")
    sp.add_argument("matrix")
    common(sp)
    sp.set_defaults(fn=cmd_spmv)

    sp = sub.add_parser("ilu0", help="ILU(0) factorization + apply")
    sp.add_argument("matrix")
    sp.add_argument("--sweeps", type=int, default=8)
    common(sp)
    sp.set_defaults(fn=cmd_ilu0)

    sp = sub.add_parser("lu", help="direct LU factorize + solve")
    sp.add_argument("matrix")
    sp.add_argument("--refine", action="store_true",
                    help="mixed-precision df64 iterative refinement")
    sp.add_argument("--method", default="auto",
                    choices=["auto", "band", "snlu", "sparse", "subtree"],
                    help="band LU | supernodal multifrontal | scheduled | "
                         "subtree = distributed multifrontal over all "
                         "local devices (the MUMPS slot)")
    sp.add_argument("--matching", default="auto",
                    choices=["auto", "on", "off"],
                    help="GESP weighted matching + Ruiz scaling "
                         "(auto = on for structurally unsymmetric)")
    common(sp)
    sp.set_defaults(fn=cmd_lu)

    sp = sub.add_parser("sweep", help="corpus sweep")
    sp.add_argument("kind", choices=["spmv", "ilu0", "lu", "ilu0dist"])
    sp.add_argument("--group", default="moderate",
                    choices=["moderate", "big", "all"])
    sp.add_argument("--max-synth-nnz", type=int, default=None,
                    help="cap synthetic stand-in size (default: per-sweep)")
    common(sp)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("fetch", help="download SuiteSparse corpus")
    sp.add_argument("group", nargs="?", default="moderate",
                    choices=["moderate", "big", "all"])
    sp.set_defaults(fn=cmd_fetch)

    sp = sub.add_parser("study", help="precision study reproduction")
    sp.add_argument("matrices", nargs="*")
    sp.add_argument("--csv", default=None)
    sp.add_argument("--max-synth-nnz", type=int, default=500_000)
    sp.set_defaults(fn=cmd_study)

    sp = sub.add_parser("scaling", help="distributed SpMV scaling")
    sp.add_argument("matrix", nargs="?", default="atmosmodd")
    sp.set_defaults(fn=cmd_scaling)

    args = p.parse_args(argv)
    from .config import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
