"""Integration tests tracking the BASELINE.json targets (scaled-down, CPU mesh).

The catalogue-size versions of these runs are produced on the GPU by
chip_smoke.py, bench.py and respatpu.bench.study/scaling; these tests pin the
*logic* of each target at small scale so regressions surface in CI.
"""
import numpy as np
import pytest

from respatpu import dist
from respatpu import solve as slv
from respatpu.bench.corpus import load_matrix
from respatpu.bench.study import run_study, summarize


@pytest.mark.parametrize("name", ["2cubes_sphere", "ecology2", "Baumann"])
def test_fp32_ir_matches_fp64_reference_residual(name):
    """Target: low-precision factorization + df64 IR reaches reference-fp64
    residual levels (<=1e-10) on moderate-corpus-class matrices."""
    a, _ = load_matrix(name, max_synth_nnz=30_000)
    b, _ = slv.make_rhs_for_known_x(a)
    x, rep = slv.solve_refined(a, b, policy="fp32", tol=1e-12)
    assert rep.residual < 1e-10, (name, rep)


def test_residuals_consistent_across_scales():
    """Target: solve residuals consistent at 1 / 4 / 8 'chips' (fake mesh)."""
    a, _ = load_matrix("Baumann", max_synth_nnz=30_000)
    b, _ = slv.make_rhs_for_known_x(a)
    resids = []
    for nd in (1, 4, 8):
        x, it = dist.dist_bicgstab(a, b, mesh=dist.make_mesh(nd),
                                   tol=1e-9, max_iters=400)
        resids.append(slv.relative_residual(a, x, b))
    assert all(r < 1e-6 for r in resids), resids
    # same answer regardless of partitioning (within iterative tolerance)
    assert max(resids) / max(min(resids), 1e-16) < 1e4


def test_study_summary_shape():
    rows = run_study(["Baumann"], max_synth_nnz=20_000, verbose=False)
    s = summarize(rows)
    assert s["n_matrices"] == 1
    assert s["fp32_ir_residual_median"] is not None
    assert s["fp32_ir_residual_median"] < 1e-9
