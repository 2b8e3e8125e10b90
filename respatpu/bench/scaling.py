"""Distributed SpMV scaling measurement (nnz/s at 1 device / N devices;
the MUMPS-scaling slot of the reference protocol).

On GPUs this measures halo-exchange SpMV throughput per device count; on a
virtual CPU mesh it validates the partitioning/collective logic and reports
relative scaling (absolute CPU numbers are not meaningful).
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np

from .. import dist
from . import corpus

__all__ = ["measure_scaling"]


def measure_scaling(name: str = "atmosmodd", device_counts: Sequence[int] = (1, 2, 4, 8),
                    max_synth_nnz: Optional[int] = 2_000_000,
                    reps: int = 5, verbose: bool = True) -> List[dict]:
    import time

    import jax

    a, synth = corpus.load_matrix(name, max_synth_nnz=max_synth_nnz)
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    out = []
    avail = jax.device_count()
    for nd in device_counts:
        if nd > avail:
            continue
        mesh = dist.make_mesh(nd)
        op = dist.DistSpmv(a, mesh)
        xs = op.shard_vector(x)
        y = op(xs)
        _ = np.asarray(y).ravel()[0]  # fence
        t0 = time.perf_counter()
        for r in range(reps):
            xs2 = op.shard_vector(x * (1.0 + 1e-7 * (r + 1)))  # defeat caching
            y = op(xs2)
            _ = float(np.asarray(y).ravel()[0])
        dt = (time.perf_counter() - t0) / reps
        row = dict(matrix=name, synthetic=synth, n=a.shape[0], nnz=a.nnz,
                   devices=nd, halo=op.plan.halo, t_spmv_s=round(dt, 6),
                   gnnz_per_s=round(a.nnz / dt / 1e9, 4))
        out.append(row)
        if verbose:
            print(f"[scaling] {name} nd={nd}: {dt*1e3:.2f} ms "
                  f"({row['gnnz_per_s']} Gnnz/s, halo={op.plan.halo})")
    return out


if __name__ == "__main__":
    import sys
    name = sys.argv[1] if len(sys.argv) > 1 else "atmosmodd"
    print(json.dumps(measure_scaling(name), indent=2))
