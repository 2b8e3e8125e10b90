"""respatpu: mixed-precision sparse linear algebra in JAX, for NVIDIA GPUs.

A from-scratch JAX/XLA framework covering the workload of the
ReSpaSol reduced-precision sparse solver study (see SURVEY.md): Matrix Market
ingest, CSR SpMV, ILU(0) + level-scheduled sparse triangular solves, sparse LU
factorize/solve, Krylov solvers, dual-precision (fp32/bf16/emulated-fp64)
execution with flush-to-zero control, residual verification, corpus sweeps,
and multi-device row-partitioned distribution over a `jax.sharding.Mesh`.
"""

def _cpu_eft_guard():
    """XLA:CPU's fusion emitter breaks the error-free transforms behind the
    df64 (emulated fp64) policy; disable the fusion pass when the CPU backend
    is the only platform requested: a platform list that names a GPU too
    must keep fusion, which the GPU needs for speed and does not break EFTs.
    Must run before jax backend initialization; precision.eft_selfcheck()
    warns if it was too late."""
    import os
    if os.environ.get("JAX_PLATFORMS", "").split(",") == ["cpu"]:
        flags = os.environ.get("XLA_FLAGS", "")
        if "--xla_disable_hlo_passes=fusion" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_disable_hlo_passes=fusion").strip()


_cpu_eft_guard()

from . import analysis, formats, precision
from .formats import COOMatrix, CSRMatrix, build_ellr, coo_to_csr
from .precision import (DF, DF64, FP32, BF16, FP32_FTZ, Policy, get_policy,
                        downcast_check, ftz)

__version__ = "0.1.0"


def __getattr__(name):
    # lazy imports for modules that pull in jax-heavy deps
    if name in ("solve", "dist", "dist_lu", "dist_snlu", "dist_snlu_sub",
                "timing", "kernels", "bench", "io"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'respatpu' has no attribute {name!r}")


__all__ = [
    "COOMatrix", "CSRMatrix", "build_ellr", "coo_to_csr",
    "DF", "DF64", "FP32", "BF16", "FP32_FTZ", "Policy", "get_policy",
    "downcast_check", "ftz",
    "analysis", "formats", "precision",
    "solve", "dist", "dist_lu", "dist_snlu", "dist_snlu_sub", "timing",
    "kernels", "bench", "io",
]
