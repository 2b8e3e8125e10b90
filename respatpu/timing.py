"""Measurement harness: device timings and roofline accounting.

The reference times phases with ``omp_get_wtime``/``cudaEvent`` pairs and
controls cache state with an LLC flush (test_pardiso.c:26-38,204-206,
GPU/spmv.cu:167-199). Here a timed op runs ``n`` times inside one jit with a
loop-carried data dependency (each iteration's input is perturbed by a
scalar derived from the full previous output, so no iteration can be elided
or reordered), and the wall clock closes over a host fetch of the final
scalar. The perturbation magnitude (1e-30) is far below the fp32 ulp of any
realistic operand, leaving the computed values unchanged. No LLC flush is
done: a moderate-group SpMV operand set (12-60 MB) fits in the H100's 50 MB
L2 cache or nearly so, so these times are L2-warm.
"""
from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .precision import DF

__all__ = ["chained_time", "stream_bandwidth", "spmv_sol_bytes",
           "spmv_csr_sol_bytes", "DEVICE_PEAKS", "device_peaks",
           "device_hbm_bw", "profile_trace"]

# Published peaks keyed by ``jax.Device.device_kind``: HBM bandwidth in
# bytes/s and capacity in bytes. Source: NVIDIA H100 Tensor Core GPU data
# sheet, SXM5 part (80 GB HBM3 at 3.35 TB/s).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "hbm_bytes": 80e9},
}


def device_peaks(device=None) -> dict:
    """Published peaks of ``device`` (default: the first JAX device).

    Raises KeyError for a device kind that is not in ``DEVICE_PEAKS``: a
    roofline share against a guessed peak would be meaningless."""
    kind = (device or jax.devices()[0]).device_kind
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}") from None


def device_hbm_bw(device=None) -> float:
    return device_peaks(device)["hbm_bytes_per_s"]


def chained_time(op: Callable, x0: jax.Array, operands: tuple = ()) -> float:
    """Seconds per call of ``op`` (fp32 array -> array/DF).

    ``operands``: extra pytrees (e.g. device-resident matrices) forwarded to
    ``op(x, *operands)`` as jit arguments, so large arrays are not embedded
    in the compiled program as constants.

    Per-op time is the slope versus an n=0 baseline (which holds the
    dispatch and fetch overhead), with n scaled until device work dominates
    host jitter. Returns NaN when the slope stays non-positive: the
    measurement failed and no time is reported for it.
    """

    @jax.jit
    def run(x, n, *ops_):
        # dynamic trip count: one compilation serves every loop length
        def body(i, carry):
            x_, acc = carry
            xp = x_ + acc    # additive scalar perturbation (cannot be hoisted
            y = op(xp, *ops_)  # past the nonlinear min-guard reduction below)
            if isinstance(y, DF):
                acc2 = jnp.minimum(jnp.sum(y.hi) + jnp.sum(y.lo), 3e38) * 1e-30
            else:
                acc2 = jnp.minimum(jnp.sum(y).astype(jnp.float32), 3e38) * 1e-30
            return (x_, acc2)
        return jax.lax.fori_loop(0, n, body, (x, jnp.float32(0.0)),
                                 unroll=False)[1]

    def timed(n, salt):
        xf = x0 + jnp.float32(1e-7 * salt)
        xf.block_until_ready()
        t0 = time.perf_counter()
        np.asarray(run(xf, n, *operands))  # host fetch ends the timing
        return time.perf_counter() - t0

    # compile once, measure dispatch/fetch overhead at n=0
    np.asarray(run(x0, 0, *operands))
    overhead = min(timed(0, 1), timed(0, 2))
    t8 = timed(8, 3) - overhead
    per_est = max(t8 / 8, 1e-7)
    # pick n so device work dominates overhead/jitter (~0.3 s of work); t8
    # is itself noisy for a microsecond op, so n grows while jitter still
    # swallows the work
    n_star = int(min(max(8, 0.3 / per_est), 2048))
    salt = 4
    while True:
        best = min(timed(n_star, salt), timed(n_star, salt + 1)) - overhead
        if best > 0 or n_star >= 1 << 16:
            break
        n_star, salt = n_star * 8, salt + 2
    return best / n_star if best > 0 else float("nan")


def stream_bandwidth(nbytes: int = 1 << 30) -> float:
    """Measured device-memory read bandwidth: one fused read pass over an
    n-float array per iteration (the multiply/add output is consumed by the
    harness reduction, so nothing is written back). The default 1 GiB is
    far beyond the L2 cache."""
    n = nbytes // 4
    x = jnp.ones(n, jnp.float32)

    def op(x_):
        return x_ * 1.0000001 + 0.5

    t = chained_time(op, x)
    return n * 4 / t


class profile_trace:
    """Context manager around ``jax.profiler.trace`` (SURVEY.md §5.1: the
    device-side counterpart of the reference's cudaEvent phase timers)."""

    def __init__(self, logdir: str):
        self.logdir = logdir

    def __enter__(self):
        jax.profiler.start_trace(self.logdir)
        return self

    def __exit__(self, *exc):
        jax.profiler.stop_trace()
        return False


def spmv_sol_bytes(n: int, nnz: int, nsub: int, k: int, dtype_bytes: int = 4) -> int:
    """Speed-of-light byte count for one ELL SpMV pass: values + column
    indices (padded layout) + x read + y write."""
    return nsub * k * (dtype_bytes + 4) + n * dtype_bytes + n * dtype_bytes


def spmv_csr_sol_bytes(n: int, nnz: int, dtype_bytes: int = 4) -> int:
    """Speed-of-light byte count for one *CSR-model* SpMV pass: rowptr +
    colidx + values + x read + y write, each touched exactly once. Formats
    storing more than CSR can only score < 1 against it; only index-free
    formats (DIA) may exceed 1 and must be reported against their own model
    instead."""
    return (n + 1) * 4 + nnz * 4 + nnz * dtype_bytes + 2 * n * dtype_bytes
