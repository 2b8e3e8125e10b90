#!/usr/bin/env python
"""SpMV benchmark: fp32 SpMV time and fraction of device-memory speed of light.

Runs on a GPU only (it exits non-zero elsewhere) and prints exactly ONE JSON
line on stdout:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

Headline: the unstructured FEM-class matrix 2cubes_sphere on the
``fmt="auto"`` path, measured against the CSR byte model (rowptr + colidx +
vals + x + y read/write once) and the published HBM bandwidth of the device
(``timing.DEVICE_PEAKS``). Formats that store more than CSR (ELL) can only
score < 1 against that model. The stencil-class DIA path (which stores less
than CSR) and the circuit-class matrix dc1 are reported to stderr as
diagnostic rows, as is a measured streaming read rate. The moderate-group
operands fit in the H100's 50 MB L2 cache, so these are L2-warm numbers.
Timing: ``respatpu.timing.chained_time``.
"""
import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from respatpu.bench.corpus import load_matrix
    from respatpu.bench.synth import laplacian_3d
    from respatpu.config import enable_compile_cache
    from respatpu.kernels.spmv import to_device, spmv
    from respatpu.timing import chained_time, device_hbm_bw, \
        spmv_csr_sol_bytes, stream_bandwidth

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        log(f"bench.py needs a GPU; JAX has {jax.devices()}")
        sys.exit(2)
    enable_compile_cache()
    log(f"devices: {jax.devices()}  kind: {dev0.device_kind}")
    hbm = device_hbm_bw(dev0)
    log(f"measured streaming read: {stream_bandwidth() / 1e9:.0f} GB/s "
        f"(published peak {hbm / 1e9:.0f} GB/s)")

    # ---- headline: corpus-representative unstructured FEM matrix ----
    a, synth = load_matrix("2cubes_sphere")
    n = a.shape[0]
    log(f"matrix: 2cubes_sphere n={n} nnz={a.nnz} synthetic={synth}")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)
    csr_bytes = spmv_csr_sol_bytes(n, a.nnz)

    value = None
    for fmt in ("auto", "bell", "rgell"):
        dev = to_device(a, "fp32", fmt=fmt)
        t = chained_time(lambda xx, dd: spmv(dd, xx), x, operands=(dev,))
        frac = csr_bytes / t / hbm
        log(f"spmv fp32 [{fmt}={type(dev).__name__}]: {t*1e6:.2f} us/op, "
            f"{a.nnz/t/1e9:.2f} Gnnz/s, CSR-model SoL fraction {frac:.3f}")
        if fmt == "auto":
            value = frac

    # ---- diagnostic: stencil-class DIA path (own byte model) ----
    big = laplacian_3d(110, 110, 110)
    devb = to_device(big, "fp32", fmt="auto")
    xb = jnp.asarray(np.random.default_rng(1).standard_normal(big.shape[0]),
                     jnp.float32)
    tb = chained_time(lambda xx, dd: spmv(dd, xx), xb, operands=(devb,))
    # DIA stores no indices: bytes = vals(+pad) + x + y
    dia_bytes = big.nnz * 4 + 2 * big.shape[0] * 4
    log(f"spmv fp32 (lap3d nnz={big.nnz}, auto={type(devb).__name__}): "
        f"{tb*1e3:.4f} ms, {big.nnz/tb/1e9:.2f} Gnnz/s, "
        f"DIA-model SoL fraction {dia_bytes/tb/hbm:.3f}, "
        f"CSR-model {spmv_csr_sol_bytes(big.shape[0], big.nnz)/tb/hbm:.3f}")

    # ---- diagnostic: circuit class ----
    c, synth_c = load_matrix("dc1")
    devc = to_device(c, "fp32", fmt="auto")
    xc = jnp.asarray(np.random.default_rng(2).standard_normal(c.shape[0]),
                     jnp.float32)
    tc = chained_time(lambda xx, dd: spmv(dd, xx), xc, operands=(devc,))
    log(f"spmv fp32 (dc1 nnz={c.nnz} synthetic={synth_c}, "
        f"auto={type(devc).__name__}): {tc*1e6:.2f} us, "
        f"{c.nnz/tc/1e9:.2f} Gnnz/s, CSR-model SoL fraction "
        f"{spmv_csr_sol_bytes(c.shape[0], c.nnz)/tc/hbm:.3f}")

    print(json.dumps({
        "metric": "spmv_fp32_unstructured_hbm_sol_fraction",
        "value": float(value),
        "unit": "fraction_of_hbm_sol",
        "device": {"platform": dev0.platform, "kind": dev0.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
