"""Ozaki-scheme df64 matrix multiplication on bf16 matrix units.

The double-float (emulated fp64) dense kernels in dflinalg.py run as
elementwise error-free transforms at ~30x fp32 flop cost, because a matrix
unit's fp32 accumulation rounds, breaking error-free transforms. The Ozaki
splitting (Ozaki, Ogita, Oishi, Rump, "Error-free transformations of matrix
multiplication...", Numer. Alg. 2012) restores exactness on bf16 matrix
products:

* each df64 operand is split into P slices of w=8 significand bits aligned to
  a per-row (A) / per-column (B) exponent grid, so every slice element is an
  integer multiple of its row/col unit with magnitude < 2^w;
* slice products are integers < 2^(2w), and a K-panel dot of them is an
  integer < K * 2^(2w); with w=8 and K <= 256 every partial sum fits fp32's
  24-bit significand EXACTLY -- bf16 x bf16 -> fp32 matmuls (cuBLAS or
  XLA's own GEMM on the GPU's tensor cores) are error-free;
* the ~P^2/2 slice-product matrices are rescaled by outer(row_unit, col_unit)
  and accumulated elementwise in double-float (cheap: O(n^2), not O(n^3)).

Accuracy model: ~2^-(w*P) relative to row_max(A) * col_max(B) per output
(like fp64 for graded matrices; elements tiny relative to their row/col max
lose relative precision, the scheme's standard caveat).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import precision as prec
from ..precision import DF

__all__ = ["ozaki_matmul", "OZAKI_SLICES"]

W = 8  # slice significand width; K-panels of <=256 accumulate exactly
OZAKI_SLICES = 7  # covers ~56 bits > df64's ~49
_KPANEL = 256


def _split_slices(x: DF, axis: int, nslices: int):
    """Split df64 values into integer-mantissa slices along row/col grids.

    Returns (mants, units): mants[p] holds integers in [-(2^W), 2^W] (exact in
    bf16), units[p] the per-row/col scale such that
    x ~= sum_p mants[p] * units[p] (broadcast along ``axis``).
    """
    # per-row (axis=1 reduces cols) or per-col exponent of the max magnitude
    amax = jnp.max(jnp.abs(x.hi), axis=axis, keepdims=True)
    amax = jnp.where(amax > 0, amax, 1.0)
    # tau = smallest power of two >= amax, computed EXACTLY via exponent-bit
    # manipulation (exp2(ceil(log2(x))) through libm is off by ~1 ulp, which
    # silently destroys the exact power-of-two grid the whole scheme needs)
    bits = jax.lax.bitcast_convert_type(amax, jnp.int32)
    p2_bits = bits & jnp.int32(0x7F800000)  # clear sign+mantissa
    p2 = jax.lax.bitcast_convert_type(p2_bits, jnp.float32)  # 2^floor(log2)
    tau = jnp.where(amax == p2, p2, 2.0 * p2)
    r = x
    mants = []
    units = []
    for p in range(nslices):
        unit = tau * (2.0 ** (-W * (p + 1)))
        # m = round(r.hi / unit): division by a power of two and rounding to
        # an integer <= 2^W are exact in fp32; the df remainder keeps the tail
        m = jnp.round(r.hi / unit)
        contrib = m * unit  # exact (integer times power-of-two unit)
        r = prec.df_sub(r, DF(contrib, jnp.zeros_like(contrib)))
        mants.append(m)
        units.append(unit)
    return mants, units


@functools.partial(jax.jit, static_argnames=("nslices",))
def ozaki_matmul(a: DF, b: DF, nslices: int = OZAKI_SLICES) -> DF:
    """C = A @ B for df64 operands using exact bf16 matmuls."""
    m, k = a.hi.shape
    k2, n = b.hi.shape
    assert k == k2
    am, au = _split_slices(a, axis=1, nslices=nslices)  # row units [m,1]
    bm, bu = _split_slices(b, axis=0, nslices=nslices)  # col units [1,n]

    # K-panel split so integer accumulation stays exact
    npanels = -(-k // _KPANEL)
    kpad = npanels * _KPANEL

    def pad_k(x, axis):
        padw = [(0, 0), (0, 0)]
        padw[axis] = (0, kpad - k)
        return jnp.pad(x, padw)

    am_p = [pad_k(x, 1).reshape(m, npanels, _KPANEL).transpose(1, 0, 2)
            for x in am]  # [npanels, m, K]
    bm_p = [pad_k(x, 0).reshape(npanels, _KPANEL, n) for x in bm]

    acc = DF(jnp.zeros((m, n), jnp.float32), jnp.zeros((m, n), jnp.float32))
    # accumulate slice pairs from smallest to largest magnitude for stability
    pairs = [(p, q) for p in range(nslices) for q in range(nslices)
             if p + q <= nslices]
    pairs.sort(key=lambda pq: -(pq[0] + pq[1]))
    for p, q in pairs:
        # exact integer matmul per panel: bf16 inputs, fp32 accumulation
        prod = jax.lax.dot_general(
            am_p[p].astype(jnp.bfloat16), bm_p[q].astype(jnp.bfloat16),
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)  # [npanels, m, n]
        # panel sums are exact integers; combine panels in df
        scale = au[p] * bu[q]  # [m,1]*[1,n] -> broadcast outer scale (exact:
        # both factors are power-of-two grids)
        if npanels == 1:
            acc = prec.df_add(acc, prec.df_mul_f32(DF(scale, jnp.zeros_like(scale)),
                                                   prod[0]))
        else:
            tot = DF(jnp.zeros((m, n), jnp.float32), jnp.zeros((m, n), jnp.float32))
            for pi in range(npanels):
                tot = prec.df_add(tot, DF(prod[pi], jnp.zeros_like(prod[pi])))
            acc = prec.df_add(acc, prec.df_mul(tot, DF(scale, jnp.zeros_like(scale))))
    return acc
