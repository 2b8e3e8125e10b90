"""Precision policies: fp32, bf16, and emulated fp64 (double-float), plus FTZ.

The reference switches precision at *compile time* via ``#define FLOAT``
(test_pardiso.c:16, test_mumps.c:10, GPU/spmv.cu:11) and toggles subnormal
flush-to-zero with MXCSR inline asm (test_pardiso.c:19-24) or ``nvcc
-ftz=true`` (GPU/Makefile:4-5). Here precision is a *runtime policy object*:
no recompiles, any kernel can run under any policy.

The "reference precision" path is double-float ("df64"): each logical fp64
number is an unevaluated sum hi+lo of two fp32 values, giving ~49 bits of
significand via error-free transformations (Dekker/Knuth/Veltkamp; see T. J.
Dekker, "A floating-point technique for extending the available precision",
1971). All ops below are branch-free elementwise jnp code that XLA fuses
into ordinary fp32 arithmetic; they must NOT be rewritten with
fast-math-style reassociation (JAX/XLA preserves FP semantics by default).
``eft_selfcheck`` verifies that the backend's compiler kept them exact.

FTZ: XLA on the GPU and the CPU keeps subnormals unless asked, so the
reference's fp32+FTZ configuration is the explicit ``ftz()`` flush that the
``fp32_ftz`` policy applies to values and vectors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "DF",
    "two_sum",
    "fast_two_sum",
    "two_prod",
    "df_from_f64",
    "df_to_f64",
    "df_from_f32",
    "df_add",
    "df_sub",
    "df_neg",
    "df_mul",
    "df_mul_f32",
    "df_div",
    "df_sum",
    "df_dot",
    "df_norm2",
    "ftz",
    "eft_selfcheck",
    "Policy",
    "FP32",
    "BF16",
    "DF64",
    "FP32_FTZ",
    "get_policy",
    "downcast_check",
    "FP32_MAX",
    "FP32_MIN_NORMAL",
]

FP32_MAX = float(np.finfo(np.float32).max)  # LAPACKE_slamch('O') equivalent, test_spmv.c:109
FP32_MIN_NORMAL = float(np.finfo(np.float32).tiny)

_EFT_CHECKED = False


def eft_selfcheck(warn: bool = True) -> bool:
    """Verify error-free transforms survive this backend's compiler.

    XLA:CPU's fusion emitter is known to miscompile EFT chains when broadcast
    operands are fused in (error terms collapse to ~fp32 accuracy); XLA's GPU
    backend keeps them exact. Returns True when df64 semantics are intact.
    Fix for CPU runs: add ``--xla_disable_hlo_passes=fusion`` to
    ``XLA_FLAGS`` *before* backend initialization.
    """
    import warnings

    x = np.asarray([[1.0 + 2.0 ** -12]], np.float64)
    y = np.asarray([[1.0 - 2.0 ** -12]], np.float64)

    def probe(xh, xl, yh, yl):
        # broadcast into the op like the real kernels do
        shape = (8, 8)
        bx = DF(jnp.broadcast_to(xh, shape), jnp.broadcast_to(xl, shape))
        by = DF(jnp.broadcast_to(yh, shape), jnp.broadcast_to(yl, shape))
        return df_mul(bx, by)

    xh = x.astype(np.float32)
    xl = (x - xh).astype(np.float32)
    yh = y.astype(np.float32)
    yl = (y - yh).astype(np.float32)
    r = jax.jit(probe)(*map(jnp.asarray, (xh, xl, yh, yl)))
    got = float(np.asarray(r.hi, np.float64)[0, 0] + np.asarray(r.lo, np.float64)[0, 0])
    ok = abs(got - float(x[0, 0] * y[0, 0])) < 1e-12
    if not ok and warn:
        warnings.warn(
            "error-free transforms are being miscompiled on this backend; "
            "df64 (emulated fp64) results will only have fp32 accuracy. "
            "On CPU, set XLA_FLAGS='--xla_disable_hlo_passes=fusion' before "
            "jax initializes.", RuntimeWarning, stacklevel=2)
    return ok


def _ensure_eft_checked():
    """Run :func:`eft_selfcheck` once per process. On the GPU a failure
    raises: df64 results there would silently carry fp32 accuracy. On the
    CPU (tests, rehearsals) it warns, with the flag that fixes it."""
    global _EFT_CHECKED
    if _EFT_CHECKED:
        return
    on_gpu = jax.default_backend() == "gpu"
    if not eft_selfcheck(warn=not on_gpu):
        if on_gpu:
            raise RuntimeError(
                "error-free transforms are miscompiled on this GPU backend; "
                "df64 (emulated fp64) would only have fp32 accuracy")
    _EFT_CHECKED = True

# Veltkamp split constant for fp32: 2**12 + 1.  Kept as a python float
# (weak-typed, exact in fp32): a module-level jnp array would initialize
# the jax backend at import time, which breaks jax.distributed.initialize
# for multi-process users.
_SPLIT_C = 4097.0


class DF(NamedTuple):
    """Double-float number: value = hi + lo, |lo| <= ulp(hi)/2."""

    hi: jax.Array  # float32
    lo: jax.Array  # float32

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    def __add__(self, other):
        return df_add(self, _as_df(other))

    def __radd__(self, other):
        return df_add(_as_df(other), self)

    def __sub__(self, other):
        return df_sub(self, _as_df(other))

    def __rsub__(self, other):
        return df_sub(_as_df(other), self)

    def __mul__(self, other):
        return df_mul(self, _as_df(other))

    def __rmul__(self, other):
        return df_mul(_as_df(other), self)

    def __truediv__(self, other):
        return df_div(self, _as_df(other))

    def __neg__(self):
        return df_neg(self)

    def __getitem__(self, idx):
        return DF(self.hi[idx], self.lo[idx])


def _as_df(x) -> DF:
    if isinstance(x, DF):
        return x
    x = jnp.asarray(x)
    if x.dtype == jnp.float32:
        return DF(x, jnp.zeros_like(x))
    return df_from_f64_device(x)


def two_sum(a, b):
    """Knuth error-free addition: a+b = s+e exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker error-free addition, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _veltkamp_split(a):
    c = _SPLIT_C * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Dekker error-free product without FMA: a*b = p+e exactly."""
    p = a * b
    ah, al = _veltkamp_split(a)
    bh, bl = _veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# -- conversions -------------------------------------------------------------


def df_from_f64(x: np.ndarray) -> DF:
    """Host fp64 -> df64 (exact split on host, the canonical ingest path)."""
    _ensure_eft_checked()
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def df_from_f64_host(x: np.ndarray):
    """Host fp64 -> (hi, lo) numpy pair, for packing into device layouts."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_from_f64_device(x: jax.Array) -> DF:
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return DF(hi, lo)


def df_to_f64(x: DF) -> np.ndarray:
    """df64 -> host fp64 (for verification against scipy/numpy oracles)."""
    return np.asarray(jax.device_get(x.hi), dtype=np.float64) + np.asarray(
        jax.device_get(x.lo), dtype=np.float64)


def df_from_f32(x) -> DF:
    x = jnp.asarray(x, jnp.float32)
    return DF(x, jnp.zeros_like(x))


# -- arithmetic --------------------------------------------------------------


def df_add(x: DF, y: DF) -> DF:
    """Double-float addition (Knuth two-sum based, ~20 flops)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = fast_two_sum(s, e)
    e = e + f
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    """Double-float multiplication (Dekker two-prod based)."""
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f32(x: DF, y) -> DF:
    p, e = two_prod(x.hi, y)
    e = e + x.lo * y
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_div(x: DF, y: DF) -> DF:
    """Double-float division via Newton-refined reciprocal quotient."""
    q1 = x.hi / y.hi
    # r = x - q1*y, computed in df
    q1y = df_mul_f32(y, q1)
    r = df_sub(x, q1y)
    q2 = (r.hi + r.lo) / y.hi
    hi, lo = fast_two_sum(q1, q2)
    return DF(hi, lo)


def df_sum(x: DF, axis=None, keepdims=False) -> DF:
    """Summation in df64.

    Implemented as a binary-tree reduction over pairwise df_add via repeated
    halving (log-depth, deterministic), which keeps the error ~O(log n) ulps.
    """
    hi, lo = x.hi, x.lo
    if axis is None:
        hi = hi.ravel()
        lo = lo.ravel()
        axis = 0
    if axis < 0:
        axis += hi.ndim
    n = hi.shape[axis]
    # pad to power of two with zeros
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        pad = [(0, 0)] * hi.ndim
        pad[axis] = (0, p - n)
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
    v = DF(hi, lo)
    while v.hi.shape[axis] > 1:
        m = v.hi.shape[axis] // 2
        a = DF(jax.lax.slice_in_dim(v.hi, 0, m, axis=axis),
               jax.lax.slice_in_dim(v.lo, 0, m, axis=axis))
        b = DF(jax.lax.slice_in_dim(v.hi, m, 2 * m, axis=axis),
               jax.lax.slice_in_dim(v.lo, m, 2 * m, axis=axis))
        v = df_add(a, b)
    if not keepdims:
        v = DF(jnp.squeeze(v.hi, axis=axis), jnp.squeeze(v.lo, axis=axis))
    return v


def df_dot(x: DF, y: DF) -> DF:
    return df_sum(df_mul(x, y))


def df_norm2(x: DF) -> DF:
    s = df_dot(x, x)
    # sqrt via Newton on fp32 seed: r = sqrt(hi); refine r' = (r + s/r)/2 in df
    r0 = jnp.sqrt(s.hi)
    r0 = jnp.where(s.hi > 0, r0, jnp.zeros_like(r0))
    safe = jnp.where(r0 > 0, r0, jnp.ones_like(r0))
    q = df_div(s, DF(safe, jnp.zeros_like(safe)))
    r = df_mul_f32(df_add(q, DF(safe, jnp.zeros_like(safe))), jnp.float32(0.5))
    return DF(jnp.where(r0 > 0, r.hi, 0.0), jnp.where(r0 > 0, r.lo, 0.0))


# -- flush-to-zero -----------------------------------------------------------


def ftz(x, enabled: bool = True):
    """Explicit subnormal flush-to-zero (MXCSR FTZ|DAZ equivalent,
    test_pardiso.c:19-24). No-op when disabled."""
    if not enabled:
        return x
    if isinstance(x, DF):
        return DF(ftz(x.hi), ftz(x.lo))
    lim = jnp.asarray(np.finfo(np.dtype(x.dtype)).tiny, x.dtype)
    return jnp.where(jnp.abs(x) < lim, jnp.zeros_like(x), x)


# -- policies ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Policy:
    """Runtime precision policy: replaces the reference's per-precision
    recompile protocol (README.md:77-97)."""

    name: str
    dtype: object  # jnp dtype for single-word paths; None for df64
    double_word: bool = False
    flush_to_zero: bool = False

    def cast_values(self, v: np.ndarray):
        """Host fp64 values -> device representation under this policy."""
        if self.double_word:
            return df_from_f64(v)
        arr = jnp.asarray(np.asarray(v), dtype=self.dtype)
        return ftz(arr, self.flush_to_zero)

    def cast_host(self, v: np.ndarray):
        """Host fp64 -> host numpy arrays (hi[,lo]) for layout packing."""
        if self.double_word:
            return df_from_f64_host(v)
        out = np.asarray(v).astype(np.dtype(str(jnp.dtype(self.dtype))))
        if self.flush_to_zero:
            tiny = np.finfo(out.dtype).tiny if out.dtype.kind == "f" else 0
            out = np.where(np.abs(out) < tiny, 0, out)
        return (out,)

    @property
    def accum_dtype(self):
        return jnp.float32


FP32 = Policy("fp32", jnp.float32)
FP32_FTZ = Policy("fp32_ftz", jnp.float32, flush_to_zero=True)
BF16 = Policy("bf16", jnp.bfloat16)
DF64 = Policy("df64", None, double_word=True)

_POLICIES = {p.name: p for p in (FP32, FP32_FTZ, BF16, DF64)}
_POLICIES["fp64"] = DF64  # alias: the fp64 path is emulated


def get_policy(name: Union[str, Policy]) -> Policy:
    if isinstance(name, Policy):
        return name
    try:
        return _POLICIES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; "
                         f"available: {sorted(_POLICIES)}") from None


def downcast_check(values: np.ndarray, dtype=np.float32):
    """Overflow-guarded downcast (host), the corrected version of
    test_spmv.c:109-145 (which checks A's values where it means x).

    Returns (cast_array, n_overflow). Overflowing magnitudes are clamped to
    +-max_finite and counted, matching the reference's guard intent."""
    v = np.asarray(values, dtype=np.float64)
    fmax = np.finfo(dtype).max
    over = np.abs(v) > fmax
    n_over = int(over.sum())
    out = np.clip(v, -fmax, fmax).astype(dtype)
    return out, n_over
