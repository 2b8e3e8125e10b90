"""Device numeric multifrontal LU: batched frontal partial-LU as dense GEMMs.

The numeric half of the supernodal pipeline (symbolic analysis lives in
kernels/snlu.py). This is the device-side answer to PARDISO phase 22
(test_pardiso.c:204-210) and SuperLU_MT's pdgssv/psgssv factorization
(test_superLU_MT.c:168-172) for large 3-D FEM patterns where the dense band
is memory-infeasible: every front is a *dense* matrix, so the O(fill^{3/2})
flops of the factorization run as batched dense GEMMs instead of scalar
sparse updates.

Design (all structure precomputed on host; device sees only static shapes):

  * one flat fp32 "front pool" holds every front, each padded to a bucket
    shape (wp pivot columns + rp update rows); original A entries land in it
    via a single host-side scatter (``FrontalPlan.asm_dst``), padded pivot
    diagonals get 1.0 so padding factorizes as identity,
  * fronts are processed level-by-level up the elimination tree; within a
    level they are grouped by bucket shape and factored as ONE batched
    blocked partial LU (`_factor_group`): panel rank-1 factor (elementwise,
    nb wide) + batched triangular solve + trailing-block GEMM,
  * the child Schur complements are scattered straight into the parents'
    pool slots with precomputed flat indices (`schur_src`/`schur_dst`) —
    the multifrontal extend-add as one `at[].add(mode="drop")`,
  * tiny pivots are perturbed PARDISO-style (test_pardiso.c:144-148) and
    counted; accuracy is recovered by df64 iterative refinement upstream
    (solve.solve_refined), which is the reference study's headline recipe.

The factored pool is pulled back once and re-scattered into the filled-CSR
value array (the inverse of the assembly map), so the existing blocked
triangular-solve machinery (kernels/sptrsv.py) serves the solve phase.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .snlu import SupernodePartition

__all__ = ["FrontalPlan", "build_frontal_plan", "frontal_factor_device",
           "frontal_factor_pool", "values_from_pool", "FrontalSolver"]


def _pad_dim(x: int) -> int:
    """Pad a front dimension to a small bucket schedule (x2/x1.5 ladder):
    few distinct shapes => few XLA compilations, modest zero padding.
    Beyond the ladder, pad to 2048-multiples — the next-power-of-two rule
    doubled an 11.6k root front's area (16384^2 vs 12288^2), the kind of
    waste that tips a circuit-class pool over its ceiling."""
    if x <= 0:
        return 0
    for v in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
              1536, 2048, 3072, 4096, 6144, 8192):
        if x <= v:
            return v
    return int(-(-x // 2048) * 2048)


def _pad_pow2(x: int, lo: int = 1) -> int:
    return int(max(lo, 2 ** np.ceil(np.log2(max(x, 1)))))


def _pad_batch(b: int, mp: int) -> int:
    """Batch-dimension pad for a (level, bucket) factor/solve group.

    Small fronts (mp <= 1024) quantize HARD to {8, 64, 512, 4096, ...}: the
    batch dim is the last data-dependent axis of the kernel cache key, and
    small-front groups recur at every tree level and in every corpus
    matrix, so a coarse ladder buys cross-level and cross-matrix compile
    reuse for at most 8x padded work on fronts whose work is trivial.
    Large fronts keep a tight pow2 (their [B, mp, mp] gathers are GiBs)."""
    if mp > 1024:
        return _pad_pow2(b)
    p = 8
    while p < b:
        p *= 8
    # never let ladder INFLATION (not the true batch size) push the
    # [B, mp, mp] front gather past ~1 GiB — fall back to tight pow2
    if p * mp * mp * 4 > 1 << 30 and _pad_pow2(b) < p:
        return _pad_pow2(b)
    return p


@dataclasses.dataclass
class _Group:
    """One batched factor call: fronts of equal bucket shape in one level."""
    level: int
    wp: int  # padded pivot width
    rp: int  # padded update-row count
    snodes: np.ndarray  # member supernode ids (unpadded)
    offs: np.ndarray  # int64[B_pad] pool offsets (pad rows -> pool_size)
    valid: np.ndarray  # bool[B_pad]
    schur_src: np.ndarray  # int[B_pad, K] flat positions inside the front
    schur_dst: np.ndarray  # int[B_pad, K] flat pool positions (pad -> drop)
    piv: np.ndarray = None  # int32[B_pad, wp] global pivot rows (pad -> n)
    rsx: np.ndarray = None  # int32[B_pad, rp] global update rows (pad -> n)

    @property
    def mp(self) -> int:
        return self.wp + self.rp


@dataclasses.dataclass
class FrontalPlan:
    """Host-precomputed static structure for the device numeric phase."""
    part: SupernodePartition
    pool_size: int
    off: np.ndarray  # int64[nsn] pool offset per front
    wp: np.ndarray  # int64[nsn]
    rp: np.ndarray  # int64[nsn]
    asm_src: np.ndarray  # filled.data index per assembled entry
    asm_dst: np.ndarray  # flat pool position per assembled entry
    ones_dst: np.ndarray  # padded-pivot diagonal positions (init to 1.0)
    groups: List[_Group]  # level-ordered batched factor calls


def build_frontal_plan(part: SupernodePartition,
                       max_pool_floats: int = 2**31) -> FrontalPlan:
    """Vectorized host analysis: pool layout, assembly scatter, extend-add
    maps, level/bucket grouping. Everything the device kernels need.

    ``max_pool_floats`` caps the single flat pool (default: the int32
    flat-index ceiling).  Problems past the cap must go through the
    subtree-sharded distributed plan (dist_snlu_sub.build_sharded_plan),
    whose per-device shards each stay under it."""
    n, nsn = part.n, part.nsn
    sp = part.snode_ptr
    w = np.diff(sp).astype(np.int64)
    r = np.array([rs.size for rs in part.rowstruct], dtype=np.int64)
    wp = np.array([_pad_dim(int(x)) for x in w], dtype=np.int64)
    rp = np.array([_pad_dim(int(x)) for x in r], dtype=np.int64)
    mp = wp + rp
    off = np.zeros(nsn + 1, dtype=np.int64)
    np.cumsum(mp * mp, out=off[1:])
    pool_size = int(off[-1])
    off = off[:-1]
    if pool_size + int((mp * mp).max(initial=0)) >= min(max_pool_floats, 2**31):
        raise MemoryError(
            f"front pool would need {pool_size/2**28:.1f} GiB fp32 "
            "(pool ceiling); partition over a mesh instead "
            "(dist_snlu_sub.DistSubtreeLu)")

    col2sn = np.repeat(np.arange(nsn, dtype=np.int64), w)

    # concatenated row structures with a globally-sorted key so that the
    # local position of row g inside snode s's structure is ONE searchsorted
    rs_ptr = np.zeros(nsn + 1, dtype=np.int64)
    np.cumsum(r, out=rs_ptr[1:])
    RS = (np.concatenate(part.rowstruct) if nsn and rs_ptr[-1] else
          np.empty(0, dtype=np.int64)).astype(np.int64)
    rs_sn = np.repeat(np.arange(nsn, dtype=np.int64), r)
    rs_keys = rs_sn * np.int64(n + 1) + RS

    def loc(sn: np.ndarray, g: np.ndarray) -> np.ndarray:
        """Local front position of global row/col g inside front sn."""
        in_piv = g < sp[sn + 1]
        key = sn * np.int64(n + 1) + g
        if rs_keys.size == 0:
            # no sub-diagonal fill anywhere (e.g. diagonal matrix): every
            # entry must sit inside its pivot block
            if not np.all(in_piv):
                raise AssertionError(
                    "entry outside pivot block but rowstruct is empty")
            return g - sp[sn]
        pos_rs = np.searchsorted(rs_keys, key)
        hit = rs_keys[np.minimum(pos_rs, rs_keys.size - 1)] == key
        if not np.all(in_piv | hit):
            raise AssertionError(
                "filled pattern is not structurally symmetric: an entry "
                "falls outside its front's row structure")
        return np.where(in_piv, g - sp[sn], wp[sn] + (pos_rs - rs_ptr[sn]))

    # ---- assembly map: every filled entry belongs to exactly one front ----
    f = part.filled
    rows = np.repeat(np.arange(n, dtype=np.int64), f.row_lengths())
    cols = f.indices.astype(np.int64)
    sni, snj = col2sn[rows], col2sn[cols]
    owner = np.minimum(sni, snj)  # the snode whose pivot block holds min(i,j)
    li, lj = loc(owner, rows), loc(owner, cols)
    asm_dst = off[owner] + li * mp[owner] + lj
    asm_src = np.arange(rows.size, dtype=np.int64)

    # padded pivot diagonal -> 1.0 (factors as identity, harmless)
    cnt = wp - w
    grp = np.repeat(np.arange(nsn, dtype=np.int64), cnt)
    base = np.zeros(nsn + 1, dtype=np.int64)
    np.cumsum(cnt, out=base[1:])
    within = np.arange(int(base[-1]), dtype=np.int64) - np.repeat(base[:-1], cnt)
    t = w[grp] + within
    ones_dst = off[grp] + t * mp[grp] + t

    # ---- extend-add maps + level/bucket groups ----
    idx_dtype = np.int64 if pool_size > 2**31 - 2 else np.int32
    groups: List[_Group] = []
    for lvl, members in enumerate(part.levels):
        members = np.asarray(members, dtype=np.int64)
        keys = wp[members] * np.int64(1 << 20) + rp[members]
        for key in np.unique(keys):
            sel = members[keys == key]
            gwp, grp_rp = int(wp[sel[0]]), int(rp[sel[0]])
            gmp = gwp + grp_rp
            B = sel.size
            # B padded to >= 8 (small fronts only): singleton/small groups
            # recur at every level of the upper tree with identical
            # (wp, mp); merging B in {1, 2, 4, 8} into one batch shape
            # collapses their compiles.  Large fronts keep tight B — an
            # 8x-padded [B, mp, mp] gather at mp=8192 would waste GiBs.
            Bp = _pad_batch(B, gmp)
            # extend-add map width fixed at rp^2 for SMALL fronts
            # (rp <= 128): with K a pure function of the bucket shape, the
            # jit cache key collapses to (wp, mp, B) for exactly the groups
            # that recur at every tree level and corpus matrix, so each
            # distinct shape compiles once.  Larger fronts keep the
            # live-width pow2: an rp^2 map at rp=512 x B=512 is a 1 GiB
            # index upload per group.  Groups with
            # no parent edges take K=1.
            kr = max((part.rowstruct[s].size
                      if part.sn_parent[s] >= 0 else 0 for s in sel),
                     default=0)
            if kr == 0:
                K = 1
            elif grp_rp <= 128:
                K = grp_rp * grp_rp
            else:
                K = _pad_pow2(kr * kr)
            offs = np.full(Bp, pool_size, dtype=np.int64)
            offs[:B] = off[sel]
            valid = np.zeros(Bp, dtype=bool)
            valid[:B] = True
            src = np.zeros((Bp, K), dtype=idx_dtype)
            dst = np.full((Bp, K), pool_size, dtype=idx_dtype)
            # solve-phase index arrays (pad -> n, the RHS scratch slot):
            # the frontal triangular solves read/write the vector straight
            # through these, so factors never leave the pool
            piv = np.full((Bp, gwp), n, dtype=np.int32)
            rsx = np.full((Bp, grp_rp), n, dtype=np.int32)
            for bi, s in enumerate(sel):
                j0, j1 = int(sp[s]), int(sp[s + 1])
                piv[bi, :j1 - j0] = np.arange(j0, j1)
                rs = part.rowstruct[s]
                if rs.size:
                    rsx[bi, :rs.size] = rs
                p = part.sn_parent[s]
                if rs.size == 0 or p < 0:
                    continue
                lp = loc(np.full(rs.size, p, dtype=np.int64), rs)
                a = np.arange(rs.size, dtype=np.int64)
                sflat = ((gwp + a)[:, None] * gmp + (gwp + a)[None, :])
                dflat = off[p] + lp[:, None] * mp[p] + lp[None, :]
                box = np.zeros((kr, kr), dtype=idx_dtype)
                box[:rs.size, :rs.size] = sflat
                src[bi, :box.size] = box.ravel()
                dbox = np.full((kr, kr), pool_size, dtype=idx_dtype)
                dbox[:rs.size, :rs.size] = dflat
                dst[bi, :dbox.size] = dbox.ravel()
            groups.append(_Group(level=lvl, wp=gwp, rp=grp_rp, snodes=sel,
                                 offs=offs, valid=valid,
                                 schur_src=src, schur_dst=dst,
                                 piv=piv, rsx=rsx))

    return FrontalPlan(part=part, pool_size=pool_size, off=off, wp=wp, rp=rp,
                       asm_src=asm_src, asm_dst=asm_dst, ones_dst=ones_dst,
                       groups=groups)


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("wp", "mp", "nb"), donate_argnums=(0,))
def _factor_group(pool, offs, valid, schur_src, schur_dst, eps,
                  wp: int, mp: int, nb: int):
    """Gather a batch of fronts, blocked partial LU over the first ``wp``
    pivots, write factors back, scatter-add the Schur blocks to parents.

    Per panel: nb rank-1 pivot steps on the [B, mp, nb] panel, a batched
    unit-lower triangular solve for the U rows, and ONE batched
    [B, mp, nb] x [B, nb, mp] trailing GEMM — the masked right-looking
    update. Padding rows/cols are zero (pad pivots have diag >= eps from
    assembly, so they never count as perturbed) and factor as identity.

    All matmuls run at HIGHEST precision: by default an fp32 matmul on the
    GPU may run in TF32 (about three decimal digits), which would silently
    degrade the numeric factorization, where all the error accumulation
    lives.
    """
    with jax.default_matmul_precision("highest"):
        return _factor_group_body(pool, offs, valid, schur_src, schur_dst,
                                  eps, wp, mp, nb)


def _factor_fronts(F, eps, wp: int, mp: int, nb: int):
    """Blocked batched partial LU of gathered fronts [B, mp, mp] (see
    _factor_group docstring). Returns (factored fronts, per-front bad-pivot
    counts). Pure front math — shared by the single-chip and the
    mesh-sharded (dist_snlu) drivers."""
    B = F.shape[0]
    rowpos = jnp.arange(mp)
    npanels = wp // nb

    panelpos = jnp.arange(nb)

    def panel(carry, kb):
        F, cnt = carry
        k = kb * nb
        P = jax.lax.dynamic_slice(F, (0, 0, k), (B, mp, nb))

        # pivot steps as a fori_loop with column masks (NOT a python unroll:
        # nb=32 unrolled dynamic slices blow the HLO up ~30x, and every
        # distinct (B, wp, mp) group shape re-pays that compile — the
        # dominant cost of factoring circuit-class patterns with many
        # bucket shapes).  The masked rank-1 update touches all nb panel
        # columns but zeroes the already-factored ones, so the math is
        # identical to the shrinking-slice form.
        def pivot_step(tloc, pc):
            P, cnt = pc
            c = k + tloc
            sel = (rowpos == c).astype(P.dtype)  # [mp] one-hot pivot row
            col = jax.lax.dynamic_slice(P, (0, 0, tloc), (B, mp, 1))[..., 0]
            d = col @ sel  # [B] pivot value
            bad = jnp.abs(d) < eps
            cnt = cnt + bad.astype(jnp.int32)
            d = jnp.where(bad, jnp.where(d >= 0, eps, -eps), d)
            lmask = (rowpos > c)[None, :]
            newcol = jnp.where(lmask, col / d[:, None],
                               jnp.where(rowpos[None, :] == c, d[:, None], col))
            P = jax.lax.dynamic_update_slice(P, newcol[..., None],
                                             (0, 0, tloc))
            lcol = jnp.where(lmask, newcol, 0.0)  # [B, mp]
            urow = jnp.einsum("bmt,m->bt", P, sel,
                              precision=jax.lax.Precision.HIGHEST)
            upd = lcol[:, :, None] * urow[:, None, :]
            P = P - upd * (panelpos > tloc)[None, None, :]
            return P, cnt

        P, cnt = jax.lax.fori_loop(0, nb, pivot_step, (P, cnt))
        F = jax.lax.dynamic_update_slice(F, P, (0, 0, k))
        # U panel rows: rows k..k+nb, columns beyond the panel
        L11 = jax.lax.dynamic_slice(P, (0, k, 0), (B, nb, nb))
        R = jax.lax.dynamic_slice(F, (0, k, 0), (B, nb, mp))
        U = jax.lax.linalg.triangular_solve(L11, R, left_side=True,
                                            lower=True, unit_diagonal=True)
        colmask = (rowpos >= k + nb)[None, None, :]
        Rn = jnp.where(colmask, U, R)
        F = jax.lax.dynamic_update_slice(F, Rn, (0, k, 0))
        # trailing update (one batched GEMM)
        Lblk = jnp.where((rowpos >= k + nb)[None, :, None], P, 0.0)
        Ublk = jnp.where(colmask, Rn, 0.0)
        F = F - Lblk @ Ublk
        return (F, cnt), None

    # derive the counter init from F so its sharding/vma matches the carry
    # when this runs inside shard_map (a plain zeros() is "unvarying" and
    # trips the scan carry check)
    cnt0 = (F[:, 0, 0] * 0).astype(jnp.int32)
    (F, cnt), _ = jax.lax.scan(panel, (F, cnt0), jnp.arange(npanels))
    return F, cnt


def _factor_group_body(pool, offs, valid, schur_src, schur_dst, eps,
                       wp: int, mp: int, nb: int):
    B = offs.shape[0]
    gidx = offs[:, None] + jnp.arange(mp * mp, dtype=offs.dtype)[None, :]
    F = jnp.take(pool, gidx, mode="fill", fill_value=0.0).reshape(B, mp, mp)
    F, cnt = _factor_fronts(F, eps, wp, mp, nb)
    Ff = F.reshape(B, mp * mp)
    pool = pool.at[gidx].set(Ff, mode="drop")
    sv = jnp.take_along_axis(Ff, schur_src, axis=1)
    pool = pool.at[schur_dst.reshape(-1)].add(sv.reshape(-1), mode="drop")
    nbad = jnp.sum(cnt * valid.astype(jnp.int32))
    return pool, nbad


def _pick_nb(wp: int) -> int:
    for nb in (32, 16, 8):
        if wp % nb == 0:
            return nb
    return 8


def frontal_factor_pool(plan: FrontalPlan,
                        pivot_eps: Optional[float] = None
                        ) -> Tuple[jax.Array, int]:
    """Run the numeric multifrontal factorization on device; the factored
    front pool STAYS device-resident (the frontal solver consumes it in
    place — no host round trip, no CSR extraction).

    Returns ``(pool, n_pivot_perturbed)``.
    """
    part = plan.part
    f = part.filled
    if pivot_eps is None:
        amax = float(np.abs(f.data).max()) if f.nnz else 1.0
        pivot_eps = 1e-4 * max(amax, 1.0)  # PARDISO fp32 default (iparm[9])
    pool_np = np.zeros(plan.pool_size, dtype=np.float32)
    pool_np[plan.asm_dst] = f.data
    # padding pivots factor as scalars; init them above the perturbation
    # threshold so they are never counted as perturbed (their rows/cols are
    # zero, so any value >= eps is numerically inert)
    pool_np[plan.ones_dst] = max(1.0, pivot_eps * 1.001)
    pool = jnp.asarray(pool_np)
    eps = jnp.float32(pivot_eps)
    nbad = []  # device scalars; fetched once at the end (no per-group sync)
    cached_bytes = sum(g.schur_src.nbytes * 2 for g in plan.groups
                       if getattr(g, "dev_factor", None) is not None)
    inflight = 0
    for g in plan.groups:
        dev = getattr(g, "dev_factor", None)
        if dev is None:
            dev = (jnp.asarray(g.offs), jnp.asarray(g.valid),
                   jnp.asarray(g.schur_src), jnp.asarray(g.schur_dst))
            # device copies cached on the group so warm refactorization
            # (the phase-22 measurement) skips re-uploads — but only up to
            # a 1 GiB budget: a catalogue-size circuit tree's full map set
            # can outgrow device memory.  Past the budget, uploads stream
            # and are freed once their dispatch executes.
            sz = g.schur_src.nbytes * 2
            if cached_bytes + sz <= 1 << 30:
                g.dev_factor = dev
                cached_bytes += sz
            else:
                inflight += sz
        pool, cnt = _factor_group(pool, *dev, eps,
                                  wp=g.wp, mp=g.mp, nb=_pick_nb(g.wp))
        nbad.append(cnt)
        dev = None  # drop the streaming ref before the next upload
        if inflight > 512 << 20:
            # dispatch is async: without a drain, the host loop uploads
            # EVERY remaining group's maps before the device frees any.
            # One fence per ~512 MiB of streamed maps bounds the queue.
            jax.block_until_ready(pool)
            inflight = 0
    return pool, int(sum(int(c) for c in jax.device_get(nbad)))


def values_from_pool(plan: FrontalPlan, pool) -> np.ndarray:
    """Factored entries in ``plan.part.filled.data`` layout (host fp64, fp32
    accuracy) — for persistence, condest fallbacks, and the df64 blocked
    triangular solvers.  One host pull of the pool; the gather runs on
    host, next to the host fp64 consumers."""
    vals = np.asarray(jax.device_get(pool), dtype=np.float64)[plan.asm_dst]
    out = np.zeros(plan.part.filled.nnz, dtype=np.float64)
    out[plan.asm_src] = vals
    return out


def frontal_factor_device(plan: FrontalPlan,
                          pivot_eps: Optional[float] = None
                          ) -> Tuple[np.ndarray, int]:
    """Factor on device and pull the values back (the round-4 flow; kept for
    the df64/bf16 apply paths that build blocked triangular solvers)."""
    pool, nbad = frontal_factor_pool(plan, pivot_eps=pivot_eps)
    return values_from_pool(plan, pool), nbad


# ---------------------------------------------------------------------------
# Frontal triangular solves (device, straight from the factored pool)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("wp", "mp"))
def _fwd_group(y, pool, offs, piv, rsx, wp: int, mp: int):
    """Forward substitution L y = b over one (level, bucket) group.

    ``y`` is the permuted RHS with one scratch slot at index n (padded piv/
    rsx rows point there; ``mode="drop"`` scatters discard pad writes)."""
    gidx = offs.astype(jnp.int32)[:, None] \
        + jnp.arange(mp * mp, dtype=jnp.int32)[None, :]
    F = jnp.take(pool, gidx, mode="fill", fill_value=0.0).reshape(-1, mp, mp)
    L11 = F[:, :wp, :wp]
    L21 = F[:, wp:, :wp]
    yp = jnp.take(y, piv, mode="fill", fill_value=0.0)  # [B, wp]
    with jax.default_matmul_precision("highest"):
        z = jax.lax.linalg.triangular_solve(
            L11, yp[..., None], left_side=True, lower=True,
            unit_diagonal=True)[..., 0]
        upd = -jnp.einsum("brw,bw->br", L21, z,
                          precision=jax.lax.Precision.HIGHEST)
    y = y.at[piv.reshape(-1)].add((z - yp).reshape(-1), mode="drop")
    y = y.at[rsx.reshape(-1)].add(upd.reshape(-1), mode="drop")
    return y


@partial(jax.jit, static_argnames=("wp", "mp"))
def _bwd_group(y, pool, offs, piv, rsx, wp: int, mp: int):
    """Backward substitution U x = y over one group (descending order)."""
    gidx = offs.astype(jnp.int32)[:, None] \
        + jnp.arange(mp * mp, dtype=jnp.int32)[None, :]
    F = jnp.take(pool, gidx, mode="fill", fill_value=0.0).reshape(-1, mp, mp)
    U11 = F[:, :wp, :wp]
    U12 = F[:, :wp, wp:]
    yp = jnp.take(y, piv, mode="fill", fill_value=0.0)
    yr = jnp.take(y, rsx, mode="fill", fill_value=0.0)
    with jax.default_matmul_precision("highest"):
        rhs = yp - jnp.einsum("bwr,br->bw", U12, yr,
                              precision=jax.lax.Precision.HIGHEST)
        dpos = jnp.arange(wp)
        diag = U11[:, dpos, dpos]  # padded fronts gather 0 -> make it 1
        U11 = U11.at[:, dpos, dpos].set(jnp.where(diag == 0, 1.0, diag))
        z = jax.lax.linalg.triangular_solve(
            U11, rhs[..., None], left_side=True, lower=False,
            unit_diagonal=False)[..., 0]
    return y.at[piv.reshape(-1)].add((z - yp).reshape(-1), mode="drop")


@partial(jax.jit, static_argnames=("wp", "mp"))
def _fwd_group_t(y, pool, offs, piv, rsx, wp: int, mp: int):
    """Forward substitution U^T z = s (U^T is lower, non-unit): ascending
    groups; (U^T)[rsx, piv] = U12^T couples pivots into later rows."""
    gidx = offs.astype(jnp.int32)[:, None] \
        + jnp.arange(mp * mp, dtype=jnp.int32)[None, :]
    F = jnp.take(pool, gidx, mode="fill", fill_value=0.0).reshape(-1, mp, mp)
    U11 = F[:, :wp, :wp]
    U12 = F[:, :wp, wp:]
    yp = jnp.take(y, piv, mode="fill", fill_value=0.0)
    with jax.default_matmul_precision("highest"):
        dpos = jnp.arange(wp)
        diag = U11[:, dpos, dpos]
        U11 = U11.at[:, dpos, dpos].set(jnp.where(diag == 0, 1.0, diag))
        z = jax.lax.linalg.triangular_solve(
            U11, yp[..., None], left_side=True, lower=False,
            transpose_a=True, unit_diagonal=False)[..., 0]
        upd = -jnp.einsum("bwr,bw->br", U12, z,
                          precision=jax.lax.Precision.HIGHEST)
    y = y.at[piv.reshape(-1)].add((z - yp).reshape(-1), mode="drop")
    y = y.at[rsx.reshape(-1)].add(upd.reshape(-1), mode="drop")
    return y


@partial(jax.jit, static_argnames=("wp", "mp"))
def _bwd_group_t(y, pool, offs, piv, rsx, wp: int, mp: int):
    """Backward substitution L^T w = z (L^T is unit-upper): descending;
    (L^T)[piv, rsx] = L21^T pulls later rows into the pivot block."""
    gidx = offs.astype(jnp.int32)[:, None] \
        + jnp.arange(mp * mp, dtype=jnp.int32)[None, :]
    F = jnp.take(pool, gidx, mode="fill", fill_value=0.0).reshape(-1, mp, mp)
    L11 = F[:, :wp, :wp]
    L21 = F[:, wp:, :wp]
    yp = jnp.take(y, piv, mode="fill", fill_value=0.0)
    yr = jnp.take(y, rsx, mode="fill", fill_value=0.0)
    with jax.default_matmul_precision("highest"):
        rhs = yp - jnp.einsum("brw,br->bw", L21, yr,
                              precision=jax.lax.Precision.HIGHEST)
        z = jax.lax.linalg.triangular_solve(
            L11, rhs[..., None], left_side=True, lower=True,
            transpose_a=True, unit_diagonal=True)[..., 0]
    return y.at[piv.reshape(-1)].add((z - yp).reshape(-1), mode="drop")


class FrontalSolver:
    """Triangular solves straight from the device-resident factored pool.

    This is the PARDISO phase-33 path (test_pardiso.c:241-244) for the
    multifrontal factorization, and the fix for the round-4 circuit-class
    refusals: the chunked SpTRSV (analysis.build_tri_chunks) pads every slot
    to the WIDEST factor row — one ~24k-wide hub-coupled row demanded
    393 GiB — while the frontal solve touches only the dense front blocks
    that already exist in the pool.  Wide rows are just rows of a dense
    front here; no padding amplification anywhere.

    Dispatch is one cached-jit call per (level, bucket) group: the group
    kernels are keyed only by (wp, mp, B) so their compiles are shared
    across groups, matrices, and rounds of a sweep (a fused whole-phase jit
    would recompile per matrix, at 40+ shapes per matrix).
    """

    def __init__(self, plan: FrontalPlan, pool):
        self.plan = plan
        self.pool = pool  # device fp32 [pool_size]
        self.n = plan.part.n
        self._arrs = [(jnp.asarray(g.offs), jnp.asarray(g.piv),
                       jnp.asarray(g.rsx)) for g in plan.groups]

    def _run(self, y, kern, forward: bool):
        order = range(len(self.plan.groups))
        if not forward:
            order = reversed(order)
        for gi in order:
            g = self.plan.groups[gi]
            offs, piv, rsx = self._arrs[gi]
            y = kern(y, self.pool, offs, piv, rsx, wp=g.wp, mp=g.mp)
        return y

    def solve_device(self, bp):
        """Solve L U x = bp in permuted coordinates (device fp32 [n])."""
        y = jnp.concatenate([bp.astype(jnp.float32), jnp.zeros(1, jnp.float32)])
        y = self._run(y, _fwd_group, forward=True)
        y = self._run(y, _bwd_group, forward=False)
        return y[:self.n]

    def solve_t_device(self, sp):
        """Solve (L U)^T w = sp in permuted coordinates: U^T then L^T."""
        y = jnp.concatenate([sp.astype(jnp.float32), jnp.zeros(1, jnp.float32)])
        y = self._run(y, _fwd_group_t, forward=True)
        y = self._run(y, _bwd_group_t, forward=False)
        return y[:self.n]
