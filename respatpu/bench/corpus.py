"""The 36-matrix SuiteSparse corpus registry (README.md:110-155,
bench_consts.h:8-46) with synthetic stand-ins for network-less environments.

Real ``.mtx`` files are used when present under ``matrices/<group>/<name>/``
(same tree the reference's fetch scripts produce,
matrices/moderate/getModerateSizeMatrices.sh); otherwise a deterministic
synthetic matrix with matching size/structure class is generated so sweeps
and benchmarks always run. Synthetic substitution is reported in results.
"""
from __future__ import annotations

import os
import zlib
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..formats import CSRMatrix
from .synth import synth_like

__all__ = ["CorpusEntry", "MODERATE", "BIG", "ALL", "load_matrix", "matrix_path"]


@dataclass(frozen=True)
class CorpusEntry:
    name: str
    group: str  # moderate | big
    n: int
    nnz: int
    kind: str  # fem | grid2d | circuit | banded
    spd: bool = False


# n/nnz are SuiteSparse catalogue values (approximate where noted); they size
# the synthetic stand-ins and the roofline model.
MODERATE: List[CorpusEntry] = [
    CorpusEntry("2cubes_sphere", "moderate", 101492, 1647264, "fem", True),
    CorpusEntry("ASIC_320ks", "moderate", 321671, 1316085, "circuit"),
    CorpusEntry("Baumann", "moderate", 112211, 748331, "fem"),
    CorpusEntry("cfd2", "moderate", 123440, 3085406, "fem", True),
    CorpusEntry("crashbasis", "moderate", 160000, 1750416, "fem"),
    CorpusEntry("ct20stif", "moderate", 52329, 2600295, "fem", True),
    CorpusEntry("dc1", "moderate", 116835, 766396, "circuit"),
    CorpusEntry("Dubcova3", "moderate", 146689, 3636643, "fem", True),
    CorpusEntry("ecology2", "moderate", 999999, 4995991, "grid2d", True),
    CorpusEntry("FEM_3D_thermal2", "moderate", 147900, 3489300, "fem"),
    CorpusEntry("G2_circuit", "moderate", 150102, 726674, "circuit", True),
    CorpusEntry("Goodwin_095", "moderate", 100037, 3226066, "fem"),
    CorpusEntry("matrix-new_3", "moderate", 125329, 893984, "fem"),
    CorpusEntry("offshore", "moderate", 259789, 4242673, "fem", True),
    CorpusEntry("para-10", "moderate", 155924, 2094873, "fem"),
    CorpusEntry("parabolic_fem", "moderate", 525825, 3674625, "fem", True),
    CorpusEntry("ss1", "moderate", 205282, 845089, "circuit"),
    CorpusEntry("stomach", "moderate", 213360, 3021648, "fem"),
    CorpusEntry("thermomech_TK", "moderate", 102158, 711558, "fem", True),
    CorpusEntry("tmt_unsym", "moderate", 917825, 4584801, "grid2d"),
    CorpusEntry("xenon2", "moderate", 157464, 3866688, "fem"),
]

BIG: List[CorpusEntry] = [
    CorpusEntry("af_shell10", "big", 1508065, 52259885, "fem", True),
    CorpusEntry("af_shell2", "big", 504855, 17562051, "fem", True),
    CorpusEntry("atmosmodd", "big", 1270432, 8814880, "fem"),
    CorpusEntry("atmosmodl", "big", 1489752, 10319760, "fem"),
    CorpusEntry("cage13", "big", 445315, 7479343, "banded"),
    CorpusEntry("CurlCurl_2", "big", 806529, 8921789, "fem", True),
    CorpusEntry("dielFilterV2real", "big", 1157456, 48538952, "fem", True),
    CorpusEntry("Geo_1438", "big", 1437960, 60236322, "fem", True),
    CorpusEntry("Hook_1498", "big", 1498023, 59374451, "fem", True),
    CorpusEntry("ML_Laplace", "big", 377002, 27582698, "fem"),
    CorpusEntry("nlpkkt80", "big", 1062400, 28192672, "fem", True),
    CorpusEntry("Serena", "big", 1391349, 64131971, "fem", True),
    CorpusEntry("Si87H76", "big", 240369, 10661631, "fem", True),
    CorpusEntry("StocF-1465", "big", 1465137, 21005389, "fem", True),
    CorpusEntry("Transport", "big", 1602111, 23487281, "fem"),
]

ALL: List[CorpusEntry] = MODERATE + BIG
_BY_NAME = {e.name: e for e in ALL}

_DEFAULT_ROOTS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "matrices"),
    "matrices",
]


def matrix_path(name: str, roots: Optional[List[str]] = None) -> Optional[str]:
    """Locate a real .mtx for a corpus entry, if downloaded."""
    e = _BY_NAME[name]
    for root in roots or _DEFAULT_ROOTS:
        for cand in (os.path.join(root, e.group, name, f"{name}.mtx"),
                     os.path.join(root, e.group, f"{name}.mtx"),
                     os.path.join(root, f"{name}.mtx")):
            if os.path.exists(cand):
                return cand
    return None


def load_matrix(name: str, allow_synthetic: bool = True,
                max_synth_nnz: Optional[int] = None):
    """Returns (CSRMatrix, is_synthetic). Uses the real file when present."""
    e = _BY_NAME[name]
    path = matrix_path(name)
    if path is not None:
        from ..io import load_csr
        return load_csr(path), False
    if not allow_synthetic:
        raise FileNotFoundError(
            f"{name}.mtx not found; run the dataset fetch script "
            f"(respatpu.bench.fetch) or enable synthetic stand-ins")
    n, nnz = e.n, e.nnz
    if max_synth_nnz is not None and nnz > max_synth_nnz:
        # degree-preserving downscale: n shrinks linearly with the nnz
        # budget so nnz/row (the structural difficulty) matches the
        # catalogue entry.  The old sqrt rule halved the density of every
        # mini — weak-diag circuit minis below ~2 nnz/row degenerated into
        # exponentially ill-conditioned weak chains no solver handles.
        scale = max_synth_nnz / nnz
        n = max(1000, int(n * scale))
        nnz = max_synth_nnz
    return synth_like(e.name, n, nnz, e.kind,
                      seed=zlib.crc32(e.name.encode())), True
