"""Block-ELL SpMV kernel (shared row gathers) vs the host CSR oracle."""
import numpy as np
import pytest

from respatpu.bench.synth import (circuit_like, laplacian_2d, mesh_fem_3d,
                                  random_banded)
from respatpu.kernels.bell import (BellMatrix, build_bell, bell_to_device,
                                   bell_spmv, choose_block_shape)
from respatpu.kernels.spmv import spmv, spmv_csr_reference, to_device


@pytest.mark.parametrize("r,c", [(8, 8), (16, 32), (32, 32)])
def test_bell_matches_reference(r, c):
    a = mesh_fem_3d(4096, avg_degree=14.0, seed=1)
    x = np.random.default_rng(0).standard_normal(a.ncols)
    y_ref = spmv_csr_reference(a, x)
    dev = bell_to_device(a, "fp32", r=r, c=c)
    y = np.asarray(bell_spmv(dev, x.astype(np.float32)), np.float64)
    assert np.allclose(y, y_ref, rtol=2e-4, atol=2e-4 * np.abs(y_ref).max())


def test_bell_irregular_shapes():
    # n not divisible by r, ncols not by c, empty rows
    a = circuit_like(1003, 4, seed=3)
    x = np.random.default_rng(1).standard_normal(a.ncols)
    y_ref = spmv_csr_reference(a, x)
    dev = bell_to_device(a, "fp32", r=8, c=32)
    y = np.asarray(bell_spmv(dev, x.astype(np.float32)), np.float64)
    assert np.allclose(y, y_ref, rtol=2e-4, atol=2e-4 * np.abs(y_ref).max())


def test_bell_duplicate_free_and_padding():
    b = build_bell(mesh_fem_3d(2048, 12.0, seed=2), r=16, c=16)
    assert b.ns % 8 == 0
    # padded slots must not contribute: their blocklets are all-zero
    assert b.slots_per_entry < 1.0  # sharing actually happened


def test_bell_auto_shape_picks_candidate():
    a = mesh_fem_3d(4096, 16.0, seed=4)
    r, c = choose_block_shape(a)
    assert (r, c) in ((8, 8), (8, 32), (16, 16), (16, 32), (32, 32))


def test_auto_shape_reads_fewest_bytes():
    from respatpu.kernels.bell import _CANDIDATES, bell_bytes
    a = mesh_fem_3d(4096, 16.0, seed=4)
    best = bell_bytes(a, *choose_block_shape(a))
    assert all(best <= bell_bytes(a, r, c) for r, c in _CANDIDATES)


def test_auto_format_mesh_picks_gather_kernel():
    # unstructured mesh matrices take the ELL gather kernel; XLA fuses the
    # gather, multiply and row reduction on the GPU
    a = mesh_fem_3d(8192, 16.0, seed=5)
    dev = to_device(a, "fp32", fmt="auto")
    from respatpu.kernels.spmv import DeviceEllr
    assert isinstance(dev, DeviceEllr)
    x = np.random.default_rng(2).standard_normal(a.ncols)
    y = np.asarray(spmv(dev, x.astype(np.float32)), np.float64)
    y_ref = spmv_csr_reference(a, x)
    assert np.allclose(y, y_ref, rtol=2e-4, atol=2e-4 * np.abs(y_ref).max())


def test_auto_format_stencil_still_dia():
    from respatpu.kernels.spmv import DeviceHybrid
    a = laplacian_2d(64, 64)
    assert isinstance(to_device(a, "fp32", fmt="auto"), DeviceHybrid)


def test_auto_format_df64_stays_exact():
    from respatpu import precision as prec
    from respatpu.kernels.spmv import DeviceEllr
    a = mesh_fem_3d(2048, 12.0, seed=6)
    dev = to_device(a, "df64", fmt="auto")
    assert isinstance(dev, DeviceEllr)  # df64 takes the same rule as fp32
    x = np.random.default_rng(3).standard_normal(a.ncols)
    y = prec.df_to_f64(spmv(dev, prec.df_from_f64(x)))
    y_ref = spmv_csr_reference(a, x)
    scale = np.abs(y_ref).max() + 1.0
    assert np.abs(y - y_ref).max() / scale < 1e-13


def test_generators_structure():
    a = mesh_fem_3d(4096, 16.0, seed=0)
    deg = a.nnz / a.nrows
    assert 10 <= deg <= 22
    # symmetric pattern (SPD construction)
    at = a.transpose()
    assert np.array_equal(a.indptr, at.indptr)
    c = circuit_like(4096, 6, seed=0)
    assert c.nnz / c.nrows >= 5
