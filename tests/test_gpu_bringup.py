"""The GPU bring-up surface on the CPU: SpMV format choice and accuracy
bounds, compile-cache placement, the device peak table, the df64 guard, the
stand-in seeds, and chip_smoke.py's phases at tiny size."""
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from respatpu import precision as prec
from respatpu.bench.corpus import load_matrix
from respatpu.bench.synth import laplacian_3d
from respatpu.kernels.spmv import DeviceEllr, DeviceHybrid, spmv, to_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()

_MATS = {
    "stencil": (lambda: laplacian_3d(9, 9, 9), DeviceHybrid),
    "fem": (lambda: load_matrix("2cubes_sphere", max_synth_nnz=20_000)[0],
            DeviceEllr),
    "circuit": (lambda: load_matrix("dc1", max_synth_nnz=10_000)[0],
                DeviceEllr),
}


@pytest.mark.parametrize("kind", sorted(_MATS))
@pytest.mark.parametrize("policy", ["fp32", "bf16", "df64"])
def test_auto_dispatch_meets_bounds(kind, policy):
    make, fmt = _MATS[kind]
    a = make()
    dev = to_device(a, policy, fmt="auto")
    assert isinstance(dev, fmt)
    rng = np.random.default_rng(7)
    x = np.asarray(jnp.asarray(rng.standard_normal(a.ncols), jnp.bfloat16)
                   .astype(jnp.float32), np.float64)
    A = cs.to_scipy(a)
    scale = abs(A) @ np.abs(x)
    k = int(a.row_lengths().max())
    if policy == "df64":
        y = prec.df_to_f64(spmv(dev, prec.df_from_f64(x)))
        tol = k * cs.DF64_U
    else:
        y = np.asarray(spmv(dev, jnp.asarray(x, jnp.float32)), np.float64)
        tol = (cs.BF16_STORE if policy == "bf16" else 0.0) + k * cs.U32
    assert np.max(np.abs(y - A @ x) / np.where(scale > 0, scale, 1)) <= tol


def test_unknown_spmv_format_raises():
    with pytest.raises(ValueError, match="unknown SpMV format"):
        to_device(laplacian_3d(3, 3, 3), "fp32", fmt="gsell")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    from respatpu import config
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    try:
        assert config.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peak_table_has_h100():
    from respatpu.timing import device_hbm_bw, device_peaks
    peaks = device_peaks(_Dev("NVIDIA H100 80GB HBM3"))
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["hbm_bytes"] == 80e9
    assert device_hbm_bw(_Dev("NVIDIA H100 80GB HBM3")) == 3.35e12


def test_peak_table_unknown_kind_raises():
    from respatpu.timing import device_peaks
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(_Dev("cpu"))


def test_chained_time_reports_nan_when_timing_fails(monkeypatch):
    """A measurement swallowed by clock jitter yields NaN, never a time."""
    from respatpu import timing
    monkeypatch.setattr(timing.time, "perf_counter", lambda: 0.0)
    t = timing.chained_time(lambda x: x * 2.0, jnp.ones(8, jnp.float32))
    assert np.isnan(t)


@pytest.fixture
def fresh_eft_state(monkeypatch):
    monkeypatch.setattr(prec, "_EFT_CHECKED", False)
    monkeypatch.setattr(prec, "eft_selfcheck", lambda warn=True: False)


def test_eft_guard_raises_on_gpu(monkeypatch, fresh_eft_state):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="miscompiled"):
        prec._ensure_eft_checked()
    assert prec._EFT_CHECKED is False


def test_eft_guard_tolerated_on_cpu(monkeypatch, fresh_eft_state):
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    prec._ensure_eft_checked()
    assert prec._EFT_CHECKED is True


def test_standin_seed_stable_across_processes():
    code = ("from respatpu.bench.corpus import load_matrix;"
            "a = load_matrix('dc1', max_synth_nnz=5000)[0];"
            "print(a.nnz, float(a.data.sum()))")
    runs = [subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           capture_output=True, text=True, check=True,
                           env=dict(os.environ, PYTHONHASHSEED=str(s)),
                           timeout=120).stdout.split()
            for s in (1, 2)]
    assert runs[0] == runs[1]


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_spmv_and_eft_phases():
    rows = cs.phase_spmv({name: make() for name, (make, _) in _MATS.items()},
                         reps=1)
    assert len(rows) == 3 * 4
    assert all(r["err"] <= r["tol"] for r in rows)
    cs.phase_eft()


def test_chip_smoke_krylov_phase():
    a = load_matrix("2cubes_sphere", max_synth_nnz=20_000)[0]
    out = cs.phase_krylov(a, rehearse_on=jax.devices("cpu")[0])
    assert out["residual"] <= 1e-6
    assert out["iterations"] == out["iterations_rehearsal"]


def test_chip_smoke_direct_phase():
    a = load_matrix("dc1", max_synth_nnz=20_000)[0]
    out = cs.phase_direct(a, max_band_bytes=1 << 18)
    assert "snlu" in out["notes"] and out["residual"] <= 1e-10


def test_chip_smoke_ozaki_phase():
    assert cs.phase_ozaki(64)["err"] <= 64 * cs.DF64_U


def test_chip_smoke_four_cards_phase():
    from respatpu.bench.synth import mesh_fem_3d
    a = load_matrix("2cubes_sphere", max_synth_nnz=10_000)[0]
    out = cs.phase_four_cards(a, mesh_fem_3d(300, seed=5), ndev=4)
    assert out["subtree_lu_diff"] <= 1e-8


@pytest.mark.gpu
def test_gpu_df64_spmv_and_eft(gpu_device):
    """On the card: the EFT self-check holds and compiled df64 SpMV meets
    its bound (the same check chip_smoke.py makes at catalogue size)."""
    assert prec.eft_selfcheck(warn=False)
    rows = cs.phase_spmv({"fem": _MATS["fem"][0]()}, reps=1)
    assert all(r["err"] <= r["tol"] for r in rows)
