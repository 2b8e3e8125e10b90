"""Runtime experiment configuration (SURVEY.md §5.6).

The reference switches precision by recompiling with ``#define FLOAT`` and
toggles FTZ by editing code (README.md:77-97); thread counts and matrix paths
come from env vars + argv. Here a single dataclass covers the whole
experiment space at runtime, serializable to/from JSON for sweep manifests.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from .precision import Policy, get_policy

__all__ = ["ExperimentConfig", "compile_cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache in :func:`compile_cache_dir`.

    Entry points call this before their first compilation; it is the only
    place the program sets a cache path. Returns the path."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclass
class ExperimentConfig:
    """One experiment = matrices x workload x precision x execution layout."""

    workload: str = "spmv"  # spmv | ilu0 | lu | study
    matrices: List[str] = field(default_factory=list)  # corpus names or paths
    group: Optional[str] = None  # moderate | big | all (overrides matrices)
    policy: str = "fp32"  # fp32 | fp32_ftz | bf16 | df64
    reference_policy: str = "df64"
    ftz: Optional[bool] = None  # explicit FTZ override
    reps: int = 5  # repetitions (run_pardiso.sh:41 uses 11)
    refine: bool = True  # df64 iterative refinement after low-precision LU
    ordering: str = "rcm"
    ilu_sweeps: int = 8
    n_devices: int = 1  # row-partition width for distributed runs
    csv_path: Optional[str] = None
    max_synth_nnz: Optional[int] = None
    seed: int = 42

    def resolved_policy(self) -> Policy:
        p = get_policy(self.policy)
        if self.ftz is not None and not p.double_word:
            p = dataclasses.replace(p, flush_to_zero=self.ftz,
                                    name=p.name.replace("_ftz", "")
                                    + ("_ftz" if self.ftz else ""))
        return p

    def matrix_names(self) -> List[str]:
        if self.group:
            from .bench import corpus
            src = {"moderate": corpus.MODERATE, "big": corpus.BIG,
                   "all": corpus.ALL}[self.group]
            return [e.name for e in src]
        return self.matrices

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        return cls(**json.loads(text))

    def run(self, verbose: bool = True):
        """Execute the configured experiment via the sweep runners."""
        from .bench import runner, study
        names = self.matrix_names()
        pol = self.resolved_policy()
        if self.workload == "spmv":
            return runner.sweep_spmv(names, csv_path=self.csv_path,
                                     policies=(self.reference_policy, pol),
                                     reps=self.reps,
                                     max_synth_nnz=self.max_synth_nnz,
                                     verbose=verbose)
        if self.workload == "ilu0":
            return runner.sweep_ilu0(names, csv_path=self.csv_path, policy=pol,
                                     sweeps=self.ilu_sweeps,
                                     max_synth_nnz=self.max_synth_nnz,
                                     verbose=verbose)
        if self.workload == "lu":
            return runner.sweep_lu(names, csv_path=self.csv_path, policy=pol,
                                   refine=self.refine,
                                   max_synth_nnz=self.max_synth_nnz,
                                   verbose=verbose)
        if self.workload == "study":
            return study.run_study(names, csv_path=self.csv_path,
                                   max_synth_nnz=self.max_synth_nnz,
                                   verbose=verbose)
        raise ValueError(f"unknown workload {self.workload!r}")
