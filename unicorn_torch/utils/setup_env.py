"""Runtime environment setup (port of unicorn_tpu/utils/setup_env.py; the
reference's unicorn/utils/setup_env.py): host thread caps and the seeding
of Python's and numpy's generators.

The JAX package's `configure_jax` (its persistent compile cache) has no
counterpart: the port compiles nothing at run time but its kernels, whose
build directory (csrc/_build/) is their cache. The port's torch draws come
from explicit `torch.Generator`s, which seed_everything leaves alone.
"""
from __future__ import annotations

import os
import random

import numpy as np


def configure_omp(num_threads: int | None = None):
    """Cap host BLAS / OpenMP threads (the reference's setup_env.py:30-49);
    a variable already set is kept."""
    if num_threads is None:
        num_threads = max(1, (os.cpu_count() or 1))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(num_threads))


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed % (2 ** 31))
