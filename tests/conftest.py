# NOTE: deliberately does NOT set --xla_force_host_platform_device_count —
# smoke tests and benches must see 1 device (dryrun.py owns the 512-device
# flag). Multi-device tests spawn subprocesses with their own XLA_FLAGS.
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_blobs(n=400, d=5, sep=1.0, seed=0):
    r = np.random.default_rng(seed)
    X = np.vstack([r.normal(+sep, 1.0, (n // 2, d)),
                   r.normal(-sep, 1.0, (n - n // 2, d))]).astype(np.float32)
    y = np.concatenate([np.ones(n // 2),
                        -np.ones(n - n // 2)]).astype(np.float32)
    p = r.permutation(n)
    return X[p], y[p]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels); skips without")
