"""Synthetic stand-ins for the paper's seven evaluation datasets (copy of
``repro.data.synthetic``: ``SPECS``, ``DatasetSpec``, ``make``,
``make_sparse``, ``density`` and the generators; outputs are byte-equal to
the reference for the same (spec, scale, seed) — crc32 seeding).

The public datasets (Table 2 of the paper) are replaced by generators matched on the axes that drive SMO/shrinking
behaviour: N, d, sparsity/density, feature type (binary categorical vs dense
continuous), class balance, and separability (which controls the
support-vector fraction |zeta|/|X| — the quantity the paper's heuristics key
on). Hyperparameters (C, sigma^2) are the paper's Table 2 values.

Every generator is deterministic in (spec, seed, scale).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Literal

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_train: int
    n_test: int
    d: int
    kind: Literal["dense_clusters", "sparse_binary", "image_like",
                  "forest_like", "text_topics"]
    C: float
    sigma2: float
    density: float = 1.0     # fraction of nonzero features
    separation: float = 2.0  # inter-class margin in units of cluster sigma
    label_noise: float = 0.02
    n_clusters: int = 4      # per class, for multi-modal structure
    n_classes: int = 2       # >2 -> integer labels in {0..K-1} (OvR specs)


# Table 2 of the paper, with measured densities of the public originals.
SPECS: dict[str, DatasetSpec] = {s.name: s for s in [
    DatasetSpec("mnist", 60000, 10000, 784, "image_like", C=10, sigma2=25,
                density=0.19, separation=1.6, n_clusters=10),
    DatasetSpec("a7a", 16100, 16461, 123, "sparse_binary", C=32, sigma2=64,
                density=0.11, separation=1.1, label_noise=0.12),
    DatasetSpec("a9a", 32561, 16281, 123, "sparse_binary", C=32, sigma2=64,
                density=0.11, separation=1.1, label_noise=0.12),
    DatasetSpec("usps", 7291, 2007, 256, "image_like", C=8, sigma2=16,
                density=0.75, separation=2.2, n_clusters=10),
    DatasetSpec("mushrooms", 8124, 0, 112, "sparse_binary", C=8, sigma2=64,
                density=0.19, separation=3.0, label_noise=0.0),
    DatasetSpec("w7a", 24692, 25057, 300, "sparse_binary", C=32, sigma2=64,
                density=0.04, separation=1.8, label_noise=0.03),
    DatasetSpec("ijcnn", 49990, 91701, 22, "dense_clusters", C=0.5, sigma2=1,
                density=1.0, separation=1.0, label_noise=0.08, n_clusters=6),
    # Multi-class OvR workloads (batched multi-problem driver): integer
    # labels in {0..n_classes-1}, matched to the public originals on
    # (N, d, K, density, class balance).
    DatasetSpec("covtype", 522910, 58102, 54, "forest_like", C=10, sigma2=16,
                density=1.0, separation=1.3, label_noise=0.0, n_clusters=3,
                n_classes=7),
    # news20's vocabulary (62061 terms) is scaled to a CI-budget d at the
    # REAL ~80 nonzero terms/doc (0.0013 * 62061): nnz/row is what drives
    # ELL lane budgets and kernel-row cost, not the raw vocabulary width.
    DatasetSpec("news20", 15935, 3993, 8192, "text_topics", C=4, sigma2=64,
                density=0.0098, separation=3.0, label_noise=0.0,
                n_classes=20),
]}


def _dense_clusters(rng, n, spec: DatasetSpec):
    """Two classes of gaussian cluster mixtures; separation controls |zeta|."""
    k = spec.n_clusters
    centers_p = rng.normal(size=(k, spec.d))
    centers_m = rng.normal(size=(k, spec.d))
    # push the two banks apart along a random direction
    u = rng.normal(size=spec.d)
    u /= np.linalg.norm(u)
    centers_p += spec.separation * 0.5 * u
    centers_m -= spec.separation * 0.5 * u
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    comp = rng.integers(0, k, size=n)
    X = np.where(y[:, None] > 0, centers_p[comp], centers_m[comp])
    X = X + rng.normal(scale=1.0, size=(n, spec.d))
    return X.astype(np.float32), y.astype(np.float32)


def _image_like(rng, n, spec: DatasetSpec):
    """Nonneg [0,1] features, block-sparse rows — digit-image statistics.
    Classes = even/odd "digit" prototypes (the paper's MNIST binarization)."""
    k = spec.n_clusters
    protos = rng.random((k, spec.d)) * (rng.random((k, spec.d)) < spec.density)
    digit = rng.integers(0, k, size=n)
    y = np.where(digit % 2 == 0, -1.0, 1.0)       # even -> -1, odd -> +1
    X = protos[digit] * (0.6 + 0.8 * rng.random((n, spec.d)))
    X += (spec.separation / 10.0) * rng.normal(size=(n, spec.d)) \
        * (protos[digit] > 0)
    X = np.clip(X, 0.0, 1.0)
    return X.astype(np.float32), y.astype(np.float32)


def _sparse_binary(rng, n, spec: DatasetSpec):
    """Categorical one-hot groups (census/web-text statistics): d features
    split into groups; each sample activates one feature per group. Labels
    from a sparse linear rule + noise -> controls SV fraction."""
    n_active = max(2, int(spec.density * spec.d))
    group_sizes = np.full(n_active, spec.d // n_active)
    group_sizes[: spec.d % n_active] += 1
    offsets = np.concatenate([[0], np.cumsum(group_sizes)[:-1]])
    choices = (rng.random((n, n_active)) * group_sizes).astype(np.int64)
    cols = offsets[None, :] + choices
    X = np.zeros((n, spec.d), np.float32)
    X[np.arange(n)[:, None], cols] = 1.0
    w = rng.normal(size=spec.d) * (rng.random(spec.d) < 0.6)
    score = X @ w + 0.3 * rng.normal(size=n)
    y = np.where(score > np.median(score), 1.0, -1.0)
    flip = rng.random(n) < spec.label_noise
    y = np.where(flip, -y, y)
    return X, y.astype(np.float32)


def _forest_like(rng, n, spec: DatasetSpec):
    """covtype statistics: dense continuous cartographic features, K
    imbalanced classes (two dominant cover types, geometric tail), each a
    mixture of terrain blobs ordered along an elevation-like direction;
    a block of quantized soil/wilderness indicator columns."""
    K = spec.n_classes
    pri = 0.55 ** np.arange(K)
    pri /= pri.sum()
    u = rng.normal(size=spec.d)
    u /= np.linalg.norm(u)
    centers = rng.normal(size=(K, spec.n_clusters, spec.d))
    centers += spec.separation * np.linspace(-1.0, 1.0, K)[:, None, None] * u
    y = rng.choice(K, size=n, p=pri)
    comp = rng.integers(0, spec.n_clusters, size=n)
    X = centers[y, comp] + rng.normal(size=(n, spec.d))
    nq = max(2, spec.d // 10)
    X[:, -nq:] = (X[:, -nq:] > 0.5).astype(np.float64)
    return X.astype(np.float32), y.astype(np.int32)


def _text_topics(rng, n, spec: DatasetSpec):
    """news20 statistics: K topical classes over a large vocabulary. Each
    document draws ~density*d distinct terms from its class topic mixed
    with a Zipf background (Gumbel top-k, vectorized), tf-idf-ish positive
    magnitudes, rows l2-normalized."""
    K = spec.n_classes
    nnz = max(4, int(round(spec.density * spec.d)))
    bg = 1.0 / np.arange(1, spec.d + 1)
    topic = np.zeros((K, spec.d))
    for k in range(K):
        cols = rng.choice(spec.d, size=min(spec.d, max(nnz * 4, 16)),
                          replace=False)
        topic[k, cols] = rng.random(cols.size) * spec.separation * bg.mean()
    y = rng.integers(0, K, size=n)
    w = bg[None, :] + topic[y] * spec.d
    g = -np.log(-np.log(rng.random((n, spec.d)) + 1e-12) + 1e-12)
    keys = np.log(w) + g
    cols = np.argpartition(-keys, nnz - 1, axis=1)[:, :nnz]
    vals = np.exp(0.4 * rng.normal(size=(n, nnz))).astype(np.float32)
    X = np.zeros((n, spec.d), np.float32)
    X[np.arange(n)[:, None], cols] = vals
    X /= np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-6)
    return X, y.astype(np.int32)


_GEN = {"dense_clusters": _dense_clusters, "image_like": _image_like,
        "sparse_binary": _sparse_binary, "forest_like": _forest_like,
        "text_topics": _text_topics}


def make(spec: "DatasetSpec | str", scale: float = 1.0, seed: int = 0):
    """Returns (X_train, y_train, X_test, y_test). ``scale`` shrinks N
    (CPU-friendly benchmark sizes) without changing d or statistics.
    Binary specs label with float32 +-1; multi-class specs
    (``spec.n_classes > 2`` — the covtype/news20 stand-ins) label with
    int32 class ids, the input of one-vs-rest training (a later slice
    of the port)."""
    if isinstance(spec, str):
        spec = SPECS[spec]
    # crc32, not hash(): str hashing is salted per process, which made the
    # "deterministic in (spec, seed, scale)" contract silently false across
    # runs (two identical CLI invocations trained on different datasets)
    rng = np.random.default_rng(seed + zlib.crc32(spec.name.encode()) % 2**16)
    n_tr = max(64, int(spec.n_train * scale))
    n_te = int(spec.n_test * scale)
    X, y = _GEN[spec.kind](rng, n_tr + max(n_te, 0), spec)
    # balance check: ensure at least two classes present
    if np.unique(y[:n_tr]).size < 2:
        if spec.n_classes > 2:
            y[: n_tr // 2] = (y[0] + 1) % spec.n_classes
        else:
            y[: n_tr // 2] = -y[0]
    return X[:n_tr], y[:n_tr], X[n_tr:], y[n_tr:]


def density(X: np.ndarray) -> float:
    return float(np.count_nonzero(X)) / X.size


def make_sparse(n: int, d: int, density: float, seed: int = 0,
                noise: float = 0.3, label_noise: float = 0.02,
                margin: float = 0.0):
    """Sparse continuous-feature dataset with *exact* controllable density.

    Stand-in for the paper's large sparse workloads (rcv1/webspam class:
    text n-gram features, density well under 1%). Every row gets exactly
    ``round(density * d)`` nonzero features at uniform-random columns with
    log-normal-ish magnitudes; labels come from a sparse linear teacher so
    the SV fraction stays moderate. ``margin`` in [0, 1) discards that
    fraction of borderline samples (closest to the teacher's boundary),
    which lowers the SV fraction — the quantity shrinking heuristics key
    on. Returns (X, y) with X dense (convert via ``repro_torch.data.to_ell`` /
    ``format='ell'`` for sparse storage).
    """
    rng = np.random.default_rng(seed)
    n_gen = int(np.ceil(n / max(1.0 - margin, 1e-6)))
    nnz = max(1, int(round(density * d)))
    # unique columns per row: argpartition of random keys (vectorized)
    keys = rng.random((n_gen, d))
    cols = np.argpartition(keys, nnz - 1, axis=1)[:, :nnz]
    vals = rng.normal(size=(n_gen, nnz)).astype(np.float32) * \
        np.exp(0.5 * rng.normal(size=(n_gen, nnz))).astype(np.float32)
    X = np.zeros((n_gen, d), np.float32)
    X[np.arange(n_gen)[:, None], cols] = vals
    w = rng.normal(size=d) * (rng.random(d) < 0.5)
    score = X @ w + noise * rng.normal(size=n_gen)
    score -= np.median(score)
    if margin > 0.0:
        keep = np.argsort(-np.abs(score))[:n]    # widest-margin samples
        keep = keep[rng.permutation(keep.size)]
        X, score = X[keep], score[keep]
    y = np.where(score > 0, 1.0, -1.0)
    flip = rng.random(y.size) < label_noise
    y = np.where(flip, -y, y).astype(np.float32)
    if np.all(y == y[0]):
        y[: y.size // 2] = -y[0]
    return X[:n], y[:n]
