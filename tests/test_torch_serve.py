"""The port's serving plane: engine == host block loop, a model carried over
from the JAX reference (``convert.model``) scores like the reference's
``decision_function``, and the fp32 ``compact`` artifact."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import train as jtrain

from repro_torch import convert
from repro_torch.core import ServeEngine
from repro_torch.core.serve import row_width
from repro_torch.core import train as ttrain

from conftest import make_blobs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    X, y = make_blobs(n=400, d=6, sep=1.0, seed=11)
    Z, _ = make_blobs(n=333, d=6, sep=1.0, seed=12)
    m = ttrain(X, y, C=4.0, sigma2=4.0, heuristic="multi5pc", device="cpu")
    return m, X, y, Z


@pytest.mark.parametrize("nq", [1, 63, 64, 65, 333])
def test_engine_equals_host_loop(trained, nq):
    m, _, _, Z = trained
    ref = m.decision_function_host(Z[:nq])
    got = m.decision_function(Z[:nq])
    assert np.abs(ref).max() > 0.5          # scores are O(1), not all -beta
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)


def test_bucket_padding_is_invisible(trained):
    m, _, _, Z = trained
    whole = ServeEngine(m, device="cpu", min_bucket=8, max_bucket=32)
    one = ServeEngine(m, device="cpu", min_bucket=512, max_bucket=512)
    np.testing.assert_allclose(whole.decision_function(Z),
                               one.decision_function(Z), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(whole.predict(Z), m.predict(Z))


def test_shards_none_means_every_device(trained):
    """``shards=None`` resolves to the process group's size (1 without a
    group), and scores exactly as ``shards=1``."""
    m, _, _, Z = trained
    every = ServeEngine(m, device="cpu", shards=None)
    assert every.describe()["shards"] == 1
    np.testing.assert_array_equal(
        every.decision_function(Z),
        ServeEngine(m, device="cpu", shards=1).decision_function(Z))


def test_score_bucket_takes_the_engine_width(trained):
    """Dense rows are held ``row_width`` features wide (d = 6 -> 8 zero-
    padded columns); ``score_bucket`` takes buckets of that width only, and
    ``describe()`` keeps the model's feature count."""
    m, _, _, Z = trained
    eng = ServeEngine(m, device="cpu", min_bucket=64, max_bucket=64)
    assert eng.width == row_width(6) == 8
    assert eng.describe()["n_features"] == 6
    zb = np.zeros((64, eng.width), np.float32)
    zb[:, :6] = Z[:64]
    got = eng.score_bucket(torch.as_tensor(zb)).numpy()
    np.testing.assert_array_equal(got, eng.decision_function(Z[:64]))
    with pytest.raises(ValueError):
        eng.score_bucket(torch.as_tensor(Z[:64].astype(np.float32)))


def test_converted_reference_model_scores_like_reference():
    X, y = make_blobs(n=400, d=6, sep=1.0, seed=21)
    Z, _ = make_blobs(n=300, d=6, sep=1.0, seed=22)
    mj = jtrain(X, y, C=4.0, sigma2=4.0, heuristic="multi5pc")
    ref = np.asarray(mj.decision_function(Z))
    mt = convert.model(mj.sv_x, mj.sv_coef, mj.beta, mj.alpha,
                       dataclasses.asdict(mj.config), device="cpu")
    got = mt.decision_function(Z)
    assert np.abs(got).max() > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(mt.decision_function_host(Z), ref,
                               rtol=1e-4, atol=2e-5)
    assert abs(mt.dual_objective() - mj.dual_objective()) \
        / abs(mj.dual_objective()) < 1e-5


def test_compact_merges_duplicates_and_scores_the_same(trained):
    m, _, _, Z = trained
    dup = dataclasses.replace(
        m, sv_x=np.concatenate([m.sv_x, m.sv_x[:5]]),
        sv_coef=np.concatenate([m.sv_coef * 0.5, m.sv_coef[:5] * 0.0]))
    dup.sv_coef[:5] = m.sv_coef[:5] * 0.5
    dup.sv_coef[-5:] = m.sv_coef[:5] * 0.5
    c = dup.compact()
    assert c.sv_x.shape[0] <= m.sv_x.shape[0]
    np.testing.assert_allclose(c.decision_function(Z),
                               dup.decision_function(Z), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(NotImplementedError):
        m.compact(dtype="bfloat16")
    with pytest.raises(ValueError):      # no process group of 2 ranks
        ServeEngine(m, device="cpu", shards=2)
    with pytest.raises(ValueError):
        m.decision_function(Z[:, :3])
