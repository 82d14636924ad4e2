"""The port's serving plane: engine == host block loop, a model carried over
from the JAX reference (``convert.model``) scores like the reference's
``decision_function``, the ``compact`` artifact, bf16 SV storage against
the reference's on the same numpy inputs (the stored bits, the scores, the
resident bytes), and the engine's pricing (``model_flops`` equal to the
reference's, ``roofline`` rows with the reference's keys)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ServeEngine as JEngine
from repro.core import SVMConfig as JConfig
from repro.core import SMOSolver as JSolver
from repro.core import train as jtrain
from repro.core.solver import SVMModel as JModel
from repro.data import make_sparse as jmake_sparse

from repro_torch import convert
from repro_torch.core import ServeEngine
from repro_torch.core.serve import row_width
from repro_torch.core import train as ttrain
from repro_torch.core import bf16
from repro_torch.core.solver import SVMModel, SVMConfig
from repro_torch.kernels import ref as kref

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
    with pytest.raises(ValueError):      # bf16 and fp32 only
        m.compact(dtype="float16")
    with pytest.raises(ValueError):      # no process group of 2 ranks
        ServeEngine(m, device="cpu", shards=2)
    with pytest.raises(ValueError):
        m.decision_function(Z[:, :3])


# -- bf16 SV storage against the reference ----------------------------------

@pytest.fixture(scope="module", params=["dense", "ell"])
def ref_model(request):
    """A reference model (dense: blobs; ELL: a sparse set trained with
    ``format='ell'``), its port twin through ``convert`` and queries."""
    if request.param == "dense":
        X, y = make_blobs(n=400, d=6, sep=1.0, seed=31)
        Z, _ = make_blobs(n=200, d=6, sep=1.0, seed=32)
        mj = jtrain(X, y, C=4.0, sigma2=4.0, heuristic="multi5pc")
        mt = convert.model(mj.sv_x, mj.sv_coef, mj.beta, mj.alpha,
                           dataclasses.asdict(mj.config), device="cpu")
    else:
        X, y = jmake_sparse(360, 80, 0.1, seed=5)
        Z = X[::3] + 0.05 * (X[::3] != 0)
        mj = JSolver(JConfig(C=4.0, sigma2=8.0, format="ell",
                             ell_lane=16)).fit(X, y)
        mt = convert.ell_model(mj.sv_vals, mj.sv_cols, mj.n_features,
                               mj.sv_coef, mj.beta, mj.alpha,
                               dataclasses.asdict(mj.config), device="cpu")
    return request.param, mj, mt, np.asarray(Z, np.float32)


def _values(m):
    return m.sv_x if m.sv_vals is None else m.sv_vals


def test_compact_bf16_stores_the_reference_bits(ref_model):
    fmt, mj, mt, _ = ref_model
    cj, ct = mj.compact(dtype="bfloat16"), mt.compact(dtype="bfloat16")
    assert _values(cj).dtype.name == "bfloat16"
    assert _values(ct).dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.bits(_values(ct)),
                                  bf16.bits(_values(cj)))
    np.testing.assert_array_equal(ct.sv_coef, np.asarray(cj.sv_coef))
    if fmt == "ell":
        np.testing.assert_array_equal(ct.sv_cols, np.asarray(cj.sv_cols))
    # dtype=None stores fp32, as the reference's does, bf16 values widened
    back = ct.compact()
    assert back.sv_coef.size == ct.sv_coef.size
    np.testing.assert_array_equal(_values(back), bf16.widen(_values(ct)))


def test_convert_keeps_a_bf16_reference_model(ref_model):
    fmt, mj, _, Z = ref_model
    cj = mj.compact(dtype="bfloat16")
    if fmt == "dense":
        mt = convert.model(cj.sv_x, cj.sv_coef, cj.beta, cj.alpha,
                           dataclasses.asdict(cj.config), device="cpu")
    else:
        mt = convert.ell_model(cj.sv_vals, cj.sv_cols, cj.n_features,
                               cj.sv_coef, cj.beta, cj.alpha,
                               dataclasses.asdict(cj.config), device="cpu")
    assert _values(mt).dtype == torch.bfloat16
    np.testing.assert_array_equal(bf16.bits(_values(mt)),
                                  bf16.bits(_values(cj)))
    eng = mt.serve_engine()
    assert eng.describe()["dtype"] == "bfloat16"   # None: the model's type
    ref = np.asarray(JEngine(cj).decision_function(Z))
    got = eng.decision_function(Z)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_bf16_engine_against_the_reference_and_fp32(ref_model):
    """The port's bf16 engine within 1e-4 of max |score| of the
    reference's bf16 engine, within one storage rounding (the reference's
    envelope, rtol 2e-2 / atol 3e-2) of the fp32 scores, and bitwise the
    fp32 engine over the rounded SVs."""
    fmt, mj, mt, Z = ref_model
    e16 = ServeEngine(mt, device="cpu", dtype="bfloat16")
    got = e16.decision_function(Z)
    ref = np.asarray(JEngine(mj, dtype="bfloat16").decision_function(Z))
    assert np.abs(ref).max() > 0.5
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_allclose(got, mt.decision_function_host(Z),
                               rtol=2e-2, atol=3e-2)
    rounded = dataclasses.replace(
        mt, **{("sv_x" if fmt == "dense" else "sv_vals"):
               bf16.widen(bf16.round_bf16(_values(mt)))})
    f32 = ServeEngine(rounded, device="cpu", dtype="float32")
    np.testing.assert_array_equal(got.view(np.int32),
                                  f32.decision_function(Z).view(np.int32))


def test_bf16_halves_the_value_bytes(ref_model):
    fmt, mj, mt, _ = ref_model
    e32 = ServeEngine(mt, device="cpu")
    e16 = ServeEngine(mt, device="cpu", dtype="bfloat16")
    v32 = e32._data.X if fmt == "dense" else e32._data.vals
    v16 = e16._data.X if fmt == "dense" else e16._data.vals
    assert v16.dtype == torch.bfloat16 and v32.dtype == torch.float32
    assert e32.memory_bytes() - e16.memory_bytes() == v16.numel() * 2
    assert e16.describe()["dtype"] == "bfloat16"
    with pytest.raises(ValueError):
        ServeEngine(mt, device="cpu", dtype="float16")


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_bf16_plain_accumulates_equal_fp32_on_widened_svs(fmt):
    r = np.random.default_rng(4)
    M, d, K, B = 300, 37, 12, 50
    Z = torch.as_tensor(r.normal(size=(B, d)).astype(np.float32)) * 0.3
    coef = torch.as_tensor(r.normal(size=M).astype(np.float32))
    if fmt == "dense":
        X16 = torch.as_tensor(r.normal(size=(M, d)).astype(np.float32)) \
            .to(torch.bfloat16)
        Xw = X16.float()
        sq = (Xw * Xw).sum(1)
        got = kref.rbf_accumulate(X16, sq, coef, Z, 0.3)
        want = kref.rbf_accumulate(Xw, sq, coef, Z, 0.3)
    else:
        v16 = torch.as_tensor(r.normal(size=(M, K)).astype(np.float32)) \
            .to(torch.bfloat16)
        cols = torch.as_tensor(r.integers(0, d, (M, K)).astype(np.int32))
        vw = v16.float()
        sq = (vw * vw).sum(1)
        got = kref.ell_rbf_accumulate(v16, cols, sq, coef, Z, 0.3)
        want = kref.ell_rbf_accumulate(vw, cols, sq, coef, Z, 0.3)
    assert torch.equal(got, want)


def _twins(fmt, K_out):
    """The same random SV set as a reference and a port model (``K_out``
    coefficient columns; 1: a binary model)."""
    r = np.random.default_rng(8)
    n_sv, d, K = 301, 10, 16
    coef = r.normal(size=(n_sv, K_out) if K_out > 1 else n_sv) \
        .astype(np.float32)
    beta = r.normal(size=K_out).astype(np.float32) if K_out > 1 \
        else np.float32(0.1)
    alpha = np.abs(r.normal(size=n_sv)).astype(np.float32)
    jc, tc = JConfig(C=1.0, sigma2=4.0), SVMConfig(C=1.0, sigma2=4.0,
                                                   device="cpu")
    if fmt == "dense":
        x = r.normal(size=(n_sv, d)).astype(np.float32)
        return (JModel(jc, x, coef, beta, alpha, None),
                SVMModel(tc, x, coef, beta, alpha, None))
    vals = r.normal(size=(n_sv, K)).astype(np.float32)
    cols = r.integers(0, d, (n_sv, K)).astype(np.int32)
    return (JModel(jc, None, coef, beta, alpha, None, sv_vals=vals,
                   sv_cols=cols, n_features=d),
            SVMModel(tc, None, coef, beta, alpha, None, sv_vals=vals,
                     sv_cols=cols, n_features=d))


@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("k_out", [1, 3], ids=["binary", "multi-coef"])
def test_model_flops_equal_the_reference(fmt, k_out):
    mj, mt = _twins(fmt, k_out)
    for dtype in ("float32", "bfloat16"):
        ej = JEngine(mj, dtype=dtype)
        et = ServeEngine(mt, device="cpu", dtype=dtype)
        for b in (64, 512, 4096):
            assert et.model_flops(b) == ej.model_flops(b)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_roofline_rows_have_the_reference_keys(fmt):
    """``roofline(b).row()`` has the reference's keys, positive compute
    and memory terms, no collective on one device, and prices bf16 SVs at
    half the value bytes with the fp32 compute term (the math is fp32)."""
    mj, mt = _twins(fmt, 3)
    want = JEngine(mj).roofline(64).row()
    rows = {dt: ServeEngine(mt, device="cpu", dtype=dt).roofline(64).row()
            for dt in ("float32", "bfloat16")}
    e = ServeEngine(mt, device="cpu")
    for dt, row in rows.items():
        assert sorted(row) == sorted(want)
        assert row["t_compute_s"] > 0 and row["t_memory_s"] > 0
        assert row["t_collective_s"] == 0 and row["link_bytes_per_chip"] == 0
        assert row["model_flops"] == e.model_flops(64)
        assert row["useful_ratio"] > 0 and row["bytes_per_device"] > 0
    assert rows["float32"]["t_compute_s"] == rows["bfloat16"]["t_compute_s"]
    sv = e._data.X if fmt == "dense" else e._data.vals
    assert rows["float32"]["hbm_bytes_global"] \
        - rows["bfloat16"]["hbm_bytes_global"] == 2 * sv.numel()
    assert e.roofline().row()["flops_global"] == \
        64 * rows["float32"]["flops_global"]     # default: max_bucket 4096


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_bf16_multi_coef_engine_against_the_reference(fmt):
    """The union engine (an (n_sv, K) coefficient table) with bf16 SVs:
    (B, K) scores within 1e-4 of max |score| of the reference's bf16
    multi-coef engine, bitwise those of an fp32 union engine over the
    rounded SVs, and the value bytes halved."""
    mj, mt = _twins(fmt, 3)
    r = np.random.default_rng(9)
    Z = r.normal(size=(150, 10)).astype(np.float32)
    got = ServeEngine(mt, device="cpu", dtype="bfloat16").decision_function(Z)
    ref = np.asarray(JEngine(mj, dtype="bfloat16").decision_function(Z))
    assert got.shape == ref.shape == (150, 3)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    field = "sv_x" if fmt == "dense" else "sv_vals"
    rounded = dataclasses.replace(
        mt, **{field: bf16.widen(bf16.round_bf16(getattr(mt, field)))})
    f32 = ServeEngine(rounded, device="cpu").decision_function(Z)
    np.testing.assert_array_equal(got.view(np.int32), f32.view(np.int32))
