"""Unit functions of the PyTorch port against the JAX reference, on the same
numpy inputs: integer and mask outputs bitwise, the pair update to 1 ulp."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import dataplane as jdp
from repro.core import heuristics as jh
from repro.core import smo as jsmo
from repro.core import util as jutil
from repro.data import synthetic as jsyn

from repro_torch import device as tdevice
from repro_torch.core import dataplane as tdp
from repro_torch.core import heuristics as th
from repro_torch.core import smo as tsmo
from repro_torch.core import solver as tsolver
from repro_torch.core import util as tutil
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _state(seed, m=257, C=4.0):
    """Random buffer state with alphas at 0, at C, within C*1e-6 of the
    bounds and interior, plus inactive rows."""
    r = np.random.default_rng(seed)
    alpha = (r.random(m) * C).astype(np.float32)
    kind = r.integers(0, 5, m)
    alpha[kind == 0] = 0.0
    alpha[kind == 1] = C
    alpha[kind == 2] = np.float32(C * 0.4e-6)
    alpha[kind == 3] = np.float32(C * (1 - 0.4e-6))
    gamma = r.normal(size=m).astype(np.float32)
    y = np.where(r.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    active = r.random(m) < 0.85
    return alpha, gamma, y, active


def test_next_pow2_and_bucket_match_reference():
    for n in list(range(-3, 300)) + [1023, 1024, 1025, (1 << 20) + 1]:
        assert tutil.next_pow2(n) == jutil.next_pow2(n)
        for lo in (1, 8, 24, 64):
            assert tutil.bucket_pow2(n, lo) == jutil.bucket_pow2(n, lo)


def test_bucket_pow2_device_matches_host():
    ns = list(range(0, 300)) + [511, 512, 513, 1023, 1024, 1025,
                                (1 << 20) - 1, 1 << 20, (1 << 20) + 1]
    for lo in (1, 8, 24, 64):
        got = tutil.bucket_pow2_device(torch.tensor(ns), lo).numpy()
        want = np.array([jutil.bucket_pow2(n, lo) for n in ns])
        np.testing.assert_array_equal(got, want, err_msg=f"lo={lo}")
        ref = np.asarray(jutil.bucket_pow2_device(jnp.asarray(ns, jnp.int32),
                                                  jnp.int32(lo)))
        np.testing.assert_array_equal(got, ref)


def test_table3_and_fuse_budget_match_reference():
    assert list(th.TABLE3) == list(jh.TABLE3)
    for k, h in th.TABLE3.items():
        assert dataclasses.astuple(h) == dataclasses.astuple(jh.TABLE3[k])
        for n in (1, 77, 32561):
            assert h.interval(n) == jh.TABLE3[k].interval(n)
    for k in range(0, 9):
        for cnt in range(0, 12):
            for every in range(-1, 6):
                assert th.fuse_budget(k, cnt, every) == \
                    jh.fuse_budget(k, cnt, every)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("C", [4.0, 32.0, 0.5])
def test_select_pair_matches_reference(seed, C):
    alpha, gamma, y, active = _state(seed, C=C)
    want = jsmo.select_pair(jnp.asarray(gamma), jnp.asarray(alpha),
                            jnp.asarray(y), jnp.asarray(active), C)
    got = tsmo.select_pair(_t(gamma), _t(alpha), _t(y), _t(active), C)
    for g, w in zip(got, want):
        assert g.item() == np.asarray(w).item()


def test_select_pair_ties_break_to_lowest_index():
    m = 64
    gamma = np.zeros(m, np.float32)
    gamma[[7, 20, 41]] = -2.0          # tied minimum
    gamma[[3, 30, 50]] = 5.0           # tied maximum
    alpha = np.full(m, 1.0, np.float32)   # all interior: in both sets
    y = np.ones(m, np.float32)
    active = np.ones(m, bool)
    active[7] = False                  # the first tied minimum is shrunk
    b_up, i_up, b_low, i_low = tsmo.select_pair(
        _t(gamma), _t(alpha), _t(y), _t(active), 4.0)
    assert (i_up.item(), i_low.item()) == (20, 3)
    assert (b_up.item(), b_low.item()) == (-2.0, 5.0)
    want = jsmo.select_pair(jnp.asarray(gamma), jnp.asarray(alpha),
                            jnp.asarray(y), jnp.asarray(active), 4.0)
    assert (int(want[1]), int(want[3])) == (20, 3)


@pytest.mark.parametrize("seed", range(6))
def test_shrink_rule_matches_reference(seed):
    C = 4.0
    alpha, gamma, y, active = _state(seed, C=C)
    bu, bl = np.float32(-0.3), np.float32(0.4)
    want = np.asarray(jsmo.shrink_rule(
        jnp.asarray(gamma), jnp.asarray(alpha), jnp.asarray(y),
        jnp.asarray(active), jnp.float32(bu), jnp.float32(bl), C))
    got = tsmo.shrink_rule(_t(gamma), _t(alpha), _t(y), _t(active),
                           torch.tensor(bu), torch.tensor(bl), C).numpy()
    np.testing.assert_array_equal(got, want)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def test_pair_update_matches_reference_to_one_ulp():
    r = np.random.default_rng(3)
    worst = 0
    for _ in range(300):
        C = float(r.choice([0.5, 4.0, 32.0]))
        a_up, a_low = (r.random(2) * C).astype(np.float32)
        if r.random() < 0.3:
            a_up = np.float32(0.0)
        if r.random() < 0.3:
            a_low = np.float32(C)
        y_up, y_low = np.where(r.random(2) < 0.5, 1.0, -1.0).astype(np.float32)
        g_up, g_low = np.sort(r.normal(size=2)).astype(np.float32)
        k_ul = np.float32(r.random())
        args = (a_up, a_low, y_up, y_low, g_up, g_low, k_ul, np.float32(1.0),
                np.float32(1.0))
        want = jsmo.pair_update(*[jnp.float32(a) for a in args], C)
        got = tsmo.pair_update(*[torch.tensor(a) for a in args], C)
        for g, w in zip(got, want):
            worst = max(worst, int(_ulps(g.item(), np.asarray(w))))
    assert worst <= 1, worst


@pytest.mark.parametrize("seed", range(3))
def test_wss2_scores_match_reference(seed):
    C = 4.0
    alpha, gamma, y, active = _state(seed, C=C)
    r = np.random.default_rng(seed + 10)
    row = r.random(alpha.size).astype(np.float32)
    kdiag = np.ones_like(row)
    g_up = np.float32(gamma.min())
    want = np.asarray(jsmo.wss2_scores(
        jnp.asarray(gamma), jnp.asarray(alpha), jnp.asarray(y),
        jnp.asarray(active), C, jnp.float32(g_up), jnp.asarray(row),
        jnp.asarray(kdiag), jnp.float32(1.0)))
    got = tsmo.wss2_scores(_t(gamma), _t(alpha), _t(y), _t(active), C,
                           torch.tensor(g_up), _t(row), _t(kdiag),
                           torch.tensor(1.0)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_layouts_match_reference(p):
    r = np.random.default_rng(p)
    for M in (37, 256):
        keep = r.random(M) < r.random()
        n_act = int(keep.sum())
        m_per = max(1, -(-n_act // p)) + int(r.integers(0, 5))
        src, valid = tdp.compact_plan(_t(keep), n_act, p, m_per)
        jsrc, jvalid = jdp.compact_plan(jnp.asarray(keep), jnp.int32(n_act),
                                        p, m_per)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
        X = r.normal(size=(M, 3)).astype(np.float32)
        sq = (X * X).sum(1)
        gids = np.where(r.random(M) < 0.9, np.arange(M), -1)
        got = tdp.gather_rows(tdp.DenseData(_t(X), _t(sq), _t(gids)),
                              src, valid)
        want = jdp.gather_rows(jdp.DenseData(jnp.asarray(X), jnp.asarray(sq),
                                             jnp.asarray(gids, jnp.int32)),
                               jsrc, jvalid)
        np.testing.assert_array_equal(got.X.numpy(), np.asarray(want.X))
        np.testing.assert_array_equal(got.sq_norms.numpy(),
                                      np.asarray(want.sq_norms))
        np.testing.assert_array_equal(got.gids.numpy(), np.asarray(want.gids))
        rows = np.sort(r.choice(M, size=n_act, replace=False))
        for a, b in zip(tdp.full_layout(rows, p, m_per),
                        jdp.full_layout(rows, p, m_per)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,scale", [("a9a", 0.01), ("ijcnn", 0.004),
                                        ("mnist", 0.002), ("covtype", 0.0003),
                                        ("news20", 0.004)])
def test_synthetic_make_is_byte_equal_to_reference(name, scale):
    got = tsyn.make(name, scale, seed=1)
    want = jsyn.make(name, scale, seed=1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdevice.resolve("cuda")
    with pytest.raises(RuntimeError):
        tsolver.SMOSolver(tsolver.SVMConfig())
    assert tdevice.resolve("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("field,value", [
    ("row_cache_slots", 128), ("row_cache", True), ("checkpoint_dir", "ckpt"),
    ("resume", True), ("watchdog_threshold", 2.0), ("ckpt_retries", 5)])
def test_later_slice_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="slice"):
        tsolver.SVMConfig(**{field: value, "device": "cpu"})
