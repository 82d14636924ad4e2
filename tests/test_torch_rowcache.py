"""The port's kernel-row cache (``repro_torch.core.rowcache``) against the
JAX reference on the same access sequences and plans; the cache-on ==
cache-off bitwise contract inside the port (dense and ELL, wss1 and wss2,
fused or not, through device and host compaction and reconstruction); the
port against the reference with the cache on; the cache-aware FLOP bill;
and the cache's workload generator. All on the CPU at small sizes."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import rowcache as jrc
from repro.core import train as jtrain
from repro.data import synthetic as jsyn

from repro_torch.core import dataplane as tdp
from repro_torch.core import kernel_fns as tkf
from repro_torch.core import rowcache as trc
from repro_torch.core import train as ttrain
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

M = 8          # buffer positions of the unit tests' value table


def _blobs(n=400, d=6, sep=0.9, seed=0):
    """The reference cache tests' two Gaussian blobs."""
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(+sep, 1, (n // 2, d)),
                   rng.normal(-sep, 1, (n // 2, d))]).astype(np.float32)
    y = np.concatenate([np.ones(n // 2), -np.ones(n // 2)]).astype(np.float32)
    return X, y


def _row(g):
    """A distinct, exactly representable row per global id."""
    return np.arange(M, dtype=np.float32) + np.float32(100.0 * g)


def _same(jc, tc):
    """The two caches hold the same state, the value table bitwise."""
    for f in ("tags", "stamp", "seg", "tick", "hits", "misses"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      getattr(tc, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(np.asarray(jc.vals), tc.vals.numpy())


def _state(tc):
    return [getattr(tc, f).clone() for f in
            ("tags", "vals", "stamp", "seg", "tick", "hits", "misses")]


def _access(jc, tc, ids, policy, idle):
    """One access of both caches to the global ids ``ids`` (one: a single
    row; two: a pair). With ``idle``, the port first makes the same access
    not live, which must leave its cache exactly as it was (its rows are
    NaN, so a write of them would show)."""
    rows = np.stack([_row(g) for g in ids], 1)
    nan = torch.full((M, len(ids)), float("nan"))
    live = torch.tensor(True)
    if len(ids) == 2:
        gid = torch.tensor(ids, dtype=torch.int64)
        jrows, jc = jrc.get_pair(jc, jnp.asarray(ids, jnp.int32),
                                 lambda: jnp.asarray(rows), policy)
        at = lambda r: (lambda t, s, h: ref.cached_rows(t, s, h, r))
        if idle:
            before = _state(tc)
            _, tc = trc.get_pair(tc, gid, at(nan), policy, ~live)
            for a, b in zip(before, _state(tc)):
                assert torch.equal(a, b)
        trows, tc = trc.get_pair(tc, gid, at(torch.as_tensor(rows)), policy,
                                 live)
    else:
        gid = torch.tensor(ids[0], dtype=torch.int64)
        jrows, jc = jrc.get_row(jc, jnp.int32(ids[0]),
                                lambda: jnp.asarray(rows[:, 0]), policy)
        at = lambda r: (lambda t, s, h: ref.cached_rows(
            t, torch.stack([s, s]), h, torch.stack([r, r], 1))[:, 0])
        if idle:
            before = _state(tc)
            _, tc = trc.get_row(tc, gid, at(nan[:, 0]), policy, ~live)
            for a, b in zip(before, _state(tc)):
                assert torch.equal(a, b)
        trows, tc = trc.get_row(tc, gid, at(torch.as_tensor(rows[:, 0])),
                                policy, live)
    np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())
    _same(jc, tc)
    return jc, tc


# -------------------------------------------------------------- unit ops
@pytest.mark.parametrize("policy", ["lru", "slru"])
def test_scripted_accesses_match_reference(policy):
    """The reference tests' scenarios, step by step against the reference:
    miss, hit, a pair made of rows inserted by different pairs, eviction of
    the least recently used, a duplicate id in one pair, single rows; under
    SLRU, promotion on a hit and demotion past the protected half."""
    jc, tc = jrc.init_cache(4, M), trc.init_cache(4, M, "cpu")
    seq = [(10, 11), (10, 11), (12, 13), (11, 12), (20, 21), (9, 9), (5,),
           (5,), (20, 5), (21, 9), (20,), (30, 31), (11, 30)]
    for ids in seq:
        jc, tc = _access(jc, tc, ids, policy, idle=True)
        if ids == (10, 11) and int(tc.hits) == 2:
            assert int(tc.misses) == 2                # served from the table
        if ids == (11, 12):
            assert int(tc.hits) == 4                  # rows of two pairs
        if ids == (20, 21) and policy == "lru":
            assert set(tc.tags.tolist()) == {11, 12, 20, 21}
        if ids == (9, 9):
            assert int((tc.tags == 9).sum()) == 1     # one slot, not two
    if policy == "slru":
        assert int(tc.seg.sum()) == 2                 # protected half full


@pytest.mark.parametrize("policy,slots,seed", [
    ("lru", 2, 0), ("lru", 4, 1), ("lru", 8, 2), ("slru", 2, 3),
    ("slru", 4, 4), ("slru", 8, 5)])
def test_random_accesses_match_reference(policy, slots, seed):
    """Random pairs (duplicates included) and single rows over a small id
    pool, every step against the reference; every other access is first
    made not live in the port. At two slots SLRU evicts a pair's first row
    for its second, which the value writes must take in order."""
    r = np.random.default_rng(seed)
    jc, tc = jrc.init_cache(slots, M), trc.init_cache(slots, M, "cpu")
    for step in range(60):
        k = 1 if r.random() < 0.3 else 2
        ids = tuple(int(g) for g in r.integers(0, 3 * slots // 2 + 2, k))
        jc, tc = _access(jc, tc, ids, policy, idle=step % 2 == 0)
    assert int(tc.hits) > 0 and int(tc.misses) > 0


def test_slot_bucketing_and_solver_sizing():
    from repro_torch.core import SMOSolver, SVMConfig
    for s in (0, 1, 2, 3, 64, 65, 100, 2048):
        assert trc.bucket_slots(s) == jrc.bucket_slots(s)
    cfg = dict(row_cache=True, row_cache_slots=100, device="cpu")
    assert SMOSolver(SVMConfig(**cfg))._cache_slots() == 128
    assert SMOSolver(SVMConfig(device="cpu"))._cache_slots() == 0
    assert SMOSolver(SVMConfig(device="cpu"))._new_cache(16) is None


def _filled(slots=3, m=6):
    vals = np.arange(slots * m, dtype=np.float32).reshape(slots, m)
    jc = jrc.init_cache(slots, m)._replace(
        tags=jnp.asarray([4, 9, -1], jnp.int32), vals=jnp.asarray(vals),
        stamp=jnp.asarray([3, 1, 0], jnp.int32), hits=jnp.int32(5),
        misses=jnp.int32(7), tick=jnp.int32(3))
    tc = trc.init_cache(slots, m, "cpu").replace(
        tags=torch.tensor([4, 9, -1]), vals=torch.as_tensor(vals.copy()),
        stamp=torch.tensor([3, 1, 0]), hits=torch.tensor(5),
        misses=torch.tensor(7), tick=torch.tensor(3))
    return jc, tc


@pytest.mark.parametrize("new_idx", [[4, 9, -1, -1], [9, -1], [2, 4, 5, 7, 9,
                                                              -1],
                                     [-1, -1]])
def test_host_remap_matches_reference(new_idx):
    """Shrink re-gathers the surviving columns; growth (a re-added row)
    and an empty buffer invalidate; counters carry over either way."""
    old_idx = np.array([2, 4, 7, 9, -1, -1])
    jc, tc = _filled()
    _same(jrc.remap_cache(jc, old_idx, np.array(new_idx)),
          trc.remap_cache(tc, old_idx, np.array(new_idx)))
    empty = trc.init_cache(3, 6, "cpu")
    _same(jrc.remap_cache(jrc.init_cache(3, 6), old_idx, np.array(new_idx)),
          trc.remap_cache(empty, old_idx, np.array(new_idx)))
    assert trc.remap_cache(None, old_idx, np.array(new_idx)) is None


@pytest.mark.parametrize("keep", [[0, 1, 0, 1, 0, 0], [1, 1, 1, 0, 1, 0],
                                  [0, 0, 0, 0, 0, 1]])
def test_device_remap_matches_reference(keep):
    """The device remap on the compaction's own gather plan: both
    packages' plans for the same survivors, the same gathered table."""
    from repro.core import dataplane as jdp
    keep = np.array(keep, bool)
    n_act = int(keep.sum())
    m_per = 4
    src, valid = tdp.compact_plan(torch.as_tensor(keep), n_act, 1, m_per)
    jsrc, jvalid = jdp.compact_plan(jnp.asarray(keep), jnp.int32(n_act), 1,
                                    m_per)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    jc, tc = _filled()
    _same(jrc.remap_cache_device(jc, jsrc, jvalid),
          trc.remap_cache_device(tc, src, valid))
    assert trc.remap_cache_device(None, src, valid) is None


def test_cached_rows_dispatch_plain_versions_on_cpu():
    """On CPU tensors the cached entries are their plain versions: a hit
    gives the table rows, a miss the bits of the normal entry, for dense
    and ELL rows and for the single row on a duplicated query."""
    r = np.random.default_rng(0)
    X = torch.as_tensor(r.normal(size=(50, 7)).astype(np.float32))
    sq = (X * X).sum(1)
    z2 = X[[3, 11]].contiguous()
    table = torch.as_tensor(r.normal(size=(4, 50)).astype(np.float32))
    slot2 = torch.tensor([2, 0], dtype=torch.int32)
    hit, miss = torch.tensor(1, dtype=torch.int32), torch.tensor(
        0, dtype=torch.int32)
    want = ops.kernel_rows2("rbf", X, sq, z2, 0.1)
    got = ops.kernel_rows2_cached("rbf", X, sq, z2, table, slot2, miss, 0.1)
    assert torch.equal(got, want)
    got = ops.kernel_rows2_cached("rbf", X, sq, z2, table, slot2, hit, 0.1)
    assert torch.equal(got, table[[2, 0]].T)
    e = tdp.ELLData(*(torch.as_tensor(a) for a in _ell(X.numpy())), sq, 7)
    want = ops.ell_kernel_rows2(e.vals, e.cols, sq, z2, 0.1)
    got = ops.ell_kernel_rows2_cached(e.vals, e.cols, sq, z2, table, slot2,
                                      miss, 0.1)
    assert torch.equal(got, want) and got.stride() == want.stride()
    for fmt, data in (("dense", tdp.DenseData(X, sq)), ("ell", e)):
        p = tkf.make_provider("rbf", fmt, True, 0.1)
        s = torch.tensor(1, dtype=torch.int32)
        assert torch.equal(tkf.row_via_rows2_cached(p, data, z2[0], table, s,
                                                    miss),
                           tkf.row_via_rows2(p, data, z2[0]))
        assert torch.equal(tkf.row_via_rows2_cached(p, data, z2[0], table, s,
                                                    hit), table[1])


def _ell(X):
    from repro_torch.data import to_ell
    e = to_ell(X)
    return e.vals, e.cols


# ------------------------------------------- exactness (the core contract)
@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("selection", ["wss1", "wss2"])
@pytest.mark.parametrize("fuse", [1, 4])
def test_cache_on_equals_off_bitwise(fmt, selection, fuse):
    """Cache on == cache off, bitwise (iterations, alpha, beta), through
    physical compactions (the device remap, LRU, 64 slots; the host remap,
    SLRU, 8 slots) and reconstruction un-shrinks (the rewarm). On the CPU
    the plain fused update is the rows' epilogue, so wss1 is bitwise
    too."""
    X, y = _blobs()
    kw = dict(C=4.0, sigma2=4.0, heuristic="multi5pc", chunk_iters=32,
              min_buffer=64, format=fmt, selection=selection,
              fuse_iters=fuse, device="cpu")
    m0 = ttrain(X, y, **kw)
    assert m0.stats.compactions >= 1 and m0.stats.reconstructions >= 1
    assert m0.stats.cache_hits == m0.stats.cache_misses == 0
    for extra in (dict(), dict(compact_backend="host",
                               row_cache_policy="slru", row_cache_slots=8)):
        m1 = ttrain(X, y, row_cache=True, **kw, **extra)
        assert m1.stats.iterations == m0.stats.iterations, extra
        assert m1.stats.compactions == m0.stats.compactions
        np.testing.assert_array_equal(m1.alpha, m0.alpha)
        assert m1.beta == m0.beta
        assert m1.stats.cache_hits > 0
        assert m1.stats.cache_hits + m1.stats.cache_misses \
            == 2 * m1.stats.iterations


@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_cached_fit_matches_reference(selection):
    """Port against reference with the cache on: the outcome contract, and
    one pair (wss1) or two single rows (wss2) looked up an iteration in
    both packages."""
    from test_torch_solver import eq9_gap
    X, y = _blobs()
    C, s2, eps = 4.0, 4.0, 1e-3
    kw = dict(C=C, sigma2=s2, eps=eps, heuristic="multi5pc", chunk_iters=64,
              selection=selection, row_cache=True)
    mt, mj = ttrain(X, y, device="cpu", **kw), jtrain(X, y, **kw)
    assert mt.stats.converged == mj.stats.converged
    assert abs(mt.dual_objective() - mj.dual_objective()) \
        / abs(mj.dual_objective()) < 5e-4
    assert (mt.predict(X) == np.asarray(mj.predict(X))).mean() >= 0.995
    assert eq9_gap(X, y, mt.alpha, C, s2) <= 2 * eps
    for st in (mt.stats, mj.stats):
        assert st.cache_hits + st.cache_misses == 2 * st.iterations
        assert st.cache_hits > 0


def test_cache_hits_and_flops_discount():
    X, y = _blobs()
    kw = dict(C=4.0, sigma2=4.0, heuristic="multi5pc", chunk_iters=64,
              device="cpu")
    m0 = ttrain(X, y, **kw)
    m1 = ttrain(X, y, row_cache=True, **kw)
    st = m1.stats
    assert st.cache_hits + st.cache_misses == 2 * st.iterations
    assert st.cache_hit_rate > 0.3                  # repeat-heavy tail
    assert 0 < st.flops_est < m0.stats.flops_est    # hits are discounted
    assert st.flops_est == st.flops_production + st.flops_epilogue
    assert st.cache_hit_rate == pytest.approx(
        st.cache_hits / (st.cache_hits + st.cache_misses))
    assert m0.stats.cache_hit_rate == 0.0


@pytest.mark.parametrize("args", [dict(n=64, d=32, seed=3),
                                  dict(n=301, d=96, density=0.1, sep=1.2),
                                  dict()])
def test_make_repeat_heavy_is_byte_equal(args):
    Xt, yt = tsyn.make_repeat_heavy(**args)
    Xj, yj = jsyn.make_repeat_heavy(**args)
    assert Xt.dtype == Xj.dtype and yt.dtype == yj.dtype
    assert Xt.tobytes() == Xj.tobytes() and yt.tobytes() == yj.tobytes()
