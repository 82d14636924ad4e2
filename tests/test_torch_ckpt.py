"""The port's checkpoint layer (``repro_torch.ckpt.checkpoint``), elastic
helpers (``launch.elastic``) and chaos harness (``launch.chaos``): the
twins of the reference's unit tests (``tests/test_elastic.py``,
``tests/test_chaos.py``'s checkpoint-layer units), and the on-disk format
held against the reference's own module in both directions — the same
``/``-joined keys, the same per-array sha256 on the same arrays, and a
step written by either package restored by the other."""
import json
import os

import numpy as np
import pytest
import torch

import jax
from repro.ckpt import checkpoint as jck

from repro_torch.ckpt import checkpoint as ck
from repro_torch.launch import chaos, elastic


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture()
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(elastic.time, "perf_counter", c)
    return c


def _step(wd, clock, dt):
    wd.start_step()
    clock.t += dt
    return wd.end_step()


# -- the watchdog ------------------------------------------------------------

def test_watchdog_warmup_suppresses_events(clock):
    wd = elastic.StragglerWatchdog(threshold=2.0, warmup=3)
    for _ in range(3):
        assert _step(wd, clock, 100.0) is False
    assert wd.events == []
    assert _step(wd, clock, 150.0) is False     # median 100: not 2x
    assert _step(wd, clock, 201.0) is True
    assert len(wd.events) == 1


def test_watchdog_threshold_and_median(clock):
    wd = elastic.StragglerWatchdog(threshold=3.0, warmup=3)
    for _ in range(5):
        assert _step(wd, clock, 1.0) is False
    assert _step(wd, clock, 2.9) is False
    assert _step(wd, clock, 3.1) is True
    step, dt, med = wd.events[-1]
    assert step == 7 and dt == pytest.approx(3.1) \
        and med == pytest.approx(1.0)


def test_watchdog_straggler_excluded_from_window(clock):
    wd = elastic.StragglerWatchdog(threshold=2.0, warmup=3)
    for _ in range(4):
        _step(wd, clock, 1.0)
    assert _step(wd, clock, 10.0) is True
    assert 10.0 not in wd._times
    assert _step(wd, clock, 10.0) is True       # the baseline did not move
    assert len(wd.events) == 2


def test_watchdog_window_is_bounded(clock):
    wd = elastic.StragglerWatchdog(threshold=3.0, window=8, warmup=3)
    for i in range(50):
        _step(wd, clock, 1.0 + 0.001 * i)
    assert len(wd._times) == 8
    assert min(wd._times) == pytest.approx(1.0 + 0.001 * 42)


def test_watchdog_callback(clock):
    seen = []
    wd = elastic.StragglerWatchdog(
        threshold=2.0, warmup=3,
        on_straggle=lambda step, dt, med: seen.append((step, dt, med)))
    for _ in range(3):
        _step(wd, clock, 1.0)
    _step(wd, clock, 5.0)
    assert len(seen) == 1
    step, dt, med = seen[0]
    assert step == 4 and dt == pytest.approx(5.0) \
        and med == pytest.approx(1.0)


def test_watchdog_requires_start(clock):
    with pytest.raises(AssertionError):
        elastic.StragglerWatchdog().end_step()


# -- rescale -----------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 8)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32)}


def test_rescale_round_trip(tmp_path):
    base = str(tmp_path)
    params = _tree(0)
    ck.save(os.path.join(base, "step_7"), 7, {"params": params})
    like = {k: np.zeros_like(v) for k, v in params.items()}
    out, step = elastic.rescale(base, {"params": like})
    assert step == 7
    for k in params:
        assert isinstance(out["params"][k], np.ndarray)
        np.testing.assert_array_equal(out["params"][k], params[k])


def test_rescale_picks_newest_complete_step(tmp_path):
    base = str(tmp_path)
    old, new = _tree(1), _tree(2)
    ck.save(os.path.join(base, "step_3"), 3, {"params": old})
    ck.save(os.path.join(base, "step_9"), 9, {"params": new})
    like = {k: np.zeros_like(v) for k, v in old.items()}
    out, step = elastic.rescale(base, {"params": like})
    assert step == 9
    np.testing.assert_array_equal(out["params"]["w"], new["w"])
    out3, step3 = elastic.rescale(base, {"params": like}, step=3)
    assert step3 == 3
    np.testing.assert_array_equal(out3["params"]["w"], old["w"])
    chaos.flip_byte(os.path.join(base, "step_9", "params.npz"))
    _, step = elastic.rescale(base, {"params": like})
    assert step == 3                        # the corrupt newest is skipped


def test_rescale_no_checkpoints_raises(tmp_path):
    like = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(FileNotFoundError):
        elastic.rescale(str(tmp_path / "empty"), {"params": like})


def test_rescale_to_tensors_on_a_device(tmp_path):
    """``device=`` takes the place of the reference's shardings: leaves
    come back as tensors there, in the dtype of the ``like`` tree — bf16
    included, stored as fp32 and cast back."""
    base = str(tmp_path)
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(0))
    tree = {"w": w.to(torch.bfloat16), "n": np.arange(5, dtype=np.int64)}
    ck.save(os.path.join(base, "step_2"), 2, {"params": tree})
    with np.load(os.path.join(base, "step_2", "params.npz")) as z:
        assert z["w"].dtype == np.float32
    out, _ = elastic.rescale(base, {"params": tree}, device="cpu")
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"], tree["w"])
    assert isinstance(out["params"]["n"], torch.Tensor)
    assert out["params"]["n"].tolist() == list(range(5))


# -- the checkpoint layer ----------------------------------------------------

def test_restore_detects_per_array_corruption(tmp_path):
    d = str(tmp_path / "step_1")
    ck.save(d, 1, {"g": {"a": np.arange(32, dtype=np.float32)}})
    fn = os.path.join(d, "g.npz")
    with np.load(fn) as z:
        data = {k: np.array(z[k]) for k in z.files}
    data["a"][3] += 1.0
    np.savez(fn, **data)
    man = ck.load_manifest(d)
    man["groups"]["g"]["sha256"] = ck._sha(fn)   # only the array sha is stale
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError, match="content checksum"):
        ck.restore(d, "g", {"a": np.zeros(32, np.float32)})


def test_restore_checks_shapes(tmp_path):
    d = str(tmp_path / "step_1")
    ck.save(d, 1, {"g": {"a": np.zeros(4, np.float32)}})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(d, "g", {"a": np.zeros(5, np.float32)})


def test_complete_steps_skips_torn_and_corrupt(tmp_path):
    base = str(tmp_path)
    for s in (1, 2, 3):
        ck.save(os.path.join(base, f"step_{s}"), s,
                {"g": {"a": np.full(8, float(s), np.float32)}})
    os.makedirs(os.path.join(base, "step_4"))           # torn: no manifest
    chaos.flip_byte(os.path.join(base, "step_3", "g.npz"))
    assert ck.complete_steps(base) == [1, 2]
    with pytest.warns(UserWarning, match="torn"):
        assert ck.latest_step(base) == 3
    assert not ck.step_complete(os.path.join(base, "step_3"))


def test_save_overwrite_replaces_atomically(tmp_path):
    d = str(tmp_path / "step_5")
    ck.save(d, 5, {"g": {"a": np.zeros(4, np.float32)}})
    ck.save(d, 5, {"g": {"a": np.ones(4, np.float32)}})
    assert ck.step_complete(d)
    out = ck.restore(d, "g", {"a": np.zeros(4, np.float32)})
    np.testing.assert_array_equal(out["a"], np.ones(4))
    assert sorted(os.listdir(tmp_path)) == ["step_5"]


def test_async_save_takes_its_copy_at_the_call(tmp_path):
    d = str(tmp_path / "step_1")
    a = np.arange(8, dtype=np.float32)
    t = ck.save(d, 1, {"g": {"a": a}}, async_=True)
    a[:] = -1.0                       # the caller moves on at once
    t.join()
    out = ck.restore(d, "g", {"a": np.zeros(8, np.float32)})
    np.testing.assert_array_equal(out["a"], np.arange(8))


def test_with_retries_bounded_backoff():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert ck.with_retries(flaky, attempts=3, backoff=0.001) == ("ok", 2)

    def dead():
        raise OSError("gone")

    with pytest.raises(IOError, match="failed after 2"):
        ck.with_retries(dead, attempts=2, backoff=0.001)

    def corrupt():
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        ck.with_retries(corrupt, attempts=5, backoff=0.001)


def test_parse_spec():
    p = chaos.parse_spec("kill@3")
    assert p.kill_at_dispatch == 3 and p.kill_at_save is None
    assert chaos.parse_spec("kill-save@2").kill_at_save == 2
    p = chaos.parse_spec("delay@5:0.25")
    assert p.delay_dispatch == 5 and p.delay_seconds == 0.25 \
        and not p.delay_every
    assert chaos.parse_spec("delay-all@1:0.1").delay_every
    for bad in ("explode@1", "kill"):
        with pytest.raises(ValueError):
            chaos.parse_spec(bad)


def test_hooks_count_and_fire():
    chaos.on_dispatch(0)                # no plan: a no-op
    with chaos.inject(chaos.FaultPlan(kill_at_dispatch=2,
                                      kill_at_save=1)) as plan:
        chaos.on_dispatch(0)
        chaos.on_dispatch(1)
        chaos.on_save(0)
        with pytest.raises(chaos.InjectedKill):
            chaos.on_dispatch(2)
        with pytest.raises(chaos.InjectedKill):
            chaos.on_save(1)
    assert (plan.dispatches, plan.saves) == (3, 2)
    assert chaos._PLAN is None


@pytest.mark.parametrize("mode", ["truncate", "flip", "manifest"])
def test_corrupt_step_makes_the_step_incomplete(tmp_path, mode):
    base = str(tmp_path)
    for s in (4, 8):
        ck.save(os.path.join(base, f"step_{s}"), s,
                {"svm": {"a": np.full(64, float(s), np.float32)}})
    d = chaos.corrupt_step(base, mode=mode)
    assert d.endswith("step_8")
    assert ck.complete_steps(base) == [4]
    with pytest.raises(ValueError, match="mode"):
        chaos.corrupt_step(base, step=4, mode="melt")


# -- the format, against the reference's module ------------------------------

_ARRAYS = {
    "f32": np.linspace(-1, 1, 24, dtype=np.float32).reshape(4, 6),
    "f64": np.linspace(0, 3, 7),
    "i8": np.array([0, 1, 1, 0], np.int8),
    "i64": np.arange(9, dtype=np.int64).reshape(3, 3),
    "bool": np.array([True, False, True]),
    "scalar": np.float32(2.5),
    "fortran": np.asfortranarray(np.arange(12, dtype=np.float32)
                                 .reshape(3, 4)),
}


@pytest.mark.parametrize("name", sorted(_ARRAYS))
def test_array_sha_matches_the_reference(name):
    a = _ARRAYS[name]
    assert ck.array_sha(a) == jck.array_sha(a)
    t = torch.as_tensor(np.ascontiguousarray(a))
    assert ck.array_sha(t) == jck.array_sha(a)


def _nested():
    r = np.random.default_rng(3)
    return {"svm": {"alpha": r.random(10).astype(np.float32),
                    "masks": [np.arange(3, dtype=np.int8),
                              (np.ones(2, np.int64), np.zeros(4))]},
            "b": np.float32(1.0), "z": {"k": np.arange(5)}}


def test_flatten_keys_match_the_reference():
    tree = _nested()
    mine = ck._flatten(tree)
    ref, _ = jck._flatten(tree)
    assert list(mine) == list(ref)
    for k in ref:
        assert jck.array_sha(mine[k]) == jck.array_sha(np.asarray(ref[k]))


def test_a_port_step_restores_in_the_reference(tmp_path):
    d = str(tmp_path / "step_3")
    tree = _nested()
    ck.save(d, 3, {"g": tree}, extra={"note": "port"})
    assert jck.step_complete(d)
    out = jck.restore(d, "g", tree)
    for (k, a), b in zip(ck._leaves(tree), jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), k)
    assert jck.load_manifest(d)["extra"] == {"note": "port"}


def test_a_reference_step_restores_in_the_port(tmp_path):
    d = str(tmp_path / "step_5")
    tree = _nested()
    jck.save(d, 5, {"g": tree}, extra={"note": "reference"})
    assert ck.step_complete(d) and ck.complete_steps(str(tmp_path)) == [5]
    out = ck.restore(d, "g", tree)
    assert isinstance(out["svm"]["masks"][1], tuple)
    for (k, a), (_, b) in zip(ck._leaves(tree), ck._leaves(out)):
        assert b.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b, a, k)
    man = ck.load_manifest(d)
    flat = ck._flatten(tree)
    assert man["groups"]["g"]["array_sha256"] == {
        k: ck.array_sha(v) for k, v in flat.items()}
    assert man["groups"]["g"]["keys"] == sorted(flat)
