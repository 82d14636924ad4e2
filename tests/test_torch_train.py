"""The port's LM training path against the JAX reference on the same numpy
inputs: the token pipeline (bitwise), ``cross_entropy`` and its gradient,
AdamW (schedule and updates), ``make_train_step`` for one arch of each
family and with gradient accumulation, the flash kernel's autograd
Function, checkpoints of ``{'params', 'opt'}`` resumed across the two
packages; and, inside the port, remat on == off and a resumed
``launch.train`` run bit for bit. The card-side flash backward is held in
``test_torch_cuda.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.data import TokenPipeline as JTokenPipeline
from repro.kernels import ops as jops
from repro.launch import mesh as jmesh
from repro.launch import train_lib as jtrain_lib
from repro.models import common as jcommon
from repro.optim import adamw as jadamw

from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.data import TokenPipeline
from repro_torch.kernels import ops, ref
from repro_torch.launch import chaos, dist, train, train_lib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.models import common
from repro_torch.models.api import build
from repro_torch.optim import adamw

torch.set_num_threads(1)

# one arch of each family: dense, moe, audio (embeds frontend), ssm, hybrid
ARCHS = ["llama3-8b", "phi3.5-moe-42b-a6.6b", "musicgen-large",
         "xlstm-125m", "zamba2-1.2b"]
OCFG = dict(lr=3e-3, warmup_steps=20, decay_steps=100)   # the example's
B, L, STEPS = 4, 32, 3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _flat(tree, prefix="") -> dict:
    """{path: fp32 numpy} of a nested dict (either package's leaves)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = _np(v)
    return out


def _batches(cfg, n: int) -> list:
    """The example's batches: TokenPipeline steps 0..n-1, through the
    embeds stub for an embeds frontend; numpy."""
    tp = TokenPipeline(cfg.vocab_size, batch=B, seq_len=L, seed=0)
    emb = np.random.default_rng(0).normal(
        scale=0.02, size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
    out = []
    for i in range(n):
        raw = tp.batch_at(i)
        if cfg.frontend == "embeds":
            raw = {"embeds": emb[raw["tokens"]], "targets": raw["targets"]}
        out.append(raw)
    return out


def _tree_np(tree: dict) -> dict:
    return {k: _tree_np(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _port_batch(b: dict) -> dict:
    return {k: torch.tensor(v) for k, v in b.items()}


class RefRun:
    """The reference's train step jitted on a one-device mesh, from the
    port's seeded init of the same config (the two trees have one layout;
    the reference's own init compiles for seconds): the initial params as
    numpy, and after each step the loss, grad norm, params and optimizer
    state."""

    def __init__(self, arch: str, accum_steps: int = 1):
        self.cfg = jconfigs.smoke_config(arch)
        mesh = jmesh.make_mesh((1,), ("data",))
        step = jtrain_lib.make_train_step(
            self.cfg, jadamw.AdamWConfig(**OCFG), mesh,
            accum_steps=accum_steps)
        self.batches = _batches(self.cfg, STEPS)
        cfg = _port_cfg(self.cfg)
        init = build(cfg).init(cfg, torch.Generator().manual_seed(0))
        self.init = _tree_np(init)
        with jmesh.set_mesh(mesh):
            params = jax.tree.map(jnp.asarray, self.init)
            opt = jadamw.init(params)
            self.jstep = jax.jit(step)
            self.hist = []
            for b in self.batches:
                params, opt, m = self.jstep(params, opt,
                                            jax.tree.map(jnp.asarray, b))
                self.hist.append(dict(
                    loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                    params=jax.tree.map(np.asarray, params),
                    opt=jax.tree.map(np.asarray, opt)))
        self.mesh = mesh

    def step_from(self, params: dict, opt: dict, i: int) -> tuple:
        """One reference step on batch ``i`` from numpy trees: (params,
        opt, loss, grad norm)."""
        with jmesh.set_mesh(self.mesh):
            p, o, m = self.jstep(jax.tree.map(jnp.asarray, params),
                                 jax.tree.map(jnp.asarray, opt),
                                 jax.tree.map(jnp.asarray, self.batches[i]))
            return (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o),
                    float(m["loss"]), float(m["grad_norm"]))


@pytest.fixture(scope="module")
def ref_runs():
    cache = {}

    def get(arch, accum_steps=1):
        if (arch, accum_steps) not in cache:
            cache[arch, accum_steps] = RefRun(arch, accum_steps)
        return cache[arch, accum_steps]

    return get


def _port_cfg(jcfg, **kw):
    return dataclasses.replace(
        convert.model_config(dataclasses.asdict(jcfg)), **kw)


def _port_steps(cfg, init_np: dict, batches: list, accum_steps=1,
                params=None, opt=None) -> tuple:
    """The port's train step over ``batches`` from the reference's init
    (or from ``params`` / ``opt``): (params, opt, [(loss, gnorm, lr)])."""
    if params is None:
        params = convert.lm_params(init_np, "cpu")
        opt = adamw.init(params)
    step = train_lib.make_train_step(cfg, adamw.AdamWConfig(**OCFG),
                                     accum_steps=accum_steps)
    hist = []
    for b in batches:
        params, opt, m = step(params, opt, _port_batch(b))
        hist.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["lr"])))
    return params, opt, hist


NOISE = 1e-3


def _assert_steps(hist, want, params, want_params, ms):
    """Loss and grad norm within 1e-5 relative each step; params within
    1e-5 absolute. Adam divides a gradient by its own size, so an element
    whose gradient sits in the cross-package rounding noise (the step's
    gradients agree to ~5e-6 of each leaf's max |g|) gets an update of
    either sign: an element over 1e-5 must have had, at some step, a
    reference gradient below ``NOISE`` of its leaf's max |g| (recovered
    from the first moments ``ms``, the state before the first step and
    after each), and stay within twice the summed learning rates."""
    for (loss, gn, _), w in zip(hist, want):
        np.testing.assert_allclose(loss, w["loss"], rtol=1e-5)
        np.testing.assert_allclose(gn, w["grad_norm"], rtol=1e-5)
    got, exp = _flat(params), _flat(want_params)
    assert got.keys() == exp.keys()
    ms = [_flat(m) for m in ms]
    grads = [{k: (b[k] - 0.9 * a[k]) / 0.1 for k in b}
             for a, b in zip(ms, ms[1:])]
    bound = 2 * sum(lr for _, _, lr in hist)
    for k in exp:
        d = np.abs(got[k] - exp[k])
        bad = d > 1e-5
        if bad.any():
            noisy = np.zeros(bad.shape, bool)
            for g in grads:
                noisy |= np.abs(g[k]) < NOISE * np.abs(g[k]).max()
            assert noisy[bad].all() and d.max() <= bound, (k, d.max())


def _ms(run, lo: int, hi: int) -> list:
    """The reference's first moments before step ``lo`` and after each
    step up to ``hi`` (1-based)."""
    zero = jax.tree.map(np.zeros_like, run.hist[0]["opt"]["m"])
    return [zero if s == 0 else run.hist[s - 1]["opt"]["m"]
            for s in range(lo - 1, hi + 1)]


# ------------------------------------------------------------ token stream
@pytest.mark.parametrize("seed", [0, 3])
def test_token_pipeline_bitwise(seed):
    mine = TokenPipeline(256, batch=4, seq_len=40, seed=seed)
    theirs = JTokenPipeline(256, batch=4, seq_len=40, seed=seed)
    for step in range(3):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
        for host in range(2):
            a, b = mine.shard_for(step, host, 2), theirs.shard_for(step,
                                                                    host, 2)
            for k in a:
                assert np.array_equal(a[k], b[k])


# ------------------------------------------------------------------- loss
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(z_loss):
    r = np.random.default_rng(5)
    lg = (r.normal(size=(3, 9, 50)) * 3).astype(np.float32)
    tg = r.integers(0, 50, size=(3, 9)).astype(np.int32)
    tg[0, 2] = tg[2, 8] = tg[1, 0] = -1
    (jl, jm), jg = jax.value_and_grad(
        lambda x: jcommon.cross_entropy(x, jnp.asarray(tg), z_loss),
        has_aux=True)(jnp.asarray(lg))
    x = torch.tensor(lg, requires_grad=True)
    loss, m = common.cross_entropy(x, torch.tensor(tg), z_loss)
    (g,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(m["ce"].detach()), float(jm["ce"]),
                               rtol=1e-6)
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= 1e-6 * np.abs(jg).max()
    assert not g.numpy()[0, 2].any()            # masked positions: no grad


# -------------------------------------------------------------- optimizer
def test_schedule_matches_reference():
    cfg = adamw.AdamWConfig(**OCFG)
    jcfg = jadamw.AdamWConfig(**OCFG)
    for s in (1, 19, 20, 21, 60, 100, 10_000):
        got = float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
        want = float(jadamw.schedule(jcfg, jnp.int32(s)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(s))


@pytest.mark.parametrize("clipped", [True, False])
def test_adamw_updates_match_reference(clipped):
    """Five updates of a tree with a 1-D leaf (not decayed), a stacked 2-D
    norm and a matrix (decayed); gradients ~50 in norm engage the clip at
    1.0, ~0.05 do not."""
    r = np.random.default_rng(11)
    tree = {"b": r.normal(size=(7,)), "layers": {
        "ln": 1.0 + 0.1 * r.normal(size=(3, 5)),
        "w": r.normal(size=(5, 6)) * 0.2}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    cfg, jcfg = adamw.AdamWConfig(**OCFG), jadamw.AdamWConfig(**OCFG)
    p, jp = convert.lm_params(tree, "cpu"), jax.tree.map(jnp.asarray, tree)
    o, jo = adamw.init(p), jadamw.init(jp)
    gscale = 10.0 if clipped else 0.01
    for _ in range(5):
        g = jax.tree.map(lambda a: (r.normal(size=a.shape) * gscale)
                         .astype(np.float32), tree)
        p, o, m = adamw.update(cfg, convert.lm_params(g, "cpu"), o, p)
        jp, jo, jm = jadamw.update(jcfg, jax.tree.map(jnp.asarray, g), jo, jp)
        assert (float(m["grad_norm"]) > 1.0) == clipped
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    assert int(o["step"]) == int(jo["step"]) == 5
    for mine, theirs in ((p, jp), (o["m"], jo["m"]), (o["v"], jo["v"])):
        got, want = _flat(mine), _flat(jax.tree.map(np.asarray, theirs))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_adamw_updates_in_place():
    p = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    o = adamw.init(p)
    ids = [id(t) for t in adamw.leaves(p) + adamw.leaves(o["m"])]
    w = p["w"]
    p2, o2, _ = adamw.update(adamw.AdamWConfig(lr=0.1, warmup_steps=1),
                             {"w": torch.ones(3, 2), "b": torch.ones(2)},
                             o, p)
    assert p2 is p and o2 is o and p["w"] is w
    assert [id(t) for t in adamw.leaves(p) + adamw.leaves(o["m"])] == ids
    assert (p["w"] < 1).all() and (p["b"] < 0).all()


# ------------------------------------------------------------- train step
def _held_each_step(run, accum_steps: int = 1) -> None:
    """Each reference step against the port's step from the same state
    (the reference's params and optimizer state before it): a trajectory
    run free would carry one step's rounding into the next."""
    cfg = _port_cfg(run.cfg)
    prev_p, prev_o = run.init, None
    for s, want in enumerate(run.hist):
        params = convert.lm_params(prev_p, "cpu")
        opt = adamw.init(params) if prev_o is None else \
            convert.adamw_state(prev_o, "cpu")
        params, _, hist = _port_steps(cfg, None, run.batches[s: s + 1],
                                      accum_steps, params=params, opt=opt)
        _assert_steps(hist, [want], params, want["params"],
                      _ms(run, s + 1, s + 1))
        prev_p, prev_o = want["params"], want["opt"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(ref_runs, arch):
    _held_each_step(ref_runs(arch))


def test_train_step_accumulation_matches_reference(ref_runs):
    _held_each_step(ref_runs("llama3-8b", accum_steps=2), accum_steps=2)


def _one_rank_group(tmp_path):
    dist.init(device="cpu", init_method="file://" + str(tmp_path / "pg"),
              rank=0, world=1)


def test_train_step_metrics_and_refusals(ref_runs, tmp_path):
    """The step's metrics; on a mesh of the one-rank group, the same
    metrics and the same bits (``test_torch_mesh_train.py`` holds the
    meshes of 4 ranks); the refusals that stay."""
    run = ref_runs("phi3.5-moe-42b-a6.6b")
    cfg = _port_cfg(run.cfg)
    params = convert.lm_params(run.init, "cpu")
    step = train_lib.make_train_step(cfg, adamw.AdamWConfig(**OCFG))
    _, opt, m = step(params, adamw.init(params), _port_batch(run.batches[0]))
    assert set(m) == {"ce", "router_aux", "loss", "grad_norm", "lr"}
    assert int(opt["step"]) == 1
    assert not any(w.requires_grad for w in adamw.leaves(params))
    _one_rank_group(tmp_path)
    try:
        mesh = meshlib.make_mesh((1, 1), ("data", "model"))
        specs = train_lib.shardings_for(cfg, mesh, {})[0]
        blocks = shd.shard_tree(convert.lm_params(run.init, "cpu"), specs,
                                mesh)
        _, opt2, m2 = train_lib.make_train_step(
            cfg, adamw.AdamWConfig(**OCFG), mesh)(
            blocks, adamw.init(blocks), _port_batch(run.batches[0]))
        assert {k: float(v) for k, v in m2.items()} == \
            {k: float(v) for k, v in m.items()}
        assert all(torch.equal(a, b) for a, b in zip(
            adamw.leaves(blocks) + adamw.leaves(opt2),
            adamw.leaves(params) + adamw.leaves(opt)))
        with pytest.raises(ValueError, match="world of 1"):
            meshlib.make_mesh((2, 2), ("data", "model"))
        with pytest.raises(ValueError, match="grad_compress"):
            train_lib.make_train_step(cfg, adamw.AdamWConfig(), mesh,
                                      grad_compress="fp8")
    finally:
        dist.destroy()
    with pytest.raises(ValueError, match="equal microbatches"):
        train_lib.make_train_step(cfg, adamw.AdamWConfig(), accum_steps=3)(
            params, adamw.init(params), _port_batch(run.batches[0]))


@pytest.mark.parametrize("arch", ["llama3-8b", "xlstm-125m", "zamba2-1.2b"])
def test_remat_full_equals_none_bitwise(ref_runs, arch):
    run = ref_runs(arch)
    out = {}
    for remat in ("none", "full"):
        out[remat] = _port_steps(_port_cfg(run.cfg, remat=remat), run.init,
                                 run.batches[:2])
    (p0, o0, h0), (p1, o1, h1) = out["none"], out["full"]
    assert h0 == h1
    for a, b in zip(adamw.leaves(p0) + adamw.leaves(o0),
                    adamw.leaves(p1) + adamw.leaves(o1)):
        assert torch.equal(a, b)


def test_remat_runs_each_layer_again_in_the_backward(ref_runs,
                                                     monkeypatch):
    """With remat 'full' the backward recomputes every layer (2 forward
    calls of each); with 'none', or without grad, one."""
    from repro_torch.models import transformer
    run = ref_runs("llama3-8b")
    calls = []
    layer = transformer._block
    monkeypatch.setattr(transformer, "_block",
                        lambda *a: calls.append(1) or layer(*a))
    for remat, want in (("none", 2), ("full", 4)):
        calls.clear()
        _port_steps(_port_cfg(run.cfg, remat=remat), run.init,
                    run.batches[:1])
        assert len(calls) == want, remat
    calls.clear()
    params = convert.lm_params(run.init, "cpu")
    transformer.forward(params, _port_cfg(run.cfg, remat="full"),
                        _port_batch(run.batches[0]))
    assert len(calls) == 2                     # weights need no grad


# ---------------------------------------------------------- flash autograd
@pytest.mark.parametrize("h,hkv,causal", [(4, 2, True), (4, 2, False),
                                          (4, 4, True)])
def test_flash_function_gradients(h, hkv, causal):
    r = np.random.default_rng(h * 7 + hkv + causal)
    shapes = ((2, h, 64, 32), (2, hkv, 64, 32), (2, hkv, 64, 32))
    q, k, v = (r.normal(size=s).astype(np.float32) for s in shapes)
    g = r.normal(size=shapes[0]).astype(np.float32)
    ins = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ops.flash_attention(*ins, causal)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, ins, torch.tensor(g))
    ins2 = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention(*ins2, causal), ins2,
                               torch.tensor(g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _, vjp = jax.vjp(lambda *t: jops.flash_attention(*t, causal),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    with torch.no_grad():
        assert ops.flash_attention(*ins, causal).grad_fn is None


# ------------------------------------------------- checkpoints across both
def test_reference_checkpoint_resumes_in_the_port(ref_runs, tmp_path):
    """The reference's step 2 saved by its own module; the port restores
    it and takes step 3, which matches the reference's uncut step 3."""
    run = ref_runs("llama3-8b")
    d = str(tmp_path / "step_2")
    jckpt.save(d, 2, {"params": run.hist[1]["params"],
                      "opt": run.hist[1]["opt"]})
    cfg = _port_cfg(run.cfg)
    like = convert.lm_params(run.init, "cpu")
    params = ckpt.restore(d, "params", like)
    opt = ckpt.restore(d, "opt", adamw.init(like))
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 2
    params, _, hist = _port_steps(cfg, None, run.batches[2:], params=params,
                                  opt=opt)
    _assert_steps(hist, run.hist[2:], params, run.hist[2]["params"],
                  _ms(run, 3, 3))


def test_port_checkpoint_resumes_in_the_reference(ref_runs, tmp_path):
    """The port's step 2 saved by its module; the reference restores it
    and takes step 3, which matches the port's uncut step 3."""
    run = ref_runs("llama3-8b")
    cfg = _port_cfg(run.cfg)
    params, opt, _ = _port_steps(cfg, run.init, run.batches[:2])
    d = str(tmp_path / "step_2")
    ckpt.save(d, 2, {"params": params, "opt": opt})
    p3, _, hist = _port_steps(cfg, None, run.batches[2:], params=params,
                              opt=opt)
    jp = jckpt.restore(d, "params", run.init)
    jo = jckpt.restore(d, "opt", run.hist[0]["opt"])
    got_p, got_o, loss, gn = run.step_from(jp, jo, 2)
    _assert_steps(hist, [dict(loss=loss, grad_norm=gn)], p3, got_p,
                  [jo["m"], got_o["m"]])


def test_adamw_state_converts_from_reference(ref_runs):
    run = ref_runs("llama3-8b")
    o = convert.adamw_state(run.hist[0]["opt"], "cpu")
    assert o["step"].dtype == torch.int32 and int(o["step"]) == 1
    got, want = _flat(o["v"]), _flat(run.hist[0]["opt"]["v"])
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ----------------------------------------------------------- launch.train
_CLI = ["--arch", "llama3-8b", "--device", "cpu"]


def test_train_cli_learns():
    res = train.main(_CLI + ["--steps", "30"])
    assert len(res["loss"]) == 30
    assert res["loss"][-1] < res["loss"][0] - 0.5, res["loss"]


def test_train_killed_and_resumed_matches_uncut(tmp_path):
    small = ["--batch", "4", "--seq", "32", "--ckpt-every", "5"]
    uncut = train.main(_CLI + small + ["--steps", "20"])
    d = str(tmp_path / "ck")
    jcfg = jconfigs.smoke_config("llama3-8b")
    cfg = _port_cfg(jcfg, remat="none")

    def kill(i, rec):
        if i == 9:
            raise chaos.InjectedKill("killed after step 10")

    with pytest.raises(chaos.InjectedKill):
        train.train(cfg, adamw.AdamWConfig(**OCFG), 20, 4, 32, device="cpu",
                    ckpt_dir=d, ckpt_every=5, on_step=kill)
    assert ckpt.latest_step(d) == 10
    res = train.main(_CLI + small + ["--steps", "10", "--ckpt-dir", d,
                                     "--resume"])
    assert res["start"] == 10 and res["step"] == list(range(10, 20))
    assert res["loss"] == uncut["loss"][10:]
    assert res["grad_norm"] == uncut["grad_norm"][10:]
    for a, b in zip(adamw.leaves(res["params"]),
                    adamw.leaves(uncut["params"])):
        assert torch.equal(a, b)


def test_train_cli_refuses_a_mesh(monkeypatch):
    """``--mesh`` outside torchrun, or larger than the group, is refused;
    under torchrun's variables (one rank) ``--mesh 1,1`` trains, bit for
    bit as without a mesh (4 ranks: ``test_torch_mesh_train.py``)."""
    small = ["--batch", "4", "--seq", "32", "--steps", "3"]
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        train.main(_CLI + ["--mesh", "4,2"])
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="world of 1"):
        train.main(_CLI + small + ["--mesh", "4,2"])
    assert not dist.initialized()
    got = train.main(_CLI + small + ["--mesh", "1,1"])
    assert not dist.initialized()
    want = train.main(_CLI + small)
    assert got["loss"] == want["loss"]
    assert got["grad_norm"] == want["grad_norm"]
