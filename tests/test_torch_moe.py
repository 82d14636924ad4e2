"""The port's mixture-of-experts transformer against the JAX reference on
the same numpy inputs and ``convert.lm_params`` weights: the router
(``_route``'s experts, gates, in-expert positions, kept pairs and aux
term), the MoE FFN, forward logits and aux, decode step by step and greedy
serving, for the ``phi3.5-moe`` (top-2) and ``llama4-scout`` (top-1) smoke
configs in both dispatch modes ('scatter', 'einsum') and under heavy
capacity drops (capacity factor 0.25).

Capacity drops count positions in sequence order, so a prefill drops the
last tokens of a prompt first, while one-token decode (cap 1, one token)
never drops: decode-built caches equal prefill-filled ones only when no
pair is dropped (capacity factor E / k gives cap = L), as in the
reference (``tests/test_models.py`` compares the first 8 of 16 positions).
``serve.generate`` prefills in one forward pass, so its tokens are held
against the reference run the same way (the reference's forward, the
cache filled from that forward's own layer inputs, then the reference's
decode), and against the reference example's one-token loop where no
pair is dropped."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import transformer as jT
from repro.models.api import build as jbuild

from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.api import build

torch.set_num_threads(1)

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
MODES = {"scatter": {}, "einsum": {"moe_impl": "einsum"},
         "drop": {"capacity_factor": 0.25}}
CASES = [(a, m) for a in ARCHS for m in MODES]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


class _Pair:
    """The reference's and the port's config and weights (the reference's
    init, converted), with the reference's forward and decode jitted
    once."""

    def __init__(self, arch, over, seed=0):
        self.jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
        self.jmodel = jbuild(self.jcfg)
        self.jparams = self.jmodel.init(self.jcfg, jax.random.PRNGKey(seed))
        self.cfg = convert.model_config(dataclasses.asdict(self.jcfg))
        self.params = convert.lm_params(
            jax.tree.map(np.asarray, self.jparams), device="cpu")
        jcfg, jm = self.jcfg, self.jmodel
        self.jfwd = jax.jit(lambda p, b: jm.forward(p, jcfg, b))
        self.jdec = jax.jit(lambda p, c, b: jm.decode(p, jcfg, c, b))


@pytest.fixture(scope="module")
def pair():
    made = {}

    def get(arch, mode, **over):
        key = (arch, mode, tuple(sorted(over.items())))
        if key not in made:
            made[key] = _Pair(arch, {**MODES[mode], **over})
        return made[key]

    return get


def _tokens(cfg, B, L, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, L))
    return t.astype(np.int32)


def _layer0(params) -> dict:
    return {k: v[0] for k, v in params["layers"].items()}


# ----------------------------------------------------------------- router
@pytest.mark.parametrize("arch,mode", CASES)
def test_route_matches_reference(pair, arch, mode):
    m = pair(arch, mode)
    x = np.random.default_rng(3).normal(
        size=(2, 24, m.cfg.d_model)).astype(np.float32)
    jgi, jgv, jpos, jkeep, _, jcap, jaux = jT._route(
        jnp.asarray(x), jax.tree.map(lambda a: a[0], m.jparams["layers"]),
        m.jcfg)
    gi, gv, pos, keep, onehot, cap, aux = T._route(
        torch.tensor(x), _layer0(m.params), m.cfg)
    assert cap == jcap
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=0)
    assert onehot.shape == (2, 24, m.cfg.top_k, m.cfg.n_experts)
    if mode == "drop":            # the drop-heavy copy does drop pairs
        assert 0 < int(keep.sum()) < keep.numel()


@pytest.mark.parametrize("arch,mode", CASES)
def test_moe_ffn_matches_reference(pair, arch, mode):
    m = pair(arch, mode)
    x = np.random.default_rng(4).normal(
        size=(2, 24, m.cfg.d_model)).astype(np.float32)
    want, jaux = jT._moe_ffn(
        jnp.asarray(x), jax.tree.map(lambda a: a[0], m.jparams["layers"]),
        m.jcfg)
    got, aux = T._moe_ffn(torch.tensor(x), _layer0(m.params), m.cfg)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ model
# one batch and cache shape for every call of a pair's jitted functions
B, LP, NEW = 4, 16, 8


@pytest.mark.parametrize("arch,mode", CASES)
def test_forward_matches_reference(pair, arch, mode):
    m = pair(arch, mode)
    t = _tokens(m.cfg, B, LP, 2)
    want, jaux = m.jfwd(m.jparams, {"tokens": jnp.asarray(t)})
    got, aux = build(m.cfg).forward(m.params, m.cfg,
                                    {"tokens": torch.tensor(t)})
    assert got.shape == (B, LP, m.cfg.vocab_size)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,mode", CASES)
def test_decode_matches_reference_step_by_step(pair, arch, mode):
    m = pair(arch, mode)
    t = _tokens(m.cfg, B, 8, 1)
    model = build(m.cfg)
    jcache = m.jmodel.init_cache(m.jcfg, B, LP + NEW)
    cache = model.init_cache(m.cfg, B, LP + NEW, device="cpu")
    for i in range(8):
        step = t[:, i: i + 1]
        want, jcache = m.jdec(m.jparams, jcache, {"tokens": jnp.asarray(step)})
        got, cache = model.decode(m.params, m.cfg, cache,
                                  {"tokens": torch.tensor(step)})
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
    assert cache["pos"] == 8
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]),
                                   rtol=1e-4, atol=1e-4)


def _reference_generate(m, prompts, n):
    """The reference run the way ``serve.generate`` runs: its forward over
    the prompts gives the first token, the cache holds the K / V of that
    forward's own layer inputs (reference functions, layer by layer), then
    the reference's decode goes on from position Lp."""
    jcfg, jp = m.jcfg, m.jparams
    B, Lp = prompts.shape
    h = jnp.take(jp["embed"], jnp.asarray(prompts), axis=0)
    positions = jnp.arange(Lp, dtype=jnp.int32)[None]
    ks, vs = [], []
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], jp["layers"])
        x = jcommon.rms_norm(h, lp["ln1"])
        ks.append(jcommon.apply_rope(jnp.einsum("bld,dhk->blhk", x,
                                                lp["wk"]),
                                     positions, jcfg.rope_theta))
        vs.append(jnp.einsum("bld,dhk->blhk", x, lp["wv"]))
        h, _ = jT._layer(jcfg, lp, h, positions)
    logits = jnp.einsum("bld,dv->blv", jcommon.rms_norm(h, jp["ln_f"]),
                        jp["unembed"])
    want, _ = m.jfwd(jp, {"tokens": jnp.asarray(prompts)})
    np.testing.assert_allclose(_np(logits), _np(want), rtol=1e-5, atol=1e-5)
    cache = m.jmodel.init_cache(jcfg, B, Lp + n)
    cache = {"k": cache["k"].at[:, :, :Lp].set(jnp.stack(ks)),
             "v": cache["v"].at[:, :, :Lp].set(jnp.stack(vs)),
             "pos": jnp.asarray(Lp, jnp.int32)}
    out = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    for _ in range(n - 1):
        lg, cache = m.jdec(jp, cache, {"tokens": jnp.asarray(out[-1][:, None])})
        out.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
    return np.stack(out, 1)


def _reference_loop(m, prompts, n):
    """The reference example's loop (``examples/serve_lm.py``): the cache
    built by one-token decode over the prompt, then greedy decode."""
    B, Lp = prompts.shape
    cache = m.jmodel.init_cache(m.jcfg, B, Lp + n)
    for t in range(Lp):
        lg, cache = m.jdec(m.jparams, cache,
                           {"tokens": jnp.asarray(prompts[:, t: t + 1])})
    out = [np.asarray(jnp.argmax(lg[:, -1], -1))]
    for _ in range(n - 1):
        lg, cache = m.jdec(m.jparams, cache,
                           {"tokens": jnp.asarray(out[-1][:, None])})
        out.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
    return np.stack(out, 1)


@pytest.mark.parametrize("arch,mode", CASES)
def test_greedy_serving_matches_reference(pair, arch, mode):
    """``serve.generate`` gives the reference's tokens when the reference
    prefills as it does (one forward, drops included)."""
    m = pair(arch, mode)
    prompts = _tokens(m.cfg, B, LP, 0)
    res = serve.generate(m.params, m.cfg, torch.tensor(prompts), NEW)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  _reference_generate(m, prompts, NEW))
    assert res["cache"]["pos"] == LP + NEW - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_without_drops_matches_reference_loop(pair, arch):
    """With capacity factor E / k (cap = L: no pair dropped), the prefill
    fills the cache the one-token loop builds, so ``serve.generate`` gives
    the reference example's tokens."""
    cfg = jconfigs.smoke_config(arch)
    m = pair(arch, "scatter", capacity_factor=cfg.n_experts / cfg.top_k)
    prompts = _tokens(m.cfg, B, LP, 0)
    res = serve.generate(m.params, m.cfg, torch.tensor(prompts), NEW)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  _reference_loop(m, prompts, NEW))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_without_drops(arch):
    """The port's decode against its own forward at capacity factor E / k:
    the prefill-filled cache equals the decode-built one, and the
    one-token logits the prefill's (the bound of ``tests/test_models.py``,
    over all 16 positions)."""
    base = jconfigs.smoke_config(arch)
    cfg = convert.model_config(dataclasses.asdict(dataclasses.replace(
        base, capacity_factor=base.n_experts / base.top_k)))
    model = build(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(1))
    t = torch.tensor(_tokens(cfg, 2, 16, 1))
    full = model.init_cache(cfg, 2, 16, device="cpu")
    logits, _ = model.forward(params, cfg, {"tokens": t}, cache=full)
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    errs = []
    for i in range(16):
        lg, cache = model.decode(params, cfg, cache,
                                 {"tokens": t[:, i: i + 1]})
        errs.append(float((lg[:, 0] - logits[:, i]).abs().max()))
    assert max(errs) < 5e-3, errs
    torch.testing.assert_close(cache["k"], full["k"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache["v"], full["v"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(arch):
    """The port's own init (bf16 config) has the reference's tree: the
    same keys, shapes and types (the router fp32)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype="bfloat16")
    cfg = convert.model_config(dataclasses.asdict(jcfg))
    want = jax.eval_shape(lambda: jbuild(jcfg).init(jcfg,
                                                     jax.random.PRNGKey(0)))
    got = build(cfg).init(cfg, torch.Generator().manual_seed(0))
    flat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    mine = {}
    for a, sub in got.items():
        if isinstance(sub, dict):
            mine.update({f"{a}/{b}": t for b, t in sub.items()})
        else:
            mine[a] = sub
    assert set(mine) == set(flat)
    for k, leaf in flat.items():
        assert tuple(mine[k].shape) == leaf.shape, k
        assert str(mine[k].dtype)[6:] == str(leaf.dtype), k
    assert mine["layers/router"].dtype == torch.float32
