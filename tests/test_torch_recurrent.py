"""The port's recurrent families, xLSTM (``models/xlstm.py``) and Zamba2
(``models/zamba.py``), against the JAX reference on the same numpy inputs
and ``convert.lm_params`` weights: the chunk scans (SSD, mLSTM) and the
sLSTM scan on seeded inputs, their end states against the step
recurrence, forward and decode step by step, greedy serving against the
reference example's loop, the prefill-filled cache against the
decode-built one, the parameter and cache trees, and the ragged-length
refusal.

The mLSTM chunk form and step form keep (C, n) scaled by exp(-m) for
different stabilizers m, so their states are compared de-stabilized
(C·exp(m), n·exp(m))."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import xlstm as jX
from repro.models import zamba as jZ
from repro.models.api import build as jbuild

from repro_torch import convert
from repro_torch.launch import serve
from repro_torch.models import xlstm as X
from repro_torch.models import zamba as Z
from repro_torch.models.api import build

torch.set_num_threads(1)

ARCHS = ["xlstm-125m", "zamba2-1.2b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


# ------------------------------------------------------------ scan cores
def _ssd_inputs(seed, B=2, L=32, H=3, P=4, N=5):
    r = np.random.default_rng(seed)
    xdt = r.normal(size=(B, L, H, P)).astype(np.float32)
    Bm = r.normal(size=(B, L, N)).astype(np.float32)
    Cm = r.normal(size=(B, L, N)).astype(np.float32)
    la = -r.uniform(0.01, 1.0, size=(B, L, H)).astype(np.float32)
    return xdt, Bm, Cm, la


def _port_ssd(xdt, Bm, Cm, la, chunk):
    y, S = Z._ssd_chunk_scan(_t(xdt).transpose(1, 2), _t(Bm)[:, None],
                             _t(Cm)[:, None], _t(la).transpose(1, 2), chunk)
    return y.transpose(1, 2), S                     # (B, L, H, P), (B, H, N, P)


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunk_scan_matches_reference(chunk):
    """Batched over (batch, heads) with B / C shared by a row's heads, as
    the reference's two vmaps run it."""
    xdt, Bm, Cm, la = _ssd_inputs(0)
    core = jax.vmap(jax.vmap(
        functools.partial(jZ._ssd_chunk_scan, chunk=chunk),
        in_axes=(1, None, None, 1), out_axes=1))
    want = core(*(jnp.asarray(a) for a in (xdt, Bm, Cm, la)))
    got, _ = _port_ssd(xdt, Bm, Cm, la, chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_ssd_end_state_is_the_step_recurrence():
    """The scan's end state S equals the one-step recurrence S' = exp(la)
    S + B xᵀ over the sequence, and so does its last output C S."""
    xdt, Bm, Cm, la = _ssd_inputs(1)
    y, S = _port_ssd(xdt, Bm, Cm, la, 8)
    Sr = np.zeros(S.shape, np.float64)
    for t in range(xdt.shape[1]):
        Sr = np.exp(la[:, t])[:, :, None, None] * Sr + np.einsum(
            "bn,bhp->bhnp", Bm[:, t], xdt[:, t])
    np.testing.assert_allclose(S.numpy(), Sr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y[:, -1].numpy(),
                               np.einsum("bn,bhnp->bhp", Cm[:, -1], Sr),
                               rtol=1e-5, atol=1e-5)


def _mlstm_inputs(seed, B=2, H=3, L=32, dh=8):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(B, H, L, dh)).astype(np.float32)
               for _ in range(3))
    ig = r.normal(size=(B, H, L)).astype(np.float32)
    lf = np.log(1.0 / (1.0 + np.exp(-(r.normal(size=(B, H, L)) + 3.0))))
    return q, k, v, ig, lf.astype(np.float32)


@pytest.mark.parametrize("chunk", [8, 32])
def test_mlstm_chunk_scan_matches_reference(chunk):
    ins = _mlstm_inputs(2)
    core = jax.vmap(jax.vmap(functools.partial(jX._mlstm_chunk_scan,
                                               chunk=chunk)))
    want = core(*(jnp.asarray(a) for a in ins))
    got, _ = X._mlstm_chunk_scan(*(_t(a) for a in ins), chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_mlstm_end_state_is_the_step_recurrence():
    """The chunk scan's end (C, n, m) against the reference's one-step
    recurrence over the same sequence, de-stabilized (C·exp(m), n·exp(m));
    the port's step equals the reference's step."""
    q, k, v, ig, lf = _mlstm_inputs(3)
    _, (C, n, m) = X._mlstm_chunk_scan(*(_t(a) for a in (q, k, v, ig, lf)),
                                       8)
    B, H, L, dh = q.shape
    step = jax.vmap(jax.vmap(jX._mlstm_decode_step))
    jC = jnp.zeros((B, H, dh, dh))
    jn = jnp.zeros((B, H, dh))
    jm = jnp.zeros((B, H))
    pC, pn, pm = (torch.zeros(s) for s in ((B, H, dh, dh), (B, H, dh),
                                           (B, H)))
    for t in range(L):
        a = [x[:, :, t] for x in (q, k, v, ig, lf)]
        jC, jn, jm, jh = step(jC, jn, jm, *(jnp.asarray(x) for x in a))
        pC, pn, pm, ph = X._mlstm_decode_step(pC, pn, pm, *(_t(x) for x in a))
        np.testing.assert_allclose(ph.numpy(), _np(jh), rtol=1e-5, atol=1e-5)
    scale_c = np.exp(m.numpy().astype(np.float64))
    scale_s = np.exp(np.asarray(jm, np.float64))
    np.testing.assert_allclose(C.numpy() * scale_c[..., None, None],
                               np.asarray(jC) * scale_s[..., None, None],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(n.numpy() * scale_c[..., None],
                               np.asarray(jn) * scale_s[..., None],
                               rtol=1e-4, atol=1e-4)


def test_slstm_scan_matches_reference():
    r = np.random.default_rng(4)
    B, L, H, dh = 2, 12, 3, 4
    p = {"r": r.normal(size=(4, H, dh, dh)).astype(np.float32) * 0.5,
         "bias": r.normal(size=(4, H, dh)).astype(np.float32)}
    x = r.normal(size=(B, L, 4, H, dh)).astype(np.float32)
    state = tuple(r.normal(size=(B, H, dh)).astype(np.float32)
                  for _ in range(4))
    state = (state[0], np.abs(state[1]) + 0.5, state[2], state[3])
    jh, jst = jX._slstm_scan(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             tuple(jnp.asarray(s) for s in state))
    h, st = X._slstm_scan({k: _t(v) for k, v in p.items()}, _t(x),
                          tuple(_t(s) for s in state))
    np.testing.assert_allclose(h.numpy(), _np(jh), rtol=1e-5, atol=1e-5)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ models
@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    """(reference cfg, params, jitted forward / decode) and (port cfg,
    converted params) on the reference's init."""
    jcfg = jconfigs.smoke_config(arch)
    jm = jbuild(jcfg)
    jparams = jm.init(jcfg, jax.random.PRNGKey(seed))
    cfg = convert.model_config(dataclasses.asdict(jcfg))
    params = convert.lm_params(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jfwd = jax.jit(lambda p, b: jm.forward(p, jcfg, b))
    jdec = jax.jit(lambda p, c, b: jm.decode(p, jcfg, c, b))
    return jcfg, jm, jparams, jfwd, jdec, cfg, params


def _tokens(cfg, B, L, seed):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, L))
    return t.astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, _, jparams, jfwd, _, cfg, params = _pair(arch)
    t = _tokens(cfg, 2, 32, 0)
    want, _ = jfwd(jparams, {"tokens": jnp.asarray(t)})
    got, aux = build(cfg).forward(params, cfg, {"tokens": torch.tensor(t)})
    assert got.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


def _flat(cache) -> dict:
    """name -> array of a cache, ``s_state``'s tuple as s_state/0..3."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, tuple):
            out.update({f"{k}/{i}": a for i, a in enumerate(v)})
        elif k != "pos":
            out[k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_step_by_step(arch):
    jcfg, jm, jparams, _, jdec, cfg, params = _pair(arch)
    t = _tokens(cfg, 2, 10, 1)
    model = build(cfg)
    jcache = jm.init_cache(jcfg, 2, 10)
    cache = model.init_cache(cfg, 2, 10, device="cpu")
    for i in range(10):
        step = t[:, i: i + 1]
        want, jcache = jdec(jparams, jcache, {"tokens": jnp.asarray(step)})
        got, cache = model.decode(params, cfg, cache,
                                  {"tokens": torch.tensor(step)})
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {i}")
    assert cache["pos"] == 10
    want, got = _flat(jcache), _flat(cache)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_reference_loop(arch):
    """``serve.generate`` (prefill through the chunk scans, which fills the
    state cache, then decode) gives the tokens of the reference example's
    loop (the cache built by one-token decode, then greedy decode)."""
    jcfg, jm, jparams, _, jdec, cfg, params = _pair(arch)
    B, Lp, n = 4, 16, 16
    prompts = _tokens(cfg, B, Lp, 0)
    cache = jm.init_cache(jcfg, B, Lp + n)
    for t in range(Lp):
        lg, cache = jdec(jparams, cache,
                         {"tokens": jnp.asarray(prompts[:, t: t + 1])})
    out = [np.asarray(jnp.argmax(lg[:, -1], -1))]
    for _ in range(n - 1):
        lg, cache = jdec(jparams, cache, {"tokens": jnp.asarray(out[-1][:, None])})
        out.append(np.asarray(jnp.argmax(lg[:, -1], -1)))
    res = serve.generate(params, cfg, torch.tensor(prompts), n)
    np.testing.assert_array_equal(res["tokens"].numpy(), np.stack(out, 1))
    assert res["cache"]["pos"] == Lp + n - 1


def _destabilized(cache) -> dict:
    """The cache with each mLSTM (C, n) scaled by exp(m), m left out."""
    out = _flat(cache)
    for pre in ("m_", "t_"):
        if pre + "m" in out:
            e = torch.exp(out.pop(pre + "m"))
            out[pre + "C"] = out[pre + "C"] * e[..., None, None]
            out[pre + "n"] = out[pre + "n"] * e[..., None]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_matches_decode_built(arch):
    """``forward(cache=)`` over a 32-token prompt (two chunks) fills the
    state one-token decode builds (mLSTM states de-stabilized; conv
    states exactly the last K - 1 inputs), and both continue alike."""
    _, _, _, _, _, cfg, params = _pair(arch)
    model = build(cfg)
    t = torch.tensor(_tokens(cfg, 2, 36, 2))
    pre = model.init_cache(cfg, 2, 36, device="cpu")
    logits, _ = model.forward(params, cfg, {"tokens": t[:, :32]}, cache=pre)
    assert pre["pos"] == 32
    built = model.init_cache(cfg, 2, 36, device="cpu")
    for i in range(32):
        last, built = model.decode(params, cfg, built,
                                   {"tokens": t[:, i: i + 1]})
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=1e-4,
                               atol=1e-4)
    a, b = _destabilized(pre), _destabilized(built)
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{k}: {m}")
    for i in range(32, 36):
        step = {"tokens": t[:, i: i + 1]}
        la, pre = model.decode(params, cfg, pre, step)
        lb, built = model.decode(params, cfg, built, step)
        torch.testing.assert_close(la, lb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_length_raises(arch):
    """A length that is not a multiple of the chunk is refused, naming the
    chunk (the reference's reshape fails there; padding would change the
    function)."""
    cfg = convert.model_config(dataclasses.asdict(jconfigs.smoke_config(
        arch)))
    model = build(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=f"chunk {cfg.chunk}"):
        model.forward(params, cfg, {"tokens": torch.zeros(1, cfg.chunk + 4,
                                                          dtype=torch.int32)})
    logits, _ = model.forward(params, cfg, {"tokens": torch.zeros(
        1, cfg.chunk // 2, dtype=torch.int32)})        # L < chunk: one chunk
    assert logits.shape == (1, cfg.chunk // 2, cfg.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_cache_trees_match_reference(arch):
    """The port's own init (bf16 config) has the reference's parameter
    tree (keys, shapes, types: the gate and SSM leaves fp32), and its
    cache the reference's entries."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), dtype="bfloat16")
    cfg = convert.model_config(dataclasses.asdict(jcfg))
    model = build(cfg)
    want = jax.eval_shape(lambda: jbuild(jcfg).init(jcfg,
                                                    jax.random.PRNGKey(0)))
    flat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    got = model.init(cfg, torch.Generator().manual_seed(0))
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
    jc = jbuild(jcfg).init_cache(jcfg, 2, 8)
    c = model.init_cache(cfg, 2, 8, device="cpu")
    assert c["pos"] == 0
    want, got = _flat(jc), _flat(c)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype)[6:] == str(want[k].dtype), k
