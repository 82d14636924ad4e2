"""The port's LM serving path against the JAX reference on the same numpy
inputs: the flash kernel's plain version against the Pallas body in
interpret mode, ``mha`` and the model building blocks, forward logits with
and without the flash path, decode step by step, greedy serving, every
family through the serving CLI, and the weights each family's tree
carries across. The MoE and recurrent families are held against the
reference in ``test_torch_moe.py`` and ``test_torch_recurrent.py``; the
CUDA kernel itself in ``test_torch_cuda.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import common as jcommon
from repro.models.api import build as jbuild

from repro_torch import configs, convert
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, train_lib
from repro_torch.models import common
from repro_torch.models.api import build

torch.set_num_threads(1)

LM_ARCHS = ["llama3-8b", "qwen1.5-32b", "pixtral-12b"]  # GQA / QKV bias / embeds


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """numpy fp32 -> torch ``dtype`` (bf16 rounds as jnp's astype does)."""
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ----------------------------------------------------------- flash / mha
@pytest.mark.parametrize("b,h,hkv,l,dh,causal,dtype",
                         [(1, 4, 4, 128, 32, True, "float32"),
                          (2, 4, 2, 256, 64, True, "float32"),
                          (1, 8, 1, 256, 64, True, "float32"),
                          (2, 4, 2, 128, 64, True, "bfloat16"),
                          (1, 2, 2, 128, 32, False, "float32")])
def test_flash_plain_matches_pallas_interpret(b, h, hkv, l, dh, causal,
                                              dtype):
    r = np.random.default_rng(b * l + h)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((b, h, l, dh), (b, hkv, l, dh), (b, hkv, l, dh)))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" \
        else (jnp.float32, torch.float32)
    want = j_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                   causal=causal, block_q=64, block_k=64, interpret=True)
    got = ref.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal)
    assert got.dtype == tdt and got.shape == (b, h, l, dh)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    # the CPU wrapper is the plain version
    assert torch.equal(ops.flash_attention(_t(q, tdt), _t(k, tdt),
                                           _t(v, tdt), causal), got)


def test_flash_wrapper_refuses_causal_with_ragged_lengths():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 12, 16)
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.flash_attention(q, k, k, causal=True)
    assert ops.flash_attention(q, k, k, causal=False).shape == q.shape


def _p_carried_attention(q, k, v, split: bool) -> torch.Tensor:
    """Causal GQA attention in fp32 from bf16 q, k, v (B, H, L, Dh), with P
    carried into the second product as a bf16 kernel must: rounded to bf16
    once (as the reference's blockwise attention does), or as hi + lo bf16
    parts (as ``csrc/flash_attention.cu`` does); l adds the fp32 P."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, 1)
    vf = v.float().repeat_interleave(g, 1)
    s = q.float() @ kf.transpose(-1, -2) * q.shape[-1] ** -0.5
    L = s.shape[-1]
    s = s.masked_fill(~torch.ones(L, L, dtype=torch.bool).tril(),
                      float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    pv = hi @ vf
    if split:
        pv = pv + (p - hi).to(torch.bfloat16).float() @ vf
    return (pv / p.sum(-1, keepdim=True)).to(torch.bfloat16)


def test_bf16_flash_needs_p_in_two_parts_to_keep_its_gate():
    """Why the bf16 flash kernel splits P: on short causal rows, P rounded
    to bf16 once moves outputs near 0 past the kernel's bf16 gate against
    ``ref.flash_attention`` (rtol 2e-2, atol 2e-3); hi + lo bf16 parts stay
    inside it. At llama3-8b's head layout (32 query heads on 8 kv heads,
    Dh 128) and L = 129, a few of the 528K outputs miss."""
    r = np.random.default_rng(0)
    mk = lambda *s: _t(r.normal(size=s), torch.bfloat16)
    q, k, v = mk(4, 32, 129, 128), mk(4, 8, 129, 128), mk(4, 8, 129, 128)
    want = ref.flash_attention(q, k, v, True).float()

    def excess(split):
        got = _p_carried_attention(q, k, v, split).float()
        return float(((got - want).abs() - 2e-3 - 2e-2 * want.abs()).max())

    assert excess(split=False) > 0
    assert excess(split=True) < 0


@pytest.mark.parametrize("lq,lk,h,hkv,causal",
                         [(32, 32, 4, 2, True), (8, 40, 4, 1, True),
                          (1, 17, 6, 3, True), (16, 24, 4, 4, False)])
def test_mha_matches_reference(lq, lk, h, hkv, causal):
    r = np.random.default_rng(lq * lk)
    q = r.normal(size=(2, lq, h, 16)).astype(np.float32)
    k = r.normal(size=(2, lk, hkv, 16)).astype(np.float32)
    v = r.normal(size=(2, lk, hkv, 16)).astype(np.float32)
    want = jref.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal)
    got = ref.mha(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------- building blocks
def test_rms_norm_and_swiglu_match_reference():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 8, 32)).astype(np.float32)
    w = r.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(common.rms_norm(_t(x), _t(w))),
        _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    wg, wu = (r.normal(size=(32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = r.normal(size=(48, 32)).astype(np.float32) * 0.2
    np.testing.assert_allclose(
        _np(common.swiglu(_t(x), _t(wg), _t(wu), _t(wd))),
        _np(jcommon.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_apply_rope_matches_reference(batched_positions):
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    if batched_positions:
        pos = np.stack([pos, pos + 5])
    np.testing.assert_allclose(
        _np(common.apply_rope(_t(x), torch.tensor(pos), 5e5)),
        _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5)),
        rtol=1e-6, atol=1e-6)


def test_blockwise_attention_matches_reference():
    r = np.random.default_rng(2)
    q = r.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = r.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = r.normal(size=(2, 64, 2, 16)).astype(np.float32)
    want = jcommon.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), block_q=16)
    got = common.blockwise_attention(_t(q), _t(k), _t(v), block_q=16)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    # and it is the plain mha (exact, not an approximation)
    np.testing.assert_allclose(_np(got), _np(ref.mha(_t(q), _t(k), _t(v))),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ models
def _models(arch, seed, **over):
    """(reference cfg, params) and (port cfg, converted params) on the
    same weights (the reference's init)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **over)
    jparams = jbuild(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    cfg = convert.model_config(dataclasses.asdict(jcfg))
    params = convert.lm_params(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jcfg, jparams, cfg, params


def _batch(cfg, B, L, seed):
    r = np.random.default_rng(seed)
    if cfg.frontend == "embeds":
        e = r.normal(size=(B, L, cfg.d_model)).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": _t(e)}
    t = r.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return {"tokens": jnp.asarray(t)}, {"tokens": torch.tensor(t)}


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch, use_flash):
    jcfg, jparams, cfg, params = _models(arch, 0, use_flash=use_flash)
    jb, tb = _batch(cfg, 2, 32, 0)
    want, _ = jax.jit(lambda p, b: jbuild(jcfg).forward(p, jcfg, b))(
        jparams, jb)
    got, aux = build(cfg).forward(params, cfg, tb)
    assert got.shape == (2, 32, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_reference_step_by_step(arch):
    jcfg, jparams, cfg, params = _models(arch, 1)
    jb, tb = _batch(cfg, 2, 8, 1)
    jmodel, model = jbuild(jcfg), build(cfg)
    jcache = jmodel.init_cache(jcfg, 2, 8)
    cache = model.init_cache(cfg, 2, 8, device="cpu")
    jdec = jax.jit(lambda p, c, b: jmodel.decode(p, jcfg, c, b))
    key = "embeds" if cfg.frontend == "embeds" else "tokens"
    for t in range(8):
        want, jcache = jdec(jparams, jcache, {key: jb[key][:, t: t + 1]})
        got, cache = model.decode(params, cfg, cache,
                                  {key: tb[key][:, t: t + 1]})
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")
    assert cache["pos"] == 8
    np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS + ["musicgen-large", "yi-34b"])
def test_decode_matches_forward(arch):
    """The port's decode against its own forward (the bound of
    ``tests/test_models.py``); the prefill-filled cache equals the
    decode-built one."""
    cfg = configs.smoke_config(arch)
    model = build(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(1))
    _, tb = _batch(cfg, 2, 16, 1)
    key = "embeds" if cfg.frontend == "embeds" else "tokens"
    full = model.init_cache(cfg, 2, 16, device="cpu")
    logits, _ = model.forward(params, cfg, tb, cache=full)
    assert full["pos"] == 16
    cache = model.init_cache(cfg, 2, 16, device="cpu")
    errs = []
    for t in range(16):
        lg, cache = model.decode(params, cfg, cache,
                                 {key: tb[key][:, t: t + 1]})
        errs.append(float((lg[:, 0] - logits[:, t]).abs().max()))
    assert max(errs) < 5e-3, errs
    torch.testing.assert_close(cache["k"], full["k"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cache["v"], full["v"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["llama3-8b", "pixtral-12b"])
def test_greedy_serving_matches_reference_loop(arch):
    """``serve.generate`` (prefill through one forward, then decode) gives
    the tokens of the reference example's loop (``examples/serve_lm.py``:
    the cache built by one-token decode over the prompt, then greedy
    decode) on the same weights, prompts and embedding table."""
    B, Lp, n = 4, 16, 32
    jcfg, jparams, cfg, params = _models(arch, 0)
    jmodel = jbuild(jcfg)
    rng = np.random.default_rng(0)
    emb = None
    if cfg.frontend == "embeds":
        emb = rng.normal(scale=0.02,
                         size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
        tok2in = lambda t: {"embeds": jnp.asarray(emb[np.asarray(t)])}
    else:
        tok2in = lambda t: {"tokens": jnp.asarray(t)}
    prompts = rng.integers(0, cfg.vocab_size, (B, Lp)).astype(np.int32)
    cache = jmodel.init_cache(jcfg, B, Lp + n)
    dec = jax.jit(lambda p, c, b: jmodel.decode(p, jcfg, c, b))
    for t in range(Lp):
        logits, cache = dec(jparams, cache, tok2in(prompts[:, t: t + 1]))
    out = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    for _ in range(n - 1):
        logits, cache = dec(jparams, cache, tok2in(out[-1][:, None]))
        out.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
    want = np.stack(out, 1)

    res = serve.generate(params, cfg, torch.tensor(prompts), n,
                         None if emb is None else torch.tensor(emb))
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert res["cache"]["pos"] == Lp + n - 1


def test_prefill_step_is_the_greedy_last_token():
    cfg = configs.smoke_config("llama3-8b")
    model = build(cfg)
    params = model.init(cfg, torch.Generator().manual_seed(2))
    _, tb = _batch(cfg, 3, 12, 2)
    logits, _ = model.forward(params, cfg, tb)
    nxt = train_lib.make_prefill_step(cfg)(params, tb)
    assert torch.equal(nxt, logits[:, -1].argmax(-1))
    cache = model.init_cache(cfg, 3, 13, device="cpu")
    train_lib.make_prefill_step(cfg)(params, tb, cache)
    step, cache = train_lib.make_serve_step(cfg)(params, cache,
                                                 {"tokens": nxt[:, None]})
    assert step.shape == (3,) and cache["pos"] == 13


# ----------------------------------------------------------- config / CLI
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    for which in ("full_config", "smoke_config"):
        want = getattr(jconfigs, which)(arch)
        got = getattr(configs, which)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.hd, got.is_moe, got.active_params(),
                got.total_params()) == (want.hd, want.is_moe,
                                        want.active_params(),
                                        want.total_params())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_family_builds_and_serves(arch, capsys):
    """Every arch the reference builds has a family module here, and the
    serving CLI serves its smoke config on the CPU."""
    cfg = configs.smoke_config(arch)
    model = build(cfg)
    assert model is build(cfg) and hasattr(model, "init_cache")
    res = serve.main(["--arch", arch, "--device", "cpu", "--tokens", "2"])
    assert res["tokens"].shape == (4, 2)
    assert 0 <= int(res["tokens"].min()) and int(
        res["tokens"].max()) < cfg.vocab_size
    assert f"{arch}: generated (4, 2) on cpu" in capsys.readouterr().out


# one tree per family: leaves that stay fp32 in a bf16 config
_MIXED = {"qwen1.5-32b": (), "phi3.5-moe-42b-a6.6b": ("layers/router",),
          "xlstm-125m": ("m_groups/w_gates", "m_groups/b_gates",
                         "s_groups/wx", "s_groups/r", "s_groups/bias"),
          "zamba2-1.2b": ("groups/a_log", "groups/dt_bias", "tail/a_log",
                          "tail/dt_bias")}


def test_lm_params_keep_bf16_values():
    """``lm_params`` carries each family's tree in a bf16 config: the same
    keys, bf16 leaves bit for bit, and the reference's fp32 leaves (MoE
    router, xLSTM gates, Zamba2's SSM decay) fp32."""
    for arch, fp32 in _MIXED.items():
        jcfg, jparams, cfg, params = _models(arch, 3, dtype="bfloat16")
        want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in
                jax.tree_util.tree_flatten_with_path(jparams)[0]}
        got = {}
        for a, sub in params.items():
            if isinstance(sub, dict):
                got.update({f"{a}/{b}": t for b, t in sub.items()})
            else:
                got[a] = sub
        assert set(got) == set(want), arch
        for k, a in want.items():
            if k in fp32:
                assert a.dtype == np.float32 and got[k].dtype == \
                    torch.float32, (arch, k)
            else:
                assert a.dtype.name == "bfloat16" and got[k].dtype == \
                    torch.bfloat16, (arch, k)
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          a.astype(np.float32),
                                          err_msg=f"{arch} {k}")
        assert params["unembed"].dtype == torch.bfloat16


def test_serve_cli_prefill_goes_through_the_kernel_wrapper(monkeypatch):
    """Every prefill attention of the serving CLI, with the arch's config
    as it is (``use_flash`` unset), goes through ``ops.flash_attention``,
    which launches the kernel on CUDA tensors (``test_torch_cuda.py``
    counts those launches); only one-row decode attention does not."""
    calls = []
    wrapper = ops.flash_attention

    def spy(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return wrapper(q, k, v, causal)

    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = configs.smoke_config("llama3-8b")
    assert not cfg.use_flash
    serve.main(["--arch", "llama3-8b", "--device", "cpu", "--tokens", "3",
                "--batch", "2", "--prompt-len", "8"])
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    assert calls == [((2, H, 8, hd), (2, Hkv, 8, hd), True)] * cfg.n_layers


def test_model_config_drops_use_flash():
    jcfg = dataclasses.replace(jconfigs.smoke_config("llama3-8b"),
                               use_flash=True)
    cfg = convert.model_config(dataclasses.asdict(jcfg))
    assert not cfg.use_flash
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(jcfg, use_flash=False))


def test_serve_cli_on_cpu(capsys):
    res = serve.main(["--arch", "llama3-8b", "--device", "cpu",
                      "--tokens", "4", "--batch", "2"])
    assert res["tokens"].shape == (2, 4)
    assert "llama3-8b: generated (2, 4) on cpu" in capsys.readouterr().out
    # --svm goes to the SVM serving CLI (launch.svm_serve)
    rep = serve.main(["--svm", "--dataset", "a9a", "--scale", "0.01",
                      "--device", "cpu", "--repeats", "2", "--batch", "64"])
    assert rep["engine"]["fmt"] == "dense" and rep["p50_s"] > 0
    assert "batch=64: p50=" in capsys.readouterr().out
