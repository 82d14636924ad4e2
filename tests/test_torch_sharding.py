"""The port's shapes, meshes and sharding rules (``configs.shapes``,
``launch.mesh``, ``launch.sharding``, ``optim.compress``) against the JAX
reference, without process groups except where named:

* for every arch at its FULL config: the meta parameter shapes against the
  reference's ``eval_shape(init)``, and the parameter specs (``tp`` and
  ``fsdp``), the cache specs (decode_32k, long_500k), the batch specs,
  ``strip_fsdp`` and ``logits_spec`` against the reference's, on 16x16
  and 2x16x16 axis views;
* every rank's block of every leaf (params, cache, batch) against the
  reference's ``NamedSharding.devices_indices_map`` at the same mesh
  coordinate on a 2x2x2 ('pod', 'data', 'model') host mesh (one reference
  subprocess with 8 host devices);
* the shape set, its skip rule and the input stand-ins, the rule
  fallbacks of ``tests/test_substrate.py``;
* the int8 / bf16 codecs on the same numpy input, and ``psum_compressed``
  on a gloo group of 2 CPU ranks.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.models.api import build as jbuild
from repro.optim import compress as jcompress

from repro_torch import configs
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.launch import train_lib
from repro_torch.models import common
from repro_torch.models.api import build
from repro_torch.optim import compress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake(shape, names):
    """The reference's fake mesh view (``tests/test_substrate.py``)."""
    class M:
        axis_names = names

        class devices:
            pass
    M.devices.shape = shape
    return M


def _norm(spec) -> tuple:
    """A spec's entries with 1-tuples as their one name (a
    ``PartitionSpec`` stores ('data',) as 'data')."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict / tuple (either package's)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)) and not isinstance(
            tree, (shd.Spec, jax.sharding.PartitionSpec)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


def _specs_equal(mine, theirs):
    a, b = _flat(mine), _flat(theirs)
    assert a.keys() == b.keys()
    bad = {k: (_norm(a[k]), _norm(b[k])) for k in a
           if _norm(a[k]) != _norm(b[k])}
    assert not bad, bad


def _shapes_equal(mine, theirs):
    a, b = _flat(mine), _flat(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        assert str(a[k].dtype).replace("torch.", "") == str(b[k].dtype), k


def _jshapes(arch):
    cfg = jconfigs.full_config(arch)
    return jax.eval_shape(lambda k: jbuild(cfg).init(cfg, k),
                          jax.random.PRNGKey(0))


# ------------------------------------------------------------ param specs
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_shapes_and_specs_match_reference(arch):
    cfg = configs.full_config(arch)
    mine = build(cfg).init(cfg, common.MetaDraw())
    theirs = _jshapes(arch)
    _shapes_equal(mine, theirs)
    for shape, names in MESHES.values():
        for layout in ("tp", "fsdp"):
            ps = shd.param_specs(mine, meshlib.axes(shape, names), layout)
            _specs_equal(ps, jshd.param_specs(theirs, _fake(shape, names),
                                              layout))
            _specs_equal(shd.strip_fsdp(ps), jshd.strip_fsdp(
                jshd.param_specs(theirs, _fake(shape, names), layout)))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_and_batch_specs_match_reference(arch):
    cfg, jcfg = configs.full_config(arch), jconfigs.full_config(arch)
    for sname in ("decode_32k", "long_500k"):
        shape = configs.SHAPES[sname]
        if not configs.applicable(cfg, shape)[0]:
            continue
        theirs = jax.eval_shape(lambda: jbuild(jcfg).init_cache(
            jcfg, shape.global_batch, shape.seq_len))
        for mshape, names in MESHES.values():
            specs, shapes = train_lib.serve_shardings(
                cfg, meshlib.axes(mshape, names), shape.global_batch,
                shape.seq_len)
            _shapes_equal(shapes, theirs)
            _specs_equal(specs, jshd.cache_specs(theirs,
                                                 _fake(mshape, names)))
    for sname, shape in configs.SHAPES.items():
        mine = configs.input_specs(cfg, shape)
        theirs = jconfigs.input_specs(jcfg, jconfigs.SHAPES[sname])
        _shapes_equal(mine, theirs)
        assert all(t.device.type == "meta" for t in mine.values())
        for mshape, names in MESHES.values():
            for layout in ("tp", "fsdp"):
                _specs_equal(
                    shd.batch_specs(mine, meshlib.axes(mshape, names),
                                    layout),
                    jshd.batch_specs(theirs, _fake(mshape, names), layout))


def test_shape_set_skip_rule_and_logits_spec_match_reference():
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in configs.SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (s.kind, s.seq_len, s.global_batch) == (j.kind, j.seq_len,
                                                       j.global_batch)
        for arch in configs.ARCH_IDS:
            assert configs.applicable(configs.full_config(arch), s) == \
                jconfigs.applicable(jconfigs.full_config(arch), j)
    for shape, names in MESHES.values():
        assert _norm(shd.logits_spec(meshlib.axes(shape, names))) == \
            _norm(jshd.logits_spec(_fake(shape, names)))


def test_param_rules_divisibility_fallbacks():
    """The reference's ``test_param_rules_divisibility_fallbacks`` and
    ``test_batch_specs_nondivisible_replicates`` on the port."""
    m16 = meshlib.axes((16, 16), ("data", "model"))
    # yi-34b: 56 heads don't divide 16; hd=128 does
    assert shd._spec_for("layers.wq", (60, 7168, 56, 128), m16,
                         shd._PARAM_RULES, ("data",)) == \
        shd.Spec(None, "data", None, "model")
    assert shd._spec_for("layers.wq", (32, 4096, 32, 128), m16,
                         shd._PARAM_RULES, ("data",)) == \
        shd.Spec(None, "data", "model", None)
    assert shd._spec_for("layers.we_gate", (32, 16, 4096, 6400), m16,
                         shd._PARAM_RULES, ("data",)) == \
        shd.Spec(None, "model", "data", None)
    one = meshlib.axes((1,), ("data",))
    specs = shd.batch_specs({"tokens": torch.empty(1, 8, device="meta")},
                            one)
    assert specs["tokens"] == shd.Spec(("data",), None)
    m8 = meshlib.axes((8,), ("data",))
    assert shd.batch_specs({"t": torch.empty(4, 8, device="meta")},
                           m8)["t"] == shd.Spec(None, None)


@pytest.mark.parametrize("arch,want", [
    ("llama3-8b", dict(wq="heads", wk="head_dim", wv="head_dim", wo="heads",
                       w_gate="ffn", w_up="ffn", w_down="ffn",
                       embed="vocab", unembed="vocab")),
    ("yi-34b", dict(wq="head_dim", wk="head_dim", wv="head_dim",
                    wo="head_dim", w_gate="ffn", w_up="ffn", w_down="ffn",
                    embed="vocab", unembed="vocab")),
    ("phi3.5-moe-42b-a6.6b", dict(wq="heads", wk="head_dim", wv="head_dim",
                                  wo="heads", we_gate="experts",
                                  we_up="experts", we_down="experts",
                                  embed="vocab", unembed="vocab")),
    ("musicgen-large", dict(wq="heads", wk="heads", wv="heads", wo="heads",
                            w_gate="ffn", w_up="ffn", w_down="ffn",
                            unembed="vocab"))])
def test_model_roles_on_16x16(arch, want):
    """The role of the dim that 'model' splits, on the reference's tp
    specs at full width: the heads where 16 divides them (llama3-8b's 32,
    not its 8 kv heads), head_dim otherwise (yi-34b's 56 / 8); the norms
    and the router have none (replicated), and every split leaf is one the
    sharded step takes its 'model' block of."""
    cfg = configs.full_config(arch)
    tree = build(cfg).init(cfg, common.MetaDraw())
    mesh = meshlib.axes(*MESHES["16x16"])
    specs = shd.leaves(shd.param_specs(tree, mesh, "tp"))
    got = {}
    for path, spec in zip(shd.leaf_paths(tree), specs):
        r = shd.model_role(path, spec)
        if r is not None:
            got[path.rsplit(".", 1)[-1]] = r[1]
            assert spec[r[0]] == "model"
        else:
            assert "model" not in shd.spec_axes(spec), path
    assert got == want
    step = train_lib.MeshStep(cfg, train_lib.adamw.AdamWConfig(), mesh)
    assert step.roles == want


_MAMBA_ROLES = dict(w_in="columns", w_out="heads", a_log="heads",
                    dt_bias="heads", conv_w="part", ln_h="part")
_MLSTM_ROLES = {"mlstm.w_up": "columns", "mlstm.w_down": "heads",
                "mlstm.wq": "heads", "mlstm.wk": "heads", "mlstm.wv": "heads",
                "mlstm.b_gates": "heads", "mlstm.w_gates": "part",
                "mlstm.ln_h": "part", "slstm.wx": "heads", "slstm.r": "heads",
                "slstm.bias": "part", "slstm.ln_h": "part"}
_SLSTM_FFN = {"slstm.w_gate": "ffn", "slstm.w_up": "ffn",
              "slstm.w_down": "ffn", "embed": "vocab", "unembed": "vocab"}


@pytest.mark.parametrize("arch,shape,want", [
    ("zamba2-1.2b", (16, 16), dict(
        _MAMBA_ROLES, wq="heads", wk="heads", wv="heads", wo="heads",
        w_gate="ffn", w_up="ffn", w_down="ffn", embed="vocab",
        unembed="vocab")),
    ("xlstm-125m", (16, 16), _SLSTM_FFN),
    ("xlstm-125m", (4, 4), dict(_SLSTM_FFN, **_MLSTM_ROLES))])
def test_recurrent_model_roles(arch, shape, want):
    """The recurrent families' leaves that 'model' splits each have a role
    in the table (a Mamba2 ``w_in`` by columns, its ``conv_w`` by
    channels, ``w_out`` / ``a_log`` / ``dt_bias`` by heads; xLSTM by heads,
    head_dim where 16 does not divide its 4 heads), and the step splits a
    block where each of its leaves is split on heads or on columns it
    gathers: zamba2-1.2b's Mamba layers and shared block on 16x16; at
    xlstm-125m's 4 heads on 16 only the sLSTM FFN and the vocabulary, on 4
    its mLSTM and sLSTM blocks too. Leaves used in part ('part') are
    gathered whole and their gradients summed over 'model'."""
    cfg = configs.full_config(arch)
    tree = build(cfg).init(cfg, common.MetaDraw())
    mesh = meshlib.axes(shape, ("data", "model"))
    specs = shd.leaves(shd.param_specs(tree, mesh, "tp"))
    for path, spec in zip(shd.leaf_paths(tree), specs):
        r = shd.model_role(path, spec)
        assert (r is not None) == ("model" in shd.spec_axes(spec)), path
    step = train_lib.MeshStep(cfg, train_lib.adamw.AdamWConfig(), mesh)
    assert step.roles == want


def test_meta_init_keeps_the_seeded_init():
    """The meta path draws nothing: a seeded init after it has the bits of
    one without it."""
    cfg = configs.smoke_config("zamba2-1.2b")
    a = build(cfg).init(cfg, torch.Generator().manual_seed(0))
    build(cfg).init(cfg, common.MetaDraw())
    b = build(cfg).init(cfg, torch.Generator().manual_seed(0))
    fa, fb = _flat(a), _flat(b)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


# ----------------------------------------------------------------- blocks
_BLOCKS = """
import json, sys
import jax
import numpy as np
from jax.sharding import NamedSharding
from repro import configs
from repro.launch import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models.api import build

mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'))
coords = {}
for idx in np.ndindex(mesh.devices.shape):
    coords[mesh.devices[idx]] = list(map(int, idx))

def path_str(path):
    return '.'.join(str(getattr(k, 'key', getattr(k, 'idx', ''))) for k in path)

def blocks(shapes, specs):
    out = {}
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for (path, leaf), spec in zip(leaves, spec_leaves):
        m = NamedSharding(mesh, spec).devices_indices_map(tuple(leaf.shape))
        out[path_str(path)] = {
            ','.join(map(str, coords[d])): [
                [s.start or 0, leaf.shape[i] if s.stop is None else s.stop]
                for i, s in enumerate(idx)] for d, idx in m.items()}
    return out

res = {}
for arch in configs.ARCH_IDS:
    cfg = configs.full_config(arch)
    model = build(cfg)
    p = jax.eval_shape(lambda k: model.init(cfg, k), jax.random.PRNGKey(0))
    r = {layout: blocks(p, shd.param_specs(p, mesh, layout))
         for layout in ('tp', 'fsdp')}
    for name in ('decode_32k', 'long_500k'):
        s = configs.SHAPES[name]
        if configs.applicable(cfg, s)[0]:
            c = jax.eval_shape(lambda: model.init_cache(
                cfg, s.global_batch, s.seq_len))
            r[name] = blocks(c, shd.cache_specs(c, mesh))
    for name in ('train_4k', 'prefill_32k'):
        b = configs.input_specs(cfg, configs.SHAPES[name])
        for layout in ('tp', 'fsdp'):
            r[name + '-' + layout] = blocks(b, shd.batch_specs(b, mesh,
                                                                layout))
    res[arch] = r
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref_blocks():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_BLOCKS)],
                         capture_output=True, text=True, env=env,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _my_blocks(tree, specs, mesh) -> dict:
    out = {}
    leaves = shd.leaves(tree)
    paths = list(_flat(tree))
    for path, leaf, spec in zip(paths, leaves, shd.leaves(specs)):
        shape = tuple(getattr(leaf, "shape", ()))
        out[path] = {
            ",".join(map(str, mesh.coord_of(r).values())): [
                [s.start, s.stop] for s in shd.block(spec, shape, mesh,
                                                     mesh.coord_of(r))]
            for r in range(mesh.size)}
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_rank_block_matches_named_sharding(ref_blocks, arch):
    mesh = meshlib.axes((2, 2, 2), ("pod", "data", "model"))
    cfg = configs.full_config(arch)
    want = ref_blocks[arch]
    p = build(cfg).init(cfg, common.MetaDraw())
    got = {layout: _my_blocks(p, shd.param_specs(p, mesh, layout), mesh)
           for layout in ("tp", "fsdp")}
    for name in ("decode_32k", "long_500k"):
        s = configs.SHAPES[name]
        if configs.applicable(cfg, s)[0]:
            specs, c = train_lib.serve_shardings(cfg, mesh, s.global_batch,
                                                 s.seq_len)
            got[name] = _my_blocks(c, specs, mesh)
    for name in ("train_4k", "prefill_32k"):
        b = configs.input_specs(cfg, configs.SHAPES[name])
        for layout in ("tp", "fsdp"):
            got[name + "-" + layout] = _my_blocks(
                b, shd.batch_specs(b, mesh, layout), mesh)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


# ----------------------------------------------------------------- codecs
def test_int8_codec_matches_reference():
    r = np.random.default_rng(0)
    for x in (r.normal(size=(1000,)).astype(np.float32),
              (r.normal(size=(7, 33)) * 1e-3).astype(np.float32),
              np.zeros((5,), np.float32)):
        q, s = compress.quantize_int8(torch.tensor(x))
        jq, js = jcompress.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            compress.dequantize_int8(q, s).numpy(),
            np.asarray(jcompress.dequantize_int8(jq, js)))
    # error feedback: the residual carries what the codes dropped
    x = torch.tensor(r.normal(size=(1000,)).astype(np.float32))
    q, s = compress.quantize_int8(x)
    e = x - compress.dequantize_int8(q, s)
    assert float(e.abs().max()) <= float(s) / 2 + 1e-7


_PSUM = """
import sys, torch
import numpy as np
torch.set_num_threads(1)
from repro_torch.launch import dist
from repro_torch.optim import compress
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init(device='cpu', init_method=init, rank=rank, world=2)
r = np.random.default_rng(rank)
g = [torch.tensor(r.normal(size=(64,)).astype(np.float32)),
     torch.tensor(r.normal(size=(3, 5)).astype(np.float32))]
res = {}
for m in (None, 'bf16', 'int8'):
    red, e = compress.psum_compressed(g, None, m)
    red2, e2 = compress.psum_compressed(g, None, m, e)
    res[str(m)] = ([t.numpy() for t in red], [t.numpy() for t in red2],
                   None if e2 is None else [t.numpy() for t in e2])
if rank == 0:
    import pickle
    pickle.dump(res, open(out, 'wb'))
dist.destroy()
"""


def test_psum_compressed_on_a_gloo_group(tmp_path):
    init, out = "file://" + str(tmp_path / "pg"), str(tmp_path / "r.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM, str(r), init,
                               out], env=env, cwd=ROOT,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    import pickle
    with open(out, "rb") as f:
        res = pickle.load(f)
    rngs = [np.random.default_rng(k) for k in range(2)]
    g0, g1 = ([r.normal(size=s).astype(np.float32) for s in ((64,), (3, 5))]
              for r in rngs)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16).float().numpy()
    for j in range(2):
        np.testing.assert_allclose(res["None"][0][j], (g0[j] + g1[j]) / 2,
                                   rtol=1e-6)
        # bf16: each rank's gradient rounded, the sum rounded once more
        want = bf(bf(g0[j]) + bf(g1[j])) / 2
        np.testing.assert_array_equal(res["bf16"][0][j], want)
        # int8 with error feedback, the second call from the first's
        # residuals (each rank's residual is its own)
        deq = []
        for g in (g0[j], g1[j]):
            q, s = jcompress.quantize_int8(jnp.asarray(g))
            deq.append(np.asarray(jcompress.dequantize_int8(q, s)))
        want = bf(bf(deq[0]) + bf(deq[1])) / 2
        np.testing.assert_array_equal(res["int8"][0][j], want)
        e0 = g0[j] - deq[0]
        x = g0[j] + e0
        q, s = jcompress.quantize_int8(jnp.asarray(x))
        np.testing.assert_allclose(
            res["int8"][2][j],
            x - np.asarray(jcompress.dequantize_int8(q, s)), atol=1e-7)
