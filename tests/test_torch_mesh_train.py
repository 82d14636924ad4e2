"""The port's sharded LM training (``launch.train_lib.MeshStep`` on a
``launch.mesh`` of gloo CPU ranks) against the JAX reference's GSPMD step
on a 4-device host mesh, and against the port's own unsharded step.

One module fixture runs, from the same numpy inputs (the port's seeded
init and token batches, some targets masked unevenly across the ranks):

* the reference subprocess (``--xla_force_host_platform_device_count=4``):
  its train step on a (2, 2) ('data', 'model') mesh under ``tp`` (with
  ``gather_params_once`` and ``accum_steps`` 2) and ``fsdp`` (``accum_steps``
  2), the MoE arch under ``tp`` with each dispatch ('scatter' and
  'einsum'), llama3-8b on (1, 4) under ``tp`` (its kv heads split by
  head_dim), yi-34b on (2, 2) under ``tp`` (7 heads, 1 kv head: all
  attention split by head_dim), qwen2.5-32b on (1, 4) under ``tp`` (QKV
  bias: ``bq`` split by heads, ``bk`` / ``bv`` by head_dim), musicgen on
  (2, 2) under ``tp`` (the embeds frontend), the per-layer FSDP gather
  under remat (the dense arch under ``fsdp``, ``remat='full'``,
  ``accum_steps`` 2; zamba2 and xLSTM under ``tp``, remat full: 'data'
  gathers each Mamba layer, the shared block, each mLSTM block in its
  remat and each sLSTM block), and the (2, 2, 1) ('pod', 'data', 'model')
  mesh with ``grad_compress`` None, 'bf16' and 'int8' (two steps, the
  second from the first's residuals: ``tests/test_distributed.py``);
* then 4 port ranks, each reference step taken again from the
  reference's state before it (the method of ``test_torch_train.py``);
* beside the reference, 4 more port ranks: elastic restore (2 steps on
  (2, 2), a sharded save, a restore on (4, 1) and on (1, 4), one more
  step each, against 3 straight steps: ``tests/test_distributed.py``),
  ``launch.train --mesh 2,2`` with a save and a resume, a step on
  (1, 4) whose forward's leaves and matrix-product FLOPs are recorded,
  a per-layer fsdp step on (2, 2) whose gathered blocks are, and the
  sharded serving step of every family (``MeshServe``) against the
  reference's serving forward and decode;
* and a group of 1 rank: every mesh, layout and option bitwise equal to
  the unsharded step.

Every port step's ``dist.calls`` is held to its ``MeshStep.plan``. Every
case but ``tp`` (``gather_params_once``) runs the per-layer gather.
"""
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data import TokenPipeline
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import train, train_lib
from repro_torch.models.api import build
from repro_torch.optim import adamw

from test_torch_train import OCFG, _assert_steps, _flat, _tree_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400                     # seconds, for every subprocess
B, L, STEPS = 8, 32, 2
ARCHS = {"dense": "llama3-8b", "moe": "phi3.5-moe-42b-a6.6b",
         "moe-einsum": "phi3.5-moe-42b-a6.6b", "yi": "yi-34b",
         "qwen": "qwen2.5-32b", "audio": "musicgen-large",
         "dense-remat": "llama3-8b", "zamba": "zamba2-1.2b",
         "xlstm": "xlstm-125m", "xlstm-96": "xlstm-125m",
         "dense-sp": "llama3-8b", "moe-sp": "phi3.5-moe-42b-a6.6b",
         "moe-serve": "phi3.5-moe-42b-a6.6b",
         "moe-einsum-serve": "phi3.5-moe-42b-a6.6b", "xlstm-dh": "xlstm-125m"}
# xlstm-96: d_model 96, so that the sLSTM FFN (128 wide; 85 at the smoke
# width, which no 'model' > 1 divides) splits over 'model' too
OVERRIDES = {"moe-einsum": {"moe_impl": "einsum"},
             "dense-remat": {"remat": "full"}, "zamba": {"remat": "full"},
             "xlstm": {"remat": "full"},
             "xlstm-96": {"remat": "full", "d_model": 96},
             "dense-sp": {"seq_parallel": True},
             "moe-sp": {"seq_parallel": True},
             # capacity factor E / k: a prompt's prefill drops no token, so
             # the cache it fills is the one the reference's one-token
             # decode over the prompt builds (with drops the two differ in
             # both packages: tests/test_torch_moe.py)
             "moe-serve": {"capacity_factor": 2.0},
             "moe-einsum-serve": {"capacity_factor": 2.0,
                                  "moe_impl": "einsum"},
             # one mLSTM head, which 'model' 2 does not divide: the memory
             # C splits its dhk over 'model', n and m stay whole (and the
             # sLSTM state), each rank holding every row of a batch that
             # splits over 'data'
             "xlstm-dh": {"n_heads": 1, "n_kv_heads": 1}}
MESH22 = ((2, 2), ("data", "model"))
MESH14 = ((1, 4), ("data", "model"))
POD = ((2, 2, 1), ("pod", "data", "model"))
# name: (arch, mesh, layout, accum_steps, gather_params_once, codec)
CASES = {
    "tp": ("dense", MESH22, "tp", 2, True, None),
    "fsdp": ("dense", MESH22, "fsdp", 2, False, None),
    "moe": ("moe", MESH22, "tp", 1, False, None),
    "moe-einsum": ("moe-einsum", MESH22, "tp", 1, False, None),
    "tp-1x4": ("dense", MESH14, "tp", 1, False, None),
    "yi": ("yi", MESH22, "tp", 1, False, None),
    "qwen": ("qwen", MESH14, "tp", 1, False, None),
    "audio": ("audio", MESH22, "tp", 1, False, None),
    "fsdp-remat": ("dense-remat", MESH22, "fsdp", 2, False, None),
    "zamba-fsdp": ("zamba", MESH22, "tp", 1, False, None),
    "xlstm-fsdp": ("xlstm", MESH22, "tp", 1, False, None),
    "zamba-tp-1x4": ("zamba", MESH14, "tp", 1, False, None),
    "xlstm-96": ("xlstm-96", MESH22, "tp", 1, False, None),
    "pod-None": ("dense", POD, "tp", 1, False, None),
    "pod-bf16": ("dense", POD, "tp", 1, False, "bf16"),
    "pod-int8": ("dense", POD, "tp", 1, False, "int8"),
    "tp-sp": ("dense-sp", MESH22, "tp", 1, False, None),
}
# serving on the mesh (MeshServe, tp): name -> (arch key, mesh); the
# prompt is the first batch's tokens (B x L), then N_DEC decode steps fed
# the second batch's first tokens (none under seq_parallel, which acts on
# the prefill only)
SERVE = {"dense": ("dense", MESH22), "dense-1x4": ("dense", MESH14),
         "moe": ("moe-serve", MESH22),
         "moe-einsum": ("moe-einsum-serve", MESH22),
         "yi": ("yi", MESH22), "audio": ("audio", MESH22),
         "dense-sp": ("dense-sp", MESH22),
         "zamba": ("zamba", MESH22), "zamba-1x4": ("zamba", MESH14),
         "zamba-b1": ("zamba", MESH22), "xlstm-96": ("xlstm-96", MESH22),
         "xlstm-dh": ("xlstm-dh", MESH22)}
# the rows of a serving case's batches, where not all B: zamba-b1's one row
# does not split over 'data', so its shared attention cache splits its
# positions over 'data' and its Mamba states take their (None, ...) specs
SERVE_ROWS = {"zamba-b1": 1}
N_DEC = 4


def _inputs(path) -> dict:
    """The port's seeded init of each arch's smoke config and STEPS token
    batches (through a seeded embeds stub for an embeds frontend), with
    targets masked unevenly: every (data, model) rank of a (2, 2) mesh
    sees a different share (rows 0-1 of the first microbatch entirely,
    row 5 in part)."""
    out = {}
    for key, arch in ARCHS.items():
        cfg = _port_cfg(key, "tp")
        init = build(cfg).init(cfg, torch.Generator().manual_seed(0))
        tp = TokenPipeline(cfg.vocab_size, batch=B, seq_len=L, seed=0)
        emb = np.random.default_rng(0).normal(
            scale=0.02, size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
        batches = []
        for i in range(STEPS + 1):
            b = tp.batch_at(i)
            if cfg.frontend == "embeds":
                b = {"embeds": emb[b["tokens"]], "targets": b["targets"]}
            b["targets"][0:2] = -1
            b["targets"][5, 3:20] = -1
            batches.append(b)
        out[key] = dict(init=_tree_np(init), batches=batches)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return out


_REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.launch import train_lib
from repro.launch import mesh as meshlib
from repro.optim import adamw

D = pickle.load(open(sys.argv[1], 'rb'))
CASES, STEPS, OCFG = %(cases)r, %(steps)r, %(ocfg)r
ARCHS, OVERRIDES = %(archs)r, %(over)r
out = {}
for name, (key, (shape, axes), layout, accum, once, codec) in CASES.items():
    cfg = dataclasses.replace(configs.smoke_config(ARCHS[key]),
                              layout=layout, **OVERRIDES.get(key, {}))
    mesh = meshlib.make_mesh(shape, axes,
                             devices=jax.devices()[:int(np.prod(shape))])
    b0 = jax.tree.map(jnp.asarray, D[key]['batches'][0])
    psh, osh, bsh, _ = train_lib.shardings_for(cfg, mesh, b0)
    step = train_lib.make_train_step(
        cfg, adamw.AdamWConfig(**OCFG), mesh, grad_compress=codec,
        accum_steps=accum, gather_params_once=once)
    hist = []
    with meshlib.set_mesh(mesh):
        params = jax.device_put(jax.tree.map(jnp.asarray, D[key]['init']),
                                psh)
        opt = jax.jit(adamw.init, out_shardings=osh)(params)
        run = step if codec else jax.jit(
            step, in_shardings=(psh, osh, bsh),
            out_shardings=(psh, osh, None))
        res = None
        for s in range(STEPS):
            b = jax.device_put(jax.tree.map(jnp.asarray,
                                            D[key]['batches'][s]), bsh)
            o = run(params, opt, b, res) if codec else run(params, opt, b)
            params, opt, m = o[:3]
            res = o[3] if codec else None
            hist.append(dict(
                loss=float(m['loss']), grad_norm=float(m['grad_norm']),
                params=jax.tree.map(np.asarray, params),
                opt=jax.tree.map(np.asarray, opt),
                res=None if res is None else jax.tree.map(np.asarray, res)))
    out[name] = hist

# serving: the forward over the prompt, and the cache built by decoding
# the prompt one token at a time (the reference example's way), then
# N_DEC decode steps; each jitted with the serving cells' shardings
from repro.models.api import build
SERVE, SERVE_ROWS, N_DEC = %(serve)r, %(rows)r, %(n_dec)r
for name, (key, (shape, axes)) in SERVE.items():
    cfg = dataclasses.replace(configs.smoke_config(ARCHS[key]), layout='tp',
                              **OVERRIDES.get(key, {}))
    mesh = meshlib.make_mesh(shape, axes,
                             devices=jax.devices()[:int(np.prod(shape))])
    model = build(cfg)
    b0, b1 = ({k: v[:SERVE_ROWS.get(name)] for k, v in b.items()}
              for b in D[key]['batches'][:2])
    k = 'embeds' if 'embeds' in b0 else 'tokens'
    B, L = b0[k].shape[:2]
    psh, _, bsh, _ = train_lib.shardings_for(cfg, mesh, {k: b0[k]})
    bsh1 = train_lib.shardings_for(cfg, mesh, {k: b0[k][:, :1]})[2]
    csh, _ = train_lib.serve_shardings(cfg, mesh, B, L + N_DEC)
    with meshlib.set_mesh(mesh):
        params = jax.device_put(jax.tree.map(jnp.asarray, D[key]['init']),
                                psh)
        fwd = jax.jit(lambda p, b: model.forward(p, cfg, b)[0],
                      in_shardings=(psh, bsh))
        dec = jax.jit(lambda p, c, b: model.decode(p, cfg, c, b),
                      in_shardings=(psh, csh, bsh1),
                      out_shardings=(None, csh))
        logits = np.asarray(fwd(params, {k: jnp.asarray(b0[k])}))
        n = 0 if cfg.seq_parallel else N_DEC
        cache = jax.device_put(model.init_cache(cfg, B, L + N_DEC), csh)
        for t in range(L if n else 0):
            _, cache = dec(params, cache, {k: jnp.asarray(b0[k][:, t:t + 1])})
        steps = []
        for i in range(n):
            lg, cache = dec(params, cache,
                            {k: jnp.asarray(b1[k][:, i:i + 1])})
            steps.append(np.asarray(lg))
    out['serve-' + name] = dict(prefill=logits, decode=steps)
pickle.dump(out, open(sys.argv[2], 'wb'))
""" % dict(cases=CASES, steps=STEPS, ocfg=OCFG, archs=ARCHS,
           over=OVERRIDES, serve=SERVE, rows=SERVE_ROWS, n_dec=N_DEC)


# the common head of every port process: a gloo group, and helpers that
# turn whole numpy trees into this rank's blocks and back
_HEAD = """
import dataclasses, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import configs, convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import dist, train, train_lib
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding as shd
from repro_torch.optim import adamw

rank, world, init, inputs, out = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init(device='cpu', init_method=init, rank=rank, world=world)
D = pickle.load(open(inputs, 'rb'))
CASES, OCFG, ARCHS, OVERRIDES = %(cases)r, %(ocfg)r, %(archs)r, %(over)r
SERVE, SERVE_ROWS, N_DEC = %(serve)r, %(rows)r, %(n_dec)r
res = {}

def setup(key, shape, axes, layout):
    cfg = dataclasses.replace(configs.smoke_config(ARCHS[key]),
                              layout=layout, **OVERRIDES.get(key, {}))
    mesh = meshlib.make_mesh(shape, axes)
    ps, os_, _, _ = train_lib.shardings_for(cfg, mesh, {})
    return cfg, mesh, ps, os_

def blocks(params, opt, ps, os_, mesh):
    p = convert.lm_params(params, 'cpu')
    o = adamw.init(p) if opt is None else convert.adamw_state(opt, 'cpu')
    return shd.shard_tree(p, ps, mesh), shd.shard_tree(o, os_, mesh)

def whole(tree, specs, mesh):
    return {k: v.numpy()
            for k, v in _np(shd.gather_tree(tree, specs, mesh)).items()}

def _np(tree, prefix=''):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_np(v, prefix + k + '/'))
        else:
            out[prefix + k] = v.detach().float()
    return out

def batch(key, s):
    return {k: torch.tensor(v) for k, v in D[key]['batches'][s].items()}

def run_step(step, pb, ob, b, r=None):
    dist.calls.clear()
    o = step(pb, ob, b, r) if step.use_pod else step(pb, ob, b)
    calls = dict(dist.calls)
    plan = train_lib.plan_calls(step.plan(b))
    return o, dict(calls=calls, plan=plan)
""" % dict(cases=CASES, ocfg=OCFG, archs=ARCHS, over=OVERRIDES,
           serve=SERVE, rows=SERVE_ROWS, n_dec=N_DEC)

_TAIL = """
if rank == 0:
    pickle.dump(res, open(out, 'wb'))
dist.destroy()
"""

# 4 ranks: each reference step again from the reference's state before it
_HELD = _HEAD + """
R = pickle.load(open(sys.argv[6], 'rb'))
for name, (key, (shape, axes), layout, accum, once, codec) in CASES.items():
    cfg, mesh, ps, os_ = setup(key, shape, axes, layout)
    step = train_lib.make_train_step(
        cfg, adamw.AdamWConfig(**OCFG), mesh, grad_compress=codec,
        accum_steps=accum, gather_params_once=once)
    hist = R[name]
    got = []
    for s in range(len(hist)):
        prev = None if s == 0 else hist[s - 1]
        pb, ob = blocks(D[key]['init'] if prev is None else prev['params'],
                        None if prev is None else prev['opt'], ps, os_,
                        mesh)
        r = None
        if codec and prev is not None:
            # this rank's block of its pod's row of the reference's
            r = shd.shard_tree(shd.map_with_path(
                lambda _, x: torch.tensor(x[mesh.coord['pod']]),
                prev['res']), ps, mesh)
        if cfg.seq_parallel:
            # the same step without seq_parallel, from the same state
            twin = train_lib.make_train_step(
                dataclasses.replace(cfg, seq_parallel=False),
                adamw.AdamWConfig(**OCFG), mesh)
            tp_, to_ = blocks(D[key]['init'] if prev is None
                              else prev['params'],
                              None if prev is None else prev['opt'], ps,
                              os_, mesh)
            tp_, to_, tm = twin(tp_, to_, batch(key, s))
            no_sp = dict(loss=float(tm['loss']),
                         grad_norm=float(tm['grad_norm']),
                         params=whole(tp_, ps, mesh))
        o, calls = run_step(step, pb, ob, batch(key, s), r)
        rec = dict(loss=float(o[2]['loss']),
                   grad_norm=float(o[2]['grad_norm']),
                   lr=float(o[2]['lr']), params=whole(o[0], ps, mesh),
                   m=whole(o[1]['m'], ps, mesh), **calls)
        if cfg.seq_parallel:
            rec['no_sp'] = no_sp
        if codec:
            pod = mesh.group(('pod',))
            rows = shd.gather_tree(o[3], ps, mesh)
            rec['res'] = {k: dist.all_gather(v, pod).numpy()
                          for k, v in _np(rows).items()}
        got.append(rec)
    res[name] = got
""" + _TAIL

# 4 ranks, no reference needed: elastic restore and the CLI on a mesh
_FREE = _HEAD + """
import os
cfg, m22, ps, os_ = setup('dense', (2, 2), ('data', 'model'), 'tp')
ocfg = adamw.AdamWConfig(**OCFG)
d = os.path.join(os.path.dirname(out), 'elastic')

def steps_on(mesh, ps, os_, pb, ob, lo, hi):
    step = train_lib.make_train_step(cfg, ocfg, mesh)
    hist = []
    for s in range(lo, hi):
        o, calls = run_step(step, pb, ob, batch('dense', s))
        pb, ob = o[0], o[1]
        hist.append(dict(loss=float(o[2]['loss']),
                         grad_norm=float(o[2]['grad_norm']),
                         lr=float(o[2]['lr']), **calls))
    return pb, ob, hist

pb, ob = blocks(D['dense']['init'], None, ps, os_, m22)
pb, ob, h2 = steps_on(m22, ps, os_, pb, ob, 0, 2)
m_before = whole(ob['m'], ps, m22)
ckpt.save_sharded(os.path.join(d, 'step_2'), 2, {'params': pb, 'opt': ob},
                  {'params': ps, 'opt': os_}, m22)
p3, o3, h3 = steps_on(m22, ps, os_, pb, ob, 2, 3)
el = dict(straight=dict(hist=h2 + h3, params=whole(p3, ps, m22),
                        m=[m_before, whole(o3['m'], ps, m22)]))
saved = ckpt.restore(os.path.join(d, 'step_2'), 'params',
                     convert.lm_params(D['dense']['init'], 'cpu'))
el['saved'] = {k: v.numpy() for k, v in _np(saved).items()}
for shape in ((4, 1), (1, 4)):
    _, mesh, ps2, os2 = setup('dense', shape, ('data', 'model'), 'tp')
    p_sh, o_sh = train_lib.shardings_for(cfg, mesh, {})[3]
    pb2 = ckpt.restore_sharded(os.path.join(d, 'step_2'), 'params', p_sh,
                               ps2, mesh)
    ob2 = ckpt.restore_sharded(os.path.join(d, 'step_2'), 'opt', o_sh,
                               os2, mesh)
    p4, _, h4 = steps_on(mesh, ps2, os2, pb2, ob2, 2, 3)
    el[str(shape)] = dict(hist=h4, params=whole(p4, ps2, mesh))
res['elastic'] = el

cli = ['--arch', 'llama3-8b', '--device', 'cpu', '--mesh', '2,2',
       '--batch', '8', '--seq', '32']
ck = os.path.join(os.path.dirname(out), 'cli')
uncut = train.main(cli + ['--steps', '6'])
cut = train.main(cli + ['--steps', '3', '--ckpt-dir', ck,
                        '--ckpt-every', '3'])
resumed = train.main(cli + ['--steps', '3', '--ckpt-dir', ck, '--resume'])
_, mcli, psc, _ = setup('dense', (2, 2), ('data', 'model'), 'tp')
res['cli'] = dict(
    uncut=uncut['loss'], cut=cut['loss'], resumed=resumed['loss'],
    start=resumed['start'], steps=resumed['step'],
    uncut_params=whole(uncut['params'], psc, mcli),
    resumed_params=whole(resumed['params'], psc, mcli))

# a (1, 4) tp step: the shapes of the leaves its forward gets, and its
# matrix-product FLOPs beside the unsharded step's, on every rank
from torch.utils.flop_counter import FlopCounterMode
_, m14, ps14, os14 = setup('dense', (1, 4), ('data', 'model'), 'tp')
step = train_lib.make_train_step(cfg, ocfg, m14)
seen, fwd = [], step.model.forward
step.model.forward = lambda p, *a, **k: seen.append(
    [tuple(x.shape) for x in adamw.leaves(p)]) or fwd(p, *a, **k)
try:
    pb, ob = blocks(D['dense']['init'], None, ps14, os14, m14)
    with FlopCounterMode(display=False) as fc:
        _, calls = run_step(step, pb, ob, batch('dense', 0))
finally:
    step.model.forward = fwd
p = convert.lm_params(D['dense']['init'], 'cpu')
with FlopCounterMode(display=False) as fc1:
    train_lib.make_train_step(cfg, ocfg)(p, adamw.init(p), batch('dense', 0))
split = ['model' in shd.spec_axes(s) for s in step.specs]
whole_got = sum(got == tuple(x.shape)
                for leaves in seen
                for got, x, sp in zip(leaves, step.shapes, split) if sp)
mine = torch.tensor([float(len(seen)), float(sum(split)), float(whole_got),
                     fc.get_total_flops() / fc1.get_total_flops()],
                    dtype=torch.float64)
res['split'] = dict(ranks=dist.all_gather(mine).tolist(), **calls)

# a per-layer fsdp step on (2, 2) under remat: the shape of every block it
# gathers, beside the blocks of the stacked leaves
rcfg = dataclasses.replace(cfg, layout='fsdp', remat='full')
_, m22f, psf, osf = setup('dense', (2, 2), ('data', 'model'), 'fsdp')
step = train_lib.make_train_step(rcfg, ocfg, m22f)
got_shapes, gather = [], shd.gather
shd.gather = lambda b, *a, **k: got_shapes.append(tuple(b.shape)) or \
    gather(b, *a, **k)
try:
    pb, ob = blocks(D['dense']['init'], None, psf, osf, m22f)
    _, calls = run_step(step, pb, ob, batch('dense', 0))
finally:
    shd.gather = gather
stacked = [tuple(b.shape) for b in adamw.leaves(pb['layers'])]
res['layer_gathers'] = dict(shapes=got_shapes, stacked=stacked,
                            layers=rcfg.n_layers, **calls)

# zamba2 on (1, 4) and xLSTM (d_model 96) on (2, 2) under tp: every weight
# a layer's forward gets (common.weights, again in the recompute) against
# this rank's table block of the whole leaf, and the gradient the backward
# hands each split leaf's reduce against that block's shape
from repro_torch.models import common
for key, shape in (('zamba', (1, 4)), ('xlstm-96', (2, 2))):
    kcfg, mesh, psk, osk = setup(key, shape, ('data', 'model'), 'tp')
    step = train_lib.make_train_step(kcfg, ocfg, mesh)
    full = convert.lm_params(D[key]['init'], 'cpu')
    coord = dict(mesh.coord, data=0)

    def model_block(j, w):
        # the whole leaf's block on this rank's 'model' coordinate alone
        spec = shd.Spec(*[e if 'model' in shd.entry_axes(e) else None
                          for e in step.units[j].spec])
        return w[shd.block(spec, w.shape, mesh, coord)]

    fetched, reduced, weights = [], [], common.weights

    def record(tree, path='', *idx):
        out = weights(tree, path, *idx)
        for k, w in out.items():
            p = f'{path}.{k}' if path else k
            j = step.index[p]
            whole = full
            for part in p.split('.'):
                whole = whole[part]
            whole = whole[idx]
            if step.split[j]:
                fetched.append((p, torch.equal(w, model_block(j, whole)),
                                tuple(w.shape) == tuple(whole.shape)))
        return out

    reduce = step._reduce
    step._reduce = lambda g, leaf, spec, red, split=False: (
        reduced.append(tuple(g.shape) == tuple(
            shd.block_shape(shd.Spec(*[e if 'model' in shd.entry_axes(e)
                                       else None for e in spec]),
                            leaf.shape, mesh))) if split else None) or \
        reduce(g, leaf, spec, red, split)
    common.weights = record
    try:
        pb, ob = blocks(D[key]['init'], None, psk, osk, mesh)
        (pb, ob, _), calls = run_step(step, pb, ob, batch(key, 0))
    finally:
        common.weights = weights
    m_ok = all(tuple(m.shape) == shd.block_shape(s_, tuple(x.shape), mesh)
               for m, s_, x in zip(adamw.leaves(ob['m']), step.specs,
                                   step.shapes))
    mine = torch.tensor([len(fetched), sum(f[1] for f in fetched),
                         sum(f[2] for f in fetched),
                         len({f[0] for f in fetched}), sum(step.split),
                         len(reduced), sum(reduced), float(m_ok)],
                        dtype=torch.float64)
    res['split-' + key] = dict(ranks=dist.all_gather(mine).tolist(),
                               roles=step.roles, **calls)

# seq_parallel on the MoE arch (the router on the gathered whole): one tp
# step on (2, 2) with it and one without it, from the seeded init
scfg, m22s, pss, oss = setup('moe-sp', (2, 2), ('data', 'model'), 'tp')
got = {}
for sp in (True, False):
    c = dataclasses.replace(scfg, seq_parallel=sp)
    step = train_lib.make_train_step(c, ocfg, m22s)
    pb, ob = blocks(D['moe-sp']['init'], None, pss, oss, m22s)
    (pb, ob, m), calls = run_step(step, pb, ob, batch('moe-sp', 0))
    got[sp] = dict(loss=float(m['loss']), grad_norm=float(m['grad_norm']),
                   lr=float(m['lr']), params=whole(pb, pss, m22s),
                   m=whole(ob['m'], pss, m22s), **calls)
res['moe-sp'] = got

# serving (MeshServe): prefill over the prompt into this rank's block of
# the cache, then N_DEC decode steps; the logits and tokens of the whole
# batch, and on every rank: its block of every cache leaf against its block
# of the unsharded step's cache, the shape of every weight a layer fetched
# against its unit's block, and dist.calls against the plan
from repro_torch.models.api import build

def parts(c):
    # the tensors (or specs) of a cache, a tuple leaf's parts in order
    return [t for k in sorted(c) if k not in ('pos', 'len')
            for t in (c[k] if type(c[k]) is tuple else (c[k],))]

for name, (key, (shape, axes)) in SERVE.items():
    cfg, mesh, ps, _ = setup(key, shape, axes, 'tp')
    b0, b1 = ({k: v[:SERVE_ROWS.get(name)] for k, v in b.items()}
              for b in D[key]['batches'][:2])
    k = 'embeds' if 'embeds' in b0 else 'tokens'
    prompt = {k: torch.tensor(b0[k])}
    B, L = prompt[k].shape[:2]
    steps = [{k: torch.tensor(b1[k][:, i:i + 1])}
             for i in range(0 if cfg.seq_parallel else N_DEC)]
    pre = train_lib.make_prefill_step(cfg, mesh)
    dec = train_lib.make_serve_step(cfg, mesh)
    p = convert.lm_params(D[key]['init'], 'cpu')
    pb = shd.shard_tree(p, ps, mesh)
    want = {}
    for path, j in pre.index.items():
        u = pre.units[j]
        sh = list(u.meta.shape)
        for i, axs in shd.sharded_dims(u.spec):
            if pre.split[j] and 'model' in axs:
                sh[i] //= pre.n_model
        want[path] = tuple(sh)
    fetched = []
    for srv in (pre, dec):
        def rec_fetch(tree, path, idx, f=srv._fetch):
            got = f(tree, path, idx)
            fetched.extend((f'{path}.{n}' if path else n, tuple(w.shape))
                           for n, w in got.items())
            return got
        srv._fetch = rec_fetch

    def joined(x):
        # this rank's rows (and vocabulary block) -> the whole batch's
        if 'unembed' in pre.roles and x.dim() == 3:
            x = dist.all_gather_rows(x.contiguous(), 2,
                                     mesh.group(('model',)))
        return pre.join_rows(x, B)

    cache = pre.init_cache(B, L + N_DEC, device='cpu')
    dist.calls.clear()
    lg, cache = pre.logits(pb, prompt, cache)
    tok = pre.greedy(lg)
    ok = dict(dist.calls) == train_lib.plan_calls(
        pre.plan(prompt, max_len=L + N_DEC))
    rec = dict(prefill=joined(lg).numpy(), decode=[],
               tokens=[joined(tok).tolist()], roles=sorted(pre.roles))
    for b in steps:
        plan = train_lib.plan_calls(dec.plan(b, pos=cache['pos'],
                                             max_len=L + N_DEC))
        dist.calls.clear()
        lg, cache = dec.logits(pb, b, cache)
        tok = dec.greedy(lg)
        ok &= dict(dist.calls) == plan
        rec['decode'].append(joined(lg).numpy())
        rec['tokens'].append(joined(tok).tolist())
    model = build(cfg)
    f64 = lambda t: shd.map_with_path(
        lambda _, x: x.double() if torch.is_tensor(x) else x, t)
    if cfg.family in ('hybrid', 'ssm'):
        # the same prefill and decode steps on an fp64 copy of the weights
        # and the cache, on both sides: zamba2's and xLSTM's fp32 rounding
        # is amplified (the unsharded fp32 step's own shared K / V are up
        # to 2e-5 of their max from the fp64 function's), so their blocks
        # are held to the unsharded step's in fp64
        p, pb = f64(p), f64(pb)
        cache = f64(pre.init_cache(B, L + N_DEC, device='cpu'))
        cache = pre.logits(pb, prompt, cache)[1]
        for b in steps:
            cache = dec.logits(pb, b, cache)[1]
    full = model.init_cache(cfg, B, L + N_DEC, device='cpu')
    if cfg.family in ('hybrid', 'ssm'):
        full = f64(full)
    model.forward(p, cfg, prompt, cache=full)
    for b in steps:
        _, full = model.decode(p, cfg, full, b)
    cs, _ = train_lib.serve_shardings(cfg, mesh, B, L + N_DEC)
    mine, specs, whole = parts(cache), parts(cs), parts(full)
    cerr = max(float((a - shd.shard(w, s_, mesh)).abs().max())
               for a, s_, w in zip(mine, specs, whole))
    c_ok = len(mine) == len(whole) and all(
        tuple(a.shape) == shd.block_shape(s_, tuple(w.shape), mesh)
        for a, s_, w in zip(mine, specs, whole))
    f_ok = all(got == want[path] for path, got in fetched)
    mine = torch.tensor([cerr, float(c_ok), float(f_ok), len(fetched),
                         float(ok), float(cache['pos'])],
                        dtype=torch.float64)
    rec['ranks'] = dist.all_gather(mine).tolist()
    res['serve-' + name] = rec
""" + _TAIL

# 1 rank: every mesh, layout and option bitwise equal to the unsharded step
_WORLD1 = _HEAD + """
from repro_torch.optim import compress
def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(adamw.leaves(a),
                                                  adamw.leaves(b)))

out1 = {}
for key in ('dense', 'moe'):
    for layout in ('tp', 'fsdp'):
        for accum in (1, 2):
            for once in (False, True):
                for shape, axes, codec in (((1, 1), ('data', 'model'), None),
                                           ((1, 1, 1), ('pod', 'data',
                                                        'model'), None)):
                    if key == 'moe' and (shape != (1, 1) or once):
                        continue
                    cfg, mesh, ps, os_ = setup(key, shape, axes, layout)
                    one = train_lib.make_train_step(
                        cfg, adamw.AdamWConfig(**OCFG), accum_steps=accum)
                    step = train_lib.make_train_step(
                        cfg, adamw.AdamWConfig(**OCFG), mesh,
                        accum_steps=accum, gather_params_once=once)
                    p = convert.lm_params(D[key]['init'], 'cpu')
                    o = adamw.init(p)
                    pb, ob = blocks(D[key]['init'], None, ps, os_, mesh)
                    ok, cl = True, True
                    for s in range(2):
                        p, o, m1 = one(p, o, batch(key, s))
                        (pb, ob, m2), calls = run_step(step, pb, ob,
                                                       batch(key, s))
                        ok &= {k: float(v) for k, v in m1.items()} == \\
                            {k: float(v) for k, v in m2.items()}
                        cl &= calls['calls'] == calls['plan']
                    ok &= same(p, pb) and same(o['m'], ob['m']) and \\
                        same(o['v'], ob['v'])
                    out1[f'{key}-{layout}-{accum}-{once}-{len(shape)}'] = \\
                        dict(bitwise=bool(ok), calls=bool(cl))
# the int8 pod path: the residual is x - dequantize(quantize(x)) of the
# unsharded step's fp32 gradient, bitwise
cfg, mesh, ps, os_ = setup('dense', (1, 1, 1), ('pod', 'data', 'model'), 'tp')
step = train_lib.make_train_step(cfg, adamw.AdamWConfig(**OCFG), mesh,
                                 grad_compress='int8')
pb, ob = blocks(D['dense']['init'], None, ps, os_, mesh)
p = convert.lm_params(D['dense']['init'], 'cpu')
flat = [w.detach().requires_grad_() for w in adamw.leaves(p)]
loss, _ = train_lib.make_loss_fn(cfg)(adamw.tree_like(p, flat),
                                      batch('dense', 0))
grads = torch.autograd.grad(loss, flat)
o, _ = run_step(step, pb, ob, batch('dense', 0))
want = []
for g in grads:
    x = g.float() + torch.zeros_like(g.float())
    want.append(x - compress.dequantize_int8(*compress.quantize_int8(x)))
out1['int8-residual'] = dict(bitwise=all(
    torch.equal(a, b) for a, b in zip(adamw.leaves(o[3]), want)), calls=True)
# MeshServe (prefill into the cache, then N_DEC decode steps) and
# seq_parallel (a train step and a prefill) on (1, 1): bitwise the
# unsharded steps
from repro_torch.models.api import build
for key in ('dense', 'moe'):
    cfg, mesh, ps, os_ = setup(key, (1, 1), ('data', 'model'), 'tp')
    model = build(cfg)
    b0, b1 = D[key]['batches'][:2]
    prompt = {'tokens': torch.tensor(b0['tokens'])}
    steps = [{'tokens': torch.tensor(b1['tokens'][:, i:i + 1])}
             for i in range(N_DEC)]
    B, L = prompt['tokens'].shape
    p = convert.lm_params(D[key]['init'], 'cpu')
    pb = shd.shard_tree(p, ps, mesh)
    pre = train_lib.make_prefill_step(cfg, mesh)
    dec = train_lib.make_serve_step(cfg, mesh)
    c1 = model.init_cache(cfg, B, L + N_DEC, device='cpu')
    c2 = pre.init_cache(B, L + N_DEC, device='cpu')
    want, _ = model.forward(p, cfg, prompt, cache=c1)
    dist.calls.clear()
    got, c2 = pre.logits(pb, prompt, c2)
    ok = torch.equal(got, want) and torch.equal(
        pre.greedy(got), train_lib.make_prefill_step(cfg)(p, prompt))
    cl = dict(dist.calls) == train_lib.plan_calls(pre.plan(prompt))
    for b in steps:
        plan = train_lib.plan_calls(dec.plan(b, pos=c2['pos']))
        want, c1 = model.decode(p, cfg, c1, b)
        dist.calls.clear()
        got, c2 = dec.logits(pb, b, c2)
        ok &= torch.equal(got, want) and torch.equal(
            dec.greedy(got), torch.argmax(want[:, -1, :], dim=-1))
        cl &= dict(dist.calls) == plan
    ok &= all(torch.equal(c1[c], c2[c]) for c in ('k', 'v'))
    out1[f'serve-{key}'] = dict(bitwise=bool(ok), calls=bool(cl))
    scfg, mesh, ps, os_ = setup(key + '-sp', (1, 1), ('data', 'model'), 'tp')
    sp = train_lib.make_train_step(scfg, adamw.AdamWConfig(**OCFG), mesh)
    p2, o2, m2 = train_lib.make_train_step(
        cfg, adamw.AdamWConfig(**OCFG))(p, adamw.init(p), batch(key, 0))
    pb, ob = blocks(D[key]['init'], None, ps, os_, mesh)
    (pb, ob, m3), calls = run_step(sp, pb, ob, batch(key, 0))
    ok = {k: float(v) for k, v in m2.items()} == \
        {k: float(v) for k, v in m3.items()}
    ok &= same(p2, pb) and same(o2['m'], ob['m'])
    pf = train_lib.make_prefill_step(scfg, mesh)
    q = convert.lm_params(D[key]['init'], 'cpu')
    want, _ = model.forward(q, cfg, prompt)
    ok &= torch.equal(pf.logits(shd.shard_tree(q, ps, mesh), prompt)[0],
                      want)
    out1[f'sp-{key}'] = dict(bitwise=bool(ok),
                             calls=calls['calls'] == calls['plan'])
# zamba2 and xLSTM's MeshServe on (1, 1): bitwise the unsharded steps, every
# leaf of the cache too
for key in ('zamba', 'xlstm'):
    cfg, mesh, ps, os_ = setup(key, (1, 1), ('data', 'model'), 'tp')
    model = build(cfg)
    b0, b1 = D[key]['batches'][:2]
    prompt = {'tokens': torch.tensor(b0['tokens'])}
    steps = [{'tokens': torch.tensor(b1['tokens'][:, i:i + 1])}
             for i in range(N_DEC)]
    B, L = prompt['tokens'].shape
    p = convert.lm_params(D[key]['init'], 'cpu')
    pb = shd.shard_tree(p, ps, mesh)
    pre = train_lib.make_prefill_step(cfg, mesh)
    dec = train_lib.make_serve_step(cfg, mesh)
    c1 = model.init_cache(cfg, B, L + N_DEC, device='cpu')
    c2 = pre.init_cache(B, L + N_DEC, device='cpu')
    want, _ = model.forward(p, cfg, prompt, cache=c1)
    dist.calls.clear()
    got, c2 = pre.logits(pb, prompt, c2)
    ok = torch.equal(got, want) and torch.equal(
        pre.greedy(got), train_lib.make_prefill_step(cfg)(p, prompt))
    cl = dict(dist.calls) == train_lib.plan_calls(
        pre.plan(prompt, max_len=L + N_DEC))
    for b in steps:
        plan = train_lib.plan_calls(dec.plan(b, pos=c2['pos'],
                                             max_len=L + N_DEC))
        want, c1 = model.decode(p, cfg, c1, b)
        dist.calls.clear()
        got, c2 = dec.logits(pb, b, c2)
        ok &= torch.equal(got, want) and torch.equal(
            dec.greedy(got), torch.argmax(want[:, -1, :], dim=-1))
        cl &= dict(dist.calls) == plan
    ten = lambda c: shd.leaves({k: v for k, v in c.items()
                                if k not in ('pos', 'len')})
    ok &= sorted(c1) == sorted(k for k in c2 if k != 'len') and all(
        torch.equal(x, y) for x, y in zip(ten(c1), ten(c2)))
    out1[f'serve-{key}'] = dict(bitwise=bool(ok), calls=bool(cl))
res['world1'] = out1
""" + _TAIL


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", **kw)


def _spawn(code, world, tmp, name, inputs, *extra):
    init = "file://" + str(tmp / f"pg-{name}")
    out = str(tmp / f"{name}.pkl")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), init, str(inputs),
         out, *map(str, extra)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
        for r in range(world)]
    return procs, out


def _wait(procs, out, deadline):
    """The pickled results of a group, or the exception of its failure
    (raised by the tests that read it)."""
    try:
        for r, proc in enumerate(procs):
            try:
                _, err = proc.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                tails = [q.communicate()[1][-1500:] for q in procs[r:]]
                raise TimeoutError(
                    f"{out}: rank {r} still running at the fixture's "
                    f"{TIMEOUT} s deadline; stderr of ranks {r}..: "
                    f"{tails}") from None
            assert proc.returncode == 0, f"{out}: rank {r}: {err[-4000:]}"
        with open(out, "rb") as f:
            return pickle.load(f)
    except Exception as exc:          # noqa: BLE001 — held for the tests
        return exc


def _get(runs, group, key):
    got = runs[group]
    if isinstance(got, Exception):
        raise got
    return got[key]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    inputs = tmp / "inputs.pkl"
    D = _inputs(inputs)
    deadline = time.monotonic() + TIMEOUT
    ref_out = tmp / "ref.pkl"
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(inputs), str(ref_out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                 JAX_PLATFORMS="cpu"), cwd=ROOT)
    free = _spawn(_FREE, 4, tmp, "free", inputs)
    world1 = _spawn(_WORLD1, 1, tmp, "world1", inputs)
    got = dict(D=D)
    got["ref"] = _wait([ref], str(ref_out), deadline)
    if isinstance(got["ref"], Exception):
        got["held"] = got["ref"]
    else:
        held = _spawn(_HELD, 4, tmp, "held", inputs, ref_out)
        got["held"] = _wait(*held, deadline)
    got["free"] = _wait(*free, deadline)
    got["world1"] = _wait(*world1, deadline)
    return got


# ------------------------------------------------- held from the reference
def _port_cfg(key, layout):
    import dataclasses
    return dataclasses.replace(configs.smoke_config(ARCHS[key]),
                               layout=layout, **OVERRIDES.get(key, {}))


def _unsharded_step(key, layout, accum, state, opt, batch):
    """The port's unsharded step from a numpy state: (params, m, (loss,
    grad norm, lr))."""
    cfg = _port_cfg(key, layout)
    p = convert.lm_params(state, "cpu")
    o = adamw.init(p) if opt is None else convert.adamw_state(opt, "cpu")
    step = train_lib.make_train_step(cfg, adamw.AdamWConfig(**OCFG),
                                     accum_steps=accum)
    p, o, m = step(p, o, {k: torch.tensor(v) for k, v in batch.items()})
    return p, o["m"], (float(m["loss"]), float(m["grad_norm"]),
                       float(m["lr"]))


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


# zamba2's gradients differ from the reference's by up to 5.8e-5 of a
# leaf's max on the port's unsharded step too (grad norm 9.491028 against
# 9.490909 unsharded and 9.490899 sharded there: 1.4e-5 relative), over
# _assert_steps' 1e-5. Neither is the fp64 gradient: at this seed a
# half-ulp perturbation of the in-projection alone moves the fp32 gradient
# by 1.4e-5 to 3.7e-5 of a leaf's max, and the two packages' CPU matrix
# products round differently (ROADMAP queue 3). Its cases are held against
# the reference's loss, and in full against the port's unsharded step
UNSHARDED_ONLY = ("zamba-fsdp", "zamba-tp-1x4")


@pytest.mark.parametrize("case", ["tp", "fsdp", "moe", "pod-None",
                                  "tp-1x4", "yi", "moe-einsum", "qwen",
                                  "audio", "fsdp-remat", "zamba-fsdp",
                                  "xlstm-fsdp", "zamba-tp-1x4", "xlstm-96",
                                  "tp-sp"])
def test_sharded_step_matches_reference_and_unsharded(runs, case):
    key, _, layout, accum, _, _ = CASES[case]
    ref = _get(runs, "ref", case)
    got = _get(runs, "held", case)
    D = runs["D"][key]
    for s, (want, mine) in enumerate(zip(ref, got)):
        prev_m = _zeros_like(ref[0]["opt"]["m"]) if s == 0 \
            else ref[s - 1]["opt"]["m"]
        hist = [(mine["loss"], mine["grad_norm"], mine["lr"])]
        # against the reference's step from the same state
        if case in UNSHARDED_ONLY:
            np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
        else:
            _assert_steps(hist, [want], mine["params"], want["params"],
                          [prev_m, want["opt"]["m"]])
        # against the port's unsharded step from the same state
        prev = D["init"] if s == 0 else ref[s - 1]["params"]
        p1, m1, h1 = _unsharded_step(key, layout, accum, prev,
                                     None if s == 0 else ref[s - 1]["opt"],
                                     D["batches"][s])
        _assert_steps(hist, [dict(loss=h1[0], grad_norm=h1[1])],
                      mine["params"], _flat(p1), [prev_m, m1])
        assert mine["calls"] == mine["plan"], (mine["calls"], mine["plan"])


def test_seq_parallel_step_matches_the_step_without_it(runs):
    """The tp step with ``seq_parallel`` (L over 'model' between the
    products) against the same sharded step without it, from the same
    state (the two steps held from the reference's; dense), and one MoE
    step from the seeded init (the router on the gathered whole, its
    input gradient counted once): the same function, summed in another
    order."""
    ref, got = _get(runs, "ref", "tp-sp"), _get(runs, "held", "tp-sp")
    for s, mine in enumerate(got):
        prev_m = _zeros_like(ref[0]["opt"]["m"]) if s == 0 \
            else ref[s - 1]["opt"]["m"]
        twin = mine["no_sp"]
        _assert_steps([(mine["loss"], mine["grad_norm"], mine["lr"])],
                      [twin], mine["params"], twin["params"],
                      [prev_m, ref[s]["opt"]["m"]])
        assert "reduce_scatter" in mine["plan"], mine["plan"]
    moe = _get(runs, "free", "moe-sp")
    sp, no = moe[True], moe[False]
    zero = {k: np.zeros_like(v) for k, v in no["m"].items()}
    _assert_steps([(sp["loss"], sp["grad_norm"], sp["lr"])], [no],
                  sp["params"], no["params"], [zero, no["m"]])
    assert sp["calls"] == sp["plan"] and no["calls"] == no["plan"]
    assert "reduce_scatter" in sp["plan"]


@pytest.mark.parametrize("case", list(SERVE))
def test_sharded_serving_matches_reference(runs, case):
    """``MeshServe`` on 4 ranks (tp: attention by heads, by head_dim for
    yi-34b and for llama3-8b's kv heads on (1, 4), the FFN by width, MoE by
    experts under both dispatches, the vocabulary; musicgen's embeds;
    zamba2's Mamba2 layers and shared block and xLSTM's mLSTM and sLSTM
    blocks by heads, on (2, 2) and (1, 4); zamba2 at one row, whose shared
    cache splits its positions over 'data'; xLSTM with one head, whose
    memory splits its dhk over 'model' and whose whole n, m and sLSTM
    state hold every row of a batch split over 'data') against the
    reference's forward and decode jitted with the serving cells'
    shardings: prefill logits and each decode step's within 1e-4 (the
    reference's cache built by one-token decode over the prompt, the
    port's by the prefill), and the greedy tokens equal. Every rank holds
    its ``cache_specs`` block of every cache leaf (its block of the
    unsharded step's cache within 1e-5; zamba2 and xLSTM both steps run
    again on an fp64 copy, as their fp32 rounding is amplified), every
    weight a layer fetches is its unit's block (a split leaf's 'model'
    block, never a whole stacked leaf), and ``dist.calls`` equals the
    plan at every step."""
    ref = _get(runs, "ref", "serve-" + case)
    got = _get(runs, "free", "serve-" + case)
    np.testing.assert_allclose(got["prefill"], ref["prefill"], rtol=1e-4,
                               atol=1e-4)
    n = 0 if OVERRIDES.get(SERVE[case][0], {}).get("seq_parallel") \
        else N_DEC
    assert len(got["decode"]) == len(ref["decode"]) == n
    for s, (a, b) in enumerate(zip(got["decode"], ref["decode"])):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {s}")
    want = [np.argmax(x[:, -1], axis=-1).tolist()
            for x in [ref["prefill"]] + ref["decode"]]
    assert got["tokens"] == want
    for cerr, c_ok, f_ok, n_fetch, calls_ok, pos in got["ranks"]:
        assert cerr <= 1e-5 and c_ok and f_ok and n_fetch > 0, \
            (cerr, c_ok, f_ok, n_fetch)
        assert calls_ok and pos == L + len(got["decode"])


def test_seq_parallel_prefill_matches_the_prefill_without_it(runs):
    """The prefill with ``seq_parallel`` against the same mesh's without
    it, and the plan's reduce-scatters in place of its all-reduces."""
    sp, base = (_get(runs, "free", "serve-" + c)
                for c in ("dense-sp", "dense"))
    np.testing.assert_allclose(sp["prefill"], base["prefill"], rtol=1e-5,
                               atol=1e-5)
    assert sp["tokens"] == base["tokens"][:1]
    cfg = _port_cfg("dense-sp", "tp")
    prompt = {"tokens": torch.zeros((B, L), dtype=torch.int32)}
    ops = [e["op"] for e in train_lib.MeshServe(
        cfg, meshlib.axes(*MESH22), "prefill").plan(prompt)
        if e["what"].startswith(("sp ", "tp "))]
    assert "all_reduce" not in ops and "reduce_scatter" in ops


def test_seq_parallel_follows_the_references_constraint():
    """``seq_parallel`` acts where the reference's ``constrain_hidden``
    puts L over 'model': L a multiple of 'model' and more than 1 (decode
    never); under the fsdp layout a batch that splits over the batch axes
    splits over 'model' too, and the reference's constraint then names
    'model' twice (JAX raises ``DuplicateSpecError``), as this raises; a
    batch that does not split leaves the step as it is."""
    import dataclasses
    base = configs.smoke_config("llama3-8b")
    mesh = meshlib.axes(*MESH22)
    b = lambda n, l: {"tokens": torch.zeros((n, l), dtype=torch.int32),
                      "targets": torch.zeros((n, l), dtype=torch.int32)}
    ocfg = adamw.AdamWConfig()
    sp = train_lib.MeshStep(dataclasses.replace(base, seq_parallel=True),
                            ocfg, mesh)
    no = train_lib.MeshStep(base, ocfg, mesh)
    assert sp.plan(b(8, 31)) == no.plan(b(8, 31))      # 'model' is 2
    assert sp.plan(b(8, 32)) != no.plan(b(8, 32))
    dec = train_lib.MeshServe(dataclasses.replace(base, seq_parallel=True),
                              mesh, "decode")
    one = {"tokens": torch.zeros((8, 1), dtype=torch.int32)}
    assert dec.plan(one) == train_lib.MeshServe(base, mesh,
                                                "decode").plan(one)
    fsdp = dataclasses.replace(base, seq_parallel=True, layout="fsdp")
    step = train_lib.MeshStep(fsdp, ocfg, mesh)
    with pytest.raises(ValueError, match="name 'model' twice"):
        step.plan(b(8, 32))
    assert step.plan(b(2, 32)) == train_lib.MeshStep(
        dataclasses.replace(fsdp, seq_parallel=False), ocfg,
        mesh).plan(b(2, 32))


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_compressed_pod_step_matches_reference(runs, codec):
    """Two steps on the (2, 2, 1) pod mesh, the second from the first's
    residuals: loss and grad norm per step as the reference's; the params
    and the stacked residuals as the reference's, except where the codec
    rounds the other way. The two packages' gradients agree to rounding,
    so an element that sits on a rounding boundary of the codec may decode
    one step apart: its residual then has the other sign (r and r - step,
    with r half a step). Such elements must be rare."""
    case = f"pod-{codec}"
    ref, got = _get(runs, "ref", case), _get(runs, "held", case)
    base = _get(runs, "ref", "pod-None")
    lr_sum = 0.0
    for want, mine in zip(ref, got):
        np.testing.assert_allclose(mine["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(mine["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        assert mine["calls"] == mine["plan"], (mine["calls"], mine["plan"])
        lr_sum += mine["lr"]
        a, b = mine["params"], _flat(want["params"])
        off = sum(int((np.abs(a[k] - b[k]) > 1e-5).sum()) for k in b)
        assert off <= 1e-3 * sum(v.size for v in b.values()), off
        assert max(float(np.abs(a[k] - b[k]).max()) for k in b) \
            <= 2 * lr_sum
        for k, x in _flat(want["res"]).items():
            tol = 1e-3 * np.abs(x).max()
            same = np.abs(mine["res"][k] - x) <= tol
            flipped = np.abs(mine["res"][k] + x) <= tol
            assert (same | flipped).all(), k
            assert (~same).mean() <= 1e-3, k
    # the reference's own gates against the uncompressed step, from the
    # same state (there both calls start from the init; here the first
    # step does, the second starts from each codec's own first step)
    tol = {"bf16": 1e-2, "int8": 5e-2}[codec]
    assert abs(got[0]["loss"] - base[0]["loss"]) < tol


# ------------------------------------------------------------ inside the port
def test_fsdp_refuses_a_split_layer_dim_per_layer():
    """Where the fsdp rule splits a leaf's stacked layer dim (its largest
    dim that the batch axes divide: the smoke llama3-8b at 6 layers on a
    3-rank mesh, whose widths 3 divides nowhere, so every layer leaf
    splits its layer dim), a layer lives whole on
    one rank of the group. The per-layer gather refuses that layout with a
    ValueError that names the leaf; ``gather_params_once`` takes it, and
    plans one gather of each whole leaf."""
    import dataclasses
    cfg = dataclasses.replace(configs.smoke_config("llama3-8b"), n_layers=6,
                              layout="fsdp")
    mesh = meshlib.axes((1, 3), ("data", "model"))
    specs = train_lib.shardings_for(cfg, mesh, {})[0]
    assert all(v[0] == ("data", "model") for v in specs["layers"].values())
    with pytest.raises(ValueError, match=r"layers\.ln1 .*stacked layer dim"):
        train_lib.MeshStep(cfg, adamw.AdamWConfig(), mesh)
    step = train_lib.MeshStep(cfg, adamw.AdamWConfig(), mesh,
                              gather_params_once=True)
    b = {"tokens": torch.zeros((6, 8), dtype=torch.int32),
         "targets": torch.zeros((6, 8), dtype=torch.int32)}
    gathers = [e for e in step.plan(b) if e["what"] == "params"]
    assert all(e["calls"] == 1 for e in gathers)
    assert len(gathers) == sum(bool(shd_axes) for shd_axes in (
        [a for e in s for a in (e or ())] for s in adamw.leaves(specs)))


def test_elastic_restore_across_meshes(runs):
    """A save at step 2 on (2, 2) restored on (4, 1) and on (1, 4): one
    more step agrees with 3 straight steps on (2, 2); the saved step is
    the whole arrays, which the unsharded restore reads."""
    el = _get(runs, "free", "elastic")
    st = el["straight"]
    assert all(h["calls"] == h["plan"] for h in st["hist"])
    for shape in ("(4, 1)", "(1, 4)"):
        h = el[shape]["hist"]
        assert h[0]["calls"] == h[0]["plan"]
        _assert_steps([(h[0]["loss"], h[0]["grad_norm"], h[0]["lr"])],
                      [st["hist"][2]], el[shape]["params"], st["params"],
                      st["m"])
    assert el["saved"].keys() == st["params"].keys()


def test_train_cli_on_a_mesh_saves_and_resumes(runs):
    cli = _get(runs, "free", "cli")
    assert cli["start"] == 3 and cli["steps"] == [3, 4, 5]
    assert cli["cut"] == cli["uncut"][:3]
    assert cli["resumed"] == cli["uncut"][3:]
    for k, v in cli["uncut_params"].items():
        assert np.array_equal(v, cli["resumed_params"][k]), k
    # the same run without a mesh, within the cross-rank rounding
    one = train.main(["--arch", "llama3-8b", "--device", "cpu", "--batch",
                      "8", "--seq", "32", "--steps", "6"])
    np.testing.assert_allclose(cli["uncut"], one["loss"], rtol=1e-4)


def test_model_axis_splits_the_forward_and_its_flops(runs):
    """On (1, 4) under tp no rank's forward gets a whole leaf that the
    table splits over 'model' (embed, unembed, wq / wk / wv / wo, the
    FFN's three), and a rank's matrix-product FLOPs are at most 0.3 of
    the unsharded step's (a quarter, less the replicated norms)."""
    got = _get(runs, "free", "split")
    assert got["calls"] == got["plan"], (got["calls"], got["plan"])
    for n_fwd, n_split, n_whole, ratio in got["ranks"]:
        assert n_fwd == 1 and n_split == 9, (n_fwd, n_split)
        assert n_whole == 0
        assert 0 < ratio <= 0.3, ratio


@pytest.mark.parametrize("key,n_split,roles", [
    ("zamba", 13, {"w_in": "columns", "w_out": "heads", "a_log": "heads",
                   "dt_bias": "heads", "conv_w": "part", "ln_h": "part",
                   "wq": "heads", "wk": "heads", "wv": "heads",
                   "wo": "heads", "w_gate": "ffn", "w_up": "ffn",
                   "w_down": "ffn", "embed": "vocab", "unembed": "vocab"}),
    ("xlstm-96", 13, {
        "mlstm.w_up": "columns", "mlstm.w_down": "heads",
        "mlstm.wq": "heads", "mlstm.wk": "heads", "mlstm.wv": "heads",
        "mlstm.b_gates": "heads", "mlstm.w_gates": "part",
        "mlstm.ln_h": "part", "slstm.wx": "heads", "slstm.r": "heads",
        "slstm.bias": "part", "slstm.ln_h": "part", "slstm.w_gate": "ffn",
        "slstm.w_up": "ffn", "slstm.w_down": "ffn", "embed": "vocab",
        "unembed": "vocab"})])
def test_recurrent_model_axis_takes_table_blocks(runs, key, n_split, roles):
    """zamba2 on (1, 4) (2 Mamba heads and 1 attention head a rank,
    ``w_in``'s 74 columns) and xLSTM at d_model 96 on (2, 2) under tp:
    every weight of a split leaf that a layer's forward gets is this
    rank's table block of the whole leaf, never the whole (in the
    forward and in the remat recompute); every split leaf's gradient
    reaches its reduce as that block (no rank makes the whole fp32
    gradient); the moments the update writes are blocks. The leaves used
    in part ('part': ``conv_w``, ``ln_h``, ``w_gates``, the sLSTM
    ``bias``) come whole and their gradients are summed over 'model'."""
    got = _get(runs, "free", "split-" + key)
    assert got["calls"] == got["plan"], (got["calls"], got["plan"])
    assert got["roles"] == roles
    for n, equal, whole, paths, split, n_red, red_ok, m_ok in got["ranks"]:
        assert n > 0 and equal == n and whole == 0, (n, equal, whole)
        assert paths == split == n_split, (paths, split)
        assert n_red > 0 and red_ok == n_red and m_ok == 1


def test_per_layer_path_gathers_no_whole_stacked_leaf(runs):
    """A per-layer fsdp step under remat gathers one layer's block of each
    stacked leaf at a time, in the forward and again in the recompute,
    and never a whole stacked leaf's block."""
    got = _get(runs, "free", "layer_gathers")
    assert got["calls"] == got["plan"], (got["calls"], got["plan"])
    shapes, stacked = got["shapes"], got["stacked"]
    assert not set(shapes) & set(map(tuple, stacked))
    for leaf in stacked:
        assert shapes.count(tuple(leaf[1:])) >= 2 * got["layers"], leaf


@pytest.mark.parametrize("what", ["dense-tp", "dense-fsdp", "moe",
                                  "int8-residual", "serve", "sp",
                                  "serve-zamba", "serve-xlstm"])
def test_one_rank_mesh_is_bitwise_the_unsharded_step(runs, what):
    w1 = _get(runs, "world1", "world1")
    keys = [k for k in w1 if k.startswith(what)]
    assert keys
    for k in keys:
        assert w1[k] == dict(bitwise=True, calls=True), k
