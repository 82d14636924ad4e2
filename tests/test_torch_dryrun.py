"""The port's dry-run (``launch.dryrun``) against the JAX reference's parts
(its own dry-run reports every cell it does not skip as an error: it calls
``mesh_lib.set_mesh`` and never imports ``mesh_lib``; ROADMAP queue 3):

* the four per-cell policies on all 40 (arch x shape) cells;
* the skips, on both production meshes;
* per-device argument bytes, against a count made from the reference's
  specs and ``eval_shape`` shapes;
* ``model_flops``;
* the meta pass and the collective plan on llama3-8b x train_4k (fsdp,
  accum 1), yi-34b x train_4k (tp, accum 16: the 'model' axis splits its
  products, the plan's tensor-parallel collectives, a split rank's
  FLOPs), phi3.5-moe x prefill_32k
  (einsum dispatch), zamba2-1.2b x train_4k (tp: its Mamba layers and
  shared block split over 'model', the plan's collectives, a split rank's
  FLOPs), zamba2-1.2b and xlstm-125m x long_500k; the FLOPs'
  extrapolation from 1 and 2 repeat units against a direct full-depth
  pass; the CLI on one cell;
* the serving cells priced from ``MeshServe.plan`` and a rank's blocks
  (llama3-8b x prefill_32k / decode_32k, phi3.5-moe x decode_32k and
  zamba2-1.2b's and xlstm-125m's prefill_32k, decode_32k and long_500k
  against the whole-parameter gathers they were priced by before), each
  transformer serving cell's meta pass and zamba2's prefill's, and a
  ``seq_parallel`` override's own collectives.
"""
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.models.api import build as jbuild

from repro_torch import configs
from repro_torch.launch import dryrun, train_lib
from repro_torch.launch.mesh import production_axes

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in configs.ARCH_IDS for s in configs.SHAPES]


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported for its policies: its
    first line sets ``XLA_FLAGS`` to 512 host devices, which is put back
    at once (this process's JAX is already up, and the tests' other
    subprocesses must not inherit it)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


def _fake(shape, names):
    class M:
        axis_names = names

        class devices:
            pass
    M.devices.shape = shape
    return M


def test_policies_and_skips_match_reference(jdry):
    assert len(CELLS) == 40
    for arch, sname in CELLS:
        cfg, jcfg = configs.full_config(arch), jconfigs.full_config(arch)
        shape, jshape = configs.SHAPES[sname], jconfigs.SHAPES[sname]
        assert dryrun._layout_for(cfg, shape) == jdry._layout_for(jcfg,
                                                                  jshape)
        assert dryrun._moe_impl_for(cfg, shape) == jdry._moe_impl_for(
            jcfg, jshape)
        assert dryrun._accum_for(cfg, shape) == jdry._accum_for(jcfg, jshape)
        assert dryrun._unit_layers(cfg) == jdry._unit_layers(jcfg)
        ok = jconfigs.applicable(jcfg, jshape)[0]
        for mp in (False, True):
            rec = dryrun.run_cell(arch, sname, mp, verbose=False,
                                  cost_tier=False)
            assert rec["status"] == ("ok" if ok else "skip"), (arch, sname)
            if ok:
                assert rec["accum_steps"] == jdry._accum_for(jcfg, jshape)
                assert rec["layout"] == jdry._layout_for(jcfg, jshape)


def _ref_bytes(shapes, specs, sizes) -> int:
    """Per-device bytes of a tree from the reference's specs."""
    total = 0
    leaves = jax.tree_util.tree_leaves(shapes)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for i, e in enumerate(spec):
            axs = e if isinstance(e, tuple) else (() if e is None else (e,))
            n = math.prod(sizes[a] for a in axs)
            assert shape[i] % n == 0
            shape[i] //= n
        total += math.prod(shape) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_argument_bytes_match_a_count_from_reference_specs(jdry, arch):
    jcfg = jconfigs.full_config(arch)
    p = jax.eval_shape(lambda k: jbuild(jcfg).init(jcfg, k),
                       jax.random.PRNGKey(0))
    for sname in configs.SHAPES:
        jshape = jconfigs.SHAPES[sname]
        if not jconfigs.applicable(jcfg, jshape)[0]:
            continue
        cell = dataclasses.replace(jcfg, layout=jdry._layout_for(jcfg,
                                                                  jshape))
        for mp, (shape, names) in MESHES.items():
            fake, sizes = _fake(shape, names), dict(zip(names, shape))
            ps = jshd.param_specs(p, fake, cell.layout)
            want = {"params": _ref_bytes(p, ps, sizes)}
            b = jconfigs.input_specs(cell, jshape)
            want["batch"] = _ref_bytes(b, jshd.batch_specs(b, fake,
                                                           cell.layout),
                                       sizes)
            if jshape.kind == "train":   # fp32 m and v, an int32 step
                f32 = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
                    x.shape, np.float32), p)
                want["opt"] = 2 * _ref_bytes(f32, ps, sizes) + 4
            if jshape.kind == "decode":
                c = jax.eval_shape(lambda: jbuild(cell).init_cache(
                    cell, jshape.global_batch, jshape.seq_len))
                want["cache"] = _ref_bytes(c, jshd.cache_specs(c, fake),
                                           sizes)
            rec = dryrun.run_cell(arch, sname, mp, verbose=False,
                                  cost_tier=False)
            assert rec["argument_bytes"] == want, (sname, mp)
            assert rec["memory"]["argument_size_in_bytes"] == sum(
                want.values())


def test_model_flops_match_reference():
    for arch, sname in CELLS:
        jcfg, jshape = jconfigs.full_config(arch), jconfigs.SHAPES[sname]
        tokens = jshape.global_batch * (jshape.seq_len
                                        if jshape.kind != "decode" else 1)
        want = (6.0 if jshape.kind == "train" else 2.0) \
            * jcfg.active_params() * tokens
        assert dryrun.model_flops(configs.full_config(arch),
                                  configs.SHAPES[sname]) == want


def _leaf_bytes(arch, dtype_bytes):
    cfg = configs.full_config(arch)
    return cfg, sum(math.prod(x.shape) * dtype_bytes
                    for x in train_lib.MeshStep(
                        cfg, dryrun.adamw.AdamWConfig(),
                        production_axes()).shapes)


def test_train_cell_llama3_fsdp_prices_its_plan():
    rec = dryrun.run_cell("llama3-8b", "train_4k", False, verbose=False)
    assert rec["status"] == "ok" and rec["layout"] == "fsdp"
    assert rec["accum_steps"] == 1 and rec["local_rows"] == 1
    cfg, whole = _leaf_bytes("llama3-8b", 4)
    # every leaf splits one dim over all 256 ranks: one all-gather of each
    # layer's bf16 block in the forward and again in the remat recompute
    # (of each top-level leaf's once) and one reduce-scatter of each
    # layer's fp32 gradient a step, then the target counts, the metrics
    # and the norm
    step = train_lib.MeshStep(cfg, dryrun.adamw.AdamWConfig(),
                              production_axes())
    stacked = sum(u.lead > 0 for u in step.units)
    top = len(step.shapes) - stacked
    L = cfg.n_layers
    assert (stacked, top) == (9, 3)
    assert rec["collectives"]["counts"] == {
        "all_gather": 2 * L * stacked + top,
        "reduce_scatter": L * stacked + top, "all_reduce": 3}
    assert rec["collectives"]["bytes"]["reduce_scatter"] == whole
    layers = sum(2 * math.prod(x.shape) // 256
                 for x, u in zip(step.shapes, step.units) if u.lead)
    assert rec["collectives"]["bytes"]["all_gather"] == \
        rec["argument_bytes"]["params"] + layers
    assert rec["link_bytes_per_chip"] > whole * 255 / 256
    assert rec["flops_global"] > rec["model_flops"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    for k in ("t_compute_s", "t_memory_s", "t_collective_s"):
        assert rec[k] > 0
    assert rec["hbm_bytes_global"] is None and rec["source"] == "shapes"


@pytest.mark.parametrize("once", [False, True])
def test_per_layer_plan_gathers_each_layer_and_its_recompute(once):
    """llama3-8b x train_4k on 16x16 (fsdp, remat full): per microbatch
    the per-layer plan gathers each stacked leaf n_layers x (1 + remat)
    times, one layer's block a call, and each top-level leaf once, and
    reduces each layer's gradient once; ``gather_params_once`` keeps one
    gather and one reduce of each whole leaf a step."""
    cfg, shape = dryrun.cell_config("llama3-8b", "train_4k")
    assert cfg.remat == "full" and cfg.layout == "fsdp"
    step = train_lib.MeshStep(cfg, dryrun.adamw.AdamWConfig(),
                              production_axes(), gather_params_once=once)
    plan = step.plan(configs.input_specs(cfg, shape))
    gathers = [e for e in plan if e["what"] == "params"]
    reduces = [e for e in plan if e["what"] == "grads"]
    assert len(gathers) == len(reduces) == len(step.shapes) == 12
    for g, r, x, u in zip(gathers, reduces, step.shapes, step.units):
        assert (g["op"], g["axes"], r["op"]) == \
            ("all_gather", ("data", "model"), "reduce_scatter")
        n = 1 if once else u.count
        assert g["calls"] == (1 if once else n * u.passes)
        assert u.passes == (2 if u.lead else 1)
        assert r["calls"] == n
        assert g["bytes"] * 256 * n == math.prod(x.shape) * 2
        assert r["bytes"] * n == math.prod(x.shape) * 4


def test_train_cell_yi34b_tp_accumulates_16():
    rec = dryrun.run_cell("yi-34b", "train_4k", False, verbose=False)
    assert (rec["layout"], rec["accum_steps"]) == ("tp", 16)
    assert rec["local_rows"] == 1
    # the 'model' axis splits the products; what stays above the model's
    # FLOPs is remat's recompute and the attention, which runs whole on
    # every rank (56 heads do not split 16 ways: q, k and v are split by
    # head_dim and gathered), masked half included on meta
    assert 1 < rec["flops_global"] / rec["model_flops"] < 5
    # params are gathered once a microbatch, the grads reduced once a
    # microbatch (gather_params_once off)
    counts = rec["collectives"]["counts"]
    assert counts["all_gather"] % 16 == 0 and counts["reduce_scatter"] % 16 \
        == 0


def test_yi34b_plan_lists_the_model_axis_collectives():
    """The tp step's 'model' collectives a step of yi-34b x train_4k on
    16x16 (accum 16, 1 row a rank, remat full): per layer and microbatch
    the attention input's gradient, q / k / v gathered over head_dim
    (forward and recompute) and reduce-scattered back, the attention's and
    the FFN's reduce (the attention's again in the recompute) and the
    FFN input's gradient; the embedding, the logits' input gradient and
    the cross-entropy's max and sums once a microbatch."""
    cfg, shape = dryrun.cell_config("yi-34b", "train_4k")
    step = train_lib.MeshStep(cfg, dryrun.adamw.AdamWConfig(),
                              production_axes(), accum_steps=16)
    plan = step.plan(configs.input_specs(cfg, shape))
    tp = {e["what"]: e for e in plan if e["axes"] == ("model",)}
    L, A, S, d = cfg.n_layers, 16, shape.seq_len, cfg.d_model
    act = S * d * 2
    want = {"tp embedding": ("all_reduce", act, A),
            "tp attention input grads": ("all_reduce", act, A * L),
            "tp attention": ("all_reduce", act, A * L * 2),
            "tp ffn input grads": ("all_reduce", act, A * L),
            "tp ffn": ("all_reduce", act, A * L),
            "tp logits input grads": ("all_reduce", act, A),
            "tp ce max": ("all_reduce", S * 4, A),
            "tp ce sums": ("all_reduce", 2 * S * 4, A)}
    for n, heads in (("q", 56), ("k", 8), ("v", 8)):
        whole = S * heads * cfg.hd * 2
        want[f"tp {n} head_dim"] = ("all_gather", whole // 16, A * L * 2)
        want[f"tp {n} head_dim grads"] = ("reduce_scatter", whole, A * L)
    assert {k: (e["op"], e["bytes"], e["calls"]) for k, e in tp.items()} \
        == want
    assert all(e["group"] == 16 for e in tp.values())
    # no parameter all-gather over 'model' but the norms' (replicated)
    gathered = {e["axes"] for e in plan if e["what"] == "params"}
    assert gathered == {("data",)}


def test_zamba2_plan_splits_its_mamba_layers_and_shared_block():
    """zamba2-1.2b x train_4k on 16x16 (accum 8, 2 rows a rank, remat
    full): each Mamba layer's 'model' collectives a microbatch — the
    input's gradient, the in-projection gathered (forward and recompute)
    and reduce-scattered back, the gated norm's sum of squares (forward,
    recompute and backward), the out-projection's reduce after the remat
    block; the shared block's as a dense layer's, once a group (it runs
    outside remat); the vocabulary's once. Only ``conv_w`` gathers over
    'model' (whole, 2 passes a layer), and its gradient and ``ln_h``'s are
    summed over 'model'."""
    cfg, shape = dryrun.cell_config("zamba2-1.2b", "train_4k")
    A = dryrun._accum_for(cfg, shape)
    step = train_lib.MeshStep(cfg, dryrun.adamw.AdamWConfig(),
                              production_axes(), accum_steps=A)
    plan = step.plan(configs.input_specs(cfg, shape))
    L, G, S, d = cfg.n_layers, cfg.n_layers // cfg.attn_every, \
        shape.seq_len, cfg.d_model
    tok = shape.global_batch // A // 16 * S
    act, width, di = tok * d * 2, 2 * 2 * d + 2 * 64 + 64, 2 * d
    want = {"tp embedding": ("all_reduce", act, A),
            "tp attention input grads": ("all_reduce", act, A * G),
            "tp attention": ("all_reduce", act, A * G),
            "tp ffn input grads": ("all_reduce", act, A * G),
            "tp ffn": ("all_reduce", act, A * G),
            "tp mamba input grads": ("all_reduce", act, A * L),
            "tp mamba in-projection": ("all_gather", tok * width // 16 * 2,
                                       A * L * 2),
            "tp mamba in-projection grads": ("reduce_scatter",
                                             tok * width * 2, A * L),
            "tp mamba norm": ("all_reduce", tok * 4, A * L * 2),
            "tp mamba norm grads": ("all_reduce", tok * 4, A * L),
            "tp mamba": ("all_reduce", act, A * L),
            "tp logits input grads": ("all_reduce", act, A),
            "tp ce max": ("all_reduce", tok * 4, A),
            "tp ce sums": ("all_reduce", 2 * tok * 4, A)}
    tp = {e["what"]: e for e in plan if e["axes"] == ("model",)
          and e["what"].startswith("tp ")}
    assert {k: (e["op"], e["bytes"], e["calls"]) for k, e in tp.items()} \
        == want
    whole = [e for e in plan if e["what"] == "params"
             and "model" in e["axes"]]
    assert {(e["axes"], e["bytes"]) for e in whole} == {
        (("model",), 4 * (di + 2 * 64) // 16 * 2)}
    assert sum(e["calls"] for e in whole) == A * L * 2
    conv = [e for e in plan if e["what"] == "grads"
            and e["axes"] == ("model",)]
    assert conv and all(e["op"] == "reduce_scatter" for e in conv)
    ln_h = [e for e in plan if e["what"] == "grads"
            and e["axes"] == ("data", "model") and e["bytes"] == di * 4]
    assert sum(e["calls"] for e in ln_h) == A * L


def test_meta_pass_counts_a_split_zamba2_ranks_flops():
    """One group of zamba2-1.2b (6 Mamba layers and the shared block)
    under tp on 16x16: a rank's meta pass counts a sixteenth of the
    unsharded pass's products, a little over with the replicated norms,
    the whole B and C of its convs and the gathered in-projection."""
    cfg, shape = dryrun.cell_config("zamba2-1.2b", "train_4k",
                                    {"n_layers": 6})
    shape = dataclasses.replace(shape, seq_len=cfg.chunk)
    split = dryrun.meta_flops(cfg, shape, 1, production_axes())
    whole = dryrun.meta_flops(cfg, shape, 1)
    assert whole / 16 <= split <= 0.07 * whole, split / whole


@pytest.mark.parametrize("arch,layout,most", [
    ("llama3-8b", "tp", 1 / 16), ("phi3.5-moe-42b-a6.6b", "tp", 0.07),
    ("yi-34b", "tp", 0.15)])
def test_meta_pass_counts_a_split_ranks_flops(arch, layout, most):
    """A train cell's meta pass with the mesh counts one rank's split
    products: a sixteenth of the unsharded pass where every product
    splits (llama3-8b forced to tp), a little over with the replicated
    router (phi3.5-moe), and over that where the attention runs whole
    (yi-34b)."""
    cfg, shape = dryrun.cell_config(arch, "train_4k",
                                    {"n_layers": 1, "layout": layout})
    split = dryrun.meta_flops(cfg, shape, 1, production_axes())
    whole = dryrun.meta_flops(cfg, shape, 1)
    assert whole / 16 <= split <= most * whole, split / whole


def test_prefill_cell_moe_runs_einsum_dispatch():
    cfg, _ = dryrun.cell_config("phi3.5-moe-42b-a6.6b", "prefill_32k")
    assert cfg.moe_impl == "einsum"
    rec = dryrun.run_cell("phi3.5-moe-42b-a6.6b", "prefill_32k", False,
                          verbose=False)
    assert rec["status"] == "ok" and rec["flops_global"] > rec["model_flops"]
    # the per-layer gathers of the parameters, and the split attention's,
    # FFN's and embedding's all-reduces over 'model'
    assert set(rec["collectives"]["counts"]) == {"all_gather", "all_reduce"}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_long_500k_runs_subquadratic_archs_only(arch):
    rec = dryrun.run_cell(arch, "long_500k", False, verbose=False)
    assert rec["status"] == "ok" and rec["local_rows"] == 1
    assert rec["argument_bytes"]["cache"] > 0
    skip = dryrun.run_cell("llama3-8b", "long_500k", False, verbose=False)
    assert skip["status"] == "skip" and "quadratic" in skip["reason"]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama3-8b"])
def test_extrapolated_flops_equal_a_full_depth_pass(arch):
    """The 1- and 2-unit extrapolation (with zamba2's 2-layer tail) is
    exact: one decode step of the full-depth model on meta counts the
    same."""
    mesh = production_axes()
    cfg, shape = dryrun.cell_config(arch, "decode_32k")
    rows = dryrun.local_rows(cfg, shape, mesh, 1)
    got = dryrun.flops_extrapolated(arch, "decode_32k", mesh, 1, rows)
    assert got == dryrun.meta_flops(cfg, shape, rows, mesh) * mesh.size


def test_cli_writes_the_records(tmp_path):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--both-meshes", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "ok"), ("2x16x16", "ok")]
    assert "t_compute_s" in recs[0] and "t_compute_s" not in recs[1]


# (cell, the parent's link GiB a chip and useful ratio, priced by one
# gather of every whole parameter with every rank running the whole model)
BEFORE = {("llama3-8b", "prefill_32k"): (14.899, 0.03),
          ("llama3-8b", "decode_32k"): (14.899, 0.03),
          ("phi3.5-moe-42b-a6.6b", "decode_32k"): (77.685, 0.01)}


@pytest.mark.parametrize("arch,shape", list(BEFORE))
def test_serving_cells_price_the_sharded_serving_step(arch, shape):
    """A transformer serving cell on 16x16 is priced from ``MeshServe``:
    its plan is the serving step's (a layer's 'data' blocks gathered as
    it runs, a split leaf's 'model' block kept; no whole-parameter
    gather), its FLOPs a rank's split products, and its argument bytes
    the specs' blocks as before. The decode cells' link bytes a chip fall
    far below the whole gather's; the prefill's rise (each layer's two
    all-reduces of the activations over 'model', 512 MiB each at 2 x
    32,768 tokens), while its roofline time falls from the whole model's
    compute on every rank. Every cell's useful ratio rises."""
    link0, useful0 = BEFORE[(arch, shape)]
    rec = dryrun.run_cell(arch, shape, False, verbose=False)
    cfg, sh = dryrun.cell_config(arch, shape)
    mesh = production_axes()
    serve = train_lib.MeshServe(cfg, mesh, sh.kind)
    plan = dryrun.collective_plan(cfg, sh, mesh, 1)
    assert plan == serve.plan(configs.input_specs(cfg, sh),
                              pos=sh.seq_len - 1 if sh.kind == "decode"
                              else 0)
    params = [e for e in plan if e["what"] == "params"]
    assert params == serve.gather_plan(1, per_layer=True, remat=False)
    assert params != serve.gather_plan(whole=True)
    assert all("model" not in e["axes"] for e in params)
    whole = sum(x.numel() * x.dtype.itemsize for x in serve.shapes)
    gathered = sum(e["bytes"] * e["group"] * e["calls"] for e in params)
    assert gathered < whole / 8
    assert rec["argument_bytes"] == dryrun.argument_bytes(cfg, sh, mesh)
    assert rec["useful_ratio"] > 4 * useful0
    t = max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"])
    link = rec["link_bytes_per_chip"] / 2**30
    if sh.kind == "decode":
        assert link < link0 / 4, link
    else:
        assert link > link0 and t < 0.1 * rec["t_compute_s"] * 16, link


def test_a_seq_parallel_override_prices_its_own_collectives():
    """``overrides={'seq_parallel': True}`` on llama3-8b x prefill_32k: the
    plan's all-reduces over 'model' become reduce-scatters, each with an
    all-gather of a rank's block of L (ring bytes unchanged); a train cell
    under tp gains them in the backward too; the fsdp train cell, whose
    batch splits over 'model', raises as the reference's constraint does."""
    base = dryrun.run_cell("llama3-8b", "prefill_32k", False, verbose=False,
                           cost_tier=False)
    sp = dryrun.run_cell("llama3-8b", "prefill_32k", False, verbose=False,
                         cost_tier=False, overrides={"seq_parallel": True})
    c0, c1 = base["collectives"]["counts"], sp["collectives"]["counts"]
    assert "reduce_scatter" not in c0 and "all_reduce" not in c1
    assert c1["reduce_scatter"] == c0["all_reduce"]
    assert c1["all_gather"] == c0["all_gather"] + c0["all_reduce"]
    assert sp["link_bytes_per_chip"] == pytest.approx(
        base["link_bytes_per_chip"], rel=1e-12)
    tp = dryrun.run_cell("llama3-8b", "train_4k", False, verbose=False,
                         cost_tier=False,
                         overrides={"seq_parallel": True, "layout": "tp"})
    assert tp["collectives"]["counts"]["reduce_scatter"] > 0
    with pytest.raises(ValueError, match="name 'model' twice"):
        dryrun.run_cell("llama3-8b", "train_4k", False, verbose=False,
                        cost_tier=False, overrides={"seq_parallel": True})


# (cell, the parent's link GiB a chip, priced by one gather of every whole
# parameter with every rank running the whole model); the most of it a
# decode cell's may be now (xlstm-125m's mLSTM runs whole, its weights
# gathered over 'model'); the serving step's collectives its plan must list
RECURRENT = {
    ("zamba2-1.2b", "prefill_32k"): (2.171, None, {"tp mamba in-projection",
                                                   "tp attention"}),
    ("zamba2-1.2b", "decode_32k"): (2.171, 1 / 4, {"tp g_conv blocks",
                                                   "tp mamba", "tp ffn"}),
    ("zamba2-1.2b", "long_500k"): (2.171, 1 / 4, {"tp t_conv blocks",
                                                  "seq ak maxima",
                                                  "seq ak sums"}),
    ("xlstm-125m", "prefill_32k"): (0.360, None, {"tp slstm ffn"}),
    ("xlstm-125m", "decode_32k"): (0.360, 0.7, {"tp m_C dhk readout",
                                                "rows of m_n", "rows of m_m",
                                                "rows of s_state"}),
    ("xlstm-125m", "long_500k"): (0.360, 0.7, {"tp slstm ffn"})}


@pytest.mark.parametrize("arch,shape", list(RECURRENT))
def test_recurrent_serving_cells_price_the_sharded_serving_step(arch, shape):
    """zamba2's and xLSTM's serving cells on 16x16 (and 2x16x16) are
    priced from ``MeshServe.plan``: a layer's 'data' blocks gathered as it
    runs, no gather of a whole parameter (over 'model' only the leaves the
    step runs whole: ``conv_w``, xlstm-125m's mLSTM and sLSTM, whose 4
    heads 16 does not divide; never a split leaf), and the step's own
    collectives: the Mamba2 layers' and the shared block's under tp, a
    decode's conv-state blocks gathered over 'model', long_500k's shared
    cache combined over 'data' (its positions split there), xlstm-125m's
    memory C split by dhk (4 heads on 16) with its readout summed and its
    whole n, m and sLSTM state's rows gathered. A decode cell's links a
    chip fall: zamba2's below a quarter of the whole gather's, xLSTM's
    less (its mLSTM weights gathered over 'model')."""
    link0, most, whats = RECURRENT[(arch, shape)]
    cfg, sh = dryrun.cell_config(arch, shape)
    for mp in (False, True):
        rec = dryrun.run_cell(arch, shape, mp, verbose=False,
                              cost_tier=False)
        assert rec["status"] == "ok", rec
        mesh = production_axes(multi_pod=mp)
        serve = train_lib.MeshServe(cfg, mesh, sh.kind)
        plan = dryrun.collective_plan(cfg, sh, mesh, 1)
        assert plan == serve.plan(configs.input_specs(cfg, sh),
                                  pos=sh.seq_len - 1 if sh.kind == "decode"
                                  else 0)
        params = [e for e in plan if e["what"] == "params"]
        assert params == serve.gather_plan(1, per_layer=True, remat=False)
        whole = serve.gather_plan(whole=True)
        assert plan != whole
        over = lambda es: sum(e["bytes"] * e["group"] * e["calls"]
                              for e in es if "model" in e["axes"])
        assert over(params) < over(whole)
        assert whats <= {e["what"] for e in plan}, sorted(
            {e["what"] for e in plan})
        if most is not None:
            assert rec["link_bytes_per_chip"] / 2**30 < most * link0, rec[
                "link_bytes_per_chip"]


def test_meta_pass_counts_a_zamba2_serving_ranks_flops():
    """One group of zamba2-1.2b (6 Mamba layers and the shared block) x
    prefill_32k on 16x16: a rank's meta pass counts about a sixteenth of
    the unsharded pass (its Mamba heads and attention heads)."""
    cfg, shape = dryrun.cell_config("zamba2-1.2b", "prefill_32k",
                                    {"n_layers": 6})
    mesh = production_axes()
    rows = dryrun.local_rows(cfg, shape, mesh, 1)
    split = dryrun.meta_flops(cfg, shape, rows, mesh)
    whole = dryrun.meta_flops(cfg, shape, rows)
    assert whole / 16 <= split <= whole / 8, split / whole


SERVING = [(a, s) for a in configs.ARCH_IDS
           if configs.full_config(a).family not in ("ssm", "hybrid")
           for s in ("prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", SERVING)
def test_every_transformer_serving_cell_prices_on_the_mesh(arch, shape):
    """Every prefill and decode cell of the transformer families runs its
    meta pass on a rank's blocks and its plan on the single-pod mesh; the
    multi-pod mesh's plan too. A rank's FLOPs are about a sixteenth of
    the whole model's in decode; in prefill up to ~0.4 where the heads do
    not divide 'model' (R16: the 32k-token attention runs whole)."""
    rec = dryrun.run_cell(arch, shape, False, verbose=False)
    assert rec["status"] == "ok", rec
    assert 0 < rec["useful_ratio"] <= 1.0
    cfg, sh = dryrun.cell_config(arch, shape, {"n_layers": 1})
    whole = dryrun.meta_flops(cfg, sh, rec["local_rows"])
    split = dryrun.meta_flops(cfg, sh, rec["local_rows"], production_axes())
    assert split < (whole / 8 if sh.kind == "decode" else whole / 2)
    assert dryrun.run_cell(arch, shape, True, verbose=False,
                           cost_tier=False)["status"] == "ok"
