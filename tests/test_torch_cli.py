"""The port's command lines on the CPU (``--device cpu``, small scales):
``launch.svm_train``, ``launch.svm_serve`` and ``launch.serve --svm``.

* a training run prints the iterations, SVs and verdict of the port's
  library fit of the same config, and holds the outcome contract against
  the reference CLI's printed verdict and test accuracy;
* one-vs-rest (covtype) and a C grid print the same lines through the
  batched driver and its loop oracle (the reference's CLI-level parity
  check); the grid's objectives agree with the reference CLI's;
* ``--chaos kill@I --ckpt-dir d`` dies, and ``--resume`` prints the uncut
  run's line;
* ``--devices 2`` under ``torchrun`` (two gloo processes, started once for
  the module) prints the single-process fit's iterations and SVs;
* serving with ``--compact --dtype bfloat16 --roofline --json-out`` writes
  the reference report's keys.
"""
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import svm_serve as jserve
from repro.launch import svm_train as jtrain

from repro_torch.core import SMOSolver, SVMConfig
from repro_torch.data import SPECS, make
from repro_torch.launch import chaos, serve, svm_serve, svm_train

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300          # seconds, for the torchrun group
A9A = ["--dataset", "a9a", "--scale", "0.02"]
DIST = ["--dataset", "a9a", "--scale", "0.01"]


def run(main, argv, capsys) -> list:
    """The printed lines of one in-process CLI run."""
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


def ref_run(mod, argv, capsys, monkeypatch) -> list:
    """The reference CLI's printed lines (it reads ``sys.argv``)."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    return run(lambda _: mod.main(), None, capsys)


def fields(line: str) -> dict:
    return dict(re.findall(r"(\w+)=([^\s]+)", line))


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def torchrun():
    """``--devices 2`` under torchrun, started before the module's first
    test so the group trains while they run; the test that reads it waits
    (``TIMEOUT``), and a group still running at the end is killed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(free_port()), "-m", "repro_torch.launch.svm_train", *DIST,
         "--device", "cpu", "--devices", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_train_prints_the_library_fit_and_holds_the_reference_outcome(
        capsys, monkeypatch):
    got = run(svm_train.main, A9A + ["--device", "cpu"], capsys)
    head, acc = fields(got[0]), float(got[1].split(": ")[1])
    X, y, Xt, yt = make("a9a", scale=0.02, seed=0)
    spec = SPECS["a9a"]
    m = SMOSolver(SVMConfig(C=spec.C, sigma2=spec.sigma2,
                            heuristic="multi5pc", device="cpu")).fit(X, y)
    assert got[0].startswith("a9a/multi5pc: ")
    assert (head["iters"], head["nsv"], head["conv"]) == (
        str(m.stats.iterations), str(m.stats.n_sv), str(m.stats.converged))
    assert got[1] == f"test acc: {(m.predict(Xt) == yt).mean():.4f}"
    want = ref_run(jtrain, A9A, capsys, monkeypatch)
    assert fields(want[0])["conv"] == head["conv"] == "True"
    # predicted labels agree on >= 99.5% of the test rows
    assert abs(acc - float(want[1].split(": ")[1])) <= 0.005


def test_ovr_batched_and_loop_print_the_same_run(capsys):
    argv = ["--dataset", "covtype", "--scale", "0.001", "--device", "cpu"]
    batched = run(svm_train.main, argv, capsys)
    loop = run(svm_train.main, argv + ["--multi-backend", "loop"], capsys)
    assert batched[0].startswith("covtype/ovr7/batched: ")
    assert loop[0].startswith("covtype/ovr7/loop: ")
    # nsv differs by design, as in the reference: the batched line counts
    # SVs over the problems, the loop line its first problem's
    assert fields(batched[0])["iters"] == fields(loop[0])["iters"]
    assert batched[1] == loop[1] and batched[1].startswith("test acc: ")


def test_grid_c_lines_match_loop_and_reference(capsys, monkeypatch):
    argv = ["--dataset", "a7a", "--scale", "0.01", "--grid-c", "1,8"]
    batched = run(svm_train.main, argv + ["--device", "cpu"], capsys)
    loop = run(svm_train.main, argv + ["--device", "cpu", "--multi-backend",
                                       "loop"], capsys)
    assert batched == loop and len(batched) == 2
    want = ref_run(jtrain, argv, capsys, monkeypatch)
    for g, w in zip(batched, want):
        assert g.split(":")[0] == w.split(":")[0]      # a7a/C=1, a7a/C=8
        go, wo = float(fields(g)["obj"]), float(fields(w)["obj"])
        assert abs(go - wo) <= 5e-4 * abs(wo)


def test_chaos_kill_then_resume_prints_the_uncut_run(tmp_path, capsys):
    base = A9A + ["--device", "cpu", "--chunk-iters", "64"]
    uncut = fields(run(svm_train.main, base, capsys)[0])
    d = str(tmp_path / "ckpt")
    with pytest.raises(chaos.InjectedKill):
        svm_train.main(base + ["--ckpt-dir", d, "--chaos", "kill@20"])
    assert chaos._PLAN is None               # the plan was scoped to the run
    assert os.listdir(d)
    got = fields(run(svm_train.main, base + ["--ckpt-dir", d, "--resume"],
                     capsys)[0])
    assert (got["iters"], got["nsv"], got["conv"]) == (
        uncut["iters"], uncut["nsv"], uncut["conv"])


def test_parallel_outside_torchrun_names_torchrun():
    with pytest.raises(ValueError, match="torchrun"):
        svm_train.main(A9A + ["--device", "cpu", "--devices", "2"])


def test_serve_bf16_compact_roofline_report_keys(tmp_path, capsys,
                                                  monkeypatch):
    out = tmp_path / "port.json"
    argv = A9A + ["--compact", "--dtype", "bfloat16", "--roofline",
                  "--repeats", "3", "--batch", "100"]
    lines = run(serve.main, ["--svm", "--device", "cpu", *argv,
                             "--json-out", str(out)], capsys)
    assert lines[0].startswith("engine: ") and "'bfloat16'" in lines[0]
    assert [ln.split(" ")[0] for ln in lines[1:]] == [
        "batch=100:", "test", "roofline:", "wrote"]
    port = json.loads(out.read_text())
    ref_out = tmp_path / "ref.json"
    ref_run(jserve, argv + ["--json-out", str(ref_out)], capsys, monkeypatch)
    ref = json.loads(ref_out.read_text())
    assert sorted(port) == sorted(ref)
    assert sorted(port["roofline"]) == sorted(ref["roofline"])
    assert port["engine"]["dtype"] == ref["engine"]["dtype"] == "bfloat16"
    assert port["p50_s"] > 0 and port["qps"] > 0
    rf = port["roofline"]
    assert rf["t_compute_s"] > 0 and rf["t_memory_s"] > 0
    assert rf["t_collective_s"] == 0 and rf["dominant"] == "compute"
    # the library call the CLI makes, keyword for keyword
    rep = svm_serve.main(["--device", "cpu", *argv])
    assert rep["engine"]["n_sv"] == port["engine"]["n_sv"]


def test_devices_2_under_torchrun_prints_the_single_fit(torchrun, capsys):
    single = fields(run(svm_train.main, DIST + ["--device", "cpu"],
                        capsys)[0])
    out, err = torchrun.communicate(timeout=TIMEOUT)
    assert torchrun.returncode == 0, err[-3000:]
    lines = [ln for ln in out.splitlines() if ln.startswith("a9a/")]
    assert len(lines) == 1                   # rank 0 prints, rank 1 not
    got = fields(lines[0])
    assert got["conv"] == single["conv"] == "True"
    assert (got["iters"], got["nsv"]) == (single["iters"], single["nsv"])
    assert "test acc: " in out
