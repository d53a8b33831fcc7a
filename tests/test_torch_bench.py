"""The port's benches (``tagdust_tpu_torch/bench/``) on the CPU:

* each bench's ``main`` at a tiny size with ``--device cpu`` prints its
  JSON lines with the keys a reader of the bench takes from them (e2e:
  ``--engine torch --reads 2000 --trials 1``), the card's fields on the CPU
  being ``cpu`` and null;
* without a card and without ``--device cpu``, each bench run as a module
  exits non-zero and prints no JSON line (decided in a subprocess in which
  ``torch.cuda.is_available`` is False);
* ``bench.e2e`` refuses an engine on the wrong device, and caches its input
  whole, with its arch file beside it.
"""

import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from tagdust_tpu_torch.bench import e2e, kernels, multichip

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the plain versions run many small ops, and a
    full thread pool in each of the suite's workers oversubscribes the
    cores (the CLI tests' subprocesses get OMP_NUM_THREADS=2 for the
    same reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def lines(capsys) -> list:
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_kernels_bench_line(capsys):
    assert kernels.main(["--device", "cpu", "--batch", "32", "--len", "16",
                         "--batches", "2", "--trials", "3"]) == 0
    (rec,) = lines(capsys)
    for k in ("metric", "value", "unit", "trials", "spread_pct", "device",
              "power_limit_w"):
        assert k in rec
    assert rec["unit"] == "reads/s" and rec["trials"] == 3 and rec["value"] > 0
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert "vs_baseline" not in rec
    assert len(rec["trial_seconds"]) == 3 and rec["spread_pct"] >= 0


def test_multichip_bench_lines(capsys):
    assert multichip.main(["--device", "cpu", "--batch", "32", "--len", "16",
                           "--reps", "1", "--shards", "1,2"]) == 0
    recs = lines(capsys)
    assert [r["devices"] for r in recs] == [1, 2]
    for r in recs:
        for k in ("devices", "cards", "reads_per_s", "scaling_efficiency",
                  "device", "power_limit_w"):
            assert k in r
        assert r["cards"] == 0 and r["device"] == "cpu"
        assert "no scaling claimed" in r["note"]
    assert recs[0]["scaling_efficiency"] == 1.0


def test_e2e_bench_lines(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert e2e.main(["--device", "cpu", "--engine", "torch", "--reads", "2000",
                     "--trials", "1"]) == 0
    (rec,) = lines(capsys)
    for k in ("metric", "value", "unit", "best", "reads", "trial_seconds",
              "warmup_seconds_excluded", "stage_seconds", "detection_seconds",
              "calibration_seconds", "device", "power_limit_w"):
        assert k in rec
    assert rec["reads"] == 2000 and len(rec["trial_seconds"]) == 1
    assert set(rec["stage_seconds"]) == {"stats_prepass", "calibration",
                                         "label_extract", "parse", "write"}
    assert rec["stage_seconds"]["label_extract"] > 0
    assert "torch engine, -Q 10" in rec["metric"]
    fq = e2e.input_path(2000)
    assert os.path.dirname(fq) == str(tmp_path)
    assert os.path.exists(fq + "_tagdust_arch.txt")
    assert not [f for f in os.listdir(tmp_path) if ".part" in f]
    with open(fq) as fh:
        assert sum(1 for _ in fh) == 4 * 2000


@pytest.mark.parametrize("args", [["--engine", "torch"], ["--engine", "cuda", "--device", "cpu"],
                                  ["--engine", "both", "--device", "cpu"]],
                         ids=["torch-on-card", "cuda-on-cpu", "both-on-cpu"])
def test_e2e_bench_refuses_an_engine_on_the_wrong_device(monkeypatch, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as exc:
        e2e.main(args)
    assert exc.value.code == 2


_NO_CARD = """
import runpy, sys, torch
torch.cuda.is_available = lambda: False
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_module(sys.argv[0], run_name="__main__")
"""


@pytest.mark.parametrize("module,args", [
    ("tagdust_tpu_torch.bench.kernels", ["--batch", "32", "--len", "16"]),
    ("tagdust_tpu_torch.bench.e2e", ["--engine", "exact", "--reads", "200"]),
    ("tagdust_tpu_torch.bench.multichip", ["--batch", "32", "--shards", "1"]),
], ids=["kernels", "e2e", "multichip"])
def test_a_bench_without_a_card_exits_non_zero(module, args):
    from conftest import spawn_env

    res = subprocess.run([sys.executable, "-c", _NO_CARD, module, *args],
                         capture_output=True, text=True, cwd=_REPO,
                         env=spawn_env(rtest=False), timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
