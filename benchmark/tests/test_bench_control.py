"""The comparison that decides ``correct`` fails what it has to fail.

* The control, the reference with its products' operands rounded to TF32
  in the program's place, reads over the limit where the program reads
  under it (at a small size on the CPU; on the card ``control.py`` at the
  cell's size).
* Runs of ``run.py`` with the timed path broken underneath come out not
  correct: an answer altered where it is produced (the barcodes of the
  labelled reads), half of each batch left out by the writer, and a step
  that leaves its state as it was (the traceback's labels never set)."""

import json

import numpy as np
import pytest
import torch

from benchmark import control, run

TINY = {"reads_per_file": 500, "warmup_reads": 300, "check_reads_per_job": 400,
        "max_jobs": 1}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_control_fails_where_the_program_passes():
    limits = run.cell_spec("grid48.fixedq")["limits"]
    rows = control.readings("grid48.fixedq", [2**31 + 1, 77], 1, rehearse=TINY)
    for row in rows:
        assert row["program"]["reads_apart_pct"] <= limits["reads_apart_pct"]
        assert row["control"]["reads_apart_pct"] > limits["reads_apart_pct"]


def _altered_barcodes(fn):
    def wrapped(mb, rs, batch, *a, **k):
        fn(mb, rs, batch, *a, **k)
        ok = batch.barcode >= 0
        batch.barcode[ok] = (batch.barcode[ok] + 1) % 48
    return wrapped


def _half_written(fn):
    def wrapped(self, batches, numseq):
        h = numseq // 2
        return fn(self, [b.slice(0, h) for b in batches], h)
    return wrapped


def _unchanged_labels(fn):
    def wrapped(path, dpfin):
        out = fn(path, dpfin)
        return torch.zeros_like(out)
    return wrapped


FAULTS = {
    "answer_altered": ("tagdust_tpu_torch.controller", "run_get_label_batch",
                       _altered_barcodes),
    "half_left_out": ("tagdust_tpu_torch.io.writer", "DemuxWriter.write_batch_columnar",
                      _half_written),
    "state_unchanged": ("tagdust_tpu_torch.engine.scan", "traceback", _unchanged_labels),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, fault):
    import importlib

    modname, attr, breaker = FAULTS[fault]
    obj = importlib.import_module(modname)
    *owners, name = attr.split(".")
    for o in owners:
        obj = getattr(obj, o)
    monkeypatch.setattr(obj, name, breaker(getattr(obj, name)))
    rc = run.main(["--workload", "grid48.fixedq", "--seed", "123", "--seconds", "1"],
                  rehearse=TINY)
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False
    assert res["checks"]["reads_apart_pct"]["value"] > res["checks"]["reads_apart_pct"]["limit"]
    assert np.isfinite(res["checks"]["reads_apart_pct"]["value"])
