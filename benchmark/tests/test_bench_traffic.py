"""The traffic generator and the reading back of outputs."""

import json
import os

import numpy as np
import pytest

from benchmark import outputs, traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", ["grid48x6nt", "plate96x8nt"])
def test_same_seed_and_job_give_the_same_bytes(tmp_path, name):
    cfg = config(name)
    a, b = tmp_path / "a.fq", tmp_path / "b.fq"
    traffic.write_fastq(str(a), traffic.generate(3000, 2**31 + 17, 4, cfg)["codes"])
    traffic.write_fastq(str(b), traffic.generate(3000, 2**31 + 17, 4, cfg)["codes"])
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("name", ["grid48x6nt", "plate96x8nt"])
def test_each_job_and_seed_has_reads_of_its_own(name):
    cfg = config(name)
    x = traffic.generate(2000, 5, 0, cfg)["codes"]
    assert not np.array_equal(x, traffic.generate(2000, 5, 1, cfg)["codes"])
    assert not np.array_equal(x, traffic.generate(2000, 6, 0, cfg)["codes"])
    assert not np.array_equal(x, traffic.generate(2000, 5, traffic.WARMUP_JOB, cfg)["codes"])


@pytest.mark.parametrize("name", ["grid48x6nt", "plate96x8nt"])
def test_every_read_has_the_configured_length(tmp_path, name):
    cfg = config(name)
    d = traffic.generate(5000, 11, 2, cfg)
    L = cfg["read_length"]
    assert d["codes"].shape == (5000, L) and (d["lens"] == L).all()
    assert d["codes"].max() <= 3
    path = tmp_path / "x.fq"
    traffic.write_fastq(str(path), d["codes"], block=777)
    lines = path.read_bytes().split(b"\n")[:-1]
    assert len(lines) == 4 * 5000
    assert all(len(s) == L for s in lines[1::4]) and all(len(q) == L for q in lines[3::4])
    assert lines[4 * 1234] == b"@r0000001234"


def test_reads_carry_their_barcodes():
    cfg = config("grid48x6nt")
    d = traffic.generate(20000, 3, 0, cfg)
    alpha = "ACGT"
    head = ["".join(alpha[c] for c in row[:6]) for row in d["codes"][:2000]]
    truth = d["truth"][:2000]
    hits = [h == cfg["barcodes"][t] for h, t in zip(head, truth) if t >= 0]
    # 2% substitutions a base: about 0.98**6 = 88.6% of barcodes intact
    assert 0.85 < np.mean(hits) < 0.92
    assert 0.08 < np.mean(d["truth"] < 0) < 0.12


def test_outputs_are_found_by_name(tmp_path):
    recs = {"BC_ACGTAC": [3, 7], "un": [5]}
    for label, idx in recs.items():
        with open(tmp_path / f"out_{label}.fq", "wb") as fh:
            for i in idx:
                fh.write(b"@r%010d;RQ:1.50\nACGT\n+\nIIII\n" % i)
    (tmp_path / "out_logfile.txt").write_text("log")
    got = outputs.collect(str(tmp_path), np.array([3, 5, 9]))
    assert got == {3: [("BC_ACGTAC", b"@r0000000003;RQ:1.50", b"ACGT")],
                   5: [("un", b"@r0000000005;RQ:1.50", b"ACGT")]}


def test_a_calibrating_job_passes_a_seed_of_its_own():
    """The ``calibrated`` mix gives each job the ``-seed`` that the reference
    emits its first reads from (``check.reference_job``)."""
    from benchmark.harness import job_flags

    with open(os.path.join(HERE, "mixes", "calibrated.json")) as fh:
        mix = json.load(fh)
    cfg = config("grid48x6nt")
    seed = 2**31 + 3
    flags = [job_flags(cfg, mix, seed, job) for job in (-1, 0, 1, 2)]
    seeds = [int(f[f.index("-seed") + 1]) for f in flags]
    assert seeds == [traffic.job_seed(seed, job) for job in (-1, 0, 1, 2)]
    assert len(set(seeds)) == 4 and all(0 < s < 2**31 for s in seeds)
    assert job_flags(cfg, mix, seed, 1) == flags[2]
    fixed = job_flags(cfg, dict(mix, seed_per_job=False), seed, 1)
    assert "-seed" not in fixed
