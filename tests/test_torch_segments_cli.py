"""CLI parity of the port on the segment grammar and the filters.

The scenarios of ``tests/test_segment_types.py`` (``F:`` UMI with numeric
and ``-show_finger_seq`` headers, ``G:`` + ``S:``, ``O:``) and of
``tests/test_filters_e2e.py`` (``-ref`` + DUST on ``R:N``), all with
per-run calibration (no ``-Q``):

* under the port's ``-rtest`` (the exact engine) against the same MD5s,
  which come from runs verified byte-identical against the reference C
  build;
* under ``-engine torch`` (the streaming windows, the plain versions of the
  kernels, the plain Myers lanes) against the JAX CLI's ``-engine tpu`` on
  its XLA scan engine: the same files, every record's name, barcode,
  fingerprint, sequence and qualities byte for byte, the log's counts
  included; the header's ``RQ:`` (Q printed with two decimals) may differ
  by one step of 0.01 on under 1% of the records, since the two engines sum
  their f32 scores in another order (the kernels' tolerance on Q is 1e-2).

The port's subprocesses run with ``jax`` blocked.
"""

import hashlib
import os
import random
import re
import subprocess
import sys

import pytest

from test_filters_e2e import EXPECTED as REF_EXPECTED
from test_filters_e2e import _make_inputs as _ref_inputs
from test_segment_types import _umi_input

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the test workers share the cores: the port's small runs take two threads
FEW_THREADS = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2"}

_PORT = ("import sys; sys.modules['jax'] = None; "
         "from tagdust_tpu_torch.cli.tagdust import main; main(sys.argv[1:])")


def _gs_input(cwd):
    random.seed(31)
    with open(os.path.join(cwd, "in.fq"), "w") as f:
        for i in range(2000):
            bc = random.choice(["ACGTAC", "TGCATG"])
            g = "G" * random.choice([1, 1, 1, 2])
            read = "".join(random.choice("ACGT") for _ in range(22))
            seq = g + bc + "TATA" + read
            f.write(f"@READ{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    with open(os.path.join(cwd, "arch.txt"), "w") as f:
        f.write("tagdust -1 G:G -2 B:ACGTAC,TGCATG -3 S:TATA -4 R:N in.fq -o out.fq\n")


def _opt_input(cwd):
    random.seed(33)
    with open(os.path.join(cwd, "in.fq"), "w") as f:
        for i in range(1500):
            opt = "".join(
                random.choice("ACGT") for _ in range(random.choice([0, 1, 2, 3])))
            bc = random.choice(["ACGTAC", "TGCATG"])
            read = "".join(random.choice("ACGT") for _ in range(20))
            f.write(f"@READ{i}\n{opt}{bc}{read}\n+\n{'I' * (len(opt) + 26)}\n")
    with open(os.path.join(cwd, "arch.txt"), "w") as f:
        f.write("tagdust -1 O:N -2 B:ACGTAC,TGCATG -3 R:N in.fq -o out.fq\n")


# name -> (input maker, extra flags, {output file: MD5}, log lines)
CASES = {
    "umi": (_umi_input, [],
            {"out_BC_ACGTAC.fq": "52bbdd6a248794e4d75dc2db32ea7fa4"}, ()),
    "umi_show_finger_seq": (
        _umi_input, ["-show_finger_seq"],
        {"out_BC_ACGTAC.fq": "7e2ddbd2a32c6fce3254511d75603979"}, ()),
    "g_and_spacer": (
        _gs_input, [],
        {"out_BC_ACGTAC.fq": "39e51de640b806f8ac1d4b54a934e72a",
         "out_un.fq": "3af419d89064e306a419be78c5549f25"}, ()),
    "optional": (_opt_input, [],
                 {"out_BC_ACGTAC.fq": "f5dd6987c8ea2be38f025eafb1cdb424"}, ()),
    "ref_and_dust": (_ref_inputs, ["-ref", "contam.fa"], REF_EXPECTED,
                     ("143\tmatch artifacts:", "143\tadapter1")),
}


def _run(head, cwd, extra, out, env):
    res = subprocess.run(
        [*head, "-seed", "42", *extra, "in.fq", "-arch", "arch.txt", "-o", out],
        cwd=cwd, env=env, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-2000:]


def _files(cwd, out):
    return {f[len(out):]: open(os.path.join(cwd, f), "rb").read()
            for f in sorted(os.listdir(cwd))
            if f.startswith(out) and f.endswith(".fq")}


_RQ = re.compile(rb";RQ:(-?[0-9.]+|nan|inf)")


def _same_but_rq(a: bytes, b: bytes) -> int:
    """Asserts two FASTQ files equal but for ``RQ:`` values one step of the
    two-decimal print apart; returns how many records differ so."""
    if a == b:
        return 0
    la, lb = a.split(b"\n"), b.split(b"\n")
    assert len(la) == len(lb)
    n = 0
    for x, y in zip(la, lb):
        if x == y:
            continue
        assert _RQ.sub(b";RQ:", x) == _RQ.sub(b";RQ:", y), (x, y)
        qa, qb = float(_RQ.search(x).group(1)), float(_RQ.search(y).group(1))
        assert abs(qa - qb) <= 0.0101, (x, y)
        n += 1
    return n


def _log_counts(cwd, out):
    """The log's count lines, without their time stamps."""
    with open(os.path.join(cwd, f"{out}_logfile.txt")) as fh:
        return [ln.split("\t", 1)[-1] for ln in fh
                if "\t" in ln and ln.split("\t")[1].strip().isdigit()]


@pytest.mark.parametrize("case", list(CASES))
def test_port_rtest_reproduces_the_reference_md5s(tmp_path, case):
    from conftest import spawn_env

    make, extra, expected, log_lines = CASES[case]
    cwd = str(tmp_path)
    make(cwd)
    _run([sys.executable, "-c", _PORT], cwd, extra, "out", spawn_env(**FEW_THREADS))
    for name, md5 in expected.items():
        h = hashlib.md5(open(os.path.join(cwd, name), "rb").read()).hexdigest()
        assert h == md5, f"{name}: {h} != {md5}"
    log = open(os.path.join(cwd, "out_logfile.txt")).read()
    for ln in log_lines:
        assert ln in log


@pytest.mark.parametrize("case", list(CASES))
def test_port_engine_torch_gives_the_jax_cli_bytes(tmp_path, case):
    from conftest import spawn_env

    make, extra, expected, log_lines = CASES[case]
    cwd = str(tmp_path)
    make(cwd)
    _run([sys.executable, "-m", "tagdust_tpu.cli.tagdust"], cwd,
         [*extra, "-engine", "tpu"], "jax",
         spawn_env(TAGDUST_TPU_PALLAS="0", TAGDUST_TPU_STRICT="1",
                   TAGDUST_TPU_MESH="0"))
    _run([sys.executable, "-c", _PORT], cwd, [*extra, "-engine", "torch"], "port",
         spawn_env(TAGDUST_TPU_BT="8", TAGDUST_TPU_WINDOW="256", **FEW_THREADS))
    a, b = _files(cwd, "jax"), _files(cwd, "port")
    assert a.keys() == b.keys() and len(a) >= 2
    apart = sum(_same_but_rq(a[k], b[k]) for k in a)
    assert apart <= 0.01 * sum(v.count(b"\n") for v in a.values()) / 4
    assert _log_counts(cwd, "jax") == _log_counts(cwd, "port")
    log = open(os.path.join(cwd, "port_logfile.txt")).read()
    for ln in log_lines:
        assert ln in log

