"""The port's auxiliary tools (``tagdust_tpu_torch/cli``: ``simreads``,
``evalres``, ``merge_tool``, ``rename_qiime``) and the host cases of
``tests/test_tools.py`` on the port's CLI.

The tools are host-only copies, so each is held to the JAX package's tool
byte for byte on the same inputs (``simreads`` for the same seed and flags,
with its arch, btrim and fastx side files; ``evalres`` on the same
demultiplexed outputs), and the documented semantics are checked on the
port directly (merge consensus and low-identity rejection, QIIME renaming,
SAM input, the CLI's error paths).  Every subprocess of the port runs with
``jax`` blocked.
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RC = str.maketrans("ACGT", "TGCA")
PORT, JAX = "tagdust_tpu_torch", "tagdust_tpu"

# the port's modules run with jax unimportable
_BLOCKED = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.argv = sys.argv[1:]; "
            "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)")


def _revcomp(s: str) -> str:
    return s[::-1].translate(_RC)


def _spawn(pkg, tool, args, cwd, rtest=False):
    from conftest import spawn_env

    mod = f"{pkg}.cli.{tool}"
    head = [sys.executable, "-c", _BLOCKED, mod] if pkg == PORT else [
        sys.executable, "-m", mod]
    return subprocess.run([*head, *args], cwd=cwd, env=spawn_env(rtest=rtest),
                          capture_output=True, text=True)


def _run(pkg, tool, args, cwd, rtest=False):
    res = _spawn(pkg, tool, args, cwd, rtest)
    assert res.returncode == 0, res.stderr[-2000:]
    return res


def _pairs(cwd, n, seed, mismatch=False):
    rng = np.random.default_rng(seed)
    fulls = []
    with open(os.path.join(cwd, "r1.fq"), "w") as f1, open(
            os.path.join(cwd, "r2.fq"), "w") as f2:
        for i in range(n):
            full = "".join("ACGT"[c] for c in rng.integers(0, 4, 70))
            quals = "".join(chr(33 + int(q)) for q in rng.integers(10, 40, 70))
            cut = int(rng.integers(30, 50))
            r1, q1 = full[:cut], quals[:cut]
            r2, q2 = _revcomp(full[cut - 25:]), quals[cut - 25:][::-1]
            if mismatch and i % 3 == 0:
                r1 = r1[:10] + ("A" if r1[10] != "A" else "C") + r1[11:]
            f1.write(f"@P{i};1\n{r1}\n+\n{q1}\n")
            f2.write(f"@P{i};2\n{r2}\n+\n{q2}\n")
            fulls.append(full)
    return fulls


def test_merge_overlapping_pairs(tmp_path):
    cwd = str(tmp_path)
    rng = np.random.default_rng(3)
    fulls = ["".join("ACGT"[c] for c in rng.integers(0, 4, 60)) for _ in range(5)]
    with open(os.path.join(cwd, "r1.fq"), "w") as f1, open(
            os.path.join(cwd, "r2.fq"), "w") as f2:
        for i, full in enumerate(fulls):
            r1, r2 = full[:40], _revcomp(full[20:])  # overlap full[20:40]
            f1.write(f"@P{i};1\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@P{i};2\n{r2}\n+\n{'I' * len(r2)}\n")
    res = _run(PORT, "merge_tool", ["r1.fq", "r2.fq", "-Q", "0.9"], cwd)
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 4 * len(fulls)
    for i, full in enumerate(fulls):
        assert lines[4 * i] == f"@P{i};1"
        assert lines[4 * i + 1] == full  # perfect-overlap consensus
        assert lines[4 * i + 3] == "I" * 60


def test_merge_equals_the_jax_tool_on_noisy_pairs(tmp_path):
    cwd = str(tmp_path)
    _pairs(cwd, 120, seed=11, mismatch=True)
    args = ["r1.fq", "r2.fq", "-Q", "0.85"]
    ours = _run(PORT, "merge_tool", args, cwd).stdout
    assert ours.count("\n") > 4 * 60
    assert ours == _run(JAX, "merge_tool", args, cwd).stdout


def test_merge_rejects_low_identity(tmp_path):
    cwd = str(tmp_path)
    with open(os.path.join(cwd, "r1.fq"), "w") as f1, open(
            os.path.join(cwd, "r2.fq"), "w") as f2:
        f1.write(f"@X;1\n{'ACGT' * 15}\n+\n{'I' * 60}\n")
        f2.write(f"@X;2\n{'TTGG' * 15}\n+\n{'I' * 60}\n")
    res = _run(PORT, "merge_tool", ["r1.fq", "r2.fq", "-Q", "0.99"], cwd)
    assert res.stdout.strip() == ""


def test_rename_qiime_exact_and_mismatch(tmp_path):
    cwd = str(tmp_path)
    with open(os.path.join(cwd, "map.txt"), "w") as fh:
        fh.write("#comment line\nsampleA\tACGTAC\nsampleB\tTGCATG\n")
    with open(os.path.join(cwd, "in.fq"), "w") as fh:
        fh.write("@M01:1:XYZ:ACGTAC\nAAAACCCC\n+\nIIIIIIII\n")   # exact A
        fh.write("@M01:2:XYZ:TGCATG\nGGGGTTTT\n+\nIIIIIIII\n")   # exact B
        fh.write("@M01:3:XYZ:TGCATC\nACACACAC\n+\nIIIIIIII\n")   # 1-mismatch B
    res = _run(PORT, "rename_qiime", ["map.txt", "in.fq"], cwd)
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith(">sampleA_1 ")
    assert "orig_bc=ACGTAC new_bc=ACGTAC bc_diffs=0" in lines[0]
    assert lines[1] == "AAAACCCC"
    assert lines[2].startswith(">sampleB_1 ")
    assert lines[4].startswith(">sampleB_2 ")
    assert "bc_diffs=1" in lines[4]
    assert res.stdout == _run(JAX, "rename_qiime", ["map.txt", "in.fq"], cwd).stdout


def test_sam_input_demux(tmp_path):
    """SAM reading drops secondary (0x100) and QC-fail (0x200) records and
    demultiplexes like FASTQ input (``-Q 0`` calibrates, so the run takes
    the exact engine: the reader is what is tested)."""
    cwd = str(tmp_path)
    rows = [
        ("r1", 0, "ACAGTG" + "ACGTACGTACGTACGTACGT", 'I' * 26),
        ("r2", 256, "ACAGTG" + "AAAAAAAAAAAAAAAAAAAA", 'I' * 26),  # secondary
        ("r3", 512, "ACTTGA" + "CCCCCCCCCCCCCCCCCCCC", 'I' * 26),  # qc-fail
        ("r4", 16, "ACTTGA" + "GTGTGTGTAACCGGTTACGT", 'I' * 26),
    ]
    with open(os.path.join(cwd, "in.sam"), "w") as fh:
        fh.write("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n")
        for name, flag, seq, qual in rows:
            fh.write(f"{name}\t{flag}\tchr1\t1\t60\t26M\t*\t0\t0\t{seq}\t{qual}\n")
    _run(PORT, "tagdust",
         ["-1", "B:ACAGTG,ACTTGA", "-2", "R:N", "-Q", "0", "-seed", "42",
          "in.sam", "-o", "out", "-engine", "exact"], cwd)
    log = open(os.path.join(cwd, "out_logfile.txt")).read()
    assert "2\ttotal input reads" in log  # flags 256/512 dropped
    bc1 = open(os.path.join(cwd, "out_BC_ACAGTG.fq")).read()
    bc2 = open(os.path.join(cwd, "out_BC_ACTTGA.fq")).read()
    assert "@r1;" in bc1 and "@r4;" in bc2
    assert "r2" not in bc1 + bc2 and "r3" not in bc1 + bc2


ERRORS = {
    # skipped segment slot (-1 then -3)
    "skipped": (["-1", "B:ACGT,TGCA", "-3", "R:N"], 1,
                "building block was skipped"),
    # unequal alternative lengths in one segment
    "unequal": (["-1", "B:AC,GGG", "-2", "R:N"], 1, "same length"),
    # refuses to overwrite existing outputs
    "overwrite": (["-1", "B:ACGT,TGCA", "-2", "R:N"], None, "already exists"),
    # missing input file
    "missing": (["-1", "B:ACGT,TGCA", "-2", "R:N"], None, "does not exists"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_cli_error_paths(tmp_path, case):
    """QC and validation failures exit cleanly with the reference's
    messages, before any engine is built."""
    cwd = str(tmp_path)
    with open(os.path.join(cwd, "in.fq"), "w") as fh:
        fh.write("@a\nACGTACGT\n+\nIIIIIIII\n")
    open(os.path.join(cwd, "x_BC_ACGT.fq"), "w").close()
    arch, code, msg = ERRORS[case]
    fq = "nope.fq" if case == "missing" else "in.fq"
    out = "x" if case == "overwrite" else "y"
    r = _spawn(PORT, "tagdust",
               [*arch, "-Q", "1", fq, "-o", out, "-engine", "torch"], cwd)
    assert msg in r.stderr + r.stdout
    if code is not None:
        assert r.returncode == code and "Traceback" not in r.stderr
    elif case == "overwrite":
        assert r.returncode != 0


def _edittag(cwd):
    with open(os.path.join(cwd, "tags.txt"), "w") as fh:
        for i, bc in enumerate(["ACGTAC", "TGCATG", "CCAAGG", "GTTGCA",
                                "AAGGTT", "CTCTAG"]):
            fh.write(f"Tag{i}:{bc}\n")
    return "tags.txt"


SIM = {
    "barcodes": ["-sim_barnum", "4"],
    "linkers": ["-sim_barnum", "4", "-sim_5seq", "GGGGGGG", "-sim_3seq", "TTTTTTT"],
    "no_barcode": ["-sim_barnum", "0", "-sim_5seq", "AGGT"],
    "indels": ["-sim_barnum", "6", "-sim_InDel_frac", "0.3", "-sim_readlen_mod", "5"],
}


def _simreads(pkg, cwd, out, extra):
    _run(pkg, "simreads",
         [_edittag(cwd), "-seed", "42", *extra, "-sim_readlen", "20",
          "-sim_numseq", "500", "-sim_endloss", "0", "-sim_random_frac", "0.1",
          "-o", out, "-sim_error_rate", "0.02"], cwd, rtest=True)
    return {os.path.basename(p)[len(out):]: open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(cwd, out + "*")))}


@pytest.mark.parametrize("case", list(SIM))
def test_simreads_is_byte_equal_to_the_jax_tool(tmp_path, case):
    cwd = str(tmp_path)
    a = _simreads(JAX, cwd, "jax.fq", SIM[case])
    b = _simreads(PORT, cwd, "port.fq", SIM[case])
    assert a.keys() == b.keys() and "" in a and len(a) >= 2
    assert a[""].count(b"\n") == 4 * 500
    for k in a:
        assert a[k].replace(b"jax.fq", b"port.fq") == b[k], k


def test_simreads_tagdust_evalres_round_trip(tmp_path):
    """simreads -> tagdust -> evalres on the port's tools alone; evalres
    prints what the JAX package's prints on the same files."""
    cwd = str(tmp_path)
    _simreads(PORT, cwd, "sim.fq", SIM["barcodes"])
    _run(PORT, "tagdust", ["-seed", "42", "sim.fq", "-arch",
                           "sim.fq_tagdust_arch.txt", "-o", "bt"], cwd, rtest=True)
    outs = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(cwd, "bt*.fq")))
    assert len(outs) >= 5
    res = {}
    for pkg in (PORT, JAX):
        _run(pkg, "evalres", [*outs, "-name", f"{pkg}_run", "-sim_numseq", "500",
                              "-o", f"{pkg}_eval"], cwd, rtest=True)
        made = sorted(glob.glob(os.path.join(cwd, f"{pkg}_eval*")))
        assert made
        res[pkg] = [open(p).read().replace(f"{pkg}_run", "run") for p in made]
    assert res[PORT] == res[JAX]
    assert any(ch.isdigit() for ch in "".join(res[PORT]))
