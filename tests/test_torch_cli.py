"""The port's CLI against the JAX CLI, on the CPU.

The port runs in a subprocess with ``jax`` blocked (``sys.modules["jax"] =
None`` before any import), so the test also proves that the port's main
path, ``-arch`` detection included, imports no JAX and no module of the JAX
package.  It labels through the streaming decided mode on CPU
tensors (``-engine torch``: the plain versions of the kernels); the JAX CLI
runs ``-engine tpu`` on its XLA scan engine.  Every demultiplexed file must
be byte-identical.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tagdust_tpu.arch import build_read_structure
from tagdust_tpu.logsum import p2sp
from tagdust_tpu.model import init_model_bag
from tagdust_tpu.stats import SequenceStats

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARCODES = ["ACGTAC", "TGCATG", "CCAAGG", "GTTGCA"]
ARCHS = {
    "barcode": ["-1", f"B:{','.join(BARCODES)}", "-2", "R:N"],
    "fingerprint": ["-1", f"B:{','.join(BARCODES)}", "-2", "F:NNNN", "-3", "R:N"],
    # -arch detection over the two architectures above and R:N
    "detect": ["-arch", "{arch_file}"],
}
ARCH_FILE = "".join(
    f"tagdust {' '.join(ARCHS[a])}\n" for a in ("fingerprint", "barcode")
) + "tagdust -1 R:N\n"

_PORT_RUNNER = """
import json, sys
sys.modules["jax"] = None
from tagdust_tpu_torch.cli.tagdust import main
from tagdust_tpu_torch.engine import fused_kernel, runner, scan
main(sys.argv[1:])
assert not any(m == "tagdust_tpu" or m.startswith("tagdust_tpu.") for m in sys.modules)
print(json.dumps({"windows": runner.STREAM_STATS["windows"],
                  "plain_cuda": scan.PLAIN_CUDA_CALLS["count"]}))
"""


def write_fastq(path: str, n: int, seed: int) -> None:
    """Reads of one barcode plus a random insert (with substitutions in the
    barcode), and a tenth of fully random reads."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as fh:
        for i in range(n):
            ins = "".join(rng.choice(list("ACGT"), int(rng.integers(20, 44))))
            if rng.random() < 0.9:
                bc = list(BARCODES[int(rng.integers(len(BARCODES)))])
                for k in range(len(bc)):
                    if rng.random() < 0.05:
                        bc[k] = "ACGT"[int(rng.integers(4))]
                seq = "".join(bc) + ins
            else:
                seq = ins
            fh.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def _env(**extra):
    from conftest import spawn_env

    return spawn_env(rtest=False, **extra)


def _outputs(prefix: str) -> dict:
    out = {}
    for p in sorted(glob.glob(prefix + "*.fq")):
        with open(p, "rb") as fh:
            out[os.path.basename(p)[len(os.path.basename(prefix)):]] = fh.read()
    return out


@pytest.mark.parametrize("arch,window", [
    ("barcode", 64), ("fingerprint", 64),
    ("barcode", 100000),  # one window: the one-shot labelling path
    ("detect", 64),
])
def test_cli_torch_matches_jax_cli(tmp_path, arch, window):
    fq = str(tmp_path / "in.fq")
    write_fastq(fq, 600, seed=7)
    arch_file = tmp_path / "arch.txt"
    arch_file.write_text(ARCH_FILE)
    jax_out = str(tmp_path / "jax")
    port_out = str(tmp_path / "port")
    common = [a.format(arch_file=arch_file) for a in ARCHS[arch]] + [fq, "-Q", "10"]
    subprocess.run(
        [sys.executable, "-m", "tagdust_tpu.cli.tagdust", *common, "-o",
         jax_out, "-engine", "tpu"],
        check=True, capture_output=True, cwd=_REPO,
        env=_env(TAGDUST_TPU_PALLAS="0", TAGDUST_TPU_STRICT="1",
                 TAGDUST_TPU_MESH="0"),
    )
    res = subprocess.run(
        [sys.executable, "-c", _PORT_RUNNER, *common, "-o", port_out,
         "-engine", "torch"],
        check=True, capture_output=True, text=True, cwd=_REPO,
        env=_env(TAGDUST_TPU_BT="8", TAGDUST_TPU_WINDOW=str(window)),
    )
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert (stats["windows"] >= 3) if window < 600 else (stats["windows"] == 0)
    assert stats["plain_cuda"] == 0
    a, b = _outputs(jax_out), _outputs(port_out)
    assert a.keys() == b.keys() and any(k.startswith("_BC_") for k in a)
    assert "_un.fq" in a
    for k in a:
        assert a[k] == b[k], k


def _calib_model():
    rs = build_read_structure([f"B:{','.join(BARCODES)}", "R:N"])
    ssi = SequenceStats()
    ssi.average_length = 40
    ssi.max_seq_len = 64
    ssi.background = [float(p2sp(p)) for p in (0.27, 0.24, 0.26, 0.22, 0.01)]
    ssi.mean_5_len = ssi.stdev_5_len = -1.0
    ssi.mean_3_len = ssi.stdev_3_len = -1.0
    return init_model_bag(rs, ssi, 0.05, 0.1)


def test_calibration_scores_match_jax(monkeypatch):
    """run_get_prob over emitted calibration reads: the port's device-kind
    scorer against the JAX device scorer, Q within 1e-2."""
    from tagdust_tpu.engine import runner as jax_runner
    from tagdust_tpu.engine.native import FlatModel

    from tagdust_tpu_torch.engine import runner as port_runner

    monkeypatch.setenv("TAGDUST_TPU_PALLAS", "0")
    monkeypatch.setenv("TAGDUST_TPU_MESH", "0")
    mb = _calib_model()
    flat = FlatModel(mb)
    state, seqs = flat.emit_read_batch(12345, 40, 1000)
    _, rnd = flat.emit_random_batch(state, 40, 1000)
    seqs = list(seqs) + list(rnd)
    assert len(seqs) == 2000
    q_jax = jax_runner.run_get_prob(mb, seqs, engine_kind="tpu")
    q_port = port_runner.run_get_prob(mb, seqs, engine_kind="torch")
    np.testing.assert_array_equal(np.isfinite(q_jax), np.isfinite(q_port))
    # Q within 1e-2 up to 20, the largest threshold calibration can select
    # (calibrate.py returns at most 20).  Above it p_wrong = 1 - exp(d) is
    # small and its cancellation turns f32 ulps of the scores into a
    # relative error of Q: there hold Q within rtol 2e-3.
    low = np.isfinite(q_jax) & (q_jax <= 20.0)
    high = np.isfinite(q_jax) & (q_jax > 20.0)
    assert low.sum() > 1000
    np.testing.assert_allclose(q_port[low], q_jax[low], atol=1e-2)
    np.testing.assert_allclose(q_port[high], q_jax[high], rtol=2e-3)


def test_profile_writes_a_torch_trace(tmp_path):
    from tagdust_tpu_torch.cli.tagdust import main

    fq = str(tmp_path / "in.fq")
    write_fastq(fq, 200, seed=1)
    prof = tmp_path / "prof"
    main([*ARCHS["barcode"], fq, "-Q", "10", "-o", str(tmp_path / "o"),
          "-engine", "torch", "-profile", str(prof)])
    assert (prof / "trace.json").stat().st_size > 0
    assert (tmp_path / "o_un.fq").exists()
    names = {ev.get("name") for ev in json.loads((prof / "trace.json").read_text())
             ["traceEvents"]}
    assert {"tagdust.runner.label", "tagdust.controller.model_build"} <= names

