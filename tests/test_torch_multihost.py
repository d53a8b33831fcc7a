"""``tagdust_tpu_torch -multihost`` over ``torch.distributed`` (gloo), on the
CPU: two coordinated processes on 127.0.0.1, each run under
``communicate(timeout=...)``.

* over 2,000 generated reads of the 4-barcode library of
  ``tests/test_torch_cli.py`` (``-engine torch``, ``-Q 10``,
  ``TAGDUST_TPU_CHUNK=1000``: two chunks, one per host), with the
  architecture given and with ``-arch`` detection (on host 0, broadcast):
  the merged files equal a single-process run's byte for byte, no shard or
  sidecar is left, host 1 fully parses under 60% of the records, and both
  logfiles report the global totals and the single run's threshold;
* host 0 failing inside ``_once_on_host0``: host 1 logs "host 0 failed"
  and both exit with 1;
* a peer that dies, or stalls, before the shard barrier: every process
  ends in ``SystemExit(1)`` naming the barrier within
  ``TAGDUST_TPU_BARRIER_TIMEOUT_S``;
* ``global_counter_sum`` past int32 and ``broadcast_obj`` of a dict;
* ``init_multihost`` is idempotent and refuses a world size other than
  the one asked for;
* ``chip_smoke.py``'s multihost phase rehearses on the CPU (``-engine
  torch``, 3,000 reads, chunks of 1,500).
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from test_torch_cli import ARCH_FILE, ARCHS, _REPO, write_fastq

N_READS = 2000
TIMEOUT = 300


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    from conftest import spawn_env

    # two processes on one host: two intra-op threads each, not a full set
    # each (oversubscribed, the plain versions ran 15x slower)
    return spawn_env(rtest=False, OMP_NUM_THREADS=2, **extra)


# runs the port's CLI; with a third argument on host 0, a stats pass that
# raises (a failure inside _once_on_host0)
_CLI = """
import sys
sys.modules["jax"] = None
from tagdust_tpu_torch import controller
from tagdust_tpu_torch.cli.tagdust import main
args = sys.argv[1:]
if "--fail-on-host0" in args:
    args.remove("--fail-on-host0")
    if args[args.index("-procid") + 1] == "0":
        def boom(*a, **k):
            raise RuntimeError("injected stats failure")
        controller.get_sequence_stats = boom
main(args)
"""


def _spawn(cmd, cwd, env):
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _two_hosts(cwd, common, out, env, extra=()):
    port = _free_port()
    procs = [
        _spawn([sys.executable, "-c", _CLI, *common, "-o", out, "-multihost",
                "-coordinator", f"127.0.0.1:{port}", "-nprocs", "2",
                "-procid", str(pid), *extra], cwd, env)
        for pid in range(2)
    ]
    res = []
    for p in procs:
        out_, err = p.communicate(timeout=TIMEOUT)
        res.append((p.returncode, err))
    return res


def _summary(path: str) -> dict:
    keys = ("total input reads", "selected threshold", "successfully extracted",
            "problems with architecture", "barcode / UMI not found",
            "low complexity", "match artifacts:")
    out = {}
    with open(path) as fh:
        for line in fh:
            for key in keys:
                if line.rstrip("\n").endswith("\t" + key):
                    out[key] = line.split("]", 1)[1].strip().split("\t")[0]
    return out


@pytest.mark.parametrize("arch", ["barcode", "detect"])
def test_two_processes_write_the_single_run_bytes(tmp_path, arch):
    cwd = str(tmp_path)
    write_fastq(os.path.join(cwd, "in.fq"), N_READS, seed=13)
    with open(os.path.join(cwd, "arch.txt"), "w") as fh:
        fh.write(ARCH_FILE)
    common = ["in.fq", *[a.format(arch_file="arch.txt") for a in ARCHS[arch]],
              "-Q", "10", "-engine", "torch"]
    env = _env(TAGDUST_TPU_IO_STATS="1", TAGDUST_TPU_CHUNK="1000")
    single = _spawn([sys.executable, "-c", _CLI, *common, "-o", "single"], cwd, env)
    _, err = single.communicate(timeout=TIMEOUT)
    assert single.returncode == 0, err[-2000:]
    for rc, err in _two_hosts(cwd, common, "multi", env):
        assert rc == 0, err[-2000:]

    files = sorted(f for f in os.listdir(cwd)
                   if f.startswith("single_") and f.endswith(".fq"))
    assert len(files) >= 2
    for f in files:
        merged = os.path.join(cwd, "multi" + f[len("single"):])
        with open(os.path.join(cwd, f), "rb") as a, open(merged, "rb") as b:
            assert a.read() == b.read(), f
    left = [f for f in os.listdir(cwd) if f.startswith(("multi.h0", "multi.h1"))
            and not f.endswith(("_logfile.txt", ".iostats.json"))]
    assert not left, left
    with open(os.path.join(cwd, "multi.h1.iostats.json")) as fh:
        io = json.load(fh)
    assert io["parsed"] + io["skipped"] == N_READS
    assert io["parsed"] < 0.6 * N_READS
    want = _summary(os.path.join(cwd, "single_logfile.txt"))
    assert want["total input reads"] == str(N_READS)
    assert _summary(os.path.join(cwd, "multi_logfile.txt")) == want
    assert _summary(os.path.join(cwd, "multi.h1_logfile.txt")) == want
    if arch == "detect":
        # detection ran on host 0 alone and host 1 received its winner
        logs = {}
        for f in ("multi_logfile.txt", "multi.h1_logfile.txt"):
            with open(os.path.join(cwd, f)) as fh:
                logs[f] = "Searching for best architecture" in fh.read()
        assert logs == {"multi_logfile.txt": True, "multi.h1_logfile.txt": False}


def test_a_host0_failure_ends_every_process(tmp_path):
    cwd = str(tmp_path)
    write_fastq(os.path.join(cwd, "in.fq"), 200, seed=3)
    common = ["in.fq", *ARCHS["barcode"], "-Q", "10", "-engine", "torch"]
    t0 = time.monotonic()
    (rc0, err0), (rc1, err1) = _two_hosts(
        cwd, common, "multi", _env(TAGDUST_TPU_BARRIER_TIMEOUT_S="60"),
        extra=["--fail-on-host0"])
    assert time.monotonic() - t0 < 60
    assert rc0 == 1 and "injected stats failure" in err0
    assert rc1 == 1, err1[-2000:]
    with open(os.path.join(cwd, "multi.h1_logfile.txt")) as fh:
        assert "host 0 failed: RuntimeError: injected stats failure" in fh.read()


_PEER = """
import os, sys, time
from tagdust_tpu_torch.parallel import multihost
port, pid, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
multihost.init_multihost(f"127.0.0.1:{port}", 2, pid)
if pid == 1:
    if mode == "dies":
        os._exit(3)
    time.sleep(3 * multihost.barrier_timeout_s())
multihost.merge_output_shards("out", pid, 2)
"""


@pytest.mark.parametrize("mode", ["dies", "stalls"])
def test_a_missing_peer_fails_the_barrier(tmp_path, mode):
    port = _free_port()
    env = _env(TAGDUST_TPU_BARRIER_TIMEOUT_S="4")
    t0 = time.monotonic()
    procs = [_spawn([sys.executable, "-c", _PEER, str(port), str(p), mode],
                    str(tmp_path), env) for p in range(2)]
    err0, err1 = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    rc0, rc1 = procs[0].returncode, procs[1].returncode
    assert rc0 == 1, err0[-2000:]
    assert "cross-host barrier 'tagdust:shards-written' failed after 4s" in err0
    # the stalled peer reaches the barrier after host 0 has gone: it fails too
    assert rc1 == (3 if mode == "dies" else 1), err1[-2000:]
    assert time.monotonic() - t0 < 60


_COLLECTIVES = """
import json, sys
from tagdust_tpu_torch.parallel.multihost import (
    broadcast_obj, global_counter_sum, init_multihost)
port, pid = sys.argv[1], int(sys.argv[2])
assert init_multihost(f"127.0.0.1:{port}", 2, pid) == (pid, 2)
assert init_multihost(f"127.0.0.1:{port}", 2, pid) == (pid, 2)  # idempotent
sums = global_counter_sum({"reads": 3_000_000_001, "host": pid})
obj = broadcast_obj({"thr": [12.5, 0.0], "arch": "B:ACGTAC"} if pid == 0 else None,
                    pid == 0)
print(json.dumps({"sums": sums, "obj": obj}))
"""


def test_counter_sum_past_int32_and_broadcast(tmp_path):
    port = _free_port()
    procs = [_spawn([sys.executable, "-c", _COLLECTIVES, str(port), str(p)],
                    str(tmp_path), _env()) for p in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, err[-2000:]
        got = json.loads(out.strip().splitlines()[-1])
        assert got["sums"] == {"reads": 6_000_000_002, "host": 1}
        assert got["obj"] == {"thr": [12.5, 0.0], "arch": "B:ACGTAC"}


_WORLD = """
import sys
from tagdust_tpu_torch.parallel.multihost import init_multihost
assert init_multihost() == (0, 1)  # env://: MASTER_ADDR, RANK, WORLD_SIZE
assert init_multihost() == (0, 1)
init_multihost(num_processes=2)
"""


def test_a_world_size_other_than_asked_is_refused(tmp_path):
    env = _env(MASTER_ADDR="127.0.0.1", MASTER_PORT=_free_port(), RANK=0,
               WORLD_SIZE=1)
    p = _spawn([sys.executable, "-c", _WORLD], str(tmp_path), env)
    _, err = p.communicate(timeout=TIMEOUT)
    assert p.returncode == 1
    assert "requested 2 processes but the process group has 1" in err
    p = _spawn([sys.executable, "-c", "from tagdust_tpu_torch.parallel.multihost "
                "import init_multihost; init_multihost('127.0.0.1:1', None, 0)"],
               str(tmp_path), _env())
    _, err = p.communicate(timeout=TIMEOUT)
    assert p.returncode == 1 and "-coordinator needs -nprocs and -procid" in err


def test_chip_smoke_multihost_phase_rehearses_on_the_cpu(tmp_path, monkeypatch):
    """The phase's children, merge, logfile and parse checks, with the
    flagship phase's command on ``-engine torch`` (no card, no launches)."""
    import chip_smoke as cs

    for k, v in dict(TAGDUST_TPU_CHUNK="1500", TAGDUST_TPU_BT="8",
                     TAGDUST_TPU_WINDOW="256", OMP_NUM_THREADS="2").items():
        monkeypatch.setenv(k, v)
    tmp = str(tmp_path)
    bcs = cs.barcode_sets()["8"]
    fq = os.path.join(tmp, "flagship.fq")
    truth = cs.write_fastq(fq, 3000, 0, bcs)
    args = ["-1", f"B:{','.join(bcs)}", "-2", "R:N", fq, "-engine", "torch",
            "-Q", "10", "-seed", "1"]
    out = os.path.join(tmp, "flagship_out")
    single = {"fq": fq, "out": out, "truth": truth, "args": args,
              "wall_s": cs.run_tagdust(args + ["-o", out])}
    res = cs.phase_multihost(single, tmp)
    assert [h["io"]["parsed"] for h in res["hosts"]] == [1500, 1500]
    assert min(h["stream"]["windows"] for h in res["hosts"]) >= 3
    # a merged file that differs fails the phase
    with open(out + "_un.fq", "ab") as fh:
        fh.write(b"@x\nA\n+\nI\n")
    with pytest.raises(SystemExit, match="differs from the single-process"):
        cs.same_outputs("multihost", out, os.path.join(tmp, "mh_out"))
