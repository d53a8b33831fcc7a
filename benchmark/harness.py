"""The set-up of a run and the window's jobs: inputs made from the seed, the
program's run, the outputs read back off the clock (used by ``run.py`` and
``control.py``)."""

from __future__ import annotations

import os
import shutil
import traceback

import numpy as np

from . import outputs, traffic


class NoCard(SystemExit):
    """The cell needs more CUDA cards than the machine has."""


def setup(spec: dict, rehearse: dict = None) -> dict:
    """{"engine", "device", "reads_per_file", "warmup_reads",
    "check_reads_per_job", "max_jobs"} of a run of the cell ``spec``: on the
    card at the mix's sizes, with the program's kernel library loaded (built
    once into the checkout's ``build/``); or, with ``rehearse`` (those four
    sizes), on the CPU through the program's plain versions (``-engine
    torch``), for the tests.  Raises ``NoCard`` without the cards."""
    import torch

    if rehearse is not None:
        return dict({"max_jobs": None}, **rehearse, engine="torch", device=torch.device("cpu"))
    chips = spec["cell"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        raise NoCard(f"no CUDA card for {spec['cell']['name']}: needs {chips}, found {found}")
    torch.cuda.init()
    from tagdust_tpu_torch.engine import build

    build.lib()
    mix = spec["mix"]
    return {"engine": "cuda", "device": torch.device("cuda", 0),
            "reads_per_file": mix["reads_per_file"], "warmup_reads": mix["warmup_reads"],
            "check_reads_per_job": mix["check_reads_per_job"], "max_jobs": None}


def job_flags(config: dict, mix: dict, seed: int, job: int) -> list:
    """The job's ``tagdust`` flags: the mix's, a ``-seed`` of the job's own
    where the mix asks for one (``seed_per_job``), then the architecture (or
    ``-arch`` and the candidates)."""
    flags = list(mix["flags"])
    if mix.get("seed_per_job"):
        flags += ["-seed", str(traffic.job_seed(seed, job))]
    if mix.get("arch"):
        flags += ["-arch", config["candidates"]]
    else:
        for i, seg in enumerate(config["architecture"]):
            flags += [f"-{i + 1}", seg]
    return flags


class Jobs:
    """Runs jobs of one cell through ``program`` in directory ``tmp``."""

    def __init__(self, config: dict, mix: dict, program, tmp: str, n_check: int):
        self.config, self.mix, self.program = config, mix, program
        self.tmp, self.n_check = tmp, n_check
        self.written = {"inputs": 0, "outputs": 0}

    def make_input(self, seed: int, job: int, n: int) -> str:
        data = traffic.generate(n, seed, job, self.config)
        path = os.path.join(self.tmp, f"in{job + 1}.fq")
        self.written["inputs"] += traffic.write_fastq(path, data["codes"])
        return path

    def run_job(self, seed: int, job: int, path: str, n: int) -> dict:
        """One job, on the clock; a job that raises is recorded as failed."""
        outdir = os.path.join(self.tmp, f"out{job + 1}")
        os.mkdir(outdir)
        rec = {"index": job, "n": n}
        try:
            rec.update(self.program.job(path, os.path.join(outdir, outputs.PREFIX),
                                        job_flags(self.config, self.mix, seed, job)))
        except Exception as exc:  # noqa: BLE001 -- a failed job is counted, the run goes on
            traceback.print_exc()
            rec.update(error=f"{type(exc).__name__}: {exc}", wall=0.0, reads=0)
        return rec

    def finish_job(self, seed: int, rec: dict, path: str) -> None:
        """Off the clock: read back the sampled reads, delete the files."""
        outdir = os.path.join(self.tmp, f"out{rec['index'] + 1}")
        if not rec.get("error"):
            rng = traffic.rng_for(seed, rec["index"], 1)
            rec["sample"] = np.sort(rng.choice(rec["n"], min(self.n_check, rec["n"]),
                                               replace=False))
            self.written["outputs"] += sum(os.path.getsize(os.path.join(outdir, f))
                                           for f in os.listdir(outdir))
            rec["got"] = (outputs.collect(outdir, rec["sample"])
                          if outputs.output_files(outdir) else None)
            if rec["reads"] != rec["n"]:
                rec["error"] = f"the log counts {rec['reads']} reads of {rec['n']}"
        shutil.rmtree(outdir, ignore_errors=True)
        os.remove(path)

    def warm_up(self, seed: int, n: int) -> None:
        path = self.make_input(seed, traffic.WARMUP_JOB, n)
        rec = self.run_job(seed, traffic.WARMUP_JOB, path, n)
        self.finish_job(seed, rec, path)
        if rec.get("error"):
            raise RuntimeError(f"the warm-up job failed: {rec['error']}")

    def window(self, seed: int, n: int, path: str, seconds: float = None,
               max_jobs: int = None) -> list:
        """Jobs back to back from the input ``path`` of job 0 until their
        walls add up to ``seconds`` (or ``max_jobs`` have run)."""
        jobs, used = [], 0.0

        def more():
            return ((seconds is None or used < seconds)
                    and (max_jobs is None or len(jobs) < max_jobs))

        while more():
            rec = self.run_job(seed, len(jobs), path, n)
            used += rec["wall"]
            self.finish_job(seed, rec, path)
            jobs.append(rec)
            if more():
                path = self.make_input(seed, len(jobs), n)
        return jobs
