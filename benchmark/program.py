"""The system under test: one ``tagdust`` job of ``tagdust_tpu_torch``.

``Program.job`` is what ``tagdust``'s ``main`` does with its arguments: it
parses them (``config.parse_args``) and calls
``controller.hmm_controller_multiple``; the job's wall runs from that call
to its return, with the output files closed.

Around the calls into the program's layers the benchmark puts its own
spans (``trace.Spans``): ``detection`` (``controller.test_architectures``),
``stats`` (``controller.get_sequence_stats``), ``calibration``
(``controller.estimate_q_threshold``), ``label``
(``controller.run_get_label_batch``) and ``write``
(``DemuxWriter.write_batch_columnar``, the writer thread).  The wrappers
also keep what the check compares: the threshold calibration returned, the
read structure detection returned, and the reads calibration emitted and
scored (``controller.run_get_prob``).  ``close`` puts the program's own
functions back.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .trace import Spans


class Program:
    def __init__(self, engine: str, traced: bool):
        from tagdust_tpu_torch import controller as ctl
        from tagdust_tpu_torch.config import parse_args
        from tagdust_tpu_torch.io.writer import DemuxWriter

        self.ctl, self.parse_args, self.engine = ctl, parse_args, engine
        self.spans = Spans(traced)
        self.seen: dict = {}

        def keep(key):
            def on_return(out, a, k):
                self.seen[key] = out
            return on_return

        def keep_emitted(out, a, k):
            self.seen["emitted"] = a[1]

        wrap = self.spans.wrap
        self._saved = [(ctl, n, getattr(ctl, n)) for n in (
            "test_architectures", "get_sequence_stats", "estimate_q_threshold",
            "run_get_label_batch", "run_get_prob")]
        self._saved.append((DemuxWriter, "write_batch_columnar",
                            DemuxWriter.write_batch_columnar))
        ctl.test_architectures = wrap("detection", ctl.test_architectures, keep("arch"))
        ctl.get_sequence_stats = wrap("stats", ctl.get_sequence_stats)
        ctl.estimate_q_threshold = wrap("calibration", ctl.estimate_q_threshold,
                                        keep("threshold"))
        ctl.run_get_label_batch = wrap("label", ctl.run_get_label_batch)
        ctl.run_get_prob = wrap("calibration_scoring", ctl.run_get_prob, keep_emitted)
        DemuxWriter.write_batch_columnar = wrap("write", DemuxWriter.write_batch_columnar)

        class QuietLog(ctl.MessageLog):
            """The run's log, kept and not echoed."""

            def __call__(self, msg: str) -> None:
                self.messages.append(msg)

        self.QuietLog = QuietLog

    def job(self, infile: str, outprefix: str, flags: list) -> dict:
        """One job: {"wall", "reads", "timings", "spans", "threshold",
        "arch", "emitted" (the reads calibration scored, as (flat codes,
        offsets))}."""
        param = self.parse_args([infile, *flags, "-o", outprefix, "-engine", self.engine])
        log = self.QuietLog()
        self.seen = {}
        self.spans.take()
        # off the clock: the last job's garbage collected, as a fresh
        # process would start with none
        gc.collect()
        with self.spans.span("job"):
            t0 = time.perf_counter()
            self.ctl.hmm_controller_multiple(param, log=log)
            wall = time.perf_counter() - t0
        reads = 0
        for m in log.messages:
            if m.endswith("\ttotal input reads\n"):
                reads = int(m.split("\t")[0])
        arch = self.seen.get("arch")
        emitted = self.seen.pop("emitted", None)
        if emitted is not None:
            # two arrays in place of a list of 400,000, so that the heap the
            # next job starts from holds no more objects than a fresh one
            off = np.zeros(len(emitted) + 1, dtype=np.int64)
            np.cumsum([e.shape[0] for e in emitted], out=off[1:])
            emitted = (np.concatenate(emitted) if emitted else np.zeros(0, np.uint8), off)
        return {
            "wall": wall, "reads": reads,
            "timings": dict(self.ctl.TIMINGS),
            "spans": self.spans.take(),
            "threshold": self.seen.get("threshold"),
            "arch": None if arch is None else (list(arch.types), [list(s) for s in arch.seqs]),
            "emitted": emitted,
        }

    def close(self) -> None:
        """Put the program's functions back and drop its cached engines."""
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)
        from tagdust_tpu_torch import stats
        from tagdust_tpu_torch.engine import runner

        runner._ENGINE_CACHE.clear()
        stats._STATS_CACHE.clear()
