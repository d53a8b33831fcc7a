"""The benchmark's plain reference of a ``tagdust`` job.

A frozen copy of the port's plain code, so that a later change to the
program is held against what the program computed when the benchmark was
written.  Copied modules, their imports made local: ``constants``, ``logsum``,
``arch``, ``model``, ``rng``, ``extract`` (whole), ``lattice``
(``compile_lattice``), ``tables`` (``tables_from_lattice``), ``scan`` (the
dense step; ``scan.precision``, the control's TF32 operands, added),
``batch`` (``io/batch.py``, with ``io/fastq.py``'s ``Read``), ``dust`` (the
DUST half of ``filters.py``) and ``calibrate`` (the emitters and the
sweep; the native emitters and ``estimate_q_threshold`` taken out).  New:
``stats`` (the pre-pass over reads given as codes) and ``engine`` (the
job's reference, ``engine.Reference``).

It imports nothing of the program (``benchmark/tests/test_bench_isolation.py``).
"""
