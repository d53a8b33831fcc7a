"""runner.engine_build_s: seconds a job in the program's span
``runner.engine_build`` (a ``CudaEngine`` built on a miss of
``runner._ENGINE_CACHE``: every new file's model is new), the mean over the
jobs.  It nests inside ``runner.label`` where production builds the engine,
and inside ``detection`` where -arch builds the candidates' engines."""

from benchmark.span_readers import mean_a_job


def read(run):
    return mean_a_job(run, "runner.engine_build")
