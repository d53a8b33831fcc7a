"""controller.model_build_s: seconds a job in the program's span
``controller.model_build`` (the controller's ``init_model_bag`` of each
input file), the mean over the jobs."""

from benchmark.span_readers import mean_a_job


def read(run):
    return mean_a_job(run, "controller.model_build")
