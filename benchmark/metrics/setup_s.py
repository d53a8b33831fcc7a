"""setup_s: seconds from the start of the process to the end of set-up
(imports, the card, the kernel library, the warm-up job, the first job's
input)."""


def read(run):
    return run["setup_s"]
