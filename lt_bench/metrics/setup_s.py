"""``setup_s`` (end to end, host clock): process start to the first timed
tile — imports, the kernel library (built by nvcc on a checkout's first
run), the scene made on the card, the warm-up and, in a traced run, the
profiler's start."""


def read(run):
    return run.setup_s
