"""setup_s: seconds from the process's start to the window's opening:
imports, the CUDA context, the kernels' build or load, the weights, the
warm-up and, for serving, the traffic's pre-roll or the backlog's fill."""


def read(run):
    return run.setup_s
