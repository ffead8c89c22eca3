"""setup_s: from the process's start to the window's start (imports, the
CUDA context, the kernels' build or cache hit, the inputs from the seed,
the manager and one warm-up unit), on the host clock."""


def read(obs):
    return obs["setup_s"]
