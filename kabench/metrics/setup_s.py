"""setup_s: process start to the window's start (imports, the CUDA context,
the library builds or loads, the deployment built from the seed, the warm-up
request)."""
SOURCE = "host_clock"


def read(run):
    return run.setup_s
