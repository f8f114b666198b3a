"""setup_s: the host-clock seconds from the run's start to the window:
imports, kernels loaded (built, in a checkout's first run), inputs made,
warm-up."""


def read(rec):
    return rec["setup_s"]
