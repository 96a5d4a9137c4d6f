"""Set-up: process start to the first timed call (host clock): imports, the
card's context, the kernel library loaded or built, the inputs made, the
kernel set built and every shape warmed up."""


def read(run):
    return run["setup_s"]
