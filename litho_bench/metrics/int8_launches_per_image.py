"""Int8 kernel launches a SOCS image: the port's launch counters as tallied
while the trace recorded (``int8_launches.<kernel>``, the window only), over
the SOCS images the window completed (clips, or a chip's tiles). A rank-r
apply in chunks of 4 launches each of the four kernels once a chunk: 256 at
rank 256. A port without the tally reads nothing."""


def _tally():
    try:
        from lithographysimulator_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    return recording()["counters"]


def read(run):
    images = run["window"].get("socs_images")
    tally = None if run["trace"] is None or not images else _tally()
    if tally is None:
        return None
    launches = sum(n for key, n in tally.items()
                   if key.startswith("int8_launches."))
    return launches / images
