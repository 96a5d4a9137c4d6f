"""Int8 kernel launches a field of the exact engine: the port's launch
counters as tallied while the trace recorded (``int8_launches.<kernel>``,
the window only), over its ``abbe.fields`` tally (the fields the exact
engine computed meanwhile). A chunk of 4 fields launches each of the four
kernels once: 1.0. A port without the field counter reads nothing."""


def _tally():
    try:
        from lithographysimulator_tpu_torch.utils.profiling import recording
    except ImportError:
        return None
    return recording()["counters"]


def read(run):
    tally = None if run["trace"] is None else _tally()
    if not tally or not tally.get("abbe.fields"):
        return None
    launches = sum(n for key, n in tally.items()
                   if key.startswith("int8_launches."))
    return launches / tally["abbe.fields"]
