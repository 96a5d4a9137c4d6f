"""Megabytes a stochastic ensemble reads back to the host, an image: the
window's change of the port's ``stochastic.readback_bytes`` counter (the
deterministic field, and every host chunk's cut lines, run counts and
band) over the images the window completed. A port without the counter
reads nothing."""


def read(run):
    w = run["window"]
    delta = w.get("stochastic_counts")
    if not delta or not w.get("images"):
        return None
    return delta["readback_bytes"] / w["images"] / 1e6
