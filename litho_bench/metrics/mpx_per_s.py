"""Finished aerial-image megapixels per second: every image completed in
the window times its pixels, over the whole window (host clock)."""


def read(run):
    w = run["window"]
    if not w.get("pixels"):
        return None
    return w["pixels"] / w["seconds"] / 1e6
