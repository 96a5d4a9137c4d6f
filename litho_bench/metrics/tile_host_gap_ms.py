"""Host gap a tile: the traced window less the device's busy time, over
the tiles imaged in it (tools/profile_port.py --tiled's arithmetic)."""


def read(run):
    t, w = run["trace"], run["window"]
    if t is None or not w.get("tiles"):
        return None
    return 1e3 * (t["window_s"] - t["busy_s"]) / w["tiles"]
