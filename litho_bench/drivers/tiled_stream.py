"""One caller in a closed loop: ``tiled_socs_image(chip, kernels,
tile_optics, halo=h)`` on a pool of distinct seeded chips taken in turn,
with the rank-``r`` kernel set built in set-up by the port's public
builder. Traffic: ``pool`` chips; the images of ``sample_calls`` calls kept,
and ``sample_tiles`` tiles of each compared (the first call's first tile
is the chip's corner)."""

from __future__ import annotations

import time

import torch

from litho_bench import judge, masks, program


def setup(ctx):
    from lithographysimulator_tpu_torch.ops.tiled import tile_layout

    cfg, tr = ctx.config, ctx.traffic
    lt = program.lt()
    big = cfg["chip_px"]
    chips = masks.layouts(ctx.seed, 0, tr["pool"], big, cfg["layout"],
                          device=ctx.device)
    socs = program.kernel_set(cfg, ctx.device)
    oc = program.optics(cfg)
    halo = cfg["halo_px"]
    tiles, step = tile_layout(big, cfg["pixel_number"], halo)
    state = {"optics": oc, "chips": chips, "socs": socs, "halo": halo,
             "tiles": tiles, "step": step}
    lt.tiled_socs_image(chips[0], socs, oc, halo=halo)
    return state


def window(state, ctx, seconds):
    lt = program.lt()
    tr = ctx.traffic
    big = ctx.config["chip_px"]
    kept, k = {}, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = k % len(state["chips"])
        with ctx.span("bench.tiled_socs_image"):
            image = lt.tiled_socs_image(state["chips"][i], state["socs"],
                                        state["optics"], halo=state["halo"])
            if ctx.device != "cpu":
                torch.cuda.synchronize()
        if len(kept) < tr["sample_calls"] and i not in kept:
            kept[i] = image
        k += 1
    tiles = state["tiles"] ** 2
    return {"attempted": k, "failed": 0, "images": k, "pixels": k * big * big,
            "tiles": k * tiles, "socs_images": k * tiles,
            "socs_rank": ctx.config["socs_rank"],
            "socs_n": ctx.config["pixel_number"], "kept": kept}


def release(state):
    del state["socs"]


def compare(state, record, ctx):
    cfg, tr = ctx.config, ctx.traffic
    n, big, halo = cfg["pixel_number"], cfg["chip_px"], state["halo"]
    tiles, step = state["tiles"], state["step"]
    pad_hi = tiles * step + halo - big + (n - step)
    rng = masks.rng_for(ctx.seed, 1)
    pairs = []
    for c, (i, image) in enumerate(sorted(record["kept"].items())):
        padded = torch.nn.functional.pad(state["chips"][i],
                                         (halo, pad_hi, halo, pad_hi))
        picks = judge.sample(rng, tiles * tiles, tr["sample_tiles"])
        if c == 0:
            picks = sorted(set([0] + picks[1:]))
        for t in picks:
            ti, tj = divmod(t, tiles)
            y1, x1 = min((ti + 1) * step, big), min((tj + 1) * step, big)
            window = padded[ti * step:ti * step + n, tj * step:tj * step + n]
            pairs.append((window, image[ti * step:y1, tj * step:x1],
                          (halo, halo + y1 - ti * step,
                           halo, halo + x1 - tj * step)))
    return judge.socs_checks(cfg, pairs)
