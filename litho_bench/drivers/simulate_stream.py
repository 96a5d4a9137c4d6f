"""One caller in a closed loop: ``simulate(mask, source, aberrations,
solver='socs', socs_rank=r, device=...)`` on a pool of distinct seeded
masks taken in turn. Set-up makes the pool on the device and calls
simulate once, which builds the kernel set into the program's cache, so
every timed call is a cache hit: the spectrum, the apply and simulate's
host work (its report, the image-error bound). Traffic: ``pool`` masks,
``sample`` of them compared."""

from __future__ import annotations

import time

from litho_bench import judge, masks, program


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    lt = program.lt()
    oc = program.optics(cfg)
    pool = masks.layouts(ctx.seed, 0, tr["pool"], cfg["pixel_number"],
                         cfg["layout"], device=ctx.device)
    state = {"optics": oc, "source": program.source_map(cfg),
             "aberrations": program.aberrations(cfg), "pool": pool,
             "masks": [lt.Mask(geometry=g, config=oc) for g in pool],
             "sample": judge.sample(masks.rng_for(ctx.seed, 1), tr["pool"],
                                    tr["sample"])}
    call(state, ctx, 0)
    return state


def call(state, ctx, i):
    return program.lt().simulate(
        state["masks"][i], state["source"], state["aberrations"],
        solver="socs", socs_rank=ctx.config["socs_rank"], device=ctx.device)


def window(state, ctx, seconds):
    n = ctx.config["pixel_number"]
    pool = len(state["masks"])
    kept, k = {}, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = k % pool
        with ctx.span("bench.simulate"):
            result = call(state, ctx, i)
        if i in state["sample"] and i not in kept:
            kept[i] = result.image
        k += 1
    return {"attempted": k, "failed": 0, "images": k, "pixels": k * n * n,
            "socs_images": k, "socs_rank": ctx.config["socs_rank"],
            "socs_n": n, "kept": kept}


def compare(state, record, ctx):
    pairs = [(state["pool"][i], image, None)
             for i, image in sorted(record["kept"].items())]
    return judge.socs_checks(ctx.config, pairs)
