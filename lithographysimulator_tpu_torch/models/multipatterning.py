"""Multiple patterning (LELE / LELELE / quadruple): layout decomposition
+ composite printing.

The port's own copy of ``lithographysimulator_tpu/models/multipatterning.py``:
the decomposition is numpy on the host, bound to the port's
:class:`..config.OpticsConfig` and :mod:`.mrc` labeling (a tensor mask is
read back first); the printing images each mask through the port's
:func:`..metrology.tiled_focus_images` on ``device`` (a tensor chip's own
by default) and develops it there, and only the overlay shift (a float64
host FFT, as in the JAX package) and the binary profiles move to the host.

Below the single-exposure resolution limit (half-pitch ~ k1 * lambda / NA),
fabs split one layer across several masks exposed and etched separately
(litho-etch-litho-etch-...): features closer than the minimum same-mask
pitch land on different masks, each mask sees a relaxed pitch, and the
final pattern is the union of the transfers.

Decomposition is conflict-graph coloring: features are connected components
of the layout (:func:`.mrc.label_components`), an edge joins any two
features whose edge-to-edge (Chebyshev) distance is below ``min_pitch_nm``
— the minimum SAME-MASK spacing. Conflict edges are found by a fully
vectorized half-plane offset scan from feature-boundary pixels (a
minimal-distance witness always sits on its feature's boundary: stepping
along the larger coordinate delta never increases the Chebyshev distance
until the feature is exited), O(k^2 * boundary pixels) numpy work with no
per-feature python loop — 1e5+ features scan as fast as 10.

Coloring: two masks use BFS 2-coloring (exact on bipartite graphs; odd
cycles are inherent LELE conflicts — reported, not silently dropped); three
or more masks use greedy coloring in smallest-last (degeneracy) order,
which k-colors every graph of degeneracy < k. Features whose neighborhood
exhausts the palette are counted as violations and assigned the color least
used among their neighbors so downstream imaging still runs.

Printing: each mask images independently through any solver path (the
composite helper uses the tiled SOCS imager, so polarization / chromatic /
full-chip options apply) and the binary resists OR together — the etch
union. No reference counterpart (single-mask reference).
"""

from __future__ import annotations

import numpy as np

import torch

from ..config import OpticsConfig
from .mrc import _host, label_components


def conflict_pairs(labels: np.ndarray, k: int) -> np.ndarray:
    """(E, 2) unique label pairs with edge-to-edge Chebyshev distance <= k.

    Exact and fully vectorized: for any pair of features within distance
    <= k there is a witness pair with BOTH pixels on their features'
    boundaries (walking a witness along its larger coordinate delta keeps
    the Chebyshev distance non-increasing until the feature is exited), and
    for boundary witnesses (p, q) either q - p or p - q lies in the scanned
    half-plane {(0, 1..k)} + {(1..k, -k..k)}. Scanning those offsets from
    every boundary pixel against the full label map therefore finds every
    conflicting pair, with no false positives (every compared pair is
    within distance k by construction)."""
    h, w = labels.shape
    fg = labels != 0
    bnd = np.zeros(labels.shape, bool)
    bnd[1:, :] |= labels[1:, :] != labels[:-1, :]
    bnd[:-1, :] |= labels[:-1, :] != labels[1:, :]
    bnd[:, 1:] |= labels[:, 1:] != labels[:, :-1]
    bnd[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    bnd[0, :] = bnd[-1, :] = bnd[:, 0] = bnd[:, -1] = True
    bnd &= fg
    ys, xs = np.nonzero(bnd)
    labs = labels[ys, xs]
    offsets = [(0, dx) for dx in range(1, k + 1)] + \
              [(dy, dx) for dy in range(1, k + 1) for dx in range(-k, k + 1)]
    found: list[np.ndarray] = []
    for dy, dx in offsets:
        ty, tx = ys + dy, xs + dx
        ok = (ty < h) & (tx >= 0) & (tx < w)  # ty >= 0 always (dy >= 0)
        nb = labels[ty[ok], tx[ok]]
        a = labs[ok]
        sel = (nb != 0) & (nb != a)
        if sel.any():
            pr = np.stack([np.minimum(a[sel], nb[sel]),
                           np.maximum(a[sel], nb[sel])], axis=1)
            found.append(np.unique(pr, axis=0))
    if not found:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.concatenate(found, axis=0), axis=0)


def _color_graph(count: int, pairs: np.ndarray, n_colors: int
                 ) -> tuple[dict[int, int], int]:
    """Color labels 1..count so conflict-pair endpoints differ; returns
    (colors, violations). n_colors == 2 uses BFS (exact on bipartite
    graphs); n_colors >= 3 uses greedy smallest-last order."""
    adj: dict[int, set[int]] = {i: set() for i in range(1, count + 1)}
    for a, b in pairs:
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))
    colors: dict[int, int] = {}
    violations = 0
    if n_colors == 2:
        for start in range(1, count + 1):
            if start in colors:
                continue
            colors[start] = 0
            queue = [start]
            while queue:
                node = queue.pop()
                for nb in adj[node]:
                    if nb not in colors:
                        colors[nb] = 1 - colors[node]
                        queue.append(nb)
                    elif colors[nb] == colors[node]:
                        violations += 1  # odd cycle: not 2-colorable
        return colors, violations
    # smallest-last (degeneracy) ordering: repeatedly strip a minimum-degree
    # vertex; coloring in reverse strip order greedily succeeds whenever
    # the palette exceeds the graph degeneracy.
    deg = {v: len(adj[v]) for v in adj}
    alive = set(adj)
    order: list[int] = []
    import heapq

    heap = [(d, v) for v, d in deg.items()]
    heapq.heapify(heap)
    while heap:
        d, v = heapq.heappop(heap)
        if v not in alive or d != deg[v]:
            continue  # stale entry
        alive.discard(v)
        order.append(v)
        for nb in adj[v]:
            if nb in alive:
                deg[nb] -= 1
                heapq.heappush(heap, (deg[nb], nb))
    for v in reversed(order):
        used = {colors[nb] for nb in adj[v] if nb in colors}
        free = [c for c in range(n_colors) if c not in used]
        if free:
            colors[v] = free[0]
        else:
            violations += 1
            counts = [0] * n_colors
            for nb in adj[v]:
                if nb in colors:
                    counts[colors[nb]] += 1
            colors[v] = int(np.argmin(counts))
    return colors, violations


def decompose_multipatterning(mask, config_or_pixel, *, min_pitch_nm: float,
                              masks: int = 2) -> dict:
    """Split a layout across ``masks`` exposures.

    Returns ``{"masks": [per-mask float32 layouts], "colors", "features",
    "conflict_edges", "violations"}`` — ``violations`` counts features whose
    conflict neighborhood exhausts the palette (odd cycle for 2 masks, >
    palette-size cliques etc. for more); they are still assigned the
    least-bad color so downstream imaging runs, but a nonzero count means
    this layout is not decomposable into ``masks`` masks at this pitch."""
    if masks < 2:
        raise ValueError("multipatterning needs masks >= 2")
    px = (config_or_pixel.pixel_size
          if isinstance(config_or_pixel, OpticsConfig)
          else float(config_or_pixel))
    arr = (np.abs(_host(mask)) > 0.5).astype(np.int8)
    labels, count = label_components(arr)
    if count == 0:
        return {"masks": [np.zeros_like(arr, np.float32)
                          for _ in range(masks)],
                "colors": {}, "features": 0, "conflict_edges": 0,
                "violations": 0}
    k = max(1, int(np.ceil(min_pitch_nm / px)))
    pairs = conflict_pairs(labels, k)
    colors, violations = _color_graph(count, pairs, masks)
    color_of = np.zeros(count + 1, np.int64)
    for lab, c in colors.items():
        color_of[lab] = c
    pixel_color = color_of[labels]
    out_masks = [np.where((labels != 0) & (pixel_color == c), arr, 0
                          ).astype(np.float32) for c in range(masks)]
    return {"masks": out_masks, "colors": colors, "features": count,
            "conflict_edges": int(pairs.shape[0]), "violations": violations}


def decompose_lele(mask, config_or_pixel, *, min_pitch_nm: float) -> dict:
    """Split a layout into two LELE masks (2-mask case of
    :func:`decompose_multipatterning`, BFS 2-colored).

    Returns ``{"mask_a", "mask_b", "colors", "features", "conflict_edges",
    "violations"}``."""
    out = decompose_multipatterning(mask, config_or_pixel,
                                    min_pitch_nm=min_pitch_nm, masks=2)
    out["mask_a"], out["mask_b"] = out.pop("masks")
    return out


def subpixel_shift(image: np.ndarray, dy_nm: float, dx_nm: float,
                   pixel_size: float) -> np.ndarray:
    """Exact subpixel translation of a band-limited field via a Fourier
    phase ramp (host-side numpy). Partial-coherence imaging is linear
    shift-invariant, so displacing a mask by (dy, dx) displaces its aerial
    intensity by exactly (dy, dx) — overlay error applies as an image
    shift, with no re-imaging."""
    if dy_nm == 0.0 and dx_nm == 0.0:
        return np.asarray(image)
    arr = np.asarray(image, np.float64)
    fy = np.fft.fftfreq(arr.shape[0])[:, None]
    fx = np.fft.fftfreq(arr.shape[1])[None, :]
    ramp = np.exp(-2j * np.pi * (fy * dy_nm / pixel_size
                                 + fx * dx_nm / pixel_size))
    return np.real(np.fft.ifft2(np.fft.fft2(arr) * ramp)).astype(np.float32)


def multipatterning_print(mask_big, tile_config: OpticsConfig, source_map, *,
                          min_pitch_nm: float, masks: int = 2, resist=None,
                          rank: int = 64, halo: int | None = None,
                          polarization=None, chromatic=None,
                          overlay_nm=None, progress_cb=None,
                          device=None) -> dict:
    """Decompose + image + develop + union: the full multi-patterning flow
    on the tiled path. Returns the decomposition report plus ``profile``
    (the union print, {0,1}), per-mask ``profiles``, and the
    single-exposure profile for comparison.

    ``overlay_nm`` models scanner overlay error — the dominant
    multipatterning CDU contributor: a (dy, dx) nm pair per mask displaces
    that exposure relative to the wafer grid (applied as an exact subpixel
    Fourier shift of its aerial image; see :func:`subpixel_shift`).
    Images on ``device``, else on a tensor ``mask_big``'s device; the
    profiles are host arrays."""
    from ..metrology import _device, tiled_focus_images
    from .resist import ResistModel

    device = _device(mask_big, device)
    resist = resist or ResistModel()
    parts = decompose_multipatterning(
        mask_big, tile_config, min_pitch_nm=min_pitch_nm, masks=masks)
    if overlay_nm is None:
        overlay_nm = [(0.0, 0.0)] * masks
    if len(overlay_nm) != masks:
        raise ValueError(f"overlay_nm needs one (dy, dx) pair per mask: "
                         f"got {len(overlay_nm)} for {masks} masks")
    n_jobs = masks + 1

    def print_one(m, j, overlay=(0.0, 0.0)):
        lo, hi = j / n_jobs, (j + 1) / n_jobs
        img = tiled_focus_images(
            m, tile_config, source_map, [0.0], rank=rank, halo=halo,
            polarization=polarization, chromatic=chromatic,
            progress_cb=(None if progress_cb is None else
                         lambda f: progress_cb(lo + (hi - lo) * f)),
            device=device)[0]
        if overlay[0] != 0.0 or overlay[1] != 0.0:
            img = torch.as_tensor(subpixel_shift(
                img.cpu().numpy(), float(overlay[0]), float(overlay[1]),
                tile_config.pixel_size), device=device)
        return resist.develop_binary(img, tile_config).cpu().numpy()

    profiles = [print_one(m, j, overlay)
                for j, (m, overlay) in enumerate(zip(parts["masks"],
                                                     overlay_nm))]
    single = print_one(mask_big.to(torch.float32)
                       if isinstance(mask_big, torch.Tensor)
                       else np.asarray(mask_big, np.float32), masks)
    union = profiles[0]
    for p in profiles[1:]:
        union = np.maximum(union, p)
    parts.update({"profiles": profiles, "profile": union,
                  "profile_single": single})
    return parts


def lele_print(mask_big, tile_config: OpticsConfig, source_map, *,
               min_pitch_nm: float, resist=None, rank: int = 64,
               halo: int | None = None, polarization=None, chromatic=None,
               overlay_nm=None, progress_cb=None, device=None) -> dict:
    """Decompose + image + develop + union for two masks (LELE). Returns
    the decomposition report plus ``profile`` (the union print, {0,1}), the
    per-mask profiles, and the single-exposure profile for comparison."""
    out = multipatterning_print(
        mask_big, tile_config, source_map, min_pitch_nm=min_pitch_nm,
        masks=2, resist=resist, rank=rank, halo=halo,
        polarization=polarization, chromatic=chromatic,
        overlay_nm=overlay_nm, progress_cb=progress_cb, device=device)
    out["mask_a"], out["mask_b"] = out.pop("masks")
    out["profile_a"], out["profile_b"] = out.pop("profiles")
    return out
