"""Mask rule checks (MRC): manufacturability verification of mask rasters.

The port's own copy of ``lithographysimulator_tpu/models/mrc.py`` (numpy on
the host, bound to the port's :class:`..config.OpticsConfig`); a tensor
mask is read back to the host first.

OPC/ILT optimizers (:mod:`..optimize`) freely sculpt sub-resolution
geometry; a mask shop will reject features below its write-tool limits.
This module checks the three canonical rules on a binary mask raster —
minimum feature width, minimum space (gap), minimum feature area — and
returns both counts and violation maps (for plotting or as an OPC
post-filter).

Width/space checks are morphological: a feature pixel that disappears
under an opening with a ``k x k`` structuring element (erosion then
dilation, ``k = round(min_width / pixel)``) belongs to a sub-``k`` neck or
sliver; spaces are the same check on the complement. The separable sliding
minimum runs in O(k n^2) numpy; area uses a two-pass union-find connected
components labeling (4-connectivity). Host-side by design: MRC is a
post-processing verification of a concrete mask, not a differentiable
pipeline stage.

No reference counterpart (the reference has no OPC and no mask
verification); rules follow standard EDA/mask-shop practice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OpticsConfig


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(frozen=True)
class MaskRules:
    """Mask-shop manufacturing limits. Any rule set to 0 is skipped."""

    min_width_nm: float = 0.0
    min_space_nm: float = 0.0
    min_area_nm2: float = 0.0

    def __post_init__(self):
        if min(self.min_width_nm, self.min_space_nm, self.min_area_nm2) < 0:
            raise ValueError("mask rules must be >= 0")


def _erode(binary: np.ndarray, k: int, left: int | None = None) -> np.ndarray:
    """Separable k x k sliding-minimum erosion (edge-padded with the border
    value so the array boundary is not itself a violation). ``left`` places
    the structuring-element origin (window spans [i-left, i+k-1-left])."""
    if k <= 1:
        return binary
    if left is None:
        left = k // 2
    out = binary
    for axis in (0, 1):
        padded = np.pad(out, [(left, k - 1 - left) if a == axis else (0, 0)
                              for a in (0, 1)], mode="edge")
        acc = None
        for off in range(k):
            sl = [slice(None)] * 2
            sl[axis] = slice(off, off + out.shape[axis])
            win = padded[tuple(sl)]
            acc = win if acc is None else np.minimum(acc, win)
        out = acc
    return out


def _dilate(binary: np.ndarray, k: int) -> np.ndarray:
    # mirrored origin: for even k the dilation's structuring element must be
    # the erosion's reflection or opening(stripe of width >= k) != stripe
    # (one boundary column gets falsely flagged)
    return 1 - _erode(1 - binary, k, left=(k - 1) - (k // 2))


def _opening(binary: np.ndarray, k: int) -> np.ndarray:
    return _dilate(_erode(binary, k), k)


def label_components(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """4-connected component labels (0 = background), two-pass union-find.

    Pure numpy (no scipy in the image): first pass assigns provisional
    labels row-major and records equivalences with the left/up neighbors;
    the union-find flattens them; second pass relabels densely."""
    arr = _host(binary) > 0.5
    h, w = arr.shape
    labels = np.zeros((h, w), np.int64)
    parent = [0]  # parent[0] is the background sentinel

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for i in range(h):
        row = arr[i]
        # contiguous runs in this row share one label — handle runs, not
        # pixels, so the python loop is O(#runs) instead of O(n^2)
        d = np.diff(np.concatenate([[0], row.view(np.int8), [0]]))
        starts = np.nonzero(d == 1)[0]
        ends = np.nonzero(d == -1)[0]
        for s, e in zip(starts, ends):
            up = labels[i - 1, s:e] if i > 0 else np.zeros(0, np.int64)
            touching = np.unique(up[up > 0])
            if touching.size == 0:
                parent.append(len(parent))
                lab = len(parent) - 1
            else:
                lab = int(touching[0])
                for other in touching[1:]:
                    union(lab, int(other))
            labels[i, s:e] = lab
    if len(parent) == 1:
        return labels, 0
    # flatten + dense relabel
    roots = np.asarray([find(x) for x in range(len(parent))], np.int64)
    uniq = np.unique(roots[1:])
    dense = np.zeros(len(parent), np.int64)
    dense[uniq] = np.arange(1, uniq.size + 1)
    flat = dense[roots]
    return flat[labels], int(uniq.size)


def mrc_check(mask, config_or_pixel, rules: MaskRules) -> dict:
    """Check a binary mask raster against :class:`MaskRules`.

    ``mask`` is thresholded at 0.5 (continuous OPC outputs welcome);
    ``config_or_pixel`` is an :class:`..config.OpticsConfig` or a pixel
    size in nm. Returns violation pixel counts, per-rule violation maps,
    the component count, and ``clean`` (True when every rule passes)."""
    px = (config_or_pixel.pixel_size
          if isinstance(config_or_pixel, OpticsConfig)
          else float(config_or_pixel))
    arr = (np.abs(_host(mask)) > 0.5).astype(np.int8)
    out: dict = {"pixel_size_nm": px}

    def k_of(nm):
        return max(1, int(np.ceil(nm / px)))

    if rules.min_width_nm > 0:
        k = k_of(rules.min_width_nm)
        viol = (arr == 1) & (_opening(arr, k) == 0)
        out["width_violation_px"] = int(viol.sum())
        out["width_violations"] = viol
    if rules.min_space_nm > 0:
        k = k_of(rules.min_space_nm)
        inv = 1 - arr
        viol = (inv == 1) & (_opening(inv, k) == 0)
        out["space_violation_px"] = int(viol.sum())
        out["space_violations"] = viol
    if rules.min_area_nm2 > 0:
        labels, count = label_components(arr)
        out["component_count"] = count
        if count:
            areas = np.bincount(labels.ravel())[1:] * px * px
            bad = np.nonzero(areas < rules.min_area_nm2)[0] + 1
            viol = np.isin(labels, bad)
            out["area_violation_components"] = int(bad.size)
            out["area_violations"] = viol
        else:
            out["area_violation_components"] = 0
            out["area_violations"] = np.zeros_like(arr, bool)
    out["clean"] = (out.get("width_violation_px", 0) == 0
                    and out.get("space_violation_px", 0) == 0
                    and out.get("area_violation_components", 0) == 0)
    return out


def mrc_clean(mask, config_or_pixel, rules: MaskRules,
              *, iterations: int = 4) -> np.ndarray:
    """Repair a mask toward rule-cleanliness: iteratively remove width/area
    violators and fill space violators (open the pattern, then close it).
    Convergence is not guaranteed for adversarial geometry — re-check with
    :func:`mrc_check`; in an OPC flow run this between Gauss-Seidel sweeps
    so imaging feedback can compensate the repairs."""
    px = (config_or_pixel.pixel_size
          if isinstance(config_or_pixel, OpticsConfig)
          else float(config_or_pixel))
    arr = (np.abs(_host(mask)) > 0.5).astype(np.int8)
    kw = max(1, int(np.ceil(rules.min_width_nm / px))) if rules.min_width_nm else 1
    ks = max(1, int(np.ceil(rules.min_space_nm / px))) if rules.min_space_nm else 1
    for _ in range(iterations):
        check = mrc_check(arr, px, rules)
        if check["clean"]:
            break
        if rules.min_width_nm:
            arr = _opening(arr, kw)
        if rules.min_space_nm:
            arr = 1 - _opening(1 - arr, ks)
        if rules.min_area_nm2:
            labels, count = label_components(arr)
            if count:
                areas = np.bincount(labels.ravel())[1:] * px * px
                bad = np.nonzero(areas < rules.min_area_nm2)[0] + 1
                arr = np.where(np.isin(labels, bad), 0, arr).astype(np.int8)
    return arr.astype(np.float32)
