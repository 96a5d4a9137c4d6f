"""The edge runs of a stochastic ensemble's cut lines, on the trials' device.

A trial chunk's deprotection fields ``(T, L, n)`` float32 (cut lines along
the last axis) give, in two passes:

* the count pass (``k=None``): ``runs`` (T, L) int32, the above-threshold
  runs of every cut line, compared in float32 as ``fields > threshold``
  compares (``models/stochastic._run_counts``'s counts exactly); and
  ``counts`` (T, R) int32, the runs of the sampled lines (every
  ``row_step``-th, R = ceil(L / row_step)) compared in float64;
* the table pass (``k`` the most runs a sampled line holds): ``rise`` and
  ``fall`` (T, R, k) float64, each sampled line's runs' subpixel edges in
  order, NaN past its count: :func:`.models.resist.feature_table`'s
  ``rise_px`` and ``fall_px`` of the same lines, bit for bit; into
  ``out=(rise, fall)`` where given (contiguous, such as a trial slice of a
  larger table).

On CUDA tensors :func:`edge_runs` launches the hand-written kernel
``edge_runs`` (``csrc/stochastic_edges.cu``) and adds one to
:data:`LAUNCHES`; on CPU tensors it runs :func:`edge_runs_plain`, its plain
PyTorch twin, which runs on either device.
"""

from __future__ import annotations

import torch

from ..._spans import Counters
from .intensity_int8 import _device_stream

_LAUNCH_COUNTS = Counters("edge_launches", ("edge_runs",))
#: kernel launches by name (CUDA launches only)
LAUNCHES = _LAUNCH_COUNTS.totals


def reset_launch_counts() -> None:
    _LAUNCH_COUNTS.reset()


def edge_runs_plain(fields: torch.Tensor, threshold: float, row_step: int,
                    k: int | None = None, out=None):
    """:func:`edge_runs` in plain PyTorch, on the fields' device."""
    if k is None:
        above = fields > threshold
        rises = (above[..., 1:] & ~above[..., :-1]).sum(dim=-1)
        runs = (above[..., 0].to(torch.int64) + rises).to(torch.int32)
        sampled = fields[:, ::row_step].double() > threshold
        counts = (sampled[..., 0].to(torch.int64)
                  + (sampled[..., 1:] & ~sampled[..., :-1]).sum(dim=-1))
        return runs, counts.to(torch.int32)
    lines = fields[:, ::row_step]
    t, r, n = lines.shape
    above = lines.double() > threshold
    edge = torch.zeros((t, r, n + 2), dtype=torch.bool, device=fields.device)
    edge[..., 1:-1] = above
    # a run [s, e) starts at column s and ends at column e, where the padded
    # line changes; a line's changes alternate start, end
    start = edge[..., 1:-1] & ~edge[..., :-2]
    end = edge[..., :-2] & ~edge[..., 1:-1]
    end = torch.cat([end, edge[..., -2:-1]], dim=-1)  # e = n: the last pixel
    ts, rs, s = start.nonzero(as_tuple=True)
    te, re, e = end.nonzero(as_tuple=True)
    started = torch.cumsum(start, dim=-1)  # the runs begun by each column
    slot_s = started[ts, rs, s] - 1
    slot_e = started[te, re, e - 1] - 1
    v = lines.double()
    prev = v[ts, rs, (s - 1).clamp_min(0)]
    cur = v[ts, rs, s]
    frac = (threshold - prev) / torch.clamp_min(cur - prev, 1e-30)
    rise_px = torch.where(s > 0, (s - 1).double() + torch.clamp(frac, 0.0, 1.0),
                          s.double() - 0.5)
    last = v[te, re, e - 1]
    nxt = v[te, re, e.clamp_max(n - 1)]
    frac = (last - threshold) / torch.clamp_min(last - nxt, 1e-30)
    fall_px = torch.where(e < n, (e - 1).double() + torch.clamp(frac, 0.0, 1.0),
                          e.double() - 0.5)
    if out is None:
        out = (torch.empty((t, r, k), dtype=torch.float64, device=fields.device),
               torch.empty((t, r, k), dtype=torch.float64, device=fields.device))
    rise, fall = out
    rise.fill_(float("nan"))
    fall.fill_(float("nan"))
    keep_s, keep_e = slot_s < k, slot_e < k
    rise[ts[keep_s], rs[keep_s], slot_s[keep_s]] = rise_px[keep_s]
    fall[te[keep_e], re[keep_e], slot_e[keep_e]] = fall_px[keep_e]
    return rise, fall


def _check(fields: torch.Tensor) -> None:
    if fields.dtype != torch.float32 or fields.dim() != 3:
        raise ValueError(f"fields: expected float32 (T, L, n), got "
                         f"{fields.dtype} {tuple(fields.shape)}")
    if not fields.is_contiguous():
        raise ValueError("fields must be contiguous")


def _check_out(fields: torch.Tensor, shape, out) -> None:
    for o in out or ():
        if (o.dtype != torch.float64 or tuple(o.shape) != shape
                or not o.is_contiguous() or o.device != fields.device):
            raise ValueError(f"out: expected contiguous float64 {shape} on "
                             f"{fields.device}, got {o.dtype} "
                             f"{tuple(o.shape)} on {o.device}")


def edge_runs(fields: torch.Tensor, threshold: float, row_step: int,
              k: int | None = None, out=None):
    """The count pass (``k=None``: ``runs``, ``counts``) or the table pass
    (``rise``, ``fall`` of width ``k``, into ``out`` where given) of the
    cut lines ``fields`` (T, L, n) float32, as the module docstring
    defines them. A sampled line with more than ``k`` runs keeps its first
    ``k``: take ``k`` from the count pass's ``counts``."""
    if row_step < 1 or (k is not None and k < 0):
        raise ValueError(f"row_step {row_step} must be >= 1 and k {k} >= 0")
    if out is not None and k is None:
        raise ValueError("out is the table pass's: give k")
    if fields.device.type != "cpu":
        _check(fields)
    t, lines, n = fields.shape
    r = -(-lines // row_step)
    _check_out(fields, (t, r, k), out)
    if fields.device.type == "cpu":
        return edge_runs_plain(fields, threshold, row_step, k, out)
    dev = fields.device
    if k is None:
        runs = torch.empty((t, lines), dtype=torch.int32, device=dev)
        counts = torch.empty((t, r), dtype=torch.int32, device=dev)
        out = (runs, counts)
        ptrs = (runs.data_ptr(), counts.data_ptr(), None, None, 0)
    else:
        if out is None:
            out = (torch.empty((t, r, k), dtype=torch.float64, device=dev),
                   torch.empty((t, r, k), dtype=torch.float64, device=dev))
        ptrs = (None, None, out[0].data_ptr(), out[1].data_ptr(), k)
        if k == 0:
            return out
    from .build import EDGES, load_library

    with _device_stream(dev) as stream:
        err = load_library(EDGES).edge_runs(fields.data_ptr(), t, lines, n,
                                            row_step, float(threshold), *ptrs,
                                            stream)
    if err:
        raise RuntimeError(f"CUDA kernel edge_runs failed to launch: error {err}")
    _LAUNCH_COUNTS.add("edge_runs")
    return out
