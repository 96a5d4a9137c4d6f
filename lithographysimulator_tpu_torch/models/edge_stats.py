"""A stochastic ensemble's edge statistics and edge PSD, on the trials'
device, from the edge tables of :func:`..ops.kernels.stochastic_edges.edge_runs`.

The numbers are those of the host's numpy helpers in :mod:`.stochastic`
(``_edge_stats_tables``, ``_table_traces`` and ``_tables_psd``), computed in float64 and vectorised over the trials of a
host chunk: rise (T, R, K) and fall (T, R, K) are each sampled cut line's
runs' edges in pixels, the first ``counts`` (T, R) slots of a line valid.

Every sum is a :func:`tree_sum` over a dense axis: a fixed order of IEEE
additions, with no atomics, whose result does not change when the axis is
padded further with zeros. A trial's numbers therefore do not depend on
which trials share its chunk (the widths K, J and F below follow the
chunk), and the same inputs give the same bits on the CPU and the card.
They differ from numpy's pairwise sums in rounding only.

A trial's runs group by feature: the nearest reference anchor, or without
anchors the rounded centre over a pitch of twice the median width. Along a
cut line the runs' centres increase, so their feature ids do not decrease
and a feature's runs on one line are a contiguous slice of its slots
(``_table_traces`` relies on the same order). Each (trial, line, feature)
slice is found by a search of the line's ids, and gathered into a dense
(T, R, F, J) block, J the most runs of one feature on one line. Where a
block would pass :data:`_BLOCK_BYTES` (noisy lines, whose stray runs all
fall to the few features nearest them), the trials are taken in halves,
which changes no bit: every number is a trial's own.
"""

from __future__ import annotations

import torch

_EMPTY = torch.iinfo(torch.int64).max  # the feature id of an empty slot
_BLOCK_BYTES = 1 << 28  # the largest (T, R, F, J) float64 block formed


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` by halving its zero-padded power-of-two
    length: the same bits on any device, and under any further zero
    padding."""
    x = x.movedim(dim, -1)
    m = x.shape[-1]
    size = 1 << max(m - 1, 0).bit_length()
    if size != m:
        x = torch.nn.functional.pad(x, (0, size - m))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _divide(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` as an IEEE division on ``a``'s device (on CUDA, PyTorch
    divides by a Python number as a product with its reciprocal)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), float(b), dtype=a.dtype, device=a.device)
    return a / b.to(a.dtype)


def _feature_ids(center, width, valid, anchors, px):
    """``_assign_feature_ids`` of each trial's runs (T, R, K): the nearest
    of the sorted ``anchors`` (a non-empty float64 tensor, or None), else
    the rounded centre over the trial's pitch; :data:`_EMPTY` on empty
    slots."""
    if anchors is not None and anchors.numel() > 1:
        idx = torch.searchsorted(anchors, center).clamp(1, anchors.numel() - 1)
        lo = idx - 1
        fid = torch.where((anchors[idx] - center).abs()
                          <= (anchors[lo] - center).abs(), idx, lo)
    elif anchors is not None:
        fid = torch.zeros(center.shape, dtype=torch.int64, device=center.device)
    else:
        t = center.shape[0]
        count = valid.reshape(t, -1).sum(dim=1)
        ranked = torch.where(valid, width, torch.inf).reshape(t, -1).sort(dim=1).values
        half = count // 2
        upper = ranked.gather(1, half.clamp_max(ranked.shape[1] - 1)[:, None])[:, 0]
        lower = ranked.gather(1, (half - 1).clamp_min(0)[:, None])[:, 0]
        median = torch.where(count % 2 == 1, upper, (lower + upper) / 2)
        pitch = torch.clamp_min(median * 2.0, px)
        fid = torch.round(_divide(center, pitch[:, None, None])).to(torch.int64)
    return torch.where(valid, fid, _EMPTY)


class _Features:
    """Each (trial, feature)'s runs of a table, line by line: ``start`` and
    ``length`` (T, R, F) of its slice of each line's slots, ``block_bytes``
    of a (T, R, F, J) float64 block, and (after :meth:`dense`) :meth:`take`
    of a (T, R, K) quantity as that block."""

    def __init__(self, fid: torch.Tensor, valid: torch.Tensor, n_ids: int | None):
        t, r, k = fid.shape
        if n_ids is None:  # the no-anchor ids: up to the largest one
            n_ids = int(torch.where(valid, fid, -1).max()) + 1
        seq = fid.reshape(t * r, k)
        ids = torch.arange(n_ids, device=fid.device).expand(t * r, n_ids).contiguous()
        start = torch.searchsorted(seq, ids)
        length = torch.searchsorted(seq, ids, right=True) - start
        self.start = start.view(t, r, n_ids)
        self.length = length.view(t, r, n_ids)
        self.size = self.length.sum(dim=1)  # (T, F) runs a feature
        self.width = int(self.length.max()) if self.length.numel() else 0
        self.block_bytes = self.length.numel() * self.width * 8

    def dense(self) -> "_Features":
        j = torch.arange(self.width, device=self.start.device)
        self.mask = j < self.length[..., None]
        index = torch.where(self.mask, self.start[..., None] + j, 0)
        self._index = index.flatten(2)
        return self

    def take(self, x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        block = x.gather(2, self._index).view(self.mask.shape)
        return torch.where(self.mask, block, fill)


def _valid(counts: torch.Tensor, k: int) -> torch.Tensor:
    return torch.arange(k, device=counts.device) < counts[..., None]


def _found(rise, fall, counts, anchors, px):
    """(valid, width, center (T, R, K), the runs' :class:`_Features`)."""
    valid = _valid(counts, rise.shape[-1])
    width = (fall - rise) * px
    center = 0.5 * (rise + fall) * px
    fid = _feature_ids(center, width, valid, anchors, px)
    feats = _Features(fid, valid, None if anchors is None else anchors.numel())
    return valid, width, center, feats


def _halves(fn, rise, fall, counts, *args):
    """``fn`` of the first and the second half of the trials."""
    h = rise.shape[0] // 2
    return (fn(rise[:h], fall[:h], counts[:h], *args),
            fn(rise[h:], fall[h:], counts[h:], *args))


def trial_stats(rise: torch.Tensor, fall: torch.Tensor, counts: torch.Tensor,
                anchors, px: float, min_runs: int) -> torch.Tensor:
    """(T, 3) float64: each trial's LER and LWR (3 sigma, nm, NaN without a
    tracked feature) and mean CD (nm, 0 without a run), as
    ``_edge_stats_tables`` gives them; a feature of fewer than ``min_runs``
    runs is a fragment, not tracked."""
    valid, width, center, feats = _found(rise, fall, counts, anchors, px)
    if feats.block_bytes > _BLOCK_BYTES and rise.shape[0] > 1:
        return torch.cat(_halves(trial_stats, rise, fall, counts, anchors, px,
                                 min_runs))
    feats.dense()
    size = feats.size.to(torch.float64)

    def three_sigma(x):
        block = feats.take(x)
        mean = _divide(tree_sum(tree_sum(block, -1), 1), size)
        dev = torch.where(feats.mask, block - mean[:, None, :, None], 0.0)
        return 3.0 * torch.sqrt(_divide(tree_sum(tree_sum(dev * dev, -1), 1), size))

    keep = feats.size >= min_runs
    kept = keep.sum(dim=1)
    edges = torch.stack([three_sigma(rise * px), three_sigma(fall * px)], dim=-1)
    edges = torch.where(keep[..., None], edges, 0.0).flatten(1)
    widths = torch.where(keep, three_sigma(width), 0.0)
    nan = torch.full((), float("nan"), dtype=torch.float64, device=rise.device)
    ler = torch.where(kept > 0, _divide(tree_sum(edges, 1), 2 * kept), nan)
    lwr = torch.where(kept > 0, _divide(tree_sum(widths, 1), kept), nan)
    runs = counts.sum(dim=1)
    cd_sum = tree_sum(tree_sum(torch.where(valid, width, 0.0), 2), 1)
    mean_cd = torch.where(runs > 0, _divide(cd_sum, runs), 0.0)
    return torch.stack([ler, lwr, mean_cd], dim=1)


def _traces(rise, fall, center, feats, px):
    """:func:`band_traces` of the runs ``feats`` (made dense here)."""
    k = rise.shape[-1]
    complete = (feats.length > 0).all(dim=1)
    if not feats.width:
        return rise.new_zeros((*complete.shape, 2, rise.shape[1])), complete
    feats.dense()
    centers = feats.take(center, torch.inf)  # (T, R, F, J)
    ranked = centers.permute(0, 2, 1, 3).flatten(2).sort(dim=-1).values
    half = feats.size // 2
    upper = ranked.gather(2, half.clamp_max(ranked.shape[-1] - 1)[..., None])[..., 0]
    lower = ranked.gather(2, (half - 1).clamp_min(0)[..., None])[..., 0]
    median = torch.where(feats.size % 2 == 1, upper, (lower + upper) / 2)
    dist = torch.where(feats.mask, (centers - median[:, None, :, None]).abs(),
                       torch.inf)
    pick = (feats.start + dist.argmin(dim=-1)).clamp_max(k - 1)  # (T, R, F)
    traces = torch.stack([rise.gather(2, pick) * px, fall.gather(2, pick) * px])
    return traces.permute(1, 3, 0, 2), complete


def band_traces(rise: torch.Tensor, fall: torch.Tensor, counts: torch.Tensor,
                anchors, px: float):
    """(traces (T, F, 2, rows) float64, complete (T, F) bool) of the cut
    lines of a band (rise, fall (T, rows, K)): ``_table_traces`` of each
    trial's band of its feature table. Feature f of trial t is complete
    when it prints on every line of the band; its traces are then its rise
    and its fall edge (nm), on each line its run nearest the median of its
    run centres (the first on a tie). Incomplete features' traces are
    undefined."""
    _, _, center, feats = _found(rise, fall, counts, anchors, px)
    return _traces(rise, fall, center, feats, px)


def psd_partial(rise: torch.Tensor, fall: torch.Tensor, counts: torch.Tensor,
                anchors, px: float, spacing: float):
    """(psd (T, rows // 2) float64, n_edges (T,) int64) of the cut lines of
    a band (rise, fall (T, rows, K)): each trial's sum of its complete
    features' two traces' one-sided PSD rows (:func:`band_traces`) and
    their count. ``tree_sum`` over the trials gives the partial that
    ``_tables_psd`` accumulates."""
    rows = rise.shape[1]
    bins = rows // 2
    _, _, center, feats = _found(rise, fall, counts, anchors, px)
    if feats.block_bytes > _BLOCK_BYTES and rise.shape[0] > 1:
        (a, m), (b, e) = _halves(psd_partial, rise, fall, counts, anchors, px,
                                 spacing)
        return torch.cat([a, b]), torch.cat([m, e])
    x, complete = _traces(rise, fall, center, feats, px)
    x = x - _divide(tree_sum(x, -1), rows)[..., None]
    spec = torch.fft.rfft(x, dim=-1)[..., 1:bins + 1].abs()
    psd = _divide((2.0 * spacing) * (spec * spec), rows)
    if rows % 2 == 0:
        psd[..., -1] *= 0.5  # the Nyquist bin is not duplicated
    psd = torch.where(complete[..., None, None], psd, 0.0)
    return tree_sum(psd.flatten(1, 2), 1), 2 * complete.sum(dim=1)
