"""Least time of a stochastic ensemble's trials on the card, counted from
the grid ``n``, the trials and the cut lines' ``row_step`` alone.

A trial's chain (draw, acid, blur, threshold, cut lines, run counts, band)
can fuse into few passes, but not below these bytes of an ``n x n`` float32
field, each of which no order of the work avoids:

* the drawn field, written once and read once (4 n^2 each): the draw
  depends on a generator's stream, the blur on the whole field, so the
  field exists once between them;
* the blur's FFT round trip at its least: a real field's half spectrum
  (``n (n / 2 + 1)`` complex64) written by the forward transform and read
  by the inverse (about 4 n^2 each), and the blurred field written once
  (4 n^2): the inverse transform needs every frequency of the forward one,
  so the spectrum cannot stay on the chip for a field of 1024^2;
* the cut lines read for their copy to the host, ``ceil(n / row_step) n``
  float32: what the host's edge tables read.

The mean photon field, the transfer function and the counts that fit in
the caches are left out, as are the threshold's and the band's passes
(they can fuse into the inverse transform's last pass). The bytes move at
the card's memory rate. The count reads no kernel name, launch or chunk of
the program.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def trial_bytes(n: int, row_step: int) -> float:
    field = 4.0 * n * n
    half_spectrum = 8.0 * n * (n // 2 + 1)
    cut_lines = 4.0 * (-(-n // row_step)) * n
    return 2 * field + 2 * half_spectrum + field + cut_lines


def least_s(trials: int, n: int, row_step: int) -> float:
    """Seconds of ``trials`` trials on an ``n``-point grid at the memory
    rate."""
    return trials * trial_bytes(n, row_step) / HBM_BYTES_PER_S
