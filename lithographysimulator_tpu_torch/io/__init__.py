"""Layouts in, contours out, on the host: GDSII and OASIS readers and
writers, the C++ rasterizer and loop tracer, layout masks and streamed
tile windows, printed contours written back as GDSII. Port of
``lithographysimulator_tpu/io``, with the same names."""

from .contours import contours_to_gds, rasterize_loops, trace_contours
from .gdsii import GDSCell, GDSLibrary, GDSPolygon, read_gds, write_gds
from .layout import (mask_from_gds, mask_from_layout, mask_from_oasis,
                     mask_from_polygons)
from .native import native_available, rasterize
from .oasis import read_oasis, write_oasis
