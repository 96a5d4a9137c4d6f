"""Minimal GDSII stream-format reader/writer for mask layout import.

Port of ``lithographysimulator_tpu/io/gdsii.py`` (host numpy and
``struct``, the same records, transforms and units), so a file written by
either package reads back to equal polygons in the other.

Covers the subset that defines mask geometry: library/structure framing,
BOUNDARY (polygon), BOX, and PATH (expanded to per-segment rectangles)
elements with LAYER/DATATYPE/XY, plus SREF/AREF placements with full
STRANS/MAG/ANGLE transforms (reflection, magnification, rotation) and array
expansion. Units are resolved through the UNITS record so coordinates come
back in nanometers regardless of the file's database unit. Format per the
Calma GDSII Stream Format Manual (public record layout: 2-byte length,
1-byte record type, 1-byte data type, big-endian payloads).
"""

from __future__ import annotations

import dataclasses
import struct
import warnings
from pathlib import Path

import numpy as np

# Record types
HEADER, BGNLIB, LIBNAME, UNITS, ENDLIB = 0x00, 0x01, 0x02, 0x03, 0x04
BGNSTR, STRNAME, ENDSTR = 0x05, 0x06, 0x07
BOUNDARY, PATH, SREF, AREF = 0x08, 0x09, 0x0A, 0x0B
TEXT, NODE = 0x0C, 0x15
LAYER, DATATYPE, WIDTH, XY, ENDEL = 0x0D, 0x0E, 0x0F, 0x10, 0x11
SNAME, COLROW = 0x12, 0x13
PATHTYPE, STRANS, MAG, ANGLE = 0x21, 0x1A, 0x1B, 0x1C
BOX, BOXTYPE = 0x2D, 0x2E

_DT_NONE, _DT_INT16, _DT_INT32, _DT_REAL8, _DT_ASCII = 0x00, 0x02, 0x03, 0x05, 0x06


@dataclasses.dataclass
class GDSPolygon:
    layer: int
    datatype: int
    xy_nm: np.ndarray  # (v, 2) float64, closed ring NOT repeated


@dataclasses.dataclass
class GDSRef:
    """One SREF/AREF placement: affine transform per instance."""

    cell_name: str
    origin_nm: tuple  # (dx, dy)
    mag: float = 1.0
    angle_deg: float = 0.0
    reflect_x: bool = False  # STRANS bit 15: mirror about the x axis first
    cols: int = 1
    rows: int = 1
    col_step_nm: tuple = (0.0, 0.0)
    row_step_nm: tuple = (0.0, 0.0)

    def matrix(self) -> np.ndarray:
        theta = np.deg2rad(self.angle_deg)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]])
        refl = np.diag([1.0, -1.0 if self.reflect_x else 1.0])
        return self.mag * rot @ refl


@dataclasses.dataclass
class GDSCell:
    name: str
    polygons: list
    references: list  # list[GDSRef]


@dataclasses.dataclass
class GDSLibrary:
    name: str
    unit_nm: float  # database unit in nm
    cells: dict

    def flatten(self, cell_name: str | None = None, *, max_depth: int = 16):
        """All polygons of a cell with the SREF/AREF affine transforms
        (reflection -> magnification/rotation -> translation) applied and
        arrays expanded."""
        if cell_name is None:
            referenced = {r.cell_name for c in self.cells.values()
                          for r in c.references}
            tops = [n for n in self.cells if n not in referenced]
            if not tops:
                raise ValueError("no top cell found")
            cell_name = tops[0]

        out = []
        identity = np.eye(2)

        def walk(name, matrix, offset, depth):
            if depth > max_depth:
                raise ValueError("SREF nesting too deep (cycle?)")
            cell = self.cells[name]
            for poly in cell.polygons:
                xy = poly.xy_nm @ matrix.T + np.asarray(offset)
                out.append(GDSPolygon(poly.layer, poly.datatype, xy))
            for ref in cell.references:
                local = ref.matrix()
                for r in range(ref.rows):
                    for c in range(ref.cols):
                        inst = (np.asarray(ref.origin_nm)
                                + c * np.asarray(ref.col_step_nm)
                                + r * np.asarray(ref.row_step_nm))
                        walk(ref.cell_name, matrix @ local,
                             tuple(np.asarray(offset) + matrix @ inst),
                             depth + 1)

        walk(cell_name, identity, (0.0, 0.0), 0)
        return out


def _real8_to_float(data: bytes) -> float:
    """GDSII 8-byte excess-64 base-16 float."""
    (word,) = struct.unpack(">Q", data)
    if word == 0:
        return 0.0
    sign = -1.0 if word >> 63 else 1.0
    exponent = ((word >> 56) & 0x7F) - 64
    mantissa = (word & 0x00FFFFFFFFFFFFFF) / float(1 << 56)
    return sign * mantissa * (16.0 ** exponent)


def _float_to_real8(value: float) -> bytes:
    if value == 0.0:
        return b"\x00" * 8
    sign = 0
    if value < 0:
        sign = 1
        value = -value
    exponent = 0
    while value >= 1.0:
        value /= 16.0
        exponent += 1
    while value < 1.0 / 16.0:
        value *= 16.0
        exponent -= 1
    mantissa = int(value * (1 << 56))
    mantissa = min(mantissa, (1 << 56) - 1)
    return struct.pack(">Q", (sign << 63) | ((exponent + 64) << 56) | mantissa)


def _disc(center, radius, segments):
    th = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    return center + radius * np.stack([np.cos(th), np.sin(th)], axis=-1)


def path_to_polygons(centerline_nm: np.ndarray, width_nm: float,
                     pathtype: int = 0, *, join: str = "round",
                     miter_limit: float = 4.0,
                     circle_segments: int = 16) -> list:
    """Expand a PATH centerline into union-ready polygons.

    Per-segment rectangles carry the body; ``join`` fills the outer wedge at
    each bend (downstream rasterization unions polygons, so overlaps are
    harmless):

    * ``'round'`` (default) — a disc at each interior vertex: the GDSII
      PATH semantics (the locus within width/2 of the centerline).
    * ``'miter'`` — the outer edges extended to their intersection, falling
      back to bevel past ``miter_limit`` (ratio of miter length to width).
    * ``'bevel'`` — a triangle joining the two outer corners.

    Ends: pathtype 0/4 butt (flush), 1 round caps, 2 extended by half the
    width (Calma GDSII PATHTYPE semantics)."""
    v = np.asarray(centerline_nm, np.float64)
    half = width_nm / 2.0
    if half <= 0 or len(v) < 2:
        return []
    if join not in ("round", "miter", "bevel"):
        raise ValueError(f"unknown path join style {join!r}")
    polys = []
    units = []
    for a, b in zip(v[:-1], v[1:]):
        d = b - a
        length = float(np.hypot(*d))
        if length == 0:
            units.append(None)
            continue
        u = d / length
        units.append(u)
        a_ext, b_ext = a, b
        if pathtype == 2:
            a_ext = a - u * half
            b_ext = b + u * half
        normal = np.array([-u[1], u[0]]) * half
        polys.append(np.array([a_ext + normal, b_ext + normal,
                               b_ext - normal, a_ext - normal]))

    # joins at interior vertices
    for i in range(1, len(v) - 1):
        u_in = units[i - 1]
        u_out = units[i]
        if u_in is None or u_out is None:
            continue
        cross = u_in[0] * u_out[1] - u_in[1] * u_out[0]
        if abs(cross) < 1e-12:  # collinear: nothing to fill
            continue
        p = v[i]
        if join == "round":
            polys.append(_disc(p, half, circle_segments))
            continue
        # outer side: the side the path turns AWAY from
        sign = -1.0 if cross > 0 else 1.0
        n_in = sign * np.array([-u_in[1], u_in[0]]) * half
        n_out = sign * np.array([-u_out[1], u_out[0]]) * half
        c_in = p + n_in    # outer corner of the incoming rectangle
        c_out = p + n_out  # outer corner of the outgoing rectangle
        if join == "bevel":
            polys.append(np.array([p, c_in, c_out]))
            continue
        # miter: intersect the two outer edges (lines through c_in along u_in
        # and c_out along u_out)
        denom = cross
        diff = c_out - c_in
        t = (diff[0] * u_out[1] - diff[1] * u_out[0]) / denom
        m = c_in + t * u_in
        if np.hypot(*(m - p)) > miter_limit * half:
            polys.append(np.array([p, c_in, c_out]))  # bevel fallback
        else:
            polys.append(np.array([p, c_in, m, c_out]))

    if pathtype == 1:  # round caps
        polys.append(_disc(v[0], half, circle_segments))
        polys.append(_disc(v[-1], half, circle_segments))
    return polys


def _records(blob: bytes):
    pos = 0
    while pos + 4 <= len(blob):
        length, rectype, datatype = struct.unpack(">HBB", blob[pos : pos + 4])
        if length < 4:
            break
        yield rectype, datatype, blob[pos + 4 : pos + length]
        pos += length


def read_gds(path) -> GDSLibrary:
    blob = Path(path).read_bytes()
    lib_name = ""
    unit_nm = 1.0
    cells: dict[str, GDSCell] = {}
    cell = None
    element = None  # dict while inside BOUNDARY/BOX/SREF

    for rectype, _dt, payload in _records(blob):
        if rectype == LIBNAME:
            lib_name = payload.rstrip(b"\x00").decode("ascii", "replace")
        elif rectype == UNITS:
            # payload: user-unit-per-db-unit, db-unit-in-meters
            db_unit_m = _real8_to_float(payload[8:16])
            unit_nm = db_unit_m * 1e9
        elif rectype == BGNSTR:
            cell = GDSCell(name="", polygons=[], references=[])
        elif rectype == STRNAME and cell is not None:
            cell.name = payload.rstrip(b"\x00").decode("ascii", "replace")
        elif rectype == ENDSTR and cell is not None:
            cells[cell.name] = cell
            cell = None
        elif rectype in (BOUNDARY, BOX):
            element = {"kind": "poly", "layer": 0, "datatype": 0, "xy": None}
        elif rectype == PATH:
            element = {"kind": "path", "layer": 0, "datatype": 0, "xy": None,
                       "width": 0, "pathtype": 0}
        elif rectype in (SREF, AREF):
            element = {"kind": "ref", "sname": "", "xy": None, "mag": 1.0,
                       "angle": 0.0, "reflect": False, "colrow": (1, 1),
                       "aref": rectype == AREF}
        elif rectype in (TEXT, NODE):
            # annotation elements carry no mask geometry: skip to ENDEL
            kind = "TEXT" if rectype == TEXT else "NODE"
            warnings.warn(
                f"GDSII {kind} element skipped (no mask geometry)",
                stacklevel=2)
            element = {"kind": "skip"}
        elif rectype == LAYER and element is not None:
            element["layer"] = struct.unpack(">h", payload[:2])[0]
        elif rectype in (DATATYPE, BOXTYPE) and element is not None:
            element["datatype"] = struct.unpack(">h", payload[:2])[0]
        elif rectype == WIDTH and element is not None:
            element["width"] = struct.unpack(">i", payload[:4])[0]
        elif rectype == PATHTYPE and element is not None:
            element["pathtype"] = struct.unpack(">h", payload[:2])[0]
        elif rectype == STRANS and element is not None:
            element["reflect"] = bool(struct.unpack(">H", payload[:2])[0] & 0x8000)
        elif rectype == MAG and element is not None:
            element["mag"] = _real8_to_float(payload[:8])
        elif rectype == ANGLE and element is not None:
            element["angle"] = _real8_to_float(payload[:8])
        elif rectype == COLROW and element is not None:
            element["colrow"] = struct.unpack(">hh", payload[:4])
        elif rectype == SNAME and element is not None:
            element["sname"] = payload.rstrip(b"\x00").decode("ascii", "replace")
        elif rectype == XY and element is not None:
            coords = np.frombuffer(payload, dtype=">i4").astype(np.float64)
            element["xy"] = coords.reshape(-1, 2)
        elif rectype == ENDEL and element is not None and cell is not None:
            if element["kind"] == "poly" and element["xy"] is not None:
                xy = element["xy"]
                if len(xy) >= 4 and np.array_equal(xy[0], xy[-1]):
                    xy = xy[:-1]  # drop the repeated closing vertex
                cell.polygons.append(GDSPolygon(
                    element["layer"], element["datatype"], xy * unit_nm))
            elif element["kind"] == "path" and element["xy"] is not None:
                for rect in path_to_polygons(element["xy"] * unit_nm,
                                             element["width"] * unit_nm,
                                             element["pathtype"]):
                    cell.polygons.append(GDSPolygon(
                        element["layer"], element["datatype"], rect))
            elif element["kind"] == "ref" and element["xy"] is not None:
                xy = element["xy"] * unit_nm
                origin = tuple(xy[0])
                cols, rows = (element["colrow"] if element["aref"] else (1, 1))
                col_step = row_step = (0.0, 0.0)
                if element["aref"] and len(xy) >= 3:
                    col_step = tuple((xy[1] - xy[0]) / max(cols, 1))
                    row_step = tuple((xy[2] - xy[0]) / max(rows, 1))
                cell.references.append(GDSRef(
                    cell_name=element["sname"], origin_nm=origin,
                    mag=element["mag"], angle_deg=element["angle"],
                    reflect_x=element["reflect"], cols=cols, rows=rows,
                    col_step_nm=col_step, row_step_nm=row_step))
            element = None
        elif rectype == ENDLIB:
            break

    return GDSLibrary(name=lib_name, unit_nm=unit_nm, cells=cells)


def write_gds(path, cells: dict, *, unit_nm: float = 1.0,
              lib_name: str = "LITHO") -> Path:
    """Write a flat library: ``cells`` maps name -> list of (layer, (v, 2)
    xy-in-nm arrays). Database unit = ``unit_nm`` nanometers."""

    def rec(rectype, datatype, payload=b""):
        return struct.pack(">HBB", 4 + len(payload), rectype, datatype) + payload

    def ascii_rec(rectype, text):
        data = text.encode("ascii")
        if len(data) % 2:
            data += b"\x00"
        return rec(rectype, _DT_ASCII, data)

    ts = struct.pack(">12h", 2026, 1, 1, 0, 0, 0, 2026, 1, 1, 0, 0, 0)
    out = [rec(HEADER, _DT_INT16, struct.pack(">h", 600)),
           rec(BGNLIB, _DT_INT16, ts),
           ascii_rec(LIBNAME, lib_name),
           rec(UNITS, _DT_REAL8,
               _float_to_real8(1e-3) + _float_to_real8(unit_nm * 1e-9))]
    for name, polys in cells.items():
        out.append(rec(BGNSTR, _DT_INT16, ts))
        out.append(ascii_rec(STRNAME, name))
        for layer, xy in polys:
            v = np.asarray(xy, np.float64) / unit_nm
            closed = np.vstack([v, v[:1]]).astype(">i4")
            out.append(rec(BOUNDARY, _DT_NONE))
            out.append(rec(LAYER, _DT_INT16, struct.pack(">h", layer)))
            out.append(rec(DATATYPE, _DT_INT16, struct.pack(">h", 0)))
            out.append(rec(XY, _DT_INT32, closed.tobytes()))
            out.append(rec(ENDEL, _DT_NONE))
        out.append(rec(ENDSTR, _DT_NONE))
    out.append(rec(ENDLIB, _DT_NONE))
    path = Path(path)
    path.write_bytes(b"".join(out))
    return path
