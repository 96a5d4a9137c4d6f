"""OASIS (SEMI P39) reader/writer for mask layout import.

Port of ``lithographysimulator_tpu/io/oasis.py`` (host only), so a file
written by either package reads back to equal polygons in the other.

Parses the subset of OASIS that carries mask geometry: CELL, RECTANGLE,
POLYGON (all six point-list types), PATH (halfwidth + extensions),
PLACEMENT (both forms, incl. magnification/rotation/flip), repetitions
(grid/row/column/arbitrary-offset types 0-5, 8), modal-variable state,
CBLOCK (DEFLATE-compressed blocks), and the CELLNAME/TEXTSTRING reference
tables. TEXT elements and PROPERTY records are parsed and skipped with a
warning (no mask geometry).

Results load into the same :class:`~.gdsii.GDSLibrary` container the GDSII
reader uses, so flattening and rasterization (io/layout.py) are shared.
A minimal writer (:func:`write_oasis`) emits flat cells + placements with
explicit (non-modal) fields for round trips and interchange.
"""

from __future__ import annotations

import struct
import warnings
import zlib
from pathlib import Path

import numpy as np

from .gdsii import GDSCell, GDSLibrary, GDSPolygon, GDSRef, path_to_polygons

MAGIC = b"%SEMI-OASIS\r\n"

# record ids
PAD, START, END = 0, 1, 2
CELLNAME_IMPLICIT, CELLNAME_EXPLICIT = 3, 4
TEXTSTRING_IMPLICIT, TEXTSTRING_EXPLICIT = 5, 6
PROPNAME_IMPLICIT, PROPNAME_EXPLICIT = 7, 8
PROPSTRING_IMPLICIT, PROPSTRING_EXPLICIT = 9, 10
LAYERNAME_DATA, LAYERNAME_TEXT = 11, 12
CELL_REF, CELL_NAME = 13, 14
XYABSOLUTE, XYRELATIVE = 15, 16
PLACEMENT, PLACEMENT_TRANSFORM = 17, 18
TEXT_ELEM, RECTANGLE, POLYGON, PATH_ELEM = 19, 20, 21, 22
TRAPEZOID_AB, TRAPEZOID_A, TRAPEZOID_B = 23, 24, 25
CTRAPEZOID, CIRCLE = 26, 27
PROPERTY_FULL, PROPERTY_REPEAT = 28, 29
XNAME_IMPLICIT, XNAME_EXPLICIT, XELEMENT, XGEOMETRY = 30, 31, 32, 33
CBLOCK = 34


class _Stream:
    """Byte cursor with OASIS primitive decoders."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def raw(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated OASIS stream")
        self.pos += n
        return out

    def uint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def sint(self) -> int:
        u = self.uint()
        mag = u >> 1
        return -mag if u & 1 else mag

    def real(self) -> float:
        kind = self.uint()
        if kind == 0:
            return float(self.uint())
        if kind == 1:
            return -float(self.uint())
        if kind == 2:
            return 1.0 / float(self.uint())
        if kind == 3:
            return -1.0 / float(self.uint())
        if kind == 4:
            return float(self.uint()) / float(self.uint())
        if kind == 5:
            return -float(self.uint()) / float(self.uint())
        if kind == 6:
            return struct.unpack("<f", self.raw(4))[0]
        if kind == 7:
            return struct.unpack("<d", self.raw(8))[0]
        raise ValueError(f"unknown OASIS real type {kind}")

    def string(self) -> bytes:
        return self.raw(self.uint())

    def g_delta(self) -> tuple:
        u = self.uint()
        if u & 1:  # two-integer form: this int is x, next is y
            x = u >> 2
            if u & 2:
                x = -x
            y = self.sint()
            return (x, y)
        direction = (u >> 1) & 0x7
        mag = u >> 4
        return {
            0: (mag, 0), 1: (0, mag), 2: (-mag, 0), 3: (0, -mag),
            4: (mag, mag), 5: (-mag, mag), 6: (-mag, -mag), 7: (mag, -mag),
        }[direction]

    def point_list(self) -> np.ndarray:
        """Vertex deltas following the first (implicit) vertex. Returns the
        (v, 2) vertex array starting at (0, 0)."""
        kind = self.uint()
        count = self.uint()
        deltas = []
        if kind in (0, 1):  # 1-deltas, alternating axes
            horizontal = kind == 0
            for _ in range(count):
                d = self.sint()
                deltas.append((d, 0) if horizontal else (0, d))
                horizontal = not horizontal
        elif kind == 2:  # 2-deltas: direction in 2 LSBs
            for _ in range(count):
                u = self.uint()
                mag = u >> 2
                deltas.append({0: (mag, 0), 1: (0, mag),
                               2: (-mag, 0), 3: (0, -mag)}[u & 3])
        elif kind == 3:  # 3-deltas: direction in 3 LSBs
            for _ in range(count):
                u = self.uint()
                mag = u >> 3
                deltas.append({0: (mag, 0), 1: (0, mag), 2: (-mag, 0),
                               3: (0, -mag), 4: (mag, mag), 5: (-mag, mag),
                               6: (-mag, -mag), 7: (mag, -mag)}[u & 7])
        elif kind == 4:  # g-deltas
            deltas = [self.g_delta() for _ in range(count)]
        elif kind == 5:  # double g-deltas: each is added to the previous
            prev = (0, 0)
            for _ in range(count):
                g = self.g_delta()
                prev = (prev[0] + g[0], prev[1] + g[1])
                deltas.append(prev)
        else:
            raise ValueError(f"unknown OASIS point-list type {kind}")
        pts = np.zeros((len(deltas) + 1, 2), np.float64)
        pts[1:] = np.cumsum(np.asarray(deltas, np.float64), axis=0)
        return pts, kind


    def repetition(self, modal) -> list:
        """Offsets (incl. (0,0)) for a repetition record."""
        kind = self.uint()
        if kind == 0:
            return modal["repetition"]
        offsets = []
        if kind == 1:
            nx = self.uint() + 2
            ny = self.uint() + 2
            dx = self.uint()
            dy = self.uint()
            offsets = [(i * dx, j * dy) for j in range(ny) for i in range(nx)]
        elif kind == 2:
            nx = self.uint() + 2
            dx = self.uint()
            offsets = [(i * dx, 0) for i in range(nx)]
        elif kind == 3:
            ny = self.uint() + 2
            dy = self.uint()
            offsets = [(0, j * dy) for j in range(ny)]
        elif kind == 4:  # explicit x offsets
            n = self.uint() + 2
            xs = np.cumsum([0] + [self.uint() for _ in range(n - 1)])
            offsets = [(int(x), 0) for x in xs]
        elif kind == 5:  # explicit x offsets with grid
            n = self.uint() + 2
            g = self.uint()
            xs = np.cumsum([0] + [self.uint() * g for _ in range(n - 1)])
            offsets = [(int(x), 0) for x in xs]
        elif kind == 6:  # explicit y offsets
            n = self.uint() + 2
            ys = np.cumsum([0] + [self.uint() for _ in range(n - 1)])
            offsets = [(0, int(y)) for y in ys]
        elif kind == 7:  # explicit y offsets with grid
            n = self.uint() + 2
            g = self.uint()
            ys = np.cumsum([0] + [self.uint() * g for _ in range(n - 1)])
            offsets = [(0, int(y)) for y in ys]
        elif kind == 8:  # N x M grid with two g-delta axes
            nn = self.uint() + 2
            mm = self.uint() + 2
            gn = self.g_delta()
            gm = self.g_delta()
            offsets = [(i * gn[0] + j * gm[0], i * gn[1] + j * gm[1])
                       for j in range(mm) for i in range(nn)]
        elif kind in (9, 10, 11):  # arbitrary g-delta lists
            n = self.uint() + 2
            if kind == 9:
                g = self.g_delta()
                offsets = [(i * g[0], i * g[1]) for i in range(n)]
            else:
                grid = self.uint() if kind == 11 else 1
                pos = (0, 0)
                offsets = [pos]
                for _ in range(n - 1):
                    g = self.g_delta()
                    pos = (pos[0] + g[0] * grid, pos[1] + g[1] * grid)
                    offsets.append(pos)
        else:
            raise ValueError(f"unknown OASIS repetition type {kind}")
        modal["repetition"] = offsets
        return offsets


def _close_manhattan(pts: np.ndarray, kind: int) -> np.ndarray:
    """Polygon point lists of type 0/1 have one extra IMPLICIT vertex: the
    alternation continues for one more axis-aligned edge before the closure
    edge along the other axis (OASIS 7.7.8)."""
    if kind not in (0, 1):
        return pts
    count = len(pts) - 1  # explicit deltas
    # next edge axis continues the alternation
    horizontal_next = (kind == 0) == (count % 2 == 0)
    last = pts[-1]
    first = pts[0]
    implied = (np.array([first[0], last[1]]) if horizontal_next
               else np.array([last[0], first[1]]))
    return np.vstack([pts, implied])


def _skip_property(s: _Stream, info: int):
    """Parse (and discard) a PROPERTY record's fields."""
    # info bits: UUUU VCNS
    if info & 0x04:  # C: name present
        if info & 0x02:  # N: as reference number
            s.uint()
        else:
            s.string()
    value_count = (info >> 4) & 0xF
    if not info & 0x08:  # V=0: value list present
        if value_count == 15:
            value_count = s.uint()
        for _ in range(value_count):
            kind = s.uint()
            if kind <= 7:
                # re-dispatch real parse for this kind
                if kind in (0, 1, 2, 3):
                    s.uint()
                elif kind in (4, 5):
                    s.uint()
                    s.uint()
                elif kind == 6:
                    s.raw(4)
                else:
                    s.raw(8)
            elif kind == 8:
                s.uint()
            elif kind == 9:
                s.sint()
            elif kind in (10, 11, 12):
                s.string()
            elif kind in (13, 14, 15):
                s.uint()
            else:
                raise ValueError(f"unknown property value type {kind}")


def read_oasis(path) -> GDSLibrary:
    blob = Path(path).read_bytes()
    if not blob.startswith(MAGIC):
        raise ValueError("not an OASIS file (bad magic)")
    s = _Stream(blob[len(MAGIC):])

    unit_per_um = 1000.0
    cellnames: dict[int, str] = {}
    next_cellname_ref = 0
    cells: dict[str, GDSCell] = {}
    cell: GDSCell | None = None
    warned_text = False

    modal = {
        "layer": 0, "datatype": 0, "x": 0, "y": 0, "xy_absolute": True,
        "geometry_w": 0, "geometry_h": 0, "path_halfwidth": 0,
        "path_start_ext": 0, "path_end_ext": 0, "polygon_points": None,
        "path_points": None, "placement_cell": None, "repetition": [(0, 0)],
        "textlayer": 0, "texttype": 0, "text_x": 0, "text_y": 0,
    }

    def new_cell(name):
        nonlocal cell
        cell = GDSCell(name=name, polygons=[], references=[])
        cells[name] = cell
        # modal variables reset at each CELL record (OASIS 10.1)
        modal.update(x=0, y=0, xy_absolute=True, repetition=[(0, 0)],
                     polygon_points=None, path_points=None,
                     placement_cell=None)

    def setxy(s_, info, xbit, ybit):
        if info & xbit:
            dx = s_.sint()
            modal["x"] = dx if modal["xy_absolute"] else modal["x"] + dx
        if info & ybit:
            dy = s_.sint()
            modal["y"] = dy if modal["xy_absolute"] else modal["y"] + dy

    while not s.eof():
        rec = s.uint()
        if rec == PAD:
            continue
        if rec == START:
            version = s.string()
            if version != b"1.0":
                warnings.warn(f"OASIS version {version!r} != 1.0")
            unit_per_um = s.real()
            offset_flag = s.uint()
            if offset_flag == 0:
                for _ in range(12):
                    s.uint()  # table offsets stored here
        elif rec == END:
            break
        elif rec in (CELLNAME_IMPLICIT, CELLNAME_EXPLICIT):
            name = s.string().decode("ascii", "replace")
            if rec == CELLNAME_EXPLICIT:
                ref = s.uint()
            else:
                ref = next_cellname_ref
                next_cellname_ref += 1
            cellnames[ref] = name
        elif rec in (TEXTSTRING_IMPLICIT, TEXTSTRING_EXPLICIT,
                     PROPNAME_IMPLICIT, PROPNAME_EXPLICIT,
                     PROPSTRING_IMPLICIT, PROPSTRING_EXPLICIT):
            s.string()
            if rec in (TEXTSTRING_EXPLICIT, PROPNAME_EXPLICIT,
                       PROPSTRING_EXPLICIT):
                s.uint()
        elif rec in (LAYERNAME_DATA, LAYERNAME_TEXT):
            s.string()
            for _ in range(2):  # two interval specs
                kind = s.uint()
                if kind in (1, 2, 3):
                    s.uint()
                elif kind == 4:
                    s.uint()
                    s.uint()
        elif rec == CELL_REF:
            new_cell(cellnames.get(s.uint(), f"#cell{len(cells)}"))
        elif rec == CELL_NAME:
            new_cell(s.string().decode("ascii", "replace"))
        elif rec == XYABSOLUTE:
            modal["xy_absolute"] = True
        elif rec == XYRELATIVE:
            modal["xy_absolute"] = False
        elif rec in (PLACEMENT, PLACEMENT_TRANSFORM):
            info = s.byte()
            # bits: C N X Y R [MA]/[AA] F
            mag, angle = 1.0, 0.0
            if info & 0x80:  # C: cell reference present
                if info & 0x40:  # N: by reference number
                    # defer name lookup to the end (forward references)
                    modal["placement_cell"] = ("#ref", s.uint())
                else:
                    modal["placement_cell"] = s.string().decode(
                        "ascii", "replace")
            if rec == PLACEMENT_TRANSFORM:
                if info & 0x04:  # M: magnification real
                    mag = s.real()
                if info & 0x02:  # A: angle real
                    angle = s.real()
            else:
                angle = 90.0 * ((info >> 1) & 0x3)
            flip = bool(info & 0x01)
            setxy(s, info, 0x20, 0x10)
            offsets = (s.repetition(modal) if info & 0x08 else [(0, 0)])
            scale = 1000.0 / unit_per_um  # db units -> nm
            for ox, oy in offsets:
                cell.references.append(GDSRef(
                    cell_name=modal["placement_cell"],
                    origin_nm=((modal["x"] + ox) * scale,
                               (modal["y"] + oy) * scale),
                    mag=mag, angle_deg=angle, reflect_x=flip))
        elif rec == RECTANGLE:
            info = s.byte()  # S W H X Y R D L
            if info & 0x01:
                modal["layer"] = s.uint()
            if info & 0x02:
                modal["datatype"] = s.uint()
            if info & 0x40:
                modal["geometry_w"] = s.uint()
            if info & 0x20:
                modal["geometry_h"] = s.uint()
            if info & 0x80:  # square
                modal["geometry_h"] = modal["geometry_w"]
            setxy(s, info, 0x10, 0x08)
            offsets = (s.repetition(modal) if info & 0x04 else [(0, 0)])
            w, h = modal["geometry_w"], modal["geometry_h"]
            scale = 1000.0 / unit_per_um
            for ox, oy in offsets:
                x0 = (modal["x"] + ox) * scale
                y0 = (modal["y"] + oy) * scale
                cell.polygons.append(GDSPolygon(
                    modal["layer"], modal["datatype"],
                    np.array([[x0, y0], [x0 + w * scale, y0],
                              [x0 + w * scale, y0 + h * scale],
                              [x0, y0 + h * scale]])))
        elif rec == POLYGON:
            info = s.byte()  # 0 0 P X Y R D L
            if info & 0x01:
                modal["layer"] = s.uint()
            if info & 0x02:
                modal["datatype"] = s.uint()
            if info & 0x20:
                pts_k, kind_k = s.point_list()
                modal["polygon_points"] = _close_manhattan(pts_k, kind_k)
            setxy(s, info, 0x10, 0x08)
            offsets = (s.repetition(modal) if info & 0x04 else [(0, 0)])
            pts = modal["polygon_points"]
            if pts is None:
                raise ValueError("POLYGON with no modal point list")
            scale = 1000.0 / unit_per_um
            for ox, oy in offsets:
                xy = (pts + np.array([modal["x"] + ox, modal["y"] + oy])) * scale
                cell.polygons.append(GDSPolygon(
                    modal["layer"], modal["datatype"], xy))
        elif rec == PATH_ELEM:
            info = s.byte()  # E W P X Y R D L
            if info & 0x01:
                modal["layer"] = s.uint()
            if info & 0x02:
                modal["datatype"] = s.uint()
            if info & 0x40:
                modal["path_halfwidth"] = s.uint()
            if info & 0x80:  # extension scheme
                scheme = s.uint()
                ss = (scheme >> 2) & 0x3
                ee = scheme & 0x3
                if ss == 3:
                    modal["path_start_ext"] = s.sint()
                elif ss == 2:
                    modal["path_start_ext"] = modal["path_halfwidth"]
                elif ss == 1:
                    modal["path_start_ext"] = 0
                if ee == 3:
                    modal["path_end_ext"] = s.sint()
                elif ee == 2:
                    modal["path_end_ext"] = modal["path_halfwidth"]
                elif ee == 1:
                    modal["path_end_ext"] = 0
            if info & 0x20:
                modal["path_points"], _ = s.point_list()
            setxy(s, info, 0x10, 0x08)
            offsets = (s.repetition(modal) if info & 0x04 else [(0, 0)])
            pts = modal["path_points"]
            if pts is None:
                raise ValueError("PATH with no modal point list")
            scale = 1000.0 / unit_per_um
            half = modal["path_halfwidth"]
            for ox, oy in offsets:
                center = (pts + np.array([modal["x"] + ox,
                                          modal["y"] + oy])) * scale
                # apply explicit end extensions along the end segments
                c = center.copy()
                if len(c) >= 2:
                    d0 = c[1] - c[0]
                    dl = c[-1] - c[-2]
                    n0 = np.hypot(*d0) or 1.0
                    nl = np.hypot(*dl) or 1.0
                    c[0] = c[0] - d0 / n0 * modal["path_start_ext"] * scale
                    c[-1] = c[-1] + dl / nl * modal["path_end_ext"] * scale
                for poly in path_to_polygons(c, 2.0 * half * scale):
                    cell.polygons.append(GDSPolygon(
                        modal["layer"], modal["datatype"], poly))
        elif rec == TEXT_ELEM:
            if not warned_text:
                warnings.warn("OASIS TEXT element skipped (no mask geometry)")
                warned_text = True
            info = s.byte()  # 0 C N X Y R T L
            if info & 0x01:
                modal["textlayer"] = s.uint()
            if info & 0x02:
                modal["texttype"] = s.uint()
            if info & 0x40:  # C: text string
                if info & 0x20:  # N: refnum
                    s.uint()
                else:
                    s.string()
            setxy(s, info, 0x10, 0x08)
            if info & 0x04:
                s.repetition(modal)
        elif rec == PROPERTY_FULL:
            _skip_property(s, s.byte())
        elif rec == PROPERTY_REPEAT:
            pass
        elif rec == CBLOCK:
            comp = s.uint()
            if comp != 0:
                raise ValueError(f"unknown CBLOCK compression {comp}")
            s.uint()  # uncompressed byte count
            comp_bytes = s.uint()
            payload = zlib.decompress(s.raw(comp_bytes), wbits=-15)
            # splice the decompressed bytes in place of the block
            s.data = s.data[:s.pos] + payload + s.data[s.pos:]
        else:
            raise ValueError(f"unsupported OASIS record id {rec}")

    # resolve placements that referenced cellname numbers (possibly forward)
    for c in cells.values():
        for i, ref in enumerate(c.references):
            if isinstance(ref.cell_name, tuple):
                num = ref.cell_name[1]
                if num not in cellnames:
                    raise ValueError(f"placement references unknown cellname {num}")
                c.references[i] = GDSRef(
                    cell_name=cellnames[num], origin_nm=ref.origin_nm,
                    mag=ref.mag, angle_deg=ref.angle_deg,
                    reflect_x=ref.reflect_x)

    return GDSLibrary(name="OASIS", unit_nm=1000.0 / unit_per_um, cells=cells)


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def _uint(v: int) -> bytes:
    out = bytearray()
    v = int(v)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _sint(v: int) -> bytes:
    v = int(v)
    return _uint((abs(v) << 1) | (1 if v < 0 else 0))


def _real_f64(v: float) -> bytes:
    return _uint(7) + struct.pack("<d", v)


def _string(text: str) -> bytes:
    data = text.encode("ascii")
    return _uint(len(data)) + data


def _g_delta(dx: int, dy: int) -> bytes:
    # always the two-integer form for simplicity
    return _uint((abs(int(dx)) << 2) | (2 if dx < 0 else 0) | 1) + _sint(dy)


def write_oasis(path, cells: dict, *, unit_nm: float = 1.0,
                placements: dict | None = None) -> Path:
    """Write a library: ``cells`` maps name -> list of (layer, (v, 2)
    xy-in-nm arrays); optional ``placements`` maps name -> list of
    (cell_name, (x_nm, y_nm), mag, angle_deg, flip). Database unit =
    ``unit_nm`` nanometers."""
    unit_per_um = 1000.0 / unit_nm
    out = [MAGIC, _uint(START), _string("1.0"), _real_f64(unit_per_um),
           _uint(0)] + [_uint(0)] * 12
    for name, polys in cells.items():
        out.append(_uint(CELL_NAME))
        out.append(_string(name))
        out.append(_uint(XYABSOLUTE))
        for layer, xy in polys:
            v = np.round(np.asarray(xy, np.float64) / unit_nm).astype(int)
            deltas = np.diff(v, axis=0)
            out.append(_uint(POLYGON))
            out.append(bytes([0x20 | 0x10 | 0x08 | 0x02 | 0x01]))  # P X Y D L
            out.append(_uint(layer))
            out.append(_uint(0))  # datatype
            out.append(_uint(4))  # point-list type 4 (g-deltas)
            out.append(_uint(len(deltas)))
            for dx, dy in deltas:
                out.append(_g_delta(dx, dy))
            out.append(_sint(v[0, 0]))
            out.append(_sint(v[0, 1]))
        for ref in (placements or {}).get(name, ()):
            cell_name, (x, y), mag, angle, flip = ref
            out.append(_uint(PLACEMENT_TRANSFORM))
            info = 0x80 | 0x20 | 0x10 | 0x04 | 0x02 | (0x01 if flip else 0)
            out.append(bytes([info]))
            out.append(_string(cell_name))
            out.append(_real_f64(mag))
            out.append(_real_f64(angle))
            out.append(_sint(round(x / unit_nm)))
            out.append(_sint(round(y / unit_nm)))
    out.append(_uint(END))
    end_payload = b"".join([b"\x00" * 253, _uint(0)])  # pad + validation 0
    out.append(end_payload)
    path = Path(path)
    path.write_bytes(b"".join(out))
    return path
