"""KiCad project loader: .kicad_pcb/.kicad_sch -> problem.Problem.

Architectural departure from the reference: padne shells out to pcbnew to
plot Gerbers and re-vectorizes them with pygerber (kicad.py:1263-1396).
This loader parses the KiCad s-expression files directly and renders the
copper primitives (zone fills, track segments/arcs, pads, via annular
rings, copper graphics) straight into the exact-grid geometry engine —
no KiCad installation required, and no raster/vector round trip.

Behavioral parity targets (reference padne/kicad.py):
  * stackup extraction incl. the 2-layer fallback (:139-225)
  * directive grammar and the spec classes building Networks — star
    coupling resistors, 0 V glue sources, ESR, PROBE, COPPER (:432-798)
  * via/THT modeling: hollow-cylinder resistance, per-boundary-point
    parallel resistor stacks, hole punching (:801-836, 1497-1629)
  * board outline clipping (:1675-1689), SMD pad indexing with geometry
    validation (:296-418)
"""

from __future__ import annotations

import collections
import logging
import math
import pathlib
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np

from . import geom, problem, sexp, spans, units
from .utils.validation import checked

log = logging.getLogger(__name__)

# Copper conductivity in S/mm (not S/m!) — reference kicad.py:79.
COPPER_CONDUCTIVITY = 5.95e4

# Tessellation of round copper shapes (pads, via annular rings).
ROUND_COPPER_SEGMENTS = 32
# Tessellation of drill-hole punch shapes; matches the reference's
# shapely buffer(quad_segs=4) 16-gon (kicad.py:814).
DRILL_SEGMENTS = 16


def _rot(theta_deg: float, x: float, y: float) -> tuple[float, float]:
    """KiCad rotation in file coordinates (y axis points down): positive
    angles rotate counterclockwise on screen, which is clockwise in math
    convention.  Verified against fixture boards."""
    t = math.radians(theta_deg)
    c, s = math.cos(t), math.sin(t)
    return (x * c + y * s, -x * s + y * c)


# ---------------------------------------------------------------------------
# Project files
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class KiCadProject:
    pro_path: Path
    pcb_path: Path
    sch_path: Path

    @property
    def name(self) -> str:
        return self.pro_path.stem

    @classmethod
    def from_pro_file(cls, pro_file_path: Path) -> "KiCadProject":
        pro_file_path = Path(pro_file_path)
        if not pro_file_path.exists():
            raise FileNotFoundError(f"Project file not found: {pro_file_path}")
        base = pro_file_path.stem
        pcb = pro_file_path.parent / f"{base}.kicad_pcb"
        if not pcb.exists():
            raise FileNotFoundError(f"PCB file not found: {pcb}")
        sch = pro_file_path.parent / f"{base}.kicad_sch"
        if not sch.exists():
            raise FileNotFoundError(f"Schematic file not found: {sch}")
        return cls(pro_path=pro_file_path, pcb_path=pcb, sch_path=sch)


# ---------------------------------------------------------------------------
# Stackup
# ---------------------------------------------------------------------------
@dataclass
class StackupItem:
    name: str
    thickness: float
    conductivity: Optional[float] = None  # S/mm

    @property
    def conductance(self) -> float:
        return self.thickness * self.conductivity


@dataclass
class Stackup:
    items: list[StackupItem]

    def index_by_name(self, name: str) -> int:
        return next(i for i, item in enumerate(self.items) if item.name == name)


def extract_copper_layer_names(pcb_tree) -> list[str]:
    """Enabled copper layers in file order (the layers table lists exactly
    the enabled layers; copper layers are the *.Cu entries)."""
    layers = sexp.find_child(pcb_tree, "layers")
    if layers is None:
        raise ValueError("PCB file has no layers table")
    names = []
    for entry in layers[1:]:
        if isinstance(entry, list) and len(entry) >= 2:
            name = entry[1]
            if isinstance(name, str) and name.endswith(".Cu"):
                names.append(name)
    return names


def extract_stackup(pcb_tree, copper_conductivity: float = COPPER_CONDUCTIVITY) -> Stackup:
    """Stackup from the (setup (stackup ...)) section; default 2-layer
    stackup when absent (reference kicad.py:170-181)."""
    setup = sexp.find_child(pcb_tree, "setup")
    stackup = sexp.find_child(setup, "stackup") if setup else None
    if stackup is None:
        return Stackup(
            items=[
                StackupItem("F.Cu", 0.035, copper_conductivity),
                StackupItem("dielectric 1", 1.51),
                StackupItem("B.Cu", 0.035, copper_conductivity),
            ]
        )
    items = []
    for item in sexp.find_children(stackup, "layer"):
        name = item[1]
        layer_type = None
        thickness = None
        conductivity = None
        for prop in item[2:]:
            if not isinstance(prop, list) or len(prop) < 2:
                continue
            head = str(prop[0])
            if head == "type":
                tstr = str(prop[1]).lower()
                if "copper" in tstr:
                    layer_type = "copper"
                    conductivity = copper_conductivity
                elif "core" in tstr or "prepreg" in tstr:
                    layer_type = "dielectric"
            elif head == "thickness":
                thickness = float(prop[1])
        if layer_type is None or thickness is None:
            continue
        items.append(StackupItem(name, thickness, conductivity))
    return Stackup(items=items)


# ---------------------------------------------------------------------------
# Geometry primitives from PCB items
# ---------------------------------------------------------------------------
def _arc_points(start, mid, end) -> np.ndarray:
    """Tessellate a 3-point arc into a polyline (including endpoints)."""
    (x1, y1), (x2, y2), (x3, y3) = start, mid, end
    # Circumcenter of the three points.
    d = 2 * (x1 * (y2 - y3) + x2 * (y3 - y1) + x3 * (y1 - y2))
    if abs(d) < 1e-12:
        return np.array([start, end], dtype=np.float64)
    ux = ((x1**2 + y1**2) * (y2 - y3) + (x2**2 + y2**2) * (y3 - y1)
          + (x3**2 + y3**2) * (y1 - y2)) / d
    uy = ((x1**2 + y1**2) * (x3 - x2) + (x2**2 + y2**2) * (x1 - x3)
          + (x3**2 + y3**2) * (x2 - x1)) / d
    r = math.hypot(x1 - ux, y1 - uy)
    a1 = math.atan2(y1 - uy, x1 - ux)
    a2 = math.atan2(y2 - uy, x2 - ux)
    a3 = math.atan2(y3 - uy, x3 - ux)

    # Sweep from a1 through a2 to a3.
    def norm(a):
        while a < 0:
            a += 2 * math.pi
        return a

    sweep_12 = norm(a2 - a1)
    sweep_13 = norm(a3 - a1)
    if sweep_12 <= sweep_13:
        total = sweep_13  # counterclockwise (in file coords)
        sign = 1.0
    else:
        total = 2 * math.pi - sweep_13
        sign = -1.0
    # Segment count ~ reference pygerber config: 0.4/deg + 10.
    nseg = max(4, int(math.degrees(total) * 0.4 + 10))
    ts = np.linspace(0.0, total, nseg + 1)
    angs = a1 + sign * ts
    return np.stack([ux + r * np.cos(angs), uy + r * np.sin(angs)], axis=1)


def _get_xy(node, head):
    child = sexp.find_child(node, head)
    if child is None:
        return None
    return (float(child[1]), float(child[2]))


def _get_num(node, head, default=None):
    child = sexp.find_child(node, head)
    if child is None:
        return default
    return float(child[1])


def _item_layers(node) -> list[str]:
    """Layer names an item applies to ('*.Cu' wildcards not expanded)."""
    lay = sexp.find_child(node, "layer")
    if lay is not None:
        return [str(lay[1])]
    lays = sexp.find_child(node, "layers")
    if lays is not None:
        return [str(x) for x in lays[1:] if isinstance(x, str)]
    return []


def _expand_layer_wildcards(names: list[str], copper_names: list[str]) -> list[str]:
    out = []
    for n in names:
        if n in ("*.Cu", "F&B.Cu"):
            out.extend(copper_names if n == "*.Cu" else
                       [c for c in copper_names if c in ("F.Cu", "B.Cu")])
        elif n.endswith(".Cu") and n in copper_names:
            out.append(n)
    return out


def _stroke_polyline(pts: np.ndarray, width: float) -> list[geom.Polygon]:
    out = []
    for i in range(len(pts) - 1):
        out.append(
            geom.stroke_segment(
                pts[i][0], pts[i][1], pts[i + 1][0], pts[i + 1][1], width
            )
        )
    return out


def _graphic_to_polys(item, head: str) -> list[geom.Polygon]:
    """Render a gr_* / fp_* graphic item (already in absolute coords)."""
    kind = head.split("_", 1)[1]
    width = _get_num(item, "width")
    if width is None:
        stroke = sexp.find_child(item, "stroke")
        width = _get_num(stroke, "width", 0.0) if stroke else 0.0
    fill_node = sexp.find_child(item, "fill")
    filled = False
    if fill_node is not None and len(fill_node) > 1:
        filled = str(fill_node[1]) in ("solid", "yes")

    if kind == "line":
        a, b = _get_xy(item, "start"), _get_xy(item, "end")
        if a and b and width > 0:
            return [geom.stroke_segment(a[0], a[1], b[0], b[1], width)]
        return []
    if kind == "rect":
        a, b = _get_xy(item, "start"), _get_xy(item, "end")
        if not (a and b):
            return []
        ring = np.array(
            [[a[0], a[1]], [b[0], a[1]], [b[0], b[1]], [a[0], b[1]]]
        )
        polys = []
        if filled:
            polys.append(geom.Polygon(ring))
        if width > 0:
            polys.extend(geom.stroke_ring(ring, width))
        return polys
    if kind == "circle":
        c, e = _get_xy(item, "center"), _get_xy(item, "end")
        if not (c and e):
            return []
        r = math.hypot(e[0] - c[0], e[1] - c[1])
        polys = []
        if filled:
            polys.append(geom.circle(c[0], c[1], r, ROUND_COPPER_SEGMENTS))
        if width > 0:
            outer = geom.circle(c[0], c[1], r + width / 2, ROUND_COPPER_SEGMENTS)
            if filled:
                polys.append(outer)
            else:
                ring = geom.circle(c[0], c[1], r, 64).exterior
                polys.extend(_stroke_polyline(
                    np.vstack([ring, ring[:1]]), width))
        return polys
    if kind == "arc":
        s, m, e = (_get_xy(item, "start"), _get_xy(item, "mid"),
                   _get_xy(item, "end"))
        if s and m and e and width > 0:
            return _stroke_polyline(_arc_points(s, m, e), width)
        return []
    if kind == "poly":
        pts_node = sexp.find_child(item, "pts")
        if pts_node is None:
            return []
        ring = np.array(
            [[float(p[1]), float(p[2])] for p in pts_node[1:]
             if sexp.is_list_with_head(p, "xy")]
        )
        if len(ring) < 3:
            return []
        polys = [geom.Polygon(ring)]
        if width > 0:
            polys.extend(geom.stroke_ring(ring, width))
        return polys
    return []


def pad_shape_polygon(pad, abs_x: float, abs_y: float, angle: float
                      ) -> Optional[geom.Polygon]:
    """Copper polygon of a pad, positioned and rotated.

    Supported shapes: circle, rect, oval, roundrect, trapezoid, custom
    (primitives approximated via gr_poly/gr_line/gr_circle union handled
    by the caller's layer union).
    """
    shape = None
    for tok in pad[1:]:
        if isinstance(tok, sexp.Symbol) and tok in (
            "circle", "rect", "oval", "roundrect", "trapezoid", "custom"
        ):
            shape = str(tok)
            break
    size = _get_xy(pad, "size") or (0.0, 0.0)
    sx, sy = size

    def place(local_pts: np.ndarray) -> geom.Polygon:
        out = np.empty_like(local_pts)
        for i, (px, py) in enumerate(local_pts):
            rx, ry = _rot(angle, px, py)
            out[i] = (abs_x + rx, abs_y + ry)
        return geom.Polygon(out)

    if shape == "circle":
        return geom.circle(abs_x, abs_y, sx / 2, ROUND_COPPER_SEGMENTS)
    if shape == "rect":
        return place(np.array([
            [-sx / 2, -sy / 2], [sx / 2, -sy / 2],
            [sx / 2, sy / 2], [-sx / 2, sy / 2]]))
    if shape == "oval":
        # Stadium along the longer axis.
        if sx >= sy:
            half = (sx - sy) / 2
            pts = _stadium_points(half, sy / 2, horizontal=True)
        else:
            half = (sy - sx) / 2
            pts = _stadium_points(half, sx / 2, horizontal=False)
        return place(pts)
    if shape == "roundrect":
        rratio = _get_num(pad, "roundrect_rratio", 0.25)
        r = rratio * min(sx, sy)
        return place(_roundrect_points(sx, sy, r))
    if shape == "trapezoid":
        delta = _get_xy(pad, "rect_delta") or (0.0, 0.0)
        dx, dy = delta
        return place(np.array([
            [-sx / 2 - dy / 2, -sy / 2 + dx / 2],
            [sx / 2 + dy / 2, -sy / 2 - dx / 2],
            [sx / 2 - dy / 2, sy / 2 + dx / 2],
            [-sx / 2 + dy / 2, sy / 2 - dx / 2]]))
    if shape == "custom":
        # Approximate with the anchor shape (circle/rect of `size`).
        return geom.circle(abs_x, abs_y, max(sx, sy) / 2 or 0.5,
                           ROUND_COPPER_SEGMENTS)
    return None


def _stadium_points(half_len: float, r: float, horizontal: bool) -> np.ndarray:
    pts = []
    n = ROUND_COPPER_SEGMENTS // 2
    for i in range(n + 1):
        th = -math.pi / 2 + math.pi * i / n
        pts.append((half_len + r * math.cos(th), r * math.sin(th)))
    for i in range(n + 1):
        th = math.pi / 2 + math.pi * i / n
        pts.append((-half_len + r * math.cos(th), r * math.sin(th)))
    arr = np.array(pts)
    if not horizontal:
        arr = arr[:, ::-1].copy()
    return arr


def _roundrect_points(sx: float, sy: float, r: float) -> np.ndarray:
    r = min(r, sx / 2, sy / 2)
    n = max(2, ROUND_COPPER_SEGMENTS // 4)
    corners = [
        (sx / 2 - r, sy / 2 - r, 0.0),
        (-sx / 2 + r, sy / 2 - r, math.pi / 2),
        (-sx / 2 + r, -sy / 2 + r, math.pi),
        (sx / 2 - r, -sy / 2 + r, 3 * math.pi / 2),
    ]
    pts = []
    for cx, cy, a0 in corners:
        for i in range(n + 1):
            th = a0 + (math.pi / 2) * i / n
            pts.append((cx + r * math.cos(th), cy + r * math.sin(th)))
    return np.array(pts)


# ---------------------------------------------------------------------------
# Footprints and pads
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Endpoint:
    designator: str
    pad: str


@dataclass(frozen=True)
class LayerPoint:
    layer: str
    point: geom.Point


@dataclass
class PadInfo:
    endpoint: Endpoint
    kind: str            # "smd" | "thru_hole" | "np_thru_hole" | "connect"
    abs_x: float
    abs_y: float
    angle: float
    layers: list[str]    # expanded copper layer names
    shape_poly: Optional[geom.Polygon]
    drill: float         # 0 for SMD
    pad_node: Any


def footprint_reference(fp) -> str:
    for prop in sexp.find_children(fp, "property"):
        if len(prop) >= 3 and prop[1] == "Reference":
            return str(prop[2])
    # Older format: (fp_text reference "R1" ...)
    for t in sexp.find_children(fp, "fp_text"):
        if len(t) >= 3 and str(t[1]) == "reference":
            return str(t[2])
    return "?"


def find_pad_location(pcb_source, ref: str) -> tuple[float, float, str]:
    """Resolve a pad reference like "TP3" or "J4.2" to (x_mm, y_mm,
    copper_layer_name).

    A bare designator is allowed when the footprint has exactly one pad
    (bench probing convention, reference tests/test_sets.py:176-198).
    pcb_source: a .kicad_pcb path or an already parsed s-expression tree.
    """
    if isinstance(pcb_source, (str, Path)):
        pcb_tree = sexp.loads(Path(pcb_source).read_text())
    else:
        pcb_tree = pcb_source
    copper_names = extract_copper_layer_names(pcb_tree)
    designator, _, pad_name = ref.partition(".")
    matches = [
        p for p in iter_pads(pcb_tree, copper_names)
        if p.endpoint.designator == designator
        and (not pad_name or p.endpoint.pad == pad_name)
    ]
    if not matches:
        raise ValueError(f"No pad matching reference {ref!r}")
    if not pad_name and len(matches) > 1:
        raise ValueError(
            f"{designator!r} has {len(matches)} pads; "
            f"use {designator}.<pad> to pick one"
        )
    p = matches[0]
    layer = p.layers[0] if p.layers else "F.Cu"
    return p.abs_x, p.abs_y, layer


def iter_pads(pcb_tree, copper_names: list[str]):
    """Yield PadInfo for every pad of every footprint."""
    for fp in sexp.find_children(pcb_tree, "footprint"):
        at = sexp.find_child(fp, "at")
        fx, fy = float(at[1]), float(at[2])
        fangle = float(at[3]) if len(at) > 3 else 0.0
        ref = footprint_reference(fp)
        for pad in sexp.find_children(fp, "pad"):
            name = str(pad[1])
            kind = str(pad[2]) if len(pad) > 2 else "smd"
            pat = sexp.find_child(pad, "at")
            px = float(pat[1]) if pat else 0.0
            py = float(pat[2]) if pat else 0.0
            pangle = float(pat[3]) if pat and len(pat) > 3 else 0.0
            rx, ry = _rot(fangle, px, py)
            ax, ay = fx + rx, fy + ry
            layer_names = _expand_layer_wildcards(_item_layers(pad), copper_names)
            drill = 0.0
            drill_node = sexp.find_child(pad, "drill")
            if drill_node is not None:
                nums = [x for x in drill_node[1:] if isinstance(x, (int, float))]
                if nums:
                    drill = float(sum(nums) / len(nums))
            shape = pad_shape_polygon(pad, ax, ay, pangle)
            yield PadInfo(
                endpoint=Endpoint(designator=ref, pad=name),
                kind=kind,
                abs_x=ax,
                abs_y=ay,
                angle=pangle,
                layers=layer_names,
                shape_poly=shape,
                drill=drill,
                pad_node=pad,
            )


# ---------------------------------------------------------------------------
# Copper rendering
# ---------------------------------------------------------------------------
def render_copper_primitives(pcb_tree, copper_names: list[str]
                             ) -> dict[str, list[geom.Polygon]]:
    """All copper polygons per layer (pre-union)."""
    prims: dict[str, list[geom.Polygon]] = {name: [] for name in copper_names}

    def add(layer: str, poly_or_list):
        if layer not in prims:
            return
        if isinstance(poly_or_list, list):
            prims[layer].extend(poly_or_list)
        elif poly_or_list is not None:
            prims[layer].append(poly_or_list)

    # Track segments.
    for seg in sexp.find_children(pcb_tree, "segment"):
        a, b = _get_xy(seg, "start"), _get_xy(seg, "end")
        w = _get_num(seg, "width", 0.0)
        for layer in _item_layers(seg):
            if a and b and w > 0:
                add(layer, geom.stroke_segment(a[0], a[1], b[0], b[1], w))

    # Track arcs.
    for arc in sexp.find_children(pcb_tree, "arc"):
        s, m, e = (_get_xy(arc, "start"), _get_xy(arc, "mid"),
                   _get_xy(arc, "end"))
        w = _get_num(arc, "width", 0.0)
        for layer in _item_layers(arc):
            if s and m and e and w > 0:
                add(layer, _stroke_polyline(_arc_points(s, m, e), w))

    # Vias: annular copper of diameter `size` on every spanned layer.
    for via in sexp.find_children(pcb_tree, "via"):
        pos = _get_xy(via, "at")
        size = _get_num(via, "size", 0.0)
        span = _expand_layer_wildcards(_item_layers(via), copper_names)
        if not span:
            span = list(copper_names)  # through via
        # Through vias connect every copper layer even if the file lists
        # only the outer pair.
        if set(span) >= {"F.Cu", "B.Cu"}:
            span = list(copper_names)
        if pos and size > 0:
            for layer in span:
                add(layer, geom.circle(pos[0], pos[1], size / 2,
                                       ROUND_COPPER_SEGMENTS))

    # Zones: stored filled polygons (+ outline stroke of min_thickness
    # when filled_areas_thickness is "no", matching the plot behavior the
    # reference captures via Gerbers).
    for zone in sexp.find_children(pcb_tree, "zone"):
        # Rule areas ("keepout" zones) are fill constraints, not copper:
        # real zones' stored fills already avoid them, and KiCad files
        # can carry stale fill/outline data inside the rule area itself —
        # rendering it would bridge the very slots the keepout cuts
        # (test_set_1's resistance strips are slotted exactly this way).
        if sexp.find_child(zone, "keepout") is not None:
            continue
        min_thickness = _get_num(zone, "min_thickness", 0.0)
        # "(filled_areas_thickness no)" (KiCad 6+) marks stored fill
        # polygons as the EXACT final copper — plot them as-is.  Legacy
        # files (token absent, KiCad 5 "thick fill" mode) store fills
        # deflated by min_thickness/2 and expect the plotter to stroke
        # the outline back on.  Stroking a modern fill instead bridges
        # narrow fill voids: test_set_1's slotted resistance strips
        # (0.2 mm keepout slots vs 0.25 mm min_thickness) turned solid,
        # under-predicting the four plane readings ~4x.
        fat = sexp.find_child(zone, "filled_areas_thickness")
        stroke_outline = fat is None or str(fat[1]) != "no"
        fills = sexp.find_children(zone, "filled_polygon")
        if not fills:
            # A zone saved without refilling stores no filled_polygon:
            # silently skipping it drops the copper and produces a
            # confusing dead-network cascade downstream.  Surface it
            # loudly, like the reference does for empty gerber plots
            # (ref kicad.py:1354-1364).
            zlayers = [l for l in (_item_layers(zone) or [])
                       if l in prims]
            if not zlayers:
                continue  # not on a copper layer we analyze
            net_node = sexp.find_child(zone, "net_name")
            net = str(net_node[1]) if net_node else "?"
            warnings.warn(
                f"Zone on net {net!r} (layers {', '.join(zlayers)}) has "
                f"no stored fill — the board was saved without refilling "
                f"zones; its copper will be missing from the analysis. "
                f"Refill zones in pcbnew (B) and save.")
            continue
        for fill in fills:
            lay_node = sexp.find_child(fill, "layer")
            layer = str(lay_node[1]) if lay_node else (_item_layers(zone) or [""])[0]
            pts_node = sexp.find_child(fill, "pts")
            if pts_node is None:
                continue
            ring = np.array(
                [[float(p[1]), float(p[2])] for p in pts_node[1:]
                 if sexp.is_list_with_head(p, "xy")]
            )
            if len(ring) < 3:
                continue
            add(layer, geom.Polygon(ring))
            if stroke_outline and min_thickness > 0:
                add(layer, geom.stroke_ring(ring, min_thickness))

    # Board-level graphics on copper layers.
    for head in ("gr_line", "gr_arc", "gr_circle", "gr_rect", "gr_poly"):
        for item in sexp.find_children(pcb_tree, head):
            for layer in _item_layers(item):
                if layer in prims:
                    add(layer, _graphic_to_polys(item, head))

    # Footprint pads and copper graphics.
    for p in iter_pads(pcb_tree, copper_names):
        if p.shape_poly is None:
            continue
        for layer in p.layers:
            add(layer, p.shape_poly)

    for fp in sexp.find_children(pcb_tree, "footprint"):
        at = sexp.find_child(fp, "at")
        fx, fy = float(at[1]), float(at[2])
        fangle = float(at[3]) if len(at) > 3 else 0.0
        for head in ("fp_line", "fp_arc", "fp_circle", "fp_rect", "fp_poly"):
            for item in sexp.find_children(fp, head):
                layers = [l for l in _item_layers(item) if l in prims]
                if not layers:
                    continue
                for poly in _graphic_to_polys(item, "gr_" + head.split("_")[1]):
                    # Transform footprint-local coords to absolute.
                    rings = []
                    for ring in poly.rings:
                        out = np.empty_like(ring)
                        for i, (px, py) in enumerate(ring):
                            rx, ry = _rot(fangle, px, py)
                            out[i] = (fx + rx, fy + ry)
                        rings.append(out)
                    placed = geom.Polygon(rings[0], rings[1:])
                    for layer in layers:
                        add(layer, placed)

    return prims


def extract_board_outline(pcb_tree) -> Optional[geom.MultiPolygon]:
    """Assemble the Edge.Cuts items into closed outline polygons."""
    chains: list[np.ndarray] = []  # open polylines to be chained
    rings: list[np.ndarray] = []   # already-closed rings

    def edge_items(head):
        for item in sexp.find_children(pcb_tree, head):
            if "Edge.Cuts" in _item_layers(item):
                yield item
        for fp in sexp.find_children(pcb_tree, "footprint"):
            at = sexp.find_child(fp, "at")
            fx, fy = float(at[1]), float(at[2])
            fangle = float(at[3]) if len(at) > 3 else 0.0
            for item in sexp.find_children(fp, "fp_" + head.split("_")[1]):
                if "Edge.Cuts" in _item_layers(item):
                    yield ("transformed", item, fx, fy, fangle)

    def tx(entry, pts):
        if isinstance(entry, tuple):
            _, _, fx, fy, fangle = entry
            out = np.empty_like(pts)
            for i, (px, py) in enumerate(np.atleast_2d(pts)):
                rx, ry = _rot(fangle, px, py)
                out[i] = (fx + rx, fy + ry)
            return out
        return pts

    def node_of(entry):
        return entry[1] if isinstance(entry, tuple) else entry

    for entry in edge_items("gr_line"):
        item = node_of(entry)
        a, b = _get_xy(item, "start"), _get_xy(item, "end")
        if a and b:
            chains.append(tx(entry, np.array([a, b], dtype=np.float64)))
    for entry in edge_items("gr_arc"):
        item = node_of(entry)
        s, m, e = (_get_xy(item, "start"), _get_xy(item, "mid"),
                   _get_xy(item, "end"))
        if s and m and e:
            chains.append(tx(entry, _arc_points(s, m, e)))
    for entry in edge_items("gr_rect"):
        item = node_of(entry)
        a, b = _get_xy(item, "start"), _get_xy(item, "end")
        if a and b:
            rings.append(tx(entry, np.array(
                [[a[0], a[1]], [b[0], a[1]], [b[0], b[1]], [a[0], b[1]]])))
    for entry in edge_items("gr_circle"):
        item = node_of(entry)
        c, e = _get_xy(item, "center"), _get_xy(item, "end")
        if c and e:
            r = math.hypot(e[0] - c[0], e[1] - c[1])
            rings.append(tx(entry, geom.circle(c[0], c[1], r, 64).exterior))
    for entry in edge_items("gr_poly"):
        item = node_of(entry)
        pts_node = sexp.find_child(item, "pts")
        if pts_node is not None:
            ring = np.array(
                [[float(p[1]), float(p[2])] for p in pts_node[1:]
                 if sexp.is_list_with_head(p, "xy")]
            )
            if len(ring) >= 3:
                rings.append(tx(entry, ring))

    # Chain open polylines into closed loops (endpoint tolerance 10 um).
    tol = 0.01
    chains = [c for c in chains if len(c) >= 2]
    while chains:
        cur = chains.pop()
        changed = True
        while changed:
            changed = False
            if np.hypot(*(cur[0] - cur[-1])) < tol and len(cur) > 2:
                break
            for i, other in enumerate(chains):
                for flip_cur_end, arr in ((False, other), (True, other[::-1])):
                    if np.hypot(*(cur[-1] - arr[0])) < tol:
                        cur = np.vstack([cur, arr[1:]])
                        chains.pop(i)
                        changed = True
                        break
                if changed:
                    break
        if np.hypot(*(cur[0] - cur[-1])) < tol and len(cur) > 3:
            rings.append(cur[:-1])
        else:
            log.debug("Dropping open Edge.Cuts chain with %d points", len(cur))

    rings = [r for r in rings if len(r) >= 3]
    if not rings:
        return None

    # Orient rings by nesting depth so the nonzero winding rule produces
    # board-with-cutout semantics in a single union.
    polys = []
    ring_polys = [geom.Polygon(r) for r in rings]
    for i, r in enumerate(rings):
        depth = 0
        probe = ring_polys[i].representative_point()
        for j, other in enumerate(ring_polys):
            if i != j and other.contains(probe):
                depth += 1
        arr = ring_polys[i].exterior  # CCW-normalized
        if depth % 2 == 1:
            arr = arr[::-1].copy()
        p = geom.Polygon.__new__(geom.Polygon)
        p._rings = (np.ascontiguousarray(arr),)
        polys.append(p)
    mp = geom.union_all(polys)
    return mp if not mp.is_empty else None


# ---------------------------------------------------------------------------
# Vias and THT pads -> ViaSpec
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ViaSpec:
    """A drilled barrel connecting copper layers (via or THT pad),
    reference kicad.py:801-836."""

    point: geom.Point
    drill_diameter: float
    layer_names: list[str]
    endpoint: Optional[Endpoint] = None
    shape: geom.Polygon = field(init=False)

    def __post_init__(self):
        object.__setattr__(
            self,
            "shape",
            geom.circle(
                self.point.x, self.point.y, self.drill_diameter / 2,
                DRILL_SEGMENTS,
            ),
        )

    def compute_resistance(self, length: float, plating_thickness: float,
                           conductivity: float) -> float:
        """Hollow-cylinder model: R = L / (sigma * pi * (r_o^2 - r_i^2))."""
        outer = self.drill_diameter / 2 + plating_thickness
        inner = self.drill_diameter / 2
        area = math.pi * (outer**2 - inner**2)
        return length / (conductivity * area)


def extract_via_specs(pcb_tree, copper_names: list[str]) -> list[ViaSpec]:
    specs = []
    for via in sexp.find_children(pcb_tree, "via"):
        pos = _get_xy(via, "at")
        drill = _get_num(via, "drill", 0.0)
        span = _expand_layer_wildcards(_item_layers(via), copper_names)
        if not span or set(span) >= {"F.Cu", "B.Cu"}:
            span = list(copper_names)
        if pos is None or drill <= 0:
            continue
        specs.append(
            ViaSpec(
                point=geom.Point(pos[0], pos[1]),
                drill_diameter=drill,
                layer_names=span,
            )
        )
    return specs


def extract_tht_pad_specs(pcb_tree, copper_names: list[str]) -> list[ViaSpec]:
    specs = []
    for p in iter_pads(pcb_tree, copper_names):
        if p.kind != "thru_hole":
            continue
        span = p.layers if p.layers else list(copper_names)
        specs.append(
            ViaSpec(
                point=geom.Point(p.abs_x, p.abs_y),
                drill_diameter=p.drill,
                layer_names=span,
                endpoint=p.endpoint,
            )
        )
    return specs


def punch_via_holes(layer_geoms: dict[str, geom.MultiPolygon],
                    via_specs: list[ViaSpec]) -> dict[str, geom.MultiPolygon]:
    holes_by_layer: dict[str, list[geom.Polygon]] = collections.defaultdict(list)
    for vs in via_specs:
        if vs.drill_diameter <= 0:
            continue
        for layer in vs.layer_names:
            holes_by_layer[layer].append(vs.shape)
    out = {}
    for name, mp in layer_geoms.items():
        if name in holes_by_layer and not mp.is_empty:
            punched = geom.difference(mp, holes_by_layer[name])
            # Light cleanup of snap artifacts only: the tolerance must stay
            # far below the drill 16-gon sagitta (~3 um) so via boundary
            # points survive as exact ring vertices (they become mesh
            # connection vertices).
            out[name] = geom.simplify(punched, 1e-4)
        else:
            out[name] = mp
    return out




class LayerPointClassifier:
    """Batched closed-containment queries against layer geometry.

    Via processing touches every drill-boundary point against every
    spanned layer; per-point queries are O(points x edges), so all points
    are classified per layer in one native call and cached.
    """

    def __init__(self, layer_dict: dict[str, problem.Layer]):
        self.layer_dict = layer_dict
        self._cache: dict[str, dict[tuple[int, int], bool]] = {}

    @staticmethod
    def _key(x: float, y: float) -> tuple[int, int]:
        return (round(x * 1e6), round(y * 1e6))

    def preload(self, points_by_layer: dict[str, list[tuple[float, float]]]):
        for layer_name, pts in points_by_layer.items():
            layer = self.layer_dict.get(layer_name)
            cache = self._cache.setdefault(layer_name, {})
            todo = [p for p in pts if self._key(*p) not in cache]
            if layer is None:
                for pxy in todo:
                    cache[self._key(*pxy)] = False
                continue
            if not todo:
                continue
            cls = layer.shape.classify_points(np.array(todo, dtype=np.float64))
            for pxy, c in zip(todo, cls):
                cache[self._key(*pxy)] = bool(c >= 1)

    def intersects(self, layer_name: str, x: float, y: float) -> bool:
        cache = self._cache.setdefault(layer_name, {})
        key = self._key(x, y)
        if key not in cache:
            layer = self.layer_dict.get(layer_name)
            cache[key] = bool(layer and layer.shape.intersects(geom.Point(x, y)))
        return cache[key]

def process_via_spec(via_spec: ViaSpec,
                     layer_dict: dict[str, problem.Layer],
                     stackup: Stackup,
                     classifier: Optional[LayerPointClassifier] = None
                     ) -> list[problem.Network]:
    """Via -> per-layer-pair resistor stacks distributed over the drill
    boundary points (reference kicad.py:1497-1585)."""
    in_order = sorted(via_spec.layer_names, key=stackup.index_by_name)
    boundary = [tuple(p) for p in via_spec.shape.exterior]
    num_pts = len(boundary)

    involved = [stackup.items[stackup.index_by_name(n)] for n in via_spec.layer_names]
    coppers = [it for it in involved if it.conductivity is not None]
    if not coppers:
        return []
    plating = max(it.thickness for it in coppers)
    conductivity = coppers[0].conductivity

    networks = []
    for i in range(len(in_order) - 1):
        name_a, name_b = in_order[i], in_order[i + 1]
        layer_a, layer_b = layer_dict[name_a], layer_dict[name_b]
        ja, jb = stackup.index_by_name(name_a), stackup.index_by_name(name_b)
        segment_length = sum(
            stackup.items[j].thickness for j in range(ja + 1, jb + 1)
        )
        total_r = via_spec.compute_resistance(segment_length, plating, conductivity)
        distributed_r = total_r * num_pts

        connections = []
        elements = []
        for x, y in boundary:
            pt = geom.Point(float(x), float(y))
            if classifier is not None:
                if not (classifier.intersects(name_a, pt.x, pt.y)
                        and classifier.intersects(name_b, pt.x, pt.y)):
                    continue
            elif not (layer_a.shape.intersects(pt)
                      and layer_b.shape.intersects(pt)):
                continue
            ca = problem.Connection(layer=layer_a, point=pt)
            cb = problem.Connection(layer=layer_b, point=pt)
            elements.append(
                problem.Resistor(a=ca.node_id, b=cb.node_id,
                                 resistance=distributed_r)
            )
            connections.extend([ca, cb])
        networks.append(problem.Network(connections=connections, elements=elements))
    return networks


# ---------------------------------------------------------------------------
# Pad index (Endpoint -> layer points)
# ---------------------------------------------------------------------------
@dataclass
class PadIndex:
    mapping: dict[Endpoint, list[LayerPoint]] = field(default_factory=dict)

    def find_by_endpoint(self, ep: Endpoint) -> list[LayerPoint]:
        return self.mapping.get(ep, [])

    def _add(self, ep: Endpoint, lp: LayerPoint):
        self.mapping.setdefault(ep, []).append(lp)

    def load_smd_pads(self, pcb_tree, copper_names: list[str],
                      layer_dict: dict[str, problem.Layer]) -> None:
        for p in iter_pads(pcb_tree, copper_names):
            if p.kind != "smd":
                continue
            if not p.layers:
                continue
            layer_name = p.layers[0]
            layer = layer_dict.get(layer_name)
            if layer is None:
                log.warning("SMD pad %s references unknown layer %s",
                            p.endpoint, layer_name)
                continue
            pt = geom.Point(p.abs_x, p.abs_y)
            if not layer.shape.intersects(pt):
                log.warning(
                    "SMD pad %s connection point at (%s, %s) on layer %s "
                    "falls outside the layer geometry (likely in a hole). "
                    "Skipping this connection point.",
                    p.endpoint, p.abs_x, p.abs_y, layer_name,
                )
                continue
            self._add(p.endpoint, LayerPoint(layer=layer_name, point=pt))

    def insert_via_specs(self, via_specs: list["ViaSpec"],
                         layer_dict: dict[str, problem.Layer],
                         classifier: Optional["LayerPointClassifier"] = None
                         ) -> None:
        for vs in via_specs:
            if vs.endpoint is None or not vs.layer_names:
                continue
            boundary = [tuple(p) for p in vs.shape.exterior]
            for layer_name in vs.layer_names:
                layer = layer_dict.get(layer_name)
                if layer is None:
                    continue
                for x, y in boundary:
                    pt = geom.Point(float(x), float(y))
                    if classifier is not None:
                        if not classifier.intersects(layer_name, pt.x, pt.y):
                            continue
                    elif not layer.shape.intersects(pt):
                        continue
                    self._add(vs.endpoint, LayerPoint(layer=layer_name, point=pt))


# ---------------------------------------------------------------------------
# Directives (schematic-embedded configuration)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Directive:
    name: str
    params: dict[str, str]

    @classmethod
    def parse(cls, directive: str) -> "Directive":
        tokens = directive.split()
        if not tokens or tokens[0] != "!padne":
            raise ValueError("Directive must start with '!padne'")
        if len(tokens) < 2:
            raise ValueError("Directive must have a name")
        name = tokens[1]
        params = {}
        for param in tokens[2:]:
            if "=" not in param:
                raise ValueError(f"Invalid parameter format: {param}")
            key, value = param.split("=", 1)
            if not key:
                raise ValueError("Empty parameter key")
            if value.startswith('"') and value.endswith('"'):
                value = value[1:-1]
            params[key] = value
        return cls(name=name, params=params)


def parse_endpoint(token: str) -> Endpoint:
    parts = token.split(".")
    if len(parts) != 2:
        raise ValueError(f"Invalid endpoint format: {token}")
    return Endpoint(designator=parts[0], pad=parts[1])


def _parse_endpoints_param(param_str: Optional[str]) -> list[Endpoint]:
    if not param_str:
        return []
    return [
        parse_endpoint(tok.strip())
        for tok in param_str.split(",")
        if tok.strip()
    ]


# --- Lumped-element directive grammar --------------------------------------
#
# Each directive kind (VOLTAGE / CURRENT / RESISTANCE / REGULATOR) is one
# declarative row in LUMPED_RULES; a single builder walks the row.  The
# wiring semantics mirror the reference (kicad.py:432-733): a terminal
# that resolves to several pads is coupled through a star of small
# resistors, EXCEPT voltage-source terminals, which ride 0 V glue sources
# (a resistor star would soften the forced rail); VOLTAGE additionally
# supports a series ESR resistor.

COUPLING_RESISTANCE_DEFAULT = 0.001  # 1 mOhm star legs (reference :444)


@dataclass(frozen=True)
class TerminalRule:
    param: str  # directive parameter carrying the endpoint list
    kwarg: str  # element-constructor keyword receiving the node


@dataclass(frozen=True)
class ScalarRule:
    param: str
    kwarg: Optional[str]  # None: parsed/validated but wired specially (esr)
    default: Optional[float] = None


@dataclass(frozen=True)
class LumpedRule:
    """Grammar + wiring style for one lumped directive kind."""

    element: type
    terminals: tuple[TerminalRule, ...]
    scalars: tuple[ScalarRule, ...]
    zero_volt_glue: bool = False


LUMPED_RULES: dict[str, LumpedRule] = {
    "RESISTANCE": LumpedRule(
        element=problem.Resistor,
        terminals=(TerminalRule("a", "a"), TerminalRule("b", "b")),
        scalars=(ScalarRule("r", "resistance"),),
    ),
    "CURRENT": LumpedRule(
        element=problem.CurrentSource,
        terminals=(TerminalRule("f", "f"), TerminalRule("t", "t")),
        scalars=(ScalarRule("i", "current"),),
    ),
    "VOLTAGE": LumpedRule(
        element=problem.VoltageSource,
        terminals=(TerminalRule("p", "p"), TerminalRule("n", "n")),
        scalars=(ScalarRule("v", "voltage"), ScalarRule("esr", None, 0.0)),
        zero_volt_glue=True,
    ),
    "REGULATOR": LumpedRule(
        element=problem.VoltageRegulator,
        terminals=(
            TerminalRule("p", "v_p"), TerminalRule("n", "v_n"),
            TerminalRule("f", "s_f"), TerminalRule("t", "s_t"),
        ),
        scalars=(ScalarRule("v", "voltage"), ScalarRule("gain", "gain")),
    ),
}


def _star_terminal(layerpoints, layer_dict, coupling: float):
    """Wire one terminal to copper; several pads couple through a
    resistor star.  Returns (element node, connections, glue elements)."""
    node = problem.NodeID()
    if len(layerpoints) == 1:
        lp = layerpoints[0]
        conn = problem.Connection(
            layer=layer_dict[lp.layer], point=lp.point, node_id=node
        )
        return node, [conn], []
    conns, glue = [], []
    for lp in layerpoints:
        leg = problem.Resistor(
            a=problem.NodeID(), b=node, resistance=coupling
        )
        glue.append(leg)
        conns.append(problem.Connection(
            layer=layer_dict[lp.layer], point=lp.point, node_id=leg.a
        ))
    return node, conns, glue


def _glued_terminal(layerpoints, layer_dict, coupling: float):
    """Source-style terminal: the first pad carries the element node,
    extra pads are pinned to it with 0 V sources."""
    conns = [
        problem.Connection(layer=layer_dict[lp.layer], point=lp.point)
        for lp in layerpoints
    ]
    glue = [
        problem.VoltageSource(
            p=extra.node_id, n=conns[0].node_id, voltage=0.0
        )
        for extra in conns[1:]
    ]
    return conns[0].node_id, conns, glue


@dataclass(frozen=True)
class LumpedSpec:
    """A parsed lumped directive, ready to be wired into a Network."""

    kind: str
    pads: dict[str, list[Endpoint]]  # keyed by directive param
    scalars: dict[str, float]        # keyed by directive param
    coupling: float = COUPLING_RESISTANCE_DEFAULT

    @property
    def rule(self) -> LumpedRule:
        return LUMPED_RULES[self.kind]

    @classmethod
    def from_directive(cls, directive: Directive) -> "LumpedSpec":
        rule = LUMPED_RULES[directive.name]
        pads = {}
        for t in rule.terminals:
            raw = directive.params.get(t.param)
            endpoints = _parse_endpoints_param(raw) if raw is not None else []
            if not endpoints:
                raise ValueError(
                    f"{directive.name} directive needs a non-empty "
                    f"'{t.param}=' endpoint list"
                )
            pads[t.param] = endpoints
        scalars = {}
        for s in rule.scalars:
            raw = directive.params.get(s.param)
            if raw is not None:
                scalars[s.param] = units.Value.parse(raw).value
            elif s.default is not None:
                scalars[s.param] = s.default
            else:
                raise ValueError(
                    f"{directive.name} directive needs a "
                    f"'{s.param}=' value"
                )
        coupling = COUPLING_RESISTANCE_DEFAULT
        if "coupling" in directive.params:
            coupling = units.Value.parse(directive.params["coupling"]).value
        return cls(kind=directive.name, pads=pads, scalars=scalars,
                   coupling=coupling)

    def construct(self, pad_index: PadIndex, layer_dict) -> problem.Network:
        rule = self.rule
        wire = _glued_terminal if rule.zero_volt_glue else _star_terminal
        connections, elements = [], []
        kwargs: dict = {}
        for t in rule.terminals:
            layerpoints = [
                lp for ep in self.pads[t.param]
                for lp in pad_index.find_by_endpoint(ep)
            ]
            if not layerpoints:
                raise ValueError(
                    f"{self.kind} terminal '{t.param}' did not resolve to "
                    "any pad on live copper"
                )
            node, conns, glue = wire(layerpoints, layer_dict, self.coupling)
            kwargs[t.kwarg] = node
            connections.extend(conns)
            elements.extend(glue)
        kwargs.update({
            s.kwarg: self.scalars[s.param]
            for s in rule.scalars if s.kwarg is not None
        })
        esr = self.scalars.get("esr", 0.0)
        if esr > 0.0:
            # Series ESR between the positive pad and the ideal source.
            inner = problem.NodeID()
            elements.append(problem.Resistor(
                a=kwargs["p"], b=inner, resistance=esr
            ))
            kwargs["p"] = inner
        elements.append(rule.element(**kwargs))
        return problem.Network(connections=connections, elements=elements)


@dataclass
class ProbeSpec:
    """Force mesh vertices at pads without any electrical element
    (reference kicad.py:734-766)."""

    endpoints: list[Endpoint] = field(default_factory=list)

    @classmethod
    def from_directive(cls, directive: Directive) -> "ProbeSpec":
        if "p" not in directive.params:
            raise ValueError("PROBE directive requires a 'p' parameter")
        return cls(endpoints=_parse_endpoints_param(directive.params["p"]))

    def construct(self, pad_index: PadIndex, layer_dict) -> list[problem.Network]:
        networks = []
        for ep in self.endpoints:
            layerpoints = pad_index.find_by_endpoint(ep)
            if not layerpoints:
                raise ValueError(
                    f"PROBE endpoint {ep.designator}.{ep.pad} did not resolve "
                    "to any pad"
                )
            for lp in layerpoints:
                conn = problem.Connection(
                    layer=layer_dict[lp.layer], point=lp.point
                )
                networks.append(problem.Network(connections=[conn], elements=[]))
        return networks


@dataclass(frozen=True)
class CopperSpec:
    conductivity: float  # S/mm

    @classmethod
    def from_directive(cls, directive: Directive) -> "CopperSpec":
        if "conductivity" not in directive.params:
            raise KeyError(
                "The parameter `conductivity` not specified for the COPPER directive"
            )
        # Directive value is S/m; store S/mm.
        conductivity = units.Value.parse(directive.params["conductivity"]).value * 1e-3
        if conductivity <= 0:
            raise ValueError(f"Conductivity must be positive, got {conductivity}")
        return cls(conductivity=conductivity)


@dataclass(frozen=True)
class Directives:
    lumped_specs: list[LumpedSpec]
    copper_spec: Optional[CopperSpec] = None
    probe_specs: list[ProbeSpec] = field(default_factory=list)


def process_directives(directives: list[Directive]) -> Directives:
    lumped = []
    copper = None
    probes = []
    for d in directives:
        if d.name == "COPPER":
            if copper is not None:
                warnings.warn("Multiple COPPER directives found, using the first one")
                continue
            copper = CopperSpec.from_directive(d)
        elif d.name == "PROBE":
            probes.append(ProbeSpec.from_directive(d))
        elif d.name in LUMPED_RULES:
            lumped.append(LumpedSpec.from_directive(d))
        else:
            warnings.warn(f"Unknown directive: {d.name}")
    return Directives(lumped_specs=lumped, copper_spec=copper, probe_specs=probes)


# ---------------------------------------------------------------------------
# Schematic hierarchy
# ---------------------------------------------------------------------------
@dataclass
class SchemaInstance:
    file_path: pathlib.Path
    sheet_name: str
    parsed_sexp: Any
    child_instances: list["SchemaInstance"] = field(default_factory=list)


def build_schema_hierarchy(sch_file_path: pathlib.Path,
                           sheet_name: str = "Root") -> SchemaInstance:
    sch_file_path = pathlib.Path(sch_file_path).resolve()
    tree = sexp.load_path(sch_file_path)
    instance = SchemaInstance(
        file_path=sch_file_path, sheet_name=sheet_name, parsed_sexp=tree
    )
    for sheet in sexp.find_all(tree, "sheet"):
        sheetname = None
        sheetfile = None
        for prop in sexp.find_children(sheet, "property"):
            if len(prop) >= 3 and prop[1] == "Sheetname":
                sheetname = prop[2]
            elif len(prop) >= 3 and prop[1] == "Sheetfile":
                sheetfile = prop[2]
        if not sheetfile:
            log.warning("Sheetfile not found in sheet element, skipping child")
            continue
        nested = sch_file_path.parent / sheetfile
        if not nested.exists():
            log.warning("Referenced schematic file not at %s, skipping", nested)
            continue
        instance.child_instances.append(
            build_schema_hierarchy(nested, sheetname or "Unnamed")
        )
    return instance


def flatten_schema_hierarchy(instance: SchemaInstance) -> list[SchemaInstance]:
    result = [instance]
    for child in instance.child_instances:
        result.extend(flatten_schema_hierarchy(child))
    return result


def extract_directives_from_text(text: str) -> list[Directive]:
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("!padne"):
            out.append(Directive.parse(line))
    return out


def extract_directives_from_schema(instance: SchemaInstance) -> list[Directive]:
    out = []
    for text_el in sexp.find_all(instance.parsed_sexp, "text"):
        if len(text_el) >= 2 and isinstance(text_el[1], str):
            out.extend(extract_directives_from_text(text_el[1]))
    return out


def extract_directives_from_hierarchy(root: SchemaInstance) -> list[Directive]:
    processed: set[pathlib.Path] = set()
    out = []
    for instance in flatten_schema_hierarchy(root):
        if instance.file_path in processed:
            warnings.warn(
                "Schematic files with multiple instances are not supported, "
                f"loaded only one instance of {instance.file_path}, skipping "
                "the rest"
            )
            continue
        processed.add(instance.file_path)
        out.extend(extract_directives_from_schema(instance))
    return out


# ---------------------------------------------------------------------------
# Top-level loader
# ---------------------------------------------------------------------------
@checked
def load_kicad_project(pro_file_path) -> problem.Problem:
    with spans.span("kicad.load"):
        return _load_kicad_project(pro_file_path)


def _load_kicad_project(pro_file_path) -> problem.Problem:
    with spans.span("kicad.parse"):
        project = KiCadProject.from_pro_file(Path(pro_file_path))
        log.info("Parsing PCB file")
        pcb_tree = sexp.load_path(project.pcb_path)

        copper_names = extract_copper_layer_names(pcb_tree)

    with spans.span("kicad.copper"):
        log.info("Rendering copper layers")
        prims = render_copper_primitives(pcb_tree, copper_names)
        layer_geoms: dict[str, geom.MultiPolygon] = {}
        for name in copper_names:
            if prims[name]:
                # Post-union cleanup mirrors the reference's simplify(1e-4)
                # (kicad.py:1384): removes snap-rounding noise (nm-scale edges,
                # near-collinear jitter) that would otherwise create degenerate
                # sliver triangles and extreme cotan weights.
                layer_geoms[name] = geom.simplify(geom.union_all(prims[name]), 1e-4)
            else:
                layer_geoms[name] = geom.MultiPolygon([])

        outline = extract_board_outline(pcb_tree)
        if outline is not None:
            for name in list(layer_geoms):
                if layer_geoms[name].is_empty:
                    continue
                clipped = geom.simplify(
                    geom.intersection(layer_geoms[name], outline), 1e-4
                )
                if clipped.is_empty:
                    log.warning(
                        "Clipped geometry for layer %s is empty after applying "
                        "outline", name,
                    )
                layer_geoms[name] = clipped

    with spans.span("kicad.directives"):
        # Directives.
        hierarchy = build_schema_hierarchy(project.sch_path)
        directives = process_directives(extract_directives_from_hierarchy(hierarchy))
        conductivity = COPPER_CONDUCTIVITY
        if directives.copper_spec is not None:
            conductivity = directives.copper_spec.conductivity
            log.info("Using custom copper conductivity of %s S/mm", conductivity)

        stackup = extract_stackup(pcb_tree, conductivity)
        for name, mp in layer_geoms.items():
            if not mp.is_empty and not any(it.name == name for it in stackup.items):
                raise ValueError("Stackup does not contain all plotted layers")

    with spans.span("kicad.networks"):
        log.info("Processing vias and through hole pads")
        via_specs = extract_via_specs(pcb_tree, copper_names) + extract_tht_pad_specs(
            pcb_tree, copper_names
        )
        layer_geoms = punch_via_holes(layer_geoms, via_specs)

        # Drop layers with no copper (parity: empty gerbers are skipped,
        # reference kicad.py:1354-1364, 1419-1420).
        layer_dict: dict[str, problem.Layer] = {}
        for name in copper_names:
            mp = layer_geoms[name]
            if mp.is_empty:
                continue
            item = next((it for it in stackup.items if it.name == name), None)
            if item is None:
                continue
            layer_dict[name] = problem.Layer(
                shape=mp, name=name, conductance=item.conductance
            )

        # Batch-classify every via boundary point per layer up front.
        classifier = LayerPointClassifier(layer_dict)
        points_by_layer: dict[str, list[tuple[float, float]]] = {}
        for vs in via_specs:
            pts = [(float(x), float(y)) for x, y in vs.shape.exterior]
            for layer_name in vs.layer_names:
                points_by_layer.setdefault(layer_name, []).extend(pts)
        classifier.preload(points_by_layer)

        pad_index = PadIndex()
        pad_index.load_smd_pads(pcb_tree, copper_names, layer_dict)
        pad_index.insert_via_specs(via_specs, layer_dict, classifier)

        networks: list[problem.Network] = []
        for vs in via_specs:
            usable = [n for n in vs.layer_names if n in layer_dict]
            if len(usable) < 2:
                continue
            vs_usable = ViaSpec(
                point=vs.point,
                drill_diameter=vs.drill_diameter,
                layer_names=usable,
                endpoint=vs.endpoint,
            )
            networks.extend(
                process_via_spec(vs_usable, layer_dict, stackup, classifier)
            )

        log.info("Creating networks from specifications")
        for spec in directives.lumped_specs:
            networks.append(spec.construct(pad_index, layer_dict))
        for probe in directives.probe_specs:
            networks.extend(probe.construct(pad_index, layer_dict))

    names_in_order = sorted(layer_dict, key=stackup.index_by_name)
    layers = [layer_dict[n] for n in names_in_order]
    return problem.Problem(
        layers=layers, networks=networks, project_name=project.name
    )
