"""The board of the `soc_rails_1m` configuration and its assembled
system, made with the frozen host pipeline (pdnbench/frozen) and never
with the program.

A multi-rail board that feeds a BGA SoC through a tree of regulators: a
6-layer stack (F.Cu, In1.Cu ... In4.Cu, B.Cu), In1.Cu and In4.Cu whole
ground planes, B.Cu a ground pour with a 12 V input pour along its left
edge, In2.Cu and In3.Cu split power planes (0.5 mm splits) with one
region a rail.  The regulators sit in a column along the left edge, one
row each, over the 12 V pour; the loads sit in a BGA site at the
board's centre.  Bucks (fed from 12 V) put their rails on In2.Cu, LDOs
(fed from a buck's rail or from 12 V) on In3.Cu.

Each plane's regions, in the order of its regulators' rows: the first
rail of a plane takes the plane's largest region (the rows of the column
down to the next regulator of the plane, a fan out to the site's top,
everything right of the site's fingers, and a wedge below); every other
rail a band of the column's rows, a fan from it to the site's left
side, and a finger into the site.  The fingers of both planes are
aligned, so a via through both crosses no split.

Copper is connected by through vias (0.6 mm, 0.3 mm drill), each with an
antipad (a 1 mm clearance hole, a 16-gon) in every region of another
net it crosses, as a zone fill makes one; the fill of a region with
holes is written as strips cut through the holes' centres, so that each
filled polygon is simple (every via lies on a line of a 0.625 mm grid,
so two centre lines lie at least 0.625 mm apart, beyond an antipad's
radius).  A pad sits on F.Cu beside its via (0.3 mm off, so the via's
drill misses the pad's centre).  Ground vias stitch
the ground layers on a grid; a grid point whose antipads would cross a
split is left out.

Directives: one VOLTAGE of 12 V from the input connector's pad on the 12
V pour to its pad on the ground pour; a REGULATOR a rail, v its set
point, p its output pad and n its ground pad, with gain V / (12 V x 0.9)
for a buck and 1 for an LDO; padne's stamp adds gain x j to the f
node's injection and takes it from the t node's (the output current j
enters at p), so f is the ground pad and t the input pad, which then
supplies the regulator's input current; a CURRENT a load point, from a
load pad on its rail to a return pad on ground, the rail's current
spread evenly over its points.
"""

from __future__ import annotations

import hashlib
import math
import os
import pathlib

import numpy as np

from . import inputs
from .frozen import boardgen

NAME = "rail_board"
INPUT_V = 12.0          # V, the input connector
BUCK_EFFICIENCY = 0.9
VIA, DRILL = 0.6, 0.3   # mm, through vias
ANTIPAD = 0.5           # mm, radius of a via's clearance hole
PAD = 1.0               # mm, square pads
PAD_OFF = 0.3           # mm, a pad's centre from its via's (in -y)
SPLIT = 0.25            # mm, half a split's width
MARGIN = 0.05           # mm, a hole's least distance to its fill's edge
PITCH = 1.25            # mm, between vias at a BGA site or a row
GRID = PITCH / 2        # mm, the lines (from the origin) vias lie on
ROW = 6 * GRID          # mm, between regulator rows
CLUSTER = (3.25, 5.75, 8.25)  # mm from the left edge: out, ground, input
XS = 11.5               # mm from the left edge: the B.Cu 12 V split
XF = 13.0               # mm from the left edge: where the fans start
EDGE = 0.5              # mm, copper from the board's edge
STACK = (("F.Cu", 0), ("In1.Cu", 1), ("In2.Cu", 2), ("In3.Cu", 3),
         ("In4.Cu", 4), ("B.Cu", 31))
DIELECTRIC = (0.2, 0.3, 0.39, 0.3, 0.2)   # mm, 1.6 mm with 6 x 35 um
PLANES = {"buck": "In2.Cu", "ldo": "In3.Cu"}
ZONED = ("In1.Cu", "In2.Cu", "In3.Cu", "In4.Cu", "B.Cu")


def six_layer_header() -> str:
    """PCB header with a 6-layer 1.6 mm stackup of 35 um copper."""
    names = "\n    ".join(f'({num} "{name}" signal)' for name, num in STACK)
    stack = []
    for i, (name, _) in enumerate(STACK):
        stack.append(f'(layer "{name}" (type "copper") (thickness 0.035))')
        if i < len(DIELECTRIC):
            kind = "core" if i % 2 else "prepreg"
            stack.append(f'(layer "dielectric {i + 1}" (type "{kind}") '
                         f'(thickness {DIELECTRIC[i]}) (material "FR4"))')
    return boardgen.PCB_HEADER.replace(
        '(0 "F.Cu" signal)\n    (31 "B.Cu" signal)', names).replace(
        '(layer "F.Cu" (type "copper") (thickness 0.035))\n'
        '      (layer "dielectric 1" (type "core") (thickness 1.51) '
        '(material "FR4"))\n'
        '      (layer "B.Cu" (type "copper") (thickness 0.035))',
        "\n      ".join(stack))


# -- geometry ----------------------------------------------------------

def _area(poly) -> float:
    return 0.5 * sum(x0 * y1 - x1 * y0 for (x0, y0), (x1, y1)
                     in zip(poly, poly[1:] + poly[:1]))


def _ccw(poly) -> list:
    """The polygon with a positive signed area."""
    return list(poly) if _area(poly) > 0 else list(reversed(poly))


def _contains(poly, x, y) -> bool:
    """Whether (x, y) lies inside the convex ccw polygon (boundary in)."""
    return all((x1 - x0) * (y - y0) - (y1 - y0) * (x - x0) >= 0
               for (x0, y0), (x1, y1) in zip(poly, poly[1:] + poly[:1]))


def _edge_distance(poly, x, y) -> float:
    """The distance from (x, y) to the polygon's boundary."""
    best = math.inf
    for (x0, y0), (x1, y1) in zip(poly, poly[1:] + poly[:1]):
        dx, dy = x1 - x0, y1 - y0
        t = min(1.0, max(0.0, ((x - x0) * dx + (y - y0) * dy)
                         / (dx * dx + dy * dy)))
        best = min(best, math.hypot(x - x0 - t * dx, y - y0 - t * dy))
    return best


def _clip(poly, y, keep_above: bool) -> list:
    """The convex polygon cut by the line at y: the part with y' >= y
    (keep_above) or y' <= y; cut points lie on y exactly."""
    out = []
    for (x0, y0), (x1, y1) in zip(poly, poly[1:] + poly[:1]):
        in0 = y0 >= y if keep_above else y0 <= y
        in1 = y1 >= y if keep_above else y1 <= y
        if in0:
            out.append((x0, y0))
        if in0 != in1 and y0 != y and y1 != y:
            out.append((x0 + (y - y0) * (x1 - x0) / (y1 - y0), y))
    return out


def _half(cx, cy, upper: bool) -> list:
    """The 16-gon antipad's half above (upper: from its left point to
    its right one) or below (from its right point to its left one) the
    line through its centre."""
    inner = [(cx + ANTIPAD * math.cos(math.radians(a)),
              cy + ANTIPAD * math.sin(math.radians(a)))
             for a in (22.5 * k for k in range(1, 8))]
    if upper:
        return [(cx - ANTIPAD, cy)] + inner[::-1] + [(cx + ANTIPAD, cy)]
    return [(cx + ANTIPAD, cy)] + [(x, 2 * cy - y) for x, y in inner] + [
        (cx - ANTIPAD, cy)]


def _strips(poly, holes) -> list:
    """The convex ccw polygon less the 16-gon antipads at `holes`
    (centres, each hole inside it), as simple polygons: strips cut at the
    holes' centre lines, each hole a notch in the two strips it
    touches."""
    cuts = sorted({y for _, y in holes})
    ys = [min(y for _, y in poly)] + cuts + [max(y for _, y in poly)]
    out = []
    for ya, yb in zip(ys, ys[1:]):
        if yb <= ya:
            continue
        strip = _clip(_clip(poly, ya, True), yb, False)
        if len(strip) < 3 or _area(strip) <= 0:
            continue
        ring = []
        for (x0, y0), (x1, y1) in zip(strip, strip[1:] + strip[:1]):
            ring.append((x0, y0))
            if y0 == y1 == ya and x1 > x0:      # bottom edge, rightwards
                for cx in sorted(x for x, y in holes if y == ya):
                    ring += _half(cx, ya, True)
            elif y0 == y1 == yb and x1 < x0:    # top edge, leftwards
                for cx in sorted((x for x, y in holes if y == yb),
                                 reverse=True):
                    ring += _half(cx, yb, False)
        out.append(ring)
    return out


def _rect(x0, y0, x1, y1) -> list:
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]


def _fan_line(xa, ya, xb, yb, shift):
    """The line through (xa, ya) and (xb, yb) moved `shift` mm along its
    normal (towards larger y for a positive shift): its points at xa and
    xb."""
    h = shift * math.hypot(xb - xa, yb - ya) / (xb - xa)
    return (xa, ya + h), (xb, yb + h)


class Layout:
    """Every region (net, convex ccw pieces) of each zoned layer, the
    vias (x, y, net) and the pads (ref, x, y, layer) of a rail board."""

    def __init__(self, rails, size=(100.0, 80.0), bga: float = 25.0,
                 stitch: "float | None" = 5.0, origin=(100.0, 100.0)):
        self.rails = [dict(zip(("name", "volts", "kind", "source",
                                "amps", "points"), r)) for r in rails]
        names = [r["name"] for r in self.rails]
        if len(set(names)) != len(names):
            raise ValueError("two rails of one name")
        self.by_name = {r["name"]: r for r in self.rails}
        for r in self.rails:
            r["plane"] = PLANES[r["kind"]]
            if r["source"] != "12V" and r["source"] not in self.by_name:
                raise ValueError(f"{r['name']}: no source {r['source']!r}")
        ox, oy = origin
        self.oy = oy
        self.outline = (ox, oy, ox + size[0], oy + size[1])
        self.X0, self.Y0 = ox + EDGE, oy + EDGE
        self.X1, self.Y1 = ox + size[0] - EDGE, oy + size[1] - EDGE
        cx, cy = ox + size[0] / 2, oy + size[1] / 2
        self.bga = (cx - bga / 2, cy - bga / 2, cx + bga / 2, cy + bga / 2)
        self.FX = self.bga[0] + 0.7 * bga
        self.order = self._row_order()
        self.row_y = {name: self._on_grid(self.Y0 + 2.0) + ROW * k
                      for k, name in enumerate(self.order)}
        if self.row_y[self.order[-1]] > self.Y1 - 2.0:
            raise ValueError("the regulator column does not fit the board")
        if self.bga[0] < self.X0 + XF + 2.0:
            raise ValueError("the BGA site does not leave room for fans")
        self.regions = {layer: [] for layer in ZONED}
        self.vias, self.pads = [], []
        self._planes()
        self._ground()
        self._regulators()
        self._loads()
        if stitch:
            self._stitch(stitch)
        self.holes = self._check()

    def _row_order(self) -> list:
        """The regulators' rows, top down: each buck, then the LDOs its
        rail feeds (and theirs), then the LDOs fed from 12 V."""
        order = []

        def add(name):
            order.append(name)
            for r in self.rails:
                if r["source"] == name:
                    add(r["name"])

        for r in self.rails:
            if r["source"] == "12V" and r["kind"] == "buck":
                add(r["name"])
        order += [r["name"] for r in self.rails
                  if r["source"] == "12V" and r["kind"] != "buck"]
        return order

    # -- regions

    def _planes(self) -> None:
        X0, Y0, X1, Y1, FX = self.X0, self.Y0, self.X1, self.Y1, self.FX
        BX0, BY0, _, BY1 = self.bga
        xf = X0 + XF
        for plane in ("In2.Cu", "In3.Cu"):
            rows = [n for n in self.order if self.by_name[n]["plane"] == plane]
            if not rows:
                continue
            # The column's band edges: midway between rows.
            edges = [Y0] + [self.row_y[n] - ROW / 2 for n in rows[1:]] + [Y1]
            fingers = len(rows) - 1
            yf = [BY0 + (BY1 - BY0) * k / max(fingers, 1)
                  for k in range(fingers + 1)]
            big = rows[0]
            if fingers:
                (_, top_a), (_, top_b) = _fan_line(xf, edges[1], BX0, BY0,
                                                   -SPLIT)
                low = _fan_line(xf, Y1, BX0, BY1, SPLIT)
                cut = xf + (low[0][1] - Y1) * (BX0 - xf) / (
                    low[0][1] - low[1][1])
                pieces = [_rect(X0, Y0, xf, edges[1] - SPLIT),
                          [(xf, Y0), (BX0, Y0), (BX0, top_b), (xf, top_a)],
                          _rect(BX0, Y0, FX + SPLIT, BY0 - SPLIT),
                          _rect(FX + SPLIT, Y0, X1, Y1),
                          _rect(BX0, BY1 + SPLIT, FX + SPLIT, Y1),
                          [(cut, Y1), (BX0, low[1][1]), (BX0, Y1)]]
            else:
                pieces = [_rect(X0, Y0, X1, Y1)]
            self.regions[plane].append((big, [_ccw(q) for q in pieces]))
            for k in range(1, len(rows)):
                last = k == fingers
                top = _fan_line(xf, edges[k], BX0, yf[k - 1], SPLIT)
                bottom = (_fan_line(xf, Y1, BX0, BY1, -SPLIT) if last else
                          _fan_line(xf, edges[k + 1], BX0, yf[k], -SPLIT))
                pieces = [
                    _rect(X0, edges[k] + SPLIT, xf,
                          Y1 if last else edges[k + 1] - SPLIT),
                    [top[0], top[1], bottom[1], bottom[0]],
                    _rect(BX0, yf[k - 1] + SPLIT, FX - SPLIT,
                          yf[k] - SPLIT)]
                self.regions[plane].append((rows[k],
                                            [_ccw(q) for q in pieces]))

    def _ground(self) -> None:
        X0, Y0, X1, Y1 = self.X0, self.Y0, self.X1, self.Y1
        for layer in ("In1.Cu", "In4.Cu"):
            self.regions[layer].append(("GND", [_rect(X0, Y0, X1, Y1)]))
        xs = X0 + XS
        self.regions["B.Cu"] += [("12V", [_rect(X0, Y0, xs - SPLIT, Y1)]),
                                 ("GND", [_rect(xs + SPLIT, Y0, X1, Y1)])]
        # The input connector's two pins, on B.Cu.
        self.pads += [("J1.1", X0 + 2.0, self.Y1 - 1.0, "B.Cu"),
                      ("J2.1", xs + 2.0, self.Y1 - 1.0, "B.Cu")]

    def _on_grid(self, y) -> float:
        return self.oy + round((y - self.oy) / GRID) * GRID

    def _via_pad(self, ref, x, y, net) -> None:
        """A pad on F.Cu at (x, y - PAD_OFF) on a via at (x, y), y
        moved to the grid's nearest line."""
        y = self._on_grid(y)
        self.vias.append((x, y, net))
        self.pads.append((ref, x, y - PAD_OFF, "F.Cu"))

    def _regulators(self) -> None:
        out, gnd, inp = (self.X0 + c for c in CLUSTER)
        for k, name in enumerate(self.order):
            r, y = self.by_name[name], self.row_y[name]
            self._via_pad(f"U{k}.1", out, y, name)
            self._via_pad(f"U{k}.2", gnd, y, "GND")
            self._via_pad(f"U{k}.3", inp, y, r["source"])

    def _loads(self) -> None:
        """Each rail's load points in the BGA site: the first rail of a
        plane in the site's right part, every other on its finger's
        centre line; a load's pad and its return's in neighbouring
        slots."""
        BX0, BY0, BX1, BY1 = self.bga
        self.loads = []
        right = [(x, y) for y in np.arange(BY0 + 0.75, BY1 - 0.5, PITCH)
                 for x in np.arange(self.FX + 1.25, BX1 - 0.3, PITCH)]
        for plane in ("In2.Cu", "In3.Cu"):
            rows = [n for n in self.order if self.by_name[n]["plane"] == plane]
            fingers = len(rows) - 1
            for k, name in enumerate(rows):
                if k == 0:
                    slots = right
                else:
                    lo = BY0 + (BY1 - BY0) * (k - 1) / max(fingers, 1)
                    hi = BY0 + (BY1 - BY0) * k / max(fingers, 1)
                    yc = (lo + hi) / 2
                    slots = [(x, yc) for x in np.arange(
                        BX0 + 1.25, self.FX - SPLIT - ANTIPAD - 0.1, PITCH)]
                slots = [s for s in slots if not self._taken(*s)]
                r = self.by_name[name]
                if 2 * r["points"] > len(slots):
                    raise ValueError(f"{name}: {r['points']} load points do "
                                     f"not fit its {len(slots)} slots")
                for p in range(r["points"]):
                    (x, y), (xr, yr) = slots[2 * p], slots[2 * p + 1]
                    ref = f"L{len(self.loads)}"
                    self._via_pad(f"{ref}.1", float(x), float(y), name)
                    self._via_pad(f"{ref}.2", float(xr), float(yr), "GND")
                    self.loads.append((ref, name,
                                       r["amps"] / r["points"]))

    def _taken(self, x, y) -> bool:
        return any(math.hypot(x - vx, y - vy) < PITCH - 1e-9
                   for vx, vy, _ in self.vias)

    def _stitch(self, pitch) -> None:
        """Ground vias on a grid, where they clear every via, the BGA
        site and every split, and lie on another via's centre line or
        clear of its antipad's (_strips cuts fills there)."""
        BX0, BY0, BX1, BY1 = self.bga
        for x in np.arange(self.X0 + 2.0, self.X1 - 1.0, pitch):
            for y in np.arange(self.Y0 + 2.0, self.Y1 - 1.0, pitch):
                x, y = float(x), self._on_grid(float(y))
                if (BX0 - 1 <= x <= BX1 + 1 and BY0 - 1 <= y <= BY1 + 1) or \
                        self._taken(x, y) or any(
                            math.hypot(x - px, y - py) < PITCH
                            for _, px, py, _ in self.pads) or any(
                            0 < abs(y - vy) < ANTIPAD + MARGIN
                            for _, vy, _ in self.vias):
                    continue
                if self._fits(x, y, "GND") is None:
                    self.vias.append((x, y, "GND"))

    # -- checks

    def _where(self, layer, x, y):
        """(net, piece) of the layer's piece holding (x, y), or None."""
        for net, pieces in self.regions[layer]:
            for piece in pieces:
                if _contains(piece, x, y):
                    return net, piece
        return None

    def _fits(self, x, y, net) -> "str | None":
        """None if a via of `net` at (x, y) connects where its net's
        copper is and clears every other region by its antipad, else
        why not."""
        joined = False
        for layer in ZONED:
            got = self._where(layer, x, y)
            if got is None:
                if any(_edge_distance(p, x, y) < VIA / 2 + MARGIN
                       for _, ps in self.regions[layer] for p in ps):
                    return f"its ring touches a split on {layer}"
                continue
            owner, piece = got
            need = VIA / 2 if owner == net else ANTIPAD
            if _edge_distance(piece, x, y) < need + MARGIN:
                return f"it lies within {need + MARGIN} mm of an edge " \
                       f"of a {owner} region on {layer}"
            joined |= owner == net
        if not joined:
            return f"it reaches no {net} copper"
        return None

    def _check(self) -> dict:
        """{layer: {(net, piece index): [hole centres]}}; raises where a
        via does not fit."""
        holes = {layer: {} for layer in ZONED}
        for x, y, net in self.vias:
            why = self._fits(x, y, net)
            if why is not None:
                raise ValueError(f"a {net} via at ({x}, {y}): {why}")
            for layer in ZONED:
                owner, piece = self._where(layer, x, y)
                if owner != net:
                    key = (owner, id(piece))
                    holes[layer].setdefault(key, []).append((x, y))
        for layer in ZONED:
            for (owner, _), centres in holes[layer].items():
                ys = sorted({y for _, y in centres})
                if any(b - a < ANTIPAD + MARGIN for a, b in zip(ys, ys[1:])):
                    raise ValueError(f"two antipads in a {owner} region on "
                                     f"{layer} lie off each other's centre "
                                     f"line by less than their radius")
        for layer, regions in self.regions.items():
            for a, (_, pa) in enumerate(regions):
                for _, pb in regions[a + 1:]:
                    for p in pa:
                        for q in pb:
                            if any(_contains(q, *v) for v in p):
                                raise ValueError(f"two regions overlap on "
                                                 f"{layer}")
        return holes

    # -- the project

    def pcb_body(self) -> str:
        x0, y0, x1, y1 = self.outline
        body = boardgen.gr_rect(x0, y0, x1, y1)
        for layer in ZONED:
            for net, pieces in self.regions[layer]:
                for piece in pieces:
                    fills = _strips(piece, self.holes[layer].get(
                        (net, id(piece)), []))
                    body += _zone(layer, piece, fills)
        for x, y, _ in self.vias:
            body += boardgen.via(_n(x), _n(y), VIA, DRILL)
        refs = {}
        for ref, x, y, layer in self.pads:
            refs.setdefault(ref.split(".")[0], []).append(
                (ref.split(".")[-1], x, y, layer))
        for ref, pads in refs.items():
            fx, fy, layer = pads[0][1], pads[0][2], pads[0][3]
            body += boardgen.footprint(ref, _n(fx), _n(fy), 0, [
                {"name": name, "kind": "smd", "shape": "rect",
                 "size": (PAD, PAD), "at": (_n(x - fx), _n(y - fy)),
                 "layers": f'"{lay}"'} for name, x, y, lay in pads],
                layer=layer)
        return body

    def directives(self) -> list:
        texts = [f"!padne VOLTAGE v={INPUT_V:g}V p=J1.1 n=J2.1"]
        for r in self.rails:
            k = self.order.index(r["name"])
            gain = (r["volts"] / (INPUT_V * BUCK_EFFICIENCY)
                    if r["kind"] == "buck" else 1.0)
            texts.append(f"!padne REGULATOR v={r['volts']!r}V p=U{k}.1 "
                         f"n=U{k}.2 f=U{k}.2 t=U{k}.3 gain={gain!r}")
        for ref, _, amps in self.loads:
            texts.append(f"!padne CURRENT i={amps!r}A f={ref}.1 t={ref}.2")
        return texts


def _n(x: float) -> str:
    """A coordinate as written: whole nanometres."""
    return f"{x:.6f}".rstrip("0").rstrip(".")


def _zone(layer, outline, fills) -> str:
    pts = " ".join(f"(xy {_n(x)} {_n(y)})" for x, y in outline)
    text = (f'  (zone (net 1) (net_name "N1") (layer "{layer}") '
            "(hatch edge 0.5)\n"
            "    (connect_pads (clearance 0.5)) (min_thickness 0.25) "
            "(filled_areas_thickness no)\n"
            "    (fill yes (thermal_gap 0.5) (thermal_bridge_width 0.5))\n"
            f"    (polygon (pts {pts}))\n")
    for fill in fills:
        fpts = " ".join(f"(xy {_n(x)} {_n(y)})" for x, y in fill)
        text += f'    (filled_polygon (layer "{layer}") (pts {fpts}))\n'
    return text + "  )\n"


def gen_rail_board(out_dir, rails, size=(100.0, 80.0), bga: float = 25.0,
                   stitch: "float | None" = 5.0) -> pathlib.Path:
    """The rail board as a KiCad project under out_dir; returns its
    .kicad_pro path.  rails: (name, volts, kind "buck" or "ldo", source
    "12V" or a rail's name, load amps, load points) each; size: the
    board's outline, mm; bga: the site's side, mm; stitch: the ground
    grid's pitch, mm (None: no stitching).  An LDO's source is 12 V or
    a buck's rail (an LDO fed from an LDO's rail, on the same plane, has
    no row for its input via: Layout raises)."""
    layout = Layout(rails, size=size, bga=bga, stitch=stitch)
    out_dir = pathlib.Path(out_dir)
    d = out_dir / NAME
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{NAME}.kicad_pcb").write_text(
        six_layer_header() + layout.pcb_body() + ")\n")
    (d / f"{NAME}.kicad_sch").write_text(
        boardgen.sch_with_text(layout.directives()))
    (d / f"{NAME}.kicad_pro").write_text(
        '{"meta": {"filename": "' + NAME + '.kicad_pro"}}')
    return d / f"{NAME}.kicad_pro"


def assemble(prob, mesher_kw: dict) -> dict:
    """inputs.assemble's arrays of a loaded rail board, from the same
    frozen steps, and its voltage sources and regulators as the problem
    states them, by system node, in the order of the border's variables:
    src_regulator (whether a regulator), src_nodes (p, n, f, t; f and t
    -1 for a voltage source), src_volts and src_gain (0 for a voltage
    source).  pdnbench/reference/mna.py stamps its border from these
    and not from the frozen border arrays."""
    from .frozen import mesh, problem
    from .frozen import system as fs

    mesher = mesh.Mesher(mesh.Mesher.Config(**mesher_kw))
    indices, _, pairs = fs.compute_connectivity(prob)
    meshes, m2l = fs.generate_meshes_for_problem(prob, mesher, pairs,
                                                 indices)
    vindex = fs.VertexIndexer.create(meshes)
    nets = fs.filter_dead_networks(prob, indices, pairs)
    nix = fs.NodeIndexer.create(prob, meshes, m2l, vindex, nets)
    system, _ = fs.assemble_core_system(prob, meshes, m2l, vindex, nets,
                                        nix)
    edges, weights, layer = [], [], []
    for mesh_i, m in enumerate(meshes):
        base = int(vindex.mesh_offsets[mesh_i])
        edges.append(m.edges.astype(np.int64) + base)
        weights.append(m.cotan_edge_weights
                       * prob.layers[m2l[mesh_i]].conductance)
        layer.append(np.full(len(m.edges), m2l[mesh_i], np.int8))
    cur, src = [], []
    for network in nets:
        for el in network.elements:
            node = nix.node_to_index
            if isinstance(el, problem.Resistor):
                ia, ib = node[el.a], node[el.b]
                if ia != ib:
                    edges.append(np.array([[ia, ib]], dtype=np.int64))
                    weights.append(np.array([1.0 / el.resistance]))
                    layer.append(np.array([-1], np.int8))
            elif isinstance(el, problem.CurrentSource):
                cur.append((node[el.f], node[el.t], el.current))
            elif isinstance(el, problem.VoltageSource):
                src.append((False, (node[el.p], node[el.n], -1, -1),
                            el.voltage, 0.0))
            elif isinstance(el, problem.VoltageRegulator):
                src.append((True, (node[el.v_p], node[el.v_n],
                                   node[el.s_f], node[el.s_t]),
                            el.voltage, el.gain))
    b = system.border
    return dict(
        n=np.int64(system.n), edges=np.concatenate(edges),
        weights=np.concatenate(weights), edge_layer=np.concatenate(layer),
        comp_id=system.comp_id, num_components=np.int64(
            system.num_components), ground_var=np.int64(system.ground_var),
        coords=system.coords, group=system.group, r_core=system.r_core,
        b_row_idx=b.row_idx, b_row_node=b.row_node, b_row_val=b.row_val,
        b_col_idx=b.col_idx, b_col_node=b.col_node, b_col_val=b.col_val,
        b_rhs=b.rhs, ell_cols=system.ell.cols, ell_vals=system.ell.vals,
        ell_diag=system.ell.diag,
        cur_f=np.array([c[0] for c in cur], np.int64),
        cur_t=np.array([c[1] for c in cur], np.int64),
        cur_i=np.array([c[2] for c in cur], np.float64),
        mesh_layer=np.array(m2l, np.int64),
        mesh_vertices=np.array([m.num_vertices for m in meshes], np.int64),
        src_regulator=np.array([s[0] for s in src], bool),
        src_nodes=np.array([s[1] for s in src], np.int64).reshape(-1, 4),
        src_volts=np.array([s[2] for s in src], np.float64),
        src_gain=np.array([s[3] for s in src], np.float64))


def _key(config: dict) -> str:
    """inputs' cache key of the configuration, with this file's source
    in it: a change of the board's generator makes new inputs."""
    h = hashlib.sha256(inputs._key(config).encode())
    h.update(pathlib.Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def rail_inputs(config: dict, tmp_dir) -> inputs.Inputs:
    """The configuration's assembled system at nominal values, as
    siteboard.site_inputs makes and caches the site board's: from the
    cache, or made with the frozen pipeline and cached.  Raises where
    the layers, n, m, the component count or the regulator count differ
    from the configuration's."""
    path = inputs.CACHE / f"{config['name']}-{_key(config)}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return inputs.Inputs({k: z[k] for k in z.files})
    from .frozen import kicad

    prob = kicad.load_kicad_project(
        gen_rail_board(tmp_dir, **config["board"].get("args", {})))
    names = [layer.name for layer in prob.layers]
    if names != config["copper_layers"]:
        raise RuntimeError(f"{config['name']}: the board's layers are "
                           f"{names}, the configuration's copper_layers "
                           f"{config['copper_layers']}")
    arrays = assemble(prob, inputs.mesher_settings(config, prob))
    got = {"n": int(arrays["n"]), "m": len(arrays["b_rhs"]),
           "components": int(arrays["num_components"]),
           "regulators": int(arrays["src_regulator"].sum())}
    for key, value in got.items():
        if key in config and config[key] != value:
            raise RuntimeError(f"{config['name']}: the frozen pipeline "
                               f"made {key} = {value}, the configuration "
                               f"states {config[key]}")
    inputs.CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.tmp{os.getpid()}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return inputs.Inputs(arrays)
