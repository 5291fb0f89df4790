"""Generate minimal KiCad fixture boards for standalone testing.

Emits .kicad_pcb / .kicad_sch / .kicad_pro triples in current KiCad 8
syntax so the loader's file-parsing path is exercised without relying on
the reference repository's fixture boards.
"""

from __future__ import annotations

import json
import pathlib

PCB_HEADER = """(kicad_pcb
  (version 20240108)
  (generator "pcbnew")
  (generator_version "8.0")
  (general (thickness 1.6) (legacy_teardrops no))
  (paper "A4")
  (layers
    (0 "F.Cu" signal)
    (31 "B.Cu" signal)
    (36 "B.SilkS" user "B.Silkscreen")
    (37 "F.SilkS" user "F.Silkscreen")
    (44 "Edge.Cuts" user)
  )
  (setup
    (stackup
      (layer "F.Cu" (type "copper") (thickness 0.035))
      (layer "dielectric 1" (type "core") (thickness 1.51) (material "FR4"))
      (layer "B.Cu" (type "copper") (thickness 0.035))
    )
    (pad_to_mask_clearance 0)
  )
  (net 0 "")
  (net 1 "N1")
"""


def sch_with_text(texts: list[str]) -> str:
    body = "".join(
        f'  (text "{t}" (at 100 {50 + 10 * i} 0) '
        f'(effects (font (size 1.27 1.27))) '
        f'(uuid "0000000-0000-0000-0000-00000000a{i:03d}"))\n'
        for i, t in enumerate(texts)
    )
    return (
        '(kicad_sch\n  (version 20231120)\n  (generator "eeschema")\n'
        '  (generator_version "8.0")\n'
        '  (uuid "11111111-1111-1111-1111-111111111111")\n'
        '  (paper "A4")\n' + body + ")\n"
    )


def footprint(ref: str, x: float, y: float, angle: float, pads: list[dict],
              layer: str = "F.Cu") -> str:
    pad_text = ""
    for p in pads:
        kind = p.get("kind", "smd")
        shape = p.get("shape", "rect")
        size = p.get("size", (1.0, 1.0))
        at = p.get("at", (0, 0))
        players = p.get("layers", f'"{layer}"')
        drill = f" (drill {p['drill']})" if "drill" in p else ""
        pad_text += (
            f'    (pad "{p["name"]}" {kind} {shape} '
            f"(at {at[0]} {at[1]}) (size {size[0]} {size[1]}){drill} "
            f"(layers {players}) (net 1 \"N1\"))\n"
        )
    return (
        f'  (footprint "Test:FP_{ref}"\n'
        f'    (layer "{layer}")\n'
        f'    (at {x} {y} {angle})\n'
        f'    (property "Reference" "{ref}" (at 0 -2 0) (layer "F.SilkS")'
        f' (effects (font (size 1 1))))\n'
        + pad_text
        + "  )\n"
    )


def segment(x0, y0, x1, y1, w, layer="F.Cu") -> str:
    return (
        f"  (segment (start {x0} {y0}) (end {x1} {y1}) (width {w}) "
        f'(layer "{layer}") (net 1))\n'
    )


def via(x, y, size, drill) -> str:
    return (
        f"  (via (at {x} {y}) (size {size}) (drill {drill}) "
        f'(layers "F.Cu" "B.Cu") (net 1))\n'
    )


def gr_rect(x0, y0, x1, y1, layer="Edge.Cuts") -> str:
    return (
        f"  (gr_rect (start {x0} {y0}) (end {x1} {y1}) "
        f'(stroke (width 0.05) (type default)) (fill none) (layer "{layer}"))\n'
    )


def zone(layer: str, outline: list, fill: list) -> str:
    pts = " ".join(f"(xy {x} {y})" for x, y in outline)
    fpts = " ".join(f"(xy {x} {y})" for x, y in fill)
    return (
        f'  (zone (net 1) (net_name "N1") (layer "{layer}") (hatch edge 0.5)\n'
        "    (connect_pads (clearance 0.5)) (min_thickness 0.25) "
        "(filled_areas_thickness no)\n"
        "    (fill yes (thermal_gap 0.5) (thermal_bridge_width 0.5))\n"
        f"    (polygon (pts {pts}))\n"
        f'    (filled_polygon (layer "{layer}") (pts {fpts}))\n'
        "  )\n"
    )


def write_project(out_dir: pathlib.Path, name: str, pcb_body: str,
                  sch_texts: list[str]):
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.kicad_pcb").write_text(PCB_HEADER + pcb_body + ")\n")
    (d / f"{name}.kicad_sch").write_text(sch_with_text(sch_texts))
    (d / f"{name}.kicad_pro").write_text(json.dumps({"meta": {"filename": f"{name}.kicad_pro"}}))


def gen_strip(out_dir: pathlib.Path):
    """A 20x2 mm trace with pads at both ends and a 1 V source."""
    body = gr_rect(98, 98, 124, 104)
    body += segment(101, 101, 121, 101, 2.0)
    body += footprint("TP1", 101, 101, 0, [
        {"name": "1", "kind": "smd", "shape": "circle", "size": (1.0, 1.0)}
    ])
    body += footprint("TP2", 121, 101, 0, [
        {"name": "1", "kind": "smd", "shape": "circle", "size": (1.0, 1.0)}
    ])
    write_project(out_dir, "gen_strip", body,
                  ["!padne VOLTAGE v=1V p=TP2.1 n=TP1.1"])


def gen_two_layer_via(out_dir: pathlib.Path):
    """F.Cu trace -> via -> B.Cu trace with a current source."""
    body = gr_rect(95, 95, 130, 110)
    body += segment(100, 100, 115, 100, 1.0, "F.Cu")
    body += segment(115, 100, 125, 100, 1.0, "B.Cu")
    body += via(115, 100, 0.8, 0.4)
    body += footprint("TPA", 100, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (1.0, 1.0)}
    ])
    body += footprint("TPB", 125, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (1.0, 1.0),
         "layers": '"B.Cu"'}
    ], layer="B.Cu")
    write_project(out_dir, "gen_two_layer_via", body,
                  ["!padne CURRENT i=0.5A f=TPA.1 t=TPB.1"])


def gen_zone_plane(out_dir: pathlib.Path):
    """A zone-filled plane with THT pads and a voltage source."""
    body = gr_rect(95, 95, 125, 115)
    fill = [(97, 97), (123, 97), (123, 113), (97, 113)]
    body += zone("F.Cu", fill, fill)
    body += zone("B.Cu", fill, fill)
    body += footprint("J1", 100, 100, 0, [
        {"name": "1", "kind": "thru_hole", "shape": "circle",
         "size": (1.7, 1.7), "drill": 1.0, "layers": '"*.Cu"'}
    ])
    body += footprint("J2", 120, 110, 0, [
        {"name": "1", "kind": "thru_hole", "shape": "circle",
         "size": (1.7, 1.7), "drill": 1.0, "layers": '"*.Cu"'}
    ])
    write_project(out_dir, "gen_zone_plane", body,
                  ["!padne VOLTAGE v=3.3V p=J1.1 n=J2.1"])


def gen_rotated_pads(out_dir: pathlib.Path):
    """Rotated footprint: pad positions must follow the KiCad transform."""
    body = gr_rect(95, 95, 125, 110)
    body += segment(110, 100, 110, 106, 1.5)
    body += footprint("R1", 110, 103, -90, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (0.8, 0.9),
         "at": (-3, 0)},
        {"name": "2", "kind": "smd", "shape": "rect", "size": (0.8, 0.9),
         "at": (3, 0)},
    ])
    write_project(out_dir, "gen_rotated_pads", body,
                  ["!padne CURRENT i=1A f=R1.1 t=R1.2"])


def gen_overlapping_vias(out_dir: pathlib.Path):
    """Two vias whose drill holes overlap: hole punching must union the
    holes without degenerate slivers (reference scenario:
    overlapping_vias, reference test_kicad.py:939-1002)."""
    body = gr_rect(95, 95, 130, 110)
    body += segment(100, 100, 115, 100, 2.0, "F.Cu")
    body += segment(115, 100, 125, 100, 2.0, "B.Cu")
    body += via(115.0, 100, 0.9, 0.5)
    body += via(115.3, 100, 0.9, 0.5)  # overlaps the first
    body += footprint("TPA", 100, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (1.0, 1.0)}
    ])
    body += footprint("TPB", 125, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (1.0, 1.0),
         "layers": '"B.Cu"'}
    ], layer="B.Cu")
    write_project(out_dir, "gen_overlapping_vias", body,
                  ["!padne CURRENT i=0.25A f=TPA.1 t=TPB.1"])


def gen_via_stack_4layer(out_dir: pathlib.Path):
    """A via through a 4-layer stackup builds the full resistor chain
    (reference scenario: via_tht_4layer, reference kicad.py:1497-1585)."""
    header_4l = PCB_HEADER.replace(
        '(0 "F.Cu" signal)\n    (31 "B.Cu" signal)',
        '(0 "F.Cu" signal)\n    (1 "In1.Cu" signal)\n'
        '    (2 "In2.Cu" signal)\n    (31 "B.Cu" signal)',
    ).replace(
        '(layer "dielectric 1" (type "core") (thickness 1.51) (material "FR4"))',
        '(layer "dielectric 1" (type "prepreg") (thickness 0.2) (material "FR4"))\n'
        '      (layer "In1.Cu" (type "copper") (thickness 0.0175))\n'
        '      (layer "dielectric 2" (type "core") (thickness 1.0) (material "FR4"))\n'
        '      (layer "In2.Cu" (type "copper") (thickness 0.0175))\n'
        '      (layer "dielectric 3" (type "prepreg") (thickness 0.2) (material "FR4"))',
    )
    body = gr_rect(95, 95, 130, 110)
    body += segment(100, 100, 115, 100, 1.5, "F.Cu")
    body += segment(115, 100, 125, 100, 1.5, "B.Cu")
    body += via(115, 100, 0.8, 0.4)
    body += footprint("TPA", 100, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (1.0, 1.0)}
    ])
    body += footprint("TPB", 125, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "rect", "size": (1.0, 1.0),
         "layers": '"B.Cu"'}
    ], layer="B.Cu")
    d = out_dir / "gen_via_stack_4layer"
    d.mkdir(parents=True, exist_ok=True)
    (d / "gen_via_stack_4layer.kicad_pcb").write_text(
        header_4l + body + ")\n")
    (d / "gen_via_stack_4layer.kicad_sch").write_text(
        sch_with_text(["!padne VOLTAGE v=1V p=TPA.1 n=TPB.1"]))
    (d / "gen_via_stack_4layer.kicad_pro").write_text(
        json.dumps({"meta": {"filename": "gen_via_stack_4layer.kicad_pro"}}))


def gen_floating_island(out_dir: pathlib.Path):
    """Copper island with no electrical connection: must be dropped from
    the solve and triangulated for display (reference scenario:
    floating_copper; dead-network filtering solver.py:654-668)."""
    body = gr_rect(95, 95, 130, 112)
    body += segment(100, 100, 120, 100, 2.0)
    # floating island below the trace
    body += segment(100, 108, 120, 108, 2.0)
    body += footprint("TP1", 100, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "circle", "size": (1.0, 1.0)}
    ])
    body += footprint("TP2", 120, 100, 0, [
        {"name": "1", "kind": "smd", "shape": "circle", "size": (1.0, 1.0)}
    ])
    write_project(out_dir, "gen_floating_island", body,
                  ["!padne VOLTAGE v=2V p=TP2.1 n=TP1.1"])


def gen_regulator(out_dir: pathlib.Path):
    """Linear-regulator LDO scenario: three copper islands (input rail,
    regulated output rail, ground return), a 5 V input source, a
    REGULATOR holding the output at 3.3 V while mirroring gain-scaled
    load current into the input rail, and a 10 R load (reference
    RegulatorSpec kicad.py:720-733, stamps solver.py:512-538).

    Island rows (each a 12 mm x 1.5 mm trace):
      y=100: IN   TPI(100) -- U1(112)   (U1 = regulator input pin)
      y=104: OUT  U2(100)  -- TPO(112)  (U2 = regulator output pin)
      y=108: GND  NG(100)  -- UG(106) -- TPG(112)
    """
    body = gr_rect(95, 95, 120, 112)
    body += segment(100, 100, 112, 100, 1.5)
    body += segment(100, 104, 112, 104, 1.5)
    body += segment(100, 108, 112, 108, 1.5)
    pads = [{"name": "1", "kind": "smd", "shape": "rect",
             "size": (1.0, 1.0)}]
    for ref, x, y in (("TPI", 100, 100), ("U1", 112, 100),
                      ("U2", 100, 104), ("TPO", 112, 104),
                      ("NG", 100, 108), ("UG", 106, 108),
                      ("TPG", 112, 108)):
        body += footprint(ref, x, y, 0, pads)
    write_project(out_dir, "gen_regulator", body, [
        "!padne VOLTAGE v=5V p=TPI.1 n=NG.1",
        "!padne REGULATOR v=3.3V p=U2.1 n=UG.1 f=U1.1 t=UG.1 gain=0.9",
        "!padne RESISTANCE r=10R a=TPO.1 b=TPG.1",
    ])


def gen_resistor_divider(out_dir: pathlib.Path):
    """Lumped resistors bridging two trace islands: MNA resistor stamps
    (reference solver.py:475-484)."""
    body = gr_rect(95, 95, 135, 110)
    body += segment(100, 100, 112, 100, 1.5)
    body += segment(120, 100, 132, 100, 1.5)
    for ref, x in (("A1", 100), ("A2", 112), ("B1", 120), ("B2", 132)):
        body += footprint(ref, x, 100, 0, [
            {"name": "1", "kind": "smd", "shape": "rect",
             "size": (1.0, 1.0)}
        ])
    write_project(out_dir, "gen_resistor_divider", body, [
        "!padne VOLTAGE v=1V p=A1.1 n=B2.1",
        "!padne RESISTANCE r=100R a=A2.1 b=B1.1",
    ])


def four_layer_header() -> str:
    """PCB header with a 4-layer stackup (F / In1 / In2 / B)."""
    return PCB_HEADER.replace(
        '(0 "F.Cu" signal)\n    (31 "B.Cu" signal)',
        '(0 "F.Cu" signal)\n    (1 "In1.Cu" signal)\n'
        '    (2 "In2.Cu" signal)\n    (31 "B.Cu" signal)',
    ).replace(
        '(layer "dielectric 1" (type "core") (thickness 1.51) (material "FR4"))',
        '(layer "dielectric 1" (type "prepreg") (thickness 0.2) (material "FR4"))\n'
        '      (layer "In1.Cu" (type "copper") (thickness 0.0175))\n'
        '      (layer "dielectric 2" (type "core") (thickness 1.0) (material "FR4"))\n'
        '      (layer "In2.Cu" (type "copper") (thickness 0.0175))\n'
        '      (layer "dielectric 3" (type "prepreg") (thickness 0.2) (material "FR4"))',
    )


def gen_bench_4layer(out_dir, side: float = 60.0, n_vias: int = 7):
    """The north-star benchmark workload (BASELINE.md: "1M-DoF 4-layer
    board"): four full-area copper planes, an n_vias x n_vias stitching
    grid of through vias (each expands into the loader's hollow-cylinder
    resistor stack, reference kicad.py:1497-1585), a corner voltage
    source, a second remote forcing source, and two high-current loads
    pulling through the plane stack.  The MNA border therefore carries
    multiple source current variables plus the ground pin (m > 1), and
    every layer polygon is punched with the full via-hole grid.

    Mesh density (and thus the DoF count) is the bench runner's knob via
    Mesher.Config.maximum_size; geometry here is density-independent.
    """
    out_dir = pathlib.Path(out_dir)
    x0, y0 = 100.0, 100.0
    x1, y1 = x0 + side, y0 + side
    body = gr_rect(x0 - 2, y0 - 2, x1 + 2, y1 + 2)
    fill = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    for layer in ("F.Cu", "In1.Cu", "In2.Cu", "B.Cu"):
        body += zone(layer, fill, fill)
    # Stitching grid, inset from the edges so every hole is interior.
    inset = side / (n_vias + 1)
    for i in range(n_vias):
        for j in range(n_vias):
            body += via(x0 + inset * (i + 1), y0 + inset * (j + 1),
                        0.6, 0.3)
    pads = [{"name": "1", "kind": "smd", "shape": "rect",
             "size": (1.2, 1.2)}]
    pads_b = [{"name": "1", "kind": "smd", "shape": "rect",
               "size": (1.2, 1.2), "layers": '"B.Cu"'}]
    body += footprint("VIN", x0 + 2, y0 + 2, 0, pads)
    body += footprint("VRET", x1 - 2, y1 - 2, 0, pads_b, layer="B.Cu")
    body += footprint("SNS", x0 + 2, y1 - 2, 0, pads)
    body += footprint("SNSR", x1 - 2, y0 + 2, 0, pads_b, layer="B.Cu")
    # Load pads sit half an inset off the via grid so they never land
    # in a drilled hole.
    off = inset / 2
    body += footprint("LD1", x0 + side * 0.5 + off, y0 + side * 0.5 + off,
                      0, pads)
    body += footprint("LD1R", x0 + side * 0.5 - off, y0 + side * 0.5 - off,
                      0, pads_b, layer="B.Cu")
    body += footprint("LD2", x0 + side * 0.75 + off, y0 + side * 0.25 + off,
                      0, pads)
    body += footprint("LD2R", x0 + side * 0.25 - off, y0 + side * 0.75 - off,
                      0, pads_b, layer="B.Cu")
    name = "gen_bench_4layer"
    d = out_dir / name
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{name}.kicad_pcb").write_text(four_layer_header() + body + ")\n")
    (d / f"{name}.kicad_sch").write_text(sch_with_text([
        "!padne VOLTAGE v=1V p=VIN.1 n=VRET.1",
        "!padne VOLTAGE v=1V p=SNS.1 n=SNSR.1",
        "!padne CURRENT i=10A f=LD1.1 t=LD1R.1",
        "!padne CURRENT i=5A f=LD2.1 t=LD2R.1",
    ]))
    (d / f"{name}.kicad_pro").write_text(
        json.dumps({"meta": {"filename": f"{name}.kicad_pro"}}))
    return d / f"{name}.kicad_pro"


def generate_all(out_dir) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir)
    gen_strip(out_dir)
    gen_two_layer_via(out_dir)
    gen_zone_plane(out_dir)
    gen_rotated_pads(out_dir)
    gen_overlapping_vias(out_dir)
    gen_via_stack_4layer(out_dir)
    gen_floating_island(out_dir)
    gen_regulator(out_dir)
    gen_resistor_divider(out_dir)
    return out_dir
