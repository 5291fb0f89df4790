"""The board of the `fragmented_1m` configuration and its assembled
system, made with the frozen host pipeline (pdnbench/frozen) and never
with the program.

A multi-site board (a burn-in or multi-site test board, an LED-tile or
multi-output power board): a grid of device sites, each a square copper
island on F.Cu, over one ground zone on B.Cu.  Site t's supply holds its
island at 0.5 V + 2 mV t against the ground zone (a VOLTAGE directive
from a feed pad on the island to a B.Cu pad under it) and its device
draws 0.2 A + 2 mA t from the island (a CURRENT directive from a load
pad on the island to a second B.Cu pad under it).  So the board has one
copper component a site and the ground zone, and a border row a
site's supply and the ground pin.
"""

from __future__ import annotations

import hashlib
import os
import pathlib

import numpy as np

from . import inputs
from .frozen import boardgen

NAME = "site_board"
PAD = 1.2      # mm, square pads
INSET = 1.5    # mm from the island's corner to a pad's centre


def gen_site_board(out_dir, sites=(12, 12), island: float = 10.0,
                   pitch: float = 10.5) -> pathlib.Path:
    """The site board as a KiCad project under out_dir (2 layers, 1.6
    mm, 35 um copper: the generator's stackup): sites[0] x sites[1]
    islands of island x island mm at `pitch`, site t at column t //
    sites[1] and row t % sites[1]; returns its .kicad_pro path."""
    cols, rows = sites
    x0 = y0 = 100.0
    x1 = x0 + (cols - 1) * pitch + island
    y1 = y0 + (rows - 1) * pitch + island
    body = boardgen.gr_rect(x0 - 2, y0 - 2, x1 + 2, y1 + 2)
    ground = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    body += boardgen.zone("B.Cu", ground, ground)
    front = [{"name": "1", "kind": "smd", "shape": "rect",
              "size": (PAD, PAD)}]
    back = [{**front[0], "layers": '"B.Cu"'}]
    texts = []
    for t in range(cols * rows):
        sx = x0 + (t // rows) * pitch
        sy = y0 + (t % rows) * pitch
        square = [(sx, sy), (sx + island, sy), (sx + island, sy + island),
                  (sx, sy + island)]
        body += boardgen.zone("F.Cu", square, square)
        feed = (sx + INSET, sy + INSET)
        load = (sx + island - INSET, sy + island - INSET)
        body += boardgen.footprint(f"VS{t}", *feed, 0, front)
        body += boardgen.footprint(f"VG{t}", *feed, 0, back, layer="B.Cu")
        body += boardgen.footprint(f"LD{t}", *load, 0, front)
        body += boardgen.footprint(f"LG{t}", *load, 0, back, layer="B.Cu")
        texts.append(f"!padne VOLTAGE v={0.5 + 0.002 * t:.3f}V "
                     f"p=VS{t}.1 n=VG{t}.1")
        texts.append(f"!padne CURRENT i={0.2 + 0.002 * t:.3f}A "
                     f"f=LD{t}.1 t=LG{t}.1")
    out_dir = pathlib.Path(out_dir)
    boardgen.write_project(out_dir, NAME, body, texts)
    return out_dir / NAME / f"{NAME}.kicad_pro"


def _key(config: dict) -> str:
    """inputs' cache key of the configuration, with this file's source
    in it: a change of the board's generator makes new inputs."""
    h = hashlib.sha256(inputs._key(config).encode())
    h.update(pathlib.Path(__file__).read_bytes())
    return h.hexdigest()[:16]


def site_inputs(config: dict, tmp_dir) -> inputs.Inputs:
    """The configuration's assembled system at nominal values, as
    inputs.base_inputs makes and caches a generated board's: from the
    cache, or made with the frozen pipeline and cached.  Raises where
    the layers, n, m or the component count differ from the
    configuration's."""
    path = inputs.CACHE / f"{config['name']}-{_key(config)}.npz"
    if path.exists():
        with np.load(path, allow_pickle=False) as z:
            return inputs.Inputs({k: z[k] for k in z.files})
    from .frozen import kicad

    prob = kicad.load_kicad_project(
        gen_site_board(tmp_dir, **config["board"].get("args", {})))
    names = [layer.name for layer in prob.layers]
    if names != config["copper_layers"]:
        raise RuntimeError(f"{config['name']}: the board's layers are "
                           f"{names}, the configuration's copper_layers "
                           f"{config['copper_layers']}")
    arrays = inputs.assemble(prob, inputs.mesher_settings(config, prob))
    got = {"n": int(arrays["n"]), "m": len(arrays["b_rhs"]),
           "components": int(arrays["num_components"])}
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
