"""Interactive solution viewer (port of padne_tpu.ui).

The reference ships a Qt6/OpenGL application (ui.py, 2.3k LoC).  This
framework's primary interactive viewer is matplotlib-based (always
available in scientific environments, works over X11/ssh/notebooks) and
shares its rendering model with the zero-dependency WebGL HTML export
(padne_tpu_torch.io.htmlview) for production use.  matplotlib is
imported inside the functions only: where it is missing or there is no
display, `main` writes that HTML viewer instead.

Features (parity targets from the reference viewer):
  * per-layer display with keyboard switching (keys 1..9)
  * Potential / Power density rendering modes (key m), plasma / inferno
    colormaps respectively (ui.py:959-976)
  * disconnected copper drawn in gray (ui.py:700-707)
  * click to probe the nearest vertex value (status line, V formatting
    via padne_tpu_torch.units)
  * min/max color-scale setting from probed points (keys n / x, reset r)

Closing the figure stops the raster timer and shuts the raster worker
pool down (`close`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import solver as solver_mod
from . import units

log = logging.getLogger(__name__)


@dataclass
class RenderingMode:
    name: str
    unit: str
    cmap_name: str

    @property
    def kind(self) -> str:
        """"vertex" (per-vertex field) or "face" (per-face field)."""
        return "vertex" if self.name == "Potential" else "face"

    def values_for(self, ls: solver_mod.LayerSolution, mesh_idx: int):
        if self.kind == "vertex":
            return ls.potentials[mesh_idx].values, "vertex"
        return ls.power_densities[mesh_idx].values, "face"


MODES = [
    RenderingMode("Potential", "V", "plasma"),
    RenderingMode("Power Density", "W/mm²", "inferno"),
]


class SolutionViewer:
    """Matplotlib figure wrapping one Solution."""

    def __init__(self, solution: solver_mod.Solution):
        import matplotlib.pyplot as plt

        self.solution = solution
        self.layer_idx = 0
        self.mode_idx = 0
        self.scale_override: Optional[tuple[float, float]] = None
        self.last_probe: Optional[float] = None
        self.show_edges = False
        self.show_connections = False
        self._executor = None          # raster worker pool, made on demand
        self._raster_timer = None
        self._raster_gen = 0
        self._pending_raster = None
        self._want_raster = None
        self._closed = False
        self.fig, self.ax = plt.subplots(figsize=(10, 8))
        self._close_with_figure()
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("button_press_event", self.on_click)
        self.fig.canvas.mpl_connect("scroll_event", self.on_scroll)
        self._build_scale_boxes()
        self.redraw()

    def _close_with_figure(self):
        """Run `close` when the figure closes.  plt.close and a closed
        window both end in the figure manager's destroy (Gcf.destroy);
        the Agg backend fires no close_event, so that is the hook."""
        manager = self.fig.canvas.manager
        if manager is None:
            return
        destroy = manager.destroy

        def destroy_and_close(*args, **kwargs):
            self.close()
            return destroy(*args, **kwargs)

        manager.destroy = destroy_and_close

    def close(self):
        """Stop the raster timer and shut the raster worker pool down;
        later raster requests are ignored."""
        self._closed = True
        if self._raster_timer is not None:
            self._raster_timer.stop()
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
        self._pending_raster = self._want_raster = None

    def _build_scale_boxes(self):
        """Editable color-scale bounds (the reference toolbar's
        EditableValueLabel, ui.py:1922-1994): two text boxes accepting
        SI-prefixed values via units.Value.parse; invalid input leaves
        the scale untouched and restores the displayed value."""
        from matplotlib.widgets import TextBox

        self.fig.subplots_adjust(bottom=0.14)
        ax_lo = self.fig.add_axes([0.12, 0.02, 0.16, 0.05])
        ax_hi = self.fig.add_axes([0.38, 0.02, 0.16, 0.05])
        self._box_lo = TextBox(ax_lo, "min ")
        self._box_hi = TextBox(ax_hi, "max ")
        self._box_lo.on_submit(lambda text: self._scale_edited(0, text))
        self._box_hi.on_submit(lambda text: self._scale_edited(1, text))
        self._box_guard = False

    def _scale_edited(self, which: int, text: str):
        if self._box_guard:   # programmatic set_val during redraw
            return
        try:
            parsed = units.Value.parse(text.replace("μ", "u"))
        except ValueError:
            self.redraw()     # restore the displayed value
            return
        lo, hi = self.value_range()
        new = (parsed.value, hi) if which == 0 else (lo, parsed.value)
        if new[1] > new[0]:
            self.scale_override = new
        self.redraw()

    # -- data access --------------------------------------------------------
    @property
    def layer_solution(self) -> solver_mod.LayerSolution:
        return self.solution.layer_solutions[self.layer_idx]

    @property
    def mode(self) -> RenderingMode:
        return MODES[self.mode_idx]

    def value_range(self):
        if self.scale_override:
            return self.scale_override
        vals = []
        for mi in range(len(self.layer_solution.meshes)):
            v, _ = self.mode.values_for(self.layer_solution, mi)
            if len(v):
                vals.append((v.min(), v.max()))
        if not vals:
            return (0.0, 1.0)
        lo = min(v[0] for v in vals)
        hi = max(v[1] for v in vals)
        return (lo, hi if hi > lo else lo + 1e-12)

    # -- drawing ------------------------------------------------------------
    # Display path budget: up to this many faces the figure draws
    # direct matplotlib triangles; beyond it, the FULL field is
    # rasterized into a viewport image by padne_tpu_torch.raster (every
    # triangle contributes — no decimation) on a 2-worker thread pool,
    # mirroring the reference's VBO + prepare-pool design
    # (ref ui.py:649-1142, 146-189).  Probing/scaling always use the
    # full data in both paths.
    DECIMATE_FACES = 200_000
    RASTER_SHAPE = (900, 1200)   # (H, W) render resolution

    def _total_faces(self) -> int:
        ls = self.layer_solution
        return sum(m.num_faces for m in ls.meshes) + sum(
            m.num_faces for m in ls.disconnected_meshes)

    def _raster_items(self):
        """(field items, disconnected items) for raster.rasterize_field
        — display coords (y flipped)."""
        ls = self.layer_solution
        items = []
        for mi, m in enumerate(ls.meshes):
            vals, kind = self.mode.values_for(ls, mi)
            v = np.column_stack([m.vertices[:, 0], -m.vertices[:, 1]])
            items.append((v, m.triangles, np.asarray(vals), kind))
        gray = []
        for m in ls.disconnected_meshes:
            v = np.column_stack([m.vertices[:, 0], -m.vertices[:, 1]])
            gray.append((v, m.triangles,
                         np.zeros(m.num_faces), "face"))
        return items, gray

    def _data_extent(self):
        ls = self.layer_solution
        xs, ys = [], []
        for m in list(ls.meshes) + list(ls.disconnected_meshes):
            if len(m.vertices):
                xs.append((m.vertices[:, 0].min(), m.vertices[:, 0].max()))
                ys.append(((-m.vertices[:, 1]).min(),
                           (-m.vertices[:, 1]).max()))
        if not xs:
            return (0.0, 1.0, 0.0, 1.0)
        x0 = min(a for a, _ in xs)
        x1 = max(b for _, b in xs)
        y0 = min(a for a, _ in ys)
        y1 = max(b for _, b in ys)
        mx = 0.02 * max(x1 - x0, 1e-9)
        my = 0.02 * max(y1 - y0, 1e-9)
        return (x0 - mx, x1 + mx, y0 - my, y1 + my)

    def _compute_raster(self, extent):
        """Worker-side: rasterize field + disconnected overlay."""
        from . import raster as raster_mod

        items, gray = self._raster_items()
        field = raster_mod.rasterize_field(items, extent,
                                           self.RASTER_SHAPE)
        gmask = (raster_mod.rasterize_field(gray, extent,
                                            self.RASTER_SHAPE)
                 if gray else None)
        return field, gmask

    def _apply_raster(self, field, gmask, extent, vmin, vmax):
        """GUI-thread side: blit the prepared rasters."""
        for art in getattr(self, "_raster_artists", []):
            try:
                art.remove()
            except ValueError:
                pass   # axes were cleared by a redraw meanwhile
        self._raster_artists = []
        if gmask is not None:
            g = np.where(np.isfinite(gmask), 0.35, np.nan)
            self._raster_artists.append(self.ax.imshow(
                g, origin="lower", extent=extent,
                cmap="gray", vmin=0, vmax=1, alpha=0.6,
                interpolation="nearest", zorder=1))
        im = self.ax.imshow(
            field, origin="lower", extent=extent,
            cmap=self.mode.cmap_name, vmin=vmin, vmax=vmax,
            interpolation="nearest", zorder=2)
        self._raster_artists.append(im)
        self.ax.set_xlim(extent[0], extent[1])
        self.ax.set_ylim(extent[2], extent[3])
        return im

    def _raster_async(self, extent, vmin, vmax):
        """Submit a full-data rasterization; a figure timer applies it
        when ready (stale view stays up meanwhile — same
        prepare-then-upload flow as the reference's DeferedDict).

        Debounced: while a rasterization is in flight, newer requests
        only overwrite the "next wanted view" — ten quick scroll ticks
        compute two rasters (the in-flight one and the latest), not
        ten full-resolution frames queued behind each other."""
        from concurrent.futures import ThreadPoolExecutor

        if self._closed:
            return
        if self._executor is None:
            self._executor = ThreadPoolExecutor(2)
        self._raster_gen += 1
        pend = self._pending_raster
        if pend is not None and not pend[1].done():
            self._want_raster = (extent, vmin, vmax)
        else:
            fut = self._executor.submit(self._compute_raster, extent)
            self._pending_raster = (self._raster_gen, fut, extent,
                                    vmin, vmax)
            self._want_raster = None
        timer = self._raster_timer
        if timer is None:
            timer = self.fig.canvas.new_timer(interval=100)
            timer.add_callback(self._poll_raster)
            self._raster_timer = timer
        timer.start()

    def _poll_raster(self):
        pend = self._pending_raster
        if pend is None:
            if self._raster_timer is not None:
                self._raster_timer.stop()
            return
        gen, fut, extent, vmin, vmax = pend
        if not fut.done():
            return
        self._pending_raster = None
        want = self._want_raster
        if want is not None:
            # A newer view was requested while this one computed:
            # submit it now (the stale result below is skipped by the
            # generation check).
            self._want_raster = None
            nfut = self._executor.submit(self._compute_raster, want[0])
            self._pending_raster = (self._raster_gen, nfut) + want
        if gen != self._raster_gen:
            return   # superseded by a newer request
        try:
            field, gmask = fut.result()
        except Exception:
            # A failed worker (e.g. MemoryError on the raster buffer)
            # must not kill the timer loop or leave the axes blank
            # silently.
            log.exception("raster worker failed; view not updated")
            return
        self._apply_raster(field, gmask, extent, vmin, vmax)
        self.fig.canvas.draw_idle()

    def redraw(self):
        self.ax.clear()
        self._raster_artists = []   # clear() already removed them
        ls = self.layer_solution
        vmin, vmax = self.value_range()
        raster_mode = self._total_faces() > self.DECIMATE_FACES
        tp = None
        if raster_mode:
            # Full-fidelity image path: show the data extent now,
            # rasterize every triangle on the worker pool.
            from matplotlib import cm as _cm

            extent = self._data_extent()
            tp = _cm.ScalarMappable(cmap=self.mode.cmap_name)
            tp.set_clim(vmin, vmax)
            self._raster_async(extent, vmin, vmax)
        else:
            for m in ls.disconnected_meshes:
                tris = m.triangles
                self.ax.tripcolor(
                    m.vertices[:, 0], -m.vertices[:, 1], tris,
                    facecolors=np.zeros(len(tris)),
                    cmap="gray", vmin=-1, vmax=1, alpha=0.6,
                )
            for mi, m in enumerate(ls.meshes):
                vals, kind = self.mode.values_for(ls, mi)
                if kind == "vertex":
                    tp = self.ax.tripcolor(
                        m.vertices[:, 0], -m.vertices[:, 1],
                        m.triangles, vals,
                        shading="gouraud", cmap=self.mode.cmap_name,
                        vmin=vmin, vmax=vmax,
                    )
                else:
                    tp = self.ax.tripcolor(
                        m.vertices[:, 0], -m.vertices[:, 1],
                        m.triangles, facecolors=vals,
                        cmap=self.mode.cmap_name,
                        vmin=vmin, vmax=vmax,
                    )
        if self.show_edges and not raster_mode:
            for m in ls.meshes:
                self.ax.triplot(
                    m.vertices[:, 0], -m.vertices[:, 1],
                    m.triangles,
                    color="black", linewidth=0.15, alpha=0.5,
                )
        if self.show_connections:
            layer = self.solution.problem.layers[self.layer_idx]
            for net in self.solution.problem.networks:
                color = "red" if net.has_source else "gray"
                pts = [c.point for c in net.connections if c.layer is layer]
                if pts:
                    self.ax.plot(
                        [p.x for p in pts], [-p.y for p in pts], "o",
                        color=color, markersize=4, markeredgecolor="black",
                        markeredgewidth=0.3, zorder=5,
                    )
        layer_name = self.solution.problem.layers[self.layer_idx].name
        if raster_mode:
            layer_name += " (full-data raster)"
        lo = units.Value(vmin, self.mode.unit).pretty_format()
        hi = units.Value(vmax, self.mode.unit).pretty_format()
        if getattr(self, "_box_lo", None) is not None:
            # Mirror the displayed bounds into the editable boxes
            # without re-entering the submit callbacks ("μ" -> "u" so
            # the prefilled text round-trips through Value.parse).
            self._box_guard = True
            try:
                self._box_lo.set_val(lo.replace("μ", "u"))
                self._box_hi.set_val(hi.replace("μ", "u"))
            finally:
                self._box_guard = False
        self.ax.set_title(
            f"{layer_name} — {self.mode.name} [{lo} .. {hi}]\n"
            "keys: 1-9 layer, m mode, e edges, c connections, "
            "n/x scale from probe, r reset"
        )
        self.ax.set_aspect("equal")
        if tp is not None:
            if not getattr(self, "_cbar", None):
                self._cbar = self.fig.colorbar(tp, ax=self.ax, fraction=0.04)
            else:
                # Rebind the colorbar to the freshly drawn mappable so a
                # mode/layer/scale change updates its norm and colormap.
                self._cbar.update_normal(tp)
        self.fig.canvas.draw_idle()

    # -- interaction --------------------------------------------------------
    def on_key(self, event):
        if event.key and event.key.isdigit():
            idx = int(event.key) - 1
            if 0 <= idx < len(self.solution.layer_solutions):
                self.layer_idx = idx
                self.redraw()
        elif event.key == "m":
            self.mode_idx = (self.mode_idx + 1) % len(MODES)
            # The override is in the previous mode's units (V vs W/mm²);
            # carrying it across modes would clamp with the wrong scale.
            self.scale_override = None
            self.last_probe = None
            self.redraw()
        elif event.key == "e":
            self.show_edges = not self.show_edges
            self.redraw()
        elif event.key == "c":
            self.show_connections = not self.show_connections
            self.redraw()
        elif event.key == "r":
            self.scale_override = None
            self.redraw()
        elif event.key in ("n", "x") and self.last_probe is not None:
            lo, hi = self.value_range()
            if event.key == "n":
                self.scale_override = (self.last_probe, hi)
            else:
                self.scale_override = (lo, self.last_probe)
            self.redraw()

    def _probe_index(self):
        """Lazily built picker for the current layer + mode (replaces an
        O(V) scan per click; same indexes the reference wires into its
        tools, reference ui.py:191-267).  Vertex values (potential) pick
        the nearest mesh vertex; face values (power density) pick the
        CONTAINING face via FaceSpatialIndex."""
        from . import spatial

        kind = self.mode.kind
        key = (id(self.layer_solution), kind)
        if getattr(self, "_probe_key", None) != key:
            self._probe_key = key
            index_cls = (spatial.FaceSpatialIndex if kind == "face"
                         else spatial.VertexSpatialIndex)
            self._probe_tree = index_cls(self.layer_solution)
        return self._probe_tree

    def probe_value(self, x: float, y: float) -> Optional[float]:
        """Value under board point (x, y) in the current mode, or None
        off-copper.  Vertex modes: nearest vertex; face modes: the
        containing face's density."""
        ls = self.layer_solution
        if not ls.meshes:
            return None
        pick = self._probe_index().query(x, y)
        if pick is None:
            return None
        vals, _ = self.mode.values_for(ls, pick.mesh_index)
        return float(vals[pick.item_index])

    def on_click(self, event):
        if event.xdata is None:
            return
        x, y = float(event.xdata), -float(event.ydata)
        value = self.probe_value(x, y)
        if value is not None:
            self.last_probe = value
            txt = units.Value(value, self.mode.unit).pretty_format(4)
            log.info("Probe at (%.3f, %.3f): %s", x, y, txt)
            self.ax.set_xlabel(f"probe: {txt}")
            self.fig.canvas.draw_idle()

    def on_scroll(self, event):
        """Zoom toward/away from the cursor (reference ui.py zoom-to-
        cursor behavior).  In raster mode the zoomed view re-rasterizes
        asynchronously at the new extent (the stale image scales
        meanwhile)."""
        if event.xdata is None:
            return
        f = 1 / 1.25 if event.button == "up" else 1.25
        x0, x1 = self.ax.get_xlim()
        y0, y1 = self.ax.get_ylim()
        cx, cy = float(event.xdata), float(event.ydata)
        nx = (cx + (x0 - cx) * f, cx + (x1 - cx) * f)
        ny = (cy + (y0 - cy) * f, cy + (y1 - cy) * f)
        self.ax.set_xlim(*nx)
        self.ax.set_ylim(*ny)
        if self._total_faces() > self.DECIMATE_FACES:
            vmin, vmax = self.value_range()
            self._raster_async((nx[0], nx[1], ny[0], ny[1]),
                               vmin, vmax)
        self.fig.canvas.draw_idle()


def main(solution: solver_mod.Solution, captured_warnings=None) -> int:
    """Open the viewer.  Falls back to writing an HTML viewer next to the
    CWD when no interactive display is available."""
    captured_warnings = captured_warnings or []
    for w in captured_warnings:
        log.warning("Solver warning: %s", w.message)

    try:
        import matplotlib

        backend = matplotlib.get_backend().lower()
        headless = "agg" in backend and "webagg" not in backend
    except Exception:
        headless = True

    if headless:
        from .io import htmlview

        out = "padne_tpu_view.html"
        htmlview.export_html(solution, out)
        print(
            f"No interactive display available; wrote standalone viewer to "
            f"{out} — open it in any browser."
        )
        return 0

    import matplotlib.pyplot as plt

    SolutionViewer(solution)
    plt.show()
    return 0
