"""Full-data field rasterization for the interactive viewer (port of
padne_tpu.raster, numpy only: the viewer rasterizes on the host).

The reference viewer draws every triangle of big solutions through
OpenGL VBOs (ref ui.py:649-1142).  A matplotlib `tripcolor` at 1M
triangles hangs the figure for minutes, so this module provides the
equivalent interactivity guarantee WITHOUT decimation: rasterize the
complete field into a viewport-resolution image with vectorized numpy
(every triangle contributes), and let the figure blit one `imshow`
image.  Re-rasterization on zoom/pan runs on a worker thread
(padne_tpu_torch.ui), mirroring the reference's 2-worker prepare pool
(ref ui.py:146-189, 949-1005).

Algorithm: triangles are projected to pixel space, culled against the
viewport, and split by bounding-box size.  The small ones (almost all
of them, at scale) are filled by testing a fixed KxK candidate-pixel
grid per triangle with vectorized barycentric coordinates — one numpy
pass per chunk, no Python loop.  The rare screen-large triangles take
a per-triangle meshgrid fill.  Overlaps don't exist within a layer
(meshes partition the copper), so plain scatter order suffices.
"""

from __future__ import annotations

import numpy as np

# Candidate-grid edge for the vectorized small-triangle fill.  At the
# scales where rasterization replaces direct drawing (>200k faces),
# nearly every triangle spans < 4 px.
SMALL_K = 4


def _fill_chunk(raster, v_px, tris, tvals, kind, W, H, eps=1e-9):
    """Vectorized fill of triangles whose pixel bbox fits SMALL_K."""
    p0 = v_px[tris[:, 0]]
    p1 = v_px[tris[:, 1]]
    p2 = v_px[tris[:, 2]]
    lo = np.floor(np.minimum(np.minimum(p0, p1), p2)).astype(np.int64)
    hi = np.ceil(np.maximum(np.maximum(p0, p1), p2)).astype(np.int64)
    # Viewport cull.
    vis = ((hi[:, 0] >= 0) & (lo[:, 0] < W)
           & (hi[:, 1] >= 0) & (lo[:, 1] < H))
    span = hi - lo
    small = vis & (span[:, 0] < SMALL_K) & (span[:, 1] < SMALL_K)
    big_idx = np.nonzero(vis & ~small)[0]

    idx = np.nonzero(small)[0]
    if len(idx):
        a0, a1, a2 = p0[idx], p1[idx], p2[idx]
        base = lo[idx]
        # Candidate pixel centers: base + (di, dj) for di, dj in [0, K).
        K = SMALL_K
        di = np.arange(K)
        cx = base[:, None, 0] + di[None, :]          # (T, K)
        cy = base[:, None, 1] + di[None, :]
        px = cx[:, :, None] + 0.5                     # (T, K, 1)
        py = cy[:, None, :] + 0.5                     # (T, 1, K)
        d = ((a1[:, 0] - a0[:, 0]) * (a2[:, 1] - a0[:, 1])
             - (a2[:, 0] - a0[:, 0]) * (a1[:, 1] - a0[:, 1]))
        # Degenerate (zero-area) slivers must paint NOTHING: with d
        # replaced by inf the barycentric pair collapses to (1, 0, 0)
        # and every candidate pixel would read as inside, splatting a
        # KxK block of the sliver's vertex-0 value over neighbors.
        nondegen = (np.abs(d) >= eps)[:, None, None]
        d = np.where(np.abs(d) < eps, np.inf, d)[:, None, None]
        l1 = (((px - a0[:, 0, None, None]) * (a2[:, 1] - a0[:, 1])[:, None, None]
               - (py - a0[:, 1, None, None]) * (a2[:, 0] - a0[:, 0])[:, None, None])
              / d)
        l2 = (((py - a0[:, 1, None, None]) * (a1[:, 0] - a0[:, 0])[:, None, None]
               - (px - a0[:, 0, None, None]) * (a1[:, 1] - a0[:, 1])[:, None, None])
              / d)
        l0 = 1.0 - l1 - l2
        inside = ((l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
                  & nondegen)
        ix = np.broadcast_to(cx[:, :, None], inside.shape)
        iy = np.broadcast_to(cy[:, None, :], inside.shape)
        inside = inside & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        if kind == "vertex":
            t = tris[idx]
            val = (l0 * tvals[t[:, 0]][:, None, None]
                   + l1 * tvals[t[:, 1]][:, None, None]
                   + l2 * tvals[t[:, 2]][:, None, None])
        else:
            val = np.broadcast_to(
                tvals[idx][:, None, None], inside.shape)
        flat = (iy * W + ix)[inside]
        raster.ravel()[flat] = val[inside]

    # Screen-large triangles: rare — per-triangle meshgrid fill.
    for t in big_idx:
        a0, a1, a2 = p0[t], p1[t], p2[t]
        x0 = max(int(lo[t, 0]), 0)
        x1 = min(int(hi[t, 0]) + 1, W)
        y0 = max(int(lo[t, 1]), 0)
        y1 = min(int(hi[t, 1]) + 1, H)
        if x0 >= x1 or y0 >= y1:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1) + 0.5,
                             np.arange(y0, y1) + 0.5)
        d = ((a1[0] - a0[0]) * (a2[1] - a0[1])
             - (a2[0] - a0[0]) * (a1[1] - a0[1]))
        if abs(d) < eps:
            continue
        l1 = ((gx - a0[0]) * (a2[1] - a0[1])
              - (gy - a0[1]) * (a2[0] - a0[0])) / d
        l2 = ((gy - a0[1]) * (a1[0] - a0[0])
              - (gx - a0[0]) * (a1[1] - a0[1])) / d
        l0 = 1.0 - l1 - l2
        inside = (l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
        if kind == "vertex":
            tv = tris[t]
            val = (l0 * tvals[tv[0]] + l1 * tvals[tv[1]]
                   + l2 * tvals[tv[2]])
        else:
            val = np.full(inside.shape, tvals[t])
        sub = raster[y0:y1, x0:x1]
        sub[inside] = val[inside] if kind == "vertex" else tvals[t]


def rasterize_field(items, extent, shape, chunk: int = 200_000):
    """Rasterize a complete per-layer field.

    items: iterable of (vertices (V, 2), triangles (T, 3), values,
    kind) where kind is "vertex" (values per vertex, interpolated) or
    "face" (values per face, flat).  `vertices` are DISPLAY coords
    (caller flips y).  extent = (x0, x1, y0, y1) display window;
    shape = (H, W) pixels.  Returns a float64 (H, W) raster, NaN where
    no triangle covers the pixel center (drawn transparent).
    """
    H, W = shape
    x0, x1, y0, y1 = extent
    sx = W / max(x1 - x0, 1e-300)
    sy = H / max(y1 - y0, 1e-300)
    raster = np.full((H, W), np.nan)
    for verts, tris, vals, kind in items:
        if len(tris) == 0:
            continue
        v_px = np.empty_like(verts, dtype=np.float64)
        v_px[:, 0] = (verts[:, 0] - x0) * sx
        v_px[:, 1] = (verts[:, 1] - y0) * sy
        vals = np.asarray(vals, dtype=np.float64)
        for s in range(0, len(tris), chunk):
            # Face values index triangles, so slice them alongside the
            # chunk; vertex values index the (full) vertex array.
            tv = vals[s:s + chunk] if kind == "face" else vals
            _fill_chunk(raster, v_px, np.asarray(tris[s:s + chunk]),
                        tv, kind, W, H)
    return raster
