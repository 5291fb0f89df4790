"""Field post-processing: per-face gradients and power density (device).

Port of padne_tpu.ops.postproc as torch ops in float64.  The solve's
meshes go through one concatenated call (vertex indices offset per mesh,
per-face conductance); with no compiler in the way, no padding buckets
are needed.  `power_density` takes one mesh.
"""

from __future__ import annotations

import numpy as np
import torch


def face_gradients(vertices: torch.Tensor, triangles: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """Gradient of the P1 (linear) interpolant on each face.

    vertices: (V, 2); triangles: (F, 3); values: (V,).  Returns (F, 2).
    For a triangle with CCW-signed area A and vertices a, b, c:
        grad f = (1 / 2A) * sum_k f_k * rot90(opposite_edge_k)
    with rot90(v) = (-v_y, v_x) and opposite_edge_k oriented CCW.
    Zero-area faces get a zero gradient."""
    p = vertices[triangles]          # (F, 3, 2)
    f = values[triangles]            # (F, 3)
    e = torch.stack([p[:, 2] - p[:, 1], p[:, 0] - p[:, 2],
                     p[:, 1] - p[:, 0]], dim=1)           # (F, 3, 2)
    rot = torch.stack([-e[..., 1], e[..., 0]], dim=-1)   # (F, 3, 2)
    area2 = (
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    )                                # signed 2*area
    nz = area2 != 0.0
    safe = torch.where(nz, area2, torch.ones_like(area2))
    grad = torch.einsum("fk,fkd->fd", f, rot) / safe[:, None]
    return torch.where(nz[:, None], grad, torch.zeros_like(grad))


def power_density(vertices: torch.Tensor, triangles: torch.Tensor,
                  values: torch.Tensor, conductance: float) -> torch.Tensor:
    """p = sigma * |grad V|^2 per face of one mesh (sigma = the layer's
    sheet conductance), on the tensors' device.  Returns (F,)."""
    g = face_gradients(vertices, triangles, values)
    return conductance * (g * g).sum(dim=1)


def power_density_batch(meshes, values_list, conductances,
                        device) -> list[np.ndarray]:
    """p = sigma * |grad V|^2 per face (sigma = layer sheet conductance)
    for MANY meshes in one call.  Returns a list of per-mesh (F,) host
    arrays."""
    if not meshes:
        return []
    nv = [m.num_vertices for m in meshes]
    nf = [len(m.triangles) for m in meshes]
    voff = np.concatenate([[0], np.cumsum(nv)])
    verts = np.concatenate([np.asarray(m.vertices, np.float64)
                            for m in meshes])
    vals = np.concatenate([np.asarray(v, np.float64) for v in values_list])
    tris = np.concatenate([np.asarray(m.triangles, np.int64) + voff[i]
                           for i, m in enumerate(meshes)])
    cond = np.repeat(np.asarray(conductances, np.float64), nf)
    g = face_gradients(torch.from_numpy(verts).to(device),
                       torch.from_numpy(tris).to(device),
                       torch.from_numpy(vals).to(device))
    pd = (torch.from_numpy(cond).to(device) * (g * g).sum(dim=1)).cpu()
    return [t.numpy() for t in torch.split(pd, nf)]
