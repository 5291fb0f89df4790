"""The bordered system's equations, in float64 on the host, and the
numbers that judge an answer against them.

The full system is [[-A, C], [B, 0]] [v; j] = [r_core; rhs]: A the
assembled Laplacian, C the border's injection columns, B its constraint
rows (the program's ops.schur layout, rebuilt here from the frozen
arrays).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.linalg


class Bordered:
    """B, C and the operator A (a frozen EllMatrix) of one system."""

    def __init__(self, inp, ell):
        n, m = inp.n, inp.m
        self.A = ell.to_scipy()
        self.C = scipy.sparse.coo_matrix(
            (inp.b_col_val, (inp.b_col_node, inp.b_col_idx)),
            shape=(n, m)).tocsr()
        self.B = scipy.sparse.coo_matrix(
            (inp.b_row_val, (inp.b_row_idx, inp.b_row_node)),
            shape=(m, n)).tocsr()
        self._lu = None

    def rel_residual(self, r_core, rhs, v, j) -> float:
        """||[r_core + A v - C j; rhs - B v]|| / ||[r_core; rhs]||, the
        2-norm relative residual of an answer (v, j)."""
        v = np.asarray(v, np.float64)
        j = np.asarray(j, np.float64)
        if v.shape != (self.A.shape[0],) or j.shape != (self.C.shape[1],):
            return float("inf")
        rc = r_core + self.A @ v - self.C @ j
        rb = rhs - self.B @ v
        res = np.sqrt((rc ** 2).sum() + (rb ** 2).sum())
        return float(res / np.sqrt((r_core ** 2).sum() + (rhs ** 2).sum()))

    def direct(self, r_core, rhs) -> tuple[np.ndarray, np.ndarray]:
        """(v, j) by SciPy's sparse direct solver (SuperLU) in float64;
        the factors are kept for the next right-hand side."""
        n = self.A.shape[0]
        if self._lu is None:
            L = scipy.sparse.bmat([[-self.A, self.C], [self.B, None]],
                                  format="csc")
            self._lu = scipy.sparse.linalg.splu(L)
        z = self._lu.solve(np.concatenate([r_core, rhs]))
        return z[:n], z[n:]


def vertex_potentials(inp, v) -> np.ndarray:
    """The mesh vertices' potentials of a core solution v, layer by
    layer and within a layer mesh by mesh: the order of the program's
    Solution.layer_solutions."""
    offsets = np.concatenate([[0], np.cumsum(inp.mesh_vertices)])
    out = []
    for layer in np.unique(inp.mesh_layer):
        for i in np.flatnonzero(inp.mesh_layer == layer):
            out.append(v[offsets[i]:offsets[i + 1]])
    return np.concatenate(out)


def max_abs_diff(a, b) -> float:
    """max |a - b|; inf where the shapes differ (another mesh)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float(np.abs(a - b).max())
