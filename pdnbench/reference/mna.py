"""The plain reference of a board with regulators: its full modified
nodal analysis (MNA) system, stamped here in float64 from the loaded
problem's elements, and solved directly.

    [[-A, C], [B, 0]] [v; j] = [r_core; rhs]

A is the Laplacian of the frozen mesh's edges and their weights (lumped
resistors are edges too).  The border is stamped again from the
voltage sources and regulators as the loaded problem states them
(railboard.assemble's src_* arrays: nodes, set points, gains), and not
from the frozen border arrays, with padne's semantics (its solver.py's
stamps):

* a voltage source (p, n, V) adds a current variable j: its row reads
  v_p - v_n = V, its column injects j at p and takes it from n;
* a regulator (p, n, f, t, V, gain) is such a source whose column also
  injects gain j at f and takes gain j from t: its output current,
  scaled, flows from t to f through it (its input current);
* a current source (f, t, I) takes I from f and injects it at t (the
  request's r_core: +I at f, -I at t);
* one more variable pins the ground: the negative terminal of the
  voltage source of the highest set point (regulators aside) held at 0.

It solves with SciPy's sparse direct solver (SuperLU), because torch
has no sparse direct solver, or on request (a small board in the tests)
with a dense LU in torch on the same entries.  Plain PyTorch, NumPy and
SciPy: no JAX, nothing of padne_tpu or padne_tpu_torch.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.linalg

def laplacian(n: int, edges, weights) -> scipy.sparse.csr_matrix:
    """A: w on both ends' diagonal, -w between them, for every edge."""
    a, b = edges[:, 0], edges[:, 1]
    rows = np.concatenate([a, b, a, b])
    cols = np.concatenate([a, b, b, a])
    vals = np.concatenate([weights, weights, -weights, -weights])
    return scipy.sparse.coo_matrix((vals, (rows, cols)),
                                   shape=(n, n)).tocsr()


def border(inp) -> tuple:
    """(B, C, volts): the constraint rows (m, n), the injection columns
    (n, m) and the rows' right-hand side at the set points, stamped from
    the problem's sources and regulators and the ground pin (last)."""
    n = inp.n
    rows, cols = [], []       # (variable, node, value)
    for k, (reg, (p, m_, f, t), gain) in enumerate(zip(
            inp.src_regulator, inp.src_nodes, inp.src_gain)):
        rows += [(k, p, 1.0), (k, m_, -1.0)]
        cols += [(k, p, 1.0), (k, m_, -1.0)]
        if reg:
            cols += [(k, f, gain), (k, t, -gain)]
    sources = ~np.asarray(inp.src_regulator, bool)
    ground = (int(inp.src_nodes[sources][np.argmax(
        inp.src_volts[sources]), 1]) if sources.any() else 0)
    g = len(inp.src_volts)
    rows.append((g, ground, 1.0))
    cols.append((g, ground, 1.0))
    m = g + 1

    def sparse(entries, transpose):
        k, node, val = (np.array(x) for x in zip(*entries))
        rc = (node, k) if transpose else (k, node)
        return scipy.sparse.coo_matrix(
            (val.astype(np.float64), rc),
            shape=(n, m) if transpose else (m, n)).tocsr()

    return (sparse(rows, False), sparse(cols, True),
            np.append(np.asarray(inp.src_volts, np.float64), 0.0))


class Reference:
    """The full system of one board (inputs.Inputs with railboard's
    src_* arrays), solved for any excitation, by the dense solve where
    `dense`, else the sparse one."""

    def __init__(self, inp, dense: bool = False):
        self.n = inp.n
        self.A = laplacian(inp.n, inp.edges, inp.weights)
        self.B, self.C, self.volts = border(inp)
        self.m = self.B.shape[0]
        self.dense = dense
        self._solve = None

    def matrix(self) -> scipy.sparse.csc_matrix:
        return scipy.sparse.bmat([[-self.A, self.C], [self.B, None]],
                                 format="csc")

    def solve(self, r_core, rhs) -> tuple[np.ndarray, np.ndarray]:
        """(v, j) in float64; the factorization is kept for the next
        excitation."""
        if self._solve is None:
            if self.dense:
                import torch

                lu = torch.linalg.lu_factor(torch.from_numpy(
                    self.matrix().toarray()))
                self._solve = lambda z: torch.linalg.lu_solve(
                    *lu, torch.from_numpy(z)[:, None])[:, 0].numpy()
            else:
                self._solve = scipy.sparse.linalg.splu(self.matrix()).solve
        z = self._solve(np.concatenate([r_core, rhs]).astype(np.float64))
        return z[:self.n], z[self.n:]
