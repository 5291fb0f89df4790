"""FEM stiffness assembly: edge weights -> ELL sparse operator (host).

Carried from padne_tpu.ops.assembly as numpy (that module imports
jax.numpy); `EllMatrix.to_device` uploads as torch tensors.  Sign
conventions follow the reference: A = -L_reference, symmetric positive
semidefinite with A[i,i] = sum_j w_ij and A[i,j] = -w_ij, where
w_ij >= 0 are |cot| edge weights times layer conductance plus lumped
resistor conductances 1/R.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class EllMatrix:
    """Padded ELL sparse matrix (row-major)."""

    cols: np.ndarray  # (N, K) int32; padding entries point at the row itself
    vals: np.ndarray  # (N, K) float; padding entries are 0
    diag: np.ndarray  # (N,) float — the diagonal, stored separately

    @property
    def shape(self):
        n = len(self.diag)
        return (n, n)

    def to_device(self, device, dtype=torch.float64):
        """(cols, vals, diag) as torch tensors on `device`: cols int32 and
        vals in `dtype`, both K-major (K, N) — the layout of the ELL
        kernel K3 (ops.spmv) — and diag (N,) in `dtype`."""
        from .spmv import to_kmajor

        cols, vals = to_kmajor(self.cols, self.vals, device, dtype)
        return cols, vals, torch.from_numpy(np.asarray(self.diag)).to(
            device=device, dtype=dtype)

    def to_scipy(self):
        """CSR of the full operator (off-diagonals + diagonal), diagonal
        first in each row."""
        import scipy.sparse

        n, k = self.cols.shape
        if n * k >= 1_000_000:
            # Native two-pass fill (exact-size buffers) instead of ~10
            # nnz-sized numpy temporaries.
            from .. import native

            indptr, indices, data = native.ell_to_csr(
                self.cols, self.vals, self.diag)
            return scipy.sparse.csr_matrix(
                (data, indices, indptr), shape=(n, n))
        nz = self.vals != 0
        counts = nz.sum(axis=1) + 1  # +1 for the diagonal
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        nnz = int(indptr[-1])
        indices = np.empty(nnz, dtype=np.int64)
        data = np.empty(nnz, dtype=np.float64)
        indices[indptr[:-1]] = np.arange(n)
        data[indptr[:-1]] = self.diag
        idx = np.flatnonzero(nz)
        rows_off = idx // k
        slot = (np.arange(len(rows_off)) -
                np.concatenate([[0], np.cumsum(nz.sum(axis=1))])[rows_off])
        pos = indptr[rows_off] + 1 + slot
        indices[pos] = self.cols.ravel()[idx]
        data[pos] = self.vals.ravel()[idx]
        return scipy.sparse.csr_matrix((data, indices, indptr), shape=(n, n))


def build_ell(n: int, edges: np.ndarray, weights: np.ndarray) -> EllMatrix:
    """Pack the symmetric graph Laplacian (PSD convention) into ELL:
    A[i,j] = -w_ij, A[i,i] = sum_j w_ij.  Duplicate edges accumulate;
    zero-weight edges are dropped (they connect nothing)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    weights = np.asarray(weights, dtype=np.float64)

    if len(edges) >= 100_000:
        # Native counting-sort pass: same semantics, columns ascending
        # within each row.
        from .. import native

        cols, vals, diag = native.build_ell(
            n, edges[:, 0], edges[:, 1], weights)
        return EllMatrix(cols=cols, vals=vals, diag=diag)

    keep = weights != 0.0
    edges, weights = edges[keep], weights[keep]

    if len(edges) == 0:
        return EllMatrix(
            cols=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 1)),
            vals=np.zeros((n, 1), dtype=np.float64),
            diag=np.zeros(n, dtype=np.float64),
        )

    diag = (np.bincount(edges[:, 0], weights=weights, minlength=n)
            + np.bincount(edges[:, 1], weights=weights, minlength=n))

    # Off-diagonal entries in both directions; duplicates merge through
    # one int64-key argsort + reduceat.
    ne = len(edges)
    key = np.empty(2 * ne, dtype=np.int64)
    np.left_shift(edges[:, 0], 32, out=key[:ne])
    np.left_shift(edges[:, 1], 32, out=key[ne:])
    np.bitwise_or(key[:ne], edges[:, 1], out=key[:ne])
    np.bitwise_or(key[ne:], edges[:, 0], out=key[ne:])
    vals = np.empty(2 * ne)
    np.negative(weights, out=vals[:ne])
    vals[ne:] = vals[:ne]
    order = np.argsort(key)
    key_s = key[order]
    vals_s = vals[order]
    new = np.empty(len(key_s), dtype=bool)
    new[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=new[1:])
    starts = np.nonzero(new)[0]
    merged = np.add.reduceat(vals_s, starts)
    ukey = key_s[starts]
    ur = ukey >> 32
    uc = ukey & 0xFFFFFFFF

    counts = np.bincount(ur, minlength=n)
    K = max(int(counts.max(initial=0)), 1)
    row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ur), dtype=np.int64) - row_start[ur]

    ell_cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    ell_vals = np.zeros((n, K), dtype=np.float64)
    ell_cols[ur, slot] = uc
    ell_vals[ur, slot] = merged
    return EllMatrix(
        cols=ell_cols.astype(np.int32), vals=ell_vals, diag=diag
    )


def connected_components(n: int, edges: np.ndarray, weights: np.ndarray):
    """Components of the weighted graph (w != 0 edges connect): the
    nullspace blocks of the assembled Laplacian, deflated by the CG.
    Returns (comp_id (n,) int32, num_components)."""
    import scipy.sparse
    from scipy.sparse.csgraph import connected_components as _cc

    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    weights = np.asarray(weights)
    e = edges[weights != 0.0]
    adj = scipy.sparse.coo_matrix(
        (np.ones(len(e), dtype=np.int8), (e[:, 0], e[:, 1])), shape=(n, n)
    ).tocsr()
    num, labels = _cc(adj, directed=False)
    return labels.astype(np.int32), int(num)
