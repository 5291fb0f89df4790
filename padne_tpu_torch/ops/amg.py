"""Smoothed-aggregation AMG: host setup + device cycle, on DIA and ELL levels.

Port of padne_tpu.ops.amg.  DIA half: the host build (Hilbert
order, capped aggregation, smoothed prolongation, Galerkin operators,
aligned padded row layouts, dense coarse inverse; with tp > 1 the
prefix of levels that shards) is carried as numpy and calls the port's
own copy of the native core (..native).  The device cycle is plain torch
around ops.dia matvecs (kernel K1' on every level, however small) in the
transposed (R, n) layout; every transfer between levels is a reshape
plus a child-permutation scatter/gather.  `make_vcycle_dia_sharded` runs
the sharded prefix row-sharded over a mesh (ops.dia_sharded), with level
0 the exact CG operator as in the JAX package, and the rest as
`make_vcycle_dia_t` does.  The one-device cycle also takes the
JAX package's A/B alternatives (Chebyshev smoothing, V(s,s), the exact
level 0) as arguments, and the coarse inverse may be built on the
device (`_coarse_inv_on_device`).

ELL half (the generic route): `build_hierarchy` (greedy aggregation,
smoothed prolongation, Galerkin coarse operators, dense pinv bottom) is
carried as numpy; `make_vcycle` runs every level product through kernel
K3' (ops.spmv), on one device or row-sharded over a mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import spans
from ..utils.validation import checked
from . import assembly, bell, dia


def _lambda_max_dinv_a(A, iters: int = 12, seed: int = 3) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) (host, a dozen CSR
    SpMVs).  The iterates live in two buffers: no fresh pages an
    iteration.  Falls back to the Gershgorin-style bound 2.0 on
    degenerate input."""
    n = A.shape[0]
    if n == 0:
        return 2.0
    d = np.asarray(A.diagonal())
    dinv = 1.0 / np.where(d > 0, d, 1.0)
    y, x_next = np.empty(n), np.empty(n)

    def dinv_a(v):
        return np.multiply(dinv, A @ v, out=y)

    x = np.random.default_rng(seed).standard_normal(n)
    for _ in range(iters):
        y = dinv_a(x)
        ny = np.linalg.norm(y)
        if not np.isfinite(ny) or ny == 0:
            return 2.0
        x = np.divide(y, ny, out=x_next)
    lam = float(x @ dinv_a(x))
    if not np.isfinite(lam) or lam <= 0:
        return 2.0
    return lam


def _strength_pattern(A, theta: float, threads=None):
    """(indptr, indices) int32 CSR pattern of the strong-connection graph
    |a_ij| >= theta * sqrt(d_i d_j), diagonal excluded (native, by row
    blocks; `threads` as native.threads_for takes it)."""
    from .. import native

    A = A.tocsr()
    d = np.asarray(A.diagonal())
    return native.strength_csr(A, np.where(d > 0, d, 1.0), theta,
                               threads=threads)


def _aggregate_capped(A, cap: int, theta: float = 0.08, strength=None):
    """Greedy aggregation with a hard size cap (native sweep), so fine
    rows can be laid out as (aggregate, slot) with `cap` slots each.

    strength: optional prebuilt (indptr, indices) from _strength_pattern
    — reused across the cap retry loop."""
    import ctypes

    from .. import native

    n = A.shape[0]
    indptr, indices = (strength if strength is not None
                       else _strength_pattern(A, theta))
    agg32 = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nc = native.lib.pg_greedy_aggregate_capped(
        np.ascontiguousarray(indptr).ctypes.data_as(i32p),
        np.ascontiguousarray(indices).ctypes.data_as(i32p),
        n, cap, agg32.ctypes.data_as(i32p),
    )
    return agg32.astype(np.int64), int(nc)


@dataclass
class AlignedLevel:
    """One DIA level: operator pack + damping weights + child geometry."""

    pack: dia.DiaPack
    dinv: np.ndarray        # (np_,) f64, 0 on dummy rows
    omega_p: float          # prolongation-smoothing weight
    omega_s: float          # cycle-smoothing weight
    cap: int                # slots per aggregate at this level
    child_len: int          # padded length of the child level's vectors
    child_perm: np.ndarray  # (nc,) child row -> child padded position
    shard: bool = False     # row-shardable over the tp axis (ops.dia_sharded)
    lam: float = 0.0        # 1.1-margin estimate of lambda_max(D^-1 A)


@dataclass
class AlignedHierarchy:
    levels: list[AlignedLevel]
    posmap0: np.ndarray         # (n,) original index -> level-0 position
    np0: int                    # level-0 padded length
    # (npL, npL) f32 dense pseudo-inverse of the padded coarsest
    # operator, or a zero-arg callable computing it on first access.
    _coarse: object = None
    # The coarsest operator (scipy sparse) and its sizes, real and
    # padded, from which _coarse_inv_on_device builds the inverse on the
    # device.
    coarse_sp: object = None
    coarse_nL: int = 0
    coarse_npL: int = 0
    # The most threads a native set-up loop of the build ran on
    # (native.threads_for), 1 where all ran serially.
    setup_threads: int = 1

    @property
    def coarse_inv(self) -> np.ndarray:
        if callable(self._coarse):
            self._coarse = self._coarse()
        return self._coarse


def _eigh_pinv(Ad: np.ndarray) -> np.ndarray:
    """True pseudo-inverse via syevd, cut at 1e-6 * lambda_max: the exact
    nullspace is deflated by the CG, and inverting near-null junk modes
    would turn the preconditioner into an amplifier.  f32 throughout
    (preconditioner-grade), on the spectrum scaled to unit |A|_max."""
    import scipy.linalg

    d_scale = max(float(np.abs(Ad).max()), 1e-300)
    w_eig, V = scipy.linalg.eigh(
        (Ad / d_scale).astype(np.float32), driver="evd",
        check_finite=False)
    lam_max = max(float(w_eig[-1]), 1e-300)
    keep = w_eig > 1e-6 * lam_max
    w_inv = np.where(keep, 1.0 / np.where(keep, w_eig, 1.0),
                     np.float32(0.0)).astype(np.float32)
    w_inv /= np.float32(d_scale)
    return (V * w_inv[None, :]) @ V.T


def _coarse_inv_dense(A_sp, Ad: np.ndarray) -> np.ndarray:
    """Coarse-bottom dense inverse with pseudo-inverse semantics.

    Shift the structural nullspace (per connected component of the
    bottom operator) out of the way and Cholesky-invert,
    M = A/s + lam_g * Z Z^T, inv = M^-1 / s; for symmetric A, M^-1 acts
    like the pseudo-inverse on the deflated residuals the cycle feeds
    it.  A failed Cholesky, or a top mode of M^-1 beyond the pinv cut
    (non-structural near-null junk), takes the syevd pseudo-inverse."""
    import logging

    import scipy.sparse.csgraph as csgraph
    from scipy.linalg.lapack import dpotrf, dpotri

    log = logging.getLogger(__name__)
    nL = Ad.shape[0]
    d_scale = max(float(np.abs(Ad).max()), 1e-300)
    As = (Ad / d_scale).astype(np.float64)
    ncomp, labels = csgraph.connected_components(A_sp, directed=False)
    lam_g = max(float(np.abs(As).sum(axis=1).max()), 1e-300)
    M = As.copy()
    for c in range(ncomp):
        idx = np.nonzero(labels == c)[0]
        M[np.ix_(idx, idx)] += lam_g / len(idx)
    cfac, info = dpotrf(M, lower=1, overwrite_a=1, clean=0)
    if info == 0:
        inv, info = dpotri(cfac, lower=1, overwrite_c=1)
    if info != 0:
        log.info("coarse inverse: Cholesky reported junk (info=%d), "
                 "using the syevd pseudo-inverse", info)
        return _eigh_pinv(Ad)
    inv = np.tril(inv)
    inv = inv + inv.T - np.diag(np.diag(inv))
    rng = np.random.default_rng(7)
    v = rng.normal(size=nL)
    for _ in range(20):
        v = inv @ v
        v /= max(float(np.linalg.norm(v)), 1e-300)
    mu_max = float(v @ (inv @ v))
    w = rng.normal(size=nL)
    for _ in range(10):
        w = As @ w
        w /= max(float(np.linalg.norm(w)), 1e-300)
    lam_max = max(float(w @ (As @ w)), 1e-300)
    if mu_max > 1.0 / (1e-6 * lam_max):
        log.info("coarse inverse: near-null junk beyond the structural "
                 "nullspace (1/mu=%.2e < 1e-6*lam=%.2e), using the syevd "
                 "pseudo-inverse", 1.0 / mu_max, 1e-6 * lam_max)
        return _eigh_pinv(Ad)
    return (inv / d_scale).astype(np.float32)


def build_hierarchy_dia(
    ell,
    coords: np.ndarray,
    cap: int = 8,
    theta: float = 0.08,
    coarse_size: int = 400,
    max_levels: int = 12,
    alpha: float = 1.66,
    coverage: float = 0.95,
    max_offsets: int = 8,
    smooth_levels: int = 2,
    drop_tol: float = 1e-4,
    tp: int = 1,
    shard_min: int = 32768,
    group: "np.ndarray | None" = None,
    a_csr=None,
    deep_max_offsets: "int | None" = 24,
    deep_coverage: "float | None" = 0.995,
    coarse_eigh: bool = False,
) -> AlignedHierarchy:
    """Gather-free AMG setup (host).

    Hilbert-order the fine operator, then per level: capped aggregation
    -> smoothed prolongation + Galerkin coarse operator.  Each level's
    rows sit at (aggregate) * cap + slot, padded with inert dummy rows
    (zero matrix rows/columns, zero dinv), so every transfer on the
    device is a reshape.  Levels >= 1 may widen the offset budget
    (deep_max_offsets / deep_coverage); level 0 keeps max_offsets.

    tp > 1: a prefix of levels of at least max(shard_min, tp * 1024)
    padded rows shards over tp devices (`shard`, decided finally by
    ops.dia_sharded.shardable): those levels pad to whole grid steps per
    shard (tp * 1024 rows) and keep the narrow offset budget, since a
    wider one grows the halo past the one-neighbour reach.

    a_csr: caller-provided CSR of the same operator (skips a second
    ELL->CSR conversion).

    coarse_eigh: the host coarse inverse by the syevd pseudo-inverse
    alone (_eigh_pinv), without the Cholesky fast path (the JAX
    package's PADNE_TPU_COARSE_EIGH).

    The native loops (permutation, strength filter, DIA packing,
    Galerkin product) run by row blocks on native.threads_for(rows)
    threads, with the serial loop's bits (`setup_threads`: the most).
    Spans: `hierarchy.order` (Hilbert orders, permutation),
    `hierarchy.aggregate` (strength, aggregation), `hierarchy.lambda`,
    `hierarchy.pack`, `hierarchy.galerkin` a level, and
    `hierarchy.coarse_inv` where the host coarse inverse is built."""
    import scipy.sparse

    from .. import native

    A = ell.to_scipy() if a_csr is None else a_csr
    n0 = A.shape[0]
    threads = 1
    with spans.span("hierarchy.order"):
        # Group-aware sweep: stacked layers share one (x, y) footprint,
        # and a layer-blind sweep interleaves them off the slab offsets.
        perm0 = bell.hilbert_order(coords, group=group)
        inv0 = np.empty(n0, dtype=np.int64)
        inv0[perm0] = np.arange(n0)
        if A.nnz >= 200_000:
            A = native.csr_permute(A, perm0)
            threads = native.threads_for(n0)
        else:
            A = A[perm0][:, perm0].tocsr()
        lvl_group = (np.asarray(group)[perm0] if group is not None
                     else None)
        lvl_coords = coords[perm0]

    levels = []
    all_pos = []        # per level: row index -> padded position
    for level_i in range(max_levels):
        if A.shape[0] <= coarse_size:
            break
        nl = A.shape[0]
        cap_l = cap
        # Deep levels relax the strength filter (denser, heterogeneous
        # Galerkin operators would otherwise stall coarsening).
        theta_l = theta if level_i < 3 else theta / 4.0
        threads = max(threads, native.threads_for(nl))
        # The estimate comes first: its norms leave numpy's BLAS threads
        # spinning for a while, and the mostly serial aggregation and
        # ordering, not the threaded pack and Galerkin product, then
        # share the cores with them.
        with spans.span("hierarchy.lambda"):
            # 10% margin: an underestimated lambda_max would push
            # omega_s past the Jacobi stability bound.
            lam = 1.1 * _lambda_max_dinv_a(A, iters=16)
        with spans.span("hierarchy.aggregate"):
            strength = _strength_pattern(A, theta_l)
            agg, nc = _aggregate_capped(A, cap_l, theta_l,
                                        strength=strength)
            while cap_l > 2 and nl / nc < 0.7 * cap_l:
                cap_l //= 2
                agg, nc = _aggregate_capped(A, cap_l, theta_l,
                                            strength=strength)
            if nc >= nl or nc == 0:
                break
            if nc > 0.6 * nl:
                # Coarsening stalled: force progress with unfiltered
                # pairwise aggregation.
                agg, nc = _aggregate_capped(A, 2, theta=0.0)
                cap_l = 2
                if nc >= nl or nc == 0 or nc > 0.8 * nl:
                    break

        with spans.span("hierarchy.order"):
            # Re-Hilbert-order the coarse level by aggregate centroids
            # so every level keeps the locality the offsets rely on.
            csum = np.zeros((nc, 2))
            np.add.at(csum, agg, lvl_coords)
            ccnt = np.bincount(agg, minlength=nc).astype(float)
            coords_c = csum / np.maximum(ccnt, 1.0)[:, None]
            group_c = None
            if lvl_group is not None:
                group_c = np.zeros(nc, dtype=lvl_group.dtype)
                group_c[agg] = lvl_group
            hperm = bell.hilbert_order(coords_c, group=group_c)
            hinv = np.empty(nc, dtype=np.int64)
            hinv[hperm] = np.arange(nc)
            agg = hinv[agg]
            coords_c = coords_c[hperm]
            if group_c is not None:
                group_c = group_c[hperm]
        omega_s = min(alpha, 1.6) / lam
        # Smooth only the top levels (smoothing densifies the Galerkin
        # operators and destroys the block-offset structure).
        omega_p = 4.0 / (3.0 * lam) if level_i < smooth_levels else 0.0
        d = np.asarray(A.diagonal())
        dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)

        with spans.span("hierarchy.pack"):
            # Padded positions for this level's rows.
            order = np.argsort(agg, kind="stable")
            slot = np.empty(nl, dtype=np.int64)
            counts = np.bincount(agg, minlength=nc)
            starts = np.concatenate([[0], np.cumsum(counts)])
            slot[order] = np.arange(nl) - starts[agg[order]]
            pos = agg * cap_l + slot
            np_l = max(((cap_l * nc + 1023) // 1024) * 1024, 1024)
            # Only a prefix of levels shards: once a level is too small (or
            # not shardable), it and every deeper level run on one device.
            shard_l = (tp > 1 and cap_l * nc >= max(shard_min, tp * 1024)
                       and (not levels or levels[-1].shard))
            if shard_l:
                np_l = -(-np_l // (tp * 1024)) * (tp * 1024)

            diag_pad = np.zeros(np_l)
            diag_pad[pos] = np.asarray(A.diagonal(), dtype=np.float64)
            widen_deep = level_i > 0 and not shard_l
            mo_l = max_offsets if not widen_deep else (
                deep_max_offsets if deep_max_offsets is not None
                else max_offsets)
            cov_l = coverage if not widen_deep else (
                deep_coverage if deep_coverage is not None else coverage)
            pack = dia.pack_csr_pos_as_dia(
                A, pos, diag=diag_pad, coverage=cov_l,
                max_offsets=mo_l, np_override=np_l)
            if shard_l:
                from . import dia_sharded

                shard_l = dia_sharded.shardable(pack, tp)
            dinv_pad = np.zeros(np_l)
            dinv_pad[pos] = dinv
            all_pos.append(pos)

        with spans.span("hierarchy.galerkin"):
            # Galerkin coarse operator (aggregate-id order) with the smoothed
            # prolongation and the drop filter: relatively tiny couplings are
            # dropped and LUMPED into the diagonal so row sums (the Neumann
            # kernel) are preserved.
            if A.nnz >= 200_000:
                Ac = native.galerkin(A, agg, nc, dinv, omega_p, drop_tol)
            else:
                P0 = scipy.sparse.csr_matrix(
                    (np.ones(nl), (np.arange(nl), agg)), shape=(nl, nc)
                )
                if omega_p:
                    P = (P0
                         - omega_p * (scipy.sparse.diags(dinv) @ (A @ P0))
                         ).tocsr()
                else:
                    P = P0
                Ac = (P.T @ A @ P).tocsr()
                Ac.eliminate_zeros()
                if drop_tol:
                    dc = np.asarray(Ac.diagonal())
                    dc = np.where(dc > 0, dc, 1.0)
                    coo_c = Ac.tocoo()
                    keep = (coo_c.row == coo_c.col) | (
                        np.abs(coo_c.data)
                        >= drop_tol * np.sqrt(dc[coo_c.row] * dc[coo_c.col])
                    )
                    lump = np.zeros(Ac.shape[0])
                    np.add.at(lump, coo_c.row[~keep], coo_c.data[~keep])
                    Ac = scipy.sparse.csr_matrix(
                        (coo_c.data[keep], (coo_c.row[keep], coo_c.col[keep])),
                        shape=Ac.shape,
                    )
                    Ac = (Ac + scipy.sparse.diags(lump)).tocsr()
        levels.append(AlignedLevel(
            pack=pack, dinv=dinv_pad, omega_p=omega_p, omega_s=omega_s,
            cap=cap_l, child_len=0, child_perm=None,   # patched below
            shard=shard_l, lam=lam,
        ))
        A = Ac
        lvl_coords = coords_c
        lvl_group = group_c

    # Coarsest: dense pseudo-inverse-equivalent over the padded size,
    # computed on first access.
    nL = A.shape[0]
    npL = max(((nL + 127) // 128) * 128, 128)
    A_bottom = A

    def _compute_coarse_inv():
        with spans.span("hierarchy.coarse_inv"):
            ci = np.zeros((npL, npL), np.float32)  # padding rows stay 0
            if nL:
                Ad = np.asarray(A_bottom.todense())
                ci[:nL, :nL] = (_eigh_pinv(Ad) if coarse_eigh
                                else _coarse_inv_dense(A_bottom, Ad))
        return ci

    for i, lv in enumerate(levels):
        if i + 1 < len(levels):
            lv.child_len = levels[i + 1].pack.np_
            lv.child_perm = all_pos[i + 1].astype(np.int32)
        else:
            lv.child_len = npL
            lv.child_perm = np.arange(nL, dtype=np.int32)

    if levels:
        posmap0 = all_pos[0][inv0]
        np0 = levels[0].pack.np_
    else:
        posmap0 = inv0
        np0 = npL
    return AlignedHierarchy(levels=levels, posmap0=posmap0, np0=np0,
                            _coarse=_compute_coarse_inv, coarse_sp=A_bottom,
                            coarse_nL=nL, coarse_npL=npL,
                            setup_threads=threads)


# ---------------------------------------------------------------------------
# Device side


def make_dia_cg_operator(h: AlignedHierarchy, device) -> dict:
    """Exact level-0 operator params for the CG matvec: the f32
    sliced-ELL operator, with the lo-halves and f64 diagonal that the
    compensated residual (ops.comp) shares."""
    return h.levels[0].pack.to_device(device, compensated=True)


def _lumped_level0(pack: dia.DiaPack, lump_strength: float):
    """(pack, dinv) of the level-0 cycle operator: weak remainder entries
    (|a_ij| < lump_strength * sqrt(a_ii a_jj)) folded into the diagonal,
    row sums preserved.  Strong entries (via stitches between layers,
    cut copper edges) stay: lumping those decouples whole regions."""
    d = pack.diag
    rr, rc, rv = pack.rem_rows, pack.rem_cols, pack.rem_vals
    if len(rr):
        strength = np.abs(rv) / np.sqrt(np.maximum(d[rr] * d[rc], 1e-300))
        weak = strength < lump_strength
        if weak.any():
            d = d.copy()
            np.add.at(d, rr[weak], rv[weak])
            pack = dataclasses.replace(
                pack, rem_rows=rr[~weak], rem_cols=rc[~weak],
                rem_vals=rv[~weak], diag=d)
    return pack, np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)


def _coarse_inv_on_device(h: AlignedHierarchy, device):
    """The coarse inverse built on `device` (the JAX package's
    _device_coarse_inv): the bottom operator's COO scattered into a
    dense (npL, npL) f32 matrix A0 (scaled to unit |A|_max), the
    structural nullspace shifted out of the way, M = A0 + Z Z^T (Z the
    scaled indicators of the connected components; padding rows get a
    unit diagonal), and 30 Newton-Schulz steps X <- 2X - X (M X) from
    X0 = I / max row sum of |M|.

    Validation, as the JAX package's: |I - X M|max < 1e-2 and finite,
    and no near-null junk (the top mode of X by 20 power steps beyond
    1 / (1e-6 * lambda_max(A0)), lambda_max by 10 power steps).  The
    products must be true f32 (the JAX build's Precision.HIGHEST): with
    TF32 the check would judge another matrix, so it raises.

    Returns (the (npL, npL) f32 inverse, padding rows and columns 0, or
    None, and the reason the validation gave for None)."""
    import scipy.sparse.csgraph as csgraph

    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the coarse inverse's Newton-Schulz products "
                           "need true f32: TF32 matmuls are on "
                           "(device.resolve turns them off)")
    A_sp, nL, npL = h.coarse_sp, h.coarse_nL, h.coarse_npL
    coo = A_sp.tocoo()
    coo.sum_duplicates()    # unique (row, col): the scatter adds nothing
    d_scale = max(float(np.abs(coo.data).max()), 1e-300)
    ncomp, labels = csgraph.connected_components(A_sp, directed=False)
    rowsum = np.asarray(abs(A_sp).sum(axis=1)).ravel()
    lam_g = max(float(rowsum.max()) / d_scale, 1e-300)
    sizes = np.bincount(labels, minlength=ncomp).astype(np.float64)
    zcol = np.sqrt(lam_g / sizes[labels]).astype(np.float32)

    f32 = torch.float32

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    A0 = torch.zeros(npL, npL, dtype=f32, device=device)
    A0[dev(coo.row, np.int64), dev(coo.col, np.int64)] = dev(
        coo.data / d_scale, np.float32)
    Z = torch.zeros(npL, ncomp, dtype=f32, device=device)
    Z[torch.arange(nL, device=device), dev(labels, np.int64)] = dev(
        zcol, np.float32)
    real = (torch.arange(npL, device=device) < nL).to(f32)
    M = A0 + Z @ Z.T
    M.diagonal().add_(1.0 - real)
    lam_row = M.abs().sum(dim=1).max().clamp_min(1e-30)
    eye = torch.eye(npL, dtype=f32, device=device)
    X = eye / lam_row
    for _ in range(30):
        # The stable 2X - X (M X) form: X - X^2 M equals it only while
        # X and M commute, which f32 rounding breaks.
        X = 2.0 * X - X @ (M @ X)
    res = (eye - X @ M).abs().max()
    X = X * real[:, None] * real[None, :]

    def top(mat, v, steps):
        for _ in range(steps):
            v = mat @ v
            v = v / v.norm().clamp_min(1e-30)
        return v

    gen = torch.Generator().manual_seed(7)
    v = top(X, torch.randn(npL, generator=gen).to(device) * real, 20)
    w = top(A0, torch.randn(npL, generator=gen).to(device) * real, 10)
    mu_max = float(v @ (X @ v))
    lam_max = max(float(w @ (A0 @ w)), 1e-30)
    res = float(res)
    if not (np.isfinite(res) and res < 1e-2):
        return None, (f"Newton-Schulz did not converge (|I - XM|max "
                      f"{res:.2e})")
    if mu_max > 1.0 / (1e-6 * lam_max):
        return None, (f"near-null junk beyond the structural nullspace "
                      f"(1/mu={1.0 / mu_max:.2e} < 1e-6*lam="
                      f"{1e-6 * lam_max:.2e})")
    return X * (1.0 / d_scale), None


def _coarse_inv_device(h: AlignedHierarchy, device, coarse: str = "host"):
    """The cycle's coarse inverse on `device` and where it was built.

    coarse="host": the host inverse (AlignedHierarchy.coarse_inv),
    rounded through bf16 (the JAX package's wire format,
    preconditioner-grade) and held as f32.  coarse="device": built on
    the device (_coarse_inv_on_device); when its validation fails, the
    host inverse as for "host", as the JAX package's algorithm takes it,
    with the reason logged.  Returns (tensor, "host", "device" or
    "host (validation)")."""
    import logging

    if coarse not in ("host", "device"):
        raise ValueError(f"coarse={coarse!r}: 'host' or 'device'")
    route = "host"
    if coarse == "device":
        inv, why = _coarse_inv_on_device(h, device)
        if inv is not None:
            return inv, "device"
        logging.getLogger(__name__).info(
            "coarse inverse on the device: %s; using the host "
            "pseudo-inverse", why)
        route = "host (validation)"
    ci = torch.from_numpy(h.coarse_inv)
    return ci.to(torch.bfloat16).to(torch.float32).to(device), route


def _cheb_smooth(mv, dinv, lam, deg, b, x0=None, want_r=True):
    """4th-kind Chebyshev smoother of degree `deg` (the Lottes
    recurrence, as the JAX package's): its error propagator is a
    polynomial in D^-1 A with roots on (0, lam], A-self-adjoint, so the
    same smoother before and after keeps the cycle SPD.  Carries
    r = b - A x beside x (one product a degree); returns (x, the final
    residual when want_r, else None)."""
    r = b if x0 is None else b - mv(x0)
    d = (4.0 / (3.0 * lam)) * (dinv * r)
    x = d if x0 is None else x0 + d
    for k in range(2, deg + 1):
        r = r - mv(d)
        d = ((2.0 * k - 3.0) / (2.0 * k + 1.0)) * d \
            + ((8.0 * k - 4.0) / ((2.0 * k + 1.0) * lam)) * (dinv * r)
        x = x + d
    if want_r:
        return x, r - mv(d)
    return x, None


def _upload(pack: dia.DiaPack, dinv, device, dtype) -> dict:
    """A cycle operator on `device` in the sliced-ELL format with its
    offset entries in `dtype`, and its dinv in f32."""
    entry = pack.to_device(device, dtype=dtype)
    entry["dinv"] = torch.from_numpy(dinv.astype(np.float32)).to(device)
    return entry


def _level_entry(h: AlignedHierarchy, i: int, device, dtype,
                 lump_strength: float, cycle_lumped: bool = True,
                 lump_smoothing: bool = True) -> dict:
    """Level i's cycle operator on `device` (_upload) with its child
    permutation.

    Level 0 with lump_smoothing: the strength-lumped operator
    (_lumped_level0) smooths the transfers; with cycle_lumped it also
    smooths and takes the coarse-grid residual (one operator), else
    those keep the exact operator and the lumped one sits under "sm".
    Without lump_smoothing level 0 is exact throughout, as it is when
    lumping folds no entry."""
    lv = h.levels[i]
    pack, dinv, sm = lv.pack, lv.dinv, None
    if i == 0 and lump_smoothing:
        pack_sm, dinv_sm = _lumped_level0(lv.pack, lump_strength)
        if cycle_lumped or pack_sm is lv.pack:
            pack, dinv = pack_sm, dinv_sm
        else:
            sm = _upload(pack_sm, dinv_sm, device, dtype)
    entry = _upload(pack, dinv, device, dtype)
    if sm is not None:
        entry["sm"] = sm
    entry["child_perm"] = torch.from_numpy(
        lv.child_perm.astype(np.int64)).to(device)
    return entry


def _cycle_t(h: AlignedHierarchy, w_levels: int, cheb: int = 0,
             cheb_deep: int = 0, smooth_steps: int = 1):
    """cycle_t(level, p, bt): the cycle from `level` down on one device,
    bt and the result (R, np_level); p[i] is level i's entry
    (_level_entry) for every level visited, p[-1] the coarse inverse.

    Smoothing: damped Jacobi, smooth_steps steps before and after on
    level 0 and one on the others, or where cheb (level 0) or cheb_deep
    (the others, the W-cycle's second visits included) is >= 2 the
    4th-kind Chebyshev polynomial of that degree (_cheb_smooth) on both
    sides.  A level's entry may carry the operator of its transfer
    smoothing under "sm" (level 0's lumped one)."""
    metas = [lv.pack.meta for lv in h.levels]
    lams = [lv.lam if lv.lam else 1.6 / lv.omega_s for lv in h.levels]
    nlev = len(h.levels)

    def cycle_t(level: int, p, bt):
        if level == nlev:
            return bt @ p[-1]["coarse_inv"].T
        lv, e, meta = h.levels[level], p[level], metas[level]
        sm = e.get("sm", e)
        om_p, om_s, cap = lv.omega_p, lv.omega_s, lv.cap
        nc, clen = len(lv.child_perm), lv.child_len
        r_cols, np_l = bt.shape[0], meta[0]
        naggs = np_l // cap
        deg = cheb if level == 0 else cheb_deep
        steps = smooth_steps if level == 0 else 1

        def mv(xt):
            return dia.dia_matvec_t(meta, e, xt)

        def mv_sm(xt):
            return dia.dia_matvec_t(meta, sm, xt)

        dinv, dinv_sm = e["dinv"][None, :], sm["dinv"][None, :]
        if deg >= 2:
            x, r1 = _cheb_smooth(mv, dinv, lams[level], deg, bt)
        else:
            x = om_s * dinv * bt
            for _ in range(steps - 1):
                x = x + om_s * dinv * (bt - mv(x))
            r1 = bt - mv(x)
        # restrict: P^T r1 (om_p == 0 -> plain aggregation, no SpMV)
        t = r1 - om_p * mv_sm(dinv_sm * r1) if om_p else r1
        rc_t = t.reshape(r_cols, naggs, cap).sum(axis=2)   # (R, naggs)
        bc = torch.zeros(r_cols, clen, dtype=bt.dtype, device=bt.device)
        bc[:, e["child_perm"]] = rc_t[:, :nc]
        xc = cycle_t(level + 1, p, bc)                     # (R, clen)
        if 2 <= level + 1 <= w_levels and level + 1 < nlev:
            # W: one extra visit of the coarse level on its residual.
            r2 = bc - dia.dia_matvec_t(metas[level + 1], p[level + 1], xc)
            xc = xc + cycle_t(level + 1, p, r2)
        # prolong: child positions -> aggregate order -> broadcast
        xct = xc[:, e["child_perm"]]                       # (R, nc)
        if naggs > nc:
            xct = torch.nn.functional.pad(xct, (0, naggs - nc))
        px = xct[:, :, None].expand(r_cols, naggs, cap).reshape(
            r_cols, np_l)
        x = x + (px - om_p * dinv_sm * mv_sm(px) if om_p else px)
        if deg >= 2:
            return _cheb_smooth(mv, dinv, lams[level], deg, bt, x0=x,
                                want_r=False)[0]
        for _ in range(steps):
            x = x + om_s * dinv * (bt - mv(x))
        return x

    return cycle_t


def make_vcycle_dia_t(h: AlignedHierarchy, device, dtype=torch.float32,
                      w_levels: int = 3, lump_strength: float = 0.05,
                      cycle_lumped: bool = True, lump_smoothing: bool = True,
                      smooth_steps: int = 1, cheb: int = 0,
                      cheb_deep: int = 0, coarse: str = "host"):
    """(apply_t, params): z = apply_t(params, rt) on (R, np0), a
    symmetric V(1,1) cycle with damped-Jacobi smoothing and smoothed
    aggregation transfers, so a valid SPD preconditioner for CG.

    By default level 0 runs on the strength-lumped operator
    (_lumped_level0) for every application — the exact AMG
    preconditioner of the lumped
    operator, consistent smoother/operator pair, no full-remainder pass.
    Every level's operator is uploaded in the sliced-ELL format with its
    offset entries in `dtype` (ops.dia.DiaPack.to_device).

    w_levels: coarse levels 2..w_levels are visited twice (a W-shape on
    the top of the coarse hierarchy; the second visit is a stationary
    re-application B -> 2B - BAB, so the cycle stays SPD).  Values < 2
    give the plain V-cycle.

    The JAX package's alternatives (its PADNE_TPU_* knobs), each keeping
    the cycle symmetric: cycle_lumped=False smooths and takes level 0's
    coarse-grid residual on the exact operator (in `dtype`), the lumped
    one only smoothing the transfers (PADNE_TPU_CYCLE_LUMPED=0);
    lump_smoothing=False keeps level 0 exact throughout; smooth_steps=s
    gives V(s,s) on level 0 (PADNE_TPU_SMOOTH_STEPS); cheb=K >= 2
    smooths level 0 with a degree-K Chebyshev polynomial
    (PADNE_TPU_CHEB), cheb_deep=K the levels below it (PADNE_TPU_CHEB_DEEP;
    0 or 1: damped Jacobi); coarse="device" builds the coarse inverse on
    the device (_coarse_inv_device).  params[-1]["coarse"] says where it
    was built."""
    if smooth_steps < 1 or cheb < 0 or cheb_deep < 0:
        raise ValueError(f"smooth_steps={smooth_steps} must be >= 1, "
                         f"cheb={cheb} and cheb_deep={cheb_deep} >= 0")
    params = [_level_entry(h, i, device, dtype, lump_strength,
                           cycle_lumped, lump_smoothing)
              for i in range(len(h.levels))]
    inv, route = _coarse_inv_device(h, device, coarse)
    params.append({"coarse_inv": inv, "coarse": route})
    cycle_t = _cycle_t(h, w_levels, cheb, cheb_deep, smooth_steps)

    def apply_t(p, bt):
        return cycle_t(0, p, bt)

    return apply_t, params


def make_vcycle_dia_sharded(h: AlignedHierarchy, mesh, dtype=torch.float32,
                            w_levels: int = 3, coarse: str = "host",
                            op0=None):
    """The cycle of make_vcycle_dia_t with the sharded prefix of levels
    (AlignedLevel.shard) row-sharded over `mesh` (a
    parallel.sharding.Mesh; ops.dia_sharded: halo exchange, compressed
    far exchange, one K1' launch per shard and product).  The same
    levels and W-shape as make_vcycle_dia_t, but level 0 is the exact
    operator, as in the JAX package's sharded cycle
    (padne_tpu/ops/schur.py:748, "no lumping in the sharded cycle"): no
    strength lumping, its exact dinv, its values in f32, so it is the
    CG operator itself.  op0: that operator, already uploaded
    (dia_sharded.upload_sharded of level 0's pack; the solver's CG
    operator, compensated for K2'), shared instead of uploaded again;
    None uploads it here.  The deeper sharded levels hold their offset
    entries in `dtype`.

    Returns (apply, params, n_sharded): zs = apply(params, rts) on lists
    of per-shard (R, np0 / tp) blocks; params[i] for a sharded level
    holds its ops.dia_sharded.ShardedOperator ("op") and per-shard dinv
    and transfer indices, for a deeper level the one-device entry of
    make_vcycle_dia_t on the mesh's first device; n_sharded is how many
    levels (from the top) are sharded; coarse and params[-1]["coarse"]
    as in make_vcycle_dia_t.  (The cycle's other variants of
    make_vcycle_dia_t are single-device only, as in the JAX package.)

    Level transfers: within the sharded prefix, restriction all-gathers
    the (R, np_l / cap) aggregate residual and each child shard takes
    its rows; prolongation all-gathers the child correction and each
    shard takes its aggregates' values.  The deeper levels run as one
    replicated tail in the JAX package (the same values on every
    shard); here they run once, on the mesh's first device, through the
    one-device cycle, and the coarse correction is copied to every
    shard."""
    from ..parallel import sharding
    from . import dia_sharded

    tp = mesh.size
    n_sh = 0
    while n_sh < len(h.levels) and h.levels[n_sh].shard:
        n_sh += 1
    if n_sh == 0:
        raise ValueError("hierarchy has no shardable levels "
                         "(build_hierarchy_dia with tp= and a reachable "
                         "shard_min)")
    dev0 = mesh.devices[0]
    params = []
    for i, lv in enumerate(h.levels):
        if i >= n_sh:
            # Below level 0 nothing is lumped: lump_strength is unused.
            params.append(_level_entry(h, i, dev0, dtype, 0.0))
            continue
        pack = lv.pack
        nl = pack.np_ // tp
        al = nl // lv.cap                   # aggregates of one shard
        perm = lv.child_perm.astype(np.int64)
        dinv32 = torch.from_numpy(lv.dinv.astype(np.float32))
        if i == 0 and op0 is not None:
            op = op0
        else:
            op = dia_sharded.upload_sharded(
                pack, dia_sharded.plan_shards(pack, tp), mesh,
                dtype=torch.float32 if i == 0 else dtype)
        entry = {
            "op": op,
            "dinv": [dinv32[s * nl:(s + 1) * nl].to(dev)
                     for s, dev in enumerate(mesh.devices)],
            # Prolongation: the child positions of each shard's
            # aggregates (the last shards' may run past nc: zeros).
            "prolong": [torch.from_numpy(perm[s * al:(s + 1) * al]).to(dev)
                        for s, dev in enumerate(mesh.devices)],
        }
        if i + 1 < n_sh:
            # Restriction into a sharded child: for each child shard,
            # which aggregates land on its rows, and where.
            cl = lv.child_len // tp
            entry["restrict"] = []
            for s, dev in enumerate(mesh.devices):
                agg = np.nonzero((perm >= s * cl) & (perm < (s + 1) * cl))[0]
                entry["restrict"].append(
                    (torch.from_numpy(agg).to(dev),
                     torch.from_numpy(perm[agg] - s * cl).to(dev)))
        else:
            entry["child_perm"] = torch.from_numpy(perm).to(dev0)
        params.append(entry)
    inv, route = _coarse_inv_device(h, dev0, coarse)
    params.append({"coarse_inv": inv, "coarse": route})
    tail = _cycle_t(h, w_levels)
    nlev = len(h.levels)

    def w_visit(level: int) -> bool:
        return 2 <= level <= w_levels and level < nlev

    def cyc(level: int, p, bts):
        lv, e = h.levels[level], p[level]
        om_p, om_s, cap = lv.omega_p, lv.omega_s, lv.cap
        r_cols, nl = bts[0].shape
        al = nl // cap

        def mv(xts):
            return dia_sharded.dia_matvec_t_sharded(e["op"], xts)

        dinv = [d[None, :] for d in e["dinv"]]
        x = [om_s * d * bt for d, bt in zip(dinv, bts)]
        r1 = [bt - y for bt, y in zip(bts, mv(x))]
        if om_p:
            r1 = [a - om_p * y for a, y in
                  zip(r1, mv([d * a for d, a in zip(dinv, r1)]))]
        rc = [t.reshape(r_cols, al, cap).sum(axis=2) for t in r1]
        if level + 1 < n_sh:
            cl = lv.child_len // tp
            bcs = []
            for full, (agg, pos) in zip(
                    sharding.all_gather(mesh, rc, dim=1), e["restrict"]):
                bc = full.new_zeros(r_cols, cl)
                bc[:, pos] = full[:, agg]
                bcs.append(bc)
            xcs = cyc(level + 1, p, bcs)
            if w_visit(level + 1):
                r2 = [bc - y for bc, y in zip(bcs, dia_sharded.
                      dia_matvec_t_sharded(p[level + 1]["op"], xcs))]
                xcs = [a + b for a, b in zip(xcs, cyc(level + 1, p, r2))]
            xcf = sharding.all_gather(mesh, xcs, dim=1)
        else:
            full = sharding.gather_to(rc, dev0, dim=1)
            bc = full.new_zeros(r_cols, lv.child_len)
            bc[:, e["child_perm"]] = full[:, :len(lv.child_perm)]
            xc = tail(level + 1, p, bc)
            if w_visit(level + 1):
                r2 = bc - dia.dia_matvec_t(h.levels[level + 1].pack.meta,
                                           p[level + 1], xc)
                xc = xc + tail(level + 1, p, r2)
            xcf = sharding.broadcast(mesh, xc)
        px = []
        for xf, idx in zip(xcf, e["prolong"]):
            xct = xf[:, idx]
            if xct.shape[1] < al:
                xct = torch.nn.functional.pad(xct, (0, al - xct.shape[1]))
            px.append(xct[:, :, None].expand(r_cols, al, cap).reshape(
                r_cols, nl))
        if om_p:
            x = [xi + pi - om_p * d * y for xi, pi, d, y in
                 zip(x, px, dinv, mv(px))]
        else:
            x = [xi + pi for xi, pi in zip(x, px)]
        return [xi + om_s * d * (bt - y) for xi, d, bt, y in
                zip(x, dinv, bts, mv(x))]

    def apply(p, rts):
        return cyc(0, p, rts)

    return apply, params, n_sh


# ---------------------------------------------------------------------------
# Smoothed aggregation on ELL levels (the generic route): host setup carried
# from padne_tpu.ops.amg as numpy, device cycle over kernel K3' (ops.spmv).


@dataclass
class Level:
    """One AMG level (host arrays; make_vcycle uploads them)."""

    # Fine operator in ELL form.
    a_cols: np.ndarray
    a_vals: np.ndarray
    a_diag: np.ndarray
    # Prolongation P (n_fine x n_coarse) in ELL rows; restriction is P^T
    # stored as ELL over coarse rows (padded member lists).
    p_cols: Optional[np.ndarray]  # (n, KP)
    p_vals: Optional[np.ndarray]
    r_cols: Optional[np.ndarray]  # (nc, KR) fine indices per coarse row
    r_vals: Optional[np.ndarray]
    omega: float  # damped-Jacobi smoothing weight


@dataclass
class AMGHierarchy:
    levels: list[Level]
    coarse_inv: np.ndarray  # dense inverse of the coarsest operator

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _to_csr(ell: assembly.EllMatrix):
    return ell.to_scipy().tocsr()


def _aggregate(A, theta: float = 0.08) -> tuple[np.ndarray, int]:
    """Greedy aggregation over the strength graph (native sweep).

    Returns (agg_id per node, num_aggregates).  Strong connection:
    |a_ij| >= theta * sqrt(a_ii * a_jj)."""
    import ctypes

    import scipy.sparse

    from .. import native

    n = A.shape[0]
    d = np.asarray(A.diagonal())
    d = np.where(d > 0, d, 1.0)
    coo = A.tocoo()
    strong = (coo.row != coo.col) & (
        np.abs(coo.data) >= theta * np.sqrt(d[coo.row] * d[coo.col])
    )
    S = scipy.sparse.csr_matrix(
        (np.ones(strong.sum(), dtype=np.int8),
         (coo.row[strong], coo.col[strong])),
        shape=(n, n),
    )
    indptr = np.ascontiguousarray(S.indptr.astype(np.int32))
    indices = np.ascontiguousarray(S.indices.astype(np.int32))
    agg32 = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    num_agg = native.lib.pg_greedy_aggregate(
        indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p), n,
        agg32.ctypes.data_as(i32p),
    )
    return agg32.astype(np.int64), int(num_agg)


def _pack_ell(rows, cols_in, vals_in, n, pad_self_col: bool):
    """Vectorized COO (sorted by rows) -> padded ELL."""
    counts = np.bincount(rows, minlength=n)
    K = max(int(counts.max(initial=1)), 1)
    order = np.argsort(rows, kind="stable")
    rows, cols_in, vals_in = rows[order], cols_in[order], vals_in[order]
    slot = np.arange(len(rows)) - np.concatenate([[0], np.cumsum(counts)])[rows]
    if pad_self_col:
        cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    else:
        cols = np.zeros((n, K), dtype=np.int64)
    vals = np.zeros((n, K), dtype=np.float64)
    cols[rows, slot] = cols_in
    vals[rows, slot] = vals_in
    return cols.astype(np.int32), vals


def _ell_from_csr(A):
    """CSR -> (cols, vals, diag) padded ELL (off-diagonal entries)."""
    coo = A.tocoo()
    diag = np.asarray(A.diagonal(), dtype=np.float64)
    mask = coo.row != coo.col
    cols, vals = _pack_ell(
        coo.row[mask].astype(np.int64), coo.col[mask].astype(np.int64),
        coo.data[mask], A.shape[0], pad_self_col=True,
    )
    return cols, vals, diag


def _ell_matrix(P):
    """CSR rectangular matrix -> padded ELL (padding entries point at
    column 0 with zero value)."""
    coo = P.tocoo()
    return _pack_ell(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data,
        P.shape[0], pad_self_col=False,
    )


@checked
def build_hierarchy(
    ell: assembly.EllMatrix,
    theta: float = 0.08,
    coarse_size: int = 400,
    max_levels: int = 12,
    omega: Optional[float] = None,
    alpha: float = 1.66,
) -> AMGHierarchy:
    """Host-side setup: aggregation + smoothed prolongation + Galerkin
    coarse operators, down to a dense-invertible coarsest level.

    omega: fixed damped-Jacobi weight for both the prolongation smoother
    and the cycle smoother; None (default) estimates lambda_max(D^-1 A)
    per level by power iteration and uses 4/(3*lambda) for prolongation
    smoothing and alpha/lambda (capped at 1.8/lambda, inside the
    2/lambda stability bound) for the cycle smoother."""
    import scipy.sparse

    levels: list[Level] = []
    A = _to_csr(ell)
    a_cols, a_vals, a_diag = ell.cols, ell.vals, ell.diag

    def level_omegas(A):
        if omega is not None:
            return omega, omega
        lam = _lambda_max_dinv_a(A)
        return 4.0 / (3.0 * lam), min(alpha, 1.8) / lam

    for _ in range(max_levels):
        n = A.shape[0]
        if n <= coarse_size:
            break
        agg, nc = _aggregate(A, theta)
        if nc >= n or nc == 0:
            break
        p_omega, sm_omega = level_omegas(A)
        P0 = scipy.sparse.csr_matrix(
            (np.ones(n), (np.arange(n), agg)), shape=(n, nc)
        )
        # Smoothed prolongation: P = (I - p_omega D^-1 A) P0.
        d = np.asarray(A.diagonal())
        dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
        Dinv = scipy.sparse.diags(dinv)
        P = (P0 - p_omega * (Dinv @ (A @ P0))).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.eliminate_zeros()

        p_cols, p_vals = _ell_matrix(P)
        r_cols, r_vals = _ell_matrix(P.T.tocsr())
        levels.append(Level(a_cols=a_cols, a_vals=a_vals, a_diag=a_diag,
                            p_cols=p_cols, p_vals=p_vals, r_cols=r_cols,
                            r_vals=r_vals, omega=sm_omega))
        A = Ac
        a_cols, a_vals, a_diag = _ell_from_csr(A)

    # Coarsest level: dense pseudo-inverse (handles the Neumann nullspace).
    Ad = np.asarray(A.todense())
    coarse_inv = np.linalg.pinv(Ad, rcond=1e-12)
    levels.append(Level(a_cols=a_cols, a_vals=a_vals, a_diag=a_diag,
                        p_cols=None, p_vals=None, r_cols=None, r_vals=None,
                        omega=level_omegas(A)[1]))
    return AMGHierarchy(levels=levels, coarse_inv=coarse_inv)


def make_vcycle(h: AMGHierarchy, device, a0=None, mesh=None):
    """(apply, params): z = apply(params, r) on (N, R) tensors, a
    symmetric V(1,1) cycle (damped-Jacobi pre/post smoothing from a zero
    guess), so an SPD preconditioner for CG.  On one device, or with a
    mesh of more than one device row-sharded over it (_make_vcycle_sharded:
    apply then takes and returns lists of per-shard row blocks).

    The cycle is laid out in float64; `vcycle_as` gives the same cycle
    in another precision over the same index arrays.  Every level
    operator, restriction and prolongation is an ops.spmv.EllOperator
    uploaded once here (which checks the transfers' columns against the
    levels they read); each line of the cycle is one fused product
    (kernel K3' on the card), the dense coarsest solve one matmul.  a0:
    level 0's float64 operator already on the device (the CG operator's),
    shared instead of uploaded again."""
    from . import spmv

    if mesh is not None and mesh.size > 1:
        return _make_vcycle_sharded(h, mesh)
    f64 = torch.float64
    sizes = [len(lv.a_diag) for lv in h.levels] + [h.coarse_inv.shape[0]]
    params = []
    for i, lv in enumerate(h.levels[:-1]):
        a = a0 if i == 0 and a0 is not None else spmv.build_operator(
            lv.a_cols, lv.a_vals, lv.a_diag, sizes[i], device, f64)
        d = a.diag
        params.append({
            "a": a,
            # The damped-Jacobi weight omega D^-1, one vector per level.
            "w": lv.omega * torch.where(
                d > 0, 1.0 / torch.where(d > 0, d, 1.0), 0.0),
            "p": spmv.build_operator(lv.p_cols, lv.p_vals, None,
                                     sizes[i + 1], device, f64),
            "r": spmv.build_operator(lv.r_cols, lv.r_vals, None, sizes[i],
                                     device, f64),
        })
    params.append({"coarse_inv": torch.from_numpy(h.coarse_inv).to(
        device=device, dtype=f64)})

    def cycle(level: int, p, b):
        if level == len(p) - 1:
            return p[-1]["coarse_inv"] @ b
        a, w = p[level]["a"], p[level]["w"]
        # Pre-smooth from a zero guess needs no SpMV: x = omega D^-1 b.
        x = w[:, None] * b
        rc = spmv.ell_spmv(p[level]["r"], spmv.ell_spmv(a, x, b=b))
        x = spmv.ell_spmv(p[level]["p"], cycle(level + 1, p, rc), x0=x)
        return spmv.ell_spmv(a, x, b=b, w=w, x0=x)

    def apply(p, r):
        return cycle(0, p, r)

    return apply, params


def shard_rows(cols, vals, diag, n_pad: int, tp: int) -> list:
    """Host ELL rows (n, K) and the diagonal (n,) or None, padded with
    empty rows to n_pad and cut into tp row blocks: [(cols, vals)] of
    each shard, the diagonal as one more entry of each row at the row's
    own column."""
    n = cols.shape[0]
    if diag is not None:
        cols = np.concatenate([cols, np.arange(n)[:, None]], axis=1)
        vals = np.concatenate([vals, np.asarray(diag)[:, None]], axis=1)
    cols = np.pad(cols, ((0, n_pad - n), (0, 0)))
    vals = np.pad(vals, ((0, n_pad - n), (0, 0)))
    nl = n_pad // tp
    return [(cols[s * nl:(s + 1) * nl], vals[s * nl:(s + 1) * nl])
            for s in range(tp)]


def shard_ell_rows(cols, vals, diag, nx: int, n_pad: int, mesh, dtype):
    """`shard_rows` as one rectangular ops.spmv.EllOperator (n_pad / tp,
    nx) per shard on its device, over the all-gathered x."""
    from . import spmv

    return [spmv.build_operator(c, v, None, nx, dev, dtype)
            for (c, v), dev in zip(shard_rows(cols, vals, diag, n_pad,
                                              mesh.size), mesh.devices)]


def _make_vcycle_sharded(h: AMGHierarchy, mesh):
    """make_vcycle row-sharded over `mesh`, as the JAX package's
    make_vcycle(tp=): every level's rows are padded to a multiple of tp
    (padding rows inert: no entries, zero smoothing weight), and each
    level's A, P and R are row-sharded K3' operators over the
    all-gathered level vector, the smoothing and residual lines fused
    into their products as on one device.  The dense coarsest solve runs
    once, on the mesh's first device, and each shard takes its rows.
    Laid out in float64 (vcycle_as casts)."""
    from ..parallel import sharding
    from . import spmv

    f64, tp, dev0 = torch.float64, mesh.size, mesh.devices[0]
    sizes = [len(lv.a_diag) for lv in h.levels] + [h.coarse_inv.shape[0]]
    pads = [-(-n // tp) * tp for n in sizes]
    params = []
    for i, lv in enumerate(h.levels[:-1]):
        d = np.asarray(lv.a_diag, np.float64)
        w = np.zeros(pads[i])
        w[:sizes[i]] = lv.omega * np.where(
            d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
        params.append({
            "a": shard_ell_rows(lv.a_cols, lv.a_vals, d, pads[i], pads[i],
                                mesh, f64),
            "w": sharding.split(mesh, torch.from_numpy(w), dim=0),
            "p": shard_ell_rows(lv.p_cols, lv.p_vals, None, pads[i + 1],
                                pads[i], mesh, f64),
            "r": shard_ell_rows(lv.r_cols, lv.r_vals, None, pads[i],
                                pads[i + 1], mesh, f64),
        })
    params.append({"coarse_inv": torch.from_numpy(h.coarse_inv).to(
        device=dev0, dtype=f64)})

    def gathered(xs):
        return sharding.all_gather(mesh, xs, dim=0)

    def cycle(level: int, p, bs):
        if level == len(p) - 1:
            nc = sizes[level]
            xc = p[-1]["coarse_inv"] @ sharding.gather_to(bs, dev0, 0)[:nc]
            xc = torch.nn.functional.pad(xc, (0, 0, 0, pads[level] - nc))
            return sharding.split(mesh, xc, dim=0)
        a, w = p[level]["a"], p[level]["w"]
        x = [wi[:, None] * b for wi, b in zip(w, bs)]
        r = [spmv.ell_spmv(ai, xf, b=b) for ai, xf, b in
             zip(a, gathered(x), bs)]
        rc = [spmv.ell_spmv(ri, rf) for ri, rf in
              zip(p[level]["r"], gathered(r))]
        xc = gathered(cycle(level + 1, p, rc))
        x = [spmv.ell_spmv(pi, xcf, x0=xi) for pi, xcf, xi in
             zip(p[level]["p"], xc, x)]
        return [spmv.ell_spmv(ai, xf, b=b, w=wi, x0=xi) for ai, xf, b, wi, xi
                in zip(a, gathered(x), bs, w, x)]

    def apply(p, rs):
        return cycle(0, p, rs)

    return apply, params


def vcycle_as(vcycle, dtype):
    """make_vcycle's (apply, params) with every value cast to `dtype`;
    the operators' index arrays are shared, not copied."""
    apply, params = vcycle

    def cast(v):
        return [t.to(dtype) for t in v] if isinstance(v, list) else v.to(dtype)

    return apply, [{key: cast(v) for key, v in entry.items()}
                   for entry in params]
