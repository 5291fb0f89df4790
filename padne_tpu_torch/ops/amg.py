"""Smoothed-aggregation AMG: host setup + device cycle, on DIA and ELL levels.

Port of padne_tpu.ops.amg.  DIA half: the host build (Hilbert
order, capped aggregation, smoothed prolongation, Galerkin operators,
aligned padded row layouts, dense coarse inverse) is carried as numpy
and calls the port's own copy of the native core (..native).  The device
cycle is plain torch around ops.dia matvecs (kernel K1' on every level,
however small) in the transposed (R, n) layout; every transfer between
levels is a reshape plus a child-permutation scatter/gather.

ELL half (the generic route): `build_hierarchy` (greedy aggregation,
smoothed prolongation, Galerkin coarse operators, dense pinv bottom) is
carried as numpy; `make_vcycle` runs every level product through kernel
K3' (ops.spmv).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.validation import checked
from . import assembly, bell, dia


def _lambda_max_dinv_a(A, iters: int = 12, seed: int = 3) -> float:
    """Power-iteration estimate of lambda_max(D^-1 A) (host, a dozen CSR
    SpMVs).  Falls back to the Gershgorin-style bound 2.0 on degenerate
    input."""
    n = A.shape[0]
    if n == 0:
        return 2.0
    d = np.asarray(A.diagonal())
    dinv = 1.0 / np.where(d > 0, d, 1.0)
    x = np.random.default_rng(seed).standard_normal(n)
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        if not np.isfinite(ny) or ny == 0:
            return 2.0
        x = y / ny
    lam = float(x @ (dinv * (A @ x)))
    if not np.isfinite(lam) or lam <= 0:
        return 2.0
    return lam


def _strength_pattern(A, theta: float):
    """(indptr, indices) int32 CSR pattern of the strong-connection graph
    |a_ij| >= theta * sqrt(d_i d_j), diagonal excluded (one native pass)."""
    import ctypes

    from .. import native

    A = A.tocsr()
    n = A.shape[0]
    d = np.asarray(A.diagonal())
    d = np.ascontiguousarray(np.where(d > 0, d, 1.0))
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    out_indptr = np.empty(n + 1, dtype=np.int32)
    out_indices = np.empty(len(indices), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    nnz = native.lib.pg_strength_csr(
        n, indptr.ctypes.data_as(i32p), indices.ctypes.data_as(i32p),
        data.ctypes.data_as(f64p), d.ctypes.data_as(f64p), float(theta),
        out_indptr.ctypes.data_as(i32p), out_indices.ctypes.data_as(i32p),
    )
    return out_indptr, out_indices[:nnz]


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
    lam: float = 0.0        # 1.1-margin estimate of lambda_max(D^-1 A)


@dataclass
class AlignedHierarchy:
    levels: list[AlignedLevel]
    posmap0: np.ndarray         # (n,) original index -> level-0 position
    np0: int                    # level-0 padded length
    # (npL, npL) f32 dense pseudo-inverse of the padded coarsest
    # operator, or a zero-arg callable computing it on first access.
    _coarse: object = None

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
    group: "np.ndarray | None" = None,
    a_csr=None,
    deep_max_offsets: "int | None" = 24,
    deep_coverage: "float | None" = 0.995,
) -> AlignedHierarchy:
    """Gather-free AMG setup (host).

    Hilbert-order the fine operator, then per level: capped aggregation
    -> smoothed prolongation + Galerkin coarse operator.  Each level's
    rows sit at (aggregate) * cap + slot, padded with inert dummy rows
    (zero matrix rows/columns, zero dinv), so every transfer on the
    device is a reshape.  Levels >= 1 may widen the offset budget
    (deep_max_offsets / deep_coverage); level 0 keeps max_offsets.

    a_csr: caller-provided CSR of the same operator (skips a second
    ELL->CSR conversion)."""
    import scipy.sparse

    A = ell.to_scipy() if a_csr is None else a_csr
    n0 = A.shape[0]
    # Group-aware sweep: stacked layers share one (x, y) footprint, and
    # a layer-blind sweep interleaves them off the slab offsets.
    perm0 = bell.hilbert_order(coords, group=group)
    inv0 = np.empty(n0, dtype=np.int64)
    inv0[perm0] = np.arange(n0)
    if A.nnz >= 200_000:
        from .. import native

        A = native.csr_permute(A, perm0)
    else:
        A = A[perm0][:, perm0].tocsr()
    lvl_group = (np.asarray(group)[perm0] if group is not None else None)
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
        strength = _strength_pattern(A, theta_l)
        agg, nc = _aggregate_capped(A, cap_l, theta_l, strength=strength)
        while cap_l > 2 and nl / nc < 0.7 * cap_l:
            cap_l //= 2
            agg, nc = _aggregate_capped(A, cap_l, theta_l,
                                        strength=strength)
        if nc >= nl or nc == 0:
            break
        if nc > 0.6 * nl:
            # Coarsening stalled: force progress with unfiltered pairwise
            # aggregation.
            agg, nc = _aggregate_capped(A, 2, theta=0.0)
            cap_l = 2
            if nc >= nl or nc == 0 or nc > 0.8 * nl:
                break

        # Re-Hilbert-order the coarse level by aggregate centroids so
        # every level keeps the locality the offsets rely on.
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
        # 10% margin: an underestimated lambda_max would push omega_s
        # past the Jacobi stability bound.
        lam = 1.1 * _lambda_max_dinv_a(A, iters=16)
        omega_s = min(alpha, 1.6) / lam
        # Smooth only the top levels (smoothing densifies the Galerkin
        # operators and destroys the block-offset structure).
        omega_p = 4.0 / (3.0 * lam) if level_i < smooth_levels else 0.0
        d = np.asarray(A.diagonal())
        dinv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)

        # Padded positions for this level's rows.
        order = np.argsort(agg, kind="stable")
        slot = np.empty(nl, dtype=np.int64)
        counts = np.bincount(agg, minlength=nc)
        starts = np.concatenate([[0], np.cumsum(counts)])
        slot[order] = np.arange(nl) - starts[agg[order]]
        pos = agg * cap_l + slot
        np_l = max(((cap_l * nc + 1023) // 1024) * 1024, 1024)

        diag_pad = np.zeros(np_l)
        diag_pad[pos] = np.asarray(A.diagonal(), dtype=np.float64)
        widen_deep = level_i > 0
        mo_l = max_offsets if not widen_deep else (
            deep_max_offsets if deep_max_offsets is not None
            else max_offsets)
        cov_l = coverage if not widen_deep else (
            deep_coverage if deep_coverage is not None else coverage)
        pack = dia.pack_csr_pos_as_dia(
            A, pos, diag=diag_pad, coverage=cov_l,
            max_offsets=mo_l, np_override=np_l,
        )
        dinv_pad = np.zeros(np_l)
        dinv_pad[pos] = dinv
        all_pos.append(pos)

        # Galerkin coarse operator (aggregate-id order) with the smoothed
        # prolongation and the drop filter: relatively tiny couplings are
        # dropped and LUMPED into the diagonal so row sums (the Neumann
        # kernel) are preserved.
        if A.nnz >= 200_000:
            from .. import native

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
            lam=lam,
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
        ci = np.zeros((npL, npL), np.float32)  # padding rows stay zero
        if nL:
            ci[:nL, :nL] = _coarse_inv_dense(
                A_bottom, np.asarray(A_bottom.todense()))
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
                            _coarse=_compute_coarse_inv)


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


def _coarse_inv_device(h: AlignedHierarchy, device) -> torch.Tensor:
    """The host coarse inverse, rounded through bf16 (the JAX package's
    wire format, preconditioner-grade) and held as f32 on the device."""
    ci = torch.from_numpy(h.coarse_inv)
    return ci.to(torch.bfloat16).to(torch.float32).to(device)


def make_vcycle_dia_t(h: AlignedHierarchy, device, dtype=torch.float32,
                      w_levels: int = 3, lump_strength: float = 0.05):
    """(apply_t, params): z = apply_t(params, rt) on (R, np0), a
    symmetric V(1,1) cycle with damped-Jacobi smoothing and smoothed
    aggregation transfers, so a valid SPD preconditioner for CG.

    Level 0 runs on the strength-lumped operator (_lumped_level0) for
    every application — the exact AMG preconditioner of the lumped
    operator, consistent smoother/operator pair, no full-remainder pass.
    Every level's operator is uploaded in the sliced-ELL format with its
    offset entries in `dtype` (ops.dia.DiaPack.to_device).

    w_levels: coarse levels 2..w_levels are visited twice (a W-shape on
    the top of the coarse hierarchy; the second visit is a stationary
    re-application B -> 2B - BAB, so the cycle stays SPD).  Values < 2
    give the plain V-cycle."""
    params = []
    for i, lv in enumerate(h.levels):
        if i == 0:
            pack, dinv = _lumped_level0(lv.pack, lump_strength)
        else:
            pack, dinv = lv.pack, lv.dinv
        entry = pack.to_device(device, dtype=dtype)
        entry["dinv"] = torch.from_numpy(dinv.astype(np.float32)).to(device)
        entry["child_perm"] = torch.from_numpy(
            lv.child_perm.astype(np.int64)).to(device)
        params.append(entry)
    params.append({"coarse_inv": _coarse_inv_device(h, device)})

    metas = [lv.pack.meta for lv in h.levels]
    nlev = len(h.levels)

    def cycle_t(level: int, p, bt):
        """bt, return: (R, np_level)."""
        if level == nlev:
            return bt @ p[-1]["coarse_inv"].T
        lv, e, meta = h.levels[level], p[level], metas[level]
        om_p, om_s, cap = lv.omega_p, lv.omega_s, lv.cap
        nc, clen = len(lv.child_perm), lv.child_len
        r_cols, np_l = bt.shape[0], meta[0]
        naggs = np_l // cap

        def mv(xt):
            return dia.dia_matvec_t(meta, e, xt)

        dinv = e["dinv"][None, :]
        x = om_s * dinv * bt
        r1 = bt - mv(x)
        # restrict: P^T r1 (om_p == 0 -> plain aggregation, no SpMV)
        t = r1 - om_p * mv(dinv * r1) if om_p else r1
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
        x = x + (px - om_p * dinv * mv(px) if om_p else px)
        return x + om_s * dinv * (bt - mv(x))

    def apply_t(p, bt):
        return cycle_t(0, p, bt)

    return apply_t, params


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


def make_vcycle(h: AMGHierarchy, device, a0=None):
    """(apply, params): z = apply(params, r) on (N, R) tensors, a
    symmetric V(1,1) cycle (damped-Jacobi pre/post smoothing from a zero
    guess), so an SPD preconditioner for CG.  Single device.

    The cycle is laid out in float64; `vcycle_as` gives the same cycle
    in another precision over the same index arrays.  Every level
    operator, restriction and prolongation is an ops.spmv.EllOperator
    uploaded once here (which checks the transfers' columns against the
    levels they read); each line of the cycle is one fused product
    (kernel K3' on the card), the dense coarsest solve one matmul.  a0:
    level 0's float64 operator already on the device (the CG operator's),
    shared instead of uploaded again."""
    from . import spmv

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


def vcycle_as(vcycle, dtype):
    """make_vcycle's (apply, params) with every value cast to `dtype`;
    the operators' index arrays are shared, not copied."""
    apply, params = vcycle
    return apply, [{key: v.to(dtype) for key, v in entry.items()}
                   for entry in params]
