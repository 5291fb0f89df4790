"""Bordered saddle-point solve: FEM core + MNA border via Schur complement.

Port of padne_tpu.ops.schur.  With A the assembled SPSD Laplacian, C the
border injection columns, B the border constraint rows, the full system

    -A v + C j = r_core
     B v       = r_border

is reduced by the pseudo-inverse: v = A^+ (C j - r_core) + Z c, with Z
the per-component constants.  The expensive part, A^+ applied to m+1
vectors, is one deflated multi-RHS PCG (ops.cg); the small dense (m+p)
Schur block is solved with lstsq on the host; full-system iterative
refinement drives the exact residual to the target.

`solve_bordered` routes as the JAX package does: small cores with a
wide border that touches every component go to a host sparse direct
solve; large mixed-precision solves with coordinates (or
operator="dia") take the block-offset DIA route (`DiaBorderedSolver`:
sliced-ELL operator K1', aligned AMG, compensated refinement ladder
K2'); all
others, and systems too small for a DIA hierarchy, take the generic
ELL route (ELL AMG + `cg.make_pcg`, every SpMV through K3', f32 inner
solves with f64 residuals and an escalation to f64 on a stall).

The DIA route keeps its one (R, n) layout at any number of copper
components: up to 63 the CG projects with a dense one-hot, beyond that
with the segment-sum projector of ops.cg (ops.segment and a gather), so
heavily fragmented boards run the same kernels and the same ladder.

Every sum on the device adds in a fixed order: the border products,
C j and the per-component sums through ops.segment's layouts, built once
at set-up; B and C themselves are summed on the host.  A solve on the
card is therefore a function of its inputs.

With a mesh (parallel.sharding.Mesh) of more than one device both
routes row-shard the inner solve, as the JAX package's `mesh=` does: the
DIA route over ops.dia_sharded (halo windows, K1' and K2' per shard) and
the sharded aligned cycle, where the hierarchy's top level shards and
the deflation has at most 64 components (else it solves on one device,
as the JAX package routes it); the ELL route over rectangular K3' shard
operators on the all-gathered vector and the sharded ELL cycle, padding
rows forming their own deflation component.  The small Schur block, the
border products and the refinement residuals stay on the mesh's first
device.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import device as device_mod
from ..parallel import sharding
from . import amg, assembly, cg, comp, dia, dia_sharded, segment, spmv

log = logging.getLogger(__name__)


@dataclass
class BorderSpec:
    """Sparse description of the MNA border.

    Border variables k = 0..m-1 (voltage sources, regulators, ground pin).
    Rows:    sum_i B[k, i] v_i = rhs[k]
    Columns: current injections C[i, k] added to core equations.
    """

    m: int
    row_idx: np.ndarray   # (nnzB,) border variable index k
    row_node: np.ndarray  # (nnzB,) core node i
    row_val: np.ndarray   # (nnzB,)
    col_idx: np.ndarray   # (nnzC,) border variable index k
    col_node: np.ndarray  # (nnzC,) core node i
    col_val: np.ndarray   # (nnzC,)
    rhs: np.ndarray       # (m,)


@dataclass
class CoreSystem:
    """The assembled system (host arrays)."""

    n: int
    ell: assembly.EllMatrix
    comp_id: np.ndarray
    num_components: int
    border: BorderSpec
    r_core: np.ndarray    # (n,)
    ground_var: int       # border variable index of the ground pin
    coords: Optional[np.ndarray] = None  # (n, 2) node coordinates (mm)
    group: Optional[np.ndarray] = None   # (n,) int mesh/layer label


@dataclass
class BorderedSolution:
    v: np.ndarray            # (n,) node potentials
    j: np.ndarray            # (m,) border currents
    residual_norm: float     # || full system residual ||
    ground_current: float
    cg_iterations: int
    refinement_steps: int


def bordered_scipy_system(system: CoreSystem):
    """(L, r, A, B, C): the full sparse system in the reference layout
    [[-A, C], [B, 0]] z = [r_core, rhs]."""
    import scipy.sparse

    n, m = system.n, system.border.m
    b = system.border
    A = system.ell.to_scipy()
    C = scipy.sparse.coo_matrix(
        (b.col_val, (b.col_node, b.col_idx)), shape=(n, m))
    B = scipy.sparse.coo_matrix(
        (b.row_val, (b.row_idx, b.row_node)), shape=(m, n))
    L = scipy.sparse.bmat([[-A, C], [B, None]], format="csc")
    r = np.concatenate([system.r_core, b.rhs])
    return L, r, A, B, C


def _index(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def _f64(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float64)).to(device)


def _border_covers_components(system: CoreSystem) -> bool:
    """True when every copper component is touched by at least one
    border row or column — a necessary condition for the direct
    bordered matrix to be nonsingular (an untouched floating component
    makes it singular; those need the iterative route's deflation)."""
    touched = np.zeros(system.num_components, dtype=bool)
    b = system.border
    touched[system.comp_id[b.row_node]] = True
    touched[system.comp_id[b.col_node]] = True
    return bool(touched.all())


def _solve_bordered_direct(system: CoreSystem):
    """Host sparse direct solve (SuperLU) of the full bordered system
    [[-A, C], [B, 0]] — only for small border-covered cores with wide
    borders (see solve_bordered).  Returns None when the factorization
    is singular (the caller takes the deflated iterative route)."""
    import warnings

    import scipy.sparse.linalg

    n, m = system.n, system.border.m
    b = system.border
    L, r, A, B, C = bordered_scipy_system(system)
    with warnings.catch_warnings():
        # A singular factorization surfaces as MatrixRankWarning +
        # inf/NaN; the finite check below turns that into a fall-through.
        warnings.simplefilter("ignore",
                              scipy.sparse.linalg.MatrixRankWarning)
        z = scipy.sparse.linalg.spsolve(L, r)
    if not np.isfinite(z).all():
        return None
    v, j = z[:n], z[n:]
    res_core = system.r_core + A @ v - C @ j
    res_border = b.rhs - B @ v
    res_norm = float(np.sqrt((res_core**2).sum() + (res_border**2).sum()))
    gc = float(j[system.ground_var]) if m > 0 else 0.0
    return BorderedSolution(
        v=v, j=np.asarray(j), residual_norm=res_norm,
        ground_current=gc, cg_iterations=0, refinement_steps=0)


def _dense_border(system: CoreSystem, device):
    """B (m, n) rows and C (n, m) columns as dense f64 tensors (m is
    small: sources + ground), summed on the host and uploaded."""
    b = system.border
    n, m = system.n, b.m
    B = np.zeros((m, n))
    np.add.at(B, (b.row_idx, b.row_node), b.row_val)
    C = np.zeros((n, m))
    np.add.at(C, (b.col_node, b.col_idx), b.col_val)
    return _f64(B, device), _f64(C, device)


class DiaBorderedSolver:
    """The block-offset-DIA solve path, set up once and solvable
    repeatedly.

    Defaults are the JAX package's settings: 4 level-0 offsets
    (`max_offsets`), a 3000-row dense bottom (`coarse_size`), inner CG
    tolerances 1e-5 (first pass / host passes) and 3e-4 (compensated
    ladder passes).  `cycle_dtype` and `w_levels` follow the device as
    in the JAX package (accelerator vs CPU): bf16 values for the cycle's
    offset entries and a W-cycle on coarse levels 2..3 on CUDA; f32 and
    the plain V-cycle on the CPU.  (The JAX package's ExtraSlots only
    place remainder entries in its dense slabs; the sliced-ELL format
    holds every entry, so there is no `slots` setting.)

    The JAX package's A/B knobs (its PADNE_TPU_* environment) are
    arguments here, with its defaults.  The hierarchy's shape:
    group=False orders level 0 without the mesh/layer key (NO_GROUP);
    coverage, deep_max_offsets, deep_coverage, drop_tol, cap, theta and
    smooth_levels (L0_COVERAGE, DEEP_OFFSETS, DEEP_COVERAGE, DROP_TOL,
    CAP, THETA, SMOOTH_LEVELS) reach amg.build_hierarchy_dia only when
    set, so None keeps its own defaults; coarse_eigh (COARSE_EIGH).  The
    cycle (amg.make_vcycle_dia_t): cycle_lumped (CYCLE_LUMPED),
    lump_smoothing, smooth_steps (SMOOTH_STEPS), cheb (CHEB), cheb_deep
    (CHEB_DEEP), and coarse="host" or "device" (HOST_COARSE /
    DEVICE_COARSE): where the coarse inverse is built; `coarse` says
    where it was ("host (validation)" when the device's failed its
    check).  The cycle variants other than coarse are single-device,
    as in the JAX package: a solve that shards raises on them.

    Data flow: the inner CG, the V-cycle, the border products and the
    compensated refinement residuals all stay on the device; the host
    solves the small (m+p) Schur block, and verifies the final residual
    in f64 on its CSR copy of the operator.

    mesh: a parallel.sharding.Mesh; with more than one device its
    devices become one row-sharding axis (tp) and the hierarchy pads for
    it (shard_min: the fewest padded rows a level shards at).  The solve
    shards (`sharded`) when the top level shards and the deflation has
    at most 64 components, as the JAX package decides: the CG operator
    and the ladder's K2' per shard over its halo window
    (ops.dia_sharded), the cycle's sharded prefix as
    amg.make_vcycle_dia_sharded, the CG as cg.make_pcg_sharded.  Else
    it logs the decline and solves on the mesh's first device.  `device`
    is then that device.
    """

    def __init__(self, system: CoreSystem, device=None, tol: float = 1e-14,
                 maxiter: int = 40000, cycle_dtype=None,
                 w_levels: "int | None" = None, max_offsets: int = 4,
                 coarse_size: int = 3000, inner_tol: float = 1e-5,
                 comp_inner_tol: float = 3e-4, mesh=None,
                 shard_min: int = 32768, group: bool = True,
                 coverage: "float | None" = None,
                 deep_max_offsets: "int | None" = None,
                 deep_coverage: "float | None" = None,
                 drop_tol: "float | None" = None, cap: "int | None" = None,
                 theta: "float | None" = None,
                 smooth_levels: "int | None" = None,
                 coarse_eigh: bool = False, cycle_lumped: bool = True,
                 lump_smoothing: bool = True, smooth_steps: int = 1,
                 cheb: int = 0, cheb_deep: int = 0, coarse: str = "host"):
        import scipy.sparse

        tp = mesh.size if mesh is not None else 1
        dev = device_mod.resolve(mesh.devices[0] if tp > 1 else device)
        self.device = dev
        self.mesh, self.tp = mesh, tp
        on_card = dev.type == "cuda"
        if cycle_dtype is None:
            cycle_dtype = torch.bfloat16 if on_card else torch.float32
        if w_levels is None:
            w_levels = 3 if on_card else 0
        self.system = system
        n, m = system.n, system.border.m
        p = system.num_components
        b = system.border
        if system.coords is None:
            raise ValueError("the DIA path needs node coordinates "
                             "(CoreSystem.coords) for the Hilbert ordering")
        self.A_host = system.ell.to_scipy()
        knobs = {k: v for k, v in (
            ("coverage", coverage), ("deep_max_offsets", deep_max_offsets),
            ("deep_coverage", deep_coverage), ("drop_tol", drop_tol),
            ("cap", cap), ("theta", theta),
            ("smooth_levels", smooth_levels)) if v is not None}
        hierarchy = amg.build_hierarchy_dia(
            system.ell, system.coords, coarse_size=coarse_size,
            group=system.group if group else None, a_csr=self.A_host,
            max_offsets=max_offsets, tp=tp, shard_min=shard_min,
            coarse_eigh=coarse_eigh, **knobs)
        if not hierarchy.levels:
            raise _NoDiaHierarchy(
                f"n={n} is too small for a DIA hierarchy at "
                f"coarse_size={coarse_size}")
        self.hierarchy = hierarchy
        meta0 = hierarchy.levels[0].pack.meta
        self.sharded = tp > 1 and hierarchy.levels[0].shard and p + 1 <= 64
        if tp > 1 and not self.sharded:
            log.info("DIA sharding declined over %d devices: %s; solving "
                     "on %s", tp,
                     "the top level does not shard"
                     if not hierarchy.levels[0].shard else
                     f"{p} deflation components exceed the sharded "
                     "projector's budget (64)", dev)
        self.n_sharded = 0
        variants = dict(cycle_lumped=cycle_lumped,
                        lump_smoothing=lump_smoothing,
                        smooth_steps=smooth_steps, cheb=cheb,
                        cheb_deep=cheb_deep)
        if self.sharded and (not cycle_lumped or not lump_smoothing
                             or smooth_steps != 1 or max(cheb, cheb_deep) > 1):
            raise ValueError(f"the sharded cycle has none of the cycle "
                             f"variants {variants}")

        posmap = hierarchy.posmap0
        np0 = hierarchy.np0
        # Deflation over padded rows: dummies form one extra component.
        comp_pad = np.full(np0, p, dtype=np.int64)
        comp_pad[posmap] = system.comp_id
        self.comp_pad_dev = _index(comp_pad, dev)

        if self.sharded:
            lv0 = hierarchy.levels[0]
            op_params = dia_sharded.upload_sharded(
                lv0.pack, dia_sharded.plan_shards(lv0.pack, tp), mesh,
                compensated=True)
            vcycle_apply, vparams, self.n_sharded = \
                amg.make_vcycle_dia_sharded(hierarchy, mesh,
                                            dtype=cycle_dtype,
                                            w_levels=w_levels, coarse=coarse)
            self.cg_solver = cg.make_pcg_sharded(
                mesh, (dia_sharded.dia_matvec_t_sharded, op_params),
                comp_pad, p + 1, (vcycle_apply, vparams), stall_window=30,
                dim=1)
        else:
            op_params = amg.make_dia_cg_operator(hierarchy, dev)
            vcycle_apply, vparams = amg.make_vcycle_dia_t(
                hierarchy, dev, dtype=cycle_dtype, w_levels=w_levels,
                coarse=coarse, **variants)

            def a_apply_t(prm, xt):
                return dia.dia_matvec_t(meta0, prm, xt)

            self.cg_solver = cg.make_pcg(
                None, self.comp_pad_dev, p + 1,
                operator=(a_apply_t, op_params),
                precond=(vcycle_apply, vparams), stall_window=30, dim=1)
        # The device operands of K1': the CG operator (shared with K2';
        # a dia_sharded.ShardedOperator when sharded), and the cycle's
        # operators level by level.
        self.op_params, self.cycle_params = op_params, vparams
        self.coarse = vparams[-1]["coarse"]
        self.inner_tol = max(tol, inner_tol)
        self.comp_inner_tol = max(tol, comp_inner_tol)
        # f32 CG gains stall after a few dozen cycles; the outer ladder
        # multiplies per-pass gains, so cap the inner solve.
        self.maxiter = min(maxiter, 300)

        self.posmap = posmap
        self.np0 = np0
        self.m, self.p = m, p
        self.posmap_dev = _index(posmap, dev)
        self._row_node_pos = _index(posmap[b.row_node], dev)
        self._row_val64 = _f64(b.row_val, dev)
        self._col_idx = _index(b.col_idx, dev)
        self._col_val64 = _f64(b.col_val, dev)
        # The fixed-order sums of the border products and the deflation
        # (ops.segment): B x over the border rows, C j onto the padded
        # nodes, Z^T r over the components and the dummy slot.
        self._row_sum = segment.SegmentSum(b.row_idx, m, dev)
        self._node_sum = segment.SegmentSum(posmap[b.col_node], np0, dev)
        self._comp_sum = segment.SegmentSum(comp_pad, p + 1, dev)
        self._b64 = torch.zeros(np0, dtype=torch.float64, device=dev)
        self._b64[self.posmap_dev] = _f64(system.r_core, dev)

        # Host-side small dense pieces.
        self.BZ = np.zeros((m, p))
        np.add.at(self.BZ, (b.row_idx, system.comp_id[b.row_node]),
                  b.row_val)
        self.ZtC = np.zeros((p, m))
        np.add.at(self.ZtC, (system.comp_id[b.col_node], b.col_idx),
                  b.col_val)
        self.C_host = scipy.sparse.coo_matrix(
            (b.col_val, (b.col_node, b.col_idx)), shape=(n, m)).tocsr()
        self.B_host = scipy.sparse.coo_matrix(
            (b.row_val, (b.row_idx, b.row_node)), shape=(m, n)).tocsr()
        self._cg_iters = 0
        self._BXc_host = None
        # A^+ C: the m border columns never change across passes or
        # solves (only the residual column does), so they solve once.
        self._Xc = None

    def set_excitation(self, r_core, rhs) -> None:
        """Replace the excitation (core right-hand side r_core (n,) and
        border right-hand side rhs (m,)) of a set-up solver in place.

        The operator, the hierarchy and A^+ C do not depend on it, so a
        solve after this one runs its first CG at R = 1.  The ladder's
        device copy of r_core is rebuilt here: refreshing only the host
        arrays would leave the compensated residuals evaluated against
        the old excitation."""
        self.system.r_core[:] = r_core
        self.system.border.rhs[:] = rhs
        self._b64.zero_()
        self._b64[self.posmap_dev] = _f64(self.system.r_core, self.device)

    # -- device pieces ----------------------------------------------------

    def _build_rhs(self, rc_pad):
        """[C | rc] as a padded (np0, m+1) f32 block: C's columns summed
        on the host in f64 (they depend on the system alone)."""
        b = self.system.border
        c = np.zeros((self.np0, self.m + 1))
        np.add.at(c, (self.posmap[b.col_node], b.col_idx), b.col_val)
        rhs = torch.from_numpy(c.astype(np.float32)).to(self.device)
        rhs[:, self.m] = rc_pad
        return rhs

    def _border_apply(self, x64):
        """B @ x for padded f64 x of shape (np0,) or (np0, R)."""
        g = x64[self._row_node_pos] * (
            self._row_val64 if x64.ndim == 1 else self._row_val64[:, None])
        return self._row_sum(g)

    def _c_apply(self, j64):
        """C @ j as a padded f64 (np0,) vector."""
        return self._node_sum(self._col_val64 * j64[self._col_idx])

    def _a64(self, v32):
        """A64 @ v as f64 for padded f32 v (np0,): kernel K2' over the CG
        operator, one launch, or one per shard over its window."""
        if not self.sharded:
            return comp.comp_sell(self.op_params, v32)
        return sharding.gather_to(dia_sharded.comp_sharded(
            self.op_params, sharding.split(self.mesh, v32, dim=0)),
            self.device, dim=0)

    def _ztr(self, r64):
        """Z^T r per component (without the dummy padding slot)."""
        return self._comp_sum(r64)[:self.p]

    def _run_cg(self, rhs, tol=None):
        res = self.cg_solver(rhs, self.inner_tol if tol is None else tol,
                             self.maxiter)
        self._cg_iters += res.iterations
        return res.x

    def _solve_once(self, rc, rb, tol=None):
        """One Schur pass; rc (n,) rb (m,) host f64 -> (v_pad, j): the
        padded f32 device correction and the host f64 border unknowns."""
        m, p = self.m, self.p
        dev = self.device
        rc_pad = torch.zeros(self.np0, dtype=torch.float32, device=dev)
        rc_pad[self.posmap_dev] = torch.from_numpy(
            rc.astype(np.float32)).to(dev)
        if self._Xc is None:
            X = self._run_cg(self._build_rhs(rc_pad))       # (np0, m+1)
            self._Xc = X[:, :m]
        else:
            x_rc = self._run_cg(rc_pad[:, None], tol=tol)   # (np0, 1)
            X = torch.cat([self._Xc, x_rc], dim=1)
        bx = self._border_apply(X.double()).cpu().numpy()
        BXc, Bxr = bx[:, :m], bx[:, m]
        self._BXc_host = BXc
        Ztr = np.zeros(p)
        np.add.at(Ztr, self.system.comp_id, rc)
        j, c = self._small_correction(BXc, Bxr, rb, Ztr)
        c_full = torch.from_numpy(
            np.concatenate([c, [0.0]]).astype(np.float32)).to(dev)
        jt = torch.from_numpy(j.astype(np.float32)).to(dev)
        v_pad = X[:, :m] @ jt - X[:, m] + c_full[self.comp_pad_dev]
        return v_pad, j

    def _small_correction(self, BXc, Bxr, rb, Ztr):
        """Solve the small dense (m+p) Schur block with lstsq (graceful
        on ill-posed borders): returns the border correction (j, c)."""
        m, p = self.m, self.p
        top = np.concatenate([BXc, self.BZ], axis=1)
        bot = np.concatenate([self.ZtC, np.zeros((p, p))], axis=1)
        M = np.concatenate([top, bot], axis=0)
        rhs_small = np.concatenate([rb + Bxr, Ztr])
        sol, *_ = np.linalg.lstsq(M, rhs_small, rcond=None)
        return sol[:m], sol[m:]

    def _full_residual(self, v, j):
        """Exact host f64 residual (core, border) of (v, j)."""
        b = self.system.border
        res_core = self.system.r_core + self.A_host @ v - self.C_host @ j
        res_border = b.rhs - self.B_host @ v
        return res_core, res_border

    # -- compensated ladder -----------------------------------------------

    def _fused_pass(self, xr, pinv, BXc64, BZ64, r64, rb64, dcorr64, j64):
        """One refinement pass on the device: border products, the small
        correction through the prefactored pinv of the constant Schur
        block (minimum-norm, like the host lstsq), and the compensated
        residual update.  Returns (r, rb, dcorr, j, ||r||^2)."""
        xr64 = xr.double()
        Bxr = self._border_apply(xr64)
        rhs_small = torch.cat([rb64 + Bxr, self._ztr(r64)])
        sol = pinv @ rhs_small
        dj, c = sol[:self.m], sol[self.m:]
        c_full = torch.cat([c, c.new_zeros(1)]).float()
        dj32 = dj.float()
        dv = self._Xc @ dj32 - xr + c_full[self.comp_pad_dev]
        av = self._a64(dv)
        r_new = r64 + av - self._c_apply(dj32.double())
        rb_new = rb64 - (BXc64 @ dj - Bxr + BZ64 @ c)
        n2 = (r_new * r_new).sum() + (rb_new * rb_new).sum()
        return r_new, rb_new, dcorr64 + dv.double(), j64 + dj, n2

    def _comp_refine(self, v1_pad, j, target_residual, max_refinements):
        """Device-resident refinement ladder on the compensated operator:
        nothing n-sized crosses to the host until the final v; one scalar
        per pass steers the loop.  The returned residual is the exact
        host f64 one of the returned (v, j).

        Returns (v, j, res_core, res_border, res_norm, refinements)."""
        dev = self.device
        b = self.system.border
        j64 = _f64(j, dev)
        r64 = (self._b64 + self._a64(v1_pad)
               - self._c_apply(j64))
        rb64 = _f64(b.rhs, dev) - self._border_apply(v1_pad.double())
        res_norm = float(((r64 * r64).sum() + (rb64 * rb64).sum()).sqrt())
        p = self.p
        M = np.concatenate([
            np.concatenate([self._BXc_host, self.BZ], axis=1),
            np.concatenate([self.ZtC, np.zeros((p, p))], axis=1),
        ], axis=0)
        pinv = _f64(np.linalg.pinv(M), dev)
        BXc64, BZ64 = _f64(self._BXc_host, dev), _f64(self.BZ, dev)
        dcorr64 = torch.zeros(self.np0, dtype=torch.float64, device=dev)
        refinements = 0
        while (res_norm > target_residual
               and refinements < max_refinements):
            tol_pass = min(0.05, max(self.comp_inner_tol,
                                     0.2 * target_residual / res_norm))
            xr = self._run_cg(r64.float()[:, None], tol=tol_pass)[:, 0]
            out = self._fused_pass(xr, pinv, BXc64, BZ64, r64, rb64,
                                   dcorr64, j64)
            new_norm = float(out[4].sqrt())
            refinements += 1
            if new_norm >= res_norm:
                break   # CG stall: keep the better iterate
            r64, rb64, dcorr64, j64 = out[:4]
            res_norm = new_norm
        v = (v1_pad.double() + dcorr64)[self.posmap_dev].cpu().numpy()
        j = j64.cpu().numpy()
        res_core, res_border = self._full_residual(v, j)
        res_norm = float(np.sqrt((res_core ** 2).sum()
                                 + (res_border ** 2).sum()))
        return v, j, res_core, res_border, res_norm, refinements

    def solve(self, target_residual: float = 1e-10,
              max_refinements: int = 8) -> BorderedSolution:
        system, b = self.system, self.system.border
        self._cg_iters = 0
        v1_pad, j = self._solve_once(system.r_core, b.rhs)
        (v, j, res_core, res_border, res_norm,
         refinements) = self._comp_refine(v1_pad, j, target_residual,
                                          max_refinements)
        # Host-anchored mop-up passes, only if the ladder stopped above
        # the target (e.g. a CG stall).
        while res_norm > target_residual and refinements < max_refinements:
            tol_pass = min(0.05, max(self.inner_tol,
                                     0.2 * target_residual / res_norm))
            dv_pad, dj = self._solve_once(res_core, res_border, tol=tol_pass)
            dv = dv_pad.double()[self.posmap_dev].cpu().numpy()
            v_new, j_new = v + dv, j + dj
            rc_new, rb_new = self._full_residual(v_new, j_new)
            new_norm = float(np.sqrt((rc_new**2).sum() + (rb_new**2).sum()))
            refinements += 1
            if new_norm >= res_norm:
                break
            v, j = v_new, j_new
            res_core, res_border = rc_new, rb_new
            res_norm = new_norm

        gc = float(j[system.ground_var]) if self.m > 0 else 0.0
        return BorderedSolution(
            v=v, j=np.asarray(j), residual_norm=res_norm,
            ground_current=gc, cg_iterations=self._cg_iters,
            refinement_steps=refinements,
        )


def solve_bordered_dia(system: CoreSystem, device=None,
                       target_residual: float = 1e-10,
                       max_refinements: int = 8,
                       **solver_kw) -> BorderedSolution:
    """One-shot wrapper around DiaBorderedSolver."""
    solver = DiaBorderedSolver(system, device=device, **solver_kw)
    return solver.solve(target_residual=target_residual,
                        max_refinements=max_refinements)


class _NoDiaHierarchy(Exception):
    """No DIA hierarchy could be built (system too small)."""


def solve_bordered(
    system: CoreSystem,
    tol: float = 1e-14,
    maxiter: int = 40000,
    max_refinements: int = 8,
    target_residual: float = 1e-10,
    inner_dtype=None,
    operator: str = "auto",
    device=None,
    stats: Optional[dict] = None,
    mesh=None,
    precond: str = "auto",
    amg_threshold: int = 5000,
    dia_threshold: int = 200_000,
    dia_shard_min: int = 32768,
    direct_small: bool = True,
) -> BorderedSolution:
    """Solve the full bordered system, routed as the JAX package routes.

    inner_dtype: torch dtype of the inner CG/AMG solve (the JAX
    package's device_dtype); None means float64.  A lower precision runs
    classic mixed-precision iterative refinement: f32 inner solves, f64
    residuals and accumulated solution.

    operator: "auto" sends mixed-precision solves of n >= dia_threshold
    with coordinates to the DIA route and everything else, including
    systems too small for a DIA hierarchy, to the ELL route; "dia" and
    "ell" force one.

    precond: the ELL route's preconditioner: "auto" (AMG from
    amg_threshold core unknowns, Jacobi below), "amg" or "jacobi".

    direct_small: with operator "auto", a core of at most 50,000
    unknowns with a border wider than 16 that touches every component
    takes the host sparse direct solve; False keeps it iterative (the
    JAX package's PADNE_TPU_DIRECT_SMALL=0).

    mesh: a parallel.sharding.Mesh; with more than one device the inner
    solve row-shards over it (module doc) and `device` is the mesh's
    first device; dia_shard_min is the fewest padded rows a DIA level
    shards at (DiaBorderedSolver's shard_min).

    stats: optional dict that receives the route ("direct", "dia" or
    "ell"), the hierarchy's level sizes, setup_s (hierarchy build and
    uploads), tp and sharded (whether the inner solve sharded), on the
    DIA route coarse (where the coarse inverse was built) and, on the
    ELL route, ell_k and escalated."""
    if precond not in ("auto", "amg", "jacobi"):
        raise ValueError(f"precond={precond!r}: 'auto', 'amg' or 'jacobi'")
    n, m = system.n, system.border.m
    stats = {} if stats is None else stats
    if operator == "dia" and system.coords is None:
        raise ValueError("operator='dia' needs node coordinates "
                         "(CoreSystem.coords) for the Hilbert ordering")
    # Small core + WIDE MNA border: m+1 Schur columns of CG work are out
    # of proportion to a system SuperLU factors in milliseconds.  A
    # copper component no border row touches leaves the bordered matrix
    # singular, so such boards keep the iterative route.
    if (operator == "auto" and direct_small and m > 16 and n <= 50_000
            and _border_covers_components(system)):
        direct = _solve_bordered_direct(system)
        if direct is not None:
            stats.update(route="direct", levels=[], setup_s=0.0)
            return direct

    if mesh is not None and mesh.size > 1:
        device = mesh.devices[0]
    else:
        mesh = None
    dev = device_mod.resolve(device)
    use_dia = operator == "dia" or (
        operator == "auto" and inner_dtype is not None
        and system.coords is not None and n >= dia_threshold)
    if use_dia:
        t0 = time.perf_counter()
        try:
            solver = DiaBorderedSolver(system, device=dev, tol=tol,
                                       maxiter=maxiter, mesh=mesh,
                                       shard_min=dia_shard_min)
        except _NoDiaHierarchy:
            solver = None   # fall through to the ELL route
        if solver is not None:
            stats.update(route="dia", setup_s=time.perf_counter() - t0,
                         levels=[lv.pack.np_
                                 for lv in solver.hierarchy.levels],
                         tp=solver.tp, sharded=solver.sharded,
                         coarse=solver.coarse)
            return solver.solve(target_residual=target_residual,
                                max_refinements=max_refinements)
    return _solve_bordered_ell(
        system, dev, tol=tol, maxiter=maxiter,
        max_refinements=max_refinements, target_residual=target_residual,
        inner_dtype=inner_dtype, stats=stats,
        use_amg=precond == "amg" or (precond == "auto"
                                     and n >= amg_threshold), mesh=mesh)


def _solve_bordered_ell(system: CoreSystem, dev, tol, maxiter,
                        max_refinements, target_residual, inner_dtype,
                        stats, use_amg: bool,
                        mesh=None) -> BorderedSolution:
    """The generic ELL route of solve_bordered: one multi-RHS deflated
    PCG per Schur pass over the ELL operator (kernel K3'), the small
    dense block by host lstsq, f64 full-system refinement; AMG or
    (use_amg=False) Jacobi preconditioning.  With a mesh
    the PCG and the cycle row-shard over its first row of devices
    (_sharded_ell_cg); the rest stays on `dev`."""
    t0 = time.perf_counter()
    n, m = system.n, system.border.m
    p = system.num_components
    f64 = torch.float64
    # One upload of the operator: the f64 residual, the inner solve and
    # the cycle's level 0 share its index arrays.
    a64 = system.ell.to_device(dev, f64)
    comp_id = _index(system.comp_id, dev)
    B, C = _dense_border(system, dev)
    zt = segment.SegmentSum(comp_id, p)   # Z^T y: (p, ...) per component
    mixed = inner_dtype is not None and inner_dtype != f64
    inner = inner_dtype if mixed else f64
    inner_tol = max(tol, 1e-5) if mixed else tol
    if use_amg and not mixed:
        # The V-cycle's attainable f64 residual floor sits around 1e-11
        # relative; the outer refinement multiplies the gain per pass.
        inner_tol = max(inner_tol, 1e-9)

    r_core = _f64(system.r_core, dev)
    r_border = _f64(system.border.rhs, dev)
    row_mesh = None if mesh is None else sharding.Mesh(mesh.grid[0])
    tp = 1 if row_mesh is None else row_mesh.size
    n_pad = n + (-n) % tp
    hierarchy = vcycle = vcycle64 = None
    if use_amg:
        # One layout of the cycle's operators, in f64 (what an escalation
        # needs); the mixed inner solve casts the values and shares the
        # index arrays.
        hierarchy = amg.build_hierarchy(system.ell)
        vcycle64 = amg.make_vcycle(hierarchy, dev, a0=a64, mesh=row_mesh)
        vcycle = amg.vcycle_as(vcycle64, inner) if mixed else vcycle64

    def make_solver(dtype, precond, stall_window):
        if row_mesh is None:
            return cg.make_pcg(a64.to(dtype), comp_id, p, precond=precond,
                               stall_window=stall_window)
        return _sharded_ell_cg(system, row_mesh, n_pad, dtype, precond,
                               stall_window)

    # Stall exit only with a mixed-precision inner solve (see make_pcg).
    cg_solver = make_solver(inner, vcycle, 30 if mixed else None)
    BZ = zt(B.T).T.cpu().numpy()          # (m, p)
    ZtC = zt(C).cpu().numpy()             # (p, m)
    stats.update(route="ell", ell_k=int(system.ell.cols.shape[1]),
                 levels=([len(lv.a_diag) for lv in hierarchy.levels]
                         if hierarchy is not None else []),
                 setup_s=time.perf_counter() - t0, tp=tp, sharded=tp > 1)
    total_cg_iters = 0

    def solve_once(rc, rb, tol_pass=None):
        """One Schur pass for core rhs rc and border rhs rb (f64 device
        tensors); tol_pass: inner CG tolerance (default inner_tol)."""
        nonlocal total_cg_iters
        rhs = torch.cat([C, rc[:, None]], dim=1)              # (n, m+1)
        rhs = torch.nn.functional.pad(rhs, (0, 0, 0, n_pad - n))
        res = cg_solver(rhs.to(inner),
                        inner_tol if tol_pass is None else tol_pass,
                        maxiter)
        total_cg_iters += res.iterations
        X = res.x[:n].to(f64)              # [A^+ C | A^+ rc]
        Xc, xr = X[:, :m], X[:, m]
        BXc = (B @ Xc).cpu().numpy()                          # (m, m)
        Bxr = (B @ xr).cpu().numpy()                          # (m,)
        Ztr = zt(rc).cpu().numpy()                            # (p,)
        rb_h = rb.cpu().numpy()
        if p > 256:
            # Heavily fragmented copper: the block matrix is almost all
            # the (p, p) zero block — solve the thin blocks directly:
            # lstsq(ZtC) for j, then the minimum-norm c from the first
            # block; the outer refinement guards rank-deficient corners.
            j, *_ = np.linalg.lstsq(ZtC, Ztr, rcond=None)
            c, *_ = np.linalg.lstsq(BZ, (rb_h + Bxr) - BXc @ j, rcond=None)
        else:
            M = np.concatenate([
                np.concatenate([BXc, BZ], axis=1),
                np.concatenate([ZtC, np.zeros((p, p))], axis=1)], axis=0)
            sol, *_ = np.linalg.lstsq(M, np.concatenate([rb_h + Bxr, Ztr]),
                                      rcond=None)
            j, c = sol[:m], sol[m:]
        jt, ct = _f64(j, dev), _f64(c, dev)
        return Xc @ jt - xr + ct[comp_id], jt

    def full_residual(v, j):
        # core: r_core - (-A v + C j);  border: r_border - B v.  One
        # fused launch gives (C j - r_core) - A v, the core part negated.
        neg = spmv.ell_spmv(a64, v[:, None], b=(C @ j - r_core)[:, None])
        return -neg[:, 0], r_border - B @ v

    def norm(rc, rb):
        return float(((rc * rc).sum() + (rb * rb).sum()).sqrt())

    def escalate_inner_to_f64():
        """Swap the inner solve to f64 after a mixed-precision stall: an
        f32 inner operator contracts per pass by ~kappa(A)*eps32, and
        boards mixing milliohm couplings with thin-sliver cotan weights
        push kappa past 1e7, above the target."""
        nonlocal cg_solver, inner_tol, inner
        cg_solver = make_solver(f64, vcycle64, None)
        inner = f64
        inner_tol = max(tol, 1e-9) if use_amg else max(tol, 1e-12)

    v, j = solve_once(r_core, r_border)
    refinements = 0
    escalated = False
    budget = max_refinements
    res_core, res_border = full_residual(v, j)
    res_norm = norm(res_core, res_border)
    while res_norm > target_residual:
        if refinements >= budget:
            if mixed and not escalated:
                escalate_inner_to_f64()
                escalated = True
                budget = refinements + 4
                continue
            break
        # Pass-adaptive inner tolerance: request only the remaining
        # contraction to the outer target, with a 5x margin.
        tol_pass = min(0.05, max(inner_tol, 0.2 * target_residual / res_norm))
        dv, dj = solve_once(res_core, res_border, tol_pass=tol_pass)
        v_new, j_new = v + dv, j + dj
        rc_new, rb_new = full_residual(v_new, j_new)
        new_norm = norm(rc_new, rb_new)
        refinements += 1
        if new_norm >= res_norm:
            if mixed and not escalated:
                # Discard the failed iterate; retry the pass in f64.
                escalate_inner_to_f64()
                escalated = True
                budget = refinements + 4
                continue
            break  # no progress; keep the better iterate
        v, j = v_new, j_new
        res_core, res_border = rc_new, rb_new
        res_norm = new_norm

    stats["escalated"] = escalated
    j = j.cpu().numpy()
    gc = float(j[system.ground_var]) if m > 0 else 0.0
    return BorderedSolution(
        v=v.cpu().numpy(), j=j, residual_norm=res_norm, ground_current=gc,
        cg_iterations=total_cg_iters, refinement_steps=refinements)


def _sharded_ell_cg(system: CoreSystem, mesh, n_pad: int, dtype, precond,
                    stall_window):
    """The ELL route's deflated PCG row-sharded over `mesh`, the JAX
    package's make_pcg(mesh=): rows padded to n_pad (a multiple of the
    mesh size; padding rows form their own deflation component, so they
    carry exactly zero), each shard's rows a rectangular K3' operator
    over the all-gathered x with the diagonal as one more entry a row
    (amg.shard_ell_rows), Jacobi from the padded diagonal when no cycle
    is given.  Solves (n_pad, R) right-hand sides."""
    ell, n, p = system.ell, system.n, system.num_components
    ops = amg.shard_ell_rows(ell.cols, ell.vals, ell.diag, n_pad, n_pad,
                             mesh, dtype)
    comp_cg = np.concatenate([system.comp_id,
                              np.full(n_pad - n, p, np.int64)])

    def matvec(prm, xs):
        return [spmv.ell_spmv(op, xf) for op, xf in
                zip(prm, sharding.all_gather(mesh, xs, dim=0))]

    if precond is None:
        diag = torch.from_numpy(np.pad(np.asarray(ell.diag, np.float64),
                                       (0, n_pad - n))).to(dtype)
        precond = cg.jacobi_sharded(sharding.split(mesh, diag, dim=0))
    return cg.make_pcg_sharded(mesh, (matvec, ops), comp_cg,
                               p + (n_pad > n), precond,
                               stall_window=stall_window)
