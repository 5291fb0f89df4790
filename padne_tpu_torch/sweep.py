"""Batched design sweeps: many solves of one board, varying parameters.

Port of padne_tpu.sweep.  Mesher output and system structure are shared
across a sweep over physical parameters (copper weight / sheet
conductance, source values): the board is meshed and assembled once, the
ELL operator is uploaded once, and ONE float64 multi-RHS deflated PCG
over the border columns and the core right-hand side serves every
configuration; each configuration then costs a small dense (m + p)
least-squares solve on the host, a rescaling on the device and one fused
residual launch.  Every sparse product is kernel K3' (ops.spmv) in its
float64 instantiations.

Supported sweep axes:
  * global conductance scale (copper weight / thickness sweep)
  * per-source value scaling (voltage/current magnitudes)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from . import device as device_mod
from . import mesh, problem, solver, spans
from .ops import amg, cg, schur, segment, spmv

# From this many core unknowns the CG is preconditioned with the ELL AMG
# cycle, below with Jacobi (the JAX package's sweep threshold).
_AMG_THRESHOLD = 20000


@dataclass
class SweepSpec:
    """One configuration of the sweep."""

    conductance_scale: float = 1.0
    source_scale: float = 1.0


@dataclass
class SweepResult:
    spec: SweepSpec
    v: np.ndarray
    j: np.ndarray
    residual_norm: float


def solve_sweep(
    prob: problem.Problem,
    specs: Sequence[SweepSpec],
    mesher_config: Optional[mesh.Mesher.Config] = None,
    tol: float = 1e-12,
    maxiter: int = 40000,
    device=None,
    stats: Optional[dict] = None,
) -> list[SweepResult]:
    """Solve the board once per spec, sharing mesh + structure, on
    `device` (None: the CUDA card; see padne_tpu_torch.device).

    Scaling all conductances by s scales A by s, so A(s)^+ = A^+ / s:
    the expensive multi-RHS CG over the border columns runs ONCE on the
    unit-conductance system; per-spec solutions are recovered by
    rescaling inside the small dense border system.  Source scaling
    enters only through the right-hand sides.

    The JAX sweep runs its CG as one while_loop to maxiter; so does the
    port on the card (one launch of a CUDA WHILE graph, the continue
    test read once after it); on the CPU it is the plain loop (ops.cg's
    module doc).

    stats: optional dict that receives n, m, p, cg_iterations, the wall
    times mesh_assemble_s, setup_s (hierarchy and uploads), cg_s (the one
    multi-RHS solve) and recover_s (all per-spec recoveries), the CG's
    final true residual norm per column (cg_residual_norms), and the
    norms of the unit-scale right-hand side (rhs_core_norm,
    rhs_border_norm), host_reads (the CG's continue tests read on the
    host) and capture_s (the CUDA graph capture, 0 without one).  The
    wall times are the seconds of the call's spans (padne_tpu_torch.
    spans) `sweep.mesh_assemble`, `sweep.setup`, `sweep.cg` and
    `sweep.recover`."""
    dev = device_mod.resolve(device)
    f64 = torch.float64
    with spans.span("sweep.mesh_assemble") as mesh_assemble:
        system = solver.build_system(prob, mesher_config)[0]

    n, m = system.n, system.border.m
    p = system.num_components
    with spans.span("sweep.setup") as setup:
        a = system.ell.to_device(dev, f64)
        comp_id = torch.from_numpy(
            np.asarray(system.comp_id, np.int64)).to(dev)
        B, C = schur._dense_border(system, dev)
        r_core = torch.from_numpy(
            np.asarray(system.r_core, np.float64)).to(dev)
        r_border = torch.from_numpy(
            np.asarray(system.border.rhs, np.float64)).to(dev)

        precond = None
        if n >= _AMG_THRESHOLD:
            with spans.span("setup.hierarchy"):
                hierarchy = amg.build_hierarchy(system.ell)
            precond = amg.make_vcycle(hierarchy, dev, a0=a)
        cg_solver = cg.make_pcg(a, comp_id, p, precond=precond)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # One multi-RHS solve of the UNIT-conductance system.
    with spans.span("sweep.cg") as cg_span:
        rhs = torch.cat([C, r_core[:, None]], dim=1)
        res = cg_solver(rhs, tol, maxiter)
        Xc, xr = res.x[:, :m].contiguous(), res.x[:, m].contiguous()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with spans.span("sweep.recover") as recover:
        zt = segment.SegmentSum(comp_id, p)   # Z^T y, a fixed-order sum

        # The spec-independent pieces of the small block, on the host (m + p
        # is small, and the block is rank deficient by construction when a
        # component floats: numpy's SVD-based lstsq gives the minimum norm).
        BXc = (B @ Xc).cpu().numpy()
        Bxr = (B @ xr).cpu().numpy()
        BZ = zt(B.T).T.cpu().numpy()
        ZtC = zt(C).cpu().numpy()
        Ztr = zt(r_core).cpu().numpy()
        rb_host = r_border.cpu().numpy()
        bot = np.concatenate([ZtC, np.zeros((p, p))], axis=1)

        results = []
        for spec in specs:
            s = spec.conductance_scale
            src = spec.source_scale
            # A -> s A; r_core scales with source_scale; border voltage rhs
            # scales with source_scale.
            # v = (sA)^+ (C j - src*r_core) + Z c = (1/s)(Xc j - src*xr) + Z c
            M = np.concatenate(
                [np.concatenate([BXc / s, BZ], axis=1), bot], axis=0)
            rhs_small = np.concatenate(
                [src * rb_host + Bxr * (src / s), src * Ztr])
            sol, *_ = np.linalg.lstsq(M, rhs_small, rcond=None)
            jj = torch.from_numpy(sol[:m]).to(dev)
            c = torch.from_numpy(sol[m:]).to(dev)
            v = (Xc @ jj - src * xr) / s + c[comp_id]

            # Full residual of this spec: the core part of the scaled system
            # is src*r_core + s*A v - C j = -s * ((C j - src*r_core)/s - A v),
            # one fused launch over the unit-conductance operator.
            fused = spmv.ell_spmv(
                a, v[:, None], b=((C @ jj - src * r_core) / s)[:, None])
            rc = -s * fused[:, 0]
            rb = src * r_border - B @ v
            res_norm = float(((rc * rc).sum() + (rb * rb).sum()).sqrt())
            results.append(
                SweepResult(
                    spec=spec,
                    v=v.cpu().numpy(),
                    j=jj.cpu().numpy(),
                    residual_norm=res_norm,
                )
            )
    if stats is not None:
        stats.update(
            n=n, m=m, p=p, cg_iterations=res.iterations,
            host_reads=res.host_reads,
            capture_s=cg_solver.loop.capture_s,
            cg_residual_norms=res.residual_norms.cpu().numpy().tolist(),
            rhs_core_norm=float(np.linalg.norm(system.r_core)),
            rhs_border_norm=float(np.linalg.norm(system.border.rhs)),
            mesh_assemble_s=mesh_assemble.seconds, setup_s=setup.seconds,
            cg_s=cg_span.seconds, recover_s=recover.seconds)
    return results
