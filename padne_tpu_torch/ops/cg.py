"""Deflated multi-RHS preconditioned conjugate gradients, (R, N) layout.

Port of padne_tpu.ops.cg's `make_pcg_t`.  A is an SPSD graph Laplacian
whose nullspace is the per-component constants; the solver works in the
orthogonal complement by projecting the RHS, every preconditioned
residual and (periodically) the residual itself, which yields A^+ B.
Each column keeps its own alpha/beta and stops on its own tolerance;
all columns share one multi-RHS matvec and one V-cycle per iteration.

The JAX `while_loop` is a Python loop here: the continue condition is
read on the host once per iteration (one device sync per iteration).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CGResult(NamedTuple):
    x: torch.Tensor               # (N, R)
    iterations: int
    residual_norms: torch.Tensor  # (R,) final ||b - A x|| per column


def make_projector(comp_id: torch.Tensor, num_components: int):
    """Orthogonal projector onto the complement of per-component constant
    vectors, for (R, N) arrays: x <- x - mean_of_component(x), as dense
    one-hot matmuls (fine up to a few dozen components)."""
    onehot = torch.nn.functional.one_hot(
        comp_id.long(), num_components).to(torch.float32)      # (N, p)
    # Clamp: an empty component (e.g. a dummy padding component when the
    # padded size equals n) must not turn means into NaN.
    counts = onehot.sum(dim=0).double().clamp_min(1.0)

    def project(xt):
        oh = onehot.to(xt.dtype)
        sums = xt @ oh                                          # (R, p)
        means = sums / counts.to(xt.dtype)[None, :]
        return xt - means @ oh.T

    return project


def make_pcg_t(operator, precond, comp_id: torch.Tensor,
               num_components: int, stall_window: "int | None" = 30):
    """Deflated PCG with state kept as (R, N).

    operator: (apply, params) with yt = apply(params, xt) on (R, N).
    precond: (apply, params) in the same layout (amg.make_vcycle_dia_t).

    stall_window: exit once no active column has improved 3% in this
    many iterations.  Only safe under an outer refinement loop that
    multiplies partial gains (columns pinned at the f32 noise floor
    would otherwise spin to maxiter); None disables it.

    Returns solve(b, tol, maxiter) with b of shape (N, R) and a CGResult
    whose x is (N, R): one transpose each way per solve."""
    a_apply, a_params = operator
    m_apply, m_params = precond
    project = make_projector(comp_id, num_components)
    # 2^31 - 2 == disabled: the counter cannot reach it before maxiter.
    window = stall_window if stall_window is not None else 2**31 - 2

    def dot(a, b2):
        return (a * b2).sum(dim=1)              # (R,)

    def matvec(xt):
        return a_apply(a_params, xt)

    def apply_m(rt):
        return m_apply(m_params, rt)

    def solve(b, tol, maxiter: int = 10000) -> CGResult:
        bt = project(b.T.contiguous())
        target = tol * dot(bt, bt).sqrt().clamp_min(1e-300)
        x = torch.zeros_like(bt)
        r = bt
        z = project(apply_m(r))
        p = z
        rz = dot(r, z)
        rn = dot(r, r).sqrt()
        best = rn
        stall = torch.zeros_like(rn, dtype=torch.int32)
        k = 0
        while k < maxiter:
            active = rn > target
            if not bool((active & (stall < window)).any()):
                break
            ap = matvec(p)
            pap = dot(p, ap)
            alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0),
                                0.0)
            alpha = torch.where(active, alpha, 0.0)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * ap
            if k % 50 == 49:
                # Periodic re-projection kills drift into the nullspace.
                r = project(r)
            z = project(apply_m(r))
            rz_new = dot(r, z)
            beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, 1.0),
                               0.0)
            # Restart (p = z) on negative beta: below the f32 residual
            # floor rz is rounding noise and beta > 1 runs would grow p.
            beta = torch.where(active & (beta > 0), beta, 0.0)
            p = z + beta[:, None] * p
            rz = rz_new
            rn = dot(r, r).sqrt()
            improved = rn < 0.97 * best
            best = torch.minimum(best, rn)
            stall = torch.where(improved, 0, stall + 1)
            k += 1
        rtrue = bt - matvec(x)
        return CGResult(x=project(x).T, iterations=k,
                        residual_norms=dot(rtrue, rtrue).sqrt())

    return solve
