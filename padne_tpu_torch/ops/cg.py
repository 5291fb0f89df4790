"""Deflated multi-RHS preconditioned conjugate gradients.

Port of padne_tpu.ops.cg's `make_pcg` and `make_pcg_t` as one solver:
the generic route runs it in (N, R) layout over the ELL operator
(kernel K3') with the ELL AMG cycle or Jacobi, the DIA route in (R, N)
layout over the sliced-ELL operator with the aligned DIA cycle.  A is
an SPSD graph Laplacian whose nullspace is the per-component constants;
the solver works in the orthogonal complement by projecting the RHS,
every preconditioned residual and (periodically) the residual itself,
which yields A^+ B.  Each column keeps its own alpha/beta and stops on
its own tolerance; all columns share one multi-RHS matvec and one
preconditioner application per iteration.

`make_pcg_sharded` is the same solver over per-shard state on a device
mesh (padne_tpu.ops.cg's `make_pcg_t_sharded` and `make_pcg(mesh=)`):
dots are sums of per-shard partials, and the deflation projector sums
per-shard segment sums across the shards.

The JAX `while_loop` is a Python loop here: the continue condition is
read on the host once per iteration (one device sync per iteration).
The stateful chunked restarts of the JAX package (`solve.stateful`,
`dispatch_cap`) exist for a TPU runtime's dispatch time limit and are
not carried.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import spmv

# 2^31 - 2 == stall exit disabled: the counter cannot reach it before
# maxiter.
_NO_STALL = 2**31 - 2


class CGResult(NamedTuple):
    x: torch.Tensor               # (N, R)
    iterations: int
    residual_norms: torch.Tensor  # (R,) final ||b - A x|| per column


def make_projector(comp_id: torch.Tensor, num_components: int,
                   dim: int = 0):
    """Orthogonal projector onto the complement of per-component constant
    vectors: x <- x - mean_of_component(x), for arrays whose axis `dim`
    runs over the N unknowns ((N, R) for dim 0, (R, N) for dim 1).

    One component: subtract the means.  Up to 64: dense one-hot
    matmuls.  Beyond 64 the (N, p) one-hot would be accidentally
    quadratic (eroded boards fragment into thousands of islands), so a
    segment sum (index_add_) and a gather take over."""
    if num_components == 1:
        def project(x):
            return x - x.mean(dim=dim, keepdim=True)

        return project

    comp_id = comp_id.long()
    if num_components > 64:
        counts = torch.zeros(num_components, dtype=torch.float64,
                             device=comp_id.device).index_add_(
            0, comp_id, torch.ones(comp_id.shape[0], dtype=torch.float64,
                                   device=comp_id.device)).clamp_min(1.0)

        def project(x):
            shape = list(x.shape)
            shape[dim] = num_components
            sums = torch.zeros(shape, dtype=x.dtype,
                               device=x.device).index_add_(dim, comp_id, x)
            means = sums / counts.to(x.dtype).unsqueeze(1 - dim)
            return x - means.index_select(dim, comp_id)

        return project

    # One-hot held in f32 (exact 0/1 values) and cast to the iterate's
    # dtype at use: exact for f64 solves, f32 state stays f32.  Clamp: an
    # empty component (e.g. a dummy padding component when the padded
    # size equals n) must not turn means into NaN.
    onehot = torch.nn.functional.one_hot(
        comp_id, num_components).to(torch.float32)             # (N, p)
    counts = onehot.sum(dim=0).double().clamp_min(1.0)

    def project(x):
        oh = onehot.to(x.dtype)
        if dim == 0:
            means = (oh.T @ x) / counts[:, None].to(x.dtype)     # (p, R)
            return x - oh @ means
        means = (x @ oh) / counts.to(x.dtype)[None, :]           # (R, p)
        return x - means @ oh.T

    return project


def make_pcg(a: Optional[spmv.EllOperator], comp_id: torch.Tensor,
             num_components: int, precond: Optional[tuple] = None,
             operator: Optional[tuple] = None,
             stall_window: Optional[int] = None, dim: int = 0):
    """Deflated PCG bound to one operator.

    a: the ELL operator on the device (assembly.EllMatrix.to_device);
    its matvec is kernel K3'.  None with operator=.
    operator: optional (apply, params) replacing it, y = apply(params, x);
    the Jacobi fallback then reads params["diag"].
    precond: (apply, params) with z = apply(params, r), e.g.
    amg.make_vcycle; None selects Jacobi.

    dim: the axis of the N unknowns in the solver's state, the layout in
    which operator and precond take and return arrays: 0 keeps (N, R)
    (the ELL route), 1 keeps (R, N) (the DIA route: dia.dia_matvec_t and
    amg.make_vcycle_dia_t; it needs an operator).  solve takes and
    returns (N, R) either way: with dim 1, one transpose each way.

    stall_window: exit once no active column has improved 3% in this
    many iterations.  Only safe under an outer refinement loop with an
    inner precision floor below the requested tol (the mixed f32 case);
    in a full-precision solve CG may plateau longer than any window
    before converging, so leave it None there.

    Returns solve(b, tol, maxiter) -> CGResult."""
    if operator is None and dim != 0:
        raise ValueError("the ELL operator runs in the (N, R) layout; "
                         "pass operator= for dim=1")
    if precond is None:
        if operator is not None and not (
                isinstance(operator[1], dict) and "diag" in operator[1]):
            raise ValueError(
                "Jacobi fallback needs the operator's diagonal: pass "
                "precond=, or an operator params dict with a 'diag' key")
        dg = operator[1]["diag"] if operator is not None else a.diag
        minv = torch.where(dg > 0, 1.0 / torch.where(dg > 0, dg, 1.0),
                           1.0).unsqueeze(1 - dim)

        def apply_m(r):
            return minv * r
    else:
        m_apply, m_params = precond

        def apply_m(r):
            return m_apply(m_params, r)

    if operator is not None:
        a_apply, a_params = operator

        def matvec(x):
            return a_apply(a_params, x)
    else:
        def matvec(x):
            return spmv.ell_spmv(a, x)

    project = make_projector(comp_id, num_components, dim)
    window = _NO_STALL if stall_window is None else stall_window

    def dot(a, b2):
        return (a * b2).sum(dim=dim)            # (R,)

    def solve(b, tol, maxiter: int = 10000) -> CGResult:
        b = project(b if dim == 0 else b.T.contiguous())
        target = tol * dot(b, b).sqrt().clamp_min(1e-300)
        x = torch.zeros_like(b)
        r = b
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
            alpha = torch.where(active, alpha, 0.0).unsqueeze(dim)
            x = x + alpha * p
            r = r - alpha * ap
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
            p = z + beta.unsqueeze(dim) * p
            rz = rz_new
            rn = dot(r, r).sqrt()
            improved = rn < 0.97 * best
            best = torch.minimum(best, rn)
            stall = torch.where(improved, 0, stall + 1)
            k += 1
        # The true residual: one fused launch over the ELL operator.
        rtrue = (spmv.ell_spmv(a, x, b=b) if operator is None
                 else b - matvec(x))
        x = project(x)
        return CGResult(x=x if dim == 0 else x.T, iterations=k,
                        residual_norms=dot(rtrue, rtrue).sqrt())

    return solve


def jacobi_sharded(diags: list, dim: int = 0):
    """(apply, params) of the Jacobi preconditioner over per-shard
    diagonals, for make_pcg_sharded: z = r / diag where diag > 0."""
    minv = [torch.where(d > 0, 1.0 / torch.where(d > 0, d, 1.0),
                        1.0).unsqueeze(1 - dim) for d in diags]

    def apply(p, rs):
        return [m * r for m, r in zip(p, rs)]

    return apply, minv


def make_pcg_sharded(mesh, operator: tuple, comp_id, num_components: int,
                     precond: tuple, stall_window: Optional[int] = None,
                     dim: int = 0):
    """Deflated PCG over per-shard state on `mesh`
    (parallel.sharding.Mesh): the counterpart of the JAX package's
    make_pcg_t_sharded (dim 1, the DIA route's (R, N) layout) and
    make_pcg(mesh=) (dim 0, the ELL route's (N, R)).

    operator, precond: (apply, params) with ys = apply(params, xs) on
    lists of per-shard blocks, shard s's rows [s * N / tp, (s + 1) * N /
    tp) on mesh.devices[s] (e.g. ops.dia_sharded.dia_matvec_t_sharded
    and amg.make_vcycle_dia_sharded, or jacobi_sharded).  comp_id: (N,)
    component of each row (N a multiple of the mesh size).

    The iteration is make_pcg's: every dot is a psum of per-shard
    partials, the projector subtracts component means from per-shard
    segment sums summed across shards, and the continue condition is
    read on the host once per iteration.  solve(b, tol, maxiter) takes
    (N, R) on any device and returns CGResult with x (N, R) on the
    mesh's first device."""
    from ..parallel import sharding

    a_apply, a_params = operator
    m_apply, m_params = precond
    comp = sharding.split(mesh, torch.as_tensor(comp_id).long(), dim=0)
    counts = sharding.psum(mesh, [
        torch.zeros(num_components, dtype=torch.float64,
                    device=c.device).index_add_(
            0, c, torch.ones(len(c), dtype=torch.float64, device=c.device))
        for c in comp]).clamp_min(1.0)
    window = _NO_STALL if stall_window is None else stall_window

    def project(xs):
        shape = list(xs[0].shape)
        shape[dim] = num_components
        sums = sharding.psum(mesh, [
            x.new_zeros(shape).index_add_(dim, c, x)
            for x, c in zip(xs, comp)])
        means = sums / counts.to(sums.dtype).unsqueeze(1 - dim)
        return [x - m.index_select(dim, c) for x, m, c in
                zip(xs, sharding.broadcast(mesh, means), comp)]

    def dot(xs, ys):
        return sharding.psum(mesh, [(x * y).sum(dim=dim)
                                    for x, y in zip(xs, ys)])   # (R,)

    def scaled(coef):
        return sharding.broadcast(mesh, coef.unsqueeze(dim))

    def solve(b, tol, maxiter: int = 10000) -> CGResult:
        bs = project(sharding.split(mesh, b if dim == 0 else b.T, dim))
        target = tol * dot(bs, bs).sqrt().clamp_min(1e-300)
        xs = [torch.zeros_like(x) for x in bs]
        rs = bs
        zs = project(m_apply(m_params, rs))
        ps = zs
        rz = dot(rs, zs)
        rn = dot(rs, rs).sqrt()
        best = rn
        stall = torch.zeros_like(rn, dtype=torch.int32)
        k = 0
        while k < maxiter:
            active = rn > target
            if not bool((active & (stall < window)).any()):
                break
            aps = a_apply(a_params, ps)
            pap = dot(ps, aps)
            alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0),
                                0.0)
            alpha = scaled(torch.where(active, alpha, 0.0))
            xs = [x + a * p for x, a, p in zip(xs, alpha, ps)]
            rs = [r - a * ap for r, a, ap in zip(rs, alpha, aps)]
            if k % 50 == 49:
                # Periodic re-projection kills drift into the nullspace.
                rs = project(rs)
            zs = project(m_apply(m_params, rs))
            rz_new = dot(rs, zs)
            beta = torch.where(rz != 0, rz_new / torch.where(rz != 0, rz, 1.0),
                               0.0)
            # Restart (p = z) on negative beta, as make_pcg.
            beta = scaled(torch.where(active & (beta > 0), beta, 0.0))
            ps = [z + bt * p for z, bt, p in zip(zs, beta, ps)]
            rz = rz_new
            rn = dot(rs, rs).sqrt()
            improved = rn < 0.97 * best
            best = torch.minimum(best, rn)
            stall = torch.where(improved, 0, stall + 1)
            k += 1
        rtrue = [b_ - y for b_, y in zip(bs, a_apply(a_params, xs))]
        x = sharding.gather_to(project(xs), mesh.devices[0], dim)
        return CGResult(x=x if dim == 0 else x.T, iterations=k,
                        residual_norms=dot(rtrue, rtrue).sqrt())

    return solve
