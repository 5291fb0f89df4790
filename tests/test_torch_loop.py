"""The CG loop's dispatches (ops.cg's module doc): init, one body per
iteration and finish, the iterations run in dispatches of at most
`dispatch_cap` that stop at convergence, with the continue test `go`
read on the host once per dispatch.

On the CPU a dispatch is its plain version (`while go and k < kstop`),
so these tests hold the dispatch logic; on a CUDA tensor each dispatch
is one launch of a CUDA WHILE graph around the same iteration.

Gates:

* at caps 1, 7, 30 and one above the iteration count the dispatched
  solve is bit-equal to the host loop (dispatch_cap None on the CPU;
  torch.equal on x and the residual norms, the same iterations):
  make_pcg in the (N, R) layout (ELL operator, AMG cycle, f64) and the
  (R, N) layout (DIA operator and cycle, f32, stall window),
  make_pcg_sharded on Mesh(["cpu"] * 4) in both layouts, and
  solve_sweep (every spec's v and j);
* maxiter not a multiple of the cap, a stall exit inside a dispatch and
  a Jacobi solve of several hundred iterations (the re-projection at
  k % 50 == 49 inside dispatches and across their boundaries):
  bit-equal;
* one host read a dispatch: max(1, ceil(iterations / cap)); the host
  loop reads once an iteration and once more;
* "auto" and None are one dispatch to maxiter on one card and the host
  loop on the CPU; the escalation's cap is max(30, cap // 8) of an int
  cap, and the ELL route's f64 solver is built with it;
* DiaBorderedSolver and solve_bordered at dispatch_cap=10 against the
  JAX package's at dispatch_cap=10 (its chunked `stateful` path): the
  same CG iterations and passes, potentials within 1e-9 V (the JAX
  path counts k from 0 in each dispatch, so it re-projects at no cap
  below 50; no pass on these grids reaches 50 iterations, so the two
  runs are the same sequence);
* a dispatch stops at convergence and at its cap: no iteration when go
  is false on entry, k equal to the host loop's when go turns false
  mid-dispatch, a stop at kstop and at kmax; the re-projection follows
  the device k;
* the launch accounting a graph uses: launches counted under a
  recording (a capture) count nothing until each recount, once per
  iteration a dispatch ran;
* a source guard: no host read (bool, int, float, .item(), .cpu(),
  .tolist(), .numpy()) inside the body functions of ops/cg.py and the
  iteration a dispatch captures.

The WHILE graphs on the card are held by tests/test_torch_cuda.py (bit-
equal to the host loop; zero iterations on a converged start; L1's
count; the R = m + 1 graph released; a host read in the body raises)
and by chip_smoke.py's phase loop.
"""

import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padne_tpu import sweep as jsweep
from padne_tpu.ops import schur as jschur
from padne_tpu_torch import convert, sweep
from padne_tpu_torch.ops import amg, assembly, cg, dia, schur, spmv
from padne_tpu_torch.parallel import sharding

from tests.test_amg_dia import grid_laplacian
from tests.test_schur_dia import make_system
from tests.test_sweep import make_strip_problem
from tests.test_torch_cg import _grid_islands
from tests.test_torch_sweep import SPECS, port_strip_problem

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def port_ell(jell):
    return assembly.EllMatrix(cols=jell.cols, vals=jell.vals, diag=jell.diag)


def same(a: cg.CGResult, b: cg.CGResult) -> bool:
    return (a.iterations == b.iterations and torch.equal(a.x, b.x)
            and torch.equal(a.residual_norms, b.residual_norms))


def reads_of(k: int, cap) -> int:
    return k + 1 if cap is None else max(1, math.ceil(k / cap))


def ell_solver(cap, precond=True, p=2, side=24, stall_window=None,
               dtype=torch.float64):
    """make_pcg in (N, R) over the ELL operator of p grid islands, the
    AMG cycle (or Jacobi), and a seeded (N, 3) right-hand side."""
    ell, comp_id = _grid_islands(p, side, seed=p)
    tell = port_ell(ell)
    vc = None
    if precond:
        vc = amg.make_vcycle(amg.build_hierarchy(tell), "cpu")
        vc = amg.vcycle_as(vc, dtype) if dtype != torch.float64 else vc
    solve = cg.make_pcg(tell.to_device("cpu", torch.float64).to(dtype),
                        torch.from_numpy(comp_id), p, precond=vc,
                        stall_window=stall_window, dispatch_cap=cap)
    b = np.random.default_rng(5).standard_normal((len(ell.diag), 3))
    return solve, torch.from_numpy(b).to(dtype)


def dia_solver(cap):
    """make_pcg in (R, N) over a DIA hierarchy's f32 operator and cycle,
    stall window 30, as DiaBorderedSolver builds it."""
    ell, coords = grid_laplacian(48, seed=4)
    h = amg.build_hierarchy_dia(port_ell(ell), coords, coarse_size=100)
    comp = np.ones(h.np0, dtype=np.int64)
    comp[h.posmap0] = 0
    meta0 = h.levels[0].pack.meta
    solve = cg.make_pcg(
        None, torch.from_numpy(comp), 2,
        operator=(lambda p, xt: dia.dia_matvec_t(meta0, p, xt),
                  amg.make_dia_cg_operator(h, "cpu")),
        precond=amg.make_vcycle_dia_t(h, "cpu", w_levels=0),
        stall_window=30, dim=1, dispatch_cap=cap)
    b = np.zeros((h.np0, 3), np.float32)
    b[h.posmap0] = np.random.default_rng(11).standard_normal(
        (len(h.posmap0), 3))
    return solve, torch.from_numpy(b)


def sharded_solver(cap, dim):
    """make_pcg_sharded on 4 CPU shards: a chain Laplacian of two
    components, K3' shard operators, Jacobi."""
    rng = np.random.default_rng(0)
    n = 64
    edges = np.array([(i, i + 1) for i in range(n - 1) if i != n // 2 - 1])
    ell = assembly.build_ell(n, edges, rng.uniform(0.5, 2.0, len(edges)))
    comp_id = torch.from_numpy((np.arange(n) >= n // 2).astype(np.int64))
    mesh = sharding.Mesh(["cpu"] * 4)
    ops = amg.shard_ell_rows(ell.cols, ell.vals, ell.diag, n, n, mesh,
                             torch.float64)

    def matvec(prm, xs):
        full = sharding.all_gather(mesh, [x if dim == 0 else x.T
                                          for x in xs], dim=0)
        ys = [spmv.ell_spmv(op, xf) for op, xf in zip(prm, full)]
        return ys if dim == 0 else [y.T.contiguous() for y in ys]

    solve = cg.make_pcg_sharded(
        mesh, (matvec, ops), comp_id, 2,
        cg.jacobi_sharded(sharding.split(mesh, torch.from_numpy(ell.diag),
                                         0), dim=dim),
        dim=dim, dispatch_cap=cap)
    return solve, torch.from_numpy(rng.standard_normal((n, 3)))


CASES = {
    "ell": lambda cap: ell_solver(cap),
    "dia": dia_solver,
    "sharded_rows": lambda cap: sharded_solver(cap, 0),
    "sharded_cols": lambda cap: sharded_solver(cap, 1),
}
TOLS = {"ell": 1e-10, "dia": 1e-5, "sharded_rows": 1e-10,
        "sharded_cols": 1e-10}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_are_bit_equal_to_the_host_loop(case):
    solve, b = CASES[case](None)
    want = solve(b, TOLS[case], 500)
    assert want.iterations > 7 and want.host_reads == want.iterations + 1
    for cap in (1, 7, 30, want.iterations + 1):
        chunked, _ = CASES[case](cap)
        got = chunked(b, TOLS[case], 500)
        assert same(got, want), (case, cap, got.iterations, want.iterations)
        assert got.host_reads == reads_of(want.iterations, cap)


def test_maxiter_not_a_multiple_of_the_cap():
    solve, b = ell_solver(None, precond=False)
    want = solve(b, 1e-12, 23)
    assert want.iterations == 23
    got = ell_solver(7, precond=False)[0](b, 1e-12, 23)
    assert same(got, want) and got.host_reads == 4


def test_stall_exit_inside_a_chunk():
    """An f32 solve to an unreachable tolerance stops on its stall
    window, mid-chunk, at the host loop's iteration."""
    kw = dict(precond=False, stall_window=4, dtype=torch.float32)
    solve, b = ell_solver(None, **kw)
    want = solve(b, 1e-12, 5000)
    assert 0 < want.iterations < 5000
    for cap in (7, 30):
        got = ell_solver(cap, **kw)[0](b, 1e-12, 5000)
        assert want.iterations % cap
        assert same(got, want)


def test_reprojection_across_chunk_boundaries():
    """Jacobi on one 40 x 40 island: hundreds of iterations, so the
    re-projection at k % 50 == 49 falls inside chunks of 7 and 30 and
    on the last iteration of chunks of 25 and 50."""
    kw = dict(precond=False, p=1, side=40)
    solve, b = ell_solver(None, **kw)
    want = solve(b, 1e-10, 5000)
    assert want.iterations > 150
    for cap in (7, 25, 30, 50):
        got = ell_solver(cap, **kw)[0](b, 1e-10, 5000)
        assert same(got, want), cap
        assert got.host_reads == reads_of(want.iterations, cap)


def test_sweep_chunks_are_bit_equal():
    specs = [sweep.SweepSpec(*x) for x in SPECS]
    prob = port_strip_problem("voltage")
    runs = []
    for cap in (None, 1, 7):
        stats = {}
        runs.append((sweep.solve_sweep(prob, specs, device="cpu",
                                       stats=stats, dispatch_cap=cap),
                     stats))
    (want, wstats) = runs[0]
    assert wstats["cg_iterations"] > 7
    assert wstats["host_reads"] == wstats["cg_iterations"] + 1
    for (got, stats), cap in zip(runs[1:], (1, 7)):
        assert stats["cg_iterations"] == wstats["cg_iterations"]
        assert stats["host_reads"] == reads_of(wstats["cg_iterations"], cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.v, w.v)
            np.testing.assert_array_equal(g.j, w.j)
            assert g.residual_norm == w.residual_norm


def test_dispatch_cap_rules():
    # "auto" and None: one dispatch to maxiter on one card (a mesh of
    # that card included), the host loop on the CPU; "auto" is the host
    # loop on several cards too, where None and an int raise.
    host = cg._HOST_LOOP
    assert cg.resolve_dispatch_cap("auto", ["cpu"]) == host
    assert cg.resolve_dispatch_cap(None, ["cpu"] * 4) == host
    assert cg.resolve_dispatch_cap("auto", ["cuda:0"]) is None
    assert cg.resolve_dispatch_cap("auto", ["cuda:0"] * 4) is None
    assert cg.resolve_dispatch_cap(None, ["cuda:0"]) is None
    assert cg.resolve_dispatch_cap(1, ["cuda:0"]) == 1
    assert cg.resolve_dispatch_cap("auto", ["cuda:0", "cuda:1"]) == host
    # The private hook: the host loop on the card.
    assert cg.resolve_dispatch_cap(host, ["cuda:0"]) == host
    assert cg.resolve_dispatch_cap(7, ["cpu"] * 4) == 7
    for bad in (0, -3, 2.5, True, "8"):
        with pytest.raises(ValueError):
            cg.resolve_dispatch_cap(bad, ["cpu"])
    for bad in (7, None):
        with pytest.raises(ValueError):
            cg.resolve_dispatch_cap(bad, ["cuda:0", "cuda:1"])
    # The escalation to f64 (padne_tpu/ops/schur.py:472-475) of an int
    # cap; "auto" and None stay.
    assert cg.escalated_cap(None) is None
    assert cg.escalated_cap("auto") == "auto"
    assert cg.escalated_cap(host) == host
    assert cg.escalated_cap(10) == 30
    assert cg.escalated_cap(400) == 50


def test_escalation_takes_the_escalated_cap(monkeypatch):
    """The ELL route's escalation builds its f64 solver with
    max(30, cap // 8); max_refinements=0 escalates after the first
    f32 pass."""
    system = convert.core_system_from_numpy(make_system(g=40, seed=1))
    caps = []
    real = cg.make_pcg

    def recording(*args, **kw):
        caps.append((kw.get("precond") is None, kw["dispatch_cap"]))
        return real(*args, **kw)

    monkeypatch.setattr(cg, "make_pcg", recording)
    stats = {}
    sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                               device="cpu", operator="ell", precond="amg",
                               max_refinements=0, dispatch_cap=400,
                               stats=stats)
    assert stats["escalated"] and stats["dispatch_cap"] == 400
    assert [c for _, c in caps] == [400, 50]
    assert sol.residual_norm < 1e-9


def test_auto_is_the_host_loop_on_the_cpu():
    solve, b = ell_solver("auto")
    res = solve(b, 1e-10, 500)
    assert res.host_reads == res.iterations + 1
    assert not solve.loop.graphs


@pytest.fixture(scope="module")
def dia_pair():
    """The JAX and port DiaBorderedSolver of one grid system, both at
    dispatch_cap=10, coarse size 200 (3 levels)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PADNE_TPU_COARSE_SIZE", "200")
    try:
        jsystem = make_system(g=64, with_regulator=True, seed=3)
        want = jschur.DiaBorderedSolver(jsystem, dispatch_cap=10).solve(
            target_residual=1e-10)
    finally:
        mp.undo()
    return jsystem, want


def test_dia_solver_at_cap_10_matches_jax(dia_pair):
    jsystem, want = dia_pair
    s = schur.DiaBorderedSolver(convert.core_system_from_numpy(jsystem),
                                device="cpu", coarse_size=200,
                                dispatch_cap=10)
    assert s.dispatch_cap == 10
    got = s.solve(target_residual=1e-10)
    assert got.residual_norm < 1e-10
    assert got.cg_iterations == want.cg_iterations
    assert got.refinement_steps == want.refinement_steps
    assert np.abs(got.v - want.v).max() < 1e-9
    # One read a dispatch: at most ceil(iterations / 10) + 1 a pass.
    passes = got.refinement_steps + 1
    assert s.host_reads <= got.cg_iterations // 10 + 2 * passes
    # The same solver at the host loop: the same bits.
    host = schur.DiaBorderedSolver(convert.core_system_from_numpy(jsystem),
                                   device="cpu", coarse_size=200,
                                   dispatch_cap=None)
    again = host.solve(target_residual=1e-10)
    np.testing.assert_array_equal(again.v, got.v)
    assert host.host_reads == again.cg_iterations + passes


def test_solve_bordered_at_cap_10_matches_jax():
    jsystem = make_system(g=48, with_regulator=True, seed=2)
    want = jschur.solve_bordered(jsystem, device_dtype=jnp.float32,
                                 precond="amg", dispatch_cap=10)
    stats = {}
    got = schur.solve_bordered(convert.core_system_from_numpy(jsystem),
                               inner_dtype=torch.float32, device="cpu",
                               precond="amg", dispatch_cap=10, stats=stats)
    assert stats["route"] == "ell" and stats["dispatch_cap"] == 10
    assert got.residual_norm < 1e-9
    assert got.cg_iterations == want.cg_iterations
    assert got.refinement_steps == want.refinement_steps
    assert np.abs(got.v - want.v).max() < 1e-9


def test_sweep_at_cap_matches_jax():
    """The port's chunked sweep against the JAX sweep (one while_loop)."""
    specs = [(1.0, 1.0), (2.0, 3.3)]
    want = jsweep.solve_sweep(make_strip_problem(),
                              [jsweep.SweepSpec(*x) for x in specs])
    got = sweep.solve_sweep(port_strip_problem("voltage"),
                            [sweep.SweepSpec(*x) for x in specs],
                            device="cpu", dispatch_cap=7)
    for g, w in zip(got, want):
        assert np.abs(g.v - w.v).max() <= 1e-9


# The functions of the iteration a dispatch captures: the bodies, the
# in-place write and the periodic step on the device k.
GRAPH_FUNCTIONS = ("body", "_iteration", "_copy_into", "_leaves",
                   "_periodic_gated", "_where", "_go")


def _body_functions():
    tree = ast.parse((REPO / "padne_tpu_torch/ops/cg.py").read_text())
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)
            and node.name in GRAPH_FUNCTIONS]


HOST_READS = {"bool", "int", "float"}
HOST_METHODS = {"item", "cpu", "tolist", "numpy"}


def test_no_host_read_inside_the_body():
    bodies = _body_functions()
    # make_pcg's and make_pcg_sharded's bodies and the helpers.
    assert len(bodies) == len(GRAPH_FUNCTIONS) + 1
    found = []
    for fn in bodies:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if ((isinstance(f, ast.Name) and f.id in HOST_READS)
                    or (isinstance(f, ast.Attribute)
                        and f.attr in HOST_METHODS)):
                found.append((fn.lineno, node.lineno, ast.unparse(f)))
    assert not found, found


def _toy(x0, kmax, target=1e9):
    """A _State of scalars for a toy body, and its constants."""
    z = torch.zeros(())
    k = torch.zeros((), dtype=torch.int64)
    return (cg._State(x=torch.tensor(x0), r=z, p=z, rz=z, rn=z, best=z,
                      stall=torch.zeros((), dtype=torch.int32), k=k,
                      go=torch.ones((), dtype=torch.bool)),
            cg._Consts(target=torch.tensor(target), kmax=torch.tensor(kmax)))


def _toy_body(s, c, periodic):
    """x + 1 an iteration, times 10 where the re-projection would run;
    go while k < kmax and x below the target (its "convergence")."""
    x = periodic(lambda v: v * 10, s.x + 1, s.k)
    k = s.k + 1
    return s._replace(x=x, k=k, go=(k < c.kmax) & (x < c.target))


def _toy_host_loop(s, c):
    """The host loop's count of the toy: iterations while go."""
    k = 0
    while bool(s.go):
        s = _toy_body(s, c, cg._on_host(k))
        k += 1
    return s, k


def test_a_dispatch_stops_at_convergence_and_at_its_cap():
    """The plain dispatch (L1's WHILE loop on the card) writes over the
    state in place and returns (go, k): no iteration when go is false on
    entry; a stop mid-dispatch where go turns false, at the host loop's
    k; a stop at kstop = k + cap with go still true; a stop at kmax; the
    periodic step where the device count is 49 mod 50."""
    s, c = _toy(0.0, 100)
    s.go.fill_(False)
    before = [t.clone() for t in s]
    assert cg._dispatch_plain(_toy_body, s, c, 5) == (False, 0)
    assert all(torch.equal(a, b) for a, b in zip(s, before))
    # Converged mid-dispatch: x reaches the target 5 at k = 5 of 8.
    want = _toy_host_loop(*_toy(0.0, 100, target=5.0))
    s, c = _toy(0.0, 100, target=5.0)
    assert cg._dispatch_plain(_toy_body, s, c, 8) == (False, 5)
    assert want[1] == 5 and float(s.x) == float(want[0].x) == 5.0
    # At kstop: 3 iterations, go still true; the next dispatch goes on.
    s, c = _toy(0.0, 100)
    assert cg._dispatch_plain(_toy_body, s, c, 3) == (True, 3)
    assert cg._dispatch_plain(_toy_body, s, c, 3) == (True, 6)
    assert (float(s.x), int(s.k)) == (6.0, 6)
    # At kmax inside a dispatch: go false.
    s, c = _toy(0.0, 4)
    assert cg._dispatch_plain(_toy_body, s, c, 10) == (False, 4)
    assert (float(s.x), bool(s.go)) == (4.0, False)
    # 49 steps, then (49 + 1) * 10, then 10 more.
    s, c = _toy(0.0, 100)
    assert cg._dispatch_plain(_toy_body, s, c, 60) == (True, 60)
    assert float(s.x) == 510.0


def test_a_recording_counts_at_each_recount():
    """The accounting of a CUDA graph (ops.cg._Graph): the launches a
    capture records count nothing; a dispatch counts them once per
    iteration it ran, with their operands' shapes (as meta tensors)
    passed to the hooks."""
    from padne_tpu_torch import kernels

    def wrapper():
        pass

    wrapper.launches = 0
    seen = []

    def hook(w, x, extra):
        if w is wrapper:
            seen.append((tuple(x.shape), x.device.type, extra))

    kernels.HOOKS.append(hook)
    try:
        kernels.count(wrapper, torch.ones(2, 3), "eager")
        with kernels.recording() as tape:
            kernels.count(wrapper, torch.ones(4, 1), "captured")
            kernels.count(wrapper, torch.ones(5, 1), "captured")
            with pytest.raises(RuntimeError):
                with kernels.recording():
                    pass
        assert wrapper.launches == 1 and len(tape) == 2
        for _ in range(3):
            kernels.recount(tape)
        # A dispatch that ran 4 iterations, and one that ran none.
        kernels.recount(tape, 4)
        kernels.recount(tape, 0)
    finally:
        kernels.HOOKS.remove(hook)
    assert wrapper.launches == 15
    assert seen == [((2, 3), "cpu", "eager")] + 7 * [
        ((4, 1), "meta", "captured"), ((5, 1), "meta", "captured")]
    kernels.count(wrapper, torch.ones(1), None)
    assert wrapper.launches == 16 and len(seen) == 15
