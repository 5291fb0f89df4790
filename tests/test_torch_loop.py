"""The CG loop (ops.cg's module doc): a prologue, one body per iteration
and an epilogue, a call run by one loop chosen by the devices: one
launch of one CUDA graph of the three parts when all of the state is on
one card, else the same prologue, the plain loop (`while go:
iteration`), which reads the continue test `go` on the host once an
iteration and once more, and the same epilogue.

On the CPU every solve takes the plain loop, so these tests hold its
logic; on a CUDA tensor the same parts run inside one launch of one
graph (tests/test_torch_cuda.py).

Gates:

* the loop is chosen from the device list: one CUDA card (a mesh whose
  devices are all that card included) takes the graph, the CPU and a
  mesh over several cards the plain loop;
* the plain loop's answer, host_reads == iterations + 1 and
  graph_calls == 0: make_pcg
  in the (N, R) layout (ELL operator, AMG cycle, f64) and the (R, N)
  layout (DIA operator and cycle, f32, stall window) against the JAX
  package's make_pcg / make_pcg_t, make_pcg_sharded on Mesh(["cpu"] *
  4) in both layouts against the port's one-device solve, and
  solve_sweep;
* a stop exactly at maxiter, a stall exit at the JAX solver's iteration
  and a Jacobi solve of several hundred iterations that re-projects at
  every k % 50 == 49 and nowhere else;
* the escalated f64 solver of the ELL route converges, and no stats key
  names a dispatch cap;
* DiaBorderedSolver and solve_bordered against the JAX package's at its
  dispatch_cap=10 (its chunked `stateful` path): the same CG iterations
  and passes, potentials within 1e-9 V (the JAX path counts k from 0 in
  each dispatch, so it re-projects at no cap below 50; no pass on these
  grids reaches 50 iterations, so the two runs are the same sequence);
* the plain loop on a toy iteration: no iteration when go is false on
  entry, a stop where go turns false and at kmax, the re-projection on
  the device k;
* the launch accounting a graph uses: launches counted under a
  recording (a capture) count nothing until each recount, once per
  iteration a launch of the graph ran;
* a call runs its prologue and its epilogue once, the body once an
  iteration, all three the _Loop's own functions; two calls on one
  solver take their own b, tol and maxiter (device scalars beside b, in
  its dtype), as fresh solvers do; DiaBorderedSolver.counters() carries
  graph_calls, 0 on the plain loop;
* a source guard: no host read (bool, int, float, .item(), .cpu(),
  .tolist(), .numpy()) inside the prologues, bodies and epilogues of
  ops/cg.py and the helpers the graph captures.

The graphs on the card are held by tests/test_torch_cuda.py (bit-equal
to the plain loop on the same CUDA tensors in every layout and
projector; calls with other b, tol and maxiter on one graph; answers
that survive the next call and the R = m + 1 graph's release; launches
counted; one launch and one read a call; zero iterations on a converged
start; L1's count; a host read in the body raises) and, with the
benchmark's traced runs, by pdnbench/test_pdnbench_card.py.
"""

import ast
import collections
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from padne_tpu import sweep as jsweep
from padne_tpu.ops import amg as jamg
from padne_tpu.ops import cg as jcg
from padne_tpu.ops import dia as jdia
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


def close(x, x_ref, rel):
    x, x_ref = np.asarray(x), np.asarray(x_ref)
    assert x.shape == x_ref.shape
    assert np.abs(x - x_ref).max() <= rel * np.abs(x_ref).max()


def ell_case(precond=True, p=2, side=24, stall_window=None,
             dtype=torch.float64):
    """make_pcg in (N, R) over the ELL operator of p grid islands, the
    AMG cycle (or Jacobi), a seeded (N, 3) right-hand side, and the JAX
    package's make_pcg over the same operator (its `jax(b, tol,
    maxiter)`)."""
    ell, comp_id = _grid_islands(p, side, seed=p)
    tell = port_ell(ell)
    vc = jvc = None
    if precond:
        vc = amg.make_vcycle(amg.build_hierarchy(tell), "cpu")
        vc = amg.vcycle_as(vc, dtype) if dtype != torch.float64 else vc
        jvc = jamg.make_vcycle(jamg.build_hierarchy(ell))
    solve = cg.make_pcg(tell.to_device("cpu", torch.float64).to(dtype),
                        torch.from_numpy(comp_id), p, precond=vc,
                        stall_window=stall_window)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jsolve = jcg.make_pcg(*ell.to_device(jdt), jnp.asarray(comp_id), p,
                          precond=jvc, stall_window=stall_window)
    b = np.random.default_rng(5).standard_normal((len(ell.diag), 3))

    def jax(bt, tol, maxiter):
        return jsolve(jnp.asarray(bt.numpy()), tol, maxiter)

    return solve, torch.from_numpy(b).to(dtype), jax


def dia_case():
    """make_pcg in (R, N) over a DIA hierarchy's f32 operator and cycle,
    stall window 30, as DiaBorderedSolver builds it, and the JAX
    make_pcg_t over the same grid."""
    ell, coords = grid_laplacian(48, seed=4)
    h = amg.build_hierarchy_dia(port_ell(ell), coords, coarse_size=100,
                                max_offsets=4)
    comp = np.ones(h.np0, dtype=np.int64)
    comp[h.posmap0] = 0
    meta0 = h.levels[0].pack.meta
    solve = cg.make_pcg(
        None, torch.from_numpy(comp), 2,
        operator=(lambda p, xt: dia.dia_matvec_t(meta0, p, xt),
                  amg.make_dia_cg_operator(h, "cpu")),
        precond=amg.make_vcycle_dia_t(h, "cpu", w_levels=0),
        stall_window=30, dim=1)
    b = np.zeros((h.np0, 3), np.float32)
    b[h.posmap0] = np.random.default_rng(11).standard_normal(
        (len(h.posmap0), 3))

    def jax(bt, tol, maxiter):
        jh = jamg.build_hierarchy_dia(ell, coords, coarse_size=100,
                                      max_offsets=4)
        jop = jamg.make_dia_cg_operator(jh, slots=8)
        jvc = jamg.make_vcycle_dia_t(jh, backend="xla", w0=jop["w"])
        jmeta = jh.levels[0].pack.meta
        jsolve = jcg.make_pcg_t(
            operator=(lambda p, xt: jdia.dia_matvec_t(jmeta, p, xt,
                                                      backend="xla"), jop),
            precond=jvc, comp_id=jnp.asarray(comp), num_components=2)
        return jsolve(jnp.asarray(bt.numpy()), tol, maxiter)

    return solve, torch.from_numpy(b), jax


def sharded_case(dim):
    """make_pcg_sharded on 4 CPU shards: a chain Laplacian of two
    components, K3' shard operators, Jacobi; and the port's one-device
    make_pcg of the same chain (its `ref(b, tol, maxiter)`)."""
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
        dim=dim)
    one = cg.make_pcg(ell.to_device("cpu", torch.float64), comp_id, 2)
    return solve, torch.from_numpy(rng.standard_normal((n, 3))), one


CASES = {
    "ell": ell_case,
    "dia": dia_case,
    "sharded_rows": lambda: sharded_case(0),
    "sharded_cols": lambda: sharded_case(1),
}
TOLS = {"ell": 1e-10, "dia": 1e-5, "sharded_rows": 1e-10,
        "sharded_cols": 1e-10}


@pytest.mark.parametrize("devices,graph", [
    (["cuda"], True), (["cuda:0"], True), (["cuda:0"] * 4, True),
    (["cuda:0", "cuda:1"], False), (["cpu"], False), (["cpu"] * 4, False)])
def test_the_loop_is_chosen_by_device(devices, graph):
    """One CUDA card (a mesh whose devices are all that card included)
    takes the WHILE graph; the CPU and a mesh over two cards, which one
    graph cannot span, the plain loop.  Decided from the device list:
    no CUDA needed."""
    assert cg.one_card(devices) is graph


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_loop_matches_the_reference(case):
    """The plain loop reads go once an iteration and once more; its
    answer is the JAX solver's of the same layout (ELL: iterations
    within one, x within 1e-9 of max|x|; DIA in f32: within one, x
    within 20 tol), and for the sharded layouts the port's one-device
    solve's (the same iterations, x within 1e-12)."""
    solve, b, ref = CASES[case]()
    tol = TOLS[case]
    got = solve(b, tol, 500)
    assert got.iterations > 7 and got.host_reads == got.iterations + 1
    assert got.graph_calls == 0
    assert not solve.loop.graphs
    want = ref(b, tol, 500)
    if case.startswith("sharded"):
        assert got.iterations == want.iterations
        close(got.x, want.x, 1e-12)
    else:
        assert abs(got.iterations - int(want.iterations)) <= 1
        close(got.x, want.x, 1e-9 if case == "ell" else 20 * tol)


def test_a_stop_exactly_at_maxiter():
    """Jacobi to an unreachable tolerance stops at maxiter: 23
    iterations, 24 reads, x within 1e-9 of the JAX solver's after its
    23."""
    solve, b, jax = ell_case(precond=False)
    got = solve(b, 1e-12, 23)
    assert (got.iterations, got.host_reads) == (23, 24)
    want = jax(b, 1e-12, 23)
    assert int(want.iterations) == 23
    close(got.x, want.x, 1e-9)


def test_stall_exit_at_the_jax_iteration():
    """An f32 Jacobi solve to an unreachable tolerance on one 40 x 40
    island stops on its stall window at a plateau of CG's residual,
    above f32's rounding floor, at the JAX solver's iteration (67)."""
    solve, b, jax = ell_case(precond=False, p=1, side=40, stall_window=4,
                             dtype=torch.float32)
    got = solve(b, 1e-12, 5000)
    assert 0 < got.iterations < 5000
    assert got.host_reads == got.iterations + 1
    assert got.iterations == int(jax(b, 1e-12, 5000).iterations)


def test_reprojection_every_50_iterations(monkeypatch):
    """Jacobi on one 40 x 40 island: hundreds of iterations, the
    re-projection taken at every device k of 49 mod 50 and at no
    other; the JAX solver's iterations and x (within 1e-9)."""
    taken = []
    real = cg._periodic_gated

    def recording(fn, v, k):
        out = real(fn, v, k)
        taken.append((int(k), not torch.equal(out, v)))
        return out

    monkeypatch.setattr(cg, "_periodic_gated", recording)
    solve, b, jax = ell_case(precond=False, p=1, side=40)
    got = solve(b, 1e-10, 5000)
    assert got.iterations > 150
    assert [k for k, _ in taken] == list(range(got.iterations))
    assert [k for k, t in taken if t] == [
        k for k in range(got.iterations) if k % 50 == 49]
    want = jax(b, 1e-10, 5000)
    assert abs(got.iterations - int(want.iterations)) <= 1
    close(got.x, want.x, 1e-9)


def test_sweep_host_reads():
    """The sweep's one CG runs the plain loop on the CPU: one read an
    iteration and one more, no graph, no stats key of a cap."""
    specs = [sweep.SweepSpec(*x) for x in SPECS]
    stats = {}
    sweep.solve_sweep(port_strip_problem("voltage"), specs, device="cpu",
                      stats=stats)
    assert stats["cg_iterations"] > 7
    assert stats["host_reads"] == stats["cg_iterations"] + 1
    assert stats["capture_s"] == 0.0
    assert not [k for k in stats if "cap" in k and k != "capture_s"]


def test_the_escalated_solver_converges(monkeypatch):
    """max_refinements=0 escalates the ELL route after its first f32
    pass: its f64 solver is built and converges; the stats name no
    dispatch cap."""
    system = convert.core_system_from_numpy(make_system(g=40, seed=1))
    dtypes = []
    real = cg.make_pcg

    def recording(a, *args, **kw):
        dtypes.append(a.val.dtype)
        return real(a, *args, **kw)

    monkeypatch.setattr(cg, "make_pcg", recording)
    stats = {}
    sol = schur.solve_bordered(system, inner_dtype=torch.float32,
                               device="cpu", operator="ell", precond="amg",
                               max_refinements=0, stats=stats)
    assert stats["escalated"]
    assert dtypes == [torch.float32, torch.float64]
    assert sol.residual_norm < 1e-9
    assert not [k for k in stats if "cap" in k and k != "capture_s"]


def test_the_plain_loop_runs_on_the_cpu():
    solve, b, _ = ell_case()
    res = solve(b, 1e-10, 500)
    assert res.host_reads == res.iterations + 1
    assert not solve.loop.graphs and solve.loop.capture_s == 0.0


@pytest.mark.parametrize("case", ["ell", "dia", "sharded_cols"])
def test_a_call_runs_one_prologue_and_one_epilogue(case):
    """The plain loop runs a call of the parts the card's graph captures:
    the _Loop's own prologue once, its body once an iteration and its
    epilogue once; the answer is the unwrapped solver's, bit for bit."""
    solve, b, _ = CASES[case]()
    tol = TOLS[case]
    want = solve(b, tol, 500)
    loop, calls = solve.loop, collections.Counter()

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    for name in ("prologue", "body", "epilogue"):
        setattr(loop, name, counted(name, getattr(loop, name)))
    got = solve(b, tol, 500)
    assert calls == {"prologue": 1, "body": got.iterations, "epilogue": 1}
    assert (got.iterations, got.host_reads) == (want.iterations,
                                                want.host_reads)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.residual_norms, want.residual_norms)


@pytest.mark.parametrize("case", ["ell", "dia"])
def test_calls_on_one_solver_take_their_own_inputs(case):
    """Two calls on one solver, the second with another b, a 10x tol and
    maxiter 3, equal the same calls on fresh solvers: nothing of a call
    is kept for the next."""
    solve, b, _ = CASES[case]()
    tol = TOLS[case]
    calls = [(b, tol, 500), (3 * b.flip(0), 10 * tol, 3)]
    got = [solve(*call) for call in calls]
    assert got[1].iterations == 3
    for call, g in zip(calls, got):
        want = CASES[case]()[0](*call)
        assert (g.iterations, g.host_reads) == (want.iterations,
                                                want.host_reads)
        assert torch.equal(g.x, want.x)
        assert torch.equal(g.residual_norms, want.residual_norms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tol_and_maxiter_enter_as_device_scalars(dtype):
    """A call's tol and maxiter are 0-dim tensors beside b (the first
    shard's device; tol in b's dtype, maxiter int64), what the card's
    graph reads from buffers the host writes before each launch."""
    b = torch.ones(6, 2, dtype=dtype)
    for bs in (b, [b[:3], b[3:]]):
        i = cg._inputs(bs, 1e-5, 7)
        assert i.b is bs
        assert (i.tol.shape, i.tol.dtype, i.tol.device) == (
            (), dtype, b.device)
        assert torch.equal(i.tol, torch.tensor(1e-5, dtype=dtype))
        assert (i.kmax.shape, i.kmax.dtype, int(i.kmax)) == (
            (), torch.int64, 7)


@pytest.fixture(scope="module")
def dia_pair():
    """The JAX DiaBorderedSolver of one grid system at dispatch_cap=10,
    coarse size 200 (3 levels), and its solution."""
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
                                device="cpu", coarse_size=200)
    got = s.solve(target_residual=1e-10)
    assert got.residual_norm < 1e-10
    assert got.cg_iterations == want.cg_iterations
    assert got.refinement_steps == want.refinement_steps
    assert np.abs(got.v - want.v).max() < 1e-9
    # The plain loop: one read an iteration and one more a pass.
    passes = got.refinement_steps + 1
    assert s.host_reads == got.cg_iterations + passes
    assert s.counters()["graph_calls"] == 0


def test_solve_bordered_at_cap_10_matches_jax():
    jsystem = make_system(g=48, with_regulator=True, seed=2)
    want = jschur.solve_bordered(jsystem, device_dtype=jnp.float32,
                                 precond="amg", dispatch_cap=10)
    stats = {}
    got = schur.solve_bordered(convert.core_system_from_numpy(jsystem),
                               inner_dtype=torch.float32, device="cpu",
                               precond="amg", stats=stats)
    assert stats["route"] == "ell"
    assert got.residual_norm < 1e-9
    assert got.cg_iterations == want.cg_iterations
    assert got.refinement_steps == want.refinement_steps
    assert np.abs(got.v - want.v).max() < 1e-9
    assert stats["host_reads"] == got.cg_iterations + got.refinement_steps + 1


def test_sweep_matches_jax():
    """The port's sweep (the plain loop) against the JAX sweep (one
    while_loop)."""
    specs = [(1.0, 1.0), (2.0, 3.3)]
    want = jsweep.solve_sweep(make_strip_problem(),
                              [jsweep.SweepSpec(*x) for x in specs])
    got = sweep.solve_sweep(port_strip_problem("voltage"),
                            [sweep.SweepSpec(*x) for x in specs],
                            device="cpu")
    for g, w in zip(got, want):
        assert np.abs(g.v - w.v).max() <= 1e-9


# The functions of the parts the graph captures: the prologues, the
# bodies, the epilogues, the in-place write and the periodic step on the
# device k.
GRAPH_FUNCTIONS = ("prologue", "body", "epilogue", "_iteration",
                   "_copy_into", "_leaves", "_periodic_gated", "_where",
                   "_go")


def _body_functions():
    tree = ast.parse((REPO / "padne_tpu_torch/ops/cg.py").read_text())
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.FunctionDef)
            and node.name in GRAPH_FUNCTIONS]


HOST_READS = {"bool", "int", "float"}
HOST_METHODS = {"item", "cpu", "tolist", "numpy"}


def test_no_host_read_inside_the_body():
    bodies = _body_functions()
    # make_pcg's and make_pcg_sharded's prologues, bodies and epilogues,
    # and the helpers.
    assert len(bodies) == len(GRAPH_FUNCTIONS) + 3
    # The prologues take the call's inputs alone, the bodies the state
    # and the constants (no periodic hook), the epilogues the state and
    # the projected b.
    args = {"prologue": [["i"]], "body": [["s", "c"]],
            "epilogue": [["s", "bp"], ["s", "bs"]]}
    for fn in bodies:
        if fn.name in args:
            assert [a.arg for a in fn.args.args] in args[fn.name]
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


def _toy_body(s, c):
    """x + 1 an iteration, times 10 where the re-projection would run;
    go while k < kmax and x below the target (its "convergence")."""
    x = cg._periodic_gated(lambda v: v * 10, s.x + 1, s.k)
    k = s.k + 1
    return s._replace(x=x, k=k, go=(k < c.kmax) & (x < c.target))


def test_the_plain_loop_stops_at_convergence_and_at_maxiter():
    """The plain loop (L1's WHILE loop off the card) writes over the
    state in place and returns (k, host reads): no iteration when go is
    false on entry; a stop where go turns false; a stop at kmax; the
    periodic step where the device count is 49 mod 50."""
    s, c = _toy(0.0, 100)
    s.go.fill_(False)
    before = [t.clone() for t in s]
    assert cg._dispatch_plain(_toy_body, s, c) == (0, 1)
    assert all(torch.equal(a, b) for a, b in zip(s, before))
    # Converged: x reaches the target 5 at k = 5.
    s, c = _toy(0.0, 100, target=5.0)
    assert cg._dispatch_plain(_toy_body, s, c) == (5, 6)
    assert (float(s.x), bool(s.go)) == (5.0, False)
    # At kmax: go false.
    s, c = _toy(0.0, 4)
    assert cg._dispatch_plain(_toy_body, s, c) == (4, 5)
    assert (float(s.x), bool(s.go)) == (4.0, False)
    # 49 steps, then (49 + 1) * 10, then 10 more.
    s, c = _toy(0.0, 60)
    assert cg._dispatch_plain(_toy_body, s, c) == (60, 61)
    assert float(s.x) == 510.0


def test_a_recording_counts_at_each_recount():
    """The accounting of a CUDA graph (ops.cg._Graph): the launches a
    capture records count nothing; a launch of the graph counts them
    once per iteration it ran, with their operands' shapes (as meta
    tensors) passed to the hooks."""
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
        # A launch that ran 4 iterations, and one that ran none.
        kernels.recount(tape, 4)
        kernels.recount(tape, 0)
    finally:
        kernels.HOOKS.remove(hook)
    assert wrapper.launches == 15
    assert seen == [((2, 3), "cpu", "eager")] + 7 * [
        ((4, 1), "meta", "captured"), ((5, 1), "meta", "captured")]
    kernels.count(wrapper, torch.ones(1), None)
    assert wrapper.launches == 16 and len(seen) == 15
