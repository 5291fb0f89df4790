"""Port parity for padne_tpu_torch.serve: the wire protocol against
padne_tpu.serve, the server on the CPU (a thread on a socket under
tmp_path, device="cpu"), DiaBorderedSolver.set_excitation, and the
dispatch of padne_tpu_torch.solver.solve.

Gates: a served solve within 1e-9 V of padne_tpu.serve's on the same
board and within 1e-6 V of spsolve; the cached re-solve with the
excitation doubled within 2e-6 V of twice the first; a solve after
set_excitation within 1e-9 V of a freshly built solver's.  The faults
of padne_tpu.serve are not copied: the cache evicts before it builds,
a second server does not take a live socket, the client refuses
another protocol version."""

import gc
import logging
import os
import socket
import threading
import weakref

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

from padne_tpu import kicad as jkicad
from padne_tpu import mesh as jmesh
from padne_tpu import serve as jserve
from padne_tpu import solver as jsolver
from padne_tpu_torch import kicad, mesh, serve, solver
from padne_tpu_torch.ops import schur

torch.set_num_threads(1)

COARSE = 200      # small enough for a DIA hierarchy on the strip board
MESH_SIZE = 0.25  # the strip at 1,828 core unknowns, two levels


@pytest.fixture(scope="module")
def strip(boards_dir):
    return boards_dir / "gen_strip" / "gen_strip.kicad_pro"


def port_system(pro, size=MESH_SIZE):
    prob = kicad.load_kicad_project(pro)
    return solver.build_system(prob, mesh.Mesher.Config(maximum_size=size))[0]


def jax_system(pro, size=MESH_SIZE):
    prob = jkicad.load_kicad_project(pro)
    return jsolver.build_system(
        prob, mesher_config=jmesh.Mesher.Config(maximum_size=size))[0]


def start(target, **kwargs):
    """Run a server function on a thread until it is listening."""
    ready = threading.Event()
    th = threading.Thread(target=target, daemon=True,
                          kwargs=dict(kwargs, ready_event=ready))
    th.start()
    assert ready.wait(30), "server did not come up"
    return th


def stop(th, sock, shutdown=serve.shutdown):
    """Shut the server on `sock` down and wait for its thread."""
    shutdown(sock)
    th.join(timeout=30)
    assert not th.is_alive(), "the server thread did not stop"


@pytest.fixture()
def server(tmp_path):
    sock = str(tmp_path / "serve.sock")
    th = start(serve.serve, socket_path=sock, max_requests=16,
               device="cpu", solver_kw={"coarse_size": COARSE})
    yield sock
    stop(th, sock)


def fake_server(sock, version=serve.PROTOCOL_VERSION, device="cpu",
                ready_event=None, kinds=None):
    """Answers pings as a server of `version` on `device` would and
    declines anything else, recording each request's kind, until it is
    told to shut down."""
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(4)
    ready_event.set()
    try:
        while True:
            conn, _ = srv.accept()
            with conn:
                kind = bytes(serve._unpack(serve._recv_frame(conn))
                             ["kind"]).decode()
                kinds.append(kind)
                if kind == "ping":
                    serve._send_frame(conn, serve._pack(
                        ok=np.int8(1), pid=np.int64(1),
                        version=np.int64(version),
                        backend=serve._text(device),
                        name=serve._text(device)))
                else:
                    ok = np.int8(kind == "shutdown")
                    serve._send_frame(conn, serve._pack(ok=ok))
                if kind == "shutdown":
                    return
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------
def assert_systems_equal(a, b):
    assert type(a) is schur.CoreSystem and type(b) is schur.CoreSystem
    assert (a.n, a.num_components, a.ground_var, a.border.m) == (
        b.n, b.num_components, b.ground_var, b.border.m)
    for x, y in ((a.ell.cols, b.ell.cols), (a.ell.vals, b.ell.vals),
                 (a.ell.diag, b.ell.diag), (a.comp_id, b.comp_id),
                 (a.r_core, b.r_core), (a.coords, b.coords),
                 (a.group, b.group)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    for key in ("row_idx", "row_node", "row_val", "col_idx", "col_node",
                "col_val", "rhs"):
        x, y = getattr(a.border, key), getattr(b.border, key)
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_npz_system_round_trip(strip):
    system = port_system(strip)
    back = serve._system_from_npz(
        serve._unpack(serve._pack(**serve._system_to_npz(system))))
    assert_systems_equal(back, system)


def test_structural_key_equals_the_jax_packages(strip):
    z = serve._system_to_npz(port_system(strip))
    assert serve._structural_key(z) == jserve._structural_key(
        jserve._system_to_npz(jax_system(strip)))
    # The excitation is not part of the key; the operator is.
    z2 = dict(z, r_core=z["r_core"] * 2.0, rhs=z["rhs"] * 2.0)
    assert serve._structural_key(z2) == serve._structural_key(z)
    z3 = dict(z, vals=z["vals"] * 1.5)
    assert serve._structural_key(z3) != serve._structural_key(z)


def test_jax_payload_decodes_into_a_port_system(strip):
    payload = jserve._pack(**jserve._system_to_npz(jax_system(strip)))
    got = serve._system_from_npz(serve._unpack(payload))
    assert_systems_equal(got, port_system(strip))


def test_ping_absent_server(tmp_path):
    assert serve.ping(str(tmp_path / "nothing.sock")) is None


def test_default_socket_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("PADNE_TORCH_SOCKET", raising=False)
    monkeypatch.delenv("PADNE_TPU_SOCKET", raising=False)
    assert serve.default_socket_path().endswith(
        os.path.join("padne_tpu_torch", "serve.sock"))
    assert serve.default_socket_path() != jserve.default_socket_path()
    monkeypatch.setenv("PADNE_TORCH_SOCKET", "/x/y.sock")
    assert serve.default_socket_path() == "/x/y.sock"


def test_ping_reports_the_device(server):
    assert serve.ping(server) == {"pid": os.getpid(), "version": 1,
                                  "device": "cpu", "name": "cpu"}


# ---------------------------------------------------------------------------
# Solve
# ---------------------------------------------------------------------------
def test_solve_matches_the_jax_server_and_scipy(strip, server, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("PADNE_TPU_COARSE_SIZE", str(COARSE))
    jsock = str(tmp_path / "jax.sock")
    th = start(jserve.serve, socket_path=jsock, max_requests=4)
    try:
        want = jserve.client_solve(jax_system(strip), target_residual=1e-10,
                                   socket_path=jsock)
    finally:
        stop(th, jsock, jserve.shutdown)
    assert want is not None

    system = port_system(strip)
    stats = {}
    got = serve.client_solve(system, target_residual=1e-10,
                             socket_path=server, stats=stats)
    assert got is not None and got.residual_norm < 1e-10
    assert stats["served_by"] == os.getpid() and stats["setup_s"] > 0
    assert np.abs(got.v - np.asarray(want.v)).max() <= 1e-9
    L, r, *_ = schur.bordered_scipy_system(system)
    z = scipy.sparse.linalg.spsolve(L, r)
    assert np.abs(got.v - z[:system.n]).max() <= 1e-6


def test_preloaded_solver_is_warm(strip, tmp_path):
    """A solver handed over at start serves its board without set-up."""
    system = port_system(strip)
    solver_ = schur.DiaBorderedSolver(system, device="cpu",
                                      coarse_size=COARSE)
    sock = str(tmp_path / "pre.sock")
    th = start(serve.serve, socket_path=sock, max_requests=4, device="cpu",
               preload=[(system, solver_)])
    try:
        stats = {}
        res = serve.client_solve(port_system(strip), 1e-10,
                                 socket_path=sock, stats=stats)
    finally:
        stop(th, sock)
    assert res is not None and res.residual_norm < 1e-10
    assert stats["setup_s"] == 0.0


def test_cached_resolve_with_doubled_excitation(strip, server):
    system = port_system(strip)
    first = serve.client_solve(system, target_residual=1e-10,
                               socket_path=server)
    system.r_core *= 2.0
    system.border.rhs *= 2.0
    stats = {}
    second = serve.client_solve(system, target_residual=2e-10,
                                socket_path=server, stats=stats)
    assert second is not None and stats["setup_s"] == 0.0
    assert np.abs(second.v - 2.0 * first.v).max() <= 2e-6
    assert second.residual_norm < 2e-10


def test_small_system_declined(strip, tmp_path, caplog):
    sock = str(tmp_path / "s.sock")
    th = start(serve.serve, socket_path=sock, max_requests=4, device="cpu")
    try:
        with caplog.at_level(logging.WARNING, logger="padne_tpu_torch.serve"):
            res = serve.client_solve(port_system(strip), 1e-9,
                                     socket_path=sock)
    finally:
        stop(th, sock)
    assert res is None
    assert "too small for the DIA server path" in caplog.text


def test_set_excitation_matches_a_fresh_solver(strip):
    system = port_system(strip)
    # The strip's own core excitation is zero (a voltage source only):
    # inject seeded currents that sum to zero, and scale the source.
    rng = np.random.default_rng(11)
    r2 = rng.standard_normal(system.n) * 1e-2
    r2 -= r2.mean()
    rhs2 = system.border.rhs * 3.0
    cached = schur.DiaBorderedSolver(system, device="cpu",
                                     coarse_size=COARSE)
    cached.solve(target_residual=1e-10)
    cached.set_excitation(r2, rhs2)
    got = cached.solve(target_residual=1e-10)

    fresh_system = port_system(strip)
    fresh_system.r_core[:] = r2
    fresh_system.border.rhs[:] = rhs2
    fresh = schur.DiaBorderedSolver(fresh_system, device="cpu",
                                    coarse_size=COARSE)
    want = fresh.solve(target_residual=1e-10)
    # The ladder's device copy of the excitation was rebuilt: the host
    # mop-up passes would hide a stale one in the potentials.
    assert torch.equal(cached._b64, fresh._b64)
    assert got.refinement_steps <= want.refinement_steps
    assert got.residual_norm < 1e-10 and want.residual_norm < 1e-10
    assert np.abs(got.v - want.v).max() <= 1e-9
    assert np.abs(got.j - want.j).max() <= 1e-9


# ---------------------------------------------------------------------------
# The faults of padne_tpu.serve, not copied
# ---------------------------------------------------------------------------
def test_eviction_happens_before_the_new_solver_is_built(strip, server,
                                                         monkeypatch):
    live = weakref.WeakSet()
    at_init = []
    real_init = schur.DiaBorderedSolver.__init__

    def counting_init(self, *args, **kwargs):
        gc.collect()
        at_init.append(len(live))
        real_init(self, *args, **kwargs)
        live.add(self)

    monkeypatch.setattr(schur.DiaBorderedSolver, "__init__", counting_init)
    for size in (MESH_SIZE, 0.2):
        assert serve.client_solve(port_system(strip, size), 1e-9,
                                  socket_path=server) is not None
    assert at_init == [0, 0]


def test_second_server_on_a_live_socket_raises(server):
    with pytest.raises(RuntimeError, match="already answers"):
        serve.serve(socket_path=server, max_requests=1, device="cpu")
    assert serve.ping(server)["pid"] == os.getpid()


def test_dead_socket_is_replaced(tmp_path):
    sock = str(tmp_path / "dead.sock")
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale.bind(sock)
    stale.close()            # leaves the file, nobody listening
    assert os.path.exists(sock) and serve.ping(sock) is None
    th = start(serve.serve, socket_path=sock, max_requests=2, device="cpu")
    assert serve.ping(sock)["pid"] == os.getpid()
    stop(th, sock)
    assert not os.path.exists(sock)


def test_server_of_another_version_is_refused(strip, tmp_path, caplog):
    sock = str(tmp_path / "v2.sock")
    kinds = []
    th = start(fake_server, sock=sock, version=serve.PROTOCOL_VERSION + 1,
               kinds=kinds)
    try:
        with caplog.at_level(logging.WARNING, logger="padne_tpu_torch.serve"):
            res = serve.client_solve(port_system(strip), 1e-9,
                                     socket_path=sock)
    finally:
        stop(th, sock)
    assert res is None and kinds == ["ping", "shutdown"]
    assert "speaks protocol 2" in caplog.text


# ---------------------------------------------------------------------------
# The dispatch of solver.solve
# ---------------------------------------------------------------------------
def potentials(sol):
    return np.concatenate([p.values for ls in sol.layer_solutions
                           for p in ls.potentials])


def test_solve_dispatches_to_a_cpu_daemon(strip, server, monkeypatch):
    monkeypatch.setattr(solver, "SERVE_MIN_N", 0)
    monkeypatch.setenv("PADNE_TORCH_SOCKET", server)
    prob = kicad.load_kicad_project(strip)
    cfg = mesh.Mesher.Config(maximum_size=MESH_SIZE)
    stats = {}
    served = solver.solve(prob, mesher_config=cfg, device="cpu", stats=stats)
    assert stats["served_by"] == os.getpid() and stats["route"] == "dia"
    monkeypatch.setenv("PADNE_TORCH_SERVER", "0")
    local_stats = {}
    local = solver.solve(prob, mesher_config=cfg, device="cpu",
                         stats=local_stats)
    assert local_stats["served_by"] is None
    assert served.solver_info.residual_norm < 1e-10
    assert np.abs(potentials(served) - potentials(local)).max() <= 1e-9


def test_solve_does_not_dispatch_to_another_device_type(strip, tmp_path,
                                                        monkeypatch):
    sock = str(tmp_path / "cuda.sock")
    kinds = []
    th = start(fake_server, sock=sock, device="cuda", kinds=kinds)
    monkeypatch.setattr(solver, "SERVE_MIN_N", 0)
    monkeypatch.setenv("PADNE_TORCH_SOCKET", sock)
    try:
        stats = {}
        sol = solver.solve(kicad.load_kicad_project(strip), device="cpu",
                           stats=stats)
    finally:
        stop(th, sock)
    assert stats["served_by"] is None and kinds == ["ping", "shutdown"]
    assert sol.solver_info.residual_norm < 1e-9


def test_small_systems_solve_locally(strip, server, monkeypatch):
    """Below SERVE_MIN_N the daemon is not asked at all."""
    monkeypatch.setenv("PADNE_TORCH_SOCKET", server)
    stats = {}
    solver.solve(kicad.load_kicad_project(strip), device="cpu", stats=stats)
    assert stats["served_by"] is None
