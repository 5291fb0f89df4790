"""Resident solve server of the port: one process holds the device and
keeps set-up DiaBorderedSolvers warm; `solve` and `gui` ship their
assembled system to it over a unix socket.

Port of padne_tpu.serve.  A fresh process pays for its interpreter,
torch, the CUDA context and the host AMG set-up before its first
solve; a resident `padne-torch serve` pays them once.  Later CLI runs
ship the assembled system and get the solution back, paying host
meshing, transfer and the solve.  Repeat solves of the same operator
(same structural hash, any excitation) reuse the cached solver through
`DiaBorderedSolver.set_excitation` and skip the set-up.

Wire protocol (version 1, both directions, the JAX package's):
    8-byte big-endian frame length, then an .npz payload.
Request npz keys: kind ("ping" | "solve" | "shutdown"); solve adds the
CoreSystem/BorderSpec flat arrays (see _system_to_npz) plus
target_residual and max_refinements.  Response npz: ok (1/0) and
either the BorderedSolution arrays with setup_seconds and solve_seconds,
or err (utf-8 message).  A ping answers pid, version, backend (the
server's torch device type, "cuda" or "cpu", where the JAX package's
server names its JAX backend) and name (the card's).

Unlike padne_tpu.serve: the server evicts a cached solver before it
builds the next (one solver in device memory at a time at capacity 1),
refuses to start on a socket a live server answers (it unlinks only a
dead one), and the client refuses a server of another protocol
version.  The default socket is the port's own, so a port client never
ships a system to a JAX daemon, nor the reverse.

Security note: the default socket lives in a 0700 directory of the
user's cache dir and is created 0600.  The payload is plain arrays
(np.load with allow_pickle=False), never pickled objects.
"""

from __future__ import annotations

import gc
import io
import logging
import os
import pathlib
import socket
import struct
import time

import numpy as np

log = logging.getLogger(__name__)

PROTOCOL_VERSION = 1


def default_socket_path() -> str:
    """$PADNE_TORCH_SOCKET, or ~/.cache/padne_tpu_torch/serve.sock."""
    env = os.environ.get("PADNE_TORCH_SOCKET")
    if env:
        return env
    base = pathlib.Path(os.environ.get(
        "XDG_CACHE_HOME", pathlib.Path.home() / ".cache")) / "padne_tpu_torch"
    return str(base / "serve.sock")


# ---------------------------------------------------------------------------
# Framing + npz payloads
# ---------------------------------------------------------------------------
_MAX_FRAME = 16 << 30  # sanity bound, not a real limit


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">Q", len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = struct.unpack(">Q", _recv_exact(sock, 8))
    if n > _MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds sanity bound")
    return _recv_exact(sock, n)


def _pack(**arrays) -> bytes:
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def _unpack(payload: bytes) -> dict:
    z = np.load(io.BytesIO(payload), allow_pickle=False)
    return {k: z[k] for k in z.files}


def _text(s: str) -> np.ndarray:
    return np.frombuffer(s.encode(), dtype=np.uint8)


def _system_to_npz(system) -> dict:
    """CoreSystem + BorderSpec as flat arrays (the JAX package's keys)."""
    b = system.border
    out = dict(
        n=np.int64(system.n), cols=system.ell.cols, vals=system.ell.vals,
        diag=system.ell.diag, comp_id=system.comp_id,
        num_components=np.int64(system.num_components),
        r_core=system.r_core, ground_var=np.int64(system.ground_var),
        m=np.int64(b.m),
        row_idx=b.row_idx, row_node=b.row_node, row_val=b.row_val,
        col_idx=b.col_idx, col_node=b.col_node, col_val=b.col_val,
        rhs=b.rhs,
    )
    if system.coords is not None:
        out["coords"] = system.coords
    if system.group is not None:
        out["group"] = system.group
    return out


def _system_from_npz(z: dict):
    """The port's CoreSystem from a request's arrays (whichever package
    packed them)."""
    from .ops import assembly, schur

    border = schur.BorderSpec(
        m=int(z["m"]), row_idx=z["row_idx"], row_node=z["row_node"],
        row_val=z["row_val"], col_idx=z["col_idx"],
        col_node=z["col_node"], col_val=z["col_val"], rhs=z["rhs"],
    )
    return schur.CoreSystem(
        n=int(z["n"]),
        ell=assembly.EllMatrix(cols=z["cols"], vals=z["vals"],
                               diag=z["diag"]),
        comp_id=z["comp_id"], num_components=int(z["num_components"]),
        border=border, r_core=z["r_core"],
        ground_var=int(z["ground_var"]), coords=z.get("coords"),
        group=z.get("group"),
    )


def _structural_key(z: dict) -> str:
    """Hash of the OPERATOR structure+values (not the RHS): solves of
    the same board with different excitations reuse the cached solver
    (its hierarchy depends only on the operator)."""
    import hashlib

    h = hashlib.sha256()
    for k in ("cols", "vals", "diag", "comp_id", "row_idx", "row_node",
              "row_val", "col_idx", "col_node", "col_val",
              "ground_var"):
        a = np.ascontiguousarray(z[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------
class _SolverCache:
    """Most-recently-used DiaBorderedSolver per structural hash.

    A 1M-DoF solver pins about 1 GB of device memory; the default
    capacity of 1 keeps one resident.  `make_room` evicts before a new
    solver is built, so two never coexist at capacity."""

    def __init__(self, capacity: int = 1):
        self.capacity = max(1, capacity)
        self._items: dict = {}   # key -> solver

    def get(self, key):
        solver = self._items.pop(key, None)
        if solver is not None:
            self._items[key] = solver   # refresh recency
        return solver

    def make_room(self) -> None:
        """Evict least-recently-used solvers until one more fits, and
        hand their device memory back."""
        if len(self._items) < self.capacity:
            return
        while len(self._items) >= self.capacity:
            old_key = next(iter(self._items))
            self._items.pop(old_key)
            log.info("serve: evicted cached solver %s", old_key[:12])
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def put(self, key, solver) -> None:
        self.make_room()
        self._items[key] = solver


def _decline(msg: str) -> bytes:
    return _pack(ok=np.int8(0), err=_text(msg))


def _handle_solve(z: dict, cache: _SolverCache, device,
                  solver_kw: dict) -> bytes:
    from .ops import schur

    t0 = time.perf_counter()
    key = _structural_key(z)
    solver = cache.get(key)
    setup_seconds = 0.0
    if solver is None:
        system = _system_from_npz(z)
        cache.make_room()
        t1 = time.perf_counter()
        try:
            solver = schur.DiaBorderedSolver(system, device=device,
                                             **solver_kw)
        except schur._NoDiaHierarchy:
            # Small systems (below the AMG coarse floor) take the ELL
            # route locally; report that cleanly.
            return _decline("system too small for the DIA server path; "
                            "solve locally")
        except Exception:
            # Real server faults (device memory, set-up bugs) must be
            # visible server-side, not masked as "too small".
            log.exception("serve: solver setup failed (n=%d)", int(z["n"]))
            return _decline("server solver setup failed (see server log); "
                            "solve locally")
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        setup_seconds = time.perf_counter() - t1
        cache.put(key, solver)
    else:
        solver.set_excitation(z["r_core"], z["rhs"])
    t1 = time.perf_counter()
    result = solver.solve(target_residual=float(z["target_residual"]),
                          max_refinements=int(z["max_refinements"]))
    solve_seconds = time.perf_counter() - t1
    log.info("serve: solved n=%d in %.2fs (setup %.2fs, total %.2fs)",
             int(z["n"]), solve_seconds, setup_seconds,
             time.perf_counter() - t0)
    return _pack(
        ok=np.int8(1), v=np.asarray(result.v), j=np.asarray(result.j),
        residual_norm=np.float64(result.residual_norm),
        ground_current=np.float64(result.ground_current),
        cg_iterations=np.int64(result.cg_iterations),
        refinement_steps=np.int64(result.refinement_steps),
        setup_seconds=np.float64(setup_seconds),
        solve_seconds=np.float64(solve_seconds),
    )


def _ping_reply(device) -> bytes:
    import torch

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return _pack(ok=np.int8(1), pid=np.int64(os.getpid()),
                 version=np.int64(PROTOCOL_VERSION),
                 backend=_text(device.type), name=_text(name))


def serve(socket_path: str | None = None, max_requests: int | None = None,
          ready_event=None, preload=None, device=None,
          cache_capacity: int = 1, conn_timeout: float = 600.0,
          solver_kw: dict | None = None) -> None:
    """Run the resident solve server (blocking accept loop).

    max_requests: exit after N requests (tests/probes); None = forever.
    ready_event: optional threading.Event set once listening.
    preload: optional list of (system, solver) pairs seeded into the
    solver cache (an embedding process hands over solvers it built).
    device: where the solvers run (None: the CUDA card, see
    padne_tpu_torch.device).  cache_capacity: solvers kept resident.
    conn_timeout: seconds a connection may stall mid-frame before it is
    dropped (the upload is hundreds of MB at 1M DoF).  solver_kw: extra
    DiaBorderedSolver arguments (e.g. coarse_size).

    Raises RuntimeError when a server already answers on the socket."""
    from . import device as device_mod

    dev = device_mod.resolve(device)
    solver_kw = dict(solver_kw or {})
    tighten_parent = socket_path is None
    path = pathlib.Path(socket_path or default_socket_path())
    if path.exists():
        info = ping(str(path))
        if info is not None:
            raise RuntimeError(
                f"a solve server (pid {info['pid']}) already answers on "
                f"{path}")
        path.unlink()   # a dead server's socket
    path.parent.mkdir(parents=True, exist_ok=True)
    if tighten_parent:
        # Restrict ONLY the default cache dir this code itself creates;
        # a caller's socket may live in a shared directory (e.g. /tmp).
        os.chmod(path.parent, 0o700)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(str(path))
    os.chmod(path, 0o600)
    srv.listen(4)
    cache = _SolverCache(cache_capacity)
    for system, solver in (preload or []):
        cache.put(_structural_key(_system_to_npz(system)), solver)
    log.info("serve: listening on %s (pid %d, %s)", path, os.getpid(), dev)
    if ready_event is not None:
        ready_event.set()
    served = 0
    try:
        while max_requests is None or served < max_requests:
            conn, _ = srv.accept()
            served += 1
            conn.settimeout(conn_timeout)
            try:
                req = _unpack(_recv_frame(conn))
                kind = bytes(req["kind"]).decode()
                if kind == "ping":
                    _send_frame(conn, _ping_reply(dev))
                elif kind == "solve":
                    _send_frame(conn, _handle_solve(req, cache, dev,
                                                    solver_kw))
                elif kind == "shutdown":
                    _send_frame(conn, _pack(ok=np.int8(1)))
                    break
                else:
                    _send_frame(conn, _decline(f"unknown kind {kind!r}"))
            except Exception:
                log.exception("serve: request failed")
                try:
                    _send_frame(conn, _decline("internal error (see server "
                                               "log)"))
                except OSError:
                    pass
            finally:
                conn.close()
    finally:
        srv.close()
        path.unlink(missing_ok=True)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------
def _request(payload: bytes, socket_path: str | None = None,
             timeout: float = 600.0) -> dict:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    try:
        sock.connect(socket_path or default_socket_path())
        _send_frame(sock, payload)
        return _unpack(_recv_frame(sock))
    finally:
        sock.close()


def ping(socket_path: str | None = None, timeout: float = 5.0):
    """Server liveness: {"pid", "version", "device", "name"}, or None
    when no server answers."""
    try:
        resp = _request(_pack(kind=_text("ping")), socket_path,
                        timeout=timeout)
    except (OSError, ValueError):
        return None
    if not int(resp.get("ok", 0)):
        return None
    return {"pid": int(resp["pid"]), "version": int(resp["version"]),
            "device": bytes(resp["backend"]).decode(),
            "name": bytes(resp["name"]).decode()}


def shutdown(socket_path: str | None = None) -> bool:
    try:
        resp = _request(_pack(kind=_text("shutdown")), socket_path,
                        timeout=10.0)
        return bool(int(resp.get("ok", 0)))
    except (OSError, ValueError):
        return False


def client_solve(system, target_residual: float,
                 max_refinements: int = 12,
                 socket_path: str | None = None, device=None,
                 stats: dict | None = None):
    """Solve on the resident server.  Returns a BorderedSolution, or
    None (logged at WARNING) when no server of this protocol version
    answers, when it declines or when the exchange fails: the caller
    then solves locally.  device: refuse a server of another torch
    device type (logged at INFO: not a fault).  stats receives
    served_by (the server's pid), and the server's setup_s and
    server_solve_s."""
    import torch

    from .ops import schur

    path = socket_path or default_socket_path()
    info = ping(path)
    if info is None:
        log.warning("serve: no server answers on %s; solving locally", path)
        return None
    if info["version"] != PROTOCOL_VERSION:
        log.warning("serve: the server on %s speaks protocol %d, this "
                    "client %d; solving locally", path, info["version"],
                    PROTOCOL_VERSION)
        return None
    if device is not None and info["device"] != torch.device(device).type:
        log.info("serve: the server on %s runs on %s, this solve on %s; "
                 "solving locally", path, info["device"],
                 torch.device(device).type)
        return None
    payload = dict(_system_to_npz(system))
    payload["kind"] = _text("solve")
    payload["target_residual"] = np.float64(target_residual)
    payload["max_refinements"] = np.int64(max_refinements)
    try:
        resp = _request(_pack(**payload), path)
    except Exception:
        # ANY transport/decode failure falls back to the local solve:
        # the server helps when healthy, never blocks a solve.
        log.warning("serve: dispatch to pid %d failed; solving locally",
                    info["pid"], exc_info=True)
        return None
    if not int(resp.get("ok", 0)):
        err = bytes(resp.get("err", b"")).decode(errors="replace")
        log.warning("serve: the server (pid %d) declined the solve (%s); "
                    "solving locally", info["pid"], err)
        return None
    if stats is not None:
        stats.update(served_by=info["pid"],
                     setup_s=float(resp["setup_seconds"]),
                     server_solve_s=float(resp["solve_seconds"]))
    log.info("serve: solved by the server (pid %d, %s)", info["pid"],
             info["name"])
    return schur.BorderedSolution(
        v=resp["v"], j=resp["j"],
        residual_norm=float(resp["residual_norm"]),
        ground_current=float(resp["ground_current"]),
        cg_iterations=int(resp["cg_iterations"]),
        refinement_steps=int(resp["refinement_steps"]),
    )
