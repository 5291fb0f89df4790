#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py [--dof 1000000] [--scipy-dof 200000]

Phases (any failure exits non-zero; there is no CPU path):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from padne_tpu_torch/csrc, timed;
3. kernel K1 (slab SpMV) against its plain PyTorch version on the card,
   at the main path's shapes: the level-0 f32 slab with 8 slots at
   R = 1 and 4, and a deep-level bf16 slab with 24 offsets (dmax 32);
   max relative error (bound 1e-5 of max|y|: f32 sums in another order)
   and ms per call of each, by CUDA events;
4. kernel K2 (compensated slab residual) against its f64 plain version,
   bound 2e-13 * max(|A| |x|), and both times;
5. padne_tpu_torch.solver.solve on the generated 4-layer bench board at
   --dof (sized as bench.py sizes it), with the kernels' launch counters
   reset just before and read just after: both must be > 0, and the
   full-system residual must meet the repo's 1e-9 gate;
6. a second solve at --scipy-dof with the potentials held against
   scipy.sparse.linalg.spsolve on the same bordered system (max |dV|
   <= 1e-6 V).

The line before the last is a JSON object with the per-kernel results;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
L0_NP, L0_OFFS = 1_276_928, (-2, -1, 0, 1)       # level 0 at ~1.09M DoF
DEEP_NP = 217_088                                 # level 1 at ~1.09M DoF
DEEP_OFFS = (-32, *range(-11, 11), 32)            # D = 24, dmax 32


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_case(name, np_, offs, dtype, r, e, seed):
    """K1 vs its plain version on random data of the given shape."""
    import torch

    from padne_tpu_torch.ops import dia

    dev = torch.device("cuda")
    nb = np_ // 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(nb // 8, 8, len(offs), 128, 128, generator=gen,
                    device=dev).to(dtype)
    xt = torch.randn(r, np_, generator=gen, device=dev)
    slots = None
    if e:
        slots = (torch.randint(0, nb, (nb * e,), generator=gen, device=dev,
                               dtype=torch.int32),
                 torch.randint(0, 128, (nb, e, 128), generator=gen,
                               device=dev, dtype=torch.int32),
                 torch.randn(nb, e, 128, generator=gen, device=dev))
    meta = (np_, 128, 8, nb // 8, offs)
    y = dia.slab_matvec(meta, w, xt, slots)
    ref = dia.slab_matvec_plain(meta, w, xt, slots)
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    rel = abs_err / float(ref.abs().max())
    ms = time_ms(lambda: dia.slab_matvec(meta, w, xt, slots))
    plain_ms = time_ms(lambda: dia.slab_matvec_plain(meta, w, xt, slots))
    gbytes = w.numel() * w.element_size() / 1e9
    print(f"[K1 {name}] np={np_} D={len(offs)} dmax={max(map(abs, offs))} "
          f"R={r} E={e} {str(dtype).removeprefix('torch.')}: "
          f"max_rel_err={rel:.3e} max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms ({gbytes / ms * 1e3:.0f} GB/s slab stream) "
          f"plain {plain_ms:.4f} ms", flush=True)
    check(rel <= 1e-5, f"K1 {name} disagrees with its plain version "
                       f"({rel:.3e})")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def k2_case(seed):
    import torch

    from padne_tpu_torch.ops import comp

    dev = torch.device("cuda")
    nb = L0_NP // 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    w64 = torch.randn(nb, len(L0_OFFS), 128, 128, generator=gen,
                      device=dev, dtype=torch.float64) * 2081.0
    w = w64.float()
    w_lo = (w64 - w.double()).float()
    del w64
    x = torch.randn(L0_NP, generator=gen, device=dev) + 1.0
    meta = (L0_NP, 128, 8, nb // 8, L0_OFFS)
    y = comp.comp_slab(meta, w, w_lo, x)
    ref = comp.comp_slab_plain(meta, w, w_lo, x)
    bound = 2e-13 * float(
        comp.comp_slab_plain(meta, w.abs(), w_lo.abs(), x.abs()).max())
    torch.cuda.synchronize()
    abs_err = float((y - ref).abs().max())
    ms = time_ms(lambda: comp.comp_slab(meta, w, w_lo, x))
    plain_ms = time_ms(lambda: comp.comp_slab_plain(meta, w, w_lo, x))
    print(f"[K2 l0] np={L0_NP} D={len(L0_OFFS)} f32 hi+lo -> f64: "
          f"max_abs_err={abs_err:.3e} (bound {bound:.3e}) "
          f"kernel {ms:.4f} ms ({2 * w.numel() * 4 / ms / 1e6:.0f} GB/s "
          f"slab streams) plain(f64 bmm) {plain_ms:.4f} ms", flush=True)
    check(abs_err <= bound, "K2 disagrees with its f64 plain version")
    return {"abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def check_fields(sol, n: int) -> None:
    """Finite per-layer fields of the expected shapes, and the 1 V source
    across the stack visible in the potential range."""
    import numpy as np

    check(len(sol.layer_solutions) == 4, "expected 4 copper layers")
    lo, hi, n_vals = np.inf, -np.inf, 0
    for layer in sol.layer_solutions:
        check(len(layer.potentials) >= 1, "a layer without potentials")
        for pot, pd in zip(layer.potentials, layer.power_densities):
            check(pot.values.shape == (pot.mesh.num_vertices,)
                  and pd.values.shape == (pd.mesh.num_faces,),
                  "field shapes do not match their meshes")
            check(np.isfinite(pot.values).all()
                  and np.isfinite(pd.values).all(),
                  "non-finite potentials or power densities")
            lo = min(lo, float(pot.values.min()))
            hi = max(hi, float(pot.values.max()))
            n_vals += len(pot.values)
    check(0.9 * n < n_vals <= n, "potentials do not cover the mesh")
    check(1.0 - 1e-6 <= hi - lo < 1.5,
          f"potential range {hi - lo:.6f} V is not that of a 1 V source")


def bench_problem(tmp: pathlib.Path, dof: int):
    """The generated 4-layer bench board and a mesher config for `dof`
    (vertices ~ area / (0.43 size^2), as bench.py sizes it)."""
    import importlib.util

    from padne_tpu import kicad, mesh

    # By file path: an installed top-level `tests` package would shadow
    # the repository's (namespace) tests directory.
    spec = importlib.util.spec_from_file_location(
        "boardgen", REPO / "tests" / "boardgen.py")
    boardgen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(boardgen)
    prob = kicad.load_kicad_project(boardgen.gen_bench_4layer(tmp))
    area = sum(layer.shape.area for layer in prob.layers)
    size = max(0.05, (area / (0.43 * dof)) ** 0.5)
    return prob, mesh.Mesher.Config(maximum_size=size,
                                    variable_size_maximum_factor=1.0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dof", type=int, default=1_000_000)
    ap.add_argument("--scipy-dof", type=int, default=200_000)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    from padne_tpu_torch import device, kernels
    from padne_tpu_torch.ops import comp, dia

    device.resolve(None)   # TF32 off, CUDA required
    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] CUDA kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    k1 = [k1_case("l0 CG operator", L0_NP, L0_OFFS, torch.float32, 1, 8, 1),
          k1_case("l0 CG operator", L0_NP, L0_OFFS, torch.float32, 4, 8, 2),
          k1_case("deep cycle level", DEEP_NP, DEEP_OFFS, torch.bfloat16,
                  4, 0, 3)]
    k2 = k2_case(4)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    from padne_tpu import geom  # noqa: F401  builds the C++ core (g++)
    from padne_tpu_torch import solver
    print(f"[setup] host geometry core ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                     dir=REPO) as tmp:
        t0 = time.perf_counter()
        prob, cfg = bench_problem(pathlib.Path(tmp), args.dof)
        t_load = time.perf_counter() - t0

        dia.slab_matvec.launches = 0
        comp.comp_slab.launches = 0
        stats = {}
        sol = solver.solve(prob, mesher_config=cfg, stats=stats)
        launches = {"dia_slab": dia.slab_matvec.launches,
                    "comp_slab": comp.comp_slab.launches}
        info = sol.solver_info
        print(f"[slice] n={stats['n']} m={stats['m']} "
              f"levels={stats['levels']} load={t_load:.2f}s "
              f"mesh+assemble={stats['mesh_assemble_s']:.2f}s "
              f"setup={stats['setup_s']:.2f}s solve={stats['solve_s']:.2f}s "
              f"postproc={stats['postproc_s']:.2f}s "
              f"cg_iterations={info.cg_iterations} "
              f"refinement_passes={info.refinement_steps + 1} "
              f"residual_norm={info.residual_norm:.3e} "
              f"launches={launches}", flush=True)
        for k, v in launches.items():
            check(v > 0, f"the slice never launched {k}")
        check(info.residual_norm < 1e-9,
              f"residual {info.residual_norm:.3e} misses the 1e-9 gate")
        check_fields(sol, stats["n"])
        del sol

        prob, cfg = bench_problem(pathlib.Path(tmp) / "scipy",
                                  args.scipy_dof)
        stats2 = {}
        sol = solver.solve(prob, mesher_config=cfg,
                           check_against_scipy=True, stats=stats2)
        dv = stats2["scipy_max_dv"]
        print(f"[scipy] n={stats2['n']} solve={stats2['solve_s']:.2f}s "
              f"residual_norm={sol.solver_info.residual_norm:.3e} "
              f"max|dV| vs spsolve={dv:.3e} V", flush=True)
        check(dv <= 1e-6, f"max |dV| {dv:.3e} V vs scipy exceeds 1e-6 V")
        check_fields(sol, stats2["n"])
        check(sol.solver_info.residual_norm < 1e-9,
              "scipy-check solve misses the 1e-9 gate")

    kernels_line = {"kernels": [
        {"name": "dia_slab", "route": "cuda",
         "source": "padne_tpu_torch/csrc/dia_slab.cu",
         "replaces": "padne_tpu/ops/dia.py:802",
         "launches": launches["dia_slab"],
         "max_abs_err": max(c["abs_err"] for c in k1),
         "ms": k1[1]["ms"], "plain_ms": k1[1]["plain_ms"]},
        {"name": "comp_slab", "route": "cuda",
         "source": "padne_tpu_torch/csrc/comp_slab.cu",
         "replaces": "padne_tpu/ops/comp.py:274",
         "launches": launches["comp_slab"],
         "max_abs_err": k2["abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
