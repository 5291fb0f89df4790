"""The slice end to end on the CPU: padne_tpu_torch.solver.solve against
padne_tpu.solver.solve on the generated 4-layer bench board cut to ~40k
DoF (a two-level DIA hierarchy).  Per-layer potentials agree within
1e-6 V and power densities within 1e-6 of each layer's maximum; both
reach the repo's 1e-9 residual gate."""

import numpy as np
import pytest
import torch

from padne_tpu import kicad, mesh
from padne_tpu import solver as jsolver
from padne_tpu.solver import Solution
from padne_tpu_torch import solver

from tests.boardgen import gen_bench_4layer

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bench_problem(tmp_path_factory):
    pro = gen_bench_4layer(tmp_path_factory.mktemp("bench4"))
    prob = kicad.load_kicad_project(pro)
    # Mesh density for the DoF target, as bench.py sizes it.
    area = sum(layer.shape.area for layer in prob.layers)
    size = (area / (0.43 * 25_000)) ** 0.5
    cfg = mesh.Mesher.Config(maximum_size=size,
                             variable_size_maximum_factor=1.0)
    return prob, cfg


def test_slice_matches_jax(bench_problem):
    prob, cfg = bench_problem
    stats = {}
    got = solver.solve(prob, mesher_config=cfg, device="cpu", stats=stats)
    ref = jsolver.solve(prob, mesher_config=cfg)
    assert isinstance(got, Solution)
    assert 30_000 < stats["n"] < 60_000 and len(stats["levels"]) >= 2
    assert got.solver_info.residual_norm < 1e-9
    assert ref.solver_info.residual_norm < 1e-9
    assert got.solver_info.system_size == ref.solver_info.system_size
    assert len(got.layer_solutions) == len(ref.layer_solutions) == 4
    for lg, lr in zip(got.layer_solutions, ref.layer_solutions):
        assert len(lg.potentials) == len(lr.potentials) >= 1
        for pg, pr in zip(lg.potentials, lr.potentials):
            assert np.abs(pg.values - pr.values).max() <= 1e-6
        pmax = max(np.abs(p.values).max() for p in lr.power_densities)
        for pg, pr in zip(lg.power_densities, lr.power_densities):
            assert np.abs(pg.values - pr.values).max() <= 1e-6 * pmax


def test_device_policy():
    from padne_tpu_torch import device

    assert device.resolve("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            device.resolve(None)
