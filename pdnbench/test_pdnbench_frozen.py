"""The frozen host pipeline (pdnbench/frozen) gives the program's
assembled systems bit for bit, and the benchmark's inputs (the cache,
the variants, the excitations) keep to it (CPU)."""

import dataclasses

import numpy as np
import pytest

from pdnbench import inputs
from pdnbench.conftest import tiny_config

BOARDS = [("gen_bench_4layer", {"side": 20.0, "n_vias": 3},
           {"maximum_size": 1.0}),
          ("gen_via_stack_4layer", {}, {}),
          ("gen_regulator", {}, {})]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("gen,args,mesher", BOARDS,
                         ids=[b[0] for b in BOARDS])
def test_frozen_system_is_the_programs(tmp_path, gen, args, mesher):
    from padne_tpu_torch import kicad, mesh, solver
    from pdnbench.frozen import boardgen
    from pdnbench.frozen import kicad as fkicad
    from pdnbench.frozen import mesh as fmesh
    from pdnbench.frozen import system as fsystem

    getattr(boardgen, gen)(tmp_path, **args)
    pro = tmp_path / gen / f"{gen}.kicad_pro"
    ours, *_ = fsystem.build_system(fkicad.load_kicad_project(pro),
                                    fmesh.Mesher.Config(**mesher))
    theirs, *_ = solver.build_system(kicad.load_kicad_project(pro),
                                     mesh.Mesher.Config(**mesher))
    assert ours.n == theirs.n and ours.n > 0
    assert ours.num_components == theirs.num_components
    assert ours.ground_var == theirs.ground_var
    for key in ("cols", "vals", "diag"):
        assert _same(getattr(ours.ell, key), getattr(theirs.ell, key))
    for key in ("comp_id", "r_core", "coords", "group"):
        assert _same(getattr(ours, key), getattr(theirs, key)), key
    for f in dataclasses.fields(ours.border):
        assert _same(getattr(ours.border, f.name),
                     getattr(theirs.border, f.name)), f.name


@pytest.fixture
def tiny_inputs(tmp_path, monkeypatch):
    monkeypatch.setattr(inputs, "CACHE", tmp_path / "cache")
    config = {**tiny_config(), "name": "tiny"}
    return config, inputs.base_inputs(config, tmp_path / "board")


def test_input_cache_round_trips_bit_equal(tmp_path, tiny_inputs):
    config, made = tiny_inputs
    files = list((tmp_path / "cache").iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
    loaded = inputs.base_inputs(config, tmp_path / "unused")
    assert not (tmp_path / "unused").exists()      # no board written
    keys = set(made.__dict__)
    assert keys == set(loaded.__dict__) and "ell_vals" in keys
    for key in keys:
        assert _same(getattr(made, key), getattr(loaded, key)), key
    assert made.n == 3740 and made.m == 3


def test_nominal_variant_and_excitation_are_the_assembly(tiny_inputs):
    _, inp = tiny_inputs
    ell = inputs.variant_ell(inp, [1.0, 1.0, 1.0, 1.0])
    for key in ("cols", "vals", "diag"):
        assert _same(getattr(ell, key), getattr(inp.ell(), key))
    rc, rhs = inputs.excitation(inp, [1.0, 1.0], [1.0, 1.0])
    assert _same(rc, inp.r_core) and _same(rhs, inp.b_rhs)
    rc2, rhs2 = inputs.excitation(inp, [2.0, 0.5], [1.5, 1.0])
    assert np.array_equal(rhs2, [1.5, 1.0, 0.0])
    assert np.isclose(rc2.sum(), 0.0) and np.abs(rc2).max() == 20.0


def test_layer_weights_match_the_stackup_written(tmp_path, tiny_inputs):
    """A board variant's weights scale each layer's mesh edges as the
    project variant's thicker or thinner copper does (the via model of
    the KiCad loader also reads the copper thickness: lumped resistors
    are left out of the comparison)."""
    config, inp = tiny_inputs
    w = [2.0, 0.5, 1.0, 2.0]
    prob = inputs.load_problem(config, tmp_path / "v", layer_weights=w)
    written = inputs.assemble(prob, inputs.mesher_settings(config, prob))
    mesh = inp.edge_layer >= 0
    assert np.array_equal(written["edge_layer"], inp.edge_layer)
    assert np.array_equal(written["edges"][mesh], inp.edges[mesh])
    scale = np.asarray(w)[inp.edge_layer[mesh]]
    np.testing.assert_allclose(written["weights"][mesh],
                               inp.weights[mesh] * scale, rtol=1e-14)
