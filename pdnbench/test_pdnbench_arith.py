"""The benchmark's arithmetic and its discovery of cells, mixes and
metrics by name (CPU)."""

import json
import pathlib

import pytest

from pdnbench import arith, harness

HERE = pathlib.Path(__file__).resolve().parent


def test_window_over_count():
    assert arith.per_request(40.0, 100) == 0.4
    assert arith.per_request(40.0, 0) is None
    run = harness.Run("c", setup_s=1.0, window_s=41.5,
                      latencies=[0.5] * 83)
    for name in ("solve_s", "board_s", "project_s"):
        assert harness.metric_reader(name).read(run) == 41.5 / 83


def test_csr_bytes_from_rows_nonzeros_and_r():
    # 10 rows, 30 off-diagonal nonzeros in f32 with int32 indices, an
    # f32 diagonal, all 10 rows of x named, R = 4, f32 vectors.
    b = arith.csr_bytes(rows=10, nnz=30, value_bytes=4, diag_bytes=4,
                        x_rows=10, r=4, vec_bytes=4)
    assert b == 30 * 8 + 11 * 4 + 10 * 4 + 10 * 4 * 4 + 10 * 4 * 4
    assert arith.csr_bytes(10, 30, 4, 4, 10, 4, 4, epilogue_bytes=7) == b + 7
    # f64 values, R = 1, a rectangular operator naming 3 rows of x.
    assert arith.csr_bytes(10, 5, 8, 0, 3, 1, 8) == 5 * 12 + 44 + 24 + 80
    assert arith.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
    assert arith.roofline_pct(1.0, 0.0) is None


def test_idle_share_counts_overlaps_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]
    assert arith.union_length(iv) == 4.0
    assert arith.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert arith.gaps(iv, 1.5, 5.2) == [(3.0, 5.0)]

    class Reading:
        busy_s, window_s = 4.0, 10.0

    run = harness.Run("c", setup_s=1.0, trace=Reading())
    for name in ("device_idle.resolve", "device_idle.board"):
        assert harness.metric_reader(name).read(run) == pytest.approx(60.0)


def test_counters_are_means_of_the_window():
    run = harness.Run("c", setup_s=1.0, counters=[
        {"cg_iterations": 10, "passes": 3, "host_reads": 4,
         "host_setup_s": 1.0, "mesh_assemble_s": 2.0},
        {"cg_iterations": 12, "passes": 5, "host_reads": 6,
         "host_setup_s": 3.0, "mesh_assemble_s": 4.0}])
    want = {"cg_iters.resolve": 11, "cg_iters.board": 11,
            "passes.resolve": 4, "host_reads.resolve": 5,
            "host_setup_s.board": 2.0, "mesh_assemble_s.project": 3.0}
    for name, v in want.items():
        assert harness.metric_reader(name).read(run) == v
    empty = harness.Run("c", setup_s=1.0)
    assert harness.metric_reader("cg_iters.board").read(empty) is None
    assert harness.metric_reader("k1_roofline.resolve").read(empty) is None


def test_every_name_in_the_benchmark_has_its_file():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        assert (HERE.parent / c["file"]).is_file()
    for cell in bench["workloads"]:
        traffic = harness.traffic_of(cell["traffic"])
        assert hasattr(harness.entry_module(traffic["entry"]), "Entry")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
        for cell in m.get("workloads", []):
            harness.cell_of(bench, cell)


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a mix and a metric dropped into their folders
    are found with no edit of the harness."""
    here = tmp_path / "pdnbench"
    (here / "traffic").mkdir(parents=True)
    (here / "metrics").mkdir()
    (here / "configs").mkdir()
    (here / "traffic" / "newmix.json").write_text(json.dumps(
        {"entry": "resolve", "warmup": 1}))
    (here / "metrics" / "new_metric.layer.py").write_text(
        "def read(run):\n    return run.setup_s * 2\n")
    (here / "configs" / "newcfg.json").write_text(json.dumps({"n": 5}))
    monkeypatch.setattr(harness, "HERE", here)
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "newcfg",
                             "file": "pdnbench/configs/newcfg.json"})
    cell = {"name": "newcfg.newmix", "config": "newcfg",
            "traffic": "newmix", "chips": 1}
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "new_metric.layer", "unit": "s",
                               "moves": "setup_s"})
    assert harness.config_of(bench, cell, tmp_path) == {"n": 5,
                                                        "name": "newcfg"}
    assert harness.traffic_of("newmix")["entry"] == "resolve"
    names = [m["name"] for m in harness.metrics_of(bench, cell["name"], True)]
    assert names == ["new_metric.layer"]
    run = harness.Run(cell["name"], setup_s=3.0)
    assert harness.metric_reader("new_metric.layer").read(run) == 6.0
    assert [m["name"] for m in harness.metrics_of(
        bench, cell["name"], False)] == ["setup_s"]


def test_ell_operator_bytes_count_nonzeros_not_padding():
    """K3''s bound counts the operator's nonzeros, not its stored
    entries: the same matrix in any lane layout gives the same bytes."""
    import numpy as np
    import scipy.sparse
    import torch

    from padne_tpu_torch.ops import spmv
    from pdnbench import trace

    rng = np.random.default_rng(5)
    a = scipy.sparse.random(300, 300, density=0.02, random_state=7,
                            format="csr")
    a = (a + a.T).tocsr()
    a.setdiag(0)
    a.eliminate_zeros()
    k = int(np.diff(a.indptr).max())
    cols = np.tile(np.arange(300)[:, None], (1, k)).astype(np.int32)
    vals = np.zeros((300, k))
    for i in range(300):
        lo, hi = a.indptr[i], a.indptr[i + 1]
        cols[i, :hi - lo], vals[i, :hi - lo] = a.indices[lo:hi], a.data[lo:hi]
    diag = rng.uniform(1, 2, 300)
    shapes = set()
    for lanes in (1, 4, 32):
        op = spmv.build_operator(cols, vals, diag, 300, "cpu",
                                 torch.float32, lanes=lanes)
        shapes.add(trace._operator_shape("ell_spmv", op))
    assert shapes == {(300, a.nnz * 8, 4, 300, 4)}
