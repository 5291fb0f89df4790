"""Fixtures of pdnbench's own tests (run from the repo root with
`python -m pytest pdnbench -q`)."""

import json
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Two CPU threads: the plain kernels slow down by an order of
    magnitude when every test process takes every core."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


TINY_CELLS = ("tiny.resolve", "tiny.board", "tiny.project")


def tiny_config() -> dict:
    """pdn4l_default's configuration on a 20 mm board with a 3 x 3 via
    grid at 1 mm: 3,740 unknowns, the same board generator and checks."""
    config = json.loads((HERE / "configs" / "pdn4l_default.json").read_text())
    config["board"]["args"] = {"side": 20.0, "n_vias": 3}
    config["mesher"]["maximum_size"] = 1.0
    config["n"] = 3740
    return config


def make_tiny(tmp_path):
    """(bench, root, cache): BENCHMARK.json with a tiny configuration and
    its cells on the real traffic mixes and metrics added, the
    configuration file under root, and a directory for the input cache."""
    from pdnbench import harness

    tmp_path = pathlib.Path(tmp_path)
    root = tmp_path / "root"
    (root / "configs").mkdir(parents=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    bench = harness.load_benchmark()
    bench["configs"].append({"name": "tiny", "file": "configs/tiny.json"})
    for cell in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": "tiny",
                                   "traffic": cell.split(".")[1],
                                   "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + sorted(
                {"tiny." + w.split(".")[1] for w in m["workloads"]})
    return bench, root, tmp_path / "cache"


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench, root) of `make_tiny`, its input cache under tmp_path."""
    from pdnbench import inputs

    bench, root, cache = make_tiny(tmp_path)
    monkeypatch.setattr(inputs, "CACHE", cache)
    return bench, root
