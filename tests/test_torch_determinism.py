"""Source guard: no CUDA path of the port scatters atomically.

A scatter-add on a CUDA tensor adds in the order the threads arrive, so
the bits of its sums, and through the f32 CG the iteration counts,
change from solve to solve.  The port sums through ops.segment (a fixed
order) or on the host instead.  This test reads the port's sources as
text and fails on a scatter-add outside the allow-list: the kernels'
plain versions, which run on CPU tensors (and on the card only where a
smoke run compares a kernel with them).
"""

import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "padne_tpu_torch"

SCATTERS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
            "scatter_reduce", "scatter_reduce_", "index_reduce",
            "index_reduce_")
ACCUMULATING = ("index_put", "index_put_", "put_")
# (file, function): the plain versions of K3', K1' and K2'.
ALLOWED = {("ops/spmv.py", "ell_spmv_plain"),
           ("ops/dia.py", "sell_matvec_plain"),
           ("ops/comp.py", "comp_sell_plain")}


def _accumulates(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "accumulate":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is False)
    return len(call.args) >= 3


def scatter_sites(tree: ast.AST):
    """(function, line, name) of every scatter-add call in a module."""
    out = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else func)
            if isinstance(child, ast.Call):
                f = child.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else f.id if isinstance(f, ast.Name) else None)
                if name in SCATTERS or (name in ACCUMULATING
                                        and _accumulates(child)):
                    out.append((func, child.lineno, name))
            visit(child, inner)

    visit(tree, None)
    return out


def test_no_atomic_scatter_outside_the_plain_versions():
    found, allowed = [], set()
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        for func, line, name in scatter_sites(ast.parse(path.read_text())):
            if (rel, func) in ALLOWED:
                allowed.add((rel, func))
            else:
                found.append(f"padne_tpu_torch/{rel}:{line} {name} in "
                             f"{func}")
    assert not found, "atomic scatters on a device path:\n" + "\n".join(found)
    # The allow-list names only what exists.
    assert allowed == ALLOWED


def test_the_guard_sees_each_form():
    code = ("def f(a, i, x):\n"
            "    a.index_add_(0, i, x)\n"
            "    a.index_put_((i,), x, accumulate=True)\n"
            "    a.index_put_((i,), x, True)\n"
            "    a.index_put_((i,), x)\n"
            "    a.index_put_((i,), x, accumulate=False)\n"
            "    torch.scatter_add(a, 0, i, x)\n"
            "    a.scatter_reduce_(0, i, x, 'sum')\n")
    sites = scatter_sites(ast.parse(code))
    assert [(f, n) for f, _, n in sites] == [
        ("f", "index_add_"), ("f", "index_put_"), ("f", "index_put_"),
        ("f", "scatter_add"), ("f", "scatter_reduce_")]


def test_the_kernels_use_no_atomics():
    for path in sorted((PKG / "csrc").glob("*.cu")):
        assert "atomic" not in path.read_text(), path.name
