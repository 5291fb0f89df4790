"""The benchmark's inputs handed to the program in its own types."""

from __future__ import annotations


def core_system(inp, ell, r_core, rhs):
    """padne_tpu_torch.ops.schur.CoreSystem over the arrays of the frozen
    inputs `inp`, the frozen EllMatrix `ell` and this excitation (shared,
    not copied)."""
    from padne_tpu_torch.ops import assembly, schur

    border = schur.BorderSpec(
        m=inp.m, row_idx=inp.b_row_idx, row_node=inp.b_row_node,
        row_val=inp.b_row_val, col_idx=inp.b_col_idx,
        col_node=inp.b_col_node, col_val=inp.b_col_val, rhs=rhs)
    return schur.CoreSystem(
        n=inp.n, ell=assembly.EllMatrix(cols=ell.cols, vals=ell.vals,
                                        diag=ell.diag),
        comp_id=inp.comp_id, num_components=int(inp.num_components),
        border=border, r_core=r_core, ground_var=int(inp.ground_var),
        coords=inp.coords, group=inp.group)

