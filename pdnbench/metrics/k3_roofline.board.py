"""k3_roofline.board: K3' (ops.spmv.ell_spmv, csrc/ell_spmv.cu) in
the traced boards: the bytes its launches must move (arith.csr_bytes) at
the H100's published HBM bandwidth, over its kernel time, in percent."""


def read(run):
    return run.trace.roofline("ell_spmv") if run.trace else None
