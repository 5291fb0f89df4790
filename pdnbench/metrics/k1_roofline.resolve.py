"""k1_roofline.resolve: K1' (ops.dia.sell_matvec, csrc/dia_sell.cu) in
the traced solves: the bytes its launches must move (arith.csr_bytes) at
the H100's published HBM bandwidth, over its kernel time, in percent."""


def read(run):
    return run.trace.roofline("sell_matvec") if run.trace else None
