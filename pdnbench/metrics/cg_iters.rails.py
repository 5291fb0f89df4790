"""cg_iters.rails: cg_iters.resolve's reading (CG iterations a request,
mean over the window) in the rail board's cell."""

from pdnbench import harness

read = harness.metric_reader("cg_iters.resolve").read
