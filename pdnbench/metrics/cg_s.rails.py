"""cg_s.rails: cg_s.resolve's reading (seconds a request in the
`cg.solve` spans, mean over the window's requests) in the rail board's
cell."""

from pdnbench import harness

read = harness.metric_reader("cg_s.resolve").read
