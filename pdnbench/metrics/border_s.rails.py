"""border_s.rails: border_s.resolve's reading (seconds a request of the
bordered solve's own host work outside the CG: the self seconds of the
`schur.*` spans, mean over the window's requests) in the rail board's
cell."""

from pdnbench import harness

read = harness.metric_reader("border_s.resolve").read
