"""passes.rails: passes.resolve's reading (refinement passes a solve,
mean over the window) in the rail board's cell."""

from pdnbench import harness

read = harness.metric_reader("passes.resolve").read
