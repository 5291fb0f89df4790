"""device_idle.rails: device_idle.resolve's reading (the share of the
traced segment in which no operation ran on the device, in percent) in
the rail board's cell."""

from pdnbench import harness

read = harness.metric_reader("device_idle.resolve").read
