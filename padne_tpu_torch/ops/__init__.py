"""Numerical core of the port: host packing (numpy) and device stages
(torch), mirroring padne_tpu.ops module by module."""
