"""Solution persistence and exporters of the port.

Submodules are imported where they are used (`from .io import solution`):
this package imports nothing itself.
"""
