from . import validation  # noqa: F401
