"""Runtime contract checking.

The reference arms typeguard over its whole package and ships a
meta-test proving the checker is active (pyproject.toml:78-79,
padne/tests.py).  typeguard is not available here, so this module
provides the equivalent: a small annotation-driven runtime checker
(`@checked`) that validates argument/return types — including numpy
array shape/dtype specs — whenever PADNE_TPU_CHECKS=1 (the test suite
arms it), plus deliberately wrong functions used by the meta-test.

The C++ core has its own always-on layer: exact-predicate invariants and
`CDT::validate()` turn geometric degeneracies into clean Python
exceptions instead of crashes (the CGAL_DEBUG analog, see
native/src/pg_cdt.h).
"""

from __future__ import annotations

import functools
import os
import typing

import numpy as np


def checks_enabled() -> bool:
    return os.environ.get("PADNE_TPU_CHECKS", "0") == "1"


class Array:
    """Annotation for numpy array contracts: Array[dtype, ndim]."""

    def __class_getitem__(cls, spec):
        dtype, ndim = spec if isinstance(spec, tuple) else (spec, None)
        return ("padne_array", dtype, ndim)


def _check_value(name: str, value, annotation) -> None:
    if annotation is typing.Any or annotation is None:
        return
    if isinstance(annotation, tuple) and annotation and annotation[0] == "padne_array":
        _, dtype, ndim = annotation
        if not isinstance(value, np.ndarray):
            raise TypeError(f"{name}: expected ndarray, got {type(value).__name__}")
        if dtype is not None and not np.issubdtype(value.dtype, dtype):
            raise TypeError(
                f"{name}: expected dtype {dtype}, got {value.dtype}"
            )
        if ndim is not None and value.ndim != ndim:
            raise TypeError(f"{name}: expected ndim {ndim}, got {value.ndim}")
        return
    origin = typing.get_origin(annotation)
    if origin is not None:
        if origin in (list, tuple, set, dict):
            if not isinstance(value, origin):
                raise TypeError(
                    f"{name}: expected {origin.__name__}, got {type(value).__name__}"
                )
        return  # don't deep-check generics
    if isinstance(annotation, type):
        if annotation is float and isinstance(value, (int, np.floating)):
            return
        if annotation is int and isinstance(value, np.integer):
            return
        if not isinstance(value, annotation):
            raise TypeError(
                f"{name}: expected {annotation.__name__}, got {type(value).__name__}"
            )


def checked(fn):
    """Validate annotated arguments and return value at call time when
    PADNE_TPU_CHECKS=1; zero overhead otherwise."""
    hints = None
    sig = None

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        nonlocal hints, sig
        if not checks_enabled():
            return fn(*args, **kwargs)
        if hints is None:
            try:
                hints = typing.get_type_hints(fn)
            except Exception:
                hints = {}
        if sig is None:
            import inspect

            sig = inspect.signature(fn)

        bound = sig.bind(*args, **kwargs)
        for pname, pvalue in bound.arguments.items():
            if pname in hints:
                _check_value(pname, pvalue, hints[pname])
        result = fn(*args, **kwargs)
        if "return" in hints:
            _check_value("return", result, hints["return"])
        return result

    return wrapper


# --- deliberately wrong-typed functions for the armed-checker meta-test ---
@checked
def add_numbers(a: int, b: int) -> int:
    # Deliberately returns the wrong type so tests can prove the checker
    # is active (reference padne/tests.py pattern).
    return str(a + b)  # type: ignore[return-value]


@checked
def wrong_argument_type(values: np.ndarray) -> float:
    return float(np.sum(values))
