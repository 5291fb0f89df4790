"""SI value parsing and pretty-printing.

Functional parity with the reference units module (padne/units.py:45,91):
parse strings like ``"100mA"``, ``"3.3V"``, ``"1k"`` into a (value, unit)
pair, and format values back with an appropriate SI prefix.  Implemented
independently as a small total-function parser.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# (prefix symbol, power-of-ten). Order matters for formatting lookup.
_PREFIXES: tuple[tuple[str, int], ...] = (
    ("T", 12),
    ("G", 9),
    ("M", 6),
    ("k", 3),
    ("", 0),
    ("m", -3),
    ("μ", -6),
    ("n", -9),
    ("p", -12),
)

# ASCII spellings accepted on input only.
_INPUT_ALIASES = {"u": "μ"}

_PREFIX_MULT: dict[str, float] = {p: 10.0**e for p, e in _PREFIXES if p}
for _alias, _canon in _INPUT_ALIASES.items():
    _PREFIX_MULT[_alias] = _PREFIX_MULT[_canon]

_EXP_TO_PREFIX: dict[int, str] = {e: p for p, e in _PREFIXES}

# Units understood by the directive grammar: amps, volts, ohms ("R").
KNOWN_UNITS = frozenset({"A", "V", "R"})

_NUMBER_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


@dataclass(frozen=True)
class Value:
    """A physical value with an optional unit symbol."""

    value: float
    unit: str

    @classmethod
    def parse(cls, s: str) -> "Value":
        """Parse ``"100mA"`` -> Value(0.1, "A"), ``"1e4A"`` -> Value(1e4, "A").

        Spaces are ignored.  Raises ValueError on malformed input.
        """
        if not s or not s.strip():
            raise ValueError(f"Empty value string: {s!r}")
        s = s.replace(" ", "")

        unit = ""
        if s and s[-1] in KNOWN_UNITS:
            unit = s[-1]
            s = s[:-1]

        mult = 1.0
        if s and s[-1] in _PREFIX_MULT:
            mult = _PREFIX_MULT[s[-1]]
            s = s[:-1]

        if not _NUMBER_RE.match(s):
            raise ValueError(f"Cannot parse numeric part: {s!r}")
        return cls(value=float(s) * mult, unit=unit)

    def pretty_format(self, decimal_places: int | None = None) -> str:
        """Format with an SI prefix; smart precision when decimal_places=None."""
        if self.value == 0:
            return f"0 {self.unit}"

        mag = abs(self.value)
        if mag < 1e-10:
            return f"0 {self.unit}"

        exp = 0
        if mag >= 1:
            while mag >= 1000 and exp < 12:
                mag /= 1000
                exp += 3
        else:
            while mag < 1 and exp > -12:
                mag *= 1000
                exp -= 3

        if decimal_places is not None:
            text = f"{mag:.{decimal_places}f}"
        else:
            if mag >= 100:
                text = f"{mag:.1f}"
            elif mag >= 10:
                text = f"{mag:.2f}"
            else:
                text = f"{mag:.3f}"
            if "." in text:
                text = text.rstrip("0").rstrip(".")

        if self.value < 0:
            text = "-" + text
        return f"{text} {_EXP_TO_PREFIX[exp]}{self.unit}"
