"""Minimal s-expression reader for KiCad file formats.

KiCad `.kicad_pcb` / `.kicad_sch` / `.kicad_pro`-adjacent files are nested
s-expressions of symbols, numbers and quoted strings.  This module parses
them into plain Python lists, with symbols represented by :class:`Symbol`
(so that `Symbol("yes") != "yes"` — quoted strings and bare tokens stay
distinguishable, matching how sexpdata behaves in the reference loader,
padne/kicad.py:153-225).

The parser is a single-pass tokenizer + recursive-descent reader; it is
not a general Lisp reader (no comments, no vectors) because KiCad never
emits those.
"""

from __future__ import annotations


class Symbol(str):
    """A bare (unquoted) token.  Subclasses str for painless comparison
    against other Symbols while remaining a distinct type from str."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Symbol({str.__repr__(self)})"


def _to_atom(token: str):
    """Convert a bare token to int, float, or Symbol."""
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return Symbol(token)


def loads(text: str):
    """Parse a single top-level s-expression from ``text``."""
    items, pos = _parse_many(text, 0)
    if pos < len(text):
        raise ValueError(f"Trailing content at position {pos}")
    if not items:
        raise ValueError("No s-expression found")
    if len(items) > 1:
        raise ValueError("Multiple top-level s-expressions found")
    return items[0]


def load(fp):
    """Parse a single s-expression from a file object."""
    return loads(fp.read())


def load_path(path):
    with open(path, "r", encoding="utf-8") as f:
        return load(f)


_WS = " \t\r\n"


def _parse_many(text: str, pos: int):
    """Parse s-expressions until EOF or an unmatched ')'."""
    out = []
    n = len(text)
    while True:
        while pos < n and text[pos] in _WS:
            pos += 1
        if pos >= n or text[pos] == ")":
            return out, pos
        val, pos = _parse_one(text, pos)
        out.append(val)


def _parse_one(text: str, pos: int):
    n = len(text)
    c = text[pos]
    if c == "(":
        items, pos = _parse_many(text, pos + 1)
        if pos >= n or text[pos] != ")":
            raise ValueError(f"Unbalanced parenthesis at position {pos}")
        return items, pos + 1
    if c == '"':
        return _parse_string(text, pos)
    # Bare token.
    start = pos
    while pos < n and text[pos] not in _WS and text[pos] not in "()\"":
        pos += 1
    if start == pos:
        raise ValueError(f"Unexpected character {text[pos]!r} at {pos}")
    return _to_atom(text[start:pos]), pos


def _parse_string(text: str, pos: int):
    """Parse a double-quoted string starting at ``pos``.

    KiCad escapes: ``\\"`` for a quote, ``\\\\`` for a backslash, ``\\n``
    for newline; raw newlines inside strings are also allowed.
    """
    assert text[pos] == '"'
    pos += 1
    n = len(text)
    chunks: list[str] = []
    while pos < n:
        c = text[pos]
        if c == '"':
            return "".join(chunks), pos + 1
        if c == "\\" and pos + 1 < n:
            esc = text[pos + 1]
            chunks.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
            pos += 2
            continue
        chunks.append(c)
        pos += 1
    raise ValueError("Unterminated string literal")


def is_list_with_head(node, head: str) -> bool:
    """True when ``node`` is a list whose first item is Symbol(head)."""
    return (
        isinstance(node, list)
        and len(node) > 0
        and isinstance(node[0], Symbol)
        and node[0] == head
    )


def find_all(node, head: str):
    """Recursively yield all sub-lists with the given head symbol."""
    if not isinstance(node, list):
        return
    if is_list_with_head(node, head):
        yield node
    for item in node:
        yield from find_all(item, head)


def find_child(node, head: str):
    """Return the first direct child list with the given head, or None."""
    if not isinstance(node, list):
        return None
    for item in node:
        if is_list_with_head(item, head):
            return item
    return None


def find_children(node, head: str):
    """Return all direct child lists with the given head."""
    if not isinstance(node, list):
        return []
    return [item for item in node if is_list_with_head(item, head)]
