"""S-expression wire codec.

The port's copy of ``aiko_services_tpu/utils/sexpr.py`` (it has no JAX in
it), the pure-Python codec only: the reference also loads a C codec
(``native/sexpr_module.c``) when one is built, which the port leaves out.
Both give the same strings and trees (``tests/test_torch_wire.py``).

The control-plane wire format of the framework: UTF-8 S-expressions with
three extensions (behavior-compatible with the reference implementation,
upstream aiko_services ``main/utilities/parser.py:85-217``, but
written as a tokenizer/emitter pair rather than a char-append scanner):

* **Canonical (length-prefixed) symbols** — ``3:a b`` is the three-byte
  symbol ``"a b"``; ``0:`` encodes ``None``.  Any symbol containing
  whitespace, parentheses, or a leading ``\\d+:`` pattern is emitted in
  canonical form so that ``parse(generate(x)) == x``.
* **Quoted strings** — ``'aloha honua'`` / ``"aloha honua"`` parse to the
  inner text (accepted on input; canonical form is used on output).
* **Keyword dictionaries** — ``(a: 1 b: 2)`` parses to
  ``{"a": "1", "b": "2"}``.  Mixing keywords and positional items is an
  error, matching the reference's contract.

``parse()`` returns ``(command, parameters)`` where ``command`` is the head
symbol of the payload list — the shape every protocol handler dispatches on.
``parse_tree()`` returns the raw tree for callers that want it.

The invariant tested by ``tests/test_sexpr.py``::

    parse(generate(command, parameters)) == (command, parameters)
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union

__all__ = [
    "generate", "generate_expression", "parse", "parse_tree",
    "parse_int", "parse_float", "parse_number",
]

# A symbol must be emitted length-prefixed when it contains a delimiter or
# could be mistaken for a length prefix, quoted string, or dict keyword
# (trailing ":") on re-parse.
_NEEDS_CANONICAL = re.compile(r"^\d+:|^['\"]|[\s()]|:$")
# The same test split up, so that a symbol of many megabytes (a base64 KV
# payload) is checked at memory speed: the alternation above tries every
# branch at every position, and even the one character class below costs
# many times a ``str`` scan per character (``scripts/codec_scan.py`` times
# both on a KV export message).  An ASCII symbol is searched for each
# delimiter in turn (the ASCII characters ``\s`` matches, and the
# parentheses); any other takes the regular expression.
_LENGTH_PREFIX = re.compile(r"\d+:")
_DELIMITER = re.compile(r"[\s()]")
_ASCII_DELIMITERS = "\t\n\x0b\x0c\r\x1c\x1d\x1e\x1f ()"


def _needs_canonical(symbol: str) -> bool:
    """``_NEEDS_CANONICAL.search(symbol)``, computed faster."""
    if symbol[:1] in ("'", '"') or symbol.endswith(":") \
            or _LENGTH_PREFIX.match(symbol) is not None:
        return True
    if symbol.isascii():
        return any(c in symbol for c in _ASCII_DELIMITERS)
    return _DELIMITER.search(symbol) is not None


class _Keyword(str):
    """A *bare* symbol ending in ':' — the only token form that introduces
    a dictionary.  Canonical ('2:a:') and quoted ("'a:'") atoms parse to
    plain ``str`` and are never treated as keywords, so any symbol value
    survives the wire round-trip."""
    __slots__ = ()


def generate(command: str, parameters: Union[Dict, List, Tuple, None] = None) -> str:
    """Serialize ``(command, parameters)`` into one S-expression payload."""
    items: List[Any] = [command]
    if parameters is None:
        parameters = []
    if isinstance(parameters, dict):
        items.extend(_dict_to_items(parameters))
    else:
        items.extend(parameters)
    return generate_expression(items)


def generate_expression(expression: Union[List, Tuple]) -> str:
    """Serialize a (possibly nested) list into an S-expression string.
    The pieces of every level go into one list joined once, so a payload
    of many megabytes is copied once, not once a level."""
    pieces: List[str] = []
    _emit_list(expression, pieces)
    return "".join(pieces)


def _emit_list(expression, pieces: List[str]) -> None:
    pieces.append("(")
    for index, element in enumerate(expression):
        if index:
            pieces.append(" ")
        if isinstance(element, dict):
            _emit_list(_dict_to_items(element), pieces)
        elif isinstance(element, (list, tuple)):
            _emit_list(element, pieces)
        else:
            pieces.append(_emit(element))
    pieces.append(")")


def _dict_to_items(mapping: Dict) -> List[Any]:
    items: List[Any] = []
    for keyword, value in mapping.items():
        keyword = f"{keyword}:"
        if _NEEDS_CANONICAL.search(keyword[:-1]) or keyword == ":":
            raise SExprError(
                f"Dictionary keyword {keyword[:-1]!r} must be a simple symbol")
        items.append(_Keyword(keyword))
        items.append(value)
    return items


def _emit(element: Any) -> str:
    """One atom (lists and dicts are :func:`_emit_list`'s)."""
    if element is None:
        return "0:"
    if isinstance(element, bool):
        return "true" if element else "false"
    if not isinstance(element, str):
        element = str(element)
    if element == "":
        return '""'
    if isinstance(element, _Keyword):
        return str(element)  # dict keywords stay bare by construction
    if _needs_canonical(element):
        return f"{len(element)}:{element}"
    return element


# --------------------------------------------------------------------------- #
# Parsing: tokenizer + recursive-descent reader.

_WHITESPACE = " \t\r\n"
#: What ends a bare symbol, the most frequent first.
_BARE_ENDS = _WHITESPACE + "()"


def _bare_end(payload: str, start: int, n: int) -> int:
    """Index of the first whitespace or parenthesis at or after
    ``start`` (``n`` if none): one bounded ``find`` a delimiter, so a
    symbol of many megabytes is scanned at memory speed."""
    end = n
    for c in _BARE_ENDS:
        found = payload.find(c, start, end)
        if found >= 0:
            end = found
    return end


class SExprError(ValueError):
    pass


def _tokenize(payload: str):
    """Yield tokens: "(", ")", or (symbol, value) pairs."""
    i, n = 0, len(payload)
    while i < n:
        c = payload[i]
        if c in _WHITESPACE:
            i += 1
            continue
        if c in "()":
            yield c
            i += 1
            continue
        if c in "'\"":
            j = payload.find(c, i + 1)
            if j < 0:
                raise SExprError(f"Unterminated quoted string at {i}")
            yield ("atom", payload[i + 1:j])
            i = j + 1
            continue
        # Canonical length-prefixed symbol: <len>:<bytes>
        if c.isdigit():
            j = i
            while j < n and payload[j].isdigit():
                j += 1
            if j < n and payload[j] == ":":
                length = int(payload[i:j])
                start = j + 1
                if length == 0:
                    yield ("atom", None)
                    i = start
                    continue
                if start + length > n:
                    raise SExprError(f"Canonical symbol overruns payload at {i}")
                yield ("atom", payload[start:start + length])
                i = start + length
                continue
        # Bare symbol: runs until whitespace or paren.
        j = _bare_end(payload, i, n)
        token = payload[i:j]
        if token.endswith(":") and len(token) > 1:
            token = _Keyword(token)
        yield ("atom", token)
        i = j


def parse_tree(payload: str, dictionaries: bool = True) -> Any:
    """Parse a payload into its raw tree (lists / dicts / symbols)."""
    tokens = list(_tokenize(payload))
    pos = 0

    def read():
        nonlocal pos
        if pos >= len(tokens):
            raise SExprError("Unexpected end of payload")
        token = tokens[pos]
        pos += 1
        if token == "(":
            items = []
            while True:
                if pos >= len(tokens):
                    raise SExprError("Unbalanced '(' in payload")
                if tokens[pos] == ")":
                    pos += 1
                    return items
                items.append(read())
        if token == ")":
            raise SExprError("Unbalanced ')' in payload")
        return token[1]

    tree = read()
    if pos != len(tokens):
        # Multiple top-level atoms/lists: collect them (reference accepts
        # "3:a b 3:c d" style payloads that are flat symbol sequences).
        items = [tree]
        while pos < len(tokens):
            items.append(read())
        tree = items
    if dictionaries:
        tree = _listify_dicts(tree)
    return tree


def _listify_dicts(tree: Any) -> Any:
    if not isinstance(tree, list) or not tree:
        return tree
    head = tree[0]
    if isinstance(head, _Keyword):
        if len(tree) % 2:
            raise SExprError(
                f"Dictionary starting at {head!r} needs keyword/value pairs")
        result: Dict[str, Any] = {}
        for k, v in zip(tree[0::2], tree[1::2]):
            if not isinstance(k, _Keyword):
                raise SExprError(f"Expected keyword, got {k!r}")
            result[str(k)[:-1]] = _listify_dicts(v)
        return result
    return [_listify_dicts(item) for item in tree]


def parse(payload: str, dictionaries: bool = True) -> Tuple[str, Any]:
    """Parse a payload into ``(command, parameters)``.

    The head symbol of the outer list is the command; the tail is the
    parameter list (or dict when keyword pairs are used).  A bare atom
    parses to ``(atom, [])``.
    """
    tree = parse_tree(payload, dictionaries=False)
    if isinstance(tree, str) or tree is None:
        command, rest = tree or "", []
    elif not tree:
        command, rest = "", []
    elif isinstance(tree[0], str):
        command, rest = tree[0], tree[1:]
    else:
        inner = tree[0]
        command = inner[0] if inner else ""
        rest = inner[1:] if inner else []
    if dictionaries:
        rest = _listify_dicts(rest)
    return command, rest


def parse_int(payload: str, default: int = 0) -> int:
    try:
        return int(payload)
    except (TypeError, ValueError):
        return default


def parse_float(payload: str, default: float = 0.0) -> float:
    try:
        return float(payload)
    except (TypeError, ValueError):
        return default


def parse_number(payload: str, default: Union[int, float] = 0):
    try:
        return int(payload)
    except (TypeError, ValueError):
        try:
            return float(payload)
        except (TypeError, ValueError):
            return default
