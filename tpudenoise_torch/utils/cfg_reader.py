"""A reader for the subset of YAML that the repo's cfg files use, without
yaml (the GPU machine has none).

The subset: block mappings nested by indentation (spaces only), `#`
comments, blank lines, and as values scalars or one-line flow lists
(`[800]`, `[2, 4, 8, 16, 32]`, nested `[[608, 1024]]`).  Scalars resolve
as PyYAML's `safe_load` resolves them, which the JAX package reads the
same files with: decimal ints, floats with a dot (`0.001`, `1.0e-05`,
`.5`, `.inf`, `.nan`), `true`/`false` in three cases, `null`/`~`/empty,
and strings, bare or quoted.

Anything else raises ValueError naming the file and line, and the reader
never guesses: anchors, aliases, tags, block lists, block or multi-line
scalars, flow mappings, directives, tabs, duplicate keys, and the
scalars that YAML 1.1 (PyYAML) and YAML 1.2 read differently or that
look like numbers but are none of the forms above (`1e-3`, a string
under PyYAML; `None`, `yes`, `off`, `0x10`, `007`, `1_000`, dates).
Quote such a value to make it a string, or write `1.0e-03` for the
float.
"""

from __future__ import annotations

import math
import re

_INT = re.compile(r'[-+]?(0|[1-9][0-9]*)')
_FLOAT = re.compile(r'[-+]?[0-9]+\.[0-9]*([eE][-+][0-9]+)?'
                    r'|\.[0-9]+([eE][-+][0-9]+)?')
_SPECIAL_FLOATS = {'.inf': math.inf, '.Inf': math.inf, '.INF': math.inf,
                   '+.inf': math.inf, '+.Inf': math.inf, '+.INF': math.inf,
                   '-.inf': -math.inf, '-.Inf': -math.inf,
                   '-.INF': -math.inf,
                   '.nan': math.nan, '.NaN': math.nan, '.NAN': math.nan}
_BOOLS = {'true': True, 'True': True, 'TRUE': True,
          'false': False, 'False': False, 'FALSE': False}
_NULLS = ('', '~', 'null', 'Null', 'NULL')
# plain words that YAML 1.1 and 1.2 (or Python and YAML) read differently
_AMBIGUOUS = {'yes', 'Yes', 'YES', 'no', 'No', 'NO', 'on', 'On', 'ON',
              'off', 'Off', 'OFF', 'None', 'NONE'}
_KEY = re.compile(r'[A-Za-z_][A-Za-z0-9_]*')
# characters that start something other than a plain scalar
_INDICATORS = set('&*!|>%@`{}[]#\'"') | {'- ', '? ', '-', '?'}
_ESCAPES = {'\\': '\\', '"': '"', '/': '/', 'n': '\n', 't': '\t',
            'r': '\r', '0': '\0'}


class _Source:
    def __init__(self, name: str):
        self.name = name

    def error(self, lineno: int, what: str) -> ValueError:
        return ValueError(f'{self.name}:{lineno}: {what} (outside the YAML '
                          f'subset of tpudenoise_torch.utils.cfg_reader)')


def _quoted(text: str, src: _Source, lineno: int) -> tuple:
    """(string, rest) for text that starts with a quote."""
    q = text[0]
    out = []
    i = 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return ''.join(out), text[i + 1:]
        if q == '"' and c == '"':
            return ''.join(out), text[i + 1:]
        if q == '"' and c == '\\':
            e = text[i + 1:i + 2]
            if e not in _ESCAPES:
                raise src.error(lineno, f'escape \\{e} in a double-quoted '
                                        f'string')
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise src.error(lineno, 'a quoted string that does not end on its line')


def _plain(text: str, src: _Source, lineno: int):
    """The value of a plain (unquoted) scalar, as PyYAML resolves it."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _AMBIGUOUS:
        raise src.error(lineno, f'{text!r} reads differently under YAML '
                                f'1.1 and 1.2 or Python; quote it')
    if text[0] in '-+.0123456789' and any(c.isdigit() for c in text):
        raise src.error(lineno, f'{text!r} looks like a number but is not '
                                f'a decimal int or a float with a dot; '
                                f'quote it for a string')
    if text in _INDICATORS or text[0] in _INDICATORS \
            or text[:2] in _INDICATORS or ': ' in text or text.endswith(':'):
        raise src.error(lineno, f'{text!r}')
    return text


def _flow_list(text: str, src: _Source, lineno: int) -> tuple:
    """(list, rest) for text that starts with '['."""
    items = []
    rest = text[1:].lstrip()
    if rest.startswith(']'):
        return items, rest[1:]
    while True:
        if rest.startswith('['):
            item, rest = _flow_list(rest, src, lineno)
        elif rest[:1] in ('"', "'"):
            item, rest = _quoted(rest, src, lineno)
        else:
            m = re.match(r'[^,\[\]{}]*', rest)
            token = m.group(0).strip()
            if not token:
                raise src.error(lineno, 'an empty flow-list item')
            item, rest = _plain(token, src, lineno), rest[m.end():]
        items.append(item)
        rest = rest.lstrip()
        if rest.startswith(']'):
            return items, rest[1:]
        if not rest.startswith(','):
            raise src.error(lineno, 'a flow list that does not end on its '
                                    'line')
        rest = rest[1:].lstrip()
        if rest.startswith(']'):
            raise src.error(lineno, 'a trailing comma in a flow list')


def _comment_only(rest: str) -> bool:
    """rest is nothing, or a comment after white space."""
    return not rest.strip() or bool(re.match(r'\s+#', rest))


def _value(text: str, src: _Source, lineno: int):
    """The value of the text after `key: ` (no leading space; a comment
    may follow)."""
    if text.startswith('['):
        value, rest = _flow_list(text, src, lineno)
    elif text[:1] in ('"', "'"):
        value, rest = _quoted(text, src, lineno)
    else:
        cut = text.find(' #')
        return _plain(text if cut < 0 else text[:cut].rstrip(), src, lineno)
    if not _comment_only(rest):
        raise src.error(lineno, f'{rest.strip()!r} after a value')
    return value


def _lines(text: str, src: _Source) -> list:
    """(lineno, indent, content) of each line that holds something."""
    out = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if '\t' in line:
            raise src.error(lineno, 'a tab')
        content = line.strip()
        if not content or content.startswith('#'):
            continue
        if line.startswith(('---', '...', '%')):
            raise src.error(lineno, 'a document marker or directive')
        out.append((lineno, len(line) - len(line.lstrip(' ')), content))
    return out


def _mapping(lines: list, pos: int, indent: int, src: _Source) -> tuple:
    """(dict, next position) of the block mapping whose keys stand at
    `indent`, starting at lines[pos]."""
    out = {}
    while pos < len(lines):
        lineno, ind, content = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise src.error(lineno, 'an indentation that matches no '
                                    'mapping level (a multi-line scalar?)')
        if content.startswith('- ') or content == '-':
            raise src.error(lineno, 'a block list; write a flow list '
                                    '[a, b]')
        key, sep, rest = content.partition(':')
        if not sep or (rest and rest[0] != ' '):
            raise src.error(lineno, 'a line that is not `key: value`')
        if not _KEY.fullmatch(key) or key in _BOOLS or key in _NULLS \
                or key in _AMBIGUOUS:
            raise src.error(lineno, f'key {key!r} (keys are plain words)')
        if key in out:
            raise src.error(lineno, f'duplicate key {key!r}')
        rest = rest.strip()
        if rest.startswith('#'):
            rest = ''
        pos += 1
        nested = pos < len(lines) and lines[pos][1] > indent
        if rest:
            out[key] = _value(rest, src, lineno)
            if nested:
                raise src.error(lines[pos][0], 'an indented line after a '
                                               'value (a multi-line '
                                               'scalar?)')
        elif nested:
            out[key], pos = _mapping(lines, pos, lines[pos][1], src)
        else:
            out[key] = None
    return out, pos


def loads(text: str, name: str = '<string>'):
    """The mapping a cfg text holds (None for a text with no content), as
    `yaml.safe_load` reads it."""
    src = _Source(name)
    lines = _lines(text, src)
    if not lines:
        return None
    if ':' not in lines[0][2] or lines[0][2].startswith(('[', '"', "'")):
        raise src.error(lines[0][0], 'a document that is not a mapping')
    out, pos = _mapping(lines, 0, lines[0][1], src)
    if pos < len(lines):
        raise src.error(lines[pos][0], 'an indentation that matches no '
                                       'mapping level')
    return out


def load(path: str):
    """`loads` of a file's text, errors naming the file."""
    with open(path, 'r') as f:
        return loads(f.read(), path)
