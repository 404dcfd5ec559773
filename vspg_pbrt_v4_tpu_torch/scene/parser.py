"""`.pbrt` scene-description parser (host-side Python; this package's copy
of the JAX package's ``scene/parser.py``, which it must not import: that
package's ``scene/__init__.py`` imports JAX).

Same grammar as the reference's tokenizer/parser (parser.h:116-125,
parser.cpp): whitespace-separated tokens, `#` comments, quoted strings,
bracketed parameter arrays, `Include`/`Import` files. Directives are emitted
as (name, args, params, file:line) tuples consumed by the scene builder —
the SAX-style ParserTarget split (parser.h:25) collapsed into a token list
since scene building is a host-side, one-shot operation here.

Parameter declarations are "type name" strings with pbrt's types:
integer float point2 point3 vector3 normal rgb/color blackbody spectrum
string bool texture.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple

import numpy as np


class Directive(NamedTuple):
    name: str
    args: list  # positional (unquoted numbers / quoted strings)
    params: dict  # name -> (type, values)
    loc: str  # "file:line"


_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')

# directives taking N positional numeric args
_NUMERIC_ARGS = {
    "LookAt": 9, "Translate": 3, "Rotate": 4, "Scale": 3,
    "Transform": 16, "ConcatTransform": 16,
    "TransformTimes": 2,  # motion-blur keyframe times (parser.h)
}
# directives taking one quoted type then params
_TYPED = {
    "Integrator", "Sampler", "Film", "Filter", "PixelFilter", "Camera",
    "Shape", "Material", "LightSource", "AreaLightSource", "Accelerator",
    "CoordinateSystem", "CoordSysTransform", "ColorSpace",
}
_SIMPLE = {
    "WorldBegin", "WorldEnd", "AttributeBegin", "AttributeEnd",
    "TransformBegin", "TransformEnd", "ObjectEnd", "ReverseOrientation",
    "Identity",
}


def _tokenize(text, filename="<string>"):
    for lineno, line in enumerate(text.split("\n"), 1):
        hash_pos = -1
        # respect '#' inside quotes
        in_q = False
        for i, c in enumerate(line):
            if c == '"':
                in_q = not in_q
            elif c == "#" and not in_q:
                hash_pos = i
                break
        if hash_pos >= 0:
            line = line[:hash_pos]
        for m in _TOKEN_RE.finditer(line):
            yield m.group(0), f"{filename}:{lineno}"


def _parse_value(tok):
    if tok.startswith('"'):
        return tok[1:-1]
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        return float(tok)


_PARAM_DECL_RE = re.compile(
    r"^(integer|float|point2|point3|point|vector3|vector|normal|rgb|color|"
    r"blackbody|spectrum|string|bool|texture)\s+(\S+)$"
)


def parse_pbrt_string(text, filename="<string>", search_path="."):
    """Parse text into a list of Directives (Include/Import expanded)."""
    tokens = list(_tokenize(text, filename))
    out = []
    i = 0
    n = len(tokens)

    def read_bracketed(i):
        vals = []
        if i < n and tokens[i][0] == "[":
            i += 1
            while i < n and tokens[i][0] != "]":
                vals.append(_parse_value(tokens[i][0]))
                i += 1
            i += 1  # skip ]
        else:
            vals.append(_parse_value(tokens[i][0]))
            i += 1
        return vals, i

    while i < n:
        tok, loc = tokens[i]
        if tok in ("Include", "Import"):
            fname = tokens[i + 1][0].strip('"')
            path = os.path.join(search_path, fname)
            try:
                with open(path) as f:
                    out.extend(parse_pbrt_string(
                        f.read(), fname, os.path.dirname(path) or "."))
            except OSError as e:
                raise PbrtError(f"couldn't open include file: {e}", loc)
            i += 2
            continue

        if tok in _SIMPLE:
            out.append(Directive(tok, [], {}, loc))
            i += 1
            continue

        if tok == "ActiveTransform":
            # one bare identifier: All | StartTime | EndTime
            out.append(Directive(tok, [tokens[i + 1][0]], {}, loc))
            i += 2
            continue

        if tok in _NUMERIC_ARGS:
            cnt = _NUMERIC_ARGS[tok]
            args = [_parse_value(tokens[i + 1 + k][0]) for k in range(cnt)]
            out.append(Directive(tok, args, {}, loc))
            i += 1 + cnt
            continue

        # typed directives + the named ones (Texture, MakeNamedMaterial, ...)
        args = []
        i += 1
        # positional quoted args
        n_args = {
            "Texture": 3, "MakeNamedMaterial": 1, "NamedMaterial": 1,
            "MakeNamedMedium": 1, "MediumInterface": 2, "ObjectBegin": 1,
            "ObjectInstance": 1, "AttributeBegin": 0,
        }.get(tok, 1 if tok in _TYPED else 0)
        for _ in range(n_args):
            if i < n and tokens[i][0].startswith('"'):
                args.append(tokens[i][0][1:-1])
                i += 1
            else:
                break

        params = {}
        while i < n:
            t2 = tokens[i][0]
            if not t2.startswith('"'):
                break
            decl = t2[1:-1]
            m = _PARAM_DECL_RE.match(decl)
            if not m:
                break  # next directive's quoted arg
            ptype, pname = m.group(1), m.group(2)
            i += 1
            vals, i = read_bracketed(i)
            params[pname] = (ptype, vals)
        out.append(Directive(tok, args, params, loc))
    return out


def parse_pbrt_file(path):
    with open(path) as f:
        return parse_pbrt_string(f.read(), os.path.basename(path),
                                 os.path.dirname(path) or ".")


class ParameterDictionary:
    """Typed parameter lookups with defaults (paramdict.h:97 analog)."""

    def __init__(self, params):
        self.params = dict(params)
        self.used = set()

    def _get(self, name, default):
        if name in self.params:
            self.used.add(name)
            return self.params[name][1]
        return None

    def get_float(self, name, default=None):
        v = self._get(name, default)
        return float(v[0]) if v is not None else default

    def get_int(self, name, default=None):
        v = self._get(name, default)
        return int(v[0]) if v is not None else default

    def get_bool(self, name, default=None):
        v = self._get(name, default)
        return bool(v[0]) if v is not None else default

    def get_string(self, name, default=None):
        v = self._get(name, default)
        return str(v[0]) if v is not None else default

    def get_rgb(self, name, default=None):
        v = self._get(name, default)
        if v is None:
            return default
        ptype = self.params[name][0]
        if ptype == "blackbody":
            from ..utils.spectrum import blackbody_normalized_rgb

            return np.clip(blackbody_normalized_rgb(float(v[0])), 0, None)
        if len(v) == 1:
            return np.asarray([v[0]] * 3, np.float32)
        return np.asarray(v[:3], np.float32)

    def get_point3(self, name, default=None):
        v = self._get(name, default)
        return np.asarray(v[:3], np.float32) if v is not None else default

    def get_floats(self, name):
        v = self._get(name, None)
        return np.asarray(v, np.float32) if v is not None else None

    def get_ints(self, name):
        v = self._get(name, None)
        return np.asarray(v, np.int32) if v is not None else None

    def unused(self):
        return [k for k in self.params if k not in self.used]


class PbrtError(Exception):
    """Scene-file error with FileLoc context (util/error.h ErrorExit:
    '<file>:<line>: error: <msg>'). The CLI catches this and prints the
    pbrt-style diagnostic instead of a traceback."""

    def __init__(self, msg, loc=None):
        self.loc = loc
        super().__init__(f"{loc}: {msg}" if loc else msg)
