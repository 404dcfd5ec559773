"""Leveled logging + CHECK assertions (util/log.h + util/check.h analog;
this package's copy of the JAX package's ``utils/log.py``).

The reference routes diagnostics through LOG_VERBOSE/ERROR/FATAL with a
process-wide level set by ``--log-level`` and an optional ``--log-file``
(util/log.h:26, util/log.cpp:421), and aborts through CHECK macros whose
registered callbacks print render context ("failed at pixel (x,y) sample
s — debug with --debugstart", util/check.h + cpu/integrators.cpp:99-104).

Plain host-side Python (device code cannot log; NaN/pixel diagnostics
live in the film scrubber and --debugstart instead), one module-level
state, stderr by default.
"""

from __future__ import annotations

import sys
import time

VERBOSE, WARNING, ERROR, FATAL = 0, 1, 2, 3
_NAMES = {"verbose": VERBOSE, "warning": WARNING, "error": ERROR,
          "fatal": FATAL}

_state = {"level": WARNING, "file": None, "t0": time.time()}


class CheckError(AssertionError):
    """CHECK failure (util/check.h) — carries the registered context."""


_check_callbacks = []


def set_level(level):
    """level: int or one of 'verbose'|'warning'|'error'|'fatal'."""
    _state["level"] = _NAMES.get(level, level) if isinstance(level, str) \
        else int(level)


def set_file(path):
    """Mirror log lines to `path` (append) instead of stderr only."""
    _state["file"] = open(path, "a") if path else None


def _emit(tag, msg):
    dt = time.time() - _state["t0"]
    line = f"[{dt:9.3f}s {tag}] {msg}"
    print(line, file=sys.stderr)
    if _state["file"] is not None:
        print(line, file=_state["file"], flush=True)


def verbose(msg, *args):
    if _state["level"] <= VERBOSE:
        _emit("VERBOSE", msg % args if args else msg)


def warning(msg, *args):
    if _state["level"] <= WARNING:
        _emit("WARNING", msg % args if args else msg)


def error(msg, *args):
    if _state["level"] <= ERROR:
        _emit("ERROR", msg % args if args else msg)


def fatal(msg, *args):
    """LOG_FATAL: emit and raise (the reference aborts)."""
    _emit("FATAL", msg % args if args else msg)
    raise CheckError(msg % args if args else msg)


def register_check_callback(fn):
    """fn() -> str, called on CHECK failure to add context (the
    CheckCallbackScope pattern — integrators register a 'rendering pixel
    (x,y) sample s' describer). Returns a remover."""
    _check_callbacks.append(fn)

    def remove():
        if fn in _check_callbacks:
            _check_callbacks.remove(fn)

    return remove


def check(cond, msg="CHECK failed", *args):
    """CHECK(cond): raise CheckError with registered context on failure.
    Host-side only — for device-side data use film's NaN scrubber and
    --debugstart replay."""
    if not cond:
        text = msg % args if args else msg
        for fn in _check_callbacks:
            try:
                text += "\n  " + str(fn())
            except Exception:
                pass
        _emit("CHECK", text)
        raise CheckError(text)
