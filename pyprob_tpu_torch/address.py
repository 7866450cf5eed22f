"""Stochastic-procedure address extraction.

Counterpart of ``pyprob_tpu/address.py:extract_address``, with the same
format ``{lineno}__{reversed name chain}__{DistributionSuffix}__{instance}``
(e.g. ``42__forward__mu__Normal__1``): the source line number of the
``sample``/``observe`` call and a source-text regex for the assignment
target, so the string is stable across interpreter versions.

The markers differ from the JAX package's: its internal marker
``"pyprob_tpu"`` is a prefix of this package's path, so this package skips
frames under ``pyprob_tpu_torch`` and treats its built-in model families
(``pyprob_tpu_torch/models``) as user code.
"""

from __future__ import annotations

import linecache
import re
import sys
from functools import lru_cache

_ASSIGN_RE = re.compile(r"^\s*([A-Za-z_][\w\.]*(?:\[[^\]]*\])?)\s*=[^=]")
_RETURN_RE = re.compile(r"^\s*return\b")

_INTERNAL_MARKERS = ("pyprob_tpu_torch",)
_USER_MARKERS = ("pyprob_tpu_torch/models",)


@lru_cache(maxsize=4096)
def _is_internal_frame(filename):
    filename = filename or ""
    if any(m in filename for m in _USER_MARKERS):
        return False
    return any(m in filename for m in _INTERNAL_MARKERS)


@lru_cache(maxsize=65536)
def _extract_target_of_assignment(filename, lineno):
    line = linecache.getline(filename, lineno)
    m = _ASSIGN_RE.match(line)
    if m:
        return m.group(1)
    if _RETURN_RE.match(line):
        return "return"
    return None


def extract_address(root_function_name):
    """Build an address base from the current Python call stack: walk out
    from the first non-framework frame, collecting function names up to
    (and including) the model's root function."""
    frame = sys._getframe(1)
    while frame is not None and _is_internal_frame(frame.f_code.co_filename):
        frame = frame.f_back
    if frame is None:
        return "0__unknown"
    lineno = frame.f_lineno
    names = [_extract_target_of_assignment(frame.f_code.co_filename, lineno) or "?"]
    while frame is not None:
        n = frame.f_code.co_name
        if _is_internal_frame(frame.f_code.co_filename):
            if n == root_function_name:
                break
            frame = frame.f_back
            continue
        if n.startswith("<") and n != "<listcomp>":
            break
        names.append(n)
        if n == root_function_name:
            break
        frame = frame.f_back
    return "{}__{}".format(lineno, "__".join(reversed(names)))
