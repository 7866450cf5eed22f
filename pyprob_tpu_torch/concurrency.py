"""A persistent key/value shelf over sqlite3, and the codec of its values
(counterpart of ``pyprob_tpu/concurrency.py``).

``Shelf`` maps string keys to values stored as zlib-compressed pickles
(``set_compression`` picks the zlib level).  ``ConcurrentShelf`` retries a
read or write that finds the database locked by another process, with a
random back-off, until ``time_out_seconds``.  Bulk writes go through the
public ``transaction()`` context manager: every write inside it lands in
one sqlite transaction, committed when the block ends and rolled back if
it raises (``ConcurrentShelf.lock``/``unlock`` are the JAX package's names
for the same).

The pickles hold only numpy arrays and plain Python data.  ``encode``
turns the port's records into that first: a tensor (on any device) into
its numpy array on the host, a distribution, ``Variable`` or ``Trace``
into a tagged dict of its fields, rebuilt by ``decode`` with CPU tensors.
``decode`` unpickles with a loader that refuses any class other than
numpy's arrays, scalars and dtypes.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import pickle
import random
import sqlite3
import time
import zlib

import numpy as np
import torch

_zlib_level = -1


def set_compression(level=-1):
    """The zlib level of values written from now on (-1: zlib's default)."""
    global _zlib_level
    _zlib_level = int(level)


# ---------------------------------------------------------------------------
# the codec: the port's records as plain data
# ---------------------------------------------------------------------------

_TRACE_GROUPS = (
    "variables_controlled",
    "variables_uncontrolled",
    "variables_observed",
    "variables_observable",
    "variables_tagged",
)
_TRACE_REBUILT = _TRACE_GROUPS + ("variables", "variables_dict_address", "variables_dict_address_base",
                                  "named_variables")


_PLAIN = (bool, int, float, complex, str, bytes, np.ndarray, np.generic)


@functools.lru_cache(maxsize=None)
def _records():
    """The port's record types (imported on first use: they import this
    module's users)."""
    from . import distributions
    from .distributions.distribution import Distribution
    from .trace import Trace, Variable

    return distributions, Distribution, Trace, Variable


def to_plain(obj):
    """``obj`` as numpy arrays and plain Python data (see the module
    docstring); raises TypeError for anything else."""
    if obj is None or isinstance(obj, _PLAIN):
        return obj
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": obj.detach().to("cpu", copy=True).numpy()}
    if isinstance(obj, list):
        return [to_plain(v) for v in obj]
    if isinstance(obj, tuple):
        return {"__tuple__": [to_plain(v) for v in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            return {"__items__": [(to_plain(k), to_plain(v)) for k, v in obj.items()]}
        return {"__dict__": {k: to_plain(v) for k, v in obj.items()}}
    _, Distribution, Trace, Variable = _records()
    if isinstance(obj, Distribution):
        return {
            "__distribution__": type(obj).__name__,
            # a Factor's log-density function does not travel
            "state": {k: None if callable(v) else to_plain(v) for k, v in vars(obj).items()},
        }
    if isinstance(obj, Variable):
        return {"__variable__": {k: to_plain(v) for k, v in vars(obj).items()}}
    if isinstance(obj, Trace):
        index = {id(v): i for i, v in enumerate(obj.variables)}
        return {
            "__trace__": [to_plain(v) for v in obj.variables],
            "groups": {g: [index[id(v)] for v in getattr(obj, g)] for g in _TRACE_GROUPS},
            "fields": {k: to_plain(v) for k, v in vars(obj).items() if k not in _TRACE_REBUILT},
        }
    raise TypeError(f"cannot store a {type(obj).__name__} (only numpy arrays, plain data and the port's records)")


def from_plain(obj):
    """The inverse of ``to_plain``; tensors come back on the CPU."""
    kind = type(obj)
    if kind is list:
        return [from_plain(v) for v in obj]
    if kind is not dict:
        return obj
    distributions, _, Trace, Variable = _records()
    if "__tensor__" in obj:
        return torch.from_numpy(np.array(obj["__tensor__"]))
    if "__tuple__" in obj:
        return tuple(from_plain(v) for v in obj["__tuple__"])
    if "__dict__" in obj:
        return {k: from_plain(v) for k, v in obj["__dict__"].items()}
    if "__items__" in obj:
        return {from_plain(k): from_plain(v) for k, v in obj["__items__"]}
    if "__distribution__" in obj:
        cls = getattr(distributions, obj["__distribution__"])
        d = cls.__new__(cls)
        d.__dict__.update({k: from_plain(v) for k, v in obj["state"].items()})
        return d
    if "__variable__" in obj:
        v = Variable.__new__(Variable)
        v.__dict__.update({k: from_plain(val) for k, val in obj["__variable__"].items()})
        return v
    if "__trace__" in obj:
        variables = [from_plain(v) for v in obj["__trace__"]]
        t = Trace()
        for v in variables:
            t.add(v)
        for g, idx in obj["groups"].items():
            setattr(t, g, [variables[i] for i in idx])
        t.named_variables = {v.name: v for v in variables if v.name is not None}
        for k, v in obj["fields"].items():
            setattr(t, k, from_plain(v))
        return t
    raise ValueError(f"unknown stored record: {sorted(obj)}")


class _PlainUnpickler(pickle.Unpickler):
    """Unpickles plain Python data and numpy arrays, scalars and dtypes only."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and (
            name in ("_reconstruct", "_frombuffer", "scalar", "ndarray", "dtype") or module == "numpy.dtypes"
        ):
            return super().find_class(module, name)
        if module == "builtins" and name in ("complex", "set", "frozenset", "slice", "range", "bytearray"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def encode(obj):
    return zlib.compress(pickle.dumps(to_plain(obj), protocol=pickle.HIGHEST_PROTOCOL), _zlib_level)


def decode(blob):
    return from_plain(_PlainUnpickler(io.BytesIO(zlib.decompress(blob))).load())


# ---------------------------------------------------------------------------
# shelves
# ---------------------------------------------------------------------------


class Shelf:
    """Dict-like persistent store: str key -> an ``encode``d value."""

    def __init__(self, file_name, timeout=60.0):
        self._file_name = file_name
        os.makedirs(os.path.dirname(os.path.abspath(file_name)), exist_ok=True)
        self._conn = sqlite3.connect(file_name, timeout=timeout, check_same_thread=False)
        self._transaction_depth = 0
        self._conn.execute("CREATE TABLE IF NOT EXISTS shelf (key TEXT PRIMARY KEY, value BLOB)")
        self._conn.commit()

    @property
    def file_name(self):
        return self._file_name

    @contextlib.contextmanager
    def transaction(self, write=True):
        """Every write inside the block in one transaction: committed at
        its end, rolled back if it raises.  Nested blocks join the outer
        one."""
        if self._transaction_depth:
            self._transaction_depth += 1
            try:
                yield self
            finally:
                self._transaction_depth -= 1
            return
        self._conn.execute("BEGIN IMMEDIATE" if write else "BEGIN")
        self._transaction_depth = 1
        try:
            yield self
        except BaseException:
            self._transaction_depth = 0
            self._conn.rollback()
            raise
        self._transaction_depth = 0
        self._conn.commit()

    def _autocommit(self):
        if not self._transaction_depth:
            self._conn.commit()

    def __getitem__(self, key):
        row = self._conn.execute("SELECT value FROM shelf WHERE key = ?", (str(key),)).fetchone()
        if row is None:
            raise KeyError(key)
        return decode(row[0])

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        self._conn.execute("INSERT OR REPLACE INTO shelf (key, value) VALUES (?, ?)", (str(key), encode(value)))
        self._autocommit()

    def __delitem__(self, key):
        self._conn.execute("DELETE FROM shelf WHERE key = ?", (str(key),))
        self._autocommit()

    def __contains__(self, key):
        return self._conn.execute("SELECT 1 FROM shelf WHERE key = ?", (str(key),)).fetchone() is not None

    def __len__(self):
        return self._conn.execute("SELECT COUNT(*) FROM shelf").fetchone()[0]

    def keys(self):
        return [r[0] for r in self._conn.execute("SELECT key FROM shelf")]

    def items(self):
        for k, v in self._conn.execute("SELECT key, value FROM shelf").fetchall():
            yield k, decode(v)

    def sync(self):
        if not self._transaction_depth:
            self._conn.commit()

    def close(self):
        try:
            self._transaction_depth = 0
            self._conn.commit()
            self._conn.close()
        except sqlite3.ProgrammingError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ConcurrentShelf:
    """A ``Shelf`` whose reads and writes retry, with a random back-off of
    10-200 ms, while another process holds the database locked, and raise
    TimeoutError after ``time_out_seconds``."""

    def __init__(self, file_name, time_out_seconds=60.0):
        self._file_name = file_name
        self._time_out_seconds = time_out_seconds
        self._shelf = Shelf(file_name, timeout=time_out_seconds)
        self._lock_cm = None

    @property
    def file_name(self):
        return self._file_name

    def _retry(self, fn, *args):
        start = time.time()
        while True:
            try:
                return fn(*args)
            except sqlite3.OperationalError as e:
                if "locked" not in str(e) and "busy" not in str(e):
                    raise
                if time.time() - start > self._time_out_seconds:
                    raise TimeoutError(f"Shelf lock timeout after {self._time_out_seconds}s: {self._file_name}") from e
                time.sleep(random.uniform(0.01, 0.2))

    def __getitem__(self, key):
        return self._retry(self._shelf.__getitem__, key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __setitem__(self, key, value):
        self._retry(self._shelf.__setitem__, key, value)

    def __contains__(self, key):
        return self._retry(self._shelf.__contains__, key)

    def __len__(self):
        return self._retry(self._shelf.__len__)

    def keys(self):
        return self._retry(self._shelf.keys)

    @contextlib.contextmanager
    def transaction(self, write=True):
        """``Shelf.transaction``, its start retried while the database is
        locked."""
        cm = self._shelf.transaction(write)
        self._retry(cm.__enter__)
        try:
            yield self
        except BaseException as e:
            if not cm.__exit__(type(e), e, e.__traceback__):
                raise
        else:
            cm.__exit__(None, None, None)

    def lock(self, write=True):
        """Begin a bulk write (``transaction`` without a block); pair with
        ``unlock``."""
        if self._lock_cm is None:
            self._lock_cm = self.transaction(write)
            self._lock_cm.__enter__()

    def unlock(self):
        if self._lock_cm is not None:
            cm, self._lock_cm = self._lock_cm, None
            cm.__exit__(None, None, None)

    def sync(self):
        self._shelf.sync()

    def close(self):
        self.unlock()
        self._shelf.close()
