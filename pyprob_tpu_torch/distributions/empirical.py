"""Empirical: weighted sample container, the posterior result type.

Counterpart of ``pyprob_tpu/distributions/empirical.py`` with its storage modes:
the add/finalize lifecycle, categorical-weight sampling, the transforms
(map, filter, reweight, reobserve, resample, thin, slices,
combine_duplicates, unweighted), the weighted statistics (moments, mode,
median, quantiles, HPD interval, extremes), density estimation and
provenance metadata.  Weight math is float64 on the host.

Values are kept in one of two ways.  Array-valued results (the batched
tier's, ``from_arrays``, an ndarray given as ``values``, and what a
transform maps to numbers of one shape) are one numpy array, and every
statistic over them is a vectorised numpy pass: ``mode`` and
``combine_duplicates`` bucket rows with ``np.unique`` in first-occurrence
order, where the JAX package pickles each value into a dict.  Any other
values (traces, mixed shapes, a list given as ``values``) are a list and
take the JAX package's loops.  Both give the same values in the same
order, and weights equal within float64 round-off (NaN values excepted:
``np.unique`` puts them in one bucket).

``file_name=`` keeps the values in a shelf file (``concurrency.Shelf``):
array values in blocks of up to 2^18 rows, other values (traces among
them, stored as plain data) in blocks of the values written together,
each block beside its float64 log weights, and the metadata, the name and
the ESS of the weights last written.  Reopening the file gives the same
values, log weights and statistics; its values are read at first use.
The layout is the port's own: a JAX package Empirical file does not open
here, nor the port's there.  ``concat_empiricals=`` and
``concat_empirical_file_names=`` join Empiricals in order, read-only.
``density_estimate`` fits its Gaussian mixture by
EM in numpy, where the JAX package calls scikit-learn.
"""

from __future__ import annotations

import enum
import math
import os
import pickle
import warnings

import numpy as np
import torch

from .. import util
from ..concurrency import Shelf
from .distribution import Distribution

_FILE_SYNC_EVERY = 25  # added values written to the file together
_BLOCK_ROWS = 1 << 18  # rows of array values per stored block


class EmpiricalType(enum.Enum):
    MEMORY = 0
    FILE = 1
    CONCAT_MEMORY = 2
    CONCAT_FILE = 3


def _host_value(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def values_of(values):
    """``values`` as one numpy array when every value is a number, a numpy
    value or a tensor, all of one shape; else as a list."""
    if isinstance(values, np.ndarray):
        return values
    numeric = (float, int, np.ndarray, np.generic, torch.Tensor)
    if values and all(isinstance(v, numeric) for v in values):
        arrays = [_host_value(v) for v in values]
        if len({a.shape for a in arrays}) == 1 and all(a.dtype.kind in "biuf" for a in arrays):
            return np.stack(arrays)
    return list(values)


def _log_sum_exp(ws):
    m = ws.max()
    return float(m + math.log(np.exp(ws - m).sum()))


class Empirical(Distribution):
    def __init__(
        self,
        values=None,
        log_weights=None,
        weights=None,
        file_name=None,
        file_read_only=False,
        file_sync_timeout=25,
        concat_empiricals=None,
        concat_empirical_file_names=None,
        name="Empirical",
        effective_sample_size=None,
    ):
        """``effective_sample_size``, when given, is the ESS already computed
        from these weights (the batched tier takes it from the device-side
        log-weight statistics).  ``file_name`` keeps the values in a shelf
        file (values given here or added later are appended to what the
        file holds); ``concat_empiricals`` / ``concat_empirical_file_names``
        join Empiricals, or the files of Empiricals, in order, read-only
        (with ``file_name``, a descriptor of the joined files is written
        there, so reopening it gives the concatenation again)."""
        super().__init__(name=name, address_suffix="Empirical", batch_shape=())
        self._type = EmpiricalType.MEMORY
        self._metadata = []
        self._vals = []
        self._log_weights = []
        self._finalized = False
        self._closed = False
        self._mean_cache = self._variance_cache = self._mode_cache = None
        self._file_name = file_name
        self._file_read_only = file_read_only
        self._shelf = None
        self._pending = []  # values added since the file was last written
        self._sources = None  # the joined Empiricals of a concatenation
        if concat_empiricals is not None:
            self._concatenate(EmpiricalType.CONCAT_MEMORY, list(concat_empiricals))
            self.add_metadata(op="concat", num_sources=len(self._sources))
            return
        if concat_empirical_file_names is not None:
            files = list(concat_empirical_file_names)
            self._concatenate(EmpiricalType.CONCAT_FILE, [Empirical(file_name=f, file_read_only=True) for f in files])
            self.add_metadata(op="concat_files", files=files)
            if file_name is not None:
                self._shelf = Shelf(file_name)
                self._shelf["concat_files"] = files
                self._shelf["name"] = name
            return
        if file_name is not None:
            if file_read_only and not os.path.exists(file_name):
                raise FileNotFoundError(f"No Empirical file: {file_name}")
            self._shelf = Shelf(file_name)
            concat_files = self._shelf.get("concat_files")
            if concat_files is not None:
                # a descriptor of joined files: reopen the concatenation
                self._shelf.close()
                self._shelf = None
                self._concatenate(
                    EmpiricalType.CONCAT_FILE, [Empirical(file_name=f, file_read_only=True) for f in concat_files]
                )
                self.add_metadata(op="concat_files", files=list(concat_files))
                return
            self._type = EmpiricalType.FILE
            self._name = self._shelf.get("name", name)
            self._metadata = list(self._shelf.get("metadata", []))
            blocks = self._shelf.get("blocks", [])
            self._log_weights = np.concatenate(
                [np.zeros(0)] + [self._shelf[f"log_weights_{k}"] for k in range(len(blocks))]
            )
            self._vals = None  # read at first use
            stored_ess = self._shelf.get("effective_sample_size")
            if len(self._log_weights):
                ess = stored_ess if stored_ess is not None and stored_ess[0] == len(self._log_weights) else None
                self._finalize(None if ess is None else ess[1])
        if values is None:
            return
        if log_weights is not None:
            lw = np.asarray(log_weights, dtype=np.float64).reshape(-1)
        elif weights is not None:
            lw = np.asarray(util.safe_log(np.asarray(weights, dtype=np.float64).reshape(-1)))
        else:
            lw = np.zeros(len(values), dtype=np.float64)
        if len(lw) != len(values):
            raise ValueError("values and weights must have equal length")
        values = values if isinstance(values, np.ndarray) else list(values)
        if self._type == EmpiricalType.FILE:
            if self._file_read_only:
                raise RuntimeError("Empirical file opened read-only")
            if len(self._log_weights):
                effective_sample_size = None  # the given ESS is of the new values only
                self._values = self._join([self._values, values])
                self._log_weights = np.concatenate([np.asarray(self._log_weights, np.float64), lw])
            else:
                self._values, self._log_weights = values, lw
            self._pending = [values]
            self._finalize(effective_sample_size)
            self._write_file()
        else:
            self._values = values
            self._log_weights = lw
            self._finalize(effective_sample_size)

    @classmethod
    def from_arrays(cls, values, log_weights=None, name="Empirical", effective_sample_size=None, file_name=None):
        """Bulk construction from arrays: the values as one array, NaN
        log-weights as −inf; with ``file_name``, appended to that file."""
        values = np.asarray(values)
        if log_weights is None:
            log_weights = np.zeros(len(values), dtype=np.float64)
        else:
            log_weights = np.nan_to_num(np.asarray(log_weights, dtype=np.float64).reshape(-1), nan=-np.inf)
        return cls(values, log_weights, name=name, effective_sample_size=effective_sample_size, file_name=file_name)

    # ------------------------------------------------------------------
    # storage
    # ------------------------------------------------------------------
    @property
    def _values(self):
        """The values, read from the file or joined from the sources at
        first use."""
        if self._vals is None:
            if self._sources is not None:
                self._vals = self._join([e._values for e in self._sources])
            else:
                self._vals = self._read_file()
        return self._vals

    @_values.setter
    def _values(self, values):
        self._vals = values

    @staticmethod
    def _join(parts):
        """Values of several Empiricals in order: one array when every part
        is an array of one row shape, else a list."""
        parts = [p for p in parts if len(p)]
        if not parts:
            return []
        if all(isinstance(p, np.ndarray) for p in parts) and len({p.shape[1:] for p in parts}) == 1:
            return np.concatenate(parts)
        return [v for p in parts for v in (list(p) if isinstance(p, np.ndarray) else p)]

    def _concatenate(self, kind, sources):
        self._type = kind
        self._sources = sources
        self._vals = None
        self._log_weights = np.concatenate([np.zeros(0)] + [e.log_weights for e in sources])
        self._finalize(None)

    def _read_file(self):
        """The file's values, block by block (an array block of rows, or a
        list of values)."""
        blocks = self._shelf.get("blocks", [])
        return self._join([self._shelf[f"block_{k}"] for k in range(len(blocks))])

    def _write_file(self):
        """Append the pending values as new blocks (arrays in blocks of
        ``_BLOCK_ROWS`` rows), each beside its log weights, then the
        metadata, name and ESS, in one transaction."""
        with self._shelf.transaction():
            blocks = list(self._shelf.get("blocks", []))
            lw = np.asarray(self._log_weights, np.float64)
            stored = sum(blocks)
            for part in self._pending:
                step = _BLOCK_ROWS if isinstance(part, np.ndarray) else max(len(part), 1)
                for begin in range(0, len(part), step):
                    rows = len(part[begin : begin + step])
                    self._shelf[f"block_{len(blocks)}"] = part[begin : begin + step]
                    self._shelf[f"log_weights_{len(blocks)}"] = lw[stored : stored + rows]
                    blocks.append(rows)
                    stored += rows
            self._pending = []
            self._shelf["blocks"] = blocks
            self._shelf["num_values"] = stored
            self._shelf["metadata"] = self._metadata
            self._shelf["name"] = self._name
            if self._finalized:
                self._shelf["effective_sample_size"] = (len(self._log_weights), self._ess)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def empirical_type(self):
        return self._type

    @property
    def file_name(self):
        return self._file_name

    @property
    def length(self):
        return len(self._log_weights)

    def __len__(self):
        return len(self._log_weights)

    @property
    def finalized(self):
        return self._finalized

    def _is_array(self):
        return isinstance(self._values, np.ndarray)

    def add(self, value, log_weight=0.0, weight=None):
        if self._sources is not None:
            raise RuntimeError("Cannot add to a concatenated Empirical")
        if self._file_read_only:
            raise RuntimeError("Empirical file opened read-only")
        if weight is not None:
            log_weight = math.log(weight) if weight > 0 else -math.inf
        if self._is_array():
            self._values = list(self._values)
        if isinstance(self._log_weights, np.ndarray):
            self._log_weights = self._log_weights.tolist()
        self._values.append(value)
        self._log_weights.append(float(log_weight))
        self._finalized = False
        if self._type == EmpiricalType.FILE:
            if not self._pending or isinstance(self._pending[-1], np.ndarray):
                self._pending.append([])
            self._pending[-1].append(value)
            if len(self._pending[-1]) >= _FILE_SYNC_EVERY:
                self._write_file()

    def add_sequence(self, values, log_weights=None):
        if log_weights is None:
            log_weights = np.zeros(len(values))
        for v, lw in zip(values, np.asarray(log_weights, dtype=np.float64).reshape(-1)):
            self.add(v, log_weight=float(lw))

    def finalize(self):
        self._finalize(None)
        if self._type == EmpiricalType.FILE and not self._file_read_only:
            self._write_file()
        return self

    def _finalize(self, effective_sample_size):
        lw = self._log_weights = np.asarray(self._log_weights, dtype=np.float64)
        if lw.size:
            lw = np.nan_to_num(lw, nan=-np.inf)
            m = lw.max()
            if np.isinf(m) and m < 0:
                self._log_weights_norm = np.full_like(lw, -math.log(lw.size))
            else:
                self._log_weights_norm = lw - (m + math.log(np.exp(lw - m).sum()))
            self._probs = np.exp(self._log_weights_norm)
            if effective_sample_size is None:
                effective_sample_size = util.effective_sample_size(lw)
        else:
            self._log_weights_norm = self._probs = lw
            effective_sample_size = 0.0
        self._ess = float(effective_sample_size)
        self._mean_cache = self._variance_cache = self._mode_cache = None
        self._finalized = True
        return self

    def _check_finalized(self):
        if not self._finalized:
            self.finalize()

    def close(self):
        """Write what is pending to the file (if writable) and close it, and
        the files of a concatenation."""
        if self._shelf is not None:
            if self._type == EmpiricalType.FILE and not self._file_read_only:
                if not self._finalized:
                    self._finalize(None)
                self._write_file()
            self._shelf.close()
            self._shelf = None
        if self._type == EmpiricalType.CONCAT_FILE:
            for e in self._sources:
                e.close()
        self._closed = True

    def rename(self, name):
        self._name = name
        if self._type == EmpiricalType.FILE and not self._file_read_only and self._shelf is not None:
            self._shelf["name"] = name
        return self

    # ------------------------------------------------------------------
    # metadata provenance
    # ------------------------------------------------------------------
    def add_metadata(self, **kwargs):
        self._metadata.append(dict(kwargs))

    @property
    def metadata(self):
        return self._metadata

    def metadata_yaml(self):
        import yaml

        return yaml.safe_dump(self._metadata)

    def save_metadata(self, file_name):
        """Dump the metadata list to a YAML file."""
        with open(file_name, "w") as f:
            f.write(self.metadata_yaml())

    # ------------------------------------------------------------------
    # value access
    # ------------------------------------------------------------------
    def _get_value(self, i):
        return self._values[i]

    def get_values(self):
        return list(self._values)

    def values_numpy(self, dtype=np.float64):
        if self._is_array():
            return self._values.astype(dtype)
        return np.asarray([np.asarray(v) for v in self._values], dtype=dtype)

    @property
    def log_weights(self):
        return np.asarray(self._log_weights, dtype=np.float64)

    def log_weights_numpy(self):
        return self.log_weights

    def _log_weights_normalized(self):
        self._check_finalized()
        return self._log_weights_norm

    @property
    def weights(self):
        self._check_finalized()
        return self._probs

    def weights_numpy(self):
        return np.asarray(self.weights)

    def _take(self, idx):
        """The values at the integer indices ``idx``, kept as the values are."""
        if self._is_array():
            return self._values[idx]
        return [self._values[int(i)] for i in idx]

    def _derived(self, values, log_weights=None, **op):
        """A new Empirical of this one's name, its metadata followed by ``op``."""
        out = Empirical(values=values, log_weights=log_weights, name=self._name)
        out._metadata = list(self._metadata) + [op]
        return out

    def __getitem__(self, index):
        self._check_finalized()
        if isinstance(index, slice):
            idx = np.arange(*index.indices(len(self)), dtype=np.int64)
            return Empirical(values=self._take(idx), log_weights=self.log_weights[idx], name=self._name)
        return self._values[index]

    def sample(self, rng=None, sample_shape=()):
        """One value (``sample_shape=()``) or an array of values drawn by
        their weights from ``rng``, a numpy Generator (default the host
        generator ``util.get_rng()``)."""
        self._check_finalized()
        if len(self) == 0:
            raise RuntimeError("Cannot sample from empty Empirical")
        if not isinstance(rng, np.random.Generator):
            rng = util.get_rng()
        n = int(np.prod(sample_shape)) if sample_shape else 1
        idx = rng.choice(len(self), size=n, p=self._probs)
        if not sample_shape:
            return self._values[int(idx[0])]
        vals = self._take(idx)
        try:
            return np.asarray(vals).reshape(tuple(sample_shape) + np.asarray(vals[0]).shape)
        except (ValueError, TypeError):
            return list(vals)

    @staticmethod
    def from_distribution(distribution, num_samples):
        """``num_samples`` IID draws of another distribution (one call, on
        its device) as an unweighted Empirical."""
        draws = distribution.sample(sample_shape=(num_samples,))
        return Empirical(values=_host_value(draws))

    # ------------------------------------------------------------------
    # transforms: each returns a new Empirical and records its op
    # ------------------------------------------------------------------
    def copy(self, file_name=None):
        """A copy in memory, or appended to the Empirical file ``file_name``."""
        self._check_finalized()
        vals = self._values.copy() if self._is_array() else list(self._values)
        if file_name is None:
            return self._derived(vals, self.log_weights, op="copy")
        out = Empirical(vals, self.log_weights, file_name=file_name, name=self._name)
        out._metadata = list(self._metadata) + [{"op": "copy"}]
        return out.finalize()

    def map(self, func):
        self._check_finalized()
        return self._derived(values_of([func(v) for v in self._values]), self.log_weights, op="map")

    def filter(self, predicate):
        self._check_finalized()
        keep = np.fromiter((bool(predicate(v)) for v in self._values), dtype=bool, count=len(self))
        idx = np.flatnonzero(keep)
        return self._derived(self._take(idx), self.log_weights[idx], op="filter")

    condition = filter  # hard conditioning by predicate

    def reweight(self, log_weight_func):
        """New log weights computed from the values."""
        self._check_finalized()
        vals = self._values.copy() if self._is_array() else list(self._values)
        return self._derived(vals, [float(log_weight_func(v)) for v in self._values], op="reweight")

    def reobserve(self, likelihood_funcs=None, observe=None, likelihood_importance=1.0, min_index=None,
                  max_index=None, file_name=None):
        """Rescore a trace-valued Empirical under new observed values and/or
        replacement likelihoods (``likelihood_funcs[name](variable, trace)``
        gives the distribution).  Each trace's distributions are scored on
        the host, as the interpreter tier scores.  Best used right after an
        importance-sampling posterior."""
        from ..state import _on_host, _score
        from ..trace import Trace, Variable

        if len(self) == 0:
            return self
        self._check_finalized()
        if not isinstance(self._values[0], Trace):
            raise RuntimeError("Reobserve can only be used with Empiricals containing execution traces.")
        last_op = self._metadata[-1] if self._metadata else {}
        if not (last_op.get("op") == "posterior"
                and "IMPORTANCE_SAMPLING" in str(last_op.get("inference_engine", ""))):
            warnings.warn(
                "Reobserve should ideally follow an importance-sampling "
                "posterior; the last recorded operation was not one."
            )
        observe = observe or {}
        likelihood_funcs = likelihood_funcs or {}
        lo = min_index or 0
        hi = max_index if max_index is not None else len(self)

        def score(distribution, value):
            return likelihood_importance * _score(_on_host(distribution), util.to_tensor(value, "cpu"))

        traces = []
        for i in range(lo, hi):
            trace = self._values[i]
            new_trace = Trace()
            # a repeated name is observed as one stacked [T, ...] value:
            # each occurrence is rescored against its own row
            name_counts = {}
            for v in trace.variables:
                if v.observable and v.name is not None:
                    name_counts[v.name] = name_counts.get(v.name, 0) + 1
            occurrence = {}
            for v in trace.variables:
                if v.observable:
                    if v.name in observe:
                        value, observed = observe[v.name], True
                        if name_counts.get(v.name, 0) > 1:
                            k = occurrence.get(v.name, 0)
                            occurrence[v.name] = k + 1
                            value = np.asarray(value)[k]
                    else:
                        value, observed = v.value, bool(v.observed)
                    if v.name in likelihood_funcs:
                        distribution = likelihood_funcs[v.name](v, trace)
                        log_prob = None if value is None else score(distribution, value)
                        log_importance_weight = log_prob
                    else:
                        distribution = v.distribution
                        if observed and distribution is not None and v.name in observe:
                            log_prob = log_importance_weight = score(distribution, value)
                        else:
                            log_prob, log_importance_weight = v.log_prob, v.log_importance_weight
                    v = Variable(
                        distribution=distribution, value=value, address_base=v.address_base,
                        address=v.address, instance=v.instance, log_prob=log_prob,
                        log_importance_weight=log_importance_weight, control=v.control, name=v.name,
                        observed=observed, reused=v.reused, tagged=v.tagged,
                    )
                new_trace.add(v)
            new_trace.end(result=trace.result, execution_time_sec=trace.execution_time_sec)
            traces.append(new_trace)
        out = self._derived(traces, [t.log_importance_weight for t in traces], op="reobserve", length=len(self))
        return out if file_name is None else out.copy(file_name=file_name)

    def resample(self, num_samples, map_func=None):
        """Multinomial resampling to uniform weights, from the host
        generator ``util.get_rng()``."""
        self._check_finalized()
        idx = util.get_rng().choice(len(self), size=num_samples, p=self._probs)
        vals = self._take(idx)
        if map_func is not None:
            vals = values_of([map_func(v) for v in vals])
        return self._derived(vals, op="resample", num_samples=num_samples)

    def thin(self, num_samples, map_func=None):
        """Evenly spaced subset."""
        self._check_finalized()
        step = max(1, len(self) // num_samples)
        idx = np.arange(0, len(self), step, dtype=np.int64)[:num_samples]
        vals = self._take(idx)
        if map_func is not None:
            vals = values_of([map_func(v) for v in vals])
        return self._derived(vals, self.log_weights[idx], op="thin", num_samples=num_samples)

    def _buckets(self):
        """(the index of each distinct value's first occurrence, in
        first-occurrence order; each value's bucket) over array values."""
        vals = self._values
        rows = vals.reshape(len(vals), -1) if vals.ndim > 1 else vals
        _, first, inverse = np.unique(rows, axis=0 if vals.ndim > 1 else None, return_index=True,
                                      return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        return first[order], rank[inverse.reshape(-1)]

    def combine_duplicates(self):
        """Merge equal values, their weights summed, in first-occurrence
        order."""
        self._check_finalized()
        lw = self.log_weights
        if self._is_array() and len(self):
            first, bucket = self._buckets()
            m = np.full(len(first), -np.inf)
            np.maximum.at(m, bucket, lw)
            with np.errstate(invalid="ignore", divide="ignore"):
                total = np.bincount(bucket, weights=np.exp(lw - m[bucket]), minlength=len(first))
                combined = m + np.log(total)
            return self._derived(self._values[first], combined, op="combine_duplicates")
        buckets = {}
        for v, w in zip(self._values, lw):
            try:
                k = v if isinstance(v, (int, float, str, bool)) else pickle.dumps(v)
            except Exception:
                k = id(v)
            if k in buckets:
                buckets[k][1].append(w)
            else:
                buckets[k] = (v, [w])
        with np.errstate(invalid="ignore"):
            lws = [_log_sum_exp(np.asarray(ws, dtype=np.float64)) for _, ws in buckets.values()]
        return self._derived([v for v, _ in buckets.values()], lws, op="combine_duplicates")

    def unweighted(self):
        self._check_finalized()
        vals = self._values.copy() if self._is_array() else list(self._values)
        return self._derived(vals, op="unweighted")

    @property
    def weighted(self):
        """True when the normalized weights are not all 1/n (``np.allclose``,
        as the JAX package; pyprob compares exactly)."""
        self._check_finalized()
        if len(self) == 0:
            return False
        return not np.allclose(self._probs, 1.0 / len(self))

    # ------------------------------------------------------------------
    # statistics (weighted, float64 host math)
    # ------------------------------------------------------------------
    @property
    def effective_sample_size(self):
        self._check_finalized()
        return self._ess

    def expectation(self, func):
        self._check_finalized()
        total = None
        for v, p in zip(self._values, self._probs):
            term = np.asarray(func(v), dtype=np.float64) * p
            total = term if total is None else total + term
        return total

    def _moment(self, func):
        """E[func(v)] over float64 values: one vectorised sum over array
        values, the expectation loop otherwise."""
        self._check_finalized()
        if self._is_array():
            return np.tensordot(self._probs, func(self._values.astype(np.float64)), axes=1)
        return self.expectation(lambda v: func(np.asarray(v, dtype=np.float64)))

    @property
    def mean(self):
        if self._mean_cache is None:
            self._mean_cache = self._moment(lambda v: v)
        return self._mean_cache

    @property
    def variance(self):
        if self._variance_cache is None:
            m = self.mean
            self._variance_cache = self._moment(lambda v: (v - m) ** 2)
        return self._variance_cache

    @property
    def stddev(self):
        return np.sqrt(self.variance)

    @property
    def skewness(self):
        m, s = self.mean, self.stddev
        return self._moment(lambda v: ((v - m) / s) ** 3)

    @property
    def kurtosis(self):
        m, s = self.mean, self.stddev
        return self._moment(lambda v: ((v - m) / s) ** 4)

    @property
    def mode(self):
        """The value of greatest combined weight (the first such bucket)."""
        if self._mode_cache is None:
            combined = self.combine_duplicates()
            self._mode_cache = combined._values[int(np.argmax(combined._probs))]
        return self._mode_cache

    def _first_components(self):
        """float64 values, multi-dimensional ones by their first component."""
        vals = self.values_numpy()
        return vals.reshape(len(self), -1)[:, 0] if vals.ndim > 1 else vals

    @property
    def median(self):
        self._check_finalized()
        order = np.argsort(self._first_components(), kind="stable")
        cum = np.cumsum(self._probs[order])
        i = min(int(np.searchsorted(cum, 0.5)), len(self) - 1)
        return self._values[int(order[i])]

    def quantile(self, q):
        """Weighted quantile(s) of the values (multi-dimensional ones by
        their first component); ``q`` a float or a sequence in [0, 1]."""
        self._check_finalized()
        flat = self._first_components()
        qs = np.atleast_1d(np.asarray(q, dtype=np.float64))
        if np.any((qs < 0.0) | (qs > 1.0)):
            raise ValueError("quantiles must be in [0, 1]")
        order = np.argsort(flat, kind="stable")
        cum = np.cumsum(self._probs[order])
        idx = np.minimum(np.searchsorted(cum, qs), len(self) - 1)
        out = flat[order[idx]]
        return float(out[0]) if np.ndim(q) == 0 else out

    def hpd_interval(self, mass=0.9):
        """The shortest interval carrying ``mass`` of the weighted values
        (the shortest-interval estimator on the weighted empirical CDF),
        for scalar values; (low, high)."""
        self._check_finalized()
        if not 0.0 < mass < 1.0:
            raise ValueError("mass must be in (0, 1)")
        flat = self._first_components()
        order = np.argsort(flat, kind="stable")
        sorted_vals = flat[order]
        cum = np.concatenate([[0.0], np.cumsum(self._probs[order])])
        # for each left end i, the least j with cum[j] - cum[i] >= mass
        right = np.searchsorted(cum, cum[:-1] + mass)
        valid = right <= len(self)
        if not valid.any():
            return float(sorted_vals[0]), float(sorted_vals[-1])
        lefts = np.nonzero(valid)[0]
        rights = right[lefts]
        k = int(np.argmin(sorted_vals[rights - 1] - sorted_vals[lefts]))
        return float(sorted_vals[lefts[k]]), float(sorted_vals[rights[k] - 1])

    @property
    def min(self):
        return self.values_numpy().min(axis=0)

    @property
    def max(self):
        return self.values_numpy().max(axis=0)

    def arg_max(self, map_func):
        """The value maximizing ``map_func`` (ties: the last wins)."""
        self._check_finalized()
        best_val, best_i = None, None
        for i, v in enumerate(self._values):
            key = map_func(v)
            if best_val is None or key >= best_val:
                best_val, best_i = key, i
        if best_i is None:
            raise ValueError("arg_max of an empty Empirical")
        return self._values[best_i]

    def arg_min(self, map_func):
        """The value minimizing ``map_func`` (ties: the last wins)."""
        self._check_finalized()
        best_val, best_i = None, None
        for i, v in enumerate(self._values):
            key = map_func(v)
            if best_val is None or key <= best_val:
                best_val, best_i = key, i
        if best_i is None:
            raise ValueError("arg_min of an empty Empirical")
        return self._values[best_i]

    def log_prob(self, value, sum=False):
        raise NotImplementedError("Empirical does not define a density")

    # ------------------------------------------------------------------
    # plots and density estimation
    # ------------------------------------------------------------------
    def plot(self, *args, **kwargs):
        return self.plot_histogram(*args, **kwargs)

    def plot_histogram(self, figsize=(10, 5), xlabel=None, ylabel="Frequency", bins=30, log_xscale=False,
                       log_yscale=False, file_name=None, show=False, density=True, ax=None, **kwargs):
        """Weighted histogram of the values.  Pass ``ax=`` to draw onto an
        existing axes (the figure is then the caller's).  Needs matplotlib."""
        hist = dict(weights=self.weights_numpy(), bins=bins, density=density, **kwargs)
        if ax is not None:
            ax.hist(self.values_numpy(), **hist)
            return ax.figure
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError("Empirical.plot_histogram needs matplotlib, which is not installed") from e
        if not show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=figsize)
        ax.hist(self.values_numpy(), **hist)
        if log_xscale:
            ax.set_xscale("log")
        if log_yscale:
            ax.set_yscale("log")
        if xlabel:
            ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        if file_name is not None:
            fig.savefig(file_name, bbox_inches="tight")
        if show:
            plt.show()
        else:
            plt.close(fig)
        return fig

    def density_estimate(self, num_components=1):
        """A Mixture of ``num_components`` Normals fitted by EM (float64
        numpy) to at most 10,000 values resampled by weight (multi-
        dimensional values by their first component).  The EM starts from
        the values' quantiles at (k + 0.5) / K, equal weights and the
        values' variance, and stops after 500 steps or when the mean
        log-likelihood gains less than 1e-10; 1e-6 is added to each
        variance, as scikit-learn's default ``reg_covar`` does."""
        from .mixture import Mixture
        from .normal import Normal

        x = self.resample(min(len(self), 10000)).values_numpy()
        x = x.reshape(len(x), -1)[:, 0]
        K = int(num_components)
        means = np.quantile(x, (np.arange(K) + 0.5) / K)
        variances = np.full(K, x.var() + 1e-6)
        weights = np.full(K, 1.0 / K)
        last = -np.inf
        for _ in range(500):
            log_r = (np.log(weights) - 0.5 * np.log(2 * math.pi * variances)
                     - 0.5 * (x[:, None] - means) ** 2 / variances)
            m = log_r.max(axis=1, keepdims=True)
            log_norm = m + np.log(np.exp(log_r - m).sum(axis=1, keepdims=True))
            r = np.exp(log_r - log_norm)
            nk = r.sum(axis=0) + 10 * np.finfo(np.float64).eps
            weights = nk / len(x)
            means = (r * x[:, None]).sum(axis=0) / nk
            variances = (r * (x[:, None] - means) ** 2).sum(axis=0) / nk + 1e-6
            ll = float(log_norm.mean())
            if ll - last < 1e-10:
                break
            last = ll
        comps = [Normal(float(mu), float(math.sqrt(v))) for mu, v in zip(means, variances)]
        return Mixture(comps, probs=weights.astype(np.float32))

    def __repr__(self):
        return (f"Empirical(name={self._name!r}, length={len(self)}, type={self._type.name}, "
                f"ESS={self.effective_sample_size:.2f})")
