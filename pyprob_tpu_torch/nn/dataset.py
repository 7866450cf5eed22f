"""Training batches and the online dataset (counterpart of
``pyprob_tpu/nn/dataset.py``).

Traces in a materialized batch are grouped by their controlled-address
sequence (``trace_hash``) so each sub-batch is rectangular.  The online
dataset draws fresh traces from the model in
``PRIOR_FOR_INFERENCE_NETWORK`` mode on the batched tier: ``next_batch``
materializes them (the first batch of a training call, which grows the
network's per-address layers), ``next_device_batch`` leaves them on the
device for the training hot loop.  A model that cannot run on the batched
tier (it branches on sampled values) draws its batches on the interpreter
tier, one trace at a time, and ``next_device_batch`` returns None for it.
``save_dataset`` writes such traces to shelf files (``concurrency.Shelf``,
the traces as plain data).  ``OfflineDataset`` reads a directory of them,
its indices sorted by trace hash (persisted in the directory's
``pyprob_hashes`` file) so that similar traces batch together;
``TraceBatchSampler`` cuts those indices into batches, shuffled between
batches, and ``DistributedTraceBatchSampler`` partitions them among
``world_size`` ranks (plain Python: the rank and world size are given).
"""

from __future__ import annotations

import math
import os
import random as pyrandom
from collections import OrderedDict

import numpy as np

from .. import util
from ..concurrency import ConcurrentShelf, Shelf
from ..trace import Trace, Variable
from ..util import PriorInflation, TraceMode


class Batch:
    """Traces grouped by identical controlled-address sequences."""

    def __init__(self, traces):
        self.traces = traces
        self.size = len(traces)
        sub_batches = {}
        for trace in traces:
            if trace.length == 0:
                raise ValueError("Trace of length zero.")
            sub_batches.setdefault(trace.trace_hash(), []).append(trace)
        self.sub_batches = list(sub_batches.values())

    def __len__(self):
        return self.size


class PackedBatch:
    """A rectangular training batch packed directly from device tensors:
    the hot loop's batch, with no Python trace materialization."""

    def __init__(self, packed, size, addrs, dist_names):
        self.packed = packed
        self.size = size
        self.addrs = addrs
        self.dist_names = dist_names

    def __len__(self):
        return self.size


def _prune_variable(variable, keep_distribution=True):
    return Variable(
        distribution=variable.distribution if keep_distribution else None,
        value=None if variable.value is None else np.asarray(variable.value),
        address_base=variable.address_base,
        address=variable.address,
        instance=variable.instance,
        control=variable.control,
        name=variable.name,
        observed=variable.observed,
        tagged=variable.tagged,
    )


def prune_trace(trace):
    """Keep the controlled variables (with their distributions) and the
    named ones (values only), in execution order."""
    ret = Trace()
    for variable in trace.variables:
        if variable.control:
            ret.add(_prune_variable(variable, keep_distribution=True))
        elif variable.name is not None and variable.address not in ret.variables_dict_address:
            ret.add(_prune_variable(variable, keep_distribution=False))
    ret.end(None, None)
    return ret


class OnlineDataset:
    """Infinite dataset of fresh prior traces (observes receive sampled
    values), drawn on the batched tier when the model runs there, else on
    the interpreter tier."""

    def __init__(self, model, prior_inflation=PriorInflation.DISABLED):
        self._model = model
        self._prior_inflation = prior_inflation

    def __getitem__(self, idx):
        return self.next_batch(1)[0]

    def next_batch(self, batch_size):
        """``batch_size`` pruned, materialized training traces: one batched
        run, or the interpreter loop for a model that cannot run batched."""
        from ..vectorized import vectorized_traces

        emp = vectorized_traces(
            self._model,
            batch_size,
            TraceMode.PRIOR_FOR_INFERENCE_NETWORK,
            prior_inflation=self._prior_inflation,
            fallback=True,
        )
        if emp is not None:
            return [prune_trace(t) for t in emp.get_values()]
        return self._model._traces(
            num_traces=batch_size,
            trace_mode=TraceMode.PRIOR_FOR_INFERENCE_NETWORK,
            prior_inflation=self._prior_inflation,
            map_func=prune_trace,
            silent=True,
        ).get_values()

    def next_device_batch(self, batch_size):
        """(outputs, sites) of one batched run, outputs on the device as
        ``[B]`` tensors; None for a model that cannot run batched (its
        class is marked, as ``vectorized_traces`` marks it)."""
        from ..vectorized import _TraceabilityCache, run_training_batch

        if _TraceabilityCache.known_untraceable(self._model):
            return None
        try:
            return run_training_batch(self._model, batch_size, self._prior_inflation)
        except NotImplementedError:
            _TraceabilityCache.mark(self._model, False)
            return None

    def save_dataset(self, dataset_dir, num_traces, num_traces_per_file):
        """Write ``num_traces`` fresh training traces to files of
        ``num_traces_per_file`` in ``dataset_dir``, each file with its
        traces' hashes; returns the number written."""
        os.makedirs(dataset_dir, exist_ok=True)
        num_files = math.ceil(num_traces / num_traces_per_file)
        written = 0
        for file_idx in range(num_files):
            n = min(num_traces_per_file, num_traces - written)
            traces = self.next_batch(n)
            file_name = os.path.join(
                dataset_dir, f"pyprob_traces_{num_traces_per_file}_{util.get_time_stamp()}_{file_idx}"
            )
            _write_traces(file_name, traces)
            written += n
            util.log_print(f"Saved dataset file {file_idx + 1}/{num_files}: {file_name}")
        return written


def _write_traces(file_name, traces):
    """One dataset file: ``trace_{i}``, ``num_traces`` and ``trace_hashes``,
    in one transaction."""
    shelf = Shelf(file_name)
    with shelf.transaction():
        for i, t in enumerate(traces):
            shelf[f"trace_{i}"] = t
        shelf["num_traces"] = len(traces)
        shelf["trace_hashes"] = [t.trace_hash() for t in traces]
    shelf.close()


class OfflineDatasetFile:
    """One dataset file.  Its open handle lives in a class-level LRU of at
    most ``cache_capacity`` handles shared by every instance, so any number
    of files stay readable without exhausting file descriptors.  As in
    pyprob, ``close`` closes the shared handle (another instance of the
    same file reopens it at its next read), and the LRU has no lock: one
    reader a process."""

    cache = OrderedDict()
    cache_capacity = 8

    def __init__(self, file_name):
        self._file_name = file_name
        self._length = self._open().get("num_traces", 0)

    def _open(self):
        cache = OfflineDatasetFile.cache
        shelf = cache.pop(self._file_name, None)
        if shelf is None:
            if len(cache) >= OfflineDatasetFile.cache_capacity:
                _, old = cache.popitem(last=False)
                old.close()
            shelf = Shelf(self._file_name)
        cache[self._file_name] = shelf  # most recently used at the back
        return shelf

    @property
    def length(self):
        return self._length

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        return self._open()[f"trace_{idx}"]

    def trace_hashes(self):
        hashes = self._open().get("trace_hashes")
        if hashes is None:
            hashes = [self[i].trace_hash() for i in range(self._length)]
        return hashes

    def close(self):
        shelf = OfflineDatasetFile.cache.pop(self._file_name, None)
        if shelf is not None:
            shelf.close()


class OfflineDataset:
    """The traces of every dataset file in ``dataset_dir``, in file-name
    order, with their indices sorted by trace hash."""

    def __init__(self, dataset_dir):
        if not os.path.isdir(dataset_dir):
            raise FileNotFoundError(f"No dataset directory: {dataset_dir}")
        self._dataset_dir = dataset_dir
        files = sorted(
            os.path.join(dataset_dir, f)
            for f in os.listdir(dataset_dir)
            if not f.startswith(".") and not f.endswith("_hashes") and not f.endswith("-journal")
        )
        self._file_names, self._file_lengths = [], []
        for fn in files:
            try:
                f = OfflineDatasetFile(fn)
            except Exception:
                util.log_print(f"Skipping a file that is not a dataset file: {fn}")
                continue
            if f.length:
                self._file_names.append(fn)
                self._file_lengths.append(f.length)
            f.close()
        self._cum_lengths = np.cumsum(self._file_lengths, dtype=np.int64)
        self._length = int(self._cum_lengths[-1]) if len(self._cum_lengths) else 0
        self._files = {}
        self._hashes_file = os.path.join(dataset_dir, "pyprob_hashes")
        self._sorted_indices = self._load_or_compute_sorted_indices()

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        idx = int(idx)
        if not 0 <= idx < self._length:
            raise IndexError(idx)
        i = int(np.searchsorted(self._cum_lengths, idx, side="right"))
        local = idx - (int(self._cum_lengths[i]) - self._file_lengths[i])
        fn = self._file_names[i]
        if fn not in self._files:
            self._files[fn] = OfflineDatasetFile(fn)
        return self._files[fn][local]

    def _load_or_compute_sorted_indices(self):
        if os.path.exists(self._hashes_file):
            try:
                shelf = Shelf(self._hashes_file)
                data, files = shelf.get("sorted_indices"), shelf.get("file_names")
                shelf.close()
                if data is not None and files == self._file_names:
                    return list(data)
            except Exception:
                pass
        hashes = []
        for fn in self._file_names:
            f = OfflineDatasetFile(fn)
            hashes.extend(f.trace_hashes())
        indices = sorted(range(len(hashes)), key=hashes.__getitem__)  # stable
        try:
            shelf = Shelf(self._hashes_file)
            with shelf.transaction():
                shelf["sorted_indices"] = indices
                shelf["file_names"] = self._file_names
            shelf.close()
        except Exception:
            pass
        return indices

    @property
    def sorted_indices(self):
        return self._sorted_indices

    def save_sorted(self, sorted_dataset_dir, num_traces_per_file=None, begin_file_index=None,
                    end_file_index=None):
        """Rewrite the dataset in hash order into files of
        ``num_traces_per_file``; ``begin_file_index`` / ``end_file_index``
        let several nodes each write a disjoint range of the files.
        Returns the number of files of the whole sorted dataset."""
        os.makedirs(sorted_dataset_dir, exist_ok=True)
        if num_traces_per_file is None:
            num_traces_per_file = max(self._file_lengths)
        num_files = math.ceil(self._length / num_traces_per_file)
        begin_file_index = 0 if begin_file_index is None else begin_file_index
        end_file_index = num_files if end_file_index is None else end_file_index
        for file_idx in range(begin_file_index, end_file_index):
            begin = file_idx * num_traces_per_file
            indices = self._sorted_indices[begin : min(begin + num_traces_per_file, self._length)]
            traces = [self[i] for i in indices]
            file_name = os.path.join(sorted_dataset_dir, f"pyprob_traces_sorted_{num_traces_per_file}_{file_idx}")
            shelf = ConcurrentShelf(file_name)
            with shelf.transaction():
                for i, t in enumerate(traces):
                    shelf[f"trace_{i}"] = t
                shelf["num_traces"] = len(traces)
                shelf["trace_hashes"] = [t.trace_hash() for t in traces]
            shelf.close()
        return num_files


class TraceSampler:
    """A dataset's indices in hash order, one at a time."""

    def __init__(self, offline_dataset):
        if not isinstance(offline_dataset, OfflineDataset):
            raise TypeError("Expecting an OfflineDataset instance.")
        self._offline_dataset = offline_dataset
        self._sorted_indices = offline_dataset.sorted_indices

    def __iter__(self):
        return iter(self._sorted_indices)

    def __len__(self):
        return len(self._offline_dataset)


def _chunks(lst, n):
    return [lst[i : i + n] for i in range(0, len(lst), n)]


class TraceBatchSampler:
    """Batches of consecutive hash-sorted indices (similar traces together),
    their order shuffled at each pass with the host generator when
    ``shuffle_batches``."""

    def __init__(self, dataset, batch_size, shuffle_batches=True):
        if not isinstance(dataset, OfflineDataset):
            raise ValueError("Expecting an OfflineDataset instance.")
        self._batches = _chunks(list(dataset.sorted_indices), batch_size)
        self._shuffle_batches = shuffle_batches

    def __iter__(self):
        if self._shuffle_batches:
            pyrandom.shuffle(self._batches)
        return iter(self._batches)

    def __len__(self):
        return len(self._batches)


class DistributedTraceBatchSampler:
    """Batches for rank ``rank`` of ``world_size``: the batches cut to a
    multiple of the world size, grouped into ``num_buckets`` buckets whose
    order is shuffled by the epoch (the same on every rank), each rank
    taking every ``world_size``-th batch of a bucket from its own offset."""

    def __init__(self, dataset, batch_size, rank=0, world_size=1, num_buckets=None, shuffle_batches=True,
                 shuffle_buckets=True):
        if not isinstance(dataset, OfflineDataset):
            raise ValueError("Expecting an OfflineDataset instance.")
        if rank >= world_size:
            raise ValueError(f"rank={rank} must be < world_size={world_size}")
        self._rank = rank
        self._world_size = world_size
        batches = _chunks(list(dataset.sorted_indices), batch_size)
        batches = batches[: (len(batches) // world_size) * world_size]
        if num_buckets is None:
            num_buckets = max(1, len(batches) // (world_size * 8))
        self._num_buckets = num_buckets
        bucket_size = (max(1, len(batches) // num_buckets) // world_size) * world_size or world_size
        self._buckets = [b for b in _chunks(batches, bucket_size) if len(b) >= world_size]
        self._shuffle_batches = shuffle_batches
        self._shuffle_buckets = shuffle_buckets
        self._epoch = 0
        self._current_bucket_id = 0

    def __iter__(self):
        self._epoch += 1
        rng = pyrandom.Random(self._epoch)
        bucket_ids = list(range(len(self._buckets)))
        if self._shuffle_buckets:
            rng.shuffle(bucket_ids)
        for bucket_id in bucket_ids:
            self._current_bucket_id = bucket_id
            batches = self._buckets[bucket_id][self._rank :: self._world_size]
            if self._shuffle_batches:
                pyrandom.Random(self._epoch * 1000003 + bucket_id * 1009 + self._rank).shuffle(batches)
            yield from batches

    def __len__(self):
        return sum(len(b[self._rank :: self._world_size]) for b in self._buckets)
