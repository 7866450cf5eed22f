"""Substrate: enums, device and dtype configuration, RNG management, ESS.

PyTorch counterpart of ``pyprob_tpu/util.py``.  Differences by design:

* The device is explicit.  Entry points run on ``cuda`` unless the caller
  asks for the CPU with ``set_device('cpu')`` (the reference's own name,
  pyprob/util.py:103).  With no card present and no such request,
  ``device()`` raises instead of carrying on quietly on the CPU.
* RNG is explicit: ``seed()`` installs the numpy host generator and one
  ``torch.Generator`` per device, created lazily from the same seed.  There
  is no global key splitting.
* Matmuls and convolutions run in full float32 (TF32 off), as the JAX
  package computes; the parity tolerances assume it.
"""

from __future__ import annotations

import datetime
import enum
import random
import threading
import time

import numpy as np
import torch

__version__ = "0.1.0"

# The JAX package computes in full f32; TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class TraceMode(enum.Enum):
    NONE = 0
    PRIOR = 1
    PRIOR_FOR_INFERENCE_NETWORK = 2
    POSTERIOR = 3


class PriorInflation(enum.Enum):
    DISABLED = 0
    ENABLED = 1


class InferenceEngine(enum.Enum):
    IMPORTANCE_SAMPLING = 0
    IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK = 1
    LIGHTWEIGHT_METROPOLIS_HASTINGS = 2
    RANDOM_WALK_METROPOLIS_HASTINGS = 3
    SEQUENTIAL_MONTE_CARLO = 4
    SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK = 5
    HAMILTONIAN_MONTE_CARLO = 6
    VARIATIONAL_INFERENCE = 7
    NO_U_TURN_SAMPLER = 8
    PARALLEL_TEMPERING = 9
    TEMPERED_SMC = 10
    STEIN_VARIATIONAL_GRADIENT_DESCENT = 11
    LAPLACE = 12


class InferenceNetwork(enum.Enum):
    FEEDFORWARD = 0
    LSTM = 1


class ObserveEmbedding(enum.Enum):
    FEEDFORWARD = 0
    CNN2D5C = 1
    CNN3D5C = 2


class Optimizer(enum.Enum):
    ADAM = 0
    SGD = 1
    ADAM_LARC = 2
    SGD_LARC = 3


class LearningRateScheduler(enum.Enum):
    NONE = 0
    POLY1 = 1
    POLY2 = 2


# ---------------------------------------------------------------------------
# Global configuration
# ---------------------------------------------------------------------------

_verbosity = 2
_print_refresh_rate = 0.25  # seconds between training progress lines
_dtype = torch.float32
_device = "cuda"


def set_verbosity(v=2):
    global _verbosity
    _verbosity = v


def verbosity():
    return _verbosity


def set_device(device):
    """Select the device entry points run on: ``'cuda'`` (the default,
    also ``'cuda:N'``) or ``'cpu'``."""
    global _device
    device = str(device)
    if device != "cpu" and not device.startswith("cuda"):
        raise ValueError(f"Unknown device {device!r}; expected 'cuda' or 'cpu'")
    _device = device


def device():
    """The torch.device entry points run on.  Raises when CUDA is selected
    and no card is present: the port never falls back to the CPU unasked."""
    if _device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyprob_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; call pyprob_tpu_torch.set_device('cpu') to run on "
            "the CPU"
        )
    return torch.device(_device)


# Per thread: True while the thread runs an interpreter-tier trace, whose
# distributions keep their parameters on the host (``state._begin_trace``).
_interpreter_thread = threading.local()


def param_device():
    """Where a distribution built from plain numbers puts its parameters:
    the CPU while this thread runs an interpreter-tier trace (values are
    drawn and scored on the host there), else ``device()``."""
    if getattr(_interpreter_thread, "active", False):
        return torch.device("cpu")
    return device()


def dtype():
    return _dtype


def to_tensor(value, device_=None):
    """Float tensor of the configured dtype on ``device_`` (default: the
    device of ``value`` if it is a tensor, else ``device()``)."""
    if device_ is None:
        device_ = value.device if isinstance(value, torch.Tensor) else device()
    return torch.as_tensor(value, dtype=_dtype, device=device_)


# ---------------------------------------------------------------------------
# RNG management
# ---------------------------------------------------------------------------

_rng: np.random.Generator = np.random.default_rng(0)
_seed = 0
_generators = {}


def seed(s=None):
    """Seed all RNG sources: python ``random``, the numpy host generator
    and the per-device torch generators."""
    global _rng, _seed
    if s is None:
        s = int(time.time() * 1e6) % (2**31)
    random.seed(s)
    _rng = np.random.default_rng(s)
    _seed = s
    _generators.clear()  # re-created lazily from the new seed
    return s


def get_rng() -> np.random.Generator:
    """Host RNG."""
    return _rng


def generator(device_=None):
    """The torch.Generator of ``device_`` (default ``device()``), seeded
    from the last ``seed()``."""
    d = torch.device(device_) if device_ is not None else device()
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    g = _generators.get(d)
    if g is None:
        g = torch.Generator(device=d)
        g.manual_seed(_seed)
        _generators[d] = g
    return g


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def effective_sample_size(log_weights):
    """ESS = (Σw)²/Σw² of normalized importance weights, in float64
    log-space (counterpart of ``pyprob_tpu.util.effective_sample_size``)."""
    lw = np.asarray(log_weights, dtype=np.float64).reshape(-1)
    lw = lw[~np.isnan(lw)]
    if lw.size == 0:
        return 0.0
    m = lw.max()
    if np.isinf(m) and m < 0:
        return 0.0
    w = np.exp(lw - m)
    s = w.sum()
    return float(s * s / (w * w).sum())


# ---------------------------------------------------------------------------
# Printing
# ---------------------------------------------------------------------------


def log_print(*args, **kwargs):
    if _verbosity >= 2:
        print(*args, **kwargs)


def get_time_stamp():
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


def truncate_str(s, length=80):
    return (s[: length - 3] + "...") if len(s) > length else s
