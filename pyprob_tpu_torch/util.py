"""Substrate: enums, device and dtype configuration, RNG management, ESS
and the weight helpers (``safe_log``, ``log_weights_to_probs``,
``empirical_to_categorical``).

PyTorch counterpart of ``pyprob_tpu/util.py``.  Differences by design:

* The device is explicit.  Entry points run on ``cuda`` unless the caller
  asks for the CPU with ``set_device('cpu')`` (the reference's own name,
  pyprob/util.py:103).  With no card present and no such request,
  ``device()`` raises instead of carrying on quietly on the CPU.
* RNG is explicit: ``seed()`` installs the numpy host generator and one
  ``torch.Generator`` per device, created lazily from the same seed.  There
  is no global key splitting.
* Matmuls and convolutions run in full float32 (TF32 off), as the JAX
  package computes; the parity tolerances assume it.  Convolutions take
  cuDNN's deterministic algorithms.
"""

from __future__ import annotations

import datetime
import enum
import math
import random
import threading
import time

import numpy as np
import torch

__version__ = "0.1.0"

# The JAX package computes in full f32; TF32 would keep ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# cuDNN's default choice for a convolution's gradients differs between two
# identical backward passes on an H100 (chip_smoke.py, cnn_card_vs_cpu), so
# one seed would not reproduce a CNN network's training: ask for
# deterministic algorithms (the CNN embeddings are the port's only cuDNN use)
torch.backends.cudnn.deterministic = True


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


# Constant tensors on a card made from plain numbers (a distribution's
# parameters given as floats, a short list of probabilities): a tensor made
# anew from host memory is a synchronous copy from the host, which a CUDA
# graph cannot capture (the gradient engines capture their potential,
# ``inference/hmc.py``).  Each is made once per (value, dtype, device) and
# handed out as a clone on the card, a device copy.
_CONSTANTS = {}
_CONSTANTS_MAX = 4096


def _constant_key(value):
    """A cache key for a number or a short flat list of numbers (the float's
    hex keeps -0.0 apart from 0.0), else None."""
    if isinstance(value, (bool, int, float)):
        return float(value).hex()
    if isinstance(value, (list, tuple)) and len(value) <= 64 and all(
        isinstance(v, (bool, int, float)) for v in value
    ):
        return tuple(float(v).hex() for v in value)
    return None


def to_tensor(value, device_=None):
    """Float tensor of the configured dtype on ``device_`` (default: the
    device of ``value`` if it is a tensor, else ``device()``)."""
    if device_ is None:
        device_ = value.device if isinstance(value, torch.Tensor) else device()
    if not isinstance(value, torch.Tensor):
        d = torch.device(device_)
        key = _constant_key(value) if d.type == "cuda" else None
        if key is not None:
            key = (key, _dtype, d)
            t = _CONSTANTS.get(key)
            if t is None:
                if len(_CONSTANTS) >= _CONSTANTS_MAX:
                    _CONSTANTS.clear()
                t = _CONSTANTS[key] = torch.as_tensor(value, dtype=_dtype, device=d)
            return t.clone()
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


def safe_log(value):
    """log in float64 numpy: −inf at 0, NaN below (counterpart of
    ``pyprob_tpu.util.safe_log``)."""
    if type(value) is float or np.ndim(value) == 0:
        v = float(value)
        if v > 0.0:
            return np.float64(math.log(v))
        return np.float64(-math.inf) if v == 0.0 else np.float64(math.nan)
    with np.errstate(divide="ignore"):
        return np.log(np.asarray(value, dtype=np.float64))


def log_weights_to_probs(log_weights):
    """Normalized float64 probabilities of log-weights (NaN counts as −inf;
    all −inf gives uniform probabilities)."""
    lw = np.nan_to_num(np.asarray(log_weights, dtype=np.float64).reshape(-1), nan=-np.inf)
    m = lw.max() if lw.size else 0.0
    if np.isinf(m) and m < 0:
        return np.full_like(lw, 1.0 / max(len(lw), 1))
    w = np.exp(lw - m)
    return w / w.sum()


def empirical_to_categorical(empirical, max_items=None):
    """(Categorical, values) of an Empirical over hashable values, its
    duplicates combined; with ``max_items``, the most probable of them,
    renormalized (the reference's pyprob/util.py:326-335)."""
    from .distributions import Categorical

    emp = empirical.combine_duplicates()
    values = emp.get_values()
    probs = np.exp(np.asarray(emp._log_weights_normalized(), dtype=np.float64))
    if max_items is not None and len(values) > max_items:
        order = np.argsort(-probs)[:max_items]
        values = [values[i] for i in order]
        probs = probs[order]
        probs = probs / probs.sum()
    return Categorical(probs=probs), values


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
