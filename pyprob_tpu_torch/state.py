"""The ``sample`` / ``observe`` / ``factor`` / ``tag`` / ``rejection_sample``
effect entry points.

Counterpart of ``pyprob_tpu/state.py``'s handler slot and entry points:
user models call these module-level functions, which dispatch to the
handler the batched tier (``pyprob_tpu_torch.vectorized``) installs while
it runs ``forward``.  The interpreter tier (one trace at a time on the
host) is not ported yet; without a handler ``sample`` just draws from the
distribution, ``observe``, ``factor`` and ``tag`` record nothing, and
``rejection_sample`` is a plain host loop, as the JAX package does outside
any trace.
"""

from __future__ import annotations

import threading

import torch

# Handler installed by the batched tier; one per thread.
_handler_local = threading.local()


def _set_handler(handler):
    prev = getattr(_handler_local, "value", None)
    _handler_local.value = handler
    return prev


def _get_handler():
    return getattr(_handler_local, "value", None)


def observe(distribution, value=None, name=None, address=None):
    handler = _get_handler()
    if handler is not None:
        return handler.observe(distribution, value=value, name=name, address=address)
    return None


def sample(distribution, name=None, address=None, control=True, mask=None):
    handler = _get_handler()
    if handler is not None:
        return handler.sample(
            distribution, name=name, address=address, control=control, mask=mask
        )
    return distribution.sample()


def factor(log_prob=None, log_prob_func=None, name=None, address=None, mask=None):
    handler = _get_handler()
    if handler is not None:
        return handler.factor(
            log_prob=log_prob, log_prob_func=log_prob_func, name=name,
            address=address, mask=mask,
        )
    return None


def tag(value, name=None, address=None):
    handler = _get_handler()
    if handler is not None:
        return handler.tag(value, name=name, address=address)
    return None


def rejection_sample(attempt_fn, max_attempts=None):
    """Rejection sampling with replacement semantics.

    ``attempt_fn()`` runs model code containing ``sample`` calls and
    returns ``(output, accept)``; attempts repeat until ``accept`` is true
    and the accepted attempt *replaces* the rejected ones in the trace, so
    a block's sites keep stable addresses (instance 1).  On the batched
    tier the loop runs over the whole particle batch, retrying the lanes
    still pending (``VectorizedHandler.rejection_sample``).  With no
    handler installed it is a plain host loop (at most ``max_attempts``
    attempts, default 1e6) that returns the accepted output.
    """
    handler = _get_handler()
    if handler is not None:
        return handler.rejection_sample(attempt_fn, max_attempts=max_attempts)
    cap = int(max_attempts) if max_attempts else 1_000_000
    for _ in range(cap):
        out, accept = attempt_fn()
        if bool(torch.all(torch.as_tensor(accept))):
            return out
    raise RuntimeError(f"rejection_sample exceeded {cap:,} attempts without acceptance")
