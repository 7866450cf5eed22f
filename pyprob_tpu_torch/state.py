"""The ``sample`` / ``observe`` effect entry points.

Counterpart of ``pyprob_tpu/state.py``'s handler slot and entry points:
user models call these module-level functions, which dispatch to the
handler the batched tier (``pyprob_tpu_torch.vectorized``) installs while
it runs ``forward``.  The interpreter tier (one trace at a time on the
host) is not ported yet; without a handler ``sample`` just draws from the
distribution and ``observe`` records nothing, as the JAX package does
outside any trace.
"""

from __future__ import annotations

import threading

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


def sample(distribution, name=None, address=None, control=True):
    handler = _get_handler()
    if handler is not None:
        return handler.sample(
            distribution, name=name, address=address, control=control
        )
    return distribution.sample()
