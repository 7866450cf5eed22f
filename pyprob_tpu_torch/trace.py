"""Variable and Trace records (counterpart of ``pyprob_tpu/trace.py``).

Materialized traces hold host values: numpy scalars or arrays (the batched
tier) or 0-d CPU tensors (the interpreter tier) for values, floats or
numpy scalars for log-probs, and distributions whose parameters are CPU
tensors.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def _total(log_prob):
    return log_prob if isinstance(log_prob, float) else np.sum(log_prob)


class Variable:
    def __init__(
        self,
        distribution=None,
        value=None,
        address_base=None,
        address=None,
        instance=None,
        log_prob=None,
        log_importance_weight=None,
        control=False,
        name=None,
        observed=False,
        reused=False,
        tagged=False,
    ):
        self.distribution = distribution
        self.value = value
        self.address_base = address_base
        self.address = address
        self.instance = instance
        self.log_prob = log_prob
        self.log_importance_weight = log_importance_weight
        self.control = control
        self.name = name
        self.observable = ((not tagged) and (name is not None)) or observed
        self.observed = observed
        self.reused = reused
        self.tagged = tagged

    def __repr__(self):
        return (
            f"Variable(name:{self.name}, observable:{self.observable}, "
            f"observed:{self.observed}, tagged:{self.tagged}, "
            f"control:{self.control}, address:{self.address}, "
            f"distribution:{self.distribution}, value:{self.value}, "
            f"log_importance_weight:{self.log_importance_weight}, "
            f"log_prob:{self.log_prob})"
        )


class Trace:
    def __init__(self):
        self.variables = []
        self.variables_controlled = []
        self.variables_uncontrolled = []
        self.variables_observed = []
        self.variables_observable = []
        self.variables_tagged = []
        self.variables_dict_address = {}
        self.variables_dict_address_base = {}
        self.named_variables = {}
        self.result = None
        self.log_prob = 0.0
        self.log_prob_observed = 0.0
        self.log_importance_weight = 0.0
        self.length = 0
        self.length_controlled = 0
        self.execution_time_sec = None

    def __repr__(self):
        return (
            f"Trace(variables:{self.length:,}, controlled:{self.length_controlled:,}, "
            f"observed:{len(self.variables_observed)}, log_prob:{self.log_prob}, "
            f"log_importance_weight:{self.log_importance_weight})"
        )

    def add(self, variable):
        self.variables.append(variable)
        self.variables_dict_address[variable.address] = variable
        self.variables_dict_address_base[variable.address_base] = variable

    def end(self, result, execution_time_sec):
        """Finalize: aggregate log-probs and category lists."""
        self.result = result
        self.execution_time_sec = execution_time_sec
        for variable in self.variables:
            if variable.name is not None:
                self.named_variables[variable.name] = variable
            if variable.control:
                self.variables_controlled.append(variable)
        self.variables_uncontrolled = [
            v
            for v in self.variables
            if (not v.control) and (not v.observed) and (not v.tagged)
        ]
        self.variables_observed = [v for v in self.variables if v.observed]
        self.variables_observable = [v for v in self.variables if v.observable]
        self.variables_tagged = [v for v in self.variables if v.tagged]
        self.log_prob = sum(
            _total(v.log_prob)
            for v in self.variables
            if (v.control or v.observed) and v.log_prob is not None
        )
        self.log_prob_observed = sum(
            _total(v.log_prob)
            for v in self.variables_observed
            if v.log_prob is not None
        )
        self.length = len(self.variables)
        self.length_controlled = len(self.variables_controlled)
        for variable in self.variables:
            if variable.log_importance_weight is not None:
                self.log_importance_weight = (
                    self.log_importance_weight + variable.log_importance_weight
                )

    def rollback(self, marker):
        """Discard the variables added after ``marker`` (an earlier
        ``len(trace.variables)``): a retried ``rejection_sample`` attempt
        replaces the rejected one, so the block's addresses stay stable."""
        if marker >= len(self.variables):
            return
        del self.variables[marker:]
        self.variables_dict_address = {v.address: v for v in self.variables}
        self.variables_dict_address_base = {v.address_base: v for v in self.variables}

    def last_instance(self, address_base):
        """The instance of the last variable recorded at ``address_base``
        (0 if none): the interpreter numbers a repeated site from it."""
        if address_base in self.variables_dict_address_base:
            return self.variables_dict_address_base[address_base].instance
        return 0

    def address_counts(self, use_address_base=True):
        return Counter(v.address_base if use_address_base else v.address for v in self.variables)

    def trace_hash(self, controlled_only=True):
        """Hash of the controlled-address sequence, used for rectangular
        sub-batching."""
        vs = self.variables_controlled if controlled_only else self.variables
        return "".join(v.address for v in vs)

    def __len__(self):
        return self.length

    def named_value(self, name):
        """The value recorded under ``name``; a repeated name gives the
        stacked sequence of its values in execution order."""
        vs = [v for v in self.variables if v.name == name]
        if not vs:
            raise RuntimeError(f"Trace does not include variable with name: {name}")
        if len(vs) == 1:
            return vs[0].value
        return np.stack([np.asarray(v.value) for v in vs])
