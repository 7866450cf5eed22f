"""Mixture distribution (counterpart of
``pyprob_tpu/distributions/mixture.py``).

``log_prob`` is the logsumexp over component log-densities plus mixing
logits.  Two homogeneous families go through hand-written kernels
(``_fused_log_prob``), where the JAX package calls its Pallas kernels:
all-Normal mixtures through ``ops.kernels.mixture_normal_log_prob`` and
all-TruncatedNormal mixtures whose components share one ``low`` and one
``high`` through ``ops.kernels.mixture_truncated_normal_log_prob``.  They
take a 1-D batch scored at one value a row (the proposal heads), and a
value whose broadcast with the batches has two dims or more (a data vector
observed per particle, ``[N, D]``): its parameters are expanded to
``[N, D, K]`` and scored as ``N·D`` rows.
Both are differentiable, their gradients kernels too on CUDA, and reach
the means, the stddevs and the mixing logits through the ``.contiguous()``
and ``.expand()`` views that feed them (the training loss).  Mixtures of
StudentTs (the heavy-tailed proposal head) take the logsumexp path, as in
the JAX package, which has no kernel for them, with the K components
scored in one pass at their ``[B, K]`` parameters.  Sampling draws the
component index and gathers one component's parameters per row for a
single draw (one Gamma draw a row for StudentTs, not K); the JAX package
draws every component and selects one with a one-hot contraction, so the
two agree in distribution, not draw for draw.
"""

from __future__ import annotations

import torch

from .. import util
from ..ops import kernels
from .distribution import Distribution
from .categorical import Categorical
from .normal import Normal
from .student_t import StudentT
from .truncated_normal import TruncatedNormal


class Mixture(Distribution):
    _param_names = ()

    def __init__(self, distributions, probs=None, logits=None):
        self._distributions = list(distributions)
        if probs is None and logits is None:
            batch_shape = torch.broadcast_shapes(
                *[d.batch_shape for d in self._distributions]
            )
            K = len(self._distributions)
            probs = torch.full(
                tuple(batch_shape) + (K,),
                1.0 / K,
                dtype=util.dtype(),
                device=self._distributions[0].device,
            )
        self._mixing = Categorical(probs=probs, logits=logits)
        # [B, K] (means, stddevs) of an all-Normal mixture, or [B, K]
        # (means, stddevs) and [B] (low, high) of a truncated one, whose
        # caller already holds them stacked (the proposal heads); None =
        # stack on demand from the components
        self._normal_params = None
        self._tnorm_params = None
        self._studentt_params = None
        self._finish_init()

    @classmethod
    def _from_normal_params(cls, means, stddevs, probs):
        """Mixture of K Normals from ``[B, K]`` parameter tensors, kept
        stacked for the kernel (the components are column views)."""
        K = means.shape[1]
        comps = [Normal(means[:, i], stddevs[:, i]) for i in range(K)]
        d = cls(comps, probs=probs)
        d._normal_params = (means, stddevs)
        return d

    @classmethod
    def _from_truncated_normal_params(cls, means, stddevs, probs, low, high):
        """Mixture of K TruncatedNormals on one ``[low, high]`` per row from
        ``[B, K]`` parameter tensors and ``[B]`` bounds, kept stacked for
        the kernel."""
        K = means.shape[1]
        comps = [TruncatedNormal(means[:, i], stddevs[:, i], low, high) for i in range(K)]
        d = cls(comps, probs=probs)
        d._tnorm_params = (means, stddevs, low, high)
        return d

    @classmethod
    def _from_studentt_params(cls, dfs, means, scales, probs):
        """Mixture of K StudentTs from ``[B, K]`` parameter tensors, kept
        stacked for scoring and for drawing one component a row."""
        K = means.shape[1]
        comps = [StudentT(dfs[:, i], means[:, i], scales[:, i]) for i in range(K)]
        d = cls(comps, probs=probs)
        d._studentt_params = (dfs, means, scales)
        return d

    def _finish_init(self):
        self._num_components = len(self._distributions)
        super().__init__(
            name="Mixture",
            address_suffix=f"Mixture({', '.join(d.address_suffix for d in self._distributions)})",
            batch_shape=self._mixing.batch_shape,
        )

    @property
    def device(self):
        return self._mixing.device

    @property
    def distributions(self):
        return self._distributions

    @property
    def mixing_distribution(self):
        return self._mixing

    @property
    def probs(self):
        return self._mixing.probs

    def _stacked_normal_params(self, shape=None):
        """``[*shape, K]`` (means, stddevs) when every component is a Normal
        (``shape`` defaults to the mixture's batch, which must then be
        1-D), else None."""
        if self._normal_params is not None and shape in (None, self._batch_shape):
            return self._normal_params
        comps = self._distributions
        if not all(isinstance(d, Normal) for d in comps):
            return None
        if shape is None:
            if len(self._batch_shape) != 1:
                return None
            shape = self._batch_shape
        means = torch.stack([d.loc.expand(shape) for d in comps], -1)
        stddevs = torch.stack([d.scale.expand(shape) for d in comps], -1)
        return means, stddevs

    def _stacked_tnorm_params(self, shape=None):
        """``[*shape, K]`` (means, stddevs) and ``[*shape]`` (low, high)
        when every component is a TruncatedNormal on the same bounds (the
        same tensors, as the JAX package checks; ``shape`` as for
        ``_stacked_normal_params``), else None."""
        if self._tnorm_params is not None and shape in (None, self._batch_shape):
            return self._tnorm_params
        comps = self._distributions
        if not all(
            isinstance(d, TruncatedNormal)
            and d.low is comps[0].low
            and d.high is comps[0].high
            for d in comps
        ):
            return None
        if shape is None:
            if len(self._batch_shape) != 1:
                return None
            shape = self._batch_shape
        means = torch.stack([d.mean_non_truncated.expand(shape) for d in comps], -1)
        stddevs = torch.stack([d.stddev_non_truncated.expand(shape) for d in comps], -1)
        return means, stddevs, comps[0].low.expand(shape), comps[0].high.expand(shape)

    def _stacked_studentt_params(self):
        """``[B, K]`` (dfs, means, scales) when every component is a StudentT
        and the batch is 1-D, else None."""
        if self._studentt_params is not None:
            return self._studentt_params
        comps = self._distributions
        if len(self._batch_shape) != 1 or not all(isinstance(d, StudentT) for d in comps):
            return None
        B = self._batch_shape[0]
        return tuple(
            torch.stack([getattr(d, name).expand(B) for d in comps], -1) for name in ("df", "loc", "scale")
        )

    def log_prob(self, value, sum=False):
        value = util.to_tensor(value, self.device)
        fused = self._fused_log_prob(value)
        if fused is not None:
            return fused.sum() if sum else fused
        studentt = self._stacked_studentt_params() if value.dim() == 1 else None
        if studentt is not None:
            # the K components scored in one pass at the stacked parameters
            comp = StudentT(*studentt).log_prob(value.unsqueeze(-1))
        else:
            comp = torch.stack([d.log_prob(value) for d in self._distributions], -1)
        lp = torch.logsumexp(comp + self._mixing.logits, dim=-1)
        return lp.sum() if sum else lp

    def _fused_shape(self, value):
        """The shape of the rows the kernels score at ``value``, or None: the
        1-D batch when the value has that shape (the proposal heads), else
        the broadcast of the value with the components' and the mixing
        batches when it has two dims or more (an observe of a data vector
        per particle, ``[N, D]``, which the JAX package scores per particle
        under ``vmap``)."""
        if value.dim() == 1 and self._batch_shape == tuple(value.shape):
            return self._batch_shape
        try:
            shape = torch.broadcast_shapes(
                value.shape, self._mixing.batch_shape, *[d.batch_shape for d in self._distributions]
            )
        except RuntimeError:
            return None
        return tuple(shape) if len(shape) >= 2 else None

    def _fused_log_prob(self, value):
        """The kernel path for all-Normal and shared-bounds all-TruncatedNormal
        mixtures scored at one value a row (``_fused_shape``): the rows are
        flattened to ``[R, K]`` for the kernel and its ``[R]`` output takes
        their shape again; None when the shapes don't fit."""
        shape = self._fused_shape(value)
        if shape is None:
            return None
        params = self._stacked_normal_params(shape)
        if params is not None:
            means, stddevs = params
            rows = means.shape[:-1]
            K = means.shape[-1]
            logits = self._mixing.logits.expand(means.shape)
            return kernels.mixture_normal_log_prob(
                value.expand(rows).reshape(-1).contiguous(),
                means.reshape(-1, K).contiguous(),
                stddevs.reshape(-1, K).contiguous(),
                logits.reshape(-1, K).contiguous(),
            ).reshape(rows)
        params = self._stacked_tnorm_params(shape)
        if params is not None:
            means, stddevs, low, high = params
            rows = means.shape[:-1]
            K = means.shape[-1]
            logits = self._mixing.logits.expand(means.shape)
            return kernels.mixture_truncated_normal_log_prob(
                value.expand(rows).reshape(-1).contiguous(),
                means.reshape(-1, K).contiguous(),
                stddevs.reshape(-1, K).contiguous(),
                logits.reshape(-1, K).contiguous(),
                low.reshape(-1).contiguous(),
                high.reshape(-1).contiguous(),
            ).reshape(rows)
        return None

    def _row_components(self, generator):
        """For a homogeneous mixture with a 1-D batch: each row's component
        index drawn, and the distribution of the chosen components (batch
        ``[B]``) built from their gathered parameters; else None."""
        stacked, cls, gathered = self._stacked_normal_params(), Normal, 2  # (means, stddevs)
        if stacked is None:
            # (means, stddevs, low, high), the bounds one a row
            stacked, cls = self._stacked_tnorm_params(), TruncatedNormal
        if stacked is None:
            stacked, cls, gathered = self._stacked_studentt_params(), StudentT, 3  # (dfs, means, scales)
        if stacked is None:
            return None
        idx = self._mixing._sample(generator, ()).unsqueeze(-1)
        params = [torch.gather(p, -1, idx).squeeze(-1) for p in stacked[:gathered]]
        return cls(*params, *stacked[gathered:])

    def _sample(self, generator, shape):
        if shape == ():
            chosen = self._row_components(generator)
            if chosen is not None:
                return chosen._sample(generator, ())
        idx = self._mixing._sample(generator, shape)
        draws = torch.stack(
            [d._sample(generator, shape).expand(idx.shape) for d in self._distributions],
            dim=-1,
        )
        return torch.gather(draws, -1, idx.unsqueeze(-1)).squeeze(-1)

    @property
    def mean(self):
        w = torch.exp(self._mixing.logits)
        means = torch.stack(
            [d.mean.expand(self._batch_shape) for d in self._distributions], -1
        )
        return torch.sum(w * means, -1)

    @property
    def variance(self):
        w = torch.exp(self._mixing.logits)
        means = torch.stack(
            [d.mean.expand(self._batch_shape) for d in self._distributions], -1
        )
        variances = torch.stack(
            [d.variance.expand(self._batch_shape) for d in self._distributions], -1
        )
        m = torch.sum(w * means, -1)
        return torch.sum(w * (variances + means**2), -1) - m**2
