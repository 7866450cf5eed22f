"""Hand-written CUDA kernels for the hot distribution math, with their plain
PyTorch versions.

Counterparts of the Pallas kernels in ``pyprob_tpu/ops/kernels.py``:

* ``mixture_normal_log_prob``: the mixture-of-Normals log-density that
  scores the proposal of every particle (``csrc/mixture_normal.cu``), and
  its gradient (``mixture_normal_log_prob_backward``,
  ``csrc/mixture_normal_backward.cu``) behind the autograd Function
  ``MixtureNormalLogProb``, where the JAX package has a custom VJP;
* ``mixture_truncated_normal_log_prob``: the same with truncated
  components, the density of the Uniform prior's proposal head
  (``csrc/mixture_truncated_normal.cu``), and its gradient
  (``mixture_truncated_normal_log_prob_backward``,
  ``csrc/mixture_truncated_normal_backward.cu``) behind
  ``MixtureTruncatedNormalLogProb``;
* ``log_weight_stats``: (max, Σe^(w−max), Σe^2(w−max)) over the run's
  ``[N]`` log-weights, which give the ESS and log Z of a result
  (``csrc/log_weight_stats.cu``).

Each wrapper takes the plain version for a tensor on the CPU, and for a
CUDA tensor launches its kernel or raises: there is no fallback.  It
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on the current stream without synchronising,
and counts its launches in a plain integer attribute (``.launches``); the
two forwards also by row count (``.launch_rows``, a Counter) and kernel 3
by N (``.launch_sizes``).  The kernels are built at first launch
(``ops.build``).
"""

from __future__ import annotations

import collections
import math

import torch

from . import build

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _check(name, tensors, shapes):
    device = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != device:
            raise ValueError(f"{name}: all inputs must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32 inputs, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def _raise_on_error(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with error {err}")


# ---------------------------------------------------------------------------
# mixture-of-Normals log-density: x [B], means/stddevs/logits [B, K] -> [B]
# ---------------------------------------------------------------------------


def _normal_terms(x, means, stddevs, logits):
    """The [B, K] terms −z²/2 − log σ − log √(2π) + logit of the mixture."""
    z = (x[:, None] - means) / stddevs
    comp = -0.5 * z * z - torch.log(stddevs) - _LOG_SQRT_2PI
    return comp + logits


def mixture_normal_log_prob_plain(x, means, stddevs, logits):
    """Plain PyTorch version (``pyprob_tpu`` ``_mixture_normal_ref``)."""
    return torch.logsumexp(_normal_terms(x, means, stddevs, logits), dim=-1)


def mixture_normal_log_prob(x, means, stddevs, logits):
    """Mixture-of-Normals log-density per row.  x: [B]; params: [B, K].
    Differentiable: on the CPU through the plain version's autograd, on
    CUDA through ``MixtureNormalLogProb``, whose backward is a kernel too."""
    if means.dim() != 2 or means.shape[1] < 1:
        raise ValueError("mixture_normal_log_prob: means must be [B, K] with K >= 1")
    B, K = means.shape
    device = _check(
        "mixture_normal_log_prob",
        (x, means, stddevs, logits),
        ((B,), (B, K), (B, K), (B, K)),
    )
    if device.type == "cpu":
        return mixture_normal_log_prob_plain(x, means, stddevs, logits)
    return MixtureNormalLogProb.apply(x, means, stddevs, logits)


mixture_normal_log_prob.launches = 0
mixture_normal_log_prob.launch_rows = collections.Counter()


def _mixture_normal_forward_launch(x, means, stddevs, logits):
    B, K = means.shape
    device = x.device
    out = torch.empty((B,), dtype=torch.float32, device=device)
    if B == 0:
        return out
    err = build.library().pyprob_mixture_normal_log_prob_f32(
        x.data_ptr(), means.data_ptr(), stddevs.data_ptr(), logits.data_ptr(),
        out.data_ptr(), B, K, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on_error("mixture_normal_log_prob", err)
    mixture_normal_log_prob.launches += 1
    mixture_normal_log_prob.launch_rows[B] += 1
    return out


def mixture_normal_log_prob_backward_plain(x, means, stddevs, logits, out, g):
    """Closed-form gradient of the mixture log-density (the VJP of
    ``_mixture_normal_ref``): (dx, dmeans, dstddevs, dlogits) for the
    cotangent ``g`` [B] of ``out`` [B].  With z = (x − μ)/σ and
    r = exp(term − out): dlogits = g·r, dmeans = g·r·z/σ,
    dstddevs = g·r·(z² − 1)/σ, dx = −Σ_k dmeans."""
    z = (x[:, None] - means) / stddevs
    t = -0.5 * z * z - torch.log(stddevs) - _LOG_SQRT_2PI + logits
    gr = g[:, None] * torch.exp(t - out[:, None])
    dmeans = gr * z / stddevs
    dstddevs = gr * (z * z - 1.0) / stddevs
    return -dmeans.sum(dim=-1), dmeans, dstddevs, gr


def mixture_normal_log_prob_backward(x, means, stddevs, logits, out, g, need_x=True):
    """(dx, dmeans, dstddevs, dlogits) of the mixture log-density for the
    cotangent ``g`` of its output ``out``; dx is None unless ``need_x``."""
    if means.dim() != 2 or means.shape[1] < 1:
        raise ValueError("mixture_normal_log_prob_backward: means must be [B, K] with K >= 1")
    B, K = means.shape
    device = _check(
        "mixture_normal_log_prob_backward",
        (x, means, stddevs, logits, out, g),
        ((B,), (B, K), (B, K), (B, K), (B,), (B,)),
    )
    if device.type == "cpu":
        dx, dmeans, dstddevs, dlogits = mixture_normal_log_prob_backward_plain(
            x, means, stddevs, logits, out, g
        )
        return (dx if need_x else None), dmeans, dstddevs, dlogits
    dx = torch.empty((B,), dtype=torch.float32, device=device) if need_x else None
    dmeans, dstddevs, dlogits = (
        torch.empty((B, K), dtype=torch.float32, device=device) for _ in range(3)
    )
    if B == 0:
        return dx, dmeans, dstddevs, dlogits
    err = build.library().pyprob_mixture_normal_log_prob_backward_f32(
        x.data_ptr(), means.data_ptr(), stddevs.data_ptr(), logits.data_ptr(),
        out.data_ptr(), g.data_ptr(), None if dx is None else dx.data_ptr(),
        dmeans.data_ptr(), dstddevs.data_ptr(), dlogits.data_ptr(), B, K,
        device.index, torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on_error("mixture_normal_log_prob_backward", err)
    mixture_normal_log_prob_backward.launches += 1
    return dx, dmeans, dstddevs, dlogits


mixture_normal_log_prob_backward.launches = 0


class MixtureNormalLogProb(torch.autograd.Function):
    """The CUDA forward and backward kernels as one differentiable op
    (the JAX package's ``mixture_normal_log_prob_fused`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, means, stddevs, logits):
        out = _mixture_normal_forward_launch(x, means, stddevs, logits)
        ctx.save_for_backward(x, means, stddevs, logits, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, means, stddevs, logits, out = ctx.saved_tensors
        # the cotangent of a sum arrives expanded (stride 0)
        return mixture_normal_log_prob_backward(
            x, means, stddevs, logits, out, g.contiguous(),
            need_x=ctx.needs_input_grad[0],
        )


# ---------------------------------------------------------------------------
# mixture of truncated Normals: x, low, high [B], means/stddevs/logits [B, K]
# -> [B] (the Uniform prior's proposal head)
# ---------------------------------------------------------------------------

_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _ndtr(z):
    # a product with 1/√2, not a quotient: PyTorch's CUDA division by a
    # scalar multiplies by its reciprocal, and the kernels do the same, so
    # Φ(β) − Φ(α) cancels alike on both sides
    return 0.5 * (1.0 + torch.erf(z * _INV_SQRT_2))


def _tnorm_terms(x, means, stddevs, logits, low, high):
    """(terms, ξ, α, β, Z [B, K], inside [B]) of the truncated mixture, with
    term = −ξ²/2 − log √(2π) − log σ − log max(Z, 1e-12) + logit and
    Z = Φ(β) − Φ(α) unclipped."""
    alpha = (low[:, None] - means) / stddevs
    beta = (high[:, None] - means) / stddevs
    zraw = _ndtr(beta) - _ndtr(alpha)
    xi = (x[:, None] - means) / stddevs
    t = (
        -0.5 * xi * xi
        - _LOG_SQRT_2PI
        - torch.log(stddevs)
        - torch.log(torch.clamp(zraw, min=1e-12))
        + logits
    )
    inside = (x >= low) & (x <= high)
    return t, xi, alpha, beta, zraw, inside


def mixture_truncated_normal_log_prob_plain(x, means, stddevs, logits, low, high):
    """Plain PyTorch version (``pyprob_tpu`` ``_mixture_tnorm_ref``): the
    logsumexp of the K truncated terms, −inf where x ∉ [low, high]."""
    t, _, _, _, _, inside = _tnorm_terms(x, means, stddevs, logits, low, high)
    lse = torch.logsumexp(t, dim=-1)
    return torch.where(inside, lse, torch.full_like(lse, -math.inf))


def _check_tnorm(name, tensors, B, K):
    shapes = ((B,), (B, K), (B, K), (B, K), (B,), (B,)) + ((B,),) * (len(tensors) - 6)
    return _check(name, tensors, shapes)


def mixture_truncated_normal_log_prob(x, means, stddevs, logits, low, high):
    """Mixture-of-truncated-Normals log-density per row.  x, low, high: [B];
    params: [B, K].  Differentiable through ``MixtureTruncatedNormalLogProb``
    on both devices, so its gradient is the JAX package's custom VJP
    (``_mt_bwd``) on both: the plain closed form on the CPU, the backward
    kernel on CUDA."""
    if means.dim() != 2 or means.shape[1] < 1:
        raise ValueError("mixture_truncated_normal_log_prob: means must be [B, K] with K >= 1")
    B, K = means.shape
    _check_tnorm("mixture_truncated_normal_log_prob", (x, means, stddevs, logits, low, high), B, K)
    return MixtureTruncatedNormalLogProb.apply(x, means, stddevs, logits, low, high)


mixture_truncated_normal_log_prob.launches = 0
mixture_truncated_normal_log_prob.launch_rows = collections.Counter()


def _mixture_tnorm_forward(x, means, stddevs, logits, low, high):
    if x.device.type == "cpu":
        return mixture_truncated_normal_log_prob_plain(x, means, stddevs, logits, low, high)
    B, K = means.shape
    out = torch.empty((B,), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    err = build.library().pyprob_mixture_truncated_normal_log_prob_f32(
        x.data_ptr(), means.data_ptr(), stddevs.data_ptr(), logits.data_ptr(),
        low.data_ptr(), high.data_ptr(), out.data_ptr(), B, K, x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on_error("mixture_truncated_normal_log_prob", err)
    mixture_truncated_normal_log_prob.launches += 1
    mixture_truncated_normal_log_prob.launch_rows[B] += 1
    return out


def mixture_truncated_normal_log_prob_backward_plain(x, means, stddevs, logits, low, high, out, g):
    """Closed-form gradient of the truncated mixture log-density, as the JAX
    package's ``_mt_bwd`` takes it: a non-finite cotangent counts as 0, rows
    with x ∉ [low, high] get 0, and every non-finite gradient becomes 0.
    With r = g·exp(term − out), φ the standard Normal density and
    Z = Φ(β) − Φ(α) (its terms 0 where the 1e-12 clip is active):
    dlogits = r, dmeans = r·(ξ/σ − (φ(α)−φ(β))/(σZ)),
    dstddevs = r·((ξ²−1)/σ − (αφ(α)−βφ(β))/(σZ)), dx = −Σ r·ξ/σ,
    dlow = Σ r·φ(α)/(σZ), dhigh = −Σ r·φ(β)/(σZ).
    Returns (dx, dmeans, dstddevs, dlogits, dlow, dhigh)."""
    t, xi, alpha, beta, zraw, inside = _tnorm_terms(x, means, stddevs, logits, low, high)
    g = torch.where(torch.isfinite(g) & inside, g, torch.zeros_like(g))
    r = g[:, None] * torch.exp(t - out[:, None])
    pa = torch.exp(-0.5 * alpha * alpha) * _INV_SQRT_2PI
    pb = torch.exp(-0.5 * beta * beta) * _INV_SQRT_2PI
    # σZ, or +inf where the clip is active so that the Z terms vanish
    sz = torch.where(zraw >= 1e-12, stddevs * zraw, torch.full_like(zraw, math.inf))
    r_sigma = r / stddevs
    dmeans = r_sigma * xi - r * (pa - pb) / sz
    dstddevs = r_sigma * (xi * xi - 1.0) - r * (alpha * pa - beta * pb) / sz
    dx = -(r_sigma * xi).sum(dim=-1)
    dlow = (r * pa / sz).sum(dim=-1)
    dhigh = -(r * pb / sz).sum(dim=-1)
    return tuple(
        torch.where(torch.isfinite(a), a, torch.zeros_like(a))
        for a in (dx, dmeans, dstddevs, r, dlow, dhigh)
    )


def mixture_truncated_normal_log_prob_backward(
    x, means, stddevs, logits, low, high, out, g, need_x=True, need_bounds=True
):
    """(dx, dmeans, dstddevs, dlogits, dlow, dhigh) of the truncated mixture
    log-density for the cotangent ``g`` of its output ``out``; dx is None
    unless ``need_x``, dlow and dhigh are None unless ``need_bounds``."""
    if means.dim() != 2 or means.shape[1] < 1:
        raise ValueError(
            "mixture_truncated_normal_log_prob_backward: means must be [B, K] with K >= 1"
        )
    B, K = means.shape
    device = _check_tnorm(
        "mixture_truncated_normal_log_prob_backward",
        (x, means, stddevs, logits, low, high, out, g), B, K,
    )
    if device.type == "cpu":
        dx, dmeans, dstddevs, dlogits, dlow, dhigh = (
            mixture_truncated_normal_log_prob_backward_plain(
                x, means, stddevs, logits, low, high, out, g
            )
        )
        if not need_bounds:
            dlow = dhigh = None
        return (dx if need_x else None), dmeans, dstddevs, dlogits, dlow, dhigh

    def vector(needed):
        return torch.empty((B,), dtype=torch.float32, device=device) if needed else None

    dx, dlow, dhigh = vector(need_x), vector(need_bounds), vector(need_bounds)
    dmeans, dstddevs, dlogits = (
        torch.empty((B, K), dtype=torch.float32, device=device) for _ in range(3)
    )
    if B == 0:
        return dx, dmeans, dstddevs, dlogits, dlow, dhigh
    err = build.library().pyprob_mixture_truncated_normal_log_prob_backward_f32(
        x.data_ptr(), means.data_ptr(), stddevs.data_ptr(), logits.data_ptr(),
        low.data_ptr(), high.data_ptr(), out.data_ptr(), g.data_ptr(),
        None if dx is None else dx.data_ptr(), dmeans.data_ptr(), dstddevs.data_ptr(),
        dlogits.data_ptr(), None if dlow is None else dlow.data_ptr(),
        None if dhigh is None else dhigh.data_ptr(), B, K, device.index,
        torch.cuda.current_stream(device).cuda_stream,
    )
    _raise_on_error("mixture_truncated_normal_log_prob_backward", err)
    mixture_truncated_normal_log_prob_backward.launches += 1
    return dx, dmeans, dstddevs, dlogits, dlow, dhigh


mixture_truncated_normal_log_prob_backward.launches = 0


class MixtureTruncatedNormalLogProb(torch.autograd.Function):
    """The truncated mixture's forward and backward as one differentiable op
    (the JAX package's ``mixture_truncated_normal_log_prob_fused`` custom
    VJP): the kernels on CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, means, stddevs, logits, low, high):
        out = _mixture_tnorm_forward(x, means, stddevs, logits, low, high)
        ctx.save_for_backward(x, means, stddevs, logits, low, high, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, means, stddevs, logits, low, high, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        # the cotangent of a sum arrives expanded (stride 0)
        return mixture_truncated_normal_log_prob_backward(
            x, means, stddevs, logits, low, high, out, g.contiguous(),
            need_x=need[0], need_bounds=need[4] or need[5],
        )


# ---------------------------------------------------------------------------
# log-weight statistics: [N] -> (max, Σ e^(w−max), Σ e^2(w−max))
# ---------------------------------------------------------------------------


def log_weight_stats_plain(log_weights):
    """Plain PyTorch version (``pyprob_tpu`` ``_log_weight_stats_ref``),
    giving (−inf, NaN, NaN) when every weight is −inf, as it does."""
    lw = log_weights.reshape(-1)
    m = lw.max()
    e = torch.exp(lw - m)
    return m, e.sum(), (e * e).sum()


def log_weight_stats(log_weights):
    """(max, Σ e^(w−max), Σ e^2(w−max)) of [N] float32 log-weights, as
    three 0-d tensors on their device, views of ``log_weight_stats_packed``'s
    [3] output.  ESS = s1²/s2; log Z = max + log s1."""
    return log_weight_stats_packed(log_weights).unbind()


def log_weight_stats_packed(log_weights):
    """``log_weight_stats`` as one [3] tensor (m, s1, s2): one launch on the
    card, and one copy where the host wants all three.

    As ``_log_weight_stats_ref``: m is NaN where a weight is NaN, s1 and
    s2 are NaN where m is not finite: every weight −inf gives (−inf, NaN,
    NaN), and the batched tier maps m = −inf to ESS 0 itself.
    The kernel merges its blocks in the same launch: the last block to
    finish, found by a ticket counter, reads every block's triple from a
    scratch buffer and resets the counter.  Scratch and counter are made
    once and kept for each (device, stream): launches on one stream run in
    order, but two streams sharing a counter could interleave their
    tickets.  Launches on the card count in ``log_weight_stats.launches``
    and, by N, in ``log_weight_stats.launch_sizes``."""
    if log_weights.dim() != 1:
        raise ValueError("log_weight_stats: expected a 1-D tensor of log-weights")
    n = log_weights.shape[0]
    device = _check("log_weight_stats", (log_weights,), ((n,),))
    if n == 0:
        raise ValueError("log_weight_stats: no log-weights")
    if device.type == "cpu":
        return torch.stack(log_weight_stats_plain(log_weights))
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch, counter, capacity = _stats_scratch(device, stream)
    out = torch.empty((3,), dtype=torch.float32, device=device)
    err = build.library().pyprob_log_weight_stats_f32(
        log_weights.data_ptr(), scratch.data_ptr(), counter.data_ptr(), out.data_ptr(),
        n, capacity, device.index, stream,
    )
    _raise_on_error("log_weight_stats", err)
    log_weight_stats.launches += 1
    log_weight_stats.launch_sizes[n] += 1
    return out


_STATS_SCRATCH = {}  # (device index, stream) -> (scratch, counter, capacity)


def _stats_scratch(device, stream):
    key = (device.index, stream)
    if key not in _STATS_SCRATCH:
        capacity = build.library().pyprob_log_weight_stats_capacity(device.index)
        if capacity < 1:
            raise RuntimeError(f"log_weight_stats: no block capacity for {device}")
        _STATS_SCRATCH[key] = (
            torch.empty((3 * capacity,), dtype=torch.float32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device),
            capacity,
        )
    return _STATS_SCRATCH[key]


log_weight_stats.launches = 0
log_weight_stats.launch_sizes = collections.Counter()


def reset_launch_counts():
    mixture_normal_log_prob.launches = 0
    mixture_normal_log_prob.launch_rows.clear()
    mixture_normal_log_prob_backward.launches = 0
    mixture_truncated_normal_log_prob.launches = 0
    mixture_truncated_normal_log_prob.launch_rows.clear()
    mixture_truncated_normal_log_prob_backward.launches = 0
    log_weight_stats.launches = 0
    log_weight_stats.launch_sizes.clear()
