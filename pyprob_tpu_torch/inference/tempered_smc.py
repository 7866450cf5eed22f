"""Tempered SMC (Del Moral, Doucet & Jasra 2006) over the program's latent
sites (counterpart of ``pyprob_tpu/inference/tempered_smc.py``).

A population of N particles moves from the prior to the posterior along a
likelihood-temperature ladder

    pi_b(z)  ∝  prior(z) · likelihood(z)^b ,     0 = b_0 < b_1 < ... < b_T = 1

each next temperature chosen by bisection so that the incremental weights'
effective sample size stays at ``resample_threshold`` of N; the particles
are resampled every stage and rejuvenated by M HMC moves at the new
temperature (step size by dual averaging from the mean acceptance).  The
product of the incremental weights' means is an unbiased estimate of the
marginal likelihood (``posterior.log_evidence``).  Enumerable discrete
sites are marginalized per combination, as in the other gradient engines:
each particle carries its parts lp, ll [G] (``_FunctionalModel.
potential_parts``) and the tempered target is Σ_G exp(lp + b·ll).

The JAX package runs the anneal as one ``lax.while_loop``.  Here a stage
is a Python step over the ``[N]`` particles on the card:

- the incremental log-weights at a candidate b are logsumexp_G(lp + b·ll) −
  logsumexp_G(lp + β·ll), and their log ESS, 2·log Σe^(w−max) −
  log Σe^(2(w−max)), comes from one launch of kernel 3
  (``ops.kernels.log_weight_stats_packed``); the check at b = 1 and the 26
  bisection steps each take one launch, and the choice between their
  halves is a ``torch.where`` on the card (no host sync);
- the log Z increment, max + log Σe^(w−max) − log N, is one more launch at
  the chosen temperature;
- resampling is ``parallel.collectives``' (its uniforms from the run's
  generator, all four schemes), the particles and their parts a gather;
- rejuvenation is M HMC moves over all N rows (unit mass),
  ``_FunctionalModel.tempered_move``: each leapfrog one batched tempered
  replay, the whole move one CUDA graph on a card where the potential
  launches none of the hand-written kernels.

The one host sync of a stage reads whether β reached 1 (or the stage cap).
"""

from __future__ import annotations

import math
import time

import torch

from .. import util
from ..ops import kernels
from ..parallel.collectives import _scheme, draw_uniforms, indices_from_uniforms
from ..vectorized import _skips_batched_tier, _TraceabilityCache
from .hmc import (
    Untraceable,
    _da_init,
    _da_update,
    _decoded_empirical,
    _functionalize,
    _mesh_later,
)

_BISECTION_STEPS = 26


def incremental_weights(lp, ll, beta, b):
    """The [N] incremental log-weights of moving the particles' parts lp,
    ll [N, G] from temperature β to b (0-d tensors)."""
    return torch.logsumexp(lp + b * ll, -1) - torch.logsumexp(lp + beta * ll, -1)


def log_ess(w):
    """log ESS of the [N] log-weights w from one launch of kernel 3: 2·log
    Σe^(w−max) − log Σe^(2(w−max)) (NaN where every weight is −inf, which
    no comparison accepts)."""
    _, s1, s2 = kernels.log_weight_stats_packed(w).unbind()
    return 2.0 * torch.log(s1) - torch.log(s2)


def log_mean_weight(w):
    """log mean e^w of the [N] log-weights from one launch of kernel 3:
    max + log Σe^(w−max) − log N (−inf where every weight is −inf)."""
    m, s1, _ = kernels.log_weight_stats_packed(w).unbind()
    return torch.where(m == -math.inf, m, m + torch.log(s1)) - math.log(w.shape[0])


def next_temperature(lp, ll, beta, log_target_ess):
    """The next inverse temperature after β (0-d): 1 where the incremental
    weights' log ESS at 1 reaches ``log_target_ess``, else the JAX
    package's 26 bisection steps on [β, 1] toward that ESS, then at least
    β + 1e-5 and at most 1.  Every step decides on the card."""
    one = torch.ones_like(beta)
    full_ok = log_ess(incremental_weights(lp, ll, beta, one)) >= log_target_ess
    lo, hi = beta, one
    for _ in range(_BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        ok = log_ess(incremental_weights(lp, ll, beta, mid)) >= log_target_ess
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    new_beta = torch.where(full_ok, one, 0.5 * (lo + hi))
    return torch.clamp(torch.maximum(new_beta, beta + 1e-5), max=1.0)


def tempered_stage(fm, obs, z, lp, ll, beta, da, generator, log_target_ess, resampling, rejuvenation_steps,
                   leapfrog_steps, target_accept):
    """One stage of the anneal: the next temperature, the log Z increment,
    resampling, M rejuvenation moves.  Returns (z, lp, ll, new β, log Z
    increment, da, Σ of the moves' mean acceptances), all on the card."""
    n, dim = z.shape
    new_beta = next_temperature(lp, ll, beta, log_target_ess)
    w = incremental_weights(lp, ll, beta, new_beta)
    log_z_inc = log_mean_weight(w)
    uniforms = draw_uniforms(generator, n, resampling, z.device)
    idx = indices_from_uniforms(w, uniforms, n, resampling)
    z, lp, ll = z[idx], lp[idx], ll[idx]
    beta_rows = new_beta.expand(n)
    _, g, _, _ = fm.value_and_grad_beta(z, beta_rows, obs)
    unit_mass = torch.ones_like(z)
    acc = torch.zeros_like(beta)
    for _ in range(rejuvenation_steps):
        eps = torch.exp(da[1]).expand(n)
        p0 = torch.randn((n, dim), generator=generator, dtype=z.dtype, device=z.device)
        uniform = torch.rand((n,), generator=generator, dtype=z.dtype, device=z.device)
        z, lp, ll, g, alpha = fm.tempered_move(
            z, lp, ll, g, beta_rows, eps, unit_mass, p0, uniform, leapfrog_steps, obs
        )
        mean_alpha = alpha.mean()
        da = _da_update(da, mean_alpha, target_accept)
        acc = acc + mean_alpha
    return z, lp, ll, new_beta, log_z_inc, da, acc


def vectorized_tempered_smc_posterior(model, num_traces, observe=None, map_func=None, file_name=None,
                                      resample_threshold=0.5, resampling="systematic", rejuvenation_steps=None,
                                      leapfrog_steps=None, target_accept=None, step_size=None, max_stages=None,
                                      likelihood_importance=1.0, mesh=None, args=(), kwargs=None):
    """Anneal ``num_traces`` particles from prior to posterior; returns a
    uniform-weight Empirical with ``log_evidence``, or None if the model
    does not run on the batched tier (tempered SMC has no interpreter
    tier)."""
    if mesh is not None:
        raise _mesh_later()
    if _skips_batched_tier(model, fallback=True):
        return None
    if not observe:
        raise RuntimeError("TEMPERED_SMC requires observe={...} values")
    _scheme(resampling)
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    t0 = time.time()
    rejuvenation_steps = 2 if rejuvenation_steps is None else int(rejuvenation_steps)
    leapfrog_steps = 10 if leapfrog_steps is None else int(leapfrog_steps)
    target_accept = 0.65 if target_accept is None else float(target_accept)
    step_size = 0.1 if step_size is None else float(step_size)
    max_stages = 200 if max_stages is None else int(max_stages)
    device = util.device()
    generator = util.generator(device)
    observed = {k: util.to_tensor(v, device) for k, v in observe.items()}
    results_only = getattr(map_func, "__name__", "") == "trace_result"
    try:
        fm = _functionalize(model, observed, likelihood_importance, "TEMPERED_SMC", args, kwargs, generator)
    except Untraceable as e:
        util.log_print(f"[pyprob_tpu_torch] model {model.name!r} does not run on the batched tier ({e}); "
                       "TEMPERED_SMC has no interpreter tier.")
        _TraceabilityCache.mark(model, False)
        return None
    _TraceabilityCache.mark(model, True)

    n = int(num_traces)
    f32 = util.dtype()
    log_target_ess = torch.log(torch.tensor(float(resample_threshold) * n, dtype=f32, device=device))
    z = fm.encode(n, observed)
    with torch.no_grad():
        lp, ll = fm.potential_parts(z, observed)
    beta = torch.zeros((), dtype=f32, device=device)
    log_z = torch.zeros((), dtype=f32, device=device)
    da = _da_init(torch.tensor(step_size, dtype=f32, device=device))
    acc_sum = torch.zeros((), dtype=f32, device=device)
    stages = 0
    t_anneal = time.time()
    # one host sync a stage: whether β reached 1
    while stages < max_stages and (stages == 0 or bool(beta < 1.0)):
        z, lp, ll, beta, log_z_inc, da, acc = tempered_stage(
            fm, observed, z, lp, ll, beta, da, generator, log_target_ess, resampling, rejuvenation_steps,
            leapfrog_steps, target_accept,
        )
        log_z = log_z + log_z_inc
        acc_sum = acc_sum + acc
        stages += 1
    anneal_seconds = time.time() - t_anneal
    log_evidence, final_beta, acc_total, final_eps = (float(v) for v in (log_z, beta, acc_sum, torch.exp(da[1])))
    acceptance_rate = acc_total / max(stages * rejuvenation_steps, 1)

    emp = _decoded_empirical(fm, z, observed, map_func, results_only, file_name)
    emp.log_evidence = log_evidence
    duration = time.time() - t0
    emp.rename(
        f"Posterior, tempered SMC ({stages} adaptive stages), particles: "
        f"{emp.length:,}, log Z: {log_evidence:.3f}"
    )
    emp.add_metadata(
        op="posterior",
        num_traces=num_traces,
        inference_engine="InferenceEngine.TEMPERED_SMC",
        stages=stages,
        final_beta=final_beta,
        log_evidence=log_evidence,
        acceptance_rate=acceptance_rate,
        final_step_size=final_eps,
        resample_threshold=float(resample_threshold),
        resampling=resampling,
        rejuvenation_steps=rejuvenation_steps,
        leapfrog_steps=leapfrog_steps,
        vectorized=True,
        anneal_seconds=anneal_seconds,
        host_syncs=stages,
        potential_graph=any(e is not None for e in fm._graphs.values()),
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[tempered SMC] {emp.length:,} particles through {stages} "
            f"adaptive stages in {duration:.3f}s, log Z {log_evidence:.3f}, "
            f"rejuvenation acceptance {acceptance_rate:.2f}"
        )
    return emp
