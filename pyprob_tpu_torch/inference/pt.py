"""Parallel tempering (replica exchange) over the program's continuous
latent sites (counterpart of ``pyprob_tpu/inference/pt.py``).

K replicas of each chain target a ladder of tempered densities

    pi_k(z)  ∝  prior(z) · likelihood(z)^beta_k ,   0 = beta_0 < ... < beta_{K-1} = 1

(the quadratic ladder beta_k = (k/(K-1))², dense near 1 where the target
changes fastest), and each transition proposes swapping configurations
between adjacent temperatures with the general tempered-energy acceptance
min(1, exp(E_i(z_i) + E_j(z_j) - E_i(z_j) - E_j(z_i))), exact with
enumerated discrete sites (E_b = -logsumexp_G(lp + b·ll), from the parts
each replica carries).  Hot replicas roam between modes that gradient
chains cannot cross, and the swaps carry those jumps down to the cold
replica, whose draws are the posterior's.

The JAX package ``vmap``s one replica's move over the ladder and the
ensembles.  Here C ensembles × K replicas are the ``[C·K]`` rows of one
batched tempered replay (``_FunctionalModel.value_and_grad_beta``, each row
at its own β): one transition is K replica HMC moves in one leapfrog loop
over all rows (``_FunctionalModel.tempered_move``, one CUDA graph on a card
where the potential launches none of the hand-written kernels), then the
even/odd swap sweep, a permutation gathered on the card, then the gradient
again at each replica's new β.  The chain loop,
warmup and resumes are the gradient engines' shared driver
(``hmc._gradient_mcmc_posterior`` with ``replicas=K``): every replica
adapts its own step size and diagonal mass against its own target, and the
saved ``GradientChainState`` is the whole ladder [C, K, D].
"""

from __future__ import annotations

import torch

from .hmc import _gradient_mcmc_posterior, tempered_potential


def ladder(num_temperatures, like):
    """The quadratic ladder β_k = (k/(K-1))², k = 0..K-1, as a [K] tensor."""
    K = int(num_temperatures)
    return torch.tensor([(k / (K - 1)) ** 2 for k in range(K)], dtype=like.dtype, device=like.device)


def pt_transition(fm, obs, z, lp, ll, g, betas, eps, inv_mass, p0, accept_uniform, swap_uniform, t, leapfrog_steps):
    """One ensemble transition of C ensembles of K replicas of ``fm``'s
    tempered target, given its draws: z, g, inv_mass, p0 [C, K, D]; lp, ll
    [C, K, G]; betas [K]; eps and accept_uniform [C, K]; swap_uniform [C,
    K-1]; the step t (pairs (k, k+1) with k ≡ t mod 2 may swap).  The
    replica moves are one ``fm.tempered_move`` over R = C·K rows.  Returns
    (z, lp, ll, g, alpha [C, K] of the replica moves, do_swap [C, K-1],
    active [K-1])."""
    C, K, D = z.shape
    G = lp.shape[-1]
    R = C * K
    beta_rows = betas.expand(C, K).reshape(R)
    z, lp, ll, g, alpha = fm.tempered_move(
        z.reshape(R, D), lp.reshape(R, G), ll.reshape(R, G), g.reshape(R, D), beta_rows, eps.reshape(R),
        inv_mass.reshape(R, D), p0.reshape(R, D), accept_uniform.reshape(R), leapfrog_steps, obs,
    )
    z, lp, ll = z.reshape(C, K, D), lp.reshape(C, K, G), ll.reshape(C, K, G)
    # the even/odd sweep: log a = [E_k(z_k) + E_k+1(z_k+1)] - [E_k(z_k+1) + E_k+1(z_k)]
    ks = torch.arange(K - 1, device=z.device)
    active = (ks % 2) == (t % 2)
    e_self = tempered_potential(lp.reshape(R, G), ll.reshape(R, G), beta_rows).reshape(C, K)
    lo_beta, hi_beta = betas[:-1].expand(C, K - 1).reshape(-1), betas[1:].expand(C, K - 1).reshape(-1)
    e_lo_hi = tempered_potential(lp[:, 1:].reshape(-1, G), ll[:, 1:].reshape(-1, G), lo_beta).reshape(C, K - 1)
    e_hi_lo = tempered_potential(lp[:, :-1].reshape(-1, G), ll[:, :-1].reshape(-1, G), hi_beta).reshape(C, K - 1)
    log_a = (e_self[:, :-1] + e_self[:, 1:]) - (e_lo_hi + e_hi_lo)
    do_swap = active & (torch.log(swap_uniform) < log_a)
    # the accepted pairs are disjoint (one parity a sweep): swap them
    perm = torch.arange(K, device=z.device).expand(C, K)
    perm = torch.cat([torch.where(do_swap, ks + 1, perm[:, :-1]), perm[:, -1:]], 1)
    perm = torch.cat([perm[:, :1], torch.where(do_swap, ks, perm[:, 1:])], 1)
    z = torch.gather(z, 1, perm[..., None].expand(C, K, D))
    lp = torch.gather(lp, 1, perm[..., None].expand(C, K, G))
    ll = torch.gather(ll, 1, perm[..., None].expand(C, K, G))
    # the gradient moved with its configuration was taken at the old β:
    # take it again at each replica's own
    _, g, _, _ = fm.value_and_grad_beta(z.reshape(R, D), beta_rows, obs)
    return z, lp, ll, g.reshape(C, K, D), alpha.reshape(C, K), do_swap, active


def vectorized_pt_posterior(model, num_traces, observe=None, map_func=None, file_name=None, num_chains=None,
                            burn_in=None, thinning_steps=None, num_temperatures=None, leapfrog_steps=None,
                            target_accept=None, step_size=None, likelihood_importance=1.0, mesh=None,
                            return_chains=False, initial_state=None, args=(), kwargs=None):
    """Parallel-tempering posterior: C ensembles × K tempered replicas on the
    batched tier.  Returns an Empirical of the cold (β = 1) replicas' draws
    with acceptance and swap-rate metadata (and ``final_gradient_state``,
    the replica ladder, for warm resumes), or None if the model does not run
    on the batched tier (PT has no interpreter tier)."""
    num_temperatures = 8 if num_temperatures is None else int(num_temperatures)
    if num_temperatures < 2:
        raise ValueError(
            "PARALLEL_TEMPERING needs num_temperatures >= 2 (a single "
            "temperature is plain HMC — use HAMILTONIAN_MONTE_CARLO)"
        )
    K = num_temperatures
    leapfrog_steps = 10 if leapfrog_steps is None else int(leapfrog_steps)
    target_accept = 0.75 if target_accept is None else float(target_accept)
    if num_chains is None and initial_state is None:
        # an ensemble costs K replica moves a kept draw: fewer, longer
        # chains than plain HMC (a warm start takes its count from the state)
        num_chains = int(min(max(1, num_traces // 1024), 256))
    # the ladder, the step count and the replicas' parts (which travel with
    # their configurations), set by the first potential
    carried = {}

    def start(fm, obs, z):
        carried["betas"], carried["t"] = ladder(K, z), 0
        beta_rows = carried["betas"].expand(z.shape[0] // K, K).reshape(-1)
        u, g, carried["lp"], carried["ll"] = fm.value_and_grad_beta(z, beta_rows, obs)
        return u, g

    def transition(fm, obs, z, u, g, eps, inv_mass, generator):
        R, D = z.shape
        C = R // K
        G = carried["lp"].shape[-1]
        like = dict(dtype=z.dtype, device=z.device)
        p0 = torch.randn((R, D), generator=generator, **like) / torch.sqrt(inv_mass)
        accept_uniform = torch.rand((R,), generator=generator, **like)
        swap_uniform = torch.rand((C, K - 1), generator=generator, **like)
        betas = carried["betas"]
        z, lp, ll, g, alpha, do_swap, active = pt_transition(
            fm, obs, z.reshape(C, K, D), carried["lp"].reshape(C, K, G),
            carried["ll"].reshape(C, K, G), g.reshape(C, K, D), betas, eps.reshape(C, K),
            inv_mass.reshape(C, K, D), p0.reshape(C, K, D), accept_uniform.reshape(C, K), swap_uniform,
            carried["t"], leapfrog_steps,
        )
        carried["t"] += 1
        carried["lp"], carried["ll"] = lp.reshape(R, G), ll.reshape(R, G)
        u = tempered_potential(carried["lp"], carried["ll"], betas.expand(C, K).reshape(R))
        stats = {"swaps": do_swap.to(z.dtype).sum(1), "swap_pairs": active.to(z.dtype).sum().expand(C)}
        return z.reshape(R, D), u, g.reshape(R, D), alpha.reshape(R), stats

    def summarize(sums, post_steps):
        return {
            "swap_acceptance_rate": float(sums["swaps"].sum()) / max(float(sums["swap_pairs"].sum()), 1.0),
        }

    return _gradient_mcmc_posterior(
        model=model,
        engine_name="PARALLEL_TEMPERING",
        engine_label="PT",
        transition=transition,
        summarize=summarize,
        target_accept=target_accept,
        metadata_extra={"num_temperatures": K, "leapfrog_steps": leapfrog_steps},
        num_traces=num_traces,
        observe=observe,
        map_func=map_func,
        file_name=file_name,
        num_chains=num_chains,
        burn_in=burn_in,
        thinning_steps=thinning_steps,
        step_size=step_size,
        likelihood_importance=likelihood_importance,
        mesh=mesh,
        return_chains=return_chains,
        args=args,
        kwargs=kwargs,
        initial_state=initial_state,
        replicas=K,
        start=start,
    )
