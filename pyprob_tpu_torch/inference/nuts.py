"""No-U-Turn Sampler over the program's continuous latent sites
(counterpart of ``pyprob_tpu/inference/nuts.py``).

NUTS (arXiv:1111.4246) extends HMC (``inference/hmc.py``, whose base,
warmup and driver it shares) with dynamic trajectory lengths: each
transition grows a balanced binary tree of leapfrog states by doubling
until the trajectory starts to double back (a U-turn) or the energy error
diverges, then takes the next state multinomially from the tree's leaves
weighted by exp(-H).

As in the JAX package the tree is built iteratively: a doubling loop, and
within a doubling a loop of single leapfrog leaves; U-turn checks use
online checkpointing (a leaf at even in-subtree index i stores its
momentum and the running momentum sum at slot popcount(i >> 1), a leaf at
odd i checks the balanced spans ending at it), sampling is multinomial
over leaves, progressive within a subtree and biased between the tree and
each new subtree (Stan's variant), and a leaf whose energy error exceeds
1000 is a divergence that rejects its subtree.

The JAX package ``vmap``s nested ``while_loop``s, which run until every
chain is done.  Here they are Python loops over doublings and leaves over
all C chains in lockstep: every leaf is one replay forward and backward of
the C chains, a chain that has stopped keeps its state by ``torch.where``,
and the loops end when no chain is active, which the host reads once a
leaf (and once a doubling).  One slow chain holds every chain to its tree
depth, as under ``vmap``: the replays of a transition are 2^depth of the
deepest chain, less one; ``metadata`` reports them and the host syncs.
"""

from __future__ import annotations

import math

import torch

from .hmc import _gradient_mcmc_posterior

_DELTA_MAX = 1000.0


def _trailing_ones(i):
    """Number of contiguous low set bits of ``i`` (0b..0111 -> 3)."""
    return bin(((i + 1) & -(i + 1)) - 1).count("1")


def nuts_transition(value_and_grad, z, u, g, eps, inv_mass, p0, directions, tree_uniforms, leaf_uniform,
                    max_tree_depth, counters=None):
    """One NUTS transition of every chain, given its draws: the momentum p0
    [C, D], the direction of each doubling ``directions`` [max_tree_depth,
    C] (+1 or -1), the uniform of each doubling's biased sampling between
    tree and subtree ``tree_uniforms`` [max_tree_depth, C], and
    ``leaf_uniform(j, i)``, the uniform [C] of leaf i of doubling j's
    progressive sampling.  ``value_and_grad(z)`` gives the potential [C]
    and its gradient [C, D].  Returns (z, u, g, accept_stat [C], depth [C]
    (doublings run), diverged [C]); ``counters`` (a dict), when given,
    gains the replays and host syncs."""
    C = z.shape[0]

    def kinetic(p):
        return 0.5 * torch.sum(inv_mass * p * p, -1)

    def is_turning(p_first, p_last, rho):
        v = inv_mass * rho
        return (torch.sum(v * p_first, -1) <= 0.0) | (torch.sum(v * p_last, -1) <= 0.0)

    def sel(mask, a, b):
        return torch.where(mask[:, None] if a.dim() == 2 else mask, a, b)

    replays = syncs = 0
    h0 = u + kinetic(p0)
    zero = torch.zeros_like(u)
    z_left = z_right = z
    p_left = p_right = p0
    g_left = g_right = g
    z_prop, u_prop, g_prop = z, u, g
    r_sum = p0
    log_sum_w = zero
    done = torch.zeros((C,), dtype=torch.bool, device=z.device)
    diverged = torch.zeros_like(done)
    depth = torch.zeros((C,), dtype=torch.long, device=z.device)
    sum_alpha, n_alpha = zero, zero
    for j in range(max_tree_depth):
        if j > 0:
            syncs += 1
            if not bool((~done).any()):
                break
        active = ~done
        d = directions[j]
        fwd = d > 0
        step = (d * eps)[:, None]
        z_e, p_e, g_e = sel(fwd, z_right, z_left), sel(fwd, p_right, p_left), sel(fwd, g_right, g_left)
        # the subtree of 2^j leaves from the edge state, in direction d
        s_z, s_u, s_g = z_e, zero, g_e
        s_lsw = torch.full_like(u, -math.inf)
        s_rsum = torch.zeros_like(z)
        r_ckpts = [torch.zeros_like(z) for _ in range(max_tree_depth)]
        r_sum_ckpts = [torch.zeros_like(z) for _ in range(max_tree_depth)]
        turning = torch.zeros_like(done)
        diverging = torch.zeros_like(done)
        s_alpha, s_n = zero, zero
        running = active
        for i in range(1 << j):
            if i > 0:
                syncs += 1
                if not bool(running.any()):
                    break
            ph = p_e - 0.5 * step * g_e
            z_n = z_e + step * inv_mass * ph
            u_n, g_n = value_and_grad(z_n)
            replays += 1
            p_n = ph - 0.5 * step * g_n
            h_n = u_n + kinetic(p_n)
            h_n = torch.where(torch.isnan(h_n), torch.full_like(h_n, math.inf), h_n)
            log_w = h0 - h_n
            div = (h_n - h0) > _DELTA_MAX
            alpha = torch.clamp(torch.exp(log_w), max=1.0)
            # progressive multinomial: this leaf replaces the subtree's
            # proposal w.p. w_leaf / w_subtree_so_far
            new_lsw = torch.logaddexp(s_lsw, log_w)
            take = running & (torch.log(leaf_uniform(j, i)) < log_w - new_lsw)
            s_z, s_u, s_g = sel(take, z_n, s_z), sel(take, u_n, s_u), sel(take, g_n, s_g)
            r_sub = s_rsum + p_n
            ckpt = bin(i >> 1).count("1")
            if i % 2 == 0:
                # even leaf: open new balanced spans
                r_ckpts[ckpt] = sel(running, p_n, r_ckpts[ckpt])
                r_sum_ckpts[ckpt] = sel(running, r_sub, r_sum_ckpts[ckpt])
                turn = torch.zeros_like(done)
            else:
                # odd leaf: check every balanced span ending here
                turn = torch.zeros_like(done)
                for k in range(ckpt - _trailing_ones(i) + 1, ckpt + 1):
                    rho = r_sub - r_sum_ckpts[k] + r_ckpts[k]
                    turn = turn | is_turning(r_ckpts[k], p_n, rho)
            z_e, p_e, g_e = sel(running, z_n, z_e), sel(running, p_n, p_e), sel(running, g_n, g_e)
            s_lsw = sel(running, new_lsw, s_lsw)
            s_rsum = sel(running, r_sub, s_rsum)
            turning = sel(running, turn, turning)
            diverging = sel(running, div, diverging)
            s_alpha = s_alpha + torch.where(running, alpha, zero)
            s_n = s_n + running.to(u.dtype)
            running = running & ~turn & ~div
        ok = active & ~turning & ~diverging
        # biased progressive sampling between the tree and the new subtree
        take = ok & (torch.log(tree_uniforms[j]) < s_lsw - log_sum_w)
        z_prop, u_prop, g_prop = sel(take, s_z, z_prop), sel(take, s_u, u_prop), sel(take, s_g, g_prop)
        r_sum = sel(ok, r_sum + s_rsum, r_sum)
        log_sum_w = sel(ok, torch.logaddexp(log_sum_w, s_lsw), log_sum_w)
        upd = ok & fwd
        z_right, p_right, g_right = sel(upd, z_e, z_right), sel(upd, p_e, p_right), sel(upd, g_e, g_right)
        upd = ok & ~fwd
        z_left, p_left, g_left = sel(upd, z_e, z_left), sel(upd, p_e, p_left), sel(upd, g_e, g_left)
        turning_full = is_turning(p_left, p_right, r_sum)
        depth = depth + active.to(depth.dtype)
        diverged = diverged | (active & diverging)
        sum_alpha = sum_alpha + torch.where(active, s_alpha, zero)
        n_alpha = n_alpha + torch.where(active, s_n, zero)
        done = done | (active & (~ok | turning_full))
    if counters is not None:
        counters["replays"] = counters.get("replays", 0) + replays
        counters["host_syncs"] = counters.get("host_syncs", 0) + syncs
    accept_stat = sum_alpha / torch.clamp(n_alpha, min=1.0)
    return z_prop, u_prop, g_prop, accept_stat, depth, diverged


def vectorized_nuts_posterior(model, num_traces, observe=None, map_func=None, file_name=None, num_chains=None,
                              burn_in=None, thinning_steps=None, max_tree_depth=None, target_accept=None,
                              step_size=None, likelihood_importance=1.0, mesh=None, return_chains=False,
                              initial_state=None, args=(), kwargs=None):
    """NUTS posterior: C parallel chains on the batched tier.  Returns an
    Empirical of ``num_traces`` (uniform-weight) samples with acceptance,
    tree-depth, divergence, replay and host-sync metadata (and
    ``final_gradient_state`` for warm resumes), or None if the model does
    not run on the batched tier."""
    max_tree_depth = 10 if max_tree_depth is None else int(max_tree_depth)
    target_accept = 0.8 if target_accept is None else float(target_accept)
    counters = {}

    def transition(fm, obs, z, u, g, eps, inv_mass, generator):
        C, D = z.shape
        like = dict(dtype=z.dtype, device=z.device)
        p0 = torch.randn((C, D), generator=generator, **like) / torch.sqrt(inv_mass)
        directions = torch.where(
            torch.rand((max_tree_depth, C), generator=generator, **like) < 0.5, 1.0, -1.0
        ).to(z.dtype)
        tree_uniforms = torch.rand((max_tree_depth, C), generator=generator, **like)
        before = counters.get("replays", 0)
        z, u, g, accept_stat, depth, diverged = nuts_transition(
            lambda v: fm.value_and_grad(v, obs), z, u, g, eps, inv_mass, p0, directions, tree_uniforms,
            lambda j, i: torch.rand((C,), generator=generator, **like), max_tree_depth, counters,
        )
        counters["transitions"] = counters.get("transitions", 0) + 1
        counters["max_replays"] = max(counters.get("max_replays", 0), counters["replays"] - before)
        return z, u, g, accept_stat, {"depth": depth.to(z.dtype), "divergences": diverged.to(z.dtype)}

    def summarize(sums, post_steps):
        return {
            "mean_tree_depth": float(sums["depth"].mean()) / post_steps,
            "divergences": float(sums["divergences"].sum()),
            "replays_per_transition": counters["replays"] / counters["transitions"],
            "max_replays_per_transition": counters["max_replays"],
            "host_syncs": counters["host_syncs"],
        }

    return _gradient_mcmc_posterior(
        model=model,
        engine_name="NO_U_TURN_SAMPLER",
        engine_label="NUTS",
        transition=transition,
        summarize=summarize,
        target_accept=target_accept,
        metadata_extra={"max_tree_depth": max_tree_depth},
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
    )
