"""Lockstep guided inference for interpreter-tier models (counterpart of
``pyprob_tpu/interpreter_lockstep.py``).

The interpreter tier runs a model one trace at a time, and guided IS
there evaluates the proposal network once a site: one small device step
and one host round trip per site.  Here K worker threads each run
``model.forward()`` under their own interpreter context (``state`` keeps
one per thread).  At every proposal site a worker parks its request; the
last worker to park answers the round inline, for every parked request,
with one batched network step on the card (the workers' LSTM carries are
columns of shared ``[depth, K, H]`` buffers on the card, the per-address
parameters stacked into tables and gathered per row, as the gather loss
does).  A feedforward network has no carry: a round applies each
bucket's heads, gathered per row, to the observe embedding, as the JAX
package's feedforward branch does.  The workers run one at a time,
passing a baton: a worker that parks wakes the next answered one.
Python runs one thread at a time anyway, and every torch call releases
the GIL, so workers running together would hand it over at each of
their host draws; one at a time, a site costs one thread switch.  So no
two workers touch the carry buffers at once, and they need no lock.  The
win is one device step and one host round trip a round instead of one a
site.

A round's device step samples each row's value from its proposal (with a
generator seeded from the round's request seeds, the rows in seed order),
scores it under the proposal (the mixture kernels: kernel 2 for Uniform
heads, kernel 1 for Normal heads) and under the prior, and packs the
values, both log-densities and the heads' outputs into one tensor, copied
to the host once.  A worker's ``state.sample`` takes the precomputed pair
through ``_ProposalShim.pair_of``; a value the round did not draw (a
rejection retry's draw from the prior half of the defensive mixture) is
scored by the row's proposal rebuilt on the host from the head's output.

Every trace has its own CPU generator, seeded per ticket from the global
seed, and each request's seed comes from it, so one seed gives the same
posterior however the threads are scheduled.  Everything else is the
interpreter tier's own ``state.sample``: the statistics match the
sequential loop's.  (The JAX package's module docstring speaks of a
per-(site, prior) proposal cache for feedforward networks; its code
answers their sites in rounds, and so does this port.)  Its concurrent
groups of workers are not ported; nor is its fixed pad of a round's
rows, an XLA compile workaround.
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

from . import state, util
from .nn.gather_loss import GatherRegistry, gathered_mlp, stack_group
from .nn.layers import lstm_step
from .nn.proposals import head_distribution, prior_param_arrays
from .util import InferenceEngine, TraceMode

DEFAULT_WORKERS = 64


class _WorkerNet:
    """The network as one worker sees it, installed as its context's
    ``inference_network``: ``_infer_step`` parks on the coordinator, and
    the recurrent state is the worker's column of the coordinator's carry
    buffers (``_infer_lstm_state`` copies it out and writes it back, so
    ``rejection_sample``'s snapshot and restore work as they are; None for
    a feedforward network)."""

    def __init__(self, coordinator, idx):
        self._coordinator = coordinator
        self._idx = idx
        self._fresh = True  # True at a trace's start: zero recurrent state

    @property
    def _infer_lstm_state(self):
        if self._fresh:
            return None
        return self._coordinator.get_carry(self._idx)

    @_infer_lstm_state.setter
    def _infer_lstm_state(self, v):
        if v is None:
            self._fresh = True
        else:
            self._coordinator.set_carry(self._idx, v)
            self._fresh = False

    def _infer_init(self, observe=None):
        pass  # the coordinator embeds the observation once

    def _infer_begin_trace(self):
        self._fresh = True

    def _infer_step(self, variable, prev_variable=None, proposal_min_train_iterations=None):
        return self._coordinator.infer_step(self._idx, self, variable, prev_variable)


class _Request:
    __slots__ = ("idx", "proxy", "variable", "prev_variable", "seed", "event", "out")

    def __init__(self, idx, proxy, variable, prev_variable, seed):
        self.idx = idx
        self.proxy = proxy
        self.variable = variable
        self.prev_variable = prev_variable
        self.seed = seed
        self.event = threading.Event()
        self.out = None


class _ProposalShim:
    """Stands in for the proposal ``_infer_step`` returns: the round drew
    the value and scored it, so ``sample`` and the scores of that value
    are the precomputed ones.  Any other value is scored by the row's
    proposal, rebuilt on the host from the head's output (row ``row`` of
    the round's host copy, from column 3)."""

    __slots__ = ("_value", "_plp", "_prior_lp", "_host", "_row", "_prior", "_meta", "_dist")

    def __init__(self, value, plp, prior_lp, host, row, prior, meta):
        self._value = value
        self._plp = plp
        self._prior_lp = prior_lp
        self._host = host
        self._row = row
        self._prior = prior  # the site's prior distribution
        self._meta = meta
        self._dist = None

    def sample(self, generator=None):
        return self._value

    def _is_mine(self, value):
        if value is self._value:
            return True
        value = torch.as_tensor(value)
        return value.numel() == self._value.numel() and bool(
            torch.equal(value.reshape(-1).to(self._value.dtype), self._value.reshape(-1))
        )

    def pair_of(self, value):
        """(prior log-density, proposal log-density) of ``value`` when the
        round drew it, else None."""
        if self._is_mine(value):
            return self._prior_lp, self._plp
        return None

    def log_prob(self, value, sum=False):
        if self._is_mine(value):
            return torch.tensor(self._plp)
        if self._dist is None:
            prior = {k: v.reshape(1, -1) for k, v in prior_param_arrays(self._prior).items()}
            out = self._host[self._row : self._row + 1, 3:]
            self._dist = head_distribution(self._meta, out, prior)
        return self._dist.log_prob(torch.as_tensor(value).reshape(1), sum=sum)


class LockstepCoordinator:
    """The barrier and the batched proposal step of one posterior run."""

    def __init__(self, network, observed, num_workers):
        self._net = network
        self._params = params = network._serving_params()
        missing = [name for name in params["observe"] if name not in observed]
        if missing:
            raise RuntimeError(f"Observe embedding names missing from observe dict: {missing}")
        self._device = device = network._device
        obs = {name: util.to_tensor(observed[name], device).reshape(1, -1) for name in params["observe"]}
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._done = 0
        self._total = 0
        self._requests = []  # parked, waiting for the round's answer
        self._resume = []  # answered, waiting for the baton (popped from the end)
        self._error = None
        self._is_lstm = network._network_type == "InferenceNetworkLSTM"
        self._hbuf = self._cbuf = None  # the LSTM's carries, [depth, workers, H]
        with torch.no_grad():
            self._emb = network._embed_observe_pure(params, obs)  # [1, O]
            head_groups, self._head_of = GatherRegistry._grouped(params["proposal"])
            self._heads = {k: stack_group(params["proposal"], a) for k, a in head_groups.items()}
            if self._is_lstm:
                depth, H = network._lstm_depth, network._lstm_dim
                self._hbuf = torch.zeros((depth, num_workers, H), dtype=util.dtype(), device=device)
                self._cbuf = torch.zeros_like(self._hbuf)
                reg = self._registry = GatherRegistry(params)
                self._sembs = {k: stack_group(params["sample_embedding"], a) for k, a in reg.semb_groups.items()}
                self._aemb = torch.stack([params["address_embedding"][a] for a in reg.a_addrs])
                self._demb = torch.stack([params["dist_type_embedding"][n] for n in reg.d_names])
        self._generator = torch.Generator(device=device)
        self.round_rows = []  # rows answered by each round

    def get_carry(self, idx):
        if not self._is_lstm:
            return None
        return self._hbuf[:, idx : idx + 1].clone(), self._cbuf[:, idx : idx + 1].clone()

    def set_carry(self, idx, v):
        if self._is_lstm:
            self._hbuf[:, idx : idx + 1] = v[0]
            self._cbuf[:, idx : idx + 1] = v[1]

    # -- worker side ---------------------------------------------------
    # One worker runs at a time: a worker that parks (or finishes) hands the
    # baton to the next answered one, and the last to park, finding none,
    # answers the round.
    def _wait_turn(self, req):
        req.event.wait()
        if isinstance(req.out, BaseException):
            raise req.out
        return req.out

    def _pass_baton(self):
        """Wake the next answered worker, or answer the round when every
        worker has parked; called under ``_cond`` by a worker leaving the
        baton.  Returns the round to answer, or None."""
        if self._resume:
            self._resume.pop().event.set()
            return None
        if self._requests and self._error is None:
            batch, self._requests = self._requests, []
            return batch
        return None

    def infer_step(self, idx, proxy, variable, prev_variable):
        net, params = self._net, self._params
        # the sequential tier's early outs, so the statistics match it
        addr_key = net._head_key(variable.address)
        if self._is_lstm and prev_variable is not None:
            prev_key = net._head_key(prev_variable.address)
            if prev_key not in params["address_embedding"]:
                warnings.warn(f"Address of previous variable unknown by inference network: {prev_key}")
                return variable.distribution
        if addr_key not in params["address_embedding" if self._is_lstm else "proposal"]:
            if prev_variable is None:
                proxy._infer_lstm_state = None
            warnings.warn(f"Using prior. No proposal for address: {addr_key}")
            return variable.distribution
        seed = int(torch.randint(2**31, (), generator=state._get_rng()))
        req = _Request(idx, proxy, variable, prev_variable, seed)
        with self._cond:
            if self._error is not None:
                raise RuntimeError("lockstep run already failed")
            self._requests.append(req)
            batch = self._pass_baton()
        if batch is not None:
            self._answer_round(batch)
        return self._wait_turn(req)

    def worker_start(self, idx):
        """Wait for this worker's first turn."""
        self._wait_turn(self._starts[idx])

    def worker_done(self, idx):
        with self._cond:
            self._done += 1
            if self._done >= self._total:
                self._cond.notify_all()
            batch = self._pass_baton()
        if batch is not None:
            self._answer_round(batch)

    def worker_failed(self, idx, exc):
        with self._cond:
            if self._error is None:
                self._error = exc
            self._done += 1
            # wake every waiting worker with the failure: each re-raises,
            # lands here, and the pool drains
            unblock = self._requests + self._resume
            self._requests, self._resume = [], []
            if self._done >= self._total:
                self._cond.notify_all()
        err = RuntimeError("lockstep run failed")
        err.__cause__ = exc
        for r in unblock:
            r.out = err
            r.event.set()

    def _answer_round(self, batch):
        """Answer one round on the calling worker's thread, then hand the
        baton to the round's first worker."""
        try:
            self._answer(batch)
        except BaseException as e:
            with self._cond:
                if self._error is None:
                    self._error = e
            for r in batch:
                r.out = e
                r.event.set()
            return
        with self._cond:
            self._resume = batch[::-1]  # popped from the end: the round's order
            self._resume.pop().event.set()

    def run(self, workers):
        self._starts = [_Request(i, None, None, None, None) for i in range(len(workers))]
        with self._cond:
            self._total = len(workers)
            self._resume = self._starts[::-1]
        for w in workers:
            w.start()
        with self._cond:
            self._resume.pop().event.set()
            while self._done < self._total:
                self._cond.wait()
        for w in workers:
            w.join()
        if self._error is not None:
            raise self._error

    # -- the round -----------------------------------------------------
    @torch.no_grad()
    def _answer(self, batch):
        """Bucket the round's requests by structure (head group, previous
        site's sample-embedding group or trace start, prior signature) and
        answer each bucket with one batched step.  A feedforward network's
        buckets have no previous site."""
        net = self._net
        self.round_rows.append(len(batch))
        buckets = {}
        for r in batch:
            dist = r.variable.distribution
            prev = r.prev_variable if self._is_lstm else None
            key = (
                self._head_of[net._head_key(r.variable.address)][0],
                None if prev is None else self._registry.semb_of[net._head_key(prev.address)][0],
                type(dist), tuple(sorted(prior_param_arrays(dist))),
            )
            buckets.setdefault(key, []).append(r)
        for (head_group, prev_group, _, _), items in buckets.items():
            self._answer_bucket(head_group, prev_group, sorted(items, key=lambda r: r.seed))

    def _answer_bucket(self, head_group, prev_group, items):
        net, device = self._net, self._device
        head_key = net._head_key
        B = len(items)
        steady = prev_group is not None
        dist0 = items[0].variable.distribution
        reg = self._registry if self._is_lstm else None
        # one float pack carries every index, the prior's parameters (its
        # leaves) and the previous values: one copy to the card
        rows = []
        for r in items:
            ak = head_key(r.variable.address)
            dist = r.variable.distribution
            row = [self._head_of[ak][1], reg.a_of[ak] if reg else 0, reg.d_of[dist.name] if reg else 0, r.idx]
            if steady:
                prev = r.prev_variable
                pk = head_key(prev.address)
                row += [reg.semb_of[pk][1], reg.a_of[pk], reg.d_of[prev.distribution.name]]
            for leaf in dist._leaves():
                row += leaf.reshape(-1).tolist()
            if steady:
                row += torch.as_tensor(prev.value).reshape(-1).tolist()
            rows.append(row)
        pack = torch.tensor(rows, dtype=util.dtype()).to(device)
        n_idx = 7 if steady else 4
        idx = pack[:, :n_idx].long()
        ofs = n_idx
        leaves = []
        for leaf in dist0._leaves():
            leaves.append(pack[:, ofs : ofs + leaf.numel()].reshape((B,) + tuple(leaf.shape)))
            ofs += leaf.numel()
        prior_dist = type(dist0)._rebuild(leaves)  # the B priors, batched
        heads = self._heads[head_group]
        if self._is_lstm:
            feats = self._lstm_rows(idx, pack[:, ofs:], prev_group)
        else:
            feats = self._emb.expand(B, -1)
        out = gathered_mlp(heads["ff"], idx[:, 0], feats, activation_last=None)
        proposal = head_distribution(heads["meta"], out, prior_param_arrays(prior_dist))
        seeds = [r.seed for r in items]
        self._generator.manual_seed(int(np.random.SeedSequence(seeds).generate_state(1, np.uint64)[0]))
        values = proposal.sample(self._generator)
        plp = proposal.log_prob(values)
        prior_lp = prior_dist.log_prob(values)
        host = torch.cat([values[:, None], plp[:, None], prior_lp[:, None], out], dim=1).cpu()
        scores = host[:, 1:3].tolist()
        for row, (r, value) in enumerate(zip(items, host[:, 0].unbind())):
            dist = r.variable.distribution
            if dist.batch_shape != ():
                value = value.reshape(dist.batch_shape)
            r.out = _ProposalShim(value, scores[row][0], scores[row][1], host, row, dist, heads["meta"])
            r.proxy._fresh = False

    def _lstm_rows(self, idx, prev_values, prev_group):
        """The LSTM step of a bucket's rows: its input from the observe
        embedding and the rows' embeddings, its carry the rows' worker
        columns (zero at a trace start), which it writes back.  Returns the
        features the heads read, [B, H]."""
        net, device = self._net, self._device
        B = idx.shape[0]
        widx = idx[:, 3]
        if prev_group is not None:
            prev_sample_emb = gathered_mlp(self._sembs[prev_group], idx[:, 4], prev_values)
            prev_a, prev_d = self._aemb[idx[:, 5]], self._demb[idx[:, 6]]
            carry = (self._hbuf[:, widx], self._cbuf[:, widx])
        else:
            S = net._sample_embedding_dim
            prev_sample_emb = torch.zeros((B, S), dtype=util.dtype(), device=device)
            prev_a = torch.zeros((B, self._aemb.shape[1]), dtype=util.dtype(), device=device)
            prev_d = torch.zeros((B, self._demb.shape[1]), dtype=util.dtype(), device=device)
            carry = (torch.zeros_like(self._hbuf[:, :B]), torch.zeros_like(self._cbuf[:, :B]))
        x = torch.cat(
            [self._emb.expand(B, -1), prev_sample_emb, prev_d, prev_a, self._demb[idx[:, 2]], self._aemb[idx[:, 1]]],
            dim=1,
        )
        feats, (h, c) = lstm_step(self._params["lstm"], x, carry)
        self._hbuf[:, widx] = h
        self._cbuf[:, widx] = c
        return feats


def lockstep_interpreter_traces(
    model,
    num_traces,
    inference_network,
    observe=None,
    map_func=None,
    file_name=None,
    likelihood_importance=1.0,
    num_workers=None,
    args=(),
    kwargs=None,
):
    """Guided IS over the interpreter tier with ``num_workers`` (default 64)
    lockstep worker threads; returns an Empirical of ``map_func(trace)``
    (the trace by default), traces with a NaN or infinite weight
    discarded.  Its metadata holds the workers, the rounds and the rows of
    each round."""
    from .model import empirical_of, trace_id

    if file_name is not None:
        raise NotImplementedError("file-backed Empirical results come with the storage slice")
    map_func = map_func or trace_id
    kwargs = kwargs or {}
    observe = observe or {}
    if any(v is None for v in observe.values()):
        raise RuntimeError(f"Observe has missing value(s): {observe}")
    observed = {k: util.to_tensor(v, "cpu") for k, v in observe.items()}
    W = max(1, min(int(num_workers or DEFAULT_WORKERS), num_traces))
    coordinator = LockstepCoordinator(inference_network, observed, W)
    # a CPU generator per trace, seeded per ticket from the global seed:
    # which worker runs which ticket does not matter
    master = int(util.get_rng().integers(0, 2**63 - 1))
    seeds = np.random.SeedSequence(master).generate_state(num_traces, np.uint64)
    results = [None] * num_traces
    tickets = iter(range(num_traces))
    ticket_lock = threading.Lock()

    def worker(widx):
        ctx = state._Context()
        ctx.trace_mode = TraceMode.POSTERIOR
        ctx.inference_engine = InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
        ctx.likelihood_importance = likelihood_importance
        ctx.observed_variables = observed
        ctx.root_function_name = model.forward.__code__.co_name
        ctx.inference_network = _WorkerNet(coordinator, widx)
        prev_ctx = state._swap_context(ctx)
        try:
            coordinator.worker_start(widx)
            # autograd is per thread: every worker, and the round each
            # answers, records no graph
            with torch.no_grad():
                while True:
                    with ticket_lock:
                        t = next(tickets, None)
                    if t is None:
                        break
                    ctx.rng = torch.Generator().manual_seed(int(seeds[t]))
                    state._begin_trace()
                    try:
                        result = model.forward(*args, **kwargs)
                    except BaseException:
                        state._abort_trace()
                        raise
                    results[t] = state._end_trace(result)
            coordinator.worker_done(widx)
        except BaseException as e:
            coordinator.worker_failed(widx, e)
        finally:
            state._swap_context(prev_ctx)

    t0 = time.time()
    coordinator.run([threading.Thread(target=worker, args=(i,), daemon=True) for i in range(W)])
    duration = time.time() - t0
    values, log_weights = [], []
    for trace in results:
        log_weight = float(trace.log_importance_weight)
        if np.isfinite(log_weight):
            values.append(map_func(trace))
            log_weights.append(log_weight)
    if len(values) < num_traces:
        warnings.warn(f"Discarded {num_traces - len(values)} traces with nan/inf log_weight.")
    emp = empirical_of(values, log_weights)
    emp.add_metadata(
        lockstep_workers=W, lockstep_rounds=len(coordinator.round_rows),
        lockstep_round_rows=coordinator.round_rows, seconds=duration,
    )
    if util.verbosity() > 1:
        util.log_print(
            f"[lockstep x{W}] {num_traces:,} traces in {duration:.3f}s "
            f"({num_traces / max(duration, 1e-9):,.1f} traces/s), "
            f"ESS {emp.effective_sample_size:,.1f}"
        )
    return emp
