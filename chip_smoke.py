#!/usr/bin/env python3
"""Drive pyprob_tpu_torch's training and guided importance-sampling paths on
one NVIDIA GPU, for GaussianUnknownMean and for its Marsaglia variants (the
rejection_sample one on the batched tier, and bench.py's while-loop one on
the interpreter tier), with the LSTM and the feedforward inference
networks, and saving and loading them; for pyprob's HMM, a Beta-Bernoulli
and a Gamma-Poisson model under inference compilation, and the Branching
models' prior IS; for the Laplace-prior model (the StudentT-mixture head,
batched and in lockstep) and a Beta-NegativeBinomial model under inference
compilation, and Tobit, zero-inflated Poisson and Geometric-latent prior
IS; for MultivariateNormal, Dirichlet and LKJCholesky latents under
inference compilation and the conjugate vector models' prior IS; for GP
regression; and for the Empirical result surface, the built-in
EightSchools, regression, GaussianMixture and LinearGaussianStateSpace
families and IC on the last; and for the rest of learn_inference_network:
LARC, the CNN observe embeddings with MiniCaptcha, training from trace
files with validation and keep_best, and file-backed results; and for
the MCMC engines (LMH and RMH, batched chains and the interpreter chain,
ChainState resumes, rejection blocks, GP and GaussianMixture chains) and
the rest of the Model API (posterior_predictive, condition, ParallelModel);
for SMC on both tiers, with its four resampling schemes, guided by the
trained networks; for the gradient engines (HMC, NUTS, LAPLACE and
map_estimate), their potentials differentiated through the batched replay
with kernels 1, 1b and 4 under the gradient; and for the tempered and
variational engines (parallel tempering, tempered SMC, VI, SVGD), with
GaussianMixture's label-switching posterior on kernels 1, 1b and 3.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name (exits non-zero without a card);
2. build: nvcc builds the hand-written kernels for sm_90a from the sources
   in this checkout;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with its time (CUDA events, device time of back-to-back
   launches), the plain version's time and its bound on this card; the
   mixture backwards also through their autograd Functions (and kernel
   1's against autograd of the plain forward); the truncated mixture's
   inputs hold x outside [low, high], rows where the 1e-12 clip on
   Phi(beta) - Phi(alpha) is active, -inf logits and non-finite cotangents;
   the four mixture kernels also timed at the rows a training step
   launches them at (256 and 512; 256 for the truncated ones), the
   backwards also checked at K = 17 (one row a warp); both forwards also
   held against their plain versions at 256, 512, 1,000 and 2^18 rows and
   at K = 17 and 40, with two +inf logits (+inf), a NaN logit, rows of
   -inf logits and, for the truncated one, x outside [low, high], NaN x
   and the 1e-12 clip; kernel 3 (log_weight_stats) on its special inputs
   (a NaN among finite and among -inf weights, +inf alone and among finite
   ones, every weight -inf) against the reference's values and the plain
   version's, and at N in {1, 3, 4, 5, 4,097, 8,192, 32,768, 10^6 + 3},
   aligned and as a [1:] view (an unaligned head), against float64 and
   the plain version, two calls bit for bit equal; then the launch floor:
   a trivial kernel timed back to back the same way;
4. prior IS: 1,000,000 traces of GaussianUnknownMean against the analytic
   posterior N(7.25, sqrt(1/1.2));
5. guided IS: 1,000,000 traces proposed by an untrained LSTM inference
   network at full width (lstm_dim 512, 10 mixture components, 16-d
   observe embeddings), with the kernels' launch counts on that run;
6. card vs CPU: one guided step at N = 4,096 on both devices;
7. grad card vs CPU: the loss and every parameter gradient of one training
   step (lstm_dim 512, a packed batch of 512) on both devices;
8. train, per arm of bench.py (lstm128/batch256/lr 0.01 and
   lstm512/batch512/lr 0.005, POLY1 to 64,000 traces, EMA 0.9): a cold
   call of 12,800 traces, then 4 timed segments of 12,800, with the
   mixture kernels' launches against the optimizer steps;
9. guided IS trained, per arm: 1,000,000 traces with the trained network
   against the analytic posterior, ESS fraction >= 0.5, printed beside
   the bench's guard;
10. Marsaglia prior IS: 1,000,000 traces of
    GaussianUnknownMeanMarsagliaRejection (rejection_sample on the batched
    tier) against the analytic posterior and log Z, with the retry rounds
    per chunk;
11. Marsaglia grad card vs CPU: one training step (lstm_dim 128, 256
    rows) on both devices, through the truncated mixture's kernels;
12. Marsaglia train: bench.py's Marsaglia arm (lstm128/batch256/lr 0.004,
    32-d observe embeddings, EMA 0.9, 25,600 traces: a cold call of 12,800
    and a timed one of 12,800), the truncated kernels' launches against
    the optimizer steps;
13. Marsaglia guided IS trained: 1,000,000 traces, mean within 0.5 (the
    bench's judgement), ESS fraction >= the bench's guard 0.009 and above
    the prior IS run's, printed beside the JAX package's test floor 0.016;
    its log Z is printed, not checked (first attempts propose from q alone
    and their weights are heavy-tailed: the estimate runs low, PERF.md);
14. Marsaglia defensive IS: the trained network with every attempt drawn
    from the defensive mixture 0.5 q + 0.5 prior (bounded weights), log Z
    within 0.15 of the analytic value: the retry weighting is exact;
15. Marsaglia interpreter prior IS: 100,000 traces of the while-loop
    GaussianUnknownMeanMarsaglia on the interpreter tier (vectorized=False),
    mean and log Z within 0.15 of the analytic values;
16. Marsaglia interpreter train: bench.py's recipe for that model
    (bench.py:146-181: seed 123, 25,600 traces in one call, lstm128/
    batch256/lr 0.004, 32-d observe embeddings, EMA 0.9) on the interpreter
    tier through the gather-table loss: one launch of kernel 2 and one of
    kernel 2b a step, the rows kernel 2 was given (min, median, max), the
    trace types and addresses at the end;
17. Marsaglia lockstep IS: that network, 1,000 warm-up and 12,000 timed
    traces of lockstep IC (vectorized=False), mean and stddev within 0.5,
    the median ESS fraction of three such servings >= the bench's guard
    0.009 (the first serving's and the JAX package's lockstep test floor
    0.004 printed), the rounds and rows a round; then one round
    of up to 64 served sites (trace starts and steady sites of every
    depth, rows out of worker order) against the sequential step row by
    row: log q and log p of the drawn value, the head's proposal at four
    other points and the carry written back within 1e-4 (1 + |ref|), the
    other workers' carries untouched; then 2,000 traces with
    lockstep=False, their ESS fraction printed;
18. GUM lockstep IS: the lstm128 network of phase 8 served by lockstep at
    12,000 traces, held to the GUM limits (kernel 1 at a round's rows), the
    same row-by-row round check, and 2,000 sequential traces whose ESS
    fraction lies within 10 % of lockstep's;
19. ff train: GUM's feedforward network (the default network) with the
    JAX package's recipe (tests/test_inference.py:115-131: 16-d observe
    embeddings, batch 256, lr 0.01, 51,200 traces), one launch each of
    kernels 1 and 1b a step;
20. ff guided IS trained: that network on the batched tier at 1,000,000
    traces, mean and stddev within 0.5, ESS fraction >= 0.15 (the JAX
    test's floor), peak device memory < 10 GiB;
21. ff grad card vs CPU: one feedforward training step's loss and
    gradients on both devices, for a GUM batch of 256 (kernels 1, 1b) and
    for 256 while-loop Marsaglia traces of several trace types drawn on
    the interpreter with prior inflation (kernels 2, 2b, a per-type loss
    each);
22. Marsaglia FF interpreter train and lockstep IS: the while-loop model's
    feedforward network with tests/test_inference.py:191-213's recipe
    (observe embeddings of 128 and depth 6, prior inflation, batch 256,
    lr 0.002, 51,200 traces, seed 123), kernels 2 and 2b a site a trace
    type a step (launches a step and their rows printed); served by
    lockstep as phase 17 serves (mean and stddev within 0.5, the ESS
    fraction printed beside the JAX floor 0.008), one round row by row
    against the sequential step for it (kernel 2) and for phase 19's GUM
    network (kernel 1), 2,000 sequential traces;
23. save and load: phase 19's network and phase 8's lstm128 one saved,
    loaded into a fresh model on the card, everything equal; a 1,000,000
    serving from one seed equal to the bit; a segment of 12,800 continued
    from both within 1e-6 (1 + |p|) (bit equality printed); a file cut
    short raising RuntimeError;
24. interpreter kernel checks: kernels 2 and 2b against their plain
    versions and timed at phase 16's and phase 22's min, median and max
    rows and at 651, kernels 1 and 2 at a lockstep round's 1, 7, 33 and
    64 rows, beside their bounds and the launch floor;
25. linalg kernels: the panel Cholesky's diagonal-tile kernel as the panel
    loop launches it (tiles read in place from [B, N, N] matrices, L
    written into the panel's rows of the full factor, zeros past the
    block) at B = 8,192 tiles of P = 64 (N = 256's first panel), B = 2,048
    (N = 512's), and the ragged last panels P = 8 (N = 200) and P = 2
    (N = 130), and through its contiguous entry at B = 8,192, P = 64;
    the fused MVN quad/log-det
    kernel at (B, N) = (8,192, 256), (2,048, 512), (8,192, 200), (256,
    256) (phase 27's shape) and one unbatched N = 256, each against its
    plain version on GP covariances,
    with matrices that are not positive definite (the fused kernel's: one
    failing at the first column of its second panel) whose NaN must match;
    for kernels 5/6 also the ratio to the plain (library) route, the panel
    width and threads per block in use, and the registers, shared memory
    and spills that ptxas reported;
    then the panel factorization against torch.linalg.cholesky on the
    same [8192, 256, 256] and [2048, 512, 512] batches (a yardstick line);
26. GP IS: prior IS of GaussianProcessRegression(linspace(0, 4, N),
    learn lengthscale, noise 0.2) with y = synthesize(rng=3,
    lengthscale=1.0) at N = 256 x 8,192 and N = 512 x 2,048 traces (the
    sizes of tests/extra/chip_gp.py): posterior mean within 0.25 grid
    stddevs of the grid truth, ESS fraction inside a band around its
    analytic value, N/64 diagonal-tile launches per chunk and no call to
    torch.linalg.cholesky; then N = 256 x 32,768 traces and the chunk size
    it settled on;
27. GP card vs CPU: the GP log-likelihood at 256 log-lengthscales in
    [-2, 2] through the model on the card (panel path, diagonal-tile
    kernel) and through mvn_quad_logdet's kernel (batched, and unbatched
    for three of them), against numpy float64;
28. distributions: each scalar distribution's 1,000,000 draws on the card
    from a seeded generator (one seed, one draw), the heavy-tailed family,
    Geometric, NegativeBinomial, Censored and ZeroInflated among them, none
    ±inf, their mean and variance within 5 standard errors of the
    distribution's own (Cauchy's quartiles and tail share, Censored's tail
    masses), their log_prob against the CPU's within 1e-5 (1 + |cpu|);
    then HMM prior IS: pyprob's HMM (tests/test_inference.py:294-317: 3 states,
    16 Normal observes, 17 categorical sites) at 1,000,000 traces on the
    batched tier, _check_hmm's distances and the ESS fraction printed;
29. HMM train and guided IS trained, for the LSTM (lstm_dim 128) and the
    feedforward network: the JAX tests' recipe (tests/test_inference.py:
    348-395: 51,200 traces, batch 256, lr 0.005, observe embeddings of
    depth 2 and dim 8; categorical heads, one-hot sample embeddings),
    served at 1,000,000 traces and held to _check_hmm's limits (L2 < 3, KL
    < 1 against the posterior table) and an ESS fraction above 0.001;
30. HMM lockstep rounds: one round of HMM sites per network against the
    sequential step, row by row, as phase 17's check;
31. Beta-Bernoulli IC: p ~ Beta(2, 3), 20 Bernoulli observes with 14 ones;
    the default feedforward network trained on 51,200 traces at batch 256
    and lr 0.005 (the Beta head: one launch each of kernels 2 and 2b a step
    at 256 rows), served at 1,000,000 traces: mean and stddev within 0.01
    of Beta(16, 9)'s, ESS fraction above prior IS's;
32. Gamma-Poisson IC: the JAX test's recipe (tests/test_proposals_extended.py:
    111-149: FF, 12,000 traces, batch 512, lr 0.005; the LogNormal-mixture
    head), served at 1,000,000 traces: mean and stddev within 0.35 of
    Gamma(10, 3)'s, ESS fraction above prior IS's and above 0.15;
33. Branching prior IS: BranchingCompiled at 1,000,000 traces on the
    batched tier and Branching at 4,000 on the interpreter tier against
    the enumerated posterior, within 0.15 and 0.3
    (tests/test_models_builtin.py:57-74);
34. Laplace IC: x ~ Laplace(0, 1), obs0 ~ Normal(x, 0.5) = 4, the JAX
    test's recipe (tests/test_proposals_extended.py:191-228: FF, 12,000
    traces, batch 512, lr 0.005, 16-d observe embeddings; the
    StudentT-mixture head), served at 1,000,000 traces: the mean within
    0.3 of the grid truth, ESS fraction above prior IS's;
35. Laplace lockstep: its interpreter-only copy (_never_vectorize) trains
    an LSTM (lstm_dim 128) on interpreter batches with that recipe through
    the gather-table loss, served by lockstep at 12,000 traces: the mean
    within 0.3, one round row by row against the sequential step within
    1e-4 (1 + |ref|), the ESS fraction beside prior IS's;
36. Beta-NegativeBinomial IC: p ~ Beta(2, 2), k0 = 7 and k1 = 9 ~
    NegativeBinomial(5, p) (tests/test_distributions_r3.py:171-180),
    trained as phase 31 (one launch each of kernels 2 and 2b a step at 256
    rows), served at 1,000,000 traces: mean and stddev within 0.01 of
    Beta(12, 18)'s, ESS fraction above prior IS's;
37. Tobit and zero-inflated Poisson prior IS (tests/test_censored_zi.py:
    78-154) at 1,000,000 traces: within 0.03 (mean and stddev) and 0.05
    (mean) of the grid truths;
38. Geometric prior IS: k ~ Geometric(0.4), y ~ Normal(k, 1) = 2 at
    1,000,000 traces batched and 4,000 on the interpreter against the
    posterior enumerated over k = 0..200, within 0.01 and 0.1;
39. event distributions: 1,000,000 draws on the card of Dirichlet(2, 0.5,
    1), Dirichlet at alpha = 1e-4 (no NaN row, rows summing to 1 within
    1e-5), Multinomial(10, (0.2, 0.3, 0.5)), LKJCholesky(3, 1.5) (the
    implied correlations against their marginal, rows of unit norm) and
    LKJCholeskyCPCNormal, none NaN or ±inf, their moments within 5
    standard errors, log_prob against the CPU's within 1e-5 (1 + |cpu|);
40. LKJ CPC density: 1,000,000 LKJCholeskyCPCNormal(0, 0) draws weighted
    by LKJCholesky(3, 1.5), the mean weight within 0.1 of 1;
41. event-shaped IC (tests/test_proposals_extended.py:231-410): a
    MultivariateNormal latent (the mvn head) and a Dirichlet latent (the
    dirichlet head), each with the feedforward network and the LSTM, and
    an LKJCholesky latent (the lkj_cpc_normal head, feedforward), each
    trained with its JAX test's recipe (traces, batch 256, lr 0.003,
    16-d observe embeddings) from the test's seed and the seven after
    it: each of the JAX test's mean and ESS criteria, on the batched tier
    and by lockstep at the test's counts, met by as many seeds as the JAX
    package meets it on eight, less four, and one at least (EVENT_IC,
    EVENT_IC_JAX_MET); the first seed's network also served at 1,000,000
    traces beside prior IS at 1,000,000, its mean held to the truth and
    its ESS fraction printed; the training and serving traces/s, kernel
    3's launches and the peak device memory;
42. Dirichlet-Categorical and conjugate MultivariateNormal prior IS
    (tests/test_distributions_extra.py:115-171) at 1,000,000 traces
    batched and 2,000 on the interpreter, within 0.06 and 0.12;
    then kernels 2 and 2b against their plain versions and timed at every
    row count phases 28-42 launched kernel 2 at;
43. Empirical surface, after the GP phases (the earlier phases' draws stay
    as they were): GUM served at 1,000,000 traces by phase 8's lstm128
    network, its median and 0.5 quantile within 0.02 of 7.25, its 95 % HPD
    interval's ends within 0.03 of 7.25 -+ 1.95996 sqrt(1/1.2), a resample
    of 100,000 by its mean within 5 standard errors; BranchingCompiled's
    1,000,000-trace prior IS by its mode against the enumerated posterior's
    and combine_duplicates keeping the total weight within 1e-9; 10,000 GUM
    traces through map, filter, thin and reobserve at observes (2, 2)
    (scored on the host: no kernel launch), the reobserved mean within 0.1
    of a direct 1,000,000-trace posterior's; the host time of each
    statistic;
44. built-in models' prior IS at 1,000,000 traces with the JAX tests' data
    and limits (tests/test_models_builtin.py:158-345): EightSchools' mu and
    tau means in (3.2, 5.6) and (2.2, 5.2); BayesianLinearRegression within
    0.12 of the conjugate mean; BayesianLogisticRegression's mean and
    stddev within 0.5 grid stddevs; GaussianMixture (K = 2, 40 data, fixed
    and Dirichlet weights) by mu0's stddev within 0.35 of the grid's,
    relative, and its mass below 0 within 0.5 -+ 0.1, its observe on
    kernel 1 once a chunk at the chunk's particles times 40 rows;
    LinearGaussianStateSpace's mean path within max(0.06, 5 sd_t /
    sqrt(ESS)) of the RTS smoother; traces/s, ESS fractions, peak memory;
45. kernel 1 at GaussianMixture's observe shape, 2^18 x 40 rows and K = 2,
    with shared and per-particle logits, against its plain version within
    1e-5 (1 + |ref|), timed beside its bound and the launch floor;
46. LinearGaussianStateSpace IC with the feedforward network (nine Normal
    heads: kernels 1 and 1b in training, kernel 1 at 2^18 rows serving):
    25,600 traces at batch 256, lr 0.005, served at 1,000,000 traces, the
    mean path against the RTS smoother and the ESS fraction against prior
    IS's at 1,000,000, each enforced where the port met it on all eight
    CPU seeds of tests/event_ic_reference.py (LGSS_IC_CPU_MET), printed
    otherwise;
47. LARC card vs CPU: one ADAM_LARC and one SGD_LARC step of a GUM LSTM
    network (lstm128) from the same weights and packed batch of 256 on
    both devices: the LARC-scaled gradients and the parameters after the
    step within 1e-4 + 1e-3 |cpu| per leaf;
48. LARC train: tests/test_train.py:90-107's recipe at lstm128 (ADAM_LARC,
    POLY2 from 0.1 to 0.0025 over 2,048 traces at batch 256), the final
    learning rate within 1e-4 of 0.0025, traces/s;
49. CNN card vs CPU: CNN2D5C at [128, 1, 28, 28] and CNN3D5C at
    [8, 1, 20, 20, 20] -> 32 (a 16^3 input leaves no voxel), forward and
    input and weight gradients within 1e-4 + 1e-3 |cpu|, the CPU run
    pinned to the card's ReLU masks and pool argmaxes (a pre-activation at
    round-off of 0 falls on either side: the flips are counted); two
    backward passes on the card equal to the bit (cuDNN set
    deterministic), and the forward and backward timed;
50. MiniCaptcha IC, the feedforward network and the LSTM (dim 128)
    (tests/test_inference.py:591-655: a CNN2D5C embedding of the glyph,
    8,192 traces at batch 128, lr 0.002): trained from eight seeds, the
    MAP accuracy by post.mode over the six letters at 512 traces above
    0.8 for as many seeds as the JAX package's eight CPU seeds less four
    (CAPTCHA_CPU_MET); the first seed's network served at 10^6 traces a
    letter (every mode correct, traces/s, peak memory < 10 GiB) beside
    prior IS at 10^6 a letter (the [N, 784] observe);
51. save_dataset and offline training: 51,200 GUM training traces in
    files of 12,800 (seconds, bytes) and 2,560 for validation; the
    feedforward recipe and the lstm128 arm's trained from them with the
    validation loss every 12,800 traces, served at 10^6: mean and stddev
    within 0.5, ESS >= 0.15 (FF) and >= 0.5 (LSTM), the online arms'
    printed beside;
52. offline gather train: 12,800 while-loop Marsaglia traces saved from
    the interpreter tier, bench.py's Marsaglia LSTM recipe trained from
    them through the gather-table loss, one launch each of kernels 2 and
    2b a step;
53. keep_best: GUM's feedforward recipe with an EMA, probed every 12,800
    of 51,200 traces and at the end by the guided-IS ESS probe (100,000
    traces) and, offline, by the negative validation loss: the restored
    network equal to the best probe's snapshot to the bit, a 10^6 serving
    from it equal to one from that snapshot loaded into another model;
54. Empirical files: GUM prior IS at 10^6 on the batched tier and the
    lstm128 network by lockstep at 4,000 traces, each in memory and into
    a file from one seed: reopened, the values and log weights equal to
    the bit, mean and ESS equal; the files' concatenation equal to the
    memory results'; the host seconds to write and reopen;
55. mcmc_gum: GUM under LMH and RMH as 1,024 batched chains at 262,144
    transitions and as the interpreter chain at 7,000 steps
    (tests/test_inference.py:135-157), each held to _check_gum (mean and
    stddev within 0.75, KL < 0.25); acceptance and reuse rates, steps/s and
    transitions/s;
56. mcmc_resume: a ChainState saved and loaded equal to the bit, resumed
    (each chain from its own state; tests/test_vectorized.py:165-217's
    limits), resumed under a changed observation (rescored), and the
    interpreter chain resumed from initial_trace=post[-1];
57. mcmc_marsaglia: batched chains over rejection_sample blocks
    (tests/test_rejection.py:70-84, :113-125, the latter against a grid)
    and the while-loop model under RMH on the interpreter
    (tests/test_model.py:137-141);
58. mcmc_gp: GP regression at N = 256 under RMH, 1,024 chains, 262,144
    transitions, the mean within 0.6 grid stddevs; kernel 4 four times a
    step at [1024, 256, 256], timed at that shape beside its bound; the
    step's device-busy and wall time (torch.profiler over 32 resumed
    steps); peak memory with the [16384, 256, 256] warm-start pool;
59. mcmc_gmm: GaussianMixture K = 2 on 40 data under LMH and RMH, 1,024
    chains: the sorted component means within 0.25 of 10^6 prior IS's
    stddev; kernel 1 once a step at 40,960 rows, timed there;
60. posterior_predictive: the predictive of obs0 within 0.2 of 7.25 at
    3,000 draws (tests/test_model.py:179-200) from batched LMH traces and
    from lockstep IC, the latents pinned;
61. conditional: condition / filter with the timeout
    (tests/test_model.py:147-166) and a conditional posterior;
62. parallel: ParallelModel with 4 workers on the card: prior IS into
    chunk files, guided IC by lockstep in each worker (the lstm128
    network; its ESS within 10 % of an in-process lockstep run's), MCMC
    refused; the workers' start-up seconds;
63. smc_gum: GaussianUnknownMean under SEQUENTIAL_MONTE_CARLO at 10^6
    particles in one batch, resample_threshold 1.0, each of the four
    resampling schemes: mean within 0.2 of 7.25, stddev within 0.1, log Z
    within 0.25 of the analytic -8.2395, ESS above 5x prior IS's at 10^6
    (tests/test_smc.py:38-65); kernel 3 once a stage;
64. smc_lgss: LinearGaussianStateSpace(num_steps=8, a=0.9) on
    synthesize(rng=0) at 10^6: the mean path within 0.06 and the variance
    within 0.04 of the RTS smoother, ESS above 5x prior IS's
    (tests/test_models_builtin.py:292-323);
65. smc_hmm: the 3-state, 6-step HMM of tests/test_smc.py:124-167 at
    10^6, its int64 sites replayed, the last state's marginal within 0.03
    of the forward algorithm; smc_marsaglia: the rejection_sample GUM at
    10^6 (a retry loop at stage 1, the block replayed whole at stage 2),
    mean and stddev within 0.2 (tests/test_rejection.py:137-144);
66. smc_guided: SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK at 10^6
    with the lstm128, lstm512 and feedforward GUM networks trained above
    (threshold 1.0: mean 0.2, stddev 0.1, log Z 0.3, ESS > 0.2 N,
    tests/test_smc.py:226-274) and the Marsaglia LSTM network (mean
    within 0.25, tests/test_rejection.py:172-180); kernel 1, or kernel 2,
    on every stage;
67. smc_interpreter: the while-loop GaussianUnknownMeanMarsaglia with
    vectorized=None on the interpreter filter at 2,000 particles,
    systematic and stratified (mean 0.35, stddev 0.25, log Z 0.5,
    tests/test_smc.py:192-203), and a program whose observe count depends
    on a draw, run to the end; each SMC phase prints particles/s, its
    stages, stage ESS and resampled stages, launches by shape, host syncs
    and peak device memory;
68. kernels 1 and 2 against their plain versions and timed at the rows the
    SMC phases launched them at (10^6), beside their bounds;
69. gradient_gum: GaussianUnknownMean under HAMILTONIAN_MONTE_CARLO and
    NO_U_TURN_SAMPLER at 1,024 chains and 102,400 kept draws, held to
    _check_gum; acceptance, step size, transitions/s, potentials (replays
    forward and backward) a transition, NUTS's tree depth and host syncs;
70. gradient_gmm: GaussianMixture K = 2 on 40 data under HMC and NUTS at
    1,024 chains, the sorted means within mcmc_gmm's limit of 10^6 prior
    IS; kernels 1 and 1b at least once a potential at 40,960 rows; the JAX
    test's frozen NUTS chains (1,600 draws, tests/test_models_builtin.py:
    245-290) and HMC with learn_weights at its counts; kernel 1b timed at
    [40,960, 2];
71. hmc_gp: GP regression at N = 256 under HMC with 256 chains, the mean
    within 0.6 grid stddevs; kernel 4 four times a potential (the panel
    Cholesky under autograd, ops.blocked_linalg.PanelCholesky), no library
    Cholesky; kernel 4 timed at B = 256;
72. gradient_card_vs_cpu: the potential and its gradient at fixed z on the
    card (GaussianMixture with learn_weights through kernels 1 and 1b; the
    GP at N = 256 through kernel 4) against the plain versions on the card
    and the GP's against float64 torch.linalg.cholesky (GRADIENT's
    tolerances);
73. nuts_builtin: the JAX tests' HMC/NUTS criteria at their own counts on
    EightSchools (its means against tempered SMC in phase 80), the
    logistic regression, GP at N = 25, the state
    space, an LKJ correlation, Tobit, InverseGamma, Pareto,
    Beta-NegativeBinomial and Gumbel/HalfNormal latents;
74. gradient_resume: final_gradient_state resumed (no warmup, the carried
    step size), under a changed observation, and pickled
    (tests/test_gradient_resume.py);
75. laplace: LAPLACE exact on GUM, map_estimate, the Gamma-Poisson
    posterior by reweighting and its MAP, BayesianLinearRegression
    (tests/test_laplace.py, tests/test_models_builtin.py:178-200), kernel
    3 on each run's weights;
76. pt_bimodal: PARALLEL_TEMPERING at the JAX tests' counts
    (tests/test_pt.py): one ensemble crossing the Bimodal valley, 7 of 8
    ensembles hopping where 8 HMC chains stay stuck, GUM, BoundedBimodal,
    the two enumerated models against 400,000 prior IS, the replica-ladder
    resume (tests/test_gradient_resume.py:122-140), the errors;
77. pt_gmm: GaussianMixture K = 2 on 40 data, 256 ensembles x 8
    temperatures: both sites' unsorted means and stddevs within 0.25 grid
    stddevs of the float64 grid, the share with mu0 < mu1 in (0.3, 0.7);
    kernels 1 and 1b once a potential at 81,920 rows, held against their
    plain versions there; the tempered gradient against the plain kernels;
78. tempered_smc_gum: TEMPERED_SMC at the JAX tests' counts
    (tests/test_tempered_smc.py), then GUM at 10^6 particles with kernel 3's
    launches a stage (28);
79. tempered_smc_gmm: GaussianMixture at 65,536 particles, the whole
    posterior and log Z (within 0.3) against the grid; kernels 1 and 1b at
    2,621,440 rows against their plain versions;
80. tempered_smc_eight_schools: EightSchools at 20,000 particles, the
    reference of phase 73's NUTS means (within 0.6,
    tests/test_models_builtin.py:158-181);
81. vi: VARIATIONAL_INFERENCE at the JAX tests' counts (tests/test_vi.py:
    the three guides), then GUM served at 10^6 reweighted draws, kernel 3
    on their weights within 1e-6 of float64;
82. svgd: STEIN_VARIATIONAL_GRADIENT_DESCENT at the JAX tests' counts
    (tests/test_svgd.py, 512 particles), then GUM and the hierarchy at the
    default cap of 1,024 particles; then the seconds of phases 76-82.

Then the main path's launches by phase (kernel 3's also by N, the
forwards' by rows), kernel 3
timed at every N the path launched it at with the sum over its launches of
time minus bound, the ``{"kernels": [...]}`` line,
the card's ``nvidia-smi`` name and power limit, and last ``{"ok": true,
"device": {...}}``.  Any failed check
raises and the script exits non-zero without that line.
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

OBSERVE = {"obs0": 8.0, "obs1": 9.0}
POSTERIOR_MEAN, POSTERIOR_STDDEV = 7.25, math.sqrt(1.0 / 1.2)
NUM_TRACES = 1_000_000
MIXTURE_ROWS, MIXTURE_COMPONENTS = 1 << 18, 10  # one chunk of the path
STATS_N = 1_000_000
# kernel 3's checked sizes: the one 128-thread block with data in warp 0
# only (1-5) and in several warps (256, 512 and 2,048, the training
# phases' N); 2,054, the last N of that block as a [1:] view and the first
# of the 512-thread grid aligned; grids of one, several and 123 blocks;
# and 2^22 + 3, past the scratch's 264 blocks on an H100, where the
# blocks stride over the tiles
STATS_SIZES = (1, 3, 4, 5, 256, 512, 2048, 2054, 4097, 8192, 32768, STATS_N + 3, 2**22 + 3)
TRAIN_ROWS = 512  # the lstm512 arm's batch, where the backward is checked too

# bench.py's two arms and its training recipe (bench.py:46-48, 64-134)
ARMS = (
    {"lstm_dim": 128, "batch_size": 256, "learning_rate": 0.01, "guard": 0.804},
    {"lstm_dim": 512, "batch_size": 512, "learning_rate": 0.005, "guard": 0.851},
)
TRAIN_TRACES, TRAIN_SEGMENTS, EMA_DECAY = 12_800, 4, 0.9
KERNEL_NAMES = (
    "mixture_normal_log_prob",
    "mixture_normal_log_prob_backward",
    "mixture_truncated_normal_log_prob",
    "mixture_truncated_normal_log_prob_backward",
    "log_weight_stats",
    "chol_inv_tile",
    "mvn_quad_logdet",
    "mvn_quad_logdet_single",
)
TNORM_KERNELS = KERNEL_NAMES[2:4]
FORWARD_KERNELS = (KERNEL_NAMES[0], KERNEL_NAMES[2])

# GP regression: the repository's sizes (tests/extra/chip_gp.py:59-64) and
# the analytic prior-IS ESS fraction E[w]^2 / E[w^2] at y = synthesize(rng=3,
# lengthscale=1.0) (numpy float64 integration over the prior); the band
# holds the 0.05 %-99.95 % quantiles of 2,000 simulated runs of that size
# (0.225-0.251 and 0.120-0.164) with room to spare
GP_RUNS = ((256, 8192), (512, 2048))
GP_ESS = {256: (0.2379, 0.208, 0.268), 512: (0.1420, 0.102, 0.182)}
GP_LARGE = (256, 32768)  # ran out of memory on a 16 GB TPU (chip_gp.py:62)
# f32 log-likelihood of an [N, N] GP covariance (cond up to ~6e3) against
# float64: at most 0.0051 on the CPU over the same 256 lengthscales in
# three float32 routes; ten times that
GP_LOGLIK_ATOL = 0.05

# bench.py's Marsaglia arm (bench.py:159-167, 184) and its ESS guard
# (bench.py:55); 0.016 is the JAX package's IC test floor
# (tests/test_rejection.py:170-172)
MARSAGLIA = {
    "lstm_dim": 128, "batch_size": 256, "learning_rate": 0.004, "observe_dim": 32,
    "train_traces": 25_600, "guard": 0.009, "test_floor": 0.016,
}
# analytic GUM evidence for observes {8, 9}: log N(8; 1, sqrt 7) + log N(9; 6, sqrt(24/7))
LOG_EVIDENCE = -8.2395

# bench.py's while-loop Marsaglia arm (bench.py:146-181): the seed set before
# training (bench.py:155), 1,000 warm-up and 12,000 measured traces on the
# interpreter tier; 0.004 is the JAX package's lockstep test floor
# (tests/test_interpreter_lockstep.py:94).  The sequential loop's ESS
# fraction is held within 10 % of lockstep's, relative, only for GUM (a
# fraction near 0.9 that 2,000 traces estimate to about 1 %); Marsaglia's
# heavy-tailed fractions move several-fold between serving draws of one
# network, so its two are printed, and its guard holds the median of
# "servings" servings.  The rounds are held to the sequential step row by
# row.
INTERPRETER = {
    "seed": 123, "prior_traces": 100_000, "warm_up": 1000, "traces": 12_000,
    "sequential_traces": 2000, "test_floor": 0.004, "relative_band": 0.1, "servings": 3,
}
# a lockstep round against the sequential step, each row's log-densities
# and carry within tol * (1 + |reference|): float32 on the CPU; on the card
# the round's [B]-row GEMMs and kernels 1 and 2 against the one-row step
# and the plain mixture on the host
LOCKSTEP_ROUND_TOL = {"cpu": 1e-5, "cuda": 1e-4}
# the rows a lockstep round gives the forwards (a pool of 64 workers)
ROUND_ROWS = (1, 7, 33, 64)

# the feedforward network: GUM with the JAX package's recipe
# (tests/test_inference.py:115-131: 16-d observe embeddings, batch 256, lr
# 0.01, 51,200 traces, ESS floor 0.15), served batched at 1M traces; and
# the while-loop Marsaglia model with its recipe (tests/test_inference.py:
# 191-213: observe embeddings of 128 and depth 6, prior inflation, batch
# 256, lr 0.002, 51,200 traces; floor 0.008), seed 123 as bench.py's arm,
# served by lockstep as INTERPRETER says
FF_GUM = {"observe_dim": 16, "batch_size": 256, "learning_rate": 0.01, "train_traces": 51_200,
          "ess_floor": 0.15}
FF_MARSAGLIA = {"observe": {"dim": 128, "depth": 6}, "batch_size": 256, "learning_rate": 0.002,
                "train_traces": 51_200, "seed": 123, "test_floor": 0.008}
# save_load: the serving seed and the continued segment's
SAVE_LOAD_SEEDS = (77, 78)

# pyprob's HMM inference-compilation tests (tests/test_inference.py:271-395,
# copied here: this script imports no test module): 3 states, 16 Normal
# observes, 17 categorical sites, IC_TRAIN = 51,200 traces at batch 256, lr
# 0.005, observe embeddings of depth 2 and dim 8, lstm_dim 128 for the
# LSTM; judged by _check_hmm (L2 < 3, KL < 1 against the posterior table)
# and an ESS above 0.001 of the traces
HMM_INIT = [1.0 / 3.0] * 3
HMM_T = [[0.1, 0.5, 0.4], [0.2, 0.2, 0.6], [0.15, 0.15, 0.7]]
HMM_MEANS = [-1.0, 1.0, 0.0]
HMM_OBSERVATION = [0.9, 0.8, 0.7, 0.0, -0.025, -5.0, -2.0, -0.1, 0.0, 0.13, 0.45, 6, 0.2, 0.3, -1, -1]
HMM_POSTERIOR_CORRECT = [
    [0.3775, 0.3092, 0.3133], [0.0416, 0.4045, 0.5539], [0.0541, 0.2552, 0.6907],
    [0.0455, 0.2301, 0.7244], [0.1062, 0.1217, 0.7721], [0.0714, 0.1732, 0.7554],
    [0.9300, 0.0001, 0.0699], [0.4577, 0.0452, 0.4971], [0.0926, 0.2169, 0.6905],
    [0.1014, 0.1359, 0.7626], [0.0985, 0.1575, 0.7440], [0.1781, 0.2198, 0.6022],
    [0.0000, 0.9848, 0.0152], [0.1130, 0.1674, 0.7195], [0.0557, 0.1848, 0.7595],
    [0.2017, 0.0472, 0.7511], [0.2545, 0.0611, 0.6844],
]
HMM = {"train_traces": 51_200, "batch_size": 256, "learning_rate": 0.005, "observe": {"depth": 2, "dim": 8},
       "lstm_dim": 128, "l2": 3.0, "kl": 1.0, "ess_floor": 0.001}
# p ~ Beta(2, 3), 20 Bernoulli observes y0..y19 with 14 ones: the posterior
# is Beta(16, 9); the default feedforward network trained with the learning
# rate of the JAX test recipe nearest it (tests/test_proposals_extended.py:
# 124-131, lr 0.005) on 51,200 traces at batch 256
BETA_BERNOULLI = {"train_traces": 51_200, "batch_size": 256, "learning_rate": 0.005, "observe_dim": 4,
                  "mean": 16.0 / 25.0, "stddev": math.sqrt(16.0 * 9.0 / (25.0**2 * 26.0)), "tol": 0.01}
# the JAX test's recipe (tests/test_proposals_extended.py:111-149): Gamma(2, 1),
# Poisson observes 3 and 5, FF with 16-d observe embeddings, 12,000 traces at
# batch 512, lr 0.005; the posterior Gamma(10, 3)
GAMMA_POISSON = {"train_traces": 12_000, "batch_size": 512, "learning_rate": 0.005, "observe_dim": 16,
                 "observe": {"obs0": 3.0, "obs1": 5.0}, "mean": 10.0 / 3.0, "stddev": math.sqrt(10.0) / 3.0,
                 "tol": 0.35, "ess_floor": 0.15}
# Branching's enumerated posterior at obs 6 (tests/test_models_builtin.py:57-74)
BRANCHING = {"batched_traces": 1_000_000, "interpreter_traces": 4000, "observe": {"obs": 6.0},
             "batched_tol": 0.15, "interpreter_tol": 0.3}

# one parameter set per scalar distribution for its draws on the card (finite
# variance; Pareto's alpha > 4 so the variance's error is finite), as
# tests/test_torch_scalar_distributions.py draws them on the CPU
DISTRIBUTION_DRAWS = {
    "Bernoulli": dict(probs=0.3), "Binomial": dict(total_count=12.0, probs=0.35),
    "Poisson": dict(rate=4.0), "Exponential": dict(rate=1.5), "Gamma": dict(concentration=2.0, rate=1.5),
    "Beta": dict(concentration1=2.0, concentration0=3.0, low=-1.0, high=3.0),
    "VonMises": dict(loc=1.0, concentration=2.0), "LogNormal": dict(loc=0.2, scale=0.5),
    "Weibull": dict(scale=2.0, concentration=1.5), "Chi2": dict(df=3.0), "HalfNormal": dict(scale=2.0),
    "HalfCauchy": dict(scale=2.0), "InverseGamma": dict(concentration=6.0, rate=2.0),
    "Pareto": dict(scale=1.0, alpha=5.0),
    "StudentT": dict(df=9.0, loc=1.0, scale=2.0), "Laplace": dict(loc=1.0, scale=2.0),
    "Cauchy": dict(loc=1.0, scale=2.0), "Logistic": dict(loc=1.0, scale=2.0), "Gumbel": dict(loc=1.0, scale=2.0),
    "Geometric": dict(probs=0.3), "NegativeBinomial": dict(total_count=5.0, probs=0.4),
    "Censored": dict(loc=0.0, scale=1.0, lower=-1.0, upper=1.5), "ZeroInflated": dict(rate=3.0, gate=0.4),
}
DISTRIBUTION_DRAW_COUNT = 1_000_000

# the heavy-tailed slice.  The Laplace-prior model of the JAX test
# (tests/test_proposals_extended.py:191-228: x ~ Laplace(0, 1), obs0 ~
# Normal(x, 0.5) = 4; FF, 16-d observe embeddings, 12,000 traces at batch
# 512, lr 0.005; the mean within 0.3 of the grid truth, the ESS above prior
# IS's), served at 1,000,000 traces; its interpreter-only copy trains an
# LSTM (lstm_dim 128) with the same recipe and is served by lockstep as
# INTERPRETER says
LAPLACE = {"observe": {"obs0": 4.0}, "train_traces": 12_000, "batch_size": 512, "learning_rate": 0.005,
           "observe_dim": 16, "lstm_dim": 128, "tol": 0.3}
# p ~ Beta(2, 2), k0 = 7 and k1 = 9 ~ NegativeBinomial(5, p)
# (tests/test_distributions_r3.py:171-180): the posterior is Beta(12, 18);
# trained as BETA_BERNOULLI (the Beta head: kernels 2 and 2b)
BETA_NB = {"train_traces": 51_200, "batch_size": 256, "learning_rate": 0.005, "observe_dim": 4,
           "observe": {"k0": 7.0, "k1": 9.0}, "mean": 0.4, "stddev": math.sqrt(12.0 * 18.0 / (30.0**2 * 31.0)),
           "tol": 0.01}
# Tobit (tests/test_censored_zi.py:78-113: mu ~ Normal(0, 2), four
# observes of Censored(Normal(mu, 1), upper=1)) and the zero-inflated
# Poisson (:130-154: lam ~ Gamma(2, 1), five observes of
# ZeroInflated(Poisson(lam), 0.3)), prior IS at 1,000,000 traces against
# the grid truth within the JAX tests' limits
TOBIT = {"observe": {"y0": 0.5, "y1": 1.0, "y2": 1.0, "y3": -0.2}, "traces": 1_000_000, "tol": 0.03}
ZIP = {"observe": {f"y{i}": v for i, v in enumerate((0.0, 4.0, 0.0, 3.0, 5.0))}, "gate": 0.3,
       "traces": 1_000_000, "tol": 0.05}
# k ~ Geometric(0.4), y ~ Normal(k, 1) = 2 (tests/test_distributions_new.py:
# 171-193), prior IS on both tiers against the posterior enumerated over
# k = 0..200; the limits are more than 5 standard errors of each run's
# estimate (prior IS's ESS fraction is about 0.6)
GEOMETRIC = {"observe": {"y": 2.0}, "batched_traces": 1_000_000, "interpreter_traces": 4000,
             "batched_tol": 0.01, "interpreter_tol": 0.1}

# the event-shaped slice.  IC on a MultivariateNormal, a Dirichlet and an
# LKJCholesky latent with the JAX tests' recipes
# (tests/test_proposals_extended.py:303-339, 342-361, 388-410: 16-d observe
# embeddings, batch 256, lr 0.003; the LKJ latent with the default
# feedforward network), each of the JAX test's criteria judged at the
# test's counts: served at ``traces`` on the batched tier and at 1,024 by
# lockstep, the reference prior IS at ``base_traces`` (the
# MultivariateNormal ESS floor, the LKJ mean).  The MultivariateNormal
# posterior's mean is 4 / 2.04 per coordinate; the Dirichlet one's
# (2, 2, 3) / 7
EVENT_IC = {
    "mvn": {"observe": {"obs": 4.0}, "seed": 7, "train_traces": 8192, "traces": 4096, "base_traces": 4096,
            "mean": [4.0 / 2.04] * 2, "tol": 0.3, "ess_over_prior": 3.0},
    "dirichlet": {"observe": {"obs": 2}, "seed": 7, "train_traces": 3072, "traces": 1024,
                  "mean": [2 / 7, 2 / 7, 3 / 7], "tol": 0.08, "ess_floor": 0.3},
    "lkj": {"observe": {"y": [2.2, 2.18]}, "seed": 0, "train_traces": 4096, "traces": 1024, "base_traces": 2048,
            "tol": 0.15, "ess_floor": 0.05},
}
EVENT_IC_RECIPE = {"batch_size": 256, "learning_rate": 0.003, "observe_dim": 16, "lockstep_traces": 1024,
                   "lockstep_warm_up": 256, "seeds": 8}
# One trained network is a draw: with these short recipes (12-32 Adam
# steps) the JAX package itself misses some criteria on some seeds.  So
# each recipe is trained from the JAX test's seed and the seven after it,
# and each criterion must be met by at least as many of the eight as the
# JAX package meets it on its eight, less four, and by one at least (a
# recipe that meets a criterion at the JAX package's rate falls further
# short with probability under 3%, 10% for the MultivariateNormal FF
# network's batched ESS, which the JAX package meets on 2 of 8; a ruined
# head meets none).  The JAX package's counts, batched mean and ESS, then
# lockstep's (the JAX tests' ``vectorized=False``), from
# ``python tests/event_ic_reference.py --seeds 8`` on the CPU
EVENT_IC_JAX_MET = {
    "mvn_ic_feedforward": {"batched_mean": 7, "batched_ess": 2, "lockstep_mean": 5, "lockstep_ess": 3},
    "mvn_ic_lstm": {"batched_mean": 8, "batched_ess": 6, "lockstep_mean": 7, "lockstep_ess": 7},
    "dirichlet_ic_feedforward": {"batched_mean": 8, "batched_ess": 8, "lockstep_mean": 8, "lockstep_ess": 8},
    "dirichlet_ic_lstm": {"batched_mean": 8, "batched_ess": 8, "lockstep_mean": 8, "lockstep_ess": 8},
    "lkj_ic_feedforward": {"batched_mean": 8, "batched_ess": 7, "lockstep_mean": 8, "lockstep_ess": 7},
}
# prior IS of the conjugate models of tests/test_distributions_extra.py:
# 115-171 (a flat Dirichlet with three Categorical observes (2, 1, 0):
# Dir(3, 2, 1); N(0, I) with y = (2, 0) ~ N(x, I): N((1, 0), I/2)) at
# 1,000,000 traces batched and the JAX tests' 2,000 on the interpreter
DIRCAT = {"observe": {"o0": 0, "o1": 0, "o2": 1}, "mean": [0.5, 1 / 3, 1 / 6], "tol": 0.06}
MVN_CONJUGATE = {"observe": {"y": [2.0, 0.0]}, "mean": [1.0, 0.0], "variance": [0.5, 0.5], "tol": 0.12}
CONJUGATE_INTERPRETER_TRACES = 2000
EVENT_DRAW_COUNT = 1_000_000

PANEL = 32  # kernels 5/6's panel width (pyprob_tpu_torch/ops/csrc/mvn_quad_logdet.cu)

# the Empirical slice.  GUM's posterior at the bench's observes, served at
# 10^6 traces by the bench's first arm trained above (its ESS fraction near
# 0.9 puts the median's standard error near 0.001: prior IS's, 0.008 of
# 10^6, would put it near 0.013), held to N(7.25, sqrt(1/1.2)): the median
# and the 0.5 quantile within 0.02, the 95 % HPD interval's ends within 0.03
# of 7.25 -+ 1.95996 sd, a resample of 10^5 by its mean within 5 standard
# errors; BranchingCompiled's 10^6-trace prior IS by its mode against the
# enumerated posterior's (r = 5 at 0.338, r = 6 at 0.225) and
# combine_duplicates keeping the total weight (log-sum-exp within 1e-9);
# 10^4 GUM traces through map, filter, thin and reobserve at new observes,
# the reobserved mean within 0.1 of a direct 10^6-trace posterior's there
EMPIRICAL = {"traces": 1_000_000, "resample": 100_000, "median_tol": 0.02, "hpd_mass": 0.95, "hpd_tol": 0.03,
             "z_975": 1.95996, "trace_count": 10_000, "thin": 1000, "reobserve": {"obs0": 2.0, "obs1": 2.0},
             "reobserve_tol": 0.1, "combine_tol": 1e-9, "seed": 16}
# the five built-in families' prior IS at 10^6 traces on the batched tier,
# with the JAX tests' data and limits (tests/test_models_builtin.py:158-345):
# EightSchools' mu and tau means inside (3.2, 5.6) and (2.2, 5.2); the
# linear regression within 0.12 of the conjugate mean; the logistic
# regression's mean and stddev within 0.5 grid stddevs; GaussianMixture's
# mu0 stddev within 0.35 of the grid's, relative, and the label-switching
# share of mass with mu0 < 0 within 0.5 -+ 0.1 (fixed and Dirichlet
# weights); the state-space model's mean path within max(0.06, 5 sd_t /
# sqrt(ESS)) of the RTS smoother at every step
BUILTIN = {"eight_schools_bands": ((3.2, 5.6), (2.2, 5.2)), "linear_tol": 0.12, "logistic_tol": 0.5,
           "mixture_std_tol": 0.35, "mixture_share_tol": 0.1, "state_space_tol": 0.06, "seed": 17,
           "mixture_data": 40}
# GaussianMixture's observe as kernel 1 scores it: a chunk of 2^18 particles
# by 40 data, K = 2
GMM_ROWS, GMM_COMPONENTS = (1 << 18) * BUILTIN["mixture_data"], 2
# IC on LinearGaussianStateSpace (T = 8, a = 0.9, y from synthesize(rng=0))
# with the feedforward network (nine Normal heads: kernels 1 and 1b in
# training, kernel 1 at 2^18 rows serving): 25,600 traces at batch 256, lr
# 0.005, a 16-d embedding an observe; served at 10^6 traces, the mean path
# within max(0.06, 5 sd_t / sqrt(ESS)) of the RTS smoother and the ESS
# fraction above prior IS's at 10^6.  A criterion is enforced only when the
# port met it on all eight CPU seeds of ``python tests/event_ic_reference.py
# --paths lgss_ff --seeds 8`` (seeds met of 8: the JAX package's, the port's);
# any other is printed with its outcome
LGSS_IC = {"num_steps": 8, "a": 0.9, "train_traces": 25_600, "batch_size": 256, "learning_rate": 0.005,
           "observe_dim": 16, "tol": 0.06, "seed": 0}
LGSS_IC_CPU_MET = {"mean_path": (8, 8), "ess_over_prior": (8, 8)}

# the LARC, CNN, MiniCaptcha, storage and offline-training phases (47-55),
# after every earlier one, so the earlier phases keep their draws.
# LARC: tests/test_train.py:90-107's recipe (ADAM_LARC, POLY2 from 0.1 to
# 0.0025 over 2,048 traces, batch 256) at the bench's lstm128 width
LARC_TRAIN = {"train_traces": 2048, "batch_size": 256, "learning_rate": (0.1, 0.0025), "lstm_dim": 128,
              "lr_tol": 1e-4, "seed": 0}
# the CNN embeddings card vs CPU: CNN2D5C at MiniCaptcha's training batch
# and CNN3D5C at the smallest cube the five convolutions and two pools
# leave a voxel of (20^3: a 16^3 input has none)
CNN_CHECK = {"cnn2d5c": ((128, 1, 28, 28), 32), "cnn3d5c": ((8, 1, 20, 20, 20), 32)}
# MiniCaptcha IC (tests/test_inference.py:591-655): a CNN2D5C embedding of
# the glyph, 8,192 traces at batch 128, lr 0.002, LSTM dim 128; MAP
# accuracy by post.mode over the six letters at 512 traces, above 0.8, for
# eight training seeds; the first seed's network also at 10^6
CAPTCHA = {"train_traces": 8192, "batch_size": 128, "learning_rate": 0.002, "dim": 32, "lstm_dim": 128,
           "traces": 512, "accuracy": 0.8, "seeds": 8, "big_traces": 1_000_000}
# seeds of 8 meeting the accuracy criterion on the CPU in ``python
# tests/event_ic_reference.py --paths mini_captcha_ff mini_captcha_lstm
# --seeds 8`` (the JAX package's, the port's): every seed in both
CAPTCHA_CPU_MET = {"mini_captcha_ic_feedforward": (8, 8), "mini_captcha_ic_lstm": (8, 8)}
# offline training: GUM saved in files, the FF recipe (ff_train_kwargs) and
# the lstm128 recipe trained from them, a validation set beside
OFFLINE = {"traces": 51_200, "per_file": 12_800, "valid_traces": 2560, "ff_ess_floor": 0.15,
           "lstm_ess_floor": 0.5, "gather_traces": 12_800}
# keep_best: probes every quarter of the training, the guided-IS ESS probe
# at the library's default count, and the negative validation loss
KEEP_BEST = {"train_traces": 51_200, "every": 12_800, "probe_traces": 100_000, "serve_seed": 79}
# file-backed results
EMPIRICAL_FILE = {"traces": 1_000_000, "lockstep_traces": 4000, "seed": 80}
# the MCMC slice's phases: GUM chains at 1,024 x 256 transitions, the JAX
# tests' 7,000 interpreter steps and their burn-in (tests/test_inference.py:
# 135-157), the GP mean's limit in grid stddevs (the JAX test's for HMC,
# tests/test_models_builtin.py:225-243), GaussianMixture's in IS stddevs,
# posterior_predictive's (tests/test_model.py:179-200), ParallelModel's
MCMC = {"transitions": 262_144, "chains": 1024, "interpreter_steps": 7000,
        "interpreter_burn_in": {"lmh": 1500, "rmh": 1000}, "gp_mean_tol": 0.6, "gmm_tol": 0.25,
        "gmm_is_traces": 1_000_000, "predictive_traces": 3000, "predictive_tol": 0.2,
        "parallel_workers": 4, "parallel_traces": 8000, "parallel_relative_band": 0.1, "seed": 90}
# the online arms' ESS fractions at 10^6 (phases 9 and 20), printed beside
# the offline arms'
ONLINE_ESS = {}
# the SMC slice's phases: 10^6 particles in one batch (2,000 on the
# interpreter), the JAX tests' limits on mean, stddev and log Z
# (tests/test_smc.py:38-51, :226-274, :192-203) and the HMM of
# tests/test_smc.py:124-167
SMC = {"particles": 1_000_000, "interpreter_particles": 2000, "seed": 95,
       "gum_tol": (0.2, 0.1, 0.25), "guided_tol": (0.2, 0.1, 0.3), "interpreter_tol": (0.35, 0.25, 0.5),
       "hmm": {"init": [0.5, 0.3, 0.2], "trans": [[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.2, 0.2, 0.6]],
               "loc": [-1.0, 0.0, 1.5], "scale": 0.6, "ys": [-0.8, -1.2, 0.1, 0.3, 1.4, 1.6]}}

# Published peaks of the H100 SXM at 700 W (NVIDIA's data sheet):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores.
MEMORY_RATE, F32_RATE = 3.35e12, 67e12


T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}  # since the script started
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters=100, warmup=10):
    """Device time of one call: CUDA events around ``iters`` back-to-back
    calls, enqueued behind a sleep kernel so host overhead between
    launches does not reach the device timeline."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms: longer than enqueueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, ops):
    """The least time on this card (ms), and what sets it: the bytes over
    the memory rate or the operations over the float32 rate."""
    by_bytes, by_ops = bytes_moved / MEMORY_RATE, ops / F32_RATE
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def emit_shape(name, fn, plain, bytes_moved, ops, shape, err, iters=3, **extra):
    """A timing line for a shape the kernels line does not carry."""
    ms, plain_ms = time_ms(fn, iters=iters, warmup=1), time_ms(plain, iters=iters, warmup=1)
    bound_ms, bound_by = bound(bytes_moved, ops)
    emit({
        "phase": "kernel_shape", "name": name, "shape": shape, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "ratio_to_plain": ms / plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, **extra,
    })


# each mixture kernel's least traffic (bytes) and rough operation count
# at B rows of K components
def mixture_cost(B, K):
    return 4 * B + 3 * 4 * B * K + 4 * B, 15 * B * K + 3 * B  # ~15 per component (2 transcendental)


def mixture_backward_cost(B, K):
    return 12 * B + 12 * B * K + 4 * B + 12 * B * K, 25 * B * K + 2 * B  # ~25 per component


def tnorm_cost(B, K):
    # x, low, high, 3 [B, K] in; out; ~60 per component (2 erff, 2 logf, 1 expf)
    return (4 + 3 * K) * 4 * B, 60 * B * K + 5 * B


def tnorm_backward_cost(B, K):
    # x, low, high, out, g, 3 [B, K] in; 3 [B, K] + 3 [B] out; ~80 per component
    return (8 + 6 * K) * 4 * B, 80 * B * K + 5 * B


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({
        "phase": "device", "kind": kind, "count": torch.cuda.device_count(),
        "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return kind, smi


def phase_build():
    from pyprob_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.library()
    ptxas = [line.strip() for line in build.build_log.splitlines() if "ptxas" in line]
    for line in ptxas:
        print(line, flush=True)
    emit({
        "phase": "build", "seconds": time.perf_counter() - t0,
        "nvcc_seconds": build.build_seconds, "flags": " ".join(build.NVCC_FLAGS),
        "sources": list(build.SOURCES),
    })


def mixture_inputs(rows, components, device, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(rows, components))
    arrays = (
        rng.normal(7.0, 3.0, rows),
        rng.normal(7.0, 2.0, (rows, components)),
        rng.uniform(0.3, 3.0, (rows, components)),
        raw - np.log(np.exp(raw).sum(1, keepdims=True)),
    )
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def stats_inputs(n, device, seed=1):
    import torch

    rng = np.random.default_rng(seed)
    lw = rng.normal(-20.0, 6.0, n).astype(np.float32)
    lw[rng.random(n) < 0.01] = -np.inf
    return lw, torch.tensor(lw, device=device)


def stats_cost(n):
    # n weights in, 3 floats out; ~6 operations a weight (max, sub, exp, adds)
    return 4 * n + 12, 6 * n


def special_stats_vectors():
    """The special inputs of kernel 3 and the (m, s1, s2) the reference
    (``_log_weight_stats_ref``) gives: every weight -inf gives (-inf, NaN,
    NaN), its exp(-inf - -inf)."""
    nan, inf = math.nan, math.inf
    rng = np.random.default_rng(7)
    among_finite = rng.normal(-20.0, 6.0, 20_000).astype(np.float32)
    among_finite[13_001] = inf
    among_neg_inf = np.full(20_000, -inf, np.float32)
    among_neg_inf[17_777] = nan
    return {
        "zero_nan": (np.array([0.0, nan], np.float32), (nan, nan, nan)),
        "nan": (np.array([nan], np.float32), (nan, nan, nan)),
        "posinf": (np.array([inf], np.float32), (inf, nan, nan)),
        "posinf_among_finite": (among_finite, (inf, nan, nan)),
        "nan_among_neg_inf": (among_neg_inf, (nan, nan, nan)),
        "all_neg_inf": (np.full(4097, -inf, np.float32), (-inf, nan, nan)),
    }


def same_bits_or_nan(got, want):
    return all(a == b or (math.isnan(a) and math.isnan(b)) for a, b in zip(got, want))


def check_stats_values(w_np, w, where):
    """Kernel 3 on the weights ``w`` (``w_np`` on the host): m exact and
    s1, s2 within rtol 1e-5 of float64 and of the plain version (every
    weight -inf: (-inf, NaN, NaN)); on the card, two calls bit for bit equal,
    one launch a call, counted by N.
    Returns the kernel's and the plain version's (m, s1, s2) and the
    larger relative error against float64."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    n = w.shape[0]
    launches, at_n = K.log_weight_stats.launches, K.log_weight_stats.launch_sizes[n]
    out = K.log_weight_stats_packed(w)
    if w.is_cuda:  # the kernel's merge is deterministic; a CPU sum's split may follow the threads
        again = K.log_weight_stats_packed(w)
        check(torch.equal(out, again), f"{where}: two calls differ: {out} vs {again}")
        check(K.log_weight_stats.launches == launches + 2 and K.log_weight_stats.launch_sizes[n] == at_n + 2,
              f"{where}: not one launch a call, counted at N={n}")
    m, s1, s2 = got = tuple(out.tolist())
    pm, ps1, ps2 = plain = tuple(float(v) for v in K.log_weight_stats_plain(w))
    w64 = w_np.astype(np.float64)
    rm = w64.max()
    if rm == -math.inf:  # the reference's exp(-inf - -inf)
        want = (-math.inf, math.nan, math.nan)
        check(same_bits_or_nan(got, want) and same_bits_or_nan(plain, want),
              f"{where}: every weight -inf gave {got}, plain {plain}")
        return got, plain, 0.0
    e = np.exp(w64 - rm)
    rs1, rs2 = e.sum(), (e * e).sum()
    check(m == rm and m == pm, f"{where}: max {m}, float64 {rm}, plain {pm}")
    for value, want, what in ((s1, rs1, "s1"), (s2, rs2, "s2"), (s1, ps1, "s1 plain"), (s2, ps2, "s2 plain")):
        check(abs(value - want) <= 1e-5 * abs(want), f"{where} {what}: {value} vs {want}")
    return got, plain, max(abs(s1 - rs1) / rs1, abs(s2 - rs2) / rs2)


def check_stats(device="cuda", sizes=STATS_SIZES):
    """Kernel 3 by its wrapper: on the special inputs, the values the
    reference gives (NaN for NaN) and the plain version's; at each of
    ``sizes``, aligned and as a [1:] view (the unaligned head),
    ``check_stats_values``.  Returns the largest relative error against
    float64."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    for name, (lw_np, want) in special_stats_vectors().items():
        lw = torch.tensor(lw_np, device=device)
        got = tuple(float(v) for v in K.log_weight_stats(lw))
        plain = tuple(float(v) for v in K.log_weight_stats_plain(lw))
        check(same_bits_or_nan(got, want), f"log_weight_stats {name}: {got}, reference {want}")
        check(same_bits_or_nan(got, plain), f"log_weight_stats {name}: {got}, plain {plain}")
    worst = 0.0
    for n in sizes:
        lw_np, lw = stats_inputs(n + 1, device, seed=n)
        for what, w_np, w in (("aligned", lw_np[:n], lw[:n]), ("[1:]", lw_np[1:], lw[1:])):
            worst = max(worst, check_stats_values(w_np, w, f"log_weight_stats at N={n} ({what})")[2])
    return worst


def phase_stats_shapes(path):
    """Kernel 3 at every N the main path launched it at (the union of
    ``path``'s phases): its values held against the plain version and
    float64 (``check_stats_values``), its time, the plain version's, its
    bound, and Σ launches × (time − bound)."""
    from pyprob_tpu_torch.ops import kernels as K

    launches = {}
    for counts in path.values():
        for n, count in counts["log_weight_stats_by_n"].items():
            launches[n] = launches.get(n, 0) + count
    excess = 0.0
    for n, count in sorted(launches.items()):
        lw_np, lw = stats_inputs(n, "cuda", seed=n)
        *_, rel_err = check_stats_values(lw_np, lw, f"log_weight_stats at the main path's N={n}")
        ms, plain_ms = time_ms(lambda: K.log_weight_stats(lw)), time_ms(lambda: K.log_weight_stats_plain(lw))
        bound_ms, bound_by = bound(*stats_cost(n))
        excess += count * (ms - bound_ms)
        emit({"phase": "kernel_shape", "name": "log_weight_stats", "shape": [n], "launches": count,
              "ms": ms, "plain_ms": plain_ms, "ratio_to_plain": ms / plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "rel_err": rel_err})
    emit({"phase": "log_weight_stats_excess", "launches_by_n": launches,
          "sum_launches_x_ms_minus_bound": excess})


def kernel_functions():
    """Each kernel's wrapper, whose ``launches`` counts its launches: the
    port's one list (``ops.counted_kernels``, which also decides which
    gradient potentials stay out of CUDA graphs), named as KERNEL_NAMES."""
    from pyprob_tpu_torch.ops import counted_kernels

    fns = counted_kernels()
    check(tuple(fns) == KERNEL_NAMES, f"the port's counted kernels {tuple(fns)} are not {KERNEL_NAMES}")
    return fns


def launch_counts():
    """Each kernel's launches, kernel 3's by N (``log_weight_stats_by_n``)
    and the two forwards' by rows (``..._by_rows``)."""
    from pyprob_tpu_torch.ops import kernels as K

    counts = {name: fn.launches for name, fn in kernel_functions().items()}
    counts["log_weight_stats_by_n"] = dict(sorted(K.log_weight_stats.launch_sizes.items()))
    for name in FORWARD_KERNELS:
        counts[name + "_by_rows"] = dict(sorted(getattr(K, name).launch_rows.items()))
    return counts


def reset_launch_counts():
    from pyprob_tpu_torch.ops import kernels as K

    for fn in kernel_functions().values():
        fn.launches = 0
    K.log_weight_stats.launch_sizes.clear()
    for name in FORWARD_KERNELS:
        getattr(K, name).launch_rows.clear()


def check_mixture_backward(rows, device, degenerate=False, components=MIXTURE_COMPONENTS):
    """The mixture backward, by its wrapper and through the autograd
    Function, against the plain closed form and against autograd of the
    plain forward, each gradient within 1e-5 + 1e-4 |ref| and NaN where
    the reference is NaN.  ``degenerate``: a -inf logit in rows 1-3 and
    every logit -inf in row 5.  ``components``: K (17 puts one row on a
    warp).  Returns the inputs, the forward's output, the
    cotangent and the wrapper's max abs error against the plain
    version."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    inputs = mixture_inputs(rows, components, device, seed=rows)
    if degenerate:
        inputs[3][1:4, 0] = -math.inf
        inputs[3][5, :] = -math.inf
    g = torch.tensor(
        np.random.default_rng(rows + 1).normal(size=rows), dtype=torch.float32, device=device
    )
    out = K.mixture_normal_log_prob(*inputs)
    wrapper = K.mixture_normal_log_prob_backward(*inputs, out, g)
    plain = K.mixture_normal_log_prob_backward_plain(*inputs, out, g)
    grads = {}
    for name, fn in (("function", K.mixture_normal_log_prob), ("autograd", K.mixture_normal_log_prob_plain)):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        fn(*leaves).backward(g)
        grads[name] = [t.grad for t in leaves]
    err = 0.0
    for i, what in enumerate(("x", "means", "stddevs", "logits")):
        for ref_name, ref in (("plain", plain[i]), ("autograd", grads["autograd"][i])):
            for mine_name, mine in (("wrapper", wrapper[i]), ("function", grads["function"][i])):
                nan = torch.isnan(ref)
                excess = float(((mine - ref).abs() - (1e-5 + 1e-4 * ref.abs()))[~nan].max())
                check(
                    bool((torch.isnan(mine) == nan).all() and torch.isfinite(mine[~nan]).all())
                    and excess <= 0,
                    f"mixture backward d{what} at B={rows}, K={components}: {mine_name} vs {ref_name} "
                    f"exceeds 1e-5 + 1e-4|ref| by {excess}",
                )
        finite = ~torch.isnan(plain[i])
        err = max(err, float((wrapper[i] - plain[i]).abs()[finite].max()))
    return inputs, out, g, err


def tnorm_inputs(rows, components, device, seed=0):
    """Truncated-mixture inputs on [low, high] = [-1, 1] as the Uniform head
    gives them, with about 1 % of x outside the bounds, 0.5 % of rows whose
    components lie far beyond ``high`` (Phi(beta) - Phi(alpha) = 0: the
    1e-12 clip), 1 % of -inf logits, one row of -inf logits only (from two
    rows on: a single row stays finite), and a cotangent with 0.5 % NaN and
    0.5 % +inf.  Returns the six inputs and g."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.01, 1.01, rows)
    means = rng.normal(0.0, 0.7, (rows, components))
    stddevs = rng.uniform(0.05, 1.5, (rows, components))
    clip = rng.random(rows) < 0.005
    means[clip] = rng.uniform(8.0, 12.0, (clip.sum(), components))
    stddevs[clip] = 0.3
    raw = rng.normal(size=(rows, components))
    logits = raw - np.log(np.exp(raw).sum(1, keepdims=True))
    logits[rng.random((rows, components)) < 0.01] = -np.inf
    if rows >= 2:
        logits[min(5, rows - 1)] = -np.inf
    g = rng.normal(size=rows)
    g[rng.random(rows) < 0.005] = np.nan
    g[rng.random(rows) < 0.005] = np.inf
    arrays = (x, means, stddevs, logits, np.full(rows, -1.0), np.full(rows, 1.0), g)
    return [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]


def check_tnorm(rows, device, seed=0, components=MIXTURE_COMPONENTS):
    """The truncated mixture's forward and backward, by their wrappers and
    through the autograd Function, against the plain versions: forward
    within 1e-5 + 1e-5 |ref| with equal -inf/NaN patterns, each of the six
    gradients within 1e-5 + 1e-4 |ref| and finite, at ``components``
    components a row.  Returns the inputs, the forward's output, g and the
    two max abs errors."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    *inputs, g = tnorm_inputs(rows, components, device, seed)
    out = K.mixture_truncated_normal_log_prob(*inputs)
    ref = K.mixture_truncated_normal_log_prob_plain(*inputs)
    for what in (torch.isnan, torch.isneginf, torch.isposinf):
        check(bool((what(out) == what(ref)).all()), f"truncated mixture at B={rows}: {what.__name__} pattern")
    finite = torch.isfinite(ref)
    check(bool(finite.any() and ((~finite).any() or rows < 2)), f"truncated mixture at B={rows}: no -inf rows")
    excess = float(((out - ref).abs() - (1e-5 + 1e-5 * ref.abs()))[finite].max())
    check(excess <= 0, f"truncated mixture forward at B={rows}: exceeds 1e-5 + 1e-5|ref| by {excess}")
    fwd_err = float((out - ref).abs()[finite].max())
    wrapper = K.mixture_truncated_normal_log_prob_backward(*inputs, out, g)
    plain = K.mixture_truncated_normal_log_prob_backward_plain(*inputs, ref, g)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    K.mixture_truncated_normal_log_prob(*leaves).backward(g)
    bwd_err = 0.0
    for i, what in enumerate(("x", "means", "stddevs", "logits", "low", "high")):
        for name, mine in (("wrapper", wrapper[i]), ("function", leaves[i].grad)):
            excess = float(((mine - plain[i]).abs() - (1e-5 + 1e-4 * plain[i].abs())).max())
            check(
                bool(torch.isfinite(mine).all()) and excess <= 0,
                f"truncated mixture backward d{what} at B={rows}, K={components}: {name} vs plain "
                f"exceeds 1e-5 + 1e-4|ref| by {excess}",
            )
        bwd_err = max(bwd_err, float((wrapper[i] - plain[i]).abs().max()))
    return inputs, out, g, fwd_err, bwd_err


def set_special_rows(inputs):
    """Rows 0-3 and 7 of either forward's inputs (and rows 4-6 of the
    truncated mixture's six): two +inf logits (one at K = 1), a NaN logit,
    every logit -inf, one -inf logit, and a NaN logit among -inf ones
    (NaN), x inside [low, high] in those five rows; x above high, NaN x,
    and every component far beyond high (the 1e-12 clip)."""
    x, means, stddevs, logits = inputs[:4]
    logits[0, :2] = math.inf
    logits[1, -1] = math.nan
    logits[2] = -math.inf
    logits[3, 0] = -math.inf
    logits[7] = -math.inf
    logits[7, -1] = math.nan
    if len(inputs) == 6:
        low, high = inputs[4:]
        x[:4] = (low[:4] + high[:4]) / 2
        x[7] = (low[7] + high[7]) / 2
        x[4] = high[4] + 0.5
        x[5] = math.nan
        means[6], stddevs[6] = high[6] + 40.0, 1.0


def check_forwards(rows, components, device="cuda", seed=0):
    """Both mixture forwards by their wrappers against their plain versions
    at ``rows`` x ``components`` with the special rows: NaN, +inf and -inf
    exactly where the plain version has them (two +inf logits give +inf),
    finite values within 1e-5 (kernel 1) and 1e-5 + 1e-5 |ref| (kernel 2).
    Returns the two max abs errors over the finite values."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    errs = []
    for name, inputs, rtol in (
        ("mixture_normal_log_prob", mixture_inputs(rows, components, device, seed), 0.0),
        ("mixture_truncated_normal_log_prob", tnorm_inputs(rows, components, device, seed)[:6], 1e-5),
    ):
        set_special_rows(inputs)
        out = getattr(K, name)(*inputs)
        ref = getattr(K, name + "_plain")(*inputs)
        where = f"{name} at B={rows}, K={components}"
        for what in (torch.isnan, torch.isposinf, torch.isneginf):
            check(bool((what(out) == what(ref)).all()), f"{where}: {what.__name__} pattern")
        check(float(out[0]) == math.inf, f"{where}: two +inf logits give {float(out[0])}")
        finite = torch.isfinite(ref)
        excess = float(((out - ref).abs() - (1e-5 + rtol * ref.abs()))[finite].max())
        check(excess <= 0, f"{where}: exceeds 1e-5 + {rtol}|ref| by {excess}")
        errs.append(float((out - ref).abs()[finite].max()))
    return errs


def phase_kernels():
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    rows = []

    B, Kc = MIXTURE_ROWS, MIXTURE_COMPONENTS
    # both forwards with the special rows: the training rows, a ragged
    # block, a serving chunk; K = 17 (one row a warp) and 40 (two
    # components on some lanes)
    checked = [(n, Kc) for n in (256, 512, 1000, B)] + [(1000, 17), (256, 40)]
    emit({"phase": "forward_checks", "max_abs_err": {
        f"{n}x{k}": check_forwards(n, k, seed=n + k) for n, k in checked}})
    inputs = mixture_inputs(B, Kc, "cuda")
    out = K.mixture_normal_log_prob(*inputs)
    ref = K.mixture_normal_log_prob_plain(*inputs)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), "mixture kernel: non-finite output")
    check(err <= 1e-5, f"mixture kernel vs plain: max abs err {err} > 1e-5")
    bound_ms, bound_by = bound(*mixture_cost(B, Kc))
    rows.append({
        "name": "mixture_normal_log_prob", "route": "cuda",
        "source": "pyprob_tpu_torch/ops/csrc/mixture_normal.cu",
        "replaces": "pyprob_tpu/ops/kernels.py:72",
        "max_abs_err": err, "tolerance": "atol 1e-5 vs plain",
        "ms": time_ms(lambda: K.mixture_normal_log_prob(*inputs)),
        "plain_ms": time_ms(lambda: K.mixture_normal_log_prob_plain(*inputs)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": [B, Kc],
    })

    check_mixture_backward(1000, "cuda", degenerate=True)  # ragged last block
    # K = 17: one row a warp, 15 of its lanes idle
    check_mixture_backward(256, "cuda", degenerate=True, components=17)
    # the rows a training step launches both directions at (the IC loss
    # scores the head once per sub-batch: at most the arm's batch)
    for n in sorted({arm["batch_size"] for arm in ARMS}):
        small, small_out, small_g, small_err = check_mixture_backward(n, "cuda")
        emit_shape(
            "mixture_normal_log_prob", lambda: K.mixture_normal_log_prob(*small),
            lambda: K.mixture_normal_log_prob_plain(*small), *mixture_cost(n, Kc), [n, Kc],
            float((small_out - K.mixture_normal_log_prob_plain(*small)).abs().max()), iters=100,
        )
        emit_shape(
            "mixture_normal_log_prob_backward",
            lambda: K.mixture_normal_log_prob_backward(*small, small_out, small_g),
            lambda: K.mixture_normal_log_prob_backward_plain(*small, small_out, small_g),
            *mixture_backward_cost(n, Kc), [n, Kc], small_err, iters=100,
        )
    inputs, out, g, err = check_mixture_backward(B, "cuda")
    bound_ms, bound_by = bound(*mixture_backward_cost(B, Kc))
    rows.append({
        "name": "mixture_normal_log_prob_backward", "route": "cuda",
        "source": "pyprob_tpu_torch/ops/csrc/mixture_normal_backward.cu",
        "replaces": "pyprob_tpu/ops/kernels.py:255",
        "max_abs_err": err,
        "tolerance": "1e-5 + 1e-4 |ref| per gradient vs plain and vs autograd of the plain forward",
        "ms": time_ms(lambda: K.mixture_normal_log_prob_backward(*inputs, out, g)),
        "plain_ms": time_ms(lambda: K.mixture_normal_log_prob_backward_plain(*inputs, out, g)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": [B, Kc],
    })

    check_tnorm(1000, "cuda", seed=1)  # ragged last block
    check_tnorm(256, "cuda", seed=3, components=17)  # one row a warp
    check_tnorm(512, "cuda", seed=4)
    # the Marsaglia training step's rows
    n = MARSAGLIA["batch_size"]
    small, small_out, small_g, small_fwd, small_bwd = check_tnorm(n, "cuda", seed=2)
    emit_shape(
        "mixture_truncated_normal_log_prob", lambda: K.mixture_truncated_normal_log_prob(*small),
        lambda: K.mixture_truncated_normal_log_prob_plain(*small), *tnorm_cost(n, Kc), [n, Kc],
        small_fwd, iters=100,
    )
    emit_shape(
        "mixture_truncated_normal_log_prob_backward",
        lambda: K.mixture_truncated_normal_log_prob_backward(*small, small_out, small_g),
        lambda: K.mixture_truncated_normal_log_prob_backward_plain(*small, small_out, small_g),
        *tnorm_backward_cost(n, Kc), [n, Kc], small_bwd, iters=100,
    )
    inputs, out, g, fwd_err, bwd_err = check_tnorm(B, "cuda")
    bound_ms, bound_by = bound(*tnorm_cost(B, Kc))
    rows.append({
        "name": "mixture_truncated_normal_log_prob", "route": "cuda",
        "source": "pyprob_tpu_torch/ops/csrc/mixture_truncated_normal.cu",
        "replaces": "pyprob_tpu/ops/kernels.py:183",
        "max_abs_err": fwd_err, "tolerance": "1e-5 + 1e-5 |ref| vs plain, equal -inf/NaN",
        "ms": time_ms(lambda: K.mixture_truncated_normal_log_prob(*inputs)),
        "plain_ms": time_ms(lambda: K.mixture_truncated_normal_log_prob_plain(*inputs)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": [B, Kc],
    })
    bound_ms, bound_by = bound(*tnorm_backward_cost(B, Kc))
    rows.append({
        "name": "mixture_truncated_normal_log_prob_backward", "route": "cuda",
        "source": "pyprob_tpu_torch/ops/csrc/mixture_truncated_normal_backward.cu",
        "replaces": "pyprob_tpu/ops/kernels.py:275",
        "max_abs_err": bwd_err,
        "tolerance": "1e-5 + 1e-4 |ref| per gradient vs plain, wrapper and autograd Function",
        "ms": time_ms(lambda: K.mixture_truncated_normal_log_prob_backward(*inputs, out, g)),
        "plain_ms": time_ms(
            lambda: K.mixture_truncated_normal_log_prob_backward_plain(*inputs, out, g)
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": [B, Kc],
    })

    sweep_err = check_stats("cuda")
    lw_np, lw = stats_inputs(STATS_N, "cuda")
    (m, s1, s2), (pm, ps1, ps2), rel_err = check_stats_values(lw_np, lw, f"log_weight_stats at N={STATS_N}")
    bound_ms, bound_by = bound(*stats_cost(STATS_N))
    rows.append({
        "name": "log_weight_stats", "route": "cuda",
        "source": "pyprob_tpu_torch/ops/csrc/log_weight_stats.cu",
        "replaces": "pyprob_tpu/ops/kernels.py:309",
        "max_abs_err": max(abs(m - pm), abs(s1 - ps1), abs(s2 - ps2)),
        "max_rel_err_vs_float64": rel_err, "max_rel_err_vs_float64_all_sizes": max(rel_err, sweep_err),
        "tolerance": "m exact, s1 and s2 rtol 1e-5 vs float64 and plain; special values as plain",
        "ms": time_ms(lambda: K.log_weight_stats(lw)),
        "plain_ms": time_ms(lambda: K.log_weight_stats_plain(lw)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": [STATS_N],
    })
    counts = launch_counts()
    for row in rows:
        emit({
            "phase": "kernel", **row, "bound_us": row["bound_ms"] * 1e3,
            "launches_in_phase": counts[row["name"]],
        })
    return rows


def phase_launch_floor():
    """The least device time of one launch at these rows: a trivial kernel
    (a spin of no cycles, an add to one element) timed back to back by the
    same ``time_ms`` as the kernels."""
    import torch

    one = torch.zeros(1, device="cuda")
    sleep_ms = time_ms(lambda: torch.cuda._sleep(0))
    add_ms = time_ms(lambda: one.add_(1.0))
    emit({"phase": "launch_floor", "ms": min(sleep_ms, add_ms), "sleep0_ms": sleep_ms,
          "add_one_element_ms": add_ms})
    return min(sleep_ms, add_ms)


def hmm_l2_kl(posterior_mean):
    """_check_hmm's two distances of a [17, 3] posterior mean from the
    table (tests/test_inference.py:319-336)."""
    correct = np.asarray(HMM_POSTERIOR_CORRECT)
    l2 = float(np.sum(np.sqrt(np.sum((posterior_mean - correct) ** 2, axis=1))))
    kl = 0.0
    for p, q in zip(posterior_mean, correct):
        p, q = np.clip(p, 1e-6, None), np.clip(q, 1e-6, None)
        p, q = p / p.sum(), q / q.sum()
        kl += float(np.sum(p * np.log(p / q)))
    return l2, kl


def check_posterior(post, label):
    mean, std = float(post.mean), float(post.stddev)
    check(abs(mean - POSTERIOR_MEAN) <= 0.5, f"{label}: mean {mean}")
    check(abs(std - POSTERIOR_STDDEV) <= 0.5, f"{label}: stddev {std}")
    return mean, std


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_prior_is(device, num_traces):
    from pyprob_tpu_torch.models import GaussianUnknownMean
    from pyprob_tpu_torch.ops import kernels as K

    model = GaussianUnknownMean()
    model.posterior_results(num_traces, observe=OBSERVE, vectorized=True)  # warm-up
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    post = model.posterior_results(num_traces, observe=OBSERVE, vectorized=True)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = K.log_weight_stats.launches
    mean, std = check_posterior(post, "prior IS")
    if device == "cuda":
        check(launches >= 1, "prior IS did not launch log_weight_stats")
    emit({
        "phase": "prior_is", "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "ess": post.effective_sample_size,
        "ess_fraction": post.effective_sample_size / num_traces,
        "log_weight_stats_launches": launches,
    })


def guided_model(lstm_dim, marsaglia=False):
    """GaussianUnknownMean (or, with ``marsaglia``, its Marsaglia variant
    with the bench arm's 32-d observe embeddings) with a freshly built LSTM
    inference network: layers grown from prior traces of the port's batched
    prior, weights from the port's generator (no training)."""
    from pyprob_tpu_torch.models import GaussianUnknownMean, GaussianUnknownMeanMarsagliaRejection
    from pyprob_tpu_torch.nn import InferenceNetworkLSTM

    model = GaussianUnknownMeanMarsagliaRejection() if marsaglia else GaussianUnknownMean()
    dim = MARSAGLIA["observe_dim"] if marsaglia else 16
    net = InferenceNetworkLSTM(
        model=model,
        observe_embeddings={"obs0": {"dim": dim}, "obs1": {"dim": dim}},
        lstm_dim=lstm_dim,
        proposal_mixture_components=10,
    )
    net._pre_generate_layers(model.prior(num_traces=8))
    model._inference_network = net
    return model


def phase_guided_is(device, num_traces, lstm_dim):
    import torch
    import pyprob_tpu_torch as pp

    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    model = guided_model(lstm_dim)
    run = lambda: model.posterior_results(  # noqa: E731
        num_traces, observe=OBSERVE, vectorized=True, inference_engine=engine
    )
    run()  # warm-up
    reset_launch_counts()
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    post = run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    mean, std = check_posterior(post, "guided IS")
    ess = post.effective_sample_size
    ess64 = pp.util.effective_sample_size(post.log_weights)
    check(abs(ess - ess64) <= 1e-4 * ess64, f"guided IS: kernel ESS {ess} vs float64 {ess64}")
    if device == "cuda":
        check(ess >= 1000, f"guided IS: ESS {ess} < 1000")
        for name in ("mixture_normal_log_prob", "log_weight_stats"):
            check(launches[name] >= 1, f"guided IS did not launch {name}")
    emit({
        "phase": "guided_is", "traces": num_traces, "lstm_dim": lstm_dim,
        "mixture_components": 10, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "ess": ess, "ess_float64": ess64, "ess_fraction": ess / num_traces,
        "peak_memory_gib": peak_gib, "launches": launches,
    })
    return model, launches


def forced_step_log_q(model, mus, device):
    """log q of one guided step at forced values ``mus`` on ``device``."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch import vectorized

    pp.set_device(device)
    net = model._inference_network.to(device)
    step = net.make_vectorized_proposal_step(OBSERVE)
    captured = {}
    forced = torch.tensor(mus, device=device)

    def forced_step(site, distribution, generator, observed, **kwargs):
        value, log_q = step(site, distribution, generator, observed, forced_value=forced)
        captured["log_q"] = log_q
        return value, log_q

    forced_step.reset = step.reset
    vectorized.run_traced(
        model, len(mus), OBSERVE, pp.TraceMode.POSTERIOR,
        pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        proposal_step=forced_step,
    )
    return captured["log_q"].cpu().numpy()


def phase_card_vs_cpu(model, n, devices=("cuda", "cpu")):
    import pyprob_tpu_torch as pp

    mus = np.random.default_rng(2).normal(7.0, 3.0, n).astype(np.float32)
    a, b = (forced_step_log_q(model, mus, d) for d in devices)
    pp.set_device(devices[0])
    model._inference_network.to(devices[0])
    err = float(np.abs(a - b).max())
    check(np.isfinite(a).all() and err <= 1e-4, f"card vs CPU log q: max abs err {err}")
    emit({"phase": "card_vs_cpu", "n": n, "max_abs_err": err, "tolerance": "atol 1e-4"})


def grads_on_devices(net, batch, devices, kernels, label):
    """One training step's loss/B and every parameter gradient of ``net``
    on each of ``devices`` from the same parameters and ``batch`` (a
    materialized batch, or a PackedBatch moved to each device); on the
    card, each of ``kernels`` launched.  Held within 1e-4 + 1e-3 |cpu|.
    Returns the losses, the leaves and the largest error."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.nn import PackedBatch
    from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves

    for p in tensor_leaves(net._params):
        p.requires_grad_(True)
    results = []
    for device in devices:
        pp.set_device(device)
        net.to(device)
        on = batch
        if isinstance(batch, PackedBatch):
            packed = map_tensors(batch.packed, lambda t: t.to(device))
            on = PackedBatch(packed, batch.size, batch.addrs, batch.dist_names)
        reset_launch_counts()
        loss = float(net._loss_and_grad(on))
        launches = launch_counts()
        results.append((loss, [p.grad.cpu().numpy() for p in tensor_leaves(net._params)]))
        if device == "cuda":
            for name in kernels:
                check(launches[name] >= 1, f"{label} on the card did not launch {name}")
    pp.set_device(devices[0])
    net.to(devices[0])
    (loss_a, grads_a), (loss_b, grads_b) = results
    check(all(np.isfinite(g).all() for g in grads_a + grads_b), f"{label}: non-finite gradient")
    err, worst = 0.0, 0.0
    for a, b in zip(grads_a, grads_b):
        err = max(err, float(np.abs(a - b).max()))
        worst = max(worst, float((np.abs(a - b) - (1e-4 + 1e-3 * np.abs(b))).max()))
    check(np.isfinite(loss_a) and abs(loss_a - loss_b) <= 1e-4 + 1e-3 * abs(loss_b),
          f"{label}: loss {loss_a} vs {loss_b}")
    check(worst <= 0, f"{label}: a gradient exceeds 1e-4 + 1e-3|cpu| by {worst}")
    return [loss_a, loss_b], len(grads_a), err


def phase_grad_card_vs_cpu(lstm_dim, rows, devices=("cuda", "cpu"), marsaglia=False):
    """The loss and every parameter gradient of one training step, from the
    same weights and the same packed batch, on the card and on the CPU
    (GaussianUnknownMean through kernel 1, or with ``marsaglia`` its
    Marsaglia variant through the truncated mixture's kernels)."""
    from pyprob_tpu_torch import vectorized

    model = guided_model(lstm_dim, marsaglia)
    net = model._inference_network
    kernels = TNORM_KERNELS if marsaglia else KERNEL_NAMES[:2]
    outputs, sites = vectorized.run_training_batch(model, rows)
    batch = net._packed_batch_from_outputs(outputs, sites, rows)
    phase = "marsaglia_grad_card_vs_cpu" if marsaglia else "grad_card_vs_cpu"
    loss, leaves, err = grads_on_devices(net, batch, devices, kernels, phase)
    emit({
        "phase": phase, "lstm_dim": lstm_dim, "rows": rows,
        "loss": loss, "leaves": leaves, "max_abs_err": err,
        "tolerance": "atol 1e-4 + rtol 1e-3 per gradient",
    })


def train_kwargs(arm, segments):
    import pyprob_tpu_torch as pp

    return dict(
        observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
        inference_network=pp.InferenceNetwork.LSTM,
        batch_size=arm["batch_size"],
        learning_rate_init=arm["learning_rate"],
        lstm_dim=arm["lstm_dim"],
        proposal_mixture_components=MIXTURE_COMPONENTS,
        learning_rate_scheduler_type=pp.LearningRateScheduler.POLY1,
        num_traces_end=TRAIN_TRACES * (1 + segments),
        ema_decay=EMA_DECAY,
    )


def phase_train(device, arm, train_traces=TRAIN_TRACES, segments=TRAIN_SEGMENTS):
    """bench.py's training recipe for one arm: a cold call, then timed
    segments continuing the same network and schedule."""
    from pyprob_tpu_torch.models import GaussianUnknownMean

    model = GaussianUnknownMean()
    kw = train_kwargs(arm, segments)
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    model.learn_inference_network(num_traces=train_traces, **kw)
    sync(device)
    cold = time.perf_counter() - t0
    seg_tps = []
    for _ in range(segments):
        t0 = time.perf_counter()
        model.learn_inference_network(num_traces=train_traces, **kw)
        sync(device)
        seg_tps.append(train_traces / (time.perf_counter() - t0))
    launches = launch_counts()
    net = model._inference_network
    steps = net._total_train_iterations
    loss = net._history_train_loss[-1]
    check(math.isfinite(loss), f"train lstm{arm['lstm_dim']}: final loss {loss}")
    if device == "cuda":
        for name in ("mixture_normal_log_prob", "mixture_normal_log_prob_backward"):
            check(launches[name] >= steps,
                  f"train lstm{arm['lstm_dim']}: {name} launched {launches[name]} < {steps} steps")
    emit({
        "phase": "train", "lstm_dim": arm["lstm_dim"], "batch_size": arm["batch_size"],
        "learning_rate": arm["learning_rate"], "traces": net._total_train_traces,
        "optimizer_steps": steps, "cold_seconds": cold,
        "traces_per_s": max(seg_tps), "traces_per_s_band": [min(seg_tps), max(seg_tps)],
        "segments_traces_per_s": seg_tps, "final_loss": loss, "launches": launches,
    })
    return model, launches


def serve_batched(device, model, num_traces, label, observe=OBSERVE, kernels=("mixture_normal_log_prob",),
                  guided=True):
    """Batched IS of ``model`` (guided by its network, or with ``guided``
    False from the prior): a warm-up run, then a timed one with its
    launches and peak device memory (< 10 GiB) counted; on the card each
    of ``kernels`` and kernel 3 must have launched."""
    import torch
    import pyprob_tpu_torch as pp

    engine = (pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK if guided
              else pp.InferenceEngine.IMPORTANCE_SAMPLING)
    run = lambda: model.posterior_results(  # noqa: E731
        num_traces, observe=observe, vectorized=True, inference_engine=engine
    )
    run()  # warm-up
    reset_launch_counts()
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    post = run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak_gib = None
    if device == "cuda":
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(peak_gib < 10.0, f"{label}: peak memory {peak_gib} GiB")
        for name in tuple(kernels) + ("log_weight_stats",):
            check(launches[name] >= 1, f"{label} did not launch {name}")
    return post, seconds, launches, peak_gib


def phase_guided_is_trained(device, model, arm, num_traces):
    """Guided IS with the trained network, judged as bench.py judges it."""
    from pyprob_tpu_torch.nn.layers import tensor_leaves

    label = f"guided IS trained lstm{arm['lstm_dim']}"
    # a recorded autograd graph over the 2^18-row chunks would hold several
    # GiB more than the untrained run's 7.23 GiB: serve_batched's 10 GiB
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, label)
    mean, std = check_posterior(post, label)
    ess_fraction = post.effective_sample_size / num_traces
    check(ess_fraction >= 0.5, f"{label}: ESS fraction {ess_fraction}")
    if arm["lstm_dim"] == LARC_TRAIN["lstm_dim"]:
        ONLINE_ESS["lstm"] = ess_fraction
    served = tensor_leaves(model._inference_network._serving_params())
    check(not any(t.requires_grad for t in served), "serving parameters require grad")
    emit({
        "phase": "guided_is_trained", "lstm_dim": arm["lstm_dim"], "traces": num_traces,
        "seconds": seconds, "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "ess_fraction": ess_fraction, "bench_guard": arm["guard"],
        "bench_guard_met": ess_fraction >= arm["guard"], "peak_memory_gib": peak_gib,
        "launches": launches,
    })
    return launches


def log_evidence(post, num_traces):
    """log of the mean importance weight over all ``num_traces`` traces (the
    discarded -inf ones count as 0), in float64 on the host."""
    lw = np.asarray(post.log_weights, np.float64)
    m = lw.max()
    return float(m + math.log(np.exp(lw - m).sum() / num_traces))


def rejection_rounds(post):
    return [r for meta in post.metadata for r in meta.get("rejection_rounds", [])]


def phase_marsaglia_prior_is(device, num_traces):
    """IS from the prior of the Marsaglia model: the rejection block as a
    masked retry loop over each 2^18-particle chunk."""
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsagliaRejection

    model = GaussianUnknownMeanMarsagliaRejection()
    run = lambda: model.posterior_results(num_traces, observe=OBSERVE, vectorized=True)  # noqa: E731
    run()  # warm-up
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    post = run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    mean, std = float(post.mean), float(post.stddev)
    log_z = log_evidence(post, num_traces)
    rounds = rejection_rounds(post)
    check(abs(mean - POSTERIOR_MEAN) <= 0.15, f"Marsaglia prior IS: mean {mean}")
    check(abs(std - POSTERIOR_STDDEV) <= 0.15, f"Marsaglia prior IS: stddev {std}")
    check(abs(log_z - LOG_EVIDENCE) <= 0.15, f"Marsaglia prior IS: log Z {log_z}")
    check(len(rounds) == math.ceil(num_traces / (1 << 18)), f"Marsaglia prior IS: rounds {rounds}")
    if device == "cuda":
        check(launches["log_weight_stats"] >= 1, "Marsaglia prior IS did not launch log_weight_stats")
    ess_fraction = post.effective_sample_size / num_traces
    emit({
        "phase": "marsaglia_prior_is", "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "log_z": log_z, "log_z_analytic": LOG_EVIDENCE, "ess_fraction": ess_fraction,
        "rejection_rounds_per_chunk": rounds, "launches": launches,
    })
    return ess_fraction, launches


def marsaglia_train_kwargs():
    import pyprob_tpu_torch as pp

    dim = MARSAGLIA["observe_dim"]
    return dict(
        observe_embeddings={"obs0": {"dim": dim}, "obs1": {"dim": dim}},
        inference_network=pp.InferenceNetwork.LSTM,
        batch_size=MARSAGLIA["batch_size"],
        learning_rate_init=MARSAGLIA["learning_rate"],
        lstm_dim=MARSAGLIA["lstm_dim"],
        proposal_mixture_components=MIXTURE_COMPONENTS,
        ema_decay=EMA_DECAY,
    )


def phase_marsaglia_train(device, train_traces=MARSAGLIA["train_traces"]):
    """bench.py's Marsaglia training recipe (constant learning rate): a cold
    call for the first half of the traces, a timed call for the second."""
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsagliaRejection

    model = GaussianUnknownMeanMarsagliaRejection()
    kw = marsaglia_train_kwargs()
    half = train_traces // 2
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    model.learn_inference_network(num_traces=half, **kw)
    sync(device)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.learn_inference_network(num_traces=train_traces - half, **kw)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    net = model._inference_network
    steps = net._total_train_iterations
    loss = net._history_train_loss[-1]
    check(math.isfinite(loss), f"Marsaglia train: final loss {loss}")
    kinds = {m["kind"] for m in net._head_meta.values()}
    check(kinds == {"uniform_truncated_normal_mixture"}, f"Marsaglia train: heads {kinds}")
    if device == "cuda":
        for name in TNORM_KERNELS:
            # one launch per Uniform site per step: two sites
            check(launches[name] >= 2 * steps,
                  f"Marsaglia train: {name} launched {launches[name]} < 2 x {steps} steps")
    emit({
        "phase": "marsaglia_train", "lstm_dim": MARSAGLIA["lstm_dim"],
        "batch_size": MARSAGLIA["batch_size"], "learning_rate": MARSAGLIA["learning_rate"],
        "traces": net._total_train_traces, "optimizer_steps": steps, "cold_seconds": cold,
        "traces_per_s": (train_traces - half) / seconds, "final_loss": loss,
        "launches": launches,
    })
    return model, launches


def phase_marsaglia_guided_is_trained(device, model, num_traces, prior_fraction):
    """Guided IS with the trained Marsaglia network through the user's entry
    point, judged as bench.py judges the Marsaglia arm: mean within 0.5 and
    ESS fraction >= 0.009, and above the prior IS run's.  The ESS fraction
    of this recipe depends on the seed (first attempts propose from q
    alone, and their weights p/q are heavy-tailed: PERF.md), and so does
    log Z, which is printed beside the analytic value, not checked."""
    import torch
    import pyprob_tpu_torch as pp

    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    run = lambda: model.posterior_results(  # noqa: E731
        num_traces, observe=OBSERVE, vectorized=True, inference_engine=engine
    )
    run()  # warm-up
    reset_launch_counts()
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    post = run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    mean, std = float(post.mean), float(post.stddev)
    ess_fraction = post.effective_sample_size / num_traces
    check(abs(mean - POSTERIOR_MEAN) <= 0.5, f"Marsaglia guided IS trained: mean {mean}")
    check(ess_fraction >= MARSAGLIA["guard"],
          f"Marsaglia guided IS trained: ESS fraction {ess_fraction} < the bench's guard")
    check(ess_fraction > prior_fraction,
          f"Marsaglia guided IS trained: ESS fraction {ess_fraction} <= prior IS's {prior_fraction}")
    peak_gib = None
    if device == "cuda":
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(peak_gib < 10.0, f"Marsaglia guided IS trained: peak memory {peak_gib} GiB")
        for name in ("mixture_truncated_normal_log_prob", "log_weight_stats"):
            check(launches[name] >= 1, f"Marsaglia guided IS trained did not launch {name}")
    emit({
        "phase": "marsaglia_guided_is_trained", "lstm_dim": MARSAGLIA["lstm_dim"],
        "traces": num_traces, "seconds": seconds, "traces_per_s": num_traces / seconds,
        "mean": mean, "stddev": std, "ess_fraction": ess_fraction,
        "bench_guard": MARSAGLIA["guard"], "jax_test_floor": MARSAGLIA["test_floor"],
        "jax_test_floor_met": ess_fraction >= MARSAGLIA["test_floor"],
        "prior_is_ess_fraction": prior_fraction,
        "log_z": log_evidence(post, num_traces), "log_z_analytic": LOG_EVIDENCE,
        "rejection_rounds_per_chunk": rejection_rounds(post), "peak_memory_gib": peak_gib,
        "launches": launches,
    })
    return launches


def phase_marsaglia_defensive_is(device, model, num_traces):
    """The trained network's proposal step with every attempt, the first
    included, drawn from the defensive mixture 0.5 q + 0.5 prior: each
    attempt's weight factor is at most 2 per site, so log Z converges, and
    within 0.15 of the analytic value it shows the retry weighting (every
    executed attempt's log p - log q, the state restored per retry) exact
    on this device."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch import vectorized

    step = model._inference_network.make_vectorized_proposal_step(OBSERVE)

    def defensive_step(site, distribution, generator, observed, defensive=None):
        return step(site, distribution, generator, observed, defensive=0.5)

    for attr in ("reset", "get_state", "set_state", "select_state", "supports_defensive"):
        setattr(defensive_step, attr, getattr(step, attr))
    t0 = time.perf_counter()
    post = vectorized.vectorized_traces(
        model, num_traces, pp.TraceMode.POSTERIOR,
        inference_engine=pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        observe=OBSERVE, proposal_step=defensive_step, map_func=pp.model.trace_result,
    )
    sync(device)
    seconds = time.perf_counter() - t0
    mean, std = float(post.mean), float(post.stddev)
    log_z = log_evidence(post, num_traces)
    check(abs(mean - POSTERIOR_MEAN) <= 0.15, f"Marsaglia defensive IS: mean {mean}")
    check(abs(std - POSTERIOR_STDDEV) <= 0.15, f"Marsaglia defensive IS: stddev {std}")
    check(abs(log_z - LOG_EVIDENCE) <= 0.15, f"Marsaglia defensive IS: log Z {log_z}")
    emit({
        "phase": "marsaglia_defensive_is", "traces": num_traces, "seconds": seconds,
        "mean": mean, "stddev": std, "ess_fraction": post.effective_sample_size / num_traces,
        "log_z": log_z, "log_z_analytic": LOG_EVIDENCE,
        "rejection_rounds_per_chunk": rejection_rounds(post),
    })


def phase_marsaglia_interpreter_prior_is(device, num_traces=INTERPRETER["prior_traces"]):
    """IS from the prior of the while-loop Marsaglia model on the interpreter
    tier (one trace at a time on the host, ``vectorized=False``): log Z
    within 0.15 of the analytic value shows its weights exact."""
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia

    model = GaussianUnknownMeanMarsaglia()
    t0 = time.perf_counter()
    post = model.posterior_results(num_traces, observe=OBSERVE, vectorized=False)
    seconds = time.perf_counter() - t0
    mean, std = float(post.mean), float(post.stddev)
    log_z = log_evidence(post, num_traces)
    check(abs(mean - POSTERIOR_MEAN) <= 0.15, f"Marsaglia interpreter prior IS: mean {mean}")
    check(abs(log_z - LOG_EVIDENCE) <= 0.15, f"Marsaglia interpreter prior IS: log Z {log_z}")
    emit({
        "phase": "marsaglia_interpreter_prior_is", "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std, "log_z": log_z,
        "log_z_analytic": LOG_EVIDENCE, "ess_fraction": post.effective_sample_size / num_traces,
    })


def rows_summary(by_rows):
    """min, median and max of the rows of the launches counted in ``by_rows``."""
    rows = sorted(r for r, n in by_rows.items() for _ in range(n))
    return {"launches": len(rows), "min": rows[0], "median": rows[len(rows) // 2], "max": rows[-1]}


def phase_marsaglia_interpreter_train(device):
    """bench.py's Marsaglia recipe on the while-loop model, as the bench runs
    it: seed 123, one call of 25,600 traces (lstm128, batch 256, lr 0.004,
    32-d observe embeddings, EMA 0.9).  The model runs on the interpreter
    tier, so every batch is materialized and polymorphed, and the
    gather-table loss scores every active (step, trace) cell of a batch
    with one launch of kernel 2 and its gradient with one of kernel 2b."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia

    pp.seed(INTERPRETER["seed"])
    model = GaussianUnknownMeanMarsaglia()
    kw = marsaglia_train_kwargs()
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    model.learn_inference_network(num_traces=MARSAGLIA["train_traces"], **kw)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    net = model._inference_network
    steps = net._total_train_iterations
    loss = net._history_train_loss[-1]
    check(math.isfinite(loss), f"Marsaglia interpreter train: final loss {loss}")
    check(net._gather_used, "Marsaglia interpreter train: the gather-table loss was not used")
    addresses = len(net._params["proposal"])
    attempts = max(int(a.rpartition("__")[2]) for a in net._params["proposal"])
    rows = rows_summary(launches["mixture_truncated_normal_log_prob_by_rows"]) if device == "cuda" else None
    if device == "cuda":
        for name in TNORM_KERNELS:
            check(launches[name] == steps,
                  f"Marsaglia interpreter train: {name} launched {launches[name]} times in {steps} steps")
    emit({
        "phase": "marsaglia_interpreter_train", "lstm_dim": MARSAGLIA["lstm_dim"],
        "batch_size": MARSAGLIA["batch_size"], "learning_rate": MARSAGLIA["learning_rate"],
        "seed": INTERPRETER["seed"], "traces": net._total_train_traces, "optimizer_steps": steps,
        "seconds": seconds, "traces_per_s": net._total_train_traces / seconds, "final_loss": loss,
        "addresses": addresses, "trace_types": attempts, "kernel2_rows": rows,
        "launches": launches,
    })
    return model, launches, rows


def phase_interpreter_ic(device, model, label, warm_up, num_traces, lockstep=None, observe=OBSERVE):
    """IC on the interpreter tier (``vectorized=False``) through the user's
    entry point: a warm-up run, then a timed one with the launches counted;
    lockstep by default.  Returns the posterior, seconds, launches, peak
    device memory (GiB) and the lockstep rounds."""
    import torch
    import pyprob_tpu_torch as pp

    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    kw = {} if lockstep is None else {"lockstep": lockstep}
    if warm_up:
        model.posterior_results(warm_up, observe=observe, vectorized=False, inference_engine=engine, **kw)
    reset_launch_counts()
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    post = model.posterior_results(
        num_traces, observe=observe, vectorized=False, inference_engine=engine, **kw
    )
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    if peak_gib is not None:
        check(peak_gib < 10.0, f"{label}: peak memory {peak_gib} GiB")
    meta = post.metadata[0]
    rounds = None
    if "lockstep_round_rows" in meta:
        rr = meta["lockstep_round_rows"]
        rounds = {"workers": meta["lockstep_workers"], "rounds": len(rr),
                  "rows_per_round_mean": sum(rr) / len(rr), "rows_per_round_max": max(rr)}
    return post, seconds, launches, peak_gib, rounds


def round_traces(traces, workers=64):
    """Traces whose controlled sites fill at most ``workers`` rows of one
    lockstep round: first one trace of each length met, longest first, so
    the round holds trace starts and steady sites of every depth, then
    more in order."""
    by_length = {}
    for t in traces:
        by_length.setdefault(t.length_controlled, t)
    chosen, rows = [], 0
    for t in sorted(by_length.values(), key=lambda t: -t.length_controlled) + list(traces):
        if t not in chosen and rows + t.length_controlled <= workers:
            chosen.append(t)
            rows += t.length_controlled
    return chosen


def lockstep_round_vs_sequential(net, observe, traces, workers=64, seed=0):
    """One lockstep round against the port's sequential ``_infer_step``,
    row by row.  Every controlled site of ``traces`` (interpreter traces of
    the network's model, at most ``workers`` sites in all) becomes one
    parked request of a single round, on a worker column drawn at random,
    the rows parked in a random order.  For an LSTM network every column
    of the carry buffers holds a random LSTM state first: a steady site's
    is its carried state, a trace start's is junk the round must ignore (a
    feedforward network has no carry, and its carry errors are 0).  The round answers them
    all; then for each row the sequential step, given the same carried
    state and previous variable, is the reference.  Returns the max abs
    error of the proposal's log-density at the drawn value (``log_q``) and
    at four draws from the reference proposal (``head``: the head's
    output), of the prior's at the drawn value (``log_p``), of the carry
    written back (``carry``), each beside the largest |reference|
    (``*_ref``), and of the columns the round must not touch
    (``untouched``); ``buckets`` lists each bucket's (trace start?, worker
    columns); ``rows`` each request's (variable, previous variable, carried
    state or None)."""
    import numpy as np
    import torch
    from pyprob_tpu_torch import interpreter_lockstep as L

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    sites = [(v, t.variables_controlled[k - 1] if k else None)
             for t in traces for k, v in enumerate(t.variables_controlled)]
    check(0 < len(sites) <= workers, f"lockstep round check: {len(sites)} sites for {workers} workers")
    observed = {k: torch.as_tensor(v) for k, v in observe.items()}
    coord = L.LockstepCoordinator(net, observed, workers)
    has_carry = coord._hbuf is not None
    if has_carry:
        for buf in (coord._hbuf, coord._cbuf):
            buf.copy_(torch.randn(buf.shape, generator=gen, dtype=buf.dtype).mul_(0.5))
        h0, c0 = coord._hbuf.clone(), coord._cbuf.clone()
    cols = [int(c) for c in rng.permutation(workers)[: len(sites)]]
    seeds = [int(s) for s in rng.choice(2**31, size=len(sites), replace=False)]
    batch = [L._Request(col, L._WorkerNet(coord, col), v, prev, s)
             for (v, prev), col, s in zip(sites, cols, seeds)]
    batch = [batch[i] for i in rng.permutation(len(batch))]
    buckets = []
    answer_bucket = coord._answer_bucket

    def recorded(head_group, prev_group, items):
        buckets.append((prev_group is None, [r.idx for r in items]))
        return answer_bucket(head_group, prev_group, items)

    coord._answer_bucket = recorded
    coord._answer(batch)
    errs = dict.fromkeys(("log_q", "log_q_ref", "head", "head_ref", "log_p", "log_p_ref",
                          "carry", "carry_ref"), 0.0)

    def note(key, got, ref):
        got, ref = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(ref, dtype=torch.float64)
        errs[key] = max(errs[key], float((got - ref).abs().max()))
        errs[key + "_ref"] = max(errs[key + "_ref"], float(ref.abs().max()))

    rows = []
    net._infer_init(observed)
    with torch.no_grad():
        for r in batch:
            shim, col = r.out, r.idx
            check(isinstance(shim, L._ProposalShim) and not r.proxy._fresh,
                  f"lockstep round check: worker {col} was not answered")
            carried = None
            if has_carry and r.prev_variable is not None:
                carried = (h0[:, col : col + 1].clone(), c0[:, col : col + 1].clone())
            rows.append((r.variable, r.prev_variable, carried))
            net._infer_lstm_state = carried
            ref = net._infer_step(r.variable, prev_variable=r.prev_variable)
            check(ref is not r.variable.distribution, "lockstep round check: the network has no proposal for a site")
            value = shim.sample()
            log_p, log_q = shim.pair_of(value)
            one = value.reshape((1,) + tuple(r.variable.distribution.event_shape))  # a batch of one
            note("log_q", log_q, float(ref.log_prob(one, sum=True)))
            note("log_p", log_p, float(r.variable.distribution.log_prob(value, sum=True)))
            for _ in range(4):
                probe = ref.sample(gen)
                note("head", shim.log_prob(probe, sum=True), ref.log_prob(probe, sum=True))
            if has_carry:
                h, c = coord.get_carry(col)
                note("carry", torch.stack([h, c]).cpu(), torch.stack(list(net._infer_lstm_state)).cpu())
    rest = sorted(set(range(workers)) - set(cols))
    errs["untouched"] = float(max(
        (coord._hbuf[:, rest] - h0[:, rest]).abs().max(), (coord._cbuf[:, rest] - c0[:, rest]).abs().max()
    )) if rest and has_carry else 0.0
    errs["buckets"] = buckets
    errs["rows"] = rows
    return errs


def check_lockstep_round(label, model, tol, observe=OBSERVE):
    """``lockstep_round_vs_sequential`` on traces of ``model`` that its
    network served by lockstep (256 traces, vectorized=False), each error
    held to ``tol`` (1 + the largest |reference|) and the other columns
    untouched; returns the printable errors."""
    import pyprob_tpu_torch as pp

    traces = model.posterior(
        256, observe=observe, vectorized=False,
        inference_engine=pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
    ).get_values()
    errs = lockstep_round_vs_sequential(model._inference_network, observe, round_traces(traces))
    for key in ("log_q", "head", "log_p", "carry"):
        check(errs[key] <= tol * (1 + errs[key + "_ref"]),
              f"{label}: lockstep round vs sequential step, {key} off by {errs[key]}")
    check(errs["untouched"] == 0.0, f"{label}: the lockstep round wrote columns it did not answer")
    return {"rows": len(errs["rows"]), "buckets": [[start, len(c)] for start, c in errs["buckets"]],
            "tolerance": tol, **{k: errs[k] for k in ("log_q", "head", "log_p", "carry")}}


def phase_marsaglia_lockstep_is(device, model):
    """bench.py's Marsaglia serving run: 1,000 warm-up and 12,000 timed
    traces of lockstep IC on the interpreter tier, judged as
    bench.py:228-236 judges the arm (mean within 0.5; the ESS fraction
    against the guard 0.009), with the stddev within 0.5 as every IS phase.
    One serving's ESS fraction moves several-fold between draws of the same
    network, so the guard holds the median of INTERPRETER["servings"]
    servings, each served as the first (1,000 warm-up, 12,000 traces), the
    first being the timed one.  Then one round of served sites against the
    sequential step, row by row (``check_lockstep_round``), and 2,000
    traces from the same network with the sequential loop
    (lockstep=False), its ESS fraction printed."""
    import numpy as np

    post, seconds, launches, peak_gib, rounds = phase_interpreter_ic(
        device, model, "Marsaglia lockstep IS", INTERPRETER["warm_up"], INTERPRETER["traces"]
    )
    n = INTERPRETER["traces"]
    mean, std = check_posterior(post, "Marsaglia lockstep IS")
    ess_fraction = post.effective_sample_size / n
    fractions = [ess_fraction]
    for _ in range(INTERPRETER["servings"] - 1):
        more, _, _, _, _ = phase_interpreter_ic(
            device, model, "Marsaglia lockstep IS", INTERPRETER["warm_up"], n
        )
        fractions.append(more.effective_sample_size / n)
    ess_median = float(np.median(fractions))
    check(ess_median >= MARSAGLIA["guard"],
          f"Marsaglia lockstep IS: median ESS fraction {ess_median} of {fractions} < the bench's guard")
    if device == "cuda":
        check(launches["mixture_truncated_normal_log_prob"] >= 1,
              "Marsaglia lockstep IS did not launch mixture_truncated_normal_log_prob")
    round_check = check_lockstep_round("Marsaglia lockstep IS", model, LOCKSTEP_ROUND_TOL[device])
    seq, seq_seconds, _, _, _ = phase_interpreter_ic(
        device, model, "Marsaglia sequential IS", 0, INTERPRETER["sequential_traces"], lockstep=False
    )
    emit({
        "phase": "marsaglia_lockstep_is", "traces": n, "seconds": seconds,
        "traces_per_s": n / seconds, "mean": mean, "stddev": std, "ess_fraction": ess_fraction,
        "ess_fraction_servings": fractions, "ess_fraction_median": ess_median,
        "bench_guard": MARSAGLIA["guard"], "jax_test_floor": INTERPRETER["test_floor"],
        "jax_test_floor_met": ess_fraction >= INTERPRETER["test_floor"],
        "log_z": log_evidence(post, n), "log_z_analytic": LOG_EVIDENCE, **(rounds or {}),
        "peak_memory_gib": peak_gib, "round_vs_sequential": round_check,
        "sequential": {"traces": INTERPRETER["sequential_traces"], "seconds": seq_seconds,
                       "traces_per_s": INTERPRETER["sequential_traces"] / seq_seconds,
                       "mean": float(seq.mean),
                       "ess_fraction": seq.effective_sample_size / INTERPRETER["sequential_traces"]},
        "launches": launches,
    })
    return launches


def phase_gum_lockstep_is(device, model):
    """The lstm128 GUM network the train phase trained, served on the
    interpreter tier with lockstep at 12,000 traces: the path of kernel 1
    at the rows of a round; held to the GUM limits (mean and stddev within
    0.5, ESS fraction >= 0.5), one round of 64 served traces against the
    sequential step row by row, and 2,000 traces with the sequential loop,
    whose ESS fraction must lie within INTERPRETER["relative_band"] of the
    lockstep run's, relative to it."""
    n = INTERPRETER["traces"]
    post, seconds, launches, peak_gib, rounds = phase_interpreter_ic(
        device, model, "GUM lockstep IS", INTERPRETER["warm_up"], n
    )
    mean, std = check_posterior(post, "GUM lockstep IS")
    ess_fraction = post.effective_sample_size / n
    check(ess_fraction >= 0.5, f"GUM lockstep IS: ESS fraction {ess_fraction}")
    if device == "cuda":
        check(launches["mixture_normal_log_prob"] >= 1, "GUM lockstep IS did not launch mixture_normal_log_prob")
    round_check = check_lockstep_round("GUM lockstep IS", model, LOCKSTEP_ROUND_TOL[device])
    m = INTERPRETER["sequential_traces"]
    seq, seq_seconds, _, _, _ = phase_interpreter_ic(device, model, "GUM sequential IS", 0, m, lockstep=False)
    seq_fraction = seq.effective_sample_size / m
    check(abs(seq_fraction / ess_fraction - 1) <= INTERPRETER["relative_band"],
          f"GUM IS: sequential ESS fraction {seq_fraction} vs lockstep {ess_fraction}")
    emit({
        "phase": "gum_lockstep_is", "lstm_dim": 128, "traces": n, "seconds": seconds,
        "traces_per_s": n / seconds, "mean": mean, "stddev": std, "ess_fraction": ess_fraction,
        **(rounds or {}), "peak_memory_gib": peak_gib, "round_vs_sequential": round_check,
        "sequential": {"traces": m, "seconds": seq_seconds, "traces_per_s": m / seq_seconds,
                       "mean": float(seq.mean), "ess_fraction": seq_fraction},
        "launches": launches,
    })
    return launches


def ff_train_kwargs():
    import pyprob_tpu_torch as pp

    dim = FF_GUM["observe_dim"]
    return dict(
        observe_embeddings={"obs0": {"dim": dim}, "obs1": {"dim": dim}},
        inference_network=pp.InferenceNetwork.FEEDFORWARD,
        batch_size=FF_GUM["batch_size"],
        learning_rate_init=FF_GUM["learning_rate"],
        proposal_mixture_components=MIXTURE_COMPONENTS,
    )


def phase_ff_train(device, train_traces=FF_GUM["train_traces"]):
    """GUM's feedforward network trained with the JAX package's recipe in
    one call: one launch of kernel 1 and one of kernel 1b a step, at the
    batch's rows."""
    from pyprob_tpu_torch.models import GaussianUnknownMean
    from pyprob_tpu_torch.nn import InferenceNetworkFeedForward

    model = GaussianUnknownMean()
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    model.learn_inference_network(num_traces=train_traces, **ff_train_kwargs())
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    net = model._inference_network
    check(type(net) is InferenceNetworkFeedForward, f"ff train: trained a {type(net).__name__}")
    steps = net._total_train_iterations
    loss = net._history_train_loss[-1]
    check(math.isfinite(loss), f"ff train: final loss {loss}")
    if device == "cuda":
        for name in KERNEL_NAMES[:2]:
            check(launches[name] >= steps, f"ff train: {name} launched {launches[name]} < {steps} steps")
    emit({
        "phase": "ff_train", "batch_size": FF_GUM["batch_size"], "learning_rate": FF_GUM["learning_rate"],
        "traces": net._total_train_traces, "optimizer_steps": steps, "seconds": seconds,
        "traces_per_s": net._total_train_traces / seconds, "final_loss": loss, "launches": launches,
    })
    return model, launches


def phase_ff_guided_is_trained(device, model, num_traces):
    """The feedforward GUM network served on the batched tier, held to the
    GUM limits and the JAX package's ESS floor 0.15."""
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, "ff guided IS trained")
    mean, std = check_posterior(post, "ff guided IS trained")
    ess_fraction = post.effective_sample_size / num_traces
    check(ess_fraction >= FF_GUM["ess_floor"], f"ff guided IS trained: ESS fraction {ess_fraction}")
    ONLINE_ESS["feedforward"] = ess_fraction
    emit({
        "phase": "ff_guided_is_trained", "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "ess_fraction": ess_fraction, "jax_test_floor": FF_GUM["ess_floor"],
        "peak_memory_gib": peak_gib, "launches": launches,
    })
    return launches


def phase_ff_grad_card_vs_cpu(devices=("cuda", "cpu")):
    """One feedforward training step on the card and on the CPU from the
    same parameters and batch: GUM's packed batch of 256 (kernels 1 and
    1b), and 256 traces of the while-loop Marsaglia model drawn on the
    interpreter tier with prior inflation, several trace types, each its
    own per-type loss (kernels 2 and 2b), at the recipes' widths."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch import vectorized
    from pyprob_tpu_torch.models import GaussianUnknownMean, GaussianUnknownMeanMarsaglia
    from pyprob_tpu_torch.nn import Batch, InferenceNetworkFeedForward, OnlineDataset

    out = {}
    gum = GaussianUnknownMean()
    net = InferenceNetworkFeedForward(
        model=gum, observe_embeddings=ff_train_kwargs()["observe_embeddings"],
        proposal_mixture_components=MIXTURE_COMPONENTS,
    )
    net._pre_generate_layers(gum.prior(num_traces=8))
    rows = FF_GUM["batch_size"]
    outputs, sites = vectorized.run_training_batch(gum, rows)
    batch = net._packed_batch_from_outputs(outputs, sites, rows)
    loss, leaves, err = grads_on_devices(net, batch, devices, KERNEL_NAMES[:2], "ff grad card vs CPU (GUM)")
    out["gum"] = {"rows": rows, "loss": loss, "leaves": leaves, "max_abs_err": err}
    marsaglia = GaussianUnknownMeanMarsaglia()
    obs = FF_MARSAGLIA["observe"]
    net = InferenceNetworkFeedForward(
        model=marsaglia, observe_embeddings={"obs0": dict(obs), "obs1": dict(obs)},
        proposal_mixture_components=MIXTURE_COMPONENTS,
    )
    traces = OnlineDataset(marsaglia, prior_inflation=pp.PriorInflation.ENABLED).next_batch(
        FF_MARSAGLIA["batch_size"])
    net._pre_generate_layers(traces)
    batch = Batch(traces)
    loss, leaves, err = grads_on_devices(net, batch, devices, TNORM_KERNELS, "ff grad card vs CPU (Marsaglia)")
    out["marsaglia"] = {"rows": len(traces), "trace_types": len(batch.sub_batches), "loss": loss,
                        "leaves": leaves, "max_abs_err": err}
    emit({"phase": "ff_grad_card_vs_cpu", **out, "tolerance": "atol 1e-4 + rtol 1e-3 per gradient"})


def phase_marsaglia_ff_interpreter_train(device, train_traces=FF_MARSAGLIA["train_traces"]):
    """The while-loop Marsaglia model's feedforward network trained with the
    JAX package's recipe on the interpreter tier: every batch materialized
    and polymorphed, one per-type loss a trace type, so one launch of kernel
    2 and one of kernel 2b a site a trace type a step."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia

    pp.seed(FF_MARSAGLIA["seed"])
    model = GaussianUnknownMeanMarsaglia()
    obs = FF_MARSAGLIA["observe"]
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    model.learn_inference_network(
        num_traces=train_traces,
        observe_embeddings={"obs0": dict(obs), "obs1": dict(obs)},
        inference_network=pp.InferenceNetwork.FEEDFORWARD,
        prior_inflation=pp.PriorInflation.ENABLED,
        batch_size=FF_MARSAGLIA["batch_size"],
        learning_rate_init=FF_MARSAGLIA["learning_rate"],
        proposal_mixture_components=MIXTURE_COMPONENTS,
    )
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    net = model._inference_network
    steps = net._total_train_iterations
    loss = net._history_train_loss[-1]
    check(math.isfinite(loss), f"Marsaglia FF interpreter train: final loss {loss}")
    rows = None
    if device == "cuda":
        for name in TNORM_KERNELS:
            check(launches[name] >= steps,
                  f"Marsaglia FF interpreter train: {name} launched {launches[name]} times in {steps} steps")
        rows = rows_summary(launches["mixture_truncated_normal_log_prob_by_rows"])
    emit({
        "phase": "marsaglia_ff_interpreter_train", "observe": obs,
        "batch_size": FF_MARSAGLIA["batch_size"], "learning_rate": FF_MARSAGLIA["learning_rate"],
        "seed": FF_MARSAGLIA["seed"], "traces": net._total_train_traces, "optimizer_steps": steps,
        "seconds": seconds, "traces_per_s": net._total_train_traces / seconds, "final_loss": loss,
        "addresses": len(net._params["proposal"]),
        "kernel2_per_step": launches[TNORM_KERNELS[0]] / steps,
        "kernel2b_per_step": launches[TNORM_KERNELS[1]] / steps,
        "kernel2_rows": rows, "launches": launches,
    })
    return model, launches, rows


def phase_marsaglia_ff_lockstep_is(device, model, gum_model):
    """The Marsaglia feedforward network served as bench.py's arm serves:
    1,000 warm-up and 12,000 timed traces of lockstep IC (mean and stddev
    within 0.5; the ESS fraction printed beside the JAX package's floor
    0.008, one trained network being a lottery), one round of served sites
    against the sequential step row by row for it (kernel 2) and for the
    GUM feedforward network (kernel 1), and 2,000 sequential traces."""
    n = INTERPRETER["traces"]
    post, seconds, launches, peak_gib, rounds = phase_interpreter_ic(
        device, model, "Marsaglia FF lockstep IS", INTERPRETER["warm_up"], n
    )
    mean, std = check_posterior(post, "Marsaglia FF lockstep IS")
    ess_fraction = post.effective_sample_size / n
    if device == "cuda":
        check(launches["mixture_truncated_normal_log_prob"] >= 1,
              "Marsaglia FF lockstep IS did not launch mixture_truncated_normal_log_prob")
    tol = LOCKSTEP_ROUND_TOL[device]
    round_check = check_lockstep_round("Marsaglia FF lockstep IS", model, tol)
    gum_round_check = check_lockstep_round("GUM FF lockstep", gum_model, tol)
    m = INTERPRETER["sequential_traces"]
    seq, seq_seconds, _, _, _ = phase_interpreter_ic(
        device, model, "Marsaglia FF sequential IS", 0, m, lockstep=False
    )
    emit({
        "phase": "marsaglia_ff_lockstep_is", "traces": n, "seconds": seconds,
        "traces_per_s": n / seconds, "mean": mean, "stddev": std, "ess_fraction": ess_fraction,
        "jax_test_floor": FF_MARSAGLIA["test_floor"],
        "jax_test_floor_met": ess_fraction >= FF_MARSAGLIA["test_floor"],
        "log_z": log_evidence(post, n), "log_z_analytic": LOG_EVIDENCE, **(rounds or {}),
        "peak_memory_gib": peak_gib, "round_vs_sequential": round_check,
        "gum_round_vs_sequential": gum_round_check,
        "sequential": {"traces": m, "seconds": seq_seconds, "traces_per_s": m / seq_seconds,
                       "mean": float(seq.mean), "ess_fraction": seq.effective_sample_size / m},
        "launches": launches,
    })
    return launches


def check_networks_equal(a, b, label):
    """Parameters, EMA, optimizer state and counters of two networks equal,
    bit for bit."""
    import torch
    from pyprob_tpu_torch.nn.layers import tensor_leaves

    for x, y in zip(tensor_leaves(a._params) + tensor_leaves(a._ema_params),
                    tensor_leaves(b._params) + tensor_leaves(b._ema_params)):
        check(torch.equal(x, y), f"{label}: a parameter or EMA leaf differs after loading")
    sa, sb = a._optimizer.state_dict(), b._optimizer.state_dict()
    check(sa["param_groups"] == sb["param_groups"] and sa["state"].keys() == sb["state"].keys(),
          f"{label}: the optimizer's groups differ after loading")
    for k, state in sa["state"].items():
        for key, v in state.items():
            check(torch.equal(v.cpu(), sb["state"][k][key].cpu()), f"{label}: optimizer state {k}.{key} differs")
    for key in ("_total_train_traces", "_total_train_iterations", "_ema_steps", "_head_train_iterations",
                "_head_meta", "_history_train_loss", "_learning_rate_init"):
        check(getattr(a, key) == getattr(b, key), f"{label}: {key} differs after loading")


def phase_save_load(device, networks, num_traces=NUM_TRACES, train_traces=TRAIN_TRACES):
    """Each of ``networks`` ({label: (model, train kwargs)}) saved and loaded
    into a fresh model on the card: everything equal; a 1M serving with one
    seed giving the same ESS fraction and mean as the original's, to the
    bit; one segment of 12,800 traces continued from both with one seed,
    parameters within 1e-6 (1 + |p|) (bit-equality printed); a file cut
    short raising RuntimeError.  Continuing changes the networks, so this
    runs after every phase that serves them."""
    import tempfile
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.nn import InferenceNetwork
    from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves

    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    serve_seed, train_seed = SAVE_LOAD_SEEDS
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (model, kw) in networks.items():
            path = f"{tmp}/{label}.network"
            t0 = time.perf_counter()
            model.save_inference_network(path)
            save_s = time.perf_counter() - t0
            loaded = type(model)()
            t0 = time.perf_counter()
            loaded.load_inference_network(path)
            load_s = time.perf_counter() - t0
            net, copy = model._inference_network, loaded._inference_network
            check(type(copy) is type(net) and copy.device.type == device, f"save_load {label}: loaded {copy}")
            check_networks_equal(net, copy, f"save_load {label}")
            served = []
            for m in (model, loaded):
                pp.seed(serve_seed)
                post = m.posterior_results(num_traces, observe=OBSERVE, vectorized=True, inference_engine=engine)
                served.append((float(post.mean), post.effective_sample_size / num_traces))
            check(served[0] == served[1], f"save_load {label}: served {served[0]} vs loaded {served[1]}")
            for m in (model, loaded):
                pp.seed(train_seed)
                m.learn_inference_network(num_traces=train_traces, **kw)
            worst, bit_equal = 0.0, True
            for x, y in zip(tensor_leaves(map_tensors(net._params, torch.Tensor.detach)),
                            tensor_leaves(map_tensors(copy._params, torch.Tensor.detach))):
                bit_equal = bit_equal and bool(torch.equal(x, y))
                worst = max(worst, float(((x - y).abs() - 1e-6 * (1 + x.abs())).max()))
            check(worst <= 0, f"save_load {label}: continued parameters differ by {worst} past 1e-6 (1 + |p|)")
            data = open(path, "rb").read()
            with open(f"{tmp}/short.network", "wb") as f:
                f.write(data[: len(data) // 2])
            try:
                InferenceNetwork._load(f"{tmp}/short.network")
                check(False, f"save_load {label}: a file cut short loaded")
            except RuntimeError:
                pass
            out[label] = {"bytes": len(data), "save_seconds": save_s, "load_seconds": load_s,
                          "served_mean_ess_fraction": served[0], "continued_bit_equal": bit_equal,
                          "continued_traces": net._total_train_traces}
    emit({"phase": "save_load", **out,
          "tolerance": "served bit-equal; continued within 1e-6 (1 + |p|)"})


def make_distribution(name, params, device):
    """A distribution of DISTRIBUTION_DRAWS on ``device``: the wrappers
    around a Normal (Censored) and a Poisson (ZeroInflated)."""
    import torch
    from pyprob_tpu_torch import distributions as D

    p = {k: torch.tensor(v, device=device) for k, v in params.items()}
    if name == "Censored":
        return D.Censored(D.Normal(p["loc"], p["scale"]), lower=p["lower"], upper=p["upper"])
    if name == "ZeroInflated":
        return D.ZeroInflated(D.Poisson(p["rate"]), gate=p["gate"])
    return getattr(D, name)(**p)


def phase_distributions(device, n=DISTRIBUTION_DRAW_COUNT):
    """Each scalar distribution's draws on the card from a seeded
    ``torch.Generator``: the same seed gives the same draws, none ±inf; the
    mean and variance of ``n`` draws within 5 standard errors of the
    distribution's own (the median for HalfCauchy; E[cos(x − loc)] for
    VonMises; the median, the quartiles and the share beyond 6 scales for
    Cauchy; the bounds' tail masses for Censored); their ``log_prob`` on
    the card against the same on the CPU within 1e-5 + 1e-5 |cpu|."""
    import torch

    def within(x, expected, what):
        se = float(x.std()) / math.sqrt(x.numel())
        check(abs(float(x.mean()) - expected) <= 5 * se, f"{what}: {float(x.mean())} vs {expected} (se {se})")

    out = {}
    for name, params in DISTRIBUTION_DRAWS.items():
        d = make_distribution(name, params, device)
        draws = [d.sample(torch.Generator(device=device).manual_seed(7), (n,)) for _ in range(2)]
        check(torch.equal(*draws), f"{name}: one seed gave two draws")
        x = draws[0].double()
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite draws")
        if name == "HalfCauchy":
            within((x <= params["scale"]).double(), 0.5, f"{name} median")
        elif name == "VonMises":
            within(torch.cos(x - params["loc"]), 1.0 - float(d.variance), f"{name} E cos")
        elif name == "Cauchy":
            loc, scale = params["loc"], params["scale"]
            for q, at in ((0.25, loc - scale), (0.5, loc), (0.75, loc + scale)):
                within((x <= at).double(), q, f"{name} quantile {q}")
            within(((x - loc).abs() > 6 * scale).double(), 1.0 - 2.0 / math.pi * math.atan(6.0), f"{name} tail share")
        elif name == "Censored":
            check(float(x.min()) >= params["lower"] and float(x.max()) <= params["upper"], f"{name}: draws past a bound")
            within((x <= params["lower"]).double(), 0.5 * math.erfc(-params["lower"] / math.sqrt(2)), f"{name} lower mass")
            within((x >= params["upper"]).double(), 0.5 * math.erfc(params["upper"] / math.sqrt(2)), f"{name} upper mass")
        else:
            within(x, float(d.mean), f"{name} mean")
            within((x - x.mean()) ** 2, float(d.variance), f"{name} variance")
        lp = d.log_prob(draws[0][:4096])
        cpu = make_distribution(name, params, "cpu").log_prob(draws[0][:4096].cpu())
        err = float(((lp.cpu() - cpu).abs() - 1e-5 * (1 + cpu.abs())).max())
        check(err <= 0, f"{name}: log_prob on the card vs the CPU off by {err} past 1e-5 (1 + |cpu|)")
        out[name] = {"mean": float(x.mean()), "variance": float(x.var()),
                     "log_prob_max_abs_err": float((lp.cpu() - cpu).abs().max())}
    emit({"phase": "distributions", "draws": n, **out})


def hmm_model():
    from pyprob_tpu_torch.models import HiddenMarkovModel

    return HiddenMarkovModel(HMM_INIT, HMM_T, HMM_MEANS, 1.0, len(HMM_OBSERVATION))


def hmm_observe():
    return {f"obs{i}": v for i, v in enumerate(HMM_OBSERVATION)}


def train_phase(device, phase, model, kwargs, tnorm_rows=None):
    """One ``learn_inference_network`` call, timed, with its launches; with
    ``tnorm_rows`` kernels 2 and 2b must have launched once a step each,
    at that many rows.  Returns the launches and the printable line."""
    reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    model.learn_inference_network(**kwargs)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    net = model._inference_network
    steps, loss = net._total_train_iterations, net._history_train_loss[-1]
    check(math.isfinite(loss), f"{phase}: final loss {loss}")
    if device == "cuda" and tnorm_rows is not None:
        for name in TNORM_KERNELS:
            check(launches[name] == steps, f"{phase}: {name} launched {launches[name]} times in {steps} steps")
        rows = launches["mixture_truncated_normal_log_prob_by_rows"]
        check(rows == {tnorm_rows: steps}, f"{phase}: kernel 2's rows {rows}")
    line = {
        "phase": phase, "network": net._network_type, "batch_size": kwargs["batch_size"],
        "learning_rate": kwargs["learning_rate_init"], "traces": net._total_train_traces,
        "optimizer_steps": steps, "seconds": seconds, "traces_per_s": net._total_train_traces / seconds,
        "final_loss": loss, "launches": launches,
    }
    if tnorm_rows is not None:
        line["kernel2_launches_per_step"] = launches[TNORM_KERNELS[0]] / steps
        line["kernel2b_launches_per_step"] = launches[TNORM_KERNELS[1]] / steps
        line["kernel2_rows_per_launch"] = tnorm_rows
    return launches, line


def phase_hmm_train(device, network, train_traces=HMM["train_traces"]):
    """pyprob's HMM IC test (tests/test_inference.py:348-395): 51,200
    traces at batch 256, lr 0.005, observe embeddings of depth 2 and dim 8,
    the LSTM at lstm_dim 128 or the feedforward network; 17 categorical
    heads, one-hot sample embeddings for the LSTM."""
    import pyprob_tpu_torch as pp

    model = hmm_model()
    kwargs = dict(
        num_traces=train_traces, observe_embeddings={k: dict(HMM["observe"]) for k in hmm_observe()},
        inference_network=network, batch_size=HMM["batch_size"], learning_rate_init=HMM["learning_rate"],
    )
    if network == pp.InferenceNetwork.LSTM:
        kwargs["lstm_dim"] = HMM["lstm_dim"]
    launches, line = train_phase(device, "hmm_train", model, kwargs)
    net = model._inference_network
    kinds = {m["kind"] for m in net._head_meta.values()}
    check(kinds == {"categorical"} and len(net._head_meta) == 17, f"hmm_train: heads {kinds}")
    emit(line)
    return model, launches


def phase_hmm_prior_is(device, num_traces):
    """IS from the prior of the HMM on the batched tier: the ESS that the
    trained networks' must beat by far, and _check_hmm's distances."""
    model = hmm_model()
    post, seconds, launches, peak_gib = serve_batched(
        device, model, num_traces, "HMM prior IS", hmm_observe(), kernels=(), guided=False
    )
    l2, kl = hmm_l2_kl(np.asarray(post.mean))
    ess_fraction = post.effective_sample_size / num_traces
    emit({
        "phase": "hmm_prior_is", "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "l2": l2, "kl": kl, "ess_fraction": ess_fraction,
        "peak_memory_gib": peak_gib, "launches": launches,
    })
    return ess_fraction, launches


def phase_hmm_guided_is_trained(device, model, num_traces, prior_fraction):
    """The trained HMM network served on the batched tier, held to
    _check_hmm's limits (L2 < 3, KL < 1) and the JAX test's ESS floor
    (0.001 of the traces), the prior IS run's ESS fraction printed beside."""
    net = model._inference_network
    label = f"HMM guided IS trained ({net._network_type})"
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, label, hmm_observe(), kernels=())
    l2, kl = hmm_l2_kl(np.asarray(post.mean))
    ess_fraction = post.effective_sample_size / num_traces
    check(l2 < HMM["l2"] and kl < HMM["kl"], f"{label}: L2 {l2}, KL {kl}")
    check(ess_fraction > HMM["ess_floor"], f"{label}: ESS fraction {ess_fraction}")
    emit({
        "phase": "hmm_guided_is_trained", "network": net._network_type, "traces": num_traces,
        "seconds": seconds, "traces_per_s": num_traces / seconds, "l2": l2, "kl": kl,
        "limits": {"l2": HMM["l2"], "kl": HMM["kl"], "ess_fraction": HMM["ess_floor"]},
        "ess_fraction": ess_fraction, "prior_is_ess_fraction": prior_fraction,
        "peak_memory_gib": peak_gib, "launches": launches,
    })
    return launches


def phase_hmm_lockstep_rounds(device, models):
    """One lockstep round of HMM sites per network against the sequential
    step, row by row (categorical heads and one-hot sample embeddings)."""
    out = {}
    for model in models:
        net = model._inference_network
        out[net._network_type] = check_lockstep_round(
            f"HMM lockstep round ({net._network_type})", model, LOCKSTEP_ROUND_TOL[device], hmm_observe()
        )
    emit({"phase": "hmm_lockstep_rounds", **out})


def beta_bernoulli_model():
    """p ~ Beta(2, 3); 20 Bernoulli(p) observes y0..y19."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Bernoulli, Beta

    class BetaBernoulli(pp.Model):
        def forward(self):
            p = pp.sample(Beta(2.0, 3.0))
            for i in range(20):
                pp.observe(Bernoulli(probs=p), name=f"y{i}")
            return p

    return BetaBernoulli(name="Beta-Bernoulli")


def gamma_poisson_model():
    """rate ~ Gamma(2, 1); two Poisson(rate) observes
    (tests/test_proposals_extended.py:111-122)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Gamma, Poisson

    class GammaPoisson(pp.Model):
        def forward(self):
            rate = pp.sample(Gamma(2.0, 1.0))
            likelihood = Poisson(rate)
            pp.observe(likelihood, name="obs0")
            pp.observe(likelihood, name="obs1")
            return rate

    return GammaPoisson(name="Gamma-Poisson")


def beta_bernoulli_observe():
    return {f"y{i}": float(i < 14) for i in range(20)}


def conjugate_ic(device, phase, model, observe, train_kwargs, num_traces, spec, tnorm_rows=None,
                 kernels=()):
    """Train ``model``'s default feedforward network, serve it and prior IS
    on the batched tier, and hold the guided posterior's mean and stddev
    within ``spec["tol"]`` of the analytic ones (the mean alone where
    ``spec`` has no ``"stddev"``) and its ESS fraction above prior IS's (and
    above ``spec["ess_floor"]`` where given)."""
    launches, train_line = train_phase(device, phase + "_train", model, train_kwargs, tnorm_rows)
    post, seconds, serve_launches, peak_gib = serve_batched(
        device, model, num_traces, phase, observe, kernels=kernels
    )
    prior, prior_seconds, _, _ = serve_batched(device, model, num_traces, phase + " prior IS", observe,
                                               kernels=(), guided=False)
    mean, std = float(post.mean), float(post.stddev)
    ess_fraction = post.effective_sample_size / num_traces
    prior_fraction = prior.effective_sample_size / num_traces
    check(abs(mean - spec["mean"]) <= spec["tol"], f"{phase}: mean {mean}")
    if "stddev" in spec:
        check(abs(std - spec["stddev"]) <= spec["tol"], f"{phase}: stddev {std}")
    check(ess_fraction > prior_fraction, f"{phase}: ESS fraction {ess_fraction} <= prior IS's {prior_fraction}")
    if "ess_floor" in spec:
        check(ess_fraction > spec["ess_floor"], f"{phase}: ESS fraction {ess_fraction}")
    emit({
        "phase": phase, "train": train_line, "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "truth": {"mean": spec["mean"], "stddev": spec.get("stddev", spec.get("truth_stddev"))},
        "tolerance": spec["tol"], "stddev_checked": "stddev" in spec,
        "ess_fraction": ess_fraction, "prior_is_ess_fraction": prior_fraction,
        "prior_is_traces_per_s": num_traces / prior_seconds, "peak_memory_gib": peak_gib,
        "launches": serve_launches,
    })
    return launches, serve_launches


def phase_beta_bernoulli_ic(device, num_traces, train_traces=BETA_BERNOULLI["train_traces"]):
    """Kernels 2 and 2b through the Beta head (the truncated-Normal mixture
    on Beta's [0, 1]): the default feedforward network trained on 51,200
    traces at batch 256, one launch each of kernels 2 and 2b a step at 256
    rows; served at 1M traces (kernel 2 at the chunks' rows) against the
    analytic Beta(16, 9): mean and stddev within 0.01, ESS above prior
    IS's."""
    spec = BETA_BERNOULLI
    observe = beta_bernoulli_observe()
    kwargs = dict(num_traces=train_traces, observe_embeddings={k: {"dim": spec["observe_dim"]} for k in observe},
                  batch_size=spec["batch_size"], learning_rate_init=spec["learning_rate"])
    return conjugate_ic(device, "beta_bernoulli_ic", beta_bernoulli_model(), observe, kwargs, num_traces, spec,
                        tnorm_rows=spec["batch_size"], kernels=(TNORM_KERNELS[0],))


def phase_gamma_poisson_ic(device, num_traces, train_traces=GAMMA_POISSON["train_traces"]):
    """The LogNormal-mixture head: the JAX test's recipe (FF, 12,000 traces
    at batch 512, lr 0.005, 16-d observe embeddings), served at 1M traces
    against the analytic Gamma(10, 3) within 0.35, ESS above prior IS's and
    above 0.15 of the traces.  No kernel runs in its heads."""
    spec = GAMMA_POISSON
    kwargs = dict(num_traces=train_traces,
                  observe_embeddings={k: {"dim": spec["observe_dim"]} for k in spec["observe"]},
                  batch_size=spec["batch_size"], learning_rate_init=spec["learning_rate"])
    return conjugate_ic(device, "gamma_poisson_ic", gamma_poisson_model(), spec["observe"], kwargs, num_traces, spec)


def phase_branching_prior_is(device, num_traces=BRANCHING["batched_traces"],
                             interpreter_traces=BRANCHING["interpreter_traces"]):
    """Poisson on both tiers: BranchingCompiled's prior IS on the batched
    tier and Branching's on the interpreter tier, held to
    Branching.true_posterior(6) within 0.15 and 0.3."""
    from pyprob_tpu_torch.models import Branching, BranchingCompiled

    truth = Branching().true_posterior(6)
    t_mean, t_std = float(truth.mean), float(truth.stddev)
    observe = BRANCHING["observe"]
    post, seconds, launches, peak_gib = serve_batched(device, BranchingCompiled(), num_traces,
                                                      "Branching prior IS", observe, kernels=(), guided=False)
    reset_launch_counts()
    t0 = time.perf_counter()
    ipost = Branching().posterior_results(interpreter_traces, observe=observe, vectorized=False)
    i_seconds = time.perf_counter() - t0
    i_launches = launch_counts()
    out = {}
    for label, p, tol in (("batched", post, BRANCHING["batched_tol"]),
                          ("interpreter", ipost, BRANCHING["interpreter_tol"])):
        mean, std = float(p.mean), float(p.stddev)
        check(abs(mean - t_mean) <= tol and abs(std - t_std) <= tol,
              f"Branching prior IS ({label}): mean {mean}, stddev {std} vs {t_mean}, {t_std}")
        out[label] = {"mean": mean, "stddev": std, "tolerance": tol, "ess_fraction": p.effective_sample_size / p.length}
    emit({
        "phase": "branching_prior_is", "true_mean": t_mean, "true_stddev": t_std,
        "batched_traces": num_traces, "batched_traces_per_s": num_traces / seconds,
        "interpreter_traces": interpreter_traces, "interpreter_traces_per_s": interpreter_traces / i_seconds,
        **out, "peak_memory_gib": peak_gib, "launches": launches, "interpreter_launches": i_launches,
    })
    return launches, i_launches


def grid_moments(xs, log_p):
    """Mean and stddev of the density exp(log_p) on the grid ``xs``."""
    w = np.exp(log_p - log_p.max())
    w /= w.sum()
    mean = float((xs * w).sum())
    return mean, float(np.sqrt(((xs - mean) ** 2 * w).sum()))


def laplace_grid_truth():
    """The Laplace-prior model's posterior moments at obs0 = 4 on the JAX
    test's grid (tests/test_proposals_extended.py:219-223)."""
    xs = np.linspace(-30, 30, 200_001)
    return grid_moments(xs, -np.abs(xs) - 0.5 * ((LAPLACE["observe"]["obs0"] - xs) / 0.5) ** 2)


def tobit_grid_truth():
    """Tobit's posterior moments on the JAX test's grid
    (tests/test_censored_zi.py:92-105): the observes at the bound 1.0 score
    the upper tail's mass, the others the Normal density."""
    from scipy.special import log_ndtr

    mus = np.linspace(-6, 8, 20001)
    log_p = -0.5 * (mus / 2.0) ** 2
    for y in TOBIT["observe"].values():
        log_p = log_p + (log_ndtr(mus - y) if y >= 1.0 else -0.5 * (y - mus) ** 2)
    return grid_moments(mus, log_p)


def zip_grid_truth():
    """The zero-inflated Poisson model's posterior moments of the rate on
    the JAX test's grid (tests/test_censored_zi.py:140-151)."""
    lams = np.linspace(1e-3, 15, 20001)
    g = ZIP["gate"]
    log_p = np.log(lams) - lams  # Gamma(2, 1)
    for y in ZIP["observe"].values():
        if y == 0:
            log_p = log_p + np.log(g + (1 - g) * np.exp(-lams))
        else:
            log_p = log_p + math.log(1 - g) + y * np.log(lams) - lams - math.lgamma(y + 1)
    return grid_moments(lams, log_p)


def geometric_truth():
    """k ~ Geometric(0.4), y ~ Normal(k, 1) = 2: the posterior moments of k
    enumerated over k = 0..200."""
    ks = np.arange(201, dtype=np.float64)
    return grid_moments(ks, ks * math.log(0.6) - 0.5 * (GEOMETRIC["observe"]["y"] - ks) ** 2)


def laplace_model(interpreter=False):
    """x ~ Laplace(0, 1), obs0 ~ Normal(x, 0.5).  With ``interpreter`` the
    class sets ``_never_vectorize`` and runs on the interpreter tier, and a
    branch on the draw adds a second Laplace site where x > 0: two trace
    types, so training takes the gather-table loss by itself; the site is
    not observed, so x's posterior stays the same."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Laplace, Normal

    class LaplaceLocation(pp.Model):
        _never_vectorize = interpreter

        def forward(self):
            x = pp.sample(Laplace(0.0, 1.0))
            if interpreter and x > 0:
                pp.sample(Laplace(0.0, 1.0), name="side")
            pp.observe(Normal(x, 0.5), name="obs0")
            return x

    return LaplaceLocation(name="Laplace location")


def beta_nb_model():
    """p ~ Beta(2, 2); k0, k1 ~ NegativeBinomial(5, p)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Beta, NegativeBinomial

    class BetaNegativeBinomial(pp.Model):
        def forward(self):
            p = pp.sample(Beta(2.0, 2.0), name="p")
            pp.observe(NegativeBinomial(5.0, p), name="k0")
            pp.observe(NegativeBinomial(5.0, p), name="k1")
            return p

    return BetaNegativeBinomial(name="Beta-NegativeBinomial")


def tobit_model():
    """mu ~ Normal(0, 2); y0..y3 ~ Censored(Normal(mu, 1), upper=1)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Censored, Normal

    class Tobit(pp.Model):
        def forward(self):
            mu = pp.sample(Normal(0.0, 2.0))
            likelihood = Censored(Normal(mu, 1.0), upper=1.0)
            for i in range(len(TOBIT["observe"])):
                pp.observe(likelihood, name=f"y{i}")
            return mu

    return Tobit(name="Tobit")


def zip_model():
    """lam ~ Gamma(2, 1); y0..y4 ~ ZeroInflated(Poisson(lam), 0.3)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Gamma, Poisson, ZeroInflated

    gate, n = ZIP["gate"], len(ZIP["observe"])

    class ZeroInflatedPoisson(pp.Model):
        def forward(self):
            lam = pp.sample(Gamma(2.0, 1.0))
            likelihood = ZeroInflated(Poisson(lam), gate=gate)
            for i in range(n):
                pp.observe(likelihood, name=f"y{i}")
            return lam

    return ZeroInflatedPoisson(name="Zero-inflated Poisson")


def geometric_model():
    """k ~ Geometric(0.4); y ~ Normal(k, 1): runs on both tiers."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Geometric, Normal

    class GeometricLatent(pp.Model):
        def forward(self):
            k = pp.sample(Geometric(0.4))
            pp.observe(Normal(k, 1.0), name="y")
            return k

    return GeometricLatent(name="Geometric latent")


def phase_laplace_ic(device, num_traces, train_traces=LAPLACE["train_traces"]):
    """The StudentT-mixture head on the batched tier: the JAX test's recipe
    (FF, 16-d observe embeddings, 12,000 traces at batch 512, lr 0.005),
    served at 1M traces: the mean within 0.3 of the grid truth (the JAX
    test's limit; the stddev printed beside the truth's), the ESS fraction
    above prior IS's.  No kernel runs in its head; kernel 3 in every
    posterior."""
    spec = LAPLACE
    truth = laplace_grid_truth()
    kwargs = dict(num_traces=train_traces, observe_embeddings={"obs0": {"dim": spec["observe_dim"]}},
                  batch_size=spec["batch_size"], learning_rate_init=spec["learning_rate"])
    model = laplace_model()
    out = conjugate_ic(device, "laplace_ic", model, spec["observe"], kwargs, num_traces,
                       {"mean": truth[0], "tol": spec["tol"], "truth_stddev": truth[1]})
    kinds = {m["kind"] for m in model._inference_network._head_meta.values()}
    check(kinds == {"studentt_mixture"}, f"laplace_ic: heads {kinds}")
    return out


def phase_laplace_lockstep(device, num_traces=INTERPRETER["traces"], train_traces=LAPLACE["train_traces"]):
    """The Laplace-prior model's interpreter-only copy (``_never_vectorize``,
    with a branch on the draw that makes two trace types): an LSTM
    (lstm_dim 128) trained on interpreter batches with the JAX test's
    recipe, where every batch holds both trace types and so takes the
    gather-table loss, as the Marsaglia phase's do.  Served by lockstep at
    12,000 traces after 1,000 warm-up: the mean within 0.3 of the grid
    truth, one round of served sites row by row against the sequential
    step within 1e-4 (1 + |ref|), the ESS fraction printed beside prior
    IS's on the same tier at the same count."""
    import pyprob_tpu_torch as pp

    spec = LAPLACE
    observe = spec["observe"]
    truth = laplace_grid_truth()
    model = laplace_model(interpreter=True)
    kw = dict(observe_embeddings={"obs0": {"dim": spec["observe_dim"]}}, inference_network=pp.InferenceNetwork.LSTM,
              lstm_dim=spec["lstm_dim"], batch_size=spec["batch_size"], learning_rate_init=spec["learning_rate"])
    pp.seed(INTERPRETER["seed"])
    launches, train_line = train_phase(device, "laplace_lockstep_train", model, dict(num_traces=train_traces, **kw))
    net = model._inference_network
    check(net._gather_used, "laplace_lockstep_train: the gather-table loss was not used")
    check(len(net._head_meta) == 2 and all(m["kind"] == "studentt_mixture" for m in net._head_meta.values()),
          f"laplace_lockstep_train: heads {net._head_meta}")
    post, seconds, serve_launches, peak_gib, rounds = phase_interpreter_ic(
        device, model, "Laplace lockstep IS", INTERPRETER["warm_up"], num_traces, observe=observe
    )
    mean, std = float(post.mean), float(post.stddev)
    check(abs(mean - truth[0]) <= spec["tol"], f"Laplace lockstep IS: mean {mean} vs {truth[0]}")
    round_check = check_lockstep_round("Laplace lockstep IS", model, LOCKSTEP_ROUND_TOL[device], observe)
    t0 = time.perf_counter()
    prior = model.posterior_results(num_traces, observe=observe, vectorized=False)
    prior_seconds = time.perf_counter() - t0
    emit({
        "phase": "laplace_lockstep", "train": train_line, "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std, "truth": truth,
        "tolerance": spec["tol"], "ess_fraction": post.effective_sample_size / num_traces,
        "prior_is_ess_fraction": prior.effective_sample_size / num_traces,
        "prior_is_traces_per_s": num_traces / prior_seconds, **(rounds or {}), "peak_memory_gib": peak_gib,
        "round_vs_sequential": round_check, "launches": serve_launches,
    })
    return launches, serve_launches


def phase_beta_nb_ic(device, num_traces, train_traces=BETA_NB["train_traces"]):
    """The Beta head again, under NegativeBinomial observes: the default
    feedforward network trained as the Beta–Bernoulli phase trains it (one
    launch each of kernels 2 and 2b a step at 256 rows), served at 1M
    traces against the analytic Beta(12, 18): mean and stddev within 0.01,
    ESS above prior IS's."""
    spec = BETA_NB
    kwargs = dict(num_traces=train_traces,
                  observe_embeddings={k: {"dim": spec["observe_dim"]} for k in spec["observe"]},
                  batch_size=spec["batch_size"], learning_rate_init=spec["learning_rate"])
    return conjugate_ic(device, "beta_nb_ic", beta_nb_model(), spec["observe"], kwargs, num_traces, spec,
                        tnorm_rows=spec["batch_size"], kernels=(TNORM_KERNELS[0],))


def prior_is_vs_truth(device, phase, model, observe, num_traces, truth, tol, check_stddev=True):
    """Prior IS of ``model`` on the batched tier at ``num_traces`` (a warm-up
    run, then a timed one): the mean, and with ``check_stddev`` the stddev,
    within ``tol`` of ``truth``."""
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, phase, observe, kernels=(),
                                                      guided=False)
    mean, std = float(post.mean), float(post.stddev)
    check(abs(mean - truth[0]) <= tol, f"{phase}: mean {mean} vs {truth[0]}")
    if check_stddev:
        check(abs(std - truth[1]) <= tol, f"{phase}: stddev {std} vs {truth[1]}")
    emit({
        "phase": phase, "traces": num_traces, "seconds": seconds, "traces_per_s": num_traces / seconds,
        "mean": mean, "stddev": std, "truth": truth, "tolerance": tol, "stddev_checked": check_stddev,
        "ess_fraction": post.effective_sample_size / num_traces, "peak_memory_gib": peak_gib,
        "launches": launches,
    })
    return launches


def phase_tobit_prior_is(device, num_traces=TOBIT["traces"]):
    """Censored Normal observes (two at the bound): mean and stddev within
    0.03 of the grid truth (the JAX test's limits)."""
    return prior_is_vs_truth(device, "tobit_prior_is", tobit_model(), TOBIT["observe"], num_traces,
                             tobit_grid_truth(), TOBIT["tol"])


def phase_zip_prior_is(device, num_traces=ZIP["traces"]):
    """Zero-inflated Poisson observes: the mean within 0.05 of the grid
    truth (the JAX test's limit; the stddev printed)."""
    return prior_is_vs_truth(device, "zip_prior_is", zip_model(), ZIP["observe"], num_traces, zip_grid_truth(),
                             ZIP["tol"], check_stddev=False)


def phase_geometric_prior_is(device, num_traces=GEOMETRIC["batched_traces"],
                             interpreter_traces=GEOMETRIC["interpreter_traces"]):
    """A Geometric latent on both tiers: prior IS at 1M traces batched and
    4,000 on the interpreter against the enumerated posterior."""
    truth = geometric_truth()
    launches = prior_is_vs_truth(device, "geometric_prior_is", geometric_model(), GEOMETRIC["observe"],
                                 num_traces, truth, GEOMETRIC["batched_tol"])
    reset_launch_counts()
    t0 = time.perf_counter()
    post = geometric_model().posterior_results(interpreter_traces, observe=GEOMETRIC["observe"], vectorized=False)
    seconds = time.perf_counter() - t0
    i_launches = launch_counts()
    mean, std = float(post.mean), float(post.stddev)
    tol = GEOMETRIC["interpreter_tol"]
    check(abs(mean - truth[0]) <= tol and abs(std - truth[1]) <= tol,
          f"geometric prior IS (interpreter): mean {mean}, stddev {std} vs {truth}")
    emit({
        "phase": "geometric_interpreter_prior_is", "traces": interpreter_traces, "seconds": seconds,
        "traces_per_s": interpreter_traces / seconds, "mean": mean, "stddev": std, "truth": truth,
        "tolerance": tol, "ess_fraction": post.effective_sample_size / interpreter_traces,
        "launches": i_launches,
    })
    return launches, i_launches


def event_models():
    """The event-shaped latents' models by name (EVENT_IC), their
    coordinates read as ``z[..., i]`` so one body runs on both tiers."""
    import numpy as np
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Categorical, Dirichlet, LKJCholesky, MultivariateNormal, Normal

    class MVNLatent(pp.Model):
        def forward(self):
            z = pp.sample(MultivariateNormal(np.zeros(2), covariance_matrix=np.eye(2)))
            pp.observe(Normal(z[..., 0] + z[..., 1], 0.2), name="obs")
            return z

    class DirichletLatent(pp.Model):
        def forward(self):
            p = pp.sample(Dirichlet(np.ones(3) * 2.0))
            pp.observe(Categorical(probs=p), name="obs")
            return p

    class LKJLatent(pp.Model):
        def forward(self):
            L = pp.sample(LKJCholesky(2, 1.0))
            pp.observe(MultivariateNormal(np.zeros(2), scale_tril=L), name="y")
            return L[..., 1, 0]

    return {"mvn": MVNLatent, "dirichlet": DirichletLatent, "lkj": LKJLatent}


def dircat_model():
    """p ~ Dirichlet(1, 1, 1); o0, o1, o2 ~ Categorical(p)."""
    import numpy as np
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Categorical, Dirichlet

    class DirCat(pp.Model):
        def forward(self):
            p = pp.sample(Dirichlet(np.ones(3)))
            for name in DIRCAT["observe"]:
                pp.observe(Categorical(probs=p), name=name)
            return p

    return DirCat(name="Dirichlet-Categorical")


def mvn_conjugate_model():
    """x ~ N(0, I_2); y ~ N(x, I_2)."""
    import numpy as np
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import MultivariateNormal

    class MVNConjugate(pp.Model):
        def forward(self):
            x = pp.sample(MultivariateNormal(np.zeros(2), covariance_matrix=np.eye(2)))
            pp.observe(MultivariateNormal(x, covariance_matrix=np.eye(2)), name="y")
            return x

    return MVNConjugate(name="MVN conjugate")


def event_distributions(device):
    """The new classes at the parameters their draws are checked at."""
    import torch
    from pyprob_tpu_torch import distributions as D

    def t(v):
        return torch.tensor(v, device=device)

    return {
        "Dirichlet": D.Dirichlet(t([2.0, 0.5, 1.0])),
        "Dirichlet_small_alpha": D.Dirichlet(t([1e-4, 1e-4, 1e-4])),
        "Multinomial": D.Multinomial(t(10.0), probs=t([0.2, 0.3, 0.5])),
        "LKJCholesky": D.LKJCholesky(3, t(1.5)),
        "LKJCholeskyCPCNormal": D.LKJCholeskyCPCNormal(t([0.3, -0.2, 0.1]), t([-0.5, 0.0, -1.0]), 3),
    }


def phase_event_distributions(device, n=EVENT_DRAW_COUNT):
    """The event-shaped classes' ``n`` draws on the card from a seeded
    generator (one seed, one draw), none NaN or ±inf: each component's
    mean and variance within 5 standard errors of the distribution's own
    (Dirichlet, Multinomial, whose rows also sum to the count); LKJ(3, 1.5)'s
    implied correlations against their marginal 2 Beta(2, 2) − 1 (mean 0,
    variance 1/5), its rows of unit norm within 1e-5; the CPC proposal's
    partial correlations atanh'd back to Normals with its loc and scale;
    the Dirichlet at α = 1e-4 with no NaN row, every row summing to 1
    within 1e-5.  ``log_prob`` of 4,096 draws on the card against the CPU
    within 1e-5 (1 + |cpu|), with the same ±inf entries."""
    import torch
    from pyprob_tpu_torch.distributions.lkj import _chol_to_cpc

    def within(x, expected, what):
        x = x.double().reshape(x.shape[0], -1)
        se = x.std(0) / math.sqrt(x.shape[0])
        err = (x.mean(0) - torch.as_tensor(expected, dtype=torch.float64, device=x.device).reshape(-1)).abs()
        check(bool((err <= 5 * se).all()), f"{what}: off by {err.tolist()}, standard errors {se.tolist()}")

    out = {}
    cpu = event_distributions("cpu")
    for name, d in event_distributions(device).items():
        draws = [d.sample(torch.Generator(device=device).manual_seed(7), (n,)) for _ in range(2)]
        check(torch.equal(*draws), f"{name}: one seed gave two draws")
        x = draws[0]
        check(x.shape == (n,) + tuple(d.event_shape), f"{name}: draws of shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name}: NaN or ±inf draws")
        line = {}
        if name.startswith("Dirichlet"):
            row_err = float((x.double().sum(-1) - 1).abs().max())
            check(row_err <= 1e-5, f"{name}: a row sums to 1 ± {row_err}")
            line["row_sum_max_abs_err"] = row_err
            line["zero_components"] = int((x == 0).sum())
        if name in ("Dirichlet", "Multinomial"):
            within(x, d.mean, f"{name} mean")
            within((x.double() - d.mean.double()) ** 2, d.variance, f"{name} variance")
            if name == "Multinomial":
                check(bool((x.sum(-1) == 10).all()), f"{name}: counts do not sum to 10")
        if name == "LKJCholesky":
            norm_err = float((x.double().pow(2).sum(-1) - 1).abs().max())
            check(norm_err <= 1e-5, f"{name}: a row's norm off by {norm_err}")
            W = x @ x.mT
            r = torch.stack([W[:, 1, 0], W[:, 2, 0], W[:, 2, 1]], -1)
            within(r, [0.0] * 3, f"{name} correlations' mean")
            within(r.double() ** 2, [0.2] * 3, f"{name} correlations' variance")
            line["row_norm_max_abs_err"] = norm_err
        if name == "LKJCholeskyCPCNormal":
            z = _chol_to_cpc(x.double(), 3)
            loc, scale = d.loc.double(), torch.exp(d.log_scale.double())
            within(z, loc, f"{name} partial correlations' mean")
            within((z - loc) ** 2, scale**2, f"{name} partial correlations' variance")
        lp = d.log_prob(x[:4096]).cpu()
        ref = cpu[name].log_prob(x[:4096].cpu())
        check(torch.equal(torch.isinf(lp), torch.isinf(ref)) and torch.equal(lp == math.inf, ref == math.inf),
              f"{name}: log_prob's ±inf entries on the card differ from the CPU's")
        fin = torch.isfinite(ref)
        err = float(((lp[fin] - ref[fin]).abs() - 1e-5 * (1 + ref[fin].abs())).max()) if bool(fin.any()) else 0.0
        check(err <= 0, f"{name}: log_prob on the card vs the CPU off by {err} past 1e-5 (1 + |cpu|)")
        line["log_prob_max_abs_err"] = float((lp[fin] - ref[fin]).abs().max()) if bool(fin.any()) else 0.0
        line["log_prob_inf_entries"] = int(torch.isinf(lp).sum())
        out[name] = line
    emit({"phase": "event_distributions", "draws": n, **out})


def phase_lkj_cpc_density(device, n=EVENT_DRAW_COUNT):
    """The CPC proposal's density is exact over Cholesky factors: the
    importance weights LKJCholesky(3, 1.5) / LKJCholeskyCPCNormal(0, 0) of
    ``n`` proposal draws on the card average 1 within 0.1
    (tests/test_proposals_extended.py:364-385)."""
    import torch
    from pyprob_tpu_torch import distributions as D

    q = D.LKJCholeskyCPCNormal(torch.zeros(3, device=device), torch.zeros(3, device=device), 3)
    p = D.LKJCholesky(3, torch.tensor(1.5, device=device))
    L = q.sample(torch.Generator(device=device).manual_seed(5), (n,))
    lw = (p.log_prob(L) - q.log_prob(L)).double()
    check(bool(torch.isfinite(lw).all()), "lkj_cpc_density: non-finite weights")
    z = float(torch.exp(torch.logsumexp(lw, 0) - math.log(n)))
    check(abs(z - 1.0) < 0.1, f"lkj_cpc_density: mean weight {z}")
    emit({"phase": "lkj_cpc_density", "draws": n, "mean_weight": z, "tolerance": 0.1,
          "ess_fraction": float(torch.exp(2 * torch.logsumexp(lw, 0) - torch.logsumexp(2 * lw, 0))) / n})


def event_ic_train_kwargs(name, network):
    import pyprob_tpu_torch as pp

    r = EVENT_IC_RECIPE
    return dict(num_traces=EVENT_IC[name]["train_traces"],
                observe_embeddings={k: {"dim": r["observe_dim"]} for k in EVENT_IC[name]["observe"]},
                inference_network=getattr(pp.InferenceNetwork, network),
                batch_size=r["batch_size"], learning_rate_init=r["learning_rate"])


def event_ic_criteria(name, post, num_traces, base):
    """The JAX test's criteria on one posterior, as {criterion: (value,
    limit, met)}: the mean (within ``tol`` of the truth, or for the LKJ
    latent of ``base``'s, a prior IS) and the ESS fraction (above
    ``ess_floor``, or above ``ess_over_prior`` times ``base``'s)."""
    spec = EVENT_IC[name]
    mean = np.asarray(post.mean, dtype=np.float64).reshape(-1)
    truth = np.asarray(spec["mean"] if "mean" in spec else base.mean, dtype=np.float64).reshape(-1)
    err = float(np.abs(mean - truth).max())
    ess = post.effective_sample_size / num_traces
    if "ess_floor" in spec:
        floor = spec["ess_floor"]
    else:
        floor = spec["ess_over_prior"] * base.effective_sample_size / base.length
    return {"mean": (mean.tolist(), truth.tolist(), err <= spec["tol"]),
            "ess": (ess, floor, ess > floor)}


def counted(device, fn):
    """``fn()`` with the kernels' launches counted: (result, launches)."""
    reset_launch_counts()
    sync(device)
    out = fn()
    sync(device)
    return out, launch_counts()


def phase_event_ic(device, name, network, num_traces=NUM_TRACES, seeds=EVENT_IC_RECIPE["seeds"]):
    """IC on an event-shaped latent (EVENT_IC[name]) with the JAX test's
    recipe, trained from ``seeds`` seeds in turn (the JAX test's first):
    the reference prior IS, the network trained, served at the JAX test's
    counts on the batched tier and by lockstep, each of the test's criteria
    met by as many seeds as EVENT_IC_JAX_MET asks.  The first seed's
    network is also served at ``num_traces`` on the batched tier beside
    prior IS at ``num_traces`` (a warm-up run, then a timed one each), its
    mean held to the truth (the LKJ latent's to prior IS's) and its ESS
    fraction printed, and by lockstep after 256 warm-up traces.  Prints
    the training and serving traces/s, kernel 3's launches and the peak
    device memory (< 10 GiB).  Returns the launches by sub-phase."""
    import pyprob_tpu_torch as pp

    spec, r = EVENT_IC[name], EVENT_IC_RECIPE
    phase = f"{name}_ic_{network.lower()}"
    observe, n, n_lock = spec["observe"], spec["traces"], r["lockstep_traces"]
    kind = {"mvn": "mvn", "dirichlet": "dirichlet", "lkj": "lkj_cpc_normal"}[name]
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    launches, by_seed = {}, []
    for i in range(seeds):
        seed = spec["seed"] + i
        key = phase if i == 0 else f"{phase}_seed{seed}"
        model = event_models()[name]()
        pp.seed(seed)
        if i == 0:
            prior, prior_seconds, launches[key + "_prior_is"], _ = serve_batched(
                device, model, num_traces, phase + " prior IS", observe, kernels=(), guided=False)
        base = None
        if "base_traces" in spec:
            base, launches[key + "_base"] = counted(device, lambda: model.posterior_results(
                spec["base_traces"], observe=observe, vectorized=True))
        launches[key + "_train"], train_line = train_phase(device, key + "_train", model,
                                                           event_ic_train_kwargs(name, network))
        heads = model._inference_network._head_meta
        check([m["kind"] for m in heads.values()] == [kind], f"{phase}: heads {heads}")
        post, launches[key + "_jax_count"] = counted(device, lambda: model.posterior_results(
            n, observe=observe, vectorized=True, inference_engine=engine))
        lpost, lseconds, launches[key + "_lockstep"], lpeak_gib, rounds = phase_interpreter_ic(
            device, model, key + " lockstep", r["lockstep_warm_up"] if i == 0 else 0, n_lock, observe=observe)
        results = {f"{tier}_{c}": v for tier, p, count in (("batched", post, n), ("lockstep", lpost, n_lock))
                   for c, v in event_ic_criteria(name, p, count, base).items()}
        by_seed.append({"seed": seed, "final_loss": train_line["final_loss"],
                        **{k: {"value": v[0], "limit": v[1], "met": v[2]} for k, v in results.items()}})
        if i > 0:
            continue
        big, seconds, launches[key], peak_gib = serve_batched(device, model, num_traces, phase, observe, kernels=())
        big_mean, truth, mean_met = event_ic_criteria(name, big, num_traces, prior)["mean"]
        check(mean_met, f"{phase}: mean {big_mean} at {num_traces} traces against {truth}")
        first = {
            "train": train_line, "traces": num_traces, "seconds": seconds, "traces_per_s": num_traces / seconds,
            "mean": big_mean, "ess_fraction": big.effective_sample_size / num_traces,
            "prior_is_mean": np.asarray(prior.mean, dtype=np.float64).reshape(-1).tolist(),
            "prior_is_ess_fraction": prior.effective_sample_size / num_traces,
            "prior_is_traces_per_s": num_traces / prior_seconds,
            "lockstep": {"traces": n_lock, "seconds": lseconds, "traces_per_s": n_lock / lseconds,
                         **(rounds or {}), "peak_memory_gib": lpeak_gib},
            "kernel3_launches": launches[key]["log_weight_stats"], "peak_memory_gib": peak_gib,
            "launches": launches[key],
        }
    met = {k: sum(line[k]["met"] for line in by_seed) for k in EVENT_IC_JAX_MET[phase]}
    needed = {k: max(1, round(c * seeds / 8) - 4) for k, c in EVENT_IC_JAX_MET[phase].items()}
    emit({"phase": phase, "network": network, **first, "criteria": {
        "traces": n, "lockstep_traces": n_lock, "base_traces": spec.get("base_traces"), "tolerance": spec["tol"],
        "seeds_met": met, "seeds_needed": needed, "jax_seeds_met_of_8": EVENT_IC_JAX_MET[phase],
        "by_seed": by_seed}})
    for k in met:
        check(met[k] >= needed[k], f"{phase}: {k} met by {met[k]} of {seeds} seeds, {needed[k]} needed")
    return launches


def phase_conjugate_prior_is(device, phase, model, spec, num_traces=NUM_TRACES,
                             interpreter_traces=CONJUGATE_INTERPRETER_TRACES):
    """Prior IS of a conjugate model with a vector latent on both tiers:
    the mean (and the variance where ``spec`` has it) within ``spec["tol"]``
    of the analytic posterior's, per coordinate.  Returns the batched
    run's launches."""
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, phase, spec["observe"],
                                                      kernels=(), guided=False)
    reset_launch_counts()
    t0 = time.perf_counter()
    ipost = model.posterior_results(interpreter_traces, observe=spec["observe"], vectorized=False)
    iseconds = time.perf_counter() - t0
    line = {}
    for tier, p in (("batched", post), ("interpreter", ipost)):
        moments = {"mean": np.asarray(p.mean, dtype=np.float64)}
        if "variance" in spec:
            moments["variance"] = np.asarray(p.variance, dtype=np.float64)
        for key, value in moments.items():
            err = float(np.abs(value - np.asarray(spec[key])).max())
            check(value.shape == (len(spec[key]),) and err <= spec["tol"], f"{phase} ({tier}): {key} {value.tolist()}")
            line[f"{tier}_{key}"] = value.tolist()
    emit({
        "phase": phase, "traces": num_traces, "seconds": seconds, "traces_per_s": num_traces / seconds,
        "interpreter_traces": interpreter_traces, "interpreter_traces_per_s": interpreter_traces / iseconds,
        **line, "truth": {k: spec[k] for k in ("mean", "variance") if k in spec}, "tolerance": spec["tol"],
        "ess_fraction": post.effective_sample_size / num_traces, "peak_memory_gib": peak_gib,
        "launches": launches,
    })
    return launches


def phase_new_path_kernel_shapes(path, floor_ms):
    """Kernels 2 and 2b held against their plain versions and timed at every
    row count the new phases launched kernel 2 at (the Beta head's
    training batch and its serving chunks), beside their bounds and the
    launch floor."""
    from pyprob_tpu_torch.ops import kernels as K

    Kc = MIXTURE_COMPONENTS
    rows = set()
    for counts in path.values():
        rows |= set(counts.get("mixture_truncated_normal_log_prob_by_rows", {}))
    for n in sorted(rows):
        small, small_out, small_g, fwd_err, bwd_err = check_tnorm(n, "cuda", seed=n)
        iters = 100 if n <= 4096 else 10
        emit_shape(
            "mixture_truncated_normal_log_prob", lambda: K.mixture_truncated_normal_log_prob(*small),
            lambda: K.mixture_truncated_normal_log_prob_plain(*small), *tnorm_cost(n, Kc), [n, Kc],
            fwd_err, iters=iters, path="Beta head", launch_floor_ms=floor_ms,
        )
        emit_shape(
            "mixture_truncated_normal_log_prob_backward",
            lambda: K.mixture_truncated_normal_log_prob_backward(*small, small_out, small_g),
            lambda: K.mixture_truncated_normal_log_prob_backward_plain(*small, small_out, small_g),
            *tnorm_backward_cost(n, Kc), [n, Kc], bwd_err, iters=iters, path="Beta head",
            launch_floor_ms=floor_ms,
        )
    emit({"phase": "new_path_kernel_checks", "kernel2_rows": sorted(rows)})


def check_round_forwards(rows, components=MIXTURE_COMPONENTS, seed=0):
    """Kernels 1 and 2 forward against their plain versions at a lockstep
    round's ``rows``: finite values within 1e-5 (kernel 1) and 1e-5 + 1e-5
    |ref| (kernel 2), -inf/NaN where the plain version has them, with the
    special rows from 8 rows on.  Returns each kernel's inputs and error."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    out = {}
    for name, inputs, rtol in (
        ("mixture_normal_log_prob", mixture_inputs(rows, components, "cuda", seed), 0.0),
        ("mixture_truncated_normal_log_prob", tnorm_inputs(rows, components, "cuda", seed)[:6], 1e-5),
    ):
        if rows >= 8:
            set_special_rows(inputs)
        got = getattr(K, name)(*inputs)
        ref = getattr(K, name + "_plain")(*inputs)
        where = f"{name} at B={rows}"
        for what in (torch.isnan, torch.isposinf, torch.isneginf):
            check(bool((what(got) == what(ref)).all()), f"{where}: {what.__name__} pattern")
        finite = torch.isfinite(ref)
        err = float((got - ref).abs()[finite].max()) if bool(finite.any()) else 0.0
        excess = float(((got - ref).abs() - (1e-5 + rtol * ref.abs()))[finite].max()) if bool(finite.any()) else 0.0
        check(excess <= 0, f"{where}: exceeds 1e-5 + {rtol}|ref| by {excess}")
        out[name] = (inputs, err)
    return out


def phase_interpreter_kernel_shapes(train_rows, floor_ms, ff_rows=None):
    """Kernels 2 and 2b held against their plain versions and timed at the
    rows the interpreter's gather loss gave kernel 2 (min, median, max), at
    those the feedforward network's per-type losses gave it (``ff_rows``)
    and at an odd count near 650; kernels 1 and 2 at the rows of lockstep
    rounds (1, 7, 33, 64); each beside its bound and the launch floor."""
    from pyprob_tpu_torch.ops import kernels as K

    Kc = MIXTURE_COMPONENTS
    checked = {train_rows["min"], train_rows["median"], train_rows["max"], 651}
    if ff_rows is not None:
        checked |= {ff_rows["min"], ff_rows["median"], ff_rows["max"]}
    checked = sorted(checked)
    for n in checked:
        small, small_out, small_g, fwd_err, bwd_err = check_tnorm(n, "cuda", seed=n)
        emit_shape(
            "mixture_truncated_normal_log_prob", lambda: K.mixture_truncated_normal_log_prob(*small),
            lambda: K.mixture_truncated_normal_log_prob_plain(*small), *tnorm_cost(n, Kc), [n, Kc],
            fwd_err, iters=100, path="interpreter training", launch_floor_ms=floor_ms,
        )
        emit_shape(
            "mixture_truncated_normal_log_prob_backward",
            lambda: K.mixture_truncated_normal_log_prob_backward(*small, small_out, small_g),
            lambda: K.mixture_truncated_normal_log_prob_backward_plain(*small, small_out, small_g),
            *tnorm_backward_cost(n, Kc), [n, Kc], bwd_err, iters=100, path="interpreter training",
            launch_floor_ms=floor_ms,
        )
    for n in ROUND_ROWS:
        got = check_round_forwards(n, seed=n)
        for name, cost in (("mixture_normal_log_prob", mixture_cost), ("mixture_truncated_normal_log_prob", tnorm_cost)):
            inputs, err = got[name]
            emit_shape(
                name, lambda: getattr(K, name)(*inputs), lambda: getattr(K, name + "_plain")(*inputs),
                *cost(n, Kc), [n, Kc], err, iters=100, path="lockstep round", launch_floor_ms=floor_ms,
            )
    emit({"phase": "interpreter_kernel_checks", "training_rows": checked, "round_rows": list(ROUND_ROWS)})


def gp_model(N):
    """The GP of the JAX package's test and chip study at N points, with its
    data y = synthesize(rng=3, lengthscale=1.0)."""
    from pyprob_tpu_torch.models import GaussianProcessRegression

    model = GaussianProcessRegression(np.linspace(0, 4, N), learn=("lengthscale",), noise=0.2)
    return model, model.synthesize(rng=3, lengthscale=1.0)


def gp_covariances(N, B, device, log_lengthscales=None, seed=0):
    """B kernel matrices [B, N, N] of the GP at log-lengthscales drawn from
    its prior (or given), and diff = y for each: the inputs the GP path
    factors."""
    import torch

    model, y = gp_model(N)
    if log_lengthscales is None:
        log_lengthscales = np.random.default_rng(seed).normal(size=B)
    ell = torch.tensor(np.exp(log_lengthscales), dtype=torch.float32, device=device)
    K = model._cov_batched(model._sq_dists_tensor(torch.device(device)), (B,), ell, 1.0, 0.2)
    diff = torch.tensor(y, dtype=torch.float32, device=device).expand(B, N).contiguous()
    return K, diff


def nan_pattern_equal(a, b):
    import torch

    return bool(torch.equal(torch.isnan(a), torch.isnan(b)))


def check_tile(B, P, device, N=256, k0=0):
    """Kernel 4 against its plain version on the tiles K[:, k0:k0+P,
    k0:k0+P] of B GP covariances of size N, tile 5 made indefinite: the
    contiguous entry on a copy, and the panel loop's entry reading the
    tiles in place (row stride N) and writing L into the rows out[:, k0:k0+P,
    k0:] of an [B, N, N] matrix, with zeros past the diagonal block and
    nothing else touched.  Equal NaN patterns, elsewhere |kernel - plain| <=
    1e-3 (1 + |plain|).  Both run the same column loop with each product and
    difference rounded alone; rsqrtf and torch.rsqrt may part by an ulp,
    which the tile's condition number (up to ~2e3 for these tiles)
    amplifies.  Returns the tile view, the rows of out and the max abs
    error."""
    import torch
    from pyprob_tpu_torch.ops import tile_chol

    K, _ = gp_covariances(N, B, device, seed=P + k0)
    tiles = K[:, k0 : k0 + P, k0 : k0 + P]
    tiles[5, P // 2, P // 2] = -1.0
    out = torch.full_like(K, 7.0)
    rows = out[:, k0 : k0 + P, k0:]
    M_in_place = tile_chol.chol_inv_tile_into(tiles, rows)
    L, M = tile_chol.chol_inv_tile(tiles.contiguous())
    pL, pM = tile_chol.chol_inv_tile_plain(tiles)
    sync(device)
    err = 0.0
    for what, mine, ref in (
        ("L", L, pL), ("L^-1", M, pM), ("L in place", rows[:, :, :P], pL),
        ("L^-1 of the in-place entry", M_in_place, pM),
    ):
        check(nan_pattern_equal(mine, ref), f"chol_inv_tile P={P}: NaN pattern of {what}")
        check(bool(torch.isnan(ref[5]).any()) and not bool(torch.isnan(ref[:5]).any()),
              f"chol_inv_tile P={P}: NaN only in the indefinite tile")
        ok = ~torch.isnan(ref)
        excess = float(((mine - ref).abs() - 1e-3 * (1 + ref.abs()))[ok].max())
        check(excess <= 0, f"chol_inv_tile P={P}: {what} exceeds 1e-3 (1 + |plain|) by {excess}")
        err = max(err, float((mine - ref).abs()[ok].max()))
    check(bool((rows[:, :, P:] == 0).all()), f"chol_inv_tile P={P}: no zeros right of the block")
    check(bool((out[:, :k0] == 7).all() and (out[:, k0 + P :] == 7).all()
               and (rows[:, :, :0] == 7).all() and (out[:, k0 : k0 + P, :k0] == 7).all()),
          f"chol_inv_tile P={P}: wrote outside the panel's rows")
    del K, out, L, M, pL, pM, M_in_place
    return tiles, rows, err


def check_quad_logdet(B, N, device):
    """Kernels 5/6 against the plain version (cuSOLVER Cholesky and a
    triangular solve) on B GP covariances, matrix 2 made indefinite at
    column 7 and matrix 3 at column 32, the first of the kernel's second
    panel (B = None: one unbatched matrix, no indefinite one): equal NaN
    patterns, elsewhere |kernel - plain| <= 0.02 + 1e-4 |plain| per output.
    Two float32 Cholesky factorizations of a matrix with condition number
    up to ~6e3 part by up to ~0.005 in the log-likelihood (the CPU against
    float64), and the sums run in other orders.  Returns the inputs and
    the max abs error."""
    import torch
    from pyprob_tpu_torch.ops import mvn_logpdf

    cov, diff = gp_covariances(N, B or 1, device, seed=N)
    if B is None:
        cov, diff = cov[0], diff[0]
    else:
        cov[2, 7, 7] = -1.0
        cov[3, PANEL, PANEL] = -1.0  # first fails at a panel boundary
    out = mvn_logpdf.mvn_quad_logdet(cov, diff)
    ref = mvn_logpdf.mvn_quad_logdet_plain(cov, diff)
    err = 0.0
    for what, mine, want in zip(("quad", "half_logdet"), out, ref):
        check(nan_pattern_equal(mine, want), f"mvn_quad_logdet B={B} N={N}: NaN pattern of {what}")
        ok = ~torch.isnan(want)
        if B is not None:
            check(not bool(ok[2:4].any()) and bool(ok[:2].all()) and bool(ok[4:].all()),
                  f"mvn_quad_logdet B={B} N={N}: NaN only at 2 and 3")
        excess = float(((mine - want).abs() - (0.02 + 1e-4 * want.abs()))[ok].max())
        check(excess <= 0, f"mvn_quad_logdet B={B} N={N}: {what} exceeds 0.02 + 1e-4|plain| by {excess}")
        err = max(err, float((mine - want).abs()[ok].max()))
    return cov, diff, err


def ptxas_report(fragment):
    """Registers, shared memory and spills that ptxas reported (nvcc
    -Xptxas -v, ops.build.build_log) for each entry function whose mangled
    name holds ``fragment``."""
    from pyprob_tpu_torch.ops import build

    report, entry = {}, None
    for line in build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if fragment in m.group(1) else None
        elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report.setdefault(entry, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)  # static; absent when 0
            report.setdefault(entry, {}).update(
                registers=int(m[1]), static_smem_bytes=int(smem[1]) if smem else 0)
    return report


def quad_logdet_launch(B, N):
    """Kernels 5/6's launch at B matrices of size N: panel width, threads
    per block, blocks, workspace, dynamic shared memory a block, and
    ptxas's report for that instance."""
    import torch
    from pyprob_tpu_torch.ops import mvn_logpdf

    plan = mvn_logpdf.launch_plan(B, N, torch.device("cuda", torch.cuda.current_device()))
    instance = f"Li{plan['threads']}E"  # the template argument in the mangled name
    resources = [r for name, r in ptxas_report("mvn_quad_logdet_kernel").items() if instance in name]
    check(len(resources) == 1, f"mvn_quad_logdet: no ptxas report for {instance}")
    return {**plan, **resources[0]}


def tile_bytes(B, P, width=None):
    """Kernel 4's least traffic: each tile's lower triangle read (the
    column loop reads nothing above the diagonal), L^-1 written, and L's
    rows of ``width`` (default P) written, zeros past the block included."""
    return 4 * B * (P * (P + 1) // 2 + P * (width or P) + P * P)


def quad_logdet_bytes(B, N):
    """Kernels 5/6's least traffic: each K's lower triangle and diff
    read, two floats written."""
    return 4 * B * (N * (N + 1) // 2 + N + 2)


def phase_linalg_kernels():
    import torch
    from pyprob_tpu_torch.ops import blocked_linalg, mvn_logpdf, tile_chol

    rows = []
    into, plain = tile_chol.chol_inv_tile_into, tile_chol.chol_inv_tile_plain
    # the last panels of N = 130 and N = 200 (P = 2 and 8), and the first
    # of N = 512 at its batch, each as the panel loop launches it: read in
    # place, L written into the rows of the full factor
    for B, N, k0, P in ((8192, 130, 128, 2), (8192, 200, 192, 8), (2048, 512, 0, 64)):
        tiles, out_rows, err = check_tile(B, P, "cuda", N, k0)
        emit_shape(
            "chol_inv_tile", lambda: into(tiles, out_rows), lambda: plain(tiles),
            tile_bytes(B, P, N - k0), 2 * P**3 * B // 3, [B, P, P], err,
            entry="chol_inv_tile_into", l_row_width=N - k0,
        )
        del tiles, out_rows
    # the four panels of N = 256 at the largest GP batch, B = 32,768, as the
    # panel loop launches them: the tile read from the trailing matrix [B,
    # m, m] (row stride m = 256, 192, 128, 64), L written into rows of width m
    B, P = GP_LARGE[1], 64
    for m in range(GP_LARGE[0], 0, -P):
        tiles, out_rows, err = check_tile(B, P, "cuda", m)
        emit_shape(
            "chol_inv_tile", lambda: into(tiles, out_rows), lambda: plain(tiles),
            tile_bytes(B, P, m), 2 * P**3 * B // 3, [B, P, P], err,
            entry="chol_inv_tile_into", l_row_width=m, panel_of=GP_LARGE[0],
        )
        del tiles, out_rows
    # kernel 4's row: the first panel of N = 256, B = 8,192
    B, N, P = 8192, 256, 64
    tiles, out_rows, err = check_tile(B, P, "cuda", N)
    ops = 2 * P**3 * B // 3  # useful work: P^3/3 factor + P^3/3 inverse
    bound_ms, bound_by = bound(tile_bytes(B, P, N), ops)
    rows.append({
        "name": "chol_inv_tile", "route": "cuda",
        "source": "pyprob_tpu_torch/ops/csrc/tile_chol.cu",
        "replaces": "pyprob_tpu/ops/tile_chol.py:127",
        "max_abs_err": err, "tolerance": "1e-3 (1 + |plain|), equal NaN",
        "ms": time_ms(lambda: into(tiles, out_rows), iters=20),
        "plain_ms": time_ms(lambda: plain(tiles), iters=3, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "shape": [B, P, P],
        "entry": "chol_inv_tile_into", "l_row_width": N,
    })
    contiguous = tiles.contiguous()
    emit_shape(
        "chol_inv_tile", lambda: tile_chol.chol_inv_tile(contiguous), lambda: plain(contiguous),
        tile_bytes(B, P), ops, [B, P, P], err, entry="chol_inv_tile",
    )
    del tiles, out_rows, contiguous
    # (256, 256): the one shape the main path launches kernel 5 at
    # (gp_card_vs_cpu's 256 log-lengthscales)
    for b, n in ((2048, 512), (8192, 200), (256, 256)):
        c, d, e = check_quad_logdet(b, n, "cuda")
        emit_shape(
            "mvn_quad_logdet", lambda: mvn_logpdf.mvn_quad_logdet(c, d),
            lambda: mvn_logpdf.mvn_quad_logdet_plain(c, d), quad_logdet_bytes(b, n),
            b * (n**3 // 3 + n * n), [b, n, n], e, launch=quad_logdet_launch(b, n),
        )
        del c, d
    cov1, diff1, err1 = check_quad_logdet(None, 256, "cuda")
    cov, diff, err = check_quad_logdet(8192, 256, "cuda")
    for name, c, d, e, replaces in (
        ("mvn_quad_logdet", cov, diff, err, "pyprob_tpu/ops/mvn_logpdf.py:254"),
        ("mvn_quad_logdet_single", cov1, diff1, err1, "pyprob_tpu/ops/mvn_logpdf.py:303"),
    ):
        b = c.numel() // (c.shape[-1] ** 2)
        n = c.shape[-1]
        bound_ms, bound_by = bound(quad_logdet_bytes(b, n), b * (n**3 // 3 + n * n))
        ms = time_ms(lambda: mvn_logpdf.mvn_quad_logdet(c, d), iters=5, warmup=1)
        plain_ms = time_ms(lambda: mvn_logpdf.mvn_quad_logdet_plain(c, d), iters=5, warmup=1)
        rows.append({
            "name": name, "route": "cuda",
            "source": "pyprob_tpu_torch/ops/csrc/mvn_quad_logdet.cu",
            "replaces": replaces, "max_abs_err": e,
            "tolerance": "0.02 + 1e-4 |plain| per output, equal NaN",
            "ms": ms, "plain_ms": plain_ms, "ratio_to_plain": ms / plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "shape": list(c.shape), "launch": quad_logdet_launch(b, n),
        })
    counts = launch_counts()
    for row in rows:
        emit({
            "phase": "kernel", **row, "bound_us": row["bound_ms"] * 1e3,
            "launches_in_phase": counts[row["name"]],
        })
    del cov, diff
    # the yardstick: the panel factorization (kernel 4 + f32 GEMMs) against
    # the library's batched Cholesky on the same GP covariances
    yard = {}
    for N, B in GP_RUNS:
        K, _ = gp_covariances(N, B, "cuda", seed=1)
        panel = blocked_linalg.panel_cholesky(K)
        library = torch.linalg.cholesky(K)
        yard[f"{B}x{N}x{N}"] = {
            "panel_ms": time_ms(lambda: blocked_linalg.panel_cholesky(K), iters=5, warmup=1),
            "library_ms": time_ms(lambda: torch.linalg.cholesky(K), iters=5, warmup=1),
            "max_abs_diff": float((panel - library).abs().max()),
            "bound_ms": B * N**3 / 3 / F32_RATE * 1e3,
        }
        del K, panel, library
    emit({"phase": "cholesky_yardstick", "batches": yard})
    return rows


class CountCholesky:
    """Counts calls of torch.linalg.cholesky and cholesky_ex while active."""

    def __enter__(self):
        import torch

        self.calls = 0
        self.saved = (torch.linalg.cholesky, torch.linalg.cholesky_ex)

        def counted(fn):
            def wrapper(*args, **kwargs):
                self.calls += 1
                return fn(*args, **kwargs)
            return wrapper

        torch.linalg.cholesky, torch.linalg.cholesky_ex = (counted(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        import torch

        torch.linalg.cholesky, torch.linalg.cholesky_ex = self.saved


def phase_gp_is(device, N, num_traces, warm_up=True):
    """Prior IS of the GP through the user's entry point, against the grid
    truth (numpy float64): mean within 0.25 grid stddevs, ESS fraction in
    its band, N/64 diagonal-tile launches per chunk, no library Cholesky."""
    import torch
    from pyprob_tpu_torch import vectorized

    model, y = gp_model(N)
    grid_mean, grid_std = model.true_posterior_moments(y)
    run = lambda: model.posterior_results(num_traces, observe={"y": y})  # noqa: E731
    if warm_up:
        run()
    reset_launch_counts()
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with CountCholesky() as library:
        t0 = time.perf_counter()
        post = run()
        sync(device)
        seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    chunk = min(num_traces, vectorized._BATCH_LIMIT,
                vectorized._oom_batch_limit.get(id(model), vectorized._BATCH_LIMIT))
    chunks = math.ceil(num_traces / chunk)
    mean = float(np.asarray(post.mean).reshape(-1)[0])
    std = float(np.asarray(post.stddev).reshape(-1)[0])
    ess_fraction = post.effective_sample_size / num_traces
    analytic, low, high = GP_ESS[N]
    check(abs(mean - grid_mean) <= 0.25 * grid_std,
          f"GP IS N={N}: mean {mean} vs grid {grid_mean} +- {grid_std}")
    check(low <= ess_fraction <= high, f"GP IS N={N}: ESS fraction {ess_fraction} not in [{low}, {high}]")
    if device == "cuda":
        panels = math.ceil(N / 64)
        check(launches["chol_inv_tile"] == panels * chunks,
              f"GP IS N={N}: chol_inv_tile launched {launches['chol_inv_tile']} times, "
              f"not {panels} per chunk x {chunks}")
        check(library.calls == 0, f"GP IS N={N}: torch.linalg.cholesky called {library.calls} times")
        check(launches["log_weight_stats"] >= 1, f"GP IS N={N} did not launch log_weight_stats")
    emit({
        "phase": "gp_is", "N": N, "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean, "stddev": std,
        "grid_mean": grid_mean, "grid_stddev": grid_std,
        "mean_error_in_grid_stddevs": (mean - grid_mean) / grid_std,
        "ess_fraction": ess_fraction, "ess_fraction_analytic": analytic,
        "ess_fraction_band": [low, high], "chunk": chunk, "chunks": chunks,
        "library_cholesky_calls": library.calls, "peak_memory_gib": peak_gib,
        "launches": launches,
    })
    return launches


def forced_log_likelihood(model, y, log_lengthscales, device):
    """The observe's log-density per particle at forced log-lengthscales:
    the model's own forward on ``device``."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch import vectorized

    values = torch.tensor(log_lengthscales, dtype=torch.float32, device=device)

    def forced(site, distribution, generator, observed, **kwargs):
        return values, torch.zeros_like(values)

    forced.reset = lambda n: None
    outputs, _ = vectorized.run_traced(
        model, len(values), {"y": y}, pp.TraceMode.POSTERIOR,
        pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
        proposal_step=forced,
    )
    return outputs["log_prob_observed"]


def phase_gp_card_vs_cpu(device, N=256, n=256):
    """The GP log-likelihood at n log-lengthscales in [-2, 2] on the card,
    through the model (panel path, kernel 4) and through mvn_quad_logdet's
    kernel (batched, and unbatched at three of them), against numpy
    float64, within GP_LOGLIK_ATOL."""
    import torch
    from pyprob_tpu_torch.ops import mvn_logpdf

    model, y = gp_model(N)
    lg = np.linspace(-2.0, 2.0, n)
    exact = np.array([model._log_marglik(y, math.exp(g), 1.0, 0.2) for g in lg])
    reset_launch_counts()
    with torch.no_grad():
        ll_model = forced_log_likelihood(model, y, lg, device).double().cpu().numpy()
        cov, diff = gp_covariances(N, n, device, log_lengthscales=lg)
        const = 0.5 * N * math.log(2 * math.pi)
        q, ld = mvn_logpdf.mvn_quad_logdet(cov, diff)
        ll_kernel = (-0.5 * q.double() - ld.double() - const).cpu().numpy()
        picks = (0, n // 2, n - 1)
        ll_single = np.array([
            float(-0.5 * q1.double() - ld1.double() - const)
            for q1, ld1 in (mvn_logpdf.mvn_quad_logdet(cov[i], diff[i]) for i in picks)
        ])
    sync(device)
    launches = launch_counts()
    if device == "cuda":
        check(launches["chol_inv_tile"] == math.ceil(N / 64),
              f"GP card vs CPU: {launches['chol_inv_tile']} tile launches")
        check(launches["mvn_quad_logdet"] == 1 and launches["mvn_quad_logdet_single"] == len(picks),
              f"GP card vs CPU: mvn_quad_logdet launches {launches}")
    errs = {}
    for what, got, want in (
        ("model", ll_model, exact), ("mvn_quad_logdet", ll_kernel, exact),
        ("mvn_quad_logdet_single", ll_single, exact[list(picks)]),
    ):
        err = np.abs(got - want)
        check(np.isfinite(got).all() and err.max() <= GP_LOGLIK_ATOL,
              f"GP card vs CPU: {what} log-likelihood off by {err.max()} at "
              f"log-lengthscale {lg[err.argmax()] if len(err) == n else picks[err.argmax()]}")
        errs[what] = float(err.max())
    emit({
        "phase": "gp_card_vs_cpu", "N": N, "lengthscales": n,
        "max_abs_err": errs, "tolerance": f"atol {GP_LOGLIK_ATOL} vs numpy float64",
        "loglik_range": [float(exact.min()), float(exact.max())], "launches": launches,
    })
    return launches


def host_timed(fn):
    """(fn(), seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def log_sum_exp(lw):
    lw = np.asarray(lw, dtype=np.float64)
    m = lw.max()
    return float(m + np.log(np.exp(lw - m).sum()))


def phase_empirical_surface(device, model, num_traces=EMPIRICAL["traces"]):
    """Empirical's result surface on posteriors the card served (EMPIRICAL):
    GUM guided by ``model`` at 10^6 traces, its statistics held to the
    analytic posterior and timed on the host; BranchingCompiled's mode and
    combine_duplicates at 10^6; 10^4 GUM traces through map, filter, thin
    and reobserve (scored on the host: no kernel launch)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import Branching, BranchingCompiled, GaussianUnknownMean

    spec = EMPIRICAL
    pp.seed(spec["seed"])
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, "empirical_surface")
    n = post.length
    stats, host_s = {}, {}
    for name, fn in (
        ("mean", lambda: post.mean), ("variance", lambda: post.variance), ("skewness", lambda: post.skewness),
        ("kurtosis", lambda: post.kurtosis), ("median", lambda: post.median),
        ("quantiles", lambda: post.quantile([0.025, 0.5, 0.975])), ("hpd_interval", lambda: post.hpd_interval(0.95)),
        ("min", lambda: post.min), ("max", lambda: post.max), ("mode", lambda: post.mode),
        ("combine_duplicates", lambda: post.combine_duplicates().length),
        ("resample", lambda: post.resample(spec["resample"])), ("thin", lambda: post.thin(1000).length),
        ("arg_max", lambda: post.arg_max(float)),
    ):
        stats[name], host_s[name] = host_timed(fn)
    sd = POSTERIOR_STDDEV
    median, q50 = float(stats["median"]), float(stats["quantiles"][1])
    check(abs(median - POSTERIOR_MEAN) <= spec["median_tol"], f"empirical_surface: median {median}")
    check(abs(q50 - POSTERIOR_MEAN) <= spec["median_tol"], f"empirical_surface: quantile(0.5) {q50}")
    check(post.quantile(0.5) == q50, "empirical_surface: quantile(0.5) differs from quantile([..., 0.5, ...])")
    lo, hi = stats["hpd_interval"]
    want = (POSTERIOR_MEAN - spec["z_975"] * sd, POSTERIOR_MEAN + spec["z_975"] * sd)
    check(abs(lo - want[0]) <= spec["hpd_tol"] and abs(hi - want[1]) <= spec["hpd_tol"],
          f"empirical_surface: 95% HPD ({lo}, {hi}) against {want}")
    r = stats.pop("resample")
    r_mean, r_se = float(r.mean), float(post.stddev) / math.sqrt(spec["resample"])
    check(r.length == spec["resample"] and abs(r_mean - float(post.mean)) <= 5 * r_se,
          f"empirical_surface: resample mean {r_mean} against {float(post.mean)} (SE {r_se})")
    # BranchingCompiled: a mode over 17 values, against the enumeration
    truth = Branching().true_posterior(6)
    bpost, b_seconds, b_launches, _ = serve_batched(device, BranchingCompiled(), num_traces, "empirical Branching",
                                                    BRANCHING["observe"], kernels=(), guided=False)
    (b_mode, host_s["branching_mode"]) = host_timed(lambda: bpost.mode)
    combined, host_s["branching_combine_duplicates"] = host_timed(bpost.combine_duplicates)
    total_err = abs(log_sum_exp(combined.log_weights) - log_sum_exp(bpost.log_weights))
    check(float(b_mode) == float(truth.mode), f"empirical_surface: Branching mode {b_mode}, enumerated {truth.mode}")
    check(total_err <= spec["combine_tol"], f"empirical_surface: combine_duplicates moved the total weight {total_err}")
    check(abs(float(combined.mean) - float(bpost.mean)) <= 1e-9, "empirical_surface: combined mean moved")
    # traces: map, filter, thin, reobserve on the host
    gum = GaussianUnknownMean()
    traces, t_seconds = host_timed(lambda: gum.posterior(spec["trace_count"], observe=OBSERVE, vectorized=True))
    mapped, host_s["traces_map"] = host_timed(lambda: traces.map(lambda t: float(t.result)))
    check(mapped.values_numpy().tolist() == [float(t.result) for t in traces.get_values()], "map: values")
    upper, host_s["traces_filter"] = host_timed(lambda: traces.filter(lambda t: float(t.result) > POSTERIOR_MEAN))
    check(all(float(t.result) > POSTERIOR_MEAN for t in upper.get_values()), "filter: a value below the cut")
    thinned = traces.thin(spec["thin"])
    check(thinned.length == spec["thin"], f"thin: {thinned.length} traces")
    reset_launch_counts()
    reobserved, host_s["traces_reobserve"] = host_timed(lambda: traces.reobserve(observe=spec["reobserve"]))
    reobserve_launches = {k: v for k, v in launch_counts().items() if v}
    check(not reobserve_launches, f"reobserve launched kernels: {reobserve_launches}")
    re_mean = float(reobserved.map(lambda t: float(t.result)).mean)
    direct = gum.posterior_results(num_traces, observe=spec["reobserve"], vectorized=True)
    check(abs(re_mean - float(direct.mean)) <= spec["reobserve_tol"],
          f"reobserve: mean {re_mean} against the direct posterior's {float(direct.mean)}")
    emit({
        "phase": "empirical_surface", "traces": n, "serving_seconds": seconds, "ess_fraction": post.effective_sample_size / n,
        "median": median, "quantiles": [float(q) for q in stats["quantiles"]], "hpd_interval": [lo, hi],
        "hpd_truth": list(want), "mean": float(stats["mean"]), "stddev": float(np.sqrt(stats["variance"])),
        "skewness": float(stats["skewness"]), "kurtosis": float(stats["kurtosis"]), "mode": float(stats["mode"]),
        "distinct_values": stats["combine_duplicates"], "resample_mean": r_mean, "resample_se": r_se,
        "branching": {"mode": float(b_mode), "enumerated_mode": float(truth.mode), "distinct_values": combined.length,
                      "total_log_weight_err": total_err, "ess_fraction": bpost.effective_sample_size / bpost.length},
        "traces_run": {"traces": traces.length, "seconds": t_seconds, "filtered": upper.length,
                       "filtered_weight": float(traces.weights[[float(t.result) > POSTERIOR_MEAN
                                                                for t in traces.get_values()]].sum()),
                       "reobserved_mean": re_mean, "direct_mean": float(direct.mean),
                       "analytic_mean": GaussianUnknownMean().true_posterior(list(spec["reobserve"].values()))[0]},
        "host_seconds": host_s, "peak_memory_gib": peak_gib, "launches": launches,
    })
    return launches, b_launches


def builtin_models():
    """name: (model, observe, what to hold it to) for BUILTIN's prior IS."""
    from pyprob_tpu_torch.models import (
        BayesianLinearRegression, BayesianLogisticRegression, EightSchools, GaussianMixture,
        LinearGaussianStateSpace,
    )

    blr = BayesianLinearRegression(np.random.default_rng(0).normal(size=(40, 2)))
    y_blr = blr.synthesize([1.5, -0.7], rng=1)
    logr = BayesianLogisticRegression(np.random.default_rng(4).normal(size=(60, 1)))
    y_logr = logr.synthesize([1.2], rng=2)
    D = BUILTIN["mixture_data"]
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D)
    y_gm = gm.synthesize([-2.0, 2.0], rng=0)
    gm_truth = gm.true_posterior_moments(y_gm)
    lgss = LinearGaussianStateSpace(num_steps=LGSS_IC["num_steps"], a=LGSS_IC["a"])
    ys = lgss.synthesize(rng=0)[1]
    es = EightSchools()
    return {
        "eight_schools": (es, es.observes(), ("bands", BUILTIN["eight_schools_bands"])),
        "linear_regression": (blr, {"y": y_blr}, ("conjugate", blr.true_posterior(y_blr))),
        "logistic_regression": (logr, {"y": y_logr}, ("grid", logr.true_posterior_moments(y_logr))),
        "gaussian_mixture": (gm, {"y": y_gm}, ("mixture", gm_truth)),
        "gaussian_mixture_weights": (
            GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D, learn_weights=True), {"y": y_gm},
            ("mixture", gm_truth)),
        "state_space": (lgss, lgss.observes(ys), ("smoother", lgss.kalman_smoother(ys))),
    }


def judge_builtin(name, post, truth):
    """The checks of BUILTIN for one family's posterior: a dict of what was
    measured, each check raising when it fails."""
    kind, ref = truth
    mean, std = np.asarray(post.mean, np.float64), np.asarray(post.stddev, np.float64)
    ess = post.effective_sample_size
    out = {"mean": mean.tolist(), "stddev": std.tolist()}
    if kind == "bands":
        (mu_lo, mu_hi), (tau_lo, tau_hi) = ref
        check(mu_lo < mean[0] < mu_hi and tau_lo < mean[1] < tau_hi, f"{name}: mean {mean}")
        out["bands"] = ref
    elif kind == "conjugate":
        t_mean, cov = ref
        err = float(np.abs(mean - t_mean).max())
        check(err < BUILTIN["linear_tol"], f"{name}: mean {mean} against {t_mean}")
        out.update(truth=t_mean.tolist(), max_err=err, five_se=(5 * np.sqrt(np.diag(cov) / ess)).tolist())
    elif kind == "grid":
        t_mean, t_std = ref
        tol = BUILTIN["logistic_tol"] * t_std
        check(bool((np.abs(mean - t_mean) < tol).all() and (np.abs(std - t_std) < tol).all()),
              f"{name}: mean {mean}, stddev {std} against {t_mean}, {t_std}")
        out.update(truth=[t_mean.tolist(), t_std.tolist()], tolerance=tol.tolist(),
                   five_se=(5 * t_std / math.sqrt(ess)).tolist())
    elif kind == "mixture":
        _, t_std = ref
        share = float(post.weights[post.values_numpy()[:, 0] < 0].sum())
        std_err = abs(std[0] - t_std[0])
        check(std_err < BUILTIN["mixture_std_tol"] * t_std[0], f"{name}: mu0 stddev {std[0]} against {t_std[0]}")
        check(abs(share - 0.5) <= BUILTIN["mixture_share_tol"], f"{name}: share with mu0 < 0 {share}")
        out.update(grid_stddev=t_std.tolist(), mu0_share_below_0=share,
                   share_five_se=5 * math.sqrt(share * (1 - share) / ess))
    else:
        sm, sv = ref
        tol = np.maximum(BUILTIN["state_space_tol"], 5 * np.sqrt(sv / ess))
        err = np.abs(mean - sm)
        check(mean.shape == sm.shape and bool((err <= tol).all()), f"{name}: mean path off by {err} (limits {tol})")
        out.update(smoother=sm.tolist(), max_err=float(err.max()), tolerance=tol.tolist())
    return out


def phase_builtin_models_is(device, num_traces=NUM_TRACES):
    """Prior IS of the five built-in families (BUILTIN) at ``num_traces`` on
    the batched tier: each held to its JAX test's limits, with its traces/s,
    ESS fraction and peak memory (< 10 GiB); GaussianMixture's observe runs
    kernel 1 once a chunk, on the chunk's particles times its 40 data.
    Returns the launches by model."""
    import pyprob_tpu_torch as pp

    pp.seed(BUILTIN["seed"])
    launches, lines = {}, {}
    for name, (model, observe, truth) in builtin_models().items():
        mixture = name.startswith("gaussian_mixture")
        post, seconds, counts, peak_gib = serve_batched(
            device, model, num_traces, name, observe, kernels=("mixture_normal_log_prob",) if mixture else (),
            guided=False)
        if mixture and device == "cuda":
            rows = counts["mixture_normal_log_prob_by_rows"]
            chunks = -(-num_traces // (1 << 18))
            check(counts["mixture_normal_log_prob"] == chunks and sum(r * c for r, c in rows.items())
                  == num_traces * BUILTIN["mixture_data"], f"{name}: kernel 1's rows {rows}")
        launches[f"builtin_{name}"] = counts
        lines[name] = {"traces_per_s": num_traces / seconds, "seconds": seconds,
                       "ess_fraction": post.effective_sample_size / post.length, "peak_memory_gib": peak_gib,
                       **judge_builtin(name, post, truth), "launches": counts}
    emit({"phase": "builtin_models_is", "traces": num_traces, "models": lines})
    return launches


def gmm_inputs(particles, data, components, per_particle, device, seed=0):
    """Kernel 1's inputs as GaussianMixture's observe gives them: a particle's
    means and (shared or per-particle) logits repeated over its data, the
    data repeated over the particles, stddev 0.6."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    mus = 3.0 * torch.randn((particles, components), generator=g, device=device)
    if per_particle:
        w = torch._standard_gamma(torch.full((particles, components), 2.0, device=device), generator=g)
        logits = torch.log(w / w.sum(-1, keepdim=True))
    else:
        logits = torch.full((particles, components), -math.log(components), device=device)
    y = 2.5 * torch.randn((data,), generator=g, device=device)
    rows = particles * data
    return [
        y.repeat(particles).contiguous(),
        mus.unsqueeze(1).expand(particles, data, components).reshape(rows, components).contiguous(),
        torch.full((rows, components), 0.6, device=device),
        logits.unsqueeze(1).expand(particles, data, components).reshape(rows, components).contiguous(),
    ]


def phase_gmm_kernel_shapes(floor_ms):
    """Kernel 1 at GaussianMixture's observe shape (GMM_ROWS rows, K = 2),
    shared and per-particle logits: against its plain version within
    1e-5 (1 + |ref|) (a prior draw's log-density reaches a few hundred,
    where a float32 ulp is 3e-5), timed beside its bound and the launch
    floor."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    particles, data = GMM_ROWS // BUILTIN["mixture_data"], BUILTIN["mixture_data"]
    for per_particle in (False, True):
        inputs = gmm_inputs(particles, data, GMM_COMPONENTS, per_particle, "cuda", seed=int(per_particle))
        out, ref = K.mixture_normal_log_prob(*inputs), K.mixture_normal_log_prob_plain(*inputs)
        check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(ref).all()), "gmm shape: non-finite output")
        err = float((out - ref).abs().max())
        excess = float(((out - ref).abs() - 1e-5 * (1 + ref.abs())).max())
        check(excess <= 0, f"kernel 1 at the GaussianMixture shape: max abs err {err}, over 1e-5 (1 + |ref|) by {excess}")
        emit_shape("mixture_normal_log_prob", lambda: K.mixture_normal_log_prob(*inputs),
                   lambda: K.mixture_normal_log_prob_plain(*inputs), *mixture_cost(GMM_ROWS, GMM_COMPONENTS),
                   [GMM_ROWS, GMM_COMPONENTS], err, iters=20, path="GaussianMixture observe",
                   logits="per particle" if per_particle else "shared", launch_floor_ms=floor_ms)
        del inputs, out, ref


def phase_lgss_ic(device, num_traces=NUM_TRACES):
    """IC on LinearGaussianStateSpace with the feedforward network
    (LGSS_IC): trained, then served at ``num_traces`` beside prior IS at
    ``num_traces``; the mean path against the RTS smoother and the ESS
    fraction against prior IS's, each enforced only where
    LGSS_IC_CPU_MET says the port met it on all eight CPU seeds.  Returns
    the launches of training and serving."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import LinearGaussianStateSpace

    spec = LGSS_IC
    model = LinearGaussianStateSpace(num_steps=spec["num_steps"], a=spec["a"])
    ys = model.synthesize(rng=0)[1]
    observe = model.observes(ys)
    sm, sv = model.kalman_smoother(ys)
    pp.seed(spec["seed"])
    kwargs = dict(num_traces=spec["train_traces"], inference_network=pp.InferenceNetwork.FEEDFORWARD,
                  observe_embeddings={k: {"dim": spec["observe_dim"]} for k in observe},
                  batch_size=spec["batch_size"], learning_rate_init=spec["learning_rate"])
    train_launches, train_line = train_phase(device, "lgss_ic_feedforward_train", model, kwargs)
    heads = model._inference_network._head_meta
    check(len(heads) == spec["num_steps"] + 1 and all(m["kind"] == "normal_mixture" for m in heads.values()),
          f"lgss_ic_feedforward: heads {heads}")
    if device == "cuda":
        for name in KERNEL_NAMES[:2]:
            check(train_launches[name] >= 1, f"lgss_ic_feedforward training did not launch {name}")
    post, seconds, launches, peak_gib = serve_batched(device, model, num_traces, "lgss_ic_feedforward", observe)
    prior, prior_seconds, _, _ = serve_batched(device, model, num_traces, "lgss_ic_feedforward prior IS", observe,
                                               kernels=(), guided=False)
    mean = np.asarray(post.mean, np.float64)
    ess, prior_ess = post.effective_sample_size / num_traces, prior.effective_sample_size / num_traces
    tol = np.maximum(spec["tol"], 5 * np.sqrt(sv / post.effective_sample_size))
    met = {"mean_path": bool((np.abs(mean - sm) <= tol).all()), "ess_over_prior": ess > prior_ess}
    enforced = {k: LGSS_IC_CPU_MET[k][1] == 8 for k in met}
    emit({
        "phase": "lgss_ic_feedforward", "train": train_line, "traces": num_traces, "seconds": seconds,
        "traces_per_s": num_traces / seconds, "mean": mean.tolist(), "smoother": sm.tolist(),
        "max_err": float(np.abs(mean - sm).max()), "tolerance": tol.tolist(), "ess_fraction": ess,
        "prior_is_ess_fraction": prior_ess, "prior_is_traces_per_s": num_traces / prior_seconds,
        "prior_is_max_err": float(np.abs(np.asarray(prior.mean, np.float64) - sm).max()),
        "criteria_met": met, "enforced": enforced, "cpu_seeds_met_of_8_jax_port": LGSS_IC_CPU_MET,
        "peak_memory_gib": peak_gib, "launches": launches,
    })
    for k, ok in met.items():
        check(ok or not enforced[k], f"lgss_ic_feedforward: {k} missed")
    return train_launches, launches


def phase_larc_card_vs_cpu(devices=("cuda", "cpu")):
    """One ADAM_LARC and one SGD_LARC step of a GUM LSTM network (lstm128,
    16-d observe embeddings), from the same weights and packed batch of 256,
    on the card and on the CPU: the LARC-scaled gradient of every leaf and
    every parameter after the step within 1e-4 + 1e-3 |cpu|.  Adam's first
    step moves a parameter by about lr whatever the size of its gradient,
    so an entry whose gradient is at round-off on the CPU (below 1e-6 of its
    leaf's largest) may land apart; those are counted and printed, not
    held."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch import vectorized

    model = guided_model(128)
    net = model._inference_network
    outputs, sites = vectorized.run_training_batch(model, 256)
    batch = net._packed_batch_from_outputs(outputs, sites, 256)
    snapshot = net.snapshot_params()
    out = {}
    try:
        for opt in (pp.Optimizer.ADAM_LARC, pp.Optimizer.SGD_LARC):
            out[opt.name] = larc_step_card_vs_cpu(net, batch, snapshot, opt, devices)
    finally:
        pp.set_device(devices[0])
    emit({"phase": "larc_card_vs_cpu", **out, "tolerance": "atol 1e-4 + rtol 1e-3 per leaf"})


def larc_step_card_vs_cpu(net, batch, snapshot, opt, devices):
    """One step of ``opt`` from ``snapshot`` on ``batch`` on each device:
    the LARC-scaled gradients (read before the base optimizer's step, which
    may reuse them) and the parameters after it, held as
    phase_larc_card_vs_cpu says."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.nn import LARC, PackedBatch
    from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves

    results = []
    for device in devices:
        pp.set_device(device)
        net._optimizer = None
        net.to(device)
        net.restore_params(snapshot)
        net._optimizer_type, net._weight_decay, net._momentum = opt, 1e-5, 0.9
        net._learning_rate_init = net._learning_rate_end = 0.01
        net._learning_rate_scheduler_type = pp.LearningRateScheduler.NONE
        net._create_optimizer()
        check(isinstance(net._optimizer, LARC), f"larc_card_vs_cpu: {opt.name} built {net._optimizer!r}")
        on = PackedBatch(map_tensors(batch.packed, lambda t: t.to(device)), batch.size, batch.addrs,
                         batch.dist_names)
        reset_launch_counts()
        loss = float(net._loss_and_grad(on))
        for group in net._optimizer.param_groups:
            group["lr"] = net._current_learning_rate()
        net._optimizer.scale_gradients()
        leaves = tensor_leaves(net._params)
        scaled = [p.grad.cpu().numpy() for p in leaves]
        net._optimizer.optim.step()
        if device == "cuda":
            check(launch_counts()[KERNEL_NAMES[1]] >= 1, "larc_card_vs_cpu: kernel 1b did not launch")
        results.append((loss, scaled, [p.detach().cpu().numpy() for p in leaves]))
    (loss_a, g_a, p_a), (loss_b, g_b, p_b) = results
    check(abs(loss_a - loss_b) <= 1e-4 + 1e-3 * abs(loss_b), f"larc_card_vs_cpu {opt.name}: loss {loss_a} vs {loss_b}")
    worst_g = max(float((np.abs(a - b) - (1e-4 + 1e-3 * np.abs(b))).max()) for a, b in zip(g_a, g_b))
    check(worst_g <= 0, f"larc_card_vs_cpu {opt.name}: a scaled gradient exceeds 1e-4 + 1e-3|cpu| by {worst_g}")
    worst_p, round_off = 0.0, 0
    for a, b, g in zip(p_a, p_b, g_b):
        over = np.abs(a - b) > 1e-4 + 1e-3 * np.abs(b)
        tiny = np.abs(g) < 1e-6 * max(float(np.abs(g).max()), 1e-30)
        if opt == pp.Optimizer.ADAM_LARC:
            round_off += int((over & tiny).sum())
            over &= ~tiny
        worst_p = max(worst_p, float(over.sum()))
    check(worst_p == 0, f"larc_card_vs_cpu {opt.name}: {worst_p} parameters past 1e-4 + 1e-3|cpu| after the step")
    return {"loss": [loss_a, loss_b], "leaves": len(g_a),
            "max_abs_err_scaled_grad": max(float(np.abs(a - b).max()) for a, b in zip(g_a, g_b)),
            "max_abs_err_params": max(float(np.abs(a - b).max()) for a, b in zip(p_a, p_b)),
            "round_off_gradient_entries_apart": round_off}


def phase_larc_train(device):
    """tests/test_train.py:90-107's recipe at the bench's lstm128 width:
    ADAM_LARC with POLY2 from 0.1 to 0.0025 over 2,048 traces at batch 256;
    the learning rate ends within 1e-4 of 0.0025."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    spec = LARC_TRAIN
    pp.seed(spec["seed"])
    model = GaussianUnknownMean()
    kwargs = dict(num_traces=spec["train_traces"], num_traces_end=spec["train_traces"],
                  observe_embeddings={"obs0": {"dim": 16}, "obs1": {"dim": 16}},
                  inference_network=pp.InferenceNetwork.LSTM, lstm_dim=spec["lstm_dim"],
                  batch_size=spec["batch_size"], optimizer_type=pp.Optimizer.ADAM_LARC,
                  learning_rate_init=spec["learning_rate"][0], learning_rate_end=spec["learning_rate"][1],
                  learning_rate_scheduler_type=pp.LearningRateScheduler.POLY2,
                  proposal_mixture_components=MIXTURE_COMPONENTS)
    launches, line = train_phase(device, "larc_train", model, kwargs)
    lr = model._inference_network.learning_rate
    check(abs(lr - spec["learning_rate"][1]) <= spec["lr_tol"], f"larc_train: final learning rate {lr}")
    emit({**line, "optimizer": "ADAM_LARC", "final_learning_rate": lr, "lstm_dim": spec["lstm_dim"]})
    return launches


def pinned_cnn(params, x, ndim, branch=None):
    """The 5-convolution CNN's forward with ``nn.layers._cnn_apply``'s
    arithmetic, each ReLU taken as a multiplication by its mask and each
    max-pool as a gather at its argmax, so that ``branch`` (the masks and
    pool indices another device's run chose) can pin them: a pre-activation
    within round-off of 0, or two near-equal maxima of a pool window, may
    fall on different sides on two devices, and a gradient then differs by
    a whole term.  Returns (output, the branch taken)."""
    import torch.nn.functional as F
    from pyprob_tpu_torch.nn import layers as L

    taken = {"masks": [], "indices": []}
    pool_fn = F.max_pool2d if ndim == 2 else F.max_pool3d

    def relu(v):
        m = (v > 0) if branch is None else branch["masks"][len(taken["masks"])].to(v.device)
        taken["masks"].append(m)
        return v * m

    def pool(v):
        idx = pool_fn(v.detach(), 2, return_indices=True)[1]
        if branch is not None:
            idx = branch["indices"][len(taken["indices"])].to(v.device)
        taken["indices"].append(idx)
        return v.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

    meta, B = params["meta"], x.shape[0]
    convs = params["convs"]
    h = x.reshape((B,) + tuple(meta["input_shape"]))
    h = pool(relu(L.conv_apply(convs[1], relu(L.conv_apply(convs[0], h, ndim)), ndim)))
    for c in convs[2:]:
        h = relu(L.conv_apply(c, h, ndim))
    h = pool(h).reshape(B, -1)
    h = relu(L.linear_apply(params["lin2"], relu(L.linear_apply(params["lin1"], h))))
    return h.reshape((B,) + tuple(meta["out_shape"])), taken


def phase_cnn_card_vs_cpu(devices=("cuda", "cpu")):
    """CNN2D5C and CNN3D5C (CNN_CHECK) from the same weights, inputs and
    output cotangent on the card and on the CPU.  On the card the port's
    apply gives weight gradients equal to the bit over two backward passes
    (cuDNN set deterministic: one seed must reproduce training) and is
    timed; ``pinned_cnn`` on the card equals it to the bit; on the CPU it
    runs on the card's ReLU masks and pool argmaxes, and the forward, the
    input's gradient and every weight's are held within 1e-4 + 1e-3 |cpu|.
    The masks and argmaxes the CPU picks itself that differ from the
    card's are counted, and the error without pinning printed."""
    import torch
    from pyprob_tpu_torch.nn import layers as L
    from pyprob_tpu_torch.nn.layers import map_tensors, tensor_leaves

    out = {}
    for kind, (shape, out_dim) in CNN_CHECK.items():
        ndim = len(shape) - 2
        apply = L.cnn2d5c_apply if ndim == 2 else L.cnn3d5c_apply
        weights = (L.cnn2d5c_init if ndim == 2 else L.cnn3d5c_init)(
            torch.Generator().manual_seed(0), shape[1:], out_dim, "cpu")
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(size=(shape[0], int(np.prod(shape[1:])))).astype(np.float32))
        ct = torch.from_numpy(rng.normal(size=(shape[0], out_dim)).astype(np.float32))

        def run(device, fn):
            """fn(params, x) -> (y, extra): y and every gradient, as CPU numpy, and extra."""
            # fresh leaves each run (``.to`` on the CPU would hand back the
            # same tensor, and a second backward would add into its grad)
            params = map_tensors(weights, lambda t: t.detach().clone().to(device).requires_grad_(True))
            xd = x.detach().clone().to(device).requires_grad_(True)
            y, extra = fn(params, xd)
            y.backward(ct.to(device))
            grads = [xd.grad] + [p.grad for p in tensor_leaves(params)]
            return [y.detach()] + grads, extra, params, xd

        card, cpu = devices
        port, _, params, xd = run(card, lambda p, v: (apply(p, v), None))
        ms = deterministic = None
        if card == "cuda":
            again, _, _, _ = run(card, lambda p, v: (apply(p, v), None))
            deterministic = all(torch.equal(a, b) for a, b in zip(port[2:], again[2:]))
            check(deterministic, f"cnn_card_vs_cpu {kind}: two backward passes differ on the card")

            def step():
                for t in tensor_leaves(params) + [xd]:
                    t.grad = None
                apply(params, xd).backward(ct.to(card))

            ms = time_ms(step, iters=20, warmup=3)
        pinned, branch, _, _ = run(card, lambda p, v: pinned_cnn(p, v, ndim))
        check(all(torch.equal(a, b) for a, b in zip(port, pinned)),
              f"cnn_card_vs_cpu {kind}: pinned_cnn differs from the port's apply on {card}")
        on_branch, _, _, _ = run(cpu, lambda p, v: pinned_cnn(p, v, ndim, branch))
        own, own_branch, _, _ = run(cpu, lambda p, v: pinned_cnn(p, v, ndim))
        flips = {k: int(sum(int((a.cpu() != b).sum()) for a, b in zip(branch[k], own_branch[k])))
                 for k in ("masks", "indices")}
        worst, err, err_own = 0.0, 0.0, 0.0
        for a, b, c in zip(port, on_branch, own):
            a, b, c = a.cpu().numpy(), b.numpy(), c.numpy()
            err = max(err, float(np.abs(a - b).max()))
            err_own = max(err_own, float(np.abs(a - c).max()))
            worst = max(worst, float((np.abs(a - b) - (1e-4 + 1e-3 * np.abs(b))).max()))
        check(worst <= 0, f"cnn_card_vs_cpu {kind}: exceeds 1e-4 + 1e-3|cpu| by {worst}")
        out[kind] = {"shape": list(shape), "out_dim": out_dim, "max_abs_err": err,
                     "cpu_own_branch": {"flips": flips, "max_abs_err": err_own},
                     "forward_backward_ms": ms, "weight_grads_bit_reproducible": deterministic}
    emit({"phase": "cnn_card_vs_cpu", **out, "cudnn_deterministic": torch.backends.cudnn.deterministic,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "tolerance": "atol 1e-4 + rtol 1e-3: forward, input and weight gradients, on the card's branch"})


def captcha_train_kwargs(network):
    import pyprob_tpu_torch as pp

    c = CAPTCHA
    return dict(num_traces=c["train_traces"],
                observe_embeddings={"query_image": {"dim": c["dim"], "reshape": [1, 28, 28],
                                                    "embedding": pp.ObserveEmbedding.CNN2D5C}},
                inference_network=getattr(pp.InferenceNetwork, network), batch_size=c["batch_size"],
                learning_rate_init=c["learning_rate"], lstm_dim=c["lstm_dim"])


def phase_mini_captcha_ic(device, network, seeds=CAPTCHA["seeds"]):
    """MiniCaptcha IC (tests/test_inference.py:591-655) trained from seeds
    0..seeds-1: the MAP accuracy by post.mode over the six letters at 512
    traces each, above 0.8 for as many seeds as the JAX package's eight CPU
    seeds less four, and one at least (CAPTCHA_CPU_MET).  The first seed's
    network is also served at 10^6 traces a letter (a warm-up run, then
    the six timed): traces/s, peak memory < 10 GiB, every mode correct;
    and prior IS at 10^6 a letter (the [N, 784] observe), its modes.
    Returns the launches by sub-phase."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import MiniCaptcha

    c = CAPTCHA
    phase = f"mini_captcha_ic_{network.lower()}"
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    launches, by_seed = {}, []
    for seed in range(seeds):
        key = phase if seed == 0 else f"{phase}_seed{seed}"
        pp.seed(seed)
        model = MiniCaptcha()
        launches[key + "_train"], train_line = train_phase(device, key + "_train", model,
                                                           captcha_train_kwargs(network))
        check(model._inference_network._params["observe"]["query_image"]["kind"] == "cnn2d5c",
              f"{phase}: the observe embedding is not the CNN")

        def serve(n, guided=True):
            return [int(np.asarray(model.posterior_results(
                n, observe={"query_image": model.render(a)}, vectorized=True,
                inference_engine=engine if guided else pp.InferenceEngine.IMPORTANCE_SAMPLING).mode))
                for a in model.alphabet]

        modes, launches[key + "_serve"] = counted(device, lambda: serve(c["traces"]))
        accuracy = float(np.mean([m == i for i, m in enumerate(modes)]))
        by_seed.append({"seed": seed, "accuracy": accuracy, "met": accuracy > c["accuracy"], "modes": modes,
                        "final_loss": train_line["final_loss"], "train_traces_per_s": train_line["traces_per_s"]})
        if seed:
            continue
        model.posterior_results(c["big_traces"], observe={"query_image": model.render("A")}, vectorized=True,
                                inference_engine=engine)  # warm-up
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        (big_modes, seconds), launches[key] = counted(device, lambda: host_timed(lambda: serve(c["big_traces"])))
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
        check(peak_gib is None or peak_gib < 10.0, f"{phase}: peak memory {peak_gib} GiB")
        check(big_modes == list(range(len(model.alphabet))), f"{phase}: modes at 10^6 {big_modes}")
        (prior_modes, prior_seconds), launches[key + "_prior_is"] = counted(
            device, lambda: host_timed(lambda: serve(c["big_traces"], guided=False)))
        check(prior_modes == list(range(len(model.alphabet))), f"{phase}: prior IS modes at 10^6 {prior_modes}")
        first = {"train": train_line, "traces": c["big_traces"], "letters": len(model.alphabet),
                 "traces_per_s": c["big_traces"] * len(model.alphabet) / seconds, "modes": big_modes,
                 "peak_memory_gib": peak_gib, "prior_is_modes": prior_modes,
                 "prior_is_traces_per_s": c["big_traces"] * len(model.alphabet) / prior_seconds,
                 "launches": launches[key]}
    met = sum(line["met"] for line in by_seed)
    needed = max(1, CAPTCHA_CPU_MET[phase][0] - 4)
    emit({"phase": phase, "network": network, **first, "criteria": {
        "traces": c["traces"], "accuracy_above": c["accuracy"], "seeds_met": met, "seeds_needed": needed,
        "cpu_seeds_met_of_8_jax_port": CAPTCHA_CPU_MET[phase], "by_seed": by_seed}})
    check(met >= needed, f"{phase}: accuracy met by {met} of {seeds} seeds, {needed} needed")
    return launches


def dir_bytes(d):
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def phase_offline(device, tmp):
    """GUM's training traces saved in files (OFFLINE: 51,200 in files of
    12,800, and 2,560 for validation), then the feedforward recipe
    (ff_train_kwargs) and the lstm128 arm's trained from them with the
    validation loss every 12,800 traces, each served at 10^6: mean and
    stddev within 0.5, ESS at least 0.15 (FF) and 0.5 (LSTM), beside the
    online arms' (ONLINE_ESS).  Returns the launches by sub-phase and the
    two directories."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    o = OFFLINE
    train_dir, valid_dir = os.path.join(tmp, "gum_train"), os.path.join(tmp, "gum_valid")
    pp.seed(81)
    model = GaussianUnknownMean()
    _, seconds = host_timed(lambda: model.save_dataset(train_dir, o["traces"], o["per_file"]))
    model.save_dataset(valid_dir, o["valid_traces"], o["valid_traces"])
    files = sorted(f for f in os.listdir(train_dir) if f.startswith("pyprob_traces"))
    check(len(files) == o["traces"] // o["per_file"], f"save_dataset: files {files}")
    emit({"phase": "save_dataset", "traces": o["traces"], "traces_per_file": o["per_file"], "files": len(files),
          "seconds": seconds, "traces_per_s": o["traces"] / seconds, "bytes": dir_bytes(train_dir),
          "bytes_per_trace": dir_bytes(train_dir) / o["traces"]})
    path = {}
    for label, kw, floor in (("feedforward", ff_train_kwargs(), o["ff_ess_floor"]),
                             ("lstm", train_kwargs(ARMS[0], TRAIN_SEGMENTS), o["lstm_ess_floor"])):
        pp.seed(82)
        m = GaussianUnknownMean()
        kwargs = dict(kw, num_traces=o["traces"], dataset_dir=train_dir, dataset_valid_dir=valid_dir,
                      valid_every=o["per_file"])
        path[f"offline_train_{label}"], line = train_phase(device, f"offline_train_{label}", m, kwargs)
        net = m._inference_network
        if device == "cuda":
            for name in KERNEL_NAMES[:2]:
                check(path[f"offline_train_{label}"][name] >= net._total_train_iterations,
                      f"offline_train_{label}: {name} launched fewer times than steps")
        post, serve_s, path[f"offline_guided_is_{label}"], peak_gib = serve_batched(
            device, m, NUM_TRACES, f"offline {label} guided IS")
        mean, std = check_posterior(post, f"offline {label} guided IS")
        ess = post.effective_sample_size / NUM_TRACES
        check(ess >= floor, f"offline {label}: ESS fraction {ess} < {floor}")
        emit({"phase": f"offline_train_{label}", "train": line, "epochs": net._total_train_traces / o["traces"],
              "valid_loss": net._history_valid_loss, "valid_loss_traces": net._history_valid_loss_trace,
              "traces": NUM_TRACES, "seconds": serve_s, "traces_per_s": NUM_TRACES / serve_s, "mean": mean,
              "stddev": std, "ess_fraction": ess, "ess_floor": floor, "online_ess_fraction": ONLINE_ESS.get(label),
              "peak_memory_gib": peak_gib})
    return path, (train_dir, valid_dir)


def phase_offline_gather_train(device, tmp):
    """OFFLINE["gather_traces"] while-loop Marsaglia traces saved from the
    interpreter tier (seed 123), then bench.py's Marsaglia LSTM recipe
    trained from them: the stored batches' several trace types take the
    gather-table loss, one launch each of kernels 2 and 2b a step."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia

    n = OFFLINE["gather_traces"]
    d = os.path.join(tmp, "marsaglia_train")
    pp.seed(INTERPRETER["seed"])
    _, save_s = host_timed(lambda: GaussianUnknownMeanMarsaglia().save_dataset(d, n, n))
    model = GaussianUnknownMeanMarsaglia()
    launches, line = train_phase(device, "offline_gather_train", model,
                                 dict(marsaglia_train_kwargs(), num_traces=n, dataset_dir=d))
    net = model._inference_network
    steps = net._total_train_iterations
    check(net._gather_used, "offline_gather_train: the gather-table loss was not used")
    if device == "cuda":
        for name in TNORM_KERNELS:
            check(launches[name] == steps, f"offline_gather_train: {name} launched {launches[name]} times in {steps} steps")
    emit({**line, "save_seconds": save_s, "saved_traces": n, "bytes": dir_bytes(d),
          "trace_types": max(int(a.rpartition("__")[2]) for a in net._params["proposal"]),
          "kernel2_launches_per_step": launches[TNORM_KERNELS[0]] / steps,
          "kernel2b_launches_per_step": launches[TNORM_KERNELS[1]] / steps})
    return launches


def check_keep_best(device, model, label):
    """The restored network equals the best probe's snapshot to the bit (its
    EMA too); a 10^6 serving from it equals, to the bit, one from a copy of
    the network loaded from a file and restored from that snapshot."""
    import tempfile
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean
    from pyprob_tpu_torch.nn.layers import tensor_leaves

    net = model._inference_network
    hist = net._keep_best_history
    best = max(v for _, v in hist)
    check(net._keep_best_metric == best, f"{label}: kept metric {net._keep_best_metric}, best probe {best}")
    snap = net._keep_best_snapshot
    for tree, ref in ((net._params, snap["params"]), (net._ema_params, snap["ema_params"])):
        for t, a in zip(tensor_leaves(tree), tensor_leaves(ref)):
            check(np.array_equal(t.detach().cpu().numpy().view(np.uint32), a.view(np.uint32)),
                  f"{label}: the restored network differs from the best snapshot")
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    twin = GaussianUnknownMean()
    with tempfile.TemporaryDirectory() as d:
        model.save_inference_network(os.path.join(d, "net"))
        twin.load_inference_network(os.path.join(d, "net"))
    twin._inference_network.restore_params(snap)
    served = []
    for m in (model, twin):
        pp.seed(KEEP_BEST["serve_seed"])
        post = m.posterior_results(NUM_TRACES, observe=OBSERVE, vectorized=True, inference_engine=engine)
        served.append((float(post.mean), post.effective_sample_size / NUM_TRACES))
    check(served[0] == served[1], f"{label}: served {served[0]} vs the snapshot's {served[1]}")
    return {"history": hist, "best": best, "best_at_traces": hist[[v for _, v in hist].index(best)][0],
            "served_mean_ess_fraction": served[0]}


def phase_keep_best(device, dirs):
    """keep_best on GUM's feedforward recipe with an EMA of 0.9, probing
    every 12,800 of 51,200 traces and at the end: by the guided-IS ESS
    probe (online, keep_best_observe, 100,000 traces a probe) and by the
    negative validation loss (offline, phase offline's directories).  Each
    held by check_keep_best.  Returns the launches by sub-phase."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    k = KEEP_BEST
    common = dict(ff_train_kwargs(), num_traces=k["train_traces"], ema_decay=EMA_DECAY, keep_best=True,
                  keep_best_every=k["every"])
    path, out = {}, {}
    for label, extra in (("ess_probe", dict(keep_best_observe=OBSERVE, keep_best_num_traces=k["probe_traces"])),
                         ("validation", dict(dataset_dir=dirs[0], dataset_valid_dir=dirs[1],
                                             valid_every=k["every"]))):
        pp.seed(83)
        model = GaussianUnknownMean()
        path[f"keep_best_{label}"], line = train_phase(device, f"keep_best_{label}", model, dict(common, **extra))
        probes = len(model._inference_network._keep_best_history)
        check(probes == k["train_traces"] // k["every"] + 1, f"keep_best {label}: {probes} probes")
        out[label] = {"train": line, **check_keep_best(device, model, f"keep_best {label}")}
    emit({"phase": "keep_best", **out})
    return path


def phase_empirical_file(device, tmp, lstm_model):
    """File-backed results: GUM prior IS at 10^6 on the batched tier and the
    lstm128 network served by lockstep at 4,000 traces, each run twice from
    one seed, in memory and into an Empirical file; reopened read-only, the
    values and log weights equal the memory result's to the bit, the mean
    and ESS equal; the two files' concatenation equals the two memory
    results' concatenation.  The host seconds to write and reopen."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Empirical
    from pyprob_tpu_torch.models import GaussianUnknownMean

    e = EMPIRICAL_FILE
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    runs = {
        "batched_prior_is": (lambda **kw: GaussianUnknownMean().posterior_results(
            e["traces"], observe=OBSERVE, vectorized=True, **kw)),
        "lockstep": (lambda **kw: lstm_model.posterior_results(
            e["lockstep_traces"], observe=OBSERVE, vectorized=False, inference_engine=engine, **kw)),
    }
    out, memory, files, path = {}, [], [], {}
    for i, (label, run) in enumerate(runs.items()):
        fn = os.path.join(tmp, f"empirical_{label}")
        pp.seed(e["seed"] + i)
        (mem, mem_s), path[f"empirical_file_{label}"] = counted(device, lambda: host_timed(run))
        pp.seed(e["seed"] + i)
        on_file, file_s = host_timed(lambda: run(file_name=fn))
        _, close_s = host_timed(on_file.close)
        back, open_s = host_timed(lambda: Empirical(file_name=fn, file_read_only=True))
        values, read_s = host_timed(lambda: back._values)
        check(np.array_equal(np.asarray(values), np.asarray(mem._values)), f"empirical_file {label}: values differ")
        check(np.array_equal(back.log_weights, mem.log_weights), f"empirical_file {label}: log weights differ")
        check(np.array_equal(back.mean, mem.mean) and back.effective_sample_size == mem.effective_sample_size,
              f"empirical_file {label}: mean or ESS differ")
        out[label] = {"traces": len(mem), "seconds_in_memory": mem_s, "seconds_to_file": file_s,
                      "close_seconds": close_s, "reopen_seconds": open_s, "read_values_seconds": read_s,
                      "bytes": os.path.getsize(fn), "mean": float(mem.mean),
                      "ess_fraction": mem.effective_sample_size / len(mem)}
        memory.append(mem)
        files.append(fn)
    joined, join_s = host_timed(lambda: Empirical(concat_empirical_file_names=files))
    in_memory = Empirical(concat_empiricals=memory)
    check(np.array_equal(np.asarray(joined._values), np.asarray(in_memory._values))
          and np.array_equal(joined.log_weights, in_memory.log_weights)
          and np.array_equal(joined.mean, in_memory.mean)
          and joined.effective_sample_size == in_memory.effective_sample_size,
          "empirical_file: the files' concatenation differs from the memory results'")
    joined.close()
    emit({"phase": "empirical_file", **out, "concat_traces": len(joined), "concat_open_seconds": join_s,
          "concat_ess_fraction": in_memory.effective_sample_size / len(in_memory)})
    return path


def kl_normal(m, s, m0, s0):
    """KL(N(m, s) || N(m0, s0)), as tests/test_inference.py:71-73 computes it."""
    return math.log(s0 / s) + (s * s + (m - m0) ** 2) / (2 * s0 * s0) - 0.5


def check_gum_chain(post, label, burn_in=0):
    """_check_gum (tests/test_inference.py:67-81, without its ESS floor):
    mean within 0.75 of 7.25, stddev within 0.75 of sqrt(1/1.2), KL < 0.25."""
    if burn_in:
        post = post[burn_in:]
    mean, std = float(post.mean), float(post.stddev)
    kl = kl_normal(mean, max(std, 1e-3), 7.25, math.sqrt(1 / 1.2))
    check(abs(mean - 7.25) < 0.75 and abs(std - math.sqrt(1 / 1.2)) < 0.75 and kl < 0.25,
          f"{label}: mean {mean}, stddev {std}, KL {kl}")
    return {"mean": mean, "stddev": std, "kl": kl}


def chain_line(post, seconds):
    """A batched chain run's figures from its metadata: chains, steps,
    acceptance and reuse rates, steps/s and transitions/s on the host clock
    of the step loop and of the whole call."""
    meta = post.metadata[-1]
    check("compiled" in post.name, f"not the batched chains: {post.name}")
    C, S = meta["num_chains"], meta["num_steps"]
    return {"chains": C, "steps": S, "burn_in": meta["burn_in"], "kept": post.length,
            "acceptance_rate": meta["acceptance_rate"], "reuse_rate": meta["reuse_rate"],
            "warm_start_ess": meta["warm_start_ess"], "step_loop_seconds": meta["step_seconds"],
            "steps_per_s": S / meta["step_seconds"], "transitions_per_s": C * S / meta["step_seconds"],
            "seconds": seconds, "transitions_per_s_whole_call": C * S / seconds}


def interpreter_line(post, steps):
    meta = post.metadata[-1]
    return {"steps": steps, "seconds": meta["seconds"], "steps_per_s": steps / meta["seconds"],
            "acceptance_rate": meta["num_traces_accepted"] / steps,
            "reuse_rate": meta["num_samples_reused"] / max(1, meta["num_samples"])}


def mcmc_engines():
    import pyprob_tpu_torch as pp

    return {"lmh": pp.InferenceEngine.LIGHTWEIGHT_METROPOLIS_HASTINGS,
            "rmh": pp.InferenceEngine.RANDOM_WALK_METROPOLIS_HASTINGS}


def phase_mcmc_gum(device):
    """GUM under LMH and RMH: batched chains at MCMC["transitions"] (1,024
    chains by the defaults) and the interpreter chain at the JAX test's
    7,000 steps (tests/test_inference.py:135-157), each held to _check_gum
    (the interpreter's after its burn-in).  Returns the launches by run."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    m = MCMC
    pp.seed(m["seed"])
    model = GaussianUnknownMean()
    launches, out = {}, {}
    for name, engine in mcmc_engines().items():
        (post, seconds), launches[f"mcmc_gum_{name}"] = counted(device, lambda: host_timed(
            lambda: model.posterior_results(m["transitions"], inference_engine=engine, observe=OBSERVE)))
        line = {**chain_line(post, seconds), **check_gum_chain(post, f"mcmc_gum {name} batched")}
        check(line["chains"] == min(max(1, m["transitions"] // 256), 1024),
              f"mcmc_gum {name}: {line['chains']} chains, not the default")
        interp = model.posterior_results(m["interpreter_steps"], inference_engine=engine, observe=OBSERVE,
                                         vectorized=False)
        out[name] = {"batched": line, "interpreter": {
            **interpreter_line(interp, m["interpreter_steps"]),
            **check_gum_chain(interp, f"mcmc_gum {name} interpreter", burn_in=m["interpreter_burn_in"][name])}}
    emit({"phase": "mcmc_gum", "transitions": m["transitions"], **out, "launches": launches})
    return launches


def phase_mcmc_resume(device, tmp):
    """ChainState: a save/load round trip equal to the bit; a resume in
    which every chain continues from its own state (one LMH step: nearly
    every chain's first kept value is its own saved value, GUM accepting
    about 1 % of LMH moves), within tests/test_vectorized.py:165-217's
    limits; a resume under a changed observation, rescored; and the
    interpreter chain resumed from initial_trace=post[-1]
    (tests/test_model.py:108-124)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Empirical
    from pyprob_tpu_torch.models import GaussianUnknownMean

    m = MCMC
    engines = mcmc_engines()
    pp.seed(m["seed"] + 1)
    model = GaussianUnknownMean()
    run = lambda **kw: model.posterior_results(m["transitions"], inference_engine=engines["rmh"], **kw)  # noqa: E731
    (first, _), launches = counted(device, lambda: host_timed(lambda: run(observe=OBSERVE)))
    state = first.final_chain_state
    fn = os.path.join(tmp, "chains")
    _, save_s = host_timed(lambda: state.save(fn))
    back, load_s = host_timed(lambda: pp.ChainState.load(fn))
    check(all(np.array_equal(back.values[a], state.values[a]) and np.array_equal(back.log_probs[a], state.log_probs[a])
              for a in state.values) and np.array_equal(back.log_prob_observed, state.log_prob_observed)
          and np.array_equal(back.result, state.result), "mcmc_resume: the loaded ChainState differs")
    resumed, seconds = host_timed(lambda: run(observe=OBSERVE, initial_trace=back))
    meta = resumed.metadata[-1]
    mean, std = float(resumed.mean), float(resumed.stddev)
    check(meta["burn_in"] == 0 and meta["resumed"] and resumed.final_chain_state.num_chains == state.num_chains
          and abs(mean - 7.25) < 0.3 and abs(std - math.sqrt(1 / 1.2)) < 0.3,
          f"mcmc_resume: resumed mean {mean}, stddev {std}, {meta}")
    chains = model.posterior_results(state.num_chains, inference_engine=engines["lmh"], observe=OBSERVE,
                                     initial_trace=back, return_chains=True)
    own = float(np.mean([float(c.values_numpy()[0]) == float(back.result[i]) for i, c in enumerate(chains)]))
    check(own > 0.8, f"mcmc_resume: {own} of the chains began from their own state")
    obs_new = {"obs0": 0.0, "obs1": 1.0}
    new_mean = (1.0 / 5.0 + 1.0 / 2.0) / (1.0 / 5.0 + 1.0)
    moved = run(observe=obs_new, initial_trace=back)
    check(abs(float(moved.mean) - new_mean) < 0.4 and moved.metadata[-1]["burn_in"] > 0,
          f"mcmc_resume: changed observation mean {float(moved.mean)} vs {new_mean}")
    one = model.posterior(1000, inference_engine=engines["rmh"], observe=OBSERVE, vectorized=False)
    two = model.posterior(1000, inference_engine=engines["rmh"], observe=OBSERVE, vectorized=False,
                          initial_trace=one[-1])
    vals = [float(t.result) for t in Empirical(concat_empiricals=[one, two]).get_values()[500:]]
    check(abs(float(np.mean(vals)) - 7.25) < 0.8, f"mcmc_resume: interpreter resume mean {np.mean(vals)}")
    emit({"phase": "mcmc_resume", "chains": state.num_chains, "save_seconds": save_s, "load_seconds": load_s,
          "bytes": os.path.getsize(fn), "resumed": {"mean": mean, "stddev": std, "seconds": seconds, **{
              k: meta[k] for k in ("num_steps", "burn_in", "acceptance_rate")}},
          "chains_from_own_state": own, "changed_observation": {"mean": float(moved.mean), "truth": new_mean,
                                                                "burn_in": moved.metadata[-1]["burn_in"]},
          "interpreter_resume_mean": float(np.mean(vals)), "launches": launches})
    return launches


def outer_latent_block_model():
    """tests/test_rejection.py:98-111's model: an outer latent and a
    rejection block (a move on mu rechecks the stored block's predicate)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Normal

    class OuterLatentBlock(pp.Model):
        def forward(self):
            mu = pp.sample(Normal(0.0, 2.0))

            def attempt():
                e = pp.sample(Normal(0.0, 1.0))
                return e, e * e < 4.0

            e = pp.rejection_sample(attempt)
            pp.observe(Normal(mu + e, 0.5), name="obs0")
            return mu

    return OuterLatentBlock()


def outer_block_truth(obs=3.0):
    """mu's posterior mean and stddev by grid integration over (mu, e)."""
    mu = np.linspace(-8, 12, 2001)[:, None]
    e = np.linspace(-2, 2, 801)[None, :]
    log_p = -0.5 * (mu / 2.0) ** 2 - 0.5 * e**2 - 0.5 * ((obs - mu - e) / 0.5) ** 2
    p = np.exp(log_p - log_p.max()).sum(axis=1)
    p /= p.sum()
    mean = float((p * mu[:, 0]).sum())
    return mean, float(np.sqrt((p * (mu[:, 0] - mean) ** 2).sum()))


def phase_mcmc_marsaglia(device):
    """Batched chains over rejection_sample blocks at the JAX tests' counts
    and limits: GaussianUnknownMeanMarsagliaRejection under LMH and RMH at
    20,000 (mean within 0.3, stddev within 0.25; tests/test_rejection.py:
    70-84) and the outer-latent block under LMH at 30,000 (within 0.2 of the
    grid truth; :113-125); the while-loop Marsaglia under RMH on the
    interpreter at 3,000 (mean within 0.8 after 500; tests/test_model.py:
    137-141)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia, GaussianUnknownMeanMarsagliaRejection

    pp.seed(MCMC["seed"] + 2)
    engines = mcmc_engines()
    model = GaussianUnknownMeanMarsagliaRejection()
    launches, out = {}, {}
    for name, engine in engines.items():
        (post, seconds), launches[f"mcmc_marsaglia_{name}"] = counted(device, lambda: host_timed(
            lambda: model.posterior_results(20_000, inference_engine=engine, observe=OBSERVE)))
        mean, std = float(post.mean), float(post.stddev)
        check(abs(mean - 7.25) < 0.3 and abs(std - math.sqrt(1 / 1.2)) < 0.25,
              f"mcmc_marsaglia {name}: mean {mean}, stddev {std}")
        out[name] = {**chain_line(post, seconds), "mean": mean, "stddev": std}
    truth = outer_block_truth()
    (post, seconds), launches["mcmc_outer_block"] = counted(device, lambda: host_timed(
        lambda: outer_latent_block_model().posterior_results(30_000, inference_engine=engines["lmh"],
                                                     observe={"obs0": 3.0})))
    mean, std = float(post.mean), float(post.stddev)
    check(abs(mean - truth[0]) < 0.2 and abs(std - truth[1]) < 0.2,
          f"mcmc_outer_block: {mean}, {std} vs the grid's {truth}")
    out["outer_block_lmh"] = {**chain_line(post, seconds), "mean": mean, "stddev": std, "grid": truth}
    interp = GaussianUnknownMeanMarsaglia().posterior_results(3000, inference_engine=engines["rmh"],
                                                             observe=OBSERVE, vectorized=False)
    tail = float(interp[500:].mean)
    check(abs(tail - 7.25) < 0.8, f"mcmc_marsaglia interpreter RMH: mean {tail}")
    out["interpreter_rmh_while_loop"] = {**interpreter_line(interp, 3000), "mean": tail}
    emit({"phase": "mcmc_marsaglia", **out, "launches": launches})
    return launches


def profile_busy(device, fn):
    """(fn(), wall seconds, device-busy seconds, the kernels' device ms by
    name, top 8) of one call under torch.profiler; busy is None when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and e.device_type.name == "CUDA":  # the kernels, not the ops that launched them
            by_name[e.key[:80]] = us / 1e3
    busy = sum(by_name.values()) / 1e3 if by_name else None
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return out, wall, busy, top


def phase_mcmc_gp(device, floor_ms):
    """GaussianProcessRegression at N = 256 (gp_model) under RMH with 1,024
    chains and MCMC["transitions"]: the log-lengthscale's mean within 0.6
    grid stddevs of true_posterior_moments (the JAX test's limit for HMC,
    tests/test_models_builtin.py:225-243); kernel 4 four times a step (one
    a panel of [1024, 256, 256]), no library Cholesky; peak memory with the
    [16384, 256, 256] warm-start pool; a resumed run of 32 steps under the
    profiler for the step's device-busy and wall time; kernel 4 at this
    shape timed beside its bound."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.ops import tile_chol

    m = MCMC
    pp.seed(m["seed"] + 3)
    model, y = gp_model(256)
    grid_mean, grid_std = model.true_posterior_moments(y)
    rmh = mcmc_engines()["rmh"]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with CountCholesky() as library:
        (post, seconds), launches = counted(device, lambda: host_timed(lambda: model.posterior_results(
            m["transitions"], inference_engine=rmh, observe={"y": y}, num_chains=m["chains"])))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    line = chain_line(post, seconds)
    mean = float(np.asarray(post.mean).reshape(-1)[0])
    check(abs(mean - grid_mean) <= m["gp_mean_tol"] * grid_std,
          f"mcmc_gp: mean {mean} vs grid {grid_mean} +- {grid_std}")
    check(device != "cuda" or library.calls == 0, f"mcmc_gp: torch.linalg.cholesky called {library.calls} times")
    check(device != "cuda" or launches["chol_inv_tile"] >= 4 * line["steps"],
          f"mcmc_gp: kernel 4 launched {launches['chol_inv_tile']} times in {line['steps']} steps")
    steps = 32
    _, wall, busy, top = profile_busy(device, lambda: model.posterior_results(
        m["chains"] * steps, inference_engine=rmh, observe={"y": y}, initial_trace=post.final_chain_state))
    for P in range(256, 0, -64) if device == "cuda" else ():
        tiles, out_rows, err = check_tile(m["chains"], 64, "cuda", P)
        emit_shape("chol_inv_tile", lambda: tile_chol.chol_inv_tile_into(tiles, out_rows),
                   lambda: tile_chol.chol_inv_tile_plain(tiles),
                   tile_bytes(m["chains"], 64, P), 2 * 64**3 * m["chains"] // 3, [m["chains"], 64, 64], err,
                   iters=20, entry="chol_inv_tile_into", l_row_width=P, panel_of=256, path="GP chain step",
                   launch_floor_ms=floor_ms)
        del tiles, out_rows
    emit({"phase": "mcmc_gp", "N": 256, **line, "mean": mean, "stddev": float(np.asarray(post.stddev).reshape(-1)[0]),
          "grid_mean": grid_mean, "grid_stddev": grid_std, "mean_error_in_grid_stddevs": (mean - grid_mean) / grid_std,
          "peak_memory_gib": peak_gib, "library_cholesky_calls": library.calls,
          "kernel4_launches": launches["chol_inv_tile"], "kernel4_launches_per_step": launches["chol_inv_tile"] / line["steps"],
          "profiled": {"steps": steps, "wall_s": wall, "device_busy_s": busy,
                       "wall_ms_per_step": wall / steps * 1e3,
                       "busy_ms_per_step": None if busy is None else busy / steps * 1e3,
                       "idle_share": None if busy is None else 1 - busy / wall, "top_kernels_ms": top},
          "launches": launches})
    return launches


def sorted_means(post):
    """The weighted mean and stddev of min(mu0, mu1) and max(mu0, mu1) a
    draw: label switching folded away."""
    v = np.asarray(post.values_numpy(), np.float64)
    w = np.asarray(post.weights, np.float64)
    out = []
    for a in (v.min(axis=1), v.max(axis=1)):
        mean = float((w * a).sum())
        out.append((mean, float(np.sqrt((w * (a - mean) ** 2).sum()))))
    return out


def phase_mcmc_gmm(device, floor_ms):
    """GaussianMixture K = 2 on tests/test_models_builtin.py's 40 data under
    LMH and RMH with 1,024 chains and MCMC["transitions"]: the sorted
    component means (min and max a draw; single-site chains stay in one
    label mode, tests/test_models_builtin.py:245-250) within 0.25 of 10^6
    prior IS's posterior stddev of each; kernel 1 once a step at 1,024 x 40
    rows, timed there beside its bound; a resumed run of 32 steps under the
    profiler."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianMixture
    from pyprob_tpu_torch.ops import kernels as K

    m = MCMC
    pp.seed(m["seed"] + 4)
    D = BUILTIN["mixture_data"]
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D)
    y = gm.synthesize([-2.0, 2.0], rng=0)
    reference = gm.posterior_results(m["gmm_is_traces"], observe={"y": y})
    ref = sorted_means(reference)
    rows = m["chains"] * D
    launches, out = {}, {}
    for name, engine in mcmc_engines().items():
        (post, seconds), launches[f"mcmc_gmm_{name}"] = counted(device, lambda: host_timed(
            lambda: gm.posterior_results(m["transitions"], inference_engine=engine, observe={"y": y},
                                         num_chains=m["chains"])))
        got = sorted_means(post)
        for (mean, _), (ref_mean, ref_std), which in zip(got, ref, ("min", "max")):
            check(abs(mean - ref_mean) < m["gmm_tol"] * ref_std,
                  f"mcmc_gmm {name}: {which} mean {mean} vs IS {ref_mean} +- {ref_std}")
        line = chain_line(post, seconds)
        at_rows = launches[f"mcmc_gmm_{name}"]["mixture_normal_log_prob_by_rows"].get(rows, 0)
        check(device != "cuda" or at_rows >= line["steps"],
              f"mcmc_gmm {name}: kernel 1 at {rows} rows {at_rows} times in {line['steps']} steps")
        out[name] = {**line, "sorted_means": got, "kernel1_launches_at_chain_rows": at_rows}
    _, wall, busy, top = profile_busy(device, lambda: gm.posterior_results(
        m["chains"] * 32, inference_engine=mcmc_engines()["rmh"], observe={"y": y},
        initial_trace=post.final_chain_state))
    if device == "cuda":
        inputs = gmm_inputs(m["chains"], D, 2, False, "cuda")
        got, plain = K.mixture_normal_log_prob(*inputs), K.mixture_normal_log_prob_plain(*inputs)
        err = float((got - plain).abs().max())
        check(bool(((got - plain).abs() <= 1e-5 * (1 + plain.abs())).all()), f"kernel 1 at {rows} rows: {err}")
        emit_shape("mixture_normal_log_prob", lambda: K.mixture_normal_log_prob(*inputs),
                   lambda: K.mixture_normal_log_prob_plain(*inputs), *mixture_cost(rows, 2), [rows, 2], err,
                   iters=50, path="GaussianMixture chain step", launch_floor_ms=floor_ms)
    emit({"phase": "mcmc_gmm", "data": D, "reference_is": {"traces": m["gmm_is_traces"], "sorted_means": ref,
          "ess": reference.effective_sample_size}, **out,
          "profiled": {"steps": 32, "wall_s": wall, "device_busy_s": busy, "wall_ms_per_step": wall / 32 * 1e3,
                       "busy_ms_per_step": None if busy is None else busy / 32 * 1e3,
                       "idle_share": None if busy is None else 1 - busy / wall, "top_kernels_ms": top},
          "launches": launches})
    return launches


def predictive_obs0(pred):
    return np.asarray([float(v.value) for t in pred.get_values() for v in t.variables if v.name == "obs0"])


def phase_posterior_predictive(device, lstm_model):
    """tests/test_model.py:179-200's criterion (the predictive of obs0 is
    N(7.25, 1/1.2 + 2): its mean within 0.2 at 3,000 draws) on a
    trace-valued posterior from batched LMH chains (1,024 chains x 256
    steps, every 8th kept, their traces built by one replay pass) and on one from lockstep
    IC (the lstm128 network, 4,000 traces); every predictive trace's mu
    one of the posterior's values."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    pp.seed(MCMC["seed"] + 5)
    n = MCMC["predictive_traces"]
    lmh = mcmc_engines()["lmh"]
    runs = {
        "lmh": (GaussianUnknownMean(), lambda m: m.posterior(
            MCMC["chains"] * 256, inference_engine=lmh, observe=OBSERVE, num_chains=MCMC["chains"],
            thinning_steps=8)),
        "lockstep_ic": (lstm_model, lambda m: m.posterior(
            4000, inference_engine=pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK,
            observe=OBSERVE, vectorized=False)),
    }
    out, launches = {}, {}
    for name, (model, make) in runs.items():
        (post, post_s), launches[f"posterior_predictive_{name}"] = counted(device, lambda: host_timed(lambda: make(model)))
        pred, pred_s = host_timed(lambda: model.posterior_predictive(post, num_traces=n))
        obs = predictive_obs0(pred)
        mus = {float(t.result) for t in post.get_values()}
        pinned = all(float(t.result) in mus for t in pred.get_values())
        check(len(obs) == n and abs(obs.mean() - 7.25) < MCMC["predictive_tol"] and pinned,
              f"posterior_predictive {name}: obs0 mean {obs.mean()}, latents pinned {pinned}")
        out[name] = {"posterior_traces": post.length, "posterior_mean": float(post.map(lambda t: float(t.result)).mean),
                     "posterior_seconds": post_s, "predictive_seconds": pred_s,
                     "obs0_mean": float(obs.mean()), "obs0_stddev": float(obs.std()),
                     "analytic_stddev": math.sqrt(1 / 1.2 + 2.0)}
    emit({"phase": "posterior_predictive", "traces": n, **out, "launches": launches})
    return launches


def phase_conditional(device):
    """condition / filter (tests/test_model.py:147-166): Uniform(0, 1) kept
    above 0.8 at 200 traces with acceptance in (0.05, 0.45), the timeout
    raising, filter's deprecation; and a conditional posterior: x ~ N(0, 1),
    y ~ N(x, 1) = 0, x > 0 kept, IS at 4,000 within 0.05 of the half-normal
    mean sqrt(1/2) sqrt(2/pi)."""
    import warnings

    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Normal, Uniform

    class Uniform01(pp.Model):
        def forward(self):
            return float(pp.sample(Uniform(0.0, 1.0)))

    class HalfObserved(pp.Model):
        def forward(self):
            x = pp.sample(Normal(0.0, 1.0))
            pp.observe(Normal(x, 1.0), name="y")
            return x

    pp.seed(MCMC["seed"] + 6)
    cond = Uniform01().condition(lambda trace: trace.result > 0.8)
    vals = np.asarray(cond.prior_results(num_traces=200).get_values())
    check(bool((vals > 0.8).all()) and 0.05 < cond.acceptance_ratio < 0.45,
          f"conditional: acceptance {cond.acceptance_ratio}")
    timed_out = False
    try:
        Uniform01().condition(lambda trace: False, criterion_timeout=50).prior_results(num_traces=1)
    except RuntimeError as e:
        timed_out = "Timeout" in str(e)
    check(timed_out, "conditional: the criterion timeout did not raise")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Uniform01().filter(lambda trace: trace.result < 0.5)
    check(any("deprecated" in str(w.message) for w in caught), "conditional: filter did not warn")
    half = HalfObserved().condition(lambda trace: float(trace.result) > 0.0)
    post, seconds = host_timed(lambda: half.posterior_results(num_traces=4000, observe={"y": 0.0}))
    truth = math.sqrt(0.5) * math.sqrt(2 / math.pi)
    check(abs(float(post.mean) - truth) < 0.05, f"conditional posterior mean {float(post.mean)} vs {truth}")
    emit({"phase": "conditional", "acceptance_ratio": cond.acceptance_ratio, "timeout_raised": timed_out,
          "posterior_mean": float(post.mean), "half_normal_mean": truth, "seconds": seconds,
          "traces_per_s": 4000 / seconds, "posterior_acceptance_ratio": half.acceptance_ratio})


def phase_parallel(device, tmp, lstm_model):
    """ParallelModel with 4 workers on the card: prior IS into a file (the
    four chunk files kept, reopened equal) and guided IC with the lstm128
    network, lockstep inside each worker, each held to the GUM limits
    (mean and stddev within 0.5); the guided run's ESS within 10 % of an
    in-process lockstep run's at the same count, relative
    (tests/test_model_parallel.py's pattern); MCMC refused; the workers'
    start-up seconds."""
    import glob

    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Empirical
    from pyprob_tpu_torch.models import GaussianUnknownMean

    m = MCMC
    n, k = m["parallel_traces"], m["parallel_workers"]
    pp.seed(m["seed"] + 7)
    fn = os.path.join(tmp, "parallel_prior_is")
    prior_is, prior_s = host_timed(lambda: GaussianUnknownMean().parallel(num_workers=k).posterior_results(
        n, observe=OBSERVE, file_name=fn))
    check(len(glob.glob(fn + "_chunk_*")) == k and prior_is.length == n, "parallel: chunk files")
    values = prior_is.values_numpy()
    mean_is = check_posterior(prior_is, "parallel prior IS")
    prior_meta = next(md for md in prior_is.metadata if "worker_start_seconds" in md)
    prior_is.close()
    back = Empirical(file_name=fn)
    check(np.array_equal(back.values_numpy(), values), "parallel: the reopened file differs")
    back.close()
    engine = pp.InferenceEngine.IMPORTANCE_SAMPLING_WITH_INFERENCE_NETWORK
    guided, guided_s = host_timed(lambda: lstm_model.parallel(num_workers=k).posterior_results(
        n, observe=OBSERVE, inference_engine=engine))
    mean_ic = check_posterior(guided, "parallel guided IC")
    (local, local_s), launches = counted(device, lambda: host_timed(lambda: lstm_model.posterior_results(
        n, observe=OBSERVE, inference_engine=engine, vectorized=False)))
    ess, local_ess = guided.effective_sample_size / n, local.effective_sample_size / n
    check(abs(ess / local_ess - 1) <= m["parallel_relative_band"],
          f"parallel guided IC: ESS fraction {ess} vs in-process lockstep {local_ess}")
    refused = False
    try:
        GaussianUnknownMean().parallel(num_workers=k).posterior(
            10, inference_engine=mcmc_engines()["lmh"], observe=OBSERVE)
    except ValueError:
        refused = True
    check(refused, "parallel: MCMC was not refused")
    guided_meta = next(md for md in guided.metadata if "worker_start_seconds" in md)
    emit({"phase": "parallel", "workers": k, "traces": n,
          "prior_is": {"seconds": prior_s, "traces_per_s": n / prior_s, "mean_stddev": mean_is,
                       "worker_start_seconds": prior_meta["worker_start_seconds"],
                       "worker_seconds": prior_meta["worker_seconds"]},
          "guided_ic": {"seconds": guided_s, "traces_per_s": n / guided_s, "mean_stddev": mean_ic,
                        "ess_fraction": ess, "worker_start_seconds": guided_meta["worker_start_seconds"],
                        "worker_seconds": guided_meta["worker_seconds"]},
          "in_process_lockstep": {"seconds": local_s, "traces_per_s": n / local_s, "ess_fraction": local_ess},
          "mcmc_refused": refused, "launches": launches})
    return launches


def smc_hmm_model():
    """The 3-state, 6-step HMM of tests/test_smc.py:124-167: integer
    Categorical sites that the staged replay must carry exactly."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Categorical, Normal

    h = SMC["hmm"]

    class SmcHMM(pp.Model):
        def forward(self):
            device = pp.util.param_device()
            trans = torch.tensor(h["trans"], dtype=torch.float32, device=device)
            locs = torch.tensor(h["loc"], dtype=torch.float32, device=device)
            z = pp.sample(Categorical(probs=torch.tensor(h["init"], dtype=torch.float32, device=device)),
                          address="z0")
            for t in range(len(h["ys"])):
                pp.observe(Normal(locs[z], h["scale"]), name=f"y{t}")
                if t < len(h["ys"]) - 1:
                    z = pp.sample(Categorical(probs=trans[z]), address=f"z{t + 1}")
            return z

    return SmcHMM(name="SMC HMM")


def smc_hmm_truth():
    """The last state's marginal by the forward algorithm."""
    h = SMC["hmm"]
    trans, loc = np.asarray(h["trans"]), np.asarray(h["loc"])
    alpha = np.asarray(h["init"], np.float64)
    for t, y in enumerate(h["ys"]):
        alpha = alpha * np.exp(-0.5 * ((y - loc) / h["scale"]) ** 2)
        if t < len(h["ys"]) - 1:
            alpha = alpha @ trans
    return alpha / alpha.sum()


def drawn_observe_count_model():
    """The second observe is met only where k = 1: at stage 2 the k = 0
    particles are past their last observe (the interpreter filter's
    zero increment).  Branches on the draw, so it runs on the interpreter."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Categorical, Normal

    class OneOrTwoObserves(pp.Model):
        def forward(self):
            mu = pp.sample(Normal(1.0, math.sqrt(5.0)))
            k = pp.sample(Categorical(probs=torch.tensor([0.5, 0.5], device=pp.util.param_device())))
            likelihood = Normal(mu, math.sqrt(2.0))
            pp.observe(likelihood, name="obs0")
            if int(k) == 1:
                pp.observe(likelihood, name="obs1")
            return k

    return OneOrTwoObserves(name="one or two observes")


def smc_run(device, label, run, warm_up=True):
    """One SMC run timed on the host clock (after a warm-up run), with the
    kernels' launches, the peak device memory and the filter's metadata:
    (posterior, the phase line's fields, launches).  On the card kernel 3
    must have launched once a stage."""
    import torch

    if warm_up:
        run()
    reset_launch_counts()
    sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    post = run()
    sync(device)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    md = post.metadata[-1]
    n = md["num_traces"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    if device == "cuda" and md["vectorized"]:
        check(launches["log_weight_stats"] == md["stages"],
              f"{label}: kernel 3 launched {launches['log_weight_stats']} times in {md['stages']} stages")
    fields = {
        "particles": n, "seconds": seconds, "particles_per_s": n / seconds, "stages": md["stages"],
        "stage_ess": md["stage_ess"], "resampled_stages": md["resampled_stages"],
        "ess_fraction": post.effective_sample_size / n, "log_evidence": post.log_evidence,
        "host_syncs": md.get("host_syncs"), "peak_memory_gib": peak_gib,
        "launches_by_shape": {k: v for k, v in launches.items() if k.endswith(("_by_rows", "_by_n")) and v},
    }
    return post, fields, launches


def check_gum_smc(post, label, tol):
    """GUM's SMC limits (tests/test_smc.py:38-51): mean, stddev and log Z."""
    mean, std = float(post.mean), float(post.stddev)
    check(abs(mean - POSTERIOR_MEAN) < tol[0], f"{label}: mean {mean}")
    check(abs(std - POSTERIOR_STDDEV) < tol[1], f"{label}: stddev {std}")
    check(abs(post.log_evidence - LOG_EVIDENCE) < tol[2], f"{label}: log Z {post.log_evidence}")
    return mean, std


def phase_smc_gum(device, n=None):
    """GUM under SMC at 10^6 particles, resample_threshold 1.0, each scheme:
    tests/test_smc.py:38-65's limits (mean 0.2, stddev 0.1, log Z 0.25
    of the analytic value) and an ESS above 5x prior IS's at the same N."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    n = n or SMC["particles"]
    pp.seed(SMC["seed"])
    prior_ess = GaussianUnknownMean().posterior_results(n, observe=OBSERVE, vectorized=True).effective_sample_size
    path = {}
    for scheme in sorted(pp.parallel.RESAMPLING_SCHEMES):
        label = f"smc_gum_{scheme}"
        post, fields, path[label] = smc_run(device, label, lambda: GaussianUnknownMean().posterior_results(
            n, observe=OBSERVE, inference_engine=pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO,
            resample_threshold=1.0, resampling=scheme))
        mean, std = check_gum_smc(post, label, SMC["gum_tol"])
        check(post.effective_sample_size > 5 * prior_ess, f"{label}: ESS {post.effective_sample_size} vs IS {prior_ess}")
        check(post.metadata[-1]["resampling"] == scheme, f"{label}: metadata")
        emit({"phase": label, "mean": mean, "stddev": std, "prior_is_ess_fraction": prior_ess / n, **fields})
    return path


def phase_smc_lgss(device, n=None):
    """LinearGaussianStateSpace(num_steps=8, a=0.9) on synthesize(rng=0) at
    10^6 particles: the mean path within 0.06 and the variance within 0.04
    of the RTS smoother, the ESS above 5x prior IS's
    (tests/test_models_builtin.py:292-323)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import LinearGaussianStateSpace

    n = n or SMC["particles"]
    pp.seed(SMC["seed"] + 1)
    model = LinearGaussianStateSpace(num_steps=8, a=0.9)
    _, ys = model.synthesize(rng=0)
    sm, sv = model.kalman_smoother(ys)
    prior_ess = model.posterior_results(n, observe=model.observes(ys), vectorized=True).effective_sample_size
    post, fields, launches = smc_run(device, "smc_lgss", lambda: model.posterior_results(
        n, observe=model.observes(ys), inference_engine=pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO))
    mean_err = float(np.abs(np.asarray(post.mean, np.float64) - sm).max())
    var_err = float(np.abs(np.asarray(post.variance, np.float64) - sv).max())
    check(mean_err < 0.06, f"smc_lgss: mean path {mean_err} from the smoother")
    check(var_err < 0.04, f"smc_lgss: variance {var_err} from the smoother")
    check(post.effective_sample_size > 5 * prior_ess, f"smc_lgss: ESS {post.effective_sample_size} vs IS {prior_ess}")
    emit({"phase": "smc_lgss", "mean_path_max_err": mean_err, "variance_max_err": var_err,
          "prior_is_ess_fraction": prior_ess / n, **fields})
    return launches


def phase_smc_hmm(device, n=None):
    """The 3-state, 6-step HMM at 10^6 particles: int64 sites, the last
    state's marginal within 0.03 of the forward algorithm's
    (tests/test_smc.py:124-167)."""
    import pyprob_tpu_torch as pp

    n = n or SMC["particles"]
    pp.seed(SMC["seed"] + 2)
    ys = SMC["hmm"]["ys"]
    post, fields, launches = smc_run(device, "smc_hmm", lambda: smc_hmm_model().posterior_results(
        n, observe={f"y{t}": y for t, y in enumerate(ys)}, inference_engine=pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO))
    values = np.asarray(post.get_values())
    check(values.dtype == np.int64, f"smc_hmm: values of {values.dtype}")
    w = np.asarray(post.weights, np.float64)
    est = np.array([w[values == k].sum() for k in range(3)])
    truth = smc_hmm_truth()
    err = float(np.abs(est - truth).max())
    check(err < 0.03, f"smc_hmm: marginal {est} vs {truth}")
    emit({"phase": "smc_hmm", "marginal": est.tolist(), "forward_algorithm": truth.tolist(), "max_err": err,
          **fields})
    return launches


def phase_smc_marsaglia(device, n=None):
    """GaussianUnknownMeanMarsagliaRejection at 10^6 particles: the
    rejection block a masked retry loop at stage 1 and replayed whole at
    stage 2; mean and stddev within 0.2 (tests/test_rejection.py:137-144)."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsagliaRejection

    n = n or SMC["particles"]
    pp.seed(SMC["seed"] + 3)
    post, fields, launches = smc_run(device, "smc_marsaglia", lambda: GaussianUnknownMeanMarsagliaRejection(
    ).posterior_results(n, observe=OBSERVE, inference_engine=pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO))
    mean, std = float(post.mean), float(post.stddev)
    check(abs(mean - POSTERIOR_MEAN) < 0.2 and abs(std - POSTERIOR_STDDEV) < 0.2, f"smc_marsaglia: {mean}, {std}")
    emit({"phase": "smc_marsaglia", "mean": mean, "stddev": std, **fields})
    return launches


def phase_smc_guided(device, networks, marsaglia_model, n=None):
    """SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK at 10^6 particles,
    unchunked, with the trained GUM networks (``networks``: label -> model)
    at resample_threshold 1.0, held to tests/test_smc.py:226-274's limits
    (mean 0.2, stddev 0.1, log Z 0.3, ESS > 0.2 N), and with the Marsaglia
    LSTM network at the default threshold, mean within 0.25
    (tests/test_rejection.py:172-180); kernel 1 (GUM) or kernel 2
    (Marsaglia's Uniform head) launched on every stage."""
    import pyprob_tpu_torch as pp

    n = n or SMC["particles"]
    engine = pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO_WITH_INFERENCE_NETWORK
    path = {}
    runs = [(label, model, "mixture_normal_log_prob", {"resample_threshold": 1.0}) for label, model in networks.items()]
    runs.append(("marsaglia_lstm128", marsaglia_model, "mixture_truncated_normal_log_prob", {}))
    for i, (label, model, kernel, kwargs) in enumerate(runs):
        phase = f"smc_guided_{label}"
        pp.seed(SMC["seed"] + 10 + i)
        post, fields, path[phase] = smc_run(device, phase, lambda: model.posterior_results(
            n, observe=OBSERVE, inference_engine=engine, **kwargs))
        md = post.metadata[-1]
        if device == "cuda":
            check(path[phase][kernel] >= md["stages"], f"{phase}: {kernel} launched {path[phase][kernel]} times")
        if label.startswith("marsaglia"):
            mean, std = float(post.mean), float(post.stddev)
            check(abs(mean - POSTERIOR_MEAN) < 0.25, f"{phase}: mean {mean}")
        else:
            mean, std = check_gum_smc(post, phase, SMC["guided_tol"])
            check(post.effective_sample_size > 0.2 * n, f"{phase}: ESS {post.effective_sample_size}")
        check("WITH_INFERENCE_NETWORK" in md["inference_engine"], f"{phase}: metadata")
        emit({"phase": phase, "mean": mean, "stddev": std, "kernel": kernel, "kernel_launches": path[phase][kernel],
              **fields})
    return path


def phase_smc_interpreter(device, n=None):
    """The while-loop GaussianUnknownMeanMarsaglia with vectorized=None:
    SMC falls back to the interpreter filter, 2,000 particles, systematic
    and stratified, held to tests/test_smc.py:192-203 (mean 0.35, stddev
    0.25, log Z 0.5, metadata vectorized False); then a program whose
    observe count depends on a draw, run to the end, its share of k = 1
    within 0.03 of the analytic 0.0548."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMeanMarsaglia

    n = n or SMC["interpreter_particles"]
    engine = pp.InferenceEngine.SEQUENTIAL_MONTE_CARLO
    path = {}
    for i, scheme in enumerate(("systematic", "stratified")):
        phase = f"smc_interpreter_{scheme}"
        pp.seed(SMC["seed"] + 20 + i)
        post, fields, path[phase] = smc_run(device, phase, lambda: GaussianUnknownMeanMarsaglia().posterior_results(
            n, observe=OBSERVE, inference_engine=engine, resample_threshold=1.0, resampling=scheme), warm_up=False)
        check(post.metadata[-1]["vectorized"] is False, f"{phase}: ran on the batched tier")
        mean, std = check_gum_smc(post, phase, SMC["interpreter_tol"])
        emit({"phase": phase, "mean": mean, "stddev": std, **fields})
    pp.seed(SMC["seed"] + 22)
    post, fields, path["smc_interpreter_drawn_observes"] = smc_run(
        device, "smc_interpreter_drawn_observes", lambda: drawn_observe_count_model().posterior_results(
            n, observe=OBSERVE, inference_engine=engine, resample_threshold=1.0), warm_up=False)
    p8 = math.exp(-0.5 * 49.0 / 7.0) / math.sqrt(2 * math.pi * 7.0)
    share = math.exp(LOG_EVIDENCE) / (p8 + math.exp(LOG_EVIDENCE))
    got = float(post.mean)
    check(post.metadata[-1]["stages"] == 2 and abs(got - share) < 0.03, f"drawn observes: share {got} vs {share}")
    emit({"phase": "smc_interpreter_drawn_observes", "share_k1": got, "analytic": share, **fields})
    return path


def phase_smc_kernel_shapes(path, floor_ms):
    """Kernels 1 and 2 held against their plain versions (with the special
    rows) and timed at every row count the SMC phases launched them at
    (10^6 unchunked), beside their bounds and the launch floor."""
    from pyprob_tpu_torch.ops import kernels as K

    Kc = MIXTURE_COMPONENTS
    launches = {}  # rows -> {kernel: launches}
    for counts in path.values():
        for name in FORWARD_KERNELS:
            for rows, count in counts.get(name + "_by_rows", {}).items():
                launches.setdefault(rows, {}).setdefault(name, 0)
                launches[rows][name] += count
    for rows, by_name in sorted(launches.items()):
        checked = check_round_forwards(rows, seed=rows)
        for name, count in sorted(by_name.items()):
            inputs, err = checked[name]
            cost = mixture_cost if name == FORWARD_KERNELS[0] else tnorm_cost
            emit_shape(name, lambda: getattr(K, name)(*inputs), lambda: getattr(K, name + "_plain")(*inputs),
                       *cost(rows, Kc), [rows, Kc], err, iters=10, path="SMC", launches=count,
                       launch_floor_ms=floor_ms)
    emit({"phase": "smc_kernel_checks", "launches_by_rows": launches})



# the gradient engines' phases (69-76), after every earlier phase (whose
# draws stay as they were): GUM and GaussianMixture chains at 1,024 chains,
# the GP at N = 256 with 256 chains, the JAX tests' criteria at their own
# counts (tests/test_models_builtin.py:158-330, tests/test_lkj.py:131,
# tests/test_censored_zi.py:116, tests/test_distributions_new.py:142,
# tests/test_distributions_r3.py:137-200, tests/test_gradient_resume.py,
# tests/test_laplace.py), and each gradient on the card against its plain
# versions there
GRADIENT = {"chains": 1024, "traces": 102_400, "gmm_traces": 25_600, "gmm_burn_in": 100, "gp_chains": 256,
            "gp_traces": 12_800,
            "gp_burn_in": 200, "seed": 100, "reference_is": 1_000_000, "builtin_reference_is": 400_000,
            # |kernel − plain| <= tol (1 + |plain|) of each gradient at fixed z
            "gmm_grad_tol": 1e-4, "gp_grad_tol": 2e-3, "gp_library_tol": 5e-3}


def grad_engines():
    import pyprob_tpu_torch as pp

    return {"hmc": pp.InferenceEngine.HAMILTONIAN_MONTE_CARLO, "nuts": pp.InferenceEngine.NO_U_TURN_SAMPLER}


def gradient_line(post, seconds):
    """A gradient-chain run's figures from its metadata: chains, steps,
    acceptance, step size, transitions/s of the step loop (host clock),
    potentials (forward and backward replays) a transition, NUTS's tree
    depth, divergences and host syncs."""
    meta = post.metadata[-1]
    check("batched" in post.name, f"not the batched chains: {post.name}")
    C, T = meta["num_chains"], meta["transitions"] // meta["num_chains"]
    replays = meta.get("replays_per_transition", meta.get("leapfrog_steps"))
    line = {"chains": C, "steps": T, "burn_in": meta["burn_in"], "kept": post.length,
            "acceptance_rate": meta["acceptance_rate"], "final_step_size": meta["final_step_size"],
            "step_loop_seconds": meta["step_seconds"], "transitions_per_s": C * T / meta["step_seconds"],
            "replays_per_transition": replays, "potentials": 1 + T * replays,
            "ms_per_potential": meta["step_seconds"] / (T * replays) * 1e3, "seconds": seconds,
            "potential_graph": meta["potential_graph"]}
    for k in ("mean_tree_depth", "divergences", "max_replays_per_transition", "host_syncs"):
        if k in meta:
            line[k] = meta[k]
    return line


def phase_gradient_gum(device):
    """GUM under HMC and NUTS at 1,024 chains and GRADIENT["traces"] kept
    draws, held to _check_gum.  Returns the launches by run."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    g = GRADIENT
    pp.seed(g["seed"])
    model = GaussianUnknownMean()
    launches, out = {}, {}
    for name, engine in grad_engines().items():
        (post, seconds), launches[f"{name}_gum"] = counted(device, lambda: host_timed(
            lambda: model.posterior_results(g["traces"], inference_engine=engine, observe=OBSERVE,
                                            num_chains=g["chains"])))
        line = gradient_line(post, seconds)
        check(line["chains"] == g["chains"] and post.length == g["traces"], f"{name}_gum: {line}")
        out[name] = {**line, **check_gum_chain(post, f"{name}_gum")}
    emit({"phase": "gradient_gum", **out, "launches": launches})
    return launches


def phase_gradient_gmm(device, floor_ms):
    """GaussianMixture K = 2 on 40 data (tests/test_models_builtin.py:
    245-290) under HMC and NUTS at 1,024 chains (25 kept transitions after
    a burn-in of 100: the lockstep NUTS transition of 1,024 chains runs
    the deepest chain's tree, and this potential, with kernels 1 and 1b in
    it, is not captured as a CUDA graph): the sorted component means
    within mcmc_gmm's 0.25 of 10^6 prior IS's stddev; kernel 1 at 1,024 x
    40 rows and kernel 1b (the observe's gradient) at least once a
    potential; the JAX test's criterion that NUTS chains freeze in one
    label mode (1,600 traces, burn-in 200, return_chains: all chains but
    one), and HMC with learn_weights at its counts (200 draws, burn-in
    150, one chain: 40 rows); kernels 1 and 1b held against their plain
    versions at every row count the runs launched kernel 1 at
    (``check_gmm_kernels``) and timed beside their bounds at 40,960 and
    40 rows."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianMixture
    from pyprob_tpu_torch.ops import kernels as K

    g = GRADIENT
    pp.seed(g["seed"] + 1)
    D = BUILTIN["mixture_data"]
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D)
    y = gm.synthesize([-2.0, 2.0], rng=0)
    ref = sorted_means(gm.posterior_results(g["reference_is"], observe={"y": y}))
    rows = g["chains"] * D
    launches, out = {}, {}
    for name, engine in grad_engines().items():
        (post, seconds), launches[f"{name}_gmm"] = counted(device, lambda: host_timed(
            lambda: gm.posterior_results(g["gmm_traces"], inference_engine=engine, observe={"y": y},
                                         num_chains=g["chains"], burn_in=g["gmm_burn_in"])))
        got = sorted_means(post)
        for (mean, _), (ref_mean, ref_std), which in zip(got, ref, ("min", "max")):
            check(abs(mean - ref_mean) < MCMC["gmm_tol"] * ref_std,
                  f"{name}_gmm: {which} mean {mean} vs IS {ref_mean} +- {ref_std}")
        line = gradient_line(post, seconds)
        counts = launches[f"{name}_gmm"]
        at_rows = counts["mixture_normal_log_prob_by_rows"].get(rows, 0)
        backward = counts["mixture_normal_log_prob_backward"]
        check(device != "cuda" or (at_rows >= line["potentials"] and backward >= line["potentials"]),
              f"{name}_gmm: kernel 1 {at_rows} times at {rows} rows, kernel 1b {backward} times, "
              f"for {line['potentials']} potentials")
        out[name] = {**line, "sorted_means": got, "kernel1_at_chain_rows": at_rows, "kernel1b": backward}
    nuts = gm.posterior(1600, observe={"y": y}, burn_in=200, return_chains=True,
                        inference_engine=grad_engines()["nuts"])
    shares = [float((np.asarray(c.values_numpy(), np.float64)[:, 0] < 0).mean()) for c in nuts]
    frozen = sum(s < 0.05 or s > 0.95 for s in shares)
    check(frozen >= len(nuts) - 1, f"gradient_gmm: {frozen} of {len(nuts)} NUTS chains frozen")
    mw = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D, learn_weights=True)
    (hw, _), weights_counts = counted(device, lambda: host_timed(lambda: mw.posterior(
        200, observe={"y": y}, inference_engine=grad_engines()["hmc"], burn_in=150)))
    check(hw.length == 200, f"gradient_gmm: learn_weights HMC gave {hw.length} draws")
    check(device != "cuda" or (weights_counts["mixture_normal_log_prob"] >= 1
                               and weights_counts["mixture_normal_log_prob_backward"] >= 1),
          f"gradient_gmm learn_weights: {weights_counts}")
    launches["hmc_gmm_weights"] = weights_counts
    if device == "cuda":
        # kernels 1 and 1b against their plain versions at every row count
        # this phase launched kernel 1 at (the chains' C x 40 rows, the
        # one-chain learn_weights run's 40, the probes' and the decodes'),
        # with shared logits, and per chain as learn_weights gives them;
        # each timed beside its bound at the potentials' rows
        checked = {(rows_at, run == "hmc_gmm_weights")
                   for run, counts in launches.items() for rows_at in counts["mixture_normal_log_prob_by_rows"]}
        errors = {}
        for rows_at, per_chain in sorted(checked):
            err_f, err_b, inputs, out_k, cot = check_gmm_kernels(rows_at // D, D, per_chain)
            errors[f"{rows_at}{' per chain' if per_chain else ''}"] = {"forward": err_f, "backward": err_b}
            if rows_at not in (rows, D):
                continue
            where = "GaussianMixture potential" + (" (learn_weights, one chain)" if per_chain else "")
            emit_shape("mixture_normal_log_prob", lambda: K.mixture_normal_log_prob(*inputs),
                       lambda: K.mixture_normal_log_prob_plain(*inputs), *mixture_cost(rows_at, 2),
                       [rows_at, 2], err_f, iters=50, path=where, launch_floor_ms=floor_ms)
            emit_shape("mixture_normal_log_prob_backward",
                       lambda: K.mixture_normal_log_prob_backward(*inputs, out_k, cot, need_x=False),
                       lambda: K.mixture_normal_log_prob_backward_plain(*inputs, out_k, cot),
                       *mixture_backward_cost(rows_at, 2), [rows_at, 2], err_b, iters=50,
                       path=where + "'s gradient", launch_floor_ms=floor_ms)
        check((rows, False) in checked and (D, True) in checked,
              f"gradient_gmm: kernel 1 not launched at {rows} and {D} rows: {sorted(checked)}")
        out["kernel_checks"] = errors
    emit({"phase": "gradient_gmm", "data": D, "reference_is_sorted_means": ref, **out,
          "nuts_chain_shares_below_0": shares, "nuts_frozen": frozen, "launches": launches})
    return launches


def check_gmm_kernels(chains, data, per_chain, seed=5):
    """Kernel 1 and kernel 1b (dμ and dlogits, as the potential's gradient
    asks for them) on GaussianMixture's observe inputs at ``chains`` x
    ``data`` rows against their plain versions: the forward within 1e-5
    (1 + |ref|), the gradients within 1e-5 + 1e-4 |ref|.  Returns both max
    abs errors, the inputs, the forward's output and the cotangent."""
    import torch
    from pyprob_tpu_torch.ops import kernels as K

    rows = chains * data
    inputs = gmm_inputs(chains, data, 2, per_chain, "cuda", seed=seed)
    out_k, ref = K.mixture_normal_log_prob(*inputs), K.mixture_normal_log_prob_plain(*inputs)
    check(bool(torch.isfinite(out_k).all()) and bool(torch.isfinite(ref).all()),
          f"kernel 1 at {rows} rows: non-finite output")
    err_f = float((out_k - ref).abs().max())
    check(bool(((out_k - ref).abs() <= 1e-5 * (1 + ref.abs())).all()), f"kernel 1 at {rows} rows: {err_f}")
    cot = torch.ones_like(out_k)
    got_b = K.mixture_normal_log_prob_backward(*inputs, out_k, cot, need_x=False)
    plain_b = K.mixture_normal_log_prob_backward_plain(*inputs, out_k, cot)
    err_b = max(float((a - b).abs().max()) for a, b in zip(got_b[1:], plain_b[1:]))
    check(all(bool(((a - b).abs() <= 1e-5 + 1e-4 * b.abs()).all()) for a, b in zip(got_b[1:], plain_b[1:])),
          f"kernel 1b at {rows} rows: {err_b}")
    return err_f, err_b, inputs, out_k, cot


def phase_hmc_gp(device, floor_ms):
    """GaussianProcessRegression at N = 256 (gp_model) under HMC with 256
    chains, GRADIENT["gp_traces"] kept draws after a burn-in of 200: the
    log-lengthscale's mean within 0.6 grid stddevs (the JAX test's,
    tests/test_models_builtin.py:225-243); kernel 4 four times a potential
    (the panel Cholesky under autograd, PanelCholesky), no library
    Cholesky; peak memory; kernel 4 timed at [256, 64, 64] for each panel
    beside its bound."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.ops import tile_chol

    g = GRADIENT
    pp.seed(g["seed"] + 2)
    model, y = gp_model(256)
    grid_mean, grid_std = model.true_posterior_moments(y)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with CountCholesky() as library:
        (post, seconds), launches = counted(device, lambda: host_timed(lambda: model.posterior_results(
            g["gp_traces"], inference_engine=grad_engines()["hmc"], observe={"y": y}, num_chains=g["gp_chains"],
            burn_in=g["gp_burn_in"])))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    line = gradient_line(post, seconds)
    mean = float(np.asarray(post.mean).reshape(-1)[0])
    check(abs(mean - grid_mean) <= MCMC["gp_mean_tol"] * grid_std,
          f"hmc_gp: mean {mean} vs grid {grid_mean} +- {grid_std}")
    check(device != "cuda" or library.calls == 0, f"hmc_gp: torch.linalg.cholesky called {library.calls} times")
    check(device != "cuda" or launches["chol_inv_tile"] >= 4 * line["potentials"],
          f"hmc_gp: kernel 4 launched {launches['chol_inv_tile']} times for {line['potentials']} potentials")
    for P in range(256, 0, -64) if device == "cuda" else ():
        tiles, out_rows, err = check_tile(g["gp_chains"], 64, "cuda", P)
        emit_shape("chol_inv_tile", lambda: tile_chol.chol_inv_tile_into(tiles, out_rows),
                   lambda: tile_chol.chol_inv_tile_plain(tiles),
                   tile_bytes(g["gp_chains"], 64, P), 2 * 64**3 * g["gp_chains"] // 3, [g["gp_chains"], 64, 64],
                   err, iters=20, entry="chol_inv_tile_into", l_row_width=P, panel_of=256,
                   path="GP potential under HMC", launch_floor_ms=floor_ms)
        del tiles, out_rows
    emit({"phase": "hmc_gp", "N": 256, **line, "mean": mean, "stddev": float(np.asarray(post.stddev).reshape(-1)[0]),
          "grid_mean": grid_mean, "grid_stddev": grid_std, "mean_error_in_grid_stddevs": (mean - grid_mean) / grid_std,
          "peak_memory_gib": peak_gib, "library_cholesky_calls": library.calls,
          "kernel4_launches": launches["chol_inv_tile"],
          "kernel4_launches_per_potential": launches["chol_inv_tile"] / line["potentials"], "launches": launches})
    return launches


class PlainKernels:
    """While active, the mixture forward and the panel loop's tile factor
    take their plain PyTorch versions on the card (autograd of the plain
    forward for the mixture's gradient)."""

    def __enter__(self):
        from pyprob_tpu_torch.ops import blocked_linalg, kernels as K, tile_chol

        self.saved = (K.mixture_normal_log_prob, blocked_linalg.chol_inv_tile_into)

        def tile_into(tile, l_out):
            L, M = tile_chol.chol_inv_tile_plain(tile)
            P = tile.shape[-1]
            l_out[:, :, :P] = L
            l_out[:, :, P:] = 0
            return M

        K.mixture_normal_log_prob = K.mixture_normal_log_prob_plain
        blocked_linalg.chol_inv_tile_into = tile_into
        return self

    def __exit__(self, *exc):
        from pyprob_tpu_torch.ops import blocked_linalg, kernels as K

        K.mixture_normal_log_prob, blocked_linalg.chol_inv_tile_into = self.saved


def gp_potential_float64(model, y, z, device):
    """The GP potential (Normal prior on the log-lengthscale, MVN marginal
    likelihood) and its gradient in float64 on the card through
    torch.linalg.cholesky: the library reference of the panel path."""
    import torch

    z = torch.as_tensor(z, dtype=torch.float64, device=device).reshape(-1).requires_grad_(True)
    sq = torch.as_tensor(model._sq_dists, dtype=torch.float64, device=device)
    ell = torch.exp(z)[:, None, None]
    N = sq.shape[0]
    K = torch.exp(-0.5 * sq / (ell * ell)) + (model.fixed["noise"] ** 2 + 1e-6) * torch.eye(N, dtype=torch.float64,
                                                                                            device=device)
    L = torch.linalg.cholesky(K)
    yv = torch.as_tensor(y, dtype=torch.float64, device=device).expand(z.shape[0], N)
    a = torch.linalg.solve_triangular(L, yv.unsqueeze(-1), upper=False).squeeze(-1)
    loglik = -0.5 * (a * a).sum(-1) - torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1) \
        - 0.5 * N * math.log(2 * math.pi)
    prior = -0.5 * ((z - model.prior_mean) / model.prior_stddev) ** 2 - math.log(model.prior_stddev) \
        - 0.5 * math.log(2 * math.pi)
    u = -(loglik + prior)
    (grad,) = torch.autograd.grad(u.sum(), z)
    return u.detach(), grad


def phase_gradient_card_vs_cpu(device):
    """Each new gradient at fixed z on the card against its plain versions
    on the card: GaussianMixture with learn_weights at 1,024 chains (its
    observe on kernels 1 and 1b, against autograd of the plain forward)
    within GRADIENT["gmm_grad_tol"] (1 + |plain|), and the GP at N = 256 at
    256 log-lengthscales in [-2, 2] (the panel path with kernel 4 under
    PanelCholesky, against the panel path with the plain tile factor)
    within GRADIENT["gp_grad_tol"] (1 + |plain|), and against float64
    torch.linalg.cholesky within GRADIENT["gp_library_tol"] (1 + |ref|).
    Prints each measured error."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.inference import hmc
    from pyprob_tpu_torch.models import GaussianMixture

    g = GRADIENT
    D = BUILTIN["mixture_data"]
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D, learn_weights=True)
    y = gm.synthesize([-2.0, 2.0], rng=0)
    obs = {"y": torch.as_tensor(y, dtype=torch.float32, device=device)}
    fm = hmc._functionalize(gm, obs, 1.0, "HAMILTONIAN_MONTE_CARLO", (), None)
    rng = np.random.default_rng(g["seed"] + 3)
    z = rng.normal(size=(g["chains"], fm.dim)).astype(np.float32)
    z[:, :2] = np.array([-2.0, 2.0]) + 0.5 * rng.normal(size=(g["chains"], 2))
    zt = torch.as_tensor(z, device=device)
    (u_k, g_k), counts = counted(device, lambda: fm.value_and_grad(zt, obs))
    with PlainKernels():
        u_p, g_p = fm.value_and_grad(zt, obs)
    gmm_err = {"potential": float((u_k - u_p).abs().max()), "gradient": float((g_k - g_p).abs().max()),
               "gradient_rel": float(((g_k - g_p).abs() / (1 + g_p.abs())).max())}
    check(device != "cuda" or (counts["mixture_normal_log_prob"] >= 1
                               and counts["mixture_normal_log_prob_backward"] >= 1),
          f"gradient_card_vs_cpu: kernels 1/1b not launched: {counts}")
    tol = g["gmm_grad_tol"]
    check(bool(((u_k - u_p).abs() <= tol * (1 + u_p.abs())).all()
               and ((g_k - g_p).abs() <= tol * (1 + g_p.abs())).all()),
          f"gradient_card_vs_cpu gmm: {gmm_err} over {tol} (1 + |plain|)")
    model, ygp = gp_model(256)
    obs_gp = {"y": torch.as_tensor(ygp, dtype=torch.float32, device=device)}
    fm_gp = hmc._functionalize(model, obs_gp, 1.0, "HAMILTONIAN_MONTE_CARLO", (), None)
    zg = torch.linspace(-2.0, 2.0, 256, device=device).reshape(-1, 1)
    with CountCholesky() as library:
        (u_k, g_k), counts_gp = counted(device, lambda: fm_gp.value_and_grad(zg, obs_gp))
    check(device != "cuda" or (counts_gp["chol_inv_tile"] == 4 and library.calls == 0),
          f"gradient_card_vs_cpu gp: kernel 4 {counts_gp['chol_inv_tile']} times, library {library.calls}")
    with PlainKernels():
        u_p, g_p = fm_gp.value_and_grad(zg, obs_gp)
    u_64, g_64 = gp_potential_float64(model, ygp, zg.cpu().numpy(), device)
    gp_err = {"potential": float((u_k - u_p).abs().max()), "gradient": float((g_k - g_p).abs().max()),
              "gradient_rel": float(((g_k - g_p).abs() / (1 + g_p.abs())).max()),
              "gradient_vs_float64_rel": float(((g_k.double().reshape(-1) - g_64).abs() / (1 + g_64.abs())).max()),
              "potential_vs_float64_rel": float(((u_k.double() - u_64).abs() / (1 + u_64.abs())).max())}
    check(bool(((g_k - g_p).abs() <= g["gp_grad_tol"] * (1 + g_p.abs())).all()),
          f"gradient_card_vs_cpu gp vs plain tile: {gp_err}")
    check(gp_err["gradient_vs_float64_rel"] <= g["gp_library_tol"]
          and gp_err["potential_vs_float64_rel"] <= g["gp_library_tol"],
          f"gradient_card_vs_cpu gp vs float64: {gp_err}")
    emit({"phase": "gradient_card_vs_cpu", "gmm": {"chains": g["chains"], "dim": fm.dim, "tol": tol, **gmm_err},
          "gp": {"N": 256, "points": 256, "tol_plain": g["gp_grad_tol"], "tol_float64": g["gp_library_tol"],
                 **gp_err},
          "launches": {"gmm": counts, "gp": counts_gp}})


def lkj_corr_model():
    """tests/test_lkj.py:106-118: an LKJ prior on a 2 x 2 correlation's
    Cholesky factor, a HalfNormal scale, 8 bivariate observes."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import HalfNormal, LKJCholesky, MultivariateNormal

    class CorrModel(pp.Model):
        def forward(self):
            L = pp.sample(LKJCholesky(2, 1.0))
            sigma = pp.sample(HalfNormal(2.0))
            lik = MultivariateNormal(torch.zeros(2, device=L.device), scale_tril=sigma[..., None, None] * L)
            for i in range(8):
                pp.observe(lik, name=f"y{i}")
            return torch.stack([L[..., 1, 0], sigma], -1)

    rng = np.random.default_rng(5)
    ys = rng.multivariate_normal([0, 0], np.array([[1.0, 0.7], [0.7, 1.0]]), size=8)
    return CorrModel(name="LKJ correlation"), {f"y{i}": ys[i] for i in range(8)}


def small_latent_models():
    """tests/test_distributions_r3.py:137-200 and tests/test_distributions_new.py:
    142-170: the InverseGamma variance, Pareto and HalfNormal/Gumbel
    latents."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Gumbel, HalfNormal, InverseGamma, Normal, Pareto

    class Variance(pp.Model):
        def forward(self):
            sigma2 = pp.sample(InverseGamma(3.0, 2.0), name="sigma2")
            for i in range(4):
                pp.observe(Normal(0.0, torch.sqrt(sigma2)), name=f"x{i}")
            return sigma2

    class ParetoLatent(pp.Model):
        def forward(self):
            x = pp.sample(Pareto(1.0, 3.0), name="x")
            pp.observe(Normal(x, 0.5), name="y")
            return x

    class LocScale(pp.Model):
        def forward(self):
            loc = pp.sample(Gumbel(0.0, 1.0))
            scale = pp.sample(HalfNormal(2.0))
            pp.observe(Normal(loc, scale), name="y")
            return torch.stack([loc, scale], -1)

    return Variance(name="InverseGamma variance"), ParetoLatent(name="Pareto"), LocScale(name="Gumbel-HalfNormal")


def phase_nuts_builtin(device):
    """The JAX tests' gradient-engine criteria at their own counts (chain
    counts by the default, min(max(1, n // 256), 1024), unless the test
    gives them): EightSchools NUTS 20,000 (mu, tau means in (3.2, 5.6),
    (2.2, 5.2); within 0.6 of the test's tempered-SMC reference, in
    tempered_smc_eight_schools, after this phase); logistic regression NUTS
    600 (burn-in 200; mean and stddev within 0.5 grid stddevs); GP N = 25
    HMC 400 (burn-in 200; within 0.6 grid stddevs); the state space NUTS
    4,000 (burn-in 0; mean path within 0.08 of the RTS smoother); the LKJ
    correlation NUTS 2,000 of 16 chains (within 0.1 of 400,000 prior IS,
    above 0.1); Tobit NUTS 2,000 of 8 chains (within 0.07 of the grid);
    InverseGamma NUTS 20,000 (within 0.15 of the conjugate moments);
    Pareto HMC 20,000 and Beta-NegativeBinomial NUTS 20,000 (within 0.05
    and 0.03 of 400,000 prior IS); HalfNormal/Gumbel NUTS 2,000 of 16
    chains (within 0.25 of 400,000 prior IS).  Returns the launches by
    run and EightSchools' NUTS means."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import (
        BayesianLogisticRegression, EightSchools, GaussianProcessRegression, LinearGaussianStateSpace,
    )

    g = GRADIENT
    pp.seed(g["seed"] + 4)
    hmc_, nuts_ = grad_engines()["hmc"], grad_engines()["nuts"]
    ref_n = g["builtin_reference_is"]
    launches, lines = {}, {}

    def run(name, fn):
        (post, seconds), launches[f"builtin_{name}"] = counted(device, lambda: host_timed(fn))
        return post, gradient_line(post, seconds) if not isinstance(post, list) else {"seconds": seconds}

    es = EightSchools()
    post, line = run("eight_schools_nuts", lambda: es.posterior_results(
        20000, observe=es.observes(), inference_engine=nuts_))
    es_mean = np.asarray(post.mean, np.float64)
    (mu_lo, mu_hi), (tau_lo, tau_hi) = BUILTIN["eight_schools_bands"]
    check(mu_lo < es_mean[0] < mu_hi and tau_lo < es_mean[1] < tau_hi, f"eight_schools nuts: mean {es_mean}")
    lines["eight_schools"] = {**line, "mean": es_mean.tolist()}

    logr = BayesianLogisticRegression(np.random.default_rng(4).normal(size=(60, 1)))
    y = logr.synthesize([1.2], rng=2)
    tmean, tstd = logr.true_posterior_moments(y)
    post, line = run("logistic_nuts", lambda: logr.posterior(600, observe={"y": y}, inference_engine=nuts_,
                                                              burn_in=200))
    draws = np.stack([np.asarray(t.result, np.float64) for t in post.get_values()])
    check(abs(draws.mean() - tmean[0]) < 0.5 * tstd[0] and abs(draws.std() - tstd[0]) < 0.5 * tstd[0],
          f"logistic nuts: {draws.mean()}, {draws.std()} vs {tmean[0]}, {tstd[0]}")
    lines["logistic_regression"] = {**line, "mean": float(draws.mean()), "stddev": float(draws.std()),
                                    "grid": [float(tmean[0]), float(tstd[0])]}

    gp = GaussianProcessRegression(np.linspace(0, 4, 25), learn=("lengthscale",), noise=0.2)
    ygp = gp.synthesize(rng=3, lengthscale=1.0)
    gmean, gstd = gp.true_posterior_moments(ygp)
    post, line = run("gp25_hmc", lambda: gp.posterior(400, observe={"y": ygp}, inference_engine=hmc_, burn_in=200))
    d = np.array([float(np.asarray(t.result).reshape(-1)[0]) for t in post.get_values()])
    check(abs(d.mean() - gmean) < 0.6 * gstd, f"gp25 hmc: {d.mean()} vs {gmean} +- {gstd}")
    lines["gp_25"] = {**line, "mean": float(d.mean()), "grid": [gmean, gstd]}

    lgss = LinearGaussianStateSpace(num_steps=8, a=0.9)
    ys = lgss.synthesize(rng=0)[1]
    sm, _ = lgss.kalman_smoother(ys)
    post, line = run("state_space_nuts", lambda: lgss.posterior_results(
        4000, observe=lgss.observes(ys), burn_in=0, inference_engine=nuts_))
    err = float(np.abs(np.asarray(post.mean, np.float64) - sm).max())
    check(err < 0.08, f"state space nuts: mean path off by {err}")
    lines["state_space"] = {**line, "max_err": err}

    corr, obs_corr = lkj_corr_model()
    post, line = run("lkj_nuts", lambda: corr.posterior_results(2000, observe=obs_corr, inference_engine=nuts_,
                                                                 num_chains=16))
    xs = np.asarray(post.values_numpy(), np.float64)
    ref = corr.posterior_results(ref_n, observe=obs_corr)
    ref_rho = float(np.sum(np.asarray(ref.values_numpy(), np.float64)[:, 0] * ref.weights))
    check(bool(np.all(np.abs(xs[:, 0]) <= 1.0) and np.all(xs[:, 1] > 0)), "lkj nuts: out of support")
    check(abs(xs[:, 0].mean() - ref_rho) < 0.1 and xs[:, 0].mean() > 0.1,
          f"lkj nuts: rho {xs[:, 0].mean()} vs IS {ref_rho}")
    lines["lkj"] = {**line, "rho": float(xs[:, 0].mean()), "prior_is_rho": ref_rho}

    t_mean, t_std = tobit_grid_truth()
    post, line = run("tobit_nuts", lambda: tobit_model().posterior_results(
        2000, observe=TOBIT["observe"], inference_engine=nuts_, num_chains=8))
    v = np.asarray(post.values_numpy(), np.float64)
    check(abs(v.mean() - t_mean) < 0.07 and abs(v.std() - t_std) < 0.07, f"tobit nuts: {v.mean()}, {v.std()}")
    lines["tobit"] = {**line, "mean": float(v.mean()), "stddev": float(v.std()), "grid": [t_mean, t_std]}

    variance, pareto, loc_scale = small_latent_models()
    obs_v = {"x0": 1.2, "x1": -0.8, "x2": 2.1, "x3": 0.3}
    ssq = sum(x * x for x in obs_v.values())
    a_post, b_post = 5.0, 2.0 + ssq / 2.0
    v_mean, v_std = b_post / (a_post - 1.0), math.sqrt(b_post**2 / ((a_post - 1.0) ** 2 * (a_post - 2.0)))
    post, line = run("inverse_gamma_nuts", lambda: variance.posterior_results(20000, observe=obs_v,
                                                                                 inference_engine=nuts_))
    check(abs(float(post.mean) - v_mean) < 0.15 and abs(float(post.stddev) - v_std) < 0.15,
          f"inverse gamma nuts: {float(post.mean)}, {float(post.stddev)} vs {v_mean}, {v_std}")
    lines["inverse_gamma"] = {**line, "mean": float(post.mean), "stddev": float(post.stddev),
                              "truth": [v_mean, v_std]}

    for name, model, engine, observe, tol in (
        ("pareto_hmc", pareto, hmc_, {"y": 2.0}, 0.05),
        ("negative_binomial_nuts", beta_nb_model(), nuts_, {"k0": 7.0, "k1": 9.0}, 0.03),
    ):
        post, line = run(name, lambda: model.posterior_results(20000, observe=observe, inference_engine=engine))
        ref = model.posterior_results(ref_n, observe=observe)
        check(abs(float(post.mean) - float(ref.mean)) < tol and abs(float(post.stddev) - float(ref.stddev)) < tol,
              f"{name}: {float(post.mean)}, {float(post.stddev)} vs IS {float(ref.mean)}, {float(ref.stddev)}")
        lines[name] = {**line, "mean": float(post.mean), "stddev": float(post.stddev),
                       "prior_is": [float(ref.mean), float(ref.stddev)]}

    post, line = run("gumbel_halfnormal_nuts", lambda: loc_scale.posterior_results(
        2000, observe={"y": 1.5}, inference_engine=nuts_, num_chains=16))
    xs = np.asarray(post.values_numpy(), np.float64)
    ref = loc_scale.posterior_results(200_000, observe={"y": 1.5})
    rv, rw = np.asarray(ref.values_numpy(), np.float64), np.asarray(ref.weights, np.float64)
    ref_means = [float(np.sum(rv[:, i] * rw)) for i in range(2)]
    check(bool(np.all(xs[:, 1] > 0)) and all(abs(xs[:, i].mean() - ref_means[i]) < 0.25 for i in range(2)),
          f"gumbel/halfnormal nuts: {xs.mean(0)} vs IS {ref_means}")
    lines["gumbel_halfnormal"] = {**line, "means": xs.mean(0).tolist(), "prior_is_means": ref_means}
    emit({"phase": "nuts_builtin", **lines, "launches": launches})
    return launches, es_mean.tolist()


def phase_gradient_resume(device):
    """tests/test_gradient_resume.py on GUM, HMC and NUTS: 8,000 draws of 64
    chains, a resume from final_gradient_state (burn-in 0, the carried step
    size; mean and stddev within 0.1), a changed observation rescored (50
    steps of burn-in; the new posterior's 2.25 within 0.15, stddev within
    0.1), a pickled state resumed (within 0.25), the validation errors."""
    import pickle
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    g = GRADIENT
    pp.seed(g["seed"] + 5)
    m = GaussianUnknownMean()
    launches, out = {}, {}
    for name, engine in grad_engines().items():
        def runs():
            post = m.posterior_results(8000, observe=OBSERVE, inference_engine=engine, num_chains=64)
            state = post.final_gradient_state
            post2 = m.posterior_results(8000, observe=OBSERVE, inference_engine=engine, initial_trace=state)
            post3 = m.posterior_results(8000, observe={"obs0": 2.0, "obs1": 3.0}, inference_engine=engine,
                                        initial_trace=state, burn_in=50)
            post4 = m.posterior_results(4000, observe=OBSERVE, inference_engine=engine,
                                        initial_trace=pickle.loads(pickle.dumps(state)))
            return state, post2, post3, post4

        (state, post2, post3, post4), launches[f"gradient_resume_{name}"] = counted(device, runs)
        meta = post2.metadata[-1]
        check(state.num_chains == 64 and state.dim == 1 and np.all(state.step_size > 0), f"{name}: {state}")
        check(meta["burn_in"] == 0 and abs(meta["final_step_size"] - float(np.mean(state.step_size))) < 1e-5,
              f"{name} resume: {meta}")
        check(abs(float(post2.mean) - POSTERIOR_MEAN) < 0.1 and abs(float(post2.stddev) - POSTERIOR_STDDEV) < 0.1,
              f"{name} resume: {float(post2.mean)}, {float(post2.stddev)}")
        check(abs(float(post3.mean) - 2.25) < 0.15 and abs(float(post3.stddev) - POSTERIOR_STDDEV) < 0.1,
              f"{name} changed observation: {float(post3.mean)}, {float(post3.stddev)}")
        check(abs(float(post4.mean) - POSTERIOR_MEAN) < 0.25, f"{name} pickled: {float(post4.mean)}")
        out[name] = {"resumed": [float(post2.mean), float(post2.stddev)], "changed": [float(post3.mean),
                     float(post3.stddev)], "pickled_mean": float(post4.mean),
                     "carried_step_size": float(np.mean(state.step_size))}
    try:
        m.posterior_results(100, observe=OBSERVE, inference_engine=grad_engines()["hmc"], initial_trace="no")
        check(False, "gradient_resume: a wrong initial_trace did not raise")
    except RuntimeError as e:
        check("GradientChainState" in str(e), f"gradient_resume: {e}")
    emit({"phase": "gradient_resume", **out, "launches": launches})
    return launches


def phase_laplace(device):
    """tests/test_laplace.py and tests/test_models_builtin.py:178-200 on the
    card: LAPLACE exact on GUM at 4,000 (ESS > 0.99 N, mean and stddev
    within 0.05, both evidence estimates within 0.02 of -8.2395);
    map_estimate on GUM (7.25 and log joint -9.0672 within 0.01); the
    Gamma-Poisson posterior Gamma(13, 3) by reweighting at 20,000 (ESS >
    0.5 N, mean and stddev within 0.05) and its MAP 4.0 within 0.03;
    BayesianLinearRegression at 1,500 (mean within 0.05, variances within
    0.4 of the largest plus 0.003); kernel 3 launched on each run's
    weights at the run's N, and held there against its plain version and
    float64 (``check_stats_values``)."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Gamma, Poisson
    from pyprob_tpu_torch.models import BayesianLinearRegression, GaussianUnknownMean

    pp.seed(GRADIENT["seed"] + 6)
    lap = pp.InferenceEngine.LAPLACE
    launches, weights = {}, {}
    (post, seconds), launches["laplace_gum"] = counted(device, lambda: host_timed(
        lambda: GaussianUnknownMean().posterior_results(4000, observe=OBSERVE, inference_engine=lap)))
    check(post.effective_sample_size > 0.99 * 4000 and abs(float(post.mean) - POSTERIOR_MEAN) < 0.05
          and abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.05 and abs(post.log_evidence - LOG_EVIDENCE) < 0.02
          and abs(post.log_evidence_laplace - LOG_EVIDENCE) < 0.02,
          f"laplace gum: ESS {post.effective_sample_size}, {float(post.mean)}, {float(post.stddev)}, "
          f"{post.log_evidence}, {post.log_evidence_laplace}")
    weights["laplace_gum"] = post.log_weights
    gum = {"seconds": seconds, "ess": post.effective_sample_size, "mean": float(post.mean),
           "stddev": float(post.stddev), "log_evidence": post.log_evidence,
           "log_evidence_laplace": post.log_evidence_laplace}
    res = GaussianUnknownMean().map_estimate(observe=OBSERVE)
    (mode,) = res.values.values()
    check(abs(float(mode) - POSTERIOR_MEAN) < 0.01 and abs(res.log_joint + 9.0672) < 0.01,
          f"map_estimate gum: {mode}, {res.log_joint}")

    class GammaPoisson(pp.Model):
        def forward(self):
            lam = pp.sample(Gamma(3.0, 1.0), name="lam")
            pp.observe(Poisson(lam), name="c0")
            pp.observe(Poisson(lam), name="c1")
            return lam

    obs = {"c0": 4.0, "c1": 6.0}
    gp = GammaPoisson(name="Gamma-Poisson")
    (post, seconds), launches["laplace_gamma_poisson"] = counted(device, lambda: host_timed(
        lambda: gp.posterior_results(20000, observe=obs, inference_engine=lap)))
    check(post.effective_sample_size > 0.5 * 20000 and abs(float(post.mean) - 13 / 3) < 0.05
          and abs(float(post.stddev) - math.sqrt(13) / 3) < 0.05,
          f"laplace gamma-poisson: ESS {post.effective_sample_size}, {float(post.mean)}, {float(post.stddev)}")
    weights["laplace_gamma_poisson"] = post.log_weights
    gamma = {"seconds": seconds, "ess": post.effective_sample_size, "mean": float(post.mean),
             "stddev": float(post.stddev), "map": float(gp.map_estimate(observe=obs).values["lam"])}
    check(abs(gamma["map"] - 4.0) < 0.03, f"map_estimate gamma-poisson: {gamma['map']}")
    blr = BayesianLinearRegression(np.random.default_rng(0).normal(size=(40, 2)))
    y = blr.synthesize([1.5, -0.7], rng=1)
    mean, cov = blr.true_posterior(y)
    (post, seconds), launches["laplace_linear_regression"] = counted(device, lambda: host_timed(
        lambda: blr.posterior(1500, observe={"y": y}, inference_engine=lap)))
    weights["laplace_linear_regression"] = post.log_weights
    draws = np.stack([np.asarray(t.result, np.float64) for t in post.get_values()])
    check(np.abs(draws.mean(0) - mean).max() < 0.05
          and np.abs(draws.var(0) - np.diag(cov)).max() < 0.4 * np.diag(cov).max() + 0.003,
          f"laplace linear regression: {draws.mean(0)}, {draws.var(0)} vs {mean}, {np.diag(cov)}")
    stats_err = {}
    for run, n in (("laplace_gum", 4000), ("laplace_gamma_poisson", 20000), ("laplace_linear_regression", 1500)):
        check(device != "cuda" or launches[run]["log_weight_stats_by_n"].get(n, 0) >= 1,
              f"{run}: kernel 3 not launched at N={n}: {launches[run]['log_weight_stats_by_n']}")
        if device == "cuda":
            # kernel 3 on the run's own weights (float32 on the card; the
            # result keeps them widened to float64, which narrows back exactly)
            lw_np = weights[run].astype(np.float32)
            check(lw_np.shape == (n,), f"{run}: {lw_np.shape[0]} weights, not {n}")
            stats_err[run] = check_stats_values(lw_np, torch.from_numpy(lw_np).to(device), f"{run}'s weights")[2]
    emit({"phase": "laplace", "gum": gum, "map_gum": [float(mode), res.log_joint], "gamma_poisson": gamma,
          "linear_regression": {"seconds": seconds, "mean": draws.mean(0).tolist(), "truth": mean.tolist()},
          "kernel3_rel_err_on_weights": stats_err, "launches": launches})
    return launches


# the tempered and variational engines' phases, after every earlier phase
# (whose draws stay as they were): the JAX tests' criteria at their own
# counts (tests/test_pt.py, tests/test_tempered_smc.py, tests/test_vi.py,
# tests/test_svgd.py, tests/test_gradient_resume.py:122-140,
# tests/test_models_builtin.py:158-181), GaussianMixture's label-switching
# posterior held whole against its float64 grid, kernels 1 and 1b at PT's
# and tempered SMC's rows and kernel 3 at tempered SMC's and VI's N against
# their plain versions
TEMPERED = {"seed": 110, "gmm_ensembles": 256, "gmm_burn_in": 200, "gmm_kept": 200, "gmm_particles": 65_536,
            "gum_particles": 1_000_000, "eight_schools_particles": 20_000, "vi_draws": 1_000_000,
            "reference_is": 400_000, "grid_tol": 0.25, "gmm_log_z_tol": 0.3, "label_share": (0.3, 0.7),
            "eight_schools_tol": 0.6, "kernel3_rel_tol": 1e-6, "svgd_cap": 1024, "banana_seeds": 8}
# seeds on which the JAX package met tests/test_vi.py's Banana criteria
# (flow ESS above fullrank's + 0.3 N, ELBO above, moments within 0.08 of
# prior IS), of seeds run, on the CPU (``python tests/vi_reference.py
# --paths banana --seeds 0 24``): one seed's fit is a draw, so vi holds
# the criteria over TEMPERED["banana_seeds"] seeds, needing the JAX
# package's share of them less four, one at least (as EVENT_IC_JAX_MET)
VI_BANANA_JAX_MET = (14, 24)


def tempered_engines():
    import pyprob_tpu_torch as pp

    E = pp.InferenceEngine
    return {"pt": E.PARALLEL_TEMPERING, "tsmc": E.TEMPERED_SMC, "vi": E.VARIATIONAL_INFERENCE,
            "svgd": E.STEIN_VARIATIONAL_GRADIENT_DESCENT, "hmc": E.HAMILTONIAN_MONTE_CARLO}


def tempered_models():
    """The JAX tests' small models (tests/test_pt.py, test_tempered_smc.py,
    test_vi.py, test_svgd.py), as port models by name."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.distributions import Categorical, Exponential, Normal, Uniform

    class Bimodal(pp.Model):
        def __init__(self, stddev):
            super().__init__(name=f"Bimodal({stddev})")
            self.stddev = stddev

        def forward(self):
            mu = pp.sample(Normal(0.0, 3.0))
            pp.observe(Normal(mu * mu, self.stddev), name="y")
            return mu

    class BoundedBimodal(pp.Model):
        def forward(self):
            mu = pp.sample(Uniform(-10.0, 10.0))
            pp.observe(Normal(mu * mu, 1.0), name="y")
            return mu

    class Hierarchy(pp.Model):
        def __init__(self, both):
            super().__init__(name="Hierarchy")
            self.both = both

        def forward(self):
            x1 = pp.sample(Normal(0.0, 1.0))
            x2 = pp.sample(Normal(x1, 1.0))
            pp.observe(Normal(x2, 1.0), name="y")
            return torch.stack([x1, x2], -1) if self.both else x1

    class UniformGUM(pp.Model):
        def forward(self):
            mu = pp.sample(Uniform(0.0, 20.0))
            lik = Normal(mu, math.sqrt(2.0))
            pp.observe(lik, name="obs0")
            pp.observe(lik, name="obs1")
            return mu

    class Positive(pp.Model):
        def forward(self):
            lam = pp.sample(Exponential(1.0))
            pp.observe(Normal(lam, 0.5), name="y")
            return lam

    class Mix(pp.Model):
        def forward(self):
            mu = pp.sample(Normal(0.0, 5.0))
            k = pp.sample(Categorical(probs=[0.5, 0.5]))
            pp.observe(Normal(mu + torch.where(k == 0, -2.0, 2.0), 1.0), name="y")
            return mu

    class DepMix(pp.Model):
        def forward(self):
            d = pp.sample(Categorical(probs=[0.3, 0.7]))
            # the centers [-3, 3][d] without a tensor made from a list in
            # forward (a copy from the host, which a CUDA graph refuses)
            x = pp.sample(Normal(torch.where(d == 0, -3.0, 3.0), 1.0))
            pp.observe(Normal(x, 0.5), name="y")
            return x

    class Banana(pp.Model):
        def forward(self):
            x = pp.sample(Normal(0.0, 1.0))
            y = pp.sample(Normal(0.0, 2.0))
            pp.observe(Normal(y - x * x, 0.3), name="w")
            return torch.stack([x, y], -1)

    class Disc(pp.Model):
        def forward(self):
            k = pp.sample(Categorical(probs=[0.5, 0.5]))
            pp.observe(Normal(1.0 * k, 1.0), name="y")
            return k

    return {"bimodal": Bimodal(1.0), "bimodal_sharp": Bimodal(0.5), "bounded_bimodal": BoundedBimodal(),
            "hierarchy": Hierarchy(False), "hierarchy_both": Hierarchy(True), "uniform_gum": UniformGUM(),
            "positive": Positive(), "mix": Mix(), "depmix": DepMix(), "banana": Banana(), "disc": Disc()}


def timed_run(device, fn):
    """``fn()`` timed on the host clock with the kernels' launches counted
    and the peak device memory: (result, seconds, launches, peak GiB)."""
    import torch

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (out, seconds), launches = counted(device, lambda: host_timed(fn))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
    return out, seconds, launches, peak_gib


def pt_line(post, seconds, peak_gib):
    """A PT run's figures: ensembles, transitions, acceptance and swap rate,
    potentials (L + 1 a transition: the move's leapfrogs and the gradient
    at the swapped β) and host ms a potential of the step loop."""
    md = post.metadata[-1]
    C, L = md["num_chains"], md["leapfrog_steps"]
    T = md["transitions"] // C
    return {"ensembles": C, "temperatures": md["num_temperatures"], "transitions": T, "burn_in": md["burn_in"],
            "kept": post.length, "acceptance_rate": md["acceptance_rate"],
            "swap_acceptance_rate": md["swap_acceptance_rate"], "final_step_size": md["final_step_size"],
            "potentials": 1 + T * (L + 1), "ms_per_potential": md["step_seconds"] / (T * (L + 1)) * 1e3,
            "step_loop_seconds": md["step_seconds"], "seconds": seconds, "potential_graph": md["potential_graph"],
            "peak_memory_gib": peak_gib}


def check_close(label, got, want, tol):
    check(abs(got - want) < tol, f"{label}: {got} vs {want} (limit {tol})")


def phase_pt_bimodal(device):
    """tests/test_pt.py and tests/test_gradient_resume.py:122-140 at their
    own counts: Bimodal (modes at ±4) one ensemble of 8,000 draws (burn-in
    500) with the share above 0 in (0.3, 0.7), mean |mu| within 0.15 of 4,
    swap rate > 0.2; 8 HMC chains stuck in their modes and 7 of 8 PT
    ensembles hopping (return_chains); GUM within 0.1 / 0.12 (8 ensembles,
    K = 6); BoundedBimodal; the two enumerated models within 0.12 / 0.1 of
    400,000 prior IS; the replica-ladder resume and the rank check; the
    errors.  Returns the launches by run."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    pp.seed(TEMPERED["seed"])
    E, M = tempered_engines(), tempered_models()
    launches, out = {}, {}

    def run(name, fn):
        post, seconds, launches[f"pt_{name}"], peak = timed_run(device, fn)
        return post, (pt_line(post, seconds, peak) if not isinstance(post, list) else {"seconds": seconds})

    post, out["bimodal"] = run("bimodal", lambda: M["bimodal"].posterior_results(
        8000, observe={"y": 16.0}, inference_engine=E["pt"], num_chains=1, burn_in=500))
    vals = np.asarray(post.values_numpy(), np.float64).ravel()
    share, abs_mean = float(np.mean(vals > 0)), float(np.mean(np.abs(vals)))
    check(0.3 < share < 0.7 and abs(abs_mean - 4.0) < 0.15, f"pt bimodal: share {share}, |mu| {abs_mean}")
    check(out["bimodal"]["swap_acceptance_rate"] > 0.2 and post.metadata[-1]["num_temperatures"] == 8,
          f"pt bimodal: {out['bimodal']}")
    out["bimodal"].update(share_above_0=share, mean_abs=abs_mean)
    chains, out["hmc_bimodal_chains"] = run("hmc_bimodal_chains", lambda: M["bimodal"].posterior_results(
        8000, observe={"y": 16.0}, inference_engine=E["hmc"], num_chains=8, burn_in=500, return_chains=True))
    hmc_shares = [float(np.mean(np.asarray(c.values_numpy(), np.float64) > 0)) for c in chains]
    check(all(min(s, 1 - s) < 0.02 for s in hmc_shares), f"hmc bimodal chains not stuck: {hmc_shares}")
    chains, out["bimodal_chains"] = run("bimodal_chains", lambda: M["bimodal"].posterior_results(
        8000, observe={"y": 16.0}, inference_engine=E["pt"], num_chains=8, burn_in=500, return_chains=True))
    pt_shares = [float(np.mean(np.asarray(c.values_numpy(), np.float64) > 0)) for c in chains]
    hopped = sum(0.1 < s < 0.9 for s in pt_shares)
    check(hopped >= 7, f"pt bimodal: {hopped} of 8 ensembles hopped: {pt_shares}")
    out["bimodal_chains"].update(hmc_shares_above_0=hmc_shares, pt_shares_above_0=pt_shares, hopped=hopped)

    post, out["gum"] = run("gum", lambda: GaussianUnknownMean().posterior_results(
        8000, observe=OBSERVE, inference_engine=E["pt"], num_chains=8, burn_in=300, num_temperatures=6))
    check_close("pt gum mean", float(post.mean), POSTERIOR_MEAN, 0.1)
    check_close("pt gum stddev", float(post.stddev), POSTERIOR_STDDEV, 0.12)
    out["gum"].update(mean=float(post.mean), stddev=float(post.stddev))
    post, out["bounded_bimodal"] = run("bounded_bimodal", lambda: M["bounded_bimodal"].posterior_results(
        6000, observe={"y": 9.0}, inference_engine=E["pt"], num_chains=2, burn_in=400))
    vals = np.asarray(post.values_numpy(), np.float64).ravel()
    share, abs_mean = float(np.mean(vals > 0)), float(np.mean(np.abs(vals)))
    check(vals.min() > -10.0 and vals.max() < 10.0 and abs(abs_mean - 3.0) < 0.2 and 0.25 < share < 0.75,
          f"pt bounded bimodal: [{vals.min()}, {vals.max()}], |mu| {abs_mean}, share {share}")
    out["bounded_bimodal"].update(share_above_0=share, mean_abs=abs_mean)
    for name, tol in (("mix", 0.12), ("depmix", 0.1)):
        model = M[name]
        ref = model.posterior_results(TEMPERED["reference_is"], observe={"y": 1.0})
        post, out[name] = run(name, lambda: model.posterior_results(
            12000, observe={"y": 1.0}, inference_engine=E["pt"], num_chains=4, burn_in=300, num_temperatures=4))
        check_close(f"pt {name} mean", float(post.mean), float(ref.mean), tol)
        check_close(f"pt {name} stddev", float(post.stddev), float(ref.stddev), tol)
        out[name].update(mean=float(post.mean), stddev=float(post.stddev),
                         prior_is=[float(ref.mean), float(ref.stddev)])

    gum = GaussianUnknownMean()

    def resume():
        post = gum.posterior_results(4000, observe=OBSERVE, inference_engine=E["pt"], num_chains=16,
                                     num_temperatures=4)
        state = post.final_gradient_state
        post2 = gum.posterior_results(4000, observe=OBSERVE, inference_engine=E["pt"], num_temperatures=4,
                                      initial_trace=state)
        return state, post2

    (state, post2), seconds, launches["pt_resume"], _ = timed_run(device, resume)
    check(state.z.shape == (16, 4, 1) and state.step_size.shape == (16, 4), f"pt resume: {state}")
    check(abs(float(post2.mean) - POSTERIOR_MEAN) < 0.2 and post2.metadata[-1]["burn_in"] == 0,
          f"pt resume: {float(post2.mean)}, {post2.metadata[-1]['burn_in']}")
    hmc_state = gum.posterior_results(1000, observe=OBSERVE, inference_engine=E["hmc"],
                                      num_chains=8).final_gradient_state
    for engine, st in ((E["pt"], hmc_state), (E["hmc"], state)):
        try:
            gum.posterior_results(100, observe=OBSERVE, inference_engine=engine, num_temperatures=4,
                                  initial_trace=st)
            check(False, f"pt resume: a rank-{st.z.ndim} state warm-started {engine.name}")
        except RuntimeError as e:
            check("rank" in str(e), f"pt resume: {e}")
    out["resume"] = {"seconds": seconds, "resumed_mean": float(post2.mean), "state_shape": list(state.z.shape)}
    for fn, kind, text in (
        (lambda: gum.posterior_results(100, observe=OBSERVE, inference_engine=E["pt"], num_temperatures=1),
         ValueError, "num_temperatures"),
        (lambda: M["disc"].posterior_results(100, observe={"y": 1.0}, inference_engine=E["pt"]),
         RuntimeError, "no continuous latent"),
    ):
        try:
            fn()
            check(False, f"pt: no {kind.__name__} ({text})")
        except kind as e:
            check(text in str(e), f"pt: {e}")
    emit({"phase": "pt_bimodal", **out, "launches": launches})
    return launches


def gmm_grid_truth(gm, y):
    """GaussianMixture's (K = 2, fixed weights) exact posterior on the
    float64 grid that ``true_posterior_moments`` integrates (both label
    orders): (means [2], stddevs [2], log evidence), the evidence the
    logsumexp of the normalized log joint over the grid plus log of the cell
    area."""
    means, stds = gm.true_posterior_moments(y)
    lim, n = 3.0, 201
    grid = np.linspace(gm.prior_mean - lim * gm.prior_stddev, gm.prior_mean + lim * gm.prior_stddev, n)
    y = np.asarray(y, np.float64)
    per = (-0.5 * ((y[None, :] - grid[:, None]) / gm.obs_stddev) ** 2 - math.log(gm.obs_stddev)
           - 0.5 * math.log(2 * math.pi))  # [n, data]: log N(y_i; mu, sigma)
    a = np.log(gm.weights[0]) + per[:, None, :]
    b = np.log(gm.weights[1]) + per[None, :, :]
    hi = np.maximum(a, b)
    loglik = np.sum(hi + np.log(np.exp(a - hi) + np.exp(b - hi)), -1)
    logprior = (-0.5 * ((grid - gm.prior_mean) / gm.prior_stddev) ** 2 - math.log(gm.prior_stddev)
                - 0.5 * math.log(2 * math.pi))
    lj = loglik + logprior[:, None] + logprior[None, :]
    top = lj.max()
    log_z = float(top + np.log(np.exp(lj - top).sum()) + 2 * math.log(grid[1] - grid[0]))
    return means, stds, log_z


def check_gmm_whole(label, post, truth):
    """GaussianMixture's label-switching posterior held whole: both sites'
    means and stddevs within TEMPERED["grid_tol"] grid stddevs of the grid,
    and the share of draws with mu0 < mu1 in TEMPERED["label_share"]."""
    means, stds, _ = truth
    v = np.asarray(post.values_numpy(), np.float64)
    w = np.asarray(post.weights, np.float64)
    got_m = (w[:, None] * v).sum(0)
    got_s = np.sqrt((w[:, None] * (v - got_m) ** 2).sum(0))
    tol = TEMPERED["grid_tol"] * stds
    check(bool(np.all(np.abs(got_m - means) < tol) and np.all(np.abs(got_s - stds) < tol)),
          f"{label}: means {got_m}, stddevs {got_s} vs grid {means}, {stds}")
    share = float((w * (v[:, 0] < v[:, 1])).sum())
    lo, hi = TEMPERED["label_share"]
    check(lo < share < hi, f"{label}: share with mu0 < mu1 {share}")
    return {"means": got_m.tolist(), "stddevs": got_s.tolist(), "grid_means": list(means),
            "grid_stddevs": list(stds), "share_mu0_below_mu1": share}


def gmm_kernel_rows(label, rows, floor_ms, where):
    """Kernels 1 and 1b against their plain versions at ``rows`` rows of
    GaussianMixture's observe (``check_gmm_kernels``), each timed beside
    its bound."""
    from pyprob_tpu_torch.ops import kernels as K

    D = BUILTIN["mixture_data"]
    err_f, err_b, inputs, out_k, cot = check_gmm_kernels(rows // D, D, False)
    emit_shape("mixture_normal_log_prob", lambda: K.mixture_normal_log_prob(*inputs),
               lambda: K.mixture_normal_log_prob_plain(*inputs), *mixture_cost(rows, 2), [rows, 2], err_f,
               iters=50, path=where, launch_floor_ms=floor_ms)
    emit_shape("mixture_normal_log_prob_backward",
               lambda: K.mixture_normal_log_prob_backward(*inputs, out_k, cot, need_x=False),
               lambda: K.mixture_normal_log_prob_backward_plain(*inputs, out_k, cot),
               *mixture_backward_cost(rows, 2), [rows, 2], err_b, iters=50, path=where + "'s gradient",
               launch_floor_ms=floor_ms)
    return {"forward_max_abs_err": err_f, "backward_max_abs_err": err_b}


def phase_pt_gmm(device, floor_ms):
    """GaussianMixture K = 2 on 40 data (as gradient_gmm builds it) under PT:
    256 ensembles x 8 temperatures (2,048 replicas), 200 burn-in and 200
    kept transitions; the whole label-switching posterior against the
    float64 grid (``check_gmm_whole``); kernels 1 and 1b once a potential at
    81,920 rows, each held against its plain version there and timed, and
    the tempered potential's gradient at those rows against the plain
    kernels' within GRADIENT["gmm_grad_tol"] (1 + |plain|).  Returns the
    launches."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.inference import hmc
    from pyprob_tpu_torch.models import GaussianMixture

    t = TEMPERED
    pp.seed(t["seed"] + 1)
    D = BUILTIN["mixture_data"]
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D)
    y = gm.synthesize([-2.0, 2.0], rng=0)
    truth = gmm_grid_truth(gm, y)
    C, K = t["gmm_ensembles"], 8
    rows = C * K * D
    post, seconds, launches, peak = timed_run(device, lambda: gm.posterior_results(
        C * t["gmm_kept"], observe={"y": y}, inference_engine=tempered_engines()["pt"], num_chains=C,
        burn_in=t["gmm_burn_in"]))
    line = pt_line(post, seconds, peak)
    whole = check_gmm_whole("pt_gmm", post, truth)
    at_rows = launches["mixture_normal_log_prob_by_rows"].get(rows, 0)
    backward = launches["mixture_normal_log_prob_backward"]
    check(device != "cuda" or (at_rows >= line["potentials"] and backward >= line["potentials"]),
          f"pt_gmm: kernel 1 {at_rows} times at {rows} rows, kernel 1b {backward}, {line['potentials']} potentials")
    out = {**line, **whole, "kernel1_at_replica_rows": at_rows, "kernel1b": backward}
    if device == "cuda":
        out["kernel_checks"] = gmm_kernel_rows("pt_gmm", rows, floor_ms, "GaussianMixture PT potential")
        obs = {"y": torch.as_tensor(y, dtype=torch.float32, device=device)}
        fm = hmc._functionalize(gm, obs, 1.0, "PARALLEL_TEMPERING", (), None)
        rng = np.random.default_rng(t["seed"])
        z = torch.as_tensor((np.array([-2.0, 2.0]) + 1.5 * rng.normal(size=(C * K, 2))).astype(np.float32),
                            device=device)
        beta = torch.as_tensor(np.tile([(k / (K - 1)) ** 2 for k in range(K)], C).astype(np.float32),
                               device=device)
        (u_k, g_k, _, _), counts = counted(device, lambda: fm.value_and_grad_beta(z, beta, obs))
        with PlainKernels():
            u_p, g_p, _, _ = fm.value_and_grad_beta(z, beta, obs)
        tol = GRADIENT["gmm_grad_tol"]
        err = float(((g_k - g_p).abs() / (1 + g_p.abs())).max())
        check(counts["mixture_normal_log_prob_backward"] == 1 and err <= tol
              and bool(((u_k - u_p).abs() <= tol * (1 + u_p.abs())).all()),
              f"pt_gmm tempered gradient vs plain: {err}, launches {counts['mixture_normal_log_prob_backward']}")
        out["tempered_gradient_rel_err"] = err
    emit({"phase": "pt_gmm", "data": D, "grid_log_evidence": truth[2], **out, "launches": launches})
    return launches


def tsmc_line(post, seconds, launches, peak_gib):
    """A tempered-SMC run's figures: stages, final β, log Z, acceptance,
    seconds and ms a stage, kernel 3's launches a stage."""
    md = post.metadata[-1]
    return {"particles": md["num_traces"], "stages": md["stages"], "final_beta": md["final_beta"],
            "log_evidence": post.log_evidence, "acceptance_rate": md["acceptance_rate"],
            "final_step_size": md["final_step_size"], "seconds": seconds, "anneal_seconds": md["anneal_seconds"],
            "ms_per_stage": md["anneal_seconds"] / md["stages"] * 1e3, "host_syncs": md["host_syncs"],
            "kernel3_per_stage": launches["log_weight_stats"] / md["stages"],
            "potential_graph": md["potential_graph"], "peak_memory_gib": peak_gib}


def phase_tempered_smc_gum(device):
    """tests/test_tempered_smc.py at its own counts (GUM 8,000 with log Z
    within 0.15 of -8.2395, final β 1 and >= 2 stages; the hierarchy, the
    bimodal transport, the enumerated models against 400,000 prior IS, the
    knobs at 4,000, the errors), then GUM at 10^6 particles held the same
    way, with kernel 3's launches a stage (28: the check at β = 1, 26
    bisection steps, the log Z increment).  Returns the launches."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianUnknownMean

    t = TEMPERED
    pp.seed(t["seed"] + 2)
    E, M = tempered_engines(), tempered_models()
    launches, out = {}, {}

    def run(name, model, n, observe, **kw):
        post, seconds, launches[f"tsmc_{name}"], peak = timed_run(device, lambda: model.posterior_results(
            n, observe=observe, inference_engine=E["tsmc"], **kw))
        out[name] = tsmc_line(post, seconds, launches[f"tsmc_{name}"], peak)
        return post

    def gum_checks(name, post):
        md = post.metadata[-1]
        check_close(f"{name} mean", float(post.mean), POSTERIOR_MEAN, 0.1)
        check_close(f"{name} stddev", float(post.stddev), POSTERIOR_STDDEV, 0.1)
        check_close(f"{name} log Z", post.log_evidence, LOG_EVIDENCE, 0.15)
        check(md["final_beta"] == 1.0 and md["stages"] >= 2 and 0.2 < md["acceptance_rate"] <= 1.0,
              f"{name}: {md}")
        out[name].update(mean=float(post.mean), stddev=float(post.stddev))

    gum_checks("gum", run("gum", GaussianUnknownMean(), 8000, OBSERVE))
    post = run("hierarchy", M["hierarchy"], 8000, {"y": 2.0})
    check_close("tsmc hierarchy mean", float(post.mean), 2.0 / 3.0, 0.08)
    check_close("tsmc hierarchy log Z", post.log_evidence, -2.135, 0.1)
    post = run("bimodal", M["bimodal"], 8000, {"y": 16.0})
    vals = np.asarray(post.values_numpy(), np.float64).ravel()
    check(abs(float(np.mean(np.abs(vals))) - 4.0) < 0.15 and 0.3 < float(np.mean(vals > 0)) < 0.7,
          f"tsmc bimodal: {np.mean(np.abs(vals))}, {np.mean(vals > 0)}")
    for name, n, tol in (("mix", 8000, 0.12), ("depmix", 12000, 0.1)):
        ref = M[name].posterior_results(t["reference_is"], observe={"y": 1.0})
        post = run(name, M[name], n, {"y": 1.0})
        check_close(f"tsmc {name} mean", float(post.mean), float(ref.mean), tol)
        check_close(f"tsmc {name} stddev", float(post.stddev), float(ref.stddev), tol)
        if name == "depmix":
            check_close("tsmc depmix log Z", post.log_evidence, -2.984, 0.12)
    post = run("knobs", GaussianUnknownMean(), 4000, OBSERVE, resample_threshold=0.7, rejuvenation_steps=3,
               leapfrog_steps=5)
    md = post.metadata[-1]
    check(abs(float(post.mean) - POSTERIOR_MEAN) < 0.15 and md["rejuvenation_steps"] == 3
          and md["leapfrog_steps"] == 5, f"tsmc knobs: {float(post.mean)}, {md}")
    try:
        GaussianUnknownMean().posterior(num_traces=100, inference_engine=E["tsmc"])
        check(False, "tsmc: no observe did not raise")
    except RuntimeError as e:
        check("observe" in str(e), f"tsmc: {e}")
    n = t["gum_particles"]
    post = run("gum_1e6", GaussianUnknownMean(), n, OBSERVE)
    gum_checks("gum_1e6", post)
    stages = post.metadata[-1]["stages"]
    at_n = launches["tsmc_gum_1e6"]["log_weight_stats_by_n"].get(n, 0)
    check(device != "cuda" or at_n == 28 * stages, f"tsmc gum 1e6: kernel 3 {at_n} times at N={n}, {stages} stages")
    out["gum_1e6"]["kernel3_at_n_per_stage"] = at_n / stages
    emit({"phase": "tempered_smc_gum", **out, "launches": launches})
    return launches


def phase_tempered_smc_gmm(device, floor_ms):
    """GaussianMixture (as pt_gmm) under tempered SMC at 65,536 particles:
    the whole label-switching posterior against the grid
    (``check_gmm_whole``), log Z within 0.3 of the grid's log evidence;
    kernels 1 and 1b at 2,621,440 rows in every potential, each held
    against its plain version there and timed.  Returns the launches."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import GaussianMixture

    t = TEMPERED
    pp.seed(t["seed"] + 3)
    D = BUILTIN["mixture_data"]
    gm = GaussianMixture(num_components=2, obs_stddev=0.6, num_data=D)
    y = gm.synthesize([-2.0, 2.0], rng=0)
    truth = gmm_grid_truth(gm, y)
    n = t["gmm_particles"]
    rows = n * D
    post, seconds, launches, peak = timed_run(device, lambda: gm.posterior_results(
        n, observe={"y": y}, inference_engine=tempered_engines()["tsmc"]))
    line = tsmc_line(post, seconds, launches, peak)
    whole = check_gmm_whole("tempered_smc_gmm", post, truth)
    check_close("tempered_smc_gmm log Z", post.log_evidence, truth[2], t["gmm_log_z_tol"])
    md = post.metadata[-1]
    check(md["final_beta"] == 1.0, f"tempered_smc_gmm: final beta {md['final_beta']}")
    # a stage's potentials: the gradient at the new β and M moves of L leapfrogs
    potentials = md["stages"] * (1 + md["rejuvenation_steps"] * md["leapfrog_steps"])
    at_rows = launches["mixture_normal_log_prob_by_rows"].get(rows, 0)
    backward = launches["mixture_normal_log_prob_backward"]
    check(device != "cuda" or (at_rows >= potentials and backward >= potentials),
          f"tempered_smc_gmm: kernel 1 {at_rows} times at {rows} rows, kernel 1b {backward}, {potentials} potentials")
    out = {**line, **whole, "potentials": potentials, "kernel1_at_particle_rows": at_rows, "kernel1b": backward,
           "ms_per_potential": md["anneal_seconds"] / potentials * 1e3}
    if device == "cuda":
        out["kernel_checks"] = gmm_kernel_rows("tempered_smc_gmm", rows, floor_ms,
                                               "GaussianMixture tempered-SMC potential")
    emit({"phase": "tempered_smc_gmm", "data": D, "grid_log_evidence": truth[2], **out, "launches": launches})
    return launches


def phase_tempered_smc_eight_schools(device, nuts_mean):
    """EightSchools under tempered SMC at 20,000 particles, the reference
    the JAX test holds NUTS to (tests/test_models_builtin.py:158-181): the
    NUTS means of nuts_builtin within 0.6 of it.  Returns the launches."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.models import EightSchools

    pp.seed(TEMPERED["seed"] + 4)
    es = EightSchools()
    post, seconds, launches, peak = timed_run(device, lambda: es.posterior_results(
        TEMPERED["eight_schools_particles"], observe=es.observes(), inference_engine=tempered_engines()["tsmc"]))
    mean = np.asarray(post.mean, np.float64)
    diff = float(np.abs(np.asarray(nuts_mean) - mean).max())
    check(diff < TEMPERED["eight_schools_tol"], f"eight_schools: nuts {nuts_mean} vs tempered SMC {mean}")
    emit({"phase": "tempered_smc_eight_schools", **tsmc_line(post, seconds, launches, peak),
          "mean": mean.tolist(), "nuts_mean": list(nuts_mean), "max_abs_diff": diff, "launches": launches})
    return launches


def late_elbo(post):
    """The mean of a VI run's last 100 ELBO estimates.  The JAX tests compare
    the last step's alone, a 32-particle estimate (its standard deviation
    about 0.125 at an exact fit, 0.5·χ²₃₂/32): on GUM it lay from -0.27 to
    +0.099 from log Z over 16 seeds in the JAX package, three within 0.012
    of the +0.1 bound, while the mean of the last 100 lay within 0.025 of log
    Z in the port (``tests/vi_reference.py --paths gum_elbo``); a gap of
    0.14 (meanfield's KL on the hierarchy) is within the last step's
    noise."""
    return float(np.mean(post.metadata[-1]["elbo_history"][-100:]))


def vi_line(post, seconds, peak_gib):
    md = post.metadata[-1]
    return {"guide": md["guide"], "steps": md["vi_steps"], "draws": post.length, "final_elbo": md["final_elbo"],
            "late_elbo": late_elbo(post),
            "ess": float(post.effective_sample_size), "log_evidence": post.log_evidence,
            "fit_seconds": md["fit_seconds"], "ms_per_step": md["fit_seconds"] / max(md["vi_steps"], 1) * 1e3,
            "seconds": seconds, "step_graph": md["step_graph"], "peak_memory_gib": peak_gib}


def phase_vi(device):
    """tests/test_vi.py at its own counts: GUM meanfield (ESS > 0.9 N, log Z
    within 0.05, ELBO <= log Z + 0.1), fullrank over meanfield on the
    hierarchy (each ELBO the mean of the last 100 steps', ``late_elbo``; the
    last step's printed), the bounded and positive supports, the enumerated
    model against 400,000 prior IS, the flow over fullrank on Banana (3,000
    steps; ESS above fullrank's + 0.3 N, the last step's ELBO above, as the
    JAX test and its share, moments within 0.08 of 400,000 prior IS) on as
    many of TEMPERED["banana_seeds"] seeds as VI_BANANA_JAX_MET asks, the
    program cache; then the GUM meanfield fit served at 10^6 reweighted draws with
    kernel 3 on their weights within TEMPERED["kernel3_rel_tol"] of float64
    numpy.  Returns the launches."""
    import torch
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.inference import vi
    from pyprob_tpu_torch.models import GaussianUnknownMean

    t = TEMPERED
    pp.seed(t["seed"] + 5)
    E, M = tempered_engines(), tempered_models()
    launches, out = {}, {}

    def run(name, model, n, observe, **kw):
        post, seconds, launches[f"vi_{name}"], peak = timed_run(device, lambda: model.posterior_results(
            n, observe=observe, inference_engine=E["vi"], **kw))
        out[name] = vi_line(post, seconds, peak)
        return post

    post = run("gum", GaussianUnknownMean(), 4000, OBSERVE)
    md = post.metadata[-1]
    check(abs(float(post.mean) - POSTERIOR_MEAN) < 0.1 and abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.1
          and post.effective_sample_size > 0.9 * 4000 and abs(post.log_evidence - LOG_EVIDENCE) < 0.05
          and md["guide"] == "meanfield" and md["latent_dim"] == 1 and late_elbo(post) <= post.log_evidence + 0.1,
          f"vi gum: {out['gum']}")
    posts = {g: run(f"hierarchy_{g}", M["hierarchy"], 4000, {"y": 2.0}, guide=g) for g in ("meanfield", "fullrank")}
    for g, p in posts.items():
        check(abs(float(p.mean) - 2.0 / 3.0) < 0.08 and abs(p.log_evidence + 2.135) < 0.1,
              f"vi hierarchy {g}: {float(p.mean)}, {p.log_evidence}")
    check(posts["fullrank"].effective_sample_size > posts["meanfield"].effective_sample_size + 0.2 * 4000
          and late_elbo(posts["fullrank"]) > late_elbo(posts["meanfield"]),
          f"vi hierarchy: fullrank {out['hierarchy_fullrank']} vs meanfield {out['hierarchy_meanfield']}")
    post = run("uniform_gum", M["uniform_gum"], 4000, OBSERVE)
    vals = np.asarray(post.values_numpy(), np.float64)
    check(abs(float(post.mean) - 8.5) < 0.12 and abs(float(post.stddev) - 1.0) < 0.12 and vals.min() > 0.0
          and vals.max() < 20.0, f"vi bounded: {float(post.mean)}, {float(post.stddev)}")
    post = run("positive", M["positive"], 4000, {"y": 2.0})
    check(np.asarray(post.values_numpy()).min() > 0.0 and abs(float(post.mean) - 1.76) < 0.1,
          f"vi positive: {float(post.mean)}")
    ref = M["mix"].posterior_results(t["reference_is"], observe={"y": 1.0})
    post = run("mix", M["mix"], 8000, {"y": 1.0})
    check(abs(float(post.mean) - float(ref.mean)) < 0.15 and abs(float(post.stddev) - float(ref.stddev)) < 0.15,
          f"vi mix: {float(post.mean)}, {float(post.stddev)} vs IS {float(ref.mean)}, {float(ref.stddev)}")
    ref = M["banana"].posterior_results(t["reference_is"], observe={"w": 0.0})
    ref_m, ref_s = np.asarray(ref.mean, np.float64), np.asarray(ref.stddev, np.float64)
    banana = []
    for seed in range(t["banana_seeds"]):
        pp.seed(t["seed"] + 100 + seed)
        fr = run(f"banana_fullrank_{seed}", M["banana"], 8000, {"w": 0.0}, guide="fullrank", vi_steps=3000)
        fl = run(f"banana_flow_{seed}", M["banana"], 8000, {"w": 0.0}, guide="flow", vi_steps=3000,
                 learning_rate=0.01)
        fl_m, fl_s = np.asarray(fl.mean, np.float64), np.asarray(fl.stddev, np.float64)
        met = {"ess": fl.effective_sample_size > fr.effective_sample_size + 0.3 * 8000,
               "elbo": fl.metadata[-1]["final_elbo"] > fr.metadata[-1]["final_elbo"],
               "moments": bool(np.abs(fl_m - ref_m).max() < 0.08 and np.abs(fl_s - ref_s).max() < 0.08)}
        banana.append(all(met.values()))
        out[f"banana_flow_{seed}"].update(mean=fl_m.tolist(), stddev=fl_s.tolist(), met=met)
    need = max(1, -(-t["banana_seeds"] * VI_BANANA_JAX_MET[0] // VI_BANANA_JAX_MET[1]) - 4)
    out["banana"] = {"seeds_met": sum(banana), "seeds": len(banana), "needed": need,
                     "prior_is": [ref_m.tolist(), ref_s.tolist()]}
    check(sum(banana) >= need, f"vi banana: the flow met the JAX test's criteria on {sum(banana)} of "
          f"{len(banana)} seeds, {need} needed: {out}")
    gum = GaussianUnknownMean()
    gum.posterior_results(500, observe=OBSERVE, inference_engine=E["vi"], vi_steps=200)
    cached = len(vi._vi_cache)
    post = gum.posterior_results(500, observe={"obs0": -3.0, "obs1": -4.0}, inference_engine=E["vi"], vi_steps=200)
    check(len(vi._vi_cache) == cached and abs(float(post.mean) + 2.75) < 0.15, f"vi cache: {float(post.mean)}")
    n = t["vi_draws"]
    post = run("gum_1e6", gum, n, OBSERVE)
    check(abs(float(post.mean) - POSTERIOR_MEAN) < 0.1 and abs(post.log_evidence - LOG_EVIDENCE) < 0.05,
          f"vi gum 1e6: {out['gum_1e6']}")
    check(device != "cuda" or launches["vi_gum_1e6"]["log_weight_stats_by_n"].get(n, 0) >= 1,
          f"vi gum 1e6: kernel 3 not launched at N={n}")
    if device == "cuda":
        lw_np = np.asarray(post.log_weights, np.float64).astype(np.float32)
        *_, rel = check_stats_values(lw_np, torch.from_numpy(lw_np).to(device), "vi gum 1e6's weights")
        check(rel <= t["kernel3_rel_tol"], f"vi gum 1e6: kernel 3 {rel} relative of float64")
        out["gum_1e6"]["kernel3_rel_err_on_weights"] = rel
    emit({"phase": "vi", **out, "launches": launches})
    return launches


def phase_svgd(device):
    """tests/test_svgd.py at its own counts (512 particles, 600 or 800
    steps): GUM, the hierarchy's correlation, the bounded and positive
    supports, both modes of the sharp bimodal model, the enumerated model
    against 400,000 prior IS, the program cache (its second run at 600 steps:
    the JAX test's 100 leave the ensemble in transit); then GUM and the hierarchy
    at the default cap of 1,024 particles with their ms a step.  Returns the
    launches."""
    import pyprob_tpu_torch as pp
    from pyprob_tpu_torch.inference import svgd
    from pyprob_tpu_torch.models import GaussianUnknownMean

    t = TEMPERED
    pp.seed(t["seed"] + 6)
    E, M = tempered_engines(), tempered_models()
    launches, out = {}, {}

    def run(name, model, n, observe, particles=512, steps=600, **kw):
        post, seconds, launches[f"svgd_{name}"], peak = timed_run(device, lambda: model.posterior_results(
            n, observe=observe, inference_engine=E["svgd"], svgd_particles=particles, svgd_steps=steps, **kw))
        md = post.metadata[-1]
        out[name] = {"particles": md["svgd_particles"], "steps": md["svgd_steps"], "draws": post.length,
                     "final_mean_update_norm": md["final_mean_update_norm"], "fit_seconds": md["fit_seconds"],
                     "ms_per_step": md["fit_seconds"] / steps * 1e3, "seconds": seconds,
                     "step_graph": md["step_graph"], "peak_memory_gib": peak}
        return post

    def check_gum(name, post, n, particles):
        md = post.metadata[-1]
        check(post.length == n and abs(float(post.mean) - POSTERIOR_MEAN) < 0.1
              and abs(float(post.stddev) - POSTERIOR_STDDEV) < 0.15 and md["latent_dim"] == 1
              and md["svgd_particles"] == particles and np.isfinite(md["final_mean_update_norm"])
              and post.effective_sample_size > 0.99 * n, f"svgd {name}: {float(post.mean)}, {float(post.stddev)}")

    def check_hierarchy(name, post):
        xs = np.asarray(post.values_numpy(), np.float64)
        corr = float(np.corrcoef(xs[:, 0], xs[:, 1])[0, 1])
        check(abs(xs[:, 0].mean() - 2.0 / 3.0) < 0.1 and abs(xs[:, 1].mean() - 4.0 / 3.0) < 0.1
              and abs(corr - 0.5) < 0.15 and abs(xs[:, 0].std() - math.sqrt(2.0 / 3.0)) < 0.12,
              f"svgd {name}: means {xs.mean(0)}, corr {corr}, std {xs[:, 0].std()}")
        out[name]["corr"] = corr

    check_gum("gum", run("gum", GaussianUnknownMean(), 2000, OBSERVE), 2000, 512)
    check_hierarchy("hierarchy", run("hierarchy", M["hierarchy_both"], 512, {"y": 2.0}))
    post = run("uniform_gum", M["uniform_gum"], 1024, OBSERVE)
    vals = np.asarray(post.values_numpy(), np.float64)
    check(vals.min() > 0.0 and vals.max() < 20.0 and abs(float(post.mean) - 8.5) < 0.15
          and abs(float(post.stddev) - 1.0) < 0.15, f"svgd bounded: {float(post.mean)}, {float(post.stddev)}")
    post = run("positive", M["positive"], 512, {"y": 2.0})
    check(np.asarray(post.values_numpy()).min() > 0.0 and abs(float(post.mean) - 1.76) < 0.12,
          f"svgd positive: {float(post.mean)}")
    post = run("bimodal", M["bimodal_sharp"], 512, {"y": 4.0}, steps=800)
    vals = np.asarray(post.values_numpy(), np.float64)
    check(0.2 < float(np.mean(vals > 0)) < 0.8 and abs(np.abs(vals).mean() - 2.0) < 0.2,
          f"svgd bimodal: {np.mean(vals > 0)}, {np.abs(vals).mean()}")
    ref = M["mix"].posterior_results(t["reference_is"], observe={"y": 1.0})
    post = run("mix", M["mix"], 2048, {"y": 1.0}, steps=800)
    check(abs(float(post.mean) - float(ref.mean)) < 0.2 and abs(float(post.stddev) - float(ref.stddev)) < 0.2,
          f"svgd mix: {float(post.mean)}, {float(post.stddev)} vs IS {float(ref.mean)}, {float(ref.stddev)}")
    gum = GaussianUnknownMean()
    # the JAX test's second run takes 100 steps, which leave the ensemble in
    # transit (mean below -2.0 in 4 of 8 seeds in the JAX package, 7 of 8 in
    # the port, on the CPU): 600 here, the other tests' count
    gum.posterior_results(256, observe=OBSERVE, inference_engine=E["svgd"], svgd_particles=256, svgd_steps=100)
    cached = len(svgd._svgd_cache)
    post = gum.posterior_results(256, observe={"obs0": -3.0, "obs1": -4.0}, inference_engine=E["svgd"],
                                 svgd_particles=256, svgd_steps=600)
    check(len(svgd._svgd_cache) == cached and float(post.mean) < -2.0, f"svgd cache: {float(post.mean)}")
    cap = t["svgd_cap"]
    check_gum("gum_1024", run("gum_1024", GaussianUnknownMean(), 4096, OBSERVE, particles=cap), 4096, cap)
    check_hierarchy("hierarchy_1024", run("hierarchy_1024", M["hierarchy_both"], cap, {"y": 2.0}, particles=cap))
    emit({"phase": "svgd", **out, "launches": launches})
    return launches


def main():
    kind, smi = phase_device()
    import torch
    import pyprob_tpu_torch as pp

    pp.set_device("cuda")
    pp.set_verbosity(1)
    pp.seed(0)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on: the port computes in full f32")
    check(not torch.backends.cudnn.allow_tf32, "TF32 convolutions are on: the port computes in full f32")
    phase_build()
    rows = phase_kernels() + phase_linalg_kernels()
    floor_ms = phase_launch_floor()
    phase_prior_is("cuda", NUM_TRACES)
    model, launches = phase_guided_is("cuda", NUM_TRACES, lstm_dim=512)
    phase_card_vs_cpu(model, 4096)
    phase_grad_card_vs_cpu(512, TRAIN_ROWS)
    # each main-path phase's launches, by phase: the training phases launch
    # the mixture kernels at the arm's batch rows, the serving phases at
    # chunks of up to 2^18
    path = {"guided_is": launches}
    trained_arms = {}
    for arm in ARMS:
        trained, path[f"train_lstm{arm['lstm_dim']}"] = phase_train("cuda", arm)
        trained_arms[arm["lstm_dim"]] = trained
        path[f"guided_is_trained_lstm{arm['lstm_dim']}"] = phase_guided_is_trained(
            "cuda", trained, arm, NUM_TRACES)
    prior_fraction, path["marsaglia_prior_is"] = phase_marsaglia_prior_is("cuda", NUM_TRACES)
    phase_grad_card_vs_cpu(MARSAGLIA["lstm_dim"], MARSAGLIA["batch_size"], marsaglia=True)
    marsaglia, path["marsaglia_train"] = phase_marsaglia_train("cuda")
    path["marsaglia_guided_is_trained"] = phase_marsaglia_guided_is_trained(
        "cuda", marsaglia, NUM_TRACES, prior_fraction)
    phase_marsaglia_defensive_is("cuda", marsaglia, NUM_TRACES)
    # bench.py's while-loop Marsaglia arm on the interpreter tier, and GUM
    # served by lockstep
    phase_marsaglia_interpreter_prior_is("cuda")
    interpreted, path["marsaglia_interpreter_train"], train_rows = phase_marsaglia_interpreter_train("cuda")
    path["marsaglia_lockstep_is"] = phase_marsaglia_lockstep_is("cuda", interpreted)
    path["gum_lockstep_is"] = phase_gum_lockstep_is("cuda", trained_arms[128])
    # the feedforward network on both tiers and in lockstep, then saving
    # and loading (which continues the networks: after their last serving)
    ff_gum, path["ff_train"] = phase_ff_train("cuda")
    path["ff_guided_is_trained"] = phase_ff_guided_is_trained("cuda", ff_gum, NUM_TRACES)
    phase_ff_grad_card_vs_cpu()
    ff_marsaglia, path["marsaglia_ff_interpreter_train"], ff_rows = phase_marsaglia_ff_interpreter_train("cuda")
    path["marsaglia_ff_lockstep_is"] = phase_marsaglia_ff_lockstep_is("cuda", ff_marsaglia, ff_gum)
    phase_save_load("cuda", {
        "ff_gum": (ff_gum, ff_train_kwargs()),
        "lstm128": (trained_arms[128], train_kwargs(ARMS[0], TRAIN_SEGMENTS)),
    })
    phase_interpreter_kernel_shapes(train_rows, floor_ms, ff_rows)
    # pyprob's HMM IC tests (categorical heads, one-hot sample embeddings),
    # the Beta head (kernels 2 and 2b), the LogNormal-mixture head, and
    # Poisson on both tiers
    phase_distributions("cuda")
    new_path = {}
    hmm_prior_fraction, new_path["hmm_prior_is"] = phase_hmm_prior_is("cuda", NUM_TRACES)
    hmm_models = []
    for network in (pp.InferenceNetwork.LSTM, pp.InferenceNetwork.FEEDFORWARD):
        name = network.name.lower()
        hmm, new_path[f"hmm_train_{name}"] = phase_hmm_train("cuda", network)
        new_path[f"hmm_guided_is_trained_{name}"] = phase_hmm_guided_is_trained(
            "cuda", hmm, NUM_TRACES, hmm_prior_fraction)
        hmm_models.append(hmm)
    phase_hmm_lockstep_rounds("cuda", hmm_models)
    new_path["beta_bernoulli_train"], new_path["beta_bernoulli_ic"] = phase_beta_bernoulli_ic("cuda", NUM_TRACES)
    new_path["gamma_poisson_train"], new_path["gamma_poisson_ic"] = phase_gamma_poisson_ic("cuda", NUM_TRACES)
    new_path["branching_prior_is"], new_path["branching_interpreter_is"] = phase_branching_prior_is("cuda")
    # the heavy-tailed family's StudentT-mixture head on both tiers and in
    # lockstep, the Beta head under NegativeBinomial observes (kernels 2
    # and 2b), the Censored and ZeroInflated likelihoods, a Geometric latent
    new_path["laplace_ic_train"], new_path["laplace_ic"] = phase_laplace_ic("cuda", NUM_TRACES)
    new_path["laplace_lockstep_train"], new_path["laplace_lockstep"] = phase_laplace_lockstep("cuda")
    new_path["beta_nb_train"], new_path["beta_nb_ic"] = phase_beta_nb_ic("cuda", NUM_TRACES)
    new_path["tobit_prior_is"] = phase_tobit_prior_is("cuda")
    new_path["zip_prior_is"] = phase_zip_prior_is("cuda")
    new_path["geometric_prior_is"], new_path["geometric_interpreter_is"] = phase_geometric_prior_is("cuda")
    # the event-shaped slice: the new classes' draws and densities, IC on
    # MultivariateNormal, Dirichlet and LKJCholesky latents on both tiers
    # and in lockstep, prior IS of the conjugate vector models (kernel 3 in
    # every posterior)
    phase_event_distributions("cuda")
    phase_lkj_cpc_density("cuda")
    for name, networks in (("mvn", ("FEEDFORWARD", "LSTM")), ("dirichlet", ("FEEDFORWARD", "LSTM")),
                           ("lkj", ("FEEDFORWARD",))):
        for network in networks:
            new_path.update(phase_event_ic("cuda", name, network))
    new_path["dircat_prior_is"] = phase_conjugate_prior_is("cuda", "dircat_prior_is", dircat_model(), DIRCAT)
    new_path["mvn_conjugate_prior_is"] = phase_conjugate_prior_is(
        "cuda", "mvn_conjugate_prior_is", mvn_conjugate_model(), MVN_CONJUGATE)
    phase_new_path_kernel_shapes(new_path, floor_ms)
    path.update(new_path)
    for N, num_traces in GP_RUNS:
        path[f"gp_is_{N}x{num_traces}"] = phase_gp_is("cuda", N, num_traces)
    path[f"gp_is_{GP_LARGE[0]}x{GP_LARGE[1]}"] = phase_gp_is("cuda", *GP_LARGE, warm_up=False)
    path["gp_card_vs_cpu"] = phase_gp_card_vs_cpu("cuda")
    # the Empirical slice, after every earlier phase (whose draws it leaves
    # as they were): the result surface on served posteriors, the five
    # built-in families' prior IS (GaussianMixture's observe on kernel 1),
    # kernel 1 at that shape, IC on the state-space model
    path["empirical_surface"], path["empirical_branching"] = phase_empirical_surface("cuda", trained_arms[128])
    path.update(phase_builtin_models_is("cuda"))
    phase_gmm_kernel_shapes(floor_ms)
    path["lgss_ic_feedforward_train"], path["lgss_ic_feedforward"] = phase_lgss_ic("cuda")
    # the rest of learn_inference_network, after every earlier phase (whose
    # draws stay as they were): LARC, the CNN embeddings and MiniCaptcha,
    # training from trace files with validation and keep_best, and
    # file-backed results
    phase_larc_card_vs_cpu()
    path["larc_train"] = phase_larc_train("cuda")
    phase_cnn_card_vs_cpu()
    for network in ("FEEDFORWARD", "LSTM"):
        path.update(phase_mini_captcha_ic("cuda", network))
    with tempfile.TemporaryDirectory() as tmp:
        offline, dirs = phase_offline("cuda", tmp)
        path.update(offline)
        path["offline_gather_train"] = phase_offline_gather_train("cuda", tmp)
        path.update(phase_keep_best("cuda", dirs))
        path.update(phase_empirical_file("cuda", tmp, trained_arms[128]))
        # the MCMC engines and the rest of the Model API, after every
        # earlier phase (whose draws stay as they were): GUM, resumes and
        # rejection blocks (kernel 3 in the warm starts), the GP chains
        # (kernel 4) and GaussianMixture's (kernel 1), then
        # posterior_predictive, condition and ParallelModel
        path.update(phase_mcmc_gum("cuda"))
        path["mcmc_resume"] = phase_mcmc_resume("cuda", tmp)
        path.update(phase_mcmc_marsaglia("cuda"))
        path["mcmc_gp"] = phase_mcmc_gp("cuda", floor_ms)
        path.update(phase_mcmc_gmm("cuda", floor_ms))
        path.update(phase_posterior_predictive("cuda", trained_arms[128]))
        phase_conditional("cuda")
        torch.cuda.empty_cache()  # the workers make CUDA contexts of their own
        path["parallel"] = phase_parallel("cuda", tmp, trained_arms[128])
    # SMC on both tiers, after every earlier phase (whose draws stay as they
    # were): the staged-replay filter at 10^6 particles in one batch, guided
    # by the trained GUM and Marsaglia networks, and the interpreter filter
    smc_path = phase_smc_gum("cuda")
    smc_path["smc_lgss"] = phase_smc_lgss("cuda")
    smc_path["smc_hmm"] = phase_smc_hmm("cuda")
    smc_path["smc_marsaglia"] = phase_smc_marsaglia("cuda")
    smc_path.update(phase_smc_guided(
        "cuda", {"lstm128": trained_arms[128], "lstm512": trained_arms[512], "ff": ff_gum}, marsaglia))
    smc_path.update(phase_smc_interpreter("cuda"))
    phase_smc_kernel_shapes(smc_path, floor_ms)
    path.update(smc_path)
    # the gradient engines, after every earlier phase (whose draws stay as
    # they were): HMC and NUTS chains on GUM and GaussianMixture (kernels 1
    # and 1b in every potential) and on the GP at N = 256 (kernel 4 under
    # autograd), each gradient against its plain versions, the JAX tests'
    # criteria, resumes, and LAPLACE / map_estimate (kernel 3 on the weights)
    path.update(phase_gradient_gum("cuda"))
    path.update(phase_gradient_gmm("cuda", floor_ms))
    path["hmc_gp"] = phase_hmc_gp("cuda", floor_ms)
    phase_gradient_card_vs_cpu("cuda")
    nuts_launches, eight_schools_nuts = phase_nuts_builtin("cuda")
    path.update(nuts_launches)
    path.update(phase_gradient_resume("cuda"))
    path.update(phase_laplace("cuda"))
    # the tempered and variational engines, after every earlier phase (whose
    # draws stay as they were): parallel tempering and tempered SMC on the
    # JAX tests' models and on GaussianMixture's label-switching posterior
    # (kernels 1 and 1b in every potential), EightSchools' tempered-SMC
    # reference for nuts_builtin's NUTS, VI and SVGD (kernel 3 on the
    # weights and in every bisection step)
    t_new = time.perf_counter()
    path.update(phase_pt_bimodal("cuda"))
    path["pt_gmm"] = phase_pt_gmm("cuda", floor_ms)
    path.update(phase_tempered_smc_gum("cuda"))
    path["tempered_smc_gmm"] = phase_tempered_smc_gmm("cuda", floor_ms)
    path["tempered_smc_eight_schools"] = phase_tempered_smc_eight_schools("cuda", eight_schools_nuts)
    path.update(phase_vi("cuda"))
    path.update(phase_svgd("cuda"))
    emit({"phase": "tempered_variational_seconds", "seconds": time.perf_counter() - t_new})
    emit({"phase": "launches_by_phase", "launches": {
        phase: {name: n for name, n in counts.items() if n} for phase, counts in path.items()
    }})
    phase_stats_shapes(path)
    for row in rows:
        row["launches"] = sum(counts[row["name"]] for counts in path.values())
        check(row["launches"] >= 1, f"the main path never launched {row['name']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }})


if __name__ == "__main__":
    main()
