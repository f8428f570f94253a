"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (each prints JSON lines; any
failure exits non-zero without a result line):

1. device    — the card (nvidia-smi name and power limit), torch and CUDA
               versions, and the build of the hand-written kernels from
               src/repro_torch/kernels/csrc with nvcc (sm_90a);
2. kernels   — every kernel of the main path against its plain PyTorch
               version at the main path's shapes (n = 8 agents, P =
               124,668,672 parameters of paper-100m) in bf16 and fp32,
               plus the NaN / +-inf / tie hazards at a small width; times
               of the kernel, the plain version and the one-call PyTorch
               library yardstick, and the bound;
3. train     — the main path: the synchronous Byzantine-robust step on the
               full-width paper-100m (bf16, n = 8, f = 2, sign_flip,
               seq 256, 2 sequences per agent, remat on), 1 step each of
               trimmed_mean, coordinate_median and krum through
               ``train_loop`` with impl="auto", after one untimed warm-up
               step per rule; the launch counts must show that every
               step went through its kernels.  A traced step per rule
               (after a warm-up and an untraced step) then splits the
               device time by device event;
4. kernel vs gather — one full-width step with impl="kernel" against
               impl="gather" from the same state and batch: the same
               arena and loss, median and krum aggregates exact, trimmed
               mean within 3e-6 (phases 4b and 4d run as one pass).

The async path (ROADMAP.md slice 2) adds:

2b. masked kernels — K5 masked_coord_stat, K6 masked_gram, K7
               masked_weighted_sum and the imputed mean (through K4)
               against their plain versions at n = 8, P = 124,668,672 in
               fp32 (the async arena) and bf16, masks of 6, 1 and 0 of 8
               arrived, weights one-hot on a live row, one-hot on a ghost
               and a {0,1} set; K5 at full width at the elastic churn
               run's bucket masks (3 and 4 of 4, 6 of 6, 7 of 8 live,
               ghost rows repeating the first slot); the NaN / +-inf /
               tie hazards and n = 3, 4, 6 at a small width; times,
               library yardsticks and bounds;
3b. async    — the full-width configuration of phase 3 under stragglers
               (lognormal 0.8, quorum 6, max staleness 3: 6 deliveries and
               staleness up to 2 every step, no step pure) through
               ``train_loop(sim=...)``: 1 warm-up step, then 1 timed step
               per rule; the launch counts must show one K5 per step
               (median, trimmed) or one each of K4 (the imputed mean), K6,
               K3 and K7 (krum).  Then the elastic trimmed_mean
               (f=frac(0.25), n=elastic(8, (4, 6, 8))) for 8 steps under
               Churn(rate=0.25, mean_out=2.0): live 8, 6, 4, 6, 6, 7, 4,
               3, exactly 3 bucket steps and 1 synchronous step built.  A
               traced async step per rule splits the device time;
4b. masked kernel vs gather — one full-width async step per rule with
               impl="kernel" against impl="gather" from the same state,
               buffer, batch and trace row, and the elastic
               trimmed_mean's bucket steps with ghost rows (3 live in
               bucket 4, 7 live in bucket 8): median and krum exact,
               trimmed mean within 3e-6.

The selection family (ROADMAP.md slice 3) adds:

2c. selection kernels — K8 cge_select, K9 multi_krum_order, K10
               iterative_order, K11 ordered_apply and K13 bulyan_coord
               against their plain versions at full width (P =
               124,668,672) in bf16 and fp32: K8-K10 on the full-width
               Gram (asserted bitwise symmetric) at n = 8 and 11, K11
               with the orders of multi_krum (m = 3), m_krum (m = 3) and
               mda (k = n - f = 6) at n = 8, K13 at n = 11 (theta 7, beta
               3) and n = 8 (theta 4, beta 1); the NaN / +-inf /
               duplicate-row / pair-tie hazards at a small width and n =
               3, 4, 8, 11, 16; times, yardsticks and bounds; then K3
               and K10 at n = 1..17, 24, 32, 33, 48, 64 (three pick
               counts, every row equal, the pair tie, a NaN Gram), each
               bitwise equal to its plain version and to a repeat, timed
               beside its predicted ms;
3c. selection train — the phase-3 configuration for cge, multi_krum (m
               = 3), m_krum (m = 3) and mda at n = 8 and bulyan at n = 11
               (f = 2): 1 warm-up step, then 1 timed step per rule; the
               launch counts must show K2 and CGE's apply (cge), K2, K9, K11
               (multi_krum), K2, K10, K11 (m_krum), K2, K11 (mda) and K2,
               K10, K13 (bulyan) once per step; a traced step of cge,
               multi_krum and bulyan (m_krum and mda launch no kernel
               that those leave out);
4c. selection kernel vs gather — one full-width step per rule with
               impl="kernel" against impl="gather" from the same state and
               batch: the same arena, equal losses, the selected set and
               pick order equal, the aggregates within 3e-6.

The masked selection family and sign_sgd (ROADMAP.md slice 3b) add:

2.  K15 sign_vote against its plain version at full width in bf16 and
               fp32 (with the other phase-2 kernels), its NaN / +-inf /
               +-0 hazards at a small width;
2d. masked selection kernels — K12 masked_ordered_apply with the orders
               of multi_krum (m = 3), m_krum (m = 3) and mda (k = 6) on
               the imputed Gram of a 6-of-8 mask, and a hand-made order
               with a ghost (absent) row picked first; K14
               masked_bulyan_coord at n = 11 (9 arrived) on K10's theta
               picks, and with a ghost forced into the selection; K16
               masked_sign_vote at masks of 6, 1 and 0 of 8; fp32 (the
               async buffer) and bf16, full width; hazards at a small
               width; times, yardsticks and bounds;
3.  sign_sgd among the synchronous rules (K15 once a step);
3d. async selection — cge, multi_krum (m = 3), m_krum (m = 3), mda and
               sign_sgd at n = 8 under the phase-3b stragglers, bulyan at
               n = 11 with quorum 9 (9 of 11 arrive, no step pure): 1
               warm-up step, then 1 timed step per rule; the launch
               counts must show K4 (the imputed mean) and K6, then cge
               its masked apply, multi_krum K9 K12, m_krum K10 K12, mda
               K12, bulyan K10 K14, and sign_sgd K16, once a step; a
               traced async step for multi_krum and bulyan;
4.  sign_sgd kernel vs gather, exact;
4d. masked selection kernel vs gather — one full-width async step per
               rule of phase 3d with impl="kernel" against impl="gather"
               from the same state, buffer, batch and trace row: the same
               masked arena, the same selection and pick order on the
               imputed stack (and whether a ghost row is selected), the
               aggregates within 3e-6, sign_sgd exact.

4c. (also) the bulyan step at n = 11 on the seed-1 parameters and batch
               (ROADMAP.md P12): the two equal sign_flip rows' gather
               distances bitwise equal, and the same pick order on the
               kernel and gather paths; then what the repair costs: the
               gather distances and the gather aggregation of krum (n =
               8) and bulyan (n = 11) timed with the pair dots and with
               the library product they replaced.

The compressed exchange, agg_dtype int8 / float8_e4m3fn (ROADMAP.md
slice 4a), adds:

2e. scaled kernels — K18 scaled_coord_stat (median and trimmed), K19
               scaled_masked_coord_stat, K20 scaled_masked_sign_vote and
               K15 on the codes against their plain versions at n = 8, P =
               124,668,672, int8 and fp8 codes of a seeded fp32 arena
               (quantize_rows on the card, timed with its peak memory
               rise on lines of its own, from the fp32 arena and from the
               bf16 arena of the synchronous step),
               masks of 6, 1 and 0 of 8 arrived; the dequant-copy gate
               (aggregate_flat(codes, mask=, weights=, scale=) of each
               scaled rule raises the peak device memory by at most 3 * P
               * 4 bytes on impl="kernel", by at least n * P * 4 on
               impl="gather"); the NaN / inf / zero-row / inf-scale
               hazards at a small width; times, yardsticks and bounds;
3x. compressed train — the phase-3 configuration with agg_dtype int8 and
               fp8, and the phase-3b stragglers with int8, for
               coordinate_median, trimmed_mean, sign_sgd and krum: 1
               warm-up step, then 1 timed step per rule; the launch
               counts must show K18 (sync median, trimmed), K15 (sync
               sign), K19 (async median, trimmed), K20 (async sign) once a
               step, and krum its usual kernels and one engine-level
               dequantization a step (none for the other rules);
4x. compressed kernel vs gather — one full-width synchronous step per
               rule in int8 and fp8 and one async step per rule in int8,
               impl="kernel" against impl="gather" from the same state:
               codes and scales bitwise equal, equal losses, median, sign
               and krum exact, trimmed mean within 3e-6.

sparse_mean (ROADMAP.md slice 4b) and the legacy ``ops`` sort paths add:

2f. sparse kernels — K17 sparse_masked_weighted_mean and K21
               scaled_sparse_masked_weighted_mean against their plain
               versions at n = 8, P = 124,668,672, on the real (n, P) bf16
               arena of one sparse_mean step (the embedding rows a batch
               does not touch are 0: not sent; the share of columns nobody
               sent is printed): bf16 with mask and weights all ones, fp32
               with 6, 1 and 0 of 8 live and raw staleness weights, int8
               and fp8 codes of that arena; the NaN / +-inf / -0.0 /
               unsent / dead-row / inf-scale hazards at a small width;
               times, a partial yardstick and bounds;
2g. coord_sort — K23 against its plain version on that arena in bf16 and
               fp32 at full width, NaN and +-inf rows and n = 3, 8, 11 at
               a small width; then the ``ops`` legacy paths
               (kernel_coordinate_median, kernel_trimmed_mean,
               kernel_pairwise_sq_dists) at full width with their launch
               counts (K23 twice, K2 once), against the gather laws; times
               against ``torch.sort(dim=0)`` and the bound;
3s. sparse train — sparse_mean (f = 2, sign_flip: the rule ignores f)
               through ``train_loop``: 1 warm-up and 1 timed synchronous
               step, 1 + 1 async steps under the phase-3b stragglers,
               and 1 + 1 steps each of int8 and fp8 sync and int8 async;
               the launch counts must show one K17 (compressed: one K21)
               a step and no other kernel; a traced sync and async step;
4s. sparse kernel vs gather — one full-width step each (sync, async,
               int8 sync) with impl="kernel" against impl="gather" from
               the same state: the same arena, codes and loss, aggregates
               within 3e-6; then the masked tree of mixed leaf dtypes
               (bf16 and fp32) on both impls at a small width: median,
               sign and krum exact, trimmed mean and sparse_mean within
               3e-6 (bf16 leaves 2e-2), one masked kernel a dtype (krum:
               the imputed fallback with its warning).

The defenses with memory and the defense-aware attacks (ROADMAP.md slice
6) add:

2h. clipped_weighted_sum — K22 against its plain version at n = 8, P =
               124,668,672: fp32 rows with 8 and 6 of 8 lam > 0, bf16
               rows with 8; inf / NaN on lam = 0 rows, every lam = 0 (the
               output is v), sum lam = 1, n = 1, 3, 8, 64 and P = 1, 37,
               4099 and the prime 65537 at a small width; times against
               ``torch.addmv`` and the bound;
3m. memory train — the phase-3b configuration through
               ``train_loop(sim=...)``, 1 warm-up step and 1 timed step:
               centered_clip impl="kernel" under sign_flip on
               the synchronous trace and under stragglers, centered_clip
               impl="auto", zeno_pp, server_momentum(trimmed_mean),
               spec_alie and min_max against kernel centered_clip,
               slow_drift against server_momentum(trimmed_mean), and one
               int8 kernel centered_clip step; the launch counts must show
               5 K22 a step on kernel centered_clip (iters = 5), none under
               auto and zeno_pp, one K5 a step for server_momentum(
               trimmed_mean), and nothing from the attack probes (they run
               the gather impl); one async step built, none synchronous.
               Then one traced kernel centered_clip step (idle share, K22's
               device time) and, on its buffer, the clip-radius stage's
               time apart from K22;
4m. memory kernel vs gather — one full-width async step of centered_clip
               with impl="kernel" against impl="gather" from the same
               state, with a nonzero server_grad carried from an earlier
               step, under sign_flip and under min_max: equal arenas (the
               attacked one included) and losses; the aggregate, the new
               server_grad and each of the 5 iterates within 3e-6.

The Gram kernels' redesign (K2, K6: one tensor-core template for every
n up to 64) adds:

2.  K2 at bulyan's n = 11 at full width in bf16 and fp32;
2b. K6 at n = 11 at full width, 9 of 11 arrived, fp32 and bf16 (every
               n = 11 case timed against ``x @ x.T`` and its bound); then
               the Gram sweep: K2 and K6 at n = 1..17, 24, 32, 33, 48 and
               64 in bf16 and fp32, d = 1, 127, 4099 (a leading stride the
               16-byte vectors cannot take) and d = 4099 in rows of 4112
               (ld > d), the NaN / +-inf / tie hazards, K6 with its absent
               rows NaN-filled (the Gram must stay finite); each case
               within 3e-6 of its plain version, repeated bit for bit and
               bitwise symmetric; then both kernels timed at n = 16 and
               64 on an (n, 16,777,216) bf16 stack, with bounds, where the
               kernel turns compute-bound.

Bulyan's coordinate stage redesigned (K13, K14: one template, the
register capacity from theta, a fast path beside the exact law) adds:

2c / 2d. each timed full-width K13 / K14 case with its predicted ms on
               its line, and the async bulyan aggregation (n = 11, 9
               arrived, fp32) timed; then the Bulyan sweep: K13 and K14 at
               n = 1..17, 24, 32, 33, 48 and 64 in bf16 and fp32, theta in
               {n - 2f, n - 2f - 1, n} and f in {0, max((n - 3) // 4, 1)},
               widths and strides (1, 1), (127, 127), (4099, 4099), (4099,
               4112) and a view offset by one element (the scalar path),
               and on the (4099, 4112) stack the hazard columns: +-0
               medians, +-3e38 (overflowing distances, all-inf rounds),
               subnormals, +-inf selected values, NaN only in unselected
               rows (never in K13's output), NaN in a selected row every
               7th column, theta + 2 and theta - 2 rows selected; each
               case bitwise equal to its plain version (NaN to NaN) and to
               a repeat.

The scaled coordinate statistics redesigned (K18, K19: one template, a
fast path beside the exact law) add:

2e. each timed full-width K18 / K19 case with its predicted ms on its
               line, and the compressed aggregation (spec.aggregate_flat on
               the codes: median, trimmed, sign_sgd and sparse_mean, sync
               and 6 of 8 arrived, int8 and fp8) timed on a line of its
               own; then the
               scaled sweep:
               K18 and K19 at n = 1..17, 24, 32, 33, 48 and 64 in int8 and
               fp8, median and trimmed (b = min(2, (n - 1) // 2)), K19 at
               masks of n, n - 2, 1 and 0 arrived, widths and strides (1,
               1), (127, 127), (4099, 4112) and a view offset by one byte
               (the byte loads), every one of the 256 codes in some column,
               fp8 NaN codes and +-0 codes in some columns, and on the
               (4099, 4112) stack an inf scale, a NaN scale, a zero scale
               and a scale that overflows the largest codes to +-inf;
               medians equal to the plain version NaN to NaN (-0 == +0, the
               one allowance, counted), trimmed means within 3e-6, each
               case bitwise equal to a repeat; then K18 and K19 timed at
               full width on int8 codes at n = 16, 33 and 64 (the 16-,
               32- and 64-row capacities) against the bytes' bound.

K1 and K21 redesigned (K1 on the order-statistic template of K18 / K19,
K21 with vector loads of its live rows) add:

2.  each timed full-width K1 case with its predicted ms on its line; then
               the K1 sweep: K1 at n = 1..17, 24, 32, 33, 48 and 64 in
               bf16 and fp32, median and trimmed (b = min(2, (n - 1) //
               2)), widths and strides (1, 1), (127, 127), (4099, 4112)
               and a view offset by one element (the element loads), and
               in the rows of 4112 the hazard columns (order_stack): NaN
               (in the first and the last row among others), +-inf,
               columns of +inf or -inf only, tied +-0, one value in every
               row, +-3e38, subnormals; medians equal to the plain version
               NaN to NaN (the sign-of-zero differences counted), trimmed
               means within 3e-6, each case bitwise equal to a repeat;
               then K1 timed at full width in bf16 at n = 16, 33 and 64
               (the 16-, 32- and 64-row capacities) against the bytes'
               bound;
2f. K1 on the real sign_flip arena (median and trimmed, timed; its zero
               and -0 shares and the sign-of-zero differences), each timed
               K21 case with its predicted ms; then the K21 sweep: n =
               1..17, 24, 32, 33, 48 and 64, int8 and fp8, the scaled
               sweep's widths, codes and scale hazards, masks of n, n - 2,
               1 and 0 live, weights all ones, the raw staleness discounts
               and those with a live row's weight 0; each case bitwise
               equal to its plain version (NaN to NaN) and to a repeat.

K15 and K20 redesigned (one template: signs read from the bits of
whole words, a fast path beside the exact law) add:

2 / 2e. each timed full-width K15 / K20 case with its predicted ms on its
               line;
2f. K15 on the real sign_flip arena (bf16; its zero and -0 shares) and
               K15 and K20 (8 and 6 of 8 arrived) on its int8 and fp8
               codes, bitwise equal to the plain versions and timed
               against the bound and a partial yardstick; then the vote
               sweep: K15 and K20 at n = 1..17, 24, 32, 33, 48 and 64 on
               int8 and fp8 codes at the scaled sweep's widths (a view
               offset by one byte among them), every code, NaN and +-0
               codes, and the inf / NaN / zero / overflowing / tiny
               (2^-142) / negative scales, K20 at masks of n, n - 2, 1 and
               0 arrived, and K15 on bf16 and fp32 at K1's sweep widths
               with its hazard columns; each case bitwise equal to its
               plain version (NaN to NaN) and to a repeat.

The rules without a kernel, the composition wrappers and gradient
coding (ROADMAP.md items 15 and 17) add:

2.  the launch floor: an empty kernel (``csrc/empty.cu``) timed with the
               same timer, reps (1000) and stream helper as the
               launch-bound K3 and K8-K10, those against max(their bytes'
               bound, that floor), and the card's own time of each and of
               the empty kernel (torch.profiler);
2f. phocas, mean_around_median, cgc, geometric_median, rfa,
               median_of_means, zeno (its validation gradient the arena's
               mean), clipped(trimmed_mean), bucketed(krum) and
               staleness_discounted(trimmed_mean) on the real sign_flip
               arena: ``aggregate_flat`` synchronous on the bf16 arena and
               masked on its fp32 copy (6 of 8), timed, with the peak
               device memory of the call;
3r. the same specs through ``train_loop``, 1 warm-up and 1 timed step
               each (2 until phase 3p took their time; zeno under the
               phase-3b stragglers;
               staleness_discounted through ``make_train_step``, since the
               loops refuse a ``staleness_aware`` spec); the launch
               counts must show K1 (clipped), K2 K3 K4 on the bucket means
               (bucketed(krum)), K5 (staleness_discounted: its weights take
               the masked path) and no kernel for the rules without one;
3k. gradient coding: the coded synchronous step (parallel regime, n =
               8, r = 4, f = 1, large_value), 1 warm-up and 3 timed steps,
               one K2 and one K7 a step and nothing else; the decode of
               the last step's arena held against its plain version (the
               same decode weights, the aggregate at max |error| 0.0), the
               vote margins (the largest d2 / (tol * scale) over honest
               pairs, the smallest over honest-against-Byzantine pairs)
               and the winners (no Byzantine row); K2, K7 and the whole
               decode timed.  Then ``coded_fallback_r = 4`` under
               stragglers with crash / recover (6, 6, 5, 3 of 8 arrive,
               quorum 6): the rule (K5) on the 2 rows that meet the quorum,
               the code (K2, K7) on the 2 that miss it; and the elastic
               coded run at 2 layers under the phase-3b churn (buckets 4,
               6, 8; bucket 6's table ragged), one K2 and one K7 a step.

K9 redesigned onto K3's tile and K8 folded into CGE's apply (K4's and
K7's kernels under their CGE flag: CGE launches K2 and the apply, K4
(mean) K6 and the masked apply when masked) add:

2c. CGE's apply, sync and masked, at full width (n = 8 and 11, bf16 and
               fp32; masked 6 of 8 and 9 of 11 arrived, the ghosts kept),
               normalized and not, bitwise equal to its plain version, to
               the chain it replaces recomposed from K8 -> K4 (K7) -> a
               division by a device tensor, and to a repeat; timed against
               w @ x and the bound.  A cge_aggregation line per path
               (sync bf16, masked fp32 6 of 8): CGE's aggregation and the
               apply alone beside the parent's chain (K8 -> K4 (K7) -> ``/
               (n - f)``, composed from the same kernels), timed in turns,
               with the card's busy time of each in a trace and the
               elements where the two differ (the parent divided by a
               reciprocal multiply, at most 1 ulp away).  One drive of the
               standalone K8 entry point (``kernels.cge_select``, which no
               training path launches now), its launch counted from 0
               and printed on its own line: K8's ``launches`` in the
               kernels line are the main path's, 0.
               The selection sweep adds K9 at m in {1, 3, n - f}, K8
               keeping n - f and 1, and the sync and masked applies in
               bf16 and fp32, normalized and not, at every n of the sweep
               and its hazards, each bitwise equal to its plain version
               and a repeat; K9 and the applies timed beside their
               predicted ms.

Selection telemetry, the flight recorder and checkpoints (ROADMAP.md
items 19 and 19a) add:

3t. telemetry — sync krum, multi_krum (m = 3), cge and trimmed_mean, async
               krum under the phase-3b stragglers and the elastic
               trimmed_mean under churn (n = 8, f = 2, sign_flip), each 1
               step through ``train_loop`` from seed 0 without and with a
               Recorder (telemetry on), deterministic algorithms on for
               both: the parameters and losses bitwise equal, every
               step's sel_w summing to 1 within 1e-6, the launches a step
               differing by the selection chain alone (krum K2 K3, multi_
               krum K2 K9, cge K2 K8, async krum K4 K6 K3, the coordinate
               rules none), the churn run within its build budget; sync
               krum's hot row, cast to fp32, equal to its aggregate and
               multi_krum's support K9's first m picks.  The recorded krum
               run writes a full-width checkpoint (restored bitwise into a
               like-tree, rewritten with its seconds and bytes) and a
               trace (the report renders; its Chrome trace parses).  The
               main phases' depth was cut to pay for it: phases 3 / 3b /
               3s from 3 / 4 timed steps to 2, phases 3c / 3d and the
               compressed 3x / 3s from 2 to 1.

Peer-to-peer DGD and the resilience estimators (ROADMAP.md item 21) add:

3p. p2p and resilience — (a) full-width decentralized DGD: n = 8 agents,
               f = 2, d = 124,668,672 fp32 estimates, quadratic costs
               Q_i(x) = 1/2 ||x - target_i||^2 (targets 0.2 N(0, 1) from a
               seeded card generator), x0 = 2, agents 0 and 1
               broadcasting 50.0, the complete graph; for each of plain,
               lf, ce and the trimmed_mean, krum and sign_sgd spec
               combines, 1 untimed warm-up round and 2 timed rounds
               through ``p2p_dgd_run``, a line each with ms a round, peak
               GB, the launches a round (exactly 8 K5 for trimmed_mean, 8
               each of K4, K6, K3 and K7 for krum, 8 K16 for sign_sgd,
               none for plain / lf / ce: plain torch) and the honest
               agents' largest distance to the honest mean target
               (smaller under every robust combine than under plain);
               then the two spec combines on the same
               broadcast states with impl="kernel" and impl="gather",
               timed: krum exact, trimmed_mean within 3e-6; (b) the
               trimmed_mean combine on ring(8, 2) for 3 rounds under a
               partition over round 0, agent 7 crashed from round 1 and
               every broadcast of agent 3 dropped: the crashed rows
               bitwise unchanged, the trajectory finite, 8 K5 a round;
               (c) ``estimate_alpha_f`` (sign_flip) for krum,
               coordinate_median, bulyan and geometric_median and
               ``estimate_delta_c`` (four attacks) for coordinate_median
               and mean at n = 10, f = 2, d = 32, 24 trials, each on impl
               auto and gather from seed 0: the per-trial values within
               3e-6 of each other, the sync chains launched once a trial
               on auto (K2 K3 K4; K1; K2 K10 K13) and nothing on gather,
               ok on the four resilient rules; then krum and
               coordinate_median through ``estimate_alpha_f`` at d =
               124,668,672 with 2 trials.  The phase's seconds go on a
               line of their own.  To pay for it phase 3r went from 2
               timed steps a spec to 1.

The text families (ROADMAP.md item 22a) add:

3f. families — (a) mamba2-130m at full width: bf16 with the SSM's fp32
               A_log / dt_bias / D_skip, so an fp32 (8, P) arena of P =
               128,983,488 (num_params' 128,940,480 leaves out the conv
               biases, ROADMAP.md R3); n = 8, f = 2, sign_flip, seq 512
               (two SSD chunks of 256), one sequence an agent, remat on:
               trimmed_mean, coordinate_median and krum through
               ``train_loop`` (1 warm-up and 1 timed step, exactly one K1
               or one each of K2 K3 K4 a step), one async trimmed_mean
               step under the phase-3b stragglers (one K5), a traced
               trimmed_mean step (device busy, idle share) with the device
               time of one agent's pass split between the SSD scan, the
               block's projections, the rest of the block and the rest of
               the model, and the aggregation; each rule's warm-up step's
               arena aggregated again by the gather impl: median and krum
               exact, trimmed within 3e-6; (b) the -smoke
               reductions of mixtral-8x22b, llama4-scout-17b-a16e,
               zamba2-7b and h2o-danube-3-4b in their own dtypes at seq 80:
               one trimmed_mean and one krum step each on the kernel impl
               (finite loss, the rule's kernels once), against the gather
               impl on its arena, the MoE lines with their drops and R2
               flags.  The phase's seconds go on a line of their own.  To
               pay for it, phases 3 / 3b / 3s and 3m went from 2 timed
               steps to 1 and phase 3t from 2 steps a run to 1.

The lines before the last give the kernels' summary and the card; the
last line is {"ok": true, "device": {...}}.  Exits non-zero when CUDA is
not available.
"""
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
MEM_BPS = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
N, F = 8, 2
TOL = 3e-6                  # the fp32 kernel bar (trimmed mean, Gram, wsum)
SEQ, PER_AGENT, STEPS = 256, 2, 1
RULES = ("trimmed_mean", "coordinate_median", "krum")
RULE_KERNELS = {"trimmed_mean": ("coord_stat",),
                "coordinate_median": ("coord_stat",),
                "krum": ("gram", "krum_select", "weighted_sum")}
ASYNC_STEPS = 1
# the async rules: rule -> (n, quorum, hyper, the kernels of one masked
# step); the selection family's table is ASYNC_SEL_RULES below
ASYNC_RULES = {
    "trimmed_mean": (N, 6, {}, ("masked_coord_stat",)),
    "coordinate_median": (N, 6, {}, ("masked_coord_stat",)),
    "krum": (N, 6, {}, ("weighted_sum", "masked_gram", "krum_select",
                        "masked_weighted_sum"))}
CHURN_LIVE = [8, 6, 4, 6, 6, 7, 4, 3]
SOURCES = {
    "coord_stat": ("src/repro_torch/kernels/csrc/coord_stat.cu",
                   "src/repro/kernels/coord_stats.py:95"),
    "gram": ("src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/pairwise.py:38"),
    "krum_select": ("src/repro_torch/kernels/csrc/krum_select.cu",
                    "src/repro/kernels/select.py:106"),
    "weighted_sum": ("src/repro_torch/kernels/csrc/wsum.cu",
                     "src/repro/kernels/wsum.py:45"),
    "masked_coord_stat": ("src/repro_torch/kernels/csrc/masked_coord_stat.cu",
                          "src/repro/kernels/masked.py:235"),
    "masked_gram": ("src/repro_torch/kernels/csrc/masked_gram.cu",
                    "src/repro/kernels/pairwise.py:89"),
    "masked_weighted_sum": ("src/repro_torch/kernels/csrc/masked_wsum.cu",
                            "src/repro/kernels/wsum.py:87"),
    "cge_select": ("src/repro_torch/kernels/csrc/cge_select.cu",
                   "src/repro/kernels/select.py:120"),
    "multi_krum_order": ("src/repro_torch/kernels/csrc/order.cu",
                         "src/repro/kernels/select.py:212"),
    "iterative_order": ("src/repro_torch/kernels/csrc/order.cu",
                        "src/repro/kernels/select.py:220"),
    "ordered_apply": ("src/repro_torch/kernels/csrc/ordered_apply.cu",
                      "src/repro/kernels/wsum.py:318"),
    "bulyan_coord": ("src/repro_torch/kernels/csrc/bulyan_coord.cu",
                     "src/repro/kernels/select.py:288"),
    "masked_ordered_apply": ("src/repro_torch/kernels/csrc/ordered_apply.cu",
                             "src/repro/kernels/wsum.py:346"),
    "masked_bulyan_coord": (
        "src/repro_torch/kernels/csrc/masked_bulyan_coord.cu",
        "src/repro/kernels/select.py:312"),
    "sign_vote": ("src/repro_torch/kernels/csrc/sign_vote.cu",
                  "src/repro/kernels/masked.py:62"),
    "masked_sign_vote": ("src/repro_torch/kernels/csrc/sign_vote.cu",
                         "src/repro/kernels/masked.py:90"),
    "scaled_coord_stat": ("src/repro_torch/kernels/csrc/scaled_coord_stat.cu",
                          "src/repro/kernels/masked.py:133"),
    "scaled_masked_coord_stat": (
        "src/repro_torch/kernels/csrc/scaled_masked_coord_stat.cu",
        "src/repro/kernels/masked.py:171"),
    "scaled_masked_sign_vote": ("src/repro_torch/kernels/csrc/sign_vote.cu",
                                "src/repro/kernels/masked.py:207"),
    "sparse_masked_weighted_mean": (
        "src/repro_torch/kernels/csrc/sparse_wmean.cu",
        "src/repro/kernels/wsum.py:186"),
    "scaled_sparse_masked_weighted_mean": (
        "src/repro_torch/kernels/csrc/sparse_wmean.cu",
        "src/repro/kernels/wsum.py:227"),
    "coord_sort": ("src/repro_torch/kernels/csrc/coord_sort.cu",
                   "src/repro/kernels/coord_stats.py:53"),
    "clipped_weighted_sum": ("src/repro_torch/kernels/csrc/clipped_wsum.cu",
                             "src/repro/kernels/wsum.py:138"),
    # CGE's apply: K4's / K7's kernel under its CGE flag, K8 folded in
    "cge_weighted_sum": ("src/repro_torch/kernels/csrc/wsum.cu",
                         "src/repro/kernels/wsum.py:45"),
    "masked_cge_weighted_sum": ("src/repro_torch/kernels/csrc/masked_wsum.cu",
                                "src/repro/kernels/wsum.py:87"),
}
SYNC_KERNELS = ("coord_stat", "gram", "krum_select", "weighted_sum",
                "sign_vote")
# the selection family: rule -> (n, hyper, the kernels of one step)
SEL_RULES = {
    "cge": (N, {}, ("gram", "cge_weighted_sum")),
    "multi_krum": (N, {"m": 3}, ("gram", "multi_krum_order",
                                 "ordered_apply")),
    "m_krum": (N, {"m": 3}, ("gram", "iterative_order", "ordered_apply")),
    "mda": (N, {}, ("gram", "ordered_apply")),
    "bulyan": (11, {}, ("gram", "iterative_order", "bulyan_coord")),
}
SEL_STEPS = 1
SIGN_RULES = {"sign_sgd": (N, {}, ("sign_vote",))}
# the async selection family and sign_sgd: rule -> (n, quorum, hyper, the
# kernels of one masked step)
IMPUTED = ("weighted_sum", "masked_gram")
ASYNC_SEL_RULES = {
    "cge": (N, 6, {}, IMPUTED + ("masked_cge_weighted_sum",)),
    "multi_krum": (N, 6, {"m": 3}, IMPUTED + ("multi_krum_order",
                                              "masked_ordered_apply")),
    "m_krum": (N, 6, {"m": 3}, IMPUTED + ("iterative_order",
                                          "masked_ordered_apply")),
    "mda": (N, 6, {}, IMPUTED + ("masked_ordered_apply",)),
    "sign_sgd": (N, 6, {}, ("masked_sign_vote",)),
    "bulyan": (11, 9, {}, IMPUTED + ("iterative_order",
                                     "masked_bulyan_coord")),
}
ASYNC_SEL_STEPS = 1
# the compressed exchange (agg_dtype): the quantized dtypes, and rule -> (n,
# hyper, the kernels of one step) of the synchronous step and (n, quorum,
# hyper, the kernels of one masked step) of the async one; krum takes the
# engine-level dequantization, then its own kernels
QUANT = ("int8", "float8_e4m3fn")
QUANT_RULES = {
    "coordinate_median": (N, {}, ("scaled_coord_stat",)),
    "trimmed_mean": (N, {}, ("scaled_coord_stat",)),
    "sign_sgd": (N, {}, ("sign_vote",)),
    "krum": (N, {}, ("gram", "krum_select", "weighted_sum")),
}
ASYNC_QUANT_RULES = {
    "coordinate_median": (N, 6, {}, ("scaled_masked_coord_stat",)),
    "trimmed_mean": (N, 6, {}, ("scaled_masked_coord_stat",)),
    "sign_sgd": (N, 6, {}, ("scaled_masked_sign_vote",)),
    "krum": ASYNC_RULES["krum"],
}
QUANT_STEPS = 1
# the rules whose quantized arena is dequantized at engine level (a count
# per step, read in phase 3x)
DEQUANT_RULES = ("krum",)
# sparse_mean (phase 3s): the kernel of one step, sync and masked, on a
# float arena and on codes
K17, K21 = "sparse_masked_weighted_mean", "scaled_sparse_masked_weighted_mean"
SPARSE_SYNC = {"sparse_mean": (N, {}, (K17,))}
SPARSE_ASYNC = {"sparse_mean": (N, 6, {}, (K17,))}
SPARSE_QUANT = {"sparse_mean": (N, {}, (K21,))}
SPARSE_AQUANT = {"sparse_mean": (N, 6, {}, (K21,))}


T0 = time.time()


def emit(phase, **kw):
    """One JSON line of ``phase``, with the seconds since the script
    started (``t``)."""
    print(json.dumps({"phase": phase, **kw,
                      "t": round(time.time() - T0, 1)}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    """Largest |a - b|; NaN in both counts as agreement, NaN in one as
    inf, equal infinities as 0."""
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    one_nan = torch.isnan(a) ^ torch.isnan(b)
    same = (a == b) | both_nan
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    diff = torch.where(one_nan, torch.full_like(a, math.inf), diff)
    return float(diff.max()) if diff.numel() else 0.0


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / MEM_BPS * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def timing(fn, plain, reps, plain_reps, bytes_moved, flops, library=None,
           label=None):
    """Kernel, plain-version and (optional) library times with the bound,
    as the keyword arguments of a ``check`` line."""
    bms, by = bound(bytes_moved, flops)
    return dict(kernel_ms=time_ms(fn, reps),
                plain_ms=time_ms(plain, plain_reps),
                library_ms=time_ms(library, 2) if library else None,
                library=label, bound_ms=bms, bound_by=by)


def note(summary, name, err, kw=None):
    """Keep the largest error of ``name`` in ``summary``, and the timing
    ``kw`` (from :func:`timing`) of the summary's case."""
    summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
    if kw:
        summary[name].update(
            ms=kw["kernel_ms"], **{k: kw[k] for k in (
                "plain_ms", "library_ms", "bound_ms", "bound_by")})


# ---------------------------------------------------------------------------
# phase 1


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    t0 = time.time()
    build.lib()
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, kernel_build_s=round(time.time() - t0, 3),
         build_cached=build.BUILD_INFO.get("cached"))
    return card


# ---------------------------------------------------------------------------
# phase 2


def check(name, ok, **kw):
    emit("kernels", kernel=name, ok=bool(ok), **kw)
    if not ok:
        fail(f"kernel {name} disagrees with its plain version: {kw}")


def kernel_checks(num_params):
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain
    from repro_torch.kernels.masked import sign_vote_plain
    from repro_torch.kernels.pairwise import gram_plain
    from repro_torch.kernels.select import krum_select_plain
    from repro_torch.kernels.wsum import weighted_sum_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    summary = {k: {"max_abs_err": 0.0} for k in SYNC_KERNELS}
    agg_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        x = (torch.randn((N, P), generator=gen, device=DEVICE,
                         dtype=torch.float32) * 1e-3).to(dtype)
        main = dtype == torch.bfloat16       # the main path's arena dtype
        # K1 coord_stat
        for stat, b in (("median", 0), ("trimmed_mean", 2)):
            out = kernels.coord_stat(x, stat, b)
            ref = coord_stat_plain(x, stat, b)
            err = max_abs_err(out, ref)
            ok = err == 0.0 if stat == "median" else err <= TOL * (
                1 + float(ref.abs().max()))
            ms = time_ms(lambda: kernels.coord_stat(x, stat, b), 10)
            pms = time_ms(lambda: coord_stat_plain(x, stat, b), 2)
            lms = time_ms(lambda: torch.sort(x, dim=0), 2)
            bms, by = bound(N * P * s + 4 * P, N * (N - 1) // 2 * 2 * P)
            check("coord_stat", ok, stat=stat, dtype=dname, shape=[N, P],
                  max_abs_diff=err, exact=err == 0.0, kernel_ms=ms,
                  plain_ms=pms, library_ms=lms, library="torch.sort(dim=0)",
                  bound_ms=bms, bound_by=by,
                  predicted_ms=K1_PREDICTED_MS[dname])
            summary["coord_stat"]["max_abs_err"] = max(
                summary["coord_stat"]["max_abs_err"], err)
            if main and stat == "median":
                summary["coord_stat"].update(ms=ms, plain_ms=pms,
                                             library_ms=lms, bound_ms=bms,
                                             bound_by=by)
        # K2 gram
        gr = kernels.gram(x)
        ref = gram_plain(x)
        err = max_abs_err(gr, ref)
        ok = bool(torch.allclose(gr, ref, rtol=TOL, atol=TOL))
        rep = kernels.gram(x)
        ok = ok and torch.equal(gr, rep)            # repeats bit for bit
        ms = time_ms(lambda: kernels.gram(x), 10)
        pms = time_ms(lambda: gram_plain(x), 2)
        lms = time_ms(lambda: x @ x.T, 5)
        bms, by = bound(N * P * s + 4 * N * N, N * (N + 1) // 2 * 2 * P)
        check("gram", ok, dtype=dname, shape=[N, P], max_abs_diff=err,
              exact=err == 0.0, bitwise_repeat=True, kernel_ms=ms,
              plain_ms=pms, library_ms=lms, library="x @ x.T",
              bound_ms=bms, bound_by=by)
        summary["gram"]["max_abs_err"] = max(summary["gram"]["max_abs_err"],
                                             err)
        if main:
            summary["gram"].update(ms=ms, plain_ms=pms, library_ms=lms,
                                   bound_ms=bms, bound_by=by)
        # K3 krum_select
        w = kernels.krum_select(gr, F)
        wref = krum_select_plain(gr, F)
        err = max_abs_err(w, wref)
        ms = time_ms(lambda: kernels.krum_select(gr, F), LAUNCH_REPS)
        pms = time_ms(lambda: krum_select_plain(gr, F), 5)
        bms, by = bound(4 * N * N + 4 * N, N * N * (N + 4))
        check("krum_select", err == 0.0 and float(w.sum()) == 1.0,
              dtype="float32", shape=[N, N], max_abs_diff=err, exact=err == 0,
              kernel_ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
              bound_by=by)
        summary["krum_select"]["max_abs_err"] = max(
            summary["krum_select"]["max_abs_err"], err)
        if main:
            summary["krum_select"].update(ms=ms, plain_ms=pms,
                                          library_ms=None, bound_ms=bms,
                                          bound_by=by)
        # K4 weighted_sum with Krum's one-hot: exactly the selected row
        sel = int(torch.argmax(w))
        out = kernels.weighted_sum(w, x)
        ref = weighted_sum_plain(w, x)
        err = max(max_abs_err(out, ref), max_abs_err(out, x[sel].float()))
        ms = time_ms(lambda: kernels.weighted_sum(w, x), 10)
        pms = time_ms(lambda: weighted_sum_plain(w, x), 5)
        wl = w.to(dtype)
        lms = time_ms(lambda: wl @ x, 5)
        nsel = int((w > 0).sum())          # rows this w makes it read
        bms, by = bound(nsel * P * s + 4 * P + 4 * N, 2 * nsel * P)
        check("weighted_sum", err == 0.0, dtype=dname, shape=[N, P],
              weights="krum one-hot", max_abs_diff=err, exact=err == 0.0,
              kernel_ms=ms, plain_ms=pms, library_ms=lms,
              library="w @ x", bound_ms=bms, bound_by=by)
        summary["weighted_sum"]["max_abs_err"] = max(
            summary["weighted_sum"]["max_abs_err"], err)
        if main:
            summary["weighted_sum"].update(ms=ms, plain_ms=pms,
                                           library_ms=lms, bound_ms=bms,
                                           bound_by=by)
        # K15 sign_vote: the vote is exact, so the kernel equals its plain
        # version bit for bit
        out = kernels.sign_vote(x)
        err = max_abs_err(out, sign_vote_plain(x))
        del out
        ms = time_ms(lambda: kernels.sign_vote(x), 10)
        pms = time_ms(lambda: sign_vote_plain(x), 2)
        lms = time_ms(lambda: torch.sign(torch.sign(x).sum(0)), 2)
        bms, by = bound(N * P * s + 4 * P, 2 * N * P)
        check("sign_vote", err == 0.0, dtype=dname, shape=[N, P],
              max_abs_diff=err, exact=err == 0.0, kernel_ms=ms,
              plain_ms=pms, library_ms=lms,
              library="torch.sign(torch.sign(g).sum(0)), a partial "
                      "yardstick (three calls)", bound_ms=bms, bound_by=by,
              predicted_ms=VOTE_PREDICTED_MS[("sign_vote", dname)])
        summary["sign_vote"]["max_abs_err"] = max(
            summary["sign_vote"]["max_abs_err"], err)
        if main:
            summary["sign_vote"].update(ms=ms, plain_ms=pms, library_ms=lms,
                                        bound_ms=bms, bound_by=by)
        # aggregation time of each rule on this arena (the spec's call)
        if main:
            from repro_torch.core.aggregators import make_spec
            for rule in RULES + tuple(SIGN_RULES):
                spec = make_spec(rule, f=F, n=N)
                agg_ms[rule] = time_ms(lambda: spec.aggregate_flat(x), 5)
            emit("kernels", aggregation_ms=agg_ms, dtype=dname)
        del x, gr
        torch.cuda.empty_cache()
    hazard_checks()
    sign_hazard_checks()
    note(summary, "gram", gram_bulyan_checks(P, gen))
    return summary, agg_ms


# the predicted ms of the timed full-width K13 / K14 cases (kernel, dtype,
# n), written before the redesigned kernels' first run (PERF.md §6)
BULYAN_PREDICTED_MS = {
    ("bulyan_coord", "bfloat16", 11): (0.8, 1.3),
    ("bulyan_coord", "float32", 11): (1.3, 1.8),
    ("bulyan_coord", "bfloat16", 8): (0.5, 0.9),
    ("masked_bulyan_coord", "float32", 11): (1.2, 1.8),
    ("masked_bulyan_coord", "bfloat16", 11): (0.7, 1.1),
}
# the predicted ms of the timed full-width K18 / K19 cases (kernel, code
# dtype), written before the redesigned kernels' first run (PERF.md §6)
SCALED_PREDICTED_MS = {
    ("scaled_coord_stat", "int8"): (0.50, 0.80),
    ("scaled_coord_stat", "float8_e4m3fn"): (0.50, 0.85),
    ("scaled_masked_coord_stat", "int8"): (0.42, 0.70),
    ("scaled_masked_coord_stat", "float8_e4m3fn"): (0.42, 0.75),
}

# the predicted ms of the timed full-width K1 cases (dtype; median and
# trimmed alike) and K21 cases (code dtype, live rows), written before the
# redesigned kernels' first run (PERF.md §6)
K1_PREDICTED_MS = {"bfloat16": (0.85, 1.05), "float32": (1.42, 1.60)}
K21_PREDICTED_MS = {("int8", N): (0.50, 0.62), ("int8", 6): (0.42, 0.52),
                    ("float8_e4m3fn", N): (0.50, 0.68),
                    ("float8_e4m3fn", 6): (0.42, 0.57)}
# the predicted ms of the timed full-width K15 and K20 cases (kernel,
# dtype; K20 at 6 of 8 arrived), written before the redesigned kernels'
# first run (PERF.md §6)
VOTE_PREDICTED_MS = {
    ("sign_vote", "bfloat16"): (0.78, 0.90),
    ("sign_vote", "float32"): (1.38, 1.50),
    ("sign_vote", "int8"): (0.47, 0.56),
    ("sign_vote", "float8_e4m3fn"): (0.47, 0.56),
    ("scaled_masked_sign_vote", "int8"): (0.40, 0.48),
    ("scaled_masked_sign_vote", "float8_e4m3fn"): (0.40, 0.48),
}

# the launch-bound selection kernels (K3, K8-K10) and the empty kernel
# are timed over as many launches; the predicted time_ms of the selection
# sweep (select_sweep_checks), each written before its kernel's first run
# (PERF.md §6): K3 / K10 the wrappers' host launch path, but K10's theta
# picks at n = 64, which the card sets; K9 on K3's tile and CGE's applies
# at d = 256 the host's path too, the applies' a few checks longer
LAUNCH_REPS = 1000
SELECT_PREDICTED_MS = {"host": (0.009, 0.016), "k10_n64_theta": (0.015,
                                                                  0.035),
                       "multi_krum_order": (0.010, 0.018),
                       "cge_apply": (0.012, 0.024)}
SELECT_SWEEP_HAZARDS = (None, "dup", "pair", "all_nan")
# CGE's aggregation at n = 8 (cge_aggregation), predicted before the
# fused apply's first run (PERF.md §6): the new chain's ms (sync bf16) and
# what it saves against the parent's chain (the (d,) divide pass and K8)
CGE_PREDICTED_MS = {("sync", "bfloat16"): {"new": (1.70, 1.80),
                                           "saving": (0.28, 0.36)},
                    ("masked", "float32"): {"saving": (0.28, 0.36)}}

# the Gram kernels beyond the main path's n = 8: the sweep's n, its (d,
# leading stride, hazard) cases, and the width of the compute-bound probe
GRAM_SWEEP_N = tuple(range(1, 18)) + (24, 32, 33, 48, 64)
GRAM_SWEEP_CASES = ((1, 1, None), (127, 127, None), (4099, 4099, None),
                    (4099, 4112, None), (4099, 4112, "nan"),
                    (4099, 4112, "inf"), (4099, 4112, "ties"))
GRAM_WIDE_D = 16_777_216


def same_bits(a, b):
    """Bitwise equality of two fp32 tensors (NaN payloads included)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def gram_agrees(fn, plain):
    """(ok, error, Gram): ``fn()`` within 3e-6 of ``plain()`` (NaN equal
    to NaN), repeated bit for bit, and bitwise symmetric."""
    gr = fn()
    ref = plain()
    err = max_abs_err(gr, ref)
    ok = (bool(torch.allclose(gr, ref, rtol=TOL, atol=TOL, equal_nan=True))
          and same_bits(gr, fn()) and same_bits(gr, gr.T))
    return ok, err, gr


def gram_case(name, fn, plain, x, bytes_moved, **kw):
    """One timed full-width Gram case: held as :func:`gram_agrees` holds
    it, timed with its plain version, ``x @ x.T`` and the bound.  Returns
    the error."""
    n = x.shape[0]
    ok, err, _ = gram_agrees(fn, plain)
    kw.update(timing(fn, plain, 10, 2, bytes_moved,
                     n * (n + 1) // 2 * 2 * x.shape[1],
                     library=lambda: x @ x.T, label="x @ x.T"))
    check(name, ok, n=n, shape=list(x.shape), max_abs_diff=err,
          bitwise_repeat=True, bitwise_symmetric=True, **kw)
    return err


def gram_bulyan_checks(P, gen):
    """K2 at bulyan's n = 11 at full width, bf16 (the sync arena) and
    fp32.  Returns the largest error."""
    from repro_torch import kernels
    from repro_torch.kernels.pairwise import gram_plain

    n, worst = 11, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        s = torch.finfo(dtype).bits // 8
        x = (torch.randn((n, P), generator=gen, device=DEVICE,
                         dtype=torch.float32) * 1e-3).to(dtype)
        worst = max(worst, gram_case(
            "gram", lambda: kernels.gram(x), lambda: gram_plain(x), x,
            n * P * s + 4 * n * n, dtype=str(dtype).replace("torch.", "")))
        del x
        torch.cuda.empty_cache()
    return worst


def gram_sweep_checks():
    """K2 and K6 at every n of GRAM_SWEEP_N, bf16 and fp32, at the
    GRAM_SWEEP_CASES widths, strides and hazards (see :func:`gram_agrees`);
    K6's absent rows (n // 2, n // 2 + 3, ...) NaN-filled, its mean drawn
    apart.  One line per n.  Returns the largest error of each kernel."""
    from repro_torch import kernels
    from repro_torch.kernels.pairwise import gram_plain, masked_gram_plain

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    worst = {"gram": 0.0, "masked_gram": 0.0}
    for n in GRAM_SWEEP_N:
        m = torch.ones(n, device=DEVICE)
        m[n // 2::3] = 0.0
        _, wn = discount_weights(m)
        absent = torch.nonzero(m <= 0.5).flatten()
        errs = {"gram": 0.0, "masked_gram": 0.0}
        cases = 0
        for dtype in (torch.bfloat16, torch.float32):
            for d, ld, hazard in GRAM_SWEEP_CASES:
                base = torch.randn((n, ld), generator=gen,
                                   device=DEVICE) * 2.0
                if hazard == "nan":
                    base[min(1, n - 1), ::5] = math.nan
                elif hazard == "inf":
                    base[0, ::3] = math.inf
                    base[n - 1, 1::3] = -math.inf
                elif hazard == "ties":
                    base[:] = base[0].clone()
                    base[:, ::2] = torch.round(base[:, ::2])
                base = base.to(dtype)
                x = base[:, :d]
                ok, err, _ = gram_agrees(lambda: kernels.gram(x),
                                         lambda: gram_plain(x))
                errs["gram"] = max(errs["gram"], err)
                base[absent] = math.nan          # never read by K6
                mean = torch.randn(d, generator=gen, device=DEVICE).to(dtype)
                ok_m, err, gr = gram_agrees(
                    lambda: kernels.masked_gram(x, m, wn, mean),
                    lambda: masked_gram_plain(x, m, wn, mean))
                errs["masked_gram"] = max(errs["masked_gram"], err)
                if hazard is None:
                    ok_m = ok_m and bool(torch.isfinite(gr).all())
                cases += 2
                if not (ok and ok_m):
                    check("gram_sweep", False, n=n, d=d, ld=ld,
                          hazard=hazard, dtype=str(dtype), gram_ok=ok,
                          masked_gram_ok=ok_m, max_abs_diff=errs)
        torch.cuda.synchronize()
        check("gram_sweep", True, n=n, cases=cases, arrived=n - len(absent),
              max_abs_diff=errs, bitwise_repeat=True, bitwise_symmetric=True)
        for k in worst:
            worst[k] = max(worst[k], errs[k])
    return worst


def gram_width_checks():
    """K2 and K6 (n - 2 arrived) on an (n, GRAM_WIDE_D) bf16 stack at n =
    16 and 64, timed with bounds: where the kernel turns compute-bound.
    Returns the largest error of each kernel."""
    from repro_torch import kernels
    from repro_torch.kernels.pairwise import gram_plain, masked_gram_plain

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    D, worst = GRAM_WIDE_D, {"gram": 0.0, "masked_gram": 0.0}
    for n in (16, 64):
        x = (torch.randn((n, D), generator=gen, device=DEVICE) * 1e-3).to(
            torch.bfloat16)
        worst["gram"] = max(worst["gram"], gram_case(
            "gram", lambda: kernels.gram(x), lambda: gram_plain(x), x,
            2 * n * D + 4 * n * n, dtype="bfloat16"))
        m = arrival_mask(n - 2, n)
        _, wn = discount_weights(m)
        mean = kernels.imputed_mean(x, wn)
        worst["masked_gram"] = max(worst["masked_gram"], gram_case(
            "masked_gram", lambda: kernels.masked_gram(x, m, wn, mean),
            lambda: masked_gram_plain(x, m, wn, mean), x,
            2 * (n - 1) * D + 4 * n * n, dtype="bfloat16", arrived=n - 2))
        del x, mean
        torch.cuda.empty_cache()
    return worst


def sign_hazard_checks():
    """K15 and K16 on NaN, +-inf and +-0 values (and, for K16, NaN / +inf
    in an absent row, which casts no vote: ROADMAP.md P10) at a small width
    and n = 3, 8, 11: exact against the plain versions."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import (masked_sign_vote_plain,
                                            sign_vote_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    d = 4099
    for n in (3, 8, 11):
        m = arrival_mask(max(n - 2, 1), n)
        for hazard in ("nan", "inf", "zeros", "absent"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=gen, device=DEVICE)
                if hazard == "nan":
                    x[0, ::7] = math.nan
                elif hazard == "inf":
                    x[0, ::3], x[n - 1, 1::3] = math.inf, -math.inf
                elif hazard == "zeros":
                    x[:, ::2] = 0.0
                    x[: n // 2, ::4] = -0.0
                else:
                    x[n - 1, ::2], x[n - 1, 1::2] = math.nan, math.inf
                x = x.to(dtype)
                errs = {"sign_vote": max_abs_err(kernels.sign_vote(x),
                                                 sign_vote_plain(x))}
                out = kernels.masked_sign_vote(x, m, m)
                errs["masked_sign_vote"] = max_abs_err(
                    out, masked_sign_vote_plain(x, m, m))
                torch.cuda.synchronize()
                ok = all(v == 0.0 for v in errs.values())
                if hazard == "absent":
                    ok = ok and bool(torch.isfinite(out).all())
                check("sign_hazards", ok, hazard=hazard, n=n,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=errs)


def hazard_checks():
    """NaN row, +-inf rows, tied rows and values, at a small width."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain
    from repro_torch.kernels.pairwise import gram_plain
    from repro_torch.kernels.select import krum_select_plain
    from repro_torch.kernels.wsum import weighted_sum_plain

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    d = 4099
    for hazard in ("nan", "inf", "ties", "spots"):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((N, d), generator=gen, device=DEVICE) * 2.0
            if hazard == "nan":
                x[1] = math.nan
            elif hazard == "inf":
                x[1], x[4] = math.inf, -math.inf
            elif hazard == "ties":
                x[1] = x[0]
                x[2] = x[0]
                x[5] = torch.round(x[5])
            else:
                x[1, 7], x[3, 7], x[5, 11] = math.nan, math.inf, -math.inf
            x = x.to(dtype)
            errs, close = {}, {}
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                out = kernels.coord_stat(x, stat, b)
                ref = coord_stat_plain(x, stat, b)
                errs[stat] = max_abs_err(out, ref)
                close[stat] = bool(torch.allclose(out, ref, rtol=TOL,
                                                  atol=TOL, equal_nan=True))
            gr = kernels.gram(x)
            if hazard == "ties":
                ref = gram_plain(x)
                errs["gram"] = max_abs_err(gr, ref)
                close["gram"] = bool(torch.allclose(gr, ref, rtol=TOL,
                                                    atol=TOL))
            w = kernels.krum_select(gr, F)
            errs["krum_select"] = max_abs_err(w, krum_select_plain(gr, F))
            errs["weighted_sum"] = max_abs_err(
                kernels.weighted_sum(w, x), weighted_sum_plain(w, x))
            torch.cuda.synchronize()
            ok = (errs["median"] == 0.0 and close["trimmed_mean"]
                  and close.get("gram", True)
                  and errs["krum_select"] == 0.0
                  and errs["weighted_sum"] == 0.0
                  and float(w.sum()) == 1.0)
            check("hazards", ok, hazard=hazard,
                  dtype=str(dtype).replace("torch.", ""), shape=[N, d],
                  max_abs_diff=errs)


# ---------------------------------------------------------------------------
# phase 2b


def arrival_mask(arrived, n=N):
    """(n,) {0,1} fp32 mask with the first ``arrived`` rows arrived."""
    m = torch.zeros(n, device=DEVICE)
    m[:arrived] = 1.0
    return m


def discount_weights(m):
    """Staleness discounts {1, 1/2, 1/3} on the arrived rows and the
    normalized wn = w / tot the kernels take."""
    n = m.shape[0]
    w = m * torch.tensor([1.0, 0.5, 1.0 / 3.0] * n, device=m.device)[:n]
    return w, w / torch.clamp_min(w.sum(), 1e-30)


def masked_kernel_checks(num_params):
    """K5, K6, K7 and the imputed mean at the main path's shapes; the
    summary takes the fp32 arena's numbers (the async arena is fp32)."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_coord_stat_plain
    from repro_torch.kernels.pairwise import masked_gram_plain
    from repro_torch.kernels.ref import imputed_mean_ref
    from repro_torch.kernels.select import krum_select_plain
    from repro_torch.kernels.wsum import masked_weighted_sum_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    summary = {k: {"max_abs_err": 0.0} for k in SOURCES
               if k.startswith("masked")}
    summary["imputed_mean"] = {"max_abs_err": 0.0}

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        main = dtype == torch.float32
        x = (torch.randn((N, P), generator=gen, device=DEVICE,
                         dtype=torch.float32) * 1e-3).to(dtype)
        for arrived in (6, 1, 0):
            m = arrival_mask(arrived)
            _, wn = discount_weights(m)
            timed = arrived == 6                  # the straggler rows' mask
            # K5 masked_coord_stat
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                out = kernels.masked_coord_stat(x, m, wn, stat, b)
                ref = masked_coord_stat_plain(x, m, wn, stat, b)
                err = max_abs_err(out, ref)
                ok = err == 0.0 if stat == "median" else bool(
                    torch.allclose(out, ref, rtol=TOL, atol=TOL))
                if arrived == 0:
                    ok = ok and not bool(out.any())
                kw = {}
                if timed:
                    ms = time_ms(lambda: kernels.masked_coord_stat(
                        x, m, wn, stat, b), 10)
                    pms = time_ms(lambda: masked_coord_stat_plain(
                        x, m, wn, stat, b), 2)
                    lms = time_ms(lambda: torch.sort(x, dim=0), 2)
                    bms, by = bound(arrived * P * s + 4 * P,
                                    N * (N - 1) // 2 * 2 * P)
                    kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                              library="torch.sort(dim=0)", bound_ms=bms,
                              bound_by=by)
                check("masked_coord_stat", ok, stat=stat, dtype=dname,
                      shape=[N, P], arrived=arrived, max_abs_diff=err,
                      exact=err == 0.0, **kw)
                note(summary, "masked_coord_stat", err,
                     main and stat == "trimmed_mean" and kw)
                del out, ref
            if arrived == 0:
                continue
            # the imputed mean, through K4
            mean = kernels.imputed_mean(x, wn)
            ref = imputed_mean_ref(x, wn)
            err = max_abs_err(mean, ref)
            ok = bool(torch.allclose(mean.float(), ref.float(), rtol=TOL,
                                     atol=TOL))
            kw = {}
            if timed:
                ms = time_ms(lambda: kernels.imputed_mean(x, wn), 10)
                pms = time_ms(lambda: imputed_mean_ref(x, wn), 2)
                wl = wn.to(dtype)
                lms = time_ms(lambda: wl @ x, 5)
                bms, by = bound(arrived * P * s + P * s,
                                2 * arrived * P)
                kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                          library="w @ x", bound_ms=bms, bound_by=by)
            check("imputed_mean", ok, via="weighted_sum", dtype=dname,
                  shape=[N, P], arrived=arrived, max_abs_diff=err,
                  exact=err == 0.0, **kw)
            note(summary, "imputed_mean", err, main and kw)
            # K6 masked_gram, then K3 on it
            gr = kernels.masked_gram(x, m, wn, mean)
            ref = masked_gram_plain(x, m, wn, mean)
            err = max_abs_err(gr, ref)
            ok = (bool(torch.allclose(gr, ref, rtol=TOL, atol=TOL))
                  and torch.equal(gr, kernels.masked_gram(x, m, wn, mean)))
            sel = kernels.krum_select(gr, F)
            ok = ok and torch.equal(sel, krum_select_plain(gr, F))
            kw = {}
            if timed:
                ms = time_ms(lambda: kernels.masked_gram(x, m, wn, mean), 10)
                pms = time_ms(lambda: masked_gram_plain(x, m, wn, mean), 2)
                lms = time_ms(lambda: x @ x.T, 5)
                bms, by = bound(arrived * P * s + P * s + 4 * N * N,
                                N * (N + 1) // 2 * 2 * P)
                kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                          library="x @ x.T", bound_ms=bms, bound_by=by)
            check("masked_gram", ok, dtype=dname, shape=[N, P],
                  arrived=arrived, max_abs_diff=err, exact=err == 0.0,
                  bitwise_repeat=True, krum_select_exact=True, **kw)
            note(summary, "masked_gram", err, main and kw)
            del gr, ref
            # K7 masked_weighted_sum: one-hot live, one-hot ghost, a set
            eye = torch.eye(N, device=DEVICE)
            cases = [("one-hot live", eye[0], x[0].float())]
            if arrived < N:
                cases.append(("one-hot ghost", eye[N - 1], mean.float()))
                cases.append(("{0,1} set", eye[0] + eye[1] + eye[N - 1],
                              None))
            for label, w, want in cases:
                out = kernels.masked_weighted_sum(w, x, m, mean)
                ref = masked_weighted_sum_plain(w, x, m, mean)
                err = max_abs_err(out, ref)
                if want is None:
                    ok = bool(torch.allclose(out, ref, rtol=TOL, atol=TOL))
                else:
                    err = max(err, max_abs_err(out, want))
                    ok = err == 0.0
                kw = {}
                if timed and label == "one-hot live":
                    ms = time_ms(lambda: kernels.masked_weighted_sum(
                        w, x, m, mean), 10)
                    pms = time_ms(lambda: masked_weighted_sum_plain(
                        w, x, m, mean), 5)
                    wl = w.to(dtype)
                    lms = time_ms(lambda: wl @ x, 5)
                    bms, by = bound(P * s + 4 * P + 8 * N, 2 * P)
                    kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                              library="w @ x", bound_ms=bms, bound_by=by)
                check("masked_weighted_sum", ok, weights=label, dtype=dname,
                      shape=[N, P], arrived=arrived, max_abs_diff=err,
                      exact=err == 0.0, **kw)
                note(summary, "masked_weighted_sum", err, main and kw)
                del out, ref
            del mean
        del x
        torch.cuda.empty_cache()
    note(summary, "masked_coord_stat", masked_bucket_checks(P, gen))
    masked_hazard_checks()
    note(summary, "masked_gram", masked_gram_bulyan_checks(P, gen))
    return summary


def masked_gram_bulyan_checks(P, gen):
    """K6 at bulyan's n = 11 at full width, 9 of 11 arrived (the async
    bulyan step's quorum), fp32 (the async arena) and bf16, on the imputed
    mean of K4.  Returns the largest error."""
    from repro_torch import kernels
    from repro_torch.kernels.pairwise import masked_gram_plain

    n, arrived, worst = 11, 9, 0.0
    m = arrival_mask(arrived, n)
    _, wn = discount_weights(m)
    for dtype in (torch.float32, torch.bfloat16):
        s = torch.finfo(dtype).bits // 8
        x = (torch.randn((n, P), generator=gen, device=DEVICE,
                         dtype=torch.float32) * 1e-3).to(dtype)
        mean = kernels.imputed_mean(x, wn)
        worst = max(worst, gram_case(
            "masked_gram", lambda: kernels.masked_gram(x, m, wn, mean),
            lambda: masked_gram_plain(x, m, wn, mean), x,
            (arrived + 1) * P * s + 4 * n * n,
            dtype=str(dtype).replace("torch.", ""), arrived=arrived))
        del x, mean
        torch.cuda.empty_cache()
    return worst


# (bucket n, live rows, trimmed b = the bucket's f): the masks that the
# elastic churn run of phase 3b gives K5 (live 6, 4, 7 and 3 of buckets 6,
# 4, 8 and 4), the ghost rows packed as repeats of the first live slot
CHURN_BUCKETS = ((4, 4, 1), (4, 3, 1), (6, 6, 1), (8, 7, 2))


def masked_bucket_checks(P, gen):
    """K5 at full width, fp32 (the async arena), at the elastic churn
    run's bucket shapes and masks: median exact, trimmed mean within
    3e-6 of the plain version.  Returns the largest error."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_coord_stat_plain

    x = torch.randn((N, P), generator=gen, device=DEVICE) * 1e-3
    worst = 0.0
    for n, live, b in CHURN_BUCKETS:
        xb = x[:n]
        xb[live:] = xb[0]                      # ghost rows: the first slot
        m = arrival_mask(live, n)
        _, wn = discount_weights(m)
        for stat, bb in (("median", 0), ("trimmed_mean", b)):
            out = kernels.masked_coord_stat(xb, m, wn, stat, bb)
            ref = masked_coord_stat_plain(xb, m, wn, stat, bb)
            err = max_abs_err(out, ref)
            ok = err == 0.0 if stat == "median" else bool(
                torch.allclose(out, ref, rtol=TOL, atol=TOL))
            check("masked_coord_stat", ok, stat=stat, dtype="float32",
                  shape=[n, P], arrived=live, bucket=True, max_abs_diff=err,
                  exact=err == 0.0)
            worst = max(worst, err)
            del out, ref
    del x
    torch.cuda.empty_cache()
    return worst


def masked_hazard_checks():
    """NaN in an arrived row, NaN / +-inf in an absent row, +-inf arrived
    rows, ties, at a small width and n = 3, 4, 6, 8."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_coord_stat_plain
    from repro_torch.kernels.pairwise import masked_gram_plain
    from repro_torch.kernels.wsum import masked_weighted_sum_plain

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    d = 4099
    for n in (3, 4, 6, 8):
        b = min(2 if n == 8 else 1, (n - 1) // 2)
        m = arrival_mask(max(n - 2, 1), n)
        _, wn = discount_weights(m)
        live, absent = int(m.sum()), n - int(m.sum())
        for hazard in ("nan", "absent", "inf", "ties"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=gen, device=DEVICE) * 2.0
                if hazard == "nan":
                    x[0] = math.nan
                elif hazard == "absent" and absent:
                    x[n - 1, ::2] = math.nan
                    x[n - 1, 1::2] = math.inf
                elif hazard == "inf":
                    x[0], x[live - 1] = math.inf, -math.inf
                elif hazard == "ties":
                    x[:live] = x[0].clone()
                    x[:, ::3] = torch.round(x[:, ::3])
                x = x.to(dtype)
                errs, ok = {}, True
                for stat, bb in (("median", 0), ("trimmed_mean", b)):
                    out = kernels.masked_coord_stat(x, m, wn, stat, bb)
                    ref = masked_coord_stat_plain(x, m, wn, stat, bb)
                    errs[stat] = max_abs_err(out, ref)
                    ok = ok and (errs[stat] == 0.0 if stat == "median"
                                 else bool(torch.allclose(
                                     out, ref, rtol=TOL, atol=TOL,
                                     equal_nan=True)))
                    if hazard == "absent":
                        ok = ok and bool(torch.isfinite(out).all())
                if hazard in ("absent", "ties"):
                    mean = kernels.imputed_mean(x, wn)
                    gr = kernels.masked_gram(x, m, wn, mean)
                    ref = masked_gram_plain(x, m, wn, mean)
                    errs["masked_gram"] = max_abs_err(gr, ref)
                    ok = ok and bool(torch.allclose(gr, ref, rtol=TOL,
                                                    atol=TOL))
                    w = kernels.krum_select(gr, 1)
                    out = kernels.masked_weighted_sum(w, x, m, mean)
                    errs["masked_weighted_sum"] = max_abs_err(
                        out, masked_weighted_sum_plain(w, x, m, mean))
                    ok = (ok and errs["masked_weighted_sum"] == 0.0
                          and bool(torch.isfinite(out).all()))
                torch.cuda.synchronize()
                check("masked_hazards", ok, hazard=hazard, n=n,
                      arrived=live, dtype=str(dtype).replace("torch.", ""),
                      shape=[n, d], max_abs_diff=errs)


# ---------------------------------------------------------------------------
# phase 2c


def cge_calls(x, gr, n_keep, mask=None, mean=None):
    """CGE's apply (masked with ``mask`` / ``mean``) on the Gram ``gr`` as
    (apply(div), its plain version(div), the chain it replaces: K8 -> K4
    (K7) -> a division by a device tensor, as ``chain(div)``)."""
    from repro_torch import kernels
    from repro_torch.kernels.compare import parent_cge_apply
    from repro_torch.kernels.wsum import (_divide, cge_weighted_sum_plain,
                                          masked_cge_weighted_sum_plain)

    def chain(div):
        return _divide(parent_cge_apply(gr, x, n_keep, mask, mean), div)
    if mask is None:
        return (lambda div: kernels.cge_weighted_sum(gr, x, n_keep, div=div),
                lambda div: cge_weighted_sum_plain(gr, x, n_keep, div),
                chain)
    return (lambda div: kernels.masked_cge_weighted_sum(gr, x, mask, mean,
                                                        n_keep, div=div),
            lambda div: masked_cge_weighted_sum_plain(gr, x, mask, mean,
                                                      n_keep, div),
            chain)


def cge_apply_case(x, gr, dname, timed, mask=None, mean=None):
    """CGE's apply at full width (n - f kept), normalized and not: bitwise
    equal to its plain version, to the chain it replaces and to a repeat;
    when ``timed`` also its time with the plain version's, ``w @ x`` (w =
    1 / (n - f) on the kept live rows: with a kept ghost a partial
    yardstick, the mean term left out) and the bound.  Returns (error, the
    timing)."""
    from repro_torch import kernels
    n, P = x.shape
    name = "cge_weighted_sum" if mask is None else "masked_cge_weighted_sum"
    apply, plain, chain = cge_calls(x, gr, n - F, mask, mean)
    err, ok = 0.0, True
    for div in (n - F, None):
        out, pl, ref = apply(div), plain(div), chain(div)
        err = max(err, max_abs_err(out, pl), max_abs_err(out, ref))
        ok = (ok and same_bits_nan(out, pl) and same_bits_nan(out, ref)
              and same_bits_nan(out, apply(div)))
        del out, pl, ref
    kept = kernels.cge_select(gr, n - F) > 0.5
    live = kept if mask is None else kept & (mask > 0.5)
    ghosts = int((kept & ~live).sum())
    kw = timing(lambda: apply(n - F), lambda: plain(n - F), 10, 2,
                (int(live.sum()) + int(ghosts > 0)) * P * x.element_size()
                + 4 * P + 8 * n, (2 * (n - F) + 1) * P,
                lambda: (live.to(x.dtype) / (n - F)) @ x,
                "w @ x, w = 1/(n - f) on the kept live rows"
                + (", a partial yardstick" if ghosts else "")) if timed else {}
    check(name, ok, dtype=dname, n=n, n_keep=n - F, ghosts_kept=ghosts,
          shape=[n, P], max_abs_diff=err, **kw)
    return err, kw


def cge_aggregation(x, dname, mask=None, wn=None, arrived=None):
    """CGE's aggregation (sync, or masked with ``mask`` / ``wn``) against
    the parent's chain composed from the same kernels: the Gram (K4 ->
    K6 when masked), K8, K4 (K7), then ``/ (n - f)`` by a Python scalar
    (the reciprocal multiply torch takes on the card); and the apply alone
    against K8 -> K4 (K7) -> that divide on one Gram.  Timed in turns
    (parent, new, new, parent; CUDA events over 10 calls) and by the
    card's busy time a call in a trace (``compare.device_ms``), beside
    the predicted ms.  The two results may differ by the division's
    rounding only: at most 1 ulp."""
    from repro_torch import kernels
    from repro_torch.kernels.compare import (device_ms, parent_cge,
                                             parent_cge_apply)
    n, P = x.shape
    k = n - F
    if mask is None:
        mean = None
        gr = kernels.gram(x)

        def new():
            return kernels.kernel_cge(x, F)

        def new_stage():
            return kernels.cge_weighted_sum(gr, x, k, div=k)
    else:
        mean = kernels.imputed_mean(x, wn)
        gr = kernels.masked_gram(x, mask, wn, mean)

        def new():
            return kernels.kernel_cge_masked(x, mask, wn, F)

        def new_stage():
            return kernels.masked_cge_weighted_sum(gr, x, mask, mean, k,
                                                   div=k)

    def parent():
        return parent_cge(x, F, mask, wn)

    def parent_stage():
        return parent_cge_apply(gr, x, k, mask, mean, div=k)
    a, b = new(), parent()
    both = torch.isfinite(a) & torch.isfinite(b)
    ulps = int((a[both].view(torch.int32).long()
                - b[both].view(torch.int32).long()).abs().max())
    differ = int((a != b).sum())
    err = max_abs_err(a, b)
    same = same_bits_nan(new_stage(), a)
    del a, b, both
    ms = {}
    for label, fn in (("parent", parent), ("new", new),
                      ("parent_stage", parent_stage),
                      ("new_stage", new_stage)):
        ms[label] = time_ms(fn, 10)
    for label, fn in (("new", new), ("parent", parent),
                      ("new_stage", new_stage),
                      ("parent_stage", parent_stage)):
        ms[label] = [ms[label], time_ms(fn, 10)]
    dev = {label: device_ms(None, fn, 20)[0] for label, fn in (
        ("parent", parent), ("new", new), ("parent_stage", parent_stage),
        ("new_stage", new_stage))}
    path = "sync" if mask is None else "masked"
    ok = ulps <= 1 and same
    emit("cge_aggregation", ok=ok, path=path, dtype=dname, n=n,
         arrived=arrived, ms=ms, device_busy_ms=dev,
         predicted_ms=CGE_PREDICTED_MS.get((path, dname)),
         parent_elements_differing=differ, parent_share_differing=differ / P,
         parent_max_ulps=ulps, parent_max_abs_diff=err)
    if not ok:
        fail(f"cge aggregation ({path}): {ulps} ulps from the parent's "
             f"chain, the apply alone equal to the aggregation: {same}")


def cge_select_drive(num_params):
    """One call of the standalone K8 entry point (``kernels.cge_select``,
    the counterpart of the TPU kernel; CGE's aggregation runs its law
    inside the apply) on the Gram of a full-width bf16 stack, its launches
    counted from 0 as a user's call would launch it.  The counts stay
    out of the ``kernels`` line, whose launches are the main path's: no
    training path launches K8 now."""
    from repro_torch import kernels
    from repro_torch.kernels.select import cge_select_plain
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    x = (torch.randn((N, num_params), generator=gen, device=DEVICE)
         * 1e-3).to(torch.bfloat16)
    gr = kernels.gram(x)
    del x
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    keep = kernels.cge_select(gr, N - F)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: int(k == "cge_select") for k in counts}
    ok = counts == want and same_bits(keep, cge_select_plain(gr, N - F))
    emit("cge_select_entry", ok=ok, n=N, n_keep=N - F, launches=counts)
    if not ok:
        fail(f"cge_select entry: launches {counts} (expected {want})")
    torch.cuda.empty_cache()


def selection_kernel_checks(num_params):
    """K8-K11, K13 and CGE's apply against their plain versions at the
    main path's shapes (see the module docstring), then the small-width
    hazards.  The summary takes the bf16 arena's numbers (the sync arena):
    K8, K9 and CGE's apply at n = 8, K10 at n = 8 with m_krum's 3 picks,
    K11 with multi_krum's order, K13 at n = 11."""
    from repro_torch import kernels
    from repro_torch.kernels.ops import mda_order
    from repro_torch.kernels.select import (bulyan_beta, bulyan_coord_plain,
                                            cge_select_plain, gram_d2,
                                            iterative_order_plain,
                                            multi_krum_order_plain)
    from repro_torch.kernels.wsum import ordered_apply_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    names = ("cge_select", "multi_krum_order", "iterative_order",
             "ordered_apply", "bulyan_coord", "cge_weighted_sum")
    summary = {k: {"max_abs_err": 0.0} for k in names}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        main = dtype == torch.bfloat16
        for n in (N, 11):
            theta = n - 2 * F
            x = (torch.randn((n, P), generator=gen, device=DEVICE,
                             dtype=torch.float32) * 1e-3).to(dtype)
            gr = kernels.gram(x)
            sym = torch.equal(gr, gr.T)
            timed = main and n == N
            # K8 cge_select
            w = kernels.cge_select(gr, n - F)
            err = max_abs_err(w, cge_select_plain(gr, n - F))
            kw = timing(lambda: kernels.cge_select(gr, n - F),
                        lambda: cge_select_plain(gr, n - F), LAUNCH_REPS, 5,
                        8 * n, 2 * n * n) if timed else {}
            check("cge_select", err == 0.0 and sym
                  and float(w.sum()) == n - F, dtype=dname, n=n,
                  n_keep=n - F, gram_symmetric=sym, max_abs_diff=err, **kw)
            note(summary, "cge_select", err, kw)
            # CGE's apply (K4 under the CGE flag)
            err, kw = cge_apply_case(x, gr, dname, main and n == N)
            note(summary, "cge_weighted_sum", err, kw)
            if timed:
                cge_aggregation(x, dname)
            # K9 multi_krum_order
            for m in (2, 3):
                o = kernels.multi_krum_order(gr, F, m)
                err = max_abs_err(o.float(),
                                  multi_krum_order_plain(gr, F, m).float())
                ok = err == 0.0 and sorted(o[o < n].tolist()) == list(
                    range(m))
                kw = timing(lambda: kernels.multi_krum_order(gr, F, m),
                            lambda: multi_krum_order_plain(gr, F, m),
                            LAUNCH_REPS, 5,
                            4 * n * n + 4 * n, n * n * (n + 4)) if (
                    timed and m == 3) else {}
                check("multi_krum_order", ok, dtype=dname, n=n, m=m,
                      max_abs_diff=err, **kw)
                note(summary, "multi_krum_order", err, kw)
            # K10 iterative_order
            for k_total in sorted({2, 3, theta}):
                o = kernels.iterative_order(gr, F, k_total)
                err = max_abs_err(o.float(), iterative_order_plain(
                    gr, F, k_total).float())
                ok = err == 0.0 and sorted(o[o < n].tolist()) == list(
                    range(k_total))
                kw = timing(lambda: kernels.iterative_order(gr, F, k_total),
                            lambda: iterative_order_plain(gr, F, k_total),
                            LAUNCH_REPS, 5, 4 * n * n + 4 * n,
                            k_total * n * n * (n + 4)) if (
                    main and (n, k_total) in ((N, 3), (11, theta))) else {}
                check("iterative_order", ok, dtype=dname, n=n,
                      k_total=k_total, max_abs_diff=err, **kw)
                note(summary, "iterative_order", err,
                     kw if (n, k_total) == (N, 3) else None)
            # K11 ordered_apply with the orders of the three rules
            if n == N:
                cases = (("multi_krum", kernels.multi_krum_order(gr, F, 3),
                          3),
                         ("m_krum", kernels.iterative_order(gr, F, 3), 3),
                         ("mda", mda_order(gram_d2(gr), n, F), n - F))
                for rule, order, k in cases:
                    out = kernels.ordered_apply(order, x, k, div=k)
                    err = max_abs_err(out, ordered_apply_plain(order, x, k,
                                                               div=k))
                    wl = torch.where(order < k, 1.0 / k, 0.0).to(dtype)
                    kw = timing(
                        lambda: kernels.ordered_apply(order, x, k, div=k),
                        lambda: ordered_apply_plain(order, x, k, div=k),
                        10, 2, k * P * s + 4 * P + 4 * n, (k + 1) * P,
                        lambda: wl @ x, "w @ x, w = 1/k on the picked rows")
                    check("ordered_apply", err == 0.0, dtype=dname, n=n,
                          k=k, order_of=rule, shape=[n, P],
                          max_abs_diff=err, **kw)
                    note(summary, "ordered_apply", err,
                         kw if main and rule == "multi_krum" else None)
                    del out
            # K13 bulyan_coord on K10's theta picks
            sel = (kernels.iterative_order(gr, F, theta) < theta).float()
            beta = bulyan_beta(theta, F)
            out = kernels.bulyan_coord(x, sel, theta, F)
            err = max_abs_err(out, bulyan_coord_plain(x, sel, theta, F))
            del out
            picked = sel > 0.5
            kw = timing(lambda: kernels.bulyan_coord(x, sel, theta, F),
                        lambda: bulyan_coord_plain(x, sel, theta, F), 10, 2,
                        theta * P * s + 4 * P + 4 * n,
                        (n * (n - 1) + 3 * beta * n) * P,
                        lambda: torch.sort(x[picked], dim=0),
                        "torch.sort(g[sel], dim=0), a partial yardstick")
            check("bulyan_coord", err == 0.0, dtype=dname, n=n, theta=theta,
                  beta=beta, shape=[n, P], max_abs_diff=err,
                  predicted_ms=BULYAN_PREDICTED_MS.get(
                      ("bulyan_coord", dname, n)), **kw)
            note(summary, "bulyan_coord", err,
                 kw if main and n == 11 else None)
            # aggregation time of each selection rule at this n (the
            # spec's call, every stage included)
            if main:
                from repro_torch.core.aggregators import make_spec
                agg_ms = {}
                for rule, (rn, hyper, _) in SEL_RULES.items():
                    if rn == n:
                        spec = make_spec(rule, f=F, n=n, **hyper)
                        agg_ms[rule] = time_ms(
                            lambda: spec.aggregate_flat(x), 5)
                emit("kernels", aggregation_ms=agg_ms, dtype=dname, n=n)
            del x, gr, sel
            torch.cuda.empty_cache()
    selection_hazard_checks()
    return summary


def selection_hazard_checks():
    """K8-K11 and K13 on NaN rows, +-inf rows, isolated non-finite
    coordinates, duplicated rows (every score tied) and a near pair (the
    K10 pair tie), with rounded columns (equidistant values), at a small
    width and n = 3, 4, 8, 11, 16: every result exact against the plain
    version, the card's Gram bitwise symmetric."""
    from repro_torch import kernels
    from repro_torch.kernels.select import (bulyan_coord_plain,
                                            cge_select_plain,
                                            iterative_order_plain,
                                            multi_krum_order_plain)
    from repro_torch.kernels.wsum import ordered_apply_plain

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    d = 4099
    for n in (3, 4, 8, 11, 16):
        f = 1 if n < 8 else F
        theta = max(n - 2 * f, 1)
        for hazard in ("nan", "inf", "spots", "dup", "pair"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=gen, device=DEVICE) * 2.0
                x[:, ::5] = torch.round(x[:, ::5])
                if hazard == "nan":
                    x[1] = math.nan
                elif hazard == "inf":
                    x[1], x[n - 1] = math.inf, -math.inf
                elif hazard == "spots":
                    x[1, 7], x[n - 1, 7], x[0, 11] = (math.nan, math.inf,
                                                      -math.inf)
                elif hazard == "dup":
                    x[:] = x[0].clone()
                else:
                    x[n - 1] = x[n - 2] + 1e-3
                x = x.to(dtype)
                gr = kernels.gram(x)
                errs = {"gram_symmetry": max_abs_err(gr, gr.T)}
                errs["cge_select"] = max_abs_err(
                    kernels.cge_select(gr, n - f), cge_select_plain(gr, n - f))
                m = min(3, n)
                errs["multi_krum_order"] = max_abs_err(
                    kernels.multi_krum_order(gr, f, m).float(),
                    multi_krum_order_plain(gr, f, m).float())
                ok = True
                for k_total in sorted({m, theta, n}):
                    o = kernels.iterative_order(gr, f, k_total)
                    errs[f"iterative_order_{k_total}"] = max_abs_err(
                        o.float(), iterative_order_plain(gr, f,
                                                         k_total).float())
                    ok = ok and sorted(o[o < n].tolist()) == list(
                        range(k_total))
                for order in (kernels.multi_krum_order(gr, f, m),
                              kernels.iterative_order(gr, f, m)):
                    errs["ordered_apply"] = max(
                        errs.get("ordered_apply", 0.0),
                        max_abs_err(kernels.ordered_apply(order, x, m, div=m),
                                    ordered_apply_plain(order, x, m, div=m)))
                sel = (kernels.iterative_order(gr, f, theta)
                       < theta).float()
                errs["bulyan_coord"] = max_abs_err(
                    kernels.bulyan_coord(x, sel, theta, f),
                    bulyan_coord_plain(x, sel, theta, f))
                torch.cuda.synchronize()
                ok = ok and all(v == 0.0 for v in errs.values())
                check("selection_hazards", ok, hazard=hazard, n=n, f=f,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=errs)


def select_predicted_ms(name, n, k_total=None):
    if name == "iterative_order" and n == 64 and k_total > 3:
        return SELECT_PREDICTED_MS["k10_n64_theta"]
    if name == "multi_krum_order":
        return SELECT_PREDICTED_MS["multi_krum_order"]
    if name.endswith("cge_weighted_sum"):
        return SELECT_PREDICTED_MS["cge_apply"]
    return SELECT_PREDICTED_MS["host"]


def select_sweep_checks():
    """K3, K8, K9, K10 and CGE's sync and masked applies at every n of
    GRAM_SWEEP_N on the card's Gram of a seeded (n, 256) stack and of its
    hazards (every row equal: every score and norm tied; the pair tie that
    K10's secondary breaks; a NaN Gram: every round all-inf, every norm
    NaN), f = max(2, (n - 3) // 4): K9 at m in {1, 3, n - f}, K10 at
    k_total in {3, theta, n} (each clamped to [0, n]), K8 and the applies
    keeping max(n - f, 1) (K8 also 1), the applies in fp32 and bf16 (the
    masked one at max(n - 2, 1) arrived), normalized and not: each result
    bitwise equal to its plain version and to a repeat call, the applies
    also to the chain they replace.  Without a hazard K3, K9 (m = 3), K10
    and the applies (bf16, normalized) are timed (time_ms, LAUNCH_REPS)
    beside their predicted ms."""
    from repro_torch import kernels
    from repro_torch.kernels.compare import f_of, theta_of
    from repro_torch.kernels.select import (cge_select_plain,
                                            iterative_order_plain,
                                            krum_select_plain,
                                            multi_krum_order_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(24)
    worst = {k: 0.0 for k in ("krum_select", "iterative_order",
                              "multi_krum_order", "cge_select",
                              "cge_weighted_sum", "masked_cge_weighted_sum")}
    for n in GRAM_SWEEP_N:
        f, theta = f_of(n), theta_of(n)
        keep_n = max(n - f, 1)
        base = torch.randn((n, 256), generator=gen, device=DEVICE)
        m = arrival_mask(max(n - 2, 1), n)
        _, wn = discount_weights(m)
        for hazard in SELECT_SWEEP_HAZARDS:
            x = base.clone()
            if hazard == "dup":
                x[:] = x[0].clone()
            elif hazard == "pair" and n >= 3:
                x[n - 2] = x[n - 1] + 1e-3
                x[n - 1] = x[n - 1] + 0.5 * x[0]
            gr = kernels.gram(x)
            if hazard == "all_nan":
                gr = torch.full_like(gr, math.nan)
            cases = [("krum_select", None, lambda: kernels.krum_select(gr, f),
                      lambda: krum_select_plain(gr, f), True)]
            for k_total in sorted({min(3, n), theta, n}):
                cases.append((
                    "iterative_order", k_total,
                    lambda k=k_total: kernels.iterative_order(gr, f, k),
                    lambda k=k_total: iterative_order_plain(gr, f, k), True))
            for mm in sorted({min(1, n), min(3, n), max(n - f, 0)}):
                cases.append((
                    "multi_krum_order", mm,
                    lambda mm=mm: kernels.multi_krum_order(gr, f, mm),
                    lambda mm=mm: multi_krum_order_plain(gr, f, mm),
                    mm == min(3, n)))
            for nk in sorted({keep_n, 1}):
                cases.append((
                    "cge_select", nk,
                    lambda nk=nk: kernels.cge_select(gr, nk),
                    lambda nk=nk: cge_select_plain(gr, nk), False))
            errs, ok, timed = {}, True, {}
            for name, k_total, call, plain, timeit in cases:
                out, ref = call(), plain()
                err = max_abs_err(out.float(), ref.float())
                ok = ok and torch.equal(out, ref) and torch.equal(out, call())
                label = name if k_total is None else f"{name}_{k_total}"
                errs[label] = err
                worst[name] = max(worst[name], err)
                if hazard is None and timeit:
                    timed[label] = {
                        "ms": time_ms(call, LAUNCH_REPS),
                        "predicted_ms": select_predicted_ms(name, n,
                                                            k_total)}
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype)
                mean = kernels.imputed_mean(xd, wn)
                grams = {"cge_weighted_sum": (kernels.gram(xd), None, None),
                         "masked_cge_weighted_sum": (
                             kernels.masked_gram(xd, m, wn, mean), m, mean)}
                for name, (g2, mk, mn) in grams.items():
                    if hazard == "all_nan":
                        g2 = torch.full_like(g2, math.nan)
                    apply, plain, chain = cge_calls(xd, g2, keep_n, mk, mn)
                    for div in (keep_n, None):
                        out = apply(div)
                        err = max(max_abs_err(out, plain(div)),
                                  max_abs_err(out, chain(div)))
                        ok = (ok and same_bits_nan(out, plain(div))
                              and same_bits_nan(out, chain(div))
                              and same_bits_nan(out, apply(div)))
                        label = f"{name}_{str(dtype)[6:]}_{div or 'sum'}"
                        errs[label] = err
                        worst[name] = max(worst[name], err)
                        if (hazard is None and dtype == torch.bfloat16
                                and div):
                            timed[name] = {
                                "ms": time_ms(lambda: apply(div),
                                              LAUNCH_REPS),
                                "predicted_ms": select_predicted_ms(name, n)}
            torch.cuda.synchronize()
            check("select_sweep", ok, n=n, f=f, theta=theta, hazard=hazard,
                  max_abs_diff=errs, **({"timed": timed} if timed else {}))
    return worst


# ---------------------------------------------------------------------------
# phase 2d


def ghost_first_order(m, k):
    """(n,) int32 pick order with the first absent row at rank 0 and the
    first k - 1 live rows after it (sentinel n elsewhere)."""
    n = m.shape[0]
    order = torch.full((n,), n, dtype=torch.int32, device=m.device)
    rows = (torch.nonzero(m <= 0.5).flatten()[:1].tolist()
            + torch.nonzero(m > 0.5).flatten().tolist())[:k]
    order[rows] = torch.arange(len(rows), dtype=torch.int32, device=m.device)
    return order


def with_ghost(sel, m):
    """``sel`` with its last selected live row swapped for the first absent
    row, when no absent row is selected yet (else ``sel`` itself)."""
    picked, live = sel > 0.5, m > 0.5
    if bool((picked & ~live).any()) or bool(live.all()):
        return sel
    out = sel.clone()
    out[torch.nonzero(picked & live).flatten()[-1]] = 0.0
    out[torch.nonzero(~live).flatten()[0]] = 1.0
    return out


def masked_selection_kernel_checks(num_params):
    """K12, K14, K16 and masked CGE's apply against their plain versions
    at the main path's shapes (see the module docstring), then the
    small-width hazards.  The ghost rows are the last ones (the mask's
    first rows arrive).  The summary takes the fp32 buffer's numbers (the
    async arena): K12 with multi_krum's order, K14 at n = 11 on K10's
    picks, K16 and the CGE apply at 6 of 8."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_sign_vote_plain
    from repro_torch.kernels.ops import mda_order
    from repro_torch.kernels.select import (bulyan_beta, gram_d2,
                                            masked_bulyan_coord_plain)
    from repro_torch.kernels.wsum import masked_ordered_apply_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    names = ("masked_ordered_apply", "masked_bulyan_coord",
             "masked_sign_vote", "masked_cge_weighted_sum")
    summary = {k: {"max_abs_err": 0.0} for k in names}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        main = dtype == torch.float32
        for n, arrived in ((N, 6), (11, 9)):
            x = (torch.randn((n, P), generator=gen, device=DEVICE,
                             dtype=torch.float32) * 1e-3).to(dtype)
            m = arrival_mask(arrived, n)
            live = m > 0.5
            _, wn = discount_weights(m)
            mean = kernels.imputed_mean(x, wn)
            gr = kernels.masked_gram(x, m, wn, mean)
            # masked CGE's apply (K7 under the CGE flag), the ghosts kept
            err, kw = cge_apply_case(x, gr, dname, main and n == N, m, mean)
            note(summary, "masked_cge_weighted_sum", err, kw)
            if main and n == N:
                cge_aggregation(x, dname, m, wn, arrived)
            if n == N:
                # K12 with the rules' orders on the imputed Gram
                cases = (("multi_krum", kernels.multi_krum_order(gr, F, 3),
                          3),
                         ("m_krum", kernels.iterative_order(gr, F, 3), 3),
                         ("mda", mda_order(gram_d2(gr), n, F), n - F),
                         ("ghost first", ghost_first_order(m, 3), 3))
                for rule, order, k in cases:
                    picked = order < k
                    ghost = bool((picked & ~live).any())
                    out = kernels.masked_ordered_apply(order, x, m, mean, k,
                                                       div=k)
                    err = max_abs_err(out, masked_ordered_apply_plain(
                        order, x, m, mean, k, div=k))
                    del out
                    reads = int((picked & live).sum()) + int(ghost)
                    kw = timing(
                        lambda: kernels.masked_ordered_apply(
                            order, x, m, mean, k, div=k),
                        lambda: masked_ordered_apply_plain(
                            order, x, m, mean, k, div=k), 10, 2,
                        reads * P * s + 4 * P + 8 * n, (k + 1) * P) if (
                        rule != "ghost first") else {}
                    check("masked_ordered_apply", err == 0.0, dtype=dname,
                          n=n, k=k, order_of=rule, arrived=arrived,
                          ghost_picked=ghost, shape=[n, P],
                          max_abs_diff=err, **kw)
                    note(summary, "masked_ordered_apply", err,
                         kw if main and rule == "multi_krum" else None)
                # K16 at masks of 6, 1 and 0 of 8
                for arr in (6, 1, 0):
                    mm = arrival_mask(arr, n)
                    out = kernels.masked_sign_vote(x, mm, mm)
                    err = max_abs_err(out, masked_sign_vote_plain(x, mm, mm))
                    ok = err == 0.0 and (arr > 0 or not bool(out.any()))
                    del out
                    kw = timing(
                        lambda: kernels.masked_sign_vote(x, mm, mm),
                        lambda: masked_sign_vote_plain(x, mm, mm), 10, 2,
                        arr * P * s + 4 * P + 4 * n, 2 * arr * P,
                        lambda: torch.sign((torch.sign(x)
                                            * mm[:, None]).sum(0)),
                        "torch.sign((torch.sign(g) * mask[:, None]).sum(0))"
                        ", a partial yardstick (four calls)") if (
                        arr == 6) else {}
                    check("masked_sign_vote", ok, dtype=dname, n=n,
                          arrived=arr, shape=[n, P], max_abs_diff=err, **kw)
                    note(summary, "masked_sign_vote", err,
                         kw if main and arr == 6 else None)
            else:
                # K14 on K10's theta picks, then with a ghost selected
                theta = n - 2 * F
                beta = bulyan_beta(theta, F)
                sel = (kernels.iterative_order(gr, F, theta)
                       < theta).float()
                for label, sl in (("K10 picks", sel),
                                  ("ghost selected", with_ghost(sel, m))):
                    if label != "K10 picks" and sl is sel:
                        continue
                    picked = sl > 0.5
                    ghost = bool((picked & ~live).any())
                    out = kernels.masked_bulyan_coord(x, m, mean, sl, theta,
                                                      F)
                    err = max_abs_err(out, masked_bulyan_coord_plain(
                        x, m, mean, sl, theta, F))
                    del out
                    reads = int((picked & live).sum()) + int(ghost)
                    kw = timing(
                        lambda: kernels.masked_bulyan_coord(
                            x, m, mean, sl, theta, F),
                        lambda: masked_bulyan_coord_plain(
                            x, m, mean, sl, theta, F), 10, 2,
                        reads * P * s + 4 * P + 12 * n,
                        (n * (n - 1) + 3 * beta * n) * P,
                        lambda: torch.sort(x[picked], dim=0),
                        "torch.sort(g[sel], dim=0), a partial yardstick") if (
                        label == "K10 picks") else {}
                    pred = BULYAN_PREDICTED_MS.get(
                        ("masked_bulyan_coord", dname, n)) if kw else None
                    check("masked_bulyan_coord", err == 0.0, dtype=dname,
                          n=n, theta=theta, beta=beta, arrived=arrived,
                          selection=label, ghost_selected=ghost,
                          shape=[n, P], max_abs_diff=err, predicted_ms=pred,
                          **kw)
                    note(summary, "masked_bulyan_coord", err,
                         kw if main and label == "K10 picks" else None)
                if main:
                    # the async bulyan aggregation (the spec's masked call,
                    # every stage included)
                    from repro_torch.core.aggregators import make_spec
                    spec = make_spec("bulyan", f=F, n=n)
                    w, _ = discount_weights(m)
                    emit("kernels", masked_aggregation_ms={
                        "bulyan": time_ms(lambda: spec.aggregate_flat(
                            x, mask=m, weights=w), 5)}, dtype=dname, n=n,
                         arrived=arrived)
            del x, gr, mean
            torch.cuda.empty_cache()
    masked_selection_hazard_checks()
    return summary


def masked_selection_hazard_checks():
    """K12 and K14 on NaN and +-inf live rows, NaN / +inf in an absent row
    (never read), and tied rows with rounded columns, at a small width, n
    = 3, 4, 8, 11, 16 and n - 2 or 1 rows arrived: exact against the plain
    versions, a ghost among the picks and the selected rows."""
    from repro_torch import kernels
    from repro_torch.kernels.select import masked_bulyan_coord_plain
    from repro_torch.kernels.wsum import masked_ordered_apply_plain

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    d = 4099
    for n in (3, 4, 8, 11, 16):
        f = 1 if n < 8 else F
        theta = max(n - 2 * f, 1)
        for arrived in (max(n - 2, 1), 1):
            m = arrival_mask(arrived, n)
            _, wn = discount_weights(m)
            for hazard in ("nan", "inf", "absent", "ties"):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((n, d), generator=gen,
                                    device=DEVICE) * 2.0
                    x[:, ::5] = torch.round(x[:, ::5])
                    if hazard == "nan":
                        x[0, ::7] = math.nan
                    elif hazard == "inf":
                        x[0, ::3], x[arrived - 1, 1::3] = math.inf, -math.inf
                    elif hazard == "absent":
                        x[n - 1, ::2], x[n - 1, 1::2] = math.nan, math.inf
                    else:
                        x[:arrived] = x[0].clone()
                    x = x.to(dtype)
                    mean = kernels.imputed_mean(x, wn)
                    gr = kernels.masked_gram(x, m, wn, mean)
                    k = min(3, n)
                    errs = {}
                    for name, order in (
                            ("multi_krum", kernels.multi_krum_order(gr, f,
                                                                    k)),
                            ("m_krum", kernels.iterative_order(gr, f, k)),
                            ("ghost first", ghost_first_order(m, k))):
                        kk = int((order < n).sum())
                        errs[f"masked_ordered_apply {name}"] = max_abs_err(
                            kernels.masked_ordered_apply(order, x, m, mean,
                                                         kk, div=kk),
                            masked_ordered_apply_plain(order, x, m, mean, kk,
                                                       div=kk))
                    sel = (kernels.iterative_order(gr, f, theta)
                           < theta).float()
                    for label, sl in (("K10", sel),
                                      ("ghost", with_ghost(sel, m))):
                        errs[f"masked_bulyan_coord {label}"] = max_abs_err(
                            kernels.masked_bulyan_coord(x, m, mean, sl,
                                                        theta, f),
                            masked_bulyan_coord_plain(x, m, mean, sl, theta,
                                                      f))
                    torch.cuda.synchronize()
                    check("masked_selection_hazards",
                          all(v == 0.0 for v in errs.values()),
                          hazard=hazard, n=n, arrived=arrived,
                          dtype=str(dtype).replace("torch.", ""),
                          shape=[n, d], max_abs_diff=errs)
    # K14's all-inf rounds: at n = 16 (theta 12, beta 8) with 8 of the
    # selected values infinite in every third column, the last 4 rounds
    # find only +inf distances and take the first row, row 0: absent and
    # unselected, so its value is the (finite) mean, never its NaN bits
    n, theta = 16, 16 - 2 * F
    m = torch.ones(n, device=DEVICE)
    m[0] = 0.0
    sel = torch.zeros(n, device=DEVICE)
    sel[1:theta + 1] = 1.0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=gen, device=DEVICE)
        x[0] = math.nan
        x[1:5, ::3], x[5:9, ::3] = math.inf, -math.inf
        x = x.to(dtype)
        mean = torch.full((d,), 0.25, device=DEVICE).to(dtype)
        out = kernels.masked_bulyan_coord(x, m, mean, sel, theta, F)
        err = max_abs_err(out, masked_bulyan_coord_plain(x, m, mean, sel,
                                                         theta, F))
        torch.cuda.synchronize()
        check("masked_selection_hazards",
              err == 0.0 and bool(torch.isfinite(out).all()),
              hazard="all-inf rounds", n=n, theta=theta,
              dtype=str(dtype).replace("torch.", ""), shape=[n, d],
              max_abs_diff={"masked_bulyan_coord": err})


# Bulyan's coordinate stage beyond the main path: the sweep's n (the
# Gram's), its (d, leading stride, view offset) widths, and the hazard
# columns of its (4099, 4112) stack
BULYAN_SWEEP_WIDTHS = ((1, 1, 0), (127, 127, 0), (4099, 4099, 0),
                       (4099, 4112, 0), (4099, 4112, 1))
BULYAN_HAZARDS = ("signed_zero", "overflow", "subnormal", "inf_selected",
                  "nan_unselected", "nan_7th", "more_than_theta",
                  "fewer_than_theta")


def same_bits_nan(a, b):
    """Bitwise equality of two fp32 tensors, NaN equal to NaN whatever
    its payload."""
    an, bn = torch.isnan(a), torch.isnan(b)
    return torch.equal(an, bn) and same_bits(a[~an], b[~bn])


def bulyan_hazard(base, sel, gen, hazard, theta):
    """Writes ``hazard`` into the (n, ld) fp32 ``base`` and returns the
    selection: +-0 on most rows every 5th column (the median +-0);
    +-3e38 / +-1e38 / 2e38 every 3rd column (|x - med| overflows, the
    all-inf rounds take row 0, selected or not); a few fp32 subnormal ulps
    every 2nd column (halving the median's sum rounds: it must not be
    contracted into x - med); +inf and -inf in selected rows every 3rd
    column (infinite distances that a round may or may not reach); NaN in
    every unselected row; NaN in one selected row every 7th column (a
    warp mixes the fast and the exact path); theta + 2 or theta - 2 rows
    selected."""
    n, ld = base.shape
    picked = torch.nonzero(sel > 0.5).flatten()
    if hazard == "signed_zero":
        z = base[: n // 2 + 1, ::5]
        z[:] = torch.where(torch.rand(z.shape, generator=gen,
                                      device=DEVICE) < 0.5, 0.0, -0.0)
    elif hazard == "overflow":
        big = torch.tensor([3e38, -3e38, 1e38, -1e38, 2e38], device=DEVICE)
        cols = base[:, ::3]
        cols[:] = big[torch.randint(0, 5, cols.shape, generator=gen,
                                    device=DEVICE)]
    elif hazard == "subnormal":
        base[:, ::2] *= 1e-44
    elif hazard == "inf_selected":
        base[picked[0], ::3] = math.inf
        base[picked[-1], 1::3] = -math.inf
    elif hazard == "nan_unselected":
        base[sel <= 0.5] = math.nan
    elif hazard == "nan_7th":
        base[picked[0], ::7] = math.nan
    elif hazard in ("more_than_theta", "fewer_than_theta"):
        k = theta + 2 if hazard == "more_than_theta" else theta - 2
        sel = torch.zeros(n, device=DEVICE)
        sel[torch.randperm(n, generator=gen, device=DEVICE)[:max(min(k, n),
                                                                 0)]] = 1.0
    return sel


def bulyan_sweep_checks():
    """K13 and K14 at every n of GRAM_SWEEP_N, bf16 and fp32, theta in {n -
    2f, n - 2f - 1, n} and f in {0, max((n - 3) // 4, 1)}, at the
    BULYAN_SWEEP_WIDTHS (the offset view misaligns the vectors: the
    scalar path) and, on the (4099, 4112) stack, each BULYAN_HAZARDS
    column; K14 with rows n // 2, n // 2 + 3, ... absent and NaN-filled
    (never read), its mean drawn apart.  Each case bitwise equal to its
    plain version (NaN to NaN) and to a repeat; an unselected NaN never
    reaches K13's output (nor an absent one K14's).  One line per n.
    Returns the largest error of each kernel."""
    from repro_torch import kernels
    from repro_torch.kernels.select import (bulyan_beta, bulyan_coord_plain,
                                            masked_bulyan_coord_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(19)
    worst = {"bulyan_coord": 0.0, "masked_bulyan_coord": 0.0}
    for n in GRAM_SWEEP_N:
        m = torch.ones(n, device=DEVICE)
        m[n // 2::3] = 0.0
        absent = m <= 0.5
        errs = {"bulyan_coord": 0.0, "masked_bulyan_coord": 0.0}
        cases = 0
        fn = max((n - 3) // 4, 1)
        for f in (0, fn):
            for theta in sorted({max(n - 2 * f, 1), max(n - 2 * f - 1, 1),
                                 n}):
                for dtype in (torch.bfloat16, torch.float32):
                    for d, ld, off in BULYAN_SWEEP_WIDTHS:
                        hazards = (None,) + (BULYAN_HAZARDS if (d, ld, off)
                                             == (4099, 4112, 0) else ())
                        for hazard in hazards:
                            base = torch.randn((n, ld + off), generator=gen,
                                               device=DEVICE) * 2.0
                            sel = torch.zeros(n, device=DEVICE)
                            sel[torch.randperm(n, generator=gen,
                                               device=DEVICE)[:theta]] = 1.0
                            sel = bulyan_hazard(base, sel, gen, hazard,
                                                theta)
                            k = int(sel.sum())
                            base = base.to(dtype)
                            x = base[:, off:off + d]
                            out = kernels.bulyan_coord(x, sel, theta, f)
                            ref = bulyan_coord_plain(x, sel, theta, f)
                            ok = (same_bits_nan(out, ref) and same_bits_nan(
                                out, kernels.bulyan_coord(x, sel, theta, f)))
                            clean = (hazard == "nan_unselected"
                                     and k >= bulyan_beta(theta, f))
                            if clean:
                                ok = ok and bool(torch.isfinite(out).all())
                            errs["bulyan_coord"] = max(
                                errs["bulyan_coord"], max_abs_err(out, ref))
                            base[absent] = math.nan      # never read by K14
                            mean = (torch.randn(d + off, generator=gen,
                                                device=DEVICE)
                                    * 2.0).to(dtype)[off:]
                            out = kernels.masked_bulyan_coord(x, m, mean, sel,
                                                              theta, f)
                            ref = masked_bulyan_coord_plain(x, m, mean, sel,
                                                            theta, f)
                            ok_m = (same_bits_nan(out, ref) and same_bits_nan(
                                out, kernels.masked_bulyan_coord(
                                    x, m, mean, sel, theta, f)))
                            if clean or (hazard is None and k >= bulyan_beta(
                                    theta, f)):
                                ok_m = ok_m and bool(
                                    torch.isfinite(out).all())
                            errs["masked_bulyan_coord"] = max(
                                errs["masked_bulyan_coord"],
                                max_abs_err(out, ref))
                            cases += 2
                            if not (ok and ok_m):
                                check("bulyan_sweep", False, n=n, f=f,
                                      theta=theta, selected=k, d=d, ld=ld,
                                      offset=off, hazard=hazard,
                                      dtype=str(dtype), bulyan_coord_ok=ok,
                                      masked_bulyan_coord_ok=ok_m,
                                      max_abs_diff=errs)
        torch.cuda.synchronize()
        check("bulyan_sweep", True, n=n, cases=cases,
              arrived=n - int(absent.sum()), max_abs_diff=errs,
              bitwise=True, bitwise_repeat=True)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
    return worst


# ---------------------------------------------------------------------------
# phase 2e


def scaled_kernel_checks(num_params):
    """K18, K19, K20 and K15 on codes at the main path's shapes (n = 8, P
    = 124,668,672), int8 and fp8 codes of a seeded fp32 arena quantized on
    the card, masks of 6, 1 and 0 of 8 arrived; the quantize time; the
    dequant-copy gate; the hazards at a small width.  The summary takes
    the int8 numbers (6 of 8 arrived for K19 and K20)."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.masked import (scaled_coord_stat_plain,
                                            scaled_masked_coord_stat_plain,
                                            scaled_masked_sign_vote_plain,
                                            sign_vote_plain)

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    names = ("scaled_coord_stat", "scaled_masked_coord_stat",
             "scaled_masked_sign_vote")
    summary = {k: {"max_abs_err": 0.0} for k in names}
    x = torch.randn((N, P), generator=gen, device=DEVICE) * 1e-3
    xb = x.bfloat16()                 # the synchronous step's arena dtype
    for qdt in QUANT:
        main = qdt == "int8"
        for arena in (x, xb):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            codes, qs = quantize_rows(arena, qdt)
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            del codes, qs
            q_ms = time_ms(lambda: quantize_rows(arena, qdt), 3)
            emit("kernels", quantize_ms=q_ms, dtype=qdt, shape=[N, P],
                 arena=str(arena.dtype).replace("torch.", ""),
                 peak_rise_gb=rise / 1e9,
                 bound_ms=bound(arena.numel() * arena.element_size()
                                + N * P + 4 * N, 4 * N * P)[0])
        codes, qs = quantize_rows(x, qdt)
        # K18 scaled_coord_stat
        for stat, b in (("median", 0), ("trimmed_mean", 2)):
            out = kernels.scaled_coord_stat(codes, qs, stat, b)
            ref = scaled_coord_stat_plain(codes, qs, stat, b)
            err = max_abs_err(out, ref)
            ok = err == 0.0 if stat == "median" else bool(
                torch.allclose(out, ref, rtol=TOL, atol=TOL))
            del out, ref
            kw = timing(lambda: kernels.scaled_coord_stat(codes, qs, stat, b),
                        lambda: scaled_coord_stat_plain(codes, qs, stat, b),
                        10, 2, N * P + 4 * N + 4 * P,
                        N * (N - 1) // 2 * 2 * P + N * P)
            check("scaled_coord_stat", ok, stat=stat, dtype=qdt,
                  shape=[N, P], max_abs_diff=err, exact=err == 0.0,
                  predicted_ms=SCALED_PREDICTED_MS[
                      ("scaled_coord_stat", qdt)], **kw)
            note(summary, "scaled_coord_stat", err,
                 main and stat == "median" and kw)
        for arrived in (6, 1, 0):
            m = arrival_mask(arrived)
            _, wn = discount_weights(m)
            timed = arrived == 6
            # K19 scaled_masked_coord_stat
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                out = kernels.scaled_masked_coord_stat(codes, qs, m, wn,
                                                       stat, b)
                ref = scaled_masked_coord_stat_plain(codes, qs, m, wn, stat,
                                                     b)
                err = max_abs_err(out, ref)
                ok = err == 0.0 if stat == "median" else bool(
                    torch.allclose(out, ref, rtol=TOL, atol=TOL))
                if arrived == 0:
                    ok = ok and not bool(out.any())
                del out, ref
                kw = timing(
                    lambda: kernels.scaled_masked_coord_stat(
                        codes, qs, m, wn, stat, b),
                    lambda: scaled_masked_coord_stat_plain(
                        codes, qs, m, wn, stat, b),
                    10, 2, arrived * P + 8 * N + 4 * P,
                    N * (N - 1) // 2 * 2 * P + arrived * P) if timed else {}
                if timed:
                    kw["predicted_ms"] = SCALED_PREDICTED_MS[
                        ("scaled_masked_coord_stat", qdt)]
                check("scaled_masked_coord_stat", ok, stat=stat, dtype=qdt,
                      shape=[N, P], arrived=arrived, max_abs_diff=err,
                      exact=err == 0.0, **kw)
                note(summary, "scaled_masked_coord_stat", err,
                     main and stat == "trimmed_mean" and kw)
            # K20 scaled_masked_sign_vote
            out = kernels.scaled_masked_sign_vote(codes, qs, m, wn)
            err = max_abs_err(out, scaled_masked_sign_vote_plain(codes, qs,
                                                                 m, wn))
            ok = err == 0.0 and (arrived > 0 or not bool(out.any()))
            del out
            kw = timing(
                lambda: kernels.scaled_masked_sign_vote(codes, qs, m, wn),
                lambda: scaled_masked_sign_vote_plain(codes, qs, m, wn),
                10, 2, arrived * P + 8 * N + 4 * P,
                3 * arrived * P) if timed else {}
            if timed:
                kw["predicted_ms"] = VOTE_PREDICTED_MS[(
                    "scaled_masked_sign_vote", qdt)]
            check("scaled_masked_sign_vote", ok, dtype=qdt, shape=[N, P],
                  arrived=arrived, max_abs_diff=err, exact=err == 0.0, **kw)
            note(summary, "scaled_masked_sign_vote", err, main and kw)
        # K15 on the codes (the synchronous compressed sign_sgd)
        out = kernels.sign_vote(codes)
        err = max_abs_err(out, sign_vote_plain(codes))
        del out
        kw = timing(lambda: kernels.sign_vote(codes),
                    lambda: sign_vote_plain(codes), 10, 2,
                    N * P + 4 * P, 2 * N * P,
                    library=lambda: torch.sign(torch.sign(codes.float())
                                               .sum(0)),
                    label="torch.sign(torch.sign(codes.float()).sum(0)), a "
                          "partial yardstick (four calls)")
        check("sign_vote", err == 0.0, dtype=qdt, shape=[N, P],
              max_abs_diff=err, exact=err == 0.0,
              predicted_ms=VOTE_PREDICTED_MS[("sign_vote", qdt)], **kw)
        summary.setdefault("sign_vote_codes", {})[qdt] = kw
        compressed_aggregation(codes, qs)
        dequant_copy_gate(codes, qs, P)
        del codes, qs
        torch.cuda.empty_cache()
    del x, xb
    torch.cuda.empty_cache()
    scaled_hazard_checks()
    return summary


def compressed_aggregation(codes, qs):
    """The compressed exchange's aggregation on the codes, on a line of
    its own: ``spec.aggregate_flat(codes, scale=qs)`` of median and
    trimmed_mean (one K18 a call) and with 6 of 8 arrived (one K19), of
    sign_sgd (one K15 on the codes; one K20) and of sparse_mean (one K21
    a call, sync and masked), each call timed whole (the spec's own
    stages included)."""
    from repro_torch.core.aggregators import make_spec
    m = arrival_mask(6).bool()
    w, _ = discount_weights(m.float())
    agg = {}
    for rule in ("coordinate_median", "trimmed_mean", "sign_sgd",
                 "sparse_mean"):
        spec = make_spec(rule, f=F, n=N)
        agg[rule] = {
            "sync": time_ms(lambda: spec.aggregate_flat(codes, scale=qs), 5),
            "masked": time_ms(lambda: spec.aggregate_flat(
                codes, mask=m, weights=w, scale=qs), 5)}
    emit("compressed_aggregation", dtype=str(codes.dtype).replace(
        "torch.", ""), shape=list(codes.shape), aggregation_ms=agg)


def dequant_copy_gate(codes, qs, P):
    """``aggregate_flat(codes, mask=, weights=, scale=qs)`` of each scaled
    rule: on impl="kernel" the peak device memory may rise by at most 3 *
    P * 4 bytes over the call (a few (P,) fp32 vectors: no dequantized
    (n, P) copy); on impl="gather" (the engine-level dequantization) it
    must rise by at least n * P * 4."""
    from repro_torch.core.aggregators import make_spec
    n = codes.shape[0]
    m = arrival_mask(6).bool()
    w, _ = discount_weights(m.float())
    for rule in ("coordinate_median", "trimmed_mean", "sign_sgd"):
        rise = {}
        for impl in ("kernel", "gather"):
            spec = make_spec(rule, f=F, impl=impl, n=n)
            for mode, kw in (("sync", {}), ("masked", dict(mask=m,
                                                           weights=w))):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = spec.aggregate_flat(codes, scale=qs, **kw)
                torch.cuda.synchronize()
                rise[impl, mode] = torch.cuda.max_memory_allocated() - base
                del out
        ok = (all(rise["kernel", md] <= 3 * P * 4 for md in ("sync",
                                                              "masked"))
              and all(rise["gather", md] >= n * P * 4 for md in ("sync",
                                                                  "masked")))
        emit("dequant_copy_gate", rule=rule, dtype=str(codes.dtype).replace(
            "torch.", ""), ok=ok, kernel_rise_bytes=[rise["kernel", "sync"],
                                                    rise["kernel", "masked"]],
             gather_rise_bytes=[rise["gather", "sync"],
                                rise["gather", "masked"]],
             kernel_limit=3 * P * 4, gather_floor=n * P * 4)
        if not ok:
            fail(f"dequant-copy gate {rule}: peak rises {rise}")


def scaled_hazard_checks():
    """K18, K19, K20 and K15 on codes at a small width, n = 3, 8, 12:
    NaN rows (fp8 NaN codes, int8 0 codes of scale 1), inf rows (scale
    inf: K18 / K19 see NaN, K20 NaN columns where the row votes, K15 0
    votes on its 0 codes), zero rows (scale 1), live and absent: exact
    against the plain versions (trimmed within 3e-6)."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.masked import (scaled_coord_stat_plain,
                                            scaled_masked_coord_stat_plain,
                                            scaled_masked_sign_vote_plain,
                                            sign_vote_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    d = 4099
    for n in (3, 8, 12):
        for hazard in ("nan", "inf", "zero"):
            for qdt in QUANT:
                x = torch.randn((n, d), generator=gen, device=DEVICE)
                if hazard == "nan":
                    x[1, ::3] = math.nan
                elif hazard == "inf":
                    x[0, ::4], x[0, 1::4] = math.inf, -math.inf
                else:
                    x[n - 1] = 0.0
                codes, qs = quantize_rows(x, qdt)
                errs, close = {}, True
                for stat, b in (("median", 0), ("trimmed_mean", 1)):
                    out = kernels.scaled_coord_stat(codes, qs, stat, b)
                    ref = scaled_coord_stat_plain(codes, qs, stat, b)
                    errs["k18_" + stat] = max_abs_err(out, ref)
                    close &= bool(torch.allclose(out, ref, rtol=TOL,
                                                 atol=TOL, equal_nan=True))
                    for live in (n - 1, 1, 0):
                        # the hazard row live (first rows), then absent
                        for m in (arrival_mask(live, n),
                                  arrival_mask(live, n).flip(0)):
                            out = kernels.scaled_masked_coord_stat(
                                codes, qs, m, m, stat, b)
                            ref = scaled_masked_coord_stat_plain(
                                codes, qs, m, m, stat, b)
                            key = "k19_" + stat
                            errs[key] = max(errs.get(key, 0.0),
                                            max_abs_err(out, ref))
                            close &= bool(torch.allclose(
                                out, ref, rtol=TOL, atol=TOL,
                                equal_nan=True))
                errs["k20"] = 0.0
                for live in (n - 1, 1, 0):
                    for m in (arrival_mask(live, n),
                              arrival_mask(live, n).flip(0)):
                        out = kernels.scaled_masked_sign_vote(codes, qs, m, m)
                        errs["k20"] = max(errs["k20"], max_abs_err(
                            out, scaled_masked_sign_vote_plain(codes, qs, m,
                                                               m)))
                        if hazard == "inf" and m[0] > 0.5:
                            close &= bool(torch.isnan(out).all())
                k15 = kernels.sign_vote(codes)
                errs["k15"] = max_abs_err(k15, sign_vote_plain(codes))
                if hazard == "inf":
                    close &= not bool(torch.isnan(k15).all())
                torch.cuda.synchronize()
                ok = close and all(v == 0.0 for k, v in errs.items()
                                   if "trimmed" not in k)
                check("scaled_hazards", ok, hazard=hazard, n=n, dtype=qdt,
                      shape=[n, d], max_abs_diff=errs)


# the scaled sweep: its (d, leading stride, view offset) widths, and the
# scale hazards of its (4099, 4112) stack
SCALED_SWEEP_WIDTHS = ((1, 1, 0), (127, 127, 0), (4099, 4112, 0),
                       (4099, 4112, 1))
SCALED_HAZARDS = ("inf_scale", "nan_scale", "zero_scale", "overflow")
FLT_MAX = 3.4028234663852886e38


def scaled_stack(n, ld, qdt, gen, hazard):
    """(codes (n, ld) int8 / fp8, scale (n,) fp32) on the card: random
    codes (fp8 without NaN codes), every one of the 256 codes in row 0's
    first 256 columns and row n - 1's next 256; past column 512, fp8 NaN
    codes (0x7f, 0xff) in row n - 1 every 7th column, and +0 / -0 codes
    (int8: 0) on most rows every 5th column.  ``hazard``: row 0's scale
    inf (K19: live in the full mask), row n // 2's NaN (absent at n - 2
    arrived), row n - 1's 0 (a negative code gives -0; the one row live at
    1 arrived), or row 0's scale such that its largest codes (127, 448)
    overflow to +-inf while the scale (times 2^8 for fp8) stays finite;
    K15 / K20's sweep adds ``tiny_scale`` (row 0's scale 2^-142; fp8: its
    codes +-2^-9 and 0, so every product of the row rounds to +-0) and
    ``neg_scale`` (the even rows' scales negated)."""
    fp8 = qdt == "float8_e4m3fn"
    raw = torch.randint(0, 256, (n, ld), generator=gen, device=DEVICE,
                        dtype=torch.int32).to(torch.uint8)
    if fp8:
        raw[(raw & 0x7f) == 0x7f] -= 1
    every = torch.arange(256, device=DEVICE, dtype=torch.int32)
    raw[0, :min(ld, 256)] = every[:ld].to(torch.uint8)
    if ld > 256:
        raw[n - 1, 256:512] = every.flip(0)[:ld - 256].to(torch.uint8)
    if ld > 512:
        if fp8:
            raw[n - 1, 515::7], raw[n - 1, 517::7] = 0x7f, 0xff
        z = raw[:n // 2 + 1, 514::5]
        z[:] = torch.where(torch.rand(z.shape, generator=gen, device=DEVICE)
                           < 0.5, 0x80 if fp8 else 0, 0).to(torch.uint8)
    scale = torch.rand(n, generator=gen, device=DEVICE) * 2.0 + 0.05
    if hazard == "inf_scale":
        scale[0] = math.inf
    elif hazard == "nan_scale":
        scale[n // 2] = math.nan
    elif hazard == "zero_scale":
        scale[n - 1] = 0.0
    elif hazard == "overflow":
        scale[0] = FLT_MAX / (340.0 if fp8 else 100.0)
        raw[0, ::3] = 0x7e if fp8 else 0x7f
        raw[0, 1::3] = 0xfe if fp8 else 0x81
    elif hazard == "tiny_scale":
        scale[0] = 2.0 ** -142
        if fp8:
            raw[0] = torch.where(raw[0] >= 0x80, 0x81, 0x01).to(torch.uint8)
            raw[0, 2::5] = 0
    elif hazard == "neg_scale":
        scale[::2] = -scale[::2]
    return raw.view(getattr(torch, qdt)), scale


def scaled_masks(n):
    """Masks of n, n - 2, 1 (row n - 1) and 0 arrived (fp32 on the card);
    the n - 2 mask leaves out rows n // 2 and n // 2 + 1."""
    out = []
    for arrived in sorted({n, max(n - 2, 0), 1, 0}, reverse=True):
        m = torch.zeros(n, device=DEVICE)
        if arrived == n:
            m[:] = 1.0
        elif arrived == 1:
            m[n - 1] = 1.0
        elif arrived:
            m[:] = 1.0
            m[[n // 2, (n // 2 + 1) % n]] = 0.0
        out.append(m)
    return out


def scaled_agrees(out, ref, stat):
    """(ok, sign-of-zero differences, max |error|): NaN where the plain
    version has NaN; medians equal elsewhere (-0 == +0: the differences
    are counted), trimmed means within 3e-6."""
    on, rn = torch.isnan(out), torch.isnan(ref)
    if not torch.equal(on, rn):
        return False, 0, math.inf
    o, r = out[~on], ref[~rn]
    err = max_abs_err(o, r)
    if stat != "median":
        return bool(torch.allclose(o, r, rtol=TOL, atol=TOL)), 0, err
    eq = o == r
    signs = int((eq & (torch.signbit(o) != torch.signbit(r))).sum())
    return bool(eq.all()), signs, err


def scaled_sweep_checks():
    """K18 and K19 at every n of GRAM_SWEEP_N, int8 and fp8, median and
    trimmed (b = min(2, (n - 1) // 2)), K19 at the scaled_masks, at the
    SCALED_SWEEP_WIDTHS and, on the (4099, 4112) stack, each of
    SCALED_HAZARDS (scaled_stack).  Each case agrees with its plain
    version (scaled_agrees) and is bitwise equal to a repeat.  One line
    per n, with its sign-of-zero differences in medians and the largest
    error of each stat."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import (scaled_coord_stat_plain,
                                            scaled_masked_coord_stat_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(20)
    for n in GRAM_SWEEP_N:
        cases, signs = 0, 0
        errs = {"median": 0.0, "trimmed_mean": 0.0}
        b = min(2, (n - 1) // 2)
        for qdt in QUANT:
            for d, ld, off in SCALED_SWEEP_WIDTHS:
                hazards = (None,) + (SCALED_HAZARDS if (d, ld, off) == (
                    4099, 4112, 0) else ())
                for hazard in hazards:
                    codes, qs = scaled_stack(n, ld + off, qdt, gen, hazard)
                    g = codes[:, off:off + d]
                    for stat, bb in (("median", 0), ("trimmed_mean", b)):
                        runs = [(None, lambda: kernels.scaled_coord_stat(
                            g, qs, stat, bb),
                            scaled_coord_stat_plain(g, qs, stat, bb))]
                        for m in scaled_masks(n):
                            runs.append((int(m.sum()),
                                         lambda m=m: kernels
                                         .scaled_masked_coord_stat(
                                             g, qs, m, m, stat, bb),
                                         scaled_masked_coord_stat_plain(
                                             g, qs, m, m, stat, bb)))
                        for arrived, fn, ref in runs:
                            out = fn()
                            ok, sz, err = scaled_agrees(out, ref, stat)
                            ok = ok and same_bits(out, fn())
                            if arrived == 0:
                                ok = ok and not bool(out.any())
                            cases += 1
                            signs += sz
                            errs[stat] = max(errs[stat], err)
                            if not ok:
                                check("scaled_sweep", False, n=n, dtype=qdt,
                                      d=d, ld=ld, offset=off, hazard=hazard,
                                      stat=stat, b=bb, arrived=arrived,
                                      sign_of_zero=sz, max_abs_diff=err)
        torch.cuda.synchronize()
        check("scaled_sweep", True, n=n, cases=cases,
              sign_of_zero_differences=signs, max_abs_diff=errs,
              repeat_bitwise=True)


def scaled_capacity_timings(num_params):
    """K18 (median and trimmed, b = 2) and K19 (median, n - 2 arrived) at
    full width on random int8 codes at n = 16, 33 and 64, the 16-, 32-
    and 64-row capacities (no training path runs them): kernel ms against
    the bytes' bound, checked against the plain version on the first
    4099 columns (scaled_agrees)."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import (scaled_coord_stat_plain,
                                            scaled_masked_coord_stat_plain)

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    for n in (16, 33, 64):
        codes = torch.randint(-127, 128, (n, P), generator=gen,
                              device=DEVICE, dtype=torch.int8)
        qs = torch.rand(n, generator=gen, device=DEVICE) + 0.5
        m = scaled_masks(n)[1]
        head = codes[:, :4099]
        for name, stat, b, mask in (
                ("scaled_coord_stat", "median", 0, None),
                ("scaled_coord_stat", "trimmed_mean", 2, None),
                ("scaled_masked_coord_stat", "median", 0, m)):
            if mask is None:
                def fn(x):
                    return kernels.scaled_coord_stat(x, qs, stat, b)
                ref = scaled_coord_stat_plain(head, qs, stat, b)
                rows = n
            else:
                def fn(x):
                    return kernels.scaled_masked_coord_stat(x, qs, mask,
                                                            mask, stat, b)
                ref = scaled_masked_coord_stat_plain(head, qs, mask, mask,
                                                     stat, b)
                rows = int(mask.sum())
            ok, _, err = scaled_agrees(fn(head), ref, stat)
            emit("kernels", capacity_timing=name, stat=stat, ok=ok, n=n,
                 shape=[n, P], max_abs_diff=err,
                 kernel_ms=time_ms(lambda: fn(codes), 5),
                 bound_ms=bound(rows * P + 4 * P + 8 * n, 0)[0])
            if not ok:
                fail(f"{name} {stat} at n = {n} disagrees with its plain "
                     "version")
        del codes
        torch.cuda.empty_cache()


# K1's sweep: its (d, leading stride, offset in elements) cases, and the
# column ranges of the hazards in the rows of 4112 (order_stack)
ORDER_SWEEP_WIDTHS = ((1, 1, 0), (127, 127, 0), (4099, 4112, 0),
                      (4099, 4112, 1))


def order_stack(n, ld, dtype, gen):
    """(n, ld) bf16 / fp32 on the card: normal values and, for ld > 2400,
    hazard columns: NaN in row i of column 300 + i (the first and the last
    row among them) and in row (j // 7) % n of every 7th column of 400-700;
    +inf / -inf in one row of each column of 800-899, and +inf in half the
    rows and -inf in the others of every 3rd; columns of +inf only (900-909)
    and -inf only (910-919); +-0 in every row of the even columns of
    1000-1999 and in half the rows of the odd ones; columns of one value in
    every row (2000-2099); +-3e38 (2100-2199: the trimmed sums overflow);
    subnormals (2200-2299)."""
    g = torch.randn((n, ld), generator=gen, device=DEVICE)
    if ld > 2400:
        rows = torch.arange(n, device=DEVICE)
        g[rows, 300 + rows] = math.nan
        j = torch.arange(400, 701, 7, device=DEVICE)
        g[(j // 7) % n, j] = math.nan
        j = torch.arange(800, 900, device=DEVICE)
        g[j % n, j] = math.inf
        g[(j + 1) % n, j] = -math.inf
        half = torch.rand((n, 34), generator=gen, device=DEVICE) < 0.5
        g[:, 800:900:3] = torch.where(half, math.inf, -math.inf)
        g[:, 900:910], g[:, 910:920] = math.inf, -math.inf
        z = torch.where(torch.rand((n, 1000), generator=gen, device=DEVICE)
                        < 0.4, -0.0, 0.0)
        g[:, 1000:2000:2] = z[:, ::2]
        part = torch.rand((n, 500), generator=gen, device=DEVICE) < 0.5
        g[:, 1001:2000:2] = torch.where(part, z[:, 1::2], g[:, 1001:2000:2])
        g[:, 2000:2100] = g[0, 2000:2100].clone()
        g[:, 2100:2200] = torch.sign(g[:, 2100:2200]) * 3e38
        g[:, 2200:2300] *= 1e-40
    return g.to(dtype)


def order_sweep_checks():
    """K1 at every n of GRAM_SWEEP_N, bf16 and fp32, median and trimmed (b
    = min(2, (n - 1) // 2)), at the ORDER_SWEEP_WIDTHS with the hazard
    columns of order_stack: medians equal to the plain version NaN to NaN
    (-0 == +0, the differences counted), trimmed means within 3e-6, each
    case bitwise equal to a repeat.  One line per n; returns the largest
    median error."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain

    gen = torch.Generator(device=DEVICE).manual_seed(21)
    worst = 0.0
    for n in GRAM_SWEEP_N:
        cases, signs = 0, 0
        errs = {"median": 0.0, "trimmed_mean": 0.0}
        b = min(2, (n - 1) // 2)
        for dtype in (torch.bfloat16, torch.float32):
            for d, ld, off in ORDER_SWEEP_WIDTHS:
                g = order_stack(n, ld + off, dtype, gen)[:, off:off + d]
                for stat, bb in (("median", 0), ("trimmed_mean", b)):
                    out = kernels.coord_stat(g, stat, bb)
                    ok, sz, err = scaled_agrees(
                        out, coord_stat_plain(g, stat, bb), stat)
                    ok = ok and same_bits(out, kernels.coord_stat(g, stat,
                                                                  bb))
                    cases += 1
                    signs += sz
                    errs[stat] = max(errs[stat], err)
                    if not ok:
                        check("coord_stat_sweep", False, n=n,
                              dtype=str(dtype).replace("torch.", ""), d=d,
                              ld=ld, offset=off, stat=stat, b=bb,
                              sign_of_zero=sz, max_abs_diff=err)
        torch.cuda.synchronize()
        worst = max(worst, errs["median"])
        check("coord_stat_sweep", True, n=n, cases=cases,
              sign_of_zero_differences=signs, max_abs_diff=errs,
              repeat_bitwise=True)
    return worst


def order_capacity_timings(num_params):
    """K1 (median and trimmed, b = 2) at full width on a bf16 stack at n =
    16, 33 and 64, the 16-, 32- and 64-row capacities of the order-
    statistic template (no training path runs them): kernel ms against the
    bytes' bound, checked against the plain version on the first 4099
    columns (scaled_agrees).  The network kernel K1 ran before is timed
    beside it by ``python -m repro_torch.kernels.compare``."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(22)
    for n in (16, 33, 64):
        x = (torch.randn((n, P), generator=gen, device=DEVICE)
             * 1e-3).bfloat16()
        head = x[:, :4099]
        for stat, b in (("median", 0), ("trimmed_mean", 2)):
            ok, _, err = scaled_agrees(kernels.coord_stat(head, stat, b),
                                       coord_stat_plain(head, stat, b), stat)
            emit("kernels", capacity_timing="coord_stat", stat=stat, ok=ok,
                 n=n, dtype="bfloat16", shape=[n, P], max_abs_diff=err,
                 kernel_ms=time_ms(lambda: kernels.coord_stat(x, stat, b),
                                   5),
                 bound_ms=bound(2 * n * P + 4 * P, 0)[0])
            if not ok:
                fail(f"coord_stat {stat} at n = {n} disagrees with its "
                     "plain version")
        del x, head
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 2f


def real_arena(cfg):
    """The (n, P) bf16 arena that one full-width synchronous sparse_mean
    step (seed 7) hands to its aggregation, after the attack: a real
    batch's gradients, so the embedding rows the batch does not touch are
    0 (not sent)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    gen = make_generator(7, DEVICE)
    params = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    store = {}
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=recorded(
        make_spec("sparse_mean", f=F, n=N), store), attack="sign_flip",
        remat=True)
    opt = adamw(constant(1e-4))
    step = make_train_step(cfg, bz, opt, device=DEVICE)
    step(params, opt.init(params), None, ds.batch(ds.draw_starts(gen)))
    arena = store["kernel"][0]
    del params, store, step
    torch.cuda.empty_cache()
    sent = arena != 0
    senders = sent.sum(0)
    emit("sparse_arena", shape=list(arena.shape),
         dtype=str(arena.dtype).replace("torch.", ""),
         nobody_sent_share=float((senders == 0).float().mean()),
         one_sender_share=float((senders == 1).float().mean()),
         sent_share_per_row=sent.float().mean(1).tolist())
    del sent, senders
    return arena


SPARSE_YARDSTICK = ("torch.sum(g, 0, dtype=float32) / "
                    "torch.count_nonzero(g, 0): a partial yardstick (two "
                    "calls, every row live with unit weight, no zero guard)")


def sparse_kernel_checks(x):
    """K17 and K21 on the real arena ``x`` (n = 8, bf16): K17 on it with
    mask and weights all ones (the synchronous step), on its fp32 copy
    with 6, 1 and 0 of 8 live and raw staleness weights (the async
    buffer); K21 on its int8 and fp8 codes, all live and 6, 1, 0 of 8.
    Exact against the plain versions.  The summary takes the bf16 sync
    case (K17) and the int8 sync case (K21)."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.wsum import (
        scaled_sparse_masked_weighted_mean_plain,
        sparse_masked_weighted_mean_plain)

    P = x.shape[1]
    summary = {K17: {"max_abs_err": 0.0}, K21: {"max_abs_err": 0.0}}
    ones = torch.ones(N, device=DEVICE)

    def case(name, fn, plain, g, m, w, bytes_per, main, label, **extra):
        live = int((m > 0.5).sum())
        out = fn()
        err = max_abs_err(out, plain())
        ok = err == 0.0 and (live > 0 or not bool(out.any()))
        del out
        kw = {}
        if live in (N, 6):
            kw = timing(fn, plain, 10, 2, live * P * bytes_per + 4 * P
                        + 8 * N, 5 * live * P,
                        library=((lambda: torch.sum(g, 0, dtype=torch.float32)
                                  / torch.count_nonzero(g, 0))
                                 if name == K17 else None),
                        label=SPARSE_YARDSTICK if name == K17 else None)
            if name == K21:
                kw["predicted_ms"] = K21_PREDICTED_MS[(extra["dtype"], live)]
        check(name, ok, case=label, shape=[N, P], live=live,
              max_abs_diff=err, exact=err == 0.0, **extra, **kw)
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                           err)
        if main:
            summary[name].update(ms=kw["kernel_ms"], plain_ms=kw["plain_ms"],
                                 library_ms=None, bound_ms=kw["bound_ms"],
                                 bound_by=kw["bound_by"])

    # K17 on the synchronous step's bf16 arena
    case(K17, lambda: kernels.sparse_masked_weighted_mean(x, ones, ones),
         lambda: sparse_masked_weighted_mean_plain(x, ones, ones), x, ones,
         ones, 2, True, "sync bf16", dtype="bfloat16")
    xf = x.float()
    for live in (6, 1, 0):
        m = arrival_mask(live)
        w, _ = discount_weights(m)
        case(K17, lambda: kernels.sparse_masked_weighted_mean(xf, m, w),
             lambda: sparse_masked_weighted_mean_plain(xf, m, w), xf, m, w,
             4, False, "masked fp32, raw staleness weights",
             dtype="float32")
    for qdt in QUANT:
        codes, qs = quantize_rows(xf, qdt)
        for live in (N, 6, 1, 0):
            m = arrival_mask(live)
            w = ones if live == N else discount_weights(m)[0]
            case(K21, lambda: kernels.scaled_sparse_masked_weighted_mean(
                codes, qs, m, w),
                lambda: scaled_sparse_masked_weighted_mean_plain(
                    codes, qs, m, w), codes, m, w, 1,
                qdt == "int8" and live == N, "sync" if live == N else
                "masked, raw staleness weights", dtype=qdt,
                nobody_sent_share=float(
                    (~(codes.view(torch.uint8) & 0x7F).bool().any(0))
                    .float().mean()) if live == N else None)
        del codes, qs
        torch.cuda.empty_cache()
    del xf
    torch.cuda.empty_cache()
    sparse_hazard_checks()
    return summary


def sparse_hazard_checks():
    """K17 and K21 at a small width, n = 3, 8, 11, every live count: an inf
    or NaN in a live row of weight 0 (unsent), a live NaN (sent: its
    column NaN), -0.0 (not sent), a dead row of NaN, an all-zero column
    (an exact 0); on codes NaN rows, an inf row (scale inf: NaN columns
    wherever it is live) and a zero row.  Exact against the plain
    versions."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.wsum import (
        scaled_sparse_masked_weighted_mean_plain,
        sparse_masked_weighted_mean_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(14)
    d = 4099
    for n in (3, 8, 11):
        base = torch.randn((n, d), generator=gen, device=DEVICE)
        base = torch.where(torch.rand((n, d), generator=gen, device=DEVICE)
                           < 0.5, torch.zeros((), device=DEVICE), base)
        base[:, :7] = 0.0
        masks = [arrival_mask(k, n) for k in (n, n - 1, 1, 0)]
        for hazard in ("unsent_nonfinite", "live_nan", "neg_zero",
                       "dead_nan"):
            for dtype in (torch.float32, torch.bfloat16):
                errs, props = [], True
                for m in masks:
                    w, _ = discount_weights(m)
                    g = base.clone()
                    live = int((m > 0.5).sum())
                    if hazard == "unsent_nonfinite" and live:
                        w[0] = 0.0
                        g[0, 8::3], g[0, 9::3] = math.inf, math.nan
                    elif hazard == "live_nan" and live:
                        g[live - 1, 8::5] = math.nan
                    elif hazard == "neg_zero":
                        g[:, 9::4] = -0.0
                    elif hazard == "dead_nan" and live < n:
                        g[n - 1] = math.nan
                    g = g.to(dtype)
                    out = kernels.sparse_masked_weighted_mean(g, m, w)
                    errs.append(max_abs_err(
                        out, sparse_masked_weighted_mean_plain(g, m, w)))
                    props &= not bool(out[:7].any())
                    if hazard == "live_nan" and live:
                        props &= bool(torch.isnan(out[8::5]).all())
                    elif hazard != "live_nan":
                        props &= bool(torch.isfinite(out).all())
                torch.cuda.synchronize()
                check("sparse_hazards", props and max(errs) == 0.0,
                      of=K17, hazard=hazard, n=n,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=max(errs))
        for hazard in ("nan", "inf", "zero_row"):
            g = base.clone()
            if hazard == "nan":
                g[min(1, n - 1), ::3] = math.nan
            elif hazard == "inf":
                g[0, 8::4], g[0, 9::4] = math.inf, -math.inf
            else:
                g[n - 1] = 0.0
            for qdt in QUANT:
                codes, qs = quantize_rows(g, qdt)
                errs, props = [], True
                for m in masks + [arrival_mask(n - 1, n).flip(0)]:
                    out = kernels.scaled_sparse_masked_weighted_mean(
                        codes, qs, m, m)
                    errs.append(max_abs_err(
                        out, scaled_sparse_masked_weighted_mean_plain(
                            codes, qs, m, m)))
                    if hazard == "inf" and float(m[0]) > 0.5:
                        props &= bool(torch.isnan(out).all())
                    elif hazard != "nan":
                        props &= bool(torch.isfinite(out).all())
                torch.cuda.synchronize()
                check("sparse_hazards", props and max(errs) == 0.0,
                      of=K21, hazard=hazard, n=n, dtype=qdt,
                      shape=[n, d], max_abs_diff=max(errs))


# ---------------------------------------------------------------------------
# phase 2g


def coord_stat_arena_checks(x):
    """K1 (median and trimmed, b = 2) at full width on the real sign_flip
    arena ``x`` of real_arena (bf16, n = 8): the sign_flip rows negate the
    zero gradients of the embedding rows a batch does not touch, so tied
    +-0 fill whole columns.  Medians equal to the plain version NaN to NaN
    with the sign-of-zero differences counted, trimmed means within 3e-6;
    kernel ms against the bound.  Returns the largest median error."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain

    N_, P = x.shape
    zeros = x == 0
    neg_zero_share = float((zeros & torch.signbit(x)).float().mean())
    zero_share = float(zeros.float().mean())
    del zeros
    worst = 0.0
    for stat, b in (("median", 0), ("trimmed_mean", 2)):
        out = kernels.coord_stat(x, stat, b)
        ok, signs, err = scaled_agrees(out, coord_stat_plain(x, stat, b),
                                       stat)
        zero_out = float((out == 0).float().mean())
        del out
        if stat == "median":
            worst = err
        check("coord_stat", ok, case="real sign_flip arena", stat=stat,
              dtype="bfloat16", shape=[N_, P], max_abs_diff=err,
              sign_of_zero_differences=signs, zero_share=zero_share,
              neg_zero_share=neg_zero_share, zero_output_share=zero_out,
              kernel_ms=time_ms(lambda: kernels.coord_stat(x, stat, b), 10),
              bound_ms=bound(2 * N_ * P + 4 * P, 0)[0],
              predicted_ms=K1_PREDICTED_MS["bfloat16"])
    return worst


# K21's sweep: the weights of each mask (all ones, the raw staleness
# discounts, and those with the first live row's weight 0)
SPARSE_SWEEP_WEIGHTS = ("ones", "raw", "zero_live")


def sparse_sweep_weights(m, kind):
    n = m.shape[0]
    if kind == "ones":
        return torch.ones(n, device=DEVICE)
    w, _ = discount_weights(m)
    if kind == "zero_live":
        live = torch.nonzero(m > 0.5).flatten()
        w[live[:1]] = 0.0
    return w


def sparse_sweep_checks():
    """K21 at every n of GRAM_SWEEP_N, int8 and fp8, at the SCALED_SWEEP_
    WIDTHS (a view offset by one byte among them: the byte loads) and, on
    the (4099, 4112) stack, each of SCALED_HAZARDS (scaled_stack: every
    code, NaN and -0 codes, inf / NaN / zero / overflowing scales), the
    scaled_masks (n, n - 2, 1 and 0 live) and SPARSE_SWEEP_WEIGHTS: each
    case bitwise equal to its plain version (NaN to NaN) and to a repeat.
    One line per n."""
    from repro_torch import kernels
    from repro_torch.kernels.wsum import (
        scaled_sparse_masked_weighted_mean_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(23)
    for n in GRAM_SWEEP_N:
        cases = 0
        for qdt in QUANT:
            for d, ld, off in SCALED_SWEEP_WIDTHS:
                hazards = (None,) + (SCALED_HAZARDS if (d, ld, off) == (
                    4099, 4112, 0) else ())
                for hazard in hazards:
                    codes, qs = scaled_stack(n, ld + off, qdt, gen, hazard)
                    g = codes[:, off:off + d]
                    for m in scaled_masks(n):
                        for kind in SPARSE_SWEEP_WEIGHTS:
                            w = sparse_sweep_weights(m, kind)
                            out = kernels.scaled_sparse_masked_weighted_mean(
                                g, qs, m, w)
                            ref = scaled_sparse_masked_weighted_mean_plain(
                                g, qs, m, w)
                            rep = kernels.scaled_sparse_masked_weighted_mean(
                                g, qs, m, w)
                            ok = same_bits_nan(out, ref) and same_bits(out,
                                                                       rep)
                            cases += 1
                            if not ok:
                                check("sparse_sweep", False, n=n, dtype=qdt,
                                      d=d, ld=ld, offset=off, hazard=hazard,
                                      live=int(m.sum()), weights=kind,
                                      max_abs_diff=max_abs_err(out, ref))
        torch.cuda.synchronize()
        check("sparse_sweep", True, n=n, cases=cases, exact=True,
              repeat_bitwise=True)


# K15 / K20's sweep: the scale hazards of the codes' (4099, 4112) stack
VOTE_HAZARDS = SCALED_HAZARDS + ("tiny_scale", "neg_scale")


def vote_sweep_checks():
    """K15 and K20 at every n of GRAM_SWEEP_N: on int8 and fp8 codes at the
    SCALED_SWEEP_WIDTHS (a view offset by one byte among them: the element
    loads) and, on the (4099, 4112) stack, each of VOTE_HAZARDS
    (scaled_stack: every code, NaN and +-0 codes; inf / NaN / zero /
    overflowing / tiny / negative scales), K20 at the scaled_masks (n, n -
    2, 1 and 0 arrived); K15 also on bf16 and fp32 at the
    ORDER_SWEEP_WIDTHS with the hazard columns of order_stack (NaN, +-inf,
    +-0, subnormals).  Each case bitwise equal to its plain version (NaN
    to NaN) and to a repeat.  One line per n."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import (scaled_masked_sign_vote_plain,
                                            sign_vote_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(24)
    for n in GRAM_SWEEP_N:
        cases = 0
        runs = []
        for qdt in QUANT:
            for d, ld, off in SCALED_SWEEP_WIDTHS:
                hazards = (None,) + (VOTE_HAZARDS if (d, ld, off) == (
                    4099, 4112, 0) else ())
                for hazard in hazards:
                    codes, qs = scaled_stack(n, ld + off, qdt, gen, hazard)
                    g = codes[:, off:off + d]
                    case = dict(dtype=qdt, d=d, ld=ld, offset=off,
                                hazard=hazard)
                    runs.append(({**case, "kernel": "sign_vote"},
                                 lambda g=g: kernels.sign_vote(g),
                                 lambda g=g: sign_vote_plain(g)))
                    for m in scaled_masks(n):
                        runs.append((
                            {**case, "kernel": "scaled_masked_sign_vote",
                             "arrived": int(m.sum())},
                            lambda g=g, qs=qs, m=m:
                                kernels.scaled_masked_sign_vote(g, qs, m, m),
                            lambda g=g, qs=qs, m=m:
                                scaled_masked_sign_vote_plain(g, qs, m, m)))
        for dtype in (torch.bfloat16, torch.float32):
            for d, ld, off in ORDER_SWEEP_WIDTHS:
                g = order_stack(n, ld + off, dtype, gen)[:, off:off + d]
                runs.append((dict(kernel="sign_vote", dtype=str(dtype)[6:],
                                  d=d, ld=ld, offset=off),
                             lambda g=g: kernels.sign_vote(g),
                             lambda g=g: sign_vote_plain(g)))
        for case, fn, plain in runs:
            out, ref = fn(), plain()
            ok = same_bits_nan(out, ref) and same_bits(out, fn())
            if case.get("arrived") == 0:
                ok = ok and not bool(out.any())
            cases += 1
            if not ok:
                check("vote_sweep", False, n=n, **case,
                      max_abs_diff=max_abs_err(out, ref))
        torch.cuda.synchronize()
        check("vote_sweep", True, n=n, cases=cases, exact=True,
              repeat_bitwise=True)


def vote_arena_checks(x):
    """K15 on the real sign_flip arena ``x`` of real_arena (bf16, n = 8:
    whole columns of +-0 where the batch touches no embedding row), and
    K15 and K20 (8 and 6 of 8 arrived) on its int8 and fp8 codes: bitwise
    equal to the plain versions (NaN to NaN), timed against the bound and
    the partial yardstick, with the predicted ms."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.masked import (scaled_masked_sign_vote_plain,
                                            sign_vote_plain)

    P = x.shape[1]
    zeros = x == 0
    emit("vote_arena", shape=[N, P], zero_share=float(zeros.float().mean()),
         neg_zero_share=float((zeros & torch.signbit(x)).float().mean()))
    del zeros

    def case(name, fn, plain, bytes_moved, library, label, **kw):
        out, ref = fn(), plain()
        ok = same_bits_nan(out, ref) and same_bits(out, fn())
        err = max_abs_err(out, ref)
        zero_out = float((out == 0).float().mean())
        del out, ref
        check(name, ok, case="real sign_flip arena", shape=[N, P],
              max_abs_diff=err, exact=ok, zero_output_share=zero_out,
              **timing(fn, plain, 10, 2, bytes_moved, 0, library=library,
                       label=label), **kw)

    case("sign_vote", lambda: kernels.sign_vote(x),
         lambda: sign_vote_plain(x), 2 * N * P + 4 * P,
         lambda: torch.sign(torch.sign(x).sum(0)),
         "torch.sign(torch.sign(g).sum(0)), a partial yardstick (three "
         "calls)", dtype="bfloat16",
         predicted_ms=VOTE_PREDICTED_MS[("sign_vote", "bfloat16")])
    xf = x.float()
    for qdt in QUANT:
        codes, qs = quantize_rows(xf, qdt)
        case("sign_vote", lambda: kernels.sign_vote(codes),
             lambda: sign_vote_plain(codes), N * P + 4 * P,
             lambda: torch.sign(torch.sign(codes.float()).sum(0)),
             "torch.sign(torch.sign(codes.float()).sum(0)), a partial "
             "yardstick (four calls)", dtype=qdt,
             predicted_ms=VOTE_PREDICTED_MS[("sign_vote", qdt)])
        for live in (N, 6):
            m = arrival_mask(live)
            case("scaled_masked_sign_vote",
                 lambda: kernels.scaled_masked_sign_vote(codes, qs, m, m),
                 lambda: scaled_masked_sign_vote_plain(codes, qs, m, m),
                 live * P + 8 * N + 4 * P,
                 lambda: torch.sign((torch.sign(codes.float()
                                                * qs[:, None])
                                     * m[:, None]).sum(0)),
                 "torch.sign((torch.sign(codes.float() * scale) * "
                 "mask).sum(0)), a partial yardstick (five calls)",
                 dtype=qdt, arrived=live,
                 predicted_ms=VOTE_PREDICTED_MS[(
                     "scaled_masked_sign_vote", qdt)] if live == 6 else None)
        del codes, qs
        torch.cuda.empty_cache()
    del xf
    torch.cuda.empty_cache()


def sort_checks(x):
    """K23 on the real arena ``x`` (bf16, and its fp32 copy) against its
    plain version, exact; the hazards at a small width; then the ``ops``
    legacy paths at full width, their launches counted from 0 (the drive
    of this entry point: K23 twice, K2 once), against the gather laws.
    Returns (summary, launch counts of the drive)."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import trim_count
    from repro_torch.core.filters import dense
    from repro_torch.kernels.coord_stats import coord_sort_plain

    P = x.shape[1]
    summary = {"coord_sort": {"max_abs_err": 0.0}}
    for g in (x, x.float()):
        dname = str(g.dtype).replace("torch.", "")
        out = kernels.coord_sort(g)
        err = max_abs_err(out, coord_sort_plain(g))
        del out
        torch.cuda.empty_cache()
        lib, label = ((lambda: torch.sort(g, dim=0), "torch.sort(g, dim=0)")
                      if g.dtype == torch.float32 else
                      (lambda: torch.sort(g.float(), dim=0),
                       "torch.sort(g.float(), dim=0)"))
        kw = timing(lambda: kernels.coord_sort(g),
                    lambda: coord_sort_plain(g), 5, 2,
                    N * P * g.element_size() + N * P * 4,
                    N * (N - 1) // 2 * 2 * P, library=lib, label=label)
        check("coord_sort", err == 0.0, dtype=dname, shape=[N, P],
              max_abs_diff=err, exact=err == 0.0, **kw)
        note(summary, "coord_sort", err, g is x and kw)
        torch.cuda.empty_cache()
    sort_hazard_checks()
    b = trim_count(N, F, None)
    kernels.reset_launch_counts()
    med = kernels.kernel_coordinate_median(x)
    tm = kernels.kernel_trimmed_mean(x, b)
    d2 = kernels.kernel_pairwise_sq_dists(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: {"coord_sort": 2, "gram": 1}.get(k, 0) for k in counts}
    xf = x.float()
    err_med = max_abs_err(med, dense.coordinate_median(xf))
    tm_ref = dense.trimmed_mean(xf, F)
    tm_ok = bool(torch.allclose(tm, tm_ref, rtol=TOL, atol=TOL))
    d2_ref = dense.pairwise_sq_dists(xf)
    sq = torch.sum(torch.square(xf), dim=1)
    scale = sq[:, None] + sq[None, :]
    d2_ok = bool(((d2 - d2_ref).abs() <= TOL * scale).all())
    ok = counts == want and err_med == 0.0 and tm_ok and d2_ok
    emit("ops_sort_paths", ok=ok, shape=[N, P], launches=counts,
         median_max_abs_diff=err_med,
         trimmed_max_abs_diff=max_abs_err(tm, tm_ref), trimmed_b=b,
         sq_dists_max_abs_diff=max_abs_err(d2, d2_ref),
         ms={"kernel_coordinate_median": time_ms(
             lambda: kernels.kernel_coordinate_median(x), 3),
             "kernel_trimmed_mean": time_ms(
                 lambda: kernels.kernel_trimmed_mean(x, b), 3),
             "kernel_pairwise_sq_dists": time_ms(
                 lambda: kernels.kernel_pairwise_sq_dists(x), 3)})
    if not ok:
        fail(f"ops sort paths: launches {counts} (expected {want}), median "
             f"{err_med}, trimmed {tm_ok}, distances {d2_ok}")
    del xf, med, tm, d2, tm_ref
    torch.cuda.empty_cache()
    return summary, counts


def sort_hazard_checks():
    """K23 at a small width, n = 3, 8, 11, fp32 and bf16: NaN rows and
    spots, +-inf rows, ties; exact against the plain version."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_sort_plain

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    d = 4099
    for n in (3, 8, 11):
        for hazard in ("nan_row", "spots", "inf_rows", "ties"):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.randn((n, d), generator=gen, device=DEVICE)
                if hazard == "nan_row":
                    g[n // 2] = math.nan
                elif hazard == "spots":
                    g[1, ::7], g[0, 3::11] = math.nan, math.inf
                    g[n - 1, 5::13] = -math.inf
                elif hazard == "inf_rows":
                    g[0], g[n - 1] = math.inf, -math.inf
                else:
                    g[1] = g[0]
                    g[:, ::4] = torch.round(g[:, ::4])
                g = g.to(dtype)
                err = max_abs_err(kernels.coord_sort(g), coord_sort_plain(g))
                torch.cuda.synchronize()
                check("sort_hazards", err == 0.0, hazard=hazard, n=n,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=err)


# ---------------------------------------------------------------------------
# phase 2h

K22 = "clipped_weighted_sum"
K22_LIBRARY = "torch.addmv(v, g.t(), lam, beta=1 - sum lam)"


def cclip_kernel_checks(num_params):
    """K22 clipped_weighted_sum against its plain version at n = 8, P =
    124,668,672: fp32 rows with 8 and 6 of 8 lam > 0 (the async buffer;
    the 2 dead rows never read) and bf16 rows with 8; exact.  Times of
    the kernel, the plain version and ``torch.addmv`` (fp32: the same
    function in one call; bf16: a partial yardstick, addmv taking one
    dtype), and the bound.  The summary takes fp32 with 8 live rows."""
    from repro_torch import kernels
    from repro_torch.kernels.wsum import clipped_weighted_sum_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    summary = {K22: {"max_abs_err": 0.0}}
    v = torch.randn(P, generator=gen, device=DEVICE) * 1e-3
    for dtype, live in ((torch.float32, N), (torch.float32, 6),
                        (torch.bfloat16, N)):
        x = (torch.randn((N, P), generator=gen, device=DEVICE)
             * 1e-3).to(dtype)
        lam = torch.rand(N, generator=gen, device=DEVICE) / N
        lam[live:] = 0.0
        err = max_abs_err(kernels.clipped_weighted_sum(lam, x, v),
                          clipped_weighted_sum_plain(lam, x, v))
        keep = float(1.0 - lam.sum())
        if dtype == torch.float32:
            label = K22_LIBRARY
            library = (lambda: torch.addmv(v, x.t(), lam, beta=keep))
        else:
            vb, lb = v.to(dtype), lam.to(dtype)
            label = (K22_LIBRARY + " in bf16: a partial yardstick (addmv "
                     "takes one dtype, so v, lam and the sum are bf16)")
            library = (lambda: torch.addmv(vb, x.t(), lb, beta=keep))
        kw = timing(lambda: kernels.clipped_weighted_sum(lam, x, v),
                    lambda: clipped_weighted_sum_plain(lam, x, v), 10, 2,
                    live * P * x.element_size() + 8 * P + 4 * N,
                    2 * live * P + 2 * P, library=library, label=label)
        check(K22, err == 0.0, dtype=str(dtype).replace("torch.", ""),
              shape=[N, P], live=live, max_abs_diff=err, exact=err == 0.0,
              **kw)
        note(summary, K22, err,
             kw if dtype == torch.float32 and live == N else None)
        del x
        torch.cuda.empty_cache()
    cclip_hazard_checks()
    return summary


def cclip_hazard_checks():
    """K22 at small widths (P = 1, 37, 4099 and the prime 65537) and n = 1,
    3, 8, 64, fp32 and bf16: inf / NaN in the rows with lam = 0 (never
    read: the output stays finite), every lam = 0 (the output is v
    exactly), sum lam = 1 and plain weights; exact against the plain
    version."""
    from repro_torch import kernels
    from repro_torch.kernels.wsum import clipped_weighted_sum_plain

    gen = torch.Generator(device=DEVICE).manual_seed(18)
    for n, d in ((1, 1), (3, 4099), (8, 65537), (64, 37), (8, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            errs, props = [], True
            for case in ("live", "dead_nonfinite", "all_zero", "sum_one"):
                g = torch.randn((n, d), generator=gen, device=DEVICE) * 2.0
                lam = torch.rand(n, generator=gen, device=DEVICE) / n
                v = torch.randn(d, generator=gen, device=DEVICE)
                if case == "dead_nonfinite":
                    lam[::2] = 0.0
                    g[::2, ::3] = math.inf
                    g[::2, 1::3] = math.nan
                elif case == "all_zero":
                    lam.zero_()
                elif case == "sum_one":
                    lam.fill_(1.0 / n)
                g = g.to(dtype)
                out = kernels.clipped_weighted_sum(lam, g, v)
                errs.append(max_abs_err(
                    out, clipped_weighted_sum_plain(lam, g, v)))
                props &= bool(torch.isfinite(out).all())
                if case == "all_zero":
                    props &= torch.equal(out, v)
            torch.cuda.synchronize()
            check("clipped_weighted_sum_hazards",
                  props and max(errs) == 0.0, of=K22, n=n,
                  dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                  cases=["live", "dead_nonfinite", "all_zero", "sum_one"],
                  max_abs_diff=max(errs))


# ---------------------------------------------------------------------------
# phases 3 and 4


class DequantCount:
    """Counts the engine-level dequantizations of a quantized arena
    (``aggregators._flat_dequant``) while entered."""

    def __enter__(self):
        from repro_torch.core import aggregators
        self.mod, self.real, self.n = aggregators, aggregators._flat_dequant, 0

        def counted(*a):
            self.n += 1
            return self.real(*a)

        aggregators._flat_dequant = counted
        return self

    def __exit__(self, *exc):
        self.mod._flat_dequant = self.real


def want_dequant(rule, agg_dtype, steps):
    return steps if agg_dtype in QUANT and rule in DEQUANT_RULES else 0


def phase_train(cfg, table, steps, agg_dtype="", seq=SEQ,
                per_agent=PER_AGENT, phase="train", vs_gather=None):
    """Per rule of ``table`` (rule -> (n, hyper, kernels of one step)):
    one untimed warm-up step, then ``steps`` timed steps through
    ``train_loop`` (with exchange dtype ``agg_dtype``, ``per_agent``
    sequences of ``seq`` tokens an agent); the launch counts, reset just
    before the timed run and read just after, must show each of the
    rule's kernels once per step and no other, and a quantized exchange
    one engine-level dequantization per step for krum and none for the
    rules with a scaled kernel.  Each rule prints a ``phase`` line.
    ``vs_gather``: the name of a line on which the warm-up step's arena,
    aggregated again with impl="gather", is held to the kernel's
    aggregate (:func:`against_gather`)."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop

    totals = {k: 0 for k in SOURCES}
    for rule, (n, hyper, names) in table.items():
        ds = SyntheticLM(cfg.vocab_size, seq, n, per_agent)
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        store = {}
        warm = bz if vs_gather is None else dataclasses.replace(
            bz, aggregator=recorded(bz.aggregator, store))
        # one untimed warm-up step, so that every timed step is warm
        train_loop(cfg, warm, adamw(constant(1e-4)), ds, steps=1, seed=0,
                   device=DEVICE, log_fn=lambda s: None)
        if vs_gather is not None:
            stack, _, _, out, _ = store.pop("kernel")
            err, close = against_gather(rule, stack, out)
            emit(vs_gather, arch=cfg.name, rule=rule, seq=seq,
                 step="warm-up", ok=close, arena_dtype=str(stack.dtype),
                 max_abs_diff=err)
            if not close:
                fail(f"{cfg.name} {rule}: kernel against gather {err}")
            del stack, out
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with DequantCount() as dq:
            _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                                 steps=steps, seed=0, device=DEVICE,
                                 log_every=1, log_fn=lambda s: None)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        wall = [h["wall_s"] for h in hist]
        step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
        losses = [h["loss"] for h in hist]
        want = {k: (steps if k in names else 0) for k in SOURCES}
        emit(phase, rule=rule, n=n, hyper=hyper, impl=bz.aggregator.impl,
             agg_dtype=agg_dtype or None, steps=steps, losses=losses,
             step_ms=step_ms, median_step_ms=statistics.median(step_ms),
             peak_mem_gb=peak / 1e9, launches=counts,
             engine_dequant=dq.n)
        if not all(math.isfinite(v) for v in losses):
            fail(f"{rule}: non-finite loss {losses}")
        if counts != want:
            fail(f"{rule}: kernel launches {counts}, expected {want}")
        if dq.n != want_dequant(rule, agg_dtype, steps):
            fail(f"{rule} {agg_dtype}: {dq.n} engine dequantizations")
        for k, v in counts.items():
            totals[k] += v
    return totals


def kernel_selection(rule, gr, n, f, hyper):
    """The kernel path's selection on the (n, n) Gram ``gr``: CGE's
    keep-mask, else the (n,) pick order (sentinel n)."""
    from repro_torch import kernels
    from repro_torch.kernels.ops import mda_order
    from repro_torch.kernels.select import gram_d2
    if rule == "cge":
        return kernels.cge_select(gr, n - f)
    if rule == "multi_krum":
        return kernels.multi_krum_order(gr, f, hyper["m"]).long()
    if rule == "mda":
        return mda_order(gram_d2(gr), n, f).long()
    k = hyper["m"] if rule == "m_krum" else n - 2 * f
    return kernels.iterative_order(gr, f, k).long()


def gather_selection(rule, g, n, f, hyper):
    """The gather law's selection on the fp32 arena, in the form of
    :func:`kernel_selection`, recomputed with the dense laws' own helpers
    (``repro_torch.core.filters.dense``)."""
    from repro_torch.core.aggregators import mda_combos
    from repro_torch.core.filters import dense as D
    order = torch.full((n,), n, dtype=torch.int64, device=g.device)
    if rule == "cge":
        keep = torch.zeros((n,), device=g.device)
        keep[D._ascending(torch.linalg.vector_norm(g, dim=-1), n - f)] = 1.0
        return keep
    d2 = D.pairwise_sq_dists(g)
    if rule == "multi_krum":
        m = hyper["m"]
        order[D._ascending(D.krum_scores(d2, f), m)] = torch.arange(
            m, device=g.device)
        return order
    if rule == "mda":
        combos = torch.as_tensor(mda_combos(n, f), device=g.device)
        sub = d2[combos[:, :, None], combos[:, None, :]]
        best = combos[D.argmin_tiebreak(torch.amax(sub, dim=(1, 2)),
                                        torch.sum(sub, dim=(1, 2)))]
        order[best] = torch.arange(n - f, device=g.device)
        return order
    k = hyper["m"] if rule == "m_krum" else n - 2 * f
    mask = torch.ones((n,), dtype=torch.bool, device=g.device)
    for it in range(k):
        sc = D.krum_scores(d2, f, mask=mask, k=max(n - it - f - 2, 1))
        i = D.argmin_tiebreak(sc, D.masked_row_sums(d2, mask))
        order[i] = it
        mask[i] = False
    return order


def straggler_sim(quorum=6):
    from repro_torch.simulator import SimConfig, Straggler
    return SimConfig(faults=(Straggler("lognormal", 0.8),), quorum=quorum,
                     max_staleness=3, seed=0)


# (n, quorum) -> (arrived, max staleness) of the straggler trace's rows
STRAGGLER_TRACES = {(N, 6): ([6] * 6, [0, 1, 2, 1, 2, 1]),
                    (11, 9): ([9] * 4, [0, 1, 1, 2])}


def check_straggler_traces():
    """The straggler profile's rows at n = 8 (quorum 6) and n = 11 (quorum
    9): a fixed number of deliveries, so no row is pure."""
    from repro_torch.simulator import plan_arrivals
    for (n, quorum), (arrived, stale) in STRAGGLER_TRACES.items():
        tr = plan_arrivals(straggler_sim(quorum), n, len(arrived))
        if (tr.contrib.sum(1).tolist() != arrived
                or tr.staleness.max(1).tolist() != stale):
            fail(f"straggler trace (n={n}, quorum={quorum}) changed: "
                 f"arrived {tr.contrib.sum(1)}, max staleness "
                 f"{tr.staleness.max(1)}")


def phase_async(cfg, table, steps, agg_dtype="", seq=SEQ,
                per_agent=PER_AGENT, phase="async"):
    """Per rule of ``table`` (rule -> (n, quorum, hyper, the kernels of
    one step)): the straggler profile through ``train_loop(sim=...)``
    (with exchange dtype ``agg_dtype``, ``per_agent`` sequences of ``seq``
    tokens an agent), 1 warm-up step, then ``steps`` timed steps.  The
    launch counts, reset just before the timed run and read just after,
    must show each of the rule's kernels once a step and no other, one
    async step built, and the engine-level dequantizations as in
    :func:`phase_train`.  Each rule prints a ``phase`` line."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop

    totals = {k: 0 for k in SOURCES}
    step_ms_by_rule = {}
    for rule, (n, quorum, hyper, names) in table.items():
        sim = straggler_sim(quorum)
        ds = SyntheticLM(cfg.vocab_size, seq, n, per_agent)
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=1, seed=0,
                   device=DEVICE, sim=sim, log_fn=lambda s: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = snapshot()
        kernels.reset_launch_counts()
        with DequantCount() as dq:
            _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                                 steps=steps, seed=0, device=DEVICE, sim=sim,
                                 log_every=1, log_fn=lambda s: None)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        built = counter_delta(before)
        peak = torch.cuda.max_memory_allocated()
        wall = [h["wall_s"] for h in hist]
        step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
        losses = [h["loss"] for h in hist]
        want = {k: (steps if k in names else 0) for k in SOURCES}
        step_ms_by_rule[rule] = statistics.median(step_ms)
        emit(phase, rule=rule, n=n, quorum=quorum, hyper=hyper,
             impl=bz.aggregator.impl, agg_dtype=agg_dtype or None,
             steps=steps, engine_dequant=dq.n,
             arrived=[h["arrived"] for h in hist],
             staleness_mean=[h["staleness_mean"] for h in hist],
             losses=losses, step_ms=step_ms,
             median_step_ms=step_ms_by_rule[rule], peak_mem_gb=peak / 1e9,
             launches=counts, steps_built=built)
        if not all(math.isfinite(v) for v in losses):
            fail(f"async {rule}: non-finite loss {losses}")
        if counts != want:
            fail(f"async {rule}: kernel launches {counts}, expected {want}")
        if built != {"async_step": 1}:
            fail(f"async {rule}: built {built}, expected one async step")
        if dq.n != want_dequant(rule, agg_dtype, steps):
            fail(f"async {rule} {agg_dtype}: {dq.n} engine "
                 "dequantizations")
        for k, v in counts.items():
            totals[k] += v
    return totals, step_ms_by_rule


def phase_async_elastic(cfg):
    """The elastic trimmed_mean under churn: one step build per bucket,
    K1 on the pure step and K5 on the others."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import elastic, frac, make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import Churn, SimConfig
    from repro_torch.training import ByzantineConfig, train_loop

    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    spec = make_spec("trimmed_mean", f=frac(0.25), n=elastic(N, (4, 6, 8)))
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                         attack="sign_flip", remat=True)
    sim = SimConfig(faults=(Churn(rate=0.25, mean_out=2.0),), seed=0)
    before = snapshot()
    kernels.reset_launch_counts()
    _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                         steps=len(CHURN_LIVE), seed=0, device=DEVICE,
                         sim=sim, log_every=1, log_fn=lambda s: None)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    built = counter_delta(before)
    live = [h["n_live"] for h in hist]
    losses = [h["loss"] for h in hist]
    wall = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
    want = {k: 0 for k in SOURCES}
    want.update(coord_stat=1, masked_coord_stat=len(CHURN_LIVE) - 1)
    emit("async_elastic", rule="trimmed_mean", spec=spec.describe(),
         n_live=live, losses=losses, step_ms=step_ms, launches=counts,
         steps_built=built)
    if live != CHURN_LIVE:
        fail(f"churn trace changed: live {live}, expected {CHURN_LIVE}")
    if built != {"async_step": 3, "train_step": 1}:
        fail(f"elastic run built {built}, expected 3 bucket async steps "
             "and 1 synchronous step")
    if counts != want:
        fail(f"elastic run launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"elastic run: non-finite loss {losses}")
    return counts


def async_setup(cfg, seed, n=N, quorum=6):
    """Full-width parameters, a nonzero fp32 in-flight buffer, a batch and
    row 2 of the straggler trace (at n = 8, quorum 6: max staleness 2),
    all from ``seed``, for ``n`` agents."""
    from repro_torch.core.flat import FlatPlan
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.simulator import plan_arrivals, staleness_weights

    gen = make_generator(seed, DEVICE)
    params = init_params(cfg, gen)
    total = FlatPlan.for_proto(params).total
    buffer = torch.randn((n, total), generator=gen, device=DEVICE) * 1e-3
    ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    sim = straggler_sim(quorum)
    tr = plan_arrivals(sim, n, 3)
    cw = torch.from_numpy(staleness_weights(sim, tr)[2]).to(DEVICE)
    return params, buffer, batch, tr.refresh[2], cw


def phase_profile_async(cfg, table):
    """Per rule of ``table`` (rule -> (n, quorum, hyper)), one async step
    (row 2 of the straggler trace) after a warm-up step: untraced on the
    host clock, then traced; device busy time, idle share and the top
    device events, as phase_profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    setups = {}
    for rule, (n, quorum, hyper) in table.items():
        if (n, quorum) not in setups:
            setups.clear()
            torch.cuda.empty_cache()
            setups[n, quorum] = async_setup(cfg, 5, n, quorum)
        params, buffer, batch, refresh, cw = setups[n, quorum]
        opt = adamw(constant(1e-4))
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True)
        step = make_async_step(cfg, bz, opt, device=DEVICE)
        state = opt.init(params)
        args = (batch, None, refresh, cw)
        step(params, state, None, buffer, {}, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, None, buffer, {}, *args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, None, buffer, {}, *args)
            torch.cuda.synchronize()
            traced_ms = 1e3 * (time.perf_counter() - t0)
        busy, span, by_name = device_busy(prof)
        seen = busy > 0
        ours = sum(t for k, t in by_name.items()
                   if any(name in k for name in OUR_KERNELS))
        top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
        emit("profile_async", rule=rule, n=n, step_ms=wall_ms,
             traced_step_ms=traced_ms,
             device_busy_ms=busy if seen else "not measured",
             device_span_ms=span if seen else "not measured",
             device_idle_share=(1 - busy / wall_ms) if seen else
             "not measured",
             aggregation_kernels_ms=ours if seen else "not measured",
             top_device_events_ms=[[k[:60], t] for k, t in top])
        del state
    setups.clear()
    torch.cuda.empty_cache()


def masked_selections(rule, stack, mask, weights, n, f, hyper):
    """(kernel selection, gather selection, whether a ghost row is
    selected) of one masked step: the kernel path's on the card's imputed
    Gram (K4 mean -> K6), the gather law's on the imputed fp32 stack
    (:func:`gather_selection`), each in :func:`kernel_selection`'s form."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import _masked_prelude
    from repro_torch.kernels.ref import masked_impute_ref
    mask, w, _, tot = _masked_prelude(mask, weights)
    wn = w / tot
    mean = kernels.imputed_mean(stack, wn)
    sel_k = kernel_selection(rule, kernels.masked_gram(stack, mask.float(),
                                                       wn, mean), n, f, hyper)
    imputed = masked_impute_ref(stack, mask.float(), wn).float()
    sel_g = gather_selection(rule, imputed, n, f, hyper)
    picked = sel_k > 0.5 if rule == "cge" else sel_k < n
    return sel_k, sel_g, bool((picked & ~mask).any())


EXACT_RULES = ("coordinate_median", "krum", "sign_sgd")


def recorded(spec, store):
    """A copy of ``spec`` whose ``aggregate_flat`` keeps, in
    ``store[impl]``, the arena, mask and weights it gets, the fp32
    aggregate it returns and the row scales of a quantized arena."""
    from repro_torch.core.aggregators import AggregatorSpec

    class Recorded(AggregatorSpec):
        def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                           scale=None):
            out = super().aggregate_flat(stack, mask, weights, state, scale)
            store[self.impl] = (stack, mask, weights, out, scale)
            return out

    return Recorded(**{f.name: getattr(spec, f.name)
                       for f in dataclasses.fields(spec)})


def same(a, b):
    """Bitwise equality (int8 / fp8 codes compared as bytes)."""
    if a is None or b is None:
        return a is b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def compare_impls(phase, rule, n, hyper, store, losses, **kw):
    """The kernel and gather runs of one step from the same state: the
    arenas (and mask and weights) equal, the losses equal, for the
    selection family the selection and pick order equal (on the imputed
    stack for a masked step, with whether a ghost row is selected), the
    aggregates exact for EXACT_RULES and within 3e-6 otherwise."""
    from repro_torch import kernels
    (xk, mk, wk, ak, sk), (xg, mg, wg, ag, sg) = (store["kernel"],
                                                  store["gather"])
    same_arena = (same(xk, xg) and same(mk, mg) and same(wk, wg)
                  and same(sk, sg))
    if rule in SEL_RULES:
        if mk is None:
            sel_k = kernel_selection(rule, kernels.gram(xk), n, F, hyper)
            sel_g = gather_selection(rule, xg.float(), n, F, hyper)
        else:
            sel_k, sel_g, kw["ghost_selected"] = masked_selections(
                rule, xk, mk, wk, n, F, hyper)
        kw.update(same_selection=torch.equal(sel_k, sel_g),
                  selection_kernel=sel_k.tolist(),
                  selection_gather=sel_g.tolist())
    err = max_abs_err(ak, ag)
    close = err == 0.0 if rule in EXACT_RULES else bool(torch.allclose(
        ak, ag, rtol=TOL, atol=TOL))
    ok = (same_arena and close and kw.get("same_selection", True)
          and losses["kernel"] == losses["gather"])
    emit(phase, rule=rule, n=n, hyper=hyper, ok=ok, same_arena=same_arena,
         max_abs_diff=err, loss_kernel=losses["kernel"],
         loss_gather=losses["gather"], **kw)
    store.clear()
    torch.cuda.empty_cache()
    if not ok:
        fail(f"{phase} {rule} {kw}: kernel path differs from gather (arena "
             f"equal {same_arena}, aggregate {err}, losses {losses})")


def sync_pair(cfg, rule, n, hyper, base, batch, store, agg_dtype=""):
    """One full-width synchronous step of ``rule`` with impl="kernel" and
    with impl="gather" from the same parameters and batch (exchange dtype
    ``agg_dtype``); returns the losses (the specs' arguments and
    aggregates land in ``store``)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    losses = {}
    for impl in ("kernel", "gather"):
        spec = recorded(make_spec(rule, f=F, impl=impl, n=n, **hyper), store)
        bz = ByzantineConfig(n_agents=n, f=F, aggregator=spec,
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        opt = adamw(constant(1e-4))
        step = make_train_step(cfg, bz, opt, device=DEVICE)
        params = _clone(base)
        _, _, _, met = step(params, opt.init(params), None, batch)
        losses[impl] = float(met["loss"])
        del params
    return losses


def phase_kernel_vs_gather(cfg, rules):
    """Phase 4: one full-width synchronous step per rule of ``rules`` (n =
    8), all from one parameter set and batch (seed 1)
    (:func:`compare_impls`)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(1, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    for rule in rules:
        losses = sync_pair(cfg, rule, N, {}, base, batch, store)
        compare_impls("kernel_vs_gather", rule, N, {}, store, losses)
    torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()


def phase_selection_vs_gather(cfg):
    """Phase 4c: one full-width synchronous step per selection rule (seed
    3, a batch per rule) (:func:`compare_impls`)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(3, DEVICE)
    base = init_params(cfg, gen)
    store = {}
    for rule, (n, hyper, _) in SEL_RULES.items():
        ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
        batch = ds.batch(ds.draw_starts(gen))
        losses = sync_pair(cfg, rule, n, hyper, base, batch, store)
        compare_impls("selection_vs_gather", rule, n, hyper, store, losses)
    torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()


def async_pair(cfg, spec_of, n, base, buffer, batch, refresh, cw,
               *bucket_args, bucket=None, agg_dtype=""):
    """One full-width async step with ``spec_of("kernel")`` and with
    ``spec_of("gather")`` from the same parameters, buffer, batch and
    trace row (exchange dtype ``agg_dtype``); returns (store, losses) as
    :func:`sync_pair`."""
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    store, losses = {}, {}
    for impl in ("kernel", "gather"):
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=recorded(spec_of(impl), store),
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        opt = adamw(constant(1e-4))
        step = make_async_step(cfg, bz, opt, device=DEVICE, bucket=bucket)
        params = _clone(base)
        _, _, _, _, _, met = step(params, opt.init(params), None,
                                  buffer.clone(), {}, batch, None, refresh,
                                  cw, *bucket_args)
        losses[impl] = float(met["loss"])
        del params
    return store, losses


def phase_tie_check(cfg):
    """Phase 4c, ROADMAP.md P12: the synchronous bulyan step at n = 11 on
    the seed-1 parameters and batch, where the gather law once broke the
    exact Krum tie of the two equal sign_flip rows the other way.  The
    gather law's distances must be bitwise equal for the equal rows, and
    the kernel and gather paths must pick in the same order
    (:func:`compare_impls`)."""
    from repro_torch.core.filters.dense import pairwise_sq_dists
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    n = SEL_RULES["bulyan"][0]
    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(1, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    losses = sync_pair(cfg, "bulyan", n, {}, base, batch, store)
    x = store["gather"][0].float()
    d2 = pairwise_sq_dists(x)
    equal_rows = same(x[0], x[1])
    tie = equal_rows and same(d2[0, F:], d2[1, F:]) and float(d2[0, 1]) == 0
    emit("tie_check", rule="bulyan", n=n, seed=1, equal_rows=equal_rows,
         equal_distances=tie)
    del d2
    if not tie:
        fail("P12: the equal sign_flip rows' gather distances differ")
    gram_cost(x)
    del x
    compare_impls("selection_vs_gather", "bulyan", n, {}, store, losses,
                  seed=1, tie_check=True)
    torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()


def matmul_sq_dists(g):
    """The gather law's distances before P12's repair: the Gram as one
    library product ``g @ g.T``, which breaks an exact tie by rounding."""
    sq = torch.sum(torch.square(g), dim=-1)
    gram = g @ g.T
    d2 = torch.triu(torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram,
                                    0.0), 1)
    return d2 + d2.T


def gram_cost(x):
    """What P12's repair costs the gather law at full width: the distances
    of one fixed-order dot per pair against the library product, alone
    and inside the gather aggregation of krum (n = 8) and bulyan (n = 11),
    on the rows ``x`` of the tie check's step."""
    from unittest import mock

    from repro_torch.core.aggregators import make_spec
    from repro_torch.core.filters import dense

    for rule, n in (("krum", N), ("bulyan", x.shape[0])):
        g = x[:n]
        spec = make_spec(rule, f=F, impl="gather", n=n)
        row = {"pair_dists_ms": time_ms(lambda: dense.pairwise_sq_dists(g),
                                        2),
               "matmul_dists_ms": time_ms(lambda: matmul_sq_dists(g), 2),
               "gather_ms": time_ms(lambda: spec.aggregate_flat(g), 2)}
        with mock.patch.object(dense, "pairwise_sq_dists", matmul_sq_dists):
            row["gather_matmul_ms"] = time_ms(lambda: spec.aggregate_flat(g),
                                              2)
        emit("gather_gram", rule=rule, n=n, shape=list(g.shape), **row)


def phase_quant_vs_gather(cfg):
    """Phase 4x: the compressed exchange, impl="kernel" against
    impl="gather" from the same state: one full-width synchronous step per
    rule of QUANT_RULES in int8 and fp8 (seed 4), one async step per rule
    of ASYNC_QUANT_RULES in int8 (seed 6, row 2 of the straggler trace).
    The codes and scales (and mask and weights) bitwise equal, equal
    losses, median, sign and krum exact, trimmed mean within 3e-6
    (:func:`compare_impls`; krum's exact aggregate is its selected row)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(4, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    for qdt in QUANT:
        for rule in QUANT_RULES:
            losses = sync_pair(cfg, rule, N, {}, base, batch, store,
                               agg_dtype=qdt)
            compare_impls("quant_vs_gather", rule, N, {}, store, losses,
                          agg_dtype=qdt, loop="sync")
    del base, batch
    torch.cuda.empty_cache()
    setup = async_setup(cfg, 6)
    for rule, (n, quorum, hyper, _) in ASYNC_QUANT_RULES.items():
        store, losses = async_pair(
            cfg, lambda impl: make_spec(rule, f=F, impl=impl, n=n, **hyper),
            n, *setup, agg_dtype="int8")
        compare_impls("quant_vs_gather", rule, n, hyper, store, losses,
                      agg_dtype="int8", loop="async", quorum=quorum,
                      arrived=int((setup[-1] > 0).sum()))
    torch.use_deterministic_algorithms(False)
    del setup
    torch.cuda.empty_cache()


def phase_masked_vs_gather(cfg, table):
    """One full-width async step per rule of ``table`` (rule -> (n, quorum,
    hyper, ...)) with impl="kernel" and with impl="gather", from the same
    parameters, buffer, batch and row 2 of the straggler trace; then the
    elastic trimmed_mean's bucket steps with ghost rows (3 live in bucket
    4, 7 live in bucket 8), as the churn run packs them
    (:func:`compare_impls`)."""
    from repro_torch.core.aggregators import elastic, frac, make_spec

    def run(*a, **kw):
        return async_pair(cfg, *a, **kw)

    torch.use_deterministic_algorithms(True, warn_only=True)
    setups = {}
    for rule, (n, quorum, hyper, _) in table.items():
        if (n, quorum) not in setups:
            setups.clear()
            torch.cuda.empty_cache()
            setups[n, quorum] = async_setup(cfg, 6, n, quorum)
        setup = setups[n, quorum]
        store, losses = run(lambda impl: make_spec(rule, f=F, impl=impl, n=n,
                                                   **hyper), n, *setup)
        compare_impls("masked_vs_gather", rule, n, hyper, store, losses,
                      quorum=quorum, arrived=int((setup[-1] > 0).sum()))

    setups.clear()
    torch.cuda.empty_cache()
    base, buffer, batch, _, _ = async_setup(cfg, 6)
    for live in ((1, 3, 6), (0, 1, 2, 3, 4, 5, 7)):
        spec_e = make_spec("trimmed_mean", f=frac(0.25),
                           n=elastic(N, (4, 6, 8)))
        b, idx, valid = spec_e.elastic.pack(np.asarray(live))
        cw_b = torch.zeros(N, device=DEVICE)
        cw_b[list(live)] = 1.0
        refresh_b = np.zeros(N, bool)
        refresh_b[list(live)] = True
        store, losses = run(
            lambda impl: make_spec("trimmed_mean", f=frac(0.25), impl=impl,
                                   n=elastic(N, (4, 6, 8))),
            N, base, buffer, batch, refresh_b, cw_b, False,
            torch.as_tensor(idx, dtype=torch.int64, device=DEVICE),
            torch.as_tensor(valid, device=DEVICE), bucket=int(b))
        compare_impls("masked_vs_gather", "trimmed_mean", int(b), {}, store,
                      losses, arrived=len(live), bucket=int(b))
    torch.use_deterministic_algorithms(False)
    del buffer
    torch.cuda.empty_cache()


def phase_sparse_vs_gather(cfg):
    """Phase 4s: sparse_mean with impl="kernel" against impl="gather" from
    the same state: one full-width synchronous step (seed 8), one int8
    synchronous step, one async step (seed 9, row 2 of the straggler
    trace) (:func:`compare_impls`); then the mixed-dtype masked tree."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(8, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    for qdt in ("", "int8"):
        losses = sync_pair(cfg, "sparse_mean", N, {}, base, batch, store,
                           agg_dtype=qdt)
        compare_impls("sparse_vs_gather", "sparse_mean", N, {}, store,
                      losses, agg_dtype=qdt or None, loop="sync")
    del base, batch
    torch.cuda.empty_cache()
    setup = async_setup(cfg, 9)
    store, losses = async_pair(
        cfg, lambda impl: make_spec("sparse_mean", f=F, impl=impl, n=N), N,
        *setup)
    compare_impls("sparse_vs_gather", "sparse_mean", N, {}, store, losses,
                  loop="async", arrived=int((setup[-1] > 0).sum()))
    torch.use_deterministic_algorithms(False)
    del setup
    torch.cuda.empty_cache()
    mixed_tree_checks()


# ---------------------------------------------------------------------------
# phases 3m and 4m: the defenses with memory and the defense-aware attacks

CCLIP_ITERS = 5             # centered_clip's default iters: K22 a step


MEMORY_STEPS = 1            # timed steps a case


def memory_cases():
    """(label, spec, attack, trace, agg_dtype, timed steps, the kernels of
    one step) of phase 3m: the phase-3b configuration through
    ``train_loop`` with a stateful spec or a defense-aware attack."""
    from repro_torch.core.aggregators import make_spec, server_momentum
    cck = make_spec("centered_clip", f=F, n=N, impl="kernel")
    smt = server_momentum(make_spec("trimmed_mean", f=F, n=N))
    k22 = {K22: CCLIP_ITERS}
    k5 = {"masked_coord_stat": 1}
    steps = MEMORY_STEPS
    return [
        ("centered_clip kernel", cck, "sign_flip", "sync", "", steps, k22),
        ("centered_clip kernel", cck, "sign_flip", "stragglers", "", steps,
         k22),
        ("centered_clip auto", make_spec("centered_clip", f=F, n=N),
         "sign_flip", "stragglers", "", steps, {}),
        ("zeno_pp", make_spec("zeno_pp", f=F, n=N), "sign_flip",
         "stragglers", "", steps, {}),
        ("server_momentum(trimmed_mean)", smt, "sign_flip", "stragglers",
         "", steps, k5),
        ("spec_alie vs centered_clip kernel", cck, "spec_alie",
         "stragglers", "", steps, k22),
        ("min_max vs centered_clip kernel", cck, "min_max", "stragglers",
         "", steps, k22),
        ("slow_drift vs server_momentum(trimmed_mean)", smt, "slow_drift",
         "stragglers", "", steps, k5),
        ("centered_clip kernel int8", cck, "sign_flip", "stragglers",
         "int8", 1, k22),
    ]


def phase_memory(cfg):
    """Phase 3m: per case of :func:`memory_cases`, 1 untimed warm-up step
    and the timed steps through ``train_loop`` (on the synchronous trace
    too, every row runs the general async step: the state must see each
    step).  The launch counts, reset just before the timed run and read
    just after, must show the case's kernels per step and no other (the
    attack probes run the gather impl: no launch), one async step built
    and no synchronous one, and no engine-level dequantization."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop

    totals = {k: 0 for k in SOURCES}
    step_ms_by_case = {}
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    for label, spec, attack, trace, qdt, steps, per_step in memory_cases():
        sim = straggler_sim() if trace == "stragglers" else None
        bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec, attack=attack,
                             remat=True, agg_dtype=qdt)
        train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=1, seed=0,
                   device=DEVICE, sim=sim, log_fn=lambda s: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = snapshot()
        kernels.reset_launch_counts()
        with DequantCount() as dq:
            _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                                 steps=steps, seed=0, device=DEVICE, sim=sim,
                                 log_every=1, log_fn=lambda s: None)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        built = counter_delta(before)
        peak = torch.cuda.max_memory_allocated()
        wall = [h["wall_s"] for h in hist]
        step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
        losses = [h["loss"] for h in hist]
        want = {k: steps * per_step.get(k, 0) for k in SOURCES}
        key = f"{label}, {trace}" + (f", {qdt}" if qdt else "")
        step_ms_by_case[key] = statistics.median(step_ms)
        emit("memory", case=label, spec=spec.describe(), impl=spec.impl,
             attack=attack, trace=trace, agg_dtype=qdt or None, steps=steps,
             arrived=[h["arrived"] for h in hist], losses=losses,
             step_ms=step_ms, median_step_ms=step_ms_by_case[key],
             peak_mem_gb=peak / 1e9, launches=counts, steps_built=built,
             engine_dequant=dq.n)
        if not all(math.isfinite(v) for v in losses):
            fail(f"memory {key}: non-finite loss {losses}")
        if counts != want:
            fail(f"memory {key}: kernel launches {counts}, expected {want}")
        if built != {"async_step": 1}:
            fail(f"memory {key}: built {built}, expected one async step")
        if dq.n:
            fail(f"memory {key}: {dq.n} engine dequantizations")
        for k, v in counts.items():
            totals[k] += v
    return totals, step_ms_by_case


def memory_profile(cfg):
    """One traced async step of kernel centered_clip (row 2 of the
    straggler trace, after a warm-up step): step ms, device busy, idle
    share, K22's device time and the top device events; then, on that
    step's buffer, the device time of the clip-radius stage (the row norms
    of one iteration, plain torch) apart from K22, and of the whole
    ``aggregate_flat`` on each impl."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import (_cclip_lam, _masked_prelude,
                                              make_spec)
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    params, buffer, batch, refresh, cw = async_setup(cfg, 5)
    spec = make_spec("centered_clip", f=F, n=N, impl="kernel")
    opt = adamw(constant(1e-4))
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                         attack="sign_flip", remat=True)
    step = make_async_step(cfg, bz, opt, device=DEVICE)
    ost = opt.init(params)
    st = spec.init_state(params)
    args = (batch, None, refresh, cw)
    _, _, _, _, st, _ = step(params, ost, None, buffer, st, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, _, st, _ = step(params, ost, None, buffer, st, *args)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, _, st, _ = step(params, ost, None, buffer, st, *args)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    busy, span, by_name = device_busy(prof)
    seen = busy > 0
    k22 = sum(t for k, t in by_name.items() if "clipped_wsum_kernel" in k)
    top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
    mask, w, _, tot = _masked_prelude(cw > 0, cw)
    wn = w / tot
    tau = torch.tensor(1.0, device=DEVICE)
    v = st["server_grad"]
    norm_ms = time_ms(lambda: _cclip_lam(buffer, mask, wn, v, tau), 5)
    agg_ms = {}
    for impl in ("kernel", "gather"):
        sp = make_spec("centered_clip", f=F, n=N, impl=impl)
        agg_ms[impl] = time_ms(
            lambda: sp.aggregate_flat(buffer, mask, cw, state=st), 3)
    emit("profile_memory", rule="centered_clip", impl="kernel", n=N,
         step_ms=wall_ms, traced_step_ms=traced_ms,
         device_busy_ms=busy if seen else "not measured",
         device_span_ms=span if seen else "not measured",
         device_idle_share=(1 - busy / wall_ms) if seen else "not measured",
         k22_device_ms_per_step=k22 if seen else "not measured",
         norm_stage_ms_per_iteration=norm_ms,
         aggregate_flat_ms=agg_ms,
         top_device_events_ms=[[k[:60], t] for k, t in top])
    del params, buffer, batch, ost, st
    torch.cuda.empty_cache()
    return {"norm_stage_ms_per_iteration": norm_ms,
            "aggregate_flat_ms": agg_ms}


def memory_pair(cfg, attack, params, buffer, batch, refresh, cw, carried):
    """One full-width async step of centered_clip with impl="kernel" and
    with impl="gather" from the same parameters, fresh optimizer state,
    buffer, trace row and carried state under ``attack``; returns (store,
    losses, the new states)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    store, losses, states = {}, {}, {}
    for impl in ("kernel", "gather"):
        spec = recorded(make_spec("centered_clip", f=F, n=N, impl=impl),
                        store)
        bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec, attack=attack,
                             remat=True)
        opt = adamw(constant(1e-4))
        step = make_async_step(cfg, bz, opt, device=DEVICE)
        p = _clone(params)
        st = {"server_grad": carried.clone()}
        if attack != "sign_flip":
            st = {"agg": st, "atk": {}}
        _, _, _, _, st, met = step(p, opt.init(p), None, buffer.clone(), st,
                                   batch, None, refresh, cw)
        losses[impl] = float(met["loss"])
        states[impl] = st.get("agg", st)["server_grad"]
        del p
    return store, losses, states


def phase_memory_vs_gather(cfg):
    """Phase 4m: kernel against gather for centered_clip, from one state
    (seed 6, row 2 of the straggler trace) with a nonzero ``server_grad``
    carried from an earlier gather step: under sign_flip and under
    min_max (whose probes run the gather impl on both paths), the arenas,
    mask and weights equal and the losses equal; the aggregate, the new
    ``server_grad`` and each of the 5 iterates within 3e-6."""
    from repro_torch.core.aggregators import cclip_iterates, make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    torch.use_deterministic_algorithms(True, warn_only=True)
    params, buffer, batch, refresh, cw = async_setup(cfg, 6)
    spec = make_spec("centered_clip", f=F, n=N, impl="gather")
    opt = adamw(constant(1e-4))
    step = make_async_step(cfg, ByzantineConfig(
        n_agents=N, f=F, aggregator=spec, attack="sign_flip", remat=True),
        opt, device=DEVICE)
    p = _clone(params)
    _, _, _, buffer, carried, _ = step(p, opt.init(p), None, buffer,
                                       spec.init_state(p), batch, None,
                                       refresh, cw)
    carried = carried["server_grad"]
    del p, step
    for attack in ("sign_flip", "min_max"):
        store, losses, states = memory_pair(cfg, attack, params, buffer,
                                            batch, refresh, cw, carried)
        (xk, mk, wk, ak, _), (xg, mg, wg, ag, _) = (store["kernel"],
                                                    store["gather"])
        same_arena = same(xk, xg) and same(mk, mg) and same(wk, wg)
        close = {"aggregate": (ak, ag),
                 "server_grad": (states["kernel"], states["gather"])}
        st = {"server_grad": carried}
        its = zip(cclip_iterates(make_spec("centered_clip", f=F, n=N,
                                           impl="kernel"), xk, mk, wk, st),
                  cclip_iterates(make_spec("centered_clip", f=F, n=N,
                                           impl="gather"), xg, mg, wg, st))
        for i, pair in enumerate(its, 1):
            close[f"iterate_{i}"] = pair
        errs = {k: max_abs_err(a, b) for k, (a, b) in close.items()}
        within = {k: bool(torch.allclose(a, b, rtol=TOL, atol=TOL))
                  for k, (a, b) in close.items()}
        ok = (same_arena and all(within.values())
              and len(close) == 2 + CCLIP_ITERS
              and losses["kernel"] == losses["gather"])
        emit("memory_vs_gather", rule="centered_clip", attack=attack, ok=ok,
             same_arena=same_arena, max_abs_diff=errs, within_3e6=within,
             loss_kernel=losses["kernel"], loss_gather=losses["gather"],
             carried_norm=float(torch.linalg.vector_norm(carried)))
        del store, close, its
        torch.cuda.empty_cache()
        if not ok:
            fail(f"memory_vs_gather {attack}: arena equal {same_arena}, "
                 f"errors {errs}, losses {losses}")
    torch.use_deterministic_algorithms(False)
    del params, buffer, batch, carried
    torch.cuda.empty_cache()


# the kernels each rule's kernel impl launches on a masked bf16 + fp32 tree
MIXED_TREE_KERNELS = {
    "coordinate_median": {"masked_coord_stat": 2},
    "trimmed_mean": {"masked_coord_stat": 2},
    "sign_sgd": {"masked_sign_vote": 2},
    "sparse_mean": {K17: 2},
    "krum": {"gram": 1, "krum_select": 1, "weighted_sum": 1}}


def mixed_tree_checks():
    """The masked ``spec.aggregate`` on a tree of bf16 and fp32 leaves (6
    of 8 arrived, staleness weights) at a small width, kernel against
    gather: median, sign and krum exact, trimmed mean and sparse_mean
    within 3e-6 (bf16 leaves 2e-2: one rounding after a reassociated sum);
    the kernel impl launches one masked kernel per leaf dtype (krum: the
    imputed fallback, K2 -> K3 -> K4 once, with its one warning), the
    gather impl none."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec

    gen = torch.Generator(device=DEVICE).manual_seed(13)

    def leaf(shape, dtype):
        x = torch.randn((N,) + shape, generator=gen, device=DEVICE) * 1e-3
        keep = torch.rand((N,) + shape, generator=gen, device=DEVICE) < 0.6
        return torch.where(keep, x, torch.zeros((), device=DEVICE)).to(dtype)

    tree = {"a": leaf((64, 33), torch.bfloat16),
            "b": {"c": leaf((1000,), torch.float32),
                  "e": leaf((7, 129), torch.bfloat16)}}
    m = arrival_mask(6).bool()
    w, _ = discount_weights(m.float())
    for rule, want in MIXED_TREE_KERNELS.items():
        outs, counts, warned = {}, {}, {}
        for impl in ("kernel", "gather"):
            kernels.reset_launch_counts()
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                outs[impl] = make_spec(rule, f=F, impl=impl, n=N).aggregate(
                    tree, mask=m, weights=w)
            torch.cuda.synchronize()
            counts[impl] = {k: v for k, v in kernels.launch_counts().items()
                            if v}
            warned[impl] = sum("mixed dtypes" in str(r.message) for r in rec)
        errs, ok = {}, True
        for key, k_leaf, g_leaf in (
                ("a", outs["kernel"]["a"], outs["gather"]["a"]),
                ("b.c", outs["kernel"]["b"]["c"], outs["gather"]["b"]["c"]),
                ("b.e", outs["kernel"]["b"]["e"], outs["gather"]["b"]["e"])):
            errs[key] = max_abs_err(k_leaf, g_leaf)
            tol = TOL if k_leaf.dtype == torch.float32 else 2e-2
            ok &= (k_leaf.dtype == g_leaf.dtype and (
                errs[key] == 0.0 if rule in EXACT_RULES else
                bool(torch.allclose(k_leaf.float(), g_leaf.float(),
                                    rtol=tol, atol=tol))))
        ok &= counts["kernel"] == want and not counts["gather"]
        ok &= warned == {"kernel": int(rule == "krum"), "gather": 0}
        emit("mixed_tree", rule=rule, ok=ok, max_abs_diff=errs,
             launches=counts, fallback_warnings=warned)
        if not ok:
            fail(f"mixed-dtype tree {rule}: errors {errs}, launches {counts} "
                 f"(kernel impl expected {want}), warnings {warned}")


# the port's kernels by name: K1, K18 and K19 run order_stat_kernel, K5
# coord_stat_kernel, K17 sparse_wmean_kernel, K21 scaled_sparse_kernel
OUR_KERNELS = ("order_stat_kernel", "coord_stat_kernel", "gram_mma_kernel",
               "gram_finish_kernel", "krum_select_kernel", "wsum_kernel",
               "masked_wsum_kernel", "cge_select_kernel",
               "multi_krum_order_kernel", "iterative_order_kernel",
               "ordered_apply_kernel", "bulyan_coord_kernel",
               "sign_vote_kernel", "sparse_wmean_kernel",
               "scaled_sparse_kernel", "coord_sort_kernel",
               "clipped_wsum_kernel")


def device_events(prof):
    """(name, start us, end us) of a trace's device-side events (kernels,
    copies, sets; not the spans a profiler range draws on the device),
    read from the profiler's raw results: building its event tree
    (``prof.events()``) takes seconds on a step's trace."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_hidden_event() and not e.is_user_annotation()]


def device_busy(prof):
    """Device-side events of a trace only (kernels, copies, sets): the
    union of their intervals in ms, the span from the first start to the
    last end in ms, and the time per event name.  The traces record
    device activity only: CPU operator rows would carry the device time
    of the kernels they launched, which the kernels' own rows hold
    already, so they are not recorded."""
    evs = device_events(prof)
    spans = sorted((s, e) for _, s, e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for name, s, e in evs:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return busy / 1e3, span, by_name


def phase_profile(cfg, table):
    """Per rule of ``table``, after a warm-up step: one untimed-by-profiler
    step timed on the host clock, then one traced step.  Reports the
    device busy time (union of device events), the idle share against
    the untraced step, the kernels' share of the busy time, the peak
    device memory of the traced step and the top device events.  Runs
    after the main path's launch counts are read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    gen = make_generator(2, DEVICE)
    params = init_params(cfg, gen)
    for rule, (n, hyper, _) in table.items():
        ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
        opt = adamw(constant(1e-4))
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True)
        step = make_train_step(cfg, bz, opt, device=DEVICE)
        state = opt.init(params)
        batch = ds.batch(ds.draw_starts(gen))
        step(params, state, None, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, None, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, None, batch)
            torch.cuda.synchronize()
            traced_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        busy, span, by_name = device_busy(prof)
        seen = busy > 0
        ours = sum(t for k, t in by_name.items()
                   if any(name in k for name in OUR_KERNELS))
        top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
        emit("profile", rule=rule, n=n, step_ms=wall_ms,
             traced_step_ms=traced_ms,
             device_busy_ms=busy if seen else "not measured",
             device_span_ms=span if seen else "not measured",
             device_idle_share=(1 - busy / wall_ms) if seen else
             "not measured",
             aggregation_kernels_ms=ours if seen else "not measured",
             peak_mem_gb=peak / 1e9,
             top_device_events_ms=[[k[:60], t] for k, t in top])
        del state
    del params
    torch.cuda.empty_cache()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


# ---------------------------------------------------------------------------
# the launch floor, gradient coding and the rules without a kernel
# (ROADMAP.md items 15 and 17)

def launch_floor(summary):
    """The time of one launch of an empty kernel under :func:`time_ms`
    (the same timer, reps and stream helper, ``build.stream_ptr``, as
    every launch-bound row), each launch-bound kernel's share of max(its
    bytes' bound, that floor), and the card's own time of each and of the
    empty kernel (``torch.profiler``, ``compare.device_ms``) at the
    main path's n: K3, K8, K9 and K10's 3 picks at n =
    8, and K10's 7 picks at n = 11 (bulyan's), timed here too."""
    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels.compare import device_ms, gram_of
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    gr, gr11 = gram_of(N, gen), gram_of(11, gen)
    floor = time_ms(lambda: build.empty_launch(gr), LAUNCH_REPS)

    def bulyan():
        return kernels.iterative_order(gr11, F, 11 - 2 * F)

    timed = {**summary, "iterative_order (n = 11, 7 picks)": {
        "ms": time_ms(bulyan, LAUNCH_REPS),
        "bound_ms": bound(4 * 11 * 11 + 4 * 11, 7 * 11 * 11 * 15)[0]}}
    calls = {"krum_select": ("krum_select_kernel",
                             lambda: kernels.krum_select(gr, F)),
             "cge_select": ("cge_select_kernel",
                            lambda: kernels.cge_select(gr, N - F)),
             "multi_krum_order": ("multi_krum_order_kernel",
                                  lambda: kernels.multi_krum_order(gr, F,
                                                                   3)),
             "iterative_order": ("iterative_order_kernel",
                                 lambda: kernels.iterative_order(gr, F, 3)),
             "iterative_order (n = 11, 7 picks)": ("iterative_order_kernel",
                                                   bulyan)}
    floor_dev, _ = device_ms("empty_kernel", lambda: build.empty_launch(gr))
    rows = {}
    for name, (event, call) in calls.items():
        s = timed[name]
        b = max(s["bound_ms"], floor)
        rows[name] = dict(ms=s["ms"], device_ms=device_ms(event, call)[0],
                          bytes_bound_ms=s["bound_ms"],
                          bound_with_floor_ms=b, share=b / s["ms"])
    emit("launch_floor", floor_ms=floor, floor_device_ms=floor_dev,
         reps=LAUNCH_REPS, kernels=rows)
    return floor


CODED_R, CODED_F = 4, 1
CODED_STEPS = 3
CODED_KERNELS = ("gram", "masked_weighted_sum")
# stragglers and crash / recover at quorum 6, seed 0: 6, 6, 5 and 3 of 8
# arrive, so rows 0-1 meet the quorum (the rule) and rows 2-3 miss it
# (the code)
CODED_TRACE = ([6, 6, 5, 3], [True, True, False, False])


def coded_sim(fallback_r=CODED_R):
    from repro_torch.simulator import CrashRecover, SimConfig, Straggler
    return SimConfig(faults=(Straggler("lognormal", 0.8),
                             CrashRecover(rate=0.2, mean_down=2.0)),
                     quorum=6, max_staleness=3, seed=0,
                     coded_fallback_r=fallback_r)


class CodedCapture:
    """Keeps the arguments of the training step's coded decode
    (``training.step.flat_draco_aggregate``) while entered."""

    def __enter__(self):
        from repro_torch.training import step
        self.mod, self.real, self.calls = step, step.flat_draco_aggregate, 0

        def captured(x, r, **kw):
            self.calls += 1
            self.last = (x, r, kw)
            return self.real(x, r, **kw)

        step.flat_draco_aggregate = captured
        return self

    def __exit__(self, *exc):
        self.mod.flat_draco_aggregate = self.real


def run_counted(cfg, bz, steps, sim=None, ds=None):
    """One untimed warm-up step, then ``steps`` timed steps through
    ``train_loop``, the launch counts reset just before and read just
    after: (history, counts, steps built, step ms, peak GB)."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import train_loop
    ds = ds or SyntheticLM(cfg.vocab_size, SEQ, bz.n_agents, PER_AGENT)
    train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=1, seed=0,
               device=DEVICE, sim=sim, log_fn=lambda s: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snapshot()
    kernels.reset_launch_counts()
    _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=steps,
                         seed=0, device=DEVICE, sim=sim, log_every=1,
                         log_fn=lambda s: None)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    built = counter_delta(before)
    wall = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
    return (hist, counts, built, step_ms,
            torch.cuda.max_memory_allocated() / 1e9)


def run_direct(cfg, bz, steps):
    """:func:`run_counted` through ``make_train_step`` itself: the loops
    refuse a ``staleness_aware`` spec (they pass discounts, not rounds),
    the synchronous step takes it."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import make_train_step
    gen = make_generator(0, DEVICE)
    params = init_params(cfg, gen)
    opt = adamw(constant(1e-4))
    ost = opt.init(params)
    ds = SyntheticLM(cfg.vocab_size, SEQ, bz.n_agents, PER_AGENT)
    step = make_train_step(cfg, bz, opt, device=DEVICE)
    params, ost, _, _ = step(params, ost, None, ds.batch(ds.draw_starts(gen)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snapshot()
    kernels.reset_launch_counts()
    hist, step_ms = [], []
    for _ in range(steps):
        batch = ds.batch(ds.draw_starts(gen))
        t0 = time.time()
        params, ost, _, met = step(params, ost, None, batch)
        hist.append({"loss": float(met["loss"])})
        step_ms.append(1e3 * (time.time() - t0))
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    return (hist, counts, counter_delta(before), step_ms,
            torch.cuda.max_memory_allocated() / 1e9)


def vote_margins(gr, groups, byz, tol=1e-6):
    """The vote's margins on the (n, n) Gram ``gr``: the largest d2 / (tol
    * scale) over the honest pairs of a group (< 1: they agree) and the
    smallest over its honest-against-Byzantine pairs (> 1: they do not),
    scale the group's lower-median squared norm."""
    sq = torch.diagonal(gr).double()
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gr.double(), 0.0)
    honest_max, cross_min = 0.0, math.inf
    for g in range(int(groups.max()) + 1):
        rows = [int(i) for i in np.flatnonzero(groups == g)]
        s = sorted(float(sq[i]) for i in rows)[(len(rows) - 1) // 2]
        ratio = d2 / (tol * max(s, 1e-30))
        for i in rows:
            for j in rows:
                if i == j:
                    continue
                v = float(ratio[i, j])
                if not (byz[i] or byz[j]):
                    honest_max = max(honest_max, v)
                elif byz[i] != byz[j]:
                    cross_min = min(cross_min, v)
    return honest_max, cross_min


def coded_decode_checks(x, mask, groups, byz):
    """The coded decode on the arena ``x`` one coded step handed it: K2's
    Gram and the plain Gram give the same decode weights, K7's aggregate
    equals the plain masked weighted sum with them (max |error| 0.0), the
    honest row wins every group, and the vote margins; K2, K7 and the
    whole decode timed against their plain versions and bounds.  Returns
    the (gram, masked_weighted_sum) errors and timing rows."""
    from repro_torch import kernels
    from repro_torch.core.redundancy.coding import (coded_vote_weights,
                                                    flat_draco_aggregate)
    from repro_torch.kernels.pairwise import gram_plain
    from repro_torch.kernels.wsum import masked_weighted_sum_plain
    n, P = x.shape
    s = x.element_size()
    gr, gp = kernels.gram(x), gram_plain(x)
    gerr = max_abs_err(gr, gp)
    w = coded_vote_weights(gr, CODED_R, mask=mask, groups=groups)
    same_w = torch.equal(w, coded_vote_weights(gp, CODED_R, mask=mask,
                                               groups=groups))
    m = (torch.ones(n, device=x.device) if mask is None else mask.float())
    zero = torch.zeros((P,), dtype=x.dtype, device=x.device)
    out = kernels.masked_weighted_sum(w, x, m, zero)
    werr = max_abs_err(out, masked_weighted_sum_plain(w, x, m, zero))
    winners = [int(i) for i in torch.nonzero(w).flatten().tolist()]
    honest_won = not any(byz[i] for i in winners)
    hmax, cmin = vote_margins(gr, groups, byz)
    n_win = len(winners)
    g_kw = timing(lambda: kernels.gram(x), lambda: gram_plain(x), 10, 2,
                  n * P * s + 4 * n * n, 2 * n * n * P,
                  library=lambda: x @ x.T, label="x @ x.T")
    w_kw = timing(lambda: kernels.masked_weighted_sum(w, x, m, zero),
                  lambda: masked_weighted_sum_plain(w, x, m, zero), 10, 2,
                  n_win * P * s + 4 * P, 2 * n_win * P,
                  library=lambda: torch.mv(x.t().float(), w),
                  label="torch.mv(x.t().float(), w) (an fp32 copy first)")
    decode_ms = time_ms(lambda: flat_draco_aggregate(
        x, CODED_R, mask=mask, groups=groups), 5)
    check("gram", gerr <= TOL * float(torch.diagonal(gp).abs().max()),
          case="coded decode arena", dtype=str(x.dtype)[6:], shape=[n, P],
          max_abs_diff=gerr, **g_kw)
    check("masked_weighted_sum", werr == 0.0 and same_w and honest_won
          and hmax < 1.0 < cmin, case="coded decode", dtype=str(x.dtype)[6:],
          shape=[n, P], max_abs_diff=werr, same_decode_weights=same_w,
          winners=winners, honest_winners=honest_won,
          honest_pair_max_ratio=hmax, honest_byzantine_min_ratio=cmin,
          decode_ms=decode_ms, **w_kw)
    return {"gram": (gerr, g_kw), "masked_weighted_sum": (werr, w_kw)}


def phase_coded_sync(cfg):
    """Phase 3k: the coded synchronous step at full width (parallel
    regime, n = 8, r = 4, f = 1, large_value): 1 warm-up and 3 timed
    steps; one K2 and one K7 a step and nothing else; then the decode of
    the last step's arena held against its plain version."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.core.attacks import make_byzantine_mask
    from repro_torch.core.redundancy.coding import coding_groups
    from repro_torch.data import SyntheticLM
    from repro_torch.training import ByzantineConfig
    bz = ByzantineConfig(n_agents=N, f=CODED_F, aggregator=make_spec(
        "trimmed_mean", f=CODED_F, n=N), attack="large_value", remat=True,
        draco_r=CODED_R)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT, regime="parallel")
    with CodedCapture() as cap:
        hist, counts, built, step_ms, peak = run_counted(cfg, bz,
                                                         CODED_STEPS, ds=ds)
    want = {k: (CODED_STEPS if k in CODED_KERNELS else 0) for k in SOURCES}
    losses = [h["loss"] for h in hist]
    emit("coded_train", loop="sync", n=N, r=CODED_R, f=CODED_F,
         attack="large_value", steps=CODED_STEPS, losses=losses,
         step_ms=step_ms, median_step_ms=statistics.median(step_ms),
         peak_mem_gb=peak, launches=counts, steps_built=built)
    if counts != want:
        fail(f"coded sync: kernel launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"coded sync: non-finite loss {losses}")
    x, _, kw = cap.last
    byz = make_byzantine_mask(N, CODED_F).tolist()
    errs = coded_decode_checks(x, kw.get("mask"), coding_groups(N, CODED_R),
                               byz)
    del cap, x
    torch.cuda.empty_cache()
    return counts, errs


def phase_coded_async(cfg):
    """Phase 3k (async): trimmed_mean with ``coded_fallback_r = 4`` under
    stragglers with crash / recover (rows 0-1 meet quorum 6, rows 2-3
    miss it), 1 warm-up and 4 timed steps: one K5 a rule step, one K2 and
    one K7 a coded step."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.simulator import plan_arrivals
    from repro_torch.training import ByzantineConfig
    sim = coded_sim()
    tr = plan_arrivals(sim, N, len(CODED_TRACE[0]))
    if (tr.contrib.sum(1).tolist(), tr.quorum_met.tolist()) != CODED_TRACE:
        fail(f"coded trace changed: arrived {tr.contrib.sum(1)}, quorum "
             f"met {tr.quorum_met}")
    bz = ByzantineConfig(n_agents=N, f=CODED_F, aggregator=make_spec(
        "trimmed_mean", f=CODED_F, n=N), attack="large_value", remat=True)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT, regime="parallel")
    steps = len(CODED_TRACE[0])
    hist, counts, built, step_ms, peak = run_counted(cfg, bz, steps, sim,
                                                     ds=ds)
    coded = int((~tr.quorum_met).sum())
    want = {k: 0 for k in SOURCES}
    want.update(gram=coded, masked_weighted_sum=coded,
                masked_coord_stat=steps - coded)
    losses = [h["loss"] for h in hist]
    emit("coded_train", loop="async fallback", n=N, r=CODED_R, f=CODED_F,
         quorum=6, arrived=[h["arrived"] for h in hist],
         rule_steps=steps - coded, coded_steps=coded, losses=losses,
         step_ms=step_ms, median_step_ms=statistics.median(step_ms),
         peak_mem_gb=peak, launches=counts, steps_built=built)
    if counts != want:
        fail(f"coded async: kernel launches {counts}, expected {want}")
    if built != {"async_step": 1}:
        fail(f"coded async: built {built}, expected one async step")
    if not all(math.isfinite(v) for v in losses):
        fail(f"coded async: non-finite loss {losses}")
    return counts


CODED_ELASTIC_LAYERS = 2


def phase_coded_elastic(cfg):
    """Phase 3k (elastic): the coded step under Churn at reduced depth
    (2 layers, full width): buckets (4, 6, 8), live 8, 6, 4, 6, 6, 7, 4,
    3; bucket 6 votes over a ragged table (0, 0, 0, 0, 1, 1).  One K2
    and one K7 a step, 3 bucket steps and the synchronous step built."""
    from repro_torch.core.aggregators import elastic, make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.simulator import Churn, SimConfig
    from repro_torch.training import ByzantineConfig
    small = cfg.replace(num_layers=CODED_ELASTIC_LAYERS)
    spec = make_spec("trimmed_mean", f=CODED_F, n=elastic(N, (4, 6, 8)))
    bz = ByzantineConfig(n_agents=N, f=CODED_F, aggregator=spec,
                         attack="large_value", remat=True, draco_r=CODED_R)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT, regime="parallel")
    sim = SimConfig(faults=(Churn(rate=0.25, mean_out=2.0),), seed=0)
    from repro_torch import kernels
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import train_loop
    before = snapshot()
    kernels.reset_launch_counts()
    _, hist = train_loop(small, bz, adamw(constant(1e-4)), ds,
                         steps=len(CHURN_LIVE), seed=0, device=DEVICE,
                         sim=sim, log_every=1, log_fn=lambda s: None)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    built = counter_delta(before)
    live = [h["n_live"] for h in hist]
    losses = [h["loss"] for h in hist]
    wall = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
    want = {k: (len(CHURN_LIVE) if k in CODED_KERNELS else 0)
            for k in SOURCES}
    emit("coded_train", loop="elastic", layers=CODED_ELASTIC_LAYERS,
         n_live=live, losses=losses, step_ms=step_ms, launches=counts,
         steps_built=built)
    if live != CHURN_LIVE:
        fail(f"churn trace changed: live {live}")
    if counts != want:
        fail(f"coded elastic: kernel launches {counts}, expected {want}")
    if built != {"async_step": 3, "train_step": 1}:
        fail(f"coded elastic: built {built}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"coded elastic: non-finite loss {losses}")
    return counts


def rules15_specs():
    """(label, spec, loop, the kernels of one step) of the seven rules
    without a kernel and the three row-transform wrappers (zeno on the
    async loop: it carries state)."""
    from repro_torch.core.aggregators import (bucketed, clipped, make_spec,
                                              staleness_discounted)
    out = [(r, make_spec(r, f=F, n=N), "sync", {})
           for r in ("phocas", "mean_around_median", "cgc",
                     "geometric_median", "rfa", "median_of_means")]
    out.append(("zeno", make_spec("zeno", f=F, n=N, ema=0.2), "async", {}))
    tm = make_spec("trimmed_mean", f=F, n=N)
    out += [
        ("clipped(trimmed_mean)", clipped(tm, tau=1.0), "sync",
         {"coord_stat": 1}),
        ("bucketed(krum)", bucketed(make_spec("krum", f=F, n=N)), "sync",
         {"gram": 1, "krum_select": 1, "weighted_sum": 1}),
        ("staleness_discounted(trimmed_mean)", staleness_discounted(tm),
         "sync", {"masked_coord_stat": 1})]
    return out


def rules15_aggregations(x):
    """Each spec of :func:`rules15_specs` on the real sign_flip arena ``x``
    (bf16, n = 8): ``aggregate_flat`` synchronous on the bf16 arena and
    masked on its fp32 copy (6 of 8 arrived, staleness discounts; bucketed
    refuses a mask), timed, with the peak device memory of the call
    (and its rise above what was allocated before); each output finite."""
    n, P = x.shape
    m = arrival_mask(6, n)
    w, _ = discount_weights(m)
    xf = x.float()
    rows = {}
    for label, spec, _, _ in rules15_specs():
        st = ({"server_grad": torch.mean(xf, dim=0)} if spec.stateful
              else None)
        for case, arena, kw in (("sync bf16", x, {}),
                                ("masked fp32 6/8", xf,
                                 {"mask": m > 0, "weights": w})):
            if case.startswith("masked") and spec.name == "bucketed":
                continue
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = spec.aggregate_flat(arena, state=st, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            finite = bool(torch.isfinite(out).all())
            del out
            ms = time_ms(lambda: spec.aggregate_flat(arena, state=st, **kw),
                         2)
            rows[f"{label}, {case}"] = ms
            emit("rules15_aggregation", spec=spec.describe(), case=case,
                 shape=[n, P], ms=ms, peak_gb=peak / 1e9,
                 rise_gb=(peak - base) / 1e9, finite=finite)
            if not finite:
                fail(f"{label} {case}: non-finite aggregate")
    del xf
    torch.cuda.empty_cache()
    return rows


# timed steps a spec of phase 3r (2 until phase 3p took their time)
RULES15_STEPS = 1


def phase_rules15_train(cfg):
    """Per spec of :func:`rules15_specs`: 1 warm-up and ``RULES15_STEPS``
    timed steps of the phase-3 configuration (zeno: under the phase-3b
    stragglers); the launch counts must show the spec's kernels a step
    and no other."""
    from repro_torch.training import ByzantineConfig
    totals = {k: 0 for k in SOURCES}
    step_ms_by = {}
    for label, spec, loop, per_step in rules15_specs():
        bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                             attack="sign_flip", remat=True)
        sim = straggler_sim() if loop == "async" else None
        if spec.staleness_aware:
            hist, counts, built, step_ms, peak = run_direct(
                cfg, bz, RULES15_STEPS)
        else:
            hist, counts, built, step_ms, peak = run_counted(
                cfg, bz, RULES15_STEPS, sim)
        losses = [h["loss"] for h in hist]
        want = {k: RULES15_STEPS * per_step.get(k, 0) for k in SOURCES}
        step_ms_by[label] = statistics.median(step_ms)
        emit("rules15_train", spec=spec.describe(), impl=spec.impl, loop=loop,
             steps=RULES15_STEPS, losses=losses, step_ms=step_ms,
             median_step_ms=step_ms_by[label], peak_mem_gb=peak,
             launches=counts, steps_built=built)
        if not all(math.isfinite(v) for v in losses):
            fail(f"{label}: non-finite loss {losses}")
        if counts != want:
            fail(f"{label}: kernel launches {counts}, expected {want}")
        for k, v in counts.items():
            totals[k] += v
    return totals, step_ms_by


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# selection telemetry, the flight recorder and checkpoints (ROADMAP.md items
# 19 and 19a)

TELEMETRY_STEPS = 1
# label -> (rule, hyper, trace, the selection chain the telemetry adds a
# step: the kernels that name the rows the aggregate used)
TELEMETRY_RUNS = {
    "krum": ("krum", {}, None, ("gram", "krum_select")),
    "multi_krum": ("multi_krum", {"m": 3}, None,
                   ("gram", "multi_krum_order")),
    "cge": ("cge", {}, None, ("gram", "cge_select")),
    "trimmed_mean": ("trimmed_mean", {}, None, ()),
    "async_krum": ("krum", {}, "stragglers",
                   ("weighted_sum", "masked_gram", "krum_select")),
    "churn": ("trimmed_mean", {}, "churn", ()),
}


def telemetry_checked(spec, checks):
    """A copy of ``spec`` whose synchronous ``selection_weights`` (the
    loop's telemetry, called right after ``aggregate_flat`` on the same
    arena) checks the weights against the aggregate: Krum's hot row, cast
    to fp32, equals the aggregate bitwise; multi-Krum's support is K9's
    first m picks.  The checks' own launches are taken back out of the
    counts; each result lands in ``checks``."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import AggregatorSpec
    last = {}

    class Checked(AggregatorSpec):
        def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                           scale=None):
            last["out"] = super().aggregate_flat(stack, mask, weights, state,
                                                 scale)
            return last["out"]

        def selection_weights(self, grads, mask=None, weights=None,
                              state=None):
            sel = super().selection_weights(grads, mask, weights, state)
            out = last.pop("out", None)
            if mask is None and weights is None:
                counts = kernels.launch_counts()
                if self.name == "krum":
                    hot = int(torch.argmax(sel))
                    checks.append(("hot_row_is_aggregate", torch.equal(
                        grads[hot].float(), out)))
                else:
                    m = self.hp("m", 2)
                    order = kernels.multi_krum_order(kernels.gram(grads),
                                                     self.f, m)
                    checks.append(("support_is_k9_picks",
                                   torch.equal(sel > 0, order < m)))
                for name, fn in kernels.WRAPPERS.items():
                    fn.launches = counts[name]
            return sel

    return Checked(**{f.name: getattr(spec, f.name)
                      for f in dataclasses.fields(spec)})


def telemetry_run(cfg, bz, sim, recorder=None, ckpt_dir=None):
    """``TELEMETRY_STEPS`` steps through ``train_loop`` from seed 0, the
    launch and build counts reset just before and read just after; ->
    (params, losses, step ms, peak GB, launches, builds)."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import train_loop

    ds = SyntheticLM(cfg.vocab_size, SEQ, bz.n_agents, PER_AGENT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = snapshot()
    kernels.reset_launch_counts()
    params, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                              steps=TELEMETRY_STEPS, seed=0, device=DEVICE,
                              sim=sim, log_every=1, log_fn=lambda s: None,
                              recorder=recorder, ckpt_dir=ckpt_dir)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    wall = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
    return (params, [h["loss"] for h in hist], step_ms,
            torch.cuda.max_memory_allocated() / 1e9, counts,
            counter_delta(before))


def telemetry_checkpoint(cfg, params, ckpt_dir):
    """The recorded krum run's checkpoint (written by the loop after its
    last step) restored into a like-tree: the parameters bitwise; then
    the same tree written again, timed, with its size."""
    import shutil

    from repro_torch.checkpoint import latest_step, restore, save
    from repro_torch.optim import adamw, constant
    from repro_torch.tree import tree_items

    like = {"params": params, "opt": adamw(constant(1e-4)).init(params)}
    t0 = time.perf_counter()
    tree, step = restore(ckpt_dir, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same_params = all(torch.equal(a, b.detach()) for (_, a), (_, b) in zip(
        tree_items(tree["params"]), tree_items(params)))
    t0 = time.perf_counter()
    path = save(ckpt_dir, step + 1, tree)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    ok = (same_params and step == TELEMETRY_STEPS
          and tree["opt"]["step"] == TELEMETRY_STEPS
          and latest_step(ckpt_dir) == step + 1)
    emit("telemetry_checkpoint", ok=ok, step=step, bytes=size,
         save_s=save_s, restore_s=restore_s, params_bitwise=same_params)
    shutil.rmtree(ckpt_dir)
    if not ok:
        fail(f"checkpoint of the recorded krum run: step {step}, params "
             f"bitwise {same_params}")


def telemetry_report(path):
    """The recorded krum run's trace: the report renders its tables, and
    its Chrome trace, written beside it, parses."""
    from repro_torch.obs.recorder import chrome_trace, read_trace
    from repro_torch.obs.report import render_report

    events = read_trace(path)
    text = render_report(events)
    chrome = path[:-len(".jsonl")] + ".json"
    with open(chrome, "w") as fh:
        json.dump(chrome_trace(events), fh)
    with open(chrome) as fh:
        spans = sum(e["ph"] == "X" for e in json.load(fh)["traceEvents"])
    ok = (spans == TELEMETRY_STEPS and "per-agent suspicion" in text
          and "rule=krum  impl=kernel" in text)
    emit("telemetry_report", ok=ok, events=len(events), chrome_spans=spans,
         report=text.splitlines()[:16])
    os.remove(chrome)
    os.remove(path)
    if not ok:
        fail(f"the recorded trace's report or Chrome trace: {text!r}")


def phase_telemetry(cfg):
    """Each run of ``TELEMETRY_RUNS`` (n = 8, f = 2, sign_flip) for
    ``TELEMETRY_STEPS`` steps from seed 0 without and with a Recorder
    (selection telemetry on), deterministic algorithms on for both: the
    parameters and losses bitwise equal; every step's sel_w summing to 1
    within 1e-6; the launches a step differing by the selection chain
    alone; the churn run within its build budget (<= one async step a
    bucket, <= one synchronous step); sync krum's hot row equal to its
    aggregate and multi_krum's support K9's first m picks
    (:func:`telemetry_checked`).  The recorded krum run also writes a
    full-width checkpoint (:func:`telemetry_checkpoint`) and a trace
    (:func:`telemetry_report`).  Returns the launches of all runs."""
    from repro_torch.core.aggregators import elastic, frac, make_spec
    from repro_torch.obs import Recorder
    from repro_torch.obs.telemetry import agent_series
    from repro_torch.simulator import Churn, SimConfig
    from repro_torch.training import ByzantineConfig
    from repro_torch.tree import tree_leaves

    totals = {k: 0 for k in SOURCES}
    scratch = os.path.join(HERE, "build", "smoke_telemetry")
    os.makedirs(scratch, exist_ok=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    for label, (rule, hyper, trace, chain) in TELEMETRY_RUNS.items():
        sim, spec = None, make_spec(rule, f=F, n=N, **hyper)
        if trace == "stragglers":
            sim = straggler_sim()
        elif trace == "churn":
            sim = SimConfig(faults=(Churn(rate=0.25, mean_out=2.0),),
                            seed=0)
            spec = make_spec(rule, f=frac(0.25), n=elastic(N, (4, 6, 8)))
        checks = []
        runs = {}
        for on in (False, True):
            rec = ckpt = None
            if on:
                rec = Recorder(os.path.join(scratch, f"{label}.jsonl")
                               if label == "krum" else None)
                ckpt = (os.path.join(scratch, "ckpt") if label == "krum"
                        else None)
            bz = ByzantineConfig(
                n_agents=N, f=F, attack="sign_flip", remat=True,
                aggregator=(telemetry_checked(spec, checks)
                            if on and rule in ("krum", "multi_krum")
                            and trace is None else spec))
            params, *rest = telemetry_run(cfg, bz, sim, rec, ckpt)
            if on:
                rec.close()
                p_on = params
            # the parameters wait on the host, out of the next run's peak
            runs[on] = ([leaf.detach().cpu() for leaf in tree_leaves(params)],
                        *rest)
            del params
        (h_off, l_off, ms_off, gb_off, c_off, b_off) = runs[False]
        (h_on, l_on, ms_on, gb_on, c_on, b_on) = runs[True]
        bitwise = all(torch.equal(a, b) for a, b in zip(h_off, h_on))
        sel = agent_series(rec.events)["sel_w"]
        sums = sel.sum(axis=1).tolist()
        want = {k: c_off[k] + (TELEMETRY_STEPS if k in chain else 0)
                for k in SOURCES}
        budget = (b_on.get("async_step", 0) <= 3
                  and b_on.get("train_step", 0) <= 1)
        ok = (bitwise and l_off == l_on and c_on == want and budget
              and len(sums) == TELEMETRY_STEPS
              and all(abs(s - 1.0) <= 1e-6 for s in sums)
              and all(c for _, c in checks)
              and len(checks) == (TELEMETRY_STEPS if rule in (
                  "krum", "multi_krum") and trace is None else 0))
        per_step = {s: {k: v / TELEMETRY_STEPS for k, v in c.items() if v}
                    for s, c in (("off", c_off), ("on", c_on))}
        emit("telemetry", run=label, rule=rule, trace=trace,
             steps=TELEMETRY_STEPS, ok=ok, params_bitwise=bitwise,
             losses=l_on, losses_equal=l_off == l_on,
             step_ms_off=ms_off, step_ms_on=ms_on,
             median_step_ms_off=statistics.median(ms_off),
             median_step_ms_on=statistics.median(ms_on),
             peak_gb_off=gb_off, peak_gb_on=gb_on,
             launches_per_step_off=per_step["off"],
             launches_per_step_on=per_step["on"], chain=list(chain),
             builds_on=b_on, sel_w_sums=sums,
             sel_w=[[round(w, 6) for w in row] for row in sel.tolist()],
             checks=checks)
        if not ok:
            fail(f"telemetry {label}: bitwise {bitwise}, losses {l_off} / "
                 f"{l_on}, launches {c_on} against {want}, builds {b_on}, "
                 f"sel_w sums {sums}, checks {checks}")
        if label == "krum":
            telemetry_checkpoint(cfg, p_on, os.path.join(scratch, "ckpt"))
            telemetry_report(rec.path)
        for c in (c_off, c_on):
            for k, v in c.items():
                totals[k] += v
        del p_on, runs
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return totals


# ---------------------------------------------------------------------------
# peer-to-peer DGD and the resilience estimators (ROADMAP.md item 21)

P2P_ROUNDS = 2
P2P_BIG = 50.0              # what the Byzantine agents 0 and 1 broadcast
# combine -> the kernels of one round: one masked aggregate a receiver
P2P_COMBINES = {
    "plain": (), "lf": (), "ce": (),
    "trimmed_mean": ("masked_coord_stat",),
    "krum": ("weighted_sum", "masked_gram", "krum_select",
             "masked_weighted_sum"),
    "sign_sgd": ("masked_sign_vote",)}
# the resilience estimators: rule -> the kernels of one trial (impl auto)
RESIL_N = 10
RESIL_ALPHA = {"krum": ("gram", "krum_select", "weighted_sum"),
               "coordinate_median": ("coord_stat",),
               "bulyan": ("gram", "iterative_order", "bulyan_coord"),
               "geometric_median": ()}
RESIL_DELTA = {"coordinate_median": ("coord_stat",), "mean": ()}
RESIL_ATTACKS = ("sign_flip", "alie", "ipm", "large_value")
RESIL_TRIALS, RESIL_WIDE_TRIALS = 24, 2


def p2p_combine(rule, impl="auto"):
    from repro_torch.core.aggregators import make_spec
    return rule if rule in ("plain", "lf", "ce") else make_spec(
        rule, f=F, n=N, impl=impl)


def p2p_timed(run):
    """One untimed warm-up round of ``run(steps)``, then ``P2P_ROUNDS``
    timed rounds with the launch counts reset just before and read just
    after: (trajectory, ms a round, peak GB, launches)."""
    from repro_torch import kernels
    run(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    traj = run(P2P_ROUNDS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / P2P_ROUNDS
    return (traj, ms, torch.cuda.max_memory_allocated() / 1e9,
            kernels.launch_counts())


def p2p_spec_impls(sent):
    """The two spec combines on the same broadcast states with
    impl="kernel" and impl="gather": the mixed states exact for krum
    (it selects) and within 3e-6 for the trimmed mean; each combine
    timed once (host clock, synchronized)."""
    from repro_torch.core.p2p import complete_graph, metropolis_weights
    from repro_torch.core.p2p.dgd import make_combine_spec
    adj = complete_graph(N)
    W = metropolis_weights(adj)
    for rule in ("trimmed_mean", "krum"):
        out, ms = {}, {}
        for impl in ("kernel", "gather"):
            comb = make_combine_spec(p2p_combine(rule, impl))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[impl] = comb(adj, W, sent, F)
            torch.cuda.synchronize()
            ms[impl] = 1e3 * (time.perf_counter() - t0)
        err = max_abs_err(out["kernel"], out["gather"])
        ok = (err == 0.0 if rule == "krum" else bool(torch.allclose(
            out["kernel"], out["gather"], rtol=TOL, atol=TOL)))
        ok = ok and bool(torch.isfinite(out["kernel"]).all())
        emit("p2p_vs_gather", combine=rule, n=N, d=sent.shape[1], ok=ok,
             max_abs_diff=err, combine_ms_kernel=ms["kernel"],
             combine_ms_gather=ms["gather"])
        del out
        torch.cuda.empty_cache()
        if not ok:
            fail(f"p2p {rule}: kernel combine differs from gather by {err}")


def p2p_schedule_run(x0, grad, byz, byz_fn):
    """The trimmed_mean combine on ring(8, 2) for 3 rounds under a
    partition over round 0, agent 7 crashed from round 1 and every
    broadcast of agent 3 dropped: each agent out of a round keeps its row
    bit for bit; the trajectory finite."""
    from repro_torch import kernels
    from repro_torch.core.p2p import p2p_dgd_run, ring_graph
    from repro_torch.simulator import (MessageDrop, Partition,
                                       PermanentCrash, compile_schedule)
    rounds = 3
    specs = (Partition(groups=((0, 1, 2, 3), (4, 5, 6, 7)), start=0, end=1),
             PermanentCrash(agents=(7,), at=1),
             MessageDrop(p=1.0, agents=(3,)))
    trace = compile_schedule(specs, N, rounds + 1, seed=0)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = p2p_dgd_run(ring_graph(N, 2), grad, x0, rounds, f=F,
                       combine=p2p_combine("trimmed_mean"), byz_mask=byz,
                       byz_fn=byz_fn, fault_schedule=trace, device=DEVICE)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / rounds
    counts = kernels.launch_counts()
    frozen = [(t, i) for t in range(rounds) for i in range(N)
              if not trace.alive[t, i]]
    kept = all(torch.equal(traj[t + 1, i], traj[t, i]) for t, i in frozen)
    finite = bool(torch.isfinite(traj).all())
    want = {k: (N * rounds if k == "masked_coord_stat" else 0)
            for k in SOURCES}
    ok = kept and finite and len(frozen) == 2 and counts == want
    emit("p2p_schedule", combine="trimmed_mean", graph="ring(8, 2)",
         rounds=rounds, ok=ok, frozen=frozen, frozen_rows_bitwise=kept,
         finite=finite, ms_per_round=ms,
         launches={k: v for k, v in counts.items() if v})
    del traj
    torch.cuda.empty_cache()
    if not ok:
        fail(f"p2p under the fault schedule: frozen {frozen} bitwise {kept},"
             f" finite {finite}, launches {counts}")
    return counts


def phase_p2p(P):
    """Phase 3p (a, b): full-width DGD (n = 8, f = 2, d = P, fp32) on the
    complete graph for each combine of ``P2P_COMBINES``: 1 warm-up round,
    then ``P2P_ROUNDS`` timed rounds; the launches a round must be one
    masked aggregate's kernels per receiver (none for plain / lf / ce);
    the honest agents' largest distance to the honest mean target is
    printed, and must be smaller under every robust combine than under
    plain.  Then the spec combines kernel against gather, and the faulted
    ring.  Returns the launches."""
    from repro_torch.core.p2p import complete_graph, p2p_dgd_run
    totals = {k: 0 for k in SOURCES}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    targets = 0.2 * torch.randn((N, P), generator=gen, device=DEVICE)
    hm = torch.mean(targets[F:], dim=0)
    x0 = torch.full((N, P), 2.0, device=DEVICE)
    byz = np.arange(N) < F

    def grad(i, x):
        return x - targets[i]

    def byz_fn(g, t, s):
        return torch.full_like(s, P2P_BIG)

    dist = {}
    for rule, names in P2P_COMBINES.items():
        def run(steps):
            return p2p_dgd_run(complete_graph(N), grad, x0, steps, f=F,
                               combine=p2p_combine(rule), byz_mask=byz,
                               byz_fn=byz_fn, device=DEVICE)
        traj, ms, peak, counts = p2p_timed(run)
        dist[rule] = float(torch.linalg.vector_norm(
            traj[-1, F:] - hm, dim=1).max())
        finite = bool(torch.isfinite(traj[-1]).all())
        want = {k: (N * P2P_ROUNDS if k in names else 0) for k in SOURCES}
        ok = finite and counts == want and (rule == "plain"
                                            or dist[rule] < dist["plain"])
        emit("p2p", combine=rule, n=N, f=F, d=P, rounds=P2P_ROUNDS, ok=ok,
             ms_per_round=ms, peak_gb=peak,
             launches_per_round={k: v / P2P_ROUNDS for k, v in
                                 counts.items() if v},
             honest_max_dist=dist[rule], finite=finite)
        if not ok:
            fail(f"p2p {rule}: finite {finite}, launches {counts} against "
                 f"{want}, distance {dist}")
        for k, v in counts.items():
            totals[k] += v
        if rule == "krum":
            sent = traj[-2].clone()
            sent[:F] = P2P_BIG
        del traj
        torch.cuda.empty_cache()
    p2p_spec_impls(sent)
    del sent
    for k, v in p2p_schedule_run(x0, grad, byz, byz_fn).items():
        totals[k] += v
    del targets, x0, hm
    torch.cuda.empty_cache()
    return totals


def resil_alpha_values(rule, impl, d, trials):
    """The per-trial <V, g> that ``estimate_alpha_f(rule, ...)`` reduces
    (the same generator stream, seed 0, sign_flip)."""
    from repro_torch.core import resilience as R
    from repro_torch.core.attacks import get_attack, make_byzantine_mask
    from repro_torch.core.aggregators import make_spec
    from repro_torch.device import make_generator
    gen = make_generator(0, DEVICE)
    g = torch.ones((d,), device=DEVICE) / torch.sqrt(
        torch.tensor(float(d), device=DEVICE))
    return R._alpha_trials(make_spec(rule, f=F, impl=impl),
                           get_attack("sign_flip"),
                           R._noise(gen, trials, RESIL_N, d),
                           make_byzantine_mask(RESIL_N, F, device=DEVICE), g,
                           0.2, gen)


def resil_delta_values(rule, impl):
    """The per-trial errors of each attack that ``estimate_delta_c``
    reduces (one generator, seed 0, running on across the attacks)."""
    from repro_torch.core import resilience as R
    from repro_torch.core.attacks import get_attack, make_byzantine_mask
    from repro_torch.core.aggregators import make_spec
    from repro_torch.device import make_generator
    gen = make_generator(0, DEVICE)
    spec = make_spec(rule, f=F, impl=impl)
    mask = make_byzantine_mask(RESIL_N, F, device=DEVICE)
    return np.concatenate([R._delta_trials(
        spec, get_attack(a), R._noise(gen, RESIL_TRIALS, RESIL_N, 32), mask,
        32, F, 1.0, gen) for a in RESIL_ATTACKS])


def resil_case(what, rule, d, trials, names, estimate, values):
    """One estimator on both impls (auto, then gather) from seed 0: the
    public estimator's result and its launches (auto: ``names`` once a
    trial and attack; gather: none), and its per-trial values within the
    fp32 bar of each other; at d = 32, ``ok`` of every alpha_f.  (At full
    width the honest noise, 0.2 sqrt(d) in norm against ||g|| = 1, is
    beyond what (alpha, f)-resilience covers: ``ok`` is printed only.)"""
    from repro_torch import kernels
    res, vals, counts = {}, {}, {}
    t0 = time.perf_counter()
    for impl in ("auto", "gather"):
        kernels.reset_launch_counts()
        res[impl] = estimate(impl)
        counts[impl] = kernels.launch_counts()
        vals[impl] = values(impl)
    seconds = time.perf_counter() - t0
    reps = trials * (len(RESIL_ATTACKS) if what == "delta_c" else 1)
    want = {k: (reps if k in names else 0) for k in SOURCES}
    err = float(np.max(np.abs(vals["auto"] - vals["gather"])))
    close = bool(np.allclose(vals["auto"], vals["gather"], rtol=TOL,
                             atol=TOL))
    ok = (close and counts["auto"] == want
          and not any(counts["gather"].values())
          and (what == "delta_c" or d != 32 or res["auto"][1]))
    emit("resilience", estimator=what, rule=rule, n=RESIL_N, f=F, d=d,
         trials=trials, ok=ok, result_auto=res["auto"],
         result_gather=res["gather"], per_trial_max_abs_diff=err,
         launches_auto={k: v for k, v in counts["auto"].items() if v},
         seconds=seconds)
    if not ok:
        fail(f"resilience {what} {rule} d={d}: values within bar {close} "
             f"({err}), launches {counts}, result {res}")
    return counts["auto"]


def phase_resilience(P):
    """Phase 3p (c): ``estimate_alpha_f`` (sign_flip) for krum,
    coordinate_median, bulyan and geometric_median and ``estimate_delta_c``
    (four attacks) for coordinate_median and mean at n = 10, f = 2, d = 32,
    24 trials (JAX's tests' settings), each on impl auto and gather
    (:func:`resil_case`); then krum and coordinate_median through
    ``estimate_alpha_f`` at d = P with 2 trials.  Returns the launches."""
    from repro_torch.core.resilience import estimate_alpha_f, estimate_delta_c
    totals = {k: 0 for k in SOURCES}
    cases = [("alpha_f", r, 32, RESIL_TRIALS, names)
             for r, names in RESIL_ALPHA.items()]
    cases += [("delta_c", r, 32, RESIL_TRIALS, names)
              for r, names in RESIL_DELTA.items()]
    cases += [("alpha_f", r, P, RESIL_WIDE_TRIALS, RESIL_ALPHA[r])
              for r in ("krum", "coordinate_median")]
    for what, rule, d, trials, names in cases:
        if what == "alpha_f":
            def estimate(impl):
                return estimate_alpha_f(rule, n=RESIL_N, f=F, d=d,
                                        trials=trials, device=DEVICE,
                                        impl=impl)

            def values(impl):
                return resil_alpha_values(rule, impl, d, trials)
        else:
            def estimate(impl):
                return estimate_delta_c(rule, n=RESIL_N, f=F, d=d,
                                        trials=trials, device=DEVICE,
                                        impl=impl)

            def values(impl):
                return resil_delta_values(rule, impl)
        counts = resil_case(what, rule, d, trials, names, estimate, values)
        for k, v in counts.items():
            totals[k] += v
        torch.cuda.empty_cache()
    return totals


def phase_p2p_resilience(num_params):
    """Phase 3p: :func:`phase_p2p`, then :func:`phase_resilience`, with
    the phase's seconds on a line of its own."""
    t0 = time.perf_counter()
    totals = phase_p2p(num_params)
    t1 = time.perf_counter()
    for k, v in phase_resilience(num_params).items():
        totals[k] += v
    emit("p2p_resilience_phase", p2p_s=t1 - t0,
         resilience_s=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0)
    return totals


# ---------------------------------------------------------------------------
# the text families (ROADMAP.md item 22a): no kernel of their own; their
# models feed the existing kernels a new arena

FAM_ARCH = "mamba2-130m"
FAM_SEQ, FAM_PER_AGENT = 512, 1     # two SSD chunks of 256, one sequence
FAM_STEPS = 1
FAM_SMOKE_ARCHS = ("mixtral-8x22b", "llama4-scout-17b-a16e", "zamba2-7b",
                   "h2o-danube-3-4b")
FAM_SMOKE_SEQ = 80                  # past the reduced window of 64
FAM_SMOKE_RULES = ("trimmed_mean", "krum")
# the ranges of a traced mamba2 step: the module functions the smoke wraps
# in a profiler range while it traces (module, attribute, range name)
FAM_RANGES = (("repro_torch.models.ssm", "ssd_chunked", "ssd"),
              ("repro_torch.models.ssm", "mamba_block", "mamba_block"))
MATMUL_OPS = ("aten::matmul", "aten::mm", "aten::bmm", "aten::addmm",
              "aten::linear", "aten::einsum")
BACKWARD = "autograd::engine::evaluate_function"


def family_arena_size(cfg):
    """(the arena's P from the port's own tree, num_params): JAX's closed
    form leaves out the SSM's conv biases (ROADMAP.md R3)."""
    from repro_torch.configs import num_params
    from repro_torch.core.flat import FlatPlan
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    params = init_params(cfg, make_generator(0, DEVICE))
    P = FlatPlan.for_proto(params).total
    del params
    torch.cuda.empty_cache()
    return P, num_params(cfg)


def op_category(e, seq_cat):
    """The category of a traced op ``e`` from its ancestors: the SSD scan
    (``ssd``), the Mamba2 block's matmuls outside it (``projections``) and
    its other ops (``block_rest``: conv, gates, norm), ``aggregate``; an
    op inside a backward node takes the category of the forward op the
    node differentiates (``seq_cat``, by forward thread and sequence
    number); None for the rest."""
    mm = False
    while e is not None:
        mm = mm or e.name in MATMUL_OPS
        if e.name in ("ssd", "aggregate"):
            return e.name
        if e.name == "mamba_block":
            return "projections" if mm else "block_rest"
        if e.name.startswith(BACKWARD):
            return seq_cat.get((e.fwd_thread, e.sequence_nr))
        e = e.cpu_parent
    return None


def split_device_ms(prof):
    """Device ms of a CPU + CUDA trace by :func:`op_category` of the CPU
    op each kernel is linked to (the profiler links a kernel to the one
    op that launched it, so none counts twice), and the port's own
    kernels, which no torch op launches, to ``aggregate``; ``other``
    holds the rest (embedding, head and loss, the residual norms)."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CPU and not e.is_async]
    seq_cat = {}
    for e in evs:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD):
            cat = op_category(e, {})
            if cat is not None:
                seq_cat.setdefault((e.thread, e.sequence_nr), cat)
    out = dict.fromkeys(("ssd", "projections", "block_rest", "aggregate",
                         "other"), 0.0)
    for e in evs:
        own = sum(k.duration for k in e.kernels)
        if own:
            out[op_category(e, seq_cat) or "other"] += own / 1e3
    out["aggregate"] += sum((e - s) / 1e3 for name, s, e in device_events(prof)
                            if any(k in name for k in OUR_KERNELS))
    return out


@contextlib.contextmanager
def ranged(spec_cls):
    """While entered: each module function of ``FAM_RANGES`` runs inside a
    profiler range of its name, and ``spec_cls.aggregate_flat`` inside
    ``aggregate``."""
    import importlib

    from torch.profiler import record_function

    def wrap(fn, name):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    targets = [(importlib.import_module(mod), attr, name)
               for mod, attr, name in FAM_RANGES]
    targets.append((spec_cls, "aggregate_flat", "aggregate"))
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _ in targets]
    for (owner, attr, name), (_, _, fn) in zip(targets, saved):
        setattr(owner, attr, wrap(fn, name))
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def family_profile(cfg, rule="trimmed_mean"):
    """A traced full-width step of ``rule`` on ``cfg`` (seed 2, after a
    warm-up step and an untraced step on the host clock; device activity
    only): device busy and idle share.  Then, to split that time by part
    without reading a whole step's CPU trace (~10^5 events), a CPU + CUDA
    trace of one agent's loss and gradient (remat on) and of the step's
    aggregation on an (n, P) fp32 arena: the device ms of the SSD scan,
    the block's projections, the rest of the block, the rest of the
    model (:func:`split_device_ms`) and the aggregation; the model parts
    times n estimate the step's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import make_spec
    from repro_torch.core.flat import FlatPlan
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step
    from repro_torch.tree import tree_leaves

    gen = make_generator(2, DEVICE)
    params = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, FAM_SEQ, N, FAM_PER_AGENT)
    opt = adamw(constant(1e-4))
    spec = make_spec(rule, f=F, n=N)
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                         attack="sign_flip", remat=True)
    step = make_train_step(cfg, bz, opt, device=DEVICE)
    state = opt.init(params)
    batch = ds.batch(ds.draw_starts(gen))
    step(params, state, None, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, state, None, batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, None, batch)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    busy, span, by_name = device_busy(prof)
    ours = sum(t for k, t in by_name.items()
               if any(name in k for name in OUR_KERNELS))
    top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
    del prof, state

    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
    arena = torch.randn((N, FlatPlan.for_proto(params).total),
                        generator=gen, device=DEVICE)
    agent = {k: v[0] for k, v in batch.items()}
    t0 = time.perf_counter()
    with ranged(type(spec)), profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as prof:
        loss = loss_fn(cfg, params, agent, remat=True)
        torch.autograd.grad(loss, leaves)
        spec.aggregate_flat(arena)
        torch.cuda.synchronize()
    split = split_device_ms(prof)
    split_busy, _, _ = device_busy(prof)
    seen = busy > 0
    model = {k: split[k] for k in ("ssd", "projections", "block_rest",
                                   "other")}
    emit("families_profile", arch=cfg.name, rule=rule, step_ms=wall_ms,
         traced_step_ms=traced_ms,
         device_busy_ms=busy if seen else "not measured",
         device_span_ms=span if seen else "not measured",
         device_idle_share=(1 - busy / wall_ms) if seen else "not measured",
         aggregation_kernels_ms=ours if seen else "not measured",
         peak_mem_gb=peak / 1e9,
         top_device_events_ms=[[k[:60], t] for k, t in top],
         agent_pass_device_ms=model if seen else "not measured",
         aggregate_device_ms=split["aggregate"] if seen else "not measured",
         split_trace_busy_ms=split_busy if seen else "not measured",
         step_estimate_device_ms=({k: N * v for k, v in model.items()}
                                  if seen else "not measured"),
         split_trace_s=time.perf_counter() - t0)
    del params, arena, prof
    torch.cuda.empty_cache()


@contextlib.contextmanager
def routing_log(on):
    """While entered and ``on``: each MoE dispatch (``moe.route``) appends
    its (keep, r2) to the yielded list."""
    from repro_torch.models import moe
    log, real = [], moe.route

    def recording(*a, **kw):
        out = real(*a, **kw)
        log.append((out[3].detach(), out[4].detach()))
        return out

    if on:
        moe.route = recording
    try:
        yield log
    finally:
        moe.route = real


def against_gather(rule, stack, out):
    """(max |out - gather|, whether it passes): ``rule``'s kernel
    aggregate ``out`` of the arena ``stack`` against impl="gather" on the
    same arena: median and krum exact, trimmed mean within 3e-6."""
    from repro_torch.core.aggregators import make_spec
    ref = make_spec(rule, f=F, impl="gather",
                    n=stack.shape[0]).aggregate_flat(stack)
    err = max_abs_err(out, ref)
    close = err == 0.0 if rule in EXACT_RULES else bool(torch.allclose(
        out, ref, rtol=TOL, atol=TOL))
    return err, close


def family_pairs(cfg, rules, seq, seed, routing=False):
    """Per rule: one synchronous step with impl="kernel" from seed
    ``seed``'s parameters and batch (n = 8, f = 2, sign_flip, remat on,
    one sequence of ``seq`` tokens an agent), its launches held to the
    rule's kernels and its loss finite; then the rule with impl="gather"
    on that step's arena (:func:`against_gather`).  With ``routing`` the
    line adds the MoE calls' drops and R2 flags (every forward runs twice
    under remat: the pass, then its recomputation in the backward).  The
    step is the configuration's drive of the main path: returns its
    launches."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    gen = make_generator(seed, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, seq, N, 1)
    batch = ds.batch(ds.draw_starts(gen))
    totals = {k: 0 for k in SOURCES}
    for rule in rules:
        store = {}
        spec = recorded(make_spec(rule, f=F, impl="kernel", n=N), store)
        bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                             attack="sign_flip", remat=True)
        opt = adamw(constant(1e-4))
        step = make_train_step(cfg, bz, opt, device=DEVICE)
        params = _clone(base)
        kernels.reset_launch_counts()
        with routing_log(routing) as log:
            _, _, _, met = step(params, opt.init(params), None, batch)
            counts = kernels.launch_counts()
        stack, _, _, out, _ = store.pop("kernel")
        err, close = against_gather(rule, stack, out)
        want = {k: (1 if k in RULE_KERNELS[rule] else 0) for k in SOURCES}
        loss = float(met["loss"])
        extra = {}
        if log:
            drops = [int(torch.sum(~keep)) for keep, _ in log]
            extra = dict(moe_calls=len(log), dropped_total=sum(drops),
                         dropped_max=max(drops),
                         calls_with_drops=sum(d > 0 for d in drops),
                         r2_calls=sum(bool(r2) for _, r2 in log))
        ok = close and counts == want and math.isfinite(loss)
        emit("families_vs_gather", arch=cfg.name, rule=rule, seq=seq, ok=ok,
             loss=loss, arena_dtype=str(stack.dtype), max_abs_diff=err,
             launches={k: v for k, v in counts.items() if v}, **extra)
        if not ok:
            fail(f"{cfg.name} {rule}: loss {loss}, launches {counts} "
                 f"against {want}, kernel against gather {err}")
        for k, v in counts.items():
            totals[k] += v
        del params, stack, out
    del base
    torch.cuda.empty_cache()
    return totals


def phase_families():
    """Phase 3f (ROADMAP.md item 22a).  (a) mamba2-130m at full width (bf16
    with its fp32 SSM leaves, so an fp32 (8, P) arena; n = 8, f = 2,
    sign_flip, seq 512, one sequence an agent, remat on): trimmed_mean,
    coordinate_median and krum through ``train_loop`` (1 warm-up step
    whose arena the gather impl aggregates again, 1 timed step, one K1 or
    one each of K2 K3 K4 a step), one async trimmed_mean step under the
    phase-3b stragglers (one K5) and a traced trimmed_mean step split by
    part (:func:`family_profile`).  (b) the -smoke reductions of
    mixtral-8x22b, llama4-scout-17b-a16e, zamba2-7b and h2o-danube-3-4b
    in their own dtypes at seq 80: one trimmed_mean and one krum step
    each, on the kernel impl against the gather impl
    (:func:`family_pairs`), the MoE lines with their drops and R2.  The
    phase's seconds on a line of its own.  Returns the launches of the
    main-path runs: the timed steps of (a) and the steps of (b), which
    are those configurations' only drive (warm-up steps count nowhere in
    the smoke)."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(FAM_ARCH)
    P, closed = family_arena_size(cfg)
    emit("families_config", arch=cfg.name, arena_P=P, num_params=closed,
         conv_bias_values=P - closed, dtype=cfg.dtype, seq=FAM_SEQ,
         per_agent=FAM_PER_AGENT, ssm_chunk=cfg.ssm_chunk)
    totals = phase_train(cfg, {r: (N, {}, RULE_KERNELS[r]) for r in RULES},
                         FAM_STEPS, seq=FAM_SEQ, per_agent=FAM_PER_AGENT,
                         phase="families_train",
                         vs_gather="families_vs_gather")
    a_totals, _ = phase_async(
        cfg, {"trimmed_mean": ASYNC_RULES["trimmed_mean"]}, FAM_STEPS,
        seq=FAM_SEQ, per_agent=FAM_PER_AGENT, phase="families_async")
    family_profile(cfg)
    t1 = time.perf_counter()
    for arch in FAM_SMOKE_ARCHS:
        scfg = get_config(arch + "-smoke")
        counts = family_pairs(scfg, FAM_SMOKE_RULES, FAM_SMOKE_SEQ, 7,
                              routing=scfg.family == "moe")
        for k, v in counts.items():
            a_totals[k] += v
    for k, v in a_totals.items():
        totals[k] += v
    emit("families_phase", mamba2_s=t1 - t0,
         smoke_s=time.perf_counter() - t1,
         seconds=time.perf_counter() - t0)
    return totals


def main():
    # deterministic cuBLAS for the kernel-vs-gather phase: set before the
    # first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.configs import get_config, num_params
    except ImportError as e:
        fail(f"cannot import repro_torch from {HERE}/src: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    card = phase_device()
    cfg = get_config("paper-100m")
    summary, _ = kernel_checks(num_params(cfg))
    summary.update(masked_kernel_checks(num_params(cfg)))
    for errs in (gram_sweep_checks(), gram_width_checks()):
        for name, err in errs.items():
            note(summary, name, err)
    summary.update(selection_kernel_checks(num_params(cfg)))
    cge_select_drive(num_params(cfg))
    for name, err in select_sweep_checks().items():
        note(summary, name, err)
    floor_ms = launch_floor(summary)
    summary.update(masked_selection_kernel_checks(num_params(cfg)))
    for name, err in bulyan_sweep_checks().items():
        note(summary, name, err)
    summary.update(scaled_kernel_checks(num_params(cfg)))
    scaled_sweep_checks()
    scaled_capacity_timings(num_params(cfg))
    note(summary, "coord_stat", order_sweep_checks())
    order_capacity_timings(num_params(cfg))
    arena = real_arena(cfg)
    note(summary, "coord_stat", coord_stat_arena_checks(arena))
    summary.update(sparse_kernel_checks(arena))
    sparse_sweep_checks()
    vote_arena_checks(arena)
    vote_sweep_checks()
    sort_summary, sort_counts = sort_checks(arena)
    summary.update(sort_summary)
    rules15_aggregations(arena)
    del arena
    torch.cuda.empty_cache()
    summary.update(cclip_kernel_checks(num_params(cfg)))
    sync_rules = {**{r: (N, {}, RULE_KERNELS[r]) for r in RULES},
                  **SIGN_RULES}
    totals = phase_train(cfg, sync_rules, STEPS)
    check_straggler_traces()
    async_totals, async_step_ms = phase_async(cfg, ASYNC_RULES, ASYNC_STEPS)
    elastic_totals = phase_async_elastic(cfg)
    sel_totals = phase_train(cfg, SEL_RULES, SEL_STEPS)
    asel_totals, asel_step_ms = phase_async(cfg, ASYNC_SEL_RULES,
                                            ASYNC_SEL_STEPS)
    quant_totals = [phase_train(cfg, QUANT_RULES, QUANT_STEPS, agg_dtype=q)
                    for q in QUANT]
    aquant_totals, aquant_step_ms = phase_async(
        cfg, ASYNC_QUANT_RULES, QUANT_STEPS, agg_dtype="int8")
    sparse_totals = [phase_train(cfg, SPARSE_SYNC, STEPS)]
    asparse_totals, asparse_step_ms = phase_async(cfg, SPARSE_ASYNC,
                                                  ASYNC_STEPS)
    sparse_totals += [phase_train(cfg, SPARSE_QUANT, QUANT_STEPS,
                                  agg_dtype=q) for q in QUANT]
    asq_totals, asq_step_ms = phase_async(cfg, SPARSE_AQUANT, QUANT_STEPS,
                                          agg_dtype="int8")
    sparse_totals += [asparse_totals, asq_totals, sort_counts]
    memory_totals, memory_step_ms = phase_memory(cfg)
    rules15_totals, rules15_step_ms = phase_rules15_train(cfg)
    coded_totals, coded_errs = phase_coded_sync(cfg)
    for name, (err, _) in coded_errs.items():
        note(summary, name, err)
    coded_totals = [coded_totals, phase_coded_async(cfg),
                    phase_coded_elastic(cfg)]
    tel_totals = phase_telemetry(cfg)
    p2p_totals = phase_p2p_resilience(num_params(cfg))
    fam_totals = phase_families()
    # m_krum and mda run no kernel that multi_krum's and bulyan's traced
    # steps leave out (K2, K10, K11), so they are not traced
    phase_profile(cfg, {"trimmed_mean": (N, {}, ()), "krum": (N, {}, ()),
                        **{r: SEL_RULES[r] for r in ("cge", "multi_krum",
                                                     "bulyan")},
                        "sparse_mean": (N, {}, ())})
    phase_profile_async(cfg, {**{r: (N, 6, {}) for r in RULES},
                              "multi_krum": (N, 6, {"m": 3}),
                              "sparse_mean": (N, 6, {}),
                              "bulyan": (11, 9, {})})
    phase_kernel_vs_gather(cfg, sync_rules)
    phase_selection_vs_gather(cfg)
    phase_tie_check(cfg)
    phase_masked_vs_gather(cfg, {**ASYNC_RULES, **ASYNC_SEL_RULES})
    phase_quant_vs_gather(cfg)
    phase_sparse_vs_gather(cfg)
    memory_stage_ms = memory_profile(cfg)
    phase_memory_vs_gather(cfg)
    kern = []
    for name, (src, replaces) in SOURCES.items():
        s = summary[name]
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": (totals[name] + async_totals[name]
                                  + elastic_totals[name] + sel_totals[name]
                                  + asel_totals[name]
                                  + sum(t[name] for t in quant_totals)
                                  + aquant_totals[name]
                                  + sum(t[name] for t in sparse_totals)
                                  + memory_totals[name]
                                  + rules15_totals[name]
                                  + sum(t[name] for t in coded_totals)
                                  + tel_totals[name]
                                  + p2p_totals[name]
                                  + fam_totals[name]),
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"],
                     "library_ms": s["library_ms"]})
    from repro_torch.kernels import build
    emit("done", seconds=round(time.time() - t0, 1),
         kernel_build_s=round(build.BUILD_INFO.get("seconds", 0.0), 1),
         imputed_mean=summary["imputed_mean"],
         async_median_step_ms=async_step_ms,
         async_selection_median_step_ms=asel_step_ms,
         async_quant_median_step_ms=aquant_step_ms,
         async_sparse_median_step_ms={"float32": asparse_step_ms,
                                      "int8": asq_step_ms},
         sign_vote_on_codes=summary["sign_vote_codes"],
         memory_median_step_ms=memory_step_ms,
         centered_clip_stages=memory_stage_ms, launch_floor_ms=floor_ms,
         rules15_median_step_ms=rules15_step_ms,
         coded_decode={k: {"max_abs_err": e, "ms": kw["kernel_ms"],
                           "plain_ms": kw["plain_ms"],
                           "bound_ms": kw["bound_ms"]}
                       for k, (e, kw) in coded_errs.items()})
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
