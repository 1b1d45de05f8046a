#!/usr/bin/env python3
"""Drive the PyTorch port (``ddqst_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line is printed; nothing falls back to the CPU):

1. build  — compile ``ddqst_tpu_torch/csrc/chain_walk.cu``,
   ``chain_step.cu`` and the measuring tools ``int_rate.cu`` and
   ``walk_ablation.cu`` with nvcc for sm_90a, and the host statevector
   engine ``statevec.cc`` with g++, from the sources in this checkout, all
   at once, and print the build times and the compiler's register /
   shared-memory report;
   rate   — measure the lane instructions a second the card issues for
   integer multiply-add, wide multiply-add, three-input logic, add, float32
   FMA and a multiply/logic mix (``int_rate.cu``), and hold them against
   the documented integer rate the bounds use; disassemble the built
   libraries with ``cuobjdump -sass`` and count, by pipe, the instructions
   one chain and step issues in each kernel (the walk's staged body at N=3
   and N=7, its ring body at N=10, its gather body at N=12, and the
   variants of ``walk_ablation.cu``, whose mode 2 is the plain global body
   the walk once took from N = 8 on);
   ablation — time the variants of that plain global body at the shadow
   shape at N = 10 and N = 12 (Philox and bits alone; loads without
   conversions; the body as it stands, which must equal the plain version;
   8-byte loads; 16-byte loads; loads and conversions without Philox; at
   N = 12 also 16-byte loads alone and with an L2 prefetch of the next
   step's slice), in turns, beside the wrapper (the ring body at N = 10,
   the gather body at 12) and the bound, then at N = 12 the lockstep
   variants (chains a thread, block size, a barrier a step, the prefetch,
   shared memory reserved and the L1 carveout), each equal to the plain
   version;
2. kernel — hold the CUDA ``fused_chain_walk`` against its plain PyTorch
   version on the card, bit for bit, at the main-path shape (T=100, C=27,
   N=3, S=5,000), at a ragged S (1,237), at N=7 (2^N = 128), at N = 1, 5
   and 6 (with N=3 and N=7 the staged body's three ways of staging its
   tables) and at the notebook presets' shape (T=100, C=3, N=1, S=1,024),
   each at every block size; then from N = 8 on at the shadow route's shape
   (T=100, C=100, N=10, S=5,000), at a ragged S there, at N = 8, 9 and 11,
   at the ring body's tails (T = 7, 3 and 1 at N = 8 and 10, T = 5 at
   N = 11), at N = 12 to 16 with a ragged S, an odd T and T = 1 at
   each N (S >= 2^N at N = 12 and 13), and at the shadow bench's shape
   (T=100, C=50, N=10, S=2,000): the plan's body (the ring body up to
   N = 11, the gather body from 12) at every block size and on tables 4
   bytes (from N = 12 also 8 bytes) off 16-byte alignment;
   check that the same seed repeats; check the walk's
   distribution against the exact propagation of its tables (TV within 4
   shot-noise scales) at N = 3, 7 and 10; time kernel and plain version
   with CUDA events at 135,000 and at 27 x 37,037 (about 10^6) chains, at
   N=7, at the shadow shape and the shadow bench's, at one call of the
   chunked sampler at N = 8
   (3^8 rows x 319 chains, 5.4 GB of tables), at the shadow shape with
   N = 11 and 12 and at 5,000 chains a row with N = 13 to 16 (50, 25, 12
   and 6 rows), the kernel also at other block sizes;
3. main path — ``run_experiment(get_preset("rqc"), seed=0)`` at full width
   on the default (CUDA) device, with the kernel's launch count set to 0
   just before and read just after; print each stage's time and the
   metrics; check that ρ is a trace-1 Hermitian PSD matrix, that the
   generated samples follow the exact chain distribution of the trained
   model's own tables, that the fidelity agrees with the inversion of that
   exact distribution, and that the tables on the card match the CPU's;
   the step kernel must not run here;
4. step   — hold the CUDA ``fused_chain_step`` against its plain version,
   bit for bit, at the circuit-conditioned evaluation shape (table
   [10,800, 3], 6,750,000 chains), at a ragged 1,237 chains on [216, 3]
   and at N=7 ([279,936, 7], 10^6 chains and 999,999, not a multiple of
   4), each also in the ``row_base`` form (the chain state and a per-chain
   row offset, as ``p_sample_grid`` calls it) and at N=11 (the runtime-N
   body); check that a rerun repeats and another step differs; check one
   row's histogram against the product Bernoulli at N=3 and N=7; time
   kernel and plain version, the kernel in both forms and on rows laid out
   as the route lays them out; then run
   ``sample_all_bases`` at 200 shots (the 'seq' walk), which must launch
   the step kernel once per step;
5. route  — the phase-4 dataset route on the card at the ``rqc`` width with
   circuit conditioning: ``build_dataset_chunked`` (50 circuits, two
   shards; a second call adds none), ``train_on_dataset`` (1 epoch), then
   ``evaluate_dataset(circuit_conditioned=True)`` with the launch counts
   set to 0 just before and read just after (100 step launches, no walk);
   time ``p_sample_grid``'s T chain updates on the route's inputs (ms per
   step on the path, beside the kernel's own ms); check every (circuit, basis) row of the samples against the exact
   propagation of the model's own tables, the D3PM fidelities against the
   exact-chain inversion, the raw fidelities against the CPU's inversion,
   and every ρ for trace 1, Hermiticity and PSD.
6. generate — ``cli generate`` at its defaults (``GENERATE_*``: 10,000
   circuits of N=3, depths 2-10, 1,024 shots, 20 shards of 500, all 27
   bases), in this process through ``cli.main``, under torino noise (the
   engine computes the clean states, density matrices the counts) and under
   readout noise (the engine computes every statevector); each build's
   wall time and its stages' seconds and calls, the engine's calls (one a
   chunk, two under readout noise); then the torino build once more as
   ``python -m ddqst_tpu_torch.cli generate``, which must add no shard.
   Checks: ids 0-9,999, unique hashes, depths 2-10, every count row sums to
   1,024; the seed's 10,000 circuits are the records'; every clean state
   is the engine's, bit for bit, and within 2e-6 of the numpy path, norms
   within 1e-5; on 500 circuits spread over the 20 shards, every (circuit,
   basis) row of counts within 4 shot-noise scales (TV) of its exact Born
   probabilities after readout (the port's numpy path). It times
   ``states.batch_statevectors`` on the 10,000 circuits with
   ``prefer_native`` True and False in turns (True, False, False, True) and
   prints the engine's figures as one JSON line ``native_host_code``.

7. distill — the bench recipe on the card at full width, through
   ``run_experiment``: GHZ-3 (renoise sampler, readout noise, readout
   mitigation of reconstruction and training data, MLE reconstruction,
   exact-chain distillation with a 15% held-out split, 5,000 training and
   50,000 generated shots per basis), then RQC-3 (20,000 training shots,
   distilled against the Born probabilities of the counts' MLE). Width, T,
   bases, shots, split, learning rates and patience are the recipe's; the
   depth is cut (``DISTILL_DEPTH``: epochs and distillation steps) and each
   cut is printed. Before: ``chain_distribution`` of a seeded full-width
   model equals the exact propagation of its tables within 1e-5. Per
   recipe, with the launch counts set to 0 just before and read just after:
   one walk launch and no step launch; the chain CE fell and the held-out
   best is no worse than step 0; the distilled model's chain distribution
   equals the propagation of its tables; the samples follow it (TV within
   4 shot-noise scales per basis) and the fidelity is within 0.02 of the
   MLE of that distribution; ρ is a state; GHZ-3's MLE on the raw shots
   scores at least 0.995. It prints the fidelities beside the reference's,
   the stage seconds, the ms per distillation step and the MLE solves'
   iterations and seconds.

7b. bench — the port's bench (``ddqst_tpu_torch.bench``, the counterpart
   of ``bench.py``) at ``bench.py``'s full sizes: training steps/s at the
   ``rqc`` width (40 steps an epoch, a warm epoch, 3 repeats of 5 epochs),
   ``sample_all_bases`` at 27 x 5,000 chains and, with the CUDA walk
   demanded, at 27 x 37,037, and the ``shadow_transformer`` model's table
   sampler at 50 bases x 2,000 shots (N=10), each with the launch counts
   set to 0 just before and read just after: one walk launch and no step
   launch a call of each sampler (the ring body at N=10), every throughput
   finite and positive. Its quality keys come from phase distill's runs at
   their cut depth (printed as a cut). It prints the record on one line,
   ``{"bench_record": ...}``.
8. chunked — ``sample_all_bases_chunked`` (``gen_tables_once``) on phase
   3's trained ``rqc`` model: 200,000 shots a basis, the tables once, then
   3 walk launches of at most 2^21 chains (counts set to 0 just before,
   read just after), the samples against the exact chain distribution of
   the model's tables (TV within 4 shot-noise scales per basis).
9. shadow — ``run_experiment(get_preset("shadow_transformer"), seed=0)`` at
   full width (N=10, 100 sampled bases, 1,024 training and 5,000 generated
   shots a basis, transformer 128 / 512 / 4 blocks / 4 heads, T=100,
   renoise), CE training cut to ``SHADOW_EPOCHS_CUT`` of 30 epochs, on the
   card, with the launch counts set to 0
   just before and read just after: one walk launch (the tables over the
   102,400-row label grid, then one walk of 500,000 chains), no step
   launch. It prints the stage seconds and the quality metrics beside the
   reference's N=10 rows, checks every basis' samples against the exact
   chain distribution of the tables the walk read (TV within 4 shot-noise
   scales) and a few of their rows against a CPU recompute (1e-5); then a
   warm-started run (``params_load`` of the first run's ``params_save``)
   with ``SHADOW_DISTILL_STEPS`` distillation step over a minibatch of 10
   bases and no held-out split, printing ms a step and the chain CE before
   and after.
9b. reference_shadow — the port's shadow route at full width on the
   reference's own model, data and recipe: ``run_experiment`` of
   ``reference_shadow_cfg()`` (``scripts/run_shadow_scale.py``'s
   ``make_cfg("dist_seg", max_bases=300)`` written out: N=10, 300 sampled
   bases, 5,000 generated shots a basis, the transformer 128 / 512 / 4
   blocks / 4 heads, T=100, cosine, renoise) with ``params_load`` of the
   reference's 150-epoch CE snapshot (``REFERENCE_SHADOW_PARAMS``,
   converted by ``tools/flax_to_torch.py``) and ``data_cache`` a temporary
   copy of its data (``REFERENCE_SHADOW_DATA``), with the launch counts set
   to 0 just before and read just after. Checks: (a) one walk launch (the
   ring body, 300 x 5,000 chains, 1.23 GB of tables) and no step launch;
   (b) the shot-noise floor and the measured-data TV, which depend on the
   data alone, round to the reference's (``examples/results_shadow.jsonl``
   row 11) at 5 decimals; (c) every basis' samples within 4 shot-noise
   scales (TV) of the exact chain of the tables the walk read; (d) the mean
   TV, marginal error and classical fidelity each within 4 sigma + delta of
   row 11's, sigma the metric's standard deviation over
   ``REFERENCE_SHADOW_WALKS`` further walks of those tables, delta the
   exact chain's metric at float32 against the model at bfloat16 compute
   (printed with the margins); (e) table rows of bases 0, 150 and 299 at
   t = 100, 50, 1 within 1e-5 of a CPU recompute. Then the walk at this
   shape against its plain version, bit for bit, and timed.
9c. shadow_n12 — the shadow route at N = 12: ``run_experiment`` on the
   ``shadow_transformer`` preset with only ``data.num_qubits`` set to 12,
   at full width (100 sampled bases of 1,024 shots, RQC depth 8, readout
   noise, transformer 128 / 512 / 4 blocks / 4 heads, T=100, cosine,
   renoise, 5,000 generated shots a basis), training cut to
   ``SHADOW_EPOCHS_CUT`` of 30 epochs, with the
   launch counts set to 0 just before and read just after: the tables over
   the 409,600-row label grid (1.97 GB), then one walk of 500,000 chains on
   the gather body and no step launch. Checks: every basis' samples
   against the exact chain of the tables the walk read (TV within 4
   shot-noise scales, every per-qubit marginal within
   ``SHADOW_N12_MARGINAL_SCALES``, the mean TV less a multinomial draw's
   within 4 standard errors of 0), table rows of three bases against a CPU
   recompute (1e-5), the walk on the route's tables bit for bit against
   its plain version, and timed. It prints the stage seconds, the peak
   memory and the quality metrics beside phase shadow's at N = 10.

10. notebook — ``run_experiment(get_preset("notebook_simple"), seed=0)`` and
   ``notebook_upgraded`` (PlainMLP, 200 epochs / 100 of 300, N=1, 1,024
   shots a basis, T=100, notebook schedule, renoise), each with the launch
   counts set to 0 just before and read just after: one walk launch, no
   step launch. It prints the stage seconds, the fidelity and the raw
   fidelity beside the JAX package's seed-0 rows and seed spread, checks
   the samples against the exact chain of the trained model's tables (TV
   within 4 shot-noise scales per basis), the fidelity against the
   inversion of that distribution (within 0.02, or 4 shot-noise standard
   deviations of the fidelity where that is larger) and ρ.
11. denoise — phase 3's trained ``rqc`` model saved and reloaded
   (``params_load``), the ``rqc`` preset at the same seed in denoise mode:
   no kernel launch; t*, reps, the shots a basis and the ``denoise`` stage
   printed beside phase 3's generate-mode fidelity; each basis' samples
   against the measured frequencies pushed through the model's tables for
   steps t*..1 (TV within 4 noise scales of the reverse chain alone: each
   sample starts from a known measured shot), the share of samples that
   left their starting shot against the chain's own (within 4 standard
   deviations), and ρ.
12. bf16 — the ``rqc`` preset uncut at ``dtype='bfloat16'``: train steps/s
   and fidelity against phase 3's float32 run, one walk launch, the
   samples against the exact chain, the tables on the card against a CPU
   recompute of the same bf16 model (mean absolute difference within
   ``BF16_TABLE_TOL``, which the same weights' float32 tables on the card
   must exceed); then the ``rqc`` and
   the ``shadow_transformer`` widths' training, cut to 81 and 100 steps,
   warm, at float32 and at bfloat16 in turns, steps/s of each.
13. train_profile — 20 training steps of ``fit`` inside the port's
   ``utils.profiling.trace``, after a warm-up, at the
   ``shadow_transformer`` and the ``rqc`` widths: ms a step with and
   without the profiler, device kernels a step, the device's busy share of
   a step and its 5 costliest kernels.
14. mesh — data- and tensor-parallel training over ``torch.distributed``
   (``ddqst_tpu_torch/parallel``): one-process fits at the ``rqc`` width
   (27 batches, 3 epochs) and the shadow width (cut to 16 batches, 2
   epochs) in this process, then a spawned world of 2 ranks on this card,
   joined as ``torchrun`` joins them (gloo: NCCL refuses two ranks on one
   device). There, ``make_mesh(data=2)``: the same fit, whose losses must
   equal one process's at rtol 2e-4, atol 2e-5, then the ``rqc`` preset
   with its training cut to ``MESH_DP_RUN_EPOCHS`` through
   ``run_experiment(mesh=)`` with the launch counts set to 0
   just before and read just after (one walk launch a rank, no step
   launch; both ranks the same rho, fidelity and samples, bit for bit; the
   samples against the exact chain, the fidelity within 0.02 of its
   inversion, rho a state). ``make_mesh(data=1, model=2)``: the split
   forward of the shadow width against the whole one (2e-5), the same fit
   as one process's (the tolerance above), the Adam moments of the 10
   split parameters a block this rank's part, the replicated parameters
   bit-equal across the ranks, then the ``shadow_transformer`` preset with
   its training cut to ``MESH_TP_EPOCHS`` (one walk launch a rank at 2^N =
   1024, ranks bit-equal, the samples against the exact chain). Then a
   one-rank world over NCCL: ``fit`` on ``make_mesh(data=1)`` against the
   mesh-less ``fit`` (the tolerance above). Each fit prints its steps/s and
   the share of its time inside the collectives (host clock, the card
   synchronised around each call). A rank that raises or exits non-zero,
   or a world past ``MESH_WORLD_TIMEOUT_S``, fails the phase.
15. scaling — the JAX campaign's scaling ladder (``scripts/run_scaling_ghz.py``,
   from the port's ``campaigns.scaling``, looked up by ``scaling_rung``) at
   full width (the ``rqc`` preset's FiLM model, T=100, cosine schedule,
   renoise, readout-noisy mitigated data, MLE) over the whole canonical
   grid, depth cut (``SCALING_CUTS``, ``SCALING_SHOTS_CUT``,
   ``SCALING_MLE_ITERS``, ``SCALING_CUT_PARTS``; each cut printed): GHZ-5
   ``ghz5_auto`` and GHZ-7 ``ghz7_mle_hot`` in one ``run_experiment``
   each, GHZ-8 ``ghz8_mle_hot`` through the segment protocol of
   ``scripts/run_frontier_segments.py`` (a CE role, the hard-mining
   distillation segment alone on the data and MLE-target caches,
   ``SCALING_MINING_SEGMENT``; the eval role), and RQC-6 ``rqc6_auto`` on
   the JAX package's committed seed-0 data through the parts of
   ``--scaling-part``, each in a child process: CE stopped after epoch 1's
   checkpoint in one and resumed in the next, which distils and
   evaluates; its raw-inversion fidelity equal to the JAX package's on
   that file within 1e-5. RQC-6's parts and phase campaigns' driver
   processes run beside the rungs of this process: the card is idle most
   of a host-bound step, and each process counts its own launches.
   Each run has its launch counts and peak memory set to 0 just before and
   read just after, and must launch as ``SCALING_PLAN`` says (3 walks at
   N=5, 4 staged walks at N=6, 600 step launches at N=7 (100 at the cut's
   834 generated shots, ``SCALING_PLAN_CUT``), 10 ring walks at N=8; none
   in a part that only trains). Per rung: the
   samples within 4 shot-noise scales (TV) of the model's exact chain in
   every basis (at N=8 the float64 propagation of the tables the walks read,
   a few rows held against a recompute), the fidelity within 0.02 of the
   MLE of that distribution, ρ a state, MLE on the raw counts at least 0.999
   where the data is uncut; at N=8 the CE role's parameters load back, the
   mining segment solves and caches the target and draws non-uniformly.
   It prints the stage seconds, the peak memory and the fidelities beside
   the reference's. Then, once every other process has ended (phase
   ``scaling_kernels``), both kernels at the rungs' shapes, each against
   its plain version bit for bit and timed beside it and its bound.
16. campaigns — the port's campaign drivers as a user runs them, each a
   child process on the card, in three chains side by side, started
   before phase scaling and waited for after it: ``python -m
   ddqst_tpu_torch.campaigns.scaling --only cpu_tiny`` (one row with the
   script's keys, ``device`` the card's ``nvidia-smi`` line, a fidelity
   in [0, 1]), again with the same ``--out`` (no row added); ``python -m
   ddqst_tpu_torch.campaigns.segments --tag cpu_tiny --segments 2
   --steps_per_segment 2 --data_cache FILE --opt_chain`` on data this
   process writes (the ce, segment 0, segment 1 and eval roles in order,
   their params and one eval row; segment 1 from segment 0's parameters
   and Adam state, its saved ``count`` 4 after segment 0's 2, each segment
   lowering the full-grid chain CE; its resume and datagen role are held on the CPU by
   ``tests/test_torch_campaigns.py``); ``python -m
   ddqst_tpu_torch.campaigns.scaling --probe --only rqc4_auto`` at full
   width and shapes (no row; its 2 walk launches, counted in the child, on
   the staged body, at the T=100, C=81, N=4, S=15,000 its config gives).
17. profiles — ``campaigns.shadow_sector_profile``'s ``run`` at full width
   (transformer 128 / 512 / 4 / 4, N=10, T=100) on the reference's CE
   snapshot and data cache, its rows to a temporary file, with the launch
   counts set to 0 just before and read just after (none may launch): the
   ``--bases 48 --seed 7`` selection must be the 48 bases of the JAX
   package's record (``examples/shadow_sector_profile.jsonl``), and each
   row's ``kl_clean`` and ``kl_counts`` within ``PROFILE_ABS`` +
   ``PROFILE_REL`` · |the record's| (the largest gaps printed).

Then it prints the kernel table as one JSON line, the card's name and power
limit as ``nvidia-smi`` gives them, and, last, the result line
``{"ok": true, "device": {...}}``.

To compare two checkouts' kernels on one card, ``python3 chip_smoke.py
--time-kernels [DIR]`` builds and times only the kernels of the checkout at
DIR (default: this one), with this script's timer and inputs, and prints one
JSON line; run it in turns (old, new, new, old) on one card.
``python3 chip_smoke.py --ce-step-times [DIR]`` times only a CE training
step of ``ghz6_auto`` at full width with the package of the checkout at
DIR, alone in its process (one JSON line); run it in turns in the same way.

``python3 chip_smoke.py --bench [ARGS]`` runs only the port's bench,
``python -m ddqst_tpu_torch.bench ARGS``, in this process: by default at
``bench.py``'s full depth (300 epochs, up to 800 distillation steps, GHZ-3
at seeds 0-2); its record is the last line.

``python3 chip_smoke.py --full-depth [SEEDS]`` runs only the distill phase,
uncut (300 epochs, up to 800 distillation steps): GHZ-3 and RQC-3 at seed
0, then GHZ-3 at seeds 1 to SEEDS-1 (default: none), with the same checks;
it prints each run's result as it ends and all of them as one JSON line.

``python3 chip_smoke.py --scaling TAG [TAG ...]`` runs only the named rungs
of the ladder (any tag of ``campaigns.scaling.experiments()``; the checks
know ``ghz5_auto``, ``rqc4_auto``, ``rqc6_auto``, ``ghz7_mle_hot`` and
``ghz8_mle_hot``), uncut, each in one ``run_experiment`` call with the
rung's checks (every 25th training epoch logged), and prints one JSON line.

``python3 chip_smoke.py --campaign TAG OUT_DIR`` runs a rung with
committed JAX data (``SCALING_DATA``: ``rqc4_auto``, ``rqc6_auto``) uncut
through ``campaigns.scaling --only TAG --data_cache FILE --out
OUT_DIR/scaling.jsonl`` in this process,
then holds it as ``--scaling-part``'s evaluating part does (the launch
plan, the samples against the exact chain, raw inversion within 1e-5 and
MLE on the raw counts within 1e-4 of the JAX package's on the file, the
fidelity beside the reference's row as a verdict) and checks the row the
driver appended; one JSON line.

``python3 chip_smoke.py --repeat-check`` runs ``campaigns.shadow_scale
--tag repeat --epochs 1 --max_bases 100`` in two child processes from one
seed and compares their loss trace, a sha256 of every parameter and their
rows; where they differ it trains the model twice in one process and names
the first module output, output gradient and parameter gradient that
differ. One JSON line.

``python3 chip_smoke.py --scaling-part TAG PART IN_DIR OUT_DIR [--cut]``
runs one part of a rung split across processes or chip calls
(``SCALING_PARTS``: RQC-6 as ``ce1``, CE epochs 1-75 stopped after epoch
75's checkpoint, and ``ce2``, epochs 76-150 resumed from it, the held-out
distillation, generation and the estimators; RQC-5 and GHZ-6 as CE halves
``ce1`` and ``ce2`` and then ``d``, the held-out distillation and the tail;
GHZ-7 as ``ce1``, ``ce2``, ``d1``-``d3`` and ``eval``, on its committed
seed-0 file). It
refuses to start when a file it reads is missing from IN_DIR, writes what
the next part reads (a checkpoint, parameters, an Adam state, caches) and
its record ``TAG_PART.json`` to OUT_DIR, and prints one JSON line. The
evaluating part holds the rung's checks, the raw-inversion fidelity and,
uncut, MLE on the raw counts against the JAX package's on the same file,
and records the fidelity beside the reference's row. With ``--cut``, the
default run's cuts; with ``--no-stop K`` a distilling part runs K steps
without the held-out early stop (a diagnostic, not the recipe: its record
is ``TAG_PART_nostopK.json`` and it writes no row). Two more diagnostics of
a distilling part keep the recipe and change only its random stream, and
combine with ``--no-stop``: ``--draws FILE`` takes the part's minibatches
from the rows of a basis-draw file (``tools/make_reference_data.py
--draws``, the JAX package's own draws), refusing a file that is short,
of another basis batch, rung, seed or salt before any work, and checks
that it used one row a step; ``--salt K`` adds K to the part's
``chain_key_salt``. Their records are ``TAG_PART_jax_seedS.json`` /
``TAG_PART_saltK.json``, and their rows name the stream.
``--matmul-precision bfloat16`` (with any of those, on a distilling part)
runs the part and its checks within
``ops.precision.default_matmul_precision("bfloat16")``, the TPU's default
precision emulated in the model's products (the estimators stay float32);
its record is ``TAG_PART_bf16[...].json`` and its row's note names it.
``--row-note TEXT`` (an uncut evaluating part only) adds what the records
cannot say to the row's note, such as parts that shared the card.
``--seed K`` (any uncut part) runs it at ``run_experiment``'s seed K: the
CE model's initialisation and batch order, the distillation's basis
stream and the generation's draws, on the same committed data. Its
record is ``TAG_PART_seedK[...].json`` with ``seed``, the row's note
names the seed, and a part refuses, before any work, a predecessor's
record in IN_DIR of another seed or whose output hash is not the file it
was handed, so a chain runs at one seed. Every
record holds the sha256 of the parameters the part starts from and leaves
(``params_in_sha256`` / ``params_out_sha256``), and the step kernel's
launches timed on the path by CUDA event pairs (``step_ms_mean``,
``step_ms_total``) beside the generation stage's seconds.
``python3 chip_smoke.py --scaling-cut TAG`` runs only that cut rung,
through its parts in child processes.

``python3 chip_smoke.py --scaling-costs`` measures the stages of the GHZ-7
and GHZ-8 rungs alone (the data step, MLE on the raw counts at 50, 200 and
1,000 iterations, a CE epoch, two full-grid chain passes, four chained
distillation segments of the hot recipe) and prints one JSON line.

``python3 chip_smoke.py --shadow-reference-train`` trains the reference's
N=10 recipe (``reference_shadow_cfg()``, 150 epochs of 300 steps) uncut
from seed 0 on the reference's data cache, generates and scores as phase
reference_shadow does (checks (a) and (c)), and holds the mean TV within
``REFERENCE_TRAIN_TV_TOL`` of the reference's two trainings at this recipe,
the marginal error at most ``REFERENCE_TRAIN_MARGINAL_MAX`` and the
classical fidelity at least ``REFERENCE_TRAIN_CF_MIN``; one JSON line.

``python3 chip_smoke.py --profiles OUT_DIR`` runs phase ``profiles`` on all
48 bases through ``campaigns.shadow_sector_profile``'s own ``run`` (rows to
``OUT_DIR/shadow_sector_profile.jsonl``), then GHZ-8 at full shape
(``ghz8_mle_hot``, 6,561 bases): ``campaigns.mle_target`` writes its data
and MLE target (the estimate's own fidelity, and beside it MLE on all the
raw counts at the rung's readout_p, ``run_experiment``'s
``raw_fidelity_mitigated``, printed and written to
``OUT_DIR/ghz8_mle_hot_mle_target.json``),
``campaigns.ghz8_eval_floor`` scores the target's sampled and exact counts
through the blocked MLE, ``campaigns.ghz8_sector_profile`` and
``campaigns.eval_chain_ce_subset --bases 6561`` run on the rung's model at a
seeded initialisation (the record's snapshots are not in the repository),
and the subset route's full-grid chain CE must equal
``finetune_chain(steps=0)``'s within ``PROFILE_CE_REL``; no kernel may
launch. One JSON line.

``python3 chip_smoke.py --diag OUT_DIR probe | STEPS WARM`` runs the
three GHZ-5 distillation diagnostics (``campaigns.diag_segment_descent``,
``diag_floor_escape``, ``diag_hard_mining``) with ``--steps STEPS --warm
WARM``, side by side in child processes, each record
``OUT_DIR/<name>.json`` beside the JAX package's ``examples/<name>.json``;
``probe`` times the data, CE training and ``DIAG_PROBE_STEPS`` accum-4
steps in this process and estimates each diagnostic's time at its script's
depth (longer than a call may last). One JSON line.

``python3 chip_smoke.py --profile-distill`` times one distillation step at
full width (with and without the per-step checkpoint, and a forward alone)
and counts its device kernels and the device's busy time with
``torch.profiler``; one JSON line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet (SXM)
# 32-bit integer add, multiply-add, logic and shift each issue at 64 results
# per clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic-instruction throughput table): half the 128 float32 lanes. 132
# SMs at the 1.98 GHz boost clock. The rate phase measures it on the card and
# finds three things the bounds below rely on. Multiplies issue on one pipe
# and add/logic/shift on another, side by side, each at this rate, so the
# least time for integer work is the busier pipe's, not the sum's. A
# product's high half, alone (IMAD.HI.U32) or with the low half
# (IMAD.WIDE.U32), issues at half this rate: it takes two of the multiplier's
# slots. The float32 rate stays out of the bounds.
H100_INT_OPS_PER_S = 132 * 64 * 1.98e9
PRODUCT_MUL_SLOTS = 2
# The least integer work that computes the functions, whatever the source
# does. Rounds 2 to 10 of a Philox4x32-10 call each need two products and two
# three-input XORs per chain, except that the last round needs only one
# product when the call supplies one or two bits. Round 1 works on the
# counter alone, which is a constant, the same for a warp, or made once per
# chain, and the round keys depend on the seed alone: neither is counted per
# call. A bit: a shift, a compare, a select/or.
PHILOX_MUL_SLOTS = (8 * 2 + 1) * PRODUCT_MUL_SLOTS
PHILOX_ALU_OPS = 9 * 2
BIT_ALU_OPS = 3
PHILOX_MUL_OPS_SOURCE = 10 * 2  # products a call as the source writes it


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _bound_ms(nbytes: int, mul_slots: int, alu_ops: int) -> tuple[float, str]:
    """The larger of bytes over the memory rate and the busier integer pipe's
    instructions (multiplier slots, add/logic instructions) over the
    integer rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max(mul_slots, alu_ops) / H100_INT_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def walk_bound_ms(t_steps: int, c: int, n: int, s: int) -> tuple[float, str]:
    """Least time for the walk: the table rows its chains can reach, init
    and out, each moved once; one Philox call per 4 bits and the bit work,
    per chain and step. A step's S chains of a row read at most min(2^N, S)
    of its 2^N table rows, so where S < 2^N (N >= 13 at S = 5,000) only S
    rows a (step, row) count; where S >= 2^N the whole slice does."""
    nbytes = 4 * (t_steps * c * min(2**n, s) * n + 2 * c * s)
    calls = c * s * t_steps * math.ceil(n / 4)
    bits = c * s * t_steps * n
    return _bound_ms(nbytes, calls * PHILOX_MUL_SLOTS,
                     calls * PHILOX_ALU_OPS + bits * BIT_ALU_OPS)


def step_bound_ms(b: int, n: int, g: int,
                  row_base: bool = False) -> tuple[float, str]:
    """Least time for one chain step: the table, the rows (or the state and
    the row offsets) and the outcomes, each moved once; per chain one Philox
    call per 4 bits, the bit work, and round 1's one product of the chain's
    index (shared by its calls) with one XOR a call."""
    nbytes = 4 * (g * n + (3 if row_base else 2) * b)
    calls = b * math.ceil(n / 4)
    return _bound_ms(nbytes, calls * PHILOX_MUL_SLOTS + b * PRODUCT_MUL_SLOTS,
                     calls * (PHILOX_ALU_OPS + 1) + b * n * BIT_ALU_OPS)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events. The
    card first spins for a few ms, so the host has the calls queued before
    the first one starts and the events time the card, not Python."""
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Measuring modes of csrc/int_rate.cu and the SASS opcode each should become.
# (mode, name, SASS opcode, multiplier slots an instruction takes)
RATE_MODES = (
    (0, "int_mad", "IMAD", 1),
    (1, "int_mul_wide", "IMAD.WIDE.U32", PRODUCT_MUL_SLOTS),
    (6, "int_mul_hi", "IMAD.HI.U32", PRODUCT_MUL_SLOTS),
    (2, "logic3", "LOP3.LUT", 1),
    # the assembler spreads plain adds over both pipes (IADD3, IMAD.IADD)
    (3, "int_add", "", 0.5),
    (4, "float_fma", "FFMA", 0.5),
    # a product and an XOR in turns: the multiplier's two slots hide the XOR
    (5, "mul_wide_and_logic3", "", PRODUCT_MUL_SLOTS / 2),
)
_SASS_INSTR = re.compile(
    r"^\s*/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_.]*)(.*?);")
_CONVERT = ("F2I", "I2F", "F2F", "I2I", "F2FP", "I2FP", "FRND")
_MEMORY = ("LD", "ST", "ATOM", "RED", "ULDC", "UBLKCP", "SYNCS")
_CONTROL = ("BRA", "BRX", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC", "NOP",
            "CALL", "RET", "YIELD", "DEPBAR", "MEMBAR", "FENCE", "ERRBAR",
            "NANOSLEEP", "BPT", "ELECT", "BREAK", "BMOV", "ACQBULK")
_INT_ALU = ("IADD", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP", "ICMP", "SEL",
            "PRMT", "IABS", "IMNMX", "VIMNMX", "MOV", "POPC", "FLO", "BREV",
            "SGXT", "BMSK", "PLOP3", "P2R", "R2P", "VOTE", "SHFL")


def sass_pipe(op: str) -> str:
    """The pipe an SASS opcode issues on, coarsely."""
    base = op.split(".")[0]
    if base.startswith(("IMAD", "IMUL")):
        return "int_multiply"  # IMAD.MOV / .IADD / .SHL take that pipe too
    if base.startswith(_CONVERT):
        return "convert"
    if base.startswith(_MEMORY):
        return "load_store"
    if base.startswith(_CONTROL):
        return "control"
    if base.startswith(_INT_ALU):
        return "int_alu"
    if base.startswith("F") or base == "MUFU":
        return "float"
    return "other"  # S2R, CS2R, the uniform datapath (U...)


def disassemble(_build, name: str) -> dict[str, list[tuple[int, str, str]]]:
    """``cuobjdump -sass`` of the built ``csrc/<name>.cu``: function name ->
    [(address, opcode, operands)]."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    check(os.path.exists(cuobjdump), f"{cuobjdump} exists (it ships with nvcc)")
    text = subprocess.run(
        [cuobjdump, "-sass", _build.library_path(name)], capture_output=True,
        text=True, check=True, timeout=300).stdout
    return parse_sass(text)


def parse_sass(text: str) -> dict[str, list[tuple[int, str, str]]]:
    funcs: dict[str, list] = {}
    labels: dict[str, dict[str, int]] = {}
    name, pending = None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, pending = m.group(1), []
            funcs.setdefault(name, [])
            labels.setdefault(name, {})
            continue
        m = re.match(r"\s*(\.L_\w+):", line)
        if m:
            pending.append(m.group(1))  # names the next instruction
            continue
        m = _SASS_INSTR.match(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            labels[name].update((lab, addr) for lab in pending)
            pending = []
            funcs[name].append((addr, m.group(2), m.group(3)))
    # a branch to a label becomes a branch to the label's address
    for name, instrs in funcs.items():
        for i, (addr, op, args) in enumerate(instrs):
            m = re.search(r"\.L_\w+", args)
            if op.startswith("BRA") and m and m.group(0) in labels[name]:
                instrs[i] = (addr, op, f" {labels[name][m.group(0)]:#x} ")
    return funcs


def hot_loop(instrs: list) -> list:
    """The innermost loop (a backward branch and what it jumps over) that
    holds the most multiplies; the whole function if it has no loop."""
    loops = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any((lo2, hi2) != (lo, hi) and lo <= lo2 and hi2 <= hi
                        for lo2, hi2 in loops)]
    bodies = [[i for i in instrs if lo <= i[0] <= hi] for lo, hi in inner]
    return max(bodies, default=instrs, key=lambda b: sum(
        1 for _, op, _ in b if op.startswith("IMAD")))


def step_loop(instrs: list) -> list:
    """The loop (a backward branch and what it jumps over) that holds the
    most wide multiplies, the smallest of those, without the loops nested
    in it: the ring body's step loop, whose waits spin in small loops of
    their own."""
    loops = []
    for addr, op, args in instrs:
        m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))

    def wide(lo, hi):
        return sum(1 for a, op, _ in instrs
                   if lo <= a <= hi and op.startswith("IMAD.WIDE.U32"))

    lo, hi = max(loops, key=lambda b: (wide(*b), b[0] - b[1]))
    inner = [(a, b) for a, b in loops
             if lo <= a and b <= hi and (a, b) != (lo, hi)]
    return [i for i in instrs if lo <= i[0] <= hi
            and not any(a <= i[0] <= b for a, b in inner)]


def count_by_pipe(instrs: list) -> dict:
    counts: dict[str, int] = {}
    for _, op, _ in instrs:
        counts[sass_pipe(op)] = counts.get(sass_pipe(op), 0) + 1
    for key, prefix in (("wide_multiplies", "IMAD.WIDE.U32"),
                        ("multiply_highs", "IMAD.HI")):
        counts[key] = sum(1 for _, op, _ in instrs if op.startswith(prefix))
    counts["total"] = len(instrs)
    return counts


def phase_rate(_build) -> dict:
    """The card's lane-instruction rates by kind, and what each kernel
    issues per chain and step (from the SASS)."""
    import ctypes

    fn = _build.load("int_rate").ddqst_int_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 4 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sass = disassemble(_build, "int_rate")
    rates = {}
    for mode, label, opcode, slots in RATE_MODES:
        def launch():
            err = fn(mode, out.data_ptr(), blocks, threads, iters, stream)
            check(err == 0, f"int_rate mode {mode} launched (cudaError {err})")
        ms = min(cuda_ms(launch, 5) for _ in range(3))
        rates[label] = blocks * threads * iters * 32 / (ms * 1e-3)
        body = hot_loop(next(v for k, v in sass.items()
                             if f"int_rate_kernelILi{mode}E" in k))
        ops = [op for _, op, _ in body]
        kinds = ", ".join(f"{ops.count(o)} {o}" for o in sorted(set(ops)))
        peak = H100_INT_OPS_PER_S / slots
        log("rate", f"{label}: {rates[label]:.4e} lane instructions/s "
            f"({rates[label] / H100_INT_OPS_PER_S:.3f} of the documented "
            f"integer rate, {rates[label] / peak:.3f} of the {peak:.4e} the "
            f"bounds allow this kind); loop body: {kinds}")
        if opcode:
            n_op = sum(1 for o in ops if o.startswith(opcode))
            check(n_op >= 32 and n_op % 32 == 0 and n_op >= 0.8 * len(ops),
                  f"the {label} loop is {opcode} ({n_op} of {len(ops)})")
        # a reading over the peak means the tool or the constant is wrong
        check(rates[label] <= 1.05 * peak,
              f"measured {label} rate {rates[label]:.4e} does not exceed "
              f"{peak:.4e} by more than 5%")
    log("rate", f"documented integer rate {H100_INT_OPS_PER_S:.4e}/s "
        f"({sms} SMs x 64 lanes x 1.98 GHz); SM clock now / max: {clocks}")
    check(sms == 132, "the bounds' constants are an H100 SXM's (132 SMs)")

    # Instructions per chain and step, from the SASS of the built kernels.
    counts = {}
    step_sass = disassemble(_build, "chain_step")
    for key, tag in (("step_n3_rows", "chain_step_kernelILi3ELb0E"),
                     ("step_n3_row_base", "chain_step_kernelILi3ELb1E"),
                     ("step_n7_rows", "chain_step_kernelILi7ELb0E")):
        body = next(v for k, v in step_sass.items() if tag in k)
        c = count_by_pipe(body)
        # the whole kernel, both its 16-byte and its 4-byte accesses, serves
        # 4 chains
        counts[key] = {k: v / 4 for k, v in c.items()}
    walk_sass = disassemble(_build, "chain_walk")
    for key, tag, n in (("walk_n3", "chain_walk_kernelILi3E", 3),
                        ("walk_n7", "chain_walk_kernelILi7E", 7)):
        body = hot_loop(next(v for k, v in walk_sass.items() if tag in k))
        c = count_by_pipe(body)
        # a step reads one threshold a bit from shared memory
        steps = max(1, sum(1 for _, op, _ in body if op.startswith("LDS")) // n)
        counts[key] = {k: v / steps for k, v in c.items()}
        counts[key]["steps_in_loop_body"] = steps
    # N = 10, the shadow route's: the ring body's step loop (a stage of two
    # steps; one conversion a bit and step); N = 12: the gather body's step
    # loop (one step); then the ablation's variants of the plain global body
    # at N = 10 and 12 (its loop, unrolled by 2, without the L2 prefetch's
    # loop nested in it; mode 2 is the plain global body itself)
    for key, tag, n in (("walk_n10_ring", "chain_walk_ring_kernelILi10E", 10),
                        ("walk_n12_gather",
                         "chain_walk_gather_kernelILi12ELi4E", 12)):
        body = step_loop(next(v for k, v in walk_sass.items() if tag in k))
        c = count_by_pipe(body)
        steps = max(1, sum(1 for _, op, _ in body if op.startswith("F2I")) // n)
        counts[key] = {k: v / steps for k, v in c.items()}
        counts[key]["steps_in_loop_body"] = steps
    ablation_sass = disassemble(_build, "walk_ablation")
    for n, modes in ABLATION_MODES_BY_N.items():
        for mode in modes:
            body = step_loop(next(
                v for k, v in ablation_sass.items()
                if f"walk_ablation_kernelILi{n}ELi{mode}E" in k))
            counts[f"ablation_n{n}_{mode}"] = {
                k: v / 2 for k, v in count_by_pipe(body).items()}
    for key, c in counts.items():
        log("rate", f"SASS per chain and step, {key}: " + ", ".join(
            f"{k} {v:g}" for k, v in c.items()))
        if key.startswith("ablation"):
            continue
        calls = 3 if "n10" in key or "n12" in key else 2 if "n7" in key else 1
        check(c["multiply_highs"] <= 2 * calls and 0 < c["wide_multiplies"]
              <= PHILOX_MUL_OPS_SOURCE * calls,
              f"{key}: a Philox round's products are IMAD.WIDE.U32 (both "
              f"halves from one instruction), not an IMAD and an IMAD.HI")
    return {"rates": rates, "sass": counts}


# Variants of the plain global body in csrc/walk_ablation.cu: (mode, what it
# keeps of the body), the modes timed at each N, and the modes that give the
# walk's bits.
ABLATION_MODES = (
    (0, "Philox and bits only (no table read)"),
    (1, "4-byte loads, no conversion"),
    (2, "the plain global body (4-byte loads, conversions)"),
    (3, "8-byte loads, conversions"),
    (4, "16-byte loads (rows padded to a multiple of 4 words), conversions"),
    (5, "4-byte loads and conversions, no Philox"),
    (6, "16-byte loads and conversions, no Philox"),
    (7, "16-byte loads, L2 prefetch of the next step's slice"),
    (8, "16-byte loads, L2 prefetch two steps ahead"),
    (9, "16-byte loads through L2 only, L2 prefetch of the next step"),
)
ABLATION_MODES_BY_N = {10: (0, 1, 2, 3, 4, 5), 12: tuple(range(10))}
ABLATION_EXACT_MODES = (2, 3, 4, 7, 8, 9)
# The lockstep variants at N = 12 (ddqst_walk_lockstep): (chains a thread,
# block size, a block barrier a step, prefetch: 0 none, 1 the block's share
# of the next slice, 2 the whole next slice, unused shared memory a block in
# bytes, the preferred carveout in percent: -1 left to CUDA, 0 the most L1).
# The gather body launches as (1, 1024, 0, 0, 9216, 0) at the shadow shape.
LOCKSTEP_VARIANTS = ((1, 1024, 0, 0, 0, -1), (1, 1024, 0, 0, 9216, 0),
                     (1, 1024, 0, 0, 116736, -1), (1, 1024, 0, 0, 0, 0),
                     (1, 512, 0, 0, 0, -1), (1, 512, 0, 0, 9216, 0),
                     (1, 512, 0, 0, 77824, -1), (1, 256, 0, 0, 9216, 0),
                     (1, 1024, 1, 0, 9216, 0), (1, 1024, 0, 1, 9216, 0),
                     (1, 1024, 1, 1, 9216, 0), (1, 1024, 1, 2, 9216, 0),
                     (2, 512, 1, 0, 0, -1), (4, 256, 0, 0, 0, -1))


def phase_ablation(_build, ck) -> dict:
    """What each part of the plain global body costs at the shadow shape
    (T=100, C=100, S=5,000) at N = 10 and N = 12 (blocks of 512 threads, as
    its plan chose there): the variants of csrc/walk_ablation.cu in turns,
    beside the wrapper (the ring body at N = 10, the gather body at 12) and
    the bound; then at N = 12 the lockstep variants (``LOCKSTEP_VARIANTS``),
    each held to the plain version's bits. No profiler runs on the card's
    machine."""
    import ctypes

    fn = _build.load("walk_ablation").ddqst_walk_ablation
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                   ctypes.c_void_p]
    t_steps, c, s = 100, 100, 5000
    stream = torch.cuda.current_stream().cuda_stream
    what = dict(ABLATION_MODES)
    rec: dict = {}
    for n, modes in ABLATION_MODES_BY_N.items():
        tables, init = random_walk_inputs(t_steps, c, n, s, seed=20)
        wide = -(-n // 4) * 4  # rows of the 16-byte-load modes
        padded = (torch.nn.functional.pad(tables, (0, wide - n)).contiguous()
                  if wide > n else tables)
        out = torch.empty_like(init)
        want = ck.fused_chain_walk_reference(5, tables, init, n)
        ms: dict = {}
        for rep in range(2):
            for mode in modes:
                src = padded if mode == 4 or mode >= 6 else tables

                def launch():
                    err = fn(n, mode, src.data_ptr(), init.data_ptr(),
                             out.data_ptr(), t_steps, c, s, 512, 5, stream)
                    check(err == 0, f"walk_ablation N={n} mode {mode} "
                          f"launched ({err})")
                ms.setdefault(mode, []).append(cuda_ms(launch, 20))
                if mode in ABLATION_EXACT_MODES and rep == 0:
                    torch.cuda.synchronize()
                    check(torch.equal(out, want), f"ablation N={n} mode "
                          f"{mode} gives the plain version's bits")
            ms.setdefault("wrapper", []).append(cuda_ms(
                lambda: ck.fused_chain_walk(5, tables, init, n), 20))
        body = ck.fused_chain_walk.last_plan[3]
        bound, by = walk_bound_ms(t_steps, c, n, s)
        for mode in modes:
            log("ablation", f"N={n} mode {mode}, {what[mode]}: "
                f"{ms[mode][0]:.4f} / {ms[mode][1]:.4f} ms "
                f"({min(ms[mode]) / bound:.2f} x bound)")
        log("ablation", f"N={n} wrapper (the {body} body): "
            f"{ms['wrapper'][0]:.4f} / {ms['wrapper'][1]:.4f} ms "
            f"({min(ms['wrapper']) / bound:.2f} x bound); bound "
            f"{bound:.5f} ms ({by})")
        rec[f"n{n}"] = dict({str(k): v for k, v in ms.items()},
                            bound_ms=bound, bound_by=by, wrapper_body=body)
        if n == 12:
            rec["lockstep_n12"] = lockstep_variants(
                _build, tables, init, want, bound)
        del tables, init, padded, out, want
    return rec


def lockstep_variants(_build, tables, init, want, bound) -> dict:
    """``LOCKSTEP_VARIANTS`` at N = 12 on these inputs: ms of each, in
    turns, each first held to the plain version's bits ``want``, and the
    blocks an SM held."""
    import ctypes

    fn = _build.load("walk_ablation").ddqst_walk_lockstep
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_uint64, ctypes.c_void_p,
                             ctypes.c_void_p]
    t_steps, c, _, _ = tables.shape
    s = init.shape[1]
    out = torch.empty_like(init)
    resident = ctypes.c_int(0)
    stream = torch.cuda.current_stream().cuda_stream
    ms: dict = {}
    held: dict = {}
    for rep in range(2):
        for k, threads, barrier, prefetch, smem, carve in LOCKSTEP_VARIANTS:
            key = (f"k{k}_t{threads}_b{barrier}_p{prefetch}_smem{smem}"
                   f"_carve{carve}")

            def launch():
                err = fn(k, barrier, prefetch, smem, carve, tables.data_ptr(),
                         init.data_ptr(), out.data_ptr(), t_steps, c, s,
                         threads, 5, ctypes.addressof(resident), stream)
                check(err == 0, f"walk_lockstep {key} launched ({err})")
            ms.setdefault(key, []).append(cuda_ms(launch, 10))
            held[key] = resident.value
            if rep == 0:
                torch.cuda.synchronize()
                check(torch.equal(out, want), f"lockstep {key} gives the "
                      "plain version's bits")
    for key, v in ms.items():
        log("ablation", f"N=12 lockstep {key}: {v[0]:.4f} / {v[1]:.4f} ms "
            f"({min(v) / bound:.2f} x bound), {held[key]} blocks an SM")
    return dict(ms=ms, blocks_per_sm=held)


def exact_walk(tables: torch.Tensor, init_dist: torch.Tensor) -> torch.Tensor:
    """Exact propagation of the table walk in float64: [T,C,g,N] -> [C,g].

    Each step's [x, y] transition is built qubit by qubit, for a chunk of
    rows at a time (at most 2^25 float64 entries, 256 MB), so no [C, g, g,
    N] intermediate exists (8.4 GB a step at the shadow shape)."""
    t_steps, c, g, n = tables.shape
    y = ((torch.arange(g, device=tables.device)[:, None]
          >> torch.arange(n, device=tables.device)) & 1).double()
    rows = max(1, (1 << 25) // (g * g))
    dist = init_dist.double().clone()
    for t in range(t_steps):
        for lo in range(0, c, rows):
            p1 = tables[t, lo:lo + rows].double()  # [rows, x, N]
            trans = None
            for q in range(n):
                pq = p1[:, :, q, None]  # [rows, x, 1]
                f = pq * y[:, q] + (1 - pq) * (1 - y[:, q])  # [rows, x, y]
                trans = f if trans is None else trans.mul_(f)
            dist[lo:lo + rows] = torch.einsum("cx,cxy->cy", dist[lo:lo + rows],
                                              trans)
    return dist


def exact_transitions(tables: torch.Tensor) -> torch.Tensor:
    """The table walk's whole transition matrix in float64: [T,C,g,N] ->
    [C, g, g], row x the distribution after T steps from state x."""
    t_steps, c, g, n = tables.shape
    eye = torch.eye(g, dtype=torch.float64, device=tables.device)
    return exact_walk(tables.repeat_interleave(g, dim=1),
                      eye.repeat(c, 1)).reshape(c, g, g)


def hist_rows(idx: torch.Tensor, g: int,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Outcome indices ``[C, S]`` -> counts ``[C, g]``."""
    hist = torch.zeros((idx.shape[0], g), dtype=dtype, device=idx.device)
    return hist.scatter_add_(1, idx.long(), torch.ones(
        idx.shape, dtype=dtype, device=idx.device))


def tv_rows(idx: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    hist = hist_rows(idx, dist.shape[-1], dist.dtype)
    return 0.5 * (hist / idx.shape[-1] - dist).abs().sum(-1)


def random_walk_inputs(t_steps, c, n, s, seed):
    """Tables uniform in [0.05, 0.95] and a random start, from a seed: made
    with numpy up to 2^7 outcomes (the inputs of the earlier slices), on the
    card above (gigabytes of tables at N = 8 over the full grid)."""
    g = 2**n
    if n > 7:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tables = torch.rand((t_steps, c, g, n), generator=gen, device="cuda")
        init = torch.randint(0, g, (c, s), generator=gen, device="cuda",
                             dtype=torch.int32)
        return tables.mul_(0.9).add_(0.05), init
    rng = np.random.default_rng(seed)
    tables = rng.uniform(0.05, 0.95, (t_steps, c, g, n)).astype(np.float32)
    init = rng.integers(0, g, (c, s)).astype(np.int32)
    return (torch.from_numpy(tables).cuda(), torch.from_numpy(init).cuda())


def _offset_by_one_word(t: torch.Tensor, words: int = 1) -> torch.Tensor:
    """The same values at an address 4 bytes (4 x ``words``) off 16-byte
    alignment."""
    buf = torch.empty(t.numel() + words, dtype=t.dtype, device=t.device)
    buf[words:] = t.reshape(-1)
    return buf[words:].view(t.shape)


def phase_kernel(ck) -> dict:
    """Kernel vs plain version on the card; returns the timing record."""
    # (T, C, N, S): the rqc preset's shape, the bench recipe's (50,000 shots
    # a basis), a ragged S, and N = 1 (plain loads), 5 (all T slices at
    # once, 64 KB), 6 and 7 (a ring of chunks), the notebook presets' (N = 1,
    # 3 x 1,024 chains: fewer blocks than SMs); then from N = 8 on, the ring
    # body: the shadow route's shape (N = 10, 100 sampled bases), a ragged S
    # there, N = 8, 9 and 11, and its tails: an odd T (a short last stage
    # load) and T below its stages x steps a stage (8 at N = 8, 4 at N = 10,
    # 2 at N = 11); then the gather body from N = 12 to 16: ragged S, odd T
    # and T = 1 at each N, S >= 2^N at N = 12 and 13; then the shadow
    # bench's shape (the ring body at 50 rows x 2,000 chains); last RQC-4's
    # generation (81 bases, a call of 15,000 chains each).
    shapes = [(100, 27, 3, 5000), (100, 27, 3, 50000), (100, 27, 3, 1237),
              (100, 27, 7, 5000), (100, 27, 1, 5000), (100, 27, 5, 1237),
              (100, 27, 6, 1237), (100, 3, 1, 1024),
              (100, 100, 10, 5000), (100, 100, 10, 1237), (100, 40, 8, 3001),
              (50, 30, 9, 2049), (50, 20, 11, 1237),
              (7, 30, 8, 1237), (3, 30, 8, 1237), (1, 30, 8, 319),
              (7, 30, 10, 1237), (3, 30, 10, 5000), (1, 30, 10, 1237),
              (5, 20, 11, 1237), (20, 8, 12, 999), (7, 6, 12, 4097),
              (1, 3, 12, 5000), (9, 5, 13, 1237), (3, 2, 13, 8193),
              (1, 4, 13, 999), (8, 3, 14, 1237), (1, 3, 14, 777),
              (7, 2, 15, 1001), (1, 2, 15, 513), (6, 2, 16, 1237),
              (3, 1, 16, 999), (1, 2, 16, 4097), (100, 50, 10, 2000),
              RQC4_WALK_SHAPE]
    max_err = 0.0
    for i, (t_steps, c, n, s) in enumerate(shapes):
        tables, init = random_walk_inputs(t_steps, c, n, s, seed=i)
        seed = 0x1234_5678_9ABC + i
        out_k = ck.fused_chain_walk(seed, tables, init, n)
        plan = ck.fused_chain_walk.last_plan
        out_r = ck.fused_chain_walk_reference(seed, tables, init, n)
        again = ck.fused_chain_walk(seed, tables, init, n)
        torch.cuda.synchronize()
        err = float((out_k - out_r).abs().max())
        max_err = max(max_err, err)
        where = f"T={t_steps} C={c} N={n} S={s}"
        check(torch.equal(out_k, out_r),
              f"kernel == plain bit for bit at {where}")
        check(torch.equal(out_k, again), f"same seed repeats at {where}")
        check(not torch.equal(ck.fused_chain_walk(seed + 1, tables, init, n),
                              out_k), f"another seed differs at {where}")
        check(plan[3] == ("staged" if n <= 7 else "ring" if n <= 11
                          else "gather"), f"the plan's body at {where}: {plan}")
        plans = []
        for threads in (64, 128, 256, 512):
            out = ck.fused_chain_walk(seed, tables, init, n, threads=threads)
            plans.append(ck.fused_chain_walk.last_plan)
            check(torch.equal(out, out_r),
                  f"{threads} threads give the same bits at {where}")
        for words in (1, 2) if n > 11 else (1,) if n > 7 else ():
            shifted = _offset_by_one_word(tables, words)
            check(torch.equal(ck.fused_chain_walk(seed, shifted, init, n),
                              out_r), f"tables {4 * words} bytes off "
                  f"alignment give the same bits at {where}")
            del shifted
        off = (" and 4 and 8 bytes off alignment" if n > 11
               else " and off alignment" if n > 7 else "")
        log("kernel", f"{where}: kernel == plain (bit for bit) at the chosen "
            f"plan and at every block size{off}, repeatable; chose "
            f"{plan[0]} threads, {plan[1]} steps a buffer, "
            f"{plan[2]} B of shared memory, body {plan[3]}; the block sizes' "
            f"plans: {plans}")

    for n in (3, 7, 10):
        t_steps, c, s = 20, 4, 200_000
        tables, init = random_walk_inputs(t_steps, c, n, s, seed=10 + n)
        g = 2**n
        init_dist = torch.zeros((c, g), dtype=torch.float64, device="cuda")
        init_dist.scatter_add_(1, init.long(), torch.ones(init.shape,
                               dtype=torch.float64, device="cuda"))
        exact = exact_walk(tables, init_dist / s)
        tv = tv_rows(ck.fused_chain_walk(77, tables, init, n), exact)
        bound = 4 * math.sqrt(g / (2 * math.pi * s))
        check(bool((tv < bound).all()), f"TV {tv.tolist()} < {bound} at N={n}")
        log("kernel", f"TV vs exact propagation N={n}: max {float(tv.max()):.5f}"
            f" < bound {bound:.5f}")

    rec = {}
    # (label, C, N, S, kernel iterations, plain iterations): the shapes of
    # the paths: rqc, 10^6 chains, the bench recipes, N = 7, the shadow
    # route (100 sampled bases at N = 10), the shadow bench's (50 bases of
    # 2,000 chains: bench.py's N=10 table sampler), one walk call of
    # sample_all_bases_chunked at N = 8 (3^8 rows, 2^21 // 3^8 = 319 chains
    # a row, 5.4 GB of tables), the shadow shape at N = 11 (no path runs
    # it) and, for the gather body, at N = 12 (phase shadow_n12's shape), 13
    # (50 rows), 14 (25), 15 (12) and 16 (6), each at most 2.6 GB of tables;
    # last a walk of ``rqc4_auto``'s generation (two a run).
    # The parent's body at these shapes is timed by --time-kernels on its
    # checkout.
    for label, c, n, s, it_k, it_r in (("main", 27, 3, 5000, 50, 3),
                                       ("1e6", 27, 3, 37037, 20, 2),
                                       ("bench", 27, 3, 50000, 20, 2),
                                       ("n7", 27, 7, 5000, 20, 2),
                                       ("shadow", 100, 10, 5000, 20, 1),
                                       ("shadow_bench", 50, 10, 2000, 20, 1),
                                       ("n8_grid", 3**8, 8, 319, 5, 1),
                                       ("n11", 100, 11, 5000, 10, 1),
                                       ("n12", 100, 12, 5000, 5, 1),
                                       ("n13", 50, 13, 5000, 5, 1),
                                       ("n14", 25, 14, 5000, 5, 1),
                                       ("n15", 12, 15, 5000, 5, 1),
                                       ("n16", 6, 16, 5000, 5, 1),
                                       ("rqc4", *RQC4_WALK_SHAPE[1:], 20, 1)):
        tables, init = random_walk_inputs(100, c, n, s, seed=20)
        ms_k = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, n), it_k)
        plan = ck.fused_chain_walk.last_plan
        sweep = {t: cuda_ms(lambda: ck.fused_chain_walk(
            5, tables, init, n, threads=t), it_k)
            for t in ((256, 512) if 7 < n < 12 else (64, 128, 256, 512))}
        ms_r = cuda_ms(lambda: ck.fused_chain_walk_reference(
            5, tables, init, n), it_r)
        bound, by = walk_bound_ms(100, c, n, s)
        log("kernel", f"{label}: N={n}, {c} x {s} chains x 100 steps: kernel "
            f"{ms_k:.4f} ms (plan {plan}), plain {ms_r:.3f} ms, "
            f"bound {bound:.4f} ms ({by}), {ms_k / bound:.2f} x bound; by "
            "block size: " + ", ".join(
                f"{t}: {ms:.4f}" for t, ms in sweep.items()))
        rec[label] = dict(ms=ms_k, plain_ms=ms_r, bound_ms=bound, bound_by=by,
                          threads=plan[0], plan=list(plan), ms_by_threads=sweep)
        del tables, init
    rec["max_abs_err"] = max_err
    return rec


def random_step_inputs(g, n, b, seed):
    rng = np.random.default_rng(seed)
    table = rng.uniform(0.05, 0.95, (g, n)).astype(np.float32)
    rows = rng.integers(0, g, b).astype(np.int32)
    return torch.from_numpy(table).cuda(), torch.from_numpy(rows).cuda()


def route_like_step_inputs(c, n, shots, seed):
    """The step kernel's inputs as the dataset route makes them: the grid of
    c circuits, `shots` chains per (circuit, basis) in a row, a random state
    per chain. Returns (table, x, row_base)."""
    rng = np.random.default_rng(seed)
    g = 2**n
    table = rng.uniform(0.05, 0.95, (c * 3**n * g, n)).astype(np.float32)
    x = rng.integers(0, g, c * 3**n * shots).astype(np.int32)
    row_base = np.repeat(np.arange(c * 3**n, dtype=np.int32) * g, shots)
    return (torch.from_numpy(table).cuda(), torch.from_numpy(x).cuda(),
            torch.from_numpy(row_base).cuda())


def phase_step(ck) -> dict:
    """Step kernel vs plain version on the card; returns the timing record."""
    shapes = [(50 * 27 * 8, 3, 6_750_000), (216, 3, 1237),
              (3**7 * 2**7, 7, 1_000_000), (3**7 * 2**7, 7, 999_999),
              (40 * 16, 11, 100_003)]
    max_err = 0.0
    for i, (g, n, b) in enumerate(shapes):
        table, rows = random_step_inputs(g, n, b, seed=30 + i)
        seed = 0x0DDC_0FFE_E123 + i
        out_k = ck.fused_chain_step(seed, table, rows, n, step=7)
        out_r = ck.fused_chain_step_reference(seed, table, rows, n, step=7)
        again = ck.fused_chain_step(seed, table, rows, n, step=7)
        other = ck.fused_chain_step(seed, table, rows, n, step=8)
        # the row_base form on the same rows, split into an offset and a state
        span = min(2**n, g)
        x, base = rows % span, rows - rows % span
        out_b = ck.fused_chain_step(seed, table, x, n, step=7, row_base=base)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out_k - out_r).abs().max()),
                      float((out_b - out_r).abs().max()))
        check(torch.equal(out_k, out_r),
              f"step kernel == plain bit for bit at G={g} N={n} B={b}")
        check(torch.equal(out_b, out_r), f"step kernel with row_base == plain "
              f"bit for bit at G={g} N={n} B={b}")
        check(torch.equal(out_k, again), f"same seed and step repeat at B={b}")
        check(not torch.equal(out_k, other), f"another step differs at B={b}")
        log("step", f"G={g} N={n} B={b}: kernel == plain (bit for bit) with "
            "rows and with row_base, repeatable, another step differs")

    b = 100_000
    for n in (3, 7):
        g = 2**n
        table, _ = random_step_inputs(1, n, 1, seed=40 + n)
        rows = torch.zeros(b, dtype=torch.int32, device="cuda")
        idx = ck.fused_chain_step(99, table, rows, n, step=3)
        y = ((torch.arange(g, device="cuda")[:, None]
              >> torch.arange(n, device="cuda")) & 1).double()
        p1 = table[0].double()
        exact = (p1 * y + (1 - p1) * (1 - y)).prod(-1)[None]  # [1, g]
        tv = tv_rows(idx[None], exact)
        bound = 4 * math.sqrt(g / (2 * math.pi * b))
        check(bool((tv < bound).all()), f"one-row TV {float(tv)} < {bound} "
              f"at N={n}")
        log("step", f"one row, {b} chains, N={n}: TV vs product Bernoulli "
            f"{float(tv):.5f} < bound {bound:.5f}")

    rec = {}
    for label, (g, n, b), it_k, it_r in (("eval", shapes[0], 50, 3),
                                         ("n7", shapes[2], 50, 3)):
        table, rows = random_step_inputs(g, n, b, seed=50)
        span = 2**n
        x, base = rows % span, rows - rows % span
        ms_rows = cuda_ms(lambda: ck.fused_chain_step(5, table, rows, n, 1),
                          it_k)
        ms_k = cuda_ms(lambda: ck.fused_chain_step(5, table, x, n, 1,
                                                   row_base=base), it_k)
        ms_r = cuda_ms(lambda: ck.fused_chain_step_reference(
            5, table, x, n, 1, row_base=base), it_r)
        bound_rows, by_rows = step_bound_ms(b, n, g)
        bound, by = step_bound_ms(b, n, g, row_base=True)
        log("step", f"{label}: G={g} N={n} B={b}, random rows: with row_base "
            f"(as the path calls it) kernel {ms_k:.4f} ms, plain {ms_r:.3f} "
            f"ms, bound {bound:.4f} ms ({by}); with rows {ms_rows:.4f} ms, "
            f"bound {bound_rows:.4f} ms ({by_rows})")
        rec[label] = dict(ms=ms_k, plain_ms=ms_r, bound_ms=bound, bound_by=by,
                          ms_rows_form=ms_rows, bound_ms_rows_form=bound_rows)
    # Where the table lives: the same table and chain count with the rows as
    # the route lays them out (5,000 neighbouring chains share 8 table rows),
    # against the uniformly random rows above.
    table, x, base = route_like_step_inputs(50, 3, 5000, seed=51)
    rec["eval"]["ms_route_rows"] = cuda_ms(
        lambda: ck.fused_chain_step(5, table, x, 3, 1, row_base=base), 50)
    log("step", f"eval, rows laid out as on the route, with row_base: kernel "
        f"{rec['eval']['ms_route_rows']:.4f} ms")
    rec["max_abs_err"] = max_err
    return rec


def phase_seq_walk(ck, model) -> None:
    """sample_all_bases below 32·6^N chains takes the per-step 'seq' walk,
    which must launch the step kernel once per step and the walk never."""
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule

    sched = make_schedule("cosine", 100, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    step0, walk0 = ck.fused_chain_step.launches, ck.fused_chain_walk.launches
    out = diff.sample_all_bases(gen, model, 3, 200, sched)
    torch.cuda.synchronize()
    d_step = ck.fused_chain_step.launches - step0
    d_walk = ck.fused_chain_walk.launches - walk0
    log("step", f"sample_all_bases, 200 shots ('seq' walk): step launches "
        f"+{d_step}, walk launches +{d_walk}")
    check(tuple(out.shape) == (27, 200, 3) and out.is_cuda,
          "'seq' samples [27, 200, 3] on the card")
    check(d_step == 100 and d_walk == 0,
          "the 'seq' walk launched the step kernel once per step")


def phase_main_path(ck) -> tuple[int, dict]:
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import run_experiment

    cfg = get_preset("rqc")
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cfg, seed=0, log_fn=lambda m: log("main", m))
    wall = time.perf_counter() - t0
    launches = ck.fused_chain_walk.launches
    step_launches = ck.fused_chain_step.launches
    tm = res["timings"]
    log("main", f"wall {wall:.2f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()))
    log("main", f"train: {res['train_steps']} steps, "
        f"{res['train_steps'] / tm['train']:.1f} steps/s")
    log("main", f"fidelity {res['fidelity']:.5f} raw_fidelity "
        f"{res['raw_fidelity']:.5f} trace_distance {res['trace_distance']:.5f}"
        f" purity {res['purity']:.5f}")
    log("main", f"fused_chain_walk.launches = {launches}, "
        f"fused_chain_step.launches = {step_launches}")
    check(launches >= 1, "the main path launched the CUDA walk")
    check(step_launches == 0, "run_experiment takes the walk, not the step")

    rho = res["rho"]
    check(rho.shape == (8, 8), "rho is 8x8")
    check(abs(np.trace(rho) - 1) < 1e-4, "trace(rho) == 1 within 1e-4")
    check(np.abs(rho - rho.conj().T).max() < 1e-5, "rho Hermitian within 1e-5")
    check(np.linalg.eigvalsh(rho).min() > -1e-5, "rho PSD within 1e-5")
    for k in ("fidelity", "raw_fidelity", "trace_distance", "purity"):
        check(math.isfinite(res[k]), f"{k} finite")
    samples = res["samples"]
    check(tuple(samples.shape) == (27, cfg.data.shots_infer, 3)
          and samples.is_cuda, "samples [27, 5000, 3] on the card")

    # The samples against the exact chain distribution of the model's own
    # tables, and the fidelity against the inversion of that distribution.
    model = res["state"]
    sched = make_schedule("cosine", cfg.diffusion.num_timesteps, "cuda")
    tables = diff.grid_p1_tables(model, 3, sched).reshape(100, 27, 8, 3)
    exact = exact_walk(tables, torch.full((27, 8), 1 / 8, device="cuda"))
    idx = (samples.long() * (1 << torch.arange(3, device="cuda"))).sum(-1)
    tv = tv_rows(idx, exact)
    bound = 4 * math.sqrt(8 / (2 * math.pi * cfg.data.shots_infer))
    check(bool((tv < bound).all()), f"samples TV {float(tv.max())} < {bound}")
    rho_exact = pauli.make_counts_inverter(3)(
        (exact * cfg.data.shots_infer).float())
    target = torch.from_numpy(res["target"]).cuda()
    fid_exact = float(M.state_fidelity(target, rho_exact))
    log("main", f"samples vs exact chain: max TV {float(tv.max()):.5f} < "
        f"{bound:.5f}; fidelity {res['fidelity']:.5f} vs exact-chain "
        f"inversion {fid_exact:.5f}")
    check(abs(res["fidelity"] - fid_exact) < 0.02,
          "fidelity within 0.02 of the exact-chain inversion")

    cpu_model = build_model(cfg.model, 3, cfg.diffusion.num_timesteps)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_tables = diff.grid_p1_tables(cpu_model.eval(), 3, sched.to("cpu"))
    tab_err = float((tables.reshape(100, 216, 3).cpu() - cpu_tables).abs().max())
    log("main", f"grid tables card vs CPU: max abs err {tab_err:.2e}")
    check(tab_err < 1e-5, "grid tables on the card match the CPU's")
    return launches, res


def check_rho(rho: torch.Tensor, what: str) -> None:
    rho = rho.detach().cpu().numpy()
    check(abs(np.trace(rho) - 1) < 1e-4, f"{what}: trace 1 within 1e-4")
    check(np.abs(rho - rho.conj().T).max() < 1e-5, f"{what}: Hermitian")
    check(np.linalg.eigvalsh(rho).min() > -1e-5, f"{what}: PSD within 1e-5")


def phase_route(ck) -> tuple[int, float]:
    """The phase-4 dataset route on the card; returns the step launches of
    the circuit-conditioned evaluation and the ms one chain update takes in
    ``p_sample_grid``'s loop on the route's inputs."""
    import dataclasses

    from ddqst_tpu_torch import evaluate as ev
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.data.generate import build_dataset_chunked
    from ddqst_tpu_torch.data.records import load_dataset
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.utils.logging import write_metrics_csv

    c, n, t_steps, shots = 50, 3, 100, 5000
    base = get_preset("rqc")
    cfg = base.replace(
        model=dataclasses.replace(base.model, condition_on_circuit=True),
        train=dataclasses.replace(base.train, num_epochs=1),
        data=dataclasses.replace(base.data, shots_infer=shots),
    )
    tm = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds, exp = os.path.join(tmp, "ds"), os.path.join(tmp, "exp")
        gen_kw = dict(seed=0, num_samples=c, num_qubits=n, out_dir=ds,
                      chunk_size=25, shots=1024, noise_type="torino",
                      max_bases=50, log_fn=lambda m: log("route", m))
        t0 = time.perf_counter()
        paths = build_dataset_chunked(**gen_kw)
        torch.cuda.synchronize()
        tm["generate"] = time.perf_counter() - t0
        check(len(paths) == 2, "two shards written")
        check(len(build_dataset_chunked(**gen_kw)) == 2,
              "a second build adds no shard")
        records = load_dataset(ds)
        check(len(records) == c and len({r.hash for r in records}) == c,
              "50 unique circuits")

        t0 = time.perf_counter()
        model, eval_recs = pipeline.train_on_dataset(
            cfg, records, save_dir=exp, run_name="route",
            num_eval_circuits=c, seed=0, log_fn=lambda m: log("route", m))
        torch.cuda.synchronize()
        tm["train"] = time.perf_counter() - t0
        check(os.path.exists(os.path.join(exp, "route_eval.npz"))
              and os.path.exists(os.path.join(exp, "route_params.pt")),
              "train_on_dataset wrote its eval subset and params")

        sched = make_schedule("cosine", t_steps, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        extras: dict = {}
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        t0 = time.perf_counter()
        out = ev.evaluate_dataset(
            gen, eval_recs, model, n, sched, shots_infer=shots,
            circuit_conditioned=True, out_dir=None, extras=extras,
            log_fn=lambda m: None)
        torch.cuda.synchronize()
        tm["evaluate"] = time.perf_counter() - t0
        step_launches = ck.fused_chain_step.launches
        walk_launches = ck.fused_chain_walk.launches
        csv_path = os.path.join(exp, "metrics.csv")
        write_metrics_csv(csv_path, out)
        with open(csv_path) as f:
            check(len(f.read().splitlines()) == c + 1, "metrics.csv rows")

    raw = np.array([r["raw_fidelity"] for r in out])
    d3pm = np.array([r["d3pm_fidelity"] for r in out])
    log("route", "stages (s): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in tm.items()))
    steps = c * 27 * 1024 // cfg.train.batch_size
    log("route", f"train: {steps} steps, {steps / tm['train']:.1f} steps/s")
    log("route", f"mean raw fidelity {raw.mean():.5f}, mean D3PM fidelity "
        f"{d3pm.mean():.5f} over {c} circuits")
    log("route", f"fused_chain_step.launches = {step_launches}, "
        f"fused_chain_walk.launches = {walk_launches}")
    check(step_launches == t_steps and walk_launches == 0,
          "evaluate launched the step kernel once per step and no walk")

    # The samples against the exact chain distribution of the model's own
    # tables, per (circuit, basis) row.
    samples = extras["samples"]
    check(tuple(samples.shape) == (c, 27, shots, n) and samples.is_cuda,
          "samples [50, 27, 5000, 3] on the card")
    t0 = time.perf_counter()
    tables = diff.grid_p1_tables(model, n, sched, num_circuits=c)
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
    packed = torch.stack([
        torch.arange(27, device="cuda").repeat_interleave(shots).repeat(c),
        torch.arange(c, device="cuda").repeat_interleave(27 * shots)], -1)
    # evaluate's sampling again on the same inputs, split into the table
    # precompute and the T chain updates (twice: the second run is warm).
    splits = []
    for rep in range(2):
        split: dict = {}
        diff.p_sample_grid(torch.Generator(device="cuda").manual_seed(1 + rep),
                           model, packed, n, sched, num_circuits=c,
                           timings=split)
        splits.append(split)
    split = splits[-1]
    path_ms = split["steps"] * 1e3 / t_steps
    rest = tm["evaluate"] - split["tables"] - split["steps"]
    log("route", f"evaluate's sampling alone: tables {split['tables']:.4f} s "
        f"(grid_p1_tables on its own {t_tables:.4f} s), the {t_steps} chain "
        f"updates {split['steps']:.4f} s = {path_ms:.4f} ms a step on the "
        f"path (first run {splits[0]['steps'] * 1e3 / t_steps:.4f}); "
        f"reconstruction and metrics of {c} circuits take the rest of "
        f"{tm['evaluate']:.4f} s, about {rest:.4f} s")
    tables = tables.reshape(t_steps, c * 27, 2**n, n)
    exact = exact_walk(tables, torch.full((c * 27, 2**n), 1 / 2**n,
                                          device="cuda"))
    idx = (samples.long() * (1 << torch.arange(n, device="cuda"))).sum(-1)
    tv = tv_rows(idx.reshape(c * 27, shots), exact)
    bound = 4 * math.sqrt(2**n / (2 * math.pi * shots))
    check(bool((tv < bound).all()), f"samples TV {float(tv.max())} < {bound}")

    inv = pauli.make_counts_inverter(n)
    exact = exact.reshape(c, 27, 2**n)
    fid_exact = np.array([
        float(M.state_fidelity(torch.from_numpy(r.clean_state).cuda(),
                               inv((exact[i] * shots).float())))
        for i, r in enumerate(eval_recs)
    ])
    delta = np.abs(d3pm - fid_exact)
    log("route", f"samples vs exact chain: max TV {float(tv.max()):.5f} < "
        f"{bound:.5f} over {c * 27} rows; D3PM fidelity vs exact-chain "
        f"inversion: mean |diff| {delta.mean():.5f}, max {delta.max():.5f}")
    check(delta.mean() < 0.01 and delta.max() < 0.03,
          "D3PM fidelities within 0.01 (mean) / 0.03 (max) of the exact chain")

    raw_cpu = np.array([
        float(M.state_fidelity(
            r.clean_state,
            ev._reconstruct_counts(n, r.basis_labels, r.counts, "linear",
                                   0.0)))
        for r in eval_recs
    ])
    err = float(np.abs(raw - raw_cpu).max())
    log("route", f"raw fidelity card vs CPU inversion: max abs err {err:.2e}")
    check(err < 1e-4, "raw fidelities match the CPU's within 1e-4")
    for i in range(c):
        check_rho(extras["rho_raw"][i], f"raw rho {i}")
        check_rho(extras["rho_d3pm"][i], f"D3PM rho {i}")
    log("route", f"all {2 * c} rho: trace 1, Hermitian, PSD")
    return step_launches, path_ms


# ``cli generate``'s defaults (ddqst_tpu_torch/cli.py): 10,000 circuits of
# N=3 at depths 2-10, 1,024 shots, chunks of 500, max_bases 50 (N=3 has 27
# bases, so every record holds all of them), seed 0. Phase generate runs the
# CLI at these defaults and checks that it produced them.
GENERATE_SAMPLES, GENERATE_CHUNK, GENERATE_QUBITS = 10_000, 500, 3
GENERATE_DEPTHS, GENERATE_SHOTS = (2, 10), 1024
GENERATE_TV_CIRCUITS = 500


def generate_argv(out_dir: str, noise_type: str) -> list[str]:
    return ["generate", "--out_dir", out_dir, "--noise", noise_type]


def _timed(owner, name: str, acc: dict, restore: list) -> None:
    """Replace ``owner.name`` by a wrapper adding its seconds and calls to
    ``acc[name]``; ``restore`` collects the originals."""
    real = getattr(owner, name)
    acc[name] = {"s": 0.0, "calls": 0}

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            acc[name]["s"] += time.perf_counter() - t0
            acc[name]["calls"] += 1

    setattr(owner, name, wrapper)
    restore.append((owner, name, real))


def exact_counts_probs(qc, labels: np.ndarray, ncfg) -> np.ndarray:
    """``[B, 2^N]`` Born probabilities of ``qc`` in each basis after the
    noise (the density matrix under gate noise, else the statevector), by
    the port's numpy path, then the readout channel."""
    from ddqst_tpu_torch.qsim import measure, noise, states

    n = qc.num_qubits
    rots = measure.rotation_unitaries(labels)
    if ncfg.has_gate_noise:
        rho = noise.simulate_density_matrix(qc, ncfg)
        probs = np.einsum("bij,jk,bik->bi", rots, rho, rots.conj()).real
    else:
        probs = np.abs(rots @ states.circuit_statevector(qc)) ** 2
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    return noise.apply_readout_to_probs(
        torch.from_numpy(probs), n, ncfg.readout_p).numpy()


def phase_generate(engine_build_s: float) -> dict:
    """Phase-4 ``cli generate`` at its defaults under torino and readout
    noise, through ``cli.main`` (and once more as ``python -m``, which must
    add no shard); the C++ engine against the numpy path on the same
    10,000 circuits."""
    from ddqst_tpu_torch import cli
    from ddqst_tpu_torch.data import generate as gen
    from ddqst_tpu_torch.data.records import load_dataset
    from ddqst_tpu_torch.qsim import native_engine, noise, states

    t_phase = time.perf_counter()
    c, n, shots = GENERATE_SAMPLES, GENERATE_QUBITS, GENERATE_SHOTS
    parts = -(-c // GENERATE_CHUNK)
    out: dict = {"circuits": c, "num_qubits": n, "shards": parts,
                 "shots": shots, "builds": {}}
    built: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for noise_type in ("torino", "readout"):
            ds = os.path.join(tmp, noise_type)
            stages: dict = {}
            restore: list = []
            for owner, name in ((gen, "_unique_circuits"),
                                (gen, "_simulate_chunk"),
                                (noise, "simulate_density_matrix"),
                                (native_engine, "statevectors"),
                                (gen, "_records"), (gen, "save_shard")):
                _timed(owner, name, stages, restore)
            try:
                t0 = time.perf_counter()
                rc = cli.main(generate_argv(ds, noise_type))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for owner, name, real in restore:
                    setattr(owner, name, real)
            check(rc == 0, f"cli generate --noise {noise_type} exit 0")
            ncfg = noise.get_noise_config(noise_type)
            calls = stages["statevectors"]["calls"]
            want_calls = parts * (1 if ncfg.has_gate_noise else 2)
            log("generate", f"{noise_type}: {c} circuits in {wall:.4f} s; "
                + ", ".join(f"{k} {v['s']:.4f} s / {v['calls']} calls"
                            for k, v in stages.items()))
            check(calls == want_calls,
                  f"{noise_type}: {calls} engine calls, want {want_calls}")
            shards = sorted(f for f in os.listdir(ds) if f.endswith(".npz"))
            check(len(shards) == parts, f"{noise_type}: {parts} shards")
            t0 = time.perf_counter()
            records = load_dataset(ds)
            load_s = time.perf_counter() - t0
            log("generate", f"{noise_type}: load_dataset {load_s:.4f} s")
            check(sorted(r.id for r in records) == list(range(c)),
                  f"{noise_type}: ids 0..{c - 1}")
            check(len({r.hash for r in records}) == c,
                  f"{noise_type}: hashes unique")
            lo, hi = GENERATE_DEPTHS
            check(all(lo <= r.depth <= hi for r in records),
                  f"{noise_type}: depths {lo}-{hi}")
            counts = np.stack([r.counts for r in records])
            check(counts.shape == (c, 3**n, 2**n)
                  and bool((counts.sum(-1) == shots).all()),
                  f"{noise_type}: every count row sums to {shots}")
            built[noise_type] = (ds, ncfg, {r.id: r for r in records})
            out["builds"][noise_type] = dict(
                wall_s=wall, engine_calls=calls, load_dataset_s=load_s,
                stages_s={k: v["s"] for k, v in stages.items()},
                stage_calls={k: v["calls"] for k, v in stages.items()})

        # The second call, as a user types it: resumes and adds nothing.
        ds = built["torino"][0]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ddqst_tpu_torch.cli",
             *generate_argv(ds, "torino")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600, check=False)
        resume_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m ddqst_tpu_torch.cli generate "
              f"again: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        check(len([f for f in os.listdir(ds) if f.endswith(".npz")]) == parts
              and "saved" not in proc.stdout,
              "a second cli generate adds no shard")
        log("generate", f"python -m ddqst_tpu_torch.cli generate again: "
            f"{resume_s:.4f} s, no shard added")
        out["resume_s"] = resume_s

        # The same circuits, drawn again from the seed (the basis plan draws
        # nothing at N=3, so one draw of 10,000 equals the chunks' draws).
        pool = gen._unique_circuits(np.random.default_rng(0), c, n,
                                    *GENERATE_DEPTHS, set())
        circuits = [qc for qc, _ in pool]
        by_id = built["torino"][2]
        check([h for _, h in pool] == [by_id[i].hash for i in range(c)],
              "the seed's circuits are the records' circuits")
        times: dict = {True: [], False: []}
        psis = {}
        for prefer_native in (True, False, False, True):
            t0 = time.perf_counter()
            psis[prefer_native] = states.batch_statevectors(
                circuits, prefer_native=prefer_native)
            times[prefer_native].append(time.perf_counter() - t0)
        native, plain = psis[True], psis[False]
        err = float(np.abs(native - plain).max())
        norm_err = float(np.abs(np.linalg.norm(native, axis=1) - 1).max())
        clean = {k: np.stack([b[2][i].clean_state for i in range(c)])
                 for k, b in built.items()}
        check(all(np.array_equal(v, native) for v in clean.values()),
              "every record's clean state is the engine's, bit for bit")
        check(err < 2e-6 and norm_err < 1e-5,
              f"engine vs numpy path: max abs err {err:.2e} < 2e-6, norms "
              f"within {norm_err:.2e} < 1e-5")
        log("generate", f"batch_statevectors on {c} circuits: engine "
            f"{times[True]} s, numpy path {times[False]} s; max abs err "
            f"{err:.2e}, norms within {norm_err:.2e}")

        # Counts against the exact Born probabilities after readout, on
        # circuits spread over every shard.
        bound = 4 * math.sqrt(2**n / (2 * math.pi * shots))
        tvs = {}
        for noise_type, (_, ncfg, recs) in built.items():
            ids = range(0, c, c // GENERATE_TV_CIRCUITS)
            tv = np.stack([
                0.5 * np.abs(recs[i].counts / shots - exact_counts_probs(
                    circuits[i], recs[i].basis_labels.astype(np.int64), ncfg)
                ).sum(-1) for i in ids])
            tvs[noise_type] = float(tv.max())
            log("generate", f"{noise_type}: counts vs exact probabilities on "
                f"{len(ids)} circuits: max TV {tv.max():.5f}, mean "
                f"{tv.mean():.5f} < {bound:.5f} over {tv.size} rows")
            check(bool((tv < bound).all()),
                  f"{noise_type}: counts TV {tv.max()} < {bound}")
    out["max_tv"] = tvs
    out["phase_s"] = time.perf_counter() - t_phase
    log("generate", f"phase {out['phase_s']:.4f} s")
    engine = {
        "name": "statevectors",
        "route": "host C++ (g++ -O3)",
        "source": "ddqst_tpu_torch/csrc/statevec.cc",
        "replaces": "ddqst_tpu/qsim/native_engine.py:101",
        "circuits": c, "num_qubits": n,
        "calls": {k: v["engine_calls"] for k, v in out["builds"].items()},
        "s": times[True], "numpy_s": times[False],
        "max_abs_err": err, "max_norm_err": norm_err,
        "build_s": engine_build_s,
    }
    print(json.dumps({"native_host_code": [engine], "generate": out}),
          flush=True)
    return out


# The reference's seed-0 scores for the two recipes (its round-5 bench on a
# TPU; fidelities only, no time of that run is used anywhere).
REFERENCE_FIDELITY = {
    "ghz": dict(fidelity=0.99638, raw_fidelity=0.95785,
                raw_fidelity_mitigated=0.99986),
    "rqc": dict(fidelity=0.99811),
}
# (CE epochs, distillation steps) of the default run; the recipe's own depth
# is ``ddqst_tpu_torch.bench.FULL_DEPTH``, 300 epochs and up to 800 steps
# (--full-depth, --bench).
# Sized for a slow host: a distillation step is bound by the host's launches
# and took 0.67 to 1.48 s on the machines it was measured on. Cut to this
# depth so the script stays near 450 s on such a host before its `scaling`
# phase. At 10 epochs and 10 steps GHZ-3's held-out selection kept step 0
# on the card and its chain CE did not fall.
DISTILL_DEPTH = {"ghz": (20, 25), "rqc": (3, 25)}


def check_chain_equals_tables(model, sched, exact, what: str) -> torch.Tensor:
    """``chain_distribution`` of ``model`` against the float64 propagation of
    its own grid tables, within 1e-5 per entry; returns it ``[27, 8]``."""
    from ddqst_tpu_torch.ops import diffusion as diff

    dist = diff.sampler_distribution(model, 3, sched, exact=exact)
    tables = diff.grid_p1_tables(model, 3, sched, exact=exact)
    ref = exact_walk(tables.reshape(sched.num_timesteps, 27, 8, 3),
                     torch.full((27, 8), 1 / 8, device="cuda"))
    err = float((dist.double() - ref).abs().max())
    log("distill", f"{what}: chain_distribution vs the propagation of "
        f"grid_p1_tables: max abs err {err:.2e}")
    check(tuple(dist.shape) == (27, 8) and dist.is_cuda and err < 1e-5,
          f"{what}: chain_distribution equals the table propagation in 1e-5")
    return dist


def run_recipe(ck, kind: str, seed: int, depth: tuple[int, int]) -> dict:
    """One recipe through ``run_experiment`` on the card, with its checks."""
    from ddqst_tpu_torch.bench import FULL_DEPTH, bench_recipe
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import run_experiment

    tag = f"{kind}3 seed {seed}"
    cfg = bench_recipe(kind, *depth)
    for what, got, full in (("num_epochs", depth[0], FULL_DEPTH[0]),
                            ("chain_finetune_steps", depth[1], FULL_DEPTH[1])):
        if got != full:
            log("distill", f"{tag}: CUT {what} {full} -> {got}")
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cfg, seed=seed, log_fn=lambda m: log("distill", m))
    wall = time.perf_counter() - t0
    walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
    check(walks == 1 and steps == 0,
          f"{tag}: one walk launch and no step launch ({walks}, {steps})")
    plan = ck.fused_chain_walk.last_plan

    info, tm = res["chain_info"], res["timings"]
    steps_run = len(res["ft_losses"])
    ms_step = tm["distill"] * 1e3 / steps_run
    log("distill", f"{tag}: wall {wall:.2f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()))
    log("distill", f"{tag}: train {res['train_steps']} steps, "
        f"{res['train_steps'] / tm['train']:.1f} steps/s; distillation ran "
        f"{steps_run} of {depth[1]} steps, {ms_step:.2f} ms a step (its "
        f"{len(info['val_history'])} held-out and 2 full-grid evaluations "
        f"included); chain CE {info['train_ce_before']:.5f} -> "
        f"{info['train_ce_after']:.5f}; held-out "
        f"{info['val_history'][0][1]:.5f} at step 0, best "
        f"{info['best_val_ce']:.5f} at step {info['best_step']}")
    check(info["train_ce_after"] < info["train_ce_before"],
          f"{tag}: distillation lowered the full-grid chain CE")
    check(info["best_val_ce"] <= info["val_history"][0][1],
          f"{tag}: the held-out best is no worse than step 0")
    check(np.isfinite(res["ft_losses"]).all(), f"{tag}: finite losses")

    rho = res["rho"]
    check(rho.shape == (8, 8), f"{tag}: rho is 8x8")
    check_rho(torch.from_numpy(rho), f"{tag}: rho")
    samples, shots = res["samples"], cfg.data.shots_infer
    check(tuple(samples.shape) == (27, shots, 3) and samples.is_cuda,
          f"{tag}: samples [27, {shots}, 3] on the card")
    sched = make_schedule("cosine", 100, "cuda")
    dist = check_chain_equals_tables(res["state"], sched, cfg.diffusion.exact,
                                     f"{tag}, distilled model")
    idx = (samples.long() * (1 << torch.arange(3, device="cuda"))).sum(-1)
    tv = tv_rows(idx, dist.double())
    bound = 4 * math.sqrt(8 / (2 * math.pi * shots))
    check(bool((tv < bound).all()), f"{tag}: samples TV {float(tv.max())} < "
          f"{bound}")
    target = torch.from_numpy(res["target"]).cuda()
    rec = mle.make_mle(3)
    fid_exact = float(M.state_fidelity(target, rec(dist * shots)))
    log("distill", f"{tag}: samples vs exact chain: max TV "
        f"{float(tv.max()):.5f} < {bound:.5f}; fidelity {res['fidelity']:.5f} "
        f"vs MLE of the exact chain distribution {fid_exact:.5f}")
    check(abs(res["fidelity"] - fid_exact) < 0.02,
          f"{tag}: fidelity within 0.02 of the exact chain's MLE")

    # One MLE solve's time: the generated samples' again, warm.
    counts = mle.bits_to_counts(samples)
    solve: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec(counts, solve)
    torch.cuda.synchronize()
    mle_s = time.perf_counter() - t0
    log("distill", f"{tag}: MLE iterations {res['mle_iterations']}; the "
        f"samples' solve again: {solve['iterations']} iterations in "
        f"{mle_s:.4f} s ({mle_s * 1e3 / solve['iterations']:.4f} ms each)")
    check(solve["iterations"] == res["mle_iterations"]["samples"],
          f"{tag}: the MLE solve repeats its iteration count")

    ref = REFERENCE_FIDELITY[kind]
    log("distill", f"{tag}: " + ", ".join(
        f"{k} {res[k]:.5f} (reference, uncut: {v:.5f})"
        for k, v in ref.items()))
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated"):
        check(math.isfinite(res[k]), f"{tag}: {k} finite")
    if kind == "ghz":
        check(res["raw_fidelity_mitigated"] >= 0.995,
              f"{tag}: MLE on the raw shots scores at least 0.995")
    return dict(
        kind=kind, seed=seed, epochs=depth[0], chain_steps=depth[1],
        fidelity=res["fidelity"], raw_fidelity=res["raw_fidelity"],
        raw_fidelity_mitigated=res["raw_fidelity_mitigated"],
        fidelity_exact_chain=fid_exact, steps_run=steps_run,
        best_step=info["best_step"], ce_before=info["train_ce_before"],
        ce_after=info["train_ce_after"], ms_per_distill_step=ms_step,
        mle_iterations=res["mle_iterations"], mle_solve_s=mle_s,
        timings=tm, wall_s=wall, walk_launches=walks,
        walk_threads=plan[0])


def phase_distill(ck, depth: dict, ghz_seeds: int = 1) -> list[dict]:
    """The bench recipes at full width; ``depth`` maps the recipe to its
    (CE epochs, distillation steps)."""
    from ddqst_tpu_torch.bench import bench_recipe
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.models.d3pm import init_params_
    from ddqst_tpu_torch.ops.schedules import make_schedule

    cfg = bench_recipe("ghz", *depth["ghz"])
    model = build_model(cfg.model, 3, 100).cuda()
    init_params_(model, torch.Generator(device="cuda").manual_seed(0))
    sched = make_schedule("cosine", 100, "cuda")
    for exact in (False, True):
        check_chain_equals_tables(
            model.eval(), sched, exact, "seeded model before distillation, "
            f"{'exact posterior' if exact else 'renoise'}")
    # Seed 0 of both recipes first, then GHZ-3's further seeds.
    order = [("ghz", 0), ("rqc", 0)] + [("ghz", s)
                                        for s in range(1, ghz_seeds)]
    runs = []
    for kind, seed in order:
        runs.append(run_recipe(ck, kind, seed, depth[kind]))
        log("distill", "result " + json.dumps(runs[-1]))
    return runs


def phase_bench(ck, distill: list[dict]) -> dict:
    """The port's bench (``ddqst_tpu_torch.bench``) on the card: its
    throughput parts at ``bench.py``'s full sizes (training at the ``rqc``
    width, ``sample_all_bases`` at 27 x 5,000 and at 27 x 37,037 chains
    with the CUDA walk demanded, the N=10 table sampler at 50 x 2,000), the
    quality keys from phase distill's recipe runs at their cut depth. With
    the launch counts set to 0 just before and read just after: each call
    of a sampling part launches the walk once and the step kernel never,
    the shadow part's on the ring body. Every throughput finite and
    positive. Prints the record on one line."""
    from ddqst_tpu_torch import bench

    dev = torch.device("cuda", torch.cuda.current_device())
    log("bench", "CUT: the quality keys from phase distill's runs ("
        + ", ".join(f"{k}3 {e} epochs / {s} steps" for k, (e, s)
                    in DISTILL_DEPTH.items())
        + f"; bench.py: {bench.FULL_DEPTH[0]} / {bench.FULL_DEPTH[1]}), "
        "GHZ-3 at seed 0 only (bench.py: seeds 0-2)")
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    parts = bench.measure_throughputs(
        dev, lambda rec: log("bench", json.dumps(rec)))
    walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
    for name, rec in parts.items():
        check(math.isfinite(rec["per_sec"]) and rec["per_sec_min"] > 0,
              f"bench {name}: throughput {rec['per_sec']} finite, its "
              f"minimum {rec['per_sec_min']} positive")
        if name == "train":
            check(rec["walk_launches"] == rec["step_launches"] == 0,
                  "bench train: no kernel launch")
            continue
        check(rec["walk_launches"] == rec["calls"]
              and rec["step_launches"] == 0,
              f"bench {name}: one walk launch and no step launch a call "
              f"({rec['walk_launches']}, {rec['step_launches']} in "
              f"{rec['calls']} calls)")
        log("bench", f"{name}: {rec['per_sec']:.1f} a second (median; min "
            f"{rec['per_sec_min']:.1f}), tables {rec['timings'].get('tables')}"
            f" s, walk {rec['timings'].get('walk')} s of one call; walk plan "
            f"{rec['plan']}; peak {rec['peak_gb']:.2f} GB")
    check(parts["shadow"]["plan"][3] == "ring",
          f"the shadow bench's walk took the ring body "
          f"({parts['shadow']['plan']})")
    check(walks == sum(parts[k]["calls"] for k in ("sampling", "walk_1m",
                                                    "shadow")) and steps == 0,
          f"bench: the launch counts ({walks}, {steps}) are the parts' calls")
    record = dict(bench.make_record(parts, bench.quality_keys(distill),
                                    bench.device_info(dev)),
                  quality=dict(source="phase distill", depth=DISTILL_DEPTH))
    print(json.dumps({"bench_record": record}), flush=True)
    return dict(record=record, parts=parts)


# The reference's N=10 rows at this preset's data (RESULTS.md, "N=10
# shadow-transformer preset", its round-2 runs on a TPU; quality numbers
# only, no time of those runs is used anywhere).
REFERENCE_SHADOW = {
    "30 epochs, exact posterior": dict(
        mean_tv_to_target=0.446, tv_shot_noise_floor=0.118,
        meas_tv_to_target=0.264, mean_marginal_error=0.044,
        classical_fidelity=0.678),
    "150 epochs, cosine LR, renoise": dict(
        mean_tv_to_target=0.213, tv_shot_noise_floor=0.118,
        meas_tv_to_target=0.264, mean_marginal_error=0.015,
        classical_fidelity=0.893),
    # The 300-basis recipe of scripts/run_shadow_scale.py (its TPU runs):
    # examples/results_shadow.jsonl:6, a training of its own, and :11, the
    # CE snapshot shadow_work/dist_seg_ce_params on the data cache
    # shadow_work/dist_seg_data.npz, which phase reference_shadow loads.
    "300 bases, 150 epochs (results_shadow.jsonl:6)": dict(
        mean_tv_to_target=0.1969, tv_shot_noise_floor=0.11949,
        meas_tv_to_target=0.2663, mean_marginal_error=0.01115,
        classical_fidelity=0.90386),
    "300 bases, the CE snapshot (results_shadow.jsonl:11)": dict(
        mean_tv_to_target=0.1983, tv_shot_noise_floor=0.11954,
        meas_tv_to_target=0.26626, mean_marginal_error=0.01144,
        classical_fidelity=0.90284),
}
REFERENCE_SNAPSHOT_ROW = "300 bases, the CE snapshot (results_shadow.jsonl:11)"
REFERENCE_TRAINING_ROWS = ("300 bases, 150 epochs (results_shadow.jsonl:6)",
                           REFERENCE_SNAPSHOT_ROW)
# Depth cuts of phase shadow, each printed: the preset's 30 CE epochs (also
# in phase shadow_n12) and the warm-started run's distillation steps (on an
# H100 a step takes about 3.5 s, each of its two full-grid CE evaluations
# about 14 s).
SHADOW_EPOCHS_CUT = 5
SHADOW_DISTILL_STEPS = 1


def phase_shadow(ck) -> dict:
    """The shadow route on the card: the ``shadow_transformer`` preset at
    full width, CE training cut to ``SHADOW_EPOCHS_CUT`` epochs, then a
    warm-started distillation run of ``SHADOW_DISTILL_STEPS``."""
    import dataclasses

    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import load_data_cache, run_experiment

    cfg = get_preset("shadow_transformer")
    log("shadow", f"CUT num_epochs {cfg.train.num_epochs} -> "
        f"{SHADOW_EPOCHS_CUT}")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                num_epochs=SHADOW_EPOCHS_CUT))
    n, t_steps, shots = (cfg.data.num_qubits, cfg.diffusion.num_timesteps,
                         cfg.data.shots_infer)
    with tempfile.TemporaryDirectory() as tmp:
        params, cache = (os.path.join(tmp, "shadow.pt"),
                         os.path.join(tmp, "data.npz"))
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        t0 = time.perf_counter()
        with _TablesKept() as kept:
            res = run_experiment(cfg, seed=0, params_save=params,
                                 data_cache=cache,
                                 log_fn=lambda m: log("shadow", m))
        wall = time.perf_counter() - t0
        walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
        plan = ck.fused_chain_walk.last_plan
        labels = load_data_cache(cache).basis_labels
        tm = res["timings"]
        log("shadow", f"wall {wall:.2f} s; stages (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in tm.items()))
        log("shadow", f"train: {res['train_steps']} steps, "
            f"{res['train_steps'] / tm['train']:.1f} steps/s")
        log("shadow", f"fused_chain_walk.launches = {walks} ({plan[0]} "
            f"threads a block, body {plan[3]}), fused_chain_step.launches = "
            f"{steps}")
        check(walks == 1 and steps == 0,
              "the shadow route launched the walk once and the step never")
        check(plan[3] == "ring", f"the shadow route's walk took the ring "
              f"body ({plan})")
        quality = ("mean_tv_to_target", "tv_shot_noise_floor",
                   "meas_tv_to_target", "mean_marginal_error",
                   "classical_fidelity")
        log("shadow", f"quality ({SHADOW_EPOCHS_CUT} epochs, renoise): "
            + ", ".join(f"{k} {res[k]:.5f}" for k in quality)
            + f", max_tv_to_target "
            f"{res['max_tv_to_target']:.5f}, max_marginal_error "
            f"{res['max_marginal_error']:.5f}, z_bias {res['z_bias']}")
        for what, ref in REFERENCE_SHADOW.items():
            log("shadow", f"reference ({what}): " + ", ".join(
                f"{k} {v:g}" for k, v in ref.items()))
        for k in quality + ("max_tv_to_target", "max_marginal_error"):
            check(math.isfinite(res[k]), f"shadow {k} finite")
        samples = res["samples"]
        check(tuple(samples.shape) == (100, shots, n) and samples.is_cuda,
              f"samples [100, {shots}, {n}] on the card")

        # The samples against the exact chain distribution of the tables
        # the walk read (the trained model's own), every basis.
        model, tables = res["state"], kept.tables
        sched = make_schedule("cosine", t_steps, "cuda")
        exact = cfg.diffusion.exact
        lab = torch.from_numpy(np.asarray(labels, np.int64)).cuda()
        g = 2**n
        dist = exact_walk(tables, torch.full((100, g), 1 / g, device="cuda"))
        idx = (samples.long() * (1 << torch.arange(n, device="cuda"))).sum(-1)
        tv = tv_rows(idx, dist)
        bound = 4 * math.sqrt(g / (2 * math.pi * shots))
        log("shadow", f"samples vs the exact chain of the tables the walk "
            f"read: TV mean {float(tv.mean()):.5f}, "
            f"max {float(tv.max()):.5f} < bound {bound:.5f} over 100 bases")
        check(bool((tv < bound).all()), f"shadow samples TV {float(tv.max())}"
              f" < {bound} for every basis")

        # A few table rows against a CPU recompute.
        cpu_model = build_model(cfg.model, n, t_steps)
        cpu_model.load_state_dict({k: v.cpu() for k, v in
                                   model.state_dict().items()})
        rows = [0, 37, 99]
        ts = torch.tensor([t_steps, t_steps // 2, 1])
        cpu_grid = (diff._unpack(torch.arange(g), n).repeat(len(rows), 1),
                    lab[rows].cpu().repeat_interleave(g, dim=0))
        with torch.no_grad():
            cpu_tab = diff._tables_for_ts(cpu_model.eval(), ts, n,
                                          sched.to("cpu"), exact,
                                          grid=cpu_grid)
        card = tables[(t_steps - ts).tolist()][:, rows].reshape(3, -1, n)
        tab_err = float((card.cpu() - cpu_tab).abs().max())
        log("shadow", f"tables card vs CPU, bases {rows} at t = "
            f"{ts.tolist()}: max abs err {tab_err:.2e}")
        check(tab_err < 1e-5, "shadow tables on the card match the CPU's")
        del tables, dist, kept.tables

        # A warm-started distillation run over minibatches of 10 bases.
        cfg2 = cfg.replace(train=dataclasses.replace(
            cfg.train, chain_finetune_steps=SHADOW_DISTILL_STEPS,
            chain_basis_batch=10, chain_val_fraction=0.0))
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        res2 = run_experiment(cfg2, seed=0, params_load=params,
                              data_cache=cache,
                              log_fn=lambda m: log("shadow", m))
        walks2 = ck.fused_chain_walk.launches
    info, tm2 = res2["chain_info"], res2["timings"]
    ms_step = tm2["distill"] * 1e3 / SHADOW_DISTILL_STEPS
    log("shadow", f"distillation, {SHADOW_DISTILL_STEPS} steps of 10 bases: "
        f"{ms_step:.1f} ms a step (its 2 full-grid CE evaluations over 100 "
        f"bases included); chain CE {info['train_ce_before']:.5f} -> "
        f"{info['train_ce_after']:.5f}; stages (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in tm2.items()))
    check(len(res2["ft_losses"]) == SHADOW_DISTILL_STEPS
          and np.isfinite(res2["ft_losses"]).all(),
          "the shadow distillation ran its steps with finite losses")
    check(math.isfinite(info["train_ce_after"]) and walks2 == 1,
          "the warm-started run generated through one walk launch")
    return dict(walk_launches=walks, walk_threads=plan[0],
                walk_plan=list(plan), wall_s=wall,
                timings=tm, train_steps=res["train_steps"],
                **{k: res[k] for k in quality}, max_tv_exact_chain=float(
                    tv.max()), table_err=tab_err, distill_ms_per_step=ms_step,
                distill_ce=(info["train_ce_before"], info["train_ce_after"]),
                distill_timings=tm2)


# Phase shadow_n12: the shadow_transformer preset with only its qubit count
# raised, and what it checks.
SHADOW_N12_QUBITS = 12
SHADOW_N12_TABLE_BASES = (0, 50, 99)
# 1,200 marginals (100 bases x 12 qubits) a run: at 4 scales a right sampler
# would fail about one run in 13, at 5 one in 1,700.
SHADOW_N12_MARGINAL_SCALES = 5


def exact_walk_by_products(tables: torch.Tensor,
                           init_dist: torch.Tensor) -> torch.Tensor:
    """:func:`exact_walk` as one float64 matrix product a (step, row): the
    transition's log is ``sum_q log(1 - p_q(x)) + y_q log(p_q(x) / (1 -
    p_q(x)))``, a ``[2^N, N] x [N, 2^N]`` product, so a step costs a few
    passes over ``[2^N, 2^N]`` where :func:`exact_walk` makes several for
    each of the N qubits. A probability of exactly 0 or 1 becomes 1e-300
    in the logarithms, which moves no mass a float64 sum keeps."""
    t_steps, c, g, n = tables.shape
    y = ((torch.arange(g, device=tables.device)[:, None]
          >> torch.arange(n, device=tables.device)) & 1).double()
    rows = max(1, (1 << 26) // (g * g))
    dist = init_dist.double().clone()
    for t in range(t_steps):
        for lo in range(0, c, rows):
            p1 = tables[t, lo:lo + rows].double()  # [rows, x, N]
            log1 = p1.clamp_min(1e-300).log_()
            log0 = (1 - p1).clamp_min_(1e-300).log_()
            trans = torch.matmul(log1 - log0, y.T)  # [rows, x, y]
            trans.add_(log0.sum(-1, keepdim=True)).exp_()
            dist[lo:lo + rows] = torch.einsum("cx,cxy->cy", dist[lo:lo + rows],
                                              trans)
    return dist


def phase_shadow_n12(ck, shadow: dict) -> dict:
    """The shadow route at N = 12 on the card: ``run_experiment`` on the
    ``shadow_transformer`` preset with only ``data.num_qubits`` set to 12,
    everything else the preset's, at full width (100 sampled bases of 1,024
    shots, RQC depth 8, readout noise, transformer 128 / 512 / 4 blocks / 4
    heads, T=100, cosine, renoise, 5,000 generated shots a basis) and its
    training cut to ``SHADOW_EPOCHS_CUT`` of 30 epochs, with the launch
    counts set to 0 just before and read just after. Since 5,000 shots >=
    2^12 the route builds the tables over the 409,600-row label grid (1.97
    GB) and walks them in one
    launch of the gather body. Checks: (a) one walk launch on the gather
    body and no step launch; (b) every basis' samples
    against the exact chain of the tables the walk read: TV within 4
    shot-noise scales (at 2^12 outcomes and 5,000 shots that bound exceeds
    1 and says nothing), every per-qubit marginal within
    ``SHADOW_N12_MARGINAL_SCALES`` noise scales,
    and the mean over the bases of the TV less that of a multinomial draw
    of the same size from the exact chain within 4 standard errors of 0;
    (c) table rows of a few bases at t = 100, 50, 1 within 1e-5 of a CPU
    recompute; (d) the walk on the route's tables bit for bit against its
    plain version, and timed. It prints the stage seconds, the peak memory
    and the quality metrics beside phase shadow's at N = 10."""
    import dataclasses

    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import load_data_cache, run_experiment

    phase = "shadow_n12"
    base = get_preset("shadow_transformer")
    log(phase, f"CUT num_epochs {base.train.num_epochs} -> "
        f"{SHADOW_EPOCHS_CUT}")
    cfg = base.replace(
        data=dataclasses.replace(base.data, num_qubits=SHADOW_N12_QUBITS),
        train=dataclasses.replace(base.train, num_epochs=SHADOW_EPOCHS_CUT))
    n, t_steps, shots = (cfg.data.num_qubits, cfg.diffusion.num_timesteps,
                         cfg.data.shots_infer)
    g = 2**n
    kept = []
    assembled = diff._assembled_tables

    def keep(*args, **kwargs):
        kept.append(assembled(*args, **kwargs))
        return kept[-1]

    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "data.npz")
        diff._assembled_tables = keep
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
            t0 = time.perf_counter()
            res = run_experiment(cfg, seed=0, data_cache=cache,
                                 log_fn=lambda m: log(phase, m))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walks = ck.fused_chain_walk.launches
            steps = ck.fused_chain_step.launches
            plan = ck.fused_chain_walk.last_plan
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
        finally:
            diff._assembled_tables = assembled
        labels = load_data_cache(cache).basis_labels
    tm = res["timings"]
    log(phase, f"wall {wall:.2f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()))
    log(phase, f"train: {res['train_steps']} steps, "
        f"{res['train_steps'] / tm['train']:.1f} steps/s; peak memory "
        f"{peak_gb:.3f} GB")
    log(phase, f"fused_chain_walk.launches = {walks} (plan {plan}), "
        f"fused_chain_step.launches = {steps}")
    # (a)
    check(walks == 1 and steps == 0 and len(kept) == 1,
          f"{phase}: one walk launch ({walks}), no step launch ({steps}), "
          f"one table build ({len(kept)})")
    check(plan[3] == "gather", f"{phase}: the walk took the gather body "
          f"({plan})")
    tables, samples = kept[0], res["samples"]
    c = samples.shape[0]
    check(tuple(tables.shape) == (t_steps, 100, g, n)
          and tuple(samples.shape) == (100, shots, n) and samples.is_cuda,
          f"{phase}: tables {tuple(tables.shape)} and samples "
          f"{tuple(samples.shape)} cover the 100 bases on the card")
    quality = ("mean_tv_to_target", "tv_shot_noise_floor",
               "meas_tv_to_target", "mean_marginal_error",
               "classical_fidelity", "max_tv_to_target", "max_marginal_error")
    for k in quality:
        check(math.isfinite(res[k]), f"{phase}: {k} finite")
    log(phase, "quality at N=12: " + ", ".join(
        f"{k} {res[k]:.5f}" for k in quality) + f", z_bias {res['z_bias']}")
    log(phase, "quality at N=10 (phase shadow): " + ", ".join(
        f"{k} {shadow[k]:.5f}" for k in quality if k in shadow))

    # (b) The samples against the exact chain of the tables the walk read;
    # the matrix-product propagation first held against exact_walk's on two
    # bases.
    uniform = torch.full((c, g), 1.0 / g, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist = exact_walk_by_products(tables, uniform)
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    check_err = float((exact_walk(tables[:, :2], uniform[:2])
                       - dist[:2]).abs().max())
    log(phase, f"exact chain by products in {t_exact:.2f} s; against "
        f"exact_walk on bases 0-1: max abs diff {check_err:.2e}")
    check(check_err < 1e-9, f"{phase}: the two exact propagations agree")
    idx = (samples.long() * (1 << torch.arange(n, device="cuda"))).sum(-1)
    tv = tv_rows(idx, dist)
    bound = 4 * math.sqrt(g / (2 * math.pi * shots))
    check(bool((tv < bound).all()), f"{phase}: samples TV {float(tv.max())} "
          f"< {bound} for every basis")
    bits = ((torch.arange(g, device="cuda")[:, None]
             >> torch.arange(n, device="cuda")) & 1).double()
    want = dist @ bits  # [C, N] exact per-qubit marginals
    got = samples.double().mean(1)
    scale = ((want * (1 - want)).clamp_min(1.0 / shots) / shots).sqrt()
    z = ((got - want).abs() / scale).max()
    gen = torch.Generator(device="cuda").manual_seed(12)
    draws = torch.multinomial(dist.float(), shots, replacement=True,
                              generator=gen)
    excess = tv - tv_rows(draws, dist)
    mean_ex = float(excess.mean())
    se_ex = float(excess.std()) / math.sqrt(c)
    log(phase, f"samples vs the exact chain: TV mean {float(tv.mean()):.5f}, "
        f"max {float(tv.max()):.5f} (bound {bound:.5f}); marginals within "
        f"{float(z):.3f} noise scales (bound {SHADOW_N12_MARGINAL_SCALES}); "
        f"TV less a multinomial "
        f"draw's: mean {mean_ex:.5f}, standard error {se_ex:.5f}")
    check(float(z) < SHADOW_N12_MARGINAL_SCALES, f"{phase}: every per-qubit "
          f"marginal within {SHADOW_N12_MARGINAL_SCALES} noise scales of the "
          "exact chain's")
    check(abs(mean_ex) < 4 * se_ex, f"{phase}: the samples' TV exceeds a "
          f"multinomial draw's by {mean_ex:.5f}, within 4 x {se_ex:.5f}")

    # (c) A few table rows against a CPU recompute.
    model = res["state"]
    sched = make_schedule(cfg.diffusion.schedule, t_steps, "cuda")
    lab = torch.from_numpy(np.asarray(labels, np.int64))
    cpu_model = build_model(cfg.model, n, t_steps)
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    rows = list(SHADOW_N12_TABLE_BASES)
    ts = torch.tensor([t_steps, t_steps // 2, 1])
    cpu_grid = (diff._unpack(torch.arange(g), n).repeat(len(rows), 1),
                lab[rows].repeat_interleave(g, dim=0))
    with torch.no_grad():
        cpu_tab = diff._tables_for_ts(cpu_model.eval(), ts, n,
                                      sched.to("cpu"), cfg.diffusion.exact,
                                      grid=cpu_grid)
    card = tables[(t_steps - ts).tolist()][:, rows].reshape(len(ts), -1, n)
    tab_err = float((card.cpu() - cpu_tab).abs().max())
    log(phase, f"tables card vs CPU, bases {rows} at t = {ts.tolist()}: max "
        f"abs err {tab_err:.2e}")
    check(tab_err < 1e-5, f"{phase}: tables on the card match the CPU's")

    # (d) The walk on the route's tables against its plain version.
    init = torch.randint(0, g, (c, shots), generator=gen, device="cuda",
                         dtype=torch.int32)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(ck.fused_chain_walk_reference(
        5, tables, init, n)), 1)
    out = ck.fused_chain_walk(5, tables, init, n)
    kernel_plan = ck.fused_chain_walk.last_plan
    err = float((out - plain[-1]).abs().max())
    check(torch.equal(out, plain[-1]), f"{phase}: kernel == plain bit for "
          f"bit on the route's tables")
    ms = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, n), 10)
    wb, by = walk_bound_ms(t_steps, c, n, shots)
    log(phase, f"walk on the route's tables (T={t_steps}, C={c}, N={n}, "
        f"S={shots}): kernel {ms:.4f} ms (plan {kernel_plan}), plain "
        f"{plain_ms:.3f} ms, bound {wb:.4f} ms ({by}), {ms / wb:.2f} x "
        "bound; == plain bit for bit")
    return dict(walk_launches=walks, step_launches=steps, walk_plan=list(plan),
                wall_s=wall, timings=tm, train_steps=res["train_steps"],
                peak_gb=peak_gb, **{k: res[k] for k in quality},
                max_tv_exact_chain=float(tv.max()), marginal_z=float(z),
                tv_excess=mean_ex, tv_excess_se=se_ex, exact_s=t_exact,
                table_err=tab_err,
                kernel=dict(ms=ms, plain_ms=plain_ms, bound_ms=wb, bound_by=by,
                            max_abs_err=err, plan=list(kernel_plan)))


# The reference's own N=10 shadow recipe, model and data: the recipe is
# ``campaigns.shadow_scale.make_cfg("dist_seg", max_bases=300)``, the model
# that recipe's 150-epoch CE snapshot, converted from orbax by
# ``tools/flax_to_torch.py``.
REFERENCE_SHADOW_PARAMS = "examples/reference_params/dist_seg_ce_params.pt"
REFERENCE_SHADOW_DATA = "shadow_work/dist_seg_data.npz"
# Further walks of the same tables; their spread is each metric's shot-noise
# standard deviation.
REFERENCE_SHADOW_WALKS = 8
SHADOW_METRICS = ("mean_tv_to_target", "mean_marginal_error",
                  "classical_fidelity")
# --shadow-reference-train against the mean of REFERENCE_TRAINING_ROWS: the
# mean TV within REFERENCE_TRAIN_TV_TOL, the marginal error at most, the
# classical fidelity at least.
REFERENCE_TRAIN_TV_TOL = 0.01
REFERENCE_TRAIN_MARGINAL_MAX = 0.015
REFERENCE_TRAIN_CF_MIN = 0.89


def reference_shadow_cfg():
    """``scripts/run_shadow_scale.py``'s ``make_cfg("dist_seg",
    max_bases=300)``, from the port's ``campaigns.shadow_scale``."""
    from ddqst_tpu_torch.campaigns.shadow_scale import make_cfg

    return make_cfg("dist_seg", max_bases=300)


def repo_file(rel: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)


def reference_shadow_run(ck, phase: str, **kw) -> dict:
    """``run_experiment(reference_shadow_cfg(), seed=0, **kw)`` on a
    temporary copy of the reference's data cache, with the launch counts set
    to 0 just before and read just after. Returns the results (``res``),
    the tables the walk read (kept from ``_assembled_tables``), the data,
    the launches and the wall seconds; checks the plan (one walk launch,
    the ring body, no step launch) and every basis' samples against the
    exact chain of those tables (TV within 4 shot-noise scales)."""
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.pipeline import load_data_cache, run_experiment

    kept = []
    assembled = diff._assembled_tables

    def keep(*args, **kwargs):
        kept.append(assembled(*args, **kwargs))
        return kept[-1]

    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "data.npz")
        shutil.copyfile(repo_file(REFERENCE_SHADOW_DATA), cache)
        diff._assembled_tables = keep
        try:
            ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
            t0 = time.perf_counter()
            res = run_experiment(reference_shadow_cfg(), seed=0,
                                 data_cache=cache,
                                 log_fn=lambda m: log(phase, m), **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            walks = ck.fused_chain_walk.launches
            steps = ck.fused_chain_step.launches
            plan = ck.fused_chain_walk.last_plan
        finally:
            diff._assembled_tables = assembled
        data = load_data_cache(cache)
    tm = res["timings"]
    log(phase, f"wall {wall:.2f} s; stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in tm.items()))
    log(phase, f"fused_chain_walk.launches = {walks} ({plan[0]} threads a "
        f"block, body {plan[3]}), fused_chain_step.launches = {steps}")
    check(walks == 1 and steps == 0 and len(kept) == 1,
          f"{phase}: one walk launch ({walks}), no step launch ({steps}), "
          f"one table build ({len(kept)})")
    check(plan[3] == "ring", f"{phase}: the walk took the ring body ({plan})")
    tables = kept[0]
    c, shots, n = res["samples"].shape
    check(tuple(tables.shape) == (100, 300, 2**n, n) and c == 300
          and shots == 5000 and res["samples"].is_cuda,
          f"{phase}: tables {tuple(tables.shape)} and samples "
          f"{tuple(res['samples'].shape)} cover all 300 bases on the card")
    for k in SHADOW_METRICS + ("tv_shot_noise_floor", "meas_tv_to_target"):
        check(math.isfinite(res[k]), f"{phase}: {k} finite")
    dist = samples_vs_tables(phase, "the run's samples", res["samples"],
                             tables, torch.full((c, 2**n), 2.0**-n,
                                                device="cuda"))
    return dict(res=res, tables=tables, dist=dist, data=data, wall=wall,
                walks=walks, plan=plan)


def phase_reference_shadow(ck) -> dict:
    """The port's shadow route at full width on the reference's own model
    (``params_load``), data cache and recipe; see the module docstring."""
    import dataclasses

    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.mle import bits_to_counts
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import shadow_metrics
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    phase = "reference_shadow"
    cfg = reference_shadow_cfg()
    params = repo_file(REFERENCE_SHADOW_PARAMS)
    run = reference_shadow_run(ck, phase, params_load=params)
    res, tables, data = run["res"], run["tables"], run["data"]
    ref = REFERENCE_SHADOW[REFERENCE_SNAPSHOT_ROW]
    _, c, g, n = tables.shape
    t_steps, shots = cfg.diffusion.num_timesteps, cfg.data.shots_infer

    # (b) What depends on the data cache alone equals the reference's row.
    for k in ("tv_shot_noise_floor", "meas_tv_to_target"):
        log(phase, f"{k}: {res[k]:.7f} (reference {ref[k]})")
        check(round(res[k], 5) == ref[k], f"{phase}: {k} {res[k]:.7f} rounds "
              f"to the reference's {ref[k]}")

    # (d) The sampled metrics against the reference's row, within 4 sigma
    # (sigma: the spread over further walks of these tables) plus delta
    # (the exact chain's metric at float32 against bfloat16 compute, which
    # brackets the precision of the reference's matmuls on its TPU).
    meas = bits_to_counts(data.bits).cpu().numpy()
    clean = np.asarray(data.clean_probs)

    def metrics(counts: np.ndarray) -> dict:
        return shadow_metrics(counts, meas, clean, shots, n)

    gen = torch.Generator(device="cuda").manual_seed(2024)
    walks = []
    for _ in range(REFERENCE_SHADOW_WALKS):
        init = torch.randint(0, g, (c, shots), generator=gen, device="cuda",
                             dtype=torch.int32)
        seed = int(torch.randint(0, 2**63 - 1, (), generator=gen,
                                 device="cuda"))
        idx = ck.fused_chain_walk(seed, tables, init, n)
        walks.append(metrics(hist_rows(idx, g).cpu().numpy()))
    sigma = {k: float(np.std([w[k] for w in walks], ddof=1))
             for k in SHADOW_METRICS}
    exact32 = metrics(run["dist"].cpu().numpy())
    model_bf = build_model(dataclasses.replace(cfg.model, dtype="bfloat16"),
                           n, t_steps).cuda()
    restore_params(params, model_bf).eval()
    sched = make_schedule(cfg.diffusion.schedule, t_steps, "cuda")
    lab = torch.from_numpy(np.asarray(data.basis_labels, np.int64)).cuda()
    grid = (diff._unpack(torch.arange(g, device="cuda"), n).repeat(c, 1),
            lab.repeat_interleave(g, dim=0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables_bf = diff._assembled_tables(model_bf, n, sched,
                                       cfg.diffusion.exact, grid, 1 << 18,
                                       1 << 16)
    torch.cuda.synchronize()
    t_bf = time.perf_counter() - t0
    dist_bf = exact_walk(tables_bf, torch.full((c, g), 1 / g, device="cuda"))
    exact_bf = metrics(dist_bf.cpu().numpy())
    del tables_bf, dist_bf, model_bf
    delta = {k: abs(exact32[k] - exact_bf[k]) for k in SHADOW_METRICS}
    margin = {k: 4 * sigma[k] + delta[k] for k in SHADOW_METRICS}
    log(phase, f"bfloat16 tables in {t_bf:.2f} s")
    for k in SHADOW_METRICS:
        log(phase, f"{k}: port {res[k]:.5f}, reference {ref[k]} (row 11), "
            f"|diff| {abs(res[k] - ref[k]):.5f} <= margin {margin[k]:.5f} "
            f"(4 sigma {4 * sigma[k]:.5f}, sigma over "
            f"{REFERENCE_SHADOW_WALKS} walks {sigma[k]:.5f}; delta "
            f"{delta[k]:.5f}: exact chain float32 {exact32[k]:.5f}, "
            f"bfloat16 {exact_bf[k]:.5f})")
    for what, row in REFERENCE_SHADOW.items():
        log(phase, f"reference ({what}): " + ", ".join(
            f"{k} {v:g}" for k, v in row.items()))
    for k in SHADOW_METRICS:
        check(abs(res[k] - ref[k]) <= margin[k],
              f"{phase}: {k} {res[k]:.5f} within {margin[k]:.5f} of the "
              f"reference's {ref[k]}")

    # (e) A few table rows on the card against a CPU recompute of the
    # snapshot.
    cpu_model = restore_params(params, build_model(cfg.model, n, t_steps))
    rows = [0, 150, 299]
    ts = torch.tensor([t_steps, t_steps // 2, 1])
    cpu_grid = (grid[0][:g].cpu().repeat(len(rows), 1),
                lab[rows].cpu().repeat_interleave(g, dim=0))
    with torch.no_grad():
        cpu_tab = diff._tables_for_ts(cpu_model.eval(), ts, n,
                                      sched.to("cpu"), cfg.diffusion.exact,
                                      grid=cpu_grid)
    card = tables[(t_steps - ts).tolist()][:, rows].reshape(len(ts), -1, n)
    tab_err = float((card.cpu() - cpu_tab).abs().max())
    log(phase, f"tables card vs CPU, bases {rows} at t = {ts.tolist()}: max "
        f"abs err {tab_err:.2e}")
    check(tab_err < 1e-5, f"{phase}: tables on the card match the CPU's")

    # The walk kernel at this shape against its plain version, and timed.
    init = torch.randint(0, g, (c, shots), generator=gen, device="cuda",
                         dtype=torch.int32)
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(ck.fused_chain_walk_reference(
        5, tables, init, n)), 1)
    out = ck.fused_chain_walk(5, tables, init, n)
    kernel_plan = ck.fused_chain_walk.last_plan
    err = float((out - plain[-1]).abs().max())
    check(torch.equal(out, plain[-1]), f"{phase}: kernel == plain bit for "
          f"bit at T={t_steps} C={c} N={n} S={shots}")
    ms = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, n), 20)
    bound, by = walk_bound_ms(t_steps, c, n, shots)
    log(phase, f"walk at T={t_steps}, C={c}, N={n}, S={shots} "
        f"({tables.numel() * 4 / 1e9:.3f} GB of tables): kernel {ms:.4f} ms "
        f"(plan {kernel_plan}), plain {plain_ms:.3f} ms, bound {bound:.4f} "
        f"ms ({by}), {ms / bound:.2f} x bound; == plain bit for bit")
    return dict(walk_launches=run["walks"], walk_plan=list(run["plan"]),
                wall_s=run["wall"], timings=res["timings"],
                **{k: res[k] for k in SHADOW_METRICS + (
                    "tv_shot_noise_floor", "meas_tv_to_target",
                    "max_tv_to_target", "max_marginal_error")},
                sigma=sigma, delta=delta, margin=margin,
                exact_chain_float32=exact32, exact_chain_bfloat16=exact_bf,
                bf16_tables_s=t_bf, table_err=tab_err,
                kernel=dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, max_abs_err=err,
                            threads=kernel_plan[0], plan=list(kernel_plan)))


def shadow_reference_train(ck) -> dict:
    """``--shadow-reference-train``: the reference's recipe trained by the
    port from seed 0 on the reference's data cache, uncut (150 epochs of
    300 steps), then generated and scored as phase reference_shadow does,
    and held against the reference's two trainings at this recipe."""
    phase = "reference_train"
    run = reference_shadow_run(ck, phase)
    res = run["res"]
    tm = res["timings"]
    rows = [REFERENCE_SHADOW[k] for k in REFERENCE_TRAINING_ROWS]
    want_tv = float(np.mean([r["mean_tv_to_target"] for r in rows]))
    losses = res["losses"]
    out = dict(train_steps=res["train_steps"], wall_s=run["wall"],
               timings=tm, steps_per_s=res["train_steps"] / tm["train"],
               walk_launches=run["walks"], walk_plan=list(run["plan"]),
               **{k: res[k] for k in SHADOW_METRICS + (
                   "tv_shot_noise_floor", "meas_tv_to_target",
                   "max_tv_to_target", "max_marginal_error")},
               loss_every_15_epochs=[float(v) for v in losses[14::15]],
               reference_mean_tv=want_tv)
    log(phase, f"{res['train_steps']} steps in {tm['train']:.1f} s "
        f"({out['steps_per_s']:.1f} steps/s); losses every 15 epochs: "
        + ", ".join(f"{v:.4f}" for v in out["loss_every_15_epochs"]))
    for what in REFERENCE_TRAINING_ROWS:
        log(phase, f"reference ({what}): " + ", ".join(
            f"{k} {v:g}" for k, v in REFERENCE_SHADOW[what].items()))
    log(phase, "result " + json.dumps(out))
    check(abs(res["mean_tv_to_target"] - want_tv) <= REFERENCE_TRAIN_TV_TOL,
          f"{phase}: mean TV {res['mean_tv_to_target']:.5f} within "
          f"{REFERENCE_TRAIN_TV_TOL} of the reference's {want_tv:.5f}")
    check(res["mean_marginal_error"] <= REFERENCE_TRAIN_MARGINAL_MAX,
          f"{phase}: marginal error {res['mean_marginal_error']:.5f} <= "
          f"{REFERENCE_TRAIN_MARGINAL_MAX}")
    check(res["classical_fidelity"] >= REFERENCE_TRAIN_CF_MIN,
          f"{phase}: classical fidelity {res['classical_fidelity']:.5f} >= "
          f"{REFERENCE_TRAIN_CF_MIN}")
    return out


def phase_chunked(ck, model) -> int:
    """``sample_all_bases_chunked`` on the trained ``rqc`` model: the tables
    once, then walks of at most 2^21 chains (200,000 shots a basis in 3
    launches), against the exact chain distribution of its tables."""
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule

    sched = make_schedule("cosine", 100, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    shots = 200_000
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    tm: dict = {}
    out = diff.sample_all_bases_chunked(gen, model, 3, shots, sched,
                                        max_chains=1 << 21, walk="cuda",
                                        timings=tm)
    torch.cuda.synchronize()
    walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
    check(walks == 3 and steps == 0,
          f"sample_all_bases_chunked launched the walk 3 times ({walks}) and "
          f"the step never ({steps})")
    tables = diff.grid_p1_tables(model, 3, sched).reshape(100, 27, 8, 3)
    dist = exact_walk(tables, torch.full((27, 8), 1 / 8, device="cuda"))
    idx = (out.long() * (1 << torch.arange(3, device="cuda"))).sum(-1)
    tv = tv_rows(idx, dist)
    bound = 4 * math.sqrt(8 / (2 * math.pi * shots))
    log("chunked", f"sample_all_bases_chunked, {shots} shots a basis: walk "
        f"launches {walks}, tables {tm['tables']:.4f} s, walks "
        f"{tm['walk']:.4f} s; samples vs exact chain: max TV "
        f"{float(tv.max()):.5f} < {bound:.5f}")
    check(tuple(out.shape) == (27, shots, 3) and out.is_cuda,
          "chunked samples on the card")
    check(bool((tv < bound).all()), f"chunked samples TV {float(tv.max())} <"
          f" {bound}")
    return walks


def samples_vs_tables(phase: str, what: str, samples: torch.Tensor,
                      tables: torch.Tensor,
                      init_dist: torch.Tensor) -> torch.Tensor:
    """Each basis' samples ``[C, S, N]`` against the exact propagation of
    ``tables`` ``[T', C, 2^N, N]`` from ``init_dist`` ``[C, 2^N]``: TV
    within 4 shot-noise scales. Returns the exact distribution."""
    c, shots, n = samples.shape
    dist = exact_walk(tables, init_dist)
    idx = (samples.long() * (1 << torch.arange(n, device="cuda"))).sum(-1)
    tv = tv_rows(idx, dist)
    bound = 4 * math.sqrt(2**n / (2 * math.pi * shots))
    log(phase, f"{what}: samples vs the exact chain: TV mean "
        f"{float(tv.mean()):.5f}, max {float(tv.max()):.5f} < bound "
        f"{bound:.5f} over {c} bases")
    check(bool((tv < bound).all()), f"{what}: samples TV {float(tv.max())} "
          f"< {bound} for every basis")
    return dist


def fidelity_shot_sd(n: int, target: torch.Tensor, dist: torch.Tensor,
                     shots: int) -> float:
    """Shot-noise standard deviation of the linear-inversion fidelity at
    ``shots`` a basis drawn from ``dist`` ``[3^N, 2^N]``: the unprojected
    estimate is affine in each basis' frequencies, so its variance is the
    sum over bases of Var_{o ~ dist[b]}(F with basis b's row one-hot at
    o) / shots."""
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import pauli

    inv = pauli.make_counts_inverter(n, psd=False)
    var = 0.0
    for b in range(dist.shape[0]):
        f = []
        for o in range(dist.shape[1]):
            d = dist.clone()
            d[b] = 0.0
            d[b, o] = 1.0
            f.append(float(M.state_fidelity(target, inv(d.float()))))
        f = torch.tensor(f, dtype=torch.float64)
        p = dist[b].double().cpu()
        var += float((p * f**2).sum() - (p * f).sum() ** 2) / shots
    return math.sqrt(max(var, 0.0))


# The JAX package's notebook rows at seed 0 (examples/results_parity.jsonl
# rows 13-14, its CPU/TPU runs; fidelities only) and its seed spread
# (RESULTS.md, the notebook two-model comparison).
REFERENCE_NOTEBOOK = {
    "notebook_simple": dict(fidelity=0.98764, raw_fidelity=0.98526,
                            seed_spread=(0.988, 0.997)),
    "notebook_upgraded": dict(fidelity=0.88837, raw_fidelity=0.98526,
                              seed_spread=(0.888, 0.998)),
}


# The notebook_upgraded preset's training, cut (printed) from its 300
# epochs of 24 steps; notebook_simple runs its 200 uncut.
NOTEBOOK_EPOCHS_CUT = {"notebook_upgraded": 100}


def phase_notebook(ck) -> dict:
    """The phase-1 notebook presets on the card (``notebook_upgraded``'s
    training cut to ``NOTEBOOK_EPOCHS_CUT``): PlainMLP, notebook schedule,
    renoise, 1,024 shots a basis at N=1 (3 x 1,024 chains: the table
    walk)."""
    import dataclasses

    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import run_experiment

    out = {}
    for preset, ref in REFERENCE_NOTEBOOK.items():
        cfg = get_preset(preset)
        if preset in NOTEBOOK_EPOCHS_CUT:
            log("notebook", f"{preset}: CUT num_epochs "
                f"{cfg.train.num_epochs} -> {NOTEBOOK_EPOCHS_CUT[preset]}")
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, num_epochs=NOTEBOOK_EPOCHS_CUT[preset]))
        n, t_steps, shots = (cfg.data.num_qubits, cfg.diffusion.num_timesteps,
                             cfg.data.shots_infer)
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        t0 = time.perf_counter()
        res = run_experiment(cfg, seed=0, log_fn=lambda m: log("notebook", m))
        wall = time.perf_counter() - t0
        walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
        tm = res["timings"]
        log("notebook", f"{preset}: wall {wall:.2f} s; stages (s): " + ", "
            .join(f"{k} {v:.4f}" for k, v in tm.items()))
        log("notebook", f"{preset}: train {res['train_steps']} steps, "
            f"{res['train_steps'] / tm['train']:.1f} steps/s; "
            f"fused_chain_walk.launches = {walks}, fused_chain_step.launches "
            f"= {steps}")
        log("notebook", f"{preset}: fidelity {res['fidelity']:.5f}, raw "
            f"fidelity {res['raw_fidelity']:.5f}; the JAX package at seed 0: "
            f"{ref['fidelity']:.5f} / {ref['raw_fidelity']:.5f}, its seeds "
            f"{ref['seed_spread'][0]}-{ref['seed_spread'][1]}")
        check(walks == 1 and steps == 0,
              f"{preset}: one walk launch and no step launch")
        check(tuple(res["samples"].shape) == (3, shots, n)
              and res["samples"].is_cuda, f"{preset}: samples [3, {shots}, "
              f"{n}] on the card")
        check_rho(torch.from_numpy(res["rho"]), f"{preset}: rho")

        model = res["state"]
        sched = make_schedule(cfg.diffusion.schedule, t_steps, "cuda")
        tables = diff.grid_p1_tables(model, n, sched, cfg.diffusion.exact
                                     ).reshape(t_steps, 3, 2**n, n)
        dist = samples_vs_tables("notebook", preset, res["samples"], tables,
                                 torch.full((3, 2**n), 1 / 2**n,
                                            device="cuda"))
        target = torch.from_numpy(res["target"]).cuda()
        fid_exact = float(M.state_fidelity(target, pauli.make_counts_inverter(
            n)((dist * shots).float())))
        sd = fidelity_shot_sd(n, target, dist, shots)
        bound = max(0.02, 4 * sd)
        log("notebook", f"{preset}: fidelity {res['fidelity']:.5f} vs the "
            f"exact chain's inversion {fid_exact:.5f} (shot-noise sd "
            f"{sd:.5f}; bound {bound:.5f})")
        check(abs(res["fidelity"] - fid_exact) < bound,
              f"{preset}: fidelity within {bound:.4f} of the exact chain's "
              "inversion")
        out[preset] = dict(fidelity=res["fidelity"],
                           raw_fidelity=res["raw_fidelity"],
                           fidelity_exact_chain=fid_exact, fidelity_sd=sd,
                           train_steps=res["train_steps"], timings=tm,
                           wall_s=wall, walk_launches=walks)
    return out


def phase_denoise(ck, res_main: dict) -> dict:
    """Denoise mode on the card: phase 3's trained ``rqc`` model reloaded,
    the same seed's measured shots reverse-diffused from t*; no kernel
    runs. Each basis' samples against the exact propagation of the measured
    frequencies through the model's tables for steps t*..1."""
    import dataclasses

    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import load_data_cache, run_experiment
    from ddqst_tpu_torch.qsim.noise import get_noise_config
    from ddqst_tpu_torch.utils.checkpoint import save_params

    base = get_preset("rqc")
    cfg = base.replace(diffusion=dataclasses.replace(base.diffusion,
                                                     infer_mode="denoise"))
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    sched = make_schedule(cfg.diffusion.schedule, t_steps, "cuda")
    t_star = diff.match_timestep(
        sched, max(get_noise_config(cfg.data.noise_type).readout_p, 0.01))
    reps = max(-(-cfg.data.shots_infer // cfg.data.shots_train), 1)
    with tempfile.TemporaryDirectory() as tmp:
        params, cache = (os.path.join(tmp, "rqc.pt"),
                         os.path.join(tmp, "data.npz"))
        save_params(params, res_main["state"])
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        t0 = time.perf_counter()
        res = run_experiment(cfg, seed=0, params_load=params, data_cache=cache,
                             log_fn=lambda m: log("denoise", m))
        wall = time.perf_counter() - t0
        walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
        data = load_data_cache(cache, "cuda")
    tm = res["timings"]
    shots = reps * cfg.data.shots_train
    log("denoise", f"t* = {t_star}, reps = {reps}, {reps} x "
        f"{cfg.data.shots_train} = {shots} shots a basis; wall {wall:.2f} s; "
        "stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in tm.items()))
    log("denoise", f"fidelity {res['fidelity']:.5f} (denoise mode) against "
        f"{res_main['fidelity']:.5f} (generate mode, phase 3) and raw "
        f"{res['raw_fidelity']:.5f}; fused_chain_walk.launches = {walks}, "
        f"fused_chain_step.launches = {steps}")
    check(walks == 0 and steps == 0, "denoise mode launched no kernel")
    check(abs(res["raw_fidelity"] - res_main["raw_fidelity"]) < 1e-6,
          "the same seed regenerated the same data")
    samples = res["samples"]
    check(tuple(samples.shape) == (27, shots, n) and samples.is_cuda,
          f"denoised samples [27, {shots}, {n}] on the card")
    check_rho(torch.from_numpy(res["rho"]), "denoise: rho")

    # Sample r·S + i of a basis started from its measured shot i, and the
    # chain then ran steps t*..1 of the model's tables (P, [27, g, g]). The
    # measured frequencies are fixed, so only the reverse chain adds noise:
    # a hist entry's variance is sum_x freq[x] P[x,y] (1 - P[x,y]) / shots,
    # and 0.5 * sum_y of its sd bounds E[TV] above. A denoiser that returned
    # its input would pass a bound of independent draws, as the chain moves
    # the distribution little; the moved-shot count catches it.
    g = 2**n
    weights = 1 << torch.arange(n, device="cuda")
    start = (data.bits.long() * weights).sum(-1).repeat(1, reps)  # [27, shots]
    idx = (samples.long() * weights).sum(-1)
    freqs = torch.zeros((27, g), dtype=torch.float64, device="cuda")
    freqs.scatter_add_(1, start, torch.ones(start.shape, dtype=torch.float64,
                                            device="cuda"))
    freqs /= shots
    tables = diff.grid_p1_tables(res["state"], n, sched, cfg.diffusion.exact
                                 ).reshape(t_steps, 27, g, n)
    trans = exact_transitions(tables[t_steps - t_star:])
    dist = torch.einsum("cx,cxy->cy", freqs, trans)
    scale = 0.5 * (torch.einsum("cx,cxy->cy", freqs, trans * (1 - trans))
                   / shots).sqrt().sum(-1)
    tv = tv_rows(idx, dist)
    log("denoise", f"samples vs the measured shots through steps t*..1: TV "
        f"mean {float(tv.mean()):.6f}, max {float(tv.max()):.6f}; max TV / "
        f"noise scale {float((tv / scale).max()):.3f} < 4 (scale mean "
        f"{float(scale.mean()):.6f}) over 27 bases")
    check(bool((tv < 4 * scale).all()), "denoise: samples TV within 4 noise "
          "scales of the reverse chain for every basis")
    stay = trans.diagonal(dim1=1, dim2=2).gather(1, start)  # P[x_i, x_i]
    moved = int((idx != start).sum())
    want = float((1 - stay).sum())
    sd = math.sqrt(float((stay * (1 - stay)).sum()))
    log("denoise", f"samples that left their measured shot: {moved} of "
        f"{idx.numel()}, the chain's expectation {want:.1f} (sd {sd:.1f})")
    check(want > 8 * sd, "denoise: the chain moves enough shots to tell a "
          "denoiser from the identity")
    check(abs(moved - want) < 4 * sd, "denoise: moved shots within 4 sd of "
          "the chain's expectation")
    return dict(t_star=t_star, reps=reps, shots_per_basis=shots,
                moved_shots=moved, moved_shots_expected=want,
                tv_max=float(tv.max()), tv_scale_mean=float(scale.mean()),
                fidelity=res["fidelity"], raw_fidelity=res["raw_fidelity"],
                fidelity_generate=res_main["fidelity"], timings=tm,
                wall_s=wall, walk_launches=walks, step_launches=steps)


# Epochs of the cut trainings the bf16 phase times at each dtype, 81 and
# 100 steps (the presets train 30 epochs of 27 and of 100 steps).
TIMING_EPOCHS = {"rqc": 3, "shadow_transformer": 1}
# bf16 grid tables, card against the CPU's recompute of the same model: the
# mean absolute difference. Each side accumulates its products in its own
# order, so a few roundings to bfloat16's 8 significant bits differ and
# spread; a float32 computation differs at every rounding. Most table
# entries sit near 0 or 1, where both differences vanish, so the maximum
# cannot tell them apart and the mean can. The limit lies between the two
# readings, which PERF.md records.
BF16_TABLE_TOL = 1e-6


def training_setup(cfg, rows: int):
    """A one-epoch ``fit`` at ``cfg``'s width on the card, on ``rows``
    random bitstrings and conditioning (per-qubit labels for the
    transformer, basis indices otherwise) from a seeded generator: ``(gen,
    model, bits, cond, sched, train_cfg)``, ``train_cfg`` logging
    nothing."""
    import dataclasses

    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops.schedules import make_schedule

    n = cfg.data.num_qubits
    gen = torch.Generator(device="cuda").manual_seed(0)
    bits = torch.randint(0, 2, (rows, n), generator=gen, device="cuda",
                         dtype=torch.int8)
    cond = (torch.randint(0, 3, (rows, n), generator=gen, device="cuda")
            if cfg.model.arch == "transformer"
            else torch.randint(0, 3**n, (rows,), generator=gen, device="cuda"))
    sched = make_schedule(cfg.diffusion.schedule,
                          cfg.diffusion.num_timesteps, "cuda")
    model = build_model(cfg.model, n, cfg.diffusion.num_timesteps)
    train_cfg = dataclasses.replace(cfg.train, num_epochs=1, log_every=0,
                                    eval_every=0)
    return gen, model, bits, cond, sched, train_cfg


def train_steps_per_s(cfg, rows: int, epochs: int) -> float:
    """``fit`` for ``epochs`` on ``rows`` random rows at ``cfg``'s width on
    the card (one epoch to warm up first); returns steps per second."""
    import dataclasses

    from ddqst_tpu_torch import train as training

    gen, model, bits, cond, sched, warm = training_setup(cfg, rows)
    training.fit(gen, model, bits, cond, warm, sched, log_fn=lambda m: None)
    tc = dataclasses.replace(warm, num_epochs=epochs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    training.fit(gen, model, bits, cond, tc, sched, log_fn=lambda m: None)
    torch.cuda.synchronize()
    return rows // cfg.train.batch_size * epochs / (time.perf_counter() - t0)


def phase_bf16(ck, res_main: dict) -> dict:
    """The ``rqc`` preset uncut at ``dtype='bfloat16'``, against phase 3's
    float32 run; then the shadow width's training, cut, at both dtypes."""
    import dataclasses

    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import run_experiment

    base = get_preset("rqc")
    cfg = base.replace(model=dataclasses.replace(base.model, dtype="bfloat16"))
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cfg, seed=0, log_fn=lambda m: log("bf16", m))
    wall = time.perf_counter() - t0
    walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
    tm, tm32 = res["timings"], res_main["timings"]
    sps = res["train_steps"] / tm["train"]
    sps32 = res_main["train_steps"] / tm32["train"]
    log("bf16", f"rqc at bfloat16: wall {wall:.2f} s; stages (s): " + ", "
        .join(f"{k} {v:.4f}" for k, v in tm.items()))
    log("bf16", f"rqc train: bfloat16 {sps:.1f} steps/s against float32 "
        f"{sps32:.1f} steps/s (phase 3); fidelity {res['fidelity']:.5f} "
        f"against {res_main['fidelity']:.5f}; fused_chain_walk.launches = "
        f"{walks}, fused_chain_step.launches = {steps}")
    check(walks == 1 and steps == 0, "bf16 rqc: one walk launch, no step")
    check_rho(torch.from_numpy(res["rho"]), "bf16 rqc: rho")
    model = res["state"]
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "bf16 rqc: the parameters stayed float32")
    sched = make_schedule("cosine", t_steps, "cuda")
    tables = diff.grid_p1_tables(model, n, sched, cfg.diffusion.exact)
    check(tables.dtype == torch.float32, "bf16 rqc: float32 tables")
    samples_vs_tables("bf16", "rqc", res["samples"],
                      tables.reshape(t_steps, 27, 2**n, n),
                      torch.full((27, 2**n), 1 / 2**n, device="cuda"))
    weights = model.state_dict()
    cpu_model = build_model(cfg.model, n, t_steps)
    cpu_model.load_state_dict({k: v.cpu() for k, v in weights.items()})
    cpu_tables = diff.grid_p1_tables(cpu_model.eval(), n, sched.to("cpu"),
                                     cfg.diffusion.exact)
    diff_bf16 = (tables.cpu() - cpu_tables).abs()
    # The control: the same weights' tables computed in float32 on the card,
    # what a card that skipped the bfloat16 casts would give.
    f32_model = build_model(base.model, n, t_steps).cuda()
    f32_model.load_state_dict(weights)
    diff_f32 = (diff.grid_p1_tables(f32_model.eval(), n, sched,
                                    cfg.diffusion.exact).cpu()
                - cpu_tables).abs()
    tab_err, f32_err = float(diff_bf16.mean()), float(diff_f32.mean())
    log("bf16", f"rqc tables against the CPU's bf16 recompute, mean (max) "
        f"abs difference: bf16 on the card {tab_err:.3e} "
        f"({float(diff_bf16.max()):.3e}), float32 on the card (control) "
        f"{f32_err:.3e} ({float(diff_f32.max()):.3e}); tolerance on the mean "
        f"{BF16_TABLE_TOL:.0e}")
    check(tab_err < BF16_TABLE_TOL, "bf16 rqc tables on the card match the "
          "CPU's")
    check(f32_err > BF16_TABLE_TOL, "float32 tables of the same weights fail "
          "the bf16 tolerance")

    # Both widths again, warm and in turns (float32, bfloat16, bfloat16,
    # float32), on random data of the presets' sizes: phase 3's run was the
    # process's first training, so its rate is not a warm one.
    warm = {}
    for preset, epochs in (("rqc", TIMING_EPOCHS["rqc"]),
                           ("shadow_transformer",
                            TIMING_EPOCHS["shadow_transformer"])):
        c = get_preset(preset)
        rows = (c.data.max_bases or 3**c.data.num_qubits) * c.data.shots_train
        steps = rows // c.train.batch_size * epochs
        log("bf16", f"{preset} width, CUT: {c.train.num_epochs} epochs -> "
            f"{epochs} ({steps} steps, after a 1-epoch warm-up) at each "
            "dtype, in turns, random bits and conditioning")
        rates = {"float32": [], "bfloat16": []}
        for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
            cd = c.replace(model=dataclasses.replace(c.model, dtype=dtype))
            rates[dtype].append(train_steps_per_s(cd, rows, epochs))
        warm[preset] = {k: sum(v) / len(v) for k, v in rates.items()}
        log("bf16", f"{preset} train, warm: float32 " + " / ".join(
            f"{r:.1f}" for r in rates["float32"]) + " steps/s, bfloat16 "
            + " / ".join(f"{r:.1f}" for r in rates["bfloat16"])
            + f" steps/s (bfloat16 / float32 = "
            f"{warm[preset]['bfloat16'] / warm[preset]['float32']:.3f})")
    return dict(rqc_steps_per_s=sps, rqc_steps_per_s_float32=sps32,
                fidelity=res["fidelity"], fidelity_float32=res_main["fidelity"],
                timings=tm, wall_s=wall, walk_launches=walks,
                table_err=tab_err, table_err_float32_control=f32_err,
                warm_steps_per_s=warm)


PROFILE_STEPS = 20


def _union_us(ranges: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (microseconds)."""
    total, end = 0.0, -math.inf
    for a, b in sorted(ranges):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_training(preset: str) -> dict:
    """``PROFILE_STEPS`` training steps of ``fit`` at a preset's width, on
    random data, after a warm-up run: ms a step on the host clock without
    the profiler, then the same call inside ``utils.profiling.trace``: its
    ms a step, the device kernels a step, the device's busy time (the union
    of the kernels' intervals) against both windows, and the 5 kernels that
    take the most device time. A call of ``fit`` includes its parameter
    initialisation. Device-side ranges of ``record_function`` annotations
    (``Optimizer.step``'s) are not kernels and are left out."""
    from ddqst_tpu_torch import train as training
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.utils.profiling import trace

    cfg = get_preset(preset)
    gen, model, bits, cond, sched, tc = training_setup(
        cfg, PROFILE_STEPS * cfg.train.batch_size)

    def run():
        training.fit(gen, model, bits, cond, tc, sched, log_fn=lambda m: None)
        torch.cuda.synchronize()

    run()  # warm-up
    t0 = time.perf_counter()
    run()
    plain_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with trace(tmp) as prof:
            run()
        window = time.perf_counter() - t0
        trace_mb = sum(os.path.getsize(os.path.join(tmp, f))
                       for f in os.listdir(tmp)) / 2**20
    device = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    kernels = [e for e in device if not getattr(e, "is_user_annotation", False)]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    out = dict(preset=preset, steps=PROFILE_STEPS,
               ms_per_step=plain_s * 1e3 / PROFILE_STEPS,
               ms_per_step_profiled=window * 1e3 / PROFILE_STEPS,
               device_kernels_per_step=len(kernels) / PROFILE_STEPS,
               device_busy_ms_per_step=busy_us / 1e3 / PROFILE_STEPS,
               device_busy_share=busy_us / (plain_s * 1e6),
               device_busy_share_profiled=busy_us / (window * 1e6),
               annotation_ranges_left_out=len(device) - len(kernels),
               trace_mb=trace_mb,
               top_kernels=[(name[:80], c, us / 1e3) for name, (c, us) in top])
    log("profile", f"{preset} width, {PROFILE_STEPS} steps of fit (batch "
        f"{cfg.train.batch_size}): {out['ms_per_step']:.3f} ms a step "
        f"({out['ms_per_step_profiled']:.3f} under the profiler), "
        f"{out['device_kernels_per_step']:.1f} device kernels a step, device "
        f"busy {out['device_busy_ms_per_step']:.3f} ms a step = "
        f"{100 * out['device_busy_share']:.1f}% of an unprofiled step "
        f"({100 * out['device_busy_share_profiled']:.1f}% of the profiled "
        f"window); {out['annotation_ranges_left_out']} annotation ranges left "
        f"out; trace {trace_mb:.1f} MB")
    for name, count, ms in out["top_kernels"]:
        log("profile", f"  {name}: {count} launches, device {ms:.3f} ms "
            f"({ms / PROFILE_STEPS:.3f} ms a step)")
    check(len(kernels) > 0, f"{preset}: the profile saw device kernels")
    return out


def phase_train_profile() -> dict:
    out = {p: profile_training(p) for p in ("shadow_transformer", "rqc")}
    out["embed_backward"] = embed_repeat()
    return out


def profile_distill() -> dict:
    """Where one distillation step's time goes, at full width (27·8 grid
    rows, T = 100, seeded weights, random targets): the host-clock time of a
    step (forward, backward, Adam) with and without the per-step checkpoint
    and of a forward alone, and from ``torch.profiler`` over two steps the
    count of device kernels launched and the time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    from ddqst_tpu_torch.bench import FULL_DEPTH, bench_recipe
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.models.d3pm import init_params_
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule

    cfg = bench_recipe("ghz", *FULL_DEPTH)
    model = build_model(cfg.model, 3, 100).cuda()
    init_params_(model, torch.Generator(device="cuda").manual_seed(0))
    sched = make_schedule("cosine", 100, "cuda")
    tgt = torch.rand((27, 8), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(1))
    tgt = tgt / tgt.sum(-1, keepdim=True)
    opt = torch.optim.Adam(model.parameters(), lr=3e-4)

    def step(checkpoint=True):
        opt.zero_grad(set_to_none=True)
        dist = diff.chain_distribution(model, 3, sched, False,
                                       checkpoint=checkpoint)
        (-(tgt * dist.clamp_min(1e-12).log()).sum(-1).mean()).backward()
        opt.step()

    @torch.no_grad()
    def forward():
        diff.chain_distribution(model, 3, sched, False)

    def host_ms(fn, iters=3):
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    out = dict(step_ms=host_ms(step),
               step_no_checkpoint_ms=host_ms(lambda: step(False)),
               forward_ms=host_ms(forward))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us = sum(getattr(e, "device_time_total", 0)
                  or getattr(e, "cuda_time_total", 0) for e in kernels)
    out.update(device_kernels_per_step=len(kernels) / 2,
               device_busy_ms_per_step=busy_us / 2e3)
    log("profile", json.dumps(out))
    top = sorted(prof.key_averages(),
                 key=lambda e: -(getattr(e, "self_device_time_total", 0)
                                 or getattr(e, "self_cuda_time_total", 0)))[:8]
    for e in top:
        log("profile", f"{e.key[:60]}: {e.count} calls, device "
            f"{(getattr(e, 'self_device_time_total', 0) or getattr(e, 'self_cuda_time_total', 0)) / 1e3:.2f} ms")
    return out



# Depth cuts of the mesh phase, each printed. The rqc preset's DP-2 run
# trains 5 of its 30 epochs; the shadow preset's TP-2 run 1 of its 30: two
# ranks on one card stage every tensor-parallel reduce through the host over
# gloo (16 a step), and the whole phase gets 180 s.
MESH_DP_RUN_EPOCHS, MESH_TP_EPOCHS = 5, 1
# The comparisons with one process: the rqc width on the preset's 27,648
# rows for 3 epochs (81 steps), the shadow width on 16 of its 100 batches an
# epoch for 2 epochs (32 steps), and the one-rank NCCL fit at the rqc width
# on 8 batches for 2 epochs.
MESH_DP_EPOCHS, MESH_TP_BATCHES, MESH_TP_FIT_EPOCHS = 3, 16, 2
MESH_NCCL_BATCHES, MESH_NCCL_EPOCHS = 8, 2
MESH_RTOL, MESH_ATOL = 2e-4, 2e-5  # tests/test_parallel.py's DP / TP tolerance
MESH_WORLD_TIMEOUT_S = 240


class CollectiveClock:
    """Host-clock time inside ``torch.distributed.all_reduce`` and
    ``broadcast`` while active, the card synchronised before and after each
    call, so a call's time is its own and not the queue's before it."""

    def __init__(self):
        self.seconds, self.calls = 0.0, 0

    def _timed(self, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out
        return call

    def __enter__(self):
        import torch.distributed as dist

        self._saved = dist.all_reduce, dist.broadcast
        dist.all_reduce, dist.broadcast = map(self._timed, self._saved)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.broadcast = self._saved


def mesh_fit(preset: str, batches: int, epochs: int, mesh=None):
    """``fit`` at a preset's width on ``batches`` batches of random rows
    (``training_setup``'s seeded data) for ``epochs``, on ``mesh`` or in one
    process: ``(record, model, optimiser)``, the record holding the losses,
    steps/s and the collectives' share of the time."""
    import dataclasses

    from ddqst_tpu_torch import train as training
    from ddqst_tpu_torch.config import get_preset

    cfg = get_preset(preset)
    rows = batches * cfg.train.batch_size
    gen, model, bits, cond, sched, tc = training_setup(cfg, rows)
    tc = dataclasses.replace(tc, num_epochs=epochs)
    made, make = [], training.make_optimizer

    def recording(cfg, params):
        made.append(make(cfg, params))
        return made[-1]

    training.make_optimizer = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with CollectiveClock() as clock:
            model, losses = training.fit(gen, model, bits, cond, tc, sched,
                                         mesh=mesh, log_fn=lambda m: None)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        training.make_optimizer = make
    steps = batches * epochs
    return dict(losses=losses.cpu(), steps=steps, seconds=seconds,
                steps_per_s=steps / seconds, collective_s=clock.seconds,
                collective_calls=clock.calls,
                collective_share=clock.seconds / seconds), model, made[0]


def _mesh_rank(rank: int, fn, world: int, port: int, out_dir: str) -> None:
    """A rank of a spawned world: torchrun's environment, then
    ``init_distributed()``, ``fn(rank, out_dir)``, its result saved."""
    from ddqst_tpu_torch.parallel.mesh import init_distributed

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    check(init_distributed(), "the rank joined its world")
    try:
        out = fn(rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def run_world(fn, world: int, out_dir: str) -> list[dict]:
    """``fn`` in ``world`` spawned ranks on this card; each rank's result.
    An exception or a non-zero exit in any rank, or a world still running
    after ``MESH_WORLD_TIMEOUT_S``, fails the phase (the other ranks are
    stopped)."""
    import torch.multiprocessing as mp

    from ddqst_tpu_torch.parallel.mesh import free_port

    ctx = mp.start_processes(_mesh_rank,
                             args=(fn, world, free_port(), out_dir),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.perf_counter() + MESH_WORLD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() > deadline:
                raise RuntimeError(f"check failed: the {world}-rank world "
                                   f"ran past {MESH_WORLD_TIMEOUT_S} s")
    except mp.ProcessException as e:
        raise RuntimeError(f"check failed: a rank failed: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _run_record(ck, res: dict) -> dict:
    keep = ("fidelity", "raw_fidelity", "trace_distance", "purity", "rho",
            "target", "losses", "train_steps", "timings", "mean_tv_to_target",
            "tv_shot_noise_floor", "mean_marginal_error", "classical_fidelity")
    out = {k: res[k] for k in keep if k in res}
    out.update(samples=res["samples"].cpu(),
               state={k: v.cpu() for k, v in res["state"].state_dict().items()},
               walk_launches=ck.fused_chain_walk.launches,
               step_launches=ck.fused_chain_step.launches)
    return out


def mesh_two_ranks(rank: int, out_dir: str) -> dict:
    """The 2-rank world of phase mesh, both ranks on this card (gloo)."""
    import dataclasses

    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.models.d3pm import init_params_
    from ddqst_tpu_torch.ops import cuda_kernels as ck
    from ddqst_tpu_torch.parallel import mesh as pm
    from ddqst_tpu_torch.parallel import tensor as tp
    from ddqst_tpu_torch.pipeline import run_experiment

    def say(m):
        if rank == 0:
            log("mesh", m)

    dp = pm.make_mesh(data=2)
    tpm = pm.make_mesh(data=1, model=2)
    out = dict(backend=dp.backend, device=str(dp.device))

    # Data-parallel: the comparison fit (after a one-batch warm-up: the
    # process's first training is slower), then the rqc preset, its
    # training cut.
    mesh_fit("rqc", 1, 1, dp)
    out["dp_fit"] = mesh_fit("rqc", 27, MESH_DP_EPOCHS, dp)[0]
    rqc = get_preset("rqc")
    say(f"rqc, CUT: {rqc.train.num_epochs} epochs -> {MESH_DP_RUN_EPOCHS} "
        "for the DP-2 run_experiment")
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(rqc.replace(train=dataclasses.replace(
        rqc.train, num_epochs=MESH_DP_RUN_EPOCHS)), seed=0, mesh=dp,
        log_fn=say)
    out["dp_run"] = dict(_run_record(ck, res),
                         wall_s=time.perf_counter() - t0)

    # Tensor-parallel: the forward of seeded weights, whole and split.
    cfg = get_preset("shadow_transformer")
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = build_model(cfg.model, n, t_steps).cuda()
    init_params_(model, gen)
    x = torch.randint(0, 2, (1024, n), generator=gen, device="cuda")
    t = torch.randint(1, t_steps + 1, (1024,), generator=gen, device="cuda")
    b = torch.randint(0, 3, (1024, n), generator=gen, device="cuda")
    with torch.no_grad():
        whole = model(x, t, b)
        tp.shard_params(tpm, model)
        split = model(x, t, b)
    out["tp_forward_err"] = float((whole - split).abs().max())

    # Tensor-parallel training: the comparison fit, its Adam moments, then
    # the shadow preset with its training cut.
    mesh_fit("shadow_transformer", 1, 1, tpm)
    rec, model, opt = mesh_fit("shadow_transformer", MESH_TP_BATCHES,
                               MESH_TP_FIT_EPOCHS, tpm)
    out["tp_fit"] = rec
    names = [k for k, _ in model.named_parameters()]
    out["tp_moments"] = {
        name: (tuple(opt.state[p]["exp_avg"].shape),
               tuple(opt.state[p]["exp_avg_sq"].shape))
        for name, p in zip(names, opt.param_groups[0]["params"])}
    out["tp_whole_shapes"] = {k: tuple(p.shape)
                              for k, p in model.named_parameters()}
    out["tp_dims"] = tp.transformer_param_shardings(model)
    out["tp_state"] = {k: v.cpu() for k, v in model.state_dict().items()}
    say(f"shadow_transformer, CUT: {cfg.train.num_epochs} epochs -> "
        f"{MESH_TP_EPOCHS} for the TP-2 run_experiment")
    cut = cfg.replace(train=dataclasses.replace(cfg.train,
                                                num_epochs=MESH_TP_EPOCHS))
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    res = run_experiment(cut, seed=0, mesh=tpm, log_fn=say,
                         data_cache=os.path.join(out_dir, "shadow.npz"))
    out["tp_run"] = dict(_run_record(ck, res),
                         wall_s=time.perf_counter() - t0)
    return out


def mesh_nccl_rank(rank: int, out_dir: str) -> dict:
    """The one-rank NCCL world of phase mesh: ``fit`` without a mesh, then
    on ``make_mesh(data=1)``."""
    from ddqst_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(data=1)
    mesh_fit("rqc", 1, 1, mesh)  # NCCL sets its communicator up here
    plain = mesh_fit("rqc", MESH_NCCL_BATCHES, MESH_NCCL_EPOCHS)[0]
    on_mesh = mesh_fit("rqc", MESH_NCCL_BATCHES, MESH_NCCL_EPOCHS, mesh)[0]
    return dict(backend=mesh.backend, plain=plain, mesh=on_mesh)


def _losses_match(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got - want).abs().max())
    log("mesh", f"{what}: losses {np.round(got.numpy(), 6).tolist()} against "
        f"one process's {np.round(want.numpy(), 6).tolist()}, max abs "
        f"difference {err:.3e}")
    check(bool(torch.allclose(got, want, rtol=MESH_RTOL, atol=MESH_ATOL)),
          f"{what}: losses equal one process's at rtol {MESH_RTOL}, atol "
          f"{MESH_ATOL}")
    return err


def _fit_line(what: str, rec: dict) -> str:
    return (f"{what}: {rec['steps']} steps in {rec['seconds']:.3f} s = "
            f"{rec['steps_per_s']:.1f} steps/s; collectives "
            f"{rec['collective_calls']} calls, {rec['collective_s']:.3f} s = "
            f"{100 * rec['collective_share']:.1f}% of the fit")


def phase_mesh() -> dict:
    """Data- and tensor-parallel training on the card: a 2-rank world
    sharing it over gloo, then a one-rank world over NCCL."""
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.pipeline import load_data_cache

    t_phase = time.perf_counter()
    log("mesh", f"CUT: the TP comparison fit on {MESH_TP_BATCHES} of the "
        f"shadow preset's 100 batches an epoch, {MESH_TP_FIT_EPOCHS} epochs; "
        f"the NCCL fit on {MESH_NCCL_BATCHES} batches, {MESH_NCCL_EPOCHS} "
        "epochs")
    ref_dp = mesh_fit("rqc", 27, MESH_DP_EPOCHS)[0]
    ref_tp = mesh_fit("shadow_transformer", MESH_TP_BATCHES,
                      MESH_TP_FIT_EPOCHS)[0]
    log("mesh", _fit_line("one process, rqc width", ref_dp))
    log("mesh", _fit_line("one process, shadow width", ref_tp))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        a, b = run_world(mesh_two_ranks, 2, tmp)
        world_s = time.perf_counter() - t0
        labels = load_data_cache(os.path.join(tmp, "shadow.npz")).basis_labels
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (nccl,) = run_world(mesh_nccl_rank, 1, tmp)
        nccl_s = time.perf_counter() - t0
    log("mesh", f"2-rank world {world_s:.1f} s, backend {a['backend']} on "
        f"{a['device']}; 1-rank world {nccl_s:.1f} s, backend "
        f"{nccl['backend']}")
    check(a["backend"] == b["backend"] == "gloo"
          and a["device"] == b["device"] == "cuda:0",
          "two ranks on one card run gloo, on the card")
    check(nccl["backend"] == "nccl", "one rank on one card runs NCCL")

    # Data-parallel.
    for r, rank in enumerate((a, b)):
        log("mesh", _fit_line(f"DP-2 rank {r}, rqc width", rank["dp_fit"]))
        _losses_match(f"DP-2 rank {r}", rank["dp_fit"]["losses"],
                      ref_dp["losses"])
    ra, rb = a["dp_run"], b["dp_run"]
    tm = ra["timings"]
    log("mesh", f"DP-2 rqc: wall {ra['wall_s']:.2f} / {rb['wall_s']:.2f}"
        f" s; stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in tm.items()))
    log("mesh", f"DP-2 rqc: train {ra['train_steps']} steps, "
        f"{ra['train_steps'] / tm['train']:.1f} steps/s; fidelity "
        f"{ra['fidelity']:.5f} (ranks: {ra['fidelity']!r} / "
        f"{rb['fidelity']!r}); walk launches {ra['walk_launches']} / "
        f"{rb['walk_launches']}, step launches {ra['step_launches']} / "
        f"{rb['step_launches']}")
    check(ra["fidelity"] == rb["fidelity"]
          and np.array_equal(ra["rho"], rb["rho"])
          and torch.equal(ra["samples"], rb["samples"]),
          "DP-2 rqc: both ranks return the same rho, fidelity and samples")
    check(ra["walk_launches"] == rb["walk_launches"] == 1
          and ra["step_launches"] == rb["step_launches"] == 0,
          "DP-2 rqc: one walk launch a rank, no step launch")
    check_rho(torch.from_numpy(ra["rho"]), "DP-2 rqc: rho")
    cfg = get_preset("rqc")
    model = build_model(cfg.model, 3, 100).cuda()
    model.load_state_dict(ra["state"])
    sched = make_schedule("cosine", 100, "cuda")
    tables = diff.grid_p1_tables(model.eval(), 3, sched).reshape(100, 27, 8, 3)
    shots = cfg.data.shots_infer
    dist = samples_vs_tables("mesh", "DP-2 rqc", ra["samples"].cuda(), tables,
                             torch.full((27, 8), 1 / 8, device="cuda"))
    fid_exact = float(M.state_fidelity(
        torch.from_numpy(ra["target"]).cuda(),
        pauli.make_counts_inverter(3)((dist * shots).float())))
    log("mesh", f"DP-2 rqc: fidelity {ra['fidelity']:.5f} vs the exact "
        f"chain's inversion {fid_exact:.5f}")
    check(abs(ra["fidelity"] - fid_exact) < 0.02,
          "DP-2 rqc: fidelity within 0.02 of the exact chain's inversion")

    # Tensor-parallel.
    for r, rank in enumerate((a, b)):
        log("mesh", f"TP-2 rank {r}: forward of seeded weights, split vs "
            f"whole: max abs difference {rank['tp_forward_err']:.3e}")
        check(rank["tp_forward_err"] < 2e-5,
              "TP-2: the split forward equals the whole one within 2e-5")
        log("mesh", _fit_line(f"TP-2 rank {r}, shadow width", rank["tp_fit"]))
        _losses_match(f"TP-2 rank {r}", rank["tp_fit"]["losses"],
                      ref_tp["losses"])
        split = 0
        for name, dim in rank["tp_dims"].items():
            want = list(rank["tp_whole_shapes"][name])
            if dim is not None:
                want[dim] //= 2
                split += 1
            check(rank["tp_moments"][name] == (tuple(want), tuple(want)),
                  f"TP-2 rank {r}: the Adam moments of {name} are this "
                  "rank's part")
        check(split == 10 * get_preset("shadow_transformer").model.num_blocks,
              f"TP-2 rank {r}: 10 split parameters a block ({split})")
    shadow = get_preset("shadow_transformer")
    replicated = [k for k, d in a["tp_dims"].items() if d is None]
    check(all(torch.equal(a["tp_state"][k], b["tp_state"][k])
              for k in a["tp_state"]),
          f"TP-2: the {len(replicated)} replicated parameters (and the "
          "gathered split ones) are equal on both ranks, bit for bit")
    log("mesh", f"TP-2: {split} split parameters with local Adam moments; "
        f"{len(replicated)} replicated parameters bit-equal across the ranks")
    ta, tb = a["tp_run"], b["tp_run"]
    tm = ta["timings"]
    log("mesh", f"TP-2 shadow (training cut): wall {ta['wall_s']:.2f} / "
        f"{tb['wall_s']:.2f} s; stages (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in tm.items()))
    log("mesh", f"TP-2 shadow: train {ta['train_steps']} steps, "
        f"{ta['train_steps'] / tm['train']:.1f} steps/s; mean TV "
        f"{ta['mean_tv_to_target']:.5f} (floor "
        f"{ta['tv_shot_noise_floor']:.5f}); walk launches "
        f"{ta['walk_launches']} / {tb['walk_launches']}, step launches "
        f"{ta['step_launches']} / {tb['step_launches']}")
    check(torch.equal(ta["samples"], tb["samples"])
          and ta["mean_tv_to_target"] == tb["mean_tv_to_target"],
          "TP-2 shadow: both ranks return the same samples and metrics")
    check(ta["walk_launches"] == tb["walk_launches"] == 1
          and ta["step_launches"] == tb["step_launches"] == 0,
          "TP-2 shadow: one walk launch a rank, no step launch")
    n, g = shadow.data.num_qubits, 2**shadow.data.num_qubits
    model = build_model(shadow.model, n, 100).cuda()
    model.load_state_dict(ta["state"])
    lab = torch.from_numpy(np.asarray(labels, np.int64)).cuda()
    grid = (diff._unpack(torch.arange(g, device="cuda"), n).repeat(len(lab), 1),
            lab.repeat_interleave(g, dim=0))
    tables = diff._assembled_tables(model.eval(), n, sched,
                                    shadow.diffusion.exact, grid, 1 << 18,
                                    1 << 16)
    samples_vs_tables("mesh", "TP-2 shadow", ta["samples"].cuda(), tables,
                      torch.full((len(lab), g), 1 / g, device="cuda"))
    del tables

    # NCCL, one rank.
    log("mesh", _fit_line("NCCL-1, rqc width, no mesh", nccl["plain"]))
    log("mesh", _fit_line("NCCL-1, rqc width, make_mesh(data=1)",
                          nccl["mesh"]))
    _losses_match("NCCL-1", nccl["mesh"]["losses"], nccl["plain"]["losses"])
    phase_s = time.perf_counter() - t_phase
    log("mesh", f"steps/s, one process / DP-2 / TP-2 (rank 0): rqc width "
        f"{ref_dp['steps_per_s']:.1f} / {a['dp_fit']['steps_per_s']:.1f}, "
        f"shadow width {ref_tp['steps_per_s']:.1f} / "
        f"{a['tp_fit']['steps_per_s']:.1f}; collective share DP-2 "
        f"{100 * a['dp_fit']['collective_share']:.1f}%, TP-2 "
        f"{100 * a['tp_fit']['collective_share']:.1f}%, NCCL-1 "
        f"{100 * nccl['mesh']['collective_share']:.1f}%. Two ranks share one "
        f"card here: these numbers measure the mesh code, not scaling across "
        f"cards. Phase {phase_s:.1f} s")

    def fit_rec(rec):
        return {k: rec[k] for k in ("steps", "seconds", "steps_per_s",
                                    "collective_s", "collective_calls",
                                    "collective_share")}

    return dict(
        phase_s=phase_s, world_s=world_s, nccl_world_s=nccl_s,
        one_process=dict(rqc=fit_rec(ref_dp), shadow=fit_rec(ref_tp)),
        dp2=[fit_rec(r["dp_fit"]) for r in (a, b)],
        tp2=[fit_rec(r["tp_fit"]) for r in (a, b)],
        nccl1=dict(plain=fit_rec(nccl["plain"]), mesh=fit_rec(nccl["mesh"])),
        dp2_rqc=dict(fidelity=ra["fidelity"], fidelity_exact_chain=fid_exact,
                     train_steps=ra["train_steps"], timings=ra["timings"],
                     wall_s=ra["wall_s"],
                     walk_launches=[ra["walk_launches"], rb["walk_launches"]]),
        tp2_shadow=dict(mean_tv_to_target=ta["mean_tv_to_target"],
                        train_steps=ta["train_steps"], timings=ta["timings"],
                        wall_s=ta["wall_s"], epochs=MESH_TP_EPOCHS,
                        walk_launches=[ta["walk_launches"],
                                       tb["walk_launches"]]),
        tp_forward_err=[a["tp_forward_err"], b["tp_forward_err"]])


# The scaling ladder: the JAX campaign's full canonical-grid recipes beyond
# N = 3 (RESULTS.md:237-456), from the port's ``campaigns.scaling``.


def scaling_rung(tag: str):
    """One rung of ``scripts/run_scaling_ghz.py``, uncut: its config in
    ``campaigns.scaling.experiments()`` (an unknown tag raises)."""
    from ddqst_tpu_torch.campaigns.scaling import experiment

    return experiment(tag)[0]


# The JAX package's records of each rung uncut, on a TPU (quality only):
# RESULTS.md:249, :424, :425, :250, :426, :272; GHZ-8 after its 1600
# uniform steps (:398), 0.87904 / 0.91254 after one / two 800-step mining
# segments (:400-401).
REFERENCE_SCALING = {
    "rqc4_auto": dict(fidelity=0.97117, raw_fidelity=0.92724,
                      raw_fidelity_mitigated=0.99981),
    "ghz5_auto": dict(fidelity=0.97031, raw_fidelity=0.84628,
                      raw_fidelity_mitigated=0.99994),
    "rqc5_auto": dict(fidelity=0.99494, raw_fidelity=0.85564,
                      raw_fidelity_mitigated=0.99982),
    "ghz6_auto": dict(fidelity=0.97845, raw_fidelity=0.75445,
                      raw_fidelity_mitigated=0.99996),
    "rqc6_auto": dict(fidelity=0.99059, raw_fidelity=0.76961,
                      raw_fidelity_mitigated=0.99982),
    "ghz7_mle_hot": dict(fidelity=0.96752, raw_fidelity=0.55760,
                         raw_fidelity_mitigated=0.99993),
    "ghz8_mle_hot": dict(fidelity=0.47733, raw_fidelity=0.35480,
                         raw_fidelity_mitigated=0.99984),
}
# (walk launches, step launches) of one run's generation, as
# pipeline._generate and diffusion.sample_all_bases choose them: at most
# 2^21 chains a sample_all_bases call, the table walk from 32·6^N chains.
# N = 4: 2^21 // 81 = 25,890 shots a call, 30,000 in 2 calls of 15,000;
# N = 5: 2^21 // 243 = 8,630 shots a call, 20,000 in 3 calls of 6,667;
# N = 6: 10,000 in 4 calls of 2,500; N = 7: 5,000 in 6 calls of 834, each
# 2,187 x 834 = 1,823,958 chains < 32·6^7, so the 'seq' walk: T step
# launches a call; N = 8 (gen_tables_once): the tables once, 3,000 in 10
# walks of 300 (2^21 // 6,561 = 319 a walk).
SCALING_PLAN = {"rqc4_auto": (2, 0), "ghz5_auto": (3, 0), "rqc5_auto": (3, 0),
                "ghz6_auto": (4, 0), "rqc6_auto": (4, 0),
                "ghz7_mle_hot": (0, 600), "ghz8_mle_hot": (10, 0)}
# Each launch's shape: the walk's (C, N, S), the step's (G, N, B).
SCALING_WALK_SHAPES = {"ghz5_auto": (243, 5, 6667),
                       "rqc6_auto": (729, 6, 2500),
                       "ghz8_mle_hot": (3**8, 8, 300)}
SCALING_STEP_SHAPES = {"ghz7_mle_hot": (3**7 * 2**7, 7, 3**7 * 834)}
# The default run's cuts of depth (``scaling`` phase): CE epochs and
# distillation steps; GHZ-8 runs the segment protocol with one mining
# segment of SCALING_SEGMENT_STEPS steps. Width, bases, T and
# generated shots are never cut. What is left is set by work no depth cut
# removes: at N = 8 a full-grid chain pass (168 M grid rows, about 42 s on
# the card) before and after each segment and for the tables, at N = 7 the
# 'seq' walk's 600 grid forwards (about 34 s).
SCALING_CUTS = {
    "ghz5_auto": dict(num_epochs=1, chain_finetune_steps=5),
    "ghz7_mle_hot": dict(num_epochs=1, chain_finetune_steps=1),
    "ghz8_mle_hot": dict(num_epochs=1),
}
SCALING_SEGMENT_STEPS = 2
# The GHZ-8 distillation segment of the default run, (chain_accum,
# chain_hard_frac): the campaign's hard-mining segment alone, from the CE
# role's parameters with a fresh Adam state. The campaign's uniform segment
# before it would add two full-grid chain passes, about 95 s.
SCALING_MINING_SEGMENT = (4, 0.5)
# Cuts of the shots a basis, for the phase's budget: an epoch is then 533
# training steps at N = 7 and 640 at N = 8 (6-12 ms a step, bound by the
# host); GHZ-7 generates 834 shots a basis, one 'seq' call of T step
# launches (``SCALING_PLAN_CUT``) in place of six (34 s of grid forwards on
# the card). The data is cut, so MLE on the raw counts is not held to 0.999.
SCALING_SHOTS_CUT = {"ghz7_mle_hot": dict(shots_train=250, shots_infer=834),
                     "ghz8_mle_hot": dict(shots_train=100)}
SCALING_PLAN_CUT = {"ghz7_mle_hot": (0, 100)}
# Every MLE solve of a rung (the target, the samples', the raw counts', the
# exact chain's) stops after this many iterations (the package's cap is
# 4,000, with a tolerance of 3e-7). On the card an iteration takes 3-4 ms
# at N = 5, 60 ms at N = 7 and 48 ms at N = 8, and a solve 380 to 3,200
# iterations to its tolerance; GHZ-5's raw counts reach it in about 380, so
# that rung still holds MLE on the raw counts to 0.999.
SCALING_MLE_ITERS = {"ghz5_auto": 500, "rqc6_auto": 500,
                     "ghz7_mle_hot": 50, "ghz8_mle_hot": 50}
# The rungs split across processes (``--scaling-part TAG PART IN_DIR
# OUT_DIR``), each part one ``run_experiment`` call with the rung's recipe
# unchanged. ``ce`` = (a, b): the part trains CE epochs a+1 to b of the
# recipe's ``num_epochs``, so the cosine schedule spans the whole run; it
# resumes from epoch a's checkpoint (a > 0) and, with b below the total,
# stops right after epoch b's (written every ``every`` epochs). A part
# without ``ce`` warm-starts from the previous part's parameters (and its
# distillation Adam state). ``steps``: the part's distillation steps, the
# k-th distilling part with ``chain_key_salt`` + k; ``eval``: generation and
# the estimators follow. RQC-6 on the H100: CE at 5.3-7.7 ms a step, 3,559
# steps an epoch, about 24-34 min a half. GHZ-7: CE halves of 30 epochs of
# 6,407 steps (1,665-2,305 s each beside other processes, 8.7-12.0 ms a
# step; the checkpoint between them 47 MB), the MLE target solved in
# ``d1``, 1,600 distillation steps at 2.0-2.8 s in three parts (17-26 min
# each), then the eval part (600 step launches, MLE solves).
# RQC-5 and GHZ-6: CE halves, each leaving a checkpoint (about 44 MB; a
# call brings back at most 64 MiB, so one a call), then the held-out
# distillation and the eval in a part of its own: at the 10-11 ms a CE step
# measured in some calls, a CE half with all 800 steps after it would not
# fit one call. RQC-5: 1,186 steps an epoch, 17-32 min a half; GHZ-6:
# RQC-6's shapes, 24-46 min a half (the JAX run kept step 775 of 800).
SCALING_PARTS = {
    "rqc5_auto": {"ce1": dict(ce=(0, 150), every=50),
                  "ce2": dict(ce=(150, 300), every=50),
                  "d": dict(steps=800, eval=True)},
    "ghz6_auto": {"ce1": dict(ce=(0, 75), every=25),
                  "ce2": dict(ce=(75, 150), every=25),
                  "d": dict(steps=800, eval=True)},
    "rqc6_auto": {"ce1": dict(ce=(0, 75), every=25),
                  "ce2": dict(ce=(75, 150), every=25, steps=800,
                              eval=True)},
    "ghz7_mle_hot": {"ce1": dict(ce=(0, 30), every=10),
                     "ce2": dict(ce=(30, 60), every=10),
                     "d1": dict(steps=500), "d2": dict(steps=550),
                     "d3": dict(steps=550), "eval": dict(eval=True)},
}
# The default run's cut of a split rung, through the same parts: CE 2
# epochs, stopped after 1 and resumed, 10 distillation steps.
SCALING_CUT_PARTS = {
    "rqc6_auto": {"ce1": dict(ce=(0, 1), every=1),
                  "ce2": dict(ce=(1, 2), every=1, steps=10, eval=True)},
}
# A rung's committed seed-0 data, which every part (and ``--campaign``)
# reads: the JAX package's ``ensure_data_cache`` on the CPU, written by
# ``tools/make_reference_data.py`` (``--tag TAG --out
# examples/reference_data/TAG_seed0.npz``).
SCALING_DATA = {"rqc4_auto": "examples/reference_data/rqc4_auto_seed0.npz",
                "rqc5_auto": "examples/reference_data/rqc5_auto_seed0.npz",
                "ghz6_auto": "examples/reference_data/ghz6_auto_seed0.npz",
                "rqc6_auto": "examples/reference_data/rqc6_auto_seed0.npz",
                "ghz7_mle_hot":
                    "examples/reference_data/ghz7_mle_hot_seed0.npz"}
# The JAX package's numbers on that file (the same tool, on the CPU): the
# raw-inversion fidelity, MLE on the raw counts solved to its tolerance and
# that solve's iterations. The rows of REFERENCE_SCALING were measured on
# data the JAX package no longer makes bit for bit (raw 0.76961 there).
SCALING_DATA_JAX = {
    "rqc4_auto": dict(raw_fidelity=0.9273253083229065,
                      raw_fidelity_mitigated=0.9998022317886353,
                      mle_iterations=633),
    "rqc5_auto": dict(raw_fidelity=0.8559212684631348,
                      raw_fidelity_mitigated=0.999823808670044,
                      mle_iterations=586),
    "ghz6_auto": dict(raw_fidelity=0.7544494867324829,
                      raw_fidelity_mitigated=0.9999563097953796,
                      mle_iterations=570),
    "rqc6_auto": dict(raw_fidelity=0.7702612280845642,
                      raw_fidelity_mitigated=0.9998176097869873,
                      mle_iterations=535),
    "ghz7_mle_hot": dict(raw_fidelity=0.5573741793632507,
                         raw_fidelity_mitigated=0.9999403953552246,
                         mle_iterations=936)}
SCALING_DATA_RAW_TOL = 1e-5
SCALING_DATA_MLE_TOL = 1e-4
# A cut part's limit in the default run (RQC-6's parts take about 30 and 60
# s on the card).
SCALING_PART_TIMEOUT_S = 600
# The reference run's trace distance and held-out step (RESULTS.md:433-435,
# :250; examples/results_scaling.jsonl:11, :14),
# and how far below its fidelity the port's still agrees.
REFERENCE_RUN = {"rqc4_auto": dict(trace_distance=0.03514),
                 "rqc5_auto": dict(trace_distance=0.01162),
                 "ghz6_auto": dict(trace_distance=0.0252, best_step=775),
                 "rqc6_auto": dict(trace_distance=0.0173, best_step=25)}
REFERENCE_FIDELITY_MARGIN = 0.005


def cut_rung(tag: str):
    """The rung's recipe with the default run's cuts, each one printed."""
    import dataclasses

    cfg = scaling_rung(tag)
    for k, v in SCALING_CUTS[tag].items():
        log("scaling", f"{tag}: CUT {k} {getattr(cfg.train, k)} -> {v}")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                **SCALING_CUTS[tag]))
    for k, v in SCALING_SHOTS_CUT.get(tag, {}).items():
        log("scaling", f"{tag}: CUT {k} {getattr(cfg.data, k)} -> {v}")
    return cfg.replace(data=dataclasses.replace(
        cfg.data, **SCALING_SHOTS_CUT.get(tag, {})))


class _MleCapped:
    """Within the block, ``ops.mle.make_mle`` (as the pipeline calls it)
    stops every solve after ``iterations`` unless told otherwise."""

    def __init__(self, iterations: int):
        self.iterations = iterations

    def __enter__(self):
        from ddqst_tpu_torch.ops import mle

        self.make = make = mle.make_mle

        def capped(*args, **kw):
            kw.setdefault("iterations", self.iterations)
            return make(*args, **kw)

        mle.make_mle = capped
        return self

    def __exit__(self, *exc):
        from ddqst_tpu_torch.ops import mle

        mle.make_mle = self.make


class _TablesKept:
    """Within the block, the tables ``ops.diffusion._assembled_tables`` makes
    (``sample_all_bases_chunked``'s, walked by the kernel) are kept in
    ``self.tables``, for checking the samples against their exact
    propagation without building them again."""

    def __enter__(self):
        from ddqst_tpu_torch.ops import diffusion as diff

        self.make = make = diff._assembled_tables
        self.tables = None

        def keep(*args, **kw):
            self.tables = make(*args, **kw)
            return self.tables

        diff._assembled_tables = keep
        return self

    def __exit__(self, *exc):
        from ddqst_tpu_torch.ops import diffusion as diff

        diff._assembled_tables = self.make


class _CeStopped(Exception):
    """CE training stopped after a checkpoint (see ``_CeStop``)."""

    def __init__(self, epoch: int):
        super().__init__(f"CE stopped after epoch {epoch}'s checkpoint")
        self.epoch = epoch


class _CeStop:
    """Within the block, ``utils.checkpoint.save_checkpoint`` (as
    ``train.fit`` calls it) keeps only the newest checkpoint and raises
    ``_CeStopped`` right after writing epoch ``epoch``'s."""

    def __init__(self, epoch: int):
        self.epoch = epoch

    def __enter__(self):
        from ddqst_tpu_torch.utils import checkpoint as C

        self.save = save = C.save_checkpoint

        def save_then_stop(ckpt_dir, state, step):
            wrote = save(ckpt_dir, state, step)
            for old in C._steps(ckpt_dir)[:-1]:
                shutil.rmtree(os.path.join(ckpt_dir, str(old)))
            if step == self.epoch:
                raise _CeStopped(step)
            return wrote

        C.save_checkpoint = save_then_stop
        return self

    def __exit__(self, *exc):
        from ddqst_tpu_torch.utils import checkpoint as C

        C.save_checkpoint = self.save


def _role(ck, what: str, cfg, device: str = "cuda", seed: int = 0,
          **kw) -> tuple[dict, dict]:
    """One ``run_experiment`` at ``seed`` on ``device`` (the card), with the
    launch counts and the peak memory set to 0 just before and read just
    after.
    The record holds the stage seconds where the result has them (a
    ``stop_after`` result has JAX's three keys only), the run's log lines
    and when each came. A run that ``_CeStop`` stopped returns
    ``{'ce_stopped_at': epoch}``."""
    from ddqst_tpu_torch.pipeline import run_experiment

    cuda = torch.device(device).type == "cuda"
    lines, line_s = [], []

    def say(m):
        lines.append(m)
        line_s.append(time.perf_counter() - t0)
        log("scaling", m)

    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with ck.StepTimer() as timer:
            res = run_experiment(cfg, seed=seed, log_fn=say, device=device,
                                 **kw)
    except _CeStopped as stop:
        res = dict(ce_stopped_at=stop.epoch)
    if cuda:
        torch.cuda.synchronize()
    rec = dict(wall_s=time.perf_counter() - t0, log=lines, log_s=line_s,
               walk_launches=ck.fused_chain_walk.launches,
               step_launches=ck.fused_chain_step.launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda
               else None, **timer.summary())
    check(rec["step_timed_launches"] == rec["step_launches"],
          f"{what}: every step launch timed once")
    tm = res.get("timings")
    rec["generation_s"] = None
    if tm is not None:
        rec["timings"] = dict(tm)
        if "walk" in tm:
            rec["generation_s"] = tm.get("tables", 0.0) + tm["walk"]
    log("scaling", f"{what}: wall {rec['wall_s']:.2f} s, "
        + (f"peak {rec['peak_gb']:.2f} GB allocated, " if cuda else "")
        + "launches: walk "
        f"{rec['walk_launches']}, step {rec['step_launches']}" + (
            f" ({rec['step_ms_mean']:.4f} ms a launch by CUDA events, "
            f"{rec['step_ms_total']:.2f} ms in all)"
            if rec["step_ms_total"] is not None else "") + (
            "; stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in tm.items())
            if tm else ""))
    return res, rec


def scaling_checks(ck, tag: str, cfg, res: dict, rec: dict,
                   data_cut: bool, tables: torch.Tensor | None = None) -> dict:
    """A rung's checks on its ``run_experiment`` result: the launch plan, the
    samples against the model's exact chain distribution over every basis
    (TV within 4 shot-noise scales), the fidelity against the MLE of that
    distribution (within 0.02), ρ a state, and MLE on the raw counts at
    0.999 or more when the data is uncut. The exact distribution is the
    model's ``chain_distribution``, or, given the ``[T, 3^N, 2^N, N]``
    tables the walks read, their float64 propagation (a few rows of which
    are held against a recompute from the model)."""
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle, pauli
    from ddqst_tpu_torch.ops.schedules import make_schedule

    n, shots = cfg.data.num_qubits, cfg.data.shots_infer
    walks, steps = rec["walk_launches"], rec["step_launches"]
    plan = (SCALING_PLAN_CUT.get(tag, SCALING_PLAN[tag]) if data_cut
            else SCALING_PLAN[tag])
    check((walks, steps) == plan, f"{tag}: launches (walk, step) "
          f"{(walks, steps)} equal the plan {plan}")
    if walks:
        body = ck.fused_chain_walk.last_plan[3]
        check(body == ("staged" if n <= 7 else "ring"),
              f"{tag}: the walk took its body for N={n} ({body})")
    samples = res["samples"]
    check(tuple(samples.shape) == (3**n, shots, n) and samples.is_cuda,
          f"{tag}: samples [{3**n}, {shots}, {n}] on the card")
    check_rho(torch.from_numpy(res["rho"]), f"{tag}: rho")
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "trace_distance", "purity"):
        check(math.isfinite(res[k]), f"{tag}: {k} finite")

    dev = samples.device
    sched = make_schedule("cosine", cfg.diffusion.num_timesteps, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if tables is None:
        # The model's exact chain over all 3^N bases, 2^18 grid rows a
        # forward.
        dist = diff.chain_distribution_all_bases(
            res["state"], n, sched, cfg.diffusion.exact, max_rows=1 << 18)
    else:
        g, t_steps = 2**n, cfg.diffusion.num_timesteps
        rows, ts = [0, 3**n // 2, 3**n - 1], [t_steps, t_steps // 2, 1]
        grid = (diff._unpack(torch.arange(g, device=dev), n).repeat(3, 1),
                torch.tensor(rows, device=dev).repeat_interleave(g))
        with torch.no_grad():
            again = diff._tables_for_ts(
                res["state"], torch.tensor(ts, device=dev), n, sched,
                cfg.diffusion.exact, grid=grid)
        kept = tables[[t_steps - t for t in ts]][:, rows].reshape(3, -1, n)
        err = float((kept - again).abs().max())
        log("scaling", f"{tag}: the walks' tables at bases {rows}, t = "
            f"{ts} vs a recompute from the model: max abs err {err:.2e}")
        check(err < 1e-5, f"{tag}: the walks' tables are the model's")
        dist = exact_walk(tables, torch.full((3**n, g), 1 / g, device=dev))
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    idx = (samples.long() * (1 << torch.arange(n, device=dev))).sum(-1)
    tv = tv_rows(idx, dist.double())
    del idx
    bound = 4 * math.sqrt(2**n / (2 * math.pi * shots))
    # The all-X/Y bases (no Z): the coherence sector of RESULTS.md:363-377.
    xy = torch.from_numpy(~(pauli.all_basis_labels(n) == 2).any(-1)).to(dev)
    log("scaling", f"{tag}: samples vs the model's exact chain "
        f"({t_exact:.2f} s): "
        f"TV mean {float(tv.mean()):.5f}, max {float(tv.max()):.5f} (all-X/Y "
        f"bases: {int(xy.sum())}, max {float(tv[xy].max()):.5f}) < bound "
        f"{bound:.5f} over {3**n} bases")
    check(bool((tv < bound).all()), f"{tag}: samples TV {float(tv.max())} < "
          f"{bound} in every basis")
    solve: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rho_exact = mle.make_mle(n)(dist * shots, solve)
    torch.cuda.synchronize()
    t_mle = time.perf_counter() - t0
    target = torch.from_numpy(res["target"]).to(dev)
    fid_exact = float(M.state_fidelity(target, rho_exact))
    log("scaling", f"{tag}: fidelity {res['fidelity']:.5f} vs the MLE of the "
        f"exact chain {fid_exact:.5f} ({solve['iterations']} iterations, "
        f"{t_mle:.2f} s); raw {res['raw_fidelity']:.5f}, MLE on raw "
        f"{res['raw_fidelity_mitigated']:.5f}; MLE iterations "
        f"{res['mle_iterations']}")
    check(abs(res["fidelity"] - fid_exact) < 0.02,
          f"{tag}: fidelity within 0.02 of the exact chain's MLE")
    if not data_cut:
        check(res["raw_fidelity_mitigated"] >= 0.999,
              f"{tag}: MLE on the raw counts scores at least 0.999")
    ref = REFERENCE_SCALING[tag]
    log("scaling", f"{tag}: " + ", ".join(
        f"{k} {res[k]:.5f} (reference, uncut: {v:.5f})"
        for k, v in ref.items()))
    out = dict(tag=tag, num_qubits=n, fidelity=res["fidelity"],
               raw_fidelity=res["raw_fidelity"],
               raw_fidelity_mitigated=res["raw_fidelity_mitigated"],
               trace_distance=res["trace_distance"], purity=res["purity"],
               fidelity_exact_chain=fid_exact, max_tv_exact_chain=float(
                   tv.max()), tv_bound=bound,
               mle_iterations=res["mle_iterations"],
               exact_chain_s=t_exact, exact_chain_mle_s=t_mle,
               exact_chain_mle_iterations=solve["iterations"],
               train_steps=res["train_steps"],
               **{k: v for k, v in rec.items()
                  if k not in ("log", "log_s")})
    if "chain_info" in res:
        out.update(chain_record(res["chain_info"], res["ft_losses"]))
    return out


def chain_record(info: dict, ft_losses) -> dict:
    """A distillation's numbers in a rung's record: the full-grid chain CE
    before and after, the steps run and, with a held-out split, the best
    step, its CE and the held-out history ``[[step, CE], ...]``."""
    out = dict(ce_before=info["train_ce_before"],
               ce_after=info["train_ce_after"],
               distill_steps_run=len(ft_losses))
    if "best_step" in info:
        out.update(best_step=info["best_step"],
                   best_val_ce=info["best_val_ce"],
                   val_history=[[int(k), float(ce)] for k, ce
                                in info["val_history"]])
    return out


def scaling_run(ck, tag: str, cfg, data_cut: bool) -> dict:
    """One rung in one ``run_experiment`` call, with its checks. A
    distillation without a held-out split is held to finite losses only:
    from a fresh Adam state the hot recipe's first steps raise the chain CE
    (at N = 7 for its first 10 to 30 steps on the card), which later steps
    bring down."""
    res, rec = _role(ck, tag, cfg)
    if "chain_info" in res:
        info = res["chain_info"]
        steps = len(res["ft_losses"])
        log("scaling", f"{tag}: distillation ran {steps} of "
            f"{cfg.train.chain_finetune_steps} steps, "
            f"{rec['timings']['distill'] * 1e3 / max(steps, 1):.1f} ms a step "
            f"(its full-grid CE evaluations included); chain CE "
            f"{info['train_ce_before']:.5f} -> {info['train_ce_after']:.5f}"
            + (f"; held-out best {info['best_val_ce']:.5f} at step "
               f"{info['best_step']}" if "best_step" in info else ""))
        check(np.isfinite(res["ft_losses"]).all(), f"{tag}: finite losses")
        if "best_step" in info:
            check(info["best_val_ce"] <= info["val_history"][0][1]
                  and info["train_ce_after"] <= info["train_ce_before"] + 1e-6,
                  f"{tag}: the held-out selection is no worse than step 0")
    out = scaling_checks(ck, tag, cfg, res, rec, data_cut)
    log("scaling", "result " + json.dumps(out))
    return out


def scaling_segments(ck, tag: str, cfg, tmp: str,
                     data_cut: bool) -> dict:
    """The segment protocol of ``scripts/run_frontier_segments.py:130-205``
    through ``run_experiment``: a CE role (``params_save``,
    ``stop_after='distill'``, no distillation), the hard-mining segment
    (``SCALING_MINING_SEGMENT``, warm-started from the CE role's parameters
    with a fresh Adam state, on the data cache; it solves and caches the MLE
    target), then the eval role (the full tail, no distillation). A fresh
    Adam state's first hot steps may raise the chain CE (recorded)."""
    import dataclasses

    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    n = cfg.data.num_qubits
    def snap(name: str, kind: str = "params") -> str:
        return os.path.join(tmp, f"{tag}_{name}_{kind}")
    dcache, tcache = (os.path.join(tmp, f"{tag}_data.npz"),
                      os.path.join(tmp, f"{tag}_target.npz"))
    roles = {}

    res, roles["ce"] = _role(
        ck, f"{tag} CE role", cfg.replace(train=dataclasses.replace(
            cfg.train, chain_finetune_steps=0)),
        params_save=snap("ce"), stop_after="distill", data_cache=dcache)
    check(res["ft_info"] is None and np.isfinite(res["losses"]).all(),
          f"{tag}: the CE role trained ({len(res['losses'])} epochs), no "
          "distillation")
    model = restore_params(snap("ce"), build_model(
        cfg.model, n, cfg.diffusion.num_timesteps).cuda())
    check(all(bool(p.isfinite().all()) for p in model.parameters()),
          f"{tag}: the CE role's parameters load back, finite")
    del model

    accum, hard = SCALING_MINING_SEGMENT
    log("scaling", f"{tag}: CUT the distillation to the mining segment "
        f"alone (accum {accum}, hard_frac {hard}) from the CE role's "
        "parameters, a fresh Adam state: no uniform segment before it, "
        "nothing chained across segments")
    scfg = cfg.replace(train=dataclasses.replace(
        cfg.train, chain_finetune_steps=SCALING_SEGMENT_STEPS,
        chain_accum=accum, chain_hard_frac=hard))
    res, roles["seg0"] = _role(
        ck, f"{tag} mining segment (accum {accum}, hard_frac {hard})", scfg,
        params_load=snap("ce"), params_save=snap("seg0"),
        target_cache=tcache, stop_after="distill",
        opt_save=snap("seg0", "opt"), data_cache=dcache)
    info = res["ft_info"]
    roles["seg0"].update(ce_before=info["train_ce_before"],
                         ce_after=info["train_ce_after"])
    log("scaling", f"{tag} mining segment: chain CE "
        f"{info['train_ce_before']:.6f} -> {info['train_ce_after']:.6f}")
    check(len(res["ft_losses"]) == SCALING_SEGMENT_STEPS
          and np.isfinite(res["ft_losses"]).all(),
          f"{tag} mining segment: {SCALING_SEGMENT_STEPS} finite steps")
    opt = torch.load(snap("seg0", "opt"), weights_only=True)
    check(int(opt["count"]) == SCALING_SEGMENT_STEPS,
          f"{tag}: the Adam state saved after {int(opt['count'])} steps")
    check(os.path.exists(tcache)
          and not any("(cached," in m for m in roles["seg0"]["log"]),
          f"{tag}: the segment solved the MLE target and cached it")
    p = info.get("hard_draw_p")
    check(p is not None and float(p.max()) > 1.01 * float(p.min()),
          f"{tag}: the mining segment's draw weights are not uniform")
    log("scaling", f"{tag}: mining draw weights min {float(p.min()):.3e}, max "
        f"{float(p.max()):.3e} (uniform {1 / 3**n:.3e})")
    check(roles["seg0"]["walk_launches"] == 0
          and roles["seg0"]["step_launches"] == 0,
          f"{tag} mining segment: no kernel launch")

    with _TablesKept() as kept:
        res, rec = _role(ck, f"{tag} eval role", cfg.replace(
            train=dataclasses.replace(cfg.train, chain_finetune_steps=0)),
            params_load=snap("seg0"), data_cache=dcache)
    out = scaling_checks(ck, tag, cfg, res, rec, data_cut,
                         tables=kept.tables)
    del kept.tables
    for r in roles.values():
        del r["log"], r["log_s"]
    out["roles"] = roles
    out["hard_draw_p_max_over_min"] = float(p.max() / p.min())
    log("scaling", "result " + json.dumps(out))
    return out


def scaling_kernel_rows(ck) -> dict:
    """Both kernels at the rungs' shapes: each held against its plain version
    bit for bit on the card, then timed (CUDA events) beside the plain
    version and its bound."""
    rows = {}
    for i, (tag, (c, n, s)) in enumerate(SCALING_WALK_SHAPES.items()):
        tables, init = random_walk_inputs(100, c, n, s, seed=60 + i)
        out = ck.fused_chain_walk(9, tables, init, n)
        plan = ck.fused_chain_walk.last_plan
        check(torch.equal(out, ck.fused_chain_walk_reference(9, tables, init,
                                                             n)),
              f"walk kernel == plain bit for bit at {tag}'s shape")
        ms_k = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, n), 10)
        ms_r = cuda_ms(lambda: ck.fused_chain_walk_reference(
            5, tables, init, n), 1)
        bound, by = walk_bound_ms(100, c, n, s)
        rows[tag] = dict(kernel="fused_chain_walk", shape=[100, c, n, s],
                         ms=ms_k, plain_ms=ms_r, bound_ms=bound, bound_by=by,
                         x_bound=ms_k / bound, plan=list(plan))
        del tables, init
    for tag, (g, n, b) in SCALING_STEP_SHAPES.items():
        # The path's inputs: 834 neighbouring chains a basis share its 2^N
        # table rows, a random state each.
        table, x, base = route_like_step_inputs(1, n, b // 3**n, seed=70)
        check(table.shape[0] == g and x.shape[0] == b,
              f"{tag}'s step shape [{g}, {n}], B = {b}")
        check(torch.equal(
            ck.fused_chain_step(9, table, x, n, 3, row_base=base),
            ck.fused_chain_step_reference(9, table, x, n, 3, row_base=base)),
            f"step kernel == plain bit for bit at {tag}'s shape")
        ms_k = cuda_ms(lambda: ck.fused_chain_step(5, table, x, n, 1,
                                                   row_base=base), 50)
        ms_r = cuda_ms(lambda: ck.fused_chain_step_reference(
            5, table, x, n, 1, row_base=base), 2)
        bound, by = step_bound_ms(b, n, g, row_base=True)
        rows[tag] = dict(kernel="fused_chain_step", shape=[g, n, b], ms=ms_k,
                         plain_ms=ms_r, bound_ms=bound, bound_by=by,
                         x_bound=ms_k / bound)
    for tag, r in rows.items():
        log("scaling", f"{r['kernel']} at {tag}'s shape {r['shape']}: kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['x_bound']:.2f} x "
            "bound" + (f", plan {r['plan']}" if "plan" in r else ""))
    return rows


def scaling_split_cut(tag: str) -> dict:
    """A split rung with the default run's cuts, each part of
    ``SCALING_CUT_PARTS`` in a child process (``--scaling-part TAG PART DIR
    DIR --cut``), as the chip calls run them, with one folder as each
    part's input and output. The parts' records, the evaluating part's
    (launches, checks) at the top; the seconds the rung adds."""
    t0 = time.perf_counter()
    log("scaling", f"{tag}: CUT to {describe_split(SCALING_CUT_PARTS[tag])}, "
        "each part in a child process; every MLE solve to "
        f"{SCALING_MLE_ITERS[tag]} iterations (uncut: "
        f"{describe_split(SCALING_PARTS[tag])})")
    from ddqst_tpu_torch.campaigns.segments import run_child

    parts = {}
    with tempfile.TemporaryDirectory() as d:
        for part in SCALING_CUT_PARTS[tag]:
            check(run_child([sys.executable, os.path.abspath(__file__),
                             "--scaling-part", tag, part, d, d, "--cut"],
                            f"{tag} part {part}", SCALING_PART_TIMEOUT_S),
                  f"{tag} part {part}: the child process exited 0")
            with open(os.path.join(d, f"{tag}_{part}.json")) as f:
                parts[part] = json.load(f)
    last = parts[list(parts)[-1]]
    for part, rec in list(parts.items())[:-1]:
        check(rec["walk_launches"] == rec["step_launches"] == 0,
              f"{tag} part {part}: no kernel launch")
    check((last["walk_launches"], last["step_launches"]) == SCALING_PLAN[tag],
          f"{tag}: the evaluating part launched as the plan says")
    out = dict(last, parts=parts, wall_s=time.perf_counter() - t0)
    log("scaling", f"{tag}: the split rung, cut, took {out['wall_s']:.1f} s "
        "(its child processes' start included)")
    return out


def phase_scaling(ck) -> dict:
    """The scaling ladder at full width with the default run's cuts: GHZ-5
    and GHZ-7 in one ``run_experiment`` each, GHZ-8 through the segment
    protocol, all in this process, while RQC-6's parts run in child
    processes beside them (each process counts its own launches). The
    kernels at the rungs' shapes are timed after the phase, when no other
    process shares the card (``scaling_kernel_rows``)."""
    t_phase = time.perf_counter()
    rungs = {}
    with ThreadPoolExecutor(len(SCALING_CUT_PARTS)) as pool:
        split = {tag: pool.submit(scaling_split_cut, tag)
                 for tag in SCALING_CUT_PARTS}
        for tag in ("ghz5_auto", "ghz7_mle_hot", "ghz8_mle_hot"):
            cfg, cut = cut_rung(tag), tag in SCALING_SHOTS_CUT
            log("scaling", f"{tag}: CUT every MLE solve to "
                f"{SCALING_MLE_ITERS[tag]} iterations (uncut: to its "
                "tolerance, at most 4,000)")
            with _MleCapped(SCALING_MLE_ITERS[tag]):
                if tag != "ghz8_mle_hot":
                    rungs[tag] = scaling_run(ck, tag, cfg, cut)
                    continue
                log("scaling", f"{tag}: CUT the distillation to "
                    f"{SCALING_SEGMENT_STEPS} steps (the recipe: 1600 steps; "
                    "its campaign: 4 uniform and 2 mining segments of 800)")
                with tempfile.TemporaryDirectory() as tmp:
                    rungs[tag] = scaling_segments(ck, tag, cfg, tmp, cut)
        own_s = time.perf_counter() - t_phase
        rungs.update({tag: f.result() for tag, f in split.items()})
    split_s = max(rungs[tag]["wall_s"] for tag in SCALING_CUT_PARTS)
    phase_s = time.perf_counter() - t_phase
    log("scaling", f"phase time {phase_s:.1f} s: {own_s:.1f} s the rungs in "
        f"this process and their checks, {split_s:.1f} s the split rungs' "
        "parts beside them")
    return dict(rungs=rungs, phase_s=phase_s, own_s=own_s, split_s=split_s)


def scaling_uncut(ck, tags: list[str]) -> list[dict]:
    """``--scaling TAG ...``: each named rung uncut, in one
    ``run_experiment`` call, with the rung's checks."""
    import dataclasses

    runs = []
    for tag in tags:
        cfg = scaling_rung(tag)
        # The recipe logs no epoch; every 25th is logged here, so a run cut
        # by a time limit shows how far it got.
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, log_every=25))
        log("scaling", f"{tag}: uncut: {cfg.train.num_epochs} CE epochs, "
            f"{cfg.train.chain_finetune_steps} distillation steps, "
            f"{cfg.data.shots_train} / {cfg.data.shots_infer} shots a basis")
        runs.append(scaling_run(ck, tag, cfg, data_cut=False))
    return runs


def describe_split(parts: dict) -> str:
    """One line of a rung's split: each part's CE epochs, distillation
    steps and tail."""
    def one(name, p):
        what = []
        if "ce" in p:
            what.append(f"CE epochs {p['ce'][0] + 1}-{p['ce'][1]}")
        else:
            what.append("warm start")
        if p.get("steps"):
            what.append(f"{p['steps']} distillation steps")
        if p.get("eval"):
            what.append("generation and estimators")
        return f"{name}: " + ", ".join(what)
    return "; ".join(one(k, p) for k, p in parts.items())


def part_files(tag: str, parts: dict, part: str, in_dir: str, out_dir: str,
               data: str | None = None, mle_target: bool = False) -> dict:
    """Where part ``part`` of a split rung reads and writes: ``needs`` (the
    files it reads, which must exist before it starts), the checkpoint it
    resumes from, the epoch it stops after, the ``chain_key_salt`` offset,
    and the ``run_experiment`` arguments (the data cache among them) that
    chain it to the previous part (with ``mle_target`` the distilling parts
    share the MLE target's cache). Raises ``ValueError`` for a split that
    cannot run (a part that stops CE early and also distils or evaluates,
    a stop that is not on a checkpoint, an unknown part)."""
    if part not in parts:
        raise ValueError(f"{tag}: no part {part!r}; parts: {list(parts)}")
    names = list(parts)
    k, spec = names.index(part), parts[part]
    prev = parts[names[k - 1]] if k else None
    salt = sum(bool(parts[p].get("steps")) for p in names[:k])

    def inp(name):
        return os.path.join(in_dir, f"{tag}_{name}")

    def outp(name):
        return os.path.join(out_dir, f"{tag}_{name}")

    if data is None:
        data = (repo_file(SCALING_DATA[tag]) if tag in SCALING_DATA
                else inp("data.npz") if k else outp("data.npz"))
    needs = [data] if k or tag in SCALING_DATA else []
    kw = dict(data_cache=data)
    out = dict(needs=needs, kw=kw, salt=salt, resume_from="", stop=None)
    if "ce" in spec:
        a, b = spec["ce"]
        out["stop"] = b if b < spec.get("total", b) else None
        if out["stop"] is not None and (spec.get("steps")
                                        or spec.get("eval")):
            raise ValueError(f"{tag} {part}: a part that stops CE early "
                             "neither distils nor evaluates")
        if b % spec["every"]:
            raise ValueError(f"{tag} {part}: CE stops at epoch {b}, not on a "
                             f"checkpoint (every {spec['every']})")
        if a:
            out["resume_from"] = os.path.join(inp("ckpt"), str(a))
            needs.append(os.path.join(out["resume_from"], "checkpoint.pt"))
    else:
        kw["params_load"] = inp(f"{names[k - 1]}_params.pt")
        needs.append(kw["params_load"])
        if prev.get("steps"):
            kw["opt_load"] = inp(f"{names[k - 1]}_opt.pt")
            needs.append(kw["opt_load"])
    if spec.get("steps") and mle_target:
        kw["target_cache"] = inp("target.npz") if salt else outp("target.npz")
        if salt:
            needs.append(kw["target_cache"])
    return out


def part_setup(tag: str, part: str, in_dir: str, out_dir: str, cut: bool,
               cfg=None, parts: dict | None = None,
               data: str | None = None) -> tuple:
    """The rung's config (with ``cut``, its CE epochs cut to the cut
    split's), its split (each part with the CE total) and the part's files
    (``part_files``); raises ``FileNotFoundError`` when a file the part
    reads is missing."""
    import dataclasses

    if parts is None:
        parts = (SCALING_CUT_PARTS if cut else SCALING_PARTS)[tag]
    if cfg is None:
        cfg = scaling_rung(tag)
        if cut:
            total = max(p["ce"][1] for p in parts.values() if "ce" in p)
            log("scaling", f"{tag}: CUT num_epochs {cfg.train.num_epochs} -> "
                f"{total}")
            cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                        num_epochs=total))
    parts = {k: dict(p, total=cfg.train.num_epochs) for k, p in parts.items()}
    plan = part_files(tag, parts, part, in_dir, out_dir, data,
                      mle_target=cfg.train.chain_target == "mle")
    missing = [p for p in plan["needs"] if not os.path.exists(p)]
    if missing:
        raise FileNotFoundError(
            f"{tag} {part}: missing {missing}; move the previous part's "
            f"outputs into {in_dir} first")
    return cfg, parts, plan


def part_record_name(tag: str, part: str, seed: int = 0,
                     diagnostics: str = "") -> str:
    """The file name of a part's record at ``seed``, the suffix of its
    diagnostics after the seed: ``TAG_PART.json``, ``TAG_PART_seedK.json``
    for K > 0, e.g. ``TAG_PART_seed1_salt2.json``."""
    return (f"{tag}_{part}" + (f"_seed{seed}" if seed else "")
            + diagnostics + ".json")


def predecessor_check(tag: str, names: list[str], part: str, in_dir: str,
                      seed: int, params_in_sha: str | None) -> None:
    """One seed a chain: the record of the part before ``part`` in
    ``IN_DIR`` (``TAG_PREV_seedK.json`` at seed K > 0, else
    ``TAG_PREV.json``), where there is one, must have been run at ``seed``
    (a record without ``seed`` was run at 0) and have left the parameters
    this part was handed (its ``params_out_sha256`` is ``params_in_sha``;
    a record without the key is not held to it). Raises ``ValueError``
    otherwise, before any work."""
    k = names.index(part)
    if not k:
        return
    found = [p for p in dict.fromkeys(
        os.path.join(in_dir, part_record_name(tag, names[k - 1], s))
        for s in (seed, 0)) if os.path.exists(p)]
    if not found:
        return
    with open(found[0]) as f:
        prev = json.load(f)
    if prev.get("seed", 0) != seed:
        raise ValueError(f"{tag} {part} at seed {seed}: its predecessor's "
                         f"record {found[0]} was run at seed "
                         f"{prev.get('seed', 0)}")
    want = prev.get("params_out_sha256")
    if want is not None and want != params_in_sha:
        raise ValueError(f"{tag} {part}: handed parameters with sha256 "
                         f"{params_in_sha}, but {found[0]} left {want}")


def file_sha256(path: str) -> str:
    """The sha256 of a file's bytes, as ``sha256sum`` prints it."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def scaling_part(ck, tag: str, part: str, in_dir: str, out_dir: str,
                 cut: bool = False, *, cfg=None, parts: dict | None = None,
                 data: str | None = None, device: str = "cuda",
                 salt: int = 0, seed: int = 0,
                 draws: tuple | None = None) -> tuple[dict, dict, dict]:
    """``--scaling-part TAG PART IN_DIR OUT_DIR``: one part of a rung split
    across processes (``SCALING_PARTS``, or with ``cut`` the default run's
    ``SCALING_CUT_PARTS``), through ``run_experiment`` with the recipe
    unchanged. It refuses to start (``FileNotFoundError``, before any work)
    when a file it reads is missing: the rung's data, the previous part's
    checkpoint, parameters or Adam state under ``IN_DIR``. It writes under
    ``OUT_DIR``: a CE part that stops early its one checkpoint
    (``TAG_ckpt/<epoch>/``), a part that neither stops nor evaluates its
    parameters and Adam state (``TAG_PART_params.pt`` / ``_opt.pt``), the
    first part without committed data ``TAG_data.npz``, the first that
    distils against the MLE target ``TAG_target.npz`` (the mode adds the
    record, ``TAG_PART.json``). The record holds the sha256 of the
    parameters the part starts from (``params_in_sha256``: the previous
    part's parameter file, or the checkpoint a CE part resumes from; ``None``
    for a fresh start) and of those it leaves (``params_out_sha256``: its
    parameter file or its one checkpoint; ``None`` for an evaluating part),
    so each part's input is its predecessor's output, and the ``seed`` it
    ran at (``run_experiment``'s: the CE model's initialisation and batch
    order, the distillation's basis stream, the generation's draws; the
    data is the committed file's). Before any work it holds the
    predecessor's record in ``IN_DIR``, where there is one
    (``predecessor_check``), to this part's seed and input. Returns
    ``(record, result, role record)``;
    ``cfg``, ``parts``, ``data`` and ``device`` stand in for the rung's for
    a test on the CPU. ``salt`` is added to the part's ``chain_key_salt``;
    ``draws`` (``load_draws``' rows and name) are the minibatches it takes
    (``_Draws``), one row a step run, which it checks at the end. A
    distilling part records the matmul precision it ran at
    (``ops.precision.current()``). The evaluation's checks are
    ``scaling_part_checks``."""
    from ddqst_tpu_torch.ops import precision

    import dataclasses

    cfg, parts, plan = part_setup(tag, part, in_dir, out_dir, cut, cfg,
                                  parts, data)
    tr, spec, kw = cfg.train, parts[part], plan["kw"]
    names = list(parts)
    params_in = kw.get("params_load") or (
        os.path.join(plan["resume_from"], "checkpoint.pt")
        if plan["resume_from"] else None)
    params_in_sha = file_sha256(params_in) if params_in else None
    predecessor_check(tag, names, part, in_dir, seed, params_in_sha)
    log("scaling", f"{tag} part {part}{' (CUT)' if cut else ''}, split "
        f"{describe_split(parts)}; {tr.num_epochs} CE epochs in all"
        + (f"; seed {seed}" if seed else ""))
    if params_in_sha:
        log("scaling", f"{tag} {part}: starts from {params_in} (sha256 "
            f"{params_in_sha})")
    os.makedirs(out_dir, exist_ok=True)
    steps = spec.get("steps", 0)
    train_kw = dict(chain_finetune_steps=steps,
                    chain_key_salt=tr.chain_key_salt + plan["salt"] + salt,
                    log_every=tr.log_every or (1 if cut else 25))
    tmp = None
    if "ce" in spec and (spec["ce"][0] or plan["stop"] is not None):
        if plan["stop"] is not None:
            ckpt_dir = os.path.join(out_dir, f"{tag}_ckpt")
        else:
            tmp = ckpt_dir = tempfile.mkdtemp(prefix=f"{tag}_ckpt_")
        if plan["resume_from"]:
            dst = os.path.join(ckpt_dir, str(spec["ce"][0]))
            if os.path.abspath(dst) != os.path.abspath(plan["resume_from"]):
                shutil.copytree(plan["resume_from"], dst, dirs_exist_ok=True)
        train_kw.update(checkpoint_dir=ckpt_dir,
                        checkpoint_every=spec["every"],
                        resume=bool(spec["ce"][0]))
    if not spec.get("eval") and plan["stop"] is None:
        kw.update(stop_after="distill",
                  params_save=os.path.join(out_dir, f"{tag}_{part}_params.pt"))
        if steps:
            kw["opt_save"] = os.path.join(out_dir, f"{tag}_{part}_opt.pt")
    pcfg = cfg.replace(train=dataclasses.replace(tr, **train_kw))
    try:
        stop = (_CeStop(plan["stop"]) if plan["stop"] is not None
                else contextlib.nullcontext())
        stand_in = (_Draws(draws[0], 3**cfg.data.num_qubits) if draws
                    else contextlib.nullcontext())
        with stop, stand_in:
            res, rec = _role(ck, f"{tag} {part}", pcfg, device=device,
                             seed=seed, **kw)
    finally:
        if tmp:
            shutil.rmtree(tmp, ignore_errors=True)
    params_out = kw.get("params_save") or (
        os.path.join(train_kw["checkpoint_dir"], str(plan["stop"]),
                     "checkpoint.pt") if plan["stop"] is not None else None)
    out = dict(tag=tag, part=part, cut=cut, split=describe_split(parts),
               parts=names, seed=seed, params_in_sha256=params_in_sha,
               params_out_sha256=file_sha256(params_out) if params_out
               else None,
               **{k: v for k, v in rec.items() if k not in ("log", "log_s")})
    if steps:
        out.update(chain_key_salt=train_kw["chain_key_salt"],
                   salt_offset=salt, matmul_precision=precision.current())
    if draws:
        ran = len(res["ft_losses"])
        check(stand_in.used == ran, f"{tag} {part}: one row of the draw "
              f"file a step ({stand_in.used} rows, {ran} steps)")
        out.update(draws=draws[1], draw_rows_used=stand_in.used,
                   first_losses=[float(v) for v in res["ft_losses"][:25]])
    if plan["stop"] is not None:
        check(res.get("ce_stopped_at") == plan["stop"],
              f"{tag} {part}: CE stopped after epoch {plan['stop']}'s "
              "checkpoint")
        from ddqst_tpu_torch.utils import checkpoint as C

        kept = C._steps(train_kw["checkpoint_dir"])
        check(kept == [plan["stop"]], f"{tag} {part}: one checkpoint kept, "
              f"epoch {plan['stop']} ({kept})")
        out.update(_ce_timing(rec, spec["ce"], cfg))
        log("scaling", f"{tag} {part}: CE stopped after epoch "
            f"{spec['ce'][1]} ({out['train_steps']} steps, "
            f"{out['ms_per_step']:.3f} ms a step); checkpoint "
            f"{os.path.join(train_kw['checkpoint_dir'], str(spec['ce'][1]))}")
    elif "ce" in spec and "timings" not in res:
        # CE to its end with nothing after it (``stop_after='distill'``).
        out.update(_ce_timing(rec, spec["ce"], cfg))
        log("scaling", f"{tag} {part}: CE epochs {spec['ce'][0] + 1}-"
            f"{spec['ce'][1]} ({out['train_steps']} steps, "
            f"{out['ms_per_step']:.3f} ms a step)")
    else:
        out.update(train_steps=res.get("train_steps"),
                   ce_epochs=list(spec["ce"]) if "ce" in spec else None)
        if res.get("train_steps") and "timings" in res:
            out["ms_per_step"] = (res["timings"]["train"] * 1e3
                                  / res["train_steps"])
        info = res.get("chain_info") or res.get("ft_info")
        if info is not None:
            out.update(chain_record(info, res["ft_losses"]))
        if steps and "timings" not in res:
            out.update(_distill_stages(rec, len(res["ft_losses"])))
    return out, res, rec


# The pipeline's log lines that open a distillation, close its target and
# close the distillation (its full-grid chain CE after the steps).
_DISTILL_MARKS = (("start", "exact-chain distillation:"),
                  ("target", "distillation target:"),
                  ("end", "chain CE ("))


def _distill_stages(rec: dict, steps: int) -> dict:
    """A distilling part's stage seconds from its log (a ``stop_after``
    result has no timings): ``target_s`` from the distillation's first line
    to the target's, ``distill_s`` from there to the chain CE line (the
    steps and the full-grid chain CE before and after them) and
    ``distill_s_per_step``. Empty when a line is missing."""
    at: dict = {}
    for m, t in zip(rec["log"], rec["log_s"]):
        for key, mark in _DISTILL_MARKS:
            if mark in m:
                at.setdefault(key, t)
    if len(at) < len(_DISTILL_MARKS) or not steps:
        return {}
    distill = at["end"] - at["target"]
    return dict(target_s=at["target"] - at["start"], distill_s=distill,
                distill_s_per_step=distill / steps)


def _ce_timing(rec: dict, ce: tuple, cfg) -> dict:
    """A CE part's stage seconds from its log (a result without
    ``timings``): the data until fit's first line, then training; its
    steps and ms a step."""
    t_fit = next(t for m, t in zip(rec["log"], rec["log_s"])
                 if "training on" in m)
    a, b = ce
    n_steps = (b - a) * max(3**cfg.data.num_qubits * cfg.data.shots_train
                            // cfg.train.batch_size, 1)
    return dict(timings=dict(datagen=t_fit, train=rec["wall_s"] - t_fit),
                ce_epochs=[a, b], train_steps=n_steps,
                ms_per_step=(rec["wall_s"] - t_fit) * 1e3 / n_steps)


def scaling_part_checks(ck, tag: str, cfg, res: dict, rec: dict,
                        cut: bool) -> dict:
    """An evaluating part's checks: the rung's (``scaling_checks``; MLE on
    the raw counts held to 0.999 only uncut, the cut capping every solve),
    the raw-inversion fidelity equal to the JAX package's on the same file
    within ``SCALING_DATA_RAW_TOL`` and, uncut, MLE on the raw counts within
    ``SCALING_DATA_MLE_TOL`` of the JAX package's solve; then the generative
    fidelity beside the reference's row (recorded, not held): agreement when
    at most ``REFERENCE_FIDELITY_MARGIN`` below it."""
    info = res.get("chain_info")
    if info is not None:
        check(np.isfinite(res["ft_losses"]).all(), f"{tag}: finite losses")
        if "best_step" in info:
            check(info["best_val_ce"] <= info["val_history"][0][1]
                  and info["train_ce_after"] <= info["train_ce_before"] + 1e-6,
                  f"{tag}: the held-out selection is no worse than step 0")
    out = scaling_checks(ck, tag, cfg, res, rec, data_cut=cut)
    jax_side = SCALING_DATA_JAX.get(tag)
    if jax_side is not None:
        err = abs(res["raw_fidelity"] - jax_side["raw_fidelity"])
        log("scaling", f"{tag}: raw inversion {res['raw_fidelity']:.7f} vs "
            f"the JAX package's {jax_side['raw_fidelity']:.7f} on the same "
            f"file: |diff| {err:.2e}")
        check(err <= SCALING_DATA_RAW_TOL, f"{tag}: raw inversion equals the "
              f"JAX package's within {SCALING_DATA_RAW_TOL}")
        out["raw_fidelity_jax"] = jax_side["raw_fidelity"]
        if not cut:
            err = abs(res["raw_fidelity_mitigated"]
                      - jax_side["raw_fidelity_mitigated"])
            log("scaling", f"{tag}: MLE on raw "
                f"{res['raw_fidelity_mitigated']:.7f} "
                f"({res['mle_iterations']['raw']} iterations) vs the JAX "
                f"package's {jax_side['raw_fidelity_mitigated']:.7f} "
                f"({jax_side['mle_iterations']}): |diff| {err:.2e}")
            check(err <= SCALING_DATA_MLE_TOL, f"{tag}: MLE on raw within "
                  f"{SCALING_DATA_MLE_TOL} of the JAX package's solve")
            out["raw_fidelity_mitigated_jax"] = jax_side[
                "raw_fidelity_mitigated"]
    ref = dict(REFERENCE_SCALING[tag], **REFERENCE_RUN.get(tag, {}))
    gap = res["fidelity"] - ref["fidelity"]
    out["verdict"] = ("cut, not compared" if cut else "above the row"
                      if gap > 0 else "agreement"
                      if gap >= -REFERENCE_FIDELITY_MARGIN else "miss")
    log("scaling", f"{tag}: fidelity {res['fidelity']:.5f} vs the reference's "
        f"{ref['fidelity']:.5f} ({gap:+.5f}: {out['verdict']}); trace "
        f"distance {res['trace_distance']:.5f} vs "
        f"{ref.get('trace_distance')}; "
        f"held-out step {out.get('best_step')} vs {ref.get('best_step')}; "
        f"chain CE {out.get('ce_before')} -> {out.get('ce_after')}; held-out "
        f"history {out.get('val_history')}")
    return out


def no_stop(cfg, parts: dict, part: str, steps: int) -> tuple:
    """A diagnostic form of a distilling part (``--no-stop K``), not the
    recipe: ``steps`` distillation steps with the held-out patience past
    them, so every held-out evaluation runs and the selection keeps the
    best of all. Returns the config and split to run it with."""
    import dataclasses

    if not parts[part].get("steps"):
        raise ValueError(f"part {part!r} does not distil")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, chain_finetune_steps=steps,
        chain_val_patience=steps + 1))
    return cfg, dict(parts, **{part: dict(parts[part], steps=steps)})


def load_draws(path: str, tag: str, cfg, steps: int, salt: int,
               seed: int = 0) -> tuple[np.ndarray, str]:
    """A basis-draw file (``tools/make_reference_data.py --draws``) for a
    distilling part of ``tag`` that runs ``steps`` steps at ``seed`` with
    ``salt`` added to the recipe's ``chain_key_salt``: its rows and their
    name (``jax_seedS``, ``_saltK`` after it for a salt). Raises
    ``ValueError``, before any work, for a file that has fewer than
    ``steps`` rows or rows of another length than the recipe's basis batch,
    or that was drawn for another rung, seed, salt or chunk length."""
    tr = cfg.train
    with np.load(path) as f:
        rows = f["draws"]
        meta = {k: f[k].item() for k in ("tag", "seed", "salt",
                                         "steps_per_call")}
    if rows.ndim != 2 or rows.shape[0] < steps or (
            rows.shape[1] != tr.chain_basis_batch):
        raise ValueError(f"{path}: draws {list(rows.shape)}, the part needs "
                         f"[>= {steps}, {tr.chain_basis_batch}]")
    want = dict(tag=tag, seed=seed, salt=salt,
                steps_per_call=tr.chain_steps_per_call)
    for k, v in want.items():
        if meta[k] != v:
            raise ValueError(f"{path}: drawn for {k} {meta[k]!r}, the part "
                             f"runs {k} {v!r}")
    return rows, f"jax_seed{seed}" + (f"_salt{salt}" if salt else "")


class _Draws:
    """Within the block, ``torch.multinomial`` hands out the rows of a
    basis-draw file in order, one a call, on the device of the weights it
    is given: the distillation's minibatch draw (``train.finetune_chain``)
    on another package's stream, the package's API unchanged. Any other
    call, or one past the last row, raises. ``used`` counts the rows
    handed out."""

    def __init__(self, rows: np.ndarray, num_bases: int):
        self.rows, self.num_bases, self.used = rows, num_bases, 0

    def __enter__(self):
        self.own = torch.multinomial

        def draw(p, num_samples, replacement=False, *, generator=None):
            if (replacement or tuple(p.shape) != (self.num_bases,)
                    or num_samples != self.rows.shape[1]):
                raise RuntimeError(
                    f"torch.multinomial{(tuple(p.shape), num_samples)} is "
                    "not the distillation's draw")
            if self.used == len(self.rows):
                raise RuntimeError(f"all {self.used} rows of the draw file "
                                   "are used")
            row = torch.from_numpy(self.rows[self.used].astype(np.int64))
            self.used += 1
            return row.to(p.device)

        torch.multinomial = draw
        return self

    def __exit__(self, *exc):
        torch.multinomial = self.own


SCALING_PART_USAGE = ("usage: chip_smoke.py --scaling-part TAG PART IN_DIR "
                      "OUT_DIR [--cut | --no-stop K] [--draws FILE] "
                      "[--salt K] [--seed K] "
                      "[--matmul-precision float32|bfloat16] "
                      "[--row-note TEXT]")
# A distilling part's record and row name a diagnostic precision so.
PRECISION_TAGS = {"float32": "", "bfloat16": "bf16"}


def scaling_part_args(argv: list[str]) -> dict:
    """``--scaling-part``'s arguments, checked before any work: the part's
    inputs (``part_setup``: ``FileNotFoundError``), then the diagnostics,
    which run only uncut and only on a distilling part (``--no-stop K``,
    ``--salt K``, ``--draws FILE`` against the part by ``load_draws``,
    ``--matmul-precision`` one of ``ops.precision.MODES``), ``--seed K``
    (K >= 0, ``run_experiment``'s seed), which any uncut part takes, and
    ``--row-note TEXT``, which only an uncut evaluating part takes (added to
    its row's note, for what the records cannot say, such as parts that
    shared the card): ``ValueError``. Returns what ``scaling_part`` and the
    record need."""
    args = list(argv)

    def take(flag: str):
        if flag not in args:
            return None
        i = args.index(flag)
        if i + 1 == len(args):
            raise ValueError(f"{flag} needs a value; {SCALING_PART_USAGE}")
        value = args[i + 1]
        del args[i:i + 2]
        return value

    cut = "--cut" in args
    args = [a for a in args if a != "--cut"]
    diag = int(take("--no-stop") or 0)
    salt = int(take("--salt") or 0)
    seed = take("--seed")
    draws = take("--draws")
    mm = take("--matmul-precision")
    note = take("--row-note")
    if mm is not None and mm not in PRECISION_TAGS:
        raise ValueError(f"unknown matmul precision {mm!r}; options: "
                         f"{list(PRECISION_TAGS)}")
    if len(args) != 4:
        raise ValueError(SCALING_PART_USAGE)
    if seed is not None and (cut or not seed.isdigit()):
        raise ValueError(f"--seed takes an integer of 0 or more and an "
                         f"uncut part (--seed {seed}"
                         + (", --cut)" if cut else ")"))
    seed = int(seed or 0)
    tag, part, in_dir, out_dir = args
    cfg, parts, plan = part_setup(tag, part, in_dir, out_dir, cut)
    if ((diag or salt or draws or mm)
            and (cut or not parts[part].get("steps"))):
        raise ValueError(f"{tag} {part}: --no-stop, --salt, --draws and "
                         "--matmul-precision take an uncut distilling part")
    if note is not None and (cut or not parts[part].get("eval")):
        raise ValueError(f"{tag} {part}: --row-note takes an uncut "
                         "evaluating part")
    if diag:
        cfg, parts = no_stop(cfg, parts, part, diag)
    return dict(tag=tag, part=part, in_dir=in_dir, out_dir=out_dir, cut=cut,
                cfg=cfg, parts=parts, no_stop=diag, salt=salt, seed=seed,
                row_note=note, matmul_precision=mm or "float32",
                draws=None if draws is None else load_draws(
                    draws, tag, cfg, parts[part]["steps"],
                    plan["salt"] + salt, seed))


def part_names(a: dict) -> tuple[str, str]:
    """For ``scaling_part_args``' result ``a``: the part's record file name
    (``part_record_name`` with the seed, then the precision, ``--no-stop``,
    draw file and salt suffixes) and what an uncut evaluating part adds to
    its row's note (the seed, the draw stream, the precision,
    ``--row-note``)."""
    stream = "".join(([f"_{a['draws'][1]}"] if a["draws"] else [])
                     + ([f"_salt{a['salt']}"] if a["salt"] else []))
    mm = a["matmul_precision"]
    mm_tag = PRECISION_TAGS[mm]
    name = part_record_name(a["tag"], a["part"], a["seed"], (
        (f"_{mm_tag}" if mm_tag else "")
        + (f"_nostop{a['no_stop']}" if a["no_stop"] else "") + stream))
    note = "".join(
        ([f"; seed {a['seed']}"] if a["seed"] else [])
        + ([f"; draw stream {stream[1:]}"] if stream else [])
        + ([f"; matmul precision {mm} (bf16-input products)"] if mm_tag
           else [])
        + ([f"; {a['row_note']}"] if a["row_note"] else []))
    return name, note


def split_row(tag: str, cfg, res: dict, in_dir: str, parts: list[str],
              wall_s: float, smi: str, seed: int = 0) -> tuple[dict, dict]:
    """A split rung's row in ``campaigns.scaling``'s schema (its ``row``),
    from the evaluating (last) part's result: ``wall_s`` the sum of every
    part's, the earlier parts' read from their records in ``in_dir``
    (``part_record_name`` at ``seed``; a missing one is logged and left
    out). Returns the row and each part's seconds."""
    from ddqst_tpu_torch.campaigns.scaling import experiment, row

    walls = {}
    for p in parts[:-1]:
        path = os.path.join(in_dir, part_record_name(tag, p, seed))
        if os.path.exists(path):
            with open(path) as f:
                walls[p] = json.load(f)["wall_s"]
        else:
            log("scaling", f"{tag}: no record {path}; its seconds are not "
                "in the row's wall_s")
    walls[parts[-1]] = wall_s
    return row(tag, cfg, experiment(tag)[1], res, sum(walls.values()),
               smi), walls


def scaling_costs() -> dict:
    """``--scaling-costs``: what the stages of the GHZ-7 and GHZ-8 rungs cost
    on the card, each measured alone on the recipe's data (seed 0): the
    data step and its peak memory; MLE on the raw counts capped at 50, 200
    and 1,000 iterations (ms an iteration, fidelity); one CE epoch on the
    first 500 shots a basis; two full-grid chain passes; then the hot
    recipe's distillation (``chain_lr`` 1e-3, the recipe's basis batch)
    against the raw counts in four chained segments, 5 uniform, 5 mining
    (accum 4, hard_frac 0.5), 10 and 10 uniform steps, with the Adam state
    carried over, each segment's full-grid chain CE before and after."""
    import dataclasses

    from ddqst_tpu_torch import pipeline, train
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle
    from ddqst_tpu_torch.ops.schedules import make_schedule

    def now() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    out = {}

    def say(key: str, rec: dict) -> None:
        out[key] = rec
        log("costs", f"{key} {json.dumps(rec)}")

    for n, tag in ((7, "ghz7_mle_hot"), (8, "ghz8_mle_hot")):
        cfg = scaling_rung(tag)
        torch.cuda.reset_peak_memory_stats()
        t = now()
        g_data, g_train, _ = pipeline._generators(0, torch.device("cuda"))
        data = pipeline.generate_training_data(cfg, g_data,
                                               np.random.default_rng(0))
        say(f"n{n}_datagen", dict(
            s=now() - t, peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        target = torch.from_numpy(data.target).cuda()
        raw = mle.bits_to_counts(data.bits)
        for cap in (50, 200, 1000):
            info: dict = {}
            t = now()
            rho = mle.make_mle(n, data.basis_labels, readout_p=0.01,
                               iterations=cap)(raw, info)
            dt = now() - t
            say(f"n{n}_mle_raw_cap{cap}", dict(
                s=dt, ms_per_iter=dt * 1e3 / info["iterations"],
                it=info["iterations"],
                fid=float(M.state_fidelity(target, rho))))
        sched = make_schedule("cosine", 100, "cuda")
        model = build_model(cfg.model, n, 100).cuda()
        x, basis = pipeline.flatten_for_training(data.bits[:, :500],
                                                 data.basis_idx)
        t = now()
        model, _ = train.fit(g_train, model, x, basis, dataclasses.replace(
            cfg.train, num_epochs=1), sched, log_fn=lambda m: None)
        steps = x.shape[0] // cfg.train.batch_size
        dt = now() - t
        say(f"n{n}_fit_500shots", dict(s=dt, steps=steps,
                                       ms_per_step=dt * 1e3 / steps))
        t = now()
        _, _, info = train.finetune_chain(model, raw, sched, n, steps=0,
                                          exact=False)
        say(f"n{n}_grid_ce_two_passes", dict(s=now() - t,
                                             ce=info["train_ce_before"]))
        opt = None
        for seg, (steps, accum, hard) in enumerate(
                ((5, 1, 0.0), (5, 4, 0.5), (10, 1, 0.0), (10, 1, 0.0))):
            t = now()
            model, _, info = train.finetune_chain(
                model, raw, sched, n, steps=steps, learning_rate=1e-3,
                exact=False, basis_batch=cfg.train.chain_basis_batch,
                steps_per_call=10, accum=accum, hard_frac=hard,
                init_opt_state=opt,
                generator=torch.Generator(device="cuda").manual_seed(seg))
            opt = info.pop("final_opt_state")
            say(f"n{n}_distill_seg{seg}", dict(
                s=now() - t, steps=steps, accum=accum, hard=hard,
                ce_before=info["train_ce_before"],
                ce_after=info["train_ce_after"]))
        del data, raw, model
        torch.cuda.empty_cache()
    return out


# Phase campaigns: the drivers of ``ddqst_tpu_torch.campaigns`` as a user
# runs them, each a child process on the card (``python -m ...``), in three
# chains side by side: the ladder driver on ``cpu_tiny`` twice, the segments
# driver on ``cpu_tiny`` (on data this process writes, so no datagen role),
# and the ladder's ``--probe`` of RQC-4 (full width and shapes, 1 CE epoch,
# 50 distillation steps). The segments driver's resume and its datagen role
# are held on the CPU (tests/test_torch_campaigns.py): each role here is a
# process of 7-20 s.
CAMPAIGN_CHILD_TIMEOUT_S = 300
CAMPAIGN_PROBE = "rqc4_auto"
CAMPAIGN_ROW_KEYS = {"tag", "num_qubits", "fidelity", "raw_fidelity",
                     "raw_fidelity_mitigated", "trace_distance", "note",
                     "wall_s", "device"}
# One walk of RQC-4's generation: (T, C, N, S), 30,000 shots a basis in two
# calls of 15,000 (2^21 // 81 = 25,890 a call at most).
RQC4_WALK_SHAPE = (100, 81, 4, 15000)


def run_campaign(cmd: list[str], what: str) -> tuple[str, float]:
    """One driver's process to its end: (its standard output, seconds).
    It must exit 0 within ``CAMPAIGN_CHILD_TIMEOUT_S``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           f"ddqst_tpu_torch.campaigns.{cmd[0]}", *cmd[1:]],
                          cwd=repo_file("."), capture_output=True, text=True,
                          timeout=CAMPAIGN_CHILD_TIMEOUT_S)
    dt = time.perf_counter() - t0
    log("campaigns", f"{what}: exit {proc.returncode} in {dt:.1f} s")
    check(proc.returncode == 0, f"{what} exits 0; stderr tail: "
          + "\n".join(proc.stderr.splitlines()[-20:]))
    return proc.stdout, dt


def launch_lines(stdout: str) -> list[dict]:
    """The kernel-launch lines ``campaigns.scaling`` prints after a run."""
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{") and '"walk_launches"' in line]


def check_row(row: dict, tag: str, smi: str, what: str) -> None:
    check(row["tag"] == tag and CAMPAIGN_ROW_KEYS <= set(row)
          and row["device"] == smi and math.isfinite(row["fidelity"])
          and 0.0 <= row["fidelity"] <= 1.0,
          f"{what}: the row of {tag} has the script's keys, the card "
          f"({smi}) and a fidelity in [0, 1]: {row}")


def campaign_ladder(d: str, smi: str) -> dict:
    """``campaigns.scaling --only cpu_tiny`` twice on one record: one row."""
    from ddqst_tpu_torch.campaigns import read_rows

    out = os.path.join(d, "scaling.jsonl")
    cmd = ["scaling", "--only", "cpu_tiny", "--out", out]
    stdout, s1 = run_campaign(cmd, "scaling --only cpu_tiny")
    rows = read_rows(out)
    check(len(rows) == 1, f"one row ({len(rows)})")
    check_row(rows[0], "cpu_tiny", smi, "scaling")
    (launches,) = launch_lines(stdout)
    _, s2 = run_campaign(cmd, "scaling --only cpu_tiny, again")
    check(len(read_rows(out)) == 1, "a second call with the same --out adds "
          "no row")
    log("campaigns", f"cpu_tiny row {json.dumps(rows[0])}; a second call "
        "added no row")
    return dict(row=rows[0], s=[s1, s2],
                walk_launches=launches["walk_launches"])


def campaign_segments(d: str, data: str, smi: str) -> dict:
    """``campaigns.segments --opt_chain`` on ``cpu_tiny``, 2 segments of 2
    steps, on the data file ``data``: the ce, segment 0, segment 1 and eval
    roles; segment 1 starts from segment 0's parameters and loads its Adam
    state (its saved ``count`` is segment 0's plus its own 2 steps), and
    each segment lowers the full-grid chain CE."""
    from ddqst_tpu_torch.campaigns import read_rows
    from ddqst_tpu_torch.campaigns.segments import snapshot

    work, out = os.path.join(d, "segments"), os.path.join(d, "segments.jsonl")
    stdout, s = run_campaign(
        ["segments", "--tag", "cpu_tiny", "--segments", "2",
         "--steps_per_segment", "2", "--workdir", work, "--out", out,
         "--data_cache", data, "--opt_chain"],
        "segments --tag cpu_tiny --opt_chain, 2 x 2 steps")
    roles = [line.split("] ", 1)[1].rsplit(":", 1)[0]
             for line in stdout.splitlines()
             if line.startswith("[segments]") and line.endswith("starting")]
    check(roles == ["ce segment -1", "distill segment 0", "distill segment 1",
                    "eval segment 2"], f"the roles in order: {roles}")
    check(all(os.path.exists(snapshot(work, "cpu_tiny", k))
              for k in (-1, 0, 1)),
          "the ce, segment 0 and segment 1 params exist")
    counts = [int(torch.load(snapshot(work, "cpu_tiny", k, "opt"),
                             weights_only=True)["count"]) for k in (0, 1)]
    opt0 = snapshot(work, "cpu_tiny", 0, "opt")
    check(counts == [2, 4] and f"chained distillation Adam state from {opt0}"
          in stdout, f"segment 1 loaded segment 0's Adam state: counts "
          f"{counts} (want [2, 4])")
    segs = read_rows(os.path.join(work, "cpu_tiny_segments.jsonl"))
    check([g["segment"] for g in segs] == [0, 1]
          and segs[1]["ce_before"] == segs[0]["ce_after"]
          and all(g["ce_after"] < g["ce_before"] for g in segs),
          f"each segment lowers the chain CE, segment 1 from segment 0's "
          f"parameters: {segs}")
    rows = read_rows(out)
    check(len(rows) == 1 and rows[0]["distill_steps_actual"] == 4,
          f"one eval row after 4 distillation steps: {rows}")
    check_row(rows[0], "cpu_tiny_seg2x2", smi, "segments")
    log("campaigns", f"segments: roles {roles}; Adam counts {counts}; chain "
        f"CE {[(g['ce_before'], g['ce_after']) for g in segs]}; "
        f"{json.dumps(rows[0])}")
    return dict(row=rows[0], roles=roles, opt_counts=counts, segments=segs,
                s=s)


def campaign_probe(d: str) -> dict:
    """``campaigns.scaling --probe --only rqc4_auto``: no row, the walk
    launches of a full run, at the shape its config gives."""
    cfg = scaling_rung(CAMPAIGN_PROBE)
    walks, steps = SCALING_PLAN[CAMPAIGN_PROBE]
    # sample_all_bases' calls: at most 2^21 chains each, shots split evenly.
    n, shots = cfg.data.num_qubits, cfg.data.shots_infer
    calls = -(-shots // (2**21 // 3**n))
    check((cfg.diffusion.num_timesteps, 3**n, n, walk_call_shots(n, shots))
          == RQC4_WALK_SHAPE and calls == walks,
          f"{CAMPAIGN_PROBE}'s config gives {walks} walks of (T, C, N, S) = "
          f"{RQC4_WALK_SHAPE}")
    out = os.path.join(d, "probe.jsonl")
    stdout, s = run_campaign(["scaling", "--probe", "--only", CAMPAIGN_PROBE,
                              "--out", out],
                             f"scaling --probe --only {CAMPAIGN_PROBE}")
    check(not os.path.exists(out), "the probe wrote no row")
    (line,) = launch_lines(stdout)
    check((line["walk_launches"], line["step_launches"]) == (walks, steps)
          and line["walk_plan"][3] == "staged",
          f"the probe launched as a full run does, on the staged body: "
          f"{line}")
    log("campaigns", f"probe {CAMPAIGN_PROBE}: walk launches "
        f"{line['walk_launches']} at (T, C, N, S) = {RQC4_WALK_SHAPE}, plan "
        f"{line['walk_plan']}; step launches {line['step_launches']}; no row")
    return dict(line, walk_shape=list(RQC4_WALK_SHAPE), s=s)


def start_campaigns(pool, d: str, smi: str) -> dict:
    """The three chains of driver processes, started on ``pool`` (3
    threads) in the folder ``d`` once the data they share is made in this
    thread; their futures."""
    from ddqst_tpu_torch.pipeline import ensure_data_cache

    data = os.path.join(d, "cpu_tiny_data.npz")
    ensure_data_cache(scaling_rung("cpu_tiny"), 0, data,
                      lambda m: log("campaigns", m),
                      device=torch.device("cuda"))
    return dict(ladder=pool.submit(campaign_ladder, d, smi),
                segments=pool.submit(campaign_segments, d, data, smi),
                probe=pool.submit(campaign_probe, d))


def campaign_rung(ck, tag: str, out_dir: str, smi: str) -> dict:
    """``--campaign TAG OUT_DIR``: ``campaigns.scaling --only TAG
    --data_cache <the committed data> --out OUT_DIR/scaling.jsonl``, uncut,
    in this process (``scaling.main``'s own ``run``), then the rung's
    checks: the launch plan, the samples against the model's exact chain,
    the raw inversion and MLE on the raw counts against the JAX package's
    on the same file, the fidelity beside the reference's row (a verdict,
    not a check), and the row the driver appended."""
    from ddqst_tpu_torch.campaigns import read_rows, scaling

    out = os.path.join(out_dir, "scaling.jsonl")
    check(tag not in scaling.finished_tags(out), f"{out} has no {tag} row "
          "yet (a finished tag would be skipped)")
    argv = ["--only", tag, "--out", out, "--data_cache",
            repo_file(SCALING_DATA[tag])]
    cfg = scaling_rung(tag)
    log("scaling", f"{tag}: uncut through campaigns.scaling {' '.join(argv)}:"
        f" {cfg.train.num_epochs} CE epochs, {cfg.train.chain_finetune_steps}"
        f" distillation steps, {cfg.data.shots_train} / "
        f"{cfg.data.shots_infer} shots a basis")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ((row, res),) = scaling.run(scaling.parse_args(argv))
    torch.cuda.synchronize()
    rec = dict(wall_s=time.perf_counter() - t0,
               walk_launches=ck.fused_chain_walk.launches,
               step_launches=ck.fused_chain_step.launches,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               timings=dict(res["timings"]))
    log("scaling", f"{tag}: wall {rec['wall_s']:.2f} s, peak "
        f"{rec['peak_gb']:.2f} GB allocated, launches: walk "
        f"{rec['walk_launches']}, step {rec['step_launches']}; stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec["timings"].items()))
    out_rec = scaling_part_checks(ck, tag, cfg, res, rec, cut=False)
    (kept,) = [r for r in read_rows(out) if r["tag"] == tag]
    check(kept == row, f"the record holds the driver's row: {kept}")
    check_row(kept, tag, smi, "campaign")
    for k in ("fidelity", "raw_fidelity", "raw_fidelity_mitigated",
              "trace_distance"):
        check(kept[k] == round(res[k], 5), f"the row's {k} is the run's")
    log("scaling", f"{tag}: row {json.dumps(kept)}")
    return dict(out_rec, row=kept,
                rescore=campaign_rescore(tag, res, out_rec, out_dir))


# ``exact_rescore``'s fidelity of the exact chain against the rung's own
# (``scaling_checks``' ``fidelity_exact_chain``): two callers of one MLE
# on one distribution, the rows rounding to 5 decimals.
RESCORE_TOL = 1e-4


def campaign_rescore(tag: str, res: dict, rec: dict, out_dir: str) -> dict:
    """The run's parameters saved to ``OUT_DIR/<tag>_params.pt``, then
    ``campaigns.exact_rescore --also_sampled`` on them (its rows in
    ``OUT_DIR/exact_rescore.jsonl``): the exact row's fidelity equals the
    rung's ``fidelity_exact_chain`` within ``RESCORE_TOL``."""
    from ddqst_tpu_torch.campaigns import exact_rescore
    from ddqst_tpu_torch.utils.checkpoint import save_params

    path = os.path.join(out_dir, f"{tag}_params.pt")
    save_params(path, res["state"])
    t0 = time.perf_counter()
    exact, sampled = exact_rescore.rescore(exact_rescore.parse_args(
        ["--tag", tag, "--params", path, "--also_sampled", "--out",
         os.path.join(out_dir, "exact_rescore.jsonl")]))
    wall = time.perf_counter() - t0
    err = abs(exact["fidelity"] - rec["fidelity_exact_chain"])
    log("scaling", f"{tag}: exact_rescore on {path} ({wall:.1f} s): exact "
        f"{exact['fidelity']}, sampled {sampled['fidelity']}; the rung's "
        f"exact-chain MLE {rec['fidelity_exact_chain']:.6f}, |diff| "
        f"{err:.2e}; the run's fidelity {res['fidelity']:.5f}")
    check(err <= RESCORE_TOL, f"{tag}: exact_rescore equals the rung's "
          f"fidelity_exact_chain within {RESCORE_TOL}")
    return dict(exact=exact, sampled=sampled, abs_diff=err, s=wall,
                params=path)


# ``--shadow-segments``: ``campaigns.shadow_segments`` from the reference's
# CE snapshot on its data cache at its 300 bases; the eval row beside the
# reference's rows (examples/results_shadow.jsonl 9 and 11).
SHADOW_SEG_TAG = "dist_seg"
SHADOW_SEG_ROW_KEYS = {
    "tag", "epochs", "model", "distill_steps", "distill_steps_actual",
    "max_bases", "seed", "mean_tv_to_target", "tv_shot_noise_floor",
    "meas_tv_to_target", "mean_marginal_error", "classical_fidelity",
    "note", "wall_s", "device"}
SHADOW_SEG_REFERENCE = {"dist300": 0.17363, "snapshot": 0.1983}
SHADOW_SEG_PROBE_STEPS = 5


def shadow_segments_argv(work: str, k: int, s: int, start: int) -> list[str]:
    return ["--tag", SHADOW_SEG_TAG, "--segments", str(k),
            "--steps_per_segment", str(s), "--start_segment", str(start),
            "--data_cache", repo_file(REFERENCE_SHADOW_DATA),
            "--max_bases", "300", "--workdir", work,
            "--out", os.path.join(work, "shadow.jsonl")]


def shadow_workdir(work: str) -> None:
    """``work`` with the reference's CE snapshot in it as the CE role's."""
    from ddqst_tpu_torch.campaigns.segments import snapshot

    os.makedirs(work, exist_ok=True)
    ce = snapshot(work, SHADOW_SEG_TAG, -1)
    if not os.path.exists(ce):
        shutil.copyfile(repo_file(REFERENCE_SHADOW_PARAMS), ce)


def shadow_segments_probe(out_dir: str) -> dict:
    """``SHADOW_SEG_PROBE_STEPS`` distillation steps of segment 0 in this
    process (the driver's distill role, ``shadow_segments.child``), each
    optimiser step's end stamped after a device synchronisation: ms a step
    at the campaign's shape (the median interval)."""
    from ddqst_tpu_torch.campaigns import shadow_segments

    work = os.path.join(out_dir, "probe")
    shadow_workdir(work)
    stamps = []
    step = torch.optim.Adam.step

    def stamped(self, *a, **kw):
        out = step(self, *a, **kw)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return out

    argv = shadow_segments_argv(work, 1, SHADOW_SEG_PROBE_STEPS, 0)
    torch.optim.Adam.step = stamped
    t0 = time.perf_counter()
    try:
        shadow_segments.child(shadow_segments.parse_args(
            argv + ["--child_role", "distill", "--child_segment", "0"]))
    finally:
        torch.optim.Adam.step = step
    wall = time.perf_counter() - t0
    gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    step_s = gaps[len(gaps) // 2]
    (seg,) = shadow_steps_log(work)
    log("shadow_segments", f"probe: {len(stamps)} steps, median {step_s:.3f} "
        f"s a step (gaps {[round(g, 3) for g in gaps]}); the role "
        f"{wall:.1f} s in this process; chain CE {seg['ce_before']:.5f} -> "
        f"{seg['ce_after']:.5f}, held-out step {seg['best_step']} kept")
    check(len(stamps) == SHADOW_SEG_PROBE_STEPS
          and math.isfinite(seg["ce_after"]), f"shadow segments probe: "
          f"{SHADOW_SEG_PROBE_STEPS} steps, a finite chain CE: {seg}")
    return dict(step_s=step_s, gaps_s=gaps, role_s=wall, segment=seg)


def shadow_steps_log(work: str) -> list[dict]:
    from ddqst_tpu_torch.campaigns import read_rows

    return read_rows(os.path.join(work, f"{SHADOW_SEG_TAG}_segments.jsonl"))


def shadow_segments_run(ck, out_dir: str, k: int, s: int, start: int,
                        smi: str) -> dict:
    """The driver as a user runs it (``python -m
    ddqst_tpu_torch.campaigns.shadow_segments``, every role a child) in
    ``OUT_DIR``, from segment ``start``; then the checks: each segment's
    chain CE falls, and after the eval role its row has the script's keys
    and the card, and an eval of the last snapshot in this process
    (``reference_shadow_run``: one ring walk, every basis' samples within 4
    shot-noise scales of the exact chain of the tables it read) gives the
    row's metrics again, the training and sampling repeating bit for bit."""
    from ddqst_tpu_torch.campaigns import read_rows
    from ddqst_tpu_torch.campaigns.segments import snapshot

    shadow_workdir(out_dir)
    argv = shadow_segments_argv(out_dir, k, s, start)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "ddqst_tpu_torch.campaigns.shadow_segments",
                           *argv], cwd=repo_file("."))
    wall = time.perf_counter() - t0
    log("shadow_segments", f"driver {' '.join(argv)}: exit "
        f"{proc.returncode} in {wall:.1f} s")
    check(proc.returncode == 0, "the shadow segments driver exits 0")
    segs = shadow_steps_log(out_dir)
    log("shadow_segments", f"steps log: {json.dumps(segs)}")
    out = dict(segments=segs, driver_s=wall)
    rows = read_rows(os.path.join(out_dir, "shadow.jsonl"))
    if rows:
        row = rows[-1]
        run = reference_shadow_run(ck, "shadow_segments", params_load=snapshot(
            out_dir, SHADOW_SEG_TAG, k - 1))
        again = {m: round(run["res"][m], 5) for m in SHADOW_METRICS + (
            "tv_shot_noise_floor", "meas_tv_to_target")}
        tv = row["mean_tv_to_target"]
        ref = SHADOW_SEG_REFERENCE["dist300"]
        gap = tv - ref
        verdict = ("below the reference" if gap < 0 else "agreement"
                   if gap <= REFERENCE_FIDELITY_MARGIN else "miss")
        log("shadow_segments", f"{row['tag']}: TV {tv} against the "
            f"reference's {ref} after 300 steps ({gap:+.5f}: {verdict}) and "
            f"{SHADOW_SEG_REFERENCE['snapshot']} before distillation; "
            f"marginal error {row['mean_marginal_error']}, classical "
            f"fidelity {row['classical_fidelity']}; "
            f"{row['distill_steps_actual']} steps run; an eval in this "
            f"process: {again}")
        out.update(row=row, verdict=verdict, reference=SHADOW_SEG_REFERENCE,
                   eval_again=again, eval_walk_plan=list(run["plan"]),
                   eval_walks=run["walks"])
    for seg in segs:
        check(seg["ce_after"] < seg["ce_before"], f"segment "
              f"{seg['segment']}: chain CE {seg['ce_before']} -> "
              f"{seg['ce_after']} falls")
    if rows:
        check(set(row) == SHADOW_SEG_ROW_KEYS and row["device"] == smi
              and row["tag"] == f"{SHADOW_SEG_TAG}_seg{k}x{s}",
              f"the eval row has the script's keys and the card: {row}")
        check(all(row[m] == v for m, v in again.items()),
              f"an eval of the last snapshot in this process gives the "
              f"row's metrics: {again}")
    return out


# ``--parity [TAGS]``: ``campaigns.parity_suite`` on the card, each row
# held to the JAX package's (examples/results_parity.jsonl): the samples
# against the model's exact chain, the raw inversion's fidelity within
# ``PARITY_RAW_SDS``·√2 shot-noise standard deviations of the JAX row's
# (the same state and noise from the seed, independent shots; the standard
# deviation over ``PARITY_RAW_DRAWS`` multinomial draws from the exact
# noisy distribution, through the pipeline's own inversion).
PARITY_TAGS = ("phase1_plus", "phase1_simple_mlp", "phase1_upgraded_mlp",
               "phase2_bell", "phase2_ghz3") + tuple(
    f"phase3_rqc2_{k}" for k in ("ideal", "readout", "depolarizing",
                                 "thermal", "torino"))
PARITY_ROW_KEYS = {"tag", "fidelity", "raw_fidelity",
                   "raw_fidelity_mitigated", "trace_distance", "reference",
                   "note", "wall_s", "device"}
PARITY_RAW_SDS = 4.0
PARITY_RAW_DRAWS = 64
PARITY_JAX_ROWS = "examples/results_parity.jsonl"


def raw_fidelity_sd(cfg, seed: int, draws: int, dev) -> float:
    """The shot-noise standard deviation of ``raw_fidelity`` (unmitigated
    linear inversion of ``shots_train`` shots a basis) under ``cfg`` at
    ``seed``: over ``draws`` multinomial draws (numpy, seeded) from the
    exact noisy Born distribution."""
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.pipeline import noisy_basis_probs
    from ddqst_tpu_torch.qsim import measure, noise, states

    n = cfg.data.num_qubits
    circuit = states.prep_circuit(cfg.data.state_type, n, cfg.data.rqc_depth,
                                  np.random.default_rng(seed))
    labels = pauli.all_basis_labels(n)
    probs = noisy_basis_probs(
        circuit, noise.get_noise_config(cfg.data.noise_type),
        torch.from_numpy(measure.rotation_unitaries(labels)).to(dev))
    probs = probs.double().cpu().numpy()
    target = torch.from_numpy(states.circuit_statevector(circuit)).to(dev)
    inv = pauli.make_counts_inverter(n, labels)
    rng = np.random.default_rng(seed + 1)
    fids = [float(M.state_fidelity(target, inv(torch.from_numpy(np.stack(
        [rng.multinomial(cfg.data.shots_train, p / p.sum()) for p in probs]
    )).float().to(dev)))) for _ in range(draws)]
    return float(np.std(fids, ddof=1))


def parity_run(ck, tags: list[str], out_dir: str, smi: str) -> dict:
    """Each tag uncut through ``parity_suite.run`` in this process (its row
    in ``OUT_DIR/parity.jsonl``), then its checks; the fidelity beside the
    JAX row's and the published value (recorded, not held)."""
    from ddqst_tpu_torch.campaigns import parity_suite, read_rows
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops.schedules import make_schedule

    jax_rows = {r["tag"]: r for r in read_rows(repo_file(PARITY_JAX_ROWS))}
    cfgs = {t: (c, ref) for t, c, ref, _ in parity_suite.experiments()}
    out_path = os.path.join(out_dir, "parity.jsonl")
    out = {}
    for tag in tags:
        cfg, ref = cfgs[tag]
        n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        ((row, res),) = parity_suite.run(out_path, only=tag)
        check(res is not None, f"{tag}: no row in {out_path} yet")
        walks, steps = ck.fused_chain_walk.launches, ck.fused_chain_step.launches
        check(set(row) == PARITY_ROW_KEYS and row["device"] == smi,
              f"{tag}: the row has the script's keys and the card: {row}")
        for k in ("fidelity", "raw_fidelity", "trace_distance"):
            check(math.isfinite(res[k]), f"{tag}: {k} finite")
        sched = make_schedule(cfg.diffusion.schedule, t_steps, "cuda")
        tables = diff.grid_p1_tables(res["state"], n, sched,
                                     cfg.diffusion.exact
                                     ).reshape(t_steps, 3**n, 2**n, n)
        samples_vs_tables("parity", tag, res["samples"], tables,
                          torch.full((3**n, 2**n), 2.0**-n, device="cuda"))
        want = jax_rows[tag]
        sd = raw_fidelity_sd(cfg, 0, PARITY_RAW_DRAWS, "cuda")
        bound = PARITY_RAW_SDS * math.sqrt(2) * sd
        err = abs(res["raw_fidelity"] - want["raw_fidelity"])
        log("parity", f"{tag}: raw {res['raw_fidelity']:.5f} vs the JAX "
            f"row's {want['raw_fidelity']} (|diff| {err:.5f}, shot-noise sd "
            f"{sd:.5f}, bound {bound:.5f}); fidelity {res['fidelity']:.5f} "
            f"vs the JAX row's {want['fidelity']} and the published {ref}; "
            f"{res['train_steps']} CE steps, wall {row['wall_s']} s; "
            f"launches: walk {walks}, step {steps}")
        check(err <= bound, f"{tag}: raw_fidelity within {bound:.5f} of the "
              f"JAX row's")
        out[tag] = dict(row=row, jax_row=want, raw_sd=sd, raw_bound=bound,
                        train_steps=res["train_steps"], walk_launches=walks,
                        step_launches=steps, timings=res["timings"],
                        walk_shape=[t_steps, 3**n, n, walk_call_shots(
                            n, cfg.data.shots_infer)])
    out["kernel"] = {
        "x".join(map(str, shape)): walk_row(ck, *shape)
        for shape in sorted({tuple(r["walk_shape"]) for r in out.values()})}
    return out


def walk_call_shots(n: int, shots: int) -> int:
    """Chains a row of one ``sample_all_bases`` walk call: at most 2^21
    chains a call, the shots split evenly over the calls."""
    calls = -(-shots // (2**21 // 3**n))
    return -(-shots // calls)


def walk_row(ck, t_steps: int, c: int, n: int, s: int) -> dict:
    """The walk at one shape on seeded random tables: bit for bit against
    its plain version; ms (CUDA events) of the kernel and the plain
    version, and the bound, as phase ``kernel`` reckons them."""
    tables, init = random_walk_inputs(t_steps, c, n, s, seed=c + n)
    out = ck.fused_chain_walk(5, tables, init, n)
    plan = ck.fused_chain_walk.last_plan
    plain = ck.fused_chain_walk_reference(5, tables, init, n)
    check(torch.equal(out, plain), f"kernel == plain bit for bit at "
          f"T={t_steps} C={c} N={n} S={s}")
    ms = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, n), 20)
    plain_ms = cuda_ms(lambda: ck.fused_chain_walk_reference(
        5, tables, init, n), 2)
    bound, by = walk_bound_ms(t_steps, c, n, s)
    log("kernel", f"T={t_steps} C={c} N={n} S={s}: kernel {ms:.4f} ms (plan "
        f"{plan}), plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}), "
        f"{ms / bound:.2f} x bound; == plain bit for bit")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                plan=list(plan), max_abs_err=0.0)


# ``--rqc3-ceiling``: ``campaigns.rqc3_ceiling --ceiling`` on the card,
# against the JAX package's record of the same protocol.
RQC3_CEILING_ROWS = "examples/rqc3_ceiling.jsonl"
RQC3_EXACT_TOL = 1e-4  # the MLE's tolerance: the same distribution, no draw
RQC3_SAMPLED_SDS = 4.0
RQC3_RUN_TAG = "rqc3_20k_counts"
RQC3_RUN_ROWS = "examples/results_rqc3_99.jsonl"


def rqc3_ceiling_run(out_dir: str, smi: str, run: bool) -> dict:
    """The ceiling rows, each against the JAX package's: the exact rows
    within ``RQC3_EXACT_TOL``; a sampled row equal within the tolerance
    (the same numpy draws) or, where the draws differ, within
    ``RQC3_SAMPLED_SDS``·√2 shot-noise standard deviations (over 16 draws
    of noise-aware MLE). ``run``: also ``--run --only RQC3_RUN_TAG``
    uncut, beside its JAX row."""
    from ddqst_tpu_torch.campaigns import rqc3_ceiling, read_rows
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle

    from ddqst_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    want = read_rows(repo_file(RQC3_CEILING_ROWS))
    t0 = time.perf_counter()
    got = rqc3_ceiling.run_ceiling(os.path.join(out_dir, "rqc3_ceiling.jsonl"),
                                   dev)
    wall = time.perf_counter() - t0
    check(len(got) == len(want), f"{len(want)} ceiling rows")
    diffs = []
    for g, w in zip(got, want):
        check(g["device"] == smi and {k: g[k] for k in ("mode", "seed")}
              == {k: w[k] for k in ("mode", "seed")}
              and g.get("shots") == w.get("shots"), f"row {g} is {w}'s")
        keys = [k for k in w if k not in ("mode", "seed", "shots")]
        err = max(abs(g[k] - w[k]) for k in keys)
        bound = RQC3_EXACT_TOL
        if g["mode"] == "sampled" and err > RQC3_EXACT_TOL:
            target, probs, ncfg = rqc3_ceiling.noisy_setup(g["seed"], dev)
            target = torch.from_numpy(target).to(dev)
            rec = mle.make_mle(3, readout_p=ncfg.readout_p)
            rng = np.random.default_rng(2000 + g["seed"])
            fids = [float(M.state_fidelity(target, rec(torch.from_numpy(
                np.stack([rng.multinomial(g["shots"], p / p.sum())
                          for p in probs])).float().to(dev))))
                for _ in range(16)]
            bound = RQC3_SAMPLED_SDS * math.sqrt(2) * float(
                np.std(fids, ddof=1))
        log("rqc3_ceiling", f"{json.dumps(g)} vs the JAX package's "
            f"{json.dumps(w)}: max |diff| {err:.2e} (bound {bound:.2e})")
        check(err <= bound, f"ceiling row {g} within {bound:.2e} of {w}")
        diffs.append(err)
    out = dict(rows=got, max_abs_diff=max(diffs), s=wall)
    if run:
        jax = {r["tag"]: r for r in read_rows(repo_file(RQC3_RUN_ROWS))}
        ((row, res),) = rqc3_ceiling.run_campaign(
            os.path.join(out_dir, "rqc3_99.jsonl"), RQC3_RUN_TAG, 0, dev)
        check(row["device"] == smi and math.isfinite(res["fidelity"]),
              f"{RQC3_RUN_TAG}: a finite row on the card: {row}")
        log("rqc3_ceiling", f"{RQC3_RUN_TAG}: fidelity {row['fidelity']} vs "
            f"the JAX row's {jax[RQC3_RUN_TAG]['fidelity']}; raw "
            f"{row['raw_fidelity']} vs {jax[RQC3_RUN_TAG]['raw_fidelity']}; "
            f"MLE on raw {row['raw_fidelity_mitigated']} vs "
            f"{jax[RQC3_RUN_TAG]['raw_fidelity_mitigated']}; "
            f"{row['wall_s']} s")
        out["run"] = dict(row=row, jax_row=jax[RQC3_RUN_TAG],
                          timings=res["timings"])
    return out


# ``profiles`` and ``--profiles``: ``campaigns.shadow_sector_profile`` on
# the reference's CE snapshot and data cache at full width, against the JAX
# package's record of that snapshot (``scripts/shadow_sector_profile.py
# --bases 48 --seed 7``). The chain is exact and the basis draw is numpy's,
# so the record holds row for row: the same 48 bases, and each ``kl_clean``
# and ``kl_counts`` within PROFILE_ABS + PROFILE_REL · |the record's|.
PROFILE_RECORD = "examples/shadow_sector_profile.jsonl"
PROFILE_ABS, PROFILE_REL = 1e-4, 1e-3
PROFILE_KEYS = ("kl_clean", "kl_counts")


def profile_gaps(rows: list[dict], record: list[dict]) -> dict:
    """Each key's largest |port - record| and largest share of its bound
    over ``rows`` (the record's first ``len(rows)`` rows), checked."""
    gaps = {}
    for k in PROFILE_KEYS:
        diff = [abs(r[k] - w[k]) for r, w in zip(rows, record)]
        share = [d / (PROFILE_ABS + PROFILE_REL * abs(w[k]))
                 for d, w in zip(diff, record)]
        j = int(np.argmax(share))
        gaps[k] = dict(max_abs_gap=max(diff), max_share_of_bound=share[j],
                       worst_basis=rows[j]["basis"], port=rows[j][k],
                       jax=record[j][k])
        log("profiles", f"{k}: largest gap {max(diff):.3e} over "
            f"{len(rows)} bases; worst against its bound at basis "
            f"{rows[j]['basis']}: port {rows[j][k]} vs the record's "
            f"{record[j][k]} ({share[j]:.3f} of {PROFILE_ABS:g} + "
            f"{PROFILE_REL:g}·|record|)")
    for r, w in zip(rows, record):
        check(r["basis"] == w["basis"] and r["n_z"] == w["n_z"],
              f"basis {r['basis']} is the record's {w['basis']}")
        for k in PROFILE_KEYS:
            check(abs(r[k] - w[k]) <= PROFILE_ABS + PROFILE_REL * abs(w[k]),
                  f"basis {r['basis']}: {k} {r[k]} within {PROFILE_ABS:g} + "
                  f"{PROFILE_REL:g}·|{w[k]}| of the record's")
    return gaps


def shadow_profile(ck, out_dir: str, smi: str) -> dict:
    """``campaigns.shadow_sector_profile`` through its ``run`` on the
    reference's CE snapshot and cache (``--bases 48 --seed 7``, the
    defaults; rows to ``OUT_DIR/shadow_sector_profile.jsonl``) with the
    launch counts set to 0 just before and read just after (none may
    launch): the selection equal to the record's 48 bases, every row held
    to the record."""
    from ddqst_tpu_torch.campaigns import read_rows
    from ddqst_tpu_torch.campaigns import shadow_sector_profile as ssp

    record = read_rows(repo_file(PROFILE_RECORD))
    args = ssp.parse_args([
        os.path.relpath(repo_file(REFERENCE_SHADOW_PARAMS)), "--data",
        os.path.relpath(repo_file(REFERENCE_SHADOW_DATA)), "--out",
        os.path.join(out_dir, "shadow_sector_profile.jsonl")])
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    rows = ssp.run(args, log_fn=lambda m: log("profiles", m))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(walk=ck.fused_chain_walk.launches,
                    step=ck.fused_chain_step.launches)
    log("profiles", f"N=10 transformer 128 / 512 / 4 / 4, T=100: {len(rows)}"
        f" bases' exact chains in {wall:.1f} s; launches: walk "
        f"{launches['walk']}, step {launches['step']}")
    check(launches == dict(walk=0, step=0), "the profile launches no kernel")
    check([r["basis"] for r in rows] == [r["basis"] for r in record],
          f"the selection (--bases {args.bases} --seed {args.seed}) is the "
          f"record's {len(record)} bases")
    check(all(r["device"] == smi for r in rows),
          "the rows carry the card's nvidia-smi line")
    gaps = profile_gaps(rows, record)
    return dict(bases=len(rows), s=wall, gaps=gaps, launches=launches)


def phase_profiles(ck, smi: str) -> dict:
    with tempfile.TemporaryDirectory() as d:
        return shadow_profile(ck, d, smi)


# ``--profiles`` part (b): GHZ-8 at full shape, ``ghz8_mle_hot``'s data and
# MLE target rebuilt by ``campaigns.mle_target``. ``frontier_work/`` (the
# record's snapshots) is absent, so the sector profile and the subset CE
# run on a seeded initialisation of the rung's model: shapes and times are
# held, not the record's numbers. Two routes to one full-grid chain CE
# (``eval_chain_ce_subset`` over all 3^8 bases, ``finetune_chain(steps=0)``)
# must agree within PROFILE_CE_REL.
PROFILE_GHZ8 = "ghz8_mle_hot"
PROFILE_GHZ8_MLE_ON_RAW = 0.99984  # RESULTS.md:307, the JAX package's row
PROFILE_CE_REL = 1e-5


def mle_on_raw(cfg, data_cache: str) -> dict:
    """``run_experiment``'s ``raw_fidelity_mitigated`` of a data cache: MLE
    on all its training counts at the config's readout_p, its fidelity
    against the cache's clean state."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.ops import metrics, mle
    from ddqst_tpu_torch.qsim import noise

    p = (noise.get_noise_config(cfg.data.noise_type).readout_p
         if cfg.data.mitigate_readout else 0.0)
    t0 = time.perf_counter()
    data = pipeline.load_data_cache(data_cache, torch.device("cuda"))
    solve: dict = {}
    rho = mle.make_mle(cfg.data.num_qubits, data.basis_labels, readout_p=p)(
        mle.bits_to_counts(data.bits), solve)
    fid = float(metrics.state_fidelity(
        torch.from_numpy(data.target).to(rho.device), rho))
    return dict(fidelity=fid, iterations=solve["iterations"], readout_p=p,
                s=time.perf_counter() - t0)


def ghz8_profiles(ck, out_dir: str, smi: str,
                  tag: str = PROFILE_GHZ8) -> dict:
    """Part (b) of ``--profiles`` on ``tag``'s data, its rows under
    ``out_dir`` (and the target's record, its MLE iterations and own
    fidelity, as ``OUT_DIR/<tag>_mle_target.json``); the launch counts set
    to 0 before and read after (none may launch)."""
    from ddqst_tpu_torch.campaigns import (eval_chain_ce_subset,
                                           ghz8_eval_floor,
                                           ghz8_sector_profile, mle_target)
    from ddqst_tpu_torch.campaigns.scaling import experiment
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.models.d3pm import init_params_
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.train import finetune_chain
    from ddqst_tpu_torch.utils.checkpoint import save_params

    cfg, _ = experiment(tag)
    n = cfg.data.num_qubits
    out = {}
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        tgt = mle_target.run(mle_target.parse_args(
            ["--tag", tag, "--workdir", work]))
        out["mle_target"] = dict(tgt, s=time.perf_counter() - t0)
        del out["mle_target"]["path"]
        log("profiles", f"{tag}: data and target in "
            f"{out['mle_target']['s']:.1f} s; the target's own fidelity "
            f"{tgt['fidelity']:.5f} ({tgt['iterations']} MLE iterations)")
        raw = mle_on_raw(cfg, mle_target.data_path(work, tag))
        out["mle_target"]["mle_on_raw"] = raw
        log("profiles", f"{tag}: MLE on raw (readout_p {raw['readout_p']}, "
            f"run_experiment's raw_fidelity_mitigated) {raw['fidelity']:.5f} "
            f"({raw['iterations']} iterations, {raw['s']:.1f} s), beside the "
            f"target's {tgt['fidelity']:.5f} (readout_p 0); the JAX "
            f"package's row: MLE on raw {PROFILE_GHZ8_MLE_ON_RAW}")
        with open(os.path.join(out_dir, f"{tag}_mle_target.json"), "w") as f:
            json.dump(dict(tag=tag, **out["mle_target"], device=smi), f)
        floor = ghz8_eval_floor.run(ghz8_eval_floor.parse_args(
            ["--workdir", work, "--out",
             os.path.join(out_dir, "ghz8_eval_floor.jsonl")]))
        for row in floor:
            check(row["device"] == smi and 0 < row["fidelity"] <= 1,
                  f"eval floor row {row}")
        log("profiles", f"{tag}: eval floor sampled "
            f"{floor[0]['fidelity']} ({floor[0]['wall_s']} s), exact "
            f"{floor[1]['fidelity']} ({floor[1]['wall_s']} s), beside the "
            f"target's own {tgt['fidelity']:.5f} (the script expects both "
            "near 0.99984)")
        out["eval_floor"] = floor

        snap = os.path.join(work, f"{tag}_init_params.pt")
        model = build_model(cfg.model, n, cfg.diffusion.num_timesteps).cuda()
        init_params_(model, torch.Generator(device="cuda").manual_seed(0))
        save_params(snap, model)
        log("profiles", f"{tag}: the sector profile and the subset "
            "CE run on the rung's model at its seeded initialisation, not "
            "the record's snapshot (frontier_work/ is absent): only shapes "
            "and times are held")
        sectors = ghz8_sector_profile.run(ghz8_sector_profile.parse_args(
            [snap, "--tag", tag, "--workdir", work, "--out",
             os.path.join(out_dir, "ghz8_sector_excess.jsonl")]))
        check([(r["sector"], r["bases"]) for r in sectors] == [
            ("random", 48), ("low_ent", 48), ("xy", min(48, 2**n))]
            and all(math.isfinite(r["excess_mean"]) for r in sectors),
            "three sectors of 48 bases, finite")
        out["sectors"] = sectors

        tpath = mle_target.target_path(work, tag)
        t0 = time.perf_counter()
        (sub,) = eval_chain_ce_subset.run(eval_chain_ce_subset.parse_args(
            [snap, "--tag", tag, "--target", tpath, "--bases",
             str(3**n), "--chunk", "243"]),
            log_fn=lambda m: log("profiles", m))
        subset_s = time.perf_counter() - t0
        with np.load(tpath) as z:
            target = z["target"]
        t0 = time.perf_counter()
        _, _, info = finetune_chain(
            model, target, make_schedule(cfg.diffusion.schedule,
                                         cfg.diffusion.num_timesteps, "cuda"),
            n, steps=0, exact=cfg.diffusion.exact, device="cuda")
        torch.cuda.synchronize()
        ft_s = time.perf_counter() - t0
        rel = abs(sub["ce"] - info["train_ce_after"]) / abs(
            info["train_ce_after"])
        log("profiles", f"{tag}: full-grid chain CE over "
            f"{len(sub['bases'])} bases: eval_chain_ce_subset {sub['ce']:.6f}"
            f" in {subset_s:.1f} s (one pass); finetune_chain(steps=0) "
            f"{info['train_ce_after']:.6f} (before "
            f"{info['train_ce_before']:.6f}) in {ft_s:.1f} s (two passes); "
            f"relative gap {rel:.2e}")
        check(rel <= PROFILE_CE_REL, f"the two routes agree within "
              f"{PROFILE_CE_REL:g} relative")
        out["full_grid_ce"] = dict(subset=sub["ce"], subset_s=subset_s,
                                   finetune=info["train_ce_after"],
                                   finetune_s=ft_s, rel_gap=rel)
    out["launches"] = dict(walk=ck.fused_chain_walk.launches,
                           step=ck.fused_chain_step.launches)
    log("profiles", f"{tag}: launches: walk "
        f"{out['launches']['walk']}, step {out['launches']['step']}")
    check(out["launches"] == dict(walk=0, step=0),
          "part (b) launches no kernel")
    return out


# ``--diag``: the three GHZ-5 diagnostics, each ``python -m
# ddqst_tpu_torch.campaigns.<name>`` in a child process, side by side, at
# ``--steps STEPS --warm WARM``, beside the JAX package's records
# (``examples/<name>.json``: other random streams, so a verdict, not a
# check). ``probe`` times one arm's unit instead: CE training and
# DIAG_PROBE_STEPS accum-4 steps, and from them each diagnostic's time at
# its script's depth (``diag_minibatches``), which no call holds.
DIAG_MODULES = ("diag_segment_descent", "diag_floor_escape",
                "diag_hard_mining")
DIAG_TIMEOUT_S = 3200
DIAG_PROBE_STEPS = 20


def diag_probe(ck) -> dict:
    """One probe arm in this process: the diagnostics' data and CE
    training, then DIAG_PROBE_STEPS steps at accum 4, timed."""
    from ddqst_tpu_torch.campaigns import diag
    from ddqst_tpu_torch.campaigns.recipes import diag_cfg
    from ddqst_tpu_torch.ops.mle import bits_to_counts

    dev = torch.device("cuda")
    cfg = diag_cfg("diag5esc")
    ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
    t0 = time.perf_counter()
    data, g_train = diag.make_data(cfg, dev)
    model, sched = diag.train_ce(cfg, data.bits, data.basis_idx, g_train,
                                 dev, lambda m: log("diag", m))
    ce_s = time.perf_counter() - t0
    target = bits_to_counts(data.bits)
    t0 = time.perf_counter()
    _, losses, info = diag.distill(model, target, sched, cfg, dev,
                                   steps=DIAG_PROBE_STEPS, salt=0, accum=4)
    torch.cuda.synchronize()
    arm_s = time.perf_counter() - t0
    # Two full-grid CE passes a call: time one alone to split the arm.
    t0 = time.perf_counter()
    _, _, _ = diag.distill(model, target, sched, cfg, dev, steps=0, salt=0)
    torch.cuda.synchronize()
    evals_s = time.perf_counter() - t0
    step_s = (arm_s - evals_s) / DIAG_PROBE_STEPS
    out = dict(data_and_ce_s=ce_s, arm_s=arm_s, two_grid_passes_s=evals_s,
               step_at_accum4_s=step_s, ce_before=info["train_ce_before"],
               ce_after=info["train_ce_after"],
               launches=dict(walk=ck.fused_chain_walk.launches,
                             step=ck.fused_chain_step.launches))
    out["estimate_s"] = {k: ce_s + v * step_s / 4
                         for k, v in diag_minibatches().items()}
    log("diag", f"probe: data and CE {ce_s:.1f} s; {DIAG_PROBE_STEPS} "
        f"accum-4 steps {arm_s:.1f} s ({step_s:.3f} s a step, two grid "
        f"passes {evals_s:.1f} s); chain CE {info['train_ce_before']:.5f} "
        f"-> {info['train_ce_after']:.5f}; estimates (s, each alone): "
        + ", ".join(f"{k} {v:.0f}" for k, v in out["estimate_s"].items()))
    check(out["launches"] == dict(walk=0, step=0), "the probe launches no "
          "kernel")
    check(np.isfinite(losses.cpu().numpy()).all(), "finite losses")
    return out


def diag_minibatches() -> dict:
    """Minibatches of ``diag.BASIS_BATCH`` bases each diagnostic runs at
    its script's depth (the modules' ``S``, ``WARM``, ``AVG_CHUNKS``); an
    accum-k step runs k."""
    from ddqst_tpu_torch.campaigns import (diag, diag_floor_escape,
                                           diag_hard_mining,
                                           diag_segment_descent)

    sd, fe, hm = diag_segment_descent, diag_floor_escape, diag_hard_mining
    grid = 3**5 // diag.BASIS_BATCH  # the ``full`` arm's clamped accum
    return {
        # single (2 S), params, optchain, lrdecay (S + S each) at accum 1;
        # accum4 (S + S) at 4.
        "diag_segment_descent": 4 * 2 * sd.S + 4 * 2 * sd.S,
        # warm-up, cont / lr3 / lr10, avg (AVG_CHUNKS of S / AVG_CHUNKS)
        # at 4; full: S / 15 steps over the whole grid.
        "diag_floor_escape": 4 * (fe.WARM + 3 * fe.S + fe.AVG_CHUNKS
                                  * (fe.S // fe.AVG_CHUNKS))
        + grid * (fe.S // 15),
        "diag_hard_mining": hm.ACCUM * (hm.WARM + len(hm.ARMS) * hm.S)}


def diag_run(out_dir: str, smi: str, depth: list[str]) -> dict:
    """The three diagnostics side by side, each a child process writing
    ``OUT_DIR/<name>.json`` (its log ``OUT_DIR/<name>.log``), at ``depth``
    ``[STEPS, WARM]`` (printed as a cut); each record beside the JAX
    package's."""
    from ddqst_tpu_torch.campaigns import diag_floor_escape as fe

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(os.path.abspath(__file__)),
                    env.get("PYTHONPATH", "")) if p)
    os.makedirs(out_dir, exist_ok=True)
    log("diag", f"CUT: {depth[0]} steps an arm or segment (the scripts': "
        f"{fe.S}), {depth[1]} warm-up steps ({fe.WARM})")
    procs = {}
    t0 = time.perf_counter()
    for name in DIAG_MODULES:
        flags = ["--steps", depth[0]] + (
            ["--warm", depth[1]] if name != "diag_segment_descent" else [])
        with open(os.path.join(out_dir, f"{name}.log"), "w") as logf:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"ddqst_tpu_torch.campaigns.{name}",
                 "--out", os.path.join(out_dir, f"{name}.json")] + flags,
                stdout=logf, stderr=subprocess.STDOUT, env=env)
    out = {}
    for name, proc in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, DIAG_TIMEOUT_S
                                       - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed"
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"{name}.log")) as f:
            tail = f.read().splitlines()[-40:]
        for line in tail:
            log("diag", f"{name}: {line}")
        check(rc == 0, f"{name} exited 0 ({rc}) after {wall:.0f} s")
        with open(os.path.join(out_dir, f"{name}.json")) as f:
            got = json.load(f)
        with open(repo_file(f"examples/{name}.json")) as f:
            want = json.load(f)
        check(set(got) == set(want) | {"device"} and got["device"] == smi,
              f"{name}: the JAX record's keys and the card's line")
        log("diag", f"{name} ({wall:.0f} s): port {json.dumps(got)}")
        log("diag", f"{name}: JAX {json.dumps(want)}")
        out[name] = dict(port=got, jax=want, s=wall)
    return out


# ``--repeat-check``: does training repeat bit for bit from one seed in two
# processes? At two widths: ``campaigns.shadow_scale`` at the shadow width
# (1 epoch, 100 bases), and ``campaigns.scaling --probe`` of RQC-4 at the
# ``rqc`` width on its committed data (1 CE epoch and 50 distillation steps
# at full shapes, so the backward through ``chain_distribution`` too).
REPEAT_ARGS = {
    "shadow": ["--tag", "repeat", "--epochs", "1", "--max_bases", "100"],
    "rqc": ["--only", "rqc4_auto", "--probe", "--data_cache",
            "examples/reference_data/rqc4_auto_seed0.npz"],
}


def repeat_child(width: str, path: str) -> None:
    """``--repeat-child WIDTH PATH``: one run of ``REPEAT_ARGS[WIDTH]``; its
    row (less ``wall_s``), losses (CE epochs, then distillation steps, as
    hex floats) and a sha256 of each parameter and of all of them, in
    PATH. The probe writes no row, so the RQC-4 run's row is the one its
    results would give."""
    import hashlib

    from ddqst_tpu_torch.campaigns import scaling, shadow_scale

    if width == "shadow":
        rec, res = shadow_scale.run(shadow_scale.parse_args(
            REPEAT_ARGS[width] + ["--out", path + ".jsonl"]))
    else:
        argv = REPEAT_ARGS[width] + ["--out", path + ".jsonl"]
        argv[argv.index("--data_cache") + 1] = repo_file(
            argv[argv.index("--data_cache") + 1])
        ((_, res),) = scaling.run(scaling.parse_args(argv))
        tag = REPEAT_ARGS[width][1]
        cfg, note = scaling.experiment(tag)
        rec = scaling.row(tag, cfg, note, res, 0.0, "")
    hashes, whole = {}, hashlib.sha256()
    for name, p in res["state"].state_dict().items():
        b = p.detach().cpu().contiguous().numpy().tobytes()
        hashes[name] = hashlib.sha256(b).hexdigest()
        whole.update(b)
    losses = list(res["losses"]) + list(res.get("ft_losses", []))
    with open(path, "w") as f:
        json.dump(dict(row={k: v for k, v in rec.items() if k != "wall_s"},
                       losses=[float(x).hex() for x in losses],
                       train_steps=res["train_steps"], params=hashes,
                       params_sha256=whole.hexdigest()), f)


def first_divergence(cfg, steps: int = 3) -> dict:
    """Within one process, ``steps`` training steps of ``cfg``'s model twice
    from one seed (a batch of the shadow width's shape, seeded), every
    module's output and output gradient and every parameter's gradient
    recorded: the first that differs between the two, by execution order
    (forward) and backward order (gradients)."""
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.models.d3pm import init_params_
    from ddqst_tpu_torch.ops.diffusion import denoising_loss
    from ddqst_tpu_torch.ops.schedules import make_schedule

    dev = torch.device("cuda")
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    sched = make_schedule(cfg.diffusion.schedule, t_steps, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    x0 = torch.randint(0, 2, (cfg.train.batch_size, n), generator=gen,
                       device=dev, dtype=torch.int32)
    basis = torch.randint(0, 3, (cfg.train.batch_size, n), generator=gen,
                          device=dev)

    def once():
        model = build_model(cfg.model, n, t_steps).to(dev)
        init_params_(model, torch.Generator(device=dev).manual_seed(0))
        opt = torch.optim.Adam(model.parameters(), lr=cfg.train.learning_rate)
        g = torch.Generator(device=dev).manual_seed(1)
        rec = dict(forward=[], backward=[], grads=[])

        def fwd(name):
            def hook(mod, args, out):
                if isinstance(out, torch.Tensor):
                    rec["forward"].append((name, type(mod).__name__,
                                           out.detach().clone()))
                    if out.requires_grad:
                        out.register_hook(lambda gr: rec["backward"].append(
                            (name, type(mod).__name__, gr.clone())))
            return hook

        hooks = [m.register_forward_hook(fwd(name))
                 for name, m in model.named_modules() if name]
        try:
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                denoising_loss(g, model, x0, basis, sched).backward()
                rec["grads"] += [(name, "parameter", p.grad.clone())
                                 for name, p in model.named_parameters()]
                opt.step()
        finally:
            for h in hooks:
                h.remove()
        return rec

    a, b = once(), once()
    out = {}
    for kind in ("forward", "backward", "grads"):
        first = next(((i, na, ty, float((x.double() - y.double()).abs().max()))
                      for i, ((na, ty, x), (_, _, y))
                      in enumerate(zip(a[kind], b[kind]))
                      if not torch.equal(x, y)), None)
        out[kind] = (None if first is None else dict(
            index=first[0], of=len(a[kind]), name=first[1], type=first[2],
            max_abs_diff=first[3]))
    return out


def repeat_check(width: str) -> dict:
    """``REPEAT_ARGS[width]`` in two child processes from one seed, their
    loss trace, parameter hashes and rows compared; where they differ,
    ``first_divergence`` names the first tensor that does (at the shadow
    width)."""
    runs = []
    with tempfile.TemporaryDirectory() as d:
        for i in range(2):
            path = os.path.join(d, f"run{i}.json")
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   "--repeat-child", width, path],
                                  cwd=repo_file("."), timeout=900)
            check(proc.returncode == 0, f"repeat child {i} exits 0")
            with open(path) as f:
                runs.append(dict(json.load(f), s=time.perf_counter() - t0))
    a, b = runs
    same = dict(losses=a["losses"] == b["losses"],
                params=a["params_sha256"] == b["params_sha256"],
                row=a["row"] == b["row"])
    out = dict(same=same,
               runs=[dict(params_sha256=r["params_sha256"], s=r["s"],
                          train_steps=r["train_steps"],
                          losses=len(r["losses"]),
                          last_loss=float.fromhex(r["losses"][-1]),
                          row=r["row"]) for r in runs],
               first_param_differing=next(
                   (k for k in a["params"] if a["params"][k] != b["params"][k]),
                   None),
               row_keys_differing=[k for k in a["row"]
                                   if a["row"][k] != b["row"].get(k)])
    log("repeat", f"{width}: two processes, {' '.join(REPEAT_ARGS[width])}: "
        f"{len(a['losses'])} losses, the last {float.fromhex(a['losses'][-1])}"
        f" / {float.fromhex(b['losses'][-1])}; params sha256 "
        f"{a['params_sha256'][:16]} / {b['params_sha256'][:16]}; same: "
        f"{same}; first parameter differing: {out['first_param_differing']};"
        f" row keys differing: {out['row_keys_differing']}")
    if not all(same.values()) and width == "shadow":
        from ddqst_tpu_torch.campaigns.shadow_scale import make_cfg

        out["first_divergence"] = first_divergence(
            make_cfg("repeat", epochs=1, max_bases=100))
        log("repeat", f"first divergence within one process: "
            f"{json.dumps(out['first_divergence'])}")
    return out


# The shape at which ``nn.Embedding``'s CUDA backward did not repeat: the
# shadow width's batch, 1,024 rows of N = 10 bits, into the 2-row
# ``bit_emb`` of width 128.
EMBED_CHECK_SHAPE = (2, 1024 * 10, 128)


def embed_grads(lookup, rows: int, m: int, e: int) -> list[torch.Tensor]:
    """``lookup``'s gradient of one ``[rows, e]`` table twice, for one
    seeded index tensor ``[m]`` and one output gradient ``[m, e]``."""
    from torch import nn

    gen = torch.Generator(device="cuda").manual_seed(3)
    table = nn.Embedding(rows, e).cuda()
    idx = torch.randint(0, rows, (m,), generator=gen, device="cuda")
    grad_out = torch.randn((m, e), generator=gen, device="cuda")
    grads = []
    for _ in range(2):
        table.weight.grad = None
        lookup(table, idx).backward(grad_out)
        grads.append(table.weight.grad.clone())
    return grads


def embed_repeat() -> dict:
    """``models.d3pm.embed``'s backward twice at ``EMBED_CHECK_SHAPE``: the
    two gradients equal bit for bit (a check), and equal to
    ``nn.Embedding``'s within float rounding; whether ``nn.Embedding``'s own
    CUDA backward repeats there is recorded, not checked."""
    from ddqst_tpu_torch.models.d3pm import embed

    t0 = time.perf_counter()
    rows, m, e = EMBED_CHECK_SHAPE
    a, b = embed_grads(lambda t, i: embed(t, i, torch.float32), rows, m, e)
    check(torch.equal(a, b), f"embed's backward repeats bit for bit at "
          f"{rows} rows x {m} indices x {e}")
    c, d = embed_grads(lambda t, i: t(i), rows, m, e)
    err = float((a - c).abs().max() / c.abs().max())
    check(err < 1e-5, f"embed's gradient equals nn.Embedding's within 1e-5 "
          f"of its largest entry: {err:.3g}")
    out = dict(shape=list(EMBED_CHECK_SHAPE), repeats=True,
               nn_embedding_repeats=bool(torch.equal(c, d)),
               nn_embedding_max_abs_diff=float((c - d).abs().max()),
               rel_err_to_nn_embedding=err, s=time.perf_counter() - t0)
    log("train_profile", f"embed backward at {EMBED_CHECK_SHAPE}: repeats; "
        f"nn.Embedding's repeats: {out['nn_embedding_repeats']} (max "
        f"difference {out['nn_embedding_max_abs_diff']:.3g}); embed against "
        f"nn.Embedding {err:.3g} of the largest entry; {out['s']:.2f} s")
    return out


def parent_embed(table, idx, dtype):
    """``models.d3pm.embed`` before its backward was made to repeat:
    ``nn.Embedding``'s lookup and CUDA backward."""
    return table(idx.long()).to(dtype)


# Steps a timed turn of ``--train-step-times``: the widths' training at
# ``TIMING_EPOCHS`` epochs, in turns with the parent's embed.
TRAIN_STEP_TURNS = ("embed", "parent", "embed", "parent")


def train_step_times() -> dict:
    """``--train-step-times``: ms a training step at the shadow and ``rqc``
    widths with ``embed``'s repeating backward and with the parent's
    (``parent_embed``), in turns within this process."""
    from ddqst_tpu_torch.config import get_preset
    from ddqst_tpu_torch.models import d3pm, transformer

    own = d3pm.embed
    out = {}
    for preset, rows in (("shadow_transformer", 100 * 1024),
                         ("rqc", 27 * 1024)):
        cfg = get_preset(preset)
        ms = {"embed": [], "parent": []}
        for turn in TRAIN_STEP_TURNS:
            fn = own if turn == "embed" else parent_embed
            d3pm.embed = transformer.embed = fn
            try:
                rate = train_steps_per_s(cfg, rows, TIMING_EPOCHS[preset])
            finally:
                d3pm.embed = transformer.embed = own
            ms[turn].append(1e3 / rate)
        out[preset] = ms
        log("train_step_times", f"{preset}: ms a step, {TRAIN_STEP_TURNS}: "
            f"embed {ms['embed']}, parent {ms['parent']}")
    return out


def time_kernels(ck) -> dict:
    """Both kernels' ms at their shapes, in the forms every version of the
    port has (the step kernel with ``rows``, the walk with the body its plan
    chooses), for comparing two checkouts on one card. The ``row_base`` form
    and the walk from N = 8 on are timed where the package has them."""
    import inspect

    out = {}
    shapes = [("walk_main", 27, 3, 5000, 50), ("walk_1e6", 27, 3, 37037, 20),
              ("walk_n7", 27, 7, 5000, 20)]
    if getattr(ck, "_MAX_WALK_N", 7) >= 11:  # the walk takes N = 8 to 11
        shapes += [("walk_shadow", 100, 10, 5000, 20),
                   ("walk_shadow_bench", 50, 10, 2000, 20),
                   ("walk_n8_grid", 3**8, 8, 319, 5),
                   ("walk_n11", 100, 11, 5000, 10)]
    if getattr(ck, "_MAX_WALK_N", 7) >= 12:  # and N = 12 to 16
        shapes += [("walk_n12", 100, 12, 5000, 5),
                   ("walk_n13", 50, 13, 5000, 5),
                   ("walk_n14", 25, 14, 5000, 5),
                   ("walk_n15", 12, 15, 5000, 5),
                   ("walk_n16", 6, 16, 5000, 5)]
    for label, c, n, s, iters in shapes:
        tables, init = random_walk_inputs(100, c, n, s, seed=20)
        out[label] = cuda_ms(lambda: ck.fused_chain_walk(5, tables, init, n),
                             iters)
    has_base = "row_base" in inspect.signature(ck.fused_chain_step).parameters
    for label, (g, n, b) in (("step_eval", (50 * 27 * 8, 3, 6_750_000)),
                             ("step_n7", (3**7 * 2**7, 7, 1_000_000))):
        table, rows = random_step_inputs(g, n, b, seed=50)
        out[label + "_rows"] = cuda_ms(
            lambda: ck.fused_chain_step(5, table, rows, n, 1), 50)
        if has_base:
            x, base = rows % 2**n, rows - rows % 2**n
            out[label + "_row_base"] = cuda_ms(
                lambda: ck.fused_chain_step(5, table, x, n, 1, row_base=base),
                50)
    return out


# Steps a turn of ``--ce-step-times``: timed after a warm-up of as many.
CE_STEP_TIMES_STEPS = 400


def ce_step_ms(root: str, tag: str = "ghz6_auto") -> dict:
    """``--ce-step-times [DIR]``: ms a CE training step of rung ``tag`` at
    full width (``train_steps_per_s`` on random rows, one batch a step), with
    the package of the checkout at ``DIR`` (``kernels_of`` puts it first),
    alone in this process."""
    ck = kernels_of(root)
    cfg = scaling_rung(tag)
    rate = train_steps_per_s(cfg, CE_STEP_TIMES_STEPS * cfg.train.batch_size,
                             1)
    return dict(tag=tag, ms=1e3 / rate, steps=CE_STEP_TIMES_STEPS,
                batch=cfg.train.batch_size,
                package=os.path.dirname(os.path.dirname(ck.__file__)))


def kernels_of(root: str):
    """``ddqst_tpu_torch.ops.cuda_kernels`` of the checkout at ``root``
    (``--time-kernels``). This script imports nothing of the package at
    module level, so ``root`` comes first; a module from anywhere else
    raises."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from ddqst_tpu_torch.ops import cuda_kernels as ck

    where = os.path.abspath(ck.__file__)
    if not where.startswith(os.path.join(root, "")):
        raise RuntimeError(f"--time-kernels {root}: the kernels imported "
                           f"are {where}, not that checkout's")
    return ck


def build_all(_build) -> dict[str, float]:
    """Build every source at once, one compiler each (nvcc for the CUDA
    sources, g++ for the statevector engine); returns each one's seconds."""
    names = ("chain_walk", "chain_step", "int_rate", "walk_ablation",
             "statevec")
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(_build.build, names))
    for name, (path, seconds) in zip(names, built):
        log("build", f"{os.path.basename(_build._source(name)[0])} -> {path} "
            f"in {seconds:.2f} s")
        with open(f"{path}.log") as f:
            for line in f.read().splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log("build", line.strip())
    return {name: seconds for name, (_, seconds) in zip(names, built)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port "
              "on a GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--time-kernels"]:
        # python3 chip_smoke.py --time-kernels [DIR]: only time the kernels
        # of the checkout at DIR (default: this one) and print one JSON line.
        ck = kernels_of(sys.argv[2] if sys.argv[2:] else
                        os.path.dirname(__file__))
        print(json.dumps({"time_kernels_ms": time_kernels(ck),
                          "package": os.path.dirname(ck.__file__)}), flush=True)
        return 0
    if sys.argv[1:2] == ["--ce-step-times"]:
        # python3 chip_smoke.py --ce-step-times [DIR]: only the ms of a CE
        # step of ghz6_auto with the checkout at DIR (default: this one),
        # one JSON line; run it for two checkouts in turns to compare them.
        print(json.dumps({"ce_step_times": ce_step_ms(
            sys.argv[2] if sys.argv[2:] else os.path.dirname(__file__))}),
            flush=True)
        return 0
    try:
        from ddqst_tpu_torch.ops import _build
        from ddqst_tpu_torch.ops import cuda_kernels as ck
    except ImportError as e:
        print(f"chip_smoke: the ddqst_tpu_torch package is missing ({e}); "
              "run from the root of a checkout", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("setup", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} ({smi})")

    if sys.argv[1:2] == ["--campaign"]:
        # python3 chip_smoke.py --campaign TAG OUT_DIR: one rung uncut
        # through campaigns.scaling on its committed data, its row appended
        # to OUT_DIR/scaling.jsonl, checked.
        if len(sys.argv) != 4:
            print("usage: chip_smoke.py --campaign TAG OUT_DIR",
                  file=sys.stderr)
            return 2
        tag, out_dir = sys.argv[2:]
        check(tag in SCALING_DATA, f"{tag} has committed data "
              f"({sorted(SCALING_DATA)})")
        build_all(_build)
        print(json.dumps({"campaign": campaign_rung(ck, tag, out_dir, smi),
                          "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--shadow-segments"]:
        # python3 chip_smoke.py --shadow-segments OUT_DIR probe | K S
        # [START]: the probe times a step of segment 0 in this process;
        # otherwise the driver runs K segments of S steps from segment START
        # (default 0) and the eval, in OUT_DIR, then the checks.
        args = sys.argv[2:]
        if len(args) not in (2, 3, 4) or (len(args) == 2
                                          and args[1] != "probe"):
            print("usage: chip_smoke.py --shadow-segments OUT_DIR probe | "
                  "K S [START]", file=sys.stderr)
            return 2
        build_all(_build)
        out = (shadow_segments_probe(args[0]) if args[1] == "probe" else
               shadow_segments_run(ck, args[0], int(args[1]), int(args[2]),
                                   int(args[3]) if args[3:] else 0, smi))
        print(json.dumps({"shadow_segments": out, "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--parity"]:
        # python3 chip_smoke.py --parity OUT_DIR [TAG ...]: parity_suite's
        # tags (default: the ten of phases 1-3) uncut, checked; one JSON
        # line.
        if len(sys.argv) < 3:
            print("usage: chip_smoke.py --parity OUT_DIR [TAG ...]",
                  file=sys.stderr)
            return 2
        tags = sys.argv[3:] or list(PARITY_TAGS)
        build_all(_build)
        print(json.dumps({"parity": parity_run(ck, tags, sys.argv[2], smi),
                          "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--rqc3-ceiling"]:
        # python3 chip_smoke.py --rqc3-ceiling OUT_DIR [--run]: the ceiling
        # rows against the JAX package's; --run adds RQC3_RUN_TAG uncut.
        if len(sys.argv) not in (3, 4):
            print("usage: chip_smoke.py --rqc3-ceiling OUT_DIR [--run]",
                  file=sys.stderr)
            return 2
        build_all(_build)
        out = rqc3_ceiling_run(sys.argv[2], smi, sys.argv[3:] == ["--run"])
        print(json.dumps({"rqc3_ceiling": out, "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--profiles"]:
        # python3 chip_smoke.py --profiles OUT_DIR: the N=10 sector profile
        # of the reference's snapshot against the JAX package's record, all
        # 48 bases; then GHZ-8 at full shape (the MLE target, the eval
        # floor, the sector profile and two routes to the full-grid CE).
        if len(sys.argv) != 3:
            print("usage: chip_smoke.py --profiles OUT_DIR", file=sys.stderr)
            return 2
        build_all(_build)
        out = dict(shadow=shadow_profile(ck, sys.argv[2], smi),
                   ghz8=ghz8_profiles(ck, sys.argv[2], smi))
        print(json.dumps({"profiles": out, "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--diag"]:
        # python3 chip_smoke.py --diag OUT_DIR probe | STEPS WARM: one
        # probe arm, or the three GHZ-5 diagnostics side by side at a cut
        # depth (their full recipes outlast a call; the probe says so).
        if len(sys.argv) not in (4, 5) or (
                len(sys.argv) == 4 and sys.argv[3] != "probe"):
            print("usage: chip_smoke.py --diag OUT_DIR probe | STEPS WARM",
                  file=sys.stderr)
            return 2
        build_all(_build)
        out = (diag_probe(ck) if sys.argv[3:] == ["probe"] else
               diag_run(sys.argv[2], smi, sys.argv[3:]))
        print(json.dumps({"diag": out, "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--repeat-child"]:
        repeat_child(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--repeat-check"]:
        # python3 chip_smoke.py --repeat-check [WIDTH ...]: at each width
        # (default: shadow and rqc) one run in each of two processes from
        # one seed, compared, embed's backward twice first; one JSON line.
        # A width whose two runs differ fails the mode.
        widths = sys.argv[2:] or list(REPEAT_ARGS)
        for w in widths:
            check(w in REPEAT_ARGS, f"{w} is a width of {list(REPEAT_ARGS)}")
        build_all(_build)
        out = dict(embed=embed_repeat())
        out.update({w: repeat_check(w) for w in widths})
        print(json.dumps({"repeat_check": out, "card": smi}), flush=True)
        for w in widths:
            check(all(out[w]["same"].values()), f"{w}: the two runs equal "
                  f"in losses, parameters and row: {out[w]['same']}")
        return 0
    if sys.argv[1:2] == ["--train-step-times"]:
        # python3 chip_smoke.py --train-step-times: ms a training step with
        # embed's repeating backward and the parent's, in turns.
        print(json.dumps({"train_step_times": train_step_times(),
                          "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--profile-distill"]:
        print(json.dumps({"profile_distill": profile_distill(), "card": smi}),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--scaling"]:
        # python3 chip_smoke.py --scaling TAG [TAG ...]: only the named
        # rungs of the scaling ladder, uncut, and one JSON line.
        tags = sys.argv[2:]
        for tag in tags:  # a rung without checks raises before any work
            check(tag in SCALING_PLAN, f"{tag} is a rung with checks "
                  f"({sorted(SCALING_PLAN)})")
        build_all(_build)
        print(json.dumps({"scaling_uncut": scaling_uncut(ck, tags),
                          "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--scaling-part"]:
        # python3 chip_smoke.py --scaling-part TAG PART IN_DIR OUT_DIR
        # [--cut | --no-stop K] [--draws FILE] [--salt K] [--seed K]
        # [--matmul-precision NAME] [--row-note TEXT]: one part of a split
        # rung (SCALING_PARTS), its record written to
        # OUT_DIR/TAG_PART[_seedK][_diagnostics].json and printed as one
        # JSON line.
        # The precision covers the part and its checks (the exact chain is
        # the model's at that precision); the estimators stay float32.
        from ddqst_tpu_torch.ops import precision

        try:
            a = scaling_part_args(sys.argv[2:])
        except ValueError as e:
            print(f"chip_smoke: {e}", file=sys.stderr)
            return 2
        tag, part, in_dir, out_dir, cut, cfg, parts, diag = (
            a[k] for k in ("tag", "part", "in_dir", "out_dir", "cut", "cfg",
                           "parts", "no_stop"))
        build_all(_build)
        mm = a["matmul_precision"]
        with (_MleCapped(SCALING_MLE_ITERS[tag]) if cut
              else contextlib.nullcontext()), \
                precision.default_matmul_precision(mm):
            out, res, rec = scaling_part(ck, tag, part, in_dir, out_dir, cut,
                                         cfg=cfg, parts=parts,
                                         salt=a["salt"], seed=a["seed"],
                                         draws=a["draws"])
            name, note = part_names(a)
            if parts[part].get("eval"):
                out.update(scaling_part_checks(ck, tag, cfg, res, rec, cut))
                if diag:
                    out["verdict"] = (f"diagnostic: {diag} steps without the "
                                      "early stop, not the recipe")
                elif not cut:
                    out["row"], out["part_walls"] = split_row(
                        tag, cfg, res, in_dir, list(parts), out["wall_s"],
                        smi, a["seed"])
                    out["row"]["note"] += note
                    with open(os.path.join(out_dir, "scaling.jsonl"),
                              "a") as f:
                        f.write(json.dumps(out["row"]) + "\n")
        out["card"] = smi
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(out, f)
        print(json.dumps({"scaling_part": out}), flush=True)
        return 0
    if sys.argv[1:2] == ["--scaling-cut"]:
        # python3 chip_smoke.py --scaling-cut TAG: only the default run's
        # cut of a split rung, through its parts, and one JSON line.
        build_all(_build)
        print(json.dumps({"scaling_cut": scaling_split_cut(sys.argv[2]),
                          "card": smi}), flush=True)
        return 0
    if sys.argv[1:2] == ["--scaling-costs"]:
        # python3 chip_smoke.py --scaling-costs: the stages of the N = 7 and
        # 8 rungs measured alone, and one JSON line.
        print(json.dumps({"scaling_costs": scaling_costs(), "card": smi}),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--shadow-reference-train"]:
        # python3 chip_smoke.py --shadow-reference-train: the reference's
        # N=10 recipe trained uncut by the port, and one JSON line.
        build_all(_build)
        out = shadow_reference_train(ck)
        print(json.dumps({"shadow_reference_train": out, "card": smi}),
              flush=True)
        return 0
    if sys.argv[1:2] == ["--bench"]:
        # python3 chip_smoke.py --bench [ARGS]: the port's bench,
        # python -m ddqst_tpu_torch.bench ARGS (default: bench.py's full
        # depth); its record is the last line.
        from ddqst_tpu_torch import bench

        return bench.main(sys.argv[2:])
    if sys.argv[1:2] == ["--full-depth"]:
        # python3 chip_smoke.py --full-depth [SEEDS]: only the bench
        # recipes, uncut, and one JSON line of their results.
        from ddqst_tpu_torch.bench import FULL_DEPTH

        runs = phase_distill(ck, dict.fromkeys(("ghz", "rqc"), FULL_DEPTH),
                             ghz_seeds=int(sys.argv[2]) if sys.argv[2:] else 1)
        print(json.dumps({"full_depth": runs,
                          "card": smi}), flush=True)
        return 0

    phase_s: dict[str, float] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log("time", f"phase {name}: {phase_s[name]:.1f} s")
        return out

    build_s = timed("build", build_all, _build)
    rate = timed("rate", phase_rate, _build)
    ablation = timed("ablation", phase_ablation, _build, ck)
    kernel = timed("kernel", phase_kernel, ck)
    launches, res = timed("main", phase_main_path, ck)
    step = timed("step", phase_step, ck)
    timed("seq_walk", phase_seq_walk, ck, res["state"])
    step_launches, path_ms = timed("route", phase_route, ck)
    timed("generate", phase_generate, build_s["statevec"])
    distill = timed("distill", phase_distill, ck, DISTILL_DEPTH)
    bench = timed("bench", phase_bench, ck, distill)
    chunked_launches = timed("chunked", phase_chunked, ck, res["state"])
    shadow = timed("shadow", phase_shadow, ck)
    reference = timed("reference_shadow", phase_reference_shadow, ck)
    shadow_n12 = timed("shadow_n12", phase_shadow_n12, ck, shadow)
    notebook = timed("notebook", phase_notebook, ck)
    denoise = timed("denoise", phase_denoise, ck, res)
    bf16 = timed("bf16", phase_bf16, ck, res)
    train_profile = timed("train_profile", phase_train_profile)
    mesh = timed("mesh", phase_mesh)
    # The campaigns' driver processes run beside phase scaling (as its split
    # rung's parts do); phase campaigns is the wait for them after it. The
    # kernels are timed once every other process has left the card.
    with tempfile.TemporaryDirectory() as d, ThreadPoolExecutor(3) as pool:
        chains = start_campaigns(pool, d, smi)
        scaling = timed("scaling", phase_scaling, ck)
        campaigns = timed("campaigns", lambda: {k: f.result()
                                                for k, f in chains.items()})
    scaling["kernels"] = timed("scaling_kernels", scaling_kernel_rows, ck)
    profiles = timed("profiles", phase_profiles, ck, smi)

    main_rec = kernel["main"]
    bench_rec = kernel["bench"]
    eval_rec = step["eval"]
    int_rate = rate["rates"]["logic3"]
    print(json.dumps({"kernels": [{
        "name": "fused_chain_walk",
        "route": "cuda",
        "source": "ddqst_tpu_torch/csrc/chain_walk.cu",
        "replaces": "ddqst_tpu/ops/pallas_kernels.py:158",
        "launches": launches,
        "max_abs_err": max(kernel["max_abs_err"],
                           reference["kernel"]["max_abs_err"],
                           shadow_n12["kernel"]["max_abs_err"]),
        "ms": main_rec["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
        "ms_1e6_chains": kernel["1e6"]["ms"],
        "plain_ms_1e6_chains": kernel["1e6"]["plain_ms"],
        "bound_ms_1e6_chains": kernel["1e6"]["bound_ms"],
        "threads": main_rec["threads"],
        "ms_by_threads": main_rec["ms_by_threads"],
        "launches_bench_recipes": [r["walk_launches"] for r in distill],
        "launches_bench": {k: bench["parts"][k]["walk_launches"]
                           for k in ("sampling", "walk_1m", "shadow")},
        "ms_bench_shape": bench_rec["ms"],
        "plain_ms_bench_shape": bench_rec["plain_ms"],
        "bound_ms_bench_shape": bench_rec["bound_ms"],
        "threads_bench_shape": bench_rec["threads"],
        "ms_by_threads_bench_shape": bench_rec["ms_by_threads"],
        "int_ops_per_s_measured": int_rate,
        "sass_instructions": rate["sass"]["walk_n3"],
        "ms_n7": kernel["n7"]["ms"],
        "plain_ms_n7": kernel["n7"]["plain_ms"],
        "bound_ms_n7": kernel["n7"]["bound_ms"],
        "launches_shadow_route": shadow["walk_launches"],
        "launches_reference_shadow": reference["walk_launches"],
        **{f"{k}_reference_shadow": reference["kernel"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "threads",
                     "plan")},
        "launches_shadow_n12": shadow_n12["walk_launches"],
        **{f"{k}_shadow_n12": shadow_n12["kernel"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "plan")},
        "launches_chunked_sampler": chunked_launches,
        "launches_notebook_presets": {k: v["walk_launches"]
                                      for k, v in notebook.items()},
        "launches_denoise_mode": denoise["walk_launches"],
        "launches_bf16_rqc": bf16["walk_launches"],
        "launches_mesh_per_rank": {
            "dp2_rqc": mesh["dp2_rqc"]["walk_launches"],
            "tp2_shadow": mesh["tp2_shadow"]["walk_launches"]},
        **{f"{k}_{label}": kernel[label][k]
           for label in ("shadow", "shadow_bench", "n8_grid", "n11", "n12",
                         "n13", "n14", "n15", "n16")
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "threads",
                     "ms_by_threads", "plan")},
        "sass_instructions_n10_ring": rate["sass"]["walk_n10_ring"],
        "sass_instructions_n10_global": rate["sass"]["ablation_n10_2"],
        "sass_instructions_n12_global": rate["sass"]["ablation_n12_2"],
        "sass_instructions_n12_gather": rate["sass"]["walk_n12_gather"],
        "ablation_ms": ablation,
        "launches_scaling": {
            tag: scaling["rungs"][tag]["walk_launches"]
            for tag in SCALING_WALK_SHAPES if tag in scaling["rungs"]},
        "scaling_shapes": {tag: r for tag, r in scaling["kernels"].items()
                           if r["kernel"] == "fused_chain_walk"},
        "launches_campaigns": {
            "scaling_cpu_tiny": campaigns["ladder"]["walk_launches"],
            "probe_rqc4_auto": campaigns["probe"]["walk_launches"]},
        "launches_profiles": profiles["launches"]["walk"],
        "shape_rqc4_auto": list(RQC4_WALK_SHAPE),
        **{f"{k}_rqc4_auto": kernel["rqc4"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "threads",
                     "ms_by_threads", "plan")},
    }, {
        "name": "fused_chain_step",
        "route": "cuda",
        "source": "ddqst_tpu_torch/csrc/chain_step.cu",
        "replaces": "ddqst_tpu/ops/pallas_kernels.py:71",
        "launches": step_launches,
        "max_abs_err": step["max_abs_err"],
        "ms": eval_rec["ms"],
        "plain_ms": eval_rec["plain_ms"],
        "bound_ms": eval_rec["bound_ms"],
        "bound_by": eval_rec["bound_by"],
        "library_ms": None,
        "ms_n7": step["n7"]["ms"],
        "plain_ms_n7": step["n7"]["plain_ms"],
        "bound_ms_n7": step["n7"]["bound_ms"],
        "ms_rows_form": eval_rec["ms_rows_form"],
        "bound_ms_rows_form": eval_rec["bound_ms_rows_form"],
        "ms_n7_rows_form": step["n7"]["ms_rows_form"],
        "ms_route_rows": eval_rec["ms_route_rows"],
        "path_ms_per_step": path_ms,
        "int_ops_per_s_measured": int_rate,
        "sass_instructions": rate["sass"]["step_n3_row_base"],
        "launches_scaling": {
            tag: scaling["rungs"][tag]["step_launches"]
            for tag in SCALING_STEP_SHAPES},
        "scaling_shapes": {tag: r for tag, r in scaling["kernels"].items()
                           if r["kernel"] == "fused_chain_step"},
        "launches_profiles": profiles["launches"]["step"],
    }], "lane_instructions_per_s": rate["rates"],
        "bench_recipes": distill, "bench": bench["parts"], "shadow": shadow,
        "reference_shadow": reference, "shadow_n12": shadow_n12,
        "notebook": notebook,
        "denoise": denoise, "bf16": bf16, "train_profile": train_profile,
        "mesh": mesh, "scaling": scaling, "campaigns": campaigns,
        "profiles": profiles,
        "phase_seconds": phase_s}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
