#!/usr/bin/env python3
"""Quickest proof that the torch port runs on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card and nvcc
    python3 chip_smoke.py --profile  # also: kernel-time breakdowns of a
                                     # served run, of the train step
                                     # under each MLP recipe and each
                                     # mask and of the moe_ab grouped
                                     # step (torch.profiler)
    python3 chip_smoke.py --paired DIR  # also: K1-K12 timed in turns
                                     # (old, new, new, old) against
                                     # DIR's paged_attention.cu,
                                     # flash_attention.cu and
                                     # mlp_matmul.cu (a checkout of an
                                     # earlier commit, e.g. unpacked with
                                     # git archive under build/)

Phases, in order; any failure exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: every ``dlnetbench_tpu_torch/ops/csrc/*.cu`` with nvcc for
   sm_90a (one nvcc per source, in parallel; seconds and ptxas resource
   lines printed);
3. K1 (paged attention, bf16 pages; split over each slot's sequence in
   blocks of 4 pages, the partials combined by the last block to
   finish) against its plain PyTorch version
   on the card at the decode shapes of the served model (B=8 slots,
   Hq=32, Hkv=8, Dh=128, page 16, 32 pages per slot, lengths 1..512
   with ragged last pages); tolerance 2e-2 absolute and relative, the
   JAX package's kernel-vs-gather bar (tests/test_serving.py), since the
   output is bf16.  Times (median of single launches with L2 flushed
   between them): the kernel, its plain version, and one
   ``scaled_dot_product_attention(enable_gqa=True)`` call on K/V
   gathered beforehand (a yardstick the port never calls), beside the
   bound: the bytes the call must move over the card's memory rate;
4. K2 (int8 and e4m3 pages) the same way, tolerance 2e-2 (bf16 output;
   the SDPA yardstick reads the pages dequantized beforehand);
5. K3/K4/K5 (flash attention forward, dq, dk/dv) against their plain
   versions at the train step's shapes (B=2, S=6144, Hq=32, Hkv=8,
   Dh=128, bf16, causal), plus a non-causal and a Dh=64 case at S=1024;
   each kernel is held alone (the plain backward reads the kernel's O,
   lse and D).  Tolerances: every row of O, dq, dk and dv (the Dh
   values of one batch, position and head) within 2^-6 of that row's
   own max-abs (floored at 1e-3 of the tensor's, for rows that cancel
   to ~0) — both sides round the output to bf16 (one ulp apart at
   most, <= 2^-7 of the row's largest value) after f32 sums of the same
   bf16-rounded p and ds taken in another order; a bar per row keeps it
   at the scale of the values it separates, where late rows of O and
   late keys' dk/dv are ten times under their tensor's max-abs.  lse
   and D 1e-3 absolute.  Times as in 3, at the train shape; the yardsticks
   are SDPA's forward (K3) and SDPA's backward, which computes dq, dk
   and dv together (K4 and K5 both list it);
5a. K6/K7/K8 (splash attention: K3-K5 driven by a BlockMask) at the
   same train shape under five masks — window(1024), seg(avg=768),
   their intersection, a non-causal seg(768) and plain causal — each
   against the chunked plain versions at K3-K5's bars; under the
   plain-causal mask bitwise equal to K3/K4/K5; two planted faults (a
   tile dropped from a visit range, an interval widened by a key) must
   break the bar in each kernel.  Every kernel timed under every mask
   beside its bound over the mask's live pairs; for window(1024), the
   kernels line's row, the plain versions and SDPA with the dense bool
   mask (forward; forward + backward for K7 + K8) too; the f32
   (CUDA-core) K6/K7/K8 at (2, 384, 4, 2, 128) under the JAX tests'
   MASK_SPECS, every row within 4e-3 of its max-abs, and under the
   plain-causal mask bitwise equal to the f32 K3/K4/K5;
5b. K11 (the fused-quantization matmul; with K12 one warp-specialised
   wgmma/TMA kernel) at the train step's MLP shapes
   (gate/up [12288, 4096] @ [4096, 14336], down [12288, 14336] @
   [14336, 4096]), int8 and e4m3, with and without amax, against its
   plain version on the card: int8 bit-exact; e4m3 every row within
   2^-6 of its max-abs and a relative Frobenius error <= 1e-2 (the JAX
   bar); amax exactly max |x|; a stale scale (0.1 x the amax) gives a
   finite, saturated output equal to the plain version's.  Yardstick:
   ``torch._int_mm`` / ``torch._scaled_mm`` on operands quantized
   beforehand; the kernel also timed under each cluster size (1, 2, 4
   blocks along N sharing one quantized x stage);
5c. K9 (dg, du) and K10 (dWd; on K11's wgmma/TMA skeleton, as K11 and
   K12) at the same shape against their plain versions: dg and du every
   row within 2^-6 of its max-abs, dWd within 1e-3; yardsticks one
   ``torch.mm`` each (dy @ Wd^T, h^T @ dy); K10 also timed under each
   cluster size (1, 2, 4 blocks along D sharing one h stage);
5d. K12 (the grouped expert matmul) against its plain version: bf16 at
   the bench's moe_ab shapes (8 experts x 1280 slots, 4096 -> 7168 and
   7168 -> 4096) and at mixtral_8x7b width (4096 -> 14336), int8 and
   e4m3 at the moe_ab gate/up shape, each with full and with skewed
   counts ([1280, 1000, 0, 17, 640, 1280, 129, 1]): every row at or past
   a count exactly zero; bf16 every row within 2^-6 of its max-abs; int8
   bit-exact; e4m3 every row within 2^-6 and Frobenius <= 1e-2.
   Yardsticks at the moe_ab gate/up shape, full counts: one
   ``torch.bmm`` (bf16), 8 per-expert ``torch._int_mm`` /
   ``torch._scaled_mm`` products summed (int8 / e4m3); int8 / e4m3 also
   timed under each cluster size;
5e. with ``--paired DIR``: K1, K2 int8 and K2 e4m3 at the decode shape
   against DIR's paged_attention.cu (called with its own C argument
   list); K3 at the train shape (causal) and K6 under window(1024),
   then K4 and K5 (causal) and K7 and K8 (window(1024)) as controls,
   each side's BlockMask packed at the tiles DIR's wrapper declares,
   against the same C entry points built from DIR's flash_attention.cu;
   then K9 and K10 at
   the train shape, K11 (int8, e4m3; up and down) and K12 (bf16, int8,
   e4m3; gate/up and down, full counts, and gate/up skewed) against
   DIR's mlp_matmul.cu (both sources compiled at once); both outputs
   held to the plain version first, then timed old, new, new, old;
5f. the card-only pytest cases (tests/test_torch_card_*.py, which import
   no jax) in a subprocess, ``pytest --noconftest -m cuda``: rc 0 and at
   least CARD_TESTS_MIN cases passed (every case of those files);
5g. the tuner (run after 5d): ``python -m dlnetbench_tpu_torch.tuning
   tune``'s entry point on the card for ``quantized_matmul`` (e4m3,
   [2048, 4096] @ [4096, 14336], clusters 1, 2, 4) and
   ``paged_attention`` (the served decode geometry, every divisor of its
   32 pages a slot) into a fresh DB under build/: each committed record
   names this card's chip key (``h100_sxm`` on an H100 SXM) and consults
   back as a hit through the real sites (``fused_matmul``,
   ``kv_cache.decode_split``); K11 under every cluster and K1 under
   every split held to their plain versions at 5b's and 3's bars, and
   under the tuned configs; then the bench's ``tuned_ab`` line on that
   DB (the e4m3 fused SwiGLU chain frozen against DB-tuned clusters, its
   bands printed); the DB is switched off again after;
6. a tiny f32 model served on the card and on the CPU (plain versions)
   with the same weights: greedy token streams must be equal, for each
   cache dtype;
7. serve through ``dlnetbench_tpu_torch.cli.main(["serve", ...])`` at
   llama3_8b width (4096 hidden, 32/8 heads, ff 14336, 4 layers, vocab
   32768, bf16) with 16 seeded poisson requests, once per cache dtype:
   every request completes with every token in the vocab, and the
   kernel's launch counter rose by layers x decode steps in that run;
7a. the decode-loop phase, the same served model and plan through
   ``cli serve``, the launch and step counters set to 0 before each run
   and read after it: ``--multi_step_n 16`` on bf16 (K1), int8 and fp8
   (K2), whose streams must equal 7's exactly, K1/K2 launched layers x
   device steps; ``--attn_impl gather`` at N=1 (no kernel launch);
   ``--multi_step_n 16 --speculative --spec_k 4`` with the ngram and the
   truncated (``--drafter_layers 1``) drafter, under ``gather`` and
   under ``auto``, every stream complete; K1 a round: drafter_layers x
   spec_k for the truncated drafter and none in the verify pass (one
   gather-math pass over slots x (spec_k + 1) rows, as in the JAX
   package); their agreement with the N=1 streams (under ``gather`` the
   gather N=1 run, under ``auto`` 7's) printed, not asserted: the verify
   pass rounds at slots x (spec_k + 1) rows where the 1-step engine
   rounds at slots, and a near-tie argmax can flip (7b holds the pass
   itself); sampled (``--temperature 0.8 --top_p 0.95 --sample_seed
   7``) at N=1 and N=16, equal exactly, K1 layers x device steps, then
   with speculation (truncated drafter), whose first draws must all
   equal N=1's (the rest agree in distribution, not token by token: the
   count is printed); ``--grammar json`` at N=16, every stream passing
   ``validate_stream``.  Every fused run's record has steps_per_dispatch
   and tokens_per_sync above 1.  Printed for each run: TTFT and TPOT
   p50 and tokens/s beside its N=1 reference, and ``decode_loop``, and
   for each speculative run its rounds issued and the idle ones; and
   after 10d, one N=16 bf16 run (warm engine) under ``torch.profiler``:
   the device's idle share and its top kernels;
7b. the speculative verify pass at the served model's width (random
   bf16 pools, 8 slots at cache lengths 17 to 490, spec_k + 1 = 5 fed
   tokens each): one pass of ``speculative._verify_tokens`` against 5
   iterated 1-step ``_step_tokens`` calls on the same pools, under
   ``gather`` and under ``auto`` (K1): no K1 launch in the pass, its f32
   logits within VERIFY_TOL of the steps' max-abs logit, and its greedy
   tokens equal the steps' wherever their top-2 margin exceeds twice
   that bar; the pass's time beside one step's and the 5 steps' is
   printed;
7c. the serving-breadth phase through ``cli serve``, the counters set to
   0 before each run and read after it, K1 (bf16) or K2 (int8) launched
   layers x device steps on every run.  Prefix sharing: the served model
   on 7's plan with ``shared_prefix_len`` 120 and ``prefix_pool`` 2 (7
   shared pages of 16 and a copy-on-write page of 8 rows), unshared and
   with ``--prefix_sharing`` at N=1 (with ``--live_metrics``) and N=16
   on bf16, and at N=1 on int8: every sharing run's record has a hit
   rate above 0 and copy-on-write copies; its streams' agreement with
   the unshared run's is printed, and on bf16 each parted stream's first
   flip with its top-2 margin (int8 copies rows that are quantized
   again with the sharer's own, so it has no equality bar); TTFT p50 /
   p99 against the unshared run and ``prefix_bytes_saved`` printed; every
   live-metrics line has the JAX package's locked keys.  MoE decode: a
   tiny f32 MoE decode step (4 experts, top-2, skewed, one slot masked)
   on the card against the CPU, load and rounds equal, the written pools
   within MOE_STEP_TOL of their max-abs, the tokens equal; then a model
   of mixtral_8x7b's width (the served model with 8 experts, top-2,
   capacity factor 1.0: C = 2 at 8 slots) on 7's plan, bf16 and int8 at
   N=1 and N=16 and bf16 at ``--moe_skew`` MOE_SKEW: N=16 streams equal
   N=1, every decode dispatch's load sums to top_k x layers x the tokens
   it fed, the MoE host reads equal layers x (device steps + prefill
   chunks) — exactly layers a fused trip — and the skewed run's
   ``rounds_mean`` exceeds the balanced run's; TPOT p50, ``rounds_mean``
   and the per-expert load printed for each run;
7d. the serving-at-scale phase, at the served model's width, on two
   cards where there are two and on cuda:0 named twice otherwise (the
   list printed): K1 (bf16) and K2 (int8) over pools split along the KV
   heads at 3's decode shape, within SHARD_TOL (K1's bar) of the
   unsharded launch, one launch a shard; ``cli serve --kv_shard 2``
   (bf16, int8) on the first 8 requests of 7's plan, K1/K2 launched 2 x
   layers x device steps, the streams' agreement with 7's printed; the
   migration channel at the served geometry (24 pages in 8-page chunks,
   bf16 / int8 / e4m3): the pages land bit for bit, bytes = pages x
   page_bytes, the send's ms printed; ``--world 2 --disaggregate``
   (int8): every request sent once, bytes under 0.55 x bf16's, K2
   layers x decode steps, agreement with 7's int8 streams and TTFT /
   TPOT p50 of both printed with the migration block's ms p50 and
   overlap; ``--replicas 2 --routing prefix_affinity --prefix_sharing``
   on 7c's prefix-heavy plan (first 8 requests) against one sharing
   engine: the assignment, the hit rates and the agreement printed; and
   ``--world 2`` with a crash of rank 1 at step 12 under ``shrink``:
   every request completes on ``degraded_world`` [0] with 4 slots.  The
   counters are set to 0 before each served run and read after it;
8. a tiny f32 model (TF32 off) takes 2 SGD steps on the card (K3/K4/K5,
   f32 kernels) and on the CPU (plain versions) from the same weights
   and tokens: losses within 1e-5 relative and every parameter within
   1e-5 of its tensor's max-abs (f32 on both sides; summation order);
8b. the MLP recipes' train steps at the bench shape through
   ``bench_step.build`` (counters reset before and read after each):
   int8 composed and fused give bitwise-equal first losses and K11
   launched 3 x layers x steps in the fused run; e4m3 fused with delayed
   scaling keeps finite losses and moves its qstate off the initial
   ones, then holds it within 5 %; ``mlp_backward="pallas"`` gives the
   autograd loss bitwise and every gradient leaf within 2e-2 of its
   max-abs, with K9 and K10 launched layers x steps;
8c. the router's order on tied logits on the card (an all-zero token row
   must route to experts [0, 1], as ``jax.lax.top_k`` orders ties, and
   a row with duplicated router columns as on the CPU); then a tiny f32
   MoE model (4 experts, top-2, ``moe_impl="grouped"``, TF32 off) takes
   2 SGD steps on the card (K12 f32, K3/K4/K5 f32) and on the
   CPU from the same weights: the layers' expert choices are compared
   first (a routing flip is not a kernel fault), then losses within 1e-5
   relative and every parameter within 1e-5 of its leaf's max-abs, K12
   launched 3 x layers x steps;
8d. the quantized grouped expert FFN (``moe.moe_grouped(quant=...)``, the
   JAX package's route to K12 int8 / e4m3) forward and backward at the
   moe_ab width: finite, within 0.1 (relative Frobenius; the recipes'
   own quantization error is 5-7 %) of the bf16 layer, K12 launched 3
   times per format;
8e. a mixtral_8x7b-width train step (``TransformerConfig.from_card``, 2
   layers, S=2048, B=2, vocab 32000): ``moe_impl="grouped"`` against
   ``"sparse"`` on the same weights, first losses within 1e-3 relative
   and within 1.5 of ln V, ms a step of each and the layer-0 routing
   stats; K12 launched 3 x layers x steps in the grouped run only;
9. train through ``dlnetbench_tpu_torch.bench.main([])`` at the bench
   shape (llama3_8b width, 4 layers, vocab 32768, B=2, S=6144, bf16):
   the aux lines come first, under the headline's keys, the one-rank
   ``straggler A/B`` and ``spmd overlap A/B`` as their skip notes — the
   8-bit lines (``fp8_mlp``, ``fp8_swiglu``, ``int8_matmul``: the composed
   recipes' library products, never K11) each with a share of the 8-bit
   peak in (0, 1.0], ``tuned_ab`` (its bands, an ephemeral DB),
   ``checkpoint_ab`` (dcp, 12 measured saves), the
   serving lines among them with ``serving_decode``'s token_parity and
   ``sampling_ab``'s token_identity true and ``kv_density_ab``'s int8
   and fp8 parity bars held — with the A/B
   bands and int8_step's loss within 2 % of the headline's; the headline
   line has a finite loss within 1.5 of ln(32768) and vs_baseline in
   (0, 1.05]; the ``moe_ab`` line carries the three variants' bands, the
   ratio bands and the routing globals; each of K3/K4/K5 launched layers
   x steps times (warm calls included, the moe_ab chains too); K11 as
   often as the A/B chains and the tuned_ab searches and chains launch
   it and K12 3 x 2 layers x the grouped
   chain's steps; the ``longcontext_ab`` line (before ``moe_ab``) with
   K3 launched K x (1 + rounds) more for its dense leg and K6 3 x as
   often for its splash legs; then at its S=64k operands: K6 under the
   causal mask bitwise equal to K3, and under the window and segment
   masks against ``plain_splash_rows`` on four sampled q tiles;
9a. tiny f32 models under a window and a segment mask (TF32 off) take 2
   SGD steps on the card (K6/K7/K8 f32) and on the CPU: losses within
   1e-5 relative, every parameter within 1e-5 of its leaf's max-abs;
9b. the bench step at full width through ``bench_step.build`` under
   window(1024) and seg(768) beside the unmasked step: losses finite and
   within 1.5 of ln V, K6/K7/K8 launched layers x steps and K3-K5 never
   in a masked run; ms a step in paired rounds; then B=1, S=32768 dense
   causal against window(4096), paired rounds;
10. ``dlnetbench_tpu_torch.entry.entry()`` forward once at S=1024: logits
   [1, 1024, 32768], finite, K3 launched once per layer;
10a. the DP and FSDP proxies at world 1 and full size, in process,
   through ``cli.main(["dp" | "fsdp", ...])`` (NCCL; no Hopper kernel:
   the compute is the burn, a CUDA-graph-replayed matmul chain): the
   H100 stats file llama3_8b_16_bfloat16, bf16 buffers at --size_scale 1
   (DP buckets of 8 030 261 248 elements), --time_scale 0.05, -w 3 -r 5,
   8 buckets / 8 units.  Bars: the record complete with every timer
   (FSDP: also allgather_time, reduce_scatter_time) and sum(bucket_bytes)
   = 2 x model_size; the run's collective counters equal 8 allreduces
   (DP), 15 allgathers and 8 reduce-scatters (FSDP) per full step times
   the steps it called, and one full step of a bundle built again issues
   exactly those; the median compute_time within 10 % of (fwd_us +
   bwd_us) x time_scale; issuing a full step returns to Python within
   10 % of its fenced time; energy_source nvml and a mean power between
   50 W and the card's limit; the medians and the phase's wall time
   printed, and the compute leg's burn timed six times 0.5 s apart
   against its calibration (printed, no bar);
10b. the pipeline hybrids and sequence-parallel proxies the same way,
   each at world 1 and -w 2 -r 3: ``hybrid_2d`` (gpipe, 4 microbatches),
   ``hybrid_3d`` (--tp 1) and ``ring_attention`` / ``ulysses`` (--sp 1,
   full depth) on llama3_8b at full size, ``hybrid_3d_moe`` on
   mixtral_8x7b_16_bfloat16 at --size_scale 0.5 (its 45.1 G-element
   expert shard fits one card only halved) and --time_scale 0.01, with
   the same bars: every program's collectives (the variants' too) per
   step times the steps it ran, the compute leg within 10 % of the
   stats time (at world 1 each burns exactly one step of it), host
   issue and power;
10h. model breadth (run after 10b, before 10c's profiled runs; no new
   kernel): (a) K3/K4/K5 at gpt2_xl's attention (B=4, S=1024, 25 heads
   of 64, MHA, causal) against their plain versions at 5's bars, timed
   beside SDPA and the bound; (b) the gpt2_xl train step at full width
   and depth (``TransformerConfig.from_card``: 48 layers, D 1600, F
   6400, vocab 50257, learned positions, tied head, bf16, B=4, S=1024)
   through ``bench_step.make_train_k``: one warm step, then 3 chained
   steps timed, losses finite and each below the initial loss (at this
   depth the loss falls on the first step and then wanders, in f32
   alike), K3/K4/K5 launched layers x
   steps and the dense route never; ms a step, tokens/s, peak GB; (c)
   the same step's ``remat`` modes ``full`` and ``dots`` against no
   remat on the same weights: the first loss bitwise, every gradient
   leaf within 2^-6 of its max-abs (the bit-equal leaves counted), K3
   launched twice a layer (the block's forward runs again), ``full``'s
   peak below no remat's; each mode's peak GB and ms a step printed; (d)
   ``bench_step.build(k=1, remat=True, remat_scope="mlp")`` against
   ``build(k=1)`` at the headline shape under (c)'s bars; (e) the vit_h
   train step at full width and depth (``ViTConfig.from_card``: 32
   layers, D 1280, 16 heads of 80, F 5120, 224^2 images in 14-pixel
   patches, S 257, 1000 classes, bf16, B=32), SGD as (b): 3 steps timed,
   ``flash_attention.dense_attention_calls`` layers x steps (one a
   forward block) and no flash or splash launch; ms a step, images/s;
   (f) tiny f32 GPT-2 (S 128, head_dim 64: the f32 kernels) and ViT (17
   tokens: the dense route), TF32 off, 2 SGD steps on the card and on
   the CPU from the same weights: losses within 1e-5 relative, every
   parameter within 1e-5 of its leaf's max-abs.  The dense route's
   counter is set to 0 at the start of the script and must still be 0
   when this phase starts and again after the last phase;
10i. the studies (``dlnetbench_tpu_torch/examples/``; no new kernel), each
   through its entry point, after 10h and before every profiled session:
   ``dp_bucket_study --devices 1`` (one NCCL rank in this process, three
   bucket points), ``pod_study --serving`` on a cut plan set through the
   module's constants (load fractions 0.25 and 2.0, one seed, 40
   requests, the straggler point at 0.25; plus the calibration), each
   point a ``cli serve`` process pinned to the gather attention
   (head_dim 16), and ``pod_study --kv_density`` on the card.  Bars: the
   first two exit 0 (their own verdicts hold); each prints its tables,
   verdicts and skipped-PNG notes; the kv-density study's parity,
   capacity (>= 1.8x), lossless and sharing bars hold, and its
   band-disjoint goodput@SLO verdict is printed as measured (on the H100
   its tiny engine is dispatch-bound, and the win is not band-disjoint:
   the study then exits 1, which this phase reports and allows); the
   records are the card's, the serving records' ``attn_impl`` is
   ``gather``; K1/K2 launch 0 times in this process and the dense
   route's counter stays 0; the phase's seconds are printed (budget 90
   s);
10j. the native C++ tier (``dlnetbench_tpu_torch/native/``), after 10i
   and before every profiled session: (a) its card flavour, built by
   ``utils/native_build`` in a thread started right after the kernels'
   build (``nvcc`` for ``csrc/burn.cu``, ``g++`` with the CUDA runtime
   for the binaries); the build's seconds, ``nvcc``'s version, ptxas's
   register and spill lines for ``burn.cu`` (any spill fails) and the
   dlopened NCCL's path and version printed, the version equal to
   ``torch.cuda.nccl.version()``; (b) ``nccl_selftest`` at world 1 (and
   2 on two cards): every collective and p2p op at f32, bf16 and e4m3
   over the world and a split communicator, exact; (c) the burn kernel
   against the port's torch chain (``proxies/burn.Burner.eager``) from
   one seeded state (``nccl_probe``'s check state: positive, rank one,
   its first product of order one) after 1, 2 and 8 iterations, one
   launch each: the max-abs difference within 2^-6 of the chain's own max-abs,
   which must reach 0.5 after 1 iteration (tanh bends it) and stay a
   normal number, at least 1e-30, after 8 (the sup norm of any chain
   falls as m <- tanh(m^2); a state of mixed signs reaches 0), and the
   torch chain without tanh, transposed, scaled by 1/128 or zero, from
   the same state, must miss that bar (each miss printed); (d) a requested 20 ms burn within 5 % by CUDA
   events, after the paired calibration, and short requests (0.7 and
   2.7 us, as pod_study's gpt2_l asks, and 50 us) within 5 % by the
   burn's own clock, printed beside the events; 64 iterations within
   0.33 ms by CUDA events (a third of the one-block kernel's 0.980);
   the burn's start delay beside 32 and 100 SMs held for 1 ms by a
   spinning block each on a second stream (``nccl_probe --hold-sms``):
   with 32 held the burn's cluster must start before the holder ends,
   with 100 its delay is printed; (e) the seven
   proxies through their binaries on ``--backend nccl`` at world 1, at
   10a/10b's models and flags (llama3_8b at full size and --time_scale
   0.05; the MoE at --time_scale 0.01 and --size_scale 0.35, not 10b's
   0.5: its card buffers come to 199.7 GB x size_scale — the dp-sync
   source and sum, 93.4 GB each at size 1, and the non-expert sync,
   all-to-all and activation pairs, 12.9 GB together — which is 99.9 GB
   at 0.5 and 69.9 GB at 0.35, of the card's 80), 1 warm-up and 2 runs:
   each record passes the port's parser with backend nccl, compute_mode
   device_burn, transport local, nccl_impl real and 0 timed copies; its
   runtime median printed beside 10a/10b's (a report, not a bar); the
   burn's launches summed for the kernels line, and its chain share
   (iterations x ns an iteration over the burns' device span; the rest
   is the spin to the time asked) printed; (f) ``congestion_study``
   (nccl, world 1, the congestor on the same card) and ``pod_study
   --tier native --backend nccl --devices 1`` on its dp and fsdp points
   at their default time scales, each exit 0.  In every record of (e)
   and (f) the burns' device span (``burn_device_us``, the burn's clock)
   lies within 5 % of the compute the record asked for
   (``burn_requested_us``).  The phase's seconds are printed (budget 120
   s);
10c. the observability channels through ``cli.main``: ``dp`` (8
   buckets, -w 2 -r 3) with ``--profile --trace-out --telemetry`` and
   ``ulysses`` (--sp 1, full depth) with ``--profile --trace-out``, at
   the 10a/10b flags.  Bars: the record holds ``profile``; the trace
   holds ``kernel`` events on the rank's device track and the host
   phases (build, warmup, timed, fence, profile); every collective kind
   whose calls launch device work at one rank is in ``profile`` once a
   call — Ulysses' 128 all-to-alls a step, each a copy or a SendRecv
   kernel tagged ``alltoall`` (DP's in-place one-rank allreduces launch
   nothing in NCCL, so the DP run requires no kind); DP's telemetry
   block holds warmup + runs samples.  Printed: the trace's event count
   and bytes, the profiled step's wall (its ``profile`` span) beside the
   untraced median.  Then a two-point in-process ``sweep dp``
   (``num_buckets=2,4``, one NCCL group for both): two records tagged
   with the axis;
10d. the record pipeline over the records 7, 10a-10c wrote (the seven
   proxies, the two observability runs, the sweep's two points and the
   three served runs; no run of its own): each passes the port's
   ``validate_record`` and carries ``global.attribution`` whose fractions
   sum to 1 within 1e-3, whose ``bound`` is in the port's vocabulary and
   whose ``inputs.compute_basis`` is ``measured``; at world 1 the
   transport is ``local`` and there is no ``achieved.comm``; DP's
   verdict is ``sm``; the sweep's ``bound_tally`` counts no ``n/a``; the
   port's ``merge_records`` gives a world-1 record back with its rows
   and its verdict.  Then ``bench.main(["--skip-aux", "--check", F])``
   at the bench shape twice: against 9's headline line, rc 0 with a
   ``sentinel`` section; against that line with its ``value`` and
   ``band`` halved, rc 3 with the headline named as regressed.  The
   headline's block is priced on the card's preset (``inputs.hw``) and
   its ``achieved.sm.frac`` is ``tflops_achieved`` over the bf16 peak
   within rounding.  The records make one DataFrame (``records_to_
   dataframe``: every rank x run a row, ``attr_bound`` on each) and a
   bandwidth table, printed.  Each record's verdict and fractions are
   printed, and whether matplotlib can be imported (the plot functions
   are held on the CPU; the card machine has pandas, not matplotlib);
10e. the resilience layer at world 1 (no Hopper kernel on this path),
   ``cli dp`` at llama3_8b's stats, bf16, 8 buckets, --size_scale 0.01
   (a 160.7 MB state), --time_scale 0.005, -w 1 -r 6: (a) a 20 ms delay
   plan from the fourth timed run on: the ``fault_delay_us`` timer
   [0, 0, 0, 20000, 20000, 20000] and the runtime median inflated by
   the delay within 10 %; (b) a crash at step 5 under ``retry``: six
   runs, ``fault_retries`` 1; (c) the crash under ``fail_fast`` in a
   subprocess: a non-zero exit with ``RankFailure``; (d) under
   ``retry`` with ``--checkpoint_dir``, npz and dcp each in stall and
   async: 3 saves (after steps 1, 3 and 7) on disk and in the record;
   then a snapshot of a DP bundle's state on the card, restored after
   two steps and an update of every leaf in place, equal to the state
   at the saved step bit for bit (each backend and mode); (e) a
   ``StepWatchdog`` of 0.2 s around a ~1 s device spin
   (``torch.cuda._sleep``, then a synchronize) fires once and the
   flight recorder writes ``flight_stall.json``;
10g. the SPMD tier (``models/spmd.py``; no new kernel): (a) a tiny f32
   step (embed 256, 4 heads: head_dim 64, S 256, 2 layers, 4 experts)
   on mesh (1, 1, 1), TF32 off, on the card and on the CPU from the same
   weights, in each sp_mode with the einsum and the grouped expert FFN:
   the loss within 1e-5 relative, every updated leaf within 1e-5 of its
   max-abs and its update within 1e-3 of the update's max-abs (plus one
   ulp of the leaf), K3/K4/K5 launched layers x ticks, K12 (f32) 3 x
   layers x ticks under ``grouped``; (b) K3/K4/K5 at one microbatch's
   attention of the bench-shape step (2 x 2048, 16 heads, head_dim
   128, causal) and K12's gate/up and down products at its dispatch
   buffer's shape (bf16, int8, e4m3), each against its plain version
   on seeded inputs; then ``entry.dryrun_multichip(1)`` at the
   bench's SPMD shape (embed 2048, 16/16 heads, ff 8192, 4 layers, S
   2048, vocab 32768, 4 experts, bf16; its MoE parity stages f32 at
   1e-4; the overlap parity and the masked stages need >= 2 and 4
   ranks), the counters set to 0 before and read after: no stage
   skipped by the deadline, 9 steps, the three MoE stages, finite
   losses in each sp_mode, K3/K4/K5 layers x ticks a step, K12 3 x
   layers x ticks a grouped step, no splash launch; then
   ``spmd.build(1)`` at that shape with ``moe_ffn_impl="grouped"`` in
   bf16, int8 and e4m3, 1 + 6 steps each, finite, K3/K4/K5 and K12 as counted, the median ms
   a step printed beside the card; (c) the bench's ``spmd_overlap_ab``
   at world 1 prints the JAX bench's skip note and no line;
10f. ``bench.main(["--skip-aux", "--trace-out", F])``: each of K3/K4/K5
   launched layers x (K x (1 + rounds) + 2K) times (the profiled call
   runs twice, to warm the profiler and recorded), the merged trace
   holding the host spans build, timed and profile and K3/K4/K5 device
   events of the recorded call — after the proxy phases, since a
   profiler session slows the host's later launches;
11. the ``kernels`` JSON line (K1/K2's launches summed over 7, 7a, 7c
   and 7d; K3/K4/K5's over 9, 10f, 10g (b) and 10h (b); K12's per format over 9 or
   8d and 10g (b); the burn kernel's over 10j (e), its time one burn of
   64 iterations, its bound their 2 x 256^3 flop each at the card's
   bf16 tensor-core rate, 989 TFLOP/s on an H100 SXM, the rate of its
   bf16 operands summed in f32), then the ``ok``
   JSON line last.

``nvidia-smi``'s SM clock, power draw and temperature are printed beside
the timed phases (lines starting ``smi``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
SRC = "dlnetbench_tpu_torch/ops/csrc/paged_attention.cu"
FLASH_SRC = "dlnetbench_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {"fwd": "dlnetbench_tpu/ops/flash_attention.py:126",
                  "dq": "dlnetbench_tpu/ops/flash_attention.py:242",
                  "dkv": "dlnetbench_tpu/ops/flash_attention.py:279"}
SPLASH_REPLACES = {"fwd": "dlnetbench_tpu/ops/flash_attention.py:648",
                   "dq": "dlnetbench_tpu/ops/flash_attention.py:761",
                   "dkv": "dlnetbench_tpu/ops/flash_attention.py:802"}

# decode shapes of the served model (llama3_8b width)
B, HQ, HKV, DH, PAGE, PMAX, NUM_PAGES = 8, 32, 8, 128, 16, 32, 512
LENGTHS = [1, 37, 100, 173, 260, 333, 421, 512]
TOL = 2e-2
SERVE_PLAN = {"kind": "poisson", "rate_rps": 1000, "num_requests": 16,
              "seed": 1, "prompt_len": [128, 384], "output_len": [32, 96]}
MODEL_FLAGS = ["--embed", "4096", "--heads", "32", "--kv_heads", "8",
               "--ff", "14336", "--layers", "4", "--vocab", "32768",
               "--dtype", "bfloat16"]
ENGINE_FLAGS = ["--slots", "8", "--page_size", "16", "--num_pages", "512",
                "--max_seq_len", "512", "--prefill_chunk", "64"]

# the train step's attention shapes (b, s, hq, hkv, dh, causal) first,
# then a non-causal and a Dh=64 case
FLASH_CASES = [(2, 6144, 32, 8, 128, True), (1, 1024, 32, 8, 128, False),
               (1, 1024, 16, 4, 64, True)]
# O, dq, dk, dv: each row (the Dh values of one batch, position and head)
# against 2^-6 of that row's own max-abs (floored at 1e-3 of the
# tensor's); lse and D: absolute
FLASH_TOL_ROW, FLASH_TOL_LSE = 2.0 ** -6, 1e-3

# K6/K7/K8 at the train step's attention shape, under five masks: (label,
# MaskSpec fields); the first is the row of the kernels line, the
# segment mask carries the planted faults
SPLASH_SHAPE = (2, 6144, 32, 8, 128)
SPLASH_SPECS = [("window(1024)", {"window": 1024}),
                ("seg(768)", {"seg_avg": 768}),
                ("window(1024)&seg(768)", {"window": 1024, "seg_avg": 768}),
                ("non-causal seg(768)", {"causal": False, "seg_avg": 768}),
                ("causal", {})]
# the f32 (CUDA-core) K6/K7/K8 at a small shape under the JAX tests'
# MASK_SPECS and plain causal: every row within 4e-3 of its max-abs (f32
# both sides, but a dq row that cancels to ~0 keeps the f32 rounding of
# its terms against its 1e-3 floor)
SPLASH_F32_SHAPE = (2, 384, 4, 2, 128)
SPLASH_F32_SPECS = [{"window": 40}, {"seg_avg": 50, "seg_seed": 3},
                    {"causal": False, "seg_avg": 64, "seg_seed": 1},
                    {"window": 32, "seg_avg": 80, "seg_seed": 5}, {}]
SPLASH_F32_TOL_ROW = 4e-3
# the masked train steps: the bench step's knobs, and a long-context
# pair at B=1, S=32768, dense causal vs the Mistral 7B window
MASKED_STEPS = {"window(1024)": {"attention_window": 1024},
                "seg(768)": {"attention_seg_avg": 768}}
LONG_SEQ_STEP, LONG_WINDOW = 32768, 4096
# the tiny f32 masked model, card vs CPU (f32 both sides; summation
# order): losses 1e-5 relative, each parameter 1e-5 of its leaf's max-abs
MASK_REF_TOL = 1e-5

# K3/K4/K5 and their splash mode K6/K7/K8: warp-specialised wgmma/TMA
# kernels; K1/K2: one kernel split over each slot's sequence
FLASH_DESIGN = "wgmma + TMA, warp-specialised"
PAGED_DESIGN = "split over the sequence, last-arriving block combines"

MLP_SRC = "dlnetbench_tpu_torch/ops/csrc/mlp_matmul.cu"
# K9, K10, K11 and K12 (bf16, int8, e4m3): one warp-specialised wgmma/TMA
# kernel
WG_DESIGN = "wgmma + TMA, warp-specialised, persistent"
# the card-only pytest cases, in files that import no jax (59 of them
# moved there from the jax-importing test files, 46 added with the split
# K1/K2 and the wgmma K3/K6, 11 with the proxies, 13 with the pipeline
# and sequence-parallel proxies, 4 with the observability channels, 26
# with the tuner's knobs, 10 with serving at scale on one card; its 10
# two-card cases skip on one; 14 with model breadth; 1 with the studies,
# whose 3 two-card cases skip on one; 6 with the native tier, whose
# two-card case skips on one; 3 with the cluster burn: its check after 2
# iterations and its start delay beside 32 and 100 held SMs); all must
# pass
CARD_TESTS = "tests/test_torch_card_*.py"
CARD_TESTS_MIN = 325
MLP_REPLACES = {"k11": "dlnetbench_tpu/ops/quantized_matmul.py:112",
                "k9": "dlnetbench_tpu/ops/mlp_backward.py:50",
                "k10": "dlnetbench_tpu/ops/mlp_backward.py:103"}
# the train step's MLP: T = B * S tokens, hidden D, ff F
MLP_T, MLP_D, MLP_F = 12288, 4096, 14336
# K11 e4m3 (bf16 output): each row within 2^-6 of its max-abs and a
# relative Frobenius error <= 1e-2 (the JAX bar); int8 is bit-exact
E4M3_TOL_ROW, E4M3_TOL_FRO = 2.0 ** -6, 1e-2
# K9 dg/du (bf16 outputs, one ulp apart at most): 2^-6 of the row's
# max-abs; K10 dWd (f32 output; summation order differs, and the kernel's
# approximate sigmoid can move an element of the recomputed h by one bf16
# rounding): 1e-3 of the row's max-abs
DGDU_TOL_ROW, DWD_TOL_ROW = 2.0 ** -6, 1e-3
# mlp_backward="pallas" vs the autograd backward, each gradient leaf
# within this share of its max-abs: the default path rounds dh and the
# f32 silu-gradient terms to bf16 where K9 keeps dh in f32 registers
PALLAS_TOL_LEAF = 2e-2

GMM_REPLACES = "dlnetbench_tpu/ops/grouped_matmul.py:82"
# K12 at the bench's moe_ab shape (E=8 experts, C=1280 slots = int(1.25 x
# 4096 tokens x top-2 / 8), d 4096, f_e 7168) and at mixtral_8x7b width
# (f 14336): (label, K, N) of x [E, C, K] @ w [E, K, N]
GMM_E, GMM_C = 8, 1280
GMM_CASES = [("moe_ab gate/up", 4096, 7168), ("moe_ab down", 7168, 4096),
             ("mixtral gate/up", 4096, 14336)]
# skewed per-expert counts: a full expert, an empty one, ragged tails
GMM_SKEW = [1280, 1000, 0, 17, 640, 1280, 129, 1]
# bf16 and e4m3 (bf16 outputs): every row within 2^-6 of its max-abs;
# e4m3 also a relative Frobenius error <= 1e-2; int8 bit-exact
GMM_TOL_ROW = 2.0 ** -6
# the tiny f32 MoE model, card vs CPU: losses 1e-5 relative, each
# parameter within 1e-5 of its leaf's max-abs (f32 on both sides)
MOE_REF_TOL = 1e-5
# mixtral width, grouped vs sparse on the same weights: first loss
MIXTRAL_TOL_LOSS = 1e-3
# the quantized grouped expert layer against the bf16 one (relative
# Frobenius): a sanity bar over the recipes' own quantization error
# (5.0 % int8, 6.5 % e4m3 at a reduced shape on the CPU); K12's own
# int8 / e4m3 results are held to its plain version in the K12 phase
MOE_QUANT_TOL = 0.1


def abs_err(a, r) -> float:
    return float((a.float() - r.float()).abs().max())


def row_err(a, r) -> float:
    """Worst row's max abs error over the plain row's max-abs, the latter
    floored at 1e-3 of the tensor's: a row that cancels to ~0 (dq of
    query 0 under the causal mask: O = v_0, so dp - D = 0) keeps f32
    rounding of its terms."""
    err = (a.float() - r.float()).abs().amax(dim=-1)
    scale = r.float().abs().amax(dim=-1)
    return float((err / scale.clamp_min(1e-3 * scale.max())).max())


def fro_err(a, r) -> float:
    """Relative Frobenius error ||a - r|| / ||r||."""
    d = (a.float() - r.float()).norm()
    return float(d / r.float().norm().clamp_min(1e-30))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: rc {smi.returncode} {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def idle_draw_w() -> float:
    """The card's power draw at rest (nvidia-smi): the least of five
    readings 0.2 s apart, the card idle since the last fence."""
    import torch
    torch.cuda.synchronize()
    reads = []
    for _ in range(5):
        time.sleep(0.2)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        try:
            reads.append(float(smi.stdout.strip().splitlines()[0]))
        except (ValueError, IndexError):
            fail(f"nvidia-smi power.draw: {smi.stdout!r} {smi.stderr!r}")
    return min(reads)


def smi_sample(label: str) -> None:
    """The card's SM clock, power draw and temperature beside a timed
    phase (nvidia-smi; read-only)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    say(f"smi {label}: {smi.stdout.strip() or smi.stderr.strip()}")


def timed_ms(torch, fn, reps: int = 30) -> float:
    """Median device time of one call, L2 flushed (a 256 MiB write)
    before each, timed with CUDA events around the call alone.  A spin
    of ~2 ms on the card sits before the first event, so the call's host
    side (Python, argument checks, launch) is queued behind it and the
    events see the device time only."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def decode_operands(torch, page_dtype: str):
    """Seeded operands at the served model's decode shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = "cuda"
    q = (torch.randn(B, HQ, DH, generator=gen, device=dev)
         * DH ** -0.5).to(torch.bfloat16)
    perm = torch.randperm(NUM_PAGES, generator=gen, device=dev)
    bt = perm[:B * PMAX].reshape(B, PMAX).to(torch.int32).contiguous()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    pools = [torch.randn(HKV, NUM_PAGES, PAGE, DH, generator=gen,
                         device=dev) for _ in range(2)]
    if page_dtype == "bf16":
        return q, [p.to(torch.bfloat16) for p in pools], None, lengths, bt
    from dlnetbench_tpu_torch.ops.quantized_matmul import (cast_q,
                                                           scale_from_amax)
    fmt = {"int8": "int8", "fp8": "float8"}[page_dtype]
    qp, sc = [], []
    for p in pools:
        s = scale_from_amax(p.abs().amax(dim=(2, 3)), fmt)
        qp.append(cast_q(p / s[:, :, None, None], fmt).contiguous())
        sc.append(s.contiguous())
    return q, qp, sc, lengths, bt


def bound(page_dtype: str, elt: int, peak: dict) -> tuple[float, str]:
    """Least time for the call: each valid token's K and V row read once
    (plus the touched pages' scales and block-table entries), q read and
    out written once; operations 4*Hq*Dh per token (QK^T and PV)."""
    pages = sum(math.ceil(n / PAGE) for n in LENGTHS)
    nbytes = (sum(LENGTHS) * HKV * DH * 2 * elt + 2 * B * HQ * DH * 2
              + pages * 4 + B * 4)
    if page_dtype != "bf16":
        nbytes += pages * HKV * 2 * 4
    ops = 4 * HQ * DH * sum(LENGTHS)
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = ops / peak[page_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                        "operations")


def kernel_phase(torch, page_dtype: str, peak: dict) -> dict:
    import torch.nn.functional as F

    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
    q, (kp, vp), sc, lengths, bt = decode_operands(torch, page_dtype)
    if page_dtype == "bf16":
        def kernel():
            return PA.paged_attention(q, kp, vp, lengths, bt)

        def plain():
            return PA.gather_attention(q, kp, vp, lengths, bt)
        k_deq = PA.take_pages(kp, bt.long()).movedim(0, 1)
        v_deq = PA.take_pages(vp, bt.long()).movedim(0, 1)
    else:
        fmt = {"int8": "int8", "fp8": "float8"}[page_dtype]

        def kernel():
            return PAQ.quant_paged_attention(q, kp, vp, sc[0], sc[1],
                                             lengths, bt, fmt=fmt)

        def plain():
            return PAQ.dequant_gather_attention(q, kp, vp, sc[0], sc[1],
                                                lengths, bt)
        idx = bt.long()
        k_deq = (PA.take_pages(kp, idx).float()
                 * sc[0][:, idx][..., None, None]).movedim(0, 1)
        v_deq = (PA.take_pages(vp, idx).float()
                 * sc[1][:, idx][..., None, None]).movedim(0, 1)
    got = kernel()
    torch.cuda.synchronize()
    ref = plain()
    err = float((got.float() - ref.float()).abs().max())
    if not torch.isfinite(got).all():
        fail(f"{page_dtype}: kernel output not finite")
    if not torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL):
        fail(f"{page_dtype}: kernel vs plain max abs err {err} > {TOL}")
    # the yardstick: SDPA over K/V gathered (and dequantized) beforehand
    t = PMAX * PAGE
    kl = k_deq.reshape(B, HKV, t, DH).to(torch.bfloat16).contiguous()
    vl = v_deq.reshape(B, HKV, t, DH).to(torch.bfloat16).contiguous()
    mask = (torch.arange(t, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(q4, kl, vl, attn_mask=mask,
                                              scale=1.0, enable_gqa=True)
    lib_err = float((library()[:, :, 0].float() - ref.float()).abs().max())
    ms = timed_ms(torch, kernel)
    plain_ms = timed_ms(torch, plain, reps=10)
    library_ms = timed_ms(torch, library)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        kernel()
    torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) / 50 * 1e6
    bound_ms, bound_by = bound(page_dtype, kp.element_size(), peak)
    say(f"kernel {page_dtype}: max_abs_err {err:.3e} (tol {TOL}), "
        f"sdpa err {lib_err:.3e}; kernel_ms {ms:.4f} plain_ms "
        f"{plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
        f"{bound_ms:.4f} ({bound_by}) -> {bound_ms / ms:.3f} of bound; "
        f"back-to-back calls {call_us:.1f} us each (host wrapper "
        f"included)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def reference_phase(torch) -> None:
    """Tiny f32 model, same weights, on the card and on the CPU: the
    greedy token streams must be equal (K1/K2 on the card, their plain
    versions on the CPU)."""
    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.serving import scheduler as S
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mc = TransformerConfig(vocab_size=256, embed_dim=256, num_heads=4,
                           num_kv_heads=2, ff_dim=512, num_layers=2,
                           seq_len=64, dtype="float32")
    plan = ArrivalPlan.from_dict({"kind": "poisson", "rate_rps": 500.0,
                                  "num_requests": 6, "seed": 3,
                                  "prompt_len": [5, 20],
                                  "output_len": [4, 12]})
    cpu_params = init_params(mc, seed=5, device="cpu")
    gpu_params = {k: ({n: w.cuda() for n, w in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    for cd in ("bf16", "int8", "fp8"):
        cfg = S.ServingConfig(slots=4, page_size=16, num_pages=32,
                              max_seq_len=64, prefill_chunk=8,
                              cache_dtype=cd, warmup_requests=0)
        streams = {}
        for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
            eng = S.Engine(mc, cfg, params=params, device=dev)
            eng.run(plan.sample())
            streams[dev] = eng.token_streams
        if streams["cuda"] != streams["cpu"]:
            fail(f"reference {cd}: card streams {streams['cuda']} != CPU "
                 f"plain streams {streams['cpu']}")
        say(f"reference {cd}: {len(streams['cuda'])} greedy streams equal "
            f"on the card and on the CPU")


def serve_run(torch, label: str, flags: list[str],
              plan: dict = SERVE_PLAN) -> dict:
    """One ``cli serve`` run at the served model's width (MODEL_FLAGS,
    ENGINE_FLAGS, ``plan``) plus ``flags``, its record written to
    ``OUT/serve_<label>.jsonl``: every request completes with every
    token in the vocab.  The launch, step, prefill-chunk and MoE
    host-read counters are set to 0 just before the run (its warm-up
    requests included) and read just after; a MoE engine also keeps,
    per decode dispatch, its load's sum and the tokens emitted before
    it (``moe_dispatches``)."""
    from dlnetbench_tpu_torch import cli
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
    from dlnetbench_tpu_torch.serving import disagg as DG
    from dlnetbench_tpu_torch.serving import fleet as FL
    from dlnetbench_tpu_torch.serving import moe_decode as MD
    from dlnetbench_tpu_torch.serving import scheduler as S
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    engines, servers = [], []
    engine_cls = S.Engine
    chunks = [0]
    inits = {cls: cls.__init__ for cls in (DG.DisaggServer,
                                           FL.FleetServer)}

    def captured(cls):
        def init(self, *a, **kw):
            inits[cls](self, *a, **kw)
            servers.append(self)
        return init

    class RecordedEngine(engine_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

        def _reset_state(self):
            super()._reset_state()
            self.moe_dispatches = []

        def _prefill_one(self, slot, st):
            chunks[0] += 1
            return super()._prefill_one(slot, st)

        def _record_moe(self, load, rounds):
            self.moe_dispatches.append((int(load.sum()),
                                        self._tokens_emitted))
            super()._record_moe(load, rounds)

    out = OUT / f"serve_{label}.jsonl"
    out.unlink(missing_ok=True)
    S.Engine = RecordedEngine
    for cls in inits:
        cls.__init__ = captured(cls)
    try:
        PA.launches = PAQ.launches = 0
        S.decode_dispatches = S.decode_device_steps = 0
        MD.host_reads = 0
        t0 = time.perf_counter()
        rc = cli.main(["serve", "--arrival", json.dumps(plan),
                       *MODEL_FLAGS, *ENGINE_FLAGS, *flags, "--out",
                       str(out)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"k1": PA.launches, "k2": PAQ.launches,
                  "dispatches": S.decode_dispatches,
                  "steps": S.decode_device_steps,
                  "prefill_chunks": chunks[0],
                  "moe_host_reads": MD.host_reads}
    finally:
        S.Engine = engine_cls
        for cls, init in inits.items():
            cls.__init__ = init
    if rc != 0:
        fail(f"serve {label}: cli rc {rc}")
    rec = json.loads(out.read_text().splitlines()[-1])
    srv = rec["global"]["serving"]
    if srv["completed"] != plan["num_requests"]:
        fail(f"serve {label}: {srv['completed']} of "
             f"{plan['num_requests']} requests completed")
    # the streams of the run's server (a disaggregated pair or a fleet)
    # or of its last engine (after a crash-shrink rebuild: the requests
    # it redid); each stream is whole and in the vocab
    eng = engines[-1] if engines else None
    holder = servers[-1] if servers else eng
    streams = dict(holder.token_streams)
    want = {r.rid: r.output_len
            for r in ArrivalPlan.from_dict(plan).sample()}
    for rid, toks in streams.items():
        if len(toks) != want[rid] or not all(0 <= t < 32768
                                             for t in toks):
            fail(f"serve {label}: request {rid} tokens {toks[:8]}... "
                 f"(len {len(toks)}, want {want[rid]} in vocab)")
    out = {"serving": srv, "streams": streams,
           "counts": counts, "wall": wall, "record": rec,
           "moe_dispatches": getattr(eng, "moe_dispatches", []),
           "tokens_emitted": getattr(eng, "_tokens_emitted", 0)}
    # the engine, its class and ``engines`` form a cycle: break it, or
    # its weights (11 GB for the MoE runs) stay on the card until a GC
    engines.clear()
    servers.clear()
    return out


def serve_phase(torch, cache_dtype: str) -> dict:
    """The classic engine through ``cli serve``: the kernel's launch
    counter rose by layers x decode steps."""
    res = serve_run(torch, cache_dtype, ["--cache_dtype", cache_dtype])
    srv, counts = res["serving"], res["counts"]
    layers = int(MODEL_FLAGS[MODEL_FLAGS.index("--layers") + 1])
    mine, other = (("k1", "k2") if cache_dtype == "bf16"
                   else ("k2", "k1"))
    if counts[mine] != layers * counts["steps"] or counts[mine] == 0 \
            or counts[other] != 0 or counts["steps"] != counts["dispatches"]:
        fail(f"serve {cache_dtype}: launches {counts} != {layers} layers "
             f"x {counts['steps']} decode steps on {mine}")
    say(f"serve {cache_dtype}: {srv['completed']} requests, "
        f"{counts[mine]} {mine} launches = {layers} x {counts['steps']} "
        f"decode steps (warm-up run included); ttft p50 "
        f"{srv['ttft_ms']['p50']} p99 {srv['ttft_ms']['p99']} ms, tpot "
        f"p50 {srv['tpot_ms']['p50']} ms, {srv['tokens_per_s']} tokens/s, "
        f"wall {srv['wall_s']} s (cli {res['wall']:.1f} s); decode_loop "
        f"{json.dumps(srv['decode_loop'])}")
    return {"launches": counts[mine], **res}


# the decode-loop phase's paths (served model, SERVE_PLAN): fused N,
# speculative, sampled
LOOP_N = ["--multi_step_n", "16"]
SPEC = [*LOOP_N, "--speculative", "--spec_k", "4"]
TRUNCATED = ["--drafter", "truncated", "--drafter_layers", "1"]
SAMPLED = ["--temperature", "0.8", "--top_p", "0.95", "--sample_seed", "7"]


def agreement(streams: dict, ref: dict) -> tuple[int, int]:
    """(tokens equal position by position, tokens) over the requests."""
    same = sum(a == b for rid in ref
               for a, b in zip(streams[rid], ref[rid]))
    return same, sum(len(t) for t in ref.values())


def decode_loop_phase(torch, served: dict) -> dict:
    """The fused decode loop, speculative decode and seeded sampling
    through ``cli serve`` at the served model's width (the bars are in
    the module docstring, 7a).  Returns the K1 and K2 launches of its
    runs, per cache dtype."""
    from dlnetbench_tpu_torch.serving import sampling as SMP
    t_phase = time.perf_counter()
    layers = int(MODEL_FLAGS[MODEL_FLAGS.index("--layers") + 1])
    k = int(SPEC[SPEC.index("--spec_k") + 1])
    launches = {"bf16": 0, "int8": 0, "fp8": 0}
    rows = []

    def run(label, flags, *, k1_per_step=0, k2_per_step=0, fused=True,
            dtype="bf16", ref=None):
        res = serve_run(torch, label, flags)
        c, dl = res["counts"], res["serving"]["decode_loop"]
        want = (k1_per_step * c["steps"], k2_per_step * c["steps"])
        if (c["k1"], c["k2"]) != want or c["steps"] == 0:
            fail(f"decode loop {label}: launches K1 {c['k1']} / K2 "
                 f"{c['k2']} != {want[0]} / {want[1]} over "
                 f"{c['steps']} device steps")
        if fused and not (dl["steps_per_dispatch"] > 1
                          and dl["tokens_per_sync"] > 1):
            fail(f"decode loop {label}: decode_loop {dl} does not fuse")
        launches[dtype] += c["k1"] + c["k2"]
        rows.append((label, res, ref or served[dtype]))
        return res

    for dt in ("bf16", "int8", "fp8"):
        per_step = (layers, 0) if dt == "bf16" else (0, layers)
        res = run(f"loop16_{dt}", ["--cache_dtype", dt, *LOOP_N],
                  k1_per_step=per_step[0], k2_per_step=per_step[1],
                  dtype=dt)
        if res["streams"] != served[dt]["streams"]:
            same, n = agreement(res["streams"], served[dt]["streams"])
            fail(f"decode loop {dt}: N=16 streams != N=1 streams ({same} "
                 f"of {n} tokens agree)")
    say("decode loop: N=16 streams equal N=1 exactly on bf16 (K1), int8 "
        "and fp8 (K2)")
    gather_one = run("gather_n1", ["--attn_impl", "gather"], fused=False)

    def rounds(res) -> str:
        dl = res["serving"]["decode_loop"]
        idle = dl["spec"]["rounds_idle"]
        issued = dl["device_steps"] + idle
        return (f"{issued} rounds issued, {idle} idle "
                f"({idle / issued:.4f})")

    # K1 a round: the truncated drafter's 1 layer x k drafts; the verify
    # pass is gather math
    for drafter, extra, per_round in (("ngram", [], 0),
                                      ("truncated", TRUNCATED, k)):
        flags = [*SPEC, "--drafter", drafter, *extra]
        gres = run(f"spec_{drafter}_gather", [*flags, "--attn_impl",
                                              "gather"], ref=gather_one)
        g_same, g_n = agreement(gres["streams"], gather_one["streams"])
        res = run(f"spec_{drafter}", flags, k1_per_step=per_round)
        same, n = agreement(res["streams"], served["bf16"]["streams"])
        spec = res["serving"]["decode_loop"]["spec"]
        say(f"decode loop spec {drafter}: every stream complete; tokens "
            f"agreeing with N=1 position by position: under gather "
            f"{g_same} of {g_n}, under auto {same} of {n}; acceptance "
            f"{spec['acceptance_rate']} ({spec['accepted']} of "
            f"{spec['drafted']}); {rounds(res)} (gather: "
            f"{rounds(gres)})")
    one = run("sampled_n1", SAMPLED, k1_per_step=layers, fused=False)
    res = run("sampled_n16", [*SAMPLED, *LOOP_N], k1_per_step=layers,
              ref=one)
    if res["streams"] != one["streams"]:
        same, n = agreement(res["streams"], one["streams"])
        fail(f"decode loop sampled: N=16 != N=1 ({same} of {n} agree)")
    res = run("sampled_spec", [*SAMPLED, *SPEC, *TRUNCATED],
              k1_per_step=k, ref=one)
    firsts = sum(res["streams"][r][0] == one["streams"][r][0]
                 for r in one["streams"])
    if firsts != len(one["streams"]):
        fail(f"decode loop sampled spec: first draws agree for {firsts} "
             f"of {len(one['streams'])} requests")
    same, n = agreement(res["streams"], one["streams"])
    say(f"decode loop sampled: N=16 equals N=1 exactly; speculative "
        f"sampling's first draws all equal N=1's, {same} of {n} tokens "
        f"agree position by position (rejection sampling draws other "
        f"lanes: equal in distribution, not token by token); "
        f"{rounds(res)}")
    res = run("grammar", ["--temperature", "0.8", "--sample_seed", "7",
                          "--grammar", "json", *LOOP_N],
              k1_per_step=layers, ref=one)
    grammar = SMP.compile_grammar("json", 32768)
    bad = [r for r, t in res["streams"].items()
           if not SMP.validate_stream(grammar, t)]
    if bad:
        fail(f"decode loop grammar: streams of {bad} fail validate_stream")
    say(f"decode loop grammar: {len(res['streams'])} streams validate")
    for label, res, ref in rows:
        srv, ref = res["serving"], ref["serving"]
        say(f"decode loop {label}: ttft p50 {srv['ttft_ms']['p50']} ms "
            f"(N=1 {ref['ttft_ms']['p50']}), tpot p50 "
            f"{srv['tpot_ms']['p50']} ms (N=1 {ref['tpot_ms']['p50']}), "
            f"{srv['tokens_per_s']} tokens/s (N=1 {ref['tokens_per_s']}), "
            f"wall {srv['wall_s']} s; decode_loop "
            f"{json.dumps(srv['decode_loop'])}")
    say(f"decode loop: {len(rows)} served runs in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def served_model():
    """The served model (MODEL_FLAGS) as a TransformerConfig."""
    from dlnetbench_tpu_torch.models.transformer import TransformerConfig

    def flag(name):
        return MODEL_FLAGS[MODEL_FLAGS.index(name) + 1]
    return TransformerConfig(
        vocab_size=int(flag("--vocab")), embed_dim=int(flag("--embed")),
        num_heads=int(flag("--heads")), num_kv_heads=int(flag("--kv_heads")),
        ff_dim=int(flag("--ff")), num_layers=int(flag("--layers")),
        seq_len=512, dtype=flag("--dtype"))


# the verify pass against iterated 1-step calls: its f32 logits within
# VERIFY_TOL of the steps' max-abs logit (bf16 activations rounded at
# slots x (spec_k + 1) rows against slots rows; 7.6e-3 read on an H100)
VERIFY_TOL = 0.02


def verify_pass_phase(torch) -> dict:
    """The speculative verify pass at the served width (module
    docstring, 7b).  Returns the pass's and the steps' times in ms."""
    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.serving import decode as D
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    from dlnetbench_tpu_torch.serving import speculative as SP
    mc = served_model()
    slots, k1, page, pages = 8, int(SPEC[SPEC.index("--spec_k") + 1]) + 1, \
        16, 512
    pmax = 512 // page
    cc = KV.CacheConfig(num_layers=mc.num_layers,
                        num_kv_heads=mc.num_kv_heads,
                        head_dim=mc.head_dim, num_pages=pages,
                        page_size=page, max_seqs=slots,
                        max_pages_per_seq=pmax, dtype=mc.dtype)
    params = init_params(mc, seed=11, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    k_pages, v_pages = KV.device_buffers(cc, "cuda")
    k_pages.normal_(generator=gen)
    v_pages.normal_(generator=gen)
    bt = torch.randperm(pages, generator=gen, device="cuda")[
        :slots * pmax].reshape(slots, pmax).to(torch.int32)
    pos = torch.tensor([17, 63, 100, 200, 255, 300, 400, 490],
                       dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, mc.vocab_size, (slots, k1), generator=gen,
                           device="cuda", dtype=torch.int32)
    ok = torch.ones((slots, k1), dtype=torch.bool, device="cuda")

    def one_pass():
        kp, vp = k_pages.clone(), v_pages.clone()
        return SP._verify_tokens(mc, cc, params, kp, vp, tokens, pos, ok,
                                 bt, return_logits=True)

    def steps(impl, n=k1):
        pools, logits = (k_pages.clone(), v_pages.clone()), []
        for j in range(n):
            pools, _, lg = D._step_tokens(mc, cc, params, pools,
                                          tokens[:, j], pos + j, ok[:, j],
                                          bt, attn_impl=impl,
                                          return_logits=True)
            logits.append(lg)
        return (*pools, torch.stack(logits, dim=1))

    before = PA.launches
    kp, vp, out, logits = one_pass()
    torch.cuda.synchronize()
    if PA.launches != before:
        fail(f"verify pass: {PA.launches - before} K1 launches, want 0")
    for impl in ("gather", "auto"):
        ks, vs, ref = steps(impl)
        err = float((logits - ref).abs().max())
        scale = float(ref.abs().max())
        top2 = ref.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        clear = margin > 2 * VERIFY_TOL * scale
        flips = out != ref.argmax(dim=-1)
        kv_err = max(float((a.float() - b.float()).abs().max())
                     for a, b in ((kp, ks), (vp, vs)))
        if err > VERIFY_TOL * scale or bool((flips & clear).any()):
            fail(f"verify pass vs {k1} steps ({impl}): logits max err "
                 f"{err:.4g} against max-abs {scale:.4g} (bar "
                 f"{VERIFY_TOL}), {int((flips & clear).sum())} token "
                 f"flips past the margin")
        say(f"verify pass vs {k1} 1-step calls ({impl}): logits max err "
            f"{err:.4g} of max-abs {scale:.4g} ({err / scale:.3e}, bar "
            f"{VERIFY_TOL}); {int(flips.sum())} of {flips.numel()} greedy "
            f"tokens differ, none where the top-2 margin exceeds "
            f"{2 * VERIFY_TOL * scale:.4g} (smallest margin "
            f"{float(margin.min()):.4g}); written k/v max err {kv_err:.4g}")
    times = {"verify_pass": timed_ms(torch, one_pass, reps=10),
             "step": timed_ms(torch, lambda: steps("auto", 1), reps=10),
             "steps": timed_ms(torch, lambda: steps("auto"), reps=10)}
    say(f"verify pass at {slots} x {k1} rows: {times['verify_pass']:.3f} ms "
        f"against one 1-step call {times['step']:.3f} ms and {k1} of them "
        f"{times['steps']:.3f} ms (K1; CUDA events around each eager call, "
        f"its pool copies included)")
    return times


# the serving-breadth phase (module docstring, 7c): prefix-heavy traffic
# over the served model (7 shared full pages of 16 and a copy-on-write
# page of 8 rows), and a MoE model at mixtral_8x7b's width (the served
# model's attention and FF width, 8 experts, top-2, capacity factor 1.0:
# C = 2 expert slots a round at 8 slots)
PREFIX_SERVE_PLAN = {**SERVE_PLAN, "shared_prefix_len": 120,
                     "prefix_pool": 2}
SHARING = ["--prefix_sharing"]
MOE_FLAGS = ["--num_experts", "8", "--top_k", "2",
             "--moe_capacity_factor", "1.0"]
MOE_SKEW = 8.0
# the JAX package's locked live-metrics line (tests/test_bench_aux.py)
LIVE_KEYS = {"run", "t_s", "window_s", "completed", "ttft_ms", "tpot_ms",
             "queue_depth", "active_slots", "kv_occupancy", "engine_steps"}
# the tiny f32 MoE decode step, card against CPU: written pools within
# this share of their max-abs (TF32 off; summation order)
MOE_STEP_TOL = 1e-5


def flip_margins(torch, plan: dict, ref: dict, got: dict) -> list[str]:
    """For each request whose stream parts from ``ref``: the first
    differing position, both tokens, and the top-2 margin of the served
    model's logits there (a full causal forward over prompt + the
    reference's tokens so far, padded to 128 positions; the served
    weights are ``init_params(seed=0)``, as ``cli serve`` makes them)."""
    from dlnetbench_tpu_torch.models.transformer import (forward,
                                                         init_params)
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    from dlnetbench_tpu_torch.serving.decode import prompt_tokens_for
    mc = served_model()
    params = init_params(mc, seed=0, device="cuda")
    reqs = {r.rid: r for r in ArrivalPlan.from_dict(plan).sample()}
    out = []
    for rid, toks in sorted(ref.items()):
        j = next((i for i, (a, b) in enumerate(zip(toks, got[rid]))
                  if a != b), None)
        if j is None:
            continue
        seq = [*prompt_tokens_for(reqs[rid], mc.vocab_size), *toks[:j]]
        pad = -len(seq) % 128
        x = torch.tensor([seq + [0] * pad], device="cuda")
        with torch.no_grad():
            logits = forward(params, x, mc)[0, len(seq) - 1].float()
        top2 = logits.topk(2).values
        out.append(f"request {rid} token {j}: {toks[j]} -> {got[rid][j]}, "
                   f"top-2 margin {float(top2[0] - top2[1]):.4g}")
    del params
    return out


def moe_reference_step(torch, device="cuda") -> None:
    """A tiny f32 MoE decode step (4 experts, top-2, skewed, one slot
    masked) on the card and on the CPU from the same weights and pools:
    load and rounds equal, the written pools within MOE_STEP_TOL of
    their max-abs, the greedy tokens equal."""
    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.serving import decode as D
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    from dlnetbench_tpu_torch.serving.moe_decode import skew_bias
    torch.backends.cuda.matmul.allow_tf32 = False
    mc = TransformerConfig(vocab_size=256, embed_dim=256, num_heads=4,
                           num_kv_heads=2, ff_dim=512, num_layers=2,
                           seq_len=64, dtype="float32", num_experts=4,
                           top_k=2, moe_capacity_factor=1.0)
    cc = KV.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=64,
                        num_pages=32, page_size=16, max_seqs=4,
                        max_pages_per_seq=4)
    gen = torch.Generator().manual_seed(9)
    k, v = (torch.randn((2, 2, 32, 16, 64), generator=gen)
            for _ in range(2))
    tokens = torch.randint(0, 256, (4,), generator=gen, dtype=torch.int32)
    pos = torch.tensor([3, 17, 40, 63], dtype=torch.int32)
    bt = torch.randperm(32, generator=gen)[:16].reshape(4, 4).to(
        torch.int32)
    active = torch.tensor([True, True, False, True])
    cpu_params = init_params(mc, seed=4, device="cpu")
    res = []
    for dev in ("cpu", device):
        params = {n: ({m: w.to(dev) for m, w in t.items()}
                      if isinstance(t, dict) else t.to(dev))
                  for n, t in cpu_params.items()}
        step = D.make_decode_step(mc, cc, moe_bias=skew_bias(4, 2.0, 3,
                                                              dev))
        kp, vp, nxt, load, rounds = step(
            params, k.clone().to(dev), v.clone().to(dev), tokens.to(dev),
            pos.to(dev), bt.to(dev), active.to(dev))
        res.append((kp.cpu(), vp.cpu(), nxt.cpu(), load.cpu(), rounds))
    (kc, vc, tc, lc, rc), (kg, vg, tg, lg, rg) = res
    err = max(float((a - b).abs().max()) / float(a.abs().max())
              for a, b in ((kc, kg), (vc, vg)))
    if not torch.equal(lc, lg) or rc != rg or err > MOE_STEP_TOL \
            or not torch.equal(tc[active], tg[active]):
        fail(f"MoE reference step: load {lg.tolist()} / {lc.tolist()}, "
             f"rounds {rg} / {rc}, pools err {err:.3g} (bar "
             f"{MOE_STEP_TOL}), tokens {tg.tolist()} / {tc.tolist()}")
    say(f"MoE reference step (f32, 4 experts top-2, skewed): card load "
        f"{lg.tolist()} and {rg} rounds equal the CPU's; written pools "
        f"within {err:.3g} of max-abs (bar {MOE_STEP_TOL}); tokens equal")


def serving_breadth_phase(torch) -> dict:
    """Prefix sharing, MoE decode and the live metrics stream through
    ``cli serve`` (module docstring, 7c).  Returns the K1 and K2
    launches of its runs, per cache dtype."""
    t_phase = time.perf_counter()
    layers = int(MODEL_FLAGS[MODEL_FLAGS.index("--layers") + 1])
    launches = {"bf16": 0, "int8": 0, "fp8": 0}

    def run(label, flags, plan, dtype="bf16"):
        res = serve_run(torch, label, ["--cache_dtype", dtype, *flags],
                        plan)
        c = res["counts"]
        mine, other = (("k1", "k2") if dtype == "bf16" else ("k2", "k1"))
        if c[mine] != layers * c["steps"] or c["steps"] == 0 or c[other]:
            fail(f"serving breadth {label}: launches K1 {c['k1']} / K2 "
                 f"{c['k2']} against {layers} x {c['steps']} device steps "
                 f"on {mine}")
        launches[dtype] += c[mine]
        srv = res["serving"]
        say(f"serving breadth {label}: {mine} {c[mine]} = {layers} x "
            f"{c['steps']} device steps; ttft p50 {srv['ttft_ms']['p50']} "
            f"p99 {srv['ttft_ms']['p99']} ms, tpot p50 "
            f"{srv['tpot_ms']['p50']} ms, {srv['tokens_per_s']} tokens/s, "
            f"wall {srv['wall_s']} s (cli {res['wall']:.1f} s)")
        return res

    # ---- prefix sharing
    live = OUT / "live_metrics.jsonl"
    off = run("prefix_off_n1", [], PREFIX_SERVE_PLAN)
    shared = {
        "n1": run("prefix_on_n1", [*SHARING, "--live_metrics", str(live)],
                  PREFIX_SERVE_PLAN),
        "n16": run("prefix_on_n16", [*SHARING, *LOOP_N],
                   PREFIX_SERVE_PLAN)}
    q_off = run("prefix_off_int8", [], PREFIX_SERVE_PLAN, "int8")
    shared["int8"] = run("prefix_on_int8", SHARING, PREFIX_SERVE_PLAN,
                         "int8")
    for key, res in shared.items():
        g = res["record"]["global"]
        pst = res["serving"]["kv_cache"]["prefix"]
        if not (g["prefix_hit_rate"] > 0 and pst["cow_copies"] > 0
                and g["serving_config"]["prefix_sharing"] is True):
            fail(f"serving breadth prefix {key}: hit rate "
                 f"{g['prefix_hit_rate']}, prefix block {pst}")
        ref = q_off if key == "int8" else off
        same, n = agreement(res["streams"], ref["streams"])
        flips = ([] if key == "int8" or res["streams"] == ref["streams"]
                 else flip_margins(torch, PREFIX_SERVE_PLAN,
                                   ref["streams"], res["streams"]))
        say(f"serving breadth prefix {key}: {same} of {n} tokens equal "
            f"the unshared run's ({'equal streams' if same == n else 'parted'}"
            f"{'; int8: copied rows quantized again, no equality bar' if key == 'int8' else ''}); "
            f"hit rate {g['prefix_hit_rate']}, prefix_bytes_saved "
            f"{g['prefix_bytes_saved']}, {pst['cow_copies']} copy-on-write "
            f"copies, {pst['pages_shared']} pages shared; ttft p50 "
            f"{res['serving']['ttft_ms']['p50']} / p99 "
            f"{res['serving']['ttft_ms']['p99']} ms against unshared "
            f"{ref['serving']['ttft_ms']['p50']} / "
            f"{ref['serving']['ttft_ms']['p99']}")
        for line in flips:
            say(f"serving breadth prefix {key} flip: {line}")
    lines = [json.loads(ln) for ln in live.read_text().splitlines()]
    if not lines or any(set(ln) != LIVE_KEYS for ln in lines):
        fail(f"serving breadth live metrics: {len(lines)} lines, keys "
             f"{[sorted(ln) for ln in lines[:2]]}")
    say(f"serving breadth live metrics: {len(lines)} lines of the locked "
        f"schema over runs {sorted({ln['run'] for ln in lines})}")

    # ---- MoE decode
    moe_reference_step(torch)
    moe = {}
    for dt in ("bf16", "int8"):
        for n, flags in (("n1", []), ("n16", LOOP_N)):
            moe[f"{dt}_{n}"] = run(f"moe_{dt}_{n}", [*MOE_FLAGS, *flags],
                                   SERVE_PLAN, dt)
        if moe[f"{dt}_n16"]["streams"] != moe[f"{dt}_n1"]["streams"]:
            same, n = agreement(moe[f"{dt}_n16"]["streams"],
                                moe[f"{dt}_n1"]["streams"])
            fail(f"serving breadth MoE {dt}: N=16 streams != N=1 ({same} "
                 f"of {n} tokens agree)")
    moe["skew"] = run("moe_bf16_n1_skew",
                      [*MOE_FLAGS, "--moe_skew", str(MOE_SKEW)], SERVE_PLAN)
    top_k = int(MOE_FLAGS[MOE_FLAGS.index("--top_k") + 1])
    for key, res in moe.items():
        c, blk = res["counts"], res["record"]["global"]["moe"]
        # every decode dispatch routed top_k pairs a layer for each token
        # it fed: its load's sum against the tokens emitted after it
        marks = [e for _, e in res["moe_dispatches"]]
        marks.append(res["tokens_emitted"])
        bad = [(s, b - a) for (s, a), b in zip(res["moe_dispatches"],
                                               marks[1:])
               if s != top_k * layers * (b - a)]
        want_reads = layers * (c["steps"] + c["prefill_chunks"])
        if bad or c["moe_host_reads"] != want_reads:
            fail(f"serving breadth MoE {key}: dispatch loads against "
                 f"top_k x layers x tokens {bad[:4]}; host reads "
                 f"{c['moe_host_reads']} != {layers} x ({c['steps']} "
                 f"device steps + {c['prefill_chunks']} prefill chunks)")
        say(f"serving breadth MoE {key}: tpot p50 "
            f"{res['serving']['tpot_ms']['p50']} ms, rounds_mean "
            f"{blk['rounds_mean']} (p99 {blk['rounds_p99']}, prefill "
            f"{blk['prefill_rounds_mean']}), load_imbalance "
            f"{blk['load_imbalance']}, expert_load {blk['expert_load']}; "
            f"{len(res['moe_dispatches'])} dispatches each loading "
            f"{top_k} x {layers} x its tokens; host reads "
            f"{c['moe_host_reads']} = {layers} x ({c['steps']} device "
            f"steps + {c['prefill_chunks']} prefill chunks)")
    b_rounds = moe["bf16_n1"]["record"]["global"]["moe"]["rounds_mean"]
    s_rounds = moe["skew"]["record"]["global"]["moe"]["rounds_mean"]
    if not s_rounds > b_rounds:
        fail(f"serving breadth MoE: skew {MOE_SKEW} rounds_mean {s_rounds} "
             f"not above the balanced run's {b_rounds}")
    say(f"serving breadth MoE: N=16 streams equal N=1 on bf16 (K1) and "
        f"int8 (K2); skew {MOE_SKEW} raises rounds_mean {b_rounds} -> "
        f"{s_rounds}, tpot p50 {moe['bf16_n1']['serving']['tpot_ms']['p50']}"
        f" -> {moe['skew']['serving']['tpot_ms']['p50']} ms")
    say(f"serving breadth: 10 served runs in "
        f"{time.perf_counter() - t_phase:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after")
    return launches


# the serving-at-scale phase (module docstring, 7d): half the served
# plan, the prefix-heavy plan's first 8 requests for the fleet, and a
# crash of capacity rank 1 at its world-2 engine's 12th step
SCALE_PLAN = {**SERVE_PLAN, "num_requests": 8}
SCALE_PREFIX_PLAN = {**PREFIX_SERVE_PLAN, "num_requests": 8}
SCALE_CRASH = {"policy": "shrink", "events": [
    {"kind": "crash", "ranks": [1], "iteration": 12}]}
# K1/K2 over KV-head shards against the unsharded launch: K1's bar
SHARD_TOL = 2e-2


def scale_devices(torch) -> list[str]:
    """Two distinct cards where there are two, else cuda:0 twice."""
    if torch.cuda.device_count() >= 2:
        return ["cuda:0", "cuda:1"]
    return ["cuda:0", "cuda:0"]


def shard_attention_check(torch, devs: list[str], page_dtype: str) -> float:
    """One decode step's attention at the served shapes (3's operands)
    over pools split along the KV heads on ``devs``: max abs error
    against the unsharded launch, K1/K2 launched once a shard."""
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    q, pools, scales, lengths, bt = decode_operands(torch, page_dtype)
    fmt = {"int8": "int8", "fp8": "float8"}.get(page_dtype)
    quant = scales is not None
    ref = KV.paged_attention_decode(
        q, *pools, lengths, bt, k_scale=scales[0] if quant else None,
        v_scale=scales[1] if quant else None, fmt=fmt)
    half = HKV // 2

    def split(t):
        return KV.HeadShards([t[:half].contiguous().to(devs[0]),
                              t[half:].contiguous().to(devs[1])])
    PA.launches = PAQ.launches = 0
    got = KV.paged_attention_decode(
        q, split(pools[0]), split(pools[1]), lengths, bt,
        k_scale=split(scales[0]) if quant else None,
        v_scale=split(scales[1]) if quant else None, fmt=fmt)
    torch.cuda.synchronize()
    launched = PAQ.launches if quant else PA.launches
    PA.launches = PAQ.launches = 0
    err = abs_err(got, ref)
    if launched != 2 or not err <= SHARD_TOL:
        fail(f"scale kv_shard attention {page_dtype}: {launched} launches "
             f"(want 2), max abs err {err} against the unsharded launch "
             f"(bar {SHARD_TOL})")
    return err


def migration_check(torch, devs: list[str], cache_dtype: str) -> dict:
    """The migration channel at the served geometry (4 layers, 8 KV
    heads, 16-token pages, Dh 128): 24 seeded pages in the stored dtype
    sent ``devs[0] -> devs[1]`` in 8-page chunks, landed bit for bit at
    other page ids; bytes pages x page_bytes; its ms (one send, fenced,
    after a warm one)."""
    from dlnetbench_tpu_torch.ops.page_migration import MigrationChannel
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    cfg = KV.CacheConfig(num_layers=4, num_kv_heads=HKV, head_dim=DH,
                         num_pages=64, page_size=PAGE, max_seqs=8,
                         max_pages_per_seq=32, dtype="bfloat16",
                         cache_dtype=cache_dtype).validate()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    src = []
    for t in KV.device_buffers(cfg, devs[0]):
        if t.dim() == 3:
            src.append(torch.rand(t.shape, generator=gen, device="cuda")
                       .to(devs[0]) + 0.01)
        else:
            src.append(torch.randn(t.shape, generator=gen, device="cuda")
                       .mul(30.0 if t.dtype == torch.int8 else 1.0)
                       .clamp(-127, 127).to(t.dtype).to(devs[0]))
    src_ids = list(range(3, 51, 2))
    dst_ids = list(range(40, 16, -1))
    ch = MigrationChannel(cfg, devs[1], chunk_pages=8)
    dst = ch.scatter(KV.device_buffers(cfg, devs[1]),
                     ch.send(src, src_ids), dst_ids)
    ch.reset()
    ch.send(src, src_ids)               # the timed send (warm)
    for got, want in zip(dst, src):
        bits = [(t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                 else t) for t in (got, want)]
        if got.dtype != want.dtype or not torch.equal(
                bits[0][:, :, dst_ids].cpu(), bits[1][:, :, src_ids].cpu()):
            fail(f"scale migration {cache_dtype}: the landed pages are not "
                 f"the sent ones bit for bit ({got.dtype})")
    rec = ch._sends[0]
    if rec.bytes != len(src_ids) * cfg.page_bytes:
        fail(f"scale migration {cache_dtype}: {rec.bytes} bytes != "
             f"{len(src_ids)} x {cfg.page_bytes}")
    return {"pages": rec.pages, "bytes": rec.bytes, "ms": rec.wall_ms,
            "ms_per_page": rec.wall_ms / rec.pages}


def scale_phase(torch, served: dict) -> dict:
    """``kv_shard``, the migration channel, disaggregation, the fleet and
    crash + shrink at the served model's width (module docstring, 7d).
    Returns the K1 and K2 launches of its served runs."""
    t_phase = time.perf_counter()
    devs = scale_devices(torch)
    layers = int(MODEL_FLAGS[MODEL_FLAGS.index("--layers") + 1])
    launches = {"bf16": 0, "int8": 0, "fp8": 0}
    say(f"scale: devices {devs} "
        f"({'two cards' if devs[0] != devs[1] else 'one card named twice'})")
    dev_flags = ["--devices", ",".join(devs)]

    def run(label, flags, plan, dtype, shards=1):
        res = serve_run(torch, f"scale_{label}",
                        ["--cache_dtype", dtype, *flags], plan)
        c = res["counts"]
        mine, other = (("k1", "k2") if dtype == "bf16" else ("k2", "k1"))
        if c[mine] != shards * layers * c["steps"] or c["steps"] == 0 \
                or c[other]:
            fail(f"scale {label}: launches K1 {c['k1']} / K2 {c['k2']} "
                 f"against {shards} shards x {layers} layers x "
                 f"{c['steps']} device steps on {mine}")
        launches[dtype] += c[mine]
        srv = res["serving"]
        say(f"scale {label}: {mine} {c[mine]} = {shards} x {layers} x "
            f"{c['steps']} device steps; ttft p50 {srv['ttft_ms']['p50']} "
            f"ms, tpot p50 {srv['tpot_ms']['p50']} ms, "
            f"{srv['tokens_per_s']} tokens/s (cli {res['wall']:.1f} s)")
        return res

    # ---- kv_shard
    for dt in ("bf16", "int8"):
        err = shard_attention_check(torch, devs, dt)
        say(f"scale kv_shard=2 attention {dt}: max abs err {err} against "
            f"the unsharded launch (bar {SHARD_TOL}), 2 launches")
    for dt in ("bf16", "int8"):
        res = run(f"kv_shard_{dt}", ["--kv_shard", "2", *dev_flags],
                  SCALE_PLAN, dt, shards=2)
        ref = {rid: served[dt]["streams"][rid] for rid in res["streams"]}
        same, n = agreement(res["streams"], ref)
        say(f"scale kv_shard=2 {dt}: {same} of {n} tokens equal the "
            f"kv_shard=1 run's (7); tpot p50 "
            f"{res['serving']['tpot_ms']['p50']} ms against "
            f"{served[dt]['serving']['tpot_ms']['p50']}")

    # ---- migration
    for dt in ("bf16", "int8", "fp8"):
        m = migration_check(torch, devs, dt)
        say(f"scale migration {dt}: {m['pages']} pages bit for bit, "
            f"{m['bytes']} bytes = pages x page_bytes, {m['ms']:.3f} ms "
            f"({m['ms_per_page'] * 1e3:.1f} us a page) {devs[0]} -> "
            f"{devs[1]}")

    # ---- disaggregated prefill/decode against one engine
    dis = run("disagg_int8", ["--world", "2", "--disaggregate",
                              *dev_flags], SCALE_PLAN, "int8")
    mig = dis["serving"]["migration"]
    if mig["sends"] != SCALE_PLAN["num_requests"] \
            or mig["bytes_ratio_vs_bf16"] > 0.55:
        fail(f"scale disagg: migration block {mig}")
    ref = {rid: served["int8"]["streams"][rid] for rid in dis["streams"]}
    same, n = agreement(dis["streams"], ref)
    say(f"scale disagg int8: {same} of {n} tokens equal the monolithic "
        f"run's (7); ttft p50 {dis['serving']['ttft_ms']['p50']} / tpot "
        f"p50 {dis['serving']['tpot_ms']['p50']} ms against "
        f"{served['int8']['serving']['ttft_ms']['p50']} / "
        f"{served['int8']['serving']['tpot_ms']['p50']}; migration "
        f"{mig['sends']} sends, {mig['bytes']} bytes (ratio "
        f"{mig['bytes_ratio_vs_bf16']}), ms p50 {mig['ms']['p50']}, "
        f"overlap {mig['overlap']}")

    # ---- the fleet against one engine
    one = run("fleet_ref", SHARING, SCALE_PREFIX_PLAN, "bf16")
    flt = run("fleet", [*SHARING, "--replicas", "2", "--routing",
                        "prefix_affinity", *dev_flags],
              SCALE_PREFIX_PLAN, "bf16")
    fb = flt["record"]["global"]["fleet"]
    if sum(fb["requests_per_replica"]) != SCALE_PREFIX_PLAN["num_requests"]:
        fail(f"scale fleet: fleet block {fb}")
    same, n = agreement(flt["streams"], one["streams"])
    say(f"scale fleet prefix_affinity: {same} of {n} tokens equal one "
        f"engine's; requests per replica {fb['requests_per_replica']}, "
        f"affinity hit rate {fb['affinity_hit_rate']}, reuse "
        f"{fb['prefix_reuse_tokens']} tokens, replica hit rates "
        f"{fb['replica_prefix_hit_rate']}")

    # ---- crash + shrink
    crash = run("crash_shrink", ["--world", "2", "--fault",
                                 json.dumps(SCALE_CRASH), *dev_flags],
                SCALE_PLAN, "bf16")
    g = crash["record"]["global"]
    if g.get("degraded_world") != [0] or g.get("degraded_slots") != 4:
        fail(f"scale crash: degraded_world {g.get('degraded_world')}, "
             f"degraded_slots {g.get('degraded_slots')}")
    say(f"scale crash + shrink: every request completed on "
        f"degraded_world [0] (4 slots), detection {g['detection_ms']} ms, "
        f"recovery {g['recovery_ms']} ms")
    say(f"scale: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def profile_loop(torch) -> None:
    """The device's idle share over one N=16 bf16 served run (warm
    engine, torch.profiler's kernel time over the run's wall)."""
    from torch.profiler import ProfilerActivity, profile

    from dlnetbench_tpu_torch.models.transformer import init_params
    from dlnetbench_tpu_torch.serving import scheduler as S
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    mc = served_model()
    cfg = S.ServingConfig(slots=8, page_size=16, num_pages=512,
                          max_seq_len=512, prefill_chunk=64,
                          multi_step_n=16, warmup_requests=8)
    eng = S.Engine(mc, cfg, params=init_params(mc, device="cuda"))
    plan = ArrivalPlan.from_dict(SERVE_PLAN)
    S.run_serving(mc, cfg, plan, engine=eng)         # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(plan.sample())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"decode loop profiled N=16 bf16 run: decode_loop "
        f"{json.dumps(eng.decode_loop_block())}")
    profile_rows(prof, wall, "loop16_bf16")


def serving_lines_check(line: dict) -> None:
    """The bench's serving lines, ridden inside the headline: the
    serving_decode line's token parity, the sampling_ab line's token
    identity, the kv_density_ab line's parity bars."""
    sd, sa, kd = (line["serving_decode"], line["sampling_ab"],
                  line["kv_density_ab"])
    if sd.get("token_parity") is not True:
        fail(f"bench serving_decode: token_parity {sd.get('token_parity')}")
    if sa.get("token_identity") is not True:
        fail(f"bench sampling_ab: token_identity "
             f"{sa.get('token_identity')}")
    bars = {dt: kd["variants"][dt].get("parity_ok")
            for dt in ("int8", "fp8")}
    if bars != {"int8": True, "fp8": True}:
        fail(f"bench kv_density_ab: parity bars {bars}")
    for key in ("multi_step", "speculative"):
        if not sd[key]["steps_per_dispatch"]["value"] > 1:
            fail(f"bench serving_decode {key}: {sd[key]}")
    say(f"bench serving lines: serving_decode e2e p99 {sd['value']} ms, "
        f"token_parity true, N=16 speedup "
        f"{sd['multi_step']['speedup_tokens_per_s']['value']}x tokens/s "
        f"(spec {sd['speculative']['speedup_tokens_per_s']['value']}x); "
        f"sampling_ab e2e p99 {sa['value']} ms, token_identity true, "
        f"acceptance {sa['spec_sampled']['acceptance_rate']['value']}; "
        f"kv_density_ab capacity int8 "
        f"{kd['variants']['int8']['capacity_x']['value']}x, fp8 "
        f"{kd['variants']['fp8']['capacity_x']['value']}x, parity max err "
        f"{kd['variants']['int8']['parity_max_err']['value']} / "
        f"{kd['variants']['fp8']['parity_max_err']['value']}")


def flash_operands(torch, b, s, hq, hkv, dh, seed=0):
    """Seeded bf16 q, k, v and an output cotangent dO."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    return (rand(b, s, hq, dh), rand(b, s, hkv, dh), rand(b, s, hkv, dh),
            rand(b, s, hq, dh))


def flash_bound(kind: str, b, s, hq, hkv, dh, causal, peak: dict,
                pairs: int | None = None,
                mask_bytes: int = 0) -> tuple[float, str]:
    """Least time for one launch: each operand read once and each output
    written once (bf16 rows, f32 lse/D, the mask's int32 arrays), against
    2 * B * Hq * Dh operations per (query, key) pair this run attends
    (the causal triangle, diagonal included, or a mask's live ``pairs``)
    and per product — 2 products in the forward, 3 in dq (s, dp, dq), 4
    in dk/dv (s, dv, dp, dk)."""
    if pairs is None:
        pairs = s * (s + 1) // 2 if causal else s * s
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kind]
    ops = 2 * products * b * hq * dh * pairs
    big, small, row = b * s * hq * dh * 2, b * s * hkv * dh * 2, b * hq * s * 4
    nbytes = mask_bytes + {"fwd": big + 2 * small + big + row,
                           "dq": 3 * big + 2 * small + row + big + row,
                           "dkv": 2 * big + 2 * small + 2 * row
                           + 2 * small}[kind]
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = ops / peak["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_phase(torch, case, peak: dict, timed: bool) -> dict:
    """K3, K4 and K5 each against its plain version on the same inputs
    (the plain backward reads the kernels' O, lse and D); with ``timed``,
    their times beside the plain versions', SDPA's and the bound."""
    import torch.nn.functional as F

    from dlnetbench_tpu_torch.ops import flash_attention as FA
    b, s, hq, hkv, dh, causal = case
    q, k, v, do = flash_operands(torch, b, s, hq, hkv, dh)
    out, lse = FA.kernel_forward(q, k, v, causal)
    dq, dcap = FA.kernel_dq(q, k, v, out, lse, do, causal)
    dk, dv = FA.kernel_dkv(q, k, v, do, lse, dcap, causal)
    torch.cuda.synchronize()
    p_out, p_lse = FA.plain_forward(q, k, v, causal)
    p_dq, p_dcap = FA.plain_dq(q, k, v, out, lse, do, causal)
    p_dk, p_dv = FA.plain_dkv(q, k, v, do, lse, dcap, causal)

    pairs = {"o": (out, p_out), "lse": (lse, p_lse), "d": (dcap, p_dcap),
             "dq": (dq, p_dq), "dk": (dk, p_dk), "dv": (dv, p_dv)}
    errs = {n: abs_err(a, r) for n, (a, r) in pairs.items()}
    rows = {n: row_err(*pairs[n]) for n in ("o", "dq", "dk", "dv")}
    label = f"flash {case}"
    for name, t in (("o", out), ("lse", lse), ("dq", dq), ("dk", dk),
                    ("dv", dv)):
        if not torch.isfinite(t).all():
            fail(f"{label}: {name} not finite")
    say(f"{label}: worst row err / row max-abs O {rows['o']:.3e} dq "
        f"{rows['dq']:.3e} dk {rows['dk']:.3e} dv {rows['dv']:.3e} (bar "
        f"{FLASH_TOL_ROW:.3e}); max abs err O {errs['o']:.3e} lse "
        f"{errs['lse']:.3e} D {errs['d']:.3e} (bar {FLASH_TOL_LSE}) dq "
        f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e}; "
        f"max-abs O {float(p_out.float().abs().max()):.3e} dq "
        f"{float(p_dq.float().abs().max()):.3e} dk "
        f"{float(p_dk.float().abs().max()):.3e} dv "
        f"{float(p_dv.float().abs().max()):.3e}")
    bad = [f"{n} row err {e:.3e} > {FLASH_TOL_ROW:.3e} of the row's "
           f"max-abs" for n, e in rows.items() if not e <= FLASH_TOL_ROW]
    bad += [f"{n} max abs err {errs[n]:.3e} > {FLASH_TOL_LSE}"
            for n in ("lse", "d") if not errs[n] <= FLASH_TOL_LSE]
    if bad:
        fail(f"{label}: kernels disagree with their plain versions: "
             f"{'; '.join(bad)}")
    del p_out, p_lse, p_dq, p_dcap, p_dk, p_dv
    if not timed:
        return {}
    # the yardsticks: SDPA on [B, H, S, Dh] views of the same tensors
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                           enable_gqa=True)
        return torch.autograd.grad(o, leaves, dot)
    sdpa_err = abs_err(sdpa_fwd().transpose(1, 2), out)
    runs = {
        "fwd": (lambda: FA.kernel_forward(q, k, v, causal),
                lambda: FA.plain_forward(q, k, v, causal)),
        "dq": (lambda: FA.kernel_dq(q, k, v, out, lse, do, causal),
               lambda: FA.plain_dq(q, k, v, out, lse, do, causal)),
        "dkv": (lambda: FA.kernel_dkv(q, k, v, do, lse, dcap, causal),
                lambda: FA.plain_dkv(q, k, v, do, lse, dcap, causal)),
    }
    lib_fwd = timed_ms(torch, sdpa_fwd)
    lib_bwd = timed_ms(torch, sdpa_fwd_bwd) - lib_fwd
    results = {}
    for kind, (kernel, plain) in runs.items():
        ms = timed_ms(torch, kernel)
        plain_ms = timed_ms(torch, plain, reps=5)
        bound_ms, bound_by = flash_bound(kind, *case, peak)
        err = {"fwd": errs["o"], "dq": errs["dq"],
               "dkv": max(errs["dk"], errs["dv"])}[kind]
        results[kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_fwd if kind == "fwd" else lib_bwd}
        say(f"flash {kind}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"bound_ms {bound_ms:.4f} ({bound_by}) -> {bound_ms / ms:.3f} "
            f"of bound")
    say(f"flash yardsticks: SDPA forward {lib_fwd:.4f} ms (err vs K3 "
        f"{sdpa_err:.3e}), SDPA backward (dq, dk, dv together) "
        f"{lib_bwd:.4f} ms against K4 + K5 "
        f"{results['dq']['ms'] + results['dkv']['ms']:.4f} ms")
    return results


def splash_check(torch, label, got: dict, want: dict) -> dict:
    """Every row of O, dq, dk, dv within 2^-6 of its max-abs and lse, D
    within 1e-3 against the plain versions; finite.  Returns the row
    and absolute errors."""
    for name, t in got.items():
        if not torch.isfinite(t).all():
            fail(f"{label}: {name} not finite")
    rows = {n: row_err(got[n], want[n]) for n in ("o", "dq", "dk", "dv")}
    errs = {n: abs_err(got[n], want[n]) for n in got}
    bad = [f"{n} row err {e:.3e} > {FLASH_TOL_ROW:.3e}"
           for n, e in rows.items() if not e <= FLASH_TOL_ROW]
    bad += [f"{n} max abs err {errs[n]:.3e} > {FLASH_TOL_LSE}"
            for n in ("lse", "d") if not errs[n] <= FLASH_TOL_LSE]
    if bad:
        fail(f"{label}: kernels disagree with their plain versions: "
             f"{'; '.join(bad)}")
    return {"rows": rows, "errs": errs}


def splash_faults(torch, spec, ops: tuple, got: dict, want: dict) -> None:
    """Planted faults must fail the bars: one tile dropped from a visit
    range (K6/K7: a q tile loses its diagonal kv tile, so the rows of a
    document that starts inside it see no key; K8: a kv tile loses its
    first q tile, so the keys of a document that ends inside that q tile
    get no contribution), and one row interval widened by a key (the
    first row of a document also sees the last key of the one before)."""
    import dataclasses

    import numpy as np

    from dlnetbench_tpu_torch.ops import attention_mask as M
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    q, k, v, do, out, lse, dcap = ops
    s = q.shape[1]
    ids = M.segment_ids(spec.seg_seed, spec.seg_avg, s)
    starts = np.nonzero(np.diff(ids))[0] + 1       # first rows of docs
    ends = starts - 1                              # last rows of docs
    bq, bkd = FA.DKV_TILES
    # K6's mask at FWD_TILES, K7's at DQ_TILES: the same row's q tile
    # loses its last kv tile in each, and the same row its first key
    bms = {kind: M.block_mask(spec, s, *FA._KIND_TILES[kind])
           for kind in ("fwd", "dq")}
    row = next(int(r) for r in starts if r % bq and all(
        bm.q_first_k[r // bm.block_q] < bm.q_last_k[r // bm.block_q]
        and r % bm.block_q for bm in bms.values()))
    dropped, widened = {}, {}
    for kind, bm in bms.items():
        last = bm.q_last_k.copy()
        last[row // bm.block_q] -= 1
        lo = bm.lo.copy()
        lo[row] -= 1
        dropped[kind] = FA.pack_block_mask(
            dataclasses.replace(bm, q_last_k=last), False, q.device)
        widened[kind] = FA.pack_block_mask(dataclasses.replace(bm, lo=lo),
                                           False, q.device)
    bmt = M.block_mask(spec, s, *FA.DKV_TILES)
    j = next(int(e) // bkd for e in ends if e % bkd < bq - 1
             and bmt.kv_first_q[e // bkd] == (e // bkd) * (bkd // bq)
             and bmt.kv_first_q[e // bkd] < bmt.kv_last_q[e // bkd])
    first_t = bmt.kv_first_q.copy()
    first_t[j] += 1
    lo_t = bmt.lo.copy()
    lo_t[row] -= 1
    dev = q.device
    faults = {
        "dropped tile": (
            dropped,
            FA.pack_block_mask(dataclasses.replace(bmt, kv_first_q=first_t),
                               True, dev)),
        "widened interval": (
            widened,
            FA.pack_block_mask(dataclasses.replace(bmt, lo=lo_t), True,
                               dev)),
    }
    for fault, (arr, arr_t) in faults.items():
        o_bad, _ = FA.kernel_splash_forward(q, k, v, spec,
                                            arrays=arr["fwd"])
        dq_bad, _ = FA.kernel_splash_dq(q, k, v, out, lse, do, spec,
                                        arrays=arr["dq"])
        dk_bad, dv_bad = FA.kernel_splash_dkv(q, k, v, do, lse, dcap, spec,
                                              arrays=arr_t)
        torch.cuda.synchronize()
        seen = {"K6 O": row_err(o_bad, want["o"]),
                "K7 dq": row_err(dq_bad, want["dq"]),
                "K8 dk/dv": max(row_err(dk_bad, want["dk"]),
                                row_err(dv_bad, want["dv"]))}
        missed = [n for n, e in seen.items() if e <= FLASH_TOL_ROW]
        if missed:
            fail(f"splash planted fault ({fault}): {missed} still within "
                 f"the bar {seen}")
        say(f"splash planted fault ({fault}; q row {row}, kv tile {j}): "
            f"detected, worst row err " + ", ".join(
                f"{n} {e:.3e}" for n, e in seen.items()))
        del o_bad, dq_bad, dk_bad, dv_bad


def splash_f32_phase(torch) -> None:
    """The f32 K6/K7/K8 (CUDA cores; they carry the tiny masked models)
    against their plain versions under ``SPLASH_F32_SPECS``, and under
    the plain-causal mask bitwise against the f32 K3/K4/K5."""
    from dlnetbench_tpu_torch.ops import attention_mask as M
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, hq, hkv, dh = SPLASH_F32_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    q, k, v, do = (torch.randn(b, s, h, dh, generator=gen, device="cuda")
                   for h in (hq, hkv, hkv, hq))
    worst = {}
    for fields in SPLASH_F32_SPECS:
        spec = M.MaskSpec(**fields)
        out, lse = FA.kernel_splash_forward(q, k, v, spec)
        dq, dcap = FA.kernel_splash_dq(q, k, v, out, lse, do, spec)
        dk, dv = FA.kernel_splash_dkv(q, k, v, do, lse, dcap, spec)
        torch.cuda.synchronize()
        p_out, p_lse = FA.plain_splash_forward(q, k, v, spec)
        p_dq, p_dcap = FA.plain_splash_dq(q, k, v, out, lse, do, spec)
        p_dk, p_dv = FA.plain_splash_dkv(q, k, v, do, lse, dcap, spec)
        rows = {"o": row_err(out, p_out), "dq": row_err(dq, p_dq),
                "dk": row_err(dk, p_dk), "dv": row_err(dv, p_dv)}
        errs = {"lse": abs_err(lse, p_lse), "d": abs_err(dcap, p_dcap)}
        if not (all(e <= SPLASH_F32_TOL_ROW for e in rows.values())
                and all(e <= FLASH_TOL_LSE for e in errs.values())):
            fail(f"splash f32 {spec.label()}: row errs {rows} (bar "
                 f"{SPLASH_F32_TOL_ROW}), {errs} (bar {FLASH_TOL_LSE})")
        if spec.is_plain_causal:
            f_out, f_lse = FA.kernel_forward(q, k, v, True)
            f_dq, f_dcap = FA.kernel_dq(q, k, v, f_out, f_lse, do, True)
            f_dk, f_dv = FA.kernel_dkv(q, k, v, do, f_lse, f_dcap, True)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in (
                    (out, f_out), (lse, f_lse), (dq, f_dq), (dcap, f_dcap),
                    (dk, f_dk), (dv, f_dv))):
                fail("splash f32: K6/K7/K8 under the plain-causal mask not "
                     "bitwise equal to K3/K4/K5")
        worst[spec.label()] = {n: float(f"{e:.3e}") for n, e in rows.items()}
    say(f"splash f32 {SPLASH_F32_SHAPE}: worst row err / row max-abs per "
        f"mask {json.dumps(worst)} (bar {SPLASH_F32_TOL_ROW}); the "
        f"plain-causal mask bitwise equal to the f32 K3/K4/K5")


def splash_phase(torch, peak: dict) -> dict:
    """K6/K7/K8 against their plain versions at the train step's
    attention shape under five masks (the plain backward reads the
    kernels' O, lse and D); the plain-causal mask bitwise against
    K3/K4/K5; the planted faults; times of every kernel under every mask
    beside the bound over the mask's live pairs, and for the window mask
    (the kernels line's row) the plain versions' and the library's:
    ``scaled_dot_product_attention`` with the boolean dense mask,
    forward and forward + backward, on K/V expanded to the q heads
    beforehand."""
    import torch.nn.functional as F

    from dlnetbench_tpu_torch.ops import attention_mask as M
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    b, s, hq, hkv, dh = SPLASH_SHAPE
    q, k, v, do = flash_operands(torch, b, s, hq, hkv, dh, seed=3)
    results = {}
    for label, fields in SPLASH_SPECS:
        spec = M.MaskSpec(**fields)
        out, lse = FA.kernel_splash_forward(q, k, v, spec)
        dq, dcap = FA.kernel_splash_dq(q, k, v, out, lse, do, spec)
        dk, dv = FA.kernel_splash_dkv(q, k, v, do, lse, dcap, spec)
        torch.cuda.synchronize()
        p_out, p_lse = FA.plain_splash_forward(q, k, v, spec)
        p_dq, p_dcap = FA.plain_splash_dq(q, k, v, out, lse, do, spec)
        p_dk, p_dv = FA.plain_splash_dkv(q, k, v, do, lse, dcap, spec)
        got = {"o": out, "lse": lse, "d": dcap, "dq": dq, "dk": dk,
               "dv": dv}
        want = {"o": p_out, "lse": p_lse, "d": p_dcap, "dq": p_dq,
                "dk": p_dk, "dv": p_dv}
        tag = f"splash {label} {SPLASH_SHAPE}"
        chk = splash_check(torch, tag, got, want)
        note = ""
        if spec.is_plain_causal:
            f_out, f_lse = FA.kernel_forward(q, k, v, True)
            f_dq, f_dcap = FA.kernel_dq(q, k, v, f_out, f_lse, do, True)
            f_dk, f_dv = FA.kernel_dkv(q, k, v, do, f_lse, f_dcap, True)
            torch.cuda.synchronize()
            same = {n: torch.equal(a, b_) for n, a, b_ in (
                ("o", out, f_out), ("lse", lse, f_lse), ("dq", dq, f_dq),
                ("d", dcap, f_dcap), ("dk", dk, f_dk), ("dv", dv, f_dv))}
            if not all(same.values()):
                fail(f"{tag}: K6/K7/K8 under the plain-causal mask not "
                     f"bitwise equal to K3/K4/K5: {same}")
            note = "; bitwise equal to K3/K4/K5"
            del f_out, f_lse, f_dq, f_dcap, f_dk, f_dv
        if label == "seg(768)":
            splash_faults(torch, spec, (q, k, v, do, out, lse, dcap), got,
                          want)
        del p_out, p_lse, p_dq, p_dcap, p_dk, p_dv, want
        rows = chk["rows"]
        lo, hi = M.row_intervals(spec, s)
        pairs = int((hi - lo + 1).sum())
        say(f"{tag}: worst row err / row max-abs O {rows['o']:.3e} dq "
            f"{rows['dq']:.3e} dk {rows['dk']:.3e} dv {rows['dv']:.3e} "
            f"(bar {FLASH_TOL_ROW:.3e}); lse {chk['errs']['lse']:.3e} D "
            f"{chk['errs']['d']:.3e}; live pairs {pairs / (s * s):.4f} of "
            f"S^2{note}")
        runs = {
            "fwd": lambda: FA.kernel_splash_forward(q, k, v, spec),
            "dq": lambda: FA.kernel_splash_dq(q, k, v, out, lse, do, spec),
            "dkv": lambda: FA.kernel_splash_dkv(q, k, v, do, lse, dcap,
                                                spec),
        }
        plains = {
            "fwd": lambda: FA.plain_splash_forward(q, k, v, spec),
            "dq": lambda: FA.plain_splash_dq(q, k, v, out, lse, do, spec),
            "dkv": lambda: FA.plain_splash_dkv(q, k, v, do, lse, dcap,
                                               spec),
        }
        res = {}
        for kind, kernel in runs.items():
            arr = FA.splash_arrays(spec, s, kind, q.device)
            b_ms, b_by = flash_bound(kind, b, s, hq, hkv, dh, spec.causal,
                                     peak, pairs=pairs,
                                     mask_bytes=arr.packed.numel() * 4)
            err = {"fwd": chk["errs"]["o"], "dq": chk["errs"]["dq"],
                   "dkv": max(chk["errs"]["dk"], chk["errs"]["dv"])}[kind]
            res[kind] = {"max_abs_err": err, "ms": timed_ms(torch, kernel),
                         "bound_ms": b_ms, "bound_by": b_by}
        if label == SPLASH_SPECS[0][0]:
            # the plain versions' and the library's times for the row
            dense = torch.from_numpy(M.dense_mask(spec, s)).cuda()
            g = hq // hkv
            qt = q.transpose(1, 2)
            kt, vt = (x.transpose(1, 2).repeat_interleave(g, dim=1)
                      for x in (k, v))
            leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
            dot = do.transpose(1, 2)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=dense)

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(*leaves, attn_mask=dense)
                return torch.autograd.grad(o, leaves, dot)
            sdpa_err = abs_err(sdpa_fwd().transpose(1, 2), out)
            lib_fwd = timed_ms(torch, sdpa_fwd)
            lib_bwd = timed_ms(torch, sdpa_fwd_bwd) - lib_fwd
            for kind in runs:
                res[kind]["plain_ms"] = timed_ms(torch, plains[kind], reps=3)
                res[kind]["library_ms"] = lib_fwd if kind == "fwd" \
                    else lib_bwd
            say(f"splash yardsticks ({label}): SDPA forward with the dense "
                f"bool mask {lib_fwd:.4f} ms (err vs K6 {sdpa_err:.3e}), "
                f"its backward (dq, dk, dv together) {lib_bwd:.4f} ms "
                f"against K7 + K8 {res['dq']['ms'] + res['dkv']['ms']:.4f} "
                f"ms; plain versions " + ", ".join(
                    f"{kd} {res[kd]['plain_ms']:.2f} ms" for kd in runs))
            del dense, kt, vt, leaves
        say(f"splash {label} times: " + "; ".join(
            f"{kd} kernel_ms {r['ms']:.4f} bound_ms {r['bound_ms']:.4f} "
            f"({r['bound_by']}) -> {r['bound_ms'] / r['ms']:.3f} of bound"
            for kd, r in res.items()))
        results[label] = res
        del out, lse, dq, dcap, dk, dv, got
        torch.cuda.empty_cache()
    return results


def flash_counts() -> dict:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    return {"fwd": FA.fwd_launches, "dq": FA.dq_launches,
            "dkv": FA.dkv_launches}


def reset_flash_counts() -> None:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    FA.fwd_launches = FA.dq_launches = FA.dkv_launches = 0
    FA.splash_fwd_launches = FA.splash_dq_launches = 0
    FA.splash_dkv_launches = 0


def splash_counts() -> dict:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    return {"fwd": FA.splash_fwd_launches, "dq": FA.splash_dq_launches,
            "dkv": FA.splash_dkv_launches}


def train_reference_phase(torch) -> None:
    """Tiny f32 model (TF32 off), same weights and tokens, 2 SGD steps on
    the card (the f32 flash kernels) and on the CPU (plain versions)."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = T.TransformerConfig(vocab_size=256, embed_dim=256, num_heads=2,
                              num_kv_heads=1, ff_dim=512, num_layers=2,
                              seq_len=128, dtype="float32",
                              logits_f32=False)
    cpu = T.init_params(cfg, seed=7, device="cpu")
    gpu = {k: ({n: w.cuda() for n, w in v.items()}
               if isinstance(v, dict) else v.cuda())
           for k, v in cpu.items()}
    gen = torch.Generator()
    gen.manual_seed(8)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len + 1),
                           generator=gen)
    step = BS.make_train_k(cfg, 2)
    start = [p.clone() for p in BS.leaves(cpu)]
    reset_flash_counts()
    _, gpu_losses = step(gpu, tokens.cuda())
    torch.cuda.synchronize()
    counts = flash_counts()
    _, cpu_losses = step(cpu, tokens)
    want = cfg.num_layers * 2
    if counts != {"fwd": want, "dq": want, "dkv": want}:
        fail(f"train reference: flash launches {counts}, want {want} each")
    gl, cl = gpu_losses.cpu(), cpu_losses
    if not torch.allclose(gl, cl, rtol=1e-5, atol=0) or not gl[1] < gl[0]:
        fail(f"train reference: card losses {gl.tolist()} vs CPU "
             f"{cl.tolist()}")
    # the update itself (two steps at lr 1e-3 move a weight ~1e-6), each
    # element within two f32 ulps of its weight (each side rounds
    # p - lr * g twice) plus 1e-3 of the leaf's largest move
    worst = 0.0
    for p0, c, g in zip(start, BS.leaves(cpu), BS.leaves(gpu)):
        moved, ref = g.cpu() - p0, c - p0
        ulp = torch.nextafter(p0.abs(), torch.tensor(math.inf)) - p0.abs()
        lim = 2 * ulp + 1e-3 * ref.abs().max()
        worst = max(worst, float(((moved - ref).abs() / lim).max()))
        if not float(ref.abs().max()) > 0 or worst > 1:
            fail(f"train reference: a leaf's update differs between card "
                 f"and CPU by {worst:.3e} of its bar (or did not move)")
    say(f"train reference: 2 f32 SGD steps, losses card {gl.tolist()} CPU "
        f"{cl.tolist()}; every weight's update within {worst:.3e} of its "
        f"bar (2 ulps + 1e-3 of the leaf's largest move); flash launches "
        f"{counts}")


def mask_reference_phase(torch) -> dict:
    """Tiny f32 models (TF32 off) under a window and under a segment
    mask, same weights and tokens, 2 SGD steps on the card (K6/K7/K8
    f32) and on the CPU (plain versions): losses within 1e-5 relative,
    every parameter within 1e-5 of its leaf's max-abs."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for label, knobs in (("window(32)", {"attention_window": 32}),
                         ("seg(40)", {"attention_seg_avg": 40,
                                      "attention_seg_seed": 1})):
        cfg = T.TransformerConfig(vocab_size=256, embed_dim=256, num_heads=2,
                                  num_kv_heads=1, ff_dim=512, num_layers=2,
                                  seq_len=128, dtype="float32",
                                  logits_f32=False, **knobs)
        cpu = T.init_params(cfg, seed=11, device="cpu")
        gpu = {k: ({n: w.cuda() for n, w in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in cpu.items()}
        gen = torch.Generator()
        gen.manual_seed(12)
        tokens = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len + 1),
                               generator=gen)
        step = BS.make_train_k(cfg, 2)
        reset_flash_counts()
        gpu, gpu_losses = step(gpu, tokens.cuda())
        torch.cuda.synchronize()
        counts, flash = splash_counts(), flash_counts()
        cpu, cpu_losses = step(cpu, tokens)
        want = cfg.num_layers * 2
        if counts != {"fwd": want, "dq": want, "dkv": want} \
                or any(flash.values()):
            fail(f"mask reference {label}: splash launches {counts} (want "
                 f"{want} each), flash {flash} (want 0)")
        gl = gpu_losses.cpu()
        if not torch.allclose(gl, cpu_losses, rtol=MASK_REF_TOL, atol=0) \
                or not gl[1] < gl[0]:
            fail(f"mask reference {label}: card losses {gl.tolist()} vs CPU "
                 f"{cpu_losses.tolist()}")
        worst = 0.0
        for c, g in zip(BS.leaves(cpu), BS.leaves(gpu)):
            worst = max(worst, float((g.cpu() - c).abs().max()
                                     / c.abs().max().clamp_min(1e-30)))
        if not worst <= MASK_REF_TOL:
            fail(f"mask reference {label}: a parameter differs by "
                 f"{worst:.3e} of its leaf's max-abs (bar {MASK_REF_TOL})")
        say(f"mask reference {label}: 2 f32 SGD steps, losses card "
            f"{gl.tolist()} CPU {cpu_losses.tolist()}; worst parameter "
            f"{worst:.3e} of its leaf's max-abs (bar {MASK_REF_TOL}); "
            f"K6/K7/K8 f32 launches {counts}")
        out[label] = counts
    return out


def masked_train_phase(torch) -> dict:
    """The bench train step at full width (llama3_8b, 4 layers, B=2,
    S=6144, vocab 32768) through ``bench_step.build`` under each mask of
    ``MASKED_STEPS`` beside the unmasked step: the first call's losses
    finite and near ln V, K6/K7/K8 launched layers x steps and K3-K5
    never in a masked run; then ms a step in paired rounds.  Then a
    long-context pair at B=1, S=32768 (4 layers): dense causal against
    the Mistral 7B window, paired rounds.  Returns the splash launches of
    the whole phase and the step times."""
    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    layers, k = BS.LAYERS, 3
    total = {"fwd": 0, "dq": 0, "dkv": 0}

    def counted(name, masked, steps, run):
        reset_flash_counts()
        losses = run()
        torch.cuda.synchronize()
        sp, fl = splash_counts(), flash_counts()
        for kd in total:
            total[kd] += sp[kd]
        want = layers * steps
        mine, other = (sp, fl) if masked else (fl, sp)
        if mine != {"fwd": want, "dq": want, "dkv": want} \
                or any(other.values()):
            fail(f"masked train {name}: splash launches {sp}, flash {fl} "
                 f"(want {want} each on the {'splash' if masked else 'flash'}"
                 f" kernels and none on the other)")
        return losses

    progs, first = {}, {}
    for name, over in {"dense": {}, **MASKED_STEPS}.items():
        train_k, params, tokens, _, cfg = BS.build(k, **over)
        losses = counted(name, bool(over), k,
                         lambda: train_k(params, tokens)[1]).cpu()
        ln_v = math.log(cfg.vocab_size)
        if not (torch.isfinite(losses).all()
                and abs(float(losses[0]) - ln_v) < 1.5):
            fail(f"masked train {name}: losses {losses.tolist()} (want "
                 f"finite, within 1.5 of ln V {ln_v:.3f})")
        first[name] = losses.tolist()
        progs[name] = lambda p=params, f=train_k, t=tokens: f(p, t)
    reset_flash_counts()
    summ, _ = bench.measure_paired(progs, k, "cuda")
    torch.cuda.synchronize()
    sp = splash_counts()
    for kd in total:
        total[kd] += sp[kd]
    del progs
    torch.cuda.empty_cache()
    ms = {n: v["value"] * 1e3 for n, v in summ.items()}
    say(f"masked train (llama3_8b width, {layers} layers, B={BS.BATCH} "
        f"S={BS.SEQ}): first losses {json.dumps(first)}; ms a step "
        f"(median of {bench.ROUNDS} paired rounds of {k} steps) " + ", ".join(
            f"{n} {v:.3f} (band {summ[n]['band'][0] * 1e3:.3f}-"
            f"{summ[n]['band'][1] * 1e3:.3f})" for n, v in ms.items()))

    # the long-context pair: B=1, S=32768
    card = BS.bench_card()
    k_long = 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.randint(0, BS.VOCAB, (1, LONG_SEQ_STEP + 1),
                           generator=gen, device="cuda")
    progs = {}
    for name, over in (("dense", {}),
                       (f"window({LONG_WINDOW})",
                        {"attention_window": LONG_WINDOW})):
        cfg = BS.bench_cfg(card, seq_len=LONG_SEQ_STEP, **over)
        params = T.init_params(cfg, seed=0, device="cuda")
        train_k = BS.make_train_k(cfg, k_long)
        losses = counted(f"S={LONG_SEQ_STEP} {name}", bool(over), k_long,
                         lambda: train_k(params, tokens)[1]).cpu()
        if not torch.isfinite(losses).all():
            fail(f"masked train S={LONG_SEQ_STEP} {name}: losses "
                 f"{losses.tolist()}")
        first[f"S={LONG_SEQ_STEP} {name}"] = losses.tolist()
        progs[name] = lambda p=params, f=train_k: f(p, tokens)
    reset_flash_counts()
    long_summ, rounds = bench.measure_paired(progs, k_long, "cuda")
    torch.cuda.synchronize()
    sp = splash_counts()
    for kd in total:
        total[kd] += sp[kd]
    del progs
    torch.cuda.empty_cache()
    names = list(long_summ)
    ratio = [w / d for w, d in zip(rounds[names[1]], rounds[names[0]])]
    say(f"masked train long context (B=1 S={LONG_SEQ_STEP}, {layers} "
        f"layers): first losses dense {first[f'S={LONG_SEQ_STEP} dense']}, "
        f"{names[1]} {first[f'S={LONG_SEQ_STEP} {names[1]}']}; ms a step "
        + ", ".join(f"{n} {v['value'] * 1e3:.3f}" for n, v in
                    long_summ.items())
        + f"; paired ratio {names[1]}/dense per round "
        f"{[round(r, 4) for r in ratio]}")
    return {"launches": total, "ms": ms,
            "long_ms": {n: v["value"] * 1e3 for n, v in long_summ.items()}}


def longcontext_phase(torch, line: dict) -> None:
    """The bench's ``longcontext_ab`` line (all four legs, finite), then
    at its S=64k operands: K6 under the plain-causal mask bitwise equal
    to K3 (the dense leg), and K6 under the window and segment masks
    against the chunked plain version on sampled q tiles (the first, the
    last and two in the middle)."""
    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    legs = ("dense", "splash_causal", "splash_window", "splash_segment")
    for leg in legs:
        band = line.get(leg) or {}
        if set(band) != {"value", "best", "band", "n"} \
                or not (math.isfinite(band["value"]) and band["value"] > 0):
            fail(f"longcontext: leg {leg} {band}")
    for leg in legs[1:]:
        r = line[f"ratio_{leg}_vs_dense"]["value"]
        if not (math.isfinite(r) and r > 0):
            fail(f"longcontext: ratio {leg} {r}")
    sh = bench.longcontext_shape()
    q, k, v = bench.longcontext_operands(sh, "cuda")
    specs = bench.longcontext_specs(sh)
    dense, dense_lse = FA.kernel_forward(q, k, v, True)
    causal, causal_lse = FA.kernel_splash_forward(q, k, v,
                                                  specs["splash_causal"])
    torch.cuda.synchronize()
    if not (torch.equal(dense, causal) and torch.equal(dense_lse,
                                                       causal_lse)):
        fail("longcontext: the splash_causal leg's output is not bitwise "
             "the dense leg's")
    del dense, dense_lse, causal, causal_lse
    s, bq = sh["seq"], FA.FWD_TILES[0]
    nq = s // bq
    tiles = [0, nq // 3, 2 * nq // 3, nq - 1]
    worst = {}
    for name in ("splash_window", "splash_segment"):
        spec = specs[name]
        out, lse = FA.kernel_splash_forward(q, k, v, spec)
        torch.cuda.synchronize()
        for t in tiles:
            c0 = t * bq
            p_out, p_lse = FA.plain_splash_rows(q, k, v, spec, c0, c0 + bq)
            e_row = row_err(out[:, c0:c0 + bq], p_out)
            e_lse = abs_err(lse[:, :, c0:c0 + bq], p_lse)
            if not (e_row <= FLASH_TOL_ROW and e_lse <= FLASH_TOL_LSE):
                fail(f"longcontext {name}: q tile {t}: row err {e_row:.3e} "
                     f"(bar {FLASH_TOL_ROW:.3e}), lse {e_lse:.3e}")
            worst[name] = max(worst.get(name, 0.0), e_row)
        del out, lse
    torch.cuda.empty_cache()
    say(f"longcontext: {json.dumps({k_: v_ for k_, v_ in line.items() if k_ not in ('metric', 'masks')})}")
    say(f"longcontext: masks {json.dumps(line['masks'])}")
    say(f"longcontext (S={s}): splash_causal bitwise equal to dense (K6 = "
        f"K3); K6 against the chunked plain version on q tiles {tiles}: "
        f"worst row err window {worst['splash_window']:.3e}, segment "
        f"{worst['splash_segment']:.3e} (bar {FLASH_TOL_ROW:.3e}); window "
        f"{line['splash_window']['value']} ms vs dense "
        f"{line['dense']['value']} ms (ratio "
        f"{line['ratio_splash_window_vs_dense']['value']}), speedup vs "
        f"sparsity {line['speedup_vs_sparsity']}")


def reset_mlp_counts() -> None:
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    Q.fused_launches = MB.dgdu_launches = MB.dwd_launches = 0


def mlp_counts() -> dict:
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    return {"k11": Q.fused_launches, "k9": MB.dgdu_launches,
            "k10": MB.dwd_launches}


def seeded(torch, seed: int):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)
    return rand


def bound_ms(ops: float, nbytes: float, peak: dict,
             kind: str) -> tuple[float, str]:
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = ops / peak[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmm_check(torch, fmt: str, y, ref, label: str) -> dict:
    """K11 against its plain version: int8 bit-exact, e4m3 by row and
    Frobenius bars; both finite."""
    if not torch.isfinite(y.float()).all():
        fail(f"{label}: output not finite")
    errs = {"max_abs_err": abs_err(y, ref), "row": row_err(y, ref),
            "fro": fro_err(y, ref)}
    if fmt == "int8":
        if not torch.equal(y, ref):
            fail(f"{label}: int8 kernel differs from the plain version "
                 f"(max abs err {errs['max_abs_err']:.3e}); it must be "
                 f"bit-exact")
    elif not (errs["row"] <= E4M3_TOL_ROW and errs["fro"] <= E4M3_TOL_FRO):
        fail(f"{label}: e4m3 row err {errs['row']:.3e} (bar "
             f"{E4M3_TOL_ROW:.3e}), Frobenius {errs['fro']:.3e} (bar "
             f"{E4M3_TOL_FRO})")
    return errs


def qmm_phase(torch, fmt: str, peak: dict) -> dict:
    """K11 at the train step's MLP shapes (gate/up [T, D] @ [D, F], down
    [T, F] @ [F, D]), with and without amax, against the plain version on
    the card; a stale-scale case; times at the up-projection shape."""
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    kind = "int8" if fmt == "int8" else "fp8"
    rand = seeded(torch, 21)
    out, worst = {}, 0.0
    for proj, (k, n) in (("up", (MLP_D, MLP_F)), ("down", (MLP_F, MLP_D))):
        x = rand(MLP_T, k)
        w = rand(k, n, scale=k ** -0.5)
        wq, sw = Q.quantize_tensor(w, fmt)
        w_t = Q.k_major(wq)
        amax = Q.amax_of(x)
        sx = Q.scale_from_amax(amax, fmt)
        for collect in (False, True):
            y, am = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt, collect)
            torch.cuda.synchronize()
            ref, _ = Q.plain_fused_matmul(x, wq, sw, sx, fmt, False)
            label = f"K11 {kind} {proj} amax={collect}"
            errs = qmm_check(torch, fmt, y, ref, label)
            if collect and not torch.equal(am, amax):
                fail(f"{label}: amax {float(am)} != max|x| {float(amax)}")
            worst = max(worst, errs["max_abs_err"])
            say(f"{label}: max abs err {errs['max_abs_err']:.3e}, worst "
                f"row {errs['row']:.3e}, Frobenius {errs['fro']:.3e}"
                + (f"; amax {float(am)} exact" if collect else ""))
            del y, ref
        if proj == "up":
            out = qmm_times(torch, fmt, x, wq, w_t, sw, sx, peak)
        del x, w, wq, w_t
        torch.cuda.empty_cache()
    # a stale carried amax (0.1 of the truth): saturated, finite, equal
    # to the plain version's saturated result
    x = rand(1024, MLP_D)
    wq, sw = Q.quantize_tensor(rand(MLP_D, MLP_D, scale=MLP_D ** -0.5),
                               fmt)
    stale = Q.scale_from_amax(0.1 * Q.amax_of(x), fmt)
    y, am = Q.kernel_fused_matmul(x, Q.k_major(wq), sw, stale, fmt, True)
    torch.cuda.synchronize()
    ref, _ = Q.plain_fused_matmul(x, wq, sw, stale, fmt, False)
    errs = qmm_check(torch, fmt, y, ref, f"K11 {kind} stale scale")
    fresh, _ = Q.plain_fused_matmul(x, wq, sw, Q.scale_from_amax(
        Q.amax_of(x), fmt), fmt, False)
    if torch.equal(y, fresh) or not torch.equal(am, Q.amax_of(x)):
        fail(f"K11 {kind} stale scale: output not saturated or amax "
             f"{float(am)} not fresh")
    say(f"K11 {kind} stale scale (0.1 x amax): finite, saturated, max abs "
        f"err vs plain {errs['max_abs_err']:.3e}; amax out fresh")
    return {"max_abs_err": max(worst, errs["max_abs_err"]), **out}


def qmm_times(torch, fmt, x, wq, w_t, sw, sx, peak) -> dict:
    """K11, its plain version and the library product on operands
    quantized beforehand, at [T, D] @ [D, F]."""
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    kind = "int8" if fmt == "int8" else "fp8"
    t, k = x.shape
    n = w_t.shape[0]
    xq = Q.cast_q(x.float() / sx, fmt)
    if fmt == "int8":
        def library():
            return torch._int_mm(xq, w_t.t())
    else:
        def library():
            return torch._scaled_mm(xq, w_t.t(), scale_a=sx, scale_b=sw,
                                    out_dtype=torch.bfloat16)
    y, _ = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt, False)
    lib = library()
    ref = (lib.float() * (sx * sw)).to(torch.bfloat16) if fmt == "int8" \
        else lib
    lib_err = abs_err(y, ref)
    del y, lib, ref
    ms = timed_ms(torch, lambda: Q.kernel_fused_matmul(x, w_t, sw, sx, fmt,
                                                       False))
    by_cluster = cluster_ms(torch, lambda: Q.kernel_fused_matmul(
        x, w_t, sw, sx, fmt, False))
    say(f"K11 {kind} [{t}, {k}] x [{k}, {n}] by cluster size (blocks along "
        f"N sharing one quantized x stage): "
        + ", ".join(f"c={c} {v:.4f} ms" for c, v in by_cluster.items()))
    plain_ms = timed_ms(torch, lambda: Q.plain_fused_matmul(
        x, wq, sw, sx, fmt, False), reps=5)
    library_ms = timed_ms(torch, library)
    b_ms, b_by = bound_ms(2 * t * k * n, t * k * 2 + k * n + t * n * 2,
                          peak, kind)
    say(f"K11 {kind}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} ({'torch._int_mm' if fmt == 'int8' else 'torch._scaled_mm'}, "
        f"err vs K11 {lib_err:.3e}) bound_ms {b_ms:.4f} ({b_by}) -> "
        f"{b_ms / ms:.3f} of bound, {2 * t * k * n / ms / 1e9:.1f} T/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def cluster_ms(torch, fn, set_cluster=None) -> dict:
    """fn's time under each cluster size (1, 2, 4) that set_cluster (by
    default the 8-bit kernels' setter) takes; the preferred size is
    restored after."""
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    set_cluster = set_cluster or Q.set_cluster
    out = {}
    for c in Q.CLUSTERS:
        prev = set_cluster(c)
        try:
            out[c] = timed_ms(torch, fn)
        finally:
            set_cluster(prev)
    return out


def mlp_bwd_phase(torch, peak: dict) -> dict:
    """K9 and K10 at the train step's MLP shape against their plain
    versions on the card; times beside the plain versions', one
    torch.mm each (dy . Wd^T; h^T . dy on h computed beforehand) and the
    bound."""
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    rand = seeded(torch, 31)
    t, d, f = MLP_T, MLP_D, MLP_F
    dy = rand(t, d, scale=0.1)
    wd = rand(f, d, scale=f ** -0.5)
    g, u = rand(t, f), rand(t, f)
    dg, du = MB.kernel_dgdu(dy, wd, g, u)
    dw = MB.kernel_dwd(g, u, dy)
    torch.cuda.synchronize()
    pdg, pdu = MB.plain_dgdu(dy, wd, g, u)
    pdw = MB.plain_dwd(g, u, dy)
    for name, a in (("dg", dg), ("du", du), ("dWd", dw)):
        if not torch.isfinite(a.float()).all():
            fail(f"K9/K10: {name} not finite")
    rows = {"dg": row_err(dg, pdg), "du": row_err(du, pdu),
            "dwd": row_err(dw, pdw)}
    errs = {"k9": max(abs_err(dg, pdg), abs_err(du, pdu)),
            "k10": abs_err(dw, pdw)}
    say(f"K9/K10: worst row err / row max-abs dg {rows['dg']:.3e} du "
        f"{rows['du']:.3e} (bar {DGDU_TOL_ROW:.3e}) dWd {rows['dwd']:.3e} "
        f"(bar {DWD_TOL_ROW}); max abs err K9 {errs['k9']:.3e} K10 "
        f"{errs['k10']:.3e}")
    if not (rows["dg"] <= DGDU_TOL_ROW and rows["du"] <= DGDU_TOL_ROW
            and rows["dwd"] <= DWD_TOL_ROW):
        fail(f"K9/K10 disagree with their plain versions: {rows}")
    del dg, du, dw, pdg, pdu, pdw
    h = MB.silu_parts(g.float())[0].mul_(u.float()).to(torch.bfloat16)
    runs = {
        "k9": (lambda: MB.kernel_dgdu(dy, wd, g, u),
               lambda: MB.plain_dgdu(dy, wd, g, u),
               lambda: torch.mm(dy, wd.t()),
               t * d * 2 + f * d * 2 + 4 * t * f * 2),
        "k10": (lambda: MB.kernel_dwd(g, u, dy),
                lambda: MB.plain_dwd(g, u, dy),
                lambda: torch.mm(h.t(), dy, out_dtype=torch.float32),
                2 * t * f * 2 + t * d * 2 + f * d * 4),
    }
    out = {}
    for name, (kernel, plain, library, nbytes) in runs.items():
        ms = timed_ms(torch, kernel)
        plain_ms = timed_ms(torch, plain, reps=5)
        library_ms = timed_ms(torch, library)
        b_ms, b_by = bound_ms(2 * t * d * f, nbytes, peak, "bf16")
        out[name] = {"max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms}
        say(f"{name.upper()}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {library_ms:.4f} (one torch.mm) bound_ms "
            f"{b_ms:.4f} ({b_by}) -> {b_ms / ms:.3f} of bound, "
            f"{2 * t * d * f / ms / 1e9:.1f} TFLOP/s")
    smi_sample("K9/K10 timed")
    by_cluster = cluster_ms(torch, lambda: MB.kernel_dwd(g, u, dy),
                            MB.set_dwd_cluster)
    say(f"K10 [{f}, {t}] x [{t}, {d}] by cluster size (blocks along D "
        f"sharing one h stage): "
        + ", ".join(f"c={c} {v:.4f} ms" for c, v in by_cluster.items()))
    smi_sample("K10 cluster sweep")
    return out


def gmm_counts() -> int:
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    return GM.grouped_launches


def reset_gmm_counts() -> None:
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    GM.grouped_launches = 0


def gmm_check(torch, fmt, y, ref, counts, label: str) -> dict:
    """K12 against its plain version: every row at or past an expert's
    count exactly zero; int8 bit-exact, bf16 and e4m3 by the row bar
    (e4m3 also the Frobenius bar); finite."""
    if not torch.isfinite(y.float()).all():
        fail(f"{label}: output not finite")
    for e, n in enumerate(counts.tolist()):
        if y[e, n:].count_nonzero().item():
            fail(f"{label}: expert {e} has nonzero rows at or past its "
                 f"count {n}")
    errs = {"max_abs_err": abs_err(y, ref), "row": row_err(y, ref),
            "fro": fro_err(y, ref)}
    if fmt == "int8":
        if not torch.equal(y, ref):
            fail(f"{label}: int8 kernel differs from the plain version "
                 f"(max abs err {errs['max_abs_err']:.3e}); it must be "
                 f"bit-exact")
    elif not errs["row"] <= GMM_TOL_ROW or (
            fmt == "float8" and not errs["fro"] <= E4M3_TOL_FRO):
        fail(f"{label}: row err {errs['row']:.3e} (bar {GMM_TOL_ROW:.3e}), "
             f"Frobenius {errs['fro']:.3e}")
    return errs


def gmm_phase(torch, peak: dict) -> dict:
    """K12 against its plain version at the moe_ab gate/up and down shapes
    and at mixtral width (bf16), and int8 and e4m3 at the moe_ab gate/up
    shape, each with full and with skewed counts; times at the moe_ab
    gate/up shape with full counts beside the plain version's, a library
    yardstick's and the bound."""
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    rand = seeded(torch, 41)
    full = torch.full((GMM_E,), GMM_C, dtype=torch.int32, device="cuda")
    skew = torch.tensor(GMM_SKEW, dtype=torch.int32, device="cuda")
    out = {}
    for fmt in (None, "int8", "float8"):
        kind = {None: "bf16", "int8": "int8", "float8": "e4m3"}[fmt]
        cases = GMM_CASES if fmt is None else GMM_CASES[:1]
        worst = 0.0
        for label, k, n in cases:
            x = rand(GMM_E, GMM_C, k)
            w = rand(GMM_E, k, n, scale=k ** -0.5)
            sx = sw = None
            if fmt:
                w, sw = GM.quantize_experts(w, fmt)
                sx = Q.scale_from_amax(GM.expert_amax(x), fmt)
            for cname, counts in (("full", full), ("skewed", skew)):
                y = GM.grouped_matmul(x, w, counts=counts, sx=sx, sw=sw,
                                      fmt=fmt)
                torch.cuda.synchronize()
                ref = GM.plain_grouped_matmul(x, w, counts, sx, sw, fmt)
                tag = f"K12 {kind} {label} [{GMM_E}, {GMM_C}, {k}] x [{k}, " \
                      f"{n}] {cname} counts"
                errs = gmm_check(torch, fmt, y, ref, counts, tag)
                worst = max(worst, errs["max_abs_err"])
                say(f"{tag}: max abs err {errs['max_abs_err']:.3e}, worst "
                    f"row {errs['row']:.3e}, Frobenius {errs['fro']:.3e}; "
                    f"rows past the counts zero")
                del y, ref
            if label == GMM_CASES[0][0]:
                out[kind] = {"max_abs_err": worst,
                             **gmm_times(torch, fmt, x, w, sx, sw, peak)}
            del x, w
            torch.cuda.empty_cache()
        out[kind]["max_abs_err"] = worst
    return out


def gmm_times(torch, fmt, x, w, sx, sw, peak) -> dict:
    """K12, its plain version and a library yardstick at full counts:
    bf16 one ``torch.bmm``; int8 / e4m3 the per-expert
    ``torch._int_mm`` / ``torch._scaled_mm`` products summed over the
    experts, on operands quantized beforehand."""
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    e, c, k = x.shape
    n = w.shape[2]
    kind = {None: "bf16", "int8": "int8", "float8": "fp8"}[fmt]
    if fmt is None:
        w_t = w

        def library():
            return torch.bmm(x, w)
        lib_name = "one torch.bmm"
    else:
        xq = Q.cast_q(x.float() / sx[:, None, None], fmt)
        w_t = w.transpose(1, 2).contiguous()     # K-major, made once
        if fmt == "int8":
            def library():
                return [torch._int_mm(xq[i], w_t[i].t()) for i in range(e)]
            lib_name = f"{e} torch._int_mm, summed"
        else:
            # a scale of its own per expert: cuBLASLt refuses a scale
            # pointer that is not aligned like an allocation
            sxs = [sx[i].clone() for i in range(e)]
            sws = [sw[i].clone() for i in range(e)]

            def library():
                return [torch._scaled_mm(xq[i], w_t[i].t(), scale_a=sxs[i],
                                         scale_b=sws[i],
                                         out_dtype=torch.bfloat16)
                        for i in range(e)]
            lib_name = f"{e} torch._scaled_mm, summed"
    ms = timed_ms(torch, lambda: GM.kernel_grouped_matmul(x, w_t, None, sx,
                                                          sw, fmt))
    if fmt:
        by_cluster = cluster_ms(torch, lambda: GM.kernel_grouped_matmul(
            x, w_t, None, sx, sw, fmt))
        say(f"K12 {kind} by cluster size: "
            + ", ".join(f"c={c} {v:.4f} ms" for c, v in by_cluster.items()))
    plain_ms = timed_ms(torch, lambda: GM.plain_grouped_matmul(
        x, w, None, sx, sw, fmt), reps=5)
    library_ms = timed_ms(torch, library)
    ops = 2 * e * c * k * n
    nbytes = e * c * k * 2 + e * k * n * w.element_size() + e * c * n * 2
    b_ms, b_by = bound_ms(ops, nbytes, peak, kind)
    say(f"K12 {kind}: kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
        f"library_ms {library_ms:.4f} ({lib_name}) bound_ms {b_ms:.4f} "
        f"({b_by}) -> {b_ms / ms:.3f} of bound, {ops / ms / 1e9:.1f} T/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def moe_quant_phase(torch) -> dict:
    """The quantized grouped expert FFN (``moe.moe_grouped(quant=...)``,
    the JAX package's route to the int8 / e4m3 grouped kernels) at the
    moe_ab width, forward and backward once per format: finite, K12
    launched 3 times, and within ``MOE_QUANT_TOL`` (relative Frobenius)
    of the bf16 grouped layer on the same inputs."""
    from dlnetbench_tpu_torch.models import moe as M
    rand = seeded(torch, 51)
    t, d, f, e = 4096, 4096, 7168, GMM_E
    x = rand(t, d)
    wr, wg, wu = rand(d, e, scale=d ** -0.5), rand(e, d, f, scale=d ** -0.5), \
        rand(e, d, f, scale=d ** -0.5)
    wd = rand(e, f, d, scale=f ** -0.5)
    with torch.no_grad():
        ref = M.moe_grouped(x, wr, wg, wu, wd, 2)
    launches = {}
    for fmt in ("int8", "float8"):
        leaves = [a.detach().requires_grad_(True) for a in (x, wg, wu, wd)]
        reset_gmm_counts()
        y = M.moe_grouped(leaves[0], wr, *leaves[1:], 2, quant=fmt)
        grads = torch.autograd.grad(y.float().square().sum(), leaves)
        torch.cuda.synchronize()
        launches[fmt] = gmm_counts()
        err = fro_err(y.detach(), ref)
        if launches[fmt] != 3 or not all(torch.isfinite(g).all()
                                         for g in (y, *grads)) \
                or not err <= MOE_QUANT_TOL:
            fail(f"moe quant {fmt}: K12 launches {launches[fmt]} (want 3), "
                 f"Frobenius vs bf16 {err:.3e} (bar {MOE_QUANT_TOL}), or "
                 f"not finite")
        say(f"moe quant {fmt}: moe_grouped(quant={fmt!r}) forward + "
            f"backward finite, Frobenius vs the bf16 layer {err:.3e}; K12 "
            f"launches {launches[fmt]}")
        del y, grads, leaves
    return launches


def moe_reference_phase(torch) -> None:
    """Tiny f32 MoE model (``moe_impl="grouped"``, TF32 off), same
    weights and tokens, 2 SGD steps on the card (K12 f32, the f32 flash
    kernels) and on the CPU (plain versions).  The layer routings are
    compared first, so that a flipped expert is told apart from a
    kernel fault."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import layers as L
    from dlnetbench_tpu_torch.models import moe as M
    from dlnetbench_tpu_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ties: jax.lax.top_k puts the lower index first among equal logits,
    # and the router keeps that order through a stable sort; on the card
    # that rests on torch.sort's stability there.  An all-zero token row
    # (every logit 0) and one whose logits tie in pairs (duplicated
    # router columns)
    gen = torch.Generator()
    gen.manual_seed(11)
    wr = torch.randn(256, 8, generator=gen)
    wr[:, 1], wr[:, 5] = wr[:, 0], wr[:, 2]
    xt = torch.zeros(2, 256)
    xt[1] = torch.randn(256, generator=gen)
    cw, ci = L.moe_router(xt, wr, 2)
    gw, gi = L.moe_router(xt.cuda(), wr.cuda(), 2)
    if gi[0].tolist() != [0, 1] or not torch.equal(gi.cpu(), ci) \
            or not torch.allclose(gw.cpu(), cw, rtol=0, atol=1e-6):
        fail(f"moe router ties: card chose {gi.tolist()}, CPU "
             f"{ci.tolist()}; an all-zero row must give [0, 1]")
    say(f"moe router ties: an all-zero row routes to {gi[0].tolist()} on the "
        f"card (jax.lax.top_k's order), a tied row to {gi[1].tolist()} as "
        f"on the CPU")
    cfg = T.TransformerConfig(vocab_size=256, embed_dim=256, num_heads=2,
                              num_kv_heads=1, ff_dim=128, num_layers=2,
                              seq_len=128, dtype="float32", logits_f32=False,
                              num_experts=4, top_k=2, moe_impl="grouped")
    cpu = T.init_params(cfg, seed=9, device="cpu")
    gpu = {k: ({n: w.cuda() for n, w in v.items()}
               if isinstance(v, dict) else v.cuda())
           for k, v in cpu.items()}
    gen = torch.Generator()
    gen.manual_seed(10)
    tokens = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len + 1),
                           generator=gen)
    route = M.route
    seen = []

    def recording(*a, **kw):
        out = route(*a, **kw)
        seen.append(out[0].idx.cpu())
        return out
    M.route = recording
    try:
        with torch.no_grad():
            T.loss_fn(cpu, tokens, cfg)
            T.loss_fn(gpu, tokens.cuda(), cfg)
    finally:
        M.route = route
    half = len(seen) // 2
    same = all(torch.equal(a, b) for a, b in zip(seen[:half], seen[half:]))
    say(f"moe reference: expert indices of the {half} layers "
        f"{'EQUAL' if same else 'DIFFER'} on the card and on the CPU")
    if not same:
        fail("moe reference: a routing flip between card and CPU (router "
             "logits differ near a tie), not a kernel fault")
    step = BS.make_train_k(cfg, 2)
    reset_gmm_counts()
    gpu, gpu_losses = step(gpu, tokens.cuda())
    torch.cuda.synchronize()
    launches = gmm_counts()
    cpu, cpu_losses = step(cpu, tokens)
    gl = gpu_losses.cpu()
    if launches != 3 * cfg.num_layers * 2:
        fail(f"moe reference: K12 launches {launches}, want "
             f"{3 * cfg.num_layers * 2}")
    if not torch.allclose(gl, cpu_losses, rtol=MOE_REF_TOL, atol=0):
        fail(f"moe reference: card losses {gl.tolist()} vs CPU "
             f"{cpu_losses.tolist()}")
    worst = 0.0
    for c, g in zip(BS.leaves(cpu), BS.leaves(gpu)):
        worst = max(worst, float((g.cpu() - c).abs().max()
                                 / c.abs().max().clamp_min(1e-30)))
    if not worst <= MOE_REF_TOL:
        fail(f"moe reference: a parameter differs by {worst:.3e} of its "
             f"leaf's max-abs (bar {MOE_REF_TOL})")
    say(f"moe reference: 2 f32 SGD steps, losses card {gl.tolist()} CPU "
        f"{cpu_losses.tolist()}; worst parameter {worst:.3e} of its leaf's "
        f"max-abs (bar {MOE_REF_TOL}); K12 f32 launches {launches}")


def mixtral_phase(torch) -> dict:
    """A mixtral_8x7b-width train step (the card's own dims, 2 layers,
    S=2048, B=2, its vocab 32000), ``moe_impl="grouped"`` against
    ``"sparse"`` on the same weights and tokens: first losses, ms a step,
    the layer-0 routing stats and K12's launches."""
    import dataclasses

    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    card = load_model_card("mixtral_8x7b")
    base = T.TransformerConfig.from_card(card, num_layers=2, seq_len=2048)
    steps, b = 3, 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    tokens = torch.randint(0, base.vocab_size, (b, base.seq_len + 1),
                           generator=gen, device="cuda")
    params = T.init_params(base, seed=0, device="cuda")
    info = bench.router_probe(params, tokens[:, :-1], base)
    res = {}
    for impl in ("sparse", "grouped"):
        cfg = dataclasses.replace(base, moe_impl=impl)
        p = {k: ({n: w.clone() for n, w in v.items()}
                 if isinstance(v, dict) else v.clone())
             for k, v in params.items()}
        first = float(T.loss_fn(p, tokens, cfg).detach())
        BS.make_train_k(cfg, 1)(p, tokens)            # warm
        torch.cuda.synchronize()
        reset_gmm_counts()
        t0 = time.perf_counter()
        p, losses = BS.make_train_k(cfg, steps)(p, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        res[impl] = {"loss": first, "ms": ms, "launches": gmm_counts(),
                     "losses": losses.cpu().tolist()}
        del p
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    ln_v = math.log(base.vocab_size)
    ls, lg = res["sparse"]["loss"], res["grouped"]["loss"]
    want = 3 * base.num_layers * steps
    if not (math.isfinite(ls) and math.isfinite(lg)
            and abs(ls - ln_v) < 1.5 and abs(lg - ln_v) < 1.5
            and abs(lg - ls) <= MIXTRAL_TOL_LOSS * abs(ls)):
        fail(f"mixtral: first losses grouped {lg} sparse {ls} (bar "
             f"{MIXTRAL_TOL_LOSS} relative, within 1.5 of ln V {ln_v:.3f})")
    if res["grouped"]["launches"] != want or res["sparse"]["launches"]:
        fail(f"mixtral: K12 launches grouped {res['grouped']['launches']} "
             f"(want {want}), sparse {res['sparse']['launches']} (want 0)")
    say(f"mixtral_8x7b width (d {card.embed_dim}, {card.num_heads}/"
        f"{card.kv_heads} heads, {base.num_experts} experts of ff "
        f"{base.ff_dim}, top-{base.top_k}, 2 layers, B={b} S="
        f"{base.seq_len}, vocab {base.vocab_size}): first loss grouped "
        f"{lg!r} sparse {ls!r}; ms/step grouped {res['grouped']['ms']:.2f} "
        f"sparse {res['sparse']['ms']:.2f} ({steps} chained steps after a "
        f"warm one); losses grouped {res['grouped']['losses']} sparse "
        f"{res['sparse']['losses']}; K12 launches {want} = 3 x 2 layers x "
        f"{steps} steps; layer-0 routing {json.dumps(info['moe'])}")
    return res


def quant_train_phase(torch) -> dict:
    """The quantized and fused-backward train steps at the bench shape,
    through ``bench_step.build`` with the JAX package's overrides; the
    launch counters are reset before and read after each run."""
    import dataclasses

    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    layers = BS.LAYERS
    launches = {}

    def run(steps: int, **overrides):
        train_k, carry, tokens, _, cfg = BS.build(steps, **overrides)
        reset_mlp_counts()
        carry, losses = train_k(carry, tokens)
        torch.cuda.synchronize()
        counts = mlp_counts()
        losses = losses.cpu()
        if not torch.isfinite(losses).all():
            fail(f"quant train {overrides}: losses {losses.tolist()}")
        return carry, tokens, cfg, losses, counts

    # int8 composed vs fused: the same recipe, so the first loss is
    # bitwise equal; K11 launched 3 x layers a step in the fused run only
    steps = 2
    losses = {}
    for fusion in ("composed", "fused"):
        _, _, _, losses[fusion], counts = run(steps, mlp_dtype="int8",
                                              quant_fusion=fusion)
        want = 3 * layers * steps if fusion == "fused" else 0
        if counts != {"k11": want, "k9": 0, "k10": 0}:
            fail(f"quant train int8 {fusion}: launches {counts}, want K11 "
                 f"{want}")
        launches["k11_int8"] = launches.get("k11_int8", 0) + counts["k11"]
        torch.cuda.empty_cache()
    if losses["composed"][0].item() != losses["fused"][0].item():
        fail(f"quant train: int8 fused first loss {losses['fused'][0]!r} "
             f"!= composed {losses['composed'][0]!r} (must be bitwise)")
    say(f"quant train int8: composed losses {losses['composed'].tolist()}, "
        f"fused {losses['fused'].tolist()} (first bitwise equal); K11 "
        f"{launches['k11_int8']} = 3 x {layers} layers x {steps} steps")

    # e4m3 fused with delayed scaling: the state moves off its ones and
    # then holds still on the same batch
    steps = 3
    (params, qs), tokens, cfg, l1, counts = run(
        steps, mlp_dtype="float8", quant_fusion="fused",
        quant_scaling="delayed")
    if counts["k11"] != 3 * layers * steps:
        fail(f"quant train e4m3 delayed: K11 launches {counts['k11']}")
    launches["k11_e4m3"] = counts["k11"]
    qs1 = qs.clone()
    (_, qs), l2 = BS.make_train_k(cfg, 1)((params, qs), tokens)
    torch.cuda.synchronize()
    drift = float((qs / qs1 - 1).abs().max())
    if not (torch.isfinite(qs1).all() and bool((qs1 != 1).all())
            and torch.isfinite(l2).all() and drift < 0.05):
        fail(f"quant train e4m3 delayed: qstate {qs1.tolist()} -> "
             f"{qs.tolist()}, losses {l1.tolist()} {l2.tolist()}")
    say(f"quant train e4m3 fused delayed: losses {l1.tolist()} then "
        f"{l2.tolist()}; qstate {qs1.cpu().tolist()} (moved off 1.0; next "
        f"step drifts {drift:.2e}); K11 {counts['k11']}")
    del params, qs, qs1, tokens
    torch.cuda.empty_cache()

    # mlp_backward="pallas" against the autograd backward on the same
    # weights: the forward is the same, so the loss is bitwise equal
    _, params, tokens, _, cfg = BS.build(1)
    cfg_p = dataclasses.replace(cfg, mlp_backward="pallas")
    ps = BS.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss_d = T.loss_fn(params, tokens, cfg)
    grads_d = torch.autograd.grad(loss_d, ps)
    reset_mlp_counts()
    loss_p = T.loss_fn(params, tokens, cfg_p)
    grads_p = torch.autograd.grad(loss_p, ps)
    torch.cuda.synchronize()
    counts = mlp_counts()
    worst = max(float((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30))
                for a, b in zip(grads_p, grads_d))
    if loss_p.item() != loss_d.item() or worst > PALLAS_TOL_LEAF \
            or counts != {"k11": 0, "k9": layers, "k10": layers}:
        fail(f"quant train pallas: loss {loss_p.item()!r} vs "
             f"{loss_d.item()!r}, worst leaf {worst:.3e} (bar "
             f"{PALLAS_TOL_LEAF}), launches {counts}")
    del grads_d, grads_p, loss_d, loss_p
    for p in ps:
        p.requires_grad_(False)
    steps = 2
    reset_mlp_counts()
    params, lp = BS.make_train_k(cfg_p, steps)(params, tokens)
    torch.cuda.synchronize()
    counts = mlp_counts()
    if counts != {"k11": 0, "k9": layers * steps, "k10": layers * steps} \
            or not torch.isfinite(lp).all():
        fail(f"quant train pallas: {steps} steps, launches {counts}, "
             f"losses {lp.tolist()}")
    launches["k9"], launches["k10"] = counts["k9"], counts["k10"]
    say(f"quant train pallas: loss bitwise equal to autograd's, worst "
        f"gradient leaf {worst:.3e} of its max-abs (bar "
        f"{PALLAS_TOL_LEAF}); {steps} steps, losses {lp.tolist()}, K9 "
        f"{counts['k9']} K10 {counts['k10']} = {layers} layers x {steps} "
        f"steps")
    del params, tokens, ps
    torch.cuda.empty_cache()
    return launches


TRAIN_AUX_KEYS = ("fp8_mlp", "fp8_swiglu", "int8_matmul", "int8_fused_ab",
                  "fp8_fused_ab", "tuned_ab", "checkpoint_ab",
                  "serving_decode",
                  "kv_density_ab", "sampling_ab", "longcontext_ab",
                  "moe_ab", "int8_step", "int8_switchback_step",
                  "recommended_step")


def tuned_ab_check(bench, line: dict) -> int:
    """The ``tuned_ab`` line's bands, configs and search meta; returns the
    K11 launches it made: each searched projection's candidates a warm
    chain and ``ROUNDS`` measured ones (two when pruned), then the frozen
    and tuned SwiGLU chains (3 products a step) warm and ``ROUNDS``
    times, ``TUNED_AB_K`` launches or steps a chain."""
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    for var in ("tuned_ms", "frozen_ms", "ratio_tuned_vs_frozen"):
        band = line[var]
        if set(band) != {"value", "best", "band", "n"} \
                or band["n"] != bench.ROUNDS or not band["value"] > 0:
            fail(f"tuned_ab: {var} band {band}")
    chains = 0
    for stage in ("up", "down"):
        cfg, meta = line["configs"][stage], line["search"][stage]
        if set(cfg) != {"cluster"} or cfg["cluster"] not in Q.CLUSTERS \
                or not isinstance(line["band_disjoint_win"], bool):
            fail(f"tuned_ab: {stage} config {cfg}")
        if not meta.get("reused_db_record"):
            chains += ((1 + bench.ROUNDS) * meta["candidates"]
                       - (bench.ROUNDS - 2) * meta["pruned"])
    say(f"tuned_ab: tuned {line['tuned_ms']['value']} ms band "
        f"{line['tuned_ms']['band']}, frozen {line['frozen_ms']['value']} "
        f"ms band {line['frozen_ms']['band']}, ratio "
        f"{line['ratio_tuned_vs_frozen']['value']} band "
        f"{line['ratio_tuned_vs_frozen']['band']}, band-disjoint win "
        f"{line['band_disjoint_win']}; clusters {line['configs']}, prior "
        f"hits {line['db_prior_hit']}, search {line['search']}")
    return bench.TUNED_AB_K * (chains + 2 * (1 + bench.ROUNDS) * 3)


# the tuning phase's K11 shape (the bench MLP's up projection at 2048
# tokens) and its tune CLI runs
TUNE_QMM = (2048, 4096, 14336)


def tune_cli(argv: list) -> dict:
    """``python -m dlnetbench_tpu_torch.tuning tune ...``'s entry point
    in this process; returns the committed record (its last stdout
    line)."""
    import contextlib
    import io

    from dlnetbench_tpu_torch.tuning.__main__ import main as tune_main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tune_main(["tune", *argv])
    if rc != 0:
        fail(f"tuning: tune {' '.join(argv)} rc {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def tuning_phase(torch, name: str) -> None:
    """5g: the tune CLI on the card for K11 (e4m3) and K1 into a fresh
    DB, its records consulted back as hits through the real sites, every
    cluster and split held to the plain versions, then the ``tuned_ab``
    line on that DB.  The DB is switched off again after."""
    import contextlib
    import io
    import os
    import shutil

    from dlnetbench_tpu_torch import bench, tuning
    from dlnetbench_tpu_torch.core.hardware import hw_key_for_device_name
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    from dlnetbench_tpu_torch.serving import kv_cache as KV
    t0 = time.perf_counter()
    db_dir = OUT / "tuning_db"
    shutil.rmtree(db_dir, ignore_errors=True)
    dev = torch.device("cuda")
    chip = tuning.hw_key(dev)
    if chip != hw_key_for_device_name(name):
        fail(f"tuning: chip key {chip!r} for {name!r}")
    t, d, n = TUNE_QMM
    recs = {
        "quantized_matmul": tune_cli([
            "--op", "quantized_matmul", "--db", str(db_dir), "--fmt",
            "float8", "--tokens", str(t), "--d", str(d), "--n", str(n)]),
        "paged_attention": tune_cli([
            "--op", "paged_attention", "--db", str(db_dir), "--batch",
            str(B), "--heads", str(HQ), "--kv_heads", str(HKV),
            "--head_dim", str(DH), "--pages", str(PMAX), "--page_size",
            str(PAGE)])}
    for op, rec in recs.items():
        say(f"tuning: committed {json.dumps(rec)}")
        if rec["hw"] != chip or rec["op"] != op:
            fail(f"tuning: {op} record names chip {rec['hw']!r}, not this "
                 f"card's {chip!r}")
    if recs["quantized_matmul"]["meta"]["candidates"] != len(Q.CLUSTERS) \
            or recs["paged_attention"]["meta"]["candidates"] != 6:
        fail(f"tuning: candidate grids {recs}")
    rand = seeded(torch, 41)
    x = rand(t, d)
    wq, sw = Q.quantize_tensor(rand(d, n, scale=d ** -0.5), "float8")
    sx = Q.scale_from_amax(Q.amax_of(x), "float8")
    ref, _ = Q.plain_fused_matmul(x, wq, sw, sx, "float8", False)
    for c in Q.CLUSTERS:
        qmm_check(torch, "float8", Q.fused_matmul(x, wq, sw, sx,
                                                  fmt="float8", cluster=c),
                  ref, f"tuning: K11 e4m3 cluster {c}")
    q, pools, _, lengths, bt = decode_operands(torch, "bf16")
    gref = PA.gather_attention(q, *pools, lengths, bt)
    splits = [p for p in range(1, PMAX + 1) if PMAX % p == 0]
    for p in splits:
        got = PA.paged_attention(q, *pools, lengths, bt, split=p)
        if not torch.allclose(got.float(), gref.float(), rtol=TOL,
                              atol=TOL):
            fail(f"tuning: K1 split {p}: max abs err "
                 f"{abs_err(got, gref):.3e} (bar {TOL})")
    os.environ[tuning.ENV_DB_DIR] = str(db_dir)
    tuning.reset()
    try:
        y = Q.fused_matmul(x, wq, sw, sx, fmt="float8")
        qmm_check(torch, "float8", y, ref, "tuning: K11 under the tuned "
                  "cluster")
        split = KV.decode_split(B, HQ, HKV, DH, PMAX, PAGE, None, dev)
        got = KV.paged_attention_decode(q, *pools, lengths, bt, split=split)
        if not torch.allclose(got.float(), gref.float(), rtol=TOL,
                              atol=TOL):
            fail(f"tuning: K1 under the tuned split {split}: max abs err "
                 f"{abs_err(got, gref):.3e}")
        prov = tuning.provenance()
        for op, rec in recs.items():
            site = prov["sites"].get(f"{op}|{rec['key']}")
            if not site or not site["hit"] or \
                    site["config"] != rec["config"]:
                fail(f"tuning: {op} record not consulted back as a hit: "
                     f"{site}")
        if split != recs["paged_attention"]["config"][
                "pages_per_compute_block"]:
            fail(f"tuning: decode_split {split} != the record's")
        del x, wq, ref, y, q, pools, gref, got
        torch.cuda.empty_cache()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            line = bench.bench_tuned_ab(BS.bench_card(),
                                        hw_key_for_device_name(name), name,
                                        dev)
        say(f"tuning: tuned_ab line {buf.getvalue().strip()}")
        tuned_ab_check(bench, line)
        if "[ephemeral]" in line["metric"] or \
                line["db_path"] != str(db_dir / tuning.DB_FILENAME):
            fail(f"tuning: tuned_ab did not commit to the phase's DB: "
                 f"{line['db_path']}")
        held = tuning.TuningDB(db_dir).load()
        if len(held) != 4 or {r["hw"] for r in held.values()} != {chip}:
            fail(f"tuning: DB after tuned_ab holds {list(held)}")
    finally:
        os.environ.pop(tuning.ENV_DB_DIR, None)
        tuning.reset()
    torch.cuda.empty_cache()
    say(f"tuning phase: K11 clusters {list(Q.CLUSTERS)} and K1 splits "
        f"{splits} held to the plain versions; elected cluster "
        f"{recs['quantized_matmul']['config']['cluster']} at [{t}, {d}] x "
        f"[{d}, {n}] and {recs['paged_attention']['config']} at the "
        f"decode shape; {time.perf_counter() - t0:.1f} s")


def trace_events(path: Path) -> dict:
    """A merged Chrome trace's host span names, device events and
    size."""
    from dlnetbench_tpu_torch.metrics import spans
    raw = path.read_text()
    evs = json.loads(raw)["traceEvents"]
    return {"host": {e["name"] for e in evs if e.get("ph") == "X"
                     and e.get("pid") == spans.HOST_PID},
            "device": [e for e in evs if e.get("ph") == "X"
                       and e.get("pid") != spans.HOST_PID],
            "bytes": len(raw)}


def train_phase(torch) -> dict:
    """The headline train step through ``bench.main([])``."""
    import contextlib
    import io

    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step as BS
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_counts()
    reset_mlp_counts()
    reset_gmm_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts()
    splash = splash_counts()
    k11 = mlp_counts()["k11"]
    k12 = gmm_counts()
    if rc != 0:
        fail(f"train: bench rc {rc}")
    lines = [json.loads(t) for t in buf.getvalue().strip().splitlines()]
    line = lines[-1]
    for ln in lines[:-1]:
        say(f"train aux line: {json.dumps(ln)}")
    say(f"train headline: {json.dumps({k: v for k, v in line.items() if not isinstance(v, dict)})}")
    measured = [ln for ln in lines[:-1] if "skipped" not in ln]
    skipped = [ln["metric"] for ln in lines[:-1] if "skipped" in ln]
    if [ln["metric"] for ln in measured] != [line[k]["metric"]
                                             for k in TRAIN_AUX_KEYS] \
            or line["recommended_step"]["metric"] != "recommended_step" \
            or skipped != ["straggler A/B", "spmd overlap A/B"]:
        fail(f"train: aux lines {[ln.get('metric') for ln in lines]} do "
             f"not match the headline's keys {TRAIN_AUX_KEYS} with the "
             f"one-rank straggler and spmd overlap A/B lines skipped")
    for key in ("fp8_mlp", "fp8_swiglu", "int8_matmul"):
        vs = line[key]["vs_baseline"]
        if vs is None or not 0 < vs <= 1.0:
            fail(f"train: {key} share of the 8-bit peak {vs} not in "
                 f"(0, 1.0]")
    ck = line["checkpoint_ab"]
    if ck["backend"] != "dcp" or ck["save_ms"]["n"] != 12 \
            or not ck["stall_ms"]["value"] > 0:
        fail(f"train: checkpoint_ab {ck}")
    for key in ("int8_fused_ab", "fp8_fused_ab"):
        ab = line[key]
        for var in ("composed", "fused", "fused_delayed"):
            if set(ab[var]) != {"value", "best", "band", "n"} \
                    or not ab[var]["value"] > 0:
                fail(f"train: {key} {var} band {ab[var]}")
    rel = abs(line["int8_step"]["loss"] - line["loss"]) / line["loss"]
    if not rel <= 0.02:
        fail(f"train: int8_step loss {line['int8_step']['loss']} not "
             f"within 2 % of the headline's {line['loss']}")
    tuned_k11 = tuned_ab_check(bench, line["tuned_ab"])
    want_k11 = 2 * 2 * (1 + bench.ROUNDS) * bench.AB_K + tuned_k11
    if k11 != want_k11:
        fail(f"train: K11 launches {k11} != {want_k11} (2 formats x 2 "
             f"fused variants x {1 + bench.ROUNDS} chains x {bench.AB_K}, "
             f"and tuned_ab's {tuned_k11})")
    moe = line["moe_ab"]
    sh = bench.moe_ab_shape(BS.bench_card())
    for var in ("dense_ms", "moe_ms", "moe_grouped_ms"):
        if set(moe[var]) != {"value", "best", "band", "n"} \
                or not moe[var]["value"] > 0 or moe[var]["n"] != bench.ROUNDS:
            fail(f"train: moe_ab {var} band {moe[var]}")
    for var in ("ratio_moe_vs_dense", "ratio_moe_grouped_vs_dense"):
        if not moe[var]["value"] > 0:
            fail(f"train: moe_ab {var} {moe[var]}")
    if moe["moe_experts"] != sh["experts"] \
            or len(moe["moe"]["expert_load"]) != sh["experts"] \
            or not isinstance(moe["band_disjoint"], bool):
        fail(f"train: moe_ab routing globals {moe}")
    moe_steps = sh["k"] * (1 + bench.ROUNDS)
    want_k12 = 3 * sh["layers"] * moe_steps
    if k12 != want_k12:
        fail(f"train: K12 launches {k12} != {want_k12} (3 x "
             f"{sh['layers']} layers x {moe_steps} grouped-chain steps)")
    steps = (BS.env_int("DLNB_BENCH_K", 10)
             + 2 * bench.STEP_K) * (1 + bench.ROUNDS)
    # the moe_ab chains attend through the same kernels: 3 chains
    want = BS.LAYERS * steps + 3 * sh["layers"] * moe_steps
    # longcontext_ab: K chained forwards a call, a warm call and ROUNDS
    # timed ones per leg; the dense leg on K3, the three splash legs on K6
    lc_calls = bench.longcontext_shape()["k"] * (1 + bench.ROUNDS)
    if splash != {"fwd": 3 * lc_calls, "dq": 0, "dkv": 0}:
        fail(f"train: splash launches {splash} != K6 {3 * lc_calls} (3 "
             f"longcontext legs x {lc_calls} calls), K7/K8 0")
    loss = line["loss"]
    if not (math.isfinite(loss) and abs(loss - math.log(BS.VOCAB)) < 1.5):
        fail(f"train: loss {loss} not within 1.5 of ln({BS.VOCAB})")
    vs = line["vs_baseline"]
    if vs is None or not 0 < vs <= 1.05:
        fail(f"train: vs_baseline {vs} not in (0, 1.05]")
    if counts != {"fwd": want + lc_calls, "dq": want, "dkv": want}:
        fail(f"train: flash launches {counts}, want {BS.LAYERS} layers x "
             f"{steps} steps + 3 moe_ab chains x {sh['layers']} layers x "
             f"{moe_steps} steps = {want} each, and K3 {lc_calls} more "
             f"for the longcontext dense leg")
    say("train 8-bit lines (composed recipes' library products, never "
        "K11): " + "; ".join(
            f"{key} {line[key]['value']} ms, "
            f"{line[key].get('tflops_achieved', line[key].get('tops_achieved'))}"
            f" T/s, {line[key]['vs_baseline']} of the 8-bit peak"
            for key in ("fp8_mlp", "fp8_swiglu", "int8_matmul"))
        + f"; checkpoint_ab {ck['value']} of the save cost off the timed "
        f"path (stall {ck['stall_ms']['value']} ms, async "
        f"{ck['async_ms']['value']} ms, baseline "
        f"{ck['baseline_ms']['value']} ms a step, save "
        f"{ck['save_ms']['value']} ms, {ck['state_bytes']} bytes, "
        f"{ck['backend']})")
    say(f"train: {line['value']} ms/step, vs_baseline {vs}, loss {loss}; "
        f"int8_step {line['int8_step']['value']} ms (loss "
        f"{line['int8_step']['loss']}), int8_switchback_step "
        f"{line['int8_switchback_step']['value']} ms, recommended "
        f"{line['recommended_step']['recipe']}; moe_ab dense "
        f"{moe['dense_ms']['value']} ms, sparse {moe['moe_ms']['value']} ms, "
        f"grouped {moe['moe_grouped_ms']['value']} ms (ratios "
        f"{moe['ratio_moe_vs_dense']['value']} / "
        f"{moe['ratio_moe_grouped_vs_dense']['value']} vs dense); flash "
        f"launches {counts} = {BS.LAYERS} layers x {steps} steps "
        f"(headline and both int8 lines) + the moe_ab chains, warm calls "
        f"included; K11 {k11} in the A/B chains; K12 {k12} in the grouped "
        f"chain; K6 {splash['fwd']} in the longcontext splash legs; bench "
        f"wall {wall:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    say(f"train on K11 / K12: the A/B up-projection chains, int8 fused "
        f"{line['int8_fused_ab']['fused']['value']} ms, e4m3 fused delayed "
        f"{line['fp8_fused_ab']['fused_delayed']['value']} ms; the moe_ab "
        f"grouped step {moe['moe_grouped_ms']['value']} ms")
    return {"counts": counts, "k12": k12, "line": line, "splash": splash}


def entry_phase(torch) -> None:
    """The flagship forward through ``entry.entry()`` at S=1024."""
    from dlnetbench_tpu_torch import entry
    fn, (params, tokens) = entry.entry()
    reset_flash_counts()
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    counts = flash_counts()
    layers = entry.flagship_cfg().num_layers
    if tuple(logits.shape) != (1, 1024, 32768) \
            or logits.dtype != torch.float32:
        fail(f"entry: logits {tuple(logits.shape)} {logits.dtype}")
    if not torch.isfinite(logits).all():
        fail("entry: logits not finite")
    if counts != {"fwd": layers, "dq": 0, "dkv": 0}:
        fail(f"entry: flash launches {counts}, want fwd {layers}")
    say(f"entry: logits {tuple(logits.shape)} finite, std "
        f"{float(logits.std()):.3f}; flash launches {counts}")


PROXY_MODEL = "llama3_8b_16_bfloat16"
PROXY_TIME_SCALE = 0.05
PROXY_FLAGS = ["--model", PROXY_MODEL, "--buffer_dtype", "bfloat16",
               "--size_scale", "1", "--time_scale", str(PROXY_TIME_SCALE)]
MOE_MODEL, MOE_SIZE_SCALE, MOE_TIME_SCALE = \
    "mixtral_8x7b_16_bfloat16", 0.5, 0.01
PIPE = ["--num_stages", "1", "--num_microbatches", "4"]
# proxy -> (subcommand and flags, warmup, runs, per-step collectives of
# each program that issues any); at world 1 no program hops.  The
# hybrids' grad sync is one allreduce (the MoE's two); hybrid_3d adds 2
# TP allreduces a wave (2 x 4 waves); the MoE 2 x 32 layers all-to-alls
# a wave; Ulysses 4 a layer (32 layers); ring_attention at sp = 1 and
# dp = 1 issues nothing
PROXY_RUNS = {
    "dp": (["dp", *PROXY_FLAGS, "--num_buckets", "8"], 3, 5,
           {"full": {"allreduce": 8}, "comm": {"allreduce": 8}}),
    "fsdp": (["fsdp", *PROXY_FLAGS, "--num_units", "8"], 3, 5,
             {"full": {"allgather": 15, "reduce_scatter": 8},
              "comm": {"allgather": 15, "reduce_scatter": 8},
              "allgather": {"allgather": 15},
              "reduce_scatter": {"reduce_scatter": 8}}),
    "hybrid_2d": (["hybrid_2d", *PROXY_FLAGS, *PIPE], 2, 3,
                  {"full": {"allreduce": 1}, "comm": {"allreduce": 1},
                   "pp_comm": {}, "dp_comm": {"allreduce": 1}}),
    "hybrid_3d": (["hybrid_3d", *PROXY_FLAGS, *PIPE, "--tp", "1"], 2, 3,
                  {"full": {"allreduce": 17}, "comm": {"allreduce": 17},
                   "pp_comm": {}, "dp_comm": {"allreduce": 1},
                   "tp_comm": {"allreduce": 16}}),
    "hybrid_3d_moe": (["hybrid_3d_moe", "--model", MOE_MODEL,
                       "--buffer_dtype", "bfloat16", "--size_scale",
                       str(MOE_SIZE_SCALE), "--time_scale",
                       str(MOE_TIME_SCALE), *PIPE,
                       "--num_expert_shards", "1"], 2, 3,
                      {"full": {"alltoall": 512, "allreduce": 2},
                       "comm": {"alltoall": 512, "allreduce": 2},
                       "pp_comm": {}, "ep_comm": {"alltoall": 512},
                       "dp_ep_comm": {"allreduce": 2}}),
    "ring_attention": (["ring_attention", *PROXY_FLAGS, "--sp", "1"], 2, 3,
                       {"full": {}, "comm": {}, "ring_comm": {}}),
    "ulysses": (["ulysses", *PROXY_FLAGS, "--sp", "1"], 2, 3,
                {"full": {"alltoall": 128}, "comm": {"alltoall": 128},
                 "a2a_comm": {"alltoall": 128}}),
}
PROXY_TIMERS = ["runtimes", "compute_time", "barrier_time", "comm_time",
                "overlap_fraction", "energy_consumed"]
PROXY_BURN_TOL = 0.10      # compute leg vs (fwd + bwd) x time_scale
PROXY_ISSUE_MAX = 0.10     # host issue time over the fenced step
PROXY_POWER_MIN_W = 50.0   # or the card's idle draw before the phase


def proxy_counts(per_step: dict) -> dict:
    """The collectives of a program's per-step counts, every key."""
    from dlnetbench_tpu_torch.parallel import collectives as col
    return {k: per_step.get(k, 0) for k in col.COUNTS}


def proxy_bundle(torch, proxy: str, device):
    """``proxy``'s bundle at its ``PROXY_RUNS`` configuration, built
    through the proxy's own ``build`` (as the CLI builds it)."""
    from dlnetbench_tpu_torch.core.model_card import (
        arch_name_from_stats_name, load_model_card)
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import (dp, fsdp, hybrid_2d, hybrid_3d,
                                              hybrid_3d_moe, ring_attention,
                                              ulysses)
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    model = MOE_MODEL if proxy == "hybrid_3d_moe" else PROXY_MODEL
    stats = load_model_stats(model)
    card = load_model_card(arch_name_from_stats_name(model))
    cfg = (ProxyConfig(size_scale=MOE_SIZE_SCALE, time_scale=MOE_TIME_SCALE)
           if proxy == "hybrid_3d_moe"
           else ProxyConfig(size_scale=1.0, time_scale=PROXY_TIME_SCALE))
    kw = {"dtype": torch.bfloat16}
    pipe = dict(num_stages=1, num_microbatches=4, **kw)
    build = {
        "dp": lambda: dp.build(stats, 8, cfg, make_flat_mesh(device), **kw),
        "fsdp": lambda: fsdp.build(stats, 8, cfg, device, **kw),
        "hybrid_2d": lambda: hybrid_2d.build(stats, card, cfg, device,
                                             **pipe),
        "hybrid_3d": lambda: hybrid_3d.build(stats, card, cfg, device, tp=1,
                                             **pipe),
        "hybrid_3d_moe": lambda: hybrid_3d_moe.build(
            stats, card, cfg, device, num_expert_shards=1, **pipe),
        "ring_attention": lambda: ring_attention.build(stats, card, cfg,
                                                       device, sp=1, **kw),
        "ulysses": lambda: ulysses.build(stats, card, cfg, device, sp=1,
                                         **kw),
    }[proxy]
    return build()


def proxy_phase(torch, card: str) -> dict:
    """The seven proxies at world 1 through ``cli.main([proxy, ...])``
    (``PROXY_RUNS``): llama3_8b_16_bfloat16's H100 stats file at full
    size and --time_scale 0.05 (the MoE proxy: mixtral_8x7b at
    --size_scale 0.5, --time_scale 0.01), bf16 buffers.  Bars: the
    record is complete, every timer present and DP's ``sum(
    bucket_bytes)`` = 2 x model_size; the run's counters equal each
    program's per-step collectives times the steps it called (full: build
    + warmup + runs; comm and each variant: build + 1 warm + runs); the
    median compute_time is within 10 % of (fwd_us + bwd_us) x
    time_scale; one full step of a bundle built again issues exactly its
    per-step collectives and returns to Python in under 10 % of its
    fenced time; energy_source is nvml and the runs' energy over their
    runtime gives a mean power between the card's idle draw (nvidia-smi,
    read before the phase; at least 50 W) and its limit.  Printed: each
    run's compute leg against the stats time and against the burn's
    plan, beside the SM clock and power NVML read after each chain.
    Returns each proxy's medians."""
    from dlnetbench_tpu_torch import cli
    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel import collectives as col
    from dlnetbench_tpu_torch.parallel import multihost
    limit_w = float(card.split(",")[-1].strip().split()[0])
    t_phase = time.perf_counter()
    idle_w = idle_draw_w()
    min_w = max(PROXY_POWER_MIN_W, idle_w)
    say(f"proxy phase: idle draw {idle_w:.1f} W before it (the power "
        f"bar's floor {min_w:.1f} W)")
    device = multihost.initialize("cuda")
    medians = {}
    for proxy, (argv, warmup, runs, per_step) in PROXY_RUNS.items():
        moe = proxy == "hybrid_3d_moe"
        stats = load_model_stats(MOE_MODEL if moe else PROXY_MODEL)
        want_compute = (stats.fwd_us + stats.bwd_us) * (
            MOE_TIME_SCALE if moe else PROXY_TIME_SCALE)
        path = OUT / f"proxy_{proxy}.jsonl"
        path.unlink(missing_ok=True)
        smi_sample(f"proxy {proxy}")
        t0 = time.perf_counter()
        col.reset_counts()
        rc = cli.main([*argv, "-w", str(warmup), "-r", str(runs), "--out",
                       str(path)])
        got = col.counts()
        wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if rc != 0 or not path.is_file():
            fail(f"proxy {proxy}: cli rc {rc}, record {path.is_file()}")
        rec = json.loads(path.read_text().strip().splitlines()[-1])
        g, row = rec["global"], rec["ranks"][0]
        variants = [k for k in per_step if k not in ("full", "comm")]
        timers = PROXY_TIMERS + [f"{v}_time" for v in variants]
        missing = [t for t in timers
                   if len(row.get(t) or []) != rec["num_runs"]]
        if rec["num_runs"] != runs or missing or len(rec["ranks"]) != 1:
            fail(f"proxy {proxy}: record incomplete: runs "
                 f"{rec['num_runs']}, missing timers {missing}")
        if proxy == "dp" and sum(g["bucket_bytes"]) != 2 * stats.model_size:
            fail(f"proxy dp: sum(bucket_bytes) {sum(g['bucket_bytes'])} != "
                 f"2 x {stats.model_size}")
        want = proxy_counts({})
        for prog, counted in per_step.items():
            calls = 1 + (warmup if prog == "full" else 1) + runs
            for k, v in counted.items():
                want[k] += v * calls
        if got != want:
            fail(f"proxy {proxy}: collectives in the cli run {got}, want "
                 f"{want}")
        med = {t: statistics.median(row[t]) for t in timers}
        medians[proxy] = med
        if abs(med["compute_time"] / want_compute - 1) > PROXY_BURN_TOL:
            fail(f"proxy {proxy}: compute_time median "
                 f"{med['compute_time']:.0f} us vs (fwd + bwd) x "
                 f"time_scale {want_compute:.0f} us (bar "
                 f"{PROXY_BURN_TOL:.0%})")
        if g.get("energy_source") != "nvml":
            fail(f"proxy {proxy}: energy_source {g.get('energy_source')}")
        # NVML's energy counter moves every ~100 ms, so one 0.36 s step
        # sees 3 or 4 of its updates: the power is all the steps' joules
        # over all their time, not a median step's
        watts = sum(row["energy_consumed"]) / (sum(row["runtimes"]) * 1e-6)
        if not min_w <= watts <= limit_w:
            fail(f"proxy {proxy}: mean power {watts:.1f} W outside "
                 f"[{min_w:.1f}, {limit_w}]")
        burn, state = row["burn"], row.get("card_state", {})
        say(f"proxy {proxy}: cli run {wall:.1f} s; medians " + ", ".join(
            f"{t} {v:.1f}" for t, v in med.items())
            + f" (us; J; overlap); {watts:.1f} W; compute leg "
            f"{med['compute_time'] / want_compute:.4f} x stats (burn "
            f"{burn['ns_per_iter']:.1f} ns an iteration); collectives "
            f"{got}; peak memory "
            f"{max(a.get('peak_memory_bytes', 0) for a in g['aot'].values()) / 1e9:.2f} GB")
        say(f"proxy {proxy}: per run, compute leg x stats "
            f"{[round(c / want_compute, 4) for c in row['compute_time']]}, "
            f"x the burn's plan "
            f"{[round(c / burn['planned_us'], 4) for c in row['compute_time']]}"
            f"; SM clock after the full / compute chain "
            f"{state.get('sm_clock_mhz')} / "
            f"{state.get('compute_sm_clock_mhz')} MHz; power "
            f"{state.get('power_w')} / {state.get('compute_power_w')} W")
        smi_sample(f"after proxy {proxy}")

        # one full step, built again: its collectives and its issue time
        bundle = proxy_bundle(torch, proxy, device)
        col.reset_counts()
        bundle.full()
        torch.cuda.synchronize()
        if col.counts() != proxy_counts(per_step["full"]):
            fail(f"proxy {proxy}: one full step issued {col.counts()}, "
                 f"want {per_step['full']}")
        shares = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bundle.full()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            shares.append((t1 - t0) / (time.perf_counter() - t0))
        share = statistics.median(shares)
        if share >= PROXY_ISSUE_MAX:
            fail(f"proxy {proxy}: issuing a step took {share:.3f} of its "
                 f"fenced time (bar {PROXY_ISSUE_MAX})")
        say(f"proxy {proxy}: one step issues {per_step['full']}; host "
            f"issue {share:.4f} of the fenced step "
            f"({[round(x, 4) for x in shares]})")
        del bundle
        torch.cuda.empty_cache()
    multihost.shutdown()
    say(f"proxy phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return medians


# model breadth (10h): K3/K4/K5 at gpt2_xl's attention (B=4, S=1024,
# 25 heads of 64, MHA, causal), the gpt2_xl train step at full width and
# depth (bf16, B=4, S=1024, tied head), its remat modes, the headline
# step with remat_scope="mlp", the vit_h train step (B=32, 224^2, patch
# 14: S=257 on the dense route) and tiny f32 GPT-2 / ViT models card vs
# CPU; the steps are plain SGD (bench_step's learning rate)
GPT2_ATTN = (4, 1024, 25, 25, 64, True)
GPT2_BATCH, VIT_BATCH, BREADTH_STEPS = 4, 32, 3
# the remat modes against the un-rematted step on the same weights: the
# first loss bitwise, every gradient leaf within 2^-6 of its max-abs (the
# recomputed forward is the same program; the backward's sums may run in
# another order)
REMAT_TOL_LEAF = 2.0 ** -6
# the tiny f32 models, card vs CPU (TF32 off): losses 1e-5 relative,
# every parameter within 1e-5 of its leaf's max-abs after 2 steps
BREADTH_REF_TOL = 1e-5
TINY_GPT2 = dict(vocab_size=257, embed_dim=128, num_heads=2, num_kv_heads=2,
                 ff_dim=256, num_layers=2, seq_len=128, gated=False,
                 max_positions=128, tied_embeddings=True, dtype="float32")
TINY_VIT = dict(image_size=32, patch_size=8, embed_dim=128, num_heads=2,
                ff_dim=256, num_layers=2, num_classes=10, dtype="float32")


def dense_calls() -> int:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    return FA.dense_attention_calls


def reset_dense_calls() -> None:
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    FA.dense_attention_calls = 0


def loss_and_grads(torch, loss_of, params) -> tuple:
    """``(loss, grads, peak GB above the allocation before the call,
    ms)`` of ``loss_of(params)`` and its gradient over the tree's leaves
    (``bench_step.leaves`` order)."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    ps = BS.leaves(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in ps:
        p.requires_grad_(True)
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return loss.detach(), grads, peak, ms


def grads_check(torch, label: str, l0, g0, l1, g1) -> str:
    """The remat bars: loss bitwise, each leaf within REMAT_TOL_LEAF of
    its max-abs; returns the worst leaf's share and the bit-equal
    count."""
    if not torch.equal(l0, l1):
        fail(f"{label}: first loss {float(l1)!r} != the un-rematted "
             f"{float(l0)!r} (bitwise)")
    worst, same = 0.0, 0
    for a, b in zip(g0, g1):
        same += int(torch.equal(a, b))
        err = float((a.float() - b.float()).abs().max())
        worst = max(worst, err / max(float(a.float().abs().max()), 1e-30))
    if not worst <= REMAT_TOL_LEAF:
        fail(f"{label}: a gradient leaf differs by {worst:.3e} of its "
             f"max-abs (bar {REMAT_TOL_LEAF:.3e})")
    return f"worst leaf {worst:.3e} of its max-abs, {same}/{len(g0)} " \
           f"leaves bit-equal"


def vit_train_k(torch, cfg, k: int):
    """``train_k(params, images, labels) -> (params, losses)``: k SGD
    steps of ``vit.loss_fn`` on one batch, updated in place as
    ``bench_step.make_train_k`` updates the decoder."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import vit as V

    def train_k(params, images, labels):
        ps = BS.leaves(params)
        losses = []
        for _ in range(k):
            for p in ps:
                p.requires_grad_(True)
            loss = V.loss_fn(params, images, labels, cfg)
            grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                for p, g in zip(ps, grads):
                    p.sub_(g.to(p.dtype) * BS.LEARNING_RATE)
            losses.append(loss.detach().to(torch.float32))
            del loss, grads
        for p in ps:
            p.requires_grad_(False)
        return params, torch.stack(losses)
    return train_k


def tree_to(tree: dict, device) -> dict:
    return {k: tree_to(v, device) if isinstance(v, dict)
            else v.to(device, copy=True) for k, v in tree.items()}


def gpt2_step_phase(torch) -> dict:
    """(b) and (c): the gpt2_xl train step, then its remat modes."""
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig.from_card(load_model_card("gpt2_xl"))
    if (cfg.num_layers, cfg.embed_dim, cfg.ff_dim, cfg.vocab_size,
            cfg.max_positions, cfg.gated, cfg.tied_embeddings) != (
                48, 1600, 6400, 50257, 1024, False, True):
        fail(f"gpt2_xl: the card gave {cfg}")
    params = T.init_params(cfg, seed=0, device="cuda")
    weights_gb = sum(p.numel() * p.element_size()
                     for p in BS.leaves(params)) / 1e9
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (GPT2_BATCH, cfg.seq_len + 1),
                           generator=gen, device="cuda")
    with torch.no_grad():
        initial = float(T.loss_fn(params, tokens, cfg))
    _, warm = BS.make_train_k(cfg, 1)(params, tokens)
    reset_flash_counts()
    reset_dense_calls()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, losses = BS.make_train_k(cfg, BREADTH_STEPS)(params, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / BREADTH_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = flash_counts()
    losses = losses.cpu()
    want = cfg.num_layers * BREADTH_STEPS
    if counts != {"fwd": want, "dq": want, "dkv": want} or dense_calls():
        fail(f"gpt2_xl step: flash launches {counts} (want {want} each), "
             f"dense route {dense_calls()} (want 0)")
    # at 48 layers, JAX's init and lr 1e-3 the loss falls on the first
    # step and then wanders (in f32 alike): every step must stay below
    # the initial loss
    if not (bool(torch.isfinite(losses).all())
            and float(losses.max()) < initial):
        fail(f"gpt2_xl step: losses {losses.tolist()} not finite and "
             f"below the initial {initial:.4f}")
    tokens_s = GPT2_BATCH * cfg.seq_len / (step_ms / 1e3)
    say(f"breadth (b) gpt2_xl train step ({cfg.num_layers} layers, D "
        f"{cfg.embed_dim}, F {cfg.ff_dim}, vocab {cfg.vocab_size}, tied, "
        f"bf16, B={GPT2_BATCH}, S={cfg.seq_len}): {step_ms:.3f} ms a step "
        f"(the mean of {BREADTH_STEPS} chained), {tokens_s:.0f} tokens/s, "
        f"peak {peak:.2f} GB allocated ({weights_gb:.2f} GB of weights, "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above "
        f"them); initial loss {initial:.4f}, warm step {float(warm[0]):.4f}"
        f", losses "
        f"{losses.tolist()}; flash launches {counts}, dense route 0")

    # (c) the remat modes on the updated weights, grads of one pass each
    def loss_of(c):
        return lambda p: T.loss_fn(p, tokens, c)
    modes = {"none": cfg, "full": dataclasses.replace(cfg, remat=True),
             "dots": dataclasses.replace(cfg, remat=True,
                                         remat_policy="dots")}
    reset_flash_counts()
    l0, g0, peak0, _ = loss_and_grads(torch, loss_of(cfg), params)
    if flash_counts()["fwd"] != cfg.num_layers:
        fail(f"gpt2_xl no remat: K3 launched {flash_counts()['fwd']}")
    peaks = {"none": peak0}
    for mode in ("full", "dots"):
        reset_flash_counts()
        l1, g1, peaks[mode], _ = loss_and_grads(torch, loss_of(modes[mode]),
                                                params)
        counts = flash_counts()
        line = grads_check(torch, f"gpt2_xl remat {mode}", l0, g0, l1, g1)
        del g1
        if counts != {"fwd": 2 * cfg.num_layers, "dq": cfg.num_layers,
                      "dkv": cfg.num_layers}:
            fail(f"gpt2_xl remat {mode}: flash launches {counts} (K3 "
                 f"twice a layer: the block's forward runs again)")
        say(f"breadth (c) remat {mode}: first loss bitwise the "
            f"un-rematted one's ({float(l0):.6f}); {line}; flash launches "
            f"{counts}")
    del g0
    torch.cuda.empty_cache()
    if not peaks["full"] < peaks["none"]:
        fail(f"gpt2_xl: remat full's peak {peaks['full']:.2f} GB is not "
             f"below no remat's {peaks['none']:.2f} GB")
    times = {}
    for mode, c in modes.items():
        BS.make_train_k(c, 1)(params, tokens)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        BS.make_train_k(c, 2)(params, tokens)
        torch.cuda.synchronize()
        times[mode] = (time.perf_counter() - t0) * 1e3 / 2
    say("breadth (c) gpt2_xl remat modes (one forward + backward: peak GB "
        "above what was resident before it, its own grads included; ms a "
        "step, one warm step then the mean of 2 chained): " + "; ".join(
            f"{m} {peaks[m]:.2f} GB {times[m]:.3f} ms" for m in modes))
    return {"counts": {k: want for k in ("fwd", "dq", "dkv")},
            "step_ms": step_ms, "tokens_s": tokens_s, "peak": peak,
            "peaks": peaks, "times": times}


def remat_mlp_phase(torch) -> None:
    """(d) ``bench_step.build(k=1, remat=True, remat_scope="mlp")``
    against ``build(k=1)`` at the headline shape: the first loss bitwise,
    every gradient leaf within REMAT_TOL_LEAF of its max-abs."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    got, ref = {}, None
    for label, kw in (("none", {}),
                      ("mlp", {"remat": True, "remat_scope": "mlp"})):
        step, params, tokens, _, cfg = BS.build(k=1, **kw)
        reset_flash_counts()
        loss, grads, peak, _ = loss_and_grads(
            torch, lambda p, c=cfg: T.loss_fn(p, tokens, c), params)
        if flash_counts()["fwd"] != cfg.num_layers:
            fail(f"headline remat {label}: K3 launched "
                 f"{flash_counts()['fwd']}, want {cfg.num_layers}")
        if ref is None:
            ref = (loss, grads)
        else:
            line = grads_check(torch, "headline remat_scope='mlp'", *ref,
                               loss, grads)
            ref = None
        del grads
        _, losses = step(params, tokens)
        if not torch.allclose(losses[0], loss.float(), rtol=1e-6, atol=0):
            fail(f"headline remat {label}: train_k's loss "
                 f"{float(losses[0])!r} != the pass's {float(loss)!r}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, tokens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got[label] = (float(loss), peak, ms)
        del params, step
        torch.cuda.empty_cache()
    say(f"breadth (d) headline step (bench_step.build(k=1)) with "
        f"remat_scope='mlp': first loss bitwise ({got['none'][0]:.6f}); "
        f"{line}; peak above the weights {got['none'][1]:.2f} -> "
        f"{got['mlp'][1]:.2f} GB; a step {got['none'][2]:.3f} -> "
        f"{got['mlp'][2]:.3f} ms (the second call of each)")


def vit_step_phase(torch) -> dict:
    """(e) the vit_h train step at full width and depth."""
    from dlnetbench_tpu_torch.core.model_card import load_model_card
    from dlnetbench_tpu_torch.models import vit as V
    cfg = V.ViTConfig.from_card(load_model_card("vit_h"))
    if (cfg.num_layers, cfg.embed_dim, cfg.head_dim, cfg.ff_dim,
            cfg.num_patches + 1, cfg.num_classes) != (32, 1280, 80, 5120,
                                                      257, 1000):
        fail(f"vit_h: the card gave {cfg}")
    params = V.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    images = torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device="cuda")
    labels = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                           device="cuda")
    vit_train_k(torch, cfg, 1)(params, images, labels)
    reset_flash_counts()
    reset_dense_calls()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, losses = vit_train_k(torch, cfg, BREADTH_STEPS)(params, images,
                                                       labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / BREADTH_STEPS
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = losses.cpu()
    flash = {**flash_counts(), **{f"splash_{k}": v
                                  for k, v in splash_counts().items()}}
    want = cfg.num_layers * BREADTH_STEPS
    if dense_calls() != want or any(flash.values()):
        fail(f"vit_h step: dense route {dense_calls()} (want {want}: one "
             f"a forward block), flash launches {flash} (want none)")
    if not bool(torch.isfinite(losses).all()):
        fail(f"vit_h step: losses {losses.tolist()}")
    images_s = VIT_BATCH / (step_ms / 1e3)
    say(f"breadth (e) vit_h train step ({cfg.num_layers} layers, D "
        f"{cfg.embed_dim}, {cfg.num_heads} heads of {cfg.head_dim}, F "
        f"{cfg.ff_dim}, S {cfg.num_patches + 1}, bf16, B={VIT_BATCH}): "
        f"{step_ms:.3f} ms a step (the mean of {BREADTH_STEPS} chained), "
        f"{images_s:.1f} images/s, peak {peak:.2f} GB; losses "
        f"{losses.tolist()}; dense route {dense_calls()}, flash launches "
        f"none")
    reset_dense_calls()
    return {"step_ms": step_ms, "images_s": images_s, "peak": peak}


def breadth_reference_phase(torch) -> None:
    """(f) tiny f32 GPT-2 (S 128, head_dim 64: the f32 kernels) and ViT
    (17 tokens: the dense route) take 2 SGD steps on the card and on the
    CPU from the same weights."""
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    from dlnetbench_tpu_torch.models import vit as V
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator()
    gen.manual_seed(9)
    gcfg = T.TransformerConfig(**TINY_GPT2)
    tokens = torch.randint(0, gcfg.vocab_size, (2, gcfg.seq_len + 1),
                           generator=gen)
    vcfg = V.ViTConfig(**TINY_VIT)
    images = torch.randn((2, 32, 32, 3), generator=gen)
    labels = torch.tensor([3, 8])
    runs = {
        "gpt2": (T.init_params(gcfg, seed=10, device="cpu"),
                 lambda p, dev: BS.make_train_k(gcfg, 2)(p, tokens.to(dev)),
                 {"fwd": 4, "dq": 4, "dkv": 4}, 0),
        "vit": (V.init_params(vcfg, seed=11, device="cpu"),
                lambda p, dev: vit_train_k(torch, vcfg, 2)(
                    p, images.to(dev), labels.to(dev)),
                {"fwd": 0, "dq": 0, "dkv": 0}, 4),
    }
    for name, (cpu, run, want_flash, want_dense) in runs.items():
        card = tree_to(cpu, "cuda")
        reset_flash_counts()
        reset_dense_calls()
        card, card_losses = run(card, "cuda")
        torch.cuda.synchronize()
        counts, dense = flash_counts(), dense_calls()
        cpu, cpu_losses = run(cpu, "cpu")
        card_losses = card_losses.cpu()
        if counts != want_flash or dense != want_dense:
            fail(f"breadth reference {name}: flash {counts} (want "
                 f"{want_flash}), dense route {dense} (want {want_dense})")
        if not torch.allclose(card_losses, cpu_losses, rtol=BREADTH_REF_TOL,
                              atol=0):
            fail(f"breadth reference {name}: card losses "
                 f"{card_losses.tolist()} vs CPU {cpu_losses.tolist()}")
        worst = 0.0
        for a, b in zip(BS.leaves(card), BS.leaves(cpu)):
            err = float((a.cpu() - b).abs().max())
            worst = max(worst, err / max(float(b.abs().max()), 1e-30))
        if not worst <= BREADTH_REF_TOL:
            fail(f"breadth reference {name}: a parameter differs by "
                 f"{worst:.3e} of its leaf's max-abs (bar "
                 f"{BREADTH_REF_TOL})")
        say(f"breadth (f) {name} tiny f32, 2 SGD steps card vs CPU: losses "
            f"{card_losses.tolist()} / {cpu_losses.tolist()}; worst "
            f"parameter {worst:.3e} of its leaf's max-abs; flash {counts}, "
            f"dense route {dense}")
    reset_dense_calls()


def breadth_phase(torch, peak: dict) -> dict:
    """10h: model breadth; returns (b)'s K3/K4/K5 launches and its
    figures."""
    t_phase = time.perf_counter()
    if dense_calls():
        fail(f"an earlier path took the dense attention route "
             f"{dense_calls()} times (every earlier path runs the kernels)")
    flash_phase(torch, GPT2_ATTN, peak, timed=True)
    torch.cuda.empty_cache()
    smi_sample("gpt2_xl step")
    gpt2 = gpt2_step_phase(torch)
    torch.cuda.empty_cache()
    remat_mlp_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("vit_h step")
    vit = vit_step_phase(torch)
    torch.cuda.empty_cache()
    breadth_reference_phase(torch)
    torch.cuda.empty_cache()
    say(f"breadth phase: {time.perf_counter() - t_phase:.1f} s")
    return {"flash": gpt2["counts"], "gpt2": gpt2, "vit": vit}


# the studies (10i): the serving study's cut plan, set through the
# module's constants (the study takes no flag for it)
STUDY_SERVING_CUT = {"SERVING_FRACTIONS": (0.25, 2.0),
                     "SERVING_SEEDS": (0,), "SERVING_REQUESTS": 40,
                     "SERVING_FAULT_FRAC": 0.25}
STUDY_BUDGET_S = 90.0


def study_records(torch, path: Path, want: int) -> list:
    """The ``want`` records a study wrote, each from this card."""
    recs = [json.loads(line) for line in path.read_text().splitlines()
            if line.strip()]
    if len(recs) != want:
        fail(f"{path}: {len(recs)} records, want {want}")
    for rec in recs:
        if rec["mesh"]["platform"] != "gpu" or \
                rec["mesh"]["device_kind"] != torch.cuda.get_device_name(0):
            fail(f"{path}: a record from {rec['mesh']}, not this card")
    return recs


def kv_density_bars(out: Path) -> bool:
    """The kv-density study's bars from its JSON: every one but the
    goodput band must hold (a failure here fails the script); returns
    whether a quantized recipe's goodput@SLO win is band-disjoint (the
    study's last bar, a wall-time verdict this script reports)."""
    from dlnetbench_tpu_torch.metrics.stats import bands_overlap
    line = json.loads((out / "kv_density_ab.json").read_text())
    ab = json.loads((out / "prefix_sharing_ab.json").read_text())
    base = line["variants"]["bf16"]["goodput_rps"]
    win = False
    for cd in ("int8", "fp8"):
        v = line["variants"][cd]
        if not v["parity_ok"]:
            fail(f"kv_density: {cd} decode parity {v['parity_max_err']}")
        if v["capacity_x"]["value"] < 1.8:
            fail(f"kv_density: {cd} capacity {v['capacity_x']} < 1.8x")
        g = v["goodput_rps"]
        win = win or (bands_overlap(base["band"], g["band"]) is False
                      and g["value"] > base["value"])
    if not (ab["lossless"] and ab["prefix_hit_rate"] > 0
            and ab["prefix_bytes_saved"] > 0):
        fail(f"kv_density: prefix sharing {ab}")
    return win


def studies_phase(torch) -> None:
    """10i: the studies through their entry points (docstring)."""
    from dlnetbench_tpu_torch.examples import dp_bucket_study, pod_study
    from dlnetbench_tpu_torch.ops import paged_attention as PA
    from dlnetbench_tpu_torch.ops import paged_attention_quant as PAQ
    t_phase = time.perf_counter()
    out = OUT / "studies"
    shutil.rmtree(out, ignore_errors=True)
    PA.launches = PAQ.launches = 0
    dense0 = dense_calls()

    t0 = time.perf_counter()
    rc = dp_bucket_study.main(["--devices", "1", "--out_dir",
                               str(out / "dp")])
    if rc != 0:
        fail(f"dp_bucket_study --devices 1: rc {rc}")
    recs = study_records(torch, out / "dp" / "records.jsonl", 3)
    say(f"studies: dp_bucket_study --devices 1 rc 0, buckets "
        f"{[r['global']['num_buckets'] for r in recs]} in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    saved = {k: getattr(pod_study, k) for k in STUDY_SERVING_CUT}
    for k, v in STUDY_SERVING_CUT.items():
        setattr(pod_study, k, v)
    try:
        rc = pod_study.main(["--serving", "--out_dir",
                             str(out / "serving")])
    finally:
        for k, v in saved.items():
            setattr(pod_study, k, v)
    if rc != 0:
        fail(f"pod_study --serving (cut plan): rc {rc}")
    recs = study_records(torch, out / "serving" / "records.jsonl", 3)
    impls = {r["global"]["serving_config"]["attn_impl"] for r in recs}
    if impls != {"gather"}:
        fail(f"pod_study --serving: attention {impls}, want the gather pin")
    say(f"studies: pod_study --serving (cut: {STUDY_SERVING_CUT}) rc 0, "
        f"attn_impl gather, in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rc = pod_study.main(["--kv_density", "--out_dir",
                         str(out / "kv_density")])
    study_records(torch, out / "kv_density" / "records.jsonl", 2)
    win = kv_density_bars(out / "kv_density")
    if rc != 0 and win:
        fail(f"pod_study --kv_density: rc {rc} with every bar held")
    say(f"studies: pod_study --kv_density rc {rc} in "
        f"{time.perf_counter() - t0:.1f} s; parity, capacity, lossless "
        f"and sharing bars held; goodput@SLO win band-disjoint: {win}"
        + ("" if win else " (the study's own verdict, a finding on this "
           "card, printed above; PERF.md section 6)"))

    if PA.launches or PAQ.launches:
        fail(f"studies: K1 {PA.launches} / K2 {PAQ.launches} launches, "
             f"want 0 (every study path pins the gather attention)")
    if dense_calls() != dense0:
        fail(f"studies: {dense_calls() - dense0} dense attention calls")
    secs = time.perf_counter() - t_phase
    say(f"studies phase: {secs:.1f} s (budget {STUDY_BUDGET_S:.0f} s"
        f"{'' if secs <= STUDY_BUDGET_S else ', OVER'}); K1/K2 0 launches")


# the native tier (10j): the seven proxies at 10a/10b's models, flags and
# scales through their binaries on --backend nccl (the MoE at
# --size_scale 0.35, the most the card holds: docstring, 10j (e))
NATIVE_PIPE = ["--num_stages", "1", "--num_microbatches", "4"]
NATIVE_RUNS = {
    "dp": ["--num_buckets", "8"],
    "fsdp": ["--num_units", "8", "--sharding_factor", "1"],
    "hybrid_2d": NATIVE_PIPE,
    "hybrid_3d": [*NATIVE_PIPE, "--tp", "1"],
    "hybrid_3d_moe": [*NATIVE_PIPE, "--num_expert_shards", "1"],
    "ring_attention": ["--sp", "1"],
    "ulysses": ["--sp", "1"],
}
NATIVE_MOE_SIZE_SCALE = 0.35
NATIVE_MOE_CARD_GB = 199.7   # the MoE's card buffers at size_scale 1
# the burn kernel vs the torch chain: max-abs within BURN_TOL of the
# chain's max-abs, from nccl_probe --burn-check's state, whose chain must
# reach BURN_BENT after 1 iteration and BURN_FLOOR after 8
BURN_TOL, BURN_BENT, BURN_FLOOR = 2.0 ** -6, 0.5, 1e-30
BURN_CAL_MS, BURN_CAL_TOL = 20.0, 0.05
# pod_study's gpt2_l bucket and forward, and one a few iterations long
BURN_SHORT_MS = (0.0007, 0.0027, 0.05)
BURN_CHECK_ITERS = (1, 2, 8)
# the start delay: SMs held for 1 ms beside the burn; with the first
# count held its cluster must start before the holder ends
BURN_HOLD_SMS = (32, 100)
BURN_TIME_MS_MAX = 0.33    # 64 iterations: a third of the one-block 0.980
BURN_SPAN_TOL = 0.05       # a record's burn span vs the compute asked
BURN_TIME_ITERS = 64       # the kernels line's timed call
BURN_SRC = "dlnetbench_tpu_torch/native/csrc/burn.cu"
BURN_REPLACES = "native/include/dlnb/stablehlo_gen.hpp:181"
NATIVE_BUDGET_S = 120.0
_native_build: dict = {}


def start_native_build() -> None:
    """Build the native tier's card flavour in a thread, beside the
    kernel phases (10j joins it)."""
    import threading

    def work():
        from dlnetbench_tpu_torch.utils import native_build
        t0 = time.perf_counter()
        try:
            _native_build["bin"] = native_build.native_bin(ROOT,
                                                           flavour="cuda")
        except Exception as e:  # reported by 10j
            _native_build["error"] = e
        _native_build["seconds"] = time.perf_counter() - t0
    th = threading.Thread(target=work, daemon=True)
    th.start()
    _native_build["thread"] = th


def native_run(bin_dir: Path, args: list, env: dict,
               timeout: float = 300) -> str:
    """A native binary's stdout; fails the script on a nonzero rc."""
    proc = subprocess.run([str(bin_dir / args[0]), *map(str, args[1:])],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    if proc.returncode != 0:
        fail(f"native {' '.join(map(str, args))}: rc {proc.returncode}\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def native_json(bin_dir: Path, args: list, env: dict,
                timeout: float = 300) -> dict:
    return json.loads(native_run(bin_dir, args, env,
                                 timeout).strip().splitlines()[-1])


def native_burn_check(torch, bin_dir: Path, env: dict,
                      iters: int) -> tuple:
    """The burn kernel against the port's torch chain from one seeded
    state after ``iters`` iterations: the max-abs difference and the
    chain's max-abs."""
    import numpy as np

    from dlnetbench_tpu_torch.proxies.burn import Burner
    out = OUT / f"burn_check_{iters}.bin"
    rep = native_json(bin_dir, ["nccl_probe", "--burn-check", iters,
                                "--seed", 11, "--out", out], env)
    raw = torch.from_numpy(np.fromfile(out, dtype="int16"))
    init = raw[:65536].view(torch.bfloat16).reshape(256, 256)
    fin = raw[65536:].view(torch.bfloat16).reshape(256, 256)
    b = Burner("cuda")
    b.state.copy_(init.cuda())
    b.eager(iters)
    err = (b.state.float() - fin.cuda().float()).abs().max().item()
    scale = b.state.float().abs().max().item()
    if not math.isfinite(scale) or \
            scale < (BURN_BENT if iters == 1 else BURN_FLOOR):
        fail(f"burn check at {iters} iterations: the chain's max-abs "
             f"{scale} (it must reach {BURN_BENT} at 1 iteration, "
             f"{BURN_FLOOR} after)")
    if not err <= BURN_TOL * scale or rep["burn"]["check_launches"] != 1:
        fail(f"burn kernel vs torch chain at {iters} iterations: max-abs "
             f"{err} (bar {BURN_TOL} x the chain's {scale}), launches "
             f"{rep['burn']['check_launches']}")
    # the bar's power: a wrong chain from the same state must miss it
    x0 = init.cuda().float()
    wrong = {"no tanh": lambda x: (x @ x / 256).clamp(-1, 1),
             "transposed": lambda x: torch.tanh(x.T @ x / 256),
             "scale 1/128": lambda x: torch.tanh(x @ x / 128),
             "zeros": lambda x: torch.zeros_like(x)}
    for name, step in wrong.items():
        x = x0
        for _ in range(iters):
            x = step(x).to(torch.bfloat16).float()
        miss = (x - b.state.float()).abs().max().item()
        if not miss > BURN_TOL * scale:
            fail(f"burn check at {iters} iterations cannot tell a chain "
                 f"with {name} from the right one (max-abs {miss})")
        say(f"native burn check, {iters} iteration(s): a chain with {name} "
            f"misses by {miss / scale:.3g} x the chain's max-abs (bar "
            f"{BURN_TOL})")
    return err, scale


def burn_span_check(label: str, rec: dict) -> float:
    """A native record's burns: their device span against the compute it
    asked for (BURN_SPAN_TOL); returns the ratio."""
    g = rec["global"]
    asked, spent = g["burn_requested_us"], g["burn_device_us"]
    ratio = spent / asked if asked > 0 else float("nan")
    if not abs(ratio - 1) <= BURN_SPAN_TOL:
        fail(f"native {label}: the burns took {spent} us on the card for "
             f"{asked} us asked (x{ratio:.4f}, bar {BURN_SPAN_TOL:.0%})")
    return ratio


def native_phase(torch, card: str, py_medians: dict, peak: dict) -> dict:
    """10j: the native tier on the card (docstring); returns the burn
    kernel's row of the kernels line."""
    from dlnetbench_tpu_torch.metrics.parser import (records_to_dataframe,
                                                     validate_record)
    from dlnetbench_tpu_torch.native_cards import chain_share
    from dlnetbench_tpu_torch.utils import native_build
    t_phase = time.perf_counter()
    out = OUT / "native"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # (a) the build, started beside the kernel phases
    th = _native_build.get("thread")
    if th is None:
        start_native_build()
        th = _native_build["thread"]
    th.join()
    if "error" in _native_build:
        fail(f"native build (cuda flavour): {_native_build['error']}")
    bin_dir = _native_build["bin"]
    # ptxas's resource lines for burn.cu's kernels: no spill allowed
    for line in (bin_dir.parent / "burn.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas {BURN_SRC}: {line.strip()}")
        spill = re.findall(r"(\d+) bytes spill", line)
        if any(int(n) for n in spill):
            fail(f"native burn: ptxas spills ({line.strip()})")
    nvcc = native_build.find_nvcc()
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True).stdout.strip().splitlines()[-1]
    env = native_build.nccl_env()
    probe = native_json(bin_dir, [
        "nccl_probe", "--burn-ms",
        ",".join(map(str, (BURN_CAL_MS, *BURN_SHORT_MS))),
        "--time-iters", BURN_TIME_ITERS,
        "--hold-sms", ",".join(map(str, BURN_HOLD_SMS))], env)
    torch_nccl = ".".join(map(str, torch.cuda.nccl.version()))
    say(f"native: cuda build {_native_build['seconds']:.1f} s (in a thread "
        f"beside the kernel phases), {nvcc_v}; NCCL {probe['nccl_version']}"
        f" from {probe['nccl_library']} (torch's {torch_nccl})")
    if probe["nccl_version"] != torch_nccl:
        fail(f"native: dlopened NCCL {probe['nccl_version']} != torch's "
             f"{torch_nccl}")
    # (b) every op and dtype, exact
    worlds = [1] + ([2] if torch.cuda.device_count() >= 2 else [])
    for w in worlds:
        rep = native_json(bin_dir, ["nccl_selftest", "--world", w], env)
        if not rep["ok"] or rep["failures"]:
            fail(f"native nccl_selftest world {w}: {rep['failures']}")
        say(f"native: nccl_selftest world {w}: {rep['checks']} checks "
            f"exact (f32, bf16, e4m3; world and split communicators)")
    # (c) the burn kernel against its plain version
    checks = {n: native_burn_check(torch, bin_dir, env, n)
              for n in BURN_CHECK_ITERS}
    err = max(e for e, _ in checks.values())
    # (d) the calibration, read by CUDA events
    burn = probe["burn"]
    req = {r["requested_ms"]: r for r in burn["requests"]}
    got = statistics.median(req[BURN_CAL_MS]["measured_ms"])
    if abs(got / BURN_CAL_MS - 1) > BURN_CAL_TOL:
        fail(f"native burn: a requested {BURN_CAL_MS} ms burn took "
             f"{req[BURN_CAL_MS]['measured_ms']} ms (bar "
             f"{BURN_CAL_TOL:.0%})")
    say(f"native burn: {burn['ns_per_iter']:.1f} ns an iteration and "
        f"{burn['fixed_ns']:.0f} ns a launch (calibrated in "
        f"{burn['calibration_s']:.2f} s); a requested "
        f"{BURN_CAL_MS} ms burn took {req[BURN_CAL_MS]['measured_ms']} ms; "
        + "; ".join(f"vs the torch chain at {n} iteration(s) max-abs {e} of "
                    f"the chain's {m}" for n, (e, m) in checks.items()))
    for ms in BURN_SHORT_MS:
        r = req[ms]
        say(f"native burn: {ms * 1e3:.1f} us asked ({r['iters']} "
            f"iterations and the spin, {r['reps']} back to back): "
            f"{[round(x * 1e3, 4) for x in r['measured_ms']]} us each by "
            f"CUDA events, {r['clock_ms'] * 1e3:.4f} us by the burn's "
            f"clock (the device timer's tick {burn['timer_tick_ns']} ns)")
        if abs(r["clock_ms"] / ms - 1) > BURN_CAL_TOL:
            fail(f"native burn: {ms * 1e3} us asked took "
                 f"{r['clock_ms'] * 1e3} us by the burn's clock (bar "
                 f"{BURN_CAL_TOL:.0%})")
    say(f"native burn: one cluster of {burn['cluster']} CTAs, "
        f"{burn['smem_bytes']} bytes of shared memory each, at most "
        f"{burn['max_active_clusters']} such clusters at once on this "
        f"card; {BURN_TIME_ITERS} iterations {burn['time_ms']:.4f} ms")
    if not burn["time_ms"] <= BURN_TIME_MS_MAX:
        fail(f"native burn: {BURN_TIME_ITERS} iterations took "
             f"{burn['time_ms']} ms (bar {BURN_TIME_MS_MAX} ms)")
    for h in burn["holds"]:
        say(f"native burn: start delay beside {h['sms']} SMs held for "
            f"{h['hold_us']:.0f} us ({h['started']} holders ran): the "
            f"burn began {h['start_delay_us']:.1f} us after the holders, "
            f"the kernel it queued behind ended at {h['wait_end_us']:.1f}")
        if h["started"] != h["sms"] or (
                h["sms"] == BURN_HOLD_SMS[0]
                and not h["start_delay_us"] < h["hold_us"]):
            fail(f"native burn: beside {h['sms']} held SMs the burn began "
                 f"{h['start_delay_us']} us after the holders "
                 f"({h['started']} ran), want before their "
                 f"{h['hold_us']} us end")
    # (e) the seven proxies on --backend nccl, world 1
    launches = 0
    for proxy, flags in NATIVE_RUNS.items():
        moe = proxy == "hybrid_3d_moe"
        path = out / f"{proxy}.jsonl"
        if moe:
            free, total = torch.cuda.mem_get_info()
            need = NATIVE_MOE_CARD_GB * NATIVE_MOE_SIZE_SCALE
            say(f"native {proxy}: {need:.1f} GB of card buffers at size "
                f"{NATIVE_MOE_SIZE_SCALE}; "
                f"the card has {free / 1e9:.1f} of {total / 1e9:.1f} GB "
                f"free")
        t0 = time.perf_counter()
        native_run(bin_dir, [
            proxy, "--model", MOE_MODEL if moe else PROXY_MODEL,
            "--world", 1, *flags, "--backend", "nccl",
            "--size_scale", NATIVE_MOE_SIZE_SCALE if moe else 1,
            "--time_scale", MOE_TIME_SCALE if moe else PROXY_TIME_SCALE,
            "--warmup", 1, "--runs", 2, "--no_topology",
            "--base_path", ROOT, "--out", path], env, timeout=600)
        wall = time.perf_counter() - t0
        rec = json.loads(path.read_text().strip().splitlines()[-1])
        validate_record(rec)
        records_to_dataframe([rec])
        g = rec["global"]
        want = {"backend": "nccl", "compute_mode": "device_burn",
                "transport": "local", "timed_copies": 0, "nccl_impl": "real"}
        bad = {k: g.get(k) for k, v in want.items() if g.get(k) != v}
        if bad:
            fail(f"native {proxy}: record fields {bad}, want {want}")
        launches += g["burn_launches"]
        span = burn_span_check(proxy, rec)
        share = chain_share(g)
        med = statistics.median(rec["ranks"][0]["runtimes"])
        py = py_medians.get(proxy, {}).get("runtimes")
        py_s = "not run" if py is None else f"{py:.1f} us"
        say(f"native {proxy}: runtime median {med:.1f} us (the Python "
            f"tier's 10a/10b run: {py_s}"
            f"{f', at size {MOE_SIZE_SCALE}' if moe else ''}"
            f"); burn {g['burn_launches']} launches, "
            f"{g['burn_iters']} iterations; {g['twins']} twins, "
            f"{g['h2d_copies']} h2d copies, "
            f"{g['timed_copies']} timed; burn span x{span:.4f} of the "
            f"{g['burn_requested_us']:.1f} us asked, chain share "
            f"{share:.4f}; {wall:.1f} s")
    # (f) the studies' native paths, cut
    from dlnetbench_tpu_torch.examples import congestion_study, pod_study
    t0 = time.perf_counter()
    rc = congestion_study.main(["--out_dir", str(out / "congestion"),
                                "--runs", "3"])
    if rc != 0:
        fail(f"congestion_study: rc {rc}")
    rep = json.loads((out / "congestion" / "report.json").read_text())
    recs = {p.stem: json.loads(p.read_text().strip().splitlines()[-1])
            for p in sorted((out / "congestion").glob("*_p0.jsonl"))}
    spans = [burn_span_check(f"congestion_study {k}", r)
             for k, r in recs.items()]
    say(f"native: congestion_study (nccl, world 1, one card) runtime "
        f"x{rep['runtime_inflation']:.3f}, barrier "
        f"x{rep['barrier_inflation']:.3f}; burn span "
        f"{[round(x, 4) for x in spans]} of the compute asked ({list(recs)}"
        f"), chain share "
        f"{[round(chain_share(r['global']), 4) for r in recs.values()]}; in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    orig = pod_study.build_plan
    pod_study.build_plan = lambda models, devices: [
        pt for pt in orig(models, devices) if pt[0] in ("dp", "fsdp")]
    try:
        rc = pod_study.main(["--tier", "native", "--backend", "nccl",
                             "--devices", "1", "--models",
                             "gpt2_l_16_bfloat16", "--runs", "2",
                             "--out_dir", str(out / "pod_study")])
    finally:
        pod_study.build_plan = orig
    if rc != 0:
        fail(f"pod_study --tier native --backend nccl: rc {rc}")
    pts = [json.loads(line) for line in (out / "pod_study" / "records.jsonl")
           .read_text().splitlines() if line.strip()]
    spans = [burn_span_check(f"pod_study {r['global']['proxy']}", r)
             for r in pts]
    say(f"native: pod_study --tier native --backend nccl --devices 1 (dp "
        f"and fsdp points) rc 0; runtime medians "
        f"{[round(statistics.median(r['ranks'][0]['runtimes']), 1) for r in pts]}"
        f" us, burn span {[round(x, 4) for x in spans]} of the compute "
        f"asked, chain share "
        f"{[round(chain_share(r['global']), 4) for r in pts]}; in "
        f"{time.perf_counter() - t0:.1f} s")
    secs = time.perf_counter() - t_phase
    say(f"native phase: {secs:.1f} s (budget {NATIVE_BUDGET_S:.0f} s"
        f"{'' if secs <= NATIVE_BUDGET_S else ', OVER'}) on {card}")
    # the kernels line: one burn of BURN_TIME_ITERS iterations; its bound
    # is their 2 x 256^3 flop each at the card's bf16 tensor-core rate
    # (bf16 operands, f32 sums)
    from dlnetbench_tpu_torch.proxies.burn import Burner
    b = Burner("cuda")
    plain = timed_ms(torch, lambda: b.eager(BURN_TIME_ITERS), reps=10)
    ops = BURN_TIME_ITERS * 2 * 256 ** 3
    nbytes = 2 * 256 * 256 * 2
    return {"name": "burn chain tanh(state @ state / 256) (one cluster of 8 "
                    "CTAs, a 128 x 64 tile each on wgmma, the bf16 state "
                    "exchanged through distributed shared memory)",
            "route": "cuda", "source": BURN_SRC, "replaces": BURN_REPLACES,
            "launches": launches, "max_abs_err": err,
            "ms": burn["time_ms"], "plain_ms": plain,
            "bound_ms": max(ops / peak["bf16"], nbytes / peak["bytes"]) * 1e3,
            "bound_by": ("operations" if ops / peak["bf16"]
                         >= nbytes / peak["bytes"] else "bytes"),
            "library_ms": None}


# the observability runs: proxy -> (flags, warmup, runs, the kinds the
# profile must hold and each one's device events a step).  At one rank
# NCCL's in-place allreduce launches no device work, so DP's profile
# holds the burn only; each of Ulysses' 128 all-to-alls is one copy or
# one SendRecv kernel
OBS_RUNS = {
    "dp": (["dp", *PROXY_FLAGS, "--num_buckets", "8", "--telemetry"], 2, 3,
           {}),
    "ulysses": (["ulysses", *PROXY_FLAGS, "--sp", "1"], 2, 3,
                {"alltoall": 128}),
}
OBS_HOST_PHASES = {"build", "warmup", "timed", "fence", "profile"}


def observability_phase(torch, card: str) -> None:
    """``cli dp`` and ``cli ulysses`` with ``--profile --trace-out``
    (``OBS_RUNS``), then a two-point in-process sweep; the bars are in
    the module docstring (10c)."""
    from dlnetbench_tpu_torch import cli, sweep
    from dlnetbench_tpu_torch.parallel import collectives as col
    t_phase = time.perf_counter()
    for proxy, (argv, warmup, runs, kinds) in OBS_RUNS.items():
        path, trace = OUT / f"obs_{proxy}.jsonl", OUT / f"obs_{proxy}.json"
        path.unlink(missing_ok=True)
        trace.unlink(missing_ok=True)
        col.reset_counts()
        t0 = time.perf_counter()
        rc = cli.main([*argv, "-w", str(warmup), "-r", str(runs),
                       "--profile", "--trace-out", str(trace), "--out",
                       str(path)])
        wall = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if rc != 0 or not path.is_file() or not trace.is_file():
            fail(f"observability {proxy}: cli rc {rc}, record "
                 f"{path.is_file()}, trace {trace.is_file()}")
        rec = json.loads(path.read_text().strip().splitlines()[-1])
        g = rec["global"]
        profile = g.get("profile")
        if not profile:
            fail(f"observability {proxy}: the record lacks profile")
        events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and e.get("pid") == 1]
        if not kernels:
            fail(f"observability {proxy}: the trace has no kernel events "
                 f"on the rank's device track")
        host = {e["name"]: e for e in events
                if e.get("pid") == 0 and e.get("ph") == "X"}
        missing = OBS_HOST_PHASES - set(host)
        if missing:
            fail(f"observability {proxy}: host phases {sorted(missing)} "
                 f"missing from the trace")
        for kind, per_step in kinds.items():
            got = (profile.get(kind) or {}).get("count", 0)
            if got != per_step:
                fail(f"observability {proxy}: profile {kind} count {got}, "
                     f"want {per_step} (the step's calls): {profile}")
        if "--telemetry" in argv:
            tele = g.get("telemetry") or {}
            if tele.get("recorded") != warmup + runs:
                fail(f"observability {proxy}: telemetry recorded "
                     f"{tele.get('recorded')}, want {warmup + runs}")
        median = statistics.median(rec["ranks"][0]["runtimes"])
        say(f"observability {proxy}: cli run {wall:.1f} s; trace "
            f"{len(events)} events, {trace.stat().st_size} bytes "
            f"({len(kernels)} kernel events); profiled step "
            f"{host['profile']['dur'] / 1e3:.1f} ms beside the untraced "
            f"median {median / 1e3:.1f} ms; profile "
            + ", ".join(f"{k} {v['count']} x {v['mean_us']:.1f} us"
                        for k, v in profile.items())
            + f"; top {g['device_top_ops'][:2]}")
    out = OUT / "obs_sweep.jsonl"
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    rc = sweep.main(["dp", "--model", PROXY_MODEL, "--out", str(out),
                     "--axis", "num_buckets=2,4", "--", "--buffer_dtype",
                     "bfloat16", "--time_scale", str(PROXY_TIME_SCALE),
                     "-w", "1", "-r", "2", "--no_topology"])
    recs = [json.loads(line) for line in out.read_text().splitlines()] \
        if out.is_file() else []
    tags = [r["global"].get("variables", {}).get("num_buckets")
            for r in recs]
    if rc != 0 or tags != ["2", "4"]:
        fail(f"observability sweep: rc {rc}, tagged records {tags}")
    say(f"observability sweep: 2 in-process points in "
        f"{time.perf_counter() - t0:.1f} s, runtime medians "
        f"{[statistics.median(r['ranks'][0]['runtimes']) / 1e3 for r in recs]}"
        f" ms")
    say(f"observability phase: {time.perf_counter() - t_phase:.1f} s on "
        f"{card}")


# the records the earlier phases write, read back by records_phase
RECORD_FILES = [*(f"proxy_{p}.jsonl" for p in PROXY_RUNS),
                *(f"obs_{p}.jsonl" for p in OBS_RUNS), "obs_sweep.jsonl",
                *(f"serve_{dt}.jsonl" for dt in ("bf16", "int8", "fp8"))]


def records_phase(torch, card: str, headline: dict) -> None:
    """The record pipeline on the records already under ``OUT`` and the
    bench's regression sentinel; the bars are in the module docstring
    (10d).  ``headline`` is the bench headline line of phase 9."""
    import contextlib
    import importlib.util
    import io

    from dlnetbench_tpu_torch import bench, sweep
    from dlnetbench_tpu_torch.analysis import attribution as A
    from dlnetbench_tpu_torch.analysis.bandwidth import bus_factor
    from dlnetbench_tpu_torch.core.hardware import (HARDWARE,
                                                    hw_key_for_device_name)
    from dlnetbench_tpu_torch.metrics.merge import merge_records
    from dlnetbench_tpu_torch.metrics.parser import (load_records,
                                                     validate_record)
    import pandas

    from dlnetbench_tpu_torch.analysis.bandwidth import bandwidth_summary
    from dlnetbench_tpu_torch.metrics.parser import records_to_dataframe
    t_phase = time.perf_counter()
    say(f"records: pandas {pandas.__version__}; matplotlib "
        f"{'importable' if importlib.util.find_spec('matplotlib') else 'absent'}"
        f" (the plot functions are held on the CPU)")
    records = {}
    for name in RECORD_FILES:
        path = OUT / name
        if not path.is_file():
            fail(f"records: {name} missing")
        recs = load_records(path)
        if not recs:
            fail(f"records: {name} holds no record")
        for i, rec in enumerate(recs):
            label = f"{name}[{i}]" if len(recs) > 1 else name
            try:
                validate_record(rec)
            except ValueError as e:
                fail(f"records {label}: {e}")
            g = rec["global"]
            attr = g.get("attribution")
            if not isinstance(attr, dict):
                fail(f"records {label}: no global.attribution")
            fr = attr["fractions"]
            if abs(sum(fr.values()) - 1.0) > 1e-3 \
                    or set(fr) != set(A.RESOURCES):
                fail(f"records {label}: fractions {fr} do not sum to 1")
            if attr["bound"] not in A.BOUNDS:
                fail(f"records {label}: bound {attr['bound']!r} not in "
                     f"{A.BOUNDS}")
            inputs = attr.get("inputs") or {}
            if inputs.get("compute_basis") != "measured":
                fail(f"records {label}: compute_basis "
                     f"{inputs.get('compute_basis')!r} != 'measured'")
            if len(rec["ranks"]) == 1:
                if g.get("transport") != "local" \
                        or inputs.get("transport", "local") != "local":
                    fail(f"records {label}: world 1 transport "
                         f"{g.get('transport')!r} / "
                         f"{inputs.get('transport')!r} != 'local'")
                if "comm" in (attr.get("achieved") or {}):
                    fail(f"records {label}: world 1 carries achieved.comm "
                         f"{attr['achieved']['comm']}")
            model = g.get("comm_model") or {}
            bus = {t: [bus_factor(c["kind"], c["group"]) for c in cs]
                   for t, cs in model.items()}
            say(f"records {label}: bound {attr['bound']}, fractions {fr}, "
                f"time {inputs.get('time_us')} us, hw {inputs.get('hw')}, "
                f"transport {g.get('transport')}; comm_model bus factors "
                f"{bus}")
            records[label] = rec
    dp = records["proxy_dp.jsonl"]
    if dp["global"]["attribution"]["bound"] != "sm":
        fail(f"records: DP's verdict "
             f"{dp['global']['attribution']['bound']!r} != 'sm'")
    tally = sweep.bound_tally(str(OUT / "obs_sweep.jsonl"), io.StringIO())
    if not tally or "n/a" in tally:
        fail(f"records: the sweep's bound tally {tally}")
    merged = merge_records([dp])
    if merged["ranks"] != dp["ranks"] \
            or merged["global"]["attribution"] != dp["global"]["attribution"]:
        fail("records: merging the world-1 DP record changed its rows or "
             "its verdict")
    frame = records_to_dataframe(list(records.values()))
    if frame["attr_bound"].isna().any() \
            or len(frame) != sum(len(r["ranks"]) * r["num_runs"]
                                 for r in records.values()):
        fail(f"records: the DataFrame's rows or attr_bound "
             f"{frame['attr_bound'].value_counts(dropna=False).to_dict()}")
    bw = bandwidth_summary(list(records.values()))
    for row in bw.itertuples():
        say(f"records bandwidth {row.section} {row.collective}: "
            f"{row.msg_bytes:.0f} B in {row.time_us:.1f} us, algbw "
            f"{row.algbw_GBps:.2f} GB/s ({row.transport}, {row.attr_bound})")
    say(f"records: {len(records)} records attributed, {len(frame)} "
        f"DataFrame rows; sweep tally {tally}; the DP record merges to "
        f"itself (bound {merged['global']['attribution']['bound']})")

    def check(baseline: dict, label: str) -> tuple[int, dict]:
        path = OUT / f"bench_baseline_{label}.jsonl"
        path.write_text(json.dumps(baseline) + "\n")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--skip-aux", "--check", str(path)])
        torch.cuda.synchronize()
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        say(f"records: bench --check {label}: rc {rc} in "
            f"{time.perf_counter() - t0:.1f} s; headline {line['value']} ms "
            f"(band {line['band']}); sentinel "
            f"{json.dumps(line.get('sentinel'))}")
        return rc, line

    rc, line = check(headline, "own")
    if rc != 0 or not isinstance(line.get("sentinel"), dict) \
            or line["sentinel"].get("verdict") != "clean":
        fail(f"records: bench --check against this run's headline: rc "
             f"{rc}, sentinel {line.get('sentinel')}")
    halved = {**headline, "value": headline["value"] / 2,
              "band": [v / 2 for v in headline["band"]]}
    rc3, line3 = check(halved, "halved")
    if rc3 != 3 or "headline" not in line3["sentinel"].get("regressions",
                                                          []):
        fail(f"records: bench --check against the halved baseline: rc "
             f"{rc3}, sentinel {line3.get('sentinel')}")
    attr = line.get("attribution") or {}
    hw = HARDWARE[hw_key_for_device_name(torch.cuda.get_device_name(0))
                  or "h100_sxm"]
    frac = (attr.get("achieved") or {}).get("sm", {}).get("frac")
    want = line["tflops_achieved"] * 1e12 / hw.peak("bfloat16")
    if (attr.get("inputs") or {}).get("hw") != hw.name or frac is None \
            or abs(frac - want) > 1e-4:
        fail(f"records: the headline's block {attr} (want inputs.hw "
             f"{hw.name!r} and achieved.sm.frac {want:.4f})")
    say(f"records: headline attribution {json.dumps(attr)}")
    say(f"records phase: {time.perf_counter() - t_phase:.1f} s on {card}")


# the resilience phase: cli dp at world 1, cut to a small state (no kernel
# on this path: the burn and NCCL's one-rank allreduce)
FAULT_FLAGS = ["dp", "--model", PROXY_MODEL, "--buffer_dtype", "bfloat16",
               "--num_buckets", "8", "--size_scale", "0.01",
               "--time_scale", "0.005", "--no_topology", "-w", "1", "-r", "6"]
FAULT_DELAY_US = 20000.0
FAULT_DELAY_TOL = 0.10     # the runtime's inflation against the delay
CRASH = {"kind": "crash", "ranks": [0], "iteration": 5}
# steps 0-4, the crash at 5, then after the retry 6 (warmup), 7 and 8:
# every 2 steps a save after steps 1, 3 and 7
CKPT_SAVED = [1, 3, 7]
WATCHDOG_DEADLINE_S = 0.2
SPIN_CYCLES = 2_000_000_000     # ~1 s of device time at 1.98 GHz


def fault_run(name: str, extra: list) -> dict:
    """One ``cli dp`` run of the faults phase; its record."""
    from dlnetbench_tpu_torch import cli
    path = OUT / f"fault_{name}.jsonl"
    path.unlink(missing_ok=True)
    rc = cli.main([*FAULT_FLAGS, *extra, "--out", str(path)])
    if rc != 0 or not path.is_file():
        fail(f"faults {name}: cli rc {rc}, record {path.is_file()}")
    return json.loads(path.read_text().strip().splitlines()[-1])


def restore_check(torch) -> None:
    """A snapshot of a DP bundle's state on the card, taken after a step
    and restored after two more steps and an update of every leaf in
    place (the proxy's burn state settles at a fixed point, and its
    allreduced zero buckets stay zero): equal to the state at the saved
    step bit for bit, for npz and dcp, stall and async."""
    import shutil

    from dlnetbench_tpu_torch.core.model_stats import load_model_stats
    from dlnetbench_tpu_torch.parallel import multihost
    from dlnetbench_tpu_torch.parallel.mesh import make_flat_mesh
    from dlnetbench_tpu_torch.proxies import dp
    from dlnetbench_tpu_torch.proxies.base import ProxyConfig
    from dlnetbench_tpu_torch.utils.checkpoint import (SnapshotCheckpointer,
                                                       flatten)
    device = multihost.initialize("cuda")
    bundle = dp.build(load_model_stats(PROXY_MODEL), 8,
                      ProxyConfig(size_scale=0.01, time_scale=0.005),
                      make_flat_mesh(device), dtype=torch.bfloat16)

    def bits(t):
        return t.view(torch.int16) if t.element_size() == 2 else t

    for backend in ("npz", "dcp"):
        for mode in ("stall", "async"):
            d = OUT / f"fault_restore_{backend}_{mode}"
            shutil.rmtree(d, ignore_errors=True)
            sc = SnapshotCheckpointer(d, bundle.state, every=1, mode=mode,
                                      backend=backend)
            bundle.full()
            sc.on_step(0)
            saved = [t.clone() for t in flatten(bundle.state)]
            bundle.full()
            bundle.full()
            for t in flatten(bundle.state):
                t.add_(1)
            torch.cuda.synchronize()
            if any(torch.equal(bits(a), bits(b))
                   for a, b in zip(flatten(bundle.state), saved)):
                fail(f"faults restore: a leaf did not move after the save "
                     f"({backend}, {mode})")
            sc.wait()
            restored, step = sc.restore(bundle.state)
            same = [torch.equal(bits(a), bits(b))
                    for a, b in zip(flatten(restored), saved)]
            if step != 0 or not all(same):
                fail(f"faults restore ({backend}, {mode}): step {step}, "
                     f"leaves equal {same}")
            say(f"faults restore ({backend}, {mode}): {len(saved)} leaves, "
                f"{sc.state_bytes} bytes, bitwise the state at the saved "
                f"step; save {sc.checkpoint_ms[0]:.1f} ms, in the step "
                f"{sc.stall_ms[0]:.1f} ms")
    del bundle
    multihost.shutdown()


def faults_phase(torch, card: str) -> None:
    """The resilience layer at world 1 on the card, through ``cli.main``
    (``FAULT_FLAGS``) and the checkpoint and watchdog APIs; the bars are
    in the module docstring (10e)."""
    import shutil

    from dlnetbench_tpu_torch.metrics import telemetry
    from dlnetbench_tpu_torch.utils.watchdog import StepWatchdog
    t_phase = time.perf_counter()
    # (a) a delay from the fourth timed run on: inside the timed window
    plan = {"events": [{"kind": "delay", "ranks": [0], "iteration": 4,
                        "magnitude_us": FAULT_DELAY_US}]}
    rec = fault_run("delay", ["--fault", json.dumps(plan)])
    row = rec["ranks"][0]
    rt = row["runtimes"]
    inflation = statistics.median(rt[3:]) - statistics.median(rt[:3])
    if row.get("fault_delay_us") != [0.0] * 3 + [FAULT_DELAY_US] * 3 \
            or abs(inflation / FAULT_DELAY_US - 1) > FAULT_DELAY_TOL:
        fail(f"faults delay: fault_delay_us {row.get('fault_delay_us')}, "
             f"runtimes {rt}: inflation {inflation:.0f} us against "
             f"{FAULT_DELAY_US:.0f} (bar {FAULT_DELAY_TOL:.0%})")
    say(f"faults delay: runtime median {statistics.median(rt[:3]):.0f} -> "
        f"{statistics.median(rt[3:]):.0f} us, inflation "
        f"{inflation / FAULT_DELAY_US:.4f} x the {FAULT_DELAY_US:.0f} us "
        f"delay; compute leg {statistics.median(row['compute_time']):.0f}"
        f" us")
    # (b) a crash under retry finishes every run
    rec = fault_run("retry", ["--fault", json.dumps(
        {"policy": "retry", "events": [CRASH]})])
    g = rec["global"]
    if g.get("fault_retries") != 1 or rec["num_runs"] != 6 \
            or len(rec["ranks"][0]["runtimes"]) != 6:
        fail(f"faults retry: fault_retries {g.get('fault_retries')}, runs "
             f"{rec['num_runs']}")
    say(f"faults retry: 6 runs, fault_retries 1, detection "
        f"{g['detection_ms']} ms, recovery {g['recovery_ms']} ms")
    # (c) a crash under fail_fast ends the process with RankFailure
    proc = subprocess.run(
        [sys.executable, "-m", "dlnetbench_tpu_torch.cli", *FAULT_FLAGS,
         "--fault", json.dumps({"events": [CRASH]})], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    if proc.returncode == 0 or "RankFailure" not in proc.stderr:
        fail(f"faults fail_fast: rc {proc.returncode}, stderr tail "
             f"{proc.stderr[-800:]}")
    say(f"faults fail_fast: rc {proc.returncode}, "
        f"{proc.stderr.strip().splitlines()[-1]}")
    # (d) checkpoints under retry: npz and dcp, stall and async
    for backend in ("npz", "dcp"):
        for mode in ("stall", "async"):
            d = OUT / f"fault_ck_{backend}_{mode}"
            shutil.rmtree(d, ignore_errors=True)
            rec = fault_run(f"ckpt_{backend}_{mode}", [
                "--fault", json.dumps({"policy": "retry",
                                       "events": [CRASH]}),
                "--checkpoint_dir", str(d), "--checkpoint_every", "2",
                "--checkpoint_mode", mode, "--checkpoint_backend", backend])
            g = rec["global"]
            want = [f"{s}.npz" if backend == "npz" else str(s)
                    for s in CKPT_SAVED]
            names = sorted(p.name for p in d.iterdir())
            if g.get("checkpoint_saves") != len(CKPT_SAVED) \
                    or g.get("checkpoint_backend") != backend \
                    or names != sorted(want):
                fail(f"faults checkpoint ({backend}, {mode}): saves "
                     f"{g.get('checkpoint_saves')}, on disk {names}")
            say(f"faults checkpoint ({backend}, {mode}): saves after steps "
                f"{CKPT_SAVED}, {g['checkpoint_state_bytes']} bytes, save "
                f"median {g['checkpoint_ms']} ms, in the step "
                f"{g['checkpoint_stall_ms']} ms; runtime median "
                f"{statistics.median(rec['ranks'][0]['runtimes']):.0f} us")
    restore_check(torch)
    # (e) the watchdog fires while the host waits on a device spin
    flight = OUT / "fault_flight"
    shutil.rmtree(flight, ignore_errors=True)
    telemetry.enable(capacity=16, dump_dir=flight)
    try:
        telemetry.record_step("proxy", step=0, step_wall_us=0.0)
        wd = StepWatchdog(WATCHDOG_DEADLINE_S, name="device_spin")
        t0 = time.perf_counter()
        with wd:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        spin = time.perf_counter() - t0
    finally:
        telemetry.disable()
    if wd.stalls != 1 or not (flight / "flight_stall.json").is_file() \
            or spin <= WATCHDOG_DEADLINE_S:
        fail(f"faults watchdog: {wd.stalls} stalls over a {spin:.2f} s "
             f"device spin (deadline {WATCHDOG_DEADLINE_S} s), dump "
             f"{(flight / 'flight_stall.json').is_file()}")
    say(f"faults watchdog: fired once during a {spin:.2f} s device spin "
        f"(deadline {WATCHDOG_DEADLINE_S} s), flight_stall.json written")
    say(f"faults phase: {time.perf_counter() - t_phase:.1f} s on {card}")


SPMD_CARD_STEP = dict(vocab_size=512, embed_dim=256, num_heads=4,
                      num_kv_heads=4, ff_dim=512, seq_len=256, num_layers=2,
                      batch=4, num_microbatches=2)
SPMD_TOL = 1e-5
# each leaf's update (new - initial), card against CPU: within 1e-3 of
# the update's max-abs, plus one f32 ulp of the leaf's largest value
# (p - lr * g rounds at the leaf's ulp on each side), as
# tests/test_torch_spmd.py holds the port's update to JAX's
SPMD_UPDATE_TOL = 1e-3
SPMD_TIMED_STEPS = 6
# dryrun_multichip(1): megatron, ring and Ulysses, one step each, and
# two steps (reference and variant) for each MoE parity stage
SPMD_MOE_STAGES = ("moe_a2a=decomposed", "moe_ffn_impl=grouped",
                   "moe_a2a=decomposed+grouped")
SPMD_DRYRUN_STEPS = 3 + 2 * len(SPMD_MOE_STAGES)
SPMD_QUANTS = (("bf16", "none"), ("int8", "int8"), ("e4m3", "float8"))


def spmd_reference_phase(torch) -> None:
    """10g (a): the tiny f32 SPMD step on mesh (1, 1, 1), TF32 off, on
    the card and on the CPU from the same weights and tokens, in each
    sp_mode with the einsum and the grouped expert FFN: the loss within
    1e-5 relative, every updated leaf within 1e-5 of its max-abs and
    its update (new - initial) within 1e-3 of the update's max-abs plus
    one ulp of the leaf; K3/K4/K5 launched layers x ticks and K12 (f32)
    3 x layers x ticks under ``grouped``."""
    import numpy as np

    from dlnetbench_tpu_torch.models import spmd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    per = SPMD_CARD_STEP["num_layers"] * SPMD_CARD_STEP["num_microbatches"]
    worst, worst_upd = 0.0, (0.0, "")
    for sp_mode in ("megatron", "ring", "ulysses"):
        for ffn in ("einsum", "grouped"):
            cfg = spmd.SpmdConfig(**SPMD_CARD_STEP, sp_mode=sp_mode,
                                  moe_ffn_impl=ffn)
            reset_flash_counts()
            reset_gmm_counts()
            (l_card,), card_tree = spmd.run_one_rank(cfg, "cuda")
            counts, k12 = flash_counts(), gmm_counts()
            (l_cpu,), cpu_tree = spmd.run_one_rank(cfg, "cpu")
            want_k12 = 3 * per if ffn == "grouped" else 0
            if counts != {"fwd": per, "dq": per, "dkv": per} \
                    or k12 != want_k12:
                fail(f"spmd reference {sp_mode}/{ffn}: flash launches "
                     f"{counts} (want {per} each), K12 {k12} (want "
                     f"{want_k12})")
            if not (math.isfinite(l_card)
                    and abs(l_card - l_cpu) <= SPMD_TOL * abs(l_cpu)):
                fail(f"spmd reference {sp_mode}/{ffn}: card loss {l_card} "
                     f"vs CPU {l_cpu}")
            init = spmd.init_params(cfg)     # run_one_rank's weights
            keys = [(k, None) for k in ("embed", "final_norm", "head")]
            keys += [("layers", k) for k in spmd.LAYER_KEYS]
            for outer, inner in keys:
                got, want, p0 = (t[outer] if inner is None
                                 else t[outer][inner]
                                 for t in (card_tree, cpu_tree, init))
                p0 = p0.numpy()
                name = inner or outer
                err = float(np.abs(got - want).max()) \
                    / float(np.abs(want).max())
                worst = max(worst, err)
                if not err <= SPMD_TOL:
                    fail(f"spmd reference {sp_mode}/{ffn}: {name} "
                         f"{err:.3e} of its max-abs from the CPU's")
                uscale = float(np.abs(want - p0).max())
                uerr = float(np.abs((got - p0) - (want - p0)).max())
                ulp = float(np.spacing(np.abs(p0).max()))
                worst_upd = max(worst_upd, (uerr / max(uscale, 1e-30),
                                            f"{sp_mode}/{ffn} {name}"))
                if not uerr <= SPMD_UPDATE_TOL * uscale + ulp:
                    fail(f"spmd reference {sp_mode}/{ffn}: {name}'s "
                         f"update off the CPU's by {uerr:.3e} (update "
                         f"max-abs {uscale:.3e}, bar {SPMD_UPDATE_TOL} "
                         f"of it + ulp {ulp:.3e})")
            say(f"spmd reference {sp_mode}/{ffn}: loss card {l_card:.7f} "
                f"CPU {l_cpu:.7f}; flash {counts}, K12 {k12}")
    say(f"spmd reference: every leaf within {worst:.3e} of its max-abs "
        f"(bar {SPMD_TOL}); every update within {worst_upd[0]:.3e} of its "
        f"max-abs ({worst_upd[1]}; bar {SPMD_UPDATE_TOL} + one ulp of the "
        f"leaf)")


def spmd_kernel_phase(torch) -> None:
    """10g (b), first: the kernels of the bench-shape bf16 SPMD step at
    the shapes the step hands them, each against its plain version on
    the same seeded inputs, outside the counted run: K3/K4/K5 at one
    microbatch's causal attention (``flash_phase``'s bars: every row of
    O, dq, dk, dv within 2^-6 of its max-abs, lse and D within 1e-3),
    and K12's expert products at the dispatch buffer's shape, gate/up
    and down, in bf16, int8 and e4m3 (``gmm_check``'s bars: bf16 and
    e4m3 by the row, int8 bit-exact).  The grouped FFN's backward is
    batched library products and launches no kernel."""
    from dlnetbench_tpu_torch import entry
    from dlnetbench_tpu_torch.models import moe as MoE
    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    cfg = spmd.SpmdConfig(**entry.BENCH_SPMD, batch=4, num_microbatches=2)
    mb = cfg.batch // cfg.num_microbatches
    flash_phase(torch, (mb, cfg.seq_len, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, True), {}, timed=False)
    e, d, f = cfg.num_experts, cfg.embed_dim, cfg.ff_dim
    c = MoE.group_capacity(mb * cfg.seq_len, cfg.top_k, e,
                           cfg.capacity_factor)
    full = torch.full((e,), c, dtype=torch.int32, device="cuda")
    rand = seeded(torch, 47)
    for fmt in (None, "int8", "float8"):
        for label, k, n in (("gate/up", d, f), ("down", f, d)):
            x = rand(e, c, k)
            w = rand(e, k, n, scale=k ** -0.5)
            sx = sw = None
            if fmt:
                w, sw = GM.quantize_experts(w, fmt)
                sx = Q.scale_from_amax(GM.expert_amax(x), fmt)
            y = GM.grouped_matmul(x, w, sx=sx, sw=sw, fmt=fmt)
            torch.cuda.synchronize()
            ref = GM.plain_grouped_matmul(x, w, None, sx, sw, fmt)
            tag = (f"spmd K12 {fmt or 'bf16'} {label} [{e}, {c}, {k}] x "
                   f"[{k}, {n}]")
            errs = gmm_check(torch, fmt, y, ref, full, tag)
            say(f"{tag}: max abs err {errs['max_abs_err']:.3e}, worst row "
                f"{errs['row']:.3e}, Frobenius {errs['fro']:.3e}")
            del x, w, y, ref
    torch.cuda.empty_cache()


def spmd_phase(torch, card: str) -> dict:
    """10g (b) and (c): ``entry.dryrun_multichip(1)`` at the bench's
    SPMD shape (``entry.BENCH_SPMD``, bf16; its MoE parity stages f32),
    the counters set to 0 before and read after: no stage skipped by
    its deadline, ``SPMD_DRYRUN_STEPS`` steps, K3/K4/K5 launched
    layers x ticks for each of its ``steps`` train steps, K12 (f32) 3 x
    layers x ticks for each step of a grouped stage, no splash kernel;
    then ``spmd.build(1)`` at the same shape with ``moe_ffn_impl=
    "grouped"`` in bf16, int8 and e4m3 (``moe_ffn_quant``): one warm
    and ``SPMD_TIMED_STEPS`` fenced steps each, finite losses and
    parameters, K3/K4/K5 layers x ticks and K12 3 x layers x ticks a
    step, the median ms a step beside the card; and the bench's
    ``spmd_overlap_ab`` at world 1: the JAX bench's skip note and no
    line.  Returns the launches for the kernels line."""
    import contextlib
    import io

    from dlnetbench_tpu_torch import bench, entry
    from dlnetbench_tpu_torch.models import spmd
    from dlnetbench_tpu_torch.parallel import multihost
    t_phase = time.perf_counter()
    layers, ticks = entry.BENCH_SPMD["num_layers"], 2
    per = layers * ticks
    reset_flash_counts()
    reset_gmm_counts()
    out = entry.dryrun_multichip(1, shape="bench", log=say)
    torch.cuda.synchronize()
    counts, k12, masked = flash_counts(), gmm_counts(), splash_counts()
    if out["skipped"] or out["steps"] != SPMD_DRYRUN_STEPS \
            or tuple(out["moe"]) != SPMD_MOE_STAGES:
        fail(f"spmd dryrun: stages skipped {out['skipped']}, {out['steps']} "
             f"steps (want {SPMD_DRYRUN_STEPS}), MoE stages "
             f"{list(out['moe'])} (want {list(SPMD_MOE_STAGES)})")
    want = out["steps"] * per
    # one grouped step a grouped stage (its reference is the einsum's)
    grouped = sum(1 for label in out["moe"] if "grouped" in label)
    if counts != {"fwd": want, "dq": want, "dkv": want} \
            or k12 != 3 * per * grouped or any(masked.values()):
        fail(f"spmd dryrun: flash launches {counts} (want {want} each: "
             f"{out['steps']} steps x {per}), K12 {k12} (want "
             f"{3 * per * grouped}), splash {masked} (want none)")
    if set(out["loss"]) != {"megatron", "ring", "ulysses"} \
            or not all(math.isfinite(v) for v in out["loss"].values()):
        fail(f"spmd dryrun: losses {out['loss']}")
    say(f"spmd dryrun_multichip(1) bench shape: losses {out['loss']}, "
        f"{out['steps']} steps, flash launches {counts}, K12 (f32) {k12}")
    launches = {"flash": dict(counts), "k12": {}}
    device = multihost.initialize("cuda")
    try:
        for label, quant in SPMD_QUANTS:
            cfg = spmd.SpmdConfig(**entry.BENCH_SPMD, batch=4,
                                  num_microbatches=ticks,
                                  moe_ffn_impl="grouped",
                                  moe_ffn_quant=quant)
            _, _, step, params, tokens = spmd.build(1, cfg, device=device)
            reset_flash_counts()
            reset_gmm_counts()
            params, loss = step(params, tokens)
            ms, losses = [], [float(loss)]
            for _ in range(SPMD_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, loss = step(params, tokens)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(loss))
            steps = SPMD_TIMED_STEPS + 1
            counts, k12 = flash_counts(), gmm_counts()
            finite = all(bool(torch.isfinite(t).all())
                         for t, _ in spmd._leaves_with_specs(params,
                                                             cfg.sp_mode))
            if counts != {"fwd": steps * per, "dq": steps * per,
                          "dkv": steps * per} \
                    or k12 != 3 * per * steps \
                    or not all(math.isfinite(v) for v in losses) \
                    or not finite:
                fail(f"spmd grouped {label}: flash {counts} (want "
                     f"{steps * per} each), K12 {k12} (want "
                     f"{3 * per * steps}), losses {losses}, params finite "
                     f"{finite}")
            for kind in counts:
                launches["flash"][kind] += counts[kind]
            launches["k12"][label] = k12
            say(f"spmd step grouped {label}: {statistics.median(ms):.3f} "
                f"ms a step (median of {SPMD_TIMED_STEPS}, min "
                f"{min(ms):.3f}) on {card}; losses "
                f"{[round(v, 4) for v in losses]}; flash {counts}, K12 {k12}")
            del params, step
            torch.cuda.empty_cache()
    finally:
        multihost.shutdown()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        line = bench.bench_overlap_ab("cuda")
    note = [json.loads(t) for t in buf.getvalue().strip().splitlines()]
    want_note = {"metric": "spmd overlap A/B",
                 "skipped": "needs >= 2 devices, have 1 — single-chip "
                            "session has no communication to overlap"}
    if line is not None or note != [want_note]:
        fail(f"spmd_overlap_ab at world 1: line {line}, printed {note}")
    say(f"spmd_overlap_ab at world 1: {json.dumps(note[0])}")
    say(f"spmd phase: {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches


def trace_phase(torch) -> dict:
    """``bench.main(["--skip-aux", "--trace-out", F])`` (10f): rc 0;
    K3/K4/K5 each launched layers x (K x (1 + rounds) + 2K) times (the
    profiled call runs twice: once to warm the profiler, once
    recorded); the merged trace holds the host spans build, timed and
    profile and K3/K4/K5 device events of the recorded call.  After the
    proxy phases: a profiler session slows the host's later launches."""
    import contextlib
    import io

    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step as BS
    path = OUT / "bench_trace.json"
    path.unlink(missing_ok=True)
    reset_flash_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--skip-aux", "--trace-out", str(path)])
    torch.cuda.synchronize()
    counts = flash_counts()
    k = BS.env_int("DLNB_BENCH_K", 10)
    want = BS.LAYERS * (k * (1 + bench.ROUNDS) + 2 * k)
    if rc != 0 or not path.is_file() \
            or counts != {"fwd": want, "dq": want, "dkv": want}:
        fail(f"trace: bench rc {rc}, trace {path.is_file()}, flash "
             f"launches {counts} (want {want} each)")
    trace = trace_events(path)
    in_trace = {kind: sum(1 for e in trace["device"]
                          if f"{kind}_bf16" in str(e.get("name", "")))
                for kind in ("fwd", "dq", "dkv")}
    if not all(in_trace.values()) or not {"build", "timed", "profile"} \
            <= trace["host"]:
        fail(f"trace: --trace-out trace holds K3/K4/K5 device events "
             f"{in_trace} (want each > 0) and host spans "
             f"{sorted(trace['host'])}")
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    say(f"trace: bench --skip-aux --trace-out {line['value']} ms/step, "
        f"{trace['bytes']} bytes, {len(trace['device'])} device events in "
        f"the profiled headline call, K3/K4/K5 {in_trace} (the call's "
        f"{BS.LAYERS} layers x {k} steps = {BS.LAYERS * k} each), host "
        f"spans {sorted(trace['host'])}; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


def card_tests_phase() -> None:
    """The card-only pytest cases (``CARD_TESTS``, files that import no
    jax) in a subprocess, without tests/conftest.py (which imports jax):
    rc 0 and at least ``CARD_TESTS_MIN`` cases passed."""
    import glob
    import re
    files = sorted(glob.glob(str(ROOT / CARD_TESTS)))
    if not files:
        fail(f"card tests: no {CARD_TESTS} in {ROOT}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", *files], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() \
        else ""
    m = re.search(r"(\d+) passed", tail)
    passed = int(m.group(1)) if m else 0
    if proc.returncode != 0 or passed < CARD_TESTS_MIN:
        fail(f"card tests: rc {proc.returncode}, {passed} passed (want rc 0 "
             f"and >= {CARD_TESTS_MIN}):\n{proc.stdout[-4000:]}"
             f"{proc.stderr[-2000:]}")
    say(f"card tests: pytest --noconftest -m cuda {CARD_TESTS}: {tail} in "
        f"{time.perf_counter() - t0:.1f} s (>= {CARD_TESTS_MIN} cases)")


def parent_tiles(parent: Path) -> dict:
    """The BlockMask tiles (q rows, keys) each splash kernel of another
    checkout walks, as its wrapper declares them (its own test pins them
    to its CUDA source)."""
    import re
    src = (parent / "dlnetbench_tpu_torch/ops/flash_attention.py") \
        .read_text()
    tiles = {}
    for kind, name in (("fwd", "FWD_TILES"), ("dq", "DQ_TILES"),
                       ("dkv", "DKV_TILES")):
        m = re.search(rf"^{name} = \((\d+), (\d+)\)", src, re.M)
        if m is None:
            fail(f"paired: no {name} in the parent's flash_attention.py")
        tiles[kind] = (int(m.group(1)), int(m.group(2)))
    return tiles


def paired_flash(torch, lib, parent: Path, turns, stream) -> None:
    """K3 at the train shape (causal) and K6 under window(1024), then K4
    and K5 (causal) and K7 and K8 (window(1024)) against another
    checkout's flash kernels; each side's splash kernels read the
    BlockMask packed at their own tiles."""
    import ctypes

    from dlnetbench_tpu_torch.ops import attention_mask as M
    from dlnetbench_tpu_torch.ops import flash_attention as FA
    ptr = ctypes.c_void_p
    for name, n_ptr in (("dlnb_flash_fwd", 5), ("dlnb_flash_dq", 8),
                        ("dlnb_flash_dkv", 8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = FA._fn(name, n_ptr).argtypes
    for name, n_ptr in (("dlnb_splash_fwd", 6), ("dlnb_splash_dq", 9),
                        ("dlnb_splash_dkv", 9)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ptr] * n_ptr + [ctypes.c_int] * 5
                       + [ctypes.c_float, ptr])
    b, s, hq, hkv, dh, causal = FLASH_CASES[0]
    scale = dh ** -0.5
    q, k, v, do = flash_operands(torch, b, s, hq, hkv, dh, seed=5)
    out, lse = FA.kernel_forward(q, k, v, causal)
    p_out, p_lse = FA.plain_forward(q, k, v, causal)
    p_dq, p_dcap = FA.plain_dq(q, k, v, out, lse, do, causal)
    p_dk, p_dv = FA.plain_dkv(q, k, v, do, lse, p_dcap, causal)
    spec = M.MaskSpec(window=1024)
    s_out, s_lse = FA.kernel_splash_forward(q, k, v, spec)
    ps_out, ps_lse = FA.plain_splash_forward(q, k, v, spec)
    ps_dq, ps_dcap = FA.plain_splash_dq(q, k, v, s_out, s_lse, do, spec)
    ps_dk, ps_dv = FA.plain_splash_dkv(q, k, v, do, s_lse, ps_dcap, spec)
    tiles = parent_tiles(parent)
    old_arr = {
        "fwd": FA.pack_block_mask(M.block_mask(spec, s, *tiles["fwd"]),
                                  False, q.device),
        "dq": FA.pack_block_mask(M.block_mask(spec, s, *tiles["dq"]), False,
                                 q.device),
        "dkv": FA.pack_block_mask(M.block_mask(spec, s, *tiles["dkv"]), True,
                                  q.device)}
    dims = (b, s, hq, hkv, dh)
    old = {"o": torch.empty_like(q), "lse": torch.empty_like(lse),
           "dq": torch.empty_like(q), "d": torch.empty_like(lse),
           "dk": torch.empty_like(k), "dv": torch.empty_like(v)}
    new = {}

    def call(rc, name):
        if rc:
            fail(f"paired: parent {name} rc {rc}")

    def bar(label, pairs):
        for name, (a, r) in pairs.items():
            rows = name not in ("D", "lse")
            bar_ = FLASH_TOL_ROW if rows else FLASH_TOL_LSE
            err = row_err(a, r) if rows else abs_err(a, r)
            if not (torch.isfinite(a.float()).all() and err <= bar_):
                fail(f"paired {label} {name}: err {err:.3e} (bar {bar_})")

    def old_k3():
        call(lib.dlnb_flash_fwd(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                old["o"].data_ptr(), old["lse"].data_ptr(),
                                *dims, int(causal), scale, stream()),
             "dlnb_flash_fwd")

    def new_k3():
        new["o"], new["lse"] = FA.kernel_forward(q, k, v, causal)

    def old_k6():
        call(lib.dlnb_splash_fwd(1, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), old["o"].data_ptr(),
                                 old["lse"].data_ptr(),
                                 old_arr["fwd"].packed.data_ptr(), *dims,
                                 scale, stream()), "dlnb_splash_fwd")

    def new_k6():
        new["o"], new["lse"] = FA.kernel_splash_forward(q, k, v, spec)

    def old_k4():
        call(lib.dlnb_flash_dq(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               old["d"].data_ptr(), old["dq"].data_ptr(),
                               *dims, int(causal), scale, stream()),
             "dlnb_flash_dq")

    def new_k4():
        new["dq"], new["d"] = FA.kernel_dq(q, k, v, out, lse, do, causal)

    def old_k5():
        call(lib.dlnb_flash_dkv(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                do.data_ptr(), lse.data_ptr(),
                                p_dcap.data_ptr(), old["dk"].data_ptr(),
                                old["dv"].data_ptr(), *dims, int(causal),
                                scale, stream()), "dlnb_flash_dkv")

    def new_k5():
        new["dk"], new["dv"] = FA.kernel_dkv(q, k, v, do, lse, p_dcap,
                                             causal)

    def old_k7():
        call(lib.dlnb_splash_dq(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                s_out.data_ptr(), do.data_ptr(),
                                s_lse.data_ptr(), old["d"].data_ptr(),
                                old["dq"].data_ptr(),
                                old_arr["dq"].packed.data_ptr(), *dims,
                                scale, stream()), "dlnb_splash_dq")

    def new_k7():
        new["dq"], new["d"] = FA.kernel_splash_dq(q, k, v, s_out, s_lse, do,
                                                  spec)

    def old_k8():
        call(lib.dlnb_splash_dkv(1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 do.data_ptr(), s_lse.data_ptr(),
                                 ps_dcap.data_ptr(), old["dk"].data_ptr(),
                                 old["dv"].data_ptr(),
                                 old_arr["dkv"].packed.data_ptr(), *dims,
                                 scale, stream()), "dlnb_splash_dkv")

    def new_k8():
        new["dk"], new["dv"] = FA.kernel_splash_dkv(q, k, v, do, s_lse,
                                                    ps_dcap, spec)

    def side(which):
        return old if which == "old" else new

    shape = f"[{b}, {s}, {hq}/{hkv}, {dh}]"
    turns(f"K3 flash forward {shape} causal", old_k3, new_k3,
          lambda w: bar(f"K3 ({w})", {"o": (side(w)["o"], p_out),
                                      "lse": (side(w)["lse"], p_lse)}))
    turns(f"K6 splash forward {shape} window(1024)", old_k6, new_k6,
          lambda w: bar(f"K6 ({w})", {"o": (side(w)["o"], ps_out),
                                      "lse": (side(w)["lse"], ps_lse)}))
    del p_out, p_lse, ps_out, ps_lse
    turns(f"K4 flash dq {shape} causal (control)", old_k4, new_k4,
          lambda w: bar(f"K4 ({w})", {"dq": (side(w)["dq"], p_dq),
                                      "D": (side(w)["d"], p_dcap)}))
    turns(f"K5 flash dk/dv {shape} causal (control)", old_k5, new_k5,
          lambda w: bar(f"K5 ({w})", {"dk": (side(w)["dk"], p_dk),
                                      "dv": (side(w)["dv"], p_dv)}))
    turns(f"K7 splash dq {shape} window(1024) (control)", old_k7, new_k7,
          lambda w: bar(f"K7 ({w})", {"dq": (side(w)["dq"], ps_dq),
                                      "D": (side(w)["d"], ps_dcap)}))
    turns(f"K8 splash dk/dv {shape} window(1024) (control)", old_k8,
          new_k8,
          lambda w: bar(f"K8 ({w})", {"dk": (side(w)["dk"], ps_dk),
                                      "dv": (side(w)["dv"], ps_dv)}))


def paired_paged(torch, lib, parent: Path, turns, stream) -> None:
    """K1, K2 int8 and K2 e4m3 at the served decode shape against another
    checkout's paged attention, each side's output held to the plain
    version at ``TOL``.  A parent whose C entry takes no workspace (the
    kernel before the split) is called with its own argument list; one
    that does gets a workspace for one split a page and fresh
    counters."""
    import ctypes

    from dlnetbench_tpu_torch.ops import paged_attention as PA
    text = (parent / SRC).read_text()
    split = "void* workspace" in text
    # a parent whose entry takes the pages a split last gets 0 (its
    # default split)
    tail = [0] if "int split)" in text else []
    fn = lib.dlnb_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * (10 if split
                                                              else 8)
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p]
                   + [ctypes.c_int] * len(tail))
    scratch = ([torch.empty(B * HQ * PMAX * (DH + 2), device="cuda"),
                torch.zeros(B * HKV, dtype=torch.int32, device="cuda")]
               if split else [])
    for dt, label in (("bf16", "K1 paged_attention (bf16 pages)"),
                      ("int8", "K2 quant_paged_attention (int8 pages)"),
                      ("fp8", "K2 quant_paged_attention (e4m3 pages)")):
        q, (kp, vp), sc, lengths, bt = decode_operands(torch, dt)
        sc = sc or (None, None)
        ref = PA.gather_attention(q, kp, vp, lengths, bt, *sc)
        got = {"old": torch.empty_like(q)}

        def old():
            rc = fn(PA.DTYPE_CODES[q.dtype], PA.DTYPE_CODES[kp.dtype],
                    q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                    *[x.data_ptr() if x is not None else None for x in sc],
                    lengths.data_ptr(), bt.data_ptr(),
                    got["old"].data_ptr(), *[x.data_ptr() for x in scratch],
                    B, HQ, HKV, NUM_PAGES, PAGE, DH, PMAX, stream(), *tail)
            if rc:
                fail(f"paired: parent dlnb_paged_attention rc {rc}")

        def new():
            got["new"] = PA.launch(q, kp, vp, lengths, bt, *sc)

        def check(which):
            a = got[which]
            if not (torch.isfinite(a).all() and torch.allclose(
                    a.float(), ref.float(), rtol=TOL, atol=TOL)):
                fail(f"paired {label} ({which}): max abs err "
                     f"{abs_err(a, ref):.3e} (bar {TOL})")

        turns(f"{label} B={B} decode", old, new, check)


def paired_phase(torch, parent: Path) -> list:
    """K1, K2, K3, K6, then K4, K5, K7, K8 and K9-K12 timed in turns
    against the same kernels built from another checkout's ``SRC``,
    ``FLASH_SRC`` and ``MLP_SRC`` (all compiled at once): old, new, new,
    old, each a ``timed_ms`` median, on the same operands; both outputs
    held to the plain version by the kernels' own bars first."""
    import ctypes

    from dlnetbench_tpu_torch.ops import _build
    from dlnetbench_tpu_torch.ops import grouped_matmul as GM
    from dlnetbench_tpu_torch.ops import mlp_backward as MB
    from dlnetbench_tpu_torch.ops import quantized_matmul as Q
    out_dir = OUT / "paired"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in (SRC, FLASH_SRC, MLP_SRC):
        path = out_dir / f"libparent_{Path(src).stem}.so"
        procs[src] = (path, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(path),
             str(parent / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (path, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"paired: the parent's {src} did not build:\n{log[-3000:]}")
        libs[src] = ctypes.CDLL(str(path))
    lib = libs[MLP_SRC]
    # a parent whose K11/K12 entries take a cluster size last gets 0 (its
    # preference); an older one takes the argument list without it
    tail = ([0] if "void* stream, int cluster)" in (parent / MLP_SRC)
            .read_text() else [])
    cut = None if tail else -1
    lib.dlnb_qmm.restype = lib.dlnb_gmm.restype = ctypes.c_int
    lib.dlnb_qmm.argtypes = Q._fn().argtypes[:cut]
    lib.dlnb_gmm.argtypes = GM._fn().argtypes[:cut]
    lib.dlnb_dgdu.restype = lib.dlnb_dwd.restype = ctypes.c_int
    lib.dlnb_dgdu.argtypes = MB._fn("dlnb_dgdu", 6).argtypes
    lib.dlnb_dwd.argtypes = MB._fn("dlnb_dwd", 4).argtypes

    def stream():
        return torch.cuda.current_stream().cuda_stream

    rows = []

    def turns(label, old, new, check):
        old()
        torch.cuda.synchronize()
        check("old")
        new()
        torch.cuda.synchronize()
        check("new")
        t = [timed_ms(torch, f, reps=20) for f in (old, new, new, old)]
        row = {"kernel": label, "old_ms": [t[0], t[3]],
               "new_ms": [t[1], t[2]],
               "speedup": (t[0] + t[3]) / (t[1] + t[2])}
        rows.append(row)
        say(f"paired {label}: old {t[0]:.4f} / {t[3]:.4f} ms, new "
            f"{t[1]:.4f} / {t[2]:.4f} ms -> {row['speedup']:.2f}x")

    smi_sample("paired start")
    paired_paged(torch, libs[SRC], parent, turns, stream)
    smi_sample("paired K1/K2 done")
    paired_flash(torch, libs[FLASH_SRC], parent, turns, stream)
    for label, pair in (("K4 + K5", rows[5:7]), ("K7 + K8", rows[7:9])):
        t_old = sum(sum(r["old_ms"]) for r in pair)
        t_new = sum(sum(r["new_ms"]) for r in pair)
        say(f"paired {label}: old {t_old / 2:.4f} ms, new {t_new / 2:.4f} "
            f"ms -> {t_old / t_new:.2f}x")
    torch.cuda.empty_cache()
    smi_sample("paired flash done")
    rand = seeded(torch, 61)
    t, d, f = MLP_T, MLP_D, MLP_F
    dy = rand(t, d, scale=0.1)
    wd = rand(f, d, scale=f ** -0.5)
    g, u = rand(t, f), rand(t, f)
    ref = {"k9": MB.plain_dgdu(dy, wd, g, u), "k10": MB.plain_dwd(g, u, dy)}
    old_out = {"k9": (torch.empty_like(g), torch.empty_like(u)),
               "k10": torch.empty(f, d, device="cuda")}
    new_out = {}

    def old_k9():
        dg, du = old_out["k9"]
        rc = lib.dlnb_dgdu(dy.data_ptr(), wd.data_ptr(), g.data_ptr(),
                           u.data_ptr(), dg.data_ptr(), du.data_ptr(), t, f,
                           d, stream())
        if rc:
            fail(f"paired: parent dlnb_dgdu rc {rc}")

    def new_k9():
        new_out["k9"] = MB.kernel_dgdu(dy, wd, g, u)

    def old_k10():
        rc = lib.dlnb_dwd(g.data_ptr(), u.data_ptr(), dy.data_ptr(),
                          old_out["k10"].data_ptr(), t, f, d, stream())
        if rc:
            fail(f"paired: parent dlnb_dwd rc {rc}")

    def new_k10():
        new_out["k10"] = MB.kernel_dwd(g, u, dy)

    def check_bwd(name, which):
        got = (old_out if which == "old" else new_out)[name]
        pairs = (zip(got, ref["k9"], ("dg", "du")) if name == "k9"
                 else [(got, ref["k10"], "dWd")])
        bar = DGDU_TOL_ROW if name == "k9" else DWD_TOL_ROW
        for a, r, label in pairs:
            err = row_err(a, r)
            if not (torch.isfinite(a.float()).all() and err <= bar):
                fail(f"paired {name.upper()} {label} ({which}): worst row "
                     f"err {err:.3e} (bar {bar:.3e})")

    turns(f"K9 dgdu [{t}, {d}] x [{f}, {d}]^T", old_k9, new_k9,
          lambda which: check_bwd("k9", which))
    turns(f"K10 dwd [{f}, {t}] x [{t}, {d}]", old_k10, new_k10,
          lambda which: check_bwd("k10", which))
    del dy, wd, g, u, ref, old_out, new_out
    torch.cuda.empty_cache()
    smi_sample("paired K9/K10 done")
    for fmt in ("int8", "float8"):
        kind = "int8" if fmt == "int8" else "e4m3"
        for proj, (k, n) in (("up", (MLP_D, MLP_F)),
                             ("down", (MLP_F, MLP_D))):
            x = rand(MLP_T, k)
            wq, sw = Q.quantize_tensor(rand(k, n, scale=k ** -0.5), fmt)
            w_t = Q.k_major(wq)
            sx = Q.scale_from_amax(Q.amax_of(x), fmt)
            ref, _ = Q.plain_fused_matmul(x, wq, sw, sx, fmt, False)
            y_old = torch.empty_like(ref)
            y_new = {}

            def old():
                rc = lib.dlnb_qmm(Q.DTYPE_CODES[x.dtype], Q.FMT_CODES[fmt],
                                  0, x.data_ptr(), w_t.data_ptr(),
                                  sx.data_ptr(), sw.data_ptr(),
                                  y_old.data_ptr(), None, MLP_T, n, k,
                                  stream(), *tail)
                if rc:
                    fail(f"paired: parent dlnb_qmm rc {rc}")

            def new():
                y_new["y"] = Q.kernel_fused_matmul(x, w_t, sw, sx, fmt,
                                                   False)[0]

            def check(which):
                got = y_old if which == "old" else y_new["y"]
                qmm_check(torch, fmt, got, ref,
                          f"paired K11 {kind} {proj} ({which})")

            turns(f"K11 {kind} {proj} [{MLP_T}, {k}] x [{k}, {n}]", old,
                  new, check)
            del x, wq, w_t, ref, y_old, y_new
            torch.cuda.empty_cache()
    full = torch.full((GMM_E,), GMM_C, dtype=torch.int32, device="cuda")
    skew = torch.tensor(GMM_SKEW, dtype=torch.int32, device="cuda")
    for fmt in (None, "int8", "float8"):
        kind = {None: "bf16", "int8": "int8", "float8": "e4m3"}[fmt]
        for label, k, n in GMM_CASES[:2]:
            x = rand(GMM_E, GMM_C, k)
            w = rand(GMM_E, k, n, scale=k ** -0.5)
            sx = sw = None
            w_k = w
            if fmt:
                w, sw = GM.quantize_experts(w, fmt)
                sx = Q.scale_from_amax(GM.expert_amax(x), fmt)
                w_k = w.transpose(1, 2).contiguous()
            for cname, counts in (("full", full), ("skewed", skew)):
                if cname == "skewed" and label != GMM_CASES[0][0]:
                    continue
                ref = GM.plain_grouped_matmul(x, w, counts, sx, sw, fmt)
                y_old = torch.empty_like(ref)
                y_new = {}

                def old():
                    rc = lib.dlnb_gmm(
                        Q.DTYPE_CODES[x.dtype], GM.FMT_CODES[fmt],
                        x.data_ptr(), w_k.data_ptr(), counts.data_ptr(),
                        sx.data_ptr() if fmt else None,
                        sw.data_ptr() if fmt else None, y_old.data_ptr(),
                        GMM_E, GMM_C, n, k, stream(), *tail)
                    if rc:
                        fail(f"paired: parent dlnb_gmm rc {rc}")

                def new():
                    y_new["y"] = GM.kernel_grouped_matmul(x, w_k, counts,
                                                          sx, sw, fmt)

                def check(which):
                    got = y_old if which == "old" else y_new["y"]
                    gmm_check(torch, fmt, got, ref, counts,
                              f"paired K12 {kind} {label} {cname} ({which})")

                turns(f"K12 {kind} {label} {cname} counts", old, new, check)
                del ref, y_old, y_new
            del x, w, w_k
            torch.cuda.empty_cache()
    smi_sample("paired end")
    say(json.dumps({"paired": rows}))
    return rows


def profile_rows(prof, wall: float, label: str) -> None:
    """Write the top device rows of a profile to
    build/chip_smoke/profile_<label>.json and print the device busy
    share."""
    from torch.autograd import DeviceType
    rows = [(e.key, getattr(e, "device_time_total",
                            getattr(e, "cuda_time_total", 0.0)), e.count,
             e.device_type == DeviceType.CUDA)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    # device-side events only (kernels, copies, sets): host ops and
    # autograd nodes carry the device time of the kernels they launched
    kernels = [r[:3] for r in rows if r[3]]
    rows = [r[:3] for r in rows]
    busy = sum(r[1] for r in kernels)
    top = sorted(rows, key=lambda r: -r[1])[:40]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"profile_{label}.json").write_text(json.dumps(
        {"wall_s": wall, "busy_s": busy / 1e6, "rows": top}, indent=1))
    say(f"profile {label}: wall {wall:.3f} s, kernel time "
        f"{busy / 1e6:.3f} s ({busy / 1e6 / wall:.3f} of wall; "
        f"device idle share {1 - busy / 1e6 / wall:.3f})")
    for key, t_us, n in sorted(kernels, key=lambda r: -r[1])[:25]:
        say(f"  {t_us / 1e3:10.3f} ms  {n:6d}x  {key[:90]}")


# the step recipes profiled with --profile: label -> build overrides
PROFILE_RECIPES = {
    "train": {},
    "train_int8": {"mlp_dtype": "int8"},
    "train_int8_fused": {"mlp_dtype": "int8", "quant_fusion": "fused"},
    "train_e4m3_delayed": {"mlp_dtype": "float8", "quant_fusion": "fused",
                           "quant_scaling": "delayed"},
    "train_pallas_bwd": {"mlp_backward": "pallas"},
    "train_window": {"attention_window": 1024},
    "train_seg": {"attention_seg_avg": 768},
}


def profile_train(torch, label: str, overrides: dict) -> None:
    """ms a step (one round of K chained steps after a warm round,
    unprofiled), then device busy share and top kernels over a profiled
    round, of the bench train step under a recipe's overrides."""
    from torch.profiler import ProfilerActivity, profile

    from dlnetbench_tpu_torch.models import bench_step as BS
    k = BS.env_int("DLNB_BENCH_K", 10)
    train_k, carry, tokens, _, _ = BS.build(k, **overrides)
    carry, _ = train_k(carry, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = train_k(carry, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / k * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_k(carry, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"profile {label} {overrides}: {k} steps, {step_ms:.3f} ms a step "
        f"unprofiled, {wall / k * 1e3:.1f} ms under the profiler")
    profile_rows(prof, wall, label)


def profile_moe(torch) -> None:
    """The moe_ab grouped chain's train step (``moe_impl="grouped"`` at
    the bench's moe_ab shape): ms a step and its kernel breakdown."""
    from torch.profiler import ProfilerActivity, profile

    from dlnetbench_tpu_torch import bench
    from dlnetbench_tpu_torch.models import bench_step as BS
    from dlnetbench_tpu_torch.models import transformer as T
    card = BS.bench_card()
    sh = bench.moe_ab_shape(card)
    cfg = T.TransformerConfig(
        vocab_size=BS.VOCAB, embed_dim=card.embed_dim,
        num_heads=card.num_heads, num_kv_heads=card.num_kv_heads,
        ff_dim=sh["f_e"], num_layers=sh["layers"], seq_len=sh["seq"],
        logits_f32=False, num_experts=sh["experts"], top_k=sh["top_k"],
        moe_impl="grouped", moe_capacity_factor=sh["capacity_factor"])
    k = sh["k"]
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    tokens = torch.randint(0, BS.VOCAB, (BS.BATCH, sh["seq"] + 1),
                           generator=gen, device="cuda")
    train_k = BS.make_train_k(cfg, k)
    train_k(params, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_k(params, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / k * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_k(params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"profile moe_grouped (moe_ab shape): {k} steps, {step_ms:.3f} ms a "
        f"step unprofiled, {wall / k * 1e3:.1f} ms under the profiler")
    profile_rows(prof, wall, "moe_grouped")


def profile_phase(torch) -> None:
    """Kernel-time breakdown of a served run at the same width (bf16 and
    int8 caches), from torch.profiler's device events; the rows go to
    build/chip_smoke/profile_<cache>.json, then the train step's."""
    from torch.profiler import ProfilerActivity, profile

    from dlnetbench_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_params)
    from dlnetbench_tpu_torch.serving import scheduler as S
    from dlnetbench_tpu_torch.serving.arrivals import ArrivalPlan
    mc = TransformerConfig(vocab_size=32768, embed_dim=4096, num_heads=32,
                           num_kv_heads=8, ff_dim=14336, num_layers=4,
                           seq_len=512, dtype="bfloat16")
    for cd in ("bf16", "int8"):
        cfg = S.ServingConfig(slots=8, page_size=16, num_pages=512,
                              max_seq_len=512, prefill_chunk=64,
                              cache_dtype=cd, warmup_requests=8)
        eng = S.Engine(mc, cfg, params=init_params(mc, device="cuda"))
        plan = ArrivalPlan.from_dict({**SERVE_PLAN, "num_requests": 8})
        S.run_serving(mc, cfg, plan, engine=eng)     # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.run(plan.sample())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profile_rows(prof, wall, cd)


def main(argv: list[str]) -> int:
    if not (ROOT / "dlnetbench_tpu_torch" / "ops" / "csrc").is_dir():
        fail(f"no dlnetbench_tpu_torch package beside {__file__}: run "
             f"from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a "
             "CUDA card")
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{name}; count {torch.cuda.device_count()}")
    from dlnetbench_tpu_torch.core.hardware import (HARDWARE,
                                                    hw_key_for_device_name)
    hw_key = hw_key_for_device_name(name)
    if hw_key is None:
        say(f"no preset for {name!r}: bounds priced against h100_sxm")
    hw = HARDWARE[hw_key or "h100_sxm"]
    peak = {"bytes": hw.hbm_bandwidth, "bf16": hw.peak("bfloat16"),
            "int8": hw.peak("int8"), "fp8": hw.peak("float8"),
            "fp32": hw.peak("float32")}
    OUT.mkdir(parents=True, exist_ok=True)
    reset_dense_calls()

    from dlnetbench_tpu_torch.ops import _build
    build = _build.build()
    say(f"build: {len(build.libs)} kernel libraries in "
        f"{build.seconds:.1f} s")
    start_native_build()
    for src, log in build.log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {src}: {line.strip()}")

    results = {dt: kernel_phase(torch, dt, peak)
               for dt in ("bf16", "int8", "fp8")}
    flash = flash_phase(torch, FLASH_CASES[0], peak, timed=True)
    for case in FLASH_CASES[1:]:
        flash_phase(torch, case, peak, timed=False)
    torch.cuda.empty_cache()
    splash = splash_phase(torch, peak)
    splash_f32_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("K11")
    qmm = {fmt: qmm_phase(torch, fmt, peak) for fmt in ("int8", "float8")}
    torch.cuda.empty_cache()
    smi_sample("K9/K10")
    mlp_bwd = mlp_bwd_phase(torch, peak)
    torch.cuda.empty_cache()
    smi_sample("K12")
    gmm = gmm_phase(torch, peak)
    torch.cuda.empty_cache()
    smi_sample("after K12")
    tuning_phase(torch, name)
    if "--paired" in argv:
        paired_phase(torch, Path(argv[argv.index("--paired") + 1]).resolve())
        torch.cuda.empty_cache()
    card_tests_phase()
    reference_phase(torch)
    served = {dt: serve_phase(torch, dt) for dt in ("bf16", "int8", "fp8")}
    torch.cuda.empty_cache()
    smi_sample("decode loop")
    loop_launches = decode_loop_phase(torch, served)
    torch.cuda.empty_cache()
    verify_pass_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("serving breadth")
    breadth_launches = serving_breadth_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("serving at scale")
    scale_launches = scale_phase(torch, served)
    torch.cuda.empty_cache()
    train_reference_phase(torch)
    smi_sample("quant train")
    quant_launches = quant_train_phase(torch)
    moe_reference_phase(torch)
    moe_quant = moe_quant_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("mixtral")
    mixtral_phase(torch)
    smi_sample("bench (headline and aux lines)")
    trained = train_phase(torch)
    serving_lines_check(trained["line"])
    smi_sample("after bench")
    torch.cuda.empty_cache()
    longcontext_phase(torch, trained["line"]["longcontext_ab"])
    torch.cuda.empty_cache()
    # after the headline, as the heavy S=32768 steps would precede it
    mask_reference_phase(torch)
    smi_sample("masked steps")
    masked = masked_train_phase(torch)
    smi_sample("after masked steps")
    torch.cuda.empty_cache()
    entry_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("proxies")
    py_medians = proxy_phase(torch, card)
    torch.cuda.empty_cache()
    # after the proxies' host-launch bars, before every profiled session
    breadth = breadth_phase(torch, peak)
    torch.cuda.empty_cache()
    smi_sample("studies")
    studies_phase(torch)
    torch.cuda.empty_cache()
    smi_sample("native tier")
    burn_row = native_phase(torch, card, py_medians, peak)
    torch.cuda.empty_cache()
    observability_phase(torch, card)
    torch.cuda.empty_cache()
    records_phase(torch, card, trained["line"])
    torch.cuda.empty_cache()
    smi_sample("faults")
    faults_phase(torch, card)
    torch.cuda.empty_cache()
    smi_sample("spmd")
    spmd_reference_phase(torch)
    spmd_kernel_phase(torch)
    spmd = spmd_phase(torch, card)
    torch.cuda.empty_cache()
    traced = trace_phase(torch)
    torch.cuda.empty_cache()
    # the decode loop's profiled run, after the proxies as every
    # torch.profiler session of this script: a session leaves host-side
    # instrumentation behind that slows graph launches (the burn's
    # calibration, timed over back-to-back replays, no longer sees it:
    # ROADMAP.md queue 1 item 1)
    profile_loop(torch)
    torch.cuda.empty_cache()
    if "--profile" in argv:
        profile_phase(torch)
        torch.cuda.empty_cache()
        for label, overrides in PROFILE_RECIPES.items():
            profile_train(torch, label, overrides)
            torch.cuda.empty_cache()
        profile_moe(torch)
        torch.cuda.empty_cache()

    kernels = []
    for dt, label, replaces in (
            ("bf16", f"K1 paged_attention (bf16 pages; {PAGED_DESIGN})",
             "dlnetbench_tpu/serving/kv_cache.py:768"),
            ("int8", f"K2 quant_paged_attention (int8 pages; "
             f"{PAGED_DESIGN})",
             "dlnetbench_tpu/ops/paged_attention_quant.py:48"),
            ("fp8", f"K2 quant_paged_attention (e4m3 pages; "
             f"{PAGED_DESIGN})",
             "dlnetbench_tpu/ops/paged_attention_quant.py:48")):
        kernels.append({"name": label, "route": "cuda", "source": SRC,
                        "replaces": replaces,
                        "launches": (served[dt]["launches"]
                                     + loop_launches[dt]
                                     + breadth_launches[dt]
                                     + scale_launches[dt]),
                        **results[dt]})
    for kind, label in (
            ("fwd", f"K3 flash_attention forward ({FLASH_DESIGN})"),
            ("dq", f"K4 flash_attention dq ({FLASH_DESIGN})"),
            ("dkv", f"K5 flash_attention dk/dv ({FLASH_DESIGN})")):
        kernels.append({"name": label, "route": "cuda",
                        "source": FLASH_SRC,
                        "replaces": FLASH_REPLACES[kind],
                        "launches": (trained["counts"][kind] + traced[kind]
                                     + spmd["flash"][kind]
                                     + breadth["flash"][kind]),
                        **flash[kind]})
    row = splash[SPLASH_SPECS[0][0]]
    for kind, label in (
            ("fwd", f"K6 splash_attention forward ({FLASH_DESIGN}; "),
            ("dq", f"K7 splash_attention dq ({FLASH_DESIGN}; "),
            ("dkv", f"K8 splash_attention dk/dv ({FLASH_DESIGN}; ")):
        # the masked steps' launches, and K6's in the longcontext legs
        launches = masked["launches"][kind] + trained["splash"][kind]
        kernels.append({"name": f"{label}{SPLASH_SPECS[0][0]})",
                        "route": "cuda", "source": FLASH_SRC,
                        "replaces": SPLASH_REPLACES[kind],
                        "launches": launches, **row[kind]})
    for key, label, res in (
            ("k9", f"K9 dgdu (SwiGLU backward dg, du; {WG_DESIGN})",
             mlp_bwd["k9"]),
            ("k10", f"K10 dwd (SwiGLU backward dWd; {WG_DESIGN})",
             mlp_bwd["k10"]),
            ("k11_int8", f"K11 fused_matmul (int8; {WG_DESIGN})",
             qmm["int8"]),
            ("k11_e4m3", f"K11 fused_matmul (e4m3; {WG_DESIGN})",
             qmm["float8"])):
        kernels.append({"name": label, "route": "cuda", "source": MLP_SRC,
                        "replaces": MLP_REPLACES[key.split("_")[0]],
                        "launches": quant_launches[key], **res})
    for kind, label, launches in (
            ("bf16", f"K12 grouped_matmul (bf16; {WG_DESIGN})",
             trained["k12"] + spmd["k12"]["bf16"]),
            ("int8", f"K12 grouped_matmul (int8; {WG_DESIGN})",
             moe_quant["int8"] + spmd["k12"]["int8"]),
            ("e4m3", f"K12 grouped_matmul (e4m3; {WG_DESIGN})",
             moe_quant["float8"] + spmd["k12"]["e4m3"])):
        kernels.append({"name": label, "route": "cuda", "source": MLP_SRC,
                        "replaces": GMM_REPLACES, "launches": launches,
                        **gmm[kind]})
    kernels.append(burn_row)
    if dense_calls():
        fail(f"a path after the breadth phase took the dense attention "
             f"route {dense_calls()} times")
    say(card)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
