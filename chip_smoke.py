"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, all started together; the sLSTM's, the longest, runs on
beside phases 2-n and is waited for before phase o, the first to launch
it) and holds each against its plain PyTorch
version at the main path's shapes: the whole-MLP forward at the serving
path's (both models' G at 64 rows, im2col's also at 1024; a row's bits
the same at 3, 64 and 1024 rows), and the dense layer's forward, dx and
dW/db kernels at Algorithm 1's (batch 1024; 2048 -> 2048, G's head 2048
-> 73, D's first layer 81 -> 2048, D's head 2048 -> 2); every one of
these runs on the 3xTF32 tensor-core tile, so each is also held to a
float64 product.  ptxas's report of the four sources is checked for
spills in every instantiation of their tensor-core kernels (the flash
kernel's 20: 10 with the lse store, 10 without), of the selective scan's
forward (4) and backward (4), and of the sLSTM kernels (48 each, forward
and backward: a batch row count 1-8 by a head width 16-512).  Then, with
the paper's G and D (11 x 2048, batch 1024, random weights from fixed
seeds):

- one Algorithm 1 step on im2col through the kernels against the same
  step on the plain versions (losses, every gradient, the new params),
  its launches, its time and a profile;
- the serving path: ``GANDSE.attach`` + ``explore_batch`` (64 tasks) on
  dnnweaver and im2col, the Selections checked, one warm call profiled;
- the training path: ``GANDSE.train`` on im2col (4096 rows, 2 epochs of 4
  steps), then ``explore_batch`` of 64 tasks on the trained G;
- a reduced-scale quality run on dnnweaver at
  ``experiments/run_comparison.py``'s scale (3 x 256, 8000 rows, 8
  epochs, 200 hard tasks; ``launch/quality.py``), from the reference's
  own initial weights for seed 0, its satisfied count beside the
  reference's.

Then the baselines (phases a-e, each path's launches counted):

- a. the two batched select routes on the serving path's probs (the
  dense route, which ``explore_batch`` takes at this batch and cap, and
  the streaming route), timed in turns: the same Selections, field for
  field, also at a cap of 65536 on im2col;
- b. the whole MLP's gradient (``mlp_apply_chained`` on the card: the
  kernel's forward, the dense kernels' backward) at LargeMLP's 17 layers
  against the plain chain's;
- c. LargeMLP at full width (16 x 2048, batch 1024, im2col): one step
  through the kernels against the plain route and float64; the whole MLP
  at its 17 layers (M = 64 and 1024, as phase 2 holds G's); ``train``
  (4096 rows, 2 epochs) and ``explore_batch`` of 64 tasks; one step
  profiled;
- d. DRL's rollout and SA on the card (class defaults, 64 dnnweaver
  tasks): the CPU port's Selections from the same params and seeds; one
  SA check interval and one DRL rollout timed and profiled beside their
  threefry draws alone;
- e. Table 5 on dnnweaver at the comparison's reduced scale
  (``launch/comparison.py``; GANDSE's row is the quality run's), beside
  the reference's CPU rows; GANDSE satisfies at least as many tasks as
  budget-matched RandomSearch.

Then the DSE serving tier at G 11 x 2048 (phases f-h, each path's
launches counted from zero):

- f. ``launch/dse_serve`` (the sync pump) on im2col, G from the
  reference's init for seed 0: 256 requests in micro-batches of 64, 64
  duplicates queued behind their originals (coalesced) and 64 verbatim
  repeats (cache hits); every request answered, none failed, retried or
  degraded, one ``mlp_forward_f32`` launch a dispatched batch, every
  Selection as one standalone ``explore_tasks`` of the 256 tasks gives
  it; requests/s, ms a dispatch, one warm dispatch profiled;
- g. the same workload through the concurrent front end
  (``--concurrent``): the same checks, p50/p99 latency; then the same
  stream through ``FaultyEngine`` (a burst of 3 batched-route faults,
  ``degrade_after`` 3): the degraded route entered and left, nothing
  lost, every Selection as a standalone ``explore_tasks`` on its route;
- h. ``launch/online`` on dnnweaver (G and D 11 x 2048, batch 64, 4096
  rows, 10 waves of 16, 3 generations, generation 2's checkpoint
  corrupted): 3 generations and swaps, generation 1 served after the
  corrupted save, the dense kernels launched by every training step;
  each generation's train, save and restore seconds and bytes; then a
  generation's training alone on one thread, and one warm step of batch
  64 profiled.

Then the LM serving path of gemma3-1b at full width (26 layers, d 1152,
4 heads / 1 kv head of 256, d_ff 6912, vocab 262144; float32 params from
seed 0): the flash-attention kernel (tensor cores: 3xTF32 for float32,
bf16 with a split P) against its plain version at the prefill's shapes
(and ``bench_kernels.py``'s, a continued prefill, a non-causal one,
mixtral-8x7b's prefill layer;
float32 against float64 attention too, bf16 to one ulp of the plain
version's output); ``make_prefill_step`` on 2 prompts of
4096 tokens through the kernel (26 launches, asserted) and through the
plain attention, their last-token logits compared; and the
continuous-batching ``Engine`` (4 slots, cache 128) serving 8 requests of
12 prompt tokens and 16 new ones, its logits at the prompts' last tokens
held to the prefill step's.

Then LM training (phases i-k):

- i. ``nn/attention.FlashAttentionFn`` (the flash kernel's forward with
  each row's log-sum-exp, ``_flash_custom``'s backward in torch ops) at
  stablelm-1.6b's layer (2 x 2048, 32 heads of 64), gemma3-1b's global
  and local layers (1 x 4096, 4 heads of 256 on one kv head, window
  1024), mixtral-8x7b's (1 x 2048, 32 heads of 128 on 8, window 4096)
  and hymba-1.5b's global and local layers (2 x 2048, 25 heads of 64 on
  5, window 1024 on the local), float32: out the same bits with and
  without lse, lse to the plain version's, out and the three gradients
  against float64 autograd (at most 4x the plain route's error), the
  same bits twice; the forward with and without lse, the backward,
  SDPA's forward and backward timed;
- j. stablelm-1.6b at full width (24 layers, d 2048, d_ff 5632, vocab
  100352, float32 from seed 0), batch 2 x 2048 from ``SyntheticStream``:
  one block against float64; the kernel route's loss and gradients
  against the plain route's from the same state; ``make_train_step``, one
  warm step and 4 timed (24 flash launches with lse a step, asserted),
  tokens/s beside the 6·N·tokens bound, the peak memory, a profiled step;
- k. ``launch/train.main`` on the card at the reduced stablelm config, 12
  steps, once whole and once failing at step 7: it restarts, resumes
  from step 4's checkpoint, and its losses equal the whole run's.

Then the MoE decoders (phase l; float32 from seed 0, phase j's state
freed first):

- l1. the MoE layer (``nn/moe.moe_apply``) of mixtral-8x7b (8 experts of
  4096 -> 14336, top 2) and phi3.5-moe (16 of 4096 -> 6400) at the
  prefill's 8192 tokens: within TOL·scale of the dense-gather oracle
  (``ref.moe_dispatch_ffn``) with the dropped assignments' weights
  zeroed, at a capacity that drops nothing, at the default 1.25
  (capacities 2560 and 1280) and at 1.0, which drops; the routing and
  dispatch integers the CPU port's on the same router logits; the same
  bits twice; the layer, the oracle and the parts timed;
- l2. mixtral-8x7b at full width (d 4096, 32 heads / 8 kv of 128, window
  4096, vocab 32000, untied), its depth cut to MOE_LAYERS (2) layers
  (the script's time limit: one init serves l2-l4):
  ``make_prefill_step`` on 2 x 4096 tokens through the kernel (2 flash
  launches at head dim 128, window 4096, asserted) and through the plain
  attention, their last-token logits compared and the routing flips
  between the two routes counted layer by layer; timed, profiled;
- l3. the ``Engine`` on that model (SERVE's requests): every request
  served, each decode step of the first wave's prompt held to a decode
  step from the plain pieces (each MoE layer the oracle over the step's
  kept assignments; the reference's capacity at decode makes decode
  differ from prefill); ms a step beside the weights-read bound;
- l4. the same model and params (trained last: the step updates them in
  place), batch 1 x 2048 of ``SyntheticStream``: the
  kernel route's loss and gradients the same bits twice and against the
  plain route's (loss within 1e-5, each leaf within 1e-3 of its norm);
  ``make_train_step``: one warm step and 3 timed (2 flash launches with
  lse a step, asserted), the peak memory, a profiled step.

Then hymba-1.5b (phase m; float32 from seed 0, phase l's state freed
first):

- m0. ``init_params(prng_key(0))`` at full width (32 layers, d 1600, 25
  heads / 5 kv of 64, d_ff 5504, vocab 32001, ssm_state 16; 1.59 B
  params) on the card, timed, and its bits held to the CPU's draw: the
  embedding table and layer 0 of every stack, sampled counters of each
  drawn weight (across the chunk boundary where there is one) and the
  other leaves whole.  Every LM phase's init is timed (``init ...``
  lines, the reference's weights for seed 0);
- m1. the selective-scan kernel (``ssm_scan_f32``) at the prefill's
  (2, 4096, 3200, 16) on a layer's own inputs against its plain loop:
  within TOL·scale, the same bits twice, within 4x the plain loop's
  float64 error plus 1e-6·scale; timed beside its bound and the loop;
  flash at hymba's global and local layers joins the flash checks;
- m2. ``make_prefill_step`` at 2 x 4096 through the kernels (32 flash
  and 32 scan launches, asserted) and through the plain pieces, logits
  compared, timed, profiled;
- m3. the ``Engine`` at SERVE: every request served, each decode step of
  the first wave's prompt held to the full-sequence forward at that
  position through the kernels and through the plain pieces; ms a step,
  a decode step profiled.

Then hymba-1.5b training (phase n, on phase m's params):

- n1. the scan's backward kernel (``ssm_scan_bwd_f32``) at the train
  step's layer shape (2, 2048, 3200, 16) and the prefill's (2, 4096,
  ...), on a layer's own inputs and a random dys, from the forward
  kernel's chunk states: within TOL·scale of its plain version
  (``ref.ssm_scan_bwd``) and of torch's autograd of the plain loop, the
  same bits twice, within 4x the plain autograd's float64 error plus
  1e-6·scale; timed beside its bound, the forward with and without its
  chunk states beside it;
- n2. one gradient of the whole model on ``SyntheticStream``'s batch 0
  at 2 x 2048: the kernel route (32 flash launches with lse, 32 scan
  forwards, 32 scan backwards, asserted) the same bits twice and against
  the plain route (``use_fused=False``, remat): the loss within 1e-5,
  each leaf within 1e-3 of its norm;
- n3. ``make_train_step`` (no remat): one warm step and LM_TRAIN_STEPS
  timed, the launches of n2 a step (asserted), tokens/s beside the bound
  (``lm_train_bound_ms`` with the scans'), the peak memory, a profiled
  step;
- n4. ``launch/train.main`` at the reduced hymba config, 12 steps, once
  whole and once failing at step 7: its losses equal the whole run's.

Then xlstm-1.3b (phase o; float32 from seed 0, phase n's state freed
first):

- o0. ``init_params(prng_key(0))`` at full width (48 layers as 6 repeats
  of [mLSTM x 7, sLSTM], d 2048, 4 heads of 512, vocab 50304, tied; 1.14
  B params) on the card, timed, its bits sampled against the CPU's draw
  (the sLSTM's wx is 2^24 counters, ``prng.CHUNK``: drawn in one piece);
- o1. the sLSTM kernel (``slstm_scan_f32``) at the prefill's (2, 4096,
  2048, H 4) and the Engine's (4, 1, ...) layer shapes on a layer's own
  weights, against its plain loop: hs and the final (c, n, m, h) within
  TOL·scale, the same bits twice, within 4x the plain loop's float64
  error plus 1e-6·scale; timed beside its bound and the loop (library:
  none);
- o2. one mLSTM layer (chunkwise) and one sLSTM layer (kernel and plain
  loop) at 2 x 4096 against the same layers in float64;
- o3. ``make_prefill_step`` at 2 x 4096 on the first XLSTM_SERVE_REPEATS
  (3) of the 6 repeats (the script's time limit; ``reduced`` says so)
  through the kernel (3 sLSTM launches, no flash launch, asserted) and
  through the plain loop, timed, profiled (groups ``gemm``, the sLSTM
  kernel, other).  At seed 0's random weights the residual stream grows
  ~4x a repeat and the float32 model's logits at that depth move by
  O(1) under a one-ulp nudge of the embedding, so the two routes' logits
  (and each one's distance from the float64 forward) are reported, not
  held.  Held: each of the 3 sLSTM launches again on its recorded input
  against the plain loop (the last also against float64), and the model
  cut to one repeat (8 layers) through both routes, logits within
  TOL·scale;
- o4. the ``Engine`` at SERVE on the same 3 repeats: every request
  served, 3 sLSTM launches a decode step (asserted), those of the step at the
  prompts' last token held to the plain loop on their recorded inputs
  and states; ms and launches a step; its logits against the stepwise forward and prefill reported;
  a second Engine on the model cut to one repeat, each decode step of
  the first wave's prompt held to the forward at that position and the
  last to ``make_prefill_step`` (both stepwise at 12 tokens), its first
  new tokens the prefill's argmax.

Then xlstm-1.3b training (phase p, on phase o's params):

- p1. the sLSTM backward kernel (``slstm_scan_bwd_f32``) at the train
  step's (2, 2048, 2048, H 4) and the prefill's (2, 4096, ...) layer
  shapes, on the input an sLSTM layer records in the model cut to one
  repeat and a random dys, from the forward kernel's chunk states:
  within TOL·scale of ``ref.slstm_scan_bwd`` and of torch's autograd of
  the plain loop (d_wx, d_rh, d_bias and the initial state's four), the
  same bits twice, within 4x the plain float64 error plus 1e-6·scale;
  the forward's chunk states against the plain loop's; timed beside its
  bound and the plain adjoint loop (library: none), and the forward with
  and without chunk states;
- p2. one gradient of the model cut to one repeat (8 layers) at 2 x
  2048 of ``SyntheticStream``'s batch 0, remat on, through the kernels
  (2 sLSTM forward launches and 1 backward, asserted; the same bits
  twice) and through the plain loop (``use_fused=False``): the loss
  within 1e-5 relative, each leaf within 1e-3 of max(its norm, 1e-6 x
  the gradient's norm); both against a float64 gradient, the kernel
  route no further than twice the plain route;
- p3. ``make_train_step`` on the first 3 of the 6 repeats (24 layers;
  cut for the script's time limit), 2 x 2048 (XLSTM_TRAIN_REMAT): one
  warm step (its peak memory; its gradient's norm as the clip reads
  it, in float32, and in float64; where the float32 norm overflows, the
  plain route's gradient from the same state too, which must overflow
  alike: the reference's math) and XLSTM_TRAIN_STEPS timed (3 sLSTM
  backward launches a step and 3 forward, 6 with remat, asserted), each
  loss and every gradient element finite, tokens/s beside the bound, the
  peak memory, a profiled step;
- p4. ``launch/train.main`` at the reduced xlstm config, 12 steps, once
  whole and once failing at step 7: its losses equal the whole run's.

Then whisper-small (phase q; float32 from seed 0, phase p's state freed
first; 8 windows of 1500 stub frames, ``normal · 0.1``, and the
decoder's 448-token context):

- q1. the flash kernel at whisper's four attention shapes, 8 x 12 heads
  of 64 (the encoder's 1500 x 1500 and the cross-attention's 448 x 1500
  without a mask, the decoder's 448 x 448 causal, decode's 1 x 1500),
  with and without lse (`flash_row`: the plain version, float64, the
  same bits twice, SDPA and the bound beside it); ``FlashAttentionFn``
  at the cross-attention's and the encoder's shapes (`flash_grad_row`);
- q2. ``init_params(prng_key(0))`` at full width (12 + 12 layers, d 768,
  vocab 51865; 295,882,752 params), its bits sampled against the CPU's
  draw; ``encode`` (12 flash launches) and ``make_prefill_step`` on a
  4-token prompt (36) against the plain route; ``make_decode_step`` on
  one ``encode``: the prompt a token a step, then 60 greedy steps (12
  launches a step), the prompt's logits held to the teacher-forced
  forward and the first 8 steps to the plain route's; ms and bounds, a
  prefill and a decode step profiled;
- q3. one gradient at full depth (36 flash launches with lse) against
  the plain route, and the model cut to 2 + 2 layers against float64
  (the kernel route within twice the plain route's error);
  ``make_train_step`` (no remat): one warm step and LM_TRAIN_STEPS
  timed, 36 launches with lse a step, decoder tokens/s and frames/s
  beside the bound, the peak memory, a profiled step.

Then qwen2-vl-7b (phase r; float32 from seed 0, phase q's state freed
first; 28 layers, d 3584, 28 heads / 4 kv of 128, d_ff 18944, vocab
152064, untied, M-RoPE sections (16, 24, 24)):

- r1. the flash kernel at qwen2-vl's layer, 2 x 28 / 4 kv x 4096 x 128
  causal (a GQA group of 7), with and without lse (`flash_row`), and
  ``FlashAttentionFn`` at 2 x 2048 (`flash_grad_row`);
- r2. ``init_params(prng_key(0))`` at full width (7,615,487,488 params,
  asserted), its bits sampled against the CPU's draw;
  ``make_prefill_step`` at 2 x 4096 with the default text positions and
  with QWEN_VISION's (3, B, S) M-RoPE positions (28 flash launches each,
  logits held to the plain route's), timed beside the bound, profiled;
- r3. the ``Engine`` at SERVE (text positions from its clock), its
  prompt-end logits held to the prefill step's, ms a decode step beside
  the weights' read, a profiled step;
- r4. the model cut to QWEN_TRAIN_LAYERS layers (the full model's first
  layers, embedding and head), 2 x 2048 with QWEN_VISION's positions:
  layer 0's block against float64 (`check_lm_block`); one gradient
  through the kernels against the plain route (loss within 1e-5
  relative, each leaf within 1e-3 of its norm); the model cut to one
  layer at 1 x 512 against float64 (the kernel route within twice the
  plain route's error); ``make_train_step`` (no remat): one warm step and
  LM_TRAIN_STEPS timed (one flash launch with lse a layer and step,
  asserted), tokens/s beside the bound, the peak memory, a profiled
  step; then one step in 2 microbatches (the positions cut along B; two
  launches with lse a layer), its loss within 1e-5 of the unsplit
  loss's on the same state.

Then the cost tools (phase s, phase r's state freed first):

- s1. each hand-written kernel at a shape the script launches, on the
  card and on ``meta``: the meta call's outputs have the launch's
  shapes, dtypes and strides (flash's lse and the scans' chunk states
  too), and no launch counter moves;
- s2. every path timed above (the LM prefills, ``Engine`` steps and train
  steps, whisper's ``encode``, prefill and decode step, the MoE layers)
  counted at its own shape and config by ``train/step.build_case`` and
  ``utils/op_cost`` on meta, in a process of its own started with the
  script (``--count-paths``, `count_paths`); its ``t_compute``,
  ``t_memory``, ``t_bound`` and bottleneck on the card's roofline
  (``utils/roofline``) beside the time its phase measured and the
  script's hand bound; every measured time at least its ``t_bound``;
  the counted params of every model built equal the card's;
  ``launch/dryrun.CARD_BYTES`` the card's ``total_memory``;
- s3. ``launch/perf``'s sweep on the card: stablelm-1.6b's train step at
  2 x 2048, microbatches 1 and 2 by remat off and on, one warm step and
  two timed each, the peak memory reset before each: its time at least
  its counted ``t_bound``, its ``max_memory_allocated`` beside the
  counted peak, and a flash launch with lse a layer and microbatch (two
  under remat) a step, as the meta count says.

Then the multi-rank half (phase t, ~60 s):

- t1. a world of one on NCCL, ``launch/mesh.make_host_mesh()`` = (data 1,
  model 1): phase 3's 64-task ``explore_batch`` under ``task_mesh`` gives
  phase 3's Selections; ``train_gan(mesh=)`` at batch 1024 on G/D 11 x
  2048 (2048 rows, 2 epochs) takes the unsharded path and gives the
  no-mesh bits, and one step at batch 32768 is kept for t2; mixtral's
  layer at phase l's 8192 tokens under the mesh takes the ``e_par``
  combine, with the no-mesh bits on finite input and, with token 0
  non-finite, the NaN rows of the CPU port's pieces on the card's
  routing; ``examples/train_lm_torch.py`` at its ~100M model runs
  T_LM_STEPS steps with flash with lse launched and the loss falling;
- t2. two ranks on the one card (gloo, both ``cuda:0``; ``--t2-rank``
  starts each): task-sharded ``explore_batch`` of 64 and 63 tasks gives
  t1's Selections bit for bit; data-parallel ``train_gan``'s first step
  at batch 32768 gives t1's all-reduced gradients and losses within
  T_GRAD_TOL, and 2 epochs at batch 1024 track t1's run (the same params
  on both ranks, loss_g within 1e-3, at most 1% of the params outside
  rtol 2e-4 / atol 1e-6), with the whole MLP and the three dense kernels
  launched in each rank (``t2_failures``).  ms a task and ms a step of t1 and t2 beside the
  card's name and power limit; two ranks time-slice one card, so t2
  checks correctness, not speed.

Then serving and training across a 'model' axis (phase u): two ranks on the
one card (``--u-rank`` starts each; gloo, both ``cuda:0``, a (1, 2)
('data', 'model') mesh), each building the full params from seed 0 of
stablelm-1.6b at full width and depth and of mixtral-8x7b at full width
cut to phase l4's 2 layers.  Rank 0 first runs the world of one with
them (no mesh: stablelm's 2 x 2048 prefill and 8 ``Engine`` steps,
mixtral's 1 x 2048 prefill, ``train_gan``'s first step at batch 1024).
Then each rank keeps its blocks under ``param_specs(fsdp=True)`` (the
``Engine`` shards them and its decode states, ``state_specs``) and drops
the rest: its param bytes equal its spec blocks' and its card memory
little more; stablelm's prefill launches flash once a layer on 16 of 32
heads, mixtral's on 16 with 4 experts a rank, each within TOL·scale of
the world of one's logits with its argmax; the ``Engine``'s tokens are
the world of one's; on the (1, 2) task mesh ``explore_batch``'s
Selections are t1's and ``train_gan``'s first step the world of one's
within T_GRAD_TOL, with the whole MLP and the dense kernels launched in
each rank.  Each model is trained last, after its serving checks (the
step updates the params in place): from the full params every rank
takes the world of one's gradient (remat on) and keeps its blocks of it,
then rank 0 alone times it again (with stablelm's AdamW update); then
each rank trains its blocks with ``make_train_step(mesh=)`` at 2 x 2048
and 1 x 2048 (remat, act_shard 'model'), its collectives timed forward
and backward apart: the loss within 1e-5 of the world of one's, every
gradient block within U_GRAD_TOL of its leaf's norm, flash with lse on
16 of 32 heads twice a layer (forward and recompute), params, mu and nu
the spec blocks' bytes, mixtral's 4 experts a rank with no routing flip
between the ranks, and after the step every replicated leaf the same
bits on both ranks (``u_failures``).  Then the same for hymba-1.5b,
xlstm-1.3b and whisper-small at full width (ROADMAP Queue 1 item 6c):
hymba at full depth, its 1 x 2048 prefill (flash on all 25 heads, which
2 does not divide; the selective scan on 1600 of 3200 channels) and 8
``Engine`` steps, trained at 1 x 2048 on its first global and first
local layer; xlstm cut to one repeat (8 blocks), its 1 x 2048 prefill
(the sLSTM kernel on all 4 heads: it runs replicated), 8 ``Engine``
steps and one train step; whisper at full depth, a prefill of 448
tokens on 1500 frames (flash on 6 of 12 heads: encoder, decoder and 448
x 1500 cross-attention), ``encode`` and 8 ``make_decode_step`` steps,
one train step at 1 x 448; each held to the world of one as above, the
bytes kept to the spec blocks' (whisper's table stays whole).  Each
path's ms and its collectives' share, and each rank's peak memory,
beside the card's name and power limit.

Then the cost tools across a mesh (phase s4): ``launch/perf
--mesh-shape 1x2 --dtype float32`` counts stablelm-1.6b's prefill (2 x
2048) and train step (2 x 2048, remat, act_shard 'model') as rank 0 of
a fake process group of 2 on meta (``launch/mesh.counting_world``), in
two processes started with the script beside s2's; their collective
calls and bytes equal, exactly, what phase u measured on each rank (the
train step's global norm included), printed beside each rank's
``max_memory_allocated`` and the counted peak, phase u's ms and the
counted ``t_bound``, and the card's torch's process-group backends
(the fake one among them).

Exits non-zero on any failure, and when no CUDA device is present.  The
last line of output is ``{"ok": true, "device": {...}}``; the lines before
it are the kernel table (JSON) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))
from repro_torch.baselines import (LargeMLP, PolicyGradientDRL,  # noqa: E402
                                   SimulatedAnnealing)
from repro_torch.baselines import drl as DRL  # noqa: E402
from repro_torch.baselines import sa as SA  # noqa: E402
from repro_torch.baselines.sa import anneal as sanneal  # noqa: E402
from repro_torch.core import dse_api as dse  # noqa: E402
from repro_torch.core.explorer import (enumerate_candidates_batch,  # noqa: E402
                                       task_keys)
from repro_torch.core import fused_select as fs  # noqa: E402
from repro_torch.core import gan as G  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import train as T  # noqa: E402
from repro_torch.core.selector import select_batch  # noqa: E402
from repro_torch.dataset import generator as gen_mod  # noqa: E402
from repro_torch.design_models import DnnWeaverModel, Im2colModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data.synthetic import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_dense as fd  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import slstm_scan as sl  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.launch import comparison as CMP  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import dse_serve  # noqa: E402
from repro_torch.launch import online  # noqa: E402
from repro_torch.launch import quality as Q  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.configs.qwen2_vl_7b import vision_positions  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.configs.whisper_small import DECODER_TRAIN_LEN  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import base as MB  # noqa: E402
from repro_torch.nn import attention as A  # noqa: E402
from repro_torch.nn import blocks as NB  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402
from repro_torch.nn import moe as MOE  # noqa: E402
from repro_torch.nn import ssm as SSM  # noqa: E402
from repro_torch.nn import xlstm as XL  # noqa: E402
from repro_torch.optim import (adam, apply_updates, tree_leaves,  # noqa: E402
                               tree_map, tree_unflatten)
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.core import shard  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.train import shardings as SH  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.utils import op_cost  # noqa: E402
from repro_torch.utils import roofline as RL  # noqa: E402

# H100 SXM data-sheet peaks (dense, no sparsity)
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12    # HBM3
PEAK_BF16_FLOPS = 989e12    # bf16 in the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 in the tensor cores
#: exponentials a second on the SFUs: 16 an SM a clock (4 a quadrant),
#: 132 SMs at the 1.98 GHz boost clock; for information beside the bound
SFU_EXP_PER_S = 16 * 132 * 1.98e9
N_TASKS = 64
TOL = 1e-4                  # max|y_k - y_ref| <= TOL * max(1, max|y_ref|)
BATCH = 1024                # Algorithm 1's batch (Table 4)
#: Algorithm 1's dense-layer shapes (M, K, N, relu) at 11 x 2048
DENSE_SHAPES = {
    "hidden 2048->2048": (BATCH, 2048, 2048, True),
    "G head 2048->73": (BATCH, 2048, 73, False),
    "D first 81->2048": (BATCH, 81, 2048, True),
    "D head 2048->2": (BATCH, 2048, 2, False),
}
#: the dense kernels: wrapper, TPU kernel it replaces
DENSE_KERNELS = {
    "dense_forward_f32": (fd.dense_forward,
                          "src/repro/kernels/fused_mlp.py:71"),
    "dense_dx_f32": (fd.dense_dx, "src/repro/kernels/fused_mlp.py:121"),
    "dense_dw_db_f32": (fd.dense_dw_db, "src/repro/kernels/fused_mlp.py:143"),
}
#: the kernels on the tensor cores, three TF32 products a product (3xTF32)
TF32_KERNELS = ("dense_forward_f32", "dense_dx_f32", "dense_dw_db_f32")
#: the flash kernel's shapes: (B, H, Hkv, Sq, Sk, D, causal, window,
#: q_offset).  gemma3-1b's global and local layers at the prefill's 2 x
#: 4096 tokens, benchmarks/bench_kernels.py's shape, a continued prefill
#: (the last 1024 rows), and a non-causal case
FLASH_SHAPES = {
    "gemma3 global 2x4x4096x256": (2, 4, 1, 4096, 4096, 256, True, None, 0),
    "gemma3 local 2x4x4096x256 w1024": (2, 4, 1, 4096, 4096, 256, True,
                                        1024, 0),
    "bench 1x8x512x64 kv2": (1, 8, 2, 512, 512, 64, True, None, 0),
    "q_offset 3072 2x4x1024x256 kv4096": (2, 4, 1, 1024, 4096, 256, True,
                                          None, 3072),
    "non-causal 2x4x1024x256": (2, 4, 1, 1024, 1024, 256, False, None, 0),
    "mixtral 2x32x4096x128 kv8 w4096": (2, 32, 8, 4096, 4096, 128, True,
                                        4096, 0),
    "hymba global 2x25x4096x64 kv5": (2, 25, 5, 4096, 4096, 64, True, None,
                                      0),
    "hymba local 2x25x4096x64 kv5 w1024": (2, 25, 5, 4096, 4096, 64, True,
                                           1024, 0),
}
BF16_TOL = 3e-2             # the reference's own bf16 kernel test
LM_ARCH = "gemma3-1b"
PREFILL = (2, 4096)         # prefill_32k cut in batch and length
SERVE = dict(slots=4, cache_len=128, requests=8, prompt_len=12, max_new=16)
#: the reference's quality run on dnnweaver from seed 0, GANDSE's row of
#: ``experiments/run_comparison.py --models dnnweaver --seed 0`` on an
#: x86-64 CPU with jax 0.9 (PERF.md): satisfied of 200, mean candidates.
#: EXPERIMENTS.md's 93 of 200 (2.4) is an earlier run, not reproduced
REF_QUALITY = (56, 2.005)
#: LM training: stablelm-1.6b at full width, float32, batch x seq
LM_TRAIN_ARCH = "stablelm-1.6b"
LM_TRAIN = (2, 2048)
LM_TRAIN_STEPS = 4           # timed, after one warm step
#: the flash Function's layer shapes, float32: (B, H, Hkv, S, D, window)
FLASH_GRAD_SHAPES = {
    "stablelm-1.6b 2x32x2048x64": (2, 32, 32, 2048, 64, None),
    "gemma3 global 1x4x4096x256 kv1": (1, 4, 1, 4096, 256, None),
    "gemma3 local 1x4x4096x256 kv1 w1024": (1, 4, 1, 4096, 256, 1024),
    "mixtral 1x32x2048x128 kv8 w4096": (1, 32, 8, 2048, 128, 4096),
    "hymba global 2x25x2048x64 kv5": (2, 25, 5, 2048, 64, None),
    "hymba local 2x25x2048x64 kv5 w1024": (2, 25, 5, 2048, 64, 1024),
}
#: launch/train at the reduced stablelm config, restarted once at step 7
LAUNCHER_ARGV = ["--arch", LM_TRAIN_ARCH, "--steps", "12", "--batch", "8",
                 "--seq", "128", "--ckpt-every", "4", "--log-every", "1"]
#: phase l: the MoE decoders at full width, float32 from seed 0.  The MoE
#: layer of both archs at the prefill's tokens; mixtral with its depth
#: cut (its 32 layers are 187 GB in float32) to MOE_LAYERS, one init to
#: serve and then train at MOE_TRAIN (batch x seq)
MOE_ARCH = "mixtral-8x7b"
MOE_LAYER_ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b")
MOE_LAYERS = 2
MOE_TRAIN = (1, 2048)
MOE_TRAIN_STEPS = 3          # timed, after one warm step
#: phase m: hymba-1.5b at full width (32 layers, d 1600, 25 heads / 5 kv
#: of 64, the SSM branch in every layer), float32 from seed 0: prefill at
#: PREFILL, the Engine at SERVE
HYMBA_ARCH = "hymba-1.5b"
#: phase n: hymba-1.5b training at full width on phase m's params, at
#: stablelm's cell (LM_TRAIN, LM_TRAIN_STEPS timed steps, no remat: the
#: peak fits); the scan's backward alone at the train step's and the
#: prefill's layer shapes; the launcher at the reduced config, restarted
#: once at step 7
SSM_BWD_SHAPES = {"train step": LM_TRAIN, "prefill": PREFILL}
HYMBA_LAUNCHER_ARGV = ["--arch", HYMBA_ARCH] + LAUNCHER_ARGV[2:]
#: phase o: xlstm-1.3b at full width (6 repeats of [mLSTM x 7, sLSTM], d
#: 2048, 4 heads of 512), float32 from seed 0: prefill at PREFILL and the
#: Engine at SERVE on the first XLSTM_SERVE_REPEATS repeats (24 of 48
#: layers: the script's time limit); the sLSTM kernel alone at both
#: paths' layer shapes
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_SERVE_REPEATS = 3
SLSTM_SHAPES = {"prefill": PREFILL, "engine": (SERVE["slots"], 1)}
#: phase p: xlstm-1.3b training on phase o's params at LM_TRAIN: the
#: sLSTM backward alone at the train step's and the prefill's layer
#: shapes; the train step on the first XLSTM_TRAIN_REPEATS of the 6
#: repeats (24 of 48 layers: the script's time limit), XLSTM_TRAIN_STEPS
#: timed after a warm one, without remat (the reference's default is
#: remat; a full-depth gradient without it peaks at ~48 GB on the card,
#: under the ~70 GB past which remat pays, PERF.md §6); the launcher at
#: the reduced config, restarted once at step 7
SLSTM_BWD_SHAPES = {"train step": LM_TRAIN, "prefill": PREFILL}
XLSTM_TRAIN_REMAT = False
XLSTM_TRAIN_REPEATS = 3
XLSTM_TRAIN_STEPS = 1
XLSTM_LAUNCHER_ARGV = ["--arch", XLSTM_ARCH] + LAUNCHER_ARGV[2:]
#: phase q: whisper-small at full width (12 encoder + 12 decoder layers,
#: d 768, 12 heads of 64, d_ff 3072, vocab 51865, tied; 295,882,752
#: params), float32 from seed 0, once phase p's state is freed: a batch
#: of WHISPER_BATCH 30 s windows (1500 stub frames each, ``normal · 0.1``)
#: and the decoder's 448-token context (``DECODER_TRAIN_LEN``).  Serving:
#: a WHISPER_PROMPT-token prompt, fed a token a decode step, then
#: WHISPER_NEW greedy steps, the first WHISPER_TEACHER held to the plain
#: route's; the float64 gradient on the model cut to WHISPER_CUT_LAYERS
#: encoder and decoder layers
WHISPER_ARCH = "whisper-small"
WHISPER_BATCH = 8
WHISPER_PROMPT = 4
WHISPER_NEW = 60
WHISPER_TEACHER = 8
WHISPER_CUT_LAYERS = 2
#: the flash kernel at whisper's attention shapes, as FLASH_SHAPES
WHISPER_FLASH_SHAPES = {
    "whisper encoder 8x12x1500x64": (8, 12, 12, 1500, 1500, 64, False,
                                     None, 0),
    "whisper decoder 8x12x448x64": (8, 12, 12, 448, 448, 64, True, None, 0),
    "whisper cross 8x12x448x1500x64": (8, 12, 12, 448, 1500, 64, False,
                                       None, 0),
    "whisper decode cross 8x12x1x1500x64": (8, 12, 12, 1, 1500, 64, False,
                                            None, 0),
}
#: the flash Function at whisper's unmasked shapes: (B, H, Hkv, Sq, Sk, D,
#: causal, window)
WHISPER_FLASH_GRAD_SHAPES = {
    "whisper cross 8x12x448x1500x64": (8, 12, 12, 448, 1500, 64, False,
                                       None),
    "whisper encoder 8x12x1500x64": (8, 12, 12, 1500, 1500, 64, False,
                                     None),
}
#: phase r: qwen2-vl-7b at full width (7,615,487,488 params), float32
#: from seed 0, once phase q's state is freed; its training at
#: QWEN_TRAIN_LAYERS of 28 layers (params, gradients and Adam's two
#: moments of the full depth come to ~122 GB)
QWEN_ARCH = "qwen2-vl-7b"
QWEN_PARAMS = 7_615_487_488
QWEN_TRAIN_LAYERS = 4
#: a prompt's vision layout (Qwen2-VL, arXiv:2409.12191 §2.1): 16 text
#: tokens, a 32 x 32 image at one temporal position, then text
QWEN_VISION = dict(text=16, grid=32)
QWEN_FLASH_SHAPES = {
    "qwen2-vl 2x28x4096x128 kv4": (2, 28, 4, 4096, 4096, 128, True, None,
                                   0),
}
#: the flash Function at qwen2-vl's train step: (B, H, Hkv, Sq, Sk, D,
#: causal, window)
QWEN_FLASH_GRAD_SHAPES = {
    "qwen2-vl 2x28x2048x128 kv4": (2, 28, 4, 2048, 2048, 128, True, None),
}
#: the float64 gradient's batch and its layout (16 text tokens, a 16 x 16
#: image, then text)
QWEN_F64_BATCH = (1, 512)
QWEN_F64_VISION = dict(text=16, grid=16)
#: seconds of each LM's ``init_params`` on the card, by label
INIT_S: dict = {}
#: the config of each model ``init_lm`` built, by the same label
MODELS: dict = {}
#: phase s3: launch/perf's sweep of LM_TRAIN_ARCH's train step at
#: LM_TRAIN, (microbatches, remat) a variant, PERF_SWEEP_STEPS timed steps
#: after one warm step each
PERF_SWEEP = tuple((micro, remat) for micro in (1, 2)
                   for remat in (False, True))
PERF_SWEEP_STEPS = 1


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` single-call times with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def mlp_work(m: int, ws, bs) -> tuple:
    """Bytes the whole-MLP forward must move (each input read once, the
    output written once) and its 2·M·K·N product flops per layer (the
    bias adds apart): the kernel's own ``fm.work``."""
    flops, n_bytes, _ = fm.work(m, [ws[0].shape[0]]
                                + [w.shape[1] for w in ws])
    return n_bytes, flops


def mlp_bound_ms(m: int, ws, bs) -> tuple:
    """Least time for the whole-MLP forward on this card, the way it
    computes: its bytes over HBM against three TF32 products at 495
    TFLOP/s (3xTF32)."""
    n_bytes, flops = mlp_work(m, ws, bs)
    return bound(n_bytes, 3 * flops, PEAK_TF32_FLOPS)


def mlp_simt_bound_ms(m: int, ws, bs) -> float:
    """The same bound outside the tensor cores: the product and the bias
    adds at the float32 SIMT peak."""
    n_bytes, flops = mlp_work(m, ws, bs)
    return bound(n_bytes, flops + m * sum(b.numel() for b in bs))[0]


#: the launch counters' names (``counts``), which the kernels' meta
#: routes also charge under (flash with lse apart from flash without)
KERNEL_NAMES = ("mlp_forward_f32", "dense_forward_f32", "dense_dx_f32",
                "dense_dw_db_f32", "flash_attention_f32",
                "flash_attention_f32 with lse", "ssm_scan_f32",
                "ssm_scan_bwd_f32", "slstm_scan_f32", "slstm_scan_bwd_f32")


def zero_counts() -> None:
    fm.fused_mlp.launches = 0
    fa.flash_attention.launches = 0
    fa.flash_attention.lse_launches = 0
    ss.ssm_scan.launches = 0
    ss.ssm_scan_bwd.launches = 0
    sl.slstm_scan.launches = 0
    sl.slstm_scan_bwd.launches = 0
    for wrapper, _ in DENSE_KERNELS.values():
        wrapper.launches = 0


def counts() -> dict:
    out = {"mlp_forward_f32": fm.fused_mlp.launches,
           "flash_attention_f32": fa.flash_attention.launches,
           "flash_attention_f32 with lse": fa.flash_attention.lse_launches,
           "ssm_scan_f32": ss.ssm_scan.launches,
           "ssm_scan_bwd_f32": ss.ssm_scan_bwd.launches,
           "slstm_scan_f32": sl.slstm_scan.launches,
           "slstm_scan_bwd_f32": sl.slstm_scan_bwd.launches}
    out.update({name: w.launches for name, (w, _) in DENSE_KERNELS.items()})
    return out


def print_builds(names) -> None:
    for name in names:
        info = build.build_info[name]
        print(f"built {name} -> {info['path']} in {info['seconds']:.1f} s",
              flush=True)
        print(str(info["log"]).strip(), flush=True)


def build_all() -> tuple:
    """Phase 1: one nvcc per source, started together.  Waits for every
    source but flash's and the sLSTM's, the longest builds, which no phase
    before 6 and o launches: those nvccs run on beside phases 2-h and 2-n,
    and the Futures it returns, (flash's, the sLSTM's), are waited for
    before phases 6 and o."""
    loads = (fm.load_library, fd.load_library, ss.load_library)
    pool = concurrent.futures.ThreadPoolExecutor(len(loads) + 2)
    late = (pool.submit(fa.load_library), pool.submit(sl.load_library))
    for f in [pool.submit(load) for load in loads]:
        f.result()
    pool.shutdown(wait=False)
    print_builds(["mlp_forward.cu", "dense_train.cu", "ssm_scan.cu"])
    return late


#: the tensor-core kernel of each source, the selective scan's two and
#: the sLSTM's two, whose instantiations ptxas must not spill, and how
#: many there are
SPILL_CHECKS = (("dense_train.cu", "gemm_3xtf32_kernel", 12),
                ("mlp_forward.cu", "gemm_3xtf32_kernel", 12),
                ("flash_attention.cu", "flash_fwd_kernel", 20),
                ("ssm_scan.cu", "ssm_scan_kernel", 4),
                ("ssm_scan.cu", "ssm_scan_bwd_kernel", 4),
                ("slstm_scan.cu", "slstm_scan_kernel", 48),
                ("slstm_scan.cu", "slstm_scan_bwd_kernel", 48))


def check_spills(sources) -> dict:
    """ptxas's report (-Xptxas -v) for each instantiation of the
    tensor-core kernel in each source that holds it, of the selective
    scan's forward and backward (one per state size each) and of the
    sLSTM's forward and backward (one per batch row count and head width
    each): registers and no spill stores or loads."""
    out = {}
    for source, kernel, count in SPILL_CHECKS:
        if source not in sources:
            continue
        log = str(build.build_info[source]["log"])
        if not log:
            print(f"{source} was loaded from an earlier build: no ptxas "
                  "report", flush=True)
            continue
        found, name = {}, None
        for line in log.splitlines():
            if "Function properties for " in line:
                name = line.split("Function properties for ")[1].strip()
            elif name and kernel in name and "spill stores" in line:
                stores, loads = (int(line.split(" bytes spill " + w)[0]
                                     .split(",")[-1]) for w in ("stores",
                                                                "loads"))
                assert stores == 0 and loads == 0, f"{name} spills: {line}"
                found[name] = dict(spill_stores=stores, spill_loads=loads)
            elif name and kernel in name and "Used " in line:
                found[name]["registers"] = int(
                    line.split("Used ")[1].split()[0])
                name = None
        assert len(found) == count, \
            f"{len(found)} of {count} {kernel} in the ptxas report of {source}"
        print(f"{kernel} in {source}: {len(found)} instantiations, "
              f"registers {sorted(v.get('registers') for v in found.values())}"
              ", no spills", flush=True)
        out[f"{source} {kernel}"] = found
    return out


def bound(n_bytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple:
    t_bytes, t_ops = n_bytes / PEAK_HBM_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def dense_work(kernel: str, m: int, k: int, n: int, relu: bool) -> tuple:
    """Bytes one dense kernel must move (each operand read once, each
    output written once) and its float32 flops (the 2·M·K·N product, the
    bias adds or db sums, the mask multiplies)."""
    dy_y = m * n * (2 if relu else 1)         # dy, and y for the mask
    mask = m * n if relu else 0
    if kernel == "dense_forward_f32":
        return 4 * (m * k + k * n + n + m * n), 2 * m * k * n + m * n
    if kernel == "dense_dx_f32":
        return 4 * (dy_y + k * n + m * k), 2 * m * k * n + mask
    return 4 * (m * k + dy_y + k * n + n), 2 * m * k * n + m * n + mask


def simt_bound_ms(kernel: str, m: int, k: int, n: int, relu: bool) -> float:
    """Least time for one dense kernel outside the tensor cores: its bytes
    over HBM against its flops at the float32 SIMT peak."""
    return bound(*dense_work(kernel, m, k, n, relu))[0]


def dense_bound_ms(kernel: str, m: int, k: int, n: int, relu: bool) -> tuple:
    """Least time for one dense kernel on this card, the way it computes:
    on the tensor cores, its bytes over HBM against three TF32 products
    of 2·M·K·N flops at 495 TFLOP/s (3xTF32)."""
    n_bytes, flops = dense_work(kernel, m, k, n, relu)
    if kernel not in TF32_KERNELS:
        return bound(n_bytes, flops)
    return bound(n_bytes, 3 * 2 * m * k * n, PEAK_TF32_FLOPS)


#: (query, key) pairs the masks keep for one head
kept_pairs = fa.kept_pairs


def flash_work(shape, dtype) -> tuple:
    """Bytes one flash-attention call must move (q, k, v read once, o
    written once) and the 4·D flops of QKᵀ and PV for every kept (query,
    key) pair (``fa.work``'s bytes; its float32 flops)."""
    work = functools.partial(fa.work, *shape)
    return work(dtype)[1], work(torch.float32)[0]


def flash_bound_ms(shape, dtype) -> tuple:
    """Least time for one flash-attention call on this card, the way the
    kernel computes: its bytes over HBM against three TF32 products of
    each product flop at 495 TFLOP/s (float32, 3xTF32: 12·D a pair) or
    one bf16 product for QKᵀ and two for PV at 989 TFLOP/s (bf16, P split
    into hi + lo: 6·D a pair)."""
    n_bytes, flops = flash_work(shape, dtype)
    if dtype == torch.float32:
        return bound(n_bytes, 3 * flops, PEAK_TF32_FLOPS)
    return bound(n_bytes, 1.5 * flops, PEAK_BF16_FLOPS)


def flash_bound_4d_ms(shape, dtype) -> float:
    """The same call's bound at 4·D flops a pair, at the float32 rate
    outside the tensor cores (float32) or at the bf16 rate (bf16)."""
    n_bytes, flops = flash_work(shape, dtype)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    return bound(n_bytes, flops, peak)[0]


def flash_float64(q, k, v, causal, window, q_offset):
    """Attention with the plain version's masks, in float64."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, hkv, h // hkv, sq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.double()) / d ** 0.5
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos[:, None] >= kpos[None, :]
    if window:
        keep &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(keep, s, ref.NEG_INF)
    out = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, -1), v.double())
    return out.reshape(b, h, sq, d)


def bf16_ulp(x) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = torch.floor(torch.log2(x.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _err(got, want) -> float:
    return float((got - want).abs().max()) if want.numel() else 0.0


def _hold(label: str, got, want) -> float:
    """got finite and within TOL·max(1, max|want|) of want."""
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), f"{label}: not finite"
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    err = _err(got, want)
    assert err <= TOL * scale, f"{label}: {err} > {TOL * scale}"
    return err


def library_tf32_ms(fn) -> float:
    """CUDA-event median of `fn` with TF32 allowed in float32 matmuls
    (restored after): for information beside the float32 library time."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return cuda_ms(fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def library_dw_db(x, dy, y, relu: bool) -> tuple:
    """dW and db in PyTorch calls from the kernel's own inputs (the mask
    included, as dx's library call includes it)."""
    g = dy * (y > 0) if relu else dy
    return x.t() @ g, g.sum(0)


def check_dense() -> dict:
    """Phase 2b: each dense kernel against its plain version at Algorithm
    1's shapes; two calls give the same bits; each kernel's errors from a
    float64 product no more than 4x the plain float32 version's plus
    1e-6·scale; CUDA-event medians of the kernel, the plain version and
    one library call (float32, and with TF32 allowed)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = {name: {} for name in DENSE_KERNELS}
    for label, (m, k, n, relu) in DENSE_SHAPES.items():
        x = torch.randn(m, k, generator=gen, device="cuda")
        w = torch.randn(k, n, generator=gen, device="cuda") * (2.0 / k) ** 0.5
        b = torch.randn(n, generator=gen, device="cuda") * 0.1
        dy = torch.randn(m, n, generator=gen, device="cuda")
        y = ref.fused_dense(x, w, b, relu)
        g = dy * (y > 0) if relu else dy
        calls = {
            "dense_forward_f32": (
                lambda: fd.dense_forward(x, w, b, relu),
                lambda: ref.fused_dense(x, w, b, relu),
                (lambda: torch.relu_(torch.addmm(b, x, w))) if relu
                else (lambda: torch.addmm(b, x, w))),
            "dense_dx_f32": (
                lambda: fd.dense_dx(dy, y, w, relu),
                lambda: ref.dense_dx(dy, y, w, relu),
                lambda: (dy * (y > 0) if relu else dy) @ w.t()),
            "dense_dw_db_f32": (
                lambda: fd.dense_dw_db(x, dy, y, relu),
                lambda: ref.dense_dw_db(x, dy, y, relu),
                lambda: library_dw_db(x, dy, y, relu)),
        }
        g64 = g.double()
        y64 = x.double() @ w.double() + b.double()
        exact = {"dense_forward_f32": (torch.relu(y64) if relu else y64,),
                 "dense_dx_f32": (g64 @ w.double().t(),),
                 "dense_dw_db_f32": (x.double().t() @ g64, g64.sum(0))}
        for name, (kern, plain, library) in calls.items():
            got, want = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            got, want, again = (t if isinstance(t, tuple) else (t,)
                                for t in (got, want, again))
            err = max(_hold(f"{name} {label}", a, b_)
                      for a, b_ in zip(got, want))
            assert all(torch.equal(a, c) for a, c in zip(got, again)), \
                f"{name} {label}: two calls differ"
            bnd, by = dense_bound_ms(name, m, k, n, relu)
            row = dict(max_abs_err=err)
            row.update(float64_errors(f"{name} {label}", got, want,
                                      exact[name]))
            row.update(
                ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library),
                library_tf32_ms=library_tf32_ms(library), bound_ms=bnd,
                bound_by=by, simt_bound_ms=simt_bound_ms(name, m, k, n, relu),
                bound_peak="3xTF32, 495 TFLOP/s")
            rows[name][label] = row
            print(f"dense {name} {label}: " + json.dumps(rows[name][label]),
                  flush=True)
    return rows


def float64_errors(label: str, got, want, exact) -> dict:
    """Max errors of the kernel's and the plain version's outputs from
    the float64 product; the kernel's at most 4x the plain float32
    version's plus 1e-6·scale (what a single-pass TF32 kernel misses)."""
    e_k = e_p = 0.0
    for a, p_, t in zip(got, want, exact):
        ek, ep = _err(a.double(), t), _err(p_.double(), t)
        scale = max(1.0, float(t.abs().max())) if t.numel() else 1.0
        assert ek <= 4 * ep + 1e-6 * scale, \
            f"{label}: {ek} from float64, plain float32 {ep}"
        e_k, e_p = max(e_k, ek), max(e_p, ep)
    return dict(max_abs_err_f64=e_k, plain_max_abs_err_f64=e_p)


def check_step(model) -> dict:
    """Phase 2c: one Algorithm 1 step at the paper's width from one state,
    through the kernels, through the plain versions (use_fused=False) in
    float32, and through the plain versions in float64, on the card.

    The losses of the two float32 routes agree at TOL·max(1, |loss|), as
    the kernels are held.  The gradients (read from the first Adam moment,
    0.1·g after one step from zero moments) cannot be held to each other
    element by element: a pre-activation within float32 rounding of 0
    takes the other side of the ReLU mask in the other route, which moves
    that unit's gradient for that row and everything below it, and across
    the 23 layers between the losses and G's first layer that adds up to
    about 1e-3 of a leaf's norm on an H100 (PERF.md).  So each route's
    gradients are held to the float64 step's in the norm of each leaf: the
    kernel route may be no further from it than TOL plus twice the plain
    float32 route's distance.  The new params are not compared: Adam's
    first step moves each weight by about ±lr whatever the gradient's
    size, so a near-zero gradient whose sign differs moves a weight by
    2·lr.  Counts the kernel route's launches, times warm steps of both
    float32 routes (host clock ended by a synchronize), and profiles one
    kernel-route step."""
    cfg = G.GANConfig(n_net=model.net_space.n_dims)        # 11 x 2048
    ds = gen_mod.generate_dataset(model, BATCH, seed=0)
    batch = T.encode_dataset(model, ds, "cuda")
    st = T.init_state(model, cfg, 0, "cuda")
    args = (st.g_params, st.d_params, st.g_opt, st.d_opt, batch, st.rng)
    plain_cfg = dataclasses.replace(cfg, use_fused=False)
    steps = {"kernel": T.make_train_step(model, cfg)[2],
             "plain": T.make_train_step(model, plain_cfg)[2]}
    outs = {}
    for route, step in steps.items():
        zero_counts()
        outs[route] = step(*args)
        torch.cuda.synchronize()
        if route == "kernel":
            launches = counts()
    f64 = lambda t: t.double() if t.is_floating_point() else t
    args64 = tuple(tree_map(f64, a) for a in args)
    outs["float64"] = steps["plain"](*args64)
    (*k_out, k_met), (*p_out, p_met) = outs["kernel"], outs["plain"]
    layers = cfg.g_hidden_layers + 1
    want = {"dense_forward_f32": 3 * layers,
            "dense_dx_f32": 3 * layers - 2, "dense_dw_db_f32": 2 * layers}
    for name, n in want.items():
        assert launches[name] == n, (name, launches[name], n)
    for key in k_met:
        a, b_ = float(k_met[key]), float(p_met[key])
        assert abs(a - b_) <= TOL * max(1.0, abs(b_)), (key, a, b_)

    def norm_err(a, b_):
        return float(torch.linalg.vector_norm(a.double() - b_.double())) / \
            max(float(torch.linalg.vector_norm(b_.double())), 1e-30)

    grads = {}
    for i, what in ((2, "G"), (3, "D")):
        g = {r: [m / 0.1 for m in tree_leaves(outs[r][i].mu)]
             for r in outs}
        e_k = [norm_err(a, t) for a, t in zip(g["kernel"], g["float64"])]
        e_p = [norm_err(a, t) for a, t in zip(g["plain"], g["float64"])]
        for li, (ek, ep) in enumerate(zip(e_k, e_p)):
            assert ek <= TOL + 2 * ep, \
                f"{what} gradient leaf {li}: {ek} from float64, plain {ep}"
        pairs = list(zip(g["kernel"], g["plain"]))
        grads[what] = dict(
            max_norm_err_kernel_vs_float64=max(e_k),
            max_norm_err_plain_vs_float64=max(e_p),
            max_norm_err_kernel_vs_plain=max(norm_err(a, b_)
                                             for a, b_ in pairs),
            max_abs_err_kernel_vs_plain=max(_err(a, b_) for a, b_ in pairs),
            max_abs=max(float(b_.abs().max()) for _, b_ in pairs),
            n=sum(b_.numel() for _, b_ in pairs))
    assert torch.equal(k_out[4], p_out[4])

    def ms_per_step(step, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    out = dict(metrics={k: float(v) for k, v in k_met.items()},
               gradients=grads, launches=launches,
               ms_per_step=ms_per_step(steps["kernel"]),
               plain_ms_per_step=ms_per_step(steps["plain"]),
               bound_ms_per_step=step_bound_ms(cfg, model),
               profile=profile_step(steps["kernel"], args))
    print("algorithm1 step: " + json.dumps(out), flush=True)
    return out


def step_bound_ms(cfg, model) -> float:
    """Sum of the dense kernels' bounds over one step (36 forward, 34 dx,
    24 dW/db at 11 layers): the step's least time if nothing else ran."""
    g_dims = ([cfg.n_net + cfg.n_obj + cfg.noise_dim]
              + [cfg.g_neurons] * cfg.g_hidden_layers
              + [model.space.onehot_width])
    d_dims = ([cfg.n_net + model.space.onehot_width + cfg.n_obj]
              + [cfg.d_neurons] * cfg.d_hidden_layers + [2])
    total = 0.0

    def net(dims, fwd, dx_from, dw):
        nonlocal total
        for li, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
            relu = li < len(dims) - 2
            total += fwd * dense_bound_ms("dense_forward_f32", BATCH, k, n,
                                          relu)[0]
            total += dw * dense_bound_ms("dense_dw_db_f32", BATCH, k, n,
                                         relu)[0]
            total += sum(li >= f for f in dx_from) * dense_bound_ms(
                "dense_dx_f32", BATCH, k, n, relu)[0]

    net(g_dims, 1, (1,), 1)          # G: dx past its first layer
    net(d_dims, 2, (0, 1), 1)        # D in G's loss (all) and in D's loss
    return total


#: device-time groups of a profile, by kernel name (the first that matches)
PROFILE_GROUPS = (("flash_fwd_kernel", "flash_fwd_kernel"),
                  ("slstm_scan_kernel", "slstm_scan_kernel"),
                  ("slstm_scan_bwd_kernel", "slstm_scan_bwd_kernel"),
                  ("ssm_scan_kernel", "ssm_scan_kernel"),
                  ("ssm_scan_bwd_kernel", "ssm_scan_bwd_kernel"),
                  ("sum_parts_kernel", "ssm_scan_bwd_kernel"),
                  ("gemm", "gemm (cuBLAS, and the 3xTF32 tile)"),
                  ("double", "float64 elementwise"),
                  ("copy", "copies"))


def profile_step(step, args) -> dict:
    """One warm step under torch.profiler: the device's busy time and idle
    share, its launches, the kernels that take the most device time, and
    the device ms of PROFILE_GROUPS (the rest as "other").  Only the
    device's activity is traced (nothing here reads the host's), and its
    raw events are summed by name: ``key_averages`` would first build a
    Python object an event, tens of seconds for a step of ~150k
    launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}                       # name: [count, device ms]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = by_name.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e6
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    groups = {name: 0.0 for _, name in PROFILE_GROUPS}
    groups["other"] = 0.0
    for key, (_, ms) in by_name.items():
        name = next((n for k, n in PROFILE_GROUPS if k in key), "other")
        groups[name] += ms
    return dict(profiled_wall_ms=1e3 * wall, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / (1e3 * wall),
                device_launches=sum(n for n, _ in by_name.values()),
                device_ms_by_group=groups,
                top_kernels=[[key[:110], n, ms] for key, (n, ms) in top])


def drive_train(model) -> dict:
    """Phase 4: GANDSE.train at the paper's width (4096 rows, 2 epochs of
    4 steps of 1024), then explore_batch of 64 tasks on the trained G."""
    cfg = G.GANConfig(n_net=model.net_space.n_dims)        # 11 x 2048
    ds = gen_mod.generate_dataset(model, 4096, seed=0)
    engine = dse.GANDSE(model, cfg)                         # the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = engine.train(n_data=4096, iters=2, seed=0, ds=ds)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    assert len(st.history) == 8, len(st.history)
    # the initial state alone (train_s holds one draw of it)
    t0 = time.perf_counter()
    T.init_state(model, cfg, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert all(np.isfinite(r[k]) for r in st.history for k in r), \
        "non-finite training metrics"
    tasks = gen_mod.generate_tasks(model, N_TASKS, seed=1)
    res = engine.explore_batch(tasks, seed=0)
    assert len(res) == N_TASKS
    probs = engine._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj,
        seed=dse.row_seeds(0, N_TASKS))
    assert bool(torch.isfinite(probs).all()), "trained G's probs not finite"
    return dict(train_s=train_s,
                train_ms_per_step_with_setup=1e3 * train_s / 8,
                init_s=init_s,
                history=st.history,
                explore_n_satisfied=sum(r.satisfied for r in res),
                explore_mean_candidates=float(np.mean(
                    [r.selection.n_candidates for r in res])))


def init_on_card_and_cpu(model, cfg, seed: int = 0) -> dict:
    """``init_state(seed)`` drawn on the card and on the CPU (where the
    tests hold it to the reference's weights): the same bits."""
    card = T.init_state(model, cfg, seed, "cuda")
    cpu = T.init_state(model, cfg, seed, "cpu")
    leaves = [(a["w"].cpu(), b["w"]) for p, q in ((card.g_params,
                                                   cpu.g_params),
                                                  (card.d_params,
                                                   cpu.d_params))
              for a, b in zip(p["layers"], q["layers"])]
    off = sum(int((a != b).sum()) for a, b in leaves)
    ulps = max(int((a.view(torch.int32).long() - b.view(torch.int32).long())
                   .abs().max()) for a, b in leaves)
    assert off == 0, f"{off} weights differ, by up to {ulps} ulps"
    return dict(weights=sum(a.numel() for a, _ in leaves),
                differ=off, max_ulps=ulps)


def quality_run() -> dict:
    """Phase 5: GANDSE on dnnweaver at experiments/run_comparison.py's
    scale (``launch/quality.py``), from the reference's own initial
    weights for seed 0 (the card's draw held to the CPU's).  Training must
    lower the mean loss_g of an epoch."""
    model = DnnWeaverModel()
    init = init_on_card_and_cpu(model, CMP.gan_config(model, CMP.Scale()))
    out = Q.quality_run("cuda")
    out["init_card_vs_cpu"] = init
    by_epoch = out["loss_g_by_epoch"]
    assert by_epoch[-1] < by_epoch[0], f"loss_g did not fall: {by_epoch}"
    out["reference"] = dict(n_satisfied=REF_QUALITY[0],
                            mean_candidates=REF_QUALITY[1])
    print("quality dnnweaver: " + json.dumps(out), flush=True)
    return out


def check_kernel() -> dict:
    """Phase 2: the kernel against its plain version at the serving
    path's shapes: each model's G at full width with M = 64 (the main
    path's rows), and im2col's also at M = 1024, the smaller batches the
    leading rows of the larger; a row's bits are the same in a call of
    3, 64 or 1024 rows (the 64-row and the 128-row tile)."""
    rows = {}
    for model, ms in ((Im2colModel(), (N_TASKS, 1024)),
                      (DnnWeaverModel(), (N_TASKS,))):
        cfg = G.GANConfig(n_net=model.net_space.n_dims)
        gen = torch.Generator(device="cuda").manual_seed(11)
        params = G.init_generator(prng.prng_key(torch.tensor(11)), cfg,
                                  model.space, "cuda")
        for m, row in check_chain(model.name, params, ms, gen).items():
            rows[model.name, m] = row
    return rows


def check_chain(name: str, params, ms, gen) -> dict:
    """The whole-MLP kernel on `params`' weights (with nonzero biases, so
    the epilogue is exercised) at each batch of `ms` against its plain
    version and float64 (`_check_one`), the smaller batches the leading
    rows of the larger; a row's bits the same in a call of 3 rows and in
    every batch of `ms`."""
    ws = [p["w"] for p in params["layers"]]
    bs = [torch.randn(p["b"].shape, generator=gen, device="cuda") * 0.1
          for p in params["layers"]]
    x_all = torch.randn(max(ms), ws[0].shape[0], generator=gen,
                        device="cuda")
    rows, ys = {}, {}
    for m in ms:
        rows[m], ys[m] = _check_one(f"{name} M={m}", x_all[:m], ws, bs)
    # a row's result does not depend on the rows that share the call
    ys[3] = fm.fused_mlp(x_all[5:8].contiguous(), ws, bs)
    torch.cuda.synchronize()
    for m in ms:
        assert torch.equal(ys[3], ys[m][5:8]), \
            f"{name}: rows 5:8 differ between M=3 and M={m}"
        assert torch.equal(ys[min(ms)], ys[m][:min(ms)]), \
            f"{name}: rows differ between M={min(ms)} and M={m}"
    print(f"kernel rows {name}: the same bits at M = {sorted(ys)}",
          flush=True)
    return rows


def mlp_float64(x, ws, bs):
    """The whole-MLP chain in float64 (hidden ReLU, linear head)."""
    y = x.double()
    for i, (w, b) in enumerate(zip(ws, bs)):
        y = y @ w.double() + b.double()
        if i < len(ws) - 1:
            y = torch.relu(y)
    return y


def _check_one(label: str, x, ws, bs) -> tuple:
    """The kernel at one batch against its plain version and a float64
    chain, twice for the same bits, then timed; returns (row, output)."""
    m = x.shape[0]
    y_k = fm.fused_mlp(x, ws, bs)
    again = fm.fused_mlp(x, ws, bs)
    y_r = ref.fused_mlp(x, ws, bs)
    y_64 = mlp_float64(x, ws, bs)
    torch.cuda.synchronize()
    assert y_r.shape == (m, ws[-1].shape[1]), y_r.shape
    err = _hold(f"whole-MLP kernel at {label}", y_k, y_r)
    assert torch.equal(y_k, again), f"whole-MLP {label}: two calls differ"
    f64 = float64_errors(f"whole-MLP {label}", (y_k,), (y_r,), (y_64,))
    print(f"kernel check {label}: max_abs_err={err:.3e} "
          + json.dumps(f64), flush=True)

    def library():
        h = x
        for i, (w, b) in enumerate(zip(ws, bs)):
            h = torch.addmm(b, h, w)
            if i < len(ws) - 1:
                h = torch.relu_(h)
        return h

    bound, bound_by = mlp_bound_ms(m, ws, bs)
    row = dict(
        max_abs_err=err, same_bits=True, **f64,
        ms=cuda_ms(lambda: fm.fused_mlp(x, ws, bs)),
        plain_ms=cuda_ms(lambda: ref.fused_mlp(x, ws, bs)),
        library_ms=cuda_ms(library),
        library_tf32_ms=library_tf32_ms(library),
        bound_ms=bound, bound_by=bound_by,
        simt_bound_ms=mlp_simt_bound_ms(m, ws, bs),
        bound_peak="3xTF32, 495 TFLOP/s")
    print(f"kernel times {label}: " + json.dumps(row), flush=True)
    return row, y_k


def drive_path(model) -> dict:
    """Phase 3: GANDSE.attach + explore_batch on the card, cold then warm."""
    cfg = G.GANConfig(n_net=model.net_space.n_dims)     # 11 x 2048
    ds = gen_mod.generate_dataset(model, 4096, seed=0)
    params = G.init_generator(prng.prng_key(torch.tensor(0)), cfg,
                              model.space, "cuda")
    engine = dse.GANDSE(model, cfg)                     # device=None: the card
    assert engine.device.type == "cuda", engine.device
    engine.attach(ds, params)
    tasks = gen_mod.generate_tasks(model, N_TASKS, seed=1)
    t0 = time.perf_counter()
    cold = engine.explore_batch(tasks, seed=0)
    t1 = time.perf_counter()
    warm = engine.explore_batch(tasks, seed=0)
    t2 = time.perf_counter()
    return dict(engine=engine, tasks=tasks, cold=cold, warm=warm,
                cold_s=t1 - t0, warm_s=t2 - t1)


def check_path(name: str, run: dict) -> dict:
    """The serving path's results: finite probs of the right shape, the
    Selections' metrics from the float64 oracle, the candidate cap, and
    the same Selections from the CPU route given the same probs."""
    engine, tasks = run["engine"], run["tasks"]
    model, xcfg = engine.model, engine.explorer_cfg
    cold, warm = run["cold"], run["warm"]
    assert len(warm) == N_TASKS
    for a, b in zip(cold, warm):
        assert _same(a.selection, b.selection), "cold and warm runs differ"
    for i, r in enumerate(warm):
        sel = r.selection
        assert sel.n_candidates <= xcfg.max_candidates, sel.n_candidates
        if sel.cfg_idx is None:
            continue
        lat, pw = model.evaluate_indices(tasks.net_idx[i][None],
                                         sel.cfg_idx[None])
        assert float(lat[0]) == sel.latency and float(pw[0]) == sel.power
    probs = engine._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj,
        seed=dse.row_seeds(0, N_TASKS))
    assert probs.shape == (N_TASKS, model.space.onehot_width), probs.shape
    assert bool(torch.isfinite(probs).all()), "G probs not finite"
    sums = [float(g.sum(-1).sub(1).abs().max())
            for g in model.space.split_groups(probs)]
    assert max(sums) < 1e-5, f"per-group probs do not sum to 1: {sums}"

    def select(p):
        return fs.select_from_probs(model, tasks.net_idx, p, xcfg,
                                    tasks.lat_obj, tasks.pow_obj)

    on_card, on_cpu = select(probs), select(probs.cpu())
    for a, b, r in zip(on_card, on_cpu, warm):
        assert _same(a, b), "card and CPU select differ on the same probs"
        assert _same(a, r.selection), "explore_batch differs from its probs"
    n_sat = sum(r.satisfied for r in warm)
    out = dict(cold_ms_per_task=1e3 * run["cold_s"] / N_TASKS,
               warm_ms_per_task=1e3 * run["warm_s"] / N_TASKS,
               n_satisfied=n_sat,
               mean_candidates=float(np.mean([r.selection.n_candidates
                                              for r in warm])))
    print(f"explore_batch {name}: " + json.dumps(out), flush=True)
    return out


def profile_path(name: str, run: dict) -> dict:
    """Where a warm ``explore_batch`` spends its time: G and the select
    timed apart on the host clock (each ended by a synchronize), and one
    more call under ``torch.profiler`` for the device's busy time, its
    kernel launches, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine, tasks = run["engine"], run["tasks"]
    xcfg, seeds = engine.explorer_cfg, dse.row_seeds(0, N_TASKS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = engine._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj, seed=seeds)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fs.select_from_probs(engine.model, tasks.net_idx, probs, xcfg,
                         tasks.lat_obj, tasks.pow_obj)
    t2 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        engine.explore_batch(tasks, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(g_ms=1e3 * (t1 - t0), select_ms=1e3 * (t2 - t1),
               profiled_wall_ms=1e3 * wall, device_busy_ms=busy_us / 1e3,
               device_idle_share=1.0 - busy_us / 1e3 / (1e3 * wall),
               device_launches=sum(e.count for e in dev),
               top_kernels=[[e.key[:110], e.count,
                             e.self_device_time_total / 1e3] for e in top])
    print(f"profile {name}: " + json.dumps(out), flush=True)
    return out


def flash_row(label: str, shape, q, k, v, dtype, tol, lse: bool = False
              ) -> dict:
    """One flash shape and dtype: within `tol`·scale of the plain
    version, the same bits twice; float32 also against float64 attention
    (at most 4x the plain version's error plus 1e-6·scale), bf16 within
    one bf16 ulp plus 1e-5·scale of the plain version's output.  With
    `lse`, the kernel that stores lse: out the same bits, lse within
    1e-5·max(1, |lse|) of the plain version's, and its time.  CUDA-event
    medians of the kernel, the plain version and one library call
    (``scaled_dot_product_attention`` with the same boolean mask, a
    yardstick the port never calls)."""
    import torch.nn.functional as F
    b, h, hkv, sq, sk, d, causal, window, q_offset = shape
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    qpos = torch.arange(sq, device="cuda") + q_offset
    kpos = torch.arange(sk, device="cuda")
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep &= qpos[:, None] >= kpos[None, :]
    if window:
        keep &= qpos[:, None] - kpos[None, :] < window
    got, again = fa.flash_attention(q, k, v, **kw), \
        fa.flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    name = f"flash {label} {dtype}"
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.float().abs().max()))
    err = _err(got.float(), want.float())
    assert err <= tol * scale, f"{name}: {err}"
    same = torch.equal(got, again)
    assert same, f"{name}: two calls differ"
    row = dict(max_abs_err=err, tol=tol * scale, same_bits=same)
    if dtype == torch.float32:
        exact = flash_float64(q, k, v, **kw)
        row.update(float64_errors(name, (got,), (want,), (exact,)))
        del exact
    else:
        diff = (got.float() - want.float()).abs()
        ulp = bf16_ulp(torch.maximum(got.float().abs(),
                                     want.float().abs()))
        excess = float((diff - ulp).max())
        assert excess <= 1e-5 * scale, \
            f"{name}: {excess} past one bf16 ulp"
        row.update(max_ulps=float((diff / ulp).max()),
                   max_excess_over_one_ulp=excess)
    if lse:
        o_lse, lse_k = fa.flash_attention(q, k, v, return_lse=True, **kw)
        _, lse_p = ref.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(o_lse, got), f"{name}: lse changed out"
        lse_err = float(((lse_k - lse_p).abs()
                         / lse_p.abs().clamp(min=1.0)).max())
        assert lse_err <= 1e-5, f"{name}: lse {lse_err}"
        row.update(out_same_bits_with_lse=True, lse_max_rel_err=lse_err,
                   lse_ms=cuda_ms(lambda: fa.flash_attention(
                       q, k, v, return_lse=True, **kw)))
        del o_lse, lse_k, lse_p
    bnd, by = flash_bound_ms(shape, dtype)
    row.update(
        ms=cuda_ms(lambda: fa.flash_attention(q, k, v, **kw)),
        plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v, **kw)),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep, enable_gqa=True)),
        bound_ms=bnd, bound_by=by,
        bound_4d_ms=flash_bound_4d_ms(shape, dtype),
        bound_peak=("3xTF32, 495 TFLOP/s" if dtype == torch.float32
                    else "bf16 with P split, 989 TFLOP/s"),
        kept_pairs_per_head=kept_pairs(sq, sk, causal, window, q_offset))
    print(f"{name}: " + json.dumps(row), flush=True)
    return row


def check_flash() -> dict:
    """Phase 6a: the flash-attention kernel against its plain version at
    FLASH_SHAPES (`flash_row`).  float32: within TOL of the plain
    version, and no further from float64 attention than 4x the plain
    version plus 1e-6·scale (as the tile is held).  bf16: within
    BF16_TOL, and within one bf16 ulp (at the larger of the two) plus
    1e-5·scale of the plain version's output, since both compute in
    float32 before the last rounding.  Two calls give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for label, shape in FLASH_SHAPES.items():
        b, h, hkv, sq, sk, d = shape[:6]
        q32 = torch.randn(b, h, sq, d, generator=gen, device="cuda")
        k32 = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
        v32 = torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            rows[label, str(dtype).split(".")[-1]] = flash_row(
                label, shape, q, k, v, dtype, tol)
    return rows


def init_lm(m, label: str):
    """``init_params(prng_key(0), m)`` on the card, the reference's initial
    weights for seed 0 (threefry as eager torch); its seconds kept in
    INIT_S under `label`."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cuda")
    torch.cuda.synchronize()
    INIT_S[label] = dict(seconds=time.perf_counter() - t0,
                         params=MB.param_count(params))
    MODELS[label] = m
    print(f"init {label}: " + json.dumps(INIT_S[label]), flush=True)
    return params


def lm_model():
    """gemma3-1b at full width, float32 params from seed 0 on the card."""
    m = configs.get_arch(LM_ARCH)
    params = init_lm(m, m.name)
    n_global = sum(seg.repeats for seg in m.segments for sp in seg.pattern
                   if sp.cfg.window is None)
    print(f"lm {m.name}: {MB.param_count(params)} params, {m.n_layers} "
          f"layers ({n_global} global)", flush=True)
    return m, params


def _logits_agree(label: str, got, want) -> dict:
    """Finite logits within TOL·max(1, max|want|), equal argmax per row."""
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert bool(torch.isfinite(got).all()), f"{label}: not finite"
    scale = max(1.0, float(want.abs().max()))
    err = _err(got, want)
    assert err <= TOL * scale, f"{label}: {err} > {TOL * scale}"
    assert torch.equal(got.argmax(-1), want.argmax(-1)), \
        f"{label}: argmax differs"
    return dict(max_abs_err=err, tol=TOL * scale, max_abs=float(
        want.abs().max()))


def prefill_flops(m, b: int, s: int) -> dict:
    """Flops of a prefill's parts as computed (each product 2·M·K·N): the
    layers' projections (wq, wkv, the router, and a dense FFN's w_gate,
    w_up, w_down), an MoE layer's experts over their whole capacity
    buffers (2·3·E·cap·D·F a layer, at the default capacity), wo, the
    logits, the flash kernel's kept pairs, and an SSM branch's products
    (in_proj D -> 2·Di, x_proj Di -> 1 + 2N, out_proj Di -> D); for an
    xLSTM model its blocks' products (`xlstm_flops`) instead."""
    out = {"projections": 0.0, "experts": 0.0, "wo": 0.0, "flash": 0.0,
           "ssm_projections": 0.0}
    t = b * s
    for seg in m.segments:
        for spec in seg.pattern:
            c = spec.cfg
            if spec.kind != "dense":
                for k, v in xlstm_flops(spec, b, s).items():
                    out[k] = out.get(k, 0.0) + seg.repeats * v
                continue
            ffn = 0 if c.n_experts else 3 * c.d_ff
            out["projections"] += seg.repeats * 2 * t * c.d_model * (
                (c.n_heads + 2 * c.n_kv) * c.dh + ffn + c.n_experts)
            if c.n_experts:
                cap = MOE.capacity(t, c.n_experts, c.top_k, 1.25)
                out["experts"] += seg.repeats * 2 * 3 * c.n_experts * cap \
                    * c.d_model * c.d_ff
            out["wo"] += seg.repeats * 2 * t * c.n_heads * c.dh * c.d_model
            out["flash"] += seg.repeats * 4 * c.dh * b * c.n_heads * \
                kept_pairs(s, s, True, c.window, 0)
            if c.ssm_state:
                di = 2 * c.d_model
                out["ssm_projections"] += seg.repeats * 2 * t * (
                    c.d_model * 2 * di + di * (1 + 2 * c.ssm_state)
                    + di * c.d_model)
    out["logits"] = 2 * t * m.d_model * m.vocab
    return out


def xlstm_flops(spec, b: int, s: int, chunk: int = 64) -> dict:
    """Flops of one xLSTM layer over (b, s) tokens as computed: an
    mLSTM's projections (wqkv, wif, wz, wo) and its chunkwise products
    (per chunk of L and head: the scores and their product with v, 2·L²·dh
    each, the carried C's product with q and the chunk's update of C,
    2·L·dh² each, and n's, 5·L·dh); an sLSTM's projections (wx, wo), its
    recurrence apart (`slstm_bound_ms`)."""
    c = spec.cfg
    d, h, t = c.d_model, c.n_heads, b * s
    dh = d // h
    if spec.kind == "mlstm":
        return {"mlstm_projections": 2 * t * d * (3 * d + 2 * h + 2 * d),
                "mlstm_chunks": b * h * s * (4 * chunk * dh + 4 * dh * dh
                                             + 5 * dh)}
    return {"slstm_projections": 2 * t * d * 5 * d}


def prefill_bound_ms(m, b: int, s: int) -> dict:
    """Least time of a prefill's parts at the float32 peak (TF32 off), the
    flash kernel's at three TF32 products at 495 TFLOP/s (its 3xTF32, as
    ``flash_bound_ms``), and for an SSM model its scans' (`ssm_bound_ms`,
    one a layer), for an xLSTM model its sLSTM recurrences'
    (`slstm_bound_ms`)."""
    out = {k: 1e3 * (3 * v / PEAK_TF32_FLOPS if k == "flash"
                     else v / PEAK_F32_FLOPS)
           for k, v in prefill_flops(m, b, s).items()}
    specs = [sp for seg in m.segments for _ in range(seg.repeats)
             for sp in seg.pattern]
    out["ssm_scan"] = sum(ssm_bound_ms(b, s, 2 * sp.cfg.d_model,
                                       sp.cfg.ssm_state)[0]
                          for sp in specs if sp.cfg.ssm_state)
    out["slstm_scan"] = sum(slstm_bound_ms(b, s, sp.cfg.d_model,
                                           sp.cfg.n_heads)[0]
                            for sp in specs if sp.kind == "slstm")
    return out


@contextlib.contextmanager
def recorded_routes():
    """``nn/moe.route_topk`` wrapped to keep each MoE layer's (T, K)
    expert indices in call order (the list stays empty for a dense
    model)."""
    route, seen = MOE.route_topk, []

    def rec(logits, top_k):
        idx, w = route(logits, top_k)
        seen.append(idx.reshape(-1, top_k))
        return idx, w

    MOE.route_topk = rec
    try:
        yield seen
    finally:
        MOE.route_topk = route


def routing_flips(a: list, b_: list) -> list:
    """Per MoE layer, the (token, k) assignments whose expert differs
    between two runs."""
    assert len(a) == len(b_), (len(a), len(b_))
    return [int((x != y).sum()) for x, y in zip(a, b_)]


@contextlib.contextmanager
def recorded_flash():
    """Each call of the flash kernel's wrapper through ``kernels/ops``
    kept as (head dim, window): ops' handle on the wrapper's module is
    swapped for one whose wrapper records, then calls the real one (whose
    launch counters count as ever)."""
    seen = []

    def rec(q, k, v, **kw):
        seen.append((q.shape[-1], kw.get("window")))
        return fa.flash_attention(q, k, v, **kw)

    ops._fa = types.SimpleNamespace(flash_attention=rec)
    try:
        yield seen
    finally:
        ops._fa = fa


@contextlib.contextmanager
def plain_flash():
    """Every ``kernels/ops.flash_attention`` call takes the plain version
    (as ``use_fused=False`` does where a path has that option): the
    decode step's plain route."""
    ops._fa = types.SimpleNamespace(flash_attention=ref.flash_attention)
    try:
        yield
    finally:
        ops._fa = fa


def prefill_tokens(m, shape=PREFILL):
    """The prefill's random prompts, from seed 0 on the card."""
    return torch.randint(0, m.vocab, shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))


def drive_prefill(m, params, label: str = "prefill",
                  hold_logits: bool = True, keep: list = None,
                  rounds=("kernel", "plain"),
                  positions=None) -> dict:
    """Phase 6b (and l2, m2, o3): make_prefill_step on PREFILL random
    prompts through the kernels (flash's launches counted: one per
    attention layer, at each layer's head dim and window; the selective
    scan's one per SSM layer; the sLSTM kernel's one per sLSTM layer)
    and through the plain attention, scan and sLSTM loops
    (use_fused=False),
    their last-token logits compared (for an MoE model
    with the routing flips between the two routes counted, layer by
    layer, and named in a failure; with ``hold_logits=False`` the
    distance is reported, not held, and `keep` receives both logits: see
    `drive_xlstm_prefill`), then one more call of each route in
    `rounds`; every call is timed (host clock, ended by a synchronize)
    and each route's least time is reported.
    `positions` (qwen2-vl's (3, B, S) M-RoPE ids) join the batch."""
    b, s = PREFILL
    toks = prefill_tokens(m)
    batch = {"tokens": toks}
    if positions is not None:
        batch["positions"] = positions
    routes = {"kernel": TS.make_prefill_step(m),
              "plain": TS.make_prefill_step(m, use_fused=False)}
    times = {"kernel": [], "plain": []}

    def timed(r):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = routes[r](params, batch)
        torch.cuda.synchronize()
        times[r].append(1e3 * (time.perf_counter() - t0))
        return y

    zero_counts()
    with recorded_routes() as route_k, recorded_flash() as calls:
        got = timed("kernel")
    launches = counts()
    with recorded_routes() as route_p:
        want = timed("plain")
    specs = [sp for seg in m.segments for _ in range(seg.repeats)
             for sp in seg.pattern]
    layers = [sp.cfg for sp in specs if sp.kind == "dense"]
    assert launches["flash_attention_f32"] == len(layers), launches
    assert calls == [(c.dh, c.window) for c in layers], calls
    assert launches["ssm_scan_f32"] == sum(1 for c in layers
                                           if c.ssm_state), launches
    assert launches["slstm_scan_f32"] == sum(
        1 for sp in specs if sp.kind == "slstm"), launches
    out = dict(launches=launches, bound_ms=prefill_bound_ms(m, b, s),
               flash_calls=[list(c) for c in dict.fromkeys(calls)])
    what = f"{label} logits"
    if route_k:
        out["routing_flips_by_layer"] = routing_flips(route_k, route_p)
        what += (f" ({sum(out['routing_flips_by_layer'])} routing flips "
                 f"between the routes)")
    if hold_logits:
        out.update(_logits_agree(what, got, want))
    else:
        assert bool(torch.isfinite(got).all()), f"{what}: not finite"
        out["logits_vs_plain"] = dict(
            max_abs_err=_err(got, want), max_abs=float(want.abs().max()),
            argmax_equal=bool(torch.equal(got.argmax(-1), want.argmax(-1))))
        keep.extend((got, want))
    del got, want, route_k, route_p
    for r in rounds:
        timed(r)
    for r, ts in times.items():
        out[f"{r}_ms_per_prefill"] = min(ts)
        out[f"{r}_prompt_tok_per_s"] = b * s / (min(ts) / 1e3)
    out["bound_ms_per_prefill"] = sum(out["bound_ms"].values())
    out["profile"] = profile_step(lambda: routes["kernel"](params, batch),
                                  ())
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def run_engine(m, params, capture_until: int) -> dict:
    """The Engine (device=None: the card) serving SERVE's requests, each
    decode step's tokens, start and logits kept while the engine's clock
    is below `capture_until` (the first wave's prompt)."""
    eng = serve.Engine(m, params, SERVE["slots"], SERVE["cache_len"])
    assert eng.device.type == "cuda", eng.device
    decode, steps = eng._decode, []

    def capture(params_, toks, clock, states, start=None):
        logits, states = decode(params_, toks, clock, states, start=start)
        if clock < capture_until:
            steps.append(dict(toks=toks.clone(), clock=clock,
                              start=start.clone(),
                              logits=logits[:, 0].clone()))
        return logits, states

    eng._decode = capture
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, m.vocab, size=SERVE["prompt_len"]).tolist()
               for _ in range(SERVE["requests"])]
    for r, p in enumerate(prompts):
        eng.submit(serve.Request(rid=r, prompt=p, max_new=SERVE["max_new"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iters = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = sorted(eng.finished, key=lambda r: r.rid)
    assert len(done) == SERVE["requests"], len(done)
    assert all(len(r.out) == SERVE["max_new"] for r in done)
    new_tokens = sum(len(r.out) for r in done)
    # one more decode step of the idle engine (its caches have room left)
    toks = torch.zeros((SERVE["slots"], 1), dtype=torch.long, device="cuda")
    start = torch.from_numpy(eng.start).to("cuda")
    profile = profile_step(lambda: decode(
        params, toks, eng.clock, eng.states, start=start), ())
    return dict(done=done, prompts=prompts, steps=steps, stats=dict(
        engine_iters=iters, new_tokens=new_tokens, wall_s=wall,
        new_tok_per_s=new_tokens / wall, ms_per_decode_step=1e3 * wall / iters,
        decode_step_profile=profile))


def drive_serve(m, params, label: str = "serve") -> dict:
    """Phase 6c (and r3): the Engine serving SERVE's requests, its
    launches counted from zero (none of flash: decode attention is the
    plain version), then its logits at the prompts' last tokens held to
    make_prefill_step's on those prompts (kernel)."""
    plen = SERVE["prompt_len"]
    zero_counts()
    run = run_engine(m, params, plen)
    launches = counts()
    assert launches["flash_attention_f32"] == 0, launches
    first = torch.tensor(run["prompts"][:SERVE["slots"]], device="cuda")
    want = TS.make_prefill_step(m)(params, {"tokens": first})
    weight_bytes = 4 * MB.param_count(params)
    out = dict(weights_read_ms=1e3 * weight_bytes / PEAK_HBM_BYTES,
               **run["stats"], launches=launches,
               **_logits_agree("engine vs prefill logits",
                               run["steps"][plen - 1]["logits"], want))
    assert [r.out[0] for r in run["done"][:SERVE["slots"]]] == \
        want.argmax(-1).tolist()
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of `reps` warm calls of fn(), each ended by a
    synchronize (one call before them warms up)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def drive_dense(name: str, run: dict) -> dict:
    """Phase a: the two batched select routes on phase 3's engine, tasks
    and G's probs (G runs again here, so the whole MLP launches): the
    dense route (``enumerate_candidates_batch`` + ``select_batch``, which
    ``explore_batch`` takes at this batch and cap) and the streaming route
    (``fused_select_batch``), timed in turns (streaming, dense, dense,
    streaming; the best of each).  Their Selections are the same, field
    for field, and equal explore_batch's.  On im2col also at a cap of
    65536, 64 tasks (the largest block, 2^22 rows, the dense route is
    given)."""
    engine, tasks = run["engine"], run["tasks"]
    model, xcfg = engine.model, engine.explorer_cfg
    probs = engine._explorer.generator_probs_device(
        tasks.net_idx, tasks.lat_obj, tasks.pow_obj,
        seed=dse.row_seeds(0, N_TASKS))
    caps = [xcfg.max_candidates] + ([65536] if name == "im2col" else [])
    out = dict(n_tasks=N_TASKS)
    for cap in caps:
        assert fs.dense_route_fits(model, N_TASKS, cap), cap

        def dense():
            cand, valid, cnt = enumerate_candidates_batch(
                model.space, probs, xcfg.prob_threshold, cap)
            return select_batch(model, tasks.net_idx, cand, valid, cnt,
                                tasks.lat_obj, tasks.pow_obj)

        def fused():
            return fs.fused_select_batch(
                model, tasks.net_idx, probs, xcfg.prob_threshold, cap,
                tasks.lat_obj, tasks.pow_obj, tile=xcfg.select_tile)

        res, times = {}, {"fused": [], "dense": []}
        for route in ("fused", "dense", "dense", "fused"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[route] = (dense if route == "dense" else fused)()
            times[route].append(1e3 * (time.perf_counter() - t0))
        for i, (a, b) in enumerate(zip(res["dense"], res["fused"])):
            assert _same(a, b), f"dense {name} cap {cap}: task {i} differs"
        if cap == xcfg.max_candidates:
            for i, (a, r) in enumerate(zip(res["dense"], run["warm"])):
                assert _same(a, r.selection), \
                    f"dense {name}: task {i} differs from explore_batch"
        out[f"cap {cap}"] = dict(
            same_as_fused=True,
            mean_candidates=float(np.mean([r.n_candidates
                                           for r in res["dense"]])),
            dense_ms_per_task=min(times["dense"]) / N_TASKS,
            fused_ms_per_task=min(times["fused"]) / N_TASKS)
    print(f"dense route {name}: " + json.dumps(out), flush=True)
    return out


def _with_biases(params, gen):
    """A copy of `params` with nonzero biases (so every term is live)."""
    return {"layers": [{"w": p["w"], "b": torch.randn(
        p["b"].shape, generator=gen, device="cuda") * 0.1}
        for p in params["layers"]]}


def check_mlp_grad(model) -> dict:
    """Phase b: the whole MLP's gradient at LargeMLP's shapes (17 layers,
    16 x 2048, M = 64): ``mlp_apply_chained`` on the card (the kernel's
    forward, then the dense kernels' recompute and backward) against the
    plain chain's autograd, TF32 off, for x, every w and every b, each
    within TOL·max(1, max|g_ref|); its launches counted."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    lm = LargeMLP(model)
    params = _with_biases(lm.init_params(1), gen)
    x = torch.randn(N_TASKS, params["layers"][0]["w"].shape[0],
                    generator=gen, device="cuda")
    dy = torch.randn(N_TASKS, model.space.onehot_width, generator=gen,
                     device="cuda")

    def grads(use_fused):
        leaves = [x.clone().requires_grad_()] + [
            t.clone().requires_grad_() for p in params["layers"]
            for t in (p["w"], p["b"])]
        layers = [{"w": w, "b": b} for w, b in zip(leaves[1::2],
                                                    leaves[2::2])]
        y = L.mlp_apply_chained({"layers": layers}, leaves[0],
                                use_fused=use_fused)
        return torch.autograd.grad(y, leaves, dy)

    want = grads(False)
    zero_counts()
    got = grads(None)
    torch.cuda.synchronize()
    launches = counts()
    n = len(params["layers"])
    for name, k in (("mlp_forward_f32", 1), ("dense_forward_f32", n),
                    ("dense_dx_f32", n), ("dense_dw_db_f32", n)):
        assert launches[name] == k, (name, launches[name], k)
    errs = [_hold(f"whole-MLP gradient of input {i}", g, w)
            for i, (g, w) in enumerate(zip(got, want))]
    out = dict(layers=n, m=N_TASKS, max_abs_err=max(errs),
               max_abs=max(float(w.abs().max()) for w in want),
               launches=launches)
    print("whole-MLP gradient: " + json.dumps(out), flush=True)
    return out


def _norm_err(a, b_) -> float:
    return float(torch.linalg.vector_norm(a.double() - b_.double())) / \
        max(float(torch.linalg.vector_norm(b_.double())), 1e-30)


def mlp_step_bound_ms(dims) -> float:
    """Sum of the dense kernels' bounds over one LargeMLP step: a forward
    and a dW/db a layer, a dx a layer past the first."""
    total = 0.0
    for li, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        relu = li < len(dims) - 2
        total += dense_bound_ms("dense_forward_f32", BATCH, k, n, relu)[0]
        total += dense_bound_ms("dense_dw_db_f32", BATCH, k, n, relu)[0]
        if li > 0:
            total += dense_bound_ms("dense_dx_f32", BATCH, k, n, relu)[0]
    return total


def check_mlp_step(model) -> dict:
    """Phase c1: one LargeMLP step at full width (16 x 2048, batch 1024,
    lr 2e-5) from one state, noise and batch: through the kernels, the
    plain versions in float32 (use_fused=False), and the plain versions in
    float64.  The losses of the two float32 routes agree within
    TOL·max(1, |loss|); each gradient leaf, and each layer's new
    parameters (w and b together), of the kernel route lies no further
    from float64, in its norm, than TOL plus twice the plain float32
    route (as ``check_step`` holds Algorithm 1's gradients).  Counts the
    kernel route's launches and times warm steps of both float32
    routes."""
    lm = LargeMLP(model)
    ds = gen_mod.generate_dataset(model, BATCH, seed=0)
    data = T.encode_dataset(model, ds, "cuda")
    batch = {k: data[k] for k in ("net_enc", "obj_enc", "cfg_onehot")}
    params = lm.init_params(0)
    rng = prng.prng_key(torch.tensor(0)).to("cuda")
    noise = G.sample_noise_dim(prng.split(rng)[1], BATCH, lm.noise_dim)
    f64 = lambda t: t.double()
    routes = {"kernel": (params, batch, noise, None),
              "plain": (params, batch, noise, False),
              "float64": (tree_map(f64, params), tree_map(f64, batch),
                          noise.double(), False)}
    optim = adam(lm.lr)
    outs = {}
    for route, (p, b, nz, use_fused) in routes.items():
        if route == "kernel":
            zero_counts()
        loss, grads = lm.loss_and_grads(p, b, nz, use_fused)
        upd, _ = optim.update(grads, optim.init(p))
        torch.cuda.synchronize()
        if route == "kernel":
            launches = counts()
        outs[route] = (loss, tree_leaves(grads),
                       tree_leaves(apply_updates(p, upd)))
    n = lm.hidden_layers + 1
    want = {"dense_forward_f32": n, "dense_dx_f32": n - 1,
            "dense_dw_db_f32": n}
    for name, k in want.items():
        assert launches[name] == k, (name, launches[name], k)
    lk, lp = float(outs["kernel"][0]), float(outs["plain"][0])
    assert abs(lk - lp) <= TOL * max(1.0, abs(lp)), (lk, lp)

    def by_layer(leaves):
        # a layer's w and b as one vector: a zero-initialized bias moves by
        # Adam's ±lr alone in the first step, so it is held in its layer
        return [torch.cat([w.flatten(), b.flatten()])
                for w, b in zip(leaves[0::2], leaves[1::2])]

    res = {}
    for i, what, split in ((1, "gradients", list), (2, "new_params",
                                                    by_layer)):
        k_, p_, t_ = (split(outs[r][i]) for r in ("kernel", "plain",
                                                  "float64"))
        e_k = [_norm_err(a, t) for a, t in zip(k_, t_)]
        e_p = [_norm_err(a, t) for a, t in zip(p_, t_)]
        for li, (ek, ep) in enumerate(zip(e_k, e_p)):
            assert ek <= TOL + 2 * ep, \
                f"LargeMLP {what} {li}: {ek} from float64, plain {ep}"
        res[what] = dict(max_norm_err_kernel_vs_float64=max(e_k),
                         max_norm_err_plain_vs_float64=max(e_p),
                         max_abs_err_kernel_vs_plain=max(
                             _err(a, b_) for a, b_ in zip(k_, p_)))
    # Adam's first step is ±lr whatever a gradient's size: the elements
    # whose step takes the other sign than float64's, in each route
    g64 = outs["float64"][1]
    for r in ("kernel", "plain"):
        res["new_params"][f"{r}_sign_flips"] = sum(
            int(((a > 0) != (t > 0)).sum()) for a, t in zip(outs[r][1], g64))
    steps = {r: lm.make_step(u)[1] for r, u in (("kernel", None),
                                                ("plain", False))}
    opt = optim.init(params)
    args = (params, opt, batch, rng)
    dims = ([params["layers"][0]["w"].shape[0]]
            + [p["w"].shape[1] for p in params["layers"]])
    out = dict(layers=f"{lm.hidden_layers} x {lm.neurons}", batch=BATCH,
               loss=lk, plain_loss=lp, float64_loss=float(outs["float64"][0]),
               **res, launches=launches,
               n_params=sum(t.numel() for t in tree_leaves(params)),
               ms_per_step=host_ms(lambda: steps["kernel"](*args), reps=5),
               plain_ms_per_step=host_ms(lambda: steps["plain"](*args),
                                         reps=5),
               bound_ms_per_step=mlp_step_bound_ms(dims),
               profile=profile_step(steps["kernel"], args))
    print("LargeMLP step: " + json.dumps(out), flush=True)
    return out


def drive_mlp(model) -> dict:
    """Phase c2: ``LargeMLP.train`` at full width on the card (4096 rows,
    2 epochs of 4 steps of 1024), then ``explore_batch`` of 64 tasks
    (the whole-MLP kernel over 17 layers, then the streaming select),
    cold then warm; the trained net's probs finite."""
    lm = LargeMLP(model)
    assert lm.device.type == "cuda", lm.device
    ds = gen_mod.generate_dataset(model, 4096, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm.train(n_data=4096, iters=2, seed=0, ds=ds)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tasks = gen_mod.generate_tasks(model, N_TASKS, seed=1)
    t0 = time.perf_counter()
    cold = lm.explore_batch(tasks, seed=0)
    t1 = time.perf_counter()
    warm = lm.explore_batch(tasks, seed=0)
    t2 = time.perf_counter()
    for a, b in zip(cold, warm):
        assert _same(a.selection, b.selection), "LargeMLP cold/warm differ"
    probs = lm.generator_probs_device(tasks.net_idx, tasks.lat_obj,
                                      tasks.pow_obj, seed=0)
    assert bool(torch.isfinite(probs).all()), "LargeMLP probs not finite"
    # train_s includes the init's draws and the dataset's upload; the
    # step alone is phase c1's
    return dict(train_s=train_s,
                train_ms_per_step_with_setup=1e3 * train_s / 8,
                explore_cold_ms_per_task=1e3 * (t1 - t0) / N_TASKS,
                explore_warm_ms_per_task=1e3 * (t2 - t1) / N_TASKS,
                explore_n_satisfied=sum(r.satisfied for r in warm),
                explore_mean_candidates=float(np.mean(
                    [r.selection.n_candidates for r in warm])))


def check_mlp_chain(model) -> dict:
    """Phase c3: the whole-MLP kernel at LargeMLP's 17 layers (16 x 2048)
    at M = 64 and 1024 (`check_chain`)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    return check_chain(f"LargeMLP {model.name}", LargeMLP(model)
                       .init_params(2), (N_TASKS, 1024), gen)


def drive_drl_sa() -> dict:
    """Phase d: DRL's rollout and SA's anneal on the card (class defaults,
    64 dnnweaver tasks) against the CPU port's from the same policy params
    (trained on the CPU, then moved) and seeds: the same Selections.  The
    rollout's launches counted (zeroed just before it)."""
    model = DnnWeaverModel()
    ds = gen_mod.generate_dataset(model, 4096, seed=0)
    tasks = gen_mod.generate_tasks(model, N_TASKS, seed=1)
    cpu = PolicyGradientDRL(model, device="cpu").train(
        n_data=4096, iters=8, seed=0, ds=ds)
    card = PolicyGradientDRL(model).attach(ds, cpu.params)
    out = {}
    for name, on_card, on_cpu in (
            ("DRL", card, cpu),
            ("SA", SimulatedAnnealing(model),
             SimulatedAnnealing(model, device="cpu"))):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = on_card.explore_tasks(tasks, seed=0)
        t1 = time.perf_counter()
        launches = counts()
        want = on_cpu.explore_tasks(tasks, seed=0)
        off = [i for i, (a, b) in enumerate(zip(got, want))
               if not _same(a.selection, b.selection)]
        assert not off, f"{name}: card and CPU differ at tasks {off}"
        out[name] = dict(same_as_cpu=True, launches=launches,
                         ms_per_task=1e3 * (t1 - t0) / N_TASKS,
                         n_satisfied=sum(r.satisfied for r in got),
                         mean_candidates=float(np.mean(
                             [r.selection.n_candidates for r in got])))
        print(f"{name} on the card: " + json.dumps(out[name]), flush=True)
    assert out["DRL"]["launches"]["dense_forward_f32"] > 0, \
        "the DRL rollout never launched dense_forward_f32"
    out["time split"] = profile_sa_drl(model, tasks, card)
    return out


def profile_sa_drl(model, tasks, drl) -> dict:
    """Where SA's anneal and DRL's rollout spend their time on the card
    (the 64 tasks of phase d): one check interval of the anneal (its start
    and ``CHECK_EVERY`` steps) and one whole rollout, each timed warm on
    the host clock and profiled (device busy time, idle share, launches),
    beside the same work's threefry draws alone (SA: an interval's
    ``_draws``; DRL: ``rollout_draws``), timed where the code makes them
    (on the host, then one copy to the card) and, for the choice of that
    place, as launches on the card."""
    sa = SimulatedAnnealing(model)
    net = torch.as_tensor(tasks.net_idx, dtype=torch.int64, device="cuda")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")
    lo, po = f32(tasks.lat_obj), f32(tasks.pow_obj)
    keys = task_keys(dse.row_seeds(0, len(tasks)), len(tasks))
    on_card = keys.to("cuda")
    copy = lambda *ts: [t.to("cuda") for t in ts]
    net_enc = f32(drl.ds.net_encoded(model, tasks.net_idx))
    obj_enc = f32(drl.ds.obj_encoded(tasks.lat_obj, tasks.pow_obj))
    n_dims, width = model.space.n_dims, model.space.onehot_width
    sa_draws = lambda k: SA._draws(k, SA.CHECK_EVERY, n_dims)
    drl_draws = lambda k: DRL.rollout_draws(k, n_dims, drl.rollout_len,
                                            width, drl.explore_eps)
    work = {
        "SA check interval": (
            lambda: sanneal(model, net, lo, po, keys, sa.t_init, sa.cooling,
                            sa.steps_per_temp, SA.CHECK_EVERY),
            lambda: copy(*sa_draws(keys)[1:]),
            lambda: sa_draws(on_card)),
        "DRL rollout": (
            lambda: DRL.rollout(model, drl.params, net, net_enc, obj_enc, lo,
                                po, keys, drl.rollout_len, drl.explore_eps),
            lambda: copy(*drl_draws(keys)),
            lambda: drl_draws(on_card)),
    }
    out = {}
    with torch.no_grad():
        for name, (whole, draws, card_draws) in work.items():
            ms, draws_ms = host_ms(whole), host_ms(draws)
            out[name] = dict(n_tasks=len(tasks), ms=ms, draws_ms=draws_ms,
                             draws_share=draws_ms / ms,
                             draws_on_card_ms=host_ms(card_draws),
                             profile=profile_step(whole, ()),
                             draws_on_card_profile=profile_step(card_draws,
                                                                ()))
            print(f"{name} time split: " + json.dumps(out[name]), flush=True)
    return out


class _OracleOn:
    """A design model whose torch oracle runs on another device (the
    results come back to the caller's): swaps one component of a lane."""

    def __init__(self, model, device: str):
        self.model, self.device = model, device
        self.space, self.name = model.space, model.name

    def evaluate_torch_indices(self, net_idx, cfg_idx):
        lat, pw = self.model.evaluate_torch_indices(net_idx.to(self.device),
                                                    cfg_idx.to(self.device))
        return lat.to(net_idx.device), pw.to(net_idx.device)


def trace_sa_lanes(model, tasks, seed: int) -> dict:
    """SA's lanes on Table 5's tasks, the card's against the CPU port's.
    A lane that differs is traced by swapping one component: the card's
    anneal rerun on those lanes with the CPU's torch oracle must give the
    CPU's lane exactly, so that the oracle's float32 rounding on the card
    (hard tasks put objectives on a config's own metrics) is the cause,
    and the anneal's own arithmetic (threefry, exp, the masked loop) is
    not."""
    sa = SimulatedAnnealing(model)
    card = sa.explore_tasks(tasks, seed=seed)
    cpu = SimulatedAnnealing(model, device="cpu").explore_tasks(tasks,
                                                                seed=seed)
    off = [t for t, (a, b) in enumerate(zip(card, cpu))
           if not _same(a.selection, b.selection)]
    out = dict(n_lanes=len(card), differ=off, lanes={})
    if off:
        idx = np.asarray(off)
        seeds = dse.row_seeds(seed, len(tasks))[idx]
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)[idx],
                                        device="cuda")
        best, _, n_eval = sanneal(
            _OracleOn(model, "cpu"),
            torch.as_tensor(tasks.net_idx[idx], dtype=torch.int64,
                            device="cuda"),
            f32(tasks.lat_obj), f32(tasks.pow_obj),
            task_keys(seeds, len(seeds)), sa.t_init, sa.cooling,
            sa.steps_per_temp, sa.max_steps)
        for i, t in enumerate(off):
            a, b = card[t].selection, cpu[t].selection
            swapped = (best[i].tolist(), int(n_eval[i]))
            out["lanes"][t] = dict(
                card=(a.cfg_idx.tolist(), a.n_candidates, a.satisfied),
                cpu=(b.cfg_idx.tolist(), b.n_candidates, b.satisfied),
                card_with_cpu_oracle=swapped)
            assert swapped == (b.cfg_idx.tolist(), b.n_candidates), \
                f"SA lane {t}: the CPU oracle does not explain it: {out}"
    print("SA lanes, card vs CPU (Table 5 tasks; differing lanes rerun on "
          "the card with the CPU's oracle): " + json.dumps(out), flush=True)
    return out


#: the reference's Table 5 on dnnweaver, ``REPRO_RESULTS=<dir> python
#: experiments/run_comparison.py --models dnnweaver --seed 0`` on an x86-64
#: CPU with jax 0.9 (PERF.md): satisfied of 200, improvement ratio, DSE ms
#: per task, mean candidates, training s.  Times are that CPU's
REF_TABLE5 = {
    "GANDSE": (56, 0.1122924357652776, 0.2431, 2.005, 6.97),
    "LargeMLP": (56, 0.0925061038615396, 0.2219, 1.87, 1.52),
    "DRL": (70, 0.23168537361673036, 0.0888, 17.0, 1.73),
    "SA": (200, 0.12212839847648244, 0.7498, 60.54, 0.0),
    "RandomSearch": (28, 0.2297712263764759, 0.0938, 2.0, 0.0),
}
TABLE5_KEYS = ("sat", "impr", "dse_ms_per_task", "candidates", "train_s")


def table5(quality: dict) -> dict:
    """Phase e: Table 5 on dnnweaver at ``run_comparison.py``'s reduced
    scale (seed 0, 200 hard tasks) on the card, GANDSE's row the quality
    phase's (not trained again); beside it the reference's CPU rows.  The
    reference's own bar: GANDSE satisfies at least as many tasks as
    budget-matched RandomSearch."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results", "chip_smoke")
    rep = CMP.run_comparison("dnnweaver", CMP.Scale(), seed=0,
                             results_dir=out_dir, device="cuda",
                             done={"GANDSE": quality["row"]})
    rows = {}
    for r in rep["rows"]:
        rows[r["method"]] = dict(zip(TABLE5_KEYS, (
            r["n_satisfied"], r["improvement_ratio"], 1e3 * r["dse_time_s"],
            r["n_candidates"], r["train_time_s"])))
        assert r["n_tasks"] == 200 and np.isfinite(r["dse_time_s"])
    print("table5 dnnweaver: " + json.dumps(rows), flush=True)
    print("REF_TABLE5 dnnweaver (the reference's CPU run): " + json.dumps(
        {k: dict(zip(TABLE5_KEYS, v)) for k, v in REF_TABLE5.items()}),
        flush=True)
    assert CMP.gandse_beats_random_search(rep), \
        "GANDSE satisfied fewer tasks than budget-matched RandomSearch"
    model = DnnWeaverModel()
    rows["SA"]["lanes_vs_cpu"] = trace_sa_lanes(
        model, CMP.shared_data(model, CMP.Scale(), 0)[1], seed=2)
    return rows


#: phases f and g: ``launch/dse_serve`` at G 11 x 2048 on im2col, from the
#: reference's init for seed 0
SERVE_ARGV = ["--model", "im2col", "--layers", "11", "--neurons", "2048",
              "--requests", "256", "--max-batch", "64",
              "--repeat-frac", "0.25"]
#: phase h: ``launch/online`` at G and D 11 x 2048 on dnnweaver (batch 64,
#: as the launcher sets it); objectives on sampled design points (slack 1)
#: and 64 candidates a task, as the reference's online test sets them, so
#: the waves keep giving hard tasks to harvest (at the launcher's 2048,
#: generation 1 satisfied 79 of the next 80 on an H100: too few hard
#: tasks for 3 generations)
ONLINE_ARGV = ["--model", "dnnweaver", "--layers", "11", "--neurons", "2048",
               "--data", "4096", "--waves", "10", "--wave-size", "16",
               "--slack", "1.0", "--max-candidates", "64", "--min-hard", "4",
               "--train-iters", "2", "--generations", "3",
               "--corrupt-step", "2"]


def _standalone(engine, tasks, seed: int = 0):
    """Each task row's Selection from one standalone ``explore_tasks`` of
    the whole task batch (row i with seed + i)."""
    return [r.selection for r in engine.explore_tasks(tasks, seed=seed)]


def _check_served(label: str, rep: dict, launches: dict) -> dict:
    """What phases f and g hold of a fault-free ``dse_serve`` run: every
    request answered, none failed, retried or degraded, the coalesced and
    cached counts the stream's shape gives, one whole-MLP launch a
    dispatched batch, and every Selection as a standalone explore_tasks
    gives it."""
    srv, engine, tasks = rep["server"], rep["engine"], rep["tasks"]
    s = srv.summary()
    args = rep["args"]
    n, n_rep = args.requests, int(args.requests * args.repeat_frac)
    responses = rep["responses"]
    assert len(responses) == rep["n_total"] == n + 2 * n_rep, len(responses)
    assert all(r.ok for r in responses), label
    assert s["pending"] == 0, s["pending"]
    for k in ("failed", "retried", "degraded_entered", "rejected"):
        assert s[k] == 0, (label, k, s[k])
    assert s["kernels"]["fused"] == {engine.model.name: True}, s["kernels"]
    dispatched = [r for r in responses if r.source == "dispatch"]
    assert len(dispatched) == n, len(dispatched)
    if args.concurrent:         # duplicates coalesce or hit, by timing
        assert s["coalesced"] + s["cache"]["hits"] == 2 * n_rep, s
    else:
        assert s["coalesced"] == n_rep and s["cache"]["hits"] == n_rep, s
    assert launches["mlp_forward_f32"] == s["batches"], \
        (launches, s["batches"])
    want = _standalone(engine, tasks, args.seed)
    for r in responses:
        i = int(r.seed) - args.seed
        assert _same(r.result.selection, want[i]), (label, r.source, i)
    out = dict(requests=len(responses), seconds=rep["seconds"],
               requests_per_s=len(responses) / rep["seconds"],
               dispatched_rows_per_s=n / rep["seconds"],
               batches=s["batches"], mean_batch=s["mean_batch_size"],
               ms_per_dispatch=1e3 * s["dispatch_s"] / s["batches"],
               coalesced=s["coalesced"], cache_hits=s["cache"]["hits"],
               n_satisfied=sum(r.result.satisfied for r in dispatched),
               launches=launches)
    if rep["latency"] is not None:
        out["latency"] = rep["latency"]
    return out


def drive_serve_sync() -> dict:
    """Phase f: ``launch/dse_serve`` (the sync pump) at SERVE_ARGV, counts
    zeroed just before it; then one warm dispatch of 64 fresh requests
    profiled."""
    zero_counts()
    t0 = time.perf_counter()
    rep = dse_serve.serve(SERVE_ARGV)
    launches = counts()
    out = _check_served("serve sync", rep, launches)
    srv, tasks, name = rep["server"], rep["tasks"], rep["engine"].model.name
    for i in range(N_TASKS):
        srv.submit(name, tasks.net_idx[i], tasks.lat_obj[i],
                   tasks.pow_obj[i], seed=10_000 + i)
    batch = srv.form_batch()
    assert batch is not None and batch.n_real == N_TASKS
    out["dispatch_profile"] = profile_step(lambda: srv.publish_batch(
        batch, *srv.execute_batch(batch)), ())
    out["phase_s"] = time.perf_counter() - t0
    print("serve sync: " + json.dumps(out), flush=True)
    return dict(out, report=rep)


def drive_serve_concurrent() -> dict:
    """Phase g: the same workload through the front end (``--concurrent``),
    counts zeroed just before it; then the fault run: the same stream
    through ``FaultyEngine`` (a burst of 3 batched-route faults,
    ``degrade_after`` 3), which must enter the degraded route, recover,
    lose nothing, and answer every request as a standalone explore_tasks
    on the route that computed it does."""
    from repro_torch.serve import (DSEServer, FaultPlan, FaultyEngine,
                                   ServeConfig, ServeFrontend)
    zero_counts()
    t0 = time.perf_counter()
    rep = dse_serve.serve(SERVE_ARGV + ["--concurrent"])
    launches = counts()
    out = _check_served("serve concurrent", rep, launches)
    out["phase_s"] = time.perf_counter() - t0

    engine, tasks, args = rep["engine"], rep["tasks"], rep["args"]
    n, n_rep = args.requests, int(args.requests * args.repeat_frac)
    faulty = FaultyEngine(engine, FaultPlan(burst_start=0, burst_len=3))
    srv = DSEServer(ServeConfig(
        max_batch=args.max_batch, max_dispatch_attempts=10,
        retry_backoff_base=0.005, retry_jitter=0.0, degrade_after=3,
        degrade_probe_after=1))
    srv.register(faulty)
    zero_counts()
    t1 = time.perf_counter()
    with ServeFrontend(srv) as fe:
        responses = dse_serve.serve_concurrent(fe, engine.model.name, tasks,
                                               n, n_rep, args.seed)
        latency = fe.metrics()["frontend"]["latency"]
    fault_s = time.perf_counter() - t1
    fault_launches = counts()
    s = srv.summary()
    assert len(responses) == n + 2 * n_rep and all(r.ok for r in responses)
    assert s["pending"] == 0 and s["failed"] == 0, s
    assert faulty.injected_errors == 3, faulty.fault_stats()
    assert s["degraded_entered"] == 1 and s["degraded_recovered"] == 1, s
    assert not s["degraded"], s["degraded"]
    degraded = [r for r in responses if r.degraded]
    assert degraded, "the fault run never took the degraded route"
    # a row's one computed result (cache hits and coalesced followers
    # share it) comes from the route of its dispatch
    want = _standalone(engine, tasks, args.seed)
    rows = sorted({int(r.seed) - args.seed for r in degraded})
    t2 = time.perf_counter()
    seq = engine.explore_tasks(tasks.take(np.asarray(rows)),
                               seed=np.asarray(rows, np.int64) + args.seed,
                               batched=False)
    seq_ms = 1e3 * (time.perf_counter() - t2) / len(rows)
    want_seq = {i: r.selection for i, r in zip(rows, seq)}
    for r in responses:
        i = int(r.seed) - args.seed
        assert _same(r.result.selection, want_seq.get(i, want[i])), \
            ("serve faults", r.source, r.degraded, i)
    out["faults"] = dict(
        seconds=fault_s, requests=len(responses),
        degraded_responses=len(degraded),
        sequential_ms_per_task=seq_ms,
        ms_per_dispatch=1e3 * s["dispatch_s"] / s["batches"],
        degraded_rows_unlike_batched=sum(
            not _same(want_seq[i], want[i]) for i in rows),
        degraded_batches=s["degraded_batches"], batches=s["batches"],
        dispatch_attempts=s["dispatch_attempts"], retried=s["retried"],
        latency=latency, fault_stats=faulty.fault_stats(),
        launches=fault_launches)
    print("serve concurrent: " + json.dumps(out), flush=True)
    return out


def drive_online(per_step: dict) -> dict:
    """Phase h: ``launch/online`` at ONLINE_ARGV (its checkpoints in a
    temporary directory), counts zeroed just before it: at least 3
    generations and 3 swaps, generation 2's corrupted save skipped for
    generation 1 (one fallback), the dense kernels launched by every
    training step (the warm-up epoch's and the generations'), the whole
    MLP by the served waves.  Two threads launch here, but each counter
    has one: the front end's dispatcher the whole MLP, the trainer the
    dense kernels."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="dse_online_") as d:
        zero_counts()
        t0 = time.perf_counter()
        rep = online.run(ONLINE_ARGV + ["--checkpoint-dir", d])
        launches = counts()
        phase_s = time.perf_counter() - t0
    final, timings, args = rep["final"], rep["timings"], rep["args"]
    assert final["generations"] >= 3 and final["swaps"] >= 3, final
    assert final["swap_fallbacks"] == 1, final
    assert final["generation_errors"] == 0, final["last_error"]
    by_gen = {t["generation"]: t for t in timings}
    assert by_gen[2]["serving_step"] == 1, by_gen
    assert by_gen[3]["serving_step"] == 3, by_gen
    assert rep["summary"]["pending"] == 0
    assert all(w["answered"] == args.wave_size for w in rep["waves"])
    for k in ("failed", "retried", "degraded_entered"):
        assert rep["summary"][k] == 0, (k, rep["summary"][k])
    warmup_steps = (args.data + args.replay) // 64     # one epoch, batch 64
    steps = warmup_steps + sum(t["steps"] for t in timings)
    for name in DENSE_KERNELS:
        assert launches[name] == per_step[name] * steps, \
            (name, launches[name], per_step[name], steps)
    assert launches["mlp_forward_f32"] > 0, launches
    out = dict(phase_s=phase_s, wall_s=rep["seconds"],
               satisfied_per_wave=[w["satisfied"] for w in rep["waves"]],
               waves=rep["waves"], generations=final["generations"],
               swaps=final["swaps"], fallbacks=final["swap_fallbacks"],
               mined_rows=final["mined_rows"], timings=timings,
               ms_per_step_in_run=[1e3 * t["train_s"] / t["steps"]
                                   for t in timings],
               training_steps=steps, launches=launches,
               canaries=final["canaries"])
    out["alone"] = online_training_alone(args)
    print("online: " + json.dumps(out), flush=True)
    return out


def online_training_alone(args) -> dict:
    """Phase h's training with nothing beside it, after the run: a
    generation's ``train_gan`` (the launcher's config, data + replay rows,
    its epochs, warm-started) on this thread with no front end, trainer
    or launcher thread running, its ms a step to hold beside the run's;
    then one warm step of batch 64 profiled (device busy ms, idle share,
    launches)."""
    model = online.MODELS[args.model]()
    cfg = G.GANConfig(n_net=model.net_space.n_dims).scaled(
        layers=args.layers, neurons=args.neurons, batch_size=64)
    ds = gen_mod.generate_dataset(model, args.data + args.replay,
                                  seed=args.seed)
    st = T.train_gan(model, ds, cfg, iters=1, seed=args.seed,
                     device="cuda")                     # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = T.train_gan(model, ds, cfg, iters=args.train_iters, seed=1,
                     state=st, device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = len(st.history)
    batch = T.encode_dataset(
        model, gen_mod.generate_dataset(model, 64, seed=args.seed), "cuda")
    step = T.make_train_step(model, cfg)[2]
    step_args = (st.g_params, st.d_params, st.g_opt, st.d_opt, batch, st.rng)
    step(*step_args)                                    # warm at this shape
    return dict(train_s=train_s, steps=steps,
                ms_per_step=1e3 * train_s / steps,
                step_profile=profile_step(step, step_args))


def _same(a, b) -> bool:
    if (a.cfg_idx is None) != (b.cfg_idx is None):
        return False
    if a.cfg_idx is not None and not np.array_equal(a.cfg_idx, b.cfg_idx):
        return False
    return (a.latency, a.power, a.satisfied, a.n_candidates) == \
        (b.latency, b.power, b.satisfied, b.n_candidates)


def flash_grad_work(shape) -> tuple:
    """Bytes and kept (query, key) pairs of one flash attention's forward
    (q, k, v read, o and lse written) and backward (q, k, v, o, dO and lse
    read, dq, dk and dv written), float32; `shape` (B, H, Hkv, Sq, Sk, D,
    causal, window)."""
    b, h, hkv, sq, sk, d, causal, window = shape
    big, small, rows = b * h * sq * d, b * hkv * sk * d, b * h * sq
    fwd = 4 * (2 * big + 2 * small + rows)
    bwd = 4 * (4 * big + 4 * small + rows)
    return fwd, bwd, b * h * kept_pairs(sq, sk, causal, window, 0)


def flash_grad_bound_ms(shape) -> dict:
    """Least time of the Function's forward plus backward, the way each
    computes: the kernel's forward at three TF32 products of 4·D flops a
    kept pair (495 TFLOP/s), the torch-ops backward's five products (S,
    dP, dV, dQ, dK: 10·D flops a kept pair) at the float32 peak outside
    the tensor cores (67 TFLOP/s, TF32 off); beside it the backward of a
    hand-written 3xTF32 kernel (30·D flops a pair at 495 TFLOP/s)."""
    fwd_b, bwd_b, pairs = flash_grad_work(shape)
    d = shape[5]
    fwd = bound(fwd_b, 3 * 4 * d * pairs, PEAK_TF32_FLOPS)
    bwd = bound(bwd_b, 10 * d * pairs)
    bwd_tc = bound(bwd_b, 3 * 10 * d * pairs, PEAK_TF32_FLOPS)
    return dict(bound_ms=fwd[0] + bwd[0], bound_by=bwd[1],
                fwd_bound_ms=fwd[0], bwd_bound_ms=bwd[0],
                bwd_bound_3xtf32_ms=bwd_tc[0], kept_pairs=pairs)


def _vjp(fn, inputs, dout) -> list:
    """fn(*inputs) and its gradients for the cotangent dout: [out, *d]."""
    leaves = [t.detach().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    out.backward(dout.to(out.dtype))
    return [out.detach()] + [t.grad for t in leaves]


def flash_grad_row(label: str, shape, gen) -> dict:
    """``nn/attention.FlashAttentionFn`` (the kernel's forward with lse,
    the blocked torch-ops backward) at one (B, H, Hkv, Sq, Sk, D, causal,
    window) shape, float32, on (B, S, H, D) tensors as the model passes
    them.  The kernel's out the same bits with and without lse; lse
    within 1e-5·max(1, |lse|) of the plain version's; out, dq, dk and dv
    from a float64 autograd of the same inputs no further than 4x the
    plain float32 route's (``use_fused=False``, torch's autograd) plus
    1e-6·scale; the same bits twice.  CUDA-event medians: the forward
    with and without lse, the backward alone, the Function's and the
    plain route's forward + backward, and SDPA's forward and forward +
    backward (float32, the same boolean mask; a yardstick the port never
    calls)."""
    import torch.nn.functional as F
    b, h, hkv, sq, sk, d, causal, window = shape
    kw = dict(causal=causal, window=window)
    q, k, v, do = (torch.randn(b, n, m, d, generator=gen, device="cuda")
                   for n, m in ((sq, h), (sk, hkv), (sk, hkv), (sq, h)))
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o_alone = fa.flash_attention(qt, kt, vt, **kw)
    o_lse, lse = fa.flash_attention(qt, kt, vt, return_lse=True, **kw)
    _, lse_plain = ref.flash_attention(qt, kt, vt, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o_alone, o_lse), f"{label}: lse changed out"
    lse_err = float(((lse - lse_plain).abs()
                     / lse_plain.abs().clamp(min=1.0)).max())
    assert lse_err <= 1e-5, f"{label}: lse {lse_err}"
    del lse_plain
    kern = lambda *t: A.flash_attention(*t, **kw)
    plain = lambda *t: A.flash_attention(*t, use_fused=False, **kw)
    f64 = lambda a, b_, c: flash_float64(
        a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2), causal,
        window, 0).transpose(1, 2)
    got = _vjp(kern, (q, k, v), do)
    again = _vjp(kern, (q, k, v), do)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    assert same, f"{label}: two calls differ"
    del again
    want = _vjp(plain, (q, k, v), do)
    exact = _vjp(f64, tuple(t.double() for t in (q, k, v)), do.double())
    row = dict(lse_max_rel_err=lse_err, same_bits=True,
               out_same_bits_with_lse=True,
               **float64_errors(f"flash grad {label}", got, want, exact))
    row["max_abs_err_vs_plain"] = {
        n: _err(x, y) for n, x, y in zip(("out", "dq", "dk", "dv"), got,
                                         want)}
    del got, want, exact
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    if window:
        keep &= ~torch.ones_like(keep).tril(-window)
    sdpa = lambda a, b_, c: F.scaled_dot_product_attention(
        a, b_, c, attn_mask=keep, enable_gqa=True)
    row.update(
        fwd_ms=cuda_ms(lambda: fa.flash_attention(qt, kt, vt, **kw)),
        fwd_lse_ms=cuda_ms(lambda: fa.flash_attention(
            qt, kt, vt, return_lse=True, **kw)),
        bwd_ms=cuda_ms(lambda: A.flash_backward(qt, kt, vt, o_lse, lse,
                                                dot, **kw)),
        fwd_bwd_ms=cuda_ms(lambda: _vjp(kern, (q, k, v), do)),
        plain_fwd_bwd_ms=cuda_ms(lambda: _vjp(plain, (q, k, v), do)),
        library_fwd_ms=cuda_ms(lambda: sdpa(qt, kt, vt)),
        library_fwd_bwd_ms=cuda_ms(lambda: _vjp(sdpa, (qt, kt, vt), dot)),
        **flash_grad_bound_ms(shape))
    print(f"flash grad {label}: " + json.dumps(row), flush=True)
    return row


def check_flash_grad() -> dict:
    """Phase i: `flash_grad_row` at FLASH_GRAD_SHAPES, causal (Sq = Sk)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    return {label: flash_grad_row(label, (b, h, hkv, s, s, d, True, window),
                                  gen)
            for label, (b, h, hkv, s, d, window) in FLASH_GRAD_SHAPES.items()}


def lm_train_batch(m, step: int, shape=LM_TRAIN) -> dict:
    """Step `step` of the synthetic stream (seed 0) at `shape` (batch x
    seq), on the card."""
    b, s = shape
    toks, labels = SyntheticStream(DataConfig(
        vocab=m.vocab, seq_len=s, global_batch=b, seed=0)).batch(step)
    return {"tokens": torch.from_numpy(toks).to("cuda", torch.long),
            "labels": torch.from_numpy(labels).to("cuda", torch.long)}


def lm_train_bound_ms(m, n_params: int) -> float:
    """Least time of a train step at the float32 peak (67 TFLOP/s, TF32
    off): 6·N·tokens (N without an untied embedding table: a lookup, no
    product), plus attention's 12·D flops (4 forward, 8 backward) per
    kept (query, key) pair and head; plus, for each SSM layer, the
    selective scan's forward and backward bounds (bytes)."""
    b, s = LM_TRAIN
    if not m.tied_embeddings:
        n_params -= m.vocab * m.d_model
    attn = sum(seg.repeats * 12 * sp.cfg.dh * sp.cfg.n_heads * b
               * kept_pairs(s, s, True, sp.cfg.window, 0)
               for seg in m.segments for sp in seg.pattern)
    scans = sum(seg.repeats * (
        ssm_bound_ms(b, s, 2 * m.d_model, sp.cfg.ssm_state)[0]
        + ssm_bwd_bound_ms(b, s, 2 * m.d_model, sp.cfg.ssm_state)[0])
        for seg in m.segments for sp in seg.pattern if sp.cfg.ssm_state)
    return 1e3 * (6 * n_params * b * s + attn) / PEAK_F32_FLOPS + scans


@contextlib.contextmanager
def float64_block():
    """The blocks' attention, RMSNorm and LayerNorm in float64 (the
    port's compute them in float32 whatever their inputs): the reference
    of ``check_lm_block`` and of whisper's float64 gradient."""
    attn, norm, lnorm = A.flash_attention, L.rmsnorm_apply, \
        L.layernorm_apply

    def attn64(q, k, v, *, causal=True, window=None, **_):
        return flash_float64(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal, window,
                             0).transpose(1, 2)

    def norm64(params, x, eps=1e-6):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * params["scale"]

    def lnorm64(params, x, eps=1e-5):
        c = x - x.mean(-1, keepdim=True)
        return c * torch.rsqrt(c.square().mean(-1, keepdim=True) + eps) \
            * params["scale"] + params["bias"]

    A.flash_attention, L.rmsnorm_apply, L.layernorm_apply = \
        attn64, norm64, lnorm64
    try:
        yield
    finally:
        A.flash_attention, L.rmsnorm_apply, L.layernorm_apply = \
            attn, norm, lnorm


def check_lm_block(m, params, batch) -> dict:
    """One full-width block (layer 0) forward and backward on the batch's
    embeddings (at its positions, if it has them), through the kernel
    route, the plain route and float64:
    the output and every gradient (input and params) from float64 no
    further than 4x the plain float32 route's plus 1e-6·scale."""
    cfg = m.segments[0].pattern[0].cfg
    lp = tree_map(lambda a: a[0].detach().clone(), params["segments"][0][0])
    x = L.embed_apply(params["embed"], batch["tokens"]).detach()
    dy = torch.randn(x.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    pos = batch.get("positions")
    if pos is None:
        pos = torch.arange(x.shape[1], device="cuda")[None].expand(
            x.shape[:2])
    leaves = tree_leaves(lp)

    def run(use_fused, dtype=torch.float32):
        def fn(x_, *ps):
            return NB.block_apply(tree_unflatten(lp, list(ps)), x_, cfg, pos,
                                  use_fused=use_fused)
        return _vjp(fn, [t.to(dtype) for t in (x, *leaves)], dy.to(dtype))

    got, want = run(None), run(False)
    with float64_block():
        exact = run(False, torch.float64)
    out = float64_errors("lm block", got, want, exact)
    out["max_norm_err_kernel_vs_plain"] = max(
        _norm_err(a, b_) for a, b_ in zip(got, want))
    return out


def grads_vs_plain(m, params, batch) -> dict:
    """One gradient through the kernels (a flash launch with lse a layer,
    asserted) against the plain route (``use_fused=False``, with remat:
    without it the plain attention keeps a score matrix a layer): the loss
    within 1e-5 relative, each leaf within 1e-3 of its norm."""
    zero_counts()
    loss_k, g_k = TS.loss_and_grads(m, params, batch)
    launches = counts()
    assert launches["flash_attention_f32 with lse"] == m.n_layers, launches
    loss_p, g_p = TS.loss_and_grads(m, params, batch, remat=True,
                                    use_fused=False)
    loss_k, loss_p = float(loss_k), float(loss_p)
    assert np.isfinite(loss_k), loss_k
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    errs = [_norm_err(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                              tree_leaves(g_p))]
    assert max(errs) <= 1e-3, f"gradient leaf {int(np.argmax(errs))}: " \
        f"{max(errs)} of its norm from the plain route's"
    del g_k, g_p
    torch.cuda.empty_cache()
    return dict(loss=loss_k, plain_loss=loss_p, grad_launches=launches,
                max_grad_norm_err_vs_plain=max(errs), n_grad_leaves=len(errs))


def timed_train_steps(step, params, opt, warm, batches, flash_per_step: int
                      ) -> tuple:
    """One warm `step` on the batch `warm`, then one on each of `batches`
    timed (host clock ended by a synchronize), their launches counted
    from zero: `flash_per_step` flash launches a step, all with lse
    (asserted); every loss finite; the peak memory of the timed steps.
    Returns (params, opt, the measurements)."""
    params, opt, met = step(params, opt, warm)
    losses = [float(met["loss"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for b_ in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, b_)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(met["loss"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(losses).all(), losses
    for key in ("flash_attention_f32", "flash_attention_f32 with lse"):
        assert launches[key] == flash_per_step * len(batches), (key,
                                                                launches)
    return params, opt, dict(
        losses=losses, step_ms=times, ms_per_step=statistics.median(times),
        launches=launches, max_memory_allocated_gb=peak / 1e9)


def check_lm_train() -> dict:
    """Phase j: stablelm-1.6b at full width (24 layers, d 2048, 32 heads of
    64, d_ff 5632, vocab 100352, tied), float32 params from seed 0,
    batch 2 x 2048 from SyntheticStream: one block against float64; the
    loss and every gradient of the kernel route (``remat=False``, the
    launcher's) against the plain route's (``use_fused=False``, with
    ``remat=True``: without it the plain attention keeps a 1 GB score
    matrix a layer) from the same state; then ``make_train_step``: one
    warm step and LM_TRAIN_STEPS timed ones (host clock ended by a
    synchronize), their launches counted from zero, the peak memory, one
    more step profiled."""
    m = configs.get_arch(LM_TRAIN_ARCH)
    params = init_lm(m, m.name)
    n_params = MB.param_count(params)
    batch0 = lm_train_batch(m, 0)
    out = dict(arch=m.name, n_params=n_params, batch=list(LM_TRAIN),
               block=check_lm_block(m, params, batch0))
    print(f"lm train block: {json.dumps(out['block'])}", flush=True)

    out.update(grads_vs_plain(m, params, batch0))

    def grads_ms(**kw) -> float:
        """Host ms of one warm loss_and_grads (forward and backward)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TS.loss_and_grads(m, params, batch0, **kw)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    out.update(grads_ms=grads_ms(), grads_remat_ms=grads_ms(remat=True),
               plain_grads_remat_ms=grads_ms(remat=True, use_fused=False))

    step, optim = TS.make_train_step(m, remat=False)
    batches = [lm_train_batch(m, i) for i in range(1, LM_TRAIN_STEPS + 2)]
    params, opt, run = timed_train_steps(step, params, optim.init(params),
                                         batch0, batches[:LM_TRAIN_STEPS],
                                         m.n_layers)
    out.update(run, tokens_per_s=LM_TRAIN[0] * LM_TRAIN[1]
               / (run["ms_per_step"] / 1e3),
               bound_ms_per_step=lm_train_bound_ms(m, n_params),
               flash_launches_per_step=m.n_layers,
               profile=profile_step(lambda: step(params, opt, batches[-1]),
                                    ()))
    out["device_launches_per_step"] = out["profile"]["device_launches"]
    out["optimizer_ms"] = out["ms_per_step"] - out["grads_ms"]
    print("lm train: " + json.dumps(out), flush=True)
    del params, opt, batches
    torch.cuda.empty_cache()
    return out


def drive_lm_launcher(argv=LAUNCHER_ARGV, label: str = "lm launcher",
                      kernels=("flash_attention_f32 with lse",)) -> dict:
    """Phase k (and n4): ``launch/train.main`` on the card at a reduced
    config (`argv`: stablelm's, LAUNCHER_ARGV) twice, each into a
    checkpoint directory of its own: uninterrupted, and with
    ``--simulate-failure-at 7``, which fails once, restarts, resumes from
    step 4's checkpoint and replays steps 5-12.  The two histories' losses
    equal, step for step; each run launched each of `kernels`."""
    runs = {}
    with tempfile.TemporaryDirectory(prefix="lm_train_") as tmp:
        for name, extra in (("whole", []),
                            ("restarted", ["--simulate-failure-at", "7"])):
            hist = os.path.join(tmp, f"{name}.json")
            log = io.StringIO()
            zero_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                rc = LT.main(argv + extra + [
                    "--ckpt-dir", os.path.join(tmp, name),
                    "--history-out", hist])
            torch.cuda.synchronize()
            with open(hist) as fh:
                history = json.load(fh)
            runs[name] = dict(rc=rc, seconds=time.perf_counter() - t0,
                              launches=counts(), log=log.getvalue(),
                              losses={r["step"]: r["loss"] for r in history})
    whole, again = runs["whole"], runs["restarted"]
    assert whole["rc"] == again["rc"] == 0
    assert "restart 1/3" in again["log"], again["log"]
    assert "resumed from checkpoint step=4" in again["log"], again["log"]
    assert "after 1 restart(s)" in again["log"], again["log"]
    assert "after 0 restart(s)" in whole["log"], whole["log"]
    assert sorted(whole["losses"]) == list(range(1, 13)), whole["losses"]
    assert whole["losses"] == again["losses"], (whole["losses"],
                                                again["losses"])
    for r in runs.values():
        for key in kernels:
            assert r["launches"][key] > 0, (key, r)
    out = {name: {k: v for k, v in r.items() if k != "log"}
           for name, r in runs.items()}
    print(f"{label}: " + json.dumps(out), flush=True)
    return out


def moe_layer_work(t: int, cfg, cap: int) -> tuple:
    """Bytes one MoE layer must move (the tokens, the router and the
    three expert weights read once, the output written once), its flops
    as computed (the router, the three products over the whole capacity
    buffers) and those of the kept assignments alone (2·3·T·K·D·F)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    n_bytes = 4 * (2 * t * d + d * e + 3 * e * d * f)
    return n_bytes, 2 * t * d * e + 2 * 3 * e * cap * d * f, \
        2 * t * d * e + 2 * 3 * t * cfg.top_k * d * f


def check_moe_layer(arch: str) -> dict:
    """Phase l1: the MoE layer (``nn/moe.moe_apply``) of `arch` at full
    width (float32 from seed 0) on the prefill's 2 x 4096 tokens of unit
    RMS, under no_grad.  At three capacity factors (one that drops
    nothing, the default 1.25, and 1.0, which must drop some): the
    card's routing and dispatch integers equal the CPU port's on the same
    router logits, and the layer is within TOL·max(1, max|y|) of the
    dense-gather oracle (``ref.moe_dispatch_ffn``) with the dropped
    assignments' weights zeroed.  Two calls the same bits.  CUDA-event
    medians of the layer, the oracle and the parts at the default:
    routing, dispatch, each of the three batched products, the SwiGLU
    products together, combine."""
    cfg = configs.get_arch(arch).segments[0].pattern[0].cfg
    e, k = cfg.n_experts, cfg.top_k
    t = PREFILL[0] * PREFILL[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = MOE.moe_init(prng.prng_key(torch.tensor(0)), e, cfg.d_model,
                     cfg.d_ff, "cuda")
    x = torch.randn((t, cfg.d_model), generator=gen, device="cuda")
    w3 = (p["w_gate"], p["w_up"], p["w_down"])
    row = dict(arch=arch, tokens=t, experts=e, top_k=k, d_model=cfg.d_model,
               d_ff=cfg.d_ff)
    with torch.no_grad():
        logits = x @ p["router"]
        idx, wts = MOE.route_topk(logits, k)
        idx_c = MOE.route_topk(logits.cpu(), k)[0]
        assert torch.equal(idx.cpu(), idx_c), f"{arch}: routing differs " \
            "from the CPU port's"
        load = int(torch.bincount(idx.reshape(-1), minlength=e).max())
        row["max_expert_load"] = load
        for label, cf in (("no drops", (load + 0.5) * e / (k * t)),
                          ("default", 1.25), ("drops", 1.0)):
            cap = MOE.capacity(t, e, k, cf)
            disp = MOE._dispatch_group(idx, e, cap)
            for name, a, b_ in zip(("buf_tok", "occupied", "slot", "keep"),
                                   disp, MOE._dispatch_group(idx_c, e, cap)):
                assert torch.equal(a.cpu(), b_), \
                    f"{arch} {label}: {name} differs from the CPU port's"
            keep = disp[3].reshape(t, k)
            dropped = int((~keep).sum())
            if label == "no drops":
                assert dropped == 0, (arch, label, dropped)
            if label == "drops":
                assert dropped > 0, (arch, label, dropped)
            want = ref.moe_dispatch_ffn(x, *w3, idx, wts * keep)
            err = _hold(f"moe layer {arch} {label}",
                        MOE.moe_apply(p, x, top_k=k, capacity_factor=cf),
                        want)
            row[label] = dict(capacity_factor=cf, capacity=cap,
                              dropped=dropped, max_abs_err=err,
                              tol=TOL * max(1.0, float(want.abs().max())))
            del want
        cap = row["default"]["capacity"]
        y = MOE.moe_apply(p, x, top_k=k)
        same = torch.equal(y, MOE.moe_apply(p, x, top_k=k))
        assert same, f"moe layer {arch}: two calls differ"
        del y
        wk = wts * MOE._dispatch_group(idx, e, cap)[3].reshape(t, k)
        xe, slot, keep_f = MOE.dispatch(x, idx, e, cap)
        g = torch.bmm(xe, p["w_gate"])
        h = torch.nn.functional.silu(g) * torch.bmm(xe, p["w_up"])
        del g
        ye = torch.bmm(h, p["w_down"])
        kw = dict(reps=5, warmup=1)
        parts = dict(
            route_ms=cuda_ms(lambda: MOE.route_topk(x @ p["router"], k), **kw),
            dispatch_ms=cuda_ms(lambda: MOE.dispatch(x, idx, e, cap), **kw),
            bmm_gate_ms=cuda_ms(lambda: torch.bmm(xe, p["w_gate"]), **kw),
            bmm_up_ms=cuda_ms(lambda: torch.bmm(xe, p["w_up"]), **kw),
            bmm_down_ms=cuda_ms(lambda: torch.bmm(h, p["w_down"]), **kw),
            expert_ffn_ms=cuda_ms(lambda: MOE.expert_ffn(p, xe), **kw),
            combine_ms=cuda_ms(lambda: MOE.combine(ye, slot, keep_f, wts),
                               **kw))
        del h, ye, xe
        ms = cuda_ms(lambda: MOE.moe_apply(p, x, top_k=k), **kw)
        plain_ms = cuda_ms(lambda: ref.moe_dispatch_ffn(x, *w3, idx, wk),
                           **kw)
    n_bytes, flops, kept_flops = moe_layer_work(t, cfg, cap)
    bnd, by = bound(n_bytes, flops)
    row.update(cpu_integers_equal=True, same_bits=same,
               max_abs_err=max(row[lb]["max_abs_err"]
                               for lb in ("no drops", "default", "drops")),
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bnd,
               bound_by=by, bound_kept_ms=bound(n_bytes, kept_flops)[0],
               dispatch_share=(parts["route_ms"] + parts["dispatch_ms"]
                               + parts["combine_ms"]) / ms, **parts)
    print(f"moe layer {arch}: " + json.dumps(row), flush=True)
    del p, x, logits, idx, wts, wk
    torch.cuda.empty_cache()
    return row


def moe_model(n_layers: int):
    """MOE_ARCH at full width with its one segment cut to `n_layers`
    (``dataclasses.replace``), float32 params from seed 0 on the card,
    and the cut as a `reduced` record."""
    full = configs.get_arch(MOE_ARCH)
    m = cut_config(full, n_layers)
    params = init_lm(m, f"{m.name} {n_layers} layers")
    reduced = dict(n_layers=n_layers, of=full.n_layers,
                   why="the full depth is 187 GB of float32 params")
    print(f"moe model {m.name}: {MB.param_count(params)} params, {n_layers} "
          f"of {full.n_layers} layers", flush=True)
    return m, params, reduced


@contextlib.contextmanager
def moe_oracle():
    """``nn/moe.moe_apply`` replaced by the dense-gather oracle over the
    assignments the layer's own routing and capacity keep: each MoE layer
    of the plain decode step l3 holds the Engine's to."""
    apply = MOE.moe_apply

    def plain(params, x, *, top_k=2, capacity_factor=1.25, aux_loss=False):
        assert not aux_loss
        t, e = x.shape[0], params["router"].shape[-1]
        idx, wts = MOE.route_topk(x @ params["router"], top_k)
        keep = MOE._dispatch_group(
            idx, e, MOE.capacity(t, e, top_k, capacity_factor))[3]
        return ref.moe_dispatch_ffn(x, params["w_gate"], params["w_up"],
                                    params["w_down"], idx,
                                    wts * keep.reshape(t, top_k))

    MOE.moe_apply = plain
    try:
        yield
    finally:
        MOE.moe_apply = apply


def drive_moe_serve(m, params) -> dict:
    """Phase l3: the Engine serving SERVE's requests on the MoE model
    (launches counted from zero).  An MoE decode step routes its lanes at
    the capacity of that many tokens (one slot an expert at 4 lanes and 8
    experts), as the reference's does, so the Engine is not held to the
    prefill step: each decode step of the first wave's prompt is held to
    a decode step from the plain pieces on the same tokens, params and
    start (each MoE layer the dense-gather oracle over that step's kept
    assignments), within TOL.  A step reads every expert: the bound is
    the params' bytes but the embedding table's, over HBM."""
    plen = SERVE["prompt_len"]
    zero_counts()
    run = run_engine(m, params, plen)
    launches = counts()
    states = MB.init_decode_state(params, m, SERVE["slots"],
                                  SERVE["cache_len"])
    plain = TS.make_decode_step(m)
    errs = []
    with moe_oracle():
        for st in run["steps"]:
            logits, states = plain(params, st["toks"], st["clock"], states,
                                   start=st["start"])
            errs.append(_logits_agree(
                f"moe decode step {st['clock']} vs the plain pieces",
                st["logits"], logits[:, 0]))
    assert len(errs) == plen, len(errs)
    weight_bytes = 4 * (MB.param_count(params)
                        - params["embed"]["table"].numel())
    out = dict(run["stats"], launches=launches,
               decode_launches_per_step=run["stats"]["decode_step_profile"][
                   "device_launches"],
               weights_read_gb=weight_bytes / 1e9,
               weights_read_ms=1e3 * weight_bytes / PEAK_HBM_BYTES,
               decode_vs_plain=dict(
                   steps=len(errs),
                   max_abs_err=max(e_["max_abs_err"] for e_ in errs),
                   tol=min(e_["tol"] for e_ in errs)))
    print("moe serve: " + json.dumps(out), flush=True)
    return out


def check_moe_train(m, params, reduced: dict) -> dict:
    """Phase l4: MOE_ARCH cut to MOE_LAYERS (`m`, `params`: phase l2's
    and l3's, updated in place here), batch MOE_TRAIN of
    ``SyntheticStream``: the kernel route's loss and gradients
    (``remat=False``) twice, the same bits (the MoE layer's backward has
    no atomic adds), and against the plain route's (``use_fused=False``)
    from the same state with the routing flips between the routes
    counted; then ``make_train_step``: one warm step and MOE_TRAIN_STEPS
    timed (host clock ended by a synchronize), their launches counted
    from zero (one flash launch with lse a layer and step), the peak
    memory, one more step profiled."""
    n_params = MB.param_count(params)
    batch0 = lm_train_batch(m, 0, MOE_TRAIN)
    with recorded_routes() as route_k:
        loss_k, g_k = TS.loss_and_grads(m, params, batch0)
    loss_2, g_2 = TS.loss_and_grads(m, params, batch0)
    same = bool(torch.equal(loss_k, loss_2)) and all(
        torch.equal(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                            tree_leaves(g_2)))
    del g_2
    with recorded_routes() as route_p:
        loss_p, g_p = TS.loss_and_grads(m, params, batch0, use_fused=False)
    flips = routing_flips(route_k, route_p)
    loss_k, loss_p = float(loss_k), float(loss_p)
    assert np.isfinite(loss_k), loss_k
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p,
                                                        flips)
    errs = [_norm_err(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                              tree_leaves(g_p))]
    assert max(errs) <= 1e-3, f"gradient leaf {int(np.argmax(errs))}: " \
        f"{max(errs)} of its norm from the plain route's ({sum(flips)} " \
        f"routing flips)"
    assert same, "two backward passes of the kernel route differ"
    out = dict(arch=m.name, reduced=reduced, n_params=n_params,
               batch=list(MOE_TRAIN), loss=loss_k, plain_loss=loss_p,
               max_grad_norm_err_vs_plain=max(errs), n_grad_leaves=len(errs),
               routing_flips_by_layer=flips, grads_same_bits_twice=same)
    del g_k, g_p, route_k, route_p
    torch.cuda.empty_cache()

    step, optim = TS.make_train_step(m, remat=False)
    batches = [lm_train_batch(m, i, MOE_TRAIN)
               for i in range(1, MOE_TRAIN_STEPS + 2)]
    params, opt, run = timed_train_steps(step, params, optim.init(params),
                                         batch0, batches[:MOE_TRAIN_STEPS],
                                         m.n_layers)
    b, s = MOE_TRAIN
    out.update(
        run, tokens_per_s=b * s / (run["ms_per_step"] / 1e3),
        bound_ms_per_step=3e3 * sum(prefill_flops(m, b, s).values())
        / PEAK_F32_FLOPS,
        profile=profile_step(lambda: step(params, opt, batches[-1]), ()))
    print("moe train: " + json.dumps(out), flush=True)
    del params, opt, batches
    torch.cuda.empty_cache()
    return out


def ssm_work(b: int, s: int, di: int, n: int) -> tuple:
    """Bytes the selective scan must move and its float32 operations (8
    at each (b, t, d, n)): the kernel's own ``ss.work``."""
    ops_, n_bytes, _ = ss.work(b, s, di, n)
    return n_bytes, ops_


def ssm_bound_ms(b: int, s: int, di: int, n: int) -> tuple:
    """Least time of one selective scan on this card: its bytes over HBM
    against its operations at the float32 SIMT peak."""
    return bound(*ssm_work(b, s, di, n))


def ssm_bwd_work(b: int, s: int, di: int, n: int) -> tuple:
    """Bytes the scan's backward must move and its float32 operations (26
    at each (b, t, d, n)), the kernel's own ``ss.bwd_work``, with the
    bytes of its partial sums over its blocks of 256 / N channels
    (written, then read) between them."""
    ops_, n_bytes, _ = ss.bwd_work(b, s, di, n)
    blocks = -(-di // (256 // n))
    partials = 4 * 2 * (2 * b * blocks * s * n + b * di * n)
    return n_bytes, partials, ops_


def ssm_bwd_bound_ms(b: int, s: int, di: int, n: int) -> tuple:
    """Least time of the scan's backward: its bytes over HBM against its
    operations at the float32 SIMT peak."""
    n_bytes, _, ops_ = ssm_bwd_work(b, s, di, n)
    return bound(n_bytes, ops_)


def hymba_model():
    """Phase m0: HYMBA_ARCH at full width, ``init_params(prng_key(0))`` on
    the card (timed), its bits held to the CPU's draw
    (`check_init_bits`)."""
    m = configs.get_arch(HYMBA_ARCH)
    params = init_lm(m, m.name)
    bits = check_init_bits(m, params)
    n_global = sum(seg.repeats for seg in m.segments for sp in seg.pattern
                   if sp.cfg.window is None)
    print(f"hymba {m.name}: {MB.param_count(params)} params, {m.n_layers} "
          f"layers ({n_global} global), init bits: {json.dumps(bits)}",
          flush=True)
    return m, params, dict(INIT_S[m.name], bits=bits)


#: markers of the weights `check_init_bits`'s CPU pass does not draw:
#: -(MARK + i) for the i-th, exact in float32 and no value an init sets
MARK = 1e6


def check_init_bits(m, params, seed: int = 0, sample: int = 1 << 14
                    ) -> dict:
    """The card's initial weights against the CPU's draw (which the tests
    hold to the reference's), for the embedding table and layer 0 of
    every stack (an encoder's too, and its ``pos_embed``).  The CPU runs
    ``init_params`` on the model cut to one layer a segment (layer 0's
    keys are the full model's) with each
    weight's draw replaced by a marker that records its key and scale;
    then for each weight the CPU draws `sample` counters at its start,
    its middle, its end and (past ``prng.CHUNK``) across the first chunk
    boundary, and those elements of the card's weight must have the same
    bits.  The leaves that are not drawn (norm scales, zeros, -4.6,
    A_log) are compared whole."""
    one = lambda segs: tuple(  # noqa: E731
        dataclasses.replace(sg, repeats=1) for sg in segs)
    cut = dataclasses.replace(m, segments=one(m.segments), enc_segments=(
        None if m.enc_segments is None else one(m.enc_segments)))
    drawn, draw = [], prng.normal_scaled

    def marker(key, shape, scale, device):
        drawn.append((key.cpu(), scale))
        return torch.full(shape, -(MARK + len(drawn) - 1))

    prng.normal_scaled = marker
    try:
        cpu = MB.init_params(prng.prng_key(torch.tensor(seed)), cut, "cpu")
    finally:
        prng.normal_scaled = draw
    def layer0_and_rest(cpu_tree, card_tree):
        """(cpu, card) leaf pairs: layer 0 of each segment stack, the other
        leaves whole."""
        out = [(c[0], d[0]) for cs, ds in zip(cpu_tree["segments"],
                                              card_tree["segments"])
               for c, d in zip(tree_leaves(cs), tree_leaves(ds))]
        return out + [(c, d) for k in cpu_tree
                      if k not in ("segments", "encoder")
                      for c, d in zip(tree_leaves(cpu_tree[k]),
                                      tree_leaves(card_tree[k]))]

    pairs = layer0_and_rest(cpu, params)
    if "encoder" in cpu:
        pairs += layer0_and_rest(cpu["encoder"], params["encoder"])
    sampled = whole = counters = 0
    for c, d in pairs:
        assert c.shape == d.shape, (c.shape, d.shape)
        first = float(c.reshape(-1)[0]) if c.numel() else 0.0
        if first > -MARK:
            assert torch.equal(c.view(torch.int32), d.cpu().view(
                torch.int32)), f"an undrawn leaf {tuple(c.shape)} differs"
            whole += 1
            continue
        key, scale = drawn[int(-first - MARK)]
        n = c.numel()
        flat = d.reshape(-1)
        starts = {0, max(n // 2 - sample // 2, 0), max(n - sample, 0)}
        if n > prng.CHUNK:
            starts.add(max(prng.CHUNK - sample // 2, 0))
        for st in sorted(starts):
            cnt = min(sample, n - st)
            want = prng.normal(key, cnt, st) * scale
            got = flat[st:st + cnt].cpu()
            assert torch.equal(want.view(torch.int32),
                               got.view(torch.int32)), \
                f"leaf {tuple(c.shape)}: counters {st}..{st + cnt} differ"
            counters += cnt
        sampled += 1
    assert sampled == len(drawn), (sampled, len(drawn))
    return dict(drawn_leaves=sampled, whole_leaves=whole,
                counters_compared=counters)


def ssm_scan_inputs(m, params, seed: int = 17, shape=PREFILL) -> tuple:
    """The selective scan's inputs at `shape` (batch x seq; the prefill's)
    from layer 0 of the first local segment: a random (B, S, D) hidden
    state, RMS-normed, through that layer's in_proj, conv, SiLU and (dt,
    B, C) projections, as ``nn/ssm.ssm_scan`` forms them; h0 zeros."""
    b, s = shape
    p = MB._layer(params["segments"][1][0]["ssm"], 0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = L.rmsnorm_apply({"scale": torch.ones(m.d_model, device="cuda")},
                        torch.randn(b, s, m.d_model, generator=gen,
                                    device="cuda"))
    with torch.no_grad():
        di = p["conv_w"].shape[1]
        x = (h @ p["in_proj"])[..., :di]
        x = torch.nn.functional.silu(SSM._conv_causal(x, p["conv_w"],
                                                      p["conv_b"]))
        dt, bmat, cmat, a = SSM._selective_inputs(p, x)
    h0 = torch.zeros(b, di, a.shape[1], device="cuda")
    return dt, bmat.contiguous(), cmat.contiguous(), x, a, h0


def check_ssm_scan(m, params) -> dict:
    """Phase m1: the selective-scan kernel against its plain loop
    (``ref.ssm_scan``) on the inputs a hymba layer gives it at the
    prefill's shape: ys and the final state within TOL·scale, the same
    bits twice, no further from the float64 scan than 4x the plain
    float32 loop plus 1e-6·scale; CUDA-event times of the kernel and the
    plain loop beside the bound.  No single PyTorch call computes a
    selective scan (library: none)."""
    args = ssm_scan_inputs(m, params)
    b, s, di = args[0].shape
    n = args[4].shape[1]
    got, again = ss.ssm_scan(*args), ss.ssm_scan(*args)
    want = ref.ssm_scan(*args)
    exact = ref.ssm_scan(*(t.double() for t in args))
    torch.cuda.synchronize()
    row = dict(shape=[b, s, di, n],
               max_abs_err=max(_hold("ssm_scan ys", got[0], want[0]),
                               _hold("ssm_scan h", got[1], want[1])),
               tol=TOL * max(1.0, float(want[0].abs().max())),
               same_bits=all(torch.equal(x, y) for x, y in zip(got, again)))
    assert row["same_bits"], "ssm_scan: two calls differ"
    row.update(float64_errors("ssm_scan", got, want, exact))
    del exact
    bnd, by = ssm_bound_ms(b, s, di, n)
    n_bytes, ops_ = ssm_work(b, s, di, n)
    row.update(ms=cuda_ms(lambda: ss.ssm_scan(*args)),
               plain_ms=cuda_ms(lambda: ref.ssm_scan(*args), reps=3,
                                warmup=1),
               bound_ms=bnd, bound_by=by, library_ms=None,
               bytes=n_bytes, operations=ops_,
               exp_bound_ms=1e3 * b * s * di * n / SFU_EXP_PER_S)
    print("ssm_scan_f32: " + json.dumps(row), flush=True)
    return row


def drive_hymba_serve(m, params) -> dict:
    """Phase m3: the Engine serving SERVE's requests on hymba (launches
    counted from zero: decode attention and the SSM's one-token step are
    eager torch, so neither kernel runs).  Each decode step of the first
    wave's prompt is held to the full-sequence forward of those prompts
    at that position, through the kernels (flash and the scan) and
    through the plain pieces (use_fused=False): decode's state and conv
    tail carry what the scan carries.  The engine's first new tokens are
    the prefill's argmax.  A step reads every weight (the tied head the
    whole table): the bound is the params' bytes over HBM."""
    plen = SERVE["prompt_len"]
    zero_counts()
    run = run_engine(m, params, plen)
    launches = counts()
    first = torch.tensor(run["prompts"][:SERVE["slots"]], device="cuda")
    errs = {}
    for route, fused in (("kernels", None), ("plain", False)):
        with torch.no_grad():
            full = MB.forward(params, m, first, use_fused=fused)
        errs[route] = [_logits_agree(
            f"hymba decode step {st['clock']} vs the {route} forward",
            st["logits"], full[:, st["clock"]]) for st in run["steps"]]
        del full
    assert len(errs["kernels"]) == plen, len(errs["kernels"])
    assert [r.out[0] for r in run["done"][:SERVE["slots"]]] == \
        run["steps"][plen - 1]["logits"].argmax(-1).tolist()
    weight_bytes = 4 * MB.param_count(params)
    out = dict(run["stats"], launches=launches,
               decode_launches_per_step=run["stats"]["decode_step_profile"][
                   "device_launches"],
               weights_read_gb=weight_bytes / 1e9,
               weights_read_ms=1e3 * weight_bytes / PEAK_HBM_BYTES,
               **{f"decode_vs_{route}_forward": dict(
                   steps=len(e), max_abs_err=max(x["max_abs_err"] for x in e),
                   tol=min(x["tol"] for x in e))
                  for route, e in errs.items()})
    print("hymba serve: " + json.dumps(out), flush=True)
    return out


def check_ssm_bwd(m, params) -> dict:
    """Phase n1: the scan's backward kernel (``ssm_scan_bwd_f32``) at
    SSM_BWD_SHAPES on a hymba layer's own inputs and a random dys (the
    final state's cotangent None, as in the model), from the forward
    kernel's chunk states: within TOL·scale of its plain version
    (``ref.ssm_scan_bwd`` on the plain loop's chunk states) and of torch's
    autograd of the plain loop, the same bits twice, no further from a
    float64 autograd of the plain loop than 4x the plain float32
    autograd's error plus 1e-6·scale.  CUDA-event medians of the
    backward, of the forward with and without its chunk states, and of
    the plain backward, beside the bound.  No single PyTorch call
    computes a selective scan's backward (library: none)."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(23)
    for label, shape in SSM_BWD_SHAPES.items():
        args = ssm_scan_inputs(m, params, shape=shape)
        b, s, di = args[0].shape
        n = args[4].shape[1]
        dys = torch.randn(b, s, di, generator=gen, device="cuda")
        _, _, h_chunks = ss.ssm_scan_fwd(*args)
        got = ss.ssm_scan_bwd(*args[:5], h_chunks, dys)
        again = ss.ssm_scan_bwd(*args[:5], h_chunks, dys)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        assert same, f"ssm_scan_bwd {label}: two calls differ"
        del again
        _, _, plain_chunks = ref.ssm_scan(*args, boundaries=True)
        plain = ref.ssm_scan_bwd(*args[:5], plain_chunks, dys)
        err = max(_hold(f"ssm_scan_bwd {label} {k} vs its plain version",
                        x, y) for k, x, y in zip(
                            ("d_dt", "d_bmat", "d_cmat", "d_x", "d_a",
                             "d_h0"), got, plain))
        del plain, plain_chunks

        def autograd(dtype):
            return _vjp(lambda *t: ref.ssm_scan(*t)[0],
                        [t.to(dtype) for t in args], dys.to(dtype))[1:]

        want = autograd(torch.float32)
        err_autograd = max(_hold(f"ssm_scan_bwd {label} vs autograd", x, y)
                           for x, y in zip(got, want))
        exact = autograd(torch.float64)
        row = dict(shape=[b, s, di, n], max_abs_err=err,
                   max_abs_err_vs_autograd=err_autograd,
                   tol=TOL * max(1.0, max(float(w.abs().max())
                                          for w in want)),
                   same_bits=same,
                   **float64_errors(f"ssm_scan_bwd {label}", got, want,
                                    exact))
        del got, want, exact
        n_bytes, partials, ops_ = ssm_bwd_work(b, s, di, n)
        bnd, by = ssm_bwd_bound_ms(b, s, di, n)
        row.update(
            ms=cuda_ms(lambda: ss.ssm_scan_bwd(*args[:5], h_chunks, dys)),
            fwd_chunks_ms=cuda_ms(lambda: ss.ssm_scan_fwd(*args)),
            fwd_ms=cuda_ms(lambda: ss.ssm_scan_fwd(*args, boundaries=False)),
            plain_ms=cuda_ms(lambda: ref.ssm_scan_bwd(*args[:5], h_chunks,
                                                      dys), reps=3, warmup=1),
            bound_ms=bnd, bound_by=by, library_ms=None, bytes=n_bytes,
            operations=ops_, partials_bytes=partials,
            bound_with_partials_ms=1e3 * (n_bytes + partials)
            / PEAK_HBM_BYTES,
            fwd_bound_ms=ssm_bound_ms(b, s, di, n)[0],
            exp_bound_ms=1e3 * 2 * b * s * di * n / SFU_EXP_PER_S)
        rows[label] = row
        print(f"ssm_scan_bwd_f32 {label}: " + json.dumps(row), flush=True)
        del args, dys, h_chunks
    torch.cuda.empty_cache()
    return rows


def check_hymba_grad(m, params) -> dict:
    """Phase n2: one gradient of hymba at full width on SyntheticStream's
    batch 0 at LM_TRAIN: the kernel route (no remat: flash with lse, the
    scan's forward and backward kernels; its launches counted from zero)
    twice, the same bits, and against the plain route
    (``use_fused=False``, ``remat=True``: the plain attention and the
    plain loop under autograd) from the same state: the loss within 1e-5
    relative, each leaf within 1e-3 of its norm; the peak memory of the
    kernel route's gradient."""
    batch0 = lm_train_batch(m, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    loss_k, g_k = TS.loss_and_grads(m, params, batch0)
    torch.cuda.synchronize()
    grads_ms = 1e3 * (time.perf_counter() - t0)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    n_ssm = sum(seg.repeats for seg in m.segments for sp in seg.pattern
                if sp.cfg.ssm_state)
    assert launches["flash_attention_f32 with lse"] == m.n_layers, launches
    assert launches["ssm_scan_f32"] == launches["ssm_scan_bwd_f32"] == \
        n_ssm, launches
    loss_2, g_2 = TS.loss_and_grads(m, params, batch0)
    same = bool(torch.equal(loss_k, loss_2)) and all(
        torch.equal(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                            tree_leaves(g_2)))
    assert same, "two backward passes of the kernel route differ"
    del g_2
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_p, g_p = TS.loss_and_grads(m, params, batch0, remat=True,
                                    use_fused=False)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    loss_k, loss_p = float(loss_k), float(loss_p)
    assert np.isfinite(loss_k), loss_k
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    errs = [_norm_err(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                              tree_leaves(g_p))]
    assert max(errs) <= 1e-3, f"gradient leaf {int(np.argmax(errs))}: " \
        f"{max(errs)} of its norm from the plain route's"
    out = dict(loss=loss_k, plain_loss=loss_p,
               max_grad_norm_err_vs_plain=max(errs), n_grad_leaves=len(errs),
               grads_same_bits_twice=same, launches=launches,
               remat=False, grads_ms=grads_ms,
               plain_grads_remat_ms=plain_ms,
               grads_max_memory_allocated_gb=peak / 1e9)
    print("hymba grad: " + json.dumps(out), flush=True)
    del g_k, g_p
    torch.cuda.empty_cache()
    return out


def check_hymba_train(m, params) -> dict:
    """Phase n3: ``make_train_step(remat=False)`` on hymba at full
    width, batch LM_TRAIN of SyntheticStream: one warm step and
    LM_TRAIN_STEPS timed ones (host clock ended by a synchronize), their
    launches counted from zero (a flash launch with lse an attention
    layer, a scan forward and a scan backward an SSM layer, a step), the
    peak memory, one more step profiled; the bound is
    ``lm_train_bound_ms`` (the scans' bounds in).  Updates `params` in
    place."""
    n_params = MB.param_count(params)
    step, optim = TS.make_train_step(m, remat=False)
    opt = optim.init(params)
    params, opt, met = step(params, opt, lm_train_batch(m, 0))   # warm
    losses = [float(met["loss"])]
    batches = [lm_train_batch(m, i) for i in range(1, LM_TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for b_ in batches[:LM_TRAIN_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, b_)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(met["loss"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(losses).all(), losses
    n_ssm = sum(seg.repeats for seg in m.segments for sp in seg.pattern
                if sp.cfg.ssm_state)
    for key, want in (("flash_attention_f32", m.n_layers),
                      ("flash_attention_f32 with lse", m.n_layers),
                      ("ssm_scan_f32", n_ssm), ("ssm_scan_bwd_f32", n_ssm)):
        assert launches[key] == want * LM_TRAIN_STEPS, (key, launches)
    ms = statistics.median(times)
    out = dict(
        arch=m.name, n_params=n_params, batch=list(LM_TRAIN),
        remat=False, losses=losses, step_ms=times,
        ms_per_step=ms, tokens_per_s=LM_TRAIN[0] * LM_TRAIN[1] / (ms / 1e3),
        bound_ms_per_step=lm_train_bound_ms(m, n_params),
        launches=launches,
        launches_per_step={k: v / LM_TRAIN_STEPS for k, v in launches.items()
                           if v},
        max_memory_allocated_gb=peak / 1e9,
        profile=profile_step(lambda: step(params, opt, batches[-1]), ()))
    out["device_launches_per_step"] = out["profile"]["device_launches"]
    print("hymba train: " + json.dumps(out), flush=True)
    del opt, batches
    torch.cuda.empty_cache()
    return out


def slstm_work(b: int, s: int, d: int, h: int) -> tuple:
    """Bytes the sLSTM kernel must move and its float32 operations
    (b·s·d·(8·dh + 36)): the kernel's own ``sl.work``."""
    ops_, n_bytes, _ = sl.work(b, s, d, h)
    return n_bytes, ops_


def slstm_bound_ms(b: int, s: int, d: int, h: int) -> tuple:
    """Least time of one sLSTM recurrence on this card: its bytes over HBM
    against its operations at the float32 SIMT peak (the S dependent
    steps' latency is not counted)."""
    return bound(*slstm_work(b, s, d, h))


def xlstm_model():
    """Phase o0: XLSTM_ARCH at full width, ``init_params(prng_key(0))`` on
    the card (timed), its bits held to the CPU's draw
    (`check_init_bits`)."""
    m = configs.get_arch(XLSTM_ARCH)
    params = init_lm(m, m.name)
    bits = check_init_bits(m, params)
    print(f"xlstm {m.name}: {MB.param_count(params)} params, {m.n_layers} "
          f"layers ({[sp.kind for sp in m.segments[0].pattern]} x "
          f"{m.segments[0].repeats}), init bits: {json.dumps(bits)}",
          flush=True)
    return m, params, dict(INIT_S[m.name], bits=bits)


def xlstm_layer(m, params, kind: str):
    """Layer 0 of the first stack of `kind` ("mlstm" or "slstm"): its
    params (views) and its spec."""
    for seg_p, seg in zip(params["segments"], m.segments):
        for sp, spec in zip(seg_p, seg.pattern):
            if spec.kind == kind:
                return MB._layer(sp, 0), spec
    raise ValueError(kind)


def slstm_inputs(m, params, shape, seed: int = 23) -> tuple:
    """The sLSTM kernel's inputs at `shape` (batch x seq) from layer 0 of
    the sLSTM stack: wx = x @ wx of a random (B, S, D) x at rms 1, its rh
    and bias, and the state the reference starts from; for one step (the
    Engine's shape) the state a 16-step plain run from it leaves."""
    b, s = shape
    p, _ = xlstm_layer(m, params, "slstm")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        state = XL.slstm_state_init(b, m.d_model, "cuda")
        if s == 1:
            warm = torch.randn(b, 16, m.d_model, generator=gen,
                               device="cuda") @ p["wx"]
            _, state = ref.slstm_scan(warm, p["rh"], p["b"], state)
        wx = torch.randn(b, s, m.d_model, generator=gen,
                         device="cuda") @ p["wx"]
    return wx, p["rh"], p["b"], state


def _flat(run) -> tuple:
    """(hs, c, n, m, h) of an sLSTM recurrence's (hs, state)."""
    return (run[0], *run[1])


def check_slstm_scan(m, params) -> dict:
    """Phase o1: the sLSTM kernel against its plain loop
    (``ref.slstm_scan``) on a layer's own weights at SLSTM_SHAPES: hs and
    the final state within TOL·scale, the same bits twice, no further
    from the float64 loop than 4x the plain float32 loop plus
    1e-6·scale; CUDA-event times of the kernel and the plain loop beside
    the bound (the plain loop's one call after the held one, which warms
    it).  No PyTorch call computes an sLSTM (library: none)."""
    h = m.segments[0].pattern[0].cfg.n_heads
    out = {}
    for label, (b, s) in SLSTM_SHAPES.items():
        args = slstm_inputs(m, params, (b, s))
        got, again = sl.slstm_scan(*args), sl.slstm_scan(*args)
        want = ref.slstm_scan(*args)
        exact = ref.slstm_scan(*(t.double() for t in args[:3]),
                               tuple(t.double() for t in args[3]))
        torch.cuda.synchronize()
        names = ("hs", "c", "n", "m", "h")
        row = dict(
            shape=[b, s, m.d_model, h],
            max_abs_err=max(_hold(f"slstm_scan {label} {n}", g, w)
                            for n, g, w in zip(names, _flat(got),
                                               _flat(want))),
            tol=TOL * max(1.0, float(want[0].abs().max())),
            same_bits=all(torch.equal(x, y) for x, y in zip(_flat(got),
                                                            _flat(again))))
        assert row["same_bits"], f"slstm_scan {label}: two calls differ"
        row.update(float64_errors(f"slstm_scan {label}", _flat(got),
                                  _flat(want), _flat(exact)))
        del got, again, want, exact
        bnd, by = slstm_bound_ms(b, s, m.d_model, h)
        n_bytes, ops_ = slstm_work(b, s, m.d_model, h)
        row.update(ms=cuda_ms(lambda: sl.slstm_scan(*args)),
                   plain_ms=cuda_ms(lambda: ref.slstm_scan(*args), reps=1,
                                    warmup=0),
                   bound_ms=bnd, bound_by=by, library_ms=None,
                   bytes=n_bytes, operations=ops_)
        row["us_per_step"] = 1e3 * row["ms"] / s
        out[label] = row
        print(f"slstm_scan_f32 {label}: " + json.dumps(row), flush=True)
    return out


def check_xlstm_layers(m, params, seed: int = 29) -> dict:
    """Phase o2: one mLSTM layer (chunkwise at PREFILL) and one sLSTM layer
    (the kernel and the plain loop) on a random (B, S, D) input at rms 1,
    against the same layers in float64: the mLSTM (no kernel) within
    TOL·scale of float64; the sLSTM's kernel route no further from
    float64 than 4x the plain loop plus 1e-6·scale, and within TOL·scale
    of it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*PREFILL, m.d_model, generator=gen, device="cuda")
    out = {}
    with torch.no_grad():
        for kind in ("mlstm", "slstm"):
            p, spec = xlstm_layer(m, params, kind)
            p64 = tree_map(lambda a: a.double(), p)
            heads = spec.cfg.n_heads
            if kind == "mlstm":
                got, _ = XL.mlstm_apply(p, x, heads)
                exact, _ = XL.mlstm_apply(p64, x.double(), heads)
                err = _err(got.double(), exact)
                scale = max(1.0, float(exact.abs().max()))
                assert err <= TOL * scale, f"mlstm layer: {err} from float64"
                out[kind] = dict(max_abs_err_f64=err, tol=TOL * scale)
            else:
                got, _ = XL.slstm_apply(p, x, heads)
                plain, _ = XL.slstm_apply(p, x, heads, use_fused=False)
                exact, _ = XL.slstm_apply(p64, x.double(), heads,
                                          use_fused=False)
                out[kind] = dict(
                    max_abs_err=_hold("slstm layer", got, plain),
                    **float64_errors("slstm layer", (got,), (plain,),
                                     (exact,)))
            del got, exact
    print("xlstm layers vs float64: " + json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def recorded_slstm(limit: int, skip: int = 0):
    """`limit` calls of ``nn/xlstm.slstm_apply`` on the kernel route, after
    the first `skip`, kept as (params, x, heads, state), x and the state
    copied (a decode step updates the state in place afterwards); each
    call then runs as ever."""
    apply, seen = XL.slstm_apply, []
    calls = [0]

    def rec(params, x, n_heads, state=None, use_fused=None):
        if use_fused is None:
            calls[0] += 1
            if skip < calls[0] <= skip + limit:
                seen.append((params, x.clone(), n_heads, None if state is None
                             else tuple(t.clone() for t in state)))
        return apply(params, x, n_heads, state=state, use_fused=use_fused)

    XL.slstm_apply = rec
    try:
        yield seen
    finally:
        XL.slstm_apply = apply


def check_slstm_calls(label: str, seen, f64_last: bool = False) -> list:
    """Each recorded sLSTM layer call again through the kernel and through
    the plain loop on its own input and state: the output and the final
    state within TOL·scale; with `f64_last` the last call also against
    the float64 loop (the kernel no further than 4x the plain loop plus
    1e-6·scale)."""
    rows = []
    for i, (p, x, heads, state) in enumerate(seen):
        with torch.no_grad():
            got = XL.slstm_apply(p, x, heads, state=state)
            want = XL.slstm_apply(p, x, heads, state=state, use_fused=False)
            flat_k, flat_p = (got[0], *got[1]), (want[0], *want[1])
            row = dict(x_rms=float(x.square().mean().sqrt()),
                       max_abs_err=max(
                           _hold(f"{label} sLSTM call {i} {n}", g, w)
                           for n, g, w in zip(("y", "c", "n", "m", "h"),
                                              flat_k, flat_p)))
            if f64_last and i == len(seen) - 1:
                exact = XL.slstm_apply(
                    tree_map(lambda a: a.double(), p), x.double(), heads,
                    state=None if state is None else tuple(
                        t.double() for t in state), use_fused=False)
                row.update(float64_errors(f"{label} sLSTM call {i}", flat_k,
                                          flat_p, (exact[0], *exact[1])))
        rows.append(row)
    return rows


def cut_config(m, repeats: int):
    """A one-segment model (mixtral, xlstm, qwen2-vl) cut to the first
    `repeats` repeats of its pattern at full width."""
    seg = m.segments[0]
    assert len(m.segments) == 1 and repeats <= seg.repeats, (m.segments,
                                                             repeats)
    return dataclasses.replace(m, segments=(dataclasses.replace(
        seg, repeats=repeats),))


def cut_repeats(m, params, repeats: int = 1):
    """`cut_config` and its params: the first `repeats` of each stack
    (views), the other leaves as they are."""
    return cut_config(m, repeats), dict(
        params, segments=[[tree_map(lambda a: a[:repeats], sp)
                           for sp in params["segments"][0]]])


def drive_xlstm_prefill(m, params) -> dict:
    """Phase o3: ``drive_prefill`` at `m`'s depth (an sLSTM launch a
    repeat and no flash launch asserted, timed, profiled).  Its last-token logits
    through the kernel and through the plain loop are reported, not
    held: at seed 0's random weights the residual stream grows ~4x a
    repeat of the pattern (0.02 to ~840 rms before the last sLSTM layer)
    and the float32 model's logits move by O(1) when its embedding moves
    by one ulp (`sensitivity`), so no two float32 routes agree there;
    both routes' distance from the float64 forward is reported beside
    it.  What is held: each of the prefill's sLSTM launches, again on
    its own recorded input, within TOL·scale of the plain loop (the last
    also against float64), and the prefill of the model cut to one
    repeat of the pattern (8 layers, where one ulp moves nothing) through
    both routes within TOL·scale."""
    n_sl = sum(seg.repeats for seg in m.segments for sp in seg.pattern
               if sp.kind == "slstm")
    logits = []
    with recorded_slstm(n_sl) as seen:
        out = drive_prefill(m, params, "xlstm prefill", hold_logits=False,
                            keep=logits, rounds=("kernel",))
    assert len(seen) == n_sl, len(seen)
    out["slstm_calls_vs_plain"] = check_slstm_calls("xlstm prefill", seen,
                                                    f64_last=True)
    del seen
    toks = prefill_tokens(m)
    got, want = (t.double() for t in logits)
    del logits
    with torch.no_grad():
        nudged = dict(params, embed={
            "table": params["embed"]["table"] * (1 + 2 ** -23)})
        moved = MB.forward(nudged, m, toks)[:, -1].double()
        del nudged
        p64 = tree_map(lambda a: a.double(), params)
        exact = MB.forward(p64, m, toks, use_fused=False)[:, -1]
        del p64
    torch.cuda.empty_cache()
    out["depth_logits"] = dict(
        max_abs_f64=float(exact.abs().max()),
        kernel_vs_f64=_err(got, exact), plain_vs_f64=_err(want, exact),
        kernel_vs_plain=_err(got, want),
        sensitivity=dict(what="kernel route, embedding x (1 + 2^-23)",
                         moved_logits_by=_err(moved, got)))
    cut, p1 = cut_repeats(m, params)
    with torch.no_grad():
        got = TS.make_prefill_step(cut)(p1, {"tokens": toks})
        want = TS.make_prefill_step(cut, use_fused=False)(p1,
                                                          {"tokens": toks})
    out["one_repeat"] = _logits_agree("xlstm prefill cut to one repeat",
                                      got, want)
    print("xlstm prefill checks: " + json.dumps(
        {k: out[k] for k in ("logits_vs_plain", "slstm_calls_vs_plain",
                             "depth_logits", "one_repeat")}),
          flush=True)
    return out


def engine_vs_prefill(m, params, run: dict, label: str, hold: bool
                      ) -> dict:
    """The Engine's decode logits over the first wave's prompts against
    the full-sequence forward at each position, and at the prompts' last
    tokens against ``make_prefill_step`` (both stepwise at 12 tokens), and
    its first new tokens against the prefill's argmax: held within
    TOL·scale where `hold`, else reported."""
    plen = SERVE["prompt_len"]
    first = torch.tensor(run["prompts"][:SERVE["slots"]], device="cuda")
    with torch.no_grad():
        full = MB.forward(params, m, first)
    want = TS.make_prefill_step(m)(params, {"tokens": first})
    assert len(run["steps"]) == plen, len(run["steps"])
    pairs = [(f"{label} decode step {st['clock']} vs the forward",
              st["logits"], full[:, st["clock"]]) for st in run["steps"]]
    pairs.append((f"{label} vs prefill logits",
                  run["steps"][plen - 1]["logits"], want))
    firsts = [r.out[0] for r in run["done"][:SERVE["slots"]]]
    if hold:
        errs = [_logits_agree(*pr) for pr in pairs]
        assert firsts == want.argmax(-1).tolist(), (firsts, want.argmax(-1))
    else:
        errs = [dict(max_abs_err=_err(g, w), tol=TOL * max(
            1.0, float(w.abs().max()))) for _, g, w in pairs]
    return dict(steps=plen, held=hold,
                decode_vs_forward_max_abs_err=max(
                    e["max_abs_err"] for e in errs[:-1]),
                engine_vs_prefill=errs[-1],
                first_tokens_equal_prefill_argmax=firsts == want.argmax(
                    -1).tolist())


def drive_xlstm_serve(m, params) -> dict:
    """Phase o4: the Engine serving SERVE's requests on xlstm-1.3b at
    `m`'s depth, its launches counted from zero (one sLSTM launch an sLSTM
    layer a decode step: the engine's steps and one more profiled; the
    mLSTM's one-token cell is eager torch), ms and launches a step.  Its
    decode logits are held to the stepwise forward and prefill step where
    the float32 model is well conditioned: on the model cut to one repeat
    of the pattern, served by a second Engine; at `m`'s depth they are
    reported (see `drive_xlstm_prefill`), and the sLSTM launches of the
    step at the prompts' last token are held, on their own recorded
    inputs and states, to the plain loop.  A step reads every weight (the tied head the whole
    table): the bound is the params' bytes over HBM."""
    plen = SERVE["prompt_len"]
    n_sl = sum(seg.repeats for seg in m.segments for sp in seg.pattern
               if sp.kind == "slstm")
    zero_counts()
    with recorded_slstm(n_sl, skip=n_sl * (plen - 1)) as seen:
        run = run_engine(m, params, plen)
    launches = counts()
    steps = run["stats"]["engine_iters"] + 1
    assert launches["slstm_scan_f32"] == n_sl * steps, (launches, steps)
    assert launches["flash_attention_f32"] == 0, launches
    calls = check_slstm_calls(f"xlstm engine step {plen - 1}", seen)
    del seen
    full = engine_vs_prefill(m, params, run, "xlstm engine", hold=False)
    cut, p1 = cut_repeats(m, params)
    cut_run = run_engine(cut, p1, plen)
    one = engine_vs_prefill(cut, p1, cut_run, "xlstm engine cut to one "
                            "repeat", hold=True)
    weight_bytes = 4 * MB.param_count(params)
    out = dict(run["stats"], launches=launches,
               slstm_launches_per_step=launches["slstm_scan_f32"] / steps,
               decode_launches_per_step=run["stats"]["decode_step_profile"][
                   "device_launches"],
               weights_read_gb=weight_bytes / 1e9,
               weights_read_ms=1e3 * weight_bytes / PEAK_HBM_BYTES,
               slstm_calls_vs_plain=calls, at_depth=full,
               one_repeat=dict(one, ms_per_decode_step=cut_run["stats"][
                   "ms_per_decode_step"]))
    print("xlstm serve: " + json.dumps(out), flush=True)
    return out


def slstm_bwd_work(b: int, s: int, d: int, h: int) -> tuple:
    """Bytes the sLSTM's backward (the kernel and its wrapper's d_rh and
    d_bias products) must move: wx, hs, dys, rh, bias, h0 and the (B,
    ⌈S/64⌉, D) chunk states (c, n, m) read once; d_wx, d_rh, d_bias and
    the initial state's four cotangents written once.  Its float32
    operations: the pre-activations again, the recurrent adjoint and
    d_rh, 2·dh for each of the 4 gate columns of each (b, t, channel)
    each, and ~80 pointwise around them (the forward's 36 again and the
    adjoint's ~44; a transcendental counted as one)."""
    dh = d // h
    nc = sl.n_chunks(s)
    n_bytes = 4 * (b * s * 4 * d + 2 * b * s * d + 2 * h * dh * 4 * dh
                   + 2 * 4 * d + b * d + 3 * b * nc * d + b * s * 4 * d
                   + 4 * b * d)
    return n_bytes, b * s * d * (3 * 8 * dh + 80)


def slstm_layer_input(m, params, shape, seed: int = 31) -> tuple:
    """The sLSTM recurrence's inputs as the model gives them at `shape`
    (batch x seq): the input the sLSTM layer records in the model cut to
    one repeat on SyntheticStream's batch `seed`, through its wx; its rh
    and bias; the reference's initial state."""
    cut, p1 = cut_repeats(m, params)
    toks = lm_train_batch(cut, seed, shape)["tokens"]
    with recorded_slstm(1) as seen, torch.no_grad():
        MB.forward(p1, cut, toks)
        p, x, _, _ = seen[0]
        wx = (x @ p["wx"]).float()
    state = XL.slstm_state_init(shape[0], m.d_model, "cuda")
    return wx, p["rh"], p["b"], state


def check_slstm_bwd(m, params) -> dict:
    """Phase p1: the sLSTM's backward kernel (``slstm_scan_bwd_f32``) at
    SLSTM_BWD_SHAPES on an sLSTM layer's recorded input and a random dys
    (the final state's cotangents None, as in the model), from the
    forward kernel's chunk states (held to the plain loop's): within
    TOL·scale of its plain version (``ref.slstm_scan_bwd`` on the plain
    loop's chunk states) and of torch's autograd of the plain loop, the
    same bits twice, no further from a float64 autograd of the plain loop
    than 4x the plain float32 autograd's error plus 1e-6·scale.
    CUDA-event medians of the backward (the kernel and its d_rh / d_bias
    products), of the products alone (the kernel's time is the
    difference), of the forward with and without its chunk states, and
    the host time of the plain adjoint loop's one call (the held one),
    beside the bound.  No PyTorch call
    computes an sLSTM's backward (library: none)."""
    rows = {}
    heads = m.segments[0].pattern[-1].cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(37)
    names = ("d_wx", "d_rh", "d_bias", "dc0", "dn0", "dm0", "dh0")
    for label, shape in SLSTM_BWD_SHAPES.items():
        wx, rh, bias, state = slstm_layer_input(m, params, shape)
        b, s, d = shape[0], shape[1], m.d_model
        dys = torch.randn(b, s, d, generator=gen, device="cuda")
        hs, fin, chunks = sl.slstm_scan_fwd(wx, rh, bias, state)
        p_hs, _, p_chunks = ref.slstm_scan(wx, rh, bias, state,
                                           boundaries=True)
        chunk_err = max(_hold(f"slstm chunk states {label} {n}", g, w)
                        for n, g, w in zip("cnm", chunks, p_chunks))
        got = sl.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys)
        again = sl.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        assert same, f"slstm_scan_bwd {label}: two calls differ"
        del again
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ref.slstm_scan_bwd(wx, rh, bias, state, p_hs, p_chunks, dys)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        err = max(_hold(f"slstm_scan_bwd {label} {n} vs its plain version",
                        x, y) for n, x, y in zip(names, got, plain))
        del plain, p_hs, p_chunks

        def autograd(dtype):
            return _vjp(lambda *t: ref.slstm_scan(*t[:3], t[3:])[0],
                        [t.to(dtype) for t in (wx, rh, bias, *state)],
                        dys.to(dtype))[1:]

        want = autograd(torch.float32)
        err_autograd = max(_hold(f"slstm_scan_bwd {label} {n} vs autograd",
                                 x, y) for n, x, y in zip(names, got, want))
        exact = autograd(torch.float64)
        row = dict(shape=[b, s, d, heads], max_abs_err=err,
                   max_abs_err_vs_autograd=err_autograd,
                   chunk_states_max_abs_err=chunk_err,
                   tol=TOL * max(1.0, max(float(w.abs().max())
                                          for w in want)),
                   same_bits=same,
                   **float64_errors(f"slstm_scan_bwd {label}", got, want,
                                    exact))
        del got, want, exact
        n_bytes, ops_ = slstm_bwd_work(b, s, d, heads)
        bnd, by = bound(n_bytes, ops_)

        def bwd():
            return sl.slstm_scan_bwd(wx, rh, bias, state, hs, chunks, dys)

        row.update(
            ms=cuda_ms(bwd, reps=10),
            weight_grads_ms=cuda_ms(lambda: ref.slstm_weight_grads(
                state[3], hs, wx, heads)),
            fwd_chunks_ms=cuda_ms(lambda: sl.slstm_scan_fwd(
                wx, rh, bias, state), reps=10),
            fwd_ms=cuda_ms(lambda: sl.slstm_scan_fwd(
                wx, rh, bias, state, boundaries=False), reps=10),
            plain_ms=plain_ms,
            bound_ms=bnd, bound_by=by, library_ms=None, bytes=n_bytes,
            operations=ops_,
            kernel_bound_ms=bound(n_bytes, ops_ - b * s * d * 8 * (
                d // heads))[0],
            fwd_bound_ms=slstm_bound_ms(b, s, d, heads)[0])
        row["us_per_step"] = 1e3 * row["ms"] / s
        row["kernel_ms_by_difference"] = row["ms"] - row["weight_grads_ms"]
        rows[label] = row
        print(f"slstm_scan_bwd_f32 {label}: " + json.dumps(row), flush=True)
        del wx, dys, hs, chunks
    torch.cuda.empty_cache()
    return rows


def _loss_grads_f64(m, params, batch) -> tuple:
    """The loss and gradients of ``next_token_loss`` in float64 through
    the plain loop (float64 params, float64 logits and loss), remat on;
    an encoder-decoder encodes ``batch["frames"]`` first, in float64."""
    p64 = tree_map(lambda a: a.double(), params)
    live = [t.requires_grad_(True) for t in tree_leaves(p64)]
    tree = tree_unflatten(p64, live)
    enc = None if m.enc_segments is None else MB.encode(
        tree, m, batch["frames"].double(), use_fused=False, remat=True)
    logits = MB.forward(tree, m, batch["tokens"],
                        positions=batch.get("positions"), use_fused=False,
                        remat=True, enc_out=enc)
    logz = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
    loss = (logz - gold).mean()
    del logits, logz, gold
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), list(grads)


def check_xlstm_grad(m, params) -> dict:
    """Phase p2: one gradient of xlstm cut to one repeat of its pattern (7
    mLSTM layers and an sLSTM layer at full width, where the float32
    model is well conditioned) on SyntheticStream's batch 0 at LM_TRAIN,
    remat on: the kernel route (``SLSTMScanFn``: 2 forward launches and 1
    backward, asserted; its launches counted from zero) twice, the same
    bits, and against the plain route (``use_fused=False``: torch's
    autograd of the plain loop) from the same state: the loss within 1e-5
    relative, each leaf within 1e-3 of max(its norm, 1e-6 x the whole
    gradient's norm) (the mLSTM's b_i and the sLSTM's i-gate bias are
    zero up to rounding: a constant on the input gate shifts c, n and m
    together); both routes against a float64 gradient, the kernel route's
    largest leaf error (by the same measure) at most twice the plain
    route's."""
    cut, p1 = cut_repeats(m, params)
    batch0 = lm_train_batch(cut, 0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    loss_k, g_k = TS.loss_and_grads(cut, p1, batch0, remat=True)
    torch.cuda.synchronize()
    grads_ms = 1e3 * (time.perf_counter() - t0)
    launches = counts()
    assert launches["slstm_scan_f32"] == 2 and \
        launches["slstm_scan_bwd_f32"] == 1, launches
    loss_2, g_2 = TS.loss_and_grads(cut, p1, batch0, remat=True)
    same = bool(torch.equal(loss_k, loss_2)) and all(
        torch.equal(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                            tree_leaves(g_2)))
    assert same, "two gradients of the kernel route differ"
    del g_2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_p, g_p = TS.loss_and_grads(cut, p1, batch0, remat=True,
                                    use_fused=False)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    g_k, g_p = tree_leaves(g_k), tree_leaves(g_p)
    loss_k, loss_p = float(loss_k), float(loss_p)
    assert np.isfinite(loss_k), loss_k
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    total = float(torch.stack([g.norm() for g in g_p]).norm())

    def errs(got, want, norm):
        return [float((a - w).norm()) / max(float(w.norm()), 1e-6 * norm)
                for a, w in zip(got, want)]

    vs_plain = errs(g_k, g_p, total)
    assert max(vs_plain) <= 1e-3, f"gradient leaf {int(np.argmax(vs_plain))}" \
        f": {max(vs_plain)} of its norm from the plain route's"
    loss_64, g_64 = _loss_grads_f64(cut, p1, batch0)
    total_64 = float(torch.stack([g.norm() for g in g_64]).norm())
    k64 = errs((g.double() for g in g_k), g_64, total_64)
    p64 = errs((g.double() for g in g_p), g_64, total_64)
    assert max(k64) <= 2 * max(p64), (max(k64), max(p64))
    out = dict(layers=cut.n_layers, batch=list(LM_TRAIN), loss=loss_k,
               plain_loss=loss_p, float64_loss=float(loss_64),
               max_grad_norm_err_vs_plain=max(vs_plain),
               max_grad_norm_err_f64=max(k64),
               plain_max_grad_norm_err_f64=max(p64),
               n_grad_leaves=len(vs_plain), grads_same_bits_twice=same,
               launches=launches, remat=True, grads_ms=grads_ms,
               plain_grads_ms=plain_ms)
    print("xlstm grad: " + json.dumps(out), flush=True)
    del g_k, g_p, g_64
    torch.cuda.empty_cache()
    return out


def xlstm_train_bound_ms(m, n_params: int, remat: bool) -> float:
    """Least time of an xlstm train step at the float32 peak (67 TFLOP/s,
    TF32 off): 6·N·tokens and the mLSTM chunks' products three times
    (forward, backward's two), plus one more forward for remat (no
    attention; the sLSTM's recurrent products are rh's share of N)."""
    b, s = LM_TRAIN
    chunks = sum(seg.repeats * xlstm_flops(sp, b, s)["mlstm_chunks"]
                 for seg in m.segments for sp in seg.pattern
                 if sp.kind == "mlstm")
    passes = 4 if remat else 3
    return 1e3 * (passes * (2 * n_params * b * s + chunks)
                  ) / PEAK_F32_FLOPS


def grad_norms(grads) -> dict:
    """The gradient's global norm as the clip reads it (``global_norm``:
    squares summed in float32, the reference's), in float64, and whether
    every element is finite."""
    leaves = tree_leaves(grads)
    return dict(f32=float(global_norm(grads)),
                f64=float(torch.stack([g.double().norm()
                                       for g in leaves]).norm()),
                elements_finite=all(bool(torch.isfinite(g).all())
                                    for g in leaves))


def check_xlstm_train(m, params) -> dict:
    """Phase p3: xlstm-1.3b's ``make_train_step`` on its first
    XLSTM_TRAIN_REPEATS repeats (`cut_repeats`), batch LM_TRAIN of
    SyntheticStream, remat XLSTM_TRAIN_REMAT: one warm step
    (timed, its peak memory), then XLSTM_TRAIN_STEPS timed ones (host
    clock ended by a synchronize), their launches counted from zero (an
    sLSTM layer's backward once and its forward once, twice with remat, a
    step), each step's loss and every gradient element finite (its norms,
    ``grad_norms``, read by the ``grad_compress`` hook, which returns the
    gradients as they are), the peak memory, one more step profiled.
    Where the warm step's float32 norm (the clip's) is not finite, the
    plain route's gradient (``use_fused=False``, remat) from the same
    state and batch too: the same overflow there is the reference's math
    (ROADMAP Queue 3 item 5), not the kernels'.  Updates `params` in
    place."""
    of = m.n_layers
    m, params = cut_repeats(m, params, XLSTM_TRAIN_REPEATS)
    n_params = MB.param_count(params)
    n_sl = sum(seg.repeats for seg in m.segments for sp in seg.pattern
               if sp.kind == "slstm")
    batches = [lm_train_batch(m, i) for i in range(XLSTM_TRAIN_STEPS + 2)]
    start = tree_map(torch.clone, params)
    norms = []

    def record_norm(grads):
        norms.append(grad_norms(grads))
        return grads

    step, optim = TS.make_train_step(m, remat=XLSTM_TRAIN_REMAT,
                                     grad_compress=record_norm)
    opt = optim.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, met = step(params, opt, batches[0])          # warm
    torch.cuda.synchronize()
    warm = dict(ms=1e3 * (time.perf_counter() - t0), loss=float(met["loss"]),
                norms=norms[0],
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9)
    if not np.isfinite(warm["norms"]["f32"]):
        t0 = time.perf_counter()
        loss, grads = TS.loss_and_grads(m, start, batches[0], remat=True,
                                        use_fused=False)
        torch.cuda.synchronize()
        warm["plain_route"] = dict(
            grads_ms=1e3 * (time.perf_counter() - t0), loss=float(loss),
            norms=grad_norms(grads))
        del grads
        assert not np.isfinite(warm["plain_route"]["norms"]["f32"]), \
            ("the kernel route's gradient norm overflows, the plain "
             "route's does not", warm)
    del start
    gc.collect()
    torch.cuda.empty_cache()
    losses = [warm["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for b_ in batches[1:XLSTM_TRAIN_STEPS + 1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, b_)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(met["loss"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    assert np.isfinite(losses).all() and all(
        n["elements_finite"] for n in norms), (losses, norms)
    fwd = n_sl * (2 if XLSTM_TRAIN_REMAT else 1)
    assert launches["slstm_scan_f32"] == fwd * XLSTM_TRAIN_STEPS, launches
    assert launches["slstm_scan_bwd_f32"] == n_sl * XLSTM_TRAIN_STEPS, \
        launches
    ms = statistics.median(times)
    out = dict(
        arch=m.name, n_params=n_params, batch=list(LM_TRAIN),
        reduced=dict(n_layers=m.n_layers, of=of,
                     why="the script's time limit"),
        remat=XLSTM_TRAIN_REMAT, losses=losses, grad_norms=norms,
        clip_norm_finite=all(np.isfinite(n["f32"]) for n in norms),
        warm_step=warm, step_ms=times, ms_per_step=ms,
        tokens_per_s=LM_TRAIN[0] * LM_TRAIN[1] / (ms / 1e3),
        bound_ms_per_step=xlstm_train_bound_ms(
            m, n_params, XLSTM_TRAIN_REMAT),
        launches=launches,
        launches_per_step={k: v / XLSTM_TRAIN_STEPS
                           for k, v in launches.items() if v},
        max_memory_allocated_gb=peak / 1e9)
    t0 = time.perf_counter()
    out["profile"] = profile_step(lambda: step(params, opt, batches[-1]), ())
    out["profile_s"] = time.perf_counter() - t0
    out["device_launches_per_step"] = out["profile"]["device_launches"]
    print("xlstm train: " + json.dumps(out), flush=True)
    del opt, batches
    torch.cuda.empty_cache()
    return out


def whisper_frames(m, seed: int = 0):
    """WHISPER_BATCH 30 s windows of stub frame embeddings (B,
    ``max_enc_len`` = 1500, D), ``normal · 0.1`` from `seed`, on the
    card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(WHISPER_BATCH, m.max_enc_len, m.d_model, generator=g,
                       device="cuda") * 0.1


def whisper_model():
    """Phase q0: WHISPER_ARCH at full width, ``init_params(prng_key(0))``
    on the card (timed), its bits held to the CPU's draw
    (`check_init_bits`: the decoder's and the encoder's layer 0, the
    embedding and ``pos_embed``)."""
    m = configs.get_arch(WHISPER_ARCH)
    params = init_lm(m, m.name)
    bits = check_init_bits(m, params)
    print(f"whisper {m.name}: {MB.param_count(params)} params, "
          f"{sum(s.n_layers for s in m.enc_segments)} + {m.n_layers} "
          f"layers, init bits: {json.dumps(bits)}", flush=True)
    return m, params, dict(INIT_S[m.name], bits=bits)


def whisper_layers(m) -> tuple:
    """(encoder layers, decoder layers)."""
    return (sum(s.n_layers for s in m.enc_segments), m.n_layers)


def whisper_flops(m, b: int, s_enc: int, s_dec: int,
                  encoder: bool = True) -> dict:
    """Flops of a whisper forward's parts as computed (each product
    2·M·K·N): the encoder's projections (wq, wkv, wo, the GEGLU's three;
    with ``encoder=False`` none, as at decode), the decoder's (the self-
    and cross-attention's wq and wo, the self-attention's wkv, the
    GEGLU's), the cross-attention's K/V (``enc_out @ wkv`` in every
    decoder layer, over all S_enc frames), the tied logits, and the flash
    kernel's 4·D a kept (query, key) pair (the encoder's all pairs, the
    decoder's causal ones, the cross-attention's all S_dec x S_enc)."""
    c = m.segments[0].pattern[0].cfg
    n_enc, n_dec = whisper_layers(m)
    d, qd, kvd = c.d_model, c.n_heads * c.dh, c.n_kv * c.dh
    attn_ffn = 2 * d * (qd + 2 * kvd + qd + 3 * c.d_ff)   # a token's
    per_pair = 4 * c.dh * b * c.n_heads
    out = {"encoder_projections": 0.0,
           "decoder_projections": n_dec * b * s_dec * (attn_ffn + 4 * d * qd),
           "cross_kv": n_dec * 2 * b * s_enc * d * 2 * kvd,
           "logits": 2 * b * s_dec * d * m.vocab,
           "flash": per_pair * n_dec * (
               kept_pairs(s_dec, s_dec, True, None, 0) + s_dec * s_enc)}
    if encoder:
        out["encoder_projections"] = n_enc * b * s_enc * attn_ffn
        out["flash"] += per_pair * n_enc * s_enc * s_enc
    return out


def whisper_bound_ms(flops: dict) -> dict:
    """Least time of each part: the products at the float32 SIMT peak (67
    TFLOP/s, TF32 off: cuBLAS SGEMM), flash at three TF32 products at 495
    TFLOP/s (its 3xTF32), as ``flash_bound_ms`` counts it."""
    return {k: 1e3 * (3 * v / PEAK_TF32_FLOPS if k == "flash"
                      else v / PEAK_F32_FLOPS) for k, v in flops.items()}


def check_flash_at(shapes: dict, grad_shapes: dict) -> dict:
    """`flash_row` with and without lse at each of `shapes`, float32, and
    `flash_grad_row` at each of `grad_shapes`."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    rows = {}
    for label, shape in shapes.items():
        b, h, hkv, sq, sk, d = shape[:6]
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, hkv, sk, d, generator=gen, device="cuda")
                for _ in range(2))
        rows[label] = flash_row(label, shape, q, k, v, torch.float32, TOL,
                                lse=True)
        del q, k, v
    grads = {label: flash_grad_row(label, shape, gen)
             for label, shape in grad_shapes.items()}
    torch.cuda.empty_cache()
    return dict(forward=rows, grad=grads)


def drive_whisper_serve(m, params) -> dict:
    """Phase q2: serving whisper at full width on WHISPER_BATCH windows.
    ``encode`` through the kernel (one flash launch an encoder layer,
    counted from zero) and the plain attention, within TOL·scale;
    ``make_prefill_step`` on the frames and a WHISPER_PROMPT-token prompt
    (one launch an encoder layer and two a decoder layer), its last
    logits against the plain route's; then ``make_decode_step`` from one
    ``encode`` (counts zeroed just before): a KV cache of
    DECODER_TRAIN_LEN, the prompt fed a token a step, then WHISPER_NEW
    greedy steps, one cross-attention launch a decoder layer a step.
    Held: the decode logits at the prompt's positions to a
    teacher-forced ``forward``, and the first WHISPER_TEACHER steps to
    the plain route's decode (`plain_flash`, its own plain ``encode``) on
    the kernel route's tokens.  Host-clock ms of encode, prefill (both
    routes) and a decode step, beside their bounds; a prefill and a
    decode step profiled."""
    b, n_prompt = WHISPER_BATCH, WHISPER_PROMPT
    n_enc, n_dec = whisper_layers(m)
    frames = whisper_frames(m)
    prompt = torch.randint(0, m.vocab, (b, n_prompt), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    batch = {"frames": frames, "tokens": prompt}
    out = {}
    with torch.no_grad():
        zero_counts()
        enc = MB.encode(params, m, frames)
        torch.cuda.synchronize()
        launches = counts()
        assert launches["flash_attention_f32"] == n_enc, launches
        enc_plain = MB.encode(params, m, frames, use_fused=False)
        out["encode"] = dict(
            launches=launches,
            max_abs_err=_hold("whisper encode", enc, enc_plain),
            max_abs=float(enc_plain.abs().max()),
            ms=host_ms(lambda: MB.encode(params, m, frames)),
            plain_ms=host_ms(lambda: MB.encode(params, m, frames,
                                               use_fused=False), reps=1))
    s_enc = frames.shape[1]
    out["encode"]["bound_ms"] = whisper_bound_ms({   # no decoder tokens
        k: v for k, v in whisper_flops(m, b, s_enc, 0).items()
        if k in ("encoder_projections", "flash")})
    print("whisper encode: " + json.dumps(out["encode"]), flush=True)

    routes = {"kernel": TS.make_prefill_step(m),
              "plain": TS.make_prefill_step(m, use_fused=False)}
    zero_counts()
    got = routes["kernel"](params, batch)
    torch.cuda.synchronize()
    launches = counts()
    assert launches["flash_attention_f32"] == n_enc + 2 * n_dec, launches
    want = routes["plain"](params, batch)
    pre = dict(launches=launches,
               **_logits_agree("whisper prefill logits", got, want))
    del got, want
    for r in routes:
        pre[f"{r}_ms_per_prefill"] = host_ms(
            lambda: routes[r](params, batch), reps=2 if r == "kernel" else 1)
    pre["bound_ms"] = whisper_bound_ms(whisper_flops(m, b, s_enc, n_prompt))
    pre["bound_ms_per_prefill"] = sum(pre["bound_ms"].values())
    pre["frames_per_s"] = b * s_enc / (pre["kernel_ms_per_prefill"] / 1e3)
    pre["profile"] = profile_step(lambda: routes["kernel"](params, batch), ())
    out["prefill"] = pre
    print("whisper prefill: " + json.dumps(pre), flush=True)

    dec = TS.make_decode_step(m)
    states = MB.init_decode_state(params, m, b, DECODER_TRAIN_LEN)
    toks = [prompt[:, t:t + 1] for t in range(n_prompt)]
    kept, times = [], []
    zero_counts()
    for t in range(n_prompt + WHISPER_NEW):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, states = dec(params, toks[t], t, states, enc)
        nxt = logits[:, 0].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if t < max(WHISPER_TEACHER, n_prompt):
            kept.append(logits[:, 0].clone())
        if t + 1 >= n_prompt:
            toks.append(nxt)
    launches = counts()
    steps = n_prompt + WHISPER_NEW
    assert launches["flash_attention_f32"] == n_dec * steps, launches
    with torch.no_grad():
        full = MB.forward(params, m, prompt, enc_out=enc)
    vs_forward = max(_hold(f"whisper decode step {t} vs forward",
                           kept[t], full[:, t]) for t in range(n_prompt))
    del full
    st_p = MB.init_decode_state(params, m, b, DECODER_TRAIN_LEN)
    vs_plain = []
    with plain_flash():
        for t in range(WHISPER_TEACHER):
            lp, st_p = dec(params, toks[t], t, st_p, enc_plain)
            vs_plain.append(_hold(f"whisper decode step {t} vs plain",
                                  kept[t], lp[:, 0]))
    del st_p, kept
    weights = 4 * sum(t.numel() for k, v in params.items()
                      if k != "encoder" for t in tree_leaves(v))
    dflops = whisper_flops(m, b, s_enc, 1, encoder=False)
    ds = dict(
        launches=launches, steps=steps,
        flash_launches_per_step=launches["flash_attention_f32"] / steps,
        max_abs_err_vs_forward=vs_forward,
        max_abs_err_vs_plain_teacher_forced=max(vs_plain),
        ms_per_decode_step=statistics.median(times[n_prompt:]),
        step_ms_min_max=[min(times), max(times)],
        new_tok_per_s=b * WHISPER_NEW / (sum(times[n_prompt:]) / 1e3),
        bound_ms=whisper_bound_ms(dflops),
        weights_and_enc_out_read_ms=1e3 * (weights + 4 * n_dec * enc.numel())
        / PEAK_HBM_BYTES,
        cross_kv_share_of_bound=dflops["cross_kv"] / sum(
            v for k, v in dflops.items() if k != "flash"),
        profile=profile_step(lambda: dec(params, toks[0], steps, states,
                                         enc), ()))
    ds["bound_ms_per_step"] = sum(ds["bound_ms"].values())
    out["decode"] = ds
    print("whisper decode: " + json.dumps(ds), flush=True)
    del enc, enc_plain, states
    torch.cuda.empty_cache()
    return out


def whisper_train_batch(m, step: int) -> dict:
    """Step `step`: WHISPER_BATCH windows of frames (seed 100 + step) and
    SyntheticStream's (seed 0) tokens and labels at DECODER_TRAIN_LEN."""
    toks, labels = SyntheticStream(DataConfig(
        vocab=m.vocab, seq_len=DECODER_TRAIN_LEN, global_batch=WHISPER_BATCH,
        seed=0)).batch(step)
    return {"frames": whisper_frames(m, seed=100 + step),
            "tokens": torch.from_numpy(toks).to("cuda", torch.long),
            "labels": torch.from_numpy(labels).to("cuda", torch.long)}


def whisper_cut(m, params, n: int = WHISPER_CUT_LAYERS):
    """The model cut to `n` encoder and `n` decoder layers at full width,
    and its params: views of the first `n` of each stack."""
    def cut(segs):
        return tuple(dataclasses.replace(sg, repeats=n) for sg in segs)

    def first(segments_params):
        return [[tree_map(lambda a: a[:n], sp) for sp in seg]
                for seg in segments_params]

    mc = dataclasses.replace(m, segments=cut(m.segments),
                             enc_segments=cut(m.enc_segments))
    pc = dict(params, segments=first(params["segments"]),
              encoder=dict(params["encoder"], segments=first(
                  params["encoder"]["segments"])))
    return mc, pc


def check_whisper_grad(m, params) -> dict:
    """Phase q3a: one gradient of whisper at full depth on
    `whisper_train_batch` 0, no remat: the kernel route (36 flash launches
    with lse, asserted) against the plain route (``use_fused=False``,
    remat): the loss within 1e-5 relative, each leaf within 1e-3 of its
    norm; its peak memory.  Then the model cut to WHISPER_CUT_LAYERS
    encoder and decoder layers: both routes against a float64 gradient
    (`float64_block`), the kernel route's largest leaf error (of the
    leaf's norm) at most twice the plain route's."""
    n_enc, n_dec = whisper_layers(m)
    batch = whisper_train_batch(m, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    loss_k, g_k = TS.loss_and_grads(m, params, batch)
    torch.cuda.synchronize()
    grads_ms = 1e3 * (time.perf_counter() - t0)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    assert launches["flash_attention_f32 with lse"] == n_enc + 2 * n_dec, \
        launches
    t0 = time.perf_counter()
    loss_p, g_p = TS.loss_and_grads(m, params, batch, remat=True,
                                    use_fused=False)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    loss_k, loss_p = float(loss_k), float(loss_p)
    assert np.isfinite(loss_k), loss_k
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), (loss_k, loss_p)
    errs = [_norm_err(a, b_) for a, b_ in zip(tree_leaves(g_k),
                                              tree_leaves(g_p))]
    assert max(errs) <= 1e-3, f"gradient leaf {int(np.argmax(errs))}: " \
        f"{max(errs)} of its norm from the plain route's"
    out = dict(loss=loss_k, plain_loss=loss_p,
               max_grad_norm_err_vs_plain=max(errs), n_grad_leaves=len(errs),
               launches=launches, remat=False, grads_ms=grads_ms,
               plain_grads_remat_ms=plain_ms,
               grads_max_memory_allocated_gb=peak / 1e9)
    del g_k, g_p
    torch.cuda.empty_cache()
    mc, pc = whisper_cut(m, params)
    _, g_k = TS.loss_and_grads(mc, pc, batch)
    _, g_p = TS.loss_and_grads(mc, pc, batch, use_fused=False)
    with float64_block():
        loss_64, g_64 = _loss_grads_f64(mc, pc, batch)
    k64 = [_norm_err(a, w) for a, w in zip(tree_leaves(g_k), g_64)]
    p64 = [_norm_err(a, w) for a, w in zip(tree_leaves(g_p), g_64)]
    assert max(k64) <= 2 * max(p64), (max(k64), max(p64))
    out["cut"] = dict(layers=[WHISPER_CUT_LAYERS] * 2,
                      float64_loss=float(loss_64),
                      max_grad_norm_err_f64=max(k64),
                      plain_max_grad_norm_err_f64=max(p64))
    print("whisper grad: " + json.dumps(out), flush=True)
    del g_k, g_p, g_64
    torch.cuda.empty_cache()
    return out


def check_whisper_train(m, params) -> dict:
    """Phase q3b: ``make_train_step(remat=False)`` at full depth on
    `whisper_train_batch`: one warm step and LM_TRAIN_STEPS timed (host
    clock ended by a synchronize), their launches counted from zero (36
    flash launches a step, all with lse: 12 encoder, 12 decoder
    self-attention, 12 cross-attention), decoder tokens/s and frames/s,
    the bound (3x the forward's products at 67 TFLOP/s plus attention's
    12·D flops a kept pair and head, as ``lm_train_bound_ms``), the peak
    memory, one more step profiled.  Updates `params` in place."""
    n_enc, n_dec = whisper_layers(m)
    n_params = MB.param_count(params)
    step, optim = TS.make_train_step(m, remat=False)
    batches = [whisper_train_batch(m, i)
               for i in range(1, LM_TRAIN_STEPS + 2)]
    per_step = n_enc + 2 * n_dec
    params, opt, run = timed_train_steps(
        step, params, optim.init(params), whisper_train_batch(m, 0),
        batches[:LM_TRAIN_STEPS], per_step)
    flops = whisper_flops(m, WHISPER_BATCH, m.max_enc_len, DECODER_TRAIN_LEN)
    gemm = sum(v for k, v in flops.items() if k != "flash")
    bound = 1e3 * (3 * gemm + 3 * flops["flash"]) / PEAK_F32_FLOPS
    ms = run["ms_per_step"]
    out = dict(
        run, arch=m.name, n_params=n_params, batch=WHISPER_BATCH,
        frames=m.max_enc_len, decoder_tokens=DECODER_TRAIN_LEN, remat=False,
        decoder_tokens_per_s=WHISPER_BATCH * DECODER_TRAIN_LEN / (ms / 1e3),
        frames_per_s=WHISPER_BATCH * m.max_enc_len / (ms / 1e3),
        bound_ms_per_step=bound, forward_tflop=sum(flops.values()) / 1e12,
        flash_launches_per_step=per_step,
        profile=profile_step(lambda: step(params, opt, batches[-1]), ()))
    out["device_launches_per_step"] = out["profile"]["device_launches"]
    print("whisper train: " + json.dumps(out), flush=True)
    del opt, batches
    torch.cuda.empty_cache()
    return out


def qwen_model():
    """Phase r2a: QWEN_ARCH at full width, ``init_params(prng_key(0))`` on
    the card (timed), QWEN_PARAMS params, its bits held to the CPU's
    draw (`check_init_bits`)."""
    m = configs.get_arch(QWEN_ARCH)
    params = init_lm(m, m.name)
    n = MB.param_count(params)
    assert n == QWEN_PARAMS, n
    bits = check_init_bits(m, params)
    print(f"qwen {m.name}: {n} params, {m.n_layers} layers, M-RoPE "
          f"{m.segments[0].pattern[0].cfg.mrope_sections}, init bits: "
          f"{json.dumps(bits)}", flush=True)
    return m, params, dict(INIT_S[m.name], bits=bits)


def qwen_positions(b: int, s: int, layout=None):
    """(3, b, s) M-RoPE positions of `layout` (QWEN_VISION) on the card."""
    return vision_positions(b, s, device="cuda", **(layout or QWEN_VISION))


def qwen_train_batch(m, step: int, shape=None, layout=None) -> dict:
    """`lm_train_batch` at `shape` (LM_TRAIN) with `layout`'s (3, B, S)
    positions."""
    shape = shape or LM_TRAIN
    return dict(lm_train_batch(m, step, shape),
                positions=qwen_positions(*shape, layout))


def check_qwen_train(mc, pc, of: int) -> dict:
    """Phase r4 on the model cut to QWEN_TRAIN_LAYERS of `of` layers,
    batch LM_TRAIN with QWEN_VISION's positions: layer 0's block against
    float64; one gradient through the kernels (a flash launch with lse a
    layer, asserted) against the plain route (``use_fused=False``, remat):
    the loss within 1e-5 relative, each leaf within 1e-3 of its norm;
    the model cut to one layer at QWEN_F64_BATCH against float64, the
    kernel route within twice the plain route's error;
    ``make_train_step`` (no remat): one warm step and LM_TRAIN_STEPS timed
    (host clock ended by a synchronize), a flash launch with lse a layer
    and step, tokens/s beside ``lm_train_bound_ms``, the peak memory, a
    profiled step; then one step in 2 microbatches (two launches with lse
    a layer), its loss within 1e-5 of ``loss_and_grads``' on the same
    params and batch.  Updates `pc` in place."""
    n_layers = mc.n_layers
    n_params = MB.param_count(pc)
    batch0 = qwen_train_batch(mc, 0)
    out = dict(arch=mc.name, reduced=dict(
        n_layers=n_layers, of=of, why="params, gradients and Adam's "
        "moments of the full depth come to ~122 GB"),
        n_params=n_params, batch=list(LM_TRAIN), vision=QWEN_VISION,
        block=check_lm_block(mc, pc, batch0))
    print(f"qwen train block: {json.dumps(out['block'])}", flush=True)

    out.update(grads_vs_plain(mc, pc, batch0))

    m1, p1 = cut_repeats(mc, pc, 1)
    b64 = qwen_train_batch(m1, 0, QWEN_F64_BATCH, QWEN_F64_VISION)
    _, g_k = TS.loss_and_grads(m1, p1, b64)
    _, g_p = TS.loss_and_grads(m1, p1, b64, use_fused=False)
    with float64_block():
        loss_64, g_64 = _loss_grads_f64(m1, p1, b64)
    k64 = [_norm_err(a, w) for a, w in zip(tree_leaves(g_k), g_64)]
    p64 = [_norm_err(a, w) for a, w in zip(tree_leaves(g_p), g_64)]
    assert max(k64) <= 2 * max(p64), (max(k64), max(p64))
    out["cut"] = dict(layers=1, batch=list(QWEN_F64_BATCH),
                      float64_loss=float(loss_64),
                      max_grad_norm_err_f64=max(k64),
                      plain_max_grad_norm_err_f64=max(p64))
    print("qwen grad: " + json.dumps(out), flush=True)
    del g_k, g_p, g_64, p1
    torch.cuda.empty_cache()

    step, optim = TS.make_train_step(mc, remat=False)
    batches = [qwen_train_batch(mc, i) for i in range(1, LM_TRAIN_STEPS + 2)]
    pc, opt, run = timed_train_steps(step, pc, optim.init(pc), batch0,
                                     batches[:LM_TRAIN_STEPS], n_layers)
    out.update(run, tokens_per_s=LM_TRAIN[0] * LM_TRAIN[1]
               / (run["ms_per_step"] / 1e3),
               bound_ms_per_step=lm_train_bound_ms(mc, n_params),
               profile=profile_step(lambda: step(pc, opt, batches[-1]), ()))
    out["device_launches_per_step"] = out["profile"]["device_launches"]

    last = batches[-1]
    loss_1, g = TS.loss_and_grads(mc, pc, last)
    del g
    step2, _ = TS.make_train_step(mc, remat=False, microbatches=2)
    zero_counts()
    pc, opt, met = step2(pc, opt, last)
    launches2 = counts()
    assert launches2["flash_attention_f32 with lse"] == 2 * n_layers, \
        launches2
    loss_1, loss_2 = float(loss_1), float(met["loss"])
    assert abs(loss_2 - loss_1) <= 1e-5 * abs(loss_1), (loss_2, loss_1)
    out["microbatches"] = dict(microbatches=2, loss=loss_2,
                               unsplit_loss=loss_1, launches=launches2)
    print("qwen train: " + json.dumps(out), flush=True)
    del opt, batches, last
    torch.cuda.empty_cache()
    return out


def phase_r() -> dict:
    """Phase r, qwen2-vl-7b at full width: r1 the flash kernel at its
    layer (`check_flash_at`), r2 init and the prefills with text and
    vision positions (`drive_prefill`), r3 the ``Engine``
    (`drive_serve`), r4 training on the cut model (`check_qwen_train`,
    once the full model is freed); each path's launches counted from zero
    just before it."""
    out = dict(flash=check_flash_at(QWEN_FLASH_SHAPES, QWEN_FLASH_GRAD_SHAPES))
    m, params, out["init"] = qwen_model()
    out["prefill"] = drive_prefill(m, params, "qwen prefill")
    out["prefill_vision"] = drive_prefill(
        m, params, "qwen prefill vision", rounds=("kernel",),
        positions=qwen_positions(*PREFILL))
    out["serve"] = drive_serve(m, params, "qwen serve")
    mc, pc = cut_repeats(m, params, QWEN_TRAIN_LAYERS)
    pc = tree_map(torch.clone, pc)     # copies, so the full model can go
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = check_qwen_train(mc, pc, m.n_layers)
    del pc
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase s: the cost tools (utils/op_cost, utils/roofline, train/step's
# build_case, launch/perf) beside the card
# ---------------------------------------------------------------------------
def shape_of(kind: str, b: int, s: int) -> Shape:
    return Shape(f"{kind}_{b}x{s}", s, b, kind)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def path_cases() -> dict:
    """Phase s2's paths, each the case of what its phase times, at the
    phase's own shapes and configs: label -> a function building its
    ``TS.Case`` on meta structs."""
    get = configs.get_arch
    gemma, mixtral, hymba, xlstm, whisper, qwen = (get(a) for a in (
        LM_ARCH, MOE_ARCH, HYMBA_ARCH, XLSTM_ARCH, WHISPER_ARCH, QWEN_ARCH))
    prefill = shape_of("prefill", *PREFILL)
    engine = shape_of("decode", SERVE["slots"], SERVE["cache_len"])
    train = shape_of("train", *LM_TRAIN)
    # float32, the dtype every phase runs (the cost tools count bf16 by
    # default, the reference's dtype)
    build = (lambda m, shape, **kw:                         # noqa: E731
             lambda: TS.build_case(m, shape, dtype=torch.float32, **kw))
    cases = {
        "prefill": build(gemma, prefill),
        "serve": build(gemma, engine),
        "lm train": build(get(LM_TRAIN_ARCH), train, remat=False),
        "moe prefill": build(cut_config(mixtral, MOE_LAYERS), prefill),
        "moe serve": build(cut_config(mixtral, MOE_LAYERS), engine),
        "moe train": build(cut_config(mixtral, MOE_LAYERS),
                           shape_of("train", *MOE_TRAIN), remat=False),
        "hymba prefill": build(hymba, prefill),
        "hymba serve": build(hymba, engine),
        "hymba train": build(hymba, train, remat=False),
        "xlstm prefill": build(cut_config(xlstm, XLSTM_SERVE_REPEATS),
                               prefill),
        "xlstm serve": build(cut_config(xlstm, XLSTM_SERVE_REPEATS), engine),
        "xlstm train": build(cut_config(xlstm, XLSTM_TRAIN_REPEATS), train,
                             remat=XLSTM_TRAIN_REMAT),
        "whisper decode": build(whisper, shape_of(
            "decode", WHISPER_BATCH, DECODER_TRAIN_LEN)),
        "whisper train": build(whisper, shape_of(
            "train", WHISPER_BATCH, whisper.max_enc_len), remat=False),
        "qwen prefill": build(qwen, prefill),
        "qwen serve": build(qwen, engine),
        "qwen train": build(cut_config(qwen, QWEN_TRAIN_LAYERS), train,
                            remat=False),
    }

    def encode():
        p = TS.param_structs(whisper, torch.float32)
        return TS.Case("whisper encode", lambda p_, f: MB.encode(
            p_, whisper, f), (p, _meta((WHISPER_BATCH, whisper.max_enc_len,
                                        whisper.d_model))))

    def whisper_prefill():
        frames = _meta((WHISPER_BATCH, whisper.max_enc_len, whisper.d_model))
        toks = _meta((WHISPER_BATCH, WHISPER_PROMPT), torch.int32)
        return TS.Case("whisper prefill", TS.make_prefill_step(whisper), (
            TS.param_structs(whisper, torch.float32),
            {"frames": frames, "tokens": toks}))

    def moe_layer(arch):
        cfg = get(arch).segments[0].pattern[0].cfg
        p = MOE.moe_init(prng.prng_key(torch.tensor(0)), cfg.n_experts,
                         cfg.d_model, cfg.d_ff, "meta")
        x = _meta((PREFILL[0] * PREFILL[1], cfg.d_model))
        return TS.Case(f"moe layer {arch}", lambda p_, x_: MOE.moe_apply(
            p_, x_, top_k=cfg.top_k), (p, x))

    cases.update({"whisper encode": encode,
                  "whisper prefill": whisper_prefill})
    cases.update({f"moe layer {a}": functools.partial(moe_layer, a)
                  for a in MOE_LAYER_ARCHS})
    m = get(LM_TRAIN_ARCH)
    cases.update({f"s3 micro={mi} remat={int(r)}": build(
        m, train, remat=r, microbatches=mi) for mi, r in PERF_SWEEP})
    return cases


def count_paths(out_path: str) -> None:
    """Phase s2's counts, made on meta in a process of their own while
    the card runs phases 2-r (``--count-paths``): each path's case run
    once under ``utils/op_cost``, its roofline terms on the card, its
    peak of live bytes, its params, its kernels' calls; written to
    `out_path` as JSON."""
    torch.set_num_threads(1)
    out = {}
    for label, make in path_cases().items():
        t0 = time.perf_counter()
        case = make()
        c = op_cost.count(case.fn, *case.args)[1]
        counted = c.totals()
        rl = RL.from_counted(label, counted)
        out[label] = dict(
            t_compute_ms=1e3 * rl.t_compute, t_memory_ms=1e3 * rl.t_memory,
            t_bound_ms=1e3 * rl.t_bound, bottleneck=rl.bottleneck,
            flops_by_unit=counted["flops_by_unit"],
            hbm_bytes=counted["hbm_bytes"], peak_bytes=counted["peak_bytes"],
            n_params=MB.param_count(case.args[0]),
            kernel_calls={r["op"]: r["calls"] for r in c.top_ops(10 ** 6)
                          if r["op"] in KERNEL_NAMES},
            trace_s=time.perf_counter() - t0)
        del case, counted, c
    with open(out_path, "w") as fh:
        json.dump(out, fh)


def start_counting() -> tuple:
    """Phase s2's counts in a process of their own (`count_paths`), started
    with the script: (the process, the file it writes)."""
    fd_, path = tempfile.mkstemp(suffix=".json")
    os.close(fd_)
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--count-paths", path])
    return proc, path


def check_meta_routes() -> dict:
    """Phase s1: each hand-written kernel at a shape the script launches,
    on the card and on meta: the meta call's outputs have the launch's
    shapes, dtypes and strides, and it moves no launch counter."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rand = lambda *sh: torch.randn(sh, generator=gen,  # noqa: E731
                                   device="cuda")
    model = Im2colModel()
    g_params = G.init_generator(prng.prng_key(torch.tensor(11)), G.GANConfig(
        n_net=model.net_space.n_dims), model.space, "cuda")
    ws = [lay["w"] for lay in g_params["layers"]]
    bs = [lay["b"] for lay in g_params["layers"]]
    m_, k_, n_, relu = DENSE_SHAPES["hidden 2048->2048"]
    x, w, b = rand(m_, k_), rand(k_, n_) / k_ ** 0.5, rand(n_)
    y = fd.dense_forward(x, w, b, relu)
    dy = rand(m_, n_)
    fb, fh, fhkv, fsq, fsk, fd_, fc, fw, fo = FLASH_SHAPES[
        "gemma3 local 2x4x4096x256 w1024"]
    q, k, v = rand(fb, fh, fsq, fd_), rand(fb, fhkv, fsk, fd_), rand(
        fb, fhkv, fsk, fd_)
    sb, ss_ = LM_TRAIN
    di, n = 2 * configs.get_arch(HYMBA_ARCH).d_model, 16
    scan = (rand(sb, ss_, di).abs() * 0.1, rand(sb, ss_, n), rand(sb, ss_, n),
            rand(sb, ss_, di), -rand(di, n).abs(), rand(sb, di, n))
    xd = configs.get_arch(XLSTM_ARCH).d_model
    heads = 4
    lb, ls = SLSTM_SHAPES["engine"]
    sl_in = (rand(lb, ls, 4 * xd) * 0.3, rand(heads, xd // heads,
                                              4 * xd // heads) * 0.05,
             rand(4 * xd) * 0.1,
             (torch.zeros(lb, xd, device="cuda"),
              torch.full((lb, xd), 1e-6, device="cuda"),
              torch.full((lb, xd), -1e30, device="cuda"),
              torch.zeros(lb, xd, device="cuda")))
    calls = {
        "mlp_forward_f32": (fm.fused_mlp, (rand(N_TASKS, ws[0].shape[0]), ws,
                                           bs)),
        "dense_forward_f32": (fd.dense_forward, (x, w, b, relu)),
        "dense_dx_f32": (fd.dense_dx, (dy, y, w, relu)),
        "dense_dw_db_f32": (fd.dense_dw_db, (x, dy, y, relu)),
        "flash_attention_f32": (functools.partial(
            fa.flash_attention, causal=fc, window=fw, q_offset=fo),
            (q, k, v)),
        "flash_attention_f32 with lse": (functools.partial(
            fa.flash_attention, causal=fc, window=fw, q_offset=fo,
            return_lse=True), (q, k, v)),
        "ssm_scan_f32": (ss.ssm_scan_fwd, scan),
        "slstm_scan_f32": (sl.slstm_scan_fwd, sl_in),
    }
    on_card = {name: fn(*args) for name, (fn, args) in calls.items()}
    hc = on_card["ssm_scan_f32"][2]
    calls["ssm_scan_bwd_f32"] = (ss.ssm_scan_bwd, (*scan[:5], hc,
                                                    rand(sb, ss_, di)))
    hs_, _, ch = on_card["slstm_scan_f32"]
    calls["slstm_scan_bwd_f32"] = (sl.slstm_scan_bwd, (
        *sl_in, hs_, ch, rand(lb, ls, xd)))
    for name in ("ssm_scan_bwd_f32", "slstm_scan_bwd_f32"):
        fn, args = calls[name]
        on_card[name] = fn(*args)
    torch.cuda.synchronize()

    def layout(out):
        return [None if t is None else (list(t.shape), str(t.dtype),
                                        list(t.stride()))
                for t in tree_leaves(out)]

    to_meta = lambda a: tree_map(  # noqa: E731
        lambda t: t.to("meta") if torch.is_tensor(t) else t, a)
    rows = {}
    for name, (fn, args) in calls.items():
        meta_args = to_meta(list(args))
        before = counts()
        got = fn(*meta_args)
        assert counts() == before, f"{name}: the meta call moved a counter"
        want = layout(on_card[name])
        assert layout(got) == want, (name, layout(got), want)
        assert all(t is None or t.is_meta for t in tree_leaves(got)), name
        rows[name] = dict(outputs=len(want), layouts=want)
    del on_card
    torch.cuda.empty_cache()
    print("meta routes vs the card: " + json.dumps(
        {k: r["outputs"] for k, r in rows.items()}), flush=True)
    return rows


def check_bounds(counted: dict, measured: dict, trained: dict) -> dict:
    """Phase s2: each path's counted ``t_compute``, ``t_memory``,
    ``t_bound`` and bottleneck beside the time its phase measured and
    PERF.md's hand bound; every measured time at least its ``t_bound``;
    the counted params of every model ``init_lm`` built (and of the cut
    train steps) equal the card's; ``CARD_BYTES`` the card's memory."""
    total = torch.cuda.get_device_properties(0).total_memory
    assert DR.CARD_BYTES == total, (DR.CARD_BYTES, total)
    for label, m in MODELS.items():
        n = MB.param_count(TS.param_structs(m))
        assert n == INIT_S[label]["params"], (label, n, INIT_S[label])
    for label, n_card in trained.items():
        assert counted[label]["n_params"] == n_card, (label, n_card,
                                                      counted[label])
    rows = {}
    paths = [k for k in counted if not k.startswith("s3 ")]
    for label in paths + [k for k in measured if k not in paths]:
        c = counted[label.replace(" vision", "")]
        row = {k: c[k] for k in ("t_compute_ms", "t_memory_ms", "t_bound_ms",
                                 "bottleneck", "flops_by_unit", "hbm_bytes",
                                 "peak_bytes", "n_params", "trace_s")}
        if label in measured:
            ms, hand_ms = measured[label]
            row.update(measured_ms=ms, hand_bound_ms=hand_ms,
                       measured_over_t_bound=ms / c["t_bound_ms"],
                       t_bound_over_hand=c["t_bound_ms"] / hand_ms)
        rows[label] = row
        print(f"bound {label}: " + json.dumps(row), flush=True)
        if label in measured:
            assert row["measured_ms"] >= c["t_bound_ms"], \
                f"{label}: {row['measured_ms']} ms on the card under its " \
                f"bound {c['t_bound_ms']}"
    return dict(paths=rows, card_bytes=total,
                params_checked=sorted(MODELS) + sorted(trained))


def perf_sweep(counted: dict) -> dict:
    """Phase s3: ``launch/perf``'s sweep on the card.  LM_TRAIN_ARCH's
    train step at LM_TRAIN, float32 from seed 0, each PERF_SWEEP variant
    (microbatches, remat): its peak memory reset, one warm step and
    PERF_SWEEP_STEPS timed (host clock ended by a synchronize), its
    launches counted from zero; the least step time and
    ``max_memory_allocated`` beside the counted ``t_bound`` and peak.
    Each step makes one flash launch with lse a layer and microbatch,
    and under remat one more in the recompute, as the meta count of the
    same step says; the time at least its ``t_bound``."""
    m = configs.get_arch(LM_TRAIN_ARCH)
    params = init_lm(m, f"{m.name} (phase s3)")
    batches = [lm_train_batch(m, i) for i in range(PERF_SWEEP_STEPS + 1)]
    rows, launches = {}, {}
    for micro, remat in PERF_SWEEP:
        label = f"s3 micro={micro} remat={int(remat)}"
        c = counted[label]
        lse_per_step = m.n_layers * micro * (2 if remat else 1)
        assert c["kernel_calls"].get("flash_attention_f32 with lse") == \
            lse_per_step, (label, c["kernel_calls"])
        step, optim = TS.make_train_step(m, remat=remat, microbatches=micro)
        opt = optim.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        times = []
        for batch in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        launches[label] = counts()
        peak = torch.cuda.max_memory_allocated()
        assert launches[label]["flash_attention_f32 with lse"] == \
            lse_per_step * len(batches), (label, launches[label])
        ms = min(times[1:])
        rows[label] = dict(
            micro=micro, remat=remat, step_ms=times[1:], warm_ms=times[0],
            ms=ms, t_bound_ms=c["t_bound_ms"], bottleneck=c["bottleneck"],
            ms_over_t_bound=ms / c["t_bound_ms"], peak_bytes=peak,
            predicted_peak_bytes=c["peak_bytes"],
            peak_over_predicted=peak / c["peak_bytes"],
            flash_lse_per_step=lse_per_step)
        print(f"perf {label}: " + json.dumps(rows[label]), flush=True)
        assert ms >= c["t_bound_ms"], (label, ms, c["t_bound_ms"])
        del opt, step
        torch.cuda.empty_cache()
    del params, batches
    torch.cuda.empty_cache()
    return dict(variants=rows, launches=launches)


def phase_s(counting: tuple, measured: dict, trained: dict) -> dict:
    """Phase s: s1 the meta routes against the card; s2 the counted
    bounds beside the measured times (the counts made by `count_paths`
    beside phases 2-r); s3 the perf sweep on the card."""
    out = dict(meta_routes=check_meta_routes())
    proc, path = counting
    assert proc.wait() == 0, f"count_paths exited {proc.returncode}"
    with open(path) as fh:
        counted = json.load(fh)
    os.unlink(path)
    print("phase s2 trace seconds: " + json.dumps(
        {k: round(v["trace_s"], 2) for k, v in counted.items()}), flush=True)
    out["bounds"] = check_bounds(counted, measured, trained)
    out["perf"] = perf_sweep(counted)
    return out


# ---------------------------------------------------------------------------
# phase t: the multi-rank half (launch/mesh, core/shard, train/shardings)
# ---------------------------------------------------------------------------
#: t2's ranks, both on the one card (gloo: NCCL takes one rank a device)
T2_RANKS = 2
#: explore_batch's task counts under the mesh: phase 3's and a ragged one
T_TASKS = (N_TASKS, N_TASKS - 1)
#: train_gan under the mesh: rows, epochs (batch 1024: 2 steps an epoch)
T_TRAIN = (2048, 2)
#: train_gan's first step alone: rows, epochs, batch.  The dense kernels
#: split no reduction past 66 tiles of 128 rows (``gemm3::splits``, 132
#: SMs), so at 16384 rows a rank and 32768 on one rank every row's
#: forward, ReLU masks and backward signal have the same bits in both
#: runs, and the gradients differ only by the order of the sums over the
#: rows.  At batch 1024 a rank's 512 rows split the hidden layers' K in
#: two (one rank's 1024 do not), and at 2048 the heads' K slices differ
#: (16 against 8): rounding then flips ReLU masks, each moving the
#: gradient by one sample's term (PERF.md, PR 28)
T_FIRST = (32768, 1, 32768)
#: that step's all-reduced gradients (Adam's first moment after one step,
#: 0.1 g) against one rank's: the largest max |difference| / max |value|
#: of a leaf; its losses' relative difference too
T_GRAD_TOL = 1e-5
#: examples/train_lm_torch.py's steps at its default ~100M model
T_LM_STEPS = 40


def _sel_row(s) -> list:
    return [None if s.cfg_idx is None else s.cfg_idx.tolist(), s.latency,
            s.power, s.satisfied, s.n_candidates]


def t_engine(device) -> "dse.GANDSE":
    """Phase 3's im2col engine: G 11 x 2048 from seed 0 on `device`, the
    normalizers of 4096 rows."""
    model = Im2colModel()
    cfg = G.GANConfig(n_net=model.net_space.n_dims)
    engine = dse.GANDSE(model, cfg, device=device)
    engine.attach(gen_mod.generate_dataset(model, 4096, seed=0),
                  G.init_generator(prng.prng_key(torch.tensor(0)), cfg,
                                   model.space, device))
    return engine


def t_explore(engine, mesh) -> dict:
    """explore_batch of each of T_TASKS under the task mesh (phase 3's
    tasks and seed), warm: its Selections and ms a task; the launches of
    the timed batches, counted from zero just before them."""
    out = {}
    with shard.task_mesh(mesh):
        for n in T_TASKS:
            tasks = gen_mod.generate_tasks(engine.model, n, seed=1)
            engine.explore_batch(tasks, seed=0)
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = engine.explore_batch(tasks, seed=0)
            torch.cuda.synchronize()
            out[n] = dict(sels=[_sel_row(r.selection) for r in res],
                          ms_per_task=1e3 * (time.perf_counter() - t0) / n,
                          launches=counts())
    return out


def t_train(mesh, rows: int = T_TRAIN[0], epochs: int = T_TRAIN[1],
            batch: int = 1024) -> tuple:
    """train_gan on im2col at G/D 11 x 2048 on `rows` rows for `epochs`
    epochs of `batch`, under `mesh`: the state, ms a step (set-up
    included) and the launches, counted from zero just before it."""
    model = Im2colModel()
    cfg = dataclasses.replace(G.GANConfig(n_net=model.net_space.n_dims),
                              batch_size=batch)
    ds = gen_mod.generate_dataset(model, rows, seed=0)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    st = T.train_gan(model, ds, cfg, iters=epochs, seed=0, mesh=mesh,
                     device="cuda")
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(st.history)
    return st, ms, counts()


def first_step(st) -> dict:
    """A one-step run's all-reduced gradients, as Adam's first moments
    (0.1 g: the first moment starts at 0) of G and of D on the CPU, and
    its losses."""
    return dict(g=[t.cpu() for t in tree_leaves(st.g_opt.mu)],
                d=[t.cpu() for t in tree_leaves(st.d_opt.mu)],
                loss_g=st.history[0]["loss_g"],
                loss_d=st.history[0]["loss_d"])


def first_step_gap(mine: dict, ref: dict) -> dict:
    """G's and D's largest max |difference| / max |value| over the leaves
    of the first step's gradients, and the losses' relative difference."""
    def gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                   for x, y in zip(a, b))

    return dict(g=gap(mine["g"], ref["g"]), d=gap(mine["d"], ref["d"]),
                loss=max(abs(mine[k] - ref[k]) / abs(ref[k])
                         for k in ("loss_g", "loss_d")))


def check_moe_e_par(mesh) -> dict:
    """Phase t1: mixtral's layer at phase l's 8192 tokens (its seed and
    input) under the host mesh takes the e_par combine: on finite input
    the bits of the no-mesh layer phase l holds; with token 0 non-finite
    the NaN row count of the CPU port's pieces run on the card's routing
    (at a width of 16: which rows turn NaN depends on the routing alone),
    where the no-mesh layer has one."""
    cfg = configs.get_arch("mixtral-8x7b").segments[0].pattern[0].cfg
    e, k = cfg.n_experts, cfg.top_k
    t = PREFILL[0] * PREFILL[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = MOE.moe_init(prng.prng_key(torch.tensor(0)), e, cfg.d_model,
                     cfg.d_ff, "cuda")
    x = torch.randn((t, cfg.d_model), generator=gen, device="cuda")
    kw = dict(reps=5, warmup=1)
    with torch.no_grad():
        plain = MOE.moe_apply(p, x, top_k=k)
        plain_ms = cuda_ms(lambda: MOE.moe_apply(p, x, top_k=k), **kw)
        with SH.use_mesh(mesh):
            assert MOE._e_par(e), "the host mesh does not take e_par"
            y = MOE.moe_apply(p, x, top_k=k)
            ms = cuda_ms(lambda: MOE.moe_apply(p, x, top_k=k), **kw)
        same = torch.equal(y, plain)
        del y, plain
        x[0] = float("inf")
        with SH.use_mesh(mesh):
            card_nan = int(torch.isnan(MOE.moe_apply(p, x, top_k=k))
                           .any(1).sum())
        plain_nan = int(torch.isnan(MOE.moe_apply(p, x, top_k=k))
                        .any(1).sum())
        idx, wts = MOE.route_topk(x @ p["router"], k)
        cap = MOE.capacity(t, e, k, 1.25)
        narrow = torch.Generator().manual_seed(1)
        ps = {"w_gate": torch.randn((e, 16, 8), generator=narrow),
              "w_up": torch.randn((e, 16, 8), generator=narrow),
              "w_down": torch.randn((e, 8, 16), generator=narrow)}
        xe, slot, keep = MOE.dispatch(x[:, :16].cpu(), idx.cpu()[None], e,
                                      cap)
        cpu_nan = int(torch.isnan(MOE.combine_e_par(
            MOE.expert_ffn(ps, xe), slot, keep, wts.cpu(), 1)).any(1).sum())
    del p, x
    torch.cuda.empty_cache()
    out = dict(tokens=t, same_bits_as_no_mesh=same, nan_rows=card_nan,
               cpu_nan_rows=cpu_nan, no_mesh_nan_rows=plain_nan,
               e_par_ms=ms, no_mesh_ms=plain_ms)
    assert same, "e_par differs from the plain combine on finite input"
    assert card_nan == cpu_nan > plain_nan == 1, out
    return out


def drive_train_lm_example() -> dict:
    """Phase t1: ``examples/train_lm_torch.py`` at its default ~100M
    model, T_LM_STEPS steps on the card under ``make_host_mesh()``: the
    loss falls (the example asserts it) and flash with lse is launched."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "train_lm_torch.py")
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    log = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="train_lm_") as tmp:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            losses = example.main(["--steps", str(T_LM_STEPS),
                                   "--ckpt-dir", tmp])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out = dict(losses=losses, seconds=seconds,
               ms_per_step=1e3 * seconds / T_LM_STEPS, launches=counts(),
               model=log.getvalue().splitlines()[0])
    assert losses[-1] < losses[0], losses
    assert out["launches"]["flash_attention_f32 with lse"] > 0, out
    return out


def phase_t1(engine, warm) -> dict:
    """Phase t1: a world of one on NCCL, ``make_host_mesh()`` = (1, 1).
    `engine` and `warm` are phase 3's im2col engine and its Selections."""
    import torch.distributed as dist

    mesh = LM.make_host_mesh()
    assert SH.mesh_sizes(mesh) == {"data": 1, "model": 1}, mesh
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    explore = t_explore(engine, mesh)
    assert explore[N_TASKS]["sels"] == [_sel_row(r.selection) for r in warm]
    st, ms, launches = t_train(mesh)
    st_plain, _, _ = t_train(None)
    same = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((st.g_params, st.d_params)),
        tree_leaves((st_plain.g_params, st_plain.d_params))))
    assert same and st.history == st_plain.history,         "train_gan under the one-rank mesh is not the no-mesh run"
    out = dict(
        explore={n: {k: r[k] for k in ("ms_per_task", "launches")}
                 for n, r in explore.items()},
        train=dict(ms_per_step=ms, launches=launches,
                   same_bits_as_no_mesh=same),
        moe=check_moe_e_par(mesh), train_lm=drive_train_lm_example())
    assert launches["dense_forward_f32"] > 0, launches
    first, _, _ = t_train(mesh, *T_FIRST)
    print("phase t1: " + json.dumps(out), flush=True)
    return out, {"sels": {n: r["sels"] for n, r in explore.items()},
                 "params": [t.cpu() for t in tree_leaves(
                     (st.g_params, st.d_params))],
                 "loss_g": [h["loss_g"] for h in st.history],
                 "first": first_step(first)}


def t2_rank(rank: int, tmp: str) -> int:
    """One rank of phase t2 (``--t2-rank``): gloo over a FileStore in
    `tmp`, ``cuda:0``, ``make_host_mesh()`` = (2, 1); task-sharded
    explore_batch, data-parallel train_gan's first step and its T_TRAIN
    run held to t1's, written to `tmp`/rank<r>.json."""
    import hashlib

    import torch.distributed as dist

    torch.cuda.set_device(0)
    LM.init_process_group("gloo", dist.FileStore(os.path.join(tmp, "store"),
                                                 T2_RANKS), rank, T2_RANKS)
    mesh = LM.make_host_mesh(device="cuda:0")
    assert SH.mesh_sizes(mesh) == {"data": T2_RANKS, "model": 1}
    t1 = torch.load(os.path.join(tmp, "t1.pt"))
    explore = t_explore(t_engine("cuda:0"), mesh)
    first, _, _ = t_train(mesh, *T_FIRST)
    st, ms, launches = t_train(mesh)
    leaves = [a.cpu() for a in tree_leaves((st.g_params, st.d_params))]
    digest = hashlib.sha256()
    for a in leaves:
        digest.update(a.numpy().tobytes())
    loss_g = [h["loss_g"] for h in st.history]
    out = dict(
        rank=rank,
        explore={n: dict(same_as_t1=r["sels"] == t1["sels"][n],
                         ms_per_task=r["ms_per_task"],
                         launches=r["launches"])
                 for n, r in explore.items()},
        train=dict(ms_per_step=ms, launches=launches, steps=len(loss_g),
                   first_step_gap=first_step_gap(first_step(first),
                                                 t1["first"]),
                   params_sha256=digest.hexdigest(),
                   n_params=sum(a.numel() for a in leaves),
                   outside_ref_tol=sum(
                       int((~torch.isclose(a, b, rtol=2e-4, atol=1e-6)).sum())
                       for a, b in zip(leaves, t1["params"])),
                   loss_g_max_diff=max(abs(a - b) for a, b in
                                       zip(loss_g, t1["loss_g"]))))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()
    return 0


def run_t2_ranks(t1_state: dict, cmd=None) -> list:
    """Starts T2_RANKS processes at once, each `cmd` (this script by
    default) with ``--t2-rank r --t2-dir DIR``, on t1's state in DIR; the
    records they write there, in rank order."""
    cmd = cmd or [sys.executable, os.path.abspath(__file__)]
    with tempfile.TemporaryDirectory(prefix="phase_t2_") as tmp:
        torch.save(t1_state, os.path.join(tmp, "t1.pt"))
        procs = [subprocess.Popen(
            cmd + ["--t2-rank", str(r), "--t2-dir", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(T2_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        ranks = []
        for r in range(T2_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    return ranks


def t2_failures(ranks: list) -> list:
    """The gates of phase t2 that the ranks' records miss (none: held).

    - each rank's Selections of 64 and 63 tasks are t1's, bit for bit,
      with the whole MLP launched;
    - at T_FIRST's batch, the first step's all-reduced G and D gradients
      are t1's one-rank step's within T_GRAD_TOL of each leaf's largest
      value, and its losses within T_GRAD_TOL: there each row's bits and
      ReLU masks are one rank's and only the sums over the rows round
      apart (PERF.md, PR 28);
    - after T_TRAIN's 4 steps every rank holds the same params, bit for
      bit, and loss_g is within 1e-3 of t1's at every step (the
      reference's bound); at most 1% of the params lie outside the
      reference's rtol 2e-4 / atol 1e-6 of t1's;
    - the three dense kernels launched in each rank."""
    bad = []
    for r in ranks:
        tag = f"rank {r['rank']}"
        for n, ex in r["explore"].items():
            if not ex["same_as_t1"]:
                bad.append(f"{tag}: {n} tasks' Selections")
            if not ex["launches"]["mlp_forward_f32"]:
                bad.append(f"{tag}: mlp_forward_f32 not launched")
        tr = r["train"]
        gap = tr["first_step_gap"]
        for k in ("g", "d"):
            if not gap[k] <= T_GRAD_TOL:
                bad.append(f"{tag}: first step's {k.upper()} gradients")
        if not gap["loss"] <= T_GRAD_TOL:
            bad.append(f"{tag}: first step's losses")
        if tr["params_sha256"] != ranks[0]["train"]["params_sha256"]:
            bad.append(f"{tag}: params differ from rank 0's")
        if not tr["loss_g_max_diff"] < 1e-3:
            bad.append(f"{tag}: loss_g")
        if not tr["outside_ref_tol"] <= 0.01 * tr["n_params"]:
            bad.append(f"{tag}: params outside the reference's tolerance")
        for name in DENSE_KERNELS:
            if not tr["launches"][name]:
                bad.append(f"{tag}: {name} not launched")
    return bad


def phase_t2(t1_state: dict) -> dict:
    """Phase t2: T2_RANKS ranks on the one card (gloo, both ``cuda:0``),
    started once, held by ``t2_failures``."""
    ranks = run_t2_ranks(t1_state)
    out = {f"rank {r['rank']}": r for r in ranks}
    print("phase t2: " + json.dumps(out), flush=True)
    failed = t2_failures(ranks)
    assert not failed, failed
    return out


def phase_t(engine, warm) -> tuple:
    """Phase t: t1 then t2, with the card's name and power limit; the
    world of one is shut down at the end."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    t1, state = phase_t1(engine, warm)
    t2 = phase_t2(state)
    dist.destroy_process_group()
    out = dict(card=smi(), t1=t1, t2=t2, seconds=time.perf_counter() - t0)
    print(f"phase t: {out['seconds']:.1f} s on {out['card']}", flush=True)
    return out, state


# ---------------------------------------------------------------------------
# phase u: serving and training across a 'model' axis (train/parallel), two
# ranks on the
# one card
# ---------------------------------------------------------------------------
#: u's ranks, both on the one card (gloo), on a (1, 2) ('data', 'model')
#: mesh
U_RANKS = 2
U_ARCH = "stablelm-1.6b"
#: stablelm's prefill, full width and depth
U_PREFILL = (2, 2048)
#: the Engine: 2 slots, 2 requests of 4 prompt tokens + 5 new (8 steps);
#: a cache of 64 (its S, 64, ties dh and goes to 'model' first)
U_ENGINE = dict(slots=2, cache_len=64, requests=2, prompt=4, max_new=5)
#: mixtral at full width, cut to MOE_LAYERS layers as phase l4's
U_MOE_PREFILL = (1, 2048)
#: train_gan's one step on the task mesh: rows, epochs, batch
U_TRAIN = (1024, 1, 1024)
#: the LM train steps on the mesh (remat on, act_shard 'model', the
#: reference's defaults): stablelm at full width and depth, the cut
#: mixtral at full width
U_LM_TRAIN = (2, 2048)
U_MOE_TRAIN = (1, 2048)
#: a gradient block's distance from the world of one's over its leaf's
#: norm (the LM gradient gate of phase j), the norm floored at
#: U_GRAD_FLOOR of the whole gradient's: a leaf whose gradient is zero in
#: exact arithmetic (the mLSTM's b_i: the stabiliser absorbs a shift of
#: every input gate) holds rounding noise alone
U_GRAD_TOL = 1e-3
U_GRAD_FLOOR = 1e-4
#: hymba, xlstm and whisper across the 'model' axis (ROADMAP Queue 1 item
#: 6c), at full width: hymba-1.5b served at full depth (32 layers: 25
#: heads, which 2 does not divide, so every rank runs every head) and
#: trained on U_HYMBA_TRAIN_CUT (its first global and first local layer);
#: xlstm-1.3b cut to U_XLSTM_REPEATS repeat (8 blocks: float32's
#: conditioning at depth, ROADMAP Queue 3 item 6) for both; whisper-small
#: at full depth, served through make_decode_step (the reference's Engine
#: cannot serve it, Queue 3 item 7): ``encode`` of U_WHISPER_FRAMES
#: frames, a prefill of U_WHISPER_PREFILL tokens, U_WHISPER_STEPS decode
#: steps from empty caches of U_ENGINE's cache_len
U_HYMBA_PREFILL = (1, 2048)
U_HYMBA_TRAIN_CUT = 2          # segments: [global x1, local x1]
U_XLSTM_REPEATS = 1
U_RECURRENT_TRAIN = (1, 2048)
U_WHISPER_FRAMES = 1500
U_WHISPER_PREFILL = (1, 448)
U_WHISPER_STEPS = 8
#: phase u's records that hold a "train" record, and their archs
U_TRAINED = {"lm": U_ARCH, "moe": MOE_ARCH, "hymba_train": HYMBA_ARCH,
             "xlstm": XLSTM_ARCH, "whisper": WHISPER_ARCH}
#: phase u's records that serve (a prefill, and an Engine or whisper's
#: decode steps), held to rank 0's world of one
U_SERVED = ("lm", "moe", "hymba", "xlstm", "whisper")


def u_hymba_train_cut():
    """hymba-1.5b cut to its first U_HYMBA_TRAIN_CUT segments, one layer
    each: a global (full) and a local (window 1024) layer."""
    m = configs.get_arch(HYMBA_ARCH)
    return dataclasses.replace(m, segments=tuple(
        dataclasses.replace(seg, repeats=1)
        for seg in m.segments[:U_HYMBA_TRAIN_CUT]))


def u_heads(cfg) -> int:
    """The q heads of a rank's flash launch: H/m where 'model' divides the
    heads, else every head (wq's and wo's blocks end mid-head)."""
    return cfg.n_heads // U_RANKS if cfg.n_heads % U_RANKS == 0 \
        else cfg.n_heads


def u_expect(m) -> dict:
    """What one forward of `m` launches on a rank: flash (a decoder or
    encoder layer's attention, a whisper decoder layer's self- and
    cross-attention) at ``u_heads`` q heads, the selective scan at Di/m
    channels, the sLSTM at every head (it runs replicated)."""
    specs = [(seg.repeats, sp) for seg in m.segments + (m.enc_segments or ())
             for sp in seg.pattern]
    per = {"dense": 1, "enc": 1, "dec": 2}
    return dict(
        flash=sum(n * per.get(sp.kind, 0) for n, sp in specs),
        heads=sorted({u_heads(sp.cfg) for _, sp in specs
                      if sp.kind in per}),
        ssm=sum(n for n, sp in specs if sp.cfg.ssm_state),
        ssm_channels=sorted({2 * m.d_model // U_RANKS for _, sp in specs
                             if sp.cfg.ssm_state}),
        slstm=sum(n for n, sp in specs if sp.kind == "slstm"),
        slstm_heads=sorted({sp.cfg.n_heads for _, sp in specs
                            if sp.kind == "slstm"}))


@contextlib.contextmanager
def recorded_kernels():
    """Each launch through ``kernels/ops``: a flash launch's (q heads, Sq,
    Sk), a selective scan's channels, an sLSTM scan's heads."""
    seen = {"flash": [], "ssm": [], "slstm": []}

    def flash(q, k, v, **kw):
        seen["flash"].append((q.shape[1], q.shape[2], k.shape[2]))
        return fa.flash_attention(q, k, v, **kw)

    def scan(dt, *a, **kw):
        seen["ssm"].append(dt.shape[-1])
        return ss.ssm_scan(dt, *a, **kw)

    def slstm(wx, rh, *a, **kw):
        seen["slstm"].append(rh.shape[0])
        return sl.slstm_scan(wx, rh, *a, **kw)

    ops._fa = types.SimpleNamespace(flash_attention=flash)
    ops._ss = types.SimpleNamespace(ssm_scan=scan)
    ops._sl = types.SimpleNamespace(slstm_scan=slstm)
    try:
        yield seen
    finally:
        ops._fa, ops._ss, ops._sl = fa, ss, sl


def u_kernels(seen: dict) -> dict:
    """``recorded_kernels``' record as counts and the distinct shapes."""
    return {k: dict(n=len(v), shapes=sorted(set(v))) for k, v in seen.items()}


def u_requests(m) -> list:
    rng = np.random.default_rng(1)
    return [rng.integers(0, m.vocab, U_ENGINE["prompt"]).tolist()
            for _ in range(U_ENGINE["requests"])]


def u_engine(m, params, mesh=None) -> dict:
    """The Engine serving u_requests: its tokens, iterations, the first
    step's ms and the median of the others', and the launches, counted
    from zero just before it."""
    eng = serve.Engine(m, params, U_ENGINE["slots"], U_ENGINE["cache_len"],
                       mesh=mesh)
    for i, p in enumerate(u_requests(m)):
        eng.submit(serve.Request(rid=i, prompt=p, max_new=U_ENGINE["max_new"]))
    torch.cuda.synchronize()
    zero_counts()
    steps = []
    while eng.queue or any(s is not None for s in eng.slots):
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t0))
    return dict(tokens={r.rid: r.out for r in eng.finished},
                iters=len(steps), first_step_ms=steps[0],
                ms_per_step=statistics.median(steps[1:]),
                launches=counts(), engine=eng)


def u_prefill(m, params, shape, mesh=None) -> dict:
    """make_prefill_step(mesh=) on the prompts of prefill_tokens(shape):
    the logits (on the CPU), the flash launches (counted from zero just
    before it) and their heads of a prefill whose collectives are timed
    (``u_timed_split``, its ms under a mesh); with no mesh, the ms of a
    second one."""
    step = TS.make_prefill_step(m, mesh=mesh)
    batch = {"tokens": prefill_tokens(m, shape)}
    if m.enc_segments is not None:
        batch["frames"] = u_frames(m, shape[0])
    zero_counts()
    got = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_kernels() as seen:
        split = u_timed_split(lambda: got.append(step(params, batch)))
    out = dict(logits=got[0].cpu(), heads=[h for h, _, _ in seen["flash"]],
               kernels=u_kernels(seen), launches=counts(),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if mesh is not None:
        return dict(out, split=split, ms=split["ms"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, batch)
    torch.cuda.synchronize()
    return dict(out, ms=1e3 * (time.perf_counter() - t0))


def u_frames(m, b: int):
    """`b` windows of U_WHISPER_FRAMES stub frames (``normal · 0.1``) from
    seed 1 on the card."""
    return 0.1 * torch.randn((b, U_WHISPER_FRAMES, m.d_model), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(1))


def u_decode(m, params, mesh=None) -> dict:
    """Whisper's decode through ``make_decode_step(mesh=, cache_len=)``:
    ``encode`` of one window of U_WHISPER_FRAMES frames (every rank the
    whole batch), then U_WHISPER_STEPS steps from empty caches of
    U_ENGINE's cache_len (the states cut by ``shard_states`` under a
    mesh): the steps' logits (on the CPU), the launches from zero just
    before the encode and the kernels' shapes, the encode's ms and the
    median step's."""
    b, cache = 1, U_ENGINE["cache_len"]
    toks = prefill_tokens(m, (b, U_WHISPER_STEPS))
    states = MB.init_decode_state(params, m, b, cache)
    if mesh is not None:
        states = SH.shard_states(states, mesh, b)
    dec = TS.make_decode_step(m, mesh=mesh,
                              cache_len=cache if mesh is not None else None)
    frames = u_frames(m, b)
    torch.cuda.synchronize()
    zero_counts()
    logits, steps = [], []
    with recorded_kernels() as seen:
        t0 = time.perf_counter()
        with torch.no_grad(), SH.use_mesh(mesh):
            enc = MB.encode(params, m, frames)
        torch.cuda.synchronize()
        encode_ms = 1e3 * (time.perf_counter() - t0)
        for t in range(U_WHISPER_STEPS):
            t0 = time.perf_counter()
            lg, states = dec(params, toks[:, t:t + 1], t, states,
                             enc_out=enc)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t0))
            logits.append(lg[:, 0].cpu())
    return dict(logits=torch.stack(logits, 1), launches=counts(),
                kernels=u_kernels(seen), encode_ms=encode_ms,
                ms_per_step=statistics.median(steps),
                state_bytes=_tensors_bytes(states))


def u_train_batch(m, shape) -> dict:
    """Step 0 of the synthetic stream at `shape`, with ``u_frames``'
    frames for an encoder-decoder."""
    batch = lm_train_batch(m, 0, shape)
    if m.enc_segments is not None:
        batch["frames"] = u_frames(m, shape[0])
    return batch


def u_collectives():
    """``train/parallel``'s two primitives (every collective's forward and
    backward passes through ``_all_gather`` or ``_all_reduce``) wrapped to
    add their host time (synchronised before and after: the ranks share
    one card, so a collective's time includes the wait for the other
    rank) to a total, forward and backward apart: a collective issued
    while autograd's engine runs a backward (its own, or a remat
    recompute's forward) counts as backward.  Returns (the totals, an
    undo)."""
    from repro_torch.train import parallel as PAR

    spent = {side: {"ms": 0.0, "calls": 0, "bytes": 0}
             for side in ("forward", "backward")}
    saved = {n: getattr(PAR, n) for n in ("_all_gather", "_all_reduce")}
    task = getattr(torch._C, "_current_graph_task_id", lambda: -1)

    def timed(fn):
        def run(t, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(t, *a, **kw)
            torch.cuda.synchronize()
            rec = spent["backward" if task() != -1 else "forward"]
            rec["ms"] += 1e3 * (time.perf_counter() - t0)
            rec["calls"] += 1
            rec["bytes"] += sum(x.numel() * x.element_size() for x in (
                out if isinstance(out, list) else [out]))
            return out
        return run

    for n, fn in saved.items():
        setattr(PAR, n, timed(fn))
    return spent, lambda: [setattr(PAR, n, fn) for n, fn in saved.items()]


def u_timed_split(fn) -> dict:
    """One more run of `fn` with the collectives timed: its ms, the
    collectives' ms, calls and bytes received, and each of those of the
    forward's and the backward's collectives apart."""
    spent, undo = u_collectives()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        undo()
    both = {k: spent["forward"][k] + spent["backward"][k]
            for k in ("ms", "calls", "bytes")}
    out = dict(ms=total, collective_ms=both["ms"],
               collective_share=both["ms"] / total,
               collective_calls=both["calls"],
               collective_bytes=both["bytes"])
    if spent["backward"]["calls"]:
        for side, rec in spent.items():
            out[side] = dict(rec, share=rec["ms"] / total)
    return out


def _tensors_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def u_init(m) -> tuple:
    """`m`'s full params from seed 0 on the card, and the seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = MB.init_params(prng.prng_key(torch.tensor(0)), m, "cuda")
    torch.cuda.synchronize()
    return full, time.perf_counter() - t0


def u_model(m, mesh, rank: int, prefill_shape, engine: bool,
            train_shape, world_step: bool, decode: bool = False) -> dict:
    """One rank's run of `m`: its full params from seed 0; on rank 0 the
    world of one first (no mesh: the prefill at `prefill_shape` where
    given, with `engine` the Engine, with `decode` whisper's decode
    steps); the world of one's gradient for training at `train_shape`
    where given (``u_world_grads``); then the Engine built from the full
    params (it shards them and its decode states) or the params sharded
    here, the full tree dropped; the bytes kept beside the spec blocks'
    (counted on the full tree) and the card's ``memory_allocated``; the
    Engine's 8 steps and one more with the collectives timed; whisper's
    decode steps; the prefill on the blocks (its logits and routes go
    back to the script); last, the blocks trained at `train_shape`
    (``u_train``: the step updates them in place).  ``expect`` is what a
    forward launches on a rank (``u_expect``)."""
    full, init_s = u_init(m)
    specs = SH.param_specs(full, mesh)
    out = dict(init_s=init_s, full_param_bytes=_tensors_bytes(full),
               spec_block_bytes=SH.block_bytes(full, specs, mesh),
               n_layers=m.n_layers, expect=u_expect(m))
    if rank == 0 and (prefill_shape or decode):
        one = {}
        if prefill_shape:
            with recorded_routes() as routes:
                one = u_prefill(m, full, prefill_shape)
            one["routes"] = [r.cpu() for r in routes]
        if engine:
            one["engine"] = u_engine(m, full)
            del one["engine"]["engine"]
        if decode:
            one["decode"] = u_decode(m, full)
        out["world_of_one"] = one
    world = batch = None
    if train_shape is not None:
        batch = u_train_batch(m, train_shape)
        world = u_world_grads(m, full, batch, specs, mesh, rank, world_step)
    if engine:
        run = u_engine(m, full, mesh)
        eng = run.pop("engine")
        local = eng.params
        full_states = MB.init_decode_state(full, m, U_ENGINE["slots"],
                                           U_ENGINE["cache_len"])
        out.update(state_bytes=_tensors_bytes(eng.states),
                   state_spec_block_bytes=SH.block_bytes(
                       full_states, SH.state_specs(
                           full_states, mesh, U_ENGINE["slots"]), mesh))
        del full_states
    else:
        local = SH.shard_params(full, mesh)
    if decode:
        full_states = MB.init_decode_state(full, m, 1, U_ENGINE["cache_len"])
        out["state_spec_block_bytes"] = SH.block_bytes(
            full_states, SH.state_specs(full_states, mesh, 1), mesh)
        del full_states
    del full
    gc.collect()
    torch.cuda.empty_cache()
    out.update(param_bytes=_tensors_bytes(local),
               memory_allocated=torch.cuda.memory_allocated())
    if engine:
        toks = torch.zeros((U_ENGINE["slots"], 1), dtype=torch.long,
                           device="cuda")
        start = torch.from_numpy(eng.start).to("cuda")
        out["engine"] = dict(run, split=u_timed_split(lambda: eng._decode(
            eng.params, toks, eng.clock, eng.states, start=start)))
    if decode:
        out["decode"] = u_decode(m, local, mesh)
        out["state_bytes"] = out["decode"].pop("state_bytes")
    if prefill_shape:
        with recorded_routes() as routes:
            out["prefill"] = u_prefill(m, local, prefill_shape, mesh)
        out["prefill"]["routes"] = [r.cpu() for r in routes]
    if train_shape is not None:
        out["train"] = dict(u_train(m, mesh, local, specs, world, batch),
                            shape=list(train_shape), n_layers=m.n_layers,
                            spec_block_bytes=out["spec_block_bytes"],
                            expect=out["expect"])
    return out


def u_dse(mesh, rank: int, sels: list) -> dict:
    """On the (1, 2) task mesh (no batch axis: both ranks compute every
    row): explore_batch of N_TASKS tasks against t1's Selections, and
    train_gan's first step at U_TRAIN; on rank 0 that step with no mesh
    first, the world of one's."""
    engine = t_engine("cuda:0")
    tasks = gen_mod.generate_tasks(engine.model, N_TASKS, seed=1)
    with shard.task_mesh(mesh):
        engine.explore_batch(tasks, seed=0)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        res = engine.explore_batch(tasks, seed=0)
        torch.cuda.synchronize()
        explore = dict(ms_per_task=1e3 * (time.perf_counter() - t0) / N_TASKS,
                       launches=counts(),
                       same_as_t1=[_sel_row(r.selection) for r in res] == sels)
    out = dict(explore=explore)
    if rank == 0:
        st, ms, _ = t_train(None, *U_TRAIN)
        out["world_of_one"] = dict(first=first_step(st), ms_per_step=ms)
    st, ms, launches = t_train(mesh, *U_TRAIN)
    out["train"] = dict(first=first_step(st), ms_per_step=ms,
                        launches=launches)
    return out


def _replicated_sha256(tree, specs, mesh) -> dict:
    """sha256 of the bits of every leaf that no mesh axis splits, by its
    index in ``tree_leaves`` order."""
    import hashlib

    out = {}
    for i, (t, spec) in enumerate(zip(tree_leaves(tree),
                                      SH.spec_leaves(specs))):
        if all(SH.norm_axes(e, mesh) is None for e in spec):
            out[i] = hashlib.sha256(t.detach().cpu().numpy().tobytes()
                                    ).hexdigest()
    return out


def u_world_grads(m, full, batch, specs, mesh, rank: int,
                  world_step: bool) -> dict:
    """The world of one's training on the full tree: its gradient (remat
    on) on every rank at once, each keeping its loss, global norm, each
    leaf's norm and this rank's block of each leaf (on the host); then on
    rank 0 alone, warm and timed while the other waits at a barrier, the
    forward and backward again, and with `world_step` AdamW's update of a
    copy of the tree (the step's other half)."""
    import torch.distributed as dist

    from repro_torch.optim import adamw

    loss, g = TS.loss_and_grads(m, full, batch, remat=True)
    leaves = tree_leaves(g)
    one = dict(loss=float(loss), grad_norm=float(global_norm(g)),
               norms=[float(torch.linalg.vector_norm(x)) for x in leaves],
               blocks=[SH.local_block(x, sp, mesh).cpu()
                       for x, sp in zip(leaves, SH.spec_leaves(specs))])
    del g, leaves
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, g = TS.loss_and_grads(m, full, batch, remat=True)
        torch.cuda.synchronize()
        one["fwd_bwd_ms"] = 1e3 * (time.perf_counter() - t0)
        if world_step:
            optim = adamw(3e-4, weight_decay=0.1, clip_norm=1.0)
            copy = tree_map(torch.clone, full)
            opt = optim.init(copy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            optim.update_in_place(g, opt, copy)
            torch.cuda.synchronize()
            one["step_ms"] = one["fwd_bwd_ms"] + 1e3 * (
                time.perf_counter() - t0)
            del copy, opt
        del g
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return one


def u_train(m, mesh, local, specs, one: dict, batch) -> dict:
    """One train step on this rank's blocks `local` (remat on, act_shard
    'model'): ``make_train_step(mesh=)``'s gradient with the launches
    counted from zero just before it, the flash heads and MoE routes
    recorded and the collectives timed, forward and backward apart
    (``u_timed_split``); its loss, global norm and every gradient block
    held to the world of one's `one` (``u_world_grads``); the global
    norm of the blocks with its collectives timed (``norm_split``);
    AdamW's update with it, timed; the bytes of params, mu
    and nu; the peak memory and the sha256 of every replicated leaf
    after the step."""
    step, optim = TS.make_train_step(m, mesh=mesh)
    opt = optim.init(local)
    got = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with recorded_kernels() as seen, recorded_routes() as routes:
        split = u_timed_split(lambda: got.extend(
            step.loss_and_grads(local, batch)))
    launches = counts()
    heads = [h for h, _, _ in seen["flash"]]
    loss, grads = got
    norms = []
    norm_split = u_timed_split(lambda: norms.append(step.grad_norm(grads)))
    norm = norms[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    optim.update_in_place(grads, opt, local, norm=norm)
    torch.cuda.synchronize()
    update_ms = 1e3 * (time.perf_counter() - t0)
    floor = max(U_GRAD_FLOOR * one["grad_norm"], 1e-30)
    errs = [float(torch.linalg.vector_norm(
        a.double() - b_.to(a.device).double())) / max(n, floor)
        for a, b_, n in zip(tree_leaves(grads), one.pop("blocks"),
                            one.pop("norms"))]
    del grads, got
    cfg = m.segments[0].pattern[0].cfg
    return dict(
        loss=float(loss), world_loss=one["loss"], grad_norm=float(norm),
        world_grad_norm=one["grad_norm"], max_grad_block_err=max(errs),
        worst_leaf=int(np.argmax(errs)), n_leaves=len(errs),
        ms_per_step=split["ms"] + update_ms, update_ms=update_ms,
        split=split, norm_split=norm_split, launches=launches,
        heads=sorted(set(heads)),
        flash_launches=len(heads), kernels=u_kernels(seen),
        routes=[r.cpu() for r in routes],
        param_bytes=_tensors_bytes(local), mu_bytes=_tensors_bytes(opt.mu),
        nu_bytes=_tensors_bytes(opt.nu),
        experts_per_rank=(local["segments"][0][0]["ffn"]["w_gate"].shape[1]
                          if cfg.n_experts else None),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        replicated_sha256=_replicated_sha256(local, specs, mesh),
        world_of_one=one)


def u_rank(rank: int, tmp: str) -> int:
    """One rank of phase u (``--u-rank``): gloo over a FileStore in `tmp`,
    ``cuda:0``, a (1, 2) ('data', 'model') mesh; its record to
    `tmp`/rank<r>.pt."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    LM.init_process_group("gloo", dist.FileStore(os.path.join(tmp, "store"),
                                                 U_RANKS), rank, U_RANKS)
    mesh = LM.make_host_mesh((1, U_RANKS), device="cuda:0")
    assert SH.mesh_sizes(mesh) == {"data": 1, "model": U_RANKS}
    t1 = torch.load(os.path.join(tmp, "t1.pt"))
    out = dict(rank=rank, coordinate=tuple(mesh.get_coordinate()))
    out["lm"] = u_model(configs.get_arch(U_ARCH), mesh, rank, U_PREFILL,
                        engine=True, train_shape=U_LM_TRAIN,
                        world_step=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["moe"] = u_model(cut_config(configs.get_arch(MOE_ARCH),
                                    MOE_LAYERS),
                         mesh, rank, U_MOE_PREFILL, engine=False,
                         train_shape=U_MOE_TRAIN, world_step=False)
    gc.collect()
    torch.cuda.empty_cache()
    for name, m, kw in (
            ("hymba", configs.get_arch(HYMBA_ARCH),
             dict(prefill_shape=U_HYMBA_PREFILL, engine=True,
                  train_shape=None)),
            ("hymba_train", u_hymba_train_cut(),
             dict(prefill_shape=None, engine=False,
                  train_shape=U_RECURRENT_TRAIN)),
            ("xlstm", cut_config(configs.get_arch(XLSTM_ARCH),
                                 U_XLSTM_REPEATS),
             dict(prefill_shape=U_HYMBA_PREFILL, engine=True,
                  train_shape=U_RECURRENT_TRAIN)),
            ("whisper", configs.get_arch(WHISPER_ARCH),
             dict(prefill_shape=U_WHISPER_PREFILL, engine=False,
                  train_shape=U_WHISPER_PREFILL, decode=True))):
        out[name] = u_model(m, mesh, rank, world_step=False, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    out["dse"] = u_dse(mesh, rank, t1["sels"])
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def run_u_ranks(sels: list, cmd=None) -> list:
    """Starts U_RANKS processes at once, each `cmd` (this script by
    default) with ``--u-rank r --u-dir DIR``, t1's Selections in DIR; the
    records they write there, in rank order."""
    cmd = cmd or [sys.executable, os.path.abspath(__file__)]
    with tempfile.TemporaryDirectory(prefix="phase_u_") as tmp:
        torch.save({"sels": sels}, os.path.join(tmp, "t1.pt"))
        procs = [subprocess.Popen(
            cmd + ["--u-rank", str(r), "--u-dir", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(U_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                for r in range(U_RANKS)]


def u_agree(got, want) -> dict:
    """max |got - want| beside TOL·max(1, max|want|), and whether the
    rows' argmax agree."""
    return dict(max_abs_err=_err(got, want),
                tol=TOL * max(1.0, float(want.abs().max())),
                same_argmax=bool(torch.equal(got.argmax(-1),
                                             want.argmax(-1))),
                finite=bool(torch.isfinite(got).all()))


def u_summary(ranks: list) -> dict:
    """Each rank's record held to rank 0's world of one: the logits'
    agreement, the routing flips, the tokens, whisper's decode steps, the
    first step's gradient gap; the tensors dropped (a JSON-able
    record)."""
    one = {name: ranks[0][name].pop("world_of_one") for name in U_SERVED}
    dse_one = ranks[0]["dse"].pop("world_of_one")
    out = {}
    for r in ranks:
        rec = dict(rank=r["rank"], coordinate=r["coordinate"])
        for name in U_SERVED:
            run, pre = dict(r[name]), r[name]["prefill"]
            run["prefill"] = dict(
                ms=pre["ms"], split=pre["split"], launches=pre["launches"],
                max_memory_allocated=pre["max_memory_allocated"],
                heads=sorted(set(pre["heads"])),
                flash_launches=len(pre["heads"]), kernels=pre["kernels"],
                routing_flips=routing_flips(pre["routes"], one[name][
                    "routes"][:len(pre["routes"])]),
                **u_agree(pre["logits"], one[name]["logits"]))
            if "engine" in run:
                run["engine"] = dict(run["engine"], same_tokens=(
                    run["engine"]["tokens"] == one[name]["engine"]["tokens"]))
                run["engine"]["tokens"] = {
                    str(k): v for k, v in run["engine"]["tokens"].items()}
            if "decode" in run:
                dec = dict(run["decode"])
                run["decode"] = dict(
                    {k: v for k, v in dec.items() if k != "logits"},
                    **u_agree(dec["logits"], one[name]["decode"]["logits"]))
            rec[name] = run
        for name in U_TRAINED:
            tr, tr0 = r[name]["train"], ranks[0][name]["train"]
            rec.setdefault(name, {k: v for k, v in r[name].items()
                                  if k != "train"})
            rec[name]["train"] = dict(
                {k: v for k, v in tr.items()
                 if k not in ("routes", "replicated_sha256",
                              "world_of_one")},
                routing_flips_vs_rank0=routing_flips(tr["routes"],
                                                     tr0["routes"]),
                replicated_leaves=len(tr["replicated_sha256"]),
                same_replicated_bits=(tr["replicated_sha256"]
                                      == tr0["replicated_sha256"]))
        dse = r["dse"]
        rec["dse"] = dict(explore=dse["explore"], train=dict(
            ms_per_step=dse["train"]["ms_per_step"],
            launches=dse["train"]["launches"],
            first_step_gap=first_step_gap(dse["train"]["first"],
                                          dse_one["first"])))
        out[f"rank {r['rank']}"] = rec
    world = dict(prefill_ms=one["lm"]["ms"],
                 engine_ms_per_step=one["lm"]["engine"]["ms_per_step"],
                 engine_first_step_ms=one["lm"]["engine"]["first_step_ms"],
                 moe_prefill_ms=one["moe"]["ms"],
                 train_ms_per_step=dse_one["ms_per_step"],
                 **{f"{name}_prefill_ms": one[name]["ms"]
                    for name in U_SERVED if name not in ("lm", "moe")},
                 **{f"{name}_engine_ms_per_step": one[name]["engine"][
                     "ms_per_step"] for name in U_SERVED
                    if name != "lm" and "engine" in one[name]},
                 whisper_decode={k: one["whisper"]["decode"][k] for k in (
                     "encode_ms", "ms_per_step", "launches")},
                 **{f"{name}_train": ranks[0][name]["train"]["world_of_one"]
                    for name in U_TRAINED})
    return dict(world_of_one=world, ranks=out)


def u_failures(ranks: dict) -> list:
    """The gates of phase u that the ranks' records (``u_summary``'s) miss
    (none: held).

    - the ranks sit at 'model' coordinates 0 and 1;
    - each rank keeps exactly its spec blocks' bytes of the params (and
      of the Engine's or whisper's decode states); stablelm's and
      mixtral's blocks are under 0.55 of their full params' (whisper's
      vocab does not divide, so its table stays whole: 0.57); the card
      holds little more for a rank once the full tree is dropped;
    - each prefill runs flash once an attention layer (whisper's encoder,
      decoder and cross-attention each) on ``u_heads`` q heads a launch
      (H/2, or all 25 of hymba's), hymba's selective scan once a layer on
      Di/2 = 1600 channels, xlstm's sLSTM once a repeat on its 4 heads
      (replicated); the logits are finite, within TOL·max(1, max|logit|)
      of rank 0's world of one, with the same argmax;
    - the Engine's 8 steps give the world of one's tokens (stablelm,
      hymba, xlstm), xlstm's an sLSTM launch a step (hymba's SSM step
      is plain ops); whisper's 8 decode steps after one ``encode`` give
      its logits within the same tolerance, with the 448 x 1500 and 1 x
      1500 cross-attention launched;
    - explore_batch's Selections are t1's, bit for bit, with the whole MLP
      launched; train_gan's first step's gradients and losses are the
      world of one's within T_GRAD_TOL, with the three dense kernels
      launched;
    - every train step on the blocks (``u_train_failures``)."""
    bad = []
    for tag, r in ranks.items():
        if r["coordinate"] != (0, r["rank"]):
            bad.append(f"{tag}: coordinate {r['coordinate']}")
        for name in U_SERVED + ("hymba_train",):
            run = r[name]
            if run["param_bytes"] != run["spec_block_bytes"]:
                bad.append(f"{tag}: {name} param bytes")
            if name in ("lm", "moe") and not (
                    run["param_bytes"] < 0.55 * run["full_param_bytes"]):
                bad.append(f"{tag}: {name} keeps more than its blocks")
            held = run["param_bytes"] + run.get("state_bytes", 0)
            if not run["memory_allocated"] < held + (256 << 20):
                bad.append(f"{tag}: {name} memory_allocated")
            if "state_bytes" in run and run["state_bytes"] != run[
                    "state_spec_block_bytes"]:
                bad.append(f"{tag}: {name} decode state bytes")
            if name not in U_SERVED:
                continue
            pre, want = run["prefill"], run["expect"]
            if pre["heads"] != (want["heads"] if want["flash"] else []) \
                    or pre["flash_launches"] != want["flash"]:
                bad.append(f"{tag}: {name} flash heads {pre['heads']} x "
                           f"{pre['flash_launches']}")
            k = pre["kernels"]
            if (k["ssm"]["n"], k["ssm"]["shapes"]) != (
                    want["ssm"], want["ssm_channels"]) or (
                    k["slstm"]["n"], k["slstm"]["shapes"]) != (
                    want["slstm"], want["slstm_heads"]):
                bad.append(f"{tag}: {name} scans {k['ssm']} {k['slstm']}")
            if not (pre["finite"] and pre["same_argmax"]
                    and pre["max_abs_err"] <= pre["tol"]):
                bad.append(f"{tag}: {name} logits")
            if "engine" in run:
                eng = run["engine"]
                if not eng["same_tokens"] or eng["iters"] != 8:
                    bad.append(f"{tag}: {name} Engine tokens")
                # a decode step's SSM step is plain ops; its sLSTM step
                # the kernel at S = 1
                if eng["launches"]["ssm_scan_f32"] != 0 or \
                        eng["launches"]["slstm_scan_f32"] != \
                        8 * want["slstm"]:
                    bad.append(f"{tag}: {name} Engine scans")
            if "decode" in run:
                dec = run["decode"]
                cross = {(h, sq, sk) for h, sq, sk in pre["kernels"][
                    "flash"]["shapes"]}
                if not (dec["finite"] and dec["same_argmax"]
                        and dec["max_abs_err"] <= dec["tol"]) or (
                        want["heads"][0], U_WHISPER_PREFILL[1],
                        U_WHISPER_FRAMES) not in cross or (
                        want["heads"][0], 1, U_WHISPER_FRAMES) not in {
                        tuple(t) for t in dec["kernels"]["flash"]["shapes"]}:
                    bad.append(f"{tag}: {name} decode")
        ex, tr = r["dse"]["explore"], r["dse"]["train"]
        if not ex["same_as_t1"]:
            bad.append(f"{tag}: Selections")
        if not ex["launches"]["mlp_forward_f32"]:
            bad.append(f"{tag}: mlp_forward_f32 not launched")
        gap = tr["first_step_gap"]
        if not max(gap.values()) <= T_GRAD_TOL:
            bad.append(f"{tag}: train_gan's first step {gap}")
        for name in DENSE_KERNELS:
            if not tr["launches"][name]:
                bad.append(f"{tag}: {name} not launched")
        bad += u_train_failures(tag, r)
    return bad


def u_train_failures(tag: str, r: dict) -> list:
    """The train gates of ``u_failures`` on one rank's record (of
    ``u_summary``): every model of U_TRAINED trained on the blocks (remat
    on, act_shard 'model'): the loss within 1e-5 relative of the world of
    one's, every gradient block within U_GRAD_TOL of its leaf's norm
    (floored at U_GRAD_FLOOR of the whole gradient's), the global norm of
    the blocks within 1e-4 relative; every replicated leaf
    the same bits on both ranks after the step; flash with lse on
    ``u_heads`` q heads twice an attention (the forward and the remat
    recompute), the selective scan's forward twice a layer and its
    backward once on 1600 channels, the sLSTM's likewise on its 4 heads;
    params, mu and nu each the spec blocks' bytes; mixtral's E/2 experts
    a rank, routed alike on both ranks."""
    bad = []
    for name, arch in U_TRAINED.items():
        tr, cfg = r[name]["train"], configs.get_arch(arch).segments[
            0].pattern[0].cfg
        want = tr["expect"]
        if not abs(tr["loss"] - tr["world_loss"]) <= 1e-5 * abs(
                tr["world_loss"]):
            bad.append(f"{tag}: {name} loss {tr['loss']} vs "
                       f"{tr['world_loss']}")
        if not tr["max_grad_block_err"] <= U_GRAD_TOL:
            bad.append(f"{tag}: {name} gradient leaf {tr['worst_leaf']}"
                       f" {tr['max_grad_block_err']} of its norm")
        if not abs(tr["grad_norm"] - tr["world_grad_norm"]) <= 1e-4 * \
                tr["world_grad_norm"]:
            bad.append(f"{tag}: {name} global norm")
        if not tr["same_replicated_bits"]:
            bad.append(f"{tag}: {name} replicated leaves' bits")
        # remat: each attention's flash runs in the forward and again in
        # the backward's recompute, always with lse; the scans likewise
        if tr["heads"] != (want["heads"] if want["flash"] else []) or not (
                tr["flash_launches"] == 2 * want["flash"] == tr["launches"][
                    "flash_attention_f32 with lse"]):
            bad.append(f"{tag}: {name} flash heads {tr['heads']} x "
                       f"{tr['flash_launches']}")
        k, n = tr["kernels"], tr["launches"]
        if (n["ssm_scan_f32"], n["ssm_scan_bwd_f32"], k["ssm"]["shapes"]) \
                != (2 * want["ssm"], want["ssm"], want["ssm_channels"]) or (
                    n["slstm_scan_f32"], n["slstm_scan_bwd_f32"],
                    k["slstm"]["shapes"]) != (
                    2 * want["slstm"], want["slstm"], want["slstm_heads"]):
            bad.append(f"{tag}: {name} scans {n} {k['ssm']} {k['slstm']}")
        if not (tr["param_bytes"] == tr["mu_bytes"] == tr["nu_bytes"]
                == tr["spec_block_bytes"]):
            bad.append(f"{tag}: {name} bytes kept")
        if cfg.n_experts and (tr["experts_per_rank"] != cfg.n_experts
                              // U_RANKS or any(
                                  tr["routing_flips_vs_rank0"])):
            bad.append(f"{tag}: {name} experts or routing flips")
    return bad


def phase_u(t1_state: dict) -> dict:
    """Phase u: U_RANKS ranks on the one card (gloo, both ``cuda:0``),
    rank 0 also running the world of one, held by ``u_failures``; times
    beside the card's name and power limit."""
    t0 = time.perf_counter()
    out = u_summary(run_u_ranks(t1_state["sels"][N_TASKS]))
    out.update(card=smi(), seconds=time.perf_counter() - t0,
               moe_reduced=dict(n_layers=MOE_LAYERS,
                                of=configs.get_arch(MOE_ARCH).n_layers),
               hymba_train_reduced=dict(
                   n_layers=u_hymba_train_cut().n_layers,
                   of=configs.get_arch(HYMBA_ARCH).n_layers,
                   why="a global and a local layer: the script's time"),
               xlstm_reduced=dict(
                   n_layers=U_XLSTM_REPEATS * len(configs.get_arch(
                       XLSTM_ARCH).segments[0].pattern),
                   of=configs.get_arch(XLSTM_ARCH).n_layers,
                   why="float32's conditioning at depth (ROADMAP Queue 3 "
                       "item 6)"))
    print("phase u: " + json.dumps(out), flush=True)
    failed = u_failures(out["ranks"])
    assert not failed, failed
    print(f"phase u: {out['seconds']:.1f} s on {out['card']}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase s4: the cost tools across a mesh (launch/perf --mesh-shape) beside
# phase u's measured collectives
# ---------------------------------------------------------------------------
#: phase u's stablelm cells that s4 counts: label -> (shape name, (B, S))
S4_CELLS = {"prefill": ("prefill_32k", U_PREFILL),
            "train": ("train_4k", U_LM_TRAIN)}


def start_s4() -> tuple:
    """Phase s4's counts, started with the script beside s2's (they need
    no card, and the script's own process will hold t1's group, which a
    counting world may not meet): ``launch/perf --mesh-shape 1xU_RANKS
    --dtype float32`` on U_ARCH's S4_CELLS (remat on, act_shard 'model',
    one microbatch: phase u's knobs), one process a cell.  Returns ({label:
    (the row's file, the process)}, their directory)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="1")
    tmp = tempfile.mkdtemp(prefix="phase_s4_")
    procs = {}
    for label, (name, (b, s_)) in S4_CELLS.items():
        path = os.path.join(tmp, f"{label}.jsonl")
        procs[label] = (path, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.perf", "--arch",
             U_ARCH, "--shape", name, "--batch", str(b), "--seq", str(s_),
             "--mesh-shape", f"1x{U_RANKS}", "--dtype", "float32", "--out",
             path], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, tmp


def s4_rows(started: tuple) -> dict:
    """Each S4_CELLS row of the processes `start_s4` started."""
    rows = {}
    for label, (path, p) in started[0].items():
        log = p.communicate(timeout=300)[0]
        assert p.returncode == 0, log[-4000:]
        with open(path) as fh:
            rows[label] = json.loads(fh.readline())
    return rows


def stop_s4(started: tuple) -> None:
    """Ends `start_s4`'s processes where they still run and removes their
    directory."""
    for _, p in started[0].values():
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(started[1], ignore_errors=True)


def phase_s4(model_run: dict, started: tuple) -> dict:
    """Phase s4: the counted collectives of phase u's stablelm prefill and
    train step on its (1, U_RANKS) mesh (`start_s4`'s processes, rank 0
    of a fake world of U_RANKS on meta) held equal to what phase u
    measured on each rank: its ``PAR._all_gather`` and ``_all_reduce``
    calls and the bytes of their results, the train step's global norm
    (``norm_split``) included; beside them each rank's
    ``max_memory_allocated`` against the counted peak and phase u's ms
    against the counted ``t_bound``, with the card's name and power
    limit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed import fake_pg

    t0 = time.perf_counter()
    rows = s4_rows(started)
    out = dict(fake_backend=dict(module=fake_pg.__name__,
                                 torch=torch.__version__,
                                 backends=list(dist.Backend.backend_list)),
               card=smi(), counted={k: {f: r[f] for f in (
                   "n_coll", "coll_bytes", "collectives", "bytes_per_device",
                   "t_bound", "t_collective_s", "bottleneck", "trace_s",
                   "mesh", "rank")} for k, r in rows.items()}, ranks={})
    failed = []
    for name, r in model_run["ranks"].items():
        lm = r["lm"]
        measured = {"prefill": (lm["prefill"]["split"], None,
                                lm["prefill"]["ms"],
                                lm["prefill"]["max_memory_allocated"]),
                    "train": (lm["train"]["split"],
                              lm["train"]["norm_split"],
                              lm["train"]["ms_per_step"],
                              lm["train"]["max_memory_allocated"])}
        out["ranks"][name] = {}
        for label, (split, norm, ms, peak) in measured.items():
            row = rows[label]
            calls = split["collective_calls"] + (
                norm["collective_calls"] if norm else 0)
            n_bytes = split["collective_bytes"] + (
                norm["collective_bytes"] if norm else 0)
            rec = dict(measured_calls=calls, counted_calls=row["n_coll"],
                       measured_bytes=n_bytes,
                       counted_bytes=row["coll_bytes"],
                       max_memory_allocated=peak,
                       counted_peak_bytes=row["bytes_per_device"],
                       ms=ms, t_bound_ms=1e3 * row["t_bound"],
                       ms_over_t_bound=ms / (1e3 * row["t_bound"]))
            out["ranks"][name][label] = rec
            if calls != row["n_coll"] or n_bytes != row["coll_bytes"]:
                failed.append((name, label, rec))
    out["seconds"] = time.perf_counter() - t0
    print("phase s4: " + json.dumps(out), flush=True)
    assert not failed, failed
    print(f"phase s4: {out['seconds']:.1f} s on {out['card']}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the measurements to this JSON")
    ap.add_argument("--count-paths", metavar="JSON",
                    help="only phase s2's counts on meta (the script starts "
                    "this itself)")
    ap.add_argument("--t2-rank", type=int,
                    help="one rank of phase t2 (the script starts them)")
    ap.add_argument("--t2-dir", help="phase t2's store and results")
    ap.add_argument("--u-rank", type=int,
                    help="one rank of phase u (the script starts them)")
    ap.add_argument("--u-dir", help="phase u's store and results")
    args = ap.parse_args()
    if args.count_paths:
        count_paths(args.count_paths)
        return 0
    if args.t2_rank is not None:
        return t2_rank(args.t2_rank, args.t2_dir)
    if args.u_rank is not None:
        return u_rank(args.u_rank, args.u_dir)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    counting = start_counting()
    s4 = start_s4()
    try:
        return run_phases(args, counting, s4)
    finally:
        if counting[0].poll() is None:
            counting[0].kill()
            counting[0].wait()
        stop_s4(s4)


def run_phases(args, counting: tuple, s4: tuple) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def elapsed(label: str) -> None:
        print(f"chip_smoke: {label} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    card = smi()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # phase 1: build every kernel, one nvcc per source, in parallel
    flash_build, slstm_build = build_all()
    spills = check_spills([src for src, _, _ in SPILL_CHECKS if src not in (
        "flash_attention.cu", "slstm_scan.cu")])

    elapsed("phase 2")
    # phase 2: each kernel against its plain version; one full-width step
    kern = check_kernel()
    dense = check_dense()
    step = check_step(Im2colModel())

    elapsed("phase 3")
    # phase 3: the serving path, counts zeroed just before it
    zero_counts()
    runs = {"dnnweaver": drive_path(DnnWeaverModel()),
            "im2col": drive_path(Im2colModel())}
    serve_launches = counts()
    print(f"launches on the serving path: {json.dumps(serve_launches)}",
          flush=True)
    assert serve_launches["mlp_forward_f32"] > 0, \
        "the serving path never launched the whole-MLP kernel"
    paths = {name: check_path(name, run) for name, run in runs.items()}
    for name, run in runs.items():
        paths[name]["profile"] = profile_path(name, run)

    elapsed("phase a")
    # phase a: the dense route on the same engines, counts zeroed just
    # before it
    zero_counts()
    dense_route = {name: drive_dense(name, run) for name, run in runs.items()}
    dense_launches = counts()
    print(f"launches on the dense route: {json.dumps(dense_launches)}",
          flush=True)
    assert dense_launches["mlp_forward_f32"] > 0, \
        "the dense route never launched the whole-MLP kernel"

    elapsed("phase 4")
    # phase 4: the training path, counts zeroed just before it
    zero_counts()
    train = drive_train(Im2colModel())
    train_launches = counts()
    print(f"launches on the training path: {json.dumps(train_launches)}",
          flush=True)
    print("GANDSE.train im2col: " + json.dumps(
        {k: v for k, v in train.items() if k != "history"}), flush=True)
    for name in DENSE_KERNELS:
        assert train_launches[name] > 0, f"training never launched {name}"
    assert train_launches["mlp_forward_f32"] > 0, \
        "explore_batch on the trained G never launched the whole-MLP kernel"

    elapsed("phase 5")
    # phase 5: quality at the reference's reduced scale
    quality = quality_run()

    elapsed("phase b")
    # phase b: the whole MLP's gradient at LargeMLP's shapes
    mlp_grad = check_mlp_grad(Im2colModel())

    elapsed("phase c")
    # phase c: LargeMLP at full width: one step against the plain route
    # and float64, the 17-layer whole MLP, then train + explore with the
    # counts zeroed just before
    mlp_step = check_mlp_step(Im2colModel())
    mlp_chain = check_mlp_chain(Im2colModel())
    zero_counts()
    mlp_run = drive_mlp(Im2colModel())
    baseline_launches = counts()
    print(f"launches on the baseline path: {json.dumps(baseline_launches)}",
          flush=True)
    print("LargeMLP im2col: " + json.dumps(mlp_run), flush=True)
    for name in ("mlp_forward_f32", *DENSE_KERNELS):
        assert baseline_launches[name] > 0, \
            f"LargeMLP's train and explore never launched {name}"

    elapsed("phase d")
    # phase d: DRL's rollout and SA on the card against the CPU port
    drl_sa = drive_drl_sa()

    elapsed("phase e")
    # phase e: Table 5 on dnnweaver, GANDSE's row from phase 5
    t5 = table5(quality)

    elapsed("phases f-h")
    # phases f-h: the DSE serving tier at G 11 x 2048, counts zeroed just
    # before each
    serve_sync = drive_serve_sync()
    serve_conc = drive_serve_concurrent()
    online_run = drive_online(step["launches"])

    elapsed("phase 6")
    # phase 6: flash against its plain version (its build ran on beside
    # phases 2-h), then the LM serving path at full width, counts zeroed
    # just before its prefill (inside drive_prefill)
    flash_build.result()
    print_builds(["flash_attention.cu"])
    spills.update(check_spills(["flash_attention.cu"]))
    flash = check_flash()
    m, params = lm_model()
    prefill = drive_prefill(m, params)
    lm_serve = drive_serve(m, params)
    del params
    per_prefill = {                    # the layers' kernel medians summed
        k: sum(n * flash[label, "float32"][k] for label, n in (
            ("gemma3 global 2x4x4096x256", 4),
            ("gemma3 local 2x4x4096x256 w1024", 22)))
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_4d_ms")}
    print("flash per prefill (4 global + 22 local layers): "
          + json.dumps(per_prefill), flush=True)
    torch.cuda.empty_cache()

    elapsed("phases i-k")
    # phases i-k: LM training; the train steps' and the launcher's counts
    # zeroed just before each (inside check_lm_train, drive_lm_launcher)
    flash_grad = check_flash_grad()
    lm_train = check_lm_train()
    lm_launcher = drive_lm_launcher()

    elapsed("phase l")
    # phase l: the MoE decoders, once phase j's state is freed; the
    # launches of each path counted from zero just before it (inside
    # drive_prefill, drive_moe_serve and check_moe_train)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase l starts with {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated", flush=True)
    zero_counts()
    moe_layers = {arch: check_moe_layer(arch) for arch in MOE_LAYER_ARCHS}
    moe_layer_launches = counts()
    m, params, reduced = moe_model(MOE_LAYERS)
    moe_prefill = dict(drive_prefill(m, params, "moe prefill"),
                       reduced=reduced)
    moe_serve = dict(drive_moe_serve(m, params), reduced=reduced)
    gc.collect()
    torch.cuda.empty_cache()
    moe_train = check_moe_train(m, params, reduced)   # updates params
    del params

    elapsed("phase m")
    # phase m: hymba-1.5b at full width, once phase l's state is freed;
    # the prefill's and the Engine's launches counted from zero just
    # before each (inside drive_prefill and drive_hymba_serve)
    gc.collect()
    torch.cuda.empty_cache()
    m, params, hymba_init = hymba_model()
    ssm = check_ssm_scan(m, params)
    hymba_prefill = drive_prefill(m, params, "hymba prefill")
    hymba_serve = drive_hymba_serve(m, params)

    elapsed("phase n")
    # phase n: hymba-1.5b training on phase m's params (the train step
    # updates them in place, so it runs last); the gradient's, the train
    # steps' and the launcher's counts zeroed just before each (inside
    # check_hymba_grad, check_hymba_train and drive_lm_launcher)
    ssm_bwd = check_ssm_bwd(m, params)
    hymba_grad = check_hymba_grad(m, params)
    hymba_train = check_hymba_train(m, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    hymba_launcher = drive_lm_launcher(
        HYMBA_LAUNCHER_ARGV, "hymba launcher",
        ("flash_attention_f32 with lse", "ssm_scan_f32", "ssm_scan_bwd_f32"))

    elapsed("phase o")
    # phase o: xlstm-1.3b at full width, once phase n's state is freed; the
    # prefill's and the Engine's launches counted from zero just before
    # each (inside drive_prefill and drive_xlstm_serve)
    gc.collect()
    torch.cuda.empty_cache()
    slstm_build.result()
    print_builds(["slstm_scan.cu"])
    spills.update(check_spills(["slstm_scan.cu"]))
    m, params, xlstm_init = xlstm_model()
    slstm = check_slstm_scan(m, params)
    xlstm_layers = check_xlstm_layers(m, params)
    served = cut_repeats(m, params, XLSTM_SERVE_REPEATS)
    reduced = dict(n_layers=served[0].n_layers, of=m.n_layers,
                   why="the script's time limit")
    xlstm_prefill = dict(drive_xlstm_prefill(*served), reduced=reduced)
    xlstm_serve = dict(drive_xlstm_serve(*served), reduced=reduced)
    del served

    # phase p: xlstm-1.3b training on phase o's params (the train step
    # updates them in place, so it runs last); the gradient's, the train
    # steps' and the launcher's counts zeroed just before each (inside
    # check_xlstm_grad, check_xlstm_train and drive_lm_launcher)
    elapsed("phase p")
    slstm_bwd = check_slstm_bwd(m, params)
    elapsed("p2")
    xlstm_grad = check_xlstm_grad(m, params)
    elapsed("p3")
    xlstm_train = check_xlstm_train(m, params)
    elapsed("p4")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    xlstm_launcher = drive_lm_launcher(
        XLSTM_LAUNCHER_ARGV, "xlstm launcher",
        ("slstm_scan_f32", "slstm_scan_bwd_f32"))

    elapsed("phase q")
    # phase q: whisper-small at full width, once phase p's state is freed;
    # the encoder's, the prefill's, the decode loop's, the gradient's and
    # the train steps' launches counted from zero just before each (inside
    # drive_whisper_serve, check_whisper_grad and check_whisper_train)
    gc.collect()
    torch.cuda.empty_cache()
    whisper_flash = check_flash_at(WHISPER_FLASH_SHAPES,
                                   WHISPER_FLASH_GRAD_SHAPES)
    m, params, whisper_init = whisper_model()
    whisper_serve = drive_whisper_serve(m, params)
    elapsed("q3")
    whisper_grad = check_whisper_grad(m, params)
    whisper_train = check_whisper_train(m, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    elapsed("phase r")
    # phase r: qwen2-vl-7b at full width, once phase q's state is freed;
    # each path's launches counted from zero just before it (inside
    # drive_prefill, phase_r and check_qwen_train)
    qwen = phase_r()

    elapsed("phase s")
    # phase s: the cost tools beside the card, once phase r's state is
    # freed; s2's counts were made beside phases 2-r, s3's launches
    # counted from zero just before each variant (inside perf_sweep)
    gc.collect()
    torch.cuda.empty_cache()
    measured = {   # label: (the time its phase measured, its hand bound)
        "prefill": (prefill["kernel_ms_per_prefill"],
                    prefill["bound_ms_per_prefill"]),
        "serve": (lm_serve["ms_per_decode_step"], lm_serve["weights_read_ms"]),
        "lm train": (lm_train["ms_per_step"], lm_train["bound_ms_per_step"]),
        **{f"moe layer {a}": (r["ms"], r["bound_ms"])
           for a, r in moe_layers.items()},
        "moe prefill": (moe_prefill["kernel_ms_per_prefill"],
                        moe_prefill["bound_ms_per_prefill"]),
        "moe serve": (moe_serve["ms_per_decode_step"],
                      moe_serve["weights_read_ms"]),
        "moe train": (moe_train["ms_per_step"],
                      moe_train["bound_ms_per_step"]),
        "hymba prefill": (hymba_prefill["kernel_ms_per_prefill"],
                          hymba_prefill["bound_ms_per_prefill"]),
        "hymba serve": (hymba_serve["ms_per_decode_step"],
                        hymba_serve["weights_read_ms"]),
        "hymba train": (hymba_train["ms_per_step"],
                        hymba_train["bound_ms_per_step"]),
        "xlstm prefill": (xlstm_prefill["kernel_ms_per_prefill"],
                          xlstm_prefill["bound_ms_per_prefill"]),
        "xlstm serve": (xlstm_serve["ms_per_decode_step"],
                        xlstm_serve["weights_read_ms"]),
        "xlstm train": (xlstm_train["ms_per_step"],
                        xlstm_train["bound_ms_per_step"]),
        "whisper encode": (whisper_serve["encode"]["ms"], sum(
            whisper_serve["encode"]["bound_ms"].values())),
        "whisper prefill": (whisper_serve["prefill"]["kernel_ms_per_prefill"],
                            whisper_serve["prefill"]["bound_ms_per_prefill"]),
        "whisper decode": (whisper_serve["decode"]["ms_per_decode_step"],
                           whisper_serve["decode"]["bound_ms_per_step"]),
        "whisper train": (whisper_train["ms_per_step"],
                          whisper_train["bound_ms_per_step"]),
        "qwen prefill": (qwen["prefill"]["kernel_ms_per_prefill"],
                         qwen["prefill"]["bound_ms_per_prefill"]),
        "qwen prefill vision": (
            qwen["prefill_vision"]["kernel_ms_per_prefill"],
            qwen["prefill_vision"]["bound_ms_per_prefill"]),
        "qwen serve": (qwen["serve"]["ms_per_decode_step"],
                       qwen["serve"]["weights_read_ms"]),
        "qwen train": (qwen["train"]["ms_per_step"],
                       qwen["train"]["bound_ms_per_step"]),
    }
    trained = {label: r["n_params"] for label, r in (
        ("lm train", lm_train), ("moe train", moe_train),
        ("hymba train", hymba_train), ("xlstm train", xlstm_train),
        ("whisper train", whisper_train), ("qwen train", qwen["train"]))}
    cost = phase_s(counting, measured, trained)
    sweep_launches = {label: r["flash_attention_f32 with lse"]
                      for label, r in cost["perf"]["launches"].items()}

    elapsed("phase t")
    # phase t: the multi-rank half; each path's launches counted from zero
    # just before it (inside t_explore, t_train and drive_train_lm_example)
    gc.collect()
    torch.cuda.empty_cache()
    mesh_run, t1_state = phase_t(runs["im2col"]["engine"],
                                 runs["im2col"]["warm"])

    elapsed("phase u")
    # phase u: serving and training across a 'model' axis, two ranks on
    # the card; each rank's launches counted from zero just before each
    # path (inside u_engine, u_prefill, u_dse, t_train and u_train)
    gc.collect()
    torch.cuda.empty_cache()
    model_run = phase_u(t1_state)
    u_ranks = list(model_run["ranks"].values())

    elapsed("phase s4")
    # phase s4: launch/perf's counts of phase u's stablelm steps on its
    # mesh (made on meta in processes started with the script), beside
    # what phase u measured
    cost_mesh = phase_s4(model_run, s4)
    print("init seconds on the card: " + json.dumps(INIT_S), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s to here",
          flush=True)

    row = kern["im2col", N_TASKS]
    table = {"kernels": [{
        "name": "mlp_forward_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mlp_forward.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:273",
        "launches": serve_launches["mlp_forward_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "im2col_m1024": kern["im2col", 1024],
        "dnnweaver_m64": kern["dnnweaver", N_TASKS],
        "largemlp_17_layers_m64": mlp_chain[N_TASKS],
        "largemlp_17_layers_m1024": mlp_chain[1024],
        "launches_by_path": {
            "serving": serve_launches["mlp_forward_f32"],
            "dense_route": dense_launches["mlp_forward_f32"],
            "training": train_launches["mlp_forward_f32"],
            "baseline": baseline_launches["mlp_forward_f32"],
            "whole_mlp_gradient": mlp_grad["launches"]["mlp_forward_f32"],
            "dse_serve_sync": serve_sync["launches"]["mlp_forward_f32"],
            "dse_serve_concurrent":
                serve_conc["launches"]["mlp_forward_f32"],
            "dse_serve_faults":
                serve_conc["faults"]["launches"]["mlp_forward_f32"],
            "online": online_run["launches"]["mlp_forward_f32"],
            "task_mesh_t1": mesh_run["t1"]["explore"][N_TASKS]["launches"][
                "mlp_forward_f32"],
            "task_mesh_t2": {r: t["explore"][str(N_TASKS)]["launches"][
                "mlp_forward_f32"] for r, t in mesh_run["t2"].items()}},
        "model_axis": {f"rank {r['rank']}": dict(
            launches=r["dse"]["explore"]["launches"]["mlp_forward_f32"],
            ms_per_task=r["dse"]["explore"]["ms_per_task"])
            for r in u_ranks},
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dense_train.cu",
        "replaces": replaces,
        "launches": train_launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in dense[name].values()),
        **{k: v for k, v in dense[name]["hidden 2048->2048"].items()
           if k != "max_abs_err"},
        "launches_per_step": step["launches"][name],
        "launches_per_largemlp_step": mlp_step["launches"][name],
        "launches_by_path": {
            "training": train_launches[name],
            "baseline": baseline_launches[name],
            "drl_rollout": drl_sa["DRL"]["launches"][name],
            "whole_mlp_gradient": mlp_grad["launches"][name],
            "online": online_run["launches"][name],
            "data_parallel_t1": mesh_run["t1"]["train"]["launches"][name],
            "data_parallel_t2": {r: t["train"]["launches"][name]
                                 for r, t in mesh_run["t2"].items()}},
        "model_axis": {f"rank {r['rank']}": dict(
            launches=r["dse"]["train"]["launches"][name],
            ms_per_step=r["dse"]["train"]["ms_per_step"]) for r in u_ranks},
        "shapes": {label: dense[name][label] for label in DENSE_SHAPES
                   if label != "hidden 2048->2048"},
    } for name, (_, replaces) in DENSE_KERNELS.items()] + [{
        "name": "flash_attention_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "launches": prefill["launches"]["flash_attention_f32"],
        "max_abs_err": max([r["max_abs_err"] for (_, t), r in flash.items()
                            if t == "float32"]
                           + [r["max_abs_err"] for r in
                              qwen["flash"]["forward"].values()]),
        **{k: flash["gemma3 global 2x4x4096x256", "float32"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "bound_4d_ms")},
        "per_prefill": per_prefill,
        "model_axis": {f"rank {r['rank']}": {
            **{name: {k: r[name]["prefill"][k] for k in (
                "flash_launches", "heads", "ms", "max_abs_err", "tol")}
               for name in U_SERVED},
            "whisper_decode": r["whisper"]["decode"]["kernels"]["flash"],
            **{f"{name}_train": {
                "flash_launches": r[name]["train"]["flash_launches"],
                "lse_launches": r[name]["train"]["launches"][
                    "flash_attention_f32 with lse"],
                "heads": r[name]["train"]["heads"],
                "ms_per_step": r[name]["train"]["ms_per_step"]}
               for name in U_TRAINED}} for r in u_ranks},
        "launches_by_path": {
            "prefill": prefill["launches"]["flash_attention_f32"],
            "lm_train_steps": lm_train["launches"]["flash_attention_f32"],
            "lm_launcher": {k: r["launches"]["flash_attention_f32"]
                            for k, r in lm_launcher.items()},
            "moe_layer": moe_layer_launches["flash_attention_f32"],
            "moe_prefill": moe_prefill["launches"]["flash_attention_f32"],
            "moe_engine": moe_serve["launches"]["flash_attention_f32"],
            "moe_train_steps":
                moe_train["launches"]["flash_attention_f32"],
            "hymba_prefill": hymba_prefill["launches"]["flash_attention_f32"],
            "hymba_engine": hymba_serve["launches"]["flash_attention_f32"],
            "hymba_train_steps":
                hymba_train["launches"]["flash_attention_f32"],
            "whisper_encode":
                whisper_serve["encode"]["launches"]["flash_attention_f32"],
            "whisper_prefill":
                whisper_serve["prefill"]["launches"]["flash_attention_f32"],
            "whisper_decode_steps":
                whisper_serve["decode"]["launches"]["flash_attention_f32"],
            "whisper_train_steps":
                whisper_train["launches"]["flash_attention_f32"],
            "qwen_prefill": qwen["prefill"]["launches"]["flash_attention_f32"],
            "qwen_prefill_vision":
                qwen["prefill_vision"]["launches"]["flash_attention_f32"],
            "qwen_engine": qwen["serve"]["launches"]["flash_attention_f32"],
            "qwen_train_steps":
                qwen["train"]["launches"]["flash_attention_f32"],
            "perf_sweep": {label: r["flash_attention_f32"]
                           for label, r in cost["perf"]["launches"].items()}},
        "lse_launches_by_path": {
            "lm_train_steps":
                lm_train["launches"]["flash_attention_f32 with lse"],
            "moe_train_steps":
                moe_train["launches"]["flash_attention_f32 with lse"],
            "hymba_train_steps":
                hymba_train["launches"]["flash_attention_f32 with lse"],
            "whisper_gradient":
                whisper_grad["launches"]["flash_attention_f32 with lse"],
            "whisper_train_steps":
                whisper_train["launches"]["flash_attention_f32 with lse"],
            "qwen_gradient":
                qwen["train"]["grad_launches"]["flash_attention_f32 with lse"],
            "qwen_train_steps":
                qwen["train"]["launches"]["flash_attention_f32 with lse"],
            "qwen_train_microbatches": qwen["train"]["microbatches"][
                "launches"]["flash_attention_f32 with lse"],
            "perf_sweep": sweep_launches,
            "lm_launcher": {k: r["launches"]["flash_attention_f32 with lse"]
                            for k, r in lm_launcher.items()},
            "train_lm_example": mesh_run["t1"]["train_lm"]["launches"][
                "flash_attention_f32 with lse"]},
        "lse": {label: {k: r[k] for k in (
            "fwd_ms", "fwd_lse_ms", "lse_max_rel_err", "out_same_bits_with_lse")}
            for label, r in flash_grad.items()},
        "function_fwd_bwd": {label: {k: r[k] for k in (
            "fwd_bwd_ms", "bwd_ms", "plain_fwd_bwd_ms", "library_fwd_ms",
            "library_fwd_bwd_ms", "bound_ms", "bound_by", "fwd_bound_ms",
            "bwd_bound_ms", "bwd_bound_3xtf32_ms", "max_abs_err_f64",
            "plain_max_abs_err_f64")}
            for label, r in flash_grad.items()},
        "shapes": {f"{label} {t}": r for (label, t), r in flash.items()
                   if (label, t) != ("gemma3 global 2x4x4096x256",
                                     "float32")},
        "whisper_shapes": whisper_flash["forward"],
        "whisper_function_fwd_bwd": {label: {k: r[k] for k in (
            "fwd_bwd_ms", "bwd_ms", "plain_fwd_bwd_ms", "library_fwd_ms",
            "library_fwd_bwd_ms", "bound_ms", "bound_by", "max_abs_err_f64",
            "plain_max_abs_err_f64")}
            for label, r in whisper_flash["grad"].items()},
        "qwen_shapes": qwen["flash"]["forward"],
        "qwen_function_fwd_bwd": {label: {k: r[k] for k in (
            "fwd_bwd_ms", "bwd_ms", "plain_fwd_bwd_ms", "library_fwd_ms",
            "library_fwd_bwd_ms", "bound_ms", "bound_by", "max_abs_err_f64",
            "plain_max_abs_err_f64")}
            for label, r in qwen["flash"]["grad"].items()},
    }, {
        "name": "ssm_scan_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/nn/ssm.py:ssm_scan (its inner lax.scan, "
                    "ssm.py:83-105; no Pallas kernel)",
        "launches": hymba_prefill["launches"]["ssm_scan_f32"],
        **{k: ssm[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "exp_bound_ms",
                               "shape", "max_abs_err_f64",
                               "plain_max_abs_err_f64")},
        "launches_by_path": {
            "hymba_prefill": hymba_prefill["launches"]["ssm_scan_f32"],
            "hymba_engine": hymba_serve["launches"]["ssm_scan_f32"],
            "hymba_gradient": hymba_grad["launches"]["ssm_scan_f32"],
            "hymba_train_steps": hymba_train["launches"]["ssm_scan_f32"],
            "hymba_launcher": {k: r["launches"]["ssm_scan_f32"]
                               for k, r in hymba_launcher.items()}},
        "with_chunk_states_ms": {label: r["fwd_chunks_ms"]
                                 for label, r in ssm_bwd.items()},
        "model_axis": {f"rank {r['rank']}": dict(
            hymba_prefill=r["hymba"]["prefill"]["kernels"]["ssm"],
            hymba_train=r["hymba_train"]["train"]["kernels"]["ssm"])
            for r in u_ranks},
    }, {
        "name": "ssm_scan_bwd_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/nn/ssm.py:ssm_scan (XLA's autodiff of its "
                    "jax.checkpoint-ed inner lax.scan, ssm.py:94-102; no "
                    "Pallas kernel)",
        "launches": hymba_train["launches"]["ssm_scan_bwd_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in ssm_bwd.values()),
        **{k: ssm_bwd["train step"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "bound_with_partials_ms", "exp_bound_ms", "shape",
            "max_abs_err_f64", "plain_max_abs_err_f64")},
        "shapes": {label: r for label, r in ssm_bwd.items()
                   if label != "train step"},
        "launches_by_path": {
            "hymba_gradient": hymba_grad["launches"]["ssm_scan_bwd_f32"],
            "hymba_train_steps":
                hymba_train["launches"]["ssm_scan_bwd_f32"],
            "hymba_launcher": {k: r["launches"]["ssm_scan_bwd_f32"]
                               for k, r in hymba_launcher.items()}},
        "model_axis": {f"rank {r['rank']}": r["hymba_train"]["train"][
            "launches"]["ssm_scan_bwd_f32"] for r in u_ranks},
    }, {
        "name": "slstm_scan_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slstm_scan.cu",
        "replaces": "src/repro/nn/xlstm.py:209-228 (slstm_apply's cell "
                    "under _chunked_scan / lax.scan; no Pallas kernel)",
        "launches": xlstm_prefill["launches"]["slstm_scan_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in slstm.values()),
        **{k: slstm["prefill"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "us_per_step", "max_abs_err_f64", "plain_max_abs_err_f64")},
        "engine_step": slstm["engine"],
        "with_chunk_states_ms": {label: r["fwd_chunks_ms"]
                                 for label, r in slstm_bwd.items()},
        "model_axis": {f"rank {r['rank']}": dict(
            xlstm_prefill=r["xlstm"]["prefill"]["kernels"]["slstm"],
            xlstm_engine=r["xlstm"]["engine"]["launches"]["slstm_scan_f32"],
            xlstm_train=r["xlstm"]["train"]["kernels"]["slstm"])
            for r in u_ranks},
        "launches_by_path": {
            "xlstm_prefill": xlstm_prefill["launches"]["slstm_scan_f32"],
            "xlstm_engine": xlstm_serve["launches"]["slstm_scan_f32"],
            "xlstm_gradient": xlstm_grad["launches"]["slstm_scan_f32"],
            "xlstm_train_steps":
                xlstm_train["launches"]["slstm_scan_f32"],
            "xlstm_launcher": {k: r["launches"]["slstm_scan_f32"]
                               for k, r in xlstm_launcher.items()}},
    }, {
        "name": "slstm_scan_bwd_f32",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/slstm_scan.cu",
        "replaces": "src/repro/nn/xlstm.py:209-228 (XLA's autodiff of "
                    "slstm_apply's cell under the jax.checkpoint-ed "
                    "_chunked_scan, xlstm.py:20-34; no Pallas kernel)",
        "launches": xlstm_train["launches"]["slstm_scan_bwd_f32"],
        "max_abs_err": max(r["max_abs_err"] for r in slstm_bwd.values()),
        **{k: slstm_bwd["train step"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "kernel_ms_by_difference", "kernel_bound_ms", "weight_grads_ms",
            "shape", "us_per_step", "max_abs_err_f64",
            "plain_max_abs_err_f64")},
        "shapes": {label: r for label, r in slstm_bwd.items()
                   if label != "train step"},
        "launches_by_path": {
            "xlstm_gradient": xlstm_grad["launches"]["slstm_scan_bwd_f32"],
            "xlstm_train_steps":
                xlstm_train["launches"]["slstm_scan_bwd_f32"],
            "xlstm_launcher": {k: r["launches"]["slstm_scan_bwd_f32"]
                               for k, r in xlstm_launcher.items()}},
        "model_axis": {f"rank {r['rank']}": r["xlstm"]["train"]["launches"][
            "slstm_scan_bwd_f32"] for r in u_ranks},
    }]}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "kernels": table["kernels"],
                       "paths": paths, "step": step, "train": train,
                       "quality": quality, "dense_route": dense_route,
                       "mlp_grad": mlp_grad, "mlp_step": mlp_step,
                       "mlp_run": mlp_run, "drl_sa": drl_sa, "table5": t5,
                       "serve_sync": {k: v for k, v in serve_sync.items()
                                      if k != "report"},
                       "serve_concurrent": serve_conc, "online": online_run,
                       "prefill": prefill,
                       "serve": lm_serve, "flash_grad": flash_grad,
                       "lm_train": lm_train, "lm_launcher": lm_launcher,
                       "moe_layers": moe_layers, "moe_prefill": moe_prefill,
                       "moe_serve": moe_serve, "moe_train": moe_train,
                       "hymba_init": hymba_init, "ssm_scan": ssm,
                       "hymba_prefill": hymba_prefill,
                       "hymba_serve": hymba_serve, "ssm_scan_bwd": ssm_bwd,
                       "hymba_grad": hymba_grad, "hymba_train": hymba_train,
                       "hymba_launcher": hymba_launcher,
                       "xlstm_init": xlstm_init, "slstm_scan": slstm,
                       "xlstm_layers": xlstm_layers,
                       "xlstm_prefill": xlstm_prefill,
                       "xlstm_serve": xlstm_serve,
                       "slstm_scan_bwd": slstm_bwd,
                       "xlstm_grad": xlstm_grad,
                       "xlstm_train": xlstm_train,
                       "xlstm_launcher": xlstm_launcher,
                       "whisper_flash": whisper_flash,
                       "whisper_init": whisper_init,
                       "whisper_serve": whisper_serve,
                       "whisper_grad": whisper_grad,
                       "whisper_train": whisper_train, "qwen": qwen,
                       "phase_s": cost, "phase_t": mesh_run,
                       "phase_u": model_run, "phase_s4": cost_mesh,
                       "init_s": INIT_S,
                       "build": build.build_info,
                       "ptxas_tensor_core_kernels": spills},
                      fh, indent=1)
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
