"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on one card, after building the CUDA kernels from
``src/repro_torch/kernels/csrc`` and holding each against its plain PyTorch
version there:

* the paper's Harris offload flow, ``courier_offload(corner_harris_demo(
  Library(db)), frame, db=make_harris_db())``, at the paper's 1080x1920 frame
  over a stream of 16 frames, with fusion off and on (K1-K4);
* the traced transformer served behind the request queue and the executor,
  ``serve_traced_transformer_demo``, at DeepSeek-67B widths (d 8192, 64
  heads, d_ff 22016, vocab 102400; 2 of its 95 layers, ~9.8 GB of f32
  weights): 8 requests of [512, 8192] in groups of 4 (K5, K6 on the
  tensor cores: 3xTF32 wgmma);
* the Harris pipeline served the same way, ``serve_pipeline_demo``, at
  1080x1920 (K1-K3 on the serving path);
* the replan loop at the same widths: an ``ElasticPlanner`` over the traced
  transformer serves requests of [512, 8192] through ``executor_for(3)``
  with a ``StageProfiler``, decides with ``replan_from_profile`` on the
  card's own stage times, and hot-swaps (``swap_executor``) to the
  decision's executor — or to the widened one if it keeps its plan — with
  requests in flight (K5, and K6 unless the decision defused it);
* KV-slot serving at the same widths: the zoo transformer's rows with a
  stateful ``attention_decode`` a layer (``register_decode_modules``, one
  ``KVSlotPool`` of 12 slots x 17 positions a layer on the card), traced
  and planned, serving 12 greedy sessions of 16 steps through
  ``RequestQueueServer(continuous=True)`` over an ``open_groups`` executor,
  then the same sessions with ``continuous=False`` (K5, K6 on the lm head);
* the LM serving mode, ``serve_lm``, at gemma3-12b's full widths (d 3840,
  16 heads x 256, 8 kv heads, d_ff 15360, vocab 262144, window 1024 with
  every 6th layer global; bf16, 6 of its 48 layers, 4.70 GB of weights):
  batched prefill of 4 prompts of 4096 tokens, then 32 greedy decode steps
  (K7 on every prefill self-attention);
* training, ``repro_torch.launch.train.build``'s step, at the same widths
  (bf16, 6 layers, batch 2 x 4096 tokens, loss chunk 512, per-layer remat,
  AdamW; ~28 GB of weights, gradients and moments): K7 on every
  self-attention's forward and its recompute, K8 and K9 on its backward;
  then ``FaultTolerantDriver`` over ``examples/train_100m.py``'s widths
  with a checkpoint store and one scripted step fault;
* the moe family at moonshot-v1-16b-a3b's full widths (d 2048, 16 heads x
  128, 64 experts, top 6, d_ff 1408, vocab 163840; bf16, the router f32):
  ``serve_lm`` at 6 of its 48 layers (~7.5 GB of weights; 4 prompts of 4096
  tokens through the einsum dispatch, 32 greedy tokens through the sort
  dispatch; K7 on every prefill self-attention), and training at 2 layers
  (batch 2 x 4096, loss chunk 512, per-layer remat, AdamW; K7-K9);
* the ssm and hybrid families at full widths, served at 4 of their
  layers: rwkv6-1.6b (d 2048, 32 RWKV-6 heads of 64, d_ff 7168, vocab
  65536; 4 of 24 layers) and hymba-1.5b (d 1600, 25 heads x 64 over 5 kv
  heads, window 1024 on every layer, a selective-SSM branch of state 16; 4
  of 32 layers), bf16 with the recurrences in f32: ``serve_lm`` with 4
  prompts of 4096 tokens (the chunked scans) and 32 greedy tokens (K7 on
  every hymba prefill self-attention), and training at 1 layer (batch 2 x
  4096, remat nesting the scans' chunk checkpoints; K7-K9 for hymba);
* the vlm family at llama-3.2-vision-11b's full widths and all its layers
  (d 4096, 32 heads x 128 over 8 kv heads, d_ff 14336, vocab 128256; 40
  layers = 8 groups of 4 self + 1 cross-attention layer against 1601 image
  rows; bf16, 18.5 GB of weights): ``serve_lm`` with 4 prompts of 4096
  tokens and 32 greedy tokens (K7 on every prefill attention, causal=False
  on the 8 cross layers, whose image K/V the decode steps reuse from the
  cache), and training at one group (5 layers, batch 2 x 4096, one
  checkpoint a group; K7-K9 on the self and the cross layers);
* the SPMD token pipeline (``core/spmd_pipeline.py``) at gemma3-12b's
  full widths: all 48 layers through ``spmd_pipeline_fn`` on 4 ranks of
  ``run_on_local_mesh`` sharing the card (gloo, hand-offs through pinned
  host memory), cut by ``partition_optimal`` over the cost model's
  per-layer costs, then on 3 after ``ElasticPlanner.boundaries(3)``, 8
  microbatches of [1, 4096, 3840] (K7 on every attention); and layers 0-7
  trained in 4 stages, 4 microbatches of 1 x 4096 (K7-K9);
* tensor-parallel serving (``launch/steps.py`` on DTensor weights) at
  gemma3-12b's full widths, 6 of its 48 layers (layer 5 global): the weights
  drawn whole from one seed on each rank of a (data 1, model 2) mesh of
  ``run_on_local_mesh`` sharing the card and cut by ``distribute_params``
  (each rank keeps half of the heads, the ff columns and the vocab rows),
  the cache by ``cache_shardings``; ``make_prefill_step`` over 2 prompts of 2048
  tokens, ``LM.prefill`` into the sharded cache, 16 teacher-forced
  ``make_decode_step`` steps (K7 on each rank's 8 local heads);
* tensor-parallel training (the train step on DTensor params and moments)
  at gemma3-12b's full widths, 6 of its 48 layers (5 local, one global):
  each rank of a (data 1, model 2) mesh sharing the card draws the whole
  weights from one seed and keeps its shards
  (``init_train_state_sharded``); two ``make_train_step`` steps with
  ``seq_parallel`` over 2 x 2048 tokens, then one without it from the same
  start (K7 on each rank's 8 local heads in the forward and the
  recompute, K8 and K9 on them in the backward);
* expert parallelism (the moe family on DTensor weights) at
  moonshot-v1-16b-a3b's full widths: each rank of a (data 1, model 2) mesh
  sharing the card draws the whole weights and keeps its 32 of the 64
  experts, 8 of the 16 heads and half of the vocab rows; served at 4 of
  its 48 layers (2 prompts of 2048 tokens through the sort dispatch, 16
  teacher-forced decode steps) and trained at 1 layer (2 x 4096 tokens
  through the einsum dispatch, ``seq_parallel`` on and off), with the
  whole-model run's routing pinned (K7 on each rank's local heads, K8 and
  K9 in the backward);
* the hybrid and ssm families tensor-parallel (their recurrences on each
  rank's channels or heads, the state in the cache's layout) at
  hymba-1.5b's and rwkv6-1.6b's full widths on a (data 1, model 2) mesh
  sharing the card: served at 2 of 32 and 2 of 24 layers (2 prompts of
  2048 tokens, 16 teacher-forced decode steps; K7 on all 25 of hymba's
  heads on each rank, since 25 does not divide 2) and trained at 1 layer
  (2 x 2048 tokens, ``seq_parallel`` on and off; K7-K9 for hymba);
* the vlm family tensor-parallel at llama-3.2-vision-11b's full widths on
  a (data 1, model 2) mesh sharing the card: each rank holds 16 of the 32
  heads, 4 of the 8 kv heads, half of d_ff and of the vocab rows, and its
  self and image K/V caches keep every kv head at half of head_dim (the
  JAX layout, re-laid at each write, gathered to read); served at 2 of 8
  groups (2 prompts of 2048 tokens against 1601 image rows, 16
  teacher-forced decode steps; K7 on each rank's heads, causal on the 8
  self layers and causal=False on the 2 cross layers) and trained at one
  group (2 x 2048 tokens, ``seq_parallel`` on and off; K7-K9 on the self
  and the cross layers);
* a data axis over more than one rank (FSDP) on a (data 2, model 2) mesh
  of 4 ranks sharing the card, one row of each batch a data rank:
  gemma3-12b (4 layers served, 2 trained), moonshot-v1-16b-a3b (2 and
  2), hymba-1.5b and rwkv6-1.6b (2 served, 1 trained; every recurrent
  state holding the rank's row) at full widths, served by
  ``param_shardings_serving`` (2 prompts of 2048 tokens, 16 or 8
  teacher-forced decode steps) and, but for moonshot, by
  ``param_shardings`` (the prefill and 2 decode steps, each layer and the
  embed table gathered over data as they are read), trained with
  ``seq_parallel`` on and off (moonshot on); K7 on each rank's heads, K8
  and K9 in the backward (none for rwkv);
* pod as a second batch axis on a (pod 2, data 2, model 1) mesh of 4
  ranks sharing the card (a spawn of its own), one row of a batch of 4 a
  rank, pod-major: the same five archs, served as in cell 17 and trained
  (gemma3 at 1 layer) with ``seq_parallel``; every head on each rank; the
  vlm self cache's 4 layers one a rank; hymba's trained state saved by
  ``CheckpointStore`` and restored by ``shardings=``, bit-equal.

Phases:

1. device   — fail without CUDA; print the card's name and power limit
2. build    — nvcc every CUDA source at once; print the build seconds
3. kernels  — each kernel against its plain version at the main paths'
              shapes and at ragged shapes, with the reference's tolerances
              (K2-K4 also bit for bit); device times (median of
              back-to-back runs, input cold in L2) beside the bound, the
              plain version and the library call; harris.cu's registers,
              spills (none allowed) and shared memory, K2's and K4's ms by
              tile, and beside K2's and K3's bound a same-bytes copy of the
              gray plane (what HBM gives at this size) and a launch with no
              bytes to move (what this timing adds to any kernel);
              K7's, K8's and K9's registers, spills (none allowed in the
              f32 entries) and shared memory, the route each of
              their cases took (bf16 on the tensor cores, f32 on the SIMT
              kernels), and cuobjdump's proof that every bf16
              entry of the two flash-attention sources issues TC_SASS and
              no f32 entry a tensor-core instruction; K6's registers,
              spills (none allowed) and shared memory, and TC_SASS in
              every K6 entry (its one route, 3xTF32 wgmma), with TF32 off
              for the plain version; K6's bound is the 3xTF32 tensor work
              at the TF32 peak, the f32 FMA bound beside it
4. main     — the offload path, fuse=False then fuse=True: hw rows resolved,
              launch counts moved, no host sync on the path, Switcher logs
              empty, outputs equal the plain app; ms/frame of the original
              app, run_sequential, run, and the card's own ms/frame
5. serve    — the traced transformer: K6 fused on the lm head, every rmsnorm
              on K5, launch counts moved by the expected numbers (K6's all
              on its tensor-core route), results
              equal the untraced app (2e-4); latency p50/p95, requests/s,
              the card's own ms per group beside the wall ms.  Then the
              Harris pipeline behind the same server.
5a. replan  — the ReplanDecision made from the card's stage times, the
              measured p50 of each stage, each node's modeled ms before
              apply_to_ir and measured ms after; the hot swap with requests
              in flight: 0 dropped, 0 failed, 0 out of order, results
              within 2e-4 of the untraced app on both sides, K5 on both
              executors; wall ms a request and requests/s on each side;
              the card's DeviceInventory and an empty refresh() diff
5b. decode  — both modes: every step's logits within 2e-4 of a full-prefix
              rerun of the untraced app, 0 drops, 0 out of order, seam
              joins (continuous), no slot leaked, stateful nodes serial and
              off the hw rows, K5 launched; p50 time to the first token,
              steps/s, card ms a step, idle share, seam fill
6. lm       — K7 at the serving shape, on q/k/v of the real prompt at layer
              0 (local) and layer 5 (global), against its plain version
              (o element by element, within one bf16 ulp plus 2^-8 rms);
              its device time and TFLOP/s beside the bound, the plain
              version and F.scaled_dot_product_attention.  Then serve_lm:
              6 K7 launches in the prefill, none in the decode loop; the
              decode loop's logits equal LM.apply over prompt + generated
              tokens (K7 at T = 4128) within 2.5e-2 of the largest; prefill
              and decode ms and tokens/s, the card's own prefill ms and
              K7's share
7. train    — K8 and K9 against autograd through K7's plain version at
              every head_dim x (f32, bf16), T != M, ragged lengths, the four
              masks (rows that see no key included), and at the driver
              run's [8, 64, 10, 64] f32 (window 32 and none), element by
              element, and there K7, K8 and K9 on the f32 route timed
              beside their bound, the plain version, SDPA (forward or
              backward) and the launch floor; at [2, 4096, 16, 256] bf16 (causal and window 1024)
              K7 element by element and its time and TFLOP/s beside the
              bound, then K8/K9's times beside the bound, the plain
              backward and SDPA's backward, with TFLOP/s (the launches on
              the wgmma route).  Then full-width training steps (12/6/6
              K7/K8/K9 launches each, all on the wgmma route, finite
              losses, step ms, tokens/s, peak memory, a profile), a kernel
              step against a plain-attention step (loss and every gradient
              leaf within 2.5e-2), and the driver at 100M widths (f32, the
              SIMT route): 80 steps, 1 restart, the loss falls
8. moe      — moonshot-v1-16b-a3b, gated only on what no near-tie in the
              routing and no second device decides: (a) the card's f32
              router logits within 1e-5 of a float64 product on the card,
              its top-k off the float64 routing only within a tie gap (8x
              the measured logits error), its kept set equal to the plain
              capacity rule on its own choices; (b) moe_apply against
              moe_ref under its own routing (einsum prefill and sort
              decode, and both with no drops; bf16 2e-2, f32 2e-4 of
              max|ref|); K7 at the serving shape element by element;
              serve_lm: 6 K7 launches, finite logits, (c) served twice bit
              for bit; (d) decode against LM.apply over prompt +
              generated, gated in f32 with the rerun's routing pinned
              (1e-4), printed in bf16 with flips by layer; (e) 4 training
              steps (the loss falls, launches, routes), the kernel step
              against a plain-attention step with its routing pinned (loss
              1e-3) and each leaf's gradient error within 1.5x an SDPA
              control's, every gradient finite, the total loss's parts,
              K8/K9 at [2, 4096, 16, 128] element by element; (f) prefill
              and decode ms, tokens/s, step ms, peak GB, idle share and the
              card ms by range (route, dispatch, experts, combine, K7)
9. ssm      — rwkv6-1.6b and hymba-1.5b, gated only on what no second
              device decides (neither family makes a discrete choice):
              (a) f32 at full width, ssm_apply over [2, 64, 1600] and
              time_mix over [2, 64, 2048] against 64 single-token calls
              carrying their state (2e-4, every zero- or one-initialised
              leaf drawn first); (b) time_mix at [1, 512, 2048] with the
              scan's chunked remat on and off (outputs and every gradient,
              1e-5 relative); (c) serve_lm at 4 layers: K7 launches
              (hymba 4 in the prefill, rwkv none), finite logits, served
              twice bit for bit; (d) decode against LM.apply over prompt +
              generated at batch 1 x 1024, f32 1e-4 and bf16 2.5e-2 of the
              largest logit; (e) 4 training steps at 1 layer (the loss
              falls, launches and routes, every gradient finite), hymba's
              kernel step against a plain-attention step (loss 1e-3) and
              each leaf's gradient error within 1.5x an SDPA control's,
              rwkv's step against the step without the per-layer remat
              (loss 1e-5); (f) K7 at [4, 4096, 25, 64] and K8/K9 at [2,
              4096, 25, 64], window 1024, element by element, timed beside
              the bound, the plain version and SDPA; (g) prefill and decode
              ms, tokens/s, step ms, peak GB, idle share and the card ms by
              range (ssm:conv, ssm:scan, rwkv:time_mix, rwkv:scan,
              rwkv:channel_mix, K7, the rest)
10. vlm     — llama-3.2-vision-11b, image embeddings and weights drawn
              from the seed: (a) layers.attention(kv_x=) at [2, 256, 4096]
              against 1601 image rows (the K7 call inside it element by
              element, the layer's output 2.5e-2 of max |ref| against the
              plain layer), K7 self and cross at the serving shape and
              K8/K9 cross at [2, 4096, 32, 128], element by element, timed
              beside the bound, the plain version and SDPA; (b) serve_lm at
              40 layers: 40 K7 launches in the prefill (32 causal, 8 with
              causal=False against 1601 keys), none in decode, finite
              logits, served twice bit for bit; (c) decode against LM.apply
              over prompt + the served ids at batch 1 x 1024, bf16 at 40
              layers (2.5e-2) and f32 at 2 groups (1e-4); (d) 4 training
              steps at one group (the loss falls, 10/5/5 launches a step,
              routes, every gradient finite and nonzero, the cross layer's
              wq/wk/wv/wo among them), the kernel step against a
              plain-attention step (loss 1e-3) and each leaf's gradient
              error within 1.5x an SDPA control's; (e) prefill and decode
              ms, tokens/s, step ms, peak GB, idle share and the card ms by
              range (vlm:self, vlm:cross, vlm:cross_kv, vlm:mlp) of a
              one-group prefill and 2 decode steps
11. spmd    — the served stack's cost-model plans (4 stages, the 3-stage
              re-plan, the 8-layer training cut) beside the equal split;
              the parent's sequential run of the same blocks; the 4- and
              3-stage runs (the transport, per rank its layers, stage ms,
              hand-off ms, idle share and peak GB; the run's ms; the
              schedule's bubble share) held to it within 2e-2 of
              max|ref|, bit for bit printed, 48 x 8 K7 launches each;
              the 4-stage training step held to the sequential one: the
              outputs, and every layer leaf's gradient within 2e-2 of
              max|ref grad|; 32/32/32 K7/K8/K9 launches; the phase's
              seconds (budget 90)
12. tp      — the whole-model run in this process first (the prefill
              step's logits, LM.prefill, 16 greedy decode steps, the
              cache), then 2 ranks sharing the card: per rank the local
              shapes of wq, wk, mlp/wi, the embed table and the cache, peak
              GB, K7 launches (> 0 on every rank, all on the wgmma route)
              and the prefill, prefill-into-cache and decode ms; K7 on the
              q/k/v a local (window 1024) and a global layer gave it on
              each rank ([2, 2048, 8, 256] bf16), element by element
              against its plain version, rank 0's timed beside the bound,
              the plain version and SDPA; the
              prefill logits, the decode logits (both runs fed the whole
              run's greedy tokens, so no near-tie decides) and the
              gathered K/V cache each within 2e-2 of max|ref|, printed as
              a share of that limit; the phase's seconds (budget 60)
13. tp_train — the whole-model run in this process first (step 1's loss,
              grad_norm and gradients, saved for the ranks), then 2 ranks
              sharing the card: per step and rank the loss, grad_norm, ms,
              peak GB, K7/K8/K9 launches (12/6/6, all on the wgmma route)
              and the collectives' count, bytes and ms, forward and
              backward apart; gates: step 1's loss within 1e-3 relative of
              the whole run's and grad_norm within 1e-2, with
              seq_parallel and without, the grad_norm the same number on
              both ranks, every gradient leaf of layers 0 and 5 and the
              embed table and final norm within 2e-2 of max|g_ref| at each
              rank's bounds (before AdamW clips them), the moments' local
              shapes those of their opt_shardings specs, the loss falling
              from step 1 to 2; K8 and K9 at each rank's own q, k, v and dO
              of layer 0 and layer 5 ([2, 2048, 8, 256] bf16) element by
              element against their plain versions, rank 0's timed beside
              the bound, the plain backward and SDPA's; the peak GB with
              seq_parallel and without; the phase's seconds (budget 90)
14. ep      — moonshot-v1-16b-a3b expert-parallel on 2 ranks sharing the
              card, each whole-model run in this process first, its
              routing recorded and pinned into the ranks; serving (4
              layers): per rank its experts, the local shapes of moe/wi,
              moe/wo, the router (whole), wq, the embed table and the cache,
              K7 launches (> 0, wgmma route), every moe call's dropped_frac
              equal to the whole run's, the collectives' count, MB and
              share of a rerun; the prefill and decode logits, the gathered
              cache and layer 0's moe output against moe_ref under the
              pinned routing (the whole run's too) each within 2e-2 of
              max|ref|; K7 at each
              rank's [2, 2048, 8, 128] element by element, rank 0's timed
              beside the bound and SDPA; training (1 layer): steps 1 and 3
              (seq_parallel, then without from the same start) pinned, loss
              1e-3 and grad_norm 1e-2 relative of the whole run's,
              dropped_frac equal, each layer's router, ln2, wq and experts
              0 and 32's wi/wo and the embed table within 2e-2 of
              max|g_ref| of the same ranks' step with the experts whole on
              every rank (ep_whole_experts_grads: the row split's own f32
              sums, which at this random init move some of these
              gradients 1-3.5x the limit off the plain whole run's,
              printed beside them with the f32 control: the plain bf16
              run's own distance to the same step in f32 with its
              routing pinned, and the ranks' distance to that f32 step
              over it), the grad_norm equal on
              both ranks, 4/2/2 K7/K8/K9 a step on the wgmma route, the
              moments at their opt_shardings local shapes (moe/wi [2, 32,
              2048, 2, 1408]), the loss falling, the collectives' count, MB
              and share of each step; K8/K9 at each rank's [2, 4096, 8,
              128] element by element, rank 0's timed; in every run, and in
              an unpinned prefill, the two ranks' own top-k choices equal
              bit for bit; the phase's seconds (budget 90)
15. tp_recurrent — hymba-1.5b and rwkv6-1.6b tensor-parallel on 2 ranks
              sharing the card, the state leaves drawn, each whole-model
              run in this process first; serving: per rank the local
              shapes (hymba's ssm/in_proj, attn/wq whole, attn/wo's half
              of the rows, ssm h/conv and the k/v cache's half of
              head_dim; rwkv's wr, wo, ck, S split on its last dim,
              tm_last), K7 launches (4 on each hymba rank, wgmma route),
              prefill and decode ms, peak GB, the collectives' count, MB
              and ms in a rerun; the prefill and decode logits and every
              cache leaf reassembled (hymba's k/v, h, conv; rwkv's S,
              tm_last, cm_last; each layer printed) within 2e-2 of
              max|ref|, or no further than 1.5x the whole bf16 run from
              an f32 run of the same weights fed the same tokens (the
              control; rwkv's deepest token-shift states read ~1.05 of
              the first limit), the decode within 2.5e-2 of LM.apply over
              the prompt and the fed tokens on the ranks; training (1 layer):
              steps 1 and 3 (seq_parallel, then without from the same
              start) loss 1e-3 and grad_norm 1e-2 relative of the whole
              run's, every gradient leaf within 2e-2 of max|g_ref| or
              within 1.5x the whole bf16 step's own distance from the
              f32 step (the control; rwkv's u and embed table read
              1.21-1.47 of the first limit), the grad_norm equal and
              every leaf held whole bit-equal on both
              ranks after steps 2 and 3, 4/2/2 K7/K8/K9 a hymba step on
              the wgmma route (none for rwkv), the loss falling; K7 at
              each hymba rank's [2, 2048, 25, 64] (window 1024) and K8/K9
              at its [2, 2048, 25, 64], element by element, rank 0's timed
              beside the bound, the plain version and SDPA; the phase's
              seconds (budget 150)
16. tp_vlm  — llama-3.2-vision-11b tensor-parallel on 2 ranks sharing the
              card (the helpers of tp_recurrent), the image embeddings
              drawn from the seed, the whole-model run in this process
              first; serving (2 groups): per rank the local shapes
              (wq and wk of the self layers, mlp/wi, the cross layers'
              wk and wo, the self k/v and image ck/cv caches with every
              kv head at half of head_dim, the embed table), 20 K7
              launches (10 a prefill: 8 causal, 2 causal=False against
              1601 keys; wgmma route), prefill and decode ms, peak GB,
              the collectives' count, MB and ms in a rerun; the prefill
              and decode logits and the self k/v and image ck/cv
              reassembled (each group printed, with the whole bf16 run's
              own distance to an f32 run) within 2e-2 of max|ref|, the
              decode within 2.5e-2 of LM.apply over the prompt and the
              fed tokens on the ranks; training (one group): steps 1
              and 3 (seq_parallel, then without from the same start)
              loss 1e-3 and grad_norm 1e-2 relative of the whole run's,
              every gradient leaf within 2e-2 of max|g_ref|, the
              grad_norm equal and every leaf held whole bit-equal on both
              ranks after steps 2 and 3, 10/5/5 K7/K8/K9 a step on the
              wgmma route, the loss falling; K7 (self and cross) and
              K8/K9 (self and cross) at each rank's own inputs ([2, 2048,
              16, 128], 2048 or 1601 keys) element by element, rank 0's
              timed beside the bound, the plain version and SDPA; the
              phase's seconds (budget 90)
17. fsdp    — gemma3-12b, moonshot-v1-16b-a3b, hymba-1.5b and rwkv6-1.6b
              on a (data 2, model 2) mesh of 4 ranks sharing the card,
              each whole-model run in this process first (the same layout
              registered; moonshot's routing pinned into the ranks; f32
              controls for moonshot and rwkv): per rank its local shapes
              (the cache's rows one a data rank), prefill, decode and step
              ms, peak GB and collectives by group (data, model: calls,
              bytes, ms); logits and every cache leaf within 2e-2 of
              max|ref|, decode 2.5e-2 (gemma3, moonshot) or 2e-2 (hymba,
              rwkv), step 1's loss 1e-3 and grad_norm 1e-2 relative,
              every checked gradient 2e-2 of max|g_ref| (a moonshot
              gradient, or a read CONTROLLED names, over that
              passing by the f32 control at 2.0x); K7-K9 launches by
              family; K7 and K8/K9 at each rank's inputs (gemma3 [1, 2048,
              8, 256], moonshot [1, 2048 / 4096, 8, 128], hymba [1, 2048,
              25, 64]) element by element, rank 0's timed; the phase's
              seconds (aim 160)
18. pod     — the same archs and gates on a (pod 2, data 2, model 1) mesh
              of 4 ranks (a spawn of its own; ``POD``), a batch of 4
              split over (pod, data): per rank its pod, data and pod+data
              collectives, the vlm self-cache exchange a decode step,
              prefill, decode and step ms, peak GB; K7 and K8/K9 at a
              rank's inputs with every head (gemma3 [1, 2048, 16, 256],
              moonshot [1, 2048 / 4096, 16, 128], hymba [1, 2048, 25,
              64], the vlm [1, 2048, 32, 128], 2048 or 1601 keys); hymba's
              trained state through ``CheckpointStore`` (save, restore by
              ``shardings=``, bit-equal on every rank, bytes and ms)
19. the ``kernels`` JSON line (the ranks' launches added), the nvidia-smi
   line, and the result line;
   a ``[time] <phase> <seconds>`` line after each phase

Any failed check raises: the script then exits non-zero without the result
line.  Imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/harris.cu"
RMS_SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
FA_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
HBM_BW = 3.35e12              # H100 SXM HBM3, bytes/s (data sheet)
FP32_PEAK = 67e12             # H100 SXM float32 outside the tensor cores
BF16_PEAK = 989e12            # H100 SXM bf16 dense, tensor cores
TF32_PEAK = 495e12            # H100 SXM TF32 dense, tensor cores
N_FRAMES = 16
H, W = 1080, 1920
RAGGED = [(17, 23), (33, 130), (1081, 1919)]
L2_BYTES = 50 * 10**6
# the serving traffic: 8 requests of [512, d] each, served in groups of 4
TRAFFIC = dict(n_requests=8, max_batch=4, seq_len=512)
GROUP_ROWS = TRAFFIC["max_batch"] * TRAFFIC["seq_len"]  # 2048 rows a group
RMS_RAGGED = [(7, 130, 77), (513, 130, 77)]
# the LM serving mode: gemma3-12b at full widths, 6 of 48 layers (one
# 5-local + 1-global period), 4 prompts of 4096 tokens, 32 new tokens
LM_TRAFFIC = dict(arch="gemma3-12b", layers=6, batch=4, prompt_len=4096,
                  tokens=32)
# K7's small and ragged shapes (B, T, H, M), run at every head_dim and type;
# T > M + 40 - 1 gives rows that see no key under the window of 40
FA_RAGGED = [(2, 77, 3, 131), (1, 300, 2, 200)]
FA_MASKS = [(True, 0), (True, 64), (False, 0), (False, 40)]
# what bf16 K7, K8 and K9 must run: wgmma on the tensor cores (SASS HGMMA)
TC_SASS = "HGMMA"
# the sources whose entries cuobjdump checks: library -> K numbers
TC_LIBRARIES = {"flash_attention": "K7", "flash_attention_bwd": "K8/K9"}
# training: gemma3-12b at full widths, 6 of 48 layers, batch 2 x 4096,
# one warm-up step, 4 timed steps, one profiled step
TRAIN = dict(arch="gemma3-12b", layers=6, batch=2, seq_len=4096, timed=4,
             lr=3e-3)
# the driver at examples/train_100m.py's widths (:28-31)
DRIVER = dict(n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
              head_dim=64, d_ff=2560, vocab=32768, window=32, global_every=6,
              dtype="float32")
DRIVER_RUN = dict(steps=80, batch=8, seq_len=64, ckpt_every=20, fail_at=50)


def driver_attention() -> tuple[tuple, int, list]:
    """The driver run's self-attention: (B, T, H, M), head_dim and masks
    (the local layers' window and the global layer's none), f32."""
    T = DRIVER_RUN["seq_len"]
    return ((DRIVER_RUN["batch"], T, DRIVER["n_heads"], T),
            DRIVER["head_dim"], [(True, DRIVER["window"]), (True, 0)])


# the replan phase: the served transformer's weights and requests of
# [512, 8192], one a group (executor_for's default), so the profile times
# what the IR's priors price; 8 fill the profile, 4 are in flight at the
# swap, 8 follow it.  Each side's requests/s is timed over a window of 120
# requests (~5.4 s on the card) kept 8 deep in flight, in three parts
REPLAN = dict(seq_len=512, profile=8, in_flight=4, after=8, min_samples=4,
              worker_budget=4, window=120, depth=8, parts=3)
# the continuous-decode phase: 12 greedy sessions of 16 steps over KV slots
# (12 slots of 17 positions a layer), groups of 4
DECODE = dict(sessions=12, steps=16, max_batch=4, max_seq=17)
# the moe family: moonshot-v1-16b-a3b at full widths, served at 6 of its 48
# layers (4 prompts of 4096 tokens, 32 new tokens), its decode held to a
# full-prefix rerun at batch 1 x 1024 (16 tokens), trained at 2 layers
# (batch 2 x 4096, 4 steps)
MOE = dict(arch="moonshot-v1-16b-a3b", layers=6, batch=4, prompt_len=4096,
           tokens=32, decode_prompt=1024, decode_tokens=16, train_layers=2,
           train_batch=2, train_seq=4096, train_steps=4, lr=3e-3)


# the ssm and hybrid families at full widths: rwkv6-1.6b and hymba-1.5b
# served at 4 of their 24 and 32 layers (cut from 8 to make room for the
# fsdp phase's hybrid and ssm families: the eager scans are host-bound),
# 4 prompts of 4096 tokens (a
# multiple of 256: the chunked scans) and 32 new tokens, the prefill
# profiled at 1 layer and the decode for 2 steps (the profiler's parse of
# more events costs tens of seconds); the decode held to a full-prefix
# rerun at batch 1 x 1024 (16 tokens); trained at 1 layer (cut from 2 to
# make room for the fsdp phase: rwkv6-1.6b's eager scan's step took
# 5.4-5.9 s at 2 layers, hymba-1.5b's step 2.5-2.8 s) (batch 2 x 4096, 4
# steps); the state checks
# at [2, 64, d], the remat check at [1, 512, 2048]
SSM = dict(archs=("rwkv6-1.6b", "hymba-1.5b"), layers=4, batch=4,
           prompt_len=4096, tokens=32, decode_prompt=1024, decode_tokens=16,
           state_batch=2, state_len=64, remat_len=512, profile_layers=1,
           profile_steps=2, train_layers={"rwkv6-1.6b": 1, "hymba-1.5b": 1},
           train_batch=2, train_seq=4096, train_steps=4, lr=3e-3)
# the leaves ssm_init and rwkv_init set to zeros or ones, drawn from the
# seed instead: name -> (low, high) of a uniform draw
STATE_LEAF_DRAWS = {"dt_bias": (-2.0, 0.0), "A_log": (-1.0, 1.0),
                    "D": (0.5, 1.5), "mu": (0.0, 1.0), "mu_c": (0.0, 1.0),
                    "w_bias": (-3.0, 0.0), "u": (-0.5, 0.5),
                    "ln_scale": (0.5, 1.5)}
# the vlm family: llama-3.2-vision-11b at full widths, served whole (40
# layers, 4 prompts of 4096 tokens against 1601 image rows, 32 new tokens),
# the cross layer held at [2, 256, 4096]; decode held to a full-prefix
# rerun at batch 1 x 1024 (16 tokens), bf16 at all the layers and f32 at 2
# groups; the prefill profiled at 1 group, the decode for 2 steps; trained
# at one group (5 layers, batch 2 x 4096, 4 steps)
VLM = dict(arch="llama-3.2-vision-11b", batch=4, prompt_len=4096, tokens=32,
           attn_batch=2, attn_len=256, decode_prompt=1024, decode_tokens=16,
           f32_groups=2, profile_groups=1, profile_steps=2, train_groups=1,
           train_batch=2, train_seq=4096, train_steps=4, lr=3e-3)

# the SPMD token pipeline: gemma3-12b's 48 full-width layers served in 4
# and then 3 cost-balanced stages (ranks sharing the card) over 8
# microbatches of [1, 4096, 3840]; layers 0-7 trained in 4 stages over 4
# microbatches of 1 x 4096, loss mean(out²); each layer drawn from the seed
# plus its index, so any rank draws its own layers alone
SPMD = dict(arch="gemma3-12b", stages=4, replan=3, microbatches=8,
            seq_len=4096, train_layers=8, train_stages=4,
            train_microbatches=4, seed=2027, timeout=600)
# tensor-parallel serving: gemma3-12b at full widths, 6 of 48 layers (5
# local, layer 5 global at global_every 6; cut from 12 to keep the script
# within its time), a (data 1, model 2) mesh sharing the card, 2 prompts of
# 2048 tokens (over the 1024 window), 16 decode steps
TP = dict(arch="gemma3-12b", layers=6, mesh=(1, 2), batch=2,
          prompt_len=2048, decode=16, seed=2028, timeout=600)
# tensor-parallel training: gemma3-12b at full widths, 6 of 48 layers (5
# local, layer 5 global), a (data 1, model 2) mesh sharing the card, batch
# 2 x 2048 tokens, loss chunk 512, per-layer remat, AdamW (lr 3e-4 from
# the first step); two steps with seq_parallel on the same batch, then one
# without it from the same start; layers 0 and 5 checked leaf by leaf
TP_TRAIN = dict(arch="gemma3-12b", layers=6, mesh=(1, 2), batch=2,
                seq_len=2048, loss_chunk=512, lr=3e-4, seed=2029,
                checked=(0, 5), timeout=600)

# the hybrid and ssm families tensor-parallel: hymba-1.5b served at 2 of
# 32 layers and rwkv6-1.6b at 2 of 24 (cut from 8 and 6, then 4 and 3, to
# make room for the fsdp phase), full widths, on a (data 1, model 2)
# mesh sharing the card (2 prompts of 2048 tokens, over hymba's 1024
# window; 16 teacher-forced decode steps), each trained at 1 layer (cut
# from 2 for the fsdp phase's hybrid and ssm families; batch 2 x 2048,
# cut from 2 x 4096 to keep the script within its time; loss
# chunk 512, per-layer remat, AdamW); the state leaves drawn from the seed
# as in the ssm phase.  ``control_limit``: a read CONTROLLED names for
# the arch passes within that many times the whole bf16 run's own
# distance to the same run in f32 (per layer for a layer's leaf)
TP_RECURRENT = dict(tag="tp_recurrent", archs=("hymba-1.5b", "rwkv6-1.6b"),
                    layers={"hymba-1.5b": 2, "rwkv6-1.6b": 2}, mesh=(1, 2),
                    batch=2, prompt_len=2048, decode=16, train_layers=1,
                    train_batch=2, train_seq=2048, loss_chunk=512, lr=3e-4,
                    seed=2031, timeout=600, control_limit=2.0)
# the reads, by arch, whose bf16 drift alone passes 2e-2 of max|ref| on the
# card (rwkv's token-shift states at the deepest layers, its embedding
# gradient; PERF.md, cell 15), held by an f32 control instead in the
# tp_recurrent and fsdp phases (their ``control_limit``)
CONTROLLED = {"rwkv6-1.6b": ("cache_tm_last", "cache_cm_last",
                             "embed/table")}

# the vlm family tensor-parallel: llama-3.2-vision-11b at full widths on a
# (data 1, model 2) mesh sharing the card, each rank holding 16 of the 32
# heads, 4 of the 8 kv heads, half of d_ff and of the vocab rows, its self
# and image K/V caches every kv head at half of head_dim (the JAX layout):
# served at 2 of its 8 groups (8 self + 2 cross layers; 2 prompts of 2048
# tokens against 1601 image rows drawn from the seed in bf16, 16
# teacher-forced decode steps), trained at one group (5 layers, 2 x 2048
# tokens, seq_parallel on and off; loss chunk 512, group remat, AdamW);
# ``control_limit`` as in TP_RECURRENT (CONTROLLED names no vlm read)
TP_VLM = dict(tag="tp_vlm", archs=("llama-3.2-vision-11b",),
              layers={"llama-3.2-vision-11b": 10}, mesh=(1, 2), batch=2,
              prompt_len=2048, decode=16, train_layers=5, train_batch=2,
              train_seq=2048, loss_chunk=512, lr=3e-4, seed=2032,
              timeout=600, control_limit=2.0)

# expert parallelism: moonshot-v1-16b-a3b at full widths on a (data 1,
# model 2) mesh sharing the card, each rank holding 32 of the 64 experts,
# 8 of the 16 heads and half of the vocab rows: served at 4 of 48 layers
# (cut from 6 to keep the script within its time; 2 prompts of 2048
# tokens, the sort dispatch; 16 decode steps), trained at 1 layer (cut
# from 2 to make room for the fsdp phase's hybrid and ssm families; batch
# 2 x 4096 tokens: the einsum dispatch, 16 groups of
# 512; loss chunk 512, per-layer remat, AdamW); every check against the
# whole-model run pins its routing; the gradients of experts 0 and 32
# (one from each rank's range) are checked leaf by leaf
EP = dict(arch="moonshot-v1-16b-a3b", layers=4, mesh=(1, 2), batch=2,
          prompt_len=2048, decode=16, train_layers=1, train_batch=2,
          train_seq=4096, loss_chunk=512, lr=3e-4, seed=2030,
          experts=(0, 32), timeout=600)

# a data axis over more than one rank (FSDP): a (data 2, model 2) mesh of
# 4 ranks sharing the card, each data rank one row of the batch.
# gemma3-12b at full widths: served at 4 of 48 layers (2 prompts of 2048
# tokens, 16 teacher-forced decode steps) with weights by
# param_shardings_serving, then the prefill step and 2 decode steps with
# weights by param_shardings (the FSDP storage: each layer and the embed
# table gathered over data as they are read); trained at 2 layers (2 x
# 2048, loss chunk 512, one step with seq_parallel and one without from
# the same start).  moonshot-v1-16b-a3b at full widths: served at 2 layers
# (2 x 2048: the sort dispatch in 2 groups, one a data rank; 8 decode
# steps, one group across both data ranks), trained at 2 layers (2 x
# 4096: the einsum dispatch, 16 groups, 8 a data rank), the whole run's
# routing pinned, experts 0 and 32 checked.  The reference: the port's
# one-process whole run of the same weights with the same layout
# registered (the same routing groups and capacity).  hymba-1.5b
# ("hybrid": 25 heads whole on each model rank, attn/wo's rows split) and
# rwkv6-1.6b ("ssm") at full widths, their zero- and one-initialised
# leaves drawn from the seed: each served at 2 layers under both layouts
# (16 decode steps by param_shardings_serving, 2 by param_shardings),
# every recurrent state holding a data rank's row, and trained at 1 (2 x
# 2048, seq_parallel on and off); logits, decode and cache within 2e-2.
# ``control_limit``: a moonshot gradient, or a read CONTROLLED names
# (cell 15's rwkv reads), over 2e-2 of max|ref| passes within that many
# times the whole bf16 run's own distance to the same run in f32 (per
# layer for a layer's leaf).  llama-3.2-vision-11b ("vlm") at full widths
# and one group (4 self + 1 cross layer): served (2 prompts of 2048 tokens
# against 1601 bf16 image rows drawn from the seed, one row a data rank; 16
# decode steps by param_shardings_serving, 2 by param_shardings) with its
# self cache in the JAX layout (each group's 4 self layers split over data:
# each data rank holds 2 of them for both rows, writes the rows gathered
# over data and sends the other rank its row to decode), trained at one
# group (2 x 2048, seq_parallel on, its own image rows).  ``nested``: the
# families whose first step (c = 0, seq_parallel on) the same ranks take
# again from the same weights on the same batch with nested remat,
# ``scan_chunks=default_scan_chunks(L)`` at the training depth (gemma3
# and moonshot at 2 layers: c = 2; hymba and rwkv at 1: c = 1, the
# chunk's checkpoint around the layer's, around the recurrence's time
# chunks), through make_train_step; every checked gradient, the loss and
# grad_norm held to the c = 0 step's, bit for bit or within the bf16
# limit (the vlm family ignores scan_chunks, as JAX does: its step stays
# in the CPU tests, tests/test_torch_remat_sharded.py)
FSDP = dict(mesh=(2, 2), dense="gemma3-12b", dense_layers=4,
            train_layers=2, moe="moonshot-v1-16b-a3b", moe_layers=2,
            hybrid="hymba-1.5b", ssm="rwkv6-1.6b", rec_layers=2,
            rec_train_layers=1, vlm="llama-3.2-vision-11b", vlm_layers=5,
            batch=2, prompt_len=2048, decode=16, fsdp_decode=2,
            moe_decode=8, train_seq=2048, moe_train_seq=4096,
            loss_chunk=512, lr=3e-4, seed=2033, experts=(0, 32),
            control_limit=2.0, timeout=600, axes=("data", "model"),
            tag="fsdp", cell=17, nested=("dense", "moe", "hybrid", "ssm"))
# cell 18: pod as a second batch axis, a (pod 2, data 2, model 1) mesh of
# 4 ranks sharing the card (a spawn of its own, after cell 17's), the
# batch split over (pod, data) pod-major, one row of 4 a batch rank,
# every head on each rank (model 1); the families, depths
# and gates of cell 17 (its weights, drawn from the same seed), 4 x 2048
# prompts (16 teacher-forced decode steps; moonshot 8) and training at 4 x
# 2048 (moonshot 4 x 4096); the vlm self cache's 4 self layers one a batch
# rank; hymba's trained state (``ckpt``) saved by CheckpointStore under
# build/ and restored by shardings= (every rank's local tensors
# bit-equal), the directory deleted after.  gemma3 trains at 1 layer here
# (2 in cell 17): with model 1 a rank's step holds half of the 262144 x
# 3840 table in bf16 with its two f32 moments (5.0 GB), the table gathered
# whole and its gradient (4.0 GB) and each loss chunk's f32 table
# gradient (4.0 GB); at 2 layers the 4 ranks ran out of an H100's 80 GB,
# and at 1 layer with loss chunks of 512 too, so its loss runs in chunks
# of 256 tokens (each chunk's [256, 262144] f32 logits and their bf16
# gradient terms half as large; PERF.md, cell 18).  With one model rank a
# family trains one step, with seq_parallel: the step without it is the
# same computation (the same loss and grad_norm to the bit on the card)
POD = dict(FSDP, mesh=(2, 2, 1), axes=("pod", "data", "model"), batch=4,
           tag="pod", cell=18, ckpt="hybrid", train_layers=1, loss_chunk=256,
           nested=())
# the fsdp phase's families, in the order they run, and their seed offsets
FSDP_FAMS = {"dense": 0, "moe": 10, "hybrid": 20, "ssm": 30, "vlm": 40}
# the layer leaves whose local shapes a serving rank prints, by family
FSDP_SHAPES = {"dense": ("attn/wq", "attn/wo", "mlp/wi"),
               "moe": ("attn/wq", "attn/wo", "moe/wi", "moe/router"),
               "hybrid": ("ssm/in_proj", "attn/wq", "attn/wo"),
               "ssm": ("rwkv/wr", "rwkv/wo", "rwkv/ck"),
               "vlm": ("attn/wq", "attn/wk", "mlp/wi")}
# the families trained with seq_parallel alone (no second step without it)
FSDP_SP_ONLY = ("moe", "vlm")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------------- #
def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name}  count={torch.cuda.device_count()}  "
          f"torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


# --------------------------------------------------------------------------- #
# 2. build
# --------------------------------------------------------------------------- #
def phase_build():
    from repro_torch.kernels import build, harris as hk, rmsnorm as rk

    sources = sorted(f[:-3] for f in os.listdir(build.CSRC) if f.endswith(".cu"))
    t0 = time.perf_counter()
    running = [build.start_build(s) for s in sources]       # all at once
    for b in running:
        build.finish_build(b)
    lib = hk.library()
    secs = time.perf_counter() - t0
    print(f"[build] {sources} built in {secs:.2f} s "
          f"(per source: {build.build_seconds})")
    for src in sources:
        log = build.build_logs.get(src, "")
        for entry, lines in ptxas_report(log):
            for line in lines:
                print(f"[build] ptxas {src} {entry}: {line}")
        for line in log.splitlines():       # e.g. wgmma serialized by ptxas
            if "warning" in line.lower():
                print(f"[build] nvcc {src}: {line.strip()}")
    for (th, tw), bs, rgb in itertools.product(hk.TILE_CANDIDATES, (2, 3),
                                               (False, True)):
        check(lib.repro_harris_tile_smem_bytes(th, tw, bs, rgb)
              == hk.tile_smem_bytes(th, tw, bs, rgb),
              "shared-memory reckoning differs between harris.cu and Python")
    check(rk.library().repro_rmsnorm_matmul_smem_bytes()
          == rk.gemm_smem_bytes(),
          "K6's shared-memory tile differs between rmsnorm.cu and Python")
    return secs


def kernel_entry(mangled: str) -> str:
    """``name<head_dim, type>`` (or ``name<true|false>`` for a kernel
    templated on a bool, ``name<BS, FROM_RGB, CSA>`` for Harris's tile
    kernel, ``name<float|float4>`` for K3) of a kernel from its mangled
    name."""
    m = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)(?:IL([ib])(\d+)E)?",
                  mangled)
    if not m:
        return mangled[:60]
    rest = mangled[m.end(1):]
    lits = re.findall(r"L([ib])(\d+)E", rest.split("Ev", 1)[0])
    if len(lits) > 1:
        return m.group(1) + "<" + ", ".join(
            v if t == "i" else ("true" if v == "1" else "false")
            for t, v in lits) + ">"
    vt = re.match(r"I(f|6float4)E", rest)
    if vt:
        return f"{m.group(1)}<{'float' if vt.group(1) == 'f' else 'float4'}>"
    if m.group(2) == "b":
        return f"{m.group(1)}<{'true' if m.group(3) == '1' else 'false'}>"
    dt = "bf16" if "__nv_bfloat16" in mangled else "f32"
    return m.group(1) + (f"<{m.group(3)}, {dt}>" if m.group(3) else "")


def ptxas_report(log: str) -> list:
    """[(kernel entry, its ptxas -v lines on registers and spills)] from an
    nvcc log."""
    out = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            out.append((kernel_entry(line), []))
        elif out and ("registers" in line or "spill" in line):
            out[-1][1].append(line.strip().removeprefix("ptxas info    : "))
    return out


def tc_resources() -> dict:
    """K7's, K8's and K9's kernels: registers and spills from the ptxas -v
    log that ``kernels/build.py`` keeps, the dynamic shared memory a block
    takes, and the tensor-core instructions ``cuobjdump -sass`` finds in
    each.  Fails unless every bf16 entry runs ``TC_SASS`` and no f32 entry
    runs a tensor-core instruction, and unless the f32 K7/K8/K9 entries
    spill nothing and take the shared memory ``fa.simt_fwd_smem_bytes`` or
    ``fa.simt_bwd_smem_bytes`` reckons."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    fwd, bwd = fa.library(), fa.bwd_library()       # built and loaded

    def smem_bytes(entry: str, hd: int, bf16: int) -> int:
        if "bwd" not in entry:
            return fwd.repro_flash_attention_smem_bytes(hd, bf16)
        return bwd.repro_flash_attention_bwd_smem_bytes(int("dkv" in entry),
                                                        hd, bf16)

    out = {}
    for name, label in TC_LIBRARIES.items():
        tc = sass_tensor_ops(name)
        entries = ptxas_report(build.build_logs.get(name, ""))
        for entry, lines in entries:
            hd = int(re.search(r"<(\d+),", entry).group(1))
            bf16 = entry.endswith("bf16>")
            r = out[entry] = {
                **ptxas_resources(lines),
                "smem_bytes": smem_bytes(entry, hd, int(bf16)),
                "sass": tc.get(entry, {})}
            print(f"[kernels] {label} {entry}: {r}")
            check(bool(r["sass"].get(TC_SASS)) if bf16 else not r["sass"],
                  f"{label} {entry}: tensor-core instructions {r['sass']}")
            if not bf16:                # the f32 K7/K8/K9 SIMT tiles
                reckon = (functools.partial(fa.simt_bwd_smem_bytes,
                                            "dkv" in entry, hd)
                          if "bwd" in entry else
                          functools.partial(fa.simt_fwd_smem_bytes, hd))
                check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                      f"{label} {entry} spills: {r}")
                check(r["smem_bytes"] == reckon(),
                      f"{label} {entry}: shared memory {r['smem_bytes']} "
                      f"differs from the Python reckoning {reckon()}")
                print(f"[kernels] {label} {entry} (f32 SIMT): registers "
                      f"{r['registers']}, 0 spill bytes, shared memory "
                      f"{reckon(stages=1)} bytes with one ring stage, "
                      f"{r['smem_bytes']} with two")
        kernels = 1 if name == "flash_attention" else 2
        check(len(entries) == 2 * kernels * len(fa.HEAD_DIMS),
              f"{label}'s ptxas log names {[e for e, _ in entries]}")
    return out


def sass_tensor_ops(name: str) -> dict:
    """{kernel entry: {tensor-core SASS op: count}} of the built library
    ``lib<name>``, from ``cuobjdump -sass``."""
    from repro_torch.kernels import build

    sass = subprocess.run(
        [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump"),
         "-sass", str(build.library_path(name))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    tc = {}
    for chunk in sass.split("Function : ")[1:]:
        ops = re.findall(r"\b(HGMMA|HMMA)\.", chunk)
        tc[kernel_entry(chunk.split()[0])] = {o: ops.count(o)
                                              for o in set(ops)}
    return tc


def ptxas_resources(lines: list) -> dict:
    """Registers and spill bytes from one entry's ptxas -v lines."""
    regs = re.search(r"Used (\d+) registers", " ".join(lines))
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      " ".join(lines))
    return {"registers": int(regs.group(1)) if regs else None,
            "spill_stores": int(spill.group(1)) if spill else None,
            "spill_loads": int(spill.group(2)) if spill else None}


def harris_resources() -> dict:
    """Every kernel of harris.cu: registers and spills from the ptxas -v
    log, and the dynamic shared memory a K2/K4 block takes at the main
    path's tile.  Fails on a spill, or unless the log names the nine
    entries."""
    from repro_torch.kernels import build, harris as hk

    out = {}
    for entry, lines in ptxas_report(build.build_logs.get("harris", "")):
        tile = re.match(r"harris_tile_kernel<(\d), (\w+), \w+>", entry)
        smem = None
        if tile:
            bs = int(tile.group(1))
            smem = hk.tile_smem_bytes(*hk.fused_tile(H, W, bs, device="cuda"),
                                      bs, tile.group(2) == "true")
        r = out[entry] = {**ptxas_resources(lines), "smem_bytes": smem}
        print(f"[kernels] harris.cu {entry}: {r}")
        check((r["spill_stores"], r["spill_loads"]) == (0, 0),
              f"{entry} spills: {r}")
    want = {"cvt_color_kernel", "convert_scale_abs_kernel<float>",
            "convert_scale_abs_kernel<float4>"} | {
        f"harris_tile_kernel<{bs}, {rgb}, {csa}>"
        for bs in (2, 3) for rgb, csa in (("false", "false"),
                                          ("true", "false"), ("true", "true"))}
    check(set(out) == want, f"harris's ptxas log names {sorted(out)}")
    return out


def k6_resources() -> dict:
    """K6's (and K5's) kernels in rmsnorm.cu: registers and spills from the
    ptxas -v log, the dynamic shared memory a K6 block takes, and the
    tensor-core instructions ``cuobjdump -sass`` finds.  Fails unless every
    K6 entry issues ``TC_SASS`` without spills and no K5 entry a
    tensor-core instruction."""
    from repro_torch.kernels import build, rmsnorm as rk

    tc = sass_tensor_ops("rmsnorm")
    out = {}
    for entry, lines in ptxas_report(build.build_logs.get("rmsnorm", "")):
        k6 = entry.startswith("rmsnorm_matmul_kernel")
        r = out[entry] = {**ptxas_resources(lines),
                          "smem_bytes": (rk.library()
                                         .repro_rmsnorm_matmul_smem_bytes()
                                         if k6 else None),
                          "sass": tc.get(entry, {})}
        print(f"[kernels] {'K6' if k6 else 'K5'} {entry}: {r}")
        check(bool(r["sass"].get(TC_SASS)) if k6 else not r["sass"],
              f"{entry}: tensor-core instructions {r['sass']}")
        check(not k6 or (r["spill_stores"], r["spill_loads"]) == (0, 0),
              f"{entry} spills: {r}")
    check(sorted(out) == ["rmsnorm_kernel<false>", "rmsnorm_kernel<true>",
                          "rmsnorm_matmul_kernel<false>",
                          "rmsnorm_matmul_kernel<true>"],
          f"rmsnorm's ptxas log names {sorted(out)}")
    return out


# --------------------------------------------------------------------------- #
# timing on the card
# --------------------------------------------------------------------------- #
def device_ms(fn, inputs, reps: int = 25, label: str = "",
              cycles: int = int(1e7)) -> float:       # ~5 ms at 1.98 GHz
    """Median device time of ``fn`` over ``reps`` runs.

    Each run is queued behind a short ``torch.cuda._sleep``, so the host has
    enqueued all of the run's launches before the card reaches them and the
    two events around it time the card, not Python's launch overhead.  (One
    sleep before all runs does not do: a plain version launches ~40 kernels
    a run, and the host blocks once about a thousand launches are pending.)
    ``inputs`` rotate so that together they exceed the 50 MB L2 cache: each
    run finds its input cold, as a frame of the stream does.
    """
    import torch

    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    for _ in range(4):
        times, ahead = [], True
        for i in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(cycles)
            a.record()
            fn(*inputs[i % len(inputs)])
            b.record()
            ahead = ahead and not a.query()      # the card was still asleep
            times.append((a, b))
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(a.elapsed_time(b) for a, b in times)
        cycles *= 4
    raise SmokeFailure(f"{label}: the host never got ahead of the card")


def rotation(make, nbytes: int) -> list:
    """Enough copies of an input that together they exceed the L2 cache."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]


# --------------------------------------------------------------------------- #
# 3. kernels against their plain versions
# --------------------------------------------------------------------------- #
def frame(h, w, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255).cuda()


def err_close(got, want, rtol=1e-5, atol=1e-3) -> float:
    """max |got - want|; fails beyond atol + rtol * |want| (cvt, csa)."""
    import torch

    d = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    check(bool((d <= atol + rtol * want.abs()).all()),
          f"kernel differs from its plain version by {d.max().item()}")
    return d.max().item()


def err_scaled(got, want, atol=1e-5) -> float:
    """max |got - want|; fails beyond atol * max |want| (Harris responses)."""
    import torch

    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    d = (got - want).abs().max().item()
    scale = want.abs().max().item() + 1e-9
    check(d / scale <= atol, f"Harris response differs by {d / scale} "
                             f"of its largest value")
    return d


def phase_kernels():
    import torch

    from repro_torch.kernels import harris as hk

    harris_resources()

    def same(got, want):                       # K2-K4: bit for bit
        check(torch.equal(got, want), "kernel differs from its plain version "
                                      "in some bit")
        return got

    errs = {k: 0.0 for k in hk.LAUNCHES}
    for i, (h, w) in enumerate([(H, W), *RAGGED]):
        img = frame(h, w, 100 + i)
        gray = hk.cvt_color_ref(img)
        errs["cvt_color"] = max(errs["cvt_color"],
                                err_close(hk.cvt_color(img), gray))
        x = torch.randn((h, w), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i)) * 300
        for a, b in ((1.0, 0.0), (0.01, 5.0), (-2.0, 100.0)):
            want = hk.convert_scale_abs_ref(x, a, b)
            errs["convert_scale_abs"] = max(
                errs["convert_scale_abs"],
                err_close(same(hk.convert_scale_abs(x, a, b), want), want))
        # a view 4 bytes past an aligned start takes the 4-byte loads
        xs = x.view(-1)[1:]
        same(hk.convert_scale_abs(xs, -2.0, 100.0),
             hk.convert_scale_abs_ref(xs, -2.0, 100.0))
        for bs in (2, 3):
            want = hk.corner_harris_ref(gray, bs)
            errs["corner_harris"] = max(
                errs["corner_harris"],
                err_scaled(same(hk.corner_harris(gray, bs), want), want))
            want_csa = hk.harris_fused_ref(img, bs, alpha=1e-6, beta=3.0)
            errs["harris_fused"] = max(
                errs["harris_fused"],
                err_scaled(same(hk.harris_fused(img, bs, with_csa=False),
                                want), want),
                err_close(same(hk.harris_fused(img, bs, alpha=1e-6, beta=3.0),
                               want_csa), want_csa))
        torch.cuda.synchronize()
        print(f"[kernels] {h}x{w}: K1-K4 (bs 2 and 3, K4 with and without "
              f"the epilogue) match their plain versions; K2-K4 bit for bit")

    # device times at the main path's shapes and parameters (bs 2; K4 as
    # the pair module the fused path resolves)
    n_px = H * W
    imgs = rotation(lambda: (frame(H, W, 7),), 16 * n_px)
    grays = rotation(lambda: (hk.cvt_color_ref(frame(H, W, 8)),), 8 * n_px)
    w = torch.tensor([0.299, 0.587, 0.114], device="cuda")
    ops = {"cvt_color": 5, "corner_harris": 36, "convert_scale_abs": 4,
           "harris_fused": 41}                           # flops per pixel
    moved = {"cvt_color": 16, "corner_harris": 8, "convert_scale_abs": 8,
             "harris_fused": 16}                         # HBM bytes per pixel
    runs = {
        "cvt_color": (imgs, hk.cvt_color, hk.cvt_color_ref,
                      lambda im: im @ w),
        "corner_harris": (grays, hk.corner_harris, hk.corner_harris_ref, None),
        "convert_scale_abs": (grays, hk.convert_scale_abs,
                              hk.convert_scale_abs_ref, None),
        "harris_fused": (imgs, hk.harris_fused_pair,
                         lambda im: hk.harris_fused_ref(im, with_csa=False),
                         None),
    }
    rows = {}
    for name, (inputs, kern, plain, library) in runs.items():
        t_bytes = moved[name] * n_px / HBM_BW * 1e3
        t_ops = ops[name] * n_px / FP32_PEAK * 1e3
        rows[name] = {
            "ms": device_ms(kern, inputs, label=name),
            "plain_ms": device_ms(plain, inputs, label=f"{name} plain"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (device_ms(library, inputs, label=f"{name} library")
                           if library else None),
            "max_abs_err": errs[name],
        }
        r = rows[name]
        print(f"[kernels] {name:18s} kernel_ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) library_ms={r['library_ms']} "
              f"max_abs_err={r['max_abs_err']}")
    feasible = [t for t in hk.TILE_CANDIDATES
                if hk.tile_score(t, H, W, 2, hk._device_class("cuda"))
                < math.inf]
    for name, inputs, kern in (
            ("corner_harris", grays, hk.corner_harris),
            ("harris_fused", imgs,
             lambda im, **kw: hk.harris_fused(im, with_csa=False, **kw))):
        tiles = {f"{th}x{tw}": round(device_ms(
            lambda x, t=(th, tw): kern(x, tile=t), inputs,
            label=f"{name} tile {th}x{tw}"), 5) for th, tw in feasible}
        print(f"[kernels] {name} ms by tile (autotuned "
              f"{hk.fused_tile(H, W, 2, device='cuda')}): {json.dumps(tiles)}")
    # what HBM gives at this size: a same-bytes copy of the gray plane (the
    # 8 B a pixel of K2's and K3's bound), not a call for the same function;
    # and what any launch costs timed this way, with no bytes to move
    plane = torch.empty((H, W), device="cuda")
    tiny = torch.ones(4, device="cuda")
    copy_ms = device_ms(lambda g: plane.copy_(g), grays, label="copy")
    floor_ms = device_ms(lambda t: t.add_(1.0), [(tiny,)], label="floor")
    print(f"[kernels] hbm_copy_ms={copy_ms:.5f} (out.copy_(gray), "
          f"{8 * n_px} bytes moved) launch_floor_ms={floor_ms:.5f} (add_ on "
          f"4 elements) beside K2's and K3's bound_ms="
          f"{rows['corner_harris']['bound_ms']:.5f}: K2 "
          f"{rows['corner_harris']['ms']:.5f}, K3 "
          f"{rows['convert_scale_abs']['ms']:.5f}")
    return rows, {"hbm_copy_ms": copy_ms, "launch_floor_ms": floor_ms}


def serve_args() -> dict:
    """The traced transformer at DeepSeek-67B widths
    (``repro_torch.configs.deepseek_67b.zoo_widths``) under the serving
    traffic."""
    from dataclasses import asdict

    from repro_torch.configs.deepseek_67b import zoo_widths

    return {**TRAFFIC, **asdict(zoo_widths)}


def phase_rmsnorm_kernels():
    """K5 and K6 against their plain versions at the serving path's group
    shapes (K5 [2048, 8192]; K6 [2048, 8192] @ [8192, 102400]) and at ragged
    shapes; K5 to 1e-5 and K6 to 1e-4 (the reference's tolerances), with
    the plain version's float32 products in full f32 (no TF32); K6's
    registers, spills, shared memory and tensor-core SASS; then their
    device times beside the bound, the plain version and the library
    yardstick (F.rms_norm; for K6 the composition F.rms_norm + matmul, as
    no single PyTorch call computes it).  K6's bound is its route's: the
    3xTF32 tensor work at the TF32 peak, with the f32 FMA bound beside it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rk

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    resources = k6_resources()
    g = torch.Generator("cuda").manual_seed(5)
    errs = {"rmsnorm": 0.0, "rmsnorm_matmul": 0.0}

    def inputs(n, d, dout):
        x = torch.randn((n, d), generator=g, device="cuda")
        s = torch.randn((d,), generator=g, device="cuda") * 0.2
        w = (torch.randn((d, dout), generator=g, device="cuda") * d ** -0.5
             if dout else None)
        return x, s, w

    d, vocab = serve_args()["d"], serve_args()["vocab"]
    for n, k, dout in [(GROUP_ROWS, d, vocab), *RMS_RAGGED]:
        x, s, w = inputs(n, k, dout)
        errs["rmsnorm"] = max(errs["rmsnorm"], err_close(
            rk.rmsnorm(x, s), rk.rmsnorm_ref(x, s), rtol=1e-5, atol=1e-5))
        errs["rmsnorm_matmul"] = max(errs["rmsnorm_matmul"], err_close(
            rk.rmsnorm_matmul(x, s, w), rk.rmsnorm_matmul_ref(x, s, w),
            rtol=1e-4, atol=1e-4))
        torch.cuda.synchronize()
        print(f"[kernels] rmsnorm [{n}, {k}] and rmsnorm_matmul "
              f"[{n}, {k}] @ [{k}, {dout}] match their plain versions")
        del x, s, w

    rows = {}
    # K5: inputs rotate past the L2 cache, as the serving path's do
    norm_in = rotation(lambda: inputs(GROUP_ROWS, d, 0)[:2],
                       8 * GROUP_ROWS * d)
    one = [(x, 1.0 + s) for x, s in norm_in]
    n_el = GROUP_ROWS * d
    t_bytes = (8 * n_el + 4 * d) / HBM_BW * 1e3
    t_ops = 5 * n_el / FP32_PEAK * 1e3
    rows["rmsnorm"] = {
        "ms": device_ms(rk.rmsnorm, norm_in, label="rmsnorm"),
        "plain_ms": device_ms(rk.rmsnorm_ref, norm_in, label="rmsnorm plain"),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": device_ms(
            lambda x, s1: F.rms_norm(x, (d,), s1, rk.EPS), one,
            label="rmsnorm library"),
        "library": "F.rms_norm"}
    del norm_in, one
    # K6 at the lm head of a group of 4: w alone (3.36 GB) is 67x the L2
    x, s, w = inputs(GROUP_ROWS, d, vocab)
    s1 = 1.0 + s
    flop = 2.0 * GROUP_ROWS * d * vocab
    t_ops = 3 * flop / TF32_PEAK * 1e3          # 3xTF32: three products
    t_bytes = 4.0 * (GROUP_ROWS * d + d + d * vocab
                     + GROUP_ROWS * vocab) / HBM_BW * 1e3
    kw = dict(reps=5, cycles=int(4e7))
    k6_ms = device_ms(rk.rmsnorm_matmul, [(x, s, w)], label="K6", **kw)
    rows["rmsnorm_matmul"] = {
        "ms": k6_ms,
        "plain_ms": device_ms(rk.rmsnorm_matmul_ref, [(x, s, w)],
                              label="K6 plain", **kw),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "fma_bound_ms": flop / FP32_PEAK * 1e3,
        "tensor_tflops": 3 * flop / k6_ms / 1e9,
        "library_ms": device_ms(
            lambda x, w: torch.matmul(F.rms_norm(x, (d,), s1, rk.EPS), w),
            [(x, w)], label="K6 library", **kw),
        "library": "F.rms_norm + torch.matmul (a composition)",
        "kernel_route": rk.GEMM_ROUTE, "resources": resources}
    del x, s, w, s1
    torch.cuda.empty_cache()
    for name, r in rows.items():
        r["max_abs_err"] = errs[name]
        print(f"[kernels] {name:18s} kernel_ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) library_ms={r['library_ms']:.5f} "
              f"[{r['library']}] max_abs_err={r['max_abs_err']}")
    r = rows["rmsnorm_matmul"]
    print(f"[kernels] rmsnorm_matmul route {r['kernel_route']}: "
          f"{r['tensor_tflops']:.1f} TFLOP/s of tensor work (3 products), "
          f"f32 FMA bound {r['fma_bound_ms']:.5f} ms")
    return rows


# --------------------------------------------------------------------------- #
# 4. the main path
# --------------------------------------------------------------------------- #
def host_ms_per_frame(fn, frames) -> float:
    import torch

    fn(frames)                                   # warmup
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fn(frames)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / len(frames))
    return best


def phase_main_path():
    import torch

    from repro_torch.core import Library, courier_offload
    from repro_torch.core.placement import is_hw
    from repro_torch.kernels import harris as hk
    from repro_torch.models.harris import (corner_harris_demo, make_frames,
                                           make_harris_db)

    frames = make_frames(N_FRAMES, H, W, seed=0, device="cuda")
    plain_app = corner_harris_demo(Library(make_harris_db(with_hw=False)))
    want = [plain_app(f) for f in frames]
    launches, times = {k: 0 for k in hk.LAUNCHES}, {}
    for fuse in (False, True):
        db = make_harris_db(with_hw=True)
        app = corner_harris_demo(Library(db))
        off = courier_offload(app, frames[0], db=db, fuse=fuse)
        nodes = {n.fn_key: n for n in off.pipeline.ir.nodes}
        hw_keys = (["cvtColor+cornerHarris", "convertScaleAbs"] if fuse else
                   ["cvtColor", "cornerHarris", "convertScaleAbs"])
        for k in hw_keys:
            check(k in nodes and is_hw(nodes[k].placement),
                  f"fuse={fuse}: {k} is not a hw node ({sorted(nodes)})")
        check(not is_hw(nodes["normalize"].placement), "normalize went hw")

        hk.reset_launches()
        torch.cuda.set_sync_debug_mode("error")   # the path never waits
        try:                                      # for the card
            got = off.map(frames)                 # the main path
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts = dict(hk.LAUNCHES)
        expect = ({"harris_fused": N_FRAMES, "convert_scale_abs": N_FRAMES}
                  if fuse else {"cvt_color": N_FRAMES,
                                "corner_harris": N_FRAMES,
                                "convert_scale_abs": N_FRAMES})
        check(counts == {k: expect.get(k, 0) for k in counts},
              f"fuse={fuse}: launch counts {counts}, expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        check(off.fallbacks == [] and off.plan.fallback_log == [],
              f"Off-load Switcher fell back: {off.fallbacks} "
              f"{off.plan.fallback_log}")
        for g, r in zip(got, want):
            check(g.shape == (H, W) and bool(torch.isfinite(g).all())
                  and float(g.min()) >= 0.0 and float(g.max()) <= 255.0,
                  "main-path output is not a finite [0, 255] frame")
            torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3)
        print(f"[main] fuse={fuse}: {off.pipeline.plan.n_stages} stages "
              f"{[s.node_names for s in off.pipeline.plan.stages]}; "
              f"launches {counts}; outputs equal the plain app (1e-3)")

        t = {"original_ms_per_frame":
             host_ms_per_frame(lambda fs: [app(f) for f in fs], frames),
             "run_sequential_ms_per_frame":
             host_ms_per_frame(off.pipeline.run_sequential, frames),
             "run_ms_per_frame": host_ms_per_frame(off.pipeline.run, frames),
             # the card's own time for one frame through the pipeline, with
             # the host ahead of it: what the stream would take if the host
             # never held the card back
             "device_ms_per_frame": device_ms(
                 off.pipeline, [(f,) for f in frames], reps=N_FRAMES,
                 label=f"pipeline fuse={fuse}")}
        t["device_idle_share"] = 1.0 - (t["device_ms_per_frame"]
                                        / t["run_ms_per_frame"])
        times[f"fuse={fuse}"] = t
        print(f"[main] fuse={fuse}: " + "  ".join(
            f"{k}={v:.4f}" for k, v in t.items()))
    return launches, times


# --------------------------------------------------------------------------- #
# 5. serving: the traced transformer, then the Harris pipeline
# --------------------------------------------------------------------------- #
def phase_serve(k6_ms: float):
    import torch

    from repro_torch.kernels import harris as hk, rmsnorm as rk
    from repro_torch.launch.serve import (serve_pipeline_demo,
                                          serve_traced_transformer_demo)

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls would run in TF32")
    rk.reset_launches()
    t0 = time.perf_counter()
    args = serve_args()
    st = serve_traced_transformer_demo(device="cuda", **args)
    torch.cuda.synchronize()
    counts = dict(rk.LAUNCHES)
    secs = time.perf_counter() - t0
    groups = st["warmup_groups"] + st["executor"]["groups_admitted"]
    check(st["fused_nodes"] == ["rmsnorm_4+matmul_0"],
          f"lm head not fused: {st['fused_nodes']}")
    check(st["hw_nodes"] == {**{f"rmsnorm_{i}": "rmsnorm" for i in range(4)},
                             "rmsnorm_4+matmul_0": "rmsnorm+matmul"},
          f"hw nodes {st['hw_nodes']}")
    check(counts == {"rmsnorm": 4 * groups, "rmsnorm_matmul": groups},
          f"launches {counts} for {groups} groups")
    # K6 has one route, whose kernels phase 3 found HGMMA in: every K6
    # launch (one a group, checked above) ran on the tensor cores
    routes = {rk.GEMM_ROUTE: counts["rmsnorm_matmul"]}
    check(st["requests_served"] == args["n_requests"] and st["failed"] == 0,
          f"served {st['requests_served']} of {args['n_requests']}")
    check(st["results_match"],
          f"served results differ from the untraced app by "
          f"{st['max_rel_err']} of their largest value")
    lat = st["latency_ms"]
    served_groups = st["executor"]["groups_admitted"]
    wall = 1e3 * st["requests_served"] / st["throughput_rps"] / served_groups
    dev = st["device_ms_per_group"]
    out = {"requests_served": st["requests_served"],
           "groups": served_groups, "warmup_groups": st["warmup_groups"],
           "latency_p50_ms": lat["p50"], "latency_p95_ms": lat["p95"],
           "requests_per_s": st["throughput_rps"],
           "wall_ms_per_group": wall, "device_ms_per_group": dev,
           "device_idle_share": 1.0 - dev / wall,
           "k6_share_of_device_time": k6_ms / dev, "k6_routes": routes,
           "max_rel_err": st["max_rel_err"], "stages": st["stages"],
           "profile": st["profile"], "seconds": secs}
    print(f"[serve] traced transformer at DeepSeek-67B widths: "
          f"{st['requests_served']} requests in {served_groups} groups over "
          f"{st['n_stages']} stages {st['stages']}; fused "
          f"{st['fused_nodes']}; launches {counts}; results match the "
          f"untraced app (max rel err {st['max_rel_err']})")
    print("[serve] " + "  ".join(
        f"{k}={out[k]}" for k in ("latency_p50_ms", "latency_p95_ms",
                                  "requests_per_s", "wall_ms_per_group",
                                  "device_ms_per_group", "device_idle_share",
                                  "k6_share_of_device_time", "k6_routes")))
    torch.cuda.empty_cache()

    hk.reset_launches()
    sp = serve_pipeline_demo(n_requests=N_FRAMES, max_batch=4, size=(H, W),
                             device="cuda")
    torch.cuda.synchronize()
    hcounts = dict(hk.LAUNCHES)
    check(sp["requests_served"] == N_FRAMES and sp["results_match"],
          f"Harris serving: {sp['requests_served']} served, max abs err "
          f"{sp['max_abs_err']}")
    ran = hcounts["cvt_color"]
    check(ran >= N_FRAMES + 1 and hcounts == {
        "cvt_color": ran, "corner_harris": ran, "convert_scale_abs": ran,
        "harris_fused": 0}, f"Harris serving launches {hcounts}")
    print(f"[serve] Harris pipeline: {sp['requests_served']} frames, "
          f"{sp['batches']} batches, launches {hcounts}, p50 "
          f"{sp['latency_ms']['p50']} ms, max abs err {sp['max_abs_err']}")
    return counts, hcounts, out


# --------------------------------------------------------------------------- #
# 5a. the replan loop and the hot swap; 5b. continuous decode on KV slots
# --------------------------------------------------------------------------- #
def zoo_params() -> dict:
    """The served transformer's weights, as phase 5 draws them (the same
    generator, seed and widths as ``serve_traced_transformer_demo``)."""
    import torch

    from repro_torch.models.zoo import init_transformer_params

    w = {k: serve_args()[k] for k in ("d", "n_layers", "ff", "n_heads",
                                      "vocab")}
    return init_transformer_params(
        torch.Generator(device="cuda").manual_seed(0), device="cuda", **w)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (inf when ``got`` is not finite)."""
    import torch

    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((got - want).abs().max() / want.abs().max())


def wait_all(reqs, timeout: float = 600.0) -> list:
    return [r.wait(timeout=timeout) for r in reqs]


def rate_window(srv, seqs: list, refs: list, n: int, depth: int,
                parts: int) -> dict:
    """Serve ``n`` requests (the inputs in turn) keeping ``depth`` in
    flight, each result held to its untraced reference as it lands (and
    then dropped, also from the server's record of finished requests: a
    result is [512, vocab] f32, 210 MB).  Returns the window's
    requests/s from the first submit to the last result, the same for each
    of ``parts`` consecutive slices of the results (their spread), and the
    worst relative error."""
    from collections import deque

    pending, done, worst = deque(), [], 0.0

    def land():
        i, r = pending.popleft()
        worst_i = rel_err(r.wait(timeout=600.0), refs[i % len(refs)])
        done.append(r.t_done)
        r.result = None       # the server keeps every finished request
        return worst_i

    t0 = time.perf_counter()
    for i in range(n):
        if len(pending) == depth:
            worst = max(worst, land())
        pending.append((i, srv.submit(seqs[i % len(seqs)])))
    while pending:
        worst = max(worst, land())
    done.sort()
    ends = [0] + [(k + 1) * n // parts for k in range(parts)]
    edges = [t0] + [done[e - 1] for e in ends[1:]]
    return {"requests": n, "depth": depth, "wall_ms": 1e3 * (done[-1] - t0),
            "requests_per_s": n / (done[-1] - t0),
            "requests_per_s_parts": [
                (ends[k + 1] - ends[k]) / (edges[k + 1] - edges[k])
                for k in range(parts)],
            "max_rel_err": worst}


def phase_replan(params: dict) -> tuple[dict, dict]:
    """The elastic planner over the traced transformer on the card: serve
    through ``executor_for(3)`` with a profiler, decide with
    ``replan_from_profile`` on the card's own stage times, then hot-swap to
    the decision's executor (or, if the planner keeps its plan, to the
    widened one) while requests are in flight."""
    import torch

    from repro_torch.analysis.verify import verify_enabled
    from repro_torch.core import (DeviceInventory, Frontend, Library,
                                  PipelineGenerator, StageProfiler)
    from repro_torch.core.placement import is_hw
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.launch.serve import RequestQueueServer
    from repro_torch.models.zoo import make_zoo_db, transformer_demo
    from repro_torch.runtime import ElasticPlanner

    cfg = REPLAN
    d = serve_args()["d"]
    torch.cuda.reset_peak_memory_stats()
    db = make_zoo_db()
    app = transformer_demo(Library(db), params)
    gen = torch.Generator(device="cuda").manual_seed(200)
    n_req = cfg["profile"] + cfg["in_flight"] + cfg["after"]
    seqs = [torch.randn((cfg["seq_len"], d), generator=gen, device="cuda")
            for _ in range(n_req)]
    refs = [app(x) for x in seqs]              # the untraced app, on the card
    ir, _ = Frontend(db).trace(app, seqs[0])
    pipe = PipelineGenerator(db).generate(ir, policy="optimal", fuse=True,
                                          max_stages=4)
    fused = [n.name for n in pipe.ir.nodes if n.fused_from]
    check(fused == ["rmsnorm_4+matmul_0"], f"lm head not fused: {fused}")
    planner = ElasticPlanner(pipe.ir, db=db, min_samples=cfg["min_samples"],
                             device="cuda")
    prof = StageProfiler(3, sample_every=1, min_samples=cfg["min_samples"])
    ex_a, _ = planner.executor_for(3, profiler=prof)
    rms_a = sum(n.fn_key == "rmsnorm" and is_hw(n.placement)
                for n in planner.layer_ir.nodes)
    stages_a = [list(s.node_names) for s in planner.current_plan.stages]
    ex_a.warmup(seqs[0])
    srv = RequestQueueServer(ex_a, max_batch=1, max_wait_ms=0.0)
    srv.start()
    try:
        p = cfg["profile"]
        results = wait_all([srv.submit(x) for x in seqs[:p]])

        # decide on the card's own stage times
        old_ir = planner.layer_ir
        modeled = {n.name: n.time_ms for n in old_ir.nodes}
        p50 = [prof.percentile_ms(k) for k in range(3)]
        decision = planner.replan_from_profile(prof)
        measured = {n.name: n.time_ms for n in old_ir.nodes}
        if decision.replanned:
            ex_b, how = decision.executor, "the decision's executor"
        else:
            ex_b, _ = planner.executor_for(
                3, profiler=prof.clone_for(3),
                worker_budget=cfg["worker_budget"])
            how = (f"the widened executor (worker budget "
                   f"{cfg['worker_budget']}, replicas {ex_b.replicas})")
        rms_b = sum(n.fn_key == "rmsnorm" and is_hw(n.placement)
                    for n in planner.layer_ir.nodes)
        k6_b = sum(n.fn_key == "rmsnorm+matmul" and is_hw(n.placement)
                   for n in planner.layer_ir.nodes)
        ex_b.warmup(seqs[0])                  # off the serving path
        window_a = rate_window(srv, seqs, refs, cfg["window"], cfg["depth"],
                               cfg["parts"])

        # swap with the next wave in flight on the old executor; the verify
        # gate (check_plan) runs on the new plan and IR before the swap
        rk.reset_launches()
        ex_a.reset_stats()
        wave_b = [srv.submit(x) for x in seqs[p:p + cfg["in_flight"]]]
        t_end = time.monotonic() + 600.0
        while any(r.t_batch is None for r in wave_b):
            check(time.monotonic() < t_end, "wave B never dispatched")
            time.sleep(0.001)
        check(verify_enabled(), "REPRO_VERIFY=off: the swap's verify gate "
                                "would not run")
        old = srv.swap_executor(ex_b, timeout=600.0, db=db,
                                plan=planner.current_plan,
                                ir=planner.layer_ir)
        in_flight_at_swap = sum(not r._event.is_set() for r in wave_b)
        check(old is ex_a and srv.swaps == 1 and in_flight_at_swap >= 1,
              f"swap: old is ex_a {old is ex_a}, swaps {srv.swaps}, "
              f"{in_flight_at_swap} requests in flight")
        wave_c = [srv.submit(x) for x in seqs[p + cfg["in_flight"]:]]
        results += wait_all(wave_b)
        results += wait_all(wave_c)
        window_b = rate_window(srv, seqs, refs, cfg["window"], cfg["depth"],
                               cfg["parts"])
    finally:
        srv.stop()
    torch.cuda.synchronize()
    counts = dict(rk.LAUNCHES)
    st, sa, sb = srv.stats(), ex_a.stats(), ex_b.stats()
    ex_a.close()
    ex_b.close()
    n_all = n_req + 2 * cfg["window"]
    check(st["requests_served"] == n_all and st["failed"] == 0
          and st["shed"] == 0 and st["expired"] == 0,
          f"replan serving: served {st['requests_served']} of {n_all}, "
          f"failed {st['failed']}, shed {st['shed']}, "
          f"expired {st['expired']}")
    check(sa.out_of_order_retired == 0 and sb.out_of_order_retired == 0
          and sa.tokens_failed == 0 and sb.tokens_failed == 0,
          f"retirement: {sa.as_dict()} {sb.as_dict()}")
    after_swap = cfg["after"] + cfg["window"]
    check(sa.tokens_retired >= 1 and sb.tokens_retired == after_swap
          and sa.tokens_retired + sb.tokens_retired
          == cfg["in_flight"] + after_swap,
          f"retired {sa.tokens_retired} on the old executor and "
          f"{sb.tokens_retired} on the new")
    want_k5 = sa.groups_admitted * rms_a + sb.groups_admitted * rms_b
    check(counts["rmsnorm"] == want_k5 and rms_a > 0 and rms_b > 0,
          f"K5 launches {counts['rmsnorm']}, expected {want_k5} "
          f"({sa.groups_admitted} x {rms_a} + {sb.groups_admitted} x "
          f"{rms_b})")
    errs = [rel_err(y, want) for y, want in zip(results, refs)]
    del results, refs
    before = max(errs[:p + cfg["in_flight"]] + [window_a["max_rel_err"]])
    after = max(errs[-cfg["after"]:] + [window_b["max_rel_err"]])
    check(max(before, after) <= 2e-4,
          f"served results differ from the untraced app by {errs}, "
          f"{window_a['max_rel_err']} and {window_b['max_rel_err']} (the "
          f"windows) of their largest value")
    print(f"[replan] {decision.describe()}")
    print(f"[replan] plan {stages_a}: measured stage p50 ms {p50}")
    for name in modeled:
        print(f"[replan]   node {name}: modeled {modeled[name]} ms -> "
              f"measured {measured[name]} ms")
    if decision.defused:
        print(f"[replan] the decision defused {decision.defused}: K6 is "
              f"not on the new executor (phase 5 launched it)")
    out = {"decision": decision.describe(), "replanned": decision.replanned,
           "defused": list(decision.defused), "stage_p50_ms": p50,
           "stages_before": stages_a,
           "stages_after": [list(s.node_names)
                            for s in planner.current_plan.stages],
           "swapped_to": how, "in_flight_at_swap": in_flight_at_swap,
           "verify_gate": "check_plan", "modeled_ms": modeled,
           "measured_ms": measured,
           "window_before": window_a, "window_after": window_b,
           "max_rel_err_before_swap": before,
           "max_rel_err_after_swap": after,
           "k5_launches": counts["rmsnorm"],
           "k6_launches": counts["rmsnorm_matmul"],
           "k6_on_new_executor": k6_b,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[replan] swapped mid-stream to {how} with {in_flight_at_swap} "
          f"requests in flight, after check_plan passed: "
          f"{st['requests_served']} served, 0 failed, 0 out of order; max "
          f"rel err {before} before, {after} after; launches {counts}")
    for side, w in (("before", window_a), ("after", window_b)):
        print(f"[replan] {side} the swap: {w['requests']} requests "
              f"{w['depth']} deep in {w['wall_ms']} ms: requests_per_s="
              f"{w['requests_per_s']} (by thirds "
              f"{w['requests_per_s_parts']})")
    print(f"[replan] peak {out['peak_gb']} GB allocated")

    inv = DeviceInventory.detect()
    diff = inv.refresh()
    check(len(inv) == 1 and not diff.changed
          and inv.spec(0).platform == "gpu",
          f"inventory {inv.describe()} refresh {diff.describe()}")
    print(f"[replan] {inv.describe()}; refresh: {diff.describe()}")
    out["inventory"] = diff.describe()
    del seqs, app, pipe, planner, ir
    torch.cuda.empty_cache()
    return counts, out


def decode_app(lib, params: dict):
    """One new token ``x: [1, d]`` and its slot id through the zoo
    transformer's rows with per-layer decode attention (rmsnorm,
    attention_decode_<i>, add, rmsnorm, swiglu, add), then the lm head's
    rmsnorm and matmul."""
    def app(x, slot):
        for i, ly in enumerate(params["layers"]):
            h = lib.rmsnorm(x, ly["ln1"])
            a = getattr(lib, f"attention_decode_{i}")(
                h, slot, ly["wq"], ly["wk"], ly["wv"], ly["wo"])
            x = lib.add(x, a)
            h = lib.rmsnorm(x, ly["ln2"])
            f = lib.swiglu(h, ly["wi"], ly["wo_ffn"])
            x = lib.add(x, f)
        h = lib.rmsnorm(x, params["ln_f"])
        return lib.matmul(h, params["w_out"])
    app.__name__ = "decode"
    return app


def serve_decode(srv, pools: list, firsts: list, w_out) -> list:
    """Greedy sessions: step t+1's token is the tied embedding (a column of
    the lm head) of step t's argmax; one session arrives each time an
    earlier step completes, so later sessions meet groups in flight.  The
    last step frees the session's slots through ``on_finish``.  Returns
    per session the (x, logits, latency ms) of every step."""
    import torch

    n, steps = len(firsts), DECODE["steps"]
    runs: list = [[] for _ in range(n)]
    slots: list = [None] * n
    xs = list(firsts)
    active: dict = {}

    def release(sess):
        for pool in pools:
            pool.free(slots[sess])

    def submit(sess):
        last = len(runs[sess]) == steps - 1
        active[sess] = srv.submit(
            xs[sess], slots[sess],
            priority="interactive" if not runs[sess] else "batch",
            on_finish=(lambda _r, s=sess: release(s)) if last else None)

    def admit(sess):
        ids = {pool.alloc() for pool in pools}
        check(len(ids) == 1, f"the layers' pools disagree on a slot: {ids}")
        slots[sess] = ids.pop()
        submit(sess)

    admit(0)
    nxt, t_end = 1, time.monotonic() + 600.0
    while active:
        check(time.monotonic() < t_end, "decode sessions did not finish")
        done = [s for s, r in active.items() if r._event.is_set()]
        if not done:
            time.sleep(0.0002)
            continue
        for sess in done:
            r = active.pop(sess)
            logits = r.wait(0)
            runs[sess].append((xs[sess], logits, r.latency_ms))
            xs[sess] = w_out[:, int(torch.argmax(logits))][None].clone()
            if len(runs[sess]) < steps:
                submit(sess)
            if nxt < n:
                admit(nxt)
                nxt += 1
    return runs


def phase_continuous(params: dict) -> tuple[dict, dict]:
    """KV-slot serving on the card: the traced decode app (per-layer
    KVSlotPools of 12 slots x 17 positions, k and v [64, 128] f32) behind
    ``RequestQueueServer(continuous=True)`` over an ``open_groups``
    executor, then the same sessions with ``continuous=False``; every
    step's logits against a full-prefix rerun of the untraced app."""
    import numpy as np
    import torch

    from repro_torch.core import (Frontend, Library, PipelineGenerator,
                                  StageProfiler)
    from repro_torch.core.placement import is_hw
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.launch.serve import RequestQueueServer
    from repro_torch.models.zoo import (make_zoo_db, register_decode_modules,
                                        transformer_demo)
    from repro_torch.runtime import KVSlotPool

    cfg, a = DECODE, serve_args()
    d, n_heads = a["d"], a["n_heads"]
    db = make_zoo_db()
    pools = [KVSlotPool(cfg["sessions"], cfg["max_seq"],
                        {"k": (n_heads, d // n_heads),
                         "v": (n_heads, d // n_heads)}, device="cuda")
             for _ in params["layers"]]
    for i, pool in enumerate(pools):
        register_decode_modules(db, pool, n_heads=n_heads,
                                name=f"attention_decode_{i}")
    app = decode_app(Library(db), params)
    x0 = torch.zeros((1, d), device="cuda")
    ir, _ = Frontend(db).trace(app, x0, torch.tensor(-1))
    check(all(p.allocs == 0 for p in pools), "the trace touched a slot")
    pipe = PipelineGenerator(db).generate(ir, policy="optimal", fuse=True,
                                          max_stages=3)
    stateful = [n for n in pipe.ir.nodes if n.state]
    check(len(stateful) == len(pools)
          and all(n.serial_only and not is_hw(n.placement) for n in stateful),
          f"stateful nodes {[(n.name, n.serial_only, str(n.placement)) for n in stateful]}")
    hw_rows = {n.name: n.fn_key for n in pipe.ir.nodes if is_hw(n.placement)}
    stages = [list(s.node_names) for s in pipe.plan.stages]
    print(f"[decode] plan {stages}; on K5/K6: {hw_rows}")
    plain = transformer_demo(Library(make_zoo_db()), params)
    gen = torch.Generator(device="cuda").manual_seed(300)
    firsts = [torch.randn((1, d), generator=gen, device="cuda")
              for _ in range(cfg["sessions"])]
    n_steps = cfg["sessions"] * cfg["steps"]
    counts_all = {k: 0 for k in rk.LAUNCHES}
    out = {"plan": stages, "hw_rows": hw_rows}
    for continuous in (True, False):
        mode = "continuous" if continuous else "batch-boundary"
        prof = StageProfiler(pipe.plan.n_stages, sample_every=1)
        ex = pipe.executor(microbatch=cfg["max_batch"], pad_microbatches=True,
                           buckets=(cfg["max_batch"],),
                           replicas=[1] * pipe.plan.n_stages,
                           open_groups=continuous, pad_token=(x0, -1),
                           max_in_flight=4 * cfg["max_batch"], profiler=prof)
        ex.warmup(x0, -1)
        rk.reset_launches()
        srv = RequestQueueServer(ex, max_batch=cfg["max_batch"],
                                 max_wait_ms=2.0, queue_depth=64,
                                 continuous=continuous)
        srv.start()
        box: dict = {}
        try:
            profile = device_profile(lambda: box.setdefault(
                "runs", serve_decode(srv, pools, firsts, params["w_out"])))
        finally:
            srv.stop()
        torch.cuda.synchronize()
        counts = dict(rk.LAUNCHES)
        for k, v in counts.items():
            counts_all[k] += v
        st, xst = srv.stats(), ex.stats()
        ex.close()
        for pool in pools:
            pool.check_no_leaks()
        check(st["requests_served"] == n_steps and st["failed"] == 0
              and st["shed"] == 0 and st["expired"] == 0
              and st["release_errors"] == 0,
              f"{mode}: served {st['requests_served']} of {n_steps} "
              f"({st['failed']} failed, {st['shed']} shed, {st['expired']} "
              f"expired, {st['release_errors']} release errors)")
        check(xst.out_of_order_retired == 0, f"{mode}: out of order")
        check(counts["rmsnorm"] > 0, f"{mode}: K5 never launched")
        if continuous:
            check(st["seam_joins"] >= 1, "no request joined at the seam")
        worst = 0.0
        for run in box["runs"]:
            check(len(run) == cfg["steps"], f"{mode}: a session ran "
                                             f"{len(run)} steps")
            xs = torch.cat([x for x, _, _ in run])
            for t, (_, logits, _) in enumerate(run):
                check(logits.shape == (1, a["vocab"]),
                      f"logits {tuple(logits.shape)}")
                worst = max(worst, rel_err(logits, plain(xs[:t + 1])[-1:]))
        check(worst <= 2e-4, f"{mode}: decode logits differ from the "
                             f"full-prefix rerun by {worst} of the largest")
        ttft = [run[0][2] for run in box["runs"]]
        # every group is padded to the one bucket of max_batch rows; the
        # window's mean fill is its seated rows (the steps) over all rows,
        # where seam_fill is the profiler's EMA over the last seals
        check(xst.tokens_retired == n_steps, f"{mode}: retired "
                                             f"{xst.tokens_retired} steps")
        r = {"ttft_p50_ms": float(np.percentile(ttft, 50)),
             "ttft_samples": len(ttft),
             "steps_per_s": 1e3 * n_steps / profile["wall_ms"],
             "device_ms_per_step": profile["device_busy_ms"] / n_steps,
             "device_idle_share": profile["device_idle_share"],
             "seam_joins": st["seam_joins"],
             "mean_fill": n_steps / (xst.groups_admitted * cfg["max_batch"]),
             "seam_fill_ema": prof.seam_fill(),
             "groups": xst.groups_admitted, "max_rel_err": worst,
             "launches": counts, "wall_ms": profile["wall_ms"]}
        out[mode] = r
        print(f"[decode] {mode}: {cfg['sessions']} sessions x "
              f"{cfg['steps']} steps in {xst.groups_admitted} groups; "
              f"launches {counts}; every step within {worst} of the "
              f"full-prefix rerun; slots leak-free")
        print(f"[decode] {mode}: " + "  ".join(
            f"{k}={r[k]}" for k in ("ttft_p50_ms", "ttft_samples",
                                    "steps_per_s", "device_ms_per_step",
                                    "device_idle_share", "seam_joins",
                                    "mean_fill", "seam_fill_ema")))
        del box
    del pools, pipe, ir, plain
    torch.cuda.empty_cache()
    return counts_all, out


# --------------------------------------------------------------------------- #
# K7 flash attention, and 6. the LM serving mode
# --------------------------------------------------------------------------- #
def visible_pairs(T: int, M: int, causal: bool, window: int) -> int:
    """(t, m) pairs a query row sees, summed over the T rows of one head."""
    import numpy as np

    t = np.arange(T)
    hi = np.minimum(t + 1, M) if causal else np.full(T, M)
    lo = np.maximum(t - window + 1, 0) if window > 0 else np.zeros(T, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(q, k, causal: bool, window: int) -> tuple[float, str]:
    """The least time for K7's work on these inputs: 4*hd FLOP per visible
    pair at the peak for their type, against q, k, v and o read or written
    once plus the f32 lse."""
    import torch

    B, T, H, hd = q.shape
    M = k.shape[1]
    flops = 4.0 * hd * B * H * visible_pairs(T, M, causal, window)
    peak = BF16_PEAK if q.dtype == torch.bfloat16 else FP32_PEAK
    nbytes = q.element_size() * 2 * B * H * hd * (T + M) + 4 * B * H * T
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BW * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def flash_err(q, k, v, causal: bool, window: int,
              fwd=None) -> tuple[float, float]:
    """K7 (or ``fwd``, called as ``fa.flash_attention_fwd`` is) against its
    plain version; returns max |o - o_ref| and the largest |o - o_ref| as a
    share of its element-wise limit.

    o within 2e-5 (f32) or 2.5e-2 (bf16) of max |o_ref|, and element by
    element: |o - o_ref| <= 2e-5 * (|o_ref| + rms(o_ref)) in f32, and
    <= 2^-7 * |o_ref| + 2^-8 * rms(o_ref) in bf16 (one bf16 ulp of the
    value, plus a margin for values near 0).  max |o_ref| is set by rows
    that see few keys, while rows deep in a causal span or a window average
    many v rows and are far smaller, so only the element-wise limit holds
    those rows' P.V sums.  lse within 1e-5 of max(1, |lse_ref|), element by
    element (rows that see no key have lse near -1e30)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    o, lse = (fwd or fa.flash_attention_fwd)(q, k, v, causal, window)
    ro, rlse = fa.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
          "non-finite K7 output")
    bf16 = q.dtype == torch.bfloat16
    ro = ro.float()
    diff = (o.float() - ro).abs()
    d, scale = diff.max().item(), ro.abs().max().item()
    rms = ro.square().mean().sqrt().item()
    limit = (2.0**-7 * ro.abs() + 2.0**-8 * rms if bf16
             else 2e-5 * (ro.abs() + rms))
    worst = (diff / limit).max().item()
    dl = ((lse - rlse).abs() / rlse.abs().clamp(min=1.0)).max().item()
    check(d <= (2.5e-2 if bf16 else 2e-5) * scale and worst <= 1.0
          and dl <= 1e-5,
          f"K7 {tuple(q.shape)} x {tuple(k.shape)} {q.dtype} causal={causal} "
          f"window={window}: o off by {d / scale} of max and by {worst} of "
          f"the element-wise limit, lse by {dl}")
    return d, worst


def phase_flash_kernels() -> float:
    """K7 at small and ragged shapes (T != M, lengths off the tile), at
    every head_dim it is built for, f32 and bf16, causal with and without a
    window, and non-causal with and without one; then at the driver run's
    shape, f32, with its two masks."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    resources = tc_resources()
    g = torch.Generator("cuda").manual_seed(7)
    err = worst = 0.0
    (dB, dT, dH, dM), dhd, dmasks = driver_attention()
    cases = [(hd, dt, shape, FA_MASKS) for hd in fa.HEAD_DIMS
             for dt in (torch.float32, torch.bfloat16) for shape in FA_RAGGED]
    cases.append((dhd, torch.float32, (dB, dT, dH, dM), dmasks))
    routes = {}
    for hd, dt, (B, T, H, M), masks in cases:
        q, k, v = (torch.randn((B, L, H, hd), generator=g,
                               device="cuda").to(dt) for L in (T, M, M))
        for causal, window in masks:
            d, w = flash_err(q, k, v, causal, window)
            err, worst = max(err, d), max(worst, w)
        routes[(hd, str(dt).removeprefix("torch."))] = kernel_routes(
            "flash_attention", len(masks))
    print(f"[kernels] flash_attention: hd {fa.HEAD_DIMS} x (f32, bf16) x "
          f"{FA_RAGGED} (B, T, H, M) x (causal, window) {FA_MASKS}, and the "
          f"driver's [{dB}, {dT}, {dH}, {dhd}] f32 x {dmasks}, match the "
          f"plain version (max abs err {err}, at most {worst} of the "
          f"element-wise limit)")
    print(f"[kernels] K7 routes by (head_dim, type): {routes}")
    return err, resources


def kernel_routes(name: str, n: int) -> str:
    """The route kernel ``name``'s last ``n`` launches took (read from the
    wrapper's per-route counts, which it then zeroes); fails unless one
    route took them all and it is the one ``fa.ROUTES`` names for their
    type."""
    from repro_torch.kernels import flash_attention as fa

    counts = fa.ROUTE_LAUNCHES[name]
    took = {r: c for r, c in counts.items() if c}
    for r in counts:
        counts[r] = 0
    check(len(took) == 1 and sum(took.values()) == n,
          f"{name}'s last {n} launches took the routes {took}")
    return next(iter(took))


def sdpa_backend(qt, kt, vt, mask, is_causal: bool) -> str:
    """The backend PyTorch's dispatcher picks for this SDPA call."""
    import torch
    from torch.nn.attention import SDPBackend

    i = int(torch._fused_sdp_choice(qt, kt, vt, mask, 0.0, is_causal))
    return next((n for n, b in SDPBackend.__members__.items()
                 if int(b) == i), str(i))


def device_profile(fn, groups: dict | None = None,
                   ranges: str | None = None) -> dict:
    """One run of ``fn`` under torch.profiler: the card's busy ms (the sum of
    its kernels' self times), the window's wall ms, the idle share, the
    kernels that took the most time, (``groups``: label -> substring of a
    kernel's name) the summed ms of each group, and (``ranges``: a prefix
    of ``record_function`` names) the card ms of the kernels launched
    inside each such range.  A range also shows on the card's timeline as
    an annotation, which is left out of the kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()

    def ranged(e) -> bool:
        return ranges is not None and e.key.startswith(ranges)

    kern = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in ev if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0 and not ranged(e)),
                  reverse=True)
    busy = sum(k[0] for k in kern)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if kern else None,
            "kernels": len(kern),
            "top": [{"ms": ms, "count": n, "name": name[:90]}
                    for ms, n, name in kern[:8]],
            "groups": {g: sum(ms for ms, _, name in kern if sub in name)
                       for g, sub in (groups or {}).items()},
            "ranges": {e.key: e.device_time_total / 1e3 for e in ev
                       if ranged(e) and e.device_type == DeviceType.CPU}}


def profile_lm(model, params, ids, n_decode: int) -> dict:
    """Where the LM's time goes: one prefill (with its first token), then
    ``n_decode`` decode steps, each window under the profiler."""
    import torch

    B, P = ids.shape
    state = {"cache": model.init_cache(B, P + n_decode, device="cuda")}

    def prefill():
        hp, state["cache"] = model.prefill(params, ids, state["cache"])
        state["tok"] = torch.argmax(model.logits(params, hp)[:, -1],
                                    dim=-1)[:, None]

    def decode():
        for t in range(n_decode):
            lg, state["cache"] = model.decode_step(params, state["tok"],
                                                   state["cache"], P + t)
            state["tok"] = torch.argmax(lg[:, -1], dim=-1)[:, None]

    out = {"prefill": device_profile(prefill),
           f"decode_{n_decode}_steps": device_profile(decode)}
    for k, v in out.items():
        print(f"[lm] profile {k}: wall {v['wall_ms']:.3f} ms, card busy "
              f"{v['device_busy_ms']:.3f} ms, idle share "
              f"{v['device_idle_share']}, {v['kernels']} kernel names")
        for t in v["top"]:
            print(f"[lm]   {t['ms']:10.3f} ms x{t['count']:<5d} {t['name']}")
    return out


def phase_lm(small_err: float):
    """K7 at the serving shape, then the LM serving mode's main path."""
    import gc

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import lm_config, serve_lm
    from repro_torch.models import LM
    from repro_torch.models import layers as ml

    gc.collect()
    torch.cuda.empty_cache()                 # the zoo's weights are gone
    torch.cuda.reset_peak_memory_stats()     # peak_gb: this phase's own
    print(f"[lm] {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
          f"before the LM")
    tr = LM_TRAFFIC
    cfg = lm_config(tr["arch"], reduced=False, layers=tr["layers"])
    check(cfg.dtype == "bfloat16" and cfg.hd == 256
          and list(cfg.layer_windows) == [1024] * 5 + [0],
          f"unexpected config {cfg}")
    model = LM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    B, P, N = tr["batch"], tr["prompt_len"], tr["tokens"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, P))
    ids = torch.as_tensor(prompt, device="cuda")
    print(f"[lm] {cfg.arch_id} at full widths, {cfg.n_layers} layers, "
          f"{cfg.n_params * 2 / 1e9:.3f} GB of bf16 weights "
          f"({torch.cuda.memory_allocated() / 1e9:.3f} GB allocated)")

    # the forward pass over the prompt (it warms cuBLAS for the prefill's
    # shapes), keeping K7's inputs at layer 0 (local) and 5 (global)
    taken, calls, real = {}, [], ml.ops.attention

    def record(q, k, v, causal=True, window=0):
        if len(calls) in (0, 5):
            taken[len(calls)] = (q, k, v, causal, window)
        calls.append(window)
        return real(q, k, v, causal, window)

    ml.ops.attention = record
    try:
        model.apply(params, ids)
    finally:
        ml.ops.attention = real
    check(calls == [1024] * 5 + [0], f"attention calls {calls}")

    err, per = small_err, {}
    for layer, kind in ((0, "local"), (5, "global")):
        q, k, v, causal, window = taken[layer]
        check(tuple(q.shape) == (B, P, cfg.n_heads, cfg.hd)
              and q.dtype == torch.bfloat16, f"K7 input {tuple(q.shape)}")
        fa.reset_launches()
        d, worst = flash_err(q, k, v, causal, window)
        route = kernel_routes("flash_attention", 1)
        err = max(err, d)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window:
            pos = torch.arange(P, device="cuda")
            mask = ml.attn_mask(pos, pos, window)
            lib = (lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask))
            backend = sdpa_backend(qt, kt, vt, mask, False)
        else:
            lib = (lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))
            backend = sdpa_backend(qt, kt, vt, None, True)
        kw = dict(reps=5, cycles=int(4e7))
        bound, by = attention_bound(q, k, causal, window)
        per[kind] = {
            "ms": device_ms(lambda q, k, v: fa.flash_attention_fwd(
                q, k, v, causal, window), [(q, k, v)], label=f"K7 {kind}",
                **kw),
            "plain_ms": device_ms(lambda q, k, v: fa.flash_attention_ref(
                q, k, v, causal, window), [(q, k, v)],
                label=f"K7 {kind} plain", **kw),
            "bound_ms": bound, "bound_by": by,
            "library_ms": device_ms(lib, [(qt, kt, vt)],
                                    label=f"K7 {kind} library", **kw),
            "library": f"F.scaled_dot_product_attention ({backend})",
            "pairs": B * cfg.n_heads * visible_pairs(P, P, causal, window),
            "max_abs_err": d, "err_of_elementwise_limit": worst,
            "route": route}
        r = per[kind]
        r["tflops"] = 4.0 * cfg.hd * r["pairs"] / r["ms"] / 1e9
        r["bound_tflops"] = 4.0 * cfg.hd * r["pairs"] / r["bound_ms"] / 1e9
        print(f"[lm] K7 {kind} layer {layer} (window {window}) at "
              f"[{B}, {P}, {cfg.n_heads}, {cfg.hd}] bf16 (route {route}): "
              f"kernel_ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({by}) library_ms="
              f"{r['library_ms']:.5f} [{r['library']}] pairs={r['pairs']} "
              f"TFLOP/s={r['tflops']:.2f} (bound {r['bound_tflops']:.2f}) "
              f"max_abs_err={d} ({worst} of the element-wise limit)")
        del q, k, v, qt, kt, vt
    taken.clear()
    torch.cuda.empty_cache()

    # the main path: serve_lm, after one short warm-up run (decode shapes)
    serve_lm(cfg, params, prompt, tokens=2, device="cuda")
    fa.reset_launches()
    st = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                  keep_logits=True)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    check(st["k7_launches_prefill"] == cfg.n_layers
          and st["k7_launches_decode"] == 0
          and counts == {"flash_attention": cfg.n_layers,
                         "flash_attention_bwd_dq": 0,
                         "flash_attention_bwd_dkv": 0},
          f"K7 launches {counts}: prefill {st['k7_launches_prefill']}, "
          f"decode {st['k7_launches_decode']}")
    check(st["finite"] and st["ids"].shape == (B, N),
          f"decode produced {st['ids'].shape}, finite={st['finite']}")

    # the decode loop's logits against LM.apply over prompt + generated
    full = torch.cat([ids, torch.as_tensor(st["ids"], device="cuda")], dim=1)
    h, _ = model.apply(params, full)                     # K7 at T = 4128
    want = model.logits(params, h[:, P - 1:P + N])
    got = st["logits"]
    check(got.shape == want.shape == (B, N + 1, cfg.vocab),
          f"logits {tuple(got.shape)} vs {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
          "non-finite logits")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel <= 2.5e-2, f"decode logits differ from LM.apply by {rel} of "
                         f"the largest")
    agree = (torch.argmax(want, dim=-1)[:, :N].cpu().numpy()
             == st["ids"]).mean()
    k7_ms = ((cfg.n_layers - 1) * per["local"]["ms"] + per["global"]["ms"])
    out = {k: st[k] for k in ("prefill_ms", "prefill_tok_s",
                              "prefill_device_ms", "decode_ms_per_token",
                              "decode_tok_s", "k7_launches_prefill",
                              "k7_launches_decode")}
    out.update({"k7_ms_per_prefill": k7_ms,
                "k7_share_of_prefill_device_time":
                    k7_ms / st["prefill_device_ms"],
                "logits_max_rel_err": rel,
                "greedy_agreement_with_apply": float(agree),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "k7": per})
    print(f"[lm] serve_lm: {B} x {P} prompt, {N} tokens; K7 launches "
          f"{counts} (all in the prefill); decode logits equal LM.apply "
          f"within {rel} of the largest (greedy agreement {agree})")
    print("[lm] " + "  ".join(f"{k}={out[k]}" for k in (
        "prefill_ms", "prefill_tok_s", "prefill_device_ms",
        "decode_ms_per_token", "decode_tok_s", "k7_ms_per_prefill",
        "k7_share_of_prefill_device_time")))
    out["profile"] = profile_lm(model, params, ids, n_decode=8)
    del model, params, ids, full, h, want, got, st
    gc.collect()
    torch.cuda.empty_cache()
    row = {**per["global"], "max_abs_err": err,
           **{f"local_{k}": per["local"][k] for k in (
               "ms", "plain_ms", "bound_ms", "library_ms", "library",
               "max_abs_err", "err_of_elementwise_limit", "tflops")}}
    return row, counts, out


# --------------------------------------------------------------------------- #
# 7. training: K8 and K9, full-width steps, the fault-tolerant driver
# --------------------------------------------------------------------------- #
def grad_err(got, want) -> tuple[float, float]:
    """max |g - g_ref| and its largest share of the element-wise limit:
    |g - g_ref| <= 2^-7 |g_ref| + 2^-8 rms(g_ref) in bf16 (one ulp plus a
    margin near 0), <= 2e-4 (|g_ref| + rms(g_ref)) in f32."""
    import torch

    check(bool(torch.isfinite(got).all()), "non-finite gradient")
    bf16 = got.dtype == torch.bfloat16
    want = want.float()
    diff = (got.float() - want).abs()
    rms = want.square().mean().sqrt()
    limit = (2.0**-7 * want.abs() + 2.0**-8 * rms if bf16
             else 2e-4 * (want.abs() + rms))
    return diff.max().item(), (diff / limit).max().item()


def flash_bwd_err(q, k, v, do, causal: bool, window: int) -> dict:
    """The Function's (dq, dk, dv) — K7, then K8 and K9 — against
    ``torch.autograd.grad`` through ``flash_attention_ref``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fa.flash_attention(*leaves, causal, window),
                              leaves, do)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.flash_attention_ref(*ref, causal,
                                                      window)[0], ref, do)
    torch.cuda.synchronize()
    e = {n: grad_err(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    worst = max(w for _, w in e.values())
    check(worst <= 1.0,
          f"K8/K9 {tuple(q.shape)} x {tuple(k.shape)} {q.dtype} "
          f"causal={causal} window={window}: a gradient is off by {worst} "
          f"of its element-wise limit ({e})")
    return {"flash_attention_bwd_dq": e["dq"],
            "flash_attention_bwd_dkv": max(e["dk"], e["dv"])}


def driver_inputs(g, n: int) -> list:
    """``n`` tensors at the driver run's attention shape ([B, T, H, hd],
    f32), enough copies of each set that together they exceed the L2."""
    import torch

    (B, T, H, _), hd, _ = driver_attention()
    nbytes = 4 * n * B * T * H * hd
    return rotation(lambda: tuple(torch.randn((B, T, H, hd), generator=g,
                                              device="cuda")
                                  for _ in range(n)), nbytes)


def sdpa_f32(window: int):
    """F.scaled_dot_product_attention over [B, H, T, hd] f32 tensors with
    the driver's mask (causal, and the window when there is one), and the
    backend PyTorch picks for it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as ml

    (B, T, H, _), hd, _ = driver_attention()
    mask = None
    if window:
        pos = torch.arange(T, device="cuda")
        mask = ml.attn_mask(pos, pos, window)
    q = torch.zeros((B, H, T, hd), device="cuda")
    backend = sdpa_backend(q, q, q, mask, mask is None)

    def call(q, k, v):
        if mask is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return call, backend


def f32_route_timing(floor_ms: float) -> dict:
    """K7 (forward), K8 and K9 on their f32 SIMT route at the driver run's
    shape, the one with the most launches, under both of its masks: each
    kernel's device time beside its bound, the plain version and
    F.scaled_dot_product_attention (its backward for K8/K9), with the
    launch floor of this timing (a launch with no bytes) beside them."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(23)
    (B, T, H, _), hd, masks = driver_attention()
    rows = {}
    for causal, window in masks:
        kind = f"window {window}" if window else "causal"
        fwd_in = driver_inputs(g, 3)
        q, k, v = fwd_in[0]
        bound, by = attention_bound(q, k, causal, window)
        lib, backend = sdpa_f32(window)
        rows.setdefault("flash_attention", {})[kind] = {
            "ms": device_ms(lambda q, k, v: fa.flash_attention_fwd(
                q, k, v, causal, window), fwd_in, label=f"K7 f32 {kind}"),
            "plain_ms": device_ms(lambda q, k, v: fa.flash_attention_ref(
                q, k, v, causal, window), fwd_in,
                label=f"K7 f32 {kind} plain"),
            "bound_ms": bound, "bound_by": by,
            "library_ms": device_ms(
                lib, [tuple(t.transpose(1, 2) for t in x) for x in fwd_in],
                label=f"K7 f32 {kind} library"),
            "library": f"F.scaled_dot_product_attention ({backend})"}
        bwd_in = []
        for q, k, v, do in driver_inputs(g, 4):
            lse = fa.flash_attention_fwd(q, k, v, causal, window)[1]
            delta = fa.flash_attention_bwd_dq(q, k, v, lse, do, causal,
                                              window)[1]
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            bwd_in.append((q, k, v, do, lse, delta,
                           lib(qt, kt, vt), (qt, kt, vt), do.transpose(1, 2)))
        lib_ms = device_ms(lambda *a: torch.autograd.grad(
            a[6], a[7], a[8], retain_graph=True), bwd_in,
            label=f"SDPA f32 backward {kind}")
        for name, fn, plain, flops, t_rows, m_rows in (
                ("flash_attention_bwd_dq",
                 lambda q, k, v, do, lse, delta, *_: fa.flash_attention_bwd_dq(
                     q, k, v, lse, do, causal, window),
                 lambda q, k, v, do, lse, delta, *_:
                     fa.flash_attention_bwd_dq_ref(q, k, v, lse, do, causal,
                                                   window), 6, 3, 2),
                ("flash_attention_bwd_dkv",
                 lambda q, k, v, do, lse, delta, *_:
                     fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal, window),
                 lambda q, k, v, do, lse, delta, *_:
                     fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    causal, window),
                 8, 2, 4)):
            q, k = bwd_in[0][:2]
            bound, by, _ = bwd_bound(q, k, causal, window, flops, t_rows,
                                     m_rows)
            rows.setdefault(name, {})[kind] = {
                "ms": device_ms(fn, bwd_in, label=f"{name} f32 {kind}"),
                "plain_ms": device_ms(plain, bwd_in,
                                      label=f"{name} f32 {kind} plain"),
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library": f"backward of F.scaled_dot_product_attention "
                           f"({backend}; dq, dk and dv together)"}
        del fwd_in, bwd_in
    fa.reset_launches()
    torch.cuda.empty_cache()
    for name, per in rows.items():
        for kind, r in per.items():
            r["launch_floor_ms"] = floor_ms
            print(f"[train] {name} f32 (route simt_f32) at the driver's "
                  f"[{B}, {T}, {H}, {hd}] {kind}: kernel_ms={r['ms']:.5f} "
                  f"plain_ms={r['plain_ms']:.5f} bound_ms="
                  f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms="
                  f"{r['library_ms']:.5f} [{r['library']}] launch_floor_ms="
                  f"{floor_ms:.5f}")
    return rows


def phase_flash_bwd_kernels(floor_ms: float) -> tuple[dict, dict]:
    """K8 and K9 at small and ragged shapes (T != M, lengths off the tile;
    rows that see no key under window 40 at T = 300, M = 200), at every
    head_dim, f32 and bf16, with the four masks; then at the driver run's
    shape, f32, with its two masks, where K7, K8 and K9 are also timed
    (``f32_route_timing``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(17)
    errs = {"flash_attention_bwd_dq": (0.0, 0.0),
            "flash_attention_bwd_dkv": (0.0, 0.0)}
    (dB, dT, dH, dM), dhd, dmasks = driver_attention()
    shapes = [(hd, dt, shape, FA_MASKS) for hd in fa.HEAD_DIMS
              for dt in (torch.float32, torch.bfloat16) for shape in FA_RAGGED]
    shapes.append((dhd, torch.float32, (dB, dT, dH, dM), dmasks))
    cases, routes = 0, {}
    fa.reset_launches()
    for hd, dt, (B, T, H, M), masks in shapes:
        q, k, v, do = (torch.randn((B, L, H, hd), generator=g,
                                   device="cuda").to(dt)
                       for L in (T, M, M, T))
        for causal, window in masks:
            for n, (d, w) in flash_bwd_err(q, k, v, do, causal,
                                           window).items():
                errs[n] = (max(errs[n][0], d), max(errs[n][1], w))
            cases += 1
        routes[(hd, str(dt).removeprefix("torch."))] = tuple(
            kernel_routes(n, len(masks)) for n in fa.LAUNCHES)
    for n, (d, w) in errs.items():
        print(f"[train] {n}: {cases} cases (hd {fa.HEAD_DIMS} x (f32, "
              f"bf16) x {FA_RAGGED} (B, T, H, M) x {FA_MASKS}, and the "
              f"driver's [{dB}, {dT}, {dH}, {dhd}] f32 x {dmasks}) match "
              f"autograd through the plain forward: max abs err {d}, worst "
              f"case {w} of its element-wise limit")
    print(f"[train] K7/K8/K9 routes by (head_dim, type): {routes}")
    return errs, f32_route_timing(floor_ms)


def bwd_bound(q, k, causal: bool, window: int, flops_per_hd: int,
              t_rows: int, m_rows: int) -> tuple[float, str, int]:
    """The least time for a backward kernel on these inputs: ``flops_per_hd``
    * hd FLOP per visible pair at the peak for the type, against
    ``t_rows`` tensors of T rows and ``m_rows`` of M rows (each [B, *, H,
    hd], read or written once) plus two f32 [B*H, T] rows (lse, delta)."""
    import torch

    B, T, H, hd = q.shape
    M = k.shape[1]
    pairs = B * H * visible_pairs(T, M, causal, window)
    peak = BF16_PEAK if q.dtype == torch.bfloat16 else FP32_PEAK
    nbytes = (q.element_size() * B * H * hd * (t_rows * T + m_rows * M)
              + 8 * B * H * T)
    t_ops = flops_per_hd * hd * pairs / peak * 1e3
    t_bytes = nbytes / HBM_BW * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", pairs)


def phase_bwd_timing(small: dict) -> tuple[dict, dict]:
    """K8 and K9 at the training shape, [2, 4096, 16, 256] bf16, on the
    global (causal) and a local (window 1024) layer: K7's o and lse held to
    the plain forward (and K7 timed beside its bound), K8/K9 to the plain
    backward from K7's lse, then timed beside the bound, the plain version
    and the backward of F.scaled_dot_product_attention."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as ml

    B, T, H, hd = TRAIN["batch"], TRAIN["seq_len"], 16, 256
    g = torch.Generator("cuda").manual_seed(11)
    q, k, v, do = (torch.randn((B, T, H, hd), generator=g, device="cuda"
                               ).bfloat16() for _ in range(4))
    per, errs = {}, dict(small)
    kw = dict(reps=5, cycles=int(4e7))
    k7 = {}
    for kind, causal, window in (("global", True, 0), ("local", True, 1024)):
        fa.reset_launches()
        d, w = flash_err(q, k, v, causal, window)
        route = kernel_routes("flash_attention", 1)
        bound, by = attention_bound(q, k, causal, window)
        flops = 4.0 * hd * B * H * visible_pairs(T, T, causal, window)
        ms = device_ms(lambda q, k, v: fa.flash_attention_fwd(
            q, k, v, causal, window), [(q, k, v)], label=f"K7 {kind} train",
            **kw)
        k7[kind] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                    "tflops": flops / ms / 1e9,
                    "bound_tflops": flops / bound / 1e9, "route": route,
                    "max_abs_err": d, "err_of_elementwise_limit": w}
        print(f"[train] flash_attention {kind} (window {window}) at [{B}, "
              f"{T}, {H}, {hd}] bf16 (route {route}) matches the plain "
              f"forward: max abs err {d}, {w} of the element-wise limit; "
              f"kernel_ms={ms:.5f} TFLOP/s={flops / ms / 1e9:.2f} bound_ms="
              f"{bound:.5f} ({by}, {flops / bound / 1e9:.2f} TFLOP/s)")
        fa.reset_launches()
        lse = fa.flash_attention_fwd(q, k, v, causal, window)[1]
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, lse, do, causal,
                                              window)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                            window)
        bwd_route = [kernel_routes(n, 1) for n in (
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")]
        check(bwd_route == ["wgmma_bf16"] * 2,
              f"K8/K9 at the training shape took {bwd_route}")
        want = fa.flash_attention_bwd_ref(q, k, v, lse, do, causal, window)
        e = {n: grad_err(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                  (dq, dk, dv), want)}
        check(max(w for _, w in e.values()) <= 1.0,
              f"K8/K9 at the training shape ({kind}): {e}")
        del dq, dk, dv, want
        errs["flash_attention_bwd_dq"] = max(errs["flash_attention_bwd_dq"],
                                             e["dq"])
        errs["flash_attention_bwd_dkv"] = max(
            errs["flash_attention_bwd_dkv"], e["dk"], e["dv"])

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        if window:
            pos = torch.arange(T, device="cuda")
            mask = ml.attn_mask(pos, pos, window)
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            backend = sdpa_backend(qt, kt, vt, mask, False)
        else:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
            backend = sdpa_backend(qt, kt, vt, None, True)
        dot = do.transpose(1, 2)
        lib_ms = device_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), [()],
            label=f"SDPA backward {kind}", **kw)
        del out, qt, kt, vt
        for name, fn, plain, flops, rows in (
                ("flash_attention_bwd_dq",
                 lambda: fa.flash_attention_bwd_dq(q, k, v, lse, do,
                                                   causal, window),
                 lambda: fa.flash_attention_bwd_dq_ref(q, k, v, lse, do,
                                                       causal, window),
                 6, (3, 2)),
                ("flash_attention_bwd_dkv",
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                    causal, window),
                 lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                        delta, causal,
                                                        window),
                 8, (2, 4))):
            bound, by, pairs = bwd_bound(q, k, causal, window, flops, *rows)
            r = per.setdefault(name, {})[kind] = {
                "ms": device_ms(fn, [()], label=f"{name} {kind}", **kw),
                "plain_ms": device_ms(plain, [()], label=f"{name} {kind} "
                                      f"plain", **kw),
                "bound_ms": bound, "bound_by": by, "pairs": pairs,
                "library_ms": lib_ms,
                "library": f"backward of F.scaled_dot_product_attention "
                           f"({backend}; dq, dk and dv together)",
                "max_abs_err": (e["dq"] if name.endswith("dq")
                                else max(e["dk"], e["dv"]))[0],
                "route": bwd_route[0]}
            r["tflops"] = flops * hd * pairs / r["ms"] / 1e9
            print(f"[train] {name} {kind} (window {window}) at [{B}, {T}, "
                  f"{H}, {hd}] bf16 (route {r['route']}): kernel_ms="
                  f"{r['ms']:.5f} TFLOP/s={r['tflops']:.2f} plain_ms="
                  f"{r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} ({by}) "
                  f"library_ms={r['library_ms']:.5f} [{r['library']}] "
                  f"pairs={pairs}")
        fa.reset_launches()
        del lse, delta
    torch.cuda.empty_cache()
    rows = {}
    for name, r in per.items():
        rows[name] = {**r["global"], "max_abs_err": errs[name][0],
                      "err_of_elementwise_limit": errs[name][1],
                      **{f"local_{f}": r["local"][f] for f in (
                          "ms", "plain_ms", "bound_ms", "library_ms",
                          "pairs", "tflops")}}
    return rows, k7


def phase_train() -> tuple[dict, dict]:
    """Full-width training through ``launch.train.build``'s step."""
    import gc

    import torch

    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import lm_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import build
    from repro_torch.models import LM

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated "
          f"before training")
    tr = TRAIN
    cfg = lm_config(tr["arch"], reduced=False, layers=tr["layers"])
    check(cfg.dtype == "bfloat16" and cfg.hd == 256
          and list(cfg.layer_windows) == [1024] * 5 + [0],
          f"unexpected config {cfg}")
    n_steps = 1 + tr["timed"] + 1
    torch.cuda.reset_peak_memory_stats()
    state, step, data = build(cfg, n_steps, tr["lr"], tr["seq_len"],
                              tr["batch"], device="cuda")
    n_params = sum(p.numel() for p in leaves(state["params"]))
    torch.cuda.synchronize()
    print(f"[train] {cfg.arch_id} at full widths, {cfg.n_layers} layers, "
          f"{n_params} parameters; {torch.cuda.memory_allocated() / 1e9:.3f} "
          f"GB of weights and AdamW moments allocated")
    tokens = tr["batch"] * tr["seq_len"]
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers}

    # the main path: one warm-up step, then the timed steps
    fa.reset_launches()
    losses, wall, card = [], [], []
    for i in range(1 + tr["timed"]):
        before = dict(fa.LAUNCHES)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        state, met = step(state, batch)
        b.record()
        loss = float(met["loss"])
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        card.append(a.elapsed_time(b))
        losses.append(loss)
        got = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        check(got == per_step, f"step {i}: launches {got}, expected "
                               f"{per_step}")
        check(math.isfinite(loss), f"step {i}: loss {loss}")
        print(f"[train] step {i}: loss {loss} grad_norm "
              f"{float(met['grad_norm'])} lr {float(met['lr'])} wall "
              f"{wall[-1]:.3f} ms card {card[-1]:.3f} ms launches {got}")
    counts = dict(fa.LAUNCHES)
    routes = {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()}
    check(all(routes[k] == {"wgmma_bf16": n, "simt_f32": 0}
              for k, n in counts.items()),
          f"training steps' K7/K8/K9 routes {routes}")
    print(f"[train] every K7/K8/K9 launch of the steps took the tensor-core "
          f"route: {routes}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(wall[1:])
    out = {"losses": losses, "step_ms": wall, "card_step_ms": card,
           "median_step_ms": step_ms,
           "median_card_step_ms": statistics.median(card[1:]),
           "tokens_per_s": tokens / step_ms * 1e3,
           "peak_gb": peak, "n_params": n_params,
           "launches_per_step": per_step}
    prof = device_profile(
        lambda: step(state, data.batch(1 + tr["timed"])),
        groups={"K7": "flash_fwd", "K8": "flash_bwd_dq",
                "K9": "flash_bwd_dkv"})
    prof["k7_k8_k9_share_of_busy"] = (sum(prof["groups"].values())
                                      / prof["device_busy_ms"])
    out["profile"] = prof
    print(f"[train] {tr['timed']} timed steps: median {step_ms:.3f} ms wall, "
          f"{out['median_card_step_ms']:.3f} ms card, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {peak:.3f} GB; losses "
          f"{losses}")
    print(f"[train] profile of one step: wall {prof['wall_ms']:.3f} ms, card "
          f"busy {prof['device_busy_ms']:.3f} ms, idle share "
          f"{prof['device_idle_share']}, K7/K8/K9 ms {prof['groups']} "
          f"({prof['k7_k8_k9_share_of_busy']} of the busy time)")
    for t in prof["top"]:
        print(f"[train]   {t['ms']:10.3f} ms x{t['count']:<5d} {t['name']}")

    # one more step's loss and gradients from the same state and batch,
    # with the kernels and with the plain attention under autograd
    model, batch = LM(cfg), data.batch(n_steps)
    b = {"ids": torch.as_tensor(batch.ids, device="cuda").long(),
         "labels": torch.as_tensor(batch.labels, device="cuda").long(),
         "mask": torch.as_tensor(batch.mask, device="cuda")}
    k_loss, k_grads, _ = loss_and_grads(model, state["params"], b)
    real = ops.attention
    ops.attention = (lambda q, k, v, causal=True, window=0:
                     fa.flash_attention_ref(q, k, v, causal, window)[0])
    try:
        p_loss, p_grads, _ = loss_and_grads(model, state["params"], b)
    finally:
        ops.attention = real
    torch.cuda.synchronize()
    g_err = max(((kg.float() - pg.float()).abs().max()
                 / pg.float().abs().max()).item()
                for kg, pg in zip(k_grads, p_grads))
    l_err = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    check(math.isfinite(float(k_loss)) and l_err <= 2.5e-2
          and g_err <= 2.5e-2,
          f"kernel step vs plain-attention step: loss {float(k_loss)} vs "
          f"{float(p_loss)}, largest per-leaf gradient error {g_err}")
    out.update({"kernel_vs_plain_loss": [float(k_loss), float(p_loss)],
                "kernel_vs_plain_loss_rel_err": l_err,
                "kernel_vs_plain_grad_max_rel_err": g_err})
    print(f"[train] kernel step vs plain-attention step: loss "
          f"{float(k_loss)} vs {float(p_loss)} (rel err {l_err}); largest "
          f"per-leaf max|dg|/max|g_ref| {g_err} (limit 2.5e-2)")
    del state, k_grads, p_grads, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def phase_driver() -> tuple[dict, dict]:
    """FaultTolerantDriver on the card at examples/train_100m.py's widths,
    with a checkpoint store in a temporary directory and one scripted step
    fault."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import build
    from repro_torch.runtime import FaultPlan, FaultTolerantDriver

    cfg = dataclasses.replace(get_config("gemma3-12b"), **DRIVER)
    run = DRIVER_RUN
    state, step, data = build(cfg, run["steps"], 3e-3, run["seq_len"],
                              run["batch"], device="cuda")
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as root:
        store = CheckpointStore(root, keep=2)
        drv = FaultTolerantDriver(step, store, data,
                                  ckpt_every=run["ckpt_every"],
                                  faults=FaultPlan().fail_step(
                                      [run["fail_at"]]))
        t0 = time.perf_counter()
        state, res = drv.run(state, run["steps"])
        secs = time.perf_counter() - t0
        kept = store.steps()
    counts = dict(fa.LAUNCHES)
    check(all(fa.ROUTE_LAUNCHES[k] == {"wgmma_bf16": 0, "simt_f32": n}
              for k, n in counts.items()),
          f"driver's K7/K8/K9 routes {fa.ROUTE_LAUNCHES} (f32: SIMT)")
    first, last = np.mean(res.losses[:10]), np.mean(res.losses[-10:])
    check(res.restarts == 1 and res.steps_done == run["steps"]
          and len(res.losses) == run["steps"] and last < first
          and all(map(math.isfinite, res.losses)),
          f"driver: restarts {res.restarts}, steps {res.steps_done}, loss "
          f"{first} -> {last}")
    out = {"n_params": cfg.n_params, "steps_done": res.steps_done,
           "restarts": res.restarts, "loss_first10": float(first),
           "loss_last10": float(last), "seconds": secs,
           "checkpoints_kept": kept, "launches": counts}
    print(f"[train] driver at 100M widths ({cfg.n_params / 1e6:.1f}M "
          f"params, f32): {res.steps_done} steps in {secs:.3f} s, restarts "
          f"{res.restarts} (step {run['fail_at']} failed once), loss "
          f"{first} -> {last}, checkpoints {kept}, launches {counts}, all "
          f"on the SIMT f32 route")
    del state
    torch.cuda.empty_cache()
    return counts, out


# --------------------------------------------------------------------------- #
# 8. the moe family: moonshot-v1-16b-a3b served and trained
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def routing_hook(fn):
    """Run with ``moe.ROUTING_HOOK`` set to ``fn``."""
    from repro_torch.models import moe

    moe.ROUTING_HOOK = fn
    try:
        yield
    finally:
        moe.ROUTING_HOOK = None


def recorder(rec: dict):
    """A routing hook that keeps every choice and appends (idx, logits) to
    ``rec[router.data_ptr()]``: each layer's router is its own view of the
    stacked weights, so the key names the layer."""
    def hook(router, logits, idx):
        rec.setdefault(router.data_ptr(), []).append((idx, logits.detach()))
        return idx
    return hook


def pinner(rec: dict, at: list):
    """A routing hook that replaces each layer's choices with the first ones
    ``rec`` holds for it, at the positions ``at[0]`` (a slice)."""
    def hook(router, logits, idx):
        return rec[router.data_ptr()][0][0][:, at[0]]
    return hook


def same_set(a, b):
    """[..., k] indices → [...] bool: the two top-k sets are equal."""
    import torch

    return (torch.sort(a, dim=-1).values == torch.sort(b, dim=-1).values
            ).all(-1)


def keep_rule(idx, C: int, E: int, mode: str):
    """The plain capacity rule under the choices ``idx`` [G, N, k]: an
    assignment is kept when fewer than C earlier ones chose its expert;
    sort ranks them in token order, einsum in k-slot order (GShard)."""
    import torch
    import torch.nn.functional as F

    oh = F.one_hot(idx, E)                                  # [G, N, k, E]
    if mode == "sort":
        per_tok = oh.sum(2)
        pos = torch.gather(per_tok.cumsum(1) - per_tok, 2, idx)
    else:
        lvl = oh.sum(1)                                     # [G, k, E]
        ahead = (lvl.cumsum(1) - lvl)[:, None] + oh.cumsum(1) - oh
        pos = torch.gather(ahead, 3, idx[..., None])[..., 0]
    return pos < C


def moe_routing_check(p, x, cfg, label: str) -> dict:
    """moe_apply on the card at ``x``'s shape (the main path's dispatch):
    (a) its f32 router logits against a float64 product of the same inputs
    on the card (gated at 1e-5 of the largest), its top-k against the
    float64 routing (gated only outside a tie gap of 8x the measured logits
    error), its keep mask against the plain capacity rule on its own
    choices (gated: equal); (b) its output against ``moe_ref`` under its
    own routing (bf16: 2e-2 of max|ref|)."""
    import torch

    from repro_torch.models import moe

    routing = {}
    y, aux = moe.moe_apply(p, x, cfg.top_k, cfg.moe_capacity_factor,
                           routing=routing)
    torch.cuda.synchronize()
    G, C, k = routing["G"], routing["C"], cfg.top_k
    d = x.shape[-1]
    E = p["router"].shape[1]
    l64 = torch.einsum("gnd,de->gne", x.reshape(G, -1, d).double(),
                       p["router"].double())
    dl = (routing["logits"].double() - l64).abs().max().item()
    lerr = dl / l64.abs().max().item()
    check(lerr <= 1e-5, f"{label}: f32 router logits off by {lerr} of the "
                        f"largest float64 logit (limit 1e-5)")
    p64 = torch.softmax(l64, dim=-1)
    top64 = torch.topk(p64, k + 1, dim=-1)
    gap64 = top64.values[..., k - 1] - top64.values[..., k]
    idx = routing["idx"]
    # assignments [G, N, k] whose expert the float64 routing does not pick
    other = ~(idx[..., :, None] == top64.indices[..., None, :k]).any(-1)
    tie = 8.0 * dl
    n_flip = int(other.sum())
    outside = int((other & (gap64 > tie)[..., None]).sum())
    check(outside == 0, f"{label}: {outside} assignments differ from the "
                        f"float64 routing outside its tie gap of {tie}")
    keep = routing["keep"]
    check(torch.equal(keep, keep_rule(idx, C, E, routing["mode"])),
          f"{label}: the kept set differs from the capacity rule on the "
          f"card's own choices")
    keep64 = keep_rule(top64.indices[..., :k], C, E, routing["mode"])
    n_keep = int((keep != keep64).sum())
    ref = moe.moe_ref(p, x.reshape(-1, d), idx.reshape(-1, k),
                      routing["gate"].reshape(-1, k), keep.reshape(-1, k))
    err = ((y.reshape(-1, d).float() - ref).abs().max()
           / ref.abs().max()).item()
    check(err <= 2e-2, f"{label}: moe_apply off moe_ref by {err} of "
                       f"max|ref| (limit 2e-2)")
    out = {"mode": routing["mode"], "G": G, "C": C,
           "aux": {k_: float(v) for k_, v in aux.items()},
           "logits_rel_err": lerr, "tie_gap": tie,
           "topk_differs": n_flip,
           "topk_differs_outside_tie_gap": outside,
           "keep_differs_from_float64_routing": n_keep,
           "kept": int(keep.sum()), "assignments": int(keep.numel()),
           "moe_ref_rel_err": err}
    print(f"[moe] {label} at {list(x.shape)} {x.dtype}: mode "
          f"{out['mode']}, G {G}, C {C}; aux {out['aux']}")
    print(f"[moe]   (a) f32 router logits within {lerr} of the largest "
          f"float64 logit (limit 1e-5); {n_flip} of {idx.numel()} top-k "
          f"assignments differ from the float64 routing, {outside} of them "
          f"outside the tie gap {tie} (limit 0); kept set equals the "
          f"capacity rule on the card's choices ({out['kept']} of "
          f"{out['assignments']}), differs from the float64 routing's in "
          f"{n_keep} assignments (printed, not gated)")
    print(f"[moe]   (b) moe_apply within {err} of max|ref| of moe_ref under "
          f"its own routing (limit 2e-2)")
    return out


def moe_no_drop_check(p, x, cfg) -> dict:
    """(b) both dispatches with no drops (C = Ng: 2 groups of 512 tokens)
    against ``moe_ref`` under each one's own routing, bf16 (2e-2) and f32
    (2e-4)."""
    import torch

    from repro_torch.models import moe

    E, k = p["router"].shape[1], cfg.top_k
    cf = E / k * (1 + 1e-6)               # C = int(Ng * (1 + 1e-6)) = Ng
    xs = x.reshape(-1, x.shape[-1])[:1024][None]
    out = {}
    for dt, limit in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
        pd = {n: (t if n == "router" else t.to(dt)) for n, t in p.items()}
        xd = xs.to(dt)
        for mode in ("einsum", "sort"):
            routing = {}
            y, aux = moe.moe_apply(pd, xd, k, cf, 2, mode, routing=routing)
            ref = moe.moe_ref(pd, xd[0], *(routing[n].reshape(-1, k)
                                           for n in ("idx", "gate", "keep")))
            err = ((y[0].float() - ref).abs().max() / ref.abs().max()).item()
            name = f"{mode}_{str(dt).removeprefix('torch.')}"
            out[name] = err
            check(routing["C"] == 512 and float(aux["dropped_frac"]) == 0.0
                  and err <= limit,
                  f"no-drop {name}: C {routing['C']}, dropped "
                  f"{float(aux['dropped_frac'])}, off moe_ref by {err} "
                  f"(limit {limit})")
        del pd, xd
    print(f"[moe]   (b) no drops (C = 512, 2 groups of 512 tokens): "
          f"moe_apply within {out} of max|ref| of moe_ref (limits 2e-2 "
          f"bf16, 2e-4 f32)")
    return out


def forced_decode(model, params, full, P: int, pin: dict | None = None):
    """Prefill ``full[:, :P]``, then feed ``full[:, P:]`` one token a step;
    the logits at positions P-1 .. L-1 [B, L-P+1, V].  ``pin``: a recorded
    routing of ``full`` (see :func:`pinner`) pinned into every step."""
    import torch

    B, L = full.shape
    at = [slice(0, P)]
    hook = pinner(pin, at) if pin is not None else None
    cache = model.init_cache(B, L, device="cuda")
    with routing_hook(hook):
        hp, cache = model.prefill(params, full[:, :P], cache)
        out = [model.logits(params, hp)[:, -1]]
        for t in range(P, L):
            at[0] = slice(t, t + 1)
            lg, cache = model.decode_step(params, full[:, t:t + 1], cache, t)
            out.append(lg[:, -1])
    return torch.stack(out, dim=1)


def moe_decode_vs_rerun(cfg, params, dtype: str) -> dict:
    """(d) greedy decode (serve_lm, batch 1 x MOE decode prompt, with no
    drops) against LM.apply over prompt + generated: the largest error of
    the logits over the largest logit, the top-k flips by layer, the greedy
    agreement, and the error with the rerun's routing pinned into a decode
    of the same tokens.  Gated in f32 only, pinned (1e-4): unpinned, a flip
    at a near-tie decides the error, and in bf16 rounding flips choices."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM

    m = MOE
    E, k = cfg.n_experts, cfg.top_k
    c = dataclasses.replace(cfg, dtype=dtype,
                            moe_capacity_factor=E / k * (1 + 1e-6))
    model = LM(c)
    if dtype != cfg.dtype:
        params = tree_map(lambda t: t.to(getattr(torch, dtype)) if
                          t.dtype != torch.float32 else t, params)
    P, N = m["decode_prompt"], m["decode_tokens"]
    prompt = np.random.default_rng(2).integers(0, c.vocab, (1, P))
    rec_dec, rec_full = {}, {}
    with routing_hook(recorder(rec_dec)):
        st = serve_lm(c, params, prompt, tokens=N, device="cuda",
                      keep_logits=True)
    full = torch.cat([torch.as_tensor(prompt, device="cuda"),
                      torch.as_tensor(st["ids"], device="cuda")], dim=1)
    with routing_hook(recorder(rec_full)):
        h, _ = model.apply(params, full)
    want = model.logits(params, h[:, P - 1:])
    got = st["logits"]
    pinned = forced_decode(model, params, full, P, pin=rec_full)
    torch.cuda.synchronize()
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    per_pos = ((got - want).abs().amax(-1)[0] / scale).tolist()
    perr = ((pinned - want).abs().max() / scale).item()
    routers = [params["layers"]["moe"]["router"][i].data_ptr()
               for i in range(c.n_layers)]
    flips, first, gaps = [], None, []
    for ptr in routers:
        seen = torch.cat([i for i, _ in rec_dec[ptr]], dim=1)[0]  # [L, k]
        ridx, rlog = rec_full[ptr][0]
        f = ~same_set(seen, ridx[0])
        flips.append(int(f.sum()))
        pos = torch.nonzero(f)[:, 0]
        if len(pos):
            first = min(first or 10**9, int(pos[0]))
            top = torch.topk(torch.softmax(rlog[0].double(), -1), k + 1,
                             dim=-1).values
            gaps.append(float((top[:, k - 1] - top[:, k])[pos[0]]))
    clean = [e for i, e in enumerate(per_pos)
             if first is None or P - 1 + i <= first]
    agree = float((torch.argmax(want, -1)[0, :N].cpu().numpy()
                   == st["ids"][0]).mean())
    out = {"rel_err": err, "pinned_rel_err": perr,
           "rel_err_before_first_flip": max(clean) if clean else None,
           "flips_by_layer": flips, "first_flip_position": first,
           "first_flip_gaps": gaps, "greedy_agreement": agree}
    print(f"[moe] (d) {dtype}: decode vs LM.apply over prompt + generated "
          f"(batch 1 x {P}, {N} tokens, no drops): largest error {err} of "
          f"the largest logit; with the rerun's routing pinned {perr}; "
          f"before the first flip {out['rel_err_before_first_flip']}; "
          f"top-k flips by layer {flips} (first at position {first}; the "
          f"rerun's k-th minus (k+1)-th probability there, by layer: "
          f"{gaps}); greedy agreement {agree}"
          + (" (gated: pinned, limit 1e-4)" if dtype == "float32" else
             " (printed, not gated)"))
    if dtype == "float32":
        check(perr <= 1e-4, f"f32 decode with the rerun's routing pinned is "
                            f"off LM.apply by {perr} (limit 1e-4)")
    del model, params, h, want, got, pinned
    return out


def leaf_names(tree, prefix="") -> list:
    """The leaves' paths, in :func:`~repro_torch.core.tree.flatten`'s
    order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def moe_train(cfg_full) -> tuple[dict, dict]:
    """(e) training at 2 layers through ``launch.train.build``'s step; the
    kernel step against a plain-attention step and an SDPA control step,
    both with the kernel step's routing pinned; K7/K8/K9 at this shape."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import build
    from repro_torch.models import LM

    m = MOE
    cfg = dataclasses.replace(cfg_full, n_layers=m["train_layers"])
    B, S = m["train_batch"], m["train_seq"]
    torch.cuda.reset_peak_memory_stats()
    state, step, data = build(cfg, m["train_steps"], m["lr"], S, B,
                              device="cuda")
    n_params = sum(p.numel() for p in leaves(state["params"]))
    torch.cuda.synchronize()
    print(f"[moe] (e) train: {cfg.arch_id} at full widths, {cfg.n_layers} "
          f"layers, {n_params} parameters; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB of weights and "
          f"AdamW moments allocated")
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers}
    fa.reset_launches()                   # the main path: the train steps
    losses, dropped, wall = [], [], []
    for i in range(m["train_steps"]):
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = dict(fa.LAUNCHES)
        state, met = step(state, batch)
        loss = float(met["loss"])
        wall.append((time.perf_counter() - t0) * 1e3)
        got = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        check(got == per_step and math.isfinite(loss),
              f"moe train step {i}: launches {got}, loss {loss}")
        losses.append(loss)
        dropped.append(float(met["dropped_frac"]))
        print(f"[moe]   step {i}: loss {loss} dropped_frac {dropped[-1]} "
              f"grad_norm {float(met['grad_norm'])} wall {wall[-1]:.3f} ms")
    counts = dict(fa.LAUNCHES)
    check(all(fa.ROUTE_LAUNCHES[n] == {"wgmma_bf16": c, "simt_f32": 0}
              for n, c in counts.items()),
          f"moe train routes {fa.ROUTE_LAUNCHES}")
    check(losses[-1] < losses[0], f"moe train loss {losses[0]} -> "
                                  f"{losses[-1]} did not fall")
    step_ms = statistics.median(wall[1:])
    out = {"losses": losses, "dropped_frac": dropped, "step_ms": wall,
           "median_step_ms": step_ms, "tokens_per_s": B * S / step_ms * 1e3,
           "n_params": n_params, "launches_per_step": per_step}

    # the kernel step, then plain attention and SDPA with its routing
    model = LM(cfg)
    bt = data.batch(m["train_steps"])
    b = {"ids": torch.as_tensor(bt.ids, device="cuda").long(),
         "labels": torch.as_tensor(bt.labels, device="cuda").long(),
         "mask": torch.as_tensor(bt.mask, device="cuda")}
    params = state["params"]
    rec = {}
    with routing_hook(recorder(rec)):
        k_loss, k_grads, k_aux = loss_and_grads(model, params, b)
    real = ops.attention
    variants = {
        "plain": lambda q, k, v, causal=True, window=0:
            fa.flash_attention_ref(q, k, v, causal, window)[0],
        "sdpa": lambda q, k, v, causal=True, window=0:
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True).transpose(1, 2)}
    ref = {}
    try:
        for name, fn in variants.items():
            ops.attention = fn
            with routing_hook(pinner(rec, [slice(None)])):
                ref[name] = loss_and_grads(model, params, b)[:2]
    finally:
        ops.attention = real
    torch.cuda.synchronize()
    check(cfg.window == 0, "the SDPA control assumes causal, no window")
    p_loss, p_grads = ref["plain"]
    l_err = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    check(l_err <= 1e-3, f"moe kernel step vs plain step, routing pinned: "
                         f"loss rel err {l_err} (limit 1e-3)")
    names = leaf_names(params)
    ratios = {}
    for n, kg, pg, sg in zip(names, k_grads, p_grads, ref["sdpa"][1]):
        check(bool(torch.isfinite(kg).all()), f"{n}: non-finite gradient")
        norm = pg.float().norm()
        rk = ((kg.float() - pg.float()).norm() / norm).item()
        rs = ((sg.float() - pg.float()).norm() / norm).item()
        ratios[n] = (rk, rs, rk / rs if rs else (0.0 if rk == 0 else math.inf))
        print(f"[moe]   {n}: ||dg||/||g_ref|| kernels {rk}, SDPA {rs}, "
              f"ratio {ratios[n][2]} (limit 1.5)")
    worst = max(r for _, _, r in ratios.values())
    check(worst <= 1.5, f"moe train: a leaf's kernel gradient error is "
                        f"{worst} x SDPA's (limit 1.5)")
    router_g = k_grads[names.index("/layers/moe/router")]
    check(float(router_g.abs().max()) > 0, "the router's gradient is 0")
    lb, z = float(k_aux["load_balance_loss"]), float(k_aux["router_z_loss"])
    resid = float(k_aux["total"]) - (float(k_loss) + 1e-2 * lb + 1e-3 * z)
    print(f"[moe]   kernel step vs plain-attention step, the kernel step's "
          f"routing pinned: loss {float(k_loss)} vs {float(p_loss)} (rel "
          f"err {l_err}, limit 1e-3); the kernels' gradient error at most "
          f"{worst} x SDPA's (limit 1.5); every gradient finite, router max "
          f"|g| {float(router_g.abs().max())}")
    print(f"[moe]   total {float(k_aux['total'])} = ce {float(k_loss)} + "
          f"1e-2 x {lb} + 1e-3 x {z} (residue {resid}); dropped_frac "
          f"{float(k_aux['dropped_frac'])}")
    out.update({"kernel_vs_plain_loss_rel_err": l_err,
                "grad_err_vs_sdpa": ratios, "worst_grad_ratio": worst,
                "total_residue": resid})
    del k_grads, ref, p_grads, rec
    gc.collect()

    # K7, K8 and K9 at this shape, on layer 0's q/k/v
    taken = {}

    def take(q, k, v, causal=True, window=0):
        taken.setdefault("qkv", (q, k, v))
        return real(q, k, v, causal, window)

    ops.attention = take
    try:
        with torch.no_grad():
            model.apply(params, b["ids"], remat=False)
    finally:
        ops.attention = real
    q, k, v = taken["qkv"]
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        5), device="cuda").to(q.dtype)
    e = flash_bwd_err(q, k, v, do, True, 0)
    out["bwd_err"] = e
    for n, (d, w) in e.items():
        print(f"[moe]   {n} at {list(q.shape)} bf16 causal: max abs err {d}, "
              f"{w} of the element-wise limit"
              + (" (above half of it: see PERF.md)" if w > 0.5 else ""))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe]   train: median step {step_ms:.3f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gb']:.3f} "
          f"GB, launches a step {per_step} (all wgmma_bf16), losses "
          f"{losses}, dropped_frac (summed over layers) {dropped}")
    del state, params, model, q, k, v, do, taken
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def phase_moe(fa_err: float) -> tuple[dict, dict]:
    """The moe family on the card: moonshot-v1-16b-a3b served (6 layers,
    4 x 4096 prompt, 32 greedy tokens) and trained (2 layers)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import lm_config, serve_lm
    from repro_torch.models import LM
    from repro_torch.models import layers as ml
    from repro_torch.models import transformer as mt

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = MOE
    cfg = lm_config(m["arch"], reduced=False, layers=m["layers"])
    check(cfg.dtype == "bfloat16" and cfg.n_experts == 64 and cfg.top_k == 6
          and cfg.d_model == 2048 and cfg.d_ff == 1408 and cfg.window == 0,
          f"unexpected config {cfg}")
    model = LM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    check(params["layers"]["moe"]["router"].dtype == torch.float32,
          "the router is not f32")
    B, P, N = m["batch"], m["prompt_len"], m["tokens"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, P))
    ids = torch.as_tensor(prompt, device="cuda")
    nbytes = sum(t.numel() * t.element_size()
                 for t in (params["embed"]["table"],
                           *params["layers"]["moe"].values(),
                           *params["layers"]["attn"].values()))
    print(f"[moe] {cfg.arch_id} at full widths: d {cfg.d_model}, "
          f"{cfg.n_heads} x {cfg.hd} heads, {cfg.n_kv_heads} kv heads, "
          f"{cfg.n_experts} experts, top {cfg.top_k}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype} (router f32); {cfg.n_layers} layers, "
          f"{nbytes / 1e9:.3f} GB of weights")

    # the forward over the prompt, keeping layer 0's moe and K7 inputs
    taken, real_moe, real_attn = {}, mt.moe_apply, ml.ops.attention

    def take_moe(p, x, *a, **kw):
        taken.setdefault("moe", x)
        return real_moe(p, x, *a, **kw)

    def take_attn(q, k, v, causal=True, window=0):
        taken.setdefault("attn", (q, k, v))
        return real_attn(q, k, v, causal, window)

    mt.moe_apply, ml.ops.attention = take_moe, take_attn
    try:
        _, aux = model.apply(params, ids, remat=False)
    finally:
        mt.moe_apply, ml.ops.attention = real_moe, real_attn
    print(f"[moe] LM.apply over the prompt: aux summed over "
          f"{cfg.n_layers} layers { {k: float(v) for k, v in aux.items()} }")
    out = {"aux_apply": {k: float(v) for k, v in aux.items()}}

    # K7 at the serving shape
    q, k, v = taken["attn"]
    fa.reset_launches()
    d, w = flash_err(q, k, v, True, 0)
    route = kernel_routes("flash_attention", 1)
    out["k7"] = {"max_abs_err": max(d, fa_err),
                 "err_of_elementwise_limit": w, "route": route}
    print(f"[moe] K7 layer 0 at {list(q.shape)} bf16 causal (route "
          f"{route}): max abs err {d}, {w} of the element-wise limit")
    del q, k, v

    # (a), (b): the router and both dispatches on layer 0's moe input
    p0 = {n: t[0] for n, t in params["layers"]["moe"].items()}
    x = taken.pop("moe")
    out["prefill_routing"] = moe_routing_check(p0, x, cfg, "moe prefill")
    out["decode_routing"] = moe_routing_check(p0, x[:, -1:].contiguous(),
                                              cfg, "moe decode")
    out["no_drops"] = moe_no_drop_check(p0, x, cfg)
    del x, p0, taken
    torch.cuda.empty_cache()

    # the main path: serve_lm, after a short warm-up run
    serve_lm(cfg, params, prompt, tokens=2, device="cuda")
    fa.reset_launches()
    st = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                  keep_logits=True)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    check(st["k7_launches_prefill"] == cfg.n_layers
          and st["k7_launches_decode"] == 0
          and fa.ROUTE_LAUNCHES["flash_attention"]["wgmma_bf16"]
          == cfg.n_layers and st["finite"] and st["ids"].shape == (B, N),
          f"moe serve_lm: K7 launches {counts}, routes "
          f"{fa.ROUTE_LAUNCHES['flash_attention']}, finite {st['finite']}")
    # (c) the same prefill and decode served again, bit for bit
    again = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                     keep_logits=True)
    same = (torch.equal(again["logits"], st["logits"])
            and np.array_equal(again["ids"], st["ids"]))
    check(same, "moe serve_lm served twice gives other logits")
    print(f"[moe] serve_lm: {B} x {P} prompt, {N} tokens; K7 launches "
          f"{counts} (all in the prefill, wgmma_bf16); every logit finite; "
          f"(c) served twice bit for bit: {same}")
    for k_ in ("prefill_ms", "prefill_tok_s", "prefill_device_ms",
               "decode_ms_per_token", "decode_tok_s"):
        out[k_] = st[k_]
    print("[moe] " + "  ".join(f"{k_}={out[k_]}" for k_ in (
        "prefill_ms", "prefill_tok_s", "prefill_device_ms",
        "decode_ms_per_token", "decode_tok_s")))
    del again, st

    # (f) where the card's time goes
    cache = {"c": model.init_cache(B, P + 8, device="cuda")}

    def prefill():
        cache["h"], cache["c"] = model.prefill(params, ids, cache["c"])

    def decode():
        tok = ids[:, -1:]
        for t in range(8):
            lg, cache["c"] = model.decode_step(params, tok, cache["c"], P + t)
            tok = torch.argmax(lg[:, -1], -1)[:, None]

    out["profile"] = {k_: device_profile(f, groups={"K7": "flash_fwd"},
                                         ranges="moe:")
                      for k_, f in (("prefill", prefill),
                                    ("decode_8_steps", decode))}
    for k_, v_ in out["profile"].items():
        print(f"[moe] (f) profile {k_}: wall {v_['wall_ms']:.3f} ms, card "
              f"busy {v_['device_busy_ms']:.3f} ms, idle share "
              f"{v_['device_idle_share']}, card ms by range "
              f"{ {**v_['ranges'], **v_['groups']} }")
        for t in v_["top"]:
            print(f"[moe]   {t['ms']:10.3f} ms x{t['count']:<5d} {t['name']}")
    del cache
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # (d) decode against the full-prefix rerun, bf16 and f32
    out["decode_vs_rerun"] = {dt: moe_decode_vs_rerun(cfg, params, dt)
                              for dt in ("bfloat16", "float32")}
    del model, params, ids
    gc.collect()
    torch.cuda.empty_cache()

    # (e) training
    tcounts, out["train"] = moe_train(cfg)
    for k_, v_ in tcounts.items():
        counts[k_] = counts.get(k_, 0) + v_
    print(f"[moe] serve peak {out['serve_peak_gb']:.3f} GB, train peak "
          f"{out['train']['peak_gb']:.3f} GB; K7/K8/K9 launches on the moe "
          f"main paths {counts}")
    return counts, out


# --------------------------------------------------------------------------- #
# 9. the ssm and hybrid families: rwkv6-1.6b and hymba-1.5b
# --------------------------------------------------------------------------- #
def draw_state_leaves(block: dict, g) -> dict:
    """``block`` (an ``ssm_init`` or ``rwkv_init`` tree, stacked or not)
    with each leaf of :data:`STATE_LEAF_DRAWS` replaced by a uniform draw
    from ``g`` of its shape and type: at their initial zeros and ones the
    token shift, the bonus and the learned decay take no part."""
    import torch

    out = dict(block)
    for k, (lo, hi) in STATE_LEAF_DRAWS.items():
        if k in out:
            v = out[k]
            out[k] = (torch.rand(v.shape, generator=g, device=v.device)
                      * (hi - lo) + lo).to(v.dtype)
    return out


def share_of(got, want, tol: float) -> float:
    """The largest |got - want| over its limit tol * (1 + |want|) (the
    reference's ``rtol = atol = tol``)."""
    return float(((got.float() - want.float()).abs()
                  / (tol * (1.0 + want.float().abs()))).max())


def ssm_state_checks() -> dict:
    """(a) state carried against recomputed, f32 on the card at full width:
    ``ssm_apply`` over [2, 64, 1600] in one call against 64 single-token
    calls carrying {h, conv}, ``time_mix`` over [2, 64, 2048] against 64
    calls carrying S and the shift; within 2e-4 (``tests/test_moe_ssm.py``).
    (b) ``time_mix`` at [1, 512, 2048] (two 256-step chunks), the scan's
    remat on and off: outputs and every gradient within 1e-5 relative."""
    import torch

    from repro_torch.launch.serve import lm_config
    from repro_torch.models import rwkv as mr
    from repro_torch.models import ssm as ms

    s = SSM
    g = torch.Generator("cuda").manual_seed(21)
    B, T = s["state_batch"], s["state_len"]
    hy = lm_config("hymba-1.5b", reduced=False)
    d, N, K = hy.d_model, hy.ssm_state, hy.conv_kernel
    p = draw_state_leaves(ms.ssm_init(g, d, N, K, torch.float32), g)
    x = torch.randn((B, T, d), generator=g, device="cuda")
    y_full, st_full = ms.ssm_apply(p, x)
    st = ms.ssm_init_state(B, d, N, K, torch.float32, "cuda")
    ys = []
    for t in range(T):
        y_t, st = ms.ssm_apply(p, x[:, t:t + 1], state=st)
        ys.append(y_t)
    out = {"ssm_apply": {
        "y": share_of(torch.cat(ys, 1), y_full, 2e-4),
        "h": share_of(st["h"], st_full["h"], 2e-4),
        "conv": share_of(st["conv"], st_full["conv"], 2e-4)}}

    rw = lm_config("rwkv6-1.6b", reduced=False)
    d = rw.d_model
    p = draw_state_leaves(mr.rwkv_init(g, d, rw.d_ff, torch.float32), g)
    x = torch.randn((B, T, d), generator=g, device="cuda")
    S0 = torch.zeros((B, d // mr.HEAD_DIM, mr.HEAD_DIM, mr.HEAD_DIM),
                     device="cuda")
    y_full, S_full = mr.time_mix(p, x, S0, None)
    S, last, ys = S0, torch.zeros((B, d), device="cuda"), []
    for t in range(T):
        y_t, S = mr.time_mix(p, x[:, t:t + 1], S, last)
        last = x[:, t]
        ys.append(y_t)
    out["time_mix"] = {"y": share_of(torch.cat(ys, 1), y_full, 2e-4),
                       "S": share_of(S, S_full, 2e-4)}
    torch.cuda.synchronize()
    for name, v in out.items():
        width = rw.d_model if name == "time_mix" else hy.d_model
        print(f"[ssm] (a) {name}, f32 [{B}, {T}, {width}]: one call vs {T} "
              f"single-token calls carrying the state, share of the 2e-4 "
              f"limit by output {v}")
        check(max(v.values()) <= 1.0, f"{name}: carried state off the "
                                      f"one-call run ({v})")

    # (b) the scan's chunked remat against the same blocks without it
    x = torch.randn((1, s["remat_len"], d), generator=g, device="cuda")
    S0 = torch.zeros((1, d // mr.HEAD_DIM, mr.HEAD_DIM, mr.HEAD_DIM),
                     device="cuda")
    names = sorted(set(p) - {"ck", "cv", "cr", "mu_c"})   # time-mix leaves
    runs = []
    for remat in (True, False):
        leaves = [x.clone().requires_grad_()] + [
            p[n].clone().requires_grad_() for n in names]
        with torch.enable_grad():
            y, S = mr.time_mix(dict(zip(names, leaves[1:])), leaves[0], S0,
                               None, remat=remat)
            grads = torch.autograd.grad((y ** 2).sum() + S.sum(), leaves)
        runs.append((y.detach(), S.detach(), grads))
        del y, S, leaves
    (y1, S1, g1), (y2, S2, g2) = runs
    rel = {"y": float((y1 - y2).norm() / y2.norm()),
           "S": float((S1 - S2).norm() / S2.norm()),
           **{f"d/{n}": float((a - b).norm() / b.norm())
              for n, a, b in zip(["x"] + names, g1, g2)}}
    worst = max(rel.values())
    print(f"[ssm] (b) time_mix at [1, {s['remat_len']}, {d}] f32, chunk 256"
          f": remat on vs off, largest relative difference {worst} over "
          f"the output, S and {len(g1)} gradients (limit 1e-5)")
    check(worst <= 1e-5 and all(float(b.abs().max()) > 0 for b in g2),
          f"time_mix's chunked remat changes its result: {rel}")
    out["remat"] = {"worst_rel": worst, "by_output": rel}
    del runs, g1, g2, p, x
    torch.cuda.empty_cache()
    return out


def cut_params(params: dict, n: int) -> dict:
    """The first ``n`` layers of a stacked LM tree (views)."""
    from repro_torch.core.tree import tree_map

    return {**params, "layers": tree_map(lambda t: t[:n], params["layers"])}


def sdpa_window(T: int, window: int):
    """F.scaled_dot_product_attention over [B, H, T, hd] with the causal
    (and ``window``) boolean mask, and the mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as ml

    pos = torch.arange(T, device="cuda")
    mask = ml.attn_mask(pos, pos, window)
    return (lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask)), mask


def sdpa_for(T: int, M: int, causal: bool, window: int):
    """(F.scaled_dot_product_attention over [B, H, T, hd] with K7's mask,
    the mask or None, and its name): no mask for unmasked cross-attention,
    ``is_causal`` for a causal mask without a window, else
    :func:`sdpa_window`'s boolean one (T == M)."""
    import torch.nn.functional as F

    if window <= 0:
        check(T == M or not causal, f"a causal SDPA control at T {T} != "
                                    f"M {M}")
        return (lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), None,
            "is_causal" if causal else "no mask")
    check(T == M, f"a masked SDPA control at T {T} != M {M}")
    return (*sdpa_window(T, window), "boolean window mask")


def k7_at(q, k, v, window: int, label: str, causal: bool = True,
          tag: str = "[ssm] (f)") -> dict:
    """K7 element by element and timed on these inputs, beside the bound,
    the plain version and SDPA with the same mask (``sdpa_for``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    fa.reset_launches()
    d, w = flash_err(q, k, v, causal, window)
    route = kernel_routes("flash_attention", 1)
    B, T, H, hd = q.shape
    M = k.shape[1]
    lib, mask, mask_name = sdpa_for(T, M, causal, window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    backend = sdpa_backend(qt, kt, vt, mask, causal and mask is None)
    kw = dict(reps=5, cycles=int(4e7))
    bound, by = attention_bound(q, k, causal, window)
    pairs = B * H * visible_pairs(T, M, causal, window)
    r = {"ms": device_ms(lambda q, k, v: fa.flash_attention_fwd(
             q, k, v, causal, window), [(q, k, v)], label=f"K7 {label}",
             **kw),
         "plain_ms": device_ms(lambda q, k, v: fa.flash_attention_ref(
             q, k, v, causal, window), [(q, k, v)],
             label=f"K7 {label} plain", **kw),
         "bound_ms": bound, "bound_by": by,
         "library_ms": device_ms(lib, [(qt, kt, vt)],
                                 label=f"K7 {label} library", **kw),
         "library": f"F.scaled_dot_product_attention ({backend}, "
                    f"{mask_name})",
         "max_abs_err": d, "err_of_elementwise_limit": w, "route": route,
         "shape": list(q.shape), "keys": M, "causal": causal}
    fa.reset_launches()
    r["tflops"] = 4.0 * hd * pairs / r["ms"] / 1e9
    print(f"{tag} K7 {label} at {list(q.shape)} x {M} keys bf16 causal "
          f"{causal} window {window} (route {route}): max abs err {d}, {w} "
          f"of the element-wise limit; kernel_ms={r['ms']:.5f} "
          f"({r['tflops']:.2f} TFLOP/s) plain_ms={r['plain_ms']:.5f} "
          f"bound_ms={bound:.5f} ({by}) library_ms={r['library_ms']:.5f} "
          f"[{r['library']}]")
    return r


def k8_k9_at(q, k, v, do, window: int, label: str, causal: bool = True,
             tag: str = "[ssm] (f)") -> dict:
    """K8 and K9 through the autograd Function against autograd through
    the plain version (element by element), then each timed from K7's lse
    beside its bound, the plain backward and SDPA's backward."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    fa.reset_launches()
    e = flash_bwd_err(q, k, v, do, causal, window)
    fa.reset_launches()
    lse = fa.flash_attention_fwd(q, k, v, causal, window)[1]
    delta = fa.flash_attention_bwd_dq(q, k, v, lse, do, causal, window)[1]
    fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, window)
    routes = [kernel_routes(n, 1) for n in ("flash_attention",
                                             "flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv")]
    check(routes == ["wgmma_bf16"] * 3, f"K7-K9 at {label} took {routes}")
    B, T, H, hd = q.shape
    M = k.shape[1]
    lib, mask, mask_name = sdpa_for(T, M, causal, window)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    with torch.enable_grad():
        o = lib(qt, kt, vt)
    backend = sdpa_backend(qt, kt, vt, mask, causal and mask is None)
    kw = dict(reps=5, cycles=int(4e7))
    lib_ms = device_ms(lambda: torch.autograd.grad(
        o, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), [()],
        label=f"SDPA backward {label}", **kw)
    rows = {}
    for name, fn, plain, flops, nrows in (
            ("flash_attention_bwd_dq",
             lambda: fa.flash_attention_bwd_dq(q, k, v, lse, do, causal,
                                               window),
             lambda: fa.flash_attention_bwd_dq_ref(q, k, v, lse, do, causal,
                                                   window), 6, (3, 2)),
            ("flash_attention_bwd_dkv",
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal, window),
             lambda: fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    causal, window), 8,
             (2, 4))):
        bound, by, pairs = bwd_bound(q, k, causal, window, flops, *nrows)
        r = rows[name] = {
            "ms": device_ms(fn, [()], label=f"{name} {label}", **kw),
            "plain_ms": device_ms(plain, [()], label=f"{name} {label} "
                                  f"plain", **kw),
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": f"backward of F.scaled_dot_product_attention "
                       f"({backend}, {mask_name}; dq, dk and dv together)",
            "max_abs_err": e[name][0], "err_of_elementwise_limit": e[name][1],
            "route": "wgmma_bf16", "shape": list(q.shape), "keys": M,
            "causal": causal}
        r["tflops"] = flops * hd * pairs / r["ms"] / 1e9
        print(f"{tag} {name} {label} at {list(q.shape)} x {M} keys bf16 "
              f"causal {causal} window {window}: max abs err "
              f"{r['max_abs_err']}, {r['err_of_elementwise_limit']} of the "
              f"element-wise limit; kernel_ms={r['ms']:.5f} "
              f"({r['tflops']:.2f} TFLOP/s) plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={bound:.5f} ({by}) library_ms={lib_ms:.5f} "
              f"[{r['library']}]")
    fa.reset_launches()
    del o, qt, kt, vt, lse, delta
    return rows


def recurrent_decode_vs_rerun(cfg, params, dtype: str) -> dict:
    """(d) greedy decode (serve_lm, batch 1 x SSM decode prompt) against
    LM.apply over prompt + generated at the served layers: the largest error
    of the logits over the largest logit; f32 limit 1e-4, bf16 2.5e-2."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM

    s = SSM
    c = dataclasses.replace(cfg, dtype=dtype)
    model = LM(c)
    if dtype != cfg.dtype:
        params = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
    P, N = s["decode_prompt"], s["decode_tokens"]
    prompt = np.random.default_rng(2).integers(0, c.vocab, (1, P))
    st = serve_lm(c, params, prompt, tokens=N, device="cuda",
                  keep_logits=True)
    full = torch.cat([torch.as_tensor(prompt, device="cuda"),
                      torch.as_tensor(st["ids"], device="cuda")], dim=1)
    with torch.no_grad():
        h, _ = model.apply(params, full)
        want = model.logits(params, h[:, P - 1:])
    got = st["logits"]
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()
                                           and torch.isfinite(want).all()),
          f"{c.arch_id} {dtype} decode logits {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    per_pos = ((got - want).abs().amax(-1)[0] / scale).tolist()
    agree = float((torch.argmax(want, -1)[0, :N].cpu().numpy()
                   == st["ids"][0]).mean())
    limit = 1e-4 if dtype == "float32" else 2.5e-2
    print(f"[ssm] (d) {c.arch_id} {dtype}: decode vs LM.apply over prompt "
          f"+ generated (batch 1 x {P}, {N} tokens, {c.n_layers} layers): "
          f"largest error {err} of the largest logit ({err / limit} of the "
          f"{limit} limit); by position {[round(e, 8) for e in per_pos]}; "
          f"greedy agreement {agree}")
    check(err <= limit, f"{c.arch_id} {dtype} decode is off LM.apply by "
                        f"{err} of the largest logit (limit {limit})")
    del model, params, h, want, got, st
    return {"rel_err": err, "share": err / limit, "by_position": per_pos,
            "greedy_agreement": agree}


def recurrent_train(cfg_full) -> tuple[dict, dict]:
    """(e) training at ``SSM["train_layers"]`` layers through
    ``launch.train.build``'s step, the state leaves drawn first; hymba:
    the kernel step against a plain-attention step and an SDPA control,
    then K8/K9 at this shape; rwkv: the step against the same step
    without the per-layer remat."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import build
    from repro_torch.models import LM
    from repro_torch.models import layers as ml

    s = SSM
    cfg = dataclasses.replace(cfg_full,
                              n_layers=s["train_layers"][cfg_full.arch_id])
    B, S = s["train_batch"], s["train_seq"]
    torch.cuda.reset_peak_memory_stats()
    state, step, data = build(cfg, s["train_steps"], s["lr"], S, B,
                              device="cuda")
    blk = "rwkv" if cfg.rwkv else "ssm"
    drawn = draw_state_leaves(state["params"]["layers"][blk],
                              torch.Generator("cuda").manual_seed(3))
    for k, v in state["params"]["layers"][blk].items():
        v.copy_(drawn[k])
    n_params = sum(p.numel() for p in leaves(state["params"]))
    tag = f"[ssm] (e) {cfg.arch_id}"
    print(f"{tag} train: full widths, {cfg.n_layers} layers, {n_params} "
          f"parameters; {torch.cuda.memory_allocated() / 1e9:.3f} GB of "
          f"weights and AdamW moments allocated")
    L = cfg.n_layers
    per_step = ({"flash_attention": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0} if cfg.rwkv else
                {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                 "flash_attention_bwd_dkv": L})
    fa.reset_launches()                   # the main path: the train steps
    losses, wall = [], []
    for i in range(s["train_steps"]):
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = dict(fa.LAUNCHES)
        state, met = step(state, batch)
        loss = float(met["loss"])
        wall.append((time.perf_counter() - t0) * 1e3)
        got = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
        check(got == per_step and math.isfinite(loss),
              f"{cfg.arch_id} train step {i}: launches {got}, loss {loss}")
        losses.append(loss)
        print(f"{tag}   step {i}: loss {loss} grad_norm "
              f"{float(met['grad_norm'])} wall {wall[-1]:.3f} ms")
    counts = dict(fa.LAUNCHES)
    check(all(fa.ROUTE_LAUNCHES[n] == {"wgmma_bf16": c, "simt_f32": 0}
              for n, c in counts.items()),
          f"{cfg.arch_id} train routes {fa.ROUTE_LAUNCHES}")
    check(losses[-1] < losses[0], f"{cfg.arch_id} train loss {losses[0]} "
                                  f"-> {losses[-1]} did not fall")
    step_ms = statistics.median(wall[1:])
    out = {"losses": losses, "step_ms": wall, "median_step_ms": step_ms,
           "tokens_per_s": B * S / step_ms * 1e3, "n_params": n_params,
           "launches_per_step": per_step}

    model = LM(cfg)
    bt = data.batch(s["train_steps"])
    b = {"ids": torch.as_tensor(bt.ids, device="cuda").long(),
         "labels": torch.as_tensor(bt.labels, device="cuda").long(),
         "mask": torch.as_tensor(bt.mask, device="cuda")}
    params = state["params"]
    names = leaf_names(params)
    k_loss, k_grads, _ = loss_and_grads(model, params, b)
    for n, kg in zip(names, k_grads):
        check(bool(torch.isfinite(kg).all()) and float(kg.abs().max()) > 0,
              f"{cfg.arch_id} {n}: gradient not finite or all zero")
    if cfg.rwkv:
        r_loss, r_grads, _ = loss_and_grads(model, params, b, remat=False)
        torch.cuda.synchronize()
        l_err = abs(float(k_loss) - float(r_loss)) / abs(float(r_loss))
        g_rel = max(float((a.float() - b_.float()).norm() / b_.float().norm())
                    for a, b_ in zip(k_grads, r_grads))
        print(f"{tag}   the step with per-layer remat vs without: loss "
              f"{float(k_loss)} vs {float(r_loss)} (rel err {l_err}, limit "
              f"1e-5); largest gradient leaf difference {g_rel} (printed); "
              f"every gradient finite and nonzero")
        check(l_err <= 1e-5, f"rwkv remat step vs plain: loss rel err "
                             f"{l_err} (limit 1e-5)")
        out.update({"remat_loss_rel_err": l_err, "remat_grad_rel": g_rel})
        del r_grads
    else:
        w = int(cfg.layer_windows[0])
        check(all(int(x) == w for x in cfg.layer_windows) and w > 0,
              f"unexpected windows {cfg.layer_windows}")
        lib, _ = sdpa_window(S, w)
        real = ops.attention
        variants = {
            "plain": lambda q, k, v, causal=True, window=0:
                fa.flash_attention_ref(q, k, v, causal, window)[0],
            "sdpa": lambda q, k, v, causal=True, window=0: lib(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2)}
        ref = {}
        try:
            for name, fn in variants.items():
                ops.attention = fn
                ref[name] = loss_and_grads(model, params, b)[:2]
        finally:
            ops.attention = real
        torch.cuda.synchronize()
        p_loss, p_grads = ref["plain"]
        l_err = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
        ratios = {}
        for n, kg, pg, sg in zip(names, k_grads, p_grads, ref["sdpa"][1]):
            norm = pg.float().norm()
            rk = ((kg.float() - pg.float()).norm() / norm).item()
            rs = ((sg.float() - pg.float()).norm() / norm).item()
            ratios[n] = (rk, rs, rk / rs if rs else
                         (0.0 if rk == 0 else math.inf))
            print(f"{tag}   {n}: ||dg||/||g_ref|| kernels {rk}, SDPA {rs}, "
                  f"ratio {ratios[n][2]} (limit 1.5)")
        worst = max(r for _, _, r in ratios.values())
        print(f"{tag}   kernel step vs plain-attention step: loss "
              f"{float(k_loss)} vs {float(p_loss)} (rel err {l_err}, limit "
              f"1e-3); the kernels' gradient error at most {worst} x SDPA's "
              f"(limit 1.5); every gradient finite and nonzero")
        check(l_err <= 1e-3, f"hymba kernel step vs plain step: loss rel "
                             f"err {l_err} (limit 1e-3)")
        check(worst <= 1.5, f"hymba train: a leaf's kernel gradient error "
                            f"is {worst} x SDPA's (limit 1.5)")
        out.update({"kernel_vs_plain_loss_rel_err": l_err,
                    "grad_err_vs_sdpa": ratios, "worst_grad_ratio": worst})
        del ref, p_grads
        gc.collect()

        # K8 and K9 (and K7) at this shape, on layer 0's q/k/v
        taken = {}

        def take(q, k, v, causal=True, window=0):
            taken.setdefault("qkv", (q, k, v))
            return real(q, k, v, causal, window)

        ops.attention = take
        try:
            with torch.no_grad():
                LM(dataclasses.replace(cfg, n_layers=1)).apply(
                    cut_params(params, 1), b["ids"], remat=False)
        finally:
            ops.attention = real
        q, k, v = taken.pop("qkv")
        do = torch.randn(q.shape, generator=torch.Generator(
            "cuda").manual_seed(5), device="cuda").to(q.dtype)
        out["bwd"] = k8_k9_at(q, k, v, do, w, "train")
        del q, k, v, do
    del k_grads
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{tag}   train: median step {step_ms:.3f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gb']:.3f} "
          f"GB, launches a step {per_step}, losses {losses}")
    del state, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def ssm_model(arch: str) -> tuple[dict, dict]:
    """One model at full widths and the served depth: (f) K7 at the serving
    shape (hymba), (c) serve_lm twice, (g) the profile, (d) decode vs the
    rerun in bf16 and f32, (e) training at ``SSM["train_layers"]`` layers."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import lm_config, serve_lm
    from repro_torch.models import LM
    from repro_torch.models import layers as ml

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = SSM
    cfg = lm_config(arch, reduced=False, layers=s["layers"])
    check(cfg.dtype == "bfloat16" and (cfg.rwkv or (
        cfg.hybrid and cfg.hd == 64 and cfg.window == 1024)),
        f"unexpected config {cfg}")
    model = LM(cfg)
    g = torch.Generator("cuda").manual_seed(0)
    params = model.init(g)
    blk = "rwkv" if cfg.rwkv else "ssm"
    params["layers"][blk] = draw_state_leaves(params["layers"][blk], g)
    B, P, N = s["batch"], s["prompt_len"], s["tokens"]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, P))
    ids = torch.as_tensor(prompt, device="cuda")
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    tag = f"[ssm] {cfg.arch_id}"
    secs, t0 = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        secs[part] = now - t0[0]
        t0[0] = now

    print(f"{tag} at full widths: d {cfg.d_model}, "
          + ("RWKV-6 heads of 64" if cfg.rwkv else
             f"{cfg.n_heads} x {cfg.hd} heads, {cfg.n_kv_heads} kv heads, "
             f"window {cfg.window}, ssm_state {cfg.ssm_state}")
          + f", d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; "
          f"{cfg.n_layers} layers, {nbytes / 1e9:.3f} GB of weights")
    out = {"n_layers": cfg.n_layers, "weights_gb": nbytes / 1e9}

    if not cfg.rwkv:        # (f) K7 at the serving shape, layer 0's q/k/v
        taken, real = {}, ml.ops.attention

        def take(q, k, v, causal=True, window=0):
            taken.setdefault("qkv", (q, k, v, window))
            return real(q, k, v, causal, window)

        ml.ops.attention = take
        try:
            with torch.no_grad():
                LM(dataclasses.replace(cfg, n_layers=1)).apply(
                    cut_params(params, 1), ids, remat=False)
        finally:
            ml.ops.attention = real
        q, k, v, w = taken.pop("qkv")
        out["k7"] = k7_at(q, k, v, w, "serve")
        del q, k, v
    lap("k7")

    # (c) the main path: serve_lm, after a short warm-up run
    serve_lm(cfg, params, prompt[:, :256], tokens=2, device="cuda")
    fa.reset_launches()
    st = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                  keep_logits=True)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    want_k7 = 0 if cfg.rwkv else cfg.n_layers
    check(st["k7_launches_prefill"] == want_k7
          and st["k7_launches_decode"] == 0
          and fa.ROUTE_LAUNCHES["flash_attention"]["wgmma_bf16"] == want_k7
          and st["finite"] and st["ids"].shape == (B, N),
          f"{arch} serve_lm: K7 launches {counts}, routes "
          f"{fa.ROUTE_LAUNCHES['flash_attention']}, finite {st['finite']}")
    again = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                     keep_logits=True)
    same = (torch.equal(again["logits"], st["logits"])
            and np.array_equal(again["ids"], st["ids"]))
    check(same, f"{arch} serve_lm served twice gives other logits")
    print(f"{tag} (c) serve_lm: {B} x {P} prompt, {N} tokens; K7 launches "
          f"{counts} (all in the prefill, wgmma_bf16); every logit finite; "
          f"served twice bit for bit: {same}")
    keys = ("prefill_ms", "prefill_tok_s", "prefill_device_ms",
            "decode_ms_per_token", "decode_tok_s")
    for k_ in keys:
        out[k_] = [st[k_], again[k_]]
    print(f"{tag} (g) " + "  ".join(f"{k_}={out[k_]}" for k_ in keys))
    del again, st
    lap("serve")

    # (g) where the card's time goes: a prefill at a depth cut, a few
    # decode steps at the served layers
    Lp, n_dec = min(s["profile_layers"], cfg.n_layers), s["profile_steps"]
    cut = cut_params(params, Lp)
    cmodel = LM(dataclasses.replace(cfg, n_layers=Lp))
    # decode from a zero cache at position P: the served decode's kernels
    # and shapes (the work does not depend on the state's values), without
    # a third prefill at the served layers
    cache = {"p": cmodel.init_cache(B, P, device="cuda"),
             "d": model.init_cache(B, P + n_dec, device="cuda")}

    def prefill():
        with torch.no_grad():
            cmodel.prefill(cut, ids, cache["p"])

    def decode():
        tok = ids[:, -1:]
        with torch.no_grad():
            for t in range(n_dec):
                lg, cache["d"] = model.decode_step(params, tok, cache["d"],
                                                   P + t)
                tok = torch.argmax(lg[:, -1], -1)[:, None]

    prefix = "rwkv:" if cfg.rwkv else "ssm:"
    out["profile"] = {}
    for k_, f in ((f"prefill_{Lp}_layers", prefill),
                  (f"decode_{n_dec}_steps", decode)):
        t1 = time.perf_counter()
        out["profile"][k_] = device_profile(f, groups={"K7": "flash_fwd"},
                                            ranges=prefix)
        out["profile"][k_]["profiler_s"] = time.perf_counter() - t1
    for k_, v_ in out["profile"].items():
        v_["rest_ms"] = (v_["device_busy_ms"] - sum(v_["ranges"].values())
                         - v_["groups"]["K7"])
        print(f"{tag} (g) profile {k_} ({v_['profiler_s']:.3f} s under the "
              f"profiler, its parse included): wall {v_['wall_ms']:.3f} ms, "
              f"card "
              f"busy {v_['device_busy_ms']:.3f} ms, idle share "
              f"{v_['device_idle_share']}, card ms by range "
              f"{ {**v_['ranges'], **v_['groups'], 'rest': v_['rest_ms']} }")
        for t in v_["top"]:
            print(f"{tag}   {t['ms']:10.3f} ms x{t['count']:<6d} {t['name']}")
    del cache, cut, cmodel
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lap("profile")

    # (d) decode against the full-prefix rerun, bf16 and f32
    out["decode_vs_rerun"] = {dt: recurrent_decode_vs_rerun(cfg, params, dt)
                              for dt in ("bfloat16", "float32")}
    del model, params, ids
    gc.collect()
    torch.cuda.empty_cache()
    lap("decode_vs_rerun")

    # (e) training
    tcounts, out["train"] = recurrent_train(cfg)
    lap("train")
    out["seconds"] = secs
    tr, prof = out["train"], out["profile"]
    print(f"{tag} (g) prefill {out['prefill_ms']} ms ({out['prefill_tok_s']} "
          f"tokens/s), decode {out['decode_ms_per_token']} ms a token, "
          f"train step {tr['median_step_ms']:.3f} ms ({tr['tokens_per_s']:.1f}"
          f" tokens/s); peak {out['serve_peak_gb']:.3f} GB serving, "
          f"{tr['peak_gb']:.3f} GB training; idle share "
          f"{ {k_: v_['device_idle_share'] for k_, v_ in prof.items()} }")
    for k_, v_ in tcounts.items():
        counts[k_] = counts.get(k_, 0) + v_
    print(f"{tag} serve peak {out['serve_peak_gb']:.3f} GB, train peak "
          f"{out['train']['peak_gb']:.3f} GB; K7/K8/K9 launches on its main "
          f"paths {counts}; seconds by part "
          f"{ {k_: round(v_, 3) for k_, v_ in secs.items()} }")
    return counts, out


def phase_ssm() -> tuple[dict, dict]:
    """The ssm and hybrid families on the card: the state and remat checks,
    then rwkv6-1.6b and hymba-1.5b, each served at 4 layers and trained at
    1."""
    t0 = time.perf_counter()
    out = {"state": ssm_state_checks()}
    print(f"[ssm] (a), (b): {time.perf_counter() - t0:.3f} s")
    counts = {}
    for arch in SSM["archs"]:
        c, out[arch] = ssm_model(arch)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    return counts, out


# --------------------------------------------------------------------------- #
# 10. the vlm family: llama-3.2-vision-11b
# --------------------------------------------------------------------------- #
def cut_groups(params: dict, n: int) -> dict:
    """The first ``n`` groups of a vlm LM tree (views)."""
    from repro_torch.core.tree import tree_map

    return {**params, "layers": tree_map(lambda t: t[:n], params["layers"]),
            "cross": tree_map(lambda t: t[:n], params["cross"])}


@contextlib.contextmanager
def attention_spy(calls: list | None = None, keep: dict | None = None,
                  kind=lambda causal, window: "self" if causal else "cross"):
    """``ops.attention`` as it is, each call's (causal, keys) appended to
    ``calls`` and the first call's (q, k, v, window) of each ``kind`` (by
    default ``"self"``, ``"cross"``) kept in ``keep``."""
    from repro_torch.kernels import ops

    real = ops.attention

    def spy(q, k, v, causal=True, window=0):
        if calls is not None:
            calls.append((bool(causal), k.shape[1]))
        if keep is not None:
            keep.setdefault(kind(causal, window), (q, k, v, window))
        return real(q, k, v, causal, window)

    ops.attention = spy
    try:
        yield
    finally:
        ops.attention = real


def vlm_cross_layer(params, img) -> dict:
    """(a) ``layers.attention(kv_x=)`` at [2, 256, d] against the image
    rows, on cross layer 0's weights: the K7 call inside it element by
    element against the plain version, and the layer's output against the
    same layer with ``flash_attention_ref`` in K7's place (bf16 2.5e-2 of
    max |ref|; its element-wise share printed: the wo product after the
    attention sums 4096 of o's roundings)."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import layers as ml

    v = VLM
    p = tree_map(lambda t: t[0], params["cross"]["attn"])
    g = torch.Generator("cuda").manual_seed(31)
    x = torch.randn((v["attn_batch"], v["attn_len"], p["wq"].shape[0]),
                    generator=g, device="cuda").to(p["wq"].dtype)
    kv_x = img[:v["attn_batch"]]
    keep = {}
    fa.reset_launches()
    with torch.no_grad(), attention_spy(keep=keep):
        y, _ = ml.attention(p, x, None, theta=0.0, kv_x=kv_x)
    check(fa.LAUNCHES["flash_attention"] == 1 and set(keep) == {"cross"},
          f"the cross layer launched {dict(fa.LAUNCHES)} ({set(keep)})")
    fa.reset_launches()
    q, k, vv, _ = keep["cross"]
    d, w = flash_err(q, k, vv, False, 0)
    real = ops.attention
    ops.attention = lambda q, k, v, causal=True, window=0: \
        fa.flash_attention_ref(q, k, v, causal, window)[0]
    try:
        with torch.no_grad():
            y_ref, _ = ml.attention(p, x, None, theta=0.0, kv_x=kv_x)
    finally:
        ops.attention = real
    torch.cuda.synchronize()
    yr = y_ref.float()
    diff = (y.float() - yr).abs()
    rel = (diff.max() / yr.abs().max()).item()
    rms = yr.square().mean().sqrt()
    y_share = (diff / (2.0**-7 * yr.abs() + 2.0**-8 * rms)).max().item()
    print(f"[vlm] (a) layers.attention(kv_x=) at {list(x.shape)} against "
          f"{kv_x.shape[1]} image rows: K7 inside it (q {list(q.shape)}, "
          f"k/v {list(k.shape)}, causal False) max abs err {d}, {w} of the "
          f"element-wise limit; the layer's output off the plain layer by "
          f"{rel} of max |ref| (limit 2.5e-2; {y_share} of the element-wise "
          f"limit, printed)")
    check(rel <= 2.5e-2, f"cross layer off its plain version by {rel}")
    return {"k7_max_abs_err": d, "k7_err_of_elementwise_limit": w,
            "layer_rel_err": rel, "layer_elementwise_share": y_share}


def vlm_decode_vs_rerun(cfg, params, img, dtype: str, groups: int) -> dict:
    """(c) greedy decode (serve_lm, batch 1 x the decode prompt) against
    LM.apply over prompt + the served ids at ``groups`` groups: the largest
    error of the logits over the largest logit; f32 1e-4, bf16 2.5e-2."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import LM

    v = VLM
    c = dataclasses.replace(cfg, dtype=dtype,
                            n_layers=groups * cfg.cross_attn_every)
    if groups * cfg.cross_attn_every != cfg.n_layers:
        params = cut_groups(params, groups)
    if dtype != cfg.dtype:
        params = tree_map(lambda t: t.to(getattr(torch, dtype)), params)
    model = LM(c)
    P, N = v["decode_prompt"], v["decode_tokens"]
    prompt = np.random.default_rng(2).integers(0, c.vocab, (1, P))
    im = img[:1].to(getattr(torch, dtype))
    st = serve_lm(c, params, prompt, tokens=N, device="cuda",
                  keep_logits=True, img_embeds=im)
    full = torch.cat([torch.as_tensor(prompt, device="cuda"),
                      torch.as_tensor(st["ids"], device="cuda")], dim=1)
    with torch.no_grad():
        h, _ = model.apply(params, full, img_embeds=im, remat=False)
        want = model.logits(params, h[:, P - 1:])
    got = st["logits"]
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()
                                           and torch.isfinite(want).all()),
          f"vlm {dtype} decode logits {tuple(got.shape)} vs "
          f"{tuple(want.shape)}")
    scale = want.abs().max()
    err = ((got - want).abs().max() / scale).item()
    per_pos = ((got - want).abs().amax(-1)[0] / scale).tolist()
    limit = 1e-4 if dtype == "float32" else 2.5e-2
    print(f"[vlm] (c) {dtype} at {c.n_layers} layers ({groups} groups): "
          f"decode vs LM.apply over prompt + the served ids (batch 1 x {P}, "
          f"{N} tokens, {c.n_img_tokens} image rows): largest error {err} "
          f"of the largest logit ({err / limit} of the {limit} limit); by "
          f"position {[round(e, 8) for e in per_pos]}")
    check(err <= limit, f"vlm {dtype} decode is off LM.apply by {err} of "
                        f"the largest logit (limit {limit})")
    del model, params, h, want, got, st
    return {"n_layers": c.n_layers, "rel_err": err, "share": err / limit,
            "by_position": per_pos}


def vlm_train(cfg_full) -> tuple[dict, dict]:
    """(d) training at one group (4 self + 1 cross layers) through
    ``make_train_step``, group remat, AdamW, image embeddings drawn from the
    seed (the trainer CLI's zeros give the cross layers' q, k, v and o no
    gradient); the kernel step against a plain-attention step and an SDPA
    control step."""
    import dataclasses
    import gc

    import torch
    import torch.nn.functional as F

    from repro_torch.core.tree import leaves
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import LM
    from repro_torch.optim import adamw_init

    v = VLM
    cfg = dataclasses.replace(
        cfg_full, n_layers=v["train_groups"] * cfg_full.cross_attn_every)
    B, S, n = v["train_batch"], v["train_seq"], v["train_steps"]
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator("cuda").manual_seed(0)
    model, step = make_train_step(cfg, lr=v["lr"], warmup=5, total_steps=n,
                                  loss_chunk=512)
    params = model.init(g)
    state = {"params": params, "opt": adamw_init(params)}
    img = torch.randn((B, cfg.n_img_tokens, cfg.d_model), generator=g,
                      device="cuda").bfloat16()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=S, global_batch=B,
                           seed=0)

    def batch_of(i):
        bt = data.batch(i)
        return {"ids": torch.as_tensor(bt.ids, device="cuda").long(),
                "labels": torch.as_tensor(bt.labels, device="cuda").long(),
                "mask": torch.as_tensor(bt.mask, device="cuda"),
                "img_embeds": img}

    n_params = sum(p.numel() for p in leaves(params))
    print(f"[vlm] (d) train: {cfg.n_layers} layers (one group), {n_params} "
          f"parameters, {B} x {S} tokens, {cfg.n_img_tokens} image rows; "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB of weights and "
          f"AdamW moments allocated")
    L = cfg.n_layers          # K7 forward + the group's recompute
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    fa.reset_launches()                   # the main path: the train steps
    losses, wall = [], []
    for i in range(n):
        b = batch_of(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        before = dict(fa.LAUNCHES)
        state, met = step(state, b)
        loss = float(met["loss"])
        wall.append((time.perf_counter() - t0) * 1e3)
        got = {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}
        check(got == per_step and math.isfinite(loss),
              f"vlm train step {i}: launches {got}, loss {loss}")
        losses.append(loss)
        print(f"[vlm]   step {i}: loss {loss} grad_norm "
              f"{float(met['grad_norm'])} wall {wall[-1]:.3f} ms")
    counts = dict(fa.LAUNCHES)
    check(all(fa.ROUTE_LAUNCHES[k] == {"wgmma_bf16": c, "simt_f32": 0}
              for k, c in counts.items()),
          f"vlm train routes {fa.ROUTE_LAUNCHES}")
    check(losses[-1] < losses[0], f"vlm train loss {losses[0]} -> "
                                  f"{losses[-1]} did not fall")
    step_ms = statistics.median(wall[1:])
    out = {"losses": losses, "step_ms": wall, "median_step_ms": step_ms,
           "tokens_per_s": B * S / step_ms * 1e3, "n_params": n_params,
           "launches_per_step": per_step}

    b = batch_of(n)
    params = state["params"]
    names = leaf_names(params)
    k_loss, k_grads, _ = loss_and_grads(model, params, b)
    for nm, kg in zip(names, k_grads):
        check(bool(torch.isfinite(kg).all()) and float(kg.abs().max()) > 0,
              f"vlm {nm}: gradient not finite or all zero")
    cross_g = {nm: float(kg.abs().max()) for nm, kg in zip(names, k_grads)
               if nm.startswith("/cross/attn/")}
    real = ops.attention
    variants = {
        "plain": lambda q, k, v, causal=True, window=0:
            fa.flash_attention_ref(q, k, v, causal, window)[0],
        "sdpa": lambda q, k, v, causal=True, window=0:
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal).transpose(1, 2)}
    check(cfg.window == 0, "the SDPA control assumes no window")
    ref = {}
    try:
        for name, fn in variants.items():
            ops.attention = fn
            ref[name] = loss_and_grads(model, params, b)[:2]
    finally:
        ops.attention = real
    torch.cuda.synchronize()
    p_loss, p_grads = ref["plain"]
    l_err = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    ratios = {}
    for nm, kg, pg, sg in zip(names, k_grads, p_grads, ref["sdpa"][1]):
        norm = pg.float().norm()
        rk = ((kg.float() - pg.float()).norm() / norm).item()
        rs = ((sg.float() - pg.float()).norm() / norm).item()
        ratios[nm] = (rk, rs, rk / rs if rs else
                      (0.0 if rk == 0 else math.inf))
        print(f"[vlm]   {nm}: ||dg||/||g_ref|| kernels {rk}, SDPA {rs}, "
              f"ratio {ratios[nm][2]} (limit 1.5)")
    worst = max(r for _, _, r in ratios.values())
    print(f"[vlm]   kernel step vs plain-attention step: loss "
          f"{float(k_loss)} vs {float(p_loss)} (rel err {l_err}, limit "
          f"1e-3); the kernels' gradient error at most {worst} x SDPA's "
          f"(limit 1.5); every gradient finite and nonzero; the cross "
          f"layer's max |g| {cross_g}")
    check(l_err <= 1e-3, f"vlm kernel step vs plain step: loss rel err "
                         f"{l_err} (limit 1e-3)")
    check(worst <= 1.5, f"vlm train: a leaf's kernel gradient error is "
                        f"{worst} x SDPA's (limit 1.5)")
    out.update({"kernel_vs_plain_loss_rel_err": l_err,
                "grad_err_vs_sdpa": ratios, "worst_grad_ratio": worst,
                "cross_grad_max": cross_g})
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[vlm]   train: median step {step_ms:.3f} ms, "
          f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gb']:.3f} "
          f"GB, launches a step {per_step} (all wgmma_bf16), losses "
          f"{losses}")
    del state, params, model, k_grads, ref, p_grads, b, img
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def phase_vlm() -> tuple[dict, dict]:
    """llama-3.2-vision-11b on the card at full widths, bf16: (a) the cross
    layer and K7/K8/K9 at the cross shape against their plain versions;
    (b) served whole, twice, bit for bit; (c) decode against the rerun;
    (d) training at one group; (e) the profile."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import lm_config, serve_lm
    from repro_torch.models import LM

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    v = VLM
    cfg = lm_config(v["arch"], reduced=False)
    check(cfg.dtype == "bfloat16" and cfg.n_layers == 40
          and cfg.cross_attn_every == 5 and cfg.n_img_tokens == 1601
          and cfg.hd == 128, f"unexpected config {cfg}")
    n_groups = cfg.n_layers // cfg.cross_attn_every
    model = LM(cfg)
    g = torch.Generator("cuda").manual_seed(0)
    params = model.init(g)
    B, P, N = v["batch"], v["prompt_len"], v["tokens"]
    img = torch.randn((B, cfg.n_img_tokens, cfg.d_model), generator=g,
                      device="cuda").bfloat16()
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, (B, P))
    ids = torch.as_tensor(prompt, device="cuda")
    nbytes = sum(t.numel() * t.element_size() for t in leaves(params))
    secs, t0 = {}, [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        secs[part] = now - t0[0]
        t0[0] = now

    print(f"[vlm] {cfg.arch_id} at full widths: d {cfg.d_model}, "
          f"{cfg.n_heads} x {cfg.hd} heads over {cfg.n_kv_heads} kv heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; {cfg.n_layers} "
          f"layers = {n_groups} groups of ({cfg.cross_attn_every - 1} self + "
          f"1 cross), {cfg.n_img_tokens} image rows; "
          f"{sum(t.numel() for t in leaves(params))} parameters, "
          f"{nbytes / 1e9:.3f} GB of weights")
    out = {"n_layers": cfg.n_layers, "weights_gb": nbytes / 1e9}

    # (a) the cross layer, then K7 / K8 / K9 at the served shapes, on the
    # first group's q/k/v of the real prompt and image rows
    out["cross_layer"] = vlm_cross_layer(params, img)
    keep = {}
    with torch.no_grad(), attention_spy(keep=keep):
        LM(dataclasses.replace(cfg, n_layers=cfg.cross_attn_every)).apply(
            cut_groups(params, 1), ids, img_embeds=img, remat=False)
    q, k, vv, _ = keep["self"]
    out["k7_self"] = k7_at(q, k, vv, 0, "self serve", tag="[vlm] (a)")
    q, k, vv, _ = keep.pop("cross")
    out["k7"] = k7_at(q, k, vv, 0, "cross serve", causal=False,
                      tag="[vlm] (a)")
    tb = v["train_batch"]
    q, k, vv = (t[:tb].contiguous() for t in (q, k, vv))
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(
        5), device="cuda").to(q.dtype)
    out["bwd"] = k8_k9_at(q, k, vv, do, 0, "cross train", causal=False,
                          tag="[vlm] (a)")
    del q, k, vv, do, keep
    lap("kernels")

    # (b) the main path: serve_lm at all 40 layers, after a short warm-up
    serve_lm(cfg, params, prompt[:, :256], tokens=2, device="cuda",
             img_embeds=img)
    fa.reset_launches()
    calls = []
    with attention_spy(calls):
        st = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                      keep_logits=True, img_embeds=img)
    torch.cuda.synchronize()
    counts = dict(fa.LAUNCHES)
    n_cross = sum(1 for c, m in calls if not c and m == cfg.n_img_tokens)
    n_self = sum(1 for c, m in calls if c and m == P)
    check(st["k7_launches_prefill"] == cfg.n_layers
          and st["k7_launches_decode"] == 0
          and fa.ROUTE_LAUNCHES["flash_attention"]["wgmma_bf16"]
          == cfg.n_layers and n_cross == n_groups
          and n_self == cfg.n_layers - n_groups and len(calls) == cfg.n_layers
          and st["finite"] and st["ids"].shape == (B, N),
          f"vlm serve_lm: K7 launches {counts}, routes "
          f"{fa.ROUTE_LAUNCHES['flash_attention']}, calls {calls}, finite "
          f"{st['finite']}")
    again = serve_lm(cfg, params, prompt, tokens=N, device="cuda",
                     keep_logits=True, img_embeds=img)
    same = (torch.equal(again["logits"], st["logits"])
            and np.array_equal(again["ids"], st["ids"]))
    check(same, "vlm serve_lm served twice gives other logits")
    print(f"[vlm] (b) serve_lm: {B} x {P} prompt, {cfg.n_img_tokens} image "
          f"rows, {N} tokens, {cfg.n_layers} layers; K7 launches {counts} "
          f"(all in the prefill, wgmma_bf16: {n_self} causal self, {n_cross} "
          f"cross with causal=False against {cfg.n_img_tokens} keys); every "
          f"logit finite; served twice bit for bit: {same}")
    keys = ("prefill_ms", "prefill_tok_s", "prefill_device_ms",
            "decode_ms_per_token", "decode_tok_s")
    for k_ in keys:
        out[k_] = [st[k_], again[k_]]
    print("[vlm] (b) " + "  ".join(f"{k_}={out[k_]}" for k_ in keys))
    out["k7_calls"] = {"self": n_self, "cross": n_cross}
    del again, st
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    lap("serve")

    # (e) where the card's time goes: a one-group prefill, 2 decode steps
    # at all the layers
    Gp, n_dec = v["profile_groups"], v["profile_steps"]
    cut = cut_groups(params, Gp)
    cmodel = LM(dataclasses.replace(cfg, n_layers=Gp * cfg.cross_attn_every))
    cache = {"p": cmodel.init_cache(B, P, device="cuda")}
    # decode from a cache whose image K/V the served prefill's would be: a
    # zero self cache at position P (the work does not depend on it)
    cache["d"] = model.init_cache(B, P + n_dec, device="cuda")
    with torch.no_grad():
        model.prefill(params, ids[:, :1], cache["d"], img_embeds=img)

    def prefill():
        with torch.no_grad():
            cmodel.prefill(cut, ids, cache["p"], img_embeds=img)

    def decode():
        tok = ids[:, -1:]
        with torch.no_grad():
            for t in range(n_dec):
                lg, cache["d"] = model.decode_step(params, tok, cache["d"],
                                                   P + t)
                tok = torch.argmax(lg[:, -1], -1)[:, None]

    out["profile"] = {}
    for k_, f in ((f"prefill_{Gp}_group", prefill),
                  (f"decode_{n_dec}_steps", decode)):
        t1 = time.perf_counter()
        out["profile"][k_] = device_profile(f, groups={"K7": "flash_fwd"},
                                            ranges="vlm:")
        out["profile"][k_]["profiler_s"] = time.perf_counter() - t1
    for k_, v_ in out["profile"].items():
        v_["rest_ms"] = v_["device_busy_ms"] - sum(v_["ranges"].values())
        print(f"[vlm] (e) profile {k_} ({v_['profiler_s']:.3f} s under the "
              f"profiler, its parse included): wall {v_['wall_ms']:.3f} ms, "
              f"card busy {v_['device_busy_ms']:.3f} ms, idle share "
              f"{v_['device_idle_share']}, card ms by range "
              f"{ {**v_['ranges'], 'rest': v_['rest_ms']} } (K7 inside "
              f"vlm:self and vlm:cross: {v_['groups']['K7']})")
        for t in v_["top"]:
            print(f"[vlm]   {t['ms']:10.3f} ms x{t['count']:<6d} {t['name']}")
    del cache, cut, cmodel
    lap("profile")

    # (c) decode against the full-prefix rerun: bf16 at all the layers,
    # f32 at a cut depth (40 f32 layers are 37 GB beside the bf16 weights)
    out["decode_vs_rerun"] = {
        "bfloat16": vlm_decode_vs_rerun(cfg, params, img, "bfloat16",
                                        n_groups),
        "float32": vlm_decode_vs_rerun(cfg, params, img, "float32",
                                       v["f32_groups"])}
    del model, params, ids, img
    gc.collect()
    torch.cuda.empty_cache()
    lap("decode_vs_rerun")

    # (d) training
    tcounts, out["train"] = vlm_train(cfg)
    lap("train")
    out["seconds"] = secs
    for k_, v_ in tcounts.items():
        counts[k_] = counts.get(k_, 0) + v_
    tr, prof = out["train"], out["profile"]
    print(f"[vlm] prefill {out['prefill_ms']} ms ({out['prefill_tok_s']} "
          f"tokens/s), decode {out['decode_ms_per_token']} ms a token, "
          f"train step {tr['median_step_ms']:.3f} ms "
          f"({tr['tokens_per_s']:.1f} tokens/s); peak "
          f"{out['serve_peak_gb']:.3f} GB serving, {tr['peak_gb']:.3f} GB "
          f"training; idle share "
          f"{ {k_: v_['device_idle_share'] for k_, v_ in prof.items()} }; "
          f"K7/K8/K9 launches on its main paths {counts}; seconds by part "
          f"{ {k_: round(v_, 3) for k_, v_ in secs.items()} }")
    return counts, out


# --------------------------------------------------------------------------- #
# 11. spmd
# --------------------------------------------------------------------------- #
def spmd_inputs(cfg, seed: int, device):
    """The phase's microbatches: [M, 1, T, d] bf16 drawn from the seed."""
    import torch

    n = SPMD["microbatches"]
    g = torch.Generator(device).manual_seed(seed + 10_000)
    return torch.randn((n, 1, SPMD["seq_len"], cfg.d_model), generator=g,
                       device=device).bfloat16()


def spmd_rank(mesh, runs: list) -> list:
    """One rank of the phase, one spawn for every run of ``runs`` (each
    the (bounds, layers, microbatches, train) of :func:`spmd_run`) on this
    mesh, in turn; → their results."""
    import gc

    import torch

    out = []
    for run in runs:
        out.append(spmd_run(mesh, *run))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def spmd_run(mesh, bounds: list, n_layers: int, n_micro: int,
             train: bool) -> dict:
    """One run on a rank: draw this stage's layers, run the pipeline
    (forward, or forward and mean(out²)'s backward), return its numbers,
    the last stage's outputs and, training, its layers' gradients."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import spmd_pipeline_fn
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import pipeline_block, pipeline_stage

    cfg = get_config(SPMD["arch"])
    S, s = len(bounds), mesh.axis_index("stage")
    ends = list(bounds[1:]) + [n_layers]
    lengths = torch.tensor([e - b for b, e in zip(bounds, ends)],
                           dtype=torch.int32)
    t0 = time.perf_counter()
    stack = pipeline_stage(cfg, bounds[s], ends[s], int(lengths.max()),
                           SPMD["seed"], mesh.device)
    xs = spmd_inputs(cfg, SPMD["seed"], mesh.device)[:n_micro]
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    stats = {}
    fn = spmd_pipeline_fn(pipeline_block(cfg), S, stats=stats)
    t1 = time.perf_counter()
    if train:
        weights = tree_map(lambda a: a.requires_grad_(True), stack["block"])
        out = fn(stack, lengths, xs)
        (out.float() ** 2).mean().backward()
    else:
        with torch.no_grad():
            out = fn(stack, lengths, xs)
    torch.cuda.synchronize()
    res = {"stage": s, "layers": [bounds[s], ends[s]],
           "ms": 1e3 * (time.perf_counter() - t1), "draw_s": draw_s,
           "stats": stats, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": dict(fa.LAUNCHES),
           "routes": {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()},
           "out": out.detach() if s == S - 1 else None}
    if train:
        res["grads"] = [tree_map(lambda a, j=j: a.grad[0, j], weights)
                        for j in range(ends[s] - bounds[s])]
    return res


def spmd_reference(cfg, n_layers: int, xs, train: bool):
    """The parent's sequential run of the same blocks on each microbatch:
    the outputs, and training each layer's gradient of mean(out²) over
    all the microbatches.  Serving draws one layer at a time."""
    import torch

    from repro_torch.core.tree import tree_map
    from repro_torch.models.transformer import pipeline_block, pipeline_layer

    block, seed = pipeline_block(cfg), SPMD["seed"]
    if not train:
        hs = list(xs)
        with torch.no_grad():
            for i in range(n_layers):
                lp = pipeline_layer(cfg, i, seed, "cuda")
                hs = [block(lp, h) for h in hs]
                del lp
        return torch.stack(hs), None
    layers = [pipeline_layer(cfg, i, seed, "cuda") for i in range(n_layers)]
    weights = [tree_map(lambda a: a.requires_grad_(True), lp["block"])
               for lp in layers]
    outs = []
    for x in xs:
        h = x
        for lp in layers:
            h = block(lp, h)
        # mean over all the microbatches = the mean of theirs (equal sizes)
        ((h.float() ** 2).mean() / len(xs)).backward()
        outs.append(h.detach())
    grads = [tree_map(lambda a: a.grad, w) for w in weights]
    return torch.stack(outs), grads


def spmd_plans(cfg) -> dict:
    """The served stack's cost-model IR (per-layer costs at S 4096) and its
    cuts: ``partition_optimal`` at 4 stages, ``ElasticPlanner`` at 3, and
    the training cut of layers 0-7 at 4."""
    from repro_torch.core import linear_ir, partition_optimal
    from repro_torch.core.costmodel import lm_layer_cost
    from repro_torch.runtime import ElasticPlanner

    def bounds(plan):
        out, i = [], 0
        for st in plan.stages:
            out.append(i)
            i += len(st.node_names)
        return out

    ms = [lm_layer_cost(cfg, 1, SPMD["seq_len"], i).time_ms()
          for i in range(cfg.n_layers)]
    ir = linear_ir("gemma_layers", [f"L{i}" for i in range(cfg.n_layers)], ms)
    n = SPMD["train_layers"]
    ir8 = linear_ir("gemma_layers_train", [f"L{i}" for i in range(n)],
                    ms[:n])
    plans = {"costs_ms": ms,
             "served": bounds(partition_optimal(ir, max_stages=SPMD["stages"])),
             "replan": ElasticPlanner(ir, device="cuda").boundaries(
                 SPMD["replan"]),
             "train": bounds(partition_optimal(
                 ir8, max_stages=SPMD["train_stages"]))}
    for k, n_st in (("served", SPMD["stages"]), ("replan", SPMD["replan"]),
                    ("train", SPMD["train_stages"])):
        check(len(plans[k]) == n_st, f"spmd: the {k} plan has "
                                     f"{len(plans[k])} stages, not {n_st}")
    return plans


def spmd_stage_costs(costs: list, bounds: list) -> list:
    ends = list(bounds[1:]) + [len(costs)]
    return [round(sum(costs[b:e]), 3) for b, e in zip(bounds, ends)]


def spmd_report(label: str, res: list, n_stages: int, n_micro: int) -> dict:
    """Print and return a run's per-rank numbers."""
    ranks = [{"stage": r["stage"], "layers": r["layers"], "ms": r["ms"],
              "compute_ms": r["stats"]["compute_ms"],
              "handoff_ms": r["stats"]["handoff_ms"],
              "idle_share": 1.0 - r["stats"]["busy_share"],
              "peak_gb": r["peak_gb"], "draw_s": r["draw_s"],
              "launches": r["launches"]} for r in res]
    bubble = (n_stages - 1) / (n_micro + n_stages - 1)
    for r in ranks:
        print(f"[spmd] {label} stage {r['stage']} layers "
              f"{r['layers'][0]}..{r['layers'][1] - 1}: stage ms "
              f"{r['compute_ms']:.3f} of {r['ms']:.3f}, hand-off ms "
              f"{r['handoff_ms']:.3f}, idle share {r['idle_share']:.3f}, "
              f"peak {r['peak_gb']:.3f} GB, drawn in {r['draw_s']:.3f} s, "
              f"launches {r['launches']}")
    out = {"ranks": ranks, "ms": max(r["ms"] for r in ranks),
           "schedule_bubble_share": bubble}
    print(f"[spmd] {label}: {out['ms']:.3f} ms across {n_stages} ranks; the "
          f"schedule's bubble share (S-1)/(M+S-1) = {bubble:.3f}")
    return out


def phase_spmd() -> tuple[dict, dict]:
    """gemma3-12b's 48 full-width layers through ``spmd_pipeline_fn`` on 4
    ranks sharing the card, then 3 after the elastic re-plan, each held to
    the sequential run; layers 0-7 trained in 4 stages, each layer leaf's
    gradient held to the sequential run's."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import run_on_local_mesh

    cfg = get_config(SPMD["arch"])
    check(cfg.n_layers == 48 and cfg.d_model == 3840 and cfg.n_heads == 16
          and cfg.hd == 256 and cfg.n_kv_heads == 8 and cfg.d_ff == 15360
          and cfg.window == 1024 and cfg.dtype == "bfloat16",
          f"unexpected config {cfg}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    plans = spmd_plans(cfg)
    costs, M = plans["costs_ms"], SPMD["microbatches"]
    glob = [i for i in range(cfg.n_layers) if cfg.layer_windows[i] == 0]
    print(f"[spmd] {cfg.arch_id}: {cfg.n_layers} layers, global {glob}; "
          f"cost model ms a layer at S {SPMD['seq_len']}: local "
          f"{costs[0]:.4f}, global {costs[glob[0]]:.4f}")
    for k in ("served", "replan", "train"):
        print(f"[spmd] plan {k}: boundaries {plans[k]}, cost-model ms a "
              f"stage {spmd_stage_costs(costs, plans[k])}")
    n3 = cfg.n_layers // SPMD["replan"]
    eq3 = [i * n3 for i in range(SPMD["replan"])]
    print(f"[spmd] the equal 3-way split {eq3} costs "
          f"{spmd_stage_costs(costs, eq3)} (global layers a stage "
          f"{[sum(b <= g < b + n3 for g in glob) for b in eq3]})")
    out = {"plans": plans, "seconds": {}}
    counts: dict = {}
    secs, t0 = out["seconds"], [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        secs[part] = now - t0[0]
        t0[0] = now

    def add(res: list) -> None:
        for r in res:
            check(all(v["simt_f32"] == 0 for v in r["routes"].values()),
                  f"spmd: a rank left the wgmma route {r['routes']}")
            for k, v in r["launches"].items():
                counts[k] = counts.get(k, 0) + v

    # the sequential references (served; layers 0-7 trained, M = 4
    # microbatches of 1 x 4096), then one spawn of 4 ranks that serves in
    # 4 stages and trains in 4, then one of 3 that serves after the re-plan
    n, Mt = SPMD["train_layers"], SPMD["train_microbatches"]
    check(SPMD["train_stages"] == SPMD["stages"],
          "spmd: the served and trained pipelines share one spawn")
    xs = spmd_inputs(cfg, SPMD["seed"], "cuda")
    ref, _ = spmd_reference(cfg, cfg.n_layers, xs, False)
    scale = ref.float().abs().max().item()
    lap("reference")
    tref, grads = spmd_reference(cfg, n, xs[:Mt], True)
    grads = [[g.detach() for g in leaves(lg)] for lg in grads]
    del xs
    gc.collect()
    torch.cuda.empty_cache()
    lap("train_reference")
    both = run_on_local_mesh((SPMD["stages"],), ("stage",), spmd_rank,
                             [(plans["served"], cfg.n_layers, M, False),
                              (plans["train"], n, Mt, True)],
                             device="cuda", timeout=SPMD["timeout"])
    runs = {"served": [r[0] for r in both], "train": [r[1] for r in both]}
    del both
    lap("served_and_train_ranks")
    runs["replan"] = [r[0] for r in run_on_local_mesh(
        (SPMD["replan"],), ("stage",), spmd_rank,
        [(plans["replan"], cfg.n_layers, M, False)], device="cuda",
        timeout=SPMD["timeout"])]
    lap("replan_ranks")
    for key, n_st in (("served", SPMD["stages"]), ("replan", SPMD["replan"])):
        res = runs.pop(key)
        got = res[-1]["out"].to("cuda")
        err = (got.float() - ref.float()).abs().max().item()
        k7 = sum(r["launches"]["flash_attention"] for r in res)
        add(res)
        rep = spmd_report(key, res, n_st, M)
        rep.update(max_abs_err=err, limit=2e-2 * scale, share=err / (
            2e-2 * scale), bitwise=bool(torch.equal(got, ref)), k7=k7)
        print(f"[spmd] {key}: {n_st} stages {plans[key]} vs the sequential "
              f"run: max |err| {err:.6g} against 2e-2 * max|ref| = "
              f"{2e-2 * scale:.6g} (share {rep['share']:.4f}); bit for bit: "
              f"{rep['bitwise']}; K7 launches {k7} (want "
              f"{cfg.n_layers * M})")
        check(err <= 2e-2 * scale and bool(torch.isfinite(got).all()),
              f"spmd {key}: outputs off the sequential run by {err}")
        check(k7 == cfg.n_layers * M, f"spmd {key}: {k7} K7 launches")
        out[key] = rep
        del res, got
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    # trained: layers 0-7 in 4 stages, M = 4 microbatches of 1 x 4096
    res = runs.pop("train")
    add(res)
    rep = spmd_report("train", res, SPMD["train_stages"], Mt)
    got = res[-1]["out"].to("cuda")
    out_err = (got.float() - tref.float()).abs().max().item()
    worst = (0.0, None)
    for r in res:
        for j, lg in enumerate(r["grads"]):
            layer = r["layers"][0] + j
            for leaf, (g, w) in enumerate(zip(leaves(lg), grads[layer])):
                share = ((g.to("cuda").float() - w.float()).abs().max()
                         / (2e-2 * w.float().abs().max())).item()
                check(share <= 1.0 and bool(torch.isfinite(g).all()),
                      f"spmd train: layer {layer} leaf {leaf} gradient "
                      f"at {share:.3f} of 2e-2 * max|ref|")
                worst = max(worst, (share, f"layer {layer} leaf {leaf}"))
    k = {kk: sum(r["launches"][kk] for r in res) for kk in res[0]["launches"]}
    rep.update(out_max_abs_err=out_err, worst_grad_share=worst[0],
               worst_grad_leaf=worst[1], launches=k)
    print(f"[spmd] train: {SPMD['train_stages']} stages {plans['train']}, "
          f"{Mt} microbatches: outputs off the sequential run by "
          f"{out_err:.6g}; each layer leaf's gradient within "
          f"{worst[0]:.4f} of 2e-2 * max|ref grad| (worst {worst[1]}); "
          f"step {rep['ms']:.3f} ms; launches {k}")
    check(k == {"flash_attention": n * Mt, "flash_attention_bwd_dq": n * Mt,
                "flash_attention_bwd_dkv": n * Mt},
          f"spmd train: launches {k}")
    out["train"] = rep
    del res, got, tref, grads
    gc.collect()
    torch.cuda.empty_cache()
    lap("checks")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[spmd] phase {out['phase_s']:.3f} s (budget 90); seconds by part "
          f"{ {k_: round(v_, 3) for k_, v_ in secs.items()} }; K7/K8/K9 "
          f"launches on the ranks {counts}")
    return counts, out


def tp_config():
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TP["arch"]), n_layers=TP["layers"])
    check(cfg.d_model == 3840 and cfg.n_heads == 16 and cfg.n_kv_heads == 8
          and cfg.hd == 256 and cfg.d_ff == 15360 and cfg.vocab == 262144
          and cfg.dtype == "bfloat16" and cfg.window == 1024
          and [int(w) for w in cfg.layer_windows].count(0) == 1,
          f"unexpected tp config {cfg}")
    return cfg


def tp_inputs(cfg, device):
    """The prompts [B, T] drawn from the phase's seed."""
    import torch

    g = torch.Generator(device).manual_seed(TP["seed"] + 1)
    return torch.randint(0, cfg.vocab, (TP["batch"], TP["prompt_len"]),
                         generator=g, device=device)


def tp_serve(model, params, cache, ids, prefill, decode, tokens=None,
             steps: int | None = None, phase=lambda name: None, img=None):
    """The phase's serving run (the same code whole or on a rank): the
    prefill step's logits, ``LM.prefill`` into ``cache``, then one decode
    step a token of ``tokens`` [B, n] (teacher-forced), or of the greedy
    tokens when None, ``steps`` of them (``TP["decode"]`` by default);
    ``phase(name)`` is called before each part ("prefill", "fill",
    "dec<j>"); ``img``: a vlm model's image embeddings, given to the
    prefills; → (prefill logits, decode logits, tokens fed, ms of each
    part)."""
    import torch

    kw = {} if img is None else {"img_embeds": img}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    phase("prefill")
    logits, pre_ms = timed(lambda: prefill(params, {"ids": ids, **kw}))
    phase("fill")
    _, fill_ms = timed(lambda: model.prefill(params, ids, cache, **kw))
    T, fed, outs, dec_ms = ids.shape[1], [], [], []
    tok = logits[:, -1].argmax(-1)
    for j in range(TP["decode"] if steps is None else steps):
        phase(f"dec{j}")
        if tokens is not None:
            tok = tokens[:, j].to(ids.device)
        fed.append(tok)
        (lg, _), ms = timed(lambda: decode(
            params, cache, {"ids": tok[:, None], "pos": T + j}))
        outs.append(lg.cpu())
        dec_ms.append(ms)
        tok = lg[:, -1].argmax(-1)
    return (logits.cpu(), outs, torch.stack(fed, 1).cpu(),
            {"prefill_step_ms": pre_ms, "prefill_cache_ms": fill_ms,
             "decode_ms": dec_ms})


def timed_collectives(stats: dict, groups: dict | None = None):
    """Patch the two collectives under every autograd function of the
    model axis (``spmd_pipeline.reduce_over_ranks`` and
    ``gather_over_ranks``) so each first waits for the card's queued work
    (``sync_ms``) and then is timed alone (``collective_ms``), counted by
    name and pass (``"<name> forward"``, the recompute's included, or
    ``"<name> backward"``) in ``calls``, with ``bytes`` and its ms by pass
    in ``by_pass``; the patch is undone on exit.  A gloo collective waits
    for the card anyway (the copy to pinned host memory blocks), so the
    patch adds little to a run's time.  ``groups``: the group's ranks
    (a tuple) → a name (``"data"``, ``"model"``, ``"pod"``,
    ``"pod+data"``): each collective's calls, bytes and ms also by that
    name in ``by_group``.  The modules that bind the two functions by name
    (the train step's gradient buckets, the loss's sums, the moe counts,
    ``global_norm``) are patched too."""
    import torch

    from repro_torch.core import spmd_pipeline as sp

    import torch.distributed as dist

    names = ("reduce_over_ranks", "gather_over_ranks")
    mods = [sp] + [sys.modules[m] for m in (
        "repro_torch.launch.steps", "repro_torch.models.transformer",
        "repro_torch.models.moe", "repro_torch.optim.adamw")
        if m in sys.modules]
    saved = {n: getattr(sp, n) for n in names}
    bound = [(m, n) for m in mods for n in names
             if getattr(m, n, None) is saved[n]]
    stats.setdefault("by_pass", {})
    stats.setdefault("by_group", {})

    def wrap(name, fn):
        def call(t, *args, **kw):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(t, *args, **kw)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            nbytes = t.numel() * t.element_size()
            way = "backward" if kw.get("backward") else "forward"
            stats["sync_ms"] += 1e3 * (t1 - t0)
            stats["collective_ms"] += 1e3 * (t2 - t1)
            key = f"{name} {way}"
            stats["calls"][key] = stats["calls"].get(key, 0) + 1
            stats["bytes"] += nbytes
            p = stats["by_pass"].setdefault(way, {"calls": 0, "bytes": 0,
                                                  "ms": 0.0})
            p["calls"] += 1
            p["bytes"] += nbytes
            p["ms"] += 1e3 * (t2 - t1)
            if groups is not None:
                grp = next(a for a in args if isinstance(a, dist.ProcessGroup))
                gname = groups.get(
                    tuple(dist.get_process_group_ranks(grp)), "other")
                q = stats["by_group"].setdefault(gname, {"calls": 0,
                                                         "bytes": 0,
                                                         "ms": 0.0})
                q["calls"] += 1
                q["bytes"] += nbytes
                q["ms"] += 1e3 * (t2 - t1)
            return out
        return call

    @contextlib.contextmanager
    def patched():
        wrapped = {n: wrap(n, fn) for n, fn in saved.items()}
        for m, n in bound:
            setattr(m, n, wrapped[n])
        try:
            yield stats
        finally:
            for m, n in bound:
                setattr(m, n, saved[n])

    return patched()


def tp_rank(mesh, ids, tokens) -> dict:
    """One rank of the tp phase: draw the whole weights from the phase's
    seed and keep its shards, serve, return its numbers, logits, cache
    shards and the q/k/v its first local and first global layer gave K7."""
    import torch

    from repro_torch.core.spmd_pipeline import local_bounds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    cfg = tp_config()
    t0 = time.perf_counter()
    mesh.device_mesh                      # the DeviceMesh and its groups
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = LM(cfg).init(torch.Generator(mesh.device).manual_seed(TP["seed"]))
    params = TS.distribute_params(mesh, whole)
    del whole
    torch.cuda.empty_cache()
    cache = TST.init_cache_sharded(cfg, mesh, TP["batch"],
                                   TP["prompt_len"] + TP["decode"])
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    keep = {}
    try:
        model, prefill = TST.make_prefill_step(cfg, mesh)
        _, decode = TST.make_decode_step(cfg, mesh)
        with attention_spy(keep=keep, kind=lambda causal, window:
                           "tp local" if window else "tp global"):
            logits, dec, _, ms = tp_serve(model, params, cache,
                                          ids.to(mesh.device), prefill,
                                          decode, tokens)
        launches = dict(fa.LAUNCHES)
        routes = {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()}
        # the same run again, its collectives timed alone (the card's
        # queued work waited for first), for the time's breakdown
        coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                "bytes": 0}
        cache2 = TST.init_cache_sharded(cfg, mesh, TP["batch"],
                                        TP["prompt_len"] + TP["decode"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with timed_collectives(coll):
            tp_serve(model, params, cache2, ids.to(mesh.device), prefill,
                     decode, tokens)
        coll["run_ms"] = 1e3 * (time.perf_counter() - t1)
        del cache2
    finally:
        layers.set_attention_mesh(None)
    shapes = {n: tuple(params["layers"][a][b].to_local().shape)
              for n, (a, b) in {"wq": ("attn", "wq"), "wk": ("attn", "wk"),
                                "attn/wo": ("attn", "wo"),
                                "mlp/wi": ("mlp", "wi"),
                                "mlp/wo": ("mlp", "wo")}.items()}
    shapes["embed"] = tuple(params["embed"]["table"].to_local().shape)
    shapes["cache_k"] = tuple(cache["k"].to_local().shape)
    return {"rank": mesh.rank, "transport": mesh.transport,
            "shapes": shapes, "logits": logits, "decode": dec, "ms": ms,
            "draw_s": draw_s, "mesh_s": mesh_s, "collectives": coll,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "routes": routes,
            "k7_inputs": {n: (*(t.cpu() for t in qkv), w)
                          for n, (*qkv, w) in keep.items()},
            "cache": {n: (cache[n].to_local().cpu(),
                          local_bounds(cache[n])) for n in ("k", "v")}}


def tp_prepare() -> dict:
    """Cell 12's reference: the whole-model serving run of gemma3-12b,
    alone on the card; → what :func:`tp_rank` and :func:`tp_check`
    read."""
    import gc

    import torch

    from repro_torch.core.tree import leaves
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = tp_config()
    B, T, n = TP["batch"], TP["prompt_len"], TP["decode"]
    glob = [i for i in range(cfg.n_layers) if cfg.layer_windows[i] == 0]
    print(f"[tp] {cfg.arch_id}: {cfg.n_layers} of 48 layers (global "
          f"{glob}), d {cfg.d_model}, {cfg.n_heads} heads x {cfg.hd} over "
          f"{cfg.n_kv_heads} kv heads, ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}; batch {B} x {T} tokens, {n} decode steps; mesh "
          f"(data, model) = {TP['mesh']}")

    # the whole-model run, alone on the card
    model = LM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(TP["seed"]))
    nbytes = sum(a.numel() * a.element_size() for a in leaves(params))
    ids = tp_inputs(cfg, "cuda")
    cache = model.init_cache(B, T + n)
    _, prefill = TST.make_prefill_step(cfg)
    _, decode = TST.make_decode_step(cfg)
    ref, ref_dec, tokens, ref_ms = tp_serve(model, params, cache, ids,
                                            prefill, decode)
    ref_cache = {k: cache[k].cpu() for k in ("k", "v")}
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    print(f"[tp] whole-model run: {nbytes / 1e9:.3f} GB of weights; prefill "
          f"step {ref_ms['prefill_step_ms']:.3f} ms, prefill into the cache "
          f"{ref_ms['prefill_cache_ms']:.3f} ms, decode "
          f"{statistics.median(ref_ms['decode_ms']):.3f} ms a step "
          f"(median of {n}); {t_ref:.3f} s")
    return {"cfg": cfg, "ids": ids.cpu(), "tokens": tokens, "ref": ref,
            "ref_dec": ref_dec, "ref_ms": ref_ms, "ref_cache": ref_cache,
            "nbytes": nbytes, "t_ref": t_ref}


def tp_check(prep: dict, res: list) -> tuple[dict, dict]:
    """gemma3-12b served tensor-parallel on 2 ranks sharing the card
    (``res``: each rank's :func:`tp_rank`), held to the whole-model run on
    the same weights (:func:`tp_prepare`)."""
    import gc

    import torch

    t0 = time.perf_counter()
    cfg, ref, ref_dec = prep["cfg"], prep["ref"], prep["ref_dec"]
    ref_ms, ref_cache, t_ref = prep["ref_ms"], prep["ref_cache"], prep["t_ref"]
    B, T, n = TP["batch"], TP["prompt_len"], TP["decode"]
    ranks_s = max(r["part_s"] for r in res)
    half = {"wq": (cfg.d_model, cfg.n_heads // 2, cfg.hd),
            "wk": (cfg.d_model, cfg.n_kv_heads // 2, cfg.hd),
            "attn/wo": (cfg.n_heads * cfg.hd // 2, cfg.d_model),
            "mlp/wi": (cfg.d_model, 2, cfg.d_ff // 2),
            "mlp/wo": (cfg.d_ff // 2, cfg.d_model),
            "embed": (cfg.vocab_padded // 2, cfg.d_model),
            "cache_k": (B, T + n, cfg.n_kv_heads // 2, cfg.hd)}
    counts: dict = {}
    for r in res:
        k7 = r["launches"]["flash_attention"]
        print(f"[tp] rank {r['rank']} over {r['transport']}: local shapes "
              f"{r['shapes']}; peak {r['peak_gb']:.3f} GB; DeviceMesh in "
              f"{r['mesh_s']:.3f} s, drawn in {r['draw_s']:.3f} s; K7 "
              f"launches {k7} (routes "
              f"{r['routes']['flash_attention']}); prefill step "
              f"{r['ms']['prefill_step_ms']:.3f} ms, prefill into the cache "
              f"{r['ms']['prefill_cache_ms']:.3f} ms, decode "
              f"{statistics.median(r['ms']['decode_ms']):.3f} ms a step")
        c = r["collectives"]
        print(f"[tp] rank {r['rank']} rerun with each collective timed "
              f"alone: {c['run_ms']:.3f} ms in all, {c['collective_ms']:.3f}"
              f" ms in {c['calls']} collectives ({c['bytes'] / 1e6:.3f} MB "
              f"sent), {c['sync_ms']:.3f} ms waiting for the card's queued "
              f"work before them")
        check(c["calls"].get("reduce_over_ranks forward", 0) > 0,
              f"tp rank {r['rank']}: the rerun timed no collective "
              f"({c['calls']})")
        check(all(tuple(r["shapes"][k][-len(v):]) == v
                  for k, v in half.items()),
              f"tp rank {r['rank']}: local shapes {r['shapes']}, want "
              f"{half} (a layer's)")
        check(k7 > 0 and r["routes"]["flash_attention"]["simt_f32"] == 0,
              f"tp rank {r['rank']}: K7 launches {r['routes']}")
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v

    # K7 on the q/k/v that each rank's first local and first global layer
    # gave it: element by element against the plain version on every
    # rank's, rank 0's timed beside the bound, plain version and SDPA
    k7: dict = {}
    for r in res:
        check(set(r["k7_inputs"]) == {"tp local", "tp global"},
              f"tp rank {r['rank']}: K7 saw {set(r['k7_inputs'])}")
        for name, (q, k, v, w) in sorted(r["k7_inputs"].items()):
            q, k, v = (t.to("cuda") for t in (q, k, v))
            want = (B, T, cfg.n_heads // 2, cfg.hd)
            check(tuple(q.shape) == want and k.shape == v.shape == q.shape
                  and q.dtype == torch.bfloat16,
                  f"tp rank {r['rank']} K7 {name}: q {tuple(q.shape)} "
                  f"{q.dtype}, k {tuple(k.shape)}; want {want} bf16")
            if r["rank"] == 0:
                k7[name] = k7_at(q, k, v, w, name, tag="[tp]")
            else:
                d, worst = flash_err(q, k, v, True, w)
                print(f"[tp] rank {r['rank']} K7 {name} at {list(q.shape)} "
                      f"bf16 window {w}: max abs err {d}, {worst} of the "
                      f"element-wise limit")
                k7[f"{name} rank {r['rank']}"] = {
                    "max_abs_err": d, "err_of_elementwise_limit": worst}
        del q, k, v

    def share(got, want) -> float:
        want = want.float()
        return ((got.float() - want).abs().max()
                / (2e-2 * want.abs().max())).item()

    reads = {"prefill_logits": max(share(r["logits"], ref) for r in res),
             "decode_logits": max(share(g, w) for r in res
                                  for g, w in zip(r["decode"], ref_dec))}
    for name in ("k", "v"):
        full = torch.zeros(ref_cache[name].shape, dtype=ref_cache[name].dtype)
        for r in res:
            local, bounds = r["cache"][name]
            full[tuple(bounds)] = local
        reads[f"cache_{name}"] = share(full, ref_cache[name])
        scale = 2e-2 * ref_cache[name].float().abs().max()
        by_layer = [round(((full[i].float() - ref_cache[name][i].float())
                           .abs().max() / scale).item(), 4)
                    for i in range(cfg.n_layers)]
        print(f"[tp] cache_{name} by layer, share of the whole cache's "
              f"limit: {by_layer}")
    for k, v in reads.items():
        print(f"[tp] {k}: max |err| at {v:.4f} of 2e-2 * max|ref|")
        check(v <= 1.0, f"tp {k}: {v:.4f} of the limit")
    out = {"reads_share_of_limit": reads, "whole_ms": ref_ms, "k7": k7,
           "ranks": [{k: r[k] for k in ("rank", "transport", "shapes",
                                        "ms", "draw_s", "mesh_s", "peak_gb",
                                        "launches", "collectives")}
                     for r in res],
           "ranks_s": ranks_s, "weights_gb": prep["nbytes"] / 1e9,
           "phase_s": t_ref + ranks_s + time.perf_counter() - t0}
    print(f"[tp] cell {out['phase_s']:.3f} s (budget 60): whole run "
          f"{t_ref:.3f} s, ranks {ranks_s:.3f} s; K7 launches on the ranks "
          f"{counts}")
    del res
    gc.collect()
    return counts, out


def tp_train_config():
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(TP_TRAIN["arch"]),
                              n_layers=TP_TRAIN["layers"])
    check(cfg.d_model == 3840 and cfg.n_heads == 16 and cfg.n_kv_heads == 8
          and cfg.hd == 256 and cfg.d_ff == 15360 and cfg.vocab == 262144
          and cfg.vocab_padded == cfg.vocab and cfg.dtype == "bfloat16"
          and [int(w) for w in cfg.layer_windows] == [1024] * 5 + [0],
          f"unexpected tp_train config {cfg}")
    return cfg


def tp_train_batch(cfg, device) -> dict:
    """The phase's batch [B, S] drawn from its seed (every token counts)."""
    import torch

    g = torch.Generator(device).manual_seed(TP_TRAIN["seed"] + 1)
    shape = (TP_TRAIN["batch"], TP_TRAIN["seq_len"])
    return {"ids": torch.randint(0, cfg.vocab, shape, generator=g,
                                 device=device),
            "labels": torch.randint(0, cfg.vocab, shape, generator=g,
                                    device=device),
            "mask": torch.ones(shape, device=device)}


def tp_train_checked(tree) -> dict:
    """name → leaf of the leaves the phase holds to the whole run: every
    leaf of layers 0 and 5 (``"<path>@<layer>"``, a view of the stacked
    leaf's layer) and the embed table and final norm; a DTensor's local
    tensor with the layer's bounds (``local_bounds`` without the layer
    dim), a plain tensor whole."""
    from repro_torch.core.spmd_pipeline import local_bounds, local_tensor
    from repro_torch.launch import sharding as TS

    out = {}

    def take(path, a):
        name, local, at = TS.path_str(path), local_tensor(a), local_bounds(a)
        if name.startswith("layers/"):
            for i in TP_TRAIN["checked"]:
                out[f"{name}@{i}"] = (local[i], at[1:])
        else:
            out[name] = (local, at)

    TS.map_with_path(take, tree)
    return out


def tp_train_reference(path: str) -> dict:
    """The whole-model run on plain tensors in this process: step 1's
    loss, grad_norm (before clipping) and the checked gradients, saved to
    ``path`` for the ranks (each reads its shards' bounds of it); →
    (loss, grad_norm, max |g| of each checked leaf, weights GB, ms)."""
    import torch

    from repro_torch.core.tree import flatten, leaves, unflatten
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import LM
    from repro_torch.optim import global_norm

    cfg = tp_train_config()
    model = LM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(
        TP_TRAIN["seed"]))
    nbytes = sum(a.numel() * a.element_size() for a in leaves(params))
    batch = tp_train_batch(cfg, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ce, grads, _ = loss_and_grads(model, params, batch,
                                  loss_chunk=TP_TRAIN["loss_chunk"])
    gnorm = float(global_norm(grads))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    tree = unflatten(flatten(params)[1], grads)
    checked = {k: g.cpu() for k, (g, _) in tp_train_checked(tree).items()}
    torch.save(checked, path)
    out = {"loss": float(ce), "grad_norm": gnorm,
           "max_ref": {k: float(g.float().abs().max())
                       for k, g in checked.items()},
           "weights_gb": nbytes / 1e9, "step_ms": ms}
    del params, grads, tree, checked
    return out


def tp_train_rank(mesh, ref_path: str) -> dict:
    """One rank of the tp_train phase: draw the whole weights from the
    phase's seed and keep its shards (``init_train_state_sharded``), run
    two ``make_train_step`` steps with seq_parallel, then one without it
    from the same start, the collectives timed alone; each step's
    gradients held, before AdamW clips them, to the whole run's at this
    rank's bounds (``max |g - g_ref|`` a checked leaf); the moments' local
    shapes after step 1; the q, k, v and dO of layer 0's and layer 5's
    attention in step 1 (K7's inputs, K8's and K9's output gradient)."""
    import torch

    from repro_torch.core.spmd_pipeline import is_dtensor, local_tensor
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers
    from repro_torch.optim import adamw_init

    cfg = tp_train_config()
    t0 = time.perf_counter()
    mesh.device_mesh                      # the DeviceMesh and its groups
    whole = LM(cfg).init(torch.Generator(mesh.device).manual_seed(
        TP_TRAIN["seed"]))
    state = TST.init_train_state_sharded(cfg, mesh, whole)
    del whole
    start = [local_tensor(a).clone() for a in leaves(state["params"])]
    torch.cuda.empty_cache()
    batch = tp_train_batch(cfg, mesh.device)
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0

    steps, errs, inputs = [], [], {}
    real_update = TST.adamw_update

    def spy(grads, st, params, **kw):
        """The step's gradients against the whole run's, before AdamW."""
        t1 = time.perf_counter()
        if steps_plan[len(steps)][1]:
            e = {}
            for k, (g, at) in tp_train_checked(grads).items():
                want = ref[k][at].to(g.device)
                e[k] = float((g.float() - want.float()).abs().max())
            errs.append(e)
            torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t1
        return real_update(grads, st, params, **kw)

    def keep_attention(q, k, v, causal=True, window=0):
        o = real_attention(q, k, v, causal, window)
        name = "tp_train local" if window else "tp_train global"
        if name not in inputs and torch.is_grad_enabled():
            inputs[name] = [t.detach().clone() for t in (q, k, v)] + [
                None, int(window)]
            o.register_hook(lambda g, n=name: inputs[n].__setitem__(
                3, g.detach().clone()))
        return o

    # (seq_parallel, compare the gradients) of each step
    steps_plan = [(True, True), (True, False), (False, True)]
    real_attention = layers.ops.attention
    TST.adamw_update = spy
    try:
        for i, (sp, _) in enumerate(steps_plan):
            if i == 2:                    # the same start, no moments yet
                for a, s0 in zip(leaves(state["params"]), start):
                    local_tensor(a).copy_(s0)
                state = {"params": state["params"],
                         "opt": adamw_init(state["params"])}
            _, step = TST.make_train_step(
                cfg, mesh, seq_parallel=sp, lr=TP_TRAIN["lr"], warmup=1,
                total_steps=10, loss_chunk=TP_TRAIN["loss_chunk"])
            layers.ops.attention = keep_attention if i == 0 else \
                real_attention
            coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                    "bytes": 0}
            spent = [0.0]
            fa.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with timed_collectives(coll):
                state, met = step(state, batch)
                loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            ms = 1e3 * (time.perf_counter() - t1 - spent[0])
            steps.append({
                "seq_parallel": sp, "loss": loss, "grad_norm": gnorm,
                "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": dict(fa.LAUNCHES),
                "routes": {k: dict(v) for k, v in
                           fa.ROUTE_LAUNCHES.items()},
                "collectives": coll})
            if i == 0:
                moments = {}
                TS.map_with_path(lambda p, a: moments.__setitem__(
                    TS.path_str(p), (tuple(local_tensor(a).shape),
                                     tuple(a.shape))), state["opt"].m)
    finally:
        TST.adamw_update = real_update
        layers.ops.attention = real_attention
        layers.set_attention_mesh(None)
    return {"rank": mesh.rank, "transport": mesh.transport,
            "draw_s": draw_s, "steps": steps, "grad_err": errs,
            "moments": moments,
            "moments_plain_step": not is_dtensor(state["opt"].step),
            "inputs": {n: tuple(t.cpu() if torch.is_tensor(t) else t
                                for t in v) for n, v in inputs.items()}}


def tp_train_prepare(tmp: str) -> dict:
    """Cell 13's reference: the whole-model step of gemma3-12b, its
    gradients saved under ``tmp`` for the ranks; → what
    :func:`tp_train_rank` and :func:`tp_train_check` read."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = tp_train_config()
    B, S = TP_TRAIN["batch"], TP_TRAIN["seq_len"]
    print(f"[tp_train] {cfg.arch_id}: {cfg.n_layers} of 48 layers (windows "
          f"{[int(w) for w in cfg.layer_windows]}), d {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.hd} over {cfg.n_kv_heads} kv heads, "
          f"ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; batch {B} x {S} "
          f"tokens, loss chunk {TP_TRAIN['loss_chunk']}, per-layer remat, "
          f"AdamW lr {TP_TRAIN['lr']}; mesh (data, model) = "
          f"{TP_TRAIN['mesh']}")
    ref_path = os.path.join(tmp, "reference.pt")
    ref = tp_train_reference(ref_path)
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    print(f"[tp_train] whole-model run: {ref['weights_gb']:.3f} GB of "
          f"weights; loss {ref['loss']} grad_norm {ref['grad_norm']}; "
          f"loss and gradients {ref['step_ms']:.3f} ms; {t_ref:.3f} s "
          f"with the draw and the saved gradients")
    return {"cfg": cfg, "path": ref_path, "ref": ref, "t_ref": t_ref}


def tp_train_check(prep: dict, res: list) -> tuple[dict, dict]:
    """gemma3-12b trained tensor-parallel on 2 ranks sharing the card
    (``res``: each rank's :func:`tp_train_rank`), held to the whole-model
    run on the same weights and batch (:func:`tp_train_prepare`)."""
    import gc

    import torch

    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    cfg, ref, t_ref = prep["cfg"], prep["ref"], prep["t_ref"]
    B, S = TP_TRAIN["batch"], TP_TRAIN["seq_len"]
    ranks_s = max(r["part_s"] for r in res)
    layout = MeshLayout(TP_TRAIN["mesh"], ("data", "model"))
    abstract = TST.abstract_params(cfg)
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.opt_shardings(layout, adamw_init(abstract),
                                      abstract).m)
    per_step = {"flash_attention": 2 * cfg.n_layers,
                "flash_attention_bwd_dq": cfg.n_layers,
                "flash_attention_bwd_dkv": cfg.n_layers}
    counts: dict = {}
    for r in res:
        for i, st in enumerate(r["steps"]):
            c = st["collectives"]
            print(f"[tp_train] rank {r['rank']} step {i + 1} seq_parallel "
                  f"{st['seq_parallel']}: loss {st['loss']} grad_norm "
                  f"{st['grad_norm']}; {st['ms']:.3f} ms, peak "
                  f"{st['peak_gb']:.3f} GB; launches {st['launches']} "
                  f"(routes {st['routes']}); {c['collective_ms']:.3f} ms in "
                  f"{c['calls']} collectives ({c['bytes'] / 1e6:.3f} MB), "
                  f"by pass {c['by_pass']}, {c['sync_ms']:.3f} ms waiting "
                  f"for the card's queued work before them")
            check(st["launches"] == per_step,
                  f"tp_train rank {r['rank']} step {i + 1}: launches "
                  f"{st['launches']}, expected {per_step}")
            check(all(st["routes"][k] == {"wgmma_bf16": n, "simt_f32": 0}
                      for k, n in per_step.items()),
                  f"tp_train rank {r['rank']} step {i + 1}: routes "
                  f"{st['routes']}")
            check(c["by_pass"].get("backward", {}).get("calls", 0) > 0,
                  f"tp_train rank {r['rank']} step {i + 1}: no collective "
                  f"in the backward pass ({c['calls']})")
            for k, v in st["launches"].items():
                counts[k] = counts.get(k, 0) + v
        bad = {k: v for k, v in r["moments"].items()
               if v[0] != TS.local_shape(layout, specs[k], v[1])}
        check(not bad and r["moments_plain_step"],
              f"tp_train rank {r['rank']}: moments' local shapes off their "
              f"opt_shardings specs: {bad}")
        print(f"[tp_train] rank {r['rank']} over {r['transport']}: drawn and "
              f"cut in {r['draw_s']:.3f} s; every moment's local shape is "
              f"its opt_shardings spec's (e.g. layers/attn/wq "
              f"{r['moments']['layers/attn/wq'][0]} of "
              f"{r['moments']['layers/attn/wq'][1]})")
    reads = {}
    for i in range(3):
        st = [r["steps"][i] for r in res]
        norms = {s["grad_norm"] for s in st}
        check(len(norms) == 1, f"tp_train step {i + 1}: grad_norm differs "
                               f"between the ranks: {norms}")
    for i in (0, 2):                           # from the same start
        st = res[0]["steps"][i]
        reads[f"step{i + 1}_loss_rel"] = (abs(st["loss"] - ref["loss"])
                                          / abs(ref["loss"]))
        reads[f"step{i + 1}_grad_norm_rel"] = (
            abs(st["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"])
        check(reads[f"step{i + 1}_loss_rel"] <= 1e-3
              and reads[f"step{i + 1}_grad_norm_rel"] <= 1e-2,
              f"tp_train step {i + 1}: loss {st['loss']} grad_norm "
              f"{st['grad_norm']} against the whole run's {ref['loss']} "
              f"{ref['grad_norm']}")
        share = {k: max(r["grad_err"][0 if i == 0 else 1][k] for r in res)
                 / (2e-2 * ref["max_ref"][k]) for k in ref["max_ref"]}
        label = "seq_parallel" if i == 0 else "no seq_parallel"
        for k, v in sorted(share.items()):
            print(f"[tp_train] {label} gradient {k}: max |g - g_ref| at "
                  f"{v:.4f} of 2e-2 * max|g_ref| ({ref['max_ref'][k]:.6g})")
        worst = max(share.values())
        reads[f"step{i + 1}_grad_share_of_limit"] = worst
        check(worst <= 1.0, f"tp_train {label}: a gradient is off by "
                            f"{worst} of its limit ({share})")
    falls = [r["steps"][1]["loss"] < r["steps"][0]["loss"] for r in res]
    print(f"[tp_train] loss step 1 -> 2 (seq_parallel, the same batch): "
          f"{res[0]['steps'][0]['loss']} -> {res[0]['steps'][1]['loss']}")
    check(all(falls), "tp_train: the loss did not fall from step 1 to 2")
    peak = {sp: max(s["peak_gb"] for r in res for s in r["steps"]
                    if s["seq_parallel"] == sp) for sp in (True, False)}
    print(f"[tp_train] peak GB a rank: seq_parallel {peak[True]:.3f}, "
          f"without {peak[False]:.3f}")

    # K8 and K9 at each rank's own q, k, v and dO of layer 0 (local) and
    # layer 5 (global): element by element against the plain versions,
    # rank 0's timed beside the bound, the plain backward and SDPA's
    bwd: dict = {}
    for r in res:
        check(set(r["inputs"]) == {"tp_train local", "tp_train global"}
              and all(v[3] is not None for v in r["inputs"].values()),
              f"tp_train rank {r['rank']}: attention inputs "
              f"{ {k: [t is None for t in v] for k, v in r['inputs'].items()} }")
        for name, (q, k, v, do, w) in sorted(r["inputs"].items()):
            q, k, v, do = (t.to("cuda") for t in (q, k, v, do))
            want = (B, S, cfg.n_heads // 2, cfg.hd)
            check(tuple(q.shape) == want and k.shape == v.shape == q.shape
                  == do.shape and q.dtype == torch.bfloat16,
                  f"tp_train rank {r['rank']} {name}: q {tuple(q.shape)} "
                  f"{q.dtype}, dO {tuple(do.shape)}; want {want} bf16")
            if r["rank"] == 0:
                bwd[name] = k8_k9_at(q, k, v, do, w, name, tag="[tp_train]")
            else:
                e = flash_bwd_err(q, k, v, do, True, w)
                print(f"[tp_train] rank {r['rank']} K8/K9 {name} at "
                      f"{list(q.shape)} bf16 window {w}: {e}")
                bwd[f"{name} rank {r['rank']}"] = e
            del q, k, v, do
    out = {"reference": {k: v for k, v in ref.items() if k != "max_ref"},
           "reads": reads, "peak_gb": peak, "k8_k9": bwd,
           "ranks": [{"rank": r["rank"], "draw_s": r["draw_s"],
                      "steps": r["steps"]} for r in res],
           "ranks_s": ranks_s,
           "phase_s": t_ref + ranks_s + time.perf_counter() - t0}
    print(f"[tp_train] cell {out['phase_s']:.3f} s (budget 90): whole run "
          f"{t_ref:.3f} s, ranks {ranks_s:.3f} s; K7/K8/K9 launches on the "
          f"ranks {counts}")
    del res
    gc.collect()
    return counts, out


# --------------------------------------------------------------------------- #
# 14. expert parallelism: moonshot-v1-16b-a3b served and trained on 2 ranks
# --------------------------------------------------------------------------- #
def ep_config(layers: int):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(EP["arch"]), n_layers=layers)
    check(cfg.d_model == 2048 and cfg.n_heads == 16 and cfg.n_kv_heads == 16
          and cfg.hd == 128 and cfg.d_ff == 1408 and cfg.n_experts == 64
          and cfg.top_k == 6 and cfg.vocab == 163840 and cfg.window == 0
          and cfg.dtype == "bfloat16", f"unexpected ep config {cfg}")
    return cfg


class RoutingLog:
    """A ``moe.ROUTING_HOOK`` that keeps every call's own top-k choices by
    (phase, layer) in ``own`` (the caller sets ``phase``; a layer's router
    is a view of the stacked [L, d, E] one, so its storage offset names the
    layer) and replaces them with ``pins[phase][layer]`` for the phases
    ``pins`` holds; ``dropped[phase]`` gathers each moe call's
    ``dropped_frac`` (:func:`moe_spy`).  ``part`` (i, n): the rank holds
    the i-th of n equal parts of the batch's tokens (its rows of a batch
    split over a data axis) and takes that part of each pin."""

    def __init__(self, pins: dict | None = None, part=None):
        self.pins, self.phase, self.part = pins or {}, None, part
        self.own, self.dropped = {}, {}

    def set(self, phase: str) -> None:
        self.phase = phase

    def __call__(self, router, logits, idx):
        layer = router.storage_offset() // router.numel()
        self.own.setdefault((self.phase, layer), []).append(
            idx.detach().cpu())
        pin = self.pins.get(self.phase)
        if pin is None:
            return idx
        pin = pin[layer].to(idx.device)
        if self.part is not None:
            i, n = self.part
            flat = pin.reshape(-1, pin.shape[-1])
            m = flat.shape[0] // n
            pin = flat[i * m:(i + 1) * m]
        return pin.reshape(idx.shape)

    def first(self) -> dict:
        """phase -> each layer's first choices (the forward's, before any
        recompute)."""
        out: dict = {}
        for (phase, layer), calls in sorted(self.own.items()):
            out.setdefault(phase, []).append(calls[0])
        return out


@contextlib.contextmanager
def moe_spy(log: RoutingLog, keep: dict):
    """``transformer.moe_apply`` as it is, each call's ``dropped_frac``
    appended to ``log.dropped[log.phase]`` and the first call's input,
    output and routing in the "prefill" phase kept in ``keep``."""
    from repro_torch.models import transformer as mt

    real = mt.moe_apply

    def spy(p, x, *a, **kw):
        r = {}
        y, aux = real(p, x, *a, routing=r, **kw)
        log.dropped.setdefault(log.phase, []).append(
            aux["dropped_frac"].detach())
        if log.phase == "prefill" and not keep:
            keep.update(x=x, y=y, **{k: r[k] for k in ("idx", "gate",
                                                       "keep")})
        return y, aux

    mt.moe_apply = spy
    try:
        yield
    finally:
        mt.moe_apply = real


def ep_inputs(cfg, device):
    """The served prompts [B, T] drawn from the phase's seed."""
    import torch

    g = torch.Generator(device).manual_seed(EP["seed"] + 1)
    return torch.randint(0, cfg.vocab, (EP["batch"], EP["prompt_len"]),
                         generator=g, device=device)


def ep_serve_rank(mesh, cfg, ref_path: str) -> dict:
    """One rank of the ep phase's serving: draw the whole weights from the
    phase's seed and keep its shards, serve teacher-forced with the whole
    run's tokens and routing pinned, rerun with the collectives timed
    alone, then an unpinned prefill; its logits, cache shards, layer 0's
    moe input, output and routing, each call's dropped_frac, its own
    choices and the q/k/v its first layer gave K7."""
    import torch

    from repro_torch.core.spmd_pipeline import local_bounds
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    B, T, n = EP["batch"], EP["prompt_len"], EP["decode"]
    ref = torch.load(ref_path)
    t0 = time.perf_counter()
    mesh.device_mesh                      # the DeviceMesh and its groups
    whole = LM(cfg).init(torch.Generator(mesh.device).manual_seed(EP["seed"]))
    params = TS.distribute_params(mesh, whole)
    del whole
    torch.cuda.empty_cache()
    cache = TST.init_cache_sharded(cfg, mesh, B, T + n)
    ids = ref["ids"].to(mesh.device)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    log, keep, kq = RoutingLog(ref["pins"]), {}, {}
    try:
        model, prefill = TST.make_prefill_step(cfg, mesh)
        _, decode = TST.make_decode_step(cfg, mesh)
        with routing_hook(log), moe_spy(log, keep), attention_spy(
                keep=kq, kind=lambda causal, window: "ep"):
            logits, dec, _, ms = tp_serve(model, params, cache, ids, prefill,
                                          decode, ref["tokens"], steps=n,
                                          phase=log.set)
        launches = dict(fa.LAUNCHES)
        routes = {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()}
        # the same run again, its collectives timed alone
        coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                "bytes": 0}
        cache2 = TST.init_cache_sharded(cfg, mesh, B, T + n)
        again = RoutingLog(ref["pins"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with routing_hook(again), timed_collectives(coll):
            tp_serve(model, params, cache2, ids, prefill, decode,
                     ref["tokens"], steps=n, phase=again.set)
        coll["run_ms"] = 1e3 * (time.perf_counter() - t1)
        del cache2
        # the ranks' own choices, nothing pinned
        own = RoutingLog()
        own.set("own")
        with routing_hook(own):
            prefill(params, {"ids": ids})
        torch.cuda.synchronize()
    finally:
        layers.set_attention_mesh(None)
    moe, lp = params["layers"]["moe"], params["layers"]
    shapes = {"moe/wi": tuple(moe["wi"].to_local().shape),
              "moe/wo": tuple(moe["wo"].to_local().shape),
              "moe/router": tuple(moe["router"].to_local().shape),
              "attn/wq": tuple(lp["attn"]["wq"].to_local().shape),
              "embed": tuple(params["embed"]["table"].to_local().shape),
              "cache_k": tuple(cache["k"].to_local().shape)}
    return {"rank": mesh.rank, "transport": mesh.transport, "shapes": shapes,
            "experts": local_bounds(moe["wi"])[1],
            "logits": logits, "decode": dec, "ms": ms, "draw_s": draw_s,
            "collectives": coll,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "routes": routes,
            "dropped": {k: [float(v) for v in vs]
                        for k, vs in log.dropped.items()},
            "own": {**log.own, **own.own},
            "moe0": {k: v.cpu() for k, v in keep.items()},
            "k7_inputs": {nm: (*(t.cpu() for t in qkv), w)
                          for nm, (*qkv, w) in kq.items()},
            "cache": {nm: (cache[nm].to_local().cpu(),
                           local_bounds(cache[nm])) for nm in ("k", "v")}}


def ep_serve_reference(cfg, path: str) -> dict:
    """The whole-model serving run on plain tensors in this process, its
    routing recorded: the prompts, the greedy tokens it fed and each
    phase's choices by layer saved to ``path`` for the ranks; → its
    logits, cache, dropped_frac by phase, layer 0's moe weights, ms."""
    import torch

    from repro_torch.core.tree import leaves
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM

    B, T, n = EP["batch"], EP["prompt_len"], EP["decode"]
    model = LM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(EP["seed"]))
    nbytes = sum(a.numel() * a.element_size() for a in leaves(params))
    ids = ep_inputs(cfg, "cuda")
    cache = model.init_cache(B, T + n, device="cuda")
    _, prefill = TST.make_prefill_step(cfg)
    _, decode = TST.make_decode_step(cfg)
    log, keep = RoutingLog(), {}
    with routing_hook(log), moe_spy(log, keep):
        logits, dec, tokens, ms = tp_serve(model, params, cache, ids,
                                           prefill, decode, steps=n,
                                           phase=log.set)
    pins = {k: torch.stack(v) for k, v in log.first().items()}
    torch.save({"ids": ids.cpu(), "tokens": tokens, "pins": pins}, path)
    out = {"logits": logits, "decode": dec, "ms": ms,
           "cache": {k: cache[k].cpu() for k in ("k", "v")},
           "dropped": {k: [float(v) for v in vs]
                       for k, vs in log.dropped.items()},
           "own": log.first(), "weights_gb": nbytes / 1e9,
           "moe0_io": keep,
           "moe0": {k: v[0].clone() for k, v in
                    params["layers"]["moe"].items()}}
    del params, cache
    return out


def ep_train_config():
    return ep_config(EP["train_layers"])


def ep_train_batch(cfg, device) -> dict:
    """The phase's training batch [B, S] drawn from its seed."""
    import torch

    g = torch.Generator(device).manual_seed(EP["seed"] + 2)
    shape = (EP["train_batch"], EP["train_seq"])
    return {"ids": torch.randint(0, cfg.vocab, shape, generator=g,
                                 device=device),
            "labels": torch.randint(0, cfg.vocab, shape, generator=g,
                                    device=device),
            "mask": torch.ones(shape, device=device)}


def ep_train_checked(tree, n_layers: int) -> dict:
    """name → (leaf, its bounds in the whole one) of the leaves the ep
    phase holds to the whole run: each layer's router, ``ln2`` scale and
    ``wq`` (the rank's heads), ``wi``/``wo`` of the experts in
    ``EP["experts"]`` the rank holds, and the embed table (its vocab
    rows); a DTensor's local tensor, a plain tensor whole."""
    from repro_torch.core.spmd_pipeline import local_bounds, local_tensor

    lp, out = tree["layers"], {}
    for i in range(n_layers):
        for name, a in (("moe/router", lp["moe"]["router"]),
                        ("ln2/scale", lp["ln2"]["scale"]),
                        ("attn/wq", lp["attn"]["wq"])):
            out[f"layers/{name}@{i}"] = (local_tensor(a)[i],
                                         local_bounds(a)[1:])
        for name in ("wi", "wo"):
            a = lp["moe"][name]
            ex = local_bounds(a)[1]
            for e in EP["experts"]:
                if ex.start <= e < ex.stop:
                    w = local_tensor(a)[i, e - ex.start]
                    out[f"layers/moe/{name}@{i}/expert{e}"] = (
                        w, tuple(slice(0, m) for m in w.shape))
    table = tree["embed"]["table"]
    out["embed/table"] = (local_tensor(table), local_bounds(table))
    return out


def ep_train_reference(path: str) -> dict:
    """The whole-model training run on plain tensors: step 1's loss,
    grad_norm (before clipping), checked gradients and each layer's
    routing, the gradients and the routing saved to ``path`` for the
    ranks; and the control: the same step in f32 with the same routing
    pinned, its checked gradients saved beside (``"f32"``) and each one's
    distance to the bf16 step's (``own_f32``, the bf16 step's own
    rounding)."""
    import dataclasses

    import torch

    from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import LM
    from repro_torch.optim import global_norm

    cfg = ep_train_config()
    model = LM(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(EP["seed"] + 3))
    nbytes = sum(a.numel() * a.element_size() for a in leaves(params))
    batch = ep_train_batch(cfg, "cuda")
    log = RoutingLog()
    log.set("train")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routing_hook(log), moe_spy(log, {}):
        ce, grads, aux = loss_and_grads(model, params, batch,
                                        loss_chunk=EP["loss_chunk"])
    gnorm = float(global_norm(grads))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    plain = {k: g.cpu() for k, (g, _) in ep_train_checked(
        unflatten(flatten(params)[1], grads), cfg.n_layers).items()}
    pins = {k: torch.stack(v) for k, v in log.first().items()}
    del grads
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    del params
    log32 = RoutingLog({"train32": pins["train"]})
    log32.set("train32")
    with routing_hook(log32):
        _, g32, _ = loss_and_grads(LM(c32), p32, batch,
                                   loss_chunk=EP["loss_chunk"])
    f32 = {k: g.cpu() for k, (g, _) in ep_train_checked(
        unflatten(flatten(p32)[1], g32), cfg.n_layers).items()}
    del p32, g32
    torch.save({"plain": plain, "pins": pins, "f32": f32}, path)
    out = {"loss": float(ce), "grad_norm": gnorm,
           "dropped_frac": float(aux["dropped_frac"]),
           "max_plain": {k: float(g.float().abs().max())
                         for k, g in plain.items()},
           "own_f32": {k: float((g.float() - f32[k]).abs().max())
                       for k, g in plain.items()},
           "weights_gb": nbytes / 1e9, "step_ms": ms}
    del plain, f32
    torch.cuda.empty_cache()
    return out


def ep_whole_experts_grads(mesh, cfg, whole, batch, seq_parallel: bool
                           ) -> tuple[float, dict]:
    """The reference the ranks' expert-parallel gradients are held to: the
    same step-1 loss and gradients on the same ranks with ``moe/wi`` and
    ``moe/wo`` whole on every rank (the guard's path: every expert
    computed, nothing summed) and everything else split as the train
    step splits it (attention's heads, whose row split's f32 sum is the
    ranks' own, ff and vocab) → (the cross-entropy, the checked gradients
    by :func:`ep_train_checked`).  The forward is the expert-parallel
    one's, bit for bit (the exact combine), so this reference isolates
    expert parallelism from the row split's rounding, which this init's
    large experts carry into a few percent of some gradients."""
    import torch

    from repro_torch.core.tree import flatten, unflatten
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM

    sh = TS.param_shardings(mesh, whole)
    for n in ("wi", "wo"):
        sh["layers"]["moe"][n] = TS.NamedSharding(
            mesh, TS.P(*(None,) * whole["layers"]["moe"][n].dim()))
    params = TS.distribute_params(mesh, whole, sh)
    TST.make_train_step(cfg, mesh, seq_parallel=seq_parallel)  # the layout
    con = TST._layer_param_constraint(mesh)

    def keep_experts(lp):
        """The step's layer constraint, but for wi and wo, left whole."""
        moe = lp["moe"]
        out = con({**lp, "moe": {k: v for k, v in moe.items()
                                 if k not in ("wi", "wo")}})
        out["moe"] = {**out["moe"], "wi": moe["wi"], "wo": moe["wo"]}
        return out

    ce, grads, _ = TST.loss_and_grads(
        LM(cfg), params, batch, loss_chunk=EP["loss_chunk"],
        act_constraint=TST._act_constraint(mesh) if seq_parallel else None,
        param_constraint=keep_experts)
    checked = {k: g.detach().clone() for k, (g, _) in ep_train_checked(
        unflatten(flatten(params)[1], grads), cfg.n_layers).items()}
    del params, grads
    return float(ce), checked


def ep_train_rank(mesh, cfg, ref_path: str) -> dict:
    """One rank of the ep phase's training: draw the whole weights and
    keep its shards (``init_train_state_sharded``); two
    ``make_train_step`` steps with seq_parallel, then one without from the
    same start, the collectives timed alone; steps 1 and 3 with the whole
    run's routing pinned, their gradients taken before AdamW against the
    same ranks' step with the experts whole
    (:func:`ep_whole_experts_grads`, first) and against the whole run's
    at this rank's bounds, step 2 routed by the rank itself; the moments'
    local shapes; its own choices; layer 0's q, k, v and dO."""
    import torch

    from repro_torch.core.spmd_pipeline import is_dtensor, local_tensor
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers
    from repro_torch.optim import adamw_init

    t0 = time.perf_counter()
    mesh.device_mesh
    whole = LM(cfg).init(torch.Generator(mesh.device).manual_seed(
        EP["seed"] + 3))
    state = TST.init_train_state_sharded(cfg, mesh, whole)
    start = [local_tensor(a).clone() for a in leaves(state["params"])]
    batch = ep_train_batch(cfg, mesh.device)
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0

    pinned = ref["pins"]["train"]
    log = RoutingLog({"step1": pinned, "step3": pinned,
                      "whole_experts_seq": pinned,
                      "whole_experts_noseq": pinned})
    # the experts-whole reference of steps 1 (seq_parallel) and 3 (not)
    t1 = time.perf_counter()
    whole_ref = {}
    try:
        with routing_hook(log):
            for sp in (True, False):
                log.set(f"whole_experts_{'seq' if sp else 'noseq'}")
                whole_ref[sp] = ep_whole_experts_grads(mesh, cfg, whole,
                                                       batch, sp)
    finally:
        layers.set_attention_mesh(None)
    del whole
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    whole_ref_s = time.perf_counter() - t1

    steps, errs, inputs = [], [], {}
    real_update = TST.adamw_update

    def spy(grads, st, params, **kw):
        """The step's gradients against the whole run's, before AdamW."""
        t1 = time.perf_counter()
        sp, compare = steps_plan[len(steps)]
        if compare:
            e = {}
            for k, (g, at) in ep_train_checked(grads,
                                               cfg.n_layers).items():
                want = whole_ref[sp][1][k]
                e[k] = float((g.float() - want.float()).abs().max())
                want = ref["plain"][k][at].to(g.device)
                e[f"{k} plain"] = float((g.float() - want.float()).abs()
                                        .max())
                want = ref["f32"][k][at].to(g.device)
                e[f"{k} f32"] = float((g.float() - want).abs().max())
            errs.append(e)
            torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t1
        return real_update(grads, st, params, **kw)

    def keep_attention(q, k, v, causal=True, window=0):
        o = real_attention(q, k, v, causal, window)
        if "ep_train" not in inputs and torch.is_grad_enabled():
            inputs["ep_train"] = [t.detach().clone() for t in (q, k, v)] + [
                None, int(window)]
            o.register_hook(lambda g: inputs["ep_train"].__setitem__(
                3, g.detach().clone()))
        return o

    # (seq_parallel, compare the gradients) of each step
    steps_plan = [(True, True), (True, False), (False, True)]
    real_attention = layers.ops.attention
    TST.adamw_update = spy
    try:
        with routing_hook(log), moe_spy(log, {}):
            for i, (sp, _) in enumerate(steps_plan):
                log.set(f"step{i + 1}")
                if i == 2:                # the same start, no moments yet
                    for a, s0 in zip(leaves(state["params"]), start):
                        local_tensor(a).copy_(s0)
                    state = {"params": state["params"],
                             "opt": adamw_init(state["params"])}
                _, step = TST.make_train_step(
                    cfg, mesh, seq_parallel=sp, lr=EP["lr"], warmup=1,
                    total_steps=10, loss_chunk=EP["loss_chunk"])
                layers.ops.attention = (keep_attention if i == 0
                                        else real_attention)
                coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                        "bytes": 0}
                spent = [0.0]
                fa.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with timed_collectives(coll):
                    state, met = step(state, batch)
                    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
                ms = 1e3 * (time.perf_counter() - t1 - spent[0])
                steps.append({
                    "seq_parallel": sp, "loss": loss, "grad_norm": gnorm,
                    "dropped_frac": float(met["dropped_frac"]), "ms": ms,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": dict(fa.LAUNCHES),
                    "routes": {k: dict(v) for k, v in
                               fa.ROUTE_LAUNCHES.items()},
                    "collectives": coll})
                if i == 0:
                    moments = {}
                    TS.map_with_path(lambda p, a: moments.__setitem__(
                        TS.path_str(p), (tuple(local_tensor(a).shape),
                                         tuple(a.shape))), state["opt"].m)
    finally:
        TST.adamw_update = real_update
        layers.ops.attention = real_attention
        layers.set_attention_mesh(None)
    return {"rank": mesh.rank, "transport": mesh.transport,
            "draw_s": draw_s, "steps": steps, "grad_err": errs,
            "whole_experts": {sp: {"loss": ce, "max": {
                k: float(g.float().abs().max()) for k, g in gr.items()}}
                for sp, (ce, gr) in whole_ref.items()},
            "whole_experts_s": whole_ref_s,
            "moments": moments, "own": log.own,
            "moments_plain_step": not is_dtensor(state["opt"].step),
            "inputs": {nm: tuple(t.cpu() if torch.is_tensor(t) else t
                                 for t in v) for nm, v in inputs.items()}}


def ep_same_choices(res: list, label: str) -> dict:
    """Every rank's own choices against rank 0's, bit for bit: (phase,
    layer) keys, calls and indices; gated."""
    import torch

    own = res[0]["own"]
    bad = [key for r in res[1:] for key in set(own) | set(r["own"])
           if len(own.get(key, [])) != len(r["own"].get(key, []))
           or not all(torch.equal(a, b) for a, b in zip(own[key],
                                                         r["own"][key]))]
    n = sum(len(v) for v in own.values())
    check(not bad, f"ep {label}: the ranks' own choices differ at {bad}")
    print(f"[ep] {label}: the {len(res)} ranks' own top-k choices equal bit "
          f"for bit in all {n} routing calls ({len(own)} phase x layer "
          f"keys)")
    return {"calls": n, "keys": len(own)}


def cells_rank(mesh, parts: list) -> list:
    """One rank of several cells on one mesh, one spawn: each (rank
    function, its arguments after the mesh) of ``parts`` in turn, the
    card's memory freed between them; → their results, each with its
    seconds (``part_s``)."""
    import gc

    import torch

    out = []
    for fn, args in parts:
        t0 = time.perf_counter()
        out.append(fn(mesh, *args))
        out[-1]["part_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def ep_serve_prepare(tmp: str) -> dict:
    """The ep phase's serving reference: the whole-model run of
    moonshot-v1-16b-a3b (4 layers), alone on the card, saved under
    ``tmp`` for the ranks; → what :func:`ep_serve_check` reads."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = ep_config(EP["layers"])
    B, T, n = EP["batch"], EP["prompt_len"], EP["decode"]
    m = EP["mesh"][1]
    print(f"[ep] {cfg.arch_id}: {cfg.n_layers} of 48 layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.hd} ({cfg.n_kv_heads} "
          f"kv heads), {cfg.n_experts} experts top {cfg.top_k}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype} (router f32); batch "
          f"{B} x {T} tokens, {n} decode steps; mesh (data, model) = "
          f"{EP['mesh']}: {cfg.n_experts // m} experts and "
          f"{cfg.n_heads // m} heads a rank")
    path = os.path.join(tmp, "serve.pt")
    ref = ep_serve_reference(cfg, path)
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase
    print(f"[ep] whole-model serving run: {ref['weights_gb']:.3f} GB of "
          f"weights; prefill step {ref['ms']['prefill_step_ms']:.3f} ms, "
          f"prefill into the cache {ref['ms']['prefill_cache_ms']:.3f} "
          f"ms, decode {statistics.median(ref['ms']['decode_ms']):.3f} ms "
          f"a step (median of {n}); {t_ref:.3f} s")
    return {"cfg": cfg, "path": path, "ref": ref, "t_ref": t_ref}


def ep_serve_check(prep: dict, res: list) -> tuple[dict, dict]:
    """moonshot-v1-16b-a3b served expert-parallel (4 layers) on 2 ranks
    sharing the card (``res``: each rank's :func:`ep_serve_rank`), held to
    the whole-model run on the same weights (:func:`ep_serve_prepare`)
    with its routing pinned."""
    import gc

    import torch

    from repro_torch.models import moe

    t0 = time.perf_counter()
    cfg, ref, t_ref = prep["cfg"], prep["ref"], prep["t_ref"]
    B, T, n = EP["batch"], EP["prompt_len"], EP["decode"]
    m = EP["mesh"][1]
    serve_s = max(r["part_s"] for r in res)
    out: dict = {}
    counts: dict = {}
    half = {"moe/wi": (cfg.n_layers, cfg.n_experts // m, cfg.d_model, 2,
                       cfg.d_ff),
            "moe/wo": (cfg.n_layers, cfg.n_experts // m, cfg.d_ff,
                       cfg.d_model),
            "moe/router": (cfg.n_layers, cfg.d_model, cfg.n_experts),
            "attn/wq": (cfg.n_layers, cfg.d_model, cfg.n_heads // m, cfg.hd),
            "embed": (cfg.vocab_padded // m, cfg.d_model),
            "cache_k": (cfg.n_layers, B, T + n, cfg.n_kv_heads // m, cfg.hd)}
    for r in res:
        k7 = r["launches"]["flash_attention"]
        c = r["collectives"]
        print(f"[ep] rank {r['rank']} over {r['transport']}: experts "
              f"{r['experts'].start}..{r['experts'].stop - 1}, local shapes "
              f"{r['shapes']}; peak {r['peak_gb']:.3f} GB; drawn and cut in "
              f"{r['draw_s']:.3f} s; K7 launches {k7} (routes "
              f"{r['routes']['flash_attention']}); prefill step "
              f"{r['ms']['prefill_step_ms']:.3f} ms, prefill into the cache "
              f"{r['ms']['prefill_cache_ms']:.3f} ms, decode "
              f"{statistics.median(r['ms']['decode_ms']):.3f} ms a step")
        print(f"[ep] rank {r['rank']} serving rerun with each collective "
              f"timed alone: {c['run_ms']:.3f} ms in all, "
              f"{c['collective_ms']:.3f} ms "
              f"({c['collective_ms'] / c['run_ms']:.3f} of it) in "
              f"{c['calls']} collectives ({c['bytes'] / 1e6:.3f} MB sent), "
              f"{c['sync_ms']:.3f} ms waiting for the card's queued "
              f"work before them")
        check(r["shapes"] == half, f"ep rank {r['rank']}: local shapes "
                                   f"{r['shapes']}, want {half}")
        check(k7 > 0 and r["routes"]["flash_attention"]["simt_f32"] == 0,
              f"ep rank {r['rank']}: K7 launches {r['routes']}")
        check(r["dropped"] == ref["dropped"],
              f"ep rank {r['rank']}: dropped_frac by phase {r['dropped']} "
              f"against the whole run's {ref['dropped']}")
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    print(f"[ep] dropped_frac of every moe call equals the whole run's on "
          f"both ranks (prefill layers {ref['dropped']['prefill']})")
    out["same_choices_serve"] = ep_same_choices(res, "serving (pinned runs "
                                                "and the unpinned prefill)")
    flips = sum(int((~same_set(calls[0], ref["own"][ph][layer])).sum())
                for (ph, layer), calls in res[0]["own"].items()
                if ph in ref["own"])
    print(f"[ep] tokens whose own top-k on rank 0 differ from the whole "
          f"run's (pinned to the whole run's; printed, not gated): {flips}")

    def share(got, want) -> float:
        want = want.float()
        return ((got.float() - want).abs().max()
                / (2e-2 * want.abs().max())).item()

    reads = {"prefill_logits": max(share(r["logits"], ref["logits"])
                                   for r in res),
             "decode_logits": max(share(g, w) for r in res
                                  for g, w in zip(r["decode"],
                                                  ref["decode"]))}
    by_step = [round(max(share(r["decode"][j], ref["decode"][j])
                         for r in res), 4) for j in range(n)]
    print(f"[ep] decode logits by step, share of the limit: {by_step}")
    for name in ("k", "v"):
        full = torch.zeros(ref["cache"][name].shape,
                           dtype=ref["cache"][name].dtype)
        for r in res:
            local, bounds = r["cache"][name]
            full[tuple(bounds)] = local
        reads[f"cache_{name}"] = share(full, ref["cache"][name])
        scale = 2e-2 * ref["cache"][name].float().abs().max()
        by_layer = [round(((full[i].float() - ref["cache"][name][i].float())
                           .abs().max() / scale).item(), 4)
                    for i in range(cfg.n_layers)]
        print(f"[ep] cache_{name} by layer, share of the whole cache's "
              f"limit: {by_layer}")
    # layer 0's moe output on each rank (and in the whole run) against
    # moe_ref under the pinned routing, from the whole weights of layer 0
    p0 = ref["moe0"]
    for name, x0 in ([(f"moe0_rank{r['rank']}", r["moe0"]) for r in res]
                     + [("moe0_whole", ref["moe0_io"])]):
        d = x0["x"].shape[-1]
        k = x0["idx"].shape[-1]
        want = moe.moe_ref(p0, x0["x"].to("cuda").reshape(-1, d),
                           *(x0[nm].to("cuda").reshape(-1, k)
                             for nm in ("idx", "gate", "keep")))
        reads[name] = share(x0["y"].to("cuda").reshape(-1, d), want)
    for k_, v in reads.items():
        print(f"[ep] {k_}: max |err| at {v:.4f} of 2e-2 * max|ref|")
    for k_, v in reads.items():
        check(v <= 1.0, f"ep {k_}: {v:.4f} of the limit")
    out["serve"] = {"reads_share_of_limit": reads, "whole_ms": ref["ms"],
                    "dropped": ref["dropped"], "own_flips": flips,
                    "ranks": [{k_: r[k_] for k_ in (
                        "rank", "transport", "shapes", "ms", "draw_s",
                        "peak_gb", "launches", "collectives")} for r in res],
                    "ranks_s": serve_s, "weights_gb": ref["weights_gb"]}
    # K7 on the q/k/v each rank's first layer gave it
    k7: dict = {}
    for r in res:
        q, k_, v, w = (t.to("cuda") if torch.is_tensor(t) else t
                       for t in r["k7_inputs"]["ep"])
        want = (B, T, cfg.n_heads // m, cfg.hd)
        check(tuple(q.shape) == want and k_.shape == v.shape == q.shape
              and q.dtype == torch.bfloat16,
              f"ep rank {r['rank']} K7: q {tuple(q.shape)} {q.dtype}; want "
              f"{want} bf16")
        if r["rank"] == 0:
            k7["ep"] = k7_at(q, k_, v, w, "ep", tag="[ep]")
        else:
            d_, worst = flash_err(q, k_, v, True, w)
            print(f"[ep] rank {r['rank']} K7 at {list(q.shape)} bf16: max "
                  f"abs err {d_}, {worst} of the element-wise limit")
            k7[f"ep rank {r['rank']}"] = {"max_abs_err": d_,
                                          "err_of_elementwise_limit": worst}
        del q, k_, v
    out["k7"] = k7
    out["serve"]["serve_s"] = t_ref + serve_s + time.perf_counter() - t0
    print(f"[ep] serving {out['serve']['serve_s']:.3f} s: whole run "
          f"{t_ref:.3f} s, ranks {serve_s:.3f} s")
    del res, ref, p0
    gc.collect()
    torch.cuda.empty_cache()
    return counts, out


def ep_train_prepare(tmp: str) -> dict:
    """The ep phase's training reference: the whole-model step of
    moonshot-v1-16b-a3b (2 layers) with its controls, saved under ``tmp``
    for the ranks; → what :func:`ep_train_check` reads."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tcfg = ep_train_config()
    path = os.path.join(tmp, "train.pt")
    tref = ep_train_reference(path)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[ep] whole-model training run ({tcfg.n_layers} layers, "
          f"{EP['train_batch']} x {EP['train_seq']} tokens, loss chunk "
          f"{EP['loss_chunk']}): {tref['weights_gb']:.3f} GB of weights; "
          f"loss {tref['loss']} grad_norm {tref['grad_norm']} "
          f"dropped_frac {tref['dropped_frac']}; loss and gradients "
          f"{tref['step_ms']:.3f} ms")
    return {"cfg": tcfg, "path": path, "ref": tref,
            "t_ref": time.perf_counter() - t0}


def ep_train_check(prep: dict, res: list) -> tuple[dict, dict]:
    """moonshot-v1-16b-a3b trained expert-parallel (2 layers) on 2 ranks
    sharing the card (``res``: each rank's :func:`ep_train_rank`), held
    to the whole-model step (:func:`ep_train_prepare`) with its routing
    pinned."""
    import gc

    import torch

    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.optim import adamw_init

    m = EP["mesh"][1]
    counts: dict = {}
    tcfg, tref = prep["cfg"], prep["ref"]
    S = EP["train_seq"]
    t_train = time.perf_counter()
    train_s = max(r["part_s"] for r in res)
    layout = MeshLayout(EP["mesh"], ("data", "model"))
    abstract = TST.abstract_params(tcfg)
    specs = {}
    TS.map_with_path(lambda p, sh: specs.__setitem__(TS.path_str(p),
                                                     sh.spec),
                     TS.opt_shardings(layout, adamw_init(abstract),
                                      abstract).m)
    L = tcfg.n_layers
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L}
    for r in res:
        for i, st in enumerate(r["steps"]):
            c = st["collectives"]
            print(f"[ep] rank {r['rank']} train step {i + 1} seq_parallel "
                  f"{st['seq_parallel']}: loss {st['loss']} grad_norm "
                  f"{st['grad_norm']} dropped_frac {st['dropped_frac']}; "
                  f"{st['ms']:.3f} ms, peak {st['peak_gb']:.3f} GB; launches "
                  f"{st['launches']} (routes {st['routes']}); "
                  f"{c['collective_ms']:.3f} ms "
                  f"({c['collective_ms'] / st['ms']:.3f} of the step) in "
                  f"{c['calls']} collectives ({c['bytes'] / 1e6:.3f} MB), "
                  f"by pass {c['by_pass']}, "
                  f"{c['sync_ms']:.3f} ms waiting for the card's queued work "
                  f"before them")
            check(st["launches"] == per_step,
                  f"ep rank {r['rank']} step {i + 1}: launches "
                  f"{st['launches']}, expected {per_step}")
            check(all(st["routes"][k] == {"wgmma_bf16": v, "simt_f32": 0}
                      for k, v in per_step.items()),
                  f"ep rank {r['rank']} step {i + 1}: routes {st['routes']}")
            check(c["by_pass"].get("backward", {}).get("calls", 0) > 0,
                  f"ep rank {r['rank']} step {i + 1}: no collective in the "
                  f"backward pass ({c['calls']})")
            for k, v in st["launches"].items():
                counts[k] = counts.get(k, 0) + v
        bad = {k: v for k, v in r["moments"].items()
               if v[0] != TS.local_shape(layout, specs[k], v[1])}
        check(not bad and r["moments_plain_step"],
              f"ep rank {r['rank']}: moments' local shapes off their "
              f"opt_shardings specs: {bad}")
        mw = r["moments"]["layers/moe/wi"][0]
        check(mw == (L, tcfg.n_experts // m, tcfg.d_model, 2, tcfg.d_ff),
              f"ep rank {r['rank']}: moe/wi moments {mw}")
        print(f"[ep] rank {r['rank']}: drawn and cut in {r['draw_s']:.3f} s; "
              f"every moment's local shape is its opt_shardings spec's "
              f"(moe/wi {mw}, moe/wo {r['moments']['layers/moe/wo'][0]}, "
              f"router {r['moments']['layers/moe/router'][0]})")
    same = ep_same_choices(
        res, "training (steps 1 and 3 pinned, step 2 routed by the ranks)")
    treads = {}
    for i in range(3):
        norms = {r["steps"][i]["grad_norm"] for r in res}
        check(len(norms) == 1, f"ep step {i + 1}: grad_norm differs between "
                               f"the ranks: {norms}")
    for r in res:
        print(f"[ep] rank {r['rank']} reference with the experts whole on "
              f"every rank (attention, ff and vocab split as in the steps): "
              f"{r['whole_experts_s']:.3f} s; its loss with / without "
              f"seq_parallel {r['whole_experts'][True]['loss']} / "
              f"{r['whole_experts'][False]['loss']}, the expert-parallel "
              f"steps' {r['steps'][0]['loss']} / {r['steps'][2]['loss']}")
    shares: dict = {}
    for i, sp in ((0, True), (2, False)):      # from the same start, pinned
        st = res[0]["steps"][i]
        treads[f"step{i + 1}_loss_rel"] = (abs(st["loss"] - tref["loss"])
                                           / abs(tref["loss"]))
        treads[f"step{i + 1}_grad_norm_rel"] = (
            abs(st["grad_norm"] - tref["grad_norm"]) / tref["grad_norm"])
        treads[f"step{i + 1}_loss_equal_whole_experts"] = all(
            r["steps"][i]["loss"] == r["whole_experts"][sp]["loss"]
            for r in res)
        check(treads[f"step{i + 1}_loss_rel"] <= 1e-3
              and treads[f"step{i + 1}_grad_norm_rel"] <= 1e-2
              and st["dropped_frac"] == tref["dropped_frac"],
              f"ep step {i + 1}: loss {st['loss']} grad_norm "
              f"{st['grad_norm']} dropped_frac {st['dropped_frac']} against "
              f"the whole run's {tref['loss']} {tref['grad_norm']} "
              f"{tref['dropped_frac']}")
        worst_at, plain_at, own_at, ctl_at = {}, {}, {}, {}
        errs = [r["grad_err"][0 if i == 0 else 1] for r in res]
        for k in tref["max_plain"]:
            got = [e[k] for e in errs if k in e]
            check(len(got) >= 1, f"ep: no rank checked {k}")
            ref_max = max(r["whole_experts"][sp]["max"][k] for r in res
                          if k in r["whole_experts"][sp]["max"])
            worst_at[k] = max(got) / (2e-2 * ref_max)
            scale = 2e-2 * tref["max_plain"][k]
            plain_at[k] = max(e[f"{k} plain"] for e in errs if k in e) / scale
            # the control: the plain bf16 run's own distance to the f32
            # run (a share of the limit), and the ranks' distance to the
            # f32 run over that own distance
            own = tref["own_f32"][k]
            own_at[k] = own / scale
            ctl_at[k] = (max(e[f"{k} f32"] for e in errs if k in e)
                         / max(own, 1e-30))
        label = "seq_parallel" if sp else "no seq_parallel"
        for k, v in sorted(worst_at.items()):
            print(f"[ep] {label} gradient {k}: max |g - g_ref| at {v:.4f} of "
                  f"2e-2 * max|g_ref| (g_ref the same ranks' step with the "
                  f"experts whole); against the plain whole run "
                  f"{plain_at[k]:.4f} of 2e-2 * max|g_plain| "
                  f"({tref['max_plain'][k]:.6g}; printed, not gated); the "
                  f"plain bf16 run's own distance to the f32 run "
                  f"{own_at[k]:.4f} of that limit, the ranks' distance to "
                  f"the f32 run {ctl_at[k]:.4f} x the plain run's own "
                  f"(the f32 control, printed)")
        treads[f"step{i + 1}_grad_share_of_limit"] = max(worst_at.values())
        treads[f"step{i + 1}_grad_share_plain"] = max(plain_at.values())
        treads[f"step{i + 1}_grad_own_share_f32"] = own_at
        treads[f"step{i + 1}_grad_f32_control"] = ctl_at
        shares[label] = worst_at
    for label, worst_at in shares.items():
        check(max(worst_at.values()) <= 1.0,
              f"ep {label}: a gradient is off by {max(worst_at.values())} of "
              f"its limit ({worst_at})")
    falls = [r["steps"][1]["loss"] < r["steps"][0]["loss"] for r in res]
    print(f"[ep] loss step 1 -> 2 (seq_parallel, the same batch): "
          f"{res[0]['steps'][0]['loss']} -> {res[0]['steps'][1]['loss']}")
    check(all(falls), "ep: the loss did not fall from step 1 to 2")
    # K8 and K9 at each rank's own q, k, v and dO of layer 0
    bwd: dict = {}
    for r in res:
        check(set(r["inputs"]) == {"ep_train"}
              and r["inputs"]["ep_train"][3] is not None,
              f"ep rank {r['rank']}: attention inputs {set(r['inputs'])}")
        q, k_, v, do, w = (t.to("cuda") if torch.is_tensor(t) else t
                           for t in r["inputs"]["ep_train"])
        want = (EP["train_batch"], S, tcfg.n_heads // m, tcfg.hd)
        check(tuple(q.shape) == want and k_.shape == v.shape == q.shape
              == do.shape and q.dtype == torch.bfloat16,
              f"ep rank {r['rank']}: q {tuple(q.shape)} {q.dtype}, dO "
              f"{tuple(do.shape)}; want {want} bf16")
        if r["rank"] == 0:
            bwd["ep_train"] = k8_k9_at(q, k_, v, do, w, "ep_train",
                                       tag="[ep]")
        else:
            e = flash_bwd_err(q, k_, v, do, True, w)
            print(f"[ep] rank {r['rank']} K8/K9 at {list(q.shape)} bf16: {e}")
            bwd[f"ep_train rank {r['rank']}"] = e
        del q, k_, v, do
    out = {"reference": {k: v for k, v in tref.items()
                         if k != "max_plain"},
           "reads": treads, "k8_k9": bwd, "same_choices": same,
           "ranks": [{"rank": r["rank"], "draw_s": r["draw_s"],
                      "steps": r["steps"]} for r in res],
           "ranks_s": train_s,
           "train_s": prep["t_ref"] + train_s + time.perf_counter() - t_train}
    print(f"[ep] training {out['train_s']:.3f} s: whole run "
          f"{prep['t_ref']:.3f} s, ranks {train_s:.3f} s")
    del res
    gc.collect()
    return counts, out


def phase_tp_cells() -> tuple[tuple, tuple, tuple]:
    """Cells 12, 13 and 14 on one spawn of the (data 1, model 2) mesh:
    gemma3-12b served (:func:`tp_rank`) and trained (:func:`tp_train_rank`)
    tensor-parallel, moonshot-v1-16b-a3b served and trained
    expert-parallel (:func:`ep_serve_rank`, :func:`ep_train_rank`); every
    whole-model reference first, alone on the card, then the ranks
    (:func:`cells_rank`), then each cell's checks; → ((launches, numbers)
    of cell 12, of 13, of 14)."""
    import tempfile

    from repro_torch.launch.mesh import run_on_local_mesh

    t_phase = time.perf_counter()
    check(TP["mesh"] == TP_TRAIN["mesh"] == EP["mesh"],
          "cells 12-14 share one mesh")
    with tempfile.TemporaryDirectory(prefix="tp_cells_") as tmp:
        tp, tt = tp_prepare(), tp_train_prepare(tmp)
        serve, train = ep_serve_prepare(tmp), ep_train_prepare(tmp)
        t1 = time.perf_counter()
        res = run_on_local_mesh(
            TP["mesh"], ("data", "model"), cells_rank,
            [(tp_rank, (tp["ids"], tp["tokens"])),
             (tp_train_rank, (tt["path"],)),
             (ep_serve_rank, (serve["cfg"], serve["path"])),
             (ep_train_rank, (train["cfg"], train["path"]))],
            device="cuda", timeout=max(TP["timeout"], TP_TRAIN["timeout"],
                                       EP["timeout"]))
        ranks_s = time.perf_counter() - t1
    cells = (tp_check(tp, [r[0] for r in res]),
             tp_train_check(tt, [r[1] for r in res]))
    counts, out = ep_serve_check(serve, [r[2] for r in res])
    tcounts, out["train"] = ep_train_check(train, [r[3] for r in res])
    del res
    for k, v in tcounts.items():
        counts[k] = counts.get(k, 0) + v
    out["phase_s"] = out["serve"]["serve_s"] + out["train"]["train_s"]
    print(f"[ep] cell {out['phase_s']:.3f} s (budget 90): serving "
          f"{out['serve']['serve_s']:.3f} s, training "
          f"{out['train']['train_s']:.3f} s; K7/K8/K9 launches on the ranks "
          f"{counts}")
    print(f"[tp] [tp_train] [ep] cells 12-14, one spawn: "
          f"{time.perf_counter() - t_phase:.3f} s, the ranks {ranks_s:.3f} s")
    for o in (cells[0][1], cells[1][1], out):
        o["spawn_s"] = ranks_s
    return cells[0], cells[1], (counts, out)


# --------------------------------------------------------------------------- #
# 15. the hybrid and ssm families under a model axis: hymba-1.5b and
# rwkv6-1.6b served and trained on 2 ranks
# --------------------------------------------------------------------------- #
def tpr_settings(arch: str) -> dict:
    """The phase settings that serve and train ``arch`` on the ranks:
    TP_VLM's for the vlm family, TP_RECURRENT's for the others."""
    return TP_VLM if arch in TP_VLM["archs"] else TP_RECURRENT


def tpr_config(arch: str, layers: int):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    if cfg.rwkv:
        check(cfg.d_model == 2048 and cfg.d_ff == 7168 and cfg.vocab == 65536
              and cfg.dtype == "bfloat16", f"unexpected rwkv config {cfg}")
    elif cfg.cross_attn_every:
        check(cfg.d_model == 4096 and cfg.n_heads == 32
              and cfg.n_kv_heads == 8 and cfg.hd == 128 and cfg.d_ff == 14336
              and cfg.vocab == 128256 and cfg.cross_attn_every == 5
              and cfg.n_img_tokens == 1601 and cfg.dtype == "bfloat16",
              f"unexpected vlm config {cfg}")
    else:
        check(cfg.d_model == 1600 and cfg.n_heads == 25
              and cfg.n_kv_heads == 5 and cfg.hd == 64 and cfg.d_ff == 5504
              and cfg.window == 1024 and cfg.ssm_state == 16
              and cfg.dtype == "bfloat16", f"unexpected hymba config {cfg}")
    return cfg


def tpr_draw(cfg, device: str = "cuda") -> dict:
    """The whole weights from the phase's seed, with the leaves
    ``ssm_init`` / ``rwkv_init`` set to zeros or ones drawn
    (:func:`draw_state_leaves`); any rank draws the same alone."""
    import torch

    from repro_torch.models import LM

    g = torch.Generator(device).manual_seed(tpr_settings(cfg.arch_id)["seed"])
    params = LM(cfg).init(g)
    if cfg.rwkv or cfg.hybrid:
        blk = "rwkv" if cfg.rwkv else "ssm"
        params["layers"][blk] = draw_state_leaves(params["layers"][blk], g)
    return params


def tpr_inputs(cfg, device: str = "cuda") -> tuple:
    """The served prompts [B, T], the image embeddings they are served
    against (a vlm config's, [B, M, d] in its dtype; else None) and the
    training batch (a vlm config's with image embeddings of its own), from
    the seed."""
    import torch

    s = tpr_settings(cfg.arch_id)
    g = torch.Generator(device).manual_seed(s["seed"] + 1)
    ids = torch.randint(0, cfg.vocab, (s["batch"], s["prompt_len"]),
                        generator=g, device=device)
    shape = (s["train_batch"], s["train_seq"])
    batch = {"ids": torch.randint(0, cfg.vocab, shape, generator=g,
                                  device=device),
             "labels": torch.randint(0, cfg.vocab, shape, generator=g,
                                     device=device),
             "mask": torch.ones(shape, device=device)}
    img = None
    if cfg.cross_attn_every:
        img, batch["img_embeds"] = (torch.randn(
            (n, cfg.n_img_tokens, cfg.d_model), generator=g,
            device=device).to(torch.bfloat16)
            for n in (s["batch"], s["train_batch"]))
    return ids, img, batch


def tpr_leaves(tree) -> dict:
    """path → (this rank's local tensor, its bounds) of every leaf (a plain
    leaf whole)."""
    from repro_torch.core.spmd_pipeline import local_bounds, local_tensor
    from repro_torch.launch import sharding as TS

    out = {}
    TS.map_with_path(lambda p, a: out.__setitem__(
        TS.path_str(p), (local_tensor(a), local_bounds(a))), tree)
    return out


def tpr_by_layer(path: str, diff) -> list:
    """max |diff| of each layer of a leaf stacked over the layers (its
    path under ``layers/``, or a vlm model's ``cross/``: a group each),
    else of the whole leaf, as a list."""
    d = diff.abs()
    if path.startswith(("layers/", "cross/")):
        return d.flatten(1).amax(1).tolist()
    return [float(d.max())]


def tpr_reference(arch: str, path: str) -> dict:
    """The whole-model runs of one arch on plain tensors in this process:
    serving (the prefill step's logits, ``LM.prefill``, greedy decode, the
    cache after it, all on the host) and step 1's loss, grad_norm and
    gradients at the training depth, the gradients saved to ``path`` for
    the ranks (each reads its shards' bounds); and the controls: the same
    weights served in f32, fed the same tokens, and, for an arch with
    CONTROLLED reads, the same training step in f32, its gradients
    saved beside the bf16 ones (``own_f32`` None without it)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM
    from repro_torch.optim import global_norm

    s = tpr_settings(arch)
    cfg = tpr_config(arch, s["layers"][arch])
    model = LM(cfg)
    params = tpr_draw(cfg)
    ids, img, _ = tpr_inputs(cfg)
    cache = model.init_cache(s["batch"], s["prompt_len"] + s["decode"],
                             device="cuda")
    _, prefill = TST.make_prefill_step(cfg)
    _, decode = TST.make_decode_step(cfg)
    logits, dec, tokens, ms = tp_serve(model, params, cache, ids, prefill,
                                       decode, steps=s["decode"], img=img)
    out = {"logits": logits, "decode": dec, "tokens": tokens, "ms": ms,
           "cache": {k: v.cpu() for k, (v, _) in tpr_leaves(cache).items()},
           "weights_gb": sum(a.numel() * a.element_size()
                             for a in leaves(params)) / 1e9}
    # the control: the same weights served in f32, fed the same tokens
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    del params, cache
    m32 = LM(c32)
    cache = m32.init_cache(s["batch"], s["prompt_len"] + s["decode"],
                           device="cuda")
    lg32, dec32, _, _ = tp_serve(m32, p32, cache, ids,
                                 TST.make_prefill_step(c32)[1],
                                 TST.make_decode_step(c32)[1], tokens,
                                 steps=s["decode"],
                                 img=None if img is None else img.float())
    out["f32"] = {"logits": lg32, "decode": dec32, "cache": {
        k: v.cpu() for k, (v, _) in tpr_leaves(cache).items()}}
    del p32, cache
    gc.collect()

    cfg = tpr_config(arch, s["train_layers"])
    model = LM(cfg)
    params = tpr_draw(cfg)
    _, _, batch = tpr_inputs(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ce, grads, _ = TST.loss_and_grads(model, params, batch,
                                      loss_chunk=s["loss_chunk"])
    gnorm = float(global_norm(grads))
    torch.cuda.synchronize()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    tree = unflatten(flatten(params)[1], grads)
    checked = {k: g.cpu() for k, (g, _) in tpr_leaves(tree).items()}
    torch.save(checked, path)
    out.update(loss=float(ce), grad_norm=gnorm,
               max_ref={k: float(g.float().abs().max())
                        for k, g in checked.items()})
    del grads, tree
    out.update(f32_loss=None, own_f32=None)
    if not CONTROLLED.get(arch):
        del params, checked
        gc.collect()
        torch.cuda.empty_cache()
        return out
    # the control: the same step in f32; its gradients saved beside
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda a: a.float(), params)
    del params
    gc.collect()
    b32 = {k: v.float() if k == "img_embeds" else v
           for k, v in batch.items()}
    ce32, grads, _ = TST.loss_and_grads(LM(c32), p32, b32,
                                        loss_chunk=s["loss_chunk"])
    tree = unflatten(flatten(p32)[1], grads)
    f32 = {k: g.cpu() for k, (g, _) in tpr_leaves(tree).items()}
    torch.save(f32, path + ".f32")
    out.update(f32_loss=float(ce32), own_f32={
        k: tpr_by_layer(k, checked[k].float() - g) for k, g in f32.items()})
    del p32, grads, tree, checked, f32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tpr_serve_rank(mesh, arch: str, tokens) -> dict:
    """One rank's serving of ``arch``: draw the whole weights and keep its
    shards, serve teacher-forced with the whole run's ``tokens``, rerun
    with the collectives timed alone, then ``LM.apply`` over the prompt
    and the fed tokens (the decode's rerun); its logits, cache shards and
    local shapes, and the q/k/v its first layer gave K7."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST

    s = tpr_settings(arch)
    cfg = tpr_config(arch, s["layers"][arch])
    params = TS.distribute_params(mesh, tpr_draw(cfg, mesh.device))
    torch.cuda.empty_cache()
    ids, img, _ = tpr_inputs(cfg, mesh.device)
    new_cache = functools.partial(TST.init_cache_sharded, cfg, mesh,
                                  s["batch"], s["prompt_len"] + s["decode"])
    cache = new_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    keep = {}
    model, prefill = TST.make_prefill_step(cfg, mesh)
    _, decode = TST.make_decode_step(cfg, mesh)
    with attention_spy(keep=keep):
        logits, dec, _, ms = tp_serve(model, params, cache, ids, prefill,
                                      decode, tokens, steps=s["decode"],
                                      img=img)
    launches = dict(fa.LAUNCHES)
    routes = {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()}
    coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {}, "bytes": 0}
    cache2 = new_cache()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with timed_collectives(coll):
        tp_serve(model, params, cache2, ids, prefill, decode, tokens,
                 steps=s["decode"], img=img)
    coll["run_ms"] = 1e3 * (time.perf_counter() - t1)
    del cache2
    full = torch.cat([ids, tokens.to(ids.device)], dim=1)
    with torch.no_grad():                 # the decode's rerun
        h, _ = model.apply(params, full, remat=False, img_embeds=img)
        rerun = model.logits(params, h[:, s["prompt_len"]:])
    got = torch.cat(dec, dim=1).to(rerun.device)
    rerun_err = ((got.float() - rerun.float()).abs().max()
                 / rerun.float().abs().max()).item()
    names = (("rwkv/wr", "rwkv/wo", "rwkv/ck") if cfg.rwkv
             else ("attn/wq", "attn/wk", "mlp/wi") if cfg.cross_attn_every
             else ("ssm/in_proj", "attn/wq", "attn/wo"))
    pl = tpr_leaves(params)
    shapes = {f"layers/{n}": tuple(pl[f"layers/{n}"][0].shape)
              for n in names}
    if cfg.cross_attn_every:
        for n in ("cross/attn/wk", "cross/attn/wo"):
            shapes[n] = tuple(pl[n][0].shape)
    shapes["embed"] = tuple(pl["embed/table"][0].shape)
    cache_shards = {k: (v.cpu(), b) for k, (v, b) in
                    tpr_leaves(cache).items()}
    return {"shapes": shapes,
            "cache_shapes": {k: tuple(v.shape)
                             for k, (v, _) in cache_shards.items()},
            "logits": logits, "decode": dec, "ms": ms, "collectives": coll,
            "rerun_err": rerun_err, "cache": cache_shards,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "routes": routes,
            "k7_inputs": {n: (*(t.cpu() for t in qkv), w)
                          for n, (*qkv, w) in keep.items()}}


def tpr_train_rank(mesh, arch: str, ref_path: str) -> dict:
    """One rank's training of ``arch`` at its training depth: draw the
    whole weights
    and keep its shards (``init_train_state_sharded``), two
    ``make_train_step`` steps with seq_parallel, then one without it from
    the same start, each under :func:`timed_collectives`; the gradients
    of steps 1 and 3 held, before AdamW clips them, to the whole run's at
    this rank's bounds (``max |g - g_ref|`` a layer, and the same against
    the whole f32 step's, the control); a digest of every leaf
    the ranks hold whole after steps 2 and 3; the q, k, v and dO of the
    first self-attention in step 1 (K7's inputs, K8's and K9's output
    gradient), and of the first cross-attention (a vlm model's)."""
    import hashlib

    import torch

    from repro_torch.core.spmd_pipeline import local_tensor, sharded_dims
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.models import layers
    from repro_torch.optim import adamw_init

    s = tpr_settings(arch)
    cfg = tpr_config(arch, s["train_layers"])
    state = TST.init_train_state_sharded(cfg, mesh,
                                         tpr_draw(cfg, mesh.device))
    start = [local_tensor(a).clone() for a in leaves(state["params"])]
    torch.cuda.empty_cache()
    _, _, batch = tpr_inputs(cfg, mesh.device)
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    ref32 = (torch.load(ref_path + ".f32", mmap=True, map_location="cpu")
             if os.path.exists(ref_path + ".f32") else None)
    steps, errs, inputs, digests = [], [], {}, []
    real_update = TST.adamw_update

    def spy(grads, st, params, **kw):
        t1 = time.perf_counter()
        if plan[len(steps)][1]:
            e = {}
            for k, (g, at) in tpr_leaves(grads).items():
                e[k] = tuple(tpr_by_layer(k, g.float() - r[k][at].to(
                    g.device).float()) if r is not None else None
                             for r in (ref, ref32))
            errs.append(e)
            torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t1
        return real_update(grads, st, params, **kw)

    def keep_attention(q, k, v, causal=True, window=0):
        o = real_attention(q, k, v, causal, window)
        name = "train" if causal else "train cross"
        if name not in inputs and torch.is_grad_enabled():
            inputs[name] = [t.detach().clone() for t in (q, k, v)] + [
                None, int(window)]
            o.register_hook(lambda g: inputs[name].__setitem__(
                3, g.detach().clone()))
        return o

    def whole_digest() -> dict:
        """path → sha256 of each leaf the ranks hold whole."""
        out = {}

        def take(path, a):
            if not sharded_dims(a):
                t = local_tensor(a).detach().contiguous().cpu()
                out[TS.path_str(path)] = hashlib.sha256(
                    t.view(torch.uint8).numpy().tobytes()).hexdigest()

        TS.map_with_path(take, state["params"])
        return out
    # (seq_parallel, compare the gradients) of each step
    plan = [(True, True), (True, False), (False, True)]
    real_attention = layers.ops.attention
    TST.adamw_update = spy
    try:
        for i, (sp, _) in enumerate(plan):
            if i == 2:                    # the same start, no moments yet
                for a, s0 in zip(leaves(state["params"]), start):
                    local_tensor(a).copy_(s0)
                state = {"params": state["params"],
                         "opt": adamw_init(state["params"])}
            _, step = TST.make_train_step(
                cfg, mesh, seq_parallel=sp, lr=s["lr"], warmup=1,
                total_steps=10, loss_chunk=s["loss_chunk"])
            layers.ops.attention = (keep_attention if i == 0
                                    else real_attention)
            coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                    "bytes": 0}
            spent = [0.0]
            fa.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with timed_collectives(coll):
                state, met = step(state, batch)
                loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            ms = 1e3 * (time.perf_counter() - t1 - spent[0])
            steps.append({
                "seq_parallel": sp, "loss": loss, "grad_norm": gnorm,
                "ms": ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": dict(fa.LAUNCHES),
                "routes": {k: dict(v) for k, v in
                           fa.ROUTE_LAUNCHES.items()},
                "collectives": coll})
            if i:
                digests.append(whole_digest())
    finally:
        TST.adamw_update = real_update
        layers.ops.attention = real_attention
    return {"steps": steps, "grad_err": errs, "whole_digests": digests,
            "inputs": {n: tuple(t.cpu() if torch.is_tensor(t) else t
                                for t in v) for n, v in inputs.items()}}


def tpr_rank(mesh, jobs: dict) -> dict:
    """One rank of the tp_recurrent phase: for each arch of ``jobs`` (arch
    → (the whole run's decode tokens, the path of its saved gradients)),
    serving (:func:`tpr_serve_rank`) then training
    (:func:`tpr_train_rank`)."""
    import gc

    import torch

    from repro_torch.models import layers

    t0 = time.perf_counter()
    mesh.device_mesh                      # the DeviceMesh and its groups
    out = {"rank": mesh.rank, "transport": mesh.transport,
           "mesh_s": time.perf_counter() - t0}
    try:
        for arch, (tokens, ref_path) in jobs.items():
            t0 = time.perf_counter()
            out[arch] = {"serve": tpr_serve_rank(mesh, arch, tokens)}
            gc.collect()
            torch.cuda.empty_cache()
            out[arch]["serve_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out[arch]["train"] = tpr_train_rank(mesh, arch, ref_path)
            gc.collect()
            torch.cuda.empty_cache()
            out[arch]["train_s"] = time.perf_counter() - t0
    finally:
        layers.set_attention_mesh(None)
    return out


def tpr_share(got, want) -> float:
    """max |got - want| as a share of 2e-2 * max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / (2e-2 * want.abs().max())).item()


def layer_controls(got, whole, w32) -> list:
    """Each layer's (share, f32 control, own share) of a cache leaf [L,
    ...] (a vlm leaf's [G, ...]: a group's): ``got``'s distance to the
    whole bf16 run's ``whole`` as a share of 2e-2 * max |whole|, its
    distance to the f32 run's ``w32`` over the whole run's own, and that
    own distance as a share of the limit."""
    got, whole, w32 = (t.float() for t in (got, whole, w32))
    scale, by = 2e-2 * whole.abs().max(), []
    for i in range(whole.shape[0]):
        own = (whole[i] - w32[i]).abs().max()
        by.append((((got[i] - whole[i]).abs().max() / scale).item(),
                   ((got[i] - w32[i]).abs().max()
                    / own.clamp_min(1e-30)).item(),
                   (own / scale).item()))
    return by


def tpr_check_serve(arch: str, ref: dict, res: list) -> tuple[dict, dict]:
    """The serving gates of one arch over the ranks' results: local shapes,
    K7 launches (hymba), the prefill and decode logits and every cache
    leaf reassembled within 2e-2 of max |ref| of the whole run, each
    layer of a CONTROLLED leaf also passing within ``control_limit``
    times the whole bf16 run's own distance to the f32 run on the same
    weights and tokens (each layer's two reads printed); the decode
    within 2.5e-2 of its rerun; every read printed before the gates
    fail; → (K7 launches, reads)."""
    import torch

    s = tpr_settings(arch)
    cfg = tpr_config(arch, s["layers"][arch])
    m = s["mesh"][1]
    B, M = s["batch"], s["prompt_len"] + s["decode"]
    d, L = cfg.d_model, cfg.n_layers
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.rwkv:
        want = {"layers/rwkv/wr": (L, d, d // m),
                "layers/rwkv/wo": (L, d // m, d),
                "layers/rwkv/ck": (L, d, cfg.d_ff // m),
                "S": (L, B, d // 64, 64, 64 // m),
                "tm_last": (L, B, d // m), "cm_last": (L, B, d // m)}
    elif cfg.cross_attn_every:
        # the heads, kv heads and ff columns split; the caches keep every
        # kv head at the rank's half of head_dim (the JAX layout)
        G, per = L // cfg.cross_attn_every, cfg.cross_attn_every - 1
        want = {"layers/attn/wq": (G, per, d, H // m, hd),
                "layers/attn/wk": (G, per, d, KV // m, hd),
                "layers/mlp/wi": (G, per, d, 2, cfg.d_ff // m),
                "cross/attn/wk": (G, d, KV // m, hd),
                "cross/attn/wo": (G, H * hd // m, d),
                "self/k": (G, per, B, M, KV, hd // m),
                "self/v": (G, per, B, M, KV, hd // m),
                "cross/ck": (G, B, cfg.n_img_tokens, KV, hd // m),
                "cross/cv": (G, B, cfg.n_img_tokens, KV, hd // m)}
    else:
        want = {"layers/ssm/in_proj": (L, d, 2, d // m),
                "layers/attn/wq": (L, d, H, hd),
                "layers/attn/wo": (L, H * hd // m, d),
                "ssm/h": (L, B, d // m, cfg.ssm_state),
                "ssm/conv": (L, B, cfg.conv_kernel - 1, d // m),
                "k": (L, B, M, KV, hd // m)}
    want["embed"] = (cfg.vocab_padded // m, d)
    counts: dict = {}
    tag = f"[{s['tag']}] {arch}"
    for r in res:
        sv = r[arch]["serve"]
        got = {**sv["shapes"], **sv["cache_shapes"]}
        check(all(got[k] == v for k, v in want.items()),
              f"{tag} rank {r['rank']}: local shapes "
              f"{ {k: got[k] for k in want} }, want {want}")
        k7 = sv["launches"]["flash_attention"]
        check(k7 == (0 if cfg.rwkv else 2 * L)
              and sv["routes"]["flash_attention"]["simt_f32"] == 0,
              f"{tag} rank {r['rank']}: K7 launches {sv['routes']}")
        c = sv["collectives"]
        print(f"{tag} rank {r['rank']}: local shapes "
              f"{ {k: got[k] for k in want} }; peak {sv['peak_gb']:.3f} GB; "
              f"K7 launches {k7} ({sv['routes']['flash_attention']}); "
              f"prefill step {sv['ms']['prefill_step_ms']:.3f} ms, prefill "
              f"into the cache {sv['ms']['prefill_cache_ms']:.3f} ms, decode "
              f"{statistics.median(sv['ms']['decode_ms']):.3f} ms a step "
              f"(median of {s['decode']}); rerun with each collective timed "
              f"alone: {c['run_ms']:.3f} ms, {c['collective_ms']:.3f} ms in "
              f"{c['calls']} collectives ({c['bytes'] / 1e6:.3f} MB), "
              f"{c['sync_ms']:.3f} ms waiting for the card's queued work")
        check(c["calls"].get("reduce_over_ranks forward", 0) > 0,
              f"{tag} rank {r['rank']}: the rerun timed no collective")
        for k, v in sv["launches"].items():
            counts[k] = counts.get(k, 0) + v
    f32 = ref["f32"]
    got = {"prefill_logits": [r[arch]["serve"]["logits"] for r in res],
           "decode_logits": [torch.cat(r[arch]["serve"]["decode"], 1)
                             for r in res]}
    want = {"prefill_logits": (ref["logits"], f32["logits"]),
            "decode_logits": (torch.cat(ref["decode"], 1),
                              torch.cat(f32["decode"], 1))}
    for name, whole in ref["cache"].items():
        full = torch.zeros(whole.shape, dtype=whole.dtype)
        for r in res:
            local, bounds = r[arch]["serve"]["cache"][name]
            full[tuple(bounds)] = local
        got[f"cache_{name}"] = [full]
        want[f"cache_{name}"] = (whole, f32["cache"][name])
    ctl, lim = CONTROLLED.get(arch, ()), s["control_limit"]
    reads, controls, fails = {}, {}, []
    for k, outs in got.items():
        whole, w32 = (t.float() for t in want[k])
        reads[k] = max(tpr_share(g, whole) for g in outs)
        line = f"{tag} {k}: max |err| at {reads[k]:.4f} of 2e-2 * max|ref|"
        ok = reads[k] <= 1.0
        if k.startswith("cache_"):
            by = layer_controls(outs[0], whole, w32)
            line += "; by layer (share, f32 control, own share) " + str(
                [tuple(round(x, 4) for x in b) for b in by])
            if k in ctl:
                controls[k] = [c for _, c, _ in by]
                ok = all(a <= 1.0 or c <= lim for a, c, _ in by)
        print(line)
        if not ok:
            fails.append(f"{k} at {reads[k]:.4f} of the limit"
                         + (f", f32 control {controls[k]}" if k in ctl
                            else ""))
    reads = {"share_of_limit": reads, "f32_control": controls}
    rerun = max(r[arch]["serve"]["rerun_err"] for r in res)
    reads["decode_vs_rerun_share"] = rerun / 2.5e-2
    print(f"{tag} decode vs LM.apply over prompt + fed tokens on the ranks: "
          f"largest error {rerun} of the largest logit "
          f"({rerun / 2.5e-2:.4f} of the 2.5e-2 limit)")
    if rerun > 2.5e-2:
        fails.append(f"decode off its rerun by {rerun}")
    check(not fails, f"{tag} serving: {'; '.join(fails)}")
    return counts, reads


def tpr_check_train(arch: str, ref: dict, res: list) -> tuple[dict, dict]:
    """The training gates of one arch over the ranks' results: K7/K8/K9
    launches a step (hymba), step 1's loss and grad_norm, every gradient
    within 2e-2 of max |g_ref| with and without seq_parallel, each layer
    of a CONTROLLED leaf also passing within ``control_limit`` times
    the whole bf16 step's own distance to the f32 step (as for serving),
    grad_norm equal on the ranks, the whole leaves equal on both ranks
    after steps 2 and 3, the loss falling; every read printed before the
    gates fail; → (launches, reads)."""
    s = tpr_settings(arch)
    cfg = tpr_config(arch, s["train_layers"])
    L = cfg.n_layers
    n = 0 if cfg.rwkv else L
    per_step = {"flash_attention": 2 * n, "flash_attention_bwd_dq": n,
                "flash_attention_bwd_dkv": n}
    tag = f"[{s['tag']}] {arch}"
    counts: dict = {}
    for r in res:
        for i, st in enumerate(r[arch]["train"]["steps"]):
            c = st["collectives"]
            print(f"{tag} rank {r['rank']} step {i + 1} seq_parallel "
                  f"{st['seq_parallel']}: loss {st['loss']} grad_norm "
                  f"{st['grad_norm']}; {st['ms']:.3f} ms, peak "
                  f"{st['peak_gb']:.3f} GB; launches {st['launches']}; "
                  f"{c['collective_ms']:.3f} ms in {c['calls']} collectives "
                  f"({c['bytes'] / 1e6:.3f} MB), by pass {c['by_pass']}, "
                  f"{c['sync_ms']:.3f} ms waiting for the card's queued work")
            check(st["launches"] == per_step
                  and all(st["routes"][k] == {"wgmma_bf16": n, "simt_f32": 0}
                          for k, n in per_step.items()),
                  f"{tag} rank {r['rank']} step {i + 1}: launches "
                  f"{st['routes']}, expected {per_step}")
            check(c["by_pass"].get("backward", {}).get("calls", 0) > 0,
                  f"{tag} rank {r['rank']} step {i + 1}: no collective in "
                  f"the backward pass")
            for k, v in st["launches"].items():
                counts[k] = counts.get(k, 0) + v
    ctl = [k for k in CONTROLLED.get(arch, ()) if k in ref["max_ref"]]
    lim = s["control_limit"]
    reads, fails = {}, []
    for i in (0, 2):                        # from the same start
        st = res[0][arch]["train"]["steps"][i]
        label = "seq_parallel" if i == 0 else "no seq_parallel"
        reads[f"step{i + 1}_loss_rel"] = (abs(st["loss"] - ref["loss"])
                                          / abs(ref["loss"]))
        reads[f"step{i + 1}_grad_norm_rel"] = (
            abs(st["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"])
        if not (reads[f"step{i + 1}_loss_rel"] <= 1e-3
                and reads[f"step{i + 1}_grad_norm_rel"] <= 1e-2):
            fails.append(f"{label}: loss {st['loss']} grad_norm "
                         f"{st['grad_norm']} against the whole run's "
                         f"{ref['loss']} {ref['grad_norm']}")
        # each layer's error, the largest over the ranks, as a share of
        # 2e-2 * max|g_ref|, and its f32 control: the distance to the f32
        # step over the whole bf16 step's own
        # (None without the control)
        errs = [r[arch]["train"]["grad_err"][i // 2] for r in res]
        by, own_f32 = {}, ref["own_f32"]
        for k in ref["max_ref"]:
            scale = 2e-2 * max(ref["max_ref"][k], 1e-30)
            by[k] = [(max(e[k][0][j] for e in errs) / scale,
                      None if own_f32 is None else
                      max(e[k][1][j] for e in errs)
                      / max(own_f32[k][j], 1e-30),
                      None if own_f32 is None else own_f32[k][j] / scale)
                     for j in range(len(errs[0][k][0]))]
        share = {k: max(b[0] for b in v) for k, v in by.items()}
        top = {k: round(share[k], 4)
               for k in sorted(share, key=lambda k: -share[k])}
        shown = {k: [tuple(round(x, 4) for x in b) for b in by[k]]
                 for k in ctl}
        print(f"{tag} {label}: loss {reads[f'step{i + 1}_loss_rel']:.3g} and "
              f"grad_norm {reads[f'step{i + 1}_grad_norm_rel']:.3g} relative "
              f"off the whole run; gradients (largest first), share of 2e-2 "
              f"* max|g_ref|: {top}; by layer (share, f32 control, own "
              f"share): {shown}")
        reads[f"step{i + 1}_grad_share_of_limit"] = share
        reads[f"step{i + 1}_grad_f32_control"] = {
            k: [c for _, c, _ in by[k]] for k in ctl}
        bad = {k: by[k] for k in share
               if not all(a <= 1.0 or (k in ctl and c <= lim)
                          for a, c, _ in by[k])}
        if bad:
            fails.append(f"{label}: gradients off their limit: {bad}")
    for i in range(3):
        norms = {r[arch]["train"]["steps"][i]["grad_norm"] for r in res}
        if len(norms) != 1:
            fails.append(f"step {i + 1}: grad_norm differs between the "
                         f"ranks: {norms}")
    for j in range(2):                      # after steps 2 and 3
        digests = [r[arch]["train"]["whole_digests"][j] for r in res]
        same = all(dg == digests[0] for dg in digests)
        print(f"{tag} after step {j + 2}: the {len(digests[0])} leaves held "
              f"whole are equal on both ranks: {same}")
        if not (same and digests[0]):
            fails.append(f"after step {j + 2}: the ranks' whole leaves "
                         f"differ")
    steps = res[0][arch]["train"]["steps"]
    print(f"{tag} loss step 1 -> 2 (seq_parallel, the same batch): "
          f"{steps[0]['loss']} -> {steps[1]['loss']}")
    if not all(r[arch]["train"]["steps"][1]["loss"]
               < r[arch]["train"]["steps"][0]["loss"] for r in res):
        fails.append("the loss did not fall from step 1 to 2")
    check(not fails, f"{tag} training: {'; '.join(fails)}")
    return counts, reads


def tpr_cells(settings: list) -> tuple[dict, dict, list]:
    """The archs of each of ``settings`` (TP_RECURRENT, TP_VLM) served and
    trained on 2 ranks sharing the card, in one spawn, each held to its
    whole-model runs on the same weights in this process
    (:func:`tpr_reference`), every gate checked (:func:`tpr_check_serve`,
    :func:`tpr_check_train`); → (launches on the ranks, the reads and
    numbers by arch, the ranks' results)."""
    import gc
    import tempfile

    import torch

    from repro_torch.launch.mesh import run_on_local_mesh

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    archs = [a for s in settings for a in s["archs"]]
    mesh = settings[0]["mesh"]
    check(all(s["mesh"] == mesh for s in settings),
          f"one spawn, one mesh: {[s['mesh'] for s in settings]}")
    for arch in archs:
        s = tpr_settings(arch)
        tag = f"[{s['tag']}]"
        c = tpr_config(arch, s["layers"][arch])
        print(f"{tag} {arch}: {c.n_layers} layers served, "
              f"{s['train_layers']} trained; d {c.d_model}, "
              + ("RWKV-6 heads of 64" if c.rwkv else
                 f"{c.n_heads} heads x {c.hd} over {c.n_kv_heads} kv heads, "
                 + (f"groups of {c.cross_attn_every - 1} self + 1 cross "
                    f"layer against {c.n_img_tokens} image rows"
                    if c.cross_attn_every else
                    f"window {c.window}, ssm_state {c.ssm_state}"))
              + f", ff {c.d_ff}, vocab {c.vocab}, {c.dtype}; serving "
              f"{s['batch']} x {s['prompt_len']} and {s['decode']} "
              f"teacher-forced decode steps, training {s['train_batch']} x "
              f"{s['train_seq']}; mesh (data, model) = {s['mesh']}")
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="tp_cells_") as tmp:
        refs, jobs = {}, {}
        for arch in archs:
            tag = f"[{tpr_settings(arch)['tag']}]"
            path = os.path.join(tmp, f"{arch}.pt")
            refs[arch] = tpr_reference(arch, path)
            jobs[arch] = (refs[arch]["tokens"], path)
            r = refs[arch]
            print(f"{tag} {arch} whole-model run: "
                  f"{r['weights_gb']:.3f} GB of weights served; prefill step "
                  f"{r['ms']['prefill_step_ms']:.3f} ms, decode "
                  f"{statistics.median(r['ms']['decode_ms']):.3f} ms a step; "
                  f"training loss {r['loss']}"
                  + (f" (f32 {r['f32_loss']})" if r["f32_loss"] else "")
                  + " "
                  f"grad_norm {r['grad_norm']}, loss and gradients "
                  f"{r['step_ms']:.3f} ms")
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t_phase
        t1 = time.perf_counter()
        res = run_on_local_mesh(mesh, ("data", "model"), tpr_rank, jobs,
                                device="cuda",
                                timeout=max(s["timeout"] for s in settings))
        ranks_s = time.perf_counter() - t1
    counts: dict = {}
    for arch in archs:
        c1, serve_reads = tpr_check_serve(arch, refs[arch], res)
        c2, train_reads = tpr_check_train(arch, refs[arch], res)
        for k, v in (*c1.items(), *c2.items()):
            counts[k] = counts.get(k, 0) + v
        out[arch] = {"serve_reads": serve_reads, "train_reads": train_reads,
                     "whole_ms": refs[arch]["ms"],
                     "whole_step_ms": refs[arch]["step_ms"],
                     "ranks": [{"rank": r["rank"],
                                "serve_s": r[arch]["serve_s"],
                                "train_s": r[arch]["train_s"],
                                **{k: r[arch]["serve"][k] for k in (
                                    "ms", "peak_gb", "collectives",
                                    "launches")},
                                "steps": r[arch]["train"]["steps"]}
                               for r in res]}
    out.update(ranks_s=ranks_s, reference_s=t_ref,
               mesh_s=[r["mesh_s"] for r in res], t_phase=t_phase)
    return counts, out, res


def tpr_kernels(s: dict, res: list, arch: str, serve: dict,
                train: dict) -> dict:
    """K7 at each rank's q/k/v of the prefill step (``serve``: the kept
    call's name → its label, q's expected shape, the keys and the window),
    K8 and K9 at each rank's q/k/v/dO of training step 1 (``train``
    likewise): element by element against the plain versions, rank 0's
    timed beside the bound, the plain version and SDPA."""
    import torch

    tag = f"[{s['tag']}]"
    kern: dict = {"k7": {}, "k8_k9": {}}
    for part, kept, table in (("serve", "k7_inputs", serve),
                              ("train", "inputs", train)):
        for name, (label, want, keys, window) in table.items():
            for r in res:
                q, k, v, *do, w = (t.cuda() if torch.is_tensor(t) else t
                                   for t in r[arch][part][kept][name])
                causal = "cross" not in name
                check(tuple(q.shape) == want and k.shape == v.shape
                      and tuple(k.shape) == (*want[:1], keys, *want[2:])
                      and all(t.shape == q.shape for t in do)
                      and q.dtype == torch.bfloat16 and w == window,
                      f"{tag} rank {r['rank']} {name}: q {tuple(q.shape)} "
                      f"{q.dtype}, k {tuple(k.shape)}, window {w}; want "
                      f"{want} bf16 over {keys} keys, window {window}")
                if part == "serve":
                    if r["rank"] == 0:
                        kern["k7"][label] = k7_at(q, k, v, w, label,
                                                  causal=causal, tag=tag)
                        continue
                    dd, worst = flash_err(q, k, v, causal, w)
                    print(f"{tag} rank {r['rank']} K7 {label} at "
                          f"{list(q.shape)} x {k.shape[1]} keys bf16 causal "
                          f"{causal} window {w}: max abs err {dd}, {worst} "
                          f"of the element-wise limit")
                    kern["k7"][f"{label} rank {r['rank']}"] = {
                        "max_abs_err": dd, "err_of_elementwise_limit": worst}
                elif r["rank"] == 0:
                    kern["k8_k9"][label] = k8_k9_at(q, k, v, do[0], w, label,
                                                    causal=causal, tag=tag)
                else:
                    e = flash_bwd_err(q, k, v, do[0], causal, w)
                    print(f"{tag} rank {r['rank']} K8/K9 {label} at "
                          f"{list(q.shape)} x {k.shape[1]} keys bf16 causal "
                          f"{causal} window {w}: {e}")
                    kern["k8_k9"][f"{label} rank {r['rank']}"] = e
                del q, k, v, do
    return kern


def phase_tp_families() -> tuple[dict, dict, dict]:
    """Cells 15 and 16 in one spawn of 2 ranks sharing the card:
    hymba-1.5b and rwkv6-1.6b (TP_RECURRENT) and llama-3.2-vision-11b
    (TP_VLM) served and trained tensor-parallel, held to the whole-model
    runs on the same weights in this process; K7 (serving), K8 and K9
    (training) at each rank's own inputs against their plain versions,
    rank 0's timed: hymba's self-attention, the vlm model's self and cross
    attentions; → (launches on the ranks, the tp_recurrent cells' reads
    and kernels, the tp_vlm cell's)."""
    import gc

    counts, cells, res = tpr_cells([TP_RECURRENT, TP_VLM])
    outs = {}
    for s in (TP_RECURRENT, TP_VLM):
        outs[s["tag"]] = {a: cells[a] for a in s["archs"]}
    s = TP_RECURRENT
    B, T, Bt, Tt = (s["batch"], s["prompt_len"], s["train_batch"],
                    s["train_seq"])
    outs["tp_recurrent"].update(tpr_kernels(
        s, res, "hymba-1.5b",
        {"self": ("tp_recurrent serve", (B, T, 25, 64), T, 1024)},
        {"train": ("tp_recurrent train", (Bt, Tt, 25, 64), Tt, 1024)}))
    s = TP_VLM
    arch = s["archs"][0]
    B, T, Bt, Tt = (s["batch"], s["prompt_len"], s["train_batch"],
                    s["train_seq"])
    for r in res:                        # both attentions on every rank
        for part, k in (("serve", "k7_inputs"), ("train", "inputs")):
            got = r[arch][part][k]
            check(len(got) == 2, f"[tp_vlm] rank {r['rank']}: the K7 calls "
                                 f"kept were {sorted(got)}")
    h, M = 32 // s["mesh"][1], 1601     # each rank's heads; image rows
    outs["tp_vlm"].update(tpr_kernels(
        s, res, arch,
        {"self": ("tp_vlm self serve", (B, T, h, 128), T, 0),
         "cross": ("tp_vlm cross serve", (B, T, h, 128), M, 0)},
        {"train": ("tp_vlm self train", (Bt, Tt, h, 128), Tt, 0),
         "train cross": ("tp_vlm cross train", (Bt, Tt, h, 128), M, 0)}))
    phase_s = time.perf_counter() - cells["t_phase"]
    for o in outs.values():
        o.update({k: cells[k] for k in ("ranks_s", "reference_s",
                                         "mesh_s")}, phase_s=phase_s)
    print(f"[tp_recurrent] [tp_vlm] cells 15 and 16, one spawn: "
          f"{phase_s:.3f} s (budget 180): whole runs "
          f"{cells['reference_s']:.3f} s, ranks {cells['ranks_s']:.3f} s; "
          f"K7/K8/K9 launches on the ranks {counts}")
    del res
    gc.collect()
    return counts, outs["tp_recurrent"], outs["tp_vlm"]


# --------------------------------------------------------------------------- #
# cell 17: a data axis over more than one rank (FSDP)
# --------------------------------------------------------------------------- #
def fsdp_shape(fam: str, c: dict = FSDP) -> dict:
    """``fam``'s served layers, decode steps (by param_shardings_serving),
    trained layers and training length in cell ``c``."""
    f = c
    if fam == "dense":
        return dict(layers=f["dense_layers"], decode=f["decode"],
                    train_layers=f["train_layers"], train_seq=f["train_seq"])
    if fam == "moe":
        return dict(layers=f["moe_layers"], decode=f["moe_decode"],
                    train_layers=f["moe_layers"],
                    train_seq=f["moe_train_seq"])
    if fam == "vlm":
        return dict(layers=f["vlm_layers"], decode=f["decode"],
                    train_layers=f["vlm_layers"], train_seq=f["train_seq"])
    return dict(layers=f["rec_layers"], decode=f["decode"],
                train_layers=f["rec_train_layers"], train_seq=f["train_seq"])


def fsdp_config(fam: str, layers: int):
    """gemma3-12b ("dense"), moonshot-v1-16b-a3b ("moe"), hymba-1.5b
    ("hybrid"), rwkv6-1.6b ("ssm") or llama-3.2-vision-11b ("vlm") at full
    widths and ``layers`` layers."""
    import dataclasses

    from repro_torch.configs import get_config

    if fam in ("hybrid", "ssm", "vlm"):
        return tpr_config(FSDP[fam], layers)
    cfg = dataclasses.replace(get_config(FSDP[fam]), n_layers=layers)
    if fam == "dense":
        check(cfg.d_model == 3840 and cfg.n_heads == 16
              and cfg.n_kv_heads == 8 and cfg.hd == 256
              and cfg.d_ff == 15360 and cfg.vocab == 262144
              and cfg.dtype == "bfloat16", f"unexpected fsdp config {cfg}")
    else:
        check(cfg.d_model == 2048 and cfg.n_experts == 64 and cfg.top_k == 6
              and cfg.hd == 128 and cfg.dtype == "bfloat16",
              f"unexpected fsdp config {cfg}")
    return cfg


def fsdp_draws(cfg, fam: str, device, c: dict = FSDP) -> dict:
    """The inputs of cell ``c`` (:data:`FSDP` or :data:`POD`) for ``fam``
    from its seed: the served prompts [B, T] and the training batch [B, S]
    (every token counts); a vlm config's served image rows (``"img"``,
    [B, M, d]) and the training batch's own, in its dtype."""
    import torch

    f = c
    g = torch.Generator(device).manual_seed(f["seed"] + FSDP_FAMS[fam] + 1)
    shape = (f["batch"], fsdp_shape(fam, c)["train_seq"])
    out = {"ids": torch.randint(0, cfg.vocab, (f["batch"], f["prompt_len"]),
                                generator=g, device=device),
           "train": {"ids": torch.randint(0, cfg.vocab, shape, generator=g,
                                          device=device),
                     "labels": torch.randint(0, cfg.vocab, shape,
                                             generator=g, device=device),
                     "mask": torch.ones(shape, device=device)}}
    if cfg.cross_attn_every:
        out["img"], out["train"]["img_embeds"] = (torch.randn(
            (f["batch"], cfg.n_img_tokens, cfg.d_model), generator=g,
            device=device).to(torch.bfloat16) for _ in range(2))
    return out


def fsdp_weights(cfg, fam: str, part: str, device):
    """The whole weights of ``fam``'s serving or training run (``part``),
    drawn from the phase's seed (any process draws the same); a hybrid or
    ssm block's zero- and one-initialised leaves drawn too
    (:func:`draw_state_leaves`)."""
    import torch

    from repro_torch.models import LM

    seed = FSDP["seed"] + FSDP_FAMS[fam] + (2 if part == "train" else 3)
    g = torch.Generator(device).manual_seed(seed)
    params = LM(cfg).init(g)
    if cfg.rwkv or cfg.hybrid:
        blk = "rwkv" if cfg.rwkv else "ssm"
        params["layers"][blk] = draw_state_leaves(params["layers"][blk], g)
    return params


def fsdp_checked(tree, fam: str, n_layers: int) -> dict:
    """name → (leaf, its bounds in the whole leaf) of the gradients the
    phase holds to the whole run: for gemma3, hymba, rwkv and
    llama-3.2-vision every leaf of every layer (``"<path>@<layer>"``; a
    vlm self layer's in the order g * per + j, a cross layer's by group)
    and the embed table and final norm; for
    moonshot each layer's router, ``ln2`` and ``wq``, ``wi``/``wo`` of
    the experts in ``FSDP["experts"]`` the rank holds, and the embed
    table.  A DTensor's local tensor at its ``local_bounds`` (its data
    shard too), a plain tensor whole."""
    from repro_torch.core.spmd_pipeline import local_bounds, local_tensor
    from repro_torch.launch import sharding as TS

    out = {}

    def take(path, a):
        name, local, at = TS.path_str(path), local_tensor(a), local_bounds(a)
        moe = name.startswith("layers/moe/w")
        if fam == "moe" and not (moe or name == "embed/table" or any(
                name.endswith(k) for k in ("moe/router", "ln2/scale",
                                           "attn/wq"))):
            return
        if fam == "vlm" and name.startswith(("layers/", "cross/")):
            k = 2 if name.startswith("layers/") else 1
            for i, t in enumerate(local.flatten(0, k - 1).unbind(0)):
                out[f"{name}@{i}"] = (t, at[k:])
            return
        if not name.startswith("layers/"):
            out[name] = (local, at)
            return
        for i in range(n_layers):
            if not moe:
                out[f"{name}@{i}"] = (local[i], at[1:])
                continue
            for e in FSDP["experts"]:
                if at[1].start <= e < at[1].stop:
                    out[f"{name}@{i}/expert{e}"] = (
                        local[i, e - at[1].start], at[2:])

    TS.map_with_path(take, tree)
    return out


def fsdp_serve_reference(fam: str, layout, c: dict = FSDP) -> dict:
    """The whole-model serving run of ``fam`` on plain tensors in this
    process, cell ``c``'s layout registered (the moe routing groups): the
    prefill step, ``LM.prefill`` and greedy decode steps; its routing
    recorded by phase (moonshot); → logits, decode logits, the tokens it
    fed, the cache, the pins, ms; for a family with CONTROLLED reads,
    the control: the same weights served in f32, fed the same tokens."""
    import dataclasses

    import torch

    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.launch import steps as TST
    from repro_torch.models import LM, layers

    f = c
    L, n = fsdp_shape(fam, c)["layers"], fsdp_shape(fam, c)["decode"]
    cfg = fsdp_config(fam, L)
    model = LM(cfg)
    params = fsdp_weights(cfg, fam, "serve", "cuda")
    nbytes = sum(a.numel() * a.element_size() for a in leaves(params))
    draws = fsdp_draws(cfg, fam, "cuda", c)
    ids, img = draws["ids"], draws.get("img")
    cache = model.init_cache(f["batch"], f["prompt_len"] + n, device="cuda")
    log = RoutingLog()
    try:
        _, prefill = TST.make_prefill_step(cfg, layout)
        _, decode = TST.make_decode_step(cfg, layout)
        with routing_hook(log):
            logits, dec, tokens, ms = tp_serve(model, params, cache, ids,
                                               prefill, decode, steps=n,
                                               phase=log.set, img=img)
        out = {"logits": logits, "decode": dec, "tokens": tokens, "ms": ms,
               "ids": ids.cpu(), "weights_gb": nbytes / 1e9,
               "cache": {k: v.cpu() for k, (v, _) in
                         tpr_leaves(cache).items()},
               "pins": {k: torch.stack(v) for k, v in log.first().items()}}
        del cache
        if CONTROLLED.get(f[fam]):
            c32 = dataclasses.replace(cfg, dtype="float32")
            p32 = tree_map(lambda a: a.float(), params)
            del params
            m32 = LM(c32)
            cache = m32.init_cache(f["batch"], f["prompt_len"] + n,
                                   device="cuda")
            lg32, dec32, _, _ = tp_serve(
                m32, p32, cache, ids, TST.make_prefill_step(c32, layout)[1],
                TST.make_decode_step(c32, layout)[1], tokens, steps=n,
                img=None if img is None else img.float())
            out["f32"] = {"logits": lg32, "decode": dec32, "cache": {
                k: v.cpu() for k, (v, _) in tpr_leaves(cache).items()}}
            del p32, cache
    finally:
        layers.set_attention_mesh(None)
    return out


def fsdp_train_reference(fam: str, layout, c: dict = FSDP) -> dict:
    """The whole-model training step of ``fam`` on plain tensors in this
    process, cell ``c``'s layout registered: step 1's loss, grad_norm
    (before clipping) and checked gradients (:func:`fsdp_checked`), its
    routing (moonshot), and for moonshot and a family with CONTROLLED
    reads the control: the same step in f32 (moonshot's with the same
    routing pinned), its checked gradients."""
    import dataclasses

    import torch

    from repro_torch.core.tree import flatten, leaves, tree_map, unflatten
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import LM, layers
    from repro_torch.optim import global_norm

    f = c
    cfg = fsdp_config(fam, fsdp_shape(fam, c)["train_layers"])
    params = fsdp_weights(cfg, fam, "train", "cuda")
    nbytes = sum(a.numel() * a.element_size() for a in leaves(params))
    batch = fsdp_draws(cfg, fam, "cuda", c)["train"]
    log = RoutingLog()
    log.set("train")
    layers.set_attention_mesh(layout)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with routing_hook(log):
            ce, grads, aux = loss_and_grads(LM(cfg), params, batch,
                                            loss_chunk=f["loss_chunk"])
        gnorm = float(global_norm(grads))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        plain = {k: g.cpu() for k, (g, _) in fsdp_checked(
            unflatten(flatten(params)[1], grads), fam, cfg.n_layers).items()}
        del grads
        out = {"loss": float(ce), "grad_norm": gnorm, "step_ms": ms,
               "dropped_frac": float(aux["dropped_frac"]),
               "weights_gb": nbytes / 1e9, "plain": plain,
               "pins": {k: torch.stack(v) for k, v in log.first().items()}}
        if fam == "moe" or CONTROLLED.get(f[fam]):
            c32 = dataclasses.replace(cfg, dtype="float32")
            p32 = tree_map(lambda a: a.float(), params)
            del params
            log32 = RoutingLog({"train": out["pins"]["train"]}
                               if fam == "moe" else None)
            log32.set("train")
            with routing_hook(log32):
                _, g32, _ = loss_and_grads(LM(c32), p32, batch,
                                           loss_chunk=f["loss_chunk"])
            out["f32"] = {k: g.cpu() for k, (g, _) in fsdp_checked(
                unflatten(flatten(p32)[1], g32), fam, cfg.n_layers).items()}
            del p32, g32
    finally:
        layers.set_attention_mesh(None)
    torch.cuda.empty_cache()
    return out


def batch_part(mesh) -> tuple:
    """(i, n): this rank holds the i-th of n equal parts of a batch split
    over the mesh's batch axes, ``pod`` and ``data`` (pod-major)."""
    i, n = 0, 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            i, n = i * mesh.shape[a] + mesh.axis_index(a), n * mesh.shape[a]
    return i, n


def fsdp_serve_rank(mesh, fam: str, ref: dict, groups: dict,
                    c: dict = FSDP) -> dict:
    """One rank's serving of ``fam`` in cell ``c``: the whole weights
    drawn from the seed, kept by ``param_shardings_serving`` (and, but for
    moonshot, by ``param_shardings`` too: the FSDP storage), the prompts
    split over the batch axes by ``distribute_batch`` (one row a data
    rank, or a pod x data rank); the prefill
    step, ``LM.prefill`` and the whole run's tokens teacher-forced, the
    whole run's routing pinned, each collective timed by group; the
    rank's logits rows, cache shards, ms, peak GB, local shapes (the
    cache's too) and the q/k/v the first layer gave K7 (none for rwkv; a
    vlm model's first cross layer's too, and its self-cache exchanges:
    :func:`held_exchanges`)."""
    import torch

    from repro_torch.core.spmd_pipeline import local_bounds
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST

    f = c
    L = fsdp_shape(fam, c)["layers"]
    cfg = fsdp_config(fam, L)
    B, T = f["batch"], f["prompt_len"]
    part = batch_part(mesh)
    t0 = time.perf_counter()
    whole = fsdp_weights(cfg, fam, "serve", mesh.device)
    specs = {"serving": TS.param_shardings_serving(mesh, whole)}
    if fam != "moe":
        specs["fsdp"] = TS.param_shardings(mesh, whole)
    sharded = {k: TS.distribute_params(mesh, whole, v)
               for k, v in specs.items()}
    del whole
    torch.cuda.empty_cache()
    ids = TS.distribute_batch(mesh, {"ids": ref["ids"].to(mesh.device)})
    img = {}
    if cfg.cross_attn_every:                # the same rows as the prompt
        img = TS.distribute_batch(mesh, {"img_embeds": fsdp_draws(
            cfg, fam, mesh.device, c)["img"]})
    draw_s = time.perf_counter() - t0
    out = {"draw_s": draw_s, "runs": {}}
    model, prefill = TST.make_prefill_step(cfg, mesh)
    _, decode = TST.make_decode_step(cfg, mesh)

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t1)

    for layout, params in sharded.items():
        n = fsdp_shape(fam, c)["decode"] if (
            layout == "serving") else f["fsdp_decode"]
        log = RoutingLog(ref["pins"], part)
        coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                "bytes": 0}
        cache = TST.init_cache_sharded(cfg, mesh, B, T + n)
        kq: dict = {}
        exch = {"prefill": [], "decode": []}
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        with routing_hook(log), timed_collectives(coll, groups), \
                attention_spy(keep=kq, kind=lambda c, w: "k7" if c
                              else "k7 cross"):
            log.set("prefill")
            logits, pre_ms = timed(lambda: prefill(params, {**ids, **img}))
            log.set("fill")
            with held_exchanges(exch["prefill"]):
                _, fill_ms = timed(lambda: model.prefill(params, ids["ids"],
                                                         cache, **img))
            dec, dec_ms = [], []
            for j in range(n):
                log.set(f"dec{j}")
                tok = TS.distribute_batch(
                    mesh, {"ids": ref["tokens"][:, j:j + 1].to(mesh.device)})
                step = []
                with held_exchanges(step):
                    (lg, _), ms = timed(lambda: decode(params, cache,
                                                       {**tok, "pos": T + j}))
                exch["decode"].append(step)
                dec.append(lg.to_local().cpu())
                dec_ms.append(ms)
        coll["run_ms"] = 1e3 * (time.perf_counter() - t1)
        pl, held = tpr_leaves(params), tpr_leaves(cache)
        shapes = {n: tuple(pl[f"layers/{n}"][0].shape)
                  for n in FSDP_SHAPES[fam]}
        shapes["embed"] = tuple(pl["embed/table"][0].shape)
        shapes.update({f"cache_{k}": tuple(v.shape)
                       for k, (v, _) in held.items()})
        shapes["ids"] = tuple(ids["ids"].to_local().shape)
        out["runs"][layout] = {
            "logits": logits.to_local().cpu(),
            "collected": TS.collect_batch(logits).cpu()
            if layout == "serving" else None,
            "rows": local_bounds(logits)[0], "decode": dec,
            "ms": {"prefill_step_ms": pre_ms, "prefill_cache_ms": fill_ms,
                   "decode_ms": dec_ms},
            "collectives": coll, "shapes": shapes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cache": {k: (v.cpu(), b) for k, (v, b) in held.items()}
            if layout == "serving" else None,
            "k7": {name: tuple(t.cpu() if torch.is_tensor(t) else t
                               for t in qkv) for name, qkv in kq.items()}
            if layout == "serving" else None,
            "held": exch}
        del cache
    return out


@contextlib.contextmanager
def held_exchanges(calls: list):
    """Each self-cache exchange (``layers.held_rows``: the owner of a vlm
    self layer sending the other batch ranks their rows) timed alone, the
    card synchronised around it, appended to ``calls`` as (ms, bytes sent,
    bytes received) of this rank."""
    import torch

    from repro_torch.models import layers

    real = layers.held_rows

    def timed(x, split):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real(x, split)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        n = x.size                         # the ranks of its line
        nbytes = got.numel() * got.element_size()
        calls.append((ms, nbytes * (n - 1), 0) if x.layer is not None
                     else (ms, 0, nbytes))
        return got

    layers.held_rows = timed
    try:
        yield calls
    finally:
        layers.held_rows = real


def fsdp_train_rank(mesh, fam: str, ref: dict, groups: dict,
                    c: dict = FSDP) -> dict:
    """One rank's training of ``fam`` in cell ``c``: the whole weights
    drawn from the seed, kept by ``param_shardings``
    (``init_train_state_sharded``), the batch split over the batch axes;
    one ``make_train_step`` step with seq_parallel (and, but for the
    families of ``FSDP_SP_ONLY`` and a model axis of one rank, one
    without from the same start), the whole run's routing pinned, each
    collective timed by group; each step's checked gradients, before
    AdamW, against the whole run's at this rank's bounds (and against the
    f32 control's where the whole run took one); the moments' local
    shapes; the q, k, v and dO layer 0's attention gave K8 and K9 in the
    first step (none for rwkv; a vlm model's first cross layer's too);
    for a family ``c["nested"]`` names, the first step taken again from
    the same start with ``scan_chunks=default_scan_chunks(L)``
    (``"nested"``: its c, metrics, ms, peak, collectives and K7-K9
    launches, and each checked gradient's max |g - g_first|, 0.0 where
    the two are bit-equal); for the family ``c["ckpt"]`` names, the
    trained state's checkpoint round trip (:func:`pod_checkpoint`)."""
    import torch

    from repro_torch.core.spmd_pipeline import local_tensor
    from repro_torch.core.tree import leaves
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import sharding as TS
    from repro_torch.launch import steps as TST
    from repro_torch.launch.dryrun import default_scan_chunks
    from repro_torch.models import layers
    from repro_torch.optim import adamw_init

    f = c
    cfg = fsdp_config(fam, fsdp_shape(fam, c)["train_layers"])
    nest = fam in c["nested"]
    part = batch_part(mesh)
    t0 = time.perf_counter()
    whole = fsdp_weights(cfg, fam, "train", mesh.device)
    state = TST.init_train_state_sharded(cfg, mesh, whole)
    del whole
    # one step with seq_parallel, and one without from the same start but
    # for FSDP_SP_ONLY's families and a model axis of one rank, where the
    # carry splits nothing (SeqParallel.line is None): the same step twice
    plan = ([True] if fam in FSDP_SP_ONLY or c["mesh"][-1] == 1
            else [True, False])
    # the start of the second step (and of the nested one), kept on the
    # host
    start = [local_tensor(a).to("cpu", copy=True)
             for a in leaves(state["params"])] if len(plan) > 1 or nest \
        else []
    torch.cuda.empty_cache()
    batch = TS.distribute_batch(mesh, fsdp_draws(cfg, fam, mesh.device,
                                                 c)["train"])
    draw_s = time.perf_counter() - t0
    steps, inputs = [], {}
    real_update, real_attention = TST.adamw_update, layers.ops.attention
    spent = [0.0]
    # the first step's checked gradients on the host (the nested step's
    # yardstick), and the nested step's distances to them
    first, nested = {}, {}

    def spy(grads, st, params, **kw):
        t1 = time.perf_counter()
        checked = fsdp_checked(grads, fam, cfg.n_layers)
        if "c" in nested:
            nested["diff"] = {
                k: 0.0 if torch.equal(g, first[k].to(g.device)) else float(
                    (g.float() - first[k].to(g.device).float()).abs().max())
                for k, (g, _) in checked.items()}
        else:
            e = {}
            for k, (g, at) in checked.items():
                for name in ("plain", "f32"):
                    if name in ref:
                        want = ref[name][k][at].to(g.device).float()
                        d = float((g.float() - want).abs().max())
                        e[k if name == "plain" else f"{k} f32"] = d
                if nest and len(steps) == 1:
                    first[k] = g.to("cpu", copy=True)
            steps[-1]["grad_err"] = e
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t1
        return real_update(grads, st, params, **kw)

    def keep_attention(q, k, v, causal=True, window=0):
        o = real_attention(q, k, v, causal, window)
        name = "train" if causal else "train cross"
        if name not in inputs and torch.is_grad_enabled():
            inputs[name] = [t.detach().clone() for t in (q, k, v)] + [
                None, int(window)]
            o.register_hook(lambda g: inputs[name].__setitem__(
                3, g.detach().clone()))
        return o

    TST.adamw_update = spy
    try:
        for i, sp in enumerate(plan):
            if i:                         # the same start, no moments yet
                for a, s0 in zip(leaves(state["params"]), start):
                    local_tensor(a).copy_(s0)
                state = {"params": state["params"],
                         "opt": adamw_init(state["params"])}
            _, step = TST.make_train_step(cfg, mesh, seq_parallel=sp,
                                          lr=f["lr"], warmup=1,
                                          total_steps=10,
                                          loss_chunk=f["loss_chunk"])
            layers.ops.attention = keep_attention if i == 0 else \
                real_attention
            coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                    "bytes": 0}
            log = RoutingLog({"train": ref["pins"]["train"]}, part) \
                if fam == "moe" else RoutingLog()
            log.set("train")
            spent[0] = 0.0
            steps.append({"seq_parallel": sp})
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with routing_hook(log), timed_collectives(coll, groups):
                state, met = step(state, batch)
                loss, gnorm = float(met["loss"]), float(met["grad_norm"])
            steps[-1].update(
                loss=loss, grad_norm=gnorm,
                dropped_frac=float(met.get("dropped_frac", 0.0)),
                ms=1e3 * (time.perf_counter() - t1 - spent[0]),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                collectives=coll)
            if i == 0:
                moments = {}
                TS.map_with_path(lambda p, a: moments.__setitem__(
                    TS.path_str(p), (tuple(local_tensor(a).shape),
                                     tuple(a.shape))), state["opt"].m)
        if nest:
            # the first step again, its layers checkpointed in chunks of c
            # too: the same start, fresh moments, the same batch and pins
            layers.ops.attention = real_attention
            for a, s0 in zip(leaves(state["params"]), start):
                local_tensor(a).copy_(s0)
            state = {"params": state["params"],
                     "opt": adamw_init(state["params"])}
            nested["c"] = default_scan_chunks(cfg.n_layers)
            _, step = TST.make_train_step(cfg, mesh, seq_parallel=plan[0],
                                          scan_chunks=nested["c"],
                                          lr=f["lr"], warmup=1,
                                          total_steps=10,
                                          loss_chunk=f["loss_chunk"])
            coll = {"sync_ms": 0.0, "collective_ms": 0.0, "calls": {},
                    "bytes": 0}
            log = RoutingLog({"train": ref["pins"]["train"]}, part) \
                if fam == "moe" else RoutingLog()
            log.set("train")
            spent[0] = 0.0
            before = dict(fa.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with routing_hook(log), timed_collectives(coll, groups):
                state, met = step(state, batch)
                nested.update(loss=float(met["loss"]),
                              grad_norm=float(met["grad_norm"]))
            nested.update(
                ms=1e3 * (time.perf_counter() - t1 - spent[0]),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                collectives=coll,
                launches={k: v - before.get(k, 0)
                          for k, v in fa.LAUNCHES.items()})
    finally:
        TST.adamw_update = real_update
        layers.ops.attention = real_attention
    ckpt = pod_checkpoint(mesh, state) if c.get("ckpt") == fam else None
    return {"draw_s": draw_s, "steps": steps, "moments": moments,
            "inputs": {name: tuple(t.cpu() if torch.is_tensor(t) else t
                                   for t in qkv)
                       for name, qkv in inputs.items()}, "ckpt": ckpt,
            "nested": nested or None}


def pod_checkpoint(mesh, state: dict) -> dict:
    """A trained state's round trip through ``CheckpointStore`` on the
    ranks of ``mesh``: saved under ``build/pod_ckpt`` (every DTensor leaf
    gathered whole, rank 0 writing), restored by ``shardings=``
    (``param_shardings``, ``opt_shardings``); → the file's bytes, the save
    and restore ms (the card synchronised), the leaves, and whether every
    local tensor, placement and plain leaf came back bit-equal.  The
    directory is deleted after every rank has read it."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core.spmd_pipeline import is_dtensor, local_tensor
    from repro_torch.core.tree import leaves
    from repro_torch.launch import sharding as TS

    root = os.path.join(HERE, "build", "pod_ckpt")
    if mesh.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    dist.barrier()
    store = CheckpointStore(root, keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = store.save(1, state, {"next_step": 1})
    t1 = time.perf_counter()
    sh = {"params": TS.param_shardings(mesh, state["params"]),
          "opt": TS.opt_shardings(mesh, state["opt"], state["params"])}
    got, extra = store.restore(1, like=state, shardings=sh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pairs = list(zip(leaves(got), leaves(state)))
    equal = extra == {"next_step": 1} and all(
        is_dtensor(a) == is_dtensor(b)
        and (not is_dtensor(a) or a.placements == b.placements)
        and torch.equal(local_tensor(a), local_tensor(b)) for a, b in pairs)
    nbytes = os.path.getsize(os.path.join(path, "arrays.npz"))
    dist.barrier()
    if mesh.rank == 0:
        shutil.rmtree(root)
    dist.barrier()
    return {"bytes": nbytes, "save_ms": 1e3 * (t1 - t0),
            "restore_ms": 1e3 * (t2 - t1), "leaves": len(pairs),
            "equal": equal, "gone": not os.path.exists(root)}


def fsdp_cell_rank(mesh, ref: dict, c: dict) -> dict:
    """One rank of cell ``c`` (:data:`FSDP` on ``mesh``, or :data:`POD`):
    every family of :data:`FSDP_FAMS` served and trained
    (:func:`fsdp_serve_rank`, :func:`fsdp_train_rank`), the K7-K9 launch
    counts set to 0 before the cell and read after it, and by family; each
    collective named by its group (``pod``, ``data``, ``model``, and
    ``pod+data``: the batch line)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    dm = mesh.device_mesh                 # the DeviceMesh and its groups
    groups = {tuple(dist.get_process_group_ranks(dm.get_group(a))): a
              for a in c["axes"]}
    if "pod" in c["axes"]:
        groups[tuple(mesh.axis_group(("pod", "data"))[1])] = "pod+data"
    out = {"rank": mesh.rank, "coord": mesh.coord,
           "transport": mesh.transport, "mesh_s": time.perf_counter() - t0}
    fa.reset_launches()
    for fam in FSDP_FAMS:
        gc.collect()                      # the last family's tensors gone
        torch.cuda.empty_cache()          # before the peaks are read
        before = dict(fa.LAUNCHES)
        t1 = time.perf_counter()
        out[f"{fam}_serve"] = fsdp_serve_rank(mesh, fam, ref[f"{fam}_serve"],
                                              groups, c)
        torch.cuda.empty_cache()
        out[f"{fam}_train"] = fsdp_train_rank(mesh, fam, ref[f"{fam}_train"],
                                              groups, c)
        torch.cuda.empty_cache()
        out[f"{fam}_launches"] = {k: v - before.get(k, 0)
                                  for k, v in fa.LAUNCHES.items()}
        out[f"{fam}_s"] = time.perf_counter() - t1
    out["launches"] = dict(fa.LAUNCHES)
    out["routes"] = {k: dict(v) for k, v in fa.ROUTE_LAUNCHES.items()}
    return out


def fsdp_rank(mesh, ref_path: str, tag: str) -> dict:
    """One rank of the fsdp phase's cell ``tag`` (:data:`FSDP` or
    :data:`POD`, on ``mesh``): :func:`fsdp_cell_rank` against the parent's
    references in ``ref_path``."""
    import torch

    from repro_torch.models import layers

    c = next(x for x in (FSDP, POD) if x["tag"] == tag)
    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    try:
        return fsdp_cell_rank(mesh, ref, c)
    finally:
        layers.set_attention_mesh(None)


def fsdp_share(got, want, limit: float = 2e-2) -> float:
    """max |got - want| over ``limit`` * max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / (limit * want.abs().max())).item()


def fsdp_check_serve(fam: str, ref: dict, res: list,
                     cell: dict = FSDP) -> dict:
    """The ranks' serving of ``fam`` in cell ``cell`` against the whole
    run: each rank's logits rows within 2e-2 of max|ref| (and ``collect_batch``'s whole
    logits equal to the rows), decode within 2.5e-2 (gemma3, moonshot) or
    2e-2 (hymba, rwkv), every cache leaf reassembled within 2e-2 (a leaf
    CONTROLLED names also passing, layer by layer, within
    ``control_limit`` times the whole bf16 run's own distance to the f32
    run), the local shapes; prints each rank's ms, peak, shapes and
    collectives by group (a vlm model's self-cache exchanges a decode
    step too), and every read before a gate fails."""
    import torch

    dlim = 2.5e-2 if fam in ("dense", "moe") else 2e-2
    cfg = fsdp_config(fam, fsdp_shape(fam, cell)["layers"])
    per = cfg.cross_attn_every - 1 if cfg.cross_attn_every else 0
    nb = math.prod(cell["mesh"][:-1])        # the batch ranks, pod x data
    reads, fails, exchange = {}, [], {}
    for layout in res[0][f"{fam}_serve"]["runs"]:
        pre, dec = [], []
        for r in res:
            g = r[f"{fam}_serve"]["runs"][layout]
            rows = g["rows"]
            pre.append(fsdp_share(g["logits"], ref["logits"][rows]))
            dec += [fsdp_share(a, w[rows], dlim)
                    for a, w in zip(g["decode"], ref["decode"])]
            if g["collected"] is not None:
                check(torch.equal(g["collected"][rows], g["logits"]),
                      f"{cell['tag']} {fam}: collect_batch's logits differ "
                      f"from the rank's rows")
            c, ms = g["collectives"], g["ms"]
            print(f"[{cell['tag']}] {fam} {layout} rank {r['rank']} {r['coord']}: "
                  f"local shapes {g['shapes']}; prefill step "
                  f"{ms['prefill_step_ms']:.3f} ms, prefill into the cache "
                  f"{ms['prefill_cache_ms']:.3f} ms, decode "
                  f"{statistics.median(ms['decode_ms']):.3f} ms a step "
                  f"(median of {len(ms['decode_ms'])}); peak "
                  f"{g['peak_gb']:.3f} GB; collectives "
                  f"{c['collective_ms']:.3f} ms of {c['run_ms']:.3f} ms, "
                  f"by group "
                  f"{json.dumps(c['by_group'])}")
            check(g["shapes"]["ids"][0] == cell["batch"] // nb,
                  f"{cell['tag']} {fam} rank {r['rank']}: the batch's local rows "
                  f"{g['shapes']['ids']}")
            # the rank's rows of B; the vlm self cache: every row of B for
            # its part of each group's self layers (the JAX layout)
            check(all(v[2] == cell["batch"] and nb * v[1] == per
                      if k.startswith("cache_self/") else
                      v[1] == cell["batch"] // nb
                      for k, v in g["shapes"].items()
                      if k.startswith("cache_")),
                  f"{cell['tag']} {fam} rank {r['rank']}: the cache's local rows "
                  f"{g['shapes']}")
            if per:
                steps = g["held"]["decode"]
                ms = [sum(c[0] for c in st) for st in steps]
                sent = [sum(c[1] for c in st) for st in steps]
                got = [sum(c[2] for c in st) for st in steps]
                check(not g["held"]["prefill"]
                      and all(len(st) == 2 * per * cfg.n_layers
                              // cfg.cross_attn_every for st in steps),
                      f"{cell['tag']} {fam} rank {r['rank']}: self-cache exchanges "
                      f"{[len(st) for st in steps]} a decode step, "
                      f"{len(g['held']['prefill'])} in the prefill")
                exchange[f"{layout} rank {r['rank']}"] = {
                    "calls_a_step": len(steps[0]),
                    "ms_a_step_median": statistics.median(ms),
                    "bytes_sent_a_step": sent[0],
                    "bytes_received_a_step": got[0]}
                print(f"[{cell['tag']}] {fam} {layout} rank {r['rank']}: self-cache "
                      f"exchange a decode step {len(steps[0])} calls, "
                      f"{statistics.median(ms):.3f} ms (median of "
                      f"{len(ms)}), {sent[0] / 1e6:.3f} MB sent and "
                      f"{got[0] / 1e6:.3f} MB received; decode step "
                      f"{statistics.median(g['ms']['decode_ms']):.3f} ms")
        reads[f"{layout}_prefill_logits"] = max(pre)
        reads[f"{layout}_decode_logits"] = max(dec)
    ctl, lim = CONTROLLED.get(FSDP[fam], ()), FSDP["control_limit"]
    for name, whole in ref["cache"].items():
        full = torch.zeros(whole.shape, dtype=whole.dtype)
        seen = torch.zeros(full.shape, dtype=torch.bool)
        for r in res:
            local, bounds = r[f"{fam}_serve"]["runs"]["serving"]["cache"][name]
            full[tuple(bounds)] = local
            seen[tuple(bounds)] = True
        check(bool(seen.all()), f"{cell['tag']} {fam}: the ranks' cache {name} does "
                                f"not cover the whole")
        k = f"cache_{name}"
        reads[k] = fsdp_share(full, whole)
        if reads[k] <= 1.0 or k not in ctl:
            continue
        by = layer_controls(full, whole, ref["f32"]["cache"][name])
        print(f"[{cell['tag']}] {fam} {k}: by layer (share, f32 control, own share) "
              f"{[tuple(round(x, 4) for x in b) for b in by]} (limit {lim})")
        reads[f"{k} f32_control"] = [c for _, c, _ in by]
        if not all(a <= 1.0 or c <= lim for a, c, _ in by):
            fails.append(k)
    for k, v in reads.items():
        if k.endswith("f32_control"):
            continue
        lim_k = dlim if "decode" in k else 2e-2
        print(f"[{cell['tag']}] {fam} {k}: max |err| at {v:.4f} of {lim_k:g} * "
              f"max|ref|")
        if v > 1.0 and f"{k} f32_control" not in reads:
            fails.append(k)
    check(not fails, f"{cell['tag']} {fam} serving: reads over their limit {fails}")
    if exchange:
        reads["self_cache_exchange"] = exchange
    return reads


def fsdp_check_train(fam: str, ref: dict, res: list,
                     cell: dict = FSDP) -> dict:
    """The ranks' training of ``fam`` in cell ``cell`` against the whole
    run's step 1:
    loss within 1e-3 and grad_norm within 1e-2 relative (equal on every
    rank), moonshot's ``dropped_frac`` within 1e-6 (the data ranks' means
    averaged: ``1 - kept / k`` rounds a shard at a time), every checked
    gradient within 2e-2 of max|g_ref| — or, where a moonshot leaf or one
    CONTROLLED names reads over that, within ``control_limit`` times
    the whole bf16 run's own distance to the f32 run (the ep phase's
    control); the moments' local shapes; prints each step's ms, peak and
    collectives by group."""
    reads = {}
    n_steps = len(res[0][f"{fam}_train"]["steps"])
    lim = FSDP["control_limit"]
    ctl = CONTROLLED.get(FSDP[fam], ())
    scales = {k: 2e-2 * float(w.float().abs().max())
              for k, w in ref["plain"].items()}
    for i in range(n_steps):
        sts = [r[f"{fam}_train"]["steps"][i] for r in res]
        label = "seq_parallel" if sts[0]["seq_parallel"] else \
            "no seq_parallel"
        norms = {st["grad_norm"] for st in sts}
        check(len(norms) == 1, f"{cell['tag']} {fam} {label}: grad_norm differs "
                               f"between the ranks: {norms}")
        st = sts[0]
        lrel = abs(st["loss"] - ref["loss"]) / abs(ref["loss"])
        grel = abs(st["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        check(lrel <= 1e-3 and grel <= 1e-2
              and abs(st["dropped_frac"] - ref["dropped_frac"]) <= 1e-6,
              f"{cell['tag']} {fam} {label}: loss {st['loss']} grad_norm "
              f"{st['grad_norm']} dropped_frac {st['dropped_frac']} against "
              f"the whole run's {ref['loss']} {ref['grad_norm']} "
              f"{ref['dropped_frac']}")
        shares, fails = {}, []
        for k, want in ref["plain"].items():
            scale = scales[k]
            got = [r[f"{fam}_train"]["steps"][i]["grad_err"][k] for r in res
                   if k in r[f"{fam}_train"]["steps"][i]["grad_err"]]
            check(len(got) >= 1, f"{cell['tag']} {fam}: no rank checked {k}")
            shares[k] = max(got) / scale
            if shares[k] <= 1.0:
                continue
            if "f32" not in ref or (fam != "moe"
                                    and k.split("@")[0] not in ctl):
                fails.append(k)
                continue
            own = float((want.float() - ref["f32"][k].float()).abs().max())
            ranks = max(r[f"{fam}_train"]["steps"][i]["grad_err"][f"{k} f32"]
                        for r in res
                        if k in r[f"{fam}_train"]["steps"][i]["grad_err"])
            ratio = ranks / max(own, 1e-30)
            print(f"[{cell['tag']}] {fam} {label} gradient {k}: {shares[k]:.4f} of "
                  f"2e-2 * max|g_ref|; the f32 control: the whole bf16 run's "
                  f"own distance to the f32 run {own / scale:.4f} of that "
                  f"limit, the ranks' distance to it {ratio:.4f} x that "
                  f"(limit {lim})")
            reads[f"{label} {k} f32_control"] = ratio
            if ratio > lim:
                fails.append(k)
        top = dict(sorted(shares.items(), key=lambda kv: -kv[1])[:4])
        print(f"[{cell['tag']}] {fam} {label} step: loss {st['loss']} ({lrel:.3g} "
              f"rel), grad_norm {st['grad_norm']} ({grel:.3g} rel); every "
              f"checked gradient's max |g - g_ref| over 2e-2 * max|g_ref|, "
              f"the largest: {top}")
        for r in res:
            s = r[f"{fam}_train"]["steps"][i]
            c = s["collectives"]
            print(f"[{cell['tag']}] {fam} {label} rank {r['rank']}: step "
                  f"{s['ms']:.3f} ms, peak {s['peak_gb']:.3f} GB; "
                  f"collectives {c['collective_ms']:.3f} ms, by group "
                  f"{json.dumps(c['by_group'])}")
        check(not fails, f"{cell['tag']} {fam} {label}: gradients over their limit "
                         f"{fails}")
        reads[f"{label} loss_rel"] = lrel
        reads[f"{label} grad_norm_rel"] = grel
        reads[f"{label} grad_share_of_limit"] = max(shares.values())
    return reads


def fsdp_check_nested(fam: str, ref: dict, res: list, cell: dict) -> dict:
    """The ranks' nested-remat step of ``fam`` (``scan_chunks`` c, the
    first step again from the same start) against their first step (c =
    0): the count of checked gradients that are not bit-equal on some
    rank, the largest max |g - g_first| as a share of the bf16 limit (2e-2
    * max|g_ref| of the whole run's gradient; failing above 1.0), the loss
    and grad_norm (equal on every rank, within the first step's gates of
    it); prints, for rank 0, both steps' ms, peak memory and ``data``
    collectives (GB and s) and the nested step's K7-K9 launches."""
    tag = cell["tag"]
    nests = [r[f"{fam}_train"]["nested"] for r in res]
    firsts = [r[f"{fam}_train"]["steps"][0] for r in res]
    c = nests[0]["c"]
    check(len({(n["loss"], n["grad_norm"]) for n in nests}) == 1,
          f"{tag} {fam} scan_chunks={c}: loss or grad_norm differs between "
          f"the ranks: {[(n['loss'], n['grad_norm']) for n in nests]}")
    n0, s0 = nests[0], firsts[0]
    lrel = abs(n0["loss"] - s0["loss"]) / abs(s0["loss"])
    grel = abs(n0["grad_norm"] - s0["grad_norm"]) / s0["grad_norm"]
    scales = {k: 2e-2 * float(w.float().abs().max())
              for k, w in ref["plain"].items()}
    unequal, share = set(), 0.0
    for n in nests:
        for k, d in n["diff"].items():
            if d != 0.0:
                unequal.add(k)
                share = max(share, d / scales[k])
    checked = len(set().union(*(n["diff"] for n in nests)))
    print(f"[{tag}] {fam} scan_chunks={c} step (the first step again, "
          f"nested remat): loss {n0['loss']} (bit-equal to c = 0: "
          f"{n0['loss'] == s0['loss']}), grad_norm {n0['grad_norm']} "
          f"(bit-equal: {n0['grad_norm'] == s0['grad_norm']}); "
          f"{len(unequal)} of {checked} checked gradients not bit-equal on "
          f"some rank, the largest share of the bf16 limit {share:.4g}"
          + (f" ({sorted(unequal)[:6]})" if unequal else ""))

    def data(st) -> tuple:
        g = st["collectives"]["by_group"].get("data", {})
        return g.get("bytes", 0) / 1e9, g.get("ms", 0.0) / 1e3

    rows = {}
    for label, st in (("c=0", s0), (f"c={c}", n0)):
        gb, sec = data(st)
        rows[label] = {"ms": st["ms"], "peak_gb": st["peak_gb"],
                       "data_gb": gb, "data_s": sec}
        print(f"[{tag}] {fam} rank 0 {label}: step {st['ms']:.3f} ms, peak "
              f"{st['peak_gb']:.3f} GB, data collectives {gb:.4f} GB in "
              f"{sec:.3f} s")
    print(f"[{tag}] {fam} rank 0 scan_chunks={c} step's K7-K9 launches "
          f"{n0['launches']}")
    check(share <= 1.0 and lrel <= 1e-3 and grel <= 1e-2,
          f"{tag} {fam} scan_chunks={c}: against its c = 0 step, loss "
          f"{lrel:.3g} rel, grad_norm {grel:.3g} rel, gradients at "
          f"{share:.4g} of the bf16 limit ({sorted(unequal)[:6]})")
    return {"c": c, "unequal": len(unequal), "checked": checked,
            "share_of_limit": share, "loss_equal": n0["loss"] == s0["loss"],
            "grad_norm_equal": n0["grad_norm"] == s0["grad_norm"],
            "launches": n0["launches"], "rank0": rows}


def fsdp_cell_checks(c: dict, ref: dict, res: list) -> tuple[dict, dict]:
    """Cell ``c``'s checks over its ranks' results ``res``
    (:func:`fsdp_cell_rank`) against the whole runs ``ref``: every
    family's serving and training (:func:`fsdp_check_serve`,
    :func:`fsdp_check_train`; the nested-remat step of the families
    ``c["nested"]`` names, :func:`fsdp_check_nested`), the K7-K9 launches
    and routes, the vlm
    family's launches, the moments' local shapes, K7 at a batch rank's
    serving shapes and K8/K9 at its training shapes element by element on
    every rank (rank 0's timed), and the checkpoint round trip of
    ``c["ckpt"]`` → (the K7-K9 launches summed over the ranks, the cell's
    reads and numbers)."""
    import torch

    f, tag = c, c["tag"]
    counts: dict = {}
    for r in res:
        check(r["launches"]["flash_attention"] > 0
              and r["launches"]["flash_attention_bwd_dq"] > 0
              and r["launches"]["flash_attention_bwd_dkv"] > 0
              and all(v.get("simt_f32", 0) == 0
                      for v in r["routes"].values()),
              f"{tag} rank {r['rank']}: K7-K9 launches {r['launches']}, "
              f"routes {r['routes']}")
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    reads = {}
    for fam in FSDP_FAMS:
        reads[f"{fam}_serve"] = fsdp_check_serve(fam, ref[f"{fam}_serve"],
                                                 res, c)
        reads[f"{fam}_train"] = fsdp_check_train(fam, ref[f"{fam}_train"],
                                                 res, c)
        if fam in c["nested"]:
            reads[f"{fam}_nested"] = fsdp_check_nested(
                fam, ref[f"{fam}_train"], res, c)
        print(f"[{tag}] {fam} K7-K9 launches by rank "
              f"{[r[f'{fam}_launches'] for r in res]}; the ranks' seconds "
              f"{[round(r[f'{fam}_s'], 3) for r in res]}")
    # the vlm family's launches on every rank: 5 K7 a prefill (4 self, 1
    # cross) in the prefill step and LM.prefill under both layouts, and a
    # train step's forward and group recompute, 5 K8 and 5 K9
    L = f["vlm_layers"]
    want = {"flash_attention": 6 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    for r in res:
        check(r["vlm_launches"] == want,
              f"{tag} rank {r['rank']} vlm: K7-K9 launches "
              f"{r['vlm_launches']}, want {want}")
    # the moments at their opt_shardings local shapes: (leaf, the dim
    # split over data, the dim split over model), a part of the whole on
    # a rank
    moments = {"dense": ("layers/attn/wq", 1, 2),
               "moe": ("layers/attn/wq", 1, 2),
               "hybrid": ("layers/ssm/in_proj", 1, 3),
               "ssm": ("layers/rwkv/wr", 1, 2),
               "vlm": ("layers/attn/wq", 2, 3)}
    nd, m = f["mesh"][-2], f["mesh"][-1]
    for r in res:
        for fam in FSDP_FAMS:
            leaf, dd, dm_ = moments[fam]
            local, shape = r[f"{fam}_train"]["moments"][leaf]
            check(local[dd] * nd == shape[dd] and local[dm_] * m == shape[dm_]
                  and all(a == b for i, (a, b) in enumerate(zip(local, shape))
                          if i not in (dd, dm_)),
                  f"{tag} rank {r['rank']} {fam}: {leaf} moments "
                  f"{(local, shape)}")
    # K7 at a batch rank's serving shapes, K8/K9 at its training shapes,
    # element by element on every rank, rank 0's timed (hymba's 25 heads
    # whole on a model rank, window 1024; the vlm self layers causal and
    # its cross layer against the 1601 image rows)
    k7, bwd = {}, {}
    hy = fsdp_config("hybrid", 1)
    vl = fsdp_config("vlm", f["vlm_layers"])
    T, M = f["prompt_len"], vl.n_img_tokens
    want_q = {"hybrid": (1, T, hy.n_heads // m if hy.n_heads % m == 0
                         else hy.n_heads, hy.hd),
              "vlm": (1, T, vl.n_heads // m, vl.hd)}
    kept = {"dense": (("k7", "train"),), "moe": (("k7", "train"),),
            "hybrid": (("k7", "train"),),
            "vlm": (("k7", "train"), ("k7 cross", "train cross"))}
    for r in res:
        for fam, names in ((f_, kept[f_]) for f_ in FSDP_FAMS
                           if f_ in kept):
            for serve_name, train_name in names:
                cross = "cross" in serve_name
                label = f"{tag} {fam}" + (" cross" if cross else "")
                keys = M if cross else T
                for part, name in (("serve", serve_name),
                                   ("train", train_name)):
                    got = (r[f"{fam}_serve"]["runs"]["serving"]["k7"]
                           if part == "serve"
                           else r[f"{fam}_train"]["inputs"])
                    check(name in got, f"{tag} rank {r['rank']} {fam}: no "
                                       f"{name} inputs kept ({sorted(got)})")
                    q, k, v, *do, w = (t.to("cuda") if torch.is_tensor(t)
                                       else t for t in got[name])
                    do = [t for t in do if t is not None]
                    check(q.shape[0] == 1 and q.dtype == torch.bfloat16
                          and tuple(q.shape) == want_q.get(fam,
                                                           tuple(q.shape))
                          and (fam != "vlm" or k.shape[1] == keys)
                          and (part == "serve" or len(do) == 1),
                          f"{tag} rank {r['rank']} {fam} {part}: q "
                          f"{tuple(q.shape)}, k {tuple(k.shape)}")
                    if part == "serve" and r["rank"] == 0:
                        k7[label] = k7_at(q, k, v, w, label,
                                          causal=not cross, tag=f"[{tag}]")
                    elif part == "serve":
                        d, worst = flash_err(q, k, v, not cross, w)
                        print(f"[{tag}] rank {r['rank']} K7 {label} at "
                              f"{list(q.shape)} x {k.shape[1]} keys: max abs "
                              f"err {d}, {worst} of the element-wise limit")
                        k7[f"{label} rank {r['rank']}"] = {
                            "max_abs_err": d,
                            "err_of_elementwise_limit": worst}
                    elif r["rank"] == 0:
                        bwd[label] = k8_k9_at(q, k, v, do[0], w,
                                              f"{label} train",
                                              causal=not cross,
                                              tag=f"[{tag}]")
                    else:
                        e = flash_bwd_err(q, k, v, do[0], not cross, w)
                        print(f"[{tag}] rank {r['rank']} K8/K9 {label} at "
                              f"{list(q.shape)} x {k.shape[1]} keys: {e}")
                        bwd[f"{label} rank {r['rank']}"] = e
                    del q, k, v, do
    ckpt = None
    if c.get("ckpt"):
        ckpt = [r[f"{c['ckpt']}_train"]["ckpt"] for r in res]
        for r, ck in zip(res, ckpt):
            print(f"[{tag}] checkpoint of {FSDP[c['ckpt']]}'s trained state "
                  f"rank {r['rank']}: {ck['leaves']} leaves, "
                  f"{ck['bytes'] / 1e9:.3f} GB on disk, save "
                  f"{ck['save_ms']:.3f} ms, restore by shardings "
                  f"{ck['restore_ms']:.3f} ms, bit-equal {ck['equal']}, "
                  f"directory deleted {ck['gone']}")
            check(ck["equal"] and ck["gone"],
                  f"{tag} rank {r['rank']}: the checkpoint round trip {ck}")
    out = {"reads": reads, "k7": k7, "k8_k9": bwd, "ckpt": ckpt,
           "whole": {k: {n: v for n, v in w.items() if n in (
               "ms", "step_ms", "loss", "grad_norm", "weights_gb")}
               for k, w in ref.items()},
           "ranks": [{"rank": r["rank"], "coord": r["coord"],
                      "mesh_s": r["mesh_s"], "launches": r["launches"],
                      **{f"{fam}_launches": r[f"{fam}_launches"]
                         for fam in FSDP_FAMS},
                      **{f"{fam}_{p}": {
                          "draw_s": r[f"{fam}_{p}"]["draw_s"],
                          **({"runs": {lay: {n: g[n] for n in (
                              "ms", "collectives", "shapes", "peak_gb")}
                              for lay, g in r[f"{fam}_{p}"]["runs"].items()}}
                             if p == "serve" else
                             {"steps": [{n: s[n] for n in (
                                 "seq_parallel", "loss", "grad_norm", "ms",
                                 "peak_gb", "collectives")}
                                 for s in r[f"{fam}_{p}"]["steps"]]})}
                         for fam in FSDP_FAMS
                         for p in ("serve", "train")}}
                     for r in res]}
    return counts, out


def phase_fsdp(c: dict = FSDP) -> tuple[dict, dict]:
    """Cell ``c`` in a spawn of 4 ranks sharing the card: a data axis over
    more than one rank (:data:`FSDP`, cell 17, a (data 2, model 2) mesh)
    or pod as a second batch axis (:data:`POD`, cell 18, (pod 2, data 2,
    model 1)): gemma3-12b, moonshot-v1-16b-a3b, hymba-1.5b, rwkv6-1.6b
    and llama-3.2-vision-11b served and trained, each held to the
    whole-model run on the same weights in this process (the cell's layout
    registered) → (the K7-K9 launches on the ranks, the cell's numbers).
    Each cell has a spawn of its own: in one spawn the ranks' pinned host
    buffers of cell 17 and both cells' references in this process outgrew
    a one-H100 machine's 96 GiB of host memory (PERF.md, cell 18)."""
    import gc
    import tempfile

    import torch

    from repro_torch.launch.mesh import MeshLayout, run_on_local_mesh

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    f, tag = c, c["tag"]
    print(f"[{tag}] cell {c['cell']}: mesh {c['axes']} = {c['mesh']}, 4 "
          f"ranks sharing the card, the batch split over "
          f"{tuple(a for a in c['axes'] if a != 'model')}, one row a rank "
          f"of it; {f['dense']} served at {f['dense_layers']} layers "
          f"({f['batch']} x {f['prompt_len']}, {f['decode']} decode steps; "
          f"{f['fsdp_decode']} under the FSDP storage) and trained at "
          f"{f['train_layers']} ({f['batch']} x {f['train_seq']}, loss "
          f"chunks of {f['loss_chunk']}); {f['moe']} served at "
          f"{f['moe_layers']} ({f['moe_decode']} decode steps) and trained "
          f"({f['batch']} x {f['moe_train_seq']}); {f['hybrid']} and "
          f"{f['ssm']} served at {f['rec_layers']} ({f['decode']} decode "
          f"steps; {f['fsdp_decode']} under the FSDP storage) and trained "
          f"at {f['rec_train_layers']} ({f['batch']} x {f['train_seq']}); "
          f"{f['vlm']} served and trained at {f['vlm_layers']} (one group) "
          f"against 1601 image rows, its self cache's layers split over the "
          f"batch axes")
    layout = MeshLayout(c["mesh"], c["axes"])
    ref, ref_s = {}, {}
    for fam in FSDP_FAMS:
        t0 = time.perf_counter()
        ref[f"{fam}_serve"] = fsdp_serve_reference(fam, layout, c)
        gc.collect()
        torch.cuda.empty_cache()
        ref[f"{fam}_train"] = fsdp_train_reference(fam, layout, c)
        gc.collect()
        torch.cuda.empty_cache()
        s, t = ref[f"{fam}_serve"], ref[f"{fam}_train"]
        ref_s[fam] = time.perf_counter() - t0
        ctl = ", ".join(n for n in ("serve", "train")
                        if "f32" in ref[f"{fam}_{n}"])
        print(f"[{tag}] {fam} whole-model run: {s['weights_gb']:.3f} GB "
              f"served, prefill step {s['ms']['prefill_step_ms']:.3f} ms, "
              f"decode {statistics.median(s['ms']['decode_ms']):.3f} ms a "
              f"step; training step 1 (loss and gradients) "
              f"{t['step_ms']:.3f} ms, loss {t['loss']}, grad_norm "
              f"{t['grad_norm']}; {ref_s[fam]:.3f} s, its f32 controls "
              f"included ({ctl or 'none'})")
    t_ref = time.perf_counter() - t_phase
    fd, path = tempfile.mkstemp(suffix=".pt")
    os.close(fd)
    try:
        torch.save({k: {n: v for n, v in r.items() if n in (
            "ids", "tokens", "pins", "plain") or (n == "f32" and "plain" in r)}
            for k, r in ref.items()}, path)
        free, total = torch.cuda.mem_get_info()
        print(f"[{tag}] before the spawn: the card {free / 1e9:.3f} GB free "
              f"of {total / 1e9:.3f}; this process holds "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
              f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved")
        # the ranks' allocators map their blocks into growing segments:
        # 4 ranks near 18 GB each on the one card leave no room for the
        # blocks a fixed-size segment strands (4.2 GB on a cell-18 rank
        # before)
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        t1 = time.perf_counter()
        try:
            res = run_on_local_mesh(c["mesh"], c["axes"], fsdp_rank, path,
                                    tag, device="cuda", timeout=c["timeout"])
        finally:
            if alloc is None:
                os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        ranks_s = time.perf_counter() - t1
    finally:
        os.unlink(path)
    t2 = time.perf_counter()
    counts, out = fsdp_cell_checks(c, ref, res)
    out.update(reference_s=t_ref, reference_s_by_family=ref_s,
               ranks_s=ranks_s, checks_s=time.perf_counter() - t2,
               phase_s=time.perf_counter() - t_phase)
    print(f"[{tag}] cell {c['cell']}: phase {out['phase_s']:.3f} s: whole "
          f"runs {t_ref:.3f} s, ranks (the spawn) {ranks_s:.3f} s, checks "
          f"and kernel timings {out['checks_s']:.3f} s; K7-K9 launches on "
          f"the ranks {counts}")
    del res
    gc.collect()
    return counts, out


def main() -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    t_start = time.perf_counter()
    clock = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        print(f"[time] {phase} {now - clock[0]:.3f}")
        clock[0] = now

    name, smi = phase_device()
    import torch

    lap("device")
    build_s = phase_build()
    lap("build")
    rows, yardsticks = phase_kernels()
    lap("kernels")
    rows.update(phase_rmsnorm_kernels())
    lap("rmsnorm_kernels")
    fa_err, tc_res = phase_flash_kernels()
    lap("flash_kernels")
    launches, times = phase_main_path()
    lap("main")
    counts, hcounts, served = phase_serve(rows["rmsnorm_matmul"]["ms"])
    lap("serve")
    params = zoo_params()
    rcounts, replanned = phase_replan(params)
    lap("replan")
    ccounts, decoded = phase_continuous(params)
    del params
    lap("continuous")
    rows["flash_attention"], fcounts, lm = phase_lm(fa_err)
    lap("lm")
    bwd_small, f32_route = phase_flash_bwd_kernels(
        yardsticks["launch_floor_ms"])
    lap("flash_bwd_kernels")
    bwd_rows, k7_train = phase_bwd_timing(bwd_small)
    rows.update(bwd_rows)
    lap("bwd_timing")
    tcounts, trained = phase_train()
    lap("train")
    dcounts, driven = phase_driver()
    lap("driver")
    mcounts, moe_out = phase_moe(rows["flash_attention"]["max_abs_err"])
    rows["flash_attention"]["max_abs_err"] = moe_out["k7"]["max_abs_err"]
    for n, (d, _) in moe_out["train"]["bwd_err"].items():
        rows[n]["max_abs_err"] = max(rows[n]["max_abs_err"], d)
    lap("moe")
    scounts, ssm_out = phase_ssm()
    hy = ssm_out["hymba-1.5b"]
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], hy["k7"]["max_abs_err"])
    for n, r in hy["train"]["bwd"].items():
        rows[n]["max_abs_err"] = max(rows[n]["max_abs_err"],
                                     r["max_abs_err"])
    lap("ssm")
    vcounts, vlm_out = phase_vlm()
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], vlm_out["k7"]["max_abs_err"],
        vlm_out["k7_self"]["max_abs_err"])
    for n, r in vlm_out["bwd"].items():
        rows[n]["max_abs_err"] = max(rows[n]["max_abs_err"],
                                     r["max_abs_err"])
    lap("vlm")
    pcounts, spmd_out = phase_spmd()
    lap("spmd")
    def fold(k7: dict, bwd: dict) -> None:
        """The kernels line's max_abs_err: the largest of every rank's K7
        read in ``k7`` and K8/K9 read in ``bwd`` (a timed rank's a dict,
        another rank's a (max abs err, share) pair)."""
        rows["flash_attention"]["max_abs_err"] = max(
            rows["flash_attention"]["max_abs_err"],
            *(r["max_abs_err"] for r in k7.values()))
        for label, r in bwd.items():
            for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                d = r[n]["max_abs_err"] if "rank" not in label else r[n][0]
                rows[n]["max_abs_err"] = max(rows[n]["max_abs_err"], d)

    ((tpcounts, tp_out), (ttcounts, tp_train_out),
     (ecounts, ep_out)) = phase_tp_cells()
    fold(tp_out["k7"], tp_train_out["k8_k9"])
    fold(ep_out["k7"], ep_out["train"]["k8_k9"])
    lap("tp_cells")
    trcounts, tpr_out, tpv_out = phase_tp_families()
    fold(tpr_out["k7"], tpr_out["k8_k9"])
    fold(tpv_out["k7"], tpv_out["k8_k9"])
    lap("tp_families")
    fscounts, fsdp_out = phase_fsdp(FSDP)
    fold(fsdp_out["k7"], fsdp_out["k8_k9"])
    lap("fsdp")
    pdcounts, pod_out = phase_fsdp(POD)
    fold(pod_out["k7"], pod_out["k8_k9"])
    lap("pod")
    print(f"[time] total {time.perf_counter() - t_start:.3f}")
    for k, v in (*counts.items(), *hcounts.items(), *rcounts.items(),
                 *ccounts.items(), *fcounts.items(), *tcounts.items(),
                 *dcounts.items(), *mcounts.items(), *scounts.items(),
                 *vcounts.items(), *pcounts.items(), *tpcounts.items(),
                 *ttcounts.items(), *ecounts.items(), *trcounts.items(),
                 *fscounts.items(), *pdcounts.items()):
        launches[k] = launches.get(k, 0) + v
    replaces = {"cvt_color": "src/repro/kernels/harris.py:44",
                "corner_harris": "src/repro/kernels/harris.py:101",
                "convert_scale_abs": "src/repro/kernels/harris.py:124",
                "harris_fused": "src/repro/kernels/harris.py:247",
                "rmsnorm": "src/repro/kernels/rmsnorm.py:28",
                "rmsnorm_matmul": "src/repro/kernels/rmsnorm.py:67",
                "flash_attention": "src/repro/kernels/flash_attention.py:96",
                "flash_attention_bwd_dq":
                    "src/repro/kernels/flash_attention.py:206",
                "flash_attention_bwd_dkv":
                    "src/repro/kernels/flash_attention.py:223"}
    sources = {"rmsnorm": RMS_SOURCE, "rmsnorm_matmul": RMS_SOURCE,
               "flash_attention": FA_SOURCE,
               "flash_attention_bwd_dq": FA_BWD_SOURCE,
               "flash_attention_bwd_dkv": FA_BWD_SOURCE}
    kernels = [{"name": k, "route": "cuda", "source": sources.get(k, SOURCE),
                "replaces": replaces[k], "launches": launches[k],
                **{f: rows[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "kernel_route")
                   if f in rows[k]}}
               for k in replaces]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was never launched on the "
                                 f"main paths")
    print(json.dumps({"build_s": build_s, "main_path": times, **yardsticks,
                      "frame": [H, W], "frames": N_FRAMES,
                      "serve_transformer": served, "replan": replanned,
                      "continuous_decode": decoded, "serve_lm": lm,
                      "f32_route_driver_shape": f32_route,
                      "train": trained, "driver": driven, "moe": moe_out,
                      "ssm": ssm_out, "vlm": vlm_out, "spmd": spmd_out,
                      "tp": tp_out, "tp_train": tp_train_out,
                      "ep": ep_out, "tp_recurrent": tpr_out,
                      "tp_vlm": tpv_out, "fsdp": fsdp_out, "pod": pod_out,
                      "tc_resources": tc_res, "k7_train_shape": k7_train,
                      "k6_resources": rows["rmsnorm_matmul"]["resources"],
                      "local_layer": {n: {k: v for k, v in rows[n].items()
                                          if k.startswith("local_")}
                                      for n in ("flash_attention",
                                                "flash_attention_bwd_dq",
                                                "flash_attention_bwd_dkv")}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
