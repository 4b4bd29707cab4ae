"""Chip smoke test of paddle_tpu_torch on one CUDA card (H100).

    python3 chip_smoke.py [--seed N] [--phases a,b,...]

``--phases`` (or ``--only``) runs the named phases alone (development: no result line,
exit 0 when they pass); the phases run in the order below.

Phases (any failure exits non-zero before the result line):
  1. device   — prints the card's name and power limit (nvidia-smi);
                no CUDA device -> exit 1.
  2. build    — builds every kernel from paddle_tpu_torch/csrc with nvcc.
  3. check    — each kernel against its plain PyTorch version on the card
                at the main path's shapes (int8_matmul at the decode M and
                at every prefill bucket the serve, pressure and prefix
                phases' prompts fill;
                paged_attention also at max_len 4096 with slots at pos
                4095 and 0), in f32 and with bf16 and float16 operands
                (K3: the pairs of q and pool dtypes); |kernel - plain| must
                stay within 1e-4 + 1e-4 * |plain| in f32 (sums in another
                order), 1e-3 + 8e-3 * |plain| with bf16 (one bf16 unit) and
                1e-4 + 2e-3 * |plain| with float16 (one float16 unit), and
                two calls must give bit-equal results.
  4. time     — device times (a CUDA graph replayed, CUDA events) of each
                kernel, its plain version and a PyTorch library call on the
                same inputs, over a sweep of 24 layers' distinct tensors (the
                weights / KV do not fit the 50 MB L2, as in a real decode
                step), beside the bound; "call_ms" is the kernel called
                eagerly, host launch cost included.  paged_attention is
                also timed at the serve phase's own positions, and
                int8_matmul at the largest prefill bucket; both in f32 and
                in bf16 (rows "paged_attention_bf16", "int8_matmul_bf16"),
                and in float16 (a "time f16" line beside the bf16 row).
  5. serve    — GPT-2 medium (24 x 1024, vocab 50304), random weights from
                --seed, int8 weight-only, paged KV (block 16, 8 slots,
                max_len 1024): warmup must capture every program as a
                CUDA graph (one prefill per bucket, the decode chunk
                all-greedy and mixed: len(buckets) + 2).  8 requests
                (prompts 32..400, 64 new tokens, 6 greedy + 2 sampled)
                through the captured engine; kernel launch counters are
                zeroed just before and read just after (the engine adds
                each graph's K3 / K4 launches at every replay); both must be
                > 0.  The same requests then run through the same program
                functions uncaptured: greedy streams must be equal, and no
                program may be captured after warmup.  Then one decode
                step's logits on the kernel path are held against the same
                step run by the plain versions (on the CPU) on the same KV
                state, the decode step is profiled captured and uncaptured
                (wall, device busy, idle share, kernels per step; the
                graph's replay span by CUDA events), and greedy agreement
                with solo generate() is printed.  Then the same for the
                model decorated to bf16 (amp.decorate O2, then int8) on
                bf16 pools (ServingEngine(dtype=torch.bfloat16)): K3/K4
                launch on bf16 operands, and the logits stay within 5% of
                their largest |value| of the CPU plain path.  Each run
                prints tokens/s, TTFT p50 and max, warmup seconds and the
                capture count, captured and uncaptured.
  5b. telemetry — the serve configuration on one captured engine with
                profile=False and profile=True in turns (off, on, on, off),
                the serve traffic each time: tokens/s and TTFT p50 of each
                run and setting; the serving_ttft_seconds histogram must
                count the 8 requests and it plus
                serving_inter_token_seconds the 512 tokens; profile=True
                must open one serving_prefill span per request and one
                serving_decode span per decode step, profile=False none;
                K3 / K4 launches and greedy streams equal in every run;
                post_warmup_compiles() 0.  Prints the program registry's
                records of the engine's names (captures, capture seconds,
                bytes, replays), then a torch.profiler window over 3
                decode steps: every K3 / K4 kernel in it must lie inside
                a serving_decode range, their counts equal to the launch
                counters'.
  6. pressure — the serve model (f32) on a paged pool of 224 blocks where
                512 back every slot: 16 requests (prompts 200..400, 256 new
                tokens, 12 greedy + 4 keyed-sampled), first on the full
                pool, then on the short one, each engine captured.  On the
                short pool runs must be preempted and parked (at least
                one), every one resumed, none failed, and every stream must
                equal the full pool's token for token.  K3 / K4 launches
                counted through the replays of each run (zeroed just
                before, read just after) must be > 0.  Prints tokens/s,
                TTFT and the ms of each preemption and restore.
  7. prefix   — the serve model with prefix_cache=True against the same
                engine without: one request of a 384-token prefix plus 16
                tokens fills the cache, then 16 greedy requests of the
                prefix plus 16..96 tokens and the bare prefix (24 full
                blocks: copy-on-write), 64 new tokens each.  The cache must
                hit, copy once, capture nothing after warmup and leave the
                prefix's 24 blocks unchanged bit for bit; K3 / K4 must
                launch; a stream may split from the uncached engine's only
                where the uncached path's top-two logit margin is below
                2e-3 (each split printed with its margin).  Prints TTFT p50
                and max with and without the cache, and the device ms of a
                warm prefill (bucket 64 at cached_len 384) against a cold
                one (bucket 512; and the uncached engine's bucket 512).
  8. spec     — speculative decoding on the serve model (f32 pools) with
                a draft of GPT-2 small's widths (12 x 768, 12 heads, vocab
                50304, int8, random weights from --seed + 4), spec_tokens=4:
                K3 and K4 checked against their plain versions at the spec
                path's shapes (K3: the draft's 8 x 12 heads and the verify's
                40 flattened rows, tables repeated per row, pos + j; K4:
                the verify's M = 40 on GPT-2 medium's Linears, the draft's
                M = 8 and its prefill buckets on GPT-2 small's), K3 timed
                at the verify shape beside two bounds (the flattened rows'
                K/V bytes and the live K/V bytes read once); then the serve
                phase's 8 requests through the plain engine, the
                speculative engine captured (warmup captures len(buckets)
                + 2, none after; K3 / K4 must launch through the replays,
                counters zeroed just before) and the same uncaptured: all
                streams captured == uncaptured, and each greedy stream
                equals the plain engine's or splits where the plain path's
                top-two margin is below 2e-3 (printed).  One verify tick's
                logits on the kernel path within 2e-3 of the plain path on
                the CPU, same KV state.  Prints tokens/s, TTFT, the accept
                rate and tokens per slot per tick, and a profiled tick
                (wall, device, idle share, kernels, replay span) of both
                engines.
  9. lora     — batched multi-adapter LoRA on the serve model (f32 pools):
                five artifacts made by the port's apply_lora (rank 8, the
                default targets qkv / proj / ffn_in / ffn_out, A drawn by
                LoRALinear, B at std 0.01, from --seed) + export_adapter
                on copies of the served int8 model; the serve phase's 8
                requests spread over the base (2) and four adapters,
                through the plain engine, then a LoRA engine
                (LoRAConfig(rank=8, max_adapters=8), check_base_hash on)
                captured and uncaptured.  Gates: warmup captures
                len(buckets) + 2 and none follows, across a hot
                load_adapter of the fifth artifact while the engine loop
                serves too; K3 / K4 launch through the LoRA engine's
                replays; captured == uncaptured; the base requests'
                streams equal the plain engine's; each greedy adapter
                stream equals the request served alone, or splits where
                the adapter path's top-two margin is below 1e-3 (printed);
                at least one adapter stream leaves the base's within 16
                tokens; one decode step's logits with the four adapters
                live within 2e-3 of the plain path on the CPU, same KV
                state and stacks.  Prints tokens/s and TTFT against the
                plain engine, the profiled decode step (wall, device,
                idle share, kernels, replay span), the adapter gathers +
                bmm alone per step and their share, the stacks' memory
                and the ms of the hot load.  Then LoRA training: an f32
                GPT-2 medium with apply_lora (rank 8), B 2 x S 512,
                TrainStep + AdamW on the factors, 3 captured steps: finite
                losses, every base tensor bit-unchanged, every lora_B
                moved, K1 and K2 24 launches each per step through the
                replays, the exported adapter read back by read_adapter.
  9b. beam     — generate(decode_strategy="beam_search", num_beams=4) on
                the serve model (int8, f32), B 2 x prompt 128, 64 new
                tokens: ms per token; K4 launched 4 x 24 x 64 times;
                num_beams=1 equals greedy generate(); each score within
                1e-3 of its tokens' teacher-forced log-prob; a 2-layer
                full-width copy's beams on the card equal the CPU plain
                path's (or, at a near tie, the card's best beam scores
                within 1e-3 of the CPU's on the CPU path).
  9c. spec_bf16 — after the bf16 serve run: the bf16 serve model with a
                bf16-decorated int8 draft on bf16 pools, spec_tokens=4,
                the serve traffic, captured, against the plain bf16
                engine: K3 / K4 launch, nothing captured after warmup,
                each greedy stream equal to the plain engine's or split
                where the plain path's top-two margin is below 5% of the
                largest |logit|; tokens/s and the accept rate.
 9d. gateway  — the serving front door: GPT-2 medium (random weights from
                --seed) saved by jit.save (weights and metadata), served by
                create_predictor(Config(prefix).enable_serving(
                model_provider=..., quantize="int8", kv="paged", block 16,
                8 slots, max_len 1024, decode_chunk 4, gateway={gold:
                weight 4, high allowed; free: weight 1, low only})).  The
                serve phase's 8 requests from "free" at low priority and,
                once they hold the 8 slots, 4 from "gold" at PRIORITY_HIGH
                (prompts 64..256, 64 new tokens): the gateway preempts low
                decodes, runs the high ones, resumes the low ones.  Gates:
                preemptions >= 1 and resumes equal to them, no high request
                preempted, every response terminal, no capture after
                warmup, K3 / K4 launched (counters zeroed just before);
                every greedy stream equals the same request's through the
                plain engine (the same engine driven without the gateway)
                or splits where its top-two margin is below 2e-3; sampled
                streams equal.  Then one streamed POST /v1/completions over
                serve_http(port=0) on 127.0.0.1: its SSE tokens equal the
                gateway's stream; /healthz says warm, /metrics carries
                gateway_* series.  Then a run preempted from the paged
                engine crosses encode_run -> run_to_bytes -> run_from_bytes
                -> decode_run into a fixed-KV engine of the same model and
                continues the uninterrupted stream.  Prints tokens/s
                against the plain engine, TTFT p50 per lane, preemptions
                and resumes with ms each, the blob's MiB and the codec's ms,
                and profile_report()'s keys.
 9e. fleet    — the in-process serving fleet: two replicas of the gateway
                phase's engine options (int8 GPT-2 medium, paged, 8 slots,
                max_len 1024, decode_chunk 4) built over ONE model (each
                engine serves its own copy of the weights), behind a
                started ServingGateway over the FleetRouter, and a plain
                engine of the same options (the uninterrupted streams, then
                the refresher's oracle).  16 requests (prompts 32..400, 64
                new tokens, 12 greedy with resubmit, 4 keyed-sampled, four
                sessions of two) clean (tokens/s against the plain
                engine), then with PDTPU_FAULT_REPLICA_CRASH mid-decode:
                greedy streams equal the plain engine's (or split at a near
                tie), the lost replica's sampled runs end in
                ReplicaLostError, sessions held, exactly the one injected
                crash; the crashed replica's remove frees its footprint.
                A rollout while a second wave's 8 prompts keep arriving (12
                in flight): every boot captures under traffic, every drain
                migrates residents mid-decode through the codec, streams
                equal, nothing dropped, no capture after warmup on the old
                replicas, the card's memory after each remove within 2% of
                a replica's footprint of its level before the matching
                boot.  WeightPublisher + FleetRefresher: a second seed's
                weights through the three gates onto both replicas (canary
                streams equal the oracle's), a corrupt publish quarantined,
                a diverging canary rolled back, /healthz 200 with both
                verified.  The Autoscaler (injected clock) from one replica
                up on a burst and down by a drain.  Prints tokens/s, the ms
                from the crash to the first resubmitted token, ms per
                migrated run, boot capture seconds and the inter-token p99
                during the captures against outside them, flip / canary /
                rollback ms, a replica's memory and its weight copy's, and
                K3 / K4 launches over the phase and per replica.
 9f. worker   — serving replicas in processes of their own: two
                ``python -m paddle_tpu_torch.serving.worker`` processes
                with the fleet phase's engine options behind a FleetRouter
                driven on this thread, each building GPT-2 medium int8 by
                ``chip_smoke:worker_model`` (a seeded CPU draw, the same as
                this process's oracle engine) and capturing its graphs in
                its own CUDA context; boot seconds from spawn to ready.
                The fleet phase's 16 requests: streams equal the oracle's
                (greedy may split at a near tie), each worker's K3 / K4
                launches over the wave, read from the worker, > 0 and equal
                to its programs' replays times their recorded counts (96 /
                384 per decode replay), nothing captured after warmup;
                tokens/s against the oracle and the fleet phase's
                in-process pair.  The same wave with one worker SIGKILLed
                at 8 tokens: its greedy runs finish on the peer (ms from
                the kill to the first resubmitted token), its sampled runs
                end in ReplicaLostError, one fence; the supervised restart
                serves equal streams.  replica_wedge armed over the wire:
                the fence's latency against heartbeat_timeout_s (3 s), the
                kill after the grace.  A --listen worker attached with the
                oracle's jit.save int8 weights shipped in checked chunks
                (ship and attach seconds, equal streams), then flipped by
                path to a second seed's weights (ms; streams equal the
                swapped oracle's, nothing captured).
 9g. programs — program sets (``programs/``) on the worker phase's
                engine options: a set saved from a warm in-process engine
                (its manifest, per-program records and the kernel
                libraries its graphs launch); one worker booted from it
                under a fresh, empty PDTPU_PROGRAM_CACHE_DIR must run no
                nvcc (its store and build misses 0, read from the
                process), serve streams equal to the saving engine's, and
                launch K3 / K4 its programs' replays times their recorded
                counts (96 / 384 per decode replay); the same worker booted
                without the set under another empty store (its nvcc
                builds counted); boot seconds of both.  A set with one
                byte flipped: the engine refuses it with ProgramSetError,
                and the predictor's fallback boots fresh and counts
                program_set_fallback_total.  Prints the phase's seconds.
 9h. serve_f16 — GPT-2 medium decorated to float16 (amp.decorate O2,
                as the reference's engine serves it), int8, on float16
                paged pools, captured: the serve phase's 6 greedy
                requests, K3 / K4 launched on their float16 routes,
                nothing captured after warmup, each stream equal to solo
                generate()'s or split where the top-two margin is below
                2e-2 (a few float16 units of the logits; printed).
 10. fixed    — 4-layer full-width engines on the fixed pool, captured, f32
                and bf16: greedy streams must equal the uncaptured path's,
                and in f32 solo generate()'s.  Then the captured f32 engine
                swaps in another draw of the weights (swap_weights): in
                place, nothing captured, streams equal solo generate() on
                the new weights.
 11. flash    — the tensor-core instructions (HMMA / HGMMA lines of
                cuobjdump -sass) of every kernel in the built flash
                library, failing if a 16-bit (tensor-core route, bf16 and
                float16) kernel has none; the flash kernels K1 (forward)
                and K2 (backward) against their plain versions on the card
                at the training shape (B 4, S 1024, H 16, D 64, causal,
                dropout 0.1, fixed seed) in bf16, float16 and f32, and at
                small shapes with a bias, segment ids, Sk != Sq (a dQ over
                8 key tiles in float16), D 128 and D 256, in every type
                (every gradient, dbias included; float16 within 2e-3 +
                2e-3 * |plain|); two K2 calls at the training shape must
                give bit-equal gradients in bf16 and in float16, and the
                peak memory of one call is printed; then timed like K3/K4
                over 24 layers' tensors in bf16 and float16, beside the
                bound and torch's scaled_dot_product_attention as the
                yardstick (the kernel table keeps the bf16 rows; a "time
                f16" line per kernel).
 12. train    — GPT-2 medium (24 x 1024, 16 heads, vocab 50304), B 4,
                S 1024, O1 bf16, AdamW(1e-4), dropout 0.1, random weights
                and one random batch from --seed, through jit.TrainStep's
                captured step: warmup() captures the step's CUDA graph
                (timed; no capture may follow), 8 steps replay it, each
                loss printed, steady step time and tokens/s; the loss must
                be finite and fall, and K1/K2 must launch 24 times per
                step each through the replays (counters zeroed just before
                the steps).  A steady step is profiled (wall, device busy,
                idle share, kernels), and one uncaptured step gives the
                peak memory.  Then the same 8 steps uncaptured (the same
                program functions without the graph, from the same seed):
                losses must be bit-equal to the captured run's.  Then 3
                captured steps under recompute_policy("stages") with
                "dots_saveable" and with "nothing_saveable": losses within
                1e-5 relative of the plain run's (bit-equality expected;
                both printed), K1 48 and K2 24 launches per step, peak
                memory below the plain run's, device time printed.
 12b. the train phase's captured leg also checks that the
                train_step_seconds histogram counted its 8 steps.
 13. traincheck — one step's loss and every parameter's gradient of a
                2-layer full-width f32 GPT (dropout 0, B 1, S 1024) on the
                kernel path against the same step by the plain versions on
                the CPU, same weights and batch.
 13b. guard    — GPT-2 medium TrainStep(guard=True) (the train phase's
                model, batch and O1 step), captured with
                PDTPU_FAULT_NAN_GRADS=3 armed: 5 steps; step 3's guard is
                false and leaves the parameters and both moments
                bit-equal, the others are true and move them; K1 / K2 24
                launches per step through the replays; nothing captured
                after warmup; ms per step by CUDA events printed.
 13c. amp16   — GPT-2 medium in float16 at the train phase's batch.  (a)
                4 eager steps under auto_cast(dtype="float16"):
                scaler.scale(loss).backward(), scaler.step(opt),
                opt.clear_grad(): finite losses, K1 / K2 24 launches per
                step.  (b) GuardedTrainStep(TrainStep(O1 float16,
                guard=True), scaler=GradScaler()), captured by warmup with
                PDTPU_FAULT_NAN_GRADS=3:6: step 3 leaves every state tensor
                bit-equal, halves the scale once and writes one
                quarantine.jsonl record.  (c) After step 2
                AsyncCheckpointManager saved the step's state (its stall on
                the training thread printed against CheckpointManager.save
                of the same 4 GiB); steps 4 and 5 are bad too, and the
                third bad step rolls back: parameters bit-equal to those
                saved, the scaler's state the saved one.  Nothing captured
                after warmup; K1 / K2 24 launches per step; the guarded
                float16 ms per step printed beside the guard phase's bf16.
 13d. dlrm    — DLRM at the Criteo Kaggle widths of the DLRM reference
                implementation's dlrm_s_criteo_kaggle.sh: 13 dense
                features, bottom MLP 13-512-256-64-16, 26 tables of the
                Kaggle sizes in one f32 table (33,762,577 x 16, 2.16 GB),
                top MLP 512-256-1, B 128; ids drawn per feature from a
                power law (zipf 1.2, so rows repeat), labels
                Bernoulli(0.25), all from --seed.  TrainStep with Adam:
                sparse (Embedding(sparse=True), the lazy row update in the
                captured step) and dense, 5 captured steps each: the first
                step's loss and state sparse == dense within 1e-6, one
                uncaptured sparse step == the captured one within 1e-6,
                rows no batch touched bit-equal after the 5 sparse steps,
                finite losses; ms per step (CUDA events), peak memory,
                lookups and unique rows per step and a profiled step of
                each printed.
 13e. trainexport — the train phase's model and batch (GPT-2 medium, O1
                bf16, AdamW, dropout 0.1) through save_train_program and
                TrainSession, 3 steps against TrainStep's 3 from the same
                state: losses within 2e-2 (dropout draws differ: the
                session's masks come from its key), K1 / K2 24 launches per
                step through the session's replays (steps 2-3: the first
                step's capture runs a warm step), ms per step of both.
 13f. tostatic — GPT-2 medium's f32 eval forward (B 4 x S 1024, twice,
                and B 2 x S 1024) through jit.to_static: logits within 2e-3 of
                eager, one capture per signature (two calls of the first),
                K1 24 launches per replay (48 at a signature's first call:
                the capture's warm run and its replay), ms per call
                against eager.
 14. bert     — BERT-large / ERNIE-large pretraining (BASELINE configs #3
                and #4 as bench.py measures them: B 8 x S 512, O1 bf16,
                AdamW(1e-4) with decay off for biases and norms, dropout
                0.1, vocab 30528 / 18000, random weights and batches from
                --seed).  (f) first: K1 / K2 at BERT's attention shape
                (H 16, D 64, non-causal, the padding bias of lengths
                128..512, dropout 0.1) against their plain versions in
                bf16 and f32, then timed per layer over 24 layers' tensors
                beside the bound (the visible pairs), SDPA with the
                (B, 1, 1, S) mask, and each without the bias.  (a)
                BERT-large on bench.py's batch (no mask), 8 steps
                captured and 8 uncaptured: losses finite, falling and
                bit-equal, K1 / K2 24 launches per step each through the
                replays, one capture by warmup and none after; tokens/s,
                steady wall, device ms, idle share, kernels per step, peak
                memory.  (b) the same with the padding mask (lengths
                128..512), two segments, MLM labels on 15% of the real
                tokens (-100 elsewhere).  (c) ERNIE-large (relu, task
                ids).  (d) BERT-large at dropout 0 under
                LinearWarmup(PolynomialDecay) stepped once per step: a
                checkpoint after step 4 (under build/bert_resume, removed
                after), restored into a fresh warmed-up step: steps 5-8
                bit-equal to the uninterrupted run's, each step's lr the
                scheduler's, no capture at the restore; the checkpoint's
                size and the save / restore seconds.  (e) one f32 step of
                a 4-layer full-width BERT with the padding mask on the
                kernel path against the CPU plain path (loss 1e-4
                relative, gradients 1e-3 of each tensor's largest value).
 14b. predictor — the one-shot Predictor: a BERT-large sequence classifier
                (bert_large_config(vocab_size=30528,
                max_position_embeddings=512), 2 labels, eval, random
                weights) exported by jit.save with input_spec [InputSpec(
                [-1, 512], "int64")] * 2 (ids and the padding mask: K1's
                (B, Sk) bias), loaded by create_predictor(Config(prefix))
                and run at B 8 with lengths 128..512: K1 must launch 24
                times per run through the exported program's operator
                nodes; the logits within 2e-3 of the eager port model on
                the card, and the eager model within 2e-3 of its CPU plain
                path (2 rows).  Prints export and load seconds and ms per
                run against the eager module.
 15. bn       — the fused BatchNorm kernels K5-K9 against their plain
                versions on the card: at the ResNet-50 b256 main path's
                shapes (the stem, 3,211,264 x 64; layer1's bn3 with its
                residual, 802,816 x 256; layer4, 12,544 x 2048) and at
                small odd shapes (C 24 and 40, M no multiple of any
                block), f32 and bf16, every activation, no / plain / dual
                residual; then the three autograd Functions (outputs,
                statistics, dx / dgamma / dbeta / dres) against autograd
                of the plain references.  Kernels: f32 within 1e-5 of each
                tensor's largest |value|, bf16 within one bf16 unit
                (1e-2 + 1e-2 * |plain|).  Functions: f32 within 1e-4 of
                each tensor's largest |value|, bf16 within 2e-2 of it
                plus 2e-2 * |plain|, at most one element in a million off
                (an activation mask flipped by statistics summed in
                another order).  K9 (bn_pool_apply) takes its ring route
                where the row slots fit (the bf16 stem must; rings of up
                to 28 slots are checked) and its window route elsewhere
                and for a bf16 average; both are checked, max bit-equal
                to the plain version, a bf16 average within one bf16
                unit (2**-7 of the larger value, plus 1e-5 of the largest
                |value|), two calls bit-equal.  Then each kernel timed
                (CUDA graph replay) at layer1's bn3 and at the stem, beside
                its bound, its plain version and PyTorch's own BatchNorm
                kernels; K9's ring route in turns with its window route.
                Also K9 at VGG-16-BN's five pooled sites (bf16, max
                2x2/2/0, N 256) on the route its plan takes and on the
                other one (the ring under a hand-made plan of 4 slots
                where the plan takes the window route), and K5-K8 (bf16
                and f32) at every distinct fused BatchNorm shape of the
                conv nets at b256 x 224^2: VGG-16-BN's five (relu; up to
                12,845,056 x 64, K5 there the pooled sites' statistics
                too), MobileNetV1's ten (relu), MobileNetV2's twelve relu6
                and five residual ones, and relu6 with the residual.
 16. resnet   — ResNet-50 (BASELINE config #2): resnet50() under
                jit.layout_policy("NHWC"), TrainStep O2 bf16, cross-entropy
                on the logits, Momentum(0.1, 0.9), one random batch of
                256 x 3 x 224 x 224 from --seed, 8 steps through the
                captured step (as the train phase: warmup captures, no
                capture follows): each loss printed (all finite), the
                steady step's wall, images/s, device busy and idle share,
                the top device entries with the cuDNN convolutions and
                K5-K9 summed apart, K5-K9 launches per step through the
                replays (asserted against the counts derived from the
                model's blocks; K9 on its ring route), layout copies per
                step, peak memory.  Then the same 8 steps uncaptured
                (losses bit-equal; its profile puts the stem's plain
                backward recompute, _BnPool.backward, on a line of its
                own), and 3 captured steps under recompute_policy("stages")
                (losses within 1e-5 relative, K5 / K6 launched again at
                every block site: 105 / 96 per step, peak memory below the
                plain run's).  Then K7 and K8 timed at each of the step's
                48 BN backward sites' shapes beside each site's bound.
 17. resnetcheck — one f32 step of ResNet-18 (10 classes, 4 x 3 x 64 x 64)
                on the kernel path against the same step by the plain
                versions on the CPU, same weights and batch: the loss,
                every gradient and every running statistic within 1e-3 of
                its tensor's largest |value|.
 18. mobilenet — MobileNetV1 at full width (scale 1.0, 1000 classes) with
                the resnet phase's recipe (b256 x 224^2, O2 bf16, NHWC,
                Momentum(0.1, 0.9)), TrainStep over model(x, labels)'s
                mean (the fused pool + classifier + cross-entropy tail), 8
                captured steps and the same uncaptured (losses bit-equal;
                the tail's "fused_ce" range on a line of its own); then
                MobileNetV2 at full width, captured, on its logits.  K5-K9
                launches per step asserted against the models' fixed
                counts (V1 27 / 27 / 27 / 27 / 0; V2 45 fused of its 52
                BatchNorms, ten with the residual fused in, the seven
                projections without a shortcut plain batch_norm), V1's
                layout copies 0 (V2's printed); images/s, device ms, idle,
                peak, profile groups.
 19. vgg      — vgg16(batch_norm=True), 1000 classes, b256 x 224^2, O2
                bf16, NHWC, Momentum(0.01, 0.9), 4 captured steps: K5-K9
                launches per step 13 / 8 / 8 / 8 / 5 and K9's routes
                asserted (each pooled site's route printed); then 2 steps
                uncaptured (losses bit-equal) whose profile puts the
                pooled sites' plain backward recompute on a line of its
                own.  (The bn phase holds K9 at the five site shapes on
                both routes.)  The resnet phase also runs ResNet-50
                through model(x, labels) (3 captured steps: the first
                loss within 2e-2 of the logits leg's, the same launches
                per step).
 20. convcheck — one f32 step of MobileNetV2 (scale 0.5, 10 classes, 8 x 3
                x 96 x 96) on the kernel path against the CPU plain path,
                then with PDTPU_FUSED_BN=0 on the card (no K5-K9 launch,
                one composite call per fused site) against the kernel
                path: the loss within 1e-4; the whole gradient within
                2e-2 in norm and cos 0.999, and each gradient tensor within
                5e-2 of the other run's in norm, or elementwise within
                1e-4 where it is zero by the math (beside the CPU's own
                spread under a 1e-7 relative change of the input, measured
                in the same run); running statistics within 1e-3.
 21. lenet    — LeNet on synthetic MNIST-shaped data (64 x 1 x 28 x 28,
                10 classes, from --seed): 20 eager Adam steps with a
                falling loss, then a captured TrainStep bit-equal to the
                same steps uncaptured.
 22. qat      — ImperativeQuantAware over MobileNetV1 (b32 x 224^2, f32,
                eager, 3 steps, K5-K8 27 per step, the act_scale buffers
                move); PostTrainingQuantization of a fresh one (2
                calibration batches): each converted layer within 1e-4 of
                the CPU's on the same input (the gate), the logits' end
                to end distance printed (a value at an activation grid's
                rounding boundary may land on either side); finite logits
                of shape (8, 1000); save_quantized_model +
                jit.load: the same logits within 1e-4.
 23. parallel — the parallel path on a one-rank NCCL group (a FileStore in
                a temporary directory) and create_mesh({"dp": 1}): GPT-2
                medium (dropout 0, B 4 x S 1024) through
                fleet.distributed_train_step with sharding stage 2,
                recompute and O1 bf16 (AdamW 1e-4), PARALLEL_STEPS steps,
                then stage 3 for PARALLEL_FSDP_STEPS: each loss within
                1e-3 relative of TrainStep(amp_level="O1", remat=True)'s
                on the same weights and batch, K1 / K2 launches per step
                equal to that step's; ms per step, tokens/s, peak GiB, the
                NCCL kernels' device ms per step (the phase fails when a
                profiled step runs none, or when the step was not captured
                as a CUDA graph).  The same model through
                gpt_pipeline_step(n_micro=4, remat=True) on the pp=1 mesh,
                "gpipe" and "1f1b", PIPE_STEPS steps each: losses within
                1e-3 of each other and the first of the sharded leg's,
                1F1B's temp_bytes below GPipe's.  ResNet-50 (b256 x 224^2,
                O2 bf16, NHWC, Momentum(0.1, 0.9)) through
                ShardedTrainStep, PAR_RESNET_STEPS captured steps: K5-K9
                launches per step equal to TrainStep's, the statistics
                all-reduces per step two per fused site, the first loss
                within 2e-2 of TrainStep's.  ring_attention at sp=1, (2,
                2048, 16, 64) f32, causal and not, output and gradients
                against the naive softmax at 2e-4.
Before the last line it prints one JSON line with every kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

TOL = 1e-4          # |kernel - plain| <= TOL + TOL * |plain|
# K3 / K4 on bf16 operands, (atol, rtol): kernel and plain version both
# compute in f32 and round once to bf16, so f32 values that differ in
# their last bits may round to neighbouring bf16 values: one bf16 unit
# (8e-3 > 2**-7, a unit's largest relative size)
BF16_TOL = (1e-3, 8e-3)
# the same on float16 operands: one float16 unit (2e-3 > 2**-10)
F16_TOL = (1e-4, 2e-3)
LOGIT_TOL = 2e-3    # kernel-path vs plain-path decode logits, max abs
# the same in bf16, as a share of the logits' largest |value|: the card
# and the CPU round the bf16 activations of 24 layers at other places
# (cuBLAS and the CPU's matmul, layer norm), a few bf16 units each
BF16_LOGIT_TOL = 5e-2
# flash kernels vs their plain versions, (atol, rtol): f32 outputs sum in
# another order; f32 gradients sum over up to 1024 rows; bf16 values are
# rounded to bf16 by both, one bf16 unit (2**-8 relative) apart at most;
# float16 the same with units eight times finer (2**-11 relative)
FLASH_TOL = {"float32": ((1e-4, 1e-4), (2e-4, 1e-3)),
             "bfloat16": ((1e-2, 1e-2), (1e-2, 1e-2)),
             "float16": ((2e-3, 2e-3), (2e-3, 2e-3))}
DT_SUFFIX = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}
# kernel-path vs CPU plain-path training step (f32, TF32 off): the loss
# within 1e-4 relative, each gradient within GRAD_TOL of its tensor's
# largest |gradient| (cuBLAS and the CPU sum in other orders)
GRAD_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
LAYERS = 24
SLOTS = 8
BLOCK = 16
MAX_LEN = 1024
PROMPT_LENS = (32, 64, 100, 160, 220, 280, 340, 400)   # serve phase
# pressure phase: 224 blocks where parity would give 512 (8 x 64); 16
# requests of 200..400 prompt tokens and 256 new ones, every 4th sampled
PRESSURE_BLOCKS, PRESSURE_NEW = 224, 256
PRESSURE_LENS = tuple(int(n) for n in np.linspace(200, 400, 16))
# prefix phase: 16 requests of one 384-token prefix plus 16..96 suffix
# tokens (buckets 16..128 of the suffix), and the bare prefix (24 full
# blocks: the copy-on-write path), 64 new tokens each
PREFIX_LEN, PREFIX_NEW = 384, 64
PREFIX_SUFFIXES = tuple(int(n) for n in np.linspace(16, 96, 16))
MARGIN_TOL = 2e-3   # a cached / uncached greedy split needs a nearer tie
FLEET_LENS = tuple(int(n) for n in np.linspace(32, 400, 16))   # fleet wave
FLEET_NEW = 64
FLEET_SAMPLED = (3, 7, 11, 15)   # keyed-sampled, no resubmit
FLEET_SESSIONS = {0: "s0", 1: "s0", 4: "s1", 5: "s1", 8: "s2", 9: "s2",
                  12: "s3", 13: "s3"}
FLEET_ROLL_LENS = (64, 80, 96, 112, 128, 144, 160, 72)   # rollout wave
FLEET_ROLL_NEW = 512
FLEET_ROLL_INFLIGHT = 12   # rollout wave requests kept unfinished
MEM_TOL = 0.02      # memory after a remove vs before its boot: of a replica
WORKER_HEARTBEAT_S = 3.0   # worker phase: the wedge fence's heartbeat age
WORKER_GRACE_S = 1.0       # and the grace before a wedged worker is killed
WORKER_BOOT_S = 600.0      # a worker's boot budget (spawn to ready)
WORKER_CHECK = 4           # greedy prompts served on a restarted / remote one
SPEC_TOKENS = 4     # spec phase: draft proposals per verify tick
# lora phase: LoRAConfig(rank, max_adapters) on the default targets; the
# artifacts' B factors are drawn at this std (A: LoRALinear's own draw,
# Normal(0, 1/rank)), which moves a projection's output by about as much
# as the base's own spread at GPT-2 medium's init
LORA_RANK, LORA_SLOTS, LORA_B_STD = 8, 8, 0.01
# the serve phase's 8 requests by adapter (None: the base); 3 and 6 sample
LORA_ADAPTERS = (None, "t1", "t2", "t3", "t4", None, "t1", "t2")
LORA_MARGIN_TOL = 1e-3   # a batched / solo adapter split needs a nearer tie
LORA_TRAIN_B, LORA_TRAIN_S, LORA_TRAIN_STEPS = 2, 512, 3
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 1024, 8               # train phase
PARALLEL_STEPS, PARALLEL_FSDP_STEPS = 5, 3      # parallel phase: sharded GPT
PIPE_STEPS = 3                                   # and each pipeline schedule
PAR_RESNET_STEPS = 3                             # and sharded ResNet-50
RING_SHAPE = (2, 2048, 16, 64)                   # ring attention at sp=1
# dlrm phase: the Criteo Kaggle tables of dlrm_s_criteo_kaggle.sh
CRITEO_KAGGLE = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3,
                 93145, 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652,
                 2173, 4, 7046547, 18, 15, 286181, 105, 142572)
DLRM_B, DLRM_STEPS = 128, 5
EXPORT_STEPS = 3                                         # trainexport phase
# bert phase: BERT-large / ERNIE-large as bench.py measures them
BERT_B, BERT_S, BERT_STEPS, BERT_VOCAB = 8, 512, 8, 30528
RECOMPUTE_STEPS = 3        # the train / resnet phases' recompute legs
TELEMETRY_RUNS = (False, True, True, False)   # profile= in turns
BEAM_B, BEAM_PROMPT, BEAM_NEW, BEAM_K = 2, 128, 64, 4   # beam phase
BEAM_CHECK_NEW = 16        # the 2-layer card-vs-CPU beam check
SCORE_TOL = 1e-3           # a beam's score vs its teacher-forced log-prob
GUARD_STEPS, GUARD_POISONED = 5, 3   # guard phase: steps, the NaN step
# amp16 phase: eager float16 steps under GradScaler; the guarded captured
# step's NaN window (steps 3..5, max_bad_steps 3: one skip-and-decay, then
# a rollback to the async checkpoint of step AMP16_SAVE_AT)
AMP16_EAGER_STEPS, AMP16_NAN, AMP16_SAVE_AT, AMP16_BAD = 4, (3, 6), 2, 3
# a float16 engine's greedy split from solo generate() must sit at a near
# tie: float16 logits round at 2**-11 relative (about 2.4e-3 at |logit| 5)
# on two paths that round at other places, so a few units apart
F16_MARGIN_TOL = 2e-2
RESNET_B, RESNET_HW, RESNET_STEPS = 256, 224, 8           # resnet phase
# the fused-BN kernels' main-path shapes at batch 256, as (N, H, W, C)
BN_STEM = (RESNET_B, 112, 112, 64)       # M = 3,211,264
BN_LAYER1 = (RESNET_B, 56, 56, 256)      # layer1's bn3, M = 802,816
BN_LAYER4 = (RESNET_B, 7, 7, 2048)       # M = 12,544
BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx",
              "bn_pool_apply")
LABELS_STEPS = 3           # the resnet phase's labels leg (the fused tail)
MOBILE_B, MOBILE_HW, MOBILE_STEPS = 256, 224, 8          # mobilenet phase
# the fused BatchNorm sites' distinct (H = W, C) at 224 x 224, b256:
# MobileNetV1's 27 sites (relu), MobileNetV2's 35 relu6 sites and its 10
# projections with the residual fused in (no activation)
MOBILE_V1_SITES = ((112, 32), (112, 64), (56, 64), (56, 128), (28, 128),
                   (28, 256), (14, 256), (14, 512), (7, 512), (7, 1024))
MOBILE_V2_RELU6_SITES = ((112, 32), (112, 96), (56, 96), (56, 144),
                         (28, 144), (28, 192), (14, 192), (14, 384),
                         (14, 576), (7, 576), (7, 960), (7, 1280))
MOBILE_V2_RESIDUAL_SITES = ((56, 24), (28, 32), (14, 64), (14, 96), (7, 160))
# K5-K9 launches of one training step (the models' fused sites, pinned on
# the CPU by test_torch_vision_models.py::test_fused_sites_per_step);
# MobileNetV2's 45 fused sites of its 52 BatchNorms are 35 relu6 sites
# and 10 residual ones, the other 7 plain batch_norm (projections without
# a shortcut); at any scale
MOBILE_V1_LAUNCHES = dict(bn_stats=27, bn_apply=27, bn_bwd_reduce=27,
                          bn_bwd_dx=27, bn_pool_apply=0)
MOBILE_V2_LAUNCHES = dict(bn_stats=45, bn_apply=45, bn_bwd_reduce=45,
                          bn_bwd_dx=45, bn_pool_apply=0)
MOBILE_V2_FORMS = dict(relu6=35, residual=10, plain=7)
VGG_B, VGG_HW, VGG_STEPS = 256, 224, 4                   # vgg phase
VGG_POOL = ("max", (2, 2), (2, 2), (0, 0))
# VGG-16-BN's five pooled BatchNorm sites at 224 x 224, as (N, H, W, C);
# its eight unpooled sites have the same five shapes
VGG_POOL_SITES = tuple((VGG_B, hw, hw, c) for hw, c in (
    (224, 64), (112, 128), (56, 256), (28, 512), (14, 512)))
VGG16_LAUNCHES = dict(bn_stats=13, bn_apply=8, bn_bwd_reduce=8, bn_bwd_dx=8,
                      bn_pool_apply=5)
# convcheck: each gradient tensor's relative distance from the other
# run's, above the CPU's own spread under a 1e-7 relative change of the
# input (up to 4.0e-2 at MobileNetV2's ReLU6 kinks; the card's 4.3e-3);
# a tensor whose gradient is zero by the math (rms under CONV_CHECK_ZERO:
# a bias or scale before a convolution and a BatchNorm, at init) is held
# elementwise within CONV_CHECK_ZERO instead
CONV_CHECK_TOL, CONV_CHECK_ZERO = 5e-2, 1e-4
LENET_B, LENET_STEPS = 64, 20                            # lenet phase
QAT_B, QAT_STEPS = 32, 3                                 # qat phase
BN_LINES = {"bn_stats": 119, "bn_apply": 132, "bn_bwd_reduce": 153,
            "bn_bwd_dx": 183, "bn_pool_apply": 611}


PHASES = ("check", "serve", "telemetry", "pressure", "prefix", "spec", "lora",
          "beam", "gateway", "fleet", "worker", "programs", "serve_bf16",
          "spec_bf16", "serve_f16",
          "fixed",
          "flash", "train", "traincheck", "dlrm", "trainexport", "tostatic",
          "guard", "amp16", "bert",
          "predictor", "bn", "resnet", "resnetcheck", "mobilenet", "vgg",
          "convcheck", "lenet", "qat", "parallel")


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters: int) -> float:
    """Mean ms per fn() called eagerly back to back (host launch cost
    included), after warm-up, by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(torch, fn, replays: int = 20) -> float:
    """Mean device ms of fn(): captured once as a CUDA graph and replayed,
    so host launch cost is out of the number; CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / replays


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def max_err(torch, got, want, atol=TOL, rtol=TOL):
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    return float(err.max()), ok


def prefill_buckets():
    """The prefill buckets (M of every prefill Linear) the serve,
    pressure and prefix phases' prompts (the prefix phase's: their
    uncached suffixes) land in, by the engine's own default bucket rule."""
    from paddle_tpu_torch.serving.engine import _default_buckets
    buckets = _default_buckets(MAX_LEN)
    lens = (PROMPT_LENS + PRESSURE_LENS + PREFIX_SUFFIXES
            + (PREFIX_LEN + PREFIX_SUFFIXES[0], 1))
    return sorted({min(b for b in buckets if b >= n) for n in lens})


def int8_phase(torch, rng, dev):
    """K4 checked at every M of the main path (8 decode slots and each
    prefill bucket) over one GPT-2-medium layer's four Linears, with f32,
    bf16 and float16 x, two calls bit-equal at each; timed per layer in
    each type at decode M and at the largest prefill bucket, swept over 24
    layers' weights.  Returns the f32 and the bf16 row of the kernel
    table; the float16 route's figures are printed beside the bf16 ones."""
    from paddle_tpu_torch.ops import _build, int8_matmul as im
    from paddle_tpu_torch.quantization import quantize_weight_int8
    shapes = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
    layers = []
    for _ in range(LAYERS):
        ws = []
        for k, n in shapes:
            w = torch.randn(k, n, device=dev) * 0.02
            ws.append(quantize_weight_int8(w))
        layers.append(ws)
    ms_at = [SLOTS] + prefill_buckets()
    xs_at = {mc: {k: torch.from_numpy(rng.randn(mc, k).astype(np.float32))
                  .to(dev) for k in (1024, 4096)} for mc in ms_at}
    sms = _build.sm_count(dev.index)
    rows = []
    for dt, (atol, rtol) in ((torch.float32, (TOL, TOL)),
                             (torch.bfloat16, BF16_TOL),
                             (torch.float16, F16_TOL)):
        name = "int8_matmul" + DT_SUFFIX[str(dt)[6:]]
        xs_dt = {mc: {k: x.to(dt) for k, x in xs.items()}
                 for mc, xs in xs_at.items()}
        err, ok = 0.0, True
        for mc in ms_at:
            for (k, n), (wi, s) in zip(shapes, layers[0]):
                x = xs_dt[mc][k]
                got = im.dequant_matmul(x, wi, s)
                again = im.dequant_matmul(x, wi, s)
                want = im._plain(x, wi, s)
                torch.cuda.synchronize()
                e, o = max_err(torch, got, want, atol, rtol)
                rep = torch.equal(got, again)
                o = o and got.dtype == dt
                err, ok = max(err, e), ok and o and rep
                print(f"check {name} M={mc} K={k} N={n} "
                      f"{im._plan(mc, k, n, sms, x.element_size())}: "
                      f"max_abs_err={e:.3e}"
                      f"{'' if o else ' OUT OF TOLERANCE'}"
                      f"{'' if rep else ' NOT BIT-REPEATABLE'}")
        if not ok:
            fail(f"{name} disagrees with its plain version or does not "
                 f"repeat ({err:.3e})")
        rows.append(_int8_time(torch, im, layers, shapes, xs_dt,
                               [SLOTS, ms_at[-1]], name, err))
    f16_line(rows[1], rows[2])
    return rows[:2]


def f16_line(bf16, f16):
    """One line with a kernel's float16 route beside its bf16 route, both
    timed in this call (the kernel table keeps one row per kernel)."""
    print(f"time f16 {f16['name']}: {f16['ms']:.4f} ms (bf16 "
          f"{bf16['ms']:.4f}; plain {f16['plain_ms']:.4f}; library "
          f"{f16['library_ms']:.4f}; bound {f16['bound_ms']:.4f} "
          f"{f16['bound_by']}; call {f16['call_ms']:.4f}); max_abs_err "
          f"{f16['max_abs_err']:.3e}")


def _int8_time(torch, im, layers, shapes, xs_at, ms, name, err):
    """K4's row of the kernel table: ms per layer (graph replay over 24
    layers' weights), plain and library times and the bound at decode M
    (and printed at the largest prefill M)."""
    def sweep(f, xs):
        def run():
            for ws in layers:
                for (k, n), (wi, s) in zip(shapes, ws):
                    f(xs[k], wi, s)
        return run

    def bound(m, elem):
        nbytes = sum(m * k * elem + k * n + 4 * n + m * n * elem
                     for k, n in shapes)
        return bound_ms(nbytes, sum(2 * m * k * n for k, n in shapes))
    lib_f = lambda x, wi, s: torch.matmul(x, wi.to(x.dtype) * s.to(x.dtype))
    out = {}
    for mc in ms:
        xs = xs_at[mc]
        elem = xs[1024].element_size()
        out[mc] = dict(ms=graph_ms(torch, sweep(im.dequant_matmul, xs)) / LAYERS,
                       plain=graph_ms(torch, sweep(im._plain, xs)) / LAYERS,
                       lib=graph_ms(torch, sweep(lib_f, xs)) / LAYERS,
                       bound=bound(mc, elem))
        print(f"time {name} M={mc}: {out[mc]['ms']:.4f} ms per layer "
              f"(plain {out[mc]['plain']:.4f}, matmul(x, w.to(x.dtype)*s) "
              f"{out[mc]['lib']:.4f}, bound {out[mc]['bound'][0]:.4f} "
              f"{out[mc]['bound'][1]})")
    d = out[ms[0]]
    eager = call_ms(torch, sweep(im.dequant_matmul, xs_at[ms[0]]), 10) / LAYERS
    return {"name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "paddle_tpu/ops/int8_matmul.py:49",
            "max_abs_err": err, "ms": d["ms"], "plain_ms": d["plain"],
            "bound_ms": d["bound"][0], "bound_by": d["bound"][1],
            "library_ms": d["lib"], "call_ms": eager}


def _paged_case(torch, rng, dev, pos_np, nb, h=16, d=64, block=BLOCK,
                layers=1):
    """q, per-layer (kpool, vpool), tables, pos for len(pos_np) slots:
    each slot owns nb table entries, the live ones from a random
    permutation of the pool, the tail holding the allocator's sentinel."""
    s = len(pos_np)
    num_blocks = s * nb
    tables_np = np.full((s, nb), num_blocks, np.int32)
    perm = rng.permutation(num_blocks)
    for i, p in enumerate(pos_np):
        live = min(-(-(int(p) + 1) // block), nb)
        tables_np[i, :live] = perm[i * nb:i * nb + live]
    q = torch.from_numpy(rng.randn(s, h, d).astype(np.float32)).to(dev)
    pools = [(torch.randn(num_blocks, block, h, d, device=dev),
              torch.randn(num_blocks, block, h, d, device=dev))
             for _ in range(layers)]
    return (q, pools, torch.from_numpy(tables_np).to(dev),
            torch.from_numpy(np.asarray(pos_np, np.int32)).to(dev))


def paged_phase(torch, rng, dev):
    """K3 at decode shapes: 8 slots, ragged pos 17..1000, block 16, the
    engine's default pool (8 * 64 blocks), sentinel tail entries; and a
    long context (max_len 4096, a slot at pos 4095 and one at pos 0); f32,
    bf16, float16 and the mixed dtype pairs (q and the pools); two calls
    bit-equal at each.  Times per layer in f32, bf16 and float16, swept
    over 24 layers' pools, at these positions and at the serve phase's own
    (each prompt plus 32 of its 64 new tokens).  Returns the f32 and the
    bf16 row of the kernel table; the float16 route's figures are printed
    beside the bf16 ones."""
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa
    h, d = 16, 64
    nb = MAX_LEN // BLOCK
    sms = _build.sm_count(dev.index)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    pos_np = np.array([17, 150, 300, 511, 512, 700, 901, 1000], np.int32)
    long_np = np.array([4095, 0, 2047, 3000, 17, 1023, 4000, 64], np.int32)
    q, pools, tables, pos = _paged_case(torch, rng, dev, pos_np, nb,
                                        layers=LAYERS)
    lq, lpools, ltables, lpos = _paged_case(torch, rng, dev, long_np,
                                            4096 // BLOCK)
    errs = {f32: 0.0, bf16: 0.0, f16: 0.0}
    ok = True
    for label, args in (("main", (q, *pools[0], tables, pos)),
                        ("max_len 4096", (lq, *lpools[0], ltables, lpos))):
        for qd, kvd in ((f32, f32), (bf16, bf16), (f32, bf16), (bf16, f32),
                        (f16, f16), (f32, f16), (f16, f32)):
            a = (args[0].to(qd), args[1].to(kvd), args[2].to(kvd),
                 *args[3:])
            got = pa.paged_attention(*a)
            again = pa.paged_attention(*a)
            want = pa._plain(*a)
            torch.cuda.synchronize()
            key = f16 if f16 in (qd, kvd) else bf16 if bf16 in (qd, kvd) \
                else f32
            atol, rtol = {f32: (TOL, TOL), bf16: BF16_TOL,
                          f16: F16_TOL}[key]
            e, o = max_err(torch, got, want, atol, rtol)
            o = o and got.dtype == qd
            rep = torch.equal(got, again)
            errs[key], ok = max(errs[key], e), ok and o and rep
            print(f"check paged_attention {label} q {str(qd)[6:]} pools "
                  f"{str(kvd)[6:]} S={a[0].shape[0]} H={h} D={d} "
                  f"block={BLOCK} "
                  f"{pa._plan(8, h, d, a[3].shape[1], sms, kvd.itemsize)} "
                  f"pos={a[4].tolist()}: max_abs_err={e:.3e}"
                  f"{'' if o else ' OUT OF TOLERANCE'}"
                  f"{'' if rep else ' NOT BIT-REPEATABLE'}")
    del lq, lpools, ltables, lpos
    if not ok:
        fail(f"paged_attention disagrees with its plain version or does "
             f"not repeat ({errs})")
    rows = []
    for dt in (f32, bf16, f16):
        dq = q.to(dt)
        dpools = pools if dt == f32 else [(k.to(dt), v.to(dt))
                                          for k, v in pools]
        rows.append(_paged_time(torch, pa, sms, dq, dpools, tables, pos,
                                pos_np, nb, errs[dt]))
        del dpools
        torch.cuda.empty_cache()
    f16_line(rows[1], rows[2])
    return rows[:2]


def _paged_time(torch, pa, sms, q, pools, tables, pos, pos_np, nb, err):
    """K3's row of the kernel table in q's and the pools' dtype (one
    dtype): ms per layer over 24 layers' pools, plain and SDPA times, the
    bound (the pools' element size sets the live K/V bytes)."""
    import ctypes
    from paddle_tpu_torch.ops import _build
    h, d = q.shape[1], q.shape[2]
    elem = pools[0][0].element_size()
    name = "paged_attention" + DT_SUFFIX[str(pools[0][0].dtype)[6:]]
    dev = q.device
    plan = pa._plan(SLOTS, h, d, nb, sms, elem)
    fits = ctypes.c_int(0)
    _build.check(_build.function(
        "paged_attention", "pdt_paged_attention_max_clusters",
        [ctypes.c_int] * 5 + [ctypes.c_void_p])(
            h, d, plan.hpb, plan.splits, pa._DTYPE_CODE[pools[0][0].dtype],
            ctypes.byref(fits)),
        "paged_attention max clusters")
    print(f"{name} plan {plan}: grid {plan.grid(SLOTS, h)}, "
          f"{fits.value} clusters of {plan.splits} resident at once")

    def kern(p):
        return lambda: [pa.paged_attention(q, k, v, tables, p)
                        for k, v in pools]

    def bound(p_np):
        rows = int(np.minimum(p_np + 1, nb * BLOCK).sum())
        nbytes = (rows * h * d * elem * 2 + 2 * q.numel() * q.element_size()
                  + tables.numel() * 4 + p_np.size * 4)
        return bound_ms(nbytes, 4.0 * rows * h * d)
    ms = graph_ms(torch, kern(pos)) / LAYERS
    eager = call_ms(torch, kern(pos), 10) / LAYERS
    plain = graph_ms(torch, lambda: [pa._plain(q, k, v, tables, pos)
                                     for k, v in pools], 5) / LAYERS
    # library yardstick: SDPA on views gathered beforehand (the gather
    # itself is not timed), masked to each slot's rows <= pos
    views = [tuple(pa.gather_block_rows(t, tables).permute(0, 2, 1, 3)
                   .contiguous() for t in kv) for kv in pools]
    t_idx = torch.arange(nb * BLOCK, device=dev)
    mask = (t_idx[None, :] <= pos[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fn():
        for k, v in views:
            sdpa(q4, k, v, attn_mask=mask)
    lib = graph_ms(torch, lib_fn) / LAYERS
    del views
    b, by = bound(pos_np)
    serve_np = np.array([n - 1 + 32 for n in PROMPT_LENS], np.int32)
    serve_pos = torch.from_numpy(serve_np).to(dev)
    serve_ms = graph_ms(torch, kern(serve_pos)) / LAYERS
    sb, _ = bound(serve_np)
    print(f"time {name} pos={pos_np.tolist()}: {ms:.4f} ms per layer "
          f"(plain {plain:.4f}, SDPA pre-gathered {lib:.4f}, bound {b:.4f}); "
          f"serve pos={serve_np.tolist()}: {serve_ms:.4f} ms per layer "
          f"(bound {sb:.4f})")
    return {"name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:109",
            "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib, "call_ms": eager}


def device_profile(torch, step, steps: int, what: str, card: str,
                   groups=None, top: int = 8, ranges=None):
    """Where a steady step's time goes: host wall per step (no profiler),
    then device busy time per step and the top kernels from torch.profiler
    over as many further steps; with ``groups`` ({label: substrings}), the
    device time per step of the kernels whose names hold one of a group's
    substrings (first group that matches); with ``ranges`` ({label:
    record_function name}), the kernels launched inside each named range
    are taken out of their groups into a group of their own (an eager step
    only: a graph replay launches its kernels from no range).  Prints
    them; returns (wall ms, busy ms or None, {label: ms}, kernels per
    step)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA

    def kernel(e):
        # a record_function range also shows as a device row spanning its
        # kernels: not a kernel of its own
        return (e.device_type == cuda and e.key not in (ranges or {}).values()
                and not getattr(e, "is_user_annotation", False))
    rows = []
    for e in prof.key_averages():
        if not kernel(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3 / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _ in rows)
    kernels = sum(e.count for e in prof.key_averages() if kernel(e)) / steps
    print(f"profile [{card}]: {what}: wall {step_ms:.3f} ms, device busy "
          + (f"{busy:.3f} ms, idle {1 - busy / step_ms:.1%}, "
             f"{kernels:.0f} kernels per step" if rows
             else "not measured (no device events)"))
    for ms, name in rows[:top]:
        print(f"profile:   {ms:8.3f} ms/step  {name[:90]}")

    def group(name):
        return next((g for g, keys in (groups or {}).items()
                     if any(k in name for k in keys)), "other")
    sums = {}
    for ms, name in rows:
        sums[group(name)] = sums.get(group(name), 0.0) + ms
    for label, range_name in (ranges or {}).items():
        inside = [k for e in prof.events() if e.name == range_name
                  for k in _kernels_under(e)]
        for name, us in inside:
            sums[group(name)] -= us / 1e3 / steps
        sums[label] = sum(us for _, us in inside) / 1e3 / steps
    if groups:
        print("profile: by group: " + ", ".join(
            f"{g} {ms:.3f} ms ({ms / busy:.1%})"
            for g, ms in sorted(sums.items(), key=lambda kv: -kv[1])))
    return step_ms, (busy if rows else None), sums, kernels


def _kernels_under(event):
    """(name, us) of every kernel launched inside a profiler CPU event."""
    out = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        out += _kernels_under(child)
    return out


def decode_profile(torch, eng, steps: int, card: str, tag: str = "serve"):
    mode = "uncaptured" if eng._run_uncaptured else "captured"
    return device_profile(torch, eng.step, steps,
                          f"{tag} {mode} decode step (8 slots x "
                          f"{eng.decode_chunk} tokens, "
                          f"{eng.model.gpt.config.num_hidden_layers} layers)",
                          card)


def sampler_ms(torch, dev, seed: int, vocab: int):
    """Device ms of the keyed sampler for one token of 8 slots, all
    sampling (top-k 40, top-p 0.9, temperature 0.8), and of the
    all-greedy step on the same logits (CUDA graph replay)."""
    from paddle_tpu_torch.generation.keyed import greedy_step, sample_step
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    last = torch.randn(SLOTS, vocab, generator=gen, device=dev) * 3.0
    keys = torch.randint(0, 2 ** 32, (SLOTS, 2), generator=gen, device=dev)
    pos = torch.arange(100, 100 + SLOTS, dtype=torch.int32, device=dev)
    knobs = (torch.full((SLOTS,), 0.8, device=dev),
             torch.full((SLOTS,), 40, dtype=torch.int64, device=dev),
             torch.full((SLOTS,), 0.9, device=dev),
             torch.zeros(SLOTS, dtype=torch.bool, device=dev))
    with torch.inference_mode():
        mixed = graph_ms(torch, lambda: sample_step(last, keys, pos, *knobs))
        greedy = graph_ms(torch, lambda: greedy_step(last))
    return mixed, greedy


def replay_span_ms(torch, eng, steps: int) -> float:
    """Device ms per decode step of the captured engine by CUDA events
    around each replay of a decode graph: the graph's span on the card,
    the gaps between its kernels included (no profiler)."""
    spans = []
    progs = [eng._programs[n] for n in ("decode", "decode_greedy")]
    saved = [p.graph.replay for p in progs]

    def timed(replay):
        def run():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            replay()
            b.record()
            spans.append((a, b))
        return run

    for p, replay in zip(progs, saved):
        p.graph.replay = timed(replay)
    try:
        for _ in range(steps):
            eng.step()
    finally:
        for p, replay in zip(progs, saved):
            p.graph.replay = replay
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / len(spans)


def decode_logits_check(torch, eng, model, dev):
    """One decode step's logits on the engine's current paged state, by
    the kernel path on the card and by the plain versions on the CPU (the
    host-planned writes of ``paged_decode_logits``, on copies of the
    pools).  Returns (max abs difference, the plain logits' largest
    |value|)."""
    from paddle_tpu_torch.serving.engine import paged_decode_logits
    eng._ensure_decode_blocks()      # back the next row, as a step would
    tables_np = eng._host_tables()
    active = np.zeros(SLOTS, bool)
    pos = np.zeros(SLOTS, np.int64)
    tokens = torch.zeros(SLOTS, dtype=torch.long)
    for slot, run in eng._slots.items():
        active[slot], pos[slot], tokens[slot] = True, run.pos, run.last_token
    geo = (eng.kv_pool.num_blocks, BLOCK, MAX_LEN)
    with torch.inference_mode():
        pools = [(k.clone(), v.clone()) for k, v in eng._pools]
        kern = paged_decode_logits(
            model, pools, tables_np, torch.from_numpy(tables_np).to(dev),
            active, pos, tokens.to(dev), *geo).cpu()
        del pools
        cpu_model = copy.deepcopy(model).cpu()
        cpu_pools = [(k.cpu(), v.cpu()) for k, v in eng._pools]
        plain = paged_decode_logits(
            cpu_model, cpu_pools, tables_np, torch.from_numpy(tables_np),
            active, pos, tokens, *geo)
    return float((kern - plain).abs().max()), float(plain.abs().max())


def serve_run(torch, eng, prompts, sampled, new_tokens, launch_names,
              adapters=None):
    """The requests through the engine (counters zeroed just before and
    read just after), request i under LoRA adapter ``adapters[i]`` when
    given.  Returns the streams, wall seconds, TTFTs and the kernels'
    launches by name."""
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    torch.cuda.synchronize()
    im.dequant_matmul.launches = 0
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    resps = [eng.submit(p, max_new_tokens=new_tokens,
                        adapter=adapters[i] if adapters else None,
                        **({"decode_strategy": "sampling", **sampled[i]}
                           if i in sampled else {}))
             for i, p in enumerate(prompts)]
    eng.run_until_drained(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(launch_names, (im.dequant_matmul.launches,
                                       pa.paged_attention.launches)))
    return ([r.tokens(timeout=5) for r in resps], wall,
            sorted(r.ttft for r in resps), launches)


def serve_requests(args, vocab: int):
    """The serve phase's 8 prompts (PROMPT_LENS) from --seed, and the
    knobs of its two sampled requests, by index."""
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, vocab, (n,)) for n in PROMPT_LENS]
    sampled = {3: dict(temperature=0.8, top_k=40, top_p=0.9, seed=11),
               6: dict(temperature=1.2, top_k=0, top_p=0.8, seed=12)}
    return prompts, sampled


def serve_model(torch, args, dev, dtype=None):
    """GPT-2 medium from --seed, int8 weight-only; with dtype bf16 or
    float16 decorated to it (amp O2) before quantization."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.quantization import quantize_for_serving
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed).eval()
    if dtype in (torch.bfloat16, torch.float16):
        amp.decorate(models=model, level="O2", dtype=str(dtype)[6:])
    return quantize_for_serving(model)


def serve_phase(torch, args, dev, card, model, dtype=None):
    """GPT-2 medium (``serve_model``), paged KV: the main path; with
    dtype bf16 the engine's pools are bf16.  The engine's programs run as
    CUDA graphs (captured by warmup); the same requests then run again
    through the same program functions uncaptured, for an A/B.  Returns
    the launches of K3 and K4 in the captured run, keyed by their
    kernel-table names."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.serving import ServingEngine

    bf16 = dtype == torch.bfloat16
    tag = "serve bf16" if bf16 else "serve"
    cfg = model.gpt.config
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        kv="paged", block_size=BLOCK, dtype=dtype,
                        device=dev)
    pool_dt = eng._pools[0][0].dtype
    if pool_dt != (dtype or torch.float32):
        fail(f"{tag}: the engine built {pool_dt} pools")
    warm = eng.warmup()
    counts = warm["compile_counts"]
    if not warm["captured"] or counts["total"] != counts["bound"]:
        fail(f"{tag}: warmup captured {counts} (want the bound, "
             f"{counts['bound']} CUDA graphs)")
    print(f"{tag}: warmup {warm['seconds']:.2f}s, {counts['total']} CUDA "
          f"graphs captured (bound {counts['bound']}: prefill buckets "
          f"{sorted(counts['prefill'])}, decode x{counts['decode']}); pools "
          f"{pool_dt}, weights {next(model.parameters()).dtype} + int8")
    prompts, sampled = serve_requests(args, cfg.vocab_size)
    suffix = "_bf16" if bf16 else ""
    names = ("int8_matmul" + suffix, "paged_attention" + suffix)
    runs = {}
    for mode in ("captured", "uncaptured"):
        eng._run_uncaptured = mode == "uncaptured"
        outs, wall, ttfts, launches = serve_run(torch, eng, prompts,
                                                sampled, 64, names)
        if any(len(o) != 64 for o in outs):
            fail(f"{tag} {mode}: a request did not produce 64 tokens")
        if any(not (0 <= t < cfg.vocab_size) for o in outs for t in o):
            fail(f"{tag} {mode}: token out of the vocabulary")
        total = sum(len(o) for o in outs)
        runs[mode] = dict(outs=outs, tps=total / wall, ttfts=ttfts)
        print(f"{tag} {mode} [{card}]: 8 requests, {total} tokens in "
              f"{wall:.3f}s: {total / wall:.1f} tokens/s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; launches {launches}")
        if mode == "captured":
            main_launches = launches
    eng._run_uncaptured = False
    for name, n in main_launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    cap, unc = runs["captured"]["outs"], runs["uncaptured"]["outs"]
    for i in range(len(prompts)):
        if i not in sampled and cap[i] != unc[i]:
            fail(f"{tag}: captured greedy stream {i} differs from the "
                 "uncaptured one")
    print(f"{tag}: greedy streams captured == uncaptured; sampled streams "
          f"equal: {[cap[i] == unc[i] for i in sorted(sampled)]}")
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: {eng.post_warmup_compiles()} programs captured after "
             "warmup")

    # the decode step, all-greedy and mixed (the main run's two sampled
    # requests), profiled captured and uncaptured; on the greedy state
    # first one step's logits, kernel path vs plain path
    prof, spans = {}, {}
    for kind in ("greedy", "mixed"):
        knobs = sampled if kind == "mixed" else {}
        check = [eng.submit(p, max_new_tokens=96,
                            **({"decode_strategy": "sampling", **knobs[i]}
                               if i in knobs else {}))
                 for i, p in enumerate(prompts)]
        eng.step()                   # admits all eight + one decode chunk
        if kind == "greedy":
            err, top = decode_logits_check(torch, eng, model, dev)
        for mode in ("captured", "uncaptured"):
            eng._run_uncaptured = mode == "uncaptured"
            prof[kind, mode] = decode_profile(torch, eng, 3, card,
                                              f"{tag} {kind}")
        eng._run_uncaptured = False
        spans[kind] = replay_span_ms(torch, eng, 3)
        print(f"{tag} {kind} captured [{card}]: decode graph replay span "
              f"{spans[kind]:.3f} ms per step (CUDA events)")
        eng.run_until_drained(timeout=300)
        [r.tokens(timeout=5) for r in check]
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: programs captured after warmup")
    tol = BF16_LOGIT_TOL * top if bf16 else LOGIT_TOL
    print(f"{tag}: decode-step logits kernel path vs plain path: max abs "
          f"err {err:.3e} (tolerance {tol:.3e}), |logits| max {top:.3f}")
    if not err <= tol:
        fail(f"{tag}: decode logits disagree: {err:.3e}")
    if not bf16:
        mixed_ms, greedy_ms = sampler_ms(torch, dev, args.seed,
                                         cfg.vocab_size)
        print(f"{tag} [{card}]: keyed sampler, one token of 8 slots x "
              f"{cfg.vocab_size}: {mixed_ms:.4f} ms (all-greedy step "
              f"{greedy_ms:.4f} ms), {eng.decode_chunk} tokens per decode "
              f"step: {eng.decode_chunk * (mixed_ms - greedy_ms):.3f} ms "
              "more per mixed step (CUDA graph replay)")
    agree = []
    for i, p in enumerate(prompts):
        if i in sampled:
            continue
        solo, _ = generate(model, p, max_new_tokens=64, device=dev)
        solo = solo[0].tolist()
        agree.append(sum(a == s for a, s in zip(cap[i], solo)))
    print(f"{tag}: greedy tokens equal to solo generate(): {agree} of 64 "
          "per request")
    for mode in ("captured", "uncaptured"):
        r = runs[mode]
        ttfts = r["ttfts"]
        steps = []
        for kind in ("greedy", "mixed"):
            wall_ms, busy_ms, _, kernels = prof[kind, mode]
            steps.append(
                f"{kind} step wall {wall_ms:.3f} ms, device "
                + (f"{busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}, "
                   f"{kernels:.0f} kernels" if busy_ms else "not measured")
                + (f", replay span {spans[kind]:.3f} ms"
                   if mode == "captured" else ""))
        print(f"{tag} {mode} summary [{card}]: {r['tps']:.1f} tokens/s, "
              f"TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; " + "; ".join(steps)
              + f"; warmup {warm['seconds']:.2f}s, captures "
              f"{counts['total']}, logits err {err:.3e}")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return main_launches


def _serving_hist(obs):
    reg = obs.get_registry()
    return {n: reg.get(n).snapshot()["count"]
            for n in ("serving_ttft_seconds", "serving_inter_token_seconds")}


def _span_counts(obs, prefix="serving_"):
    return {k: v[0] for k, v in obs.get_tracer().aggregates().items()
            if k.startswith(prefix)}


def telemetry_window(torch, eng, prompts, steps: int = 3):
    """A torch.profiler window over ``steps`` captured decode steps of 8
    active slots with profile=True: the serving_decode ranges (host) and
    the K3 / K4 kernels (device) in it, with the launch counters zeroed
    just before.  Returns (ranges, kernels inside a range, kernels outside
    and their largest distance in us, K3 / K4 launches counted, kernels
    seen)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    resps = [eng.submit(p, max_new_tokens=96) for p in prompts]
    eng.step()                       # admits all eight + one decode step
    torch.cuda.synchronize()
    im.dequant_matmul.launches = pa.paged_attention.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    launches = {"paged_attention": pa.paged_attention.launches,
                "int8_matmul": im.dequant_matmul.launches}
    eng.run_until_drained(timeout=300)
    [r.tokens(timeout=5) for r in resps]
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name == "serving_decode" and e.device_type != cuda]
    seen = {"paged_attention": 0, "int8_matmul": 0}
    inside, outside, worst = dict(seen), dict(seen), 0.0
    for e in prof.events():
        if e.device_type != cuda:
            continue
        kind = ("paged_attention" if "paged_attention" in e.name else
                "int8_matmul" if "dequant_matmul" in e.name else None)
        if kind is None:
            continue
        seen[kind] += 1
        a, b = e.time_range.start, e.time_range.end
        if any(lo <= a and b <= hi for lo, hi in ranges):
            inside[kind] += 1
        else:
            outside[kind] += 1
            worst = max(worst, min(max(lo - a, b - hi, 0.0)
                                   for lo, hi in ranges) if ranges else 0.0)
    return ranges, inside, outside, worst, launches, seen


def telemetry_phase(torch, args, dev, card, model):
    """The engine's telemetry on the serve configuration (GPT-2 medium
    int8, paged, 8 slots, the serve traffic), one captured engine run with
    profile=False and profile=True in turns (TELEMETRY_RUNS).  Gates per
    run: the TTFT histogram counts the requests and the TTFT +
    inter-token histograms the tokens; profile=True opens one
    serving_prefill span per request and one serving_decode span per
    decode step, profile=False none; K3 / K4 launch counts and the greedy
    streams equal in every run; nothing is captured after warmup.  Then
    the registry's entries (captures, capture seconds, bytes, replays),
    and a torch.profiler window over decode steps: every K3 / K4 kernel
    of it inside a serving_decode range, their counts equal to the launch
    counters'."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.utils.monitor import stat_get
    cfg = model.gpt.config
    prompts, sampled = serve_requests(args, cfg.vocab_size)
    eng = _paged_engine(model, dev)
    by = {False: [], True: []}
    ref = None
    for prof in TELEMETRY_RUNS:
        eng._profile = prof
        eng.reset_metrics()
        h0, s0 = _serving_hist(obs), _span_counts(obs)
        steps0 = stat_get("STAT_serving_decode_steps")
        outs, wall, ttfts, launches = _drive(
            torch, eng, prompts, sampled, 64, f"telemetry profile={prof}")
        tokens = sum(len(o) for o in outs)
        h1, s1 = _serving_hist(obs), _span_counts(obs)
        hist = {n: h1[n] - h0[n] for n in h1}
        spans = {k: n - s0.get(k, 0) for k, n in s1.items()
                 if n - s0.get(k, 0)}
        steps = stat_get("STAT_serving_decode_steps") - steps0
        p50 = ttfts[len(ttfts) // 2] * 1e3
        by[prof].append((tokens / wall, p50))
        print(f"telemetry profile={prof} [{card}]: {tokens} tokens in "
              f"{wall:.3f}s: {tokens / wall:.1f} tokens/s; TTFT p50 "
              f"{p50:.1f} ms; {steps} decode steps; histogram counts "
              f"{hist}; spans {spans}; launches {launches}")
        if hist["serving_ttft_seconds"] != len(prompts) or sum(
                hist.values()) != tokens:
            fail(f"telemetry: histogram counts {hist} for {len(prompts)} "
                 f"requests and {tokens} tokens")
        want = ({"serving_prefill": len(prompts), "serving_decode": steps}
                if prof else {})
        if spans != want:
            fail(f"telemetry profile={prof}: spans {spans}, want {want}")
        greedy = [o for i, o in enumerate(outs) if i not in sampled]
        if ref is None:
            ref = (launches, greedy)
        elif (launches, greedy) != ref:
            fail(f"telemetry profile={prof}: launches {launches} or greedy "
                 f"streams differ from the first run's ({ref[0]})")
    if eng.post_warmup_compiles() != 0:
        fail(f"telemetry: post_warmup_compiles() "
             f"{eng.post_warmup_compiles()}")
    for prof in (False, True):
        tps = [t for t, _ in by[prof]]
        p50s = [p for _, p in by[prof]]
        print(f"telemetry summary profile={prof} [{card}]: "
              f"{np.mean(tps):.1f} tokens/s (runs {', '.join(f'{t:.1f}' for t in tps)}), "
              f"TTFT p50 {np.mean(p50s):.1f} ms (runs "
              f"{', '.join(f'{p:.1f}' for p in p50s)})")
    print("telemetry: post_warmup_compiles() 0; the registry's records of "
          "the engine's program names (process-wide: every engine's "
          "captures and replays under a name add up):")
    mine = {p.tracked_as for p in eng._programs.values()}
    for name, rec in sorted(obs.get_program_registry().snapshot().items()):
        if name in mine:
            print(f"telemetry:   {name}: captures {rec['compiles']}, "
                  f"capture seconds {rec['compile_seconds_total']:.3f}, "
                  f"argument bytes {rec['argument_bytes']:.0f}, output "
                  f"bytes {rec.get('output_bytes', 0):.0f}, replays "
                  f"{rec['replays']}, flops {rec['flops']}")
    eng._profile = True
    ranges, inside, outside, worst, launches, seen = telemetry_window(
        torch, eng, prompts)
    print(f"telemetry window [{card}]: {len(ranges)} serving_decode ranges; "
          f"K3 / K4 kernels seen {seen}, inside a range {inside}, outside "
          f"{outside} (largest distance {worst:.1f} us); launches counted "
          f"{launches}")
    if not any(seen.values()):
        print("telemetry window: the profiler recorded no K3 / K4 kernel "
              "(device events not measured)")
    elif any(outside.values()) or inside != launches or len(ranges) != 3:
        fail(f"telemetry: the serving_decode ranges do not enclose the "
             f"step's K3 / K4 kernels ({inside} inside, {outside} outside, "
             f"{launches} launched)")
    eng.close()
    del eng
    torch.cuda.empty_cache()


def _timed(torch, fn, out):
    """fn, with the ms of each call that did its work (did not return
    False) appended to ``out``; the card is synchronized around it."""
    def run(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        if res is not False:
            out.append((time.perf_counter() - t0) * 1e3)
        return res
    return run


def _ms_line(label, ms):
    return (f"{label} {np.mean(ms):.3f} ms per run (max {max(ms):.3f}, "
            f"{len(ms)} runs)" if ms else f"{label}: none")


def _paged_engine(model, dev, **kw):
    from paddle_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN, kv="paged",
                        block_size=BLOCK, device=dev, **kw)
    warm = eng.warmup()
    counts = warm["compile_counts"]
    if not warm["captured"] or counts["total"] != counts["bound"]:
        fail(f"warmup captured {counts} (want {counts['bound']} graphs)")
    return eng


def _drive(torch, eng, prompts, sampled, new_tokens, tag, adapters=None):
    """serve_run with every request required to finish with its tokens
    and K3 / K4 required to launch (counted through the replays)."""
    names = ("int8_matmul", "paged_attention")
    try:
        outs, wall, ttfts, launches = serve_run(torch, eng, prompts, sampled,
                                                new_tokens, names, adapters)
    except Exception as e:  # noqa: BLE001 — a failed request fails the phase
        fail(f"{tag}: a request failed: {e!r}")
    if any(len(o) != new_tokens for o in outs):
        fail(f"{tag}: a request did not produce {new_tokens} tokens")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{tag}: kernel {name} was not launched")
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: {eng.post_warmup_compiles()} captures after warmup")
    return outs, wall, ttfts, launches


def pressure_phase(torch, args, dev, card, model):
    """The serve model's paged engine on 224 blocks where 512 back every
    slot: 16 requests of 200..400 prompt tokens and 256 new ones (every
    4th keyed-sampled).  Runs are parked and resumed as the pool runs
    short; every request must complete, with its stream equal token for
    token to the same requests on the full pool."""
    rng = np.random.RandomState(args.seed + 2)
    vocab = model.gpt.config.vocab_size
    prompts = [rng.randint(0, vocab, (n,)) for n in PRESSURE_LENS]
    sampled = {i: dict(temperature=0.8, top_k=40, top_p=0.9, seed=20 + i)
               for i in range(1, len(prompts), 4)}
    runs = {}
    for tag, extra in (("full pool", {}),
                       ("pressure", dict(num_blocks=PRESSURE_BLOCKS))):
        eng = _paged_engine(model, dev, **extra)
        pre_ms, res_ms = [], []
        eng.preempt_slot = _timed(torch, eng.preempt_slot, pre_ms)
        eng.restore_run = _timed(torch, eng.restore_run, res_ms)
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, sampled,
                                             PRESSURE_NEW, f"pressure {tag}")
        kv = eng.metrics()["kv_pool"]
        total = sum(len(o) for o in outs)
        print(f"pressure {tag} [{card}]: {len(prompts)} requests, "
              f"{eng.kv_pool.num_blocks} blocks, {total} tokens in "
              f"{wall:.3f}s: {total / wall:.1f} tokens/s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; preemptions {kv['oom_preempts']}, "
              f"resumes {kv['oom_resumes']}, failed {kv['oom_failed']}; "
              + _ms_line("preempt", pre_ms) + "; "
              + _ms_line("restore", res_ms) + f"; launches {launches}")
        if kv["oom_failed"] or kv["oom_paused"] or \
                kv["oom_resumes"] != kv["oom_preempts"]:
            fail(f"pressure {tag}: {kv}")
        runs[tag] = (outs, kv["oom_preempts"])
        eng.close()
        del eng
        torch.cuda.empty_cache()
    if runs["pressure"][1] < 1:
        fail("pressure: the short pool preempted no run")
    diff = [i for i, (a, b) in enumerate(zip(runs["pressure"][0],
                                             runs["full pool"][0])) if a != b]
    if diff:
        fail(f"pressure: streams {diff} differ from the full pool's")
    print(f"pressure: all {len(prompts)} streams (greedy and sampled) equal "
          "the full pool's token for token")


def _replay_ms(torch, prog, n: int = 10) -> float:
    """Device ms per replay of a captured program (CUDA events)."""
    prog.graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        prog.graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _top2_margin(torch, model, dev, ids) -> float:
    """Top-two margin of the next-token logits of ``ids`` (a full
    forward, no cache)."""
    with torch.inference_mode():
        logits = model(torch.as_tensor(np.asarray(ids)[None]).to(dev))
    top = logits[0, -1].float().topk(2).values
    return float(top[0] - top[1])


def prefix_phase(torch, args, dev, card, model):
    """The serve model's paged engine with prefix_cache=True against one
    without: a request of the 384-token prefix plus 16 tokens fills the
    cache, then 16 greedy requests of the prefix plus 16..96 tokens and
    the bare prefix (copy-on-write), 64 new tokens each.  The cache must
    hit, copy once, capture nothing after warmup and leave the prefix's
    blocks bit for bit unchanged; a stream may split from the uncached
    engine's only at a near tie (the uncached path's top-two margin below
    2e-3 there).  Prints TTFT and the device ms of a warm prefill (bucket
    64 at cached_len 384) against a cold one (bucket 512)."""
    rng = np.random.RandomState(args.seed + 3)
    vocab = model.gpt.config.vocab_size
    prefix = rng.randint(0, vocab, (PREFIX_LEN,))
    first = np.concatenate([prefix, rng.randint(0, vocab,
                                                (PREFIX_SUFFIXES[0],))])
    prompts = [np.concatenate([prefix, rng.randint(0, vocab, (n,))])
               for n in PREFIX_SUFFIXES] + [prefix]
    runs = {}
    for cached in (False, True):
        tag = "prefix cached" if cached else "prefix uncached"
        eng = _paged_engine(model, dev, prefix_cache=cached)
        eng.submit(first, max_new_tokens=PREFIX_NEW)
        eng.run_until_drained(timeout=300)
        if cached:
            chain = eng.prefix_cache.match("default", prefix)
            if len(chain) != PREFIX_LEN // BLOCK:
                fail(f"{tag}: {len(chain)} prefix blocks cached")
            shared = [[t[b].clone() for pair in eng._pools for t in pair]
                      for b in chain]
            hits = eng.prefix_cache.hits
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, {},
                                             PREFIX_NEW, tag)
        extra = ""
        if cached:
            stats = eng.prefix_cache.stats()
            if stats["hits"] <= hits or stats["cow_copies"] < 1:
                fail(f"{tag}: {stats}")
            for b, before in zip(chain, shared):
                after = [t[b] for pair in eng._pools for t in pair]
                if not all(torch.equal(x, y) for x, y in zip(before, after)):
                    fail(f"{tag}: shared block {b} was written")
            extra = (f"; {stats['hits']} block hits, {stats['misses']} "
                     f"misses, {stats['cow_copies']} copy-on-write, shared "
                     f"blocks unchanged")
            warm_table = eng.kv_pool.sentinel_table()
            warm_table[:len(chain)] = chain  # reads the prefix, writes drop
            timed = ((64, PREFIX_LEN, warm_table),
                     (512, 0, eng.kv_pool.sentinel_table()))
        else:
            timed = ((512, None, eng.kv_pool.sentinel_table()),)
        prefill = {}
        for bucket, cached_len, table in timed:
            prog = eng._programs[bucket]
            fill = dict(target=table, prompt_len=(cached_len or 0) + bucket)
            if cached_len is not None:
                fill["cached_len"] = cached_len
            with torch.inference_mode():
                eng._fill(prog.inputs, **fill)
                prefill[bucket] = _replay_ms(torch, prog)
        runs[cached] = outs
        print(f"{tag} [{card}]: {len(prompts)} requests, "
              f"{sum(len(o) for o in outs)} tokens in {wall:.3f}s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; prefill device ms "
              + ", ".join(f"bucket {b}"
                          + (f" (cached_len {c})" if c else "")
                          + f" {prefill[b]:.3f}" for b, c, _ in timed)
              + f"{extra}; launches {launches}")
        eng.close()
        del eng
        torch.cuda.empty_cache()
    splits = []
    for i, (got, want) in enumerate(zip(runs[True], runs[False])):
        if got == want:
            continue
        j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        margin = _top2_margin(torch, model, dev,
                              np.concatenate([prompts[i], want[:j]]))
        splits.append((i, j, margin))
        print(f"prefix: stream {i} splits from the uncached one at token "
              f"{j}: uncached top-two margin {margin:.3e}")
        if margin >= MARGIN_TOL:
            fail(f"prefix: stream {i} splits at token {j} where the margin "
                 f"is {margin:.3e} (>= {MARGIN_TOL})")
    print(f"prefix: {len(prompts) - len(splits)} of {len(prompts)} greedy "
          "streams equal the uncached engine's token for token; splits "
          f"only at near ties: {splits}")


def spec_draft(torch, args, dev, dtype=None):
    """The spec phase's draft: GPT-2 small's widths (12 x 768, 12 heads,
    the target's vocab 50304), random weights from --seed + 4, int8
    weight-only, as the README's speculative config pairs them; with
    dtype bf16 decorated to bf16 (amp O2) before quantization."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_small_config
    from paddle_tpu_torch.quantization import quantize_for_serving
    cfg = gpt2_small_config(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed + 4).eval()
    if dtype == torch.bfloat16:
        amp.decorate(models=model, level="O2", dtype="bfloat16")
    return quantize_for_serving(model)


def spec_kernel_checks(torch, dev, draft, buckets):
    """K3 and K4 against their plain versions (and bit-repeatable) at the
    spec path's own shapes: K3 at the draft's 8 x 12 heads and at the
    verify's 40 flattened rows of 16 heads (tables repeated per row, pos
    + j); K4 at the verify's M = 40 on GPT-2 medium's four Linears and at
    the draft's M = 8 and its prefill buckets on GPT-2 small's."""
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.quantization import quantize_weight_int8
    rng = np.random.RandomState(5)
    k1 = SPEC_TOKENS + 1
    nb = MAX_LEN // BLOCK + 1
    serve_np = np.array([n - 1 + 32 for n in PROMPT_LENS], np.int32)
    errs, ok = [], True
    for label, h, rows in (("draft", 12, 1), ("verify", 16, k1)):
        q, pools, tables, _ = _paged_case(torch, rng, dev, serve_np + k1, nb,
                                          h=h)
        q = torch.from_numpy(rng.randn(SLOTS * rows, h, 64).astype(
            np.float32)).to(dev)
        tab = tables.repeat_interleave(rows, 0)
        pos = torch.from_numpy((serve_np[:, None] + np.arange(rows))
                               .reshape(-1).astype(np.int32)).to(dev)
        got = pa.paged_attention(q, *pools[0], tab, pos)
        again = pa.paged_attention(q, *pools[0], tab, pos)
        e, o = max_err(torch, got, pa._plain(q, *pools[0], tab, pos))
        rep = torch.equal(got, again)
        errs.append(e)
        ok = ok and o and rep
        print(f"check paged_attention {label} S={q.shape[0]} H={h} D=64: "
              f"max_abs_err={e:.3e}{'' if o else ' OUT OF TOLERANCE'}"
              f"{'' if rep else ' NOT BIT-REPEATABLE'}")
    medium = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)]
    small = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
    for m, shapes in [(SLOTS * k1, medium), (SLOTS, small)] + [
            (b, small) for b in buckets]:
        for k, n in shapes:
            x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev)
            wi, sc = quantize_weight_int8(torch.randn(k, n, device=dev) * 0.02)
            got = im.dequant_matmul(x, wi, sc)
            again = im.dequant_matmul(x, wi, sc)
            e, o = max_err(torch, got, im._plain(x, wi, sc))
            rep = torch.equal(got, again)
            errs.append(e)
            ok = ok and o and rep
            print(f"check int8_matmul spec M={m} K={k} N={n}: max_abs_err="
                  f"{e:.3e}{'' if o else ' OUT OF TOLERANCE'}"
                  f"{'' if rep else ' NOT BIT-REPEATABLE'}")
    torch.cuda.synchronize()
    if not ok:
        fail(f"spec: a kernel disagrees with its plain version at the spec "
             f"path's shapes or does not repeat ({max(errs):.3e})")


def verify_time(torch, dev, card):
    """K3 at the verify shape, timed like the kernel table's K3 (24
    layers' pools, CUDA graph replay): 8 slots x 5 rows flattened at the
    serve phase's positions (prompt + 32) + j, beside two bounds: the
    flattened rows' K/V bytes (each row's window read once, what this
    kernel must read) and the live K/V bytes read once per slot (what a
    multi-query kernel would read)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(6)
    k1, h, d = SPEC_TOKENS + 1, 16, 64
    nb = MAX_LEN // BLOCK + 1
    serve_np = np.array([n - 1 + 32 for n in PROMPT_LENS], np.int32)
    _, pools, tables, _ = _paged_case(torch, rng, dev, serve_np + k1, nb,
                                      layers=LAYERS)
    q = torch.from_numpy(rng.randn(SLOTS * k1, h, d).astype(np.float32)).to(
        dev)
    tab = tables.repeat_interleave(k1, 0)
    pos_np = (serve_np[:, None] + np.arange(k1)).reshape(-1)
    pos = torch.from_numpy(pos_np.astype(np.int32)).to(dev)
    ms = graph_ms(torch, lambda: [pa.paged_attention(q, k, v, tab, pos)
                                  for k, v in pools]) / LAYERS
    one = graph_ms(torch, lambda: [pa.paged_attention(
        q[::k1].contiguous(), k, v, tables, pos[::k1].contiguous())
        for k, v in pools]) / LAYERS
    row = h * d * 4 * 2
    flat = bound_ms(int((pos_np + 1).sum()) * row + 2 * q.numel() * 4,
                    4.0 * int((pos_np + 1).sum()) * h * d)
    live = bound_ms(int((serve_np + k1).sum()) * row + 2 * q.numel() * 4,
                    4.0 * int((pos_np + 1).sum()) * h * d)
    print(f"time paged_attention verify [{card}]: S={SLOTS} x {k1} rows "
          f"flattened, pos={pos_np.tolist()}: {ms:.4f} ms per layer (one row "
          f"per slot at the same pos: {one:.4f}); bound {flat[0]:.4f} "
          f"({flat[1]}: the flattened rows' K/V), {live[0]:.4f} ({live[1]}: "
          f"the live K/V read once)")
    del pools
    torch.cuda.empty_cache()


def verify_logits_check(torch, eng, model, dev):
    """One verify tick's target logits (every active slot's last token and
    SPEC_TOKENS proposals drawn from --seed) on the kernel path on the
    card against the same rows by the plain versions on the CPU, on the
    engine's current paged state (``paged_decode_logits`` with (S, K+1)
    tokens, on copies of the pools).  Returns (max abs difference over
    the active slots, the plain logits' largest |value| there)."""
    from paddle_tpu_torch.serving.engine import paged_decode_logits
    eng._ensure_decode_blocks()      # back the tick's rows, as a step would
    tables_np = eng._host_tables()
    active = np.zeros(SLOTS, bool)
    pos = np.zeros(SLOTS, np.int64)
    ids = np.random.RandomState(7).randint(
        0, model.gpt.config.vocab_size, (SLOTS, SPEC_TOKENS + 1))
    for slot, run in eng._slots.items():
        active[slot], pos[slot], ids[slot, 0] = True, run.pos, run.last_token
    ids = torch.from_numpy(ids)
    geo = (eng.kv_pool.num_blocks, BLOCK, eng._pool_len)
    with torch.inference_mode():
        pools = [(k.clone(), v.clone()) for k, v in eng._pools]
        kern = paged_decode_logits(
            model, pools, tables_np, torch.from_numpy(tables_np).to(dev),
            active, pos, ids.to(dev), *geo).cpu()
        del pools
        cpu_model = copy.deepcopy(model).cpu()
        cpu_pools = [(k.cpu(), v.cpu()) for k, v in eng._pools]
        plain = paged_decode_logits(
            cpu_model, cpu_pools, tables_np, torch.from_numpy(tables_np),
            active, pos, ids, *geo)
    live = torch.from_numpy(active)
    return (float((kern[live] - plain[live]).abs().max()),
            float(plain[live].abs().max()))


def check_verify_logits(torch, eng, model, dev):
    """``verify_logits_check`` printed and held to LOGIT_TOL."""
    err, top = verify_logits_check(torch, eng, model, dev)
    print(f"spec: verify-tick logits kernel path vs plain path: max abs err "
          f"{err:.3e} (tolerance {LOGIT_TOL:.1e}), |logits| max {top:.3f}")
    if not err <= LOGIT_TOL:
        fail(f"spec: verify logits disagree: {err:.3e}")


def _tick_profile(torch, eng, prompts, sampled, card, tag, check=None):
    """The engine's steady tick with 8 slots active, captured, all-greedy
    and mixed (the requests of ``sampled`` sampling): wall, device busy,
    idle share, kernels (device_profile) and the decode graph's replay
    span (CUDA events), printed.  ``check(eng)`` runs first on the
    all-greedy state."""
    for kind, knobs in (("greedy", {}), ("mixed", sampled)):
        resps = [eng.submit(p, max_new_tokens=96,
                            **({"decode_strategy": "sampling", **knobs[i]}
                               if i in knobs else {}))
                 for i, p in enumerate(prompts)]
        eng.step()                   # admits all eight + one tick
        if check is not None and kind == "greedy":
            check(eng)
        wall_ms, busy, _, kernels = device_profile(
            torch, eng.step, 3, f"{tag} captured {kind} tick (8 slots, "
            f"{model_layers(eng)})", card)
        span = replay_span_ms(torch, eng, 3)
        print(f"spec: {tag} {kind} tick [{card}]: wall {wall_ms:.3f} ms, "
              "device " + (f"{busy:.3f} ms, idle {1 - busy / wall_ms:.1%}, "
                           f"{kernels:.0f} kernels" if busy
                           else "not measured")
              + f", replay span {span:.3f} ms")
        eng.run_until_drained(timeout=300)
        [r.tokens(timeout=5) for r in resps]


def model_layers(eng) -> str:
    layers = eng.model.gpt.config.num_hidden_layers
    if eng.draft_model is None:
        return f"{layers} layers, {eng.decode_chunk} tokens per step"
    return (f"{layers} target + {eng.draft_model.gpt.config.num_hidden_layers}"
            f" draft layers, K={eng.spec_tokens}")


def spec_phase(torch, args, dev, card, model):
    """Speculative decoding on the serve model (GPT-2 medium int8, paged,
    f32 pools) with the GPT-2-small-config int8 draft (``spec_draft``),
    spec_tokens=4: the serve phase's 8 requests (6 greedy + 2 sampled, 64
    new tokens) through the plain engine, the speculative engine captured
    and the same uncaptured.  Gates: warmup captures len(buckets) + 2 and
    none follows; K3 and K4 launch through the spec run's replays; the
    captured streams equal the uncaptured ones; each greedy stream equals
    the plain engine's, or splits where the plain path's top-two margin is
    below MARGIN_TOL (printed); one verify tick's logits within LOGIT_TOL
    of the plain path on the CPU.  Prints tokens/s, TTFT, accept rate,
    tokens per slot per tick and a profiled tick against the plain
    engine's decode step."""
    from paddle_tpu_torch.serving.engine import _default_buckets
    cfg = model.gpt.config
    draft = spec_draft(torch, args, dev)
    prompts, sampled = serve_requests(args, cfg.vocab_size)
    buckets = sorted({min(b for b in _default_buckets(MAX_LEN) if b >= n)
                      for n in PROMPT_LENS})
    spec_kernel_checks(torch, dev, draft, buckets)
    verify_time(torch, dev, card)
    runs = {}
    for tag in ("plain", "captured", "uncaptured"):
        if tag == "plain":
            eng = _paged_engine(model, dev)
        elif tag == "captured":
            eng = _paged_engine(model, dev, draft_model=draft,
                                spec_tokens=SPEC_TOKENS)
        else:
            eng._run_uncaptured = True
            eng.reset_metrics()
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, sampled,
                                             64, f"spec {tag}")
        total = sum(len(o) for o in outs)
        line = (f"spec {tag} [{card}]: 8 requests, {total} tokens in "
                f"{wall:.3f}s: {total / wall:.1f} tokens/s; TTFT p50 "
                f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
                f"{ttfts[-1] * 1e3:.1f} ms; launches {launches}")
        if tag != "plain":
            m = eng.metrics()["spec"]
            # every request speculates: proposed / K is its slot-ticks
            slot_ticks = m["proposed"] / SPEC_TOKENS
            line += (f"; {m['ticks']} ticks, accept rate "
                     f"{m['accept_rate']:.4f} ({m['accepted']} of "
                     f"{m['proposed']}), tokens per slot per tick "
                     f"{(total - len(prompts)) / slot_ticks:.3f}")
        print(line)
        runs[tag] = outs
        if tag == "plain":
            _tick_profile(torch, eng, prompts, sampled, card, "plain engine")
        elif tag == "captured":
            _tick_profile(torch, eng, prompts, sampled, card, "spec engine",
                          check=lambda e: check_verify_logits(torch, e,
                                                              model, dev))
        if eng.post_warmup_compiles() != 0:
            fail(f"spec {tag}: captures after warmup")
        if tag != "captured":
            eng.close()
            del eng
            torch.cuda.empty_cache()
    cap, unc = runs["captured"], runs["uncaptured"]
    if cap != unc:
        fail("spec: captured streams differ from the uncaptured ones: "
             f"{[i for i, (a, b) in enumerate(zip(cap, unc)) if a != b]}")
    splits = []
    for i, (got, want) in enumerate(zip(cap, runs["plain"])):
        if i in sampled or got == want:
            continue
        j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        margin = _top2_margin(torch, model, dev,
                              np.concatenate([prompts[i], want[:j]]))
        splits.append((i, j, margin))
        print(f"spec: greedy stream {i} splits from the plain engine's at "
              f"token {j}: plain top-two margin {margin:.3e}")
        if margin >= MARGIN_TOL:
            fail(f"spec: stream {i} splits at token {j} where the margin "
                 f"is {margin:.3e} (>= {MARGIN_TOL})")
    print(f"spec: captured == uncaptured (all 8 streams); "
          f"{len(prompts) - len(sampled) - len(splits)} of "
          f"{len(prompts) - len(sampled)} greedy streams equal the plain "
          f"engine's; splits only at near ties: {splits}")
    del draft
    torch.cuda.empty_cache()


def spec_bf16_phase(torch, args, dev, card, model):
    """Speculation in bf16: the bf16 serve model (``serve_model`` decorated
    to bf16, int8) with the draft decorated to bf16 too, on bf16 pools,
    spec_tokens=4, the serve phase's 8 requests, against the plain bf16
    engine.  Gates: the captured spec engine's warmup captures the bound
    and none follows; K3 / K4 launch through its replays (bf16 operands);
    each greedy stream equals the plain engine's or splits where the plain
    path's top-two margin is below the bf16 tolerance (5% of the largest
    |logit|, printed).  Prints tokens/s, TTFT and the accept rate."""
    bf16 = torch.bfloat16
    cfg = model.gpt.config
    draft = spec_draft(torch, args, dev, bf16)
    prompts, sampled = serve_requests(args, cfg.vocab_size)
    runs = {}
    for tag in ("plain", "spec"):
        kw = ({"draft_model": draft, "spec_tokens": SPEC_TOKENS}
              if tag == "spec" else {})
        eng = _paged_engine(model, dev, dtype=bf16, **kw)
        if any(t.dtype != bf16 for store in
               [eng._pool_store] + ([eng._draft_store] if kw else [])
               for pair in store for t in pair):
            fail("spec bf16: the engine built pools of another dtype")
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, sampled,
                                             64, f"spec bf16 {tag}")
        total = sum(len(o) for o in outs)
        line = (f"spec bf16 {tag} [{card}]: 8 requests, {total} tokens in "
                f"{wall:.3f}s: {total / wall:.1f} tokens/s; TTFT p50 "
                f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms; launches {launches}")
        if tag == "spec":
            m = eng.metrics()["spec"]
            line += (f"; {m['ticks']} ticks, accept rate "
                     f"{m['accept_rate']:.4f} ({m['accepted']} of "
                     f"{m['proposed']})")
        print(line)
        runs[tag] = outs
        eng.close()
        del eng
        torch.cuda.empty_cache()
    splits = []
    for i, (got, want) in enumerate(zip(runs["spec"], runs["plain"])):
        if i in sampled or got == want:
            continue
        j = next(k for k, (a, b) in enumerate(zip(got, want)) if a != b)
        ids = np.concatenate([prompts[i], want[:j]])
        margin = _top2_margin(torch, model, dev, ids)
        with torch.inference_mode():
            top = float(model(torch.as_tensor(ids[None]).to(dev))[0, -1]
                        .float().abs().max())
        splits.append((i, j, margin))
        print(f"spec bf16: greedy stream {i} splits from the plain "
              f"engine's at token {j}: top-two margin {margin:.3e} "
              f"(tolerance {BF16_LOGIT_TOL * top:.3e})")
        if margin >= BF16_LOGIT_TOL * top:
            fail(f"spec bf16: stream {i} splits at token {j} where the "
                 f"margin is {margin:.3e}")
    print(f"spec bf16: {len(prompts) - len(sampled) - len(splits)} of "
          f"{len(prompts) - len(sampled)} greedy streams equal the plain "
          f"bf16 engine's; splits only at near ties: {splits}")
    del draft
    torch.cuda.empty_cache()


def swap_check(torch, eng, cfg, prompts, dev, seed):
    """``swap_weights`` on a captured fixed-pool engine: another draw of
    the weights copied in place (every parameter keeps its storage), no
    capture after it, greedy streams equal solo generate() on the new
    weights."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models import GPTForPretraining
    new = GPTForPretraining(cfg, device=dev, seed=seed).eval()
    ptrs = [t.data_ptr() for t in eng.model.state_dict().values()]
    eng.swap_weights({k: t.clone() for k, t in new.state_dict().items()},
                     weights_sha=f"seed {seed}")
    if [t.data_ptr() for t in eng.model.state_dict().values()] != ptrs:
        fail("swap_weights rebound a weight instead of writing it in place")
    resps = [eng.submit(p, max_new_tokens=32) for p in prompts]
    eng.run_until_drained(timeout=300)
    for p, r in zip(prompts, resps):
        solo, _ = generate(new, p, max_new_tokens=32, device=dev)
        if r.tokens(timeout=5) != solo[0].tolist():
            fail("swap_weights: a greedy stream differs from solo "
                 "generate() on the new weights")
    if eng.post_warmup_compiles() != 0:
        fail("swap_weights: a program was captured after the swap")
    print(f"fixed f32 swap_weights: {len(prompts)} greedy streams == solo "
          f"generate() on the new weights, in place, refresh_epoch "
          f"{eng.refresh_epoch}, no capture")
    del new


def lora_artifacts(torch, args, model, n: int):
    """``n`` adapter artifacts of the served model, each made by the
    port's ``apply_lora`` on a copy of it (A drawn by LoRALinear from a
    generator seeded from --seed) with B drawn at LORA_B_STD, then
    ``export_adapter`` into build/lora/ of the checkout.  Returns the
    paths (``tenant1.npz``, ...)."""
    import os

    from paddle_tpu_torch import lora
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "lora")
    os.makedirs(out, exist_ok=True)
    paths = []
    for i in range(n):
        wrapped = copy.deepcopy(model)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(args.seed + 40 + i)
        lora.apply_lora(wrapped, rank=LORA_RANK, generator=gen)
        with torch.no_grad():
            for m in wrapped.modules():
                if isinstance(m, lora.LoRALinear):
                    m.lora_B.normal_(0.0, LORA_B_STD, generator=gen)
        paths.append(os.path.join(out, f"tenant{i + 1}.npz"))
        lora.export_adapter(wrapped, paths[-1])
        del wrapped
    torch.cuda.empty_cache()
    return paths


def _lora_ctx(torch, reg, aids, dev):
    """An adapter_context over the registry's stacks moved to ``dev``."""
    from paddle_tpu_torch.lora import adapter_context
    stacks = {k: (a.to(dev), b.to(dev)) for k, (a, b) in reg.stacks.items()}
    return adapter_context(stacks, reg.scales.to(dev),
                           torch.as_tensor(aids, dtype=torch.int32).to(dev))


def lora_logits_check(torch, eng, model, dev):
    """One decode step's logits on the LoRA engine's current paged state,
    every slot under its own adapter, by the kernel path on the card and
    by the plain versions on the CPU (copies of the pools and the
    stacks).  Returns (max abs difference, the plain logits' largest
    |value|, the adapter ids)."""
    from paddle_tpu_torch.serving.engine import paged_decode_logits
    eng._ensure_decode_blocks()
    tables_np = eng._host_tables()
    active = np.zeros(SLOTS, bool)
    pos = np.zeros(SLOTS, np.int64)
    aids = np.zeros(SLOTS, np.int32)
    tokens = torch.zeros(SLOTS, dtype=torch.long)
    for slot, run in eng._slots.items():
        active[slot], pos[slot], tokens[slot] = True, run.pos, run.last_token
        aids[slot] = run.aid
    geo = (eng.kv_pool.num_blocks, BLOCK, MAX_LEN)
    reg = eng._lora_reg
    with torch.inference_mode():
        pools = [(k.clone(), v.clone()) for k, v in eng._pools]
        with _lora_ctx(torch, reg, aids, dev):
            kern = paged_decode_logits(
                model, pools, tables_np, torch.from_numpy(tables_np).to(dev),
                active, pos, tokens.to(dev), *geo).cpu()
        del pools
        cpu_model = copy.deepcopy(model).cpu()
        cpu_pools = [(k.cpu(), v.cpu()) for k, v in eng._pools]
        with _lora_ctx(torch, reg, aids, "cpu"):
            plain = paged_decode_logits(
                cpu_model, cpu_pools, tables_np, torch.from_numpy(tables_np),
                active, pos, tokens, *geo)
    return (float((kern - plain).abs().max()), float(plain.abs().max()),
            sorted(set(aids.tolist())))


def lora_delta_ms(torch, eng, dev):
    """Device ms of the adapter deltas alone for one decode step, as the
    hooks compute them: the 96 hooked projections' gathers (A[aids],
    B[aids], scale[aids], once per step) and, decode_chunk times, two
    batched matmuls, the scale and the add at the decode shape (8 slots,
    one token, adapters 1..4 and the base), as one CUDA graph
    replayed."""
    reg = eng._lora_reg
    aids = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2], dtype=torch.int32,
                        device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    xs = {k: torch.randn(SLOTS, 1, a.shape[1], generator=gen, device=dev)
          for k, (a, _) in reg.stacks.items()}
    ys = {k: torch.randn(SLOTS, 1, b.shape[2], generator=gen, device=dev)
          for k, (_, b) in reg.stacks.items()}

    def deltas():
        ctx = _lora_ctx(torch, reg, aids, dev)
        for _ in range(eng.decode_chunk):
            for k in reg.keys:
                a, b, s = ctx.factors(k)
                ys[k] + torch.bmm(torch.bmm(xs[k], a), b) * s[:, None, None]
    with torch.inference_mode():
        return graph_ms(torch, deltas)


def _lora_margin(torch, model, reg, dev, aid, ids) -> float:
    """Top-two margin of the next-token logits of ``ids`` under adapter
    ``aid`` (a full forward, no cache)."""
    with _lora_ctx(torch, reg, [aid], dev):
        return _top2_margin(torch, model, dev, ids)


def lora_phase(torch, args, dev, card, model):
    """Batched multi-adapter LoRA on the serve model (GPT-2 medium int8,
    paged, f32 pools): four artifacts made by the port's apply_lora +
    export_adapter on the served model, then the serve requests spread
    over the base and the four adapters (LORA_ADAPTERS) through the plain
    engine and the LoRA engine (LoRAConfig(rank 8, max_adapters 8),
    check_base_hash on), captured and uncaptured.  Gates: warmup captures
    len(buckets) + 2 and none follows, a hot load_adapter of a fifth
    artifact while the engine loop serves included; K3 / K4 launch
    through the LoRA engine's replays; captured == uncaptured; the base
    requests' streams equal the plain engine's; each greedy adapter
    stream equals the request served alone (a split only where the
    adapter path's top-two margin is below LORA_MARGIN_TOL); one decode
    step's logits with the four adapters live within LOGIT_TOL of the CPU
    plain path.  Then the training leg (``lora_train_leg``)."""
    from paddle_tpu_torch.lora import LoRAConfig
    cfg = model.gpt.config
    prompts, sampled = serve_requests(args, cfg.vocab_size)
    t0 = time.perf_counter()
    paths = lora_artifacts(torch, args, model, 5)
    print(f"lora: 5 artifacts (rank {LORA_RANK}, B std {LORA_B_STD}) made "
          f"and exported in {time.perf_counter() - t0:.2f}s")
    plain = _paged_engine(model, dev)
    outs, wall, ttfts, _ = _drive(torch, plain, prompts, sampled, 64,
                                  "lora plain")
    total = sum(len(o) for o in outs)
    base_runs = dict(outs=outs, tps=total / wall, ttfts=ttfts)
    plain_prof = decode_profile(torch, _filled(plain, prompts), 3, card,
                                "lora plain engine")
    plain.run_until_drained(timeout=300)
    plain.close()
    del plain
    torch.cuda.empty_cache()

    eng = _paged_engine(model, dev, lora=LoRAConfig(
        rank=LORA_RANK, max_adapters=LORA_SLOTS))
    reg = eng._lora_reg
    names = [f"t{i + 1}" for i in range(4)]
    for name, path in zip(names, paths):
        eng.load_adapter(name, path)
    runs = {}
    for mode in ("captured", "uncaptured"):
        eng._run_uncaptured = mode == "uncaptured"
        eng.reset_metrics()
        outs, wall, ttfts, launches = _drive(torch, eng, prompts, sampled,
                                             64, f"lora {mode}",
                                             LORA_ADAPTERS)
        total = sum(len(o) for o in outs)
        runs[mode] = dict(outs=outs, tps=total / wall, ttfts=ttfts,
                          launches=launches)
        print(f"lora {mode} [{card}]: 8 requests over the base and 4 "
              f"adapters, {total} tokens in {wall:.3f}s: "
              f"{total / wall:.1f} tokens/s; TTFT p50 "
              f"{ttfts[len(ttfts) // 2] * 1e3:.1f} ms, max "
              f"{ttfts[-1] * 1e3:.1f} ms; launches {launches}")
    eng._run_uncaptured = False
    cap, unc = runs["captured"]["outs"], runs["uncaptured"]["outs"]
    if cap != unc:
        fail("lora: captured streams differ from the uncaptured ones: "
             f"{[i for i, (a, b) in enumerate(zip(cap, unc)) if a != b]}")
    differ = [i for i, a in enumerate(LORA_ADAPTERS)
              if a is not None and cap[i][:16] != base_runs["outs"][i][:16]]
    n_adapted = sum(a is not None for a in LORA_ADAPTERS)
    print(f"lora: {len(differ)} of {n_adapted} adapter streams differ from "
          f"the base's within the first 16 tokens ({differ})")
    if not differ:
        fail("lora: no adapter stream leaves the base's")
    for i, a in enumerate(LORA_ADAPTERS):
        if a is None and cap[i] != base_runs["outs"][i]:
            fail(f"lora: base request {i}'s stream differs from the plain "
                 "engine's")
    splits = []
    for i, a in enumerate(LORA_ADAPTERS):
        if a is None or i in sampled:
            continue
        solo = eng.submit(prompts[i], max_new_tokens=64, adapter=a)
        eng.run_until_drained(timeout=300)
        want = solo.tokens(timeout=5)
        if cap[i] == want:
            continue
        j = next(k for k, (x, y) in enumerate(zip(cap[i], want)) if x != y)
        margin = _lora_margin(torch, model, reg, dev, reg.resolve(a),
                              np.concatenate([prompts[i], want[:j]]))
        splits.append((i, j, margin))
        print(f"lora: adapter stream {i} ({a}) splits from its solo run at "
              f"token {j}: top-two margin {margin:.3e}")
        if margin >= LORA_MARGIN_TOL:
            fail(f"lora: stream {i} splits at token {j} where the margin is "
                 f"{margin:.3e} (>= {LORA_MARGIN_TOL})")
    print("lora: captured == uncaptured (all 8 streams); the 2 base streams "
          "equal the plain engine's; greedy adapter streams equal their "
          f"solo runs but at near ties: {splits}")

    # one decode step with the four adapters live: kernel path vs CPU
    resps = [eng.submit(p, max_new_tokens=96, adapter=LORA_ADAPTERS[i])
             for i, p in enumerate(prompts)]
    eng.step()                       # admits all eight + one decode chunk
    err, top, aids = lora_logits_check(torch, eng, model, dev)
    print(f"lora: decode-step logits kernel path vs plain path, adapter ids "
          f"{aids}: max abs err {err:.3e} (tolerance {LOGIT_TOL:.1e}), "
          f"|logits| max {top:.3f}")
    if not err <= LOGIT_TOL:
        fail(f"lora: decode logits disagree: {err:.3e}")
    lora_prof = decode_profile(torch, eng, 3, card, "lora engine")
    span = replay_span_ms(torch, eng, 3)
    eng.run_until_drained(timeout=300)
    [r.tokens(timeout=5) for r in resps]
    delta = lora_delta_ms(torch, eng, dev)

    # a hot load while the engine loop serves: nothing is captured
    eng.start()
    resps = [eng.submit(p, max_new_tokens=64, adapter=LORA_ADAPTERS[i])
             for i, p in enumerate(prompts)]
    time.sleep(0.05)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.load_adapter("t5", paths[4])
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    late = eng.submit(prompts[0], max_new_tokens=16, adapter="t5")
    try:
        for r in resps + [late]:
            r.tokens(timeout=300)
    except Exception as e:  # noqa: BLE001 — a failure fails the phase
        fail(f"lora: a request failed around the hot load: {e!r}")
    if eng.post_warmup_compiles() != 0:
        fail(f"lora: {eng.post_warmup_compiles()} captures after warmup "
             "(a hot load must capture nothing)")
    counts = eng.compile_counts()
    stats = eng.metrics()["lora"]
    eng.close()

    wall_ms, busy, _, kernels = lora_prof
    pw, pbusy, _, pkernels = plain_prof
    stack_bytes = sum(a.nbytes + b.nbytes for a, b in reg.stacks.values())
    b, r = base_runs, runs["captured"]
    p50 = {k: v["ttfts"][len(v["ttfts"]) // 2] * 1e3
           for k, v in (("lora", r), ("plain", b))}
    print(f"lora summary [{card}]: {r['tps']:.1f} tokens/s against the "
          f"plain engine's {b['tps']:.1f} on the same requests; TTFT p50 "
          f"{p50['lora']:.1f} ms against {p50['plain']:.1f}; greedy decode "
          "step "
          f"(8 slots under ids {aids}) wall {wall_ms:.3f} ms, device "
          + (f"{busy:.3f} ms, idle {1 - busy / wall_ms:.1%}, {kernels:.0f} "
             f"kernels" if busy else "not measured")
          + f", replay span {span:.3f} ms; plain engine's step wall "
          f"{pw:.3f} ms, device "
          + (f"{pbusy:.3f} ms, {pkernels:.0f} kernels" if pbusy
             else "not measured")
          + f"; adapter gathers + bmm alone {delta:.3f} ms per step"
          + (f" ({delta / busy:.1%} of the step's device time)" if busy
             else "")
          + f"; stacks {stack_bytes / 2 ** 20:.1f} MiB ({LORA_SLOTS} + 1 "
          f"rows x {len(reg.keys)} targets); hot load_adapter "
          f"{load_ms:.1f} ms while serving; captures {counts['total']} "
          f"(bound {counts['bound']}), none after warmup; registry "
          f"{stats['loaded']} loaded, {stats['loads']} loads")
    del eng
    torch.cuda.empty_cache()
    lora_train_leg(torch, args, dev, card)


def _filled(eng, prompts):
    """``eng`` with the serve prompts admitted (greedy, 96 new tokens) and
    one decode chunk run: 8 active slots for a profile."""
    for p in prompts:
        eng.submit(p, max_new_tokens=96)
    eng.step()
    return eng


def lora_train_leg(torch, args, dev, card):
    """LoRA fine-tuning at the serve model's widths: an f32 GPT-2 medium
    (dropout 0) with apply_lora (rank 8), B 2 x S 512, TrainStep with
    AdamW on the factors only, LORA_TRAIN_STEPS captured steps.  Gates:
    finite losses; every base tensor bit-unchanged; every lora_B moved; K1
    and K2 launched 24 times each per step through the replays; the
    exported adapter passes read_adapter."""
    import os

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import lora
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    crit = GPTPretrainingCriterion()
    held = {}

    def make():
        pt.seed(args.seed)
        model = GPTForPretraining(cfg, device=dev, seed=args.seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 50)
        lora.apply_lora(model, rank=LORA_RANK, generator=gen)
        held["model"] = model
        held["base"] = {k: t.clone() for k, t in model.state_dict().items()
                        if "lora_" not in k}
        factors = [p for p in model.parameters() if p.requires_grad]
        opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=factors)
        return model, TrainStep(model, lambda logits, y: crit(logits, y),
                                opt)

    def counters():
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        return lambda: {"flash_attention_fwd": fa.flash_fwd.launches,
                        "flash_attention_bwd": fa.flash_bwd.launches}
    batch = tuple(torch.from_numpy(a).to(dev) for a in _train_batch(
        cfg, args.seed + 5, LORA_TRAIN_B, LORA_TRAIN_S))
    leg = train_leg(torch, make, batch, LORA_TRAIN_STEPS, counters, card,
                    f"lora train step (GPT-2 medium f32, rank {LORA_RANK}, "
                    f"B {LORA_TRAIN_B} x S {LORA_TRAIN_S}, captured)")
    model = held.pop("model")
    base = held.pop("base")
    print(_leg_line("lora train captured", card, leg,
                    LORA_TRAIN_B * LORA_TRAIN_S, "tokens"))
    print("lora train: losses " + ", ".join(repr(x) for x in leg["losses"]))
    if not all(np.isfinite(leg["losses"])):
        fail(f"lora train: non-finite loss {leg['losses']}")
    want = cfg.num_hidden_layers * LORA_TRAIN_STEPS
    if any(n != want for n in leg["launches"].values()):
        fail(f"lora train: flash launches {leg['launches']}, expected "
             f"{want} each ({cfg.num_hidden_layers} per step)")
    moved = [k for k, t in model.state_dict().items() if k.endswith("lora_B")
             and bool((t != 0).any())]
    n_b = sum(k.endswith("lora_B") for k in model.state_dict())
    changed = [k for k, t in model.state_dict().items()
               if k in base and not torch.equal(t, base[k])]
    if changed or len(moved) != n_b:
        fail(f"lora train: base tensors changed {changed[:4]}; lora_B moved "
             f"{len(moved)} of {n_b}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "lora", "trained.npz")
    lora.export_adapter(model, path)
    header, factors, _ = lora.read_adapter(path)
    print(f"lora train: {len(base)} base tensors bit-unchanged, {len(moved)}"
          f" of {n_b} lora_B moved; exported {len(factors)} factor pairs, "
          f"read back (rank {header['rank']}, {len(header['keys'])} keys)")
    del model, base
    torch.cuda.empty_cache()


def serve_f16_phase(torch, args, dev, card):
    """GPT-2 medium decorated to float16 (amp O2, as the reference's
    engine serves it) and quantized to int8, paged KV in float16: K3 and
    K4 on their float16 routes.  The captured engine serves the serve
    phase's greedy prompts (64 new tokens; counters zeroed just before):
    K3 and K4 launched, and each greedy stream equal to solo generate()'s
    or split from it where the top-two margin is below F16_MARGIN_TOL."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.serving import ServingEngine
    f16 = torch.float16
    model = serve_model(torch, args, dev, f16)
    eng = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                        kv="paged", block_size=BLOCK, dtype=f16,
                        device=dev)
    if eng._pools[0][0].dtype != f16:
        fail(f"serve f16: the engine built {eng._pools[0][0].dtype} pools")
    warm = eng.warmup()
    counts = warm["compile_counts"]
    if not warm["captured"] or counts["total"] != counts["bound"]:
        fail(f"serve f16: warmup captured {counts}")
    prompts, sampled = serve_requests(args, model.gpt.config.vocab_size)
    greedy = [p for i, p in enumerate(prompts) if i not in sampled]
    outs, wall, ttfts, launches = serve_run(
        torch, eng, greedy, {}, 64, ("int8_matmul_f16", "paged_attention_f16"))
    total = sum(len(o) for o in outs)
    print(f"serve f16 captured [{card}]: {len(greedy)} greedy requests, "
          f"{total} tokens in {wall:.3f}s: {total / wall:.1f} tokens/s; "
          f"TTFT p50 {ttfts[len(ttfts) // 2] * 1e3:.1f} ms; pools "
          f"{eng._pools[0][0].dtype}, weights "
          f"{next(model.parameters()).dtype} + int8; launches {launches}")
    if any(n <= 0 for n in launches.values()):
        fail(f"serve f16: a kernel was not launched: {launches}")
    if any(len(o) != 64 for o in outs):
        fail("serve f16: a request did not produce 64 tokens")
    if eng.post_warmup_compiles() != 0:
        fail("serve f16: programs captured after warmup")
    eng.close()
    del eng
    solo = [generate(model, p, max_new_tokens=64, device=dev)[0][0].tolist()
            for p in greedy]
    splits = _splits(torch, model, dev, greedy, outs, solo, "serve f16",
                     tol=F16_MARGIN_TOL)
    print(f"serve f16: greedy streams equal to solo generate(): "
          f"{len(greedy) - len(splits)} of {len(greedy)}; splits at near "
          f"ties {splits}")
    del model
    torch.cuda.empty_cache()


def fixed_phase(torch, args, dev):
    """4-layer full-width engines on the fixed pool, captured: the f32
    engine's greedy streams equal solo generate(); the bf16 one's equal
    its uncaptured path's (solo generate() runs other shapes, whose bf16
    rounding may split a near tie).  Then the captured f32 engine swaps
    its weights (``swap_check``)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.serving import ServingEngine
    cfg = gpt2_medium_config(num_hidden_layers=4, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(args.seed + 1)
    prompts = [rng.randint(0, cfg.vocab_size, (n,))
               for n in (5, 17, 40, 64, 90, 120)]
    for dtype in (None, torch.bfloat16):
        model = GPTForPretraining(cfg, device=dev, seed=args.seed + 1).eval()
        if dtype is not None:
            amp.decorate(models=model, level="O2", dtype="bfloat16")
        streams, engines = [], []
        for uncaptured in (False, True):
            eng = ServingEngine(model, max_slots=SLOTS, max_len=256,
                                kv="fixed", dtype=dtype, device=dev)
            eng._run_uncaptured = uncaptured
            resps = [eng.submit(p, max_new_tokens=32) for p in prompts]
            eng.run_until_drained(timeout=300)
            counts = eng.compile_counts()
            if counts["total"] != counts["bound"] \
                    or eng.post_warmup_compiles() != 0:
                fail(f"fixed: captures {counts}, "
                     f"{eng.post_warmup_compiles()} after warmup")
            streams.append([r.tokens(timeout=5) for r in resps])
            engines.append(eng)
        if streams[0] != streams[1]:
            fail("fixed-pool captured streams differ from the uncaptured")
        if dtype is None:
            for p, got in zip(prompts, streams[0]):
                solo, _ = generate(model, p, max_new_tokens=32, device=dev)
                if got != solo[0].tolist():
                    fail("fixed-pool greedy stream differs from solo "
                         "generate()")
        print(f"fixed {'bf16' if dtype else 'f32'}: {len(prompts)} greedy "
              f"streams captured == uncaptured"
              + ("" if dtype else " == solo generate()")
              + f"; {counts['total']} CUDA graphs")
        if dtype is None:
            swap_check(torch, engines[0], cfg, prompts, dev, args.seed + 2)
        for eng in engines:
            eng.close()
        del model, engines
        torch.cuda.empty_cache()


def _flash_inputs(torch, rng, dev, b, sq, sk, h, d, dtype, bias=False,
                  seg=False):
    """q/k/v as views of one fused (B, S, 3, H, D) tensor, as GPT passes
    them; do, an optional bias and two-segment ids."""
    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).to(dtype)
    qkv = t(b, sq, 3, h, d)
    q = qkv[:, :, 0]
    if sk == sq:
        k, v = qkv[:, :, 1], qkv[:, :, 2]
    else:
        k, v = t(b, sk, h, d), t(b, sk, h, d)
    bi = qs = ks = None
    if bias:
        bi = torch.from_numpy(rng.randn(b, sk).astype(np.float32)).to(dev)
    if seg:
        qs = torch.zeros(b, sq, dtype=torch.int32, device=dev)
        ks = torch.zeros(b, sk, dtype=torch.int32, device=dev)
        qs[:, sq // 2:] = 1
        ks[:, sk // 3:] = 1
    return q, k, v, t(b, sq, h, d), bi, qs, ks


def flash_check(torch, fa, args, label):
    """K1 and K2 against their plain versions on the same inputs; returns
    the largest error and prints one line."""
    q, k, v, do, bi, qs, ks, seed, causal, p = args
    o, lse = fa.flash_fwd(q, k, v, bi, qs, ks, seed, causal, p)
    grads = fa.flash_bwd(q, k, v, bi, qs, ks, seed, o, lse, do, causal, p)
    po, plse = fa._plain_fwd(q, k, v, bi, qs, ks, seed, causal, p)
    pgrads = fa._plain_bwd(q, k, v, bi, qs, ks, seed, o, lse, do, causal, p)
    torch.cuda.synchronize()
    (oa, orl), (ga, grl) = FLASH_TOL[str(q.dtype).replace("torch.", "")]
    errs = {"o": max_err(torch, o, po, oa, orl),
            "lse": max_err(torch, lse, plse)}
    for name, g, pg in zip(("dq", "dk", "dv", "dbias"), grads, pgrads):
        if pg is not None:
            errs[name] = max_err(torch, g, pg, ga, grl)
    bad = [n for n, (_, ok) in errs.items() if not ok]
    print(f"check flash {label}: " + ", ".join(
        f"{n} {e:.2e}" for n, (e, _) in errs.items())
        + (f" OUT OF TOLERANCE: {bad}" if bad else ""))
    if bad:
        fail(f"flash attention disagrees with its plain version ({label}: "
             f"{bad})")
    return max(e for e, _ in errs.values())


FLASH_TC_KERNELS = ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel",
                    "flash_bwd_dkdv_tc_kernel")


def _cuobjdump() -> str:
    """cuobjdump from PATH, the toolkit, or Triton's bundled copy."""
    import shutil
    from pathlib import Path
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton
        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" /
                     "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in cands:
        if c.exists():
            return str(c)
    fail("cuobjdump not found (toolkit or triton/backends/nvidia/bin)")


def _kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol,
    e.g. flash_fwd_tc_kernel<64,64,1>: the last length-prefixed name of
    the (nested) symbol, then its integer and type arguments."""
    import re
    i = 2 if mangled.startswith("_Z") else 0
    i += mangled[i:i + 1] == "N"
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    rest = mangled[i:]
    if not rest.startswith("I"):
        return name
    dtype = {"If": ["f32"], "I13__nv_bfloat16": ["bf16"],
             "I6__half": ["f16"]}
    head = next((v for k, v in dtype.items() if rest.startswith(k)), [])
    args = head + re.findall(r"L[ib](\d+)E", rest)
    return f"{name}<{','.join(args)}>"


def flash_sass_check():
    """Tensor-core instructions (HMMA / HGMMA lines of the SASS) in every
    kernel of the built flash library; fails unless each of the 16-bit
    route's kernels (3 kinds x 3 head_dims x bf16 and float16) has some."""
    from paddle_tpu_torch.ops import _build
    lib = _build._target("flash_attention")
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            counts[name] = 0
        elif name and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    for n in sorted(counts):
        print(f"sass {n}: {counts[n]} HMMA/HGMMA")
    tc = {n: c for n, c in counts.items() if n.split("<")[0] in
          FLASH_TC_KERNELS}
    if len(tc) != 2 * 3 * len(FLASH_TC_KERNELS) or not all(tc.values()):
        fail(f"a 16-bit flash kernel has no tensor-core instruction: {tc}")
    return tc


def flash_phase(torch, rng, dev):
    """K1/K2 checked at the training shape in bf16, float16 and f32 and at
    small variant shapes; timed at the training shape in bf16 and float16
    per layer over 24 layers' tensors.  Returns the kernel table's rows
    (the bf16 route's); the float16 route's figures are printed beside."""
    from paddle_tpu_torch.ops import flash_attention as fa
    flash_sass_check()
    b, s, h, d, p = TRAIN_B, TRAIN_S, 16, 64, 0.1
    seed = torch.tensor([20260417], dtype=torch.int32, device=dev)
    err_f = {torch.bfloat16: 0.0, torch.float16: 0.0, torch.float32: 0.0}
    err_b = dict(err_f)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        ins = _flash_inputs(torch, rng, dev, b, s, s, h, d, dtype)
        e = flash_check(torch, fa, (*ins[:4], None, None, None, seed, True,
                                    p), f"{str(dtype)[6:]} B={b} S={s} "
                                        f"H={h} D={d} causal p={p}")
        err_f[dtype] = e
        torch.cuda.empty_cache()
    f16 = torch.float16
    for name, bb, sq, sk, hh, dd, dt, causal, bias, seg, pp in (
            ("bias", 2, 256, 256, 2, 64, torch.float32, False, True, False,
             0.0),
            ("segments", 2, 256, 256, 2, 128, torch.float32, False, False,
             True, 0.0),
            ("sk!=sq", 2, 128, 384, 2, 64, torch.bfloat16, True, False,
             False, 0.1),
            ("bias+dropout d256", 1, 256, 256, 2, 256, torch.float32, True,
             True, False, 0.2),
            ("segments d128", 2, 256, 256, 2, 128, torch.bfloat16, False,
             False, True, 0.0),
            ("bias+dropout d256", 1, 256, 256, 2, 256, torch.bfloat16, True,
             True, False, 0.2),
            ("bias", 2, 256, 256, 2, 64, f16, False, True, False, 0.0),
            ("segments d128", 2, 256, 256, 2, 128, f16, False, False, True,
             0.0),
            ("sk!=sq multi-tile dQ", 1, 128, 1024, 2, 64, f16, True, True,
             False, 0.1),
            ("bias+dropout d256", 1, 256, 256, 2, 256, f16, True, True,
             False, 0.2)):
        q, k, v, do, bi, qs, ks = _flash_inputs(
            torch, rng, dev, bb, sq, sk, hh, dd, dt, bias, seg)
        err_b[dt] = max(err_b[dt], flash_check(
            torch, fa, (q, k, v, do, bi, qs, ks, seed, causal, pp),
            f"{name} {str(dt)[6:]} B={bb} Sq={sq} Sk={sk} H={hh} D={dd}"))

    rows = {}
    for dt in (torch.bfloat16, torch.float16):
        rows[dt] = _flash_time(torch, fa, rng, dev, dt, seed,
                               err_f[dt], max(err_f[dt], err_b[dt]))
    for key in range(2):
        f16_line(rows[torch.bfloat16][key], rows[torch.float16][key])
    return rows[torch.bfloat16]


def _flash_time(torch, fa, rng, dev, dt, seed, err_f, err_b):
    """K1's and K2's rows of the kernel table in dtype dt at the training
    shape: ms per layer over 24 layers' distinct tensors (the step's
    working set), eager call, plain and SDPA times and the bound; for bf16
    also K2's bit-repeat and its peak memory."""
    b, s, h, d, p = TRAIN_B, TRAIN_S, 16, 64, 0.1
    tag = str(dt)[6:]
    layers = [_flash_inputs(torch, rng, dev, b, s, s, h, d, dt)[:4]
              for _ in range(LAYERS)]
    saved = [fa.flash_fwd(q, k, v, None, None, None, seed, True, p)
             for q, k, v, _ in layers]
    # K2 repeats bit for bit, and one call allocates no dQ partials
    q, k, v, do = layers[0]
    o, lse = saved[0]
    first = fa.flash_bwd(q, k, v, None, None, None, seed, o, lse, do, True,
                         p)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    second = fa.flash_bwd(q, k, v, None, None, None, seed, o, lse, do, True,
                          p)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    same = all(torch.equal(x, y) for x, y in zip(first[:3], second[:3]))
    partials = (s // 64) * b * h * s * d * 4
    print(f"check flash K2 repeat ({tag} B={b} S={s} H={h} D={d} causal "
          f"p={p}): dq, dk, dv {'bit-equal' if same else 'DIFFER'}; peak "
          f"memory of one call {peak / 2 ** 20:.1f} MiB (the f32 dQ "
          f"partials alone would be {partials / 2 ** 20:.1f} MiB)")
    if not same:
        fail("two flash backward calls on the same inputs differ")
    if peak >= partials:
        fail(f"a {tag} flash backward call took {peak} bytes")
    del first, second

    def fwd(f):
        def run():
            for q, k, v, _ in layers:
                f(q, k, v, None, None, None, seed, True, p)
        return run

    def bwd(f):
        def run():
            for (q, k, v, do), (o, lse) in zip(layers, saved):
                f(q, k, v, None, None, None, seed, o, lse, do, True, p)
        return run
    times = {"fwd": (graph_ms(torch, fwd(fa.flash_fwd)) / LAYERS,
                     call_ms(torch, fwd(fa.flash_fwd), 5) / LAYERS,
                     graph_ms(torch, fwd(fa._plain_fwd), 3) / LAYERS),
             "bwd": (graph_ms(torch, bwd(fa.flash_bwd)) / LAYERS,
                     call_ms(torch, bwd(fa.flash_bwd), 5) / LAYERS,
                     graph_ms(torch, bwd(fa._plain_bwd), 3) / LAYERS)}
    torch.cuda.empty_cache()
    # library yardstick: torch's SDPA, causal, dropout 0.1, on the same
    # inputs in its (B, H, S, D) view; backward = (fwd + grad) - fwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_in = [tuple(t.transpose(1, 2).detach().requires_grad_()
                    for t in (q, k, v)) + (do.transpose(1, 2),)
              for q, k, v, do in layers]

    def lib_fwd():
        for q, k, v, _ in lib_in:
            sdpa(q, k, v, is_causal=True, dropout_p=p)

    def lib_fwd_bwd():
        for q, k, v, do in lib_in:
            out = sdpa(q, k, v, is_causal=True, dropout_p=p)
            torch.autograd.grad(out, (q, k, v), do)
    lib_f = graph_ms(torch, lib_fwd) / LAYERS
    lib_b = graph_ms(torch, lib_fwd_bwd) / LAYERS - lib_f
    # bound per layer, from this run's shapes: each input read once, each
    # output written once; tensor-core operations over the visible
    # (causal) score pairs, 2 * D per pair and product (bf16 and float16
    # share the tensor cores' dense rate)
    elem = b * s * h * d * 2                       # one 16-bit (B, S, H, D)
    pairs = b * h * s * (s + 1) // 2
    rows = b * h * s * 4                           # one f32 (B, H, S)
    bound = {"fwd": bound_ms(3 * elem + elem + rows + 4, 2 * 2 * d * pairs,
                             BF16_OPS_PER_S),
             # q, k, v, o, do and lse in; dq, dk, dv out; 5 products
             "bwd": bound_ms(5 * elem + rows + 4 + 3 * elem,
                             5 * 2 * d * pairs, BF16_OPS_PER_S)}
    out = []
    for key, lib, err, line in (("fwd", lib_f, err_f, 257),
                                ("bwd", lib_b, err_b, 417)):
        ms, eager, plain = times[key]
        bms, by = bound[key]
        name = f"flash_attention_{key}" + ("_f16" if dt == torch.float16
                                             else "")
        print(f"time {name} ({tag}, per layer): {ms:.4f} ms "
              f"(call {eager:.4f}), plain {plain:.4f}, SDPA {lib:.4f}, "
              f"bound {bms:.4f} ({by})")
        out.append({"name": name, "route": "cuda",
                    "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                    "replaces": f"paddle_tpu/ops/flash_attention.py:{line}",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib,
                    "call_ms": eager})
    del layers, saved, lib_in
    torch.cuda.empty_cache()
    return out


def _train_batch(cfg, seed: int, b: int, s: int):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, cfg.vocab_size, (b, s)),
            rng.randint(0, cfg.vocab_size, (b, s)))


def train_leg(torch, make, batch, steps: int, counters, card: str,
              what: str, policy=None, uncaptured: bool = False, **prof):
    """One training run from a fresh model and TrainStep (``make()``, the
    same seed each time) under the recompute ``policy`` ((spec, policy) or
    None): ``warmup()`` (on the card the step's capture) timed, then
    ``steps`` steps on ``batch``, each timed to its end, with the launch
    counters zeroed just before the steps and read just after
    (``counters``: a callable that zeroes them and returns a reader); a
    steady step profiled (``device_profile``, keyword arguments ``prof``);
    the peak memory of one uncaptured step (the same program function
    without its graph; peak stats reset just before).  ``uncaptured``
    runs every step so (the A/B: programs, no graphs).  The model and the
    step are freed before it returns its numbers."""
    import gc
    from paddle_tpu_torch.jit import recompute_policy
    with recompute_policy(*policy) if policy else recompute_policy(None):
        model, step = make()
        step._run_uncaptured = uncaptured
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = step.warmup(*batch)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        made = step.compile_counts()["total"]
        read = counters()
        hist0 = _step_hist_count()
        losses, t_steps = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(step(*batch))
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
        progs = getattr(step, "_programs", {}).values()
        out = dict(losses=[float(x) for x in losses], launches=read(),
                   captured=bool(progs) and all(p.graph is not None
                                                for p in progs),
                   hist_steps=_step_hist_count() - hist0,
                   warm=warm, warm_s=warm_s,
                   recaptured=step.compile_counts()["total"] - made,
                   first_ms=t_steps[0] * 1e3,
                   steady_ms=float(np.median(t_steps[2:] or t_steps)) * 1e3)
        out["profile"] = device_profile(torch, lambda: step(*batch), 2,
                                        what, card, **prof)
        step._run_uncaptured = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*batch)
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, step
    gc.collect()          # a step and its programs' bound methods: a cycle
    torch.cuda.empty_cache()
    return out


def _step_hist_count() -> int:
    from paddle_tpu_torch import observability as obs
    h = obs.get_registry().get("train_step_seconds")
    return 0 if h is None else h.snapshot()["count"]


def _leg_line(tag: str, card: str, leg: dict, items: int, unit: str):
    wall, busy, _, kernels = leg["profile"]
    return (f"{tag} [{card}]: warmup {leg['warm_s']:.2f} s "
            f"(compiled {leg['warm']['compiled']}), first step "
            f"{leg['first_ms']:.1f} ms, steady step {leg['steady_ms']:.2f} ms "
            f"({items / leg['steady_ms'] * 1e3:.0f} {unit}/s); profiled: "
            f"wall {wall:.3f} ms, device "
            + (f"{busy:.3f} ms, idle {1 - busy / wall:.1%}"
               if busy else "not measured")
            + f", {kernels:.0f} kernels per step; peak memory of an "
            f"uncaptured step {leg['peak_gib']:.2f} GiB; captures after "
            f"warmup {leg['recaptured']}; launches {leg['launches']}")


def _check_recompute_losses(tag: str, got, want):
    """A recompute leg's losses against the plain leg's first steps: within
    1e-5 relative (bit-equality is the expectation); both printed."""
    want = want[:len(got)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"{tag}: losses {', '.join(repr(x) for x in got)} vs without "
          f"recompute {', '.join(repr(x) for x in want)}: "
          + ("bit-equal" if got == want else f"largest relative {rel:.2e}"))
    if not rel <= 1e-5:
        fail(f"{tag}: losses {got} differ from the plain run's {want}")


def train_phase(torch, args, dev, card):
    """GPT-2 medium, O1 bf16, AdamW(1e-4), dropout 0.1: the training leg of
    the main path, through the step's CUDA graph; then the same steps
    uncaptured (the A/B: losses bit-equal) and under
    recompute_policy("stages") with each policy (RECOMPUTE_STEPS steps:
    losses within 1e-5 relative of the plain run's, K1 twice per layer,
    peak memory below the plain run's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config()
    crit = GPTPretrainingCriterion()
    layers = cfg.num_hidden_layers

    def make():
        pt.seed(args.seed)
        model = GPTForPretraining(cfg, device=dev, seed=args.seed)
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
        return model, TrainStep(model, lambda logits, y: crit(logits, y),
                                opt, amp_level="O1", amp_dtype="bfloat16")

    def counters():
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        return lambda: {"flash_attention_fwd": fa.flash_fwd.launches,
                        "flash_attention_bwd": fa.flash_bwd.launches}
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    what = f"train step (GPT-2 medium, B {TRAIN_B} x S {TRAIN_S}, O1 bf16"
    tokens = TRAIN_B * TRAIN_S
    cap = train_leg(torch, make, batch, TRAIN_STEPS, counters, card,
                    what + ", captured)")
    vals = cap["losses"]
    print("train: losses " + ", ".join(f"{x:.4f}" for x in vals))
    print("train: losses in full (f32 values, to compare runs bit for bit) "
          + ", ".join(repr(x) for x in vals))
    if not all(np.isfinite(vals)):
        fail(f"non-finite training loss: {vals}")
    if not vals[-1] < vals[0]:
        fail(f"training loss did not fall: {vals[0]} -> {vals[-1]}")
    want = layers * TRAIN_STEPS
    if any(n != want for n in cap["launches"].values()):
        fail(f"flash launches {cap['launches']}, expected {want} each "
             f"({layers} layers x {TRAIN_STEPS} steps, through replays)")
    if not cap["warm"]["compiled"] or cap["recaptured"]:
        fail(f"train: warmup {cap['warm']}, {cap['recaptured']} captures "
             "after it (expected one capture, by warmup)")
    print(_leg_line("train captured", card, cap, tokens, "tokens"))
    print(f"train: train_step_seconds histogram counted {cap['hist_steps']} "
          f"calls over the {TRAIN_STEPS} steps")
    if cap["hist_steps"] != TRAIN_STEPS:
        fail(f"train: the train_step histogram counted "
             f"{cap['hist_steps']} of {TRAIN_STEPS} steps")
    unc = train_leg(torch, make, batch, TRAIN_STEPS, counters, card,
                    what + ", uncaptured)", uncaptured=True)
    print(_leg_line("train uncaptured", card, unc, tokens, "tokens"))
    if unc["losses"] != vals:
        fail(f"train: captured losses {vals} differ from the uncaptured "
             f"step's {unc['losses']}")
    print("train: captured and uncaptured losses bit-equal over "
          f"{TRAIN_STEPS} steps")
    for pol in ("dots_saveable", "nothing_saveable"):
        tag = f"train stages/{pol}"
        leg = train_leg(torch, make, batch, RECOMPUTE_STEPS, counters, card,
                        what + f", captured, recompute stages/{pol})",
                        policy=("stages", pol))
        print(_leg_line(tag, card, leg, tokens, "tokens"))
        _check_recompute_losses(tag, leg["losses"], vals)
        stated = {"flash_attention_fwd": 2 * layers * RECOMPUTE_STEPS,
                  "flash_attention_bwd": layers * RECOMPUTE_STEPS}
        if leg["launches"] != stated:
            fail(f"{tag}: flash launches {leg['launches']}, stated {stated}"
                 " (each block's region reruns K1 in the backward)")
        if not leg["peak_gib"] < cap["peak_gib"]:
            fail(f"{tag}: peak memory {leg['peak_gib']:.2f} GiB is not "
                 f"below the plain step's {cap['peak_gib']:.2f} GiB")
        print(f"{tag} [{card}]: device time {leg['profile'][1] or 0:.3f} "
              f"ms vs {cap['profile'][1] or 0:.3f} ms without recompute; "
              f"peak memory "
              f"{leg['peak_gib']:.2f} vs {cap['peak_gib']:.2f} GiB "
              f"({leg['peak_gib'] / cap['peak_gib']:.1%})")
    return cap["launches"]


def train_check_phase(torch, args, dev):
    """One f32 step of a 2-layer full-width GPT (dropout 0, B 1, S 1024):
    loss and every parameter gradient on the kernel path against the plain
    versions on the CPU, same weights and batch."""
    from paddle_tpu_torch.jit import forward_loss
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    crit = GPTPretrainingCriterion()
    batch = _train_batch(cfg, args.seed + 2, 1, TRAIN_S)
    gpu = GPTForPretraining(cfg, device=dev, seed=args.seed + 2)
    cpu = copy.deepcopy(gpu).cpu()
    out = []
    for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
        n0 = fa.flash_fwd.launches
        ids, lab = (torch.from_numpy(a).to(d) for a in batch)
        loss = forward_loss(model, lambda lg, y: crit(lg, y), (ids, lab))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           model.named_parameters()])
        out.append((float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)},
                    fa.flash_fwd.launches - n0))
    (lg, gg, ng), (lc, gc, _) = out
    if ng != cfg.num_hidden_layers:
        fail(f"the kernel path launched K1 {ng} times, not once per layer")
    worst = max(((gg[n] - gc[n]).abs().max() / gc[n].abs().max()
                 .clamp_min(1e-30)).item() for n in gc)
    print(f"traincheck: 2-layer f32 step, kernel path vs CPU plain path: "
          f"loss {lg:.6f} vs {lc:.6f}; largest gradient difference "
          f"{worst:.2e} of its tensor's max (tolerance {GRAD_TOL}) over "
          f"{len(gc)} parameters")
    if not abs(lg - lc) <= 1e-4 * abs(lc) or not worst <= GRAD_TOL:
        fail("the kernel-path training step disagrees with the plain path")
    del gpu, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# BERT / ERNIE pretraining (BASELINE configs #3 / #4, as bench.py runs them)
# ---------------------------------------------------------------------------

def _beam(torch, model, ids, new: int, k: int, dev):
    from paddle_tpu_torch.generation import generate
    return generate(model, ids, max_new_tokens=new, num_beams=k,
                    decode_strategy="beam_search", device=dev)


def _forced_logp(torch, model, ids, out):
    """The teacher-forced log-prob of each row's tokens ``out`` after its
    prompt ``ids`` (one full forward, no cache)."""
    with torch.inference_mode():
        full = torch.cat([ids, out.to(torch.long)], dim=1)
        logits = model(full)[:, ids.shape[1] - 1:-1].float()
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, 2, out.to(torch.long)[..., None]).sum(
            dim=(1, 2))


def beam_phase(torch, args, dev, card, model):
    """Beam search on the serve model (GPT-2 medium, int8, f32
    activations): generate(decode_strategy="beam_search", num_beams=4),
    B 2 x prompt 128, 64 new tokens, from --seed.  Gates: K4 launches =
    4 Linears x 24 layers x 64 forwards (the prefill and 63 steps);
    num_beams=1 equals greedy generate() token for token; each returned
    score within SCORE_TOL of the teacher-forced log-prob of its tokens;
    on a 2-layer copy at full width (16 new tokens) the card's beams equal
    the CPU plain path's, or, at a near tie, the card's best beam scores
    within SCORE_TOL of the CPU's best on the CPU path.  Prints ms per
    token."""
    from paddle_tpu_torch.generation import generate
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.quantization import quantize_for_serving
    cfg = model.gpt.config
    layers = cfg.num_hidden_layers
    rng = np.random.RandomState(args.seed + 6)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (BEAM_B, BEAM_PROMPT))).to(dev)
    _beam(torch, model, ids, 2, BEAM_K, dev)          # first-use set-up
    torch.cuda.synchronize()
    im.dequant_matmul.launches = 0
    t0 = time.perf_counter()
    out, scores = _beam(torch, model, ids, BEAM_NEW, BEAM_K, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = im.dequant_matmul.launches
    want = 4 * layers * BEAM_NEW
    print(f"beam [{card}]: num_beams={BEAM_K}, B {BEAM_B} x prompt "
          f"{BEAM_PROMPT}, {BEAM_NEW} new tokens in {wall:.3f}s: "
          f"{wall / BEAM_NEW * 1e3:.2f} ms per token "
          f"({BEAM_B * BEAM_NEW / wall:.1f} tokens/s over the batch); K4 "
          f"launches {launches} (stated {want}); scores "
          f"{[round(float(x), 4) for x in scores]}")
    if launches != want:
        fail(f"beam: {launches} K4 launches, stated {want}")
    if out.shape != (BEAM_B, BEAM_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()):
        fail(f"beam: output {tuple(out.shape)} or a token out of the "
             "vocabulary")
    one, _ = _beam(torch, model, ids, BEAM_NEW, 1, dev)
    greedy, _ = generate(model, ids, max_new_tokens=BEAM_NEW, device=dev)
    if not torch.equal(one, greedy):
        fail("beam: num_beams=1 differs from greedy generate()")
    forced = _forced_logp(torch, model, ids, out)
    err = float((forced - scores).abs().max())
    print(f"beam: num_beams=1 == greedy (B {BEAM_B} x {BEAM_NEW}); scores "
          f"vs teacher-forced log-probs: max abs err {err:.3e} (tolerance "
          f"{SCORE_TOL})")
    if not err <= SCORE_TOL:
        fail(f"beam: scores differ from the teacher-forced log-probs "
             f"({err:.3e})")
    small_cfg = gpt2_medium_config(num_hidden_layers=2,
                                   hidden_dropout_prob=0.0,
                                   attention_probs_dropout_prob=0.0)
    small = quantize_for_serving(GPTForPretraining(
        small_cfg, device=dev, seed=args.seed + 7).eval())
    card_out, card_sc = _beam(torch, small, ids, BEAM_CHECK_NEW, BEAM_K, dev)
    cpu = copy.deepcopy(small).cpu()
    cpu_out, cpu_sc = _beam(torch, cpu, ids.cpu(), BEAM_CHECK_NEW, BEAM_K,
                            "cpu")
    card_out = card_out.cpu()
    if torch.equal(card_out, cpu_out):
        print(f"beam: 2-layer full-width beams on the card equal the CPU "
              f"plain path's (B {BEAM_B} x {BEAM_CHECK_NEW}); scores "
              f"{card_sc.tolist()} vs {cpu_sc.tolist()}")
    else:
        rescored = _forced_logp(torch, cpu, ids.cpu(), card_out)
        gap = float((rescored - cpu_sc).abs().max())
        print(f"beam: 2-layer beams split from the CPU's at a tie: the "
              f"card's best beams score {rescored.tolist()} on the CPU "
              f"path against its own best {cpu_sc.tolist()} (gap {gap:.3e})")
        if not gap <= SCORE_TOL:
            fail(f"beam: the card's 2-layer beams differ from the CPU's "
                 f"beyond a near tie ({gap:.3e})")
    del small, cpu
    torch.cuda.empty_cache()


def _event_ms(torch, fn):
    """(fn()'s result, its ms by CUDA events, synchronized)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _dlrm_batches(torch, cfg, seed: int, n: int, dev):
    """n batches: dense features N(0, 1), ids per feature from a power law
    (zipf 1.2, folded into the vocabulary: low ids repeat), labels
    Bernoulli(0.25)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = np.stack([(rng.zipf(1.2, DLRM_B) - 1) % v
                        for v in cfg.vocab_sizes], 1)
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (
            rng.randn(DLRM_B, cfg.dense_dim).astype(np.float32), ids,
            (rng.rand(DLRM_B, 1) < 0.25).astype(np.float32))))
    return out


def dlrm_phase(torch, args, dev, card):
    """DLRM at Criteo Kaggle widths: sparse (lazy Adam) against dense
    TrainStep, captured (module docstring, 13d)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import DLRM, DLRMConfig, DLRMCriterion
    cfg = DLRMConfig(dense_dim=13, vocab_sizes=CRITEO_KAGGLE,
                     embedding_dim=16, bottom_mlp=(512, 256, 64),
                     top_mlp=(512, 256))
    batches = _dlrm_batches(torch, cfg, args.seed, DLRM_STEPS, dev)
    offsets = torch.from_numpy(cfg.offsets).to(dev)
    rows = [(b[1] + offsets).reshape(-1) for b in batches]
    uniq = [int(torch.unique(r).numel()) for r in rows]
    print(f"dlrm: {cfg.total_rows:,} rows x {cfg.embedding_dim} "
          f"({cfg.total_rows * cfg.embedding_dim * 4 / 1e9:.2f} GB f32), "
          f"B {DLRM_B}: {DLRM_B * cfg.num_features} lookups per step, "
          f"unique rows per step {uniq}")

    def make(mode, uncaptured=False):
        model = DLRM(cfg, embedding=mode, device=dev, seed=args.seed)
        opt = pt.optimizer.Adam(1e-3, parameters=model.parameters())
        step = TrainStep(model, DLRMCriterion(), opt)
        step._run_uncaptured = uncaptured
        return model, step

    legs = {}
    for mode in ("sparse", "dense"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model, step = make(mode)
        init = model.table.weight.detach().clone() if mode == "sparse" \
            else None
        t0 = time.perf_counter()
        step.warmup(*batches[0])
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        losses, ms = [], []
        for i, b in enumerate(batches):
            loss, t = _event_ms(torch, lambda: step(*b))
            losses.append(float(loss))
            ms.append(t)
            if i == 0:
                first = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(np.isfinite(losses)):
            fail(f"dlrm {mode}: non-finite losses {losses}")
        if step.compile_counts()["total"] != 1:
            fail(f"dlrm {mode}: {step.compile_counts()} captures, expected 1")
        steady = float(np.median(ms[1:]))
        print(f"dlrm {mode} [{card}]: warmup (capture) {warm_s:.2f} s; "
              f"ms per step {', '.join(f'{t:.3f}' for t in ms)} (steady "
              f"{steady:.3f}, {DLRM_B / steady * 1e3:.0f} samples/s); peak "
              f"memory {peak:.2f} GiB; losses "
              + ", ".join(repr(x) for x in losses))
        prof = device_profile(torch, lambda: step(*batches[-1]), 3,
                              f"dlrm {mode} step (B {DLRM_B}, captured)",
                              card)
        legs[mode] = dict(losses=losses, first=first, steady=steady,
                          peak=peak, prof=prof)
        if mode == "sparse":
            touched = torch.zeros(cfg.total_rows, dtype=torch.bool,
                                  device=dev)
            for r in rows:
                touched[r] = True
            w = model.table.weight.detach()
            if not torch.equal(w[~touched], init[~touched]):
                fail("dlrm sparse: rows no batch touched moved")
            moved = int((w[touched] != init[touched]).any(1).sum())
            print(f"dlrm sparse: {int((~touched).sum()):,} untouched rows "
                  f"bit-equal after {DLRM_STEPS} steps; {moved:,} of "
                  f"{int(touched.sum()):,} touched rows moved")
            del init, touched, w
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    sp, de = legs["sparse"], legs["dense"]
    dl = abs(sp["losses"][0] - de["losses"][0])
    ds = max(float((v.float() - de["first"][k].float()).abs().max())
             for k, v in sp["first"].items())
    print(f"dlrm: first step sparse vs dense: loss {dl:.3e}, state "
          f"{ds:.3e} (max abs)")
    if dl > 1e-6 or ds > 1e-6:
        fail(f"dlrm: the first sparse step differs from the dense one "
             f"(loss {dl}, state {ds})")
    del legs
    gc.collect()
    torch.cuda.empty_cache()
    # one uncaptured sparse step against the captured one
    got = []
    for uncaptured in (False, True):
        model, step = make("sparse", uncaptured)
        got.append((float(step(*batches[0])),
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()}))
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    du = max(float((v - got[1][1][k]).abs().max())
             for k, v in got[0][1].items())
    print(f"dlrm: captured vs uncaptured sparse step: loss "
          f"{abs(got[0][0] - got[1][0]):.3e}, state {du:.3e} (max abs)")
    if abs(got[0][0] - got[1][0]) > 1e-6 or du > 1e-6:
        fail("dlrm: the captured sparse step differs from the uncaptured")
    print(f"dlrm [{card}]: sparse lazy Adam {sp['steady']:.3f} ms / "
          f"{sp['peak']:.2f} GiB against dense Adam {de['steady']:.3f} ms / "
          f"{de['peak']:.2f} GiB per step ({de['steady'] / sp['steady']:.1f}x)")


def _gpt_train_make(torch, args, dev, cfg):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion)
    pt.seed(args.seed)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed)
    crit = GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    return model, (lambda logits, y: crit(logits, y)), opt


def trainexport_phase(torch, args, dev, card):
    """GPT-2 medium's O1 step exported and stepped by TrainSession against
    TrainStep from the same state (module docstring, 13e)."""
    import shutil
    from paddle_tpu_torch.jit import (TrainSession, TrainStep,
                                      save_train_program)
    from paddle_tpu_torch.models import gpt2_medium_config
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config()
    layers = cfg.num_hidden_layers
    batches = [tuple(torch.from_numpy(a).to(dev) for a in _train_batch(
        cfg, args.seed + i, TRAIN_B, TRAIN_S)) for i in range(EXPORT_STEPS)]
    root = _build_dir("trainexport")
    path = f"{root}/gpt2_medium"
    model, loss_fn, opt = _gpt_train_make(torch, args, dev, cfg)
    t0 = time.perf_counter()
    save_train_program(model, loss_fn, opt, path,
                       [(tuple(b.shape), "int64") for b in batches[0]],
                       amp_level="O1", amp_dtype="bfloat16", seed=args.seed)
    save_s = time.perf_counter() - t0
    sizes = {ext: os.path.getsize(path + ext) / 2 ** 20
             for ext in (".pdtrain", ".pdstate.npz", ".pdtrainmeta")}
    step = TrainStep(model, loss_fn, opt, amp_level="O1",
                     amp_dtype="bfloat16")
    t0 = time.perf_counter()
    sess = TrainSession(path, device=dev)
    load_s = time.perf_counter() - t0
    print(f"trainexport [{card}]: saved in {save_s:.1f} s ("
          + ", ".join(f"{k} {v:.2f} MiB" for k, v in sizes.items())
          + f"), loaded in {load_s:.1f} s")
    got, want, ms, ms_ref, launches = [], [], [], [], []
    for i, b in enumerate(batches):
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        loss, t = _event_ms(torch, lambda: sess.step(*b))
        got.append(loss)
        ms.append(t)
        launches.append((fa.flash_fwd.launches, fa.flash_bwd.launches))
        loss, t = _event_ms(torch, lambda: float(step(*b)))
        want.append(loss)
        ms_ref.append(t)
    print(f"trainexport [{card}]: TrainSession losses "
          + ", ".join(repr(x) for x in got) + "; TrainStep "
          + ", ".join(repr(x) for x in want))
    print(f"trainexport [{card}]: ms per step (CUDA events, the first a "
          f"capture) session {', '.join(f'{t:.2f}' for t in ms)}, "
          f"TrainStep {', '.join(f'{t:.2f}' for t in ms_ref)}; K1 / K2 "
          f"launches per session step {launches}")
    if not all(np.isfinite(got)):
        fail(f"trainexport: non-finite session losses {got}")
    worst = max(abs(a - b) for a, b in zip(got, want))
    if worst > 2e-2:
        fail(f"trainexport: session losses {got} differ from TrainStep's "
             f"{want} by {worst:.3e} (> 2e-2)")
    if any(n != (layers, layers) for n in launches[1:]):
        fail(f"trainexport: K1 / K2 launches per step {launches[1:]}, "
             f"expected {layers} each")
    del sess, step, model, opt
    gc.collect()
    shutil.rmtree(root, ignore_errors=True)


def tostatic_phase(torch, args, dev, card):
    """GPT-2 medium's f32 eval forward through to_static (module
    docstring, 13f)."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.models import gpt2_medium_config
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = gpt2_medium_config()
    model, _, _ = _gpt_train_make(torch, args, dev, cfg)
    model.eval()
    sf = to_static(model)
    ids = [torch.from_numpy(_train_batch(cfg, args.seed, b, TRAIN_S)[0])
           .to(dev) for b in (TRAIN_B, TRAIN_B, TRAIN_B // 2)]
    worst, ms, ms_eager, k1 = 0.0, [], [], []
    for x in ids:
        fa.flash_fwd.launches = 0
        out, t = _event_ms(torch, lambda: sf(x))
        k1.append(fa.flash_fwd.launches)
        ms.append(t)
        with torch.no_grad():
            ref, t = _event_ms(torch, lambda: model(x))
        ms_eager.append(t)
        worst = max(worst, float((out - ref).abs().max()))
        del out, ref
    counts = sf.compile_counts()["total"]
    print(f"tostatic [{card}]: max |static - eager| {worst:.3e}; captures "
          f"{counts} for 2 signatures; K1 launches per call {k1}; ms per "
          f"call (the first of each signature a capture) "
          f"{', '.join(f'{t:.2f}' for t in ms)} against eager "
          f"{', '.join(f'{t:.2f}' for t in ms_eager)}")
    if worst > 2e-3:
        fail(f"tostatic: static logits differ from eager by {worst}")
    if counts != 2:
        fail(f"tostatic: {counts} captures for 2 signatures")
    layers = cfg.num_hidden_layers
    if k1 != [2 * layers, layers, 2 * layers]:
        fail(f"tostatic: K1 launches per call {k1}, expected "
             f"{[2 * layers, layers, 2 * layers]} (a signature's first "
             "call captures: its warm run and the replay)")
    del sf, model
    gc.collect()


def guard_phase(torch, args, dev, card):
    """TrainStep(guard=True) on GPT-2 medium (the train phase's model,
    batch and O1 step), captured, with PDTPU_FAULT_NAN_GRADS armed at step
    GUARD_POISONED when the step is captured: GUARD_STEPS steps.  Gates:
    at the poisoned step last_guard is false and the parameters and both
    AdamW moments are bit-equal before and after it; every other step's
    guard is true and moves them; K1 / K2 launch 24 times per step
    through the replays; nothing is captured after warmup; the losses are
    finite."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.utils import faults
    cfg = gpt2_medium_config()
    crit = GPTPretrainingCriterion()
    pt.seed(args.seed)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed)
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = TrainStep(model, lambda logits, y: crit(logits, y), opt,
                     amp_level="O1", amp_dtype="bfloat16", guard=True)
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    faults.enable("nan_grads", str(GUARD_POISONED))
    try:
        warm = step.warmup(*batch)
    finally:
        faults.disable("nan_grads")
    made = step.compile_counts()["total"]
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    oks, losses, moved, ms = [], [], [], []
    for i in range(1, GUARD_STEPS + 1):
        state = step._state_tensors()[:-2]    # parameters, buffers, moments
        before = [t.clone() for t in state]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = step(*batch)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
        oks.append(bool(step.last_guard[1]))
        same = sum(torch.equal(a, b) for a, b in zip(before, state))
        moved.append(len(state) - same)
        del before
    launches = {"flash_attention_fwd": fa.flash_fwd.launches,
                "flash_attention_bwd": fa.flash_bwd.launches}
    recaptured = step.compile_counts()["total"] - made
    print(f"guard [{card}]: GPT-2 medium TrainStep(guard=True), captured "
          f"(warmup {warm}), PDTPU_FAULT_NAN_GRADS={GUARD_POISONED}: "
          f"guard verdicts {oks}, losses {[round(x, 4) for x in losses]}, "
          f"state tensors moved per step {moved} of "
          f"{len(step._state_tensors()) - 2}; launches {launches}; "
          f"captures after warmup {recaptured}; ms per step (CUDA events "
          f"around each replay) {[round(x, 3) for x in ms]}")
    want = [i != GUARD_POISONED for i in range(1, GUARD_STEPS + 1)]
    if oks != want:
        fail(f"guard: verdicts {oks}, want {want}")
    if moved[GUARD_POISONED - 1] != 0:
        fail(f"guard: the poisoned step moved {moved[GUARD_POISONED - 1]} "
             "state tensors")
    if not all(moved[i - 1] > 0 for i in range(1, GUARD_STEPS + 1)
               if i != GUARD_POISONED):
        fail(f"guard: a healthy step moved nothing: {moved}")
    if recaptured or not warm["compiled"]:
        fail(f"guard: warmup {warm}, {recaptured} captures after it")
    stated = cfg.num_hidden_layers * GUARD_STEPS
    if any(n != stated for n in launches.values()):
        fail(f"guard: flash launches {launches}, stated {stated} each")
    if not all(np.isfinite(losses)):
        fail(f"guard: non-finite losses {losses}")
    del model, step, opt
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return [x for i, x in enumerate(ms, 1) if i != GUARD_POISONED]


def _amp16_eager(torch, args, dev, card, cfg, batch):
    """(a) AMP16_EAGER_STEPS eager GPT-2 medium steps under
    auto_cast(dtype="float16") with GradScaler: scale(loss).backward(),
    step(opt), clear_grad().  Gates: finite losses, K1 / K2 launched once
    per layer and step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion)
    from paddle_tpu_torch.ops import flash_attention as fa
    crit = GPTPretrainingCriterion()
    pt.seed(args.seed)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed)
    model.train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    scaler = pt.amp.GradScaler()
    ids, labels = batch
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    losses, scales, ms = [], [], []
    for _ in range(AMP16_EAGER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pt.amp.auto_cast(dtype="float16"):
            loss = crit(model(ids), labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
        scales.append(scaler.get_init_loss_scaling())
    launches = {"flash_attention_fwd": fa.flash_fwd.launches,
                "flash_attention_bwd": fa.flash_bwd.launches}
    print(f"amp16 eager [{card}]: GPT-2 medium, auto_cast(float16) + "
          f"GradScaler, B {TRAIN_B} x S {TRAIN_S}: losses "
          f"{[round(x, 4) for x in losses]}, loss scale after each step "
          f"{scales}, ms per step (host clock to a synchronize) "
          f"{[round(x, 1) for x in ms]}; launches {launches}")
    if not all(np.isfinite(losses)):
        fail(f"amp16 eager: non-finite losses {losses}")
    want = cfg.num_hidden_layers * AMP16_EAGER_STEPS
    if any(n != want for n in launches.values()):
        fail(f"amp16 eager: flash launches {launches}, expected {want} each")
    del model, opt
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def amp16_phase(torch, args, dev, card, guard_ms=None):
    """GPT-2 medium in float16 at the train phase's batch.  (a) Eager
    steps under GradScaler (``_amp16_eager``).  (b) GuardedTrainStep over
    TrainStep(amp_dtype="float16", amp_level="O1", guard=True), captured
    by warmup with PDTPU_FAULT_NAN_GRADS armed for steps 3..5: step 3 is
    skipped on the device (parameters and moments bit-equal, the scale
    halved once, one quarantine record).  (c) Steps 4 and 5 are bad too:
    the third bad step rolls back to the checkpoint that
    AsyncCheckpointManager wrote after step 2 (parameters bit-equal to
    those saved, the scaler's state the saved one).  No capture after
    warmup; K1 / K2 once per layer and step.  Prints the guarded float16
    ms per step beside the guard phase's bf16 one, and the save's stall
    on the training thread against CheckpointManager.save's for the same
    state.  ``guard_ms``: the guard phase's bf16 ms per healthy step, when
    it ran in this call."""
    import gc
    import json as _json
    import os
    import shutil
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.utils import faults
    from paddle_tpu_torch.utils.guarded import GuardedTrainStep
    cfg = gpt2_medium_config()
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    _amp16_eager(torch, args, dev, card, cfg, batch)

    crit = GPTPretrainingCriterion()
    pt.seed(args.seed)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed)
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    inner = TrainStep(model, lambda logits, y: crit(logits, y), opt,
                      amp_level="O1", amp_dtype="float16", guard=True)
    root = _build_dir("amp16")
    ckpt = os.path.join(root, "guarded")
    scaler = pt.amp.GradScaler()
    gstep = GuardedTrainStep(inner, checkpoint_dir=ckpt, scaler=scaler,
                             max_bad_steps=AMP16_BAD)
    faults.enable("nan_grads", f"{AMP16_NAN[0]}:{AMP16_NAN[1]}")
    try:
        warm = inner.warmup(*batch)
    finally:
        faults.disable("nan_grads")
    made = inner.compile_counts()["total"]
    am = dck.AsyncCheckpointManager(ckpt, max_to_keep=2)
    fa.flash_fwd.launches = fa.flash_bwd.launches = 0
    losses, ms, skipped, saved = [], [], [], None
    for i in range(1, AMP16_NAN[1]):
        if i == AMP16_NAN[0]:
            state = inner._state_tensors()[:-2]
            before = [t.clone() for t in state]
            scale_before = scaler.get_init_loss_scaling()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = gstep(*batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        skipped.append(gstep.last_skipped)
        if i == AMP16_NAN[0]:
            same = sum(torch.equal(a, b) for a, b in zip(before, state))
            del before
            with open(os.path.join(ckpt, "quarantine.jsonl")) as f:
                recs = [_json.loads(line) for line in f]
            print(f"amp16 guarded: poisoned step {i}: {same} of "
                  f"{len(state)} state tensors bit-equal; scale "
                  f"{scale_before} -> {scaler.get_init_loss_scaling()}; "
                  f"quarantine records {len(recs)}: {recs}")
            if same != len(state):
                fail(f"amp16 guarded: the poisoned step moved "
                     f"{len(state) - same} state tensors")
            if scaler.get_init_loss_scaling() != scale_before / 2:
                fail("amp16 guarded: the scale did not halve once")
            if len(recs) != 1 or recs[0]["reason"] != "nonfinite":
                fail(f"amp16 guarded: quarantine holds {recs}")
        if i == AMP16_SAVE_AT:
            saved = _amp16_saves(torch, am, inner, model, opt, scaler, root,
                                 card)
    launches = {"flash_attention_fwd": fa.flash_fwd.launches,
                "flash_attention_bwd": fa.flash_bwd.launches}
    rec = gstep.quarantine[-1]
    rolled = [torch.equal(p.detach(), w)
              for p, w in zip(model.parameters(), saved["params"])]
    recaptured = inner.compile_counts()["total"] - made
    healthy = [x for i, x in enumerate(ms, 1) if i < AMP16_NAN[0]]
    bf16 = guard_ms
    print(f"amp16 guarded [{card}]: GPT-2 medium GuardedTrainStep(TrainStep("
          f"O1 float16, guard=True)), captured (warmup {warm}), NaN window "
          f"{AMP16_NAN}: losses {[round(x, 4) for x in losses]}, skipped "
          f"{skipped}; last record {rec}; parameters after the rollback "
          f"bit-equal to those saved: {sum(rolled)} of {len(rolled)}; "
          f"scaler {scaler.state_dict()} vs saved {saved['scaler']}; "
          f"captures after warmup {recaptured}; launches {launches}")
    print(f"amp16 guarded [{card}]: ms per healthy step (host clock to a "
          f"synchronize, one host read each) "
          f"{[round(x, 2) for x in healthy]}; the guard phase's bf16 "
          + (f"{[round(x, 2) for x in bf16]} (CUDA events)" if bf16 else
             "not run in this call"))
    if rec.get("rolled_back_to") != AMP16_SAVE_AT:
        fail(f"amp16 rollback: the last record is {rec}")
    if not all(rolled):
        fail(f"amp16 rollback: {len(rolled) - sum(rolled)} parameters differ "
             "from those saved")
    if scaler.state_dict() != saved["scaler"]:
        fail(f"amp16 rollback: scaler {scaler.state_dict()}, saved "
             f"{saved['scaler']}")
    if recaptured or not warm["compiled"]:
        fail(f"amp16 guarded: warmup {warm}, {recaptured} captures after")
    want = cfg.num_hidden_layers * (AMP16_NAN[1] - 1)
    if any(n != want for n in launches.values()):
        fail(f"amp16 guarded: flash launches {launches}, expected {want}")
    if not all(np.isfinite(losses)):
        fail(f"amp16 guarded: non-finite losses {losses}")
    am.close()
    del model, opt, inner, gstep, saved
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)


def _amp16_saves(torch, am, inner, model, opt, scaler, root, card):
    """The rollback's checkpoint by AsyncCheckpointManager (its stall on
    the training thread timed), then the same state by
    CheckpointManager.save (timed) into another directory.  Returns what
    was saved: device clones of the parameters and the scaler's state."""
    import os
    from paddle_tpu_torch.distributed import checkpoint as dck
    from paddle_tpu_torch.jit import state_arrays
    params = [p.detach().clone() for p in model.parameters()]
    tree = {"params": state_arrays(model), "opt": inner._opt_state}
    nbytes = sum(t.numel() * t.element_size() for t in
                 dck._flatten(tree).values())
    extra = dck.train_state_extras(opt, None, scaler, None,
                                  generator=inner._gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    am.save(tree, opt._step_count, extra)
    stall_async = time.perf_counter() - t0
    t0 = time.perf_counter()
    am.wait_until_finished()
    write_async = time.perf_counter() - t0
    sync = dck.CheckpointManager(os.path.join(root, "sync"))
    t0 = time.perf_counter()
    sync.save(tree, opt._step_count, extra)
    stall_sync = time.perf_counter() - t0
    print(f"amp16 checkpoint [{card}]: {nbytes / 2 ** 30:.2f} GiB (GPT-2 "
          f"medium parameters and AdamW moments): AsyncCheckpointManager."
          f"save stalled the training thread {stall_async:.3f} s (pinned "
          f"snapshot + enqueue; the writer took {write_async:.3f} s more); "
          f"CheckpointManager.save {stall_sync:.3f} s")
    return {"params": params, "scaler": scaler.state_dict()}


def _bert_large(**kw):
    from paddle_tpu_torch.models import bert_large_config
    return bert_large_config(vocab_size=BERT_VOCAB,
                             max_position_embeddings=BERT_S, **kw)


def _bert_decay(name):
    return "bias" not in name and "norm" not in name


def _bert_batch(torch, dev, vocab: int, seed: int, padded: bool):
    """bench.py's batch (ids, MLM labels on every position) or the padded
    leg's (ids, two segments, positions, the padding mask with lengths
    drawn from 128..512, labels on 15% of the real tokens, -100 elsewhere),
    B 8 x S 512, from ``seed``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (BERT_B, BERT_S))
    if not padded:
        lab = rng.randint(0, vocab, (BERT_B, BERT_S))
        return tuple(torch.from_numpy(a).to(dev) for a in (ids, lab))
    lens = rng.randint(128, BERT_S + 1, (BERT_B,))
    keys = np.arange(BERT_S)[None, :]
    mask = (keys < lens[:, None]).astype(np.int64)
    tt = ((keys >= (lens // 2)[:, None]) & (mask > 0)).astype(np.int64)
    pos = np.broadcast_to(np.arange(BERT_S), (BERT_B, BERT_S))
    lab = np.where((rng.rand(BERT_B, BERT_S) < 0.15) & (mask > 0), ids, -100)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (ids, tt, pos, mask, lab))


def _bert_maker(torch, args, dev, ernie: bool = False, schedule=None,
                **cfg_kw):
    """make() for train_leg: the model from --seed, bench.py's AdamW
    (decay off for biases and norms; lr 1e-4 or ``schedule()``), and
    TrainStep(O1 bf16) on (logits, nsp, labels)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion,
                                         ErnieForPretraining,
                                         ernie_large_config)
    crit = BertPretrainingCriterion()

    def make():
        pt.seed(args.seed)
        if ernie:
            model = ErnieForPretraining(
                ernie_large_config(max_position_embeddings=BERT_S, **cfg_kw),
                device=dev, seed=args.seed)
        else:
            model = BertForPretraining(_bert_large(**cfg_kw), device=dev,
                                       seed=args.seed)
        opt = pt.optimizer.AdamW(
            learning_rate=schedule() if schedule else 1e-4,
            parameters=model.parameters(),
            apply_decay_param_fun=_bert_decay)
        return model, TrainStep(model, lambda lg, nsp, y: crit(lg, nsp, y),
                                opt, amp_level="O1", amp_dtype="bfloat16")
    return make


def _flash_counters(torch):
    from paddle_tpu_torch.ops import flash_attention as fa

    def counters():
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        return lambda: {"flash_attention_fwd": fa.flash_fwd.launches,
                        "flash_attention_bwd": fa.flash_bwd.launches}
    return counters


def _bert_leg(torch, tag, card, make, batch, layers, uncaptured=False):
    """BERT_STEPS steps through train_leg; finite losses, K1 / K2 once per
    layer per step through the replays, one capture and none after."""
    what = (f"{tag} train step (B {BERT_B} x S {BERT_S}, O1 bf16, "
            + ("uncaptured)" if uncaptured else "captured)"))
    leg = train_leg(torch, make, batch, BERT_STEPS, _flash_counters(torch),
                    card, what, uncaptured=uncaptured)
    vals = leg["losses"]
    print(f"{tag}: losses " + ", ".join(f"{x:.4f}" for x in vals))
    print(f"{tag}: losses in full " + ", ".join(repr(x) for x in vals))
    if not all(np.isfinite(vals)):
        fail(f"{tag}: non-finite training loss: {vals}")
    want = layers * BERT_STEPS
    if any(n != want for n in leg["launches"].values()):
        fail(f"{tag}: flash launches {leg['launches']}, expected {want} "
             f"each ({layers} layers x {BERT_STEPS} steps, through replays)")
    if not leg["warm"]["compiled"] or leg["recaptured"]:
        fail(f"{tag}: warmup {leg['warm']}, {leg['recaptured']} captures "
             "after it (expected one capture, by warmup)")
    print(_leg_line(tag + (" uncaptured" if uncaptured else " captured"),
                    card, leg, BERT_B * BERT_S, "tokens"))
    return leg


def bert_flash_time(torch, rng, dev, card):
    """(f) K1 / K2 at BERT-large's attention shape (B 8, S 512, H 16,
    D 64, non-causal, the padding bias of lengths 128..512, dropout 0.1):
    checked against their plain versions in bf16 and f32, then timed per
    layer over 24 layers' bf16 tensors beside the bound (the visible
    pairs only), SDPA with the (B, 1, 1, S) additive mask and dropout 0.1,
    and K1 / K2 without the bias (K2's: what the unneeded dbias costs)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d, p = BERT_B, BERT_S, 16, 64, 0.1
    seed = torch.tensor([20261018], dtype=torch.int32, device=dev)
    lens = rng.randint(128, s + 1, (b,))
    bias = torch.from_numpy(np.where(np.arange(s)[None] < lens[:, None],
                                     0.0, -1e4).astype(np.float32)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do, _, _, _ = _flash_inputs(torch, rng, dev, b, s, s, h, d,
                                             dtype)
        flash_check(torch, fa, (q, k, v, do, bias, None, None, seed, False,
                                p), f"bert {str(dtype)[6:]} B={b} S={s} "
                                    f"H={h} D={d} bias p={p}")
        del q, k, v, do
        torch.cuda.empty_cache()
    layers = [_flash_inputs(torch, rng, dev, b, s, s, h, d,
                            torch.bfloat16)[:4] for _ in range(LAYERS)]
    saved = [fa.flash_fwd(q, k, v, bias, None, None, seed, False, p)
             for q, k, v, _ in layers]
    nob = [fa.flash_fwd(q, k, v, None, None, None, seed, False, p)
           for q, k, v, _ in layers]

    def fwd(f, bi=bias):
        def run():
            for q, k, v, _ in layers:
                f(q, k, v, bi, None, None, seed, False, p)
        return run

    def bwd(f, bi=bias, outs=saved):
        def run():
            for (q, k, v, do), (o, lse) in zip(layers, outs):
                f(q, k, v, bi, None, None, seed, o, lse, do, False, p)
        return run
    ms = {"fwd": (graph_ms(torch, fwd(fa.flash_fwd)) / LAYERS,
                  call_ms(torch, fwd(fa.flash_fwd), 5) / LAYERS,
                  graph_ms(torch, fwd(fa._plain_fwd), 3) / LAYERS),
          "bwd": (graph_ms(torch, bwd(fa.flash_bwd)) / LAYERS,
                  call_ms(torch, bwd(fa.flash_bwd), 5) / LAYERS,
                  graph_ms(torch, bwd(fa._plain_bwd), 3) / LAYERS)}
    nobias = (graph_ms(torch, fwd(fa.flash_fwd, None)) / LAYERS,
              graph_ms(torch, bwd(fa.flash_bwd, None, nob)) / LAYERS)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = bias.to(torch.bfloat16)[:, None, None, :]
    lib_in = [tuple(t.transpose(1, 2).detach().requires_grad_()
                    for t in (q, k, v)) + (do.transpose(1, 2),)
              for q, k, v, do in layers]

    def lib_fwd():
        for q, k, v, _ in lib_in:
            sdpa(q, k, v, attn_mask=mask, dropout_p=p)

    def lib_fwd_bwd():
        for q, k, v, do in lib_in:
            out = sdpa(q, k, v, attn_mask=mask, dropout_p=p)
            torch.autograd.grad(out, (q, k, v), do)
    lib_f = graph_ms(torch, lib_fwd) / LAYERS
    lib_fb = graph_ms(torch, lib_fwd_bwd) / LAYERS
    # bound per layer: inputs read once, outputs written once; the
    # tensor-core products over the pairs this data needs (each query
    # against its row's real keys), 2 * D per pair and product
    elem = b * s * h * d * 2
    rows = b * h * s * 4
    pairs = int(h * s * lens.sum())
    bound = {"fwd": bound_ms(4 * elem + rows + b * s * 4 + 4,
                             2 * 2 * d * pairs, BF16_OPS_PER_S),
             "bwd": bound_ms(5 * elem + rows + b * s * 4 + 4 + 3 * elem
                             + b * s * 4, 5 * 2 * d * pairs, BF16_OPS_PER_S)}
    for key, lib in (("fwd", lib_f), ("bwd", lib_fb - lib_f)):
        k_ms, eager, plain = ms[key]
        bms, by = bound[key]
        print(f"time bert flash_attention_{key} [{card}] (bf16, B={b} S={s} "
              f"H={h} D={d}, padding bias, p={p}, per layer): {k_ms:.4f} ms "
              f"(call {eager:.4f}), plain {plain:.4f}, SDPA with the "
              f"(B, 1, 1, S) mask {lib:.4f}, bound {bms:.4f} ({by})")
    print(f"time bert flash_attention [{card}]: without the bias K1 "
          f"{nobias[0]:.4f} ms per layer against {ms['fwd'][0]:.4f} with "
          f"it, K2 {nobias[1]:.4f} against {ms['bwd'][0]:.4f} (dbias "
          f"computed and dropped: {ms['bwd'][0] - nobias[1]:+.4f} ms); "
          f"SDPA fwd+bwd {lib_fb:.4f}")
    del layers, saved, nob, lib_in
    torch.cuda.empty_cache()


def bert_check_phase(torch, args, dev, card):
    """(e) One f32 step of a 4-layer full-width BERT (vocab 30528, dropout
    0, B 2 x S 512 with the padding mask and two segments) on the kernel
    path against the same step by the plain versions on the CPU: the loss
    within 1e-4 relative, every gradient within GRAD_TOL of its tensor's
    largest |value|."""
    from paddle_tpu_torch.jit import forward_loss
    from paddle_tpu_torch.models import (BertForPretraining,
                                         BertPretrainingCriterion)
    from paddle_tpu_torch.ops import flash_attention as fa
    cfg = _bert_large(num_hidden_layers=4, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)
    crit = BertPretrainingCriterion()
    batch = [a[:2].cpu() for a in _bert_batch(torch, dev, cfg.vocab_size,
                                              args.seed + 5, padded=True)]
    gpu = BertForPretraining(cfg, device=dev, seed=args.seed + 5)
    cpu = copy.deepcopy(gpu).cpu()
    out = []
    for model, d in ((gpu, dev), (cpu, torch.device("cpu"))):
        n0 = fa.flash_fwd.launches
        loss = forward_loss(model, lambda lg, nsp, y: crit(lg, nsp, y),
                            tuple(a.to(d) for a in batch))
        names = [n for n, _ in model.named_parameters()]
        # no NSP labels, as bench.py: the NSP head gets no gradient
        grads = torch.autograd.grad(loss, [p for _, p in
                                           model.named_parameters()],
                                    allow_unused=True)
        out.append((float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)
                     if g is not None},
                    fa.flash_fwd.launches - n0))
    (lg, gg, ng), (lc, gc, _) = out
    if ng != cfg.num_hidden_layers:
        fail(f"bert check: the kernel path launched K1 {ng} times, not once "
             "per layer")
    worst = max(((gg[n] - gc[n]).abs().max() / gc[n].abs().max()
                 .clamp_min(1e-30)).item() for n in gc)
    print(f"bert check [{card}]: 4-layer f32 step (padding mask), kernel "
          f"path vs CPU plain path: loss {lg:.6f} vs {lc:.6f}; largest "
          f"gradient "
          f"difference {worst:.2e} of its tensor's max (tolerance "
          f"{GRAD_TOL}) over {len(gc)} parameters")
    if not abs(lg - lc) <= 1e-4 * abs(lc) or not worst <= GRAD_TOL:
        fail("the BERT kernel-path training step disagrees with the plain "
             "path")
    del gpu, cpu
    torch.cuda.empty_cache()


def bert_resume_leg(torch, args, dev, card):
    """(d) BERT-large, dropout 0, AdamW under LinearWarmup(PolynomialDecay)
    stepped once per step: 8 captured steps with a checkpoint after step 4,
    then a fresh captured step (warmed up) restores it and runs steps 5-8.
    Its losses must equal the uninterrupted run's bit for bit, the lr of
    every step the scheduler's, and the restore must capture nothing."""
    import gc
    import os
    import shutil
    from paddle_tpu_torch.optimizer import lr as sched_lr

    def schedule():
        return sched_lr.LinearWarmup(
            sched_lr.PolynomialDecay(1e-4, decay_steps=BERT_STEPS,
                                     end_lr=1e-5),
            warmup_steps=3, start_lr=1e-5, end_lr=1e-4)
    make = _bert_maker(torch, args, dev, schedule=schedule,
                       hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    batch = _bert_batch(torch, dev, BERT_VOCAB, args.seed + 6, padded=True)
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "bert_resume")
    shutil.rmtree(ckpt, ignore_errors=True)
    save_at = BERT_STEPS // 2

    def run(step, first, restore=False):
        sched = step.optimizer._lr_scheduler
        step.warmup(*batch)
        made = step.compile_counts()["total"]
        times = {}
        if restore:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            meta = step.restore_checkpoint(ckpt)
            torch.cuda.synchronize()
            times["restore_s"] = time.perf_counter() - t0
            if meta["step"] != save_at or sched.last_epoch != save_at:
                fail(f"bert resume: restored step {meta['step']}, schedule "
                     f"at {sched.last_epoch}, expected {save_at}")
        losses, lrs = [], []
        for i in range(first, BERT_STEPS):
            want_lr = float(np.float32(sched()))
            losses.append(float(step(*batch)))
            got_lr = float(step._lr)
            if got_lr != want_lr:
                fail(f"bert resume: step {i + 1} ran at lr {got_lr}, the "
                     f"schedule says {want_lr}")
            lrs.append(got_lr)
            sched.step()
            if not restore and i + 1 == save_at:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step.save_checkpoint(ckpt)
                times["save_s"] = time.perf_counter() - t0
        if step.compile_counts()["total"] != made:
            fail(f"bert resume: {step.compile_counts()['total'] - made} "
                 "captures after warmup")
        return losses, lrs, times
    model, step = make()
    full, lrs, t_save = run(step, 0)
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(ckpt) for f in fs)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    model, step = make()
    got, glrs, t_rest = run(step, save_at, restore=True)
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    print(f"bert resume [{card}]: lrs {', '.join(f'{x:.3e}' for x in lrs)}; "
          f"losses {', '.join(repr(x) for x in full)}; resumed steps "
          f"{save_at + 1}-{BERT_STEPS}: {', '.join(repr(x) for x in got)}; "
          f"checkpoint {size / 2 ** 30:.2f} GiB, save "
          f"{t_save['save_s']:.2f} s, restore {t_rest['restore_s']:.2f} s")
    if got != full[save_at:] or glrs != lrs[save_at:]:
        fail(f"bert resume: losses {got} / lrs {glrs} differ from the "
             f"uninterrupted run's {full[save_at:]} / {lrs[save_at:]}")


def bert_phase(torch, args, dev, card):
    """BERT-large and ERNIE-large pretraining on K1 / K2 with the padding
    bias, legs (a)-(f).  The JSON line's K1 / K2 launches stay the train
    phase's; each leg here asserts its own."""
    from paddle_tpu_torch.models import ernie_large_config
    rng = np.random.RandomState(args.seed + 7)
    bert_flash_time(torch, rng, dev, card)                            # (f)
    layers = _bert_large().num_hidden_layers
    make = _bert_maker(torch, args, dev)
    plain = _bert_batch(torch, dev, BERT_VOCAB, args.seed, padded=False)
    cap = _bert_leg(torch, "bert", card, make, plain, layers)         # (a)
    unc = _bert_leg(torch, "bert", card, make, plain, layers, uncaptured=True)
    if unc["losses"] != cap["losses"]:
        fail(f"bert: captured losses {cap['losses']} differ from the "
             f"uncaptured step's {unc['losses']}")
    if not cap["losses"][-1] < cap["losses"][0]:
        fail(f"bert: training loss did not fall: {cap['losses']}")
    print(f"bert: captured and uncaptured losses bit-equal over "
          f"{BERT_STEPS} steps")
    padded = _bert_batch(torch, dev, BERT_VOCAB, args.seed + 1, padded=True)
    real = int(padded[3].sum())
    print(f"bert padded: {real} real tokens of {BERT_B * BERT_S}, "
          f"{int((padded[4] >= 0).sum())} MLM labels")
    _bert_leg(torch, "bert padded", card, make, padded, layers)       # (b)
    ecfg = ernie_large_config(max_position_embeddings=BERT_S)
    _bert_leg(torch, "ernie", card, _bert_maker(torch, args, dev, True),
              _bert_batch(torch, dev, ecfg.vocab_size, args.seed + 2,
                          padded=False), ecfg.num_hidden_layers)      # (c)
    bert_resume_leg(torch, args, dev, card)                           # (d)
    bert_check_phase(torch, args, dev, card)                          # (e)


def bn_err(torch, got, want):
    """(max abs err, ok) of a fused-BN kernel against its plain version:
    f32 within 1e-5 of the tensor's largest |value| (the column sums add
    in another order; the elementwise kernels round like the plain
    version); bf16 within one bf16 unit, 1e-2 + 1e-2 * |plain|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == torch.bfloat16:
        ok = bool((err <= 1e-2 + 1e-2 * w.abs()).all())
    else:
        ok = float(err.max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)
    return float(err.max()), ok


def _bn_rows(torch, gen, dev, m, c, dtype, shift=0.5):
    return (torch.randn(m, c, generator=gen, device=dev) * 1.5
            + shift).to(dtype)


def _bn_coef(torch, gen, dev, c):
    """An (8, C) coef: a, b, mean, invstd and the dx rows A, B, Cc."""
    rows = [torch.rand(c, generator=gen, device=dev) + 0.5,
            torch.randn(c, generator=gen, device=dev),
            0.3 * torch.randn(c, generator=gen, device=dev),
            torch.rand(c, generator=gen, device=dev) + 0.5]
    rows += [torch.randn(c, generator=gen, device=dev) for _ in range(3)]
    rows.append(torch.zeros(c, device=dev))
    return torch.stack(rows).contiguous()


def bn_kernel_check(torch, fbn, gen, dev, m, c, dtype, act, res, errs):
    """K5-K8 at one (M, C, dtype, act, residual form) against their plain
    versions; the largest error per kernel goes into errs."""
    x = _bn_rows(torch, gen, dev, m, c, dtype)
    g = _bn_rows(torch, gen, dev, m, c, dtype, shift=0.0)
    r = None if res == "none" else _bn_rows(torch, gen, dev, m, c, dtype)
    coef = _bn_coef(torch, gen, dev, c)
    coefr = _bn_coef(torch, gen, dev, c) if res == "dual" else None
    pairs = {"bn_stats": (fbn.bn_stats(x), fbn._plain_stats(x)),
             "bn_apply": ((fbn.bn_apply(x, coef, r, act, coefr),),
                          (fbn._plain_apply(x, coef, r, act, coefr),)),
             "bn_bwd_reduce": (fbn.bn_bwd_reduce(g, x, coef, r, act, coefr),
                               fbn._plain_bwd_reduce(g, x, coef, r, act,
                                                     coefr)),
             "bn_bwd_dx": (fbn.bn_bwd_dx(g, x, coef, r, act, coefr),
                           fbn._plain_bwd_dx(g, x, coef, r, act, coefr))}
    torch.cuda.synchronize()
    bad = []
    for name, (got, want) in pairs.items():
        for a, b in zip(got, want):
            if b is None:
                continue
            e, ok = bn_err(torch, a, b)
            errs[name] = max(errs.get(name, 0.0), e)
            if not ok:
                bad.append(f"{name} {e:.3e}")
    if bad:
        fail(f"fused-BN kernels disagree with their plain versions at M={m} "
             f"C={c} {dtype} act={act} residual={res}: {bad}")


def bn_pool_check(torch, fbn, gen, dev, shape, dtype, act, pool, errs,
                  route=None):
    """K9 against its plain version: max bit-equal, avg within bn_err's
    bound and, in bf16, within one bf16 unit of the larger value (2**-7
    of it) plus 1e-5 of the largest |value| (both sum in f32 and round
    once); two calls bit-equal.  By the wrapper's own route choice, or
    ``route`` "window" to hold the window route at a shape the ring takes,
    or a hand-made ``PoolPlan`` to hold the ring where the wrapper takes
    the window route.  Returns the route taken."""
    n, h, w, c = shape
    x = _bn_rows(torch, gen, dev, n * h * w, c, dtype).view(n, h, w, c)
    coef = _bn_coef(torch, gen, dev, c)
    before = dict(fbn.bn_pool_apply.routes)
    call = fbn._pool_window if route == "window" else fbn.bn_pool_apply
    if isinstance(route, fbn.PoolPlan):
        call = lambda *a: fbn._pool_ring(*a, route)
    got = call(x, coef, act, *pool)
    again = call(x, coef, act, *pool)
    want = fbn._plain_pool_apply(x, coef, act, *pool)
    torch.cuda.synchronize()
    taken = next(r for r, v in fbn.bn_pool_apply.routes.items()
                 if v != before[r])
    e, ok = bn_err(torch, got, want)
    if pool[0] == "avg" and dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        ok = ok and bool(((g - w).abs() <= 2.0 ** -7 * torch.maximum(
            g.abs(), w.abs()) + 1e-5 * float(w.abs().max())).all())
    exact = pool[0] != "max" or torch.equal(got, want)
    rep = torch.equal(got, again)
    key = "bn_pool_apply" if taken == "ring" else "bn_pool_apply (window)"
    errs[key] = max(errs.get(key, 0.0), e)
    if not (ok and exact and rep) or got.shape != want.shape:
        fail(f"bn_pool_apply ({taken} route) disagrees with its plain "
             f"version at {shape} {dtype} act={act} pool={pool}: {e:.3e}"
             f"{'' if exact else ', max not bit-equal'}"
             f"{'' if rep else ', not bit-repeatable'}")
    return taken


def bn_function_check(torch, fbn, gen, dev, form, shape, dtype):
    """One autograd Function (both directions on the kernels) against
    autograd of its plain reference: outputs, f32 statistics and the
    gradients of x, gamma, beta (and the residual's), for a logical NCHW
    input in channels-last memory.  Returns the largest error."""
    n, h, w, c = shape

    def act_t():
        return (torch.randn(n, c, h, w, generator=gen, device=dev) + 0.3).to(
            dtype).contiguous(memory_format=torch.channels_last)

    def scale():
        return torch.rand(c, generator=gen, device=dev) + 0.5

    def shift():
        return torch.randn(c, generator=gen, device=dev)
    x, r = act_t(), act_t()
    gamma, beta, gr, br = scale(), shift(), scale(), shift()
    pool = ("max", 3, 2, 1)
    eps = 1e-5
    if form == "single":
        ins = [x, gamma, beta, r]
        kern = lambda x, g, b, r: fbn.bn_act_train(x, g, b, eps, "relu", r,
                                                   False)
        plain = lambda x, g, b, r: fbn.bn_act_reference(x, g, b, eps, "relu",
                                                        r, 1)
    elif form == "dual":
        ins = [x, gamma, beta, r, gr, br]
        kern = lambda *a: fbn.bn2_act_train(*a, eps, "relu", False)
        plain = lambda *a: fbn.bn2_act_reference(*a, eps, "relu", 1)
    else:
        ins = [x, gamma, beta]
        kern = lambda x, g, b: fbn.bn_act_pool_train(x, g, b, eps, "relu",
                                                     pool, False)
        plain = lambda x, g, b: fbn.bn_act_pool_reference(x, g, b, eps,
                                                          "relu", pool, 1)
    with torch.no_grad():
        shapes = [t.shape for t in plain(*ins)]
    cts = [(torch.randn(shapes[0], generator=gen, device=dev)).to(
        dtype).contiguous(memory_format=torch.channels_last)]
    cts += [0.1 * torch.randn(s, generator=gen, device=dev)
            for s in shapes[1:]]

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in ins]
        outs = fn(*leaves)
        grads = torch.autograd.grad(outs, leaves, cts)
        return [o.detach() for o in outs] + list(grads)
    got, want = run(kern), run(plain)
    torch.cuda.synchronize()
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        scale = float(b.abs().max())
        bad = (err > 2e-2 * scale + 2e-2 * b.abs()) if dtype == \
            torch.bfloat16 else (err > 1e-4 * scale)
        worst = max(worst, float(err.max()))
        if int(bad.sum()) > a.numel() // 1_000_000:
            fail(f"{form} fused-BN Function disagrees with autograd of its "
                 f"plain reference at {shape} {dtype}: {int(bad.sum())} "
                 f"elements off, max err {float(err.max()):.3e} of "
                 f"{scale:.3e}")
    print(f"check bn Function {form} {str(dtype)[6:]} NHWC={shape}: max "
          f"abs err {worst:.3e} over outputs and gradients")
    return worst


def bn_bytes_ops(name, m, c, elem, res, mo=None, window=9):
    """(bytes, f32 operations) of one kernel call: each input read once,
    each output written once; the operations this call's arithmetic
    does per element."""
    n = m * c
    coef = 8 * c * 4
    rows = 1 if res == "none" else 2
    if name == "bn_stats":
        return n * elem + 2 * c * 4, 3 * n
    if name == "bn_apply":
        return (rows + 1) * n * elem + coef * (2 if res == "dual" else 1), \
            (4 + 2 * (rows - 1)) * n
    if name == "bn_bwd_reduce":
        return (rows + 1) * n * elem + coef + 3 * c * 4, 10 * n
    if name == "bn_bwd_dx":   # g, x (, r) in; dx (, dres) out
        return (rows + 2 + (res != "none")) * n * elem + coef, 10 * n
    # bn_pool_apply: x in, the pooled output out
    return n * elem + mo * c * elem + coef, 4 * window * mo * c


def library_ms(torch, fn, what):
    """graph_ms of a PyTorch yardstick call, or None (printed) where this
    build of PyTorch refuses the call: a yardstick is measured, never
    relied on."""
    try:
        return graph_ms(torch, fn)
    except RuntimeError as e:
        print(f"time: yardstick {what} not measured: {str(e)[:160]}")
        torch.cuda.synchronize()
        return None


def bn_time(torch, fbn, gen, dev, shape, res):
    """Per kernel at one main-path site (bf16, relu): graph ms, eager call
    ms, plain ms, PyTorch's own BatchNorm kernel for the same function
    (the SyncBatchNorm building blocks; None where there is none), bound
    ms and what bounds it.  Also prints the pair yardsticks
    (batch_norm + relu_, native_batch_norm_backward) and var_mean."""
    n, h, w, c = shape
    m = n * h * w
    dt = torch.bfloat16
    x = _bn_rows(torch, gen, dev, m, c, dt)
    g = _bn_rows(torch, gen, dev, m, c, dt, shift=0.0)
    r = _bn_rows(torch, gen, dev, m, c, dt) if res != "none" else None
    coef = _bn_coef(torch, gen, dev, c)
    x4, g4 = (t.view(n, h, w, c).permute(0, 3, 1, 2) for t in (x, g))
    r4 = r.view(n, h, w, c).permute(0, 3, 1, 2) if r is not None else None
    wgt, bia = coef[0].to(dt), coef[1].to(dt)
    eps = 1e-5
    # inputs of PyTorch's own BatchNorm kernels (the SyncBatchNorm
    # building blocks), each the same function as one of K5-K8 without
    # the activation and the residual
    mean, invstd = torch.batch_norm_stats(x4, eps)
    sums = torch.batch_norm_backward_reduce(g4, x4, mean, invstd, wgt,
                                            True, False, False)
    count = torch.full((1,), m, dtype=torch.int32, device=dev)
    calls = {
        "bn_stats": (lambda: fbn.bn_stats(x), lambda: fbn._plain_stats(x),
                     lambda: torch.batch_norm_stats(x4, eps)),
        "bn_apply": (lambda: fbn.bn_apply(x, coef, r, "relu"),
                     lambda: fbn._plain_apply(x, coef, r, "relu"),
                     lambda: torch.batch_norm_elemt(x4, wgt, bia, mean,
                                                    invstd, eps)),
        "bn_bwd_reduce": (
            lambda: fbn.bn_bwd_reduce(g, x, coef, r, "relu"),
            lambda: fbn._plain_bwd_reduce(g, x, coef, r, "relu"),
            lambda: torch.batch_norm_backward_reduce(
                g4, x4, mean, invstd, wgt, True, True, True)),
        "bn_bwd_dx": (
            lambda: fbn.bn_bwd_dx(g, x, coef, r, "relu"),
            lambda: fbn._plain_bwd_dx(g, x, coef, r, "relu"),
            lambda: torch.batch_norm_backward_elemt(
                g4, x4, mean, invstd, wgt, sums[0], sums[1], count))}
    out = {}
    for name, (kern, plain, lib) in calls.items():
        b, by = bound_ms(*bn_bytes_ops(name, m, c, 2, res))
        out[name] = dict(ms=graph_ms(torch, kern),
                         call_ms=call_ms(torch, kern, 10),
                         plain_ms=graph_ms(torch, plain, 5),
                         library_ms=library_ms(torch, lib, name), bound_ms=b,
                         bound_by=by)
    if res == "none":    # the stem: the pooled epilogue
        from paddle_tpu_torch.ops import _build
        sms = _build.sm_count(dev.index), _build.smem_limits(dev.index)
        x4n = x.view(n, h, w, c)
        pool = ("max", (3, 3), (2, 2), (1, 1))
        ho, wo = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
        b, by = bound_ms(*bn_bytes_ops("bn_pool_apply", m, c, 2, res,
                                       mo=n * ho * wo))
        kern = lambda: fbn.bn_pool_apply(x4n, coef, "relu", *pool)
        old = lambda: fbn._pool_window(x4n, coef, "relu", *pool)
        # the ring route (kern) and the window route it replaced (old),
        # in turns
        times = [graph_ms(torch, f) for f in (kern, old, old, kern)]
        out["bn_pool_apply"] = dict(
            ms=times[0], call_ms=call_ms(torch, kern, 10),
            plain_ms=graph_ms(torch, lambda: fbn._plain_pool_apply(
                x4n, coef, "relu", *pool), 5),
            library_ms=None, bound_ms=b, bound_by=by)
        print(f"time bn_pool_apply at the stem {shape} bf16 relu max 3x3/2: "
              f"ring route {times[0]:.4f} / {times[3]:.4f} ms, window route "
              f"(the kernel it replaced) {times[1]:.4f} / {times[2]:.4f} ms, "
              f"bound {b:.4f} ms ({by}); plan " + str(fbn._pool_plan(
                  n, h, w, c, 2, "max", (3, 3), (2, 2), (1, 1), *sms)))

    def fwd_pair():
        y = torch.nn.functional.batch_norm(x4, None, None, wgt, bia, True,
                                           0.1, eps)
        if r4 is not None:
            y.add_(r4)
        return y.relu_()
    save = torch.native_batch_norm(x4, wgt, bia, None, None, True, 0.1, eps)
    bwd_pair = lambda: torch.ops.aten.native_batch_norm_backward(
        g4, x4, wgt, None, None, save[1], save[2], True, eps,
        [True, True, True])
    pair = [library_ms(torch, f, w) for f, w in (
        (fwd_pair, "batch_norm"), (bwd_pair, "native_batch_norm_backward"),
        (lambda: torch.var_mean(x, 0, correction=0), "var_mean"))]
    pair = [float("nan") if p is None else p for p in pair]
    print(f"time bn at NHWC={shape} bf16 relu residual={res}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (call {v['call_ms']:.4f}, plain "
        f"{v['plain_ms']:.4f}, torch "
        + (f"{v['library_ms']:.4f}" if v['library_ms'] is not None else "-")
        + f", bound {v['bound_ms']:.4f} {v['bound_by']})"
        for k, v in out.items()))
    print(f"time bn pair yardsticks at NHWC={shape}: batch_norm(training)"
          f"{' + add_' if r4 is not None else ''} + relu_ {pair[0]:.4f} ms "
          f"(K5+K6 {out['bn_stats']['ms'] + out['bn_apply']['ms']:.4f}); "
          f"native_batch_norm_backward {pair[1]:.4f} ms (K7+K8 "
          f"{out['bn_bwd_reduce']['ms'] + out['bn_bwd_dx']['ms']:.4f}); "
          f"var_mean {pair[2]:.4f} ms (K5 {out['bn_stats']['ms']:.4f})")
    del x, g, r, x4, g4, r4, save
    torch.cuda.empty_cache()
    return out


def bn_phase(torch, args, dev):
    """K5-K9 checked at the main path's shapes and at small odd ones, the
    Functions against autograd of the plain references, then timed."""
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    errs = {}
    f32, bf16 = torch.float32, torch.bfloat16
    acts = (None, "relu", "relu6")
    forms = ("none", "plain", "dual")
    main_cases = [
        (BN_STEM, "relu", "none"), (BN_LAYER1, "relu", "plain"),
        (BN_LAYER4, "relu", "dual"), (BN_LAYER4, "relu", "none")]
    for (n, h, w, c), act, res in main_cases:
        for dtype in (bf16, f32):
            bn_kernel_check(torch, fbn, gen, dev, n * h * w, c, dtype, act,
                            res, errs)
            torch.cuda.empty_cache()
    small = [(1037, 24), (515, 40), (333, 7)]
    for m, c in small:
        for dtype in (bf16, f32):
            for act in acts:
                for res in forms:
                    bn_kernel_check(torch, fbn, gen, dev, m, c, dtype, act,
                                    res, errs)
    pools = [("max", (3, 3), (2, 2), (1, 1)), ("avg", (3, 3), (2, 2), (1, 1)),
             ("max", (2, 3), (2, 1), (0, 1))]
    routes = {}
    for dtype in (bf16, f32):
        for route in (None, "window"):   # the stem: the ring, and the old
            routes[("stem", str(dtype), route)] = bn_pool_check(
                torch, fbn, gen, dev, BN_STEM, dtype, "relu", pools[0], errs,
                route)
            torch.cuda.empty_cache()
        for shape in ((3, 9, 11, 24), (2, 12, 12, 40), (1, 7, 5, 3),
                      (2, 6, 480 // dtype.itemsize * 2, 64)):
            for act in acts:
                for pool in pools:
                    routes[(shape, str(dtype), act, pool)] = bn_pool_check(
                        torch, fbn, gen, dev, shape, dtype, act, pool, errs)
        # rings of 18 and 28 slots: a barrier per slot past the first 16
        for shape, pool in (
                ((2, 10, 10, 32), ("max", (9, 9), (1, 1), (0, 0))),
                ((2, 14, 14, 64), ("avg", (14, 14), (1, 1), (0, 0)))):
            routes[(shape, str(dtype), "relu", pool)] = bn_pool_check(
                torch, fbn, gen, dev, shape, dtype, "relu", pool, errs)
    taken = {r: sum(v == r for v in routes.values()) for r in
             ("ring", "window")}
    print(f"check bn_pool_apply routes: {taken} of {len(routes)} checks; "
          "the stem by the wrapper's choice: "
          + ", ".join(f"{k[1][6:]} {v}" for k, v in routes.items()
                      if k[0] == "stem" and k[2] is None))
    if routes[("stem", str(bf16), None)] != "ring":
        fail("the bf16 stem did not take K9's ring route")
    vgg_pool_sites(torch, fbn, gen, dev, errs)
    conv_net_sites(torch, fbn, gen, dev, errs)
    print("check bn kernels vs plain (main-path shapes and small odd ones, "
          "f32 and bf16, every activation and residual form): max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    fn_err = 0.0
    for form, shape in (("single", BN_LAYER1), ("dual", BN_LAYER4),
                        ("pool", BN_STEM)):
        fn_err = max(fn_err, bn_function_check(torch, fbn, gen, dev, form,
                                               shape, bf16))
        torch.cuda.empty_cache()
        fn_err = max(fn_err, bn_function_check(
            torch, fbn, gen, dev, form, (3, 7, 9, 24), f32))
    times = {"layer1": bn_time(torch, fbn, gen, dev, BN_LAYER1, "plain"),
             "stem": bn_time(torch, fbn, gen, dev, BN_STEM, "none")}
    rows = []
    for name in BN_KERNELS:
        t = times["stem" if name == "bn_pool_apply" else "layer1"][name]
        rows.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/csrc/fused_bn_act.cu",
                     "replaces": f"paddle_tpu/ops/fused_bn_act.py:"
                                 f"{BN_LINES[name]}",
                     "max_abs_err": errs[name], **t})
    return rows


def bn_sites(model):
    """(single, dual, pooled) fused-BN call sites of one ResNet forward,
    read from the model's blocks the way ``vision.models.resnet`` routes
    them: bn1 (and bn2 of a bottleneck) are single sites; the last BN of a
    block is dual when its downsample splits into (conv, BatchNorm), else
    single; the stem is pooled when its max pool is fusable."""
    from paddle_tpu_torch.ops.fused_bn_act import fusable_pool_spec
    from paddle_tpu_torch.vision.models.resnet import (BottleneckBlock,
                                                       _split_downsample)
    pooled = int(fusable_pool_spec(model.maxpool, model.data_format)
                 is not None)
    single, dual = 1 - pooled, 0
    for layer in (model.layer1, model.layer2, model.layer3, model.layer4):
        for blk in layer:
            single += 2 if isinstance(blk, BottleneckBlock) else 1
            if _split_downsample(blk.downsample) is not None:
                dual += 1
            else:
                single += 1
    return single, dual, pooled


def bn_launches_per_step(model, recompute: bool = False):
    """Expected K5-K9 launches of one training step (forward + backward):
    K5 once per single site, twice per dual and once at the pooled stem;
    K6, K7 and K8 once per single or dual site; K9 once per pooled site
    (its backward is plain tensor code).  With ``recompute`` (every block a
    region), each block's forward runs again in the backward: K5 and K6
    once more at every block site (the stem is in no block)."""
    single, dual, pooled = bn_sites(model)
    out = {"bn_stats": single + 2 * dual + pooled,
           "bn_apply": single + dual, "bn_bwd_reduce": single + dual,
           "bn_bwd_dx": single + dual, "bn_pool_apply": pooled}
    if recompute:
        blocks = single - (1 - pooled)
        out["bn_stats"] += blocks + 2 * dual
        out["bn_apply"] += blocks + dual
    return out


def bn_site_list(model, batch: int, hw: int):
    """Every fused-BN site of one ResNet step as (label, M, C, form):
    the pooled stem ("pool"), then each block's BatchNorms in order, the
    last one "plain" (a residual) or "dual" (a BatchNorm on the
    downsample too), the others "none".  Shapes from the blocks'
    convolution strides and BatchNorm widths."""
    from paddle_tpu_torch.ops.fused_bn_act import _pool_out
    from paddle_tpu_torch.vision.models.resnet import (BottleneckBlock,
                                                       _split_downsample)

    def stride(conv):
        st = conv.stride
        return st[0] if isinstance(st, (tuple, list)) else int(st)
    h = hw // stride(model.conv1)
    sites = [("stem", batch * h * h, model.bn1.num_features, "pool")]
    h, _ = _pool_out(h, h, (3, 3), (2, 2), (1, 1))
    for li, layer in enumerate((model.layer1, model.layer2, model.layer3,
                                model.layer4)):
        for bi, blk in enumerate(layer):
            tag = f"layer{li + 1}.{bi}"
            last = blk.bn3 if isinstance(blk, BottleneckBlock) else blk.bn2
            res = ("dual" if _split_downsample(blk.downsample) is not None
                   else "plain")
            if isinstance(blk, BottleneckBlock):
                sites.append((f"{tag}.bn1", batch * h * h,
                              blk.bn1.num_features, "none"))
                h //= stride(blk.conv2)
                sites.append((f"{tag}.bn2", batch * h * h,
                              blk.bn2.num_features, "none"))
            else:
                h //= stride(blk.conv1)
                sites.append((f"{tag}.bn1", batch * h * h,
                              blk.bn1.num_features, "none"))
            sites.append((f"{tag}.{'bn3' if isinstance(blk, BottleneckBlock) else 'bn2'}",
                          batch * h * h, last.num_features, res))
    return sites


def bn_step_bounds(model, batch: int, hw: int):
    """Per-step bound (ms, bytes at 3.35 TB/s) of each of K5-K9 over this
    ResNet's BatchNorm sites for a batch of batch x hw x hw: each input
    read once, each output written once (bf16)."""
    from paddle_tpu_torch.ops.fused_bn_act import _pool_out
    total = dict.fromkeys(BN_KERNELS, 0.0)
    for _, m, c, form in bn_site_list(model, batch, hw):
        if form == "pool":
            h = int(round((m // batch) ** 0.5))
            ho, _ = _pool_out(h, h, (3, 3), (2, 2), (1, 1))
            total["bn_stats"] += bn_bytes_ops("bn_stats", m, c, 2, "none")[0]
            total["bn_pool_apply"] += bn_bytes_ops(
                "bn_pool_apply", m, c, 2, "none", mo=batch * ho * ho)[0]
            continue
        for name in ("bn_stats",) * (2 if form == "dual" else 1) + (
                "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
            total[name] += bn_bytes_ops(name, m, c, 2, form)[0]
    return {k: v / HBM_BYTES_PER_S * 1e3 for k, v in total.items()}


def bn_backward_sites(torch, fbn, dev, model, card):
    """K7 and K8 timed (CUDA graph replay, bf16, relu) at each of the
    step's BN backward sites' shapes, beside each one's bound: where
    their per-step time over bound comes from.  Sites of one shape are
    timed once.  Prints a table; returns the per-step sums."""
    gen = torch.Generator(device=dev).manual_seed(7)
    sites = [t for t in bn_site_list(model, RESNET_B, RESNET_HW)
             if t[3] != "pool"]
    timed = {}
    for _, m, c, form in sites:
        if (m, c, form) in timed:
            continue
        x = _bn_rows(torch, gen, dev, m, c, torch.bfloat16)
        g = _bn_rows(torch, gen, dev, m, c, torch.bfloat16, shift=0.0)
        r = None if form == "none" else _bn_rows(torch, gen, dev, m, c,
                                                 torch.bfloat16)
        coef = _bn_coef(torch, gen, dev, c)
        coefr = _bn_coef(torch, gen, dev, c) if form == "dual" else None
        timed[(m, c, form)] = {
            "bn_bwd_reduce": graph_ms(torch, lambda: fbn.bn_bwd_reduce(
                g, x, coef, r, "relu", coefr)),
            "bn_bwd_dx": graph_ms(torch, lambda: fbn.bn_bwd_dx(
                g, x, coef, r, "relu", coefr))}
        del x, g, r
    torch.cuda.empty_cache()
    print(f"bn backward sites [{card}]: site, M, C, residual; K7 ms "
          "(bound), K8 ms (bound), share of bound")
    sums = {"bn_bwd_reduce": [0.0, 0.0], "bn_bwd_dx": [0.0, 0.0]}
    for label, m, c, form in sites:
        cells = []
        for name in ("bn_bwd_reduce", "bn_bwd_dx"):
            t = timed[(m, c, form)][name]
            b, _ = bound_ms(*bn_bytes_ops(name, m, c, 2, form))
            sums[name][0] += t
            sums[name][1] += b
            cells.append(f"{t:.4f} ({b:.4f}) {b / t:.0%}")
        print(f"bn site {label:<14} M={m:>9} C={c:>4} {form:<5}  "
              + "  ".join(cells))
    print("bn backward sites: per step K7 {:.3f} ms (bound {:.3f}, {:.0%}), "
          "K8 {:.3f} ms (bound {:.3f}, {:.0%}) over {} sites".format(
              *sums["bn_bwd_reduce"],
              sums["bn_bwd_reduce"][1] / sums["bn_bwd_reduce"][0],
              *sums["bn_bwd_dx"], sums["bn_bwd_dx"][1] / sums["bn_bwd_dx"][0],
              len(sites)))
    return sums


def resnet_phase(torch, args, dev, card):
    """ResNet-50, BASELINE config #2: the conv-net leg of the main path,
    through the step's CUDA graph; then the same steps uncaptured (the A/B:
    losses bit-equal; the profile with the stem's plain backward recompute
    on a line of its own) and under recompute_policy("stages")
    (RECOMPUTE_STEPS steps: losses within 1e-5 relative, K5 / K6 again at
    every block site, peak memory below the plain run's)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50
    torch.cuda.empty_cache()

    def make(loss=lambda lg, y: F.cross_entropy(lg, y)):
        pt.seed(args.seed)
        model = resnet50(device=dev, seed=args.seed)
        opt = Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=model.parameters())
        return model, TrainStep(model, loss, opt, amp_level="O2",
                                amp_dtype="bfloat16")

    counters = bn_counters(fbn)
    groups = bn_groups()
    stem = "stem backward recompute (_BnPool.backward, plain)"
    what = (f"train step (ResNet-50, b{RESNET_B} x {RESNET_HW}^2, O2 bf16, "
            "NHWC")
    with layout_policy("NHWC"):
        model = resnet50(device=dev, seed=args.seed)   # sites and bounds
        per_step = bn_launches_per_step(model)
        want = {"bn_stats": 53, "bn_apply": 48, "bn_bwd_reduce": 48,
                "bn_bwd_dx": 48, "bn_pool_apply": 1}
        if per_step != want:
            fail(f"ResNet-50's fused-BN sites give {per_step} launches per "
                 f"step, not {want}")
        per_step_rc = bn_launches_per_step(model, recompute=True)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        x = torch.randn(RESNET_B, 3, RESNET_HW, RESNET_HW, generator=gen,
                        device=dev)
        y = torch.randint(0, 1000, (RESNET_B,), generator=gen, device=dev)
        cap = train_leg(torch, make, (x, y), RESNET_STEPS, counters, card,
                        what + ", captured)", groups=groups, top=14)
        vals = cap["losses"]
        launches = {n: cap["launches"][n] for n in BN_KERNELS}
        print("resnet: losses " + ", ".join(f"{v:.4f}" for v in vals))
        print("resnet: losses in full " + ", ".join(repr(v) for v in vals))
        if not all(np.isfinite(vals)):
            fail(f"non-finite ResNet-50 training loss: {vals}")
        expect = {k: v * RESNET_STEPS for k, v in per_step.items()}
        if launches != expect:
            fail(f"K5-K9 launches {launches}, expected {expect} "
                 f"({per_step} per step x {RESNET_STEPS} steps, through "
                 "replays)")
        if cap["launches"]["routes"] != {"ring": expect["bn_pool_apply"],
                                         "window": 0}:
            fail(f"K9 took routes {cap['launches']['routes']} on the main "
                 "path, not the ring")
        if not cap["warm"]["compiled"] or cap["recaptured"]:
            fail(f"resnet: warmup {cap['warm']}, {cap['recaptured']} "
                 "captures after it (expected one capture, by warmup)")
        print(f"resnet [{card}]: ResNet-50 b{RESNET_B} {RESNET_HW}x"
              f"{RESNET_HW} O2 bf16 NHWC, Momentum(0.1, 0.9), captured: "
              f"K5-K9 launches per step {per_step}; layout copies per step "
              f"{cap['launches']['relayouts'] / RESNET_STEPS:g}")
        print(_leg_line("resnet captured", card, cap, RESNET_B, "images"))
        busy, sums = cap["profile"][1], cap["profile"][2]
        bounds = bn_step_bounds(model, RESNET_B, RESNET_HW)
        fused = sum(v for k, v in sums.items() if k.startswith("bn_"))
        print(f"resnet: K5-K9 per step {fused:.3f} ms of {busy or 0:.3f} ms "
              f"device time; per kernel, device ms vs bound ms over this "
              "step's sites: " + ", ".join(
                  f"{n} {sums.get(f'{n} (K{5 + i})', 0.0):.3f} vs "
                  f"{bounds[n]:.3f}" for i, n in enumerate(BN_KERNELS))
              + f" (K5-K8 bound {sum(bounds.values()) - bounds['bn_pool_apply']:.3f})")
        unc = train_leg(torch, make, (x, y), RESNET_STEPS, counters, card,
                        what + ", uncaptured)", uncaptured=True,
                        groups=groups, top=14,
                        ranges={stem: "bn_pool_backward"})
        print(_leg_line("resnet uncaptured", card, unc, RESNET_B, "images"))
        if unc["losses"] != vals:
            fail(f"resnet: captured losses {vals} differ from the "
                 f"uncaptured step's {unc['losses']}")
        print(f"resnet: captured and uncaptured losses bit-equal over "
              f"{RESNET_STEPS} steps; the stem's plain backward recompute "
              f"{unc['profile'][2].get(stem, 0.0):.3f} ms per step "
              "(uncaptured profile)")
        labels = resnet_labels_leg(torch, make, (x, y), vals[0], per_step,
                                   counters, card, what, groups)
        tag = "resnet stages/dots_saveable"
        leg = train_leg(torch, make, (x, y), RECOMPUTE_STEPS, counters, card,
                        what + ", captured, recompute stages)",
                        policy=("stages", "dots_saveable"), groups=groups,
                        top=14)
        print(_leg_line(tag, card, leg, RESNET_B, "images"))
        _check_recompute_losses(tag, leg["losses"], vals)
        stated = {k: v * RECOMPUTE_STEPS for k, v in per_step_rc.items()}
        got = {n: leg["launches"][n] for n in BN_KERNELS}
        if got != stated:
            fail(f"{tag}: K5-K9 launches {got}, stated {stated} "
                 f"({per_step_rc} per step: K5 / K6 again at every block "
                 "site)")
        if not leg["peak_gib"] < cap["peak_gib"]:
            fail(f"{tag}: peak memory {leg['peak_gib']:.2f} GiB is not "
                 f"below the plain step's {cap['peak_gib']:.2f} GiB")
        print(f"{tag} [{card}]: device time {leg['profile'][1] or 0:.3f} "
              f"ms vs {busy or 0:.3f} ms without recompute; peak memory "
              f"{leg['peak_gib']:.2f} vs {cap['peak_gib']:.2f} GiB "
              f"({leg['peak_gib'] / cap['peak_gib']:.1%})")
        bn_backward_sites(torch, fbn, dev, model, card)
    del model, x
    torch.cuda.empty_cache()
    return _add_launches(launches, labels)


def resnet_check_phase(torch, args, dev):
    """One f32 ResNet-18 step (10 classes, 4 x 3 x 64 x 64) on the kernel
    path (NHWC policy) against the plain path on the CPU, same weights and
    batch: loss, gradients and running statistics."""
    from paddle_tpu_torch.jit import forward_loss, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.vision.models import resnet18
    rng = np.random.RandomState(args.seed + 4)
    batch = (rng.randn(4, 3, 64, 64).astype(np.float32),
             rng.randint(0, 10, (4,)))
    gpu = resnet18(num_classes=10, device=dev, seed=args.seed + 4)
    cpu = copy.deepcopy(gpu).cpu()
    out = []
    for model, d, policy in ((gpu, dev, "NHWC"),
                             (cpu, torch.device("cpu"), None)):
        n0 = {k: getattr(fbn, k).launches for k in BN_KERNELS}
        x, y = (torch.from_numpy(a).to(d) for a in batch)
        with layout_policy(policy):
            loss = forward_loss(model, lambda lg, yy: F.cross_entropy(lg, yy),
                                (x, y))
            names = [n for n, _ in model.named_parameters()]
            grads = torch.autograd.grad(loss, [p for _, p in
                                               model.named_parameters()])
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("_mean", "_variance"))}
        out.append((float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)}, stats,
                    {k: getattr(fbn, k).launches - n0[k]
                     for k in BN_KERNELS}))
    (lg, gg, sg, ng), (lc, gc, sc, nc) = out
    if ng != bn_launches_per_step(gpu) or any(nc.values()):
        fail(f"ResNet-18 check: kernel launches {ng} on the card, {nc} on "
             f"the CPU; expected {bn_launches_per_step(gpu)} and none")

    def worst(a, b):
        return max(((a[k] - b[k]).abs().max() / b[k].abs().max()
                    .clamp_min(1e-30)).item() for k in b)
    wg, ws = worst(gg, gc), worst(sg, sc)
    print(f"resnetcheck: ResNet-18 f32 step, kernel path vs CPU plain path: "
          f"loss {lg:.6f} vs {lc:.6f}; largest gradient difference {wg:.2e} "
          f"and running-statistic difference {ws:.2e} of their tensor's "
          f"max (tolerance {GRAD_TOL}) over {len(gc)} parameters and "
          f"{len(sc)} statistics; launches {ng}")
    if not abs(lg - lc) <= GRAD_TOL * abs(lc) or not wg <= GRAD_TOL or \
            not ws <= GRAD_TOL:
        fail("the kernel-path ResNet step disagrees with the plain path")
    del gpu, cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the conv-net leftovers: the fused tail, MobileNetV1 / V2, VGG, LeNet, QAT
# ---------------------------------------------------------------------------

def bn_counters(fbn):
    """A ``counters`` callable for ``train_leg``: zeroes K5-K9's launch
    counters, K9's routes and the fused entries' layout copies and
    composite calls, and returns their reader."""
    entries = (fbn.bn_act_train, fbn.bn2_act_train, fbn.bn_act_pool_train)

    def counters():
        for name in BN_KERNELS:
            getattr(fbn, name).launches = 0
        fbn.bn_pool_apply.routes.update(ring=0, window=0)
        for e in entries:
            e.relayouts = 0
            e.composite_calls = 0
        return lambda: dict(
            {n: getattr(fbn, n).launches for n in BN_KERNELS},
            routes=dict(fbn.bn_pool_apply.routes),
            relayouts=sum(e.relayouts for e in entries),
            composite=sum(e.composite_calls for e in entries))
    return counters


def bn_groups():
    """Profile groups of a conv-net step: K5-K9, the partial sums, the
    PyTorch pools, depthwise and other convolutions (cuDNN)."""
    groups = {f"{n} (K{5 + i})": (f"{n}_kernel",)
              for i, n in enumerate(BN_KERNELS)}
    groups["bn_pool_apply (K9)"] += ("bn_pool_ring_kernel",)
    groups["bn_sum_partials (K5, K7)"] = ("bn_sum_partials",)
    groups["pooling (PyTorch)"] = ("max_pool", "avg_pool", "adaptive_avg")
    # cuDNN's one-channel-per-group kernels (conv2d / dgrad2d / wgrad2d
    # _c1_k1_nhwc...): the depthwise convolutions
    groups["depthwise convolutions (cuDNN)"] = ("c1_k1", "depthwise")
    groups["convolutions (cuDNN)"] = (
        "conv", "xmma", "cudnn", "cutlass", "implicit_gemm", "dgrad",
        "wgrad", "fprop", "nhwc", "nchw")
    return groups


def resnet_labels_leg(torch, make, batch, first_loss, per_step, counters,
                      card, what, groups):
    """ResNet-50 through model(x, labels) (the fused pool + classifier +
    cross-entropy tail) and a mean, captured, LABELS_STEPS steps from the
    same weights and batch as the logits leg: its first loss within 2e-2
    relative of that leg's first (the tail rounds h and W to bf16 inside
    its products, the logits leg's Linear runs in bf16), K5-K9 launches per
    step equal to the logits leg's."""
    x, y = batch
    leg = train_leg(torch, lambda: make(lambda losses, _: losses.mean()),
                    (x, y, y), LABELS_STEPS, counters, card,
                    what + ", captured, labels: the fused tail)",
                    groups=groups, top=14)
    print(_leg_line("resnet labels", card, leg, RESNET_B, "images"))
    rel = abs(leg["losses"][0] - first_loss) / abs(first_loss)
    print(f"resnet labels [{card}]: losses "
          + ", ".join(repr(v) for v in leg["losses"])
          + f"; first {leg['losses'][0]!r} against the logits leg's "
          f"{first_loss!r} (relative {rel:.2e})")
    if not all(np.isfinite(leg["losses"])) or not rel <= 2e-2:
        fail(f"resnet labels: losses {leg['losses']} against the logits "
             f"leg's first {first_loss}")
    got = {n: leg["launches"][n] for n in BN_KERNELS}
    want = {k: v * LABELS_STEPS for k, v in per_step.items()}
    if got != want:
        fail(f"resnet labels: K5-K9 launches {got}, expected {want}")
    return got


def _add_launches(total, leg):
    for n in BN_KERNELS:
        total[n] = total.get(n, 0) + leg[n]
    return total


def vgg_pool_sites(torch, fbn, gen, dev, errs):
    """K9 at VGG-16-BN's five pooled sites (bf16, relu, max 2x2/2/0), on
    the route the wrapper takes and on the other: the window route
    forced where the wrapper's plan takes the ring, and where it takes
    the window route (the ring's kh + max(kh, sh) = 4 row slots of W * C
    elements do not fit two blocks per SM) the ring under a hand-made
    plan of 4 slots, one block per SM.  Prints each site's routes."""
    from paddle_tpu_torch.ops import _build
    sms = _build.sm_count(dev.index)
    smem = _build.smem_limits(dev.index)
    out = []
    for shape in VGG_POOL_SITES:
        n, h, w, c = shape
        plan = fbn._pool_plan(n, h, w, c, 2, *VGG_POOL, sms, smem)
        taken = bn_pool_check(torch, fbn, gen, dev, shape, torch.bfloat16,
                              "relu", VGG_POOL, errs)
        if plan.route == "ring":
            other = "window"
        else:
            slot = -(-w * c * 2 // 128) * 128 // 2
            other = fbn.PoolPlan("ring", 4, slot, h // 2, min(n, sms))
        held = bn_pool_check(torch, fbn, gen, dev, shape, torch.bfloat16,
                             "relu", VGG_POOL, errs, other)
        out.append((shape, taken, held))
        torch.cuda.empty_cache()
    print("check bn_pool_apply at VGG-16-BN's pooled sites (bf16, relu, max "
          "2x2/2): " + "; ".join(f"{h}x{w}x{c}: the wrapper's {t}, "
                                 f"{o} held too" for (_, h, w, c), t, o
                                 in out))
    if {t for _, t, _ in out} | {o for _, _, o in out} != {"ring",
                                                           "window"}:
        fail(f"VGG's pooled sites did not exercise both K9 routes: {out}")
    return out


def conv_net_sites(torch, fbn, gen, dev, errs):
    """K5-K8 against their plain versions, bf16 and f32, at every distinct
    fused BatchNorm shape of the conv nets' main paths at b256 x 224^2:
    VGG-16-BN's five (relu; K5 there is also the pooled sites' statistics,
    up to M = 12,845,056 rows), MobileNetV1's ten (relu), MobileNetV2's
    twelve relu6 shapes and five residual ones (no activation), and relu6
    with the residual at its first residual shape."""
    cases = {
        "VGG-16-BN": [(s, "relu", "none") for s in VGG_POOL_SITES],
        "MobileNetV1": [((MOBILE_B, hw, hw, c), "relu", "none")
                        for hw, c in MOBILE_V1_SITES],
        "MobileNetV2": [((MOBILE_B, hw, hw, c), "relu6", "none")
                        for hw, c in MOBILE_V2_RELU6_SITES]
        + [((MOBILE_B, hw, hw, c), None, "plain")
           for hw, c in MOBILE_V2_RESIDUAL_SITES]
        + [((MOBILE_B,) + MOBILE_V2_RESIDUAL_SITES[0][:1] * 2
            + MOBILE_V2_RESIDUAL_SITES[0][1:], "relu6", "plain")]}
    t0 = time.perf_counter()
    for model, sites in cases.items():
        for (n, h, w, c), act, res in sites:
            for dtype in (torch.bfloat16, torch.float32):
                bn_kernel_check(torch, fbn, gen, dev, n * h * w, c, dtype,
                                act, res, errs)
            torch.cuda.empty_cache()
        rows = max(n * h * w for (n, h, w, _), _, _ in sites)
        print(f"check bn {model} sites: K5-K8 at {len(sites)} shapes (up to "
              f"M = {rows:,} rows), bf16 and f32, against the plain "
              "versions: passed")
    print(f"check bn conv-net sites: {time.perf_counter() - t0:.1f} s")


def mobilenet_phase(torch, args, dev, card):
    """MobileNetV1 at full width (scale 1.0, 1000 classes), BASELINE
    config #2's recipe (b256 x 224^2, O2 bf16, layout_policy("NHWC"),
    Momentum(0.1, 0.9)): TrainStep over model(x, labels)'s mean (the
    fused tail), MOBILE_STEPS captured steps, then the same uncaptured
    (losses bit-equal; its profile puts the tail on a line of its own);
    then MobileNetV2 at full width, captured, on its logits and
    F.cross_entropy.  K5-K9 launches per step asserted against the
    models' sites (K9 0), layout copies 0.  Returns the launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import MobileNetV1, MobileNetV2
    torch.cuda.empty_cache()
    counters = bn_counters(fbn)
    groups = bn_groups()
    tail = "classifier tail (fused_ce)"

    def make(cls, loss):
        def build():
            pt.seed(args.seed)
            model = cls(device=dev, seed=args.seed)
            opt = Momentum(learning_rate=0.1, momentum=0.9,
                           parameters=model.parameters())
            return model, TrainStep(model, loss, opt, amp_level="O2",
                                    amp_dtype="bfloat16")
        return build
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    x = torch.randn(MOBILE_B, 3, MOBILE_HW, MOBILE_HW, generator=gen,
                    device=dev)
    y = torch.randint(0, 1000, (MOBILE_B,), generator=gen, device=dev)
    what = f"b{MOBILE_B} x {MOBILE_HW}^2, O2 bf16, NHWC"
    total = {}
    with layout_policy("NHWC"):
        per_step = MOBILE_V1_LAUNCHES
        v1 = make(MobileNetV1, lambda losses, _: losses.mean())
        cap = train_leg(torch, v1, (x, y, y), MOBILE_STEPS, counters, card,
                        f"train step (MobileNetV1, {what}, labels, "
                        "captured)", groups=groups, top=12)
        unc = train_leg(torch, v1, (x, y, y), MOBILE_STEPS, counters, card,
                        f"train step (MobileNetV1, {what}, labels, "
                        "uncaptured)", uncaptured=True, groups=groups,
                        top=12, ranges={tail: "fused_ce"})
        print(_leg_line("mobilenet v1 captured", card, cap, MOBILE_B,
                        "images"))
        print(_leg_line("mobilenet v1 uncaptured", card, unc, MOBILE_B,
                        "images"))
        vals = cap["losses"]
        print("mobilenet v1: losses in full " + ", ".join(map(repr, vals)))
        if not all(np.isfinite(vals)) or unc["losses"] != vals:
            fail(f"mobilenet v1: captured losses {vals}, uncaptured "
                 f"{unc['losses']} (finite and bit-equal expected)")
        for tag, leg in (("captured", cap), ("uncaptured", unc)):
            got = {n: leg["launches"][n] for n in BN_KERNELS}
            want = {k: v * MOBILE_STEPS for k, v in per_step.items()}
            if got != want or leg["launches"]["relayouts"]:
                fail(f"mobilenet v1 {tag}: K5-K9 launches {got}, expected "
                     f"{want}; layout copies {leg['launches']['relayouts']}")
        if cap["recaptured"]:
            fail(f"mobilenet v1: {cap['recaptured']} captures after warmup")
        _add_launches(total, cap["launches"])
        sums = unc["profile"][2]
        print(f"mobilenet v1 [{card}]: K5-K8 launches per step {per_step}; "
              "layout copies 0; per step (uncaptured profile): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
                  sums.items(), key=lambda kv: -kv[1])))
        per2 = MOBILE_V2_LAUNCHES
        v2 = make(MobileNetV2, lambda lg, yy: F.cross_entropy(lg, yy))
        leg2 = train_leg(torch, v2, (x, y), MOBILE_STEPS, counters, card,
                         f"train step (MobileNetV2, {what}, captured)",
                         groups=groups, top=12)
        print(_leg_line("mobilenet v2 captured", card, leg2, MOBILE_B,
                        "images"))
        got = {n: leg2["launches"][n] for n in BN_KERNELS}
        want = {k: v * MOBILE_STEPS for k, v in per2.items()}
        if got != want or not all(np.isfinite(leg2["losses"])):
            fail(f"mobilenet v2: K5-K9 launches {got}, expected {want}; "
                 f"losses {leg2['losses']}")
        _add_launches(total, leg2["launches"])
        forms = MOBILE_V2_FORMS
        print(f"mobilenet v2 [{card}]: {sum(forms.values())} BatchNorms: "
              f"{forms['relu6']} single sites on relu6 (K6 / K8's relu6 "
              f"code), {forms['residual']} with the residual fused in and "
              f"no activation (K6 / K8 in their residual form), "
              f"{forms['plain']} plain batch_norm (projections without a "
              f"shortcut); K5-K8 "
              f"launches per step {per2}; layout copies per step "
              f"{leg2['launches']['relayouts'] / MOBILE_STEPS:g} (the "
              "global pool's backward gradient at the last BatchNorm); "
              "losses "
              + ", ".join(map(repr, leg2["losses"])))
    del x
    torch.cuda.empty_cache()
    return total


def vgg_phase(torch, args, dev, card):
    """vgg16(batch_norm=True) at full width (1000 classes), VGG_B x
    224^2, O2 bf16, layout_policy("NHWC"), Momentum(0.01, 0.9), cross
    entropy on the logits: VGG_STEPS captured steps (K5 / K6 / K7 / K8 /
    K9 launches per step asserted: 13 / 8 / 8 / 8 / 5), then an uncaptured
    profile with _BnPool.backward's plain recompute on a line of its own.
    Prints each pooled site's K9 route.  Returns the launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import vgg16
    torch.cuda.empty_cache()
    counters = bn_counters(fbn)
    groups = bn_groups()
    rec = "pooled backward recompute (_BnPool.backward, plain)"

    def make():
        pt.seed(args.seed)
        model = vgg16(batch_norm=True, device=dev, seed=args.seed)
        opt = Momentum(learning_rate=0.01, momentum=0.9,
                       parameters=model.parameters())
        return model, TrainStep(model, lambda lg, yy: F.cross_entropy(lg, yy),
                                opt, amp_level="O2", amp_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 12)
    x = torch.randn(VGG_B, 3, VGG_HW, VGG_HW, generator=gen, device=dev)
    y = torch.randint(0, 1000, (VGG_B,), generator=gen, device=dev)
    what = f"train step (VGG-16-BN, b{VGG_B} x {VGG_HW}^2, O2 bf16, NHWC"
    with layout_policy("NHWC"):
        per_step = VGG16_LAUNCHES
        sms = _build.sm_count(dev.index), _build.smem_limits(dev.index)
        shapes = [(VGG_B, VGG_HW >> i, VGG_HW >> i, c)
                  for i, c in enumerate((64, 128, 256, 512, 512))]
        plans = [fbn._pool_plan(n, h, w, c, 2, *VGG_POOL, *sms)
                 for n, h, w, c in shapes]
        cap = train_leg(torch, make, (x, y), VGG_STEPS, counters, card,
                        what + ", captured)", groups=groups, top=12)
        print(_leg_line("vgg captured", card, cap, VGG_B, "images"))
        got = {n: cap["launches"][n] for n in BN_KERNELS}
        want = {k: v * VGG_STEPS for k, v in per_step.items()}
        routes = {r: sum(p.route == r for p in plans) * VGG_STEPS
                  for r in ("ring", "window")}
        if got != want or cap["launches"]["routes"] != routes or \
                cap["launches"]["relayouts"] or cap["recaptured"] or \
                not all(np.isfinite(cap["losses"])):
            fail(f"vgg: K5-K9 launches {got} (expected {want}), K9 routes "
                 f"{cap['launches']['routes']} (expected {routes}), layout "
                 f"copies {cap['launches']['relayouts']}, captures after "
                 f"warmup {cap['recaptured']}, losses {cap['losses']}")
        unc = train_leg(torch, make, (x, y), 2, counters, card,
                        what + ", uncaptured)", uncaptured=True,
                        groups=groups, top=12,
                        ranges={rec: "bn_pool_backward"})
        print(_leg_line("vgg uncaptured", card, unc, VGG_B, "images"))
        if unc["losses"] != cap["losses"][:2]:
            fail(f"vgg: uncaptured losses {unc['losses']} differ from the "
                 f"captured {cap['losses'][:2]}")
        print(f"vgg [{card}]: K5-K9 launches per step {per_step}; K9 route "
              "per pooled site: " + ", ".join(
                  f"{h}x{w}x{c} {p.route}"
                  + (f" ({p.ring} slots, band {p.band})"
                     if p.route == "ring" else "")
                  for (_, h, w, c), p in zip(shapes, plans))
              + f"; losses {', '.join(map(repr, cap['losses']))}; the "
              f"pooled sites' plain backward recompute "
              f"{unc['profile'][2].get(rec, 0.0):.3f} ms per step "
              "(uncaptured profile)")
    total = _add_launches({}, cap["launches"])
    del x
    torch.cuda.empty_cache()
    return total


def _conv_check_run(torch, model, dev, batch, policy, fbn):
    """One training forward and backward of ``model`` on ``dev``: (loss,
    gradients by name, running statistics by name, K5-K9 launches, the
    fused entries' composite calls)."""
    from paddle_tpu_torch.jit import forward_loss, layout_policy
    from paddle_tpu_torch.nn import functional as F
    entries = (fbn.bn_act_train, fbn.bn2_act_train, fbn.bn_act_pool_train)
    n0 = {k: getattr(fbn, k).launches for k in BN_KERNELS}
    c0 = sum(e.composite_calls for e in entries)
    x, y = (torch.from_numpy(a).to(dev) for a in batch)
    with layout_policy(policy):
        loss = forward_loss(model, lambda lg, yy: F.cross_entropy(lg, yy),
                            (x, y))
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
    stats = {k: v.detach().double().cpu() for k, v in
             model.state_dict().items() if k.endswith(("_mean", "_variance"))}
    return (float(loss.detach()),
            {n: g.double().cpu() for (n, _), g in zip(named, grads)}, stats,
            {k: getattr(fbn, k).launches - n0[k] for k in BN_KERNELS},
            sum(e.composite_calls for e in entries) - c0)


def _grad_spread(got, want):
    """Per gradient tensor against ``want``'s: (the largest relative
    distance, in norm, over the tensors whose gradient is not zero by the
    math; its tensor; the largest elementwise difference over those that
    are, whose rms is under CONV_CHECK_ZERO; how many those are)."""
    worst, name, zero_err, zeros = 0.0, None, 0.0, 0
    for k, b in want.items():
        if float(b.norm()) / b.numel() ** 0.5 < CONV_CHECK_ZERO:
            zeros += 1
            zero_err = max(zero_err, float((got[k] - b).abs().max()))
            continue
        d = float((got[k] - b).norm() / b.norm())
        if d > worst:
            worst, name = d, k
    return worst, name, zero_err, zeros


def _conv_check_compare(tag, got, want, own):
    """Loss within 1e-4 relative; the whole gradient within 2e-2 of the
    other run's in norm and cos 0.999, and each gradient tensor within
    CONV_CHECK_TOL of the other run's in norm, or elementwise within
    CONV_CHECK_ZERO where it is zero by the math (``own``: the CPU's own
    spread under a 1e-7 relative change of the input, printed beside);
    running means and variances each within 1e-3 of the largest |value|
    of their kind (the means after a normalized projection are zero up
    to rounding)."""
    import torch
    (lg, gg, sg, *_), (lw, gw, sw, *_) = got, want
    worst, name, zero_err, zeros = _grad_spread(gg, gw)
    a = torch.cat([gg[k].ravel() for k in gw])
    b = torch.cat([gw[k].ravel() for k in gw])
    dist = float((a - b).norm() / b.norm())
    cos = float(a @ b / a.norm() / b.norm())
    stat = 0.0
    for kind in ("_mean", "_variance"):
        keys = [k for k in sw if k.endswith(kind)]
        scale = max(float(sw[k].abs().max()) for k in keys)
        stat = max(stat, max(float((sg[k] - sw[k]).abs().max())
                             for k in keys) / scale)
    print(f"convcheck {tag}: loss {lg!r} vs {lw!r}; per gradient tensor: "
          f"largest relative distance {worst:.2e} ({name}) over "
          f"{len(gw) - zeros} tensors (tolerance {CONV_CHECK_TOL}; the "
          f"CPU's own spread {own[0]:.2e}, {own[1]}), the {zeros} zero by "
          f"the math within {zero_err:.2e} elementwise (tolerance "
          f"{CONV_CHECK_ZERO}; the CPU's own {own[2]:.2e}); whole gradient "
          f"distance {dist:.2e} (tolerance 2e-2), cos {cos:.6f}; running "
          f"statistics "
          f"{stat:.2e} of their kind's largest |value|, over {len(sw)}")
    if not (abs(lg - lw) <= 1e-4 * abs(lw) and dist <= 2e-2
            and cos >= 0.999 and worst <= CONV_CHECK_TOL
            and zero_err <= CONV_CHECK_ZERO and stat <= 1e-3):
        fail(f"convcheck {tag}: the two paths disagree")


def conv_check_phase(torch, args, dev):
    """One f32 step of MobileNetV2 (scale 0.5, 10 classes, 8 x 3 x 96 x 96,
    classifier dropout 0) on the kernel path (NHWC policy) against the
    plain path on the CPU, same weights and batch; then the same on the
    card with PDTPU_FUSED_BN=0: no K5-K9 launch, one composite call per
    fused site, against the kernel path.  Each gradient tensor is held on
    its own (_conv_check_compare).  The limit comes from the CPU's own
    spread, measured here too: the plain path again on the input times
    1 + 1e-7 n.  At initialization the gradient is discontinuous at the
    ReLU6 kinks, so an element within rounding of one moves a tensor's
    gradient by its share of the tensor's rows."""
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.vision.models import MobileNetV2
    rng = np.random.RandomState(args.seed + 13)
    batch = (rng.randn(8, 3, 96, 96).astype(np.float32),
             rng.randint(0, 10, (8,)))
    nudged = ((batch[0] * (1 + 1e-7 * rng.randn(*batch[0].shape)))
              .astype(np.float32), batch[1])
    gpu = MobileNetV2(0.5, 10, device=dev, seed=args.seed + 13)
    gpu.classifier[0].p = 0.0
    cpu = copy.deepcopy(gpu).cpu()
    cpu2 = copy.deepcopy(cpu)
    sites = MOBILE_V2_LAUNCHES["bn_stats"]
    start = {k: v.clone() for k, v in gpu.state_dict().items()}
    kern = _conv_check_run(torch, gpu, dev, batch, "NHWC", fbn)
    plain = _conv_check_run(torch, cpu, torch.device("cpu"), batch, None,
                            fbn)
    own = _grad_spread(_conv_check_run(torch, cpu2, torch.device("cpu"),
                                       nudged, None, fbn)[1], plain[1])
    if kern[3] != MOBILE_V2_LAUNCHES or any(plain[3].values()):
        fail(f"convcheck: launches {kern[3]} on the card (expected "
             f"{MOBILE_V2_LAUNCHES}), {plain[3]} on the CPU")
    _conv_check_compare("kernel path vs CPU plain path", kern, plain, own)
    gpu.load_state_dict(start)
    os.environ["PDTPU_FUSED_BN"] = "0"
    try:
        comp = _conv_check_run(torch, gpu, dev, batch, "NHWC", fbn)
    finally:
        del os.environ["PDTPU_FUSED_BN"]
    if any(comp[3].values()) or comp[4] != sites:
        fail(f"convcheck PDTPU_FUSED_BN=0: launches {comp[3]}, composite "
             f"calls {comp[4]} (expected none and {sites})")
    print(f"convcheck PDTPU_FUSED_BN=0: no K5-K9 launch, {comp[4]} "
          f"composite calls ({sites} fused sites)")
    _conv_check_compare("PDTPU_FUSED_BN=0 vs the kernel path", comp, kern,
                        own)
    del gpu, cpu, cpu2
    torch.cuda.empty_cache()


def lenet_phase(torch, args, dev, card):
    """LeNet (BASELINE config #1's model) on synthetic MNIST-shaped data
    from --seed (LENET_B x 1 x 28 x 28, 10 classes; no dataset is read):
    LENET_STEPS eager Adam steps with a falling loss; then a captured
    TrainStep's losses bit-equal to the same steps uncaptured, with
    cuDNN's deterministic algorithms (at LeNet's widths its weight
    gradients otherwise take algorithms that add with atomics, whose
    order changes run to run)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.vision.models import LeNet
    gen = torch.Generator(device=dev).manual_seed(args.seed + 14)
    x = torch.rand(LENET_B, 1, 28, 28, generator=gen, device=dev)
    y = torch.randint(0, 10, (LENET_B,), generator=gen, device=dev)
    model = LeNet(device=dev, seed=args.seed)
    opt = Adam(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    t0 = time.perf_counter()
    for _ in range(LENET_STEPS):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    eager_ms = (time.perf_counter() - t0) / LENET_STEPS * 1e3
    print(f"lenet [{card}]: eager Adam, {LENET_STEPS} steps at "
          f"{eager_ms:.2f} ms per step; losses "
          + ", ".join(f"{v:.4f}" for v in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"lenet: the eager loss does not fall: {losses}")
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for uncaptured in (False, True):
        pt.seed(args.seed)
        m = LeNet(device=dev, seed=args.seed)
        step = TrainStep(m, lambda lg, yy: F.cross_entropy(lg, yy),
                         Adam(learning_rate=1e-3, parameters=m.parameters()))
        step._run_uncaptured = uncaptured
        step.warmup(x, y)
        runs.append([float(step(x, y)) for _ in range(5)])
        del m, step
        gc.collect()
    torch.backends.cudnn.deterministic = deterministic
    print(f"lenet: TrainStep captured {', '.join(map(repr, runs[0]))}; "
          f"uncaptured {', '.join(map(repr, runs[1]))}")
    if runs[0] != runs[1]:
        fail("lenet: captured and uncaptured TrainStep losses differ")


def qat_phase(torch, args, dev, card):
    """ImperativeQuantAware over MobileNetV1 (scale 1.0, QAT_B x 224^2,
    f32, eager Momentum, QAT_STEPS steps): finite losses, K5-K8 27 launches
    per step each, the act_scale buffers move.  Then post-training
    quantization of a fresh MobileNetV1: prepare, 2 calibration batches,
    convert; each converted layer within 1e-4 of the CPU's on the card's
    own input (the gate), and the eval logits end to end finite, with
    their distance from the CPU's printed: there an activation within
    rounding of a quantization boundary lands on either side, one step of
    1/127 of the layer's scale, and 28 layers requantize, so that reading
    has no limit of its own.  Then the QAT model through
    save_quantized_model and jit.load: the same logits (1e-4)."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.quantization import (ImperativeQuantAware,
                                               Int8Conv2D, Int8Linear,
                                               PostTrainingQuantization)
    from paddle_tpu_torch.vision.models import MobileNetV1
    gen = torch.Generator(device=dev).manual_seed(args.seed + 15)

    def images(n):
        return torch.randn(n, 3, 224, 224, generator=gen, device=dev)
    x, y = images(QAT_B), torch.randint(0, 1000, (QAT_B,), generator=gen,
                                        device=dev)
    model = MobileNetV1(device=dev, seed=args.seed + 15)
    qat = ImperativeQuantAware()
    qat.quantize(model)
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters())
    n0 = {k: getattr(fbn, k).launches for k in BN_KERNELS}
    losses, scales = [], []
    for _ in range(QAT_STEPS):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        scales.append({k: float(v) for k, v in model.state_dict().items()
                       if k.endswith("act_scale")})
    got = {k: getattr(fbn, k).launches - n0[k] for k in BN_KERNELS}
    want = {k: v * QAT_STEPS for k, v in MOBILE_V1_LAUNCHES.items()}
    moved = sum(scales[-1][k] != scales[0][k] for k in scales[0])
    print(f"qat [{card}]: MobileNetV1 b{QAT_B} f32 eager, losses "
          + ", ".join(f"{v:.4f}" for v in losses) + f"; {len(scales[0])} "
          f"act_scale buffers, all > 0 after the first step, {moved} moved "
          f"between the first step and the last (fc: "
          + ", ".join(f"{s['fc.act_scale']:.4f}" for s in scales)
          + f"); K5-K9 launches {got}")
    if not all(np.isfinite(losses)) or got != want or not moved or \
            not all(v > 0 for v in scales[0].values()):
        fail(f"qat: losses {losses}, launches {got} (expected {want}), "
             f"act_scale buffers {scales}")
    fp = MobileNetV1(device=dev, seed=args.seed + 16).eval()
    ptq = PostTrainingQuantization()
    ptq.prepare(fp)
    with torch.no_grad():
        for _ in range(2):
            fp(images(QAT_B))
    ptq.convert(fp)
    xe = images(8)
    cpu = copy.deepcopy(fp).cpu()
    seen = []
    hooks = [m.register_forward_hook(
        lambda _, ins, out, name=name: seen.append((name, ins[0], out)))
        for name, m in fp.named_sublayers()
        if isinstance(m, (Int8Conv2D, Int8Linear))]
    with torch.no_grad():
        card_logits = fp(xe).double().cpu()
        cpu_logits = cpu(xe.cpu()).double()
        for h in hooks:
            h.remove()
        # each converted layer on the card's own input, on the CPU
        layers = dict(cpu.named_sublayers())
        layer_err = max(float((out.cpu() - want).abs().max()
                              / want.abs().max())
                        for name, inp, out in seen
                        for want in [layers[name](inp.cpu())])
    err = float((card_logits - cpu_logits).abs().max()
                / cpu_logits.abs().max())
    print(f"qat: PTQ convert (2 calibration batches of {QAT_B}): each of "
          f"the {len(seen)} converted layers on the card within "
          f"{layer_err:.2e} of the CPU's on the same input (tolerance "
          f"1e-4); the converted eval logits {tuple(card_logits.shape)} "
          f"within {err:.2e} of the CPU's end to end (read, not gated: "
          "the layers' inputs differ at quantization boundaries)")
    if not (layer_err <= 1e-4 and len(seen) == 28
            and bool(torch.isfinite(card_logits).all())
            and card_logits.shape == (8, 1000)):
        fail(f"qat: {len(seen)} converted layers differ from the CPU's by "
             f"{layer_err:.3e}; logits {tuple(card_logits.shape)}, finite "
             f"{bool(torch.isfinite(card_logits).all())}")
    path = os.path.join(_build_dir("qat"), "mobilenet_v1_qat")
    t0 = time.perf_counter()
    qat.save_quantized_model(model, path, input_spec=[
        jit.InputSpec([-1, 3, 224, 224], "float32")])
    loaded = jit.load(path, device=dev)
    save_s = time.perf_counter() - t0
    with torch.no_grad():
        want_l = model(xe).double()
        got_l = loaded(xe).double()
    err = float((got_l - want_l).abs().max() / want_l.abs().max())
    print(f"qat: save_quantized_model + jit.load in {save_s:.1f} s; the "
          f"loaded program's logits within {err:.2e} of the QAT model's")
    if not err <= 1e-4:
        fail(f"qat: the loaded QAT program's logits differ by {err:.3e}")
    del model, fp, loaded
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the serving front door: gateway (predictor front, HTTP, codec) and the
# exported predictor
# ---------------------------------------------------------------------------

def _build_dir(name: str) -> str:
    import os
    import shutil
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def _splits(torch, model, dev, prompts, got, want, tag, sampled=(),
            tol=MARGIN_TOL):
    """Indices where stream ``got[i]`` leaves ``want[i]``; a greedy split
    must sit where the ``want`` path's top-two margin is below ``tol``,
    a sampled stream must be equal."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        if i in sampled:
            fail(f"{tag}: sampled stream {i} differs from the plain engine's")
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        margin = _top2_margin(torch, model, dev,
                              np.concatenate([prompts[i], w[:j]]))
        print(f"{tag}: stream {i} splits from the plain engine's at token "
              f"{j}: top-two margin {margin:.3e}")
        if margin >= tol:
            fail(f"{tag}: stream {i} splits at token {j} where the margin is "
                 f"{margin:.3e} (>= {tol})")
        out.append((i, j, margin))
    return out


def _sse_tokens(url: str, body: dict, timeout: float):
    """POST a streamed completion; the SSE chunks' token ids and whether the
    stream ended with ``data: [DONE]``."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    toks, done = [], False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.strip()
            if line == b"data: [DONE]":
                done = True
            elif line.startswith(b"data: "):
                chunk = json.loads(line[6:])
                if "error" in chunk:
                    fail(f"gateway http: error chunk {chunk}")
                toks += chunk["choices"][0]["token_ids"]
    return toks, done


def _get_json(url: str, timeout: float):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        body = r.read()
    return body


def gateway_phase(torch, args, dev, card):
    """The serving front door on GPT-2 medium (random weights from --seed):
    saved by jit.save (weights and metadata), served through
    create_predictor(Config(prefix).enable_serving(model_provider=...,
    quantize="int8", kv="paged", ..., gateway={gold: weight 4, may send
    high; free: weight 1, low only})).  The serve phase's 8 requests from
    "free" at low priority, then, once they hold the 8 slots, 4 "gold"
    requests at PRIORITY_HIGH: the gateway preempts 4 low decodes, runs
    the high ones and resumes the low ones.  Every stream must equal the
    same request's through the plain engine (the same engine driven
    without the gateway: FIFO, no preemption) or split only at a near tie;
    every response terminal; no capture after warmup; K3 / K4 launched.
    Then one streamed completion over serve_http (127.0.0.1, port 0) equal
    to the gateway's stream, /healthz warm and /metrics with gateway_*
    series; then a run preempted from the paged engine crosses the codec
    (encode_run -> run_to_bytes -> run_from_bytes -> decode_run) into a
    second engine of the same model on the fixed KV layout and continues
    its stream."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (PRIORITY_HIGH, PRIORITY_LOW,
                                          ServingEngine, TenantConfig,
                                          decode_run, encode_run,
                                          run_from_bytes, run_to_bytes)
    tag = "gateway"
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    prefix = _build_dir("gateway") + "/gpt2_medium"
    t0 = time.perf_counter()
    jit.save(GPTForPretraining(cfg, device=dev, seed=args.seed).eval(),
             prefix)
    save_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pred = create_predictor(Config(prefix).enable_serving(
        model_provider=lambda: GPTForPretraining(cfg, device=dev,
                                                 seed=args.seed + 1),
        quantize="int8", kv="paged", block_size=BLOCK, max_slots=SLOTS,
        max_len=MAX_LEN, decode_chunk=4, start=False,
        gateway={"tenants": {"gold": TenantConfig(weight=4.0,
                                                  max_priority=1),
                             "free": TenantConfig(weight=1.0,
                                                  max_priority=0)}}))
    boot_s = time.perf_counter() - t0
    eng, gw = pred.engine, pred.gateway
    counts = eng.compile_counts()
    if not eng.warm or counts["total"] != counts["bound"]:
        fail(f"{tag}: warmup captured {counts}")
    model = eng.model
    print(f"{tag}: jit.save {save_s:.2f}s (weights + metadata), "
          f"create_predictor {boot_s:.2f}s (build, npz load, int8, warmup: "
          f"{counts['total']} CUDA graphs)")
    lo_prompts, sampled = serve_requests(args, cfg.vocab_size)
    rng = np.random.RandomState(args.seed + 7)
    hi_prompts = [rng.randint(0, cfg.vocab_size, (n,))
                  for n in (64, 128, 192, 256)]
    prompts = lo_prompts + hi_prompts
    knobs = [{"decode_strategy": "sampling", **sampled[i]} if i in sampled
             else {} for i in range(len(prompts))]

    # the plain engine: the same 12 requests, FIFO, no gateway
    outs, wall, _, _ = _drive(torch, eng, prompts, sampled, 64,
                              f"{tag} plain")
    plain = outs
    plain_tps = 12 * 64 / wall

    # the gateway: 8 low requests fill the slots, 4 high ones preempt
    timing = {"preempt": [], "restore": []}
    for name, key in (("preempt_slot", "preempt"),
                      ("restore_run", "restore")):
        orig = getattr(eng, name)

        def timed(*a, _orig=orig, _key=key):
            t = time.perf_counter()
            try:
                return _orig(*a)
            finally:
                torch.cuda.synchronize()
                timing[_key].append(time.perf_counter() - t)
        setattr(eng, name, timed)
    torch.cuda.synchronize()
    im.dequant_matmul.launches = pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    resps = [pred.submit(p, 64, tenant="free", priority=PRIORITY_LOW,
                         **knobs[i]) for i, p in enumerate(lo_prompts)]
    gw.start()     # its first tick admits the 8 low requests together
    deadline = time.monotonic() + 120
    while eng.scheduler.occupancy() < SLOTS:
        if time.monotonic() > deadline:
            fail(f"{tag}: the low requests never held the {SLOTS} slots")
        time.sleep(0.001)
    resps += [pred.submit(p, 64, tenant="gold", priority=PRIORITY_HIGH)
              for p in hi_prompts]
    try:
        gw_outs = [r.tokens(timeout=300) for r in resps]
    except Exception as e:  # noqa: BLE001 — a failed request fails the phase
        fail(f"{tag}: a request failed: {e!r}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"int8_matmul": im.dequant_matmul.launches,
                "paged_attention": pa.paged_attention.launches}
    if not all(r.done() for r in resps):
        fail(f"{tag}: a response is not terminal")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{tag}: kernel {name} was not launched")
    m = gw.metrics()
    if m["preempted"] < 1 or m["resumed"] != m["preempted"]:
        fail(f"{tag}: {m['preempted']} preemptions, {m['resumed']} resumes")
    if any(r.request.preempts for r in resps[8:]):
        fail(f"{tag}: a high request was preempted")
    if eng.post_warmup_compiles() != 0:
        fail(f"{tag}: {eng.post_warmup_compiles()} captures after warmup")
    splits = _splits(torch, model, dev, prompts, gw_outs, plain, tag,
                     sampled=set(sampled))
    ttft = {lane: sorted(r.ttft for r in rs) for lane, rs in
            (("high", resps[8:]), ("low", resps[:8]))}
    pre, res = timing["preempt"], timing["restore"]
    print(f"{tag} [{card}]: 12 requests (8 low, 4 high), {12 * 64} tokens in "
          f"{wall:.3f}s: {12 * 64 / wall:.1f} tokens/s against the plain "
          f"engine's {plain_tps:.1f} on the same 12; TTFT p50 high "
          f"{ttft['high'][len(ttft['high']) // 2] * 1e3:.1f} ms, low "
          f"{ttft['low'][len(ttft['low']) // 2] * 1e3:.1f} ms; "
          f"{m['preempted']} preemptions "
          f"({np.mean(pre) * 1e3:.1f} ms each), {m['resumed']} resumes "
          f"({np.mean(res) * 1e3:.1f} ms each); launches {launches}; "
          f"{12 - len(splits)} of 12 streams equal the plain engine's, "
          f"splits {splits}; captures after warmup 0")

    # the HTTP side: one streamed completion over a real socket
    server = pred.serve_http(port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        toks, done = _sse_tokens(base + "/v1/completions", {
            "prompt": [int(t) for t in lo_prompts[0]], "max_tokens": 64,
            "stream": True, "user": "free"}, timeout=120)
        if not done or toks != gw_outs[0]:
            fail(f"{tag} http: the SSE stream (done={done}, {len(toks)} "
                 "tokens) differs from the gateway's stream")
        health = json.loads(_get_json(base + "/healthz", 30))
        if health.get("warm") is not True or not health.get("ok"):
            fail(f"{tag} http: /healthz says {health}")
        metrics = _get_json(base + "/metrics", 30).decode()
        series = sorted({ln.split("{")[0].split(" ")[0]
                         for ln in metrics.splitlines()
                         if ln.startswith("gateway_")})
        if not series:
            fail(f"{tag} http: /metrics carries no gateway_* series")
    finally:
        server.close()
    print(f"{tag} http: SSE stream of {len(toks)} tokens == the gateway's; "
          f"/healthz warm {health['warm']}; /metrics gateway series "
          f"{series}")
    rep = pred.profile_report()
    gw.close(close_engine=False)
    print(f"{tag}: profile_report() keys {sorted(rep)}")

    # the codec: a run preempted from the paged engine resumes on a fixed
    # one of the same model
    fixed = ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                          kv="fixed", device=dev)
    warm = fixed.warmup()
    if not warm["captured"]:
        fail(f"{tag} codec: the fixed engine captured nothing")
    i = 7
    req, resp = eng.make_request(prompts[i], 64, **knobs[i])
    if not eng.try_admit(req, resp):
        fail(f"{tag} codec: no slot")
    for _ in range(3):
        eng.step()
    head = resp.tokens_so_far()
    (slot,) = list(eng._slots)
    paused = eng.preempt_slot(slot)
    times = {}
    t = time.perf_counter()
    blob = encode_run(paused)
    times["encode"] = time.perf_counter() - t
    t = time.perf_counter()
    data = run_to_bytes(blob)
    times["bytes"] = time.perf_counter() - t
    t = time.perf_counter()
    moved = decode_run(run_from_bytes(data), engine=fixed)
    times["decode"] = time.perf_counter() - t
    if not fixed.restore_run(moved):
        fail(f"{tag} codec: the fixed engine took no restore")
    fixed.run_until_drained(timeout=120)
    tail = moved.resp.tokens(timeout=5)
    if head + tail != plain[i]:
        fail(f"{tag} codec: the moved run's stream ({len(head)} + "
             f"{len(tail)} tokens) differs from the uninterrupted one")
    if fixed.post_warmup_compiles() != 0:
        fail(f"{tag} codec: captures after warmup")
    print(f"{tag} codec [{card}]: a run preempted at {len(head)} tokens "
          f"(pos {paused.pos}) crossed paged -> fixed: blob "
          f"{len(data) / 2**20:.2f} MiB, encode {times['encode'] * 1e3:.1f} "
          f"ms, bytes {times['bytes'] * 1e3:.1f} ms, decode "
          f"{times['decode'] * 1e3:.1f} ms; the stream continues equal to "
          f"the uninterrupted run ({len(head)} + {len(tail)} tokens)")
    fixed.close()
    pred.close()
    del pred, eng, gw, fixed, model
    torch.cuda.empty_cache()


def _fleet_launches(eng) -> dict:
    """K3 / K4 launches through ``eng``'s graph replays so far: each
    program's replays times its graph's recorded launches."""
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    names = {id(pa.paged_attention): "paged_attention",
             id(im.dequant_matmul): "int8_matmul"}
    out = dict.fromkeys(names.values(), 0)
    for prog in eng._programs.values():
        for (owner, _key), n in prog.launches:
            if id(owner) in names:
                out[names[id(owner)]] += n * prog.replays
    return out


def _p99(xs):
    return float(np.percentile(xs, 99)) * 1e3 if xs else float("nan")


def fleet_phase(torch, args, dev, card):
    """The in-process serving fleet on one card: two replicas of the
    gateway phase's engine options built over ONE GPT-2 medium int8 model
    (each engine serves a copy of its own), behind a started
    ServingGateway over the FleetRouter; a plain engine of the same
    options gives the uninterrupted streams and is the refresher's oracle.
    (1) 16 requests (prompts 32..400, 64 new tokens; 12 greedy with
    resubmit, 4 keyed-sampled; four sessions of 2) served clean, then
    again with PDTPU_FAULT_REPLICA_CRASH mid-decode: greedy streams equal
    the plain engine's (or split at a near tie), the crashed replica's
    sampled runs end in ReplicaLostError, the others equal, sessions
    held, every response terminal, exactly one crash.  (2) a second
    wave's 8 prompts (64..160 tokens, 512 new) arriving, 12 kept in
    flight, while ``rollout`` boots a replacement per replica (graphs
    captured on this thread while the gateway's thread replays),
    drains the old one (its residents migrate mid-decode through the
    codec) and removes it: every stream equal, nothing dropped, no
    capture after warmup on the old replicas, the card's memory after
    each remove within 2% of a replica's footprint of its level before
    the matching boot.  (3) WeightPublisher / FleetRefresher: a second
    seed's weights pass the three gates and flip both replicas (canary
    streams equal the oracle's, nothing captured), a corrupt publish is
    quarantined, a diverging canary is rolled back; /healthz 200 with
    both replicas verified.  (4) From one replica, the Autoscaler
    (injected clock) scales up on a burst and down by a drain.  K3 / K4
    launches counted over the phase (zeroed just before) and per
    replica through its graphs' replays.  Returns the clean wave's
    tokens/s, the plain engine's and the mean flip ms (the worker phase
    prints its own beside them)."""
    import os
    import shutil
    import threading

    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving import (Autoscaler, FleetRefresher,
                                          FleetRouter, ReplicaLostError,
                                          Response, ServingEngine,
                                          ServingGateway, WeightPublisher)
    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.utils import faults
    tag = "fleet"
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    model = GPTForPretraining(cfg, device=dev, seed=args.seed).eval()
    # what an engine's own copy of the weights costs before and after
    # int8 (serve_model's model: quantized in place)
    f32_bytes = sum(t.numel() * t.element_size()
                    for t in model.state_dict().values())
    quantize_for_serving(model)
    rng = np.random.RandomState(args.seed + 21)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in FLEET_LENS]
    knobs = [dict(decode_strategy="sampling", temperature=0.8, top_k=40,
                  top_p=0.9, seed=40 + i) if i in FLEET_SAMPLED
             else {"resubmit": True} for i in range(len(prompts))]
    sampled = set(FLEET_SAMPLED)
    roll = [rng.randint(0, cfg.vocab_size, (n,)) for n in FLEET_ROLL_LENS]

    def make():
        return ServingEngine(model, max_slots=SLOTS, max_len=MAX_LEN,
                             kv="paged", block_size=BLOCK, decode_chunk=4,
                             device=dev)

    captures = []   # (start, end) of each warmup on this thread

    def warm(eng):
        t = time.monotonic()
        rep = eng.warmup()
        captures.append((t, time.monotonic()))
        c = rep["compile_counts"]
        if not rep["captured"] or c["total"] != c["bound"]:
            fail(f"{tag}: warmup captured {c}")
        return rep["seconds"]

    def mem():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    # the plain engine: the uninterrupted streams, then the oracle (its
    # warmup also makes this thread's capture stream and its workspace)
    copy_bytes = sum(t.numel() * t.element_size()
                     for t in model.state_dict().values())
    plain = make()
    warm(plain)

    def plain_run(ps, new, kw):
        t0 = time.perf_counter()
        resps = [plain.submit(p, max_new_tokens=new,
                              **{k: v for k, v in kw[i].items()
                                 if k != "resubmit"})
                 for i, p in enumerate(ps)]
        plain.run_until_drained(timeout=600)
        torch.cuda.synchronize()
        return [r.tokens(timeout=5) for r in resps], time.perf_counter() - t0

    want, plain_wall = plain_run(prompts, FLEET_NEW, knobs)
    want_roll, _ = plain_run(roll, FLEET_ROLL_NEW, [{}] * len(roll))

    removed = []    # per removed replica: id, captures after warmup, memory
    orig_remove = fleet_mod.ReplicaManager.remove

    def remove(self, rid):
        rep = self.get(rid)
        if rep is None or rep.state == fleet_mod.DRAINING:
            return orig_remove(self, rid)   # nothing, or a deferred remove
        rec = {"id": rid, "pwc": rep.engine.post_warmup_compiles(),
               "launches": _fleet_launches(rep.engine)}
        orig_remove(self, rid)
        rec["mem_after"] = mem()
        removed.append(rec)
    fleet_mod.ReplicaManager.remove = remove
    times = {}     # id(response) -> token arrival times
    orig_push = Response._push_token

    def timed_push(self, tok, logp=0.0):
        times.setdefault(id(self), []).append(time.monotonic())
        orig_push(self, tok, logp)
    Response._push_token = timed_push
    crash_at = {}
    orig_on_crash = fleet_mod.ReplicaManager._on_crash

    def on_crash(self, rep, exc):
        crash_at.setdefault("t", time.monotonic())
        crash_at["exc"] = exc
        orig_on_crash(self, rep, exc)
    fleet_mod.ReplicaManager._on_crash = on_crash
    flip_ms, canary_ms, rollback_ms = [], [], []
    orig_flip = fleet_mod.ReplicaManager._apply_flip
    fleet_mod.ReplicaManager._apply_flip = _timed(torch, orig_flip, flip_ms)
    fleet = gw = None
    pub_dir = _build_dir("fleet_publish")
    try:
        m0 = mem()
        a = make()
        warm(a)
        footprint = mem() - m0
        print(f"{tag}: a replica takes {footprint / 2**30:.3f} GiB of the "
              f"card, {copy_bytes / 2**30:.3f} GiB of it its own copy of "
              f"the int8 weights (of the f32 weights it would be "
              f"{f32_bytes / 2**30:.3f} GiB)")
        b = make()
        warm(b)
        fleet = FleetRouter([a, b])
        fleet.warmup()
        del a, b
        gw = ServingGateway(fleet)
        gw.start()
        placed = {}

        def track(rep):
            orig = rep.engine.try_admit

            def admit(req, resp):
                ok = orig(req, resp)
                if ok:
                    placed[id(resp)] = rep.id
                return ok
            rep.engine.try_admit = admit
        for rep in fleet.manager.replicas():
            track(rep)

        def wave(ps, new, kw, sessions):
            return [gw.submit(p, new, tenant="t",
                              session=sessions.get(i), **kw[i])
                    for i, p in enumerate(ps)]

        def outcomes(resps, what):
            try:
                for r in resps:
                    r.tokens(timeout=600)
            except Exception:  # noqa: BLE001 — judged per response below
                pass
            if not all(r.done() for r in resps):
                fail(f"{tag} {what}: a response is not terminal")
            return [r.tokens_so_far() for r in resps]

        # (1a) the clean wave: routing, affinity, tokens/s
        torch.cuda.synchronize()
        im.dequant_matmul.launches = pa.paged_attention.launches = 0
        t0 = time.perf_counter()
        clean = wave(prompts, FLEET_NEW, knobs, FLEET_SESSIONS)
        got = outcomes(clean, "clean wave")
        torch.cuda.synchronize()
        fleet_wall = time.perf_counter() - t0
        if any(r.error is not None for r in clean):
            fail(f"{tag}: a clean-wave request failed: "
                 f"{[repr(r.error) for r in clean if r.error]}")
        splits = _splits(torch, model, dev, prompts, got, want,
                         f"{tag} clean", sampled=sampled)
        by_replica = {rid: sum(1 for r in clean if placed[id(r)] == rid)
                      for rid in (0, 1)}
        print(f"{tag} [{card}]: 2 replicas, {len(prompts)} requests, "
              f"{len(prompts) * FLEET_NEW} tokens in {fleet_wall:.3f}s: "
              f"{len(prompts) * FLEET_NEW / fleet_wall:.1f} tokens/s "
              f"against one plain engine's "
              f"{len(prompts) * FLEET_NEW / plain_wall:.1f} on the same "
              f"{len(prompts)}; placed {by_replica}; splits {splits}")

        # (1b) the same requests, replica 1 lost mid-decode
        crash = wave(prompts, FLEET_NEW, knobs, FLEET_SESSIONS)
        deadline = time.monotonic() + 120
        while min(len(r.tokens_so_far()) for r in crash) < 8:
            if time.monotonic() > deadline:
                fail(f"{tag} crash: the wave never reached 8 tokens")
            time.sleep(0.001)
        victim = fleet.manager.get(1)
        faults.enable("replica_crash", f"1:{victim.steps + 3}")
        got = outcomes(crash, "crash wave")
        faults.disable("replica_crash")
        c = fleet.manager.counters()
        if c["failovers"] != 1 or victim.state != "crashed":
            fail(f"{tag} crash: {c['failovers']} fences (want the one "
                 f"injected), replica 1 {victim.state}, cause "
                 f"{crash_at.get('exc')!r}")
        if not isinstance(crash_at["exc"], fleet_mod._InjectedReplicaCrash):
            fail(f"{tag} crash: a crash not injected: {crash_at['exc']!r}")
        lost = [i for i, r in enumerate(crash)
                if isinstance(r.error, ReplicaLostError)]
        for i, r in enumerate(crash):
            on_victim = placed[id(r)] == 1
            if i in sampled and on_victim:
                if i not in lost:
                    fail(f"{tag} crash: sampled request {i} on the lost "
                         f"replica ended {r.error!r}")
            elif r.error is not None:
                fail(f"{tag} crash: request {i} failed: {r.error!r}")
        for resps in (clean, crash):
            for sess in set(FLEET_SESSIONS.values()):
                if len({placed[id(resps[i])] for i, v in
                        FLEET_SESSIONS.items() if v == sess}) != 1:
                    fail(f"{tag}: session {sess} left its replica while "
                         "it lived")
        keep = [i for i in range(len(prompts)) if i not in lost]
        splits = _splits(torch, model, dev, [prompts[i] for i in keep],
                         [got[i] for i in keep], [want[i] for i in keep],
                         f"{tag} crash",
                         sampled={k for k, i in enumerate(keep)
                                  if i in sampled})
        resubmitted = [i for i, r in enumerate(crash)
                       if placed[id(r)] == 1 and i not in sampled]
        first = min(t for i in resubmitted for t in times[id(crash[i])]
                    if t > crash_at["t"])
        print(f"{tag} crash [{card}]: replica 1 lost at its step "
              f"{victim.steps - 1}; {c['resubmits']} runs resubmitted "
              f"({resubmitted}), {len(lost)} lost ({lost}, "
              f"ReplicaLostError), {c['reroutes']} re-routed; first token "
              f"after the crash {(first - crash_at['t']) * 1e3:.1f} ms "
              f"later; streams equal the plain engine's but {splits}")

        # the crashed replica goes, a fresh one comes
        before = mem()
        fleet.remove(1)
        freed = before - removed[-1]["mem_after"]
        boot = make()
        idle_boot_s = warm(boot)
        track(fleet.manager.get(fleet.add_replica(boot)))
        fleet.manager.refresh_warm_marks()
        del boot
        print(f"{tag}: removing the crashed replica freed "
              f"{freed / 2**30:.3f} GiB (a replica: "
              f"{footprint / 2**30:.3f}); its replacement captured in "
              f"{idle_boot_s:.3f}s with no traffic")
        if abs(freed - footprint) > MEM_TOL * footprint:
            fail(f"{tag}: the crashed replica's remove freed {freed} "
                 f"bytes, its footprint is {footprint}")

        # (2) rollout under traffic
        migrate_ms = []
        mig = fleet_mod.ReplicaManager._migrate_residents

        def timed_migrate(self, rep):
            torch.cuda.synchronize()
            t = time.perf_counter()
            n0 = self._n["migrated"]
            did = mig(self, rep)
            n = self._n["migrated"] - n0
            if n:
                torch.cuda.synchronize()
                migrate_ms.append((time.perf_counter() - t) * 1e3 / n)
            return did
        fleet_mod.ReplicaManager._migrate_residents = timed_migrate
        boots, mems = [], []

        def factory():
            mems.append(mem())
            eng = make()
            boots.append(warm(eng))
            return eng

        n_caps = len(captures)
        drained = []     # (replica, its residents when its drain began)
        orig_drain = fleet.drain

        def drain(rid):
            drained.append((rid, fleet.manager.get(rid).engine.scheduler
                            .occupancy()))
            orig_drain(rid)
        fleet.drain = drain
        # the wave's 8 prompts go on arriving (FLEET_ROLL_INFLIGHT kept
        # unfinished) until the rollout returns: every boot captures
        # under traffic and every drain finds residents mid-decode
        roll_resps, which = [], []
        rolled = threading.Event()

        def keep_up():
            while not rolled.is_set():
                if sum(not r.done() for r in roll_resps) \
                        < FLEET_ROLL_INFLIGHT:
                    i = len(roll_resps) % len(roll)
                    roll_resps.extend(wave([roll[i]], FLEET_ROLL_NEW,
                                           [{}], {}))
                    which.append(i)
                else:
                    time.sleep(0.002)

        feeder = threading.Thread(target=keep_up, name="fleet-feeder")
        feeder.start()
        try:
            deadline = time.monotonic() + 120
            while len(roll_resps) < FLEET_ROLL_INFLIGHT or min(
                    len(r.tokens_so_far()) for r in roll_resps) < 8:
                if time.monotonic() > deadline:
                    fail(f"{tag} rollout: the wave never reached 8 tokens")
                time.sleep(0.001)
            old_ids = [r.id for r in fleet.manager.replicas(("healthy",))]
            new_ids = fleet.rollout(factory)
        finally:
            rolled.set()
            feeder.join()
        fleet.drain = orig_drain
        fleet_mod.ReplicaManager._migrate_residents = mig
        for rid in new_ids:
            track(fleet.manager.get(rid))
        got = outcomes(roll_resps, "rollout wave")
        if any(r.error is not None for r in roll_resps):
            fail(f"{tag} rollout: dropped "
                 f"{[repr(r.error) for r in roll_resps if r.error]}")
        splits = _splits(torch, model, dev, [roll[i] for i in which], got,
                         [want_roll[i] for i in which], f"{tag} rollout")
        moved = sum(r.request.migrations for r in roll_resps)
        if moved < 1:
            fail(f"{tag} rollout: no run migrated mid-decode (residents at "
                 f"each drain {drained}, boots {boots} s)")
        olds = [r for r in removed if r["id"] in old_ids]
        if any(r["pwc"] != 0 for r in olds):
            fail(f"{tag} rollout: captures after warmup on the old "
                 f"replicas {[r['pwc'] for r in olds]}")
        drift = [r["mem_after"] - m for r, m in zip(olds, mems)]
        if any(abs(d) > MEM_TOL * footprint for d in drift):
            fail(f"{tag} rollout: memory after a remove differs from its "
                 f"level before the matching boot by {drift} bytes")
        windows = captures[n_caps:]
        inside, outside = [], []
        for r in roll_resps:
            ts = times.get(id(r), [])
            for t_a, t_b in zip(ts, ts[1:]):
                hit = any(t_a < e and t_b > s for s, e in windows)
                (inside if hit else outside).append(t_b - t_a)
        print(f"{tag} rollout [{card}]: {len(old_ids)} replicas replaced "
              f"under traffic; boots captured in "
              f"{[round(x, 3) for x in boots]} s; residents at each drain "
              f"{drained}; {moved} runs migrated "
              f"mid-decode at {np.mean(migrate_ms):.1f} ms each (preempt + "
              f"encode + decode + restore; max {max(migrate_ms):.1f}); "
              f"inter-token p99 {_p99(inside):.1f} ms during the captures "
              f"({len(inside)} gaps) against {_p99(outside):.1f} ms outside "
              f"({len(outside)}); memory after each remove minus before its "
              f"boot {[round(d / 2**20, 1) for d in drift]} MiB; "
              f"{len(got) - len(splits)} of {len(got)} streams equal, "
              f"splits {splits}; nothing dropped")

        # (3) refresh
        refresher = FleetRefresher(fleet, pub_dir, plain,
                                   canary_prompts=[p[:64] for p in
                                                   prompts[:2]],
                                   canary_max_new_tokens=32,
                                   flip_timeout_s=120.0,
                                   canary_timeout_s=120.0)
        refresher._replica_tokens = _timed(torch, refresher._replica_tokens,
                                           canary_ms)
        refresher._rollback_canary = _timed(
            torch, refresher._rollback_canary, rollback_ms)
        publisher = WeightPublisher(pub_dir)

        def publish(seed):
            new = quantize_for_serving(GPTForPretraining(
                cfg, device=dev, seed=seed).eval())
            t = time.perf_counter()
            pub = publisher.publish(model=new)
            del new
            torch.cuda.empty_cache()
            return pub, time.perf_counter() - t

        def shas():
            return [r.engine.weights_sha
                    for r in fleet.manager.replicas(("healthy",))]

        def converge(sha, what):
            deadline = time.monotonic() + 300
            while True:
                refresher.poll()
                if shas() == [sha, sha]:
                    return
                if time.monotonic() > deadline:
                    fail(f"{tag} refresh: {what} never converged "
                         f"({refresher.status()})")
                time.sleep(0.01)

        good, pub_s = publish(args.seed + 1)
        converge(good["sha256"], "the good publish")
        canary = [plain.submit(p[:64], max_new_tokens=32)
                  for p in prompts[:2]]
        plain.run_until_drained(timeout=120)
        oracle_streams = [r.tokens(timeout=5) for r in canary]
        for rep in fleet.manager.replicas(("healthy",)):
            resps = []
            for p in prompts[:2]:
                req, resp = rep.engine.make_request(p[:64], 32)
                rep.engine.scheduler.submit(req, resp)
                resps.append(resp)
            fleet._work.set()
            if [r.tokens(timeout=120) for r in resps] != oracle_streams:
                fail(f"{tag} refresh: replica {rep.id}'s canary streams "
                     "differ from the oracle's")
        if fleet.post_warmup_compiles() != 0:
            fail(f"{tag} refresh: a capture after the flip")
        faults.enable("publish_corrupt", "1")
        bad, _ = publish(args.seed + 2)
        faults.disable("publish_corrupt")
        refresher.poll()
        st = refresher.status()
        if bad["sha256"] not in st["quarantined"] or \
                shas() != [good["sha256"]] * 2:
            fail(f"{tag} refresh: the corrupt publish was not quarantined "
                 f"({st})")
        faults.enable("canary_diverge")
        div, _ = publish(args.seed + 3)
        refresher.poll()
        faults.disable("canary_diverge")
        converge(good["sha256"], "the rollback")
        st = refresher.status()
        c = fleet.manager.counters()
        if div["sha256"] not in st["quarantined"] or c["rollbacks"] != 2:
            fail(f"{tag} refresh: the diverging canary was not rolled back "
                 f"({st}, {c['rollbacks']} rollbacks)")
        status, _, body = gw.handle("GET", "/healthz")
        health = json.loads(body)
        if status != 200 or health["fleet"]["routable_verified"] != 2:
            fail(f"{tag} refresh: /healthz {status}, fleet "
                 f"{health['fleet']['routable_verified']} verified")
        if fleet.post_warmup_compiles() != 0:
            fail(f"{tag} refresh: a capture after a flip")
        print(f"{tag} refresh [{card}]: publish {pub_s:.2f}s "
              f"({os.path.getsize(good['path']) / 2**30:.3f} GiB npz); "
              f"{c['weight_refreshes']} flips at {np.mean(flip_ms):.1f} ms "
              f"each (max {max(flip_ms):.1f}); canary "
              f"{np.mean(canary_ms):.1f} ms (2 x 32 tokens); rollback "
              f"{np.mean(rollback_ms):.1f} ms; quarantined "
              f"{sorted(v for v in st['quarantined'].values())}; /healthz "
              f"{status}, routable_verified 2; no capture after warmup")

        # (4) the autoscaler, from one replica
        def wait_removed(n, what):
            # the drain's end removes the replica on the gateway's thread
            deadline = time.monotonic() + 120
            while len(removed) < n:
                if time.monotonic() > deadline:
                    fail(f"{tag} autoscale: {what} never left")
                time.sleep(0.005)

        rid = fleet.manager.replicas(("healthy",))[0].id
        fleet.drain(rid)
        fleet.remove(rid)
        wait_removed(len(removed) + 1, "the drained replica")
        with np.load(good["path"]) as z:
            state = {k: z[k] for k in z.files}

        def spawn():
            eng = make()
            warm(eng)
            eng.swap_weights(state, good["sha256"])
            new_id = fleet.add_replica(eng)
            track(fleet.manager.get(new_id))
            return new_id

        asc = Autoscaler(fleet, gw.scale_signals, spawn, min_replicas=1,
                         max_replicas=2, scale_up_est_wait_s=0.05,
                         breach_ticks=2, idle_ticks=2, cooldown_s=0.0,
                         _clock=lambda: 0.0)
        burst = wave(prompts + prompts[:8], FLEET_NEW,
                     knobs + knobs[:8], {})
        acts = []
        t = time.perf_counter()
        while "up" not in acts and time.perf_counter() - t < 30:
            acts.append(asc.tick())
        up_s = time.perf_counter() - t
        # after the scale-up, traffic reaches the new replica too
        burst += wave(prompts, FLEET_NEW, knobs, {})
        outcomes(burst, "burst")
        if any(r.error is not None for r in burst):
            fail(f"{tag} autoscale: a burst request failed")
        spread = {rid: sum(1 for r in burst[-len(prompts):]
                           if placed[id(r)] == rid)
                  for rid in (r.id for r in fleet.manager.replicas())}
        n_removed = len(removed)
        t = time.perf_counter()
        while "down" not in acts and time.perf_counter() - t < 30:
            acts.append(asc.tick())
            time.sleep(0.01)
        wait_removed(n_removed + 1, "the retired replica")
        c = fleet.manager.counters()
        if (c["scale_up"], c["scale_down"]) != (1, 1):
            fail(f"{tag} autoscale: actions {acts}, counters {c}")
        print(f"{tag} autoscale [{card}]: 1 -> 2 -> 1 replicas on a burst "
              f"of {len(burst)} requests (scale-up decided and booted in "
              f"{up_s:.2f}s under traffic, the capture included; the next "
              f"{len(prompts)} placed {spread}; the retirement a drain); "
              f"actions {[a for a in acts if a]}")

        # launches over the phase
        launches = {"int8_matmul": im.dequant_matmul.launches,
                    "paged_attention": pa.paged_attention.launches}
        for name, n in launches.items():
            if n <= 0:
                fail(f"{tag}: kernel {name} was not launched")
        per = {r["id"]: r["launches"] for r in removed}
        for rep in fleet.manager.replicas():
            per[rep.id] = _fleet_launches(rep.engine)
        if any(v["paged_attention"] <= 0 or v["int8_matmul"] <= 0
               for v in per.values()):
            fail(f"{tag}: a replica launched no K3 / K4: {per}")
        print(f"{tag}: launches over the phase {launches}; per replica "
              f"through its replays {per}; plain engine / oracle "
              f"{_fleet_launches(plain)}")
        return {"tokens_per_s": len(prompts) * FLEET_NEW / fleet_wall,
                "plain_tokens_per_s": len(prompts) * FLEET_NEW / plain_wall,
                "flip_ms": float(np.mean(flip_ms))}
    finally:
        faults.reset()
        Response._push_token = orig_push
        fleet_mod.ReplicaManager.remove = orig_remove
        fleet_mod.ReplicaManager._on_crash = orig_on_crash
        fleet_mod.ReplicaManager._apply_flip = orig_flip
        if gw is not None:
            gw.close()   # closes the fleet: every replica's memory freed
        plain.close()
        plain._free_device()
        shutil.rmtree(pub_dir, ignore_errors=True)


def worker_model(seed: int = 0, device=None, **config):
    """The worker phase's model factory, imported by every worker process
    as ``chip_smoke:worker_model``: the GPT of ``config`` drawn by
    ``build_gpt`` on the CPU from ``seed`` (so each process holds the same
    weights), then int8 weight-only as the serve phases'."""
    from paddle_tpu_torch.quantization import quantize_for_serving
    from paddle_tpu_torch.serving.worker import build_gpt
    return quantize_for_serving(build_gpt(seed, device=device, **config))


def _program_launches(eng) -> dict:
    """K3 / K4 launches each of ``eng``'s captured programs records, by the
    program's name as a worker reports its replays."""
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import paged_attention as pa
    names = {id(pa.paged_attention): "paged_attention",
             id(im.dequant_matmul): "dequant_matmul"}
    out = {}
    for name, prog in eng._programs.items():
        c = dict.fromkeys(names.values(), 0)
        for (owner, _key), n in prog.launches:
            if id(owner) in names:
                c[names[id(owner)]] += n
        out[str(name)] = c
    return out


def _worker_launches(tag, rid, before: dict, after: dict,
                     counts: dict) -> dict:
    """A worker's K3 / K4 launches between two of its process reports;
    they must be > 0 and equal its programs' replays in between times the
    launches each program's graph records (``counts``)."""
    got = {k: after["launches"][k] - before["launches"][k]
           for k in ("paged_attention", "dequant_matmul")}
    exp = dict.fromkeys(got, 0)
    for name, n in after["replays"].items():
        for k in exp:
            exp[k] += (n - before["replays"].get(name, 0)) * counts[name][k]
    if got != exp or min(got.values()) <= 0:
        fail(f"{tag}: worker {rid} launched {got}, its replays make {exp}")
    return got


def _log_tail(path, lines: int = 40) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return "(no log)"


def worker_phase(torch, args, dev, card, inproc=None):
    """Serving replicas in processes of their own (``serving/worker.py``):
    the fleet phase's engine options (int8 GPT-2 medium, paged, 8 slots,
    max_len 1024, decode_chunk 4) in two ``python -m
    paddle_tpu_torch.serving.worker`` processes behind a FleetRouter driven
    on this thread, each worker building its model by ``chip_smoke:
    worker_model`` (the same seeded CPU draw as this process's oracle
    engine, captured here) and capturing its graphs in its own CUDA
    context.  Boot seconds from spawn to ready.  (1) The fleet phase's 16
    requests (12 greedy with resubmit, 4 keyed-sampled): streams equal the
    oracle's (greedy may split at a near tie), each worker's K3 / K4
    launches over the wave (read from the worker process) > 0 and equal to
    its programs' replays times their recorded counts (4 x layers K3 and
    16 x layers K4 per decode replay), nothing captured after warmup;
    tokens/s against the oracle engine and the fleet phase's in-process
    pair.  (2) The same wave, one worker SIGKILLed once every stream holds
    8 tokens: its greedy runs finish on the peer (ms from the kill to the
    first resubmitted token), its sampled runs end in ReplicaLostError,
    exactly one fence; the supervised restart (seconds from the kill to
    ready) serves equal streams.  (3) ``replica_wedge`` armed over the
    wire on the other worker with a run resident: the fence latency
    against ``WORKER_HEARTBEAT_S``, the run finished on the peer, the
    wedged process killed after the grace.  (4) A standalone ``--listen
    127.0.0.1:0`` worker attached with the oracle's ``jit.save`` int8
    artifact shipped in checked chunks (its factory seed differs): ship
    and attach seconds, equal streams; then a flip by path to a second
    seed's artifact (ms against the fleet phase's in-process flip), its
    streams equal the oracle's after the same swap, nothing captured."""
    import inspect
    import os
    import shutil
    import signal

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.models import GPTConfig, gpt2_medium_config
    from paddle_tpu_torch.serving import (FleetRouter, ReplicaLostError,
                                          Response, RestartBackoff)
    from paddle_tpu_torch.serving import fleet as fleet_mod
    from paddle_tpu_torch.serving import worker as worker_mod
    from paddle_tpu_torch.serving.transfer import file_sha256
    tag = "worker"
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    config = {k: getattr(cfg, k)
              for k in inspect.signature(GPTConfig.__init__).parameters
              if k != "self"}
    layers = cfg.num_hidden_layers

    def spec(seed, weights=None):
        out = {"model": {"factory": "chip_smoke:worker_model",
                         "kwargs": dict(config, seed=seed)},
               "engine": dict(max_slots=SLOTS, max_len=MAX_LEN, kv="paged",
                              block_size=BLOCK, decode_chunk=4,
                              device=str(dev))}
        if weights is not None:
            out["weights"] = weights
        return out

    model = worker_model(args.seed, device=dev, **config)
    rng = np.random.RandomState(args.seed + 21)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in FLEET_LENS]
    knobs = [dict(decode_strategy="sampling", temperature=0.8, top_k=40,
                  top_p=0.9, seed=40 + i) if i in FLEET_SAMPLED
             else {"resubmit": True} for i in range(len(prompts))]
    sampled = set(FLEET_SAMPLED)
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    check = greedy[:WORKER_CHECK]
    plain = _paged_engine(model, dev, decode_chunk=4)
    counts = _program_launches(plain)
    if counts["decode"] != {"paged_attention": 4 * layers,
                            "dequant_matmul": 16 * layers}:
        fail(f"{tag}: the decode graph records {counts['decode']}")

    def plain_run(idx, new=FLEET_NEW):
        t0 = time.perf_counter()
        resps = [plain.submit(prompts[i], max_new_tokens=new,
                              **{k: v for k, v in knobs[i].items()
                                 if k != "resubmit"}) for i in idx]
        plain.run_until_drained(timeout=600)
        torch.cuda.synchronize()
        return [r.tokens(timeout=5) for r in resps], time.perf_counter() - t0

    want, plain_wall = plain_run(range(len(prompts)))
    fleet = FleetRouter([], heartbeat_timeout_s=WORKER_HEARTBEAT_S,
                        kill_grace_s=WORKER_GRACE_S,
                        restart_backoff=RestartBackoff(max_restarts=1,
                                                       base_delay=0.1,
                                                       max_delay=0.5))

    def drive(pred, timeout, what):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                fail(f"{tag}: timed out after {timeout} s waiting for "
                     f"{what}")
            if not fleet.step():
                time.sleep(0.0002)

    def healthy(rid):
        rep = fleet.manager.get(rid)
        if rep is not None and rep.state in ("crashed", "wedged"):
            fail(f"{tag}: worker {rid} {rep.state}: {rep.fence_reason}")
        return rep is not None and rep.state == "healthy"

    def process(rid):
        return fleet.manager.get(rid).engine.metrics(fresh=True)

    def served(client, idx, what, model_=model, want_=None):
        resps = []
        for i in idx:
            req, resp = client.make_request(prompts[i], FLEET_NEW)
            client.scheduler.submit(req, resp)
            resps.append(resp)
        drive(lambda: all(r.done() for r in resps), 600, what)
        got = [r.tokens_so_far() for r in resps]
        if any(r.error is not None for r in resps):
            fail(f"{tag} {what}: {[repr(r.error) for r in resps]}")
        return _splits(torch, model_, dev, [prompts[i] for i in idx], got,
                       want_ or [want[i] for i in idx], f"{tag} {what}")

    times = {}
    orig_push = Response._push_token

    def timed_push(self, tok, logp=0.0):
        times.setdefault(id(self), []).append(time.monotonic())
        orig_push(self, tok, logp)
    Response._push_token = timed_push
    crash_at = {}
    orig_on_crash = fleet_mod.ReplicaManager._on_crash

    def on_crash(self, rep, exc):
        crash_at.setdefault("t", time.monotonic())
        crash_at["exc"] = exc
        orig_on_crash(self, rep, exc)
    fleet_mod.ReplicaManager._on_crash = on_crash
    ship = []
    orig_ship = worker_mod.RemoteWorkerClient._ship_artifacts

    def timed_ship(self, *a):
        t = time.perf_counter()
        orig_ship(self, *a)
        ship.append((time.perf_counter() - t, self.bytes_shipped))
    worker_mod.RemoteWorkerClient._ship_artifacts = timed_ship
    art = _build_dir("worker_artifacts")
    listener = listen_log = None
    # the remote leg's artifacts first: the workers' frames queue up while
    # this thread does anything but drive the fleet, and a worker blocked
    # on a full socket stops beating
    path0, path1 = os.path.join(art, "w0"), os.path.join(art, "w1")
    jit.save(model, path0)
    new_model = worker_model(args.seed + 1, device=dev, **config)
    jit.save(new_model, path1)
    w0, w1 = path0 + ".pdiparams.npz", path1 + ".pdiparams.npz"
    try:
        # boot two workers at once
        t_spawn = time.monotonic()
        ids = [fleet.add_worker(spec(args.seed), boot_timeout_s=WORKER_BOOT_S)
               for _ in range(2)]
        boot_s = {}

        def booted():
            for rid in ids:
                if rid not in boot_s and healthy(rid):
                    boot_s[rid] = time.monotonic() - t_spawn
            return len(boot_s) == len(ids)
        drive(booted, WORKER_BOOT_S, "two worker boots")
        pids = {rid: fleet.manager.get(rid).engine.pid for rid in ids}
        print(f"{tag} [{card}]: two worker processes {sorted(pids.values())}"
              f" ready {[round(boot_s[r], 2) for r in ids]} s after their "
              f"spawn (import, seeded CPU draw, int8, capture; the kernels "
              f"built by this process)")
        placed = {}
        for rid in ids:
            sched = fleet.manager.get(rid).engine.scheduler

            def submit(req, resp, *a, _orig=sched.submit, _rid=rid, **kw):
                _orig(req, resp, *a, **kw)
                placed[id(resp)] = _rid
            sched.submit = submit
        for rid in ids:
            proc = process(rid)["process"]
            if proc["modules"] != {"jax": False, "paddle_tpu": False} or \
                    proc["device"] != str(dev):
                fail(f"{tag}: worker {rid} reports {proc}")

        # (1) the clean wave
        before = {rid: process(rid)["process"] for rid in ids}
        t0 = time.perf_counter()
        clean = [fleet.submit(p, FLEET_NEW, **knobs[i])
                 for i, p in enumerate(prompts)]
        drive(lambda: all(r.done() for r in clean), 600, "the clean wave")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(r.error is not None for r in clean):
            fail(f"{tag}: clean-wave errors "
                 f"{[repr(r.error) for r in clean if r.error]}")
        splits = _splits(torch, model, dev, prompts,
                         [r.tokens_so_far() for r in clean], want,
                         f"{tag} clean", sampled=sampled)
        per = {}
        for rid in ids:
            m = process(rid)
            per[rid] = _worker_launches(tag, rid, before[rid], m["process"],
                                        counts)
            if m["post_warmup_compiles"] != 0:
                fail(f"{tag}: worker {rid} captured after warmup")
        tps = len(prompts) * FLEET_NEW / wall
        ref = ("not run" if inproc is None else
               f"{inproc['tokens_per_s']:.1f}")
        print(f"{tag} [{card}]: 2 worker processes, {len(prompts)} requests"
              f", {len(prompts) * FLEET_NEW} tokens in {wall:.3f}s: "
              f"{tps:.1f} tokens/s against one engine's "
              f"{len(prompts) * FLEET_NEW / plain_wall:.1f} (this process, "
              f"the same 16) and the fleet phase's in-process pair's {ref}; "
              f"placed {sorted(placed[id(r)] for r in clean)}; K3 / K4 "
              f"launches per worker over the wave {per} (= replays x "
              f"{counts['decode']} per decode replay, "
              f"{counts[str(plain.buckets[0])]} per prefill); splits "
              f"{splits}")

        # (2) a worker SIGKILLed mid-decode, then its supervised restart
        crash = [fleet.submit(p, FLEET_NEW, **knobs[i])
                 for i, p in enumerate(prompts)]
        drive(lambda: min(len(r.tokens_so_far()) for r in crash) >= 8, 120,
              "the kill wave at 8 tokens")
        victim = fleet.manager.get(ids[1])
        t_kill = time.monotonic()
        os.kill(victim.engine.pid, signal.SIGKILL)
        drive(lambda: all(r.done() for r in crash), 600, "the kill wave")
        c = fleet.manager.counters()
        if c["failovers"] != 1 or victim.state != "crashed":
            fail(f"{tag} kill: {c['failovers']} fences, the victim "
                 f"{victim.state} ({crash_at.get('exc')!r})")
        lost, resub = [], []
        for i, r in enumerate(crash):
            on_victim = placed[id(r)] == ids[1]
            if i in sampled and on_victim:
                if not isinstance(r.error, ReplicaLostError):
                    fail(f"{tag} kill: sampled request {i} ended "
                         f"{r.error!r}")
                lost.append(i)
            elif r.error is not None:
                fail(f"{tag} kill: request {i} failed: {r.error!r}")
            elif on_victim:
                resub.append(i)
        keep = [i for i in range(len(prompts)) if i not in lost]
        splits = _splits(torch, model, dev, [prompts[i] for i in keep],
                         [crash[i].tokens_so_far() for i in keep],
                         [want[i] for i in keep], f"{tag} kill",
                         sampled={k for k, i in enumerate(keep)
                                  if i in sampled})
        first = min(t for i in resub for t in times[id(crash[i])]
                    if t > t_kill)

        def restarted():
            return next((r for r in fleet.manager.replicas()
                         if r.id not in ids and r.kind == "subprocess"
                         and r.state == "healthy"), None)
        drive(lambda: restarted() is not None, WORKER_BOOT_S,
              "the supervised restart")
        restart_s = time.monotonic() - t_kill
        new = restarted()
        rsplits = served(new.engine, check, "restart")
        print(f"{tag} kill [{card}]: worker {ids[1]} SIGKILLed at 8+ tokens;"
              f" fenced {(crash_at['t'] - t_kill) * 1e3:.1f} ms after the "
              f"kill; {c['resubmits']} greedy runs resubmitted ({resub}), "
              f"{len(lost)} sampled lost ({lost}, ReplicaLostError); first "
              f"resubmitted token {(first - t_kill) * 1e3:.1f} ms after the "
              f"kill; splits {splits}; the supervised restart ready "
              f"{restart_s:.2f}s after the kill, {len(check)} streams "
              f"equal but {rsplits}")

        # (3) a wedge on the other worker
        a = fleet.manager.get(ids[0])
        req, resp = a.engine.make_request(prompts[check[0]], FLEET_NEW,
                                          resubmit=True)
        a.engine.scheduler.submit(req, resp)
        drive(lambda: len(resp.tokens_so_far()) >= 1, 120,
              "a run resident on the wedge's worker")
        a.engine.set_fault("replica_wedge", f"{a.lineage['index']}:0")
        t_arm = time.monotonic()
        drive(lambda: a.state == "wedged", 60, "the wedge fence")
        fence_s = time.monotonic() - t_arm
        drive(resp.done, 600, "the wedged worker's run on its peer")
        if resp.error is not None or resp.tokens_so_far() != want[check[0]]:
            _splits(torch, model, dev, [prompts[check[0]]],
                    [resp.tokens_so_far()], [want[check[0]]], f"{tag} wedge")
        drive(lambda: a.engine.proc.poll() is not None,
              WORKER_GRACE_S + 30, "the wedged worker's kill")
        killed_s = time.monotonic() - t_arm
        print(f"{tag} wedge [{card}]: fenced {fence_s:.3f}s after the wedge "
              f"was armed (heartbeat_timeout_s {WORKER_HEARTBEAT_S}: "
              f"{a.fence_reason}); its run finished on the peer; killed "
              f"{killed_s:.3f}s after the arming (grace {WORKER_GRACE_S} s)")

        # (4) a remote worker: shipped weights, then a flip by path
        env = dict(os.environ)
        root = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = (root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else root)
        listen_log = os.path.join(art, "listen.log")
        index = fleet.manager._next_id
        with open(listen_log, "w") as log:
            listener = subprocess.Popen(
                [sys.executable, "-m", "paddle_tpu_torch.serving.worker",
                 "--listen", "127.0.0.1:0", "--index", str(index)],
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, env=env, start_new_session=True)
        addr, deadline = None, time.monotonic() + 120
        while addr is None:
            for line in _log_tail(listen_log, 5).splitlines():
                if "worker listening on" in line:
                    addr = line.strip().rsplit(" ", 1)[-1]
            if addr is None:
                if listener.poll() is not None or \
                        time.monotonic() > deadline:
                    fail(f"{tag} remote: no listening worker:\n"
                         f"{_log_tail(listen_log)}")
                time.sleep(0.05)
        t_att = time.monotonic()
        rid = fleet.add_worker(spec(args.seed + 7, weights=w0), address=addr,
                               boot_timeout_s=WORKER_BOOT_S)
        drive(lambda: healthy(rid), WORKER_BOOT_S, "the remote attach")
        attach_s = time.monotonic() - t_att
        remote = fleet.manager.get(rid).engine
        if remote.weights_sha != file_sha256(w0) or not ship:
            fail(f"{tag} remote: served sha {remote.weights_sha}")
        asplits = served(remote, check, "remote")
        with np.load(w1, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
        sha1 = file_sha256(w1)
        t = time.perf_counter()
        entry = fleet.flip_weights(rid, path=w1, sha=sha1)
        drive(lambda: entry["done"], 600, "the flip")
        flip_ms = (time.perf_counter() - t) * 1e3
        if not entry["ok"] or remote.weights_sha != sha1:
            fail(f"{tag} flip: {entry}")
        plain.swap_weights(state, sha1)
        want_new, _ = plain_run(check)
        fsplits = served(remote, check, "flip", model_=new_model,
                         want_=want_new)
        if process(rid)["post_warmup_compiles"] != 0:
            fail(f"{tag} flip: the remote worker captured after warmup")
        inproc_flip = ("not run" if inproc is None
                       else f"{inproc['flip_ms']:.1f}")
        print(f"{tag} remote [{card}]: --listen worker attached in "
              f"{attach_s:.2f}s, {ship[-1][1] / 2**30:.3f} GiB of int8 "
              f"weights shipped in {ship[-1][0]:.2f}s in checked chunks; "
              f"{len(check)} streams equal the oracle's but {asplits}; flip "
              f"by path {flip_ms:.1f} ms (the fleet phase's in-process flip "
              f"{inproc_flip} ms), {len(check)} streams equal the swapped "
              f"oracle's but {fsplits}; nothing captured after warmup")
    except BaseException:
        print(f"{tag}: the last fence's cause: {crash_at.get('exc')!r}",
              file=sys.stderr)
        for rep in fleet.manager.replicas():
            print(f"{tag}: replica {rep.id} ({rep.kind}) {rep.state}: "
                  f"{rep.fence_reason}", file=sys.stderr)
            path = getattr(rep.engine, "log_path", None)
            if path and not path.startswith("<"):
                print(f"{tag}: log of worker {rep.id}:\n"
                      f"{_log_tail(path)}", file=sys.stderr)
        if listen_log is not None:
            print(f"{tag}: log of the listening worker:\n"
                  f"{_log_tail(listen_log)}", file=sys.stderr)
        raise
    finally:
        Response._push_token = orig_push
        fleet_mod.ReplicaManager._on_crash = orig_on_crash
        worker_mod.RemoteWorkerClient._ship_artifacts = orig_ship
        fleet.close()
        if listener is not None:
            listener.kill()
            listener.wait(timeout=30)
        plain.close()
        plain._free_device()
        shutil.rmtree(art, ignore_errors=True)


PROGRAMS_LENS = (32, 100, 220, 400)   # programs phase: 3 greedy + 1 sampled
PROGRAMS_NEW = 32


def programs_phase(torch, args, dev, card):
    """Program sets (``programs/``): save one from a warm engine of the
    worker phase's options, boot a worker process from it under an empty
    store (no nvcc: misses 0, read from the process; streams equal the
    saving engine's; K3 / K4 launches = replays x recorded counts), boot
    the same worker without it under another empty store, and refuse a
    set with one flipped byte (engine: ProgramSetError; predictor: the
    counted fallback)."""
    import inspect
    import os
    import shutil

    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import GPTConfig, gpt2_medium_config
    from paddle_tpu_torch.observability import metrics as obs_metrics
    from paddle_tpu_torch.programs import ProgramSetError, read_manifest
    from paddle_tpu_torch.serving import FleetRouter, ServingEngine
    tag = "programs"
    t_phase = time.perf_counter()
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    config = {k: getattr(cfg, k)
              for k in inspect.signature(GPTConfig.__init__).parameters
              if k != "self"}
    layers = cfg.num_hidden_layers
    engine_kw = dict(max_slots=SLOTS, max_len=MAX_LEN, kv="paged",
                     block_size=BLOCK, decode_chunk=4)
    spec = {"model": {"factory": "chip_smoke:worker_model",
                      "kwargs": dict(config, seed=args.seed)},
            "engine": dict(engine_kw, device=str(dev))}
    model = worker_model(args.seed, device=dev, **config)
    rng = np.random.RandomState(args.seed + 31)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)) for n in PROGRAMS_LENS]
    knobs = [dict(decode_strategy="sampling", temperature=0.8, top_k=40,
                  top_p=0.9, seed=7) if i == 3 else {}
             for i in range(len(prompts))]
    art = _build_dir("programs_phase")
    saver = _paged_engine(model, dev, decode_chunk=4)
    counts = _program_launches(saver)
    if counts["decode"] != {"paged_attention": 4 * layers,
                            "dequant_matmul": 16 * layers}:
        fail(f"{tag}: the decode graph records {counts['decode']}")
    t = time.perf_counter()
    path = saver.save_program_set(os.path.join(art, "gpt2m"))
    save_s = time.perf_counter() - t
    man = read_manifest(path)
    resps = [saver.submit(p, PROGRAMS_NEW, **knobs[i])
             for i, p in enumerate(prompts)]
    saver.run_until_drained(timeout=600)
    want = [r.tokens(timeout=5) for r in resps]
    print(f"{tag} [{card}]: set of {len(man['programs'])} programs and "
          f"libraries {sorted(man['libraries'])} saved in {save_s:.2f}s, "
          f"{os.path.getsize(path) / 2**20:.2f} MiB")
    old_env = os.environ.get("PDTPU_PROGRAM_CACHE_DIR")

    def boot(store, with_set):
        os.environ["PDTPU_PROGRAM_CACHE_DIR"] = os.path.join(art, store)
        fleet = FleetRouter([])
        try:
            t0 = time.monotonic()
            rid = fleet.add_worker(dict(spec, program_set=path) if with_set
                                   else spec, boot_timeout_s=WORKER_BOOT_S)
            deadline = t0 + WORKER_BOOT_S
            while True:
                rep = fleet.manager.get(rid)
                if rep is not None and rep.state in ("crashed", "wedged"):
                    fail(f"{tag}: worker {rep.state}: {rep.fence_reason}\n"
                         f"{_log_tail(rep.engine.log_path)}")
                if rep is not None and rep.state == "healthy":
                    break
                if time.monotonic() > deadline:
                    fail(f"{tag}: the worker did not boot")
                if not fleet.step():
                    time.sleep(0.0002)
            boot_s = time.monotonic() - t0
            client = fleet.manager.get(rid).engine
            before = client.metrics(fresh=True)["process"]
            out = [fleet.submit(p, PROGRAMS_NEW, **knobs[i])
                   for i, p in enumerate(prompts)]
            while not all(r.done() for r in out):
                if not fleet.step():
                    time.sleep(0.0002)
            if any(r.error is not None for r in out):
                fail(f"{tag}: {[repr(r.error) for r in out]}")
            m = client.metrics(fresh=True)
            after = m["process"]
            got = _worker_launches(tag, rid, before, after, counts)
            if m["post_warmup_compiles"] != 0:
                fail(f"{tag}: the worker captured after warmup")
            return boot_s, [r.tokens() for r in out], after, got
        finally:
            fleet.close()

    try:
        set_s, streams, proc, got = boot("store_a", True)
        builds, store = proc["kernel_builds"], proc["program_store"]
        if builds["misses"] != 0 or store["misses"] != 0 or \
                builds["installs"] != len(man["libraries"]):
            fail(f"{tag}: the worker booted from the set built kernels: "
                 f"{builds}, store {store}")
        if set(proc["program_set"]["kinds"].values()) != {"recaptured"}:
            fail(f"{tag}: the worker's set {proc['program_set']}")
        if proc["modules"] != {"jax": False, "paddle_tpu": False}:
            fail(f"{tag}: the worker imported {proc['modules']}")
        splits = _splits(torch, model, dev, prompts, streams, want,
                         f"{tag} set", sampled={3})
        fresh_s, fresh_streams, fproc, _ = boot("store_b", False)
        fresh_splits = _splits(torch, model, dev, prompts, fresh_streams,
                               want, f"{tag} fresh", sampled={3})
        print(f"{tag} [{card}]: worker booted from the set in {set_s:.2f}s "
              f"(store misses {store['misses']}, hits {store['hits']}, "
              f"libraries installed {builds['installs']}), without it in "
              f"{fresh_s:.2f}s (nvcc builds {fproc['kernel_builds']['misses']}"
              f", store misses {fproc['program_store']['misses']}); "
              f"{len(prompts)} streams equal the saving engine's but "
              f"{splits} / {fresh_splits}; K3 / K4 launches {got} = replays "
              f"x (96 / 384 per decode replay)")
    finally:
        if old_env is None:
            os.environ.pop("PDTPU_PROGRAM_CACHE_DIR", None)
        else:
            os.environ["PDTPU_PROGRAM_CACHE_DIR"] = old_env
        saver.close()
        saver._free_device()
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    bad = os.path.join(art, "flipped.pdprograms")
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    try:
        ServingEngine(model, device=dev, program_set=bad, **engine_kw)
        fail(f"{tag}: a set with a flipped byte was taken")
    except ProgramSetError as e:
        refused = str(e)[:80]
    counter = obs_metrics.counter("program_set_fallback_total")
    n0 = counter.value()
    pcfg = Config()
    pcfg.enable_serving(model=model, warmup=False, start=False,
                        program_set=bad, **engine_kw)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pred = create_predictor(pcfg)
    if counter.value() != n0 + 1 or pred.engine.program_set_info is not None:
        fail(f"{tag}: the predictor's fallback was not counted")
    pred.close()
    pred.engine._free_device()
    shutil.rmtree(art, ignore_errors=True)
    print(f"{tag} [{card}]: flipped byte refused ({refused}...), predictor "
          f"fallback counted; phase {time.perf_counter() - t_phase:.2f}s")


def predictor_phase(torch, args, dev, card):
    """The one-shot Predictor over an exported BERT-large sequence
    classifier (bert_large_config(vocab_size=30528,
    max_position_embeddings=512), 2 labels, eval, random weights from
    --seed): jit.save with input_spec [InputSpec([-1, 512], "int64")] * 2
    (ids and the padding mask, the (B, Sk) bias of K1), then
    create_predictor(Config(prefix)) and runs at B 8 with lengths
    128..512.  The logits must lie within LOGIT_TOL of the eager port
    model on the card, the eager model within LOGIT_TOL of its CPU plain
    path (2 rows), and each run must launch K1 24 times (one per layer:
    a run through the plain version counts 0)."""
    from paddle_tpu_torch import jit, nn as tnn
    from paddle_tpu_torch.inference import Config, create_predictor
    from paddle_tpu_torch.models import BertForSequenceClassification
    from paddle_tpu_torch.ops import flash_attention as fa
    tag = "predictor"

    class Classifier(tnn.Layer):
        """BERT-large classifying (ids, padding mask)."""

        def __init__(self, device):
            super().__init__()
            self.model = BertForSequenceClassification(
                _bert_large(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0),
                num_classes=2, device=device, seed=args.seed)

        def forward(self, ids, mask):
            return self.model(ids, attention_mask=mask)

    cls = Classifier(dev).eval()
    layers = cls.model.bert.config.num_hidden_layers
    prefix = _build_dir("predictor") + "/bert_large_cls"
    t0 = time.perf_counter()
    jit.save(cls, prefix, input_spec=[jit.InputSpec([-1, BERT_S], "int64"),
                                      jit.InputSpec([-1, BERT_S], "int64")])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = create_predictor(Config(prefix))
    load_s = time.perf_counter() - t0
    meta = pred._layer._meta
    if meta.get("export_fallback") or meta.get("export_error") \
            or meta["input_spec"][0][0] != (-1, BERT_S):
        fail(f"{tag}: the export degraded: {meta}")
    ids, _, _, mask, _ = _bert_batch(torch, dev, BERT_VOCAB, args.seed + 9,
                                     padded=True)
    ids_np, mask_np = ids.cpu().numpy(), mask.cpu().numpy()

    def run():
        pred.get_input_handle("x0").copy_from_cpu(ids_np)
        pred.get_input_handle("x1").copy_from_cpu(mask_np)
        pred.run()
        return pred.get_output_handle("out0").copy_to_cpu()

    per_run, times = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        fa.flash_fwd.launches = 0
        t = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        per_run.append(fa.flash_fwd.launches)
    if per_run != [layers] * 5:
        fail(f"{tag}: K1 launches per run {per_run} (want {layers})")
    with torch.inference_mode():
        eager = cls(ids, mask)
        eager_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cls(ids, mask)
            torch.cuda.synchronize()
            eager_ms.append(time.perf_counter() - t)
    if out.shape != (BERT_B, 2) or not np.isfinite(out).all():
        fail(f"{tag}: logits {out.shape}, finite {np.isfinite(out).all()}")
    err = float(np.abs(out - eager.float().cpu().numpy()).max())
    cpu = copy.deepcopy(cls).cpu()
    with torch.inference_mode():
        want = cpu(ids[:2].cpu(), mask[:2].cpu()).numpy()
    cpu_err = float(np.abs(eager[:2].float().cpu().numpy() - want).max())
    del cpu
    print(f"{tag} [{card}]: BERT-large classifier, B {BERT_B} x S {BERT_S} "
          f"(lengths {mask_np.sum(1).tolist()}): export {export_s:.2f}s, "
          f"load {load_s:.2f}s; run {np.median(times) * 1e3:.2f} ms "
          f"(host copies in and out included) against the eager module "
          f"{np.median(eager_ms) * 1e3:.2f} ms; K1 launches per run "
          f"{per_run[0]}; |predictor - eager| {err:.3e}, |eager - CPU plain| "
          f"{cpu_err:.3e} (tolerance {LOGIT_TOL})")
    if not err <= LOGIT_TOL or not cpu_err <= LOGIT_TOL:
        fail(f"{tag}: logits disagree ({err:.3e}, {cpu_err:.3e})")
    del pred, cls
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# parallel: the sharded step, the pipelines and ring attention on NCCL
# ---------------------------------------------------------------------------

def _sum_into(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


# NCCL's kernels; on one rank an averaging all-reduce is its oneRankReduce
# kernel (the others copy or do nothing)
PAR_GROUPS = {"nccl (collectives)": ("nccl", "oneRankReduce"),
              "flash (K1 / K2)": ("flash_fwd", "flash_bwd")}


def _one_rank_group(torch, root):
    """A one-rank NCCL process group over a FileStore under ``root``."""
    import torch.distributed as dist
    store = dist.FileStore(os.path.join(root, "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))


def _plain_losses(torch, make, batch, steps, counters):
    """A TrainStep's losses over ``steps`` uncaptured steps (same program
    function, no graph) and its launches: the comparison legs."""
    model, step = make()
    step._run_uncaptured = True
    read = counters()
    losses = [float(step(*batch)) for _ in range(steps)]
    out = losses, read()
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _par_leg(torch, make, batch, steps, counters, card, what, **prof):
    """``train_leg`` on a sharded step, which must be captured."""
    leg = train_leg(torch, make, batch, steps, counters, card,
                    what + ", captured)", **prof)
    if not leg["captured"]:
        fail(f"{what}): the sharded step was not captured")
    return leg


def _rel_check(tag, got, want, tol):
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    print(f"{tag}: losses {', '.join(repr(x) for x in got)} vs "
          f"{', '.join(repr(x) for x in want)}: largest relative {rel:.2e}")
    if not rel <= tol:
        fail(f"{tag}: losses {got} differ from {want} by {rel:.2e} "
             f"(> {tol})")


def _nccl_ms(tag, leg):
    ms = leg["profile"][2].get("nccl (collectives)", 0.0)
    if not ms > 0:
        fail(f"{tag}: no NCCL kernel in the profiled step "
             f"(groups {leg['profile'][2]})")
    return ms


def parallel_gpt_legs(torch, args, dev, card, fa):
    """GPT-2 medium through fleet.distributed_train_step (stage 2, then
    stage 3) against TrainStep(O1, remat); returns (launches, the sharded
    leg's first loss)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion,
                                         gpt2_medium_config)
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    crit = GPTPretrainingCriterion()
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    tokens = TRAIN_B * TRAIN_S

    def counters():
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        return lambda: {"flash_attention_fwd": fa.flash_fwd.launches,
                        "flash_attention_bwd": fa.flash_bwd.launches}

    def model_opt():
        pt.seed(args.seed)
        model = GPTForPretraining(cfg, device=dev, seed=args.seed)
        return model, pt.optimizer.AdamW(learning_rate=1e-4,
                                         parameters=model.parameters())

    def make_plain():
        model, opt = model_opt()
        return model, TrainStep(model, lambda lg, y: crit(lg, y), opt,
                                amp_level="O1", remat=True)

    def make_sharded(stage):
        def make():
            st = parallel.DistributedStrategy(sharding=True, recompute=True,
                                              amp=True)
            st.sharding_configs.stage = stage
            st.amp_configs.level = "O1"
            fleet.init(is_collective=True, strategy=st)
            model, opt = model_opt()
            return model, fleet.distributed_train_step(
                model, lambda lg, y: crit(lg, y),
                fleet.distributed_optimizer(opt))
        return make
    want, plain_n = _plain_losses(torch, make_plain, batch, PARALLEL_STEPS,
                                  counters)
    per_step = {k: v // PARALLEL_STEPS for k, v in plain_n.items()}
    print(f"parallel: TrainStep(O1, remat) losses "
          f"{', '.join(repr(x) for x in want)}; K1 / K2 launches per step "
          f"{per_step}")
    launches = {}
    what = (f"sharded train step (GPT-2 medium, B {TRAIN_B} x S {TRAIN_S}, "
            "O1 bf16, recompute, one-rank NCCL")
    first = None
    for stage, steps in ((2, PARALLEL_STEPS), (3, PARALLEL_FSDP_STEPS)):
        tag = f"parallel gpt stage {stage}"
        leg = _par_leg(torch, make_sharded(stage), batch, steps, counters,
                       card, what + f", ZeRO stage {stage}",
                       groups=PAR_GROUPS)
        _rel_check(tag, leg["losses"], want[:steps], 1e-3)
        got = {k: v // steps for k, v in leg["launches"].items()}
        if got != per_step or any(v % steps for v in
                                  leg["launches"].values()):
            fail(f"{tag}: K1 / K2 launches {leg['launches']} over {steps} "
                 f"steps, TrainStep's {per_step} per step")
        nccl = _nccl_ms(tag, leg)
        print(_leg_line(tag, card, leg, tokens, "tokens"))
        print(f"{tag} [{card}]: {leg['steady_ms']:.2f} ms per step, "
              f"{tokens / leg['steady_ms'] * 1e3:.0f} tokens/s, peak "
              f"{leg['peak_gib']:.2f} GiB, NCCL kernels {nccl:.3f} ms per "
              f"step ({nccl / (leg['profile'][1] or 1):.2%} of device "
              f"time), captured {leg['captured']}")
        _sum_into(launches, leg["launches"])
        first = leg["losses"][0] if first is None else first
        parallel.set_mesh(None)
    return launches, first


def parallel_pipe_legs(torch, args, dev, card, fa, first):
    """The same GPT-2 medium through gpt_pipeline_step on the pp=1 mesh,
    GPipe and 1F1B; returns the launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.models import GPTForPretraining, gpt2_medium_config
    from paddle_tpu_torch.parallel.pipeline import gpt_pipeline_step
    cfg = gpt2_medium_config(hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    ids, labels = (torch.from_numpy(a).to(dev)
                   for a in _train_batch(cfg, args.seed, TRAIN_B, TRAIN_S))
    mesh = parallel.create_mesh({"dp": 1})
    launches, runs = {}, {}
    for sched in ("gpipe", "1f1b"):
        pt.seed(args.seed)
        model = GPTForPretraining(cfg, device=dev, seed=args.seed)
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.parameters())
        step = gpt_pipeline_step(model, opt, mesh, n_micro=4, remat=True,
                                 schedule=sched)
        mem = step.memory_stats(ids, labels)
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(PIPE_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(ids, labels)))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        n = {"flash_attention_fwd": fa.flash_fwd.launches,
             "flash_attention_bwd": fa.flash_bwd.launches}
        if not all(v > 0 for v in n.values()):
            fail(f"parallel {sched}: no K1 / K2 launch ({n})")
        _sum_into(launches, n)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[sched] = (losses, mem["temp_bytes"])
        print(f"parallel {sched} [{card}]: GPT-2 medium f32, n_micro 4, "
              f"remat, pp=1 on NCCL: losses "
              f"{', '.join(repr(x) for x in losses)}; "
              f"{float(np.median(times[1:] or times)):.1f} ms per step "
              f"(first {times[0]:.1f} ms), peak {peak:.2f} GiB, temp_bytes "
              f"{mem['temp_bytes'] / 2 ** 30:.3f} GiB; launches {n}")
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    _rel_check("parallel 1f1b vs gpipe", runs["1f1b"][0], runs["gpipe"][0],
               1e-3)
    _rel_check("parallel gpipe vs the sharded leg's first loss",
               runs["gpipe"][0][:1], [first], 1e-3)
    if not runs["1f1b"][1] < runs["gpipe"][1]:
        fail(f"parallel: 1F1B temp_bytes {runs['1f1b'][1]} not below "
             f"GPipe's {runs['gpipe'][1]}")
    return launches


def parallel_resnet_leg(torch, args, dev, card):
    """ResNet-50 through ShardedTrainStep on the one-rank NCCL mesh;
    returns the K5-K9 launches."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.jit import TrainStep, layout_policy
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import fused_bn_act as fbn
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    def loss(lg, y):
        return F.cross_entropy(lg, y)

    def model_opt():
        pt.seed(args.seed)
        model = resnet50(device=dev, seed=args.seed)
        return model, Momentum(learning_rate=0.1, momentum=0.9,
                               parameters=model.parameters())

    def make_plain():
        model, opt = model_opt()
        return model, TrainStep(model, loss, opt, amp_level="O2",
                                amp_dtype="bfloat16")

    def make_sharded():
        model, opt = model_opt()
        st = parallel.DistributedStrategy(amp=True)
        st.amp_configs.level = "O2"
        return model, parallel.ShardedTrainStep(
            model, loss, opt, strategy=st,
            mesh=parallel.create_mesh({"dp": 1}))
    base = bn_counters(fbn)

    def counters():
        read = base()
        fbn.stats_group.all_reduces = 0
        return lambda: dict(read(), stats=fbn.stats_group.all_reduces)
    with layout_policy("NHWC"):
        model = resnet50(device=dev, seed=args.seed)
        per_step = bn_launches_per_step(model)
        single, dual, pooled = bn_sites(model)
        del model
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        x = torch.randn(RESNET_B, 3, RESNET_HW, RESNET_HW, generator=gen,
                        device=dev)
        y = torch.randint(0, 1000, (RESNET_B,), generator=gen, device=dev)
        want, _ = _plain_losses(torch, make_plain, (x, y), 1, base)
        leg = _par_leg(torch, make_sharded, (x, y), PAR_RESNET_STEPS,
                       counters, card,
                       f"sharded train step (ResNet-50, b{RESNET_B} x "
                       f"{RESNET_HW}^2, O2 bf16, NHWC, one-rank NCCL",
                       groups=dict(PAR_GROUPS, **bn_groups()), top=14)
    tag = "parallel resnet"
    _rel_check(tag + " first loss vs TrainStep", leg["losses"][:1], want,
               2e-2)
    got = {n: leg["launches"][n] for n in BN_KERNELS}
    expect = {k: v * PAR_RESNET_STEPS for k, v in per_step.items()}
    if got != expect:
        fail(f"{tag}: K5-K9 launches {got}, TrainStep's {expect} "
             f"({per_step} per step)")
    sites = single + dual + pooled
    stats = leg["launches"]["stats"]
    if stats != 2 * sites * PAR_RESNET_STEPS:
        fail(f"{tag}: {stats} statistics all-reduces over "
             f"{PAR_RESNET_STEPS} steps, expected two per fused site "
             f"({sites} sites)")
    nccl = _nccl_ms(tag, leg)
    print(_leg_line(tag, card, leg, RESNET_B, "images"))
    print(f"{tag} [{card}]: {leg['steady_ms']:.2f} ms per step, "
          f"{RESNET_B / leg['steady_ms'] * 1e3:.0f} images/s, peak "
          f"{leg['peak_gib']:.2f} GiB, NCCL kernels {nccl:.3f} ms per step, "
          f"statistics all-reduces per step {stats // PAR_RESNET_STEPS} "
          f"({sites} fused sites), K5-K9 per step {per_step}, captured "
          f"{leg['captured']}")
    return got


def parallel_ring_check(torch, dev, card):
    """ring_attention on the sp=1 mesh against the naive softmax."""
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    mesh = parallel.create_mesh({"dp": 1})
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, h, d = RING_SHAPE
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
               for _ in range(3))

    def naive(q, k, v, causal):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sc = qt @ kt.transpose(-1, -2) / d ** 0.5
        if causal:
            sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool,
                                            device=dev).tril(), -1e30)
        return (torch.softmax(sc, -1) @ vt).transpose(1, 2)
    g = torch.randn(b, s, h, d, generator=gen, device=dev)
    for causal in (False, True):
        errs = []
        outs = []
        for fn in (lambda *t: ring_attention(*t, mesh, causal=causal),
                   lambda *t: naive(*t, causal)):
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*ins)
            out.backward(g)
            outs.append([out.detach()] + [t.grad for t in ins])
        for got, want in zip(*outs):
            errs.append(float((got - want).abs().max()
                              / want.abs().max().clamp_min(1e-30)))
        print(f"parallel ring [{card}]: {RING_SHAPE} f32 causal={causal}: "
              "largest error relative to |max| of out, dq, dk, dv: "
              + ", ".join(f"{e:.2e}" for e in errs))
        if not max(errs) <= 2e-4:
            fail(f"ring attention (causal={causal}) off by {errs}")


def parallel_phase(torch, args, dev, card):
    """The parallel paths on a one-rank NCCL group (module docstring,
    phase 23).  Returns the K1 / K2 and K5-K9 launches of its legs."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="nccl-store-", dir=_build_dir("parallel"))
    _one_rank_group(torch, root)
    launches = {}
    try:
        parallel.set_mesh(parallel.create_mesh({"dp": 1}))
        got, first = parallel_gpt_legs(torch, args, dev, card, fa)
        _sum_into(launches, got)
        _sum_into(launches, parallel_pipe_legs(torch, args, dev, card,
                                                   fa, first))
        _sum_into(launches, parallel_resnet_leg(torch, args, dev, card))
        parallel_ring_check(torch, dev, card)
    finally:
        parallel.set_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    print(f"parallel [{card}]: phase {time.perf_counter() - t0:.1f} s")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", "--only", default=None,
                    help="comma-separated phases to run alone (development;"
                         " prints no result line): " + ", ".join(PHASES))
    args = ap.parse_args()
    only = set(args.phases.split(",")) if args.phases else None
    if only and not only <= set(PHASES):
        fail(f"unknown phases {sorted(only - set(PHASES))}")

    def want(name):
        return only is None or name in only
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    if "jax" in sys.modules:
        fail("the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    rep = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f}s "
          f"({len(rep['logs'])} compiled now)")
    for name, log in rep["logs"].items():
        kern = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kern = " " + _kernel_name(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"build {name}{kern}: {line.strip()}")
    rng = np.random.RandomState(args.seed)
    kernels, launches = [], {}
    if want("check"):
        kernels += paged_phase(torch, rng, dev) + int8_phase(torch, rng, dev)
    torch.cuda.empty_cache()
    serve_f32 = ("serve", "telemetry", "pressure", "prefix", "spec", "lora",
                 "beam")
    if any(want(p) for p in serve_f32):
        model = serve_model(torch, args, dev)
        if want("serve"):
            launches.update(serve_phase(torch, args, dev, card, model))
        for name, phase in (("telemetry", telemetry_phase),
                            ("pressure", pressure_phase),
                            ("prefix", prefix_phase), ("spec", spec_phase),
                            ("lora", lora_phase), ("beam", beam_phase)):
            if want(name):
                phase(torch, args, dev, card, model)
        del model
    torch.cuda.empty_cache()
    if want("gateway"):
        gateway_phase(torch, args, dev, card)
    torch.cuda.empty_cache()
    inproc = None
    if want("fleet"):
        inproc = fleet_phase(torch, args, dev, card)
        gc.collect()   # the phase's engines and their patched methods cycle
    torch.cuda.empty_cache()
    if want("worker"):
        worker_phase(torch, args, dev, card, inproc)
        gc.collect()
    torch.cuda.empty_cache()
    if want("programs"):
        programs_phase(torch, args, dev, card)
        gc.collect()
    if want("serve_bf16") or want("spec_bf16"):
        model = serve_model(torch, args, dev, torch.bfloat16)
        if want("serve_bf16"):
            launches.update(serve_phase(torch, args, dev, card, model,
                                        torch.bfloat16))
        if want("spec_bf16"):
            spec_bf16_phase(torch, args, dev, card, model)
        del model
    torch.cuda.empty_cache()
    if want("serve_f16"):
        serve_f16_phase(torch, args, dev, card)
    torch.cuda.empty_cache()
    if want("fixed"):
        fixed_phase(torch, args, dev)
    torch.cuda.empty_cache()
    if want("flash"):
        kernels += flash_phase(torch, rng, dev)
    if want("train"):
        launches.update(train_phase(torch, args, dev, card))
    if want("traincheck"):
        train_check_phase(torch, args, dev)
    torch.cuda.empty_cache()
    for name, phase in (("dlrm", dlrm_phase),
                        ("trainexport", trainexport_phase),
                        ("tostatic", tostatic_phase)):
        if want(name):
            phase(torch, args, dev, card)
            gc.collect()
            torch.cuda.empty_cache()
    guard_ms = None
    if want("guard"):
        guard_ms = guard_phase(torch, args, dev, card)
    torch.cuda.empty_cache()
    if want("amp16"):
        amp16_phase(torch, args, dev, card, guard_ms)
    torch.cuda.empty_cache()
    if want("bert"):
        bert_phase(torch, args, dev, card)
    torch.cuda.empty_cache()
    if want("predictor"):
        predictor_phase(torch, args, dev, card)
    torch.cuda.empty_cache()
    if want("bn"):
        kernels += bn_phase(torch, args, dev)
    if want("resnet"):
        launches.update(resnet_phase(torch, args, dev, card))
    if want("resnetcheck"):
        resnet_check_phase(torch, args, dev)
    for name, phase in (("mobilenet", mobilenet_phase), ("vgg", vgg_phase)):
        if want(name):   # K5-K9's launches add up over the conv nets
            for k, v in phase(torch, args, dev, card).items():
                launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    if want("convcheck"):
        conv_check_phase(torch, args, dev)
    for name, phase in (("lenet", lenet_phase), ("qat", qat_phase)):
        if want(name):
            phase(torch, args, dev, card)
            gc.collect()
            torch.cuda.empty_cache()
    if want("parallel"):   # K1 / K2 and K5-K9 on the parallel paths too
        for k, v in parallel_phase(torch, args, dev, card).items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    if any(m.startswith("paddle_tpu.") or m in ("jax", "paddle_tpu")
           for m in sys.modules):
        fail("the JAX package was imported")
    if only is not None:
        print(f"partial run: phases {sorted(only)} passed; no result line")
        return
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "call_ms"]
    print(card)
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
