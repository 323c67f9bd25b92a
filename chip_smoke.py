"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line of output each (the decode phase prints a few), in
order; any failure raises and the script exits non-zero without printing
a result:

  1. build    - compile every CUDA kernel of the port from the sources in
                this checkout (nvcc, one process per source, in parallel);
                prints build seconds and ptxas register/shared-memory use,
                and a line for each D 256 instantiation of the
                tensor-core flash forward, dq and dk/dv (registers,
                stack, spills, which must be none, and dynamic shared
                memory, at most the 232,448 bytes a block may opt in to).
  2. kernels  - each kernel against its plain PyTorch version on the card.
                cim_mbiw: torch.equal over the precision grid, both beta
                shapes, both ADC modes, ragged shapes, the LeNet tiles at
                batch 256, the edges of its three routes (M {1,4,63,64,
                65,129} x N {10,16,33,64,128,256} x K {37,48,144,1040} x
                one and two planes; each call on the route route_for
                names, by the route counters) and an FMA canary (inputs
                where a fused multiply-add would move codes) through the
                tensor-core route.  ring_decode: within
                rtol = atol = 1e-5 over R {1,3,4,8} x H {1,16} x hd
                {12,128,130,256} x L {1,37,129,300,2048} (below, across
                and on the edges of its 128-slot chunks) with ragged
                valid-slot counts, the valid slots first or (L > 128)
                only in the last chunk, on strided views of a
                decode-state slab, and each row of an R-row call bit for
                bit equal to a one-row call.  flash forward, dq and
                dk/dv: within rtol = atol = 2e-5 (forward) and 5e-5
                (backward, float32 outputs) from float32 and bfloat16
                inputs, except the bfloat16 forward output, which may sit
                one bf16 ulp away (rtol 2^-7, atol 2e-5), over causal /
                non-causal x window {0, 256} x rep {1, 2, 16} x D {64,
                128}, ragged Sq and Sk in {1, 77, 512, 4096}, q_off {0,
                100}, the train shape, the dense configs' step shapes
                (phase 12: S 512, D 128, reps 4, 3 and 7, the last in
                float32), the moe phase's (phase 13: reps 4, 6 and 8 at
                S 512, 512 with mixtral's window 4096, and 768), and
                long flat bf16 rows (q x 0.01,
                S 4096); each backward run twice, bit for bit equal; every
                bf16 case at D 64 or 128 through the tensor-core forward,
                dq and dk/dv kernels (their `.launches_tc` rise; the
                per-kernel table FLASH_TC_HEAD_DIMS).  Peaked
                bf16 rows (q and k x 8, D 128), where float32 itself
                misses these limits, are held to float64 within the
                limits plus the plain version's own float32 distance.
                threefry_normal: torch.equal over streams {1, 3, 1568} x
                n {1, 3, 5, 127, 128, 129, 2048, 2^22, 6,144,000} (at
                most 2^24 normals a case), keys from key, fold_in (an id
                above 2^31) and split, and equal to the host's plain draw
                where that is at most 2^22 normals; one launch a call;
                normal_of_bits (the draw's float chain) equal to the
                plain one on all 2^23 bit patterns a normal comes from.
  3. lenet    - the first main path: LeNet (28x28x1 -> conv16 -> pool ->
                conv32 -> pool -> fc 1568->128 -> fc 128->10) served at full
                width through compile_program(...).bind(...).serve at
                (r_in, r_w) (4, 2) and (8, 4), weights from a seeded
                torch.Generator, images from pseudo-MNIST; logits equal the
                reference on the card and the port's CPU run bit for bit,
                serve_batch equals serve of the concatenation, and the
                kernel ran once per planned macro tile, each tile on the
                route route_for names for it (conv1 on the CUDA cores,
                the K >= 32 tiles on the tensor cores).  Every clean
                serve runs the bound program's CUDA graph for its
                dispatch key (captured on the key's first call, whose
                launches are its eager warm-up's): a replay equals
                engine._forward run eagerly (`eager_forward`) at every
                rung visited (256, 128, 1, 8) and for the isolated
                serve_batch (segments), each isolated request equals its
                solo serve, and 20 timed serves are 20 replays with no
                capture that add 20 x the planned tiles to each route's
                counter.  Median latency and images/s at 256, with graphs
                and with eager_forward, each with a profiled call's
                device time and busy share.
  4. noise    - the noise slice's main path: LeNet as in phase 3 with
                EngineConfig(noise=NoiseConfig()) (the post-silicon noise
                model; the planned cim_mbiw tiles in raw-dp mode, each on
                its route, and the ADC epilogue outside the kernel), key
                prng.key(1), at (4, 2) and (8, 4), batch 256: logits ==
                the card reference == the port's CPU run bit for bit; the
                same key repeats, key 2 and the clean run differ;
                serve_batch(requests, key, isolate=True) == each request's
                solo serve under request_noise_ids; threefry_normal once
                a layer.  A Monte-Carlo sweep of 8 trials over
                split(key, 8) at noise scales {0.25, 1, 4} (thermal RMS
                and SA-offset sigma scaled) prints top-1 agreement with
                the clean logits (only reproducibility is asserted).
                Median noisy and clean serve latency, and a profiled noisy
                forward's device time with the draw kernel's share.
  5. decode   - the second main path: in-flight decode serving
                (InflightScheduler over CIMDecodeLM) at OLMo-1B widths
                (d 2048, 16 heads, d_ff 8192, vocab 50304, window 2048,
                RoPE theta 1e4; depth DECODE_DEPTH), points "" = (4, 2)
                and "quality" = (8, 4), weights from a seeded
                torch.Generator.  8 requests from numpy seed 0 at capacity
                4; every fused stream equals its solo decode_sequential,
                cim_mbiw launched planned tiles x model calls, every one
                on the split-K route, and ring_decode two kernels x
                depth x model calls (replays included), a bound
                projection equals its card reference.  Every
                projection dispatch replays a CUDA graph: the run's
                captures equal the graphs the
                bound programs hold (one a dispatch key), and the solo
                decodes capture none.  Bind seconds, median fused-step
                latency per point, tokens/s; last in the script, a fused
                4-row step per point with graphs and with every
                projection run eagerly (EagerServe): median host ms and
                the profiler's device time and busy share of each.
  6. noise decode - in-flight decode as in phase 5 with noise, depth
                2, point (4, 2), 4 requests at capacity 4 under
                prng.key(0): every fused stream == its solo
                decode_sequential(..., key), and the streams differ from
                the clean model's; threefry_normal once a projection call.
  7. train    - the third main path: OLMo-1B (16 layers, d 2048, 16
                heads of 128, d_ff 8192, vocab 50304, tied head, bf16,
                remat) built by launch/train.build as `--arch olmo-1b
                --cim-mode fakequant --attn-impl pallas` (r_in 8, r_w 4,
                r_out 8, max_gamma 2^16; the flash kernels), sequence 4096
                (SHAPES["train_4k"]) at batch 2 (cut from 256),
                SyntheticLM batches (seed 1234), AdamW lr 3e-4 with the
                launcher's warmup and cosine schedule, 3 steps of
                launch/steps.make_train_step, weights from a seeded
                torch.Generator on the card.  Every loss finite; flash
                launches = 16 forward + 16 recompute + 16 dq + 16 dk/dv
                per step, every one on the tensor-core kernels; TF32
                off.  From the initial weights and batch,
                step 0 with attn_impl "jnp" (plain attention) gives the
                flash step's loss, grad norm and gradient within
                TRAIN_JNP_RTOL, and a control with an off-by-one causal
                mask falls outside it.  Host ms per step (ending in a
                sync), tokens/s, peak memory, and a profiled step's
                device time and flash share.  The noisy step: the same
                weights and batch under CIMConfig(noise=NoiseConfig()) and
                the launcher's step-0 key; loss and gradient twice, bit
                for bit equal, finite and off the clean step 0's;
                threefry_normal once per row tile of every projection and
                once for its residues, forward and recompute; host ms of
                a noisy step against the clean median.
  8. llm_serve - the fourth main path: LM serving through
                launch/serve.py (`--arch olmo-1b --cim-mode engine`, its
                defaults: batch 4, prompt 32, gen 16): OLMo-1B at full
                width and depth 16 in bf16, seeded random weights, every
                projection through an engine-mode layer at (8, 4) on the
                one BoundProgram of its weights (the 128-row prefill on
                cim_mbiw's tensor-core route, the 4-row decode on
                split-K; counts = planned tiles, replays included).
                Engine == fakequant bit for bit (the prefill's and every
                decode step's logits, and the tokens); one decode step
                with graphs == the same step with every projection run
                eagerly (EagerServe); after the first decode step no
                plan, capture or eager dispatch.  In flight: 8 requests
                (numpy seed 0, the launcher's make_requests) at 4 slots,
                depth cut to 4 of 16: every request's tokens == its solo
                decode, no growth after warm-up, every tile split-K.
                Bind and capture seconds, first and warm prefill, decode
                host ms a step, tokens/s, graph pool, peak memory, and a
                profiled decode step's device time, busy share and top
                device operations.
  9. precision - workload-adaptive precision serving through the
                library's entry points and the launcher: the four
                projections of a decode block at OLMo-1B's widths (qkv
                2048->6144, o 2048->2048, gate_up 2048->16384, down
                8192->2048; m 8, batch 4, clean) calibrated over the
                whole precision chain into a temporary profile cache
                (one calibration run, 28 binds, cim_mbiw = the planned
                tiles of every run; a second call hits the cache with an
                equal profile), assign under DEFAULT_BUDGETS, and a
                CIMDecodeLM.toy at OLMo-1B widths (depth cut to
                PRECISION_DEPTH) serving "quality" and "throughput" from
                that assignment over the same masters: every (point,
                bucket extent) warmed up, 8 requests at capacity 4 with
                alternating points, every stream == its solo decode,
                plans / captures / eager dispatches flat after warm-up,
                tokens by point, tokens/s and each point's point_report
                TOPS/W (the IMAGINE macro model's projection, not a card
                measurement).  LeNet calibrated chained under
                NoiseConfig() (4 trials, batch 8; one draw a layer a
                run), plan_ladder over the default budgets, each rung
                bound and served at batch 256 through its CUDA graph ==
                the card reference == the CPU run, host ms a serve.  Then
                `launch/serve.py --arch olmo-1b --cim-mode engine
                --inflight --precision-policy mixed --assert-no-recompile`
                in-process.  The phase's cim_mbiw route counters,
                captures and program-cache evictions.
 10. tuner    - the schedule autotuner (repro_torch.tuner, the route tile
                a tuned plan carries to cim_mbiw): every tile of
                kernel.legal_tiles at one shape per route and plane count
                (route A 256x784x{128,64}, B 4x1024x{128,64}, C 784x9x16)
                == the plain version in both ADC modes; LeNet at batch
                256, (4, 2) and (8, 4), through compile_program(...,
                tune="off" | "analytic" | "measure") with a cache file a
                mode under chiprun_out/: each layer's heuristic and
                tuned tiles, predicted costs and CUDA-event time a
                dispatch, serves by graph replay bit-equal across modes
                and to the plain reference, .launches_tuned = 21 forwards
                x the tiles that run a tuned tile (above 0 wherever a
                tuned tile differs from route_for's), median serve ms of
                the three modes; OLMo-1B's four projections (qkv
                2048->6144, o 2048->2048, gate_up 2048->16384, down
                8192->2048) as one-layer programs at (8, 4) and (2, 2),
                rows 4 and 128, tuned in both modes == untuned, the event
                time of the heuristic and the tuned tiles; a second tune
                with the same file all hits (SEARCH_COUNT flat), a
                corrupt file warns once, runs the heuristic and writes
                nothing; Spearman >= 0.7 between the analytic cost and
                the event time of JAX's five pinned shapes.  No gain is
                claimed.
 11. cnn_train - CIM-aware training of the paper's own CNN and MLP, as
                examples/train_lenet_cim.py and benchmarks/
                fig3_abn_accuracy.py run it.
                LeNet (28x28x1 -> conv16 -> pool -> conv32 -> pool -> fc
                1568->128 -> fc 128->10, weights from prng.key(0) as JAX
                draws them) in fakequant at (4, 2) under NoiseConfig(),
                pseudo-MNIST 4096 / 1024, batch 256, AdamW lr 1e-3,
                CNN_EPOCHS epochs (per-step keys split from prng.key(1)):
                step 0's clean and noisy logits == the port's CPU run bit
                for bit, its gradients within _close_grad (the conv ABN
                gains, sums over every output pixel of the batch, within
                CONV_GAIN_ATOL of the largest; the least atol each needs
                is read at batch 8, 32 and 256).  The recipe runs twice
                from the same weights, under noise and clean (under noise
                step 0's logits sit in the hundreds and LeNet stays at
                chance in 32 steps; the clean run learns): each loss falls; for each, test accuracy in
                fakequant (1024), sim (the voltage-domain macro) and
                engine (lenet_program, a graph replay == the card
                reference == the CPU engine run) on 128, and the engine
                against fakequant on those same 128 images (top-1
                agreement 1, mean relative distance at most 0.05, as
                JAX's test states); host ms a step noisy and clean,
                images/s, a profiled noisy step, peak memory.  conv1
                and conv2 through cim_conv2d_apply(mode="engine") at batch
                256 and (stride, padding) (1, 1), (2, SAME), (1, VALID),
                within rtol 1e-4 / atol 1e-5 of fakequant.  The Fig. 3(b)
                MLP (784-128-64-10) sweep: eight cases, 5 epochs of 2048
                at batch 256, accuracies and the benchmark's two claims
                (held or missed, not gated).  Every count is set to 0
                before the phase and read after it (cim_mbiw and
                threefry_normal both launch).
 12. dense    - granite-8b, minitron-4b and qwen2-7b at full width, depth
                cut to 2: one fakequant (8, 4, 8) bf16 step each with the
                flash kernels at batch 1 x 512 (finite loss, gradients and
                parameters, 4 + 2 + 2 flash launches, on the tensor cores
                but for qwen2-7b, whose float32 QKV bias makes its
                attention float32, as in JAX; each attention shape is one
                that phase 2 holds against the plain version),
                train/decode consistency over 8 tokens (< 0.1), peak
                memory.  The step runner (train_steps) is phase 7's.
 13. moe      - the moe and vlm families at full width (widths, heads,
                experts, vocabularies as published; each depth cut is
                printed), bf16, weights from a seeded torch.Generator.
                One phi3.5-moe expert bank (E 16, capacity 8, 4096 ->
                6400): the engine on the card == fakequant on the card
                == fakequant on the CPU bit for bit at (8, 4) and (1, 2),
                and noisy under prng.key(11) at (8, 4), the kernel path
                == reference=True; a moe_block at full width on 64
                tokens: top_idx card == CPU, output within 2e-2.  One
                fakequant (8, 4, 8) train step at batch 1 x 512 through
                launch/steps and the flash kernels: phi3.5-moe at depth
                2 (step 0 against plain attention within TRAIN_JNP_RTOL
                with the CIM layers in bypass, and reported in fakequant,
                where the discontinuous routing amplifies ulps; nonzero
                router, bank and per-expert ABN gain gradients),
                mixtral-8x22b at depth 1 (if it fits the card; if not,
                the peak reached is printed), internvl2-76b at depth 1
                with its 256-token prefix; finite loss, gradients and
                parameters, the profiled step's device time by kind.
                Static engine serves through launch/serve.py's build
                (depth cut), make_prompt, make_prefix and static_serve,
                each == its fakequant serve bit for bit (prefill and
                every decode logit), cim_mbiw launched the planned tiles
                (family_tiles: attention at the rows' bucket, 2E + E
                expert serves at the capacity's), no plan, bind, capture
                or eager dispatch after warm-up, a decode step profiled:
                first the main path, phi3.5-moe at depth 4 (batch 4,
                prompt 128: expert capacity 80 on the tensor cores, gen
                16; first-prefill, bind and capture seconds, decode ms a
                step, tokens/s, peak memory), in flight at depth 4 (8
                requests at 4 slots, prompt 32; every launch split-K and
                planned, no growth after warm-up), and over its first 2
                layers and their binds the sharded serve (batch 4, prompt
                8, gen 4, --engine-devices 4 folded onto the card:
                tokens and every logit == unsharded); over the same 2
                layers in bypass a forward at batch 2 x 256 under a
                ("data", "model") = (2, 2) mesh folded onto the card
                (moe_block's split of JAX's shard_map path), with the
                flash kernels (a launch a piece of the context-parallel
                split, 4 a layer, tensor cores) against
                the same forward through plain attention, the CE within
                TRAIN_JNP_RTOL's loss limit and the first layer's
                attention block within MOE_FOLD_ATTN_RTOL, the split
                against the unsplit forward reported with each run's
                dropped (token, choice) pairs (moe_fold_check); then
                mixtral at depth 1 (batch 4, prompt 32, gen 4) and
                internvl2 at depth 2 (batch 2, prompt 32 behind the
                prefix, gen 4).
 14. recurrent - the hybrid and ssm families at full width.  The flash
                forward, dq and dk/dv at D 256 (bf16 on the tensor cores,
                their `.launches_tc` rising; float32 on the CUDA-core
                kernels' second head-dimension bound) against their plain
                versions within the phase-2 tolerances, float32 and bf16:
                recurrentgemma-2b's attention (B 1, H 10, G 1, S 4096,
                causal, window 2048), S 1000 at rep 2 with window 256 and
                q_off 100, and a non-causal Sq 777 / Sk 513; their
                CUDA-event times at recurrentgemma's shape in bf16 beside
                the plain versions, the CUDA-core forward, dq and dk/dv
                of the earlier design (which must agree within the
                phase-2 limits and be slower), SDPA with the boolean
                window mask, and the bounds.  Then 3 fakequant (8, 4, 8)
                bf16 train steps at batch 1 x 4096 through launch/steps:
                recurrentgemma-2b at depth 5 of 26 (one block, the
                2-layer tail; its local attention on the D 256 flash
                kernels, two forwards with the recompute, a dq and a
                dk/dv a step, all on the tensor cores; step 0 against
                plain attention within
                TRAIN_JNP_RTOL, in bypass and in fakequant), mamba2-1.3b
                at depth 4 of 48; finite losses and parameters, peak
                memory, a profiled step.  Static engine serves through
                launch/serve.py (build with the depth cut, make_prompt,
                static_serve; bf16, (8, 4), batch 4, prompt 32, gen 16)
                of recurrentgemma-2b at depth 8 (two blocks, the tail)
                and mamba2-1.3b at depth 4 (in_proj's N 8512 ends in a
                64-column tile on the
                tensor-core and split-K routes): engine == fakequant bit
                for bit (prefill and every decode logit), cim_mbiw
                launched the planned tiles (family_tiles), no plan, bind,
                capture or eager dispatch after warm-up, one decode step
                by graph replay == the same step run eagerly (logits and
                the new cache), the cached prefill's last logits within
                PREFILL_RTOL of the cache-free forward, a decode step
                profiled.
 15. audio    - the audio family at full width: whisper-medium
                (arXiv:2212.04356: 24 encoder + 24 decoder layers, d
                1024, 16 heads of 64, d_ff 4096, vocab 51865, layernorm,
                tanh gelu), both stacks at full depth (AUDIO_DEPTH), bf16.
                The flash forward, dq and dk/dv at its three attention
                shapes (FLASH_AUDIO: the encoder's 1500 x 1500, the
                decoder's causal 187 x 187 and the cross-attention's 187
                queries over 1500 frames, B 1, H 16, D 64; bf16 on the
                tensor cores, the cross-attention in float32 too) against
                their plain versions within the phase-2 tolerances, each
                backward bit-equal on a second run, and their CUDA-event
                times beside SDPA's on the same inputs.  3 fakequant (8,
                4, 8) bf16 train steps at batch 1 x 1500 seeded frames
                (train.audio_frames, the draw kernel) and 187 tokens
                through launch/steps, every flash launch on the tensor
                cores, step 0 against plain attention within
                TRAIN_JNP_RTOL in bypass and in fakequant; a profiled
                step.  A static engine serve through launch/serve.py
                (build, make_prompt, make_frames, static_serve; (8, 4),
                batch 4, --prompt-len 1476 cut to its first token as the
                launcher cuts it, gen 16, so max_len and the encoder's
                frames are 1500): engine == fakequant bit for bit
                (prefill and every decode logit), cim_mbiw launched the
                planned tiles (the encoder and the cross K/V at 6000 rows
                on the tensor cores, the decoder at 4 on split-K), no
                plan, bind, capture or eager dispatch after warm-up, one
                decode step by graph replay == eager, the cached
                prefill within PREFILL_RTOL of the cache-free forward
                over the same frames, a decode step profiled.
 16. shard    - the sharded multi-macro engine, every mesh folded onto
                the card (ShardingConfig(fold_onto="cuda"), the port's
                counterpart of the host device count the JAX package
                fakes a bank of macros with; phi3.5-moe's sharded serve
                runs in phase 13, over its weights and binds).  LeNet at
                batch 256, (4, 2)
                and (8, 4), D {1, 2, 4, 8}, each kind forced on every
                layer through plan_network(schedule=): a clean serve by
                graph replay, its eager run and the card reference, and a
                noisy serve under prng.key(1), each == the unsharded
                program bit for bit (itself == the CPU run, clean and
                noisy; D 8 also == its own CPU run), a replay's cim_mbiw
                launches == the plan's sharded tile calls (dummy tiles
                and rows included); host ms, event ms and profiled
                device ms of a serve at each D and kind.  Engine-mode
                cim_linear_apply at OLMo-1B's projection widths
                (2048->2048, 2048->8192, 8192->2048), rows 4 and 128,
                D 4, both kinds == unsharded.  launch/serve.py's build
                (sharding=ShardingConfig(devices=4, folded)) at OLMo-1B's
                full width, depth cut to 4, bf16, engine (8, 4), batch 4,
                prompt 32, 8 new tokens: tokens and the last step's
                logits == the unsharded serve, no growth after warm-up;
                in flight 8 requests at 4 slots over D 8: fused == each
                request's sequential decode.  The tuner at D 4 on LeNet
                (4, 2): every (tile, kind) candidate of every layer ==
                untuned; the analytic winners and their event us.
                flash_attention_sharded at B 2, H 16, S 4096, D 128,
                causal, bf16 over a folded (data 1, model 4) mesh,
                forward and backward: one tensor-core launch a piece
                each, against the unsharded kernel calls within 2e-5
                (the bf16 output one ulp) and 5e-5 (float32 gradients),
                bit-equality reported.  Placement across cards runs only
                with 2 cards; otherwise a line says it was not run.
 17. cimcheck - static verification (repro_torch.analysis) on the card:
                (a) `python -m repro_torch.analysis --strict` in process
                at smoke widths (LeNet, OLMo-1B's and phi3.5-moe's
                projections over r_in {1,2,4,8} x r_w {1,2,4}, the
                noisy, folded-sharded
                and mixed-ladder points, the SASS pass), then OLMo-1B's
                four projections at full width (d 2048, d_ff 8192, m 8,
                (8, 4)); any ERROR fails the run.  (b) the SASS pass
                over every built library: floor sinks and FFMAs on their
                slices per function; any finding on a cim_mbiw route
                fails.  (c) a seeded contractible epilogue, floorf(mid +
                gain*dp + beta) with plain operators, compiled with
                kernels/build.py's flags: the pass must report it.  (d)
                compile_program(verify="strict") against "off", fresh
                each time, on LeNet (4, 2) at batch 256 and on each
                OLMo-1B projection: both times printed; no capture, bind
                or launch counter moves.  (e) the legacy entries
                (run_network, CIMInferenceEngine's call and reference,
                run_network_reference) == program.run on LeNet at batch
                256, clean and noisy, and on one OLMo-1B projection at 4
                rows (the split-K route); monte_carlo's 4 trials == 4
                runs under the split keys.  The launches of (e), the
                slice's main path, join the kernels line.
 18. ft_train - the training infrastructure on the card: launch/train.py
                at OLMo-1B's full width (d 2048, 16 heads, d_ff 8192,
                vocab 50304), depth cut to FT_DEPTH 2 of 16 (the float32
                state, params, m, v and err, is 16 B a parameter: 3.8 GB
                a checkpoint), fakequant (8, 4, 8), flash, bf16,
                --compress-grads, sequence 4096 x batch 2 (phase 7's
                batches).  FT_STEPS 6 uninterrupted steps through
                train.build and make_train_step (train_steps: flash
                launches a step, all on the tensor cores); then the same
                6 steps through the fault-tolerant driver (make_driver:
                --ckpt-dir in a temporary directory under chiprun_out/,
                --ckpt-every 2, keep 2) with faults injected before steps
                3 and 5: restarts 2, steps 2 and 4 run again, their
                losses and the final state (every param, m, v, err and
                opt/step) bit-equal to the uninterrupted run's, the
                driver's flash launches 8 steps' worth, on the tensor
                cores.  The newest checkpoint loads equal to the final
                state, is resharded (param_specs, tree_shardings,
                reshard_tree) onto a ("data", "model") = (4, 1) mesh
                folded onto the card, and one more step under use_mesh
                is bit-equal to the same step of the uninterrupted state.
                compress_leaf on the card == on the CPU, codes, scale and
                residual, on every leaf of step 1's gradients and error
                buffer and on a leaf of zeros.  Prints the bytes of a
                checkpoint, the seconds the loop blocks a save (its
                device-to-host copy) and the writer's, the restores', the
                newest's load and reshard, the free disk before the
                phase, the median step, and the card's name and power
                limit.
 19. dryrun   - the dry run (launch/dryrun.py): `--arch A --mesh card`
                in bypass, a process an arch, all ten at once on the
                host's cores with the card idle (the meta device only),
                walks every arch x shape at full size; each of the 40
                cells ok or skipped
                (JAX's reason), none making a tensor off meta; a line an
                arch with status, flops and fits_card a cell.  Then
                DRYRUN_REAL, OLMo-1B's prefill_32k cut to batch 2 x 4096
                positions (the cut named on its line), with the flash
                kernels: walked on meta in this process and built and run
                on the card, the analysed argument_size_in_bytes equal to
                the summed nbytes of the params and tokens there,
                exactly; the flash launches of a step equal to the
                walk's recorded kernel ops; analysed arguments + temp
                beside torch.cuda.max_memory_allocated over the phase's
                base, and flops over the median of 3 steps as TFLOP/s.
 20. examples - the five examples/torch_*.py on the card, each held to
                its outcome: quickstart (the ABN error below unity
                gain's, engine == reference), serve (granite-8b's smoke
                widths in float32, batch 4, gen 16: engine tokens ==
                fakequant tokens), the noise sweep at its own size (the
                clean accuracy above chance, 0.1), LeNet training one
                epoch (the noisy loss falls), and fault-tolerant
                pretraining (EXAMPLE_FT: 150 steps, d 256, 4 layers,
                faults before steps 50 and 100) whose resumed state
                equals the uninterrupted run's, every leaf.  Their
                cim_mbiw and threefry_normal launches join the kernels
                line.
 21. times    - CUDA-event times of each kernel, its plain version and a
                library call computing the same function (torch._int_mm
                for cim_mbiw, scaled_dot_product_attention for
                ring_decode and the flash kernels: yardsticks the port
                never calls), beside the least time the card could take
                (the larger of operations over the peak rate of their type
                and bytes / 3.35 TB/s, the H100 SXM's published peaks), at
                the LeNet tiles, the decode tiles, the full-macro tile,
                the decode attention shape and the train attention shape
                (B 2, H 16, S 4096, D 128, causal, bf16), where the
                forward, dq and dk/dv CUDA-core kernels of the earlier
                design are timed too.  For cim_mbiw also: the route, the
                first port's kernel (cim_mbiw.cu at BN 64) on the same
                inputs, device microseconds per call of the kernel, that
                earlier design and _int_mm from 20 calls replayed in one
                CUDA graph, and the wrapper's host microseconds per
                launch.  For threefry_normal: at the noisy LeNet's conv1
                draw (1569 streams of 2048), whisper's served frames (1
                stream of 6,144,000) and the noisy decode's engine draw
                (its shape read in phase 6): the wrapper's event ms, the
                device time a launch in 5 windows of a CUDA graph of 20,
                torch.randn of as many normals as a yardstick of another
                function; its bound from its SASS (`draw_trip_of` on
                `cuobjdump -sass`): a trip through the grid-stride loop
                computes 4 normals, and a normal's own instructions are
                those the keys reach over 4 (the layout's index, divide,
                addresses, stores and loop control left out; the erf_inv
                tail side weighted by the share of warps that run it),
                over the rate the SMs start instructions at, and its
                integer and FMA-pipe ones over their pipes' rates; beside
                it the bound from the first design's count (168 own, 10
                on the tail), the share stated against the smaller.

Then a capture line (captures, their seconds with each one's eager
warm-up, and the bytes of the shared graph pool, after the LeNet and
decode phases and at the end), the `kernels` JSON line, the card's name
and power limit as nvidia-smi reports them, and last the JSON result
line.  Detailed numbers
go to chiprun_out/chip_smoke.json.  Exits non-zero (printing no result)
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the card's published peaks: the one table the port's tuner reads too
from repro_torch.core.hw import H100_SXM as CARD  # noqa: E402
# the kernels' cost formulas: the one table the dry run's meta routes and
# PERF.md's bounds read too
from repro_torch.kernels import costs  # noqa: E402

PEAK_F32_OPS = CARD.f32_flops   # float32 rate outside the tensor cores
PEAK_BYTES = CARD.hbm_bw        # HBM3 bandwidth
PEAK_INT32_OPS = CARD.int32_ops  # 64 INT32 lanes x 132 SMs x 1.98 GHz
LENET_BATCH = 256
# the edges of cim_mbiw's routes (kernel.route_for): M around the split-K
# limit (63) and the tensor-core tiles (64, 128), N around the tile
# widths, K unaligned for TMA (37), one stage (48), across a 128-value
# stage (144) and past the decode tiles' 1024
ROUTE_M = (1, 4, 63, 64, 65, 129)
ROUTE_N = (10, 16, 33, 64, 128, 256)
ROUTE_K = (37, 48, 144, 1040)
REQUESTS = (1, 7, 100)
PRECISIONS = ((4, 2), (8, 4))
# OLMo-1B's widths (arXiv:2402.00838); depth is the only cut: 4 of its 16
# blocks keep the whole script well inside its time limit, since the
# decode phase's cost grows with depth (PERF.md has the full depth's run)
DECODE_WIDTHS = dict(d=2048, n_heads=16, d_ff=8192, vocab=50304,
                     window=2048, rope_theta=1e4)
DECODE_DEPTH = 4
DECODE_POINTS = {"": (4, 2), "quality": (8, 4)}
DECODE_CAPACITY = 4
DECODE_REQUESTS = 8
# the train path: OLMo-1B at full width and depth, SHAPES["train_4k"]'s
# sequence, global batch cut from 256 to 2
TRAIN_SEQ = 4096
TRAIN_BATCH = 2
TRAIN_STEPS = 3
TRAIN_LR = 3e-4
# flash (pallas) against plain (jnp) attention from the same weights and
# batch, each relative to the plain step: the loss, the grad norm and the
# whole gradient (|g_flash - g_plain| / |g_plain|).  The two differ by
# float32 rounding, which moves a few bf16 activations by an ulp and with
# them a few fakequant codes.  The limits are 2.5-18 times the readings
# in PERF.md.  A control step with an off-by-one causal mask must break
# one: at random weights only the gradient limit tells it apart
TRAIN_JNP_RTOL = {"loss": 5e-4, "grad_norm": 5e-3, "grad": 5e-2}
# the draw kernel's checks: streams x lengths (2048 = 128 x 16, a LeNet
# conv1 block; 6,144,000 whisper's served frames; 1, 3, 5, 127 and 129
# rows shorter than or ragged against a thread's 4 normals), each case of
# at most DRAW_MAX normals (1568 x 2^22 would be 26 GB), those of at most
# DRAW_HOST_MAX drawn on the host too
DRAW_STREAMS = (1, 3, 1568)
DRAW_LENGTHS = (1, 3, 5, 127, 128, 129, 2048, 1 << 22, 6_144_000)
DRAW_MAX = 1 << 24
DRAW_HOST_MAX = 1 << 22
# one warp instruction a clock on each of an SM's 4 sub-partitions, at
# the 1.98 GHz boost clock: the lane-instructions a second the card
# starts, whatever their pipe
PEAK_INSTRUCTIONS = CARD.sms * 4 * 32 * 1.98e9
# Monte-Carlo sweep of noisy LeNet: trials per scale; a scale multiplies
# the random terms (thermal RMS and SA-offset sigma)
MC_TRIALS = 8
MC_SCALES = (0.25, 1.0, 4.0)
# noisy decode: OLMo-1B widths at depth 2, 4 requests at capacity 4
NOISE_DECODE_DEPTH = 2
NOISE_DECODE_REQUESTS = 4
# the LM serve path (launch/serve.py): the launcher's defaults (batch 4,
# prompt 32, gen 16) at OLMo-1B's full width and depth; in flight, 8
# requests at 4 slots with the depth cut to 4 of 16 (run time)
SERVE_BATCH = 4
SERVE_PROMPT = 32
SERVE_GEN = 16
SERVE_INFLIGHT_DEPTH = 4
SERVE_INFLIGHT_SLOTS = 4
SERVE_INFLIGHT_REQUESTS = 8
# the precision path: the four projections of a decode block at OLMo-1B's
# widths calibrated over the whole precision chain (clean, m 8, batch 4),
# their assignment served in flight at depth PRECISION_DEPTH (the cut);
# LeNet calibrated under noise (n_trials 4, batch 8), its ladder's rungs
# served at LENET_BATCH
PRECISION_DEPTH = 2
PRECISION_CAL_BATCH = 4
PRECISION_LENET_TRIALS = 4
PRECISION_LENET_BATCH = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_drawn(got: torch.Tensor, key: torch.Tensor, what: str) -> None:
    """`got`, one draw_normal stream (the launchers' frames and prefixes),
    against the draw's plain version on the same key, bit for bit."""
    from repro_torch.kernels.prng.ref import threefry_normal_ref
    want = threefry_normal_ref(key.reshape(1, 2).to(got.device),
                               got.numel())
    check(torch.equal(got.flatten(), want.flatten()),
          f"{what} ({tuple(got.shape)}): threefry_normal != its plain "
          f"version on the same key")


# the shared memory a block may opt in to on an H100 (bytes)
SMEM_OPT_IN = 232448
# the D 256 instantiations of the tensor-core flash kernels: library and a
# piece of its entry function's mangled name
PTXAS_D256 = (("flash_fwd_tc", "flash_fwd_tc_kernelILi256E"),
              ("flash_bwd_dq_tc", "flash_bwd_dq_tc_d256_kernel"),
              ("flash_bwd_dkv_tc", "flash_bwd_dkv_tc_d256_kernel"))


def ptxas_entries(log: str) -> dict:
    """ptxas's report (nvcc -Xptxas -v) per entry function: registers,
    stack frame and spill store / load bytes."""
    out: dict = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = out.get(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    return out


def ptxas_d256(infos, build) -> dict:
    """ptxas's registers, stack and spills and the dynamic shared memory
    of each D 256 tensor-core flash kernel (PTXAS_D256), from the logs of
    `build.build_all`; checks that none spills."""
    out = {}
    for lib_name, piece in PTXAS_D256:
        found = [(fn, r) for fn, r in
                 ptxas_entries(infos[lib_name].log).items() if piece in fn]
        check(len(found) == 1, f"ptxas reported {len(found)} entry "
              f"functions matching {piece} in {lib_name}")
        fn, rep = found[0]
        smem_fn = getattr(build.load(lib_name),
                          f"{lib_name}_smem_bytes")
        rep = dict(rep, entry=fn, dynamic_smem_bytes=int(smem_fn(256)))
        out[lib_name] = rep
        print(f"ptxas {lib_name} D 256 ({fn}): {rep.get('registers')} "
              f"registers, {rep.get('stack')} bytes stack frame, "
              f"{rep.get('spill_stores')} / {rep.get('spill_loads')} bytes "
              f"spill stores / loads, {rep['dynamic_smem_bytes']} bytes "
              f"dynamic shared memory", flush=True)
        check(rep.get("spill_stores") == 0 and rep.get("spill_loads") == 0,
              f"the D 256 instantiation of {lib_name} spills: {rep}")
        check(0 < rep["dynamic_smem_bytes"] <= SMEM_OPT_IN,
              f"the D 256 instantiation of {lib_name} takes more shared "
              f"memory than a block may opt in to: {rep}")
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _captured(fn, calls: int) -> torch.cuda.CUDAGraph:
    """`calls` calls of `fn` captured in one CUDA graph, after a warm-up
    call on a side stream (so that allocations and workspaces exist
    first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    return g


def graph_us(fn, calls: int = 20) -> float:
    """Device microseconds per call: `calls` calls captured in one CUDA
    graph (`_captured`), the graph replayed between CUDA events."""
    g = _captured(fn, calls)
    ms = cuda_ms(g.replay, 5)
    del g
    return 1e3 * ms / calls


def graph_windows(fn, calls: int = 20, windows: int = 5) -> list:
    """Device microseconds per call in each of `windows` replays of one
    CUDA graph of `calls` calls (`_captured`, then a warm-up replay), each
    replay between its own CUDA events."""
    g = _captured(fn, calls)
    g.replay()
    out = []
    for _ in range(windows):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        g.replay()
        t1.record()
        torch.cuda.synchronize()
        out.append(1e3 * t0.elapsed_time(t1) / calls)
    del g
    return out


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds per call spent in `fn` (an asynchronous launch
    returns once the kernel is queued)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * total / calls


def kernel_counts(kern) -> tuple:
    """(all, tensor-core, split-K) launch counters of cim_mbiw."""
    return kern.launches, kern.launches_tc, kern.launches_splitk


def reset_counts(kern) -> None:
    kern.launches = kern.launches_tc = kern.launches_splitk = 0
    kern.launches_tuned = 0


def eager_forward(rt, bound, x, segments=None) -> torch.Tensor:
    """A bound program's clean dispatch run eagerly: the rows padded to
    their bucket as BoundProgram.serve pads them, then engine._forward
    called directly - the yardstick of the captured graphs."""
    prog = bound.program
    xc, lead = prog._canon(x)
    m = xc.shape[0]
    b = prog.buckets.bucket_for(m)
    xp = torch.cat([xc, xc[:1].expand((b - m,) + tuple(xc.shape[1:]))])
    seg = None
    if segments is not None:
        sg = torch.as_tensor(segments).to(prog.device, torch.int64)
        seg = torch.cat([sg, sg[:1].expand(b - m)])
    y = rt._forward(prog.plan, bound._binds, xp, reference=False,
                    m_valid=m, seg=seg)
    return y[:m].reshape(lead + tuple(y.shape[1:]))


class EagerServe:
    """Inside the block every BoundProgram.serve runs eager_forward, not
    its graph (clean dispatches only): the eager run of the same decode
    step, switched here and not in the package."""

    def __init__(self, tprog, rt):
        self.tprog, self.rt = tprog, rt

    def __enter__(self):
        rt = self.rt
        self.orig = self.tprog.BoundProgram.serve

        def serve(bound, x, key=None, noise=None, *, segments=None,
                  noise_ids=None, reference=False, point=""):
            check(key is None and noise is None and not reference,
                  "the eager yardstick serves clean dispatches only")
            return eager_forward(rt, bound, x, segments)
        self.tprog.BoundProgram.serve = serve

    def __exit__(self, *exc):
        self.tprog.BoundProgram.serve = self.orig


def graph_pool_bytes(tprog, dev) -> int:
    """Bytes the caching allocator holds in the device's shared graph
    pool (every captured executable's intermediates and outputs; the
    static inputs sit outside it), from its snapshot's pool ids."""
    pool = tprog._GRAPH_POOLS.get(tprog.resolve_device(dev))
    if pool is None:
        return 0
    return sum(sg["total_size"] for sg in torch.cuda.memory_snapshot()
               if tuple(sg["segment_pool_id"]) == tuple(pool))


class CaptureClock:
    """Wraps the executables' capture to time each one (its eager warm-up
    run and the capture, ending in a sync)."""

    def __init__(self, tprog):
        self.seconds = []
        orig = tprog._Executable.capture.__func__
        clock = self

        def capture(cls, *a, **kw):
            t0 = time.perf_counter()
            out = orig(cls, *a, **kw)
            torch.cuda.synchronize()
            clock.seconds.append(time.perf_counter() - t0)
            return out
        tprog._Executable.capture = classmethod(capture)

    def since(self, mark: int) -> dict:
        """Captures and their seconds from the mark (a count) on."""
        t = self.seconds[mark:]
        return {"captures": len(t), "seconds": sum(t),
                "max_s": max(t, default=0.0)}


def device_profile(fn, reps: int, cpu: bool = True,
                   groups=("cim_mbiw", "ring_decode")) -> dict:
    """torch.profiler over `reps` calls: device microseconds per call (all
    kernels, those whose name holds each of `groups`, and the eight
    largest by name) and the host wall time per call under the profiler.
    With `cpu=False` only the device is traced (fewer events for a call
    that launches many thousand kernels).  Empty dict when the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time_total
    total = sum(by_name.values())
    if total <= 0:
        return {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {f"{g}_us": sum(v for k, v in by_name.items() if g in k) / reps
           for g in groups}
    return {"device_us": total / reps, **out, "wall_us": 1e6 * wall / reps,
            "device_busy": total / (1e6 * wall),
            "top_kernels_us": {k[:80]: v / reps for k, v in top}}


def bound_ms(m: int, k: int, n: int, planes: int, beta_rows: bool) -> tuple:
    """Least time (ms) for one cim_mbiw call and what bounds it: each
    input byte read once, each output byte written once (the cost table's
    `costs.cim_mbiw`)."""
    return costs.bound_ms(costs.cim_mbiw(m, k, n, planes, beta_rows), CARD)


def ring_bound_ms(r: int, l: int, h: int, hd: int) -> tuple:
    """Least time (ms) for one ring_decode call and what bounds it: q, k,
    v, bias read once and the output written once, against the float32
    work of the two products (`costs.ring_decode`)."""
    return costs.bound_ms(costs.ring_decode(r, l, h, hd), CARD)


def ring_inputs(r: int, l: int, h: int, hd: int, seed: int, dev,
                tail_chunk: int = 0) -> list:
    """q (R, H, hd); k, v as block 1 of a (R, 2, L, H, hd) state slab
    (strided views, as the scheduler passes them); bias with 1..L valid
    slots per row, the first ones, or with `tail_chunk` > 0 only slots of
    the last tail_chunk-slot chunk (the earlier chunks all masked)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((r, h, hd), generator=g, device=dev)
    k = torch.randn((r, 2, l, h, hd), generator=g, device=dev)[:, 1]
    v = torch.randn((r, 2, l, h, hd), generator=g, device=dev)[:, 1]
    slot = torch.arange(l, device=dev)[None, :]
    if tail_chunk:
        last = l - tail_chunk * ((l - 1) // tail_chunk)
        valid = torch.randint(1, last + 1, (r,), generator=g, device=dev)
        keep = slot >= l - valid[:, None]
    else:
        valid = torch.randint(1, l + 1, (r,), generator=g, device=dev)
        keep = slot < valid[:, None]
    bias = torch.where(keep, 0.0, -1e9).to(torch.float32)
    return [q, k, v, bias]


RING_LENGTHS = (1, 37, 129, 300, 2048)


def ring_checks(rk, rref, dev) -> dict:
    """ring_decode (`rk.ring_decode`) against its plain version within
    rtol = atol = 1e-5 over R {1,3,4,8} x H {1,16} x hd {12,128,130,256}
    (130: 4-byte copies; above 128: 8 values a lane) x RING_LENGTHS, the
    valid slots first and, where L spans more than one
    chunk, only in the last chunk; each row of an R-row call bit for bit
    equal to its one-row call.  Returns the case count and the largest
    absolute error."""
    ring, chunk = rk.ring_decode, rk.RING_CHUNK
    rcases, rmax = 0, 0.0
    for r in (1, 3, 4, 8):
        for h in (1, 16):
            for hd in (12, 128, 130, 256):
                for l in RING_LENGTHS:
                    for tail in ((0, chunk) if l > chunk else (0,)):
                        args = ring_inputs(r, l, h, hd, rcases, dev, tail)
                        got = ring(*args)
                        want = rref.ring_decode_attention_ref(*args)
                        torch.cuda.synchronize()
                        err = float((got - want).abs().max())
                        what = (f"R={r} H={h} hd={hd} L={l}"
                                + (" (valid slots in the last chunk only)"
                                   if tail else ""))
                        check(torch.allclose(got, want, rtol=1e-5,
                                             atol=1e-5),
                              f"ring_decode != plain at {what} (max abs "
                              f"err {err})")
                        for i in range(r):
                            one = ring(*(a[i:i + 1] for a in args))
                            check(torch.equal(got[i:i + 1], one),
                                  f"ring_decode row {i} of {what} != its "
                                  f"one-row call")
                        rmax = max(rmax, err)
                        rcases += 1
    return {"cases": rcases, "max_abs_err": rmax}


# the pipes of the draw's bound, as Hopper's SM sub-partitions split them:
# the integer / logic pipe, which also takes float compares, selects and
# min / max (16 lanes a sub-partition); the fused multiply-add pipes
# (float32 add, multiply and FMA, and the integer multiply-add); the
# special-function unit; anything else (conversions, moves between
# files, control) is "other"
DRAW_PIPES = {
    "alu": ("IADD3", "IADD", "IADD32I", "VIADD", "LOP3", "LOP", "LOP32I",
            "SHF", "SHL", "SHR", "ISETP", "LEA", "SEL", "PRMT", "IMNMX",
            "IABS", "FLO", "POPC", "BREV", "BMSK", "MOV", "FSETP", "FSEL",
            "FSET", "FMNMX", "FCHK"),
    "fma": ("FADD", "FADD32I", "FMUL", "FMUL32I", "FFMA", "FFMA32I", "IMAD",
            "IMUL", "HFMA2", "HADD2", "HMUL2", "FRND"),
    "mufu": ("MUFU",),
}
# a register or predicate operand (R7, -R9, |R6|, !P0, R8.64); not RZ, PT
# or the uniform datapath's UR / UP, which hold no per-normal value
_DRAW_REG = re.compile(r"(?<![\w.])([RP]\d+)")


@dataclasses.dataclass(frozen=True)
class DrawTrip:
    """A trip through threefry_normal_kernel's grid-stride loop, read off
    its SASS (`draw_trip_of`): every instruction a trip in the bulk of a
    draw runs (`trip`, a diagnostic: the index, divide, address, store
    and loop-control instructions of the kernel's layout included), the
    normals it computes (`normals`, from the bytes it stores, 4 a normal),
    its store instructions, and a normal's own work by pipe (DRAW_PIPES,
    "other" and "all"; the trip's own work over `normals`): on the trip
    (`work`) and on the side of erf_inv's branch the bulk leaves, which a
    warp also runs when one of its lanes takes it (`tail`)."""
    trip: int
    normals: int
    stores: int
    work: dict
    tail: dict

    def own(self) -> float:
        """A normal's own instructions on the trip."""
        return self.work["all"]

    def layout(self) -> float:
        """A normal's share of the trip's other instructions."""
        return self.trip / self.normals - self.work["all"]


# the trip of the kernel's first design (one normal a trip, a 64-bit
# i / n divide a normal), as draw_trip_of reads its CUDA 12.9 listing:
# the bound the redesign is held to beside its own
DRAW_TRIP_FIRST = DrawTrip(
    trip=230, normals=1, stores=1,
    work={"alu": 84, "fma": 78, "mufu": 1, "other": 5, "all": 168},
    tail={"alu": 2, "fma": 6, "mufu": 1, "other": 1, "all": 10})


def _sass_target(ins, index) -> int:
    """The index of a branch's target in its function (-1: none)."""
    hexes = re.findall(r"\b0x([0-9a-f]+)\b", " ".join(ins.operands))
    return index.get(int(hexes[-1], 16), -1) if hexes else -1


def _stores(insns, seq) -> bool:
    return any(insns[k].base == "STG" for k in seq)


def _holds_root(insns, seq) -> bool:
    """Whether `seq` holds erf_inv's square root (its MUFU.RSQ)."""
    return any(insns[k].opcode.startswith("MUFU.RSQ") for k in seq)


def _draw_walk(insns, index, i, end, join=-1):
    """(path, tails) of a trip in the bulk from index i up to `end`: the
    instructions in order, and the sides of branches it leaves that hold
    erf_inv's square root, each as (its start in the path, its
    instructions).  An if-then block runs unless it calls out (a slow
    path for special operands, which no drawn value reaches) or holds the
    square root (erf_inv's tail side) or stores after a store on the
    path (a ragged row end's scalar stores after a vector one that ran);
    of an if / else the side without a call runs, and of two such the one
    without the square root, or else the shorter (a vector store before
    the scalar ones).  Inside the first side of an if / else, a branch to
    its `join` skips to the side's end.  None where a call lies on every
    way through."""
    path, tails = [], []

    def take(sub):
        tails.extend((len(path) + at, side) for at, side in sub[1])
        path.extend(sub[0])
    while i < end:
        ins = insns[i]
        if ins.base in ("CALL", "CAL"):
            return None
        path.append(i)
        if ins.base in ("JMP", "RET", "BRX") or (
                ins.base == "EXIT" and not ins.guard):
            raise ValueError(f"{ins.text()} inside the loop's trip")
        if ins.base != "BRA":
            i += 1
            continue
        t = _sass_target(ins, index)
        if t == join > end:
            t = end
        elif not i < t <= end:
            raise ValueError(f"{ins.text()} leaves the loop's trip")
        last = insns[t - 1]
        j = (_sass_target(last, index) if last.base == "BRA"
             and not last.guard and t < end else -1)
        if not ins.guard:
            i = t
        elif j <= t:                            # if-then
            block = _draw_walk(insns, index, i + 1, t)
            if block is not None and _holds_root(insns, block[0]):
                tails.append((len(path), block[0]))
            elif block is not None and not (
                    _stores(insns, path) and _stores(insns, block[0])):
                take(block)
            i = t
        else:                                   # if / else, joining at j
            a = _draw_walk(insns, index, i + 1, t - 1, j)
            b = _draw_walk(insns, index, t, j)
            sides = [s for s in ((a[0] + [t - 1], a[1]) if a else None, b)
                     if s is not None]
            if not sides:
                return None
            sides.sort(key=lambda s: (_holds_root(insns, s[0]), len(s[0])))
            at = len(path)
            take(sides[0])
            if len(sides) == 2 and _holds_root(insns, sides[1][0]):
                tails.append((at, sides[1][0]))
            i = j
    return path, tails


def _stored_bytes(ins) -> int:
    return 16 if ".128" in ins.opcode else 8 if ".64" in ins.opcode else 4


def draw_trip_of(insns) -> DrawTrip:
    """The trip through threefry_normal_kernel's grid-stride loop
    (`insns`, the kernel's SASS): the loop runs from the target of its one
    backward branch to that branch, a trip in the bulk takes
    `_draw_walk`'s way, it computes as many normals as its stores write
    words, and a normal's own work is what the keys reach, over them:
    every instruction that reads a value computed from a stream's key (the
    key loads seed it) or is guarded by such a predicate - the key
    schedule, the threefry rounds, the bits' uniform, log1p, the IEEE
    divide, the log, erf_inv (its square root on the tail side) and the
    scale.  The key loads and the stores are the bound's bytes; the unit's
    index, the stream's divide, the addresses, the loop control and the
    constants the compiler moves into registers read no key, and are the
    layout's, not the function's.  Raises ValueError where the code has
    another shape: no store, or not one square-root side a normal."""
    index = {ins.addr: k for k, ins in enumerate(insns)}
    backs = [k for k, ins in enumerate(insns) if ins.base == "BRA"
             and -1 < _sass_target(ins, index) < k]
    if len(backs) != 1 or not insns[backs[0]].guard:
        raise ValueError(f"not one guarded backward branch: "
                         f"{[insns[k].text() for k in backs]}")
    b = backs[0]
    h = _sass_target(insns[b], index)
    walked = _draw_walk(insns, index, h, b)
    if walked is None:
        raise ValueError("a call on every trip of the loop")
    path, tails = walked[0] + [b], walked[1]
    stores = [insns[k] for k in path if insns[k].base == "STG"]
    normals = sum(_stored_bytes(s) for s in stores) // 4
    if not normals:
        raise ValueError("no store on the loop's trip")

    def own(seq, keyed):
        counts = dict.fromkeys(list(DRAW_PIPES) + ["other"], 0)
        for k in seq:
            ins = insns[k]
            ops = list(ins.operands)
            if not ops or ins.base.startswith(("ST", "BRA", "BSSY",
                                               "BSYNC", "EXIT")):
                n_dst = 0
            elif len(ops) > 1 and re.fullmatch(r"P(\d|T)", ops[1]):
                n_dst = 2         # a result and a predicate: carry, compare
            else:
                n_dst = 1
            dst = set(_DRAW_REG.findall(" ".join(ops[:n_dst])))
            wide = (4 if ".128" in ins.opcode else 2 if ".WIDE" in ins.opcode
                    or ".64" in ins.opcode else 1)
            if dst and re.fullmatch(r"R\d+", ops[0].split(".")[0]):
                first = int(ops[0][1:].split(".")[0])
                dst |= {f"R{first + w}" for w in range(1, wide)}
            src = set(_DRAW_REG.findall(" ".join(ops[n_dst:]) + " "
                                        + ins.guard))
            if ins.base == "LDG":
                keyed |= dst
            elif src & keyed:
                keyed |= dst
                if not ins.base.startswith("ST"):
                    pipe = next((p for p, names in DRAW_PIPES.items()
                                 if ins.base in names), "other")
                    counts[pipe] += 1
            elif not ins.guard:
                keyed -= dst
        return counts

    def add(into, counts):
        for p_, v in counts.items():
            into[p_] += v
    if len(tails) != normals:
        raise ValueError(f"the bulk should leave one side a normal, "
                         f"erf_inv's square root; it leaves {len(tails)} "
                         f"for {normals} normals")
    keyed: set = set()
    work = dict.fromkeys(list(DRAW_PIPES) + ["other"], 0)
    tail = dict(work)
    pos = 0
    for at, side in sorted(tails, key=lambda t: t[0]):
        add(work, own(path[pos:at], keyed))
        add(tail, own(side, set(keyed)))
        pos = at
    add(work, own(path[pos:], keyed))
    for counts in (work, tail):
        counts["all"] = sum(counts.values())
        for p_ in counts:
            counts[p_] /= normals
    return DrawTrip(trip=len(path), normals=normals, stores=len(stores),
                    work=work, tail=tail)


def draw_bound_ms(streams: int, n: int, trip: DrawTrip,
                  tail_share: float) -> tuple:
    """Least time (ms) of one threefry_normal call and what bounds it: the
    keys read and the normals written once, against a normal's own
    instructions (`trip.work`, and `trip.tail` in the `tail_share` of
    warps that hold a normal on erf_inv's tail) over PEAK_INSTRUCTIONS,
    and those on the integer / logic pipe and on the fused multiply-add
    pipes over their rates (64 and 128 lanes an SM: the int32 rate, and
    half the 67 TFLOP/s, an FFMA counting two).  Returns (ms, "bytes" or
    "operations", each term's ms)."""
    total = streams * n
    per = {k: trip.work[k] + tail_share * trip.tail[k] for k in trip.work}
    terms = {"bytes": costs.threefry_normal(streams, n).bytes / PEAK_BYTES,
             "instructions": per["all"] * total / PEAK_INSTRUCTIONS,
             "alu": per["alu"] * total / PEAK_INT32_OPS,
             "fma": 2 * per["fma"] * total / PEAK_F32_OPS}
    worst = max(terms, key=terms.get)
    return (1e3 * terms[worst], "bytes" if worst == "bytes"
            else "operations", {k: 1e3 * v for k, v in terms.items()})


def draw_checks(dev) -> dict:
    """threefry_normal against its plain version on the card (and the
    host's run where it is small enough), bit for bit, one launch a call,
    over DRAW_STREAMS x DRAW_LENGTHS; keys from key, fold_in (an id above
    2^31) and split.  Then normal_of_bits against the plain float chain
    (`core/prng._normal_from_bits`) on all 2^23 bit patterns, bit for
    bit, in one launch."""
    from repro_torch.core import prng
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.kernels.prng.ref import threefry_normal_ref
    base = prng.key(7)
    keys = torch.cat([base[None], prng.fold_in(base, 2**31 + 5)[None],
                      prng.split(base, max(DRAW_STREAMS) - 2)])
    cases, host = 0, 0
    for streams in DRAW_STREAMS:
        for n in DRAW_LENGTHS:
            if streams * n > DRAW_MAX:
                continue
            k = keys[:streams]
            before = pk.threefry_normal.launches
            got = pk.threefry_normal(k.to(dev), n)
            torch.cuda.synchronize()
            check(pk.threefry_normal.launches == before + 1,
                  f"threefry_normal ({streams}, {n}): launches rose by "
                  f"{pk.threefry_normal.launches - before}")
            check(torch.equal(got, threefry_normal_ref(k.to(dev), n)),
                  f"threefry_normal != plain on the card at ({streams}, {n})")
            if streams * n <= DRAW_HOST_MAX:
                check(torch.equal(got.cpu(), threefry_normal_ref(k, n)),
                      f"threefry_normal != the host's draw at "
                      f"({streams}, {n})")
                host += 1
            cases += 1
            del got
    # every pattern a normal can come from (it reads bits >> 9), through
    # the draw's own device code: what licenses the cuts of code no
    # pattern reaches (threefry_normal.cu's header)
    bits = torch.arange(1 << 23, dtype=torch.int64, device=dev) << 9
    got = pk.normal_of_bits(bits).view(torch.int32)
    want = prng._normal_from_bits(bits).view(torch.int32)
    torch.cuda.synchronize()
    wrong = int((got != want).sum())
    check(torch.equal(got, want),
          f"normal_of_bits != _normal_from_bits on {wrong} of the 2^23 "
          f"patterns, first at m = "
          f"{int((got != want).nonzero()[0]) if wrong else -1}")
    del bits, got, want
    return {"cases": cases, "host_cases": host, "patterns": 1 << 23,
            "max_abs_err": 0.0}


def lenet_noise_phase(dev, tag, make_dataset, cnn, kern, kmod) -> dict:
    """Noisy LeNet serving at full width (module docstring, phase 4)."""
    from repro_torch.core import prng
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.runtime.program import request_noise_ids
    draw = pk.threefry_normal
    n_img = LENET_BATCH + sum(REQUESTS)
    images = torch.from_numpy(make_dataset(n_train=1, n_test=n_img,
                                           seed=0)[2][..., None])
    x = images[:LENET_BATCH]
    reqs, s = [], LENET_BATCH
    for b in REQUESTS:
        reqs.append(images[s:s + b])
        s += b
    key, key2 = prng.key(1), prng.key(2)
    out = {"launches": {"cim_mbiw": 0, "cim_mbiw_tc": 0,
                        "cim_mbiw_splitk": 0, "threefry_normal": 0}}
    for r_in, r_w in PRECISIONS:
        cim = CIMConfig(r_in=r_in, r_w=r_w, noise=NoiseConfig())
        params = cnn.lenet_params_list(
            cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
        prog = cnn.lenet_program(LENET_BATCH, cim=cim)
        bound = prog.bind(params)
        plan = prog.plan
        # the main path: every count to 0 just before, read just after
        reset_counts(kern)
        draw.launches = 0
        y = bound.serve(x, key)
        torch.cuda.synchronize()
        got = kernel_counts(kern) + (draw.launches,)
        want = kmod.route_counts(plan.tile_calls(LENET_BATCH))
        check(got == (plan.total_macro_evals, want["tc"], want["splitk"],
                      len(plan.layers)),
              f"noisy LeNet ({r_in},{r_w}): launches (cim_mbiw, tc, splitk, "
              f"threefry_normal) {got} != planned tiles {want} and one draw "
              f"a layer ({len(plan.layers)})")
        for name, v in zip(out["launches"], got):
            out["launches"][name] += v
        check(tuple(y.shape) == (LENET_BATCH, 10)
              and bool(torch.isfinite(y).all()), "noisy logits")
        check(torch.equal(y, bound.reference(x, key)),
              f"noisy LeNet ({r_in},{r_w}): card != card reference")
        host = cnn.lenet_program(LENET_BATCH, cim=cim, device="cpu")
        check(torch.equal(y.cpu(), host.bind(params).serve(x, key)),
              f"noisy LeNet ({r_in},{r_w}): card != CPU run")
        check(torch.equal(y, bound.serve(x, key)), "same key, other logits")
        clean_prog = cnn.lenet_program(
            LENET_BATCH, cim=cim.replace(noise=NoiseConfig(enabled=False)))
        clean = clean_prog.bind(params)
        y0 = clean.serve(x)
        check(not torch.equal(y, bound.serve(x, key2))
              and not torch.equal(y, y0),
              "a second key or the clean run gave the same logits")
        # identity-keyed isolation: each request as it is served alone
        reset_counts(kern)
        draw.launches = 0
        ys = bound.serve_batch(reqs, key, isolate=True)
        torch.cuda.synchronize()
        got_b = kernel_counts(kern) + (draw.launches,)
        for name, v in zip(out["launches"], got_b):
            out["launches"][name] += v
        check(got_b[3] == len(plan.layers),
              f"isolated serve_batch: {got_b[3]} draws != one a layer")
        for i, (yi, xi) in enumerate(zip(ys, reqs)):
            solo = bound.serve(xi, key, segments=torch.zeros(
                xi.shape[0], dtype=torch.int64),
                noise_ids=request_noise_ids(i, xi.shape[0]))
            check(torch.equal(yi, solo),
                  f"isolated request {i} != its solo noisy serve")
        # Monte-Carlo sweep over split(key, MC_TRIALS), as the JAX
        # engine's monte_carlo loops, at noise scales MC_SCALES
        top0 = torch.argmax(y0, dim=-1)
        trials = prng.split(key, MC_TRIALS)
        agree = {}
        for sc in MC_SCALES:
            point = NoiseConfig(thermal_rms_lsb8=0.52 * sc,
                                sa_sigma_v=0.020 * sc)
            ys_mc = [bound.serve(x, k, point) for k in trials]
            check(torch.equal(ys_mc[0], bound.serve(x, trials[0], point)),
                  f"MC trial 0 at scale {sc} did not repeat")
            agree[str(sc)] = [float((torch.argmax(t, -1) == top0).float()
                                    .mean()) for t in ys_mc]
        lat = {"noisy": [], "clean": []}
        for _ in range(15):
            for name, fn in (("noisy", lambda: bound.serve(x, key)),
                             ("clean", lambda: clean.serve(x))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                lat[name].append(1e3 * (time.perf_counter() - t0))
        med = {k: statistics.median(v[3:]) for k, v in lat.items()}
        prof = device_profile(lambda: bound.serve(x, key), 5,
                              groups=("cim_mbiw", "threefry_normal"))
        rec = {"median_ms": med, "latencies_ms": lat, "profile": prof,
               "mc_top1_agreement": agree,
               "launches_per_forward": dict(zip(
                   ("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk",
                    "threefry_normal"), got))}
        out[f"{r_in},{r_w}"] = rec
        share = (f"profiled noisy forward: device {prof['device_us']:.1f} "
                 f"us, threefry_normal {prof['threefry_normal_us']:.1f} us "
                 f"({100 * prof['threefry_normal_us'] / prof['device_us']:.1f}"
                 f"%), cim_mbiw {prof['cim_mbiw_us']:.1f} us" if prof
                 else "device time not measured (profiler saw none)")
        print(f"noise lenet ({r_in},{r_w}) {tag}: batch {LENET_BATCH} noisy "
              f"logits == card reference == CPU run (bit for bit), same key "
              f"repeats, key 2 and clean differ; isolated serve_batch "
              f"{list(REQUESTS)} == solo serves; launches per forward "
              f"{rec['launches_per_forward']} (tiles in raw-dp mode on "
              f"route_for's routes, one draw a layer); MC top-1 agreement "
              f"with clean over {MC_TRIALS} trials, scale: " + "; ".join(
                  f"{sc} mean {np.mean(v):.4f}" for sc, v in agree.items())
              + f"; median serve noisy {med['noisy']:.3f} ms, clean "
              f"{med['clean']:.3f} ms; {share}", flush=True)
    return out


def noisy_decode_phase(dev, tag, kern) -> dict:
    """Noisy in-flight decode at OLMo-1B widths, depth NOISE_DECODE_DEPTH
    (module docstring, phase 6): every fused stream == its solo decode
    under the key, the streams differ from the clean model's."""
    from repro_torch.core import prng
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.runtime import engine as rt
    from repro_torch.runtime.scheduler import (CIMDecodeLM,
                                               InflightScheduler, Request,
                                               decode_sequential)
    draw = pk.threefry_normal
    key = prng.key(0)
    models = {}
    for name, noise in (("noisy", NoiseConfig()),
                        ("clean", NoiseConfig(enabled=False))):
        models[name] = CIMDecodeLM.toy(
            torch.Generator().manual_seed(0), depth=NOISE_DECODE_DEPTH,
            r_in=DECODE_POINTS[""][0], r_w=DECODE_POINTS[""][1],
            cfg=rt.EngineConfig(noise=noise), **DECODE_WIDTHS)
    model = models["noisy"]
    rng = np.random.default_rng(1)
    reqs = [Request(u, tuple(int(t) for t in rng.integers(
        0, model.vocab, size=int(rng.integers(1, 4)))),
        int(rng.integers(2, 5))) for u in range(NOISE_DECODE_REQUESTS)]
    arrivals = [(i // 2, r) for i, r in enumerate(reqs)]
    reset_counts(kern)
    draw.launches = 0
    sched = InflightScheduler(model, capacity=DECODE_CAPACITY, key=key)
    # the engine's draws as it makes them: (streams, n) of each call, for
    # the times phase's draw at this path's shape
    shapes: dict = {}

    def recorded(keys, n):
        shape = (int(keys.shape[0]), int(n))
        shapes[shape] = shapes.get(shape, 0) + 1
        return draw(keys, n)
    rt.threefry_normal = recorded
    try:
        t0 = time.perf_counter()
        streams = sched.run(arrivals)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        rt.threefry_normal = draw
    launches = {"cim_mbiw": kern.launches,
                "cim_mbiw_splitk": kern.launches_splitk,
                "threefry_normal": draw.launches}
    calls = sum(len(r.prompt) for r in reqs) + sched.decode_steps
    projections = 4 * NOISE_DECODE_DEPTH
    check(launches["threefry_normal"] == projections * calls,
          f"noisy decode: {launches['threefry_normal']} draws != one a "
          f"projection call ({projections} x {calls} calls)")
    check(launches["cim_mbiw_splitk"] == launches["cim_mbiw"] > 0,
          "noisy decode tiles off the split-K route")
    for r in reqs:
        check(decode_sequential(model, r, key) == streams[r.uid],
              f"noisy request {r.uid}: fused stream != solo decode")
    clean = InflightScheduler(models["clean"], capacity=DECODE_CAPACITY)
    clean_streams = clean.run(arrivals)
    check(clean_streams != streams, "noisy streams equal the clean ones")
    met = sched.metrics()
    check(sum(shapes.values()) == launches["threefry_normal"],
          f"noisy decode: the engine made {shapes} draws, the kernel "
          f"launched {launches['threefry_normal']}")
    draw_shape = max(shapes, key=shapes.get)
    rec = {"depth": NOISE_DECODE_DEPTH, "draw_shape": draw_shape,
           "draw_shapes": {f"{s_}x{n_}": c for (s_, n_), c in shapes.items()},
           "requests": [
        (r.uid, r.prompt, r.max_new_tokens) for r in reqs],
        "streams": {str(u): t for u, t in streams.items()},
        "clean_streams": {str(u): t for u, t in clean_streams.items()},
        "launches": launches, "run_s": run_s, "metrics": met,
        "clean_metrics": clean.metrics()}
    print(f"noise decode {tag}: OLMo-1B widths, depth {NOISE_DECODE_DEPTH}, "
          f"point {DECODE_POINTS['']}, {len(reqs)} requests at capacity "
          f"{DECODE_CAPACITY} under key(0): every fused stream == "
          f"decode_sequential(..., key), streams differ from the clean "
          f"model's; launches {launches} (one draw per projection call; "
          f"the engine's draws (streams, n): count {rec['draw_shapes']}, "
          f"the most common {draw_shape}); "
          f"fused steps {met['decode_steps']:.0f} in "
          f"{met['decode_wall_s']:.1f} s noisy, "
          f"{rec['clean_metrics']['decode_wall_s']:.1f} s clean "
          f"({rec['clean_metrics']['decode_steps']:.0f} steps)", flush=True)
    del models, model, sched
    return rec


def family_tiles(cfg, layers: int, rows: int, kmod, tprog,
                 enc_rows: int = 0) -> dict:
    """Planned cim_mbiw launches of one engine forward of `layers` layers
    of a model family at `rows` token rows, per route.  A decoder layer:
    the four attention projections at the rows' bucket, and the FFN: an
    MLP (gate and up, or up alone, and down) at the same bucket, or an
    MoE block's 2E (d -> d_ff) and E (d_ff -> d) expert serves at the
    bucket of its capacity.  An ssm layer: in_proj and out_proj.  The
    hybrid family: per block of 3, two RG-LRU layers (w_gelu, w_rnn,
    w_out and the MLP) and a local-attention layer (the four projections
    and the MLP), then the tail's RG-LRU layers.  The audio family: a
    decoder layer's self-attention, its cross-attention's q and o and
    its MLP at the rows' bucket; with `enc_rows` (a prefill over that
    many frame rows) also the encoder's layers (attention and MLP) and
    each decoder layer's cross-attention k and v at that bucket."""
    from repro_torch.core import mapping
    from repro_torch.core.cim_layers import _engine_config
    from repro_torch.models.mamba2 import ssm_dims
    from repro_torch.models.moe import capacity
    d, c = cfg.d_model, cfg.cim
    ffn_rows, e, g = rows, 1, 2 if cfg.gated_mlp else 1
    if cfg.family == "moe":
        e, g = cfg.moe_experts, 2
        ffn_rows = capacity(rows, e, cfg.moe_top_k, cfg.moe_capacity_factor)
    # (projections (k, n), rows, layers that run them)
    if cfg.family == "ssm":
        d_inner, _, _, proj_out = ssm_dims(d, cfg.ssm_expand,
                                           cfg.ssm_headdim, cfg.ssm_state)
        groups = [([(d, proj_out), (d_inner, d)], rows, layers)]
    else:
        qn = cfg.n_heads * cfg.resolved_head_dim
        kvn = cfg.n_kv_heads * cfg.resolved_head_dim
        attn = [(d, qn), (d, kvn), (d, kvn), (qn, d)]
        ffn = [(d, cfg.d_ff)] * g * e + [(cfg.d_ff, d)] * e
        if cfg.family == "hybrid":
            nb, tail = divmod(layers, 3)
            w = cfg.lru_width or d
            groups = [(attn, rows, nb), (ffn, rows, layers),
                      ([(d, w), (d, w), (w, d)], rows, 2 * nb + tail)]
        elif cfg.family == "audio":
            groups = [(attn + [(d, qn), (qn, d)] + ffn, rows, layers)]
            if enc_rows:
                groups += [(attn + ffn, enc_rows, cfg.encoder_layers),
                           ([(d, kvn), (d, kvn)], enc_rows, layers)]
        else:
            groups = [(attn, rows, layers), (ffn, ffn_rows, layers)]
    total = {"tc": 0, "splitk": 0, "cuda_core": 0}
    for shapes, m, count in groups:
        bucket = tprog.DEFAULT_BUCKETS.bucket_for(m)
        for k, n in shapes:
            prog = tprog.compile_program(
                [mapping.LayerSpec(m=bucket, k=k, n=n, r_in=c.r_in,
                                   r_w=c.r_w, r_out=c.r_out)],
                _engine_config(c), device="cuda")
            for r, v in kmod.route_counts(
                    prog.plan.tile_calls(bucket)).items():
                total[r] += count * v
    return total


class BindClock:
    """Wraps engine.bind_network to time each one-time bind (the weights'
    quantization, on the card for weights already there, and the copy to
    the card of those bound on the host)."""

    def __init__(self, trt):
        self.trt, self.seconds = trt, []

    def __enter__(self):
        self.orig = orig = self.trt.bind_network
        clock = self

        def bind_network(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            clock.seconds.append(time.perf_counter() - t0)
            return out
        self.trt.bind_network = bind_network
        return self

    def __exit__(self, *exc):
        self.trt.bind_network = self.orig


def llm_serve_phase(dev, tag, kern, kmod, tprog, trt, clock) -> dict:
    """The LM serving path through launch/serve.py (module docstring,
    phase 8): OLMo-1B at full width and depth in bf16, engine mode at
    (8, 4), static batch and in flight."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as ttf
    rec: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    args = serve.parser().parse_args(
        ["--arch", "olmo-1b", "--cim-mode", "engine", "--batch",
         str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT), "--gen-len",
         str(SERVE_GEN), "--seed", "0"])
    cfg, params, _ = serve.build(args)
    full = serve.get_config("olmo-1b")
    check(cfg.replace(cim=full.cim) == full and cfg.dtype == "bfloat16"
          and (cfg.cim.mode, cfg.cim.r_in, cfg.cim.r_w) == ("engine", 8, 4),
          f"serve config is not OLMo-1B's in bf16, engine at (8, 4): {cfg}")
    max_len = SERVE_PROMPT + SERVE_GEN + 8
    prompt = serve.make_prompt(cfg.vocab_size, SERVE_BATCH, SERVE_PROMPT, 0,
                               dev)
    rows = SERVE_BATCH * SERVE_PROMPT
    plan_pre = family_tiles(cfg, cfg.n_layers, rows, kmod, tprog)
    plan_dec = family_tiles(cfg, cfg.n_layers, SERVE_BATCH, kmod, tprog)

    # -- static batch: the launcher's loop, engine mode ----------------------
    cap_mark, cap_n0 = len(clock.seconds), trt.CAPTURE_COUNT["n"]
    reset_counts(kern)
    with BindClock(trt) as binds:
        eng = serve.static_serve(cfg, params, prompt, SERVE_GEN,
                                 max_len=max_len, keep_logits=True)
    torch.cuda.synchronize()
    launches = kernel_counts(kern)
    caps = clock.since(cap_mark)
    check(caps["captures"] == trt.CAPTURE_COUNT["n"] - cap_n0,
          "serve: capture clock and counter disagree")
    want_tc = plan_pre["tc"]
    want_b = plan_pre["splitk"] + SERVE_GEN * plan_dec["splitk"]
    check(launches == (want_tc + want_b, want_tc, want_b)
          and plan_pre["cuda_core"] == plan_dec["cuda_core"] == 0,
          f"serve: cim_mbiw launches (all, tc, splitk) {launches} != the "
          f"planned prefill {plan_pre} + {SERVE_GEN} x decode {plan_dec}")
    check(eng["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0},
          f"serve: decode loop after warm-up grew {eng['growth']}")
    toks = eng["tokens"]
    check(tuple(toks.shape) == (SERVE_BATCH, 1 + SERVE_GEN)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and all(bool(torch.isfinite(lg).all()) for lg in eng["logits"]),
          "serve: tokens or logits malformed")
    per_step_s = eng["decode_s"] / max(eng["steps"], 1)

    # one decode step with graphs against the same step with every
    # projection eager, from the same cache
    cache = eng["cache"]
    tok = toks[:, -1:].to(dev)
    snap = {k: v.clone() for k, v in cache["layers"]["kv"].items()}
    pos = cache["pos"].clone()

    def restore():
        cache["layers"]["kv"].update({k: v.clone() for k, v in snap.items()})
        cache["pos"] = pos.clone()

    def step():
        with torch.no_grad():
            lg = ttf.forward(cfg, params, tok, cache=cache)[0]
        torch.cuda.synchronize()
        return lg
    captures = trt.CAPTURE_COUNT["n"]
    t0 = time.perf_counter()
    graph_lg = step()
    graph_step_ms = 1e3 * (time.perf_counter() - t0)
    restore()
    with EagerServe(tprog, trt):
        t0 = time.perf_counter()
        eager_lg = step()
        eager_step_ms = 1e3 * (time.perf_counter() - t0)
    check(trt.CAPTURE_COUNT["n"] == captures,
          "serve: the graph / eager steps captured")
    check(torch.equal(graph_lg, eager_lg),
          "serve: decode step with graphs != the same step eager")
    restore()
    prof = device_profile(step, 1, cpu=False)
    restore()
    # a warm prefill (replays of the prefill graphs)
    c2 = ttf.init_cache(cfg, SERVE_BATCH, max_len=max_len, device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        ttf.forward(cfg, params, prompt, cache=c2)
    torch.cuda.synchronize()
    warm_prefill_ms = 1e3 * (time.perf_counter() - t0)
    del c2, cache, snap
    pool = graph_pool_bytes(tprog, dev)

    # engine == fakequant bit for bit: the JAX package's contract
    fq_cfg = cfg.replace(cim=cfg.cim.replace(mode="fakequant"))
    fq = serve.static_serve(fq_cfg, params, prompt, SERVE_GEN,
                            max_len=max_len, keep_logits=True)
    diff = [i for i, (a, b) in enumerate(zip(eng["logits"], fq["logits"]))
            if not torch.equal(a, b)]
    if diff:
        i = diff[0]
        d = (eng["logits"][i].float() - fq["logits"][i].float()).abs()
        check(False, f"serve: engine != fakequant at step {i} (0 = "
              f"prefill) of steps {diff}: {int((d > 0).sum())} logits "
              f"differ, max {float(d.max()):.4g}")
    check(torch.equal(eng["tokens"], fq["tokens"]),
          "serve: engine tokens != fakequant tokens")
    del fq
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev)
    rec["static"] = {
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
        "depth": cfg.n_layers, "launches": dict(zip(
            ("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"), launches)),
        "planned_prefill": plan_pre, "planned_decode_step": plan_dec,
        "prefill_first_s": eng["prefill_s"], "warm_s": eng["warm_s"],
        "prefill_warm_ms": warm_prefill_ms,
        "decode_steps": eng["steps"], "decode_s": eng["decode_s"],
        "decode_host_ms_per_step": 1e3 * per_step_s,
        "tokens_per_s": SERVE_BATCH / per_step_s,
        "graph_step_ms": graph_step_ms, "eager_step_ms": eager_step_ms,
        "binds": len(binds.seconds), "bind_s": sum(binds.seconds),
        "captures": caps, "graph_pool_bytes": pool, "peak_bytes": peak,
        "profile": prof, "tokens": toks.tolist(),
        "bound_cache": tprog.bound_cache_stats()}
    busy = (f"device {prof['device_us'] / 1e3:.1f} ms a step, busy "
            f"{100 * prof['device_busy']:.1f}% of a profiled "
            f"{prof['wall_us'] / 1e3:.0f} ms step; top "
            + ", ".join(f"{k[:40]} {v / 1e3:.1f} ms" for k, v in list(
                prof["top_kernels_us"].items())[:4])
            if prof else "device time not measured (profiler saw none)")
    print(f"llm_serve static {tag}: OLMo-1B (16 layers, d 2048, bf16) via "
          f"launch/serve.py --cim-mode engine at (8, 4), batch "
          f"{SERVE_BATCH}, prompt {SERVE_PROMPT}, gen {SERVE_GEN}: engine == "
          f"fakequant bit for bit (prefill and {SERVE_GEN} decode logits, "
          f"tokens); a decode step with graphs == the step eager; after "
          f"warm-up plans/captures/eager +0; cim_mbiw launches {launches} "
          f"(all, tc, splitk) = planned (prefill on the tensor cores, "
          f"decode split-K); {len(binds.seconds)} binds in "
          f"{sum(binds.seconds):.1f} s; {caps['captures']} captures in "
          f"{caps['seconds']:.1f} s; prefill {eng['prefill_s']:.2f} s first "
          f"(binds and captures), {warm_prefill_ms:.1f} ms warm; decode "
          f"{1e3 * per_step_s:.1f} ms a step host (graph step "
          f"{graph_step_ms:.1f}, eager {eager_step_ms:.1f}), "
          f"{SERVE_BATCH / per_step_s:.2f} tokens/s; {busy}; graph pool "
          f"{pool / 2**20:.1f} MiB, peak {peak / 2**30:.2f} GiB",
          flush=True)

    # -- in flight: depth cut to SERVE_INFLIGHT_DEPTH ------------------------
    icfg = cfg.replace(n_layers=SERVE_INFLIGHT_DEPTH,
                       cim=cfg.cim.replace(isolate_rows=True))
    iparams = dict(params, layers=params["layers"][:SERVE_INFLIGHT_DEPTH])
    reqs = serve.make_requests(cfg.vocab_size, SERVE_INFLIGHT_REQUESTS,
                               SERVE_PROMPT, SERVE_GEN, 0)
    cap_mark = len(clock.seconds)
    reset_counts(kern)
    fused = serve.inflight_serve(icfg, iparams, reqs, SERVE_INFLIGHT_SLOTS,
                                 max_len=max_len, device=dev)
    torch.cuda.synchronize()
    ilaunch = kernel_counts(kern)
    icaps = clock.since(cap_mark)
    check(fused["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0},
          f"serve inflight: the loop after warm-up grew {fused['growth']}")
    i_pre = family_tiles(icfg, icfg.n_layers, SERVE_PROMPT, kmod, tprog)
    i_dec = family_tiles(icfg, icfg.n_layers, SERVE_INFLIGHT_SLOTS, kmod,
                             tprog)
    want = len(reqs) * i_pre["splitk"] + fused["decode_steps"] * i_dec[
        "splitk"]
    check(ilaunch == (want, 0, want),
          f"serve inflight: cim_mbiw launches {ilaunch} != planned {want}, "
          f"all split-K")
    check(len(set(fused["slot"].values())) > 1, "serve inflight: no "
          "request ever shared a step")
    t0 = time.perf_counter()
    for r in reqs:
        solo = serve.inflight_serve(icfg, iparams, [dict(r, arrival=0)],
                                    SERVE_INFLIGHT_SLOTS, max_len=max_len,
                                    device=dev)
        check(solo["tokens"][r["uid"]] == fused["tokens"][r["uid"]],
              f"serve inflight: request {r['uid']} != its solo decode")
        check(len(fused["tokens"][r["uid"]]) == r["gen"],
              f"serve inflight: request {r['uid']} has the wrong length")
    solo_s = time.perf_counter() - t0
    itoks = sum(len(t) for t in fused["tokens"].values())
    rec["inflight"] = {
        "depth": SERVE_INFLIGHT_DEPTH, "slots": SERVE_INFLIGHT_SLOTS,
        "requests": len(reqs), "tokens": itoks,
        "decode_steps": fused["decode_steps"],
        "decode_s": fused["decode_s"], "wall_s": fused["wall_s"],
        "tokens_per_s_decode": itoks / fused["decode_s"],
        "launches": dict(zip(("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"),
                             ilaunch)),
        "captures": icaps, "solo_check_s": solo_s,
        "streams": {str(u): t for u, t in fused["tokens"].items()}}
    print(f"llm_serve inflight {tag}: depth {SERVE_INFLIGHT_DEPTH} (cut "
          f"from 16), {len(reqs)} requests at {SERVE_INFLIGHT_SLOTS} slots, "
          f"{itoks} tokens in {fused['decode_steps']} fused steps: every "
          f"request == its solo decode; after warm-up plans/captures/eager "
          f"+0; cim_mbiw {ilaunch} (all split-K) = planned; "
          f"{icaps['captures']} captures in {icaps['seconds']:.1f} s; "
          f"decode {itoks / fused['decode_s']:.2f} tokens/s over "
          f"{fused['decode_s']:.1f} s, wall {fused['wall_s']:.1f} s; solo "
          f"checks {solo_s:.1f} s", flush=True)
    rec["launches"] = {
        "cim_mbiw": launches[0] + ilaunch[0],
        "cim_mbiw_tc": launches[1] + ilaunch[1],
        "cim_mbiw_splitk": launches[2] + ilaunch[2]}
    del params, iparams, eng
    torch.cuda.empty_cache()
    return rec


def decode_requests(vocab: int, points=("", "quality")) -> list:
    """The decode schedule: numpy seed 0, DECODE_REQUESTS requests with
    prompts of 1-4 tokens, 1-6 new tokens, arrivals at steps 0-6, points
    alternating over `points`.  Returns [(arrival, uid, prompt,
    max_new_tokens, point)]."""
    rng = np.random.default_rng(0)
    out = []
    for uid in range(DECODE_REQUESTS):
        prompt = tuple(int(t) for t in
                       rng.integers(0, vocab, size=int(rng.integers(1, 5))))
        max_new = int(rng.integers(1, 7))
        out.append((int(rng.integers(0, 7)), uid, prompt, max_new,
                    points[uid % len(points)]))
    return out


def precision_phase(dev, tag, kern, kmod, tprog, trt, clock) -> dict:
    """Workload-adaptive precision serving (module docstring, phase 9):
    calibrate, assign, serve mixed points in flight at OLMo-1B widths;
    a noisy LeNet calibration and its ladder; the launcher's
    --precision-policy mixed."""
    import tempfile
    from repro_torch import precision as tpr
    from repro_torch.core import prng
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels.flash_attn import kernel as rmod
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    from repro_torch.runtime.scheduler import (CIMDecodeLM,
                                               InflightScheduler, Request,
                                               decode_sequential)
    ring, draw = rmod.ring_decode, pk.threefry_normal
    rec: dict = {}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "chiprun_out"))
    d, d_ff = DECODE_WIDTHS["d"], DECODE_WIDTHS["d_ff"]
    ev0 = tprog.program_cache_stats()["evictions"]
    cap_mark = len(clock.seconds)
    # the path's counts: every count to 0 just before, read just after
    reset_counts(kern)
    ring.launches = draw.launches = 0

    # -- independent calibration of OLMo-1B's four projections ----------------
    specs = serve.precision_specs(d, d_ff)
    cache = os.path.join(tmp.name, "profiles.json")
    kw = dict(n_trials=1, batch=PRECISION_CAL_BATCH, seed=0, label="olmo-1b",
              cache_path=cache, device=dev)
    runs0, plans0 = tpr.CALIBRATION_RUNS["n"], trt.PLAN_COUNT["n"]
    before = kernel_counts(kern)
    with BindClock(trt) as binds:
        t0 = time.perf_counter()
        prof = tpr.calibrate(specs, trt.EngineConfig(), **kw)
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t0
    cal_launches = tuple(a - b for a, b in zip(kernel_counts(kern), before))
    check(tpr.CALIBRATION_RUNS["n"] == runs0 + 1,
          "precision: the first calibration did not run")
    # a run per (projection, point) plus each projection's reference
    runs = len(specs) * (len(tpr.PRECISION_CHAIN) + 1)
    check(len(binds.seconds) == runs,
          f"precision: {len(binds.seconds)} binds != {runs} calibration runs")
    want = {"tc": 0, "splitk": 0, "cuda_core": 0}
    for spec in specs:
        for p in (tpr.BASE_POINT,) + tpr.PRECISION_CHAIN:
            plan = tprog.compile_program(
                [dataclasses.replace(spec, r_in=p[0], r_w=p[1])],
                device=dev).plan
            for r, v in kmod.route_counts(
                    plan.tile_calls(PRECISION_CAL_BATCH)).items():
                want[r] += v
    check(cal_launches == (sum(want.values()), want["tc"], want["splitk"]),
          f"precision: calibration launches (all, tc, splitk) "
          f"{cal_launches} != planned {want}")
    for i in range(len(specs)):
        check(prof.delta(i, tpr.BASE_POINT) == 0.0
              and prof.agreement(i, tpr.BASE_POINT) == 1.0
              and all(np.isfinite(prof.delta(i, p)) and prof.delta(i, p) >= 0
                      for p in prof.points),
              f"precision: projection {i} profile malformed: "
              f"{prof.layers[i]}")
    t0 = time.perf_counter()
    again = tpr.calibrate(specs, trt.EngineConfig(), **kw)
    hit_s = time.perf_counter() - t0
    check(tpr.CALIBRATION_RUNS["n"] == runs0 + 1
          and again.to_dict() == prof.to_dict(),
          "precision: the second calibration missed the profile cache")
    asg = {n: tpr.assign(prof, specs, f)
           for n, f in tpr.DEFAULT_BUDGETS.items()}
    points = {n: asg[n][0] for n in ("quality", "throughput")}
    rec["calibration"] = {
        "specs": [[s.m, s.k, s.n] for s in specs], "seconds": cal_s,
        "cache_hit_s": hit_s, "binds": len(binds.seconds),
        "bind_s": sum(binds.seconds),
        "plans": trt.PLAN_COUNT["n"] - plans0,
        "launches": dict(zip(("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"),
                             cal_launches)),
        "profile": prof.to_dict(),
        "assignments": {n: [list(map(list, a)), dl]
                        for n, (a, dl) in asg.items()}}
    print(f"precision calibration {tag}: OLMo-1B's four projections (qkv "
          f"{d}->{3 * d}, o {d}->{d}, gate_up {d}->{2 * d_ff}, down "
          f"{d_ff}->{d}; m 8, batch {PRECISION_CAL_BATCH}, clean) over "
          f"{list(tpr.PRECISION_CHAIN)}: {runs} runs, {len(binds.seconds)} "
          f"binds in {sum(binds.seconds):.1f} s, {cal_s:.1f} s in all; "
          f"cim_mbiw {cal_launches} (all, tc, splitk) = planned; the second "
          f"call hit the cache in {hit_s:.3f} s with an equal profile; "
          f"assign under {tpr.DEFAULT_BUDGETS}: " + "; ".join(
              f"{n} {list(a)} (delta {dl:.4g})" for n, (a, dl) in asg.items()),
          flush=True)

    # -- mixed-point in-flight decode at OLMo-1B widths -----------------------
    t0 = time.perf_counter()
    model = CIMDecodeLM.toy(torch.Generator().manual_seed(0),
                            depth=PRECISION_DEPTH, r_in=tpr.BASE_POINT[0],
                            r_w=tpr.BASE_POINT[1], points=points,
                            **DECODE_WIDTHS)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    names = tuple(points)
    sched_in = decode_requests(model.vocab, names)
    reqs = {u: Request(u, p, n, pt) for _, u, p, n, pt in sched_in}
    t0 = time.perf_counter()
    caps0 = trt.CAPTURE_COUNT["n"]
    serve.warm_up_points(model, names, DECODE_CAPACITY)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_caps = trt.CAPTURE_COUNT["n"] - caps0
    before = serve.counters()
    sched = InflightScheduler(model, capacity=DECODE_CAPACITY)
    t0 = time.perf_counter()
    streams = sched.run([(t, reqs[u]) for t, u, *_ in sched_in])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    growth = serve._growth(before, dev)
    check(growth == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0},
          f"precision: the in-flight run after warm-up grew {growth}")
    check(set(streams) == set(reqs), "precision: not every request finished")
    for u, r in reqs.items():
        check(len(streams[u]) == r.max_new_tokens
              and all(0 <= t < model.vocab for t in streams[u]),
              f"precision: request {u} stream {streams[u]} malformed")
        check(decode_sequential(model, r) == streams[u],
              f"precision: request {u} ({r.point!r}): fused != solo")
    check(serve._growth(before, dev) == growth,
          "precision: the solo decodes planned, captured or ran eagerly")
    met = sched.metrics()
    tops = {}
    for n in names:
        rep = sched.point_report(n)
        check(rep["operating_point"]["name"] == n
              and [(l["op"], lp.spec.r_in, lp.spec.r_w) for l, lp in zip(
                  rep["layers"], model.bound_for(n).plan.layers)]
              == [("dense",) + tuple(points[n][1])],
              f"precision: point_report({n!r}) is not the point's o "
              f"projection")
        tops[n] = rep["operating_point"]["tops_per_w"]
    rec["decode"] = {
        "depth": PRECISION_DEPTH, "points": {n: list(map(list, a))
                                             for n, a in points.items()},
        "bind_s": bind_s, "warm_s": warm_s, "warm_captures": warm_caps,
        "run_s": run_s, "metrics": met, "growth": growth,
        "macro_model_tops_per_w": tops, "requests": sched_in,
        "streams": {str(u): t for u, t in streams.items()}}
    print(f"precision decode {tag}: OLMo-1B widths, depth "
          f"{PRECISION_DEPTH}, points {points} over the same masters; bind "
          f"{bind_s:.1f} s; warm-up {warm_caps} captures in {warm_s:.1f} s; "
          f"{len(reqs)} requests at capacity {DECODE_CAPACITY}: every fused "
          f"stream == decode_sequential at its point; after warm-up "
          f"plans/captures/eager +0; tokens by point "
          f"{met['tokens_by_point']}, {met['tokens_per_s']:.3f} tokens/s "
          f"over {met['decode_steps']:.0f} fused steps; the o projection's "
          f"macro-model projection (IMAGINE silicon model, not the card) "
          + ", ".join(f"{n} {v:.2f} TOPS/W" for n, v in tops.items()),
          flush=True)
    del model, sched

    # -- noisy chained LeNet calibration and its ladder -----------------------
    lspecs, acts, pools = cnn.lenet_engine_specs(PRECISION_LENET_BATCH)
    ncfg = trt.EngineConfig(noise=NoiseConfig())
    d0 = draw.launches
    t0 = time.perf_counter()
    lprof = tpr.calibrate(lspecs, ncfg, n_trials=PRECISION_LENET_TRIALS,
                          batch=PRECISION_LENET_BATCH, seed=1,
                          activations=acts, pools=pools, cache_path="",
                          device=dev)
    torch.cuda.synchronize()
    lcal_s = time.perf_counter() - t0
    lruns = PRECISION_LENET_TRIALS * (1 + len(lspecs) * len(lprof.points))
    check(draw.launches - d0 == lruns * len(lspecs),
          f"precision: noisy LeNet calibration drew {draw.launches - d0} "
          f"times != one a layer in each of {lruns} runs")
    check(lprof.n_trials == PRECISION_LENET_TRIALS and lprof.chained
          and all(lprof.delta(i, tpr.BASE_POINT) == 0.0
                  for i in range(len(lspecs))),
          "precision: noisy LeNet profile malformed")
    ladder = tpr.plan_ladder(lprof, lspecs, activations=acts, pools=pools,
                             device=dev)
    hladder = tpr.plan_ladder(lprof, lspecs, activations=acts, pools=pools,
                              device="cpu")
    check(ladder.report() == hladder.report(),
          "precision: ladder report on the card != on the host")
    images = torch.from_numpy(make_dataset(n_train=1, n_test=LENET_BATCH,
                                           seed=0)[2][..., None])
    x = images.to(dev)
    rungs = {}
    for name in ladder.names():
        prog, hprog = ladder.program(name), hladder.program(name)
        params = prog.init_params(prng.key(2))
        bound = prog.bind(params)
        caps = trt.CAPTURE_COUNT["n"]
        y = bound.serve(x, point=name)
        check(trt.CAPTURE_COUNT["n"] == caps + 1,
              f"precision: rung {name!r} did not capture its graph")
        check(tuple(y.shape) == (LENET_BATCH, 10)
              and bool(torch.isfinite(y).all())
              and torch.equal(y, bound.serve(x, point=name))
              and torch.equal(y, bound.reference(x, point=name)),
              f"precision: rung {name!r} replay != card reference")
        check(torch.equal(y.cpu(), hprog.bind(params).serve(images,
                                                            point=name)),
              f"precision: rung {name!r} card != CPU run")
        lat = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bound.serve(x, point=name)
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t0))
        op = ladder.point(name)
        rungs[name] = {"assignment": [list(p) for p in op.assignment],
                       "predicted_delta": op.predicted_delta,
                       "macro_model_tops_per_w": op.predicted_tops_per_w,
                       "serve_ms": lat,
                       "median_serve_ms": statistics.median(lat[2:])}
    rec["lenet"] = {"calibration_s": lcal_s, "runs": lruns,
                    "profile": lprof.to_dict(), "rungs": rungs}
    print(f"precision lenet {tag}: noisy chained calibration "
          f"(NoiseConfig(), {PRECISION_LENET_TRIALS} trials, batch "
          f"{PRECISION_LENET_BATCH}) {lruns} runs in {lcal_s:.1f} s, one "
          f"draw a layer; ladder rungs at batch {LENET_BATCH} through their "
          f"graphs == card reference == CPU run (bit for bit): " + "; ".join(
              f"{n} {r['assignment']} median serve "
              f"{r['median_serve_ms']:.3f} ms, macro model "
              f"{r['macro_model_tops_per_w']:.2f} TOPS/W"
              for n, r in rungs.items()), flush=True)

    # -- the launcher: --precision-policy mixed --assert-no-recompile ---------
    os.environ["REPRO_PRECISION_PROFILES"] = os.path.join(tmp.name,
                                                          "launcher.json")
    t0 = time.perf_counter()
    out = serve.main(["--arch", "olmo-1b", "--cim-mode", "engine",
                      "--inflight", "--precision-policy", "mixed",
                      "--assert-no-recompile"])
    launcher_s = time.perf_counter() - t0
    del os.environ["REPRO_PRECISION_PROFILES"]
    check(out["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                   "eager_calls": 0},
          f"precision: the launcher grew {out['growth']}")
    tmp.cleanup()
    torch.cuda.synchronize()
    launches = kernel_counts(kern)
    rec["launcher"] = {"seconds": launcher_s, "points": out["points"],
                       "tokens_by_point": out["metrics"]["tokens_by_point"],
                       "macro_model_tops_per_w": out["tops_per_w"]}
    rec["launches"] = dict(zip(("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"),
                               launches), ring_decode=ring.launches,
                           threefry_normal=draw.launches)
    rec["captures"] = clock.since(cap_mark)
    rec["evictions"] = tprog.program_cache_stats()["evictions"] - ev0
    print(f"precision launcher {tag}: launch/serve.py --precision-policy "
          f"mixed --assert-no-recompile passed in {launcher_s:.1f} s "
          f"(points {out['points']}); phase launches {rec['launches']} "
          f"(cim_mbiw all, tc, splitk), {rec['captures']['captures']} "
          f"captures in {rec['captures']['seconds']:.1f} s, "
          f"{rec['evictions']} program-cache evictions", flush=True)
    return rec


# the tuner phase: LeNet at batch 256 at these points, OLMo-1B's four
# projections (d 2048, d_ff 8192; qkv, o, gate_up, down) at these points
# and at decode and prefill rows, one representative shape per route and
# plane count for the every-legal-tile check, and JAX's five pinned
# shapes of tests/test_tuner.py for the ranking
TUNE_LENET_POINTS = ((4, 2), (8, 4))
TUNE_PROJECTIONS = {"qkv": (2048, 6144), "o": (2048, 2048),
                    "gate_up": (2048, 16384), "down": (8192, 2048)}
TUNE_PROJ_POINTS = ((8, 4), (2, 2))
TUNE_PROJ_ROWS = (4, 128)
TUNE_TILE_SHAPES = (("A", 256, 784, 128, (4, 2)), ("A", 256, 784, 64, (8, 4)),
                    ("B", 4, 1024, 128, (4, 2)), ("B", 4, 1024, 64, (8, 4)),
                    ("C", 784, 9, 16, (4, 2)), ("C", 784, 9, 16, (8, 4)))
TUNE_RANK_SHAPES = ((64, 1152, 128), (96, 1152, 256), (128, 1152, 512),
                    (256, 1152, 512), (512, 1152, 1024))
TUNE_MODES = ("off", "analytic", "measure")


def spearman(a, b) -> float:
    """Rank correlation of two equal-length sequences (no ties expected)."""
    def rank(v):
        r = [0] * len(v)
        for pos, i in enumerate(sorted(range(len(v)), key=lambda i: v[i])):
            r[i] = pos
        return r
    ra, rb = rank(a), rank(b)
    n = len(a)
    return 1.0 - 6.0 * sum((x - y) ** 2 for x, y in zip(ra, rb)) / (
        n * (n * n - 1))


def tuned_calls(plan, batch: int, kmod) -> int:
    """cim_mbiw launches of one forward over `batch` samples that run a
    tuned tile: each tile call of a layer with `blocks` whose own route is
    the tile's (stream_rows 0: one dispatch a macro tile)."""
    n = 0
    for lp in plan.layers:
        if lp.blocks is None:
            continue
        g = lp.spec.conv
        rows = batch * (g.out_h * g.out_w if g is not None else 1)
        for _, ksz in lp.k_slices:
            if kmod.route_for(rows, lp.tile_n, ksz,
                              lp.precision.n_planes).name == lp.blocks[0]:
                n += len(lp.n_slices)
    return n


def tuner_phase(dev, tag, kern, kmod, tprog, trt) -> dict:
    """The schedule autotuner on the card (module docstring, phase 10)."""
    import tempfile
    import warnings
    from repro_torch import tuner as ttuner
    from repro_torch.core import prng
    from repro_torch.core.cim_layers import CIMConfig, _engine_config
    from repro_torch.core.hw import DEFAULT_MACRO
    from repro_torch.core.mapping import LayerSpec, map_layer
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels.cim_mbiw import ref as kref
    from repro_torch.models import cnn
    from repro_torch.tuner import search as tsearch
    rec: dict = {}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "chiprun_out"))

    def cache(mode: str) -> str:
        # one file a mode: the cache keys winners by layer, not by mode
        return os.path.join(tmp.name, f"{mode}.json")

    def event_ms(spec, choice) -> float:
        return 1e3 * tsearch._measure_choice_s(spec, choice, DEFAULT_MACRO,
                                               dev)

    # -- every legal tile of each route against the plain version ------------
    rng = np.random.default_rng(5)
    tile_rows = {}
    for label, m, k, n, (r_in, r_w) in TUNE_TILE_SHAPES:
        shift, planes_n = kmod.plane_layout(r_in)
        x = torch.from_numpy(rng.integers(0, 2 ** shift, (m, planes_n * k),
                                          dtype=np.int8)).to(dev)
        half = 2 ** (r_w - 1)
        w = torch.from_numpy((2 * rng.integers(-half, half, (k, n))
                              + 1).astype(np.int8)).to(dev)
        gamma = torch.from_numpy((2.0 ** rng.uniform(0, 5, (1, n))).astype(
            np.float32)).to(dev)
        beta = torch.from_numpy(rng.uniform(-16, 16, (1, n)).astype(
            np.float32)).to(dev)
        tiles = kmod.legal_tiles(m, n, k, planes_n)
        check(bool(tiles) and {t[0] for t in tiles} == {
            kmod.route_for(m, n, k, planes_n).name},
            f"legal tiles of {(m, k, n)}: {tiles}")
        for fuse in (True, False):
            kw = dict(plane_shift=shift, g0=0.01, r_out=8, fuse_adc=fuse)
            want = kref.cim_mbiw_matmul_planes_ref(x, w, gamma, beta, **kw)
            for tile in tiles:
                got = kern(x, w, gamma, beta, tile=tile, **kw)
                check(torch.equal(got, want),
                      f"cim_mbiw at tile {tile} != plain at {(m, k, n)} "
                      f"P={planes_n} fuse_adc={fuse}")
        torch.cuda.synchronize()
        tile_rows[f"{label} {m}x{k}x{n} P{planes_n}"] = len(tiles)
    rec["legal_tiles_checked"] = tile_rows
    print(f"tuner {tag}: every legal tile == plain in both ADC modes "
          + ", ".join(f"{k_} ({v} tiles)" for k_, v in tile_rows.items()),
          flush=True)

    # -- the main path: LeNet at batch 256 and OLMo-1B's projections ---------
    reset_counts(kern)
    n0 = tsearch.SEARCH_COUNT["n"]
    images = torch.from_numpy(make_dataset(n_train=1, n_test=LENET_BATCH,
                                           seed=0)[2][..., None])
    lenet = {}
    tuned_expected = 0
    for r_in, r_w in TUNE_LENET_POINTS:
        cim = CIMConfig(r_in=r_in, r_w=r_w)
        specs, acts, pools = cnn.lenet_engine_specs(LENET_BATCH, cim=cim)
        cfg = _engine_config(cim)
        check(cfg.stream_rows == 0, "LeNet streams its rows")
        params = cnn.lenet_params_list(
            cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
        row = {"layers": [], "serve_ms": {}, "compile_s": {}}
        outs, ref = {}, None
        for mode in TUNE_MODES:
            t0 = time.perf_counter()
            prog = tprog.compile_program(
                specs, cfg, activations=acts, pools=pools, device=dev,
                tune=mode, tune_cache=cache(mode))
            row["compile_s"][mode] = time.perf_counter() - t0
            bound = prog.bind(params)
            before = kern.launches_tuned
            y = bound.serve(images)               # captures the graph
            lat = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y2 = bound.serve(images)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
            tuned_n = kern.launches_tuned - before
            want_n = 21 * tuned_calls(prog.plan, LENET_BATCH, kmod)
            tuned_expected += want_n
            check(tuned_n == want_n,
                  f"LeNet ({r_in},{r_w}) {mode}: {tuned_n} tuned launches "
                  f"!= {want_n} (21 forwards x the tuned tiles)")
            if any(lp.blocks is not None for lp in prog.plan.layers):
                check(tuned_n > 0, f"LeNet ({r_in},{r_w}) {mode}: a tuned "
                      "tile differs from route_for's but never ran")
            check(torch.equal(y, y2), f"LeNet {mode}: replay != first serve")
            if ref is None:
                ref = bound.reference(images)
            outs[mode] = y
            row["serve_ms"][mode] = 1e3 * statistics.median(lat[3:])
            row[f"plan_{mode}"] = [lp.blocks for lp in prog.plan.layers]
            row[f"launches_tuned_{mode}"] = tuned_n
            del bound
        for mode in TUNE_MODES:
            check(torch.equal(outs[mode], outs["off"])
                  and torch.equal(outs[mode], ref),
                  f"LeNet ({r_in},{r_w}) tune={mode} != tune=off / the "
                  f"plain reference")
        for i, spec in enumerate(specs):
            heur = ttuner.heuristic_choice(spec, cfg)
            lay = {"heuristic": heur.blocks,
                   "heuristic_s": ttuner.layer_cost(spec, heur).total_s,
                   "heuristic_card_s": ttuner.layer_cost(spec, heur).t_dma_s}
            for mode in ("analytic", "measure"):
                blocks = row[f"plan_{mode}"][i] or heur.blocks
                lc = ttuner.layer_cost(spec, ttuner.ScheduleChoice(*blocks))
                lay[mode] = {"tile": blocks, "predicted_s": lc.total_s,
                             "card_s": lc.t_dma_s,
                             "event_ms": event_ms(
                                 spec, ttuner.ScheduleChoice(*blocks))}
                check(lc.total_s <= lay["heuristic_s"],
                      f"LeNet layer {i} {mode}: tuned cost above the "
                      "heuristic's")
            lay["heuristic_event_ms"] = event_ms(spec, heur)
            row["layers"].append(lay)
        lenet[f"{r_in},{r_w}"] = row
        print(f"tuner lenet ({r_in},{r_w}) {tag}: batch {LENET_BATCH}, "
              "tune=off/analytic/measure bit-equal to each other and to "
              "the plain reference; layers (heuristic -> analytic / "
              "measure tile, card term us heuristic -> tuned, event us a "
              "dispatch): " + "; ".join(
                  f"{i}: {l_['heuristic']} -> {l_['analytic']['tile']} / "
                  f"{l_['measure']['tile']}, "
                  f"{1e6 * l_['heuristic_card_s']:.3f} -> "
                  f"{1e6 * l_['analytic']['card_s']:.3f}, "
                  f"{1e3 * l_['heuristic_event_ms']:.2f} -> "
                  f"{1e3 * l_['analytic']['event_ms']:.2f} / "
                  f"{1e3 * l_['measure']['event_ms']:.2f}"
                  for i, l_ in enumerate(row["layers"]))
              + "; launches_tuned " + ", ".join(
                  f"{m_} {row[f'launches_tuned_{m_}']}" for m_ in TUNE_MODES)
              + "; median serve ms " + ", ".join(
                  f"{m_} {v:.3f}" for m_, v in row["serve_ms"].items())
              + " (no gain claimed)", flush=True)
    rec["lenet"] = lenet

    projections = []
    g = torch.Generator(device=dev).manual_seed(3)
    for (r_in, r_w) in TUNE_PROJ_POINTS:
        for rows in TUNE_PROJ_ROWS:
            for name, (k, n) in TUNE_PROJECTIONS.items():
                spec = LayerSpec(m=rows, k=k, n=n, r_in=r_in, r_w=r_w)
                progs = {mode: tprog.compile_program(
                    [spec], trt.EngineConfig(), activations=("none",),
                    device=dev, tune=mode, tune_cache=cache(mode))
                    for mode in TUNE_MODES}
                params = progs["off"].init_params(
                    prng.fold_in(prng.key(0), rows).to(dev))
                x = torch.randn((rows, k), generator=g, device=dev)
                outs, bounds = {}, {}
                for mode, prog in progs.items():
                    if id(prog) not in bounds:
                        bounds[id(prog)] = prog.bind(params)
                    outs[mode] = bounds[id(prog)].serve(x)
                for mode in TUNE_MODES:
                    check(torch.equal(outs[mode], outs["off"]),
                          f"{name} ({r_in},{r_w}) rows {rows}: tune={mode} "
                          "!= tune=off")
                del bounds
                heur = ttuner.heuristic_choice(spec, trt.EngineConfig())
                evals = map_layer(spec).macro_evals
                row = {"name": name, "point": [r_in, r_w], "rows": rows,
                       "k": k, "n": n, "dispatches": evals,
                       "heuristic": heur.blocks,
                       "heuristic_event_ms": event_ms(spec, heur),
                       "heuristic_card_s": ttuner.layer_cost(
                           spec, heur).t_dma_s}
                for mode in ("analytic", "measure"):
                    lp = progs[mode].plan.layers[0]
                    ch = ttuner.ScheduleChoice(*(lp.blocks or heur.blocks))
                    row[mode] = {"tile": ch.blocks,
                                 "event_ms": event_ms(spec, ch),
                                 "card_s": ttuner.layer_cost(spec,
                                                             ch).t_dma_s}
                    check(ttuner.layer_cost(spec, ch).score()
                          <= ttuner.layer_cost(spec, heur).score()
                          or mode == "measure",
                          f"{name}: analytic tuned cost above heuristic's")
                projections.append(row)
    torch.cuda.synchronize()
    counts = kernel_counts(kern)
    rec["launches"] = dict(zip(("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"),
                               counts), cim_mbiw_tuned=kern.launches_tuned)
    rec["projections"] = projections
    rec["searches"] = tsearch.SEARCH_COUNT["n"] - n0
    print(f"tuner projections {tag}: OLMo-1B qkv/o/gate_up/down at "
          f"{TUNE_PROJ_POINTS} x rows {TUNE_PROJ_ROWS}, tune=analytic and "
          "measure bit-equal to off; event us a dispatch heuristic -> "
          "analytic / measure: " + "; ".join(
              f"{r['name']} ({r['point'][0]},{r['point'][1]}) M{r['rows']} "
              f"{r['heuristic'][0]}:{r['heuristic'][1:]} "
              f"{1e3 * r['heuristic_event_ms']:.2f} -> "
              f"{r['analytic']['tile'][1:]} "
              f"{1e3 * r['analytic']['event_ms']:.2f} / "
              f"{r['measure']['tile'][1:]} "
              f"{1e3 * r['measure']['event_ms']:.2f}" for r in projections)
          + f"; phase launches {rec['launches']}", flush=True)

    # -- the cache on the card ----------------------------------------------
    cim = CIMConfig(r_in=4, r_w=2)
    specs, acts, pools = cnn.lenet_engine_specs(LENET_BATCH, cim=cim)
    cfg = _engine_config(cim)
    n1 = tsearch.SEARCH_COUNT["n"]
    plan_hit, reps = ttuner.tune_network(specs, cfg, acts, pools,
                                         mode="analytic",
                                         cache_path=cache("analytic"),
                                         device=dev)
    check(tsearch.SEARCH_COUNT["n"] == n1
          and all(r["cache"] == "hit" for r in reps),
          f"second tune with the same file: {[r['cache'] for r in reps]}, "
          f"{tsearch.SEARCH_COUNT['n'] - n1} searches")
    check(plan_hit == tprog.compile_program(
        specs, cfg, activations=acts, pools=pools, device=dev,
        tune="analytic", tune_cache=cache("analytic")).plan,
        "the cache's hit plan != the tuned plan")
    bad = os.path.join(tmp.name, "corrupt.json")
    with open(bad, "w") as fh:
        fh.write("{ not json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        plan_bad, reps = ttuner.tune_network(specs, cfg, acts, pools,
                                             mode="analytic",
                                             cache_path=bad, device=dev)
    warned = [w_ for w_ in caught
              if issubclass(w_.category, ttuner.TuneCacheWarning)]
    with open(bad) as fh:
        kept = fh.read()
    check(len(warned) == 1 and all(r["cache"] == "invalid" for r in reps)
          and tsearch.SEARCH_COUNT["n"] == n1 and kept == "{ not json"
          and plan_bad == trt.plan_network(specs, cfg, acts, pools),
          "a corrupt cache did not warn once, run the heuristic and write "
          "nothing")
    rec["cache"] = {"hits": len(specs), "corrupt_warnings": len(warned)}

    # -- the analytic ranking against the card's event times ----------------
    predicted, measured = [], []
    for m, k, n in TUNE_RANK_SHAPES:
        spec = LayerSpec(m=m, k=k, n=n, r_in=4, r_w=2)
        heur = ttuner.heuristic_choice(spec, trt.EngineConfig())
        predicted.append(ttuner.layer_cost(spec, heur).total_s)
        measured.append(map_layer(spec).macro_evals * event_ms(spec, heur))
    rho = spearman(predicted, measured)
    rec["ranking"] = {"shapes": TUNE_RANK_SHAPES, "predicted_s": predicted,
                      "event_ms": measured, "spearman": rho}
    check(rho >= 0.7, f"Spearman {rho} < 0.7 between the analytic cost "
          f"{predicted} and the event ms {measured}")
    tmp.cleanup()
    print(f"tuner cache and ranking {tag}: a second tune with the same file "
          f"all hits ({len(specs)} layers, no search); a corrupt file warned "
          f"{len(warned)}x, ran the heuristic, wrote nothing; Spearman "
          f"{rho:.2f} between the analytic cost and the event ms of JAX's "
          f"five pinned shapes ({', '.join(f'{v:.4f}' for v in measured)} "
          f"ms); {rec['searches']} layers searched", flush=True)
    return rec


# the CIM-aware training path (phase 11): LeNet trained as
# examples/train_lenet_cim.py trains it, at the paper's 4b point; LeNet's
# convs through the engine; the Fig. 3(b) MLP sweep of
# benchmarks/fig3_abn_accuracy.py
CNN_BATCH = 256
CNN_POINT = (4, 2)
CNN_TRAIN, CNN_TEST = 4096, 1024
CNN_EPOCHS = 2
CNN_LR = 1e-3
CNN_EVAL = 128
CNN_CONV_GEOMETRIES = ((1, 1), (2, "SAME"), (1, "VALID"))
# step 0's conv ABN gain gradients, card against CPU: _close_grad's atol
# as a share of the largest (1e-5 for every other leaf).  The least atol
# they need grows with the rows summed: on an H100 it read 9.1e-6 /
# 1.2e-5 / 1.3e-5 (conv1) and 4.9e-6 / 1.2e-5 / 1.1e-4 (conv2) at batch
# 8 / 32 / 256; the limit is about twice the largest
CONV_GAINS = ("conv1/abn_log_gamma", "conv2/abn_log_gamma")
CONV_GAIN_ATOL = 2.5e-4
MLP_DIMS = (784, 128, 64, 10)
MLP_TRAIN, MLP_TEST, MLP_EPOCHS, MLP_LR = 2048, 512, 5, 2e-3
# the dense path (phase 12): the three dense configs at full width, depth
# cut to DENSE_LAYERS
DENSE_ARCHS = ("granite-8b", "minitron-4b", "qwen2-7b")
DENSE_LAYERS = 2
DENSE_SEQ = 512
DENSE_DECODE = 8


def least_atol(got: torch.Tensor, want: torch.Tensor) -> float:
    """The least atol, as a share of the largest |want|, at which
    `_close_grad` (rtol 1e-4) holds `got` against `want`."""
    g, w = got.double().cpu(), want.double().cpu()
    return max(0.0, float(((g - w).abs() - 1e-4 * w.abs()).max()
                          / max(float(w.abs().max()), 1e-30)))


def grad_ratio(got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """The largest |got - want| over tests/test_torch_fakequant.py's
    `_close_grad` limit (rtol 1e-4 plus atol x the largest |want|); at
    most 1 where the gradients agree."""
    g, w = got.double().cpu(), want.double().cpu()
    lim = 1e-4 * w.abs() + atol * max(float(w.abs().max()), 1e-30)
    return float(((g - w).abs() / lim).max())


def cnn_train_phase(dev, tag, kern, kmod) -> dict:
    """The CIM-aware training path (module docstring, phase 11)."""
    from repro_torch.core import prng
    from repro_torch.core.cim_layers import CIMConfig, cim_conv2d_apply
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.models import cnn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    draw = pk.threefry_normal
    r_in, r_w = CNN_POINT
    cim_train = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w,
                          noise=NoiseConfig())
    cim_eval = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w)
    ocfg = AdamWConfig(lr=CNN_LR, weight_decay=0.0)
    out: dict = {"point": [r_in, r_w], "batch": CNN_BATCH}

    # the main path: every count to 0 just before, read just after
    reset_counts(kern)
    draw.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    # -- LeNet, CIM-aware (the example's data, init, optimizer) --------------
    xtr, ytr, xte, yte = make_dataset(n_train=CNN_TRAIN, n_test=CNN_TEST)
    xtr_h = torch.from_numpy(xtr)[..., None]
    xtr_d, ytr_d = xtr_h.to(dev), torch.from_numpy(ytr).long().to(dev)
    xte_d = torch.from_numpy(xte)[..., None].to(dev)
    yte_d = torch.from_numpy(yte).long().to(dev)
    host = cnn.init_lenet(prng.key(0), cim=cim_train)
    params = tree_map(lambda t: t.to(dev).requires_grad_(True), host)
    host = tree_map(lambda t: t.requires_grad_(True), host)

    # step 0, the card against the port's own CPU run: clean and noisy
    # logits bit for bit, the noisy step's gradients within _close_grad
    key = prng.key(1)
    _, sub0 = prng.split(key)
    xb_h, yb_h = xtr_h[:CNN_BATCH], torch.from_numpy(ytr[:CNN_BATCH]).long()
    with torch.no_grad():
        clean_d = cnn.lenet_forward(params, xtr_d[:CNN_BATCH], cim_eval)
        clean_h = cnn.lenet_forward(host, xb_h, cim_eval)
    check(torch.equal(clean_d.cpu(), clean_h),
          "LeNet step 0: clean fakequant logits on the card != CPU run")
    leaves_d, leaves_h = tree_leaves(params), tree_leaves(host)
    noisy_d = cnn.lenet_forward(params, xtr_d[:CNN_BATCH], cim_train,
                                key=sub0)
    noisy_h = cnn.lenet_forward(host, xb_h, cim_train, key=sub0)
    check(torch.equal(noisy_d.detach().cpu(), noisy_h.detach()),
          "LeNet step 0: noisy logits on the card != CPU run (same key)")
    check(not torch.equal(noisy_d.detach(), clean_d),
          "LeNet step 0: the noisy logits equal the clean ones")
    g_d = torch.autograd.grad(cnn.nll(noisy_d, ytr_d[:CNN_BATCH]),
                              leaves_d)
    g_h = torch.autograd.grad(cnn.nll(noisy_h, yb_h), leaves_h)
    names = [f"{n}/{k}" for n in sorted(host) for k in sorted(host[n])]
    ratios = {}
    for name, a, b in zip(names, g_d, g_h):
        # LeNet's conv ABN gains are sums over every output pixel of the
        # batch (784 and 196 a image), each summed in its device's order
        atol = CONV_GAIN_ATOL if name in CONV_GAINS else 1e-5
        ratios[name] = grad_ratio(a, b, atol)
    # the least atol each conv gain needs, card against CPU, as the rows
    # grow: batch 8 and 32 (the CPU and gpu tests' sizes) and 256
    gap = {CNN_BATCH: {n: least_atol(a, b) for n, a, b in
                       zip(names, g_d, g_h) if n in CONV_GAINS}}
    for nb in (8, 32):
        nd = cnn.lenet_forward(params, xtr_d[:nb], cim_train, key=sub0)
        nh = cnn.lenet_forward(host, xb_h[:nb], cim_train, key=sub0)
        gd = torch.autograd.grad(cnn.nll(nd, ytr_d[:nb]), leaves_d)
        gh = torch.autograd.grad(cnn.nll(nh, yb_h[:nb]), leaves_h)
        gap[nb] = {n: least_atol(a, b) for n, a, b in zip(names, gd, gh)
                   if n in CONV_GAINS}
    bad = {k: v for k, v in ratios.items() if not v <= 1.0}
    check(not bad, f"LeNet step 0: card gradients off the CPU's: {bad}")
    out["step0"] = {"clean_equal": True, "noisy_equal": True,
                    "grad_ratio_max": max(ratios.values()),
                    "grad_ratio": ratios, "conv_gain_atol": CONV_GAIN_ATOL,
                    "conv_gain_least_atol": {str(k): v for k, v in
                                             sorted(gap.items())}}
    print(f"cnn_train step0 {tag}: the least atol (share of the largest) "
          f"at which the conv ABN gains' card gradients meet the CPU's, "
          f"batch 8 / 32 / {CNN_BATCH}: " + "; ".join(
              f"{n} " + " / ".join(f"{gap[nb][n]:.3g}"
                                   for nb in (8, 32, CNN_BATCH))
              for n in CONV_GAINS) + f"; limit {CONV_GAIN_ATOL:g}",
          flush=True)
    del host, g_d, g_h, noisy_d, noisy_h

    # the recipe twice from the same weights: under noise with the
    # example's per-step keys, and clean.  Under NoiseConfig() step 0's
    # logits sit in the hundreds (loss ~780; the forward is JAX's bit for
    # bit on the CPU) and 32 steps leave LeNet at chance; the clean run
    # learns (tests/test_torch_cnn_train.py holds it against JAX's)
    init = tree_map(lambda t: t.detach().clone(), params)

    def train(p, cim, key):
        opt, losses, step_ms = adamw_init(p), [], []
        for _ in range(CNN_EPOCHS):
            for i in range(0, CNN_TRAIN, CNN_BATCH):
                sub = None
                if key is not None:
                    key, sub = prng.split(key)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = cnn.train_step(cnn.lenet_forward, p, opt,
                                      xtr_d[i:i + CNN_BATCH],
                                      ytr_d[i:i + CNN_BATCH], sub, cim,
                                      ocfg)
                losses.append(float(loss))           # waits for the card
                step_ms.append(1e3 * (time.perf_counter() - t0))
        check(all(np.isfinite(losses)), f"non-finite LeNet loss: {losses}")
        check(np.mean(losses[-4:]) < np.mean(losses[:4]),
              f"the LeNet loss did not fall: {losses}")
        return opt, losses, step_ms

    _, losses, step_ms = train(params, cim_train, key)
    draws_train = draw.launches
    cp = tree_map(lambda t: t.clone().requires_grad_(True), init)
    cp_opt, clean_losses, clean_ms = train(cp, cim_eval, None)

    def evaluate(det) -> dict:
        """fakequant over the test set; sim and the engine on CNN_EVAL
        images, the engine a graph replay == the card's plain reference
        == the port's CPU engine run, and against fakequant on those same
        images: fakequant's activation swing spans its whole batch, so
        logits of batches of CNN_BATCH are another function.  JAX's
        statement (tests/test_engine_conv.py, pseudo-MNIST at 4b): mean
        relative distance at most 0.05, top-1 agreement 1."""
        fq = torch.cat([cnn.lenet_forward(det, xte_d[i:i + CNN_BATCH],
                                          cim_eval)
                        for i in range(0, CNN_TEST, CNN_BATCH)])
        xe, ye = xte_d[:CNN_EVAL], yte_d[:CNN_EVAL]
        sim = cnn.lenet_forward(det, xe, cim_eval.replace(mode="sim"))
        prog = cnn.lenet_program(CNN_EVAL, cim=cim_eval)
        check(prog.device.type == "cuda", "the LeNet program is off the card")
        bound = prog.bind(cnn.lenet_params_list(det))
        eng = bound.serve(xe)                       # captures its graph
        st0 = prog.stats()
        eng2 = bound.serve(xe)                      # replays it
        check(prog.stats()["graph_replays"] == st0["graph_replays"] + 1,
              "the second engine serve did not replay a graph")
        check(torch.equal(eng, eng2), "engine replay != its capture run")
        check(torch.equal(eng, bound.reference(xe)),
              "engine logits on the card != the card's plain reference")
        det_h = tree_map(lambda t: t.cpu(), det)
        eng_h = cnn.lenet_program(CNN_EVAL, cim=cim_eval, device="cpu").bind(
            cnn.lenet_params_list(det_h)).serve(xe.cpu())
        check(torch.equal(eng.cpu(), eng_h),
              "engine logits on the card != the port's CPU engine run")
        fq_e = cnn.lenet_forward(det, xe, cim_eval)
        agree = float((eng.argmax(-1) == fq_e.argmax(-1)).float().mean())
        rel = float((eng - fq_e).abs().mean() / (fq_e.abs().mean() + 1e-9))
        check(rel <= 0.05 and agree == 1.0,
              f"engine vs fakequant on the same {CNN_EVAL} images: mean "
              f"relative distance {rel:.3g} (<= 0.05), top-1 agreement "
              f"{agree:.4f} (== 1)")

        def acc(logits, y):
            return float((logits.argmax(-1) == y).float().mean())
        return {"acc_fakequant": acc(fq, yte_d), "acc_sim_128": acc(sim, ye),
                "acc_engine_128": acc(eng, ye),
                "top1_agree_engine_fakequant": agree,
                "engine_fakequant_mean_rel": rel,
                "engine_fakequant_max_abs": float((eng - fq_e).abs().max()),
                "top1_agree_engine_fakequant_of_batch": float(
                    (eng.argmax(-1) == fq[:CNN_EVAL].argmax(-1))
                    .float().mean())}

    with torch.no_grad():
        det = tree_map(lambda t: t.detach(), params)
        ev = {"noisy": evaluate(det),
              "clean": evaluate(tree_map(lambda t: t.detach(), cp))}
    # one noisy step under the profiler, on the clean run's copy
    xb, yb = xtr_d[:CNN_BATCH], ytr_d[:CNN_BATCH]
    prof = device_profile(lambda: cnn.train_step(
        cnn.lenet_forward, cp, cp_opt, xb, yb, prng.key(7), cim_train,
        ocfg), 1, groups=("cim_mbiw", "threefry", "gemm", "elementwise"))
    del cp, cp_opt, init
    med_noisy = statistics.median(step_ms[2:])
    med_clean = statistics.median(clean_ms[2:])
    out["lenet"] = {
        "losses": losses, "clean_losses": clean_losses, "step_ms": step_ms,
        "clean_step_ms": clean_ms,
        "median_noisy_step_ms": med_noisy, "median_clean_step_ms": med_clean,
        "images_per_s_noisy": CNN_BATCH / (med_noisy / 1e3),
        "images_per_s_clean": CNN_BATCH / (med_clean / 1e3),
        "eval": ev, "draws_in_training": draws_train, "profile": prof,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    top = ", ".join(f"{k[:40]} {v:.0f}" for k, v in list(
        prof.get("top_kernels_us", {}).items())[:4])
    share = (f"a profiled noisy step: device {prof['device_us']:.0f} us, "
             f"busy {100 * prof['device_busy']:.1f}%, top (us) {top}"
             if prof else "device time not measured (profiler saw none)")

    def curve(ls):
        return (f"loss {ls[0]:.3f} -> {ls[-1]:.3f} (mean of first/last 4: "
                f"{np.mean(ls[:4]):.3f} / {np.mean(ls[-4:]):.3f})")

    def accs(e):
        return (f"test acc fakequant {e['acc_fakequant']:.4f} ({CNN_TEST}), "
                f"sim {e['acc_sim_128']:.4f}, engine "
                f"{e['acc_engine_128']:.4f} ({CNN_EVAL}); engine vs "
                f"fakequant on the same {CNN_EVAL}: top-1 "
                f"{e['top1_agree_engine_fakequant']:.4f}, mean relative "
                f"{e['engine_fakequant_mean_rel']:.3g}, max |diff| "
                f"{e['engine_fakequant_max_abs']:.3g} (against fakequant "
                f"over batches of {CNN_BATCH}: top-1 "
                f"{e['top1_agree_engine_fakequant_of_batch']:.4f})")
    print(f"cnn_train lenet {tag}: ({r_in},{r_w}) fakequant, batch "
          f"{CNN_BATCH}, {len(losses)} steps from JAX's weights: step 0 "
          f"clean and noisy logits == CPU run (bit for bit), gradients "
          f"within _close_grad (worst {out['step0']['grad_ratio_max']:.3f} "
          f"of the limit); engine a graph replay == card reference == CPU "
          f"engine run. Under NoiseConfig(): {curve(losses)}; "
          f"{accs(ev['noisy'])}. Clean: {curve(clean_losses)}; "
          f"{accs(ev['clean'])}. Host ms a step noisy {med_noisy:.1f}, "
          f"clean {med_clean:.1f} ({CNN_BATCH / (med_noisy / 1e3):.0f} / "
          f"{CNN_BATCH / (med_clean / 1e3):.0f} images/s); peak "
          f"{out['lenet']['peak_gb']:.2f} GB; {share}", flush=True)

    # -- LeNet's convs through the engine --------------------------------
    conv_rec = []
    with torch.no_grad():
        x1 = xtr_d[:CNN_BATCH]
        h1 = cnn.max_pool_2x2(torch.relu(cim_conv2d_apply(
            det["conv1"], x1, cim_eval)))
        for name, x_in in (("conv1", x1), ("conv2", h1)):
            for stride, padding in CNN_CONV_GEOMETRIES:
                y_fq = cim_conv2d_apply(det[name], x_in, cim_eval,
                                        stride=stride, padding=padding)
                before = kern.launches
                y_eng = cim_conv2d_apply(det[name], x_in,
                                         cim_eval.replace(mode="engine"),
                                         stride=stride, padding=padding)
                torch.cuda.synchronize()
                n_l = kern.launches - before
                err = float((y_eng - y_fq).abs().max())
                ok = torch.allclose(y_eng, y_fq, rtol=1e-4, atol=1e-5)
                check(ok and n_l > 0 and y_eng.shape == y_fq.shape,
                      f"engine {name} stride {stride} padding {padding}: "
                      f"max |engine - fakequant| {err:.3g} (rtol 1e-4, "
                      f"atol 1e-5), {n_l} cim_mbiw launches")
                conv_rec.append({"layer": name, "stride": stride,
                                 "padding": str(padding),
                                 "shape": list(y_eng.shape),
                                 "max_abs_err": err, "launches": n_l})
    out["engine_conv"] = conv_rec
    print(f"cnn_train conv {tag}: conv1 and conv2 at batch {CNN_BATCH}, "
          f"(stride, padding) {CNN_CONV_GEOMETRIES}: engine within rtol "
          f"1e-4 / atol 1e-5 of fakequant, max abs err "
          f"{max(r['max_abs_err'] for r in conv_rec):.3g}; cim_mbiw "
          f"launches {[r['launches'] for r in conv_rec]}", flush=True)

    # -- the Fig. 3(b) MLP sweep ---------------------------------------------
    xtr, ytr, xte, yte = make_dataset(n_train=MLP_TRAIN, n_test=MLP_TEST,
                                      seed=0)
    xs = torch.from_numpy(xtr.reshape(-1, 784)).to(dev)
    ys = torch.from_numpy(ytr).long().to(dev)
    xt = torch.from_numpy(xte.reshape(-1, 784)).to(dev)
    yt = torch.from_numpy(yte).long().to(dev)
    accs, mlp_s = {}, {}
    mcfg = AdamWConfig(lr=MLP_LR, weight_decay=0.0)
    fqk = dict(mode="fakequant")
    cases = [             # benchmarks/fig3_abn_accuracy.py's, in its order
        ("fp_baseline", CIMConfig(mode="bypass")),
        ("adc8_gamma_free_adaptive", CIMConfig(**fqk)),
        ("adc8_gamma0b_adaptive", CIMConfig(**fqk, gamma_bits=0)),
        ("adc8_gamma2b_adaptive", CIMConfig(**fqk, gamma_bits=2)),
        ("adc8_gamma3b_adaptive", CIMConfig(**fqk, gamma_bits=3)),
        ("adc8_gamma3b_fixed", CIMConfig(**fqk, gamma_bits=3,
                                         adaptive_swing=False)),
        ("adc6_gamma3b_adaptive", CIMConfig(**fqk, gamma_bits=3, r_out=6)),
        ("adc4_gamma3b_adaptive", CIMConfig(**fqk, gamma_bits=3, r_out=4))]
    for name, cim in cases:
        t0 = time.perf_counter()
        p = tree_map(lambda t: t.to(dev).requires_grad_(True),
                     cnn.init_mlp(prng.key(0), dims=MLP_DIMS, cim=cim))
        o = adamw_init(p)
        for _ in range(MLP_EPOCHS):
            for i in range(0, MLP_TRAIN, CNN_BATCH):
                cnn.train_step(cnn.mlp_forward, p, o,
                               xs[i:i + CNN_BATCH], ys[i:i + CNN_BATCH],
                               None, cim, mcfg)
        with torch.no_grad():
            logits = cnn.mlp_forward(p, xt, cim)
        accs[name] = float((logits.argmax(-1) == yt).float().mean())
        mlp_s[name] = time.perf_counter() - t0
    claims = {
        "gamma3b >= gamma0b (adaptive)":
            accs["adc8_gamma3b_adaptive"] >= accs["adc8_gamma0b_adaptive"],
        "adaptive >= fixed - 0.02 (gamma 3b)":
            accs["adc8_gamma3b_adaptive"]
            >= accs["adc8_gamma3b_fixed"] - 0.02}
    out["fig3b"] = {"accuracy": accs, "seconds": mlp_s, "claims": claims}
    print(f"cnn_train fig3b {tag}: MLP {MLP_DIMS}, {MLP_EPOCHS} epochs of "
          f"{MLP_TRAIN} at batch {CNN_BATCH}, test {MLP_TEST}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in accs.items()) + "; claims "
          + "; ".join(f"{k}: {'held' if v else 'missed'}"
                      for k, v in claims.items())
          + " (reported, not gated)", flush=True)

    counts = kernel_counts(kern)
    out["launches"] = {
        "cim_mbiw": counts[0], "cim_mbiw_tc": counts[1],
        "cim_mbiw_splitk": counts[2], "threefry_normal": draw.launches}
    check(counts[0] > 0 and draw.launches > 0,
          f"cnn_train launched a kernel of its path no time: "
          f"{out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"cnn_train launches {tag}: {out['launches']} in "
          f"{out['seconds']:.1f} s", flush=True)
    return out


def dense_phase(dev, tag) -> dict:
    """The dense configs' train step (module docstring, phase 12)."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    out: dict = {"archs": {}}
    launches = dict.fromkeys(FLASH_NAMES, 0)
    launches_tc = dict.fromkeys(FLASH_NAMES, 0)
    t_phase = time.perf_counter()
    for arch, shape in zip(DENSE_ARCHS, FLASH_DENSE):
        cfg = get_config(arch).replace(
            n_layers=DENSE_LAYERS, attn_impl="pallas",
            cim=CIMConfig(mode="fakequant", max_gamma=2.0**16))
        check(cfg.dtype == "bfloat16" and (cfg.cim.r_in, cfg.cim.r_w,
                                           cfg.cim.r_out) == (8, 4, 8),
              f"{arch}: not a bf16 fakequant (8, 4, 8) config")
        q_dtype = torch.float32 if cfg.qkv_bias else torch.bfloat16
        check((1, cfg.n_heads, cfg.n_kv_heads, DENSE_SEQ,
               cfg.resolved_head_dim, q_dtype) == shape,
              f"{arch}: its attention is not FLASH_DENSE's {shape}, the "
              f"shape flash_checks holds against the plain version")
        t0 = time.perf_counter()
        state = steps.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        step_fn = steps.make_train_step(cfg, AdamWConfig(lr=3e-4),
                                        total_steps=10, warmup=1)
        toks, labels = SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=DENSE_SEQ,
            global_batch=1)).batch_at(0)
        batch = {"tokens": torch.from_numpy(toks).long().to(dev),
                 "labels": torch.from_numpy(labels).long().to(dev)}
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        state, rec = train_steps(cfg, state, step_fn, [batch], arch)
        m = rec["metrics"][0]
        finite = all(bool(torch.isfinite(p).all())
                     for p in tree_leaves(state["params"]))
        check(finite, f"{arch}: non-finite parameters after the step")
        # train/decode consistency (tests/test_models_smoke.py)
        bcfg = cfg.replace(cim=CIMConfig(mode="bypass"))
        g = torch.Generator().manual_seed(2)
        dt = torch.randint(0, cfg.vocab_size, (1, DENSE_DECODE),
                           generator=g).to(dev)
        with torch.no_grad():
            params = state["params"]
            full, _, _ = tf.forward(bcfg, params, dt)
            cache = tf.init_cache(bcfg, 1, max_len=16, device=dev)
            outs = []
            for t in range(DENSE_DECODE):
                lg, cache, _ = tf.forward(bcfg, params, dt[:, t:t + 1],
                                          cache=cache)
                outs.append(lg[:, 0])
        cons = float((full.float() - torch.stack(outs, 1).float())
                     .abs().max())
        check(cons < 0.1, f"{arch}: train/decode divergence {cons}")
        # the step's launches and the full forward's (train_steps set the
        # counts to 0 before the step)
        for name, f in zip(FLASH_NAMES, kerns):
            launches[name] += f.launches
            launches_tc[name] += f.launches_tc
        peak = torch.cuda.max_memory_allocated() / 1e9
        fl, fl_tc = list(rec["launches"].values()), list(
            rec["launches_tc"].values())
        out["archs"][arch] = {
            "n_layers": DENSE_LAYERS, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "n_params": n_params,
            "loss": m["loss"], "grad_norm": m["grad_norm"],
            "step_s": rec["step_ms"][0] / 1e3, "build_s": build_s,
            "flash_launches": fl, "flash_launches_tc": fl_tc,
            "train_decode_err": cons, "peak_gb": peak}
        print(f"dense {arch} {tag}: full width (d {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}), depth cut to {DENSE_LAYERS}, "
              f"{n_params / 1e9:.2f} B params: one fakequant (8,4,8) bf16 "
              f"step at batch 1 x {DENSE_SEQ}, loss {m['loss']:.4f}, grad "
              f"norm {m['grad_norm']:.4f} (finite), flash launches {fl}, "
              f"{fl_tc} on the tensor cores, step "
              f"{rec['step_ms'][0] / 1e3:.2f} s; train/decode max |diff| "
              f"{cons:.4f} over {DENSE_DECODE} tokens (< 0.1); peak "
              f"{peak:.1f} GB", flush=True)
        del state, params, cache, full, outs
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["launches_tc"] = launches_tc
    check(all(n > 0 for n in launches.values()),
          f"the dense path launched a flash kernel no time: {launches}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"dense launches {tag}: {launches} ({launches_tc} on the tensor "
          f"cores; the steps' and the full forwards' of the train/decode "
          f"check) in {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 13: the moe and vlm decoder families at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_DEPTH = 4                     # of 32
MOE_BATCH = 4
MOE_PROMPT = 128                  # prefill 512 tokens: capacity 80, bucket 128
MOE_GEN = 16
MOE_INFLIGHT_PROMPT = 32          # a solo prefill's capacity is 8, decode's
MOE_INFLIGHT_SLOTS = 4
MOE_INFLIGHT_REQUESTS = 8
MOE_BANK = (16, 8, 4096, 6400)    # E, capacity, fan-in, fan-out
MOE_BANK_POINTS = ((8, 4), (1, 2))
MOE_BLOCK_TOKENS = 64
MOE_BLOCK_RTOL = 2e-2             # card vs host, |d| / |host| of the block
MOE_TRAIN_DEPTH = 2
MOE_TRAIN_SEQ = 512
MOE_SHARD_DEPTH = 2
MOE_SHARD_PROMPT = 8              # 32 rows: expert capacity 8
MOE_SHARD_DEVICES = 4
MOE_SHARD_GEN = 4
MOE_FOLD_MESH = (2, 2)            # ("data", "model") folded onto the card
MOE_FOLD_TOKENS = (2, 256)        # 512 tokens: 256 a data shard
# the first layer's attention block under the folded mesh, flash against
# plain (relative L2 of the bf16 outputs): one bf16 ulp, the flash
# checks' rtol on a bf16 O; a piece at the wrong q offset moves a quarter
# of the rows by their own size
MOE_FOLD_ATTN_RTOL = 2.0**-7
MIXTRAL_ARCH = "mixtral-8x22b"
MIXTRAL_DEPTH = 1                 # of 56
MIXTRAL_PROMPT = 32
MIXTRAL_GEN = 4
VLM_ARCH = "internvl2-76b"
VLM_SERVE_DEPTH = 2               # of 80
VLM_TRAIN_DEPTH = 1
VLM_BATCH = 2
VLM_PROMPT = 32
VLM_GEN = 4


def _free(dev) -> None:
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _peak_gb(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def moe_bank_checks(dev, tag) -> dict:
    """One phi3.5-moe expert bank at full width (MOE_BANK): the engine on
    the card == fakequant on the card == fakequant on the CPU, bit for
    bit, clean at each of MOE_BANK_POINTS and noisy under one key at the
    first (the card's kernel path == its reference=True); then a whole
    moe_block at full width on MOE_BLOCK_TOKENS tokens: the card's top_idx
    == the CPU's and the output within MOE_BLOCK_RTOL."""
    from repro_torch.core import prng
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.core.noise_model import NO_NOISE, NoiseConfig
    from repro_torch.models import moe
    e, c, k, n = MOE_BANK
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((e, c, k), generator=g, device=dev)
    w = torch.randn((e, k, n), generator=g, device=dev) * k ** -0.5
    lg = torch.rand((e, n), generator=g, device=dev) * 5
    bt = torch.rand((e, n), generator=g, device=dev) * 8 - 4
    hx, hw, hlg, hbt = (t.cpu() for t in (x, w, lg, bt))
    rec: dict = {}
    cases = [(p, None) for p in MOE_BANK_POINTS] + [(MOE_BANK_POINTS[0],
                                                     prng.key(11))]
    for (r_in, r_w), key in cases:
        cim = CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w,
                        noise=NoiseConfig() if key is not None else NO_NOISE)
        with torch.no_grad():
            fq = moe._expert_gemm(x, w, cim, (lg, bt), key=key)
            host = moe._expert_gemm(hx, hw, cim, (hlg, hbt), key=key)
            en = cim.replace(mode="engine")
            eng = moe._expert_gemm(x, w, en, (lg, bt), key=key)
        label = f"({r_in},{r_w})" + (" noisy" if key is not None else "")
        check(torch.equal(fq.cpu(), host),
              f"moe bank {label}: fakequant on the card != on the CPU")
        if key is None:
            check(torch.equal(eng, fq),
                  f"moe bank {label}: engine != fakequant on the card")
        else:
            with torch.no_grad():
                ref = moe._expert_gemm(x, w, en, (lg, bt), key=key,
                                       reference=True)
            check(torch.equal(eng, ref),
                  f"moe bank {label}: engine kernels != reference=True")
            del ref
        rec[label] = {"finite": bool(torch.isfinite(eng).all()),
                      "mean_abs": float(eng.abs().mean())}
        del fq, host, eng
    del x, w, lg, bt, hx, hw, hlg, hbt
    _free(dev)
    bank_s = time.perf_counter() - t0

    # a whole block at full width, card against host (fakequant, (8, 4))
    t0 = time.perf_counter()
    params = moe.init_moe(torch.Generator(device=dev).manual_seed(8), k, n, e)
    hparams = {kk: v.cpu() for kk, v in params.items()}
    xb = torch.randn((1, MOE_BLOCK_TOKENS, k),
                     generator=torch.Generator(device=dev).manual_seed(9),
                     device=dev)
    cim = CIMConfig(mode="fakequant", r_in=8, r_w=4)
    kw = dict(n_experts=e, top_k=2, capacity_factor=1.25, cim=cim)
    with torch.no_grad():
        out, aux = moe.moe_block(params, xb, **kw)
        hout, haux = moe.moe_block(hparams, xb.cpu(), **kw)
        idx = moe.route(xb[0], params["router"], e, 2)[2]
        hidx = moe.route(xb[0].cpu(), hparams["router"], e, 2)[2]
    rel = float(torch.linalg.norm(out.cpu() - hout) / torch.linalg.norm(hout))
    check(torch.equal(idx.cpu(), hidx),
          "moe block: the card's top_idx != the CPU's")
    check(rel <= MOE_BLOCK_RTOL and bool(torch.isfinite(out).all()),
          f"moe block: card vs CPU relative {rel} > {MOE_BLOCK_RTOL}")
    rec["block"] = {"tokens": MOE_BLOCK_TOKENS, "rel": rel,
                    "exact": bool(torch.equal(out.cpu(), hout)),
                    "aux": float(aux), "aux_host": float(haux),
                    "seconds": time.perf_counter() - t0}
    del params, hparams, out, hout
    _free(dev)
    rec["bank_s"] = bank_s
    print(f"moe bank {tag}: phi3.5-moe's expert bank at full width (E {e}, "
          f"capacity {c}, {k} -> {n}): engine on the card == fakequant on "
          f"the card == fakequant on the CPU bit for bit at "
          f"{', '.join(str(p) for p in MOE_BANK_POINTS)} clean and "
          f"{MOE_BANK_POINTS[0]} under key 11 (where the kernels == "
          f"reference=True); "
          f"{bank_s:.1f} s.  moe_block at full width on "
          f"{MOE_BLOCK_TOKENS} tokens: top_idx card == CPU, output "
          f"relative {rel:.3g} (<= {MOE_BLOCK_RTOL}; bit-equal "
          f"{rec['block']['exact']}), aux {float(aux):.6f} / "
          f"{float(haux):.6f}", flush=True)
    return rec


def family_train_step(dev, tag, arch, depth, *, prefix: bool = False,
                      vs_plain: bool = False, seq: int = MOE_TRAIN_SEQ,
                      n_steps: int = 1, shapes=None,
                      label: str = "moe") -> dict:
    """`n_steps` fakequant (8, 4, 8) bf16 train steps of `arch` at full
    width, depth cut to `depth`, the flash kernels, batch 1 x `seq` text
    tokens (plus a vlm model's seeded prefix), through launch/steps; the
    model's attention shape must be one of `shapes`, which the kernel
    checks hold against the plain version (default FLASH_MOE).
    With `vs_plain` first step 0's loss and gradient against plain
    attention: with the CIM layers in bypass within TRAIN_JNP_RTOL; in
    fakequant within it too, but for an MoE model, where it is reported;
    and, for an MoE model, nonzero gradients of every
    bank, router and per-expert ABN gain in every layer (the offsets'
    norms are reported).  The steps are
    timed on the host, then one is profiled.  A step that does not fit
    the card (CUDA out of memory) is reported with the peak reached.  An
    audio model (both stacks cut to `depth`) trains on the launcher's
    audio batches: `seq` seeded frames (train.audio_frames) and
    min(max_target_len, seq // 8) tokens.  Each batch's frames and
    prefix are held bit for bit to the draw's plain version
    (`check_drawn`).  An audio model's three attention shapes
    (encoder, decoder, cross) must be in `shapes`, as (B, H, G, Sq, Sk,
    D, causal)."""
    from repro_torch.core import prng
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.launch import serve, train
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve.get_config(arch)
    cfg = cfg.replace(n_layers=depth,
                      encoder_layers=min(cfg.encoder_layers, depth),
                      attn_impl="pallas",
                      cim=CIMConfig(mode="fakequant", max_gamma=2.0**16))
    audio = cfg.family == "audio"
    tokens = train.audio_tokens(cfg, seq) if audio else seq
    rec = {"arch": cfg.name, "depth": depth, "fits": True}
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=tokens, global_batch=1))
    batches = []
    for i in range(n_steps):
        toks, labels = data.batch_at(i)
        batches.append({"tokens": torch.from_numpy(toks).long().to(dev),
                        "labels": torch.from_numpy(labels).long().to(dev)})
        if prefix:
            batches[-1]["prefix_embeds"] = serve.make_prefix(cfg, 1, i, dev)
            check_drawn(batches[-1]["prefix_embeds"], prng.key(i),
                        f"{arch} step {i}'s prefix")
        if audio:
            batches[-1]["encoder_frames"] = train.audio_frames(
                cfg, 1, seq, 0, i, dev)
            check_drawn(batches[-1]["encoder_frames"],
                        prng.fold_in(prng.key(0), i),
                        f"{arch} step {i}'s frames")
    shapes = FLASH_MOE if shapes is None else shapes
    want = []                     # the ssm family runs no attention
    if cfg.family != "ssm":
        h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        want = ([(1, h, g, seq, seq, hd, False),
                 (1, h, g, tokens, tokens, hd, True),
                 (1, h, g, tokens, seq, hd, False)] if audio else
                [(1, h, g, seq + (cfg.vision_tokens if prefix else 0), hd,
                  cfg.local_window if cfg.family == "hybrid"
                  else cfg.sliding_window)])
    for shape in want:
        check(shape in shapes, f"{arch}: its attention {shape} is not one "
              f"of {shapes}, the shapes flash_checks holds against the "
              f"plain version")
    try:
        rec.update(_train_body(dev, cfg, batches, vs_plain))
    except torch.OutOfMemoryError as exc:
        rec.update(fits=False, peak_gb=_peak_gb(dev),
                   error=str(exc).splitlines()[0][:200],
                   launches=dict.fromkeys(FLASH_NAMES, 0),
                   launches_tc=dict.fromkeys(FLASH_NAMES, 0))
    _free(dev)
    if not rec["fits"]:
        print(f"{label} train {tag}: {cfg.name} at full width, depth cut "
              f"to {depth}: one fakequant bf16 step at batch 1 x "
              f"{seq} does not fit the card (peak "
              f"{rec['peak_gb']:.1f} GB reached: {rec['error']})",
              flush=True)
        return rec
    prof = rec["profile"]
    kinds = (", ".join(f"{g} {prof[f'{g}_us'] / 1e3:.1f}"
                       for g in ("flash", "gemm", "elementwise", "reduce",
                                 "index"))
             + f" of {prof['device_us'] / 1e3:.1f} ms device"
             if prof else "not profiled" if prof is None
             else "device time not measured")
    s0 = rec.get("step0")
    vs_txt = ("; step 0 vs plain attention (loss / grad norm / grad), "
              "bypass " + " / ".join(
                  f"{s0['vs_plain_bypass'][m]:.3g}" for m in TRAIN_JNP_RTOL)
              + f" (limits {TRAIN_JNP_RTOL}), fakequant " + " / ".join(
                  f"{s0['vs_plain'][m]:.3g}" for m in TRAIN_JNP_RTOL)
              + (" (routing flips, reported)" if cfg.family == "moe"
                 else " (held)") + (
            "; smallest layer gradient norm " + ", ".join(
                f"{k_} {v:.3g}" for k_, v in s0["grad_norm_min"].items())
            if s0["grad_norm_min"] else "") if s0 else "")
    print(f"{label} train {tag}: {cfg.name} at full width (d "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), depth "
          + (f"{cfg.encoder_layers} + {depth}" if audio
             else f"cut to {depth}")
          + f", {rec['n_params'] / 1e9:.2f} B params: "
          f"{n_steps} fakequant (8,4,8) bf16 step(s), flash, batch 1 x "
          + (f"{seq} frames and {tokens} tokens" if audio else f"{seq}")
          + (f" + {cfg.vision_tokens} prefix" if prefix else "")
          + f": loss {rec['loss']:.4f} (ce {rec['ce']:.4f}, aux "
          f"{rec['aux']:.4f}), grad norm {rec['grad_norm']:.4f} (last "
          f"step), flash {list(rec['launches'].values())} (tensor cores "
          f"{list(rec['launches_tc'].values())}), host "
          + ", ".join(f"{t:.0f}" for t in rec["step_ms_all"])
          + f" ms a step, peak {rec['peak_gb']:.1f} GB; profiled step: "
          f"{kinds}{vs_txt}", flush=True)
    return rec


def _train_body(dev, cfg, batches, vs_plain: bool) -> dict:
    """family_train_step's work, in a frame of its own: where it runs out
    of device memory its tensors go with the frame."""
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig, global_norm
    from repro_torch.optim.adamw import tree_leaves
    rec: dict = {}
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    rec["n_params"] = sum(p.numel() for p in tree_leaves(params))
    if vs_plain:
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        def loss_grads(c):
            loss, parts = steps.loss_fn(c, params, batches[0])
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return (float(loss.detach()), float(parts["aux"].detach()),
                    [torch.zeros_like(p) if gg is None else gg
                     for p, gg in zip(leaves, grads)])

        def against_plain(c):
            p_loss, _, p_grads = loss_grads(c.replace(attn_impl="jnp"))
            loss, aux, grads = loss_grads(c)
            p_norm = float(global_norm(p_grads))
            vs = {"loss": abs(loss - p_loss) / abs(p_loss),
                  "grad_norm": abs(float(global_norm(grads)) - p_norm)
                  / p_norm,
                  "grad": float(global_norm(a - b for a, b in zip(
                      grads, p_grads))) / p_norm}
            return loss, aux, grads, vs
        # with the CIM layers in bypass the flash step holds to plain
        # attention; in fakequant the top-2 routing is discontinuous and
        # each activation swing is the min / max of the whole tensor, so
        # the few ulps between flash and plain flip some tokens' experts
        # (in float32 as in bf16) and with them the swing of every code
        # after: that comparison is reported, not held
        byp = cfg.replace(cim=CIMConfig(mode="bypass"))
        _, _, grads, vs_bypass = against_plain(byp)
        del grads
        check(all(vs_bypass[m] <= lim for m, lim in TRAIN_JNP_RTOL.items()),
              f"{cfg.name}: step 0 flash vs plain (bypass) outside "
              f"{TRAIN_JNP_RTOL}: {vs_bypass}")
        loss, aux, grads, vs = against_plain(cfg)
        check(cfg.family == "moe"
              or all(vs[m] <= lim for m, lim in TRAIN_JNP_RTOL.items()),
              f"{cfg.name}: step 0 flash vs plain (fakequant) outside "
              f"{TRAIN_JNP_RTOL}: {vs}")
        nonzero = {}
        by_id = {id(p): gg for p, gg in zip(leaves, grads)}
        if cfg.family == "moe":
            for name in ("router", "w_gate", "w_up", "w_down",
                         "abn_log_gamma", "abn_beta"):
                nonzero[name] = min(
                    float(by_id[id(lay["moe"][name])].norm())
                    for lay in params["layers"])
            # the offsets' STE gradient is zero but where a code clips
            # (floor(.. + beta) - beta passes 1 - 1), so it is reported
            check(all(v > 0 for k_, v in nonzero.items()
                      if k_ != "abn_beta"),
                  f"{cfg.name}: a zero gradient at step 0: {nonzero}")
        rec["step0"] = {"loss": loss, "aux": aux, "vs_plain": vs,
                        "vs_plain_bypass": vs_bypass,
                        "grad_norm_min": nonzero}
        del grads, by_id
    state = steps.train_state(params)
    del params
    step_fn = steps.make_train_step(cfg, AdamWConfig(lr=3e-4),
                                    total_steps=10, warmup=1)
    state, srec = train_steps(cfg, state, step_fn, batches, cfg.name)
    m = srec["metrics"][-1]
    check(all(bool(torch.isfinite(p).all())
              for p in tree_leaves(state["params"])),
          f"{cfg.name}: non-finite parameters after the step")
    # the main path's step (vs_plain) is profiled, the others are not
    prof = device_profile(
        lambda: step_fn(state, batches[0])[1]["loss"].item(), 1, cpu=False,
        groups=("flash", "gemm", "elementwise", "reduce", "index")
    ) if vs_plain else None
    rec.update(loss=m["loss"], ce=m["ce"], aux=m["aux"],
               grad_norm=m["grad_norm"], step_ms=srec["step_ms"][0],
               step_ms_all=srec["step_ms"], metrics=srec["metrics"],
               launches=srec["launches"],
               launches_tc=srec["launches_tc"], profile=prof,
               peak_gb=_peak_gb(dev))
    return rec


def _clone(tree):
    """A copy of a cache tree (dicts, None and tensors)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def family_serve(dev, tag, arch, depth, batch, prompt_len, gen, kern, kmod,
                 tprog, trt, clock, label: str = "moe",
                 replay_checks: bool = False) -> tuple:
    """A static engine serve of `arch` at full width through
    launch/serve.py (build with the depth cut, make_prompt, make_prefix
    for vlm, make_frames for audio, which serves the prompt's first
    token over max_len frames as the launcher does, both held bit for bit
    to the draw's plain version (`check_drawn`); static_serve; bf16,
    (8, 4)): cim_mbiw launched the planned
    tiles of the prefill and of every decode step (family_tiles); no
    plan, bind, capture or eager dispatch after warm-up; one decode step
    profiled; then the same serve in fakequant, whose tokens and every
    logit equal the engine's.  With `replay_checks` (the ssm, hybrid and
    audio families) also: one more decode step from the served cache run
    by graph replay and run eagerly (EagerServe) from two copies of that
    cache, logits and new cache bit for bit equal; and the prefill's
    last logits against the cache-free forward of the prompt (the
    recurrences from the zero state in one call each; the encoder over
    the same frames) within PREFILL_RTOL relative.  Returns (record,
    cfg, params, prompt, prefix)."""
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    args = serve.parser().parse_args(
        ["--arch", arch, "--cim-mode", "engine", "--batch", str(batch),
         "--prompt-len", str(prompt_len), "--gen-len", str(gen), "--seed",
         "0", "--device", str(dev)])
    t0 = time.perf_counter()
    cfg, params, _ = serve.build(args, n_layers=depth)
    check(cfg.dtype == "bfloat16" and cfg.n_layers == depth
          and (cfg.cim.mode, cfg.cim.r_in, cfg.cim.r_w) == ("engine", 8, 4),
          f"{arch}: serve config is not bf16, engine at (8, 4): {cfg}")
    max_len = serve.serve_max_len(cfg, prompt_len, gen)
    prompt = serve.make_prompt(cfg.vocab_size, batch, prompt_len, 0, dev)
    prefix = (serve.make_prefix(cfg, batch, 0, dev)
              if cfg.family == "vlm" else None)
    frames = None
    if cfg.family == "audio":
        frames = serve.make_frames(cfg, batch, max_len, 0, dev)
        prompt = prompt[:, :1]
    for drawn, what in ((prefix, "prefix"), (frames, "frames")):
        if drawn is not None:
            check_drawn(drawn, prng.key(0), f"{arch}'s served {what}")
    build_s = time.perf_counter() - t0
    rows = batch * (prompt.shape[1] + (0 if prefix is None
                                       else cfg.vision_tokens))
    plan_pre = family_tiles(cfg, depth, rows, kmod, tprog,
                            enc_rows=0 if frames is None else batch * max_len)
    plan_dec = family_tiles(cfg, depth, batch, kmod, tprog)
    cap_mark, cap_n0 = len(clock.seconds), trt.CAPTURE_COUNT["n"]
    reset_counts(kern)
    with BindClock(trt) as binds:
        eng = serve.static_serve(cfg, params, prompt, gen, max_len=max_len,
                                 keep_logits=True, prefix=prefix,
                                 frames=frames)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_counts(kern)
    caps = clock.since(cap_mark)
    check(caps["captures"] == trt.CAPTURE_COUNT["n"] - cap_n0,
          f"{arch}: capture clock and counter disagree")
    want = {r: plan_pre[r] + gen * plan_dec[r] for r in plan_pre}
    check(launches == (sum(want.values()), want["tc"], want["splitk"]),
          f"{arch}: cim_mbiw launches (all, tc, splitk) {launches} != the "
          f"planned prefill {plan_pre} + {gen} x decode {plan_dec}")
    check(eng["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                            "eager_calls": 0},
          f"{arch}: decode loop after warm-up grew {eng['growth']}")
    toks = eng["tokens"]
    check(tuple(toks.shape) == (batch, 1 + gen)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
          and all(bool(torch.isfinite(lg).all()) for lg in eng["logits"]),
          f"{arch}: tokens or logits malformed")
    peak = _peak_gb(dev)
    per_step_s = eng["decode_s"] / max(eng["steps"], 1)

    # one more decode step from the served cache, profiled (device only)
    cache, tok = eng["cache"], toks[:, -1:].to(dev)
    captures = trt.CAPTURE_COUNT["n"]

    def step():
        with torch.no_grad():
            return tf.forward(cfg, params, tok, cache=cache)[0]
    prof = device_profile(step, 1, cpu=False,
                          groups=("cim_mbiw", "index", "elementwise",
                                  "reduce", "gemm"))
    check(trt.CAPTURE_COUNT["n"] == captures,
          f"{arch}: the profiled decode step captured")
    extra: dict = {}
    if replay_checks:
        with torch.no_grad():
            g_lg, g_cache, _ = tf.forward(cfg, params, tok,
                                          cache=_clone(cache))
            with EagerServe(tprog, trt):
                e_lg, e_cache, _ = tf.forward(cfg, params, tok,
                                              cache=_clone(cache))
            free = tf.forward(cfg, params, prompt,
                              encoder_frames=frames)[0][:, -1]
        torch.cuda.synchronize()
        from repro_torch.optim.adamw import tree_leaves
        check(torch.equal(g_lg, e_lg) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g_cache),
                                              tree_leaves(e_cache))),
              f"{arch}: a decode step by graph replay != the same step "
              f"run eagerly (logits or cache)")
        check(trt.CAPTURE_COUNT["n"] == captures,
              f"{arch}: the graph / eager step or the cache-free forward "
              f"captured")
        pre = eng["logits"][0].float()
        rel = float(torch.linalg.norm(pre - free.float())
                    / torch.linalg.norm(free.float()))
        check(rel <= PREFILL_RTOL,
              f"{arch}: cached prefill vs cache-free forward {rel:.3g} > "
              f"{PREFILL_RTOL}")
        extra = {"graph_eq_eager": True, "prefill_vs_cache_free": rel,
                 "prefill_bitwise_equal": bool(torch.equal(
                     eng["logits"][0], free))}
        del g_cache, e_cache
    del cache, eng["cache"]

    # engine == fakequant bit for bit, prefill and every decode step
    fq_cfg = cfg.replace(cim=cfg.cim.replace(mode="fakequant"))
    fq = serve.static_serve(fq_cfg, params, prompt, gen, max_len=max_len,
                            keep_logits=True, prefix=prefix, frames=frames)
    diff = [i for i, (a, b) in enumerate(zip(eng["logits"], fq["logits"]))
            if not torch.equal(a, b)]
    check(not diff and torch.equal(eng["tokens"], fq["tokens"]),
          f"{arch}: engine != fakequant at steps {diff} (0 = prefill)")
    del fq
    rec = {"arch": cfg.name, "depth": depth, "batch": batch,
           "prompt": prompt.shape[1], "gen": gen,
           "frames": 0 if frames is None else max_len,
           "prefix": 0 if prefix is None else cfg.vision_tokens,
           "build_s": build_s, "prefill_first_s": eng["prefill_s"],
           "warm_s": eng["warm_s"], "decode_steps": eng["steps"],
           "decode_s": eng["decode_s"],
           "decode_host_ms_per_step": 1e3 * per_step_s,
           "tokens_per_s": batch / per_step_s,
           "binds": len(binds.seconds), "bind_s": sum(binds.seconds),
           "captures": caps, "launches": dict(zip(
               ("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"), launches)),
           "planned_prefill": plan_pre, "planned_decode_step": plan_dec,
           "growth": eng["growth"], "peak_gb": peak, "profile": prof,
           "graph_pool_bytes": graph_pool_bytes(tprog, dev),
           "tokens": toks.tolist(), **extra}
    dev_txt = (f"device {prof['device_us'] / 1e3:.1f} ms a step (cim_mbiw "
               f"{prof['cim_mbiw_us'] / 1e3:.1f}), busy "
               f"{100 * prof['device_busy']:.1f}% of a profiled "
               f"{prof['wall_us'] / 1e3:.0f} ms step"
               if prof else "device time not measured")
    shape = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads of "
             f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}"
             if cfg.family != "ssm" else
             f"state {cfg.ssm_state}, {cfg.ssm_expand}x expand")
    rec_txt = ("; one decode step by graph replay == eager, logits and "
               "cache; cached prefill vs cache-free forward "
               f"{extra['prefill_vs_cache_free']:.3g} relative (bit-equal "
               f"{extra['prefill_bitwise_equal']})" if extra else "")
    print(f"{label} serve {tag}: {cfg.name} at full width (d "
          f"{cfg.d_model}, {shape}"
          + (f", {cfg.moe_experts} experts top-{cfg.moe_top_k}"
             if cfg.family == "moe" else "")
          + f", vocab {cfg.vocab_size}), depth "
          + (f"{cfg.encoder_layers} + {depth}" if frames is not None
             else f"cut to {depth}")
          + f", bf16, engine (8, 4) via launch/serve.py, batch {batch}, "
          f"prompt {prompt.shape[1]}"
          + (f" behind {cfg.vision_tokens} prefix tokens"
             if prefix is not None else "")
          + (f" over {max_len} encoder frames" if frames is not None
             else "")
          + f", gen {gen}: engine == fakequant bit for bit (prefill and "
          f"{gen} decode logits, tokens); after warm-up plans/binds/"
          f"captures/eager +0; cim_mbiw {launches} (all, tc, splitk; the "
          f"rest on the CUDA cores) = planned; first prefill "
          f"{eng['prefill_s']:.2f} s with "
          f"{len(binds.seconds)} binds in {sum(binds.seconds):.1f} s and "
          f"{caps['captures']} captures in {caps['seconds']:.1f} s; decode "
          f"{1e3 * per_step_s:.1f} ms a step host, "
          f"{batch / per_step_s:.2f} tokens/s; {dev_txt}; peak "
          f"{peak:.1f} GB, graph pool {rec['graph_pool_bytes'] / 2**30:.1f} "
          f"GiB{rec_txt}", flush=True)
    return rec, cfg, params, prompt, prefix


def moe_inflight(dev, tag, cfg, params, kern, kmod, tprog, clock) -> dict:
    """phi3.5-moe in flight through serve.inflight_serve at the served
    model's depth: MOE_INFLIGHT_REQUESTS requests at MOE_INFLIGHT_SLOTS
    slots, prompts of MOE_INFLIGHT_PROMPT tokens (a solo prefill's expert
    capacity is 8, the decode steps' bucket), every launch split-K and
    planned, no growth after warm-up.  In-flight MoE is not equal to solo
    decoding (the expert groups mix requests), so nothing holds that."""
    from repro_torch.launch import serve
    icfg = cfg.replace(cim=cfg.cim.replace(isolate_rows=True))
    reqs = serve.make_requests(cfg.vocab_size, MOE_INFLIGHT_REQUESTS,
                               MOE_INFLIGHT_PROMPT, MOE_GEN, 0)
    max_len = serve.serve_max_len(cfg, MOE_INFLIGHT_PROMPT, MOE_GEN)
    cap_mark = len(clock.seconds)
    reset_counts(kern)
    fused = serve.inflight_serve(icfg, params, reqs, MOE_INFLIGHT_SLOTS,
                                 max_len=max_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = kernel_counts(kern)
    caps = clock.since(cap_mark)
    check(fused["growth"] == {"plans": 0, "captures": 0, "binds": 0,
                              "eager_calls": 0},
          f"moe inflight: the loop after warm-up grew {fused['growth']}")
    pre = family_tiles(icfg, cfg.n_layers, MOE_INFLIGHT_PROMPT, kmod, tprog)
    dec = family_tiles(icfg, cfg.n_layers, MOE_INFLIGHT_SLOTS, kmod, tprog)
    want = len(reqs) * pre["splitk"] + fused["decode_steps"] * dec["splitk"]
    check(launches == (want, 0, want) and pre["tc"] == pre["cuda_core"]
          == dec["tc"] == dec["cuda_core"] == 0,
          f"moe inflight: cim_mbiw launches {launches} != planned {want}, "
          f"all split-K")
    check(len(set(fused["slot"].values())) > 1,
          "moe inflight: no request ever shared a step")
    check(all(len(fused["tokens"][r["uid"]]) == r["gen"] for r in reqs),
          "moe inflight: a request has the wrong length")
    toks = sum(len(t) for t in fused["tokens"].values())
    rec = {"depth": cfg.n_layers, "slots": MOE_INFLIGHT_SLOTS,
           "requests": len(reqs), "prompt": MOE_INFLIGHT_PROMPT,
           "tokens": toks, "decode_steps": fused["decode_steps"],
           "decode_s": fused["decode_s"], "wall_s": fused["wall_s"],
           "tokens_per_s_decode": toks / fused["decode_s"],
           "captures": caps, "growth": fused["growth"],
           "launches": dict(zip(("cim_mbiw", "cim_mbiw_tc",
                                 "cim_mbiw_splitk"), launches)),
           "streams": {str(u): t for u, t in fused["tokens"].items()}}
    print(f"moe inflight {tag}: {cfg.name} depth {cfg.n_layers}, "
          f"{len(reqs)} requests at {MOE_INFLIGHT_SLOTS} slots, prompt "
          f"{MOE_INFLIGHT_PROMPT}, {toks} tokens in {fused['decode_steps']} "
          f"fused steps: after warm-up plans/binds/captures/eager +0; "
          f"cim_mbiw {launches} (all split-K) = planned; "
          f"{caps['captures']} captures in {caps['seconds']:.1f} s; decode "
          f"{toks / fused['decode_s']:.2f} tokens/s over "
          f"{fused['decode_s']:.1f} s, wall {fused['wall_s']:.1f} s",
          flush=True)
    return rec


def moe_phase(dev, tag, kern, kmod, tprog, trt, clock) -> dict:
    """The moe and vlm families at full width (module docstring, phase
    13): the bank checks, the train steps, then phi3.5-moe's serve (the
    main path: static, in flight, and the sharded serve over its layers
    and binds), mixtral's and internvl2's."""
    from repro_torch.kernels.prng import kernel as pk
    t_phase = time.perf_counter()
    draw = pk.threefry_normal
    draw.launches = 0
    rec: dict = {"cuts": {
        MOE_ARCH: {"serve_depth": MOE_DEPTH, "train_depth": MOE_TRAIN_DEPTH,
                   "shard_depth": MOE_SHARD_DEPTH, "of": 32},
        MIXTRAL_ARCH: {"depth": MIXTRAL_DEPTH, "of": 56},
        VLM_ARCH: {"serve_depth": VLM_SERVE_DEPTH,
                   "train_depth": VLM_TRAIN_DEPTH, "of": 80}}}
    print(f"moe cuts {tag}: {MOE_ARCH} serve depth {MOE_DEPTH} of 32 (gen "
          f"{MOE_GEN}), train depth {MOE_TRAIN_DEPTH}, sharded serve depth "
          f"{MOE_SHARD_DEPTH}; {MIXTRAL_ARCH} depth {MIXTRAL_DEPTH} of 56; "
          f"{VLM_ARCH} serve depth {VLM_SERVE_DEPTH}, train depth "
          f"{VLM_TRAIN_DEPTH} of 80; widths, heads, experts and "
          f"vocabularies as published", flush=True)
    launches = dict.fromkeys(("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"),
                             0)
    flash = dict.fromkeys(FLASH_NAMES, 0)
    secs: dict = {}

    def add(lc):
        for k_ in launches:
            launches[k_] += lc[k_]

    t0 = time.perf_counter()
    reset_counts(kern)
    rec["bank"] = moe_bank_checks(dev, tag)
    add(dict(zip(launches, kernel_counts(kern))))
    secs["bank"] = time.perf_counter() - t0
    rec["train"] = {}
    for arch, depth, prefix, vs in (
            (MOE_ARCH, MOE_TRAIN_DEPTH, False, True),
            (MIXTRAL_ARCH, MIXTRAL_DEPTH, False, False),
            (VLM_ARCH, VLM_TRAIN_DEPTH, True, False)):
        t0 = time.perf_counter()
        tr = family_train_step(dev, tag, arch, depth, prefix=prefix,
                               vs_plain=vs)
        rec["train"][arch] = tr
        for k_ in FLASH_NAMES:
            flash[k_] += tr["launches_tc"][k_]
        check(tr["fits"] or arch == MIXTRAL_ARCH,
              f"{arch}: the train step did not fit the card")
        secs[f"train {arch}"] = time.perf_counter() - t0
    # the main path: phi3.5-moe static, in flight, sharded
    t0 = time.perf_counter()
    srec, cfg, params, _, _ = family_serve(
        dev, tag, MOE_ARCH, MOE_DEPTH, MOE_BATCH, MOE_PROMPT, MOE_GEN, kern,
        kmod, tprog, trt, clock)
    rec["serve"] = {MOE_ARCH: srec}
    add(srec["launches"])
    rec["inflight"] = moe_inflight(dev, tag, cfg, params, kern, kmod, tprog,
                                   clock)
    add(rec["inflight"]["launches"])
    reset_counts(kern)
    rec["shard"] = moe_shard_check(dev, tag, cfg, params)
    add(dict(zip(launches, kernel_counts(kern))))
    del params
    _free(dev)
    rec["fold"] = moe_fold_check(dev, tag)
    flash["flash_fwd"] += rec["fold"]["launches_tc"]["flash_fwd"]
    _free(dev)
    secs[f"serve {MOE_ARCH}"] = time.perf_counter() - t0
    for arch, depth, batch, plen, gen in (
            (MIXTRAL_ARCH, MIXTRAL_DEPTH, MOE_BATCH, MIXTRAL_PROMPT,
             MIXTRAL_GEN),
            (VLM_ARCH, VLM_SERVE_DEPTH, VLM_BATCH, VLM_PROMPT, VLM_GEN)):
        t0 = time.perf_counter()
        srec, *_ = family_serve(dev, tag, arch, depth, batch, plen, gen,
                                kern, kmod, tprog, trt, clock)
        rec["serve"][arch] = srec
        add(srec["launches"])
        _free(dev)
        secs[f"serve {arch}"] = time.perf_counter() - t0
    rec["launches"] = dict(launches, threefry_normal=draw.launches,
                           **{f"{k_}_tc": v for k_, v in flash.items()})
    rec["seconds"] = time.perf_counter() - t_phase
    rec["part_s"] = secs
    print(f"moe launches {tag}: {rec['launches']} in {rec['seconds']:.1f} s ("
          + ", ".join(f"{k_} {v:.1f}" for k_, v in secs.items()) + ")",
          flush=True)
    return rec


def moe_shard_check(dev, tag, cfg, params) -> dict:
    """phi3.5-moe at full width, its first MOE_SHARD_DEPTH layers (the
    static serve's weights and binds), batch MOE_BATCH x MOE_SHARD_PROMPT
    (32 rows: each expert's capacity is the decode steps' 8, so the
    unsharded serve replays the static serve's expert graphs), through
    serve.static_serve unsharded and with the launcher's CIMConfig
    sharded over MOE_SHARD_DEVICES macros folded onto the card
    (--engine-devices): tokens and every logit bit for bit equal, no
    growth after warm-up in either."""
    from repro_torch.launch import serve
    from repro_torch.runtime.engine import ShardingConfig
    cfg = cfg.replace(n_layers=MOE_SHARD_DEPTH)
    params = dict(params, layers=params["layers"][:MOE_SHARD_DEPTH])
    prompt = serve.make_prompt(cfg.vocab_size, MOE_BATCH, MOE_SHARD_PROMPT,
                               1, dev)
    max_len = serve.serve_max_len(cfg, MOE_SHARD_PROMPT, MOE_SHARD_GEN)

    def sharding(d):
        return ShardingConfig(devices=d, fold_onto=dev.type)
    runs = {}
    for label, sh in (("unsharded", None),
                      (f"D{MOE_SHARD_DEVICES}", sharding(MOE_SHARD_DEVICES))):
        c = cfg.replace(cim=cfg.cim.replace(sharding=sh))
        t0 = time.perf_counter()
        out = serve.static_serve(c, params, prompt, MOE_SHARD_GEN,
                                 max_len=max_len, keep_logits=True)
        out["wall_s"] = time.perf_counter() - t0
        check(all(v == 0 for v in out["growth"].values()),
              f"moe shard serve {label}: the decode loop grew "
              f"{out['growth']}")
        del out["cache"]
        runs[label] = out
    a, b = runs.values()
    check(torch.equal(a["tokens"], b["tokens"])
          and all(torch.equal(x, y) for x, y in zip(a["logits"],
                                                    b["logits"])),
          "moe shard serve: sharded tokens or logits != unsharded")
    rec = {lbl: {"tokens": o["tokens"].tolist(), "wall_s": o["wall_s"],
                 "prefill_s": o["prefill_s"],
                 "decode_host_ms_per_step":
                 1e3 * o["decode_s"] / max(o["steps"], 1)}
           for lbl, o in runs.items()}
    print(f"shard moe {tag}: {cfg.name} at full width, depth "
          f"{MOE_SHARD_DEPTH} (cut from 32), bf16, engine (8, 4), batch "
          f"{prompt.shape[0]}, prompt {prompt.shape[1]}, gen "
          f"{MOE_SHARD_GEN}, --engine-devices {MOE_SHARD_DEVICES} folded: "
          f"tokens and every logit == unsharded; no growth after warm-up; "
          + ", ".join(f"{k_} wall {v['wall_s']:.1f} s" for k_, v in
                      rec.items()), flush=True)
    return rec


@contextlib.contextmanager
def dropped_pairs(moe):
    """While open, (tokens, slots, dropped (token, choice) pairs) of every
    capacity grid moe_block builds, in call order (`moe.capacity_grid`
    wrapped; put back on exit)."""
    calls: list = []
    inner = moe.capacity_grid

    def counted(probs, top_idx, **kw):
        tok_grid, gate_grid, keep = inner(probs, top_idx, **kw)
        calls.append((top_idx.shape[0], tok_grid.shape[1],
                      int((~keep).sum())))
        return tok_grid, gate_grid, keep
    moe.capacity_grid = counted
    try:
        yield calls
    finally:
        moe.capacity_grid = inner


def moe_fold_check(dev, tag) -> dict:
    """phi3.5-moe at full width, its first MOE_SHARD_DEPTH layers, bf16,
    bypass, batch MOE_FOLD_TOKENS, forward under a ("data", "model")
    mesh of MOE_FOLD_MESH folded onto the card (moe_block's split of
    JAX's shard_map path: the tokens over data, the experts' d_ff over
    model, the parts summed in order): with the flash kernels (counted:
    a launch for each of flash_attention_sharded's pieces a layer, each
    on the tensor cores) against the same forward through plain
    attention, the CE loss within TRAIN_JNP_RTOL["loss"].  Routing flips
    between the two move the CE as much as attention's rounding does, so
    what attention alone decides is held too: the first layer's attention
    block on the same input under the same mesh, flash (its pieces at
    their q offsets) against plain, within MOE_FOLD_ATTN_RTOL.  The split
    against the unsplit forward is reported beside the (token, choice)
    pairs each run's capacity grids drop (each shard's capacity is its
    own, so they differ)."""
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn.ops import sharded_pieces
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve, steps
    from repro_torch.models import common as cm
    from repro_torch.models import moe as tmoe
    from repro_torch.models import sharding as tsh
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    cfg = serve.get_config(MOE_ARCH).replace(
        n_layers=MOE_SHARD_DEPTH, attn_impl="pallas",
        cim=CIMConfig(mode="bypass"))
    plain_cfg = cfg.replace(attn_impl="jnp")
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (MOE_FOLD_TOKENS[0],
                                             MOE_FOLD_TOKENS[1] + 1),
                         generator=gen, device=dev)
    mesh = tmesh.make_mesh(MOE_FOLD_MESH, ("data", "model"), fold_onto=dev)
    n_model = MOE_FOLD_MESH[1]
    runs = {}
    for label, c, m in (("flash", cfg, mesh), ("plain", plain_cfg, mesh),
                        ("unsplit", plain_cfg, None)):
        fk.flash_fwd.launches = fk.flash_fwd.launches_tc = 0
        with torch.no_grad(), (tsh.use_mesh(m) if m is not None
                               else contextlib.nullcontext()), \
                dropped_pairs(tmoe) as grids:
            logits = tf.forward(c, params, toks[:, :-1])[0]
            ce = float(steps.cross_entropy(logits, toks[:, 1:]))
        torch.cuda.synchronize()
        # a model part routes its token part as the others do: one grid
        # of each group of n_model is the token part's
        step = n_model if m is not None else 1
        groups = [grids[i:i + step] for i in range(0, len(grids), step)]
        check(all(len(set(g_)) == 1 for g_ in groups),
              f"moe fold {label}: the model parts' capacity grids differ: "
              f"{grids}")
        runs[label] = {"ce": ce, "logits": logits.float(),
                       "launches": fk.flash_fwd.launches,
                       "launches_tc": fk.flash_fwd.launches_tc,
                       "grids": [g_[0] for g_ in groups]}
    fl, pl, un = runs["flash"], runs["plain"], runs["unsplit"]
    # under the mesh flash_attention_sharded splits each layer's query
    # into its pieces too (batch over data, sequence over model)
    pieces = len(sharded_pieces(mesh, *MOE_FOLD_TOKENS) or [None])
    check(fl["launches"] == fl["launches_tc"] == cfg.n_layers * pieces
          and pl["launches"] == 0,
          f"moe fold: flash launches {fl['launches']} (tensor cores "
          f"{fl['launches_tc']}), want {pieces} pieces a layer "
          f"({cfg.n_layers}); plain {pl['launches']}")
    check(all(bool(torch.isfinite(r["logits"]).all()) for r in runs.values())
          and tuple(fl["logits"].shape) == (MOE_FOLD_TOKENS[0],
                                            MOE_FOLD_TOKENS[1],
                                            cfg.vocab_size),
          "moe fold: non-finite logits or the wrong shape")
    vs = abs(fl["ce"] - pl["ce"]) / abs(pl["ce"])
    check(vs <= TRAIN_JNP_RTOL["loss"],
          f"moe fold: flash vs plain CE {vs:.3g} outside "
          f"{TRAIN_JNP_RTOL['loss']}")

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    # the first layer's attention block, flash against plain, on the
    # embedded tokens under the folded mesh (these launches compare, they
    # are not counted)
    p0 = params["layers"][0]
    with torch.no_grad(), tsh.use_mesh(mesh):
        h0 = cm.apply_norm(p0["ln1"], tf.embed_tokens(
            cfg, params, toks[:, :-1]), cfg.norm_type)
        pos = torch.arange(h0.shape[1], device=dev)
        attn = {label: cm.attention_block(
            p0["attn"], h0, tf._attn_cfg(c, window=c.sliding_window),
            c.cim, positions=pos)[0].float()
            for label, c in (("flash", cfg), ("plain", plain_cfg))}
    attn_vs = rel(attn["flash"], attn["plain"])
    check(attn_vs <= MOE_FOLD_ATTN_RTOL
          and bool(torch.isfinite(attn["flash"]).all()),
          f"moe fold: the first layer's attention block, flash vs plain "
          f"under the folded mesh, {attn_vs:.3g} relative > "
          f"{MOE_FOLD_ATTN_RTOL}")

    def dropped(r):
        return sum(g_[2] for g_ in r["grids"])
    pairs = MOE_FOLD_TOKENS[0] * MOE_FOLD_TOKENS[1] * cfg.moe_top_k \
        * cfg.n_layers
    rec = {"mesh": MOE_FOLD_MESH, "tokens": MOE_FOLD_TOKENS,
           "depth": MOE_SHARD_DEPTH, "ce": {k: v["ce"] for k, v in
                                            runs.items()},
           "ce_flash_vs_plain": vs,
           "attn_flash_vs_plain": attn_vs,
           "logits_flash_vs_plain": rel(fl["logits"], pl["logits"]),
           "logits_split_vs_unsplit": rel(pl["logits"], un["logits"]),
           "grids": {k: v["grids"] for k, v in runs.items()},
           "dropped_pairs": {k: dropped(v) for k, v in runs.items()},
           "routed_pairs": pairs,
           "launches_tc": {"flash_fwd": fl["launches_tc"]},
           "seconds": time.perf_counter() - t0}
    print(f"moe fold {tag}: {cfg.name} at full width, depth "
          f"{MOE_SHARD_DEPTH} (cut from 32), bf16, bypass, batch "
          f"{MOE_FOLD_TOKENS[0]} x {MOE_FOLD_TOKENS[1]}, (data, model) "
          f"{MOE_FOLD_MESH} folded onto the card: flash (launches "
          f"{fl['launches_tc']}: {pieces} pieces a layer, tensor cores) "
          f"vs plain attention CE "
          f"{fl['ce']:.5f} / {pl['ce']:.5f} ({vs:.3g}, limit "
          f"{TRAIN_JNP_RTOL['loss']}), the first layer's attention block "
          f"{attn_vs:.3g} relative (limit {MOE_FOLD_ATTN_RTOL:.3g}), logits "
          f"{rec['logits_flash_vs_plain']:.3g} relative; split vs unsplit "
          f"logits {rec['logits_split_vs_unsplit']:.3g} (per-shard "
          f"capacity, reported); dropped (token, choice) pairs of {pairs} "
          + ", ".join(f"{k} {v}" for k, v in rec["dropped_pairs"].items())
          + " (grids: tokens, slots, dropped: " + "; ".join(
              f"{k} {v['grids']}" for k, v in runs.items())
          + f") in {rec['seconds']:.1f} s", flush=True)
    del params, runs, attn
    return rec


# phase 14: the hybrid and ssm families at full width
REC_ARCH = "recurrentgemma-2b"
REC_SERVE_DEPTH = 8               # of 26: two blocks of 3 and the tail of 2
REC_TRAIN_DEPTH = 5               # one block and the tail
SSM_ARCH = "mamba2-1.3b"
SSM_SERVE_DEPTH = 4               # of 48
SSM_TRAIN_DEPTH = 4
REC_BATCH = 4
REC_PROMPT = 32
REC_GEN = 16
REC_TRAIN_SEQ = 4096              # so recurrentgemma's 2048 window cuts
REC_TRAIN_STEPS = 3
# the cached prefill's last logits against the cache-free forward's
# (bf16, relative L2): the same recurrences in one call each
PREFILL_RTOL = 1e-2
# recurrentgemma's attention: B, H, G, S, D, window (causal, bf16)
FLASH_REC = ((1, 10, 1, REC_TRAIN_SEQ, 256, 2048),)


def flash_d256_cases() -> list:
    """flash_cases()' form at D 256, in both dtypes: recurrentgemma's
    attention (MQA at rep 10, S 4096, causal, window 2048), a ragged S
    with rep 2, a window and a query offset, and a non-causal case.  bf16
    runs the forward, dq and dk/dv on the tensor cores, float32 on the
    CUDA-core kernels' second head-dimension bound."""
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, g, s_, d, window in FLASH_REC:
            out.append((b, h, g, s_, s_, d, True, window, 0, dtype))
        out.append((1, 4, 2, 1000, 1000, 256, True, 256, 100, dtype))
        out.append((2, 4, 2, 777, 513, 256, False, 0, 0, dtype))
    return out


def flash_d256_times(fk, fref, dev, tag) -> dict:
    """CUDA-event ms of the three flash kernels at recurrentgemma's
    attention shape in bf16 (all three on the tensor cores), the CUDA-core
    forward, dq and dk/dv kernels of the earlier design on the same inputs
    (each must agree with its tensor-core kernel and be slower), their
    plain versions and SDPA forward / backward with the boolean
    causal-window mask, with bounds; the launches made here are not
    main-path ones."""
    b, h, g, s_, d, window = FLASH_REC[0]
    q, k, v, do = flash_inputs(b, h, g, s_, s_, d, torch.bfloat16, 9, dev)
    q_off = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=window)
    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    before = [(f.launches, f.launches_tc) for f in kerns]
    o, lse = fk.flash_fwd(q, k, v, q_off, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, q_off)
    dq = fk.flash_bwd_dq(*args, **kw)
    dk, dv = fk.flash_bwd_dkv(*args, **kw)
    tc1 = [f.launches_tc - n_tc for f, (_, n_tc) in zip(kerns, before)]
    check(tc1 == [1, 1, 1],
          f"tensor-core launches {tc1} (forward, dq, dk/dv) of a bf16 D "
          f"256 call; expected [1, 1, 1]: all three on the tensor cores")
    core = cuda_core_fns(fk, *args, causal=True, window=window)
    pos = torch.arange(s_, device=dev)
    rel = pos[:, None] - pos[None, :]
    mask = (rel >= 0) & (rel < window)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), do)
    check(torch.allclose(sdpa().float(), o.float(), rtol=2e-2, atol=2e-2),
          "the SDPA yardstick computes another function than flash_fwd at "
          "D 256")
    # the earlier design against the kernels on the same inputs (the
    # phase-2 limits; a bf16 O one ulp apart)
    for kind in ("fwd", "dq", "dkv"):
        core[kind]()
    torch.cuda.synchronize()
    o_core, lse_core, dq_core, dk_core, dv_core = core["outputs"]
    check(torch.allclose(o.float(), o_core.float(), rtol=2.0**-7, atol=2e-5)
          and torch.allclose(lse, lse_core, rtol=2e-5, atol=2e-5)
          and torch.allclose(dq, dq_core, rtol=5e-5, atol=5e-5)
          and torch.allclose(dk, dk_core, rtol=5e-5, atol=5e-5)
          and torch.allclose(dv, dv_core, rtol=5e-5, atol=5e-5),
          "the CUDA-core kernels of the earlier design disagree with the "
          "tensor-core ones at D 256")
    dq_vs_core = float((dq - dq_core).abs().max())
    print(f"recurrent dq {tag}: the tensor-core dq against the CUDA-core "
          f"dq of the earlier design on recurrentgemma's inputs: max |diff| "
          f"{dq_vs_core:.3g} (limit 5e-5 + 5e-5 |x|)", flush=True)
    del dq
    fns = {"fwd": (lambda: fk.flash_fwd(q, k, v, q_off, **kw),
                   lambda: fref.flash_fwd_ref(q, k, v, q_off, **kw)),
           "dq": (lambda: fk.flash_bwd_dq(*args, **kw),
                  lambda: fref.flash_bwd_dq_ref(*args, **kw)),
           "dkv": (lambda: fk.flash_bwd_dkv(*args, **kw),
                   lambda: fref.flash_bwd_dkv_ref(*args, **kw))}
    sdpa_fwd = cuda_ms(sdpa, 5)
    sdpa_bwd = cuda_ms(sdpa_fwd_bwd, 5) - sdpa_fwd
    out = {"shape": {"b": b, "h": h, "g": g, "s": s_, "d": d,
                     "causal": True, "window": window, "dtype": "bfloat16"},
           "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd,
           "dq_vs_cuda_core_max_abs": dq_vs_core}
    for kind, (kern, plain) in fns.items():
        bnd, by = flash_bound_ms(kind, b, h, g, s_, s_, d, True, window, 2)
        out[kind] = {"ms": cuda_ms(kern, 5), "plain_ms": cuda_ms(plain, 2),
                     "bound_ms": bnd, "bound_by": by,
                     "library_ms": sdpa_fwd if kind == "fwd" else sdpa_bwd,
                     "route": "tensor cores",
                     "cuda_core_ms": cuda_ms(core[kind], 3)}
        r = out[kind]
        print(f"time {tag} flash_{kind} ({r['route']}) B={b} H={h} G={g} "
              f"S={s_} D={d} causal window {window} bf16: kernel "
              f"{r['ms']:.3f} ms, CUDA-core kernel (earlier design) "
              f"{r['cuda_core_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"SDPA "
              f"{'forward' if kind == 'fwd' else 'backward (dq, dk, dv)'}"
              f" with the boolean mask {r['library_ms']:.3f} ms, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
    check(all(out[kind]["ms"] < out[kind]["cuda_core_ms"]
              for kind in ("fwd", "dq", "dkv")),
          "a D 256 tensor-core kernel is slower than the CUDA-core kernel "
          "it replaces")
    for f, (n, n_tc) in zip(kerns, before):
        f.launches, f.launches_tc = n, n_tc
    return out


def recurrent_phase(dev, tag, kern, kmod, tprog, trt, clock) -> dict:
    """The hybrid and ssm families at full width (module docstring, phase
    14): the flash kernels at D 256 against their plain versions and their
    times, then recurrentgemma-2b's and mamba2-1.3b's train steps and
    static engine serves."""
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ref as fref
    t_phase = time.perf_counter()
    rec: dict = {"cuts": {
        REC_ARCH: {"serve_depth": REC_SERVE_DEPTH,
                   "train_depth": REC_TRAIN_DEPTH, "of": 26},
        SSM_ARCH: {"serve_depth": SSM_SERVE_DEPTH,
                   "train_depth": SSM_TRAIN_DEPTH, "of": 48}}}
    print(f"recurrent cuts {tag}: {REC_ARCH} serve depth "
          f"{REC_SERVE_DEPTH}, train depth {REC_TRAIN_DEPTH} of 26 (blocks "
          f"of two RG-LRU layers and local attention, then the 2-layer "
          f"tail); {SSM_ARCH} serve depth {SSM_SERVE_DEPTH}, train depth "
          f"{SSM_TRAIN_DEPTH} of 48; widths, heads, state, window and "
          f"vocabularies as published", flush=True)
    secs: dict = {}
    t0 = time.perf_counter()
    checks = flash_checks(fk, fref, dev, cases=flash_d256_cases())
    rec["flash_vs_plain"] = checks
    print(f"recurrent kernels {tag}: flash_fwd / flash_bwd_dq / "
          f"flash_bwd_dkv at D 256 (bf16 on the tensor cores; float32 on "
          f"the CUDA-core kernels' second bound) "
          f"within tolerance of plain on {checks['cases']} cases "
          f"(recurrentgemma's B 1 H 10 G 1 S {REC_TRAIN_SEQ} causal window "
          f"2048; S 1000 rep 2 window 256 q_off 100; non-causal Sq 777 Sk "
          f"513; float32 and bf16); max_abs_err f32 / bf16 "
          + ", ".join(f"{k_} {v['float32']:.3g} / {v['bfloat16']:.3g}"
                      for k_, v in checks["max_abs_err"].items())
          + "; every backward bit-equal on a second run", flush=True)
    rec["flash_times"] = flash_d256_times(fk, fref, dev, tag)
    secs["flash"] = time.perf_counter() - t0
    launches = dict.fromkeys(("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"),
                             0)
    flash = dict.fromkeys(FLASH_NAMES, 0)
    flash_tc = dict.fromkeys(FLASH_NAMES, 0)
    rec["train"] = {}
    for arch, depth, vs in ((REC_ARCH, REC_TRAIN_DEPTH, True),
                            (SSM_ARCH, SSM_TRAIN_DEPTH, False)):
        t0 = time.perf_counter()
        tr = family_train_step(dev, tag, arch, depth, vs_plain=vs,
                               seq=REC_TRAIN_SEQ, n_steps=REC_TRAIN_STEPS,
                               shapes=FLASH_REC, label="recurrent")
        check(tr["fits"], f"{arch}: the train steps did not fit the card")
        rec["train"][arch] = tr
        for k_ in FLASH_NAMES:
            flash[k_] += tr["launches"][k_]
            flash_tc[k_] += tr["launches_tc"][k_]
        _free(dev)
        secs[f"train {arch}"] = time.perf_counter() - t0
    check(all(v > 0 for v in flash.values()),
          f"recurrentgemma's train steps launched no D 256 flash kernel: "
          f"{flash}")
    rec["serve"] = {}
    for arch, depth in ((REC_ARCH, REC_SERVE_DEPTH),
                        (SSM_ARCH, SSM_SERVE_DEPTH)):
        t0 = time.perf_counter()
        srec, *_ = family_serve(dev, tag, arch, depth, REC_BATCH,
                                REC_PROMPT, REC_GEN, kern, kmod, tprog, trt,
                                clock, label="recurrent",
                                replay_checks=True)
        rec["serve"][arch] = srec
        for k_ in launches:
            launches[k_] += srec["launches"][k_]
        _free(dev)
        secs[f"serve {arch}"] = time.perf_counter() - t0
    rec["launches"] = dict(launches, **flash,
                           **{f"{k_}_tc": v for k_, v in flash_tc.items()})
    rec["seconds"] = time.perf_counter() - t_phase
    rec["part_s"] = secs
    print(f"recurrent launches {tag}: {rec['launches']} (flash at D 256: "
          f"the `_tc` counts on the tensor cores) in {rec['seconds']:.1f} s ("
          + ", ".join(f"{k_} {v:.1f}" for k_, v in secs.items()) + ")",
          flush=True)
    return rec


AUDIO_ARCH = "whisper-medium"
AUDIO_DEPTH = 24                  # of 24: encoder and decoder, uncut
AUDIO_BATCH = 4
AUDIO_PROMPT = 1476               # max_len = 1476 + 16 + 8 = 1500 frames
AUDIO_GEN = 16
AUDIO_FRAMES = 1500               # Whisper's 30 s window of mel frames
AUDIO_TRAIN_STEPS = 3
# whisper-medium's attention in a train step over AUDIO_FRAMES frames and
# min(448, 1500 // 8) = 187 tokens: B, H, G, Sq, Sk, D, causal - the
# encoder's, the decoder's and the cross-attention
FLASH_AUDIO = ((1, 16, 16, AUDIO_FRAMES, AUDIO_FRAMES, 64, False),
               (1, 16, 16, 187, 187, 64, True),
               (1, 16, 16, 187, AUDIO_FRAMES, 64, False))


def flash_audio_cases() -> list:
    """flash_cases()' form for FLASH_AUDIO: each shape in bf16 (on the
    tensor cores), and the cross-attention in float32 too."""
    out = [(b, h, g, sq, sk, d, causal, 0, 0, torch.bfloat16)
           for b, h, g, sq, sk, d, causal in FLASH_AUDIO]
    b, h, g, sq, sk, d, causal = FLASH_AUDIO[2]
    return out + [(b, h, g, sq, sk, d, causal, 0, 0, torch.float32)]


def audio_phase(dev, tag, kern, kmod, tprog, trt, clock) -> dict:
    """The audio family at full width (module docstring, phase 15):
    the flash kernels at whisper-medium's attention shapes against their
    plain versions and their times, then its train steps and its static
    engine serve."""
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ref as fref
    from repro_torch.kernels.prng import kernel as pk
    t_phase = time.perf_counter()
    draw = pk.threefry_normal
    draw.launches = 0
    rec: dict = {"cuts": {AUDIO_ARCH: {"encoder_depth": AUDIO_DEPTH,
                                       "decoder_depth": AUDIO_DEPTH,
                                       "of": 24}}}
    print(f"audio cuts {tag}: {AUDIO_ARCH} encoder and decoder depth "
          f"{AUDIO_DEPTH} of 24 each, served and trained; widths, heads, "
          f"vocabulary, max_target_len 448 and Whisper's {AUDIO_FRAMES} "
          f"encoder frames as published", flush=True)
    secs: dict = {}
    t0 = time.perf_counter()
    checks = flash_checks(fk, fref, dev, cases=flash_audio_cases())
    rec["flash_vs_plain"] = checks
    (_, h, _, se, _, d, _), (_, _, _, st, _, _, _), _ = FLASH_AUDIO
    print(f"audio kernels {tag}: flash_fwd / flash_bwd_dq / flash_bwd_dkv "
          f"at whisper-medium's attention (B 1, H {h}, D {d}: the "
          f"encoder's {se} x {se}, the decoder's causal {st} x {st} and "
          f"the cross-attention's {st} x {se}, bf16 on the tensor cores; "
          f"the cross-attention in float32 too) within tolerance of plain "
          f"on {checks['cases']} cases; max_abs_err f32 "
          f"/ bf16 " + ", ".join(f"{k_} {v['float32']:.3g} / "
                                 f"{v['bfloat16']:.3g}"
                                 for k_, v in checks["max_abs_err"].items())
          + "; every backward bit-equal on a second run", flush=True)
    rec["flash_times"] = {
        f"{sq}x{sk}" + (" causal" if causal else ""): flash_times(
            fk, fref, dev, tag, (b, h, g, sq, sk, d, causal),
            what=" at whisper's")
        for b, h, g, sq, sk, d, causal in FLASH_AUDIO}
    secs["flash"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = family_train_step(dev, tag, AUDIO_ARCH, AUDIO_DEPTH, vs_plain=True,
                           seq=AUDIO_FRAMES, n_steps=AUDIO_TRAIN_STEPS,
                           shapes=FLASH_AUDIO, label="audio")
    check(tr["fits"], f"{AUDIO_ARCH}: the train steps did not fit the card")
    rec["train"] = tr
    check(all(n > 0 for n in tr["launches_tc"].values())
          and tr["launches_tc"] == tr["launches"],
          f"{AUDIO_ARCH}: flash launches {tr['launches']}, on the tensor "
          f"cores {tr['launches_tc']}: every one must be on the tensor "
          f"cores")
    _free(dev)
    secs["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    srec, *_ = family_serve(dev, tag, AUDIO_ARCH, AUDIO_DEPTH, AUDIO_BATCH,
                            AUDIO_PROMPT, AUDIO_GEN, kern, kmod, tprog, trt,
                            clock, label="audio", replay_checks=True)
    check(srec["frames"] == AUDIO_FRAMES,
          f"{AUDIO_ARCH}: served over {srec['frames']} frames, not "
          f"{AUDIO_FRAMES}")
    rec["serve"] = srec
    _free(dev)
    secs["serve"] = time.perf_counter() - t0
    rec["launches"] = dict(srec["launches"], threefry_normal=draw.launches,
                           **{f"{k_}_tc": v
                              for k_, v in tr["launches_tc"].items()})
    rec["seconds"] = time.perf_counter() - t_phase
    rec["part_s"] = secs
    print(f"audio launches {tag}: {rec['launches']} in {rec['seconds']:.1f} "
          f"s (" + ", ".join(f"{k_} {v:.1f}" for k_, v in secs.items())
          + ")", flush=True)
    return rec


FLASH_PAIRS = ((1, 77), (77, 77), (512, 512), (4096, 4096), (77, 4096),
               (4096, 77), (512, 1), (77, 512))
# the train path's attention: B, H, G, S, D (causal, bf16)
FLASH_TRAIN = (TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128)
# the dense path's attention (phase 12), one per config of DENSE_ARCHS:
# B, H, G, S, D (causal) and the dtype of q; qwen2-7b's float32 QKV bias
# promotes q, k and v to float32, as in JAX, so its step runs the float32
# kernels
FLASH_DENSE = ((1, 32, 8, DENSE_SEQ, 128, torch.bfloat16),
               (1, 24, 8, DENSE_SEQ, 128, torch.bfloat16),
               (1, 28, 4, DENSE_SEQ, 128, torch.float32))
# the moe phase's train steps (phase 13): B, H, G, S, D, window, causal,
# bf16 - phi3.5-moe, mixtral (its 4096 window over 512 tokens) and
# internvl2 (512 text tokens behind 256 prefix tokens)
FLASH_MOE = ((1, 32, 8, MOE_TRAIN_SEQ, 128, 0),
             (1, 48, 8, MOE_TRAIN_SEQ, 128, 4096),
             (1, 64, 8, MOE_TRAIN_SEQ + 256, 128, 0))


def flash_cases() -> list:
    """(b, h, g, sq, sk, d, causal, window, q_off, dtype): every causal x
    window {0, 256} x rep {1, 2, 16} x D {64, 128}, each at one (Sq, Sk)
    pair (cycling through ragged sizes in {1, 77, 512, 4096}), q_off and
    dtype alternating; then the train shape in bf16 and float32; then
    the dense configs' step shapes (FLASH_DENSE, reps 4, 3 and 7) and
    the moe phase's (FLASH_MOE, reps 4, 6 and 8)."""
    out = []
    i = 0
    for causal in (True, False):
        for window in (0, 256):
            for rep in (1, 2, 16):
                for d in (64, 128):
                    sq, sk = FLASH_PAIRS[i % len(FLASH_PAIRS)]
                    g = 1 if rep == 16 else 2
                    dtype = (torch.float32, torch.bfloat16)[(i // 2) % 2]
                    out.append((1, g * rep, g, sq, sk, d, causal, window,
                                (0, 100)[i % 2], dtype))
                    i += 1
    b, h, g, s, d = FLASH_TRAIN
    out.append((b, h, g, s, s, d, True, 0, 0, torch.bfloat16))
    out.append((b, h, g, s, s, d, True, 0, 0, torch.float32))
    out += [(b, h, g, s, s, d, True, 0, 0, dtype)
            for b, h, g, s, d, dtype in FLASH_DENSE]
    out += [(b, h, g, s, s, d, True, window, 0, torch.bfloat16)
            for b, h, g, s, d, window in FLASH_MOE]
    return out


def flash_inputs(b, h, g, sq, sk, d, dtype, seed, dev, q_scale=1.0,
                 k_scale=1.0) -> list:
    """q, dO (B, H, Sq, D) and k, v (B, G, Sk, D) as transposed views of
    (B, S, heads, D) tensors, the layout the model passes; standard
    normals, q and k times their scales before the cast to `dtype`."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(s_, heads, scale=1.0):
        return (torch.randn((b, s_, heads, d), generator=gen, device=dev,
                            dtype=torch.float32) * scale).to(dtype) \
            .transpose(1, 2)
    return [rand(sq, h, q_scale), rand(sk, g, k_scale), rand(sk, g),
            rand(sq, h)]


# two bf16 cases at D 128 that stress the hi/lo split of P and dS: peaked
# rows (q and k times 8, so one key takes p ~ 1; |s| reaches ~200) and
# long flat rows (q times 0.01: p ~ 1 / i over up to 4096 keys).
# (name, (b, h, g, sq, sk, d, causal, window, q_off, dtype), q and k scale)
FLASH_STRESS = (
    ("peaked", (1, 16, 16, 1024, 1024, 128, True, 0, 0, torch.bfloat16),
     8.0, 8.0),
    ("flat", (1, 16, 16, 4096, 4096, 128, True, 0, 0, torch.bfloat16),
     0.01, 1.0),
)


def flash_exact(q, k, v, do, lse, delta, q_off, causal, window) -> dict:
    """The flash kernels' functions in float64 from the same inputs (lse
    and delta are inputs of the backward): O, lse, dq, dk, dv."""
    from repro_torch.kernels.flash_attn.ref import flash_keep_mask
    rep = q.shape[1] // k.shape[1]
    qd, dod = q.double(), do.double()
    kd, vd = (t.double().repeat_interleave(rep, dim=1) for t in (k, v))
    scale = 1.0 / q.shape[3] ** 0.5
    keep = flash_keep_mask(q.shape[2], k.shape[2], q_off, causal=causal,
                           window=window)
    s = scale * torch.matmul(qd, kd.transpose(-1, -2))
    masked = torch.where(keep, s, -1e30)
    out = {"o": torch.matmul(torch.softmax(masked, -1), vd),
           "lse": torch.logsumexp(masked, -1)}
    p = torch.where(keep, torch.exp(s - lse.double()[..., None]), 0.0)
    ds = p * (torch.matmul(dod, vd.transpose(-1, -2))
              - delta.double()[..., None]) * scale
    out["dq"] = torch.matmul(ds, kd)
    out["dk"] = torch.matmul(ds.transpose(-1, -2), qd)
    out["dv"] = torch.matmul(p.transpose(-1, -2), dod)
    return out


def flash_bound_ms(kind, b, h, g, sq, sk, d, causal, window, elt) -> tuple:
    """Least time (ms) of one flash kernel call and what bounds it: the
    products over the kept pairs (forward 2, dq 3, dk/dv 4 products of
    2*D operations a pair) at the bf16 tensor-core rate, against each
    input read once and each output written once (`elt` bytes an element
    of q/k/v/dO; lse, delta and the gradients float32): `costs.flash`."""
    return costs.bound_ms(costs.flash(kind, b, h, g, sq, sk, d, causal,
                                      window, elt), CARD)


def flash_checks(fk, fref, dev, cases=None) -> dict:
    """Each flash kernel against its plain version on every case of
    flash_cases() and the FLASH_STRESS cases (or on `cases` alone, of
    flash_cases()' form); each backward twice, bit for bit equal; each
    kernel of a bf16 case with D in its row of FLASH_TC_HEAD_DIMS on its
    tensor-core kernel (`.launches_tc` rises), every other call on the
    CUDA-core kernels.
    Returns
    the largest absolute error of each kernel per input dtype.

    Both sides compute in float32 or wider from the same inputs, so lse,
    dq, dk and dv (float32 outputs) keep the float32 limits whatever the
    input dtype.  A bfloat16 O is rounded from two float32 sums that
    differ in their last bits, so it may sit one bf16 ulp apart: at most
    2^-7 of |O|.

    The peaked case is held to the exact (float64) answer instead: there
    |s| reaches ~200, where float32 itself moves s by ~1e-4 whatever the
    order of the sum, and the plain float32 version misses the limits
    against float64 (O, dq, dk, dv).  Each output must sit within its limit
    plus the plain version's own largest distance from float64 (the
    float32 noise floor of these inputs, measured in the same run)."""
    errs = {kind: {"float32": 0.0, "bfloat16": 0.0}
            for kind in ("fwd", "dq", "dkv")}
    tf_, tb = 2e-5, 5e-5
    if cases is None:
        cases = [(c, 1.0, 1.0, "") for c in flash_cases()] + [
            (c, qs, ks, name) for name, c, qs, ks in FLASH_STRESS]
    else:
        cases = [(c, 1.0, 1.0, "") for c in cases]
    stress = {}
    for i, ((b, h, g, sq, sk, d, causal, window, off, dtype), qs, ks,
            name) in enumerate(cases):
        q, k, v, do = flash_inputs(b, h, g, sq, sk, d, dtype, 100 + i, dev,
                                   qs, ks)
        q_off = torch.full((1, 1), off, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, window=window)
        dt = str(dtype).split(".")[-1]
        tc_fns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
        want_tc = [n if dtype == torch.bfloat16
                   and d in fk.FLASH_TC_HEAD_DIMS[name_] else 0
                   for name_, n in zip(FLASH_NAMES, (1, 2, 2))]
        tc0 = [f.launches_tc for f in tc_fns]
        o_rtol = tf_ if dtype == torch.float32 else 2.0**-7
        what = (f"b={b} h={h} g={g} sq={sq} sk={sk} d={d} causal={causal} "
                f"window={window} q_off={off} {dtype}"
                + (f" ({name}: q x{qs}, k x{ks})" if name else ""))
        o, lse = fk.flash_fwd(q, k, v, q_off, **kw)
        o_ref, lse_ref = fref.flash_fwd_ref(q, k, v, q_off, **kw)
        delta = torch.sum(do.float() * o_ref.float(), dim=-1)
        args = (q, k, v, do, lse_ref, delta, q_off)
        dq = fk.flash_bwd_dq(*args, **kw)
        dk, dv = fk.flash_bwd_dkv(*args, **kw)
        dq_ref = fref.flash_bwd_dq_ref(*args, **kw)
        dk_ref, dv_ref = fref.flash_bwd_dkv_ref(*args, **kw)
        torch.cuda.synchronize()
        if name == "peaked":
            exact = flash_exact(*args, causal, window)
            o32, _ = fref.flash_fwd_ref(q.float(), k.float(), v.float(),
                                        q_off, **kw)
            rec = {}
            for key, got, plain, rtol, tol in (
                    ("o", o, o32, o_rtol, tf_), ("lse", lse, lse_ref, tf_,
                                                 tf_),
                    ("dq", dq, dq_ref, tb, tb), ("dk", dk, dk_ref, tb, tb),
                    ("dv", dv, dv_ref, tb, tb)):
                floor = float((plain.double() - exact[key]).abs().max())
                dist = (got.double() - exact[key]).abs()
                # the largest share of its tolerance an element uses
                used = float((dist / (rtol * exact[key].abs() + tol + floor))
                             .max())
                rec[key] = {"kernel_vs_f64": float(dist.max()),
                            "plain_vs_f64": floor, "tolerance_used": used}
                check(used <= 1.0,
                      f"{key} farther from float64 than its limit plus the "
                      f"plain version's float32 noise at {what}: {rec}")
            stress[name] = rec
            del exact, o32
        else:
            check(torch.allclose(o.float(), o_ref.float(), rtol=o_rtol,
                                 atol=tf_)
                  and torch.allclose(lse, lse_ref, rtol=tf_, atol=tf_),
                  f"flash_fwd != plain at {what}")
            check(torch.allclose(dk, dk_ref, rtol=tb, atol=tb)
                  and torch.allclose(dv, dv_ref, rtol=tb, atol=tb),
                  f"flash_bwd_dkv != plain at {what}")
            errs["fwd"][dt] = max(errs["fwd"][dt], float(
                (o.float() - o_ref.float()).abs().max()))
            errs["dkv"][dt] = max(errs["dkv"][dt],
                                  float((dk - dk_ref).abs().max()),
                                  float((dv - dv_ref).abs().max()))
            if name:
                stress[name] = {"o": float((o.float() - o_ref.float())
                                           .abs().max()),
                                "dk": float((dk - dk_ref).abs().max()),
                                "dv": float((dv - dv_ref).abs().max())}
            check(torch.allclose(dq, dq_ref, rtol=tb, atol=tb),
                  f"flash_bwd_dq != plain at {what}")
            errs["dq"][dt] = max(errs["dq"][dt],
                                 float((dq - dq_ref).abs().max()))
            if name:
                stress[name]["dq"] = float((dq - dq_ref).abs().max())
        dk2, dv2 = fk.flash_bwd_dkv(*args, **kw)
        check(torch.equal(dq, fk.flash_bwd_dq(*args, **kw))
              and torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash backward not bit-reproducible at {what}")
        tc1 = [f.launches_tc - n for f, n in zip(tc_fns, tc0)]
        check(tc1 == want_tc,
              f"tensor-core launches {tc1} (forward, dq, dk/dv) at {what}; "
              f"expected {want_tc}")
        del q, k, v, do, o, o_ref, dq, dk, dv, dq_ref, dk_ref, dv_ref
    return {"cases": len(cases), "max_abs_err": errs, "stress": stress}


FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


# the shard phase (phase 16): the sharded multi-macro engine, its
# partitions folded onto the one card
SHARD_DEVICES = (1, 2, 4, 8)
SHARD_LENET_POINTS = ((4, 2), (8, 4))
SHARD_PROJECTIONS = ((2048, 2048), (2048, 8192), (8192, 2048))
SHARD_PROJ_ROWS = (4, 128)
SHARD_PROJ_DEVICES = 4
SHARD_SERVE_DEVICES = 4
SHARD_SERVE_DEPTH = 4
SHARD_SERVE_GEN = 8
SHARD_INFLIGHT_DEVICES = 8
SHARD_TUNE_DEVICES = 4
SHARD_FLASH = (2, 16, 4096, 128)          # B, H (= kv heads), S, D
SHARD_FLASH_MESH = ((1, 4), ("data", "model"))
SHARD_CROSS_DEVICES = 2


CIMCHECK_FULL_POINT = (8, 4)
CIMCHECK_VERIFY_REPS = 2
CIMCHECK_MC_TRIALS = 4
CIMCHECK_DENSE = (4, 2048, 2048, 8, 4)     # rows, k, n, r_in, r_w


def cimcheck_phase(dev, tag, kern, kmod, tprog, trt) -> dict:
    """Static verification on the card (module docstring, phase 17)."""
    from repro_torch.analysis import __main__ as cli
    from repro_torch.analysis import sass
    from repro_torch.core import mapping, prng
    from repro_torch.core.cim_layers import CIMConfig, _engine_config
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels.prng.kernel import threefry_normal
    from repro_torch.models import cnn
    rec: dict = {}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)

    # (a) the CLI sweep, strict, then OLMo-1B's projections at full width
    t0 = time.perf_counter()
    rc = cli.main(["--strict", "--device", str(dev), "--json",
                   os.path.join(out_dir, "cimcheck_sweep.json")])
    sweep_s = time.perf_counter() - t0
    check(rc == 0, f"cimcheck sweep exited {rc}")
    t0 = time.perf_counter()
    rc = cli.main(["--strict", "--device", str(dev), "--arch", "olmo-1b",
                   "--r-in", str(CIMCHECK_FULL_POINT[0]),
                   "--r-w", str(CIMCHECK_FULL_POINT[1]), "--full-width",
                   "--no-extra", "--no-sass", "--json",
                   os.path.join(out_dir, "cimcheck_full_width.json")])
    full_s = time.perf_counter() - t0
    check(rc == 0, f"cimcheck at OLMo-1B's full width exited {rc}")
    rec["sweep_s"], rec["full_width_s"] = sweep_s, full_s
    print(f"cimcheck (a) {tag}: sweep of LeNet, OLMo-1B and phi3.5-moe "
          f"(smoke widths) over r_in x r_w, noisy, folded-sharded and ladder "
          f"points, SASS pass: strict exit 0 in {sweep_s:.1f} s; OLMo-1B's "
          f"projections at full width {CIMCHECK_FULL_POINT}: exit 0 in "
          f"{full_s:.1f} s", flush=True)

    # (b) the SASS pass over every built library
    t0 = time.perf_counter()
    res = sass.lint_built()
    sass_s = time.perf_counter() - t0
    per_lib: dict = {}
    for f in res.functions:
        lib = per_lib.setdefault(f.library, {"functions": 0, "sinks": 0,
                                             "ffma_on_slice": 0,
                                             "ffma_total": 0})
        lib["functions"] += 1
        lib["sinks"] += f.sinks
        lib["ffma_on_slice"] += f.ffma_on_slice
        lib["ffma_total"] += f.ffma_total
    rec["sass"] = {"seconds": sass_s, "libraries": per_lib,
                   "functions": [dataclasses.asdict(f)
                                 for f in res.functions],
                   "findings": [f.to_dict() for f in res.findings]}
    for lib, v in per_lib.items():
        print(f"cimcheck (b) {tag}: SASS {lib}: {v['functions']} functions, "
              f"{v['sinks']} floor sinks, {v['ffma_on_slice']} FFMA on "
              f"their slices ({v['ffma_total']} FFMA in all)", flush=True)
    for name in ("cim_mbiw", "cim_mbiw_tc", "cim_mbiw_splitk"):
        lib = per_lib.get(name, {})
        check(lib.get("sinks", 0) > 0,
              f"SASS pass found no floor in {name}")
        bad = [f.format() for f in res.findings if f.where.startswith(name)]
        check(not bad, f"SASS pass: FFMA on the ADC floor of {name}: {bad}")

    # (c) a seeded contractible epilogue must be reported
    t0 = time.perf_counter()
    seeded = sass.lint_path(sass.compile_source(sass.SEEDED_EPILOGUE,
                                                "cimcheck_seeded"))
    seeded_s = time.perf_counter() - t0
    st = seeded.totals()
    check(st["ffma_on_slice"] >= 1 and seeded.findings
          and {f.code for f in seeded.findings} == {"NB102"},
          f"the SASS pass missed the seeded FFMA epilogue: {st}")
    rec["seeded"] = {"seconds": seeded_s, **st,
                     "findings": [f.to_dict() for f in seeded.findings]}
    print(f"cimcheck (c) {tag}: seeded floorf(mid + gain*dp + beta) with "
          f"plain operators: {st['sinks']} floor sink(s), "
          f"{st['ffma_on_slice']} FFMA on the slice, reported as NB102 "
          f"(compile + pass {seeded_s:.1f} s)", flush=True)

    # (d) compile_program(verify=) against verify="off", fresh each call
    # (a bucket ladder no earlier compile used: a cache miss)
    cim = CIMConfig(r_in=4, r_w=2)
    l_specs, l_acts, l_pools = cnn.lenet_engine_specs(LENET_BATCH, cim=cim)
    r_in, r_w = CIMCHECK_FULL_POINT
    targets = [("lenet (4,2)", l_specs, _engine_config(cim), l_acts,
                l_pools)] + [
        (f"olmo-1b/{name}", [spec], trt.EngineConfig(), None, None)
        for name, spec in zip(("qkv", "o", "gate_up", "down"),
                              cli.llm_specs("olmo-1b", r_in, r_w,
                                            full_width=True))]
    fresh = [1 << 20]

    def compile_ms(specs, cfg, acts, pools, verify):
        fresh[0] += 1
        buckets = tprog.BatchBuckets(max_bucket=fresh[0])
        t = time.perf_counter()
        tprog.compile_program(specs, cfg, activations=acts, pools=pools,
                              buckets=buckets, device=dev, verify=verify)
        return 1e3 * (time.perf_counter() - t)
    marks = (dict(trt.CAPTURE_COUNT), tprog.bound_cache_stats(),
             kmod.launch_counts(), threefry_normal.launches)
    verify = {}
    for label, specs, cfg, acts, pools in targets:
        off = [compile_ms(specs, cfg, acts, pools, "off")
               for _ in range(CIMCHECK_VERIFY_REPS)]
        strict = [compile_ms(specs, cfg, acts, pools, "strict")
                  for _ in range(CIMCHECK_VERIFY_REPS)]
        verify[label] = {"off_ms": off, "strict_ms": strict,
                         "off_median_ms": statistics.median(off),
                         "strict_median_ms": statistics.median(strict)}
    check((dict(trt.CAPTURE_COUNT), tprog.bound_cache_stats(),
           kmod.launch_counts(), threefry_normal.launches) == marks,
          "verify=strict moved a capture, bind or launch counter")
    rec["verify"] = verify
    print(f"cimcheck (d) {tag}: compile_program ms, median of "
          f"{CIMCHECK_VERIFY_REPS} fresh compiles, verify off / strict: "
          + "; ".join(f"{k} {v['off_median_ms']:.1f} / "
                      f"{v['strict_median_ms']:.1f}"
                      for k, v in verify.items())
          + "; no capture, bind or launch counter moved", flush=True)

    # (e) the legacy entries, the slice's main path
    images = torch.from_numpy(make_dataset(n_train=1, n_test=LENET_BATCH,
                                           seed=5)[2][..., None])
    rows, k, n, dr_in, dr_w = CIMCHECK_DENSE
    xd = torch.randn((rows, k), generator=torch.Generator().manual_seed(6))
    cases = [("lenet", l_specs, l_acts, l_pools, images),
             ("olmo-1b/o", [mapping.LayerSpec(m=rows, k=k, n=n, r_in=dr_in,
                                              r_w=dr_w)], None, None, xd)]
    import warnings
    reset_counts(kern)
    threefry_normal.launches = 0
    forwards: dict = {}
    legacy = {}
    for label, specs, acts, pools, x in cases:
        for noisy in (False, True):
            cfg = trt.EngineConfig(noise=NoiseConfig(enabled=noisy))
            eng = trt.CIMInferenceEngine(specs, cfg, acts, pools,
                                         device=dev)
            check(eng.program.device.type == dev.type,
                  "legacy engine is not on the card")
            params = eng.init_params(prng.key(0))
            key = prng.key(1) if noisy else None
            t = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                y = eng(params, x, key)
                y_net = trt.run_network(eng.plan, params, x, key,
                                        device=dev)
            y_run = eng.program.run(params, x, key)
            y_ref = eng.reference(params, x, key)
            y_netref = trt.run_network_reference(eng.plan, params, x, key,
                                                 device=dev)
            n_fwd, n_ref = 3, 2
            check(torch.equal(y, y_net) and torch.equal(y, y_run)
                  and torch.equal(y, y_ref) and torch.equal(y, y_netref),
                  f"legacy {label} noisy={noisy}: the entries differ")
            check(bool(torch.isfinite(y).all()),
                  f"legacy {label} noisy={noisy}: non-finite outputs")
            entry = {"shape": list(y.shape)}
            if noisy:
                mc = eng.monte_carlo(params, x, prng.key(7),
                                     CIMCHECK_MC_TRIALS)
                runs = [eng.program.run(params, x, kk) for kk in
                        prng.split(prng.key(7), CIMCHECK_MC_TRIALS)]
                n_fwd += 2 * CIMCHECK_MC_TRIALS
                check(all(torch.equal(mc[i], r) for i, r in enumerate(runs)),
                      f"legacy {label}: monte_carlo != runs under the "
                      "split keys")
                check(not torch.equal(mc[0], mc[1]),
                      f"legacy {label}: two trials drew the same noise")
                entry["mc_trials"] = CIMCHECK_MC_TRIALS
            if dev.type == "cuda":
                torch.cuda.synchronize()
            entry["seconds"] = time.perf_counter() - t
            legacy[f"{label} noisy={noisy}"] = entry
            forwards[(label, noisy)] = (eng.plan, x.shape[0], n_fwd, n_ref)
    counts = kernel_counts(kern)
    draws = threefry_normal.launches
    want = [0, 0, 0]
    want_draws = 0
    for (label, noisy), (plan, batch, n_fwd, n_ref) in forwards.items():
        rc_ = kmod.route_counts(plan.tile_calls(batch))
        want[0] += n_fwd * sum(rc_.values())
        want[1] += n_fwd * rc_["tc"]
        want[2] += n_fwd * rc_["splitk"]
        # one draw a layer of every noisy forward, the references' too
        want_draws += (n_fwd + n_ref) * len(plan.layers) * noisy
    check(counts == tuple(want), f"legacy entries launched cim_mbiw "
          f"{counts} (all, tc, split-K), not {tuple(want)}")
    check(draws == want_draws, f"legacy entries launched threefry_normal "
          f"{draws} times, not one a layer a noisy forward ({want_draws})")
    cuda_core = counts[0] - counts[1] - counts[2]
    check(min(counts[1], counts[2], cuda_core) > 0 and draws > 0,
          f"legacy entries missed a route: {counts}, draws {draws}")
    rec["legacy"] = legacy
    rec["launches"] = {"cim_mbiw": counts[0], "cim_mbiw_tc": counts[1],
                       "cim_mbiw_splitk": counts[2],
                       "threefry_normal": draws}
    print(f"cimcheck (e) {tag}: run_network, CIMInferenceEngine call and "
          f"reference, run_network_reference == program.run on LeNet at "
          f"batch {LENET_BATCH} and OLMo-1B's o projection at {rows} rows, "
          f"clean and noisy; monte_carlo x{CIMCHECK_MC_TRIALS} == runs "
          f"under the split keys; launches cim_mbiw {counts[0]} (tensor "
          f"cores {counts[1]}, split-K {counts[2]}, CUDA cores "
          f"{cuda_core}), threefry_normal {draws}", flush=True)
    return rec


def shard_phase(dev, tag, kern, kmod, tprog, trt) -> dict:
    """The sharded multi-macro engine (module docstring, phase 16), every
    mesh folded onto `dev` (ShardingConfig(fold_onto=...)), the one card
    standing in for the bank of macros."""
    from repro_torch.core import cim_layers as tcl
    from repro_torch.core import mapping, prng
    from repro_torch.core.hw import DEFAULT_MACRO
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import cnn
    from repro_torch.models.sharding import use_mesh
    from repro_torch.tuner import search as tsearch
    fold = dev.type

    def sharding(d):
        return trt.ShardingConfig(devices=d, fold_onto=fold)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    rec: dict = {}
    reset_counts(kern)
    images = torch.from_numpy(make_dataset(n_train=1, n_test=LENET_BATCH,
                                           seed=0)[2][..., None])

    # -- LeNet at batch 256: D in SHARD_DEVICES x both kinds ------------------
    lenet = {}
    for r_in, r_w in SHARD_LENET_POINTS:
        cim = tcl.CIMConfig(r_in=r_in, r_w=r_w)
        specs, acts, pools = cnn.lenet_engine_specs(LENET_BATCH, cim=cim)
        cfg = tcl._engine_config(cim)
        ncfg = cfg.replace(noise=NoiseConfig())
        params = cnn.lenet_params_list(
            cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
        key = prng.key(1)
        base = tprog.compile_program(specs, cfg, activations=acts,
                                     pools=pools, device=dev).bind(params)
        want = base.serve(images)
        nwant = tprog.compile_program(specs, ncfg, activations=acts,
                                      pools=pools, device=dev).bind(
            params).serve(images, key)
        host = tprog.compile_program(specs, cfg, activations=acts,
                                     pools=pools, device="cpu").bind(params)
        check(torch.equal(want.cpu(), host.serve(images)),
              f"shard LeNet ({r_in},{r_w}): the unsharded card run != CPU")
        nhost = tprog.compile_program(specs, ncfg, activations=acts,
                                      pools=pools, device="cpu").bind(params)
        check(torch.equal(nwant.cpu(), nhost.serve(images, key)),
              f"shard LeNet ({r_in},{r_w}) noisy: card != CPU")
        rows = {}
        for d in SHARD_DEVICES:
            for kind in ("col", "rows"):
                sched = [(None, kind)] * len(specs)
                plan = trt.plan_network(specs, cfg.replace(
                    sharding=sharding(d)), acts, pools, schedule=sched)
                bound = tprog.program_for_plan(plan, device=dev).bind(
                    params)
                first = bound.serve(images)          # warm-up and capture
                before = kern.launches
                y = bound.serve(images)              # a replay
                sync()
                calls = kern.launches - before
                what = f"shard LeNet ({r_in},{r_w}) D={d} {kind}"
                check(calls == len(plan.tile_calls(LENET_BATCH)),
                      f"{what}: a replay launched {calls} cim_mbiw != the "
                      f"{len(plan.tile_calls(LENET_BATCH))} planned calls")
                check(torch.equal(first, want) and torch.equal(y, want)
                      and torch.equal(eager_forward(trt, bound, images),
                                      want)
                      and torch.equal(bound.reference(images), want),
                      f"{what}: replay / eager / reference != unsharded")
                nplan = trt.plan_network(specs, ncfg.replace(
                    sharding=sharding(d)), acts, pools, schedule=sched)
                nb = tprog.program_for_plan(nplan, device=dev).bind(params)
                check(torch.equal(nb.serve(images, key), nwant),
                      f"{what} noisy: != the unsharded noisy serve")
                if d == SHARD_DEVICES[-1]:
                    hplan = trt.plan_network(specs, cfg.replace(
                        sharding=trt.ShardingConfig(devices=d,
                                                    fold_onto="cpu")),
                        acts, pools, schedule=sched)
                    check(torch.equal(tprog.program_for_plan(
                        hplan, device="cpu").bind(params).serve(images)
                        .to(y.device), y), f"{what}: != the CPU run")
                lat = []
                for _ in range(7):
                    sync()
                    t0 = time.perf_counter()
                    bound.serve(images)
                    sync()
                    lat.append(1e3 * (time.perf_counter() - t0))
                row = {"host_ms": statistics.median(lat[2:]),
                       "launches_a_serve": calls,
                       "kinds": [lp.shard.kind for lp in plan.layers]}
                if dev.type == "cuda":
                    row["event_ms"] = cuda_ms(lambda: bound.serve(images), 5)
                    prof = device_profile(lambda: bound.serve(images), 3,
                                          cpu=False)
                    row["device_ms"] = (prof["device_us"] / 1e3
                                        if prof else None)
                rows[f"D{d} {kind}"] = row
                del bound, nb
        lat = []
        for _ in range(7):
            sync()
            t0 = time.perf_counter()
            base.serve(images)
            sync()
            lat.append(1e3 * (time.perf_counter() - t0))
        rows["unsharded"] = {"host_ms": statistics.median(lat[2:])}
        if dev.type == "cuda":
            rows["unsharded"]["event_ms"] = cuda_ms(
                lambda: base.serve(images), 5)
        lenet[f"{r_in}x{r_w}"] = rows
        txt = "; ".join(
            f"{k} host {v['host_ms']:.2f} ms" + (
                f", device {v['device_ms']:.3f} ms"
                if v.get("device_ms") is not None else
                ", device not measured" if "device_ms" in v else "")
            for k, v in rows.items())
        print(f"shard lenet {tag} ({r_in},{r_w}) batch {LENET_BATCH}: D "
              f"{SHARD_DEVICES} x kinds col/rows folded onto {fold}, clean "
              f"(graph replay and eager) and noisy (prng.key(1)) == the "
              f"unsharded program == the card reference == the CPU run, "
              f"bit for bit; launches = planned sharded calls; {txt}",
              flush=True)
    rec["lenet"] = lenet

    # -- engine-mode projections at OLMo-1B widths, D = 4 ---------------------
    proj = {}
    cimp = tcl.CIMConfig(mode="engine", r_in=8, r_w=4, max_gamma=2.0**16)
    gen = torch.Generator(device=dev).manual_seed(3)
    for k, n in SHARD_PROJECTIONS:
        p = tcl.init_cim_linear(gen, k, n, cfg=cimp)
        for rows_n in SHARD_PROJ_ROWS:
            x = torch.randn((rows_n, k), generator=gen, device=dev)
            want = tcl.cim_linear_apply(p, x, cimp)
            shd = cimp.replace(sharding=sharding(SHARD_PROJ_DEVICES))
            got = tcl.cim_linear_apply(p, x, shd)
            spec = mapping.LayerSpec(
                m=tprog.DEFAULT_BUCKETS.bucket_for(rows_n), k=k, n=n,
                r_in=8, r_w=4)
            auto = trt.plan_layer(spec, tcl._engine_config(shd)).shard.kind
            check(torch.equal(got, want), f"shard projection {k}->{n} rows "
                  f"{rows_n} D={SHARD_PROJ_DEVICES} ({auto}): != unsharded")
            other = "rows" if auto == "col" else "col"
            plan = trt.plan_network([spec], tcl._engine_config(shd), ["none"],
                                    schedule=[(None, other)])
            got2 = tprog.bound_for(tprog.program_for_plan(plan, device=dev),
                                   p).serve(x)
            check(torch.equal(got2, want), f"shard projection {k}->{n} rows "
                  f"{rows_n} D={SHARD_PROJ_DEVICES} ({other}): != unsharded")
            proj[f"{k}x{n} rows {rows_n}"] = [auto, other]
        del p
    rec["projections"] = proj
    print(f"shard projections {tag}: cim_linear_apply engine (8, 4) at "
          f"{', '.join(f'{k}->{n}' for k, n in SHARD_PROJECTIONS)}, rows "
          f"{SHARD_PROJ_ROWS}, D={SHARD_PROJ_DEVICES}, both kinds == "
          f"unsharded bit for bit", flush=True)

    # -- the LM serve launcher: OLMo-1B full width, depth cut ----------------
    args = serve.parser().parse_args(
        ["--arch", "olmo-1b", "--cim-mode", "engine", "--batch",
         str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT), "--gen-len",
         str(SHARD_SERVE_GEN), "--seed", "0", "--device", str(dev)])
    max_len = SERVE_PROMPT + SHARD_SERVE_GEN + 8
    runs = {}
    for label, sh in (("unsharded", None),
                      (f"D{SHARD_SERVE_DEVICES}",
                       sharding(SHARD_SERVE_DEVICES))):
        cfg, params, _ = serve.build(args, sh)
        check(cfg.cim.sharding == sh and cfg.dtype == "bfloat16"
              and (cfg.cim.r_in, cfg.cim.r_w) == (8, 4),
              f"shard serve config: {cfg.cim}")
        cfg = cfg.replace(n_layers=SHARD_SERVE_DEPTH)
        params = dict(params, layers=params["layers"][:SHARD_SERVE_DEPTH])
        prompt = serve.make_prompt(cfg.vocab_size, SERVE_BATCH,
                                   SERVE_PROMPT, 0, dev)
        t0 = time.perf_counter()
        out = serve.static_serve(cfg, params, prompt, SHARD_SERVE_GEN,
                                 max_len=max_len, keep_logits=True)
        out["wall_s"] = time.perf_counter() - t0
        growth = {k_: v for k_, v in out["growth"].items()}
        check(all(v == 0 for v in growth.values()),
              f"shard serve {label}: the decode loop grew {growth}")
        runs[label] = out
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    a, b = runs.values()
    check(torch.equal(a["tokens"], b["tokens"])
          and torch.equal(a["logits"][-1], b["logits"][-1]),
          "shard serve: sharded tokens or last logits != unsharded")
    rec["serve"] = {lbl: {"tokens": o["tokens"].tolist(),
                          "decode_host_ms_per_step":
                          1e3 * o["decode_s"] / max(o["steps"], 1),
                          "prefill_s": o["prefill_s"], "warm_s": o["warm_s"],
                          "wall_s": o["wall_s"]}
                    for lbl, o in runs.items()}
    print(f"shard serve {tag}: OLMo-1B full width, depth {SHARD_SERVE_DEPTH} "
          f"(cut from 16), bf16, engine (8, 4), batch {SERVE_BATCH}, prompt "
          f"{SERVE_PROMPT}, gen {SHARD_SERVE_GEN}, build(sharding="
          f"ShardingConfig(devices={SHARD_SERVE_DEVICES}, fold_onto="
          f"{fold!r})): tokens and last logits == unsharded; no plan, "
          f"capture or eager dispatch after warm-up; decode host ms a step "
          + ", ".join(f"{k_} {v['decode_host_ms_per_step']:.1f}"
                      for k_, v in rec["serve"].items()), flush=True)
    del runs, a, b

    # -- in flight over D = 8 -------------------------------------------------
    cfg, params, _ = serve.build(args, sharding(SHARD_INFLIGHT_DEVICES))
    icfg = cfg.replace(n_layers=SHARD_SERVE_DEPTH,
                       cim=cfg.cim.replace(isolate_rows=True))
    iparams = dict(params, layers=params["layers"][:SHARD_SERVE_DEPTH])
    del params
    reqs = serve.make_requests(icfg.vocab_size, SERVE_INFLIGHT_REQUESTS,
                               SERVE_PROMPT, SHARD_SERVE_GEN, 0)
    fused = serve.inflight_serve(icfg, iparams, reqs, SERVE_INFLIGHT_SLOTS,
                                 max_len=max_len, device=dev)
    check(all(v == 0 for v in fused["growth"].values()),
          f"shard inflight: the loop after warm-up grew {fused['growth']}")
    check(len(set(fused["slot"].values())) > 1,
          "shard inflight: no request ever shared a step")
    t0 = time.perf_counter()
    for r in reqs:
        solo = serve.inflight_serve(icfg, iparams, [dict(r, arrival=0)],
                                    SERVE_INFLIGHT_SLOTS, max_len=max_len,
                                    device=dev)
        check(solo["tokens"][r["uid"]] == fused["tokens"][r["uid"]]
              and len(solo["tokens"][r["uid"]]) == r["gen"],
              f"shard inflight: request {r['uid']} != its solo decode")
    rec["inflight"] = {
        "devices": SHARD_INFLIGHT_DEVICES, "requests": len(reqs),
        "decode_steps": fused["decode_steps"], "decode_s": fused["decode_s"],
        "solo_check_s": time.perf_counter() - t0,
        "streams": {str(u): t for u, t in fused["tokens"].items()}}
    print(f"shard inflight {tag}: {len(reqs)} requests at "
          f"{SERVE_INFLIGHT_SLOTS} slots over D={SHARD_INFLIGHT_DEVICES} "
          f"folded, depth {SHARD_SERVE_DEPTH}: fused == sequential for "
          f"every request, {fused['decode_steps']} fused steps in "
          f"{fused['decode_s']:.2f} s", flush=True)
    del iparams
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the tuner at D = 4 on LeNet -------------------------------------------
    cim = tcl.CIMConfig(r_in=4, r_w=2)
    specs, acts, pools = cnn.lenet_engine_specs(LENET_BATCH, cim=cim)
    cfg = tcl._engine_config(cim).replace(sharding=sharding(
        SHARD_TUNE_DEVICES))
    params = cnn.lenet_params_list(
        cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
    want = tprog.compile_program(specs, tcl._engine_config(cim),
                                 activations=acts, pools=pools,
                                 device=dev).bind(params).serve(images)
    n_cand = 0
    for i, spec in enumerate(specs):
        for c in tsearch.layer_candidates(spec, cfg, SHARD_TUNE_DEVICES):
            sched = [None] * len(specs)
            sched[i] = (c.blocks, c.shard_kind)
            prog = tprog.program_for_plan(trt.plan_network(
                specs, cfg, acts, pools, schedule=sched), device=dev)
            check(torch.equal(prog.run(params, images), want),
                  f"shard tuner: layer {i} candidate {c} != untuned")
            n_cand += 1
    plan, reps = tsearch.tune_network(specs, cfg, acts, pools,
                                      mode="analytic", cache_path="",
                                      device=dev)
    check(torch.equal(tprog.program_for_plan(plan, device=dev).bind(
        params).serve(images), want), "shard tuner: tuned plan != untuned")
    winners = []
    for spec, lp, rep in zip(specs, plan.layers, reps):
        c = rep["choice"]
        us = (1e6 * tsearch._measure_choice_s(spec, c, DEFAULT_MACRO, dev,
                                              SHARD_TUNE_DEVICES)
              if dev.type == "cuda" else None)
        winners.append({"tile": list(c.blocks), "kind": lp.shard.kind,
                        "predicted_s": rep["predicted_s"], "event_us": us})
    rec["tuner"] = {"devices": SHARD_TUNE_DEVICES, "candidates": n_cand,
                    "winners": winners}
    print(f"shard tuner {tag}: LeNet (4, 2) batch {LENET_BATCH} at "
          f"D={SHARD_TUNE_DEVICES} folded: {n_cand} (tile, kind) candidates "
          f"== untuned; analytic winners " + "; ".join(
              f"layer {i} {w['tile']} {w['kind']} "
              + (f"{w['event_us']:.1f} us a dispatch"
                 if w["event_us"] is not None else "not timed")
              for i, w in enumerate(winners)), flush=True)
    route_launches = kernel_counts(kern)

    # -- flash_attention_sharded: a folded (data 1, model 4) mesh -------------
    b, h, s, d = SHARD_FLASH
    mesh = make_mesh(*SHARD_FLASH_MESH, fold_onto=fold)
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    for kf in kerns:
        kf.launches = kf.launches_tc = 0
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    with use_mesh(mesh):
        out = fops.flash_attention_sharded(qg, kg, vg, True, 0)
    out.backward(do)
    sync()
    flash_launches = {kf.__name__: (kf.launches, kf.launches_tc)
                      for kf in kerns}
    pieces = fops.sharded_pieces(mesh, b, s)
    check(len(pieces) == 4 and all(
        n == (len(pieces), len(pieces) if dev.type == "cuda" else 0)
        for n in flash_launches.values()),
        f"shard flash: launches (all, tc) {flash_launches} != one a piece "
        f"on the tensor cores")
    o, lse = fops.sharded_forward(q, k, v, True, 0, pieces)
    dq, dk, dv = fops.sharded_backward(q, k, v, o, lse, do, True, 0, pieces)
    zero = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    o1, lse1 = fk.flash_fwd(qt, kt, vt, zero, causal=True)
    o1 = o1.transpose(1, 2)
    delta = torch.sum(do.float() * o1.float(), -1).transpose(1, 2) \
        .contiguous()
    args_b = (qt, kt, vt, dot, lse1, delta, zero)
    dq1 = fk.flash_bwd_dq(*args_b, causal=True)
    dk1, dv1 = fk.flash_bwd_dkv(*args_b, causal=True)
    err = {"o": float((o.float() - o1.float()).abs().max()),
           "lse": float((lse - lse1).abs().max()),
           "dq": float((dq - dq1).abs().max()),
           "dk": float((dk - dk1).abs().max()),
           "dv": float((dv - dv1).abs().max())}
    equal = {"o": torch.equal(o, o1), "lse": torch.equal(lse, lse1),
             "dq": torch.equal(dq, dq1), "dk": torch.equal(dk, dk1),
             "dv": torch.equal(dv, dv1)}
    check(torch.equal(out, o) and torch.equal(
        qg.grad, dq.transpose(1, 2).to(q.dtype)),
        "shard flash: autograd through the pieces != the pieces' kernels")
    check(torch.allclose(o.float(), o1.float(), rtol=2.0 ** -7, atol=2e-5)
          and torch.allclose(lse, lse1, rtol=2e-5, atol=2e-5),
          f"shard flash forward outside 2e-5 (o one bf16 ulp): {err}")
    for name, got, ref in (("dq", dq, dq1), ("dk", dk, dk1),
                           ("dv", dv, dv1)):
        check(torch.allclose(got, ref, rtol=5e-5, atol=5e-5),
              f"shard flash {name} outside 5e-5: {err}")
    times = {}
    if dev.type == "cuda":
        def sharded_step():
            fops.sharded_backward(q, k, v, o, lse, do, True, 0, pieces)
            fops.sharded_forward(q, k, v, True, 0, pieces)

        def plain_step():
            fk.flash_bwd_dq(*args_b, causal=True)
            fk.flash_bwd_dkv(*args_b, causal=True)
            fk.flash_fwd(qt, kt, vt, zero, causal=True)
        times = {"sharded_ms": cuda_ms(sharded_step, 5),
                 "unsharded_ms": cuda_ms(plain_step, 5)}
    rec["flash"] = {"shape": SHARD_FLASH, "mesh": SHARD_FLASH_MESH,
                    "max_abs_err": err, "bit_equal": equal,
                    "launches": flash_launches, **times}
    print(f"shard flash {tag}: flash_attention_sharded B {b} H {h} S {s} D "
          f"{d} causal bf16 over a folded (data 1, model 4) mesh, forward "
          f"and backward: launches (all, tc) {flash_launches}; against the "
          f"unsharded kernel calls max abs err {err}, bit-equal {equal}"
          + (f"; fwd+bwd {times['sharded_ms']:.3f} ms sharded, "
             f"{times['unsharded_ms']:.3f} ms unsharded" if times else ""),
          flush=True)

    # -- placement across cards ---------------------------------------------
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= SHARD_CROSS_DEVICES:
        spec = [mapping.LayerSpec(m=8, k=1300, n=300, r_in=4, r_w=2)]
        p1 = tprog.compile_program(spec, device=dev)
        params = p1.init_params(torch.Generator().manual_seed(4))
        xc = torch.randn((8, 1300), generator=torch.Generator().manual_seed(5))
        want = p1.bind(params).serve(xc)
        for kind in ("col", "rows"):
            plan = trt.plan_network(spec, trt.EngineConfig(
                sharding=trt.ShardingConfig(devices=SHARD_CROSS_DEVICES)),
                schedule=[(None, kind)])
            check(torch.equal(tprog.program_for_plan(plan, device=dev).bind(
                params).serve(xc), want), f"shard across cards {kind}: != "
                "unsharded")
        rec["across_cards"] = "run"
        print(f"shard across cards {tag}: D={SHARD_CROSS_DEVICES} on "
              f"{n_cards} cards, both kinds == unsharded", flush=True)
    else:
        rec["across_cards"] = (f"not run: {n_cards} card(s) visible, "
                               f"placement across cards needs "
                               f"{SHARD_CROSS_DEVICES}")
        print(f"shard across cards {tag}: not run - this machine shows "
              f"{n_cards} card(s) and placement across cards needs "
              f"{SHARD_CROSS_DEVICES}; not counted as a pass", flush=True)
    rec["launches"] = {
        "cim_mbiw": route_launches[0], "cim_mbiw_tc": route_launches[1],
        "cim_mbiw_splitk": route_launches[2],
        **{f"{name}_tc": n[1] for name, n in flash_launches.items()}}
    return rec


def train_steps(cfg, state, step_fn, batches, what) -> tuple:
    """make_train_step's step over `batches`, with the flash counts set to
    0 just before and read just after: (state, record of the host ms a
    step, each step's metrics, the flash launches, all and on the tensor
    cores, and the peak memory).  Checks a finite loss and a finite,
    nonzero gradient norm a step, and the flash launches: a forward an
    attention layer (two with checkpointing: the recompute; the hybrid
    family has one a block of 3, the ssm family none, the audio family
    one an encoder layer and two a decoder layer), a dq and a dk/dv,
    each on its tensor-core kernel at a D of its row of FLASH_TC_HEAD_DIMS
    unless a float32 QKV bias makes q, k and v float32 (as in JAX), else
    on the CUDA-core kernels."""
    from repro_torch.kernels.flash_attn import kernel as fk
    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    torch.cuda.reset_peak_memory_stats()
    for f in kerns:
        f.launches = f.launches_tc = 0
    step_ms, metrics = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        m = {k: float(v) for k, v in m.items()}     # waits for the card
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append(m)
    launches = [f.launches for f in kerns]
    launches_tc = [f.launches_tc for f in kerns]
    attn = {"hybrid": cfg.n_layers // 3, "ssm": 0,
            "audio": cfg.encoder_layers + 2 * cfg.n_layers}.get(
                cfg.family, cfg.n_layers)
    per_step = attn * len(batches)
    want = [(1 + int(cfg.remat)) * per_step, per_step, per_step]
    want_tc = [n if attn and not cfg.qkv_bias
               and cfg.resolved_head_dim in fk.FLASH_TC_HEAD_DIMS[name]
               else 0 for name, n in zip(FLASH_NAMES, want)]
    check(launches == want,
          f"{what}: flash launches {launches} over {len(batches)} steps != "
          f"{want} ({attn} attention layers: forward and recompute, dq, "
          f"dk/dv)")
    check(launches_tc == want_tc,
          f"{what}: tensor-core launches {launches_tc} != {want_tc}: a "
          f"bf16 step runs each kernel at a D of its row of "
          f"FLASH_TC_HEAD_DIMS on the tensor cores, any other on the "
          f"CUDA cores")
    check(all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
              and m["grad_norm"] > 0 for m in metrics),
          f"{what}: non-finite loss or grad norm: {metrics}")
    return state, {"step_ms": step_ms, "metrics": metrics,
                   "launches": dict(zip(FLASH_NAMES, launches)),
                   "launches_tc": dict(zip(FLASH_NAMES, launches_tc)),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def train_phase(dev, tag) -> dict:
    """The train path (module docstring, phase 7).  Returns its record,
    with the flash launch counts of the TRAIN_STEPS steps."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch import steps, train
    from repro_torch.optim import global_norm
    from repro_torch.optim.adamw import tree_leaves

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the fakequant products must be exact float32")
    check(SHAPES["train_4k"].seq_len == TRAIN_SEQ, "train_4k changed")
    # what earlier phases left on the card (the decode model stays for
    # the times phase), inside the peak below
    resident_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    cfg, state, step_fn, batch_fn = train.build(train.parser().parse_args([
        "--arch", "olmo-1b", "--steps", str(TRAIN_STEPS), "--seq-len",
        str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
        "--cim-mode", "fakequant", "--attn-impl", "pallas"]))
    init = [p.detach().clone() for p in tree_leaves(state["params"])]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(cfg.remat and cfg.dtype == "bfloat16" and cfg.n_layers == 16
          and cfg.d_model == 2048 and cfg.vocab_size == 50304
          and cfg.attn_impl == "pallas" and cfg.cim.mode == "fakequant"
          and (cfg.cim.r_in, cfg.cim.r_w, cfg.cim.r_out) == (8, 4, 8),
          f"launch/train.py built another config: {cfg}")
    check(state["params"]["embed"].is_cuda, "the params are not on the card")
    n_params = sum(p.numel() for p in init)
    batches = [batch_fn(i) for i in range(TRAIN_STEPS)]

    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    state, steps_rec = train_steps(cfg, state, step_fn, batches, "OLMo-1B")
    step_ms, metrics = steps_rec["step_ms"], steps_rec["metrics"]
    launches = list(steps_rec["launches"].values())
    launches_tc = list(steps_rec["launches_tc"].values())
    peak_gb = steps_rec["peak_gb"]

    # step 0's loss and gradient from the initial weights and first batch:
    # plain attention, flash attention, and flash attention with an
    # off-by-one causal mask (q_offset 1: each query also sees the next
    # token), the control that the limits must catch
    leaves = tree_leaves(state["params"])
    with torch.no_grad():
        for p, p0 in zip(leaves, init):
            p.copy_(p0)
    del init

    def loss_grads(c, key=None):
        loss, _ = steps.loss_fn(c, state["params"], batches[0], key)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [torch.zeros_like(p) if g is None
                                      else g for p, g in zip(leaves, grads)]

    before = list(f.launches for f in kerns)
    p_loss, p_grads = loss_grads(cfg.replace(attn_impl="jnp"))
    check([f.launches for f in kerns] == before,
          "the plain-attention step launched a flash kernel")
    p_norm = float(global_norm(p_grads))

    def against_plain(c):
        loss, grads = loss_grads(c)
        gnorm = float(global_norm(grads))
        return {"loss": loss, "grad_norm": gnorm, "rel": {
            "loss": abs(loss - p_loss) / abs(p_loss),
            "grad_norm": abs(gnorm - p_norm) / p_norm,
            "grad": float(global_norm(a - b for a, b in zip(grads, p_grads)))
            / p_norm}}
    vs = {"flash": against_plain(cfg)}
    off_by_one = torch.ones((1, 1), dtype=torch.int32, device=dev)
    flash_attention = fops.flash_attention
    fops.flash_attention = lambda q, k, v, causal=True, window=0: \
        flash_attention(q, k, v, causal, window, q_offset=off_by_one)
    try:
        vs["control"] = against_plain(cfg)
    finally:
        fops.flash_attention = flash_attention
    del p_grads
    pm = {"loss": p_loss, "grad_norm": p_norm}
    print(f"train {tag}: step 0 against plain attention (loss "
          f"{p_loss:.6f}, grad norm {p_norm:.5f}), relative loss / grad "
          f"norm / gradient: " + "; ".join(
              f"{k} " + " / ".join(f"{v['rel'][m]:.3g}" for m in
                                   TRAIN_JNP_RTOL) for k, v in vs.items())
          + f"; limits {TRAIN_JNP_RTOL}", flush=True)
    check(all(vs["flash"]["rel"][m] <= lim
              for m, lim in TRAIN_JNP_RTOL.items()),
          f"flash vs plain attention outside {TRAIN_JNP_RTOL}: {vs}")
    check(any(vs["control"]["rel"][m] > lim
              for m, lim in TRAIN_JNP_RTOL.items()),
          f"an off-by-one causal mask passes {TRAIN_JNP_RTOL}: {vs}")
    noisy = noisy_train_step(cfg, state, batches, loss_grads, vs, step_ms,
                             tag)

    # one more flash step under the profiler (device only)
    prof = device_profile(lambda: step_fn(state, batches[0])[1]["loss"]
                          .item(), 1, cpu=False,
                          groups=("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv", "gemm", "elementwise"))
    torch.cuda.synchronize()
    med = statistics.median(step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flash_us = sum(prof.get(f"{g}_us", 0.0) for g in
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    rec = {"n_params": n_params, "init_s": init_s, "step_ms": step_ms,
           "median_step_ms": med, "tokens_per_s": tokens / (med / 1e3),
           "peak_memory_gb": peak_gb, "resident_before_gb": resident_gb,
           "metrics": metrics,
           "plain_attention_step0": pm, "vs_plain_step0": vs,
           "vs_plain_limits": TRAIN_JNP_RTOL,
           "launches": steps_rec["launches"],
           "launches_tc": steps_rec["launches_tc"],
           "profile": prof, "noisy": noisy,
           "flash_share": flash_us / prof["device_us"] if prof else None}
    busy = (f"profiled step: device {prof['device_us'] / 1e3:.1f} ms, "
            f"flash {flash_us / 1e3:.1f} ms "
            f"({100 * rec['flash_share']:.1f}%), busy "
            f"{100 * prof['device_busy']:.1f}%" if prof
            else "device time not measured (profiler saw none)")
    print(f"train {tag}: OLMo-1B {n_params / 1e9:.3f} B params, fakequant "
          f"(8,4,8), flash attention, seq {TRAIN_SEQ} x batch "
          f"{TRAIN_BATCH}, {TRAIN_STEPS} AdamW steps: losses "
          + ", ".join(f"{m['loss']:.4f}" for m in metrics)
          + ", grad norms " + ", ".join(f"{m['grad_norm']:.3f}"
                                         for m in metrics)
          + f"; flash launches {launches} (16+16 fwd, 16 dq, 16 dk/dv a "
          f"step; on the tensor cores {launches_tc}); median step "
          f"{med:.1f} ms, "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak memory {peak_gb:.1f} "
          f"GB ({resident_gb:.1f} GB of it resident before the phase), "
          f"build {init_s:.1f} s; {busy}", flush=True)
    del state
    return rec


def noisy_train_step(cfg, state, batches, loss_grads, vs, step_ms,
                     tag) -> dict:
    """The noisy train step (module docstring, phase 7): the train phase's
    weights (at their initial values) and first batch under
    CIMConfig(noise=NoiseConfig()) and the launcher's step-0 key.  Loss
    and gradient twice, bit-equal; the draw kernel launched once per row
    tile of every projection and once for its SA residues, forward and
    recompute; then one timed noisy step of make_train_step.  Leaves the
    weights one noisy step on."""
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.core.noise_model import NoiseConfig
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.launch import steps, train
    from repro_torch.optim import AdamWConfig
    draw = pk.threefry_normal
    ncfg = cfg.replace(cim=cfg.cim.replace(noise=NoiseConfig()))
    nargs = train.parser().parse_args(["--arch", "olmo-1b", "--cim-noise"])
    key = train.step_key(nargs, 0)
    n_rows = CIMConfig().macro.n_rows

    def row_tiles(k):
        return -(-k // n_rows)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    # a draw per row tile of each of the 7 projections, one per
    # projection for its residues
    per_layer = (3 * row_tiles(d) + row_tiles(cfg.n_heads * hd)
                 + 2 * row_tiles(d) + row_tiles(cfg.d_ff)) + 7
    # forward, and the recompute of a checkpointed layer
    want = (1 + int(cfg.remat)) * cfg.n_layers * per_layer
    draw.launches = 0
    loss1, g1 = loss_grads(ncfg, key)
    launches = draw.launches
    loss2, g2 = loss_grads(ncfg, key)
    check(launches == want,
          f"noisy step: {launches} draws != projections x (row tiles + 1) "
          f"x 2 ({want})")
    check(np.isfinite(loss1) and loss1 == loss2
          and all(torch.equal(a, b) for a, b in zip(g1, g2)),
          "noisy step did not repeat bit for bit")
    check(loss1 != vs["flash"]["loss"],
          "the noisy loss equals the clean step 0's")
    del g1, g2
    nstep = steps.make_train_step(ncfg, AdamWConfig(lr=TRAIN_LR),
                                  total_steps=TRAIN_STEPS,
                                  warmup=min(20, TRAIN_STEPS // 10 + 1))
    draw.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = nstep(state, batches[0], key)
    loss_step = float(m["loss"])
    torch.cuda.synchronize()
    noisy_ms = 1e3 * (time.perf_counter() - t0)
    check(draw.launches == want, "the timed noisy step's draws")
    rec = {"loss": loss1, "clean_loss": vs["flash"]["loss"],
           "launches": launches + draw.launches, "per_step": want,
           "step_ms": noisy_ms, "clean_median_step_ms":
           statistics.median(step_ms), "step_loss": loss_step}
    print(f"noise train {tag}: OLMo-1B step 0 under NoiseConfig() and "
          f"step_key(0): loss {loss1:.6f} (clean {vs['flash']['loss']:.6f}), "
          f"loss and gradient bit-equal on a second run; threefry_normal "
          f"{want} launches a step ({cfg.n_layers} layers x {per_layer} "
          f"(projection row tiles + one residue draw a projection) x "
          f"{1 + int(cfg.remat)}, with the recompute); host "
          f"{noisy_ms:.1f} ms a noisy step "
          f"against {rec['clean_median_step_ms']:.1f} ms clean", flush=True)
    return rec


FT_DEPTH = 2                      # of 16: the float32 state (params, m, v,
                                  # err) is 16 B a parameter, 3.8 GB here
FT_STEPS = 6
FT_EVERY = 2
FT_FAULTS = {3: 1, 5: 1}          # a fault before steps 3 and 5
FT_KEEP = 2
FT_MESH_D = 4                     # the elastic restore's D, on "data"


def ft_args(ckpt_dir=None):
    """launch/train.py's arguments of the ft_train phase: OLMo-1B,
    fakequant, flash, compressed gradients; with a directory, the
    fault-tolerant driver's."""
    from repro_torch.launch import train
    argv = ["--arch", "olmo-1b", "--steps", str(FT_STEPS), "--seq-len",
            str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--lr",
            str(TRAIN_LR), "--cim-mode", "fakequant", "--attn-impl",
            "pallas", "--compress-grads"]
    if ckpt_dir is not None:
        argv += ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(FT_EVERY)]
    return train.parser().parse_args(argv)


def _state_diff(a, b) -> list:
    """Names of the train-state leaves (params, m, v, err, opt/step) that
    are not bit-equal."""
    from repro_torch.checkpoint.ckpt import _flatten_with_paths
    fa, fb = _flatten_with_paths(a), _flatten_with_paths(b)
    if [n for n, _ in fa] != [n for n, _ in fb]:
        return ["<the trees differ>"]
    return [n for (n, x), (_, y) in zip(fa, fb)
            if x.dtype != y.dtype or not torch.equal(x.detach(),
                                                     y.detach())]


def ft_train_phase(dev, tag) -> dict:
    """The training infrastructure (module docstring, phase 18): an
    uninterrupted run, the fault-tolerant driver's run of the same steps
    with two injected faults, an elastic restore onto a folded mesh, and
    compression on the card against the CPU."""
    import shutil
    import tempfile
    from repro_torch import convert
    from repro_torch.checkpoint import ckpt
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.launch import specs, train
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim import compression as gc
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime import elastic
    from repro_torch.runtime import fault_tolerance as ft

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    free_gb = shutil.disk_usage(out_dir).free / 1e9
    # two kept checkpoints and one being written, 16 B a parameter each
    need_gb = 3 * 16 * 237e6 / 1e9
    check(free_gb > need_gb, f"ft_train: {free_gb:.1f} GB free beside "
          f"chiprun_out/, {need_gb:.1f} GB needed")
    tmp = tempfile.TemporaryDirectory(dir=out_dir)
    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    try:
        # -- 1. the uninterrupted run, step 1's gradients kept ----------------
        cfg, state, step_fn, batch_fn = train.build(ft_args(),
                                                    n_layers=FT_DEPTH)
        check(cfg.n_layers == FT_DEPTH and cfg.d_model == 2048
              and cfg.n_heads == 16 and cfg.d_ff == 8192
              and cfg.vocab_size == 50304 and cfg.attn_impl == "pallas"
              and cfg.cim.mode == "fakequant"
              and (cfg.cim.r_in, cfg.cim.r_w, cfg.cim.r_out) == (8, 4, 8),
              f"ft_train: launch/train.py built another config: {cfg}")
        check("err" in state and state["params"]["embed"].is_cuda,
              "ft_train: no error buffer, or the state is not on the card")
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        batches = [batch_fn(s) for s in range(FT_STEPS + 1)]
        kept = {}
        compressed_grads = gc.compressed_grads

        def keep_step1(grads, err):
            kept.setdefault("calls", []).append(len(grads))
            if len(kept["calls"]) == 2:       # step 1: a live error buffer
                kept["grads"], kept["err"] = list(grads), list(err)
            return compressed_grads(grads, err)
        gc.compressed_grads = keep_step1
        try:
            clean, rec1 = train_steps(cfg, state, step_fn,
                                      batches[:FT_STEPS], "ft_train clean")
        finally:
            gc.compressed_grads = compressed_grads
        del state
        losses = [m["loss"] for m in rec1["metrics"]]

        # -- 2. compression on the card == on the CPU ------------------------
        t0 = time.perf_counter()
        zeros = torch.zeros((4096, 2048), device=dev)
        pairs = list(zip(kept.pop("grads"), kept.pop("err")))
        pairs.append((zeros, zeros))
        bad = []
        for i, (g, e) in enumerate(pairs):
            card = gc.compress_leaf(g, e)
            host = gc.compress_leaf(g.cpu(), e.cpu())
            if not all(a.dtype == b.dtype and torch.equal(a.cpu(), b)
                       for a, b in zip(card, host)):
                bad.append(i)
        check(kept["calls"] == [len(pairs) - 1] * FT_STEPS
              and any(bool(e.any()) for e in tree_leaves(clean["err"])),
              f"ft_train: compressed_grads calls {kept['calls']}, or the "
              f"error buffer stayed zero")
        check(not bad, f"ft_train: compress_leaf on the card != the CPU at "
              f"leaves {bad[:8]} of {len(pairs)}")
        compress_s = time.perf_counter() - t0
        n_compared = sum(g.numel() for g, _ in pairs)
        del pairs, zeros

        # -- 3. the driver's run with two faults -----------------------------
        args = ft_args(tmp.name)
        _, state, step_fn2, batch_fn2 = train.build(args, n_layers=FT_DEPTH)
        driver, run = train.make_driver(
            args, state, step_fn2, batch_fn2,
            ft.make_fault_injector(FT_FAULTS), keep=FT_KEEP)
        copies, saves, writes, loads = [], [], [], []
        save, restore = driver.manager.save, driver.restore_or_init
        to_host = driver.to_host
        write = ckpt.save_checkpoint

        def timed_to_host(st):
            # the first is the driver's snapshot of the initial state
            t = time.perf_counter()
            host = to_host(st)
            copies.append(time.perf_counter() - t)
            return host

        def timed_save(step, tree, extra=None):
            # blocks on the previous write, then starts the writer
            t = time.perf_counter()
            save(step, tree, extra)
            saves.append({"step": step, "to_host_s": copies[-1],
                          "save_call_s": time.perf_counter() - t})

        def timed_write(*a, **k):
            t = time.perf_counter()
            out = write(*a, **k)
            writes.append(time.perf_counter() - t)
            return out

        def timed_restore(init):
            t = time.perf_counter()
            out = restore(init)
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t)
            return out
        driver.to_host, driver.manager.save = timed_to_host, timed_save
        driver.restore_or_init = timed_restore
        ckpt.save_checkpoint = timed_write
        for f in kerns:
            f.launches = f.launches_tc = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            final, hist = run()
        finally:
            ckpt.save_checkpoint = write
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        drv_launches = [f.launches for f in kerns]
        drv_tc = [f.launches_tc for f in kerns]
        del state
        ran = [h.step for h in hist]
        check(driver.restarts == 2 and ran == [0, 1, 2, 2, 3, 4, 4, 5],
              f"ft_train: restarts {driver.restarts}, steps run {ran}")
        check([h.loss for h in hist] == [losses[s] for s in ran],
              f"ft_train: the driver's losses {[h.loss for h in hist]} != "
              f"the uninterrupted run's {losses} at steps {ran}")
        diff = _state_diff(final, clean)
        check(not diff, f"ft_train: after 2 restarts the state differs "
              f"from the uninterrupted run's at {len(diff)} leaves: "
              f"{diff[:8]}")
        attn = cfg.n_layers * len(hist)
        want = [(1 + int(cfg.remat)) * attn, attn, attn]
        check(drv_launches == want and drv_tc == want,
              f"ft_train: the driver's flash launches {drv_launches} (on "
              f"the tensor cores {drv_tc}) != {want}")
        step_dir = os.path.join(tmp.name, f"step_{FT_STEPS:08d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        kept_dirs = sorted(os.listdir(tmp.name))
        check(kept_dirs == [f"step_{s:08d}" for s in
                            (FT_STEPS - FT_EVERY, FT_STEPS)],
              f"ft_train: the directory keeps {kept_dirs}")

        # -- 4. elastic restore onto a folded mesh of D 4 --------------------
        logical = convert.train_state_to_numpy(final)
        del final
        t0 = time.perf_counter()
        host, manifest = ckpt.load_checkpoint(tmp.name, logical)
        load_s = time.perf_counter() - t0
        check(int(manifest["step"]) == FT_STEPS and all(
            a.tobytes() == b.tobytes() for a, b in
            zip(tree_leaves(host), tree_leaves(logical))),
              "ft_train: the newest checkpoint is not the final state")
        del logical
        mesh = elastic.make_mesh(*elastic.choose_mesh_shape(FT_MESH_D, tp=1),
                                 fold_onto=dev)
        pspec = specs.tree_shardings(specs.param_specs(host["params"], mesh),
                                     mesh)
        placements = {"params": pspec, "err": pspec,
                      "opt": {"m": pspec, "v": pspec,
                              "step": elastic.replicated(mesh)}}
        t0 = time.perf_counter()
        sharded = convert.train_state_from_numpy(
            elastic.reshard_tree(host, placements), dev)
        torch.cuda.synchronize()
        reshard_s = time.perf_counter() - t0
        del host
        with use_mesh(mesh):
            sharded, ms = step_fn2(sharded, batches[FT_STEPS])
        clean, mu = step_fn(clean, batches[FT_STEPS])
        diff = _state_diff(sharded, clean)
        check(float(ms["loss"]) == float(mu["loss"]) and not diff,
              f"ft_train: the step after the restore onto {mesh.shape} "
              f"{mesh.axis_names} differs from the unsharded one (loss "
              f"{float(ms['loss'])} / {float(mu['loss'])}, leaves "
              f"{diff[:8]})")
        del sharded, clean
    finally:
        tmp.cleanup()
        torch.cuda.empty_cache()

    med = statistics.median(rec1["step_ms"])
    rec = {"depth": FT_DEPTH, "n_params": n_params, "steps": FT_STEPS,
           "losses": losses, "step_ms": rec1["step_ms"],
           "median_step_ms": med, "peak_memory_gb": rec1["peak_gb"],
           "launches": rec1["launches"], "launches_tc": rec1["launches_tc"],
           "driver": {"steps_run": ran, "restarts": driver.restarts,
                      "run_s": run_s, "launches": drv_launches,
                      "launches_tc": drv_tc, "saves": saves,
                      "writes_s": writes, "restores_s": loads},
           "checkpoint_bytes": ckpt_bytes, "free_disk_gb_before": free_gb,
           "elastic": {"mesh": [list(mesh.shape), list(mesh.axis_names)],
                       "load_s": load_s, "reshard_s": reshard_s},
           "snapshot_s": copies[0],
           "compress_check": {"elements": n_compared, "seconds": compress_s}}
    block = [s["to_host_s"] + s["save_call_s"] for s in saves]
    print(f"ft_train {tag}: OLMo-1B at full width, depth {FT_DEPTH} of 16 "
          f"({n_params / 1e6:.1f} M params), fakequant (8,4,8), flash, "
          f"--compress-grads, seq {TRAIN_SEQ} x batch {TRAIN_BATCH}; "
          f"{FT_STEPS} uninterrupted steps: median {med:.1f} ms a step, "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; flash launches {list(rec1['launches'].values())} (tensor "
          f"cores {list(rec1['launches_tc'].values())})", flush=True)
    print(f"ft_train {tag}: driver --ckpt-every {FT_EVERY}, keep "
          f"{FT_KEEP}, faults before steps {sorted(FT_FAULTS)}: restarts "
          f"{driver.restarts}, steps run {ran}, final state (params, m, v, "
          f"err, opt/step) and re-run losses bit-equal to the "
          f"uninterrupted run; {run_s:.1f} s; flash launches "
          f"{drv_launches} all on the tensor cores", flush=True)
    print(f"ft_train {tag}: checkpoint {ckpt_bytes} bytes "
          f"({ckpt_bytes / 1e9:.3f} GB) a save; the loop blocks "
          + ", ".join(f"{b:.3f}" for b in block)
          + " s a save (device-to-host " + ", ".join(
              f"{s['to_host_s']:.3f}" for s in saves)
          + "), the writer takes " + ", ".join(f"{w:.3f}" for w in writes)
          + " s; restores " + ", ".join(f"{x:.3f}" for x in loads)
          + f" s; the initial snapshot {copies[0]:.3f} s; the newest "
          f"loaded in {load_s:.3f} s and resharded onto "
          f"{mesh.shape} {mesh.axis_names} (folded) in {reshard_s:.3f} s, "
          f"its step bit-equal to the unsharded one; compress_leaf card == "
          f"CPU on {n_compared} gradient elements and a zero leaf "
          f"({compress_s:.1f} s); free disk before {free_gb:.1f} GB; "
          f"{card_line()}", flush=True)
    return rec


# phase 19: the dry run of every (arch x shape) cell on the meta device
DRYRUN_OUT = os.path.join(ROOT, "chiprun_out", "dryrun_torch")
DRYRUN_CELLS = 40                 # ten archs x four shapes
DRYRUN_WAIT_S = 300                # the whole sweep, all archs at once
# the one cell run for real: OLMo-1B's prefill_32k cut from batch 32 x
# 32768 positions to 2 x 4096 (the plain attention's float32 scores of
# 32 x 16 heads x 32768^2 would not fit a card), the flash kernels
DRYRUN_REAL = ("olmo-1b", "prefill_32k", 2, 4096)


def dryrun_sweep() -> tuple:
    """`python -m repro_torch.launch.dryrun --arch A --mesh card` (bypass)
    for every arch, one process an arch, all started together on the
    host's cores and waited for here, while nothing runs on the card (so
    no host time of another phase is taken beside it); each touches no
    card (CUDA_VISIBLE_DEVICES empty) and writes its cells' JSON records
    to DRYRUN_OUT.  Every process is stopped before this returns.
    Returns (the processes' exit codes, the sweep's wall seconds)."""
    import shutil
    from repro_torch.configs import ARCH_IDS
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    os.makedirs(DRYRUN_OUT, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = []
    try:
        for arch in ARCH_IDS:
            log = open(os.path.join(DRYRUN_OUT, f"sweep_{arch}.log"), "w")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--mesh", "card", "--out", DRYRUN_OUT], env=env,
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            log.close()
        deadline = time.perf_counter() + DRYRUN_WAIT_S
        rcs = [p.wait(timeout=max(1.0, deadline - time.perf_counter()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs, time.perf_counter() - t0


def dryrun_phase(dev, tag) -> dict:
    """The dry run (module docstring, phase 19): the card sweep
    (`dryrun_sweep`) and its records (every cell ok or skipped, status,
    flops and fits_card a cell), then DRYRUN_REAL walked on meta and run
    on the card: the analysed
    argument_size_in_bytes == the summed nbytes of the params and inputs
    built there, exactly; the flash launches == the kernel ops the walk
    recorded; analysed arguments + temp beside the measured peak, and
    flops over the measured step time."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.launch import dryrun, trace_analysis
    t_phase = time.perf_counter()
    rcs, sweep_s = dryrun_sweep()
    check(all(rc == 0 for rc in rcs),
          f"dryrun sweep exit codes {rcs} (see {DRYRUN_OUT}/sweep_*.log)")
    cells = []
    for name in sorted(os.listdir(DRYRUN_OUT)):
        if name.endswith(".json"):
            with open(os.path.join(DRYRUN_OUT, name)) as f:
                cells.append(json.load(f))
    check(len(cells) == DRYRUN_CELLS
          and all(c["status"] in ("ok", "skipped") for c in cells)
          and all(c.get("off_meta", 0) == 0 for c in cells),
          "dryrun sweep: " + str([(c["arch"], c["shape"], c["status"],
                                   c.get("error")) for c in cells
                                  if c["status"] not in ("ok", "skipped")]))
    by_arch: dict = {}
    for c in cells:
        by_arch.setdefault(c["arch"], []).append(c)
    for arch, cs in by_arch.items():
        print(f"dryrun {arch} (card, bypass, meta): " + "; ".join(
            f"{c['shape']} {c['status']}" + (
                f" flops {c['flops']:.3e} fits_card {c['fits_card']}"
                if c["status"] == "ok" else "") for c in cs), flush=True)
    walk_s = sum(c.get("walk_s", 0.0) for c in cells)

    # the one cell run for real
    arch, shape_name, b, s_len = DRYRUN_REAL
    cfg = dryrun.cell_config(arch, attn_impl="pallas")
    shape = dataclasses.replace(SHAPES[shape_name], global_batch=b,
                                seq_len=s_len)
    walk = dryrun.analyze_cell(cfg, shape)
    base = torch.cuda.memory_allocated(dev)
    fn, args = dryrun.build_cell(cfg, shape, dev)
    held = trace_analysis.tree_tensors(args)
    on_card = sum(t.numel() * t.element_size() for t in held)
    arg_b = walk["memory"]["argument_size_in_bytes"]
    check(all(t.device.type == "cuda" for t in held) and on_card == arg_b,
          f"dryrun {arch}: analysed arguments {arg_b} B != {on_card} B of "
          f"state and inputs on the card")
    fn()                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fk.flash_fwd.launches = fk.flash_fwd.launches_tc = 0
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) - base
    calls = walk["kernels"].get("flash_fwd", {}).get("calls", 0)
    check(fk.flash_fwd.launches == fk.flash_fwd.launches_tc == 3 * calls
          == 3 * cfg.n_layers,
          f"dryrun {arch}: {fk.flash_fwd.launches} flash launches "
          f"(tensor cores {fk.flash_fwd.launches_tc}) for 3 steps of the "
          f"walk's {calls}")
    check(tuple(out.shape) == (b, cfg.vocab_size)
          and bool(torch.isfinite(out.float()).all()),
          f"dryrun {arch}: the step's logits are not finite")
    step_s = statistics.median(times)
    temp_b = walk["memory"]["temp_size_in_bytes"]
    rec = {"sweep": {f"{c['arch']}/{c['shape']}": {
               k: c.get(k) for k in ("status", "flops", "fits_card",
                                     "memory", "walk_s", "reason")}
               for c in cells},
           "sweep_walk_s": walk_s, "sweep_s": sweep_s,
           "real": {"arch": arch, "shape": shape_name,
                    "cut": {"global_batch": [32, b], "seq_len": [32768,
                                                                 s_len]},
                    "attn_impl": "pallas",
                    "argument_bytes": arg_b, "temp_bytes": temp_b,
                    "measured_peak_bytes": peak, "flops": walk["flops"],
                    "step_ms": [1e3 * t for t in times],
                    "tflops": walk["flops"] / step_s / 1e12,
                    "flash_calls": calls},
           "launches_tc": {"flash_fwd": fk.flash_fwd.launches_tc}}
    print(f"dryrun real {tag}: {arch} {shape_name} cut to batch {b} of 32 "
          f"x {s_len} of 32768 positions, bypass, flash: analysed "
          f"arguments {arg_b} B == the card's state and inputs {on_card} "
          f"B; analysed arguments + temp {(arg_b + temp_b) / 1e9:.3f} GB, "
          f"measured peak {peak / 1e9:.3f} GB "
          f"(torch.cuda.max_memory_allocated over the phase's base); "
          f"{walk['flops']:.4e} flops in {1e3 * step_s:.2f} ms = "
          f"{rec['real']['tflops']:.1f} TFLOP/s; flash launches "
          f"{calls} a step == the walk's kernel ops; the sweep's "
          f"{len(cells)} cells "
          f"walked in {walk_s:.1f} s of host time, {sweep_s:.1f} s wall "
          f"over {len(rcs)} processes with the card idle", flush=True)
    del fn, args, held, out
    _free(dev)
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


# phase 20: the examples on the card
EXAMPLE_FT = ["--steps", "150", "--d-model", "256", "--layers", "4",
              "--seq-len", "128", "--batch", "8"]
EXAMPLE_SERVE = ("granite-8b", 4, 16)      # arch, batch, gen (smoke widths)


def example_module(name):
    """examples/<name>.py loaded as a module (its main not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev, tag, kern) -> dict:
    """The five examples/torch_*.py on the card (module docstring, phase
    20), each held to its own outcome, with the kernel counts set to 0
    before and read after."""
    import shutil
    import tempfile
    from repro_torch.core import prng
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.models import transformer as tf
    t_phase = time.perf_counter()
    reset_counts(kern)
    pk.threefry_normal.launches = 0
    secs, rec = {}, {}
    print(f"examples {tag}: the lines of examples/torch_*.py follow, their "
          f"rates and seconds taken on this card", flush=True)

    t0 = time.perf_counter()
    qs = example_module("torch_quickstart").main(["--device", dev.type])
    check(qs["rel_abn"] < qs["rel_unity"],
          f"quickstart: ABN error {qs['rel_abn']:.4f} not below unity "
          f"gain's {qs['rel_unity']:.4f}")
    check(all(r["exact"] for r in qs["engine"].values())
          and qs["lenet_exact"],
          "quickstart: the engine != its reference on the card")
    rec["quickstart"] = {k: v for k, v in qs.items() if k != "engine"}
    secs["quickstart"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sv = example_module("torch_serve_llm_cim")
    arch, batch, gen = EXAMPLE_SERVE
    base = sv.get_smoke_config(arch).replace(dtype="float32")
    key = prng.key(0, dev)
    params = tf.init_params(base, key)
    prompt = prng.randint(key, (batch, 16), 0, base.vocab_size).long()
    out = sv.serve_modes(base, params, prompt, gen)
    check(torch.equal(out["engine"][0], out["fakequant"][0]),
          "serve example: engine tokens != fakequant tokens (float32)")
    rec["serve"] = {m: {"tokens": g[0].tolist(), "s": dt}
                    for m, (g, dt) in out.items()}
    secs["serve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ns = example_module("torch_noise_sweep").main(["--device", dev.type])
    clean = ns["rows"][0]
    check(clean["scale"] == 0.0 and clean["acc_mean"] > 0.1,
          f"noise sweep: clean accuracy {clean['acc_mean']:.3f} not above "
          f"chance (0.1)")
    rec["noise_sweep"] = ns
    secs["noise_sweep"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ln = example_module("torch_train_lenet_cim").main(
        ["--epochs", "1", "--device", dev.type])
    losses = ln["losses"]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"LeNet example: the loss did not fall ({losses[0]:.3f} -> "
          f"{losses[-1]:.3f})")
    rec["lenet"] = ln
    secs["lenet"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ftm = example_module("torch_fault_tolerant_pretrain")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "chiprun_out"))
    try:
        got = ftm.main(EXAMPLE_FT + ["--device", dev.type, "--ckpt-dir",
                                     os.path.join(tmp, "faults")])
        ref = ftm.run(ftm.parser().parse_args(
            EXAMPLE_FT + ["--device", dev.type, "--ckpt-dir",
                          os.path.join(tmp, "clean")]), faults=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diff = _state_diff(got["state"], ref[0])
    check(got["restarts"] == 2 and not diff,
          f"fault-tolerant example: restarts {got['restarts']}, leaves "
          f"that differ from the uninterrupted run: {diff[:5]}")
    rec["fault_tolerant"] = {"restarts": got["restarts"],
                             "first": got["first"], "last": got["last"],
                             "steps_run": len(got["history"])}
    secs["fault_tolerant"] = time.perf_counter() - t0

    rec["launches"] = dict(zip(("cim_mbiw", "cim_mbiw_tc",
                                "cim_mbiw_splitk"), kernel_counts(kern)),
                           threefry_normal=pk.threefry_normal.launches)
    rec["seconds"] = secs
    print(f"examples {tag}: quickstart ABN error {qs['rel_abn']:.4f} < "
          f"unity gain {qs['rel_unity']:.4f}, engine == reference; serve "
          f"{arch} (smoke widths, float32, batch {batch}, gen {gen}) engine "
          f"tokens == fakequant; noise sweep clean accuracy "
          f"{clean['acc_mean']:.3f} (chance 0.1); LeNet loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f} in {len(losses)} noisy "
          f"steps; fault-tolerant pretraining ({' '.join(EXAMPLE_FT)}) "
          f"restarts 2, state == the uninterrupted run; launches "
          f"{rec['launches']}; " + ", ".join(
              f"{k} {v:.1f} s" for k, v in secs.items()), flush=True)
    _free(dev)
    return rec


def cuda_core_fns(fk, q, k, v, do, lse, delta, q_off, causal,
                  window) -> dict:
    """The CUDA-core forward, dq and dk/dv kernels (flash_fwd.cu,
    flash_bwd.cu: the earlier design, which bf16 calls on a tensor-core
    route no longer reach) on the same bf16 inputs, called through their
    C entry points, to time them beside the tensor-core kernels in one
    run; "outputs" holds the buffers they write (O, lse, dq, dk, dv)."""
    import ctypes
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device) \
        .transpose(1, 2)
    o_lse = torch.empty_like(lse)
    dq = torch.empty((b, sq, h, d), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, sk, h, d), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    st = fk._bshd_strides
    fwd_st = (ctypes.c_longlong * 12)(*(st(q) + st(k) + st(v) + st(o)))
    dq_st = (ctypes.c_longlong * 21)(*(st(q) + st(k) + st(v) + st(do)
                                        + st(dq) + (0,) * 6))
    dkv_st = (ctypes.c_longlong * 21)(*(st(q) + st(k) + st(v) + st(do)
                                         + (0,) * 3 + st(dk) + st(dv)))
    rest = (b, h, h // g, sq, sk, d, int(causal), int(window),
            1.0 / d ** 0.5, torch.cuda.current_stream().cuda_stream)
    lf, lb = fk._flash_library("flash_fwd"), fk._flash_library("flash_bwd")

    def fwd():
        check(lf.flash_fwd_launch(1, q.data_ptr(), k.data_ptr(),
                                  v.data_ptr(), q_off.data_ptr(),
                                  o.data_ptr(), o_lse.data_ptr(), fwd_st,
                                  *rest) == 0, "CUDA-core forward launch")

    def dq_():
        check(lb.flash_bwd_dq_launch(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_off.data_ptr(), dq.data_ptr(),
            dq_st, *rest) == 0, "CUDA-core dq launch")

    def dkv():
        check(lb.flash_bwd_dkv_launch(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_off.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dkv_st, *rest) == 0, "CUDA-core dk/dv launch")
    return {"fwd": fwd, "dq": dq_, "dkv": dkv,
            "outputs": (o, o_lse, dq, dk, dv)}


def draw_trip() -> DrawTrip:
    """threefry_normal_kernel's trip (`draw_trip_of`) in the built
    library's `cuobjdump -sass` (the listing goes to
    chiprun_out/threefry_sass.txt): NORMALS_A_TRIP normals a trip, left in
    one 16-byte store."""
    from repro_torch.analysis import sass
    from repro_torch.kernels import build
    from repro_torch.kernels.prng import kernel as pk
    text = sass.disassemble(build._BUILT["threefry_normal"].path)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "threefry_sass.txt"),
              "w") as f:
        f.write(text)
    funcs = sass.parse_functions(text)
    names = [f for f in funcs if "threefry_normal_kernel" in f]
    check(len(names) == 1, f"threefry_normal_kernel in the SASS: {names}")
    trip = draw_trip_of(funcs[names[0]])
    check((trip.normals, trip.stores) == (pk.NORMALS_A_TRIP, 1),
          f"threefry_normal's trip stores {trip.normals} normals in "
          f"{trip.stores} stores, not {pk.NORMALS_A_TRIP} in one (a store "
          f"a normal: {trip.stores / trip.normals}): {trip}")
    return trip


# |z| from which log1p(-u^2) <= -5: a normal on erf_inv's tail side
Z_TAIL = math.sqrt(2) * float(torch.special.erfinv(torch.tensor(
    math.sqrt(-math.expm1(-5.0)), dtype=torch.float64)))


def draw_tail_share(drawn: torch.Tensor, per_lane: int) -> float:
    """The share of (warp, slot) pairs that run erf_inv's tail side, for
    a draw `drawn` (S, n) laid out as the kernel lays it out: a lane
    computes `per_lane` consecutive normals of a stream (unit s * ceil(n /
    per_lane) + q), 32 consecutive units make a warp, and the warp runs
    slot e's square root when one lane's e-th normal has |z| >= Z_TAIL.
    The kernel's first design is `per_lane` 1."""
    s, n = drawn.shape
    q = -(-n // per_lane)
    hit = torch.zeros((s, q * per_lane), dtype=torch.bool,
                      device=drawn.device)
    hit[:, :n] = drawn.abs() >= Z_TAIL
    units = hit.reshape(s * q, per_lane)
    pad = torch.zeros((-(s * q) % 32, per_lane), dtype=torch.bool,
                      device=drawn.device)
    return float(torch.cat([units, pad]).reshape(-1, 32, per_lane).any(1)
                 .double().mean())


def draw_times(dev, tag, decode_shape) -> dict:
    """threefry_normal at three draws: the noisy LeNet's conv1 draw (batch
    256: the residue stream and 1568 blocks of 128 rows x 16 channels),
    whisper's served frames (one stream of 4 x 1500 x 1024) and the noisy
    decode's engine draw (`decode_shape`, read in that phase).  At each:
    the CUDA-event ms a wrapper call over 50 calls, the device us a call
    in each of 5 replays of a CUDA graph of 20 launches, the wrapper's
    host us a call (where it exceeds the device's, the events time the
    host), the plain
    version's ms, torch.randn of as many normals (a yardstick only: not
    the same function, PyTorch's Philox normals), and the bound from the
    new SASS (`draw_trip`) and from the first design's
    (`DRAW_TRIP_FIRST`), each with its layout's share of warps on
    erf_inv's tail; the share of the bound against the smaller.  The
    launches made here are not main-path ones."""
    from repro_torch.core import prng
    from repro_torch.kernels.prng import kernel as pk
    from repro_torch.kernels.prng.ref import threefry_normal_ref
    trip = draw_trip()
    print(f"time {tag} threefry_normal's trip in the SASS: {trip.trip} "
          f"instructions for {trip.normals} normals in {trip.stores} "
          f"store(s); a normal's own {trip.own():.2f} ({trip.work}) and "
          f"{trip.layout():.2f} not its own (the layout's index, divide, "
          f"addresses, stores, loop control and constants); "
          f"{trip.tail['all']:.2f} more on erf_inv's tail side; the first "
          f"design's trip: own {DRAW_TRIP_FIRST.own():.0f}, not own "
          f"{DRAW_TRIP_FIRST.layout():.0f}, tail "
          f"{DRAW_TRIP_FIRST.tail['all']:.0f}", flush=True)
    shapes = {"lenet_conv1": (1 + LENET_BATCH * 784 // 128, 128 * 16),
              "whisper_frames": (1, AUDIO_BATCH * AUDIO_FRAMES * 1024),
              "noisy_decode": tuple(decode_shape)}
    out = {"sass_trip": dataclasses.asdict(trip),
           "sass_trip_first": dataclasses.asdict(DRAW_TRIP_FIRST)}
    for what, (streams, n) in shapes.items():
        keys = prng.fold_in(prng.key(1)[None],
                            torch.arange(streams)).to(dev)
        before = pk.threefry_normal.launches
        ms = cuda_ms(lambda: pk.threefry_normal(keys, n), 50)
        windows = graph_windows(lambda: pk.threefry_normal(keys, n))
        host = host_us(lambda: pk.threefry_normal(keys, n))
        drawn = pk.threefry_normal(keys, n)
        pk.threefry_normal.launches = before     # not the main path
        plain = cuda_ms(lambda: threefry_normal_ref(keys, n), 3)
        randn = cuda_ms(lambda: torch.randn((streams, n), device=dev), 50)
        shares = {"new": draw_tail_share(drawn, pk.NORMALS_A_TRIP),
                  "first": draw_tail_share(drawn, 1)}
        del drawn
        bounds = {"new": draw_bound_ms(streams, n, trip, shares["new"]),
                  "first": draw_bound_ms(streams, n, DRAW_TRIP_FIRST,
                                        shares["first"])}
        least = min(bounds, key=lambda k_: bounds[k_][0])
        bnd, by, _ = bounds[least]
        g_med = statistics.median(windows)
        rec = {"streams": streams, "n": n, "ms": ms, "host_us": host,
               "graph_us": g_med, "graph_windows_us": windows,
               "plain_ms": plain, "randn_ms": randn,
               "tail_share": shares, "bound_ms": bnd, "bound_by": by,
               "bound_from": least,
               "bounds": {k_: {"ms": v[0], "by": v[1], "terms_ms": v[2]}
                          for k_, v in bounds.items()},
               "share_of_bound": bnd / ms,
               "share_of_bound_graph": 1e3 * bnd / g_med}
        out[what] = rec
        print(f"time {tag} threefry_normal {what} S={streams} n={n}: "
              f"wrapper {ms:.4f} ms a call (events, 50 calls), graph "
              f"{g_med / 1e3:.4f} ms a launch (median of 5 windows of 20: "
              + ", ".join(f"{w / 1e3:.4f}" for w in windows)
              + f"), wrapper host {host:.1f} us a call, plain "
              f"{plain:.4f} ms, torch.randn {randn:.4f} ms "
              "(another function); bound from the new SASS "
              f"{bounds['new'][0]:.4f} ms ({bounds['new'][1]}; "
              + ", ".join(f"{k_} {v:.4f}" for k_, v in
                          bounds["new"][2].items())
              + f"; tail share {shares['new']:.4f}), from the first "
              f"design's count {bounds['first'][0]:.4f} ms "
              f"({bounds['first'][1]}; tail share {shares['first']:.4f}); "
              f"the wrapper at "
              f"{100 * bnd / ms:.1f}% and the graph at "
              f"{100 * 1e3 * bnd / g_med:.1f}% of the smaller ({least})",
              flush=True)
    main = out["lenet_conv1"]
    out.update({k_: main[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")})
    return out


def flash_times(fk, fref, dev, tag, shape, cuda_core: bool = False,
                what: str = "") -> dict:
    """CUDA-event ms of the three flash kernels at `shape` (B, H, G, Sq,
    Sk, D, causal) in bf16, their plain versions and SDPA forward /
    backward on the same inputs (causal by `is_causal`, else unmasked),
    with bounds; with `cuda_core` the CUDA-core kernels of the earlier
    design on the same inputs too.  The launches made here are not
    main-path ones."""
    b, h, g, sq, sk, d, causal = shape
    q, k, v, do = flash_inputs(b, h, g, sq, sk, d, torch.bfloat16, 7, dev)
    q_off = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    kw = dict(causal=causal, window=0)
    o, lse = fk.flash_fwd(q, k, v, q_off, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, q_off)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), do)
    check(torch.allclose(sdpa().float(), o.float(), rtol=2e-2, atol=2e-2),
          f"the SDPA yardstick computes another function than flash_fwd "
          f"at {shape}")
    kerns = (fk.flash_fwd, fk.flash_bwd_dq, fk.flash_bwd_dkv)
    before = [(f.launches, f.launches_tc) for f in kerns]
    core = (cuda_core_fns(fk, *args, causal=causal, window=0)
            if cuda_core else {})
    fns = {"fwd": (lambda: fk.flash_fwd(q, k, v, q_off, **kw),
                   lambda: fref.flash_fwd_ref(q, k, v, q_off, **kw)),
           "dq": (lambda: fk.flash_bwd_dq(*args, **kw),
                  lambda: fref.flash_bwd_dq_ref(*args, **kw)),
           "dkv": (lambda: fk.flash_bwd_dkv(*args, **kw),
                   lambda: fref.flash_bwd_dkv_ref(*args, **kw))}
    sdpa_fwd = cuda_ms(sdpa, 10)
    sdpa_bwd = cuda_ms(sdpa_fwd_bwd, 10) - sdpa_fwd
    out = {"shape": {"b": b, "h": h, "g": g, "sq": sq, "sk": sk, "d": d,
                     "causal": causal, "dtype": "bfloat16"},
           "sdpa_fwd_ms": sdpa_fwd, "sdpa_bwd_ms": sdpa_bwd}
    for kind, (kern, plain) in fns.items():
        bnd, by = flash_bound_ms(kind, b, h, g, sq, sk, d, causal, 0, 2)
        out[kind] = {"ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 2),
                     "bound_ms": bnd, "bound_by": by,
                     "library_ms": sdpa_fwd if kind == "fwd" else sdpa_bwd}
        r = out[kind]
        if kind in core:
            r["cuda_core_ms"] = cuda_ms(core[kind], 2)
        earlier = (f", CUDA-core kernel (earlier design) "
                   f"{r['cuda_core_ms']:.3f} ms" if kind in core else "")
        print(f"time {tag} flash_{kind}{what} B={b} H={h} Sq={sq} Sk={sk} "
              f"D={d} {'causal' if causal else 'non-causal'} bf16: kernel "
              f"{r['ms']:.4f} ms{earlier}, plain {r['plain_ms']:.3f} ms, "
              f"SDPA {'forward' if kind == 'fwd' else 'backward (dq, dk, dv)'}"
              f" {r['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by})",
              flush=True)
    for f, (n, n_tc) in zip(kerns, before):
        f.launches, f.launches_tc = n, n_tc
    return out


def main() -> int:
    depth = DECODE_DEPTH
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.core import digital_ref
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.cim_mbiw import kernel as kmod
    from repro_torch.kernels.cim_mbiw import ops as kops
    from repro_torch.kernels.cim_mbiw import ref as kref
    from repro_torch.kernels.flash_attn import kernel as rmod
    from repro_torch.kernels.flash_attn import ref as rref
    from repro_torch.models import cnn
    from repro_torch.runtime import engine as trt
    from repro_torch.runtime import program as tprog
    from repro_torch.runtime.scheduler import (CIMDecodeLM,
                                               InflightScheduler, Request,
                                               decode_sequential)

    # the plain versions' products run in float64 (no TF32 there); stated
    # here all the same so no float32 yardstick can drift into TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    kern = kmod.cim_mbiw_matmul_planes
    ring = rmod.ring_decode
    clock = CaptureClock(tprog)
    graphs: dict = {}
    t_start = t_phase = time.perf_counter()
    phase_s: dict = {}

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    infos = build.build_all(force=True)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.split("ptxas info    :")[-1].strip()
                    for ln in info.log.splitlines()
                    if "Used" in ln or ("spill" in ln and " 0 bytes spill"
                                        not in ln)]
             for name, info in infos.items()}
    report["build"] = {"seconds": build_s, "ptxas": ptxas,
                       "per_kernel_s": {n: i.seconds
                                        for n, i in infos.items()}}
    print(f"build: {len(infos)} kernel(s) in {build_s:.1f} s; "
          + "; ".join(f"{n}: {' | '.join(v)}" for n, v in ptxas.items()),
          flush=True)
    report["build"]["ptxas_d256"] = ptxas_d256(infos, build)

    phase_s["build"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 2. kernel vs plain version ------------------------------------------
    rng = np.random.default_rng(0)

    def tile_inputs(m, k, n, r_in, r_w, beta_rows):
        full = 2**r_w - 1
        x = torch.from_numpy(rng.integers(0, 2**r_in, size=(m, k),
                                          dtype=np.int32))
        w = torch.from_numpy((2 * rng.integers(-(full + 1) // 2,
                                               (full + 1) // 2, size=(k, n))
                              + 1).astype(np.int8))
        gamma = torch.from_numpy(
            (2.0 ** rng.uniform(0, 5, size=(1, n))).astype(np.float32))
        beta = torch.from_numpy(rng.uniform(
            -16, 16, size=(m if beta_rows else 1, n)).astype(np.float32))
        shift, _ = kmod.plane_layout(r_in)
        planes, _ = kops.split_planes(x, r_in, shift)
        return shift, [t.to(dev) for t in (planes, w, gamma, beta)]

    def compare(m, k, n, r_in, r_w, r_out, beta_rows, fuse_adc):
        shift, args = tile_inputs(m, k, n, r_in, r_w, beta_rows)
        g0 = digital_ref.adc_gain_factor(r_in, r_w, r_out,
                                         36 * -(-min(k, 1152) // 36))
        kw = dict(plane_shift=shift, g0=g0, r_out=r_out, fuse_adc=fuse_adc)
        route = kmod.route_for(m, n, k, args[0].shape[1] // k).name
        before = kernel_counts(kern)
        got = kern(*args, **kw)
        want = kref.cim_mbiw_matmul_planes_ref(*args, **kw)
        torch.cuda.synchronize()
        what = (f"{(m, k, n, r_in, r_w, r_out)} beta_rows={beta_rows} "
                f"fuse_adc={fuse_adc} (route {route})")
        rose = tuple(a - b for a, b in zip(kernel_counts(kern), before))
        check(rose == (1, int(route == "tc"), int(route == "splitk")),
              f"cim_mbiw counters rose by {rose} at {what}")
        check(torch.equal(got, want), f"cim_mbiw != plain at {what}")
        route_cases[route] += 1
        return int((got.long() - want.long()).abs().max())

    cases, max_err = 0, 0
    route_cases = {"tc": 0, "splitk": 0, "cuda_core": 0}
    for r_in in (1, 2, 3, 4, 8):
        for r_w in (1, 2, 4):
            for r_out in (1, 4, 8):
                for beta_rows in (False, True):
                    for fuse in (True, False):
                        max_err = max(max_err, compare(
                            70, 200, 40, r_in, r_w, r_out, beta_rows, fuse))
                        cases += 1
    ragged = [(17, 300, 33), (100, 1152, 64), (1, 9, 1), (129, 37, 65)]
    lenet_tiles = {(4, 2): [(LENET_BATCH * 784, 9, 16),
                            (LENET_BATCH * 196, 144, 32),
                            (LENET_BATCH, 784, 128), (LENET_BATCH, 128, 10)],
                   (8, 4): [(LENET_BATCH * 784, 9, 16),
                            (LENET_BATCH * 196, 144, 32),
                            (LENET_BATCH, 784, 64), (LENET_BATCH, 128, 10)]}
    shapes = [s + (8, 4) for s in ragged] + [
        s + p for p, tiles in lenet_tiles.items() for s in tiles]
    for (m, k, n, r_in, r_w) in shapes:
        for beta_rows in (False, True):
            for fuse in (True, False):
                max_err = max(max_err, compare(m, k, n, r_in, r_w, 8,
                                               beta_rows, fuse))
                cases += 1
    # the routes' edges: one and two planes ((4, 2) and (8, 4))
    for m in ROUTE_M:
        for n in ROUTE_N:
            for k in ROUTE_K:
                for i, (r_in, r_w) in enumerate(PRECISIONS):
                    for beta_rows in (False, True):
                        max_err = max(max_err, compare(
                            m, k, n, r_in, r_w, 8, beta_rows,
                            (i + beta_rows) % 2 == 0))
                        cases += 1
    canary = kref.fma_canary(0)
    c_args = [torch.from_numpy(canary[k]).to(dev)
              for k in ("x", "w", "gamma", "beta")]
    before = kernel_counts(kern)
    got = kops.cim_matmul(*c_args, r_in=8, r_out=canary["r_out"],
                          g0=canary["g0"]).cpu().numpy()
    check(kernel_counts(kern)[1] == before[1] + 1,
          "FMA canary: not on the tensor-core route")
    flips = int(np.sum(canary["codes"] != canary["codes_fma"]))
    check(np.array_equal(got, canary["codes"]),
          "FMA canary: kernel codes differ from the rounded chain")
    cases += 1
    report["kernel_vs_plain"] = {"cases": cases, "max_abs_err": max_err,
                                 "route_cases": route_cases,
                                 "canary_fma_flips": flips}
    print(f"kernels: cim_mbiw == plain on {cases} cases (grid r_in "
          f"{{1,2,3,4,8}} x r_w {{1,2,4}} x r_out {{1,4,8}} x beta (1,N)/"
          f"(M,N) x fuse_adc, ragged, LeNet tiles at batch {LENET_BATCH}, "
          f"route edges M {ROUTE_M} x N {ROUTE_N} x K {ROUTE_K}; per "
          f"route {route_cases}, each on the route route_for names; FMA "
          f"canary through the tensor-core route with {flips} codes an "
          f"FMA would move), max_abs_err {max_err}", flush=True)

    rc = ring_checks(rmod, rref, dev)
    rmax = rc["max_abs_err"]
    report["ring_vs_plain"] = rc
    print(f"kernels: ring_decode within rtol=atol=1e-5 of plain on "
          f"{rc['cases']} cases (R {{1,3,4,8}} x H {{1,16}} x hd "
          f"{{12,128,130,256}} "
          f"x L {{{','.join(map(str, RING_LENGTHS))}}}, ragged valid slots "
          f"first or only in the last {rmod.RING_CHUNK}-slot chunk, strided "
          f"state views), max_abs_err {rmax:.3g}; every row bit-equal to "
          f"its one-row call", flush=True)

    flash = flash_checks(rmod, rref, dev)
    report["flash_vs_plain"] = flash
    pk = flash["stress"]["peaked"]
    print(f"kernels: flash_fwd / flash_bwd_dq / flash_bwd_dkv within "
          f"tolerance of plain on {flash['cases']} cases (causal x window "
          f"{{0,256}} x rep {{1,2,16}} x D {{64,128}}, ragged Sq/Sk in "
          f"{{1,77,512,4096}}, q_off {{0,100}}, the train shape in f32 "
          f"and bf16, bf16 flat rows at S 4096; 2e-5 forward, 5e-5 "
          f"backward, bf16 O one ulp); max_abs_err f32 / bf16 "
          + ", ".join(f"{k} {v['float32']:.3g} / {v['bfloat16']:.3g}"
                      for k, v in flash["max_abs_err"].items())
          + "; bf16 peaked rows against float64, kernel / plain float32 "
          + ", ".join(f"{k} {v['kernel_vs_f64']:.3g} / "
                      f"{v['plain_vs_f64']:.3g}" for k, v in pk.items())
          + "; every bf16 D 64/128 case on the tensor-core forward, dq "
          "and dk/dv; every backward bit-equal on a second run", flush=True)

    draws = draw_checks(dev)
    report["draw_vs_plain"] = draws
    print(f"kernels: threefry_normal == plain on the card on "
          f"{draws['cases']} cases (streams {DRAW_STREAMS} x n "
          f"{DRAW_LENGTHS}, at most {DRAW_MAX} normals a case; keys from "
          f"key, fold_in (an id above 2^31) and split), == the host's draw "
          f"on the {draws['host_cases']} cases of at most {DRAW_HOST_MAX}; "
          f"one launch a call; normal_of_bits == _normal_from_bits on all "
          f"{draws['patterns']} patterns m << 9, bit for bit", flush=True)

    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 3. LeNet served at full width (the first main path) -----------------
    n_img = LENET_BATCH + sum(REQUESTS)
    images = torch.from_numpy(make_dataset(n_train=1, n_test=n_img,
                                           seed=0)[2][..., None])
    x = images[:LENET_BATCH]
    reqs, s = [], LENET_BATCH
    for b in REQUESTS:
        reqs.append(images[s:s + b])
        s += b
    main_routes = {"all": 0, "tc": 0, "splitk": 0}
    lenet = {}
    cap_mark, cap_n0 = len(clock.seconds), trt.CAPTURE_COUNT["n"]
    for r_in, r_w in PRECISIONS:
        cim = CIMConfig(r_in=r_in, r_w=r_w)
        params = cnn.lenet_params_list(
            cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
        prog = cnn.lenet_program(LENET_BATCH, cim=cim)
        check(prog.device.type == "cuda", "program is not on the card")
        bound = prog.bind(params)
        per_fwd = prog.plan.total_macro_evals
        reset_counts(kern)
        y = bound.serve(x)
        torch.cuda.synchronize()
        counts_serve = kernel_counts(kern)
        reset_counts(kern)
        ys = bound.serve_batch(reqs)
        torch.cuda.synchronize()
        counts_batch = kernel_counts(kern)
        launches_serve, launches_batch = counts_serve[0], counts_batch[0]
        for c in (counts_serve, counts_batch):
            for r, n_ in zip(("all", "tc", "splitk"), c):
                main_routes[r] += n_
        check(launches_serve == per_fwd and launches_batch == per_fwd,
              f"kernel launches per forward {launches_serve}/"
              f"{launches_batch} != planned tiles {per_fwd}")
        # each tile on the route route_for names for it (serve_batch
        # dispatches the concatenated requests at their bucket)
        for got_c, rows in ((counts_serve, LENET_BATCH),
                            (counts_batch,
                             prog.buckets.bucket_for(sum(REQUESTS)))):
            want_c = kmod.route_counts(prog.plan.tile_calls(rows))
            check(got_c == (sum(want_c.values()), want_c["tc"],
                            want_c["splitk"]),
                  f"LeNet ({r_in},{r_w}) at {rows} rows: launches (all, "
                  f"tc, splitk) {got_c} != route_for's {want_c}")
        check(tuple(y.shape) == (LENET_BATCH, 10) and y.is_cuda
              and bool(torch.isfinite(y).all()), "logits shape/finiteness")
        before = kern.launches
        y_ref = bound.reference(x)
        check(kern.launches == before, "the reference launched the kernel")
        check(torch.equal(y, y_ref), "card logits != card reference")
        host = cnn.lenet_program(LENET_BATCH, cim=cim, device="cpu")
        y_cpu = host.bind(params).serve(x)
        check(torch.equal(y.cpu(), y_cpu), "card logits != CPU run")
        check(torch.equal(torch.cat(ys), bound.serve(torch.cat(reqs))),
              "serve_batch != serve of the concatenation")
        # the graphs: every dispatch above but the reference captured or
        # replayed one; a replay == engine._forward run eagerly at every
        # rung the phase visits, shared and isolated serve_batch included
        rungs = {}
        for xx in [x, torch.cat(reqs)] + reqs:
            rung = prog.buckets.bucket_for(xx.shape[0])
            check(torch.equal(bound.serve(xx), eager_forward(trt, bound, xx)),
                  f"LeNet ({r_in},{r_w}) rung {rung}: graph replay != eager")
            rungs[rung] = rungs.get(rung, 0) + 1
        seg_iso = torch.repeat_interleave(torch.arange(len(REQUESTS)),
                                          torch.tensor(REQUESTS))
        iso = [torch.cat(bound.serve_batch(reqs, isolate=True))
               for _ in range(2)]
        check(torch.equal(iso[0], iso[1]) and torch.equal(
            iso[1], eager_forward(trt, bound, torch.cat(reqs), seg_iso)),
              f"LeNet ({r_in},{r_w}): isolated serve_batch graph != eager")
        for xi, yi in zip(reqs, torch.split(iso[1], list(REQUESTS))):
            check(torch.equal(yi, bound.serve(xi)),
                  f"LeNet ({r_in},{r_w}): isolated request != solo serve")
        # timed replays: no capture, one replay each, and the launches of
        # as many eager forwards on each route
        want_c = kmod.route_counts(prog.plan.tile_calls(LENET_BATCH))
        captures, st0 = trt.CAPTURE_COUNT["n"], prog.stats()
        reset_counts(kern)
        lat = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bound.serve(x)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        counts_timed = kernel_counts(kern)
        st = prog.stats()
        check(trt.CAPTURE_COUNT["n"] == captures
              and st["graph_replays"] - st0["graph_replays"] == 20
              and st["eager_calls"] == st0["eager_calls"],
              f"LeNet ({r_in},{r_w}): timed serves were not 20 replays "
              f"without a capture")
        check(counts_timed == tuple(20 * v for v in (
            sum(want_c.values()), want_c["tc"], want_c["splitk"])),
              f"LeNet ({r_in},{r_w}): 20 replays launched {counts_timed}, "
              f"not 20 x route_for's {want_c}")
        for r, n_ in zip(("all", "tc", "splitk"), counts_timed):
            main_routes[r] += n_
        lat_eager = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eager_forward(trt, bound, x)
            torch.cuda.synchronize()
            lat_eager.append(time.perf_counter() - t0)
        med = statistics.median(lat[3:])
        med_eager = statistics.median(lat_eager[3:])
        prof = device_profile(lambda: bound.serve(x), 10)
        prof_eager = device_profile(lambda: eager_forward(trt, bound, x), 10)
        lenet[f"{r_in},{r_w}"] = {
            "launches_per_forward": launches_serve,
            "routes_per_forward": want_c,
            "planned_tiles": per_fwd, "median_latency_ms": 1e3 * med,
            "images_per_s": LENET_BATCH / med,
            "latencies_ms": [1e3 * t for t in lat], "profile": prof,
            "eager_median_latency_ms": 1e3 * med_eager,
            "eager_latencies_ms": [1e3 * t for t in lat_eager],
            "eager_profile": prof_eager, "rungs_checked": rungs,
            "graphs_held": len(bound.executables), "stats": st}

        def busy(pr):
            return (f"device {pr['device_us']:.1f} us (cim_mbiw "
                    f"{pr['cim_mbiw_us']:.1f}), busy "
                    f"{100 * pr['device_busy']:.1f}% profiled" if pr
                    else "device time not measured (profiler saw none)")
        print(f"lenet ({r_in},{r_w}) {tag}: batch {LENET_BATCH} logits == "
              f"card reference == CPU run (bit for bit), serve_batch "
              f"{list(REQUESTS)} == serve(concat); {launches_serve} kernel "
              f"launches per forward (= planned tiles; routes {want_c} as "
              f"route_for names them); graph replay == eager "
              f"engine._forward at rungs {sorted(rungs)} and isolated "
              f"serve_batch, isolated requests == solo; 20 timed serves = "
              f"20 replays, no capture, launches 20 x the tiles; median "
              f"serve {1e3 * med:.3f} ms, {LENET_BATCH / med:.0f} images/s, "
              f"{busy(prof)}; eager _forward {1e3 * med_eager:.3f} ms, "
              f"{busy(prof_eager)}", flush=True)
    report["lenet"] = lenet
    graphs["lenet"] = dict(clock.since(cap_mark),
                           capture_count=trt.CAPTURE_COUNT["n"] - cap_n0,
                           pool_bytes=graph_pool_bytes(tprog, dev))
    phase_s["lenet"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 4. noisy LeNet serving (the noise slice's main path) ----------------
    noise = lenet_noise_phase(dev, tag, make_dataset, cnn, kern, kmod)
    report["noise_lenet"] = noise
    phase_s["noise"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 4. in-flight decode serving at OLMo-1B widths (the second path) -----
    t0 = time.perf_counter()
    model = CIMDecodeLM.toy(
        torch.Generator().manual_seed(0), depth=depth,
        r_in=DECODE_POINTS[""][0], r_w=DECODE_POINTS[""][1],
        points={"quality": DECODE_POINTS["quality"]}, **DECODE_WIDTHS)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    check(model.device.type == "cuda", "decode model is not on the card")
    tiles = {p: sum(b.qkv.program.plan.total_macro_evals
                    + b.o.plan.total_macro_evals
                    + b.gate_up.program.plan.total_macro_evals
                    + b.down.plan.total_macro_evals
                    for b in model.blocks_for(p)) for p in model.points}
    sched_in = decode_requests(model.vocab)
    reqs = {u: Request(u, p, n, pt) for _, u, p, n, pt in sched_in}
    arrivals = [(t, reqs[u]) for t, u, *_ in sched_in]

    # fused-step wall times per point (the scheduler syncs on the tokens)
    step_ms: dict = {}
    inner = model.step_rows

    def timed_step(state, tokens, *a, point="", commit=None, **kw):
        t = time.perf_counter()
        out = inner(state, tokens, *a, point=point, commit=commit, **kw)
        torch.cuda.synchronize()
        if commit is not None:
            step_ms.setdefault(point, []).append(
                1e3 * (time.perf_counter() - t))
        return out
    model.step_rows = timed_step
    cap_mark, cap_n0 = len(clock.seconds), trt.CAPTURE_COUNT["n"]
    reset_counts(kern)
    ring.launches = 0
    sched = InflightScheduler(model, capacity=DECODE_CAPACITY)
    t0 = time.perf_counter()
    streams = sched.run(arrivals)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    dec_cim, dec_ring = kern.launches, ring.launches
    dec_splitk = kern.launches_splitk
    del model.step_rows
    # every projection dispatch of the run was clean: each program's
    # dispatch keys were captured once, on their first call, and replayed
    # after it
    bounds = [b for p in model.points for blk in model.blocks_for(p)
              for b in (blk.qkv.bound, blk.o, blk.gate_up.bound, blk.down)]
    held = sum(len(b.executables) for b in bounds)
    cap_run = trt.CAPTURE_COUNT["n"] - cap_n0
    dstats = {}
    # the blocks of a point share their programs (equal plans)
    for prog_ in {id(b.program): b.program for b in bounds}.values():
        for k_, v in prog_.stats().items():
            dstats[k_] = dstats.get(k_, 0) + v
    check(cap_run == held > 0,
          f"decode: {cap_run} captures != {held} graphs held")
    calls = {p: sum(len(r.prompt) for r in reqs.values() if r.point == p)
             + sched.points_served.get(p, 0) for p in model.points}
    planned = sum(tiles[p] * calls[p] for p in calls)
    check(dec_cim == planned, f"decode cim_mbiw launches {dec_cim} != "
          f"planned tiles x calls {planned}")
    check(dec_splitk == dec_cim,
          f"decode: {dec_cim - dec_splitk} of {dec_cim} cim_mbiw launches "
          f"not on the split-K route (every decode tile has M <= "
          f"{DECODE_CAPACITY})")
    ring_want = rmod.RING_KERNELS * depth * sum(calls.values())
    check(dec_ring == ring_want,
          f"decode ring_decode launches {dec_ring} != two kernels x depth "
          f"x calls {ring_want}")
    check(set(streams) == set(reqs), "not every request finished")
    for u, r in reqs.items():
        toks = streams[u]
        check(len(toks) == r.max_new_tokens
              and all(0 <= t < model.vocab for t in toks),
              f"request {u} stream {toks} has the wrong length or range")
    t0 = time.perf_counter()
    for u, r in reqs.items():
        check(decode_sequential(model, r) == streams[u],
              f"request {u} ({r.point!r}): fused stream != solo decode")
    solo_s = time.perf_counter() - t0
    check(trt.CAPTURE_COUNT["n"] == cap_n0 + cap_run,
          "decode: the solo decodes captured again")
    # a bound projection on the card against its plain reference, with
    # one segment per row and a 100x spread of swings
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((4, model.d), generator=g, device=dev) * torch.tensor(
        [[1.0], [100.0], [0.1], [3.0]], device=dev)
    for p in model.points:
        qkv = model.blocks_for(p)[0].qkv.bound
        seg = torch.arange(4, device=dev)
        check(torch.equal(qkv.serve(h, segments=seg),
                          qkv.reference(h, segments=seg)),
              f"point {p!r}: qkv serve != its card reference")
    met = sched.metrics()
    med = {p: statistics.median(v) for p, v in step_ms.items()}
    report["decode"] = {
        "widths": DECODE_WIDTHS, "depth": depth,
        "points": {p or "base": list(rs) for p, rs in DECODE_POINTS.items()},
        "capacity": DECODE_CAPACITY, "bind_s": bind_s, "run_s": run_s,
        "solo_check_s": solo_s, "requests": sched_in,
        "streams": {str(u): t for u, t in streams.items()},
        "calls": calls, "tiles_per_call": tiles,
        "launches": {"cim_mbiw": dec_cim, "cim_mbiw_splitk": dec_splitk,
                     "ring_decode": dec_ring},
        "step_ms": step_ms, "median_step_ms": med, "metrics": met,
        "graphs_held": held, "program_stats": dstats}
    graphs["decode"] = dict(clock.since(cap_mark), capture_count=cap_run,
                            pool_bytes=graph_pool_bytes(tprog, dev))
    print(f"decode [{card}]: OLMo-1B widths, depth {depth}, points "
          f"{DECODE_POINTS}; bind {bind_s:.1f} s; {len(reqs)} requests at "
          f"capacity {DECODE_CAPACITY}: every fused stream == "
          f"decode_sequential; launches cim_mbiw {dec_cim} (= planned "
          f"tiles x calls, all {dec_splitk} split-K), ring_decode "
          f"{dec_ring} (= 2 kernels x depth x calls "
          f"{calls}); {cap_run} captures = {held} graphs held, one a "
          f"program's dispatch key, none in the solo decodes; "
          f"{dstats['graph_replays']} replays, "
          f"{dstats['eager_calls']} eager calls; qkv serve == card "
          f"reference at both points", flush=True)
    print(f"decode metrics [{card}]: tokens/s {met['tokens_per_s']:.3f}, "
          f"{met['tokens']:.0f} tokens, {met['decode_steps']:.0f} fused "
          f"steps in {met['decode_wall_s']:.1f} s, extents "
          f"{met['extents_seen']}, median fused step "
          + ", ".join(f"{p or 'base'!r} {med[p]:.1f} ms over "
                      f"{len(step_ms[p])} steps" for p in sorted(med))
          + f"; run {run_s:.1f} s, solo checks {solo_s:.1f} s", flush=True)
    phase_s["decode"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 6. noisy in-flight decode -----------------------------------------
    ndec = noisy_decode_phase(dev, tag, kern)
    report["noise_decode"] = ndec
    phase_s["noise_decode"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 7. training at full OLMo-1B width (the third main path), with the
    #       noisy step ---------------------------------------------------------
    train = train_phase(dev, tag)
    report["train"] = train
    torch.cuda.empty_cache()
    phase_s["train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 8. the LM serve path (launch/serve.py) at full OLMo-1B width --------
    cap_mark = len(clock.seconds)
    lserve = llm_serve_phase(dev, tag, kern, kmod, tprog, trt, clock)
    report["llm_serve"] = lserve
    graphs["llm_serve"] = dict(clock.since(cap_mark),
                               capture_count=lserve["static"]["captures"][
                                   "captures"]
                               + lserve["inflight"]["captures"]["captures"],
                               pool_bytes=graph_pool_bytes(tprog, dev))
    phase_s["llm_serve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 9. workload-adaptive precision serving -------------------------------
    cap_mark = len(clock.seconds)
    prec = precision_phase(dev, tag, kern, kmod, tprog, trt, clock)
    report["precision"] = prec
    graphs["precision"] = dict(clock.since(cap_mark),
                               capture_count=prec["captures"]["captures"],
                               pool_bytes=graph_pool_bytes(tprog, dev))
    torch.cuda.empty_cache()
    phase_s["precision"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 10. the schedule autotuner ------------------------------------------
    tune = tuner_phase(dev, tag, kern, kmod, tprog, trt)
    report["tuner"] = tune
    torch.cuda.empty_cache()
    phase_s["tuner"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 11. CIM-aware CNN and MLP training ---------------------------------
    ctrain = cnn_train_phase(dev, tag, kern, kmod)
    report["cnn_train"] = ctrain
    torch.cuda.empty_cache()
    phase_s["cnn_train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 12. the dense configs' train step ---------------------------------
    dense = dense_phase(dev, tag)
    report["dense"] = dense
    phase_s["dense"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 13. the moe and vlm families at full width -----------------------
    cap_mark = len(clock.seconds)
    moe = moe_phase(dev, tag, kern, kmod, tprog, trt, clock)
    report["moe"] = moe
    graphs["moe"] = dict(clock.since(cap_mark),
                         capture_count=trt.CAPTURE_COUNT["n"],
                         pool_bytes=graph_pool_bytes(tprog, dev))
    phase_s["moe"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 14. the hybrid and ssm families at full width ---------------------
    cap_mark = len(clock.seconds)
    recur = recurrent_phase(dev, tag, kern, kmod, tprog, trt, clock)
    report["recurrent"] = recur
    graphs["recurrent"] = dict(clock.since(cap_mark),
                               capture_count=trt.CAPTURE_COUNT["n"],
                               pool_bytes=graph_pool_bytes(tprog, dev))
    phase_s["recurrent"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 15. the audio family at full width --------------------------------
    cap_mark = len(clock.seconds)
    audio = audio_phase(dev, tag, kern, kmod, tprog, trt, clock)
    report["audio"] = audio
    graphs["audio"] = dict(clock.since(cap_mark),
                           capture_count=trt.CAPTURE_COUNT["n"],
                           pool_bytes=graph_pool_bytes(tprog, dev))
    phase_s["audio"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 16. the sharded multi-macro engine ---------------------------------
    cap_mark = len(clock.seconds)
    shard = shard_phase(dev, tag, kern, kmod, tprog, trt)
    report["shard"] = shard
    graphs["shard"] = dict(clock.since(cap_mark),
                           capture_count=trt.CAPTURE_COUNT["n"],
                           pool_bytes=graph_pool_bytes(tprog, dev))
    torch.cuda.empty_cache()
    phase_s["shard"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 17. cimcheck: static verification and the legacy entries --------
    cim = cimcheck_phase(dev, tag, kern, kmod, tprog, trt)
    report["cimcheck"] = cim
    torch.cuda.empty_cache()
    phase_s["cimcheck"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 18. the training infrastructure: checkpoints, faults, elastic ------
    fttrain = ft_train_phase(dev, tag)
    report["ft_train"] = fttrain
    phase_s["ft_train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 19. the dry run: the card sweep on meta, one cell for real --------
    dry = dryrun_phase(dev, tag)
    report["dryrun"] = dry
    phase_s["dryrun"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 20. the examples on the card ---------------------------------------
    ex = examples_phase(dev, tag, kern)
    report["examples"] = ex
    phase_s["examples"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 21. times -----------------------------------------------------------
    def int_mm_inputs(planes, w, p):
        # the matmul work alone: (M, P*K) x (P*K, N) int8, padded to
        # _int_mm's needs (M > 16, K and N multiples of 8)
        m, pk = planes.shape
        n = w.shape[1]
        mp, kp, np_ = max(m, 32), -(-pk // 8) * 8, -(-n // 8) * 8
        a = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
        a[:m, :pk] = planes
        b = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
        b[:pk, :n] = torch.cat([w] * p, dim=0)
        return a, b

    timing = []
    CORE_64 = kmod.Route("cuda_core", 64, 64, 0, ())
    shapes = [("lenet", p, t) for p, tiles in lenet_tiles.items()
              for t in tiles]
    shapes.append(("full-macro tile", (8, 1), (16384, 1152, 256)))
    # every decode row tile is 1024 deep (2048 and 8192 split evenly);
    # a col tile holds 128 channels at r_w = 2 and 64 at r_w = 4
    shapes += [("decode", p, (m, 1024, n)) for m in (1, 4)
               for p, n in (((4, 2), 128), ((8, 4), 64))]
    for label, (r_in, r_w), (m, k, n) in shapes:
        rows = label == "decode" and m > 1      # per-row beta (segments)
        shift, args = tile_inputs(m, k, n, r_in, r_w, rows)
        p = args[0].shape[1] // k
        kw = dict(plane_shift=shift, g0=0.01, r_out=8)
        reps = 50 if m * n * k * p < 5e8 else 20
        route = kmod.route_for(m, n, k, p)
        out = torch.empty((m, n), dtype=torch.int32, device=dev)

        def first_port():
            # the first port's design on the same inputs: cim_mbiw.cu at
            # its 64 x 64 tile (route C), called past the route choice
            kmod.launch(CORE_64, *args, out, fuse_adc=True, **kw)

        def kernel():
            return kern(*args, **kw)
        ms = cuda_ms(kernel, reps)
        first_ms = cuda_ms(first_port, reps)
        plain = cuda_ms(
            lambda: kref.cim_mbiw_matmul_planes_ref(*args, **kw), reps)
        a, b = int_mm_inputs(args[0], args[1], p)
        lib = cuda_ms(lambda: torch._int_mm(a, b), reps)
        bnd, by = bound_ms(m, k, n, p, rows)
        dev_us = {name: device_profile(fn, 20).get("device_us")
                  for name, fn in (
                      ("kernel", kernel),
                      ("plain", lambda: kref.cim_mbiw_matmul_planes_ref(
                          *args, **kw)),
                      ("library", lambda: torch._int_mm(a, b)))}
        g_us = {"kernel": graph_us(kernel), "first_port": graph_us(first_port),
                "library": graph_us(lambda: torch._int_mm(a, b))}
        row = {"shape": label, "r_in": r_in, "r_w": r_w, "m": m, "k": k,
               "n": n, "planes": p, "beta_rows": rows,
               "route": route.name, "tile": [route.bm, route.bn, route.kc],
               "ms": ms, "first_port_ms": first_ms, "plain_ms": plain,
               "library_ms": lib, "bound_ms": bnd, "bound_by": by,
               "device_us": dev_us, "graph_us": g_us,
               "host_us_per_launch": host_us(kernel)}
        timing.append(row)
        dev_txt = ", ".join(f"{k_} {v:.1f}" if v is not None else
                            f"{k_} not measured" for k_, v in dev_us.items())
        print(f"time {tag} {label} ({r_in},{r_w}) M={m} K={k} N={n} P={p} "
              f"[{route.name}]: kernel {ms:.4f} ms, first port's kernel "
              f"{first_ms:.4f} ms, plain {plain:.4f} ms, _int_mm "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}); device us per "
              f"call, graph of 20: kernel {g_us['kernel']:.2f}, first "
              f"port's {g_us['first_port']:.2f}, _int_mm "
              f"{g_us['library']:.2f}; profiler: {dev_txt}; wrapper host "
              f"{row['host_us_per_launch']:.1f} us a launch", flush=True)
    report["times"] = timing

    # ring_decode at the decode path's shape: the scheduler's own rings
    # (block 0's slab of the capacity-4 state), all slots valid but one row
    r, l, h, hd = (DECODE_CAPACITY, DECODE_WIDTHS["window"],
                   DECODE_WIDTHS["n_heads"],
                   DECODE_WIDTHS["d"] // DECODE_WIDTHS["n_heads"])
    g = torch.Generator(device=dev).manual_seed(2)
    sched.state["k"].normal_(generator=g)
    sched.state["v"].normal_(generator=g)
    rq = torch.randn((r, h, hd), generator=g, device=dev)
    rk, rv = sched.state["k"][:r, 0], sched.state["v"][:r, 0]
    rbias = torch.zeros((r, l), device=dev)
    rbias[0, 100:] = -1e9

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            rq[:, :, None], rk.transpose(1, 2), rv.transpose(1, 2),
            attn_mask=rbias[:, None, None, :])[:, :, 0]
    check(torch.allclose(sdpa(), ring(rq, rk, rv, rbias), rtol=1e-4,
                         atol=1e-4), "the SDPA yardstick computes another "
          "function than ring_decode")
    r_ms = cuda_ms(lambda: ring(rq, rk, rv, rbias), 50)
    r_plain = cuda_ms(lambda: rref.ring_decode_attention_ref(
        rq, rk, rv, rbias), 10)
    r_lib = cuda_ms(sdpa, 50)
    r_bnd, r_by = ring_bound_ms(r, l, h, hd)
    r_dev = {name: device_profile(fn, 10).get("device_us")
             for name, fn in (
                 ("kernel", lambda: ring(rq, rk, rv, rbias)),
                 ("plain", lambda: rref.ring_decode_attention_ref(
                     rq, rk, rv, rbias)),
                 ("library", sdpa))}
    report["ring_times"] = {"r": r, "l": l, "h": h, "hd": hd, "ms": r_ms,
                            "plain_ms": r_plain, "library_ms": r_lib,
                            "bound_ms": r_bnd, "bound_by": r_by,
                            "device_us": r_dev}
    dev_txt = ", ".join(f"{k_} {v:.1f}" if v is not None else
                        f"{k_} not measured" for k_, v in r_dev.items())
    print(f"time {tag} ring_decode R={r} L={l} H={h} hd={hd}: kernel "
          f"{r_ms:.4f} ms, plain {r_plain:.4f} ms, SDPA {r_lib:.4f} ms, "
          f"bound {r_bnd:.4f} ms ({r_by}); device us per call (profiler): "
          f"{dev_txt}", flush=True)
    b, h, g, s, d = FLASH_TRAIN
    ftimes = flash_times(rmod, rref, dev, tag, (b, h, g, s, s, d, True),
                         cuda_core=True)
    report["flash_times"] = ftimes
    dtimes = draw_times(dev, tag, ndec["draw_shape"])
    report["draw_times"] = dtimes
    phase_s["times"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # one fused 4-row decode step per point under the profiler (after its
    # own warm-up step), device only: traced last, because a trace of
    # that many thousand launches leaves the profiler blind to the short
    # traces that would follow it
    # the same step with every projection run eagerly (EagerServe) beside
    prof_step: dict = {}
    for p in model.points:
        st = model.init_state(DECODE_CAPACITY)
        toks = torch.arange(1, DECODE_CAPACITY + 1)

        def step():
            return model.step_rows(st, toks, point=p)[1].cpu()
        prof_step[p] = {}
        for mode, reps in (("graph", 5), ("eager", 2)):
            with EagerServe(tprog, trt) if mode == "eager" \
                    else contextlib.nullcontext():
                captures = trt.CAPTURE_COUNT["n"]
                step()
                host = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    step()
                    host.append(1e3 * (time.perf_counter() - t0))
                pr = device_profile(step, 1, cpu=False)
                check(mode == "graph" or trt.CAPTURE_COUNT["n"] == captures,
                      "the eager step captured a graph")
            pr["host_ms"] = host
            pr["median_host_ms"] = statistics.median(host)
            if "device_us" in pr:
                pr["busy_of_median_host"] = pr["device_us"] / (
                    1e3 * pr["median_host_ms"])
            prof_step[p][mode] = pr
        del st
        txt = []
        for mode, pr in prof_step[p].items():
            txt.append(
                f"{mode}: host {pr['median_host_ms']:.1f} ms (median of "
                f"{len(pr['host_ms'])}), " + (
                    f"device {pr['device_us']:.0f} us (cim_mbiw "
                    f"{pr['cim_mbiw_us']:.0f}, ring_decode "
                    f"{pr['ring_decode_us']:.0f}), busy "
                    f"{100 * pr['busy_of_median_host']:.1f}% of the median "
                    f"step, {100 * pr['device_busy']:.1f}% of a profiled "
                    f"{pr['wall_us'] / 1e3:.0f} ms step"
                    if "device_us" in pr else
                    "device time not measured (profiler saw none)"))
        print(f"decode point {p or 'base'!r} {DECODE_POINTS[p]} [{card}]: "
              f"one fused 4-row step, {'; '.join(txt)}", flush=True)
    report["decode"]["fused_step_profile"] = prof_step
    phase_s["profile"] = time.perf_counter() - t_phase

    # -- the kernels line ----------------------------------------------------
    # cim_mbiw, one entry a route: launches over every main path; times
    # per (4, 2) LeNet forward at batch 256 summed over the route's tiles
    # (fc1 runs its 784-row tile twice) for the tensor-core and CUDA-core
    # routes, and one (4, 2) decode tile at M 4 for split-K.  ring_decode:
    # the decode path's shape.
    fwd = [r for r in timing if r["shape"] == "lenet" and r["r_in"] == 4]
    dec = [r for r in timing if r["shape"] == "decode" and r["r_in"] == 4
           and r["m"] == DECODE_CAPACITY]
    nl, nd = noise["launches"], ndec["launches"]
    ls, lp, lt = lserve["launches"], prec["launches"], tune["launches"]
    lc, lsh, lcc = ctrain["launches"], shard["launches"], cim["launches"]
    lm, lr, la = moe["launches"], recur["launches"], audio["launches"]
    lx = ex["launches"]
    route_launches = {
        "tc": main_routes["tc"] + nl["cim_mbiw_tc"] + ls["cim_mbiw_tc"]
        + lp["cim_mbiw_tc"] + lt["cim_mbiw_tc"] + lc["cim_mbiw_tc"]
        + lsh["cim_mbiw_tc"] + lcc["cim_mbiw_tc"] + lm["cim_mbiw_tc"]
        + lr["cim_mbiw_tc"] + la["cim_mbiw_tc"] + lx["cim_mbiw_tc"],
        "splitk": main_routes["splitk"] + dec_splitk + nl["cim_mbiw_splitk"]
        + nd["cim_mbiw_splitk"] + ls["cim_mbiw_splitk"]
        + lp["cim_mbiw_splitk"] + lt["cim_mbiw_splitk"]
        + lc["cim_mbiw_splitk"] + lsh["cim_mbiw_splitk"]
        + lcc["cim_mbiw_splitk"] + lm["cim_mbiw_splitk"]
        + lr["cim_mbiw_splitk"] + la["cim_mbiw_splitk"]
        + lx["cim_mbiw_splitk"],
        "cuda_core": main_routes["all"] - main_routes["tc"]
        - main_routes["splitk"] + dec_cim - dec_splitk + nl["cim_mbiw"]
        - nl["cim_mbiw_tc"] - nl["cim_mbiw_splitk"] + nd["cim_mbiw"]
        - nd["cim_mbiw_splitk"] + ls["cim_mbiw"] - ls["cim_mbiw_tc"]
        - ls["cim_mbiw_splitk"] + lp["cim_mbiw"] - lp["cim_mbiw_tc"]
        - lp["cim_mbiw_splitk"] + lt["cim_mbiw"] - lt["cim_mbiw_tc"]
        - lt["cim_mbiw_splitk"] + lc["cim_mbiw"] - lc["cim_mbiw_tc"]
        - lc["cim_mbiw_splitk"] + lsh["cim_mbiw"] - lsh["cim_mbiw_tc"]
        - lsh["cim_mbiw_splitk"] + lcc["cim_mbiw"] - lcc["cim_mbiw_tc"]
        - lcc["cim_mbiw_splitk"] + lm["cim_mbiw"] - lm["cim_mbiw_tc"]
        - lm["cim_mbiw_splitk"] + lr["cim_mbiw"] - lr["cim_mbiw_tc"]
        - lr["cim_mbiw_splitk"] + la["cim_mbiw"] - la["cim_mbiw_tc"]
        - la["cim_mbiw_splitk"] + lx["cim_mbiw"] - lx["cim_mbiw_tc"]
        - lx["cim_mbiw_splitk"]}

    def route_entry(name, route, src, rows):
        mult = [2 if r["k"] == 784 and r["shape"] == "lenet" else 1
                for r in rows]

        def fsum(key):
            return sum(c * r[key] for c, r in zip(mult, rows))
        check(bool(rows) and all(r["route"] == route for r in rows),
              f"no timed {route} tiles: {[r['route'] for r in rows]}")
        by = "bytes" if sum(r["bound_by"] == "bytes" for r in rows) * 2 \
            >= len(rows) else "operations"
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/cim_mbiw/csrc/{src}",
                "replaces": "src/repro/kernels/cim_mbiw/kernel.py:54",
                "launches": route_launches[route], "max_abs_err": max_err,
                "ms": fsum("ms"), "plain_ms": fsum("plain_ms"),
                "bound_ms": fsum("bound_ms"), "bound_by": by,
                "library_ms": fsum("library_ms")}
    kernels = {"kernels": [
        route_entry("cim_mbiw_tc", "tc", "cim_mbiw_tc.cu",
                    [r for r in fwd if r["route"] == "tc"]),
        route_entry("cim_mbiw_splitk", "splitk", "cim_mbiw_splitk.cu",
                    dec),
        route_entry("cim_mbiw", "cuda_core", "cim_mbiw.cu",
                    [r for r in fwd if r["route"] == "cuda_core"]), {
        "name": "ring_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/ring_decode.cu",
        "replaces": "src/repro/kernels/flash_attn/ops.py:197",
        "launches": dec_ring + lp["ring_decode"], "max_abs_err": rmax,
        "ms": r_ms,
        "plain_ms": r_plain, "bound_ms": r_bnd, "bound_by": r_by,
        "library_ms": r_lib}]}
    # flash: the train paths' launches (OLMo-1B, the dense configs, the
    # moe phase's and whisper-medium's at D 64, all on the tensor-core
    # kernels) and flash_attention_sharded's pieces; times at OLMo's
    # attention shape in bf16
    for kind, line, src in (("fwd", 41, "flash_fwd_tc.cu"),
                            ("dq", 134, "flash_bwd_dq_tc.cu"),
                            ("dkv", 168, "flash_bwd_dkv_tc.cu")):
        name = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
        t = ftimes[kind]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/flash_attn/csrc/{src}",
            "replaces": f"src/repro/kernels/flash_attn/kernel.py:{line}",
            "launches": train["launches_tc"][name]
            + dense["launches_tc"][name] + lsh[f"{name}_tc"]
            + lm[f"{name}_tc"] + la[f"{name}_tc"]
            + fttrain["launches_tc"][name]
            + dry["launches_tc"].get(name, 0),
            "max_abs_err": max(flash["max_abs_err"][kind].values()),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    # flash at D 256, recurrentgemma's head dim, launched by
    # recurrentgemma's train steps (bf16) on the tensor-core kernels' D 256
    # designs; times at its attention shape in bf16
    for kind, line, src, launched in (
            ("fwd", 41, "flash_fwd_tc.cu", lr["flash_fwd_tc"]),
            ("dq", 134, "flash_bwd_dq_tc.cu", lr["flash_bwd_dq_tc"]),
            ("dkv", 168, "flash_bwd_dkv_tc.cu", lr["flash_bwd_dkv_tc"])):
        name = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
        t = recur["flash_times"][kind]
        errs = recur["flash_vs_plain"]["max_abs_err"][kind]
        kernels["kernels"].append({
            "name": f"{name}_d256", "route": "cuda",
            "source": f"src/repro_torch/kernels/flash_attn/csrc/{src}",
            "replaces": f"src/repro/kernels/flash_attn/kernel.py:{line}",
            "launches": launched,
            # the tensor-core kernels take bf16 alone
            "max_abs_err": errs["bfloat16"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    draw_launches = (noise["launches"]["threefry_normal"]
                     + ndec["launches"]["threefry_normal"]
                     + train["noisy"]["launches"] + lp["threefry_normal"]
                     + lc["threefry_normal"] + lcc["threefry_normal"]
                     + lm["threefry_normal"] + la["threefry_normal"]
                     + lx["threefry_normal"])
    kernels["kernels"].append({
        "name": "threefry_normal", "route": "cuda",
        "source": "src/repro_torch/kernels/prng/csrc/threefry_normal.cu",
        "replaces": "src/repro/runtime/engine.py:587",
        "launches": draw_launches, "max_abs_err": draws["max_abs_err"],
        "ms": dtimes["ms"], "plain_ms": dtimes["plain_ms"],
        "bound_ms": dtimes["bound_ms"], "bound_by": dtimes["bound_by"],
        "library_ms": None})
    graphs["all_phases"] = {"captures": len(clock.seconds),
                            "seconds": sum(clock.seconds),
                            "max_s": max(clock.seconds, default=0.0),
                            "capture_count": trt.CAPTURE_COUNT["n"],
                            "pool_bytes": graph_pool_bytes(tprog, dev)}
    report["graphs"] = graphs
    print(f"capture {tag}: " + "; ".join(
        f"{ph} {g['capture_count']} captures in {g['seconds']:.2f} s "
        f"(slowest {g['max_s']:.3f} s), graph pool "
        + f"{g['pool_bytes'] / 2**20:.1f} MiB after it"
        for ph, g in graphs.items()), flush=True)
    idle = [k["name"] for k in kernels["kernels"] if k["launches"] < 1]
    check(not idle, f"kernels the main paths never launched: {idle}")
    report["kernels"] = kernels
    report["launches_by_path"] = {
        "lenet": {"cim_mbiw": main_routes["all"],
                  "cim_mbiw_tc": main_routes["tc"],
                  "cim_mbiw_splitk": main_routes["splitk"]},
        "decode": {"cim_mbiw": dec_cim, "cim_mbiw_splitk": dec_splitk,
                   "ring_decode": dec_ring},
        "noise_lenet": noise["launches"],
        "noise_decode": ndec["launches"],
        "train": train["launches"],
        "noise_train": {"threefry_normal": train["noisy"]["launches"]},
        "llm_serve": lserve["launches"],
        "precision": prec["launches"],
        "tuner": tune["launches"],
        "cnn_train": lc,
        "dense": dense["launches"],
        "moe": lm,
        "recurrent": lr,
        "audio": la,
        "shard": lsh,
        "cimcheck": lcc,
        "ft_train": fttrain["launches_tc"],
        "dryrun": dry["launches_tc"],
        "examples": lx}
    report["total_s"] = time.perf_counter() - t_start
    report["phase_s"] = phase_s
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"total {report['total_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()) + ")", flush=True)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
